"""Config registry: the triangle-count graphs and every model family.

The JAX package's module of the same name registers every architecture it
dry-runs (language models, GNNs, recsys) beside the paper's graphs.  The
port carries the registry, :class:`TCGraphConfig`, :class:`LMConfig`,
:class:`GNNConfig`, :class:`RecsysConfig` and their shape sets with the
same fields and defaults, and registers the same names.
:func:`get_config` of a name nobody registers raises ``KeyError`` listing
the names there are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = ["TCGraphConfig", "LMConfig", "GNNConfig", "RecsysConfig",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "register",
           "get_config", "list_configs"]

_REGISTRY: Dict[str, Callable[[], object]] = {}


def register(name: str):
    """Register ``fn`` (a zero-argument config factory) under ``name``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _import_configs() -> None:
    from . import (  # noqa: F401  (each registers on import)
        chatglm3_6b,
        deepseek_v3_671b,
        dlrm_mlperf,
        equiformer_v2,
        gat_cora,
        graphcast,
        grok1_314b,
        nequip,
        qwen1_5_110b,
        qwen2_0_5b,
        tc_graphs,
    )


def get_config(name: str):
    """A fresh config registered under ``name``."""
    if name not in _REGISTRY:
        _import_configs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    """Every registered config name, sorted."""
    _import_configs()
    return sorted(_REGISTRY)


@dataclasses.dataclass
class TCGraphConfig:
    """The paper's own evaluation graphs (Table 1)."""

    name: str
    n_vertices: int
    n_edges: int
    n_triangles: int
    dmax_block_est: int  # planner estimate for the analytic dry-run plan
    family: str = "tc"


LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    # long_500k requires sub-quadratic attention; all five LM archs are
    # pure full-attention, so the dry run skips it (the JAX package's
    # DESIGN.md §5).
    "long_500k": dict(
        kind="decode", seq_len=524288, global_batch=1, skip_full_attention=True
    ),
}

GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="full", n_nodes=2708, n_edges=10556, d_feat=1433
    ),
    "minibatch_lg": dict(
        kind="sampled",
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanout=(15, 10),
    ),
    "ogb_products": dict(
        kind="full", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100
    ),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


@dataclasses.dataclass
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0  # chatglm "RoPE 2d" = rotary on half dims
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token-prediction auxiliary head
    # runtime knobs
    dtype: str = "bfloat16"
    remat: bool = True
    microbatch_size: int = 16  # tokens dim of grad-accumulation microbatch
    optimizer: str = "adamw"
    kv_quant: Optional[str] = None  # "int8" to quantize decode KV cache
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    shapes = LM_SHAPES
    family: str = "lm"

    def __post_init__(self):
        if self.d_head == 0:
            self.d_head = self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        if self.mla:
            attn = (
                self.d_model * self.q_lora_rank
                + self.q_lora_rank * h * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * h * (self.qk_nope_dim + self.v_head_dim)
                + h * self.v_head_dim * d
            )
        else:
            attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        dense_ffn = 3 * d * self.d_ff
        if self.moe:
            moe_ffn = self.n_experts * 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            n_moe = self.n_layers - self.first_dense_layers
            layers = self.n_layers * attn + self.first_dense_layers * dense_ffn
            layers += n_moe * (moe_ffn + shared + d * self.n_experts)
        else:
            layers = self.n_layers * (attn + dense_ffn)
        return layers + 2 * self.vocab * d

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d = self.d_model
        h, dh = self.n_heads, self.d_head
        if self.mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * h * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * h * (self.qk_nope_dim + self.v_head_dim)
                + h * self.v_head_dim * d
            )
        else:
            attn = d * h * dh + 2 * d * self.n_kv_heads * dh + h * dh * d
        act_ffn = (self.top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff
        n_moe = self.n_layers - self.first_dense_layers
        total = (
            self.n_layers * attn
            + self.first_dense_layers * 3 * d * self.d_ff
            + n_moe * (act_ffn + d * self.n_experts)
            + 2 * self.vocab * d
        )
        return total


@dataclasses.dataclass
class GNNConfig:
    name: str
    arch: str  # "nequip" | "graphcast" | "gat" | "equiformer_v2"
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    l_max: int = 0
    m_max: int = 0
    n_rbf: int = 0
    cutoff: float = 0.0
    aggregator: str = "sum"
    mesh_refinement: int = 0
    n_vars: int = 0
    d_out: int = 7  # classes / target dim
    dtype: str = "float32"
    remat: bool = True
    shapes = GNN_SHAPES
    family: str = "gnn"


@dataclasses.dataclass
class RecsysConfig:
    name: str
    n_dense: int
    n_sparse: int
    embed_dim: int
    bot_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]
    interaction: str
    table_sizes: Tuple[int, ...]
    multi_hot: int = 1  # ids per sparse field (bag size)
    dtype: str = "float32"
    shapes = RECSYS_SHAPES
    family: str = "recsys"

    @property
    def total_rows(self) -> int:
        return sum(self.table_sizes)
