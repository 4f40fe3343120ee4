"""Config registry, the triangle-count graph configs and the LM configs.

The JAX package's module of the same name registers every architecture it
dry-runs (language models, GNNs, recsys) beside the paper's graphs.  The
port carries the registry, :class:`TCGraphConfig`, :class:`LMConfig` and
``LM_SHAPES`` with the same fields and defaults; the GNN and recsys
configs come with their families.  :func:`get_config` of a name the port
does not register raises ``KeyError`` listing the names it has.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

__all__ = ["TCGraphConfig", "LMConfig", "LM_SHAPES", "register", "get_config",
           "list_configs"]

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
        grok1_314b,
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
