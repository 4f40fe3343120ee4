"""deepseek-v3-671b [arXiv:2412.19437]: 61L d7168, MLA (128 heads),
MoE 1 shared + 256 routed top-8 (moe_d_ff=2048), first 3 layers dense
(d_ff=18432), vocab 129280, MTP auxiliary head.

DeepSeek-V3 uses MLA, whose latent KV is shared across all 128 heads
(effectively kv=128 at the head level); the model is true MLA with the
published low-rank dims (q_lora 1536, kv_lora 512, qk_nope 128, qk_rope
64, v_head 128).
"""
from .base import LMConfig, register


@register("deepseek-v3-671b")
def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-671b",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,  # dense layers (first 3)
        vocab=129280,
        d_head=192,  # qk_nope + qk_rope
        moe=True,
        n_experts=256,
        top_k=8,
        n_shared_experts=1,
        moe_d_ff=2048,
        first_dense_layers=3,
        mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        mtp=True,
        microbatch_size=8,
        optimizer="adafactor",
        kv_quant="int8",
    )


@register("deepseek-v3-671b-smoke")
def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-671b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab=256,
        d_head=24,
        moe=True,
        n_experts=8,
        top_k=2,
        n_shared_experts=1,
        moe_d_ff=48,
        first_dense_layers=1,
        mla=True,
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        mtp=True,
        microbatch_size=2,
    )
