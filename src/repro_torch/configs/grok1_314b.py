"""grok-1-314b [hf:xai-org/grok-1]: 64L d6144 48H GQA(kv=8) ff32768
v131072, MoE 8 experts top-2."""
from .base import LMConfig, register


@register("grok-1-314b")
def full() -> LMConfig:
    return LMConfig(
        name="grok-1-314b",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab=131072,
        moe=True,
        n_experts=8,
        top_k=2,
        moe_d_ff=32768,
        microbatch_size=8,
        optimizer="adafactor",
    )


@register("grok-1-314b-smoke")
def smoke() -> LMConfig:
    return LMConfig(
        name="grok-1-314b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        moe=True,
        n_experts=4,
        top_k=2,
        moe_d_ff=128,
        microbatch_size=2,
    )
