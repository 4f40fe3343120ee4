"""chatglm3-6b [arXiv:2406.12793]: 28L d4096 32H GQA(kv=2) ff13696 v65024.

"RoPE 2d": ChatGLM applies rotary embeddings to half of the head
dimensions (partial rotary factor 0.5).  QKV uses bias (ChatGLM uses
add_qkv_bias=True); attention/MLP output projections do not.
"""
from .base import LMConfig, register


@register("chatglm3-6b")
def full() -> LMConfig:
    return LMConfig(
        name="chatglm3-6b",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab=65024,
        qkv_bias=True,
        rope_fraction=0.5,
    )


@register("chatglm3-6b-smoke")
def smoke() -> LMConfig:
    return LMConfig(
        name="chatglm3-6b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        rope_fraction=0.5,
        microbatch_size=2,
    )
