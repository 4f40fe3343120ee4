"""qwen2-0.5b [arXiv:2407.10671]: 24L d896 14H GQA(kv=2) ff4864 v151936.

QKV bias on (Qwen2 uses attention QKV bias), tied embeddings in the real
model (the JAX package keeps an untied lm_head; its DESIGN.md says why).
"""
from .base import LMConfig, register


@register("qwen2-0.5b")
def full() -> LMConfig:
    return LMConfig(
        name="qwen2-0.5b",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151936,
        qkv_bias=True,
        d_head=64,
    )


@register("qwen2-0.5b-smoke")
def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-0.5b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        d_head=16,
        microbatch_size=2,
    )
