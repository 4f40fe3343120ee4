"""qwen1.5-110b: 80L d8192 64H GQA(kv=8) ff49152 v152064, QKV bias."""
from .base import LMConfig, register


@register("qwen1.5-110b")
def full() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab=152064,
        qkv_bias=True,
        microbatch_size=8,
        optimizer="adafactor",  # the JAX package's choice for this size
    )


@register("qwen1.5-110b-smoke")
def smoke() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=8,
        n_kv_heads=2,
        d_ff=192,
        vocab=512,
        qkv_bias=True,
        microbatch_size=2,
    )
