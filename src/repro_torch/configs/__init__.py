"""Graph and LM configs with a name registry (the JAX package's
``configs``, its triangle-count and LM halves)."""
from .base import (  # noqa: F401
    LM_SHAPES,
    LMConfig,
    TCGraphConfig,
    get_config,
    list_configs,
    register,
)

LM_ARCHS = [
    "chatglm3-6b",
    "qwen2-0.5b",
    "qwen1.5-110b",
    "grok-1-314b",
    "deepseek-v3-671b",
]

TC_GRAPHS = [
    "tc-twitter",
    "tc-friendster",
    "tc-g500-s26",
    "tc-g500-s27",
    "tc-g500-s28",
    "tc-g500-s29",
]
