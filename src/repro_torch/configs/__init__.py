"""Graph and model configs with a name registry (``--arch <id>``), the
JAX package's ``configs``."""
from .base import (  # noqa: F401
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    GNNConfig,
    LMConfig,
    RecsysConfig,
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

GNN_ARCHS = ["nequip", "graphcast", "gat-cora", "equiformer-v2"]

ASSIGNED_ARCHS = [*LM_ARCHS, *GNN_ARCHS, "dlrm-mlperf"]

TC_GRAPHS = [
    "tc-twitter",
    "tc-friendster",
    "tc-g500-s26",
    "tc-g500-s27",
    "tc-g500-s28",
    "tc-g500-s29",
]
