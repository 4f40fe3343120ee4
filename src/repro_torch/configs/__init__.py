"""Graph configs with a name registry (the JAX package's ``configs``, its
triangle-count half)."""
from .base import TCGraphConfig, get_config, list_configs, register  # noqa: F401

TC_GRAPHS = [
    "tc-twitter",
    "tc-friendster",
    "tc-g500-s26",
    "tc-g500-s27",
    "tc-g500-s28",
    "tc-g500-s29",
]
