"""gat-cora [arXiv:1710.10903]: 2 layers, 8 hidden per head, 8 heads,
attention aggregation (the original Cora transductive config)."""
from .base import GNNConfig, register


@register("gat-cora")
def full() -> GNNConfig:
    return GNNConfig(
        name="gat-cora",
        arch="gat",
        n_layers=2,
        d_hidden=8,
        n_heads=8,
        aggregator="attn",
        d_out=7,
    )


@register("gat-cora-smoke")
def smoke() -> GNNConfig:
    return GNNConfig(
        name="gat-cora-smoke",
        arch="gat",
        n_layers=2,
        d_hidden=4,
        n_heads=2,
        aggregator="attn",
        d_out=3,
    )
