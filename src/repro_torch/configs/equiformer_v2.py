"""equiformer-v2 [arXiv:2306.12059]: 12 blocks, 128 channels, l_max=6,
m_max=2 eSCN SO(2) convolutions, 8 attention heads."""
from .base import GNNConfig, register


@register("equiformer-v2")
def full() -> GNNConfig:
    return GNNConfig(
        name="equiformer-v2",
        arch="equiformer_v2",
        n_layers=12,
        d_hidden=128,
        l_max=6,
        m_max=2,
        n_heads=8,
        n_rbf=8,
        cutoff=5.0,
        d_out=1,
    )


@register("equiformer-v2-smoke")
def smoke() -> GNNConfig:
    return GNNConfig(
        name="equiformer-v2-smoke",
        arch="equiformer_v2",
        n_layers=2,
        d_hidden=16,
        l_max=2,
        m_max=1,
        n_heads=2,
        n_rbf=4,
        cutoff=5.0,
        d_out=1,
    )
