"""nequip [arXiv:2101.03164]: 5 interaction layers, 32 hidden channels,
l_max=2 E(3) tensor products, 8 radial Bessel functions, cutoff 5 Å."""
from .base import GNNConfig, register


@register("nequip")
def full() -> GNNConfig:
    return GNNConfig(
        name="nequip",
        arch="nequip",
        n_layers=5,
        d_hidden=32,
        l_max=2,
        n_rbf=8,
        cutoff=5.0,
        aggregator="sum",
        d_out=1,  # energy
    )


@register("nequip-smoke")
def smoke() -> GNNConfig:
    return GNNConfig(
        name="nequip-smoke",
        arch="nequip",
        n_layers=2,
        d_hidden=8,
        l_max=2,
        n_rbf=4,
        cutoff=5.0,
        d_out=1,
    )
