"""graphcast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN,
16 processor layers, d_hidden=512, sum aggregation, 227 variables.

The modality frontend (lat/lon grid <-> icosahedral mesh bipartite
encoders) is a STUB per the assignment: ``input_specs`` provides node
features directly on the processing mesh; mesh_refinement=6 is recorded
for the config's provenance."""
from .base import GNNConfig, register


@register("graphcast")
def full() -> GNNConfig:
    return GNNConfig(
        name="graphcast",
        arch="graphcast",
        n_layers=16,
        d_hidden=512,
        mesh_refinement=6,
        n_vars=227,
        aggregator="sum",
        d_out=227,
    )


@register("graphcast-smoke")
def smoke() -> GNNConfig:
    return GNNConfig(
        name="graphcast-smoke",
        arch="graphcast",
        n_layers=2,
        d_hidden=32,
        mesh_refinement=1,
        n_vars=11,
        d_out=11,
    )
