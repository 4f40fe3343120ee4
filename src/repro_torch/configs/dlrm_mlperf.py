"""dlrm-mlperf [arXiv:1906.00091]: the MLPerf DLRM benchmark config
(Criteo Terabyte): 13 dense + 26 sparse features, embed_dim 128,
bottom MLP 13-512-256-128, top MLP 1024-1024-512-256-1, dot interaction.

Table sizes are the Criteo Terabyte cardinalities used by the MLPerf
reference implementation (~882M rows total, ~113 GB at fp32/128d)."""
from .base import RecsysConfig, register

CRITEO_TB_TABLE_SIZES = (
    45833188, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261,
    1572176, 345138, 10, 2209, 11267, 128, 4, 974, 14, 48937457, 11316796,
    40094537, 452104, 12606, 104, 35,
)


@register("dlrm-mlperf")
def full() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-mlperf",
        n_dense=13,
        n_sparse=26,
        embed_dim=128,
        bot_mlp=(13, 512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1),
        interaction="dot",
        table_sizes=CRITEO_TB_TABLE_SIZES,
    )


@register("dlrm-mlperf-smoke")
def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-mlperf-smoke",
        n_dense=13,
        n_sparse=8,
        embed_dim=16,
        bot_mlp=(13, 32, 16),
        top_mlp=(64, 32, 1),
        interaction="dot",
        table_sizes=(100, 50, 200, 30, 10, 80, 60, 40),
    )
