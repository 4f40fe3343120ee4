"""Sparse substrate: segment-op message passing, EmbeddingBag, sampling.

The segment reductions are ``index_add_`` / ``scatter_reduce`` and the
bags ``torch.nn.functional.embedding_bag``; the neighbour sampler is host
numpy, the JAX package's as it is.
"""
from .segment import degree, segment_softmax, segment_sum, spmm_edges  # noqa: F401
from .embedding_bag import embedding_bag  # noqa: F401
from .sampler import sample_neighbors  # noqa: F401
