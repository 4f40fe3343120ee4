"""GNN models on plain tensors (the JAX package's ``models/gnn``): GAT,
GraphCast, NequIP and Equiformer-v2, and the irreps machinery the two
equivariant ones share."""
