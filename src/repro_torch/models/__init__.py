"""The model families on plain tensors (the JAX package's ``models``):
layers (:mod:`.nn`); the LM family's attention, MoE, transformer and
steps; DLRM (:mod:`.dlrm`); the GNNs (:mod:`.gnn`) and the GNN and recsys
steps (:mod:`.gnn_steps`); and the carry-over of the reference's
parameters (:mod:`.convert`).  Parameters are the reference's trees:
nested dicts of tensors under the same path names (the LM's stacked
layers on a leading L dimension)."""
