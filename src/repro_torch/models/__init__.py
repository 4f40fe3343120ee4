"""The LM family on plain tensors (the JAX package's ``models``, its LM
half): layers (:mod:`.nn`), attention, MoE, the transformer, the serving
steps, and the carry-over of the reference's parameters
(:mod:`.convert`).  Parameters are the reference's tree: nested dicts of
tensors under the same path names, stacked layers on a leading L
dimension."""
