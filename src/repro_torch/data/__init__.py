"""Synthetic data pipelines (numpy batches, tensors on request)."""
