"""Data: deterministic synthetic LM streams (numpy)."""
from repro_torch.data.pipeline import DataConfig, batches, copy_batch, markov_batch

__all__ = ["DataConfig", "batches", "copy_batch", "markov_batch"]
