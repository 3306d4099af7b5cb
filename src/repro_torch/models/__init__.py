"""Model zoo: configs -> (init, prefill, decode_step, forward_logits)."""
from repro_torch.models.model import (
    Model, decode_step, forward_logits, init, init_decode_caches, prefill,
    segments,
)

__all__ = ["Model", "decode_step", "forward_logits", "init",
           "init_decode_caches", "prefill", "segments"]
