"""Model zoo: configs -> (init, loss_fn, prefill, decode_step,
forward_logits)."""
from repro_torch.models.model import (
    Model, decode_step, forward_logits, init, init_decode_caches,
    init_paged_decode_caches, loss_fn, prefill, prefill_chunk, segments, verify_step,
)

__all__ = ["Model", "decode_step", "forward_logits", "init",
           "init_decode_caches", "init_paged_decode_caches", "loss_fn", "prefill",
           "prefill_chunk", "segments", "verify_step"]
