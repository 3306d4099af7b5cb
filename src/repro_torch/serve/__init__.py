from repro_torch.serve.engine import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig,
)
from repro_torch.serve.kv_cache import (
    cache_bytes_per_token, paged_page_bytes, realized_cache_bytes_per_token,
)
from repro_torch.serve.speculative import SpeculativeDecodeEngine, SpeculativeEngineConfig

__all__ = ["DecodeEngine", "EngineConfig", "PagedDecodeEngine", "PagedEngineConfig",
           "SpeculativeDecodeEngine", "SpeculativeEngineConfig", "cache_bytes_per_token",
           "paged_page_bytes", "realized_cache_bytes_per_token"]
