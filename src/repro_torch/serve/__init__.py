from repro_torch.serve.engine import DecodeEngine, EngineConfig

__all__ = ["DecodeEngine", "EngineConfig"]
