"""Config system: frozen dataclasses describing every architecture.

The PyTorch port keeps its own copy of the JAX package's config dataclasses
(``repro/configs/base.py``): that module imports ``repro.core.remat`` and,
through it, JAX. Field names, defaults and ``reduced()`` are the same, so
``dataclasses.asdict`` of a config is equal across the two packages, apart
from the two backend-name fields, whose names follow this package's
registry (``repro_torch/models/backends.py``). The JAX backend names map
to the port's as:

  * ``xla``       -> ``torch``   (the plain oracle);
  * ``pallas``    -> ``cuda``    (the hand-written kernels);
  * ``pallas_fm`` -> ``cuda_fm`` (the feature-major decode kernels, decode
                                  only);

and ``auto`` is ``auto`` in both.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union

from repro_torch.core.remat import REMAT_POLICIES


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536          # 0 = no query compression
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    sfa_k: Optional[int] = None      # None = dense; else paper's Top-k budget
    window: Optional[int] = None     # sliding-window size (local layers)
    local_global_pattern: Optional[int] = None  # gemma3: N local then 1 global
    mla: Optional[MLAConfig] = None
    rope: bool = True
    rope_theta: float = 10_000.0
    causal: bool = True
    qk_norm: bool = False            # qwen3/gemma3-style per-head RMSNorm
    # Attention-backend registry names (repro_torch/models/backends.py):
    # "cuda" = the hand-written kernels, "torch" = the plain oracle, "auto"
    # = "cuda" wherever it can serve the layer, else "torch"; "cuda_fm"
    # (decode only) = the feature-major decode kernels on the persistent
    # FeatureMajorKV image, which the cache allocator then picks. ``backend``
    # drives prefill full-sequence attention, ``decode_backend`` serving
    # decode. An explicit backend that cannot serve a layer falls back to
    # "torch" with a structured FallbackReport.
    backend: str = "auto"            # "torch" | "cuda" | "auto"
    decode_backend: str = "auto"     # "torch" | "cuda" | "cuda_fm" | "auto"
    # Training-side axes (TrainPolicy below). ``bwd_emit`` "compact" /
    # "compact2" route seam-eligible layers (cuda backend, no qk-norm /
    # window / rope-protect / MLA / distill) through the fused projection +
    # attention Function of models/attention.py, whose backward feeds the
    # (n, k) code gradients straight into the code_grad kernels; elsewhere
    # the compact emit runs at the op level (kernels/ops.py scatters once).
    # ``fwd_fuse`` runs the seam's forward as proj_rtopk -> block-skip
    # FlashSFA. ``ring`` takes Ring-SFA on a mesh with a "seq" axis
    # (distributed/ring.py); outside one it is inert.
    bwd_emit: str = "dense"          # "dense" | "compact" | "compact2"
    fwd_fuse: bool = True
    ring: bool = False
    # SFA-on-RoPE handling (paper A.1): keep a few leading dims dense so
    # position info survives sparsification; 0 = sparsify everything.
    sfa_rope_protect: int = 0
    # Speculative drafting: decode reads the top-k' sub-code of the stored
    # top-k codes (serve/speculative.py sets it on the draft pass).
    sfa_draft_k: Optional[int] = None


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_dim: int                  # per-expert FFN hidden
    num_shared: int = 0
    every: int = 1                   # MoE replaces MLP every Nth layer
    first_dense: int = 0             # leading dense layers (deepseek-style)
    capacity_factor: float = 1.25    # GShard capacity (tokens may drop above)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 dims (jamba)."""
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 'Finch' dims."""
    head_dim: int = 64
    decay_lora: int = 64             # data-dependent decay LoRA rank
    gate_lora: int = 64


@dataclass(frozen=True)
class FrontendConfig:
    """Modality stub: precomputed embeddings in."""
    kind: str                        # "patch" (vlm) | "frame" (audio)
    input_dim: int                   # raw embedding dim provided by stub
    prefix_len: int                  # tokens contributed to the sequence


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|vlm|ssm|audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig]
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    frontend: Optional[FrontendConfig] = None
    hybrid_period: Optional[int] = None
    hybrid_attn_index: Optional[int] = None
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    act: str = "silu"                # silu|gelu
    glu: bool = True                 # gated MLP (SwiGLU/GeGLU)
    tie_embeddings: bool = True
    causal: bool = True              # False: encoder-only
    pos_embedding: str = "rope"      # rope|learned|none
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # Activation-remat policy of the layer loop: "none" | "full" | "codes".
    # Booleans are the deprecated pre-policy axis (True -> "full").
    remat: Union[str, bool] = "full"
    loss_chunk: int = 512
    # paper Eq. 8: λ for the SFA->dense attention-output MSE regularizer
    sfa_distill: float = 0.0

    def __post_init__(self):
        if isinstance(self.remat, bool):
            warnings.warn(
                "ModelConfig.remat as a bool is deprecated; use "
                'remat="none"|"full"|"codes" (bool maps True->"full", '
                'False->"none")', DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "remat",
                               "full" if self.remat else "none")
        elif self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r}; expected one of "
                             f"{REMAT_POLICIES}")

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (same rule as the JAX
        package's ``ModelConfig.reduced``)."""
        att = self.attention
        if att is not None:
            att = replace(
                att,
                num_heads=min(att.num_heads, 4),
                num_kv_heads=min(att.num_kv_heads, min(att.num_heads, 4)),
                head_dim=min(att.head_dim, 32),
                window=min(att.window, 16) if att.window else None,
                sfa_k=min(att.sfa_k, 4) if att.sfa_k else None,
                mla=MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                              nope_head_dim=16, rope_head_dim=8,
                              v_head_dim=16) if att.mla else None,
            )
        moe = self.moe
        if moe is not None:
            moe = replace(moe, num_experts=min(moe.num_experts, 4),
                          top_k=min(moe.top_k, 2), expert_dim=32)
        ssm = self.ssm
        if ssm is not None:
            ssm = replace(ssm, state_dim=4, conv_dim=4, expand=2)
        rwkv = self.rwkv
        if rwkv is not None:
            rwkv = replace(rwkv, head_dim=16, decay_lora=8, gate_lora=8)
        fe = self.frontend
        if fe is not None:
            fe = replace(fe, input_dim=16, prefix_len=4)
        period = self.hybrid_period
        layers = (2 * period) if period else 2
        return replace(
            self, name=self.name + "-smoke",
            num_layers=layers, d_model=64,
            d_ff=128, vocab_size=256, attention=att, moe=moe, ssm=ssm,
            rwkv=rwkv, frontend=fe, max_seq_len=128, remat="none",
            loss_chunk=64,
        )


@dataclass(frozen=True)
class TrainPolicy:
    """One validated bundle for every train-time execution-policy axis, as
    the JAX package's ``TrainPolicy``: build one, ``validate()`` it against
    the model's attention geometry (incoherent combinations fail at config
    time), and ``apply()`` it to a ``ModelConfig``.

    Fields:
      * ``remat``    — "none" | "full" | "codes" (the layer loop's
                       checkpointing, core/remat.py).
      * ``bwd_emit`` — FlashSFA backward emit layout, "dense" | "compact" |
                       "compact2".
      * ``fwd_fuse`` — fused projection -> top-k forward with block-skip
                       FlashSFA on seam-eligible layers.
      * ``ring``     — Ring-SFA context parallelism over the mesh's "seq"
                       axis (distributed/ring.py).
      * ``tp``       — intended tensor-parallel degree (the mesh's "model"
                       axis, distributed/shard.py), for the divisibility check.
      * ``backend``  — optional attention-backend override in this
                       package's registry names: "torch" | "cuda" | "auto"
                       (None = keep ``cfg.attention.backend``).
    """
    remat: Union[str, bool] = "full"
    bwd_emit: str = "dense"
    fwd_fuse: bool = True
    ring: bool = False
    tp: int = 1
    backend: Optional[str] = None

    @classmethod
    def from_model(cls, cfg: ModelConfig, **overrides) -> "TrainPolicy":
        """The policy a ``ModelConfig`` already encodes, with overrides."""
        a = cfg.attention
        base = dict(remat=cfg.remat,
                    bwd_emit=a.bwd_emit if a is not None else "dense",
                    fwd_fuse=a.fwd_fuse if a is not None else True,
                    ring=a.ring if a is not None else False)
        base.update(overrides)
        return cls(**base)

    def validate(self, attention: Optional[AttentionConfig] = None) -> "TrainPolicy":
        """Reject incoherent combinations; returns a normalized policy."""
        remat = self.remat
        if isinstance(remat, bool):
            warnings.warn('TrainPolicy.remat as a bool is deprecated; use '
                          'remat="none"|"full"|"codes"', DeprecationWarning,
                          stacklevel=2)
            remat = "full" if remat else "none"
        if remat not in REMAT_POLICIES:
            raise ValueError(f"TrainPolicy.remat={self.remat!r}; expected "
                             f"one of {REMAT_POLICIES}")
        if self.bwd_emit not in ("dense", "compact", "compact2"):
            raise ValueError(f"TrainPolicy.bwd_emit={self.bwd_emit!r}; "
                             f'expected "dense" | "compact" | "compact2"')
        if self.tp < 1:
            raise ValueError(f"TrainPolicy.tp={self.tp}; expected >= 1")
        if self.backend not in (None, "torch", "cuda", "auto"):
            raise ValueError(f"TrainPolicy.backend={self.backend!r}; expected "
                             f'"torch" | "cuda" | "auto" or None')
        backend = self.backend if self.backend is not None else (
            attention.backend if attention is not None else None)
        if remat == "codes":
            if attention is None or attention.sfa_k is None:
                raise ValueError(
                    'remat="codes" saves the SFA top-k codes as checkpoint '
                    "residuals; the model has no SFA attention (sfa_k unset)")
            if backend == "torch":
                raise ValueError(
                    'remat="codes" requires the cuda backend: only its '
                    "kernel path produces the codes it would save")
        if self.ring and attention is not None:
            if attention.sfa_k is None:
                raise ValueError("ring=True needs an SFA layer (sfa_k unset)")
            if not attention.causal:
                raise ValueError("ring=True: the ring hop schedule is the "
                                 "causal triangle; attention is bidirectional")
            if attention.mla is not None:
                raise ValueError("ring=True: MLA latent attention has no "
                                 "ring path")
        if self.tp > 1 and attention is not None:
            if attention.num_heads % self.tp or attention.num_kv_heads % self.tp:
                raise ValueError(
                    f"tp={self.tp} does not divide heads "
                    f"{attention.num_heads}/{attention.num_kv_heads}")
        return self if remat == self.remat else replace(self, remat=remat)

    def apply(self, cfg: ModelConfig) -> ModelConfig:
        """Validate against ``cfg`` and return the configured model."""
        pol = self.validate(cfg.attention)
        updates = {"remat": pol.remat}
        if cfg.attention is not None:
            att_updates = {"bwd_emit": pol.bwd_emit, "fwd_fuse": pol.fwd_fuse,
                           "ring": pol.ring}
            if pol.backend is not None:
                att_updates["backend"] = pol.backend
            updates["attention"] = replace(cfg.attention, **att_updates)
        return replace(cfg, **updates)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a sequence length and a global batch for one
    kind of step (the JAX package's ``ShapeConfig``)."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def skip_reason(model: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Why the (model, shape) cell does not run, as the JAX package's
    ``skip_reason`` says (None: it runs)."""
    if not model.causal and shape.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k":
        sub_quadratic = (
            model.family in ("ssm", "hybrid")
            or (model.attention is not None
                and model.attention.local_global_pattern is not None)
        )
        if not sub_quadratic:
            return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
