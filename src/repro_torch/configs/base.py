"""Model/config system of the PyTorch port.

The port keeps its own copy of the JAX package's ``configs/base.py`` so that
it imports nothing of that package; the dataclasses, ``smoke()`` and the
registry are the same.  A ``ModelConfig`` fully describes one architecture:
the transformer backbone, the SkipGPT dynamic-computation settings and
quantization.  ``smoke()`` shrinks a config to a CPU-runnable size with
identical structure.  Fields that only the JAX package reads (``remat``,
``scan_layers``, ``use_kernels``, ...) are kept so the two copies stay
field-for-field comparable; the port ignores them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Block kinds usable in ``layer_pattern`` (cycled over the layer stack).
ATTN = "attn"          # global causal attention
LOCAL = "local"        # sliding-window causal attention
MAMBA = "mamba"        # Mamba-2 SSD block (attention-free)

VALID_BLOCKS = (ATTN, LOCAL, MAMBA)

# Assigned input-shape grid (same 4 shapes for every LM arch).
SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class SkipConfig:
    """SkipGPT dynamic-computation-allocation settings (the paper's technique)."""

    enabled: bool = True
    # Fraction of tokens that *keep* (execute) each routed submodule.  The paper
    # prunes ~25% => keep 0.75.
    keep_prob: float = 0.75
    # Straight-through Gumbel temperature used at training time.
    tau: float = 1.0
    # Execution realization: "masked" multiplies submodule output by the 0/1
    # gate (training-faithful; no FLOP savings), "gather" compacts the kept
    # tokens into a static-capacity tile (TPU-native FLOP savings).
    mode: str = "masked"
    # Cross-layer KV reuse for tokens that skip attention (paper §2.1/§4.4).
    kv_reuse: bool = True
    # Router aux-loss weight steering the average keep rate to ``keep_prob``.
    router_loss_weight: float = 1e-2
    # Route these submodules.  Mamba blocks use masked-contribution routing.
    route_attention: bool = True
    route_mlp: bool = True
    route_ssm: bool = True


@dataclass(frozen=True)
class QuantConfig:
    """Weight quantization (paper §4.2: INT4 weights, FP16/bf16 activations,
    BFP fixed-point accumulation)."""

    enabled: bool = False
    bits: int = 4
    group_size: int = 128
    # Use power-of-2 ("BFP") scales so accumulation happens in a shared-exponent
    # integer domain, mirroring the paper's accumulation tree.
    pow2_scales: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads

    # --- attention details -------------------------------------------------
    layer_pattern: Tuple[str, ...] = (ATTN,)
    window_size: int = 0             # for LOCAL blocks
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0
    pos_embedding: str = "rope"      # rope | mrope | sinusoidal | none
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"          # swiglu | geglu | gelu_mlp
    tie_embeddings: bool = False

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 0               # every n-th layer is MoE (0 => never)
    dense_residual: bool = False     # Arctic: dense MLP in parallel with MoE
    moe_capacity_factor: float = 1.25
    moe_lb_weight: float = 0.01

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # --- frontend ------------------------------------------------------------
    frontend: str = "token"          # token | audio_stub | vlm_stub

    # --- paper technique ------------------------------------------------------
    skip: SkipConfig = field(default_factory=SkipConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)

    # --- numerics / execution -------------------------------------------------
    dtype: str = "bfloat16"
    # decode KV cache layout: "bthd" (default) or "bhtd" (head-major — the
    # attention dot consumes it transpose-free; §Perf hillclimb lever)
    kv_cache_layout: str = "bthd"
    attn_chunk: int = 1024           # KV-block size of the chunked attention scan
    xent_chunk: int = 1024           # sequence-block size of the chunked softmax-xent
    remat: bool = True
    use_kernels: bool = False        # Pallas kernels (TPU); False => pure-jnp path
    # Fused linear pipeline (norm-prologue × matmul × epilogue kernels +
    # the incremental-reduction carry).  Only meaningful with use_kernels;
    # False keeps the per-op kernel dispatch (parity/debug lever).
    fuse_linear: bool = True
    # Chunked (resumable) prefill for the continuous-batching engine:
    # prompts are processed ``prefill_chunk`` tokens at a time, scheduled
    # *between* resident decode steps so a long prompt cannot stall every
    # decode slot (head-of-line blocking).  0 = monolithic prefill — the
    # parity default; token output is identical either way.  Requires an
    # all-global-attention stack with masked-mode routing; the engine's
    # ``prefill_chunk=`` argument overrides this per-deployment.  The
    # port's engine does not serve it yet and raises ``ConfigError``.
    prefill_chunk: int = 0
    # Device-resident multi-step decode for the continuous-batching engine:
    # N decode iterations (step + sampling + stop/length detection +
    # position advance) fuse into ONE jitted ``lax.scan`` dispatch, so the
    # host syncs once per N tokens instead of once per token and its
    # scheduling work (admission, page headroom, ``plan_step``) overlaps
    # the in-flight device epoch.  1 = the single-step engine (parity
    # default; token output is identical either way at temperature 0).
    # The engine's ``decode_steps=`` argument overrides per-deployment.
    decode_steps_per_dispatch: int = 1
    scan_layers: bool = True

    # ------------------------------------------------------------------ helpers
    def __post_init__(self):
        for b in self.layer_pattern:
            if b not in VALID_BLOCKS:
                raise ValueError(f"unknown block kind {b!r}")
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.layer_pattern)}"
            )
        if self.moe_every and len(self.layer_pattern) % self.moe_every != 0:
            # the scan super-block must contain a whole number of MoE periods
            if self.moe_every % len(self.layer_pattern) != 0 and \
               len(self.layer_pattern) % self.moe_every != 0:
                raise ValueError(f"{self.name}: moe_every incompatible with pattern")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_inner_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_inner_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def stage_len(self) -> int:
        """Layers per scan super-block: lcm(pattern, moe period)."""
        p = len(self.layer_pattern)
        if self.moe_every:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def num_stages(self) -> int:
        return self.num_layers // self.stage_len

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner_ssm // self.ssm_headdim if self.ssm_state else 0

    def block_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.moe_every or self.block_kind(layer_idx) == MAMBA:
            return False
        return (layer_idx % self.moe_every) == (self.moe_every - 1)

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(
            i for i in range(self.num_layers) if self.block_kind(i) in (ATTN, LOCAL)
        )

    @property
    def is_subquadratic(self) -> bool:
        """True when the arch can run 500k-token contexts (SSM/hybrid/local)."""
        return ATTN not in self.layer_pattern or (
            MAMBA in self.layer_pattern or LOCAL in self.layer_pattern
        )

    def supported_shapes(self) -> Tuple[str, ...]:
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.is_subquadratic:
            names.append("long_500k")
        return tuple(names)

    # --- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----------------
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.resolved_head_dim
        n = 0
        emb = self.vocab_size * d
        n += emb                                   # input embedding
        if not self.tie_embeddings:
            n += emb                               # lm head
        for i in range(self.num_layers):
            kind = self.block_kind(i)
            if kind in (ATTN, LOCAL):
                q = d * self.attn_inner_dim
                kv = 2 * d * self.kv_inner_dim
                o = self.attn_inner_dim * d
                n += q + kv + o + d                # + input norm
                if self.qk_norm:
                    n += 2 * h
            elif kind == MAMBA:
                di, g, ns = self.d_inner_ssm, self.ssm_groups, self.ssm_state
                nh = self.ssm_nheads
                in_proj = d * (2 * di + 2 * g * ns + nh)
                conv = (di + 2 * g * ns) * self.ssm_conv
                out_proj = di * d
                n += in_proj + conv + out_proj + 2 * nh + di + d  # A,dt_bias,D,norms
            # MLP / MoE
            if kind == MAMBA:
                continue
            glu = self.mlp_act in ("swiglu", "geglu")
            per_ffn = d * self.d_ff * (3 if glu else 2)
            if self.is_moe_layer(i):
                e = self.top_k if active_only else self.num_experts
                n += e * per_ffn + d * self.num_experts + d  # experts + gate + norm
                if self.dense_residual:
                    n += per_ffn
            elif self.d_ff:
                n += per_ffn + d
            if self.skip.enabled:
                n += 2 * d * 2                     # two routers (attn + mlp)
        n += d                                     # final norm
        return n

    # --- smoke config ----------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Reduced config of the same family, runnable on CPU."""
        pat = self.layer_pattern
        layers = len(pat) * (2 if len(pat) <= 4 else 1)
        if self.moe_every:
            layers = max(layers, math.lcm(len(pat), self.moe_every))
        nh = min(self.num_heads, 4)
        nkv = min(self.num_kv_heads, nh)
        if nh % nkv:
            nkv = 1
        sections = self.mrope_sections
        if sum(sections):
            sections = (8, 12, 12)  # scaled to head_dim 64 (pairs: 32)
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=128,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=64 if (self.head_dim or sum(sections)) else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=8,
            window_size=16 if self.window_size else 0,
            mrope_sections=sections,
            attn_chunk=32,
            xent_chunk=32,
            remat=False,
            use_kernels=False,
        )


# ---------------------------------------------------------------------------
# Registry
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides: Any) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return replace(cfg, **overrides) if overrides else cfg


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401

    return tuple(sorted(_REGISTRY))
