"""Frozen, grouped engine configuration (a copy of the JAX package's
``serve/config.py``, which cannot be imported without JAX).

Five small frozen dataclasses — KV layout, scheduling shape, speculation,
robustness, observability — compose one :class:`EngineConfig`,
constructed as

    engine = ContinuousBatchingEngine(model, config=EngineConfig(
        kv=KVConfig(kv_mode="paged", kv_dtype="int8", prefix_cache=True),
        scheduling=SchedulingConfig(max_slots=8, max_len=1024),
    ))

Every cfg-independent validity rule lives in ``__post_init__`` here and
raises a typed :class:`~repro_torch.serve.errors.ConfigError` (is-a
``ValueError``) *before* any device work; rules that need the
``ModelConfig`` stay in the engine.  The port's engine also takes the flat
kwargs, mapped through :meth:`EngineConfig.from_kwargs`.  Groups and
fields the port's engine does not serve yet raise ``ConfigError`` there,
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.kvcache.paged import KV_DTYPES
from repro_torch.serve.errors import ConfigError


@dataclasses.dataclass(frozen=True)
class KVConfig:
    """KV-cache layout: dense slot pool vs. paged entry stream, page
    payload precision, and prefix sharing.

    ``kv_dtype`` (None | "int8" | "int4") quantizes page payloads with
    per-(entry, head) power-of-two scales; ``prefix_cache`` turns on the
    refcounted prompt-prefix registry with records published every
    ``prefix_block`` tokens.  Both are paged-only levers."""
    kv_mode: str = "dense"
    page_size: int = 16
    num_pages: Optional[int] = None
    kv_dtype: Optional[str] = None
    prefix_cache: bool = False
    prefix_block: int = 16
    prefix_max_records: int = 256


@dataclasses.dataclass(frozen=True)
class SchedulingConfig:
    """Batch shape and dispatch cadence.  ``None`` for ``prefill_chunk``
    / ``decode_steps`` defers to the ModelConfig's serving defaults
    (``cfg.prefill_chunk`` / ``cfg.decode_steps_per_dispatch``)."""
    max_slots: int = 4
    max_len: int = 512
    prefill_buckets: Optional[Tuple[int, ...]] = None
    prefill_chunk: Optional[int] = None
    decode_steps: Optional[int] = None
    step_tokens: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Self-speculative decoding."""
    spec_k: int = 0
    draft_keep: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RobustnessConfig:
    """Fault injection, watchdog, snapshots and load shedding."""
    faults: Any = None
    watchdog: Any = None
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 1
    max_queue_depth: Optional[int] = None
    max_queue_delay_s: Optional[float] = None
    max_preemptions: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Tracing and distributed placement.  ``trace`` accepts a bool, a
    Tracer, or an output path."""
    trace: Any = None
    mesh: Any = None
    sharding_policy: Any = None


# flat kwarg -> (EngineConfig group field, group attribute)
_LEGACY_MAP = {
    "max_slots": ("scheduling", "max_slots"),
    "max_len": ("scheduling", "max_len"),
    "prefill_buckets": ("scheduling", "prefill_buckets"),
    "prefill_chunk": ("scheduling", "prefill_chunk"),
    "decode_steps": ("scheduling", "decode_steps"),
    "step_tokens": ("scheduling", "step_tokens"),
    "kv_mode": ("kv", "kv_mode"),
    "page_size": ("kv", "page_size"),
    "num_pages": ("kv", "num_pages"),
    "kv_dtype": ("kv", "kv_dtype"),
    "prefix_cache": ("kv", "prefix_cache"),
    "prefix_block": ("kv", "prefix_block"),
    "spec_k": ("spec", "spec_k"),
    "draft_keep": ("spec", "draft_keep"),
    "faults": ("robustness", "faults"),
    "watchdog": ("robustness", "watchdog"),
    "snapshot_dir": ("robustness", "snapshot_dir"),
    "snapshot_every": ("robustness", "snapshot_every"),
    "max_queue_depth": ("robustness", "max_queue_depth"),
    "max_queue_delay_s": ("robustness", "max_queue_delay_s"),
    "max_preemptions": ("robustness", "max_preemptions"),
    "trace": ("obs", "trace"),
    "mesh": ("obs", "mesh"),
    "sharding_policy": ("obs", "sharding_policy"),
    "temperature": (None, "temperature"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Complete ``ContinuousBatchingEngine`` configuration."""
    kv: KVConfig = dataclasses.field(default_factory=KVConfig)
    scheduling: SchedulingConfig = dataclasses.field(
        default_factory=SchedulingConfig)
    spec: SpecConfig = dataclasses.field(default_factory=SpecConfig)
    robustness: RobustnessConfig = dataclasses.field(
        default_factory=RobustnessConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    temperature: float = 0.0

    def __post_init__(self):
        kv, sched, spec = self.kv, self.scheduling, self.spec
        if kv.kv_mode not in ("dense", "paged"):
            raise ConfigError(f"unknown kv_mode {kv.kv_mode!r}")
        if kv.page_size < 1 or (kv.num_pages is not None
                                and kv.num_pages < 1):
            raise ConfigError("num_pages and page_size must be >= 1")
        if kv.kv_dtype not in KV_DTYPES:
            raise ConfigError(f"kv_dtype must be one of {KV_DTYPES}, "
                              f"got {kv.kv_dtype!r}")
        if kv.kv_mode != "paged":
            if kv.kv_dtype is not None:
                raise ConfigError("kv_dtype quantizes page payloads — a "
                                  "paged-KV lever; set kv_mode='paged' or "
                                  "leave it None")
            if kv.prefix_cache:
                raise ConfigError("prefix_cache shares page chains across "
                                  "slots — a paged-KV lever; set "
                                  "kv_mode='paged'")
        if kv.prefix_block < 1:
            raise ConfigError("prefix_block must be >= 1 token")
        if kv.prefix_max_records < 1:
            raise ConfigError("prefix_max_records must be >= 1")
        if sched.max_slots < 1 or sched.max_len < 1:
            raise ConfigError("max_slots and max_len must be >= 1")
        if sched.prefill_chunk is not None and sched.prefill_chunk < 0:
            raise ConfigError("prefill_chunk must be >= 0 (0 = monolithic)")
        if sched.decode_steps is not None and sched.decode_steps < 1:
            raise ConfigError("decode_steps must be >= 1 (1 = single-step)")
        if sched.step_tokens is not None and sched.step_tokens < 1:
            raise ConfigError("step_tokens must be >= 1")
        if spec.spec_k < 0:
            raise ConfigError("spec_k must be >= 0 (0 = off)")
        if spec.spec_k and (sched.decode_steps or 1) > 1:
            raise ConfigError(
                "spec_k and decode_steps > 1 are mutually exclusive — "
                "both amortize host overhead over multi-token "
                "dispatches; pick one")
        if spec.draft_keep is not None and not 0.0 < spec.draft_keep <= 1.0:
            raise ConfigError("draft_keep must be in (0, 1]")

    @classmethod
    def from_kwargs(cls, **kwargs) -> "EngineConfig":
        """Build from the flat kwargs (also handy for CLI front-ends
        holding a flat namespace).  Unknown names raise ``TypeError``,
        like any bad keyword argument."""
        groups = {"kv": {}, "scheduling": {}, "spec": {},
                  "robustness": {}, "obs": {}}
        top = {}
        for name, value in kwargs.items():
            if name not in _LEGACY_MAP:
                raise TypeError(
                    f"ContinuousBatchingEngine got an unexpected keyword "
                    f"argument {name!r}")
            group, attr = _LEGACY_MAP[name]
            if name == "prefill_buckets" and value is not None:
                value = tuple(int(b) for b in value)
            if group is None:
                top[attr] = value
            else:
                groups[group][attr] = value
        return cls(kv=KVConfig(**groups["kv"]),
                   scheduling=SchedulingConfig(**groups["scheduling"]),
                   spec=SpecConfig(**groups["spec"]),
                   robustness=RobustnessConfig(**groups["robustness"]),
                   obs=ObsConfig(**groups["obs"]), **top)
