"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package: the jnp oracles in ``repro.kernels.ref`` and the Pallas kernels
in interpret mode.  Also: the port imports nothing of JAX, and its wrappers
and entry points raise instead of falling back when CUDA is asked for and
missing.

Tolerances (fp32 on both sides): outputs ≤ 1e-4·max|ref| (the sums run in
another order), Σy² and mean_sq ≤ 1e-5 relative."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_packed
from repro.kernels.fused_linear import fused_linear_pallas
from repro.kernels.fused_router_rmsnorm import router_stats_pallas
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_linear as fl
from repro_torch.kernels import fused_router_rmsnorm as frr
from repro_torch.kernels import int4_matmul as im
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

TOL = 1e-4
TOL_SQ = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _rel(out, ref, tol=TOL_SQ):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.all(np.abs(out - ref) <= tol * np.abs(ref))


# ---------------------------------------------------------------------------
# Router stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,D", [(1, 64), (4, 200), (37, 300), (16, 256),
                                 (17, 256)])
def test_router_stats_matches_oracle_and_pallas(T, D):
    rng = np.random.default_rng(T + D)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, 2)) * 0.1).astype(np.float32)
    lo, ms = frr.router_stats(torch.from_numpy(x), torch.from_numpy(w))
    for jl, jm in (jref.router_stats_ref(jnp.asarray(x), jnp.asarray(w)),
                   router_stats_pallas(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True)):
        _close(lo, jl)
        _rel(ms, jm)
    b = rng.standard_normal(2).astype(np.float32)
    pl, pm = ops.fused_router_rmsnorm_stats(
        torch.from_numpy(x)[None], torch.from_numpy(w), torch.from_numpy(b))
    jl, jm = jops.fused_router_rmsnorm_stats(jnp.asarray(x)[None],
                                             jnp.asarray(w), jnp.asarray(b))
    _close(pl, jl)
    _rel(pm, jm)


# ---------------------------------------------------------------------------
# Fused linear, dense weights
# ---------------------------------------------------------------------------

# prologue, glu, gate_mul, residual, emit_sq — the main path's four linears
# (wqkv, gu, wo/down) plus the other combinations
_FEATURES = [
    (True, False, False, False, False),    # wqkv
    (True, True, False, False, False),     # gu
    (False, False, True, True, True),      # wo / down
    (False, False, False, True, True),     # residual + Σy², no gate
    (False, False, False, False, True),    # Σy² alone
    (True, True, True, True, True),        # everything
]


@pytest.mark.parametrize("M", [1, 4, 37])
@pytest.mark.parametrize("prologue,glu,gmul,res,emit_sq", _FEATURES)
def test_fused_linear_matches_oracle_and_pallas(M, prologue, glu, gmul, res,
                                                emit_sq):
    rng = np.random.default_rng(M * 100 + len(_FEATURES))
    K, F = 200, 70                                  # ragged K and F
    N = 2 * F if glu else F
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    kw = {}
    if prologue:
        kw["mean_sq"] = (x ** 2).mean(-1).astype(np.float32)
        kw["gamma"] = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    if res:
        kw["residual"] = rng.standard_normal((M, F)).astype(np.float32)
    if gmul:
        kw["gate_mul"] = (rng.random(M) > 0.5).astype(np.float32)
    act = "silu" if glu else None
    out, sq = ops.fused_linear(
        {"w": torch.from_numpy(w)}, torch.from_numpy(x), glu=glu, act=act,
        emit_sq=emit_sq, **{k: torch.from_numpy(v) for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    for jo, jsq in (
            jref.fused_linear_ref(jnp.asarray(x), w=jnp.asarray(w), glu=glu,
                                  act=act, emit_sq=emit_sq, **jkw),
            fused_linear_pallas(jnp.asarray(x), jnp.asarray(w), glu=glu,
                                act=act, emit_sq=emit_sq, interpret=True,
                                **jkw)):
        _close(out, jo)
        if emit_sq:
            _rel(sq, jsq)
        else:
            assert sq is None and jsq is None


def test_fused_linear_leading_dims():
    rng = np.random.default_rng(7)
    B, T, K, F = 2, 5, 96, 40
    x = rng.standard_normal((B, T, K)).astype(np.float32)
    w = (rng.standard_normal((K, F)) * 0.05).astype(np.float32)
    res = rng.standard_normal((B, T, F)).astype(np.float32)
    gm = (rng.random((B, T)) > 0.5).astype(np.float32)
    out, sq = ops.fused_linear({"w": torch.from_numpy(w)},
                               torch.from_numpy(x),
                               residual=torch.from_numpy(res),
                               gate_mul=torch.from_numpy(gm), emit_sq=True)
    jo, jsq = jops.fused_linear({"w": jnp.asarray(w)}, jnp.asarray(x),
                                residual=jnp.asarray(res),
                                gate_mul=jnp.asarray(gm), emit_sq=True,
                                use_kernel=False)
    assert out.shape == (B, T, F) and sq.shape == (B, T)
    _close(out, jo)
    _rel(sq, jsq)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

_ATTN = [
    # B, Tq, Tk, Hq, Hkv, dh, window, with kv_valid_len
    (2, 1, 40, 4, 4, 32, 0, True),     # decode against a cache
    (2, 1, 40, 4, 2, 32, 0, True),     # decode, G = 2
    (2, 24, 24, 4, 4, 32, 0, False),   # prefill
    (2, 24, 24, 4, 2, 32, 0, True),    # prefill, G = 2, ragged kv_len
    (1, 24, 24, 4, 4, 64, 8, False),   # sliding window
]


def _attn_inputs(B, Tq, Tk, Hq, Hkv, dh, with_len, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hkv, dh)).astype(np.float32)
    if Tq == 1:
        kvl = rng.integers(1, Tk + 1, B).astype(np.int32)
        pos = (kvl - 1)[:, None].astype(np.int32)
    else:
        pos = np.broadcast_to(np.arange(Tq, dtype=np.int32), (B, Tq)).copy()
        kvl = (np.full(B, Tk, np.int32) - np.arange(B, dtype=np.int32)
               if with_len else None)
    return q, k, v, pos, kvl


@pytest.mark.parametrize("B,Tq,Tk,Hq,Hkv,dh,window,with_len", _ATTN)
def test_flash_attention_matches_oracle_and_pallas(B, Tq, Tk, Hq, Hkv, dh,
                                                   window, with_len):
    q, k, v, pos, kvl = _attn_inputs(B, Tq, Tk, Hq, Hkv, dh, with_len,
                                     seed=Tq + Hkv + window)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    fn = ops.decode_attention if Tq == 1 else ops.flash_attention
    kw = {} if Tq == 1 else {"causal": True}
    out = fn(t(q), t(k), t(v), q_positions=t(pos), window=window,
             kv_valid_len=t(kvl), **kw)
    jo = jref.flash_attention_ref(j(q), j(k), j(v), q_positions=j(pos),
                                  window=window, kv_valid_len=j(kvl))
    _close(out, jo)
    jk = jops.flash_attention(j(q), j(k), j(v), q_positions=j(pos),
                              window=window, kv_valid_len=j(kvl))
    _close(out, jk)


def test_flash_attention_packed_matches_pallas():
    """The plain packed version against the Pallas kernel on the same packed
    inputs, pad rows (position −1) excluded."""
    q, k, v, pos, kvl = _attn_inputs(2, 24, 24, 4, 2, 32, True, seed=3)
    qp, kp, vp, ppos, plen, _ = jops._pack_heads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(kvl))
    ppos = np.asarray(ppos).copy()
    ppos[:, -3:] = -1                                  # pad rows
    want = flash_attention_packed(qp, kp, vp, jnp.asarray(ppos), plen,
                                  scale=1 / np.sqrt(32), interpret=True)
    from repro_torch.kernels import ref
    got = ref.flash_attention_packed_ref(
        torch.tensor(np.asarray(qp)), torch.tensor(np.asarray(kp)),
        torch.tensor(np.asarray(vp)), torch.from_numpy(ppos),
        torch.tensor(np.asarray(plen))[:, 0], scale=1 / np.sqrt(32))
    _close(got[:, :-3], np.asarray(want)[:, :-3])
    assert torch.count_nonzero(got[:, -3:]) == 0      # pad rows are zeros


@pytest.mark.parametrize("G", [1, 2, 4])
def test_pack_heads_matches_reference(G):
    Hkv = 2
    q, k, v, pos, kvl = _attn_inputs(2, 5, 9, Hkv * G, Hkv, 32, True, seed=G)
    mine = ops._pack_heads(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(pos),
                           torch.from_numpy(kvl))
    theirs = jops._pack_heads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(kvl))
    for a, b in zip(mine[:5], theirs[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert mine[5] == theirs[5]


# ---------------------------------------------------------------------------
# No JAX in the port; no fallback when CUDA is asked for
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import repro(\.|\s|$)|from repro(\.|\s))",
    re.MULTILINE)


def test_port_imports_no_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/quant/int4.py",
            "src/repro_torch/kernels/int4_matmul.py",
            "src/repro_torch/kvcache/prefix.py",
            "src/repro_torch/obs/metrics.py",
            "src/repro_torch/obs/trace.py",
            "src/repro_torch/serve/faults.py",
            "src/repro_torch/serve/snapshot.py"} <= names
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad


def test_wrappers_raise_instead_of_falling_back(monkeypatch, tmp_path):
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        frr.router_stats(torch.empty(4, 64, **meta),
                         torch.empty(64, 2, **meta))
    with pytest.raises(ValueError):
        fl.fused_linear(torch.empty(4, 64, **meta),
                        torch.empty(64, 32, **meta))
    pos = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.empty(2, 1, 1, 32, **meta),
                           torch.empty(2, 8, 1, 32, **meta),
                           torch.empty(2, 8, 1, 32, **meta), pos,
                           torch.ones(2, dtype=torch.int32), scale=1.0)
    codes = torch.empty(128, 32, dtype=torch.int8, **meta)
    scale = torch.empty(1, 32, **meta)
    with pytest.raises(ValueError):
        fl.fused_linear(torch.empty(4, 64, **meta), w_codes=codes,
                        scale=scale)
    with pytest.raises(ValueError):
        im.int4_matmul(torch.empty(4, 128, **meta), codes, scale)
    with pytest.raises(ValueError):
        pa.paged_attention(torch.empty(2, 1, 2, 32, **meta),
                           torch.empty(4, 4, 1, 32, **meta),
                           torch.empty(4, 4, 1, 32, **meta),
                           torch.zeros(2, 2, dtype=torch.int32),
                           torch.zeros(2, 8, dtype=torch.int32),
                           torch.empty(2, 1, 1, 32, **meta),
                           torch.empty(2, 1, 1, 32, **meta), pos, scale=1.0)
    assert frr.launches == fl.launches == fa.launches == pa.launches == 0
    assert fl.launches_int4 == im.launches == 0
    assert fl.launches_wgmma == fl.launches_splitk == fl.launches_simt == 0
    assert fl.launches_int4_tc == fl.launches_int4_stream == 0
    assert im.launches_tc == im.launches_stream == 0
    assert fa.launches_wgmma == fa.launches_splitkv == fa.launches_simt == 0
    assert pa.launches_split == pa.launches_simt == 0
    # no nvcc: the build raises rather than handing back a plain version
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LanguageModel(get_config("llama2-7b").smoke())
    with pytest.raises(RuntimeError, match="cuda"):
        LanguageModel(get_config("llama2-7b").smoke(), device="cuda")
