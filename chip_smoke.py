#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printing one JSON line (any failure raises and exits non-zero):
  1. device   — the card (``nvidia-smi`` name and power limit, printed raw too);
  2. build    — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
  3. kernels  — each kernel against its plain PyTorch version on the card, at
                the llama2-7b main-path shapes, in bf16 and fp32, with times;
                then at ragged shapes off the tile multiples (not timed);
  4. parity   — llama2-7b smoke in fp32 through the port on cuda (kernels)
                and on cpu (plain versions): gates, logits, tokens;
  5. serve    — full-width llama2-7b in bf16 (random seeded weights, neutral
                router bias) served by ``ServeEngine.generate``: batch 4 x
                prompt 512 + 32 new tokens, greedy; every kernel's launch
                count over that run must be > 0.
Then the ``kernels`` summary line, and last the contract line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
LOG_DIR = os.path.join(ROOT, "build")          # listed in .gitignore

# Published H100 SXM peaks (NVIDIA data sheet): device memory rate and the
# dense bf16 tensor-core rate.  bound_ms = max(bytes / rate, ops / rate).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# Tolerances (kernel vs plain version on the same inputs).
TOL_F32 = 1e-4        # x max|ref|: fp32 sums in another order over K ≤ 11008
TOL_BF16 = 2.0 ** -7  # x max|ref|: two bf16 ulps at the maximum
TOL_SQ = 1e-5         # relative, Σy² and mean_sq (fp32 outputs)
TOL_LOGITS = 1e-4     # x max|logits|, phase 4 (fp32 model)
MIN_MARGIN = 1e-3     # phase 4: no router decision this close to its tie
PARITY_SEED = 6   # its margins clear MIN_MARGIN (checked every run)

TPU_KERNELS = {
    "router_stats": "src/repro/kernels/fused_router_rmsnorm.py:55",
    "fused_linear": "src/repro/kernels/fused_linear.py:135",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
}
SOURCES = {
    "router_stats": "src/repro_torch/kernels/csrc/router_stats.cu",
    "fused_linear": "src/repro_torch/kernels/csrc/fused_linear.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median CUDA-event time of one call on the device, L2 flushed before
    each run.  A ~2 ms device sleep precedes the start event, so the host
    has enqueued the call before the card reaches it and the events time
    device work, not Python and ctypes launch overhead."""

    SLEEP_CYCLES = 4_000_000

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 7, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def max_err(torch, out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at the main-path shapes
# ---------------------------------------------------------------------------

def check_router(torch, dev, timer, cfg):
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    D = cfg.d_model
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = []
    for T in (2048, 4):                   # prefill B·T0 = 4·512; decode B = 4
        x = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn((D, 2), generator=g, device=dev) * 0.02
        rel = {}
        for dt in (torch.bfloat16, torch.float32):
            xx = x.to(dt)
            lo, ms = frr.router_stats_cuda(xx, w)
            lr, mr = ref.router_stats_ref(xx, w)
            torch.cuda.synchronize()
            e, m = max_err(torch, lo, lr)
            require(e <= TOL_F32 * m, f"router logits {dt} T={T}: {e} > "
                    f"{TOL_F32}·{m}")
            sq_rel = ((ms - mr).abs() / mr.abs()).max().item()
            require(sq_rel <= TOL_SQ, f"router mean_sq {dt} T={T}: {sq_rel}")
            rel[str(dt).split(".")[-1]] = {"max_abs_err": e, "max_ref": m,
                                           "mean_sq_rel_err": sq_rel}
        ms_k = timer(lambda: frr.router_stats_cuda(x, w))
        ms_p = timer(lambda: ref.router_stats_ref(x, w))
        b, by = bound_ms(T * D * 2 + D * 2 * 4 + T * 3 * 4, 6.0 * T * D)
        shapes.append({"shape": f"x[{T},{D}] bf16", "ms": ms_k,
                       "plain_ms": ms_p, "library_ms": None, "bound_ms": b,
                       "bound_by": by, "tol": f"{TOL_F32}·max|ref|; "
                       f"mean_sq {TOL_SQ} rel", "errors": rel})
    return shapes


def check_fused_linear(torch, dev, timer, cfg):
    from repro_torch.kernels import fused_linear as fl, ref
    D, ai, ki, Fd = (cfg.d_model, cfg.attn_inner_dim, cfg.kv_inner_dim,
                     cfg.d_ff)
    linears = [  # name, K, N, glu, prologue, gate/residual/Σy² epilogue
        ("wqkv", D, ai + 2 * ki, False, True, False),
        ("wo", ai, D, False, False, True),
        ("gu", D, 2 * Fd, True, True, False),
        ("down", Fd, D, False, False, True)]
    g = torch.Generator(device=dev).manual_seed(12)
    shapes = []
    for M in (2048, 4):
        for name, K, N, glu, pro, epi in linears:
            F = N // 2 if glu else N
            bf = torch.bfloat16
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            w = (torch.randn((K, N), generator=g, device=dev)
                 / math.sqrt(K)).to(bf)
            kw = {"glu": glu, "act": "silu" if glu else None}
            if pro:
                kw["mean_sq"] = (x.float() ** 2).mean(-1)
                kw["gamma"] = (1 + 0.1 * torch.randn(
                    (K,), generator=g, device=dev)).to(bf)
            if epi:
                kw["residual"] = torch.randn((M, F), generator=g,
                                             device=dev).to(bf)
                kw["gate_mul"] = (torch.rand((M,), generator=g, device=dev)
                                  > 0.5).float()
                kw["emit_sq"] = True
            errs = {}
            for dt, tol in ((bf, TOL_BF16), (torch.float32, TOL_F32)):
                cast = {k: (v.to(dt) if isinstance(v, torch.Tensor)
                            and v.dtype == bf else v) for k, v in kw.items()}
                out, sq = fl.fused_linear_cuda(x.to(dt), w.to(dt), **cast)
                ro, rsq = ref.fused_linear_ref(
                    x.to(dt), w.to(dt), **{("act_name" if k == "act" else k): v
                                           for k, v in cast.items()})
                torch.cuda.synchronize()
                e, m = max_err(torch, out, ro)
                require(e <= tol * m, f"fused_linear {name} M={M} {dt}: "
                        f"{e} > {tol}·{m}")
                rec = {"max_abs_err": e, "max_ref": m}
                if epi:
                    sr = ((sq - rsq).abs() / rsq.abs()).max().item()
                    require(sr <= TOL_SQ, f"fused_linear {name} M={M} {dt} "
                            f"Σy² rel err {sr}")
                    rec["sq_rel_err"] = sr
                errs[str(dt).split(".")[-1]] = rec
                del out, sq, ro, rsq
            ms_k = timer(lambda: fl.fused_linear_cuda(x, w, **kw))
            ms_p = timer(lambda: ref.fused_linear_ref(
                x, w, **{("act_name" if k == "act" else k): v
                         for k, v in kw.items()}))
            ms_l = timer(lambda: torch.matmul(x, w))
            nbytes = (M * K + K * N + M * F) * 2 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0)
            b, by = bound_ms(nbytes, 2.0 * M * K * N)
            shapes.append({"shape": f"{name} M={M} K={K} N={N}",
                           "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
                           "bound_ms": b, "bound_by": by,
                           "tol": f"bf16 {TOL_BF16}·max|ref|, fp32 "
                           f"{TOL_F32}·max|ref|, Σy² {TOL_SQ} rel",
                           "errors": errs})
            del x, w, kw
    return shapes


def check_flash(torch, dev, timer, cfg):
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as fa
    B, H, dh = 4, cfg.num_heads, cfg.resolved_head_dim
    Hkv = cfg.num_kv_heads
    g = torch.Generator(device=dev).manual_seed(13)
    scale = 1.0 / math.sqrt(dh)
    shapes = []
    for label, Tq, Tk, t_last in (("prefill", 512, 512, None),
                                  ("decode", 1, 544, 543)):
        bf = torch.bfloat16
        q = torch.randn((B, Tq, H, dh), generator=g, device=dev).to(bf)
        k = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        v = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        if t_last is None:
            qpos = torch.arange(Tq, device=dev)[None].expand(B, Tq)
            kvl = None
        else:
            qpos = torch.full((B, 1), t_last, device=dev)
            kvl = torch.full((B,), t_last + 1, device=dev)
        pos, kv_len = fa.pack_positions(qpos, kvl, B, Hkv, H // Hkv, Tk)
        errs = {}
        for dt, tol in ((bf, TOL_BF16), (torch.float32, TOL_F32)):
            a = [t.to(dt) for t in (q, k, v)]
            out = fa.flash_attention_cuda(*a, pos, kv_len, scale=scale)
            ro = fa.flash_attention_plain(*a, pos, kv_len, scale=scale)
            torch.cuda.synchronize()
            e, m = max_err(torch, out, ro)
            require(e <= tol * m, f"flash {label} {dt}: {e} > {tol}·{m}")
            errs[str(dt).split(".")[-1]] = {"max_abs_err": e, "max_ref": m}
        ms_k = timer(lambda: fa.flash_attention_cuda(q, k, v, pos, kv_len,
                                                     scale=scale))
        ms_p = timer(lambda: fa.flash_attention_plain(q, k, v, pos, kv_len,
                                                      scale=scale))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms_l = timer(lambda: Fn.scaled_dot_product_attention(
            qt, kt, vt, is_causal=t_last is None))
        if t_last is None:
            pairs = B * H * Tq * (Tq + 1) // 2          # causal (q, key) pairs
            keys = Tk
        else:
            pairs = B * H * (t_last + 1)
            keys = t_last + 1
        nbytes = (2 * B * Tq * H * dh + 2 * B * keys * Hkv * dh) * 2
        b, by = bound_ms(nbytes, 4.0 * pairs * dh)
        shapes.append({"shape": f"{label} B={B} Tq={Tq} Tk={Tk} H={H} "
                       f"dh={dh}", "ms": ms_k, "plain_ms": ms_p,
                       "library_ms": ms_l, "bound_ms": b, "bound_by": by,
                       "tol": f"bf16 {TOL_BF16}·max|ref|, fp32 "
                       f"{TOL_F32}·max|ref|", "errors": errs})
    return shapes


def check_ragged(torch, dev):
    """Shapes off the main path's tile multiples (ragged M, K, F, Tq, Tk,
    G > 1, a window), against the plain versions, not timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    g = torch.Generator(device=dev).manual_seed(14)
    worst = {}

    def note(name, e, m, tol):
        require(e <= tol * m, f"ragged {name}: {e} > {tol}·{m}")
        worst[name] = max(worst.get(name, 0.0), e / m)

    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        x = torch.randn((37, 300), generator=g, device=dev).to(dt)
        w = torch.randn((300, 2), generator=g, device=dev)
        lo, ms = frr.router_stats_cuda(x, w)
        lr, mr = ref.router_stats_ref(x, w)
        note("router_stats", *max_err(torch, lo, lr), TOL_F32)
        require(((ms - mr).abs() / mr).max().item() <= TOL_SQ,
                "ragged router mean_sq")
        for M, K, F, glu in ((37, 200, 70, True), (5, 300, 130, False),
                             (130, 40, 200, False)):
            N = 2 * F if glu else F
            x = torch.randn((M, K), generator=g, device=dev).to(dt)
            w = (torch.randn((K, N), generator=g, device=dev) * 0.05).to(dt)
            kw = dict(mean_sq=(x.float() ** 2).mean(-1),
                      gamma=(1 + 0.1 * torch.randn((K,), generator=g,
                                                   device=dev)).to(dt),
                      glu=glu, residual=torch.randn(
                          (M, F), generator=g, device=dev).to(dt),
                      gate_mul=(torch.rand((M,), generator=g, device=dev)
                                > 0.5).float(), emit_sq=True)
            out, sq = fl.fused_linear_cuda(x, w, act="silu" if glu else None,
                                           **kw)
            ro, rsq = ref.fused_linear_ref(
                x, w, act_name="silu" if glu else None, **kw)
            note("fused_linear", *max_err(torch, out, ro), tol)
            require(((sq - rsq).abs() / rsq).max().item() <= TOL_SQ,
                    f"ragged fused_linear Σy² M={M} K={K} F={F}")
        for B, Tq, Tk, Hq, Hkv, dh, window in ((2, 24, 24, 4, 2, 64, 0),
                                               (1, 37, 37, 4, 4, 32, 8),
                                               (3, 1, 50, 8, 2, 128, 0)):
            q = torch.randn((B, Tq, Hq, dh), generator=g, device=dev).to(dt)
            k = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(dt)
            v = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(dt)
            kvl = torch.tensor([Tk - 3 * b for b in range(B)], device=dev)
            qpos = (kvl[:, None] - 1 if Tq == 1 else
                    torch.arange(Tq, device=dev)[None].expand(B, Tq))
            pos, kv_len = fa.pack_positions(qpos, kvl, B, Hkv, Hq // Hkv, Tk)
            s = 1.0 / math.sqrt(dh)
            out = fa.flash_attention_cuda(q, k, v, pos, kv_len, window=window,
                                          scale=s)
            ro = fa.flash_attention_plain(q, k, v, pos, kv_len, window=window,
                                          scale=s)
            note("flash_attention", *max_err(torch, out, ro), tol)
    torch.cuda.synchronize()
    return {"phase": "ragged", "max_err_over_max_ref": worst}


# ---------------------------------------------------------------------------
# Phase 4: CPU (plain versions) ≡ CUDA (kernels) on llama2-7b smoke, fp32
# ---------------------------------------------------------------------------

def _forced_run(model, toks, forced):
    import torch
    T = toks.shape[1]
    steps = forced.shape[1]
    lg, cache, st = model.prefill(toks, pad_to=T + steps)
    logits, gates = [lg.float().cpu()], [st["attn_gate"].cpu()]
    for s in range(steps):
        lg, cache, st = model.decode_step(cache, forced[:, s:s + 1], T + s)
        logits.append(lg.float().cpu())
        gates.append(st["attn_gate"].cpu())
    return logits, gates


def parity(torch, np, dev):
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config("llama2-7b").smoke(),
                              dtype="float32")
    params = routing.neutral_router_bias(
        init_params(cfg, torch.Generator().manual_seed(PARITY_SEED), "cpu"))
    for blk in params["blocks"]:            # routers at unit scale, so no
        for sub in blk.values():            # gate sits near the strict-`>`
            sub["router"]["w"] = sub["router"]["w"] * 50.0   # tie
    rng = np.random.default_rng(PARITY_SEED)
    m_cpu = LanguageModel(cfg, params, device="cpu")
    m_gpu = LanguageModel(cfg, params, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 3)))

    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append((logits[..., 1] - logits[..., 0]).abs().min().item())
        return orig(logits)

    routing.gate_from_logits = recording
    try:
        lc, gc = _forced_run(m_cpu, toks, forced)
    finally:
        routing.gate_from_logits = orig
    require(min(margins) >= MIN_MARGIN,
            f"gate margin {min(margins)} < {MIN_MARGIN}: pick another seed")
    lg, gg = _forced_run(m_gpu, toks, forced)
    for a, b in zip(gc, gg):
        require(torch.equal(a, b), "gate log differs between cpu and cuda")
    worst = 0.0
    for a, b in zip(lc, lg):
        d = (a - b).abs().max().item() / a.abs().max().item()
        worst = max(worst, d)
        require(d <= TOL_LOGITS, f"logits differ: {d} > {TOL_LOGITS}")
        require(torch.equal(a.argmax(-1), b.argmax(-1)),
                "greedy tokens differ between cpu and cuda")
    prompts = rng.integers(0, cfg.vocab_size, (2, 24))
    oc = ServeEngine(m_cpu, max_len=32).generate(prompts, 8)
    og = ServeEngine(m_gpu, max_len=32).generate(prompts, 8)
    require(np.array_equal(oc["tokens"], og["tokens"]),
            "ServeEngine tokens differ between cpu and cuda")
    require(oc["stats"].kv_saved_fraction == og["stats"].kv_saved_fraction,
            "kv_saved_fraction differs between cpu and cuda")
    gates = torch.cat([g.flatten() for g in gc])
    return {"phase": "parity", "config": cfg.name, "dtype": cfg.dtype,
            "gates_identical": True, "logits_max_rel_diff": worst,
            "tol": TOL_LOGITS, "greedy_tokens_identical": True,
            "serve_tokens_identical": True,
            "min_gate_margin": min(margins),
            "gate_ones_frac": gates.mean().item(),
            "kv_saved_fraction": og["stats"].kv_saved_fraction}


# ---------------------------------------------------------------------------
# Phase 5: full-width llama2-7b served by the lock-step engine
# ---------------------------------------------------------------------------

def serve_full_width(torch, np, dev):
    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.kernels import ops
    from repro_torch.models.model import LanguageModel
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("llama2-7b")
    B, T0, new = 4, 512, 32
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T0))
    eng = ServeEngine(model, max_len=T0 + new)

    ops.reset_kernel_launches()
    out = eng.generate(prompts, new)
    launches = ops.kernel_launches()
    s = out["stats"]
    L = cfg.num_layers
    expected = {"router_stats": 1 + new, "fused_linear": 4 * L * (1 + new),
                "flash_attention": L * (1 + new)}
    require(launches == expected,
            f"kernel launches {launches} != expected {expected}")
    require(0.0 < s.attn_keep_frac < 1.0,
            f"keep fraction {s.attn_keep_frac} not strictly inside (0, 1)")
    # logits of the same weights on the served tokens: finite everywhere
    with torch.no_grad():
        toks = torch.as_tensor(np.concatenate(
            [prompts, out["tokens"][:, :1]], axis=1), device=dev)
        lg, cache, _ = model.prefill(toks[:, :T0], pad_to=T0 + 1)
        lg2, _, _ = model.decode_step(cache, toks[:, T0:], T0)
        finite = bool(torch.isfinite(lg).all() and torch.isfinite(lg2).all())
    require(finite, "non-finite logits at full width")
    return {"phase": "serve", "config": cfg.name, "dtype": cfg.dtype,
            "batch": B, "prompt_len": T0, "new_tokens": new,
            "init_s": init_s, "prefill_s": s.prefill_s,
            "decode_s": s.decode_s, "decode_tok_per_s": s.decode_tok_per_s,
            "attn_keep_frac": s.attn_keep_frac,
            "kv_saved_fraction": s.kv_saved_fraction,
            "kv_saved_analytic": s.kv_saved_analytic,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "launches": launches, "logits_finite": finite,
            "sample_tokens": out["tokens"][0, :8].tolist()}, launches


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import build
    t = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, "chip_smoke_build.log"), "w") as f:
        for n, log in logs.items():
            f.write(f"== {n}\n{log}\n")
    usage = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "built": sorted(logs),
          "ptxas": usage})

    from repro_torch.configs import get_config
    cfg = get_config("llama2-7b")
    timer = Timer(torch, dev)
    per_kernel = {"router_stats": check_router(torch, dev, timer, cfg),
                  "fused_linear": check_fused_linear(torch, dev, timer, cfg),
                  "flash_attention": check_flash(torch, dev, timer, cfg)}
    emit({"phase": "kernels", "shapes": per_kernel})
    emit(check_ragged(torch, dev))

    emit(parity(torch, np, dev))
    serve, launches = serve_full_width(torch, np, dev)
    emit(serve)

    kernels = []
    for name, shapes in per_kernel.items():
        lib = [s["library_ms"] for s in shapes]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for s in shapes
                               for r in s["errors"].values()),
            "ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes),
            "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            "summed_over": [s["shape"] for s in shapes]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
