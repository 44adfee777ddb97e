#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printing one JSON line (any failure raises and exits non-zero):
  1. device   — the card (``nvidia-smi`` name and power limit, printed raw too);
  2. build    — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
  3. kernels  — each kernel against its plain PyTorch version on the card, at
                the llama2-7b main-path shapes, with times and bounds, on a
                Timer that reads a buffer twice the L2's size before each
                run (clean L2) and beside an empty kernel's time on it
                (``launch_floor_ms``); the router at every main-path shape
                (D 4096 and 2560 at T 2048, 453 and 4, bf16 and fp32, each
                launched twice bit for bit and, above 16 rows, its first
                16 rows held bit for bit against a call on those rows
                alone, timed beside the two-call torch composite);
                (dense and int4 fused linear and flash in bf16 and
                fp32 activations, the int4 matmul at the lm head; the
                dense fused linear's two bf16 kernels, the tensor-core tile
                at M 2048 and the split-K stream at M 4, each launched
                twice bit for bit, Σy² held against the plain version on
                the operand the route feeds, its fp32 inputs on the SIMT
                kernel; flash attention's two bf16 kernels, the tensor-core
                tile at prefill (4 × 512) and the cluster split-KV walk at
                decode (B 4 against 544 rows), each launched twice bit for
                bit and also held against the mirror that rounds P as the
                route does, its fp32 inputs on the SIMT kernel; the int4
                fused linear's two kernels, the s8 tensor-core tile at M
                2048, 512 and 256 and the split-K code stream at M 4, and
                the int4 matmul's stream at the lm head (M 4; its tile at
                M 2048 for the record), in bf16 and fp32 activations, each
                launched twice bit for bit, held bit for bit against the
                plain version summed in the route's order (GLU outputs
                within one ulp plus the activation's difference) and
                against the exact dequantized weights, timed beside the
                bf16 dense route at the same shape; paged
                attention in bf16, int8 and int4 pages over a 512-token
                history of a keep-0.5 gate log, bf16 q on the cluster
                split walk (launched twice bit for bit; timed beside the
                SIMT kernel on the same bf16 inputs and beside flash's
                split-KV walk over the same admitted rows laid out
                contiguously, the yardstick), fp32 q on the SIMT kernel);
                then ragged shapes
                off the tile multiples (the router at D 300, 301 and 4100,
                T 1, 16, 17 and 2049, and x at an address that allows 1 or
                2 elements a load), empty paged histories, padded
                K-groups, odd N, non-pow2 scales and .5 ties, flash pad rows
                and splits without a valid key included, paged G 8, 16 and
                32, head groups that do not divide Hkv, fewer admitted
                entries than blocks, all of them in one block's slice, two
                windows and rounds of listed rows, each flash, int4 and
                paged case on the route its plan picks, and the C entries'
                refusals of
                plans off their source (not timed); the SSD chunk scan at
                the mamba2-2.7b shapes (x [4, 512, 80, 64] and [1, 512, 80,
                64], B/C [B, 512, 1, 128], chunk 128; y and the final
                state): bf16 on the tensor-core route (timed beside the
                SIMT kernel on the same bf16 inputs, and held also against
                the mirror of its three-term bf16 split, tightly on inputs
                whose cumsums are exact), fp32 on the SIMT kernel, each
                launched twice bit for bit, with byte and operation
                bounds; and at ragged ones (T off the chunk, T <
                chunk, T = 1, dt = 0 rows, G > 1, N 16), every bf16 case on
                the tensor-core route and every fp32 case on the SIMT
                kernel, and the C entries' refusals of plans off the
                source;
  4. parity   — llama2-7b smoke in fp32 through the port on cuda (kernels)
                and on cpu (plain versions): gates, logits, tokens of the
                lock-step engine, of teacher-forced paged decode steps and
                of the continuous engine over the paged store; once with
                dense weights and once with int4 weights (group 64);
                exact launch counts of the cuda ``ServeEngine`` run, per
                route (int4: its prefill on the s8 tile, its decode steps
                on the split-K stream);
  5. serve    — full-width llama2-7b in bf16 (random seeded weights, neutral
                router bias) served by ``ServeEngine.generate``: batch 4 x
                prompt 512 + 32 new tokens, greedy; exact launch counts
                (the dense fused linear and flash attention per route too:
                prefill on the tensor-core tiles, decode steps on the
                split-K stream and the split-KV walk);
  6. continuous — the same weights served by ``ContinuousBatchingEngine``
                (4 slots, max_len 544, 8 requests of 128-512 prompt tokens +
                32 greedy tokens) four times: dense pool, paged bf16, int8
                and int4 pages; then 4 requests of 16-token prompts in
                paged bf16 pages, in the default pool and in one too small
                for all four (it must preempt; tokens unchanged); exact
                launch counts per prefill and per decode step (paged
                attention per route: its bf16 steps on the split walk),
                page conservation, finite logits;
  7. witness  — the same weights upcast to fp32: the continuous engine in the
                dense pool and in fp32 pages (paged attention on the SIMT
                kernel) gives identical tokens on 4 phase-6 requests;
                teacher-forced dense and paged decode in fp32 agree
                (gates, logits), and bf16 paged flips no more
                gates against fp32 than bf16 dense does (within 2x + 1 %);
                the fp32 copy is freed after it;
  8. int4     — the phase-5 weights quantized on the card by the port's
                ``quantize_params`` (group 128, pow2 scales: every linear of
                all 32 layers and the lm head), served lock-step (batch 4 x
                512 + 32) and by the continuous engine (the phase-6
                requests) in the dense pool and in paged bf16 pages: exact
                launch counts (4·L int4 fused linears and one int4 matmul
                per forward, by route, no dense fused linear), finite
                logits, weight
                bytes and peak memory; the share of tokens equal to the
                bf16 runs is reported, not checked; the llama2-7b weights
                are freed after it;
  9. parity_mamba — mamba2-2.7b smoke in fp32 through the port on cuda and
                on cpu: gates (the per-layer SSM gate log, smallest router
                margin checked), logits, keep statistics (sums within 1e-6,
                counts exact), lock-step and continuous dense-pool tokens;
                exact launch counts of the cuda runs (every SSD scan on the
                SIMT kernel);
 10. mamba    — full-width mamba2-2.7b in bf16 (random seeded weights,
                neutral router bias) served by ``ServeEngine.generate``
                (batch 4 x prompt 512 + 32) and by the continuous engine (4
                slots, 8 requests of 114-512 prompt tokens + 32, dense pool,
                exact-length prefill): exact launch counts (64 SSD scans per
                prefill, all on the tensor-core route, and none per decode
                step, 64 router passes per forward, no attention or fused
                linear), finite logits,
                weight bytes, peak memory; a paged mamba engine must raise;
 11. fused    — the continuous engine at ``decode_steps`` 8 (device-resident
                epochs: on the card a CUDA graph of one decode iteration,
                replayed) on the weights of phases 6, 8 and 10: the dense
                pool, paged bf16 and int8 pages (phase 6's requests), int4
                weights on the dense pool (phase 8's) and mamba2-2.7b on
                the dense pool (phase 10's), each giving bit for bit the
                tokens of its single-step run; phase 6's 4 short requests
                in its tight paged pool (epochs must shrink); a run at
                temperature 0.8 (tokens in the vocabulary); exact launch
                counts of the prefills and the eager warm-up iterations, at
                most one capture for the dense pool and one per block-table
                width for the paged store, every iteration past a capture's
                eager warm-up a replay; after each run one more epoch of
                its graph traced by torch.profiler a replay a session,
                each replay's port kernels counted by name equal to the
                capture delta (a trace short of it, as a lossy trace
                is, retaken at most twice); no host sync in a dense
                run's deferred prefills (``set_sync_debug_mode``); page
                conservation, finite logits (its lines are emitted after
                phase 10);
 12. chunked  — chunked (resumable) prefill, run while phase 6's bf16
                weights (and for its witness phase 7's fp32 copy, and
                phase 8's int4 weights) are resident, its line emitted
                after phase 11's: (a) flash attention at one chunk's
                geometry (C 128 at t0 0, 128 and 384 over a 640-row
                staging cache with kv_len t0 + 128, and a final chunk of 71
                real columns at t0 512, bf16 on the tensor-core tile; C 8,
                (d)'s chunk, at t0 0, 8 and 536 over a 544-row staging
                cache, and a final chunk of 3 real columns at t0 528, bf16
                on the split-KV walk), and each in fp32 on the SIMT kernel,
                against the plain version with
                phase 3's tolerances, launched twice bit for bit, the final
                chunk's real rows bit for bit a call without its pads,
                timed beside SDPA with a boolean mask of the same keys; the
                dense fused linear and the router at M = T = 128 against
                their plain versions; (b) the fp32 witness: phase 7's 4
                requests at chunk 128 against phase 7's chunk-0 runs, dense
                and fp32 pages: tokens bit for bit, each request's gate
                logs and the KV accounting identical; (c) phase 6's 8
                requests at chunk 128: the dense pool, bf16, int8 and int4
                pages, fused 8-step epochs (dense and paged bf16) under
                step_tokens 160 (no chunk deferred) and 136 (chunks
                deferred), and phase 8's int4 weights on the dense pool:
                exact launch counts, per chunk 1 router pass, 4·L fused
                linears on the tile (int4: the s8 tile), 32 flash tiles and
                nothing on the decode routes, prefill_chunks = Σ⌈T0/128⌉,
                chunks interleaved with resident decode steps, pages
                conserved, finite logits, peak memory; the share of tokens
                equal to the chunk-0 runs reported, not checked; (d) phase
                6's 4 short requests in its tight pool at chunk 8: every
                request finishes and every page comes back, aborts and
                preemptions reported (the engine's ``prefill_aborts`` and
                ``preemptions``); (e) a chunked mamba2-2.7b engine
                raises ``ConfigError`` (checked in phase 10).
Then the ``kernels`` summary line (``launches`` summed over the main-path
runs of phases 5, 6, 8, 10, 11 and 12 (its fp32 witness runs included),
each counted from 0 by the wrappers, which a graph replay does not pass
through: phase 11's and 12's replayed launches stand in their own lines,
derived, and in no sum; for the paged SIMT route, which only fp32 serving
takes, over phase 7's and phase 12's fp32 paged runs, and for the SSD
scan's SIMT route over phase 9's fp32 cuda runs, all counted from 0 too;
the dense fused linear
as its two bf16 kernels, ``fused_linear_wgmma`` and ``fused_linear_splitk``,
the int4 fused linear as ``fused_linear_int4_tc`` and
``fused_linear_int4_stream``, the int4 matmul as ``int4_matmul_stream``
(its tile is off the main path), and flash attention as
``flash_attention_wgmma`` and ``flash_attention_splitkv``, and paged
attention as ``paged_attention_split`` and ``paged_attention_simt``, and
the SSD scan as ``ssd_scan_tc`` and ``ssd_scan_simt``, by the route
counters), and last the contract
line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
LOG_DIR = os.path.join(ROOT, "build")          # listed in .gitignore

# Published H100 SXM peaks (NVIDIA data sheet): device memory rate and the
# dense bf16 and int8 tensor-core rates.  bound_ms = max(bytes / rate,
# ops / rate); the int4 kernels' products are int8 operations.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12     # float32 outside the tensor cores (the SIMT routes)

# Tolerances (kernel vs plain version on the same inputs).
TOL_F32 = 1e-4        # x max|ref|: fp32 sums in another order over K ≤ 11008
TOL_BF16 = 2.0 ** -7  # x max|ref|: two bf16 ulps at the maximum
TOL_SQ = 1e-5         # relative, Σy² and mean_sq (fp32 outputs)
TOL_SQ_EXACT = 2.0 ** -8  # relative, the tile's Σy² against the exact plain
#                       version: its operand is bf16(x · gamma), rounded once
#                       (9x the worst measured, 4.5e-4)
TOL_LOGITS = 1e-4     # x max|logits|, phase 4 (fp32 model)
TOL_BFP = 0.05        # x max|oracle|: int4 kernels against the exact
#                       dequant (8-bit activation mantissas per group)
TOL_FLASH_MIRROR = 2.0 ** -9  # x max|mirror|, past one bf16 ulp of each
#                       element: flash's bf16 routes against the mirror that
#                       rounds P as they do (the ulp is the output's own
#                       rounding; the rest covers P values that the fp32
#                       sum order moves across a bf16 rounding boundary)
TOL_SPLIT = 2.0 ** -19  # x max|mirror|: the SSD scan's tensor-core route
#                       against ref.ssd_scan_split on inputs whose cumsums
#                       are exact in any order (ssd_exact_inputs); the
#                       mirror without the split's lo term is off by ~2^-18
LOG2E = 1.4426950408889634
MIN_MARGIN = 1e-3     # phase 4: no router decision this close to its tie
PARITY_SEED = 6   # its margins clear MIN_MARGIN (checked every run)
MAMBA_SEEDS = 8   # phase 9 takes the first seed whose cpu margins clear
#                   MIN_MARGIN (the draws depend on the torch version)
TOL_KEEP = 1e-6   # keep-fraction sums, cpu against cuda (phase 9)

TPU_KERNELS = {
    "router_stats": "src/repro/kernels/fused_router_rmsnorm.py:55",
    "fused_linear_wgmma": "src/repro/kernels/fused_linear.py:135",
    "fused_linear_splitk": "src/repro/kernels/fused_linear.py:135",
    "fused_linear_int4_tc": "src/repro/kernels/fused_linear.py:93",
    "fused_linear_int4_stream": "src/repro/kernels/fused_linear.py:93",
    "int4_matmul_stream": "src/repro/kernels/int4_matmul.py:66",
    "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:74",
    "flash_attention_splitkv": "src/repro/kernels/flash_attention.py:74",
    "paged_attention_split": "src/repro/kernels/paged_attention.py:99",
    "paged_attention_simt": "src/repro/kernels/paged_attention.py:99",
    "ssd_scan_tc": "src/repro/kernels/ssd_scan.py:67",
    "ssd_scan_simt": "src/repro/kernels/ssd_scan.py:67",
}
SOURCES = {
    "router_stats": "src/repro_torch/kernels/csrc/router_stats.cu",
    "fused_linear_wgmma": "src/repro_torch/kernels/csrc/fused_linear.cu",
    "fused_linear_splitk": "src/repro_torch/kernels/csrc/fused_linear.cu",
    "fused_linear_int4_tc":
        "src/repro_torch/kernels/csrc/fused_linear_int4.cu",
    "fused_linear_int4_stream":
        "src/repro_torch/kernels/csrc/fused_linear_int4.cu",
    "int4_matmul_stream": "src/repro_torch/kernels/csrc/fused_linear_int4.cu",
    "flash_attention_wgmma":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_splitkv":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention_split":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_attention_simt":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ssd_scan_tc": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "ssd_scan_simt": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median CUDA-event time of one call on the device, on a clean L2.

    Before each run the Timer reads a buffer twice the L2's size, filled
    once at construction: whatever the previous run left dirty in L2 is
    written back during that read, before the start event, so a kernel
    that streams its inputs pays for its own bytes only (a flush that
    writes would leave its dirty lines for the timed kernel to evict).
    A ~2 ms device
    sleep precedes the start event, so the host has enqueued the call
    before the card reaches it and the events time device work, not
    Python and ctypes launch overhead."""

    SLEEP_CYCLES = 4_000_000
    FLUSH_BYTES = 100 << 20        # twice the H100's 50 MB L2

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.ones(self.FLUSH_BYTES // 4, device=dev)

    def __call__(self, fn, iters: int = 7, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.sum()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def launch_floor_ms(torch, timer) -> float:
    """An empty kernel (``torch.cuda._sleep(0)``) under ``timer``: the
    least time any launch shows on this yardstick."""
    return timer(lambda: torch.cuda._sleep(0))


def max_err(torch, out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at the main-path shapes
# ---------------------------------------------------------------------------

ROUTER_T = (2048, 453, 4)   # lock-step prefill B·T0 = 4·512; the longest
#                             continuous prefill; decode B = 4
ROUTER_ALONE = 16           # router_call reruns a call's first rows alone


def router_call(torch, x, w, what):
    """One router pass on the plan ``plan`` makes against the plain
    version: logits within TOL_F32·max|ref|, mean_sq within TOL_SQ
    (relative), one launch counted, a second launch bit for bit the same,
    and above 16 rows its first 16 rows bit for bit the same as a call on
    those rows alone (a block a row): a row's results do not depend on
    the rows a block or on the other rows.  Returns the error record."""
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    T, D = x.shape
    p = frr.plan(T, D, x.dtype, x.data_ptr())
    before = frr.launches
    lo, ms = frr.router_stats_cuda(x, w)
    require(frr.launches == before + 1,
            f"{what}: {frr.launches - before} launches counted, want 1")
    lo2, ms2 = frr.router_stats_cuda(x, w)
    lr, mr = ref.router_stats_ref(x, w)
    torch.cuda.synchronize()
    e, m = max_err(torch, lo, lr)
    require(e <= TOL_F32 * m, f"{what}: logits {e} > {TOL_F32}·{m}")
    sq_rel = ((ms - mr).abs() / mr.abs()).max().item() if T else 0.0
    require(sq_rel <= TOL_SQ, f"{what}: mean_sq rel err {sq_rel}")
    require(torch.equal(lo, lo2) and torch.equal(ms, ms2),
            f"{what}: a second launch differs")
    rec = {"rows": p.rows, "vec": p.vec, "max_abs_err": e, "max_ref": m,
           "mean_sq_rel_err": sq_rel, "repeat_bit_identical": True}
    if T > ROUTER_ALONE:
        lo3, ms3 = frr.router_stats_cuda(x[:ROUTER_ALONE], w)
        torch.cuda.synchronize()
        require(torch.equal(lo[:ROUTER_ALONE], lo3)
                and torch.equal(ms[:ROUTER_ALONE], ms3),
                f"{what}: the first {ROUTER_ALONE} rows differ alone")
        rec["rows_alone_bit_identical"] = True
    return rec


def check_router(torch, dev, timer, cfgs, floor):
    """The router at every main-path shape: D of each config (llama2-7b
    4096, mamba2-2.7b 2560) at T 2048, 453 and 4, bf16 and fp32, each
    checked by ``router_call``.  The bf16 kernel is timed beside the plain
    version and beside the two-call torch composite (``x.float() @ w`` and
    ``x.float().square().mean(-1)``: two calls, not one, so not
    ``library_ms``); each record carries the bound and ``floor``, the
    empty kernel's time on the same Timer.  Returns the shape records."""
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = []
    for cfg in cfgs:
        D = cfg.d_model
        w = torch.randn((D, 2), generator=g, device=dev) * 0.02
        for T in ROUTER_T:
            x = torch.randn((T, D), generator=g, device=dev).to(
                torch.bfloat16)
            rel = {}
            for dt in (torch.bfloat16, torch.float32):
                rel[str(dt).split(".")[-1]] = router_call(
                    torch, x.to(dt), w, f"router {cfg.name} T={T} {dt}")
            p = frr.plan(T, D, x.dtype, x.data_ptr())
            ms_k = timer(lambda: frr.router_stats_cuda(x, w))
            b, by = bound_ms(T * D * 2 + D * 2 * 4 + T * 3 * 4, 6.0 * T * D)
            shapes.append({
                "shape": f"x[{T},{D}] bf16 ({cfg.name})", "ms": ms_k,
                "plain_ms": timer(lambda: ref.router_stats_ref(x, w)),
                "library_ms": None,
                "torch_two_calls_ms": timer(
                    lambda: (x.float() @ w, x.float().square().mean(-1))),
                "torch_two_calls_note": "two calls, not one",
                "bound_ms": b, "bound_by": by,
                "launch_floor_ms": floor, "plan": dataclasses.asdict(p),
                "errors": rel})
    return shapes


def linear_shapes(cfg):
    """The four linears of a block: name, K, N, glu, norm prologue,
    gate/residual/Σy² epilogue."""
    D, ai, ki, Fd = (cfg.d_model, cfg.attn_inner_dim, cfg.kv_inner_dim,
                     cfg.d_ff)
    return [("wqkv", D, ai + 2 * ki, False, True, False),
            ("wo", ai, D, False, False, True),
            ("gu", D, 2 * Fd, True, True, False),
            ("down", Fd, D, False, False, True)]


def int4_weight(torch, dev, g, K, N, G, pow2=True):
    """A bf16 weight [K, N] (std 1/sqrt(K)) quantized on the card by the
    port's ``quantize_rtn``: (codes, scale, the exact dequantized fp32
    weight [K, N], the bf16 weight)."""
    from repro_torch.quant import dequantize, quantize_rtn
    w = (torch.randn((K, N), generator=g, device=dev)
         / math.sqrt(K)).to(torch.bfloat16)
    codes, scale = quantize_rtn(w, G, pow2)
    return codes, scale, dequantize(codes, scale, K), w


def linear_inputs(torch, dev, g, M, K, F, glu, pro, epi):
    """bf16 activation and the optional prologue/epilogue tensors of one
    fused-linear call (mean_sq and gate_mul in fp32)."""
    bf = torch.bfloat16
    x = torch.randn((M, K), generator=g, device=dev).to(bf)
    kw = {"glu": glu, "act": "silu" if glu else None}
    if pro:
        kw["mean_sq"] = (x.float() ** 2).mean(-1)
        kw["gamma"] = (1 + 0.1 * torch.randn((K,), generator=g,
                                             device=dev)).to(bf)
    if epi:
        kw["residual"] = torch.randn((M, F), generator=g, device=dev).to(bf)
        kw["gate_mul"] = (torch.rand((M,), generator=g, device=dev)
                          > 0.5).float()
        kw["emit_sq"] = True
    return x, kw


def _cast(torch, kw, dt):
    """kw with its bf16 tensors cast to dt, and the ref's keyword names."""
    cast = {k: (v.to(dt) if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else v) for k, v in kw.items()}
    return cast, {("act_name" if k == "act" else k): v
                  for k, v in cast.items()}


def fused_linear_mirror(torch, x, w, **rkw):
    """The plain version on the operand the tensor-core tile feeds its
    wgmma: with the norm prologue, bf16(x · gamma) (one rounding of a
    bf16 product, as the kernel rounds it), the per-row 1/sqrt(mean_sq +
    eps) still applied in fp32 (gamma 1 below); without it, x itself."""
    from repro_torch.kernels import ref
    gamma = rkw.get("gamma")
    if gamma is not None:
        x = (x.float() * gamma.float()).to(torch.bfloat16)
        rkw = dict(rkw, gamma=torch.ones_like(gamma))
    return ref.fused_linear_ref(x, w, **rkw)


def fused_linear_call(torch, x, w, kw, what):
    """One dense fused-linear call on its route against the plain version:
    out within tol·max|ref| (TOL_BF16 in bf16, TOL_F32 in fp32); Σy² within
    TOL_SQ (relative) of the plain version on the operand the route feeds
    (the tile's bf16(x · gamma); exact on the split-K stream and the SIMT
    kernel) and within TOL_SQ_EXACT of the exact plain version; the
    route ``plan`` picks and only its counter moved; in bf16 a second
    launch on the same inputs bit for bit.  Returns the error record."""
    from repro_torch.kernels import fused_linear as fl, ops, ref
    M, K = x.shape
    F = w.shape[1] // 2 if kw["glu"] else w.shape[1]
    tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL_F32
    route = fl.plan(M, K, F, kw["glu"], x.dtype).route
    rkw = {("act_name" if k == "act" else k): v for k, v in kw.items()}
    before = ops.kernel_launches()
    out, sq = fl.fused_linear_cuda(x, w, **kw)
    after = ops.kernel_launches()
    moved = {r for r in ("wgmma", "splitk", "simt")
             if after[f"fused_linear_{r}"] != before[f"fused_linear_{r}"]}
    require(moved == {route} and after[f"fused_linear_{route}"]
            == before[f"fused_linear_{route}"] + 1,
            f"{what}: routes {moved}, want {route}")
    ro, rsq = ref.fused_linear_ref(x, w, **rkw)
    torch.cuda.synchronize()
    e, m = max_err(torch, out, ro)
    require(e <= tol * m, f"{what}: {e} > {tol}·{m}")
    rec = {"route": route, "max_abs_err": e, "max_ref": m}
    if sq is not None:
        msq = fused_linear_mirror(torch, x, w, **rkw)[1] \
            if route == "wgmma" else rsq
        sr = ((sq - msq).abs() / msq.abs()).max().item()
        require(sr <= TOL_SQ, f"{what}: Σy² rel err {sr} > {TOL_SQ}")
        rec["sq_rel_err"] = sr
        se = ((sq - rsq).abs() / rsq.abs()).max().item()
        require(se <= TOL_SQ_EXACT, f"{what}: Σy² rel err {se} against the "
                f"exact plain version > {TOL_SQ_EXACT}")
        rec["sq_rel_err_exact"] = se
    if x.dtype == torch.bfloat16:
        out2, sq2 = fl.fused_linear_cuda(x, w, **kw)
        require(torch.equal(out, out2) and (sq is None or torch.equal(
            sq, sq2)), f"{what}: a second launch differs")
        rec["repeat_bit_identical"] = True
    return rec


def check_fused_linear(torch, dev, timer, cfg):
    """The dense fused linear at the four linears of a llama2-7b block: bf16
    at M 2048 on the tensor-core tile and at M 4 on the split-K stream,
    each timed beside its plain version and ``torch.matmul``; the same
    inputs in fp32 on the SIMT kernel (the parity route), checked and
    timed too.  Returns the shape records by bf16 route."""
    from repro_torch.kernels import fused_linear as fl, ref
    g = torch.Generator(device=dev).manual_seed(12)
    shapes = {"wgmma": [], "splitk": []}
    for M in (2048, 4):
        for name, K, N, glu, pro, epi in linear_shapes(cfg):
            F = N // 2 if glu else N
            w = (torch.randn((K, N), generator=g, device=dev)
                 / math.sqrt(K)).to(torch.bfloat16)
            x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
            what = f"fused_linear {name} M={M}"
            rec = fused_linear_call(torch, x, w, kw, f"{what} bf16")
            f32, _ = _cast(torch, kw, torch.float32)
            xf, wf = x.float(), w.float()
            simt = fused_linear_call(torch, xf, wf, f32, f"{what} fp32")
            ms_s = timer(lambda: fl.fused_linear_cuda(xf, wf, **f32))
            del xf, wf
            _, rkw = _cast(torch, kw, torch.bfloat16)
            ms_k = timer(lambda: fl.fused_linear_cuda(x, w, **kw))
            ms_p = timer(lambda: ref.fused_linear_ref(x, w, **rkw))
            ms_l = timer(lambda: torch.matmul(x, w))
            nbytes = (M * K + K * N + M * F) * 2 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0)
            b, by = bound_ms(nbytes, 2.0 * M * K * N)
            # the fp32 inputs: 4-byte elements, fp32 operations
            b32, by32 = bound_ms((M * K + K * N + M * F) * 4 + (
                (K * 4 + M * 4) if pro else 0) + (
                (M * F * 4 + M * 8) if epi else 0), 2.0 * M * K * N,
                FP32_OPS_PER_S)
            shapes[rec["route"]].append({
                "shape": f"{name} M={M} K={K} N={N}", "route": rec["route"],
                "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
                "bound_ms": b, "bound_by": by,
                "tol": f"bf16 {TOL_BF16}·max|ref|; Σy² {TOL_SQ} rel against "
                       "the plain version on the operand the route feeds "
                       "(the tile: bf16(x·gamma), rsqrt after the product)",
                "errors": {"bfloat16": rec}, "simt_f32_ms": ms_s,
                "simt_f32_bound_ms": b32, "simt_f32_bound_by": by32,
                "simt_f32_errors": dict(simt, tol=f"{TOL_F32}·max|ref|")})
            del x, w, kw
    return shapes


def int4_ulp(torch, x):
    """One ulp of x's dtype (bf16 or fp32) at each |x|; 0 at 0."""
    bits = 7 if x.dtype == torch.bfloat16 else 23
    e = torch.frexp(x.float().abs())[1]
    return torch.where(x == 0, torch.zeros_like(x.float()),
                       torch.ldexp(torch.ones_like(x.float()), e - 1 - bits))


def int4_mirror_check(torch, out, ro, x, codes, scale, rkw, split, what):
    """The int4 kernels against the plain version summed in the route's
    order of the fp32 group terms (``split``: the stream's groups per
    split; None on the tile).  Every value before the activation is equal
    bit for bit, so without an activation the output is; with the GLU's
    silu each output lies within one ulp of its dtype plus the activation's
    difference (the kernel's y / (1 + expf(-y)) against ``F.silu``, times
    |up|).  Returns (bit-identical share, largest excess over that bound
    as a share of max|ref|)."""
    from repro_torch.kernels import ref
    if rkw.get("act_name") is None:
        require(torch.equal(out, ro), f"{what}: not bit for bit with the "
                "plain version in the route's order")
        return 1.0, 0.0
    xf = x.float()
    if rkw.get("mean_sq") is not None:
        xf = ref.rms_prologue(xf, rkw["mean_sq"], rkw["gamma"],
                              rkw.get("eps", 1e-5))
    y = ref.bfp_matmul_f32(xf, codes, scale, split)
    f = y.shape[1] // 2
    yg, yu = y[:, :f], y[:, f:]
    act_diff = ((yg / (1.0 + torch.exp(-yg))) - ref.act(yg, "silu")).abs()
    bound = int4_ulp(torch, ro) + act_diff * yu.abs()
    d = (out.float() - ro.float()).abs()
    excess = (d - bound).max().item()
    require(excess <= 0.0, f"{what}: {excess} past one ulp plus the "
            "activation's difference")
    return ((out == ro).float().mean().item(),
            max(excess, 0.0) / ro.float().abs().max().item())


def int4_call(torch, x, codes, scale, kw, what, matmul=False):
    """One int4 fused-linear (or, with ``matmul``, int4-matmul) call on its
    route against the plain version in the route's order
    (``int4_mirror_check``); Σy² within TOL_SQ (relative); the route
    ``plan_int4`` picks and only its counter moved; a second launch on the
    same inputs bit for bit.  Returns (the error record, the plan)."""
    from repro_torch.kernels import fused_linear as fl, ops, ref
    from repro_torch.kernels import int4_matmul as im
    M, K = x.shape
    N, C = codes.shape[1], scale.shape[0]
    glu = kw.get("glu", False)
    p = fl.plan_int4(M, K, N // 2 if glu else N, codes.shape[0] // C, C,
                     glu, x.dtype)
    split = p.group_split or None
    name = "int4_matmul" if matmul else "fused_linear_int4"
    rkw = {("act_name" if k == "act" else k): v for k, v in kw.items()}

    def run():
        if matmul:
            return im.int4_matmul_cuda(x, codes, scale), None
        return fl.fused_linear_int4_cuda(x, codes, scale, **kw)

    before = ops.kernel_launches()
    out, sq = run()
    after = ops.kernel_launches()
    moved = {r for r in ("tc", "stream")
             if after[f"{name}_{r}"] != before[f"{name}_{r}"]}
    require(moved == {p.route} and after[name] == before[name] + 1
            and after[f"{name}_{p.route}"] == before[f"{name}_{p.route}"] + 1,
            f"{what}: routes {moved}, want {p.route}")
    if matmul:
        ro, rsq = ref.bfp_matmul_ref(x, codes, scale, split), None
    else:
        ro, rsq = ref.fused_linear_ref(x, w_codes=codes, scale=scale,
                                       split_groups=split, **rkw)
    torch.cuda.synchronize()
    same, excess = int4_mirror_check(torch, out, ro, x, codes, scale, rkw,
                                     split, what)
    e, m = max_err(torch, out, ro)
    rec = {"route": p.route, "max_abs_err": e, "max_ref": m,
           "bit_identical_share": same, "excess_over_ulp": excess}
    if sq is not None:
        sr = ((sq - rsq).abs() / rsq.abs()).max().item()
        require(sr <= TOL_SQ, f"{what}: Σy² rel err {sr} > {TOL_SQ}")
        rec["sq_rel_err"] = sr
    out2, sq2 = run()
    require(torch.equal(out, out2) and (sq is None or torch.equal(sq, sq2)),
            f"{what}: a second launch differs")
    rec["repeat_bit_identical"] = True
    return rec, p


INT4_TOL = ("the plain version summed in the route's order: bit for bit "
            "without an activation, else one ulp + the activation's "
            f"difference; Σy² {TOL_SQ} rel; exact dequant {TOL_BFP}·max")


def check_fused_linear_int4(torch, dev, timer, cfg):
    """The int4-BFP fused linear at the four linears of a llama2-7b block:
    M 2048 (lock-step prefill), 512 and 256 (the continuous buckets) on the
    tensor-core tile and M 4 (decode) on the split-K stream, in bf16 and
    fp32 activations, against the plain version in the route's order and,
    for the record, the exact-dequant oracle; timed beside the plain
    version and the bf16 dense route at the same shape.  Returns the
    shape records by route."""
    from repro_torch.kernels import fused_linear as fl, ref
    G = cfg.quant.group_size
    g = torch.Generator(device=dev).manual_seed(17)
    shapes = {"tc": [], "stream": []}
    for M in (2048, 512, 256, 4):
        for name, K, N, glu, pro, epi in linear_shapes(cfg):
            F = N // 2 if glu else N
            codes, scale, w_exact, w = int4_weight(torch, dev, g, K, N, G)
            x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
            errs = {}
            for dt in (torch.bfloat16, torch.float32):
                cast, rcast = _cast(torch, kw, dt)
                what = f"fused_linear_int4 {name} M={M} {dt}"
                rec, p = int4_call(torch, x.to(dt), codes, scale, cast, what)
                out, _ = fl.fused_linear_int4_cuda(x.to(dt), codes, scale,
                                                   **cast)
                eo, _ = ref.fused_linear_ref(x.to(dt), w_exact.to(dt),
                                             **rcast)
                torch.cuda.synchronize()
                ee, em = max_err(torch, out, eo)
                require(ee <= TOL_BFP * em, f"{what}: {ee} from the exact "
                        f"dequant > {TOL_BFP}·{em}")
                rec.update(exact_dequant_err=ee, exact_dequant_max=em)
                errs[str(dt).split(".")[-1]] = rec
                del out, eo
            _, rkw = _cast(torch, kw, torch.bfloat16)
            split = p.group_split or None
            ms_k = timer(lambda: fl.fused_linear_int4_cuda(x, codes, scale,
                                                           **kw))
            ms_p = timer(lambda: ref.fused_linear_ref(
                x, w_codes=codes, scale=scale, split_groups=split, **rkw))
            ms_d = timer(lambda: fl.fused_linear_cuda(x, w, **kw))
            Kw, C = codes.shape[0], scale.shape[0]
            nbytes = (M * K + M * F) * 2 + Kw * N + C * N * 4 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0)
            b, by = bound_ms(nbytes, 2.0 * M * Kw * N, INT8_OPS_PER_S)
            shapes[p.route].append({
                "shape": f"{name} M={M} K={K} N={N} G={G}", "route": p.route,
                "plan": dataclasses.asdict(p), "ms": ms_k, "plain_ms": ms_p,
                "library_ms": None, "bound_ms": b, "bound_by": by,
                "bytes": nbytes, "bf16_dense_ms": ms_d,
                "bf16_dense_route": fl.plan(M, K, F, glu,
                                            torch.bfloat16).route,
                "tol": INT4_TOL, "errors": errs})
            del x, kw, codes, scale, w_exact, w
    return shapes


def check_int4_matmul(torch, dev, timer, cfg):
    """The int4 matmul at the lm head (K 4096, N 32000): M 4 (the main
    path's batch) on the split-K stream and, for the record, M 2048 on the
    tensor-core tile, in bf16 and fp32 activations, against the plain
    version in the route's order and the exact-dequant oracle; timed
    beside the plain version and the bf16 dense route at the same shape.
    Returns the shape records by route."""
    from repro_torch.kernels import fused_linear as fl, int4_matmul as im
    from repro_torch.kernels import ref
    K, N, G = cfg.d_model, cfg.vocab_size, cfg.quant.group_size
    g = torch.Generator(device=dev).manual_seed(18)
    codes, scale, w_exact, w = int4_weight(torch, dev, g, K, N, G)
    shapes = {"tc": [], "stream": []}
    for M in (4, 2048):
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        errs = {}
        for dt in (torch.bfloat16, torch.float32):
            what = f"int4_matmul M={M} {dt}"
            rec, p = int4_call(torch, x.to(dt), codes, scale, {}, what,
                               matmul=True)
            out = im.int4_matmul_cuda(x.to(dt), codes, scale)
            eo = ref.int4_matmul_ref(x.to(dt), codes, scale)
            torch.cuda.synchronize()
            ee, em = max_err(torch, out, eo)
            require(ee <= TOL_BFP * em, f"{what}: {ee} from the exact "
                    f"dequant > {TOL_BFP}·{em}")
            rec.update(exact_dequant_err=ee, exact_dequant_max=em)
            errs[str(dt).split(".")[-1]] = rec
            del out, eo
        split = p.group_split or None
        ms_k = timer(lambda: im.int4_matmul_cuda(x, codes, scale))
        ms_p = timer(lambda: ref.bfp_matmul_ref(x, codes, scale, split))
        ms_d = timer(lambda: fl.fused_linear_cuda(x, w))
        Kw, C = codes.shape[0], scale.shape[0]
        nbytes = (M * K + M * N) * 2 + Kw * N + C * N * 4
        b, by = bound_ms(nbytes, 2.0 * M * Kw * N, INT8_OPS_PER_S)
        shapes[p.route].append({
            "shape": f"lm_head M={M} K={K} N={N} G={G}", "route": p.route,
            "plan": dataclasses.asdict(p), "ms": ms_k, "plain_ms": ms_p,
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "bytes": nbytes, "bf16_dense_ms": ms_d,
            "bf16_dense_route": fl.plan(M, K, N, False,
                                        torch.bfloat16).route,
            "tol": INT4_TOL, "errors": errs})
        del x
    return shapes


def bf16_ulp(torch, x):
    """One bf16 ulp at each |x|, 2^(floor(log2|x|) - 7); 0 at 0."""
    e = torch.frexp(x.abs())[1]
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def flash_mirror(torch, q, k, v, q_positions, kv_valid_len=None, *,
                 causal=True, window=0, scale):
    """The plain version with P rounded where the bf16 routes round it:
    scores scaled in fp32 by fp32(scale)·fp32(log2 e), p = exp2(s - M)
    against the row's integer maximum M = ceil(max s), rounded once to bf16
    for the product with V, l = Σ p in fp32 (unrounded); rows without a
    valid key 0.  Returns the fp32 output [B, Tq, Hq, dh] (not rounded)."""
    from repro_torch.kernels import flash_attention as fa
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qp, kp, vp = fa.pack_qkv(q, k, v)
    pos, kv_len = fa.pack_positions(q_positions, kv_valid_len, B, Hkv, G, Tk)
    c = (torch.tensor(scale, dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32)).to(q.device)
    s = torch.einsum("brd,bkd->brk", qp.float(), kp.float()) * c
    kv = torch.arange(Tk, device=q.device)[None, None]
    qpos = pos[:, :, None]
    mask = kv < kv_len[:, None, None]
    if causal:
        mask = mask & (kv <= qpos)
    if window:
        mask = mask & (kv > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp2(s - torch.ceil(s.amax(-1, keepdim=True)))
    o = torch.einsum("brk,bkd->brd", p.to(torch.bfloat16).float(),
                     vp.float()) / p.sum(-1, keepdim=True).clamp_min(1e-20)
    o = torch.where(mask.any(-1, keepdim=True), o, torch.zeros_like(o))
    return (o.reshape(B, Hkv, G, Tq, dh).permute(0, 3, 1, 2, 4)
            .reshape(B, Tq, Hq, dh))


def flash_call(torch, q, k, v, qpos, kvl, what, **kw):
    """One flash-attention call on its route against the plain version:
    out within tol·max|ref| (TOL_BF16 in bf16, TOL_F32 in fp32); in bf16
    also within one bf16 ulp of each element plus TOL_FLASH_MIRROR·max of
    the mirror (``flash_mirror``: P rounded as the route rounds it), and
    a second launch on the same inputs bit for bit; the route ``plan``
    picks and only its counter moved.  Returns the error record."""
    from repro_torch.kernels import flash_attention as fa, ops
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    bf = q.dtype == torch.bfloat16
    tol = TOL_BF16 if bf else TOL_F32
    route = fa.plan(B * Hkv, Hq // Hkv * Tq, Tk, dh, q.dtype).route
    before = ops.kernel_launches()
    out = fa.flash_attention_cuda(q, k, v, qpos, kvl, **kw)
    after = ops.kernel_launches()
    moved = {r for r in ("wgmma", "splitkv", "simt")
             if after[f"flash_attention_{r}"]
             != before[f"flash_attention_{r}"]}
    require(moved == {route} and after[f"flash_attention_{route}"]
            == before[f"flash_attention_{route}"] + 1,
            f"{what}: routes {moved}, want {route}")
    ro = fa.flash_attention_plain(q, k, v, qpos, kvl, **kw)
    torch.cuda.synchronize()
    e, m = max_err(torch, out, ro)
    require(e <= tol * m, f"{what}: {e} > {tol}·{m}")
    rec = {"route": route, "max_abs_err": e, "max_ref": m}
    if bf:
        mo = flash_mirror(torch, q, k, v, qpos, kvl, **kw)
        mm = mo.abs().max().item()
        d = (out.float() - mo).abs()
        excess = (d - bf16_ulp(torch, mo)).max().item()
        require(excess <= TOL_FLASH_MIRROR * mm, f"{what}: {excess} past one "
                f"bf16 ulp of the mirror > {TOL_FLASH_MIRROR}·{mm}")
        out2 = fa.flash_attention_cuda(q, k, v, qpos, kvl, **kw)
        require(torch.equal(out, out2), f"{what}: a second launch differs")
        rec.update(mirror_max_abs_err=d.max().item(), mirror_max=mm,
                   mirror_excess_over_ulp=excess,
                   mirror_equal_share=(out == mo.to(torch.bfloat16))
                   .float().mean().item(),
                   repeat_bit_identical=True)
    return rec


def check_flash(torch, dev, timer, cfg):
    """Flash attention at the llama2-7b main-path shapes: prefill (4 × 512,
    causal) on the tensor-core tile and decode (B 4 against a 544-row cache,
    kv_len 544) on the split-KV walk in bf16, each timed beside its plain
    version and SDPA; the same inputs in fp32 on the SIMT kernel (the
    parity route), checked and timed too.  Returns the shape records by
    bf16 route."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as fa
    B, H, dh = 4, cfg.num_heads, cfg.resolved_head_dim
    Hkv = cfg.num_kv_heads
    g = torch.Generator(device=dev).manual_seed(13)
    scale = 1.0 / math.sqrt(dh)
    shapes = {"wgmma": [], "splitkv": []}
    for label, Tq, Tk, t_last in (("prefill", 512, 512, None),
                                  ("decode", 1, 544, 543)):
        bf = torch.bfloat16
        q = torch.randn((B, Tq, H, dh), generator=g, device=dev).to(bf)
        k = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        v = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        if t_last is None:       # as the model's prefill: an expanded arange
            qpos = torch.arange(Tq, dtype=torch.int32,
                                device=dev)[None].expand(B, Tq)
            kvl = None
        else:
            qpos = torch.full((B, 1), t_last, dtype=torch.int32, device=dev)
            kvl = torch.full((B,), t_last + 1, dtype=torch.int32, device=dev)
        errs = {}
        for dt in (bf, torch.float32):
            a = [t.to(dt) for t in (q, k, v)]
            errs[str(dt).split(".")[-1]] = flash_call(
                torch, *a, qpos, kvl, f"flash {label} {dt}", scale=scale)
        route = errs["bfloat16"]["route"]
        qf, kf, vf = (t.float() for t in (q, k, v))
        ms_s = timer(lambda: fa.flash_attention_cuda(qf, kf, vf, qpos, kvl,
                                                     scale=scale))
        del qf, kf, vf
        ms_k = timer(lambda: fa.flash_attention_cuda(q, k, v, qpos, kvl,
                                                     scale=scale))
        ms_p = timer(lambda: fa.flash_attention_plain(q, k, v, qpos, kvl,
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
        b32, by32 = bound_ms(2 * nbytes, 4.0 * pairs * dh, FP32_OPS_PER_S)
        shapes[route].append({
            "shape": f"{label} B={B} Tq={Tq} Tk={Tk} H={H} dh={dh}",
            "route": route, "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
            "bound_ms": b, "bound_by": by,
            "tol": f"bf16 {TOL_BF16}·max|ref|, and one bf16 ulp + "
                   f"{TOL_FLASH_MIRROR}·max of the mirror (P rounded as the "
                   f"route rounds it); fp32 {TOL_F32}·max|ref|",
            "errors": {"bfloat16": errs["bfloat16"]}, "simt_f32_ms": ms_s,
            "simt_f32_bound_ms": b32, "simt_f32_bound_by": by32,
            "simt_f32_errors": dict(errs["float32"],
                                    tol=f"{TOL_F32}·max|ref|")})
        del q, k, v, qt, kt, vt
    return shapes


def paged_call(torch, a, qpos, kw, kd, scale, what):
    """One paged-attention call on its route against the plain version:
    out within tol·max|ref| (TOL_BF16 for bf16 q, TOL_F32 for fp32 q); the
    route ``plan`` picks and only its counter moved; for bf16 q a second
    launch on the same inputs bit for bit.  Returns the error record."""
    from repro_torch.kernels import ops, paged_attention as pa, ref
    q, kp, _, bt, eff = a[:5]
    bf = q.dtype == torch.bfloat16
    tol = TOL_BF16 if bf else TOL_F32
    route = pa.plan(q.shape[0], kp.shape[2], q.shape[2] // kp.shape[2],
                    q.shape[3], eff.shape[1], kd, q.dtype).route
    before = ops.kernel_launches()
    out = pa.paged_attention_cuda(*a, qpos, scale=scale, kv_dtype=kd, **kw)
    after = ops.kernel_launches()
    moved = {r for r in ("split", "simt") if after[f"paged_attention_{r}"]
             != before[f"paged_attention_{r}"]}
    require(moved == {route} and after[f"paged_attention_{route}"]
            == before[f"paged_attention_{route}"] + 1,
            f"{what}: routes {moved}, want {route}")
    ro = ref.paged_attention_ref(*a, q_positions=qpos, softmax_scale=scale,
                                 kv_dtype=kd, **kw)
    torch.cuda.synchronize()
    e, m = max_err(torch, out, ro)
    require(e <= tol * m, f"{what}: {e} > {tol}·{m}")
    rec = {"route": route, "max_abs_err": e, "max_ref": m}
    if bf:
        out2 = pa.paged_attention_cuda(*a, qpos, scale=scale, kv_dtype=kd,
                                       **kw)
        require(torch.equal(out, out2), f"{what}: a second launch differs")
        rec["repeat_bit_identical"] = True
    return rec


def paged_bytes(kd, q_bytes, rows, B, Hq, Hkv, dh, J, ps):
    """Bytes a paged call must move: the admitted rows' payload (and fp32
    scales) for every kv-head, the in-flight tokens (q's type), the eff_pos row
    and block table, q in and out, q_positions."""
    from repro_torch.kernels import paged_attention as pa
    row = pa.row_bytes(kd, dh) + (4 if kd else 0)
    return (rows * Hkv * 2 * row + B * Hkv * dh * 2 * q_bytes + B * J * ps * 4
            + B * J * 4 + 2 * B * Hq * dh * q_bytes + B * 4)


def paged_history(torch, np, dev, cfg, kv_dtypes, B=4, T=512, ps=16,
                  J=1024, layer=16, keep=0.5):
    """B slots' T-token entry streams in one store per payload type, packed
    by the port's own ``pack_prefill`` from a keep-0.5 gate log over every
    layer (random K/V rows), block tables over a shuffled pool of B·J pages,
    and the effective positions of a middle layer from the port's history
    functions.  Returns (stores, block_table [B, J], eff_pos [B, J·ps],
    fill per slot)."""
    from repro_torch.kvcache import history, paged
    L, Hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(15)
    rng = np.random.default_rng(15)
    P = B * J
    bt = torch.as_tensor(rng.permutation(P).reshape(B, J).astype(np.int32),
                         device=dev)
    stores = {kd: paged.init_store(cfg, P, ps, kv_dtype=kd, device=dev)
              for kd in kv_dtypes}
    fill = []
    for b in range(B):
        gates = (torch.rand((L, T), generator=g, device=dev) < keep).float()
        cache = [{n: torch.randn((1, T, Hkv, dh), generator=g,
                                 device=dev).to(torch.bfloat16)
                  for n in ("k", "v")} for _ in range(L)]
        for kd, st in stores.items():
            paged.pack_prefill(st, cache, gates, T, bt[b], cfg, kv_dtype=kd)
        fill.append(int(history.fresh_mask(gates, True).sum()))
        del cache
    view = paged.gather_view(stores[kv_dtypes[0]], bt, with_kv=False)
    E = J * ps
    in_fill = (torch.arange(E, device=dev)[None]
               < torch.tensor(fill, device=dev)[:, None])
    eff = history.effective_positions(view["pos"], view["l0"], view["l1"],
                                      in_fill, layer)
    return stores, bt, eff, fill


def check_paged(torch, np, dev, timer, cfg, B=4, T=512, ps=16, J=1024,
                layer=16):
    """Paged decode attention at the full-width decode shape: B 4, 32 heads,
    dh 128, page 16, a 1024-page walk over 512-token histories, in bf16,
    int8 and int4 pages: bf16 q on the split walk (timed; beside it the
    SIMT kernel on the same bf16 inputs, the route bf16 decode took before
    the split walk, and the dense pool's split-KV walk over the same
    admitted rows laid out contiguously, the yardstick), fp32 q on the
    SIMT kernel (int8 and int4 pages; timed).  Returns the shape records
    by route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref
    from repro_torch.kvcache import paged
    Hq, dh, Hkv = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads
    kinds = (None, "int8", "int4")
    stores, bt, eff, fill = paged_history(torch, np, dev, cfg, kinds, B=B,
                                          T=T, ps=ps, J=J, layer=layer)
    g = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    q = torch.randn((B, 1, Hq, dh), generator=g, device=dev).to(bf)
    kt = torch.randn((B, 1, Hkv, dh), generator=g, device=dev).to(bf)
    vt = torch.randn((B, 1, Hkv, dh), generator=g, device=dev).to(bf)
    qpos = torch.full((B, 1), T, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    hist_rows = int((eff <= T).sum().item())
    require(hist_rows == B * T, f"layer {layer} admits {hist_rows} entries, "
            f"not one per token ({B * T})")
    # the yardstick: the admitted bf16 rows gathered in order, then the
    # in-flight token, as the dense pool holds them (kv_len T + 1)
    st = stores[None]
    rows = paged.gather_view(st, bt)          # [B, J·ps, ...]
    order = torch.argsort(torch.where(eff <= T, eff, T + 1), dim=1,
                          stable=True)[:, :T]
    idx = order[..., None, None].expand(B, T, Hkv, dh)
    kd_ = torch.cat([rows["k"].gather(1, idx), kt], 1).contiguous()
    vd_ = torch.cat([rows["v"].gather(1, idx), vt], 1).contiguous()
    kvl = torch.full((B,), T + 1, dtype=torch.int32, device=dev)
    ms_y = timer(lambda: fa.flash_attention_cuda(q, kd_, vd_, qpos, kvl,
                                                 scale=scale))
    y_route = fa.plan(B * Hkv, Hq // Hkv, T + 1, dh, q.dtype).route
    del rows, kd_, vd_, idx
    shapes = {"split": [], "simt": []}
    for kd in kinds:
        st = stores[kd]
        kw = {} if kd is None else {"k_scales": st["k_scales"],
                                    "v_scales": st["v_scales"]}
        pages = (st["k_pages"], st["v_pages"], bt, eff)
        label = f"B={B} H={Hq} dh={dh} ps={ps} J={J} T={T} layer={layer}"
        a = (q, *pages, kt, vt)
        p = pa.plan(B, Hkv, Hq // Hkv, dh, J * ps, kd, q.dtype)
        simt_bf16 = pa.plan(B, Hkv, Hq // Hkv, dh, J * ps, kd, torch.float32)
        err = paged_call(torch, a, qpos, kw, kd, scale,
                         f"paged {kd or 'bf16'} bf16")
        ms_k = timer(lambda: pa.paged_attention_cuda(
            *a, qpos, scale=scale, kv_dtype=kd, **kw))
        ms_s = timer(lambda: pa.run_plan(simt_bf16, *a, qpos, scale=scale,
                                         kv_dtype=kd, **kw))
        ms_p = timer(lambda: ref.paged_attention_ref(
            *a, q_positions=qpos, softmax_scale=scale, kv_dtype=kd, **kw))
        nbytes = paged_bytes(kd, 2, hist_rows, B, Hq, Hkv, dh, J, ps)
        b, by = bound_ms(nbytes, 4.0 * (hist_rows + B) * Hq * dh)
        shapes["split"].append({
            "shape": f"paged {kd or 'bf16'} pages, bf16 q, {label}",
            "plan": dataclasses.asdict(p), "ms": ms_k, "plain_ms": ms_p,
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "bytes": nbytes, "simt_bf16_ms": ms_s,
            "yardstick_flash_splitkv_ms": ms_y, "yardstick_route": y_route,
            "admitted_rows": hist_rows + B, "entries_walked": B * J * ps,
            "fill": fill, "tpu_walk_bytes": B * J * ps * Hkv * 2 * (
                pa.row_bytes(kd, dh) + (4 if kd else 0)),
            "tol": f"{TOL_BF16}·max|ref|", "errors": {"bfloat16": err}})
        if kd is None:
            continue            # native pages are bf16: q must match
        a32 = (q.float(), *pages, kt.float(), vt.float())
        err = paged_call(torch, a32, qpos, kw, kd, scale,
                         f"paged {kd} fp32")
        ms_k = timer(lambda: pa.paged_attention_cuda(
            *a32, qpos, scale=scale, kv_dtype=kd, **kw))
        ms_p = timer(lambda: ref.paged_attention_ref(
            *a32, q_positions=qpos, softmax_scale=scale, kv_dtype=kd, **kw))
        nbytes = paged_bytes(kd, 4, hist_rows, B, Hq, Hkv, dh, J, ps)
        b, by = bound_ms(nbytes, 4.0 * (hist_rows + B) * Hq * dh,
                         FP32_OPS_PER_S)
        shapes["simt"].append({
            "shape": f"paged {kd} pages, fp32 q, {label}",
            "plan": dataclasses.asdict(simt_bf16), "ms": ms_k,
            "plain_ms": ms_p, "library_ms": None, "bound_ms": b,
            "bound_by": by, "bytes": nbytes,
            "tol": f"{TOL_F32}·max|ref|", "errors": {"float32": err}})
    del stores
    return shapes


def ssd_inputs(torch, dev, g, B, T, H, P, N, G, dt):
    """SSD scan inputs: x, B, C ~ N(0, 1) in ``dt``; dt (softplus'd) in
    (0, 0.1) with every third token skipped (dt = 0, as the routing gate
    leaves it); A_log = log(linspace(1, 16)) as the model's init."""
    x = torch.randn((B, T, H, P), generator=g, device=dev).to(dt)
    d = torch.rand((B, T, H), generator=g, device=dev) * 0.1
    d[:, 1::3] = 0.0
    A = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    Bm = torch.randn((B, T, G, N), generator=g, device=dev).to(dt)
    Cm = torch.randn((B, T, G, N), generator=g, device=dev).to(dt)
    return x, d, A, Bm, Cm


def ssd_exact_inputs(torch, dev, g, B, T, H, P, N, G):
    """bf16 SSD scan inputs whose chunk cumsums are exact in any order: x,
    B, C ~ N(0, 1); A_log = 0 (A = -1); dt on a 2^-10 grid in [0, 0.1),
    every third token 0.  exp(cum_i - cum_j) then has the same argument on
    the card as in the plain versions, so the tensor-core route differs
    from ``ref.ssd_scan_split`` only by its sum order and its exp; on
    ``ssd_inputs`` the fp32 cumsum's order alone moves y by ~4e-6·max,
    as much as the split's lo term."""
    x = torch.randn((B, T, H, P), generator=g, device=dev).bfloat16()
    d = torch.randint(0, 103, (B, T, H), generator=g, device=dev) / 1024.0
    d[:, 1::3] = 0.0
    A = torch.zeros(H, device=dev)
    Bm = torch.randn((B, T, G, N), generator=g, device=dev).bfloat16()
    Cm = torch.randn((B, T, G, N), generator=g, device=dev).bfloat16()
    return x, d, A, Bm, Cm


def ssd_errors(torch, args, chunk, what, split_tol=TOL_F32):
    """The kernel's y and final state, on the route ``ss.plan`` picks,
    against the plain version's, each within TOL_F32 · max|ref| (fp32
    outputs of fp32 math on the same inputs; the tensor-core route splits
    its fp32 operands into three bf16 terms, exact to fp32); on the
    tensor-core route also against ``ref.ssd_scan_split``, which rounds
    the operands as the route does, within ``split_tol`` · max|mirror|; a
    second launch must repeat both bit for bit.  Returns {"route",
    "max_abs_err", "max_ref", "state_*", "split_*"}."""
    from repro_torch.kernels import ref, ssd_scan as ss
    x, Bm = args[0], args[3]
    route = ss.plan(*x.shape, Bm.shape[-1], Bm.shape[-2], chunk,
                    x.dtype).route
    y, st = ss.ssd_scan_cuda(*args, chunk)
    y2, st2 = ss.ssd_scan_cuda(*args, chunk)
    yr, sr = ref.ssd_scan_ref(*args, chunk)
    torch.cuda.synchronize()
    require(torch.equal(y, y2) and torch.equal(st, st2),
            f"ssd_scan {route} {what}: a second launch differs")
    e, m = max_err(torch, y, yr)
    es, ms = max_err(torch, st, sr)
    out = {"route": route, "max_abs_err": e, "max_ref": m,
           "state_max_abs_err": es, "state_max_ref": ms,
           "second_launch_identical": True}
    if route == "tc":
        ym, sm = ref.ssd_scan_split(*args, chunk)
        e2, m2 = max_err(torch, y, ym)
        es2, ms2 = max_err(torch, st, sm)
        out.update(split_max_abs_err=e2, split_max_ref=m2,
                   split_state_max_abs_err=es2, split_state_max_ref=ms2,
                   split_tol=split_tol)
    require(e <= TOL_F32 * m, f"ssd_scan y {what}: {e} > {TOL_F32}·{m}")
    require(es <= TOL_F32 * ms, f"ssd_scan state {what}: {es} > "
            f"{TOL_F32}·{ms}")
    if route == "tc":
        require(e2 <= split_tol * m2 and es2 <= split_tol * ms2,
                f"ssd_scan {what} against its split mirror: y {e2} of {m2}, "
                f"state {es2} of {ms2}, limit {split_tol}·max")
    return out


def ssd_work(B, T, H, P, N, G, chunk, esize, splits=1):
    """(bytes, operations) one scan needs: each input read once and each
    output written once; the chunk products over the real tokens (causal
    pairs of each chunk: C·B and the intra-chunk y; C·state and the state
    update per token), the products with an fp32 operand ``splits`` times
    (1: the scan's own work, what the bound counts; 3: the tensor-core
    route's three bf16 terms; C·B is bf16 × bf16 either way)."""
    Q = min(chunk, T)
    ops = 0
    for t0 in range(0, T, Q):
        L = min(Q, T - t0)
        pairs = L * (L + 1) // 2
        ops += 2 * pairs * N + splits * (2 * pairs * P + 4 * L * N * P)
    nbytes = (B * T * H * P * esize + B * T * H * 4 + H * 4
              + 2 * B * T * G * N * esize + B * T * H * P * 4
              + B * H * P * N * 4)
    return nbytes, float(B * H * ops)


def check_ssd(torch, dev, timer, cfg):
    """The SSD chunk scan at the mamba2-2.7b main-path shapes: lock-step
    prefill (B 4 × T 512) and one continuous prefill (B 1 × T 512), y and
    the final state.  bf16 inputs on the tensor-core route (timed; beside
    it the SIMT kernel on the same bf16 inputs, through ``run_plan``), fp32
    inputs on the SIMT kernel (timed), each launched twice bit for bit.
    The tensor-core route is held also against ``ref.ssd_scan_split``:
    within TOL_F32 on these inputs and within TOL_SPLIT on
    ``ssd_exact_inputs`` of the same shape.  Each record carries both
    bounds: bytes, and the scan's operations, each product counted once,
    at the route's rate (bf16 tensor cores; the SIMT kernel's fp32), and
    beside them the tensor-core route's operations with its three split
    terms counted (``tc_split_ops``, not a bound).  Returns the shape
    records by route."""
    from repro_torch.kernels import ref, ssd_scan as ss
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    G, Q = cfg.ssm_groups, cfg.ssm_chunk
    g = torch.Generator(device=dev).manual_seed(19)
    shapes = {"tc": [], "simt": []}
    for B, T in ((4, 512), (1, 512)):
        label = f"B={B} T={T} H={H} P={P} N={N} G={G} Q={Q}"
        tol = f"y and state {TOL_F32}·max|ref| (fp32 outputs)"
        args = ssd_inputs(torch, dev, g, B, T, H, P, N, G, torch.bfloat16)
        p = ss.plan(B, T, H, P, N, G, Q, torch.bfloat16)
        simt_bf16 = ss.plan(B, T, H, P, N, G, Q, torch.float32)
        require(p.route == "tc" and simt_bf16.route == "simt",
                f"ssd_scan {label}: plans {p.route}/{simt_bf16.route}")
        err = ssd_errors(torch, args, Q, f"{label} bf16")
        exact = ssd_errors(torch, ssd_exact_inputs(torch, dev, g, B, T, H, P,
                                                   N, G), Q,
                           f"{label} bf16 exact cumsums", TOL_SPLIT)
        ms_k = timer(lambda: ss.ssd_scan_cuda(*args, Q))
        ms_s = timer(lambda: ss.run_plan(simt_bf16, *args, Q))
        ms_p = timer(lambda: ref.ssd_scan_ref(*args, Q))
        nbytes, ops = ssd_work(B, T, H, P, N, G, Q, 2)
        b, by = bound_ms(nbytes, ops)
        shapes["tc"].append({
            "shape": f"{label} bf16", "plan": dataclasses.asdict(p),
            "ms": ms_k, "plain_ms": ms_p, "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "bound_ops_ms": ops / BF16_OPS_PER_S * 1e3,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "ops": ops,
            "tc_split_ops": ssd_work(B, T, H, P, N, G, Q, 2, splits=3)[1],
            "simt_bf16_ms": ms_s, "tol": tol, "errors": {"bfloat16": err},
            "exact_cumsums": exact})
        a32 = (args[0].float(),) + args[1:3] + tuple(m.float()
                                                     for m in args[3:])
        del args
        err = ssd_errors(torch, a32, Q, f"{label} fp32")
        ms_k = timer(lambda: ss.ssd_scan_cuda(*a32, Q))
        ms_p = timer(lambda: ref.ssd_scan_ref(*a32, Q))
        nbytes, ops = ssd_work(B, T, H, P, N, G, Q, 4)
        b, by = bound_ms(nbytes, ops, FP32_OPS_PER_S)
        shapes["simt"].append({
            "shape": f"{label} fp32", "plan": dataclasses.asdict(simt_bf16),
            "ms": ms_k, "plain_ms": ms_p, "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "bound_ops_ms": ops / FP32_OPS_PER_S * 1e3,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "ops": ops, "tol": tol,
            "errors": {"float32": err}})
        del a32
    return shapes


# SSD scan off the main shapes: B, T, H, P, N, G, chunk (T off the chunk,
# T < chunk with G = 2, T = 1, G = 3 with two heads per group at chunk 64,
# one token past a chunk at full width)
SSD_RAGGED = ((2, 300, 8, 64, 128, 1, 128), (1, 37, 8, 64, 128, 2, 128),
              (3, 1, 4, 64, 128, 1, 128), (2, 200, 6, 32, 16, 3, 64),
              (1, 129, 80, 64, 128, 1, 128))


def check_ragged(torch, dev):
    """Shapes off the main path's tile multiples (ragged M, K, F, Tq, Tk,
    G > 1, a window), against the plain versions, not timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl
    g = torch.Generator(device=dev).manual_seed(14)
    worst, dense, flash, int4, paged_recs, ssd = {}, {}, {}, {}, {}, {}
    router = {}

    def note(name, e, m, tol):
        require(e <= tol * m, f"ragged {name}: {e} > {tol}·{m}")
        worst[name] = max(worst.get(name, 0.0), e / m)

    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        dname = str(dt).split(".")[-1]
        for T, D, off in ROUTER_RAGGED:
            # off: x starts that many elements into its buffer (None: a
            # view one row into a buffer of odd D, one more row)
            w = torch.randn((D, 2), generator=g, device=dev)
            n = (T + 1) * D if off is None else T * D + off
            buf = torch.randn((n,), generator=g, device=dev).to(dt)
            x = buf[D if off is None else off:].view(T, D)
            r = router_call(torch, x, w, f"ragged router T={T} D={D} "
                            f"off={off} {dname}")
            note("router_stats", r["max_abs_err"], r["max_ref"], TOL_F32)
            router[f"T={T} D={D} off={off} {dname}"] = r
        for M, K, F, glu in ((37, 200, 70, True), (5, 300, 130, False),
                             (130, 40, 200, False)):
            N = 2 * F if glu else F
            x = torch.randn((M, K), generator=g, device=dev).to(dt)
            w = (torch.randn((K, N), generator=g, device=dev) * 0.05).to(dt)
            kw = dict(mean_sq=(x.float() ** 2).mean(-1),
                      gamma=(1 + 0.1 * torch.randn((K,), generator=g,
                                                   device=dev)).to(dt),
                      glu=glu, act="silu" if glu else None,
                      residual=torch.randn(
                          (M, F), generator=g, device=dev).to(dt),
                      gate_mul=(torch.rand((M,), generator=g, device=dev)
                                > 0.5).float(), emit_sq=True)
            r = fused_linear_call(torch, x, w, kw, f"ragged fused_linear "
                                  f"M={M} K={K} F={F} {dname}")
            note("fused_linear", r["max_abs_err"], r["max_ref"], tol)
            dense[f"M={M} K={K} F={F} {dname}"] = r
        for case in INT4_RAGGED:
            r = ragged_int4(torch, dev, g, dt, *case)
            note("fused_linear_int4", r["max_abs_err"], r["max_ref"], tol)
            int4[f"M={case[0]} K={case[1]} F={case[2]} G={case[4]} "
                 f"{dname}"] = r
        for M, K, N, G, pow2 in ((1, 200, 33, 64, True),
                                 (17, 256, 130, 128, False),
                                 (3, 38, 7, 128, True)):
            codes, scale, _, _ = int4_weight(torch, dev, g, K, N, G, pow2)
            x = bfp_ties(torch, dev, g, M, K, dt)
            r, _ = int4_call(torch, x, codes, scale, {}, f"ragged "
                             f"int4_matmul M={M} K={K} N={N} {dname}",
                             matmul=True)
            note("int4_matmul", r["max_abs_err"], r["max_ref"], tol)
            int4[f"matmul M={M} K={K} N={N} G={G} {dname}"] = r
        for case in FLASH_RAGGED:
            B, Tq, Tk, Hq, Hkv, dh, window, kind = case
            args = flash_ragged_inputs(torch, dev, g, dt, B, Tq, Tk, Hq, Hkv,
                                       dh, kind)
            r = flash_call(torch, *args, f"ragged flash {case} {dname}",
                              window=window, scale=1.0 / math.sqrt(dh))
            note("flash_attention", r["max_abs_err"], r["max_ref"], tol)
            flash[f"{kind} B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} dh={dh} "
                  f"window={window} {dname}"] = r
        for case in PAGED_RAGGED:
            for kd in (None, "int8", "int4"):
                r = ragged_paged(torch, dev, g, dt, kd, *case)
                note("paged_attention", r["max_abs_err"], r["max_ref"], tol)
                paged_recs[f"{case} {kd} {dname}"] = r
        for B, T, H, P, N, G, chunk in SSD_RAGGED:
            r = ssd_errors(torch, ssd_inputs(torch, dev, g, B, T, H, P, N,
                                             G, dt), chunk,
                           f"ragged B={B} T={T} G={G} {dt}")
            note("ssd_scan", r["max_abs_err"], r["max_ref"], TOL_F32)
            note("ssd_scan_state", r["state_max_abs_err"],
                 r["state_max_ref"], TOL_F32)
            ssd[f"B={B} T={T} H={H} P={P} N={N} G={G} Q={chunk} "
                f"{dname}"] = r
    torch.cuda.synchronize()
    routes = {(k.split()[-1], r["rows"], r["vec"]) for k, r in router.items()}
    require(routes == {(d, rv, v) for d in ("bfloat16", "float32")
                       for rv, v in ((4, 2), (1, 2), (1, 1))},
            f"ragged router cases took (rows, vec) {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in flash.items()}
    require(routes == {("bfloat16", "wgmma"), ("bfloat16", "splitkv"),
                       ("float32", "simt")},
            f"ragged flash cases took the routes {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in int4.items()}
    require(routes == {(d, r) for d in ("bfloat16", "float32")
                       for r in ("tc", "stream")},
            f"ragged int4 cases took the routes {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in paged_recs.items()}
    require(routes == {("bfloat16", "split"), ("bfloat16", "simt"),
                       ("float32", "simt")},
            f"ragged paged cases took the routes {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in ssd.items()}
    require(routes == {("bfloat16", "tc"), ("float32", "simt")},
            f"ragged ssd cases took the routes {sorted(routes)}")
    return {"phase": "ragged", "max_err_over_max_ref": worst,
            "router_stats": router,
            "router_stats_refusals": router_refusals(torch, dev),
            "fused_linear": dense,
            "fused_linear_refusals": fused_linear_refusals(torch, dev),
            "int4": int4, "int4_refusals": int4_refusals(torch, dev),
            "flash_attention": flash,
            "flash_attention_refusals": flash_refusals(torch, dev),
            "paged_attention": paged_recs,
            "paged_attention_refusals": paged_refusals(torch, dev),
            "ssd_scan": ssd, "ssd_scan_refusals": ssd_refusals(torch, dev)}


# router_stats off the main shapes: T, D and x's offset in its buffer in
# elements (None: one row into a buffer of odd D).  T 1 to 37 take a block
# a row, 2049 blocks of 4 rows (rows off a multiple of the block's; past
# the grid's cap); T 17 and above also rerun their first 16 rows alone;
# D 300, 4096 and 4100 take lanes of 2 elements, D 301 (odd) of 1;
# offsets of 1 and 2 elements make x's address take 1 and 2.
ROUTER_RAGGED = ((1, 300, 0), (16, 300, 0), (17, 300, 0), (37, 300, 0),
                 (2049, 300, 0), (1, 4100, 0), (16, 4100, 0),
                 (17, 4100, 0), (2049, 4100, 0), (1, 4096, 0),
                 (17, 4096, 0), (3, 301, None), (20, 301, None),
                 (4, 4096, 1), (20, 4096, 1), (4, 4096, 2), (20, 4096, 2))


def router_refusals(torch, dev):
    """The router's C entries refuse a plan that disagrees with the
    source: a grid, thread count or shared-memory size other than the
    plan's, a vector width the kernel has no instantiation of or to which
    x's address is not aligned, or rows a block past its 16 warps; it
    returns cudaErrorInvalidValue and the wrapper raises, at a block a row
    and at blocks of 4 rows and in both element types."""
    from repro_torch.kernels import fused_router_rmsnorm as frr
    refused = {}
    rep = dataclasses.replace
    D = 4096
    w = torch.zeros((D, 2), device=dev)
    for dt in (torch.bfloat16, torch.float32):
        buf = torch.zeros((2048 * D + 1,), dtype=dt, device=dev)
        for T in (2048, 4):
            x = buf[:T * D].view(T, D)
            p = frr.plan(T, D, dt, x.data_ptr())
            bad = {"grid": rep(p, grid=p.grid + 1),
                   "threads": rep(p, threads=p.threads + 32),
                   "smem": rep(p, smem=p.smem + 16),
                   "vec4": rep(p, vec=4), "vec3": rep(p, vec=3),
                   "rows": rep(p, rows=8, grid=-(-T // 8),
                               threads=p.threads * 8 // p.rows,
                               smem=p.smem * 8 // p.rows)}
            for what, bp in bad.items():
                try:
                    frr.run_plan(bp, x, w)
                except RuntimeError as e:
                    refused[f"T={T} {what} {dt}"] = str(e)
                    continue
                raise RuntimeError(f"router_stats T={T}: a plan with "
                                   f"{what} off the source was not refused")
            xm = buf[1:1 + T * D].view(T, D)      # 2 or 4 bytes off
            try:
                frr.run_plan(p, xm, w)
            except RuntimeError as e:
                refused[f"T={T} misaligned {dt}"] = str(e)
                continue
            raise RuntimeError(f"router_stats T={T}: a {p.vec}-element "
                               "vector at a misaligned x was not refused")
    torch.cuda.synchronize()
    return refused


# flash attention off the main shapes: B, Tq, Tk, Hq, Hkv, dh, window and
# the positions (``flash_ragged_inputs``).  bf16 takes the tensor-core tile
# for the first three (G 2; dh 32 with a window; pad rows and Tk off the
# 128-key tile) and the split-KV walk for the last three (G 4; kv_len 3
# of 544, so whole splits see no valid key; R 16 causal); fp32 takes the
# SIMT kernel for all.
FLASH_RAGGED = ((2, 24, 24, 4, 2, 64, 0, "prefill"),
                (1, 37, 37, 4, 4, 32, 8, "prefill"),
                (2, 40, 70, 8, 4, 128, 0, "tail"),
                (3, 1, 50, 8, 2, 128, 0, "decode"),
                (2, 1, 544, 4, 4, 128, 0, "short"),
                (2, 16, 16, 2, 2, 64, 0, "prefill"))


def flash_ragged_inputs(torch, dev, g, dt, B, Tq, Tk, Hq, Hkv, dh, kind):
    """q, k, v ~ N(0, 1) in dt and int32 positions: "prefill" 0..Tq-1 with
    kv_len Tk - 3b; "tail" the last Tq of Tk with kv_len Tk - 9b and batch
    1's last 5 rows pads (-1); "decode" at kv_len - 1, kv_len Tk - 3b;
    "short" decode with kv_len 3 (then 300)."""
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(dt)  # noqa
    q, k, v = rnd(B, Tq, Hq, dh), rnd(B, Tk, Hkv, dh), rnd(B, Tk, Hkv, dh)
    step = {"prefill": 3, "tail": 9, "decode": 3}.get(kind, 0)
    kvl = torch.tensor([Tk - step * b for b in range(B)], dtype=torch.int32,
                       device=dev)
    if kind == "short":
        kvl = torch.tensor([3, 300][:B], dtype=torch.int32, device=dev)
    ar = torch.arange(Tq, dtype=torch.int32, device=dev)[None]
    if kind == "prefill":
        qpos = ar.expand(B, Tq)
    elif kind == "tail":
        qpos = (ar + Tk - Tq).repeat(B, 1)
        qpos[1, -5:] = -1
    else:
        qpos = kvl[:, None] - 1
    return q, k, v, qpos, kvl


def flash_refusals(torch, dev):
    """Flash attention's C entries refuse a plan that disagrees with the
    source: a key tile, grid, split or shared-memory size it has no
    instantiation of, or the SIMT route for bf16, returns
    cudaErrorInvalidValue and the wrapper raises, on every route."""
    from repro_torch.kernels import flash_attention as fa
    refused = {}
    B, Hkv, dh, Tk = 2, 2, 64, 100
    for Tq, dt in ((40, torch.bfloat16), (1, torch.bfloat16),
                   (40, torch.float32)):
        q = torch.zeros((B, Tq, Hkv, dh), dtype=dt, device=dev)
        k = torch.zeros((B, Tk, Hkv, dh), dtype=dt, device=dev)
        qpos = torch.full((B, Tq), Tk - 1, dtype=torch.int32, device=dev)
        p = fa.plan(B * Hkv, Tq, Tk, dh, dt)
        bad = {"tile_k": dataclasses.replace(p, tile_k=p.tile_k // 2),
               "grid": dataclasses.replace(p, grid=(p.grid[0] + 1,
                                                     p.grid[1])),
               "smem": dataclasses.replace(p, smem=p.smem + 16)}
        if p.route == "splitkv":
            bad["splits"] = dataclasses.replace(
                p, splits=p.splits + 1, grid=(p.splits + 1, p.grid[1]))
        if dt == torch.bfloat16:
            bad["simt"] = fa.plan(B * Hkv, Tq, Tk, dh, torch.float32)
        for what, bp in bad.items():
            try:
                fa.run_plan(bp, q, k, k, qpos, None, causal=True, window=0,
                            scale=0.125)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"flash_attention {p.route}: a plan with "
                               f"{what} off the source was not refused")
    torch.cuda.synchronize()
    return refused


def fused_linear_refusals(torch, dev):
    """The dense fused linear's C entries refuse a plan that disagrees with
    the source: one entry of Σy² or split-K scratch short of what the grid
    writes, or a tile width the source has no instantiation of, returns
    cudaErrorInvalidValue and the wrapper raises, on every route."""
    from repro_torch.kernels import fused_linear as fl
    refused = {}
    for M, dt in ((4, torch.bfloat16), (37, torch.bfloat16),
                  (37, torch.float32)):
        K, F = 64, 136
        p = fl.plan(M, K, F, False, dt)
        x = torch.zeros((M, K), dtype=dt, device=dev)
        w = torch.zeros((K, F), dtype=dt, device=dev)
        bad = {"tile_n": dataclasses.replace(p, tile_n=p.tile_n // 2)}
        if p.route == "splitk":
            bad["part"] = dataclasses.replace(p, part=p.part - 1)
        else:
            bad["sq_part"] = dataclasses.replace(p, sq_part=p.sq_part - 1)
        for what, q in bad.items():
            try:
                fl.run_plan(q, x, w, mean_sq=None, gamma=None, eps=1e-5,
                            glu=False, act=None, residual=None,
                            gate_mul=None, emit_sq=True)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"fused_linear {p.route}: a plan with {what} "
                               "off the source was not refused")
    torch.cuda.synchronize()
    return refused


# int4 fused linear off the main shapes: M, K, F, glu, group, pow2 scales,
# norm prologue, gate/residual/Σy² epilogue (K 200 and 38 leave a padded
# last group; G 38 leaves a part-filled 32-bit word; F 131 and 97 are odd)
INT4_RAGGED = ((1, 200, 70, True, 64, True, True, True),
               (3, 200, 131, False, 64, False, False, True),
               (17, 300, 97, False, 32, True, True, False),
               (17, 38, 64, True, 128, False, True, False),
               (5, 256, 64, False, 128, True, False, False))


def bfp_ties(torch, dev, g, M, K, dt):
    """An activation that stresses the BFP conversion: values (2j+1)/256
    with a ±1 per row and 128-group, so x·2^7/2^e ends in .5 (bf16 holds
    them exactly), and an all-zero group in row 0 where K allows."""
    j = torch.randint(-128, 128, (M, K), generator=g, device=dev)
    x = (2 * j + 1).float() / 256
    x[:, ::128] = 1.0
    if K > 128:
        x[0, 128:256] = 0.0
    return x.to(dt)


def ragged_int4(torch, dev, g, dt, M, K, F, glu, G, pow2, pro, epi):
    """One int4 fused-linear call off the main shapes on the route
    ``plan_int4`` picks, against the plain version in the route's order
    (``int4_call``)."""
    N = 2 * F if glu else F
    codes, scale, _, _ = int4_weight(torch, dev, g, K, N, G, pow2)
    _, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
    x = bfp_ties(torch, dev, g, M, K, dt)
    if pro:
        kw["mean_sq"] = 0.5 + torch.rand((M,), generator=g, device=dev)
    cast, _ = _cast(torch, kw, dt)
    return int4_call(torch, x, codes, scale, cast, f"ragged "
                     f"fused_linear_int4 M={M} K={K} F={F} G={G} {dt}")[0]


def int4_refusals(torch, dev):
    """The int4 C entries refuse a plan that disagrees with the source: a
    tile, group split, split count or grid it has no instantiation of, or
    one entry of mantissa, step or Σy² scratch short of what the grid
    writes, returns cudaErrorInvalidValue and the wrapper raises, on both
    routes."""
    from repro_torch.kernels import fused_linear as fl
    refused = {}
    K, F, G = 256, 128, 128
    codes = torch.zeros((K, F), dtype=torch.int8, device=dev)
    scale = torch.ones((K // G, F), dtype=torch.float32, device=dev)
    for M in (37, 4):
        x = torch.zeros((M, K), dtype=torch.bfloat16, device=dev)
        p = fl.plan_int4(M, K, F, G, K // G, False, torch.bfloat16)
        rep = dataclasses.replace
        bad = {"tile_m": rep(p, tile_m=p.tile_m // 2),
               "tile_n": rep(p, tile_n=p.tile_n // 2),
               "grid": rep(p, grid=(p.grid[0] + 1, p.grid[1])),
               "sq_part": rep(p, sq_part=p.sq_part - 1)}
        if p.route == "tc":
            bad.update(group_split=rep(p, group_split=1),
                       mant=rep(p, mant=p.mant - 1),
                       steps=rep(p, steps=p.steps - 1))
        else:
            bad.update(group_split=rep(p, group_split=p.group_split + 1),
                       splits=rep(p, splits=p.splits + 1))
        for what, q in bad.items():
            try:
                fl.run_plan_int4(q, x, codes, scale, emit_sq=True)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"int4 {p.route}: a plan with {what} off "
                               "the source was not refused")
    torch.cuda.synchronize()
    return refused


# paged attention off the main shape: B, Hkv, G, dh, ps, J and the history
# (``ragged_paged``).  bf16 q takes the split walk for all but the last (G
# 32, the SIMT kernel); among them G 8 and 16, Hkv 6 over head groups of 4
# and Hkv 3 over groups of 2 (a short last group), 3 admitted entries over
# 8 blocks (n < S), every admitted entry in the first block's slice, an
# empty history, and a 40960-entry row, two windows of 8 slices of 4096
# (~24600 admitted, rounds of 1024 listed rows); fp32 q takes the SIMT
# kernel for all.
PAGED_RAGGED = ((3, 2, 2, 64, 16, 5, "random"), (2, 1, 4, 32, 8, 7, "random"),
                (2, 2, 4, 64, 4, 3, "empty"), (1, 3, 1, 32, 5, 9, "random"),
                (2, 2, 8, 128, 16, 40, "random"),
                (2, 1, 16, 64, 16, 64, "random"),
                (16, 6, 2, 64, 16, 128, "random"),
                (16, 3, 1, 32, 16, 128, "random"),
                (1, 2, 1, 128, 16, 128, "few"),
                (2, 4, 1, 128, 16, 128, "front"),
                (1, 1, 4, 64, 16, 2560, "random"),
                (1, 1, 32, 64, 8, 5, "random"))


def ragged_history(torch, dev, g, B, E, kind, qp):
    """Effective positions [B, E] below qp: "random" 40 % masked; "empty"
    all masked; "few" 3 admitted entries in all; "front" only among the
    first 200 entries (40 % masked there)."""
    from repro_torch.kvcache import history
    masked = history.MASKED_POS
    eff = torch.randint(0, qp, (B, E), generator=g, device=dev,
                        dtype=torch.int32)
    if kind == "random":
        eff[torch.rand((B, E), generator=g, device=dev) < 0.4] = masked
    elif kind == "empty":
        eff.fill_(masked)
    elif kind == "few":
        keep = torch.randperm(B * E, generator=g, device=dev)[:3]
        flat = torch.full((B * E,), masked, dtype=torch.int32, device=dev)
        flat[keep] = eff.reshape(-1)[keep]
        eff = flat.reshape(B, E)
    elif kind == "front":
        eff[torch.rand((B, E), generator=g, device=dev) < 0.4] = masked
        eff[:, 200:] = masked
    return eff


def ragged_paged(torch, dev, g, dt, kd, B, Hkv, G, dh, ps, J, kind, P=64,
                 qp=20):
    """One paged-attention call off the main shapes on its route against
    its plain version (``paged_call``): random pages and block tables
    (all-zero for an empty history), effective positions as
    ``ragged_history`` makes them."""
    from repro_torch.kvcache import paged
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev)   # noqa
    q, kt, vt = rnd(B, 1, G * Hkv, dh), rnd(B, 1, Hkv, dh), rnd(B, 1, Hkv, dh)
    kp, vp = rnd(P, ps, Hkv, dh), rnd(P, ps, Hkv, dh)
    kw = {}
    if kd is None:
        kp, vp = kp.to(dt), vp.to(dt)
    else:
        kp, vp, ks, vs = paged.quantize_entries(kp, vp, kd)
        kw = {"k_scales": ks, "v_scales": vs}
    if kind == "empty":
        bt = torch.zeros((B, J), dtype=torch.int32, device=dev)
    else:
        bt = torch.randint(0, P, (B, J), generator=g, device=dev,
                           dtype=torch.int32)
    eff = ragged_history(torch, dev, g, B, J * ps, kind, qp)
    qpos = torch.full((B, 1), qp, dtype=torch.int32, device=dev)
    a = (q.to(dt), kp, vp, bt, eff, kt.to(dt), vt.to(dt))
    rec = paged_call(torch, a, qpos, kw, kd, 1.0 / math.sqrt(dh),
                     f"ragged paged B={B} Hkv={Hkv} G={G} dh={dh} ps={ps} "
                     f"J={J} {kind} {kd} {dt}")
    rec["admitted"] = int((eff <= qp).sum().item())
    return rec


def paged_refusals(torch, dev):
    """Paged attention's C entries refuse a plan that disagrees with the
    source: more kv-heads per block than warps, a tile, ring depth, split,
    grid or shared-memory size it has no instantiation of, rows the SIMT
    kernel does not take, or the split walk for fp32 q, returns
    cudaErrorInvalidValue and the wrapper raises, on both routes."""
    from repro_torch.kernels import paged_attention as pa
    refused = {}
    B, Hkv, G, dh, ps, J, P = 2, 4, 2, 64, 16, 32, 8
    kp = torch.zeros((P, ps, Hkv, dh), dtype=torch.bfloat16, device=dev)
    bt = torch.zeros((B, J), dtype=torch.int32, device=dev)
    eff = torch.zeros((B, J * ps), dtype=torch.int32, device=dev)
    tok = torch.zeros((B, 1, Hkv, dh), dtype=torch.bfloat16, device=dev)
    qpos = torch.ones((B, 1), dtype=torch.int32, device=dev)
    rep = dataclasses.replace
    for dt in (torch.bfloat16, torch.float32):
        q = torch.zeros((B, 1, Hkv * G, dh), dtype=dt, device=dev)
        pages = kp.to(dt)
        p = pa.plan(B, Hkv, G, dh, J * ps, None, dt)
        bad = {"tile": rep(p, tile=p.tile * 2),
               "grid": rep(p, grid=(p.grid[0] + 1, p.grid[1])),
               "smem": rep(p, smem=p.smem + 16)}
        if p.route == "split":
            bad.update(
                heads=rep(p, heads=2 * pa.SPLIT_WARPS,
                          tile=pa.SPLIT_SUB // 2,
                          grid=(p.grid[0],
                                B * -(-Hkv // (2 * pa.SPLIT_WARPS)))),
                stages=rep(p, stages=pa.SPLIT_MAX_STAGES + 1,
                           smem=pa.split_smem(None, p.heads, dh,
                                              pa.SPLIT_MAX_STAGES + 1)),
                splits=rep(p, splits=pa.SPLIT_MAX_S + 1,
                           grid=(pa.SPLIT_MAX_S + 1, p.grid[1])),
                rows=rep(p, rows=8))
        else:
            bad.update(rows=rep(p, rows=2, grid=(p.grid[0], -(-G // 2))),
                       split=pa.plan(B, Hkv, G, dh, J * ps, None,
                                     torch.bfloat16))
        for what, bp in bad.items():
            try:
                pa.run_plan(bp, q, pages, pages, bt, eff, tok.to(dt),
                            tok.to(dt), qpos, scale=0.125)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"paged_attention {p.route}: a plan with "
                               f"{what} off the source was not refused")
    torch.cuda.synchronize()
    return refused


def ssd_refusals(torch, dev):
    """The SSD scan's C entries refuse a plan that disagrees with the
    source: a P slice it has no instantiation of or that does not divide
    P, a grid, thread count, stage count or shared-memory size other than
    the plan's, the SIMT kernel with a P split, or the tensor-core route
    for fp32 inputs, returns cudaErrorInvalidValue and the wrapper raises,
    on both routes."""
    from repro_torch.kernels import ssd_scan as ss
    refused = {}
    B, T, H, P, N, G, Q = 2, 40, 4, 64, 128, 1, 32
    rep = dataclasses.replace
    for dt in (torch.bfloat16, torch.float32):
        args = (torch.zeros((B, T, H, P), dtype=dt, device=dev),
                torch.zeros((B, T, H), device=dev), torch.zeros(H, device=dev),
                torch.zeros((B, T, G, N), dtype=dt, device=dev),
                torch.zeros((B, T, G, N), dtype=dt, device=dev))
        p = ss.plan(B, T, H, P, N, G, Q, dt)
        bad = {"grid": rep(p, grid=(p.grid[0] + 1, p.grid[1])),
               "threads": rep(p, threads=128),
               "stages": rep(p, stages=p.stages + 1),
               "smem": rep(p, smem=p.smem + 16)}
        if p.route == "tc":
            bad.update(
                pb16=rep(p, pb=16, grid=(B * H, 4), smem=ss.tc_smem(Q, N, 16)),
                pb32=rep(p, pb=32, grid=(B * H, 2), smem=ss.tc_smem(Q, N, 32)),
                pb128=rep(p, pb=128, grid=(B * H, 1),
                          smem=ss.tc_smem(Q, N, 128)))
        else:
            bad.update(pb=rep(p, pb=P // 2, grid=(B * H, 2)),
                       tc=ss.plan(B, T, H, P, N, G, Q, torch.bfloat16))
        for what, bp in bad.items():
            try:
                ss.run_plan(bp, *args, Q)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"ssd_scan {p.route}: a plan with {what} off "
                               "the source was not refused")
    torch.cuda.synchronize()
    return refused


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


def _forced_paged(model, prompts, forced, ps=8, num_pages=32,
                  cap_tokens=64):
    """Prefill each prompt into a paged store (the port's pack_prefill),
    then teacher-forced paged decode steps.  Returns (logits, gate logs)."""
    import torch
    from repro_torch.kvcache import paged
    cfg, dev = model.cfg, model.device
    nA, S = cfg.num_layers, len(prompts)
    store = paged.init_store(cfg, num_pages, ps, device=dev)
    alloc = paged.PageAllocator(num_pages, ps, S,
                                slot_entry_capacity=cap_tokens * nA)
    logits, gates = [], []
    for i, p in enumerate(prompts):
        lg, cache, st = model.prefill(torch.as_tensor(p[None]))
        g = st["attn_gate"][:, 0]
        gates.append(g.cpu())
        logits.append(lg.float().cpu())
        n = paged.prefill_entry_count(g.cpu().numpy(), len(p), True)
        require(alloc.ensure(i, n + nA), "parity store too small")
        paged.pack_prefill(store, cache, g, len(p),
                           torch.as_tensor(alloc.block_table[i], device=dev),
                           cfg)
        alloc.append(i, n, nA * len(p))
    t = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for s in range(forced.shape[1]):
        for i in range(S):
            require(alloc.ensure(i, int(alloc.fill[i]) + nA),
                    "parity store too small")
        lg, store, st = model.paged_decode_step(
            store, forced[:, s:s + 1], t, torch.as_tensor(alloc.block_table),
            torch.as_tensor(alloc.fill))
        g = st["attn_gate"].cpu()
        gates.append(g)
        logits.append(lg.float().cpu())
        for i in range(S):
            alloc.append(i, int(1 + g[1:, i].sum()), nA)
        t = t + 1
    return logits, gates


def _paged_engine(model, prompts, new):
    from repro_torch.serve.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48,
                                   kv_mode="paged", page_size=8)
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    eng.allocator.check_conservation()
    require(eng.allocator.free_pages == eng.num_pages, "pages leaked")
    return [out["results"][u] for u in uids], out["stats"]


def parity(torch, np, dev, int4=False):
    """CPU ≡ CUDA on the fp32 smoke model; with ``int4`` every linear and
    the lm head hold int4 codes (group 64, so the smoke widths make
    several groups; the 4096-element floor lets every smoke linear in)."""
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.kernels import ops
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.quant import quantize_params
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config("llama2-7b").smoke(),
                              dtype="float32")
    params = routing.neutral_router_bias(
        init_params(cfg, torch.Generator().manual_seed(PARITY_SEED), "cpu"))
    for blk in params["blocks"]:            # routers at unit scale, so no
        for sub in blk.values():            # gate sits near the strict-`>`
            sub["router"]["w"] = sub["router"]["w"] * 50.0   # tie
    if int4:
        params = quantize_params(params, 64, True, min_size=1 << 12)
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
    ops.reset_kernel_launches()
    og = ServeEngine(m_gpu, max_len=32).generate(prompts, 8)
    launches = ops.kernel_launches()
    expected = expected_launches(m_gpu, [prompts.shape], 8, prompts.shape[0])
    require(launches == expected, f"parity launches {launches} != expected "
            f"{expected}")
    require(np.array_equal(oc["tokens"], og["tokens"]),
            "ServeEngine tokens differ between cpu and cuda")
    require(oc["stats"].kv_saved_fraction == og["stats"].kv_saved_fraction,
            "kv_saved_fraction differs between cpu and cuda")
    gates = torch.cat([g.flatten() for g in gc])
    lock_margin = min(margins)

    # the paged path: teacher-forced paged decode steps, then the
    # continuous engine over the paged store, mixed prompt lengths
    ppr = [rng.integers(0, cfg.vocab_size, (n,)) for n in (9, 16, 5, 21)]
    pforced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 3)))
    margins.clear()
    routing.gate_from_logits = recording
    try:
        plc, pgc = _forced_paged(m_cpu, ppr[:2], pforced)
        rc, sc = _paged_engine(m_cpu, ppr, 6)
    finally:
        routing.gate_from_logits = orig
    require(min(margins) >= MIN_MARGIN,
            f"paged gate margin {min(margins)} < {MIN_MARGIN}")
    plg, pgg = _forced_paged(m_gpu, ppr[:2], pforced)
    for a, b in zip(pgc, pgg):
        require(torch.equal(a, b), "paged gate log differs (cpu/cuda)")
    pworst = 0.0
    for a, b in zip(plc, plg):
        d = (a - b).abs().max().item() / a.abs().max().item()
        pworst = max(pworst, d)
        require(d <= TOL_LOGITS, f"paged logits differ: {d} > {TOL_LOGITS}")
        require(torch.equal(a.argmax(-1), b.argmax(-1)),
                "paged greedy tokens differ between cpu and cuda")
    rg, sg = _paged_engine(m_gpu, ppr, 6)
    for a, b in zip(rc, rg):
        require(np.array_equal(a.tokens, b.tokens)
                and (a.kv_stored, a.kv_dense) == (b.kv_stored, b.kv_dense),
                "paged engine tokens or gate accounting differ (cpu/cuda)")
    for f in ("kv_entries_stored", "kv_entries_dense", "history_hit_rate",
              "history_hits_per_layer", "pages_peak", "attn_keep_frac"):
        require(getattr(sc, f) == getattr(sg, f),
                f"paged engine {f} differs between cpu and cuda")
    return {"phase": "parity_int4" if int4 else "parity", "config": cfg.name,
            "dtype": cfg.dtype, "int4_weights": int4,
            "gates_identical": True, "logits_max_rel_diff": worst,
            "tol": TOL_LOGITS, "greedy_tokens_identical": True,
            "serve_tokens_identical": True, "serve_launches": launches,
            "min_gate_margin": lock_margin,
            "gate_ones_frac": gates.mean().item(),
            "kv_saved_fraction": og["stats"].kv_saved_fraction,
            "paged_gates_identical": True,
            "paged_min_gate_margin": min(margins),
            "paged_logits_max_rel_diff": pworst,
            "paged_engine_tokens_identical": True,
            "paged_kv_entries_saved_fraction": sg.kv_entries_saved_fraction,
            "paged_history_hit_rate": sg.history_hit_rate}


# ---------------------------------------------------------------------------
# Phase 5: full-width llama2-7b served by the lock-step engine
# ---------------------------------------------------------------------------

def full_width_model(torch, dev):
    """llama2-7b at its published widths in bf16, seed-0 random weights,
    router biases zeroed so routing really skips."""
    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel
    cfg = get_config("llama2-7b")
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=dev)
    torch.cuda.synchronize(dev)
    return model, time.perf_counter() - t


def is_int4(model) -> bool:
    return "w_int" in model.params().get("lm_head", {})


def expected_launches(model, prefills, n_st: int, step_rows: int,
                      paged: bool = False):
    """Exact kernel launches of one prefill per entry of ``prefills`` (its
    tokens' shape (B, T), or (B, C, Tk) for a chunk of C tokens over a
    staging cache of Tk rows) and n_st decode steps of ``step_rows`` rows: one
    router_stats per forward (later blocks take Σy² from the epilogue), four
    fused linears per layer (the int4 kernel for int4 weights), the lm head
    through the int4 matmul for int4 weights (else a plain matmul), and
    one attention per layer: flash, or paged attention for a paged step.
    The dense fused linears also by route, as ``fl.plan`` picks it from a
    forward's rows and the dtype: bf16 prefills above SPLITKV_MAX_M rows on
    the tensor-core tile, decode steps (and prefills of at most that many
    rows) on the split-K stream, fp32 on the SIMT kernel.  Flash attention
    by route too, as ``fa.plan`` picks it from the packed rows G·T of one
    (batch, kv-head) and the dtype: bf16 prefills above SPLITKV_MAX_R rows
    on the tensor-core tile, decode steps (G rows) and shorter prefills on
    the split-KV walk, fp32 on the SIMT kernel.  The int4 fused linears
    and the lm head by route too, as ``fl.plan_int4`` picks it from a
    forward's rows (the lm head's: its batch): above INT4_STREAM_MAX_M on
    the tensor-core tile, else on the split-K stream.  Paged attention by
    route too, as ``pa.plan`` picks it from the dtype and G: bf16 on the
    split walk, fp32 on the SIMT kernel.  A Mamba stack: one
    router_stats per layer and forward (no block emits the Σy² carry), one
    SSD scan per layer and prefill (decode steps run the plain
    recurrence), nothing else; the scans by route too, as ``ss.plan``
    picks it from the prefill's shape and the dtype: bf16 on the
    tensor-core route, fp32 on the SIMT kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import layers, transformer
    cfg = model.cfg
    L, n_pf = cfg.num_layers, len(prefills)
    fwd = n_pf + n_st
    routes = {f"fused_linear_{r}": 0 for r in ("wgmma", "splitk", "simt")}
    routes.update({f"flash_attention_{r}": 0
                   for r in ("wgmma", "splitkv", "simt")})
    routes.update({f"{k}_{r}": 0 for k in ("fused_linear_int4", "int4_matmul")
                   for r in ("tc", "stream")})
    routes.update({f"paged_attention_{r}": 0 for r in ("split", "simt")})
    routes.update({f"ssd_scan_{r}": 0 for r in ("tc", "simt")})
    dt, D = layers.torch_dtype(cfg), cfg.d_model
    if transformer.is_ssm_stack(cfg):
        for b, t in prefills:          # exact-length prefills, no chunks
            routes["ssd_scan_" + ss.plan(
                b, t, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                cfg.ssm_groups, cfg.ssm_chunk, dt).route] += L
        return {"router_stats": L * fwd, "fused_linear": 0,
                "fused_linear_int4": 0, "int4_matmul": 0,
                "flash_attention": 0, "paged_attention": 0,
                "ssd_scan": L * n_pf, **routes}
    int4 = is_int4(model)
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    G = cfg.num_heads // Hkv
    forwards = [(e[0] * e[1], e[0], G * e[1], e[-1]) for e in prefills]
    forwards += [(step_rows, step_rows, G, MAX_LEN)] * n_st
    if int4:
        lm = model.params()["lm_head"]
        C = lm["scale"].shape[0]
        Kw, V = lm["w_int"].shape

        def int4_route(rows):
            return fl.plan_int4(rows, D, V, Kw // C, C, False, dt).route

    for i, (rows, b, R, Tk) in enumerate(forwards):
        if int4:
            routes["fused_linear_int4_" + int4_route(rows)] += 4 * L
            routes["int4_matmul_" + int4_route(b)] += 1
        else:
            routes["fused_linear_" + fl.plan(rows, D, D, False,
                                             dt).route] += 4 * L
        if i < n_pf or not paged:
            routes["flash_attention_" + fa.plan(b * Hkv, R, Tk, dh,
                                                dt).route] += L
        else:       # the route takes q's dtype and G alone
            routes["paged_attention_" + pa.plan(b, Hkv, G, dh, Tk, None,
                                                dt).route] += L
    return {"router_stats": fwd, "ssd_scan": 0,
            "fused_linear": 0 if int4 else 4 * L * fwd,
            "fused_linear_int4": 4 * L * fwd if int4 else 0,
            "int4_matmul": fwd if int4 else 0,
            "flash_attention": L * (n_pf if paged else fwd),
            "paged_attention": L * n_st if paged else 0, **routes}


def serve_full_width(torch, np, dev, model, init_s, phase="serve"):
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    cfg = model.cfg
    B, T0, new = 4, 512, 32
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T0))
    eng = ServeEngine(model, max_len=T0 + new)

    ops.reset_kernel_launches()
    out = eng.generate(prompts, new)
    launches = ops.kernel_launches()
    s = out["stats"]
    expected = expected_launches(model, [(B, T0)], new, B)
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
    return {"phase": phase, "config": cfg.name, "dtype": cfg.dtype,
            "batch": B, "prompt_len": T0, "new_tokens": new,
            "init_s": init_s, "prefill_s": s.prefill_s,
            "decode_s": s.decode_s, "decode_tok_per_s": s.decode_tok_per_s,
            "decode_only_tok_per_s": (s.decode_tokens - B) / s.decode_s,
            "decode_steps_per_s": new / s.decode_s,
            "attn_keep_frac": s.attn_keep_frac,
            "kv_saved_fraction": s.kv_saved_fraction,
            "kv_saved_analytic": s.kv_saved_analytic,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "launches": launches, "logits_finite": finite,
            "sample_tokens": out["tokens"][0, :8].tolist()}, launches, \
        out["tokens"]


# ---------------------------------------------------------------------------
# Phase 6: full-width llama2-7b served by the continuous-batching engine
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN, PAGE = 4, 544, 16


class FiniteLogits:
    """Wraps the engine's sampler so every logits tensor it samples from is
    checked finite on the device (no extra host sync)."""

    def __init__(self, torch, dev):
        from repro_torch.serve import engine
        self.torch, self.dev, self.engine = torch, dev, engine
        self.orig = engine.sample

    def __enter__(self):
        def checked(logits, generator=None, temperature=0.0):
            # in place: a CUDA graph of a decode iteration captures this
            # write, so every replay adds its logits to the same flag
            self.all &= self.torch.isfinite(logits).all()
            return self.orig(logits, generator, temperature)
        self.engine.sample = checked
        return self

    def __exit__(self, *exc):
        self.engine.sample = self.orig

    def reset(self):
        self.all = self.torch.ones((), dtype=self.torch.bool, device=self.dev)


def serve_continuous(torch, dev, model, finite, label, prompts, new,
                     log=None, trace=True, **kw):
    """One ContinuousBatchingEngine run (4 slots, max_len 544, page 16) with
    exact launch counts (each prefill and each prefill chunk by its shape),
    every request completed, finite logits and, paged,
    page conservation with no page in use at the end.  ``log`` (a dict)
    receives each request's prompt gate log [L, T0] and decode gate
    columns (``gates``: {uid: (prompt, [L] per step)}); ``trace=False`` leaves out a fused run's traced epoch
    (phase 12's fused runs: phase 11 traces the same decode iteration).
    With
    ``decode_steps``
    > 1 (fused epochs, CUDA graphs): the wrappers count the prefills' and
    the eager warm-up iterations' launches (exact, as in single-step runs),
    at most one capture for the dense pool and one per block-table width
    ``j_step`` can take for the paged store, every iteration past a
    capture's warm-up a replay, the capture deltas × replays (derived)
    equal to the replayed iterations' expected launches, on the dense pool
    no host sync in the deferred prefills, and after the run one more
    epoch of the run's last graph traced a replay at a time: each
    replay's port kernels, counted by name in its device trace, must
    equal its capture delta (``trace_epoch``).  Returns (record,
    per-request tokens, the wrappers' launches)."""
    from repro_torch.kernels import ops
    from repro_torch.kvcache import paged
    from repro_torch.models import layers, ssm, transformer
    from repro_torch.serve.engine import ContinuousBatchingEngine
    cfg, L = model.cfg, model.cfg.num_layers
    eng = ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                                   page_size=PAGE, **kw)
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    if eng.decode_steps > 1:
        # a preemption storm (the reference's youngest-other policy can
        # evict two residents in turn forever) fails here, not at the limit
        epochs, process = [0], eng._process_epoch

        def guarded(*a, **k):
            epochs[0] += 1
            require(epochs[0] <= 4 * new * len(prompts),
                    f"{label}: {epochs[0]} epochs, no end in sight")
            return process(*a, **k)

        eng._process_epoch = guarded
        launch_epoch, seen = eng._launch_epoch, {}

        def kept(rs, ep, n):               # the run's DecodeEpoch
            seen["ep"] = ep
            return launch_epoch(rs, ep, n)

        eng._launch_epoch = kept
        if eng.kv_mode == "dense":
            eng._prefill_work_dense = unsynced_prefill(
                torch, eng._prefill_work_dense, seen)
    if log is not None:
        watch_engine(eng, log)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    finite.reset()
    rows, prefill, chunk = [], model.prefill, model.prefill_chunk

    def recorded(toks, *a, **k):      # the shape of each prefill it runs
        rows.append(tuple(toks.shape))
        return prefill(toks, *a, **k)

    def recorded_chunk(cache, toks, *a, **k):   # (B, C, staging rows)
        rows.append(tuple(toks.shape) + (cache[0]["k"].shape[1],))
        return chunk(cache, toks, *a, **k)

    model.prefill, model.prefill_chunk = recorded, recorded_chunk
    ops.reset_kernel_launches()
    t = time.perf_counter()
    try:
        out = eng.run()
    finally:
        del model.prefill, model.prefill_chunk
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    launches = ops.kernel_launches()
    s = out["stats"]
    n_pf, n_st = s.prefill_chunks, s.decode_iterations
    require(len(rows) == n_pf, f"{label}: {len(rows)} prefills seen, "
            f"{n_pf} counted")
    paged_run = eng.kv_mode == "paged"
    graph_rec = {}
    if eng.decode_steps > 1:
        cap = (len(table_widths(eng.allocator.pages_per_slot))
               if paged_run else 1)
        require(1 <= s.compiles <= cap, f"{label}: {s.compiles} graphs "
                f"captured, want 1..{cap}")
        require(s.graph_replays == n_st - s.compiles,
                f"{label}: {s.graph_replays} replays of {n_st} iterations "
                f"and {s.compiles} captures (an iteration ran eagerly)")
        derived = seen["ep"].graph_launches()
        want = expected_launches(model, [], s.graph_replays, SLOTS,
                                 paged_run)
        require(derived == want, f"{label}: capture deltas × replays "
                f"{derived} != the replayed iterations' {want}")
        graph_rec = {"graph_launches_derived": derived}
        if eng.kv_mode == "dense":
            require(seen.get("deferred", 0) >= 1 and not seen["syncs"],
                    f"{label}: {seen.get('syncs')} host syncs in "
                    f"{seen.get('deferred')} deferred prefills")
            graph_rec.update(deferred_prefills=seen["deferred"],
                             deferred_prefill_syncs=seen["syncs"])
        n_eager = s.compiles          # each capture's eager warm-up
    else:
        require(s.compiles == s.graph_replays == 0 and n_st == s.
                decode_dispatches, f"{label}: single-step run captured")
        n_eager = n_st
    expected = expected_launches(model, rows, n_eager, SLOTS, paged_run)
    require(launches == expected, f"{label}: kernel launches "
            f"{launches} != expected {expected}")
    res = [out["results"][u] for u in uids]
    require(s.requests_completed == len(prompts) and all(
        r.finish_reason == "length" and r.decode_tokens == new
        for r in res), f"{label}: not every request completed")
    require(bool(finite.all.item()), f"{label}: non-finite logits")
    esize = torch.empty((), dtype=layers.torch_dtype(cfg)).element_size()
    if transformer.is_ssm_stack(cfg):       # conv histories + fp32 state
        dense_bytes = SLOTS * L * (
            (cfg.ssm_conv - 1) * ssm.conv_dim(cfg) * esize
            + cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4)
    else:
        dense_bytes = (SLOTS * MAX_LEN * L * 2 * cfg.num_kv_heads
                       * cfg.resolved_head_dim * esize)
    # decode_tokens counts each request's first token, which prefill made
    rec = {"run": label, "dtype": cfg.dtype, "requests": len(prompts),
           "prefill_s": s.prefill_s, "prefill_tokens": s.prefill_tokens,
           "prefills": n_pf, "prefill_chunk": eng.prefill_chunk,
           "step_tokens": eng.step_tokens,
           "prefill_aborts": s.prefill_aborts,
           "prefill_deferrals": s.prefill_deferrals,
           "interleaved_steps": s.interleaved_steps, "decode_steps": n_st,
           "decode_dispatches": s.decode_dispatches,
           "steps_per_dispatch": eng.decode_steps,
           "graphs_captured": s.compiles, "graph_replays": s.graph_replays,
           "epoch_shrinks": s.epoch_shrinks, "host_s": s.host_s,
           "device_s": s.device_s, "decode_s": s.decode_s,
           "decode_tok_per_s": s.decode_tok_per_s,
           "decode_only_tok_per_s": (s.decode_tokens - n_pf) / s.decode_s,
           "decode_steps_per_s": n_st / s.decode_s,
           "wall_s": wall, "attn_keep_frac": s.attn_keep_frac,
           "kv_saved_fraction": s.kv_saved_fraction,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "dense_pool_bytes": dense_bytes, "launches": launches,
           **graph_rec}
    if paged_run:
        alloc = eng.allocator
        alloc.check_conservation()
        require(alloc.free_pages == eng.num_pages
                and alloc.stats.pages_in_use == 0,
                f"{label}: pages in use at the end")
        require(0.0 < s.kv_entries_saved_fraction < 1.0,
                f"{label}: kv_entries_saved_fraction "
                f"{s.kv_entries_saved_fraction}")
        page_bytes = PAGE * paged.entry_bytes(cfg, kw.get("kv_dtype"))
        rec.update(pages_peak=s.pages_peak, pages_total=s.pages_total,
                   page_bytes=page_bytes,
                   peak_page_bytes=s.pages_peak * page_bytes,
                   peak_over_dense=s.pages_peak * page_bytes / dense_bytes,
                   kv_entries_saved_fraction=s.kv_entries_saved_fraction,
                   kv_entries_stored=s.kv_entries_stored,
                   kv_entries_dense=s.kv_entries_dense,
                   history_hit_rate=s.history_hit_rate,
                   history_hits_per_layer=s.history_hits_per_layer,
                   preemptions=s.preemptions)
    if eng.decode_steps > 1:
        if trace:
            rec["traced_epoch"] = trace_epoch(torch, dev, label, seen["ep"],
                                              eng.decode_steps)
    return rec, [r.tokens for r in res], launches


def watch_engine(eng, log):
    """Wrap ``eng`` so that ``log`` receives each request's prompt gate log
    [L, T0] and per decode step its gate column [L] (``gates``: {uid:
    [prompt, [columns]]})."""
    import numpy as np
    gates = log.setdefault("gates", {})
    account, advance = eng._account_prefill, eng._advance_slot

    def accounted(st):
        g = st.pf_gates
        if g is not None:
            g = g.float().cpu().numpy() if hasattr(g, "cpu") else g
            gates.setdefault(st.req.uid, [None, []])[0] = np.asarray(
                g, np.float32)[:, :st.req.prompt_len]
        return account(st)

    def advanced(rs, st, tok, g, *a):
        if g is not None:
            gates.setdefault(st.req.uid, [None, []])[1].append(
                np.asarray(g, np.float32).copy())
        return advance(rs, st, tok, g, *a)

    eng._account_prefill, eng._advance_slot = accounted, advanced


def token_agreement(np, a, b):
    """Share of equal tokens over requests, and per request the index of
    the first token that differs (len = none)."""
    eq = [x == y for x, y in zip(a, b)]
    return (float(np.concatenate(eq).mean()),
            [int(np.argmin(e)) if not e.all() else len(e) for e in eq])


def continuous_full_width(torch, np, dev, model):
    """8 requests (prompts of 128-512 tokens, seeded; 32 greedy tokens each)
    over 4 slots, max_len 544, in the dense pool, paged bf16 pages and
    paged int8 pages; then 4 short requests in paged bf16 pages twice, in
    the default pool and in one too small for all four residents, where
    preemption must leave every token unchanged."""
    from repro_torch.kvcache import paged
    cfg, new = model.cfg, 32
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 513, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    runs, tokens, total = [], {}, {}
    # the tight pool holds 10/7 of one request's worst case (every token
    # fresh at every layer); four residents at keep ≈ 0.5 need about twice
    # that (4 × (1 + 31 · 0.5) / 32 ≈ 2.06) before their 32 tokens are done
    short = [rng.integers(0, cfg.vocab_size, (16,)).astype(np.int32)
             for _ in range(4)]
    worst = -(-(16 + new - 1) * cfg.num_layers // PAGE)
    with FiniteLogits(torch, dev) as finite:
        for label, plist, kw in (
                ("dense", prompts, dict(kv_mode="dense")),
                ("paged_bf16", prompts, dict(kv_mode="paged")),
                ("paged_int8", prompts, dict(kv_mode="paged",
                                             kv_dtype="int8")),
                ("paged_int4", prompts, dict(kv_mode="paged",
                                             kv_dtype="int4")),
                ("short_paged_bf16", short, dict(kv_mode="paged")),
                ("short_paged_bf16_tight", short,
                 dict(kv_mode="paged", num_pages=worst * 10 // 7))):
            rec, toks, launches = serve_continuous(
                torch, dev, model, finite, label, plist, new, **kw)
            tokens[label] = toks
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            runs.append(rec)
    by = {r["run"]: r for r in runs}
    p0 = by["short_paged_bf16"]["preemptions"]
    p1 = by["short_paged_bf16_tight"]["preemptions"]
    require(p0 == 0 and p1 >= 1, f"preemptions {p0} (default pool), {p1} "
            "(tight pool): want 0 and >= 1")
    require(all(np.array_equal(a, b) for a, b in zip(
        tokens["short_paged_bf16"], tokens["short_paged_bf16_tight"])),
        "preemption changed the tokens of a request")
    # bf16 sums in another order flip near-tie gates and argmaxes of the
    # random model (phase 7 holds this against fp32): the share of equal
    # tokens and, per request, the first index that differs (32 = none)
    same, first = {}, {}
    for label in ("paged_bf16", "paged_int8", "paged_int4"):
        same[label], first[label] = token_agreement(
            np, tokens[label], tokens["dense"])
    return {"phase": "continuous", "config": cfg.name, "dtype": cfg.dtype,
            "slots": SLOTS, "max_len": MAX_LEN, "page_size": PAGE,
            "prompt_lens": lens.tolist(), "new_tokens": new, "runs": runs,
            "tokens_identical_to_dense": same,
            "first_divergence": first,
            "preempted_tokens_identical": True}, total, prompts, tokens, \
        (short, worst * 10 // 7)


# ---------------------------------------------------------------------------
# Phase 11: device-resident decode epochs (CUDA graphs of one iteration)
# ---------------------------------------------------------------------------

def table_widths(pages_per_slot: int) -> set:
    """The block-table widths the paged fused loop can load: power-of-two
    buckets of the live chain, clamped to pages_per_slot."""
    return {min(1 << k, pages_per_slot)
            for k in range(pages_per_slot.bit_length() + 1)}


def unsynced_prefill(torch, work, seen):
    """``ContinuousBatchingEngine._prefill_work_dense`` with its deferred
    calls (a fused dense run's prefills and prefill chunks: nothing read
    back, the first token left on the device) watched by
    ``torch.cuda.set_sync_debug_mode``: ``seen["syncs"]`` counts the host
    syncs they make, which would wait on the epoch in flight."""
    seen.setdefault("syncs", 0)

    def watched(rs, unit, pool, defer=False):
        if not defer:
            return work(rs, unit, pool)
        seen["deferred"] = seen.get("deferred", 0) + 1
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return work(rs, unit, pool, defer=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                seen["syncs"] += sum(
                    "called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)

    return watched


def trace_epoch(torch, dev, label, ep, n):
    """One more epoch of ``n`` replays of the run's last graph once the run
    is over (its times untouched; the slots are all finished, so nothing
    escapes), each replay in a torch.profiler session of its own: the
    port's kernels in a replay's device trace, counted by name, must equal
    the capture delta (``ops.DEVICE_KERNELS``), and no wrapper may launch.
    A trace can lose records: the first ones of a session (up to 228 of
    256 lead kernels of 1000 cycles; hence a lead of longer throwaway
    kernels) and, on a loaded host, a run of them in the middle of a long
    one (31 of an 8-replay epoch's 2312 port kernels, once).  A replay whose trace falls short of the delta and exceeds it
    nowhere is traced again, at most TRACE_ATTEMPTS times, and every short
    trace is reported; a count above the delta, or a replay short in
    every attempt, fails.  Returns the accepted traces' summed counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.profile_decode import _kernel_times
    require(ep.captured(), f"{label}: the run's last width has no graph")
    before, t = ops.kernel_launches(), time.perf_counter()
    total, short, lead_min = {}, [], TRACE_LEAD_KERNELS
    for i in range(n):
        for attempt in range(TRACE_ATTEMPTS):
            g0 = ep.graph_launches()
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_LEAD_KERNELS):
                    torch.cuda._sleep(TRACE_LEAD_CYCLES)
                ep.run(1)
                torch.cuda.synchronize(dev)
            replayed = {k: v - g0.get(k, 0)
                        for k, v in ep.graph_launches().items()}
            want = {k: v for k, v in ops.device_kernel_launches(
                replayed).items() if v}
            got, events, lead = {}, 0, 0
            for name, (_, cnt) in _kernel_times(prof).items():
                events += cnt
                lead += cnt if "spin_kernel" in name else 0
                kern = ops.device_kernel(name)
                if kern is not None:
                    got[kern] = got.get(kern, 0) + cnt
            if want and got == want:
                break
            over = [k for k in got if got[k] > want.get(k, 0)]
            if not want or over or attempt == TRACE_ATTEMPTS - 1:
                seq = sorted((e.time_range.start, e.name[:40])
                             for e in prof.events()
                             if e.device_type == DeviceType.CUDA)
                raise RuntimeError(
                    f"{label}: replay {i}'s traced kernels {got} != its "
                    f"capture delta {want} (attempt {attempt + 1} of "
                    f"{TRACE_ATTEMPTS}; {events} device kernels traced; "
                    f"first {seq[:4]}, last {seq[-4:]}; earlier short "
                    f"traces {short})")
            short.append({"replay": i, "traced": got, "events": events,
                          "lead_kernels_traced": lead})
        _add(total, got)
        lead_min = min(lead_min, lead)
    require(ops.kernel_launches() == before,
            f"{label}: a wrapper launched inside a replayed epoch")
    return {"replays": n, "device_kernels": total,
            "lead_kernels_traced_min": lead_min, "short_traces": short,
            "seconds": time.perf_counter() - t}


FUSED_STEPS = 8
TRACE_LEAD_KERNELS = 256   # trace_epoch's throwaway kernels a session
TRACE_LEAD_CYCLES = 10000  # the spin of each (~5 µs at 1.98 GHz)
TRACE_ATTEMPTS = 3         # trace_epoch's sessions a replay at most
FUSED_TEMPERATURE = 0.8


def serve_fused(torch, np, dev, model, specs):
    """Continuous runs at ``decode_steps`` FUSED_STEPS through
    ``serve_continuous`` (exact wrapper launches, captures bounded, no
    eager iteration past a warm-up, one replayed epoch traced against its
    capture delta, pages conserved, finite logits).  ``specs``: (label,
    prompts, the single-step run's tokens or None, engine kwargs).  Where tokens are given the fused run
    must equal them bit for bit (the same kernels on the same rows: a
    graph replays its launches); a run with ``num_pages`` must shrink an
    epoch; one at a temperature must give tokens in the vocabulary.
    Returns (records, the wrappers' launches)."""
    runs, total = [], {}
    vocab = model.cfg.vocab_size
    with FiniteLogits(torch, dev) as finite:
        for label, plist, want, kw in specs:
            rec, toks, launches = serve_continuous(
                torch, dev, model, finite, label, plist, 32,
                decode_steps=FUSED_STEPS, **kw)
            if want is not None:
                same = token_agreement(np, toks, want)
                require(same[0] == 1.0, f"{label}: fused tokens differ from "
                        f"the single-step run's (share equal, first "
                        f"divergence): {same}")
                rec["tokens_identical_to_single_step"] = True
            if "num_pages" in kw:
                require(rec["epoch_shrinks"] >= 1,
                        f"{label}: the tight pool shrank no epoch")
            if kw.get("temperature"):
                flat = np.concatenate(toks)
                require(bool(((flat >= 0) & (flat < vocab)).all()),
                        f"{label}: a sampled token outside the vocabulary")
                rec["temperature"] = kw["temperature"]
                rec["distinct_tokens"] = int(np.unique(flat).size)
            _add(total, launches)
            runs.append(rec)
    return runs, total


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v



# ---------------------------------------------------------------------------
# Phase 12: chunked (resumable) prefill
# ---------------------------------------------------------------------------

CHUNK = 128
CHUNK_CAP = -(-MAX_LEN // CHUNK) * CHUNK   # the staging cache's rows: 640
CHUNK_T0 = (0, 128, 384)   # chunk starts held on flash's tile
CHUNK_LAST = (512, 71)     # a final chunk: its start and its real columns
# (d)'s chunk 8: llama2-7b's G = 1 packs R = 8 rows, which take the split-KV
# walk, over a staging cache of 544 rows; the chunk starts (t0, real
# columns) held there, the last a right-padded final chunk
CHUNK_SPLIT = 8
CHUNK_SPLIT_CAP = -(-MAX_LEN // CHUNK_SPLIT) * CHUNK_SPLIT
CHUNK_SPLIT_T0 = ((0, 8), (8, 8), (536, 8), (528, 3))


def chunk_flash(torch, dev, timer, cfg, floor):
    """Flash attention at the chunk geometry: q of one request's C
    columns at positions t0..t0 + C - 1 over a staging cache with kv_len
    t0 + C.  C = 128 over 640 rows (the tensor-core tile) for each t0 of
    CHUNK_T0 and a final chunk (t0 512, kv_len 640 = the cache's rows, 71
    real columns); C = 8 over 544 rows (the split-KV walk, as (d)'s chunks
    take it) for each (t0, real) of CHUNK_SPLIT_T0.  Each in bf16 on its
    route and fp32 on the SIMT kernel against the plain version
    (``flash_call``: phase 3's tolerances, the mirror, a second launch bit
    for bit); a final chunk's real rows equal, bit for bit, a call on
    those rows alone (kv_len t0 + real: its pad columns are inert).  Timed
    beside the plain version and SDPA with a boolean mask of the same
    keys; bound: the bytes of q, out and keys [0, kv_len), and 4·dh
    operations per (row, valid key) pair."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as fa
    B, H, dh = 1, cfg.num_heads, cfg.resolved_head_dim
    Hkv = cfg.num_kv_heads
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(15)
    scale = 1.0 / math.sqrt(dh)
    k_all = torch.randn((B, CHUNK_CAP, Hkv, dh), generator=g,
                        device=dev).to(bf)
    v_all = torch.randn((B, CHUNK_CAP, Hkv, dh), generator=g,
                        device=dev).to(bf)
    cases = ([(CHUNK, CHUNK_CAP, t, CHUNK, "wgmma") for t in CHUNK_T0]
             + [(CHUNK, CHUNK_CAP) + CHUNK_LAST + ("wgmma",)]
             + [(CHUNK_SPLIT, CHUNK_SPLIT_CAP, t, real, "splitkv")
                for t, real in CHUNK_SPLIT_T0])
    out = []
    for C, cap, t0, real, want in cases:
        k, v = (x[:, :cap].contiguous() for x in (k_all, v_all))
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        keys = torch.arange(cap, device=dev)
        q = torch.randn((B, C, H, dh), generator=g, device=dev).to(bf)
        qpos = (t0 + torch.arange(C, dtype=torch.int32, device=dev))[None]
        kvl = torch.full((B,), t0 + C, dtype=torch.int32, device=dev)
        what = f"flash chunk C={C} t0={t0} kv_len={t0 + C}"
        errs = {}
        for dt in (bf, torch.float32):
            a = [t.to(dt) for t in (q, k, v)]
            errs[str(dt).split(".")[-1]] = flash_call(
                torch, *a, qpos, kvl, f"{what} {dt}", scale=scale)
        require(errs["bfloat16"]["route"] == want,
                f"{what}: route {errs['bfloat16']['route']}, want {want}")
        rec = {"shape": f"B={B} C={C} t0={t0} Tk={cap} "
                        f"kv_len={t0 + C} H={H} dh={dh}",
               "real_columns": real}
        if real < C:
            full = fa.flash_attention_cuda(q, k, v, qpos, kvl, scale=scale)
            alone = fa.flash_attention_cuda(
                q[:, :real], k, v, qpos[:, :real],
                torch.full((B,), t0 + real, dtype=torch.int32, device=dev),
                scale=scale)
            require(torch.equal(full[:, :real], alone),
                    f"{what}: the real rows differ from a call without the "
                    "pad columns")
            rec["real_rows_bit_identical_alone"] = True
        mask = ((keys[None, :] <= qpos[0, :, None])
                & (keys[None, :] < t0 + C))
        qt = q.transpose(1, 2)
        ms_k = timer(lambda: fa.flash_attention_cuda(q, k, v, qpos, kvl,
                                                     scale=scale))
        ms_p = timer(lambda: fa.flash_attention_plain(q, k, v, qpos, kvl,
                                                      scale=scale))
        ms_l = timer(lambda: Fn.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        pairs = B * H * (C * t0 + C * (C + 1) // 2)
        nbytes = (2 * B * C * H * dh + 2 * B * (t0 + C) * Hkv * dh) * 2
        b, by = bound_ms(nbytes, 4.0 * pairs * dh)
        rec.update(route=want, ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                   library="SDPA, boolean mask of the same keys",
                   bound_ms=b, bound_by=by, launch_floor_ms=floor,
                   errors=errs)
        out.append(rec)
    return out


def chunk_kernels(torch, dev, timer, cfg, floor):
    """(a) The kernels at one chunk's geometry: flash (``chunk_flash``),
    the dense fused linear's four linears at M = 128 (bf16 on the
    tensor-core tile, fp32 on the SIMT kernel, ``fused_linear_call``) and
    the router at T = 128 (``router_call``), each also timed beside its
    plain version (the linears beside ``torch.matmul``), with phase 3's
    bounds."""
    from repro_torch.kernels import fused_linear as fl
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    g = torch.Generator(device=dev).manual_seed(16)
    M = CHUNK
    linears = []
    for name, K, N, glu, pro, epi in linear_shapes(cfg):
        F = N // 2 if glu else N
        w = (torch.randn((K, N), generator=g, device=dev)
             / math.sqrt(K)).to(torch.bfloat16)
        x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
        what = f"fused_linear {name} M={M}"
        rec = fused_linear_call(torch, x, w, kw, f"{what} bf16")
        require(rec["route"] == "wgmma", f"{what}: route {rec['route']}")
        f32, _ = _cast(torch, kw, torch.float32)
        simt = fused_linear_call(torch, x.float(), w.float(), f32,
                                 f"{what} fp32")
        _, rkw = _cast(torch, kw, torch.bfloat16)
        b, by = bound_ms((M * K + K * N + M * F) * 2 + (
            (K * 2 + M * 4) if pro else 0) + (
            (M * F * 2 + M * 8) if epi else 0), 2.0 * M * K * N)
        linears.append({
            "shape": f"{name} M={M} K={K} N={N}", "route": rec["route"],
            "ms": timer(lambda: fl.fused_linear_cuda(x, w, **kw)),
            "plain_ms": timer(lambda: ref.fused_linear_ref(x, w, **rkw)),
            "library_ms": timer(lambda: torch.matmul(x, w)),
            "bound_ms": b, "bound_by": by,
            "errors": {"bfloat16": rec, "float32": simt}})
        del x, w, kw
    D = cfg.d_model
    w = torch.randn((D, 2), generator=g, device=dev) * 0.02
    x = torch.randn((M, D), generator=g, device=dev).to(torch.bfloat16)
    errs = {str(dt).split(".")[-1]: router_call(
        torch, x.to(dt), w, f"router T={M} {dt}")
        for dt in (torch.bfloat16, torch.float32)}
    b, by = bound_ms(M * D * 2 + D * 2 * 4 + M * 3 * 4, 6.0 * M * D)
    router = {"shape": f"x[{M},{D}] bf16",
              "plan": dataclasses.asdict(frr.plan(M, D, x.dtype,
                                                  x.data_ptr())),
              "ms": timer(lambda: frr.router_stats_cuda(x, w)),
              "plain_ms": timer(lambda: ref.router_stats_ref(x, w)),
              "bound_ms": b, "bound_by": by, "errors": errs}
    return {"launch_floor_ms": floor,
            "flash": chunk_flash(torch, dev, timer, cfg, floor),
            "fused_linear": linears, "router": router}


def check_chunk_run(model, rec, prompts):
    """A chunked run's own checks beside ``serve_continuous``'s: per chunk
    of 128 the plans give 1 router pass, 4·L fused linears on the tile
    (int4 weights: the s8 tile; the lm head's one row on the stream), L
    flash tiles and nothing on the decode routes (fp32: the SIMT kernels); ``prefill_chunks`` =
    Σ⌈T0/128⌉; prefills interleaved with resident decode steps; no abort
    and no preemption."""
    L = model.cfg.num_layers
    per = expected_launches(model, [(1, CHUNK, CHUNK_CAP)], 0, SLOTS)
    route = "simt" if model.cfg.dtype == "float32" else "wgmma"
    lin = ("fused_linear_int4_tc" if is_int4(model)
           else f"fused_linear_{route}")
    want = {"router_stats": 1, lin: 4 * L, f"flash_attention_{route}": L,
            "int4_matmul_stream": 1 if is_int4(model) else 0}
    moved = {k: v for k, v in per.items() if v and k not in (
        "fused_linear", "fused_linear_int4", "int4_matmul",
        "flash_attention")}
    want = {k: v for k, v in want.items() if v}
    require(moved == want, f"{rec['run']}: launches per chunk {moved}, "
            f"want {want}")
    n_chunks = sum(-(-len(p) // CHUNK) for p in prompts)
    require(rec["prefills"] == n_chunks, f"{rec['run']}: {rec['prefills']} "
            f"prefill chunks, want {n_chunks}")
    require(rec["interleaved_steps"] > 0,
            f"{rec['run']}: no chunk ran beside a resident")
    require(rec["prefill_aborts"] == 0 and rec.get("preemptions", 0) == 0,
            f"{rec['run']}: aborted or preempted in a roomy pool")
    rec["launches_per_chunk"] = moved


def chunked_full_width(torch, np, dev, model, prompts, tokens, short, tight):
    """(c) Phase 6's 8 requests at chunk 128 on its bf16 weights: the dense
    pool and bf16, int8 and int4 pages, then fused 8-step epochs (dense
    and paged bf16) under step_tokens 160 (3 residents × 8 + 128: no chunk
    deferred) and 136 (chunks deferred); each run's launches exact
    (``serve_continuous``) and checked per chunk (``check_chunk_run``),
    its share of tokens equal to the chunk-0 run reported, not checked.
    (d) Phase 6's 4 short requests in its tight paged pool at chunk 8:
    every request finishes and every page comes back; aborts and
    preemptions reported.  Returns (records, the wrappers' launches)."""
    runs, total = [], {}
    specs = [(f"chunk{CHUNK}_dense", "dense", dict(kv_mode="dense")),
             (f"chunk{CHUNK}_paged_bf16", "paged_bf16",
              dict(kv_mode="paged")),
             (f"chunk{CHUNK}_paged_int8", "paged_int8",
              dict(kv_mode="paged", kv_dtype="int8")),
             (f"chunk{CHUNK}_paged_int4", "paged_int4",
              dict(kv_mode="paged", kv_dtype="int4"))]
    for budget in SLOTS * FUSED_STEPS + CHUNK, 136:
        specs += [(f"chunk{CHUNK}_fused_dense_st{budget}", "dense",
                   dict(kv_mode="dense", step_tokens=budget)),
                  (f"chunk{CHUNK}_fused_paged_bf16_st{budget}", "paged_bf16",
                   dict(kv_mode="paged", step_tokens=budget))]
    with FiniteLogits(torch, dev) as finite:
        for label, ref_label, kw in specs:
            if "fused" in label:
                kw = dict(kw, decode_steps=FUSED_STEPS)
            rec, toks, launches = serve_continuous(
                torch, dev, model, finite, label, prompts, 32, trace=False,
                prefill_chunk=CHUNK, **kw)
            check_chunk_run(model, rec, prompts)
            if "step_tokens" in kw:
                roomy = kw["step_tokens"] >= ((SLOTS - 1) * FUSED_STEPS
                                              + CHUNK)
                require((rec["prefill_deferrals"] == 0) == roomy,
                        f"{label}: {rec['prefill_deferrals']} deferrals")
            rec["tokens_equal_to_chunk0"] = token_agreement(
                np, toks, tokens[ref_label])
            _add(total, launches)
            runs.append(rec)
        rec, toks, launches = serve_continuous(
            torch, dev, model, finite,
            f"chunk{CHUNK_SPLIT}_short_paged_bf16_tight", short, 32,
            kv_mode="paged", num_pages=tight, prefill_chunk=CHUNK_SPLIT)
        rec["tokens_equal_to_chunk0"] = token_agreement(
            np, toks, tokens["short_paged_bf16"])
        _add(total, launches)
    return runs, rec, total


def chunk_witness(torch, np, dev, m32, reqs, new, tokens, logs):
    """(b) The fp32 witness: phase 7's 4 requests on its fp32 weights at
    chunk 128, in the dense pool and in fp32 pages, against phase 7's
    chunk-0 runs: tokens bit for bit, each request's prompt gate log and
    decode gate columns identical, the same KV accounting (per request
    and, paged, the store's entries stored and dense, history hit rates).
    Returns (records, the wrappers' launches, seconds)."""
    runs, total, t = [], {}, time.perf_counter()
    with FiniteLogits(torch, dev) as finite:
        for label in ("fp32_dense", "fp32_paged"):
            log = {}
            rec, toks, launches = serve_continuous(
                torch, dev, m32, finite, f"chunk{CHUNK}_{label}", reqs, new,
                log=log, kv_mode=label.split("_")[1], prefill_chunk=CHUNK)
            check_chunk_run(m32, rec, reqs)
            require(all(np.array_equal(a, b) for a, b in zip(
                toks, tokens[label])), f"{label}: chunk {CHUNK} tokens "
                "differ from chunk 0")
            ref = logs[label]
            for uid, (pg, cols) in ref["log"]["gates"].items():
                pg2, cols2 = log["gates"][uid]
                require(np.array_equal(pg, pg2) and len(cols) == len(cols2)
                        and all(np.array_equal(a, b)
                                for a, b in zip(cols, cols2)),
                        f"{label}: request {uid}'s gate log differs at "
                        f"chunk {CHUNK}")
            keys = ["kv_saved_fraction", "attn_keep_frac"] + (
                ["kv_entries_stored", "kv_entries_dense", "history_hit_rate",
                 "history_hits_per_layer", "kv_entries_saved_fraction"]
                if label == "fp32_paged" else [])
            diff = {k: (ref["rec"][k], rec[k]) for k in keys
                    if ref["rec"][k] != rec[k]}
            require(not diff, f"{label}: KV accounting differs at chunk "
                    f"{CHUNK}: {diff}")
            rec.update(tokens_identical_to_chunk0=True,
                       gate_logs_identical_to_chunk0=True,
                       kv_accounting_identical_to_chunk0=keys)
            _add(total, launches)
            runs.append(rec)
    return runs, total, time.perf_counter() - t


# ---------------------------------------------------------------------------
# Phase 7: the bf16 divergence of paged from dense, held against fp32
# ---------------------------------------------------------------------------

def _upcast(torch, tree):
    if isinstance(tree, dict):
        return {k: _upcast(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_upcast(torch, v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _forced_distance(torch, ref, other):
    """Teacher-forced run ``other`` against ``ref`` (both as _forced_run
    returns them): the share of gate decisions that differ (prefill, decode
    steps), the largest logits difference over max|ref|, and the share of
    equal argmaxes."""
    (rl, rg), (ol, og) = ref, other
    rel = max((a - b).abs().max().item() / a.abs().max().item()
              for a, b in zip(rl, ol))
    agree = sum((a.argmax(-1) == b.argmax(-1)).sum().item()
                for a, b in zip(rl, ol)) / sum(a.shape[0] for a in rl)
    dec = (torch.cat([g.flatten() for g in rg[1:]])
           != torch.cat([g.flatten() for g in og[1:]])).float().mean().item()
    pf = (rg[0] != og[0]).float().mean().item()
    return {"gate_mismatch_prefill": pf, "gate_mismatch_decode": dec,
            "logits_max_rel_diff": rel, "argmax_agree": agree}


def _forced_paged_aligned(model, prompts, forced):
    """_forced_paged at full width with its prefill outputs stacked as
    _forced_run returns them (equal prompt lengths)."""
    import torch
    S, T, steps = len(prompts), len(prompts[0]), forced.shape[1]
    per_slot = -(-(T + steps + 1) * model.cfg.num_layers // PAGE)
    logits, gates = _forced_paged(model, prompts, forced, ps=PAGE,
                                  num_pages=S * per_slot,
                                  cap_tokens=T + steps + 1)
    return ([torch.cat(logits[:S])] + logits[S:],
            [torch.stack(gates[:S], 1)] + gates[S:])


def witness(torch, np, dev, model, prompts, bf16_tokens):
    """The same weights in fp32 (the bf16 weights upcast, so only the
    arithmetic differs): the continuous engine in the dense pool and in
    fp32 pages on the first 4 phase-6 requests must give identical tokens
    (and, at chunk 128, phase 12's ``chunk_witness`` on the same copy);
    teacher-forced decode steps (2 prompts × 256 tokens, 16 forced tokens)
    of the dense and the paged path in fp32 must give identical gates and
    logits within 1e-4·max; and the bf16 paged path may flip at most twice
    (+ 1 %) as many decode gates against fp32 as the bf16 dense path does."""
    from repro_torch.core import routing
    from repro_torch.models.model import LanguageModel
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    m32 = LanguageModel(cfg32, _upcast(torch, model.params()), device=dev)
    new, reqs = 32, prompts[:SLOTS]
    runs, tokens, logs = [], {}, {}
    with FiniteLogits(torch, dev) as finite:
        for label, kw in (("fp32_dense", dict(kv_mode="dense")),
                          ("fp32_paged", dict(kv_mode="paged"))):
            log = {}
            rec, toks, launches = serve_continuous(torch, dev, m32, finite,
                                                   label, reqs, new, log=log,
                                                   **kw)
            runs.append(rec)
            tokens[label] = toks
            logs[label] = {"rec": rec, "log": log}
    require(all(np.array_equal(a, b) for a, b in zip(
        tokens["fp32_dense"], tokens["fp32_paged"])),
        "fp32 paged tokens differ from fp32 dense at full width")
    agree = {run: token_agreement(np, bf16_tokens[run][:SLOTS],
                                  tokens["fp32_dense"])
             for run in ("dense", "paged_bf16", "paged_int8", "paged_int4")}

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (2, 256)),
                           device=dev)
    forced = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (2, 16)),
                             device=dev)
    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append((logits[..., 1] - logits[..., 0]).abs().min().item())
        return orig(logits)

    routing.gate_from_logits = recording
    try:
        ref = _forced_run(m32, toks, forced)
    finally:
        routing.gate_from_logits = orig
    dist = {"fp32_paged": _forced_distance(
        torch, ref, _forced_paged_aligned(m32, list(toks), forced))}
    chunk = chunk_witness(torch, np, dev, m32, reqs, new, tokens, logs)
    del m32
    torch.cuda.empty_cache()
    dist["bf16_dense"] = _forced_distance(
        torch, ref, _forced_run(model, toks, forced))
    dist["bf16_paged"] = _forced_distance(
        torch, ref, _forced_paged_aligned(model, list(toks), forced))
    fp = dist["fp32_paged"]
    require(fp["gate_mismatch_prefill"] == 0.0
            and fp["gate_mismatch_decode"] == 0.0,
            f"fp32 paged gates differ from fp32 dense: {fp}")
    require(fp["logits_max_rel_diff"] <= TOL_LOGITS and fp["argmax_agree"]
            == 1.0, f"fp32 paged logits differ from fp32 dense: {fp}")
    # a paged-only fault at bf16 (a wrong row, scale or cast) would flip
    # far more gates than bf16 rounding does on the dense path
    bd, bp = dist["bf16_dense"], dist["bf16_paged"]
    require(bp["gate_mismatch_decode"]
            <= 2 * bd["gate_mismatch_decode"] + 0.01,
            f"bf16 paged stands farther from fp32 than bf16 dense: {dist}")
    return {"phase": "witness", "config": cfg32.name, "requests": len(reqs),
            "new_tokens": new, "runs": runs,
            "fp32_paged_tokens_identical_to_fp32_dense": True,
            "phase6_tokens_vs_fp32_dense": agree,
            "forced": {"prompts": 2, "prompt_len": 256, "steps": 16,
                       "min_gate_margin_fp32": min(margins),
                       "vs_fp32_dense": dist}}, launches, chunk


# ---------------------------------------------------------------------------
# Phase 8: full-width llama2-7b with int4-BFP weights
# ---------------------------------------------------------------------------

def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def serve_int4(torch, np, dev, model, lock_tokens, cont_tokens, prompts):
    """The phase-5 bf16 weights quantized on the card by the port's
    ``quantize_params`` at llama2-7b's QuantConfig (group 128, pow2 scales:
    every linear of all 32 layers and the lm head), served lock-step (batch
    4 × 512 + 32) and by the continuous engine (the phase-6 requests) in
    the dense pool and in paged bf16 pages, with exact launch counts and
    finite logits.  The share of tokens equal to the bf16 runs is reported
    only: random weights make it no check."""
    from repro_torch.models.model import LanguageModel
    from repro_torch.quant import quantize_params
    cfg, L = model.cfg, model.cfg.num_layers
    t = time.perf_counter()
    m4 = LanguageModel(cfg, quantize_params(
        model.params(), cfg.quant.group_size, cfg.quant.pow2_scales),
        device=dev)
    torch.cuda.synchronize(dev)
    quant_s = time.perf_counter() - t
    p4 = m4.params()
    n_int4 = sum("w_int" in sub["inner"][lin] for blk in p4["blocks"]
                 for sub in blk.values() for lin in sub["inner"])
    require(n_int4 == 4 * L and is_int4(m4),
            f"{n_int4} int4 linears of {4 * L}, lm head int4: {is_int4(m4)}")
    lock, launches, toks = serve_full_width(torch, np, dev, m4, quant_s,
                                            phase="int4_serve")
    total = dict(launches)
    same = {"lock_step": token_agreement(np, list(toks), list(lock_tokens))}
    runs, int4_tokens = [lock], {}
    with FiniteLogits(torch, dev) as finite:
        for label, ref_label, kw in (
                ("int4_dense", "dense", dict(kv_mode="dense")),
                ("int4_paged_bf16", "paged_bf16", dict(kv_mode="paged"))):
            rec, toks, launches = serve_continuous(
                torch, dev, m4, finite, label, prompts, 32, **kw)
            runs.append(rec)
            same[label] = token_agreement(np, toks, cont_tokens[ref_label])
            int4_tokens[label] = toks
            for k, v in launches.items():
                total[k] += v
    fused, fused_launches = serve_fused(torch, np, dev, m4, [
        ("fused_int4_dense", prompts, int4_tokens["int4_dense"],
         dict(kv_mode="dense"))])
    with FiniteLogits(torch, dev) as finite:   # phase 12: int4 at chunk 128
        crec, ctoks, claunch = serve_continuous(
            torch, dev, m4, finite, f"chunk{CHUNK}_int4_dense", prompts, 32,
            kv_mode="dense", prefill_chunk=CHUNK)
    check_chunk_run(m4, crec, prompts)
    crec["tokens_equal_to_chunk0"] = token_agreement(
        np, ctoks, int4_tokens["int4_dense"])
    rec = {"phase": "int4", "config": cfg.name, "dtype": cfg.dtype,
           "group_size": cfg.quant.group_size,
           "pow2_scales": cfg.quant.pow2_scales, "int4_linears": n_int4,
           "lm_head_int4": True, "quantize_s": quant_s,
           "weight_bytes": _tree_bytes(p4),
           "bf16_weight_bytes": _tree_bytes(model.params()),
           "runs": runs, "tokens_equal_to_bf16": same}
    del m4, p4
    torch.cuda.empty_cache()
    return rec, total, (fused, fused_launches), (crec, claunch)


# ---------------------------------------------------------------------------
# Phase 9: CPU (plain versions) ≡ CUDA (kernels) on mamba2-2.7b smoke, fp32
# ---------------------------------------------------------------------------

def _mamba_forced(model, toks, forced):
    """Prefill + teacher-forced decode steps: per forward the logits, the
    SSM gate log [L, B(, T)] and the keep statistics (Σ keep, n_routed)."""
    T = toks.shape[1]
    lg, cache, st = model.prefill(toks)
    out = [(lg.float().cpu(), st["ssm_gate"].cpu(),
            st["keep_frac_sum"].item(), st["n_routed"].item())]
    for s in range(forced.shape[1]):
        lg, cache, st = model.decode_step(cache, forced[:, s:s + 1], T + s)
        out.append((lg.float().cpu(), st["ssm_gate"].cpu(),
                    st["keep_frac_sum"].item(), st["n_routed"].item()))
    return out


def _mamba_engines(model, prompts, cont_prompts, new):
    """Lock-step tokens and stats, then the continuous engine over the
    dense pool (2 slots, so slots are reused) with mixed prompt lengths."""
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    lock = ServeEngine(model, max_len=prompts.shape[1] + new).generate(
        prompts, new)
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48)
    uids = [eng.submit(p, max_new_tokens=new) for p in cont_prompts]
    out = eng.run()
    return lock, [out["results"][u].tokens for u in uids], out["stats"]


def _mamba_cpu(torch, np, cfg, seed):
    """The smoke model from ``seed`` (routers at unit scale, zero bias) and
    its inputs, run on the cpu with every router margin recorded.  Returns
    (params, inputs, cpu results, smallest margin)."""
    from repro_torch.core import routing
    from repro_torch.kernels import ops
    from repro_torch.models.model import LanguageModel, init_params
    params = routing.neutral_router_bias(
        init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))
    for blk in params["blocks"]:            # routers at unit scale: no gate
        r = blk["mixer"]["router"]          # near the strict-`>` tie
        r["w"] = r["w"] * 50.0
    rng = np.random.default_rng(seed)
    inputs = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 21))),
              torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 4))),
              rng.integers(0, cfg.vocab_size, (2, 19)),
              [rng.integers(0, cfg.vocab_size, (n,)) for n in (9, 16, 5, 21)])
    m_cpu = LanguageModel(cfg, params, device="cpu")
    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append((logits[..., 1] - logits[..., 0]).abs().min().item())
        return orig(logits)

    routing.gate_from_logits = recording
    try:
        res = (_mamba_forced(m_cpu, *inputs[:2]),
               _mamba_engines(m_cpu, inputs[2], inputs[3], 8))
    finally:
        routing.gate_from_logits = orig
    return params, inputs, res, min(margins)


def parity_mamba(torch, np, dev):
    """CPU ≡ CUDA on the fp32 mamba2-2.7b smoke model (2 layers, chunk 8,
    so the prompts span several chunks and the last one is ragged), with
    exact launch counts of the cuda runs (every SSD scan on the SIMT
    kernel).  Returns (record, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import LanguageModel
    cfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(),
                              dtype="float32")
    tried = {}
    for seed in range(MAMBA_SEEDS):
        params, inputs, (fc, (lc, cc, sc)), margin = _mamba_cpu(
            torch, np, cfg, seed)
        tried[seed] = margin
        if margin >= MIN_MARGIN:
            break
    require(margin >= MIN_MARGIN, f"mamba gate margins {tried} all below "
            f"{MIN_MARGIN}")
    toks, forced, prompts, cont = inputs
    m_gpu = LanguageModel(cfg, params, device=dev)
    rows, steps, prefill, decode = [], [], m_gpu.prefill, m_gpu.decode_step

    def recorded(toks, *a, **k):      # the shape of each prefill it runs
        rows.append(tuple(toks.shape))
        return prefill(toks, *a, **k)

    def stepped(*a, **k):
        steps.append(1)
        return decode(*a, **k)

    m_gpu.prefill, m_gpu.decode_step = recorded, stepped
    ops.reset_kernel_launches()
    fg = _mamba_forced(m_gpu, toks, forced)
    worst = keep_diff = 0.0
    for (la, ga, ka, na), (lb, gb, kb, nb) in zip(fc, fg):
        require(torch.equal(ga, gb), "mamba gate log differs (cpu/cuda)")
        d = (la - lb).abs().max().item() / la.abs().max().item()
        worst = max(worst, d)
        require(d <= TOL_LOGITS, f"mamba logits differ: {d} > {TOL_LOGITS}")
        require(torch.equal(la.argmax(-1), lb.argmax(-1)),
                "mamba greedy tokens differ between cpu and cuda")
        keep_diff = max(keep_diff, abs(ka - kb))
        require(abs(ka - kb) <= TOL_KEEP and na == nb,
                f"mamba keep statistics differ: {ka} vs {kb}, {na} vs {nb}")
    lg, cg, sg = _mamba_engines(m_gpu, prompts, cont, 8)
    torch.cuda.synchronize(dev)
    launches = ops.kernel_launches()
    del m_gpu.prefill, m_gpu.decode_step
    expected = expected_launches(m_gpu, rows, len(steps), 0)
    require(launches == expected and launches["ssd_scan_tc"] == 0,
            f"mamba parity launches {launches} != expected {expected}")
    require(np.array_equal(lc["tokens"], lg["tokens"]),
            "mamba ServeEngine tokens differ between cpu and cuda")
    lk = abs(lc["stats"].attn_keep_frac - lg["stats"].attn_keep_frac)
    require(lk <= TOL_KEEP, f"mamba lock-step keep fraction differs: {lk}")
    require(all(np.array_equal(a, b) for a, b in zip(cc, cg)),
            "mamba continuous tokens differ between cpu and cuda")
    for f in ("prefill_tokens", "decode_tokens", "decode_dispatches",
              "prefill_chunks", "requests_completed"):
        require(getattr(sc, f) == getattr(sg, f),
                f"mamba continuous {f} differs between cpu and cuda")
    require(abs(sc.attn_keep_frac - sg.attn_keep_frac) <= TOL_KEEP,
            "mamba continuous keep fraction differs between cpu and cuda")
    gates = torch.cat([f[1].flatten() for f in fc])
    return {"phase": "parity_mamba", "config": cfg.name, "dtype": cfg.dtype,
            "seed": seed, "margins_tried": tried, "gates_identical": True,
            "gate_decisions": gates.numel(),
            "gate_ones_frac": gates.mean().item(),
            "decode_keep_frac": [f[2] / f[3] for f in fc[1:]],
            "min_gate_margin": margin, "margin_floor": MIN_MARGIN,
            "logits_max_rel_diff": worst, "tol": TOL_LOGITS,
            "keep_stats_max_abs_diff": max(keep_diff, lk),
            "keep_tol": TOL_KEEP, "greedy_tokens_identical": True,
            "serve_tokens_identical": True,
            "continuous_tokens_identical": True,
            "serve_keep_frac": lg["stats"].attn_keep_frac,
            "prefills": len(rows), "decode_steps": len(steps),
            "launches": launches}, launches


# ---------------------------------------------------------------------------
# Phase 10: full-width mamba2-2.7b, lock-step and continuous (dense pool)
# ---------------------------------------------------------------------------

def serve_mamba(torch, np, dev):
    """mamba2-2.7b at its published widths in bf16, seed-0 random weights,
    router biases zeroed: lock-step batch 4 × 512 + 32 and the continuous
    engine on 8 requests of 114-512 prompt tokens + 32 over 4 slots, with
    exact launch counts; a paged mamba engine must raise."""
    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel
    from repro_torch.serve.engine import ContinuousBatchingEngine
    cfg = get_config("mamba2-2.7b")
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    lock, launches, _ = serve_full_width(torch, np, dev, model, init_s,
                                         phase="mamba_serve")
    total = dict(launches)
    rng = np.random.default_rng(0)
    lens = rng.integers(114, 513, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    with FiniteLogits(torch, dev) as finite:
        cont, cont_tokens, launches = serve_continuous(
            torch, dev, model, finite, "mamba_dense", prompts, 32,
            kv_mode="dense")
    for k, v in launches.items():
        total[k] += v
    fused = serve_fused(torch, np, dev, model, [
        ("fused_mamba_dense", prompts, cont_tokens, dict(kv_mode="dense"))])
    try:
        ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                                 kv_mode="paged")
        paged_raises = False
    except ValueError:
        paged_raises = True
    require(paged_raises, "a paged mamba engine did not raise")
    from repro_torch.serve.errors import ConfigError
    try:                                   # phase 12 (e)
        ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                                 prefill_chunk=CHUNK)
        chunk_raises = False
    except ConfigError:
        chunk_raises = True
    require(chunk_raises, "a chunked mamba engine did not raise")
    p = model.params()
    rec = {"phase": "mamba", "config": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "weight_bytes": _tree_bytes(p),
           "params": sum(t.numel() for t in model.parameters()),
           "prompt_lens": lens.tolist(), "runs": [lock, cont],
           "paged_raises": True, "chunked_raises": True}
    del model, p
    torch.cuda.empty_cache()
    return rec, total, fused


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
    floor = launch_floor_ms(torch, timer)
    dense = check_fused_linear(torch, dev, timer, cfg)
    flash = check_flash(torch, dev, timer, cfg)
    int4_lin = check_fused_linear_int4(torch, dev, timer, cfg)
    lm_head = check_int4_matmul(torch, dev, timer, cfg)
    paged = check_paged(torch, np, dev, timer, cfg)
    mamba_cfg = get_config("mamba2-2.7b")
    ssd = check_ssd(torch, dev, timer, mamba_cfg)
    router = check_router(torch, dev, timer, (cfg, mamba_cfg), floor)
    per_kernel = {
        "router_stats": router,
        "fused_linear_wgmma": dense["wgmma"],
        "fused_linear_splitk": dense["splitk"],
        "fused_linear_int4_tc": int4_lin["tc"],
        "fused_linear_int4_stream": int4_lin["stream"],
        "int4_matmul_stream": lm_head["stream"],
        "flash_attention_wgmma": flash["wgmma"],
        "flash_attention_splitkv": flash["splitkv"],
        "paged_attention_split": paged["split"],
        "paged_attention_simt": paged["simt"],
        "ssd_scan_tc": ssd["tc"], "ssd_scan_simt": ssd["simt"]}
    # the lm head's tile (M 2048) is off the main path: recorded, not listed
    emit({"phase": "kernels", "launch_floor_ms": floor,
          "shapes": per_kernel, "int4_matmul_tc": lm_head["tc"]})
    emit(check_ragged(torch, dev))

    emit(parity(torch, np, dev))
    emit(parity(torch, np, dev, int4=True))
    model, init_s = full_width_model(torch, dev)
    serve, launches, lock_tokens = serve_full_width(torch, np, dev, model,
                                                    init_s)
    emit(serve)
    cont, cont_launches, prompts, tokens, (short, tight) = \
        continuous_full_width(torch, np, dev, model)
    emit(cont)
    for k, v in cont_launches.items():
        launches[k] += v
    fused_runs, fused_launches = serve_fused(torch, np, dev, model, [
        ("fused_dense", prompts, tokens["dense"], dict(kv_mode="dense")),
        ("fused_paged_bf16", prompts, tokens["paged_bf16"],
         dict(kv_mode="paged")),
        ("fused_paged_int8", prompts, tokens["paged_int8"],
         dict(kv_mode="paged", kv_dtype="int8")),
        ("fused_short_paged_bf16_tight", short, None,
         dict(kv_mode="paged", num_pages=tight)),
        ("fused_dense_temperature", prompts[:4], None,
         dict(kv_mode="dense", temperature=FUSED_TEMPERATURE))])
    t12 = time.perf_counter()          # phase 12 on the bf16 weights
    chunk_k = chunk_kernels(torch, dev, timer, cfg, floor)
    chunk_runs, chunk_tight, chunk_launches = chunked_full_width(
        torch, np, dev, model, prompts, tokens, short, tight)
    chunk_s = time.perf_counter() - t12
    wit, wit_launches, (wit_chunk, more, wit_chunk_s) = witness(
        torch, np, dev, model, prompts, tokens)
    emit(wit)            # its fp32 paged run: the paged SIMT route's launches
    launches["paged_attention_simt"] += wit_launches["paged_attention_simt"]
    _add(chunk_launches, more)
    int4, int4_launches, (runs, more), (int4_chunk, int4_chunk_launches) = \
        serve_int4(torch, np, dev, model, lock_tokens, tokens, prompts)
    emit(int4)
    for k, v in int4_launches.items():
        launches[k] += v
    fused_runs += runs
    _add(fused_launches, more)
    _add(chunk_launches, int4_chunk_launches)
    chunk_runs.append(int4_chunk)
    del model
    torch.cuda.empty_cache()

    par, par_launches = parity_mamba(torch, np, dev)
    emit(par)            # fp32: the SSD scan's SIMT route's launches
    launches["ssd_scan_simt"] += par_launches["ssd_scan_simt"]
    mamba, mamba_launches, (runs, more) = serve_mamba(torch, np, dev)
    emit(mamba)
    for k, v in mamba_launches.items():
        launches[k] += v
    fused_runs += runs
    _add(fused_launches, more)
    derived, traced = {}, {}
    for r in fused_runs:
        _add(derived, r["graph_launches_derived"])
        _add(traced, r["traced_epoch"]["device_kernels"])
    emit({"phase": "fused", "steps_per_dispatch": FUSED_STEPS,
          "graphs_captured": sum(r["graphs_captured"] for r in fused_runs),
          "runs": fused_runs, "launches": fused_launches,
          "graph_launches_derived": derived,
          "traced_epochs_device_kernels": traced,
          "short_traces": sum(len(r["traced_epoch"]["short_traces"])
                              for r in fused_runs),
          "trace_seconds": sum(r["traced_epoch"]["seconds"]
                               for r in fused_runs)})
    _add(launches, fused_launches)
    emit({"phase": "chunked", "chunk": CHUNK, "staging_rows": CHUNK_CAP,
          "split_chunk": CHUNK_SPLIT, "split_staging_rows": CHUNK_SPLIT_CAP,
          "seconds": chunk_s + wit_chunk_s + int4_chunk["wall_s"],
          "kernels": chunk_k, "witness_fp32": wit_chunk, "runs": chunk_runs,
          "pressure": chunk_tight, "mamba_chunked_raises": True,
          "launches": chunk_launches})
    _add(launches, chunk_launches)
    require(all(launches[k] > 0 for k in TPU_KERNELS),
            f"a kernel of the path never launched: {launches}")

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
