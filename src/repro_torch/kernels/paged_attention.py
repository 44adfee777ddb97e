"""Paged decode attention over the §4.4 store-once entry stream.

Kernel: ``csrc/paged_attention.cu`` (CUDA C++, sm_90a), the port of the TPU
kernel ``paged_attention_packed`` in the JAX package's
``kernels/paged_attention.py`` together with the fold of the in-flight
token in its ``ops.paged_decode_attention``.  The TPU kernel walks every
page of a slot's chain at every layer and masks entry by entry; the kernels
read the slot's ``eff_pos`` row and load K/V only for the entries it
admits.  Two routes, which ``plan`` picks by q's dtype and G = Hq / Hkv
alone: bf16 q with G <= ``SPLIT_MAX_G`` takes the cluster split walk
(``"split"``: one scan per cluster shared by a group of kv-heads, the
admitted entries split evenly over its blocks, mma.sync over a cp.async
ring, the blocks' partials added through distributed shared memory; the
main path's decode, bf16, int8 and int4 pages alike), fp32 q or a larger G
the SIMT kernel (``"simt"``, the parity route).  See the source for the
designs and the bound.  The output is the folded, normalized attention, as
the reference's ``ops`` function returns.  The plain version is
``ref.paged_attention_ref`` (a dense gather of the chain, the whole pool
dequantized first).

``paged_attention`` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; any other device, or a failed build or
launch, raises.  ``launches`` counts calls, ``launches_split`` and
``launches_simt`` the route each took.  The kernels allocate nothing and
keep no state between calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

launches = 0
launches_split = 0
launches_simt = 0
_FNS = {}
_HEAD_DIMS = (32, 64, 128)
_PAYLOAD = {None: 0, "int8": 1, "int4": 2}
_ROUTES = {"simt": 0, "split": 1}

# What csrc/paged_attention.cu instantiates.  plan() chooses among it; the
# C entries refuse any other plan.
SPLIT_MAX_G = 16         # bf16 q with at most this many query heads per
#                          kv-head takes the split walk (its mma rows)
SPLIT_WARPS = 4          # warps of a split block
SPLIT_SUB = 16           # entries one warp takes of a step, for one head
SPLIT_MAX_S = 8          # blocks per cluster (the portable cluster size)
SPLIT_BLOCKS = 256       # split blocks wanted: about two per SM
SPLIT_SCAN_MIN = 256     # eff_pos entries a block's slice holds at least
SPLIT_MIN_STAGES, SPLIT_MAX_STAGES = 2, 4
SPLIT_SLICE = 4096       # eff_pos entries a block tests per window, at
#                          most (32 a thread): a window is S such slices
SPLIT_LIST = 1024        # listed pool rows (int32) a round of a block's
#                          share of a window holds
SPLIT_SMEM = 74752       # dynamic shared memory of a split block, at
#                          most: three blocks per SM of 228 KB
SIMT_GROUP = 8           # admitted rows the SIMT kernel gathers at once
SIMT_ROWS = 4            # query heads a SIMT block owns (1 when G = 1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one paged-attention call runs (``plan``).

    ``rows``: query rows of a block (the split walk's 16 mma rows; the
    SIMT kernel's query heads per block).  ``heads``: kv-heads per block
    (a split block's group of 1, 2 or 4, each taken by 4 / heads warps; 1
    on the SIMT kernel).  ``splits``: blocks per cluster, each taking an
    equal share of a slot's admitted entries (1 on the SIMT kernel).
    ``tile``: listed entries a split step stages, 64 / heads (the SIMT
    kernel's rows gathered at once).  ``stages``: ring depth (0 on the
    SIMT kernel).  ``grid``: (splits, B·⌈Hkv/heads⌉) on the split walk,
    (B·Hkv, ⌈G/rows⌉) on the SIMT kernel.  ``smem``: dynamic shared memory
    bytes per block."""
    route: str            # "split" or "simt"
    rows: int
    heads: int
    splits: int
    tile: int
    stages: int
    grid: Tuple[int, int]
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_bytes(payload: Optional[str], dh: int) -> int:
    """Bytes of one kv-head's payload row in a page."""
    return {None: 2 * dh, "int8": dh, "int4": dh // 2}[payload]


def split_smem(payload: Optional[str], heads: int, dh: int,
               stages: int) -> int:
    """Dynamic shared memory of a split block: ``stages`` ring stages, each
    the K and V rows of 64 / heads entries for ``heads`` kv-heads (bf16:
    an entry's rows side by side, heads·dh + 8 wide; codes: their rows and
    fp32 scales), for int8 and int4 pages each warp's bf16 tile of 16 rows
    dh + 8 wide (K's, then V's); at least the warps' partials after the walk
    (4 × 16 rows × dh fp32); then the list of pool rows."""
    tile = SPLIT_WARPS * SPLIT_SUB // heads
    if payload is None:
        stage = 2 * tile * (heads * dh + 8) * 2
        warp_tiles = 0
    else:
        stage = 2 * tile * heads * (row_bytes(payload, dh) + 4)
        warp_tiles = SPLIT_WARPS * SPLIT_SUB * (dh + 8) * 2
    walk = stages * stage + warp_tiles
    return max(walk, SPLIT_WARPS * 16 * dh * 4) + SPLIT_LIST * 4


def split_bounds(n: int, S: int):
    """The admitted-order share [⌊s·n/S⌋, ⌊(s+1)·n/S⌋) of each of the S
    blocks of a cluster, the rule the split walk's blocks follow in each
    window of the slot's row."""
    return [(s * n // S, (s + 1) * n // S) for s in range(S)]


def split_slice(E: int, S: int) -> int:
    """Entries of a block's slice of a window: ⌈E/S⌉ in whole groups of 4
    (16-byte loads), at most SPLIT_SLICE; windows of S slices cover the
    row."""
    return max(4, min(SPLIT_SLICE, _cdiv(E, 4 * S) * 4))


def plan(B: int, Hkv: int, G: int, dh: int, E: int,
         payload: Optional[str], dtype: torch.dtype) -> Plan:
    """The route, head grouping, split, ring, grid and shared memory of
    paged attention over B slots of Hkv kv-heads with G query heads each,
    head dim dh, E = J·ps entries per slot's chain, pages of ``payload``
    (None, "int8", "int4") and q in ``dtype``: bf16 with G <= SPLIT_MAX_G
    -> the split walk, else the SIMT kernel.  Pure: the one place these
    choices are made.

    The split walk takes the most kv-heads per block (<= SPLIT_WARPS, a
    power of two, <= Hkv) that still give SPLIT_BLOCKS blocks with the
    largest split E allows (SPLIT_SCAN_MIN entries a block at least, at
    most SPLIT_MAX_S), then the split that reaches SPLIT_BLOCKS, then the
    deepest ring (SPLIT_MIN_STAGES to SPLIT_MAX_STAGES) within SPLIT_SMEM
    (two stages fit it at every head dim, payload and grouping)."""
    if dh not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head dim {dh} not in "
                         f"{_HEAD_DIMS}")
    if payload not in _PAYLOAD:
        raise ValueError(f"paged_attention kernel: kv_dtype {payload!r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged_attention kernel: q {dtype} must be "
                         "bfloat16 or float32")
    if dtype == torch.float32 or G > SPLIT_MAX_G:
        rows = 1 if G == 1 else SIMT_ROWS
        return Plan("simt", rows, 1, 1, SIMT_GROUP, 0,
                    (B * Hkv, _cdiv(G, rows)), 0)
    max_s = max(1, min(SPLIT_MAX_S, _cdiv(E, SPLIT_SCAN_MIN)))
    heads = SPLIT_WARPS
    while heads > 1 and (heads > Hkv or B * _cdiv(Hkv, heads) * max_s
                         < SPLIT_BLOCKS):
        heads //= 2
    groups = _cdiv(Hkv, heads)
    splits = max(1, min(max_s, _cdiv(SPLIT_BLOCKS, max(1, B * groups))))
    stages = SPLIT_MIN_STAGES
    while (stages < SPLIT_MAX_STAGES
           and split_smem(payload, heads, dh, stages + 1) <= SPLIT_SMEM):
        stages += 1
    return Plan("split", SPLIT_MAX_G, heads, splits,
                SPLIT_WARPS * SPLIT_SUB // heads, stages,
                (splits, B * groups), split_smem(payload, heads, dh, stages))


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("paged_attention")
        fn = lib.paged_attention_bf16 if dtype == torch.bfloat16 \
            else lib.paged_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
            ctypes.c_float] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


def paged_attention(q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
                    q_positions, *, scale: float, k_scales=None,
                    v_scales=None, kv_dtype=None):
    """q [B,1,Hq,dh]; k/v pages [P,ps,Hkv,dhp]; block_table [B,J];
    eff_pos [B,J·ps]; k/v_tok [B,1,Hkv,dh]; q_positions [B,1]
    -> [B,1,Hq,dh] in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(
            q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
            q_positions=q_positions, softmax_scale=scale, k_scales=k_scales,
            v_scales=v_scales, kv_dtype=kv_dtype)
    return paged_attention_cuda(
        q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
        q_positions, scale=scale, k_scales=k_scales, v_scales=v_scales,
        kv_dtype=kv_dtype)


def paged_attention_cuda(q, k_pages, v_pages, block_table, eff_pos, k_tok,
                         v_tok, q_positions, *, scale: float, k_scales=None,
                         v_scales=None, kv_dtype=None):
    """The CUDA kernels alone (raises for anything they do not take), on
    the route ``plan`` picks."""
    tensors = [q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
               q_positions]
    if kv_dtype is not None:
        tensors += [k_scales, v_scales]
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise ValueError("paged_attention kernel needs CUDA tensors, got "
                         + ", ".join(str(getattr(t, "device", None))
                                     for t in tensors))
    if kv_dtype not in _PAYLOAD:
        raise ValueError(f"paged_attention kernel: kv_dtype {kv_dtype!r}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged_attention kernel: q {q.dtype} must be "
                         "bfloat16 or float32")
    B, one, Hq, dh = q.shape
    P, ps, Hkv, dhp = k_pages.shape
    J = block_table.shape[1]
    want_dhp = dh // 2 if kv_dtype == "int4" else dh
    want_page = q.dtype if kv_dtype is None else torch.int8
    if (one != 1 or dh not in _HEAD_DIMS or Hkv == 0 or Hq % Hkv
            or dhp != want_dhp or v_pages.shape != k_pages.shape
            or k_pages.dtype != want_page or v_pages.dtype != want_page
            or block_table.shape != (B, J) or eff_pos.shape != (B, J * ps)
            or k_tok.shape != (B, 1, Hkv, dh) or v_tok.shape != k_tok.shape
            or q_positions.shape != (B, 1)):
        raise ValueError(
            f"paged_attention kernel: shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)} {k_pages.dtype} block_table "
            f"{tuple(block_table.shape)} eff_pos {tuple(eff_pos.shape)} "
            f"k_tok {tuple(k_tok.shape)} q_positions "
            f"{tuple(q_positions.shape)} (kv_dtype {kv_dtype})")
    if kv_dtype is not None and (k_scales.shape != (P, ps, Hkv)
                                 or v_scales.shape != (P, ps, Hkv)):
        raise ValueError("paged_attention kernel: scales must be "
                         f"[{P}, {ps}, {Hkv}]")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention kernel: pages must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel: pages must be 16-byte "
                         "aligned")
    return run_plan(plan(B, Hkv, Hq // Hkv, dh, J * ps, kv_dtype, q.dtype),
                    q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
                    q_positions, scale=scale, k_scales=k_scales,
                    v_scales=v_scales, kv_dtype=kv_dtype)


def run_plan(p: Plan, q, k_pages, v_pages, block_table, eff_pos, k_tok,
             v_tok, q_positions, *, scale: float, k_scales=None,
             v_scales=None, kv_dtype=None):
    """One launch of plan ``p`` on checked CUDA inputs; the C entry refuses
    the call if the plan disagrees with what it instantiates."""
    global launches, launches_split, launches_simt
    B, _, Hq, dh = q.shape
    P, ps, Hkv, _ = k_pages.shape
    J = block_table.shape[1]
    q = q.contiguous()
    k_tok = k_tok.to(q.dtype).contiguous()
    v_tok = v_tok.to(q.dtype).contiguous()
    block_table = block_table.to(torch.int32).contiguous()
    eff_pos = eff_pos.to(torch.int32).contiguous()
    if eff_pos.data_ptr() % 16:        # its rows are read 16 bytes at once
        eff_pos = eff_pos.clone()
    q_pos = q_positions.to(torch.int32).reshape(B).contiguous()
    ks = vs = None
    if kv_dtype is not None:
        ks = k_scales.to(torch.float32).contiguous()
        vs = v_scales.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    err = _fn(q.dtype)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), block_table.data_ptr(),
        eff_pos.data_ptr(), k_tok.data_ptr(), v_tok.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), B, P, ps, Hkv, Hq // Hkv, J, dh,
        _PAYLOAD[kv_dtype], float(scale), _ROUTES[p.route], p.rows, p.heads,
        p.splits, p.tile, p.stages, p.grid[0], p.grid[1], p.smem,
        build.stream_ptr(q.device))
    build.check(err, f"paged_attention ({p.route})")
    launches += 1
    if p.route == "split":
        launches_split += 1
    else:
        launches_simt += 1
    return out
