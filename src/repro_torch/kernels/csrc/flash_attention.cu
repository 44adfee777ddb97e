// Online-softmax GQA attention (paper Alg. 2; FlashAttention update rule).
//
// Replaces the TPU kernel flash_attention_packed
// (src/repro/kernels/flash_attention.py:74) together with the head packing
// around it (ops._pack_heads): the G query heads of a KV group are the
// rows of one (batch, kv-head) problem, row r = g·Tq + t.  Instead of
// copying q, k and v into packed arrays, the kernels read them in place
// through their strides — q [B, Tq, Hq, dh], k/v [B, Tk, Hkv, dh] (the
// decode cache layout) — and write the output as [B, Tq, Hq, dh].  The
// positions are read in place too: q_pos [B, Tq] through its strides (the
// prefill's arange is an expanded view) and kv_len [B] or null (= Tk); a
// row derives (b, g, t) and its position from its own index.
//
// Masking is the reference's, by absolute position: key kp is valid for a
// row at position pos when kp < kv_len (and kp < Tk), kp <= pos (causal)
// and kp > pos - window (window > 0).  The running maximum starts at
// NEG_INF = -1e30, never -inf, so exp(m_prev - m_new) is never
// exp(-inf + inf) = NaN; the SIMT kernel masks scores to NEG_INF too (a
// fully masked tile gives exp(0) = 1 and later tiles wash it out).  A row
// with no valid key at all (a pad row, pos = -1) is written as zeros, as
// the reference oracle does; whether a row (or a split's part of it) saw a
// valid key is an explicit flag, never l > 0 (on the SIMT kernel a fully
// masked tile leaves l > 0).
//
// Three routes.  The wrapper's plan() (kernels/flash_attention.py) picks
// one by dtype and R = G·Tq alone, with its tiles, split, grid and dynamic
// shared memory; the C entries launch exactly that grid and refuse a tile,
// split or dh this file has no instantiation of.
//
// 1. bf16, R > 16: the tensor-core tile (flash_wgmma; prefill).  Bound by
//    the bytes at the main path's prefill: 4 × 512 causal rows of 32 heads
//    at dh 128 are 8.6 GFLOP (8.7 µs at 989 TFLOP/s) over 67 MB of q, k, v
//    and out (20 µs at 3.35 TB/s).  A work item is 128 packed rows of one
//    (b, kv-head), computed by two consumer warpgroups of 64 rows each.
//    The blocks are persistent, one per SM: each walks its items (the row
//    tiles of one (b, kv-head) side by side, heaviest first, so their K
//    and V come from memory once; every other round backwards) while its
//    producer warpgroup stages the next item: warps 1-3 copy its positions
//    and Q (16-byte cp.async, since Q's rows may span two heads g) into
//    the second of two Q buffers, and one thread streams K and V tiles of
//    128 keys through a 2-stage TMA ring that runs on across items (a 4-D
//    tensor map over [B, Tk, Hkv, dh], 128-byte swizzle, zero fill past
//    Tk; dh = 128 takes two 64-wide boxes, dh = 256 four, dh = 32 one box
//    whose upper half is the zero fill, dh = 80 two boxes, the second of
//    16 real columns and 48 of zero fill: its rows are padded to 128 in
//    shared memory, Q·Kᵀ takes the 5 k-steps of real columns and P·V an
//    n128 product whose last 48 columns are zeros, never written out).  At dh 256 (gemma3-12b) a tile
//    holds 64 keys and the block one Q buffer (WgShape): O alone takes
//    128 registers a consumer thread there, and two 64 KB Q buffers
//    beside the ring would pass 227 KB; P·V runs as two n128 products.  S = Q·Kᵀ is a bf16 wgmma from shared memory
//    (K is K-major); O += P·V takes P from registers (the fp32 scores
//    rescaled and rounded to bf16, in the mma A layout) and V MN-major
//    (the transpose bit).  Tile i's scores are issued with tile i - 1's
//    P·V, and its softmax runs while that product is in flight.  Tiles
//    past an item's causal limit or kv_len are never loaded; tiles wholly
//    below its smallest position skip the mask.
//
// 2. bf16, R <= 16: the cluster split-KV walk (flash_splitkv; decode, and
//    prefills of at most 16 rows).  Bound by the bytes of the cache: at
//    B 4, Tk 544, 32 heads, dh 128 a call reads 35.7 MB (10.7 µs).  Each
//    (b, kv-head) is one thread-block cluster of S <= 8 blocks, block s
//    walking keys [s·kc, (s+1)·kc) of [0, Tk); plan() takes S for about
//    two blocks per SM (at B 4, S = 2: more, smaller splits measured
//    slower, their reads of the cache spread over more places at once).
//    All R rows of the group sit in one block, so each K/V row is
//    read once for all of them (the reference's KV-head packing).  K and
//    V rows come in through a 2-stage cp.async ring of 64 keys, 16 bytes
//    per copy, zero-filled past the block's last valid key (nothing past
//    kv_len is read); each of the 4 warps owns 16 keys of a tile and runs
//    its own online softmax with mma.sync m16n8k16 (rows past R are zero).
//    The warps' (m, l, acc) are added in warp order through shared memory,
//    then the cluster's blocks in rank order through distributed shared
//    memory: one launch, no atomics, no scratch, nothing that outlives it.
//    At dh 256 the ring takes 140 KB (one block an SM) and Q's fragments
//    are read from shared memory each tile instead of held in registers.
//    A sliding-window ring cache (gemma3's LOCAL layers) is attended in
//    slot order with kv_len = min(t + 1, W): the softmax is over a set of
//    keys, so the ring needs no key positions and no reordering
//    (core/skip_block.py, routed_attention_decode's ring).
//
// 3. fp32: the SIMT kernel (flash_simt), fp32 FMAs from shared memory; the
//    parity instrument of the CPU ≡ CUDA checks.  Its tile is static
//    shared memory up to dh 128 and dynamic (82 KB) at dh 256.  Lane d
//    owns output dims d, d + 32, ...; at dh 80 its third dim exists for
//    lanes 0-15 only.
//
// Where the bf16 routes round.  P = exp2(s·c - m) with c = fp32(scale) ·
// fp32(log2 e), one FFMA on the raw fp32 score and ex2.approx (relative
// error ~2^-22); the scale is never applied to bf16 Q.  The running row
// maximum m is kept as an integer, ceil of the scaled scores' maximum, so
// every rescale is an exact power of two and bf16(P) = bf16(exp2(s·c -
// M))·2^(M - m) for any later maximum M: the route's one bf16 rounding, on
// P, does not depend on the tile or split that saw each key, and l = Σ P
// is summed in fp32 before the rounding.  chip_smoke.py's mirror rounds P
// the same way.  A masked raw score is -inf (m stays finite, so it gives
// P = 0 exactly).
#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <type_traits>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1.0e30f;
constexpr float kMasked = -INFINITY;  // a masked raw score on the bf16 routes
constexpr float kLog2e = 1.4426950408889634f;

// Element strides: q, k, v, out by (batch, time, head); q_pos by (batch, t).
struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh, pb, pt;
};

__device__ __forceinline__ int row_pos(const int* q_pos, const Strides& st,
                                       int b, int r, int R, int Tq) {
  return r < R ? q_pos[b * st.pb + (r % Tq) * st.pt] : -1;
}
__device__ __forceinline__ int valid_len(const int* kv_len, int b, int Tk) {
  return kv_len != nullptr ? min(kv_len[b], Tk) : Tk;
}
__device__ __forceinline__ bool key_ok(int kp, int pos, int kvl, int causal,
                                       int window) {
  return kp < kvl && (!causal || kp <= pos) && (!window || kp > pos - window);
}
// The smallest and largest position over rows 0..n-1 of pos_s (lanes of
// one warp; every lane ends with both).
__device__ __forceinline__ void pos_range(const int* pos_s, int n, int lane,
                                          int& lo, int& hi) {
  lo = INT_MAX;
  hi = -1;
  for (int r = lane; r < n; r += 32) {
    lo = min(lo, pos_s[r]);
    hi = max(hi, pos_s[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// ---------------------------------------------------------------------------
// Route 3: the SIMT kernel (fp32)
// ---------------------------------------------------------------------------
//
// Each block owns one (b, kv-head) and 16 rows and loops over KV tiles of
// 32 keys staged in shared memory; each warp owns two rows: lane j scores
// key j, the warp reduces max and Σexp with shuffles, and lane d
// accumulates output dims d, d+32, ....

constexpr int kSimtKeys = 32, kSimtWarps = 8, kSimtRowsPerWarp = 2;
constexpr int kSimtRows = kSimtWarps * kSimtRowsPerWarp;

template <int DH>
struct SimtSmem {
  float ks[kSimtKeys][DH + 1];  // +1: lane j reads row j freely
  float vs[kSimtKeys][DH];
  float qs[kSimtRows][DH];
  int ps[kSimtRows];
};
// Up to dh 128 the tile is static shared memory (≤ 41 KB); at dh 256 it is
// 82 KB, past the 48 KB static limit, so the kernel takes it dynamically
// (the launch opts in; plan() gives its bytes).
template <int DH>
constexpr bool kSimtDynamic = sizeof(SimtSmem<DH>) > 48 * 1024;

template <int DH>
__global__ void __launch_bounds__(kSimtWarps * 32)
flash_simt(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ q_pos,
           const int* __restrict__ kv_len, float* __restrict__ out, int Hkv,
           int G, int Tq, int Tk, Strides st, int causal, int window,
           float scale) {
  constexpr int DPL = (DH + 31) / 32;  // output dims per lane, at most
  extern __shared__ __align__(16) uint8_t simt_dyn[];
  SimtSmem<DH>* sm;
  if constexpr (kSimtDynamic<DH>) {
    sm = reinterpret_cast<SimtSmem<DH>*>(simt_dyn);
  } else {
    __shared__ SimtSmem<DH> simt_static;
    sm = &simt_static;
  }
  auto& ks = sm->ks;
  auto& vs = sm->vs;
  auto& qs = sm->qs;
  auto& ps = sm->ps;

  const int R = G * Tq;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int r0 = blockIdx.x * kSimtRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kThreads = kSimtWarps * 32;

  for (int r = tid; r < kSimtRows; r += kThreads)
    ps[r] = row_pos(q_pos, st, b, r0 + r, R, Tq);
  for (int e = tid; e < kSimtRows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, gr = r0 + r;
    float val = 0.f;
    if (gr < R) {
      const int g = gr / Tq, t = gr % Tq;
      val = q[b * st.qb + t * st.qt + (h * G + g) * st.qh + d] * scale;
    }
    qs[r][d] = val;
  }
  __syncthreads();

  int maxpos = -1;
  for (int r = 0; r < kSimtRows; ++r) maxpos = max(maxpos, ps[r]);
  const int kvl = valid_len(kv_len, b, Tk);
  const int limit = causal ? min(kvl, maxpos + 1) : kvl;

  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp], acc[kSimtRowsPerWarp][DPL];
  bool any[kSimtRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kSimtRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    any[i] = false;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  for (int t0 = 0; t0 < limit; t0 += kSimtKeys) {
    for (int e = tid; e < kSimtKeys * DH; e += kThreads) {
      const int j = e / DH, d = e % DH, kp = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Tk) {
        kv = k[b * st.kb + kp * st.kt + h * st.kh + d];
        vv = v[b * st.vb + kp * st.vt + h * st.vh + d];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSimtRowsPerWarp; ++i) {
      const int rl = warp * kSimtRowsPerWarp + i;
      if (r0 + rl >= R) continue;  // warp-uniform
      const int kp = t0 + lane;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(qs[rl][d], ks[lane][d], s);
      const bool valid = key_ok(kp, ps[rl], kvl, causal, window);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[i], repro::warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + repro::warp_sum(p);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kSimtKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          if (DH % 32 == 0 || lane + 32 * dd < DH)
            acc[i][dd] = fmaf(pj, vs[j][lane + 32 * dd], acc[i][dd]);
      }
      m[i] = m_new;
      any[i] = any[i] || __any_sync(0xffffffffu, valid);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kSimtRowsPerWarp; ++i) {
    const int gr = r0 + warp * kSimtRowsPerWarp + i;
    if (gr >= R) continue;
    const int g = gr / Tq, t = gr % Tq;
    float* o = out + b * st.ob + t * st.ot + (h * G + g) * st.oh;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd)
      if (DH % 32 == 0 || lane + 32 * dd < DH)
        o[lane + 32 * dd] = any[i] ? acc[i][dd] / den : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Route 1: the tensor-core tile (bf16, R > 16)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;   // packed rows per item: 2 consumer warpgroups
constexpr int kWgKeys = 128;   // keys per K/V tile
constexpr int kWgStages = 2;
constexpr int kWgThreads = 384;  // + the producer warpgroup
constexpr int kWgMaxBlocks = 132;  // persistent blocks: one per SM of an H100
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;
constexpr int kWgStagers = 96;   // producer threads that stage Q: warps 1-3

// At dh 256 an item's O takes 128 fp32 registers a consumer thread (64 rows
// x 256 dims over a warpgroup), so its K/V tiles hold 64 keys (32 score
// registers, 16 of P, 16 of the next P: the same 192 as at dh 128), and
// one Q buffer of 64 KB with the 128 KB ring keeps the block under 227 KB
// of shared memory; the producer stages an item's Q once the consumers
// have written the item before out of it.
template <int DH>
struct WgShape {
  static constexpr int kDhp = (DH + 63) / 64 * 64;  // whole 128-byte rows
  static constexpr int kBoxes = kDhp / 64;
  // Q·Kᵀ's k-steps: every one of kDhp below dh 64 (as dh 32 always ran),
  // the real columns' from 64 up (dh 80: 5 of 8).
  static constexpr int kQkSteps = DH < 64 ? kDhp / 16 : (DH + 15) / 16;
  static constexpr int kKeys = DH > 128 ? 64 : kWgKeys;  // keys per tile
  static constexpr int kQBufs = DH > 128 ? 1 : 2;
  static constexpr int kQBytes = kBoxes * kWgRows * 128;
  static constexpr int kTileBytes = kBoxes * kKeys * 128;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  // The Q buffers, the ring, 10 barriers, slack to align the base to 1 KB.
  static constexpr int kSmem =
      kQBufs * kQBytes + kWgStages * kStageBytes + 10 * 8 + 1024;
};

// Byte offset of 16-byte chunk c of row r in a Q buffer: boxes of 64 dh
// (128-byte lines of 128 rows), chunk c % 8 of a line at c % 8 ^ r % 8
// (the 128-byte swizzle).
__device__ __forceinline__ uint32_t q_chunk(int r, int c) {
  return (c / 8) * (kWgRows * 128) + r * 128 + (((c % 8) ^ (r & 7)) << 4);
}

// The j-th item of block x of P: rounds of P items, every other round
// walked backwards.  The row tiles of one (b, kv-head) are consecutive
// items, heaviest first, so they run in the same round and read its K and
// V from memory once (then from L2); the alternating rounds even out the
// blocks' work.
__device__ __forceinline__ int wg_item(int j, int x, int P) {
  return j * P + ((j & 1) ? P - 1 - x : x);
}

// tmk, tmv: 4-D maps over k/v [B, Tk, Hkv, dh] (dims {dh, Hkv, Tk, B}),
// boxes of 64 dh x 1 head x kKeys keys x 1 batch.  Item w is row tile
// nrt - 1 - w % nrt of (b, h) = ((w / nrt) / Hkv, (w / nrt) % Hkv).
template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tmk,
            const __grid_constant__ CUtensorMap tmv,
            const bf16* __restrict__ q, const int* __restrict__ q_pos,
            const int* __restrict__ kv_len, bf16* __restrict__ out, int B,
            int Hkv, int G, int Tq, int Tk, Strides st, int causal,
            int window, float scale_log2) {
  using Sh = WgShape<DH>;
  constexpr int DHP = Sh::kDhp, kChunks = DHP / 8;
  constexpr int KT = Sh::kKeys, NQ = Sh::kQBufs;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int pos_s[2][kWgRows];
  __shared__ int meta_s[2][5];  // t_begin, t_end, lo, hi, kvl of an item
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  uint8_t* const qgen = smem_raw + (base - raw);
  const uint32_t ring = base + NQ * Sh::kQBytes;
  // Barriers: per ring stage full (both TMA tiles landed) and empty (both
  // consumer warpgroups' wgmma retired); per Q buffer m_full (the item's
  // positions and tile range), q_full (and its Q) and q_empty (consumed);
  // item j takes buffer j % NQ.
  const uint32_t full = ring + kWgStages * Sh::kStageBytes;
  const uint32_t empty = full + 8 * kWgStages;
  const uint32_t m_full = empty + 8 * kWgStages;
  const uint32_t q_full = m_full + 16;
  const uint32_t q_empty = q_full + 16;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int R = G * Tq, BH = B * Hkv, nrt = (R + kWgRows - 1) / kWgRows;
  const int n_items = BH * nrt, P = gridDim.x, x = blockIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(m_full + 8 * s, 1);
      mbar_init(q_full + 8 * s, kWgStagers);
      mbar_init(q_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (tid == 256) {  // one thread issues the K/V TMA copies
      int g = 0;  // tiles issued so far: the ring's stage and phase
      for (int j = 0; wg_item(j, x, P) < n_items; ++j) {
        const int w = wg_item(j, x, P), buf = j % NQ;
        const int b = (w / nrt) / Hkv, h = (w / nrt) % Hkv;
        mbar_wait(m_full + 8 * buf, (j / NQ) & 1);  // the item's tile range
        const int t_end = meta_s[buf][1];
        for (int it = meta_s[buf][0]; it < t_end; ++it, ++g) {
          const int s = g % kWgStages;
          if (g >= kWgStages) mbar_wait(empty + 8 * s, (g / kWgStages - 1) & 1);
          const uint32_t ks = ring + s * Sh::kStageBytes;
          const uint32_t vs = ks + Sh::kTileBytes;
          mbar_expect_tx(full + 8 * s, Sh::kStageBytes);
#pragma unroll
          for (int c = 0; c < Sh::kBoxes; ++c) {
            tma_load_4d(ks + c * KT * 128, &tmk, full + 8 * s, 64 * c, h,
                        it * KT, b);
            tma_load_4d(vs + c * KT * 128, &tmv, full + 8 * s, 64 * c, h,
                        it * KT, b);
          }
        }
      }
    } else if (tid >= 256 + 32) {
      // Warps 1-3 stage each item into its Q buffer while the consumers
      // work on the item before: the positions, then warp 1 the item's
      // range of K/V tiles (so its copies can start), then Q (16-byte
      // cp.async, all in flight at once; zeros past R and past dh).
      const int t96 = tid - 256 - 32;
      for (int j = 0; wg_item(j, x, P) < n_items; ++j) {
        const int w = wg_item(j, x, P), buf = j % NQ;
        const int b = (w / nrt) / Hkv, h = (w / nrt) % Hkv;
        const int r0 = (nrt - 1 - w % nrt) * kWgRows;
        if (j >= NQ) mbar_wait(q_empty + 8 * buf, ((j / NQ) - 1) & 1);
        for (int r = t96; r < kWgRows; r += kWgStagers)
          pos_s[buf][r] = row_pos(q_pos, st, b, r0 + r, R, Tq);
        asm volatile("bar.sync 1, %0;\n" ::"n"(kWgStagers) : "memory");
        if (t96 < 32) {
          int lo, hi;
          pos_range(pos_s[buf], min(kWgRows, R - r0), lane, lo, hi);
          if (lane == 0) {
            const int kvl = valid_len(kv_len, b, Tk);
            const int limit = causal ? min(kvl, hi + 1) : kvl;
            meta_s[buf][0] = window > 0 ? max(0, lo - window + 1) / KT : 0;
            meta_s[buf][1] = limit > 0 ? (limit + KT - 1) / KT : 0;
            meta_s[buf][2] = lo;
            meta_s[buf][3] = hi;
            meta_s[buf][4] = kvl;
            mbar_arrive(m_full + 8 * buf);
          }
        }
        const uint32_t qb = base + buf * Sh::kQBytes;
        for (int e = t96; e < kWgRows * kChunks; e += kWgStagers) {
          const int r = e / kChunks, c = e % kChunks, gr = r0 + r;
          const bool live = gr < R && 8 * c < DH;
          const int gq = live ? gr / Tq : 0, t = live ? gr % Tq : 0;
          cp_async16(qb + q_chunk(r, c),
                     q + b * st.qb + t * st.qt + (h * G + gq) * st.qh +
                         (live ? 8 * c : 0),
                     live ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
        // wgmma reads Q through the async proxy.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(q_full + 8 * buf);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item;
  // this thread rows ra and ra + 8 of the accumulator fragments.  Tile i's
  // scores are issued together with tile i - 1's P·V, and its softmax runs
  // while that product is in flight (the next P goes to pn; O is rescaled
  // once the product has landed).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  const int warp = (tid % 128) / 32;
  const int ra = wg * 64 + warp * 16 + lane / 4;
  float o[DHP / 2], sc[KT / 2];
  uint32_t p[KT / 16][4], pn[KT / 16][4];
  uint32_t q_wg = 0;
  float m0, m1, l0, l1;
  bool f0, f1;
  int pa, pb, lo, hi, kvl;

  // S = Q·Kᵀ of the tile in stage ks, both K-major (rows of 64 dh a box:
  // 128 rows of Q, KT keys of K).
  auto issue_scores = [&](uint32_t ks) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::kQkSteps; ++kk) {
      const uint32_t off = (kk / 4) * kWgRows * 128 + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * KT * 128 + (kk % 4) * 32;
      if constexpr (KT == 128)
        wgmma_m64n128k16<0>(sc, smem_desc(q_wg + off, 16, 1024),
                            smem_desc(ks + koff, 16, 1024), kk > 0 ? 1u : 0u);
      else
        wgmma_m64n64k16<0>(sc, smem_desc(q_wg + off, 16, 1024),
                           smem_desc(ks + koff, 16, 1024), kk > 0 ? 1u : 0u);
    }
    wgmma_commit();
  };
  // O += P·V of the tile in stage vs, V MN-major: atoms of 64 dh (LBO =
  // one box of KT keys), 16 keys (2 KB) per k16 step.  At dh 256 two
  // n128 products a step, each over two boxes: O's registers [0, 64) hold
  // dims 0-127, [64, 128) dims 128-255 (register 4i is still dim 8i).
  auto issue_pv = [&](uint32_t vs) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if constexpr (DHP == 256) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          wgmma_m64n128k16_rs(
              *reinterpret_cast<float(*)[64]>(o + 64 * hh), p[kk],
              smem_desc(vs + hh * 2 * KT * 128 + kk * 16 * 128, KT * 128,
                        1024),
              1u);
      } else {
        const uint64_t db = smem_desc(vs + kk * 16 * 128, KT * 128, 1024);
        if constexpr (DHP == 128)
          wgmma_m64n128k16_rs(o, p[kk], db, 1u);
        else
          wgmma_m64n64k16_rs(o, p[kk], db, 1u);
      }
    }
    wgmma_commit();
  };
  // The online softmax of tile it's raw scores: masked ones set to -inf
  // (m stays finite, so they give P = 0), the integer row maxima of the
  // scaled scores, P = exp2(s·scale - m) (one FFMA) summed into l and
  // rounded to bf16 into pn: key block
  // kk is fragments j = 2kk (registers 0, 1) and 2kk + 1 (registers 2,
  // 3), rows ra then ra + 8; fragment j holds keys 8j + 2(lane%4) + {0, 1}
  // of rows ra (sc[4j], sc[4j+1]) and ra + 8 (sc[4j+2..3]).  Returns O's
  // rescale factors in al0, al1.
  auto softmax = [&](int it, float& al0, float& al1) {
    const int j0 = it * KT;
    const bool no_mask = j0 + KT <= kvl && (!causal || j0 + KT - 1 <= lo) &&
                         (!window || j0 > hi - window);
    if (!no_mask) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = j0 + 8 * j + 2 * (lane % 4) + e;
          const bool v0 = key_ok(kp, pa, kvl, causal, window);
          const bool v1 = key_ok(kp, pb, kvl, causal, window);
          sc[4 * j + e] = v0 ? sc[4 * j + e] : kMasked;
          sc[4 * j + 2 + e] = v1 ? sc[4 * j + 2 + e] : kMasked;
          f0 = f0 || v0;
          f1 = f1 || v1;
        }
      }
    } else {
      f0 = f1 = true;
    }
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, ceilf(quad_max(mx0) * scale_log2));
    const float mn1 = fmaxf(m1, ceilf(quad_max(mx1) * scale_log2));
    al0 = pow2_int(m0 - mn0);
    al1 = pow2_int(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const float e0 = exp2_fast(fmaf(sc[4 * j], scale_log2, -mn0));
      const float e1 = exp2_fast(fmaf(sc[4 * j + 1], scale_log2, -mn0));
      const float e2 = exp2_fast(fmaf(sc[4 * j + 2], scale_log2, -mn1));
      const float e3 = exp2_fast(fmaf(sc[4 * j + 3], scale_log2, -mn1));
      sum0 += e0 + e1;
      sum1 += e2 + e3;
      pn[j / 2][(j % 2) * 2] = pack_bf16(e0, e1);
      pn[j / 2][(j % 2) * 2 + 1] = pack_bf16(e2, e3);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
  };
  auto stage = [&](int g) { return ring + (g % kWgStages) * Sh::kStageBytes; };

  int g = 0;  // tiles consumed so far: the ring's stage and phase
  for (int j = 0; wg_item(j, x, P) < n_items; ++j) {
    const int w = wg_item(j, x, P), buf = j % NQ;
    const int b = (w / nrt) / Hkv, h = (w / nrt) % Hkv;
    const int r0 = (nrt - 1 - w % nrt) * kWgRows;
    mbar_wait(q_full + 8 * buf, (j / NQ) & 1);
    const int t_begin = meta_s[buf][0], t_end = meta_s[buf][1];
    lo = meta_s[buf][2];
    hi = meta_s[buf][3];
    kvl = meta_s[buf][4];
    pa = pos_s[buf][ra];
    pb = pos_s[buf][ra + 8];
    q_wg = base + buf * Sh::kQBytes + wg * 64 * 128;
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
    f0 = f1 = false;

    for (int it = t_begin; it < t_end; ++it, ++g) {
      mbar_wait(full + 8 * (g % kWgStages), (g / kWgStages) & 1);
      issue_scores(stage(g));
      if (it > t_begin) {
        issue_pv(stage(g - 1) + Sh::kTileBytes);
        wgmma_wait<1>();  // the scores; P·V may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(sc);
      float al0, al1;
      softmax(it, al0, al1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (it > t_begin) mbar_arrive(empty + 8 * ((g - 1) % kWgStages));
#pragma unroll
      for (int i = 0; i < DHP / 8; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pn[kk][r];
    }
    if (t_end > t_begin) {  // the last tile's P·V
      issue_pv(stage(g - 1) + Sh::kTileBytes);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(empty + 8 * ((g - 1) % kWgStages));
    }

    // Epilogue: l and the flag over the quad that shares a row; O · (1/l)
    // (zeros for a row with no valid key) as bf16 pairs into this
    // warpgroup's rows of the item's Q buffer (its wgmma reads are done),
    // then out in 16-byte chunks through the output strides.
    const float r0l = 1.f / fmaxf(quad_sum(l0), 1e-20f);
    const float r1l = 1.f / fmaxf(quad_sum(l1), 1e-20f);
    const float y0 = quad_any(f0) ? r0l : 0.f, y1 = quad_any(f1) ? r1l : 0.f;
    uint8_t* const qb = qgen + buf * Sh::kQBytes;
#pragma unroll
    for (int i = 0; i < DHP / 8; ++i) {
      const int bo = 4 * (lane % 4);  // byte of the pair in its chunk
      *reinterpret_cast<uint32_t*>(qb + q_chunk(ra, i) + bo) =
          pack_bf16(o[4 * i] * y0, o[4 * i + 1] * y0);
      *reinterpret_cast<uint32_t*>(qb + q_chunk(ra + 8, i) + bo) =
          pack_bf16(o[4 * i + 2] * y1, o[4 * i + 3] * y1);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    for (int e = tid % 128; e < 64 * kChunks; e += 128) {
      const int r = wg * 64 + e / kChunks, c = e % kChunks, gr = r0 + r;
      if (gr < R && 8 * c < DH) {
        const int gq = gr / Tq, t = gr % Tq;
        *reinterpret_cast<uint4*>(out + b * st.ob + t * st.ot +
                                  (h * G + gq) * st.oh + 8 * c) =
            *reinterpret_cast<const uint4*>(qb + q_chunk(r, c));
      }
    }
    mbar_arrive(q_empty + 8 * buf);  // the Q buffer and positions are free
  }
}

// ---------------------------------------------------------------------------
// Route 2: the cluster split-KV walk (bf16, R <= 16)
// ---------------------------------------------------------------------------

constexpr int kSkvRows = 16;      // mma rows; rows past R are zero
constexpr int kSkvKeys = 64;      // keys per tile: 16 per warp
constexpr int kSkvWarps = 4;
constexpr int kSkvThreads = 32 * kSkvWarps;
constexpr int kSkvStages = 2;
constexpr int kSkvMaxSplits = 8;  // blocks per cluster
constexpr int kSkvSplitStep = 16; // kc, the keys per split, is a multiple

template <int DH>
struct SkvShape {
  static constexpr int kPitch = DH + 8;  // bf16 per staged row: ldmatrix
  //                                        rows fall on distinct banks
  static constexpr int kSmem =
      (kSkvRows + kSkvStages * 2 * kSkvKeys) * kPitch * 2;
  // After the walk the same memory holds the warps' partials and the
  // block's: acc [warps + 1][16][DH] and (m, l, flag) per row.
  static constexpr int kPartFloats =
      (kSkvWarps + 1) * kSkvRows * DH + 3 * (kSkvWarps + 1) * kSkvRows;
  static_assert(kPartFloats * 4 <= kSmem, "partials exceed the ring");
};

// Block (s, bh) of cluster bh walks keys [s·kc, min((s+1)·kc, limit)).
template <int DH>
__global__ void __launch_bounds__(kSkvThreads)
flash_splitkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ q_pos,
              const int* __restrict__ kv_len, bf16* __restrict__ out, int Hkv,
              int G, int Tq, int Tk, Strides st, int causal, int window,
              float scale_log2, int kc) {
  namespace cg = cooperative_groups;
  using Sh = SkvShape<DH>;
  constexpr int P = Sh::kPitch, kChunks = DH / 8;
  extern __shared__ __align__(16) uint8_t skv_smem[];
  __shared__ int pos_s[kSkvRows];
  bf16* const qs = reinterpret_cast<bf16*>(skv_smem);
  bf16* const ring = qs + kSkvRows * P;  // [stage][K, V][key][P]
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x, splits = gridDim.x;  // the cluster spans x
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int R = G * Tq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid < kSkvRows) pos_s[tid] = row_pos(q_pos, st, b, tid, R, Tq);
  for (int e = tid; e < kSkvRows * kChunks; e += kSkvThreads) {
    const int r = e / kChunks, c = e % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const int g = r / Tq, t = r % Tq;
      val = *reinterpret_cast<const uint4*>(
          q + b * st.qb + t * st.qt + (h * G + g) * st.qh + 8 * c);
    }
    *reinterpret_cast<uint4*>(qs + r * P + 8 * c) = val;
  }
  __syncthreads();

  int lo, hi;
  pos_range(pos_s, R, lane, lo, hi);
  const int kvl = valid_len(kv_len, b, Tk);
  const int limit = causal ? min(kvl, hi + 1) : kvl;
  const int kb0 = split * kc, kend = min(kb0 + kc, limit);
  const int ntiles = kend > kb0 ? (kend - kb0 + kSkvKeys - 1) / kSkvKeys : 0;

  // Tile i into stage i % 2: K then V rows, 16 bytes per copy; keys at or
  // past kend are zero-filled and not read.
  auto load_tile = [&](int i) {
    bf16* const stage = ring + (i % kSkvStages) * 2 * kSkvKeys * P;
    for (int e = tid; e < 2 * kSkvKeys * kChunks; e += kSkvThreads) {
      const int which = e / (kSkvKeys * kChunks);
      const int key = (e / kChunks) % kSkvKeys, c = e % kChunks;
      const int kp = kb0 + i * kSkvKeys + key;
      const bool live = kp < kend;
      const long long row = live ? kp : kb0;
      const bf16* src = which == 0
                            ? k + b * st.kb + row * st.kt + h * st.kh + 8 * c
                            : v + b * st.vb + row * st.vt + h * st.vh + 8 * c;
      cp_async16(smem_u32(stage + (which * kSkvKeys + key) * P + 8 * c), src,
                 live ? 16 : 0);
    }
  };
  if (ntiles > 0) load_tile(0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1);
  cp_async_commit();

  // Q's A fragments, all dh / 16 k steps, held for the whole walk; at dh
  // 256 the 128 registers of o leave no room for its 64, so each tile
  // reads them again from qs (which stays put until the walk ends).
  constexpr bool kQRegs = DH <= 128;
  uint32_t qa[kQRegs ? DH / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ldmatrix_x4(qa[kk], qs + (lane % 16) * P + kk * 16 + (lane / 16) * 8);
  }

  const int g4 = lane / 4, t4 = lane % 4;  // fragment row, column pair
  const int pr[2] = {pos_s[g4], pos_s[g4 + 8]};
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  bool f[2] = {false, false};

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<1>();  // tile i landed; tile i + 1 may be in flight
    __syncthreads();
    const bf16* const ks =
        ring + (i % kSkvStages) * 2 * kSkvKeys * P + warp * 16 * P;
    const bf16* const vs = ks + kSkvKeys * P;
    const int kw = kb0 + i * kSkvKeys + warp * 16;  // this warp's 16 keys
    if (kw < kend) {
      // S [16 rows x 16 keys]: n-tiles of keys 0-7 and 8-15.
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t bk[4];
        const int mi = lane / 8;
        ldmatrix_x4(bk, ks + ((mi / 2) * 8 + lane % 8) * P + kk * 16 +
                            (mi % 2) * 8);
        if constexpr (kQRegs) {
          mma_16816(sc[0], qa[kk], bk[0], bk[1]);
          mma_16816(sc[1], qa[kk], bk[2], bk[3]);
        } else {
          uint32_t qf[4];
          ldmatrix_x4(qf, qs + (lane % 16) * P + kk * 16 + (lane / 16) * 8);
          mma_16816(sc[0], qf, bk[0], bk[1]);
          mma_16816(sc[1], qf, bk[2], bk[3]);
        }
      }
      // The online softmax as on the tile: masked raw scores -inf, the
      // integer row maxima of the scaled scores, P = exp2(s·scale - m).
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kw + 8 * j + 2 * t4 + (e & 1);
          const bool ok =
              kp < kend && key_ok(kp, pr[e / 2], kvl, causal, window);
          const float s = ok ? sc[j][e] : kMasked;
          f[e / 2] = f[e / 2] || ok;
          sc[j][e] = s;
          mx[e / 2] = fmaxf(mx[e / 2], s);
        }
      }
      float al[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], ceilf(quad_max(mx[r]) * scale_log2));
        al[r] = pow2_int(m[r] - mn);
        m[r] = mn;
      }
      float ex[2][4], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ex[j][e] = exp2_fast(fmaf(sc[j][e], scale_log2, -m[e / 2]));
          sum[e / 2] += ex[j][e];
        }
      }
      // P's A fragment over the warp's 16 keys.
      const uint32_t pa[4] = {pack_bf16(ex[0][0], ex[0][1]),
                              pack_bf16(ex[0][2], ex[0][3]),
                              pack_bf16(ex[1][0], ex[1][1]),
                              pack_bf16(ex[1][2], ex[1][3])};
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + sum[r];
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[n][0] *= al[0];
        o[n][1] *= al[0];
        o[n][2] *= al[1];
        o[n][3] *= al[1];
      }
      // O += P·V: V rows transposed by ldmatrix, 16 dims per step.
#pragma unroll
      for (int n2 = 0; n2 < DH / 16; ++n2) {
        uint32_t bv[4];
        const int mi = lane / 8;
        ldmatrix_x4_trans(bv, vs + ((mi % 2) * 8 + lane % 8) * P + n2 * 16 +
                                  (mi / 2) * 8);
        mma_16816(o[2 * n2], pa, bv[0], bv[1]);
        mma_16816(o[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with stage i % 2
    if (i + 2 < ntiles) load_tile(i + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // The warps' partials, then the block's, in shared memory (over the
  // ring): acc [warp][row][DH], m, l, flag [warp][row]; the block's at
  // index kSkvWarps.
  float* const acc = reinterpret_cast<float*>(skv_smem);
  float* const pm = acc + (kSkvWarps + 1) * kSkvRows * DH;
  float* const pl = pm + (kSkvWarps + 1) * kSkvRows;
  float* const pf = pl + (kSkvWarps + 1) * kSkvRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    f[r] = quad_any(f[r]);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    float* const a0 = acc + (warp * kSkvRows + g4) * DH + 8 * n + 2 * t4;
    a0[0] = o[n][0];
    a0[1] = o[n][1];
    a0[8 * DH] = o[n][2];
    a0[8 * DH + 1] = o[n][3];
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = warp * kSkvRows + g4 + 8 * r;
      pm[i] = m[r];
      pl[i] = l[r];
      pf[i] = f[r] ? 1.f : 0.f;
    }
  }
  __syncthreads();

  // Block: the warps' (m, l, acc) in warp order, each weighted by
  // 2^(m_w - M) over the flagged ones (exact powers of two).
  constexpr int kB = kSkvWarps * kSkvRows;  // the block's partial index
  for (int e = tid; e < kSkvRows * DH; e += kSkvThreads) {
    const int r = e / DH, d = e % DH;
    float M = kNegInf;
    bool any = false;
#pragma unroll
    for (int w = 0; w < kSkvWarps; ++w) {
      if (pf[w * kSkvRows + r] != 0.f) {
        M = fmaxf(M, pm[w * kSkvRows + r]);
        any = true;
      }
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kSkvWarps; ++w) {
      if (pf[w * kSkvRows + r] != 0.f) {
        const float wt = pow2_int(pm[w * kSkvRows + r] - M);
        L += wt * pl[w * kSkvRows + r];
        O += wt * acc[(w * kSkvRows + r) * DH + d];
      }
    }
    acc[(kB + r) * DH + d] = O;
    if (d == 0) {
      pm[kB + r] = M;
      pl[kB + r] = L;
      pf[kB + r] = any ? 1.f : 0.f;
    }
  }
  cluster.sync();  // every block's partial is written

  // Cluster: the blocks' partials in rank order, read from their shared
  // memory; O / L, or zeros for a row no block saw a valid key of.
  for (int e = split * kSkvThreads + tid; e < R * DH;
       e += splits * kSkvThreads) {
    const int r = e / DH, d = e % DH;
    float rm[kSkvMaxSplits], rl[kSkvMaxSplits], ra[kSkvMaxSplits];
    bool rf[kSkvMaxSplits];
#pragma unroll
    for (int c = 0; c < kSkvMaxSplits; ++c) {
      if (c < splits) {
        rf[c] = *cluster.map_shared_rank(pf + kB + r, c) != 0.f;
        rm[c] = *cluster.map_shared_rank(pm + kB + r, c);
        rl[c] = *cluster.map_shared_rank(pl + kB + r, c);
        ra[c] = *cluster.map_shared_rank(acc + (kB + r) * DH + d, c);
      } else {
        rf[c] = false;
      }
    }
    float M = kNegInf;
    bool any = false;
#pragma unroll
    for (int c = 0; c < kSkvMaxSplits; ++c) {
      if (rf[c]) {
        M = fmaxf(M, rm[c]);
        any = true;
      }
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int c = 0; c < kSkvMaxSplits; ++c) {
      if (rf[c]) {
        const float wt = pow2_int(rm[c] - M);
        L += wt * rl[c];
        O += wt * ra[c];
      }
    }
    const int g = r / Tq, t = r % Tq;
    out[b * st.ob + t * st.ot + (h * G + g) * st.oh + d] =
        __float2bfloat16_rn(any ? O / fmaxf(L, 1e-20f) : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its memory
}

// ---------------------------------------------------------------------------
// Launch: the plan, checked, then exactly its grid
// ---------------------------------------------------------------------------

enum Route { kSimt = 0, kWgmma = 1, kSplitkv = 2 };

struct Call {
  const void *q, *k, *v, *q_pos, *kv_len;
  void* out;
  int B, Hkv, G, Tq, Tk, dh;
  Strides st;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_simt(const Call& c, dim3 grid) {
  int smem = 0;
  if constexpr (kSimtDynamic<DH>) {
    static bool configured[kMaxDevices] = {};
    smem = sizeof(SimtSmem<DH>);
    cudaError_t e = opt_in_smem(flash_simt<DH>, smem, configured);
    if (e != cudaSuccess) return e;
  }
  flash_simt<DH><<<grid, kSimtWarps * 32, smem, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const int*>(c.q_pos),
      static_cast<const int*>(c.kv_len), static_cast<float*>(c.out), c.Hkv,
      c.G, c.Tq, c.Tk, c.st, c.causal, c.window, c.scale);
  return cudaSuccess;
}

template <int DH>
cudaError_t launch_wgmma(const Call& c, dim3 grid) {
  using Sh = WgShape<DH>;
  static bool configured[kMaxDevices] = {};
  cudaError_t e = opt_in_smem(flash_wgmma<DH>, Sh::kSmem, configured);
  if (e != cudaSuccess) return e;
  // {dh, Hkv, Tk, B}: dh contiguous, strides in bytes.
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c.dh),
                              static_cast<cuuint64_t>(c.Hkv),
                              static_cast<cuuint64_t>(c.Tk),
                              static_cast<cuuint64_t>(c.B)};
  const cuuint64_t ks[3] = {static_cast<cuuint64_t>(c.st.kh) * 2,
                            static_cast<cuuint64_t>(c.st.kt) * 2,
                            static_cast<cuuint64_t>(c.st.kb) * 2};
  const cuuint64_t vs[3] = {static_cast<cuuint64_t>(c.st.vh) * 2,
                            static_cast<cuuint64_t>(c.st.vt) * 2,
                            static_cast<cuuint64_t>(c.st.vb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(Sh::kKeys), 1};
  CUtensorMap tmk, tmv;
  if (!tensor_map_nd(&tmk, c.k, 4, dims, ks, box) ||
      !tensor_map_nd(&tmv, c.v, 4, dims, vs, box))
    return cudaErrorInvalidValue;
  flash_wgmma<DH><<<grid, kWgThreads, Sh::kSmem, c.stream>>>(
      tmk, tmv, static_cast<const bf16*>(c.q),
      static_cast<const int*>(c.q_pos), static_cast<const int*>(c.kv_len),
      static_cast<bf16*>(c.out), c.B, c.Hkv, c.G, c.Tq, c.Tk, c.st, c.causal,
      c.window, c.scale * kLog2e);
  return cudaSuccess;
}

template <int DH>
cudaError_t launch_splitkv(const Call& c, dim3 grid, int kc) {
  using Sh = SkvShape<DH>;
  static bool configured[kMaxDevices] = {};
  cudaError_t e = opt_in_smem(flash_splitkv<DH>, Sh::kSmem, configured);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSkvThreads);
  cfg.dynamicSmemBytes = Sh::kSmem;
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, flash_splitkv<DH>, static_cast<const bf16*>(c.q),
      static_cast<const bf16*>(c.k), static_cast<const bf16*>(c.v),
      static_cast<const int*>(c.q_pos), static_cast<const int*>(c.kv_len),
      static_cast<bf16*>(c.out), c.Hkv, c.G, c.Tq, c.Tk, c.st, c.causal,
      c.window, c.scale * kLog2e, kc);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// One instantiation per head dim this file takes: f<32>() ... f<256>().
template <typename F>
auto by_dh(int dh, F&& f) {
  switch (dh) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return f(std::integral_constant<int, 256>());
  }
}
bool dh_ok(int dh) {
  return dh == 32 || dh == 64 || dh == 80 || dh == 128 || dh == 256;
}

// The dynamic shared memory each route's kernel is launched with.
int smem_bytes(int route, int dh) {
  return by_dh(dh, [&](auto d) -> int {
    constexpr int DH = decltype(d)::value;
    switch (route) {
      case kWgmma: return WgShape<DH>::kSmem;
      case kSplitkv: return SkvShape<DH>::kSmem;
      default:
        return kSimtDynamic<DH> ? static_cast<int>(sizeof(SimtSmem<DH>)) : 0;
    }
  });
}
// Keys per K/V tile of the tensor-core tile.
int wg_keys(int dh) {
  return by_dh(dh, [](auto d) { return WgShape<decltype(d)::value>::kKeys; });
}

int launch(const Call& c, bool is_bf16, int route, int tile_r, int tile_k,
           int splits, int kc, int grid_x, int grid_y, int smem) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int R = c.G * c.Tq, BH = c.B * c.Hkv;
  if (!dh_ok(c.dh)) return bad;
  if (smem != smem_bytes(route, c.dh)) return bad;
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (is_bf16) {
    const Strides& s = c.st;
    if (!a16(c.q) || !a16(c.k) || !a16(c.v) || !a16(c.out) ||
        (s.qb | s.qt | s.qh | s.kb | s.kt | s.kh | s.vb | s.vt | s.vh | s.ob |
         s.ot | s.oh) % 8 != 0)
      return bad;
  }
  dim3 grid(grid_x, grid_y);
  cudaError_t e = cudaErrorInvalidValue;
  if (!is_bf16) {
    if (route != kSimt || tile_r != kSimtRows || tile_k != kSimtKeys ||
        splits != 1 || kc != 0 || grid_x != cdiv(R, kSimtRows) ||
        grid_y != BH)
      return bad;
    if (R == 0 || BH == 0) return static_cast<int>(cudaGetLastError());
    e = by_dh(c.dh, [&](auto d) {
      return launch_simt<decltype(d)::value>(c, grid);
    });
  } else if (route == kWgmma) {
    const int items = BH * cdiv(R, kWgRows);
    if (tile_r != kWgRows || tile_k != wg_keys(c.dh) || splits != 1 ||
        kc != 0 ||
        grid_x != (items < kWgMaxBlocks ? items : kWgMaxBlocks) ||
        grid_y != 1)
      return bad;
    if (R == 0 || BH == 0) return static_cast<int>(cudaGetLastError());
    e = by_dh(c.dh, [&](auto d) {
      return launch_wgmma<decltype(d)::value>(c, grid);
    });
  } else if (route == kSplitkv) {
    if (R > kSkvRows || tile_r != kSkvRows || tile_k != kSkvKeys || kc <= 0 ||
        kc % kSkvSplitStep != 0 || splits < 1 || splits > kSkvMaxSplits ||
        splits != (c.Tk > kc ? cdiv(c.Tk, kc) : 1) || grid_x != splits ||
        grid_y != BH)
      return bad;
    if (R == 0 || BH == 0) return static_cast<int>(cudaGetLastError());
    e = by_dh(c.dh, [&](auto d) {
      return launch_splitkv<decltype(d)::value>(c, grid, kc);
    });
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

Call make_call(const void* q, const void* k, const void* v, const void* q_pos,
               const void* kv_len, void* out, int B, int Hkv, int G, int Tq,
               int Tk, int dh, const long long* s, int causal, int window,
               float scale, void* stream) {
  return Call{q, k, v, q_pos, kv_len, out, B, Hkv, G, Tq, Tk, dh,
              Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                      s[9], s[10], s[11], s[12], s[13]},
              causal, window, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q [B, Tq, Hq = Hkv·G, dh]; k/v [B, Tk, Hkv, dh]; out [B, Tq, Hq, dh]: one
// storage type, unit stride along dh, other strides (in elements) given in
// `strides` as (q: b, t, h), (k: b, t, h), (v: b, t, h), (out: b, t, h),
// (q_pos: b, t).  q_pos int32 [B, Tq] (-1 = pad row); kv_len int32 [B] or
// null (= Tk).  dh in {32, 64, 80, 128, 256}.  The plan (route 0 simt, 1 wgmma, 2
// splitkv; tile_r rows x tile_k keys per block; the split-KV route's
// `splits` blocks per cluster of kc keys each; the grid; the dynamic shared
// memory) comes from the caller's plan() (kernels/flash_attention.py) and
// is launched exactly: one that disagrees with what this file
// instantiates, or bf16 operands not 16-byte aligned, returns
// cudaErrorInvalidValue before anything is launched.  Returns the first
// CUDA error, else cudaGetLastError().
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* q_pos,
                                    const void* kv_len, void* out, int B,
                                    int Hkv, int G, int Tq, int Tk, int dh,
                                    const long long* strides, int causal,
                                    int window, float scale, int route,
                                    int tile_r, int tile_k, int splits,
                                    int kc, int grid_x, int grid_y, int smem,
                                    void* stream) {
  return launch(make_call(q, k, v, q_pos, kv_len, out, B, Hkv, G, Tq, Tk, dh,
                          strides, causal, window, scale, stream),
                true, route, tile_r, tile_k, splits, kc, grid_x, grid_y,
                smem);
}
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* kv_len,
                                   void* out, int B, int Hkv, int G, int Tq,
                                   int Tk, int dh, const long long* strides,
                                   int causal, int window, float scale,
                                   int route, int tile_r, int tile_k,
                                   int splits, int kc, int grid_x, int grid_y,
                                   int smem, void* stream) {
  return launch(make_call(q, k, v, q_pos, kv_len, out, B, Hkv, G, Tq, Tk, dh,
                          strides, causal, window, scale, stream),
                false, route, tile_r, tile_k, splits, kc, grid_x, grid_y,
                smem);
}
