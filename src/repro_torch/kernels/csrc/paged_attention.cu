// Paged decode attention over the §4.4 store-once entry stream.
//
// Replaces the TPU kernel paged_attention_packed
// (src/repro/kernels/paged_attention.py:99) together with the fold of the
// in-flight token in ops.paged_decode_attention (src/repro/kernels/ops.py):
// one query token per slot attends to the slot's page chain, masked by
// effective position (eff_pos <= q_pos; the history sentinel is int32
// max), plus its own (k_tok, v_tok), which is committed to the store only
// after the step.  Output [B, 1, Hq, dh] in q's type, divided by
// max(l, 1e-20).  The online softmax is fp32; its running maximum starts
// at NEG_INF = -1e30 and is never -inf.
//
// Bound.  Decode attention is bound by the bytes it must read.  The chain
// holds every layer's entries (a token stores 1 + Σ gates of them, ~16.5
// at keep 0.5 over 32 layers), token-major, and exactly one entry per
// token is valid at any layer.  The TPU kernel walks every page at every
// layer and masks entry by entry: an L·keep-fold read amplification.
// Nearly every page holds one valid entry for each layer, so skipping
// whole pages saves nothing.  Both routes read the small eff_pos row (4 B
// per entry) and load K/V only for the entries it admits.
//
// Two routes.  The wrapper's plan() (kernels/paged_attention.py) picks one
// by q's dtype and G = Hq / Hkv alone, with its head grouping, split, ring
// and grid; the C entries launch exactly that and refuse a plan this file
// has no instantiation of.
//
// 1. bf16 q, G <= 16: the cluster split walk (paged_split; the main
//    path's decode).  At the full shape (B 4, 32 kv-heads, G 1, dh 128, a
//    16384-entry row of which 512 are admitted) a call must read 33.8 MB
//    of bf16 K/V rows (10.1 µs at 3.35 TB/s).  The SIMT kernel (route 2)
//    took 7× that, and development builds of it showed why: with its K/V
//    loads compiled out it kept 0.020 of its 0.070 ms, without its per-row
//    reductions all of it (PERF.md, Findings).  It waited on loads:
//    each warp had 8 dependent rows in flight, a block on one SM in two,
//    and every head's block rescanned the slot's whole eff_pos row.
//    One thread-block cluster per (slot, group of HB kv-heads), HB in
//    {1, 2, 4}, S <= 8 blocks (the portable cluster size), 4 warps each;
//    plan() aims at 256 blocks and at most 73 KB of shared memory and 168
//    registers a thread, so that three fit an SM (at two, clusters of 8
//    no longer all fit at once and the launch ran as two waves).
//    - One scan per cluster, shared by its heads.  The slot's row goes in
//      windows of S slices of at most 4096 entries (one window at the main
//      path's 16-17 k).  Each rank tests its slice, 32 entries a thread
//      with 16-byte loads, and publishes the admitted bits of each thread,
//      their prefix and its count in shared memory.  After cluster.sync()
//      rank s takes the admitted entries whose index in the window's
//      admitted order lies in [⌊s·n/S⌋, ⌊(s+1)·n/S⌋): balanced by admitted
//      entries, not by entry range (about half of a row lies past the
//      slot's fill).  It lists them in entry order from the ranks' bits
//      (distributed shared memory), at most 1024 a round, and resolves
//      their pages through block_table (clamped) in one parallel pass.
//    - Whole head groups gathered.  An entry's HB kv-head rows are
//      contiguous in [P, ps, Hkv, dhp]: 16-byte cp.async copies bring the
//      K and V rows of a step's 64 / HB listed entries (and their HB fp32
//      scales for int8 and int4 pages) into one stage of a 2-4 stage ring
//      while the step before is consumed; entries past the list are
//      zero-filled and masked.  A step gives each warp 16 entries of one
//      head: with HB < 4 several warps share a head, and their partials
//      are added in warp order before the cluster's.
//    - Tensor cores.  S = Q·Kᵀ and O += P·V with mma.sync m16n8k16 from
//      ldmatrix, the G query heads padded to 16 rows, Q's fragments held in
//      registers for the whole walk (warp_mma.cuh, shared with
//      flash_attention.cu's split-KV walk).  A warp turns its int8 or int4
//      codes into bf16 in its own 16-row tile by integer tricks alone,
//      exactly (|code| <= 127), K's and then V's; the per-(entry, head)
//      scales, powers of two (kvcache/paged.py), multiply S's columns and
//      P's before its rounding, also exactly, so every page type feeds the
//      same bf16 product.  An entry-major tile 16 entries deep was the
//      fastest of those measured: 8 entries a warp-step, more blocks (HB
//      1-2), a smaller tile, or int8/int4 fragments built from the codes
//      in registers (no bf16 tile) each took more time.
//    - The softmax rounds as flash's split-KV walk: an integer running
//      maximum of the scaled scores (every rescale an exact power of two),
//      P = exp2(s·scale·log2 e - m) rounded once to bf16 for P·V, l summed
//      in fp32.  The in-flight token's score is one more mma chain.
//    - The ranks' (m, l, acc) are added in rank order through distributed
//      shared memory, then the in-flight token is folded in and the row
//      written: one launch, no atomics, no scratch, no state kept.
//
// 2. fp32 q, or G > 16: the SIMT kernel (paged_simt; the earlier design
//    unchanged, now the parity route).  One block per (slot, KV head,
//    group of GR query heads).  Each of the 8 warps scans its own
//    256-entry chunks of eff_pos, compacts the admitted entry indices in
//    order into its own shared list with ballots, then gathers those
//    entries' K and V rows 8 at a time (lane l owns dims [l·dh/32,
//    (l+1)·dh/32)) and runs an fp32 online softmax; int8/int4 payloads
//    are dequantized in the walk.  The warps' states merge in shared
//    memory, then the in-flight token is folded in.
//
// int4 pages: byte d holds dim d in its low nibble and dim d + dh/2 in its
// high nibble, each sign-extended.
#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1.0e30f;

enum Payload { kNative = 0, kInt8 = 1, kInt4 = 2 };
enum Route { kSimt = 0, kSplit = 1 };

// ---------------------------------------------------------------------------
// Route 2: the SIMT kernel (fp32 q, or G > 16)
// ---------------------------------------------------------------------------

constexpr int kSimtWarps = 8;
constexpr int kSimtPerLane = 8;             // eff_pos loads a lane per chunk
constexpr int kSimtChunk = 32 * kSimtPerLane;  // entries a warp scans a chunk
constexpr int kSimtGroup = 8;               // admitted rows gathered at once
constexpr int kSimtMaxRows = 4;             // query heads a block may own

template <int BYTES> struct Raw;
template <> struct Raw<1> { using T = uint8_t; };
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

template <typename V, int N>
__device__ __forceinline__ void load_vec(const V* p, V (&out)[N]) {
  using R = typename Raw<sizeof(V) * N>::T;
  const R r = *reinterpret_cast<const R*>(p);
  memcpy(out, &r, sizeof(R));
}

// The lane's DPL dims [lane·DPL, (lane+1)·DPL) of one payload row as fp32
// codes (native rows: the values; quantized rows: before the scale).
template <typename T, int PAY, int DH>
__device__ __forceinline__ void load_row(const void* pages, long long row,
                                         int lane, float (&out)[DH / 32]) {
  constexpr int DPL = DH / 32;
  if constexpr (PAY == kNative) {
    T v[DPL];
    load_vec<T, DPL>(static_cast<const T*>(pages) + row * DH + lane * DPL,
                     v);
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = repro::to_f32(v[i]);
  } else if constexpr (PAY == kInt8) {
    int8_t v[DPL];
    load_vec<int8_t, DPL>(
        static_cast<const int8_t*>(pages) + row * DH + lane * DPL, v);
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = static_cast<float>(v[i]);
  } else {
    // lanes 0-15 own the low nibbles (dims < dh/2), lanes 16-31 the high
    // nibbles of the same bytes (dims >= dh/2)
    uint8_t v[DPL];
    load_vec<uint8_t, DPL>(static_cast<const uint8_t*>(pages) +
                               row * (DH / 2) + (lane & 15) * DPL,
                           v);
    const int shift = lane < 16 ? 0 : 4;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      out[i] = static_cast<float>((((v[i] >> shift) & 0xF) ^ 8) - 8);
  }
}

template <typename T, int PAY, int DH, int GR>
__global__ void __launch_bounds__(kSimtWarps * 32)
paged_simt(const T* __restrict__ q, const void* __restrict__ k_pages,
             const void* __restrict__ v_pages,
             const float* __restrict__ k_scales,
             const float* __restrict__ v_scales,
             const int* __restrict__ block_table,
             const int* __restrict__ eff_pos, const T* __restrict__ k_tok,
             const T* __restrict__ v_tok, const int* __restrict__ q_pos,
             T* __restrict__ out, int P, int ps, int Hkv, int G, int J,
             float scale) {
  constexpr int DPL = DH / 32;
  __shared__ int admitted[kSimtWarps][kSimtChunk];
  __shared__ float sm_m[kSimtWarps][GR], sm_l[kSimtWarps][GR];
  __shared__ float sm_acc[kSimtWarps][GR][DH];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int g0 = blockIdx.y * GR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Hq = Hkv * G;
  const int E = J * ps;
  const int qp = q_pos[b];
  const int* ep = eff_pos + static_cast<long long>(b) * E;
  const int* bt = block_table + static_cast<long long>(b) * J;

  float qr[GR][DPL], m[GR], l[GR], acc[GR][DPL];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int g = g0 + r;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = g < G ? repro::to_f32(
                             q[(static_cast<long long>(b) * Hq + h * G + g) *
                                   DH +
                               lane * DPL + i]) *
                             scale
                       : 0.f;
    }
  }

  const int n_chunks = (E + kSimtChunk - 1) / kSimtChunk;
  int next[kSimtPerLane];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int k = 0; k < kSimtPerLane; ++k) {
      const int e = c * kSimtChunk + k * 32 + lane;
      next[k] = e < E ? ep[e] : 0;
    }
  };
  if (warp < n_chunks) load_chunk(warp);

  for (int c = warp; c < n_chunks; c += kSimtWarps) {
    // compact this chunk's admitted entries, in order, into the warp's list
    int n = 0;
#pragma unroll
    for (int k = 0; k < kSimtPerLane; ++k) {
      const int e = c * kSimtChunk + k * 32 + lane;
      const bool ok = e < E && next[k] <= qp;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) admitted[warp][n + __popc(bal & ((1u << lane) - 1u))] = e;
      n += __popc(bal);
    }
    __syncwarp();
    if (c + kSimtWarps < n_chunks) load_chunk(c + kSimtWarps);   // prefetch

    for (int i0 = 0; i0 < n; i0 += kSimtGroup) {
      float kv[kSimtGroup][DPL], vv[kSimtGroup][DPL], ksc[kSimtGroup],
          vsc[kSimtGroup];
#pragma unroll
      for (int u = 0; u < kSimtGroup; ++u) {
        ksc[u] = vsc[u] = 1.f;
        if (i0 + u < n) {
          const int e = admitted[warp][i0 + u];
          const int page = min(max(bt[e / ps], 0), P - 1);
          const long long row =
              (static_cast<long long>(page) * ps + e % ps) * Hkv + h;
          load_row<T, PAY, DH>(k_pages, row, lane, kv[u]);
          load_row<T, PAY, DH>(v_pages, row, lane, vv[u]);
          if constexpr (PAY != kNative) {
            ksc[u] = k_scales[row];
            vsc[u] = v_scales[row];
          }
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) kv[u][i] = vv[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        float s[kSimtGroup];
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < kSimtGroup; ++u) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) d = fmaf(qr[r][i], kv[u][i], d);
          s[u] = repro::warp_sum(d) * ksc[u];
          if (i0 + u < n) mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[r] - mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kSimtGroup; ++u) {
          s[u] = i0 + u < n ? expf(s[u] - mx) : 0.f;
          psum += s[u];
          s[u] *= vsc[u];
        }
        l[r] = l[r] * alpha + psum;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[r][i] * alpha;
#pragma unroll
          for (int u = 0; u < kSimtGroup; ++u) a = fmaf(s[u], vv[u][i], a);
          acc[r][i] = a;
        }
        m[r] = mx;
      }
    }
    __syncwarp();   // the list is rewritten by the next chunk
  }

  // merge the warps' online-softmax states
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][r][lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  if (warp >= GR) return;
  const int r = warp, g = g0 + r;
  if (g >= G) return;
  float M = kNegInf;
  for (int w = 0; w < kSimtWarps; ++w) M = fmaxf(M, sm_m[w][r]);
  float L = 0.f, A[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) A[i] = 0.f;
  for (int w = 0; w < kSimtWarps; ++w) {
    const float f = expf(sm_m[w][r] - M);
    L += sm_l[w][r] * f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) A[i] += sm_acc[w][r][lane * DPL + i] * f;
  }

  // fold in the in-flight token (always causally valid: its pos == q_pos);
  // the row's q is picked with compile-time indices so qr stays in
  // registers
  float qrow[DPL];
#pragma unroll
  for (int rr = 0; rr < GR; ++rr)
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (rr == r) qrow[i] = qr[rr][i];
  const long long tok = (static_cast<long long>(b) * Hkv + h) * DH +
                        lane * DPL;
  float qk = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    qk = fmaf(qrow[i], repro::to_f32(k_tok[tok + i]), qk);
  const float s_tok = repro::warp_sum(qk);
  const float m2 = fmaxf(M, s_tok);
  const float alpha = expf(M - m2), p_tok = expf(s_tok - m2);
  const float den = fmaxf(L * alpha + p_tok, 1e-20f);
  T* o = out + (static_cast<long long>(b) * Hq + h * G + g) * DH + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    o[i] = repro::from_f32<T>(
        (A[i] * alpha + p_tok * repro::to_f32(v_tok[tok + i])) / den);
}


// ---------------------------------------------------------------------------
// Route 1: the cluster split walk (bf16 q, G <= 16)
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitRows = 16;          // mma rows: the G query heads
constexpr int kSub = 16;                // entries a warp takes per step
constexpr int kHeadEntries = kSplitWarps * kSub;  // heads x entries a step
constexpr int kSplitMaxS = 8;           // blocks per cluster
constexpr int kSplitMinStages = 2, kSplitMaxStages = 4;
constexpr int kScanPerThread = 32;      // contiguous eff_pos tests a thread
constexpr int kWinSlice = kSplitThreads * kScanPerThread;  // a slice, at most
constexpr int kListCap = 1024;          // listed rows a round
constexpr int kSmemMax = 74752;         // dynamic bytes: three blocks per SM

// Sizes (bytes) of the split walk's shared memory.  A step stages the K
// and V rows of `tile` = 64 / HB listed entries for HB kv-heads: as bf16,
// an entry's HB rows side by side, HB·dh + 8 wide (ldmatrix rows on
// distinct banks); as codes, HB rows of row_bytes and HB fp32 scales.
// int8 and int4 codes are turned into bf16 by each warp in its own tile
// of 16 rows dh + 8 wide, K's rows and then V's.  After the walk the same
// memory holds the warps' partials, acc [4][16][dh] fp32.  Then the list
// of pool rows.
__host__ __device__ constexpr int row_bytes(int pay, int dh) {
  return pay == kNative ? 2 * dh : pay == kInt8 ? dh : dh / 2;
}
__host__ __device__ constexpr int entry_pitch(int heads, int dh) {
  return heads * dh + 8;  // bf16
}
__host__ __device__ constexpr int step_entries(int heads) {
  return kHeadEntries / heads;
}
__host__ __device__ constexpr int stage_bytes(int pay, int heads, int dh) {
  return pay == kNative
             ? 2 * step_entries(heads) * entry_pitch(heads, dh) * 2
             : 2 * kHeadEntries * (row_bytes(pay, dh) + 4);
}
__host__ __device__ constexpr int warp_tile_bytes(int dh) {
  return kSub * (dh + 8) * 2;
}
__host__ __device__ constexpr int split_smem(int pay, int heads, int dh,
                                             int stages) {
  const int walk = stages * stage_bytes(pay, heads, dh) +
                   (pay == kNative ? 0 : kSplitWarps * warp_tile_bytes(dh));
  const int part = kSplitWarps * kSplitRows * dh * 4;
  return (walk > part ? walk : part) + kListCap * 4;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// Returns once at most n (0-2) committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// Exclusive prefix sum of v over the block (thread order); total = Σ v.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int pre = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) {
    const int t = warp_tot[w];
    if (w < warp) pre += t;
    total += t;
  }
  __syncthreads();  // warp_tot is rewritten by the next call
  return pre + inc - v;
}

// Codes as exact bf16 pairs, by integer tricks alone.  int8: byte u of
// x = w ^ 0x80808080 is c + 128; the float with bits 0x4B0000uu is
// 2^23 + u, less 2^23 + 128 it is c, and its upper half is bf16(c).
// int4: nibble n of x = w ^ 0x88888888 is c + 8; bf16 bits 0x4300 | n are
// 128 + n, less 136 they are c.
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t x, int sel_lo,
                                              int sel_hi) {
  const float lo = __int_as_float(__byte_perm(x, 0x4B000000u, sel_lo)) -
                   8388736.f;
  const float hi = __int_as_float(__byte_perm(x, 0x4B000000u, sel_hi)) -
                   8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint32_t s4x2_bf16(uint32_t t) {
  const uint32_t b = (t & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&b),
      __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// 16 raw bytes of a code row (chunk c) as bf16 into a warp tile row.
template <int PAY, int DH>
__device__ __forceinline__ void codes_to_bf16(uint4 raw, int c, bf16* row) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
  if constexpr (PAY == kInt8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
      o[2 * i] = s8x2_bf16(x, 0x7440, 0x7441);
      o[2 * i + 1] = s8x2_bf16(x, 0x7442, 0x7443);
    }
    *reinterpret_cast<uint4*>(row + 16 * c) = make_uint4(o[0], o[1], o[2],
                                                         o[3]);
    *reinterpret_cast<uint4*>(row + 16 * c + 8) =
        make_uint4(o[4], o[5], o[6], o[7]);
  } else {
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x88888888u;
      const uint32_t t0 = __byte_perm(x, 0, 0x4140);  // bytes 0, 1
      const uint32_t t1 = __byte_perm(x, 0, 0x4342);  // bytes 2, 3
      o[2 * i] = s4x2_bf16(t0);
      o[2 * i + 1] = s4x2_bf16(t1);
      h[2 * i] = s4x2_bf16(t0 >> 4);
      h[2 * i + 1] = s4x2_bf16(t1 >> 4);
    }
    // byte d: dim d (low nibble), dim d + dh/2 (high nibble)
    *reinterpret_cast<uint4*>(row + 16 * c) = make_uint4(o[0], o[1], o[2],
                                                         o[3]);
    *reinterpret_cast<uint4*>(row + 16 * c + 8) =
        make_uint4(o[4], o[5], o[6], o[7]);
    *reinterpret_cast<uint4*>(row + DH / 2 + 16 * c) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(row + DH / 2 + 16 * c + 8) =
        make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// The admitted bits of eff_pos entries e0 .. e0 + 31 below E (bit u:
// e0 + u).
__device__ __forceinline__ uint32_t admitted32(const int* ep, int e0, int E,
                                               int qp, bool vec) {
  uint32_t flags = 0;
#pragma unroll
  for (int k = 0; k < kScanPerThread / 4; ++k) {
    const int e = e0 + 4 * k;
    if (vec && e + 4 <= E) {
      const int4 v = *reinterpret_cast<const int4*>(ep + e);
      flags |= (static_cast<uint32_t>(v.x <= qp) |
                static_cast<uint32_t>(v.y <= qp) << 1 |
                static_cast<uint32_t>(v.z <= qp) << 2 |
                static_cast<uint32_t>(v.w <= qp) << 3)
               << (4 * k);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u < E && ep[e + u] <= qp) flags |= 1u << (4 * k + u);
    }
  }
  return flags;
}

// Block (s, b·groups + group) of cluster (b, group): see the header.
template <int PAY, int DH>
__global__ void __launch_bounds__(kSplitThreads, 3)  // three blocks per SM
paged_split(const bf16* __restrict__ q, const uint8_t* __restrict__ k_pages,
            const uint8_t* __restrict__ v_pages,
            const float* __restrict__ k_scales,
            const float* __restrict__ v_scales,
            const int* __restrict__ block_table,
            const int* __restrict__ eff_pos, const bf16* __restrict__ k_tok,
            const bf16* __restrict__ v_tok, const int* __restrict__ q_pos,
            bf16* __restrict__ out, int P, int ps, int Hkv, int G, int J,
            int HB, int stages, float scale_log2) {
  namespace cg = cooperative_groups;
  constexpr int kRow = row_bytes(PAY, DH);
  constexpr int kChunks = kRow / 16;  // 16-byte copies per kv-head row
  constexpr int WP = DH + 8;          // a warp tile's row pitch (bf16)
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int cnt_sh;
  __shared__ int warp_tot[kSplitWarps];
  __shared__ uint32_t bits_sh[kSplitThreads];
  __shared__ uint16_t pre_sh[kSplitThreads];
  __shared__ float m_sh[kSplitWarps][kSplitRows];
  __shared__ float l_sh[kSplitWarps][kSplitRows];
  __shared__ float hm_sh[kSplitWarps][kSplitRows];
  __shared__ float hl_sh[kSplitWarps][kSplitRows];
  __shared__ float tok_sh[kSplitWarps][kSplitRows];
  cg::cluster_group cluster = cg::this_cluster();

  const int S = gridDim.x, rank = blockIdx.x;  // the cluster spans x
  const int groups = (Hkv + HB - 1) / HB;
  const int b = blockIdx.y / groups, h0 = (blockIdx.y % groups) * HB;
  const int hl = min(HB, Hkv - h0);  // live heads of this group
  const int WPH = kSplitWarps / HB;  // warps per head
  const int TILE = kSub * WPH;       // entries a step
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;  // fragment row, column pair
  const int jh = warp / WPH, sub = warp % WPH;  // this warp's head, entries
  const bool live = jh < hl;
  const int h = h0 + jh;
  const int E = J * ps;
  const int qp = q_pos[b];
  const int* ep = eff_pos + static_cast<long long>(b) * E;
  const int* bt = block_table + static_cast<long long>(b) * J;
  const bool vec = E % 4 == 0 &&  // 16-byte eff_pos loads
                   reinterpret_cast<uintptr_t>(eff_pos) % 16 == 0;
  const int EP = entry_pitch(HB, DH);
  const int sbytes = stage_bytes(PAY, HB, DH);
  uint8_t* const ring = smem;
  bf16* const wt = reinterpret_cast<bf16*>(smem + stages * sbytes) +
                   warp * (warp_tile_bytes(DH) / 2);  // int8/int4 only
  int* const list = reinterpret_cast<int*>(
      smem + split_smem(PAY, HB, DH, stages) - kListCap * 4);

  // the slot's block-table row into L2 ahead of the page lookups
  for (int i = 32 * tid; i < J; i += 32 * kSplitThreads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(bt + i));
  // Q's A fragments (rows g4, g4 + 8; zero past G) and the in-flight
  // token's K row as the B fragment of entry 0 of an n-tile, in flight
  // during the scan.
  uint32_t qa[DH / 16][4], kb[DH / 16][2];
  if (live) {
    const long long hh = static_cast<long long>(b) * Hkv + h;
    const bf16* q0 = q + hh * G * DH;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g4 + 8 * (i % 2), d = 16 * kk + 2 * t4 + 8 * (i / 2);
        qa[kk][i] = r < G ? *reinterpret_cast<const uint32_t*>(q0 + r * DH + d)
                          : 0u;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        kb[kk][i] = g4 == 0 && sub == 0 ? *reinterpret_cast<const uint32_t*>(
                                  k_tok + hh * DH + 16 * kk + 2 * t4 + 8 * i)
                            : 0u;
    }
  }
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // The slot's row in windows of S slices of Ws entries (one window at the
  // main path's shape).  Per window: 1. each rank tests its slice, 16
  // entries a thread, and publishes its admitted count and, per thread,
  // the admitted bits and their prefix; 2. after cluster.sync() it lists
  // its share [a, a_end) of the window's admitted order from the ranks'
  // bits (distributed shared memory), in entry order, in rounds of at most
  // kListCap, and resolves their pages; 3. it walks each round.
  const int Ws = max(4, min(kWinSlice, (E + 4 * S - 1) / (4 * S) * 4));
  for (int w0 = 0; w0 == 0 || w0 < E; w0 += S * Ws) {
    {
      const int s0 = min(w0 + rank * Ws, E), s1 = min(s0 + Ws, E);
      const int e0 = s0 + kScanPerThread * tid;
      const uint32_t bits = e0 < s1 ? admitted32(ep, e0, s1, qp, vec) : 0u;
      int total;
      pre_sh[tid] = static_cast<uint16_t>(
          block_scan(__popc(bits), warp_tot, total));
      bits_sh[tid] = bits;
      if (tid == 0) cnt_sh = total;
    }
    if (w0 == 0 && live && sub == 0) {  // the token's raw score, rows g4
      float st[4] = {0.f, 0.f, 0.f, 0.f};  // and g4 + 8
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_16816(st, qa[kk], kb[kk][0], kb[kk][1]);
      if (t4 == 0) {
        tok_sh[jh][g4] = st[0];
        tok_sh[jh][g4 + 8] = st[2];
      }
    }
    cluster.sync();  // every rank's bits and count are published
    long long n = 0;
    for (int r = 0; r < S; ++r) n += *cluster.map_shared_rank(&cnt_sh, r);
    const int a = static_cast<int>(rank * n / S);
    const int a_end = static_cast<int>((rank + 1) * n / S);
    for (int base = a; base < a_end; base += kListCap) {
      const int hi = min(a_end, base + kListCap);
      int pr = 0;  // admitted entries of the window before slice r
      for (int r = 0; r < S && pr < hi; ++r) {
        const int cr = *cluster.map_shared_rank(&cnt_sh, r);
        if (pr + cr > base) {
          const uint32_t bits = *cluster.map_shared_rank(&bits_sh[tid], r);
          int g = pr + *cluster.map_shared_rank(&pre_sh[tid], r);
          const int eb = w0 + r * Ws + kScanPerThread * tid;
          for (uint32_t f = bits; f != 0; f &= f - 1, ++g)
            if (g >= base && g < hi) list[g - base] = eb + __ffs(f) - 1;
        }
        pr += cr;
      }
      __syncthreads();  // the list of entries is complete
      // Entries -> pool rows, the pages resolved through block_table
      // (clamped), every thread's loads in flight at once.
      for (int i = tid; i < hi - base; i += kSplitThreads) {
        const int e = list[i];
        list[i] = min(max(bt[e / ps], 0), P - 1) * ps + e % ps;
      }
      __syncthreads();

      const int nr = hi - base;
      const int nsteps = (nr + TILE - 1) / TILE;
      // Step i into stage i % stages: for each of its TILE listed entries
      // the K and V rows of kv-heads h0..h0+hl-1 (contiguous in the pages)
      // and, for codes, their scales; entries past the list zero-filled.
      auto load_step = [&](int i) {
        uint8_t* const st = ring + (i % stages) * sbytes;
        const int t0 = i * TILE;
        constexpr int kScaleSlots = PAY == kNative ? 0 : 1;
        const int cpe = hl * kChunks;  // 16-byte copies per entry row
        for (int y = warp; y < 2 * TILE; y += kSplitWarps) {
          const int t = y < TILE ? y : y - TILE;
          const bool ok = t0 + t < nr;
          const long long row = ok ? list[t0 + t] : 0;
          const long long hrow = row * Hkv + h0;
          for (int c = lane; c < cpe + kScaleSlots * hl; c += 32) {
            if (c < cpe) {
              const uint8_t* src =
                  (y < TILE ? k_pages : v_pages) + hrow * kRow + 16 * c;
              uint8_t* dst = PAY == kNative ? st + y * EP * 2 + 16 * c
                                            : st + y * HB * kRow + 16 * c;
              cp_async16(smem_u32(dst), src, ok ? 16 : 0);
            } else {
              const int j = c - cpe;
              const float* src = (y < TILE ? k_scales : v_scales) + hrow + j;
              float* sc = reinterpret_cast<float*>(st + 2 * TILE * HB * kRow);
              cp_async4(smem_u32(sc + y * HB + j), src, ok ? 4 : 0);
            }
          }
        }
      };
      for (int i = 0; i < stages - 1; ++i) {
        if (i < nsteps) load_step(i);
        cp_async_commit();
      }
      for (int i = 0; i < nsteps; ++i) {
        cp_async_wait_dyn(stages - 2);  // step i landed
        __syncthreads();  // ... for every thread; stage (i - 1) % stages free
        if (i + stages - 1 < nsteps) load_step(i + stages - 1);
        cp_async_commit();
        const int nt = min(kSub, nr - i * TILE - kSub * sub);
        if (!live || nt <= 0) continue;
        const uint8_t* const st = ring + (i % stages) * sbytes;
        // this warp's 16 entries of head jh: K rows then V rows, pitch kp
        const bf16* ks;
        const bf16* vs;
        int kp;
        float ksc[4] = {1.f, 1.f, 1.f, 1.f}, vsc[4] = {1.f, 1.f, 1.f, 1.f};
        constexpr int kUnits = kSub * kChunks;  // 16-byte code chunks of K
        constexpr int kPer = (kUnits + 31) / 32;
        uint4 raw[kPer];
        // the codes of K (kv 0) or V (kv 1) of its rows into registers
        auto load_codes = [&](int kv) {
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int x = lane + 32 * u;
            const int y = kv * TILE + kSub * sub + x / kChunks;
            if (x < kUnits)
              raw[u] = *reinterpret_cast<const uint4*>(
                  st + (y * HB + jh) * kRow + 16 * (x % kChunks));
          }
        };
        if constexpr (PAY == kNative) {
          ks = reinterpret_cast<const bf16*>(st) + kSub * sub * EP + jh * DH;
          vs = ks + TILE * EP;
          kp = EP;
        } else {
          // K's codes as bf16 into its own tile (V's follow after S); the
          // scales multiply S (K) and P (V) instead, exactly (powers of two)
          load_codes(0);
          const float* sc =
              reinterpret_cast<const float*>(st + 2 * TILE * HB * kRow);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = kSub * sub + 8 * (e / 2) + 2 * t4 + (e % 2);
            ksc[e] = sc[t * HB + jh];
            vsc[e] = sc[(TILE + t) * HB + jh];
          }
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int x = lane + 32 * u;
            if (x < kUnits)
              codes_to_bf16<PAY, DH>(raw[u], x % kChunks,
                                     wt + (x / kChunks) * WP);
          }
          __syncwarp();
          ks = vs = wt;
          kp = WP;
        }
        const int mi = lane / 8;
        // S [16 rows x 16 entries]: n-tiles of entries 0-7 and 8-15.
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + ((mi / 2) * 8 + lane % 8) * kp + kk * 16 +
                              (mi % 2) * 8);
          mma_16816(sc[0], qa[kk], bk[0], bk[1]);
          mma_16816(sc[1], qa[kk], bk[2], bk[3]);
        }
        if constexpr (PAY != kNative) {
          load_codes(1);
          __syncwarp();  // K's rows read: the tile takes V's
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int x = lane + 32 * u;
            if (x < kUnits)
              codes_to_bf16<PAY, DH>(raw[u], x % kChunks,
                                     wt + (x / kChunks) * WP);
          }
        }
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[jn][e] *= ksc[2 * jn + (e & 1)];
            if (8 * jn + 2 * t4 + (e & 1) < nt)
              mx[e / 2] = fmaxf(mx[e / 2], sc[jn][e]);
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
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ex[jn][e] = 8 * jn + 2 * t4 + (e & 1) < nt
                            ? exp2_fast(fmaf(sc[jn][e], scale_log2, -m[e / 2]))
                            : 0.f;
            sum[e / 2] += ex[jn][e];
            ex[jn][e] *= vsc[2 * jn + (e & 1)];
          }
        const uint32_t pa[4] = {pack_bf16(ex[0][0], ex[0][1]),
                                pack_bf16(ex[0][2], ex[0][3]),
                                pack_bf16(ex[1][0], ex[1][1]),
                                pack_bf16(ex[1][2], ex[1][3])};
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + sum[r];
#pragma unroll
        for (int nn = 0; nn < DH / 8; ++nn) {
          o[nn][0] *= al[0];
          o[nn][1] *= al[0];
          o[nn][2] *= al[1];
          o[nn][3] *= al[1];
        }
        if constexpr (PAY != kNative) __syncwarp();  // V's rows written
        // O += P·V: V rows transposed by ldmatrix, 16 dims per step.
#pragma unroll
        for (int n2 = 0; n2 < DH / 16; ++n2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + ((mi % 2) * 8 + lane % 8) * kp + n2 * 16 +
                                    (mi / 2) * 8);
          mma_16816(o[2 * n2], pa, bv[0], bv[1]);
          mma_16816(o[2 * n2 + 1], pa, bv[2], bv[3]);
        }
        if constexpr (PAY != kNative) __syncwarp();  // its tile is reused
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring and the list are free
    }
    if (w0 + S * Ws < E) cluster.sync();  // the bits are rewritten next
  }

  // 3. The warps' partials over the ring: acc [warp][row][DH], m and l
  // per (warp, row); then per head the sum of its warps' in warp order
  // (weights 2^(m_w - M), exact), into its first warp's slot.
  float* const acc = reinterpret_cast<float*>(smem);
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
    for (int nn = 0; nn < DH / 8; ++nn) {
      float* const a0 = acc + (warp * kSplitRows + g4) * DH + 8 * nn + 2 * t4;
      a0[0] = o[nn][0];
      a0[1] = o[nn][1];
      a0[8 * DH] = o[nn][2];
      a0[8 * DH + 1] = o[nn][3];
    }
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_sh[warp][g4 + 8 * r] = m[r];
        l_sh[warp][g4 + 8 * r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int x = tid; WPH > 1 && x < hl * G * DH; x += kSplitThreads) {
    const int d = x % DH, y = x / DH, r = y % G, j = y / G;
    float M = kNegInf;
    for (int p = 0; p < WPH; ++p) M = fmaxf(M, m_sh[j * WPH + p][r]);
    float L = 0.f, O = 0.f;
    for (int p = 0; p < WPH; ++p) {
      const int w = j * WPH + p;
      const float f = pow2_int(m_sh[w][r] - M);
      L += f * l_sh[w][r];
      O += f * acc[(w * kSplitRows + r) * DH + d];
    }
    acc[(j * WPH * kSplitRows + r) * DH + d] = O;
    if (d == 0) {
      hm_sh[j][r] = M;
      hl_sh[j][r] = L;
    }
  }
  // one warp a head: its own partial is the head's
  float (*const pm)[kSplitRows] = WPH > 1 ? hm_sh : m_sh;
  float (*const pl)[kSplitRows] = WPH > 1 ? hl_sh : l_sh;
  cluster.sync();  // every rank's partial is written

  // 4. The ranks' partials in rank order, weighted by 2^(m_s - M) (exact:
  // integer maxima; a rank that saw nothing has l = 0 and acc = 0), then
  // the in-flight token, always valid (its position is q_pos).
  for (int x = rank * kSplitThreads + tid; x < hl * G * DH;
       x += S * kSplitThreads) {
    const int d = x % DH, y = x / DH, r = y % G, j = y / G;
    float rm[kSplitMaxS], rl[kSplitMaxS], ra[kSplitMaxS];
    float M = kNegInf;
#pragma unroll
    for (int c = 0; c < kSplitMaxS; ++c) {
      if (c < S) {
        rm[c] = *cluster.map_shared_rank(&pm[j][r], c);
        rl[c] = *cluster.map_shared_rank(&pl[j][r], c);
        ra[c] = *cluster.map_shared_rank(
            acc + (j * WPH * kSplitRows + r) * DH + d, c);
        M = fmaxf(M, rm[c]);
      }
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int c = 0; c < kSplitMaxS; ++c) {
      if (c < S) {
        const float f = pow2_int(rm[c] - M);
        L += f * rl[c];
        O += f * ra[c];
      }
    }
    const float st = tok_sh[j][r] * scale_log2;
    const float m2 = fmaxf(M, st);
    const float alpha = exp2f(M - m2), p_tok = exp2f(st - m2);
    const float den = fmaxf(L * alpha + p_tok, 1e-20f);
    const long long hh = static_cast<long long>(b) * Hkv + h0 + j;
    out[(hh * G + r) * DH + d] = __float2bfloat16_rn(
        (O * alpha + p_tok * __bfloat162float(v_tok[hh * DH + d])) / den);
  }
  cluster.sync();  // no block leaves while another reads its memory
}

// ---------------------------------------------------------------------------
// Launch: the plan, checked, then exactly its grid
// ---------------------------------------------------------------------------

struct Call {
  const void *q, *kp, *vp, *ks, *vs, *bt, *ep, *kt, *vt, *qpos;
  void* out;
  int B, P, ps, Hkv, G, J, dh, payload;
  float scale;
  cudaStream_t stream;
};

template <typename T, int PAY, int DH, int GR>
cudaError_t launch_simt(const Call& c, dim3 grid) {
  paged_simt<T, PAY, DH, GR><<<grid, kSimtWarps * 32, 0, c.stream>>>(
      static_cast<const T*>(c.q), c.kp, c.vp,
      static_cast<const float*>(c.ks), static_cast<const float*>(c.vs),
      static_cast<const int*>(c.bt), static_cast<const int*>(c.ep),
      static_cast<const T*>(c.kt), static_cast<const T*>(c.vt),
      static_cast<const int*>(c.qpos), static_cast<T*>(c.out), c.P, c.ps,
      c.Hkv, c.G, c.J, c.scale);
  return cudaSuccess;
}

template <typename T, int PAY, int DH>
cudaError_t simt_rows(const Call& c, dim3 grid, int rows) {
  return rows == 1 ? launch_simt<T, PAY, DH, 1>(c, grid)
                   : launch_simt<T, PAY, DH, kSimtMaxRows>(c, grid);
}

template <typename T, int PAY>
cudaError_t simt_dh(const Call& c, dim3 grid, int rows) {
  return c.dh == 32   ? simt_rows<T, PAY, 32>(c, grid, rows)
         : c.dh == 64 ? simt_rows<T, PAY, 64>(c, grid, rows)
                      : simt_rows<T, PAY, 128>(c, grid, rows);
}

template <int PAY, int DH>
cudaError_t launch_split(const Call& c, dim3 grid, int heads, int stages,
                         int smem) {
  static bool configured[kMaxDevices] = {};
  cudaError_t e =
      opt_in_smem(paged_split<PAY, DH>, kSmemMax, configured);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  constexpr float kLog2e = 1.4426950408889634f;
  return cudaLaunchKernelEx(
      &cfg, paged_split<PAY, DH>, static_cast<const bf16*>(c.q),
      static_cast<const uint8_t*>(c.kp), static_cast<const uint8_t*>(c.vp),
      static_cast<const float*>(c.ks), static_cast<const float*>(c.vs),
      static_cast<const int*>(c.bt), static_cast<const int*>(c.ep),
      static_cast<const bf16*>(c.kt), static_cast<const bf16*>(c.vt),
      static_cast<const int*>(c.qpos), static_cast<bf16*>(c.out), c.P, c.ps,
      c.Hkv, c.G, c.J, heads, stages, c.scale * kLog2e);
}

template <int PAY>
cudaError_t split_dh(const Call& c, dim3 grid, int heads, int stages,
                     int smem) {
  return c.dh == 32   ? launch_split<PAY, 32>(c, grid, heads, stages, smem)
         : c.dh == 64 ? launch_split<PAY, 64>(c, grid, heads, stages, smem)
                      : launch_split<PAY, 128>(c, grid, heads, stages, smem);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch(const Call& c, int route, int rows, int heads, int splits,
           int tile, int stages, int grid_x, int grid_y, int smem) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (c.dh != 32 && c.dh != 64 && c.dh != 128) return bad;
  if (c.payload < kNative || c.payload > kInt4) return bad;
  if (c.G < 1 || c.Hkv < 1 || c.B < 0 || c.J < 0 || c.ps < 1 || c.P < 1)
    return bad;
  if (reinterpret_cast<uintptr_t>(c.kp) % 16 ||
      reinterpret_cast<uintptr_t>(c.vp) % 16)
    return bad;
  const dim3 grid(grid_x, grid_y);
  cudaError_t e = cudaErrorInvalidValue;
  if (route == kSimt) {
    if ((rows != 1 && rows != kSimtMaxRows) || heads != 1 || splits != 1 ||
        tile != kSimtGroup || stages != 0 || smem != 0 ||
        grid_x != c.B * c.Hkv || grid_y != cdiv(c.G, rows))
      return bad;
    if (c.B == 0) return static_cast<int>(cudaGetLastError());
    switch (c.payload) {
      case kNative: e = simt_dh<T, kNative>(c, grid, rows); break;
      case kInt8: e = simt_dh<T, kInt8>(c, grid, rows); break;
      default: e = simt_dh<T, kInt4>(c, grid, rows); break;
    }
  } else if (route == kSplit) {
    if constexpr (sizeof(T) != 2) {
      return bad;  // the split walk's products are bf16
    } else {
      if (reinterpret_cast<uintptr_t>(c.q) % 4 || c.G > kSplitRows ||
          rows != kSplitRows || (heads != 1 && heads != 2 && heads != 4) ||
          tile != step_entries(heads) || splits < 1 ||
          splits > kSplitMaxS || stages < kSplitMinStages ||
          stages > kSplitMaxStages || grid_x != splits ||
          grid_y != c.B * cdiv(c.Hkv, heads) ||
          smem != split_smem(c.payload, heads, c.dh, stages) ||
          smem > kSmemMax)
        return bad;
      if (c.B == 0) return static_cast<int>(cudaGetLastError());
      switch (c.payload) {
        case kNative:
          e = split_dh<kNative>(c, grid, heads, stages, smem);
          break;
        case kInt8:
          e = split_dh<kInt8>(c, grid, heads, stages, smem);
          break;
        default:
          e = split_dh<kInt4>(c, grid, heads, stages, smem);
          break;
      }
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k_tok, v_tok, out: contiguous [B, 1, Hq = Hkv·G, dh] / [B, 1, Hkv, dh]
// in one storage type.  k/v pages: contiguous, 16-byte aligned [P, ps,
// Hkv, dhp] of that type (payload 0), int8 codes (1) or nibble-packed int4
// codes, dhp = dh/2 (2); k/v scales: f32 [P, ps, Hkv] for payloads 1-2
// (else unused).  block_table int32 [B, J]; eff_pos int32 [B, J·ps]; q_pos
// int32 [B].  dh in {32, 64, 128}.  The plan (route 0 simt, 1 split; rows
// per block; kv-heads per block; blocks per cluster; entries per tile;
// ring stages; the grid; the dynamic shared memory) comes from the
// caller's plan() (kernels/paged_attention.py) and is launched exactly:
// one that disagrees with what this file instantiates returns
// cudaErrorInvalidValue before anything is launched.  Returns the first
// CUDA error, else cudaGetLastError().
extern "C" int paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* eff_pos, const void* k_tok, const void* v_tok,
    const void* q_pos, void* out, int B, int P, int ps, int Hkv, int G,
    int J, int dh, int payload, float scale, int route, int rows, int heads,
    int splits, int tile, int stages, int grid_x, int grid_y, int smem,
    void* stream) {
  return launch<bf16>(
      Call{q, k_pages, v_pages, k_scales, v_scales, block_table, eff_pos,
           k_tok, v_tok, q_pos, out, B, P, ps, Hkv, G, J, dh, payload, scale,
           static_cast<cudaStream_t>(stream)},
      route, rows, heads, splits, tile, stages, grid_x, grid_y, smem);
}
extern "C" int paged_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* eff_pos, const void* k_tok, const void* v_tok,
    const void* q_pos, void* out, int B, int P, int ps, int Hkv, int G,
    int J, int dh, int payload, float scale, int route, int rows, int heads,
    int splits, int tile, int stages, int grid_x, int grid_y, int smem,
    void* stream) {
  return launch<float>(
      Call{q, k_pages, v_pages, k_scales, v_scales, block_table, eff_pos,
           k_tok, v_tok, q_pos, out, B, P, ps, Hkv, G, J, dh, payload, scale,
           static_cast<cudaStream_t>(stream)},
      route, rows, heads, splits, tile, stages, grid_x, grid_y, smem);
}
