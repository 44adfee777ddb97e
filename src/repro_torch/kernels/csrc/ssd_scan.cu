// Mamba-2 SSD chunk scan: y and the final state of each sequence-head,
// the state carried across chunks on the chip.
//
// Replaces the TPU kernel ssd_scan_pallas / _ssd_kernel
// (src/repro/kernels/ssd_scan.py).  There one grid cell is one
// (batch·head, chunk) and the state [N, P] waits in VMEM scratch for the
// next cell of the sequential chunk axis.  Blocks on this card run in no
// order, so a block owns a (batch, head) — on the tensor-core route a
// slice of its P columns — and walks the chunks in a loop.  Unlike the TPU
// kernel it also writes the final state, which the served path
// (models/ssm.py) hands to the decode step.
//
// Per chunk of Q tokens (cum = inclusive cumsum of dt·A over the chunk, B
// and C of the head's group):
//   y[i]    = Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j + exp(cum_i) C_i·S
//   S'      = S·exp(cum_Q) + Σ_j B_j ⊗ exp(cum_Q − cum_j) dt_j x_j
// exp(cum_i − cum_j) is > 1 above the diagonal and may overflow: it is
// computed only where j ≤ i, and 0 is used elsewhere.  Tokens past T load
// as zeros (dt = 0: they decay nothing and add nothing, so S is the state
// after T tokens).
//
// Two routes; the wrapper's plan() (kernels/ssd_scan.py) picks one and
// the C entries launch exactly its grid, threads, stages and shared
// memory, and refuse any other plan.
//
// "tc" (bf16 x, B and C; the main path): one block of 8 warps per (batch,
// head, slice of PB columns of P), grid (B·H, P/PB).  Every product takes
// one operand that is exact in bf16, so the other, fp32, is split into
// three bf16 terms (hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi −
// mid); split_bf16 in warp_mma.cuh) and three mma.sync m16n8k16 products,
// summed in fp32, give the fp32 product up to the order of the sums:
//   scores C·Bᵀ         C and B exact: one product;
//   y_intra = W·x        W = scores ⊙ exp(cum_i − cum_j) ⊙ dt_j split in
//                        registers, x exact: three;
//   y_inter = C·S        C exact, S split into three bf16 tiles in shared
//                        memory once a chunk: three;
//   S'      = Bᵀ·x       Bᵀ scaled by exp(cum_Q − cum_j)·dt_j and split in
//                        registers, x exact (so the scaled operand is Bᵀ
//                        and not x: one split serves every column tile of
//                        the slice): three.
// Warp w owns rows 16w..16w+15 of the chunk for y (its C rows stay in
// registers as A fragments, loaded from global memory for the next chunk
// as soon as this chunk's y is written) and rows 16w..16w+15 of N for the
// state, which stays in its accumulators for the whole walk.  The scores
// stay in registers too: a warp takes 16 causal columns at a time, scales
// them, splits them and multiplies them by x, as flash attention's S → P·V
// does.  B and the x slice of the next chunk load by cp.async into the
// second of two stages while this chunk computes (rows padded by 16 bytes,
// so ldmatrix's eight rows hit eight bank groups); dt of the next chunk
// waits in warp 0's registers, which computes the chunk's cumsum as a warp
// scan and the per-row factors exp(cum_i) and exp(cum_Q − cum_j)·dt_j.
// Each product's fragments load before its mma.sync calls, and narrow
// slices keep the three split terms in three accumulators, so several
// mma chains are in flight.  The causal rows give warp w w + 1 tiles of
// scores and y; so warps w and 7 − w share their two state stripes: warp
// 7 − w leaves the last blocks of its stripe's update to warp w, which
// hands the partial sums over in shared memory (added in a fixed order).
// Two barriers a chunk.  No atomics: a second launch repeats bit for bit.
// The scores, and B and C, do not depend on P, so every slice computes and
// loads them again: plan() takes PB 64 wherever 64 divides P (all of
// mamba2-2.7b's P: 178 KB of shared memory, one block per SM, up to 255
// registers) and 8 elsewhere (~105 KB, two a SM).
//
// "simt" (fp32 x, B and C: the CPU ≡ CUDA parity route, and the bf16
// shapes the tile does not take): one block per (batch, head), SIMT fp32
// out of shared memory, which holds the chunk's B (rows padded to N+1, so
// a warp's 32 rows hit 32 banks), C, dtx, the state and one 32-row tile of
// scores (~216 KB, one block per SM).  Each product is register-tiled so
// that a thread does 2-4 FMAs per shared-memory load: scores 4 rows × 4
// columns (C rows read 4 at a time, broadcast), y 2 rows × 4 values of P
// (float4), the state update 8 values of N × 4 of P.  Only the causal
// column blocks of each score tile are computed.
//
// Bound: at the main path's shapes (B 4, T 512, H 80, P 64, N 128, Q 128,
// a third of the tokens at dt = 0) the scan is 75.1 MB of bytes and 9.43
// GFLOP, each product counted once: 0.0224 ms of bytes, against 0.0095 ms
// of those operations at the bf16 tensor-core rate (the route's three
// split terms are its own way to fp32 accuracy, not work the scan needs)
// or 0.141 ms at the SIMT route's fp32 rate (67 TFLOP/s).
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kSimt = 0, kTc = 1;  // routes, as plan() numbers them

namespace simt {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows of one score / y tile
constexpr int kMaxQ = 128, kMaxN = 128, kMaxP = 64;

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

struct Layout {
  int b, c, x, s, w, cum, dt, dec, total;  // offsets in floats
  __host__ __device__ Layout(int Q, int P, int N) {
    b = 0;
    c = b + align4(Q * (N + 1));
    x = c + align4(Q * (N + 4));
    s = x + align4(Q * P);
    w = s + align4(N * P);
    cum = w + align4(kRows * (Q + 4));
    dt = cum + align4(Q);
    dec = dt + align4(Q);
    total = dec + align4(Q);
  }
};

// Four consecutive elements (8- or 16-byte aligned) as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& v) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log, const T* __restrict__ bm,
                    const T* __restrict__ cm, float* __restrict__ y,
                    float* __restrict__ state_out, int Tlen, int H, int P,
                    int N, int G, int Q) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(Q, P, N);
  const int NB = N + 1, NC = N + 4, WS = Q + 4;
  float* sB = smem + L.b;      // [Q][N+1]
  float* sC = smem + L.c;      // [Q][N+4]
  float* sX = smem + L.x;      // [Q][P]   dt·x
  float* sS = smem + L.s;      // [N][P]   carried state
  float* sW = smem + L.w;      // [kRows][Q+4] scores of one row tile
  float* sCum = smem + L.cum;  // [Q]
  float* sDt = smem + L.dt;    // [Q]
  float* sDec = smem + L.dec;  // [Q]  exp(cum_Q − cum_j)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);
  const long long seq = static_cast<long long>(b) * Tlen;

  for (int e = tid; e < N * P; e += kThreads) sS[e] = 0.f;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int P4 = P / 4, N4 = N / 4;
  const int nc = (Tlen + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    // the chunk's x, B and C: 4 elements per load, several loads in flight
#pragma unroll 4
    for (int e = tid; e < Q * P4; e += kThreads) {
      const int i = e / P4, p = 4 * (e - i * P4), t = t0 + i;
      *reinterpret_cast<float4*>(sX + i * P + p) =
          t < Tlen ? load4(x + ((seq + t) * H + h) * P + p) : zero4;
    }
#pragma unroll 4
    for (int e = tid; e < Q * N4; e += kThreads) {
      const int i = e / N4, n = 4 * (e - i * N4), t = t0 + i;
      const long long off = ((seq + t) * G + g) * N + n;
      const float4 bv = t < Tlen ? load4(bm + off) : zero4;
      const float4 cv = t < Tlen ? load4(cm + off) : zero4;
      float* br = sB + i * NB + n;   // padded rows: not 16-byte aligned
      br[0] = bv.x;
      br[1] = bv.y;
      br[2] = bv.z;
      br[3] = bv.w;
      *reinterpret_cast<float4*>(sC + i * NC + n) = cv;
    }
    for (int i = tid; i < Q; i += kThreads) {
      const int t = t0 + i;
      sDt[i] = t < Tlen ? dt[(seq + t) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // the within-chunk cumsum, in order
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += sDt[i] * a;
        sCum[i] = s;
      }
    }
    for (int e = tid; e < Q * P; e += kThreads) sX[e] *= sDt[e / P];
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) sDec[j] = expf(cum_last - sCum[j]);

    for (int i0 = 0; i0 < Q; i0 += kRows) {
      // (a) scores: a warp owns 4 rows (C broadcast), a lane 4 columns
      // j = lane + 32q (padded B rows: 32 banks); column blocks past the
      // tile's diagonal block are never read, so they are not computed
      {
        const int ty = tid >> 5, lane = tid & 31;
        const int nq = i0 / 32 + 1;
        int rc[4], jc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rc[r] = min(i0 + 4 * ty + r, Q - 1) * NC;
#pragma unroll
        for (int q = 0; q < 4; ++q) jc[q] = min(lane + 32 * q, Q - 1) * NB;
        float acc[4][4] = {};
        for (int n = 0; n < N; n += 4) {  // N % 8 == 0
          float cv[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // broadcast, 16-byte aligned rows
            const float4 v = *reinterpret_cast<const float4*>(sC + rc[r] + n);
            cv[r][0] = v.x;
            cv[r][1] = v.y;
            cv[r][2] = v.z;
            cv[r][3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float bv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              bv[q] = q < nq ? sB[jc[q] + n + k] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (q < nq) acc[r][q] = fmaf(cv[r][k], bv[q], acc[r][q]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ty + r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = lane + 32 * q;
            if (q < nq && i < Q && j < Q)
              sW[(4 * ty + r) * WS + j] =
                  j <= i ? acc[r][q] * expf(sCum[i] - sCum[j]) : 0.f;
          }
        }
      }
      __syncthreads();
      // (b) y: a thread owns rows ia, ia+1 and 4 consecutive p (float4)
      {
        const int gr = tid >> 4, p = 4 * (tid & 15);
        const int ia = i0 + 2 * gr;
        if (p < P && ia < Q) {
          const bool has_b = ia + 1 < Q;
          const int ib = has_b ? ia + 1 : ia;
          const float* wa = sW + (2 * gr) * WS;
          const float* wb = has_b ? wa + WS : wa;
          float4 ya = make_float4(0.f, 0.f, 0.f, 0.f), yb = ya;
#pragma unroll 4
          for (int j = 0; j <= ib; ++j) {  // sW is 0 past each row's diagonal
            const float4 xv = *reinterpret_cast<const float4*>(sX + j * P + p);
            fma4(ya, wa[j], xv);
            fma4(yb, wb[j], xv);
          }
          const float* ca = sC + ia * NC;
          const float* cb = sC + ib * NC;
          float4 za = make_float4(0.f, 0.f, 0.f, 0.f), zb = za;
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            const float4 sv = *reinterpret_cast<const float4*>(sS + n * P + p);
            fma4(za, ca[n], sv);
            fma4(zb, cb[n], sv);
          }
          const float ea = expf(sCum[ia]), eb = expf(sCum[ib]);
          if (t0 + ia < Tlen) {
            float4 o = make_float4(ya.x + za.x * ea, ya.y + za.y * ea,
                                   ya.z + za.z * ea, ya.w + za.w * ea);
            *reinterpret_cast<float4*>(y + ((seq + t0 + ia) * H + h) * P + p) = o;
          }
          if (has_b && t0 + ib < Tlen) {
            float4 o = make_float4(yb.x + zb.x * eb, yb.y + zb.y * eb,
                                   yb.z + zb.z * eb, yb.w + zb.w * eb);
            *reinterpret_cast<float4*>(y + ((seq + t0 + ib) * H + h) * P + p) = o;
          }
        }
      }
      __syncthreads();
    }
    // (c) S[n][p] = S[n][p]·exp(cum_Q) + Σ_j B[j][n]·(exp(cum_Q − cum_j)·dtx[j][p]):
    // a thread owns 8 values of n and 4 consecutive p (float4)
    {
      const int ng = tid >> 4, p = 4 * (tid & 15);
      if (p < P && 8 * ng < N) {
        float4 acc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int j = 0; j < Q; ++j) {
          const float w = sDec[j];
          float4 xv = *reinterpret_cast<const float4*>(sX + j * P + p);
          xv = make_float4(xv.x * w, xv.y * w, xv.z * w, xv.w * w);
          const float* br = sB + j * NB + 8 * ng;
#pragma unroll
          for (int k = 0; k < 8; ++k) fma4(acc[k], br[k], xv);
        }
        const float decay = expf(cum_last);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float4* sp = reinterpret_cast<float4*>(sS + (8 * ng + k) * P + p);
          const float4 old = *sp;
          *sp = make_float4(old.x * decay + acc[k].x, old.y * decay + acc[k].y,
                            old.z * decay + acc[k].z, old.w * decay + acc[k].w);
        }
      }
    }
    __syncthreads();
  }
  // state_out[b][h][p][n]
  float* so = state_out + (static_cast<long long>(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    so[e] = sS[n * P + p];
  }
}


}  // namespace simt

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kMaxQ = 16 * kWarps;  // a 16-row stripe of the chunk a warp
constexpr int kMaxN = 16 * kWarps;  // and a 16-row stripe of the state
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int q) { return (q + 15) & ~15; }
// bf16 per staged row: an odd number of 16-byte groups, so the eight rows
// one ldmatrix reads fall in eight bank groups
__host__ __device__ constexpr int b_pitch(int N) { return N + 8; }
__host__ __device__ constexpr int x_pitch(int PB) {
  return (PB / 8) % 2 ? PB + 16 : PB + 8;
}

// Byte offsets of the dynamic shared memory (plan() mirrors this).
struct Smem {
  int b, x, s, f, part, total;
  __host__ __device__ Smem(int Q, int N, int PB) {
    const int Qp = pad16(Q);
    b = 0;                                            // B: stages × [Qp][N+8]
    x = b + kStages * Qp * b_pitch(N) * 2;            // x: stages × [Qp][XP]
    s = x + kStages * Qp * x_pitch(PB) * 2;           // S: 3 × [N][XP]
    f = s + 3 * N * x_pitch(PB) * 2;                  // 4 × [Qp] fp32
    part = f + 4 * Qp * 4;                            // 4 × [16][PB+8] fp32
    total = part + (kWarps / 2) * 16 * (PB + 8) * 4;
  }
};

// Blocks of 8 columns are built for two a SM, of 64 for one: their
// accumulators want up to 255 registers.
template <int PB>
__global__ void __launch_bounds__(kThreads, PB == 8 ? 2 : 1)
    ssd_scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const bf16* __restrict__ bm,
                const bf16* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ state_out, int Tlen, int H, int P, int N,
                int G, int Q) {
  constexpr int NT = PB / 8;  // 8-column tiles of the slice
  constexpr int XP = x_pitch(PB);
  constexpr int KN = kMaxN / 16;
  // accumulators per product whose three split terms run as separate
  // chains: three at PB 8 (one column tile), one at PB 64, whose eight
  // tiles give enough independent chains (and registers are short)
  constexpr int SA = NT == 1 ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(Q, N, PB);
  const int Qp = pad16(Q), NP = b_pitch(N);
  bf16* const sB = reinterpret_cast<bf16*>(smem + L.b);
  bf16* const sX = reinterpret_cast<bf16*>(smem + L.x);
  bf16* const sS = reinterpret_cast<bf16*>(smem + L.s);
  float* const sCum = reinterpret_cast<float*>(smem + L.f);
  float* const sDt = sCum + Qp;
  float* const sEc = sDt + Qp;  // exp(cum_i)
  float* const sF = sEc + Qp;   // exp(cum_Q − cum_j)·dt_j
  // warp w < 4's partial of warp 7 − w's state stripe: [16][PB+8] each
  float* const sPart = reinterpret_cast<float*>(smem + L.part);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PB;
  const int grp = h / (H / G);
  const float a = -expf(a_log[h]);
  const long long seq = static_cast<long long>(b) * Tlen;
  const int nc = (Tlen + Q - 1) / Q;
  const int nk = N / 16, nj = Qp / 16;
  const bool has_rows = 16 * warp < Qp;  // a stripe of y
  const bool has_state = 16 * warp < N;  // a stripe of the state

  // B and the x slice of chunk c into stage st (zeros past Q and past T).
  auto load_stage = [&](int c, int st) {
    const int t0 = c * Q, cpr = N / 8;
    bf16* const dB = sB + st * Qp * NP;
    for (int e = tid; e < Qp * cpr; e += kThreads) {
      const int i = e / cpr, k = e - i * cpr, t = t0 + i;
      const bool ok = i < Q && t < Tlen;
      cp_async16(smem_u32(dB + i * NP + 8 * k),
                 ok ? bm + ((seq + t) * G + grp) * N + 8 * k : bm,
                 ok ? 16 : 0);
    }
    bf16* const dX = sX + st * Qp * XP;
    for (int e = tid; e < Qp * NT; e += kThreads) {
      const int i = e / NT, k = e - i * NT, t = t0 + i;
      const bool ok = i < Q && t < Tlen;
      cp_async16(smem_u32(dX + i * XP + 8 * k),
                 ok ? x + ((seq + t) * H + h) * P + p0 + 8 * k : x,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // dt of chunk c, rows 4·lane..4·lane+3 (warp 0)
  float dnext[4];
  auto load_dt = [&](int c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * lane + r, t = c * Q + i;
      dnext[r] = i < Q && t < Tlen ? __ldg(dt + (seq + t) * H + h) : 0.f;
    }
  };
  // this warp's C rows of chunk c as A fragments, one per 16 values of N
  uint32_t cf[KN][4];
  auto load_c = [&](int c) {
    const int ia = 16 * warp + g8, ib = ia + 8, t0 = c * Q;
    const bool oka = ia < Q && t0 + ia < Tlen, okb = ib < Q && t0 + ib < Tlen;
    const uint32_t* ra = reinterpret_cast<const uint32_t*>(
        oka ? cm + ((seq + t0 + ia) * G + grp) * N : cm);
    const uint32_t* rb = reinterpret_cast<const uint32_t*>(
        okb ? cm + ((seq + t0 + ib) * G + grp) * N : cm);
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      if (kk < nk) {
        const int o = 8 * kk + q4;  // 32-bit words: values 16kk + 2q4, +1
        cf[kk][0] = oka ? __ldg(ra + o) : 0u;
        cf[kk][1] = okb ? __ldg(rb + o) : 0u;
        cf[kk][2] = oka ? __ldg(ra + o + 4) : 0u;
        cf[kk][3] = okb ? __ldg(rb + o + 4) : 0u;
      }
    }
  };
  // B fragments of 16 rows of `src` from row k0 (the k dimension), this
  // slice's columns: one pair of registers per 8-column tile
  auto load_rows = [&](uint32_t (&f)[NT][2], const bf16* src, int k0) {
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, src + (k0 + (mi % 2) * 8 + r8) * XP + n2 * 16 +
                                (mi / 2) * 8);
      f[2 * n2][0] = bv[0];
      f[2 * n2][1] = bv[1];
      f[2 * n2 + 1][0] = bv[2];
      f[2 * n2 + 1][1] = bv[3];
    }
    if constexpr (NT % 2) {
      uint32_t bv[2];
      ldmatrix_x2_trans(bv, src + (k0 + (mi % 2) * 8 + r8) * XP + (NT - 1) * 8);
      f[NT - 1][0] = bv[0];
      f[NT - 1][1] = bv[1];
    }
  };
  // d (+)= a · f over the slice's tiles
  auto mma_tiles = [](float (&d)[NT][4], const uint32_t (&af)[4],
                      const uint32_t (&f)[NT][2]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_16816(d[nt], af, f[nt][0], f[nt][1]);
  };

  // d += (Bᵀ rows n0..n0+15, scaled by exp(cum_Q − cum_j)·dt_j and split)
  // · x over the 16-token blocks kb_lo..kb_hi−1 of the chunk
  auto state_rows = [&](float (&d)[NT][4], const bf16* cB, const bf16* cX,
                        int n0, int kb_lo, int kb_hi) {
    float tm[2][NT][4];  // the mid and lo chains (SA 3)
    if constexpr (SA == 3) {
#pragma unroll
      for (int sp = 0; sp < 2; ++sp)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tm[sp][nt][e] = 0.f;
    }
    for (int kb = kb_lo; kb < kb_hi; ++kb) {
      // A = Bᵀ (rows n, columns j: ldmatrix transposes B's rows)
      uint32_t bt[4], xb[NT][2];
      ldmatrix_x4_trans(bt, cB + (16 * kb + (mi / 2) * 8 + r8) * NP + n0 +
                                (mi % 2) * 8);
      load_rows(xb, cX, 16 * kb);
      const float2 f0 = *reinterpret_cast<const float2*>(sF + 16 * kb +
                                                         2 * q4);
      const float2 f1 = *reinterpret_cast<const float2*>(sF + 16 * kb +
                                                         2 * q4 + 8);
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bt[r]));
        const float2 f = r < 2 ? f0 : f1;
        split_bf16(v.x * f.x, v.y * f.y, ah[r], am[r], al[r]);
      }
      mma_tiles(d, ah, xb);
      if constexpr (SA == 3) {
        mma_tiles(tm[0], am, xb);
        mma_tiles(tm[1], al, xb);
      } else {
        mma_tiles(d, am, xb);
        mma_tiles(d, al, xb);
      }
    }
    if constexpr (SA == 3) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] += tm[0][nt][e] + tm[1][nt][e];
    }
  };
  // Causal rows make warp w's y cost (w + 1) tiles of 2·nk + 3·NT mma; a
  // 16-token block of a state stripe costs 3·NT.  Warps w and 7 − w split
  // their two state stripes so that each pair's two warps carry about the
  // same: warp 7 − w gives its stripe's last `give` blocks to warp w.
  const int pair = warp < kWarps / 2 ? warp : kWarps - 1 - warp;
  int share = 0;
  if (kWarps - 1 - pair < nk) {  // both warps of the pair own a stripe
    const int yl = pair < nj ? pair + 1 : 0;
    const int yh = kWarps - 1 - pair < nj ? kWarps - pair : 0;
    share = max(0, min(nj, ((yh - yl) * (2 * nk + 3 * NT) + 3 * NT) /
                               (6 * NT)));
  }
  const int take = warp < kWarps / 2 ? share : 0;
  const int give = warp < kWarps / 2 ? 0 : share;
  float acc_s[NT][4];  // S[n][p], n = 16·warp + g8 (+8), p = 8·nt + 2·q4 (+1)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) cf[kk][e] = 0u;

  if (warp == 0) load_dt(0);
  load_stage(0, 0);
  if (has_rows) load_c(0);

  for (int c = 0; c < nc; ++c) {
    const int st = c & 1, t0 = c * Q;
    if (warp == 0) {  // the chunk's cumsum: a warp scan of 4-row sums
      float v[4], s = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s += dnext[r] * a;
        v[r] = s;
      }
      float incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float excl = incl - s;
      const float cum_q = __shfl_sync(0xffffffffu, excl + v[3], (Qp - 1) / 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * lane + r;
        if (i < Qp) {
          const float cv = excl + v[r];
          sCum[i] = cv;
          sDt[i] = dnext[r];
          sEc[i] = expf(cv);
          sF[i] = expf(cum_q - cv) * dnext[r];
        }
      }
      if (c + 1 < nc) load_dt(c + 1);
    }
    cp_async_wait<0>();
    __syncthreads();  // this chunk's stage and factors are in place
    if (c + 1 < nc) load_stage(c + 1, st ^ 1);
    const bf16* const cB = sB + st * Qp * NP;
    const bf16* const cX = sX + st * Qp * XP;

    if (has_rows) {
      const int i0 = 16 * warp;
      // y in SA accumulators: with SA 3 one per split term, three
      // independent mma chains, summed when y is written
      float acc[SA][NT][4];
#pragma unroll
      for (int sp = 0; sp < SA; ++sp)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[sp][nt][e] = 0.f;
      if (c > 0) {  // y_inter = exp(cum_i) · C·S, S in three bf16 tiles
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          if (kk < nk) {
            uint32_t sf[3][NT][2];
#pragma unroll
            for (int sp = 0; sp < 3; ++sp)
              load_rows(sf[sp], sS + sp * N * XP, 16 * kk);
#pragma unroll
            for (int sp = 0; sp < 3; ++sp)
              mma_tiles(acc[sp % SA], cf[kk], sf[sp]);
          }
        }
        const float e0 = sEc[i0 + g8], e1 = sEc[i0 + g8 + 8];
#pragma unroll
        for (int sp = 0; sp < SA; ++sp)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[sp][nt][0] *= e0;
            acc[sp][nt][1] *= e0;
            acc[sp][nt][2] *= e1;
            acc[sp][nt][3] *= e1;
          }
      }
      // y_intra over the causal 16-column blocks: scores, W, W·x
      const float ci[2] = {sCum[i0 + g8], sCum[i0 + g8 + 8]};
      for (int jb = 0; jb <= warp; ++jb) {
        // scores: the even and the odd 16-value steps of N in separate
        // accumulators (four mma chains), added before the scaling
        // (the fragments of four steps load before their products)
        float sc[2][2][4] = {};
        uint32_t xb[NT][2];
        load_rows(xb, cX, 16 * jb);
#pragma unroll
        for (int k4 = 0; k4 < KN; k4 += 4) {
          if (k4 < nk) {
            uint32_t bk[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (k4 + u < nk)
                ldmatrix_x4(bk[u], cB + (16 * jb + (mi / 2) * 8 + r8) * NP +
                                       16 * (k4 + u) + (mi % 2) * 8);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (k4 + u < nk) {
                mma_16816(sc[u % 2][0], cf[k4 + u], bk[u][0], bk[u][1]);
                mma_16816(sc[u % 2][1], cf[k4 + u], bk[u][2], bk[u][3]);
              }
            }
          }
        }
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g8 + (e / 2) * 8;
            const int j = 16 * jb + 8 * jt + 2 * q4 + (e & 1);
            const float v = sc[0][jt][e] + sc[1][jt][e];
            sc[0][jt][e] =
                j <= i ? v * (exp2_fast((ci[e / 2] - sCum[j]) * kLog2e) *
                              sDt[j])
                       : 0.f;
          }
        }
        uint32_t wh[4], wm[4], wl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[0][r / 2][2 * (r % 2)], sc[0][r / 2][2 * (r % 2) + 1],
                     wh[r], wm[r], wl[r]);
        mma_tiles(acc[0], wh, xb);
        mma_tiles(acc[1 % SA], wm, xb);
        mma_tiles(acc[2 % SA], wl, xb);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + g8 + 8 * hf, t = t0 + i;
        if (i < Q && t < Tlen) {
          float* const yr = y + ((seq + t) * H + h) * P + p0 + 2 * q4;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float2 v = make_float2(acc[0][nt][2 * hf], acc[0][nt][2 * hf + 1]);
#pragma unroll
            for (int sp = 1; sp < SA; ++sp) {
              v.x += acc[sp][nt][2 * hf];
              v.y += acc[sp][nt][2 * hf + 1];
            }
            *reinterpret_cast<float2*>(yr + 8 * nt) = v;
          }
        }
      }
      if (c + 1 < nc) load_c(c + 1);
    }

    if (has_state) {  // S = S·exp(cum_Q) + (Bᵀ scaled, split)·x
      const float decay = expf(sCum[Qp - 1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_s[nt][e] *= decay;
      // the pair's share: warp w < 4 also takes the last `take` 16-token
      // blocks of warp 7 − w's stripe, into a partial in shared memory
      state_rows(acc_s, cB, cX, 16 * warp, 0, nj - give);
      if (take > 0) {
        float tp[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tp[nt][e] = 0.f;
        state_rows(tp, cB, cX, 16 * (kWarps - 1 - warp), nj - take, nj);
        float* const pp = sPart + warp * 16 * (PB + 8) + 2 * q4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(pp + (g8 + 8 * hf) * (PB + 8) +
                                       8 * nt) =
                make_float2(tp[nt][2 * hf], tp[nt][2 * hf + 1]);
      }
    }
    __syncthreads();  // every warp is done with S, this stage and the factors
    if (give > 0) {  // the partner's share of this stripe
      const float* const pp =
          sPart + (kWarps - 1 - warp) * 16 * (PB + 8) + 2 * q4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 v = *reinterpret_cast<const float2*>(
              pp + (g8 + 8 * hf) * (PB + 8) + 8 * nt);
          acc_s[nt][2 * hf] += v.x;
          acc_s[nt][2 * hf + 1] += v.y;
        }
    }
    if (c + 1 < nc && has_state) {  // S in three bf16 tiles for the next y
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = 16 * warp + g8 + 8 * hf, p = 8 * nt + 2 * q4;
          uint32_t hi, md, lo;
          split_bf16(acc_s[nt][2 * hf], acc_s[nt][2 * hf + 1], hi, md, lo);
          *reinterpret_cast<uint32_t*>(sS + n * XP + p) = hi;
          *reinterpret_cast<uint32_t*>(sS + (N + n) * XP + p) = md;
          *reinterpret_cast<uint32_t*>(sS + (2 * N + n) * XP + p) = lo;
        }
      }
    }
  }
  if (has_state) {  // state_out[b][h][p][n], this block's columns
    float* const so = state_out + (static_cast<long long>(bh) * P + p0) * N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        so[(8 * nt + 2 * q4 + (e & 1)) * N + 16 * warp + g8 + 8 * (e / 2)] =
            acc_s[nt][e];
  }
}

}  // namespace tc

struct Call {
  const void *x, *dt, *a_log, *bm, *cm;
  void *y, *state;
  int B, T, H, P, N, G, Q;
  cudaStream_t stream;
};

template <typename K>
cudaError_t launch_kernel(K kernel, const Call& c, dim3 grid, int threads,
                          int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, c.stream>>>(
      static_cast<const bf16*>(c.x), static_cast<const float*>(c.dt),
      static_cast<const float*>(c.a_log), static_cast<const bf16*>(c.bm),
      static_cast<const bf16*>(c.cm), static_cast<float*>(c.y),
      static_cast<float*>(c.state), c.T, c.H, c.P, c.N, c.G, c.Q);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const Call& c, int route, int pb, int grid_x, int grid_y,
           int threads, int stages, int smem) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (c.B < 0 || c.T < 1 || c.H < 1 || c.G < 1 || c.H % c.G || c.P < 1 ||
      c.N < 1 || c.Q < 1 || c.Q > c.T)
    return bad;
  if (!aligned16(c.x) || !aligned16(c.bm) || !aligned16(c.cm)) return bad;
  const dim3 grid(grid_x, grid_y);
  cudaError_t e = cudaErrorInvalidValue;
  if (route == kSimt) {
    if (c.Q > simt::kMaxQ || c.N < 8 || c.N > simt::kMaxN || c.N % 8 ||
        c.P < 4 || c.P > simt::kMaxP || c.P % 4 || pb != c.P ||
        grid_x != c.B * c.H || grid_y != 1 || threads != simt::kThreads ||
        stages != 1 ||
        smem != static_cast<int>(simt::Layout(c.Q, c.P, c.N).total *
                                 sizeof(float)))
      return bad;
    if (c.B == 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = c.stream;
    e = cudaFuncSetAttribute(simt::ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    simt::ssd_scan_kernel<T><<<grid, threads, smem, s>>>(
        static_cast<const T*>(c.x), static_cast<const float*>(c.dt),
        static_cast<const float*>(c.a_log), static_cast<const T*>(c.bm),
        static_cast<const T*>(c.cm), static_cast<float*>(c.y),
        static_cast<float*>(c.state), c.T, c.H, c.P, c.N, c.G, c.Q);
    e = cudaGetLastError();
  } else if (route == kTc) {
    if constexpr (sizeof(T) != 2) {
      return bad;  // the tile's products are bf16
    } else {
      if (c.Q > tc::kMaxQ || c.N < 16 || c.N > tc::kMaxN || c.N % 16 ||
          (pb != 8 && pb != 64) || c.P % pb ||
          grid_x != c.B * c.H || grid_y != c.P / pb ||
          threads != tc::kThreads || stages != tc::kStages ||
          smem != tc::Smem(c.Q, c.N, pb).total || smem > 232448)
        return bad;
      if (c.B == 0) return static_cast<int>(cudaGetLastError());
      e = pb == 8 ? launch_kernel(tc::ssd_scan_tc<8>, c, grid, threads, smem)
                  : launch_kernel(tc::ssd_scan_tc<64>, c, grid, threads, smem);
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, T, H, P] (bf16 or f32); dt: [B, T, H] f32; a_log: [H] f32;
// bm/cm: [B, T, G, N] in x's type; y: [B, T, H, P] f32; state: [B, H, P, N]
// f32; all contiguous, x, bm and cm 16-byte aligned; Q = min(chunk, T), H a
// multiple of G.  The plan (route 0 simt, 1 tc; P columns per block; the
// grid; threads; stages; dynamic shared memory) comes from the caller's
// plan() (kernels/ssd_scan.py) and is launched exactly: one that disagrees
// with what this file instantiates returns cudaErrorInvalidValue before
// anything is launched.  Returns the first CUDA error, else
// cudaGetLastError().
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a_log,
                             const void* bm, const void* cm, void* y,
                             void* state, int B, int T, int H, int P, int N,
                             int G, int Q, int route, int pb, int grid_x,
                             int grid_y, int threads, int stages, int smem,
                             void* stream) {
  return launch<bf16>(Call{x, dt, a_log, bm, cm, y, state, B, T, H, P, N, G,
                           Q, static_cast<cudaStream_t>(stream)},
                      route, pb, grid_x, grid_y, threads, stages, smem);
}
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a_log,
                            const void* bm, const void* cm, void* y,
                            void* state, int B, int T, int H, int P, int N,
                            int G, int Q, int route, int pb, int grid_x,
                            int grid_y, int threads, int stages, int smem,
                            void* stream) {
  return launch<float>(Call{x, dt, a_log, bm, cm, y, state, B, T, H, P, N, G,
                            Q, static_cast<cudaStream_t>(stream)},
                       route, pb, grid_x, grid_y, threads, stages, smem);
}
