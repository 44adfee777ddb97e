// Mamba-2 SSD chunk scan: y and the final state of one sequence-head per
// block, the state carried across chunks in shared memory.
//
// Replaces the TPU kernel ssd_scan_pallas / _ssd_kernel
// (src/repro/kernels/ssd_scan.py).  There one grid cell is one
// (batch·head, chunk) and the state [N, P] waits in VMEM scratch for the
// next cell of the sequential chunk axis.  Blocks on this card run in no
// order, so one block owns one (batch, head) and walks its chunks in a
// loop; the state never leaves shared memory.  Unlike the TPU kernel it
// also writes the final state, which the served path (models/ssm.py) hands
// to the decode step.
//
// Per chunk of Q tokens (cum = inclusive cumsum of dt·A over the chunk,
// dtx = dt·x, B and C of the head's group):
//   y[i]    = Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) dtx_j + exp(cum_i) C_i·S
//   S'      = S·exp(cum_Q) + Σ_j B_j ⊗ exp(cum_Q − cum_j) dtx_j
// exp(cum_i − cum_j) is > 1 above the diagonal and may overflow: it is
// computed only where j ≤ i, and 0 is stored elsewhere.  Tokens past T
// load as zeros (dt = 0: they decay nothing and add nothing, so S is the
// state after T tokens).
//
// Bound: at the main path's shapes (B 4, T 512, H 80, P 64, N 128, Q 128)
// the chunk products are 9.4 GFLOP of fp32 against 75 MB moved:
// operations.  The kernel is SIMT fp32 out of shared memory, which holds
// the chunk's B (rows padded to N+1, so a warp's 32 rows hit 32 banks), C,
// dtx, the state and one 32-row tile of scores (~216 KB, one block per
// SM).  Each product is register-tiled so that a thread does 2-4 FMAs per
// shared-memory load: scores 4 rows × 4 columns (C rows read 4 at a time,
// broadcast), y 2 rows × 4 values of P (float4), the state update 8 values
// of N × 4 of P; the inner loops are unrolled so that, with only 8 warps
// per SM, several loads are in flight.  Only the causal column blocks of
// each score tile are computed.  The chunk's inputs load 4 elements at a
// time.  Tensor cores (the three
// products are [Q,N]x[N,Q], [Q,Q]x[Q,P], [N,Q]x[Q,P]) would need fp32
// accuracy that TF32 does not give: a later change's work (3xTF32 or bf16
// splits).
#include "common.cuh"

namespace {

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

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* bm,
           const void* cm, void* y, void* state, int B, int Tlen, int H, int P,
           int N, int G, int Q, void* stream) {
  const size_t bytes = static_cast<size_t>(Layout(Q, P, N).total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && H > 0)
    ssd_scan_kernel<T><<<B * H, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_log), static_cast<const T*>(bm),
        static_cast<const T*>(cm), static_cast<float*>(y),
        static_cast<float*>(state), Tlen, H, P, N, G, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory (bytes) one block needs at these sizes, or -1 when
// the kernel's thread tiles do not cover them (Q ≤ 128, N ≤ 128 and a
// multiple of 8, P ≤ 64 and a multiple of 4).
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N) {
  if (Q < 1 || Q > kMaxQ || N < 8 || N > kMaxN || N % 8 || P < 4 ||
      P > kMaxP || P % 4)
    return -1;
  return static_cast<long long>(Layout(Q, P, N).total) * sizeof(float);
}

// x: [B, T, H, P] (bf16 or f32); dt: [B, T, H] f32; a_log: [H] f32;
// bm/cm: [B, T, G, N] in x's type; y: [B, T, H, P] f32; state: [B, H, P, N]
// f32; all contiguous, x, bm and cm 16-byte aligned.  Q = min(chunk, T), H
// a multiple of G, the sizes within ssd_scan_smem_bytes' limits.  Returns
// cudaGetLastError().
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a_log,
                             const void* bm, const void* cm, void* y,
                             void* state, int B, int T, int H, int P, int N,
                             int G, int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a_log, bm, cm, y, state, B, T, H, P, N,
                               G, Q, stream);
}
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a_log,
                            const void* bm, const void* cm, void* y,
                            void* state, int B, int T, int H, int P, int N,
                            int G, int Q, void* stream) {
  return launch<float>(x, dt, a_log, bm, cm, y, state, B, T, H, P, N, G, Q,
                       stream);
}
