// Fused linear pipeline, int4-BFP weights (paper Alg. 1 + §4.2 float-fixed
// hybrid PE array), and the bare int4 matmul.
//
// Replaces the int4 branch of the TPU kernel fused_linear_pallas
// (src/repro/kernels/fused_linear.py) and int4_matmul_pallas
// (src/repro/kernels/int4_matmul.py): one template, with the prologue and
// the epilogue compiled out for the matmul.
//
//   xn  = x · (1 / sqrt(mean_sq + eps)) · gamma                 (prologue)
//   per row m and K-group c (G rows of the codes, one scale row):
//     e   = ceil(log2 max|xn[m, group c]|)   (0 for an all-zero group)
//     q   = clip(rint(xn · 2^7 / 2^e), -128, 127)               int8
//     acc = Σ_k q[m, k] · code[k, n]                            int32, exact
//     y  += acc · 2^(e-7) · scale[c, n]                         fp32
//   then act / GLU, gate_mul, residual, cast, Σy² (fused_epilogue.cuh).
//
// Design.  A block owns a BM x BN output tile (for GLU, BN columns of both
// halves of the widened [gate | up] codes) and walks the K-groups in order.
// Per group: each warp converts rows of the activation to BFP in registers
// (one lane per 4 consecutive k, a warp max for the shared exponent) and
// stores the mantissas packed 4 to a 32-bit word; the codes, stored [K, N]
// row-major one int8 each, arrive as 4x4 byte squares (4 k rows x 4
// columns, one 32-bit load per row) and are transposed with byte permutes,
// so that one word holds 4 consecutive k of one column.  Then __dp4a
// (s8 x s8 -> s32) forms the exact integer products, and one fp32
// reconstruction per (row, group) adds them in.  The reconstruction and
// the prologue use explicitly rounded operations (no contraction) in the
// same order as the plain version, so the mantissas and the per-group
// terms equal it bit for bit; only the epilogue's activation differs.
//
// Bound.  Decode (M = 4) is bound by the weight bytes: 1 B per code and
// 4 B per scale (208.7 MB per llama2-7b layer, 131 MB for the lm head);
// codes stay one per byte for parity with the reference.  Prefill
// (M = 2048) is bound by int8 operations.  This first kernel is SIMT
// (dp4a, not the int8 tensor cores), has no split-K and no pipelining of
// the code stream: mma.sync / wgmma, TMA, nibble-packed codes and split-K
// are later work.
#include <cstdint>

#include "fused_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 128;             // the widest group the kernel stages
constexpr int kStride = kMaxG / 4 + 1;  // words per staged row, padded
constexpr float kMant = 128.f;          // 2^MBITS
constexpr float kStep = 0.0078125f;     // 2^-MBITS

// Transposes a 4x4 byte square: r[q] holds columns 0..3 of row q; on
// return c[j] holds rows 0..3 of column j.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // r2.b2 r3.b2 r2.b3 r3.b3
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Global column of staged column cc: the gate half then the up half.
template <int BN, bool GLU>
__device__ __forceinline__ long long code_col(int f0, int cc, int F) {
  return (GLU && cc >= BN) ? static_cast<long long>(F) + f0 + cc - BN
                           : static_cast<long long>(f0) + cc;
}

template <typename T, int BM, int BN, int TM, int TN, bool GLU>
__global__ void __launch_bounds__(kThreads)
fused_linear_int4_kernel(const T* __restrict__ x,
                         const float* __restrict__ mean_sq,
                         const T* __restrict__ gamma,
                         const int8_t* __restrict__ codes,
                         const float* __restrict__ scale,
                         const T* __restrict__ residual,
                         const float* __restrict__ gate_mul,
                         T* __restrict__ out, float* __restrict__ sq_part,
                         int M, int K, int F, int G, int C, int act,
                         float eps, int vec) {
  constexpr int TX = BN / TN;  // threads along the output columns
  constexpr int TY = BM / TM;  // threads along the rows
  static_assert(TX == 16 && TX * TY == kThreads, "tile/thread mismatch");
  constexpr int WBN = GLU ? 2 * BN : BN;   // staged code columns
  constexpr int SQ_COLS = WBN / 4;         // 4x4 squares across a group

  __shared__ int xq[BM][kStride];    // mantissas, 4 consecutive k per word
  __shared__ int wq[WBN][kStride];   // codes, 4 consecutive k per word
  __shared__ float pe_s[BM];         // 2^e of each row, current group
  __shared__ float sc_s[WBN];        // scales of the current group
  __shared__ float rs[BM];           // 1 / sqrt(mean_sq + eps)

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
  const long long N = GLU ? 2LL * F : static_cast<long long>(F);
  const int words = (G + 3) / 4;
  const bool prologue = mean_sq != nullptr;

  if (prologue) {
    for (int r = tid; r < BM; r += kThreads)
      rs[r] = (m0 + r < M)
                  ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean_sq[m0 + r], eps)))
                  : 0.f;
  }
  __syncthreads();

  float acc[TM][TN];
  float accu[GLU ? TM : 1][GLU ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < (GLU ? TM : 1); ++i)
#pragma unroll
    for (int j = 0; j < (GLU ? TN : 1); ++j) accu[i][j] = 0.f;

  for (int c = 0; c < C; ++c) {
    const int k0 = c * G;

    // 1. The activation tile to BFP: warp w converts rows w, w + 8, ...;
    //    lane l holds k = 4l .. 4l+3 of the group.
    for (int r = warp; r < BM; r += kWarps) {
      const int gm = m0 + r;
      float v[4];
      float amax = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = 4 * lane + q, gk = k0 + kk;
        float t = 0.f;
        if (gm < M && kk < G && gk < K) {
          t = repro::to_f32(x[static_cast<long long>(gm) * K + gk]);
          if (prologue)
            t = __fmul_rn(__fmul_rn(t, rs[r]), repro::to_f32(gamma[gk]));
        }
        v[q] = t;
        amax = fmaxf(amax, fabsf(t));
      }
      amax = repro::warp_max(amax);
      const float e = amax == 0.f ? 0.f : ceilf(log2f(fmaxf(amax, 1e-30f)));
      const float pe = exp2f(e);
      if (lane < words) {
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float m = rintf(__fdiv_rn(__fmul_rn(v[q], kMant), pe));
          m = fminf(fmaxf(m, -128.f), 127.f);
          word |= (static_cast<uint32_t>(static_cast<int>(m)) & 0xffu)
                  << (8 * q);
        }
        xq[r][lane] = static_cast<int>(word);
      }
      if (lane == 0) pe_s[r] = pe;
    }

    // 2. The group's codes, one word per 4 consecutive k of a column
    //    (zero past G, past F and past the group's K rows).
    if (vec) {
      for (int s = tid; s < words * SQ_COLS; s += kThreads) {
        const int cc = 4 * (s % SQ_COLS), k4 = s / SQ_COLS;
        const int gf = f0 + (GLU ? cc % BN : cc);
        const long long col = code_col<BN, GLU>(f0, cc, F);
        uint32_t rows[4], cols[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * k4 + q;
          rows[q] = (kk < G && gf < F)
                        ? *reinterpret_cast<const uint32_t*>(
                              codes + (static_cast<long long>(k0) + kk) * N +
                              col)
                        : 0u;
        }
        transpose4x4(rows, cols);
#pragma unroll
        for (int j = 0; j < 4; ++j) wq[cc + j][k4] = static_cast<int>(cols[j]);
      }
    } else {
      for (int e = tid; e < 4 * words * WBN; e += kThreads) {
        const int kk = e / WBN, cc = e % WBN;
        const int gf = f0 + (GLU ? cc % BN : cc);
        int8_t b = 0;
        if (kk < G && gf < F)
          b = codes[(static_cast<long long>(k0) + kk) * N +
                    code_col<BN, GLU>(f0, cc, F)];
        reinterpret_cast<int8_t*>(&wq[cc][0])[kk] = b;
      }
    }
    for (int cc = tid; cc < WBN; cc += kThreads) {
      const int gf = f0 + (GLU ? cc % BN : cc);
      sc_s[cc] = gf < F ? scale[static_cast<long long>(c) * N +
                                code_col<BN, GLU>(f0, cc, F)]
                        : 0.f;
    }
    __syncthreads();

    // 3. Exact integer products, then one reconstruction per (row, group).
    int ia[TM][TN];
    int iu[GLU ? TM : 1][GLU ? TN : 1];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) ia[i][j] = 0;
#pragma unroll
    for (int i = 0; i < (GLU ? TM : 1); ++i)
#pragma unroll
      for (int j = 0; j < (GLU ? TN : 1); ++j) iu[i][j] = 0;
    for (int kw = 0; kw < words; ++kw) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xq[ty * TM + i][kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wq[tx + j * TX][kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) ia[i][j] = __dp4a(a[i], b[j], ia[i][j]);
      if (GLU) {
        int bu[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) bu[j] = wq[BN + tx + j * TX][kw];
#pragma unroll
        for (int i = 0; i < (GLU ? TM : 1); ++i)
#pragma unroll
          for (int j = 0; j < (GLU ? TN : 1); ++j)
            iu[i][j] = __dp4a(a[i], bu[j], iu[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float step = __fmul_rn(pe_s[ty * TM + i], kStep);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float t = __fmul_rn(static_cast<float>(ia[i][j]), step);
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(t, sc_s[tx + j * TX]));
      }
      if (GLU) {
#pragma unroll
        for (int j = 0; j < (GLU ? TN : 1); ++j) {
          const float t =
              __fmul_rn(static_cast<float>(iu[GLU ? i : 0][j]), step);
          accu[GLU ? i : 0][j] =
              __fadd_rn(accu[GLU ? i : 0][j],
                        __fmul_rn(t, sc_s[BN + tx + j * TX]));
        }
      }
    }
    __syncthreads();
  }

  repro::store_tile<T, TM, TN, TX, GLU>(acc, accu, m0 + ty * TM, f0 + tx, M,
                                         F, act, residual, gate_mul, out,
                                         sq_part, blockIdx.x, tx == 0);
}

template <typename T, int BM, int BN, int TM, int TN, bool GLU>
void launch_tile(const void* x, const void* ms, const void* gamma,
                 const void* codes, const void* scale, const void* res,
                 const void* gmul, void* out, void* sq_part, void* sq, int M,
                 int K, int F, int G, int C, int act, float eps, int vec,
                 cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  fused_linear_int4_kernel<T, BM, BN, TM, TN, GLU>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(ms),
          static_cast<const T*>(gamma), static_cast<const int8_t*>(codes),
          static_cast<const float*>(scale), static_cast<const T*>(res),
          static_cast<const float*>(gmul), static_cast<T*>(out),
          static_cast<float*>(sq_part), M, K, F, G, C, act, eps, vec);
  if (sq != nullptr)
    repro::sq_reduce(sq_part, sq, M, static_cast<int>(grid.x), stream);
}

template <typename T>
int launch(const void* x, const void* ms, const void* gamma,
           const void* codes, const void* scale, const void* res,
           const void* gmul, void* out, void* sq_part, void* sq, int M,
           int K, int F, int G, int C, int glu, int act, float eps,
           void* stream_) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream_);
  if (M <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || G > kMaxG || C <= 0 || K > G * C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sq == nullptr) sq_part = nullptr;
  // 32-bit code loads need every square's 4 columns in one half and
  // 4-byte aligned rows.
  const long long N = glu ? 2LL * F : static_cast<long long>(F);
  const int vec = (F % 4 == 0) && (N % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(codes) % 4 == 0);
  if (M <= 16) {
    if (glu)
      launch_tile<T, 16, 64, 1, 4, true>(x, ms, gamma, codes, scale, res,
                                         gmul, out, sq_part, sq, M, K, F, G,
                                         C, act, eps, vec, s);
    else
      launch_tile<T, 16, 64, 1, 4, false>(x, ms, gamma, codes, scale, res,
                                          gmul, out, sq_part, sq, M, K, F, G,
                                          C, act, eps, vec, s);
  } else {
    if (glu)
      launch_tile<T, 128, 64, 8, 4, true>(x, ms, gamma, codes, scale, res,
                                          gmul, out, sq_part, sq, M, K, F, G,
                                          C, act, eps, vec, s);
    else
      launch_tile<T, 128, 128, 8, 8, false>(x, ms, gamma, codes, scale, res,
                                            gmul, out, sq_part, sq, M, K, F,
                                            G, C, act, eps, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fused pipeline.  x [M, K], residual/out [M, F]: one storage type,
// contiguous.  codes [G·C, N] int8 in [-8, 7] (N = 2F with glu, [gate | up]),
// G·C >= K (the codes' padding rows are zero), scale [C, N] f32, G <= 128.
// mean_sq [M], gate_mul [M] f32; gamma [K].  Optional inputs are null.
// sq_part: f32 scratch of ceil(F/64)·M entries, needed with sq [M] f32.
// act: 0 none, 1 silu.  Returns cudaGetLastError().
extern "C" int fused_linear_int4_bf16(
    const void* x, const void* mean_sq, const void* gamma, const void* codes,
    const void* scale, const void* residual, const void* gate_mul, void* out,
    void* sq_part, void* sq, int M, int K, int F, int G, int C, int glu,
    int act, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, mean_sq, gamma, codes, scale, residual,
                               gate_mul, out, sq_part, sq, M, K, F, G, C, glu,
                               act, eps, stream);
}
extern "C" int fused_linear_int4_f32(
    const void* x, const void* mean_sq, const void* gamma, const void* codes,
    const void* scale, const void* residual, const void* gate_mul, void* out,
    void* sq_part, void* sq, int M, int K, int F, int G, int C, int glu,
    int act, float eps, void* stream) {
  return launch<float>(x, mean_sq, gamma, codes, scale, residual, gate_mul,
                       out, sq_part, sq, M, K, F, G, C, glu, act, eps, stream);
}

// The bare int4 matmul: x [M, K] x codes [G·C, N] (scale [C, N]) -> out
// [M, N], all as above with no prologue and no epilogue.
extern "C" int int4_matmul_bf16(const void* x, const void* codes,
                                const void* scale, void* out, int M, int K,
                                int N, int G, int C, void* stream) {
  return launch<__nv_bfloat16>(x, nullptr, nullptr, codes, scale, nullptr,
                               nullptr, out, nullptr, nullptr, M, K, N, G, C,
                               0, 0, 0.f, stream);
}
extern "C" int int4_matmul_f32(const void* x, const void* codes,
                               const void* scale, void* out, int M, int K,
                               int N, int G, int C, void* stream) {
  return launch<float>(x, nullptr, nullptr, codes, scale, nullptr, nullptr,
                       out, nullptr, nullptr, M, K, N, G, C, 0, 0, 0.f,
                       stream);
}
