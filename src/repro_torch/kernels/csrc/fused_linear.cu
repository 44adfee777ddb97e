// Fused linear pipeline, dense weights: RMSNorm prologue x matmul x
// {GLU, gate_mul, residual, Σy²} epilogue (paper Alg. 1 + §4.2).
//
// Replaces the dense-weight branch of the TPU kernel fused_linear_pallas
// (src/repro/kernels/fused_linear.py); its int4-BFP branch is
// fused_linear_int4.cu.
//
//   y   = act((x · rsqrt(mean_sq + eps) · gamma) @ W)          (no GLU)
//   y   = act(xn @ W[:, :F]) * (xn @ W[:, F:])                 (GLU, W [K, 2F])
//   y   = y · gate_mul + residual;  out = cast(y);  sq = Σ_f y²  (fp32, pre-cast)
//
// Design.  A plain shared-memory tiled SIMT kernel with fp32 accumulation
// (the reference upcasts every tile to fp32 before its dot).  Each block owns
// a BM x BN output tile and walks K in steps of BK; the prologue is applied
// while the x tile is staged into shared memory, so the normalised
// activation never reaches device memory.  For GLU the block stages the
// matching column tiles of BOTH halves of the widened weight and keeps two
// accumulators, so the epilogue can combine them in registers.
//
// The epilogue and the Σy² carry across output tiles (per-tile partials
// summed in a fixed order by a second kernel, no atomics) are shared with
// the int4 kernel: fused_epilogue.cuh.
//
// Bound.  Prefill (M = 2048) is bound by operations: the four linears of a
// llama2-7b layer are 829 GFLOP.  Decode (M = 4) is bound by the weight
// bytes (404.8 MB per layer).  This first kernel uses SIMT fp32 FMAs, not
// the tensor cores, so at prefill it runs far from the bf16 bound; a
// small-M tile (BM = 16) keeps the wasted rows at decode to 12 of 16.
// wgmma/TMA pipelines are later work.
#include "fused_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <typename T, int BM, int BN, int TM, int TN, bool GLU>
__global__ void __launch_bounds__(kThreads)
fused_linear_kernel(const T* __restrict__ x, const float* __restrict__ mean_sq,
                    const T* __restrict__ gamma, const T* __restrict__ w,
                    const T* __restrict__ residual,
                    const float* __restrict__ gate_mul, T* __restrict__ out,
                    float* __restrict__ sq_part, int M, int K, int F, int act,
                    float eps) {
  constexpr int TX = BN / TN;  // threads along the output columns
  constexpr int TY = BM / TM;  // threads along the rows
  static_assert(TX == 16 && TX * TY == kThreads, "tile/thread mismatch");
  constexpr int WBN = GLU ? 2 * BN : BN;

  __shared__ float xs[kBK][BM + 1];  // +1: conflict-free transposed stores
  __shared__ float ws[kBK][WBN];
  __shared__ float rs[BM];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
  const long long N = GLU ? 2LL * F : static_cast<long long>(F);
  const bool prologue = mean_sq != nullptr;

  if (prologue) {
    for (int r = tid; r < BM; r += kThreads)
      rs[r] = (m0 + r < M) ? 1.f / sqrtf(mean_sq[m0 + r] + eps) : 0.f;
  }
  __syncthreads();

  float acc[TM][TN];
  float accu[GLU ? TM : 1][GLU ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (GLU) {
#pragma unroll
    for (int i = 0; i < (GLU ? TM : 1); ++i)
#pragma unroll
      for (int j = 0; j < (GLU ? TN : 1); ++j) accu[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K) {
        v = repro::to_f32(x[static_cast<long long>(gm) * K + gk]);
        if (prologue) v = v * rs[r] * repro::to_f32(gamma[gk]);
      }
      xs[kk][r] = v;
    }
    for (int e = tid; e < kBK * WBN; e += kThreads) {
      const int kk = e / WBN, c = e % WBN;
      const int gk = k0 + kk;
      const int gf = f0 + (GLU ? c % BN : c);
      float v = 0.f;
      if (gk < K && gf < F) {
        const long long col = (GLU && c >= BN) ? F + gf : gf;
        v = repro::to_f32(w[static_cast<long long>(gk) * N + col]);
      }
      ws[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (GLU) {
        float bu[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) bu[j] = ws[kk][BN + tx + j * TX];
#pragma unroll
        for (int i = 0; i < (GLU ? TM : 1); ++i)
#pragma unroll
          for (int j = 0; j < (GLU ? TN : 1); ++j)
            accu[i][j] = fmaf(a[i], bu[j], accu[i][j]);
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
                 const void* w, const void* res, const void* gmul, void* out,
                 void* sq_part, void* sq, int M, int K, int F, int act,
                 float eps, cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  fused_linear_kernel<T, BM, BN, TM, TN, GLU><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ms),
      static_cast<const T*>(gamma), static_cast<const T*>(w),
      static_cast<const T*>(res), static_cast<const float*>(gmul),
      static_cast<T*>(out), static_cast<float*>(sq_part), M, K, F, act, eps);
  if (sq != nullptr)
    repro::sq_reduce(sq_part, sq, M, static_cast<int>(grid.x), stream);
}

template <typename T>
int launch(const void* x, const void* ms, const void* gamma, const void* w,
           const void* res, const void* gmul, void* out, void* sq_part,
           void* sq, int M, int K, int F, int glu, int act, float eps,
           void* stream_) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream_);
  if (M <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  // sq_part is given only together with sq (the wrapper allocates it).
  if (sq == nullptr) sq_part = nullptr;
  if (M <= 16) {
    if (glu)
      launch_tile<T, 16, 64, 1, 4, true>(x, ms, gamma, w, res, gmul, out,
                                         sq_part, sq, M, K, F, act, eps, s);
    else
      launch_tile<T, 16, 64, 1, 4, false>(x, ms, gamma, w, res, gmul, out,
                                          sq_part, sq, M, K, F, act, eps, s);
  } else {
    if (glu)
      launch_tile<T, 128, 64, 8, 4, true>(x, ms, gamma, w, res, gmul, out,
                                          sq_part, sq, M, K, F, act, eps, s);
    else
      launch_tile<T, 128, 128, 8, 8, false>(x, ms, gamma, w, res, gmul, out,
                                            sq_part, sq, M, K, F, act, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K], w [K, N] (N = 2F with glu), residual/out [M, F]: all of one
// storage type and contiguous.  mean_sq [M], gate_mul [M] f32; gamma [K].
// Optional inputs are null.  sq_part: f32 scratch of ceil(F/64)·M entries,
// needed with sq [M] f32.  act: 0 none, 1 silu.
// Returns cudaGetLastError().
extern "C" int fused_linear_bf16(const void* x, const void* mean_sq,
                                 const void* gamma, const void* w,
                                 const void* residual, const void* gate_mul,
                                 void* out, void* sq_part, void* sq, int M,
                                 int K, int F, int glu, int act, float eps,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, mean_sq, gamma, w, residual, gate_mul, out,
                               sq_part, sq, M, K, F, glu, act, eps, stream);
}
extern "C" int fused_linear_f32(const void* x, const void* mean_sq,
                                const void* gamma, const void* w,
                                const void* residual, const void* gate_mul,
                                void* out, void* sq_part, void* sq, int M,
                                int K, int F, int glu, int act, float eps,
                                void* stream) {
  return launch<float>(x, mean_sq, gamma, w, residual, gate_mul, out, sq_part,
                       sq, M, K, F, glu, act, eps, stream);
}
