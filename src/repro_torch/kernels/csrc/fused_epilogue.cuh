// Epilogue shared by the fused linear kernels (dense and int4-BFP weights):
// activation / GLU, per-row gate multiplier, residual add, the cast to the
// storage type, and Σy² of the written rows.
//
// Σy² across output tiles.  The TPU kernel carries Σy² across the j tiles
// in VMEM because its grid visits j in order; CUDA blocks run in no order.
// Each block writes its per-row partial (a fixed-order shuffle reduction
// over the threads sharing a row: store_tile for thread tiles, store_frag
// for wgmma fragments) to sq_part[j, m], and sq_reduce_kernel sums the
// partials in ascending j.  No atomics, so Σy² — and with it the
// next block's norm and its strict-`>` router gate — repeats bit for bit.
#pragma once
#include "common.cuh"

namespace repro {

constexpr int kActSilu = 1;
constexpr int kActGelu = 2;
constexpr int kSqReduceThreads = 256;

// SiLU (SwiGLU), or GELU's tanh approximation (jax.nn.gelu's default; GeGLU
// and the non-GLU GELU): y · 0.5 · (1 + tanh(√(2/π) · (y + 0.044715 · y³))),
// with the accurate tanhf (not tanh.approx.f32: CPU ≡ CUDA parity is
// asserted on it).  Every route's epilogue calls this.
__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == kActGelu)
    return y * (0.5f * (1.f + tanhf(0.7978845608028654f *
                                    (y + 0.044715f * (y * y * y)))));
  return act == kActSilu ? y / (1.f + expf(-y)) : y;
}

// Writes a thread's TM x TN outputs: rows row0 + i, columns col0 + j*TX.
// `accu` is the up-projection accumulator of the GLU (unused otherwise).
// The TX threads of one row sit in consecutive lanes of one warp; `lead`
// is the first of them and writes the row's Σy² partial of tile `tile`.
template <typename T, int TM, int TN, int TX, bool GLU>
__device__ __forceinline__ void store_tile(
    const float (&acc)[TM][TN], const float (&accu)[GLU ? TM : 1][GLU ? TN : 1],
    int row0, int col0, int M, int F, int act, const T* __restrict__ residual,
    const float* __restrict__ gate_mul, T* __restrict__ out,
    float* __restrict__ sq_part, int tile, bool lead) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
    const float gm = (gate_mul != nullptr && row < M) ? gate_mul[row] : 1.f;
    float rsq = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + j * TX;
      if (row < M && col < F) {
        float y = apply_act(acc[i][j], act);
        if (GLU) y *= accu[GLU ? i : 0][GLU ? j : 0];
        if (gate_mul != nullptr) y *= gm;
        const long long o = static_cast<long long>(row) * F + col;
        if (residual != nullptr) y += to_f32(residual[o]);
        out[o] = from_f32<T>(y);
        rsq = fmaf(y, y, rsq);
      }
    }
    if (sq_part != nullptr) {
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rsq += __shfl_xor_sync(0xffffffffu, rsq, off);
      if (lead && row < M)
        sq_part[static_cast<long long>(tile) * M + row] = rsq;
    }
  }
}

// Two adjacent outputs of type T as fp32, and back (rounded to nearest).
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The same epilogue on a warpgroup's wgmma accumulator (fused_linear.cu's
// tensor-core tile in bf16, fused_linear_int4.cu's in bf16 or fp32): one
// m64n128 fragment, element i of lane l in warp w of
// the warpgroup at row 16 w + l / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (l % 4) + i % 2.  Without GLU the 128 columns are output
// columns; with GLU columns [0, 64) are the gate and [64, 128) the up
// products of the same 64 outputs, so a lane holds both (i and i + 32).
// With mean_sq the per-row 1 / sqrt(mean_sq + eps) of the norm multiplies
// the fp32 accumulator here (the kernel fed the tensor cores x · gamma).
//
// The warpgroup's 64 x NO tile (rows m0.., output columns f0..; NO = 128,
// or 64 with GLU) passes through `stage` (64 rows of NO·sizeof(T) + 16
// bytes: the pad keeps the fragment's 8 rows on distinct banks), so the
// residual comes in and the output leaves as whole 16-byte chunks (F a
// multiple of 16 / sizeof(T) and the residual 16-byte aligned).  Σy²: a row's values lie in the 4 lanes
// of one quad; each lane adds its own in column order, then two shuffles
// add the quad in a fixed order and the quad's first lane writes the
// row's partial of tile `tile`.  No atomics: a row never spans two warps.
// `bar` is a named barrier of the warpgroup's 128 threads.
template <bool GLU, typename T>
__device__ __forceinline__ void store_frag(
    const float (&acc)[64], int m0, int f0, int M, int F, int act,
    const float* __restrict__ mean_sq, float eps,
    const T* __restrict__ residual, const float* __restrict__ gate_mul,
    T* __restrict__ out, float* __restrict__ sq_part, int tile,
    uint8_t* stage, int bar) {
  constexpr int NJ = GLU ? 8 : 16;          // column pairs of a lane per row
  constexpr int NO = 8 * NJ;                // output columns of the tile
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte chunk
  constexpr int CPR = NO / EPC;             // 16-byte chunks per row
  constexpr int ROW = NO * sizeof(T) + 16;  // staged row, bytes
  constexpr int NC = 64 * CPR / 128;        // chunks per thread
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  auto sync = [&] {
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
  };
  if (residual != nullptr) {
    uint4 v[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int id = t + 128 * i, r = id / CPR, c = EPC * (id % CPR);
      v[i] = (m0 + r < M && f0 + c < F)
                 ? __ldg(reinterpret_cast<const uint4*>(
                       residual + static_cast<long long>(m0 + r) * F + f0 + c))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int id = t + 128 * i;
      *reinterpret_cast<uint4*>(stage + (id / CPR) * ROW + 16 * (id % CPR)) =
          v[i];
    }
    sync();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int lr = 16 * warp + lane / 4 + 8 * hr, row = m0 + lr;
    const bool live = row < M;
    const float rs = (mean_sq != nullptr && live)
                         ? 1.f / sqrtf(mean_sq[row] + eps) : 1.f;
    const float gm = (gate_mul != nullptr && live) ? gate_mul[row] : 1.f;
    float rsq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int lc = 8 * j + 2 * (lane % 4);
      T* p = reinterpret_cast<T*>(stage + lr * ROW + sizeof(T) * lc);
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hr + e;
        y[e] = apply_act(acc[i] * rs, act);
        if (GLU) y[e] *= acc[i + 32] * rs;
        if (gate_mul != nullptr) y[e] *= gm;
      }
      if (residual != nullptr) {
        const float2 r = load2(p);
        y[0] += r.x;
        y[1] += r.y;
      }
      if (live && f0 + lc < F) {
        rsq = fmaf(y[0], y[0], rsq);
        rsq = fmaf(y[1], y[1], rsq);
      }
      store2(p, y[0], y[1]);
    }
    if (sq_part != nullptr) {
      rsq += __shfl_xor_sync(0xffffffffu, rsq, 1);
      rsq += __shfl_xor_sync(0xffffffffu, rsq, 2);
      if (lane % 4 == 0 && live)
        sq_part[static_cast<long long>(tile) * M + row] = rsq;
    }
  }
  sync();
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int id = t + 128 * i, r = id / CPR, c = EPC * (id % CPR);
    if (m0 + r < M && f0 + c < F)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(m0 + r) * F +
                                f0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * ROW + 16 * (id % CPR));
  }
}

// Second pass of the Σy² carry: sum the per-tile partials in ascending j.
__global__ void sq_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ sq, int M, int nj) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  for (int j = 0; j < nj; ++j) s += part[static_cast<long long>(j) * M + m];
  sq[m] = s;
}

inline void sq_reduce(const void* part, void* sq, int M, int nj,
                      cudaStream_t stream) {
  sq_reduce_kernel<<<(M + kSqReduceThreads - 1) / kSqReduceThreads,
                     kSqReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(sq), M, nj);
}

}  // namespace repro
