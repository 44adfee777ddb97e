// Epilogue shared by the fused linear kernels (dense and int4-BFP weights):
// activation / GLU, per-row gate multiplier, residual add, the cast to the
// storage type, and Σy² of the written rows.
//
// Σy² across output tiles.  The TPU kernel carries Σy² across the j tiles
// in VMEM because its grid visits j in order; CUDA blocks run in no order.
// Each block writes its per-row partial (a fixed-order shuffle reduction
// over the TX threads sharing a row) to sq_part[j, m], and sq_reduce_kernel
// sums the partials in ascending j.  No atomics, so Σy² — and with it the
// next block's norm and its strict-`>` router gate — repeats bit for bit.
#pragma once
#include "common.cuh"

namespace repro {

constexpr int kActSilu = 1;
constexpr int kSqReduceThreads = 256;

__device__ __forceinline__ float apply_act(float y, int act) {
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
