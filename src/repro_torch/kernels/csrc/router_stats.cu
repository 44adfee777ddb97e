// Router logits + RMSNorm mean square in one pass over x (paper Alg. 1
// ll. 4-7).
//
// Replaces the TPU kernel router_stats_pallas
// (src/repro/kernels/fused_router_rmsnorm.py).  The TPU pads the [D, 2]
// router weight to 128 lanes so the product is MXU-shaped; here each row is
// one block whose threads stride over D with three fp32 running sums (two
// dot products and Σx²), so no padding exists.
//
// Bound: bytes.  The kernel reads x once (T·D elements) and the tiny
// weight; it does 6 operations per element read, far below the card's
// operations-per-byte balance.  One block per row with coalesced reads
// keeps every SM streaming at prefill (T = 2048); at decode (T = B = 4) the
// kernel is launch-latency bound whatever its design.
//
// CUDA rather than Triton: the port builds all its kernels through one
// nvcc route, and this reduction is a dozen lines of it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void router_stats_kernel(const T* __restrict__ x,
                                    const float* __restrict__ w,
                                    float* __restrict__ logits,
                                    float* __restrict__ mean_sq, int D) {
  const int row = blockIdx.x;
  const T* xr = x + static_cast<long long>(row) * D;
  float s0 = 0.f, s1 = 0.f, sq = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = repro::to_f32(xr[d]);
    s0 = fmaf(v, w[2 * d], s0);
    s1 = fmaf(v, w[2 * d + 1], s1);
    sq = fmaf(v, v, sq);
  }
  __shared__ float part[3][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s0 = repro::warp_sum(s0);
  s1 = repro::warp_sum(s1);
  sq = repro::warp_sum(sq);
  if (lane == 0) {
    part[0][warp] = s0;
    part[1][warp] = s1;
    part[2][warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f, c = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) {  // fixed order
      a += part[0][i];
      b += part[1][i];
      c += part[2][i];
    }
    logits[2 * row] = a;
    logits[2 * row + 1] = b;
    mean_sq[row] = c / static_cast<float>(D);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* logits, void* mean_sq, int T_,
           int D, void* stream) {
  if (T_ > 0)
    router_stats_kernel<T><<<T_, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<float*>(logits), static_cast<float*>(mean_sq), D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [T, D] (bf16 or f32, contiguous); w: [D, 2] f32 contiguous;
// logits: [T, 2] f32; mean_sq: [T] f32.  Returns cudaGetLastError().
extern "C" int router_stats_bf16(const void* x, const void* w, void* logits,
                                 void* mean_sq, int T, int D, void* stream) {
  return launch<__nv_bfloat16>(x, w, logits, mean_sq, T, D, stream);
}
extern "C" int router_stats_f32(const void* x, const void* w, void* logits,
                                void* mean_sq, int T, int D, void* stream) {
  return launch<float>(x, w, logits, mean_sq, T, D, stream);
}
