// Router logits + RMSNorm mean square in one pass over x (paper Alg. 1
// ll. 4-7): logits[t] = x[t] · W_θ (W_θ [D, 2] fp32) and
// mean_sq[t] = Σ_d x[t, d]² / D, both in fp32.
//
// Replaces the TPU kernel router_stats_pallas
// (src/repro/kernels/fused_router_rmsnorm.py).  The TPU pads the [D, 2]
// router weight to 128 lanes so the product is MXU-shaped and carries the
// sums in VMEM scratch along a sequential D grid; here nothing is padded
// and each sum is a fixed-order fp32 reduction inside one launch.
//
// Bound: bytes.  The function reads x once (T·D elements) and w once (8·D
// bytes), and does 6 operations per element, far below the card's
// operations-per-byte balance.  w is four times x's bytes per element (two
// fp32 weights against one bf16 value): it is read through L1, so device
// memory and L2 see it about once an SM, not once a row.
//
// The order of the sums.  A row's D elements are dealt to 256 "order
// threads": thread t adds elements t, t + 256, t + 512, ... in that order
// (three fused multiply-adds each); the 32 threads of each of the 8 order
// warps are added by repro::warp_sum's butterfly; the 8 order warps' sums
// are added in ascending order from 0.  It is the order of the one-block-
// a-row kernel this file held before, kept so that the redesign changes no
// number anywhere: a row's results depend on D alone, never on the rows a
// block, the vector width or the other rows of the call (a request
// preempted and recomputed by a prefill gets the bits its decode steps
// got).  (Measured on the H100: an order of 16-byte vectors reached the
// same speed but changed the tokens of a preempted request in
// chip_smoke.py's phase 6, where the fused linear's tile and split-K
// stream round differently.)
//
// One kernel, one launch rule, which plan() in
// kernels/fused_router_rmsnorm.py applies.  A lane holds E = 2 order
// threads (E = 1 where D is odd or x's address is not aligned to 2
// elements), so a row takes 8 / E warps (4); a lane loads its E elements
// of each 256-element window (4 bytes of bf16) for up to kWindows windows
// at once (every window of a row up to D 4096: one round trip) before its
// first product, and their 2E weights (16 bytes) beside the products.  A
// block takes `rows` rows an iteration, 1, 2 or 4 (at most 16 warps),
// persistent past 264 blocks of 16 warps' worth: plan() picks the most
// rows that still give two blocks an SM (llama2-7b's and mamba2-2.7b's
// 2048-row prefill: 4 rows, 264 blocks, 32 warps and 64 KB of x in flight
// an SM; below 527 rows, decode's 4 included, one row a block, as many
// blocks as rows: a wide block a row, every load issued before the first
// product).
// (Measured on the H100 in this order: w staged in shared memory once a
// block, and lanes of 8 order threads loading 16 bytes of x, were both
// slower.  In another order, a cluster of blocks a row combined through
// distributed shared memory lost more to its launch than it gained.)
//
// No atomics: a second launch repeats the first bit for bit.  The C
// entries launch exactly the plan they are given and refuse
// (cudaErrorInvalidValue, nothing launched) one that disagrees with the
// constants below.
//
// CUDA rather than Triton: the port builds all its kernels through one
// nvcc route.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kOrderThreads = 256;  // of a row (above)
constexpr int kOrderWarps = kOrderThreads / 32;
constexpr int kWindows = 16;        // windows of 256 a lane loads at once,
//                                     8 where they are 8 bytes (fp32 pairs)
constexpr int kRowsWarps = 16;      // warps of a block, at most
constexpr int kRowsGridCap = 264;   // two such blocks on each of 132 SMs

// Raw storage of B bytes, loaded through the read-only path.
template <int B> struct Raw;
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// V consecutive elements of x, loaded as one 2V- or 4V-byte access.
template <typename T, int V>
struct Vec {
  using raw_t = typename Raw<V * static_cast<int>(sizeof(T))>::type;
  raw_t r;
  __device__ __forceinline__ void load(const T* p) {
    r = __ldg(reinterpret_cast<const raw_t*>(p));
  }
  // Element i as fp32 (bf16 widens exactly by a shift).
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return reinterpret_cast<const float*>(&r)[i];
    } else if constexpr (V == 1) {
      return __uint_as_float(static_cast<uint32_t>(r) << 16);
    } else {
      const uint32_t u = reinterpret_cast<const uint32_t*>(&r)[i / 2];
      return __uint_as_float(i % 2 ? (u & 0xffff0000u) : (u << 16));
    }
  }
};

// A lane's E weights pairs (w0, w1 of each of its E columns), 2E floats.
template <int E>
__device__ __forceinline__ void load_w(const float* p, float (&wl)[2 * E]) {
  if constexpr (E == 2) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    wl[0] = f.x; wl[1] = f.y; wl[2] = f.z; wl[3] = f.w;
  } else {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    wl[0] = f.x; wl[1] = f.y;
  }
}

// rows · 8 / E warps a block take `rows` rows an iteration (block b:
// iterations b, b + grid, ...); warp w takes row w / (8 / E) of it and
// order warps g·E .. g·E + E - 1, g = w % (8 / E); its lane l holds order
// threads 32·g·E + E·l + e, e < E, whose elements are E consecutive ones.
// Dynamic shared memory: the order warps' sums [rows][8][3].
template <typename T, int E>
__global__ void __launch_bounds__(32 * kRowsWarps, 2)
router_pass(const T* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ logits, float* __restrict__ mean_sq,
            int n_rows, int D, int rows) {
  constexpr int kWarpsARow = kOrderWarps / E;
  constexpr int kWin = E * sizeof(T) > 4 ? kWindows / 2 : kWindows;
  extern __shared__ float part[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / kWarpsARow, g = warp % kWarpsARow;
  const int d_lane = 32 * g * E + E * lane;  // its first element
  const int n_win = (D + kOrderThreads - 1) / kOrderThreads;
  const int n_iter = (n_rows + rows - 1) / rows;
  for (int it = blockIdx.x; it < n_iter; it += gridDim.x) {
    const int row = it * rows + slot;
    const bool live = row < n_rows;
    const T* const xr = x + static_cast<long long>(live ? row : 0) * D;
    float acc[E][3];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e][0] = acc[e][1] = acc[e][2] = 0.f;
    for (int i0 = 0; i0 < n_win; i0 += kWin) {
      Vec<T, E> xv[kWin];
#pragma unroll
      for (int u = 0; u < kWin; ++u) {
        const int d = d_lane + kOrderThreads * (i0 + u);
        if (live && d < D) xv[u].load(xr + d);
      }
      // w's loads depend on nothing here: the compiler issues them ahead
      // of the products as registers allow
#pragma unroll
      for (int u = 0; u < kWin; ++u) {
        const int d = d_lane + kOrderThreads * (i0 + u);
        if (live && d < D) {
          float wl[2 * E];
          load_w<E>(w + 2 * d, wl);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float v = xv[u].get(e);
            acc[e][0] = fmaf(v, wl[2 * e], acc[e][0]);
            acc[e][1] = fmaf(v, wl[2 * e + 1], acc[e][1]);
            acc[e][2] = fmaf(v, v, acc[e][2]);
          }
        }
      }
    }
    // repro::warp_sum over each order warp's lanes t % 32 = E·(l % (32/E))
    // + e: offsets of E and more between lanes, the rest between a lane's
    // own order threads (a + b and b + a are the same bits).
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (o >= E)
            acc[e][c] += __shfl_xor_sync(0xffffffffu, acc[e][c], o / E);
          else if ((e & o) == 0)
            acc[e][c] = acc[e][c] + acc[e + o][c];
        }
    // lane l now holds order warp g·E + l / (32 / E)
    if (lane % (32 / E) == 0) {
      float* const dst =
          part + (slot * kOrderWarps + g * E + lane / (32 / E)) * 3;
      dst[0] = acc[0][0];
      dst[1] = acc[0][1];
      dst[2] = acc[0][2];
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < rows * 3) {
      const int sl = t / 3, c = t - 3 * sl;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kOrderWarps; ++k)
        s += part[(sl * kOrderWarps + k) * 3 + c];
      const int r = it * rows + sl;
      if (r < n_rows) {
        if (c == 2)
          mean_sq[r] = s / static_cast<float>(D);
        else
          logits[2 * r + c] = s;
      }
    }
    __syncthreads();  // part is rewritten by the next iteration
  }
}

// ---------------------------------------------------------------------------
// Launch: the plan, checked against the constants above
// ---------------------------------------------------------------------------

struct Call {
  const void *x, *w;
  void *logits, *mean_sq;
  int T, D;
  cudaStream_t stream;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch(const Call& c, int grid, int threads, int rows, int vec,
           int smem) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  constexpr int esize = static_cast<int>(sizeof(T));
  if (c.T < 0 || c.D < 0 || (vec != 1 && vec != 2) || c.D % vec ||
      reinterpret_cast<uintptr_t>(c.x) % (vec * esize) ||
      reinterpret_cast<uintptr_t>(c.w) % 16)
    return bad;
  const int warps_a_row = kOrderWarps / vec;
  if (rows < 1 || rows * warps_a_row > kRowsWarps || (rows & (rows - 1)) != 0)
    return bad;
  const int n_iter = ceil_div(c.T, rows);
  const int cap = kRowsGridCap * kRowsWarps / (rows * warps_a_row);
  if (grid != (n_iter < cap ? n_iter : cap)) return bad;
  if (threads != 32 * warps_a_row * rows || smem != rows * kOrderWarps * 3 * 4)
    return bad;
  if (c.T == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = vec == 2 ? router_pass<T, 2> : router_pass<T, 1>;
  kernel<<<grid, threads, smem, c.stream>>>(
      static_cast<const T*>(c.x), static_cast<const float*>(c.w),
      static_cast<float*>(c.logits), static_cast<float*>(c.mean_sq), c.T,
      c.D, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [T, D] (bf16 or f32, contiguous, aligned to vec elements); w: [D, 2]
// f32 contiguous, 16-byte aligned; logits: [T, 2] f32; mean_sq: [T] f32.
// The plan (grid; threads; rows a block; vector width E; dynamic shared
// memory) comes from plan() in
// kernels/fused_router_rmsnorm.py and is launched exactly: one that
// disagrees with this file's constants returns cudaErrorInvalidValue
// before anything is launched.  Returns the first CUDA error, else
// cudaGetLastError().
extern "C" int router_stats_bf16(const void* x, const void* w, void* logits,
                                 void* mean_sq, int T, int D, int grid,
                                 int threads, int rows, int vec, int smem,
                                 void* stream) {
  return launch<__nv_bfloat16>(
      Call{x, w, logits, mean_sq, T, D, static_cast<cudaStream_t>(stream)},
      grid, threads, rows, vec, smem);
}
extern "C" int router_stats_f32(const void* x, const void* w, void* logits,
                                void* mean_sq, int T, int D, int grid,
                                int threads, int rows, int vec, int smem,
                                void* stream) {
  return launch<float>(
      Call{x, w, logits, mean_sq, T, D, static_cast<cudaStream_t>(stream)},
      grid, threads, rows, vec, smem);
}
