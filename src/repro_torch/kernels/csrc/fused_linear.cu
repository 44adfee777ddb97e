// Fused linear pipeline, dense weights: RMSNorm prologue x matmul x
// {GLU, gate_mul, residual, Σy²} epilogue (paper Alg. 1 + §4.2).
//
// Replaces the dense-weight branch of the TPU kernel fused_linear_pallas
// (src/repro/kernels/fused_linear.py:135); its int4-BFP branch is
// fused_linear_int4.cu.
//
//   y   = act((x · rsqrt(mean_sq + eps) · gamma) @ W)          (no GLU)
//   y   = act(xn @ W[:, :F]) * (xn @ W[:, F:])                 (GLU, W [K, 2F])
//   y   = y · gate_mul + residual;  out = cast(y);  sq = Σ_f y²  (fp32, pre-cast)
//
// Three routes.  The wrapper's plan() (kernels/fused_linear.py) picks one
// by dtype and M alone, with its tile, split and scratch sizes; the C
// entries launch exactly that grid and refuse a tile this file has no
// instantiation of, or scratch shorter than the grid writes.  The
// threshold between the two bf16 routes is M = 16 (SPLITK_MAX_M there).
//
// 1. bf16, M > 16: the tensor-core tile (fused_linear_tc).  Bound by
//    operations at prefill: the four linears of a llama2-7b layer at
//    M = 2048 are 829 GFLOP, 0.84 ms at 989 TFLOP/s.  A block owns 128
//    rows x 128 weight columns (128 output columns, or for the GLU 64:
//    the gate and the up columns of the same outputs side by side, so one
//    accumulator holds both) and walks K in steps of 64.  One producer
//    warpgroup (one thread) fills a ring of 4 shared-memory stages with
//    TMA copies in the 128-byte swizzle, signalled through mbarriers; two
//    consumer warpgroups each issue bf16 wgmma m64n128k16 with fp32
//    accumulators over 64 of the rows.  B (W [K, N], N contiguous) is
//    MN-major, the transpose bit.  setmaxnreg moves the producer's
//    registers to the consumers.  The epilogue (store_frag in
//    fused_epilogue.cuh) works on the accumulator fragments and passes
//    each warpgroup's tile through shared memory, so the residual and the
//    output move as 16-byte chunks (the wrapper pads K and F to multiples
//    of 8).
//
//    The tensor cores' fp32 accumulator truncates at each step; over
//    K = 11008 that biased Σy² past the 1e-5 (relative) the checks hold
//    it to.  So every 8 stages the accumulator restarts from zero and is
//    added, rounded, into a second fp32 sum: the bias of a short chain.
//
//    Where the bf16 rounding happens.  The tensor cores take bf16
//    operands, so the normalised activation cannot enter them in fp32.
//    With the prologue, A comes from registers: ldmatrix reads the
//    warp's fragment of the staged x tile and __hmul2 multiplies it by
//    gamma[k], bf16(x · gamma), the exact product of two bf16 values
//    rounded once; the next stage's fragments are prepared while this
//    stage's wgmma runs.  rsqrt(mean_sq + eps) is a per-row factor, so it
//    multiplies the fp32 accumulator in the epilogue and is never rounded
//    to bf16.  This is the route's one rounding against the fp32
//    reference; without the prologue A is x itself, read by wgmma from
//    shared memory, exactly.
//
// 2. bf16, M <= 16: the split-K weight stream (splitk_stream, then
//    splitk_epilogue).  Bound by the weight bytes at decode: 404.8 MB per
//    llama2-7b layer, 0.121 ms at 3.35 TB/s.  Each lane streams 8 weight
//    columns with 16-byte loads, four rows in flight; a block's 8 warps
//    take interleaved rows of one K split, and K is split so that each
//    linear fills about one wave of 4 blocks per SM.  The prologue is
//    applied in fp32 to the few x rows as they are staged (no bf16
//    rounding on this route), FMAs accumulate in fp32, and the block sums
//    its warps in warp order into its K partial [S, M, N].  A second
//    kernel sums the partials in ascending split order, applies the
//    epilogue, and writes Σy² itself, in the place of sq_reduce: wo and
//    down launch two kernels as before, wqkv and gu one more.
//
// 3. fp32: the SIMT kernel (fused_linear_kernel), shared-memory tiles and
//    fp32 FMAs; the parity instrument of the CPU ≡ CUDA checks.
//
// Σy² without atomics.  Routes 1 and 3 write one partial per row and
// output tile and sq_reduce adds them in ascending tile order
// (fused_epilogue.cuh); route 2's epilogue adds a row's blocks in rank
// order within one thread-block cluster.  Σy² therefore repeats bit for
// bit, and with it the next block's norm and its router gate.  No state
// outlives a launch: the wrapper allocates all scratch per call.
#include <cooperative_groups.h>

#include "fused_epilogue.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// Route 3: the SIMT kernel (fp32)
// ---------------------------------------------------------------------------

constexpr int kBK = 16;

template <int BM, int BN, int TM, int TN, bool GLU>
__global__ void __launch_bounds__(kThreads)
fused_linear_kernel(const float* __restrict__ x,
                    const float* __restrict__ mean_sq,
                    const float* __restrict__ gamma,
                    const float* __restrict__ w,
                    const float* __restrict__ residual,
                    const float* __restrict__ gate_mul, float* __restrict__ out,
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
        v = x[static_cast<long long>(gm) * K + gk];
        if (prologue) v = v * rs[r] * gamma[gk];
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
        v = w[static_cast<long long>(gk) * N + col];
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

  repro::store_tile<float, TM, TN, TX, GLU>(acc, accu, m0 + ty * TM, f0 + tx,
                                             M, F, act, residual, gate_mul,
                                             out, sq_part, blockIdx.x,
                                             tx == 0);
}

// Launches one SIMT tile configuration; sq_cap: the entries sq_part holds.
template <int BM, int BN, int TM, int TN, bool GLU>
cudaError_t launch_tile(const void* x, const void* ms, const void* gamma,
                        const void* w, const void* res, const void* gmul,
                        void* out, void* sq_part, void* sq, long long sq_cap,
                        int M, int K, int F, int act, float eps,
                        cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  if (sq != nullptr && static_cast<long long>(grid.x) * M > sq_cap)
    return cudaErrorInvalidValue;
  fused_linear_kernel<BM, BN, TM, TN, GLU><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ms),
      static_cast<const float*>(gamma), static_cast<const float*>(w),
      static_cast<const float*>(res), static_cast<const float*>(gmul),
      static_cast<float*>(out), static_cast<float*>(sq_part), M, K, F, act,
      eps);
  if (sq != nullptr)
    repro::sq_reduce(sq_part, sq, M, static_cast<int>(grid.x), stream);
  return cudaSuccess;
}

// The SIMT tiles the source instantiates, (tile_m, tile_n): (16, 64) for
// either width, (128, 64) with glu, (128, 128) without.
cudaError_t launch_simt(const void* x, const void* ms, const void* gamma,
                        const void* w, const void* res, const void* gmul,
                        void* out, void* sq_part, void* sq, long long sq_cap,
                        int M, int K, int F, int glu, int act, int tile_m,
                        int tile_n, float eps, cudaStream_t s) {
  if (tile_m == 16 && tile_n == 64) {
    if (glu)
      return launch_tile<16, 64, 1, 4, true>(x, ms, gamma, w, res, gmul, out,
                                             sq_part, sq, sq_cap, M, K, F,
                                             act, eps, s);
    return launch_tile<16, 64, 1, 4, false>(x, ms, gamma, w, res, gmul, out,
                                            sq_part, sq, sq_cap, M, K, F, act,
                                            eps, s);
  }
  if (tile_m == 128 && tile_n == 64 && glu)
    return launch_tile<128, 64, 8, 4, true>(x, ms, gamma, w, res, gmul, out,
                                            sq_part, sq, sq_cap, M, K, F, act,
                                            eps, s);
  if (tile_m == 128 && tile_n == 128 && !glu)
    return launch_tile<128, 128, 8, 8, false>(x, ms, gamma, w, res, gmul, out,
                                              sq_part, sq, sq_cap, M, K, F,
                                              act, eps, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Route 1: the tensor-core tile (bf16, M > 16)
// ---------------------------------------------------------------------------

constexpr int kTcConsumers = 2;                 // consumer warpgroups
constexpr int kTcBM = 64 * kTcConsumers;        // rows per block
constexpr int kTcBK = 64;                       // K per stage: 128-byte rows
constexpr int kTcBW = 128;                      // weight columns per stage
constexpr int kTcStages = 4;
constexpr int kTcPromote = 8;                   // stages per fp32 promotion
constexpr int kTcThreads = 128 * (kTcConsumers + 1);  // + the producer
// Registers per thread after setmaxnreg: the producer warpgroup hands its
// share to the consumers (384 threads launch at 168 each; 128 x 40 +
// 256 x 232 fits the 64 K of an SM).
constexpr int kTcProducerRegs = 40, kTcConsumerRegs = 232;
constexpr int kTcABytes = kTcBM * kTcBK * 2;            // 16 KB
constexpr int kTcAtomBytes = kTcBK * 64 * 2;            // 64 columns: 8 KB
constexpr int kTcStageBytes = kTcABytes + kTcBW / 64 * kTcAtomBytes;
// A warpgroup's staged output tile: 64 rows of 128 bf16 + 16 bytes of pad.
constexpr int kTcEpiBytes = 64 * (2 * kTcBW + 16);
// Dynamic shared memory: the ring, its barriers, with the prologue a copy
// of gamma (read per fragment), and the staged epilogue.
constexpr int kTcGammaMax = 16384;  // K the prologue's gamma copy allows
template <bool PRO>
int tc_smem(int K) {
  return kTcStages * kTcStageBytes + 2 * kTcStages * 8 + (PRO ? 2 * K : 0) +
         kTcConsumers * kTcEpiBytes + 1024;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 y =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// The prologue's gamma.  This warp's A fragments of one stage (its 16
// rows of the warpgroup's tile at a_wg, the 4 k16 steps; the
// mma.m16n8k16 A layout that wgmma takes from registers) come from the
// swizzled tile by ldmatrix (chunk c of row r at 16-byte position
// c ^ (r % 8)) and are multiplied by gamma[k] (gamma_s: its copy in
// shared memory) with __hmul2: bf16(x · gamma), the exact product of two
// bf16 values rounded once.
__device__ __forceinline__ void load_a_scaled(uint32_t (&a)[4][4],
                                              uint32_t a_wg, int warp,
                                              int lane, int k0, int K,
                                              const bf16* gamma_s) {
  const int j = lane / 8, r = 16 * warp + (j % 2) * 8 + lane % 8;
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk) {
    const uint32_t addr = a_wg + r * 128 + (((2 * kk + j / 2) ^ (r & 7)) << 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(addr)
        : "memory");
    const int k = k0 + 16 * kk + 2 * (lane % 4);  // a[0], a[1]: k, k + 1
    const uint32_t lo =
        k < K ? *reinterpret_cast<const uint32_t*>(gamma_s + k) : 0u;
    const uint32_t hi =
        k + 8 < K ? *reinterpret_cast<const uint32_t*>(gamma_s + k + 8) : 0u;
    a[kk][0] = mul_bf16x2(a[kk][0], lo);
    a[kk][1] = mul_bf16x2(a[kk][1], lo);
    a[kk][2] = mul_bf16x2(a[kk][2], hi);
    a[kk][3] = mul_bf16x2(a[kk][3], hi);
  }
}

// tmx: x [M, K] in boxes of 64 k x 128 rows; tmw: w [K, N] in boxes of
// 64 columns x 64 k (N = 2F with GLU, else F); both bf16 with the
// 128-byte swizzle, zero outside.  Non-GLU blocks own 128 output columns
// (w columns f0 .. f0+127); GLU blocks own 64, with the gate columns f0..
// and the up columns F + f0.. side by side in one 128-wide B tile.
template <bool GLU, bool PRO>
__global__ void __launch_bounds__(kTcThreads, 1)
fused_linear_tc(const __grid_constant__ CUtensorMap tmx,
                const __grid_constant__ CUtensorMap tmw,
                const float* __restrict__ mean_sq,
                const bf16* __restrict__ gamma,
                const bf16* __restrict__ residual,
                const float* __restrict__ gate_mul, bf16* __restrict__ out,
                float* __restrict__ sq_part, int M, int K, int F, int act,
                float eps) {
  constexpr int BNO = GLU ? kTcBW / 2 : kTcBW;  // output columns per block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  // Per stage: full (the TMA copies landed), empty (both consumer
  // warpgroups' wgmma retired).
  const uint32_t full = base + kTcStages * kTcStageBytes;
  const uint32_t empty = full + kTcStages * 8;

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * kTcBM, f0 = blockIdx.y * BNO;
  const int nk = (K + kTcBK - 1) / kTcBK;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kTcConsumers) {  // the producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTcProducerRegs));
    if (tid == 128 * kTcConsumers) {
      const int c0 = f0, c1 = GLU ? F + f0 : f0 + 64;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTcStages;
        if (kt >= kTcStages) mbar_wait(empty + 8 * s, (kt / kTcStages - 1) & 1);
        const uint32_t sa = base + s * kTcStageBytes, sb = sa + kTcABytes;
        mbar_expect_tx(full + 8 * s, kTcStageBytes);
        tma_load(sa, &tmx, full + 8 * s, kt * kTcBK, m0);
        tma_load(sb, &tmw, full + 8 * s, c0, kt * kTcBK);
        tma_load(sb + kTcAtomBytes, &tmw, full + 8 * s, c1, kt * kTcBK);
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63, A from
  // shared memory, or with the prologue from registers scaled by gamma.
  // The tensor cores' fp32 accumulator truncates at each step, so every
  // kTcPromote stages it restarts from zero and its value is added, with
  // rounding, into `sum`: the bias stays that of a short chain.  The wait
  // for stage kt + 1, and its A fragments, overlap the wgmma group of
  // stage kt.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTcConsumerRegs));
  uint8_t* const tail = smem_raw + (base - raw) + kTcStages * kTcStageBytes +
                        2 * kTcStages * 8;  // gamma, then the staged epilogue
  bf16* const gamma_s = reinterpret_cast<bf16*>(tail);
  if constexpr (PRO) {  // gamma to shared memory while the first stages land
    for (int i = tid; i < K / 8; i += 128 * kTcConsumers)
      reinterpret_cast<uint4*>(gamma_s)[i] =
          __ldg(reinterpret_cast<const uint4*>(gamma) + i);
    asm volatile("bar.sync 3, %0;\n" ::"n"(128 * kTcConsumers) : "memory");
  }
  const int t128 = tid % 128, warp = t128 / 32, lane = t128 % 32;
  const uint32_t a_off = wg * 64 * 128;  // this warpgroup's rows of A
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  uint32_t a[4][4], a_next[4][4];  // scaled A fragments, stage kt and kt + 1
  mbar_wait(full, 0);
  if constexpr (PRO)
    load_a_scaled(a_next, base + a_off, warp, lane, 0, K, gamma_s);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kTcStages;
    const uint32_t sa = base + s * kTcStageBytes + a_off;
    const uint32_t sb = base + s * kTcStageBytes + kTcABytes;
    if constexpr (PRO) {
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i / 4][i % 4] = a_next[i / 4][i % 4];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint64_t db = smem_desc(sb + kk * 16 * 128, kTcAtomBytes, 1024);
      const uint32_t accumulate = (kk > 0 || kt % kTcPromote != 0) ? 1u : 0u;
      if constexpr (PRO)
        wgmma_m64n128k16_rs(acc, a[kk], db, accumulate);
      else
        wgmma_m64n128k16<1>(acc, smem_desc(sa + kk * 32, 16, 1024), db,
                            accumulate);
    }
    wgmma_commit();
    if (kt + 1 < nk) {
      const int s1 = (kt + 1) % kTcStages;
      mbar_wait(full + 8 * s1, ((kt + 1) / kTcStages) & 1);
      if constexpr (PRO)
        load_a_scaled(a_next, base + s1 * kTcStageBytes + a_off, warp, lane,
                      (kt + 1) * kTcBK, K, gamma_s);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (PRO) fence_regs(a);
    mbar_arrive(empty + 8 * s);
    if (kt % kTcPromote == kTcPromote - 1 || kt == nk - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
  }

  repro::store_frag<GLU>(sum, m0 + wg * 64, f0, M, F, act, mean_sq, eps,
                         residual, gate_mul, out, sq_part, blockIdx.y,
                         tail + (PRO ? 2 * K : 0) + wg * kTcEpiBytes, 1 + wg);
}

template <bool GLU, bool PRO>
cudaError_t launch_tc(const void* x, const void* ms, const void* gamma,
                      const void* w, const void* res, const void* gmul,
                      void* out, void* sq_part, void* sq, long long sq_cap,
                      int M, int K, int F, int act, float eps,
                      cudaStream_t stream) {
  constexpr int BNO = GLU ? kTcBW / 2 : kTcBW;
  const dim3 grid((M + kTcBM - 1) / kTcBM, (F + BNO - 1) / BNO);
  if ((PRO && K > kTcGammaMax) ||
      (sq != nullptr && static_cast<long long>(grid.y) * M > sq_cap))
    return cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  const cudaError_t e = opt_in_smem(fused_linear_tc<GLU, PRO>,
                                    tc_smem<PRO>(kTcGammaMax), configured);
  if (e != cudaSuccess) return e;
  CUtensorMap tmx, tmw;
  if (!tensor_map(&tmx, x, K, M, kTcBK, kTcBM) ||
      !tensor_map(&tmw, w, GLU ? 2 * F : F, K, 64, kTcBK))
    return cudaErrorInvalidValue;
  fused_linear_tc<GLU, PRO><<<grid, kTcThreads, tc_smem<PRO>(K), stream>>>(
      tmx, tmw, static_cast<const float*>(ms),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(res),
      static_cast<const float*>(gmul), static_cast<bf16*>(out),
      static_cast<float*>(sq_part), M, K, F, act, eps);
  if (sq != nullptr)
    repro::sq_reduce(sq_part, sq, M, static_cast<int>(grid.y), stream);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Route 2: the split-K weight stream (bf16, small M)
// ---------------------------------------------------------------------------

constexpr int kSkCols = 256;           // weight columns per block: 32 lanes x 8
constexpr int kSkWarps = kThreads / 32;
constexpr int kSkUnroll = 4;           // 16-byte loads in flight per lane
constexpr int kSkStage = 4096;         // staged activations: kc · MT <= this
constexpr int kEpiCluster = 8;         // epilogue blocks per row, one cluster
constexpr int kEpiThreads = 128;
static_assert(kSkCols == kThreads, "one reduction column per thread");

__device__ __forceinline__ uint4 ld_stream(const bf16* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Block (column tile j, split s): part[s, m, 256 j + c] = Σ over the
// split's K rows of xn[m, k] · w[k, 256 j + c], rows m < M <= MT.
template <int MT>
__global__ void __launch_bounds__(kThreads)
splitk_stream(const bf16* __restrict__ x, const float* __restrict__ mean_sq,
              const bf16* __restrict__ gamma, const bf16* __restrict__ w,
              float* __restrict__ part, int M, int K, int ldw, int kc,
              float eps) {
  __shared__ __align__(16) float xs[kSkStage];
  __shared__ float red[kSkWarps][2][kSkCols];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kSkCols, k0 = blockIdx.y * kc;
  const int kn = min(kc, K - k0);

  // The prologue in fp32 registers, the plain version's expression and
  // order, as the split's few x rows are staged.
  for (int e = tid; e < kn * MT; e += kThreads) {
    const int kk = e / MT, m = e % MT;
    float v = 0.f;
    if (m < M) {
      v = repro::to_f32(x[static_cast<long long>(m) * K + k0 + kk]);
      if (mean_sq != nullptr)
        v = v * (1.f / sqrtf(mean_sq[m] + eps)) *
            repro::to_f32(gamma[k0 + kk]);
    }
    xs[e] = v;
  }
  __syncthreads();

  const int col = n0 + 8 * lane;
  const bool live = col < ldw;
  const bf16* const wp = w + static_cast<long long>(k0) * ldw + col;
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k = warp; k < kn; k += kSkWarps * kSkUnroll) {
    uint4 v[kSkUnroll];
#pragma unroll
    for (int u = 0; u < kSkUnroll; ++u) {
      const int kr = k + u * kSkWarps;
      v[u] = (live && kr < kn) ? ld_stream(wp + static_cast<long long>(kr) * ldw)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kSkUnroll; ++u) {
      const int kr = k + u * kSkWarps;
      if (kr < kn) {
        float wf[8];
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(&v[u]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&vw[q]));
          wf[2 * q] = f.x;
          wf[2 * q + 1] = f.y;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a = xs[kr * MT + m];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(a, wf[j], acc[m][j]);
        }
      }
    }
  }

  // The 8 warps' sums, added in warp order, 2 rows at a time.
#pragma unroll
  for (int mb = 0; mb < MT; mb += 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][r][8 * lane + j] = acc[mb + r][j];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = red[0][r][tid];
#pragma unroll
      for (int q = 1; q < kSkWarps; ++q) s += red[q][r][tid];
      const int m = mb + r, n = n0 + tid;
      if (m < M && n < ldw)
        part[(static_cast<long long>(blockIdx.y) * M + m) * ldw + n] = s;
    }
    __syncthreads();
  }
}

// Block (c, m), one of the kEpiCluster blocks of row m's cluster: sums the
// S partials of its 4-column groups in ascending split order, applies the
// epilogue and writes out.  With sq, Σy² of the row: each thread adds its
// columns in order, the block adds its threads in a fixed order, and block
// 0 of the cluster adds the blocks' sums in rank order from their shared
// memory (no atomics, nothing that outlives the launch).  With GLU the up
// half of a partial row starts at column F = ldw / 2.
template <bool GLU>
__global__ void __cluster_dims__(kEpiCluster, 1, 1)
    __launch_bounds__(kEpiThreads)
splitk_epilogue(const float* __restrict__ part, int S,
                const bf16* __restrict__ residual,
                const float* __restrict__ gate_mul, bf16* __restrict__ out,
                float* __restrict__ sq, int M, int F, int act) {
  namespace cg = cooperative_groups;
  __shared__ float wsum[kEpiThreads / 32];
  __shared__ float bsum;
  const int m = blockIdx.y, ldw = GLU ? 2 * F : F;
  const int groups = F / 4, per = (groups + kEpiCluster - 1) / kEpiCluster;
  const int g0 = blockIdx.x * per, g1 = min(groups, g0 + per);
  const long long stride = static_cast<long long>(M) * ldw;
  const float* const prow = part + static_cast<long long>(m) * ldw;
  const float gm = gate_mul != nullptr ? gate_mul[m] : 1.f;
  float rsq = 0.f;
  for (int g = g0 + static_cast<int>(threadIdx.x); g < g1; g += kEpiThreads) {
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f), u = y;
    for (int s = 0; s < S; ++s) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(
          prow + s * stride + 4 * g));
      y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
      if (GLU) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(
            prow + s * stride + F + 4 * g));
        u.x += q.x; u.y += q.y; u.z += q.z; u.w += q.w;
      }
    }
    float v[4] = {y.x, y.y, y.z, y.w};
    const float up[4] = {u.x, u.y, u.z, u.w};
    const long long o = static_cast<long long>(m) * F + 4 * g;
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    if (residual != nullptr) {
      const uint2 rv = *reinterpret_cast<const uint2*>(residual + o);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&rv.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&rv.y));
      r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = repro::apply_act(v[i], act);
      if (GLU) v[i] *= up[i];
      if (gate_mul != nullptr) v[i] *= gm;
      if (residual != nullptr) v[i] += r[i];
      rsq = fmaf(v[i], v[i], rsq);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 ov;
    ov.x = *reinterpret_cast<const uint32_t*>(&lo);
    ov.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + o) = ov;
  }
  if (sq == nullptr) return;  // uniform over the cluster: no cluster sync
  rsq = repro::warp_sum(rsq);
  if (threadIdx.x % 32 == 0) wsum[threadIdx.x / 32] = rsq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kEpiThreads / 32; ++q) s += wsum[q];
    bsum = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's bsum is written
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    float s = 0.f;
    for (int b = 0; b < kEpiCluster; ++b) s += *cluster.map_shared_rank(&bsum, b);
    sq[m] = s;
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

// The stream, then the epilogue pass over its partials: two launches, the
// first on a (column tile, split) grid, the second on (kEpiCluster, M).
template <int MT>
void launch_splitk(const void* x, const void* ms, const void* gamma,
                   const void* w, const void* res, const void* gmul,
                   void* out, void* sq, void* part, int M, int K, int F,
                   int glu, int act, int splits, int kc, float eps,
                   cudaStream_t s) {
  const int ldw = glu ? 2 * F : F;
  const dim3 g1((ldw + kSkCols - 1) / kSkCols, splits);
  splitk_stream<MT><<<g1, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ms),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(w),
      static_cast<float*>(part), M, K, ldw, kc, eps);
  auto epi = glu ? splitk_epilogue<true> : splitk_epilogue<false>;
  epi<<<dim3(kEpiCluster, M), kEpiThreads, 0, s>>>(
      static_cast<const float*>(part), splits, static_cast<const bf16*>(res),
      static_cast<const float*>(gmul), static_cast<bf16*>(out),
      static_cast<float*>(sq), M, F, act);
}

}  // namespace

// bf16, on the route, tile and split the caller's plan chose
// (kernels/fused_linear.py, plan()); this entry launches exactly that grid.
// x [M, K], w [K, N] (N = 2F with glu, the up half at column F),
// residual/out [M, F]: K and F multiples of 8, every tensor 16-byte
// aligned (the wrapper pads K and F for shapes off them).  mean_sq [M],
// gate_mul [M] f32; gamma [K] (K <= 16384 on the tile).  Optional inputs
// are null.  act: 0 none, 1 silu.
//   splits == 0: the tensor-core tile, tile_m = 128 rows x tile_n = 128
//     output columns (64 with glu) per block; sq_part: f32 Σy² partials
//     [column tiles, M] of sq_cap entries, with sq [M] f32.
//   splits > 0: the split-K stream, tile_m = 4, 8 or 16 rows (>= M),
//     tile_n = 256 weight columns per block, kc K rows per split (splits·kc
//     >= K > (splits - 1)·kc, kc·tile_m <= 4096); part: f32 partials
//     [splits, M, N] of part_cap entries.  The epilogue pass writes sq.
// A tile the source has no instantiation of, scratch shorter than the
// grid writes, or any other size or alignment the kernels do not take
// returns cudaErrorInvalidValue before anything is launched.  Returns the
// first CUDA error, else cudaGetLastError().
extern "C" int fused_linear_bf16(const void* x, const void* mean_sq,
                                 const void* gamma, const void* w,
                                 const void* residual, const void* gate_mul,
                                 void* out, void* sq_part, void* sq,
                                 void* part, int M, int K, int F, int glu,
                                 int act, int tile_m, int tile_n, int splits,
                                 int kc, long long sq_cap, long long part_cap,
                                 float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (K % 8 != 0 || F % 8 != 0 || !a16(x) || !a16(gamma) || !a16(w) ||
      !a16(residual) || !a16(out))
    return bad;
  const int ldw = glu ? 2 * F : F;
  if (splits > 0) {
    if (tile_n != kSkCols || M > tile_m || kc <= 0 ||
        static_cast<long long>(kc) * tile_m > kSkStage ||
        static_cast<long long>(splits) * kc < K ||
        static_cast<long long>(splits - 1) * kc >= K ||
        static_cast<long long>(splits) * M * ldw > part_cap)
      return bad;
    void (*sk)(const void*, const void*, const void*, const void*,
               const void*, const void*, void*, void*, void*, int, int, int,
               int, int, int, int, float, cudaStream_t) =
        tile_m == 4 ? launch_splitk<4>
        : tile_m == 8 ? launch_splitk<8>
        : tile_m == 16 ? launch_splitk<16> : nullptr;
    if (sk == nullptr) return bad;
    sk(x, mean_sq, gamma, w, residual, gate_mul, out, sq, part, M, K, F, glu,
       act, splits, kc, eps, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (tile_m != kTcBM || tile_n != (glu ? kTcBW / 2 : kTcBW)) return bad;
  if (sq == nullptr) sq_part = nullptr;
  const auto tc = mean_sq != nullptr
                      ? (glu ? launch_tc<true, true> : launch_tc<false, true>)
                      : (glu ? launch_tc<true, false> : launch_tc<false, false>);
  const cudaError_t e = tc(x, mean_sq, gamma, w, residual, gate_mul, out,
                           sq_part, sq, sq_cap, M, K, F, act, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// fp32, the SIMT kernel, on the tile the caller's plan chose: tile_m x
// tile_n of (16 x 64), (128 x 64) with glu, (128 x 128) without.  x [M, K],
// w [K, N] (N = 2F with glu), residual/out [M, F], contiguous.  mean_sq
// [M], gate_mul [M] f32; gamma [K].  Optional inputs are null.  sq_part:
// f32 Σy² partials [column tiles, M] of sq_cap entries, with sq [M].  A
// tile without an instantiation or scratch too short returns
// cudaErrorInvalidValue.
extern "C" int fused_linear_f32(const void* x, const void* mean_sq,
                                const void* gamma, const void* w,
                                const void* residual, const void* gate_mul,
                                void* out, void* sq_part, void* sq, int M,
                                int K, int F, int glu, int act, int tile_m,
                                int tile_n, long long sq_cap, float eps,
                                void* stream) {
  if (M <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (sq == nullptr) sq_part = nullptr;
  const cudaError_t e = launch_simt(x, mean_sq, gamma, w, residual, gate_mul,
                                    out, sq_part, sq, sq_cap, M, K, F, glu,
                                    act, tile_m, tile_n, eps,
                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
