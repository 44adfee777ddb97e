// Fused linear pipeline, int4-BFP weights (paper Alg. 1 + §4.2 float-fixed
// hybrid PE array), and the bare int4 matmul (the same entry with no
// prologue and no epilogue).
//
// Replaces the int4 branch of the TPU kernel fused_linear_pallas
// (src/repro/kernels/fused_linear.py:93) and int4_matmul_pallas
// (src/repro/kernels/int4_matmul.py:66).
//
//   xn  = x · (1 / sqrt(mean_sq + eps)) · gamma                 (prologue)
//   per row m and K-group c (G rows of the codes, one scale row):
//     e   = ceil(log2 max|xn[m, group c]|)   (0 for an all-zero group)
//     q   = clip(rint(xn · 2^7 / 2^e), -128, 127)               int8
//     acc = Σ_k q[m, k] · code[k, n]                            int32, exact
//     y  += acc · 2^(e-7) · scale[c, n]                         fp32
//   then act / GLU, gate_mul, residual, cast, Σy² (fused_epilogue.cuh).
//
// The mantissas, the integer sums and each group's term t·scale (t =
// float(acc)·2^(e-7)) are computed with explicitly rounded operations in
// the order of the plain version (ref.bfp_matmul_f32), so they equal it
// bit for bit; only the order in which the fp32 group terms are added
// depends on the route, as below.
//
// Two routes.  The wrapper's plan_int4() (kernels/fused_linear.py) picks
// one by M alone, with its tile, K split and scratch sizes; the C entries
// launch exactly that grid and refuse any other (cudaErrorInvalidValue).
// Both take bf16 or fp32 activations: the tensor cores see only the int8
// mantissas and the int4 codes, whatever x's type.
//
// 1. M > 16: the tensor-core tile (bfp_prepass, then int4_tc).  Bound by
//    int8 operations at prefill (256 per code byte at M = 2048).  A
//    pre-pass writes the prologue's BFP mantissas once per call, [M, C·Gq]
//    int8 with each group zero-padded to Gq = a multiple of 32 k, and the
//    steps 2^(e-7) as [C, M] f32: one more launch per prefill call, and
//    8 MB at M = 2048, where converting in the tile would repeat the
//    conversion in every column tile.  The tile is 128 rows x 128 code
//    columns (128 outputs, or for the GLU the gate and up columns of 64
//    outputs side by side) and walks K in stages of 128 mantissa slots
//    (one group at G = 128).  Producer warp 0 keeps a ring of 4 stages
//    loading (3 with fp32 activations, whose staged epilogue is twice as
//    large) by TMA: the mantissas in the 128-byte swizzle, the codes as
//    four 32-row boxes of 128 columns at each slot's code rows.  Warps 1-3
//    turn each stage's codes K-major (16 x 8 byte blocks, byte permutes,
//    16-byte stores into the 128-byte swizzle) into a ring of 2, because
//    wgmma takes 8-bit operands only K-major and the codes are stored
//    [K, N].  Two consumer warpgroups each issue wgmma m64n128k32.s32.s8.s8
//    over 64 of the rows.  After each group's k32 steps a consumer waits
//    for its wgmma and promotes the exact int32 sums to fp32 (t =
//    float(acc)·step[m]; y += t·scale[c, n]) in ascending group order, so
//    the route equals the plain version bit for bit before the
//    activation; each consumer warp copies the scales and steps of its
//    next group but one with cp.async, so a promotion reads them from
//    shared memory.  A group whose G is not a multiple of 32 is
//    zero-padded in the mantissas: the code rows past it multiply zeros.
//    The epilogue is fused_epilogue.cuh's store_frag.
//
// 2. M <= 16: the split-K code stream (int4_stream).  Bound by the code
//    bytes at decode (1 B per code, 4 B per scale: 208.7 MB per llama2-7b
//    layer).  A warp streams 128 code columns of a run of whole K-groups
//    (its split), each lane 16 columns of 8 k rows per k32 step with
//    16-byte loads, the next step's loads in flight while this one is
//    multiplied.  Plain int32 multiply-adds would need 16 per code byte at
//    M = 4, about the card's whole int32 issue rate at its memory rate, so
//    the lane turns its 4x4 byte squares k-consecutive with byte permutes
//    and feeds mma.sync m16n8k32.s32.s8.s8 (codes as A, 16 columns; the
//    mantissas of up to 8 rows as B, broadcast from shared memory): a few
//    instructions per 16 bytes.  Each warp converts its own rows of x to
//    BFP per group (four rows side by side), so decode has no pre-pass
//    launch.  Four warps (four consecutive splits) make a block, and the
//    blocks of one column tile form a thread-block cluster along K (at
//    most 8); after the stream every rank adds, for its share of the
//    outputs, the splits' partials in ascending split order from the
//    ranks' shared memory (distributed shared memory, no atomics, nothing
//    that outlives the launch), then applies the epilogue.  Within a split
//    the fp32 group terms are added in ascending order;
//    ref.bfp_matmul_f32(split_groups=) mirrors that order bit for bit.
//    The warps' serial chains (conversion, loads, byte permutes), not the
//    memory system, bound it: a deeper code ring measured no faster.
//
// Σy² without atomics: one partial per row and tile (a column tile; on
// the stream a column tile's rank), added in ascending tile order by
// sq_reduce (fused_epilogue.cuh).  So Σy² repeats bit for bit, and with it
// the next block's norm and its router gate.
#include <cooperative_groups.h>

#include <cstdint>

#include "fused_epilogue.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxG = 128;          // the widest group either route takes
constexpr float kMant = 128.f;      // 2^MBITS
constexpr float kStep = 0.0078125f;  // 2^-MBITS

__host__ __device__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// t = float(acc) · step, exactly, for |acc| < 2^22 (|acc| <= 128·128·8 =
// 2^17) and step a power of two: the bits of 1.5·2^23 + acc, times step,
// less 1.5·2^23·step (`bias`, exact), all in one FFMA whose exact result
// needs no rounding.  One integer add and one FFMA instead of the slower
// I2F and a multiply.
constexpr float kMagic = 12582912.f;  // 1.5 · 2^23
__device__ __forceinline__ float scaled_sum(int acc, float step, float bias) {
  return __fmaf_rn(__int_as_float(acc + 0x4B400000), step, bias);
}

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

// 1 / sqrt(mean_sq + eps) as the plain version computes it (IEEE sqrt and
// division).
__device__ __forceinline__ float rsqrt_rn(float ms, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, eps)));
}

// One warp converts rows m0 .. m0+R-1 of K-group c (k0 = c·G) to BFP, the
// rows' chains side by side.  Lane l holds k = 4l .. 4l+3 of the group
// (zero past G, past K and for rows >= M); word[r] returns their mantissas
// packed 4 to a word (byte q: k 4l + q) and pe[r] 2^e.  With pro, xn =
// (x · rs[r]) · gamma first.
template <int R, typename T>
__device__ __forceinline__ void bfp_words(const T* __restrict__ x,
                                          const T* __restrict__ gamma,
                                          bool pro, const float (&rs)[R],
                                          int m0, int M, int K, int k0, int G,
                                          uint32_t (&word)[R],
                                          float (&pe)[R]) {
  const int lane = threadIdx.x % 32;
  float v[R][4], amax[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    amax[r] = 0.f;
    const int m = m0 + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = 4 * lane + q, gk = k0 + kk;
      float t = 0.f;
      if (m < M && kk < G && gk < K) {
        t = repro::to_f32(x[static_cast<long long>(m) * K + gk]);
        if (pro) t = __fmul_rn(__fmul_rn(t, rs[r]), repro::to_f32(gamma[gk]));
      }
      v[r][q] = t;
      amax[r] = fmaxf(amax[r], fabsf(t));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], o));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float e =
        amax[r] == 0.f ? 0.f : ceilf(log2f(fmaxf(amax[r], 1e-30f)));
    pe[r] = exp2f(e);
    // Dividing by a power of two and multiplying by its (exact)
    // reciprocal round the same exact value: one reciprocal per lane, not
    // four divisions.
    const float inv = __frcp_rn(pe[r]);
    word[r] = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float mt = rintf(__fmul_rn(__fmul_rn(v[r][q], kMant), inv));
      mt = fminf(fmaxf(mt, -128.f), 127.f);
      word[r] |= (static_cast<uint32_t>(static_cast<int>(mt)) & 0xffu)
                 << (8 * q);
    }
  }
}

// ---------------------------------------------------------------------------
// Route 1: the pre-pass and the tensor-core tile (M > 16)
// ---------------------------------------------------------------------------

// Warp (r, c): rows m = 4r .. 4r+3 of group c, side by side:
// mant[m, c·Gq .. c·Gq + Gq) (zero past G) and stepT[c, m] = 2^(e-7).
template <typename T>
__global__ void __launch_bounds__(256)
bfp_prepass(const T* __restrict__ x, const float* __restrict__ mean_sq,
            const T* __restrict__ gamma, int8_t* __restrict__ mant,
            float* __restrict__ stepT, int M, int K, int G, int Gq, int C,
            float eps) {
  const long long w = (static_cast<long long>(blockIdx.x) * 256 +
                       threadIdx.x) / 32;
  if (w >= static_cast<long long>(cdiv(M, 4)) * C) return;  // whole warps
  const int m0 = 4 * static_cast<int>(w / C), c = static_cast<int>(w % C);
  const int lane = threadIdx.x % 32;
  const bool pro = mean_sq != nullptr;
  float rs[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    rs[r] = pro && m0 + r < M ? rsqrt_rn(mean_sq[m0 + r], eps) : 1.f;
  uint32_t word[4];
  float pe[4];
  bfp_words<4>(x, gamma, pro, rs, m0, M, K, c * G, G, word, pe);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    if (lane < Gq / 4)
      reinterpret_cast<uint32_t*>(mant + static_cast<long long>(m) * C * Gq +
                                  static_cast<long long>(c) * Gq)[lane] =
          word[r];
    if (lane == 0)
      stepT[static_cast<long long>(c) * M + m] = __fmul_rn(pe[r], kStep);
  }
}

constexpr int kTcBM = 128;            // rows per block: 2 consumer warpgroups
constexpr int kTcBN = 128;            // code columns per block
constexpr int kTcStageK = 128;        // mantissa slots per stage: 4 k32 steps
constexpr int kTcBStages = 2;         // stages transposed ahead: codes K-major
constexpr int kTcThreads = 384;
constexpr int kTcTileBytes = 128 * 128;  // one stage of A, codes or B: 16 KB
constexpr int kTcBoxBytes = 32 * kTcBN;  // one code box: 32 k rows
// A consumer warp's scales (the block's 128 code columns) and steps (its
// 16 rows) of one group, double-buffered.
constexpr int kTcInfoFloats = kTcBN + 16;
constexpr int kTcInfoBytes = 8 * 2 * kTcInfoFloats * 4;
constexpr int kTcBarBytes = 128;         // the mbarriers, padded
constexpr int kTcTransposers = 96;       // producer warps 1-3
// Registers after setmaxnreg: 384 threads launch at 168 each; the
// producer gives up 64 (to 104) and the consumers (64 int32 sums, 64 fp32
// sums, the group's scales) take them (to 200).  The two must balance: an
// increase waits for registers the decrease released.
constexpr int kTcProducerRegs = 104, kTcConsumerRegs = 200;
static_assert(128 * kTcProducerRegs + 256 * kTcConsumerRegs == 384 * 168,
              "setmaxnreg must hand over exactly what it frees");

// Stages loading (mantissas, codes): 4, or 3 where the fp32 epilogue's
// staged tile needs the room.
template <typename T>
__host__ __device__ constexpr int tc_stages() {
  return sizeof(T) == 2 ? 4 : 3;
}
template <typename T>
__host__ __device__ constexpr int tc_epi_bytes() {  // a consumer's staged tile
  return 64 * (static_cast<int>(sizeof(T)) * kTcBN + 16);
}
template <typename T>
__host__ __device__ constexpr int tc_smem() {
  return (2 * tc_stages<T>() + kTcBStages) * kTcTileBytes + kTcInfoBytes +
         kTcBarBytes + 2 * tc_epi_bytes<T>() + 1024;
}

// cp.async of `bytes` (4 or 16) global -> shared, zero-filled where
// `valid` is false.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
      "l"(src), "n"(bytes), "r"(valid ? bytes : 0)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (row tile, column tile).  tma: the mantissas [M, C·Gq] in boxes of
// 128 slots x 128 rows, 128-byte swizzle.  tmc: the codes, boxes of 32 rows
// x 128 columns (GLU: [64 gate | 64 up] through a 3-D view).  Stage kt
// holds slots 4kt .. 4kt+3; slot j (32 mantissa k) belongs to group
// c = 32j / Gq at offset o = 32j % Gq, and reads code rows c·G + o ...
// Producer warp 0 loads stage kt into ring slot kt % S once stage kt - S
// is consumed; warps 1-3 turn its codes K-major into B slot kt % 2 once
// stage kt - 2 is consumed.  Each consumer warp copies the scales and
// steps of its next group but one (cp.async) while it multiplies, so a
// promotion never waits for global memory.
template <typename T, bool GLU>
__global__ void __launch_bounds__(kTcThreads, 1)
int4_tc(const __grid_constant__ CUtensorMap tma,
        const __grid_constant__ CUtensorMap tmc,
        const float* __restrict__ stepT, const float* __restrict__ scale,
        const T* __restrict__ residual, const float* __restrict__ gate_mul,
        T* __restrict__ out, float* __restrict__ sq_part, int M, int F,
        int G, int Gq, int C, int act) {
  constexpr int S = tc_stages<T>();
  constexpr int BNO = GLU ? kTcBN / 2 : kTcBN;  // output columns per block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t sA = base;                                // mantissas
  const uint32_t sC = sA + S * kTcTileBytes;               // codes as loaded
  const uint32_t sB = sC + S * kTcTileBytes;               // codes, K-major
  const uint32_t sI = sB + kTcBStages * kTcTileBytes;      // scales, steps
  // loaded (TMA) and empty (consumed) per ring slot, ready per B slot.
  const uint32_t loaded = sI + kTcInfoBytes;
  const uint32_t empty = loaded + 8 * S;
  const uint32_t ready = empty + 8 * S;
  uint8_t* const gC = smem_raw + (sC - raw);
  uint8_t* const gB = smem_raw + (sB - raw);
  float* const info = reinterpret_cast<float*>(smem_raw + (sI - raw));

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * kTcBM, f0 = blockIdx.y * BNO;
  const long long N = GLU ? 2LL * F : static_cast<long long>(F);
  const int nslots = C * Gq / 32;
  const int nk = (nslots + 3) / 4;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(loaded + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    for (int b = 0; b < kTcBStages; ++b)
      mbar_init(ready + 8 * b, kTcTransposers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTcProducerRegs));
    const int t = tid - 256;
    if (t < 32) {  // warp 0: its first thread keeps the ring loading
      if (t == 0) {
        int c = 0, o = 0;  // the next slot's group and offset in it
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % S, slots = min(4, nslots - 4 * kt);
          if (kt >= S) mbar_wait(empty + 8 * s, (kt / S - 1) & 1);
          const uint32_t bar = loaded + 8 * s;
          mbar_expect_tx(bar, kTcTileBytes + slots * kTcBoxBytes);
          tma_load(sA + s * kTcTileBytes, &tma, bar, kt * kTcStageK, m0);
          for (int j = 0; j < slots; ++j) {
            const uint32_t dst = sC + s * kTcTileBytes + j * kTcBoxBytes;
            if (GLU)
              tma_load_3d(dst, &tmc, bar, f0, 0, c * G + o);
            else
              tma_load(dst, &tmc, bar, f0, c * G + o);
            o += 32;
            if (o == Gq) {
              o = 0;
              ++c;
            }
          }
        }
      }
      return;
    }
    const int u0 = t - 32;  // 0 .. 95
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S, b = kt % kTcBStages;
      if (kt >= kTcBStages) {  // B slot b: stage kt - 2 has been consumed
        const int kp = kt - kTcBStages;
        mbar_wait(empty + 8 * (kp % S), (kp / S) & 1);
      }
      mbar_wait(loaded + 8 * s, (kt / S) & 1);
      // Block u of 16 mantissa slots (kc) x 8 code columns (nb), mapped so
      // that a half-warp's loads and a quarter-warp's stores each touch
      // distinct banks.
      for (int u = u0; u < 128; u += kTcTransposers) {
        const int q = u / 8, i = u % 8;
        const int nb = i + 8 * (q % 2), kc = (i + q / 2) % 8;
        const uint8_t* src = gC + s * kTcTileBytes + 16 * kc * kTcBN + 8 * nb;
        uint32_t rows[16][2];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const uint2 v = *reinterpret_cast<const uint2*>(src + r * kTcBN);
          rows[r][0] = v.x;
          rows[r][1] = v.y;
        }
        uint32_t col[8][4];  // column 8 nb + jj: k 16 kc + 4 w .. in word w
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t sq[4] = {rows[4 * w][h], rows[4 * w + 1][h],
                                    rows[4 * w + 2][h], rows[4 * w + 3][h]};
            uint32_t cj[4];
            transpose4x4(sq, cj);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) col[4 * h + jj][w] = cj[jj];
          }
        // B[n][k] in the 128-byte swizzle: row n (128 k), chunk k/16
        // stored at position (k/16) ^ (n % 8) of its row.
        uint8_t* dst = gB + b * kTcTileBytes + nb * 1024;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint4*>(dst + jj * 128 + ((kc ^ jj) << 4)) =
              make_uint4(col[jj][0], col[jj][1], col[jj][2], col[jj][3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(ready + 8 * b);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTcConsumerRegs));
  const int t128 = tid % 128, warp = t128 / 32, lane = t128 % 32;
  // This lane's rows (two: 16 warp + lane / 4 + {0, 8} of the warpgroup's
  // 64) and columns (32: 8 j + 2 (lane % 4) + {0, 1}).
  const int c2 = 2 * (lane % 4);
  int acc[64];
  float y[64], sc[32], st[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    y[i] = 0.f;
  }
  // Group c's scales and steps into this warp's buffer c % 2; every call
  // commits one cp.async group (empty past the last group), so waiting
  // for all but the newest group waits for group c when c + 1 is queued.
  float* const wbuf = info + (4 * wg + warp) * 2 * kTcInfoFloats;
  auto queue = [&](int c) {
    if (c < C) {
      float* const d = wbuf + (c % 2) * kTcInfoFloats;
      const int l = lane;  // 4 columns: the gate half, then the up half
      const int f = f0 + (GLU ? 4 * (l % 16) : 4 * l);
      const bool ok = f < (GLU ? F : N);
      cp_async<16>(d + 4 * l,
                   scale + static_cast<long long>(c) * N + (ok ? f : f0) +
                       (GLU && l >= 16 ? F : 0),
                   ok);
      if (l < 16) {
        const int m = m0 + 64 * wg + 16 * warp + l;
        cp_async<4>(d + kTcBN + l,
                    stepT + static_cast<long long>(c) * M + min(m, M - 1),
                    m < M);
      }
    }
    cp_async_commit();
  };
  auto fetch = [&](int c) {
    cp_async_wait<1>();
    __syncwarp();
    const float* const in = wbuf + (c % 2) * kTcInfoFloats;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(in + 8 * j + c2);
      sc[2 * j] = v.x;
      sc[2 * j + 1] = v.y;
    }
    st[0] = in[kTcBN + lane / 4];
    st[1] = in[kTcBN + lane / 4 + 8];
    __syncwarp();
    queue(c + 2);  // into the buffer just read
  };
  auto promote = [&]() {
    const float bias[2] = {-kMagic * st[0], -kMagic * st[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float tv = scaled_sum(acc[i], st[(i / 2) % 2], bias[(i / 2) % 2]);
      y[i] = __fadd_rn(y[i], __fmul_rn(tv, sc[2 * (i / 4) + i % 2]));
    }
  };

  queue(0);
  queue(1);
  // The wait for stage kt + 1 overlaps stage kt's wgmma.
  auto arrived = [&](int kt) {
    mbar_wait(loaded + 8 * (kt % S), (kt / S) & 1);
    mbar_wait(ready + 8 * (kt % kTcBStages), (kt / kTcBStages) & 1);
  };
  arrived(0);
  int c = 0, o = 0;  // the next slot's group and offset in it
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S, b = kt % kTcBStages;
    const uint32_t a_s = sA + s * kTcTileBytes + wg * 64 * 128;
    const uint32_t b_s = sB + b * kTcTileBytes;
    const int slots = min(4, nslots - 4 * kt);
    wgmma_fence();
    // A k32 step is 32 bytes along the swizzled rows: 2 in the
    // descriptors' address field (16-byte units).
    const uint64_t da = smem_desc(a_s, 16, 1024), db = smem_desc(b_s, 16, 1024);
    bool ends = false;  // the stage's last slot ends a group
    for (int j = 0; j < slots; ++j) {
      wgmma_m64n128k32_s8(acc, da + 2 * j, db + 2 * j, o == 0 ? 0u : 1u);
      o += 32;
      ends = o == Gq;
      if (ends) {
        o = 0;
        ++c;
        if (j + 1 < slots) {  // a group ends inside the stage
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fetch(c - 1);
          promote();
          wgmma_fence();
        }
      }
    }
    wgmma_commit();
    if (kt + 1 < nk) arrived(kt + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
    if (ends) {
      fetch(c - 1);
      promote();
    }
  }
  cp_async_wait<0>();

  uint8_t* const epi = smem_raw + (loaded - raw) + kTcBarBytes;
  repro::store_frag<GLU>(y, m0 + wg * 64, f0, M, F, act, nullptr, 0.f,
                         residual, gate_mul, out, sq_part, blockIdx.y,
                         epi + wg * tc_epi_bytes<T>(), 1 + wg);
}

// ---------------------------------------------------------------------------
// Route 2: the split-K code stream (M <= 16)
// ---------------------------------------------------------------------------

constexpr int kSmWarps = 4;              // splits per block
constexpr int kSmThreads = 32 * kSmWarps;
constexpr int kSmCols = 128;             // code columns per block
constexpr int kSmMaxCluster = 8;

// A staged mantissa row: 32 words and a pad that puts the B fragment's
// reads (row g, word t) on distinct banks.
constexpr int kSmRowWords = kMaxG / 4 + 4;

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (rank, column tile) of a cluster of gridDim.x ranks; warp w of
// rank r is split s = 4r + w, groups [s·gps, min((s+1)·gps, C)).  Column
// tile j: code columns 128 j .. (GLU: gate f0 .. f0+63 and up F+f0 ..,
// f0 = 64 j).  MT: register rows (8 or 16) >= M.  At MT 8 the registers
// are held to three blocks per SM: the warps in flight bound the stream.
template <typename T, int MT, bool GLU>
__global__ void __launch_bounds__(kSmThreads, MT == 8 ? 3 : 1)
int4_stream(const T* __restrict__ x, const float* __restrict__ mean_sq,
            const T* __restrict__ gamma, const int8_t* __restrict__ codes,
            const float* __restrict__ scale, const T* __restrict__ residual,
            const float* __restrict__ gate_mul, T* __restrict__ out,
            float* __restrict__ sq_part, int M, int K, int F, int G, int C,
            int gps, int S, int act, float eps) {
  namespace cg = cooperative_groups;
  constexpr int NT = MT / 8;               // n8 tiles of rows
  constexpr int NOUT = GLU ? kSmCols / 2 : kSmCols;
  // Mantissas while streaming ([warp][MT rows][kSmRowWords]), then the
  // warps' partials ([warp][MT][128] f32).
  constexpr int kWords = kSmWarps * MT * kSmCols;
  static_assert(kWords >= kSmWarps * MT * kSmRowWords, "smem union");
  __shared__ __align__(16) uint32_t sm[kWords];
  __shared__ float steps[kSmWarps][MT];
  __shared__ float sq_s[MT * NOUT];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rank = blockIdx.x, Z = gridDim.x;
  const long long N = GLU ? 2LL * F : static_cast<long long>(F);
  const int j0 = blockIdx.y * NOUT;   // first output column of the tile
  const int Gq = (G + 31) / 32 * 32, nst = Gq / 32;
  const bool pro = mean_sq != nullptr;

  // This lane's 16 code columns.
  long long col;
  bool live;
  if (GLU) {
    const int f = j0 + 16 * (g % 4);
    col = (g < 4 ? 0LL : static_cast<long long>(F)) + f;
    live = f < F;
  } else {
    col = j0 + 16 * g;
    live = col < N;
  }

  __shared__ float rs_s[MT];  // 1 / sqrt(mean_sq + eps) of each row
  if (tid < M) rs_s[tid] = pro ? rsqrt_rn(mean_sq[tid], eps) : 1.f;
  __syncthreads();
  const int split = kSmWarps * rank + warp;
  const int c0 = split * gps, c1 = min(C, c0 + gps);
  uint32_t* const xq = sm + warp * MT * kSmRowWords;

  // The next k32 step of this warp to load (group lc, its k offset lk):
  // the lane's 8 rows lk + 4t + r and lk + 16 + 4t + r (r < 4) of 16
  // columns.  The next step's loads are in flight while one is multiplied.
  int lc = c0, lk = 0;
  auto load = [&](uint4 (&v)[8]) {
    const int8_t* p = codes + (static_cast<long long>(lc) * G) * N + col;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int kk = lk + 4 * t + (r % 4) + 16 * (r / 4);
      v[r] = (live && kk < G) ? ld_stream(p + static_cast<long long>(kk) * N)
                              : make_uint4(0u, 0u, 0u, 0u);
    }
    lk += 32;
    if (lk == Gq) {
      lk = 0;
      ++lc;
    }
  };

  float y[NT][8][4];
  int acc[NT][8][4];
  float sc[16];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[n][i][e] = 0.f;
  for (int m = M; m < MT; ++m) {  // rows past M stay zero
    xq[m * kSmRowWords + lane] = 0u;
    if (lane == 0) steps[warp][m] = 0.f;
  }
  // Multiplies step stp of group c from v, whose loads then move on to
  // the next step, if any.
  auto step = [&](uint4 (&v)[8], int c, int stp) {
    if (stp == 0) {
      // The group's mantissas and its scales.
      __syncwarp();
      for (int m0 = 0; m0 < M; m0 += 4) {  // four rows at a time
        float rs[4];
        uint32_t w[4];
        float pe[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rs[r] = rs_s[min(m0 + r, MT - 1)];
        bfp_words<4>(x, gamma, pro, rs, m0, M, K, c * G, G, w, pe);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (m0 + r < M) {
            xq[(m0 + r) * kSmRowWords + lane] = w[r];
            if (lane == 0) steps[warp][m0 + r] = __fmul_rn(pe[r], kStep);
          }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 s4 =
            live ? __ldg(reinterpret_cast<const float4*>(
                       scale + static_cast<long long>(c) * N + col) + q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        sc[4 * q] = s4.x;
        sc[4 * q + 1] = s4.y;
        sc[4 * q + 2] = s4.z;
        sc[4 * q + 3] = s4.w;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][i][e] = 0;
    }
    // Column 16 g + J: wd[0][J] k 4t..4t+3, wd[1][J] k 16+4t..16+4t+3.
    uint32_t wd[2][16];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        const uint32_t sq[4] = {
            reinterpret_cast<const uint32_t*>(&v[4 * b])[s4],
            reinterpret_cast<const uint32_t*>(&v[4 * b + 1])[s4],
            reinterpret_cast<const uint32_t*>(&v[4 * b + 2])[s4],
            reinterpret_cast<const uint32_t*>(&v[4 * b + 3])[s4]};
        uint32_t cj[4];
        transpose4x4(sq, cj);
#pragma unroll
        for (int j = 0; j < 4; ++j) wd[b][4 * s4 + j] = cj[j];
      }
    if (lc < c1) load(v);
    // mma i: A rows g, g + 8 = columns 16g + i, 16g + 8 + i; B = rows
    // 8n + g of the mantissas.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint32_t* xr = xq + (8 * n + g) * kSmRowWords + 8 * stp;
      const uint32_t b0 = xr[t], b1 = xr[4 + t];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t a[4] = {wd[0][i], wd[0][8 + i], wd[1][i], wd[1][8 + i]};
        mma_s8(acc[n][i], a, b0, b1);
      }
    }
    if (stp == nst - 1) {  // promote: D[n][i][e] is row 8n + 2t + e % 2,
#pragma unroll             // column 16g + i + 8 (e / 2)
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float st = steps[warp][8 * n + 2 * t + e % 2];
          const float bias = -kMagic * st;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float tv = scaled_sum(acc[n][i][e], st, bias);
            y[n][i][e] =
                __fadd_rn(y[n][i][e], __fmul_rn(tv, sc[i + 8 * (e / 2)]));
          }
        }
    }
  };
  uint4 v[8];
  if (c0 < c1) load(v);
  for (int c = c0; c < c1; ++c)
    for (int stp = 0; stp < nst; ++stp) step(v, c, stp);

  // The warps' partials, then every rank adds, for its outputs, the splits
  // in ascending order from the cluster's shared memory.
  __syncthreads();
  float* const part = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(warp * MT + 8 * n + 2 * t + e % 2) * kSmCols + 16 * g + i +
             8 * (e / 2)] = y[n][i][e];
  cluster.sync();  // every split's partial is written

  const int per = cdiv(NOUT, Z);
  const int cb = min(NOUT, rank * per), cnt = min(NOUT, cb + per) - cb;
  for (int e = tid; e < M * cnt; e += kSmThreads) {
    const int m = e / cnt, cc = cb + e % cnt, oc = j0 + cc;
    float yv = 0.f, u = 0.f;
    for (int s0 = 0; s0 < S; s0 += 8) {
      float pv[8], pu[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int s = s0 + q;
        if (s < S) {
          const float* p = cluster.map_shared_rank(part, s / kSmWarps) +
                           ((s % kSmWarps) * MT + m) * kSmCols + cc;
          pv[q] = *p;
          pu[q] = GLU ? p[NOUT] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (s0 + q < S) {
          yv = __fadd_rn(yv, pv[q]);
          if (GLU) u = __fadd_rn(u, pu[q]);
        }
    }
    float r = repro::apply_act(yv, act);
    if (GLU) r = __fmul_rn(r, u);
    if (gate_mul != nullptr) r = __fmul_rn(r, gate_mul[m]);
    const bool ok = oc < (GLU ? F : N);
    const long long o = static_cast<long long>(m) * (GLU ? F : N) + oc;
    if (ok) {
      if (residual != nullptr) r = __fadd_rn(r, repro::to_f32(residual[o]));
      out[o] = repro::from_f32<T>(r);
    }
    sq_s[m * NOUT + cc - cb] = ok ? __fmul_rn(r, r) : 0.f;
  }
  if (sq_part != nullptr) {
    __syncthreads();
    for (int m = warp; m < M; m += kSmWarps) {
      float s = 0.f;
      for (int q = lane; q < cnt; q += 32) s += sq_s[m * NOUT + q];
      s = repro::warp_sum(s);
      if (lane == 0)
        sq_part[(static_cast<long long>(blockIdx.y) * Z + rank) * M + m] = s;
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// Launch: the plan, checked, then exactly its grid
// ---------------------------------------------------------------------------

struct Call {
  const void *x, *mean_sq, *gamma, *codes, *scale, *residual, *gate_mul;
  void *out, *mant, *steps, *sq_part, *sq;
  int M, K, F, G, C, glu, act;
  float eps;
  cudaStream_t stream;
};

template <typename T, bool GLU>
cudaError_t launch_tc(const Call& c, dim3 grid) {
  const int Gq = (c.G + 31) / 32 * 32, Kq = c.C * Gq;
  const long long N = GLU ? 2LL * c.F : static_cast<long long>(c.F);
  const cudaError_t e = cudaFuncSetAttribute(
      int4_tc<T, GLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_smem<T>());
  if (e != cudaSuccess) return e;
  CUtensorMap tma, tmc;
  const cuuint64_t adims[2] = {static_cast<cuuint64_t>(Kq),
                               static_cast<cuuint64_t>(c.M)};
  const cuuint64_t astr[1] = {static_cast<cuuint64_t>(Kq)};
  const cuuint32_t abox[2] = {kTcStageK, kTcBM};
  bool ok = tensor_map_typed(&tma, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.mant, 2,
                             adims, astr, abox, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t rows = static_cast<cuuint64_t>(c.G) * c.C;
  if (GLU) {
    const cuuint64_t d[3] = {static_cast<cuuint64_t>(c.F), 2, rows};
    const cuuint64_t st[2] = {static_cast<cuuint64_t>(c.F),
                              static_cast<cuuint64_t>(N)};
    const cuuint32_t box[3] = {kTcBN / 2, 2, 32};
    ok = ok && tensor_map_typed(&tmc, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.codes,
                                3, d, st, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    const cuuint64_t d[2] = {static_cast<cuuint64_t>(N), rows};
    const cuuint64_t st[1] = {static_cast<cuuint64_t>(N)};
    const cuuint32_t box[2] = {kTcBN, 32};
    ok = ok && tensor_map_typed(&tmc, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.codes,
                                2, d, st, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return cudaErrorInvalidValue;
  const long long warps = static_cast<long long>(cdiv(c.M, 4)) * c.C;
  bfp_prepass<T><<<static_cast<unsigned>((warps + 7) / 8), 256, 0,
                   c.stream>>>(
      static_cast<const T*>(c.x), static_cast<const float*>(c.mean_sq),
      static_cast<const T*>(c.gamma), static_cast<int8_t*>(c.mant),
      static_cast<float*>(c.steps), c.M, c.K, c.G, Gq, c.C, c.eps);
  int4_tc<T, GLU><<<grid, kTcThreads, tc_smem<T>(), c.stream>>>(
      tma, tmc, static_cast<const float*>(c.steps),
      static_cast<const float*>(c.scale), static_cast<const T*>(c.residual),
      static_cast<const float*>(c.gate_mul), static_cast<T*>(c.out),
      static_cast<float*>(c.sq_part), c.M, c.F, c.G, Gq, c.C, c.act);
  return cudaSuccess;
}

template <typename T, int MT, bool GLU>
cudaError_t launch_stream(const Call& c, dim3 grid, int gps, int splits) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSmThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, int4_stream<T, MT, GLU>, static_cast<const T*>(c.x),
      static_cast<const float*>(c.mean_sq), static_cast<const T*>(c.gamma),
      static_cast<const int8_t*>(c.codes), static_cast<const float*>(c.scale),
      static_cast<const T*>(c.residual), static_cast<const float*>(c.gate_mul),
      static_cast<T*>(c.out), static_cast<float*>(c.sq_part), c.M, c.K, c.F,
      c.G, c.C, gps, splits, c.act, c.eps);
}

// The plan (tile_m, tile_n, group_split, splits, grid) checked against what
// this source instantiates, scratch against what the grid writes; then the
// launches.
template <typename T>
int launch(const Call& c, int tile_m, int tile_n, int gps, int splits,
           int grid_x, int grid_y, long long mant_cap, long long steps_cap,
           long long sq_cap) {
  if (c.M <= 0 || c.F <= 0) return static_cast<int>(cudaGetLastError());
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (c.G <= 0 || c.G > kMaxG || c.C <= 0 || c.K > c.G * c.C ||
      c.F % 16 != 0 || tile_n != kSmCols || !a16(c.codes) || !a16(c.scale) ||
      !a16(c.residual) || !a16(c.out))
    return bad;
  const int tiles = c.glu ? cdiv(c.F, kSmCols / 2) : cdiv(c.F, kSmCols);
  const int Gq = (c.G + 31) / 32 * 32;
  const bool with_sq = c.sq != nullptr;
  cudaError_t e;
  if (splits == 0) {  // the tensor-core tile
    if (tile_m != kTcBM || gps != 0 || grid_x != cdiv(c.M, kTcBM) ||
        grid_y != tiles ||
        mant_cap < static_cast<long long>(c.M) * c.C * Gq ||
        steps_cap < static_cast<long long>(c.M) * c.C ||
        (with_sq && sq_cap < static_cast<long long>(grid_y) * c.M))
      return bad;
    e = c.glu ? launch_tc<T, true>(c, dim3(grid_x, grid_y))
              : launch_tc<T, false>(c, dim3(grid_x, grid_y));
  } else {  // the split-K stream
    if ((tile_m != 8 && tile_m != 16) || c.M > tile_m || gps <= 0 ||
        splits != cdiv(c.C, gps) || splits > kSmWarps * kSmMaxCluster ||
        grid_x != cdiv(splits, kSmWarps) || grid_y != tiles ||
        (with_sq &&
         sq_cap < static_cast<long long>(grid_y) * grid_x * c.M))
      return bad;
    const dim3 grid(grid_x, grid_y);
    if (tile_m == 8)
      e = c.glu ? launch_stream<T, 8, true>(c, grid, gps, splits)
                : launch_stream<T, 8, false>(c, grid, gps, splits);
    else
      e = c.glu ? launch_stream<T, 16, true>(c, grid, gps, splits)
                : launch_stream<T, 16, false>(c, grid, gps, splits);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (with_sq)
    repro::sq_reduce(c.sq_part, c.sq, c.M,
                     splits == 0 ? grid_y : grid_y * grid_x, c.stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K], residual/out [M, F]: one storage type, contiguous.  codes
// [G·C, N] int8 in [-8, 7] (N = 2F with glu: [gate | up]), G·C >= K (the
// codes' padding rows are zero), scale [C, N] f32, G <= 128; F a multiple
// of 16 and codes, scale, residual, out 16-byte aligned (the wrapper pads
// F).  mean_sq [M], gate_mul [M] f32; gamma [K].  Optional inputs are
// null (the int4 matmul passes none of them).  act: 0 none, 1 silu, 2 gelu (tanh).
// On the caller's plan (kernels/fused_linear.py, plan_int4()):
//   splits == 0: the tensor-core tile, tile_m 128 rows x tile_n 128 code
//     columns, group_split 0, grid (ceil(M/128), column tiles); scratch
//     mant int8 [M, C·Gq] and steps f32 [C, M] (Gq = G rounded up to 32),
//     sq_part f32 [column tiles, M] with sq [M].
//   splits > 0: the split-K stream, tile_m 8 or 16 register rows (>= M),
//     tile_n 128, group_split groups per split, splits = ceil(C /
//     group_split) <= 32, grid (ceil(splits / 4), column tiles), one
//     cluster per column tile; sq_part f32 [column tiles · grid x, M].
// Column tiles: ceil(F / 64) with glu, else ceil(F / 128).  A plan off
// this source, scratch shorter than the grid writes, or any other size or
// alignment the kernels do not take returns cudaErrorInvalidValue before
// anything is launched.  Returns the first CUDA error, else
// cudaGetLastError().
#define INT4_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(                                                        \
      const void* x, const void* mean_sq, const void* gamma,                  \
      const void* codes, const void* scale, const void* residual,             \
      const void* gate_mul, void* out, void* mant, void* steps,               \
      void* sq_part, void* sq, int M, int K, int F, int G, int C, int glu,    \
      int act, int tile_m, int tile_n, int group_split, int splits,           \
      int grid_x, int grid_y, long long mant_cap, long long steps_cap,        \
      long long sq_cap, float eps, void* stream) {                            \
    const Call c{x,    mean_sq, gamma, codes, scale, residual, gate_mul,      \
                 out,  mant,    steps, sq ? sq_part : nullptr, sq, M, K, F,  \
                 G,    C,       glu,   act,     eps,                          \
                 static_cast<cudaStream_t>(stream)};                          \
    return launch<T>(c, tile_m, tile_n, group_split, splits, grid_x, grid_y,  \
                     mant_cap, steps_cap, sq_cap);                            \
  }
INT4_ENTRY(fused_linear_int4_bf16, __nv_bfloat16)
INT4_ENTRY(fused_linear_int4_f32, float)
