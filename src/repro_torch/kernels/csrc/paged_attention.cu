// Paged decode attention over the §4.4 store-once entry stream.
//
// Replaces the TPU kernel paged_attention_packed
// (src/repro/kernels/paged_attention.py) together with the fold of the
// in-flight token in ops.paged_decode_attention: one query token per slot
// attends to the slot's page chain, masked by effective position
// (eff_pos <= q_pos; the history sentinel is int32 max), plus its own
// (k_tok, v_tok), which is committed to the store only after the step.
// Output [B, 1, Hq, dh] in q's type, divided by max(l, 1e-20).
//
// Bound.  Decode attention is bound by the bytes it must read.  The chain
// holds every layer's entries (a token stores 1 + Σ gates of them, ~16.5
// at keep 0.5 over 32 layers), token-major, and exactly one entry per
// token is valid at any layer.  The TPU kernel walks every page at every
// layer and masks entry by entry: an L·keep-fold read amplification
// (~1.07 GB per layer for 4 slots × 16 k entries × 16 KiB).  Nearly every
// page holds one valid entry for each layer, so skipping whole pages saves
// nothing.  This kernel reads the small eff_pos row (4 B per entry) in
// full and loads K/V only for the entries it admits: its traffic is the
// dense KV read plus the metadata.
//
// Design.  One block per (slot, KV head, group of GR query heads).  Each
// of the 8 warps scans its own 256-entry chunks of eff_pos (8 coalesced
// loads a lane, the next chunk prefetched into registers), compacts the
// admitted entry indices in order into its own shared list with ballots,
// then gathers those entries' K and V rows kGroup at a time (lane l owns
// dims [l·dh/32, (l+1)·dh/32), one vector load per row) and runs an fp32
// online softmax (NEG_INF = -1e30, never -inf).  int8/int4 payloads are
// dequantized in the walk with the per-(entry, head) pow2 scale; in int4
// byte d holds dim d in its low nibble and dim d + dh/2 in its high
// nibble, each sign-extended.  The warps' (m, l, acc) states merge in
// shared memory, then the in-flight token is folded in and the row
// written.  Split-KV across blocks and tensor cores are later work.
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kWarps = 8;
constexpr int kPerLane = 8;               // eff_pos loads a lane per chunk
constexpr int kChunk = 32 * kPerLane;     // entries a warp scans per chunk
constexpr int kGroup = 8;                 // admitted rows gathered at once
constexpr int kMaxRows = 4;               // query heads a block may own

enum Payload { kNative = 0, kInt8 = 1, kInt4 = 2 };

template <int BYTES> struct Raw;
template <> struct Raw<1> { using T = uint8_t; };
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

// One vector load of BYTES aligned bytes, returned as N values of type V.
template <typename V, int N>
__device__ __forceinline__ void load_vec(const V* p, V (&out)[N]) {
  using R = typename Raw<sizeof(V) * N>::T;
  const R r = *reinterpret_cast<const R*>(p);
  memcpy(out, &r, sizeof(R));
}

// The lane's DPL dims [lane·DPL, (lane+1)·DPL) of one payload row as fp32
// codes (native rows: the values; quantized rows: before the scale).
template <typename T, int PAY, int DH>
__device__ __forceinline__ void load_row(const void* pages, long long row,
                                         int lane, float (&out)[DH / 32]) {
  constexpr int DPL = DH / 32;
  if constexpr (PAY == kNative) {
    T v[DPL];
    load_vec<T, DPL>(static_cast<const T*>(pages) + row * DH + lane * DPL,
                     v);
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = repro::to_f32(v[i]);
  } else if constexpr (PAY == kInt8) {
    int8_t v[DPL];
    load_vec<int8_t, DPL>(
        static_cast<const int8_t*>(pages) + row * DH + lane * DPL, v);
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = static_cast<float>(v[i]);
  } else {
    // lanes 0-15 own the low nibbles (dims < dh/2), lanes 16-31 the high
    // nibbles of the same bytes (dims >= dh/2)
    uint8_t v[DPL];
    load_vec<uint8_t, DPL>(static_cast<const uint8_t*>(pages) +
                               row * (DH / 2) + (lane & 15) * DPL,
                           v);
    const int shift = lane < 16 ? 0 : 4;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      out[i] = static_cast<float>((((v[i] >> shift) & 0xF) ^ 8) - 8);
  }
}

template <typename T, int PAY, int DH, int GR>
__global__ void __launch_bounds__(kWarps * 32)
paged_kernel(const T* __restrict__ q, const void* __restrict__ k_pages,
             const void* __restrict__ v_pages,
             const float* __restrict__ k_scales,
             const float* __restrict__ v_scales,
             const int* __restrict__ block_table,
             const int* __restrict__ eff_pos, const T* __restrict__ k_tok,
             const T* __restrict__ v_tok, const int* __restrict__ q_pos,
             T* __restrict__ out, int P, int ps, int Hkv, int G, int J,
             float scale) {
  constexpr int DPL = DH / 32;
  __shared__ int admitted[kWarps][kChunk];
  __shared__ float sm_m[kWarps][GR], sm_l[kWarps][GR];
  __shared__ float sm_acc[kWarps][GR][DH];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int g0 = blockIdx.y * GR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Hq = Hkv * G;
  const int E = J * ps;
  const int qp = q_pos[b];
  const int* ep = eff_pos + static_cast<long long>(b) * E;
  const int* bt = block_table + static_cast<long long>(b) * J;

  float qr[GR][DPL], m[GR], l[GR], acc[GR][DPL];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int g = g0 + r;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = g < G ? repro::to_f32(
                             q[(static_cast<long long>(b) * Hq + h * G + g) *
                                   DH +
                               lane * DPL + i]) *
                             scale
                       : 0.f;
    }
  }

  const int n_chunks = (E + kChunk - 1) / kChunk;
  int next[kPerLane];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = c * kChunk + k * 32 + lane;
      next[k] = e < E ? ep[e] : 0;
    }
  };
  if (warp < n_chunks) load_chunk(warp);

  for (int c = warp; c < n_chunks; c += kWarps) {
    // compact this chunk's admitted entries, in order, into the warp's list
    int n = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = c * kChunk + k * 32 + lane;
      const bool ok = e < E && next[k] <= qp;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) admitted[warp][n + __popc(bal & ((1u << lane) - 1u))] = e;
      n += __popc(bal);
    }
    __syncwarp();
    if (c + kWarps < n_chunks) load_chunk(c + kWarps);   // prefetch

    for (int i0 = 0; i0 < n; i0 += kGroup) {
      float kv[kGroup][DPL], vv[kGroup][DPL], ksc[kGroup], vsc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        ksc[u] = vsc[u] = 1.f;
        if (i0 + u < n) {
          const int e = admitted[warp][i0 + u];
          const int page = min(max(bt[e / ps], 0), P - 1);
          const long long row =
              (static_cast<long long>(page) * ps + e % ps) * Hkv + h;
          load_row<T, PAY, DH>(k_pages, row, lane, kv[u]);
          load_row<T, PAY, DH>(v_pages, row, lane, vv[u]);
          if constexpr (PAY != kNative) {
            ksc[u] = k_scales[row];
            vsc[u] = v_scales[row];
          }
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) kv[u][i] = vv[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        float s[kGroup];
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) d = fmaf(qr[r][i], kv[u][i], d);
          s[u] = repro::warp_sum(d) * ksc[u];
          if (i0 + u < n) mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[r] - mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          s[u] = i0 + u < n ? expf(s[u] - mx) : 0.f;
          psum += s[u];
          s[u] *= vsc[u];
        }
        l[r] = l[r] * alpha + psum;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[r][i] * alpha;
#pragma unroll
          for (int u = 0; u < kGroup; ++u) a = fmaf(s[u], vv[u][i], a);
          acc[r][i] = a;
        }
        m[r] = mx;
      }
    }
    __syncwarp();   // the list is rewritten by the next chunk
  }

  // merge the warps' online-softmax states
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][r][lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  if (warp >= GR) return;
  const int r = warp, g = g0 + r;
  if (g >= G) return;
  float M = kNegInf;
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
  float L = 0.f, A[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) A[i] = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    const float f = expf(sm_m[w][r] - M);
    L += sm_l[w][r] * f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) A[i] += sm_acc[w][r][lane * DPL + i] * f;
  }

  // fold in the in-flight token (always causally valid: its pos == q_pos);
  // the row's q is picked with compile-time indices so qr stays in
  // registers
  float qrow[DPL];
#pragma unroll
  for (int rr = 0; rr < GR; ++rr)
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (rr == r) qrow[i] = qr[rr][i];
  const long long tok = (static_cast<long long>(b) * Hkv + h) * DH +
                        lane * DPL;
  float qk = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    qk = fmaf(qrow[i], repro::to_f32(k_tok[tok + i]), qk);
  const float s_tok = repro::warp_sum(qk);
  const float m2 = fmaxf(M, s_tok);
  const float alpha = expf(M - m2), p_tok = expf(s_tok - m2);
  const float den = fmaxf(L * alpha + p_tok, 1e-20f);
  T* o = out + (static_cast<long long>(b) * Hq + h * G + g) * DH + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    o[i] = repro::from_f32<T>(
        (A[i] * alpha + p_tok * repro::to_f32(v_tok[tok + i])) / den);
}

template <typename T, int PAY, int DH, int GR>
void launch_one(const void* q, const void* kp, const void* vp,
                const void* ks, const void* vs, const void* bt,
                const void* ep, const void* kt, const void* vt,
                const void* qpos, void* out, int B, int P, int ps, int Hkv,
                int G, int J, float scale, cudaStream_t s) {
  const dim3 grid(B * Hkv, (G + GR - 1) / GR);
  paged_kernel<T, PAY, DH, GR><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(ep), static_cast<const T*>(kt),
      static_cast<const T*>(vt), static_cast<const int*>(qpos),
      static_cast<T*>(out), P, ps, Hkv, G, J, scale);
}

template <typename T, int PAY, int DH>
void launch_rows(const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const void* bt,
                 const void* ep, const void* kt, const void* vt,
                 const void* qpos, void* out, int B, int P, int ps, int Hkv,
                 int G, int J, float scale, cudaStream_t s) {
  if (G == 1)
    launch_one<T, PAY, DH, 1>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos, out, B,
                              P, ps, Hkv, G, J, scale, s);
  else
    launch_one<T, PAY, DH, kMaxRows>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos,
                                     out, B, P, ps, Hkv, G, J, scale, s);
}

template <typename T, int PAY>
int launch_dh(const void* q, const void* kp, const void* vp, const void* ks,
              const void* vs, const void* bt, const void* ep, const void* kt,
              const void* vt, const void* qpos, void* out, int B, int P,
              int ps, int Hkv, int G, int J, int dh, float scale,
              cudaStream_t s) {
  switch (dh) {
    case 32:
      launch_rows<T, PAY, 32>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos, out, B,
                              P, ps, Hkv, G, J, scale, s);
      return 0;
    case 64:
      launch_rows<T, PAY, 64>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos, out, B,
                              P, ps, Hkv, G, J, scale, s);
      return 0;
    case 128:
      launch_rows<T, PAY, 128>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos, out,
                               B, P, ps, Hkv, G, J, scale, s);
      return 0;
    default:
      return 1;
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* bt, const void* ep, const void* kt,
           const void* vt, const void* qpos, void* out, int B, int P, int ps,
           int Hkv, int G, int J, int dh, int payload, float scale,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  int bad = 1;
  switch (payload) {
    case kNative:
      bad = launch_dh<T, kNative>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos,
                                  out, B, P, ps, Hkv, G, J, dh, scale, s);
      break;
    case kInt8:
      bad = launch_dh<T, kInt8>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos, out,
                                B, P, ps, Hkv, G, J, dh, scale, s);
      break;
    case kInt4:
      bad = launch_dh<T, kInt4>(q, kp, vp, ks, vs, bt, ep, kt, vt, qpos, out,
                                B, P, ps, Hkv, G, J, dh, scale, s);
      break;
    default:
      break;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k_tok, v_tok, out: contiguous [B, 1, Hq = Hkv·G, dh] / [B, 1, Hkv, dh]
// in one storage type.  k/v pages: contiguous [P, ps, Hkv, dhp] of that type
// (payload 0), int8 codes (1) or nibble-packed int4 codes, dhp = dh/2 (2);
// k/v scales: f32 [P, ps, Hkv] for payloads 1-2 (else unused).
// block_table int32 [B, J]; eff_pos int32 [B, J·ps]; q_pos int32 [B].
// dh in {32, 64, 128}.  Returns cudaGetLastError().
extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages, const void* k_scales,
                                    const void* v_scales,
                                    const void* block_table,
                                    const void* eff_pos, const void* k_tok,
                                    const void* v_tok, const void* q_pos,
                                    void* out, int B, int P, int ps, int Hkv,
                                    int G, int J, int dh, int payload,
                                    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, k_scales, v_scales,
                               block_table, eff_pos, k_tok, v_tok, q_pos, out,
                               B, P, ps, Hkv, G, J, dh, payload, scale,
                               stream);
}
extern "C" int paged_attention_f32(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales,
                                   const void* block_table,
                                   const void* eff_pos, const void* k_tok,
                                   const void* v_tok, const void* q_pos,
                                   void* out, int B, int P, int ps, int Hkv,
                                   int G, int J, int dh, int payload,
                                   float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, k_scales, v_scales, block_table,
                       eff_pos, k_tok, v_tok, q_pos, out, B, P, ps, Hkv, G,
                       J, dh, payload, scale, stream);
}
