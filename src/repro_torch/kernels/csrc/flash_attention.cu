// Online-softmax GQA attention (paper Alg. 2; FlashAttention update rule).
//
// Replaces the TPU kernel flash_attention_packed
// (src/repro/kernels/flash_attention.py) together with the head packing
// around it (ops._pack_heads): the G query heads of a KV group are the
// rows of one (batch, kv-head) problem, row r = g·Tq + t.  Instead of
// copying q, k and v into packed arrays, the kernel reads them in place
// through their strides — q [B, Tq, Hq, dh], k/v [B, Tk, Hkv, dh] (the
// decode cache layout) — and writes the output as [B, Tq, Hq, dh].
//
// Masking is the reference's, by absolute position: key kp is valid for a
// row at position pos when kp < kv_len (and kp < Tk), kp <= pos (causal)
// and kp > pos - window (window > 0).  Masked scores are NEG_INF = -1e30,
// never -inf: a fully masked tile then gives exp(m_prev - m_new) = 1, not
// exp(-inf + inf) = NaN, and later tiles wash it out.  A row with no valid
// key at all (a pad row, pos = -1) is written as zeros, as the reference
// oracle does; the caller drops such rows.
//
// Design.  Each block owns one (b, kv-head) and BQ = 16 rows; it loops over
// the KV tiles itself (the TPU carried m, l, acc across grid steps j).
// Tiles of 32 keys are staged in shared memory as fp32; each warp owns two
// rows: lane j scores key j, the warp reduces max and Σexp with shuffles,
// and lane d accumulates output dims d, d+32, ....  Tiles past the block's
// causal limit (its largest position + 1) and past kv_len are never read.
//
// Bound.  Prefill (Tq = 512, causal) is bound by operations (tensor-core
// rate); decode (Tq = 1, Tk = 544) by reading the KV cache.  This first
// kernel uses SIMT fp32 FMAs and gives decode only B·Hkv blocks of one row
// each; split-KV decode and wgmma tiles are later work.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kBKV = 32, kWarps = 8, kRowsPerWarp = 2;
constexpr int kBQ = kWarps * kRowsPerWarp;

struct Strides {  // element strides of the batch, time and head dims
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ kv_len, T* __restrict__ out, int Hkv,
             int G, int Tq, int Tk, Strides st, int causal, int window,
             float scale) {
  constexpr int DPL = DH / 32;  // output dims per lane
  __shared__ float ks[kBKV][DH + 1];  // +1: lane j reads row j conflict-free
  __shared__ float vs[kBKV][DH];
  __shared__ float qs[kBQ][DH];
  __shared__ int ps[kBQ];

  const int R = G * Tq;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int r0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kThreads = kWarps * 32;

  for (int r = tid; r < kBQ; r += kThreads)
    ps[r] = (r0 + r < R) ? q_pos[static_cast<long long>(bh) * R + r0 + r] : -1;
  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, gr = r0 + r;
    float val = 0.f;
    if (gr < R) {
      const int g = gr / Tq, t = gr % Tq;
      val = repro::to_f32(q[b * st.qb + t * st.qt + (h * G + g) * st.qh + d]) *
            scale;
    }
    qs[r][d] = val;
  }
  __syncthreads();

  int maxpos = -1;
  for (int r = 0; r < kBQ; ++r) maxpos = max(maxpos, ps[r]);
  const int kvl = min(kv_len[bh], Tk);
  const int limit = causal ? min(kvl, maxpos + 1) : kvl;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  bool any[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    any[i] = false;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  for (int t0 = 0; t0 < limit; t0 += kBKV) {
    for (int e = tid; e < kBKV * DH; e += kThreads) {
      const int j = e / DH, d = e % DH, kp = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Tk) {
        kv = repro::to_f32(k[b * st.kb + kp * st.kt + h * st.kh + d]);
        vv = repro::to_f32(v[b * st.vb + kp * st.vt + h * st.vh + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = warp * kRowsPerWarp + i;
      if (r0 + rl >= R) continue;  // warp-uniform
      const int pos = ps[rl];
      const int kp = t0 + lane;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(qs[rl][d], ks[lane][d], s);
      bool valid = kp < kvl;
      if (causal) valid = valid && kp <= pos;
      if (window) valid = valid && kp > pos - window;
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[i], repro::warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + repro::warp_sum(p);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kBKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          acc[i][dd] = fmaf(pj, vs[j][lane + 32 * dd], acc[i][dd]);
      }
      m[i] = m_new;
      any[i] = any[i] || __any_sync(0xffffffffu, valid);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int gr = r0 + warp * kRowsPerWarp + i;
    if (gr >= R) continue;
    const int g = gr / Tq, t = gr % Tq;
    T* o = out + b * st.ob + t * st.ot + (h * G + g) * st.oh;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd)
      o[lane + 32 * dd] = repro::from_f32<T>(any[i] ? acc[i][dd] / den : 0.f);
  }
}

template <typename T, int DH>
void launch_dh(const void* q, const void* k, const void* v, const void* qp,
               const void* kvl, void* out, int B, int Hkv, int G, int Tq,
               int Tk, const Strides& st, int causal, int window, float scale,
               cudaStream_t s) {
  const dim3 grid((G * Tq + kBQ - 1) / kBQ, B * Hkv);
  flash_kernel<T, DH><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kvl), static_cast<T*>(out), Hkv, G, Tq, Tk, st,
      causal, window, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qp,
           const void* kvl, void* out, int B, int Hkv, int G, int Tq, int Tk,
           int dh, const long long* strides, int causal, int window,
           float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  if (B * Hkv == 0 || G * Tq == 0) return static_cast<int>(cudaGetLastError());
  switch (dh) {
    case 32:
      launch_dh<T, 32>(q, k, v, qp, kvl, out, B, Hkv, G, Tq, Tk, st, causal,
                       window, scale, s);
      break;
    case 64:
      launch_dh<T, 64>(q, k, v, qp, kvl, out, B, Hkv, G, Tq, Tk, st, causal,
                       window, scale, s);
      break;
    case 128:
      launch_dh<T, 128>(q, k, v, qp, kvl, out, B, Hkv, G, Tq, Tk, st, causal,
                        window, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Tq, Hq = Hkv·G, dh]; k/v [B, Tk, Hkv, dh]; out [B, Tq, Hq, dh]: one
// storage type, unit stride along dh, other strides (in elements) given in
// `strides` as (q: b, t, h), (k: b, t, h), (v: b, t, h), (out: b, t, h).
// q_pos int32 [B·Hkv, G·Tq] (-1 = pad row); kv_len int32 [B·Hkv].
// dh in {32, 64, 128}.  Returns cudaGetLastError().
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* q_pos,
                                    const void* kv_len, void* out, int B,
                                    int Hkv, int G, int Tq, int Tk, int dh,
                                    const long long* strides, int causal,
                                    int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, q_pos, kv_len, out, B, Hkv, G, Tq, Tk,
                               dh, strides, causal, window, scale, stream);
}
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* kv_len,
                                   void* out, int B, int Hkv, int G, int Tq,
                                   int Tk, int dh, const long long* strides,
                                   int causal, int window, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, q_pos, kv_len, out, B, Hkv, G, Tq, Tk, dh,
                       strides, causal, window, scale, stream);
}
