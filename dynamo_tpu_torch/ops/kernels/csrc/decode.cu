// Paged decode attention (one query token per row) for Hopper, sm_90a.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/decode.py
// `paged_decode_attention_stacked` -> `_paged_decode` -> `_decode_kernel`.
// Computes, for each row b and query head h, single-query GQA attention over
// the row's paged context: positions t < total_lens[b] (and, with a sliding
// window w > 0, t >= total_lens[b] - w), an f32 online softmax, optional
// softcap cap*tanh(s/cap) applied before the max. q is scaled by sm_scale
// and rounded to bf16 first, as the TPU kernel's caller does.
//
// Cache layout (the reference's, byte for byte): pages [L, N, 2, Hkv, ps, Dh]
// bf16, page 0 the garbage page; page_table [B, P] int32 logical -> physical.
//
// What bounds it on the H100: HBM bytes. Each live K/V row is read once
// (2 * ctx * Hkv * Dh * 2 bytes per row) and the arithmetic is ~2 flop per
// byte, far below the ~295 flop/byte where the tensor cores would bound it.
// Design for that: one block per (row, kv head) holding that head's G query
// heads in registers, so each K/V row is read from HBM exactly once for all
// G heads; 16-byte vector loads, a half-warp per 256-byte K/V row (Dh=128
// bf16), neighbouring lanes on neighbouring addresses; the block reads its
// own page ids and walks only the live pages, from the window's first page
// to ceil(ctx/ps). Masked positions are never loaded: a score is replaced by
// a select, and the P.V sum skips them, so a NaN left in the garbage page
// cannot leak through 0*NaN. Split-KV (flash-decoding) for small B*Hkv is
// later work: at B*Hkv < 132 blocks the card is under-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;        // head dim (the wrapper rejects others)
constexpr int THREADS = 128;   // 4 warps = 8 half-warps
constexpr int CHUNK = 128;     // kv positions per online-softmax step
constexpr int GROUPS = THREADS / 16;  // half-warps: token groups
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void bf16x8_to_float(const uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pages,
                    __nv_bfloat16* __restrict__ out,
                    const int* __restrict__ page_table,
                    const int* __restrict__ total_lens, long long layer,
                    int Hkv, int N, int ps, int P, float sm_scale, int window,
                    float softcap) {
  __shared__ float s_p[G][CHUNK];       // scores, then probabilities
  __shared__ float s_m[G], s_l[G], s_scale[G];
  __shared__ float s_red[GROUPS][G][DH];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = tid >> 4;   // half-warp: the token group it serves
  const int hl = tid & 15;    // lane in the half-warp: dims hl*8 .. hl*8+7
  const int Hq = Hkv * G;

  const int ctx = min(total_lens[b], P * ps);
  const int first = window > 0 ? max(ctx - window, 0) : 0;

  // this lane's 8 dims of the G query heads, scaled then rounded to bf16
  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((long long)b * Hq + h * G + g) * DH + hl * 8);
    bf16x8_to_float(raw, qr[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[g][i] = round_bf16(qr[g][i] * sm_scale);
  }
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  if (tid < G) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }

  const int* table = page_table + (long long)b * P;
  // element offset of (layer, page=0, kv=0, head h, slot 0, dim 0)
  const long long page_stride = 2LL * Hkv * ps * DH;
  const long long head_off = (long long)h * ps * DH;
  const long long v_off = (long long)Hkv * ps * DH;
  const __nv_bfloat16* layer_base = pages + layer * N * page_stride;

  for (int c0 = (first / CHUNK) * CHUNK; c0 < ctx; c0 += CHUNK) {
    // 1. scores: one half-warp per kv position
    for (int t = grp; t < CHUNK; t += GROUPS) {
      const int pos = c0 + t;
      const bool valid = pos < ctx && pos >= first;  // uniform per half-warp
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) d[g] = 0.f;
      if (valid) {
        const long long page = table[pos / ps];
        const __nv_bfloat16* kp = layer_base + page * page_stride + head_off +
                                  (long long)(pos % ps) * DH + hl * 8;
        float kf[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(kp), kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < 8; ++i) d[g] += qr[g][i] * kf[i];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
      }
      if (hl == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = d[g];
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          s_p[g][t] = valid ? s : NEG_INF;
        }
      }
    }
    __syncthreads();
    // 2. online-softmax update, one warp per query head
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = NEG_INF;
      for (int t = lane; t < CHUNK; t += 32) mx = fmaxf(mx, s_p[g][t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < CHUNK; t += 32) {
        const float s = s_p[g][t];
        const float p = s > NEG_INF * 0.5f ? expf(s - m_new) : 0.f;
        s_p[g][t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float sc = m_old > NEG_INF * 0.5f ? expf(m_old - m_new) : 0.f;
        s_scale[g] = sc;
        s_l[g] = s_l[g] * sc + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // 3. P.V: the half-warp that scored position t also accumulates it
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sc = s_scale[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= sc;
    }
    for (int t = grp; t < CHUNK; t += GROUPS) {
      const int pos = c0 + t;
      if (pos < ctx && pos >= first) {
        const long long page = table[pos / ps];
        const __nv_bfloat16* vp = layer_base + page * page_stride + v_off +
                                  head_off + (long long)(pos % ps) * DH +
                                  hl * 8;
        float vf[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(vp), vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          // p rounds to bf16 before P.V, as the TPU kernel's p.astype(v)
          const float p = round_bf16(s_p[g][t]);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] += p * vf[i];
        }
      }
    }
    __syncthreads();
  }

  // reduce the GROUPS partial sums per (head, dim), normalise, store bf16
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) s_red[grp][g][hl * 8 + i] = acc[g][i];
  __syncthreads();
  for (int idx = tid; idx < G * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < GROUPS; ++r) sum += s_red[r][g][d];
    const float l = fmaxf(s_l[g], 1e-20f);
    out[((long long)b * Hq + h * G + g) * DH + d] = __float2bfloat16_rn(sum / l);
  }
}

template <int G>
int launch(const void* q, const void* pages, void* out, const void* table,
           const void* lens, long long layer, int B, int Hkv, int N, int ps,
           int P, float sm_scale, int window, float softcap,
           cudaStream_t stream) {
  dim3 grid(B, Hkv);
  paged_decode_kernel<G><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pages),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(table),
      static_cast<const int*>(lens), layer, Hkv, N, ps, P, sm_scale, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* pages,
                                   void* out, const void* page_table,
                                   const void* total_lens, long long layer,
                                   int B, int Hq, int Hkv, int N, int ps,
                                   int P, float sm_scale, int window,
                                   float softcap, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
    case 1: return launch<1>(q, pages, out, page_table, total_lens, layer, B, Hkv, N, ps, P, sm_scale, window, softcap, s);
    case 2: return launch<2>(q, pages, out, page_table, total_lens, layer, B, Hkv, N, ps, P, sm_scale, window, softcap, s);
    case 3: return launch<3>(q, pages, out, page_table, total_lens, layer, B, Hkv, N, ps, P, sm_scale, window, softcap, s);
    case 4: return launch<4>(q, pages, out, page_table, total_lens, layer, B, Hkv, N, ps, P, sm_scale, window, softcap, s);
    case 6: return launch<6>(q, pages, out, page_table, total_lens, layer, B, Hkv, N, ps, P, sm_scale, window, softcap, s);
    case 8: return launch<8>(q, pages, out, page_table, total_lens, layer, B, Hkv, N, ps, P, sm_scale, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
