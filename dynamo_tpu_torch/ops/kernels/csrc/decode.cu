// Paged decode attention (one query token per row) for Hopper, sm_90a:
// split-KV (flash-decoding).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/decode.py
// `paged_decode_attention_stacked` -> `_paged_decode` -> `_decode_kernel`.
// Computes, for each row b and query head h, single-query GQA attention over
// the row's paged context: positions t < total_lens[b] (and, with a sliding
// window w > 0, t >= total_lens[b] - w), an f32 online softmax, optional
// softcap cap*tanh(s/cap) applied before the max. q is scaled by sm_scale
// and rounded to bf16 first, as the TPU kernel's caller does; p rounds to
// bf16 before P.V, as the TPU kernel's p.astype(v).
//
// Cache layout (the reference's, byte for byte): pages [L, N, 2, Hkv, ps, Dh]
// bf16, page 0 the garbage page; page_table [B, P] int32 logical -> physical.
//
// What bounds it on the H100: HBM bytes. Each live K/V row is read once
// (2 * ctx * Hkv * Dh * 2 bytes per row) and the arithmetic is ~2 flop per
// byte, far below the ~295 flop/byte where the tensor cores would bound it.
// So the card must keep enough bytes in flight to cover HBM latency at
// every batch size. Design for that:
// - the grid is (B * Hkv) x splits: each block takes one (row, kv head) and
//   a whole number of pages of the table (`split_pages`); the host picks the
//   split count from B * Hkv, the SM count and the table's width, never from
//   the lengths, so the launch shape does not depend on data. A split that
//   starts past the context or ends before the window writes a dead partial
//   (m = -1e30, l = 0) and exits;
// - a block reads its split's page ids into shared memory once, then streams
//   K and V together through a ring of STAGES chunks of CK positions with
//   cp.async (16 bytes a thread, zero-filled past the context), so three
//   chunks are in flight while one is consumed; one __syncthreads a chunk;
// - the G query heads of the kv head live in registers, so each K/V row is
//   read from HBM once for all G heads; each half-warp runs its own online
//   softmax over its quarter of every chunk (no block barrier inside the
//   softmax), and the 8 half-warp states merge at the end;
// - with one split the block normalises and writes bf16 itself; with more,
//   it writes f32 (num, den, max) partials and `merge_splits_kernel` merges
//   them per (row, head) and rounds to bf16 once: the arithmetic of
//   merge_softmax_partials / normalize_softmax_partials
//   (dynamo_tpu/ops/attention.py).
// Masked scores are replaced by a select and positions past the context
// arrive as zeros, so a NaN left in the garbage page cannot leak through
// 0 * NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 128;              // head dim (the wrapper rejects others)
constexpr int THREADS = 128;         // 8 half-warps
constexpr int HALVES = THREADS / 16;
constexpr int CK = 32;               // kv positions per pipeline stage
constexpr int STAGES = 4;
constexpr int ROWS_PER_HALF = CK / HALVES;
constexpr int MAX_SPLIT_PAGES = 512; // the host keeps every split within it
constexpr int MAX_G = 8;
constexpr float NEG_INF = -1e30f;
constexpr size_t KV_BYTES = (size_t)2 * STAGES * CK * DH * sizeof(bf16);
constexpr size_t SMEM_BYTES =
    KV_BYTES + MAX_SPLIT_PAGES * sizeof(int) + 2 * HALVES * MAX_G * sizeof(float);
static_assert((size_t)HALVES * MAX_G * DH * sizeof(float) <= KV_BYTES / 2,
              "the merge buffer aliases the K ring");

__device__ __forceinline__ void bf16x8_to_float(const uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int G>
__global__ void __launch_bounds__(THREADS)
split_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pages,
                    bf16* __restrict__ out, float* __restrict__ part_num,
                    float* __restrict__ part_ml,
                    const int* __restrict__ page_table,
                    const int* __restrict__ total_lens, long long layer,
                    int Hkv, int N, int ps, int P, int split_pages, int splits,
                    float sm_scale, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*Ks)[CK][DH] = reinterpret_cast<bf16(*)[CK][DH]>(smem);
  bf16(*Vs)[CK][DH] = reinterpret_cast<bf16(*)[CK][DH]>(smem + KV_BYTES / 2);
  int* pid = reinterpret_cast<int*>(smem + KV_BYTES);
  float* red_m = reinterpret_cast<float*>(pid + MAX_SPLIT_PAGES);  // [HALVES][G]
  float* red_l = red_m + HALVES * MAX_G;
  float* red_acc = reinterpret_cast<float*>(smem);  // [HALVES][G][DH], after the ring

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int hw = tid >> 4;   // half-warp
  const int hl = tid & 15;   // lane in the half-warp: dims hl*8 .. hl*8+7
  const int Hq = Hkv * G;

  const int ctx = min(total_lens[b], P * ps);
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const int s0 = split * split_pages * ps;
  const int start = max(s0, lo);
  const int end = min(s0 + split_pages * ps, ctx);

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
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  if (start < end) {  // uniform over the block
    const int first_page = start / ps;
    const int n_pages = (end - 1) / ps - first_page + 1;
    const int* table = page_table + (long long)b * P + first_page;
    for (int i = tid; i < n_pages; i += THREADS) pid[i] = table[i];
    __syncthreads();

    const long long page_stride = 2LL * Hkv * ps * DH;
    const long long v_off = (long long)Hkv * ps * DH;
    const bf16* head_base =
        pages + layer * N * page_stride + (long long)h * ps * DH;
    const int n_chunks = (end - start + CK - 1) / CK;

    auto issue = [&](int c, int st) {
#pragma unroll
      for (int i = 0; i < CK * (DH / 8) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int row = idx >> 4, c16 = idx & 15;
        const int pos = start + c * CK + row;
        const bool valid = pos < end;
        const bf16* src = pages;  // any mapped address: nothing is read
        if (valid)
          src = head_base + (long long)pid[pos / ps - first_page] * page_stride +
                (long long)(pos % ps) * DH + c16 * 8;
        cp_async16(&Ks[st][row][c16 * 8], src, valid);
        cp_async16(&Vs[st][row][c16 * 8], valid ? src + v_off : pages, valid);
      }
    };

#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < n_chunks) issue(c, c);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk c landed; every thread is done with c - 1
      if (c + STAGES - 1 < n_chunks) issue(c + STAGES - 1, (c + STAGES - 1) % STAGES);
      cp_async_commit();
      const int st = c % STAGES;

      // scores of this half-warp's rows of the chunk, all G heads
      float s[G][ROWS_PER_HALF];
#pragma unroll
      for (int j = 0; j < ROWS_PER_HALF; ++j) {
        const int row = hw + HALVES * j;
        const bool valid = start + c * CK + row < end;  // uniform per half-warp
        float kf[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(&Ks[st][row][hl * 8]), kf);
        float d[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          d[g] = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) d[g] += qr[g][i] * kf[i];
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
          float x = d[g];
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[g][j] = valid ? x : NEG_INF;
        }
      }
      // online softmax of this half-warp's state
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int j = 0; j < ROWS_PER_HALF; ++j) mx = fmaxf(mx, s[g][j]);
        const float sc = m[g] > NEG_INF * 0.5f ? expf(m[g] - mx) : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < ROWS_PER_HALF; ++j) {
          const float p = s[g][j] > NEG_INF * 0.5f ? expf(s[g][j] - mx) : 0.f;
          s[g][j] = p;
          sum += p;
        }
        l[g] = l[g] * sc + sum;
        m[g] = mx;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] *= sc;
      }
      // P.V: the rows this half-warp scored
#pragma unroll
      for (int j = 0; j < ROWS_PER_HALF; ++j) {
        const int row = hw + HALVES * j;
        if (start + c * CK + row < end) {
          float vf[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(&Vs[st][row][hl * 8]), vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = round_bf16(s[g][j]);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[g][i] += p * vf[i];
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // the K ring is free: it becomes the merge buffer

  if (hl == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red_m[hw * G + g] = m[g];
      red_l[hw * G + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) red_acc[(hw * G + g) * DH + hl * 8 + i] = acc[g][i];
  __syncthreads();

  for (int idx = tid; idx < G * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < HALVES; ++r) mx = fmaxf(mx, red_m[r * G + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < HALVES; ++r) {
      const float mr = red_m[r * G + g];
      const float w = mr > NEG_INF * 0.5f ? expf(mr - mx) : 0.f;
      num += w * red_acc[(r * G + g) * DH + d];
      den += w * red_l[r * G + g];
    }
    const long long row = (long long)b * Hq + h * G + g;
    if (splits == 1) {
      out[row * DH + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-20f));
    } else {
      const long long prow = row * splits + split;
      part_num[prow * DH + d] = num;
      if (d == 0) {
        part_ml[prow * 2] = mx;
        part_ml[prow * 2 + 1] = den;
      }
    }
  }
}

// one block per (row, query head), one thread per dim: merge the splits'
// (num, den, max) states and normalise, dead states (max -1e30) weigh zero
__global__ void __launch_bounds__(DH)
merge_splits_kernel(const float* __restrict__ part_num,
                    const float* __restrict__ part_ml, bf16* __restrict__ out,
                    int splits) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * splits * 2;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ms = ml[2 * s];
    const float w = ms > NEG_INF * 0.5f ? expf(ms - mx) : 0.f;
    num += w * part_num[(row * splits + s) * DH + d];
    den += w * ml[2 * s + 1];
  }
  out[row * DH + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-20f));
}

template <int G>
int launch(const void* q, const void* pages, void* out, void* part_num,
           void* part_ml, const void* table, const void* lens, long long layer,
           int B, int Hkv, int N, int ps, int P, int split_pages, int splits,
           float sm_scale, int window, float softcap, cudaStream_t stream) {
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_decode_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  split_decode_kernel<G><<<dim3(B * Hkv, splits), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pages),
      static_cast<bf16*>(out), static_cast<float*>(part_num),
      static_cast<float*>(part_ml), static_cast<const int*>(table),
      static_cast<const int*>(lens), layer, Hkv, N, ps, P, split_pages, splits,
      sm_scale, window, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  merge_splits_kernel<<<B * Hkv * G, DH, 0, stream>>>(
      static_cast<const float*>(part_num), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_num [B, Hq, splits, Dh] and part_ml [B, Hq, splits, 2] f32 are the
// caller's scratch (unused, may be null, when splits == 1). Every split is
// split_pages whole pages and the splits cover the table:
// split_pages <= 512 and (splits - 1) * split_pages < P <= splits * split_pages.
extern "C" int paged_decode_launch(const void* q, const void* pages, void* out,
                                   void* part_num, void* part_ml,
                                   const void* page_table,
                                   const void* total_lens, long long layer,
                                   int B, int Hq, int Hkv, int N, int ps, int P,
                                   int split_pages, int splits, float sm_scale,
                                   int window, float softcap, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || splits < 1 || split_pages < 0 ||
      split_pages > MAX_SPLIT_PAGES || (long long)splits * split_pages < P ||
      (splits > 1 && (part_num == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DYN_CASE(GV)                                                          \
  case GV:                                                                    \
    return launch<GV>(q, pages, out, part_num, part_ml, page_table,           \
                      total_lens, layer, B, Hkv, N, ps, P, split_pages, splits, \
                      sm_scale, window, softcap, s);
  switch (Hq / Hkv) {
    DYN_CASE(1)
    DYN_CASE(2)
    DYN_CASE(3)
    DYN_CASE(4)
    DYN_CASE(6)
    DYN_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DYN_CASE
}
