// Ragged mixed-step paged attention for Hopper, sm_90a.
//
// ragged_mixed_launch replaces dynamo_tpu/ops/pallas/ragged.py
// `ragged_mixed_attention_stacked` -> `_ragged_mixed` -> `_ragged_kernel`.
// (The chunked-prefill entry moved to prefill_sm90.cu, a TMA + wgmma
// design; the kernel here is the first port's WMMA design, kept for the
// ragged entry until that entry moves onto the Hopper kernel too.)
//
// It computes causal flash attention of S new query tokens per row, which
// sit at positions q_start = positions[b, 0] .. onward, against the row's
// paged context: query at position p sees kv positions t <= p, t < ctx =
// total_lens[b] and, with a window w > 0, t > p - w; optional softcap
// cap*tanh(s/cap) before the mask; f32 online softmax; q scaled by sm_scale
// and rounded to bf16 first. A prefix-cache hit (q_start > 0) falls out: the
// queries attend to whatever the page table already holds. Query slots past
// the row's real tokens (p >= ctx, i.e. beyond q_len = ctx - q_start) are pad
// and come out as zeros. The TPU ragged kernel's skip: a query tile wholly
// past q_len (a decode row has q_len = 1) writes its zeros and returns
// without touching the cache.
//
// What bounds it on the H100: tensor-core FLOPs at long S (4*S*ctx*Hq*Dh per
// row against ~2 bytes per kv element read once per query tile), HBM bytes
// for short chunks. Design for that: one block per (row, kv head, query tile
// of BQ tokens); the tile stacks its BQ tokens x G query heads into one
// M = BQ*G row operand, so each K/V chunk loaded into shared memory serves
// all G heads of the kv head; scores and P.V run on the tensor cores through
// WMMA bf16 x bf16 -> f32 (16x16x16); the kv loop stops at the tile's causal
// bound min(ctx, q_start + tile_end) and starts at the window's first chunk.
// K/V rows past the live context are zero-filled in shared memory, and every
// masked score is replaced by a select, so NaN in the garbage page cannot
// reach the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int DH = 128;       // head dim (the wrapper rejects others)
constexpr int KB = 64;        // kv positions per chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int LDQ = DH + 8;   // padded leading dims (bank spread; WMMA needs
constexpr int LDK = DH + 8;   // multiples of 8 for bf16, 4 for f32)
constexpr int LDS = KB + 4;
constexpr int LDP = KB + 8;
constexpr int LDO = DH + 4;
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int query_block(int G) { return G <= 4 ? 32 : 16; }

__host__ __device__ constexpr size_t smem_bytes(int M) {
  return (size_t)M * LDQ * 2 + 2 * (size_t)KB * LDK * 2 + (size_t)M * LDS * 4 +
         (size_t)M * LDP * 2 + (size_t)M * LDO * 4 + 3 * (size_t)M * 4;
}

template <int G, int BQ, bool RAGGED>
__global__ void __launch_bounds__(THREADS)
paged_flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pages,
                   bf16* __restrict__ out, const int* __restrict__ page_table,
                   const int* __restrict__ positions,
                   const int* __restrict__ total_lens, long long layer, int S,
                   int Hkv, int N, int ps, int P, float sm_scale, int window,
                   float softcap) {
  constexpr int M = BQ * G;  // row r = query slot (r / G), head (r % G)
  static_assert(M % 16 == 0, "query rows must tile by 16");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + M * LDQ;
  bf16* Vs = Ks + KB * LDK;
  float* Ss = reinterpret_cast<float*>(Vs + KB * LDK);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + M * LDS);
  float* Os = reinterpret_cast<float*>(Ps + M * LDP);
  float* m_s = Os + M * LDO;
  float* l_s = m_s + M;
  float* sc_s = l_s + M;

  const int b = blockIdx.x, h = blockIdx.y;
  const int tile0 = blockIdx.z * BQ;  // first query slot of this tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Hq = Hkv * G;
  const int ctx = total_lens[b];
  const int q_start = positions[(long long)b * S];
  const int kv_end = min(ctx, P * ps);

  if (RAGGED && tile0 >= ctx - q_start) {
    // the ragged skip: no real query in this tile -> zeros, no kv traffic
    for (int idx = tid; idx < M * (DH / 8); idx += THREADS) {
      const int r = idx / (DH / 8), c8 = idx % (DH / 8);
      const int s = tile0 + r / G;
      if (s < S)
        *reinterpret_cast<uint4*>(
            out + (((long long)b * S + s) * Hq + h * G + r % G) * DH + c8 * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int visible = min(kv_end, q_start + tile0 + BQ);
  const int first = window > 0 ? max(q_start + tile0 - window + 1, 0) : 0;

  // Q tile, scaled by sm_scale and rounded to bf16; slots past S are zero
  for (int idx = tid; idx < M * (DH / 8); idx += THREADS) {
    const int r = idx / (DH / 8), c8 = idx % (DH / 8);
    const int s = tile0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (((long long)b * S + s) * Hq + h * G + r % G) * DH + c8 * 8);
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(in[i]);
        o[i] = __floats2bfloat162_rn(f.x * sm_scale, f.y * sm_scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c8 * 8) = val;
  }
  for (int r = tid; r < M; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  for (int idx = tid; idx < M * DH; idx += THREADS)
    Os[(idx / DH) * LDO + idx % DH] = 0.f;

  const int* table = page_table + (long long)b * P;
  const long long page_stride = 2LL * Hkv * ps * DH;
  const long long head_off = (long long)h * ps * DH;
  const long long v_off = (long long)Hkv * ps * DH;
  const bf16* layer_base = pages + layer * N * page_stride;
  __syncthreads();

  for (int kc = (first / KB) * KB; kc < visible; kc += KB) {
    // 1. K/V chunk -> shared memory; rows past the live context are zeros
    for (int idx = tid; idx < KB * (DH / 8); idx += THREADS) {
      const int t = idx / (DH / 8), c8 = idx % (DH / 8);
      const int pos = kc + t;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (pos < kv_end) {
        const long long page = table[pos / ps];
        const bf16* kp = layer_base + page * page_stride + head_off +
                         (long long)(pos % ps) * DH + c8 * 8;
        kv = *reinterpret_cast<const uint4*>(kp);
        vv = *reinterpret_cast<const uint4*>(kp + v_off);
      }
      *reinterpret_cast<uint4*>(Ks + t * LDK + c8 * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + t * LDK + c8 * 8) = vv;
    }
    __syncthreads();
    // 2. S = Q K^T on the tensor cores
    for (int tile = warp; tile < (M / 16) * (KB / 16); tile += NWARPS) {
      const int mi = tile / (KB / 16), ni = tile % (KB / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int k = 0; k < DH / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, Qs + mi * 16 * LDQ + k * 16, LDQ);
        wmma::load_matrix_sync(kb, Ks + ni * 16 * LDK + k * 16, LDK);
        wmma::mma_sync(c, a, kb, c);
      }
      wmma::store_matrix_sync(Ss + mi * 16 * LDS + ni * 16, c, LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // 3. masked online softmax, one warp per row; p -> bf16 for P.V
    for (int r = warp; r < M; r += NWARPS) {
      const int sl = tile0 + r / G;
      const int qpos = q_start + sl;
      const bool row_ok = sl < S && qpos < ctx;
      float sv[KB / 32];
      bool ok[KB / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < KB / 32; ++u) {
        const int c = lane + 32 * u;
        const int kpos = kc + c;
        float s = Ss[r * LDS + c];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ok[u] = row_ok && kpos <= qpos && kpos < kv_end &&
                (window <= 0 || kpos > qpos - window);
        sv[u] = ok[u] ? s : NEG_INF;
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KB / 32; ++u) {
        const float p = ok[u] ? expf(sv[u] - m_new) : 0.f;
        Ps[r * LDP + lane + 32 * u] = __float2bfloat16_rn(p);
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float sc = m_old > NEG_INF * 0.5f ? expf(m_old - m_new) : 0.f;
        sc_s[r] = sc;
        l_s[r] = l_s[r] * sc + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 4. rescale the running output rows
    for (int idx = tid; idx < M * DH; idx += THREADS) {
      const int r = idx / DH;
      Os[r * LDO + idx % DH] *= sc_s[r];
    }
    __syncthreads();
    // 5. O += P V on the tensor cores
    for (int tile = warp; tile < (M / 16) * (DH / 16); tile += NWARPS) {
      const int mi = tile / (DH / 16), di = tile % (DH / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* o = Os + mi * 16 * LDO + di * 16;
      wmma::load_matrix_sync(c, o, LDO, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < KB / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, Ps + mi * 16 * LDP + k * 16, LDP);
        wmma::load_matrix_sync(vb, Vs + k * 16 * LDK + di * 16, LDK);
        wmma::mma_sync(c, a, vb, c);
      }
      wmma::store_matrix_sync(o, c, LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // normalise and store; rows that saw nothing (pad) have O = 0, l = 0 -> 0
  for (int idx = tid; idx < M * (DH / 8); idx += THREADS) {
    const int r = idx / (DH / 8), c8 = idx % (DH / 8);
    const int s = tile0 + r / G;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-20f);
    uint4 val;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&val);
    const float* src = Os + r * LDO + c8 * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __floats2bfloat162_rn(src[2 * i] * inv, src[2 * i + 1] * inv);
    *reinterpret_cast<uint4*>(
        out + (((long long)b * S + s) * Hq + h * G + r % G) * DH + c8 * 8) = val;
  }
}

template <int G, bool RAGGED>
int launch(const void* q, const void* pages, void* out, const void* table,
           const void* positions, const void* lens, long long layer, int B,
           int S, int Hkv, int N, int ps, int P, float sm_scale, int window,
           float softcap, cudaStream_t stream) {
  constexpr int BQ = query_block(G);
  const size_t smem = smem_bytes(BQ * G);
  auto kern = paged_flash_kernel<G, BQ, RAGGED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, Hkv, (S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pages),
      static_cast<bf16*>(out), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<const int*>(lens), layer,
      S, Hkv, N, ps, P, sm_scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool RAGGED>
int dispatch(const void* q, const void* pages, void* out, const void* table,
             const void* positions, const void* lens, long long layer, int B,
             int S, int Hq, int Hkv, int N, int ps, int P, float sm_scale,
             int window, float softcap, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DYN_CASE(GV)                                                        \
  case GV:                                                                  \
    return launch<GV, RAGGED>(q, pages, out, table, positions, lens, layer, \
                              B, S, Hkv, N, ps, P, sm_scale, window,        \
                              softcap, s);
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

}  // namespace

extern "C" int ragged_mixed_launch(const void* q, const void* pages,
                                   void* out, const void* page_table,
                                   const void* positions,
                                   const void* total_lens, long long layer,
                                   int B, int S, int Hq, int Hkv, int N,
                                   int ps, int P, float sm_scale, int window,
                                   float softcap, void* stream) {
  return dispatch<true>(q, pages, out, page_table, positions, total_lens,
                        layer, B, S, Hq, Hkv, N, ps, P, sm_scale, window,
                        softcap, stream);
}
