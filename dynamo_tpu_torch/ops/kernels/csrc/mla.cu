// Latent (MLA) paged attention for Hopper, sm_90a: decode and chunked prefill.
//
// One templated kernel serves two TPU kernels, each with its own C entry:
// - mla_decode_launch replaces dynamo_tpu/ops/pallas/mla_decode.py
//   `mla_paged_decode_stacked` -> `_mla_paged_decode` -> `_mla_decode_kernel`;
// - mla_prefill_launch replaces dynamo_tpu/ops/pallas/mla_prefill.py
//   `mla_paged_prefill_stacked` -> `_mla_paged_prefill` -> `_mla_prefill_kernel`.
//
// DeepSeek's absorbed multi-head latent attention over the 2-slot latent
// cache pages [L, N, 2, 1, ps, dkv] bf16 (slot 0 the latent c_kv, slot 1 the
// shared roped key k_pe zero-padded to dkv). For query head h of a query at
// position p and each kv position t <= p, t < ctx = total_lens[b]:
//   s[t]   = q_lat[h] . c_kv[t] + q_pe[h] . k_pe[t]
//   out[h] = sum_t softmax(s)[t] * c_kv[t]          (the value IS the latent)
// The query arrives pre-scaled by sm_scale, rounded to bf16 and stacked as
// one row [q_lat | q_pe] of dkv + dr values (the wrapper does it, as the TPU
// kernels' callers do); scores and sums are f32 (online softmax), p rounds
// to bf16 before P.V, and the output is f32 [B, S, nh, dkv], as on the TPU.
// Decode (S = 1) puts its query at ctx - 1; prefill puts row b's queries at
// positions[b, 0] + s, so a prefix-cache hit attends to whatever the page
// table already holds. Query slots at or past ctx are pad and come out zero;
// a query tile wholly past them writes its zeros and returns without
// touching the cache (a decode row's 511 pad slots inside a mixed step).
//
// What bounds it on the H100: HBM bytes at decode (each live position's
// (dkv + dr) * 2 bytes against 4 * nh * (dkv + dr) flops: 64 flop/byte at
// nh = 16, far below the ~295 where the tensor cores bound), tensor-core
// flops at long prefill chunks. Design for that, simple first:
// - MLA has ONE kv head, so every query head of a row reads the same latent
//   page. The block stacks HG = 16 heads (x BQ query tokens) into the M
//   dimension of WMMA bf16 x bf16 -> f32 products (16x16x16), so each kv
//   chunk loaded into shared memory serves all of them. nh must be a
//   multiple of 16 (V2-Lite 16, V2/V3 128); a head group of 16 is one block.
// - Slot 1 is read only for its first dr columns: the padding is zeros and
//   would not change the score (mla_decode.py:28-29), and skipping it saves
//   (dkv - dr) * 2 of every position's 2 * dkv * 2 bytes.
// - The TPU grid is sequential and Hopper's is not: decode gets one block
//   per (row, head group) and loops over kv chunks of KB positions; prefill
//   one block per (row, query tile of BQ tokens, head group), looping only
//   over the chunks its causal bound min(ctx, q_start + tile_end) can see.
// - The accumulator is the trouble: [M, dkv] f32 is 64 KB at M = 32 and
//   dkv = 512, beside a [KB, dkv + dr] bf16 kv chunk of 73 KB. It lives in
//   dynamic shared memory (above 48 KB, set with cudaFuncSetAttribute), and
//   the tiles are sized to the 227 KB budget: M = 16 (decode) or 32
//   (prefill, BQ = 2) rows and KB = 64 positions. Heads past the first 16
//   go to other blocks, which re-read the chunk (from L2). Register-resident
//   accumulators (mma.sync / wgmma), TMA, a producer warp and split-KV for
//   small batches are later work.
// - NaN in the garbage page 0 cannot leak: rows past the live context are
//   zero-filled in shared memory and every masked score is replaced by a
//   select, so no masked weight multiplies a loaded value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int HG = 16;        // query heads per block: one WMMA row tile
constexpr int KB = 64;        // kv positions per chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int PAD = 8;        // bf16 row padding (bank spread; WMMA ld % 8)
constexpr int LDS = KB + 4;   // f32 scores
constexpr int LDP = KB + 8;   // bf16 probabilities
constexpr int SMEM_MAX = 232448;  // 227 KB of dynamic shared memory
constexpr float NEG_INF = -1e30f;

// Shared-memory layout of a block with M query rows; every section and tile
// offset is a multiple of 32 bytes, as WMMA's loads and stores require.
// ops/kernels/_wrap.py mla_smem_bytes mirrors `total`.
struct Layout {
  int ldq;  // bf16 elements per Q / K row: dkv + dr + PAD
  int ldo;  // f32 elements per accumulator row: dkv + 4
  size_t k, s, p, o, stats, total;  // byte offsets (Q at 0)
};

__host__ __device__ inline Layout layout(int M, int dkv, int dr) {
  Layout L;
  L.ldq = dkv + dr + PAD;
  L.ldo = dkv + 4;
  L.k = (size_t)M * L.ldq * 2;
  L.s = L.k + (size_t)KB * L.ldq * 2;
  L.p = L.s + (size_t)M * LDS * 4;
  L.o = L.p + (size_t)M * LDP * 2;
  L.stats = L.o + (size_t)M * L.ldo * 4;
  L.total = L.stats + 3 * (size_t)M * 4;
  return L;
}

template <int BQ, bool DECODE>
__global__ void __launch_bounds__(THREADS)
mla_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pages,
           float* __restrict__ out, const int* __restrict__ page_table,
           const int* __restrict__ positions,
           const int* __restrict__ total_lens, long long layer, int S, int nh,
           int dkv, int dr, int N, int ps, int P) {
  constexpr int M = BQ * HG;  // row r = query slot tile0 + r / HG, head r % HG
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lo = layout(M, dkv, dr);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lo.k);
  float* Ss = reinterpret_cast<float*>(smem + lo.s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + lo.p);
  float* Os = reinterpret_cast<float*>(smem + lo.o);
  float* m_s = reinterpret_cast<float*>(smem + lo.stats);
  float* l_s = m_s + M;
  float* sc_s = l_s + M;
  const int ldq = lo.ldq, ldo = lo.ldo;
  const int kw = dkv + dr;     // query / key row width
  const int kw8 = kw / 8, dkv4 = dkv / 4;

  const int b = blockIdx.x;
  const int tile0 = blockIdx.y * BQ;  // first query slot of this tile
  const int h0 = blockIdx.z * HG;     // first head of this group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ctx = total_lens[b];
  const int q_start = DECODE ? ctx - 1 : positions[(long long)b * S];
  const int kv_end = min(ctx, P * ps);
  // output row of block row r (valid when its slot is < S)
  auto out_row = [&](int r) {
    return out + (((long long)b * S + tile0 + r / HG) * nh + h0 + r % HG) *
                     (long long)dkv;
  };

  if (tile0 >= ctx - q_start) {
    // no real query in this tile: zeros, no kv traffic
    for (int idx = tid; idx < M * dkv4; idx += THREADS) {
      const int r = idx / dkv4, c4 = idx % dkv4;
      if (tile0 + r / HG < S)
        reinterpret_cast<float4*>(out_row(r))[c4] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int visible = min(kv_end, q_start + tile0 + BQ);

  // Q tile (pre-scaled bf16 rows [q_lat | q_pe]); slots past S are zero
  for (int idx = tid; idx < M * kw8; idx += THREADS) {
    const int r = idx / kw8, c8 = idx % kw8;
    const int s = tile0 + r / HG;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          q + (((long long)b * S + s) * nh + h0 + r % HG) * kw + c8 * 8);
    *reinterpret_cast<uint4*>(Qs + r * ldq + c8 * 8) = val;
  }
  for (int r = tid; r < M; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  for (int idx = tid; idx < M * dkv; idx += THREADS)
    Os[(idx / dkv) * ldo + idx % dkv] = 0.f;

  const int* table = page_table + (long long)b * P;
  const long long page_stride = 2LL * ps * dkv;   // [2, 1, ps, dkv]
  const long long rope_off = (long long)ps * dkv;  // slot 1
  const bf16* layer_base = pages + layer * N * page_stride;
  __syncthreads();

  for (int kc = 0; kc < visible; kc += KB) {
    // 1. kv chunk -> shared memory: row t = [c_kv | k_pe[:dr]] of position
    //    kc + t; rows past the live context are zeros
    for (int idx = tid; idx < KB * kw8; idx += THREADS) {
      const int t = idx / kw8, col = (idx % kw8) * 8;
      const int pos = kc + t;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (pos < kv_end) {
        const bf16* row = layer_base + (long long)table[pos / ps] * page_stride +
                          (long long)(pos % ps) * dkv;
        val = *reinterpret_cast<const uint4*>(
            col < dkv ? row + col : row + rope_off + (col - dkv));
      }
      *reinterpret_cast<uint4*>(Ks + t * ldq + col) = val;
    }
    __syncthreads();
    // 2. S = Q K^T on the tensor cores (contracting all dkv + dr columns)
    for (int tile = warp; tile < (M / 16) * (KB / 16); tile += NWARPS) {
      const int mi = tile / (KB / 16), ni = tile % (KB / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int k = 0; k < kw / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, Qs + mi * 16 * ldq + k * 16, ldq);
        wmma::load_matrix_sync(kb, Ks + ni * 16 * ldq + k * 16, ldq);
        wmma::mma_sync(c, a, kb, c);
      }
      wmma::store_matrix_sync(Ss + mi * 16 * LDS + ni * 16, c, LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // 3. masked online softmax, one warp per row; p -> bf16 for P.V
    for (int r = warp; r < M; r += NWARPS) {
      const int sl = tile0 + r / HG;
      const int qpos = q_start + sl;
      const bool row_ok = sl < S && qpos < ctx;
      float sv[KB / 32];
      bool ok[KB / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < KB / 32; ++u) {
        const int kpos = kc + lane + 32 * u;
        ok[u] = row_ok && kpos <= qpos && kpos < kv_end;
        sv[u] = ok[u] ? Ss[r * LDS + lane + 32 * u] : NEG_INF;
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
    for (int idx = tid; idx < M * dkv; idx += THREADS) {
      const int r = idx / dkv;
      Os[r * ldo + idx % dkv] *= sc_s[r];
    }
    __syncthreads();
    // 5. O += P V on the tensor cores; V is the chunk's first dkv columns
    for (int tile = warp; tile < (M / 16) * (dkv / 16); tile += NWARPS) {
      const int mi = tile / (dkv / 16), di = tile % (dkv / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* o = Os + mi * 16 * ldo + di * 16;
      wmma::load_matrix_sync(c, o, ldo, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < KB / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, Ps + mi * 16 * LDP + k * 16, LDP);
        wmma::load_matrix_sync(vb, Ks + k * 16 * ldq + di * 16, ldq);
        wmma::mma_sync(c, a, vb, c);
      }
      wmma::store_matrix_sync(o, c, ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // normalise and store f32; rows that saw nothing (pad) have O = 0, l = 0
  for (int idx = tid; idx < M * dkv4; idx += THREADS) {
    const int r = idx / dkv4, c4 = idx % dkv4;
    if (tile0 + r / HG >= S) continue;
    const float l = fmaxf(l_s[r], 1e-20f);
    const float4 o = reinterpret_cast<const float4*>(Os + r * ldo)[c4];
    reinterpret_cast<float4*>(out_row(r))[c4] =
        make_float4(o.x / l, o.y / l, o.z / l, o.w / l);
  }
}

template <int BQ, bool DECODE>
int launch(const void* q, const void* pages, void* out, const void* table,
           const void* positions, const void* lens, long long layer, int B,
           int S, int nh, int dkv, int dr, int N, int ps, int P,
           void* stream) {
  if (B == 0 || S == 0) return 0;
  if (nh <= 0 || nh % HG || dkv <= 0 || dkv % 16 || dr < 0 || dr % 16 ||
      dr > dkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(BQ * HG, dkv, dr).total;
  if (smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = mla_kernel<BQ, DECODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, (S + BQ - 1) / BQ, nh / HG);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pages),
      static_cast<float*>(out), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<const int*>(lens), layer,
      S, nh, dkv, dr, N, ps, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mla_decode_launch(const void* q, const void* pages, void* out,
                                 const void* page_table,
                                 const void* total_lens, long long layer,
                                 int B, int nh, int dkv, int dr, int N, int ps,
                                 int P, void* stream) {
  return launch<1, true>(q, pages, out, page_table, nullptr, total_lens, layer,
                         B, 1, nh, dkv, dr, N, ps, P, stream);
}

extern "C" int mla_prefill_launch(const void* q, const void* pages, void* out,
                                  const void* page_table,
                                  const void* positions,
                                  const void* total_lens, long long layer,
                                  int B, int S, int nh, int dkv, int dr, int N,
                                  int ps, int P, void* stream) {
  return launch<2, false>(q, pages, out, page_table, positions, total_lens,
                          layer, B, S, nh, dkv, dr, N, ps, P, stream);
}
