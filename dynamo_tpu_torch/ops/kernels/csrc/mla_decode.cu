// Latent (MLA) paged decode attention (one query token per row) for Hopper,
// sm_90a: split-KV, a TMA ring fed by a producer warp, mma.sync with
// register accumulators.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/mla_decode.py
// `mla_paged_decode_stacked` -> `_mla_paged_decode` -> `_mla_decode_kernel`
// (and its per-layer variant `mla_paged_decode_layer`, the same kernel on a
// one-layer view). DeepSeek's absorbed multi-head latent attention over the
// 2-slot latent cache pages [L, N, 2, 1, ps, dkv] bf16 (slot 0 the latent
// c_kv, slot 1 the shared roped key k_pe zero-padded to dkv). For query head
// h of row b, whose one query sits at ctx - 1 (ctx = total_lens[b]), and each
// kv position t < ctx:
//   s[t]   = q_lat[h] . c_kv[t] + q_pe[h] . k_pe[t]
//   out[h] = sum_t softmax(s)[t] * c_kv[t]          (the value IS the latent)
// The query arrives pre-scaled by sm_scale, rounded to bf16 and stacked as
// one row [q_lat | q_pe] of dkv + dr values (the wrapper does it, as the TPU
// kernel's caller does); scores and sums are f32 (online softmax), p rounds
// to bf16 before P.V, and the output is f32 [B, 1, nh, dkv], as on the TPU.
//
// What bounds it on the H100: HBM bytes. Each live position's row is read
// once, (dkv + dr) * 2 bytes (slot 1 only for its first dr columns: the
// padding is zeros and would not change the score, mla_decode.py:28-29),
// against 4 * nh * (dkv + dr) flops: 64 flop/byte at nh = 16, far below the
// ~295 where the tensor cores bound. So the design keeps enough bytes in
// flight on every SM at every batch size, and keeps everything else off the
// path of the loads:
// - split-KV: the grid is (B * nh / 16) x splits; a block takes one row, 16
//   heads and a split of `split_pages` whole pages, chosen by the wrapper
//   from shapes alone (mla_decode_splits: the SM count, B, nh and the
//   table's width, never the lengths). At B = 1 one block becomes dozens.
//   A split that starts at or past the context exits at once, and the
//   merge reads only the splits before it. With one split the block writes
//   the f32 output itself; with more it writes f32 (num, den, max) partials
//   that `mla_merge_kernel` merges with merge_softmax_partials /
//   normalize_softmax_partials' arithmetic (dynamo_tpu/ops/attention.py);
// - the block reads its split's page ids into shared memory once; then one
//   producer warp keeps a ring of chunks of KB = 32 positions in flight
//   with TMA: one tensor map over the layer's [N * 2 * ps, dkv] view (a
//   page's slot is ps contiguous rows) with 128-byte swizzle, boxes of
//   [gcd(ps, 32) rows, 64 columns]: c_kv in dkv / 64 boxes and k_pe in
//   ceil(dr / 64) boxes a page, 18 copies of 2 KB for a 36 KB chunk at
//   V2-Lite's widths and ps = 16, completing on the stage's `full`
//   mbarrier; the consumers free a stage on its `empty` one. (One bulk copy
//   per position row and slot made the copies, not the bytes, the limit.)
//   The ring has 3 stages (~130 KB with the rest at V2-Lite's widths: one
//   block per SM, two chunks in flight while one is used). No consumer
//   thread spends an instruction on loads or waits on a block barrier for
//   them; boxes wholly past the split's end are not loaded;
// - products on the tensor cores with mma.sync.m16n8k16 (bf16 -> f32): the
//   16 heads are exactly one M = 16 tile. S = Q K^T is split over the 8
//   consumer warps by contraction eighths, each warp's Q fragments (an
//   eighth of the 576-wide row) held in registers for the whole split and
//   K read once through ldmatrix from the swizzled stage (conflict-free);
//   the partial scores meet in a small shared buffer, where each row's
//   softmax runs in one half-warp (shuffles only); P (bf16) and the rows'
//   rescale factors pass to P V the same way. O = P V is split over the 8
//   warps by dkv columns (64 each at dkv = 512: eight m16n8 tiles, 32 f32
//   registers a thread) and never leaves registers until the epilogue. wgmma needs M = 64 and would waste three quarters
//   of its rows at nh = 16; at 64 flop/byte mma.sync's rate is not what
//   bounds;
// - two barriers of the consumer warps a chunk (partial scores posted, P
//   posted); in the chunk that holds the split's end the consumers zero the
//   V rows past it (a page's stale slots, an earlier chunk's rows or
//   never-written memory), so p = 0 never meets a NaN.
// NaN in the garbage page 0 cannot leak: pages past the context are never
// loaded, rows past it are zeroed, and every masked score is replaced by a
// select.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HG = 16;         // query heads per block: one m16 tile
constexpr int KB = 32;         // kv positions per chunk
// ring depth: the most that fits every geometry the wrapper takes; depths
// 2 to 5 timed within 1% of each other at V2-Lite's widths
constexpr int STAGES = 3;
constexpr int NWARPS = 8;      // consumer warps
constexpr int KPARTS = NWARPS; // S: each warp takes an eighth of the contraction
constexpr int S_TILES = KB / 8; // and all positions: m16n8 score tiles a warp
constexpr int MAX_KSTEPS = (52 + KPARTS - 1) / KPARTS;  // kw <= 832
constexpr int THREADS = 32 * NWARPS + 32;  // + the producer warp
constexpr int BOX_COLS = 64;   // bf16 columns of a swizzled 128-byte row
constexpr int BLOCK_BYTES = KB * 128;  // one column block of a stage
constexpr int LDP = KB + 8;    // bf16 probabilities
constexpr int LDS = KB + 4;    // f32 partial scores
constexpr int MAX_SPLIT_PAGES = 256;  // the host keeps every split within it
constexpr int SMEM_MAX = 232448;      // 227 KB of dynamic shared memory
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BAR_CONSUMERS = 1;  // named barrier of the 256 consumer threads

// Shared memory of a block whose ring stages hold `cblocks` column blocks
// each; ops/kernels/_wrap.py mla_decode_smem_bytes mirrors `total`.
struct Layout {
  size_t stage, sp, p, sc, red_l, pid, bars, total;  // the ring at 0
};

__host__ __device__ inline Layout layout(int cblocks) {
  Layout L;
  L.stage = (size_t)cblocks * BLOCK_BYTES;
  L.sp = (size_t)STAGES * L.stage;
  L.p = L.sp + (size_t)KPARTS * HG * LDS * 4;
  L.sc = L.p + (size_t)HG * LDP * 2;
  L.red_l = L.sc + (size_t)HG * 4;
  L.pid = L.red_l + (size_t)HG * 4;
  L.bars = L.pid + (size_t)MAX_SPLIT_PAGES * 4;  // 8-byte aligned
  // + 1 KB: the ring's swizzle atoms start on a 1024-byte boundary
  L.total = L.bars + (size_t)(2 * STAGES) * 8 + 1024;
  return L;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONSUMERS), "n"(32 * NWARPS)
               : "memory");
}

// the 16-byte chunk `j` (0-7) of row `row` in a 128-byte-swizzled column
// block at `blk` (1024-byte aligned)
__device__ __forceinline__ uint32_t swz(uint32_t blk, int row, int j) {
  return blk + row * 128 + ((j ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT m16n8 output tiles per consumer warp: dkv = 64 * NT
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
mla_decode_kernel(const __grid_constant__ CUtensorMap kv_map,
                  const bf16* __restrict__ q, float* __restrict__ out,
                  float* __restrict__ part_num, float* __restrict__ part_ml,
                  const int* __restrict__ page_table,
                  const int* __restrict__ total_lens, int nh, int dr, int ps,
                  int P, int box_rows, int split_pages, int splits) {
  constexpr int DKV = 8 * NT * NWARPS;
  constexpr int CKV_BLOCKS = DKV / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  const int kw = DKV + dr;  // query / key row width
  const int cblocks = CKV_BLOCKS + (dr + BOX_COLS - 1) / BOX_COLS;
  const Layout lo = layout(cblocks);
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // the ring, 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  float* Sp = reinterpret_cast<float*>(smem + lo.sp);        // [KPARTS][HG][LDS]
  bf16* Ps = reinterpret_cast<bf16*>(smem + lo.p);           // [HG][LDP]
  float* sc_s = reinterpret_cast<float*>(smem + lo.sc);      // [HG]
  float* red_l = reinterpret_cast<float*>(smem + lo.red_l);  // [HG]
  int* pid = reinterpret_cast<int*>(smem + lo.pid);
  const uint32_t bars = base + (uint32_t)lo.bars;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (STAGES + st)
  const uint32_t empty0 = bars + 8 * STAGES;

  const int groups = nh / HG;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * HG;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // fragment row and column pair
  const long long row0 = (long long)b * nh + h0;  // output row of head h0

  const int ctx = min(total_lens[b], P * ps);
  const int start = split * split_pages * ps;
  const int end = min(start + split_pages * ps, ctx);
  if (start >= end) {
    // a split at or past the context: the merge does not read it; with one
    // split, a row with no context gets zeros, as the plain version
    if (splits == 1)
      for (int i = tid; i < HG * DKV / 4; i += THREADS)
        reinterpret_cast<float4*>(out + row0 * DKV)[i] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  // the split's page ids, read once
  const int first_page = start / ps;
  const int n_pages = (end - 1) / ps - first_page + 1;
  for (int i = tid; i < n_pages; i += THREADS)
    pid[i] = page_table[(long long)b * P + first_page + i];
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(empty0 + 8 * st, NWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_chunks = (end - start + KB - 1) / KB;

  if (warp == NWARPS) {
    // ---- producer warp: TMA boxes, one per lane (two rounds at most) ----
    // box x of column block cb of chunk i: rows [x * box_rows, + box_rows)
    // of the stage = positions start + i KB + x * box_rows .., one page's;
    // c_kv's blocks read slot 0's row, k_pe's slot 1's
    const int boxes = KB / box_rows;
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % STAGES;
      const uint32_t use = (uint32_t)(i / STAGES);
      if (i >= STAGES) mbar_wait(empty0 + 8 * st, (use & 1u) ^ 1u);
      const int pos0 = start + i * KB;
      const int live = min(boxes, (end - pos0 + box_rows - 1) / box_rows);
      const uint32_t full = bars + 8 * st;
      if (lane == 0) mbar_expect_tx(full, live * cblocks * box_rows * 128);
      __syncwarp();
      for (int op = lane; op < live * cblocks; op += 32) {
        const int x = op / cblocks, cb = op % cblocks;
        const int pos = pos0 + x * box_rows;
        const int slot = cb < CKV_BLOCKS ? 0 : 1;
        const int row = (pid[pos / ps - first_page] * 2 + slot) * ps + pos % ps;
        const int col = (cb < CKV_BLOCKS ? cb : cb - CKV_BLOCKS) * BOX_COLS;
        tma_load(base + st * (uint32_t)lo.stage + cb * BLOCK_BYTES + x * box_rows * 128,
                 &kv_map, full, col, row);
      }
    }
    return;
  }

  // ---- consumer warps ----
  // S = Q K^T: warp w takes contraction steps [w * ksp, + ksp) of 16 for
  // every position of a chunk, its Q fragments held in registers for the
  // whole split (pre-scaled bf16 rows [q_lat | q_pe])
  const int ksteps = kw / 16;
  const int ksp = (ksteps + KPARTS - 1) / KPARTS;
  const int k_first = warp * ksp;
  const int k_n = max(0, min(ksp, ksteps - k_first));
  uint32_t qf[MAX_KSTEPS][4];
#pragma unroll
  for (int j = 0; j < MAX_KSTEPS; ++j) {
    const int k0 = (k_first + j) * 16 + 2 * c;
    const bf16* qa = q + (row0 + g) * kw;
    const bf16* qb = q + (row0 + g + 8) * kw;
    const bool ok = j < k_n;
    qf[j][0] = ok ? *reinterpret_cast<const uint32_t*>(qa + k0) : 0u;
    qf[j][1] = ok ? *reinterpret_cast<const uint32_t*>(qb + k0) : 0u;
    qf[j][2] = ok ? *reinterpret_cast<const uint32_t*>(qa + k0 + 8) : 0u;
    qf[j][3] = ok ? *reinterpret_cast<const uint32_t*>(qb + k0 + 8) : 0u;
  }
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // softmax: thread t takes row r = t / 16 and positions 2 (t % 16), + 1
  const int r = tid >> 4, pr = tid & 15;
  float m_run = NEG_INF, l_run = 0.f;   // row r's max; this thread's share of its sum
  const int n0 = warp * 8 * NT;         // this warp's first output column
  // this lane's ldmatrix row (position) and 16-byte chunk within a k-step:
  // S reads K as [positions, k] (rows 0..15 of a pair of tiles), P V reads
  // V as [positions, columns] transposed (rows 0..15 of a 16-position step)
  const int s_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int s_j = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_j = lane >> 4;

  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % STAGES;
    mbar_wait(bars + 8 * st, (uint32_t)(i / STAGES) & 1u);
    const uint32_t stage = base + st * (uint32_t)lo.stage;
    const int kc = start + i * KB;
    {
      // this warp's partial scores: S_TILES independent accumulators
      float sp[S_TILES][4] = {};
#pragma unroll
      for (int j = 0; j < MAX_KSTEPS; ++j) {
        if (j < k_n) {
          const int col = (k_first + j) * 16;  // k of this step
          const uint32_t blk = stage + (col / BOX_COLS) * BLOCK_BYTES;
#pragma unroll
          for (int u = 0; u < S_TILES; u += 2) {
            uint32_t bk[4];
            ldmatrix_x4(bk, swz(blk, s_row + 8 * u, (col % BOX_COLS) / 8 + s_j));
            mma_16816(sp[u], qf[j], bk[0], bk[1]);
            mma_16816(sp[u + 1], qf[j], bk[2], bk[3]);
          }
        }
      }
      float* dst = Sp + (warp * HG) * LDS + 2 * c;
#pragma unroll
      for (int u = 0; u < S_TILES; ++u) {
        *reinterpret_cast<float2*>(dst + g * LDS + 8 * u) = make_float2(sp[u][0], sp[u][1]);
        *reinterpret_cast<float2*>(dst + (g + 8) * LDS + 8 * u) =
            make_float2(sp[u][2], sp[u][3]);
      }
    }
    if (kc + KB > end) {
      // the c_kv (V) rows past the end hold a page's stale slots, an
      // earlier chunk's rows or never-written memory: zeros, so p = 0 never
      // meets a NaN (their scores are selected away, whatever they read)
      const int dead = kc + KB - end;
      for (int idx = tid; idx < dead * CKV_BLOCKS * 8; idx += 32 * NWARPS) {
        const int t = KB - dead + idx / (CKV_BLOCKS * 8);
        const int cb = idx / 8 % CKV_BLOCKS;
        *reinterpret_cast<uint4*>(smem + (stage - base) + cb * BLOCK_BYTES + t * 128 +
                                  (idx % 8) * 16) = make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    consumer_sync();  // partial scores posted, dead V rows zeroed
    {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < KPARTS; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(Sp + (k * HG + r) * LDS + 2 * pr);
        s0 += v.x;
        s1 += v.y;
      }
      // positions past the split or the context: selected away
      const int t0 = kc + 2 * pr;
      if (t0 >= end) s0 = NEG_INF;
      if (t0 + 1 >= end) s1 = NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every chunk holds a live position, so m_new is a real score
      const float m_new = fmaxf(m_run, mx);
      const float ml = m_new * LOG2E;
      const float scale = m_run > NEG_INF * 0.5f ? ex2(m_run * LOG2E - ml) : 0.f;
      m_run = m_new;
      const float p0 = s0 > NEG_INF * 0.5f ? ex2(fmaf(s0, LOG2E, -ml)) : 0.f;
      const float p1 = s1 > NEG_INF * 0.5f ? ex2(fmaf(s1, LOG2E, -ml)) : 0.f;
      l_run = l_run * scale + p0 + p1;
      *reinterpret_cast<__nv_bfloat162*>(Ps + r * LDP + 2 * pr) =
          __floats2bfloat162_rn(p0, p1);
      if (pr == 0) sc_s[r] = scale;
    }
    consumer_sync();  // P and the rows' rescale factors posted
    const float sc0 = sc_s[g], sc1 = sc_s[g + 8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= sc0;
      o[j][1] *= sc0;
      o[j][2] *= sc1;
      o[j][3] *= sc1;
    }
    // O += P V over the chunk's positions, the warp's columns
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, static_cast<uint32_t>(__cvta_generic_to_shared(
                         Ps + (lane & 15) * LDP + kk * 16 + (lane >> 4) * 8)));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int col = n0 + 8 * j;  // a 16-column pair of tiles
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, swz(stage + (col / BOX_COLS) * BLOCK_BYTES,
                                  kk * 16 + v_row, (col % BOX_COLS) / 8 + v_j));
        mma_16816(o[j], a, bv[0], bv[1]);
        mma_16816(o[j + 1], a, bv[2], bv[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // stage free
  }

  // row r's sum over its 16 threads; its max is m_run
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    l_run += __shfl_xor_sync(0xffffffffu, l_run, off);
  if (pr == 0) red_l[r] = l_run;
  if (splits > 1 && pr == 0) {
    const long long prow = (row0 + r) * splits + split;
    part_ml[prow * 2] = m_run;
    part_ml[prow * 2 + 1] = l_run;
  }
  consumer_sync();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const long long row = row0 + g + 8 * k;
    if (splits == 1) {
      const float inv = 1.f / fmaxf(red_l[g + 8 * k], 1e-20f);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(out + row * DKV + n0 + 8 * j + 2 * c) =
            make_float2(o[j][2 * k] * inv, o[j][2 * k + 1] * inv);
    } else {
      const long long prow = row * splits + split;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(part_num + prow * DKV + n0 + 8 * j + 2 * c) =
            make_float2(o[j][2 * k], o[j][2 * k + 1]);
    }
  }
}

// one block per (row, head, 128 columns): merge the (num, den, max) states
// of the splits that start inside the row's context (the others wrote
// nothing) and normalise. Each of the 4 warps takes every 4th split, one
// float4 of columns a lane, and the warps' sums meet in shared memory
constexpr int MERGE_WARPS = 4;
constexpr int MERGE_COLS = 128;

__global__ void __launch_bounds__(32 * MERGE_WARPS)
mla_merge_kernel(const float* __restrict__ part_num,
                 const float* __restrict__ part_ml, float* __restrict__ out,
                 const int* __restrict__ total_lens, int nh, int dkv, int P,
                 int ps, int split_pages, int splits) {
  __shared__ float red[MERGE_WARPS];
  __shared__ float4 acc[MERGE_WARPS][32];
  __shared__ float dens[MERGE_WARPS];
  const long long row = blockIdx.x;
  const int ctx = min(total_lens[row / nh], P * ps);
  const int span = split_pages * ps;
  const int live = min(splits, (ctx + span - 1) / span);
  const float* ml = part_ml + row * splits * 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float mx = NEG_INF;
  for (int s = tid; s < live; s += 32 * MERGE_WARPS) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < MERGE_WARPS; ++w) mx = fmaxf(mx, red[w]);
  const int c4 = blockIdx.y * (MERGE_COLS / 4) + lane;  // this lane's float4
  const bool col_ok = c4 < dkv / 4;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
#pragma unroll 4
  for (int s = warp; s < live; s += MERGE_WARPS) {
    const float w = expf(ml[2 * s] - mx);
    if (col_ok) {
      const float4 v =
          reinterpret_cast<const float4*>(part_num + (row * splits + s) * dkv)[c4];
      num.x += w * v.x;
      num.y += w * v.y;
      num.z += w * v.z;
      num.w += w * v.w;
    }
    den += w * ml[2 * s + 1];
  }
  acc[warp][lane] = num;
  if (lane == 0) dens[warp] = den;
  __syncthreads();
  if (warp != 0 || !col_ok) return;
  den = 0.f;
#pragma unroll
  for (int w = 0; w < MERGE_WARPS; ++w) {
    const float4 a = acc[w][lane];
    if (w > 0) {
      num.x += a.x;
      num.y += a.y;
      num.z += a.z;
      num.w += a.w;
    }
    den += dens[w];
  }
  const float inv = 1.f / fmaxf(den, 1e-20f);
  reinterpret_cast<float4*>(out + row * dkv)[c4] =
      make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv);
}

template <int NT>
int launch(const void* q, const void* pages, void* out, void* part_num,
           void* part_ml, const void* table, const void* lens, long long layer,
           int B, int nh, int dr, int N, int ps, int P, int split_pages,
           int splits, cudaStream_t stream) {
  const int dkv = 8 * NT * NWARPS;
  const int kw = dkv + dr;
  if ((kw / 16 + KPARTS - 1) / KPARTS > MAX_KSTEPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cblocks = dkv / BOX_COLS + (dr + BOX_COLS - 1) / BOX_COLS;
  const size_t smem = layout(cblocks).total;
  if (smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static size_t smem_set = 0;  // the largest set so far, per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  // one layer as a 2-D matrix [N * 2 * ps, dkv]: a page's slot is ps rows
  const long long rows = (long long)N * 2 * ps;
  const int box_rows = gcd(ps, KB);
  CUtensorMap map;
  void* layer_base = const_cast<bf16*>(static_cast<const bf16*>(pages) + layer * rows * dkv);
  if (!encode_rows_map(&map, layer_base, rows, dkv, box_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  mla_decode_kernel<NT><<<dim3(B * (nh / HG), splits), THREADS, smem, stream>>>(
      map, static_cast<const bf16*>(q), static_cast<float*>(out),
      static_cast<float*>(part_num), static_cast<float*>(part_ml),
      static_cast<const int*>(table), static_cast<const int*>(lens), nh, dr, ps,
      P, box_rows, split_pages, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  mla_merge_kernel<<<dim3(B * nh, (dkv + MERGE_COLS - 1) / MERGE_COLS),
                     32 * MERGE_WARPS, 0, stream>>>(
      static_cast<const float*>(part_num), static_cast<const float*>(part_ml),
      static_cast<float*>(out), static_cast<const int*>(lens), nh, dkv, P, ps,
      split_pages, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_num [B, nh, splits, dkv] and part_ml [B, nh, splits, 2] f32 are the
// caller's scratch (unused, may be null, when splits == 1). Every split is
// split_pages whole pages and the splits cover the table: split_pages <= 256
// and (splits - 1) * split_pages < P <= splits * split_pages.
extern "C" int mla_decode_launch(const void* q, const void* pages, void* out,
                                 void* part_num, void* part_ml,
                                 const void* page_table,
                                 const void* total_lens, long long layer,
                                 int B, int nh, int dkv, int dr, int N, int ps,
                                 int P, int split_pages, int splits,
                                 void* stream) {
  if (B == 0) return 0;
  if (nh <= 0 || nh % HG || dr < 0 || dr % 16 || dr > dkv || splits < 1 ||
      split_pages < 0 || split_pages > MAX_SPLIT_PAGES ||
      (long long)splits * split_pages < P ||
      (splits > 1 && (part_num == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DYN_CASE(NTV)                                                        \
  case NTV:                                                                  \
    return launch<NTV>(q, pages, out, part_num, part_ml, page_table,        \
                       total_lens, layer, B, nh, dr, N, ps, P, split_pages, \
                       splits, s);
  switch (dkv % 128 == 0 ? dkv / 64 : 0) {
    DYN_CASE(2)
    DYN_CASE(4)
    DYN_CASE(6)
    DYN_CASE(8)
    DYN_CASE(10)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DYN_CASE
}
