// Latent (MLA) chunked-prefill and mixed-step paged attention for Hopper,
// sm_90a: wgmma tiles of 4 query slots x 16 heads, a TMA ring fed by a
// producer warpgroup, two consumer warpgroups holding O in registers, the
// query scaled and rounded in the kernel, and split-KV for decode rows.
//
// mla_prefill_launch replaces dynamo_tpu/ops/pallas/mla_prefill.py
// `mla_paged_prefill_stacked` -> `_mla_paged_prefill` -> `_mla_prefill_kernel`.
// DeepSeek's absorbed multi-head latent attention over the 2-slot latent
// cache pages [L, N, 2, 1, ps, dkv] bf16 (slot 0 the latent c_kv, slot 1 the
// shared roped key k_pe zero-padded to dkv). For query head h of a query at
// position p = positions[b, 0] + s and each kv position t <= p, t < ctx =
// total_lens[b]:
//   s[t]   = q_lat[h] . c_kv[t] + q_pe[h] . k_pe[t][:dr]
//   out[h] = sum_t softmax(s)[t] * c_kv[t]          (the value IS the latent)
// The query is (q * sm_scale) rounded to nearest bf16, as the TPU kernel's
// caller rounds it (mla_prefill.py:201); scores and sums are f32 (online
// softmax), p rounds to bf16 before P.V, and the output is f32
// [B, S, nh, dkv] = acc / max(l, 1e-20). Row b's real queries are its
// first q_len = ctx - positions[b, 0] slots (a decode row inside a mixed
// step has q_len 1); slots past them are pad and come out zero.
//
// What bounds it on the H100: tensor-core operations for prefill chunks
// (2 (dkv + dr) + 2 dkv per (query head, visible position): 0.0858 ms of
// the B=4 S=512 case), HBM bytes for mixed steps, where the f32 output of
// the decode rows' pad slots and the decode rows' contexts dominate. The
// design is the FA3 / FlashMLA shape, sized to this card:
// - work unit: a block takes one (row, head group of 16, tile of TS = 4
//   query slots). Its M = 64 rows are slot r / 16, head r % 16: one wgmma M
//   tile, so every kv chunk in shared memory serves all 64 rows (the first
//   port's WMMA kernel fed 32). nh = 128 repeats the tiling per head group.
//   Block (x, y) takes (row, head group) x and rank y, and blocks dispatch
//   x fastest, so every row's rank 0 starts before any row's rank 1. A
//   row's real tiles go last-first (rank 0 takes its last tile, which sees
//   the most kv), then its pad tiles, which write their zeros and return
//   without loading anything: B3's order (csrc/prefill_sm90.cu). An order
//   of all rows' items by the kv positions each loads (found per block by
//   a bisection over the rows' lengths) shortened the tail of a batch with
//   one long row, but was slower on short chunks and in the DeepSeek serve
//   (PERF.md), so it went.
// - the query is read in the kernel: the real slots' q_lat and q_pe rows
//   (f32 or bf16, as they come; each row contiguous, in any order of rows:
//   the model's q_lat is head-major) are staged in the ring by bulk copies,
//   one a (slot, head) row, before the first kv chunk; the consumers multiply by sm_scale in f32 (round to nearest) and
//   round to nearest bf16, bit-identical to plain.mla_query, into the
//   128-byte-swizzled [64, dkv + dr] layout the wgmma descriptor reads
//   (73,728 bytes at V2-Lite's widths). Pad slots' rows are zeros and their
//   queries are never read. Plain loads of the f32 rows by the consumers
//   were slower.
// - a producer warpgroup (40 registers after setmaxnreg; one warp issues)
//   keeps a ring of kv chunks of KB positions in flight with TMA, over B4's
//   tensor map (csrc/mla_decode.cu): the layer's [N * 2 * ps, dkv] view,
//   128-byte swizzle, boxes of [gcd(ps, KB) rows, 64 columns], dkv / 64
//   c_kv boxes and ceil(dr / 64) k_pe boxes per box of positions. A stage
//   completes on its `full` mbarrier and is freed on its `empty` one. Page
//   ids are read two chunks ahead, one lane per box of positions. Boxes
//   wholly past the block's kv range are not loaded.
// - two consumer warpgroups (232 registers each) share the 64 rows,
//   FlashMLA-style: warpgroup w computes S = Q K^T (wgmma m64nKBk16, A = Q
//   and B = K from shared memory, contracting only the dkv + dr real
//   columns: k_pe's padding is never read) for chunk 2 i + w of each pair
//   of chunks. The two post their chunks' row maxima in shared memory and
//   both take the pair's maximum, so their rescale factors agree; each
//   turns its S into P in registers and posts P (bf16, in the A-operand
//   fragment order: a thread's fragments go to the thread of the same rank
//   in the other warpgroup) in its stage's first k_pe column block, which
//   P.V no longer needs. Then each runs O += P V for both chunks of the
//   pair on its half of the dkv columns (wgmma m64n64k16, P from
//   registers, V read transposed from the stage): [64, dkv / 2] f32, 128
//   registers a thread at dkv = 512. The full [64, 512] O on one warpgroup
//   would need 256 registers a thread, more than a thread may hold. Two
//   barriers of the consumer warpgroups a pair (maxima posted; P posted).
//   dkv > 512 does not fit the registers and is refused
//   (_wrap.MLA_PREFILL_MAX_DKV). A schedule in which the owner of each
//   chunk published P and its max for the other warpgroup (no shared pair
//   max, S of the next chunk issued before the other's P.V) ran slower.
// - shared memory (limit 232,448 B) at V2-Lite's widths: Q 73,728 B plus
//   a ring of 4 stages of KB = 32 positions (147,456 B); P needs no buffer
//   of its own. A ring of 2 stages of 64 positions fits as well and its
//   N = 64 products read Q half as often, but it keeps one pair of chunks
//   in flight, so loading the next pair waits on the whole current one: it
//   was slower at every case timed (PERF.md). The stage count is the most,
//   up to 4, that fits beside Q (3 at dkv 512 with dr 128, 2 with dr 256):
//   _wrap.mla_prefill_stages picks it, from mla_smem_bytes, which mirrors
//   `layout` below.
// - masks apply only on chunks that cross the tile's diagonal or the end of
//   the block's kv range, and as selects; in the chunk that holds the end
//   of the range the warpgroup that computed its S zeroes the V rows past
//   it (a page's stale slots, the next split's rows, an earlier chunk's
//   rows), so p = 0 never meets the NaN of page 0.
// - split-KV for decode rows, B3's way (csrc/prefill_sm90.cu): a row with
//   1 <= q_len <= split_cap (the wrapper's cap is 1) would stream its whole
//   context through one block while its other tiles idle. Instead its rank
//   k takes positions [k * split_span, + split_span) of whole pages and
//   writes f32 (num, den, max) partials of its real (slot, head) rows;
//   `merge_kernel` merges the splits that start inside the context with
//   merge_softmax_partials / normalize_softmax_partials' arithmetic
//   (dynamo_tpu_torch/ops/attention.py). The split blocks write the row's
//   pad zeros. A decode row fills 16 of the 64 M rows: about 121 flop per
//   loaded byte, still under the card's ~295 ridge, so bytes bound it and
//   the idle rows cost nothing. The grid, n_work x (B * nh / 16) with
//   n_work = max(tiles, splits), follows from shapes alone
//   (mla_prefill.mla_prefill_splits); which rows split, and which block
//   takes which item, is decided here. Everything about the launch is
//   graph-safe: no host read of the lengths.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HG = 16;          // query heads per block
constexpr int TS = 4;           // query slots per tile
constexpr int M = HG * TS;      // rows per block: one wgmma M tile
constexpr int CONSUMERS = 2;    // warpgroups sharing the 64 rows
constexpr int CTHREADS = 128 * CONSUMERS;
constexpr int THREADS = CTHREADS + 128;  // + the producer warpgroup
constexpr int KB = 32;                   // kv positions per chunk
constexpr int QBLOCK_BYTES = M * 128;    // [64 rows, 64 columns] bf16, swizzled
constexpr int SMEM_MAX = 232448;         // 227 KB of dynamic shared memory
constexpr int BAR_CONSUMERS = 1;         // named barrier of the 256 consumers
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: Q at 0, the ring, the warpgroups' row maxima and sums, the
// ring's mbarriers and the query's two (staged, ring free again), 1 KB of
// alignment slack (swizzle atoms start on a 1024-byte boundary). The ring
// also stages the query's rows before the first chunk.
// ops/kernels/_wrap.py mla_smem_bytes mirrors `total`.
struct Layout {
  size_t stage, ring, red_m, red_l, bars, total;
};

__host__ __device__ inline Layout layout(int dkv, int dr, int stages) {
  Layout L;
  const int rope = (dr + 63) / 64;
  // a stage's column blocks: at least one k_pe block, which carries P
  // between the warpgroups
  L.stage = (size_t)(dkv / 64 + (rope > 0 ? rope : 1)) * KB * 128;
  L.ring = (size_t)(dkv / 64 + rope) * QBLOCK_BYTES;  // Q's column blocks
  L.red_m = L.ring + (size_t)stages * L.stage;
  L.red_l = L.red_m + CONSUMERS * M * 4;
  L.bars = L.red_l + CONSUMERS * M * 4;
  L.total = L.bars + (size_t)stages * 16 + 24 + 1024;
  return L;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONSUMERS), "n"(CTHREADS) : "memory");
}

// Where the query rows are: element strides of (row b, slot s, head h) in
// q_lat and q_pe, whose rows (dkv, dr values) are contiguous and 16-byte
// aligned; the model's absorbed q_lat is head-major
struct QLayout {
  long long lat[3], pe[3];
};

// 8 consecutive query values (f32 or bf16) at `p` as f32
__device__ __forceinline__ void load8(const void* p, bool f32, float (&f)[8]) {
  if (f32) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// NB: the latent is 128 NB wide (each consumer warpgroup holds NB m64n64
// output tiles)
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
mla_prefill_kernel(const __grid_constant__ CUtensorMap kv_map,
                   const void* __restrict__ q_lat, const void* __restrict__ q_pe,
                   float* __restrict__ out, float* __restrict__ part_num,
                   float* __restrict__ part_ml, const int* __restrict__ page_table,
                   const int* __restrict__ positions,
                   const int* __restrict__ total_lens, int S, int nh, int dr,
                   int ps, int P, int box_rows, int n_tiles, int split_cap,
                   int split_span, int splits, int stages, float sm_scale,
                   int q_lat_f32, int q_pe_f32, const QLayout ql) {
  constexpr int DKV = 128 * NB;
  constexpr int HALF = DKV / 2;          // output columns per consumer warpgroup
  constexpr int CKV_BLOCKS = DKV / 64;
  constexpr int BLOCK_BYTES = KB * 128;  // one column block of a stage
  constexpr int SREGS = KB / 2;          // S accumulator registers a thread
  const int groups = nh / HG;
  const int tid = threadIdx.x;
  const int pair = blockIdx.x;  // (row, head group)
  const int b = pair / groups;
  const int h0 = pair % groups * HG;
  const int rank = blockIdx.y;
  const int ctx = total_lens[b];
  const int q_start = positions[(long long)b * S];
  const int q_len = ctx - q_start;
  const int n_real = max(0, min(q_len, S));  // real query slots
  const int kv_end = min(ctx, P * ps);

  // zeros for the slots of tile t0 from slot `from` on (pad slots), no kv
  // traffic
  auto zero_tile = [&](int t0, int from) {
    for (int idx = tid; idx < M * (DKV / 4); idx += THREADS) {
      const int r = idx / (DKV / 4), c4 = idx % (DKV / 4);
      const int s = t0 + r / HG;
      if (s < S && s >= from)
        reinterpret_cast<float4*>(
            out + (((long long)b * S + s) * nh + h0 + r % HG) * DKV)[c4] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // A short row (1 <= q_len <= split_cap: decode rows) has all its queries
  // in tile 0 and spreads its kv range over `splits` blocks: block `rank`
  // takes positions [rank * split_span, + split_span), writes f32 partials
  // and, for rank < n_tiles, the zeros of tile `rank`'s pad slots; the
  // merge kernel writes tile 0's real rows. A long row's blocks are its
  // query tiles, the real ones last-first, then its pad tiles.
  const bool split_row = q_len >= 1 && q_len <= split_cap;
  int tile = 0, kv_lo = 0, kv_hi = kv_end;
  if (split_row) {
    if (rank < n_tiles) zero_tile(rank * TS, q_len);
    kv_lo = rank * split_span;
    // a split at or past the context: the merge does not read it
    if (rank >= splits || kv_lo >= kv_end) return;
    kv_hi = min(kv_end, kv_lo + split_span);
  } else {
    if (rank >= n_tiles) return;
    const int real_tiles = (n_real + TS - 1) / TS;
    tile = rank < real_tiles ? real_tiles - 1 - rank : rank;
    if (tile * TS >= n_real) {
      zero_tile(tile * TS, 0);
      return;
    }
  }
  const int tile0 = tile * TS;
  const int last_slot = min(tile0 + TS, n_real) - 1;
  // the block's kv range: [kv_lo, kv_stop); its last query sees kv_stop - 1
  const int kv_stop = min(kv_hi, q_start + last_slot + 1);
  // chunks start KB apart from kv_lo, a page boundary, so every TMA box
  // (box_rows | ps and box_rows | KB) lies inside one page
  const int n_chunks = kv_stop > kv_lo ? (kv_stop - kv_lo + KB - 1) / KB : 0;

  extern __shared__ unsigned char smem_raw[];
  const Layout lo = layout(DKV, dr, stages);
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t ring = base + (uint32_t)lo.ring;
  float* red_m = reinterpret_cast<float*>(gbase + lo.red_m);  // [CONSUMERS][M]
  float* red_l = reinterpret_cast<float*>(gbase + lo.red_l);  // [CONSUMERS][M]
  const uint32_t bars = base + (uint32_t)lo.bars;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (stages + st)
  const uint32_t empty0 = bars + 8 * stages;
  // the query's rows staged in the ring (q_full), a round of them converted
  // (q_free), all of them converted: the ring is the kv chunks' (q_done)
  const uint32_t q_full = bars + 16 * stages, q_free = q_full + 8, q_done = q_free + 8;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CTHREADS / 32);
    }
    mbar_init(q_full, 1);
    mbar_init(q_free, CTHREADS / 32);
    mbar_init(q_done, CTHREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The query tile's real slots, f32 or bf16 as they come: per slot, the 16
  // heads' q_lat rows then q_pe rows are staged in the ring by bulk copies,
  // as many slots a round as fit (all 4 at V2-Lite's widths), and converted
  // by the consumers
  const int n_slots = last_slot - tile0 + 1;
  const int lat_bytes = HG * DKV * (q_lat_f32 ? 4 : 2);
  const int pe_bytes = HG * dr * (q_pe_f32 ? 4 : 2);
  const int per_round = min(n_slots, (int)((size_t)stages * lo.stage) / (lat_bytes + pe_bytes));
  const int q_rounds = (n_slots + per_round - 1) / per_round;

  if (tid >= CTHREADS) {
    // ---- producer warpgroup: one warp issues the TMA boxes ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= CTHREADS + 32) return;
    const int lane = tid & 31;
    mbar_wait(q_done, 0);  // the query is in
    const int boxes = KB / box_rows;               // boxes of positions a chunk
    const int loaded = CKV_BLOCKS + (dr + 63) / 64;  // column blocks a box row fills
    const int* table = page_table + (long long)b * P;
    // lane x < boxes holds the page of box x of a chunk, read two chunks
    // ahead so the table's latency hides behind the ring
    auto page_of = [&](int i) {
      const int pos = kv_lo + i * KB + lane * box_rows;
      return i < n_chunks && lane < boxes && pos < kv_stop ? table[pos / ps] : 0;
    };
    int page_cur = page_of(0), page_nx1 = page_of(1);
    for (int i = 0; i < n_chunks; ++i) {
      const int page_nx2 = page_of(i + 2);
      const int st = i % stages;
      const uint32_t use = (uint32_t)(i / stages);
      if (i >= stages) mbar_wait(empty0 + 8 * st, (use & 1u) ^ 1u);
      const int pos0 = kv_lo + i * KB;
      const int live = min(boxes, (kv_stop - pos0 + box_rows - 1) / box_rows);
      const uint32_t full = bars + 8 * st;
      if (lane == 0) mbar_expect_tx(full, live * loaded * box_rows * 128);
      __syncwarp();
      const uint32_t stage = ring + st * (uint32_t)lo.stage;
      for (int op0 = 0; op0 < live * loaded; op0 += 32) {
        const int op = op0 + lane;
        const int x = min(op / loaded, 31);
        const int page = __shfl_sync(0xffffffffu, page_cur, x);
        if (op < live * loaded) {
          const int cb = op % loaded;
          const int slot = cb < CKV_BLOCKS ? 0 : 1;
          const int row = (page * 2 + slot) * ps + (pos0 + x * box_rows) % ps;
          const int col = (cb < CKV_BLOCKS ? cb : cb - CKV_BLOCKS) * 64;
          tma_load(stage + cb * BLOCK_BYTES + x * box_rows * 128, &kv_map, full,
                   col, row);
        }
      }
      page_cur = page_nx1;
      page_nx1 = page_nx2;
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid & 31;
  const int g4 = lane / 4, c4 = lane % 4;

  // Q: (q * sm_scale) rounded to bf16, row r = slot r / 16, head r % 16;
  // 16-byte chunk j of row r of column block k at
  // k * QBLOCK_BYTES + r * 128 + ((j ^ (r % 8)) * 16); pad slots' rows zero
  {
    const int kw8 = (DKV + dr) / 8;
    auto put = [&](int r, int c8, uint4 v) {
      *reinterpret_cast<uint4*>(gbase + (c8 / 8) * QBLOCK_BYTES + r * 128 +
                                (((c8 % 8) ^ (r & 7)) << 4)) = v;
    };
    for (int k = 0; k < q_rounds; ++k) {
      if (tid < 32) {
        // round k's bulk copies, one (slot, head) row each, once every warp
        // is done with round k - 1
        if (k > 0) mbar_wait(q_free, (uint32_t)(k - 1) & 1u);
        const int s0 = k * per_round, s1 = min(n_slots, s0 + per_round);
        if (lane == 0) mbar_expect_tx(q_full, (s1 - s0) * (lat_bytes + pe_bytes));
        __syncwarp();
        const int lat_esz = q_lat_f32 ? 4 : 2, pe_esz = q_pe_f32 ? 4 : 2;
        for (int idx = lane; idx < (s1 - s0) * HG; idx += 32) {
          const int h = idx % HG;
          const long long sl = tile0 + s0 + idx / HG;
          const uint32_t dst = ring + (idx / HG) * (lat_bytes + pe_bytes);
          bulk_load(dst + h * DKV * lat_esz,
                    static_cast<const char*>(q_lat) +
                        (b * ql.lat[0] + sl * ql.lat[1] + (h0 + h) * ql.lat[2]) * lat_esz,
                    DKV * lat_esz, q_full);
          if (dr > 0)
            bulk_load(dst + lat_bytes + h * dr * pe_esz,
                      static_cast<const char*>(q_pe) +
                          (b * ql.pe[0] + sl * ql.pe[1] + (h0 + h) * ql.pe[2]) * pe_esz,
                      dr * pe_esz, q_full);
        }
      }
      mbar_wait(q_full, (uint32_t)k & 1u);
      const int s0 = k * per_round, ns = min(n_slots, s0 + per_round) - s0;
      for (int idx = tid; idx < ns * HG * kw8; idx += CTHREADS) {
        const int rr = idx / kw8, c8 = idx % kw8;  // row s0 * HG + rr
        const unsigned char* rec = gbase + lo.ring + (rr / HG) * (lat_bytes + pe_bytes);
        const int h = rr % HG;
        float f[8];
        if (c8 * 8 < DKV)
          load8(rec + (h * DKV + c8 * 8) * (q_lat_f32 ? 4 : 2), q_lat_f32, f);
        else
          load8(rec + lat_bytes + (h * dr + c8 * 8 - DKV) * (q_pe_f32 ? 4 : 2), q_pe_f32, f);
        uint4 v;
        v.x = pack_bf16(__fmul_rn(f[0], sm_scale), __fmul_rn(f[1], sm_scale));
        v.y = pack_bf16(__fmul_rn(f[2], sm_scale), __fmul_rn(f[3], sm_scale));
        v.z = pack_bf16(__fmul_rn(f[4], sm_scale), __fmul_rn(f[5], sm_scale));
        v.w = pack_bf16(__fmul_rn(f[6], sm_scale), __fmul_rn(f[7], sm_scale));
        put(s0 * HG + rr, c8, v);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(k + 1 < q_rounds ? q_free : q_done);
    }
    for (int idx = n_slots * HG * kw8 + tid; idx < M * kw8; idx += CTHREADS)
      put(idx / kw8, idx % kw8, make_uint4(0, 0, 0, 0));
    fence_async_smem();
    consumer_sync();
  }

  const int ksteps = (DKV + dr) / 16;
  // this warp's 16 rows are one query slot
  const int qpos = q_start + tile0 + warp;
  const int tile_lo = q_start + tile0;  // the tile's first query position
  float o[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[n][j] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of its rows' sums
  // the P exchange area of a stage: its first k_pe column block, a 16-byte
  // fragment group per (k-step, thread rank)
  auto xchg = [&](int st) {
    return reinterpret_cast<uint4*>(gbase + lo.ring + st * lo.stage +
                                    CKV_BLOCKS * BLOCK_BYTES) + wtid;
  };

  const int n_pairs = (n_chunks + 1) / 2;
  for (int pr = 0; pr < n_pairs; ++pr) {
    const int mine = 2 * pr + wg, other = 2 * pr + 1 - wg;
    const bool have_mine = mine < n_chunks, have_other = other < n_chunks;
    const int st_mine = mine % stages, st_other = other % stages;
    float s[SREGS];
#pragma unroll
    for (int j = 0; j < SREGS; ++j) s[j] = 0.f;
    float mx[2] = {NEG_INF, NEG_INF};
    if (have_mine) {
      mbar_wait(bars + 8 * st_mine, (uint32_t)(mine / stages) & 1u);
      const uint32_t stage = ring + st_mine * (uint32_t)lo.stage;
      const int kc = kv_lo + mine * KB;
      wg_fence();
      // 16 columns a step: the latent's steps unrolled, then the rope's
      auto s_step = [&](int ks) {
        const uint32_t off = (uint32_t)((ks & 3) * 32);
        const uint64_t da = smem_desc(base + (ks >> 2) * QBLOCK_BYTES + off);
        const uint64_t db = smem_desc(stage + (ks >> 2) * BLOCK_BYTES + off);
        wgmma_64x32_ss(s, da, db);
      };
#pragma unroll
      for (int ks = 0; ks < DKV / 16; ++ks) s_step(ks);
      for (int ks = DKV / 16; ks < ksteps; ++ks) s_step(ks);
      wg_commit();
      wg_wait0();
      if (kc + KB > kv_stop) {
        // V rows past the block's kv range -> zeros (their scores are
        // selected away below, whatever they read)
        const int live = kv_stop - kc;
        unsigned char* vst = gbase + lo.ring + st_mine * lo.stage;
        for (int idx = wtid; idx < (KB - live) * CKV_BLOCKS * 8; idx += 128) {
          const int t = live + idx / (CKV_BLOCKS * 8);
          const int cb = idx / 8 % CKV_BLOCKS;
          *reinterpret_cast<uint4*>(vst + cb * BLOCK_BYTES + t * 128 + (idx % 8) * 16) =
              make_uint4(0, 0, 0, 0);
        }
        fence_async_smem();
      }
      if (kc + KB > kv_stop || kc + KB - 1 > tile_lo) {
#pragma unroll
        for (int j = 0; j < SREGS; ++j) {
          const int t = kc + 8 * (j >> 2) + 2 * c4 + (j & 1);
          if (!(t <= qpos && t < kv_stop)) s[j] = NEG_INF;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int j = 0; j < KB / 8; ++j)
          mx[k] = fmaxf(mx[k], fmaxf(s[4 * j + 2 * k], s[4 * j + 2 * k + 1]));
        mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], 1));
        mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], 2));
      }
    }
    // the chunks' row maxima meet; both warpgroups take the pair's
    const int r0 = 16 * warp + g4;
    if (c4 == 0) {
      red_m[wg * M + r0] = mx[0];
      red_m[wg * M + r0 + 8] = mx[1];
    }
    consumer_sync();
    float scale[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float m_new =
          fmaxf(m_run[k], fmaxf(red_m[r0 + 8 * k], red_m[M + r0 + 8 * k]));
      // a row with nothing visible yet keeps m = -1e30 and takes m log2e =
      // 0, so its masked p are 2^-1.4e30 = 0
      const float ml = m_new > NEG_INF * 0.5f ? m_new * LOG2E : 0.f;
      scale[k] = ex2(m_run[k] * LOG2E - ml);
      m_run[k] = m_new;
      float rs = 0.f;
      if (have_mine) {
#pragma unroll
        for (int j = 0; j < KB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * j + 2 * k + e], LOG2E, -ml));
            s[4 * j + 2 * k + e] = p;
            rs += p;
          }
      }
      l_run[k] = l_run[k] * scale[k] + rs;
    }
    // P (bf16) as the A operand: S's fragment of columns 16 kk .. + 15;
    // posted for the thread of the same rank in the other warpgroup
    uint32_t pa[KB / 16][4];
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    if (have_mine) {
      uint4* x = xchg(st_mine);
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        x[kk * 128] = make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
      fence_async_smem();
    }
    consumer_sync();  // P posted, dead V rows zeroed

    // the other chunk's P, from the thread of the same rank
    uint32_t po[KB / 16][4];
    if (have_other) {
      mbar_wait(bars + 8 * st_other, (uint32_t)(other / stages) & 1u);
      const uint4* x = xchg(st_other);
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        const uint4 v = x[kk * 128];
        po[kk][0] = v.x;
        po[kk][1] = v.y;
        po[kk][2] = v.z;
        po[kk][3] = v.w;
      }
    }
    if (__any_sync(0xffffffffu, scale[0] != 1.f || scale[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[n][j] *= scale[(j >> 1) & 1];
    }
    // O += P V over the pair's chunks, this warpgroup's columns
    wg_fence();
    if (have_mine) {
      const uint32_t v0 = ring + st_mine * (uint32_t)lo.stage + wg * NB * BLOCK_BYTES;
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          wgmma_64x64<1>(o[n], pa[kk], smem_desc(v0 + n * BLOCK_BYTES + kk * 16 * 128));
    }
    if (have_other) {
      const uint32_t v0 = ring + st_other * (uint32_t)lo.stage + wg * NB * BLOCK_BYTES;
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          wgmma_64x64<1>(o[n], po[kk], smem_desc(v0 + n * BLOCK_BYTES + kk * 16 * 128));
    }
    wg_commit();
    wg_wait0();
    __syncwarp();
    if (lane == 0) {  // the pair's stages free
      mbar_arrive(empty0 + 8 * ((2 * pr) % stages));
      if (2 * pr + 1 < n_chunks) mbar_arrive(empty0 + 8 * ((2 * pr + 1) % stages));
    }
  }

  // the rows' sums: each warpgroup's share, then both
  const int r0 = 16 * warp + g4;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    l_run[k] += __shfl_xor_sync(0xffffffffu, l_run[k], 1);
    l_run[k] += __shfl_xor_sync(0xffffffffu, l_run[k], 2);
    if (c4 == 0) red_l[wg * M + r0 + 8 * k] = l_run[k];
  }
  consumer_sync();
  const int slot = tile0 + warp;
  const bool real = slot <= last_slot;
  const int col0 = wg * HALF + 2 * c4;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int head = g4 + 8 * k;
    const float l = red_l[r0 + 8 * k] + red_l[M + r0 + 8 * k];
    if (split_row) {
      // num = O, den = the row sum, max = m
      if (!real) continue;
      const long long prow =
          ((long long)pair * splits + rank) * (split_cap * HG) + warp * HG + head;
      float* dst = part_num + prow * DKV + col0;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + 64 * n + 8 * j) =
              make_float2(o[n][4 * j + 2 * k], o[n][4 * j + 2 * k + 1]);
      if (wg == 0 && c4 == 0) {
        part_ml[prow * 2] = m_run[k];
        part_ml[prow * 2 + 1] = l;
      }
      continue;
    }
    if (slot >= S) continue;
    const float den = fmaxf(l, 1e-20f);
    float* dst = out + (((long long)b * S + slot) * nh + h0 + head) * DKV + col0;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 64 * n + 8 * j) =
            real ? make_float2(o[n][4 * j + 2 * k] / den, o[n][4 * j + 2 * k + 1] / den)
                 : make_float2(0.f, 0.f);
  }
}

// One block per (row, head group, partial row r, 128 columns): a split
// row's real (slot, head) row r merges the (num, den, max) partials of the
// splits that start inside its context (the others wrote nothing) and
// normalises. Each of the 4 warps takes every 4th split, one float4 of
// columns a lane, and the warps' sums meet in shared memory. Other blocks
// return.
constexpr int MERGE_WARPS = 4;
constexpr int MERGE_COLS = 128;

__global__ void __launch_bounds__(32 * MERGE_WARPS)
merge_kernel(const float* __restrict__ part_num, const float* __restrict__ part_ml,
             float* __restrict__ out, const int* __restrict__ positions,
             const int* __restrict__ total_lens, int S, int nh, int dkv, int P,
             int ps, int split_cap, int split_span, int splits) {
  __shared__ float red[MERGE_WARPS];
  __shared__ float4 acc[MERGE_WARPS][32];
  __shared__ float dens[MERGE_WARPS];
  const int rows = split_cap * HG;  // partial rows per split
  const long long bg = blockIdx.x / rows;  // (row, head group)
  const int r = blockIdx.x % rows;
  const int groups = nh / HG;
  const int b = (int)(bg / groups), hg = (int)(bg % groups);
  const int ctx = total_lens[b];
  const int q_len = ctx - positions[(long long)b * S];
  if (!(q_len >= 1 && q_len <= split_cap) || r >= min(q_len, S) * HG) return;
  const int kv_end = min(ctx, P * ps);
  const int live = min(splits, (kv_end + split_span - 1) / split_span);
  const long long prow0 = bg * splits * rows + r;  // split s: + s * rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float mx = NEG_INF;
  for (int s = tid; s < live; s += 32 * MERGE_WARPS)
    mx = fmaxf(mx, part_ml[(prow0 + (long long)s * rows) * 2]);
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
    const long long prow = prow0 + (long long)s * rows;
    const float ms = part_ml[prow * 2];
    // a split that saw nothing of this row (max -1e30) weighs nothing
    const float w = ms > NEG_INF * 0.5f ? expf(ms - mx) : 0.f;
    if (col_ok && w > 0.f) {
      const float4 v = reinterpret_cast<const float4*>(part_num + prow * dkv)[c4];
      num.x += w * v.x;
      num.y += w * v.y;
      num.z += w * v.z;
      num.w += w * v.w;
    }
    den += w * part_ml[prow * 2 + 1];
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
  const float d = fmaxf(den, 1e-20f);
  reinterpret_cast<float4*>(out + (((long long)b * S + r / HG) * nh + hg * HG + r % HG) *
                                      dkv)[c4] =
      make_float4(num.x / d, num.y / d, num.z / d, num.w / d);
}

template <int NB>
int launch(const void* q_lat, const void* q_pe, const void* pages, void* out,
           void* part_num, void* part_ml, const void* table, const void* positions,
           const void* lens, long long layer, int B, int S, int nh, int dr, int N,
           int ps, int P, float sm_scale, int q_lat_f32, int q_pe_f32, const QLayout& ql,
           int stages,
           int split_cap, int split_pages, int splits, int n_work,
           cudaStream_t stream) {
  const int dkv = 128 * NB;
  const int n_tiles = (S + TS - 1) / TS;
  const Layout lo = layout(dkv, dr, stages);
  if (lo.total > (size_t)SMEM_MAX || n_work < n_tiles || n_work < splits)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t smem_set = 0;  // the largest set so far, per instantiation
  if (lo.total > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_prefill_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lo.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = lo.total;
  }
  // one layer as a 2-D matrix [N * 2 * ps, dkv]: a page's slot is ps rows
  const long long rows = (long long)N * 2 * ps;
  const int box_rows = gcd(ps, KB);
  CUtensorMap map;
  void* layer_base = const_cast<bf16*>(static_cast<const bf16*>(pages) + layer * rows * dkv);
  if (!encode_rows_map(&map, layer_base, rows, dkv, box_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = nh / HG;
  const int span = split_pages * ps;
  mla_prefill_kernel<NB><<<dim3(B * groups, n_work), THREADS, lo.total, stream>>>(
      map, q_lat, q_pe, static_cast<float*>(out), static_cast<float*>(part_num),
      static_cast<float*>(part_ml), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<const int*>(lens), S, nh, dr,
      ps, P, box_rows, n_tiles, split_cap, span, splits, stages, sm_scale,
      q_lat_f32, q_pe_f32, ql);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<<<dim3(B * groups * split_cap * HG, (dkv + MERGE_COLS - 1) / MERGE_COLS),
                 32 * MERGE_WARPS, 0, stream>>>(
      static_cast<const float*>(part_num), static_cast<const float*>(part_ml),
      static_cast<float*>(out), static_cast<const int*>(positions),
      static_cast<const int*>(lens), S, nh, dkv, P, ps, split_cap, span, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat [B, S, nh, dkv] (f32 when q_lat_f32, else bf16) and q_pe [B, S, nh,
// dr] (f32 when q_pe_f32, else bf16), unscaled, with element strides
// (lat_sb, lat_ss, lat_sh) and (pe_sb, pe_ss, pe_sh) of their first three
// dimensions, rows contiguous and 16-byte aligned; out f32 [B, S, nh, dkv].
// stages: the ring's depth (2-4, as fits). The grid is (B * nh / 16) x
// n_work blocks, n_work >= ceil(S / 4) and >= splits; part_num [B, nh / 16,
// splits, split_cap * 16, dkv] and part_ml [.., 2] f32 are the caller's
// scratch; every split is split_pages whole pages and the splits cover the
// table ((splits - 1) * split_pages < P <= splits * split_pages).
extern "C" int mla_prefill_launch(const void* q_lat, const void* q_pe,
                                  const void* pages, void* out, void* part_num,
                                  void* part_ml, const void* page_table,
                                  const void* positions, const void* total_lens,
                                  long long layer, int B, int S, int nh, int dkv,
                                  int dr, int N, int ps, int P, float sm_scale,
                                  int q_lat_f32, int q_pe_f32, long long lat_sb,
                                  long long lat_ss, long long lat_sh, long long pe_sb,
                                  long long pe_ss, long long pe_sh, int stages,
                                  int split_cap, int split_pages, int splits,
                                  int n_work, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (nh <= 0 || nh % HG || dr < 0 || dr % 16 || dr > dkv || ps <= 0 || ps % 8 ||
      P < 1 || stages < 2 || split_cap < 1 || split_cap > TS || splits < 1 ||
      split_pages < 1 || (long long)splits * split_pages < P ||
      (long long)(splits - 1) * split_pages >= P || part_num == nullptr ||
      part_ml == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QLayout ql = {{lat_sb, lat_ss, lat_sh}, {pe_sb, pe_ss, pe_sh}};
#define DYN_CASE(NBV)                                                              \
  if (dkv == 128 * NBV)                                                            \
    return launch<NBV>(q_lat, q_pe, pages, out, part_num, part_ml, page_table,      \
                       positions, total_lens, layer, B, S, nh, dr, N, ps, P,       \
                       sm_scale, q_lat_f32, q_pe_f32, ql, stages, split_cap,       \
                       split_pages, splits, n_work, s);
  DYN_CASE(1)
  DYN_CASE(2)
  DYN_CASE(3)
  DYN_CASE(4)
#undef DYN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
