// Chunked-prefill and ragged mixed-step paged attention for Hopper, sm_90a:
// TMA + wgmma, with the score and output accumulators in registers.
//
// One kernel serves two TPU kernels, each with its own C entry:
// - paged_prefill_launch (B2) replaces dynamo_tpu/ops/pallas/prefill.py
//   `paged_prefill_attention_stacked` -> `_paged_prefill` -> `_prefill_kernel`;
// - ragged_mixed_launch (B3) replaces dynamo_tpu/ops/pallas/ragged.py
//   `ragged_mixed_attention_stacked` -> `_ragged_mixed` -> `_ragged_kernel`.
// Both compute causal flash attention of S query slots per row, which sit
// at positions q_start = positions[b, 0] .. onward, against the row's paged
// context: the query at position p sees kv positions t <= p, t < ctx =
// total_lens[b] and, with a window w > 0, t > p - w; optional softcap
// cap*tanh(s/cap) before the mask; f32 online softmax; q scaled by sm_scale
// and rounded to bf16 first; p rounded to bf16 before P.V. A prefix-cache
// hit (q_start > 0) falls out: the queries attend to whatever the page table
// already holds. Row b's real queries are its first q_len = ctx - q_start
// slots (a decode row in a mixed step has q_len = 1); slots past them are
// pad and come out as zeros; a query tile wholly past them writes its zeros
// and returns without touching the cache.
//
// Cache layout: pages [L, N, 2, Hkv, ps, Dh] bf16 with Dh 64, 128 or 256 (one
// instantiation each), page 0 the garbage page; page_table [B, P] int32. One
// layer of it is a 2-D matrix [N * 2 * Hkv * ps, Dh] in which a kv head's
// [ps, Dh] tile of one page is contiguous. The query group G = Hq / Hkv
// (1 .. 16) is a run-time argument: it only moves index arithmetic.
//
// What bounds it on the H100: tensor-core operations for prefill chunks of
// S = 512 (4 * Dh per query head and visible kv position) against ~2 bytes
// per kv element; HBM bytes at the mixed shape, whose decode rows carry most
// of the kv reads (each reads its whole context for one query slot). So the
// design is the FA3 shape, plus split-KV for short rows:
// - a block takes one (row, kv head, tile of 128 query rows); a row is one
//   (query slot, head) of the kv head's G heads (BQ = 128 / G slots: 8 at
//   G = 16, 10 at G = 12, whose last 8 rows idle), so every K/V chunk in
//   shared memory serves all G heads;
// - one producer warp keeps a ring of STAGES chunks of KB = 64 positions in
//   flight with TMA: one tensor map over the layer's 2-D view with 128-byte
//   swizzle, boxes of [gcd(ps, 64) rows, 64 dims], Dh / 64 column blocks of
//   K and as many of V a page, each stage completing on its `full`
//   mbarrier; the consumers free a stage on its `empty` mbarrier. Page ids
//   are read two chunks ahead. Boxes wholly past the block's kv range are
//   loaded from past the end of the map, which TMA fills with zeros;
// - two consumer warpgroups of 64 rows each run `wgmma` m64n64k16: S = Q K^T
//   with Q loaded, scaled and rounded once into shared memory (128-byte
//   swizzled, before the ring: Dh * 256 bytes for the block's 128 rows)
//   and K^T from the swizzled stage, both descriptor operands, then
//   softmax on the S fragments in registers, then O += P V with P
//   converted in registers to the bf16 A operand and V read transposed from
//   the stage. S and O never leave registers; nothing waits on
//   __syncthreads between softmax and P.V; the warpgroups take turns to
//   issue S (ping-pong). At Dh = 256 the accumulator O alone takes 128
//   registers a thread, so the ring takes 2 stages of 64 KB beside Q's 64
//   KB, and the producer becomes a warpgroup that gives its registers to
//   the consumers (setmaxnreg 24 / 240). Q is not a register A operand:
//   one that lives across the chunk loop is miscompiled by ptxas (CUDA
//   12.9), which gives its registers to the loop's temporaries at Dh = 64
//   although the PTX reads them in every chunk (a wrong S from the second
//   chunk on; chip_qpath.py builds that variant and counts the SASS
//   writes). P, which is made anew in each chunk, is a register operand.
//   The softmax step stays 64 positions at every Dh, so p rounds to bf16
//   against the same running maxima (plain.online_attention_rows);
// - only chunks that cross a tile's diagonal, the window edge or the end of
//   the block's kv range are masked (a select: masked scores never multiply
//   NaN); in the chunk that holds the end of the range the consumers zero
//   the V rows past it (a page's stale slots, or the next split's rows), so
//   p = 0 never meets a NaN;
// - split-KV for short rows (ragged entry only): a row of 1 .. split_cap
//   real queries would stream its whole context through one block per kv
//   head while its other tiles idle. Instead its blocks take `splits`
//   ranges of split_pages whole pages each (positions [rank * span,
//   + span)); each writes f32 (num, den, max) partials for the row's real
//   (slot, head) rows, and `merge_kernel` merges them with
//   merge_softmax_partials / normalize_softmax_partials' arithmetic
//   (dynamo_tpu/ops/attention.py) into the row's real slots; the split
//   blocks write its pad slots' zeros. A split with no visible position
//   writes a dead partial (max -1e30) that the merge skips. Which rows
//   split is decided on the device from q_len; the grid, n_work x (B * Hkv)
//   with n_work = max(tiles, splits), follows from shapes alone
//   (ragged.ragged_splits), so a short row's idle tiles become its splits.
//   The wrapper's cap is 1: the engine's short rows are its decode rows,
//   and the f32 scratch [B, Hkv, splits, cap * G, Dh] grows with the cap
//   (about 3 MB at B = 32, S = 512, Hq = 24, Hkv = 8 with cap 1) for rows a
//   larger cap would add once per prompt at most;
// - block rank 0 of every (row, kv head) dispatches first, then rank 1 and
//   so on: a long row's tiles go last-first (the last sees the most kv; in
//   the ragged entry, its real tiles before its pad tiles); a short row's
//   ranks are its splits.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KB = 64;                         // kv positions per stage
constexpr int CONSUMERS = 2;                   // warpgroups of 64 query rows
constexpr int ROWS = 64 * CONSUMERS;           // query rows per block
constexpr int CTHREADS = 128 * CONSUMERS;      // consumer threads
constexpr int HALF_BYTES = KB * 128;           // [KB, 64] bf16: one swizzled column block
constexpr int QBLOCK_BYTES = 64 * 128;         // [64 rows, 64] bf16 of a warpgroup's Q
constexpr int MAX_G = 16;                      // query heads per kv head
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// the plan of head dim DH: NB column blocks of 64 dims for K and for V a
// stage, Q in shared memory before the ring; at 256 the producer is a
// warpgroup whose registers (setmaxnreg: 24) go to the consumers'
// accumulators (240), one warp of it issuing, else it is one warp
template <int DH>
struct Geo {
  static constexpr int NB = DH / 64;
  static constexpr bool WIDE = DH > 128;
  static constexpr int THREADS = CTHREADS + (WIDE ? 128 : 32);
  static constexpr int Q_BYTES = ROWS * DH * 2;
  static constexpr int STAGE_BYTES = 2 * NB * HALF_BYTES;
  static constexpr int STAGES = WIDE ? 2 : 4;
  static constexpr int SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(DH % 64 == 0 && SMEM_BYTES <= 232448, "fits the SM");
};

// named barriers among the 256 consumer threads (0 is __syncthreads)
constexpr int BAR_ZERO = 1;  // both warpgroups: stale V rows zeroed
constexpr int BAR_TURN = 2;  // + warpgroup: its turn to issue S = Q K^T
constexpr int BAR_Q = 4;     // + warpgroup: its Q rows staged (128 threads)

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * CONSUMERS) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// SPLIT: the ragged entry's instantiation, with the split-KV path for short
// rows; the paged prefill entry's has none of that code
template <int DH, bool SPLIT>
__global__ void __launch_bounds__(Geo<DH>::THREADS, 1)
prefill_kernel(const __grid_constant__ CUtensorMap kv_map,
               const bf16* __restrict__ q, bf16* __restrict__ out,
               float* __restrict__ part_num, float* __restrict__ part_ml,
               const int* __restrict__ page_table,
               const int* __restrict__ positions,
               const int* __restrict__ total_lens, int S, int Hkv, int G,
               int ps, int P, int box_rows, int oob_row, int n_tiles,
               int split_cap, int split_span, int splits, float sm_scale,
               int window, float softcap) {
  using Gm = Geo<DH>;
  constexpr int THREADS = Gm::THREADS;
  constexpr int NB = Gm::NB;
  constexpr int STAGES = Gm::STAGES;
  constexpr int STAGE_BYTES = Gm::STAGE_BYTES;
  const int BQ = ROWS / G;    // query slots per block
  const int LIVE = BQ * G;    // rows holding a (slot, head); the rest idle
  const int Hq = Hkv * G;
  // blocks dispatch in x-fastest order: every pair's rank 0 first
  const int rank = (int)blockIdx.y;
  const int b = (int)blockIdx.x / Hkv;
  const int h = (int)blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int ctx = total_lens[b];
  const int q_start = positions[(long long)b * S];
  const int q_len = ctx - q_start;
  const int kv_end = min(ctx, P * ps);

  // zeros for the slots of tile t0 from slot `from` on (pad slots), no kv
  // traffic
  auto zero_tile = [&](int t0, int from) {
    for (int idx = tid; idx < LIVE * (DH / 8); idx += THREADS) {
      const int r = idx / (DH / 8), c8 = idx % (DH / 8);
      const int s = t0 + r / G;
      if (s < S && s >= from)
        *reinterpret_cast<uint4*>(
            out + (((long long)b * S + s) * Hq + h * G + r % G) * DH + c8 * 8) =
            make_uint4(0, 0, 0, 0);
    }
  };
  // A short row (q_len <= split_cap: decode rows) has all its queries in
  // tile 0 and spreads its kv range over `splits` blocks: block `rank`
  // takes positions [rank * split_span, + split_span), writes f32 partials
  // and, for rank < n_tiles, the zeros of tile `rank`'s pad slots;
  // merge_kernel writes tile 0's real rows. A long row's blocks are its
  // query tiles, last first (the last sees the most kv); in the ragged
  // entry its real tiles go before its pad tiles.
  const bool split_row = SPLIT && q_len >= 1 && q_len <= split_cap;
  int tile = 0, kv_lo = 0, kv_hi = kv_end;
  if (split_row) {
    if (rank < n_tiles) zero_tile(rank * BQ, q_len);
    if (rank >= splits) return;
    kv_lo = rank * split_span;
    kv_hi = min(kv_end, kv_lo + split_span);
  } else {
    if (rank >= n_tiles) return;
    if (SPLIT) {
      const int n_real = q_len > 0 ? min((q_len + BQ - 1) / BQ, n_tiles) : 0;
      tile = rank < n_real ? n_real - 1 - rank : rank;
    } else {
      tile = n_tiles - 1 - rank;  // the last tiles see the most kv
    }
    if (tile * BQ >= q_len) {
      zero_tile(tile * BQ, 0);
      return;
    }
  }
  const int tile0 = tile * BQ;
  const int last_slot = min(min(tile0 + BQ, S), q_len) - 1;
  const int visible = min(kv_hi, q_start + last_slot + 1);
  const int first = window > 0 ? max(q_start + tile0 - window + 1, 0) : 0;
  const int lo = max(first, kv_lo);
  // chunks start KB apart from kv_lo, a page boundary, so every TMA box
  // (box_rows | ps and box_rows | KB) lies inside one page
  const int kbase = kv_lo + (lo - kv_lo) / KB * KB;
  const int n_chunks = lo < visible ? (visible - kbase + KB - 1) / KB : 0;
  // first partial row of this (row, kv head, split): [split_cap * G]
  // (slot, head) rows; recomputed where used, so it holds no register
  // through the chunk loop
  auto part_row0 = [&]() {
    return (((long long)blockIdx.x) * splits + blockIdx.y) * (split_cap * G);
  };
  if (split_row && n_chunks == 0) {
    // no visible position in this split: a dead partial the merge skips
    for (int r = tid; r < q_len * G; r += THREADS) {
      part_ml[(part_row0() + r) * 2] = NEG_INF;
      part_ml[(part_row0() + r) * 2 + 1] = 0.f;
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024-byte aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t ring = base + Gm::Q_BYTES;     // the K/V stages, after Q
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (STAGES + st)
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (STAGES + st), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CTHREADS) {
    // ---- producer warp: TMA loads, one box per lane ----
    if constexpr (Gm::WIDE) {
      // 384 threads x 168 registers at launch: 128 x 24 + 256 x 240
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
      if (tid >= CTHREADS + 32) return;
    }
    const int lane = tid & 31;
    const int boxes = KB / box_rows;
    const int* table = page_table + (long long)b * P;
    // this lane's box of chunk i starts at position box_pos(i); its page
    // id is read two chunks ahead, so the table's latency hides behind
    // the ring instead of stalling every chunk
    auto box_pos = [&](int i) { return kbase + i * KB + lane * box_rows; };
    auto page_of = [&](int i) {
      const int pos = box_pos(i);
      return i < n_chunks && lane < boxes && pos < kv_hi ? table[pos / ps] : -1;
    };
    int page_cur = page_of(0), page_nx1 = page_of(1);
    for (int i = 0; i < n_chunks; ++i) {
      const int page_nx2 = page_of(i + 2);
      const int st = i % STAGES;
      const uint32_t use = (uint32_t)(i / STAGES);
      if (i >= STAGES) mbar_wait(bars + 8 * (STAGES + st), (use & 1u) ^ 1u);
      const uint32_t full = bars + 8 * st;
      if (lane == 0) mbar_expect_tx(full, STAGE_BYTES);
      __syncwarp();
      if (lane < boxes) {
        const int pos = box_pos(i);
        int rk = oob_row, rv = oob_row;
        if (page_cur >= 0) {
          rk = ((page_cur * 2) * Hkv + h) * ps + pos % ps;
          rv = rk + Hkv * ps;
        }
        const uint32_t dst = ring + st * STAGE_BYTES + lane * box_rows * 128;
#pragma unroll
        for (int cb = 0; cb < NB; ++cb) {
          tma_load(dst + cb * HALF_BYTES, &kv_map, full, 64 * cb, rk);
          tma_load(dst + (NB + cb) * HALF_BYTES, &kv_map, full, 64 * cb, rv);
        }
      }
      page_cur = page_nx1;
      page_nx1 = page_nx2;
    }
  } else {
    // ---- consumer warpgroups ----
    if constexpr (Gm::WIDE) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid & 31;
    const int g4 = lane / 4, c4 = lane % 4;
    // this thread's two rows of the block: its accumulator rows g4, g4 + 8
    int qpos[2];
    bool has_slot[2], real[2];
    long long orow[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = 64 * wg + 16 * warp + g4 + 8 * k;
      const int slot = tile0 + r / G;
      has_slot[k] = r < LIVE && slot < S;
      real[k] = has_slot[k] && slot < q_len;
      qpos[k] = q_start + slot;
      orow[k] = (((long long)b * S + slot) * Hq + h * G + r % G) * DH;
    }
    // Q, the A operand of S = Q K^T: q * sm_scale rounded to bf16, in the
    // warpgroup's swizzled rows
    const uint32_t qwg = base + wg * (NB * QBLOCK_BYTES);
    unsigned char* qs = gbase + wg * (NB * QBLOCK_BYTES);
    for (int idx = tid % 128; idx < 64 * (DH / 8); idx += 128) {
      const int r = idx / (DH / 8), c8 = idx % (DH / 8);
      const int rr = 64 * wg + r;
      const int slot = tile0 + rr / G;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (rr < LIVE && slot < S) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            q + (((long long)b * S + slot) * Hq + h * G + rr % G) * DH + c8 * 8);
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&w);
        float2 f = __bfloat1622float2(hv[0]);
        v.x = pack_bf16(f.x * sm_scale, f.y * sm_scale);
        f = __bfloat1622float2(hv[1]);
        v.y = pack_bf16(f.x * sm_scale, f.y * sm_scale);
        f = __bfloat1622float2(hv[2]);
        v.z = pack_bf16(f.x * sm_scale, f.y * sm_scale);
        f = __bfloat1622float2(hv[3]);
        v.w = pack_bf16(f.x * sm_scale, f.y * sm_scale);
      }
      *reinterpret_cast<uint4*>(qs + (c8 / 8) * QBLOCK_BYTES + r * 128 +
                                (((c8 % 8) ^ (r & 7)) << 4)) = v;
    }
    fence_async_smem();
    warpgroup_sync(BAR_Q + wg);
    // the warpgroup's query positions bound which chunks need a mask
    const int wg_lo = q_start + tile0 + (64 * wg) / G;
    const int wg_hi = q_start + tile0 + min(64 * wg + 63, LIVE - 1) / G;

    float o[NB][32];
#pragma unroll
    for (int hd = 0; hd < NB; ++hd)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hd][i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

    // ping-pong: the warpgroups take turns to issue S = Q K^T, so one's
    // softmax runs while the other's products hold the tensor cores
    if (wg == 1) named_arrive(BAR_TURN);
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % STAGES;
      const int kc = kbase + i * KB;
      mbar_wait(bars + 8 * st, (uint32_t)(i / STAGES) & 1u);
      const uint32_t kst = ring + st * STAGE_BYTES;
      if (kc + KB > kv_hi) {
        // V rows past the block's kv range: a live page's stale slots, or
        // the next split's rows -> zeros
        unsigned char* vst =
            gbase + Gm::Q_BYTES + st * STAGE_BYTES + NB * HALF_BYTES;
        for (int idx = tid; idx < NB * KB * 8; idx += CTHREADS) {
          const int row = (idx / 8) % KB, half = idx / (8 * KB);
          if (kc + row >= kv_hi)
            *reinterpret_cast<uint4*>(vst + half * HALF_BYTES + row * 128 +
                                      (idx % 8) * 16) = make_uint4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(BAR_ZERO);
      }

      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      named_sync(BAR_TURN + wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wgmma_64x64_ss(s, smem_desc(qwg + (kk / 4) * QBLOCK_BYTES + (kk % 4) * 32),
                       smem_desc(kst + (kk / 4) * HALF_BYTES + (kk % 4) * 32));
      }
      wg_commit();
      named_arrive(BAR_TURN + (1 - wg));
      wg_wait0();

      const bool need_mask = kc + KB > kv_hi || kc + KB - 1 > wg_lo ||
                             (window > 0 && kc <= wg_hi - window);
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = softcap * tanhf(s[j] / softcap);
      }
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int t = kc + 8 * (j / 4) + 2 * c4 + (j & 1);
          const int qp = qpos[(j / 2) & 1];
          if (!(t <= qp && t < kv_hi && (window <= 0 || t > qp - window)))
            s[j] = NEG_INF;
        }
      }
      float scale[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float mx = m_run[k];
#pragma unroll
        for (int j = 0; j < KB / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * k], s[4 * j + 2 * k + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // p = 2^(s log2e - m log2e); a row with nothing visible yet keeps
        // m = -1e30 and takes m log2e = 0, so its masked p are 2^-1.4e30 = 0
        const float ml = mx > NEG_INF * 0.5f ? mx * LOG2E : 0.f;
        scale[k] = ex2(m_run[k] * LOG2E - ml);
        m_run[k] = mx;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < KB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * j + 2 * k + e], LOG2E, -ml));
            s[4 * j + 2 * k + e] = p;
            rs += p;
          }
        l_run[k] = l_run[k] * scale[k] + rs;
      }
      if (__any_sync(0xffffffffu, scale[0] != 1.f || scale[1] != 1.f)) {
#pragma unroll
        for (int hd = 0; hd < NB; ++hd)
#pragma unroll
          for (int j = 0; j < 32; ++j) o[hd][j] *= scale[(j / 2) & 1];
      }
      uint32_t pa[KB / 16][4];
      // P (bf16) as the A operand: S's fragment of columns 16 kk .. + 15
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        const uint32_t vrow = kst + NB * HALF_BYTES + kk * 16 * 128;
#pragma unroll
        for (int hd = 0; hd < NB; ++hd)
          wgmma_64x64<1>(o[hd], pa[kk], smem_desc(vrow + hd * HALF_BYTES));
      }
      wg_commit();
      wg_wait0();
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + st));
    }

    if (wg == 0) named_sync(BAR_TURN);  // the other warpgroup's last turn

    // normalise and store; pad slots get zeros. A split block writes its
    // rows' f32 partials instead: num = O, den = the row sum, max = m
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float l = l_run[k];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (split_row) {
        if (!real[k]) continue;
        const long long prow = part_row0() + 64 * wg + 16 * warp + g4 + 8 * k;
#pragma unroll
        for (int hd = 0; hd < NB; ++hd)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(part_num + prow * DH + 64 * hd + 8 * j +
                                       2 * c4) =
                make_float2(o[hd][4 * j + 2 * k], o[hd][4 * j + 2 * k + 1]);
        if (c4 == 0) {
          part_ml[prow * 2] = m_run[k];
          part_ml[prow * 2 + 1] = l;
        }
        continue;
      }
      const float den = fmaxf(l, 1e-20f);
      if (!has_slot[k]) continue;
#pragma unroll
      for (int hd = 0; hd < NB; ++hd)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x0 = real[k] ? o[hd][4 * j + 2 * k] / den : 0.f;
          const float x1 = real[k] ? o[hd][4 * j + 2 * k + 1] / den : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(out + orow[k] + 64 * hd + 8 * j +
                                             2 * c4) =
              __floats2bfloat162_rn(x0, x1);
        }
    }
  }
}

// One block per (row, kv head, partial row r), one thread per dim: a split
// row's real (slot, head) row r of tile 0 merges the splits' (num, den,
// max) partials and normalises (merge_softmax_partials /
// normalize_softmax_partials' arithmetic; dead partials, max -1e30, weigh
// nothing and their unwritten num is selected away). Other blocks return.
template <int DH>
__global__ void __launch_bounds__(DH)
merge_kernel(const float* __restrict__ part_num,
             const float* __restrict__ part_ml, bf16* __restrict__ out,
             const int* __restrict__ positions,
             const int* __restrict__ total_lens, int S, int Hkv, int G,
             int split_cap, int splits) {
  const int b = (int)blockIdx.x / Hkv, h = (int)blockIdx.x % Hkv;
  const int r = blockIdx.y;  // (slot, head) = (r / G, r % G)
  const int q_len = total_lens[b] - positions[(long long)b * S];
  if (!(q_len >= 1 && q_len <= split_cap) || r >= q_len * G) return;
  const int d = threadIdx.x;
  const int rows = split_cap * G;  // partial rows per split
  const long long part0 = ((long long)b * Hkv + h) * splits * rows + r;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, part_ml[(part0 + (long long)s * rows) * 2]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const long long prow = part0 + (long long)s * rows;
    const float ms = part_ml[prow * 2];
    const bool live = ms > NEG_INF * 0.5f;
    const float w = live ? expf(ms - mx) : 0.f;
    const float v = part_num[prow * DH + d];
    num += live ? w * v : 0.f;
    den += live ? w * part_ml[prow * 2 + 1] : 0.f;
  }
  out[(((long long)b * S + r / G) * (Hkv * G) + h * G + r % G) * DH + d] =
      __float2bfloat16_rn(num / fmaxf(den, 1e-20f));
}

template <int DH, bool SPLIT>
int launch(const void* q, const void* pages, void* out, const void* table,
           const void* positions, const void* lens, long long layer, int B,
           int S, int Hkv, int G, int N, int ps, int P, float sm_scale,
           int window, float softcap, void* part_num, void* part_ml,
           int split_cap, int split_pages, int splits, int n_work,
           cudaStream_t stream) {
  constexpr int SMEM_BYTES = Geo<DH>::SMEM_BYTES;
  const int n_tiles = (S + ROWS / G - 1) / (ROWS / G);
  if (n_work < n_tiles ||
      (SPLIT &&
       (split_cap < 1 || split_cap > ROWS / G || n_work < splits ||
        splits < 1 || (long long)splits * split_pages < P ||
        part_num == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<DH, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const long long rows = (long long)N * 2 * Hkv * ps;  // one layer, 2-D
  const int box_rows = gcd(ps, KB);
  CUtensorMap map;
  void* layer_base = const_cast<bf16*>(static_cast<const bf16*>(pages) + layer * rows * DH);
  if (!encode_rows_map(&map, layer_base, rows, DH, box_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  prefill_kernel<DH, SPLIT><<<dim3(B * Hkv, n_work), Geo<DH>::THREADS, SMEM_BYTES, stream>>>(
      map, static_cast<const bf16*>(q), static_cast<bf16*>(out),
      static_cast<float*>(part_num), static_cast<float*>(part_ml),
      static_cast<const int*>(table), static_cast<const int*>(positions),
      static_cast<const int*>(lens), S, Hkv, G, ps, P, box_rows, (int)rows,
      n_tiles, split_cap, split_pages * ps, SPLIT ? splits : 1, sm_scale, window,
      softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !SPLIT) return static_cast<int>(e);
  merge_kernel<DH><<<dim3(B * Hkv, split_cap * G), DH, 0, stream>>>(
      static_cast<const float*>(part_num), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), static_cast<const int*>(positions),
      static_cast<const int*>(lens), S, Hkv, G, split_cap, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool SPLIT>
int dispatch(const void* q, const void* pages, void* out, const void* table,
             const void* positions, const void* lens, long long layer, int B,
             int S, int Hq, int Hkv, int Dh, int N, int ps, int P,
             float sm_scale, int window, float softcap, void* part_num,
             void* part_ml, int split_cap, int split_pages, int splits,
             int n_work, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > MAX_G || ps % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
#define DYN_CASE(DV)                                                           \
  case DV:                                                                     \
    return launch<DV, SPLIT>(q, pages, out, table, positions, lens, layer, B,  \
                             S, Hkv, G, N, ps, P, sm_scale, window, softcap,   \
                             part_num, part_ml, split_cap, split_pages, splits, \
                             n_work, s);
  switch (Dh) {
    DYN_CASE(64)
    DYN_CASE(128)
    DYN_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DYN_CASE
}

}  // namespace

// B2: every row's blocks are its query tiles
extern "C" int paged_prefill_launch(const void* q, const void* pages,
                                    void* out, const void* page_table,
                                    const void* positions,
                                    const void* total_lens, long long layer,
                                    int B, int S, int Hq, int Hkv, int Dh,
                                    int N, int ps, int P, float sm_scale,
                                    int window, float softcap, void* stream) {
  // a geometry dispatch refuses still needs a tile count that divides
  const int G = Hkv > 0 && Hq >= Hkv && Hq % Hkv == 0 && Hq / Hkv <= MAX_G
                    ? Hq / Hkv : 1;
  const int n_tiles = (S + ROWS / G - 1) / (ROWS / G);
  return dispatch<false>(q, pages, out, page_table, positions, total_lens,
                         layer, B, S, Hq, Hkv, Dh, N, ps, P, sm_scale, window,
                         softcap, nullptr, nullptr, 0, 0, 1, n_tiles, stream);
}

// B3: the same kernel; rows of 1 .. split_cap real queries take split-KV.
// The grid is n_work x (B * Hkv) blocks, n_work >= the tile count and >=
// splits; part_num [B, Hkv, splits, split_cap * G, Dh] and part_ml
// [.., 2] f32 are the caller's scratch; every split is split_pages whole
// pages and the splits cover the table.
extern "C" int ragged_mixed_launch(const void* q, const void* pages, void* out,
                                   const void* page_table,
                                   const void* positions,
                                   const void* total_lens, long long layer,
                                   int B, int S, int Hq, int Hkv, int Dh, int N,
                                   int ps, int P, float sm_scale, int window,
                                   float softcap, void* part_num, void* part_ml,
                                   int split_cap, int split_pages, int splits,
                                   int n_work, void* stream) {
  return dispatch<true>(q, pages, out, page_table, positions, total_lens,
                        layer, B, S, Hq, Hkv, Dh, N, ps, P, sm_scale, window,
                        softcap, part_num, part_ml, split_cap, split_pages,
                        splits, n_work, stream);
}
