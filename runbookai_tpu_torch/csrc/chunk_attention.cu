// Chunk attention (T > 1: chunked prefill and the speculative verify) over a
// paged KV pool, for bf16 queries, on the tensor cores of Hopper.
//
// Replaces the Pallas TPU kernel paged_chunk_attention (_chunk_kernel) of
// runbookai_tpu/ops/paged_attention_pallas.py for bf16 queries over bf16 pools
// and over int8 pools (one f32 absmax scale per (token, kv head),
// runbookai_tpu_torch/ops/attention.py quantize_kv), which the JAX package
// serves on its XLA gather path; and, in chunk_partial_mma_kernel (the
// page-split chunk partial), the XLA _partial_flash of
// runbookai_tpu/parallel/kv_split.py for bf16 queries over a bf16 pool slice.
// f32 queries take the CUDA-core kernels of paged_attention.cu.
//
// The Pallas paged_ragged_attention (W1) of the same file has a kernel of its
// own, ragged_attention.cu. This kernel serves the mixed batch on a
// tensor-parallel mesh: per head shard, one call at [N / 8, 8] with each
// 8-token block's table row and context gathered beforehand
// (ops/paged_attention.py paged_chunk_attention_tp), where a pad block (ctx
// 0) gives zeros.
//
// What it computes, for query row (token t, head h) of sequence b: an online
// (flash) softmax in f32 over the first ctx_lens[b] cached tokens, read
// through page_tables[b, p], causal over pos <= q_start[b] + t, kv-major GQA
// (head h reads kv head h / group). Masked probabilities are zeroed and l is
// clamped at 1e-30, so a row that sees no key gives zeros. A block reads no
// page-table entry at or past ceil(ctx / ps), nor past the page of its last
// query position: the trash column is never touched, and the engine's pad row
// (null table, ctx 1) reads page 0 only.
//
// What bounds it on an H100: a 4 x 512 prefill does 17.2 GFLOP of causal work
// (0.0174 ms at 989 TFLOP/s, operations-bound); a T=8 verify over 13,651
// cached tokens moves 55.9 MB of bf16 K/V (0.0167 ms at 3.35 TB/s,
// bytes-bound; about half of that over int8 pools). The design:
//
// - Row tiles shared by the GQA group. A block owns one (sequence, kv head,
//   tile of query rows); its rows are (token, group head) pairs, kv-major, so
//   every K/V tile it loads serves the whole group. Each warp owns 16 rows:
//   64 rows (4 warps) a block, or 32 rows (2 warps) when T * group <= 32 (the
//   T=8 verify of a 4-head group). Rows never straddle sequences or kv heads.
//   The causal key range ends at the block's last query position, so tiles
//   past it are never visited; heavy tiles are launched first.
// - Asynchronous page tiles. K/V tiles of 64 keys (four 16-token pages) are
//   read in the pool's own type, one 256-byte bf16 or 128-byte int8 row per
//   (token, kv head), with cp.async (16 bytes a thread) into a three-stage
//   ring in shared memory: the next two tiles load while this one computes
//   (a fourth stage leaves room for one 64-row block per SM, and the prefill
//   slows). Each block reads its own page ids from the table; keys past the
//   range are zero-filled, never read. bf16 tiles are stored with an XOR
//   swizzle of their 16-byte chunks, so ldmatrix reads them without bank
//   conflicts. One barrier per tile (two over int8 pools, see below).
// - Tensor cores. S = Q K^T and O += P V with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), fragments from ldmatrix (.trans for V). The softmax scale is
//   applied to the f32 scores (times log2 e, for exp2). The running max and
//   sum stay in registers, per row, reduced across a quad with shuffles.
// - P in two bf16 parts. Rounding P once to bf16 for the P V product moves
//   outputs over short contexts by up to 2^-9 of a V value, beyond the bf16
//   check (1e-3 + 1e-2 relative) wherever the output is near zero: hundreds
//   of elements at chip_smoke.py's inputs. So P = hi + lo, both bf16, and the
//   P V product runs twice (hi and lo): 1.5x the tensor-core work of one
//   rounding, for P exact to about 2^-16.
// - int8 pools without a dequantized copy. An int8 value widens to bf16
//   exactly (|v| <= 127); the widened tile (no scale applied) is written to a
//   swizzled bf16 tile after the int8 tile lands, which costs the second
//   barrier. Each score column is multiplied by k_scale[token, kv head] after
//   Q K^T, and v_scale[token, kv head] is folded into P before its split for
//   the P V product. The pool moves one byte a value plus its scales.
// - Split-K over pages when the grid is small (ops/paged_attention.py
//   chunk_plan, from shapes only). With S > 1 splits, split s covers table
//   columns [s * cols, (s + 1) * cols) and writes its f32 (acc, m, l), m in
//   natural-log units, to a workspace; a split that sees no key writes
//   (0, -1e30, 0). chunk_merge_kernel merges the splits in fixed order (the
//   same inputs give the same bits run to run) and writes q's dtype; its
//   plain version is merge_partials followed by the cast.
//
// The page-split chunk partial (chunk_partial_mma_kernel) runs the same
// rows, tiles and tensor-core steps over one page shard's slice of the
// pool: tables hold global page ids, page g lives on shard g / pages_local
// at local page g - shard * pages_local. Its prologue lists,
// in shared memory and in table order, the columns of the block's split that
// lie below its key bound and whose page this shard owns (a ballot and a
// prefix count per 32 columns); its 64-key tiles are then four owned pages
// each, whatever the pages between them, and every key carries its own
// position (column * ps + offset) into the ctx and causal masks. A foreign
// page is never read: where the allocator hands a sequence long runs of one
// shard's pages (engine/kv_cache.py), a shard walks only its runs, and where
// ownership interleaves page by page (random tables), it walks half the
// columns. It writes the un-normalised (acc, m, l) in f32, m in natural-log
// units, a row with no owned key (0, -1e30, 0): unsplit straight to the
// output; split to a workspace, and the last split of a row tile to finish
// (an int32 counter per tile, after a __threadfence) combines the splits in
// split order into the output and resets its counter (plain version:
// combine_partials). One launch a call: a second launch and its workspace
// cost more host time than the kernel takes (PERF.md). The bound is
// the owned pages' bytes.
//
// mma.sync and cp.async rather than wgmma and TMA: a 64-row wgmma tile would
// waste half of the verify's 32-row tiles, and cp.async gathers 16-token
// pages row by row without a tensor map per pool. wgmma/TMA for the prefill
// shape is later work.
//
// Built with every source of csrc/ by runbookai_tpu_torch/ops/build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, one shared library,
// ctypes).

#include <climits>

#include "attention_common.cuh"

namespace {

constexpr int kStages = 3;  // K/V tiles in the ring: two load while one computes

struct ChunkArgs {
  const __nv_bfloat16* q;  // [B, T, n_q, HD]
  const void* k;           // [tokens, n_kv, HD], bf16 or int8
  const void* v;           // same
  const float* k_scale;    // [tokens, n_kv], int8 pools only
  const float* v_scale;    // same
  const int* tables;       // [B, P]
  const int* ctx_lens;     // [B]
  const int* q_start;      // [B]
  __nv_bfloat16* out;      // [B, T, n_q, HD], one split
  float* ws_acc;           // [S, B, T, n_q, HD], several splits
  float* ws_m;             // [S, B, T, n_q]
  float* ws_l;             // same
  int T, n_q, n_kv, ps, P, cols, splits;
  float scale_log2;        // softmax scale times log2(e)
};

template <typename TKV, int HD, int WARPS>
struct Smem {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kRows = WARPS * 16;
  static constexpr int kQ = kRows * HD * 2;                      // bf16 Q tile
  static constexpr int kStage = 2 * kKeys * HD * sizeof(TKV);    // K and V tiles
  static constexpr int kScales = kInt8 ? 2 * kKeys * 4 : 0;      // k and v scales
  static constexpr int kWide = kInt8 ? 2 * kKeys * HD * 2 : 0;   // widened bf16 K, V
  static constexpr int kBytes = kQ + kStages * (kStage + kScales) + kWide;
};

// Pool row (token slot) of a sequence's key `pos`, through its page table.
__device__ __forceinline__ long long pool_row(const ChunkArgs& a, const int* table, int pos) {
  return static_cast<long long>(table[pos / a.ps]) * a.ps + pos % a.ps;
}

// Start the cp.async copies of the 64-key tile whose first key is `pos0`
// (keys at or past `hi` are zero-filled and their table entries not read).
template <typename TKV, int HD, int THREADS>
__device__ __forceinline__ void load_tile(const ChunkArgs& a, const int* table, int kvh,
                                          int pos0, int hi, char* stage, float* scales) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kChunks = HD * sizeof(TKV) / 16;  // 16-byte chunks per key row
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  char* k_s = stage;
  char* v_s = stage + kKeys * HD * sizeof(TKV);
  for (int i = threadIdx.x; i < kKeys * kChunks; i += THREADS) {
    const int key = i / kChunks, ch = i % kChunks;
    const int pos = pos0 + key;
    const bool live = pos < hi;
    const long long row = live ? pool_row(a, table, pos) : 0;
    const long long src = (row * a.n_kv + kvh) * HD * static_cast<long long>(sizeof(TKV)) + ch * 16;
    // int8 tiles are linear (widened later); bf16 tiles are swizzled.
    const int dst = kInt8 ? key * HD + ch * 16 : swz<HD>(key, ch) * 2;
    cp_async16(k_s + dst, kp + src, live);
    cp_async16(v_s + dst, vp + src, live);
  }
  if constexpr (kInt8) {
    for (int key = threadIdx.x; key < kKeys; key += THREADS) {
      const int pos = pos0 + key;
      const bool live = pos < hi;
      const long long idx = (live ? pool_row(a, table, pos) : 0) * a.n_kv + kvh;
      cp_async4(scales + key, a.k_scale + idx, live);
      cp_async4(scales + kKeys + key, a.v_scale + idx, live);
    }
  }
}

template <typename TKV, int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    chunk_attention_mma_kernel(ChunkArgs a) {
  using S = Smem<TKV, HD, WARPS>;
  constexpr int kThreads = WARPS * 32;
  constexpr int kRows = S::kRows;
  constexpr int kKs = HD / 16;    // k-steps of Q K^T
  constexpr int kNb = HD / 8;     // n-blocks of O
  constexpr int kSb = kKeys / 8;  // n-blocks of S
  extern __shared__ __align__(128) char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  char* ring = smem + S::kQ;
  float* scale_ring = reinterpret_cast<float*>(ring + kStages * S::kStage);
  __nv_bfloat16* wide =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * (S::kStage + S::kScales));

  const int n_kv = a.n_kv, group = a.n_q / n_kv;
  const int b = blockIdx.y / n_kv, kvh = blockIdx.y % n_kv;
  const int rows_total = a.T * group;                   // row r: token r / group, head r % group
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy (late) tiles first
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;

  // Key range of this block: below ctx (and the table's width), at or before
  // its last query position, inside its split's table columns.
  const int ctx = a.ctx_lens[b];
  const int qs = a.q_start[b];
  const int t_last = (min(row0 + kRows, rows_total) - 1) / group;
  int hi = min(ctx, a.P * a.ps);
  hi = min(hi, qs + t_last + 1);
  const int lo = split * a.cols * a.ps;
  hi = min(hi, (split + 1) * a.cols * a.ps);
  const int n_tiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
  const int* table = a.tables + static_cast<long long>(b) * a.P;

  // Keys pos < lim[hr] are live for this thread's rows g (hr 0) and g + 8.
  int lim[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + warp * 16 + g + 8 * hr;
    lim[hr] = r < rows_total ? min(hi, qs + r / group + 1) : lo;
  }

  if (n_tiles > 0) {
    constexpr int kChunks = HD / 8;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      const int gr = row0 + r;
      const bool live = gr < rows_total;
      const int t = live ? gr / group : 0, h = kvh * group + (live ? gr % group : 0);
      const long long row = (static_cast<long long>(b) * a.T + t) * a.n_q + h;  // (b, t, h)
      cp_async16(q_s + swz<HD>(r, ch), a.q + row * HD + ch * 8, live);
    }
  }
  // The first kStages - 1 tiles, one copy group each (Q rides with tile 0).
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles)
      load_tile<TKV, HD, kThreads>(a, table, kvh, lo + it * kKeys, hi, ring + it * S::kStage,
                                   scale_ring + it * 2 * kKeys);
    cp_async_commit();
  }

  uint32_t qf[kKs][4];
  float o[kNb][4];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the running sum

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    const int next = it + kStages - 1;  // into the stage tile it - 1 used
    if (next < n_tiles)
      load_tile<TKV, HD, kThreads>(a, table, kvh, lo + next * kKeys, hi,
                                   ring + (next % kStages) * S::kStage,
                                   scale_ring + (next % kStages) * 2 * kKeys);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        const int mat = lane >> 3;
        ldmatrix_x4(qf[ks], q_s + swz<HD>(warp * 16 + (lane & 7) + (mat & 1) * 8,
                                          2 * ks + (mat >> 1)));
      }
    }
    const __nv_bfloat16* k_t;
    const __nv_bfloat16* v_t;
    const float* sc = scale_ring + st * 2 * kKeys;
    if constexpr (S::kInt8) {
      widen_tile<HD, kThreads>(reinterpret_cast<const int8_t*>(ring + st * S::kStage), wide);
      __syncthreads();  // the widened tile is complete
      k_t = wide;
      v_t = wide + kKeys * HD;
    } else {
      k_t = reinterpret_cast<const __nv_bfloat16*>(ring + st * S::kStage);
      v_t = k_t + kKeys * HD;
    }
    const int pos0 = lo + it * kKeys;
    // A warp whose rows see no key of this tile skips it (p = 0, alpha = 1).
    if (!__any_sync(0xffffffffu, pos0 < lim[0] || pos0 < lim[1])) continue;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kSb][4];
#pragma unroll
    for (int j = 0; j < kSb; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
      for (int jj = 0; jj < kSb / 2; ++jj) {
        uint32_t kb[4];
        const int mat = lane >> 3;
        ldmatrix_x4(kb, k_t + swz<HD>(16 * jj + (lane & 7) + (mat >> 1) * 8, 2 * ks + (mat & 1)));
        mma_bf16(s[2 * jj], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Online softmax over the tile, rows g and g + 8 of the warp.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSb; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * c + e;
          float x = s[j][2 * hr + e] * a.scale_log2;
          if constexpr (S::kInt8) x *= sc[key];
          x = pos0 + key < lim[hr] ? x : kNegInf;
          s[j][2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[hr], mx);
      const float alpha = exp2f(m2[hr] - m_new);
      m2[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSb; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * c + e;
          const float p = pos0 + key < lim[hr] ? exp2f(s[j][2 * hr + e] - m_new) : 0.f;
          sum += p;
          s[j][2 * hr + e] = S::kInt8 ? p * sc[kKeys + key] : p;  // v_scale folded in
        }
      }
      l[hr] = l[hr] * alpha + sum;
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        o[nb][2 * hr] *= alpha;
        o[nb][2 * hr + 1] *= alpha;
      }
    }

    // O += P V, P as hi + lo bf16 parts.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < kNb / 2; ++dd) {
        uint32_t vb[4];
        const int mat = lane >> 3;
        ldmatrix_x4_trans(vb, v_t + swz<HD>(16 * kk + (lane & 7) + (mat & 1) * 8,
                                            2 * dd + (mat >> 1)));
        mma_bf16(o[2 * dd], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dd], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dd + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dd + 1], pl, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int r = row0 + warp * 16 + g + 8 * hr;
    if (r >= rows_total) continue;
    const int t = r / group, h = kvh * group + r % group;
    const long long row = (static_cast<long long>(b) * a.T + t) * a.n_q + h;  // (b, t, h)
    if (a.splits == 1) {
      __nv_bfloat16* dst = a.out + row * HD;
      const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nb + 2 * c) =
            __floats2bfloat162_rn(o[nb][2 * hr] / den, o[nb][2 * hr + 1] / den);
    } else {
      const long long n_rows = static_cast<long long>(gridDim.y / n_kv) * a.T * a.n_q;
      const long long ws_row = split * n_rows + row;
      float* dst = a.ws_acc + ws_row * HD;
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb)
        *reinterpret_cast<float2*>(dst + 8 * nb + 2 * c) =
            make_float2(o[nb][2 * hr], o[nb][2 * hr + 1]);
      if (c == 0) {
        a.ws_m[ws_row] = l[hr] > 0.f ? m2[hr] * kLn2 : kNegInf;
        a.ws_l[ws_row] = l[hr];
      }
    }
  }
}

struct PartialArgs {
  const __nv_bfloat16* q;  // [B, T, n_q, HD]
  const void* k;           // [pages_local * ps, n_kv, HD] bf16: this shard's slice
  const void* v;           // same
  const int* tables;       // [B, P] global page ids
  const int* ctx_lens;     // [B]
  const int* q_pos;        // [B, T], contiguous ascending per row: row b starts at q_pos[b * T]
  float* acc;              // [B, T, n_q, HD] f32, un-normalised
  float* m;                // [B, T, n_q], natural-log units
  float* l;                // same
  float* ws;               // several splits: acc [S, B, T, n_q, HD], then m and l [S, B, T, n_q]
  int* counters;           // several splits: [row tiles, B * n_kv], 0 between launches
  int T, n_q, n_kv, ps, P, cols, splits, shard, pages_local;
  float scale_log2;        // softmax scale times log2(e)
};

// Shared memory of the chunk partial: K2's, plus each stage's key positions,
// the owned-column counts of the warps and the owned columns with their
// local pages (up to `cols` each).
template <int HD, int WARPS>
struct PartialSmem {
  using Base = Smem<__nv_bfloat16, HD, WARPS>;
  static constexpr int kPos = kStages * kKeys * 4;
  static constexpr int kFixed = Base::kBytes + kPos + WARPS * 4;
  static int bytes(int cols) { return kFixed + 2 * cols * 4; }
};

// The page-split chunk partial: chunk_attention_mma_kernel's rows, tiles,
// tensor-core steps and softmax over page shard a.shard's owned pages, each
// key at its own position; (acc, m, l) out, the splits merged in the launch.
// A kernel of its own: the partial's prologue, key source and epilogue folded
// into K2's body as a template flag slowed K2 on the card (PERF.md).
template <int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    chunk_partial_mma_kernel(PartialArgs a) {
  using S = Smem<__nv_bfloat16, HD, WARPS>;
  constexpr int kThreads = WARPS * 32;
  constexpr int kRows = S::kRows;
  constexpr int kKs = HD / 16;    // k-steps of Q K^T
  constexpr int kNb = HD / 8;     // n-blocks of O
  constexpr int kSb = kKeys / 8;  // n-blocks of S
  extern __shared__ __align__(128) char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  char* ring = smem + S::kQ;
  int* pos_ring = reinterpret_cast<int*>(smem + S::kBytes);  // [stage][key]
  int* warp_n = pos_ring + kStages * kKeys;
  int* own_col = warp_n + WARPS;
  int* own_page = own_col + a.cols;

  const int n_kv = a.n_kv, group = a.n_q / n_kv;
  const int b = blockIdx.y / n_kv, kvh = blockIdx.y % n_kv;
  const int rows_total = a.T * group;                   // row r: token r / group, head r % group
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy (late) tiles first
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int shard = a.shard, pages_local = a.pages_local;

  // Key bound of this block: below ctx (and the table's width), at or
  // before its last query position.
  const int ctx = a.ctx_lens[b];
  const int qs = a.q_pos[static_cast<long long>(b) * a.T];
  const int t_last = (min(row0 + kRows, rows_total) - 1) / group;
  const int hi = min(min(ctx, a.P * a.ps), qs + t_last + 1);
  const int* table = a.tables + static_cast<long long>(b) * a.P;

  // The owned columns of this split below the bound, in table order: key
  // j < n_keys is offset j % ps of local page own_page[j / ps].
  const int c0 = split * a.cols;
  const int c1 = hi > 0 ? min(c0 + a.cols, (hi + a.ps - 1) / a.ps) : c0;
  int n_own = 0;
  for (int base = c0; base < c1; base += kThreads) {  // uniform over the block
    const int col = base + threadIdx.x;
    const int page = col < c1 ? table[col] : -1;
    const bool own = page >= 0 && page / pages_local == shard;
    const unsigned ball = __ballot_sync(0xffffffffu, own);
    if (lane == 0) warp_n[warp] = __popc(ball);
    __syncthreads();
    int before = n_own;
    for (int w = 0; w < WARPS; ++w) before += w < warp ? warp_n[w] : 0;
    if (own) {
      const int i = before + __popc(ball & ((1u << lane) - 1u));
      own_col[i] = col;
      own_page[i] = page - shard * pages_local;
    }
    for (int w = 0; w < WARPS; ++w) n_own += warp_n[w];
    __syncthreads();  // the list is complete; warp_n is free
  }
  const int n_keys = n_own * a.ps;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  // Keys at positions pos < lim[hr] are live for this thread's rows g (hr 0)
  // and g + 8.
  int lim[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + warp * 16 + g + 8 * hr;
    lim[hr] = r < rows_total ? min(hi, qs + r / group + 1) : 0;
  }

  // Start tile it's copies into its stage and write its keys' positions
  // (INT_MAX past n_keys).
  auto issue = [&](int it) {
    const int j0 = it * kKeys;
    int* pos_s = pos_ring + (it % kStages) * kKeys;
    for (int key = threadIdx.x; key < kKeys; key += kThreads) {
      const int j = j0 + key;
      pos_s[key] = j < n_keys ? own_col[j / a.ps] * a.ps + j % a.ps : INT_MAX;
    }
    load_kv_tile<__nv_bfloat16, HD, kThreads>(a.k, a.v, nullptr, nullptr, n_kv, kvh,
                                              OwnedKeys{own_page, j0, n_keys, a.ps},
                                              ring + (it % kStages) * S::kStage, nullptr);
  };

  if (n_tiles > 0) {
    constexpr int kChunks = HD / 8;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      const int gr = row0 + r;
      const bool live = gr < rows_total;
      const int t = live ? gr / group : 0, h = kvh * group + (live ? gr % group : 0);
      const long long row = (static_cast<long long>(b) * a.T + t) * a.n_q + h;  // (b, t, h)
      cp_async16(q_s + swz<HD>(r, ch), a.q + row * HD + ch * 8, live);
    }
  }
  // The first kStages - 1 tiles, one copy group each (Q rides with tile 0).
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) issue(it);
    cp_async_commit();
  }

  uint32_t qf[kKs][4];
  float o[kNb][4];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the running sum

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    const int next = it + kStages - 1;  // into the stage tile it - 1 used
    if (next < n_tiles) issue(next);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        const int mat = lane >> 3;
        ldmatrix_x4(qf[ks], q_s + swz<HD>(warp * 16 + (lane & 7) + (mat & 1) * 8,
                                          2 * ks + (mat >> 1)));
      }
    }
    const __nv_bfloat16* k_t = reinterpret_cast<const __nv_bfloat16*>(ring + st * S::kStage);
    const __nv_bfloat16* v_t = k_t + kKeys * HD;
    const int* pos_s = pos_ring + st * kKeys;
    // A warp whose rows see no key of this tile skips it (p = 0, alpha = 1).
    if (!__any_sync(0xffffffffu, pos_s[0] < lim[0] || pos_s[0] < lim[1])) continue;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kSb][4];
#pragma unroll
    for (int j = 0; j < kSb; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
      for (int jj = 0; jj < kSb / 2; ++jj) {
        uint32_t kb[4];
        const int mat = lane >> 3;
        ldmatrix_x4(kb, k_t + swz<HD>(16 * jj + (lane & 7) + (mat >> 1) * 8, 2 * ks + (mat & 1)));
        mma_bf16(s[2 * jj], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Online softmax over the tile, rows g and g + 8 of the warp, each score
    // column masked by its key's position.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSb; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = pos_s[8 * j + 2 * c + e] < lim[hr]
                              ? s[j][2 * hr + e] * a.scale_log2 : kNegInf;
          s[j][2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[hr], mx);
      const float alpha = exp2f(m2[hr] - m_new);
      m2[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSb; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = pos_s[8 * j + 2 * c + e] < lim[hr]
                              ? exp2f(s[j][2 * hr + e] - m_new) : 0.f;
          sum += p;
          s[j][2 * hr + e] = p;
        }
      }
      l[hr] = l[hr] * alpha + sum;
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        o[nb][2 * hr] *= alpha;
        o[nb][2 * hr + 1] *= alpha;
      }
    }

    // O += P V, P as hi + lo bf16 parts.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < kNb / 2; ++dd) {
        uint32_t vb[4];
        const int mat = lane >> 3;
        ldmatrix_x4_trans(vb, v_t + swz<HD>(16 * kk + (lane & 7) + (mat & 1) * 8,
                                            2 * dd + (mat >> 1)));
        mma_bf16(o[2 * dd], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dd], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dd + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dd + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // (acc, m, l) of split `split`: unsplit, the output; split, the workspace,
  // which the last split of this row tile to finish merges.
  const long long n_rows = static_cast<long long>(gridDim.y / n_kv) * a.T * a.n_q;
  const int splits = gridDim.z;
  float* ws_acc = splits == 1 ? a.acc : a.ws;
  float* ws_m = splits == 1 ? a.m : a.ws + splits * n_rows * HD;
  float* ws_l = splits == 1 ? a.l : ws_m + splits * n_rows;
  // Row r of the tile is (b, t, h) = row_of(r) of the [B, T, n_q] rows.
  auto row_of = [&](int r) {
    const int gr = row0 + r;
    return (static_cast<long long>(b) * a.T + gr / group) * a.n_q + kvh * group + gr % group;
  };
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int r = warp * 16 + g + 8 * hr;
    if (row0 + r >= rows_total) continue;
    const long long ws_row = split * n_rows + row_of(r);
    float* dst = ws_acc + ws_row * HD;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
      *reinterpret_cast<float2*>(dst + 8 * nb + 2 * c) =
          make_float2(o[nb][2 * hr], o[nb][2 * hr + 1]);
    if (c == 0) {
      ws_m[ws_row] = l[hr] > 0.f ? m2[hr] * kLn2 : kNegInf;
      ws_l[ws_row] = l[hr];
    }
  }
  if (splits == 1) return;

  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  int* counter = a.counters + static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // Per row: M = max_s m_s, weights c_s = e^(m_s - M) in the idle ring, l =
  // sum_s l_s c_s; then acc = sum_s acc_s c_s, all in split order, where a
  // split of weight 0 (it saw no key of the row) is not read. A row no split
  // saw stays (0, -1e30, 0).
  const int n_tile_rows = min(kRows, rows_total - row0);
  float* wt = reinterpret_cast<float*>(ring);  // [split][row]
  for (int r = threadIdx.x; r < n_tile_rows; r += kThreads) {
    const long long row = row_of(r);
    float mx = kNegInf;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, __ldcg(ws_m + sp * n_rows + row));
    float den = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float w = expf(__ldcg(ws_m + sp * n_rows + row) - mx);
      wt[sp * kRows + r] = w;
      den += __ldcg(ws_l + sp * n_rows + row) * w;
    }
    a.m[row] = mx;
    a.l[row] = den;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tile_rows * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), d = 4 * (i % (HD / 4));
    const long long row = row_of(r);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float w = wt[sp * kRows + r];
      if (w == 0.f) continue;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(ws_acc + (sp * n_rows + row) * HD + d));
      sum.x += x.x * w;
      sum.y += x.y * w;
      sum.z += x.z * w;
      sum.w += x.w * w;
    }
    *reinterpret_cast<float4*>(a.acc + row * HD + d) = sum;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

// out[n, :] = sum_s acc[s, n, :] e^(m[s, n] - M) / max(sum_s l[s, n] e^(m[s, n] - M), 1e-30),
// M = max_s m[s, n]; sums in split order. One warp per row, four columns a
// lane; the loads of successive splits are independent, so they pipeline.
template <typename TOUT>
__global__ void chunk_merge_kernel(const float* acc, const float* m, const float* l, TOUT* out,
                                   int splits, long long n_rows, int hd) {
  const long long n = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (n >= n_rows) return;
  const int lane = threadIdx.x % 32;
  float m_g = kNegInf;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) m_g = fmaxf(m_g, m[s * n_rows + n]);
  for (int d = 4 * lane; d < hd; d += 128) {
    float l_g = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const long long row = s * n_rows + n;
      const float c = expf(m[row] - m_g);
      const float4 x = *reinterpret_cast<const float4*>(acc + row * hd + d);
      l_g += l[row] * c;
      sum.x += x.x * c;
      sum.y += x.y * c;
      sum.z += x.z * c;
      sum.w += x.w * c;
    }
    const float den = fmaxf(l_g, 1e-30f);
    const float r[4] = {sum.x / den, sum.y / den, sum.z / den, sum.w / den};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (std::is_same<TOUT, float>::value) {
        out[n * hd + d + e] = r[e];
      } else {
        out[n * hd + d + e] = __float2bfloat16(r[e]);
      }
    }
  }
}

template <typename TKV, int HD, int WARPS>
int launch(const ChunkArgs& a, int B, cudaStream_t stream) {
  const int rows = WARPS * 16;
  const int q_tiles = (a.T * (a.n_q / a.n_kv) + rows - 1) / rows;
  const int smem = Smem<TKV, HD, WARPS>::kBytes;
  auto kernel = chunk_attention_mma_kernel<TKV, HD, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(q_tiles, B * a.n_kv, a.splits), WARPS * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int WARPS>
int launch_partial(const PartialArgs& a, int B, cudaStream_t stream) {
  const int rows = WARPS * 16;
  const int q_tiles = (a.T * (a.n_q / a.n_kv) + rows - 1) / rows;
  const int smem = PartialSmem<HD, WARPS>::bytes(a.cols);
  // The merge's weights (splits x rows floats) live in the ring.
  if (static_cast<long long>(a.splits) * rows > kStages * Smem<__nv_bfloat16, HD, WARPS>::kStage / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = chunk_partial_mma_kernel<HD, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(q_tiles, B * a.n_kv, a.splits), WARPS * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int launch_hd(const ChunkArgs& a, int B, int hd, int rows, cudaStream_t stream) {
  if (hd == 64 && rows == 32) return launch<TKV, 64, 2>(a, B, stream);
  if (hd == 64 && rows == 64) return launch<TKV, 64, 4>(a, B, stream);
  if (hd == 128 && rows == 32) return launch<TKV, 128, 2>(a, B, stream);
  if (hd == 128 && rows == 64) return launch<TKV, 128, 4>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The checks both entry points share.
bool valid_plan(int n_q, int n_kv, int ps, int P, int splits, int cols) {
  return n_kv > 0 && n_q % n_kv == 0 && ps > 0 && P >= 0 && splits >= 1 && cols >= 0 &&
         static_cast<long long>(splits) * cols >= P;
}

}  // namespace

extern "C" {

// q [B, T, n_q, hd] bf16; k, v [tokens, n_kv, hd] bf16 (kv_dtype 1) or int8
// (kv_dtype 2, with k_scale / v_scale [tokens, n_kv] f32); tables [B, P],
// ctx_lens and q_start [B] int32. rows (32 or 64) query rows per block,
// `splits` splits of `cols` table columns each. One split writes out [B, T,
// n_q, hd] bf16; several write ws_acc [splits, B, T, n_q, hd] and ws_m, ws_l
// [splits, B, T, n_q] f32 for rb_paged_chunk_merge. Returns
// cudaGetLastError() of the launch.
int rb_paged_chunk_attention_mma(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale, const void* tables,
                                 const void* ctx_lens, const void* q_start, void* out,
                                 void* ws_acc, void* ws_m, void* ws_l, int B, int T, int n_q,
                                 int n_kv, int hd, int ps, int P, int rows, int splits,
                                 int cols, float scale, int kv_dtype, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (!valid_plan(n_q, n_kv, ps, P, splits, cols))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits == 1 ? out == nullptr : (ws_acc == nullptr || ws_m == nullptr || ws_l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  ChunkArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
              static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
              static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
              static_cast<const int*>(q_start), static_cast<__nv_bfloat16*>(out),
              static_cast<float*>(ws_acc), static_cast<float*>(ws_m),
              static_cast<float*>(ws_l), T, n_q, n_kv, ps, P, cols, splits,
              scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kBF16) return launch_hd<__nv_bfloat16>(a, B, hd, rows, s);
  if (kv_dtype == kI8) return launch_hd<int8_t>(a, B, hd, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The page-split chunk partial: q [B, T, n_q, hd] bf16 over page shard
// `shard`'s bf16 slice k, v [pages_local * ps, n_kv, hd] (tables hold global
// page ids), causal over q_pos [B, T] (row b's positions q_pos[b, 0] + t).
// Writes acc [B, T, n_q, hd], m and l [B, T, n_q] f32,
// un-normalised, m in natural-log units. With splits > 1, ws holds
// splits * B * T * n_q * (hd + 2) f32 and counters q_tiles * B * n_kv int32
// zeros (left zero). Returns cudaGetLastError() of the launch.
int rb_paged_chunk_attention_partial_mma(const void* q, const void* k, const void* v,
                                         const void* tables, const void* ctx_lens,
                                         const void* q_pos, void* acc, void* m, void* l,
                                         void* ws, void* counters, int B, int T, int n_q,
                                         int n_kv, int hd, int ps, int P, int rows, int splits,
                                         int cols, int shard, int pages_local, float scale,
                                         void* stream) {
  if (B == 0 || T == 0) return 0;
  if (!valid_plan(n_q, n_kv, ps, P, splits, cols) || shard < 0 || pages_local <= 0 ||
      acc == nullptr || m == nullptr || l == nullptr ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(acc) ||
      (splits > 1 && !aligned16(ws)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const PartialArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                      static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
                      static_cast<const int*>(q_pos), static_cast<float*>(acc),
                      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(ws),
                      static_cast<int*>(counters), T, n_q, n_kv, ps, P, cols, splits, shard,
                      pages_local, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && rows == 32) return launch_partial<64, 2>(a, B, s);
  if (hd == 64 && rows == 64) return launch_partial<64, 4>(a, B, s);
  if (hd == 128 && rows == 32) return launch_partial<128, 2>(a, B, s);
  if (hd == 128 && rows == 64) return launch_partial<128, 4>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// acc [splits, n_rows, hd], m and l [splits, n_rows] f32 -> out [n_rows, hd]
// in out_dtype (0 f32, 1 bf16).
int rb_paged_chunk_merge(const void* acc, const void* m, const void* l, void* out, int splits,
                         long long n_rows, int hd, int out_dtype, void* stream) {
  if (n_rows == 0) return 0;
  if (splits < 1 || hd <= 0 || hd % 4 != 0 || reinterpret_cast<uintptr_t>(acc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kWarps = 4;
  const dim3 grid(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* mm = static_cast<const float*>(m);
  const float* ll = static_cast<const float*>(l);
  if (out_dtype == kF32)
    chunk_merge_kernel<float><<<grid, kWarps * 32, 0, s>>>(a, mm, ll, static_cast<float*>(out),
                                                           splits, n_rows, hd);
  else if (out_dtype == kBF16)
    chunk_merge_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        a, mm, ll, static_cast<__nv_bfloat16*>(out), splits, n_rows, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
