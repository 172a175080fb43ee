// Ragged paged attention (W1) over a flat mixed prefill+decode batch, for bf16
// queries over bf16 and int8 pools, on the tensor cores of Hopper.
//
// Replaces the Pallas TPU kernel paged_ragged_attention of
// runbookai_tpu/ops/paged_attention_pallas.py:468, which runs the chunk kernel
// (_chunk_kernel) with q_block = ragged_block = 8 over the batch's 8-token
// blocks. f32 queries keep the CUDA-core chunk kernel of paged_attention.cu at
// [N / 8, 8] (ops/paged_attention.py ragged_tile_attention).
//
// What it computes. The batch is N tokens, q [N, n_q, HD]; each row's tokens
// are a contiguous run starting at a multiple of rq (8): decode slots first,
// one block each (one real token, seven pads), then the prefill rows, each
// padded to a multiple of rq; pad blocks belong to a null row (ctx 0). Query
// (token t, head h) of row r attends, with an online (flash) softmax in f32,
// over the first ctx_lens[r] cached tokens of the row, read through
// tables[r, p], causal over pos <= q_pos[b] + (t - b) where b is the first
// token of t's block (a pad token acts as a later query), kv-major GQA (head h
// reads kv head h / group). Masked probabilities are zeroed and l is clamped at
// 1e-30, so a pad block gives exactly zero. The plain version is
// plain_ragged_attention: each block's table row and context gathered, then
// plain_paged_attention.
//
// What bounds it on an H100: operations at the prefill shape. The serving
// configuration's mixed batch (8 decode rows at their contexts, a 512-token
// prefill at offset 4096; 32 query / 8 kv heads, head_dim 128) is about 37
// GFLOP of causal work, 0.037 ms at 989 TFLOP/s; its K/V are 18.9 MB (6 us at
// 3.35 TB/s). K2's kernel at [N / 8, 8] fed K/V tiles to 32-row blocks, each
// block walking its row's whole causal prefix: about 279k key visits per kv
// head, which at 512 bytes of K and V a key and kv head model 1.14 GB of loads
// a call (from L2 or device memory; no byte counter was read). Tiles of 128
// query rows cut the visits to about 70k (a model of 0.29 GB), and each K/V
// tile then feeds four times the tensor-core work. The design:
//
// - A tile list over runs (ragged_plan.cu, one launch; its plain version is
//   ops/paged_attention.py plain_ragged_plan), built once per forward on the
//   device from row_ids, ctx_lens and q_positions (no host sync) and reused by
//   every layer. A tile is (row, first token of the run, kv head, first row,
//   row count, key bound, split, split count, workspace slot), its rows
//   (token, group head) pairs of one run flattened kv-major: a prefill run
//   (two blocks or more) is cut into tiles of up to 128 rows (a group of 7
//   gives a last tile of fewer rows); a one-block run (a decode slot, a short
//   chunk, a pad block) is one tile of rq * group rows, the first 16 such
//   runs whose keys exceed keys_per_split split over key ranges of that many
//   keys, each with a workspace slot of its own. Tiles never straddle two
//   runs. The list is sorted
//   heaviest (most keys) first, stably, so the same inputs give the same list.
//   Its capacity, the split size and the CTA count are functions of shapes
//   only, so a CUDA graph can hold the launch.
// - Persistent CTAs, one per SM: each takes the next tile of the list from an
//   atomic counter until the list's live count, so the heavy prefill tiles
//   start first and the decode tiles fill the SMs as they free; the last CTA
//   to finish resets the counter. A tile's result does not depend on which
//   CTA computes it.
// - Warp specialisation: four producer warps keep a four-slot ring of 64-key
//   K/V tiles full with cp.async (16 bytes a thread, 16-token pages gathered
//   row by row through the table, keys past the bound zero-filled and never
//   read), arriving on each slot's mbarrier as its copies land; eight
//   consumer warps release a slot on a second mbarrier. cp.async rather than
//   TMA: a tensor map per pool needs cuTensorMapEncodeTiled from libcuda, and
//   four cp.async producer warps feed qmm.cu's wgmma kernel on this card
//   (PERF.md). Tiles are
//   stored [HD / 64][64 keys][128 bytes] with the 128-byte swizzle, the layout
//   wgmma reads and ldmatrix reads without bank conflicts.
// - Prefill tiles on wgmma: two consumer warpgroups own 64 query rows each and
//   share every K/V tile. S = Q K^T is m64n64k16 with Q and K in shared memory
//   (K-major); O += P V is m64n{HD}k16 with P in registers and V read
//   MN-major (transposed by the descriptor). P goes in as two bf16 parts (hi
//   and lo), as in chunk_attention.cu: one rounding of P fails the bf16 check
//   near zero outputs. Keys past the tile's last query position are never
//   visited; each row masks its own causal limit, and a warpgroup whose rows
//   see no key of a K/V tile skips it. Accumulators are touched by other
//   instructions only after the products' wait (ptxas serializes wgmma
//   otherwise).
// - One-block tiles on mma.sync (m16n8k16, fragments by ldmatrix): rq * group
//   rows (32 at a group of 4; 8 of them real in a decode block) would waste
//   most of a 64-row wgmma tile. The tile's 16-row warps (RW of them) times 8 /
//   RW key groups: key group kg takes the ring's tiles kg, kg + 8 / RW, ...;
//   the key groups' (m, l, O) combine in order through shared memory. A split
//   of a long row writes its f32 (acc, m, l) to its slot of the workspace, and
//   the last split to finish (an int32 counter per (slot, kv head)) merges them
//   in split order and resets the counter: one launch a call, no second merge
//   kernel.
// - int8 pools: the producers land each int8 tile with its scales, widen it to
//   bf16 (exact: |v| <= 127) into the ring slot, and arrive; each score
//   column is multiplied by k_scale[token, kv head] after Q K^T and
//   v_scale[token, kv head] is folded into P, as in chunk_attention.cu.
//
// Built with every source of csrc/ by runbookai_tpu_torch/ops/build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, one shared library,
// ctypes).

#include "attention_common.cuh"

namespace {

constexpr int kRing = 4;          // K/V slots in the ring
constexpr int kTileRows = 128;    // query rows of a prefill tile: two warpgroups of 64
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kProducers = 128;   // four producer warps
constexpr int kThreads = kConsumers + kProducers;
constexpr int kFields = 9;        // int32 fields of a tile record

struct RaggedArgs {
  const __nv_bfloat16* q;  // [N, n_q, HD]
  const void* k;           // [tokens, n_kv, HD], bf16 or int8
  const void* v;           // same
  const float* k_scale;    // [tokens, n_kv], int8 pools only
  const float* v_scale;    // same
  const int* tables;       // [R, P]
  const int* ctx_lens;     // [R]
  const int* q_pos;        // [N]
  const int* tiles;        // [capacity, kFields], the live ones first
  const int* live;         // [1]: live tiles
  __nv_bfloat16* out;      // [N, n_q, HD]
  float* ws;               // split partials: [(slot, kv head), split][rows][HD + 2]
  int* counters;           // [2 + split_runs * n_kv], 0 between launches
  int n_q, n_kv, ps, P, rq, keys_per_split, max_splits;
  float scale_log2;        // softmax scale times log2(e)
};

// One tile: rows [r0, r0 + nr) of row `row`'s run, which starts at token tok0
// (row r is token tok0 + r / group, head kvh * group + r % group), over keys
// [lo, hi); nsplits = 0 marks a prefill (wgmma) tile, else split `split` of a
// one-block tile, lo = split * keys_per_split, whose partials go to
// workspace slot `slot`.
struct Tile {
  int row, tok0, kvh, r0, nr, hi, split, nsplits, slot;
};

template <typename TKV, int HD>
struct RaggedSmem {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kQ = kTileRows * HD * 2;       // Q tile, bf16
  static constexpr int kKV = kKeys * HD * 2;          // one bf16 K or V tile
  static constexpr int kSlot = 2 * kKV;               // K, then V
  static constexpr int kRingBytes = kRing * kSlot;
  static constexpr int kScales = kInt8 ? kRing * 2 * kKeys * 4 : 0;      // per slot: k, v
  static constexpr int kLand = kInt8 ? 2 * kKeys * HD + 2 * kKeys * 4 : 0;  // int8 K, V, scales
  static constexpr int kBytes = kQ + kRingBytes + kScales + 2 * kLand;
  static constexpr int kAlloc = kBytes + 1024;        // slack to align the start to 1024
};

// Byte offset of 16-byte chunk `ch` (of HD / 8) of row `r` in a bf16 tile of
// ROWS rows stored [HD / 64][ROWS][128 bytes], each 128-byte row's chunks XORed
// with the row's low 3 bits: wgmma's 128-byte swizzle when the tile starts on a
// 1024-byte boundary, and conflict-free for ldmatrix.
template <int ROWS>
__device__ __forceinline__ int tile_off(int r, int ch) {
  return (ch >> 3) * (ROWS * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// Shared-memory descriptor of an MN-major bf16 tile (V read as P V's B
// operand, transposed): rows of 64 values (128 bytes) swizzled as tile_off
// lays them, 8-row groups along K 1024 bytes apart, 64-column blocks along N
// `lbo` bytes apart.
__device__ __forceinline__ uint64_t desc128_mn(const void* p, int lbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (m64 x n64) = a (m64 x k16, shared, K-major) * b (k16 x n64, shared,
// K-major) + (accumulate ? d : 0), f32.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n64) += a (m64 x k16, registers: the mma.sync A layout in each
// warp) * b (k16 x n64, shared, MN-major: transposed by the descriptor), f32.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same at n128 (head_dim 128).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared memory written by the generic proxy (cp.async, st.shared), next read by wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` over the first (id 1: the consumers) or last (id 2: the
// producers) `n` threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ Tile read_tile(const RaggedArgs& a, int item) {
  const int* f = a.tiles + static_cast<long long>(item) * kFields;
  return Tile{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
}

// Position of row `r` of the tile: its token's block start plus the token's
// place in the block.
__device__ __forceinline__ int row_pos(const RaggedArgs& a, const Tile& t, int group, int r) {
  const int tok = t.tok0 + (t.r0 + r) / group;
  return a.q_pos[tok - tok % a.rq] + tok % a.rq;
}

// Rows of a one-block tile in 16-row warps: RW = the power of two >= nr / 16.
__device__ __forceinline__ int row_warps(int nr) {
  const int w = (nr + 15) / 16;
  return w <= 1 ? 1 : w <= 2 ? 2 : w <= 4 ? 4 : 8;
}

// ------------------------------------------------------------------ producers

// Copy the tile's Q rows [0, rows) into q_s (rows past nr zero-filled).
template <int HD>
__device__ __forceinline__ void load_q(const RaggedArgs& a, const Tile& t, int group, int rows,
                                       char* q_s, int tid) {
  constexpr int kCh = HD / 8;
  for (int i = tid; i < rows * kCh; i += kProducers) {
    const int r = i / kCh, ch = i % kCh;
    const bool live = r < t.nr;
    const int rr = t.r0 + (live ? r : 0);
    const long long tok = t.tok0 + rr / group;
    const int head = t.kvh * group + rr % group;
    cp_async16(q_s + tile_off<kTileRows>(r, ch), a.q + (tok * a.n_q + head) * HD + ch * 8, live);
  }
}

// Start the copies of the 64 keys from pos0 (keys at or past hi zero-filled,
// their table entries not read): bf16 straight into a ring slot (K at dst, V
// at dst + kKV, swizzled), int8 into a landing tile (linear K, V, then the k
// and v scales).
template <typename TKV, int HD>
__device__ __forceinline__ void load_kv(const RaggedArgs& a, const int* table, int kvh, int pos0,
                                        int hi, char* dst, int tid) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kCh = HD * sizeof(TKV) / 16;  // 16-byte chunks per key row
  constexpr int kV = kInt8 ? kKeys * HD : kKeys * HD * 2;
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  for (int i = tid; i < kKeys * kCh; i += kProducers) {
    const int key = i / kCh, ch = i % kCh;
    const int pos = pos0 + key;
    const bool live = pos < hi;
    const long long row = live ? static_cast<long long>(table[pos / a.ps]) * a.ps + pos % a.ps : 0;
    const long long src = (row * a.n_kv + kvh) * HD * static_cast<long long>(sizeof(TKV)) + ch * 16;
    const int off = kInt8 ? key * HD + ch * 16 : tile_off<kKeys>(key, ch);
    cp_async16(dst + off, kp + src, live);
    cp_async16(dst + kV + off, vp + src, live);
  }
  if constexpr (kInt8) {
    float* sc = reinterpret_cast<float*>(dst + 2 * kKeys * HD);
    for (int key = tid; key < kKeys; key += kProducers) {
      const int pos = pos0 + key;
      const bool live = pos < hi;
      const long long idx =
          (live ? static_cast<long long>(table[pos / a.ps]) * a.ps + pos % a.ps : 0) * a.n_kv + kvh;
      cp_async4(sc + key, a.k_scale + idx, live);
      cp_async4(sc + kKeys + key, a.v_scale + idx, live);
    }
  }
}

// Widen a landed int8 tile (K, V, scales) into a ring slot and its scales.
template <int HD>
__device__ __forceinline__ void widen_landed(const char* land, char* slot, float* scales, int tid) {
  constexpr int kCh = HD / 16;  // 16 int8 values a chunk
  constexpr int kKV = kKeys * HD * 2;
  for (int i = tid; i < 2 * kKeys * kCh; i += kProducers) {
    const int tile = i / (kKeys * kCh), j = i % (kKeys * kCh);
    const int key = j / kCh, ch = j % kCh;
    const int4 raw = *reinterpret_cast<const int4*>(land + tile * kKeys * HD + key * HD + ch * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = pack_bf16(static_cast<float>(b[2 * e]),
                                                 static_cast<float>(b[2 * e + 1]));
    char* dst = slot + tile * kKV;
    *reinterpret_cast<int4*>(dst + tile_off<kKeys>(key, 2 * ch)) = make_int4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<int4*>(dst + tile_off<kKeys>(key, 2 * ch + 1)) =
        make_int4(w[4], w[5], w[6], w[7]);
  }
  const float* sc = reinterpret_cast<const float*>(land + 2 * kKeys * HD);
  for (int i = tid; i < 2 * kKeys; i += kProducers) scales[i] = sc[i];
}

// The producer warps' part of one tile: Q, then the n_tiles K/V tiles from
// lo, ring slots (base + it) % kRing.
template <typename TKV, int HD>
__device__ __forceinline__ void produce(const RaggedArgs& a, const Tile& t, int group, int lo,
                                        int n_tiles, int base, char* q_s, char* ring,
                                        float* scales, char* land, uint64_t* full,
                                        uint64_t* empty, uint64_t* qbar) {
  using S = RaggedSmem<TKV, HD>;
  const int tid = threadIdx.x - kConsumers;
  const int rows = t.nsplits == 0 ? kTileRows : 16 * row_warps(t.nr);
  load_q<HD>(a, t, group, rows, q_s, tid);
  mbar_arrive_cp_async(qbar);
  const int* table = a.tables + static_cast<long long>(t.row) * a.P;
  if constexpr (!S::kInt8) {
    for (int it = 0; it < n_tiles; ++it) {
      const int gi = base + it, slot = gi % kRing;
      if (gi >= kRing) mbar_wait(&empty[slot], (gi / kRing - 1) & 1);
      load_kv<TKV, HD>(a, table, t.kvh, lo + it * kKeys, t.hi, ring + slot * S::kSlot, tid);
      mbar_arrive_cp_async(&full[slot]);
    }
  } else {
    cp_async_commit();  // Q's copies: a group of their own
    if (n_tiles > 0) load_kv<TKV, HD>(a, table, t.kvh, lo, t.hi, land, tid);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      const int gi = base + it, slot = gi % kRing;
      if (it + 1 < n_tiles)
        load_kv<TKV, HD>(a, table, t.kvh, lo + (it + 1) * kKeys, t.hi,
                         land + ((it + 1) & 1) * S::kLand, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of tile it landed
      bar_sync(2, kProducers);  // and every producer's
      if (gi >= kRing) mbar_wait(&empty[slot], (gi / kRing - 1) & 1);
      widen_landed<HD>(land + (it & 1) * S::kLand, ring + slot * S::kSlot,
                       scales + slot * 2 * kKeys, tid);
      fence_async_smem();
      mbar_arrive(&full[slot]);
      bar_sync(2, kProducers);  // landing tile it & 1 is free for tile it + 2
    }
  }
}

// ------------------------------------------------------------------ consumers

// Online softmax of one 64-key tile over a thread's two rows (hr 0: row g,
// hr 1: row g + 8) of 16-row mma fragments: s[j][2 hr + e] is key 8 j + 2 c +
// e. Scores are scaled (and multiplied by the keys' k scales over int8 pools),
// masked at keys pos >= lim[hr], and replaced by p (times the v scales);
// alpha[hr] is the running sums' correction.
template <bool INT8>
__device__ __forceinline__ void softmax_tile(float (*s)[4], int pos0, const int (&lim)[2],
                                             const float* sc, float scale_log2, float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * c + e;
        float x = s[j][2 * hr + e] * scale_log2;
        if constexpr (INT8) x *= sc[key];
        x = pos0 + key < lim[hr] ? x : kNegInf;
        s[j][2 * hr + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m2[hr], mx);
    alpha[hr] = exp2f(m2[hr] - m_new);
    m2[hr] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * c + e;
        const float p = pos0 + key < lim[hr] ? exp2f(s[j][2 * hr + e] - m_new) : 0.f;
        sum += p;
        s[j][2 * hr + e] = INT8 ? p * sc[kKeys + key] : p;  // v_scale folded in
      }
    }
    l[hr] = l[hr] * alpha[hr] + sum;
  }
}

// A prefill tile: warpgroup wg owns rows [64 wg, 64 wg + 64) on wgmma.
template <typename TKV, int HD>
__device__ __forceinline__ void consume_wgmma(const RaggedArgs& a, const Tile& t, int group,
                                              int n_tiles, int base, int qphase, const char* q_s,
                                              const char* ring, const float* scales,
                                              uint64_t* full, uint64_t* empty, uint64_t* qbar) {
  using S = RaggedSmem<TKV, HD>;
  constexpr int kNb = HD / 8;  // n8 blocks of O
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane >> 2, c = lane & 3;
  const int row_base = 64 * wg + 16 * (warp % 4) + g;

  // Keys pos < lim[hr] are live for rows row_base + 8 hr; a warpgroup's last
  // row has its largest limit.
  int lim[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row_base + 8 * hr;
    lim[hr] = r < t.nr ? min(t.hi, row_pos(a, t, group, r) + 1) : 0;
  }
  const int wg_lim =
      64 * wg < t.nr ? min(t.hi, row_pos(a, t, group, min(64 * wg + 63, t.nr - 1)) + 1) : 0;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the running sum
  mbar_wait(qbar, qphase);
  const char* q_wg = q_s + wg * 64 * 128;  // this warpgroup's rows in each 64-column block

  for (int it = 0; it < n_tiles; ++it) {
    const int gi = base + it, slot = gi % kRing;
    mbar_wait(&full[slot], (gi / kRing) & 1);
    const int pos0 = it * kKeys;
    if (pos0 < wg_lim) {  // uniform over the warpgroup
      fence_async_smem();
      const char* k_s = ring + slot * S::kSlot;
      const char* v_s = k_s + S::kKV;
      float s[kKeys / 2];  // s[4 j + 2 hr + e]: key 8 j + 2 c + e of row hr
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)  // 16 of the head dim a step, 32 bytes
        wgmma_ss_n64(s, desc128(q_wg + (ks >> 2) * kTileRows * 128) + 2 * (ks & 3),
                     desc128(k_s + (ks >> 2) * kKeys * 128) + 2 * (ks & 3), ks > 0);
      wgmma_commit_wait();
      fence_acc(s);
      float alpha[2];
      softmax_tile<S::kInt8>(reinterpret_cast<float(*)[4]>(s), pos0, lim,
                             scales + slot * 2 * kKeys, a.scale_log2, m2, l, alpha);
      uint32_t ph[4][4], pl[4][4];  // P of keys [16 kk, 16 kk + 16) as A fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_bf16(s[8 * kk + 0], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split_bf16(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
        split_bf16(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
        split_bf16(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step, 2048 bytes of V
        const uint64_t dv = desc128_mn(v_s + kk * 16 * 128, kKeys * 128);
        if constexpr (HD == 128) {
          wgmma_rs_n128(o, ph[kk], dv);
          wgmma_rs_n128(o, pl[kk], dv);
        } else {
          wgmma_rs_n64(o, ph[kk], dv);
          wgmma_rs_n64(o, pl[kk], dv);
        }
      }
      wgmma_commit_wait();
      fence_acc(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int r = row_base + 8 * hr;
    if (r >= t.nr) continue;
    const int rr = t.r0 + r;
    const long long tok = t.tok0 + rr / group;
    __nv_bfloat16* dst = a.out + (tok * a.n_q + t.kvh * group + rr % group) * HD;
    const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int j = 0; j < kNb; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * c) =
          __floats2bfloat162_rn(o[4 * j + 2 * hr] / den, o[4 * j + 2 * hr + 1] / den);
  }
}

// A one-block tile (split `split` of its keys): 16-row warp rw = warp % RW,
// key group kg = warp / RW on the ring tiles it with it % (8 / RW) == kg,
// mma.sync; the key groups combine in order, then the splits merge in order.
template <typename TKV, int HD>
__device__ __forceinline__ void consume_mma(const RaggedArgs& a, const Tile& t, int group, int lo,
                                            int n_tiles, int base, int qphase, const char* q_s,
                                            char* ring, const float* scales, uint64_t* full,
                                            uint64_t* empty, uint64_t* qbar, int* s_last) {
  using S = RaggedSmem<TKV, HD>;
  constexpr int kKs = HD / 16;  // k-steps of Q K^T
  constexpr int kNb = HD / 8;   // n8 blocks of O
  constexpr int kSb = kKeys / 8;
  constexpr int kStride = HD + 4;  // floats a row of the combine area
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int rw_n = row_warps(t.nr), kg_n = kConsumerWarps / rw_n;
  const int rw = warp % rw_n, kg = warp / rw_n;

  int lim[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * rw + g + 8 * hr;
    lim[hr] = r < t.nr ? min(t.hi, row_pos(a, t, group, r) + 1) : lo;
  }

  mbar_wait(qbar, qphase);
  uint32_t qf[kKs][4];
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    const int mat = lane >> 3;
    ldmatrix_x4(qf[ks], q_s + tile_off<kTileRows>(16 * rw + (lane & 7) + (mat & 1) * 8,
                                                  2 * ks + (mat >> 1)));
  }
  float o[kNb][4];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m2[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int gi = base + it, slot = gi % kRing;
    mbar_wait(&full[slot], (gi / kRing) & 1);
    const int pos0 = lo + it * kKeys;
    if (it % kg_n == kg && __any_sync(0xffffffffu, pos0 < lim[0] || pos0 < lim[1])) {
      const char* k_s = ring + slot * S::kSlot;
      const char* v_s = k_s + S::kKV;
      float s[kSb][4];
#pragma unroll
      for (int j = 0; j < kSb; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
        for (int jj = 0; jj < kSb / 2; ++jj) {
          uint32_t kb[4];
          const int mat = lane >> 3;
          ldmatrix_x4(kb, k_s + tile_off<kKeys>(16 * jj + (lane & 7) + (mat >> 1) * 8,
                                                2 * ks + (mat & 1)));
          mma_bf16(s[2 * jj], qf[ks], kb[0], kb[1]);
          mma_bf16(s[2 * jj + 1], qf[ks], kb[2], kb[3]);
        }
      }
      float alpha[2];
      softmax_tile<S::kInt8>(s, pos0, lim, scales + slot * 2 * kKeys, a.scale_log2, m2, l, alpha);
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        o[nb][0] *= alpha[0];
        o[nb][1] *= alpha[0];
        o[nb][2] *= alpha[1];
        o[nb][3] *= alpha[1];
      }
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
          ldmatrix_x4_trans(vb, v_s + tile_off<kKeys>(16 * kk + (lane & 7) + (mat & 1) * 8,
                                                      2 * dd + (mat >> 1)));
          mma_bf16(o[2 * dd], ph, vb[0], vb[1]);
          mma_bf16(o[2 * dd], pl, vb[0], vb[1]);
          mma_bf16(o[2 * dd + 1], ph, vb[2], vb[3]);
          mma_bf16(o[2 * dd + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // The key groups' (m, l, O) into the idle ring, [kg][16 RW rows].
  bar_sync(1, kConsumers);  // every consumer is done with the ring
  float* cm = reinterpret_cast<float*>(ring);
  float* cl = cm + kTileRows;
  float* co = cl + kTileRows;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int idx = kg * 16 * rw_n + 16 * rw + g + 8 * hr;
    if (c == 0) {
      cm[idx] = m2[hr];
      cl[idx] = l[hr];
    }
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
      *reinterpret_cast<float2*>(co + idx * kStride + 8 * nb + 2 * c) =
          make_float2(o[nb][2 * hr], o[nb][2 * hr + 1]);
  }
  bar_sync(1, kConsumers);

  // Row r: M = max over key groups, weights 2^(m_kg - M), in key-group order.
  const int rows = 16 * rw_n;
  const long long slot_id = static_cast<long long>(t.slot) * a.n_kv + t.kvh;
  const int n_rows = t.nr;  // rq * group: the split partials' rows
  float* part = a.ws + (slot_id * a.max_splits + t.split) * n_rows * (HD + 2);
  for (int i = threadIdx.x; i < t.nr * (HD / 4); i += kConsumers) {
    const int r = i / (HD / 4), d = 4 * (i % (HD / 4));
    float mx = kNegInf;
    for (int k = 0; k < kg_n; ++k) mx = fmaxf(mx, cm[k * rows + r]);
    float den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < kg_n; ++k) {
      const float w = exp2f(cm[k * rows + r] - mx);
      den += cl[k * rows + r] * w;
      const float4 x = *reinterpret_cast<const float4*>(co + (k * rows + r) * kStride + d);
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    if (t.nsplits == 1) {
      const int rr = t.r0 + r;
      const long long tok = t.tok0 + rr / group;
      __nv_bfloat16* dst = a.out + (tok * a.n_q + t.kvh * group + rr % group) * HD + d;
      const float inv = 1.f / fmaxf(den, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
          __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    } else {
      *reinterpret_cast<float4*>(part + r * HD + d) = acc;
      if (d == 0) {
        part[n_rows * HD + r] = mx;
        part[n_rows * HD + n_rows + r] = den;
      }
    }
  }
  if (t.nsplits == 1) return;

  // The last split of this (slot, kv head) to finish merges the splits in
  // split order and resets the counter.
  __threadfence();
  bar_sync(1, kConsumers);
  int* counter = a.counters + 2 + slot_id;
  if (threadIdx.x == 0) *s_last = atomicAdd(counter, 1) == t.nsplits - 1;
  bar_sync(1, kConsumers);
  if (!*s_last) return;
  __threadfence();
  const float* parts = a.ws + slot_id * a.max_splits * n_rows * (HD + 2);
  const long long stride = static_cast<long long>(n_rows) * (HD + 2);  // one split's partial
  for (int i = threadIdx.x; i < t.nr * (HD / 4); i += kConsumers) {
    const int r = i / (HD / 4), d = 4 * (i % (HD / 4));
    float mx = kNegInf;
    for (int sp = 0; sp < t.nsplits; ++sp)
      mx = fmaxf(mx, __ldcg(parts + sp * stride + n_rows * HD + r));
    float den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < t.nsplits; ++sp) {
      const float* p = parts + sp * stride;
      const float w = exp2f(__ldcg(p + n_rows * HD + r) - mx);
      if (w == 0.f) continue;
      den += __ldcg(p + n_rows * HD + n_rows + r) * w;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p + r * HD + d));
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    const int rr = t.r0 + r;
    const long long tok = t.tok0 + rr / group;
    __nv_bfloat16* dst = a.out + (tok * a.n_q + t.kvh * group + rr % group) * HD + d;
    const float inv = 1.f / fmaxf(den, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

// Persistent: each CTA takes tiles from the list until its live count.
template <typename TKV, int HD>
__global__ void __launch_bounds__(kThreads, 1) ragged_attention_kernel(const RaggedArgs a) {
  using S = RaggedSmem<TKV, HD>;
  extern __shared__ __align__(1024) char smem_raw[];
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing], qbar;
  __shared__ int s_item, s_last;
  // The descriptors' swizzle is anchored at 1024-byte boundaries of the address.
  char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  char* q_s = smem;
  char* ring = smem + S::kQ;
  float* scales = reinterpret_cast<float*>(ring + S::kRingBytes);
  char* land = ring + S::kRingBytes + S::kScales;
  const int group = a.n_q / a.n_kv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], kProducers);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(&qbar, kProducers);
  }
  __syncthreads();
  const int live = *a.live;
  int base = 0;  // ring tiles this CTA has streamed
  for (int items = 0;; ++items) {
    if (threadIdx.x == 0) s_item = atomicAdd(a.counters, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= live) break;
    const Tile t = read_tile(a, item);
    const int lo = t.nsplits > 0 ? t.split * a.keys_per_split : 0;
    const int n_tiles = t.hi > lo ? (t.hi - lo + kKeys - 1) / kKeys : 0;
    if (threadIdx.x >= kConsumers)
      produce<TKV, HD>(a, t, group, lo, n_tiles, base, q_s, ring, scales, land, full, empty, &qbar);
    else if (t.nsplits == 0)
      consume_wgmma<TKV, HD>(a, t, group, n_tiles, base, items & 1, q_s, ring, scales, full,
                             empty, &qbar);
    else
      consume_mma<TKV, HD>(a, t, group, lo, n_tiles, base, items & 1, q_s, ring, scales, full,
                           empty, &qbar, &s_last);
    base += n_tiles;
    __syncthreads();  // the tile is done: Q, the ring and s_item are free
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(a.counters + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      a.counters[0] = 0;  // ready for the next launch
      a.counters[1] = 0;
    }
  }
}

template <typename TKV, int HD>
int launch(const RaggedArgs& a, int ctas, cudaStream_t stream) {
  constexpr int kSmem = RaggedSmem<TKV, HD>::kAlloc;
  auto kernel = ragged_attention_kernel<TKV, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ctas, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q [N, n_q, hd] bf16; k, v [tokens, n_kv, hd] bf16 (kv_dtype 1) or int8
// (kv_dtype 2, with k_scale / v_scale [tokens, n_kv] f32); tables [R, P],
// ctx_lens [R], q_pos [N] int32; tiles [capacity, 9] and live [1] int32 from
// rb_ragged_plan; out [N, n_q, hd] bf16. ws holds split_runs * n_kv *
// max_splits * rq * group * (hd + 2) f32 and counters 2 + split_runs * n_kv
// int32 zeros (left zero). `ctas` persistent blocks. Returns cudaGetLastError() of the launch.
int rb_paged_ragged_attention(const void* q, const void* k, const void* v, const void* k_scale,
                              const void* v_scale, const void* tables, const void* ctx_lens,
                              const void* q_pos, const void* tiles, const void* live, void* out,
                              void* ws, void* counters, int ctas, int n_q, int n_kv, int hd,
                              int ps, int P, int rq, int keys_per_split, int max_splits,
                              float scale, int kv_dtype, void* stream) {
  if (ctas == 0) return 0;
  if (ctas < 0 || n_kv <= 0 || n_q % n_kv != 0 || ps <= 0 || P <= 0 || rq <= 0 ||
      rq * (n_q / n_kv) > kTileRows || keys_per_split <= 0 || keys_per_split % kKeys != 0 ||
      max_splits <= 0 || ws == nullptr || counters == nullptr || tiles == nullptr ||
      live == nullptr || (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(ws))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const RaggedArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                     static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                     static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
                     static_cast<const int*>(q_pos), static_cast<const int*>(tiles),
                     static_cast<const int*>(live), static_cast<__nv_bfloat16*>(out),
                     static_cast<float*>(ws), static_cast<int*>(counters), n_q, n_kv, ps, P, rq,
                     keys_per_split, max_splits, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kBF16 && hd == 64) return launch<__nv_bfloat16, 64>(a, ctas, s);
  if (kv_dtype == kBF16 && hd == 128) return launch<__nv_bfloat16, 128>(a, ctas, s);
  if (kv_dtype == kI8 && hd == 64) return launch<int8_t, 64>(a, ctas, s);
  if (kv_dtype == kI8 && hd == 128) return launch<int8_t, 128>(a, ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
