// The tile list of ragged paged attention (W1, ragged_attention.cu) for one
// flat mixed batch, built on the device in one launch of one CTA.
//
// Takes the place of the per-block row gather by which the Pallas TPU kernel
// paged_ragged_attention (runbookai_tpu/ops/paged_attention_pallas.py:468)
// maps the batch onto the chunk kernel's grid: the ragged kernel walks a list
// of tiles over the batch's runs instead of fixed 8-token blocks. The plain
// version is plain_ragged_plan in ops/paged_attention.py; this kernel writes
// the same records, in the same order, bit for bit.
//
// What it computes. Blocks of rq tokens next to each other with the same row
// (row_ids[b * rq]) form a run. A run's key bound is min(ctx_lens[row],
// key_max, q_pos of its last block + rq) (at least 0). A run of one block is
// one tile of rq * group rows; the first split_runs such runs (in block order)
// whose bound exceeds keys_per_split are cut into ceil(bound /
// keys_per_split) splits over key ranges, each run with the workspace slot of
// its rank among them. A longer run is cut into tiles of up to 128 rows, each
// keyed up to its last row's position + 1. Each tile's weight is the keys it
// walks. The records are sorted by weight, heaviest first, stably (the run
// order breaks ties), and each is written for every kv head (head fastest);
// the records past the live count are zero with weight -1.
//
// What bounds it on an H100: nothing of the card's rates. It reads the
// blocks' first row id and position and the rows' contexts and writes
// capacity * 40 bytes (65 KB at the serving configuration's mixed batch,
// 20 ns at 3.35 TB/s); its time is the launch and a few shared-memory passes.
// It replaces about 120 small tensor ops a forward (plain_ragged_plan), which
// cost the host more than the card.
//
// The design: one CTA of 512 threads. The blocks' rows and positions are
// loaded into shared memory; each block that starts a run measures the run
// and its bound; warp 0 ranks the wide one-block runs and then sums the tile
// counts (exclusive prefix sums, 32 at a time with shuffles); each run writes
// its tiles' weights at its offset; each live tile then counts the tiles
// heavier than it, and the earlier ones as heavy, which is its place in the
// sorted list, and writes its records there. The count of tiles is at most
// capacity / n_kv (a few hundred at the serving shape), so the quadratic rank
// costs each thread a few hundred shared-memory reads, and the order does not
// depend on scheduling.
//
// Built with every source of csrc/ by runbookai_tpu_torch/ops/build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, one shared library,
// ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 9;      // int32 fields of a tile record (ragged_attention.cu's)
constexpr int kTileRows = 128;  // query rows of a prefill tile
constexpr int kThreads = 512;
constexpr int kMaxSmem = 227 * 1024;

struct PlanArgs {
  const int* row_ids;   // [N]
  const int* q_pos;     // [N]
  const int* ctx_lens;  // [R]
  int* tiles;           // [per_head * n_kv, kFields]
  int* live;            // [1]
  int* weight;          // [per_head * n_kv]
  int nb, rq, group, n_kv, key_max, keys_per_split, split_runs, per_head;
};

// Exclusive prefix sum of v[0, n) in place, by warp 0; every thread gets the
// total.
__device__ int exclusive_scan(int* v, int n, int* s_total) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const int x = i < n ? v[i] : 0;
      int inc = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
      }
      if (i < n) v[i] = carry + inc - x;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) *s_total = carry;
  }
  __syncthreads();
  return *s_total;
}

// The per-block arrays in shared memory; a run's values sit at its first block.
struct Blocks {
  int* row;    // row of the block
  int* pos;    // position of the block's first token
  int* len;    // blocks of the run (0: not a run's first block)
  int* hi;     // key bound of the run
  int* slot;   // rank among the wide one-block runs
  int* count;  // tiles of the run
  int* off;    // first tile of the run
};

// Fields and weight of tile `loc` of the run that starts at block b.
__device__ void tile_record(const PlanArgs& a, const Blocks& s, int b, int loc, int* f,
                            int* weight) {
  const int len = s.len[b], row = s.row[b], count = s.count[b];
  f[0] = row;
  f[1] = b * a.rq;
  f[2] = 0;
  if (len == 1) {
    const bool split = count > 1;
    const int lo = split ? loc * a.keys_per_split : 0;
    f[3] = 0;
    f[4] = a.rq * a.group;
    f[5] = split ? min(s.hi[b], (loc + 1) * a.keys_per_split) : s.hi[b];
    f[6] = split ? loc : 0;
    f[7] = count;
    f[8] = split ? s.slot[b] : 0;
    *weight = f[5] - lo;
    return;
  }
  const int r0 = loc * kTileRows;
  const int nr = min(kTileRows, len * a.rq * a.group - r0);
  const int tok_last = (r0 + nr - 1) / a.group;  // the tile's last token, within the run
  const int pos_last = s.pos[b + tok_last / a.rq] + tok_last % a.rq;
  f[3] = r0;
  f[4] = nr;
  f[5] = max(0, min(min(a.ctx_lens[row], a.key_max), pos_last + 1));
  f[6] = f[7] = f[8] = 0;
  *weight = f[5];
}

__global__ void __launch_bounds__(kThreads) ragged_plan_kernel(const PlanArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_total;
  const int nb = a.nb, tid = threadIdx.x;
  Blocks s;
  s.row = smem;
  s.pos = s.row + nb;
  s.len = s.pos + nb;
  s.hi = s.len + nb;
  s.slot = s.hi + nb;
  s.count = s.slot + nb;
  s.off = s.count + nb;
  int* w = s.off + nb;        // [per_head] weight of tile i (run order)
  int* tb = w + a.per_head;   // its run's first block
  int* tl = tb + a.per_head;  // its place in the run

  for (int b = tid; b < nb; b += kThreads) {
    s.row[b] = a.row_ids[b * a.rq];
    s.pos[b] = a.q_pos[b * a.rq];
  }
  __syncthreads();
  // A block whose row differs from the previous block's starts a run.
  for (int b = tid; b < nb; b += kThreads) {
    int len = 0, hi = 0;
    if (b == 0 || s.row[b] != s.row[b - 1]) {
      len = 1;
      while (b + len < nb && s.row[b + len] == s.row[b]) ++len;
      const int key_cap = min(a.ctx_lens[s.row[b]], a.key_max);
      hi = max(0, min(key_cap, s.pos[b + len - 1] + a.rq));
    }
    s.len[b] = len;
    s.hi[b] = hi;
    s.slot[b] = len == 1 && hi > a.keys_per_split;  // a wide one-block run
  }
  __syncthreads();
  exclusive_scan(s.slot, nb, &s_total);
  for (int b = tid; b < nb; b += kThreads) {
    const int len = s.len[b], hi = s.hi[b];
    int count = 0;
    if (len == 1)
      count = hi > a.keys_per_split && s.slot[b] < a.split_runs
                  ? (hi + a.keys_per_split - 1) / a.keys_per_split
                  : 1;
    else if (len > 1)
      count = (len * a.rq * a.group + kTileRows - 1) / kTileRows;
    s.count[b] = count;
    s.off[b] = count;
  }
  __syncthreads();
  const int total = exclusive_scan(s.off, nb, &s_total);
  for (int b = tid; b < nb; b += kThreads) {
    int f[kFields];
    for (int loc = 0; loc < s.count[b]; ++loc) {
      const int i = s.off[b] + loc;
      tile_record(a, s, b, loc, f, &w[i]);
      tb[i] = b;
      tl[i] = loc;
    }
  }
  __syncthreads();
  // Tile i's place in the list: the tiles heavier than it, and the earlier
  // ones as heavy.
  for (int i = tid; i < a.per_head; i += kThreads) {
    int f[kFields] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    int wi = -1, place = i;
    if (i < total) {
      wi = w[i];
      place = 0;
      for (int j = 0; j < total; ++j) {
        const int wj = w[j];
        place += wj > wi || (wj == wi && j < i);
      }
      tile_record(a, s, tb[i], tl[i], f, &wi);
    }
    for (int h = 0; h < a.n_kv; ++h) {
      const long long idx = static_cast<long long>(place) * a.n_kv + h;
      int* dst = a.tiles + idx * kFields;
      for (int k = 0; k < kFields; ++k) dst[k] = f[k];
      if (i < total) dst[2] = h;
      a.weight[idx] = wi;
    }
  }
  if (tid == 0) *a.live = total * a.n_kv;
}

size_t plan_smem(int nb, int per_head) { return (7 * static_cast<size_t>(nb) + 3 * per_head) * 4; }

}  // namespace

extern "C" {

// row_ids, q_pos [nb * rq] and ctx_lens [R] int32 (every row id below R);
// tiles [per_head * n_kv, 9], live [1] and weight [per_head * n_kv] int32
// written. key_max is the table's width in keys (P * page_size); per_head
// bounds the live tiles of one kv head (ops/paged_attention.py
// ragged_shape). Returns cudaGetLastError() of the launch.
int rb_ragged_plan(const void* row_ids, const void* q_pos, const void* ctx_lens, void* tiles,
                   void* live, void* weight, int nb, int rq, int group, int n_kv, int key_max,
                   int keys_per_split, int split_runs, int per_head, void* stream) {
  if (nb <= 0 || rq <= 0 || group <= 0 || n_kv <= 0 || key_max < 0 || keys_per_split <= 0 ||
      split_runs < 0 || per_head < nb || row_ids == nullptr || q_pos == nullptr ||
      ctx_lens == nullptr || tiles == nullptr || live == nullptr || weight == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = plan_smem(nb, per_head);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ragged_plan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const PlanArgs a{static_cast<const int*>(row_ids), static_cast<const int*>(q_pos),
                   static_cast<const int*>(ctx_lens), static_cast<int*>(tiles),
                   static_cast<int*>(live), static_cast<int*>(weight), nb, rq, group, n_kv,
                   key_max, keys_per_split, split_runs, per_head};
  ragged_plan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
