// Int8 weight-only matmul of the decode and verify forwards, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel qmm_pallas (runbookai_tpu/ops/qmm_pallas.py, _qmm_kernel):
//
//   rb_qmm_int8:  out[M, N] = (x[M, K] @ widen(q[K, N])) * s[1, N]
//
// x is bfloat16 or float32, q int8 and row-major, s one float32 scale per output channel
// (runbookai_tpu_torch/models/quant.py). Sums are float32; the scale multiplies each
// finished sum once and the result is rounded once to x's type. M <= 256, K a multiple of
// 32, N a multiple of 128 (ops/qmm.py qmm_eligible, the JAX package's
// qmm_pallas_eligible).
//
// What bounds it on an H100: the bytes of q. One layer's seven products of the 8B read
// 218.1 MB of int8 weights, 0.065 ms at 3.35 TB/s; at M = 64 (a T = 8 verify of 8 slots)
// they are 27.9 GFLOP, 0.028 ms on the bf16 tensor cores. So each weight byte is read
// from device memory once, for every row of x, and widened on its way into the tensor
// cores:
//
// - int8 widened exactly to bf16 (|q| <= 127; each bf16 product is exact in f32, so only
//   the order of the f32 sums differs from the plain version). ldmatrix.trans reads the
//   landed int8 tile as 16-bit pairs of neighbouring channels, so a lane receives channels
//   (2g, 2g + 1) at K rows (2c, 2c + 1) in one 32-bit word; taking the mma's A row g to be
//   channel 2g and row g + 8 channel 2g + 1 makes that word the lane's a0 and a1 (a2, a3
//   from the next 8 rows of K) after two byte permutes. Each byte is widened by the float
//   trick 0x4B0000uu - (2^23 + 128) on the byte biased by 0x80, and the bf16 is the
//   float's upper half. The A side of the product is thus the output channels and its B
//   side the rows of x (out^T = q^T x^T): M = 8 fills an n8 tile with no padding.
// - A block owns a column tile of 128 channels (64 on the wgmma route where N has fewer
//   than 16 tiles of 128, as the 8B's wk and wv) over one slice of K, and every row of x.
//   Tiles of 64 rows of K stream through a four-slot cp.async ring, q in int8 (half the
//   bytes of a bf16 copy) and x's rows of the same K in bf16, both XOR-swizzled in
//   16-byte chunks (for ldmatrix, and as wgmma's 128-byte swizzle); rows of K past the
//   slice and rows of x past M are zero-filled.
// - Two routes by M (ops/qmm.py qmm_route):
//   * M <= 8 (decode), mma.sync (qmm_mma_kernel): 4 column warps of 32 channels times 2
//     K warps, each on one 32-row half of every stage; the halves' sums are added at the
//     end. Bound by the weight stream: small blocks, four to an SM, one barrier a stage.
//   * M > 8 (verify, short prefill), wgmma (qmm_wgmma_kernel<WG, RG>): m64n64k16 with the
//     widened A fragments in registers and each group of 64 rows of x (RG groups, padded
//     with zeros) read from the x tile in shared memory. Warp-specialised: a producer
//     warpgroup fills the ring and arrives on each slot's mbarrier when its copies land
//     (one producer warp could not issue the copies fast enough; four were fastest on
//     the card); the consumer warpgroups (64 channels each) widen, run the slot's wgmmas,
//     and release the slot on a second mbarrier. No block-wide barrier in the loop. The
//     accumulators are written by the wgmmas alone (the first product overwrites them),
//     which keeps ptxas from serializing them. Every column tile reads all of x from L2,
//     so at M = 256 the x traffic is four times the weights'.
// - Split over K, merged in the same launch in split order. A plan from shapes alone
//   (ops/qmm.py qmm_plan) cuts K into slices of whole 32-row units so that the column
//   tiles times the splits fill the 132 SMs. With one split a block scales and writes the
//   output. With several, each writes its f32 partial tile to the workspace,
//   __threadfence()s and bumps an int32 counter per column tile; the block that brings it
//   to the split count adds the partials in split order (the same inputs give the same
//   bits, whichever block finishes last), applies s, writes the output and resets the
//   counter to 0. No float atomics. The workspace and counters belong to the wrapper
//   (cached per device and stream, shared with the attention kernels); a call allocates
//   nothing but its output.
//
// f32 x keeps a CUDA-core kernel (the forward's f32 checks on the card): a block owns 8
// rows x 128 output columns over one slice of K; its 8 warps take the slice's rows of q in
// turn, lane l reading 4 neighbouring int8 weights with one 32-bit load; the slice's x
// rows are staged in shared memory 256 columns at a time. It uses the same plan,
// workspace and in-launch merge, with one counter per (row tile, column tile).
//
// Measured on an H100 in PERF.md (chip_smoke.py's qmm_kernel phase). Built with every
// source of csrc/ by runbookai_tpu_torch/ops/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3, one shared library, ctypes).

#include "attention_common.cuh"

namespace {

constexpr int kTileN = 128;  // output channels a block
constexpr int kTileK = 64;   // rows of K a stage
constexpr int kStages = 4;   // slots in a cp.async ring
constexpr int kQBytes = kTileK * kTileN;

struct QmmArgs {
  const void* x;        // [M, K]
  const int8_t* q;      // [K, N]
  const float* s;       // [N]
  void* out;            // [M, N], x's type
  float* ws;            // [N / tile_n, splits, M, tile_n] f32 split partials
  int* counters;        // [N / tile_n] (f32: [ceil(M / 8), N / 128]), 0 between launches
  int M, K, N, k_slice, splits;
};

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte rows, the chunk
// XORed with the row's low 3 bits: the 128-byte swizzle of wgmma's shared-memory operands
// when the tile starts on a 1024-byte boundary.
__device__ __forceinline__ int swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Byte offset of 16-byte chunk `chunk` of K row `r` in a q tile of TILE_N-byte rows (128
// or 64): swz128 over 128-byte lines, which hold one row or two.
template <int TILE_N>
__device__ __forceinline__ int q_offset(int r, int chunk) {
  constexpr int kPerLine = 128 / TILE_N;
  return swz128(r / kPerLine, (r % kPerLine) * (TILE_N / 16) + chunk);
}

// A 32-bit word of an int8 tile read by ldmatrix.trans holds channels (2g, 2g + 1) at K
// rows (k, k + 1) as bytes [q(k, 2g), q(k, 2g + 1), q(k + 1, 2g), q(k + 1, 2g + 1)].
// Returns the bf16 pairs (k, k + 1) of channel 2g (even) and of channel 2g + 1 (odd).
__device__ __forceinline__ void widen_pairs(uint32_t w, uint32_t& even, uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;  // v + 128 in each byte
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// The A fragments (m16 x k16, the mma's row g = channel c0 + 2g, row g + 8 = c0 + 2g + 1)
// of 16 channels starting at chunk `chunk` (c0 = 16 chunk) over K rows [k0, k0 + 32) of a
// landed int8 q tile, widened to bf16: af[0] for rows k0..k0 + 15, af[1] for the next 16.
template <int TILE_N>
__device__ __forceinline__ void a_fragments(const char* qs, int k0, int chunk, int lane,
                                            uint32_t (&af)[2][4]) {
  uint32_t r[4];  // matrix i: K rows k0 + 8 i + (0..7)
  ldmatrix_x4_trans(r, qs + q_offset<TILE_N>(k0 + lane, chunk));
  widen_pairs(r[0], af[0][0], af[0][1]);
  widen_pairs(r[1], af[0][2], af[0][3]);
  widen_pairs(r[2], af[1][0], af[1][1]);
  widen_pairs(r[3], af[1][2], af[1][3]);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// d += a (m16 x k16, row) * b (k16 x n8, col); bf16 in, f32 accumulate. Not volatile (a
// pure function of registers), so the compiler may issue the next fragment loads first.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copies of one stage: q rows [k0, k0 + 64) x channels [n0, n0 + TILE_N), then
// x rows [0, ROWS_X) at the same K, each 128-byte row swizzled (q rows of 64 bytes: two to
// a 128-byte row); rows of K at or past k_end and rows of x at or past M are zero-filled.
template <int TILE_N, int ROWS_X, int THREADS>
__device__ __forceinline__ void load_stage(const QmmArgs& a, char* stage, int k0, int k_end,
                                           int n0, int tid) {
  constexpr int kChunks = TILE_N / 16;  // 16-byte chunks a q row
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  for (int i = tid; i < kTileK * kChunks; i += THREADS) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool live = k0 + r < k_end;
    cp_async16(stage + q_offset<TILE_N>(r, ch),
               a.q + static_cast<long long>(live ? k0 + r : k0) * a.N + n0 + ch * 16, live);
  }
  char* xs = stage + kTileK * TILE_N;
  for (int i = tid; i < ROWS_X * 8; i += THREADS) {
    const int r = i / 8, ch = i % 8;
    const bool live = r < a.M && k0 + ch * 8 < k_end;
    cp_async16(xs + swz128(r, ch), x + (live ? static_cast<long long>(r) * a.K + k0 + ch * 8 : 0),
               live);
  }
}

// One pair of finished sums of output row `row`, channels (ch, ch + 1) of a TILE_N-wide
// column tile: scaled and rounded into out (one split), or into this split's partial tile.
template <int TILE_N>
__device__ __forceinline__ void put_pair(const QmmArgs& a, int tile, int split, int row,
                                         int ch, float lo, float hi) {
  if (row >= a.M) return;
  const int n0 = tile * TILE_N;
  if (a.splits == 1) {
    store_bf16x2(static_cast<__nv_bfloat16*>(a.out) + static_cast<long long>(row) * a.N + n0 + ch,
                 lo * a.s[n0 + ch], hi * a.s[n0 + ch + 1]);
  } else {
    float* part = a.ws + ((static_cast<long long>(tile) * a.splits + split) * a.M + row) * TILE_N;
    *reinterpret_cast<float2*>(part + ch) = make_float2(lo, hi);
  }
}

// After every thread's put_pair: the last split of this column tile to finish adds the
// partials in split order (4 channels a thread, up to 8 splits' loads in flight), scales,
// rounds and writes out, and resets the tile's counter.
template <int TILE_N, int THREADS>
__device__ __forceinline__ void merge_splits(const QmmArgs& a, int tile, int& is_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n0 = tile * TILE_N;
  const float* parts = a.ws + static_cast<long long>(tile) * a.splits * a.M * TILE_N;
  const long long stride = static_cast<long long>(a.M) * TILE_N;  // one split's tile
  for (int i = threadIdx.x; i < a.M * TILE_N / 4; i += THREADS) {
    const int row = i / (TILE_N / 4), ch = 4 * (i % (TILE_N / 4));
    const float* p = parts + row * TILE_N + ch;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < a.splits; sp0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp0 + u < a.splits) v[u] = __ldcg(reinterpret_cast<const float4*>(p + (sp0 + u) * stride));
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (sp0 + u < a.splits) {
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
      }
    }
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + static_cast<long long>(row) * a.N + n0 + ch;
    store_bf16x2(o, sum.x * a.s[n0 + ch], sum.y * a.s[n0 + ch + 1]);
    store_bf16x2(o + 2, sum.z * a.s[n0 + ch + 2], sum.w * a.s[n0 + ch + 3]);
  }
  if (threadIdx.x == 0) a.counters[tile] = 0;  // ready for the next launch
}

// mma.sync route (M <= 8). grid (N / 128, splits), 256 threads, four blocks an SM (the
// weight stream wants the bytes in flight). Warp w: column warp w % 4 owns channels
// [32 (w % 4), +32) of the tile; K warp w / 4 takes the 32-row half w / 4 of every stage.
// The K warps' sums are added at the end.
__global__ void __launch_bounds__(256, 4)
qmm_mma_kernel(const QmmArgs a) {
  constexpr int kThreads = 256;
  constexpr int kStageBytes = kQBytes + 8 * 128;  // q tile, then x's 8 rows
  extern __shared__ __align__(128) char smem[];
  __shared__ int is_last;

  const int tile = blockIdx.x, split = blockIdx.y;
  const int k_begin = split * a.k_slice;
  const int k_end = min(a.K, k_begin + a.k_slice);
  const int n_tiles = (k_end - k_begin + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wc = warp % 4, kk = warp / 4;

  float acc[2][4] = {};

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_stage<kTileN, 8, kThreads>(a, smem + t * kStageBytes, k_begin + t * kTileK, k_end,
                                      tile * kTileN, threadIdx.x);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; stage (t - 1) % kStages is free
    const int tn = t + kStages - 1;
    if (tn < n_tiles)
      load_stage<kTileN, 8, kThreads>(a, smem + (tn % kStages) * kStageBytes,
                                      k_begin + tn * kTileK, k_end, tile * kTileN, threadIdx.x);
    cp_async_commit();
    const char* qs = smem + (t % kStages) * kStageBytes;
    uint32_t af[2][2][4];  // [m16 tile][k16 step][register]
    a_fragments<kTileN>(qs, kk * 32, wc * 2, lane, af[0]);
    a_fragments<kTileN>(qs, kk * 32, wc * 2 + 1, lane, af[1]);
    uint32_t b[4];  // matrix i: the 8 rows of x, K chunk kk * 4 + i
    ldmatrix_x4(b, qs + kQBytes + swz128(lane & 7, kk * 4 + (lane >> 3)));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma(acc[mt], af[mt][0], b[0], b[1]);
      mma(acc[mt], af[mt][1], b[2], b[3]);
    }
  }
  cp_async_wait<0>();

  // K warp 1 hands its sums to K warp 0 through the idle ring; K warp 0 adds them.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem) + wc * (2 * 4 * 32);
  if (kk == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[i * 32 + lane] = acc[i / 4][i % 4];
  }
  __syncthreads();
  if (kk == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i / 4][i % 4] += red[i * 32 + lane];
    // acc[mt]: {e0, e1} channel ch at rows (2c, 2c + 1), {e2, e3} channel ch + 1.
    const int g = lane / 4, c = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put_pair<kTileN>(a, tile, split, 2 * c + h, wc * 32 + mt * 16 + 2 * g, acc[mt][h],
                         acc[mt][2 + h]);
  }
  if (a.splits > 1) merge_splits<kTileN, kThreads>(a, tile, is_last);
}

// wgmma: d = a (m64 x k16, registers, the mma's A fragment layout in each warp) *
// b (k16 x n64, the K-major 128-byte-swizzled bf16 tile in shared memory at descriptor
// `db`) + (accumulate ? d : 0); f32.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// wgmma route (8 < M <= 256; x's rows padded to 64 RG with zeros). grid (N / (64 WG),
// splits), 128 WG + 32 kProducers threads. The last kProducers warps produce: they copy
// each stage (q tile, x tile) into a ring of kStages slots with cp.async and have them
// arrive on the slot's `full` barrier. The first 4 WG warps consume: warpgroup wg = w / 4
// owns channels [64 wg, +64) of the tile as the m64 side of m64n64k16, its warp w % 4 the
// A rows 16 (w % 4)..+16, i.e. channels [64 wg + 16 (w % 4), +16) in the mma's order (row
// g = channel 2g, row g + 8 = 2g + 1), widened from the int8 tile into the A registers;
// the n64 side is each group of 64 rows of x, read from the x tile in shared memory, one
// accumulator set per group. Once a stage's products are done each consumer warp arrives
// on the slot's `empty` barrier, which the producers await before refilling it. No
// block-wide barrier runs in the loop.
constexpr int kProducers = 4;  // producer warps: issuing the copies is the bottleneck

template <int WG, int RG>
__global__ void __launch_bounds__(128 * WG + 32 * kProducers)
qmm_wgmma_kernel(const QmmArgs a) {
  constexpr int kConsumers = 128 * WG, kThreads = kConsumers + 32 * kProducers;
  constexpr int kTileW = 64 * WG;
  constexpr int kStageBytes = kTileK * kTileW + RG * 64 * 128;  // q, x: multiples of 1024
  extern __shared__ __align__(1024) char smem_raw[];
  __shared__ int is_last;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // The descriptor's swizzle is anchored at 1024-byte boundaries of the address.
  char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tile = blockIdx.x, split = blockIdx.y;
  const int k_begin = split * a.k_slice;
  const int k_end = min(a.K, k_begin + a.k_slice);
  const int n_tiles = (k_end - k_begin + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32 * kProducers);
      mbar_init(&empty[s], kConsumers / 32);
    }
  }
  __syncthreads();

  float acc[RG][32];
  if (warp >= kConsumers / 32) {
    // The producers.
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      if (t >= kStages) mbar_wait(&empty[slot], (t / kStages - 1) & 1);
      load_stage<kTileW, 64 * RG, 32 * kProducers>(a, smem + slot * kStageBytes,
                                                   k_begin + t * kTileK, k_end, tile * kTileW,
                                                   threadIdx.x - kConsumers);
      mbar_arrive_cp_async(&full[slot]);
    }
  } else {
    // The consumers. No instruction but a wgmma writes the accumulators (ptxas would
    // serialize the wgmmas): the first product of the slice overwrites them.
    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      mbar_wait(&full[slot], (t / kStages) & 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // x tile for wgmma
      const char* qs = smem + slot * kStageBytes;
      uint32_t af[2][2][4];  // the stage's four k16 steps: [32-row half][k16 step]
      a_fragments<kTileW>(qs, 0, warp, lane, af[0]);
      a_fragments<kTileW>(qs, 32, warp, lane, af[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int rg = 0; rg < RG; ++rg) {
        const uint64_t db = desc128(qs + kTileK * kTileW + rg * 64 * 128);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)  // the descriptor advances 32 bytes (16 of K) a step
          wgmma_m64n64k16(acc[rg], af[ks / 2][ks % 2], db + 2 * ks, t > 0 || ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    // acc[rg][4 j + e]: rows of x 64 rg + 8 j + 2c (e = 0, 2) and + 1 (e = 1, 3); channel
    // 2g (e < 2), 2g + 1 (e >= 2) of the warp's 16.
    const int g = lane / 4, c = lane % 4;
#pragma unroll
    for (int rg = 0; rg < RG; ++rg) {
      fence_acc(acc[rg]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put_pair<kTileW>(a, tile, split, 64 * rg + 8 * j + 2 * c + h, warp * 16 + 2 * g,
                           acc[rg][4 * j + h], acc[rg][4 * j + 2 + h]);
    }
  }
  if (a.splits > 1) merge_splits<kTileW, kThreads>(a, tile, is_last);
}

// The CUDA-core kernel for f32 x.
constexpr int kRows = 8;    // rows of x a block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 256;  // columns of x staged in shared memory at a time

// grid (ceil(M / kRows), N / 128, splits).
__global__ void __launch_bounds__(kThreads)
qmm_f32_kernel(const QmmArgs a) {
  __shared__ float x_s[kRows][kStage];
  __shared__ float red[kWarps][kRows][kTileN];
  __shared__ int is_last;
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  const int m0 = blockIdx.x * kRows;
  const int tile = blockIdx.y, n0 = tile * kTileN;
  const int split = blockIdx.z;
  const int k_begin = split * a.k_slice, k_end = min(a.K, k_begin + a.k_slice);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = min(kRows, a.M - m0);

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  const int8_t* q_lane = a.q + n0 + 4 * lane;
  for (int k0 = k_begin; k0 < k_end; k0 += kStage) {
    const int width = min(kStage, k_end - k0);
    __syncthreads();  // the previous stage of x is consumed
    for (int i = threadIdx.x; i < kRows * kStage; i += kThreads) {
      const int r = i / kStage, col = i % kStage;
      x_s[r][col] = (r < rows && col < width) ? x[static_cast<long long>(m0 + r) * a.K + k0 + col]
                                              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int col = warp; col < width; col += kWarps) {
      const char4 w =
          *reinterpret_cast<const char4*>(q_lane + static_cast<long long>(k0 + col) * a.N);
      const float w0 = w.x, w1 = w.y, w2 = w.z, w3 = w.w;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = x_s[r][col];
        acc[r][0] += xv * w0;
        acc[r][1] += xv * w1;
        acc[r][2] += xv * w2;
        acc[r][3] += xv * w3;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][r][4 * lane + j] = acc[r][j];
  }
  __syncthreads();
  float* part = a.ws + (static_cast<long long>(tile) * a.splits + split) * a.M * kTileN;
  for (int i = threadIdx.x; i < rows * kTileN; i += kThreads) {
    const int r = i / kTileN, col = i % kTileN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][r][col];
    if (a.splits == 1) {
      out[static_cast<long long>(m0 + r) * a.N + n0 + col] = sum * a.s[n0 + col];
    } else {
      part[(m0 + r) * kTileN + col] = sum;
    }
  }
  if (a.splits == 1) return;

  // The last split of this (row tile, column tile) adds them all, in split order.
  const int counter = blockIdx.x * gridDim.y + tile;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.counters + counter, 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = a.ws + static_cast<long long>(tile) * a.splits * a.M * kTileN;
  for (int i = threadIdx.x; i < rows * kTileN; i += kThreads) {
    const int r = i / kTileN, col = i % kTileN;
    float sum = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      sum += __ldcg(parts + (static_cast<long long>(sp) * a.M + m0 + r) * kTileN + col);
    out[static_cast<long long>(m0 + r) * a.N + n0 + col] = sum * a.s[n0 + col];
  }
  if (threadIdx.x == 0) a.counters[counter] = 0;  // ready for the next launch
}

int launch_mma(const QmmArgs& a, cudaStream_t stream) {
  qmm_mma_kernel<<<dim3(a.N / kTileN, a.splits), 256, kStages * (kQBytes + 8 * 128), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int WG, int RG>
int launch_wgmma(const QmmArgs& a, cudaStream_t stream) {
  // The ring, and slack to align its start to 1024 bytes.
  constexpr int kSmem = kStages * (kTileK * 64 * WG + RG * 64 * 128) + 1024;
  auto kernel = qmm_wgmma_kernel<WG, RG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.N / (64 * WG), a.splits), 128 * WG + 32 * kProducers, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int WG>
int launch_wgmma_rows(const QmmArgs& a, cudaStream_t stream) {
  switch ((a.M + 63) / 64) {
    case 1: return launch_wgmma<WG, 1>(a, stream);
    case 2: return launch_wgmma<WG, 2>(a, stream);
    case 3: return launch_wgmma<WG, 3>(a, stream);
    default: return launch_wgmma<WG, 4>(a, stream);
  }
}

}  // namespace

extern "C" {

// x [M, K] (x_dtype), q [K, N] int8, s [N] float32, out [M, N] (x_dtype); ws and counters
// as QmmArgs (counters one per tile_n-wide column tile, f32: per row tile too), needed when
// k_slice < K (else may be null), counters zero (left zero). M <= 256, K and k_slice
// multiples of 32, N of 128; tile_n 128, or 64 for bf16 x with M > 8; x and q
// 16-byte aligned. Returns cudaGetLastError() of the launch.
int rb_qmm_int8(const void* x, const void* q, const void* s, void* out, void* ws,
                void* counters, int M, int K, int N, int k_slice, int tile_n, int x_dtype,
                void* stream) {
  const bool wgmma = x_dtype == kBF16 && M > 8;
  if (M <= 0 || M > 256 || K <= 0 || K % 32 != 0 || N <= 0 || N % kTileN != 0 ||
      k_slice <= 0 || k_slice % 32 != 0 || !(tile_n == kTileN || (wgmma && tile_n == 64)) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (K + k_slice - 1) / k_slice;
  if (splits > 1 && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const QmmArgs a{x, static_cast<const int8_t*>(q), static_cast<const float*>(s), out,
                  static_cast<float*>(ws), static_cast<int*>(counters), M, K, N, k_slice,
                  splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) {
    qmm_f32_kernel<<<dim3((M + kRows - 1) / kRows, N / kTileN, splits), kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if (wgmma) return tile_n == 64 ? launch_wgmma_rows<1>(a, st) : launch_wgmma_rows<2>(a, st);
  return launch_mma(a, st);
}

}  // extern "C"
