// Building blocks of the tensor-core attention kernels (chunk_attention.cu,
// decode_attention.cu): cp.async copies, ldmatrix fragments, the bf16
// mma.sync, P split into two bf16 parts, the XOR swizzle of bf16 K/V tiles,
// the keys of a tile (a run of table columns, or a page shard's owned pages),
// the copy of one 64-key K/V tile from a paged pool and the widening of an
// int8 tile to bf16; and Hopper's wgmma descriptor, accumulator fence and
// mbarriers (qmm.cu, ragged_attention.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kKeys = 64;  // keys per K/V tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[0..3] += a (m16 x k16, row) * b (k16 x n8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo to about 2^-16 of x, both bf16; packs (x0, x1) of each.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Element offset of 16-byte chunk `chunk` of row `row` in a swizzled bf16 tile
// of HD columns: chunks are XORed with the row's low 3 bits, so the 8 rows of
// an ldmatrix 8x8 matrix fall in 8 different bank groups.
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * HD + ((chunk ^ (row & 7)) << 3);
}

// Pool rows of a tile's keys: positions pos0 + key below hi, through a
// sequence's page table.
struct RunKeys {
  const int* table;
  int pos0, hi, ps;
  __device__ __forceinline__ long long operator()(int key) const {
    const int pos = pos0 + key;
    return pos < hi ? static_cast<long long>(table[pos / ps]) * ps + pos % ps : -1;
  }
};

// Pool rows of a tile's keys j0 + key of a page shard's owned pages, listed
// in table order as local page ids (the page-split partials).
struct OwnedKeys {
  const int* own_page;
  int j0, n_keys, ps;
  __device__ __forceinline__ long long operator()(int key) const {
    const int j = j0 + key;
    return j < n_keys ? static_cast<long long>(own_page[j / ps]) * ps + j % ps : -1;
  }
};

// Start the cp.async copies of one 64-key K/V tile of kv head `kvh` into
// `stage` (K tile, then V tile), in the pool's own type: key `key` is pool
// row row_of(key), or zero-filled where that is negative (row_of then reads
// no page-table entry for it). int8 tiles are linear (widen_tile makes the
// bf16 copy), bf16 tiles swizzled; over an int8 pool the keys' k and v
// scales go to scales[key] and scales[kKeys + key].
template <typename TKV, int HD, int THREADS, typename RowOf>
__device__ __forceinline__ void load_kv_tile(const void* k, const void* v,
                                             const float* k_scale, const float* v_scale,
                                             int n_kv, int kvh, const RowOf& row_of,
                                             char* stage, float* scales) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kChunks = HD * sizeof(TKV) / 16;  // 16-byte chunks per key row
  const char* kp = static_cast<const char*>(k);
  const char* vp = static_cast<const char*>(v);
  char* k_s = stage;
  char* v_s = stage + kKeys * HD * sizeof(TKV);
  for (int i = threadIdx.x; i < kKeys * kChunks; i += THREADS) {
    const int key = i / kChunks, ch = i % kChunks;
    const long long row = row_of(key);
    const bool live = row >= 0;
    const long long src =
        ((live ? row : 0) * n_kv + kvh) * HD * static_cast<long long>(sizeof(TKV)) + ch * 16;
    const int dst = kInt8 ? key * HD + ch * 16 : swz<HD>(key, ch) * 2;
    cp_async16(k_s + dst, kp + src, live);
    cp_async16(v_s + dst, vp + src, live);
  }
  if constexpr (kInt8) {
    for (int key = threadIdx.x; key < kKeys; key += THREADS) {
      const long long row = row_of(key);
      const bool live = row >= 0;
      const long long idx = (live ? row : 0) * n_kv + kvh;
      cp_async4(scales + key, k_scale + idx, live);
      cp_async4(scales + kKeys + key, v_scale + idx, live);
    }
  }
}

// Widen keys [key0, key0 + KEYS) of a landed int8 K/V stage to the swizzled
// bf16 tiles (exact: |v| <= 127), by THREADS threads, `tid` the caller's
// index among them: a whole tile by the block (widen_tile), or one warp's
// own keys (decode_attention.cu).
template <int HD, int THREADS, int KEYS>
__device__ __forceinline__ void widen_keys(const int8_t* stage, __nv_bfloat16* wide, int key0,
                                           int tid) {
  constexpr int kChunks = HD / 16;  // 16 int8 values a chunk
  for (int i = tid; i < 2 * KEYS * kChunks; i += THREADS) {
    const int tile = i / (KEYS * kChunks), j = i % (KEYS * kChunks);
    const int key = key0 + j / kChunks, ch = j % kChunks;
    const int4 raw = *reinterpret_cast<const int4*>(stage + tile * kKeys * HD + key * HD + ch * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = pack_bf16(static_cast<float>(b[2 * e]),
                                                 static_cast<float>(b[2 * e + 1]));
    __nv_bfloat16* dst = wide + tile * kKeys * HD;
    *reinterpret_cast<int4*>(dst + swz<HD>(key, 2 * ch)) = make_int4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<int4*>(dst + swz<HD>(key, 2 * ch + 1)) = make_int4(w[4], w[5], w[6], w[7]);
  }
}

// Widen a whole landed int8 K/V stage, by the block.
template <int HD, int THREADS>
__device__ __forceinline__ void widen_tile(const int8_t* stage, __nv_bfloat16* wide) {
  widen_keys<HD, THREADS, kKeys>(stage, wide, 0, threadIdx.x);
}

// ---- Hopper: wgmma accumulators, shared-memory descriptors, mbarriers (qmm.cu,
// ragged_attention.cu).

// Keep the compiler from moving accesses of the accumulators across the wgmma waits.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major bf16 tile with 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart, starting at `p` (1024-byte aligned).
__device__ __forceinline__ uint64_t desc128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// Arrive on `bar` once every cp.async this thread has started is complete.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

}  // namespace
