// Ragged paged attention for the serving forward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of runbookai_tpu/ops/paged_attention_pallas.py:
//
//   rb_paged_decode_attention  <- paged_decode_attention (_decode_kernel), T = 1;
//                                 over an int8 pool <- _paged_decode_attention_int8
//                                 (_decode_kernel_int8)
//   rb_paged_chunk_attention   <- paged_chunk_attention  (_chunk_kernel),  T > 1,
//                                 f32 queries only: bf16 queries take the
//                                 tensor-core kernel of chunk_attention.cu
//   rb_paged_decode_attention_partial <- paged_decode_attention_partial
//                                 (_decode_kernel_partial): KV page-split serving
//   rb_paged_chunk_attention_partial  <- the XLA _partial_flash of
//                                 runbookai_tpu/parallel/kv_split.py (T > 1)
//
// The pool holds float32 or bfloat16 K/V, or int8 K/V with one float32 absmax
// scale per (token, kv head) (runbookai_tpu_torch/ops/attention.py quantize_kv).
// An int8 value is widened and multiplied by its scale in float32 as its page
// is loaded into shared memory, as _flash_page_accumulate does; the pool moves
// one byte per value plus 4 / head_dim bytes of scale. The JAX package sends
// T > 1 calls over an int8 pool to its XLA gather path; here those with f32
// queries take the chunk kernel's int8 instantiation (bf16 queries the
// tensor-core kernel), which agrees with it on every row that a caller keeps
// (a fully masked row gives zeros instead of the mean of V).
//
// Both compute, for query row r of sequence b, an online (flash) softmax over
// the first ctx_lens[b] cached tokens, read page by page through
// page_tables[b, p]. GQA is kv-major: query head h reads kv head h / group.
// Scores and the running (m, l, acc) stay in float32; masked probabilities
// are zeroed explicitly and l is clamped at 1e-30, so a row that sees no key
// (ctx 0, or a causal row before every cached token) returns zeros. The chunk
// kernel adds the causal mask pos <= q_start[b] + t: query positions are
// contiguous per sequence, as the Pallas kernel's contract requires.
//
// Design: one block per (sequence, kv head) for decode and per (sequence,
// kv head, block of tq query tokens) for chunks. The block's rows are its
// tq * group query heads, so every K/V page is loaded into shared memory once
// and shared by the whole GQA group. The page loop visits only the pages
// below ctx (and, for chunks, at or before the block's last query position);
// a block never reads a page-table entry past them, so the trailing trash
// column and the null page 0 are never touched.
//
// What bounds it: both are memory-bound on an H100. The bytes that must move
// are the K/V pages of each sequence's context (n_kv * hd * 2 * itemsize per
// token, plus n_kv * 2 * 4 bytes of scales for an int8 pool) over 3.35 TB/s. This first version computes on CUDA cores in f32
// from shared memory, with no tensor cores, TMA or split-K over pages; those
// come later.
//
// The partial kernels (template flag kPartial) run the same page walk over
// one page shard's slice of the pool: page tables hold GLOBAL page ids, page
// g lives on shard g / pages_local at local page g - shard * pages_local, and
// a page of another shard is skipped before it is loaded (the test is
// uniform over the block, so the barriers stay aligned). They write the
// un-normalised flash partials in float32 -- acc [B, T, n_q, hd], m and l
// [B, T, n_q] -- for the merge across page shards (parallel/kv_split.py
// merge_partials); a row that sees no key on this shard gives (0, -1e30, 0).
// Their bound is the owned pages' K/V bytes over 3.35 TB/s; on a page-split
// mesh each shard reads only its own pages, and the GQA group's query heads
// share every page loaded, as in the full kernels.
//
// Built with every source of csrc/ by runbookai_tpu_torch/ops/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3, one shared library, ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDecodeThreads = 128;
constexpr int kChunkThreads = 256;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;        // [B, T, n_q, hd]
  const void* k;        // [num_pages * ps, n_kv, hd]
  const void* v;        // same
  const float* k_scale; // [num_pages * ps, n_kv], int8 pools only (else null)
  const float* v_scale; // same
  const int* tables;    // [B, P]
  const int* ctx_lens;  // [B]
  const int* q_start;   // [B] position of each row's query 0 (chunk only)
  void* out;            // [B, T, n_q, hd], q's dtype; float acc when partial
  int T, n_q, n_kv, hd, ps, P, tq;
  float scale;
  float* m_out;         // [B, T, n_q], partial only (else null)
  float* l_out;         // same
  int shard, pages_local;  // partial only: this page shard and its page count
};

// Shared-memory floats one block needs for `rows` query rows.
__host__ __device__ inline int smem_floats(int rows, int hd, int ps) {
  return rows * (hd + 1)   // q, pre-scaled (padded row: no bank conflicts)
         + rows * hd       // acc
         + ps * (hd + 1)   // K page (padded row)
         + ps * hd         // V page
         + rows * ps       // scores, then probabilities
         + 3 * rows;       // m, l, alpha
}

template <typename TQ, typename TKV, bool kCausal, bool kPartial>
__global__ void paged_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int group = a.n_q / a.n_kv;
  const int t0 = blockIdx.z * a.tq;
  const int n_tok = min(a.tq, a.T - t0);
  const int rows = n_tok * group;  // row r: query token t0 + r / group, head r % group
  const int hd = a.hd, ps = a.ps;
  const int ldq = hd + 1, ldk = hd + 1;

  float* q_s = smem;
  float* acc_s = q_s + rows * ldq;
  float* k_s = acc_s + rows * hd;
  float* v_s = k_s + ps * ldk;
  float* p_s = v_s + ps * hd;
  float* m_s = p_s + rows * ps;
  float* l_s = m_s + rows;
  float* alpha_s = l_s + rows;

  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);
  auto q_index = [&](int r, int d) {
    const int t = t0 + r / group, h = kvh * group + r % group;
    return ((static_cast<long long>(b) * a.T + t) * a.n_q + h) * hd + d;
  };

  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    q_s[r * ldq + d] = to_f32(q[q_index(r, d)]) * a.scale;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int ctx = a.ctx_lens[b];
  int n_pages = ctx > 0 ? min((ctx + ps - 1) / ps, a.P) : 0;
  int q0 = 0;
  if (kCausal) {
    q0 = a.q_start[b] + t0;
    const int qpos_max = q0 + n_tok - 1;
    n_pages = qpos_max < 0 ? 0 : min(n_pages, qpos_max / ps + 1);
  }
  const int* table = a.tables + static_cast<long long>(b) * a.P;

  for (int page = 0; page < n_pages; ++page) {
    long long page_id = table[page];
    if constexpr (kPartial) {
      if (page_id / a.pages_local != a.shard) continue;  // another shard's page
      page_id -= static_cast<long long>(a.shard) * a.pages_local;
    }
    const long long row0 = page_id * ps;
    const int base = page * ps;
    __syncthreads();  // the previous page's K/V and probabilities are consumed
    for (int i = threadIdx.x; i < ps * hd; i += blockDim.x) {
      const int t = i / hd, d = i % hd;
      const long long vec = (row0 + t) * a.n_kv + kvh;  // (token, kv head)
      const long long src = vec * hd + d;
      if constexpr (std::is_same<TKV, int8_t>::value) {
        k_s[t * ldk + d] = to_f32(kp[src]) * a.k_scale[vec];
        v_s[i] = to_f32(vp[src]) * a.v_scale[vec];
      } else {
        k_s[t * ldk + d] = to_f32(kp[src]);
        v_s[i] = to_f32(vp[src]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * ps; i += blockDim.x) {
      const int r = i / ps, t = i % ps;
      const float* qr = q_s + r * ldq;
      const float* kr = k_s + t * ldk;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qr[d] * kr[d];
      const int pos = base + t;
      bool valid = pos < ctx;
      if (kCausal) valid = valid && pos <= q0 + r / group;
      p_s[i] = valid ? s : kNegInf;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float* pr = p_s + r * ps;
      const float m_prev = m_s[r];
      float m_blk = kNegInf;
      for (int t = 0; t < ps; ++t) m_blk = fmaxf(m_blk, pr[t]);
      const float m_new = fmaxf(m_prev, m_blk);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const int pos = base + t;
        bool valid = pos < ctx;
        if (kCausal) valid = valid && pos <= q0 + r / group;
        const float p = valid ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      alpha_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
      const int r = i / hd, d = i % hd;
      const float* pr = p_s + r * ps;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t) pv += pr[t] * v_s[t * hd + d];
      acc_s[i] = acc_s[i] * alpha_s[r] + pv;
    }
  }
  __syncthreads();
  if constexpr (kPartial) {
    float* acc_out = static_cast<float*>(a.out);
    for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
      const int r = i / hd, d = i % hd;
      acc_out[q_index(r, d)] = acc_s[i];
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long long row = q_index(r, 0) / hd;  // (b, t, h)
      a.m_out[row] = m_s[r];
      a.l_out[row] = l_s[r];
    }
  } else {
    TQ* out = static_cast<TQ*>(a.out);
    for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
      const int r = i / hd, d = i % hd;
      out[q_index(r, d)] = from_f32<TQ>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename TQ, typename TKV, bool kCausal, bool kPartial>
int launch(const Args& a, int B, int threads, cudaStream_t stream) {
  const int n_qblocks = (a.T + a.tq - 1) / a.tq;
  const size_t smem = sizeof(float) * smem_floats(a.tq * (a.n_q / a.n_kv), a.hd, a.ps);
  auto kernel = paged_attention_kernel<TQ, TKV, kCausal, kPartial>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(B, a.n_kv, n_qblocks), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCausal, bool kPartial = false>
int dispatch(const Args& a, int B, int threads, int q_dtype, int kv_dtype, cudaStream_t stream) {
  if (B == 0 || a.T == 0) return 0;
  if (a.n_kv <= 0 || a.n_q % a.n_kv != 0 || a.hd <= 0 || a.ps <= 0 || a.tq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kPartial && (a.pages_local <= 0 || a.shard < 0 || a.m_out == nullptr ||
                   a.l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float, kCausal, kPartial>(a, B, threads, stream);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch<float, __nv_bfloat16, kCausal, kPartial>(a, B, threads, stream);
  if constexpr (!kPartial) {  // int8 KV is refused on a page-split mesh
    if (q_dtype == kF32 && kv_dtype == kI8)
      return launch<float, int8_t, kCausal, false>(a, B, threads, stream);
  }
  // bf16-query chunk calls take chunk_attention.cu's tensor-core kernel, so
  // the causal non-partial template has no bf16-query instantiation.
  if constexpr (!kCausal || kPartial) {
    if (q_dtype == kBF16 && kv_dtype == kF32)
      return launch<__nv_bfloat16, float, kCausal, kPartial>(a, B, threads, stream);
    if (q_dtype == kBF16 && kv_dtype == kBF16)
      return launch<__nv_bfloat16, __nv_bfloat16, kCausal, kPartial>(a, B, threads, stream);
    if constexpr (!kPartial) {
      if (q_dtype == kBF16 && kv_dtype == kI8)
        return launch<__nv_bfloat16, int8_t, kCausal, false>(a, B, threads, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [B, n_q, hd]; out [B, n_q, hd]; k_scale / v_scale [num_pages * ps, n_kv] for an int8
// pool, null otherwise. Returns cudaGetLastError() of the launch.
int rb_paged_decode_attention(const void* q, const void* k, const void* v, const void* k_scale,
                              const void* v_scale, const void* tables, const void* ctx_lens,
                              void* out, int B, int n_q, int n_kv, int hd, int ps, int P,
                              float scale, int q_dtype, int kv_dtype, void* stream) {
  Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(tables), static_cast<const int*>(ctx_lens), nullptr,
         out, 1, n_q, n_kv, hd, ps, P, 1, scale};
  return dispatch<false>(a, B, kDecodeThreads, q_dtype, kv_dtype,
                         static_cast<cudaStream_t>(stream));
}

// q [B, T, n_q, hd]; q_start [B]; out [B, T, n_q, hd]. tq query tokens per block.
// k_scale / v_scale as for rb_paged_decode_attention.
int rb_paged_chunk_attention(const void* q, const void* k, const void* v, const void* k_scale,
                             const void* v_scale, const void* tables, const void* ctx_lens,
                             const void* q_start, void* out, int B, int T, int n_q, int n_kv,
                             int hd, int ps, int P, int tq, float scale, int q_dtype,
                             int kv_dtype, void* stream) {
  Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
         static_cast<const int*>(q_start), out, T, n_q, n_kv, hd, ps, P, tq, scale};
  return dispatch<true>(a, B, kChunkThreads, q_dtype, kv_dtype,
                        static_cast<cudaStream_t>(stream));
}

// Decode partial over page shard `shard`'s slice of the pool ([pages_local * ps,
// n_kv, hd]; tables hold global page ids): acc [B, n_q, hd], m and l [B, n_q],
// all float32, un-normalised.
int rb_paged_decode_attention_partial(const void* q, const void* k, const void* v,
                                      const void* tables, const void* ctx_lens, void* acc,
                                      void* m, void* l, int B, int n_q, int n_kv, int hd,
                                      int ps, int P, int shard, int pages_local, float scale,
                                      int q_dtype, int kv_dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, static_cast<const int*>(tables),
         static_cast<const int*>(ctx_lens), nullptr, acc, 1, n_q, n_kv, hd, ps, P, 1, scale,
         static_cast<float*>(m), static_cast<float*>(l), shard, pages_local};
  return dispatch<false, true>(a, B, kDecodeThreads, q_dtype, kv_dtype,
                               static_cast<cudaStream_t>(stream));
}

// Chunk partial (T > 1, causal over q_start[b] + t): acc [B, T, n_q, hd], m and
// l [B, T, n_q], float32, un-normalised. Pool and tables as for the decode partial.
int rb_paged_chunk_attention_partial(const void* q, const void* k, const void* v,
                                     const void* tables, const void* ctx_lens,
                                     const void* q_start, void* acc, void* m, void* l, int B,
                                     int T, int n_q, int n_kv, int hd, int ps, int P, int tq,
                                     int shard, int pages_local, float scale, int q_dtype,
                                     int kv_dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, static_cast<const int*>(tables),
         static_cast<const int*>(ctx_lens), static_cast<const int*>(q_start), acc, T, n_q,
         n_kv, hd, ps, P, tq, scale, static_cast<float*>(m), static_cast<float*>(l), shard,
         pages_local};
  return dispatch<true, true>(a, B, kChunkThreads, q_dtype, kv_dtype,
                              static_cast<cudaStream_t>(stream));
}

const char* rb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
