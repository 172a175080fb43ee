// Decode attention (T = 1) over a paged KV pool, for bf16 queries over a
// bf16 pool, on the tensor cores of Hopper.
//
// Replaces the Pallas TPU kernel paged_decode_attention (_decode_kernel) of
// runbookai_tpu/ops/paged_attention_pallas.py (K1) for bf16 queries with
// head_dim 64 or 128 over a bf16 pool. f32 queries, int8 pools (K3) and the
// page-split partial (K4) take the CUDA-core kernel of paged_attention.cu.
//
// What it computes, for query head h of sequence b: an online (flash)
// softmax in f32 over the first ctx_lens[b] cached tokens, read through
// page_tables[b, p], kv-major GQA (head h reads kv head h / group). A
// sequence with ctx 0 gives zeros. No page-table entry at or past
// ceil(ctx / ps) is read, so the trash column and the null page are never
// touched.
//
// What bounds it on an H100: bytes. A decode step reads each sequence's
// K/V once (n_kv * hd * 2 * 2 bytes a cached token): at B=8 with contexts
// 0..8191 (13,622 tokens) that is 55.8 MB, 0.0167 ms at 3.35 TB/s, against
// 0.00011 ms of bf16 tensor-core work. The design:
//
// - Flash-decoding split over page-table columns. A block owns one
//   (sequence, kv head, split); split s covers table columns [s * cols,
//   (s + 1) * cols). The plan (ops/paged_attention.py decode_plan) is a
//   function of shapes only, never of ctx_lens, so the wrapper makes no host
//   sync: about 2 * 132 / n_kv splits, at least four columns each, so that
//   one long row spreads over every SM (the 8B at 513 columns: 33 splits of
//   16 columns, 256 keys). A block whose run starts at or past
//   ceil(ctx / ps) exits before it loads anything: its partial would be
//   (0, -1e30, 0), which the merge would not move, so the merge reads the
//   live splits only. At the served contexts (at most 60 of 513 columns
//   live) most blocks exit at once.
// - Asynchronous page tiles. K/V tiles of 64 keys (four 16-token pages)
//   stream through a three-stage cp.async ring (16 bytes a thread) in the
//   pool's own type, XOR-swizzled for ldmatrix, as in chunk_attention.cu.
//   The GQA group's query rows are loaded once, padded to 16 rows with zeros.
// - Tensor cores, each warp on its own keys. Of every 64-key tile, warp w
//   takes keys [16 w, 16 w + 16): S = Q K^T (16 rows x 16 keys) and O += P V
//   with mma.sync.m16n8k16, P in two bf16 parts (hi + lo) as in
//   chunk_attention.cu, a running max and sum per warp in registers, reduced
//   across a quad with shuffles; no thread works a row alone. At the end the
//   four warps' (m, l, O) combine through shared memory. Of the 16 rows only
//   the group's (4 at the 8B) are real: the tensor cores idle on 12, but the
//   kernel is bound by bytes, and mma.sync keeps q in registers and needs
//   no per-key shuffles. CUDA cores would take a warp-wide reduction per key
//   and row (20 shuffles a key at the 8B's group of 4). ptxas (sm_90a): 166
//   registers at head_dim 128, 124 at 64, no spills, one barrier; shared
//   memory 102,400 bytes (Q tile and a three-stage ring of 32 KB K/V
//   stages) at 128, so two blocks an SM, and 51,200 at 64.
// - One launch per call. With several live splits, each writes its f32
//   (acc, m, l) (m in log2 units) to a workspace, __threadfence()s and bumps
//   an int32 counter per (sequence, kv head); the block that brings it to
//   the live split count merges the live splits in split order (the same
//   inputs give the same bits, whichever block finishes last), writes bf16
//   and resets the counter to 0. The workspace and counters belong to the
//   wrapper (allocated once, zeroed, grown with the shape); a call allocates
//   nothing but its output. One live split writes its output directly.
//
// Layout for the other decode kernels: the block's key source (a run of
// table columns) and its epilogue (a bf16 output) are the two places that
// an int8 pool (K3: load_kv_tile's int8 tiles widened by widen_tile, k_scale
// on score columns and v_scale folded into P, as chunk_attention.cu does)
// and a page shard's partial (K4: owned columns listed as chunk_attention.cu
// does, and (acc, m, l) written in f32) change; the template's TKV is the
// pool type.
//
// Built with every source of csrc/ by runbookai_tpu_torch/ops/build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, one shared library,
// ctypes).

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;   // query rows a block: the group, padded
constexpr int kStages = 3;  // K/V tiles in the ring: two load while one computes

struct DecodeArgs {
  const __nv_bfloat16* q;  // [B, n_q, HD]
  const void* k;           // [tokens, n_kv, HD]
  const void* v;           // same
  const int* tables;       // [B, P]
  const int* ctx_lens;     // [B]
  __nv_bfloat16* out;      // [B, n_q, HD]
  float* ws;               // acc [B * n_kv, splits, group, HD], then m and l [B * n_kv, splits, group]
  int* counters;           // [B * n_kv], 0 between launches
  int n_q, n_kv, ps, P, cols;
  float scale_log2;        // softmax scale times log2(e)
};

template <typename TKV, int HD>
struct DecodeSmem {
  static constexpr int kQ = kRows * HD * 2;                    // bf16 Q tile
  static constexpr int kStage = 2 * kKeys * HD * sizeof(TKV);  // K and V tiles
  static constexpr int kBytes = kQ + kStages * kStage;
  // After the loop the ring holds the warps' partials, then the merge's weights.
  static_assert(kWarps * kRows * (HD + 2) * 4 <= kStages * kStage, "ring too small");
};

template <typename TKV, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_mma_kernel(DecodeArgs a) {
  using S = DecodeSmem<TKV, HD>;
  constexpr int kKs = HD / 16;  // k-steps of Q K^T
  constexpr int kNb = HD / 8;   // n-blocks of O
  extern __shared__ __align__(128) char smem[];
  __shared__ int is_last;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  char* ring = smem + S::kQ;

  const int split = blockIdx.x, splits = gridDim.x;
  const int bk = blockIdx.y;  // (sequence, kv head)
  const int b = bk / a.n_kv, kvh = bk % a.n_kv;
  const int group = a.n_q / a.n_kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;

  const int ctx = a.ctx_lens[b];
  const int hi = max(0, min(ctx, a.P * a.ps));
  const int n_cols = (hi + a.ps - 1) / a.ps;
  const int n_live = n_cols > 0 ? (n_cols + a.cols - 1) / a.cols : 0;
  __nv_bfloat16* out = a.out + (static_cast<long long>(b) * a.n_q + kvh * group) * HD;
  if (split >= n_live) {
    if (split == 0)  // no key at all: zeros
      for (int i = threadIdx.x; i < group * HD; i += kThreads) out[i] = __float2bfloat16(0.f);
    return;
  }
  const int lo = split * a.cols * a.ps;
  const int end = min(hi, lo + a.cols * a.ps);
  const int n_tiles = (end - lo + kKeys - 1) / kKeys;
  const int* table = a.tables + static_cast<long long>(b) * a.P;

  auto issue = [&](int it) {
    load_kv_tile<TKV, HD, kThreads>(a.k, a.v, nullptr, nullptr, a.n_kv, kvh,
                                    RunKeys{table, lo + it * kKeys, end, a.ps},
                                    ring + (it % kStages) * S::kStage, nullptr);
  };

  {
    constexpr int kChunks = HD / 8;
    const __nv_bfloat16* q = a.q + (static_cast<long long>(b) * a.n_q + kvh * group) * HD;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      cp_async16(q_s + swz<HD>(r, ch), q + (r < group ? r : 0) * HD + ch * 8, r < group);
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
  float m2[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the running sums

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
        ldmatrix_x4(qf[ks], q_s + swz<HD>((lane & 7) + (mat & 1) * 8, 2 * ks + (mat >> 1)));
      }
    }
    const int key0 = lo + it * kKeys + 16 * warp;  // this warp's first key
    if (key0 >= end) continue;                     // (uniform over the warp)
    const __nv_bfloat16* k_t = reinterpret_cast<const __nv_bfloat16*>(ring + st * S::kStage);
    const __nv_bfloat16* v_t = k_t + kKeys * HD;

    // S = Q K^T for the 16 rows and this warp's 16 keys.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      uint32_t kb[4];
      const int mat = lane >> 3;
      ldmatrix_x4(kb, k_t + swz<HD>(16 * warp + (lane & 7) + (mat >> 1) * 8, 2 * ks + (mat & 1)));
      mma_bf16(s[0], qf[ks], kb[0], kb[1]);
      mma_bf16(s[1], qf[ks], kb[2], kb[3]);
    }

    // Online softmax over the warp's keys, rows g and g + 8.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = key0 + 8 * j + 2 * c + e < end ? s[j][2 * hr + e] * a.scale_log2
                                                          : kNegInf;
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
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              key0 + 8 * j + 2 * c + e < end ? exp2f(s[j][2 * hr + e] - m_new) : 0.f;
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

    // O += P V over the warp's 16 keys, P as hi + lo bf16 parts.
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dd = 0; dd < kNb / 2; ++dd) {
      uint32_t vb[4];
      const int mat = lane >> 3;
      ldmatrix_x4_trans(vb, v_t + swz<HD>(16 * warp + (lane & 7) + (mat & 1) * 8,
                                          2 * dd + (mat >> 1)));
      mma_bf16(o[2 * dd], ph, vb[0], vb[1]);
      mma_bf16(o[2 * dd], pl, vb[0], vb[1]);
      mma_bf16(o[2 * dd + 1], ph, vb[2], vb[3]);
      mma_bf16(o[2 * dd + 1], pl, vb[2], vb[3]);
    }
  }

  // The warps' partials of the group's rows, through the (now idle) ring.
  cp_async_wait<0>();
  __syncthreads();
  float* part_o = reinterpret_cast<float*>(ring);  // [warp][row][HD]
  float* part_m = part_o + kWarps * kRows * HD;    // [warp][row]
  float* part_l = part_m + kWarps * kRows;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int r = g + 8 * hr;
    if (r >= group) continue;
    float* dst = part_o + (warp * kRows + r) * HD;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
      *reinterpret_cast<float2*>(dst + 8 * nb + 2 * c) = make_float2(o[nb][2 * hr], o[nb][2 * hr + 1]);
    if (c == 0) {
      part_m[warp * kRows + r] = m2[hr];
      part_l[warp * kRows + r] = l[hr];
    }
  }
  __syncthreads();

  // This split's (acc, m, l): the warps combined in warp order. One live
  // split writes the output; several write the workspace.
  const long long n_parts = static_cast<long long>(gridDim.y) * splits * group;
  float* ws_acc = a.ws;
  float* ws_m = a.ws + n_parts * HD;
  float* ws_l = ws_m + n_parts;
  const long long part = (static_cast<long long>(bk) * splits + split) * group;  // row 0's
  for (int i = threadIdx.x; i < group * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part_m[w * kRows + r]);
    float acc = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = exp2f(part_m[w * kRows + r] - mx);
      acc += part_o[(w * kRows + r) * HD + d] * cw;
      den += part_l[w * kRows + r] * cw;
    }
    if (n_live == 1) {
      out[i] = __float2bfloat16(acc / fmaxf(den, 1e-30f));
    } else {
      ws_acc[part * HD + i] = acc;
      if (d == 0) {
        ws_m[part + r] = mx;
        ws_l[part + r] = den;
      }
    }
  }
  if (n_live == 1) return;

  // The last live split of this (sequence, kv head) to finish merges them all.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.counters + bk, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long long part0 = static_cast<long long>(bk) * splits * group;  // split 0, row 0
  float* wt = reinterpret_cast<float*>(ring);  // [split][row]: e^(m_s - M)
  float* den_s = wt + n_live * group;          // [row]
  if (threadIdx.x < group) {
    const int r = threadIdx.x;
    float mx = kNegInf;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, __ldcg(ws_m + part0 + s * group + r));
    float den = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float w = exp2f(__ldcg(ws_m + part0 + s * group + r) - mx);
      wt[s * group + r] = w;
      den += __ldcg(ws_l + part0 + s * group + r) * w;
    }
    den_s[r] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * HD; i += kThreads) {
    const int r = i / HD;
    float acc = 0.f;
    for (int s = 0; s < n_live; ++s)
      acc += __ldcg(ws_acc + (part0 + s * group) * HD + i) * wt[s * group + r];
    out[i] = __float2bfloat16(acc / den_s[r]);
  }
  if (threadIdx.x == 0) a.counters[bk] = 0;  // ready for the next launch
}

template <typename TKV, int HD>
int launch(const DecodeArgs& a, int B, int splits, cudaStream_t stream) {
  using S = DecodeSmem<TKV, HD>;
  // The merge's weights ((splits + 1) x 16 floats) live in the ring.
  if ((splits + 1LL) * kRows * 4 > kStages * S::kStage)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = S::kBytes;
  auto kernel = decode_attention_mma_kernel<TKV, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, B * a.n_kv), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q [B, n_q, hd] bf16; k, v [tokens, n_kv, hd] bf16; tables [B, P] and
// ctx_lens [B] int32; out [B, n_q, hd] bf16. `splits` splits of `cols`
// table columns each; with splits > 1, ws holds B * n_q * splits * (hd + 2)
// f32 and counters B * n_kv int32 zeros (left zero). The group n_q / n_kv is
// at most 16. Returns cudaGetLastError() of the launch.
int rb_paged_decode_attention_mma(const void* q, const void* k, const void* v,
                                  const void* tables, const void* ctx_lens, void* out, void* ws,
                                  void* counters, int B, int n_q, int n_kv, int hd, int ps, int P,
                                  int splits, int cols, float scale, void* stream) {
  if (B == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kRows || ps <= 0 || P < 0 || splits < 1 ||
      cols < 0 || static_cast<long long>(splits) * cols < P ||
      static_cast<long long>(B) * n_kv > 65535 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const int*>(tables),
               static_cast<const int*>(ctx_lens), static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(ws), static_cast<int*>(counters), n_q, n_kv, ps, P, cols,
               scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<__nv_bfloat16, 64>(a, B, splits, s);
  if (hd == 128) return launch<__nv_bfloat16, 128>(a, B, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
