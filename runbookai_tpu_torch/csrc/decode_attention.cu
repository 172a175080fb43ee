// Decode attention (T = 1) over a paged KV pool, for bf16 queries, on the
// tensor cores of Hopper: one kernel template, three instantiations.
//
// Replaces the Pallas TPU kernels of runbookai_tpu/ops/paged_attention_pallas.py
// for bf16 queries with head_dim 64 or 128:
//
//   K1  paged_decode_attention (_decode_kernel), over a bf16 pool;
//   K3  _paged_decode_attention_int8 (_decode_kernel_int8), over an int8 pool
//       with one f32 absmax scale per (token, kv head)
//       (runbookai_tpu_torch/ops/attention.py quantize_kv);
//   K4  paged_decode_attention_partial (_decode_kernel_partial), over one
//       page shard's slice of a bf16 pool, returning the flash partials.
//
// f32 queries and f32 pools take the CUDA-core kernel of paged_attention.cu.
//
// What it computes, for query head h of sequence b: an online (flash)
// softmax in f32 over the first ctx_lens[b] cached tokens, read through
// page_tables[b, p], kv-major GQA (head h reads kv head h / group). K1 and
// K3 write the normalised result in bf16; a sequence with ctx 0 gives
// zeros. K4 reads only the pages of page shard `shard` (tables hold global
// page ids; page g lives on shard g / pages_local at local page g - shard *
// pages_local) and writes the un-normalised (acc, m, l) in f32, m in
// natural-log units, for the merge across page shards
// (parallel/kv_split.py merge_partials); a row that sees no key there gives
// exactly (0, -1e30, 0). No page-table entry at or past ceil(ctx / ps) is
// read, so the trash column and the null page are never touched, and K4
// never loads a page of another shard.
//
// What bounds it on an H100: bytes. A decode step reads each sequence's
// K/V once (n_kv * hd * 2 * 2 bytes a cached token in bf16; half that, plus
// n_kv * 2 * 4 bytes of scales, in int8): at B=8 with contexts 0..8191
// (13,622 tokens) that is 55.8 MB in bf16, 0.0167 ms at 3.35 TB/s, against
// 0.00011 ms of bf16 tensor-core work. The design:
//
// - Flash-decoding split over page-table columns. A block owns one
//   (sequence, kv head, split); split s covers table columns [s * cols,
//   (s + 1) * cols). The plan (ops/paged_attention.py decode_plan) is a
//   function of shapes only, never of ctx_lens, so the wrapper makes no host
//   sync: about 2 * 132 / n_kv splits, at least four columns each, so that
//   one long row spreads over every SM (the 8B at 513 columns: 33 splits of
//   16 columns, 256 keys; one tp=16 page-shard call, one kv head: 103
//   splits of 5). A block whose run starts at or past ceil(ctx / ps) exits
//   before it loads anything: its partial would be (0, -1e30, 0), which the
//   merge would not move, so the merge reads the live splits only. At the
//   served contexts (at most 60 of 513 columns live) most blocks exit at
//   once.
// - The keys of a block. K1 and K3 take the run of its split's columns
//   below ceil(ctx / ps). K4 first lists, in shared memory and in table
//   order, the columns of that run whose page its shard owns (a ballot and
//   a prefix count per 32 columns, as chunk_attention.cu's chunk partial
//   does), with their local pages; its tiles are then four owned pages each,
//   whatever lies between them, and a foreign page is never read. In both,
//   the live keys are a prefix of the block's key list (only the last
//   column below ctx is cut short), so one bound masks them: T = 1 has no
//   causal mask.
// - Asynchronous page tiles. K/V tiles of 64 keys (four 16-token pages)
//   stream through a three-stage cp.async ring (16 bytes a thread) in the
//   pool's own type, as in chunk_attention.cu: bf16 tiles XOR-swizzled for
//   ldmatrix; int8 tiles linear, with the keys' k and v scales beside them.
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
//   and row (20 shuffles a key at the 8B's group of 4).
// - int8 pools without a dequantized copy (K3). Each warp widens its own 16
//   keys of the landed int8 K and V tiles to a swizzled bf16 tile (exact:
//   |v| <= 127) and syncs the warp only: no warp reads another's keys, so
//   the block keeps its one barrier a tile. Each score column is multiplied
//   by k_scale[token, kv head] after Q K^T, and v_scale[token, kv head] is
//   folded into P before its split for the P V product. The pool moves one
//   byte a value plus its scales.
// - One launch per call. With several live splits, each writes its f32
//   (acc, m, l) (m in log2 units) to a workspace, __threadfence()s and bumps
//   an int32 counter per (sequence, kv head); the block that brings it to
//   the live split count merges the live splits in split order (the same
//   inputs give the same bits, whichever block finishes last), writes the
//   output and resets the counter to 0. The live split count comes from
//   ctx alone, never from ownership, so every block of a (sequence, kv head)
//   computes the same; a live K4 split that owns no page writes (0, -1e30,
//   0) and bumps the counter all the same. The workspace and counters belong
//   to the wrapper (allocated once, zeroed, grown with the shape); a call
//   allocates nothing but its output. One live split writes its output
//   directly. K4 converts m to natural-log units last, and only where l > 0,
//   so an empty row keeps -1e30 exactly.
//
// Each variant has its own argument struct (K3 and K4 extend K1's), so K1's
// parameters stay as they were: more fields in K2's parameter struct made
// K2 slower on the card (PERF.md). ptxas (sm_90a): 162 registers for K1,
// 168 for K3 and 164 for K4 at head_dim 128, 124 to 128 at 64; no spills,
// one barrier.
// Shared memory at head_dim 128: 102,400 bytes for bf16 pools (Q tile and a
// three-stage ring of 32 KB K/V stages), plus 16 + 8 * cols for K4's
// owned-column list; 87,552 for int8 pools (16 KB stages, their scales and
// one 32 KB widened tile); two blocks an SM either way.
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

// K3: K1 over an int8 pool.
struct DecodeInt8Args : DecodeArgs {
  const float* k_scale;  // [tokens, n_kv]
  const float* v_scale;  // same
};

// K4: K1 over page shard `shard`'s slice ([pages_local * ps, n_kv, HD]);
// out is unused, the partials go to acc, m and l.
struct DecodePartialArgs : DecodeArgs {
  float* acc;  // [B, n_q, HD], un-normalised
  float* m;    // [B, n_q], natural-log units
  float* l;    // same
  int shard, pages_local;
};

template <typename TKV, bool kPartial>
using DecodeArgsOf =
    std::conditional_t<kPartial, DecodePartialArgs,
                       std::conditional_t<std::is_same<TKV, int8_t>::value, DecodeInt8Args,
                                          DecodeArgs>>;

template <typename TKV, int HD>
struct DecodeSmem {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kQ = kRows * HD * 2;                      // bf16 Q tile
  static constexpr int kStage = 2 * kKeys * HD * sizeof(TKV);    // K and V tiles
  static constexpr int kScales = kInt8 ? 2 * kKeys * 4 : 0;      // a stage's k and v scales
  static constexpr int kWide = kInt8 ? 2 * kKeys * HD * 2 : 0;   // widened bf16 K, V
  static constexpr int kRing = kStages * (kStage + kScales) + kWide;
  static constexpr int kBytes = kQ + kRing;
  // After the loop the ring holds the warps' partials, then the merge's weights.
  static_assert(kWarps * kRows * (HD + 2) * 4 <= kRing, "ring too small");
};

// Args is a template parameter of its own, so that profiles name the struct.
template <typename TKV, int HD, bool kPartial, typename Args = DecodeArgsOf<TKV, kPartial>>
__global__ void __launch_bounds__(kThreads) decode_attention_mma_kernel(Args a) {
  using S = DecodeSmem<TKV, HD>;
  constexpr bool kInt8 = S::kInt8;
  constexpr int kKs = HD / 16;  // k-steps of Q K^T
  constexpr int kNb = HD / 8;   // n-blocks of O
  extern __shared__ __align__(128) char smem[];
  __shared__ int is_last;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  char* ring = smem + S::kQ;
  // int8 pools: each stage's k and v scales, [stage][k, v][key].
  float* scale_ring = reinterpret_cast<float*>(ring + kStages * S::kStage);
  __nv_bfloat16* wide =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * (S::kStage + S::kScales));

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
  const long long row0 = static_cast<long long>(b) * a.n_q + kvh * group;  // the group's first row
  __nv_bfloat16* out = a.out + row0 * HD;
  if (split >= n_live) {
    if (split == 0) {  // no key at all: zeros, or (0, -1e30, 0)
      for (int i = threadIdx.x; i < group * HD; i += kThreads) {
        if constexpr (kPartial) {
          a.acc[row0 * HD + i] = 0.f;
          if (i % HD == 0) {
            a.m[row0 + i / HD] = kNegInf;
            a.l[row0 + i / HD] = 0.f;
          }
        } else {
          out[i] = __float2bfloat16(0.f);
        }
      }
    }
    return;
  }
  const int* table = a.tables + static_cast<long long>(b) * a.P;

  // The block's keys j < n_keys, all live: K1 and K3 at positions lo + j;
  // K4 offset j % ps of local page own_page[j / ps], its owned columns of the
  // split listed in table order.
  const int lo = split * a.cols * a.ps;
  int n_keys;
  int* own_page = nullptr;
  if constexpr (kPartial) {
    int* warp_n = reinterpret_cast<int*>(smem + S::kBytes);
    int* own_col = warp_n + kWarps;
    own_page = own_col + a.cols;
    const int c0 = split * a.cols, c1 = min(c0 + a.cols, n_cols);
    int n_own = 0;
    for (int base = c0; base < c1; base += kThreads) {  // uniform over the block
      const int col = base + threadIdx.x;
      const int page = col < c1 ? table[col] : -1;
      const bool own = page >= 0 && page / a.pages_local == a.shard;
      const unsigned ball = __ballot_sync(0xffffffffu, own);
      if (lane == 0) warp_n[warp] = __popc(ball);
      __syncthreads();
      int before = n_own;
      for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_n[w] : 0;
      if (own) {
        const int i = before + __popc(ball & ((1u << lane) - 1u));
        own_col[i] = col;
        own_page[i] = page - a.shard * a.pages_local;
      }
      for (int w = 0; w < kWarps; ++w) n_own += warp_n[w];
      __syncthreads();  // the list is complete; warp_n is free
    }
    // Only the last column below ctx is cut short, and it can only be the
    // last owned one.
    const bool cut = n_own > 0 && own_col[n_own - 1] == n_cols - 1;
    n_keys = n_own * a.ps - (cut ? n_cols * a.ps - hi : 0);
  } else {
    n_keys = min(hi, lo + a.cols * a.ps) - lo;
  }
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  auto issue = [&](int it) {
    char* stage = ring + (it % kStages) * S::kStage;
    const int j0 = it * kKeys;
    if constexpr (kPartial) {
      load_kv_tile<TKV, HD, kThreads>(a.k, a.v, nullptr, nullptr, a.n_kv, kvh,
                                      OwnedKeys{own_page, j0, n_keys, a.ps}, stage, nullptr);
    } else if constexpr (kInt8) {
      load_kv_tile<TKV, HD, kThreads>(a.k, a.v, a.k_scale, a.v_scale, a.n_kv, kvh,
                                      RunKeys{table, lo + j0, lo + n_keys, a.ps}, stage,
                                      scale_ring + (it % kStages) * 2 * kKeys);
    } else {
      load_kv_tile<TKV, HD, kThreads>(a.k, a.v, nullptr, nullptr, a.n_kv, kvh,
                                      RunKeys{table, lo + j0, lo + n_keys, a.ps}, stage, nullptr);
    }
  };

  {
    constexpr int kChunks = HD / 8;
    const __nv_bfloat16* q = a.q + row0 * HD;
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
    const int j0 = it * kKeys + 16 * warp;  // this warp's first key
    if (j0 >= n_keys) continue;             // (uniform over the warp)
    const __nv_bfloat16* k_t;
    const float* sc = scale_ring + st * 2 * kKeys;
    if constexpr (kInt8) {
      __syncwarp();  // the warp's reads of its previous widened keys are done
      widen_keys<HD, 32, 16>(reinterpret_cast<const int8_t*>(ring + st * S::kStage), wide,
                             16 * warp, lane);
      __syncwarp();
      k_t = wide;
    } else {
      k_t = reinterpret_cast<const __nv_bfloat16*>(ring + st * S::kStage);
    }
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

    // Online softmax over the warp's keys, rows g and g + 8; over an int8
    // pool each score column scaled by its key's k scale, and its v scale
    // folded into P.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 16 * warp + 8 * j + 2 * c + e;  // in the tile
          float x = s[j][2 * hr + e] * a.scale_log2;
          if constexpr (kInt8) x *= sc[key];
          x = it * kKeys + key < n_keys ? x : kNegInf;
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
          const int key = 16 * warp + 8 * j + 2 * c + e;
          const float p = it * kKeys + key < n_keys ? exp2f(s[j][2 * hr + e] - m_new) : 0.f;
          sum += p;
          s[j][2 * hr + e] = kInt8 ? p * sc[kKeys + key] : p;
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
    if (n_live > 1) {
      ws_acc[part * HD + i] = acc;
      if (d == 0) {
        ws_m[part + r] = mx;
        ws_l[part + r] = den;
      }
    } else if constexpr (kPartial) {
      a.acc[row0 * HD + i] = acc;
      if (d == 0) {
        a.m[row0 + r] = den > 0.f ? mx * kLn2 : kNegInf;
        a.l[row0 + r] = den;
      }
    } else {
      out[i] = __float2bfloat16(acc / fmaxf(den, 1e-30f));
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
  float* wt = reinterpret_cast<float*>(ring);  // [split][row]: 2^(m_s - M)
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
    if constexpr (kPartial) {
      a.m[row0 + r] = den > 0.f ? mx * kLn2 : kNegInf;
      a.l[row0 + r] = den;
    }
    den_s[r] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * HD; i += kThreads) {
    const int r = i / HD;
    float acc = 0.f;
    for (int s = 0; s < n_live; ++s)
      acc += __ldcg(ws_acc + (part0 + s * group) * HD + i) * wt[s * group + r];
    if constexpr (kPartial) {
      a.acc[row0 * HD + i] = acc;
    } else {
      out[i] = __float2bfloat16(acc / den_s[r]);
    }
  }
  if (threadIdx.x == 0) a.counters[bk] = 0;  // ready for the next launch
}

template <typename TKV, int HD, bool kPartial>
int launch(const DecodeArgsOf<TKV, kPartial>& a, int B, int splits, cudaStream_t stream) {
  using S = DecodeSmem<TKV, HD>;
  // The merge's weights ((splits + 1) x 16 floats) live in the ring.
  if ((splits + 1LL) * kRows * 4 > S::kRing) return static_cast<int>(cudaErrorInvalidValue);
  // K4's owned-column list: the warps' counts, then columns and local pages.
  const int smem = S::kBytes + (kPartial ? 4 * kWarps + 8 * a.cols : 0);
  auto kernel = decode_attention_mma_kernel<TKV, HD, kPartial>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, B * a.n_kv), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, bool kPartial>
int launch_hd(const DecodeArgsOf<TKV, kPartial>& a, int B, int hd, int splits,
              cudaStream_t stream) {
  if (hd == 64) return launch<TKV, 64, kPartial>(a, B, splits, stream);
  if (hd == 128) return launch<TKV, 128, kPartial>(a, B, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The checks both entry points share.
bool valid_plan(int B, int n_q, int n_kv, int ps, int P, int splits, int cols, const void* ws,
                const void* counters) {
  return n_kv > 0 && n_q % n_kv == 0 && n_q / n_kv <= kRows && ps > 0 && P >= 0 &&
         splits >= 1 && cols >= 0 && static_cast<long long>(splits) * cols >= P &&
         static_cast<long long>(B) * n_kv <= 65535 &&
         (splits == 1 || (ws != nullptr && counters != nullptr));
}

}  // namespace

extern "C" {

// q [B, n_q, hd] bf16; k, v [tokens, n_kv, hd] bf16 (kv_dtype 1) or int8
// (kv_dtype 2, with k_scale / v_scale [tokens, n_kv] f32); tables [B, P] and
// ctx_lens [B] int32; out [B, n_q, hd] bf16. `splits` splits of `cols`
// table columns each; with splits > 1, ws holds B * n_q * splits * (hd + 2)
// f32 and counters B * n_kv int32 zeros (left zero). The group n_q / n_kv is
// at most 16. Returns cudaGetLastError() of the launch.
int rb_paged_decode_attention_mma(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* tables,
                                  const void* ctx_lens, void* out, void* ws, void* counters,
                                  int B, int n_q, int n_kv, int hd, int ps, int P, int splits,
                                  int cols, float scale, int kv_dtype, void* stream) {
  if (B == 0) return 0;
  if (!valid_plan(B, n_q, n_kv, ps, P, splits, cols, ws, counters) ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const DecodeArgs base{static_cast<const __nv_bfloat16*>(q), k, v,
                        static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
                        static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
                        static_cast<int*>(counters), n_q, n_kv, ps, P, cols, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kBF16) return launch_hd<__nv_bfloat16, false>(base, B, hd, splits, s);
  if (kv_dtype == kI8) {
    const DecodeInt8Args a{base, static_cast<const float*>(k_scale),
                           static_cast<const float*>(v_scale)};
    return launch_hd<int8_t, false>(a, B, hd, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The page-split decode partial: q [B, n_q, hd] bf16 over page shard
// `shard`'s bf16 slice k, v [pages_local * ps, n_kv, hd] (tables hold global
// page ids). Writes acc [B, n_q, hd], m and l [B, n_q] f32, un-normalised, m
// in natural-log units. Splits, workspace and counters as for
// rb_paged_decode_attention_mma. Returns cudaGetLastError() of the launch.
int rb_paged_decode_attention_partial_mma(const void* q, const void* k, const void* v,
                                          const void* tables, const void* ctx_lens, void* acc,
                                          void* m, void* l, void* ws, void* counters, int B,
                                          int n_q, int n_kv, int hd, int ps, int P, int splits,
                                          int cols, int shard, int pages_local, float scale,
                                          void* stream) {
  if (B == 0) return 0;
  if (!valid_plan(B, n_q, n_kv, ps, P, splits, cols, ws, counters) || shard < 0 ||
      pages_local <= 0 || acc == nullptr || m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const DecodeArgs base{static_cast<const __nv_bfloat16*>(q), k, v,
                        static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
                        nullptr, static_cast<float*>(ws), static_cast<int*>(counters), n_q,
                        n_kv, ps, P, cols, scale * kLog2e};
  const DecodePartialArgs a{base, static_cast<float*>(acc), static_cast<float*>(m),
                            static_cast<float*>(l), shard, pages_local};
  return launch_hd<__nv_bfloat16, true>(a, B, hd, splits, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
