// Int8 weight-only matmul of the decode and verify forwards, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel qmm_pallas (runbookai_tpu/ops/qmm_pallas.py, _qmm_kernel):
//
//   rb_qmm_int8:  out[M, N] = (x[M, K] @ widen(q[K, N])) * s[1, N]
//
// x is float32 or bfloat16, q int8 and row-major, s one float32 scale per output channel
// (runbookai_tpu_torch/models/quant.py). Sums are float32; the scale multiplies each
// finished sum once and the result is rounded once to x's type.
//
// What bounds it: at the serving shapes (M = 8 rows per decode step, 64 per T = 8 verify)
// the product is skinny and bound by the bytes of q: K * N bytes over 3.35 TB/s, which is
// 17.5 us for the 8B's gate, up and down matrices (58.7 MB), 5.0 us for wq and wo and
// 1.25 us for wk and wv. Its 2 * M * K * N operations are far below the tensor cores'
// rate at M <= 256 (the wrapper takes no more rows, as qmm_pallas does).
//
// Design: a block owns 8 rows x 128 output columns over one slice of K. Its 8 warps take
// the slice's rows of q in turn; lane l reads 4 neighbouring int8 weights with one 32-bit
// load, so a warp reads 128 contiguous bytes of a row of q, and keeps 8 x 4 float sums in
// registers. The slice's x rows are staged in shared memory as float, 256 columns at a
// time, and read as broadcasts. The warps' sums are added in shared memory. The wrapper
// splits K into slices so that the grid holds about two blocks per SM even where N is
// narrow (wk, wv); with one slice a block applies s and writes the output, with several
// each slice writes float partial sums to a workspace [splits, M, N] and a second kernel
// adds them in a fixed order, so the result does not depend on scheduling. Blocks that
// share a tile of q (the row tiles of one slice) are neighbours in the grid, so the
// second and later reads of a tile find it in L2. No tensor cores, cp.async or TMA yet.
//
// Built with every source of csrc/ by runbookai_tpu_torch/ops/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 8;     // rows of x per block
constexpr int kCols = 128;   // output columns per block: 4 per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 256;  // columns of x staged in shared memory at a time
constexpr int kFinishThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (ceil(M / kRows), N / kCols, K / k_split). With one slice (partial == null) the
// block writes out; otherwise it writes its float sums to partial[slice, M, N].
template <typename TX>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
           TX* __restrict__ out, float* __restrict__ partial, int M, int K, int N,
           int k_split) {
  __shared__ float x_s[kRows][kStage];
  __shared__ float red[kWarps][kRows][kCols];
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;
  const int slice = blockIdx.z;
  const int k_begin = slice * k_split, k_end = k_begin + k_split;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = min(kRows, M - m0);

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  const int8_t* q_lane = q + n0 + 4 * lane;
  for (int k0 = k_begin; k0 < k_end; k0 += kStage) {
    const int width = min(kStage, k_end - k0);
    __syncthreads();  // the previous stage of x is consumed
    for (int i = threadIdx.x; i < kRows * kStage; i += kThreads) {
      const int r = i / kStage, c = i % kStage;
      x_s[r][c] = (r < rows && c < width)
                      ? to_f32(x[static_cast<long long>(m0 + r) * K + k0 + c])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = warp; c < width; c += kWarps) {
      const char4 w = *reinterpret_cast<const char4*>(q_lane + static_cast<long long>(k0 + c) * N);
      const float w0 = w.x, w1 = w.y, w2 = w.z, w3 = w.w;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = x_s[r][c];
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
  for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][r][c];
    const long long o = static_cast<long long>(m0 + r) * N + n0 + c;
    if (partial == nullptr) {
      out[o] = from_f32<TX>(sum * s[n0 + c]);
    } else {
      partial[static_cast<long long>(slice) * M * N + o] = sum;
    }
  }
}

// out[i] = (sum over slices of partial[slice, i]) * s[i % N], slices in order.
template <typename TX>
__global__ void qmm_finish_kernel(const float* __restrict__ partial, const float* __restrict__ s,
                                  TX* __restrict__ out, int M, int N, int splits) {
  const long long total = static_cast<long long>(M) * N;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += partial[sp * total + i];
  out[i] = from_f32<TX>(sum * s[i % N]);
}

template <typename TX>
int launch(const void* x, const void* q, const void* s, void* out, void* partial, int M, int K,
           int N, int k_split, cudaStream_t stream) {
  const int splits = K / k_split;
  const dim3 grid((M + kRows - 1) / kRows, N / kCols, splits);
  float* ws = splits > 1 ? static_cast<float*>(partial) : nullptr;
  qmm_kernel<TX><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<TX*>(out), ws, M, K, N, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>((total + kFinishThreads - 1) / kFinishThreads);
  qmm_finish_kernel<TX><<<blocks, kFinishThreads, 0, stream>>>(
      ws, static_cast<const float*>(s), static_cast<TX*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [M, K] (x_dtype), q [K, N] int8, s [N] float32, out [M, N] (x_dtype), partial
// [K / k_split, M, N] float32 when k_split < K (else may be null). N must be a multiple of
// 128, k_split a multiple of 32 that divides K, and q 4-byte aligned. Returns
// cudaGetLastError() of the launches.
int rb_qmm_int8(const void* x, const void* q, const void* s, void* out, void* partial, int M,
                int K, int N, int k_split, int x_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % kCols != 0 || k_split <= 0 || k_split % 32 != 0 ||
      K % k_split != 0 || (k_split < K && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(q) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch<float>(x, q, s, out, partial, M, K, N, k_split, st);
  if (x_dtype == kBF16)
    return launch<__nv_bfloat16>(x, q, s, out, partial, M, K, N, k_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
