// nt_matmul: out[M, N] = A[M, K] . B[N, K]^T with fp32 accumulation, for
// retrieval scoring (predictions against a candidate block, K = F * T).
//
// Replaces the Pallas kernel brainmagick_tpu/ops/pallas_matmul.py:nt_matmul.
// On the TPU the grid walked K in order and accumulated into the resident
// output block. On Hopper the blocks run in parallel and in no order, and
// the shape is a poor fit for a plain tiled GEMM: at M = 256, N = 2048 there
// are only 4 x 32 = 128 output tiles of 64 x 64 for 132 SMs, while K is
// 351,232 deep. What bounds it is the fp32 FMA rate (2 M N K = 368 GFLOP at
// M = 256, about 5.5 ms at the 67 TFLOP/s SIMT peak); at M = 1 it is the
// read of B (2.9 GB fp32).
//
// Design: a shared-memory tiled GEMM, 64 x 64 output tile, BK = 32, 256
// threads with a 4 x 4 register micro-tile each, split over K so that
// several blocks per SM are in flight. Each split writes its partial tile
// into a [splits, M, N] fp32 workspace; a second kernel sums the splits in
// a fixed order, so the result is the same from run to run (no atomics).
// The M tiles of one (N tile, K split) are adjacent in launch order, so
// they read the same B tile while it is still in L2. Operands are fp32 or
// bf16 (converted to fp32 when staged into shared memory). Every edge is
// masked: any M, N and K work. wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int ROWS_PER_PASS = THREADS / BK;      // 8 tile rows per load pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One (M tile, N tile, K split) block. Thread (tm, tn) owns rows
// tm + 16 i and columns tn + 16 j of the tile, so the 16 threads of a
// half-warp read 16 consecutive shared-memory words (no bank conflicts)
// and store 16 consecutive output columns (coalesced).
template <typename T>
__global__ void __launch_bounds__(THREADS)
nt_matmul_partial(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ partial, int64_t M, int64_t N,
                  int64_t K, int64_t k_chunk) {
  // k-major tiles; the +1 pad makes the transposing stores conflict-free
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tm = tid / (BN / TN);
  const int tn = tid % (BN / TN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * k_chunk;
  const int64_t k_end = k_begin + k_chunk < K ? k_begin + k_chunk : K;

  // load mapping: a warp reads 32 consecutive k of one row (coalesced)
  const int lk = tid % BK;
  const int lr = tid / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    const int64_t k = k0 + lk;
    const bool k_ok = k < k_end;
#pragma unroll
    for (int p = 0; p < BM; p += ROWS_PER_PASS) {
      const int r = lr + p;
      const int64_t m = m0 + r;
      const int64_t n = n0 + r;
      As[lk][r] = (k_ok && m < M) ? to_f32(a[m * K + k]) : 0.f;
      Bs[lk][r] = (k_ok && n < N) ? to_f32(b[n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM];
      float rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = As[kk][tm + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = Bs[kk][tn + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + tm + i * (BM / TM);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + tn + j * (BN / TN);
      if (m < M && n < N) out[m * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum over s of partial[s, i], s in increasing order
__global__ void sum_splits(const float* __restrict__ partial,
                           float* __restrict__ out, int64_t size,
                           int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += stride) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * size + i];
    out[i] = s;
  }
}

}  // namespace

// a [M, K], b [N, K] row-major (both fp32, or both bf16 when is_bf16);
// workspace [splits, M, N] fp32 (unused when splits == 1); out [M, N]
// fp32. K split z covers [z k_chunk, min(K, (z + 1) k_chunk)).
// Returns the cudaError_t of the launches.
extern "C" int bm_nt_matmul(const void* a, const void* b, int is_bf16,
                            void* workspace, void* out, long long M,
                            long long N, long long K, int splits,
                            long long k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = splits == 1 ? static_cast<float*>(out)
                               : static_cast<float*>(workspace);
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>(splits));
  if (is_bf16) {
    nt_matmul_partial<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), partial, M, N, K, k_chunk);
  } else {
    nt_matmul_partial<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), partial,
        M, N, K, k_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(M) * N;
  const int64_t wanted = (size + 255) / 256;
  const int64_t blocks = wanted < 4096 ? wanted : 4096;
  sum_splits<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      partial, static_cast<float*>(out), size, splits);
  return static_cast<int>(cudaGetLastError());
}
