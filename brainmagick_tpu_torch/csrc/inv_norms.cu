// inv_norms: out[n] = 1 / (1e-8 + sqrt(sum over k of x[n, k]^2)) for a
// contiguous [N, K] block of fp32, bf16 or int8 rows, the sum in fp32; an
// all-zero row (or K = 0) gives 1e8. The inverse norms of a candidate bank
// in retrieval scoring.
//
// Replaces no TPU kernel: the JAX package's block_inv_norms
// (brainmagick_tpu/losses.py) is plain jnp that XLA fuses into one pass.
// PyTorch's eager version of the same arithmetic (losses.block_inv_norms)
// upcasts the block to fp32, writes its square and sums that: at the
// retrieval bank's [2048, 351,232] bf16 it moves about 13 GB where 1.44 GB
// read once would do. This kernel reads the block once.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Two flops an element
// against 1 to 4 bytes is far below the card's rate; the bank above takes
// 0.43 ms to read. So the design keeps HBM busy and does little else:
// - 16-byte vector loads (4 fp32, 8 bf16 or 16 int8 values a thread), UNROLL
//   of them in flight a thread before any is used, marked streaming; each
//   in-flight vector has its own accumulator, so the sums are UNROLL short
//   chains rather than one long one.
// - Squares accumulate in fp32 registers: bf16 is widened by a shift, int8
//   squares a 4-byte word at a time with __dp4a, exactly in int32 (at most
//   16 x 127^2 a vector), then into fp32.
// - A row's start need not be 16-byte aligned (int8 or bf16 rows of an odd
//   width, a view at an offset): the elements before the first aligned
//   vector and after the last one go one by one.
// - Grid. Blocks of 256 threads, registers capped so that an SM holds 8;
//   the host (ops/inv_norms.py) picks how many blocks share a row from N
//   and K. At N = 2048, one block a row: about two waves over 132 SMs. With
//   fewer rows than fill the card, a row's vectors are split over `splits`
//   blocks, each writing its partial sum, and a second kernel adds a row's
//   partials in split order. A block reduces with warp shuffles, then over
//   its warps in shared memory in warp order. No atomics: a call gives the
//   same bits every time.
//
// The C entry returns the cudaError_t of its launches; no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RESIDENT = 8;  // blocks an SM holds (ops/inv_norms.py's plan)
constexpr int UNROLL = 4;    // 16-byte loads in flight a thread

enum Type { FP32 = 0, BF16 = 1, INT8 = 2 };

template <int TYPE>
struct Elem;
template <>
struct Elem<FP32> {
  using T = float;
  static constexpr int BYTES = 4;
  __device__ static float value(float x) { return x; }
};
template <>
struct Elem<BF16> {
  using T = uint16_t;
  static constexpr int BYTES = 2;
  __device__ static float value(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
};
template <>
struct Elem<INT8> {
  using T = int8_t;
  static constexpr int BYTES = 1;
  __device__ static float value(int8_t x) { return static_cast<float>(x); }
};

// the sum of squares of the 16 bytes in w
template <int TYPE>
__device__ __forceinline__ float vector_squares(uint4 w) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  if constexpr (TYPE == FP32) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = __uint_as_float(words[i]);
      s = fmaf(v, v, s);
    }
    return s;
  } else if constexpr (TYPE == BF16) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: the low half first
      const float lo = __uint_as_float(words[i] << 16);
      const float hi = __uint_as_float(words[i] & 0xffff0000u);
      s = fmaf(lo, lo, s);
      s = fmaf(hi, hi, s);
    }
    return s;
  } else {
    int s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = static_cast<int>(words[i]);
      s = __dp4a(v, v, s);
    }
    return static_cast<float>(s);  // at most 258,064: exact
  }
}

__device__ __forceinline__ float inverse_norm(float squares) {
  return 1.f / (1e-8f + sqrtf(squares));
}

// Block b: split b % splits of row b / splits. Writes the row's inverse
// norm to out (splits == 1) or its partial sum of squares to partial[b].
template <int TYPE>
__global__ void __launch_bounds__(THREADS, RESIDENT)
inv_norms_rows(const void* __restrict__ x, float* __restrict__ partial,
               float* __restrict__ out, int64_t K, int splits) {
  using E = Elem<TYPE>;
  using T = typename E::T;
  constexpr int V = 16 / E::BYTES;  // elements a vector
  __shared__ float s_warp[THREADS / 32];
  const int64_t row = blockIdx.x / splits;
  const int split = static_cast<int>(blockIdx.x - row * splits);
  const T* base = static_cast<const T*>(x) + row * K;
  // [0, head) and [head + nvec V, K) one by one, the vectors between
  int64_t head = ((16 - reinterpret_cast<uintptr_t>(base) % 16) % 16) /
                 E::BYTES;
  head = head < K ? head : K;
  const int64_t nvec = (K - head) / V;
  const int64_t per_split = (nvec + splits - 1) / splits;
  const int64_t v_lo = split * per_split < nvec ? split * per_split : nvec;
  const int64_t v_hi = v_lo + per_split < nvec ? v_lo + per_split : nvec;
  const uint4* vec = reinterpret_cast<const uint4*>(base + head);

  float acc[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) acc[u] = 0.f;
  int64_t v = v_lo + threadIdx.x;
  for (; v + (UNROLL - 1) * THREADS < v_hi; v += UNROLL * THREADS) {
    uint4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) w[u] = __ldcs(vec + v + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] += vector_squares<TYPE>(w[u]);
  }
  // fewer than UNROLL vectors of this thread remain
#pragma unroll
  for (int u = 0; u < UNROLL - 1; ++u)
    if (v + u * THREADS < v_hi)
      acc[u] += vector_squares<TYPE>(__ldcs(vec + v + u * THREADS));
  if (split == 0) {
    for (int64_t i = threadIdx.x; i < head; i += THREADS) {
      const float e = E::value(base[i]);
      acc[0] = fmaf(e, e, acc[0]);
    }
  }
  if (split == splits - 1) {
    for (int64_t i = head + nvec * V + threadIdx.x; i < K; i += THREADS) {
      const float e = E::value(base[i]);
      acc[UNROLL - 1] = fmaf(e, e, acc[UNROLL - 1]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) sum += acc[u];
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, offset);
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += s_warp[w];
    if (splits == 1)
      out[row] = inverse_norm(total);
    else
      partial[blockIdx.x] = total;
  }
}

// out[n] from row n's `splits` partial sums, added in split order
__global__ void __launch_bounds__(THREADS)
inv_norms_splits(const float* __restrict__ partial, float* __restrict__ out,
                 int64_t N, int splits) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (row >= N) return;
  float total = 0.f;
  for (int s = 0; s < splits; ++s) total += partial[row * splits + s];
  out[row] = inverse_norm(total);
}

template <int TYPE>
cudaError_t launch(const void* x, float* partial, float* out, int64_t N,
                   int64_t K, int splits, cudaStream_t stream) {
  inv_norms_rows<TYPE><<<static_cast<unsigned>(N * splits), THREADS, 0,
                         stream>>>(x, partial, out, K, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  inv_norms_splits<<<static_cast<unsigned>((N + THREADS - 1) / THREADS),
                     THREADS, 0, stream>>>(partial, out, N, splits);
  return cudaGetLastError();
}

}  // namespace

// x [N, K] contiguous, of type `type` (0 fp32, 1 bf16, 2 int8), any
// alignment of its elements; out [N] fp32; partial [N, splits] fp32 when
// splits > 1 (unused at 1). N >= 1, K >= 0, 1 <= splits, N splits < 2^31.
// Launches on `stream`; returns the cudaError_t of the launches
// (cudaErrorInvalidValue for a shape, type or split the kernels do not
// take).
extern "C" int bm_inv_norms(const void* x, int type, void* partial, void* out,
                            long long N, long long K, int splits,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || K < 0 || splits < 1 || N * splits >= (1ll << 31) ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  switch (type) {
    case FP32: return static_cast<int>(launch<FP32>(x, p, o, N, K, splits,
                                                    st));
    case BF16: return static_cast<int>(launch<BF16>(x, p, o, N, K, splits,
                                                    st));
    case INT8: return static_cast<int>(launch<INT8>(x, p, o, N, K, splits,
                                                    st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
