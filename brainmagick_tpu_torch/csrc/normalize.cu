// normalize_clamp_peak: for each sample b of a MEG batch,
//   out[b]  = clip((meg[b] - center[r(b)]) / scale[r(b)], -limit, limit)
//   peak[b] = max over (c, t) of |(meg[b] - center[r(b)]) / scale[r(b)]|
// (before the clamp), with r(b) = rec[b] when the caller gives the
// recordings' [R, C] tables and rec, else r(b) = b on [B, C] tables. meg is
// fp32 or bf16 (upcast exactly), out and peak fp32.
//
// Replaces the Pallas kernel brainmagick_tpu/ops/pallas_norm.py:51
// (normalize_clamp_peak / _kernel), which took one whole [1, C, T] sample
// per sequential grid step in VMEM, with center and scale already gathered
// by the caller. Here the gathers, the bf16 upcast and the zeroing of peak
// are folded in, so the normalize stage of a request or a step is one
// memset and one kernel.
//
// What bounds it on an H100 (3.35 TB/s): bytes. At the paper's [256, 273,
// 361] the kernel reads meg once (101 MB fp32, 50 MB bf16) and writes out
// once (101 MB): 0.060 ms fp32, 0.045 ms bf16; a handful of operations per
// element is far below the card's rate. So the design keeps HBM busy and
// does little else per element:
// - The flat [B C T] stream is cut into blocks of whole (b, c) rows of one
//   sample (the host's planner picks how many rows: 1024 to 8192 elements a
//   block, enough blocks to fill 132 SMs at B = 1, 3,328 at B = 256). A
//   block reads its sample's index rec[b] once, and the center and scale of
//   its rows once, into shared memory.
// - 16-byte vector loads and stores over the block's part of the flat
//   stream (4 fp32 or 8 bf16 in, 4 or 8 fp32 out), loads and stores marked
//   streaming. C T is odd at the paper shape, so a block's part starts and
//   ends off a vector boundary and vectors cross channel rows: the ragged
//   ends go element by element, and a vector walks its elements' channel
//   from its first element's (t reaching T moves to the next row). Where
//   meg or out is not 16-byte aligned, every element goes one by one.
// - The channel of an element is a multiply-high by the host's magic
//   number for T (exact for offsets below 2^31), never a division.
// - IEEE subtraction and division (__fsub_rn, __fdiv_rn), as the plain
//   version's fp32 ops, so out and peak equal it bit for bit.
// - The clamp is two compares that let a NaN through (fminf and fmaxf
//   would drop it) and send +-inf to +-limit.
// - The peak is the maximum of the uint32 bits of |x|: non-negative floats
//   order as their bits, and every NaN's bits sort above inf's, so the
//   maximum is exact, independent of order, and NaN when one element is.
//   Each thread keeps its own, a warp reduces it (redux), the block's
//   warps through shared memory, then one atomicMax per block into the
//   sample's peak, which the same entry zeroes first (cudaMemsetAsync).
//
// The C entry returns the cudaError_t of its calls; no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 64;  // (b, c) rows a block may take

// n / T for n < 2^31 by the host's (magic, shift)
__device__ __forceinline__ uint32_t divide(uint32_t n, uint32_t magic,
                                           int shift) {
  return static_cast<uint32_t>((static_cast<uint64_t>(n) * magic) >> shift);
}

// one element: its normalized value, clamped when asked, and its |.| bits
// folded into the thread's peak
__device__ __forceinline__ float normalize(float x, float center, float scale,
                                          float limit, bool clip,
                                          uint32_t& peak) {
  float v = __fdiv_rn(__fsub_rn(x, center), scale);
  peak = max(peak, __float_as_uint(v) & 0x7fffffffu);
  if (clip) {  // torch.clamp's order: min(max(v, -limit), limit)
    v = v < -limit ? -limit : v;
    v = v > limit ? limit : v;
  }
  return v;
}

__device__ __forceinline__ float bf16_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

template <bool BF16>
__device__ __forceinline__ float load_one(const void* meg, int64_t g) {
  if constexpr (BF16)
    return bf16_to_float(static_cast<const uint16_t*>(meg)[g]);
  else
    return static_cast<const float*>(meg)[g];
}

// One block: rows [c_lo, c_hi) of sample b = blockIdx.x / blocks_per_sample.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
normalize_clamp_peak(const void* __restrict__ meg,
                     const float* __restrict__ center,
                     const float* __restrict__ scale,
                     const int64_t* __restrict__ rec,
                     float* __restrict__ out, float* __restrict__ peak,
                     int64_t C, int64_t T, int64_t R, int rows,
                     int64_t blocks_per_sample, uint32_t magic, int shift,
                     float limit, int clip, int aligned) {
  constexpr int V = BF16 ? 8 : 4;  // elements in 16 bytes of meg
  __shared__ float s_center[MAX_ROWS];
  __shared__ float s_scale[MAX_ROWS];
  __shared__ uint32_t s_peak[THREADS / 32];
  const int64_t b = blockIdx.x / blocks_per_sample;
  const int64_t c_lo = (blockIdx.x - b * blocks_per_sample) * rows;
  const int64_t c_hi = c_lo + rows < C ? c_lo + rows : C;
  // JAX's gather rule: a negative index counts from the end, then clamp
  int64_t r = rec == nullptr ? b : rec[b];
  if (r < 0) r += R;
  r = r < 0 ? 0 : (r >= R ? R - 1 : r);
  for (int i = threadIdx.x; i < c_hi - c_lo; i += THREADS) {
    s_center[i] = center[r * C + c_lo + i];
    s_scale[i] = scale[r * C + c_lo + i];
  }
  __syncthreads();

  const bool do_clip = clip != 0;
  const int64_t sample = b * C * T;  // the sample's first element
  const int64_t g_lo = sample + c_lo * T;
  const int64_t g_hi = sample + c_hi * T;
  // [g_lo, v_lo) and [v_hi, g_hi) one by one, [v_lo, v_hi) in vectors
  int64_t v_lo = (g_lo + V - 1) / V * V;
  int64_t v_hi = g_hi / V * V;
  if (!aligned || v_lo >= v_hi) v_lo = v_hi = g_hi;
  const uint32_t T32 = static_cast<uint32_t>(T);
  uint32_t thread_peak = 0;

  auto one_by_one = [&](int64_t from, int64_t to) {
    for (int64_t g = from + threadIdx.x; g < to; g += THREADS) {
      const uint32_t c = divide(static_cast<uint32_t>(g - sample), magic,
                                shift) - static_cast<uint32_t>(c_lo);
      out[g] = normalize(load_one<BF16>(meg, g), s_center[c], s_scale[c],
                         limit, do_clip, thread_peak);
    }
  };
  one_by_one(g_lo, v_lo);
  for (int64_t g = v_lo + static_cast<int64_t>(threadIdx.x) * V; g < v_hi;
       g += static_cast<int64_t>(THREADS) * V) {
    float x[V];
    if constexpr (BF16) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>(meg) + g / V);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // little-endian: the low half first
        x[2 * i] = bf16_to_float(words[i] & 0xffffu);
        x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    } else {
      const float4 w = __ldcs(reinterpret_cast<const float4*>(meg) + g / V);
      x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
    }
    const uint32_t j = static_cast<uint32_t>(g - sample);
    uint32_t c = divide(j, magic, shift);
    uint32_t t = j - c * T32;
    c -= static_cast<uint32_t>(c_lo);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (t == T32) {  // the vector crossed into the next (b, c) row
        t = 0;
        ++c;
      }
      x[e] = normalize(x[e], s_center[c], s_scale[c], limit, do_clip,
                       thread_peak);
      ++t;
    }
    float4* dst = reinterpret_cast<float4*>(out + g);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      __stcs(dst + i, make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                  x[4 * i + 3]));
  }
  one_by_one(v_hi, g_hi);

  thread_peak = __reduce_max_sync(0xffffffffu, thread_peak);
  if (threadIdx.x % 32 == 0) s_peak[threadIdx.x / 32] = thread_peak;
  __syncthreads();
  if (threadIdx.x < 32) {
    uint32_t m = threadIdx.x < THREADS / 32 ? s_peak[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0)
      atomicMax(reinterpret_cast<unsigned int*>(peak) + b, m);
  }
}

}  // namespace

// meg [B, C, T] fp32 (is_bf16 = 0) or bf16 (1); center and scale [R, C]
// fp32; rec [B] int64, or null for r(b) = b (then R = B); out [B, C, T] and
// peak [B] fp32. All contiguous; any alignment (16 bytes takes the vector
// path). rows (b, c) rows a block, 1 to 64; (magic, shift) divide by T
// (exact below 2^31). B, C, T, R >= 1 and C T < 2^31. Zeroes peak, then
// launches the kernel on `stream`. Returns the cudaError_t of the calls
// (cudaErrorInvalidValue for a shape or plan the kernel does not take).
extern "C" int bm_normalize_clamp_peak(const void* meg, int is_bf16,
                                       const void* center, const void* scale,
                                       const void* rec, void* out, void* peak,
                                       long long B, long long C, long long T,
                                       long long R, float limit, int clip,
                                       int rows, unsigned int magic,
                                       int shift, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || T < 1 || R < 1 || C * T >= (1ll << 31) ||
      rows < 1 || rows > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks_per_sample = (C + rows - 1) / rows;
  const int64_t blocks = B * blocks_per_sample;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(peak, 0, sizeof(float) * B, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int aligned = reinterpret_cast<uintptr_t>(meg) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* c = static_cast<const float*>(center);
  const float* s = static_cast<const float*>(scale);
  const int64_t* r = static_cast<const int64_t*>(rec);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(peak);
  if (is_bf16)
    normalize_clamp_peak<true><<<static_cast<unsigned>(blocks), THREADS, 0,
                                 st>>>(meg, c, s, r, o, p, C, T, R, rows,
                                       blocks_per_sample, magic, shift,
                                       limit, clip, aligned);
  else
    normalize_clamp_peak<false><<<static_cast<unsigned>(blocks), THREADS, 0,
                                  st>>>(meg, c, s, r, o, p, C, T, R, rows,
                                        blocks_per_sample, magic, shift,
                                        limit, clip, aligned);
  return static_cast<int>(cudaGetLastError());
}
