// conv_stats: y = dilated SAME conv1d(x, w) (stride 1, odd k, no bias) and
// the per-channel sums s[o] = sum_{b,t} y[b,o,t], ss[o] = sum_{b,t} y^2 of
// the fp32 accumulator, in one pass over x. The BatchNorm that follows every
// encoder conv in training needs exactly these two sums.
//
// Replaces the Pallas kernel brainmagick_tpu/ops/pallas_conv_bn.py:89
// (_pallas_conv_stats / _kernel). On the TPU one program held a whole padded
// batch row in VMEM, ran the k taps as shifted in-VMEM matmuls and carried
// the sums from row to row along the sequential grid. On Hopper the blocks
// run in parallel and in no order, so nothing carries between them.
//
// Layout is the port's: x [B, C, T], w [O, C, k] (Conv1d's), y [B, O, T].
// What bounds it: fp32 FMA on the SIMT cores. The paper encoder layer is
// 2 B T C O k = 54 GFLOP (B 256, T 343, C = O = 320, k 3), about 0.54 TFLOP
// of forward conv per train step over 10 layers, against 67 TFLOP/s of fp32
// SIMT peak; x (112 MB) and y (112 MB) are read and written once.
//
// Design: an implicit GEMM with M = O, N = B T, K = C k. One block computes
// 64 output channels x 128 time steps of one batch row with 128 threads,
// each owning an 8 x 8 register tile. Per step of 16 input channels the
// block stages, in shared memory, the weights as [16 k][64] and the x
// window as [16 k][128]: one row per (channel, tap), each tap's row already
// shifted by its dilation, so that the taps never re-read device memory and
// every operand is read as aligned float4 (4 shared loads per 64 FMAs). A
// thread owns o in {4 to .. 4 to + 3, 32 + 4 to ..} and t in {4 tt ..,
// 64 + 4 tt ..} so those float4 reads are conflict-free. Stages are double-buffered with
// cp.async (zero-filling the masked edges), so the next step's copies fly
// while this one computes; a bf16 x is converted while staged, synchronously.
// The weights are first transposed once per call to [C k, O4] fp32 (a small
// kernel; O4 = O rounded up to 4, zero-padded), so they stage as aligned
// 16-byte copies. Measured on the card, the kernel is bound by how many
// instructions it runs, not by memory: the tap count k is a template
// parameter (1, 3, 5 or 7), so each thread's tap offsets and edge masks are
// computed once, not per staged element. Every edge (C, O, T, B) is masked.
// The epilogue reduces the accumulator's sum and sum of squares per output
// channel over the tile's valid t, and writes them to a [column tiles, O]
// workspace (column tile = batch row x time tile); a last kernel sums the
// column tiles in a fixed order, so the sums are the same from run to run
// (no atomics). Accumulation is fp32 and y is stored in x's type.
//
// Later work: bf16 through wgmma with TMA-fed tiles, and the BatchNorm
// normalize (+ GELU) fused into the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 64;                 // output channels per block
constexpr int BT = 128;                // time steps per block
constexpr int BC = 16;                 // input channels per stage
constexpr int TO = 8;                  // threads along o
constexpr int TT = 16;                 // threads along t
constexpr int THREADS = TO * TT;       // 128 = BT: one x column per thread
constexpr int STAGES = 2;

constexpr int RED_O = 32;              // reduce: channels per block
constexpr int RED_G = 8;               // reduce: column groups per channel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// asynchronous copies of 4 and 16 bytes; src_size 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void stage_x(float* dst, const float* src,
                                        bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void stage_x(float* dst, const __nv_bfloat16* src,
                                        bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

// wt[r, o] = w[o, r] in fp32 for r over C k and o < O, 0 for O <= o < O4
template <typename T>
__global__ void transpose_weights(const T* __restrict__ w,
                                  float* __restrict__ wt, int64_t O,
                                  int64_t O4, int64_t CK) {
  const int64_t n = O4 * CK;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / O4;
    const int64_t o = i - r * O4;
    wt[i] = o < O ? to_f32(w[o * CK + r]) : 0.f;
  }
}

// Shared memory per stage: xs [BC K][BT], then ws [BC K][BO].
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
conv_stats_tile(const T* __restrict__ x, const float* __restrict__ wt,
                T* __restrict__ y, float* __restrict__ part_s,
                float* __restrict__ part_ss, int64_t C, int64_t T_len,
                int64_t O, int64_t O4, int dilation, int n_t_tiles) {
  constexpr int ROWS = BC * K;
  constexpr int STAGE_FLOATS = ROWS * (BT + BO);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int to = tid / TT;
  const int tt = tid % TT;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t o0 = static_cast<int64_t>(blockIdx.y) * BO;
  const int64_t b = blockIdx.z;
  const T* xb = x + b * C * T_len;
  // this thread's x column for each tap, and whether it lies inside [0, T)
  int64_t tap_t[K];
  bool tap_ok[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tap_t[j] = t0 + tid + static_cast<int64_t>(j - K / 2) * dilation;
    tap_ok[j] = tap_t[j] >= 0 && tap_t[j] < T_len;
  }

  // copies of one stage: row ci K + j of xs holds x[c0 + ci, t + j d - pad]
  // over the block's t, and row r of ws holds wt[c0 K + r, o0 : o0 + BO]
  auto load_stage = [&](int buf, int64_t c0) {
    float* xs = smem + buf * STAGE_FLOATS;
    float* ws = xs + ROWS * BT;
    const T* row = xb + c0 * T_len;
#pragma unroll
    for (int ci = 0; ci < BC; ++ci, row += T_len) {
      const bool c_ok = c0 + ci < C;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool ok = c_ok && tap_ok[j];
        stage_x(xs + (ci * K + j) * BT + tid, ok ? row + tap_t[j] : xb, ok);
      }
    }
#pragma unroll
    for (int e = tid; e < ROWS * (BO / 4); e += THREADS) {
      const int r = e / (BO / 4);
      const int g = e % (BO / 4);
      const int64_t grow = c0 * K + r;
      const int64_t o = o0 + 4 * g;
      const bool ok = grow < C * K && o < O4;
      cp_async16(ws + r * BO + 4 * g, ok ? wt + grow * O4 + o : wt, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;

  const int64_t n_steps = (C + BC - 1) / BC;
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_steps) load_stage(i, i * BC);
    cp_async_commit();
  }
  for (int64_t step = 0; step < n_steps; ++step) {
    const int64_t next = step + STAGES - 1;
    if (next < n_steps) load_stage(next % STAGES, next * BC);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const float* xs = smem + (step % STAGES) * STAGE_FLOATS;
    const float4* xs4 = reinterpret_cast<const float4*>(xs);
    const float4* ws4 = reinterpret_cast<const float4*>(xs + ROWS * BT);
#pragma unroll 4
    for (int r = 0; r < ROWS; ++r) {
      const float4 a0 = ws4[r * (BO / 4) + to];
      const float4 a1 = ws4[r * (BO / 4) + BO / 8 + to];
      const float4 v0 = xs4[r * (BT / 4) + tt];
      const float4 v1 = xs4[r * (BT / 4) + BT / 8 + tt];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(a[i], v[q], acc[i][q]);
    }
    // the next iteration's copies overwrite the buffer just read
    __syncthreads();
  }

  // epilogue: store y, and reduce sum / sum of squares over the valid t
  const int64_t col = b * n_t_tiles + blockIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t o = o0 + (i < 4 ? 4 * to + i : BO / 2 + 4 * to + i - 4);
    float s = 0.f;
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int64_t t = t0 + (q < 4 ? 4 * tt + q : BT / 2 + 4 * tt + q - 4);
      if (t < T_len) {
        const float v = acc[i][q];
        s += v;
        ss = fmaf(v, v, ss);
        if (o < O) store(y + (b * O + o) * T_len + t, v);
      }
    }
    // the TT = 16 threads of one o row are one half-warp
#pragma unroll
    for (int off = TT / 2; off > 0; off /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (tt == 0 && o < O) {
      part_s[col * O + o] = s;
      part_ss[col * O + o] = ss;
    }
  }
}

// s[o] = sum over column tiles of part_s[col, o]: RED_G groups of
// consecutive columns summed in order, then the groups in order.
__global__ void __launch_bounds__(RED_O * RED_G)
sum_column_tiles(const float* __restrict__ part_s,
                 const float* __restrict__ part_ss, float* __restrict__ s,
                 float* __restrict__ ss, int64_t n_cols, int64_t O) {
  __shared__ float sh_s[RED_G][RED_O];
  __shared__ float sh_ss[RED_G][RED_O];
  const int ol = threadIdx.x % RED_O;
  const int g = threadIdx.x / RED_O;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * RED_O + ol;
  const int64_t chunk = (n_cols + RED_G - 1) / RED_G;
  const int64_t begin = g * chunk;
  const int64_t end = begin + chunk < n_cols ? begin + chunk : n_cols;
  float a = 0.f;
  float a2 = 0.f;
  if (o < O) {
    for (int64_t c = begin; c < end; ++c) {
      a += part_s[c * O + o];
      a2 += part_ss[c * O + o];
    }
  }
  sh_s[g][ol] = a;
  sh_ss[g][ol] = a2;
  __syncthreads();
  if (g == 0 && o < O) {
    float t = 0.f;
    float t2 = 0.f;
#pragma unroll
    for (int q = 0; q < RED_G; ++q) {
      t += sh_s[q][ol];
      t2 += sh_ss[q][ol];
    }
    s[o] = t;
    ss[o] = t2;
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, void* y, float* part_s,
                   float* part_ss, float* wt, int64_t B, int64_t C,
                   int64_t T_len, int64_t O, int dilation,
                   cudaStream_t stream) {
  const int n_t_tiles = static_cast<int>((T_len + BT - 1) / BT);
  const int64_t n_o_tiles = (O + BO - 1) / BO;
  if (B > 65535 || n_o_tiles > 65535) return cudaErrorInvalidConfiguration;
  const int64_t O4 = (O + 3) / 4 * 4;
  const int64_t n_w = O4 * C * K;
  const int64_t w_blocks = (n_w + 255) / 256 < 4096 ? (n_w + 255) / 256 : 4096;
  if (n_w > 0) {
    transpose_weights<T><<<static_cast<unsigned>(w_blocks), 256, 0, stream>>>(
        static_cast<const T*>(w), wt, O, O4, C * K);
  }
  const size_t smem = sizeof(float) * STAGES * BC * K * (BT + BO);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_stats_tile<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(n_t_tiles),
                  static_cast<unsigned>(n_o_tiles),
                  static_cast<unsigned>(B));
  conv_stats_tile<T, K><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), wt, static_cast<T*>(y), part_s, part_ss, C,
      T_len, O, O4, dilation, n_t_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, const void* w, void* y, float* part_s,
                     float* part_ss, float* wt, int64_t B, int64_t C,
                     int64_t T_len, int64_t O, int k, int dilation,
                     cudaStream_t stream) {
  switch (k) {
    case 1:
      return launch<T, 1>(x, w, y, part_s, part_ss, wt, B, C, T_len, O,
                          dilation, stream);
    case 3:
      return launch<T, 3>(x, w, y, part_s, part_ss, wt, B, C, T_len, O,
                          dilation, stream);
    case 5:
      return launch<T, 5>(x, w, y, part_s, part_ss, wt, B, C, T_len, O,
                          dilation, stream);
    case 7:
      return launch<T, 7>(x, w, y, part_s, part_ss, wt, B, C, T_len, O,
                          dilation, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, C, T], w [O, C, k] row-major, both fp32 or both bf16 (is_bf16);
// y [B, O, T] in the same type; workspace fp32 of C k O4 + 2 B ceil(T / 128) O
// floats (O4 = O rounded up to 4: the transposed weights, then the per-tile
// partial sums), 16-byte aligned; s, ss [O] fp32. k in {1, 3, 5, 7},
// dilation >= 1; B, T and O >= 1. Returns the cudaError_t of the launches.
extern "C" int bm_conv_stats(const void* x, const void* w, int is_bf16,
                             void* y, void* workspace, void* s, void* ss,
                             long long B, long long C, long long T,
                             long long O, int k, int dilation, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_cols = B * ((T + BT - 1) / BT);
  float* wt = static_cast<float*>(workspace);
  float* part_s = wt + C * k * ((O + 3) / 4 * 4);
  float* part_ss = part_s + n_cols * O;
  cudaError_t err =
      is_bf16 ? launch_k<__nv_bfloat16>(x, w, y, part_s, part_ss, wt, B, C,
                                        T, O, k, dilation, st)
              : launch_k<float>(x, w, y, part_s, part_ss, wt, B, C, T, O, k,
                                dilation, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((O + RED_O - 1) / RED_O);
  sum_column_tiles<<<blocks, RED_O * RED_G, 0, st>>>(
      part_s, part_ss, static_cast<float*>(s), static_cast<float*>(ss),
      n_cols, O);
  return static_cast<int>(cudaGetLastError());
}
