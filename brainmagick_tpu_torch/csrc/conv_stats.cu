// conv_stats: y = dilated SAME conv1d(x, w) (stride 1, odd k, no bias) and
// the per-channel sums s[o] = sum_{b,t} y[b,o,t], ss[o] = sum_{b,t} y^2 of
// the fp32 accumulator, in one pass over x. The BatchNorm that follows every
// encoder conv in training needs exactly these two sums.
//
// Replaces the Pallas kernel brainmagick_tpu/ops/pallas_conv_bn.py:89
// (_pallas_conv_stats / _kernel). On the TPU one program held a whole padded
// batch row in VMEM, ran the k taps as shifted in-VMEM matmuls, [T, C] @
// w[j] [C, O], and carried the sums from row to row along the sequential
// grid. On Hopper the blocks run in parallel and in no order, so nothing
// carries between them: each block writes its sums for its own tile to a
// [column tiles, O] workspace (column tile = batch row x 128 time steps),
// and a last kernel sums the column tiles in a fixed order, so a call gives
// the same bits every time (no atomics).
//
// Layout is the port's: x [B, C, T], w [O, C, k] (Conv1d's), y [B, O, T].
//
// What bounds it on an H100 (495 TFLOP/s TF32, 3.35 TB/s): the encoder
// layer at the paper shape (B 256, T 343, C = O = 320, k 3) is 2 B T C O k
// = 54 GFLOP. fp32 accuracy on the tensor cores takes three TF32 products
// (3xTF32), 162 GFLOP of TF32 work: 0.33 ms. x (112 MB) and y (112 MB) are
// read and written once: 0.07 ms. So operations bound it.
//
// fp32, the tensor-core route (conv_stats_tc): an implicit GEMM per block
// of 128 time steps x W output channels of one batch row.
// - Roles. Time is the wgmma M side: two consumer warpgroups of 64 time
//   steps each. Output channels are the N side, W in {8, 64, 128, 160}
//   (the host's planner picks it). K runs over (tap j, block of 32 input
//   channels), tap outer: y[., t] = sum_j x[., t + j d - pad] . w[:, :, j],
//   so each K step is one tap's [128 t, 32 c] x [32 c, W o] product, the
//   TPU kernel's own orientation.
// - TF32 wgmma takes only K-major operands from shared memory, and the x
//   tile [c][t] is time-contiguous. So x is the A operand, which wgmma also
//   reads from registers: the consumers read their A fragments (time row,
//   channel column) from the x tile in any layout, and split them there.
//   The weights are the B operand, K-major [2 k, O, C4] (hi taps, then lo
//   taps; C4 = C rounded up to 4, zero-padded): 1.2 MB at the paper shape.
//   Once per call the host rearranges them into [k, O, C4] (one copy) and
//   bm_split_tf32 splits that with sm90.cuh's pre-pass kernel.
// - Loads. One producer thread keeps a ring of stages filled with TMA
//   loads, signalled by full/empty mbarriers. A stage holds the x box of
//   tap j (32 channels x 136 time steps from about t0 + j d - pad, through
//   a 3D map over [B, C, T4]) and the hi and lo weight boxes (W output
//   channels x 32 channels, 128-byte swizzle, through a 3D map over
//   [2 k, O, C4]). TMA writes zeros for coordinates before 0 and past the
//   end, which is the SAME padding, the T edge, the channels past C (a 2D
//   [B C, T] map would read the next batch row's there) and the output
//   channels past O (a 2D [2 k O, C4] map would read the next tap's). TMA
//   takes a box only at a 16-byte aligned innermost coordinate (on the
//   card, an x box at an odd step never completed), so the x box starts
//   at the multiple of 4 at or before the tap's first step, and the
//   consumers read it from there plus the remainder (0 to 3): the box's 8
//   steps beyond the tile's 128 cover it. The x box row of 136 floats is
//   8 (mod 32) banks, so the fragment reads (lane g picks the time row,
//   lane t the channel) hit 32 banks with no swizzle. TMA needs 16-byte
//   rows too: the wrapper pads T to T4 = T rounded up to 4.
// - 3xTF32, as in nt_matmul.cu: x = hi + lo, hi = cvt.rna.tf32(x), lo =
//   cvt.rna.tf32(x - hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi for each of
//   the step's four k8 chunks. The 12 products of a step go into a fresh
//   accumulator that an fp32 add folds into the running sum (the tensor
//   core's own fp32 chain drifts, see nt_matmul_tiles; on the card, at the
//   paper shape, one accumulator over all 30 steps erred 6x more). At
//   W = 160 the fresh accumulator covers 80 columns at a time, so the
//   running sum (80 registers a thread), the fresh one (40) and the A
//   fragments (32) fit without spilling; the producer warpgroup gives the
//   consumers its registers (setmaxnreg).
// - Epilogue. y is stored for t < T and o < O. The rows at t >= T are
//   masked out of the sums too (the tap shifts make them nonzero). Each
//   column's sum and sum of squares are taken in a fixed order: the
//   thread's two rows, then __shfl_xor over the 8 lanes of a column, then
//   the 8 consumer warps in order through shared memory.
//
// bf16, the SIMT route (conv_stats_simt): an implicit GEMM with M = O, N =
// B T, K = C k on the fp32 SIMT cores. One block computes 64 output
// channels x 128 time steps of one batch row with 128 threads, each owning
// an 8 x 8 register tile. Per step of 16 input channels the block stages,
// in shared memory, the weights as [16 k][64] and the x window as
// [16 k][128]: one row per (channel, tap), each tap's row already shifted
// by its dilation, converted to fp32 while staged. The weights are first
// transposed once per call to [C k, O4] fp32 (a small kernel; O4 = O
// rounded up to 4, zero-padded) and staged with cp.async, double-buffered.
// The tap count k is a template parameter (1, 3, 5 or 7). Accumulation is
// fp32 and y is stored in bf16.
//
// Later work: bf16 on wgmma, one halo box per channel block read once for
// all taps, T4-aligned activations so the wrapper's pad copy goes, and the
// BatchNorm normalize (+ GELU) fused into the epilogue.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int BT = 128;                // time steps per block, both routes
constexpr int SMEM_LIMIT = 232448;     // 227 KB per block

// tensor-core route
constexpr int TC_CONSUMERS = 2;                       // warpgroups of 64 t
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);  // + the producer
constexpr int TC_BC = 32;              // input channels per K step
constexpr int X_ROW = BT + 8;          // x box row, 8 (mod 32) banks
constexpr int X_BYTES = TC_BC * X_ROW * 4;
constexpr int W_ROW_BYTES = TC_BC * 4;  // one 128-byte swizzle row
constexpr int TC_MAX_STAGES = 8;

// SIMT route
constexpr int BO = 64;                 // output channels per block
constexpr int BC = 16;                 // input channels per stage
constexpr int TO = 8;                  // threads along o
constexpr int TT = 16;                 // threads along t
constexpr int THREADS = TO * TT;       // 128 = BT: one x column per thread
constexpr int STAGES = 2;

constexpr int RED_O = 32;              // reduce: channels per block
constexpr int RED_G = 8;               // reduce: column groups per channel

using bf16 = __nv_bfloat16;

// One CTA: time steps [t0, t0 + 128) x output channels [o0, o0 + W) of
// batch row b, over K steps i = j c_blocks + cb (tap j, channels [32 cb,
// 32 cb + 32)). Stage s holds the x box [32 c][136 t], then the weights'
// hi and lo tiles [W o][32 c]. Writes y and this column tile's partial
// sums part_s/part_ss[b n_t_tiles + tile][o] for o < O.
template <int W>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_stats_tc(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map,
              float* __restrict__ y, float* __restrict__ part_s,
              float* __restrict__ part_ss, int C, int T_len, int O, int k,
              int dilation, int stages) {
  constexpr bool REBALANCE = W >= 128;
  // W = 160 sums each step in two fresh accumulators of 80 columns, one
  // after the other: one of 160 would not fit beside the running sum and
  // the A fragments (ptxas spilled it, and the kernel ran 31% slower)
  constexpr int PARTS = W > 128 ? 2 : 1;
  constexpr int W_BYTES = W * W_ROW_BYTES;
  constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment; the launch adds the slack
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + stages * STAGE_BYTES;  // 8 bytes per stage
  const uint32_t empty = full + 8 * stages;
  // the epilogue's per-warp column sums: [2][8 warps][W]
  float* red = reinterpret_cast<float*>(smem + stages * (STAGE_BYTES + 16));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * TC_CONSUMERS);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int t0 = blockIdx.x * BT;
  const int o0 = blockIdx.y * W;
  const int b = blockIdx.z;
  const int c_blocks = (C + TC_BC - 1) / TC_BC;
  const int steps = k * c_blocks;

  // one if-else for the two roles, never rejoined (setmaxnreg needs it)
  if (wg == TC_CONSUMERS) {
    // producer: one thread keeps the ring full
    if constexpr (REBALANCE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp % 4 == 0 && lane == 0) {
      const int first = t0 - (k / 2) * dilation;  // tap 0's first time step
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        const int round = i / stages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const uint32_t tile = base + s * STAGE_BYTES;
        const int j = i / c_blocks;
        const int c0 = (i - j * c_blocks) * TC_BC;
        // TMA takes a box only at a 16-byte aligned innermost coordinate
        tma_load_3d(tile, &x_map, (first + j * dilation) & ~3, c0, b,
                    full + 8 * s);
        tma_load_3d(tile + X_BYTES, &w_map, c0, o0, j, full + 8 * s);
        tma_load_3d(tile + X_BYTES + W_BYTES, &w_map, c0, o0, k + j,
                    full + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup wg owns time steps [64 wg, 64 wg + 64) of a tile
    if constexpr (REBALANCE)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = lane / 4;  // fragment row within the warp's 8-row group
    const int t = lane % 4;
    const int tau = 64 * wg + 16 * (warp % 4) + g;  // this thread's row
    const int first = t0 - (k / 2) * dilation;
    float d[W / 2];
    float step[W / 2 / PARTS];  // one K step's sum over one part
#pragma unroll
    for (int i = 0; i < W / 2; ++i) d[i] = 0.f;
#pragma unroll
    for (int i = 0; i < W / 2 / PARTS; ++i) step[i] = 0.f;
    fence_operands(d);

    for (int i = 0; i < steps; ++i) {
      const int s = i % stages;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      const uint32_t tile = base + s * STAGE_BYTES;
      // A fragment of k8 chunk jj: rows tau and tau + 8, channels 8 jj + t
      // and 8 jj + t + 4, read from the x box [channel][time], which starts
      // (first + j d) % 4 steps before the tap's first step
      const int shift = (first + (i / c_blocks) * dilation) & 3;
      const float* xs = reinterpret_cast<const float*>(smem + s * STAGE_BYTES)
                        + t * X_ROW + tau + shift;
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // q: (row, c), (row + 8, c), (row, c + 4), (row + 8, c + 4)
          const float v = xs[(8 * jj + 4 * (q / 2)) * X_ROW + 8 * (q % 2)];
          a_hi[jj][q] = to_tf32(v);
          a_lo[jj][q] = to_tf32(v - __uint_as_float(a_hi[jj][q]));
        }
      }
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        // output channels [part W / PARTS, (part + 1) W / PARTS): whole
        // 8-row swizzle groups of the weight tiles
        const uint32_t rows = part * (W / PARTS) * W_ROW_BYTES;
        const uint64_t w_hi = smem_desc(tile + X_BYTES + rows);
        const uint64_t w_lo = smem_desc(tile + X_BYTES + W_BYTES + rows);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          Wgmma<W / PARTS>::tf32(step, a_lo[jj], w_hi + 2 * jj, jj > 0);
          Wgmma<W / PARTS>::tf32(step, a_hi[jj], w_lo + 2 * jj, 1);
          Wgmma<W / PARTS>::tf32(step, a_hi[jj], w_hi + 2 * jj, 1);
        }
        wgmma_commit_and_wait();
        fence_operands(step);
#pragma unroll
        for (int r = 0; r < W / 2 / PARTS; ++r)
          d[part * (W / 2 / PARTS) + r] += step[r];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    fence_operands(d);

    // d[4 i + q] is (row tau + 8 (q / 2), channel o0 + 8 i + 2 t + q % 2)
    const int t_lo = t0 + tau;
    const int t_hi = t_lo + 8;
    const bool ok_lo = t_lo < T_len;
    const bool ok_hi = t_hi < T_len;
    float* red_s = red;  // [8 warps][W]; the consumer warps are 0..7
    float* red_ss = red + 8 * W;
#pragma unroll
    for (int i = 0; i < W / 8; ++i) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = 8 * i + 2 * t + p;
        const float v0 = ok_lo ? d[4 * i + p] : 0.f;
        const float v1 = ok_hi ? d[4 * i + 2 + p] : 0.f;
        if (o0 + col < O) {
          float* row = y + (static_cast<int64_t>(b) * O + o0 + col) * T_len;
          if (ok_lo) row[t_lo] = v0;
          if (ok_hi) row[t_hi] = v1;
        }
        float s = v0 + v1;
        float ss = v0 * v0 + v1 * v1;
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {  // the 8 lanes of a column
          s += __shfl_xor_sync(0xffffffffu, s, off);
          ss += __shfl_xor_sync(0xffffffffu, ss, off);
        }
        if (g == 0) {
          red_s[warp * W + col] = s;
          red_ss[warp * W + col] = ss;
        }
      }
    }
    // the 256 consumer threads only: the producer has left
    asm volatile("bar.sync 1, %0;" ::"n"(128 * TC_CONSUMERS) : "memory");
    const int col = threadIdx.x;
    if (col < W && o0 + col < O) {
      float s = 0.f;
      float ss = 0.f;
#pragma unroll
      for (int w = 0; w < 4 * TC_CONSUMERS; ++w) {
        s += red_s[w * W + col];
        ss += red_ss[w * W + col];
      }
      const int64_t tile = static_cast<int64_t>(b) * gridDim.x + blockIdx.x;
      part_s[tile * O + o0 + col] = s;
      part_ss[tile * O + o0 + col] = ss;
    }
  }
}

// map of a row-major [d2, d1, d0] fp32 tensor loaded in [1, box1, box0]
// boxes, zero-filled past its edges
bool encode_3d(CUtensorMap* map, const void* ptr, int64_t d0, int64_t d1,
               int64_t d2, int box0, int box1, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * 4),
                                 static_cast<cuuint64_t>(d0 * d1 * 4)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int W>
cudaError_t launch_tc(const CUtensorMap& x_map, const CUtensorMap& w_map,
                      float* y, float* part_s, float* part_ss, int64_t B,
                      int64_t C, int64_t T_len, int64_t O, int k,
                      int dilation, int stages, cudaStream_t stream) {
  constexpr int STAGE_BYTES = X_BYTES + 2 * W * W_ROW_BYTES;
  // 1024 bytes of alignment slack, 16 bytes of barriers per stage, then
  // the epilogue's sums
  const int smem = 1024 + stages * (STAGE_BYTES + 16) + 2 * 8 * W * 4;
  const int64_t n_o_tiles = (O + W - 1) / W;
  if (stages < 1 || stages > TC_MAX_STAGES || smem > SMEM_LIMIT ||
      B > 65535 || n_o_tiles > 65535)
    return cudaErrorInvalidValue;
  auto kernel = conv_stats_tc<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((T_len + BT - 1) / BT),
                  static_cast<unsigned>(n_o_tiles),
                  static_cast<unsigned>(B));
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      x_map, w_map, y, part_s, part_ss, static_cast<int>(C),
      static_cast<int>(T_len), static_cast<int>(O), k, dilation, stages);
  return cudaGetLastError();
}

// wt[r, o] = w[o, r] in fp32 for r over C k and o < O, 0 for O <= o < O4
__global__ void transpose_weights(const bf16* __restrict__ w,
                                  float* __restrict__ wt, int64_t O,
                                  int64_t O4, int64_t CK) {
  const int64_t n = O4 * CK;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / O4;
    const int64_t o = i - r * O4;
    wt[i] = o < O ? __bfloat162float(w[o * CK + r]) : 0.f;
  }
}

// asynchronous copy of 16 bytes; valid false writes zeros and reads
// nothing
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

// Shared memory per stage: xs [BC K][BT], then ws [BC K][BO].
template <int K>
__global__ void __launch_bounds__(THREADS)
conv_stats_simt(const bf16* __restrict__ x, const float* __restrict__ wt,
                bf16* __restrict__ y, float* __restrict__ part_s,
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
  const bf16* xb = x + b * C * T_len;
  // this thread's x column for each tap, and whether it lies inside [0, T)
  int64_t tap_t[K];
  bool tap_ok[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tap_t[j] = t0 + tid + static_cast<int64_t>(j - K / 2) * dilation;
    tap_ok[j] = tap_t[j] >= 0 && tap_t[j] < T_len;
  }

  // copies of one stage: row ci K + j of xs holds x[c0 + ci, t + j d - pad]
  // over the block's t (converted to fp32), and row r of ws holds
  // wt[c0 K + r, o0 : o0 + BO]
  auto load_stage = [&](int buf, int64_t c0) {
    float* xs = smem + buf * STAGE_FLOATS;
    float* ws = xs + ROWS * BT;
    const bf16* row = xb + c0 * T_len;
#pragma unroll
    for (int ci = 0; ci < BC; ++ci, row += T_len) {
      const bool c_ok = c0 + ci < C;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool ok = c_ok && tap_ok[j];
        xs[(ci * K + j) * BT + tid] =
            ok ? __bfloat162float(row[tap_t[j]]) : 0.f;
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
        if (o < O) y[(b * O + o) * T_len + t] = __float2bfloat16(v);
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

cudaError_t sum_columns(const float* part_s, const float* part_ss, void* s,
                        void* ss, int64_t n_cols, int64_t O,
                        cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((O + RED_O - 1) / RED_O);
  sum_column_tiles<<<blocks, RED_O * RED_G, 0, stream>>>(
      part_s, part_ss, static_cast<float*>(s), static_cast<float*>(ss),
      n_cols, O);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_simt(const void* x, const void* w, void* y, float* part_s,
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
    transpose_weights<<<static_cast<unsigned>(w_blocks), 256, 0, stream>>>(
        static_cast<const bf16*>(w), wt, O, O4, C * K);
  }
  const size_t smem = sizeof(float) * STAGES * BC * K * (BT + BO);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_stats_simt<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(n_t_tiles),
                  static_cast<unsigned>(n_o_tiles),
                  static_cast<unsigned>(B));
  conv_stats_simt<K><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), wt, static_cast<bf16*>(y), part_s,
      part_ss, C, T_len, O, O4, dilation, n_t_tiles);
  return cudaGetLastError();
}

}  // namespace

// The 3xTF32 split of x [count4 x 4] fp32 into hi and lo of the same size,
// all 16-byte aligned: the weights of conv_stats_tc, [k, O, C4] into the
// two halves of its [2 k, O, C4] operand. Returns the cudaError_t of the
// launch.
extern "C" int bm_split_tf32(const void* x, void* hi, void* lo,
                             long long count4, void* stream) {
  return static_cast<int>(launch_split_tf32(
      x, hi, lo, count4, static_cast<cudaStream_t>(stream)));
}

// fp32 on the tensor cores. x [B, C, T4] (T4 = T rounded up to 4, the
// columns past T zero), w_split [2 k, O, C4] (C4 = C rounded up to 4: hi
// taps then lo taps, the channels past C zero), both 16-byte aligned; y
// [B, O, T]; workspace fp32 of 2 B ceil(T / 128) O floats (the per-tile
// partial sums); s, ss [O] fp32. width in {8, 64, 128, 160} and stages as
// the host's planner gives them; odd k >= 1, dilation >= 1, B, C, T and
// O >= 1. Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for a width, stage count or shape the kernel does not take).
extern "C" int bm_conv_stats_tc(const void* x, const void* w_split, void* y,
                                void* workspace, void* s, void* ss,
                                long long B, long long C, long long T,
                                long long T4, long long O, int k,
                                int dilation, int width, int stages,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t C4 = (C + 3) / 4 * 4;
  const int64_t n_cols = B * ((T + BT - 1) / BT);
  float* part_s = static_cast<float*>(workspace);
  float* part_ss = part_s + n_cols * O;
  CUtensorMap x_map, w_map;
  if (T4 % 4 != 0 || T4 < T ||
      !encode_3d(&x_map, x, T4, C, B, X_ROW, TC_BC,
                 CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_3d(&w_map, w_split, C4, O, 2 * k, TC_BC, width,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = static_cast<float*>(y);
  cudaError_t err;
  switch (width) {
    case 8: err = launch_tc<8>(x_map, w_map, out, part_s, part_ss, B, C, T,
                               O, k, dilation, stages, st); break;
    case 64: err = launch_tc<64>(x_map, w_map, out, part_s, part_ss, B, C, T,
                                 O, k, dilation, stages, st); break;
    case 128: err = launch_tc<128>(x_map, w_map, out, part_s, part_ss, B, C,
                                   T, O, k, dilation, stages, st); break;
    case 160: err = launch_tc<160>(x_map, w_map, out, part_s, part_ss, B, C,
                                   T, O, k, dilation, stages, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_columns(part_s, part_ss, s, ss, n_cols, O, st));
}

// bf16 on the SIMT cores. x [B, C, T], w [O, C, k] row-major bf16; y
// [B, O, T] bf16; workspace fp32 of C k O4 + 2 B ceil(T / 128) O floats
// (O4 = O rounded up to 4: the transposed weights, then the per-tile
// partial sums), 16-byte aligned; s, ss [O] fp32. k in {1, 3, 5, 7},
// dilation >= 1; B, T and O >= 1. Returns the cudaError_t of the launches.
extern "C" int bm_conv_stats_bf16(const void* x, const void* w, void* y,
                                  void* workspace, void* s, void* ss,
                                  long long B, long long C, long long T,
                                  long long O, int k, int dilation,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_cols = B * ((T + BT - 1) / BT);
  float* wt = static_cast<float*>(workspace);
  float* part_s = wt + C * k * ((O + 3) / 4 * 4);
  float* part_ss = part_s + n_cols * O;
  cudaError_t err;
  switch (k) {
    case 1: err = launch_simt<1>(x, w, y, part_s, part_ss, wt, B, C, T, O,
                                 dilation, st); break;
    case 3: err = launch_simt<3>(x, w, y, part_s, part_ss, wt, B, C, T, O,
                                 dilation, st); break;
    case 5: err = launch_simt<5>(x, w, y, part_s, part_ss, wt, B, C, T, O,
                                 dilation, st); break;
    case 7: err = launch_simt<7>(x, w, y, part_s, part_ss, wt, B, C, T, O,
                                 dilation, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_columns(part_s, part_ss, s, ss, n_cols, O, st));
}
