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
// bf16, the same kernel (conv_stats_tc<bf16, W>): one wgmma m64nWk16 bf16
// product per 16 channels, where fp32 takes three TF32 products per 8.
// - A K step is one 128-byte weight row, as in fp32: 64 bf16 channels. The
//   x box [64 c][136 t] is 17,408 bytes, as fp32's [32 c][136 t]; the stage
//   holds one weight tile [W o][64 c] (no lo tile), so at W = 160 five
//   stages fit. The weights are the K-major B operand [k, O, C8] (C8 = C
//   rounded up to 8, zero-padded; one rearranging copy per call, no split),
//   with the same 128-byte swizzle and descriptor as fp32.
// - A comes from registers as packed bf16x2: the fragment's two values of
//   a register are two neighbouring channels of one time step, which lie in
//   two rows of the time-contiguous [c][t] tile, so each register is two
//   16-bit reads and a pack. A 136-step bf16 row is 68 words (4 mod 32
//   banks); lane (g, t) reads channels 2t and 2t + 1 at step g, so the 8
//   values of g fall in 4 words and the 4 values of t 8 banks apart: no
//   two lanes of a warp read different words of one bank.
// - TMA's 16-byte alignment is 8 bf16 steps: the x box starts at the
//   multiple of 8 at or before the tap's first step and the consumers add
//   the remainder (0 to 7), which the box's 8 extra steps cover; the
//   wrapper pads T to T8 = T rounded up to 8.
// - One running fp32 accumulator over all the K steps: the products are
//   exact, and at the paper shape the chain is C k = 960 deep (60 k16
//   products), far from the 32,768-deep chains past which the tensor
//   core's fp32 sum drifted in nt_matmul (ops/matmul.py, MAX_BF16_STEPS).
//   At W = 160 it is 80 registers a thread in one pass. y is the
//   accumulator rounded to bf16 (round to nearest even); the sums are taken
//   over the fp32 accumulator, as the JAX kernel's.
// - What bounds it: one bf16 product, 54 GFLOP at 989 TFLOP/s, 0.055 ms;
//   x and y (56 MB each in bf16) 0.034 ms. Operations bound it.
//
// Later work: a persistent grid, one halo box per channel block read once
// for all taps, T4/T8-aligned activations so the wrapper's pad copy goes,
// and the BatchNorm normalize (+ GELU) fused into the epilogue.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int BT = 128;                // time steps per block
constexpr int SMEM_LIMIT = 232448;     // 227 KB per block
constexpr int TC_CONSUMERS = 2;                       // warpgroups of 64 t
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);  // + the producer
constexpr int ROW_BYTES = 128;         // a K step's weight row (swizzle row)
constexpr int X_ROW = BT + 8;          // x box row, time steps
constexpr int X_BYTES = ROW_BYTES * X_ROW;  // the x box, either type
constexpr int TC_MAX_STAGES = 8;

constexpr int RED_O = 32;              // reduce: channels per block
constexpr int RED_G = 8;               // reduce: column groups per channel

using bf16 = __nv_bfloat16;

// What the element type sets: input channels per K step (one 128-byte
// weight row), weight tiles per stage (fp32: hi and lo), and TMA's
// 16-byte alignment in elements.
template <typename E>
struct Route {
  static constexpr bool FP32 = sizeof(E) == 4;
  static constexpr int CHANNELS = ROW_BYTES / sizeof(E);
  static constexpr int W_TILES = FP32 ? 2 : 1;
  static constexpr int ALIGN = 16 / sizeof(E);
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// One CTA: time steps [t0, t0 + 128) x output channels [o0, o0 + W) of
// batch row b, over K steps i = j c_blocks + cb (tap j, channels
// [CH cb, CH cb + CH), CH = 32 fp32 or 64 bf16). Stage s holds the x box
// [CH c][136 t], then the weights' tile [W o][CH c] (fp32: its hi and lo
// tiles). Writes y and this column tile's partial sums
// part_s/part_ss[b n_t_tiles + tile][o] for o < O.
template <typename E, int W>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_stats_tc(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map,
              E* __restrict__ y, float* __restrict__ part_s,
              float* __restrict__ part_ss, int C, int T_len, int O, int k,
              int dilation, int stages) {
  using R = Route<E>;
  constexpr bool REBALANCE = W >= 128;
  // fp32 at W = 160 sums each step in two fresh accumulators of 80
  // columns, one after the other: one of 160 would not fit beside the
  // running sum and the A fragments (ptxas spilled it, and the kernel ran
  // 31% slower)
  constexpr int PARTS = R::FP32 && W > 128 ? 2 : 1;
  constexpr int W_BYTES = W * ROW_BYTES;
  constexpr int STAGE_BYTES = X_BYTES + R::W_TILES * W_BYTES;
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
  const int c_blocks = (C + R::CHANNELS - 1) / R::CHANNELS;
  const int steps = k * c_blocks;
  const int first = t0 - (k / 2) * dilation;  // tap 0's first time step

  // one if-else for the two roles, never rejoined (setmaxnreg needs it)
  if (wg == TC_CONSUMERS) {
    // producer: one thread keeps the ring full
    if constexpr (REBALANCE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp % 4 == 0 && lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        const int round = i / stages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const uint32_t tile = base + s * STAGE_BYTES;
        const int j = i / c_blocks;
        const int c0 = (i - j * c_blocks) * R::CHANNELS;
        // TMA takes a box only at a 16-byte aligned innermost coordinate
        tma_load_3d(tile, &x_map, (first + j * dilation) & -R::ALIGN, c0, b,
                    full + 8 * s);
        tma_load_3d(tile + X_BYTES, &w_map, c0, o0, j, full + 8 * s);
        if constexpr (R::FP32)
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
    float d[W / 2];
    // fp32: one K step's sum over one part
    constexpr int STEP = R::FP32 ? W / 2 / PARTS : 1;
    float step[STEP];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) d[i] = 0.f;
#pragma unroll
    for (int i = 0; i < STEP; ++i) step[i] = 0.f;
    fence_operands(d);

    for (int i = 0; i < steps; ++i) {
      const int s = i % stages;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      const uint32_t tile = base + s * STAGE_BYTES;
      // the x box [channel][time] starts this many steps before the tap's
      // first step
      const int shift = (first + (i / c_blocks) * dilation) & (R::ALIGN - 1);
      if constexpr (R::FP32) {
        // A fragment of k8 chunk jj: rows tau and tau + 8, channels 8 jj +
        // t and 8 jj + t + 4
        const float* xs =
            reinterpret_cast<const float*>(smem + s * STAGE_BYTES) +
            t * X_ROW + tau + shift;
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
          const uint32_t rows = part * (W / PARTS) * ROW_BYTES;
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
          for (int r = 0; r < STEP; ++r) d[part * STEP + r] += step[r];
        }
      } else {
        // A fragment of k16 chunk kk, register q: rows tau + 8 (q % 2),
        // channels 16 kk + 2 t + 8 (q / 2) (low half) and the next one
        // (high half), read from their two rows of the x box
        const uint16_t* xs =
            reinterpret_cast<const uint16_t*>(smem + s * STAGE_BYTES) +
            2 * t * X_ROW + tau + shift;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint16_t* p = xs + (16 * kk + 8 * (q / 2)) * X_ROW
                                + 8 * (q % 2);
            a[kk][q] = static_cast<uint32_t>(p[0]) |
                       (static_cast<uint32_t>(p[X_ROW]) << 16);
          }
        }
        const uint64_t w = smem_desc(tile + X_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<W>::bf16_rs(d, a[kk], w + 2 * kk, 1);
        wgmma_commit_and_wait();
        fence_operands(d);
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
          E* row = y + (static_cast<int64_t>(b) * O + o0 + col) * T_len;
          if (ok_lo) store(row + t_lo, v0);
          if (ok_hi) store(row + t_hi, v1);
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

// map of a row-major [d2, d1, d0] fp32 or bf16 tensor loaded in [1, box1,
// box0] boxes, zero-filled past its edges
bool encode_3d(CUtensorMap* map, const void* ptr, bool is_bf16, int64_t d0,
               int64_t d1, int64_t d2, int box0, int box1,
               CUtensorMapSwizzle swizzle) {
  const int64_t elem = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * elem),
                                 static_cast<cuuint64_t>(d0 * d1 * elem)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int W>
cudaError_t launch_tc(const CUtensorMap& x_map, const CUtensorMap& w_map,
                      void* y, float* part_s, float* part_ss, int64_t B,
                      int64_t C, int64_t T_len, int64_t O, int k,
                      int dilation, int stages, cudaStream_t stream) {
  constexpr int STAGE_BYTES = X_BYTES + Route<E>::W_TILES * W * ROW_BYTES;
  // 1024 bytes of alignment slack, 16 bytes of barriers per stage, then
  // the epilogue's sums
  const int smem = 1024 + stages * (STAGE_BYTES + 16) + 2 * 8 * W * 4;
  const int64_t n_o_tiles = (O + W - 1) / W;
  if (stages < 1 || stages > TC_MAX_STAGES || smem > SMEM_LIMIT ||
      B > 65535 || n_o_tiles > 65535)
    return cudaErrorInvalidValue;
  auto kernel = conv_stats_tc<E, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((T_len + BT - 1) / BT),
                  static_cast<unsigned>(n_o_tiles),
                  static_cast<unsigned>(B));
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      x_map, w_map, static_cast<E*>(y), part_s, part_ss,
      static_cast<int>(C), static_cast<int>(T_len), static_cast<int>(O), k,
      dilation, stages);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_width(int width, const CUtensorMap& x_map,
                         const CUtensorMap& w_map, void* y, float* part_s,
                         float* part_ss, int64_t B, int64_t C, int64_t T_len,
                         int64_t O, int k, int dilation, int stages,
                         cudaStream_t st) {
  switch (width) {
    case 8: return launch_tc<E, 8>(x_map, w_map, y, part_s, part_ss, B, C,
                                   T_len, O, k, dilation, stages, st);
    case 64: return launch_tc<E, 64>(x_map, w_map, y, part_s, part_ss, B, C,
                                     T_len, O, k, dilation, stages, st);
    case 128: return launch_tc<E, 128>(x_map, w_map, y, part_s, part_ss, B,
                                       C, T_len, O, k, dilation, stages, st);
    case 160: return launch_tc<E, 160>(x_map, w_map, y, part_s, part_ss, B,
                                       C, T_len, O, k, dilation, stages, st);
    default: return cudaErrorInvalidValue;
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

// conv_stats on the tensor cores, fp32 or bf16 (is_bf16). x [B, C, T_pad]
// (T_pad = T rounded up to 4 fp32 or 8 bf16, the columns past T zero);
// w_op the weights as the B operand: fp32 [2 k, O, C4] (hi taps then lo
// taps), bf16 [k, O, C8] (C4, C8 = C rounded up to 4 or 8, the channels
// past C zero); both 16-byte aligned. y [B, O, T] in x's type; workspace
// fp32 of 2 B ceil(T / 128) O floats (the per-tile partial sums); s, ss
// [O] fp32. width in {8, 64, 128, 160} and stages as the host's planner
// gives them; odd k >= 1, dilation >= 1, B, C, T and O >= 1. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a width, stage
// count or shape the kernel does not take).
extern "C" int bm_conv_stats_tc(const void* x, const void* w_op, int is_bf16,
                                void* y, void* workspace, void* s, void* ss,
                                long long B, long long C, long long T,
                                long long T_pad, long long O, int k,
                                int dilation, int width, int stages,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16_op = is_bf16 != 0;
  const int align = bf16_op ? Route<bf16>::ALIGN : Route<float>::ALIGN;
  const int channels = bf16_op ? Route<bf16>::CHANNELS
                               : Route<float>::CHANNELS;
  const int taps = bf16_op ? k : 2 * k;
  const int64_t C_pad = (C + align - 1) / align * align;
  const int64_t n_cols = B * ((T + BT - 1) / BT);
  float* part_s = static_cast<float*>(workspace);
  float* part_ss = part_s + n_cols * O;
  CUtensorMap x_map, w_map;
  if (T_pad % align != 0 || T_pad < T ||
      !encode_3d(&x_map, x, bf16_op, T_pad, C, B, X_ROW, channels,
                 CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_3d(&w_map, w_op, bf16_op, C_pad, O, taps, channels, width,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16_op ? launch_width<bf16>(width, x_map, w_map, y, part_s, part_ss,
                                   B, C, T, O, k, dilation, stages, st)
              : launch_width<float>(width, x_map, w_map, y, part_s, part_ss,
                                    B, C, T, O, k, dilation, stages, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_columns(part_s, part_ss, s, ss, n_cols, O, st));
}
