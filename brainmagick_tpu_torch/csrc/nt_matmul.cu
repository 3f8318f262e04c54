// nt_matmul: out[M, N] = A[M, K] . B[N, K]^T with fp32 accumulation, for
// retrieval scoring: A holds the predictions (M = batch), B the candidate
// bank (N = 2048 candidates), K = F * T' = 351,232.
//
// Replaces the Pallas kernel brainmagick_tpu/ops/pallas_matmul.py:53
// (nt_matmul). On the TPU the grid walked K in order and accumulated into
// the resident output block; here blocks run in parallel, so K is split
// and the splits are summed in a second pass.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 495 TF32, 3.35 TB/s):
//   M = 256, fp32: 368 GFLOP. fp32 accuracy on the tensor cores takes three
//     TF32 products (3xTF32), 1.1 TFLOP: 2.2 ms at 495 TFLOP/s. Reading the
//     bank (2.88 GB) and the split predictions (0.72 GB) takes 1.1 ms.
//   M = 256, bf16: one product, 0.37 ms; reading 1.44 + 0.18 GB, 0.48 ms.
//   M = 1: a stream of the bank, 0.86 ms in fp32 and 0.43 ms in bf16.
//
// Design (one CTA = 128 bank rows x W prediction columns x one K chunk):
// - Roles. Bank rows are the wgmma M side: two consumer warpgroups of 64
//   rows each. The predictions are the wgmma N side, W the smallest width
//   in {8, 64, 128, 256} (bf16) or {8, 64, 128} (fp32) that covers M, with
//   a grid of tiles above that, so M = 1 computes 8 columns, not 64 rows.
//   Both operands are row-major with K contiguous, i.e. K-major, the only
//   layout TF32 wgmma takes. The accumulator holds a tile of out^T; the
//   epilogue stores it transposed into the [splits, M, N] partials (each
//   store is four 32-byte runs).
// - Pipeline. One producer thread keeps S stages of shared memory filled
//   with TMA loads (cp.async.bulk.tensor, 128-byte swizzle, one 128-byte
//   row per operand row per stage: BK = 32 fp32 or 64 bf16), signalled by
//   full/empty mbarriers. TMA zero-fills rows and columns past the tensor,
//   which covers ragged M, N and the last K chunk; stores are masked. S is
//   as many stages as fit in 227 KB, at most 8 (4 at W = 128 fp32).
// - bf16: wgmma m64nWk16 .f32.bf16.bf16, both operands from shared memory.
//   The products are exact, so this is the plain version's arithmetic up to
//   the order of the sums.
// - fp32, 3xTF32: x = hi + lo with hi = cvt.rna.tf32(x), lo =
//   cvt.rna.tf32(x - hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi. The
//   dropped lo lo term and the rounding of lo are each about 2^-22 of
//   |a_k b_k|, so the error stays near 7e-7 of |a||b| at worst; truncating
//   instead of rounding would give ~3e-6. TF32 wgmma reads B only from
//   shared memory, while A may come from registers: the bank tile (A) is
//   read from shared memory into registers and split there, and the
//   predictions are split once per call by a pre-pass kernel into [M, K]
//   hi and lo arrays (2 x 360 MB at M = 256), which TMA loads as two B
//   tiles. The 12 products of a K step sum in a fresh accumulator that an
//   fp32 add folds into the running sum (see nt_matmul_tiles).
// - Split-K fills the 132 SMs: the host's tile planner (ops/matmul.py)
//   picks the splits. Block x is the bank tile, so the bank tiles of one K
//   chunk run together and read their shared prediction chunk from L2. A
//   second kernel sums the splits in a fixed order: no atomics, so a call
//   gives the same bits every time.
// - TMA needs 16-byte aligned rows (K % 4 == 0 fp32, K % 8 == 0 bf16); the
//   wrapper zero-pads any other K once before the call.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 2;                    // warpgroups of 64 bank rows
constexpr int BANK_ROWS = 64 * CONSUMERS;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer
constexpr int ROW_BYTES = 128;                  // one swizzle row per stage
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;              // 227 KB per block

// One CTA: bank rows [bank0, bank0 + 128) x prediction columns [m0, m0 + W)
// over K steps [step0, step0 + steps) of BK = 128 bytes of K each. Stage s
// holds the bank tile [128, BK], then the prediction tile [W, BK] (bf16) or
// its hi and lo tiles (fp32). Writes partial[split][m][n] for m < M, n < N.
//
// fp32 sums each K step's 12 TF32 products in a fresh accumulator and adds
// it to the running sum with an fp32 add. Left to the tensor core over the
// whole chain, the fp32 sum drifts with the chain's length (on an H100, at
// K = 351,232: 2.6e-6 of |a||b| over 8 splits, 6.5e-7 over 33, 3.0e-7
// over 66), past the 1e-6 the scorer needs; a chain of 12 keeps it near
// the 3xTF32 split's own error. That doubles the accumulator, so fp32
// tiles stop at W = 128, whose 180-odd registers a thread gets by moving
// them from the producer warpgroup (setmaxnreg).
template <int W, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
nt_matmul_tiles(const __grid_constant__ CUtensorMap bank_map,
                const __grid_constant__ CUtensorMap pred_map,
                const __grid_constant__ CUtensorMap pred_lo_map,
                float* __restrict__ partial, int M, int N, int k_steps,
                int steps_per_split, int stages) {
  static_assert(BF16 || W <= 128, "fp32 tiles are at most 128 wide");
  constexpr bool REBALANCE = !BF16 && W == 128;
  constexpr int BK = ROW_BYTES / (BF16 ? 2 : 4);
  constexpr int BANK_BYTES = BANK_ROWS * ROW_BYTES;
  constexpr int PRED_BYTES = W * ROW_BYTES;
  constexpr int STAGE_BYTES = BANK_BYTES + PRED_BYTES * (BF16 ? 1 : 2);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment; the launch adds the slack
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + stages * STAGE_BYTES;  // 8 bytes per stage
  const uint32_t empty = full + 8 * stages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int bank0 = blockIdx.x * BANK_ROWS;
  const int m0 = blockIdx.y * W;
  const int step0 = blockIdx.z * steps_per_split;
  const int steps = min(k_steps - step0, steps_per_split);

  // one if-else for the two roles, never rejoined (setmaxnreg needs it)
  if (wg == CONSUMERS) {
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
        const int k = (step0 + i) * BK;
        tma_load(tile, &bank_map, k, bank0, full + 8 * s);
        tma_load(tile + BANK_BYTES, &pred_map, k, m0, full + 8 * s);
        if (!BF16)
          tma_load(tile + BANK_BYTES + PRED_BYTES, &pred_lo_map, k, m0,
                   full + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup wg owns bank rows [64 wg, 64 wg + 64) of a tile
    if constexpr (REBALANCE)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = lane / 4;  // fragment row within the warp's 8-row group
    const int t = lane % 4;
    float d[W / 2];
    float step[BF16 ? 1 : W / 2];  // fp32: one K step's sum
#pragma unroll
    for (int i = 0; i < W / 2; ++i) d[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (BF16 ? 1 : W / 2); ++i) step[i] = 0.f;
    fence_operands(d);

    for (int i = 0; i < steps; ++i) {
      const int s = i % stages;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      const uint32_t tile = base + s * STAGE_BYTES;
      const uint64_t pred = smem_desc(tile + BANK_BYTES);
      if constexpr (BF16) {
        const uint64_t bank = smem_desc(tile + wg * 64 * ROW_BYTES);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Wgmma<W>::bf16(d, bank + 2 * j, pred + 2 * j, 1);
        wgmma_commit_and_wait();
      } else {
        // A fragment of k8 chunk j: rows r and r + 8 (r = 16 warp + g), k
        // = 8 j + t and 8 j + t + 4. Row r's 16-byte chunk c sits at chunk
        // c ^ (r % 8) under the 128-byte swizzle, and r % 8 == g.
        const uint8_t* rows = smem + s * STAGE_BYTES +
                              (64 * wg + 16 * (warp % 4) + g) * ROW_BYTES +
                              4 * t;
        uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // q: (r, k), (r + 8, k), (r, k + 4), (r + 8, k + 4)
            const int chunk = (2 * j + q / 2) ^ g;
            const float x = *reinterpret_cast<const float*>(
                rows + (q % 2) * 8 * ROW_BYTES + 16 * chunk);
            a_hi[j][q] = to_tf32(x);
            a_lo[j][q] = to_tf32(x - __uint_as_float(a_hi[j][q]));
          }
        }
        const uint64_t pred_lo = smem_desc(tile + BANK_BYTES + PRED_BYTES);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Wgmma<W>::tf32(step, a_lo[j], pred + 2 * j, j > 0);  // a_lo b_hi
          Wgmma<W>::tf32(step, a_hi[j], pred_lo + 2 * j, 1);   // a_hi b_lo
          Wgmma<W>::tf32(step, a_hi[j], pred + 2 * j, 1);      // a_hi b_hi
        }
        wgmma_commit_and_wait();
        fence_operands(step);
#pragma unroll
        for (int r = 0; r < W / 2; ++r) d[r] += step[r];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    fence_operands(d);

    // d[4 i + q] is (bank row r + 8 (q / 2), column 8 i + 2 t + q % 2)
    float* out = partial + static_cast<int64_t>(blockIdx.z) * M * N;
    const int row = bank0 + 64 * wg + 16 * (warp % 4) + g;
#pragma unroll
    for (int i = 0; i < W / 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = row + 8 * (q / 2);
        const int m = m0 + 8 * i + 2 * t + q % 2;
        if (m < M && n < N)
          out[static_cast<int64_t>(m) * N + n] = d[4 * i + q];
      }
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

// map of a row-major [rows, cols] tensor loaded in [box_rows, 128 bytes]
// tiles with a 128-byte swizzle and zero fill past its edges
bool encode(CUtensorMap* map, const void* ptr, bool bf16, int64_t rows,
            int64_t cols, int box_rows) {
  const int elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * elem)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ROW_BYTES / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int W, bool BF16>
cudaError_t launch_tiles(const CUtensorMap& bank, const CUtensorMap& pred,
                         const CUtensorMap& pred_lo, float* partial,
                         int64_t M, int64_t N, int64_t K, int splits,
                         int64_t k_chunk, cudaStream_t stream) {
  constexpr int BK = ROW_BYTES / (BF16 ? 2 : 4);
  constexpr int STAGE_BYTES =
      BANK_ROWS * ROW_BYTES + W * ROW_BYTES * (BF16 ? 1 : 2);
  // 1024 bytes of alignment slack, 16 bytes of barriers per stage
  int stages = (SMEM_LIMIT - 1024) / (STAGE_BYTES + 16);
  stages = stages < MAX_STAGES ? stages : MAX_STAGES;
  const int smem = 1024 + stages * (STAGE_BYTES + 16);
  auto kernel = nt_matmul_tiles<W, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((N + BANK_ROWS - 1) / BANK_ROWS),
                  static_cast<unsigned>((M + W - 1) / W),
                  static_cast<unsigned>(splits));
  kernel<<<grid, THREADS, smem, stream>>>(
      bank, pred, pred_lo, partial, static_cast<int>(M), static_cast<int>(N),
      static_cast<int>((K + BK - 1) / BK), static_cast<int>(k_chunk / BK),
      stages);
  return cudaGetLastError();
}

}  // namespace

// a [M, K], b [N, K] row-major, both fp32 or both bf16 (is_bf16), 16-byte
// aligned with K % 4 == 0 (fp32) or K % 8 == 0 (bf16), K > 0; a_split
// [2, M, K] fp32 scratch for the hi/lo split (fp32 only); workspace
// [splits, M, N] fp32 (unused when splits == 1); out [M, N] fp32. width is
// the prediction tile W in {8, 64, 128} or, bf16 only, 256; K split z covers
// [z k_chunk, min(K, (z + 1) k_chunk)), k_chunk a multiple of BK.
// Returns the cudaError_t of the launches (cudaErrorInvalidValue when a
// tensor map cannot be encoded or the width is not one of the four).
extern "C" int bm_nt_matmul(const void* a, const void* b, int is_bf16,
                            void* a_split, void* workspace, void* out,
                            long long M, long long N, long long K, int width,
                            int splits, long long k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  const int box = width;
  CUtensorMap bank, pred, pred_lo;
  const void* pred_hi_ptr = a;
  const void* pred_lo_ptr = a;
  if (!bf16) {
    float* hi = static_cast<float*>(a_split);
    float* lo = hi + M * K;
    cudaError_t err = launch_split_tf32(a, hi, lo, M * K / 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    pred_hi_ptr = hi;
    pred_lo_ptr = lo;
  }
  if (!encode(&bank, b, bf16, N, K, BANK_ROWS) ||
      !encode(&pred, pred_hi_ptr, bf16, M, K, box) ||
      !encode(&pred_lo, pred_lo_ptr, bf16, M, K, box))
    return static_cast<int>(cudaErrorInvalidValue);
  float* partial = splits == 1 ? static_cast<float*>(out)
                               : static_cast<float*>(workspace);
  cudaError_t err;
#define BM_LAUNCH(W)                                                        \
  err = bf16 ? launch_tiles<W, true>(bank, pred, pred_lo, partial, M, N, K, \
                                     splits, k_chunk, s)                    \
             : launch_tiles<W, false>(bank, pred, pred_lo, partial, M, N,   \
                                      K, splits, k_chunk, s)
  switch (width) {
    case 8: BM_LAUNCH(8); break;
    case 64: BM_LAUNCH(64); break;
    case 128: BM_LAUNCH(128); break;
    case 256:
      if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
      err = launch_tiles<256, true>(bank, pred, pred_lo, partial, M, N, K,
                                    splits, k_chunk, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BM_LAUNCH
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t size = M * N;
  sum_splits<<<static_cast<unsigned>(grid_stride_blocks(size)), 256, 0, s>>>(
      partial, static_cast<float*>(out), size, splits);
  return static_cast<int>(cudaGetLastError());
}
