// PTX wrappers shared by the package's Hopper (sm_90a) kernels: mbarriers,
// TMA tensor loads, wgmma descriptors and products, the TF32 rounding of
// the 3xTF32 split and its pre-pass kernel, and the lookup of
// cuTensorMapEncodeTiled.
//
// Everything here is inline or in an unnamed namespace, so any number of
// sources can include it; each source still builds in its own nvcc
// process.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the phase with the given parity has completed; a pipeline
// that stalls for seconds traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// 2D tile [box rows, box cols] at (col, row) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// 3D box at coordinates (c0, c1, c2), innermost first; coordinates may
// be negative or past the tensor, where the box reads zeros
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle,
// 8-row groups 1024 bytes apart; the tile starts 1024-byte aligned. Adding
// 2 moves it 32 bytes along K (one k16 bf16 or k8 tf32 step).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads across the async wgmma
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nW with an fp32 accumulator of W / 2 registers per thread: bf16
// with both operands in shared memory, bf16 with A in registers (bf16_rs;
// four registers of two values, the lower K index in the low half), or
// tf32 with A in registers (W <= 128). acc = 0 overwrites the accumulator,
// 1 adds to it. The operand lists are written out in full, as PTX
// requires.
#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC32(i)                                                       \
  ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12), ACC4(i + 16),       \
      ACC4(i + 20), ACC4(i + 24), ACC4(i + 28)

template <int W>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void bf16(float (&d)[4], uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;}\n"
      : ACC4(0)
      : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void tf32(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;}\n"
      : ACC4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void bf16_rs(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;}\n"
      : ACC4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void bf16(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;}\n"
      : ACC32(0)
      : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void bf16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void tf32(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;}\n"
      : ACC32(0), ACC4(32), ACC4(36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void bf16(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;}\n"
      : ACC32(0), ACC32(32)
      : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void tf32(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;}\n"
      : ACC32(0), ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void bf16_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;}\n"
      : ACC32(0), ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void bf16_rs(float (&d)[80],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;}\n"
      : ACC32(0), ACC32(32), ACC4(64), ACC4(68), ACC4(72),
        ACC4(76)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void bf16(float (&d)[128], uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;}\n"
      : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
      : "l"(a), "l"(b), "r"(acc));
  }
};

#undef ACC32
#undef ACC4

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the library does not
// link; it is looked up once through cudart
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

namespace {

// blocks of 256 threads for a grid-stride loop over `count` items
inline int64_t grid_stride_blocks(int64_t count) {
  const int64_t wanted = (count + 255) / 256;
  return wanted < 4096 ? (wanted > 0 ? wanted : 1) : 4096;
}

// hi = rna_tf32(x), lo = rna_tf32(x - hi): the 3xTF32 split of an operand
// that wgmma reads from shared memory, once per call (count % 4 == 0,
// 16-byte aligned): nt_matmul's predictions, conv_stats' weights
__global__ void split_tf32(const float4* __restrict__ x,
                           float4* __restrict__ hi, float4* __restrict__ lo,
                           int64_t count4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < count4; i += stride) {
    const float4 v = x[i];
    float4 h, l;
    h.x = __uint_as_float(to_tf32(v.x));
    h.y = __uint_as_float(to_tf32(v.y));
    h.z = __uint_as_float(to_tf32(v.z));
    h.w = __uint_as_float(to_tf32(v.w));
    l.x = __uint_as_float(to_tf32(v.x - h.x));
    l.y = __uint_as_float(to_tf32(v.y - h.y));
    l.z = __uint_as_float(to_tf32(v.z - h.z));
    l.w = __uint_as_float(to_tf32(v.w - h.w));
    hi[i] = h;
    lo[i] = l;
  }
}

inline cudaError_t launch_split_tf32(const void* x, void* hi, void* lo,
                                     int64_t count4, cudaStream_t stream) {
  if (count4 == 0) return cudaSuccess;
  split_tf32<<<static_cast<unsigned>(grid_stride_blocks(count4)), 256, 0,
               stream>>>(static_cast<const float4*>(x),
                         static_cast<float4*>(hi), static_cast<float4*>(lo),
                         count4);
  return cudaGetLastError();
}

}  // namespace
