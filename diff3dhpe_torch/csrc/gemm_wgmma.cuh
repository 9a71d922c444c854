// GEMM with bf16 operands and a fused epilogue on Hopper's warpgroup matrix
// multiply (sm_90a): the four products of a bf16 block in fused_block.cu.
// (The f32-output GEMM of an f32 block under the contraction modes is
// gemm_wgmma_f32.cuh, which shares the helpers here.)
//
//   out[M, N] = bf16(epilogue(A[M, K] · W[N, K]ᵀ + bias))
//
// A, W, res and out bf16, bias and rscale f32, the products and the
// epilogue in f32, out rounded once. Stands for the _dot_f32 products of
// the TPU kernel diff3dhpe_tpu/ops/fused_block.py::_fused_full_block_kernel
// at bf16.
//
// What bounds it on an H100: at M = 16,524 and (N, K) = (1536, 512) the
// product is 26 GFLOP against 69 MB, bound by the tensor cores' 989 TFLOP/s
// (0.026 ms), a rate only wgmma reaches. Below that bound sits the path
// through shared memory: a 128 x 128 tile does 32 FMAs for each byte it
// loads, so at the tensor cores' 2,048 FMAs a clock TMA would write 64 bytes
// a clock and SM while the two warpgroups' wgmma read 96, of the 128 that
// shared memory moves; the kernel runs at 260-385 TFLOP/s.
//
// Design: one block computes a 128 x 128 tile of the output with nine warps.
// The producer (one thread of the ninth warp) copies 128 x 64 tiles of A and
// of W with TMA into a 3-stage ring of 128-byte-swizzled shared tiles, the
// layout wgmma's matrix descriptors read; A and W are both K-major, wgmma's
// native form. TMA zero-fills what lies past M, N
// or K, so ragged edges need no branch in the main loop. Two consumer
// warpgroups each own 64 rows: per stage four wgmma m64n128k16 on 64 f32
// accumulators a thread, one group in flight while the previous stage is
// released. full/empty mbarriers carry the ring. The epilogue stages the f32
// accumulators through the ring's shared memory (free once the main loop is
// done) so that bias, GELU, the residual and the store all run on 8 values
// of a row, coalesced.
// At 90 registers a thread and 97 KB of shared memory two blocks share an
// SM, so one block's epilogue and pipeline fill overlap the other's main
// loop; nothing needs setmaxnreg. A 128 x 256 tile with one block an SM (4
// stages, setmaxnreg 40/232) measured 6% slower over the block's four
// products, and a 2-block cluster that shares W by TMA multicast 13%
// slower (H100 at 700 W): the tile's traffic through shared memory (each
// warpgroup reads W itself while TMA writes the next stage), not L2, is
// what a next design has to cut.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kBlocksPerSM = 2;
constexpr int kThreads = 288, kConsumerThreads = 256;  // 2 consumer warpgroups + the producer warp
constexpr int kAcc = kBN / 2;  // f32 accumulators a consumer thread
constexpr int kABytes = kBM * kBK * 2, kWBytes = kBN * kBK * 2, kStageBytes = kABytes + kWBytes;
constexpr int kStageLd = kBN + 8;  // floats per row of the epilogue's staging tile
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + 1024 /* alignment */ + 128;
static_assert((size_t)kBM * kStageLd * 4 <= (size_t)kStages * kStageBytes, "staging fits the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the barrier's phase of parity `parity` has completed. A wait
// that outlasts any real one (a lost TMA transaction) traps, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1LL << 26)) __trap();
  }
}
// One box of a 2-D tensor map into shared memory; completion on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Marks every register of d as written here, so that no use of a wgmma
// accumulator moves above the wait that completes it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major bf16 tile with 128-byte rows in the 128-byte
// swizzle: start address, stride between 8-row groups 1024 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x 128] += a[64 x 16] · b[128 x 16]ᵀ, both from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));  // p: accumulate into d
}

// The epilogues of both GEMMs of fused_block.cu (this one and the f32 one).
enum Epilogue { kEpiBias = 0, kEpiGelu = 1, kEpiResidual = 2 };

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// The residual epilogue's 8 values of a row of res, as float.
__device__ __forceinline__ void load8(const bf16* p, float (&r)[8]) {
  const uint4 rv = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(rp[i]);
    r[2 * i] = f.x, r[2 * i + 1] = f.y;
  }
}
// 8 values of a row of out, rounded to bf16 (nearest even).
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 o;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) op[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = o;
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gemm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                       const bf16* __restrict__ res, const float* __restrict__ rscale,
                       bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const uint32_t ring = smem_u32(smem), full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, group = warp >> 2;  // group 2: the producer warp
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 2) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == kConsumerThreads) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, kStageBytes);
        tma_load(ring + s * kStageBytes, &map_a, full0 + 8 * s, kt * kBK, m0);
        tma_load(ring + s * kStageBytes + kABytes, &map_w, full0 + 8 * s, kt * kBK, n0);
      }
    }
  } else {
    // ---- consumers: rows group·64 ... + 63 of the tile ----
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint64_t da = make_desc(ring + s * kStageBytes + group * (64 * kBK * 2));
      const uint64_t dw = make_desc(ring + s * kStageBytes + kABytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_m64n128k16(acc, da + 2 * kk, dw + 2 * kk);  // 32 bytes of K a step
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // All but the newest group are done: the previous stage is free.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // Epilogue. Every load has landed and every wgmma has read its tiles
    // once both consumer groups pass the barrier, so the ring is free: the
    // accumulators go through it as a [128][136] f32 tile. Fragment 4·j + e
    // of a warp: row g (e < 2) or g + 8, column 8·j + 2·t + (e & 1).
    float* stage = reinterpret_cast<float*>(smem);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int g = lane >> 2, t = lane & 3, r0 = group * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      *reinterpret_cast<float2*>(stage + r0 * kStageLd + 8 * j + 2 * t) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(stage + (r0 + 8) * kStageLd + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // 8 columns a thread and step: 32 threads cover a row of the tile.
    for (int e = tid; e < kBM * (kBN / 8); e += kConsumerThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row >= M || col >= N) continue;
      const float4 lo = *reinterpret_cast<const float4*>(stage + r * kStageLd + c);
      const float4 hi = *reinterpret_cast<const float4*>(stage + r * kStageLd + c + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      if (bias) {
        const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
        const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
        v[0] += b0.x, v[1] += b0.y, v[2] += b0.z, v[3] += b0.w;
        v[4] += b1.x, v[5] += b1.y, v[6] += b1.z, v[7] += b1.w;
      }
      if (EPI == kEpiGelu) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = gelu_erf(v[i]);
      } else if (EPI == kEpiResidual) {
        float rr[8];
        load8(res + (size_t)row * N + col, rr);
        const float s = rscale ? rscale[2 * (size_t)row] : 1.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = rr[i] + v[i] * s;
      }
      store8(out + (size_t)row * N + col, v);
    }
  }
}

// cuTensorMapEncodeTiled, looked up in the libcuda that the CUDA runtime has
// already loaded into the process, so that the library links against nothing.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major bf16 [rows, K] matrix read in boxes of
// box_rows x 64 in the 128-byte swizzle; what lies outside reads as zero.
inline bool make_map(CUtensorMap* map, const bf16* base, int rows, int K, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows}, elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 GEMM of a bf16 block. K % 8 == 0 (16-byte rows for TMA), N % 8
// == 0 and 16-byte aligned bases (checked by the caller); any M.
template <int EPI>
cudaError_t launch_gemm_wgmma(const bf16* A, const bf16* W, const float* bias, const bf16* res,
                              const float* rscale, bf16* out, int M, int N, int K,
                              cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  if (!make_map(&map_a, A, M, K, kBM) || !make_map(&map_w, W, N, K, kBN)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(gemm_bf16_wgmma_kernel<EPI>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bf16_wgmma_kernel<EPI><<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_w, bias, res,
                                                                      rscale, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace wg
