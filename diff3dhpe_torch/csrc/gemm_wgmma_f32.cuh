// The f32-output GEMM of the contraction modes "high3" and "default" on
// Hopper's warpgroup matrix multiply (sm_90a): the four f32 products of an
// f32 block (fused_block.cu) under a mode, on bf16 operands split from f32
// ones (split_bf16_kernel).
//
//   out[M, N] = epilogue(Σ_p A_p[M, K] · W_p[N, K]ᵀ + bias)   in f32
//
// kPasses = 1 ("default"): A · Wᵀ on the rounded operands. kPasses = 3
// ("high3", _dot_f32_3pass, diff3dhpe_tpu/ops/fused_block.py:127-144):
// A_hi·W_hiᵀ in one set of accumulators and A_hi·W_loᵀ + A_lo·W_hiᵀ in a
// second, added once in the epilogue: hh + (hl + lh). Stands for the
// _dot_f32 products of the TPU kernel
// diff3dhpe_tpu/ops/fused_block.py::_fused_full_block_kernel at f32 under
// those modes. Epilogues as gemm_wgmma.cuh's (bias, GELU, residual with a
// per-row scale).
//
// What bounds it on an H100: at M = 16,524 and the block's four products
// the work is 26–52 GFLOP of bf16 products a pass against 34–68 MB of f32
// rows out (and in, for the residual): by the data sheet one pass is bound
// by the tensor cores (0.117 ms for the four at 989 TFLOP/s), three by them
// too. At K = 512 a 128 x 128 tile has 8 k-steps of 64, so the 64 KB of
// f32 a tile writes is of the order of the 32 KB a step loads: the
// epilogue is as long as a good part of the main loop, and whatever does
// not overlap it is lost. The earlier kernel (one tile a block, its
// accumulators staged through the ring after the main loop) hid it only
// behind a second block on the SM, and a second accumulator for the cross
// terms, which the three passes need so that the tensor cores'
// accumulation does not drop their low bits against hi·hi's magnitude at
// every k-step, would have left one block an SM and no overlap at all.
// Measured (H100 80GB HBM3, 700 W, utils/mode_attn_profile.py --parts gemm): the four
// products 0.221 ms at one pass (torch.mm with a float32 output 0.168) and
// 0.365 at three. What holds the one pass: a tile reads 32 KB a k-step from
// L2, and the qkv product, 1,560 tiles, moves 0.4 GB so in 0.071 ms (5.6
// TB/s); and the tensor cores idle while both warpgroups run the epilogue
// (fc1's GELU takes a tile from 5.9 to 7.6 µs). Two sets of accumulators,
// to run a tile's epilogue behind the next tile's first k-steps, did not
// fit: ptxas keeps a 384-thread kernel within 168 registers a thread
// whatever setmaxnreg grants at run time, so with the residual's rows they
// spilled 5 KB, and the four products took 0.42 ms. hi·hi's accumulator still
// drops bits at every k-step, so the three passes' distance from exact
// sums grows with K: r 0.10 at K = 512, 0.21 at 1024 (phase 21), 0.4514 at
// K = 2048 (tests/test_torch_cuda_kernels.py's separation case, before it
// was cut to K <= 1024), above the "high3" separation bar of 0.45. Depth
// limit: the blocks contract at K <= 1024 (embed 512, hidden 1024 in every
// config); a config with embed or hidden above 1024 needs hi·hi summed in
// more than one accumulator first (ROADMAP B.10).
//
// Design: persistent, one block an SM walking the 128 x 128 output tiles
// (row-major over the tile grid, so the blocks in flight share W and a few
// rows of A in L2), warp-specialised. A producer warpgroup (setmaxnreg to
// 40 registers; one thread issues) keeps TMA loads of 128 x 64 tiles of A
// and W (both, hi and lo, with three passes) in flight through a ring of
// 192 KB of 128-byte-swizzled stages: 6 stages of [A | W] at one pass, 3 of
// [A_hi | W_hi | A_lo | W_lo] at three, so each k-step's four tiles load
// once for the three products. Two consumer warpgroups each own 64 rows
// of the tile: per stage four wgmma m64n128k16 (twelve at three
// passes), one stage's group in flight while the previous stage is
// released. The epilogue runs in registers on the accumulators' fragments
// and stores f32 pairs straight to global memory (a warp's store covers 8
// rows x 32 contiguous bytes: whole sectors), with no staging tile and no
// barrier, while the producer already fills the ring with the next tile's
// stages: the epilogue overlaps the next tile's loads. The residual
// epilogue's rows load before the tile's main loop, which hides their
// latency.
#pragma once

#include "gemm_wgmma.cuh"

namespace wgf {

using bf16 = __nv_bfloat16;
using wg::fence_regs;
using wg::kEpiGelu;
using wg::kEpiResidual;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 384;  // the producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128·40 + 256·232 <= 65,536
constexpr int kTileBytes = kBM * kBK * 2;  // a 128 x 64 bf16 tile (A's and W's alike)
constexpr int kRingBytes = 6 * 2 * kTileBytes;  // 192 KB

template <int kPasses>
struct Ring {
  static_assert(kPasses == 1 || kPasses == 3, "one pass, or the three of bf16x3");
  static constexpr int kTiles = kPasses == 3 ? 4 : 2;  // [A_hi | W_hi | A_lo | W_lo] or [A | W]
  static constexpr int kStageBytes = kTiles * kTileBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr size_t kSmemBytes = (size_t)kRingBytes + 1024 /* alignment */ + 16 * kStages;
};

// map_a, map_w: A and W (A_hi and W_hi with three passes); map_a_lo,
// map_w_lo: A_lo and W_lo, read with three passes only.
template <int EPI, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
gemm_f32out_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_a_lo,
                         const __grid_constant__ CUtensorMap map_w_lo,
                         const float* __restrict__ bias, const float* __restrict__ res,
                         const float* __restrict__ rscale, float* __restrict__ out, int M, int N,
                         int K) {
  using R = Ring<kPasses>;
  extern __shared__ unsigned char wgf_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wgf_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = wg::smem_u32(smem);
  const uint32_t full0 = ring + kRingBytes, empty0 = full0 + 8 * R::kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + kBN - 1) / kBN, tiles = (M + kBM - 1) / kBM * tiles_n;
  const int nk = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      wg::mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival
      wg::mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread keeps the ring full, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != 0) return;
    int c = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
      for (int kt = 0; kt < nk; ++kt, ++c) {
        const int s = c % R::kStages;
        const uint32_t full = full0 + 8 * s, dst = ring + s * R::kStageBytes;
        wg::mbar_wait(empty0 + 8 * s, ((c / R::kStages) & 1) ^ 1);
        wg::mbar_expect_tx(full, R::kStageBytes);
        wg::tma_load(dst, &map_a, full, kt * kBK, m0);
        wg::tma_load(dst + kTileBytes, &map_w, full, kt * kBK, n0);
        if (kPasses == 3) {
          wg::tma_load(dst + 2 * kTileBytes, &map_a_lo, full, kt * kBK, m0);
          wg::tma_load(dst + 3 * kTileBytes, &map_w_lo, full, kt * kBK, n0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ---- consumers: warpgroup wgi owns rows wgi·64 ... + 63 of each tile ----
  const int wgi = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  constexpr int kX = kPasses == 3 ? wg::kAcc : 1;  // the cross terms' accumulators
  int c = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    // The thread's rows of the tile: row0 and row0 + 8. The residual
    // epilogue's res values (in the accumulators' fragment layout) and row
    // scales load before the main loop, so their latency hides behind it.
    const int row0 = m0 + wgi * 64 + (warp & 3) * 16 + g;
    constexpr int kR = EPI == kEpiResidual ? wg::kAcc : 1;
    float rr[kR], sc[2] = {1.0f, 1.0f};
    if constexpr (EPI == kEpiResidual) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (rscale && row < M) sc[half] = rscale[2 * (size_t)row];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          float2 r = make_float2(0.f, 0.f);
          if (row < M && col < N) r = *reinterpret_cast<const float2*>(res + (size_t)row * N + col);
          rr[4 * j + 2 * half] = r.x, rr[4 * j + 2 * half + 1] = r.y;
        }
      }
    }
    float acc[wg::kAcc], acx[kX];
#pragma unroll
    for (int i = 0; i < wg::kAcc; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kX; ++i) acx[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++c) {
      const int s = c % R::kStages;
      wg::mbar_wait(full0 + 8 * s, (c / R::kStages) & 1);
      const uint32_t st = ring + s * R::kStageBytes;
      const uint64_t da = wg::make_desc(st + wgi * (64 * kBK * 2));
      const uint64_t dw = wg::make_desc(st + kTileBytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wg::wgmma_m64n128k16(acc, da + 2 * kk, dw + 2 * kk);  // 32 bytes of K a step
      }
      if constexpr (kPasses == 3) {
        const uint64_t da_lo = wg::make_desc(st + 2 * kTileBytes + wgi * (64 * kBK * 2));
        const uint64_t dw_lo = wg::make_desc(st + 3 * kTileBytes);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wg::wgmma_m64n128k16(acx, da + 2 * kk, dw_lo + 2 * kk);
          wg::wgmma_m64n128k16(acx, da_lo + 2 * kk, dw + 2 * kk);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // All but the newest group are done: the previous stage is free.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && lane == 0) wg::mbar_arrive(empty0 + 8 * ((c - 1) % R::kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    fence_regs(acx);
    if (lane == 0) wg::mbar_arrive(empty0 + 8 * ((c - 1) % R::kStages));

    // Epilogue on the fragments: acc[4·j + e] is row g (e < 2) or g + 8 of
    // the warp's 16, column 8·j + 2·t + (e & 1). N % 8 == 0, so a pair is
    // inside N or outside it whole. Four column groups at a time, their
    // bias pairs loaded together.
#pragma unroll
    for (int j0 = 0; j0 < kBN / 8; j0 += 4) {
      float2 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 8 * (j0 + j) + 2 * t;
        bv[j] = bias && col < N ? *reinterpret_cast<const float2*>(bias + col)
                                : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + 8 * (j0 + j) + 2 * t, e = 4 * (j0 + j) + 2 * half;
          if (row >= M || col >= N) continue;
          float v0 = acc[e], v1 = acc[e + 1];
          if constexpr (kPasses == 3) v0 += acx[e], v1 += acx[e + 1];
          if (bias) v0 += bv[j].x, v1 += bv[j].y;
          if constexpr (EPI == kEpiGelu) {
            v0 = wg::gelu_erf(v0), v1 = wg::gelu_erf(v1);
          } else if constexpr (EPI == kEpiResidual) {
            v0 = rr[e] + v0 * sc[half], v1 = rr[e + 1] + v1 * sc[half];
          }
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) = make_float2(v0, v1);
        }
      }
    }
  }
}

// K % 8 == 0 (16-byte rows for TMA), N % 8 == 0 and 16-byte aligned bases
// (checked by the caller); any M. kPasses = 3 reads A_lo and W_lo, kPasses
// = 1 neither. One block an SM, at most one a tile.
template <int EPI, int kPasses>
cudaError_t launch_gemm_f32out(const bf16* A, const bf16* A_lo, const bf16* W, const bf16* W_lo,
                               const float* bias, const float* res, const float* rscale,
                               float* out, int M, int N, int K, cudaStream_t stream) {
  using R = Ring<kPasses>;
  const auto kernel = gemm_f32out_wgmma_kernel<EPI, kPasses>;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)R::kSmemBytes)) != cudaSuccess) {
    return err;
  }
  CUtensorMap map_a, map_w, map_a_lo, map_w_lo;
  if (!wg::make_map(&map_a, A, M, K, kBM) || !wg::make_map(&map_w, W, N, K, kBN)) {
    return cudaErrorInvalidValue;
  }
  if (kPasses == 1) {
    map_a_lo = map_a, map_w_lo = map_w;
  } else if (!A_lo || !W_lo || !wg::make_map(&map_a_lo, A_lo, M, K, kBM) ||
             !wg::make_map(&map_w_lo, W_lo, N, K, kBN)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  kernel<<<tiles < sms ? tiles : sms, kThreads, R::kSmemBytes, stream>>>(
      map_a, map_w, map_a_lo, map_w_lo, bias, res, rscale, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace wgf
