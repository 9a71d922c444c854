// Exact-f32 GEMM with a fused epilogue on Hopper's CUDA cores (sm_90a): the
// four products of an f32 block in fused_block.cu.
//
//   out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ + bias)
//
// A, W, res and out f32; every product a plain fmaf, summed over k in
// order (no TF32, no split products: JAX's "highest" contraction). Stands
// for the _dot_f32 products of the TPU kernel
// diff3dhpe_tpu/ops/fused_block.py::_fused_full_block_kernel at f32. The
// epilogues: the bias only, exact GELU (erff), or res + s[row] · (…) with the
// row's drop-path scale s[row] = rscale[2 · row] (1 where rscale is null).
//
// What bounds it on an H100: at M = 16,524 rows the block's four products
// are 69.3 GFLOP against ~0.3 GB, so f32 arithmetic bounds them: 67 TFLOP/s
// of FMAs outside the tensor cores, 1.03 ms. On the way there the narrow
// pipe is shared memory: it hands 128 bytes a clock to the registers while
// the SM issues 128 FMAs, so a thread must do about four FMAs for every
// float it reads from shared memory, unless a warp's lanes read the same
// addresses and the read is served once.
//
// Design:
// - A and W are both K-contiguous ("NT"). k-tiles of BK = 32 columns of the
//   block's 128 rows of A and 128 rows of W go by 16-byte cp.async straight
//   into a 3-deep shared ring: no register staging, no transposing stores,
//   one __syncthreads a k-tile. Rows are padded to BK + 4 floats, so 8
//   consecutive rows fall in 8 distinct groups of 4 banks. Rows past M or N
//   and columns past K are zero-filled (0 · 0 adds nothing).
// - 256 threads, 8 warps; a warp's lanes form a 4 x 8 grid, and thread
//   (r, c) owns rows r + 4i and columns c + 8j (i, j < 8) of its warp's
//   32 x 64 tile. A fragment read is 4 consecutive k of one row: the warp
//   reads 4 distinct rows of A (8 lanes each) and 8 of W (4 lanes each),
//   conflict-free, as 128-bit loads. 206 registers, one block an SM.
// - Each accumulator sums its k in order, as the kernel this one replaced
//   did (a register-staged 128 x 128 x 8 tile, k-major in shared memory,
//   two blocks an SM), so the bits are the same.
// - The epilogue runs from registers: row r + 4i, columns c + 8j, so a
//   warp's store covers 4 rows x 32 contiguous bytes.
// Measured on an H100 at 700 W (chip_smoke.py phase 2e), this design runs
// about a tenth slower than the kernel it replaced; cp.async rings with
// k-major tiles and other tile shapes measured no faster. See PERF.md.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gemm_wgmma.cuh"  // the epilogue codes and gelu_erf shared with the bf16 GEMM
#include "grand_attn.cuh"  // cp.async helpers

namespace gf {

using wg::gelu_erf;
using wg::kEpiBias;
using wg::kEpiGelu;
using wg::kEpiResidual;

// The tile shape: a block of 256 threads computes BM x BN outputs, each
// thread TM x TN; k-tiles of BK columns stream through a STAGES-deep ring;
// fragments are read KV = 4 columns at a time (one 128-bit load).
struct Tile {
  static constexpr int BM = 128, BN = 128, BK = 32, TM = 8, TN = 8, KV = 4, STAGES = 3;
  static constexpr int kThreads = 256;
  static constexpr int WM = 4 * TM, WN = 8 * TN;  // a warp's tile
  static constexpr int kWarpsM = BM / WM;
  static_assert(kWarpsM * (BN / WN) == kThreads / 32, "the warps must tile the block");
  static_assert((BM * BK / 4) % kThreads == 0 && (BN * BK / 4) % kThreads == 0,
                "every thread copies the same number of pieces");
  static constexpr int LD = BK + 4;  // floats a shared row
  static constexpr size_t kSmemBytes = (size_t)STAGES * (BM + BN) * LD * sizeof(float);
};

__device__ __forceinline__ void load_kv(float (&dst)[Tile::KV], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
}

// Rows [r0, r0 + ROWS) x columns [k0, k0 + BK) of a K-contiguous operand
// into one ring stage; rows at or past `rows` and columns at or past K are
// zero-filled. Every thread of the block copies the same share.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int rows, int k0,
                                          int K) {
  using T = Tile;
  constexpr int kPieces = T::BK / 4;
#pragma unroll
  for (int it = 0; it < ROWS * kPieces / T::kThreads; ++it) {
    const int e = it * T::kThreads + threadIdx.x, r = e / kPieces, c = (e % kPieces) * 4;
    const bool ok = r0 + r < rows && k0 + c < K;
    grand::cp_async16(dst + r * T::LD + c, ok ? src + (size_t)(r0 + r) * K + k0 + c : src, ok);
  }
}

template <int EPI>
__global__ void __launch_bounds__(Tile::kThreads, 1)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ res,
                const float* __restrict__ rscale, float* __restrict__ out, int M, int N, int K) {
  using T = Tile;
  extern __shared__ __align__(16) float gemm_f32_smem[];
  float* As = gemm_f32_smem;                             // [STAGES][BM][LD]
  float* Ws = gemm_f32_smem + T::STAGES * T::BM * T::LD;  // [STAGES][BN][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int wm = warp % T::kWarpsM, wn = warp / T::kWarpsM;
  const int lr = lane >> 3, lc = lane & 7;

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  const int nk = (K + T::BK - 1) / T::BK;
  auto load_tile = [&](int kt) {
    const int stage = kt % T::STAGES;
    load_rows<T::BM>(As + stage * T::BM * T::LD, A, m0, M, kt * T::BK, K);
    load_rows<T::BN>(Ws + stage * T::BN * T::LD, W, n0, N, kt * T::BK, K);
  };
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load_tile(s);
    grand::cp_async_commit();
  }

  const float* a_rows = As + (wm * T::WM + lr) * T::LD;  // row lr + 4i of the warp's tile
  const float* w_rows = Ws + (wn * T::WN + lc) * T::LD;  // row lc + 8j
  for (int kt = 0; kt < nk; ++kt) {
    // Tile kt has landed, and every warp is done with the stage the next
    // copy overwrites (the one tile kt - 1 used).
    grand::cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    if (kt + T::STAGES - 1 < nk) load_tile(kt + T::STAGES - 1);
    grand::cp_async_commit();
    const int stage = kt % T::STAGES;
    const float* as = a_rows + stage * T::BM * T::LD;
    const float* ws = w_rows + stage * T::BN * T::LD;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += T::KV) {
      float a[T::TM][T::KV], b[T::TN][T::KV];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) load_kv(a[i], as + 4 * i * T::LD + kk);
#pragma unroll
      for (int j = 0; j < T::TN; ++j) load_kv(b[j], ws + 8 * j * T::LD + kk);
#pragma unroll
      for (int q = 0; q < T::KV; ++q)
#pragma unroll
        for (int i = 0; i < T::TM; ++i)
#pragma unroll
          for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
    }
  }

  const int row0 = m0 + wm * T::WM + lr, col0 = n0 + wn * T::WN + lc;
  float bv[T::TN];
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int col = col0 + 8 * j;
    bv[j] = bias != nullptr && col < N ? bias[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = row0 + 4 * i;
    if (row >= M) continue;
    const float s = EPI == kEpiResidual && rscale != nullptr ? rscale[2 * (size_t)row] : 1.f;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;
      float v = acc[i][j] + bv[j];
      if (EPI == kEpiGelu) {
        v = gelu_erf(v);
      } else if (EPI == kEpiResidual) {
        v = res[(size_t)row * N + col] + (rscale != nullptr ? v * s : v);
      }
      out[(size_t)row * N + col] = v;
    }
  }
}

// out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ + bias); K % 4 == 0 and 16-byte
// aligned A and W (checked by the caller). bias may be null; res only read
// by the residual epilogue.
template <int EPI>
inline cudaError_t launch_gemm_f32(const float* A, const float* W, const float* bias,
                                   const float* res, const float* rscale, float* out, int M, int N,
                                   int K, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_f32_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM);
  gemm_f32_kernel<EPI><<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(A, W, bias, res,
                                                                          rscale, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace gf
