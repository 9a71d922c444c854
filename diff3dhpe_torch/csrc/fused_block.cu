// Hopper (sm_90a) port of one MixSTE transformer block on flat rows, f32
// or bf16, in two row layouts.
//
// Replaces:
//   B1 diff3dhpe_tpu/ops/fused_block.py::_fused_full_block_kernel (wrapper
//      fused_transformer_block): attention groups are runs of n_pad rows;
//   B2 diff3dhpe_tpu/ops/fused_block.py::_fused_temporal_group_kernel
//      (wrapper fused_temporal_block_cols): the temporal group (b, j) of
//      the spatial-major rows (b·F + f)·J + j, with no transpose;
//   B5 diff3dhpe_tpu/ops/fused_block.py::_fused_attn_block_kernel (wrapper
//      fused_attention_block): the attention half alone,
//      out = x + proj(GRAND(LN1(x))), groups of n consecutive rows;
// with their device functions ops/attention.py::grand_attend_tile,
// fused_block.py::_layernorm_rows and fused_block.py::_gelu_exact.
//
// What it computes, on x [R, C]:
//   xs  = x [+ t_rows[row / rows_per_item]]
//   h1  = xs + s0 · proj(GRAND(LN1(xs)))      GRAND = softmax(q kᵀ·d^-½) v − v
//   out = h1 + s1 · fc2(GELU(fc1(LN2(h1))))   GELU exact (erff)
//   out = LN_out(out)                          when an out-LN is given
// Attention stays inside each group and reads only its n real keys. s0, s1
// are the row's drop-path scales dp[row, 0], dp[row, 1] (1 without dp),
// applied to each branch, bias included, before its residual add.
//
// bf16 (JAX cdt = bf16, fused_block.py:338-374): every tensor between the
// kernels is bf16; LN parameters and biases stay f32; each kernel computes
// in f32 and rounds its output to bf16 once: xs = bf16(x + t), xn, qkv (bias
// added before the rounding), the attention output, h1, hn, mid, and the
// block output (before and after the out-LN).
//
// What bounds it on an H100: at C=512, hidden=1024 and R=16,524 rows the
// four GEMMs carry ~69 GFLOP against ~0.3 GB (f32) of compulsory traffic,
// so the block is bound by arithmetic: 67 TFLOP/s of f32 outside the tensor
// cores (the f32 products are plain FMAs, no TF32, matching the JAX
// "highest" contraction), or 989 TFLOP/s of bf16 on the tensor cores.
// Attention adds 0.6 GFLOP at n=17 and 8.2 GFLOP at n=243 on CUDA cores.
//
// Design: a small set of kernels, each right first and simple.
//   ln_rows_kernel<T>     one warp per row: [time add] + LayerNorm.
//   gemm_nt_kernel<EPI>   f32: 128x128x8 shared-memory tiles, 8x8 outputs
//                         per thread, register-staged double buffering.
//   gemm_bf16_kernel<EPI> bf16: 128x128x32 tiles through a 3-stage cp.async
//                         ring, 8 warps of 64x32, ldmatrix + mma.sync
//                         m16n8k16 with f32 accumulators.
//                         Both GEMM epilogues add the bias and then either
//                         nothing, exact GELU, or the residual (after the
//                         row's drop-path scale).
//   grand_attn_kernel     grand_attn.cuh, shared with grand_attention.cu:
//                         one block per (group, head) with the group's K
//                         and V in shared memory, reading q, k and v out of
//                         the qkv buffer through strides; B2 adds the outer
//                         group index b as blockIdx.z.
// The intermediates (LN output, qkv, attention output, h1, MLP hidden)
// make one round trip through device memory each; a single fused kernel
// with wgmma/TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "grand_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;
using grand::bf16_round;
using grand::to_float;
using grand::warp_sum;

constexpr int BM = 128, BN = 128, BK = 8, kGemmThreads = 256;

enum Epilogue { kEpiBias = 0, kEpiGelu = 1, kEpiResidual = 2 };

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, bf16) { return bf16_round(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// y[r] = LN(xs[r]) * w + b with xs[r] = x[r] + t[r / rows_per_item]
// rounded to T; with xs != nullptr xs is also written (the residual
// stream the block adds to). Statistics and the affine map in float.
template <typename T>
__global__ void ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ t,
                               int rows_per_item, const float* __restrict__ w,
                               const float* __restrict__ b, float eps,
                               T* __restrict__ xs, T* __restrict__ y, int R, int C) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const T* xr = x + (size_t)row * C;
  const T* tr = t ? t + (size_t)(row / rows_per_item) * C : nullptr;
  auto in = [&](int c) {
    return tr ? round_to(to_float(xr[c]) + to_float(tr[c]), T()) : to_float(xr[c]);
  };
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += in(c);
  const float mu = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = in(c) - mu;
    sq += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / C + eps);
  T* yr = y + (size_t)row * C;
  T* xsr = xs ? xs + (size_t)row * C : nullptr;
  for (int c = lane; c < C; c += 32) {
    const float v = in(c);
    if (xsr) store(xsr + c, v);
    store(yr + c, (v - mu) * rstd * w[c] + b[c]);
  }
}

// out[M, N] = A[M, K] · W[N, K]ᵀ + bias, then the epilogue; the residual
// epilogue computes res + s[row] · (A·Wᵀ + bias) with s[row] =
// rscale[2 * row] (1 where rscale is null). K % 8 == 0, N % 4 == 0 and
// 16-byte aligned rows (checked by the caller).
template <int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_kernel(const float* __restrict__ A, const float* __restrict__ W,
               const float* __restrict__ bias, const float* __restrict__ res,
               const float* __restrict__ rscale, float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Ws[2][BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // Loader: each thread brings one float4 of A and one of W per k-tile.
  const int lrow = tid >> 1, lk = (tid & 1) * 4;
  const bool a_ok = m0 + lrow < M, w_ok = n0 + lrow < N;
  const float* a_ptr = A + (size_t)(a_ok ? m0 + lrow : 0) * K + lk;
  const float* w_ptr = W + (size_t)(w_ok ? n0 + lrow : 0) * K + lk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a_reg = a_ok ? *reinterpret_cast<const float4*>(a_ptr) : zero;
  float4 w_reg = w_ok ? *reinterpret_cast<const float4*>(w_ptr) : zero;

  // Compute: rows ty*4+{0..3} and 64+ty*4+{0..3}, columns likewise by tx.
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto stage = [&](int buf) {
    As[buf][lk + 0][lrow] = a_reg.x;
    As[buf][lk + 1][lrow] = a_reg.y;
    As[buf][lk + 2][lrow] = a_reg.z;
    As[buf][lk + 3][lrow] = a_reg.w;
    Ws[buf][lk + 0][lrow] = w_reg.x;
    Ws[buf][lk + 1][lrow] = w_reg.y;
    Ws[buf][lk + 2][lrow] = w_reg.z;
    Ws[buf][lk + 3][lrow] = w_reg.w;
  };
  stage(0);
  __syncthreads();

  const int nk = K / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      const int k0 = (kt + 1) * BK;
      a_reg = a_ok ? *reinterpret_cast<const float4*>(a_ptr + k0) : zero;
      w_reg = w_ok ? *reinterpret_cast<const float4*>(w_ptr + k0) : zero;
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[cur][k][tx * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) stage(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col >= N) continue;
      float v[4];
      const float4 bv = bias ? *reinterpret_cast<const float4*>(bias + col) : zero;
      v[0] = acc[i][half * 4 + 0] + bv.x;
      v[1] = acc[i][half * 4 + 1] + bv.y;
      v[2] = acc[i][half * 4 + 2] + bv.z;
      v[3] = acc[i][half * 4 + 3] + bv.w;
      if (EPI == kEpiGelu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = gelu_erf(v[j]);
      } else if (EPI == kEpiResidual) {
        const float4 r = *reinterpret_cast<const float4*>(res + (size_t)row * N + col);
        if (rscale) {
          const float s = rscale[2 * (size_t)row];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] *= s;
        }
        v[0] = r.x + v[0];
        v[1] = r.y + v[1];
        v[2] = r.z + v[2];
        v[3] = r.w + v[3];
      }
      *reinterpret_cast<float4*>(out + (size_t)row * N + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const float* A, const float* W, const float* bias, const float* res,
                        const float* rscale, float* out, int M, int N, int K,
                        cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_nt_kernel<EPI><<<grid, kGemmThreads, 0, stream>>>(A, W, bias, res, rscale, out, M, N, K);
  return cudaGetLastError();
}

// ---- bf16 GEMM on the tensor cores ----------------------------------------

constexpr int TBM = 128, TBN = 128, TBK = 32, kTcStages = 3, kTcThreads = 256;
constexpr int kTcLds = TBK + 8;  // bf16 per shared row: 80 bytes, so ldmatrix's 8 rows hit distinct banks
constexpr size_t kTcSmemBytes = (size_t)kTcStages * (TBM + TBN) * kTcLds * sizeof(bf16);

// 16 bytes global -> shared, asynchronously; zero-filled where !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d[16x8] += a[16x16] · b[16x8], bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4], const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out[M, N] = bf16(epilogue(A[M, K] · W[N, K]ᵀ + bias)), A, W and res bf16,
// bias and rscale f32, the product and the epilogue in f32: as
// gemm_nt_kernel, with the residual epilogue res + s[row] · (A·Wᵀ + bias).
// K % 32 == 0, N % 8 == 0 and 16-byte aligned rows (checked by the caller).
template <int EPI>
__global__ void __launch_bounds__(kTcThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const bf16* __restrict__ res,
                 const float* __restrict__ rscale, bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);  // [stage][TBM][kTcLds]
  bf16* Ws = As + kTcStages * TBM * kTcLds;       // [stage][TBN][kTcLds]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // this warp's 64x32 of the tile

  // One k-tile of A and W: 128 rows x 4 chunks of 8 bf16 each, 2 + 2 chunks a thread.
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * TBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kTcThreads, r = c >> 2, kc = (c & 3) * 8;
      const int am = m0 + r, wr = n0 + r;
      cp_async16(As + (stage * TBM + r) * kTcLds + kc, A + (size_t)(am < M ? am : 0) * K + k0 + kc,
                 am < M);
      cp_async16(Ws + (stage * TBN + r) * kTcLds + kc, W + (size_t)(wr < N ? wr : 0) * K + k0 + kc,
                 wr < N);
    }
  };

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = K / TBK;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < nk) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();  // k-tile kt has landed
    __syncthreads();                 // and every warp is done with the stage refilled next
    if (kt + kTcStages - 1 < nk) load_tile((kt + kTcStages - 1) % kTcStages, kt + kTcStages - 1);
    cp_async_commit();
    const bf16* as = As + (kt % kTcStages) * TBM * kTcLds;
    const bf16* ws = Ws + (kt % kTcStages) * TBN * kTcLds;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      unsigned af[4][4], bfrag[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices: rows 0-7 / 8-15 by bit 3 of the lane, k 0-7 / 8-15 by bit 4.
        const int row = wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[mi], as + row * kTcLds + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: k 0-7 / 8-15 by bit 3 of the lane, n 0-7 / 8-15 by bit 4.
        const int row = wn + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        unsigned r[4];
        ldmatrix_x4(r, ws + row * kTcLds + kk + ((lane >> 3) & 1) * 8);
        bfrag[2 * nj][0] = r[0];
        bfrag[2 * nj][1] = r[1];
        bfrag[2 * nj + 1][0] = r[2];
        bfrag[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfrag[ni]);
    }
  }

  // Fragment (mi, ni): rows g and g + 8 of the m16 tile, columns 2·t, 2·t + 1.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float s = (EPI == kEpiResidual && rscale) ? rscale[2 * (size_t)row] : 1.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        if (col >= N) continue;
        float v0 = acc[mi][ni][2 * half] + (bias ? bias[col] : 0.f);
        float v1 = acc[mi][ni][2 * half + 1] + (bias ? bias[col + 1] : 0.f);
        if (EPI == kEpiGelu) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        } else if (EPI == kEpiResidual) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * N + col));
          v0 = r.x + v0 * s;
          v1 = r.y + v1 * s;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias, const bf16* res,
                        const float* rscale, bf16* out, int M, int N, int K,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  gemm_bf16_kernel<EPI><<<grid, kTcThreads, kTcSmemBytes, stream>>>(A, W, bias, res, rscale, out,
                                                                     M, N, K);
  return cudaGetLastError();
}

// ---- the block ---------------------------------------------------------------

// Where the attention groups lie among the R rows.
//   rows (B1): group g is rows g·n_pad + i, i < n_pad (keys i < n).
//   cols (B2): group (b, j) is rows (b·n + f)·J + j, f < n, for J = j_groups.
template <typename T>
cudaError_t launch_attention(const T* qkv, T* out, int R, int C, int heads, int n, int n_pad,
                             int j_groups, float scale, cudaStream_t stream) {
  // q of row r, head h at qkv[r, h * 64], k and v C and 2C columns
  // further; the output at out[r, h * 64].
  const long long ld = 3LL * C;
  if (j_groups == 0) {
    const grand::Strides s_in{n_pad * ld, grand::kHeadDim, ld};
    const grand::Strides s_out{(long long)n_pad * C, grand::kHeadDim, C};
    return grand::launch_grand_attn(qkv, qkv + C, qkv + 2 * C, out, s_in, s_in, s_in, s_out,
                                    R / n_pad, heads, n, n_pad, scale, stream);
  }
  const long long J = j_groups;
  const grand::Strides s_in{ld, grand::kHeadDim, J * ld, n * J * ld};
  const grand::Strides s_out{C, grand::kHeadDim, J * C, n * J * C};
  return grand::launch_grand_attn<T, true>(qkv, qkv + C, qkv + 2 * C, out, s_in, s_in, s_in, s_out,
                                           j_groups, heads, n, n, scale, stream,
                                           R / (n * j_groups));
}

template <typename T>
cudaError_t launch_ln(const T* x, const T* t, int rows_per_item, const float* w, const float* b,
                      float eps, T* xs, T* y, int R, int C, cudaStream_t stream) {
  constexpr int kRowsPerBlock = 8;
  ln_rows_kernel<T><<<(R + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, stream>>>(
      x, t, rows_per_item, w, b, eps, xs, y, R, C);
  return cudaGetLastError();
}

#define DIFF_CHECK(call)                   \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
    ++*launches;                           \
  } while (0)

// The whole block in storage type T (float, or bf16 with f32 LN parameters
// and biases), launched on `stream` as 7 kernels (8 with the out-LN).
// Returns the first cudaError_t that a launch reported (0 on success) and
// adds one to *launches for every kernel it launched. Null bias pointers
// mean "no bias"; t_rows == nullptr skips the time add (xs is then unused);
// oln_w == nullptr skips the out-LN; dp == nullptr skips the drop-path
// scales, else dp is [R, 2] (attention, MLP branch) per row. j_groups == 0
// selects the rows layout (groups of n_pad rows), j_groups = J the cols
// layout (n frames of J joints per sample). Scratch: xn [R, C], qkv [R, 3C],
// attn [R, C], h1 [R, C], mid [R, hidden].
template <typename T>
int run_block(const T* x, const T* t_rows, int rows_per_item, const float* dp,
              const float* ln1_w, const float* ln1_b, float ln1_eps, const T* w_qkv,
              const float* b_qkv, const T* w_proj, const float* b_proj, const float* ln2_w,
              const float* ln2_b, float ln2_eps, const T* w_fc1, const float* b_fc1,
              const T* w_fc2, const float* b_fc2, const float* oln_w, const float* oln_b,
              float oln_eps, T* xs, T* xn, T* qkv, T* attn, T* h1, T* mid, T* out, int R, int C,
              int hidden, int n, int n_pad, int j_groups, int heads, float scale, int* launches,
              cudaStream_t stream) {
  const T* resid = t_rows ? xs : x;
  DIFF_CHECK(launch_ln(x, t_rows, rows_per_item, ln1_w, ln1_b, ln1_eps, t_rows ? xs : nullptr,
                       xn, R, C, stream));
  DIFF_CHECK(launch_gemm<kEpiBias>(xn, w_qkv, b_qkv, nullptr, nullptr, qkv, R, 3 * C, C, stream));
  DIFF_CHECK(launch_attention(qkv, attn, R, C, heads, n, n_pad, j_groups, scale, stream));
  DIFF_CHECK(launch_gemm<kEpiResidual>(attn, w_proj, b_proj, resid, dp, h1, R, C, C, stream));
  DIFF_CHECK(launch_ln<T>(h1, nullptr, 1, ln2_w, ln2_b, ln2_eps, nullptr, xn, R, C, stream));
  DIFF_CHECK(launch_gemm<kEpiGelu>(xn, w_fc1, b_fc1, nullptr, nullptr, mid, R, hidden, C, stream));
  T* fc2_out = oln_w ? attn : out;
  DIFF_CHECK(launch_gemm<kEpiResidual>(mid, w_fc2, b_fc2, h1, dp ? dp + 1 : nullptr, fc2_out, R,
                                       C, hidden, stream));
  if (oln_w) {
    DIFF_CHECK(launch_ln<T>(fc2_out, nullptr, 1, oln_w, oln_b, oln_eps, nullptr, out, R, C,
                            stream));
  }
  return 0;
}

// B5: the attention half of the block in storage type T, as the first 4
// kernels of run_block without the time add and the drop-path scales:
// out = x + proj(GRAND(LN1(x))) on groups of n consecutive rows. bf16
// rounds xn, qkv (bias added first), the attention output and out, where
// the TPU kernel rounds (fused_block.py:206-228). Scratch: xn [R, C],
// qkv [R, 3C], attn [R, C].
template <typename T>
int run_attn_block(const T* x, const float* ln_w, const float* ln_b, float ln_eps, const T* w_qkv,
                   const float* b_qkv, const T* w_proj, const float* b_proj, T* xn, T* qkv,
                   T* attn, T* out, int R, int C, int n, int heads, float scale, int* launches,
                   cudaStream_t stream) {
  DIFF_CHECK(launch_ln<T>(x, nullptr, 1, ln_w, ln_b, ln_eps, nullptr, xn, R, C, stream));
  DIFF_CHECK(launch_gemm<kEpiBias>(xn, w_qkv, b_qkv, nullptr, nullptr, qkv, R, 3 * C, C, stream));
  DIFF_CHECK(launch_attention(qkv, attn, R, C, heads, n, n, 0, scale, stream));
  DIFF_CHECK(launch_gemm<kEpiResidual>(attn, w_proj, b_proj, x, nullptr, out, R, C, C, stream));
  return 0;
}

}  // namespace

#define BLOCK_ARGS                                                                              \
  x, t_rows, rows_per_item, dp, ln1_w, ln1_b, ln1_eps, w_qkv, b_qkv, w_proj, b_proj, ln2_w,    \
      ln2_b, ln2_eps, w_fc1, b_fc1, w_fc2, b_fc2, oln_w, oln_b, oln_eps, xs, xn, qkv, attn, h1, \
      mid, out, R, C, hidden, n, n_pad, j_groups, heads, scale, launches,                       \
      static_cast<cudaStream_t>(stream_ptr)

// The block at f32: B1 with j_groups == 0 (groups of n_pad rows, the first
// n real), B2 with j_groups = J (groups of n frames of the spatial-major
// rows; n_pad unused, rows_per_item = n·J). See run_block.
extern "C" int diff3dhpe_fused_block_f32(
    const float* x, const float* t_rows, int rows_per_item, const float* dp,
    const float* ln1_w, const float* ln1_b, float ln1_eps,
    const float* w_qkv, const float* b_qkv, const float* w_proj, const float* b_proj,
    const float* ln2_w, const float* ln2_b, float ln2_eps,
    const float* w_fc1, const float* b_fc1, const float* w_fc2, const float* b_fc2,
    const float* oln_w, const float* oln_b, float oln_eps,
    float* xs, float* xn, float* qkv, float* attn, float* h1, float* mid, float* out,
    int R, int C, int hidden, int n, int n_pad, int j_groups, int heads, float scale,
    int* launches, void* stream_ptr) {
  return run_block<float>(BLOCK_ARGS);
}

// The same at bf16: activations, weights and scratch bf16; LN parameters,
// biases and dp float.
extern "C" int diff3dhpe_fused_block_bf16(
    const bf16* x, const bf16* t_rows, int rows_per_item, const float* dp,
    const float* ln1_w, const float* ln1_b, float ln1_eps,
    const bf16* w_qkv, const float* b_qkv, const bf16* w_proj, const float* b_proj,
    const float* ln2_w, const float* ln2_b, float ln2_eps,
    const bf16* w_fc1, const float* b_fc1, const bf16* w_fc2, const float* b_fc2,
    const float* oln_w, const float* oln_b, float oln_eps,
    bf16* xs, bf16* xn, bf16* qkv, bf16* attn, bf16* h1, bf16* mid, bf16* out,
    int R, int C, int hidden, int n, int n_pad, int j_groups, int heads, float scale,
    int* launches, void* stream_ptr) {
  return run_block<bf16>(BLOCK_ARGS);
}

#define ATTN_BLOCK_ARGS                                                                    \
  x, ln_w, ln_b, ln_eps, w_qkv, b_qkv, w_proj, b_proj, xn, qkv, attn, out, R, C, n, heads, \
      scale, launches, static_cast<cudaStream_t>(stream_ptr)

// B5 at f32 and at bf16 (activations, weights and scratch bf16; LN
// parameters and biases float). See run_attn_block.
extern "C" int diff3dhpe_fused_attn_block_f32(
    const float* x, const float* ln_w, const float* ln_b, float ln_eps,
    const float* w_qkv, const float* b_qkv, const float* w_proj, const float* b_proj,
    float* xn, float* qkv, float* attn, float* out,
    int R, int C, int n, int heads, float scale, int* launches, void* stream_ptr) {
  return run_attn_block<float>(ATTN_BLOCK_ARGS);
}

extern "C" int diff3dhpe_fused_attn_block_bf16(
    const bf16* x, const float* ln_w, const float* ln_b, float ln_eps,
    const bf16* w_qkv, const float* b_qkv, const bf16* w_proj, const float* b_proj,
    bf16* xn, bf16* qkv, bf16* attn, bf16* out,
    int R, int C, int n, int heads, float scale, int* launches, void* stream_ptr) {
  return run_attn_block<bf16>(ATTN_BLOCK_ARGS);
}

// Head width the attention kernel is compiled for, and the most keys per
// group it holds; the wrapper checks both before launching.
extern "C" int diff3dhpe_attn_head_dim() { return grand::kHeadDim; }
extern "C" int diff3dhpe_attn_max_n() { return grand::kMaxN; }
