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
// Attention adds 0.6 GFLOP at n=17 and 8.2 GFLOP at n=243: on the CUDA cores
// at f32, on the tensor cores at bf16, where the softmax's exponentials and
// the K/V loads bound it, not the products.
//
// Design: a small set of kernels.
//   ln_rows_kernel<T, kPL>
//                         [time add] + LayerNorm, one warp a row held in
//                         registers: each lane loads kPL 16-byte pieces of
//                         the row (and of its time row) at once, then the
//                         mean, the variance about it and the output come
//                         from registers, and the output (and xs) go out as
//                         16-byte stores. Bound by bytes: one read of x (and
//                         t), one write of y (and xs).
//   gemm_nt_kernel<EPI>   f32: 128 x 128 x 8 shared-memory tiles, 8 x 8
//                         outputs a thread, a register-staged double
//                         buffer (the next k-tile's float4s are loaded into
//                         registers while the current tile computes, then
//                         stored k-major), exact f32 FMAs summed over k in
//                         order.
//   gemm_bf16_wgmma_kernel<EPI>
//                         bf16, gemm_wgmma.cuh: the _dot_f32 products of the
//                         TPU kernel as wgmma m64n128k16 on 128x128 tiles, a
//                         TMA producer warp feeding a 3-stage swizzled ring
//                         through mbarriers, two blocks an SM.
//                         Both GEMM epilogues add the bias and then either
//                         nothing, exact GELU, or the residual (after the
//                         row's drop-path scale); the bf16 one stages the
//                         accumulators through shared memory and stores
//                         16-byte pieces of a row.
//   grand_attn_tiled_kernel, grand_attn_small_kernel
//                         f32, grand_attn.cuh, shared with grand_attention.cu
//                         (compiled for head width 64 and 128; every
//                         multiple of 8 up to 128 runs on the next one,
//                         its columns past d zero-filled): 64-query blocks
//                         streaming
//                         64-key tiles of K and V through a cp.async ring
//                         with an online softmax, or at n <= 32 persistent
//                         blocks walking the (group, head) pairs through a
//                         two-stage ring of whole pairs; both read q, k and
//                         v out of the qkv buffer through strides, and B2
//                         adds the outer group index b (blockIdx.z, or part
//                         of the pair index).
//   grand_attn_bf16_kernel
//                         bf16, grand_attn_bf16.cuh (the same head widths):
//                         the TPU device function grand_attend_tile with
//                         both products as mma.sync m16n8k16, a warp's whole
//                         score block in registers (normalise first, then
//                         round P), P handed to the second product in
//                         registers; the same strided views and outer index.
// The intermediates (LN output, qkv, attention output, h1, MLP hidden)
// make one round trip through device memory each: a block call is 7
// launches (8 with the out-LN), 4 for B5.
//
// f32 contraction modes (JAX f32_contract_mode, fused_block.py:84-164): at
// f32 every product follows one of "highest" (the above: exact f32 FMAs),
// "high3" (bf16x3: _dot_f32_3pass) or "default" (one bf16 pass), F32Mode in
// grand_attn.cuh. Under "high3" and "default" each of the four products is
//   split_bf16_kernel     A (and W) f32 -> bf16 hi and lo (hi alone for
//                         "default") in scratch, one pass bound by bytes;
//                         the weights are split on every call, since the
//                         f32 path reads the model's weights as they are;
//   gemm_f32out_wgmma_kernel<EPI, 3 or 1>
//                         gemm_wgmma_f32.cuh's persistent tensor-core GEMM:
//                         (hi, hi) into one set of f32 accumulators and
//                         (hi, lo) + (lo, hi) into a second, added once in
//                         the epilogue, or the one pass, with the same
//                         epilogues on an f32 residual and an f32 output;
// the attention step runs at that mode on the tensor-core kernel of
// grand_attn_mode.cuh (the operands rounded or split once into shared
// memory, both products on mma.sync); and the time add reads t rounded to
// bf16 ("default") or as t_hi + t_lo ("high3"), as JAX's one-hot gather
// contracts it. A block call under a mode is 15 launches (16 with the
// out-LN): 8 splits, 4 GEMMs, the attention and the LNs; B5 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "gemm_wgmma.cuh"
#include "gemm_wgmma_f32.cuh"
#include "grand_attn.cuh"
#include "grand_attn_bf16.cuh"
#include "grand_attn_mode.cuh"

namespace {

using bf16 = __nv_bfloat16;
using grand::bf16_round;
using grand::warp_sum;

constexpr int BM = 128, BN = 128, BK = 8, kGemmThreads = 256;  // the f32 GEMM's tile

using wg::gelu_erf;
using wg::kEpiBias;
using wg::kEpiGelu;
using wg::kEpiResidual;

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, bf16) { return bf16_round(x); }

// One 16-byte piece of a row: 4 floats or 8 bf16, unpacked to float and
// packed back (rounding to nearest even).
template <typename T>
struct Piece {
  static constexpr int kE = 16 / sizeof(T);
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&v)[kE]) {
    if constexpr (std::is_same<T, float>::value) {
      v[0] = __uint_as_float(raw.x), v[1] = __uint_as_float(raw.y);
      v[2] = __uint_as_float(raw.z), v[3] = __uint_as_float(raw.w);
    } else {
      const unsigned u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
        v[2 * i] = f.x, v[2 * i + 1] = f.y;
      }
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[kE]) {
    if constexpr (std::is_same<T, float>::value) {
      return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                        __float_as_uint(v[3]));
    } else {
      unsigned u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        u[i] = *reinterpret_cast<const unsigned*>(&h);
      }
      return make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
};

// y[r] = LN(xs[r]) * w + b with xs[r] = x[r] + t[r / rows_per_item]
// rounded to T; with xs != nullptr xs is also written (the residual
// stream the block adds to). Statistics and the affine map in float. One
// warp a row: lane l holds pieces l, l + 32, ... (kPL of them at most) of
// the row; C is a multiple of a piece (checked by the caller).
//
// kMode (F32Mode; T = float only): the time row as JAX's one-hot gather
// contracts it under the block's mode: t itself (kHighest), bf16(t)
// (kDefault), or t_hi + t_lo with t_hi = bf16(t), t_lo = bf16(t − t_hi)
// (kHigh3).
template <typename T, int kPL, int kMode = grand::kHighest>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ t, int rows_per_item,
               const float* __restrict__ w, const float* __restrict__ b, float eps,
               T* __restrict__ xs, T* __restrict__ y, int R, int C) {
  using P = Piece<T>;
  constexpr int kE = P::kE;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const int pieces = C / kE;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  const uint4* tr = t ? reinterpret_cast<const uint4*>(t + (size_t)(row / rows_per_item) * C)
                      : nullptr;
  uint4 raw[kPL], traw[kPL];
#pragma unroll
  for (int p = 0; p < kPL; ++p) {
    const int c = lane + 32 * p;
    if (c < pieces) {
      raw[p] = xr[c];
      if (tr) traw[p] = tr[c];
    }
  }
  float v[kPL][kE];
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < kPL; ++p) {
    if (lane + 32 * p >= pieces) continue;
    P::unpack(raw[p], v[p]);
    if (tr) {
      float tv[kE];
      P::unpack(traw[p], tv);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if constexpr (kMode == grand::kDefault) tv[e] = bf16_round(tv[e]);
        if constexpr (kMode == grand::kHigh3) {
          const float hi = bf16_round(tv[e]);
          tv[e] = hi + bf16_round(tv[e] - hi);
        }
        v[p][e] = round_to(v[p][e] + tv[e], T());
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) sum += v[p][e];
  }
  const float mu = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int p = 0; p < kPL; ++p) {
    if (lane + 32 * p >= pieces) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float d = v[p][e] - mu;
      sq += d * d;
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / C + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * C);
  uint4* xsr = xs ? reinterpret_cast<uint4*>(xs + (size_t)row * C) : nullptr;
#pragma unroll
  for (int p = 0; p < kPL; ++p) {
    const int c = lane + 32 * p;
    if (c >= pieces) continue;
    if (xsr) xsr[c] = P::pack(v[p]);
    float o[kE];
#pragma unroll
    for (int e = 0; e < kE; e += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w + c * kE + e);
      const float4 bv = *reinterpret_cast<const float4*>(b + c * kE + e);
      o[e + 0] = (v[p][e + 0] - mu) * rstd * wv.x + bv.x;
      o[e + 1] = (v[p][e + 1] - mu) * rstd * wv.y + bv.y;
      o[e + 2] = (v[p][e + 2] - mu) * rstd * wv.z + bv.z;
      o[e + 3] = (v[p][e + 3] - mu) * rstd * wv.w + bv.w;
    }
    yr[c] = P::pack(o);
  }
}

// The most 16-byte pieces a lane holds: rows of up to 32 · 16 pieces
// (C <= 2048 at f32, 4096 at bf16).
constexpr int kLnMaxPiecesPerLane = 16;

// ---- f32 -> bf16 hi/lo split (the operands of the contraction modes) -----------

// Replaces the operand casts of diff3dhpe_tpu/ops/fused_block.py::
// _dot_f32_3pass (:137-140) and _dot_f32's "default" pass: hi = bf16(x)
// (nearest even) and, where lo is not null, lo = bf16(x − hi), for n8 pieces
// of 8 values (n a multiple of 8, 16-byte aligned). Bound by bytes: 4 read
// and 2 or 4 written a value; each thread moves 32 bytes in and 16 (or 32)
// out a piece, grid-stride.
__global__ void __launch_bounds__(256)
split_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ hi, bf16* __restrict__ lo,
                  long long n8) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint4 h, l;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(&h);
    __nv_bfloat162* lp = reinterpret_cast<__nv_bfloat162*>(&l);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hp[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      const float2 hf = __bfloat1622float2(hp[j]);
      lp[j] = __floats2bfloat162_rn(v[2 * j] - hf.x, v[2 * j + 1] - hf.y);
    }
    reinterpret_cast<uint4*>(hi)[i] = h;
    if (lo) reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

cudaError_t launch_split(const float* x, bf16* hi, bf16* lo, long long n, cudaStream_t stream) {
  if (n <= 0 || n % 8) return cudaErrorInvalidValue;
  const long long n8 = n / 8, want = (n8 + 255) / 256;
  const int blocks = want < 132 * 16 ? (int)want : 132 * 16;
  split_bf16_kernel<<<blocks, 256, 0, stream>>>(x, hi, lo, n8);
  return cudaGetLastError();
}

// ---- f32 GEMM on the CUDA cores ------------------------------------------------

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

// ---- bf16 GEMM on the tensor cores: gemm_wgmma.cuh ----------------------------

// out[M, N] = bf16(epilogue(A[M, K] · W[N, K]ᵀ + bias)), A, W and res bf16,
// bias and rscale f32, the product and the epilogue in f32: as
// the f32 GEMM, with the residual epilogue res + s[row] · (A·Wᵀ + bias).
// K % 8 == 0, N % 8 == 0 and 16-byte aligned rows (checked by the caller).
template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias, const bf16* res,
                        const float* rscale, bf16* out, int M, int N, int K,
                        cudaStream_t stream) {
  return wg::launch_gemm_wgmma<EPI>(A, W, bias, res, rscale, out, M, N, K, stream);
}

// ---- the block ---------------------------------------------------------------

// Where the attention groups lie among the R rows.
//   rows (B1): group g is rows g·n_pad + i, i < n_pad (keys i < n).
//   cols (B2): group (b, j) is rows (b·n + f)·J + j, f < n, for J = j_groups.
// kMode: the f32 kernels' contraction mode (F32Mode).
template <typename T, int kMode = grand::kHighest>
cudaError_t launch_attention(const T* qkv, T* out, int R, int C, int heads, int n, int n_pad,
                             int j_groups, float scale, cudaStream_t stream) {
  // q of row r, head h at qkv[r, h * d] (d = C / heads), k and v C and 2C
  // columns further; the output at out[r, h * d]. float runs the f32
  // kernels of grand_attn.cuh, bf16 the tensor-core kernel of
  // grand_attn_bf16.cuh (both take d a multiple of 8 up to 128).
  constexpr bool kF32 = std::is_same<T, float>::value;
  const long long ld = 3LL * C, d = C / heads;
  if (j_groups == 0) {
    const grand::Strides s_in{n_pad * ld, d, ld};
    const grand::Strides s_out{(long long)n_pad * C, d, C};
    if constexpr (kF32) {
      return grand::launch_grand_attn<false, kMode>(qkv, qkv + C, qkv + 2 * C, out, s_in, s_in,
                                                    s_in, s_out, R / n_pad, heads, n, n_pad,
                                                    (int)d, scale, stream);
    } else {
      return grand::launch_grand_attn_bf16(qkv, qkv + C, qkv + 2 * C, out, s_in, s_in, s_in,
                                           s_out, R / n_pad, heads, n, n_pad, (int)d, scale,
                                           stream);
    }
  }
  const long long J = j_groups;
  const grand::Strides s_in{ld, d, J * ld, n * J * ld};
  const grand::Strides s_out{C, d, J * C, n * J * C};
  if constexpr (kF32) {
    return grand::launch_grand_attn<true, kMode>(qkv, qkv + C, qkv + 2 * C, out, s_in, s_in, s_in,
                                                 s_out, j_groups, heads, n, n, (int)d, scale,
                                                 stream, R / (n * j_groups));
  } else {
    return grand::launch_grand_attn_bf16<true>(qkv, qkv + C, qkv + 2 * C, out, s_in, s_in, s_in,
                                               s_out, j_groups, heads, n, n, (int)d, scale,
                                               stream, R / (n * j_groups));
  }
}

// The attention step at a runtime mode: bf16 ignores it (JAX's _dot_f32
// contracts bf16 operands in one bf16 pass whatever the mode).
template <typename T>
cudaError_t launch_attention(const T* qkv, T* out, int R, int C, int heads, int n, int n_pad,
                             int j_groups, float scale, int mode, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (mode == grand::kHigh3) {
      return launch_attention<T, grand::kHigh3>(qkv, out, R, C, heads, n, n_pad, j_groups, scale,
                                                stream);
    }
    if (mode == grand::kDefault) {
      return launch_attention<T, grand::kDefault>(qkv, out, R, C, heads, n, n_pad, j_groups,
                                                  scale, stream);
    }
    if (mode != grand::kHighest) return cudaErrorInvalidValue;
  }
  return launch_attention<T, grand::kHighest>(qkv, out, R, C, heads, n, n_pad, j_groups, scale,
                                              stream);
}

template <typename T, int kPL>
cudaError_t launch_ln_pieces(const T* x, const T* t, int rows_per_item, const float* w,
                             const float* b, float eps, T* xs, T* y, int R, int C, int mode,
                             cudaStream_t stream) {
  constexpr int kRowsPerBlock = 8;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock), block(32 * kRowsPerBlock);
  if constexpr (std::is_same<T, float>::value) {
    if (t != nullptr && mode == grand::kHigh3) {
      ln_rows_kernel<T, kPL, grand::kHigh3><<<grid, block, 0, stream>>>(x, t, rows_per_item, w, b,
                                                                        eps, xs, y, R, C);
      return cudaGetLastError();
    }
    if (t != nullptr && mode == grand::kDefault) {
      ln_rows_kernel<T, kPL, grand::kDefault><<<grid, block, 0, stream>>>(x, t, rows_per_item, w,
                                                                          b, eps, xs, y, R, C);
      return cudaGetLastError();
    }
  }
  ln_rows_kernel<T, kPL><<<grid, block, 0, stream>>>(x, t, rows_per_item, w, b, eps, xs, y, R, C);
  return cudaGetLastError();
}

// The LN kernel instance that holds a row of C values: C a multiple of a
// 16-byte piece and at most 32 · kLnMaxPiecesPerLane pieces. mode: the time
// add's contraction mode at f32 (see ln_rows_kernel).
template <typename T>
cudaError_t launch_ln(const T* x, const T* t, int rows_per_item, const float* w, const float* b,
                      float eps, T* xs, T* y, int R, int C, cudaStream_t stream,
                      int mode = grand::kHighest) {
  constexpr int kE = 16 / sizeof(T);
  const int per_lane = (C / kE + 31) / 32;
  if (C <= 0 || C % kE || per_lane > kLnMaxPiecesPerLane || mode < grand::kHighest ||
      mode > grand::kDefault) {
    return cudaErrorInvalidValue;
  }
#define LN_ARGS x, t, rows_per_item, w, b, eps, xs, y, R, C, mode, stream
  if (per_lane <= 1) return launch_ln_pieces<T, 1>(LN_ARGS);
  if (per_lane <= 2) return launch_ln_pieces<T, 2>(LN_ARGS);
  if (per_lane <= 4) return launch_ln_pieces<T, 4>(LN_ARGS);
  if (per_lane <= 8) return launch_ln_pieces<T, 8>(LN_ARGS);
  return launch_ln_pieces<T, 16>(LN_ARGS);
#undef LN_ARGS
}

// A block entry point counts its launches in launches[kCounts]: every
// kernel (kAll), and of them the LayerNorms (kLn), the GEMMs of the block's
// storage type (kGemm: gemm_nt_kernel at f32, the wgmma GEMM at bf16), the
// splits (kSplit) and the f32-output wgmma GEMMs of the contraction modes
// (kGemmMode); the rest are the attention step's. Of these, the attention
// kernels' and ln_rows_kernel's instances under "high3" or "default" are
// also counted in kAttnMode and kLnMode.
enum LaunchCount {
  kAll = 0, kLn = 1, kGemm = 2, kSplit = 3, kGemmMode = 4, kAttnMode = 5, kLnMode = 6,
  kCounts = 7
};

// Launches `call` and, when it reports success, counts it in kAll, in
// `kind` and in `also` (kAll for neither).
#define DIFF_CHECK_AS(kind, also, call)         \
  do {                                          \
    const cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return (int)e_;      \
    ++launches[kAll];                           \
    if ((kind) != kAll) ++launches[kind];       \
    if ((also) != kAll) ++launches[also];       \
  } while (0)
#define DIFF_CHECK(kind, call) DIFF_CHECK_AS(kind, kAll, call)

// One f32 product of a block under "high3" or "default": A [M, K] and W
// [N, K] split into scratch (a_hi, a_lo [M, K]; w_hi, w_lo [N, K]; the lo
// halves unused under "default"), then the f32-output wgmma GEMM at 3 passes
// or 1. 3 launches.
template <int EPI>
int run_mode_gemm(int mode, const float* A, const float* W, const float* bias, const float* res,
                  const float* rscale, float* out, int M, int N, int K, bf16* a_hi, bf16* a_lo,
                  bf16* w_hi, bf16* w_lo, int* launches, cudaStream_t stream) {
  const bool three = mode == grand::kHigh3;
  if (!three && mode != grand::kDefault) return (int)cudaErrorInvalidValue;
  DIFF_CHECK(kSplit, launch_split(W, w_hi, three ? w_lo : nullptr, (long long)N * K, stream));
  DIFF_CHECK(kSplit, launch_split(A, a_hi, three ? a_lo : nullptr, (long long)M * K, stream));
  if (three) {
    DIFF_CHECK(kGemmMode, (wgf::launch_gemm_f32out<EPI, 3>(a_hi, a_lo, w_hi, w_lo, bias, res,
                                                          rscale, out, M, N, K, stream)));
  } else {
    DIFF_CHECK(kGemmMode, (wgf::launch_gemm_f32out<EPI, 1>(a_hi, nullptr, w_hi, nullptr, bias,
                                                          res, rscale, out, M, N, K, stream)));
  }
  return 0;
}

// Carves the split scratch of a block's products under a mode: for the
// activations 2 · R · max(C, hidden) bf16 (a_split), for the weights 2 ·
// (3C·C + C·C + 2 · hidden·C) bf16 (w_split), the layout the wrapper sizes.
struct ModeScratch {
  bf16 *a_hi, *a_lo, *w_hi[4], *w_lo[4];
  ModeScratch(bf16* a_split, bf16* w_split, int R, int C, int hidden)
      : a_hi(), a_lo(), w_hi(), w_lo() {
    if (!a_split || !w_split) return;  // "highest": no scratch
    const size_t widest = (size_t)R * (C > hidden ? C : hidden);
    a_hi = a_split, a_lo = a_split + widest;
    const size_t sizes[4] = {3 * (size_t)C * C, (size_t)C * C, (size_t)hidden * C,
                             (size_t)C * hidden};
    bf16* p = w_split;
    for (int i = 0; i < 4; ++i) w_hi[i] = p, w_lo[i] = p + sizes[i], p += 2 * sizes[i];
  }
};

// A block product: the storage type's GEMM under "highest" (and at bf16),
// else run_mode_gemm on product i's weight scratch.
template <int EPI, typename T>
int block_gemm(int mode, const ModeScratch& ms, int i, const T* A, const T* W, const float* bias,
               const T* res, const float* rscale, T* out, int M, int N, int K, int* launches,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (mode != grand::kHighest) {
      return run_mode_gemm<EPI>(mode, A, W, bias, res, rscale, out, M, N, K, ms.a_hi, ms.a_lo,
                                ms.w_hi[i], ms.w_lo[i], launches, stream);
    }
  }
  DIFF_CHECK(kGemm, launch_gemm<EPI>(A, W, bias, res, rscale, out, M, N, K, stream));
  return 0;
}

#define DIFF_RUN(call)             \
  do {                             \
    const int e_ = (call);         \
    if (e_ != 0) return e_;        \
  } while (0)

// The whole block in storage type T (float, or bf16 with f32 LN parameters
// and biases), launched on `stream` as 7 kernels (8 with the out-LN).
// Returns the first cudaError_t that a launch reported (0 on success) and
// counts every kernel it launched in launches[kCounts] (see LaunchCount).
// Null bias pointers mean "no bias"; t_rows == nullptr skips the time add
// (xs is then unused); oln_w == nullptr skips the out-LN; dp == nullptr
// skips the drop-path scales, else dp is [R, 2] (attention, MLP branch)
// per row. j_groups == 0
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
              int hidden, int n, int n_pad, int j_groups, int heads, float scale, int mode,
              bf16* a_split, bf16* w_split, int* launches, cudaStream_t stream) {
  if (!std::is_same<T, float>::value) mode = grand::kHighest;
  if (mode != grand::kHighest && (!a_split || !w_split)) return (int)cudaErrorInvalidValue;
  const ModeScratch ms(a_split, w_split, R, C, hidden);
  const T* resid = t_rows ? xs : x;
  const int attn_kind = mode != grand::kHighest ? kAttnMode : kAll;
  // The LN reads the time rows under the mode (launch_ln_pieces).
  DIFF_CHECK_AS(kLn, t_rows && mode != grand::kHighest ? kLnMode : kAll,
                launch_ln(x, t_rows, rows_per_item, ln1_w, ln1_b, ln1_eps,
                          t_rows ? xs : nullptr, xn, R, C, stream, mode));
  DIFF_RUN(block_gemm<kEpiBias>(mode, ms, 0, (const T*)xn, w_qkv, b_qkv, (const T*)nullptr,
                                nullptr, qkv, R, 3 * C, C, launches, stream));
  DIFF_CHECK(attn_kind, launch_attention(qkv, attn, R, C, heads, n, n_pad, j_groups, scale, mode,
                                         stream));
  DIFF_RUN(block_gemm<kEpiResidual>(mode, ms, 1, (const T*)attn, w_proj, b_proj, resid, dp, h1,
                                    R, C, C, launches, stream));
  DIFF_CHECK(kLn, launch_ln<T>(h1, nullptr, 1, ln2_w, ln2_b, ln2_eps, nullptr, xn, R, C, stream));
  DIFF_RUN(block_gemm<kEpiGelu>(mode, ms, 2, (const T*)xn, w_fc1, b_fc1, (const T*)nullptr,
                                nullptr, mid, R, hidden, C, launches, stream));
  T* fc2_out = oln_w ? attn : out;
  DIFF_RUN(block_gemm<kEpiResidual>(mode, ms, 3, (const T*)mid, w_fc2, b_fc2, (const T*)h1,
                                    dp ? dp + 1 : nullptr, fc2_out, R, C, hidden, launches,
                                    stream));
  if (oln_w) {
    DIFF_CHECK(kLn, launch_ln<T>(fc2_out, nullptr, 1, oln_w, oln_b, oln_eps, nullptr, out, R, C,
                                 stream));
  }
  return 0;
}

// B5: the attention half of the block in storage type T, as the first 4
// kernels of run_block without the time add and the drop-path scales:
// out = x + proj(GRAND(LN1(x))) on groups of n consecutive rows. bf16
// rounds xn, qkv (bias added first), the attention output and out, where
// the TPU kernel rounds (fused_block.py:206-228). Scratch: xn [R, C],
// qkv [R, 3C], attn [R, C]; under a mode at f32 also a_split 2·R·C and
// w_split 2·4·C·C bf16 (qkv's weight, then proj's).
template <typename T>
int run_attn_block(const T* x, const float* ln_w, const float* ln_b, float ln_eps, const T* w_qkv,
                   const float* b_qkv, const T* w_proj, const float* b_proj, T* xn, T* qkv,
                   T* attn, T* out, int R, int C, int n, int heads, float scale, int mode,
                   bf16* a_split, bf16* w_split, int* launches, cudaStream_t stream) {
  if (!std::is_same<T, float>::value) mode = grand::kHighest;
  if (mode != grand::kHighest && (!a_split || !w_split)) return (int)cudaErrorInvalidValue;
  const ModeScratch ms(a_split, w_split, R, C, C);
  DIFF_CHECK(kLn, launch_ln<T>(x, nullptr, 1, ln_w, ln_b, ln_eps, nullptr, xn, R, C, stream));
  DIFF_RUN(block_gemm<kEpiBias>(mode, ms, 0, (const T*)xn, w_qkv, b_qkv, (const T*)nullptr,
                                nullptr, qkv, R, 3 * C, C, launches, stream));
  DIFF_CHECK(mode != grand::kHighest ? kAttnMode : kAll,
             launch_attention(qkv, attn, R, C, heads, n, n, 0, scale, mode, stream));
  DIFF_RUN(block_gemm<kEpiResidual>(mode, ms, 1, (const T*)attn, w_proj, b_proj, x, nullptr, out,
                                    R, C, C, launches, stream));
  return 0;
}

}  // namespace

#define BLOCK_ARGS                                                                              \
  x, t_rows, rows_per_item, dp, ln1_w, ln1_b, ln1_eps, w_qkv, b_qkv, w_proj, b_proj, ln2_w,    \
      ln2_b, ln2_eps, w_fc1, b_fc1, w_fc2, b_fc2, oln_w, oln_b, oln_eps, xs, xn, qkv, attn, h1, \
      mid, out, R, C, hidden, n, n_pad, j_groups, heads, scale, mode, a_split, w_split,          \
      launches, static_cast<cudaStream_t>(stream_ptr)

// The block at f32: B1 with j_groups == 0 (groups of n_pad rows, the first
// n real), B2 with j_groups = J (groups of n frames of the spatial-major
// rows; n_pad unused, rows_per_item = n·J). mode: the products' F32Mode,
// with a_split and w_split the split scratch under "high3" and "default"
// (see ModeScratch; null under "highest"). launches points at int[kCounts]
// (LaunchCount). See run_block.
extern "C" int diff3dhpe_fused_block_f32(
    const float* x, const float* t_rows, int rows_per_item, const float* dp,
    const float* ln1_w, const float* ln1_b, float ln1_eps,
    const float* w_qkv, const float* b_qkv, const float* w_proj, const float* b_proj,
    const float* ln2_w, const float* ln2_b, float ln2_eps,
    const float* w_fc1, const float* b_fc1, const float* w_fc2, const float* b_fc2,
    const float* oln_w, const float* oln_b, float oln_eps,
    float* xs, float* xn, float* qkv, float* attn, float* h1, float* mid, float* out,
    int R, int C, int hidden, int n, int n_pad, int j_groups, int heads, float scale, int mode,
    bf16* a_split, bf16* w_split, int* launches, void* stream_ptr) {
  return run_block<float>(BLOCK_ARGS);
}

// The same at bf16: activations, weights and scratch bf16; LN parameters,
// biases and dp float. mode is ignored (bf16 operands contract in one bf16
// pass whatever the mode, as in JAX).
extern "C" int diff3dhpe_fused_block_bf16(
    const bf16* x, const bf16* t_rows, int rows_per_item, const float* dp,
    const float* ln1_w, const float* ln1_b, float ln1_eps,
    const bf16* w_qkv, const float* b_qkv, const bf16* w_proj, const float* b_proj,
    const float* ln2_w, const float* ln2_b, float ln2_eps,
    const bf16* w_fc1, const float* b_fc1, const bf16* w_fc2, const float* b_fc2,
    const float* oln_w, const float* oln_b, float oln_eps,
    bf16* xs, bf16* xn, bf16* qkv, bf16* attn, bf16* h1, bf16* mid, bf16* out,
    int R, int C, int hidden, int n, int n_pad, int j_groups, int heads, float scale, int mode,
    bf16* a_split, bf16* w_split, int* launches, void* stream_ptr) {
  return run_block<bf16>(BLOCK_ARGS);
}

#define ATTN_BLOCK_ARGS                                                                    \
  x, ln_w, ln_b, ln_eps, w_qkv, b_qkv, w_proj, b_proj, xn, qkv, attn, out, R, C, n, heads, \
      scale, mode, a_split, w_split, launches, static_cast<cudaStream_t>(stream_ptr)

// B5 at f32 and at bf16 (activations, weights and scratch bf16; LN
// parameters and biases float). mode, a_split, w_split as the block's.
// launches points at int[kCounts] (LaunchCount). See run_attn_block.
extern "C" int diff3dhpe_fused_attn_block_f32(
    const float* x, const float* ln_w, const float* ln_b, float ln_eps,
    const float* w_qkv, const float* b_qkv, const float* w_proj, const float* b_proj,
    float* xn, float* qkv, float* attn, float* out,
    int R, int C, int n, int heads, float scale, int mode, bf16* a_split, bf16* w_split,
    int* launches, void* stream_ptr) {
  return run_attn_block<float>(ATTN_BLOCK_ARGS);
}

extern "C" int diff3dhpe_fused_attn_block_bf16(
    const bf16* x, const float* ln_w, const float* ln_b, float ln_eps,
    const bf16* w_qkv, const float* b_qkv, const bf16* w_proj, const float* b_proj,
    bf16* xn, bf16* qkv, bf16* attn, bf16* out,
    int R, int C, int n, int heads, float scale, int mode, bf16* a_split, bf16* w_split,
    int* launches, void* stream_ptr) {
  return run_attn_block<bf16>(ATTN_BLOCK_ARGS);
}

namespace {

// One GEMM of the block alone: epilogue 0 = bias only, 1 = exact GELU,
// 2 = res + s[row] · (…); adds one to *launches when it launched.
template <typename T>
int run_gemm(const T* a, const T* w, const float* bias, const T* res, const float* rscale,
             T* out, int M, int N, int K, int epilogue, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
  if (epilogue == kEpiBias) {
    err = launch_gemm<kEpiBias>(a, w, bias, res, rscale, out, M, N, K, stream);
  } else if (epilogue == kEpiGelu) {
    err = launch_gemm<kEpiGelu>(a, w, bias, res, rscale, out, M, N, K, stream);
  } else if (epilogue == kEpiResidual && res != nullptr) {
    err = launch_gemm<kEpiResidual>(a, w, bias, res, rscale, out, M, N, K, stream);
  }
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

}  // namespace

// One product with a fused epilogue, the GEMM the four products of a block
// run, at f32 (gemm_nt_kernel on the CUDA cores, exact f32 FMAs) or at
// bf16 (the wgmma kernel): out[M, N] = epilogue(a[M, K] · w[N, K]ᵀ + bias)
// with epilogue 0 = bias only, 1 = exact GELU, 2 = res + s[row] · (…),
// s[row] = rscale[2 · row] or 1 where rscale is null; bf16 rounds the
// output once. bias may be null. One kernel; adds one to *launches when it
// launched. For measuring and testing the GEMM alone: no model path calls
// these entry points.
extern "C" int diff3dhpe_gemm_f32(const float* a, const float* w, const float* bias,
                                  const float* res, const float* rscale, float* out, int M, int N,
                                  int K, int epilogue, int* launches, void* stream_ptr) {
  return run_gemm<float>(a, w, bias, res, rscale, out, M, N, K, epilogue, launches, stream_ptr);
}

extern "C" int diff3dhpe_gemm_bf16(const bf16* a, const bf16* w, const float* bias,
                                   const bf16* res, const float* rscale, bf16* out, int M, int N,
                                   int K, int epilogue, int* launches, void* stream_ptr) {
  return run_gemm<bf16>(a, w, bias, res, rscale, out, M, N, K, epilogue, launches, stream_ptr);
}

// The block's LayerNorm alone, f32 or bf16: y = LN(xs) · w + b on R rows of
// C with xs = x + t[row / rows_per_item] rounded to the storage type (t may
// be null; xs, when not null, receives xs); at f32 t is read under mode
// (F32Mode, see ln_rows_kernel; bf16 ignores it). w, b float. One kernel;
// adds one to *launches when it launched. For measuring and testing: the
// block calls the same kernel.
extern "C" int diff3dhpe_layer_norm_f32(const float* x, const float* t, int rows_per_item,
                                        const float* w, const float* b, float eps, float* xs,
                                        float* y, int R, int C, int mode, int* launches,
                                        void* stream_ptr) {
  const cudaError_t err = launch_ln(x, t, rows_per_item, w, b, eps, xs, y, R, C,
                                    static_cast<cudaStream_t>(stream_ptr), mode);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

extern "C" int diff3dhpe_layer_norm_bf16(const bf16* x, const bf16* t, int rows_per_item,
                                         const float* w, const float* b, float eps, bf16* xs,
                                         bf16* y, int R, int C, int mode, int* launches,
                                         void* stream_ptr) {
  const cudaError_t err = launch_ln(x, t, rows_per_item, w, b, eps, xs, y, R, C,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// The split of the contraction modes alone: hi = bf16(x), and lo = bf16(x −
// hi) where lo is not null, over n values (n % 8 == 0, 16-byte aligned).
// One kernel; adds one to *launches when it launched. The block calls the
// same kernel.
extern "C" int diff3dhpe_split_bf16(const float* x, bf16* hi, bf16* lo, long long n,
                                    int* launches, void* stream_ptr) {
  const cudaError_t err = launch_split(x, hi, lo, n, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// The f32-output wgmma GEMM of the contraction modes alone, on split
// operands: out[M, N] = epilogue(Σ_p A_p · W_pᵀ + bias) in f32 over the
// three passes (a_hi, w_hi) + ((a_hi, w_lo) + (a_lo, w_hi)) with passes =
// 3, or (a_hi, w_hi) with passes = 1; res, out f32; epilogues as
// diff3dhpe_gemm_f32's. K % 8 == 0, N % 8 == 0. One kernel; adds one to
// *launches when it launched. The block calls the same kernel.
extern "C" int diff3dhpe_gemm_wgmma_f32(const bf16* a_hi, const bf16* a_lo, const bf16* w_hi,
                                        const bf16* w_lo, const float* bias, const float* res,
                                        const float* rscale, float* out, int M, int N, int K,
                                        int epilogue, int passes, int* launches,
                                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
#define WG_F32(EPI, P) \
  wgf::launch_gemm_f32out<EPI, P>(a_hi, a_lo, w_hi, w_lo, bias, res, rscale, out, M, N, K, stream)
  if (passes == 3) {
    if (epilogue == kEpiBias) err = WG_F32(kEpiBias, 3);
    if (epilogue == kEpiGelu) err = WG_F32(kEpiGelu, 3);
    if (epilogue == kEpiResidual && res) err = WG_F32(kEpiResidual, 3);
  } else if (passes == 1) {
    if (epilogue == kEpiBias) err = WG_F32(kEpiBias, 1);
    if (epilogue == kEpiGelu) err = WG_F32(kEpiGelu, 1);
    if (epilogue == kEpiResidual && res) err = WG_F32(kEpiResidual, 1);
  }
#undef WG_F32
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// The block's attention step alone at f32: out[R, C] from qkv [R, 3C]
// under mode (F32Mode), as run_block launches it, in the rows layout
// (j_groups == 0: groups of n_pad rows, the first n real) or the cols
// layout (j_groups = J: the groups (b, j) of n frames). One kernel; adds
// one to *launches when it launched. For measuring and testing.
extern "C" int diff3dhpe_block_attn_f32(const float* qkv, float* out, int R, int C, int heads,
                                        int n, int n_pad, int j_groups, float scale, int mode,
                                        int* launches, void* stream_ptr) {
  const cudaError_t err = launch_attention(qkv, out, R, C, heads, n, n_pad, j_groups, scale, mode,
                                           static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// The same at bf16: the tensor-core kernel of grand_attn_bf16.cuh, as
// run_block<bf16> launches it. For measuring and testing.
extern "C" int diff3dhpe_block_attn_bf16(const bf16* qkv, bf16* out, int R, int C, int heads,
                                         int n, int n_pad, int j_groups, float scale,
                                         int* launches, void* stream_ptr) {
  const cudaError_t err = launch_attention(qkv, out, R, C, heads, n, n_pad, j_groups, scale,
                                           grand::kHighest,
                                           static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// 1 where the block's attention step takes head width d (a multiple of 8 up
// to 128, at f32 and at bf16), and the most keys per group it holds; the
// wrapper checks both before launching.
extern "C" int diff3dhpe_attn_takes_head_dim(int d) { return grand::takes_head_dim(d); }
extern "C" int diff3dhpe_attn_max_n() { return grand::kMaxN; }

// The widest row C the LayerNorm takes at elem_bytes (4: f32, 2: bf16); C
// must also be a multiple of a 16-byte piece. The wrapper checks it.
extern "C" int diff3dhpe_ln_max_c(int elem_bytes) {
  return 32 * kLnMaxPiecesPerLane * (16 / elem_bytes);
}
