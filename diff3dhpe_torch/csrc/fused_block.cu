// Hopper (sm_90a) port of one MixSTE transformer block on flat rows, f32.
//
// Replaces: diff3dhpe_tpu/ops/fused_block.py::_fused_full_block_kernel
// (wrapper fused_transformer_block), with its device functions
// ops/attention.py::grand_attend_tile, fused_block.py::_layernorm_rows and
// fused_block.py::_gelu_exact.
//
// What it computes, on x [R, C] whose rows form groups of n_pad rows (the
// first n of each group real):
//   xs  = x [+ t_rows[row / rows_per_item]]
//   h1  = xs + s0 · proj(GRAND(LN1(xs)))      GRAND = softmax(q kᵀ·d^-½) v − v
//   out = h1 + s1 · fc2(GELU(fc1(LN2(h1))))   GELU exact (erff)
//   out = LN_out(out)                          when an out-LN is given
// Attention stays inside each group and reads only its n real keys. s0, s1
// are the row's drop-path scales dp[row, 0], dp[row, 1] (1 without dp),
// applied to each branch, bias included, before its residual add.
//
// What bounds it on an H100: at C=512, hidden=1024 and R=16,524 rows the
// four GEMMs carry ~69 GFLOP against ~0.3 GB of compulsory traffic, so the
// block is bound by float32 arithmetic (67 TFLOP/s outside the tensor cores
// on the SXM part); attention adds 0.6 GFLOP at n=17 and 8.2 GFLOP at
// n=243. All products are plain f32 FMAs (no TF32), matching the JAX
// "highest" contraction.
//
// Design: a small set of kernels, each right first and simple.
//   ln_rows_kernel        one warp per row: [time add] + LayerNorm.
//   gemm_nt_kernel<EPI>   128x128x8 shared-memory tiles, 8x8 outputs per
//                         thread, register-staged double buffering; the
//                         epilogue adds the bias and then either nothing,
//                         exact GELU, or the residual (after the row's
//                         drop-path scale).
//   grand_attn_kernel     grand_attn.cuh, shared with grand_attention.cu:
//                         one block per (group, head) with the group's K
//                         and V in shared memory, reading q, k and v out of
//                         the qkv buffer through strides.
// The intermediates (LN output, qkv, attention output, h1, MLP hidden)
// make one round trip through device memory each; a single fused kernel
// with wgmma/TMA is later work.

#include <cuda_runtime.h>
#include <math.h>

#include "grand_attn.cuh"

namespace {

using grand::warp_sum;

constexpr int BM = 128, BN = 128, BK = 8, kGemmThreads = 256;

enum Epilogue { kEpiBias = 0, kEpiGelu = 1, kEpiResidual = 2 };

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// y[r] = LN(x[r] + t[r / rows_per_item]) * w + b; with xs != nullptr also
// xs[r] = x[r] + t[...] (the residual stream the block adds to).
__global__ void ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ t,
                               int rows_per_item, const float* __restrict__ w,
                               const float* __restrict__ b, float eps,
                               float* __restrict__ xs, float* __restrict__ y, int R, int C) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* xr = x + (size_t)row * C;
  const float* tr = t ? t + (size_t)(row / rows_per_item) * C : nullptr;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += tr ? xr[c] + tr[c] : xr[c];
  const float mu = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = (tr ? xr[c] + tr[c] : xr[c]) - mu;
    sq += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / C + eps);
  float* yr = y + (size_t)row * C;
  float* xsr = xs ? xs + (size_t)row * C : nullptr;
  for (int c = lane; c < C; c += 32) {
    const float v = tr ? xr[c] + tr[c] : xr[c];
    if (xsr) xsr[c] = v;
    yr[c] = (v - mu) * rstd * w[c] + b[c];
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

cudaError_t launch_attention(const float* qkv, float* out, int R, int C, int heads, int n,
                             int n_pad, float scale, cudaStream_t stream) {
  // Group g, head h: q at qkv[g * n_pad + i, h * 64], k and v C and 2C
  // columns further; the output at out[g * n_pad + i, h * 64].
  const long long ld = 3LL * C;
  const grand::Strides s_in{n_pad * ld, grand::kHeadDim, ld};
  const grand::Strides s_out{(long long)n_pad * C, grand::kHeadDim, C};
  return grand::launch_grand_attn(qkv, qkv + C, qkv + 2 * C, out, s_in, s_in, s_in, s_out,
                                  R / n_pad, heads, n, n_pad, scale, stream);
}

cudaError_t launch_ln(const float* x, const float* t, int rows_per_item, const float* w,
                      const float* b, float eps, float* xs, float* y, int R, int C,
                      cudaStream_t stream) {
  constexpr int kRowsPerBlock = 8;
  ln_rows_kernel<<<(R + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, stream>>>(
      x, t, rows_per_item, w, b, eps, xs, y, R, C);
  return cudaGetLastError();
}

}  // namespace

#define DIFF_CHECK(call)                   \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
    ++*launches;                           \
  } while (0)

// The whole block, launched on `stream` as 7 kernels (8 with the out-LN).
// Returns the first cudaError_t that a launch reported (0 on success) and
// adds one to *launches for every kernel it launched. Null bias pointers
// mean "no bias"; t_rows == nullptr skips the time add (xs is then unused);
// oln_w == nullptr skips the out-LN (fc2_out is then unused); dp == nullptr
// skips the drop-path scales, else dp is [R, 2] (attention, MLP branch).
// Scratch: xn [R, C], qkv [R, 3C], attn [R, C], h1 [R, C], mid [R, hidden].
extern "C" int diff3dhpe_fused_block_f32(
    const float* x, const float* t_rows, int rows_per_item, const float* dp,
    const float* ln1_w, const float* ln1_b, float ln1_eps,
    const float* w_qkv, const float* b_qkv, const float* w_proj, const float* b_proj,
    const float* ln2_w, const float* ln2_b, float ln2_eps,
    const float* w_fc1, const float* b_fc1, const float* w_fc2, const float* b_fc2,
    const float* oln_w, const float* oln_b, float oln_eps,
    float* xs, float* xn, float* qkv, float* attn, float* h1, float* mid, float* out,
    int R, int C, int hidden, int n, int n_pad, int heads, float scale,
    int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* resid = t_rows ? xs : x;
  DIFF_CHECK(launch_ln(x, t_rows, rows_per_item, ln1_w, ln1_b, ln1_eps, t_rows ? xs : nullptr,
                       xn, R, C, stream));
  DIFF_CHECK(launch_gemm<kEpiBias>(xn, w_qkv, b_qkv, nullptr, nullptr, qkv, R, 3 * C, C, stream));
  DIFF_CHECK(launch_attention(qkv, attn, R, C, heads, n, n_pad, scale, stream));
  DIFF_CHECK(launch_gemm<kEpiResidual>(attn, w_proj, b_proj, resid, dp, h1, R, C, C, stream));
  DIFF_CHECK(launch_ln(h1, nullptr, 1, ln2_w, ln2_b, ln2_eps, nullptr, xn, R, C, stream));
  DIFF_CHECK(launch_gemm<kEpiGelu>(xn, w_fc1, b_fc1, nullptr, nullptr, mid, R, hidden, C, stream));
  float* fc2_out = oln_w ? attn : out;
  DIFF_CHECK(launch_gemm<kEpiResidual>(mid, w_fc2, b_fc2, h1, dp ? dp + 1 : nullptr, fc2_out, R, C, hidden, stream));
  if (oln_w) {
    DIFF_CHECK(launch_ln(fc2_out, nullptr, 1, oln_w, oln_b, oln_eps, nullptr, out, R, C, stream));
  }
  return 0;
}

// Head width the attention kernel is compiled for, and the most keys per
// group it holds; the wrapper checks both before launching.
extern "C" int diff3dhpe_attn_head_dim() { return grand::kHeadDim; }
extern "C" int diff3dhpe_attn_max_n() { return grand::kMaxN; }
