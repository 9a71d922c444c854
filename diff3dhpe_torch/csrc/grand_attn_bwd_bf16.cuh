// bf16 GRAND attention backward on the tensor cores, for Hopper (sm_90a):
// B4 at bf16 (grand_attention.cu), head width 64 or 128, n <= 256.
//
// Stands for diff3dhpe_tpu/ops/attention.py::_grand_attn_bwd_kernel on bf16
// operands (its tile _grand_attn_bwd_tile, :275-300), and keeps its rounding
// points. Per (group, head), with P recomputed from q and k:
//   S  = q·kᵀ summed in f32, P = softmax(S·scale) in f32, pad keys masked
//   dP = dO·vᵀ summed in f32, Dᵢ = Σⱼ dPᵢⱼ Pᵢⱼ
//   dS = bf16(P ∘ (dP − D) · scale),  P̃ = bf16(P)
//   dq = bf16(dS·k),  dk = bf16(dSᵀ·q)   (f32 sums)
//   dv = bf16(P̃ᵀ·dO − dO)                 (f32 sum and difference, one rounding)
// P is the row's exp(S·scale − max·scale) times one IEEE reciprocal of its
// sum, as the forward (grand_attn_bf16.cuh) forms it: at most one f32 ulp
// from JAX's quotient, before roundings that keep 8 bits.
//
// What bounds it on an H100: at the train shapes (G = B·H = 1,632 pairs of
// N = 243 at d = 128, or 3,264 at d = 64) the five products of the formulas
// are 10·G·N²·d = 123 GFLOP (0.125 ms at 989 TFLOP/s) and q, k, v, dO, dq,
// dk, dv are 7·G·N·d·2 B = 0.71 GB (0.21 ms at 3.35 TB/s): bytes bound it.
// The N² exponentials (96 M a pass) and the f32 epilogues of the N x N
// tiles cost more issue slots than the products.
//
// Design: two kernels, no atomics, so the same inputs give the same bits.
// Both keep a pair's operands in shared memory as the forward does (rows
// padded by 16 bytes, ldmatrix, mma.sync m16n8k16 bf16 -> f32) and hold
// nothing N x N outside registers.
//   1. dq pass: a warp owns 16 query rows, a block 4 (d = 64) or 8
//      (d = 128) warps of one pair, with the pair's K and V whole. The
//      warp's score block S stays in registers (as the forward's), becomes P
//      in f32, and one sweep over 16-key chunks forms dP and D; a second
//      sweep forms dP again, dS from it (rounded and packed into an A
//      fragment on the way, as the forward packs P), and dq += dS·K. dP is
//      formed twice: keeping it beside P would need 2 x 128 registers a
//      lane at N = 256. The pass writes each row's −max·scale, 1/sum and D.
//   2. dk/dv pass: a warp owns 16 keys, a block 8 warps (128 keys) of one
//      pair, with the pair's Q and dO whole and the rows' statistics. For
//      each chunk of 16 queries it forms the transposed tiles Sᵀ = K·Qᵀ and
//      dPᵀ = V·dOᵀ, Pᵀ from the statistics with the same formula as pass
//      1, dSᵀ, and dv += P̃ᵀ·dO, dk += dSᵀ·Q with P̃ᵀ and dSᵀ as A fragments
//      straight from the C fragments. dv's "− dO" is taken in f32 before
//      the one rounding.
//   So the call does 16·G·N²·d FLOP against the formulas' 10 (S and dP in
//   both passes, dP twice in the first), and reads and writes each operand
//   once from device memory (q, k, v, dO are read again from L2 by the
//   blocks of a pair). Shared memory: pass 1 204 KB (d = 128, one block an
//   SM) or 90 KB (d = 64, two); pass 2 207 KB or 111 KB at n = 256.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "grand_attn_bf16.cuh"

namespace grand {

// Warps a block of the dq pass (16 query rows each) and blocks an SM.
template <int D>
struct TcBwd {
  static constexpr int kWarps = D == 128 ? 8 : 4;
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
};
constexpr int kBwdKeyWarps = 8;  // warps a block of the dk/dv pass, 16 keys each

// dS = bf16(P ∘ (dP − D) · scale), in JAX's order of operations.
__device__ __forceinline__ float bwd_ds(float p, float dp, float dsum, float scale) {
  return p * (dp - dsum) * scale;
}

// B4 at bf16, pass 1: dq of the warp's 16 query rows of pair blockIdx.x
// (b = pair / H, h = pair % H), rows (blockIdx.y·kWarps + warp)·16 ...; the
// keys are padded to 16·KT16 >= n. stats: three planes of [pairs][n16]
// floats, each row's −max·scale, 1/sum and D, for pass 2.
template <int D, int KT16>
__global__ void __launch_bounds__(32 * TcBwd<D>::kWarps, TcBwd<D>::kMinBlocks)
grand_attn_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                              Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int H,
                              int n, int n16, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = tc_ld<D>(), kKeys = 16 * KT16, kW = TcBwd<D>::kWarps;
  extern __shared__ __align__(16) unsigned char bwd_dq_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_dq_smem);
  bf16* Vs = Ks + kKeys * kLd;
  bf16* Qs = Vs + kKeys * kLd;
  bf16* Gs = Qs + 16 * kW * kLd;  // dO rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x, b = pair / H, h = pair % H;
  const int q0 = blockIdx.y * kW * 16;
  const bf16* gbase = dout + b * sdo.b + h * sdo.h;

  // Q and K first; dO and V as a second group that lands during the softmax.
  stage_rows<D>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, 16 * kW, n, threadIdx.x, blockDim.x);
  stage_rows<D>(Ks, k + b * sk.b + h * sk.h, sk.n, 0, kKeys, n, threadIdx.x, blockDim.x);
  mma::cp_async_commit();
  stage_rows<D>(Gs, gbase, sdo.n, q0, 16 * kW, n, threadIdx.x, blockDim.x);
  stage_rows<D>(Vs, v + b * sv.b + h * sv.h, sv.n, 0, kKeys, n, threadIdx.x, blockDim.x);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();
  __syncthreads();

  const int i0 = q0 + warp * 16;  // this warp's first query row
  const bool active = i0 < n;
  const int g = lane >> 2, t = lane & 3;
  float s[2 * KT16][4];  // S, then P in f32
  float nm0 = 0.f, nm1 = 0.f, r0 = 0.f, r1 = 0.f;
  if (active) {
    tc_scores<D, KT16>(s, Qs + warp * 16 * kLd, Ks, n, lane);
    float sum0, sum1;
    tc_exp_rows<KT16>(s, n, scale, nm0, nm1, sum0, sum1);
    r0 = 1.0f / sum0;
    r1 = 1.0f / sum1;
#pragma unroll
    for (int j = 0; j < 2 * KT16; ++j) {
      s[j][0] *= r0;
      s[j][1] *= r0;
      s[j][2] *= r1;
      s[j][3] *= r1;
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // dO and V have landed
  if (!active) return;

  // D = Σ P ∘ dP over the row, dP chunk by chunk.
  const bf16* Gw = Gs + warp * 16 * kLd;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int kc = 0; kc < KT16; ++kc) {
    if (kc * 16 < n) {
      float dp[2][4];
      tc_chunk_product<D>(dp, Gw, Vs + kc * 16 * kLd, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        d0 += s[2 * kc + j][0] * dp[j][0] + s[2 * kc + j][1] * dp[j][1];
        d1 += s[2 * kc + j][2] * dp[j][2] + s[2 * kc + j][3] * dp[j][3];
      }
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);

  // dq = dS·K, dS formed from dP again, chunk by chunk.
  float acc[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KT16; ++kc) {
    if (kc * 16 < n) {
      float dp[2][4];
      tc_chunk_product<D>(dp, Gw, Vs + kc * 16 * kLd, lane);
      float ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = bwd_ds(s[2 * kc + j][e], dp[j][e], e < 2 ? d0 : d1, scale);
      }
      const unsigned a[4] = {mma::pack_bf16(ds[0][0], ds[0][1]), mma::pack_bf16(ds[0][2], ds[0][3]),
                             mma::pack_bf16(ds[1][0], ds[1][1]), mma::pack_bf16(ds[1][2], ds[1][3])};
      tc_acc_chunk<D>(acc, a, Ks + kc * 16 * kLd, lane);
    }
  }

  // The rows' statistics for pass 2, then dq staged in this warp's Q rows.
  if (t == 0) {
    const size_t plane = (size_t)gridDim.x * n16;
    float* st = stats + (size_t)pair * n16 + i0;
    if (i0 + g < n) {
      st[g] = nm0;
      st[plane + g] = r0;
      st[2 * plane + g] = d0;
    }
    if (i0 + g + 8 < n) {
      st[g + 8] = nm1;
      st[plane + g + 8] = r1;
      st[2 * plane + g + 8] = d1;
    }
  }
  bf16* Os = Qs + warp * 16 * kLd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      *reinterpret_cast<__nv_bfloat162*>(Os + (g + half * 8) * kLd + jd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[jd][2 * half], acc[jd][2 * half + 1]);
    }
  }
  tc_store_rows<D>(dq + b * sdq.b + h * sdq.h, sdq.n, Os, i0, n, lane);
}

// Bytes of shared memory of the dk/dv pass: Q and dO [n16][D + 8], K and V
// [16·kBwdKeyWarps][D + 8], then the statistics [3][n16] floats.
template <int D>
__host__ __device__ constexpr size_t bwd_dkdv_bytes(int n16) {
  return (size_t)(2 * n16 + 2 * 16 * kBwdKeyWarps) * tc_ld<D>() * sizeof(__nv_bfloat16) +
         3 * (size_t)n16 * sizeof(float);
}

// B4 at bf16, pass 2: dk and dv of the warp's 16 keys of pair blockIdx.x,
// keys (blockIdx.y·kBwdKeyWarps + warp)·16 ..., over every query row, from
// the statistics pass 1 wrote.
template <int D>
__global__ void __launch_bounds__(32 * kBwdKeyWarps, D == 128 ? 1 : 2)
grand_attn_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                                Strides sdo, Strides sdk, Strides sdv, int H, int n, int n16,
                                float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = tc_ld<D>(), kKeys = 16 * kBwdKeyWarps;
  extern __shared__ __align__(16) unsigned char bwd_dkdv_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_dkdv_smem);
  bf16* Gs = Qs + n16 * kLd;  // dO rows
  bf16* Ks = Gs + n16 * kLd;
  bf16* Vs = Ks + kKeys * kLd;
  float* St = reinterpret_cast<float*>(Vs + kKeys * kLd);  // −max·scale, 1/sum, D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x, b = pair / H, h = pair % H;
  const int k0 = blockIdx.y * kKeys;
  const bf16* gbase = dout + b * sdo.b + h * sdo.h;

  stage_rows<D>(Qs, q + b * sq.b + h * sq.h, sq.n, 0, n16, n, threadIdx.x, blockDim.x);
  stage_rows<D>(Gs, gbase, sdo.n, 0, n16, n, threadIdx.x, blockDim.x);
  stage_rows<D>(Ks, k + b * sk.b + h * sk.h, sk.n, k0, kKeys, n, threadIdx.x, blockDim.x);
  stage_rows<D>(Vs, v + b * sv.b + h * sv.h, sv.n, k0, kKeys, n, threadIdx.x, blockDim.x);
  mma::cp_async_commit();
  const size_t plane = (size_t)gridDim.x * n16;
  for (int e = threadIdx.x; e < 3 * n16; e += blockDim.x) {
    const int i = e % n16;
    St[e] = i < n ? stats[(e / n16) * plane + (size_t)pair * n16 + i] : 0.f;
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  const int j0 = k0 + warp * 16;  // this warp's first key
  if (j0 >= n) return;
  const int g = lane >> 2, t = lane & 3;
  const bf16* Kw = Ks + warp * 16 * kLd;
  const bf16* Vw = Vs + warp * 16 * kLd;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[jd][e] = dv_acc[jd][e] = 0.f;

  for (int qc = 0; qc * 16 < n; ++qc) {
    // Sᵀ and dPᵀ of the warp's keys (rows g, g + 8) and 16 queries (columns).
    float st[2][4], dpt[2][4];
    tc_chunk_product<D>(st, Kw, Qs + qc * 16 * kLd, lane);
    tc_chunk_product<D>(dpt, Vw, Gs + qc * 16 * kLd, lane);
    float p[2][4], ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = qc * 16 + 8 * j + 2 * t + (e & 1);  // the query
        const bool ok = i < n;
        p[j][e] = ok ? expf(fmaf(st[j][e], scale, St[i])) * St[n16 + i] : 0.f;
        ds[j][e] = ok ? bwd_ds(p[j][e], dpt[j][e], St[2 * n16 + i], scale) : 0.f;
      }
    }
    const unsigned pa[4] = {mma::pack_bf16(p[0][0], p[0][1]), mma::pack_bf16(p[0][2], p[0][3]),
                            mma::pack_bf16(p[1][0], p[1][1]), mma::pack_bf16(p[1][2], p[1][3])};
    const unsigned da[4] = {mma::pack_bf16(ds[0][0], ds[0][1]), mma::pack_bf16(ds[0][2], ds[0][3]),
                            mma::pack_bf16(ds[1][0], ds[1][1]), mma::pack_bf16(ds[1][2], ds[1][3])};
    tc_acc_chunk<D>(dv_acc, pa, Gs + qc * 16 * kLd, lane);
    tc_acc_chunk<D>(dk_acc, da, Qs + qc * 16 * kLd, lane);
  }

  // dv = bf16(P̃ᵀ·dO − dO) and dk = bf16(dSᵀ·Q), staged in this warp's V and
  // K rows (no other warp reads them). dO of key j is row j of Gs (j < n).
  bf16* Vo = Vs + warp * 16 * kLd;
  bf16* Ko = Ks + warp * 16 * kLd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + half * 8, j = j0 + r;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = jd * 8 + 2 * t;
      float2 gv = make_float2(0.f, 0.f);
      if (j < n) gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Gs + j * kLd + col));
      *reinterpret_cast<__nv_bfloat162*>(Vo + r * kLd + col) =
          __floats2bfloat162_rn(dv_acc[jd][2 * half] - gv.x, dv_acc[jd][2 * half + 1] - gv.y);
      *reinterpret_cast<__nv_bfloat162*>(Ko + r * kLd + col) =
          __floats2bfloat162_rn(dk_acc[jd][2 * half], dk_acc[jd][2 * half + 1]);
    }
  }
  tc_store_rows<D>(dv + b * sdv.b + h * sdv.h, sdv.n, Vo, j0, n, lane);
  tc_store_rows<D>(dk + b * sdk.b + h * sdk.h, sdk.n, Ko, j0, n, lane);
}

template <typename Kernel>
inline cudaError_t tc_allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int KT16>
inline cudaError_t launch_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                      __nv_bfloat16* dq, float* stats, Strides sq, Strides sk,
                                      Strides sv, Strides sdo, Strides sdq, int B, int H, int n,
                                      float scale, cudaStream_t stream) {
  constexpr int kW = TcBwd<D>::kWarps;
  const int n16 = (n + 15) / 16 * 16;
  const size_t bytes = (size_t)(2 * 16 * KT16 + 2 * 16 * kW) * tc_ld<D>() * sizeof(__nv_bfloat16);
  const cudaError_t err = tc_allow_smem(grand_attn_bwd_dq_bf16_kernel<D, KT16>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (n16 / 16 + kW - 1) / kW);
  grand_attn_bwd_dq_bf16_kernel<D, KT16><<<grid, 32 * kW, bytes, stream>>>(
      q, k, v, dout, dq, stats, sq, sk, sv, sdo, sdq, H, n, n16, scale);
  return cudaGetLastError();
}

template <int D>
inline cudaError_t launch_bwd_dkdv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                        const float* stats, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                        Strides sq, Strides sk, Strides sv, Strides sdo,
                                        Strides sdk, Strides sdv, int B, int H, int n,
                                        float scale, cudaStream_t stream) {
  const int n16 = (n + 15) / 16 * 16;
  const size_t bytes = bwd_dkdv_bytes<D>(n16);
  const cudaError_t err = tc_allow_smem(grand_attn_bwd_dkdv_bf16_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (n + 16 * kBwdKeyWarps - 1) / (16 * kBwdKeyWarps));
  grand_attn_bwd_dkdv_bf16_kernel<D><<<grid, 32 * kBwdKeyWarps, bytes, stream>>>(
      q, k, v, dout, stats, dk, dv, sq, sk, sv, sdo, sdk, sdv, H, n, n16, scale);
  return cudaGetLastError();
}

// B4 at bf16 on (B, H) groups of n <= kMaxN rows at head width D: pass 1,
// then pass 2. stats: 3·B·H·n16 floats of scratch (n16 = n rounded up to
// 16). Adds one to *launches for each kernel launched; returns the first
// cudaError_t reported.
template <int D>
inline cudaError_t launch_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                   __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                   float* stats, Strides sq, Strides sk, Strides sv, Strides sdo,
                                   Strides sdq, Strides sdk, Strides sdv, int B, int H, int n,
                                   float scale, int* launches, cudaStream_t stream) {
#define DQ_ARGS q, k, v, dout, dq, stats, sq, sk, sv, sdo, sdq, B, H, n, scale, stream
  cudaError_t err = n <= 128 ? launch_bwd_dq_bf16<D, 8>(DQ_ARGS) : launch_bwd_dq_bf16<D, 16>(DQ_ARGS);
#undef DQ_ARGS
  if (err != cudaSuccess) return err;
  ++*launches;
  err = launch_bwd_dkdv_bf16<D>(q, k, v, dout, stats, dk, dv, sq, sk, sv, sdo, sdk, sdv, B, H, n,
                                scale, stream);
  if (err != cudaSuccess) return err;
  ++*launches;
  return cudaSuccess;
}

}  // namespace grand
