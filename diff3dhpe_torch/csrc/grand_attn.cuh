// GRAND attention forward at float32 for Hopper (sm_90a), shared by
// fused_block.cu (the attention step of B1, B2 and B5 at f32) and
// grand_attention.cu (B3 at f32). The bf16 attention is the tensor-core
// kernel of grand_attn_bf16.cuh.
//
//   out[i] = Σ_j softmax_j(q_i·k_j·scale) v_j − v_i
//
// over the first n_keys rows of a group, for its first n_queries rows.
// Every operand is read through element strides (group b, head h, row),
// with unit stride along the 64-wide head dimension, so B1 reads q, k and
// v straight out of its packed qkv [R, 3C] buffer and B3 reads [G, N, 64]
// tensors or [B, N, 3, H, 64] views of a qkv projection without a copy.
// With kOuter a group has a second index, blockIdx.z, with its own stride:
// B2's group (b, j) of the spatial-major rows (b·F + f)·J + j.
//
// Design: one block per (group, head). The group's K and V for that head
// sit in shared memory (> 48 KB at n = 243, hence dynamic shared memory);
// each warp takes 4 queries at a time, holds their scores in registers
// (n <= 256: 8 keys per lane). K carries a pad column so that the per-lane
// key reads are free of bank conflicts. expf and IEEE division, no fast
// math. As in JAX's f32 branch (ops/attention.py::grand_attend_tile), the
// normalisation comes after the AV product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace grand {

constexpr int kHeadDim = 64;
constexpr int kMaxN = 256;             // keys per group a block holds
constexpr int kKeysPerLane = kMaxN / 32;
constexpr int kQueriesPerWarp = 4;
constexpr int kMaxWarps = 8;
constexpr int kPadDim = kHeadDim + 1;  // row stride of a padded [n][64] tile

// Element strides of one [B, H, N, 64] operand; z is the stride of the
// outer group index (read only by the kOuter kernel).
struct Strides {
  long long b, h, n, z;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// Copies rows [0, n) of one head of a strided operand into a padded
// [n][65] shared tile, optionally times a scale.
__device__ __forceinline__ void load_padded(float* dst, const float* src, long long row_stride,
                                            int n, float mul) {
  for (int e = threadIdx.x; e < n * (kHeadDim / 4); e += blockDim.x) {
    const int j = e / (kHeadDim / 4), c4 = (e % (kHeadDim / 4)) * 4;
    const float4 s = *reinterpret_cast<const float4*>(src + j * row_stride + c4);
    float* d = dst + j * kPadDim + c4;
    d[0] = s.x * mul;
    d[1] = s.y * mul;
    d[2] = s.z * mul;
    d[3] = s.w * mul;
  }
}

// Shared memory of grand_attn_kernel, in bytes, laid out so that every
// 16-byte access is aligned: Q [warps][4][64] and P [warps][n32][4], then V
// [n][64] and K [n][65] (the pad column keeps lane j's reads of row j in
// distinct banks).
__host__ __device__ inline size_t attn_smem_bytes(int n, int warps) {
  return ((size_t)warps * kQueriesPerWarp * kHeadDim + (size_t)warps * round32(n) * kQueriesPerWarp +
          (size_t)n * kHeadDim + (size_t)n * kPadDim) *
         sizeof(float);
}

template <bool kOuter>
__global__ void grand_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, float* __restrict__ out,
                                  Strides sq, Strides sk, Strides sv, Strides so,
                                  int n_keys, int n_queries, float scale) {
  constexpr int kKs = kPadDim;
  extern __shared__ __align__(16) unsigned char grand_attn_smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = n_keys, n32 = round32(n);
  float* Qs = reinterpret_cast<float*>(grand_attn_smem);
  float* Ps = Qs + warps * kQueriesPerWarp * kHeadDim;
  float* Vs = Ps + warps * n32 * kQueriesPerWarp;
  float* Ks = Vs + n * kHeadDim;

  const float* qbase = q + b * sq.b + h * sq.h;
  const float* kbase = k + b * sk.b + h * sk.h;
  const float* vbase = v + b * sv.b + h * sv.h;
  float* obase = out + b * so.b + h * so.h;
  if constexpr (kOuter) {
    const long long z = blockIdx.z;
    qbase += z * sq.z;
    kbase += z * sk.z;
    vbase += z * sv.z;
    obase += z * so.z;
  }

  // K and V in one loop: two loads in flight per thread and iteration.
  for (int e = threadIdx.x; e < n * (kHeadDim / 4); e += blockDim.x) {
    const int j = e / (kHeadDim / 4), c4 = (e % (kHeadDim / 4)) * 4;
    const float4 kv = *reinterpret_cast<const float4*>(kbase + j * sk.n + c4);
    const float4 vv = *reinterpret_cast<const float4*>(vbase + j * sv.n + c4);
    float* kd = Ks + j * kKs + c4;
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
    *reinterpret_cast<float4*>(Vs + j * kHeadDim + c4) = vv;
  }
  __syncthreads();

  float* Qw = Qs + warp * kQueriesPerWarp * kHeadDim;
  float* Pw = Ps + warp * n32 * kQueriesPerWarp;
  for (int i0 = warp * kQueriesPerWarp; i0 < n_queries; i0 += warps * kQueriesPerWarp) {
    for (int e = lane; e < kQueriesPerWarp * kHeadDim; e += 32) {
      const int i = i0 + e / kHeadDim;
      Qw[e] = i < n_queries ? qbase[i * sq.n + e % kHeadDim] * scale : 0.f;
    }
    __syncwarp();

    float s[kQueriesPerWarp][kKeysPerLane];
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk) {
#pragma unroll
      for (int qq = 0; qq < kQueriesPerWarp; ++qq) s[qq][kk] = -INFINITY;
      const int j = kk * 32 + lane;
      if (kk * 32 < n && j < n) {
        float dot[kQueriesPerWarp] = {};
        const float* kr = Ks + j * kKs;
#pragma unroll 4
        for (int d = 0; d < kHeadDim; d += 4) {
          const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
          for (int qq = 0; qq < kQueriesPerWarp; ++qq) {
            const float4 qv = *reinterpret_cast<const float4*>(Qw + qq * kHeadDim + d);
            dot[qq] = fmaf(qv.x, k0, dot[qq]);
            dot[qq] = fmaf(qv.y, k1, dot[qq]);
            dot[qq] = fmaf(qv.z, k2, dot[qq]);
            dot[qq] = fmaf(qv.w, k3, dot[qq]);
          }
        }
#pragma unroll
        for (int qq = 0; qq < kQueriesPerWarp; ++qq) s[qq][kk] = dot[qq];
      }
    }

    float inv_sum[kQueriesPerWarp];
#pragma unroll
    for (int qq = 0; qq < kQueriesPerWarp; ++qq) {
      float m = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) m = fmaxf(m, s[qq][kk]);
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const float e = kk * 32 + lane < n ? expf(s[qq][kk] - m) : 0.f;
        s[qq][kk] = e;
        sum += e;
      }
      inv_sum[qq] = 1.0f / warp_sum(sum);
    }
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk) {
      if (kk * 32 < n) {
        *reinterpret_cast<float4*>(Pw + (kk * 32 + lane) * kQueriesPerWarp) =
            make_float4(s[0][kk], s[1][kk], s[2][kk], s[3][kk]);
      }
    }
    __syncwarp();

    // The lane holds columns lane and 32 + lane.
    float o[kQueriesPerWarp][2] = {};
    for (int j = 0; j < n; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pw + j * kQueriesPerWarp);
      const float v0 = Vs[j * kHeadDim + lane], v1 = Vs[j * kHeadDim + 32 + lane];
      o[0][0] = fmaf(p.x, v0, o[0][0]);
      o[0][1] = fmaf(p.x, v1, o[0][1]);
      o[1][0] = fmaf(p.y, v0, o[1][0]);
      o[1][1] = fmaf(p.y, v1, o[1][1]);
      o[2][0] = fmaf(p.z, v0, o[2][0]);
      o[2][1] = fmaf(p.z, v1, o[2][1]);
      o[3][0] = fmaf(p.w, v0, o[3][0]);
      o[3][1] = fmaf(p.w, v1, o[3][1]);
    }
#pragma unroll
    for (int qq = 0; qq < kQueriesPerWarp; ++qq) {
      const int i = i0 + qq;
      if (i >= n_queries) break;
      const float* vi = vbase + i * sv.n;
      float* oi = obase + i * so.n;
      oi[lane] = o[qq][0] * inv_sum[qq] - vi[lane];
      oi[32 + lane] = o[qq][1] * inv_sum[qq] - vi[32 + lane];
    }
    __syncwarp();
  }
}

// Launches grand_attn_kernel<kOuter> on a grid of (B, H, outer) blocks.
template <bool kOuter = false>
inline cudaError_t launch_grand_attn(const float* q, const float* k, const float* v, float* out,
                                     Strides sq,
                                     Strides sk, Strides sv, Strides so, int B, int H,
                                     int n_keys, int n_queries, float scale, cudaStream_t stream,
                                     int outer = 1) {
  int warps = (n_queries + kQueriesPerWarp - 1) / kQueriesPerWarp;
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const size_t bytes = attn_smem_bytes(n_keys, warps);
  cudaError_t err = cudaFuncSetAttribute(grand_attn_kernel<kOuter>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  grand_attn_kernel<kOuter><<<dim3(B, H, outer), 32 * warps, bytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, n_keys, n_queries, scale);
  return cudaGetLastError();
}

}  // namespace grand
