// GRAND attention forward at float32 under a contraction mode, on the
// tensor cores, for Hopper (sm_90a): the attention step of B1, B2 and B5
// at f32 under "default" and "high3" (fused_block.cu), and B3 and B6 at f32
// under the session matmul precision "default" (grand_attention.cu), at
// every group size and every head width of takes_head_dim (grand_attn.cuh,
// "Head widths": compiled for 64 and 128, columns past d zero-filled).
//
//   out[i] = Σ_j e_ij v_j · (1 / Σ_j e_ij) − v_i,  e_ij = exp(s_ij − max_j s_ij),
//   s_ij = q_i·k_j · scale
//
// Stands for the f32 branch of the TPU device function
// diff3dhpe_tpu/ops/attention.py::grand_attend_tile (:51-98) contracting
// through diff3dhpe_tpu/ops/fused_block.py::_dot_f32 / _dot_f32_3pass
// (:127-164), or through the MXU's one bf16 pass where the session
// precision is "default" (ops/attention.py:103-117). Every product is of
// bf16 values summed in f32, which is what the tensor cores compute:
// - kDefault: q, k, then e and v rounded to bf16 (nearest even), one pass;
// - kHigh3: each operand split as a = a_hi + a_lo (a_hi = bf16(a), a_lo =
//   bf16(a − a_hi)) and summed as a_hi·b_hi + (a_hi·b_lo + a_lo·b_hi).
// The normalisation comes after P·V, as in JAX's f32 epilogue; the row sum
// l and the trailing − v read the unrounded values, and e is taken relative
// to the row's maximum. The plain version is ops/fused_block.py::
// block_attention_ref (ops/attention.py::grand_attention_stored with the
// mode's contraction).
//
// What bounds it on an H100: at the temporal eval shape (544 (group, head)
// pairs of n = 243, d = 64) q, k, v are read and the output written once in
// f32, 135 MB: 0.040 ms at 3.35 TB/s, against 8.2 GFLOP of bf16 products a
// pass (0.008 ms at 989 TFLOP/s; three passes at "high3"). So it is bound by
// bytes, and the 32 M exponentials, the splits and the shared-memory
// traffic of the fragments cost more than the products.
//
// Design (from the bf16 kernel K1, grand_attn_bf16.cuh):
// - A block takes 16·W queries of one (group, head) pair, W warps of 16
//   query rows each (W = 4 at d = 64, 8 at d = 128, fewer for short
//   groups); the grid is (B · query blocks, H[, outer]).
// - Operands are read once as f32 strided views (the packed qkv [R, 3C],
//   B2's (b, j) groups through the outer stride) and rounded or split ONCE,
//   as they land, into bf16 planes in shared memory whose rows are padded by
//   16 bytes for ldmatrix: Q [16·W][D + 8] (hi, lo), then K [n16][D + 8]
//   (hi, lo), whose planes V takes over once S is formed (n16: the keys
//   rounded up to 16; rows past n are zeros).
// - S = Q·Kᵀ by mma.sync m16n8k16 (bf16 in, f32 accumulate). A warp keeps
//   its 16 rows' whole score row in registers (KT16 = 16: n <= 256, 128
//   floats a thread), so the row's exact maximum is known with one pass
//   over the keys. "default": one pass, the head dimension outer (K1's
//   tc_scores). "high3": key chunk outer, each 16-key chunk of S summed as
//   hi·hi in one accumulator and the two cross terms in a second, added
//   once at the end: the tensor cores drop the bits below an f32
//   accumulator's last place at each k-step, and the cross terms, 2^-8 of
//   hi·hi, lose none of theirs there.
// - e = expf(s·scale − m) in f32 and l = Σ e over the unrounded e; then e is
//   rounded ("default") or split ("high3") into the A fragments of P·V in
//   registers: the C layout of S is the A layout of P·V.
// - O = e·V by mma.sync with V's planes loaded by ldmatrix.trans, one pass or
//   three; at "high3" in 64-column slabs, hi·hi and the cross terms again in
//   two accumulators, so the e fragments (128 registers at n = 256) and the
//   slab's accumulators (64) fit the 255 registers a thread.
// - out = O · (1/l) − v, v read unrounded from device memory; with stats
//   (no outer index) each row's scaled maximum m and 1/l go to the two
//   [B·H, n64] planes B4 reads. Pad query rows (n_queries > n_keys) attend
//   to the real keys and subtract their own v; rows past n_queries are not
//   stored.
// Shared memory and occupancy (n = 256): "default" 46 KB at d = 64 (2 blocks
// of 4 warps an SM, 255 registers), 104 KB at d = 128 (1 block of 8 warps);
// "high3" 92 KB at d = 64 (2 blocks of 4 warps), 204 KB at d = 128 (1 block
// of 8 warps). Groups of at most 32 keys (the spatial blocks' 17 joints)
// take an instance whose register arrays hold 32 keys (KT16 = 2), a block
// of one or two warps a pair: on an H100 it runs them faster than the
// small-group kernel's instances under the modes did, which it replaced
// (PERF.md §6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "grand_attn.cuh"
#include "grand_attn_bf16.cuh"

namespace grand {

// Warps a block (16 query rows each) and blocks an SM, by head width.
template <int D>
struct ModeConfig {
  static constexpr int kWarps = D == 128 ? 8 : 4;
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
};

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

// hi = bf16(x, y) packed, lo = bf16(x − hi.x, y − hi.y) packed.
__device__ __forceinline__ void split_pack(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// Rows [row0, row0 + rows) of one head of a strided f32 operand into bf16
// planes [rows][D + 8]: hi = bf16(x) and, under kHigh3, lo = bf16(x − hi);
// rows at or past n_valid and columns at or past d (the head's width) are
// zeros. Every thread of the block takes part, with four 16-byte loads in
// flight before it converts them.
template <int D, int kMode>
__device__ __forceinline__ void split_rows(__nv_bfloat16* hi, __nv_bfloat16* lo, const float* src,
                                           long long row_stride, int row0, int rows,
                                           int n_valid, int d) {
  constexpr int kC4 = D / 4, kLd = tc_ld<D>();
  const int total = rows * kC4, step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * step) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * step, r = e / kC4, c = (e % kC4) * 4;
      x[u] = e < total && row0 + r < n_valid && c < d
                 ? ld4(src + (long long)(row0 + r) * row_stride + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * step, r = e / kC4, c = (e % kC4) * 4;
      if (e < total) {
        uint2 h, l;
        split_pack(x[u].x, x[u].y, h.x, l.x);
        split_pack(x[u].z, x[u].w, h.y, l.y);
        *reinterpret_cast<uint2*>(hi + r * kLd + c) = h;
        if constexpr (kMode == kHigh3) *reinterpret_cast<uint2*>(lo + r * kLd + c) = l;
      }
    }
  }
}

// "high3" scores of the warp's 16 rows (A: Ah, Al, rows of [.][D + 8]
// planes) against the first 16·KT16 rows of B (Bh, Bl): for each 16-key
// chunk, hi·hi in one accumulator and hi·lo + lo·hi in a second over the
// whole head dimension, then their sum. Fragments as tc_scores's; chunks at
// or past n_rows are left 0.
template <int D, int KT16>
__device__ __forceinline__ void mode_scores3(float (&s)[2 * KT16][4], const __nv_bfloat16* Ah,
                                             const __nv_bfloat16* Al, const __nv_bfloat16* Bh,
                                             const __nv_bfloat16* Bl, int n_rows, int lane) {
  constexpr int kLd = tc_ld<D>();
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < KT16; ++kc) {
    float c1[2][4], c2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
    if (kc * 16 < n_rows) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        unsigned ah[4], al[4], bh[4], bl[4];
        mma::ldmatrix_x4(ah, Ah + a_off + kd * 16);
        mma::ldmatrix_x4(al, Al + a_off + kd * 16);
        mma::ldmatrix_x4(bh, Bh + kc * 16 * kLd + b_off + kd * 16);
        mma::ldmatrix_x4(bl, Bl + kc * 16 * kLd + b_off + kd * 16);
        mma::mma_bf16(c1[0], ah, bh);
        mma::mma_bf16(c1[1], ah, bh + 2);
        mma::mma_bf16(c2[0], ah, bl);
        mma::mma_bf16(c2[1], ah, bl + 2);
        mma::mma_bf16(c2[0], al, bh);
        mma::mma_bf16(c2[1], al, bh + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * kc + j][e] = c1[j][e] + c2[j][e];
  }
}

// acc += A·B over kCols columns for a 16 x 16 A fragment and the 16 rows of
// B at Bc (a [row][kLd] plane, at the slab's first column), B through
// ldmatrix.trans as tc_acc_chunk's.
template <int kLd, int kCols>
__device__ __forceinline__ void mode_acc_cols(float (&acc)[kCols / 8][4], const unsigned (&a)[4],
                                              const __nv_bfloat16* Bc, int lane) {
#pragma unroll
  for (int jd = 0; jd < kCols / 8; jd += 2) {
    unsigned r[4];
    mma::ldmatrix_x4_trans(r, Bc + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                  (jd + (lane >> 4)) * 8);
    mma::mma_bf16(acc[jd], a, r);
    mma::mma_bf16(acc[jd + 1], a, r + 2);
  }
}

// Rows g and g + 8 (lane (g, t)) of the warp's output over kCols columns
// from col0: out = acc · inv − v, v read unrounded; rows at or past
// n_queries and columns at or past d are not stored.
template <int kCols>
__device__ __forceinline__ void mode_store(float* obase, long long o_row, const float* vbase,
                                           long long v_row, const float (&acc)[kCols / 8][4],
                                           int i0, int col0, float inv0, float inv1,
                                           int n_queries, int d, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + g + 8 * half;
    if (i >= n_queries) continue;
    const float inv = half ? inv1 : inv0;
#pragma unroll
    for (int jd = 0; jd < kCols / 8; ++jd) {
      const int col = col0 + jd * 8 + 2 * t;
      if (col >= d) continue;
      const float2 vv = *reinterpret_cast<const float2*>(vbase + i * v_row + col);
      *reinterpret_cast<float2*>(obase + i * o_row + col) =
          make_float2(acc[jd][2 * half] * inv - vv.x, acc[jd][2 * half + 1] * inv - vv.y);
    }
  }
}

// out = softmax(q kᵀ·scale) v − v at f32 under kMode (kDefault or kHigh3)
// for query rows [q0, q0 + 16·warps) of one (group, head) pair: block x
// takes pair b = x / q_blocks, h = blockIdx.y[, outer z = blockIdx.z]. With
// stats, each real row's m and 1/l go to the planes of stat_rows rows a
// pair (see the notes above).
template <int D, int KT16, bool kOuter, int kMode>
__global__ void __launch_bounds__(32 * ModeConfig<D>::kWarps, ModeConfig<D>::kMinBlocks)
grand_attn_mode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, Strides sq,
                       Strides sk, Strides sv, Strides so, int n_keys, int n_queries,
                       int q_blocks, float scale, float* __restrict__ stats, int stat_rows,
                       int d) {
  using bf16 = __nv_bfloat16;
  static_assert(kMode == kDefault || kMode == kHigh3, "the exact f32 kernel is the tiled one");
  constexpr int kLd = tc_ld<D>();
  constexpr int kPlanes = kMode == kHigh3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char grand_attn_mode_smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_rows = 16 * warps, n16 = (n_keys + 15) & ~15;
  bf16* Qh = reinterpret_cast<bf16*>(grand_attn_mode_smem);
  bf16* Ql = Qh + q_rows * kLd;               // "high3" only
  bf16* Xh = Qh + kPlanes * q_rows * kLd;     // K, then V
  bf16* Xl = Xh + n16 * kLd;                  // "high3" only
  const int b = blockIdx.x / q_blocks, q0 = (blockIdx.x % q_blocks) * q_rows, h = blockIdx.y;

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

  split_rows<D, kMode>(Qh, Ql, qbase, sq.n, q0, q_rows, n_queries, d);
  split_rows<D, kMode>(Xh, Xl, kbase, sk.n, 0, n16, n_keys, d);
  __syncthreads();

  const int i0 = q0 + 16 * warp;  // this warp's first query row
  const bool active = i0 < n_queries;
  float s[2 * KT16][4];
  if (active) {
    if constexpr (kMode == kHigh3) {
      mode_scores3<D, KT16>(s, Qh + 16 * warp * kLd, Ql + 16 * warp * kLd, Xh, Xl, n_keys, lane);
    } else {
      tc_scores<D, KT16>(s, Qh + 16 * warp * kLd, Xh, n_keys, lane);
    }
  }
  __syncthreads();  // every warp is done with K: V takes its planes
  split_rows<D, kMode>(Xh, Xl, vbase, sv.n, 0, n16, n_keys, d);
  __syncthreads();  // V has landed
  if (!active) return;

  // e = exp(s·scale − m) over the real keys (pad keys −inf, so 0), and the
  // rows' sums of the unrounded e.
  const int g = lane >> 2, t = lane & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 8 * j + 2 * t + (e & 1) < n_keys ? s[j][e] * scale : -INFINITY;
    }
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  if (stats != nullptr && t == 0) {  // m and 1/l for B4, real rows only
    const size_t plane = (size_t)(gridDim.x / q_blocks) * gridDim.y * stat_rows;
    float* st = stats + ((size_t)b * gridDim.y + h) * stat_rows;
    if (i0 + g < n_queries) st[i0 + g] = m0, st[plane + i0 + g] = inv0;
    if (i0 + g + 8 < n_queries) st[i0 + g + 8] = m1, st[plane + i0 + g + 8] = inv1;
  }

  // e as the A fragments of P·V, 16 keys each: the C fragments of n8 tiles
  // 2kc and 2kc + 1 rounded (or split) to packed bf16 pairs.
  unsigned ph[KT16][4], pl[KT16][4];
#pragma unroll
  for (int kc = 0; kc < KT16; ++kc) {
    split_pack(s[2 * kc][0], s[2 * kc][1], ph[kc][0], pl[kc][0]);
    split_pack(s[2 * kc][2], s[2 * kc][3], ph[kc][1], pl[kc][1]);
    split_pack(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[kc][2], pl[kc][2]);
    split_pack(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[kc][3], pl[kc][3]);
  }

  if constexpr (kMode == kDefault) {
    float o[D / 8][4];
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KT16; ++kc) {
      if (kc * 16 < n_keys) mode_acc_cols<kLd, D>(o, ph[kc], Xh + kc * 16 * kLd, lane);
    }
    mode_store<D>(obase, so.n, vbase, sv.n, o, i0, 0, inv0, inv1, n_queries, d, lane);
  } else {
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 64) {  // 64-column slabs
      float o1[8][4], o2[8][4];
#pragma unroll
      for (int jd = 0; jd < 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o1[jd][e] = o2[jd][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KT16; ++kc) {
        if (kc * 16 < n_keys) {
          const int off = kc * 16 * kLd + c0;
          mode_acc_cols<kLd, 64>(o1, ph[kc], Xh + off, lane);
          mode_acc_cols<kLd, 64>(o2, ph[kc], Xl + off, lane);
          mode_acc_cols<kLd, 64>(o2, pl[kc], Xh + off, lane);
        }
      }
#pragma unroll
      for (int jd = 0; jd < 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o1[jd][e] += o2[jd][e];
      mode_store<64>(obase, so.n, vbase, sv.n, o1, i0, c0, inv0, inv1, n_queries, d, lane);
    }
  }
}

template <int D, int KT16, bool kOuter, int kMode>
inline cudaError_t launch_mode_keys(const float* q, const float* k, const float* v, float* out,
                                    Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                                    int n_keys, int n_queries, int d, float scale,
                                    cudaStream_t stream, int outer, float* stats) {
  constexpr int kPlanes = kMode == kHigh3 ? 2 : 1;
  const int q_tiles = (n_queries + 15) / 16;
  const int warps = q_tiles < ModeConfig<D>::kWarps ? q_tiles : ModeConfig<D>::kWarps;
  const int q_blocks = (q_tiles + warps - 1) / warps;
  const int n16 = (n_keys + 15) & ~15;
  const size_t bytes = (size_t)kPlanes * (16 * warps + n16) * tc_ld<D>() * sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(grand_attn_mode_kernel<D, KT16, kOuter, kMode>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
  if (err != cudaSuccess) return err;
  grand_attn_mode_kernel<D, KT16, kOuter, kMode>
      <<<dim3(B * q_blocks, H, outer), 32 * warps, bytes, stream>>>(
          q, k, v, out, sq, sk, sv, so, n_keys, n_queries, q_blocks, scale, stats,
          (n_queries + 63) / 64 * 64, d);
  return cudaGetLastError();
}

// The tensor-core kernel above on (B, H[, outer]) groups of n_keys <= kMaxN
// keys and n_queries >= n_keys query rows at head width d (takes_head_dim,
// on the instance_head_dim instance),
// under kMode (kDefault or kHigh3); strides, alignment and stats as
// launch_grand_attn's. The register arrays hold 32 keys (n_keys <= 32) or
// 256.
template <bool kOuter, int kMode>
inline cudaError_t launch_mode(const float* q, const float* k, const float* v, float* out,
                               Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                               int n_keys, int n_queries, int d, float scale, cudaStream_t stream,
                               int outer = 1, float* stats = nullptr) {
  if (n_keys <= 0 || n_keys > kMaxN || n_queries < n_keys || !takes_head_dim(d) ||
      (stats != nullptr && kOuter) || (kMode != kDefault && kMode != kHigh3)) {
    return cudaErrorInvalidValue;
  }
#define MODE_ARGS \
  q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, d, scale, stream, outer, stats
  const bool d64 = instance_head_dim(d) == 64;
  if (n_keys <= kSmallKeys) {
    return d64 ? launch_mode_keys<64, 2, kOuter, kMode>(MODE_ARGS)
               : launch_mode_keys<128, 2, kOuter, kMode>(MODE_ARGS);
  }
  return d64 ? launch_mode_keys<64, kMaxN / 16, kOuter, kMode>(MODE_ARGS)
             : launch_mode_keys<128, kMaxN / 16, kOuter, kMode>(MODE_ARGS);
#undef MODE_ARGS
}

// Launches the f32 attention on (B, H[, outer]) groups of n_keys keys and
// n_queries >= n_keys query rows at head width d (takes_head_dim: a
// multiple of 8 up to 128, on the instance_head_dim instance), n_keys <=
// kMaxN: in exact f32 the small-group kernel for n_keys <= 32 (and at most
// 64 query rows), else the tiled kernel; under a contraction mode (kMode,
// F32Mode) the tensor-core kernel above. Every stride a multiple of 4
// floats and every base 16-byte aligned (checked by the callers). With
// stats (no outer index; in exact f32 the tiled kernel only) it also writes
// each row's max m and 1/l into the two [B·H, n64] planes of B4's
// statistics.
template <bool kOuter = false, int kMode = kHighest>
inline cudaError_t launch_grand_attn(const float* q, const float* k, const float* v, float* out,
                                     Strides sq, Strides sk, Strides sv, Strides so, int B,
                                     int H, int n_keys, int n_queries, int d, float scale,
                                     cudaStream_t stream, int outer = 1, float* stats = nullptr) {
  if constexpr (kMode != kHighest) {
    return launch_mode<kOuter, kMode>(q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, d,
                                      scale, stream, outer, stats);
  }
  if (n_keys <= 0 || n_keys > kMaxN || n_queries < n_keys || !takes_head_dim(d) ||
      (stats != nullptr && (kOuter || n_keys <= kSmallKeys))) {
    return cudaErrorInvalidValue;
  }
  if (n_keys <= kSmallKeys && n_queries <= kSmallMaxN) {
    return launch_small(q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, d, scale, stream,
                        outer);
  }
#define GRAND_F32_ARGS \
  q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, d, scale, stream, outer, stats
  return instance_head_dim(d) == 64 ? launch_tiled<64, kOuter>(GRAND_F32_ARGS)
                                    : launch_tiled<128, kOuter>(GRAND_F32_ARGS);
#undef GRAND_F32_ARGS
}

}  // namespace grand
