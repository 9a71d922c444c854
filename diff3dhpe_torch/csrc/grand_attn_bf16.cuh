// bf16 GRAND attention forward on the tensor cores, for Hopper (sm_90a):
// the attention step of B1, B2 and B5 at bf16 (fused_block.cu) and B3 at
// bf16 (grand_attention.cu), compiled for head width 64 and 128; a width d
// (a multiple of 8 up to 128) runs on the next instance with its columns
// past d zero-filled in shared memory and its stores masked to d
// (grand_attn.cuh, "Head widths").
//
//   out[i] = bf16( Σ_j bf16(softmax_j(q_i·k_j·scale)) v_j − v_i )
//
// Stands for the bf16 branch of the TPU device function
// diff3dhpe_tpu/ops/attention.py::grand_attend_tile, and keeps its rounding
// points: S = q·kᵀ summed in f32 and scaled in f32, the row's softmax
// normalised in f32 FIRST, then P rounded to bf16, P·v summed in f32, and
// one rounding of P·v − v. The normalisation multiplies exp(S − max) by the
// row's reciprocal 1 / Σ (one IEEE division a row): at most one f32 ulp
// from the quotient, before a rounding that keeps 8 bits. A division an
// element cost a third of the kernel's time (0.138 against 0.093 ms at
// the eval shape, H100 at 700 W).
//
// What bounds it on an H100: at the eval shape (544 (group, head) pairs of
// n = 243, d = 64) the two products are 8.2 GFLOP and q, k, v and the
// output 67 MB: ~0.02 ms either way. The 32 M exact exponentials of the
// softmax and the K/V loads cost more than the products, so the design
// spends tensor-core work freely and keeps everything else in registers.
// At d = 128 (272 pairs) the products and bytes are the same and the
// exponentials half as many.
//
// Design:
// - Both products are mma.sync m16n8k16 (bf16 in, f32 out). A warp owns 16
//   query rows and keeps their WHOLE score block in registers (n <= 256:
//   at most 32 n8 tiles x 4 floats = 128 registers a thread), so the row
//   sum is known before P is rounded, with one pass over the keys. The
//   other choice, two passes that recompute S, costs a third more
//   tensor-core work and every exponential twice; an online softmax would
//   round unnormalised exponentials, another rounding than the TPU
//   kernel's. The kernel is compiled for 32, 64, 128 and 256 padded keys
//   (the register arrays need constant bounds); the launcher picks by n.
// - Q·Kᵀ runs the head dimension in the outer loop: one 16-column A
//   fragment of Q (4 registers) is live at a time, whatever D is. Each
//   score tile still sums over d in order, so both loop orders give the
//   same bits.
// - The C fragment of S has the register layout of the A fragment of P·V,
//   so P goes from the softmax into the second product in registers,
//   rounded to packed bf16 pairs on the way: after the rounding the f32
//   scores are dead, and P·V's accumulators (D / 2 registers: 64 at
//   d = 128) take their place. V is that product's B operand with the keys
//   along k: ldmatrix.trans from the [key][D] tile.
// - q, k and v stay strided views (a head's row is 2·D contiguous bytes):
//   D / 8 16-byte cp.async a row into shared tiles whose rows are padded by
//   16 bytes (144 or 272), so the 8 rows of an ldmatrix fall in distinct
//   banks. Rows past n are zero-filled (0 x garbage cannot make a NaN), pad
//   keys get −inf before the max, pad query rows are computed and not
//   stored. V is its own cp.async group and lands while S and the softmax
//   are computed.
// - Parallelism: a team of warps takes one (group, head), each warp 16 of
//   its queries, and loads the pair's whole K and V once for the team.
//   d = 64: 4 warps a block above 32 keys, 2 blocks an SM at up to 255
//   registers (K and V 2 x 36 KB). d = 128: K and V are 2 x 68 KB at 256
//   keys, so a block of 8 warps (128 queries) shares them, one block an SM
//   (174 KB of shared memory, 255 registers). At n <= 32 a pair has one or
//   two m16 tiles, so a block of 8 warps takes up to 8 pairs (4 at n = 17),
//   each team with its own tiles, 2 blocks an SM at either width. The
//   output tile is staged through the warp's Q rows in shared memory and
//   stored as 16-byte rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "grand_attn.cuh"

// bf16 tensor-core building blocks: 16-byte asynchronous copies into shared
// memory, ldmatrix fragment loads, and mma.sync m16n8k16 with f32
// accumulators.
namespace mma {

using bf16 = __nv_bfloat16;

// 16-byte asynchronous copies into shared memory (grand_attn.cuh).
using grand::cp_async16;
using grand::cp_async_commit;
using grand::cp_async_wait;

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i: lane l holds
// elements (l / 4, 2·(l % 4)) and (l / 4, 2·(l % 4) + 1) of each.
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same with each matrix transposed on the way: lane l holds elements
// (2·(l % 4), l / 4) and (2·(l % 4) + 1, l / 4) of each stored matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// Two floats rounded to bf16 (nearest even), x in the low half.
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace mma

namespace grand {

// bf16 per shared row of a head of width D: 16 bytes of padding.
template <int D>
__host__ __device__ constexpr int tc_ld() {
  return D + 8;
}

// Bytes of shared memory one (group, head) pair holds in a block: K and V
// [16·KT16][D + 8] and Q [16·qtb][D + 8].
template <int D>
__host__ __device__ constexpr size_t tc_slot_bytes(int kt16, int qtb) {
  return (size_t)(2 * 16 * kt16 + 16 * qtb) * tc_ld<D>() * sizeof(__nv_bfloat16);
}

// Warps a block, blocks an SM, and the shared memory a block may take, by
// head width and padded keys (see the design notes above).
template <int D, int KT16>
struct TcConfig {
  static constexpr bool kWide = D == 128 && KT16 > 2;  // one block an SM
  static constexpr int kWarps = KT16 <= 2 || kWide ? 8 : 4;
  static constexpr int kMinBlocks = kWide ? 1 : 2;
  static constexpr size_t kSmemBudget = kWide ? 220 * 1024 : 110 * 1024;
};

// Rows [row0, row0 + rows) of one head of a strided operand into a
// [rows][D + 8] shared tile by the `threads` threads of a team; rows at or
// past n_valid and columns at or past d (the head's width, a multiple of
// 8) are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int rows, int n_valid,
                                           int tid, int threads, int d = D) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  for (int e = tid; e < rows * kChunks; e += threads) {
    const int r = e / kChunks, c = (e % kChunks) * 8, i = row0 + r;
    const bool ok = i < n_valid && c < d;
    mma::cp_async16(dst + r * tc_ld<D>() + c, src + (ok ? i * row_stride + c : 0), ok);
  }
}

// The tensor-core steps of one warp, shared by the forward here and the
// backward of grand_attn_bwd_bf16.cuh. Fragments are mma.sync's: in a C
// fragment c[j][e] lane (g, t) = (lane / 4, lane % 4) holds row g (e < 2)
// or g + 8 and column 8·j + 2·t + (e & 1); the C fragments of two n8 tiles
// are, rounded to packed bf16 pairs, the A fragment of a 16-deep product.

// s = A·Bᵀ for the warp's 16 rows of A (Aw, rows of a [.][D + 8] tile)
// against the first 16·KT16 rows of B, 16 columns of d at a time: A as an A
// fragment (rows by bit 3 of the lane, d by bit 4), B as B fragments (d by
// bit 3, rows by bit 4). 16-row chunks of B at or past n_rows are skipped
// (left 0). Each element sums over d in order, as tc_chunk_product's do.
template <int D, int KT16>
__device__ __forceinline__ void tc_scores(float (&s)[2 * KT16][4], const __nv_bfloat16* Aw,
                                          const __nv_bfloat16* Bs, int n_rows, int lane) {
  constexpr int kLd = tc_ld<D>();
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    unsigned af[4];
    mma::ldmatrix_x4(af, Aw + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + kd * 16 +
                             (lane >> 4) * 8);
#pragma unroll
    for (int kc = 0; kc < KT16; ++kc) {
      if (kc * 16 < n_rows) {
        unsigned r[4];
        mma::ldmatrix_x4(r, Bs + (kc * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kd * 16 +
                                ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * kc], af, r);
        mma::mma_bf16(s[2 * kc + 1], af, r + 2);
      }
    }
  }
}

// c = A·Bᵀ for the warp's 16 rows of A (Aw) against the 16 rows of B at Bc:
// one 16-row chunk of tc_scores, with the same sums.
template <int D>
__device__ __forceinline__ void tc_chunk_product(float (&c)[2][4], const __nv_bfloat16* Aw,
                                                 const __nv_bfloat16* Bc, int lane) {
  constexpr int kLd = tc_ld<D>();
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    unsigned af[4], r[4];
    mma::ldmatrix_x4(af, Aw + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + kd * 16 +
                             (lane >> 4) * 8);
    mma::ldmatrix_x4(r, Bc + ((lane & 7) + (lane >> 4) * 8) * kLd + kd * 16 +
                            ((lane >> 3) & 1) * 8);
    mma::mma_bf16(c[0], af, r);
    mma::mma_bf16(c[1], af, r + 2);
  }
}

// Row softmax numerators in place: columns at or past n_cols get −inf, then
// s = exp(s·scale − max·scale) with the scale folded into one fma (for
// scale = d^-½ a power of two (d = 64) this is the scaled logit minus its
// max, exactly). nm0, nm1: −max·scale of rows g and g + 8; sum0, sum1 their
// sums over the row's four lanes.
template <int KT16>
__device__ __forceinline__ void tc_exp_rows(float (&s)[2 * KT16][4], int n_cols, float scale,
                                            float& nm0, float& nm1, float& sum0, float& sum1) {
  const int t = threadIdx.x & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j) {
    if (8 * j + 8 > n_cols) {  // only the tiles that reach past n_cols are tested
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * j + 2 * t + (e & 1) >= n_cols) s[j][e] = -INFINITY;
      }
    }
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  nm0 = m0 * -scale;
  nm1 = m1 * -scale;
  sum0 = sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j) {
    s[j][0] = expf(fmaf(s[j][0], scale, nm0));
    s[j][1] = expf(fmaf(s[j][1], scale, nm0));
    s[j][2] = expf(fmaf(s[j][2], scale, nm1));
    s[j][3] = expf(fmaf(s[j][3], scale, nm1));
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
}

// acc += A·B for a 16 x 16 A fragment and the 16 rows of B at Bc ([row][D],
// the rows along the product's depth): B as B fragments through
// ldmatrix.trans (rows by bit 3 of the lane, the d tile by bit 4).
template <int D>
__device__ __forceinline__ void tc_acc_chunk(float (&acc)[D / 8][4], const unsigned (&a)[4],
                                             const __nv_bfloat16* Bc, int lane) {
  constexpr int kLd = tc_ld<D>();
#pragma unroll
  for (int jd = 0; jd < D / 8; jd += 2) {
    unsigned r[4];
    mma::ldmatrix_x4_trans(r, Bc + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                  (jd + (lane >> 4)) * 8);
    mma::mma_bf16(acc[jd], a, r);
    mma::mma_bf16(acc[jd + 1], a, r + 2);
  }
}

// Rows i0 .. i0 + 15 of a warp's output, staged as bf16 in Os ([16][D + 8],
// written by the warp), to rows of dst below n_rows as 16-byte chunks, the
// columns below d (a multiple of 8).
template <int D>
__device__ __forceinline__ void tc_store_rows(__nv_bfloat16* dst, long long row_stride,
                                              const __nv_bfloat16* Os, int i0, int n_rows,
                                              int lane, int d = D) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int e = it * 32 + lane, r = e / kChunks, c = (e % kChunks) * 8;
    if (i0 + r < n_rows && c < d) {
      *reinterpret_cast<uint4*>(dst + (i0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(Os + r * tc_ld<D>() + c);
    }
  }
}

// What the forward hands B4 at bf16 (grand_attn_bwd_bf16.cuh): for each
// (group, head) pair and 64-row tile of queries, three planes of 64 floats,
// each row's −max·scale, 1/sum and (written by B4's dq pass) D.
constexpr int kBwdTileRows = 64;
constexpr int kBwdStatFloats = 3 * kBwdTileRows;

// Warps are grouped in teams of qtb: team s of block x takes pair
// x·teams + s (b = pair / H, h = pair % H) and warp w of the team its
// query rows (blockIdx.y·qtb + w)·16 ... + 15. Keys are padded to 16·KT16.
// With kStats (the trainable forward's instance; B1, B2, B5 and B3 at eval
// run the one without), stats holds pairs·nt·kBwdStatFloats floats (nt =
// 64-row tiles a pair) and receives each row's −max·scale and 1/sum.
template <int D, int KT16, bool kOuter, bool kStats = false>
__global__ void __launch_bounds__(32 * TcConfig<D, KT16>::kWarps, TcConfig<D, KT16>::kMinBlocks)
grand_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       Strides sq, Strides sk, Strides sv, Strides so, int pairs, int H,
                       int n_keys, int n_queries, int qtb, float scale, float* __restrict__ stats,
                       int nt, int d) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = tc_ld<D>();
  constexpr int kKeys = 16 * KT16, kTiles = 2 * KT16;  // padded keys; n8 tiles of S
  extern __shared__ __align__(16) unsigned char grand_attn_bf16_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / qtb, wq = warp % qtb, teams = (blockDim.x >> 5) / qtb;
  const int pair = blockIdx.x * teams + team;
  const bool live = pair < pairs;
  const int b = live ? pair / H : 0, h = live ? pair % H : 0;

  bf16* Ks = reinterpret_cast<bf16*>(grand_attn_bf16_smem + team * tc_slot_bytes<D>(KT16, qtb));
  bf16* Vs = Ks + kKeys * kLd;
  bf16* Qs = Vs + kKeys * kLd;

  const bf16* qbase = q + b * sq.b + h * sq.h;
  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  bf16* obase = out + b * so.b + h * so.h;
  if constexpr (kOuter) {
    const long long z = blockIdx.z;
    qbase += z * sq.z;
    kbase += z * sk.z;
    vbase += z * sv.z;
    obase += z * so.z;
  }

  // Q and K first, V as a second group that lands during the softmax.
  const int q0 = blockIdx.y * qtb * 16;  // first query row of the team
  const int tid = wq * 32 + lane, team_threads = qtb * 32;
  stage_rows<D>(Qs, qbase, sq.n, q0, qtb * 16, live ? n_queries : 0, tid, team_threads, d);
  stage_rows<D>(Ks, kbase, sk.n, 0, kKeys, live ? n_keys : 0, tid, team_threads, d);
  mma::cp_async_commit();
  stage_rows<D>(Vs, vbase, sv.n, 0, kKeys, live ? n_keys : 0, tid, team_threads, d);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();
  __syncthreads();

  const int i0 = q0 + wq * 16;  // this warp's first query row
  const bool active = live && i0 < n_queries;
  const int g = lane >> 2, t = lane & 3;
  unsigned p[KT16][4];  // P as the A fragments of P·V: 16 keys each
  if (active) {
    // S = Q·Kᵀ, then exp(S·scale − max·scale) and the rows' sums.
    float s[kTiles][4];
    tc_scores<D, KT16>(s, Qs + wq * 16 * kLd, Ks, n_keys, lane);
    float nm0, nm1, sum0, sum1;
    tc_exp_rows<KT16>(s, n_keys, scale, nm0, nm1, sum0, sum1);
    // Normalise, then round: the C fragments of tiles 2·kc and 2·kc + 1 are
    // the A fragment of key chunk kc.
    const float r0 = 1.0f / sum0, r1 = 1.0f / sum1;
    if constexpr (kStats) {
      if (t == 0) {
        float* st = stats + (size_t)pair * nt * kBwdStatFloats;
        const int ia = i0 + g, ib = ia + 8;
        if (ia < n_queries) {
          st[ia / kBwdTileRows * kBwdStatFloats + ia % kBwdTileRows] = nm0;
          st[ia / kBwdTileRows * kBwdStatFloats + kBwdTileRows + ia % kBwdTileRows] = r0;
        }
        if (ib < n_queries) {
          st[ib / kBwdTileRows * kBwdStatFloats + ib % kBwdTileRows] = nm1;
          st[ib / kBwdTileRows * kBwdStatFloats + kBwdTileRows + ib % kBwdTileRows] = r1;
        }
      }
    }
#pragma unroll
    for (int kc = 0; kc < KT16; ++kc) {
      p[kc][0] = mma::pack_bf16(s[2 * kc][0] * r0, s[2 * kc][1] * r0);
      p[kc][1] = mma::pack_bf16(s[2 * kc][2] * r1, s[2 * kc][3] * r1);
      p[kc][2] = mma::pack_bf16(s[2 * kc + 1][0] * r0, s[2 * kc + 1][1] * r0);
      p[kc][3] = mma::pack_bf16(s[2 * kc + 1][2] * r1, s[2 * kc + 1][3] * r1);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // V has landed
  if (!active) return;

  // O = P·V.
  float o[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KT16; ++kc) {
    if (kc * 16 < n_keys) tc_acc_chunk<D>(o, p[kc], Vs + kc * 16 * kLd, lane);
  }

  // out = bf16(O − v), staged in this warp's Q rows (no other warp reads
  // them) and stored as 16-byte chunks. v_i comes from the V tile; a pad
  // query row (n_keys <= i < n_queries) reads it from device memory, its
  // columns below d (the others are not stored).
  bf16* Os = Qs + wq * 16 * kLd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + half * 8, i = i0 + r;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = jd * 8 + 2 * t;
      float2 vv = make_float2(0.f, 0.f);
      if (i < n_keys) {
        vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Vs + i * kLd + col));
      } else if (i < n_queries && col < d) {
        vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vbase + i * sv.n + col));
      }
      *reinterpret_cast<__nv_bfloat162*>(Os + r * kLd + col) =
          __floats2bfloat162_rn(o[jd][2 * half] - vv.x, o[jd][2 * half + 1] - vv.y);
    }
  }
  tc_store_rows<D>(obase, so.n, Os, i0, n_queries, lane, d);
}

template <int D, int KT16, bool kOuter, bool kStats>
inline cudaError_t launch_grand_attn_bf16_keys(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                               const __nv_bfloat16* v, __nv_bfloat16* out,
                                               Strides sq, Strides sk, Strides sv, Strides so,
                                               int B, int H, int n_keys, int n_queries, int d,
                                               float scale, cudaStream_t stream, int outer,
                                               float* stats) {
  using Cfg = TcConfig<D, KT16>;
  const int q_tiles = (n_queries + 15) / 16;
  const int qtb = q_tiles < Cfg::kWarps ? q_tiles : Cfg::kWarps;
  int teams = Cfg::kWarps / qtb;
  while (teams > 1 && teams * tc_slot_bytes<D>(KT16, qtb) > Cfg::kSmemBudget) --teams;
  const size_t bytes = teams * tc_slot_bytes<D>(KT16, qtb);
  const cudaError_t err =
      cudaFuncSetAttribute(grand_attn_bf16_kernel<D, KT16, kOuter, kStats>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int pairs = B * H;
  const dim3 grid((pairs + teams - 1) / teams, (q_tiles + qtb - 1) / qtb, outer);
  grand_attn_bf16_kernel<D, KT16, kOuter, kStats><<<grid, 32 * qtb * teams, bytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, pairs, H, n_keys, n_queries, qtb, scale, stats,
      (n_queries + kBwdTileRows - 1) / kBwdTileRows, d);
  return cudaGetLastError();
}

template <int D, bool kOuter, bool kStats>
inline cudaError_t launch_grand_attn_bf16_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, __nv_bfloat16* out,
                                            Strides sq, Strides sk, Strides sv, Strides so, int B,
                                            int H, int n_keys, int n_queries, int d, float scale,
                                            cudaStream_t stream, int outer, float* stats) {
#define GRAND_TC_ARGS \
  q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, d, scale, stream, outer, stats
  if (n_keys <= 32) return launch_grand_attn_bf16_keys<D, 2, kOuter, kStats>(GRAND_TC_ARGS);
  if (n_keys <= 64) return launch_grand_attn_bf16_keys<D, 4, kOuter, kStats>(GRAND_TC_ARGS);
  if (n_keys <= 128) return launch_grand_attn_bf16_keys<D, 8, kOuter, kStats>(GRAND_TC_ARGS);
  return launch_grand_attn_bf16_keys<D, 16, kOuter, kStats>(GRAND_TC_ARGS);
#undef GRAND_TC_ARGS
}

// Launches the bf16 attention on (B, H[, outer]) groups of n_keys keys and
// n_queries >= n_keys query rows at head width d (takes_head_dim, on the
// instance_head_dim instance), n_keys <= kMaxN; every stride a multiple of
// 8 elements and every base 16-byte aligned (checked by the callers).
// kStats adds B4's row statistics into stats.
template <bool kOuter = false, bool kStats = false>
inline cudaError_t launch_grand_attn_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, __nv_bfloat16* out, Strides sq,
                                          Strides sk, Strides sv, Strides so, int B, int H,
                                          int n_keys, int n_queries, int d, float scale,
                                          cudaStream_t stream, int outer = 1,
                                          float* stats = nullptr) {
  if (n_keys <= 0 || n_keys > kMaxN || n_queries < n_keys || !takes_head_dim(d) ||
      (kStats && stats == nullptr)) {
    return cudaErrorInvalidValue;
  }
#define GRAND_TC_ARGS \
  q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, d, scale, stream, outer, stats
  return instance_head_dim(d) == 64
             ? launch_grand_attn_bf16_d<64, kOuter, kStats>(GRAND_TC_ARGS)
             : launch_grand_attn_bf16_d<128, kOuter, kStats>(GRAND_TC_ARGS);
#undef GRAND_TC_ARGS
}

}  // namespace grand
