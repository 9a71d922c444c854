// Hopper (sm_90a) ports of the GRAND attention forward (long and small
// groups, f32 and bf16) and backward (f32 and bf16).
//
// Replaces:
//   B3 diff3dhpe_tpu/ops/attention.py::_fullseq_grand_attn_kernel
//      (wrapper grand_attention_pallas_3d): out = softmax(q kᵀ·scale) v − v;
//   B4 diff3dhpe_tpu/ops/attention.py::_grand_attn_bwd_kernel
//      (wrapper grand_attention_bwd_pallas), its backward with P recomputed:
//        dV = Pᵀ dO − dO
//        dP = dO Vᵀ,  Dᵢ = Σⱼ dPᵢⱼ Pᵢⱼ
//        dS = P ∘ (dP − D) · scale
//        dQ = dS K,   dK = dSᵀ Q
//   B6 diff3dhpe_tpu/ops/attention.py::_packed_grand_attn_kernel (wrapper
//      packed_grand_attention): the same forward for many small groups,
//      n <= 64 (the spatial attention: n = 17 joints), f32 and bf16.
//
// Operands are [B, H, N, D] read through element strides (unit stride on
// the head dimension), N <= 256; the forward (B3, B6) takes every D that is
// a multiple of 8 up to 128, on the instance of 64 or 128 (grand_attn.cuh,
// "Head widths"), the backward (B4) D = 64 or 128 (one template, two
// instances), so the trainable attention hands over q, k and v as views of its
// [B, N, 3, H, D] qkv projection and receives outputs laid out [B, N, H, D],
// with no copy on either side.
//
// What bounds them on an H100: at the training shape (B·H = 3,264 groups
// of N = 243, d = 64) B3 does 4·N²·d FLOP per group (49 GFLOP) against
// 0.8 GB of compulsory traffic and B4 10·N²·d (123 GFLOP) against 1.4 GB,
// so both are bound by float32 arithmetic (67 TFLOP/s outside the tensor
// cores). All products are plain f32 FMAs (no TF32). B6 at the eval shape
// (7,776 groups of N = 17) does 0.58 GFLOP against 135 MB, so memory
// bounds it.
//
// The session matmul precision (Config.matmul_precision; JAX's kernels pass
// precision=None for f32 operands, ops/attention.py:103-117, :277-282):
// under "default" every f32 product of B3, B4 and B6 is one bf16 pass, its
// operands rounded to bf16 and summed in f32 (the mode argument, F32Mode
// kDefault); "highest" is the exact f32 above. B3 and B6 under "default"
// run the tensor-core kernel of grand_attn_mode.cuh, B4 the bf16 B4's
// tensor-core passes with f32 outputs (below).
//
// Design:
//   B3  the shared f32 launcher of grand_attn_mode.cuh, which B1, B2 and B5
//       run for their attention step: 64-query blocks streaming key tiles
//       of K and V through a cp.async ring with an online softmax, or at
//       n <= 32 B6's small-group kernel; under "default" above 32 keys the
//       tensor-core kernel of grand_attn_mode.cuh.
//   B4  two kernels, with P and dS spilled to HBM, because K, V, Q and dO
//       of one group (4 x 124 KB at N = 243, D = 128) do not fit a block and
//       a one-pass dk/dv with dq would need float atomics:
//       1. dq pass, a block of 128 threads per 64 queries, streaming ~8 KB
//          chunks of key tiles through a two-stage cp.async ring with
//          register micro-tiles fed by 128-bit shared loads (as the forward,
//          grand_attn.cuh). Sweep 1 is the forward's online softmax over
//          64-key tiles (S, then O = P·V), which gives the row's max, 1/sum
//          and D = dO·O / l = Σ P·dP; it is skipped when B3's launch left
//          the statistics (the train step's call). Sweep 2 forms S and dP
//          (4 x 8 micro-tiles each), P and dS = P ∘ (dP − D) · scale, stores
//          both to a [2][B·H][n64][n64] scratch (8 lanes write 32 contiguous
//          bytes) and dS to shared memory, and dQ += dS·K;
//       2. dk/dv pass, a block per 64 keys and product: dV = Pᵀ·dO − dO or
//          dK = dSᵀ·Q from the stored P or dS, 32-row chunks of both
//          operands through the ring, 4 x D/8 micro-tiles.
//       So the call does the 10·N²·d FLOP of the formulas (14 without B3's
//       statistics) and moves P and dS through HBM once each way (3.4 GB at
//       the train shape, 1 ms at the card's rate, under the 1.8 ms of f32
//       arithmetic). Shared memory 93 KB for pass 1 (two blocks an SM), 48
//       KB (D = 128) or 32 KB (D = 64) for pass 2. Each output element is
//       written by one thread: no atomics, so the gradients are deterministic.
//       At bf16, B4 is the backward of grand_attn_bwd_bf16.cuh on wgmma and
//       TMA: the rows' statistics from K1, a dq pass and a dk/dv pass, at
//       JAX's rounding points. At f32 under "default" it is the same two
//       passes with f32 outputs: "default" takes every product of
//       bf16-rounded operands summed in f32, which are the bf16 kernel's
//       rounding points term for term (S and dP summed in f32, P and D in
//       f32, dS and P rounded only as operands; S and dP summed k16 step by
//       k16 step in f32, wgmma_ss_promoted). The f32 q, k, v and dO
//       are rounded once into bf16 planes by round_heads_kernel (one launch
//       for a qkv projection's three views, one for dO: ~1.2 GB at the
//       train shape, 0.36 ms at the card's rate) rather than by the passes'
//       producer warpgroup, which would have to stage f32 tiles and write
//       the swizzled bf16 operands itself, K and V of a pair too, in the
//       40 registers it keeps. Measured at [3264, 243, 64] (H100 80GB HBM3,
//       700 W, utils/mode_attn_profile.py): the two roundings 0.420 ms of
//       a 1.535 ms call (27%, at 87% of the memory rate). Fusing them into
//       the producer would save at most those 0.42 ms, where the producer's conversions hide behind
//       the products, while the passes read twice the bytes (f32 rows, Q
//       and dO once for each 128-key block); it is left open (ROADMAP
//       B.11). dq and dk leave the passes' f32 accumulators unrounded, and
//       dv's "− dO" reads the f32 dO. No P or dS scratch: the dq pass forms
//       the rows' statistics and D (the forward under "default" hands over
//       none) into 192 floats a 64-query tile.
//   B6  the small-group kernel of grand_attn.cuh (n <= 64): persistent
//       blocks walk the (group, head) pairs through a two-stage cp.async
//       ring of whole pairs, a lane holds a (query, key) micro-tile of the
//       score block, output rows leave as 16-byte stores; bound by bytes.
//       At bf16 it is B3's tensor-core kernel, which packs the pairs of
//       small groups into a block. The TPU kernel's 119-row packed tile,
//       block-diagonal mask and group padding serve its matrix unit and
//       have no counterpart.

#include <cuda_runtime.h>
#include <math.h>

#include "grand_attn.cuh"
#include "grand_attn_bf16.cuh"
#include "grand_attn_bwd_bf16.cuh"
#include "grand_attn_mode.cuh"

namespace {

using grand::axpy4;
using grand::cp_async_commit;
using grand::cp_async_wait;
using grand::kKT;
using grand::kLdC;
using grand::kMaxN;
using grand::kQT;
using grand::kSmallMaxN;
using grand::kThreads;
using grand::ld4;
using grand::load_block;
using grand::mm_acc;
using grand::mm_rows;
using grand::oct_max;
using grand::oct_sum;
using grand::Strides;

// n rounded up to the 64-row tiles of both passes: the rows of the
// statistics and the rows and columns of P and dS a (group, head) holds.
__host__ __device__ inline int stat_rows(int n) { return (n + kQT - 1) / kQT * kQT; }

// The dq pass: chunks of a key tile and shared memory in floats. A logit
// chunk is Q, K, dO and V [64 rows][32 columns] (the first two only in
// sweep 1); a row chunk is V (sweep 1) or K (sweep 2) [kRR rows][D], kRR =
// 2048 / D. Then the tile of P (sweep 1) or dS (sweep 2), [64][72], and the
// statistics m, 1/l, D [3][64].
template <int D>
struct DqLayout {
  static constexpr int kSC = D / 32, kRR = 2048 / D, kRC = kKT / kRR;
  static constexpr int kChunks = kSC + kRC;
  static constexpr int kBlock = kQT * kLdC;  // one [64][32] chunk
  static constexpr int kStage = 4 * kBlock;
  static constexpr int kLdW = kKT + 8;
  static constexpr int kW = 2 * kStage, kStats = kW + kQT * kLdW;
  static constexpr int kFloats = kStats + 3 * kQT;
};

// B4, pass 1: dQ, P and dS of 64 queries of one (group, head). Thread
// (tq, tk) = (tid / 8, tid % 8) owns queries q0 + tq + 16i (i < 4), keys tk
// + 8j (j < 8) of each 64-key tile, and columns 4·tk + 32c of O and dQ.
// Sweep 1 is the forward's online softmax (S, then O = P·V): the row's max
// m, 1/l and D = dO·O / l = Σ P·dP. With kFwdStats, m and 1/l come from
// stats (two [B·H, n64] planes B3 wrote) and D = dO·(out + v) instead.
// Sweep 2 forms S and dP, P = exp(S − m) / l and dS = P ∘ (dP − D) · scale
// into pds (two [B·H][n64][n64] planes, zero past n) and dS into shared
// memory, and dQ += dS·K.
template <int D, bool kFwdStats>
__global__ void __launch_bounds__(kThreads)
grand_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ fout, const float* __restrict__ stats,
                         float* __restrict__ dq, float* __restrict__ pds, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sfo, Strides sdq, int n,
                         int q_tiles, float scale) {
  using L = DqLayout<D>;
  constexpr int kC = D / 32;
  extern __shared__ __align__(16) float dq_smem[];
  float* ring = dq_smem;
  float* Ws = dq_smem + L::kW;  // P, then dS
  float* Sq = dq_smem + L::kStats;
  const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * kQT;
  const int h = blockIdx.y, H = gridDim.y;
  const int tq = threadIdx.x >> 3, tk = threadIdx.x & 7;
  const float* qb = q + b * sq.b + h * sq.h + (long long)q0 * sq.n;
  const float* dob = dout + b * sdo.b + h * sdo.h + (long long)q0 * sdo.n;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int nq = n - q0;  // valid query rows of the block
  const int per_sweep = (n + kKT - 1) / kKT * L::kChunks;

  auto issue = [&](int g) {
    float* st = ring + (g & 1) * L::kStage;
    const int sweep = g / per_sweep, t = g % per_sweep / L::kChunks, c = g % L::kChunks;
    if (c < L::kSC) {
      load_block<kQT, 32>(st, kLdC, qb, sq.n, 0, 32 * c, nq);
      load_block<kKT, 32>(st + L::kBlock, kLdC, kb, sk.n, t * kKT, 32 * c, n);
      if (sweep == 1) {
        load_block<kQT, 32>(st + 2 * L::kBlock, kLdC, dob, sdo.n, 0, 32 * c, nq);
        load_block<kKT, 32>(st + 3 * L::kBlock, kLdC, vb, sv.n, t * kKT, 32 * c, n);
      }
    } else {
      load_block<L::kRR, D>(st, D + 4, sweep == 0 ? vb : kb, sweep == 0 ? sv.n : sk.n,
                            t * kKT + (c - L::kSC) * L::kRR, 0, n);
    }
  };
  const int g0 = kFwdStats ? per_sweep : 0;  // with the forward's statistics, sweep 2 only
  issue(g0);
  cp_async_commit();
  if constexpr (kFwdStats) {
    const size_t plane = (size_t)gridDim.x * kQT * H;
    const float* stb = stats + ((size_t)b * H + h) * (q_tiles * kQT) + q0;
    // m and 1/l from the forward; D = dO·(out + v) = dO·O / l by the row's 8 lanes.
    for (int e = threadIdx.x; e < 2 * kQT; e += blockDim.x) Sq[e] = stb[e / kQT * plane + e % kQT];
    const float* fob = fout + b * sfo.b + h * sfo.h + (long long)q0 * sfo.n;
    const float* vq = vb + (long long)q0 * sv.n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tq + 16 * i;
      float part = 0.f;
      if (r < nq) {
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          const int col = 4 * tk + 32 * cc;
          const float4 gv = ld4(dob + (long long)r * sdo.n + col);
          const float4 ov = ld4(fob + (long long)r * sfo.n + col);
          const float4 vv = ld4(vq + (long long)r * sv.n + col);
          part = fmaf(gv.x, ov.x + vv.x, part);
          part = fmaf(gv.y, ov.y + vv.y, part);
          part = fmaf(gv.z, ov.z + vv.z, part);
          part = fmaf(gv.w, ov.w + vv.w, part);
        }
      }
      part = oct_sum(part);
      if (tk == 0) Sq[2 * kQT + r] = part;
    }
  }

  float s[4][8], dp4[4][8], acc[4][4 * kC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kC; ++c) acc[i][c] = 0.f;
  }

  for (int g = g0; g < 2 * per_sweep; ++g) {
    cp_async_wait<0>();
    __syncthreads();  // chunk g has landed; every thread is done with chunk g - 1
    if (g + 1 < 2 * per_sweep) issue(g + 1);
    cp_async_commit();
    const float* st = ring + (g & 1) * L::kStage;
    const int sweep = g / per_sweep, t = g % per_sweep / L::kChunks, c = g % L::kChunks;

    if (!kFwdStats && sweep == 1 && t == 0 && c == 0) {
      // Sweep 1 is over: acc holds O = Σ exp(S − m)·V. D = dO·O / l by the
      // row's 8 lanes; the statistics go to shared memory; acc restarts as dQ.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float inv = 1.0f / oct_sum(l[i]);
        float part = 0.f;
        if (tq + 16 * i < nq) {
          const float* gi = dob + (long long)(tq + 16 * i) * sdo.n + 4 * tk;
#pragma unroll
          for (int cc = 0; cc < kC; ++cc) {
            const float4 gv = ld4(gi + 32 * cc);
            part = fmaf(gv.x, acc[i][4 * cc], part);
            part = fmaf(gv.y, acc[i][4 * cc + 1], part);
            part = fmaf(gv.z, acc[i][4 * cc + 2], part);
            part = fmaf(gv.w, acc[i][4 * cc + 3], part);
          }
        }
        const float dsum = oct_sum(part) * inv;
        if (tk == 0) {
          Sq[tq + 16 * i] = m[i];
          Sq[kQT + tq + 16 * i] = inv;
          Sq[2 * kQT + tq + 16 * i] = dsum;
        }
#pragma unroll
        for (int cc = 0; cc < 4 * kC; ++cc) acc[i][cc] = 0.f;
      }
    }

    if (c < L::kSC) {
      if (sweep == 0) {
        if (c == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
        }
        mm_rows<4, 8, 16, 8>(s, st, kLdC, tq, st + L::kBlock, kLdC, tk);
        if (c == L::kSC - 1) {  // online softmax, as the forward
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float mt = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              s[i][j] = t * kKT + tk + 8 * j < n ? s[i][j] * scale : -INFINITY;
              mt = fmaxf(mt, s[i][j]);
            }
            const float m_new = fmaxf(m[i], oct_max(mt));
            const float alpha = expf(m[i] - m_new);
            m[i] = m_new;
            l[i] *= alpha;
#pragma unroll
            for (int cc = 0; cc < 4 * kC; ++cc) acc[i][cc] *= alpha;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float p = expf(s[i][j] - m_new);
              l[i] += p;
              Ws[(tq + 16 * i) * L::kLdW + tk + 8 * j] = p;
            }
          }
        }
      } else {
        if (c == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = dp4[i][j] = 0.f;
        }
        mm_rows<4, 8, 16, 8>(s, st, kLdC, tq, st + L::kBlock, kLdC, tk);
        mm_rows<4, 8, 16, 8>(dp4, st + 2 * L::kBlock, kLdC, tq, st + 3 * L::kBlock, kLdC, tk);
        if (c == L::kSC - 1) {  // P and dS of the tile to shared memory and to pds
          const size_t n64 = (size_t)q_tiles * kQT;
          float* pg = pds + (((size_t)b * H + h) * n64 + q0) * n64 + t * kKT + tk;
          float* dsg = pg + (size_t)gridDim.x * kQT * H * n64;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = tq + 16 * i;
            const float mr = Sq[r], ir = Sq[kQT + r], dr = Sq[2 * kQT + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const bool ok = r < nq && t * kKT + tk + 8 * j < n;
              const float p = ok ? expf(s[i][j] * scale - mr) * ir : 0.f;
              const float ds = ok ? p * (dp4[i][j] - dr) * scale : 0.f;
              Ws[r * L::kLdW + tk + 8 * j] = ds;
              pg[r * n64 + 8 * j] = p;
              dsg[r * n64 + 8 * j] = ds;
            }
          }
        }
      }
    } else {  // sweep 1: O += P·V; sweep 2: dQ += dS·K
      mm_acc<4, 16, kC, 32>(acc, Ws + (c - L::kSC) * L::kRR, L::kLdW, tq, st, D + 4, tk, L::kRR);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq + 16 * i;
    if (r >= nq) continue;
    float* o = dq + b * sdq.b + h * sdq.h + (long long)(q0 + r) * sdq.n + 4 * tk;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      *reinterpret_cast<float4*>(o + 32 * cc) =
          make_float4(acc[i][4 * cc], acc[i][4 * cc + 1], acc[i][4 * cc + 2], acc[i][4 * cc + 3]);
    }
  }
}

// The dk/dv pass: a block takes 64 keys of one (group, head) and one of
// the two products; chunks of 32 query rows stream through a two-stage
// cp.async ring, each P or dS [32 rows][64 keys] and dO or Q [32 rows][D].
constexpr int kKB = 64;  // keys a block of the dk/dv pass
constexpr int kQR = 32;  // query rows a chunk

template <int D>
struct DkdvLayout {
  static constexpr int kA = kQR * kKB;
  static constexpr int kStage = kA + kQR * D;
  static constexpr int kFloats = 2 * kStage;
};

// B4, pass 2: of 64 keys of one (group, head), dV = Pᵀ·dO − dO
// (blockIdx.z = 0) or dK = dSᵀ·Q (blockIdx.z = 1), from the P and dS planes
// the dq pass stored ([B·H][n64][n64] each, zero past n). Thread (tk, tc) =
// (tid / 8, tid % 8) owns keys k0 + 4·tk + i (i < 4) and columns 4·tc + 32c
// (c < D / 32): per query row one 128-bit load of four P (or dS) and D / 32
// of dO (or Q) feed 16·D/32 FMAs, as the forward's P·V.
template <int D>
__global__ void __launch_bounds__(kThreads)
grand_attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                           const float* __restrict__ pds, float* __restrict__ dk,
                           float* __restrict__ dv, Strides sq, Strides sdo, Strides sdk,
                           Strides sdv, int n, int k_tiles) {
  using L = DkdvLayout<D>;
  constexpr int kC = D / 32;
  extern __shared__ __align__(16) float dkdv_smem[];
  const int b = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * kKB;
  const int h = blockIdx.y, H = gridDim.y;
  const bool is_dk = blockIdx.z == 1;
  const int tk = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int n64 = k_tiles * kKB;
  const size_t plane = (size_t)gridDim.x * kKB * H * n64;
  const float* a_src = pds + (is_dk ? plane : 0) + ((size_t)b * H + h) * n64 * n64 + k0;
  const float* x_src = is_dk ? q + b * sq.b + h * sq.h : dout + b * sdo.b + h * sdo.h;
  const long long x_row = is_dk ? sq.n : sdo.n;
  const int total = (n + kQR - 1) / kQR;  // P and dS rows past n are zero
  auto issue = [&](int g) {
    float* st = dkdv_smem + (g & 1) * L::kStage;
    load_block<kQR, kKB>(st, kKB, a_src, n64, g * kQR, 0, n64);
    load_block<kQR, D>(st + L::kA, D, x_src, x_row, g * kQR, 0, n);
  };
  issue(0);
  cp_async_commit();
  float acc[4][4 * kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kC; ++c) acc[i][c] = 0.f;
  for (int g = 0; g < total; ++g) {
    cp_async_wait<0>();
    __syncthreads();  // chunk g has landed; every thread is done with chunk g - 1
    if (g + 1 < total) issue(g + 1);
    cp_async_commit();
    const float* As = dkdv_smem + (g & 1) * L::kStage;
    const float* Xs = As + L::kA;
#pragma unroll 8
    for (int r = 0; r < kQR; ++r) {
      const float4 a = ld4(As + r * kKB + 4 * tk);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 x = ld4(Xs + r * D + 4 * tc + 32 * c);
        axpy4(a.x, x, &acc[0][4 * c]);
        axpy4(a.y, x, &acc[1][4 * c]);
        axpy4(a.z, x, &acc[2][4 * c]);
        axpy4(a.w, x, &acc[3][4 * c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long j = k0 + 4 * tk + i;
    if (j >= n) continue;
    float* o = is_dk ? dk + b * sdk.b + h * sdk.h + j * sdk.n
                     : dv + b * sdv.b + h * sdv.h + j * sdv.n;
    const float* gj = dout + b * sdo.b + h * sdo.h + j * sdo.n;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = 4 * tc + 32 * c;
      const float* e = &acc[i][4 * c];
      const float4 g4 = is_dk ? make_float4(0.f, 0.f, 0.f, 0.f) : ld4(gj + col);
      *reinterpret_cast<float4*>(o + col) =
          make_float4(e[0] - g4.x, e[1] - g4.y, e[2] - g4.z, e[3] - g4.w);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, bool kFwdStats>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* fout, const float* stats, float* dq, float* pds, Strides sq,
                      Strides sk, Strides sv, Strides sdo, Strides sfo, Strides sdq, int B, int H,
                      int n, float scale, cudaStream_t stream) {
  const int q_tiles = stat_rows(n) / kQT;
  const size_t bytes = DqLayout<D>::kFloats * sizeof(float);
  const cudaError_t err = allow_smem(grand_attn_bwd_dq_kernel<D, kFwdStats>, bytes);
  if (err != cudaSuccess) return err;
  grand_attn_bwd_dq_kernel<D, kFwdStats><<<dim3(B * q_tiles, H), kThreads, bytes, stream>>>(
      q, k, v, dout, fout, stats, dq, pds, sq, sk, sv, sdo, sfo, sdq, n, q_tiles, scale);
  return cudaGetLastError();
}

// B4 at head width D in exact f32: the dq pass, then the dk/dv pass. With
// fout (the forward's output, whose launch also wrote m and 1/l into
// stats) the dq pass skips its first sweep. Adds one to *launches for each
// kernel launched.
template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dout,
                       const float* fout, const float* stats, float* dq, float* dk, float* dv,
                       float* pds, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sfo,
                       Strides sdq, Strides sdk, Strides sdv, int B, int H, int n, float scale,
                       int* launches, cudaStream_t stream) {
#define DQ_ARGS \
  q, k, v, dout, fout, stats, dq, pds, sq, sk, sv, sdo, sfo, sdq, B, H, n, scale, stream
  cudaError_t err = fout ? launch_dq<D, true>(DQ_ARGS) : launch_dq<D, false>(DQ_ARGS);
#undef DQ_ARGS
  if (err != cudaSuccess) return err;
  ++*launches;
  const int k_tiles = stat_rows(n) / kKB;
  const size_t bytes = DkdvLayout<D>::kFloats * sizeof(float);
  if ((err = allow_smem(grand_attn_bwd_dkdv_kernel<D>, bytes)) != cudaSuccess) return err;
  grand_attn_bwd_dkdv_kernel<D><<<dim3(B * k_tiles, H, 2), kThreads, bytes, stream>>>(
      q, dout, pds, dk, dv, sq, sdo, sdk, sdv, n, k_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launches;
  return cudaSuccess;
}

// ---- B4 under the session precision "default": the bf16 passes ----

// Rounds the f32 rows of a [B, Hs, n, D] view x to bf16 (nearest even)
// into the view y, both by element strides (x's rows 16-byte aligned, y's
// 16-byte aligned): the operands of B4's tensor-core passes under
// "default". 8 values a thread and step, grid-stride, the heads of a row
// (b, r) next to each other, as q, k and v lie in a qkv projection. Bound by
// bytes: 4 read and 2 written a value.
__global__ void __launch_bounds__(256)
round_heads_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y, Strides sx,
                   Strides sy, int Hs, int n, int d8, long long pieces) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pieces;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % d8) * 8;
    long long row = i / d8;
    const int h = (int)(row % Hs);
    row /= Hs;
    const long long r = row % n, b = row / n;
    const float* src = x + b * sx.b + h * sx.h + r * sx.n + c;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    uint4 o;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
    op[0] = __floats2bfloat162_rn(lo.x, lo.y);
    op[1] = __floats2bfloat162_rn(lo.z, lo.w);
    op[2] = __floats2bfloat162_rn(hi.x, hi.y);
    op[3] = __floats2bfloat162_rn(hi.z, hi.w);
    *reinterpret_cast<uint4*>(y + b * sy.b + h * sy.h + r * sy.n + c) = o;
  }
}

cudaError_t launch_round(const float* x, __nv_bfloat16* y, Strides sx, Strides sy, int B, int Hs,
                         int n, int d, int* launches, cudaStream_t stream) {
  const long long pieces = (long long)B * Hs * n * (d / 8), want = (pieces + 255) / 256;
  round_heads_kernel<<<want < 132 * 16 ? (int)want : 132 * 16, 256, 0, stream>>>(
      x, y, sx, sy, Hs, n, d / 8, pieces);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

// B4 at f32 under "default" at head width D: q, k, v and dO rounded once
// into bf16 planes (qkv [B, n, 3H, D], then dO [B, n, H, D]: one launch for
// q, k and v where they are heads [0, H), [H, 2H) and [2H, 3H) of one view,
// as the trainable attention's qkv projection gives them, else one each,
// and one for dO), then the tensor-core passes of grand_attn_bwd_bf16.cuh
// with f32 outputs, the statistics formed in the dq pass into stats, and
// dv's "− dO" from the f32 dout. Adds one to *launches for each kernel
// launched.
template <int D>
cudaError_t launch_bwd_default(const float* q, const float* k, const float* v, const float* dout,
                               float* stats, __nv_bfloat16* planes, float* dq, float* dk,
                               float* dv, Strides sq, Strides sk, Strides sv, Strides sdo,
                               Strides sdq, Strides sdk, Strides sdv, int B, int H, int n,
                               float scale, int* launches, cudaStream_t stream) {
  const long long hd = (long long)H * D;
  const Strides s3{n * 3 * hd, D, 3 * hd, 0}, s1{n * hd, D, hd, 0};
  __nv_bfloat16* qkv = planes;
  __nv_bfloat16* g = planes + 3 * hd * n * B;
  const auto same = [](Strides a, Strides b) { return a.b == b.b && a.h == b.h && a.n == b.n; };
  cudaError_t err;
  if (k == q + hd && v == k + hd && sq.h == D && same(sq, sk) && same(sq, sv)) {
    err = launch_round(q, qkv, sq, s3, B, 3 * H, n, D, launches, stream);
  } else if ((err = launch_round(q, qkv, sq, s3, B, H, n, D, launches, stream)) == cudaSuccess &&
             (err = launch_round(k, qkv + hd, sk, s3, B, H, n, D, launches, stream)) ==
                 cudaSuccess) {
    err = launch_round(v, qkv + 2 * hd, sv, s3, B, H, n, D, launches, stream);
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_round(dout, g, sdo, s1, B, H, n, D, launches, stream)) != cudaSuccess) {
    return err;
  }
  return grand::launch_bwd_bf16<D, float>(qkv, qkv + hd, qkv + 2 * hd, g, dout, dq, dk, dv, stats,
                                          false, s3, s3, s3, s1, sdo, sdq, sdk, sdv, B, H, n,
                                          scale, launches, stream);
}

// The f32 forward under the session matmul precision (F32Mode kHighest
// or kDefault): launch_grand_attn at that mode; with small, B6's groups of
// up to kSmallMaxN keys, which under kHighest take the small-group kernel
// alone.
cudaError_t launch_fwd_f32(const float* q, const float* k, const float* v, float* out,
                           Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int n,
                           int d, float scale, float* stats, int mode, bool small,
                           cudaStream_t stream) {
  if (mode == grand::kDefault) {
    return grand::launch_grand_attn<false, grand::kDefault>(q, k, v, out, sq, sk, sv, so, B, H,
                                                            n, n, d, scale, stream, 1, stats);
  }
  if (mode != grand::kHighest) return cudaErrorInvalidValue;
  if (small) return grand::launch_small(q, k, v, out, sq, sk, sv, so, B, H, n, n, d, scale, stream);
  return grand::launch_grand_attn(q, k, v, out, sq, sk, sv, so, B, H, n, n, d, scale, stream, 1,
                                  stats);
}

}  // namespace

#define STRIDES(p) Strides{p##_sb, p##_sh, p##_sn}

// B3: out = softmax(q kᵀ·scale) v − v for every (b, h) of [B, H, n, d]
// operands (d a multiple of 8 up to 128) given by their element strides (sb, sh, sn).
// stats may be null; else (n > 32) it holds 2·B·H·n64 floats, and the
// launch writes each row's max and 1/sum into its two planes for a later
// diff3dhpe_grand_attn_bwd_f32. mode: the session matmul precision as
// F32Mode, kHighest (exact f32) or kDefault (one bf16 pass: the
// tensor-core kernel of grand_attn_mode.cuh above 32 keys). One kernel;
// adds one to *launches when it launched. Returns the cudaError_t of the
// launch.
extern "C" int diff3dhpe_grand_attn_fwd_f32(
    const float* q, const float* k, const float* v, float* out, int B, int H, int n, int d,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, float* stats, int mode, int* launches,
    void* stream_ptr) {
  const cudaError_t err = launch_fwd_f32(q, k, v, out, STRIDES(q), STRIDES(k), STRIDES(v),
                                         STRIDES(o), B, H, n, d, scale, stats, mode, false,
                                         static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// B3 at bf16: the same arguments on bf16 operands (the same d), through
// the tensor-core kernel of grand_attn_bf16.cuh (P rounded to bf16 after the
// normalisation, one rounding of P·v − v). Every stride a multiple of 8
// elements and every base 16-byte aligned (checked by the wrapper). stats
// may be null; else it holds B·H·nt·192 floats (nt = n rounded up to 64,
// over 64) and the launch writes each row's −max·scale and 1/sum there for
// a later diff3dhpe_grand_attn_bwd_bf16.
extern "C" int diff3dhpe_grand_attn_fwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
    int B, int H, int n, int d,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, float* stats, int* launches,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define FWD_ARGS q, k, v, out, STRIDES(q), STRIDES(k), STRIDES(v), STRIDES(o), B, H, n, n, d, \
                 scale, stream
  const cudaError_t err =
      stats ? grand::launch_grand_attn_bf16<false, true>(FWD_ARGS, 1, stats)
            : grand::launch_grand_attn_bf16(FWD_ARGS);
#undef FWD_ARGS
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// B6: the same function for small groups, n <= 64, through the
// small-group kernel of grand_attn.cuh (persistent blocks walking the
// (b, h) pairs); under mode kDefault the small-group kernel's instance at
// that mode up to 32 keys, the tensor-core kernel of grand_attn_mode.cuh
// above. One kernel; adds one to *launches when it launched. Returns the
// cudaError_t of the launch.
extern "C" int diff3dhpe_grand_attn_small_f32(
    const float* q, const float* k, const float* v, float* out, int B, int H, int n, int d,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, int mode, int* launches, void* stream_ptr) {
  if (n > kSmallMaxN) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_fwd_f32(q, k, v, out, STRIDES(q), STRIDES(k), STRIDES(v),
                                         STRIDES(o), B, H, n, d, scale, nullptr, mode, true,
                                         static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// B6 at bf16, n <= 64: the tensor-core kernel of grand_attn_bf16.cuh, which
// packs the pairs of small groups into a block (P rounded to bf16 after
// the normalisation, one rounding of P·v − v: the bf16 branch of JAX's
// grand_attend_tile). Arguments and checks as B3 at bf16.
extern "C" int diff3dhpe_grand_attn_small_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
    int B, int H, int n, int d,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, int* launches, void* stream_ptr) {
  if (n > kSmallMaxN) return (int)cudaErrorInvalidValue;
  return diff3dhpe_grand_attn_fwd_bf16(q, k, v, out, B, H, n, d, q_sb, q_sh, q_sn, k_sb, k_sh,
                                       k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn, scale, nullptr,
                                       launches, stream_ptr);
}

// B4: dq, dk, dv of B3 given dO, at d = 64 or 128 and n <= 256, under the
// session matmul precision mode (F32Mode):
// - kHighest, exact f32: two kernels, the dq pass, then the dk/dv pass.
//   pds is scratch of 2·B·H·n64² floats, n64 = n rounded up to 64: the dq
//   pass stores P and dS there for the dk/dv pass. fout may be null; else
//   it is B3's output for these q, k, v, from a launch of
//   diff3dhpe_grand_attn_fwd_f32 that wrote its statistics into stats
//   (2·B·H·n64 floats), and the dq pass starts from them.
// - kDefault, every product of bf16-rounded operands summed in f32: the
//   bf16 B4's tensor-core passes with f32 outputs (launch_bwd_default).
//   planes is scratch of 4·B·n·H·d bf16 for the rounded q, k, v and dO;
//   stats is scratch of B·H·nt·192 floats (nt = n rounded up to 64, over
//   64), where the dq pass forms the rows' statistics and D; pds and fout
//   are unused and fout must be null (the row sums D take the unrounded P,
//   which the forward's rounded exponentials cannot give).
// Adds one to *launches for each kernel launched; returns the first
// cudaError_t reported.
extern "C" int diff3dhpe_grand_attn_bwd_f32(
    const float* q, const float* k, const float* v, const float* dout, const float* fout,
    float* stats, float* dq, float* dk, float* dv, float* pds, __nv_bfloat16* planes, int B, int H,
    int n, int d, long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long g_sb,
    long long g_sh, long long g_sn, long long f_sb, long long f_sh, long long f_sn,
    long long dq_sb, long long dq_sh, long long dq_sn, long long dk_sb, long long dk_sh,
    long long dk_sn, long long dv_sb, long long dv_sh, long long dv_sn, float scale, int mode,
    int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || n > kMaxN || !grand::bwd_takes_head_dim(d)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (mode == grand::kDefault) {
    if (fout != nullptr || stats == nullptr || planes == nullptr) return (int)cudaErrorInvalidValue;
#define BWD_ARGS q, k, v, dout, stats, planes, dq, dk, dv, STRIDES(q), STRIDES(k), STRIDES(v), \
                 STRIDES(g), STRIDES(dq), STRIDES(dk), STRIDES(dv), B, H, n, scale, launches, \
                 stream
    err = d == 64 ? launch_bwd_default<64>(BWD_ARGS) : launch_bwd_default<128>(BWD_ARGS);
#undef BWD_ARGS
    return (int)err;
  }
  if (mode != grand::kHighest || pds == nullptr || (fout != nullptr && stats == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
#define BWD_ARGS q, k, v, dout, fout, stats, dq, dk, dv, pds, STRIDES(q), STRIDES(k), STRIDES(v), \
                 STRIDES(g), STRIDES(f), STRIDES(dq), STRIDES(dk), STRIDES(dv), B, H, n, scale, \
                 launches, stream
  err = d == 64 ? launch_bwd<64>(BWD_ARGS) : launch_bwd<128>(BWD_ARGS);
#undef BWD_ARGS
  return (int)err;
}

// B4 at bf16: dq, dk, dv of B3 at bf16 given dO, on wgmma, at d = 64 or
// 128 and n <= 256; arguments as the f32 entry point without B3's output,
// strides as B3 at bf16. stats: B·H·nt·192 floats (nt = n rounded up to 64,
// over 64); with have_stats it holds the rows' statistics that a launch of
// diff3dhpe_grand_attn_fwd_bf16 on these q, k, v wrote, else the dq pass
// forms them (in K1's order of operations, so both give the same bits) and
// writes them there; the dq pass adds each row's D for the dk/dv pass. Two
// kernels; adds one to *launches for each launched; returns the first
// cudaError_t reported.
extern "C" int diff3dhpe_grand_attn_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
    float* stats, int have_stats, int B, int H, int n, int d, long long q_sb, long long q_sh,
    long long q_sn, long long k_sb, long long k_sh, long long k_sn, long long v_sb,
    long long v_sh, long long v_sn, long long g_sb, long long g_sh, long long g_sn,
    long long dq_sb, long long dq_sh, long long dq_sn, long long dk_sb, long long dk_sh,
    long long dk_sn, long long dv_sb, long long dv_sh, long long dv_sn, float scale,
    int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || n > kMaxN || !grand::bwd_takes_head_dim(d) || stats == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
#define BWD_ARGS q, k, v, dout, dout, dq, dk, dv, stats, have_stats != 0, STRIDES(q), STRIDES(k), \
                 STRIDES(v), STRIDES(g), STRIDES(g), STRIDES(dq), STRIDES(dk), STRIDES(dv), B, H, \
                 n, scale, launches, stream
  const cudaError_t err = d == 64 ? grand::launch_bwd_bf16<64, __nv_bfloat16>(BWD_ARGS)
                                  : grand::launch_bwd_bf16<128, __nv_bfloat16>(BWD_ARGS);
#undef BWD_ARGS
  return (int)err;
}

// 1 where the forward kernels (B3, B6) take head width d (a multiple of 8
// up to 128, at f32 and at bf16), and where the backward (B4) takes it (64
// or 128).
extern "C" int diff3dhpe_grand_takes_head_dim(int d) { return grand::takes_head_dim(d); }
extern "C" int diff3dhpe_grand_bwd_takes_head_dim(int d) { return grand::bwd_takes_head_dim(d); }
// The most keys per group the kernels take; the wrappers check it.
extern "C" int diff3dhpe_grand_max_n() { return kMaxN; }
// The most keys per group B6 takes.
extern "C" int diff3dhpe_grand_small_max_n() { return kSmallMaxN; }
