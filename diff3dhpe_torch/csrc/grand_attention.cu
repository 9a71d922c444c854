// Hopper (sm_90a) ports of the GRAND attention forward (long and small
// groups) and backward, f32.
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
//      n <= 64 (the spatial attention: n = 17 joints).
//
// Operands are [B, H, N, 64] read through element strides (unit stride on
// the head dimension), so the trainable attention hands over q, k and v as
// views of its [B, N, 3, H, 64] qkv projection and receives outputs laid
// out [B, N, H, 64], with no copy on either side.
//
// What bounds them on an H100: at the training shape (B·H = 3,264 groups
// of N = 243, d = 64) B3 does 4·N²·d FLOP per group (49 GFLOP) against
// 0.8 GB of compulsory traffic and B4 10·N²·d (123 GFLOP) against 1.4 GB,
// so both are bound by float32 arithmetic (67 TFLOP/s outside the tensor
// cores). All products are plain f32 FMAs (no TF32). B6 at the eval shape
// (7,776 groups of N = 17) does 0.58 GFLOP against 135 MB, so memory
// bounds it.
//
// Design:
//   B3  grand_attn_kernel from grand_attn.cuh, the kernel B1 runs for its
//       attention step (one block per (group, head), K and V in shared
//       memory, scores in registers).
//   B4  two kernels after FlashAttention-2's split, because K, V, Q and dO
//       of one group (4 × 62 KB at N = 243) do not fit one block's 227 KB:
//       1. dq pass, one block per (group, head), K and V resident: each
//          warp takes 4 queries, recomputes their P rows and dP rows in
//          registers, writes dQ and the row statistics (max, 1/sum, D) to
//          a small [B·H, N] buffer;
//       2. dk/dv pass, one block per (group, head), Q (times scale) and dO
//          resident with the statistics: each warp takes 4 keys and
//          recomputes their P and dS columns from the stored statistics,
//          then forms dK and dV with the lanes split over the head dim.
//       Each output element is written by one thread: no atomics, so the
//       gradients are deterministic. P is rebuilt in both passes with the
//       same products in the same order, so the two passes see the same P.
//       The passes cost 14·N²·d FLOP where the formulas need 10.
//   B6  grand_attn_small_kernel: B3's one block per (group, head) would
//       leave most of a block idle at n = 17, so here one WARP takes a
//       (group, head) and a block holds several. The warp's Q (times
//       scale), K and V sit in its own slice of shared memory; lane j owns
//       key j (and key 32 + j for n > 32), so a query's scores are one or
//       two registers per lane and the softmax is two warp reductions. For
//       the AV product the lanes turn to the head dimension (columns lane
//       and 32 + lane) and take each P from its owner by shuffle. expf,
//       IEEE division, normalisation after the AV product as in B3. The
//       TPU kernel's 119-row packed tile, block-diagonal mask and group
//       padding serve its matrix unit and have no counterpart.

#include <cuda_runtime.h>
#include <math.h>

#include "grand_attn.cuh"
#include "grand_attn_bf16.cuh"

namespace {

using grand::kHeadDim;
using grand::kKeysPerLane;
using grand::kMaxN;
using grand::kMaxWarps;
using grand::kPadDim;
using grand::Strides;
using grand::load_padded;
using grand::round32;
using grand::warp_max;
using grand::warp_sum;

constexpr int kRowsPerWarp = 4;  // queries (dq pass) or keys (dk/dv pass) a warp holds

// Shared memory of the dq pass, in floats: per warp Q, dO [4][64] and dS
// [n32][4], then K, V [n][65] (the float4 tiles first, for alignment).
size_t dq_smem_floats(int n, int warps) {
  return 2 * (size_t)n * kPadDim + (size_t)warps * (2 * kRowsPerWarp * kHeadDim) +
         (size_t)warps * round32(n) * kRowsPerWarp;
}

// Shared memory of the dk/dv pass, in floats: per warp K, V [4][64] and
// P, dS [n32][4]; then Q·scale, dO [n][65] and the statistics m, 1/sum,
// D [n] each.
size_t dkdv_smem_floats(int n, int warps) {
  return 2 * (size_t)n * kPadDim + 3 * (size_t)n +
         (size_t)warps * (2 * kRowsPerWarp * kHeadDim) +
         (size_t)warps * 2 * round32(n) * kRowsPerWarp;
}

// Copies 4 rows starting at row i0 (zeros past n) of one head into a
// [4][64] warp tile, times mul.
__device__ __forceinline__ void load_rows4(float* dst, const float* src, long long row_stride,
                                           int i0, int n, float mul, int lane) {
  for (int e = lane; e < kRowsPerWarp * kHeadDim; e += 32) {
    const int i = i0 + e / kHeadDim;
    dst[e] = i < n ? src[i * row_stride + e % kHeadDim] * mul : 0.f;
  }
}

// Per lane, for its 8 rows r = kk·32 + lane of a padded [n][65] tile A and
// B, and the 4 rows of the warp tiles X and Y [4][64]:
//   xa[x][kk] = X[x]·A[r],  yb[x][kk] = Y[x]·B[r]   (−inf / 0 past n).
__device__ __forceinline__ void dots4x8(const float* A, const float* B, const float* X,
                                        const float* Y, int n, int lane,
                                        float xa[kRowsPerWarp][kKeysPerLane],
                                        float yb[kRowsPerWarp][kKeysPerLane]) {
#pragma unroll
  for (int kk = 0; kk < kKeysPerLane; ++kk) {
#pragma unroll
    for (int x = 0; x < kRowsPerWarp; ++x) {
      xa[x][kk] = -INFINITY;
      yb[x][kk] = 0.f;
    }
    const int r = kk * 32 + lane;
    if (kk * 32 < n && r < n) {
      float da[kRowsPerWarp] = {}, db[kRowsPerWarp] = {};
      const float* ar = A + r * kPadDim;
      const float* br = B + r * kPadDim;
#pragma unroll 4
      for (int d = 0; d < kHeadDim; d += 4) {
        const float a0 = ar[d], a1 = ar[d + 1], a2 = ar[d + 2], a3 = ar[d + 3];
        const float b0 = br[d], b1 = br[d + 1], b2 = br[d + 2], b3 = br[d + 3];
#pragma unroll
        for (int x = 0; x < kRowsPerWarp; ++x) {
          const float4 xv = *reinterpret_cast<const float4*>(X + x * kHeadDim + d);
          const float4 yv = *reinterpret_cast<const float4*>(Y + x * kHeadDim + d);
          da[x] = fmaf(xv.x, a0, da[x]);
          da[x] = fmaf(xv.y, a1, da[x]);
          da[x] = fmaf(xv.z, a2, da[x]);
          da[x] = fmaf(xv.w, a3, da[x]);
          db[x] = fmaf(yv.x, b0, db[x]);
          db[x] = fmaf(yv.y, b1, db[x]);
          db[x] = fmaf(yv.z, b2, db[x]);
          db[x] = fmaf(yv.w, b3, db[x]);
        }
      }
#pragma unroll
      for (int x = 0; x < kRowsPerWarp; ++x) {
        xa[x][kk] = da[x];
        yb[x][kk] = db[x];
      }
    }
  }
}

// acc[x][0..1] += Σ_r W[r][x] · T[r][lane, lane + 32] over r < n, for a
// per-warp weight tile W [n32][4] and a padded [n][65] tile T.
__device__ __forceinline__ void accumulate_rows(const float* W, const float* T, int n, int lane,
                                                float acc[kRowsPerWarp][2]) {
  for (int r = 0; r < n; ++r) {
    const float4 w = *reinterpret_cast<const float4*>(W + r * kRowsPerWarp);
    const float t0 = T[r * kPadDim + lane], t1 = T[r * kPadDim + 32 + lane];
    acc[0][0] = fmaf(w.x, t0, acc[0][0]);
    acc[0][1] = fmaf(w.x, t1, acc[0][1]);
    acc[1][0] = fmaf(w.y, t0, acc[1][0]);
    acc[1][1] = fmaf(w.y, t1, acc[1][1]);
    acc[2][0] = fmaf(w.z, t0, acc[2][0]);
    acc[2][1] = fmaf(w.z, t1, acc[2][1]);
    acc[3][0] = fmaf(w.w, t0, acc[3][0]);
    acc[3][1] = fmaf(w.w, t1, acc[3][1]);
  }
}

// B4, pass 1: dQ and the per-query statistics of one (group, head).
// stats holds three [B·H, n] planes: max of the scaled logits, 1/sum of
// their exponentials, and D.
__global__ void grand_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dout,
                                         float* __restrict__ dq, float* __restrict__ stats,
                                         Strides sq, Strides sk, Strides sv, Strides sdo,
                                         Strides sdq, int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n32 = round32(n);
  float* Ws = smem;  // per warp: Q [4][64], dO [4][64]
  float* Ss = Ws + warps * 2 * kRowsPerWarp * kHeadDim;
  float* Ks = Ss + warps * n32 * kRowsPerWarp;
  float* Vs = Ks + n * kPadDim;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  float* dqb = dq + b * sdq.b + h * sdq.h;
  const size_t plane = (size_t)gridDim.x * H * n;
  float* st = stats + ((size_t)b * H + h) * n;

  load_padded(Ks, k + b * sk.b + h * sk.h, sk.n, n, 1.0f);
  load_padded(Vs, v + b * sv.b + h * sv.h, sv.n, n, 1.0f);
  __syncthreads();

  float* Qw = Ws + warp * 2 * kRowsPerWarp * kHeadDim;
  float* DOw = Qw + kRowsPerWarp * kHeadDim;
  float* Sw = Ss + warp * n32 * kRowsPerWarp;
  for (int i0 = warp * kRowsPerWarp; i0 < n; i0 += warps * kRowsPerWarp) {
    load_rows4(Qw, qb, sq.n, i0, n, scale, lane);
    load_rows4(DOw, dob, sdo.n, i0, n, 1.0f, lane);
    __syncwarp();

    float s[kRowsPerWarp][kKeysPerLane], dp[kRowsPerWarp][kKeysPerLane];
    dots4x8(Ks, Vs, Qw, DOw, n, lane, s, dp);

#pragma unroll
    for (int x = 0; x < kRowsPerWarp; ++x) {
      float m = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) m = fmaxf(m, s[x][kk]);
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const float e = kk * 32 + lane < n ? expf(s[x][kk] - m) : 0.f;
        s[x][kk] = e;
        sum += e;
      }
      const float inv = 1.0f / warp_sum(sum);
      float dsum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        s[x][kk] *= inv;  // P
        dsum = fmaf(s[x][kk], dp[x][kk], dsum);
      }
      dsum = warp_sum(dsum);
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) s[x][kk] = s[x][kk] * (dp[x][kk] - dsum) * scale;
      if (lane == 0 && i0 + x < n) {
        st[i0 + x] = m;
        st[plane + i0 + x] = inv;
        st[2 * plane + i0 + x] = dsum;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk) {
      if (kk * 32 < n) {
        *reinterpret_cast<float4*>(Sw + (kk * 32 + lane) * kRowsPerWarp) =
            make_float4(s[0][kk], s[1][kk], s[2][kk], s[3][kk]);
      }
    }
    __syncwarp();

    float acc[kRowsPerWarp][2] = {};
    accumulate_rows(Sw, Ks, n, lane, acc);
#pragma unroll
    for (int x = 0; x < kRowsPerWarp; ++x) {
      const int i = i0 + x;
      if (i >= n) break;
      float* o = dqb + i * sdq.n;
      o[lane] = acc[x][0];
      o[32 + lane] = acc[x][1];
    }
    __syncwarp();
  }
}

// B4, pass 2: dK and dV of one (group, head) from the statistics of pass 1.
__global__ void grand_attn_bwd_dkdv_kernel(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ dout,
                                           const float* __restrict__ stats,
                                           float* __restrict__ dk, float* __restrict__ dv,
                                           Strides sq, Strides sk, Strides sv, Strides sdo,
                                           Strides sdk, Strides sdv, int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n32 = round32(n);
  float* Ws = smem;                // per warp: K [4][64], V [4][64]
  float* Ps = Ws + warps * 2 * kRowsPerWarp * kHeadDim;  // per warp: P, dS [n32][4]
  float* Qs = Ps + warps * 2 * n32 * kRowsPerWarp;       // q · scale
  float* DOs = Qs + n * kPadDim;
  float* Ms = DOs + n * kPadDim;   // statistics
  float* Is = Ms + n;
  float* Ds = Is + n;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
  const size_t plane = (size_t)gridDim.x * H * n;
  const float* st = stats + ((size_t)b * H + h) * n;

  load_padded(Qs, q + b * sq.b + h * sq.h, sq.n, n, scale);
  load_padded(DOs, dob, sdo.n, n, 1.0f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    Ms[i] = st[i];
    Is[i] = st[plane + i];
    Ds[i] = st[2 * plane + i];
  }
  __syncthreads();

  float* Kw = Ws + warp * 2 * kRowsPerWarp * kHeadDim;
  float* Vw = Kw + kRowsPerWarp * kHeadDim;
  float* Pw = Ps + warp * 2 * n32 * kRowsPerWarp;
  float* Sw = Pw + n32 * kRowsPerWarp;
  for (int j0 = warp * kRowsPerWarp; j0 < n; j0 += warps * kRowsPerWarp) {
    load_rows4(Kw, kb, sk.n, j0, n, 1.0f, lane);
    load_rows4(Vw, vb, sv.n, j0, n, 1.0f, lane);
    __syncwarp();

    // s[x][kk]: scaled logit of query kk·32 + lane against key j0 + x,
    // summed in the order pass 1 and the forward use; dp likewise.
    float s[kRowsPerWarp][kKeysPerLane], dp[kRowsPerWarp][kKeysPerLane];
    dots4x8(Qs, DOs, Kw, Vw, n, lane, s, dp);
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk) {
      const int i = kk * 32 + lane;
      if (kk * 32 >= n) continue;
      float p[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
      for (int x = 0; x < kRowsPerWarp; ++x) {
        p[x] = i < n && j0 + x < n ? expf(s[x][kk] - Ms[i]) * Is[i] : 0.f;
        ds[x] = i < n ? p[x] * (dp[x][kk] - Ds[i]) : 0.f;  // scale is folded into Qs
      }
      *reinterpret_cast<float4*>(Pw + i * kRowsPerWarp) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(Sw + i * kRowsPerWarp) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();

    float acc_v[kRowsPerWarp][2] = {}, acc_k[kRowsPerWarp][2] = {};
    accumulate_rows(Pw, DOs, n, lane, acc_v);
    accumulate_rows(Sw, Qs, n, lane, acc_k);
#pragma unroll
    for (int x = 0; x < kRowsPerWarp; ++x) {
      const int j = j0 + x;
      if (j >= n) break;
      float* ov = dvb + j * sdv.n;
      float* ok = dkb + j * sdk.n;
      ov[lane] = acc_v[x][0] - DOs[j * kPadDim + lane];
      ov[32 + lane] = acc_v[x][1] - DOs[j * kPadDim + 32 + lane];
      ok[lane] = acc_k[x][0];
      ok[32 + lane] = acc_k[x][1];
    }
    __syncwarp();
  }
}

// ---- B6: small groups, one warp per (group, head) ---------------------------

constexpr int kSmallMaxN = 64;
constexpr int kSmallMaxWarps = 8;

// Floats of shared memory one warp of grand_attn_small_kernel holds: V and
// Q [n][64] (16-byte aligned rows), then K [n][65] rounded up to 4 floats.
__host__ __device__ inline int small_warp_floats(int n) {
  return 2 * n * kHeadDim + ((n * kPadDim + 3) & ~3);
}

// out = softmax(q kᵀ·scale) v − v for pairs (b, h) of [B, H, n, 64]
// operands, n <= 32·kKpl; warp w of block x takes pair x·warps + w.
template <int kKpl>
__global__ void grand_attn_small_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v, float* __restrict__ out,
                                        Strides sq, Strides sk, Strides sv, Strides so,
                                        int pairs, int H, int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * warps + warp;
  if (pair >= pairs) return;  // warps share nothing: no block-wide barrier below
  const int b = pair / H, h = pair % H;
  float* Vs = smem + (size_t)warp * small_warp_floats(n);
  float* Qs = Vs + n * kHeadDim;
  float* Ks = Qs + n * kHeadDim;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = out + b * so.b + h * so.h;

  for (int e = lane; e < n * (kHeadDim / 4); e += 32) {
    const int j = e / (kHeadDim / 4), c4 = (e % (kHeadDim / 4)) * 4;
    const float4 qv = *reinterpret_cast<const float4*>(qb + j * sq.n + c4);
    const float4 kv = *reinterpret_cast<const float4*>(kb + j * sk.n + c4);
    const float4 vv = *reinterpret_cast<const float4*>(vb + j * sv.n + c4);
    *reinterpret_cast<float4*>(Qs + j * kHeadDim + c4) =
        make_float4(qv.x * scale, qv.y * scale, qv.z * scale, qv.w * scale);
    *reinterpret_cast<float4*>(Vs + j * kHeadDim + c4) = vv;
    float* kd = Ks + j * kPadDim + c4;
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
  }
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    const float* qi = Qs + i * kHeadDim;
    float s[kKpl];
#pragma unroll
    for (int kk = 0; kk < kKpl; ++kk) {
      const int j = kk * 32 + lane;
      s[kk] = -INFINITY;
      if (j < n) {
        const float* kr = Ks + j * kPadDim;
        float dot = 0.f;
#pragma unroll 4
        for (int d = 0; d < kHeadDim; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qi + d);
          dot = fmaf(qv.x, kr[d], dot);
          dot = fmaf(qv.y, kr[d + 1], dot);
          dot = fmaf(qv.z, kr[d + 2], dot);
          dot = fmaf(qv.w, kr[d + 3], dot);
        }
        s[kk] = dot;
      }
    }
    float m = s[0];
#pragma unroll
    for (int kk = 1; kk < kKpl; ++kk) m = fmaxf(m, s[kk]);
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKpl; ++kk) {
      s[kk] = kk * 32 + lane < n ? expf(s[kk] - m) : 0.f;
      sum += s[kk];
    }
    const float inv = 1.0f / warp_sum(sum);

    float o0 = 0.f, o1 = 0.f;  // columns lane and 32 + lane
#pragma unroll
    for (int kk = 0; kk < kKpl; ++kk) {
      const int end = n - kk * 32 < 32 ? n - kk * 32 : 32;
      for (int j = 0; j < end; ++j) {
        const float p = __shfl_sync(0xffffffffu, s[kk], j);
        const float* vr = Vs + (kk * 32 + j) * kHeadDim;
        o0 = fmaf(p, vr[lane], o0);
        o1 = fmaf(p, vr[32 + lane], o1);
      }
    }
    float* oi = ob + i * so.n;
    oi[lane] = o0 * inv - Vs[i * kHeadDim + lane];
    oi[32 + lane] = o1 * inv - Vs[i * kHeadDim + 32 + lane];
  }
}

template <int kKpl>
cudaError_t launch_small(const float* q, const float* k, const float* v, float* out, Strides sq,
                         Strides sk, Strides sv, Strides so, int B, int H, int n, float scale,
                         cudaStream_t stream) {
  // As many warps a block as 96 KB of shared memory hold (two blocks an SM).
  int warps = (96 * 1024) / (small_warp_floats(n) * (int)sizeof(float));
  warps = warps < kSmallMaxWarps ? warps : kSmallMaxWarps;
  const size_t bytes = (size_t)warps * small_warp_floats(n) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      grand_attn_small_kernel<kKpl>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int pairs = B * H;
  grand_attn_small_kernel<kKpl><<<(pairs + warps - 1) / warps, 32 * warps, bytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, pairs, H, n, scale);
  return cudaGetLastError();
}

int warps_for(int rows) {
  const int w = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  return w < kMaxWarps ? w : kMaxWarps;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

#define STRIDES(p) Strides{p##_sb, p##_sh, p##_sn}

// B3: out = softmax(q kᵀ·scale) v − v for every (b, h) of [B, H, n, 64]
// operands given by their element strides (sb, sh, sn). One kernel; adds
// one to *launches when it launched. Returns the cudaError_t of the launch.
extern "C" int diff3dhpe_grand_attn_fwd_f32(
    const float* q, const float* k, const float* v, float* out, int B, int H, int n,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = grand::launch_grand_attn(q, k, v, out, STRIDES(q), STRIDES(k),
                                                   STRIDES(v), STRIDES(o), B, H, n, n, scale,
                                                   stream);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// B3 at bf16: the same arguments on bf16 operands, through the tensor-core
// kernel of grand_attn_bf16.cuh (P rounded to bf16 after the normalisation,
// one rounding of P·v − v). Every stride a multiple of 8 elements and every
// base 16-byte aligned (checked by the wrapper).
extern "C" int diff3dhpe_grand_attn_fwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
    int B, int H, int n,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const cudaError_t err = grand::launch_grand_attn_bf16(q, k, v, out, STRIDES(q), STRIDES(k),
                                                        STRIDES(v), STRIDES(o), B, H, n, n, scale,
                                                        stream);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// B6: the same function for small groups, n <= 64 (checked by the
// wrapper), one warp per (b, h). One kernel; adds one to *launches when it
// launched. Returns the cudaError_t of the launch.
extern "C" int diff3dhpe_grand_attn_small_f32(
    const float* q, const float* k, const float* v, float* out, int B, int H, int n,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || n > kSmallMaxN) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      n <= 32 ? launch_small<1>(q, k, v, out, STRIDES(q), STRIDES(k), STRIDES(v), STRIDES(o), B,
                                H, n, scale, stream)
              : launch_small<2>(q, k, v, out, STRIDES(q), STRIDES(k), STRIDES(v), STRIDES(o), B,
                                H, n, scale, stream);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// B4: dq, dk, dv of B3 given dO, as two kernels (the dq pass, then the
// dk/dv pass). stats is scratch of 3·B·H·n floats. Adds one to *launches
// for each kernel launched; returns the first cudaError_t reported.
extern "C" int diff3dhpe_grand_attn_bwd_f32(
    const float* q, const float* k, const float* v, const float* dout, float* dq, float* dk,
    float* dv, float* stats, int B, int H, int n,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long g_sb,
    long long g_sh, long long g_sn, long long dq_sb, long long dq_sh, long long dq_sn,
    long long dk_sb, long long dk_sh, long long dk_sn, long long dv_sb, long long dv_sh,
    long long dv_sn, float scale, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int warps = warps_for(n);
  const dim3 grid(B, H);

  size_t bytes = dq_smem_floats(n, warps) * sizeof(float);
  cudaError_t err = allow_smem(grand_attn_bwd_dq_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  grand_attn_bwd_dq_kernel<<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, dout, dq, stats, STRIDES(q), STRIDES(k), STRIDES(v), STRIDES(g), STRIDES(dq), n,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launches;

  bytes = dkdv_smem_floats(n, warps) * sizeof(float);
  if ((err = allow_smem(grand_attn_bwd_dkdv_kernel, bytes)) != cudaSuccess) return (int)err;
  grand_attn_bwd_dkdv_kernel<<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, dout, stats, dk, dv, STRIDES(q), STRIDES(k), STRIDES(v), STRIDES(g),
      STRIDES(dk), STRIDES(dv), n, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// Head width and the most keys per group the kernels take; the wrappers
// check both before launching.
extern "C" int diff3dhpe_grand_head_dim() { return kHeadDim; }
extern "C" int diff3dhpe_grand_max_n() { return kMaxN; }
// The most keys per group B6 takes.
extern "C" int diff3dhpe_grand_small_max_n() { return kSmallMaxN; }
