// GRAND attention forward at float32 for Hopper (sm_90a), shared by
// fused_block.cu (the attention step of B1, B2 and B5 at f32) and
// grand_attention.cu (B3 and B6 at f32). The bf16 attention is the
// tensor-core kernel of grand_attn_bf16.cuh.
//
//   out[i] = Σ_j softmax_j(q_i·k_j·scale) v_j − v_i
//
// over the first n_keys rows of a group, for its first n_queries rows
// (n_queries >= n_keys: B1's pad query rows attend to the real keys and
// subtract their own v). Every operand is read through element strides
// (group b, head h, row), with unit stride along the head dimension, so B1
// reads q, k and v straight out of its packed qkv [R, 3C] buffer and B3
// reads [G, N, D] tensors or [B, N, 3, H, D] views of a qkv projection
// without a copy. With kOuter a group has a second index, blockIdx.z, with
// its own stride: B2's group (b, j) of the spatial-major rows (b·F + f)·J + j.
//
// One template over the head width D, instantiated for 64 and 128; n_keys
// <= 256. Products in exact f32 FMAs (no TF32), expf and one IEEE
// reciprocal a row, no fast math.
//
// What bounds it on an H100: at B3's train shape (3,264 (group, head) pairs
// of n = 243, D = 64) the two products are 49 GFLOP against 0.8 GB, so
// f32 arithmetic on the CUDA cores bounds it (67 TFLOP/s: 0.74 ms); the
// softmax adds 193 M exponentials (~0.1 ms of issue). On the way there the
// shared-memory pipe is the narrow part: it hands 128 bytes a clock to the
// registers, a lane's 16-byte load taking its share even when the warp's
// lanes read the same address, while the SM issues 128 FMAs a clock. A
// thread must therefore do ~4 FMAs for every float it loads from shared
// memory; a micro-tile of a x b outputs does a·b FMAs per a + b floats.
//
// Design, long groups (grand_attn_tiled_kernel, n_keys > 32):
// - A block of 128 threads takes 64 queries of one (group, head): the grid
//   is (⌈n / 64⌉ · groups, heads[, outer]). Q stays in shared memory. Key
//   tiles of 64 keys stream through a two-stage cp.async ring in chunks of
//   ~8 KB, each 1,024 FMAs a thread: D / 32 logit chunks K[64][32 columns],
//   then value chunks V[2048 / D keys][D]. Rows are padded (D + 4, 36 and 72
//   floats), so the rows a warp reads at one column fall in distinct 16-byte
//   bank groups.
// - Thread (tq, tk) = (tid / 8, tid % 8) holds queries tq + 16i (i < 4) and,
//   of each key tile, keys tk + 8j (j < 8): a 4 x 8 micro-tile of logits
//   (2.7 FMAs a loaded float). For P·V it holds columns 4·tk + 32c (c < D /
//   32) of the same four queries: 4 x D/8 accumulators (2.7 at D = 64, 3.2
//   at D = 128), with P through shared memory.
// - Online softmax over key tiles: the tile's row max (the row's 8 lanes by
//   shuffle) rescales the running sums by expf(m_old − m_new); each thread
//   keeps its own partial row sum, reduced once at the end. The
//   normalisation comes after P·V, as in JAX's f32 branch
//   (ops/attention.py::grand_attend_tile): out = O · (1 / l) − v.
// - Shared memory: Q 64 x (D + 4), two ring stages of 64 x 36 floats, P 64 x
//   72: 70.7 KB at D = 128 (three blocks an SM), 54.3 KB at D = 64 (four).
//
// Small groups (grand_attn_small_kernel, n_keys <= 32 with at most 64 query
// rows; also B6 up to 64 keys): a 64-query tile would leave most of a
// block idle at n = 17 (the spatial blocks: 7,776 pairs at the eval shape),
// so one WARP takes a (group, head) and a block holds several. The warp's
// K (rows padded to D + 1 floats) and V sit in its slice of shared memory;
// lane j owns key j (and 32 + j for n > 32), so a query's scores are one or
// two registers a lane and the softmax is two warp reductions. Four queries
// go at a time (four independent dot products a lane), their rows staged in
// the warp's slice and read as 128-bit broadcasts. For P·V the lanes turn to the head
// dimension (columns 32c + lane) and take each P from its owner by shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace grand {

constexpr int kMaxN = 256;    // keys per group the kernels take
constexpr int kSmallKeys = 32;     // at or below: the small-group kernel (with <= 64 query rows)
constexpr int kSmallMaxN = 64;     // the most keys the small-group kernel takes (B6)

// Element strides of one [B, H, N, D] operand; z is the stride of the
// outer group index (read only by the kOuter kernels).
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

// Sum and max over the 8 lanes that share lane / 8.
__device__ __forceinline__ float oct_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float oct_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes global -> shared, asynchronously; zero-filled where !pred (the
// source is then not read, but must still be a valid address).
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

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc += a · b over four elements, in order.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[0..3] += w · b.
__device__ __forceinline__ void axpy4(float w, float4 b, float* acc) {
  acc[0] = fmaf(w, b.x, acc[0]);
  acc[1] = fmaf(w, b.y, acc[1]);
  acc[2] = fmaf(w, b.z, acc[2]);
  acc[3] = fmaf(w, b.w, acc[3]);
}

__device__ __forceinline__ float lane_of(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows [r0, r0 + kRows) x columns [c0, c0 + kCols) of one head of a
// strided operand into a [kRows][ld] shared tile by cp.async, 16 bytes at a
// time; rows at or past n are zero-filled. Every thread of the block takes
// part.
template <int kRows, int kCols>
__device__ __forceinline__ void load_block(float* dst, int ld, const float* src,
                                           long long row_stride, int r0, int c0, int n) {
  constexpr int kC4 = kCols / 4;
  for (int e = threadIdx.x; e < kRows * kC4; e += blockDim.x) {
    const int r = e / kC4, c = (e % kC4) * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * ld + c, src + (long long)(ok ? r0 + r : 0) * row_stride + c0 + c, ok);
  }
}

// Register micro-tile of a product over 32 columns:
//   s[i][j] += Σ_{d < 32} A[(a0 + kAS·i)·lda + d] · B[(b0 + kBS·j)·ldb + d]
// from 128-bit loads: per 4 columns, kI + kJ loads feed 4·kI·kJ FMAs. Each
// dot product runs over d in order, so every kernel that forms the same
// logit forms the same bits.
template <int kI, int kJ, int kAS, int kBS>
__device__ __forceinline__ void mm_rows(float (&s)[kI][kJ], const float* A, int lda, int a0,
                                        const float* B, int ldb, int b0) {
#pragma unroll
  for (int d = 0; d < 32; d += 4) {
    float4 a[kI];
#pragma unroll
    for (int i = 0; i < kI; ++i) a[i] = ld4(A + (a0 + kAS * i) * lda + d);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float4 b = ld4(B + (b0 + kBS * j) * ldb + d);
#pragma unroll
      for (int i = 0; i < kI; ++i) s[i][j] = dot4(a[i], b, s[i][j]);
    }
  }
}

// Register micro-tile of a product over `rows` (a multiple of 4) rows:
//   o[i][4c + e] += Σ_{r < rows} W[(a0 + kAS·i)·ldw + r] · V[r·ldv + 4·t + kCS·c + e]
// for the thread's kI rows and kC groups of 4 columns; per 4 rows, kI + 4·kC
// loads feed 16·kI·kC FMAs.
template <int kI, int kAS, int kC, int kCS>
__device__ __forceinline__ void mm_acc(float (&o)[kI][4 * kC], const float* W, int ldw, int a0,
                                       const float* V, int ldv, int t, int rows) {
#pragma unroll
  for (int r = 0; r < rows; r += 4) {
    float4 w[kI];
#pragma unroll
    for (int i = 0; i < kI; ++i) w[i] = ld4(W + (a0 + kAS * i) * ldw + r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* vr = V + (r + e) * ldv + 4 * t;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 vv = ld4(vr + kCS * c);
#pragma unroll
        for (int i = 0; i < kI; ++i) axpy4(lane_of(w[i], e), vv, &o[i][4 * c]);
      }
    }
  }
}

// ---- long groups: the tiled kernel -----------------------------------------

constexpr int kQT = 64;       // queries a block of the query-stationary kernels
constexpr int kKT = 64;       // keys a tile
constexpr int kThreads = 128; // threads a block of the tiled kernels (B3 and B4)
constexpr int kLdC = 36;      // row stride of a 32-column chunk

// The chunks a key tile streams through the ring, and the shared memory of
// grand_attn_tiled_kernel in floats. A logit chunk is K[64 keys][32 columns];
// a value chunk is V[kVR keys][D], kVR = 2048 / D, so that every chunk is
// ~8 KB and costs the same 1,024 FMAs a thread.
template <int D>
struct FwdLayout {
  static constexpr int kLdQ = D + 4, kLdP = kKT + 8;
  static constexpr int kSC = D / 32, kVR = 2048 / D, kVC = kKT / kVR;
  static constexpr int kChunks = kSC + kVC;
  static constexpr int kStage = kKT * kLdC > kVR * (D + 4) ? kKT * kLdC : kVR * (D + 4);
  static constexpr int kQ = 0, kRing = kQT * kLdQ, kP = kRing + 2 * kStage;
  static constexpr int kFloats = kP + kQT * kLdP;
};

template <int D, bool kOuter>
__global__ void __launch_bounds__(kThreads)
grand_attn_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, Strides sq,
                        Strides sk, Strides sv, Strides so, int n_keys, int n_queries,
                        int q_tiles, float scale, float* __restrict__ stats) {
  using L = FwdLayout<D>;
  constexpr int kC = D / 32;  // 4-column groups a thread holds of the output
  extern __shared__ __align__(16) float fwd_smem[];
  float* Qs = fwd_smem + L::kQ;
  float* ring = fwd_smem + L::kRing;
  float* Ps = fwd_smem + L::kP;
  const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * kQT, h = blockIdx.y;
  const int tq = threadIdx.x >> 3, tk = threadIdx.x & 7;

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

  const int total = (n_keys + kKT - 1) / kKT * L::kChunks;
  auto issue = [&](int g) {
    float* st = ring + (g & 1) * L::kStage;
    const int t = g / L::kChunks, c = g % L::kChunks;
    if (c < L::kSC) {
      load_block<kKT, 32>(st, kLdC, kbase, sk.n, t * kKT, 32 * c, n_keys);
    } else {
      load_block<L::kVR, D>(st, D + 4, vbase, sv.n, t * kKT + (c - L::kSC) * L::kVR, 0, n_keys);
    }
  };
  load_block<kQT, D>(Qs, L::kLdQ, qbase + (long long)q0 * sq.n, sq.n, 0, 0, n_queries - q0);
  issue(0);
  cp_async_commit();

  float s[4][8], o[4][4 * kC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kC; ++c) o[i][c] = 0.f;
  }

  for (int g = 0; g < total; ++g) {
    cp_async_wait<0>();
    __syncthreads();  // chunk g has landed; every thread is done with chunk g - 1
    if (g + 1 < total) issue(g + 1);
    cp_async_commit();
    const float* st = ring + (g & 1) * L::kStage;
    const int t = g / L::kChunks, c = g % L::kChunks;
    if (c < L::kSC) {  // logits of queries tq + 16i, keys tk + 8j, columns 32c..32c+31
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      }
      mm_rows<4, 8, 16, 8>(s, Qs + 32 * c, L::kLdQ, tq, st, kLdC, tk);
      if (c == L::kSC - 1) {  // the tile's logits are complete: online softmax, P
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = t * kKT + tk + 8 * j < n_keys ? s[i][j] * scale : -INFINITY;
            mt = fmaxf(mt, s[i][j]);
          }
          const float m_new = fmaxf(m[i], oct_max(mt));
          const float alpha = expf(m[i] - m_new);  // 0 on the first tile
          m[i] = m_new;
          l[i] *= alpha;
#pragma unroll
          for (int cc = 0; cc < 4 * kC; ++cc) o[i][cc] *= alpha;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float p = expf(s[i][j] - m_new);
            l[i] += p;
            Ps[(tq + 16 * i) * L::kLdP + tk + 8 * j] = p;
          }
        }
      }
    } else {  // O += P·V over keys (c - kSC)·kVR of the tile
      mm_acc<4, 16, kC, 32>(o, Ps + (c - L::kSC) * L::kVR, L::kLdP, tq, st, D + 4, tk, L::kVR);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / oct_sum(l[i]);
    const int row = q0 + tq + 16 * i;
    if (stats != nullptr && tk == 0) {  // m and 1/l for B4 (rows past n too: finite)
      const size_t plane = (size_t)gridDim.x * kQT * gridDim.y;
      float* st = stats + ((size_t)b * gridDim.y + h) * (q_tiles * kQT) + row;
      st[0] = m[i];
      st[plane] = inv;
    }
    if (row >= n_queries) continue;
    const float* vi = vbase + (long long)row * sv.n + 4 * tk;
    float* oi = obase + (long long)row * so.n + 4 * tk;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float4 vv = ld4(vi + 32 * c);
      *reinterpret_cast<float4*>(oi + 32 * c) =
          make_float4(o[i][4 * c] * inv - vv.x, o[i][4 * c + 1] * inv - vv.y,
                      o[i][4 * c + 2] * inv - vv.z, o[i][4 * c + 3] * inv - vv.w);
    }
  }
}

// ---- small groups: one warp per (group, head) -------------------------------

constexpr int kSmallQueries = 4;   // queries a warp takes at a time
constexpr int kSmallMaxWarps = 8;

// Floats of shared memory one warp of grand_attn_small_kernel holds: Q
// [4][D] and V [n][D] (16-byte aligned rows), then K [n][D + 1] rounded up
// to 4 floats.
__host__ __device__ inline int small_warp_floats(int n, int d) {
  return kSmallQueries * d + n * d + ((n * (d + 1) + 3) & ~3);
}

// out = softmax(q kᵀ·scale) v − v for pairs (b, h) of [B, H, n, D]
// operands with n_keys <= 32·kKpl keys and n_queries rows; warp w of block
// x takes pair x·warps + w (and blockIdx.z as the outer index with kOuter).
template <int D, int kKpl, bool kOuter>
__global__ void grand_attn_small_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v, float* __restrict__ out,
                                        Strides sq, Strides sk, Strides sv, Strides so,
                                        int pairs, int H, int n_keys, int n_queries,
                                        float scale) {
  constexpr int kCols = D / 32;  // columns a lane holds in the P·V product
  constexpr int kQ = kSmallQueries;
  extern __shared__ __align__(16) float small_smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * warps + warp;
  if (pair >= pairs) return;  // warps share nothing: no block-wide barrier below
  const int b = pair / H, h = pair % H, n = n_keys;
  float* Qw = small_smem + (size_t)warp * small_warp_floats(n, D);
  float* Vs = Qw + kQ * D;
  float* Ks = Vs + n * D;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = out + b * so.b + h * so.h;
  if constexpr (kOuter) {
    const long long z = blockIdx.z;
    qb += z * sq.z;
    kb += z * sk.z;
    vb += z * sv.z;
    ob += z * so.z;
  }

  for (int e = lane; e < n * (D / 4); e += 32) {
    const int j = e / (D / 4), c4 = (e % (D / 4)) * 4;
    const float4 kv = ld4(kb + j * sk.n + c4);
    *reinterpret_cast<float4*>(Vs + j * D + c4) = ld4(vb + j * sv.n + c4);
    float* kd = Ks + j * (D + 1) + c4;
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
  }
  __syncwarp();

  for (int i0 = 0; i0 < n_queries; i0 += kQ) {
    // Query rows past n_queries are zeros and are not stored.
#pragma unroll
    for (int e = lane; e < kQ * (D / 4); e += 32) {
      const int x = e / (D / 4), c4 = (e % (D / 4)) * 4;
      *reinterpret_cast<float4*>(Qw + x * D + c4) =
          i0 + x < n_queries ? ld4(qb + (i0 + x) * sq.n + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    float s[kQ][kKpl];
#pragma unroll
    for (int kk = 0; kk < kKpl; ++kk) {
      const int j = kk * 32 + lane;
      float dot[kQ] = {};
      if (j < n) {
        const float* kr = Ks + j * (D + 1);
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 kv = make_float4(kr[d], kr[d + 1], kr[d + 2], kr[d + 3]);
#pragma unroll
          for (int x = 0; x < kQ; ++x) dot[x] = dot4(ld4(Qw + x * D + d), kv, dot[x]);
        }
      }
#pragma unroll
      for (int x = 0; x < kQ; ++x) s[x][kk] = j < n ? dot[x] * scale : -INFINITY;
    }
    float inv[kQ];
#pragma unroll
    for (int x = 0; x < kQ; ++x) {
      float m = s[x][0];
#pragma unroll
      for (int kk = 1; kk < kKpl; ++kk) m = fmaxf(m, s[x][kk]);
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKpl; ++kk) {
        s[x][kk] = kk * 32 + lane < n ? expf(s[x][kk] - m) : 0.f;
        sum += s[x][kk];
      }
      inv[x] = 1.0f / warp_sum(sum);
    }

    float o[kQ][kCols] = {};  // columns 32c + lane
#pragma unroll
    for (int kk = 0; kk < kKpl; ++kk) {
      const int end = n - kk * 32 < 32 ? n - kk * 32 : 32;
      for (int j = 0; j < end; ++j) {
        const float* vr = Vs + (kk * 32 + j) * D + lane;
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vr[32 * c];
#pragma unroll
        for (int x = 0; x < kQ; ++x) {
          const float p = __shfl_sync(0xffffffffu, s[x][kk], j);
#pragma unroll
          for (int c = 0; c < kCols; ++c) o[x][c] = fmaf(p, vv[c], o[x][c]);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < kQ; ++x) {
      const int i = i0 + x;
      if (i >= n_queries) break;
      const float* vi = vb + i * sv.n + lane;
      float* oi = ob + i * so.n + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) oi[32 * c] = o[x][c] * inv[x] - vi[32 * c];
    }
    __syncwarp();  // Qw is rewritten next
  }
}

template <int D, int kKpl, bool kOuter>
inline cudaError_t launch_small(const float* q, const float* k, const float* v, float* out,
                                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                                int n_keys, int n_queries, float scale, cudaStream_t stream,
                                int outer) {
  // As many warps a block as 72 KB of shared memory hold (three blocks an SM).
  const int warp_bytes = small_warp_floats(n_keys, D) * (int)sizeof(float);
  int warps = (72 * 1024) / warp_bytes;
  warps = warps < kSmallMaxWarps ? warps : kSmallMaxWarps;
  warps = warps > 0 ? warps : 1;
  const size_t bytes = (size_t)warps * warp_bytes;
  const cudaError_t err = cudaFuncSetAttribute(grand_attn_small_kernel<D, kKpl, kOuter>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
  if (err != cudaSuccess) return err;
  const int pairs = B * H;
  grand_attn_small_kernel<D, kKpl, kOuter>
      <<<dim3((pairs + warps - 1) / warps, 1, outer), 32 * warps, bytes, stream>>>(
          q, k, v, out, sq, sk, sv, so, pairs, H, n_keys, n_queries, scale);
  return cudaGetLastError();
}

template <int D, bool kOuter>
inline cudaError_t launch_tiled(const float* q, const float* k, const float* v, float* out,
                                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                                int n_keys, int n_queries, float scale, cudaStream_t stream,
                                int outer, float* stats = nullptr) {
  constexpr size_t kBytes = FwdLayout<D>::kFloats * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(grand_attn_tiled_kernel<D, kOuter>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)kBytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (n_queries + kQT - 1) / kQT;
  grand_attn_tiled_kernel<D, kOuter><<<dim3(B * q_tiles, H, outer), kThreads, kBytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, n_keys, n_queries, q_tiles, scale, stats);
  return cudaGetLastError();
}

// True for the head widths the kernels are compiled for (f32 here, bf16 in
// grand_attn_bf16.cuh).
__host__ __device__ inline bool takes_head_dim(int d) { return d == 64 || d == 128; }

// Launches the f32 attention on (B, H[, outer]) groups of n_keys keys and
// n_queries >= n_keys query rows at head width d (64 or 128), n_keys <=
// kMaxN: the small-group kernel for n_keys <= 32 (and at most 64 query
// rows), else the tiled kernel. Every stride a multiple of 4 floats and
// every base 16-byte aligned (checked by the callers). With stats (the
// tiled kernel only, no outer index) it also writes each row's max m and
// 1/l into the two [B·H, n64] planes of B4's statistics.
template <bool kOuter = false>
inline cudaError_t launch_grand_attn(const float* q, const float* k, const float* v, float* out,
                                     Strides sq, Strides sk, Strides sv, Strides so, int B,
                                     int H, int n_keys, int n_queries, int d, float scale,
                                     cudaStream_t stream, int outer = 1, float* stats = nullptr) {
  if (n_keys <= 0 || n_keys > kMaxN || n_queries < n_keys || !takes_head_dim(d) ||
      (stats != nullptr && (kOuter || n_keys <= kSmallKeys))) {
    return cudaErrorInvalidValue;
  }
#define GRAND_F32_ARGS q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, scale, stream, outer
  if (n_keys <= kSmallKeys && n_queries <= kSmallMaxN) {
    return d == 64 ? launch_small<64, 1, kOuter>(GRAND_F32_ARGS)
                   : launch_small<128, 1, kOuter>(GRAND_F32_ARGS);
  }
  return d == 64 ? launch_tiled<64, kOuter>(GRAND_F32_ARGS, stats)
                 : launch_tiled<128, kOuter>(GRAND_F32_ARGS, stats);
#undef GRAND_F32_ARGS
}

}  // namespace grand
