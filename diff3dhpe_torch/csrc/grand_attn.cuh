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
// Head widths: every attention kernel of the port takes a width d that is
// a multiple of 8 with 8 <= d <= 128 (takes_head_dim), on the instance of
// the next compiled width, D̂ = 64 for d <= 64, else 128 (instance_head_dim).
// The operands' columns at or past d are zero-filled in shared memory by
// the same cp.async predicate that zero-fills rows past n, and the stores
// are masked to d. A zero column adds exact zeros to every sum, so a width
// gives, bit for bit, what the instance gives on copies of q, k and v
// zero-padded to D̂ with the same scale (the caller's d^-½): shared memory
// holds the same values. The backward (B4) takes 64 and 128 alone
// (bwd_takes_head_dim).
//
// The float32 contraction modes (F32Mode): kHighest is the above;
// kDefault (the MXU's one bf16 pass: operands rounded to bf16, nearest
// even, products exact, f32 sums) and kHigh3 (bf16x3, _dot_f32_3pass) are
// the block kernels' f32 products under JAX's f32_contract_mode
// (diff3dhpe_tpu/ops/fused_block.py:84-164), and kDefault also B3's, B4's
// and B6's under the session matmul precision. The attention forward under
// a mode runs the tensor-core kernel of grand_attn_mode.cuh, and B4 under
// "default" the tensor-core passes of grand_attn_bwd_bf16.cuh; the two
// kernels here, and the micro-tiles B4 shares, are exact f32 alone.
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
// and the work is bound by bytes, not FMAs. Persistent blocks walk the
// (group, head) pairs, a whole pair a stage of a two-stage cp.async ring,
// the next pair's rows landing while the current one computes; a lane holds
// a register micro-tile of the score block over (query, key), so every lane
// works at n = 17. The design is set out above the kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace grand {

constexpr int kMaxN = 256;    // keys per group the kernels take
constexpr int kSmallKeys = 32;     // at or below: the small-group kernel (with <= 64 query rows)
constexpr int kSmallMaxN = 64;     // the most keys the small-group kernel takes (B6)

// True for the head widths the forward kernels take (f32 here, bf16 in
// grand_attn_bf16.cuh, the modes in grand_attn_mode.cuh): a multiple of 8
// (16-byte rows at bf16) up to 128.
__host__ __device__ inline bool takes_head_dim(int d) { return d % 8 == 0 && 8 <= d && d <= 128; }
// The compiled width a forward launch of width d runs on.
__host__ __device__ inline int instance_head_dim(int d) { return d <= 64 ? 64 : 128; }
// True for the head widths the backward kernels (B4) are compiled for.
__host__ __device__ inline bool bwd_takes_head_dim(int d) { return d == 64 || d == 128; }
// load_block's column bound where a block has none (B4's loads).
constexpr int kAllCols = 1 << 30;

// The float32 contraction modes, by the index the wrappers pass.
enum F32Mode { kHighest = 0, kHigh3 = 1, kDefault = 2 };

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
// time; rows at or past n and columns at or past d (the head's width, a
// multiple of 4) are zero-filled. Every thread of the block takes part.
template <int kRows, int kCols>
__device__ __forceinline__ void load_block(float* dst, int ld, const float* src,
                                           long long row_stride, int r0, int c0, int n,
                                           int d = kAllCols) {
  constexpr int kC4 = kCols / 4;
  for (int e = threadIdx.x; e < kRows * kC4; e += blockDim.x) {
    const int r = e / kC4, c = (e % kC4) * 4;
    const bool ok = r0 + r < n && c0 + c < d;
    cp_async16(dst + r * ld + c, src + (ok ? (long long)(r0 + r) * row_stride + c0 + c : 0), ok);
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
                        int q_tiles, float scale, float* __restrict__ stats, int d) {
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
      load_block<kKT, 32>(st, kLdC, kbase, sk.n, t * kKT, 32 * c, n_keys, d);
    } else {
      load_block<L::kVR, D>(st, D + 4, vbase, sv.n, t * kKT + (c - L::kSC) * L::kVR, 0, n_keys,
                            d);
    }
  };
  load_block<kQT, D>(Qs, L::kLdQ, qbase + (long long)q0 * sq.n, sq.n, 0, 0, n_queries - q0, d);
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
      if (32 * c + 4 * tk >= d) continue;  // columns past the head's width
      const float4 vv = ld4(vi + 32 * c);
      *reinterpret_cast<float4*>(oi + 32 * c) =
          make_float4(o[i][4 * c] * inv - vv.x, o[i][4 * c + 1] * inv - vv.y,
                      o[i][4 * c + 2] * inv - vv.z, o[i][4 * c + 3] * inv - vv.w);
    }
  }
}

// ---- small groups: persistent teams walking (group, head) pairs ------------

// Replaces, with grand_attention.cu's B6 entry point,
// diff3dhpe_tpu/ops/attention.py::_packed_grand_attn_kernel (:120-139),
// and serves as the f32 attention step of B1, B2 and B5 for groups of at
// most 32 keys: out = softmax(q kᵀ·scale) v − v on groups of n <= 64 keys.
//
// What bounds it on an H100: bytes. At the spatial eval shape (7,776
// (group, head) pairs of n = 17, D = 64) q, k and v are read once and the
// output written once, 135 MB: 0.040 ms at 3.35 TB/s, against 0.58 GFLOP
// (0.009 ms of f32 FMAs). So the design keeps loads in flight and spends
// little else:
// - Persistent blocks: a block takes one pair at a time, the grid is as
//   many blocks as are resident on the card, each walking pairs blockIdx.x
//   + k·gridDim.x. A two-stage ring in shared memory holds a whole pair a
//   stage (Q, K and V, all query rows): the next pair's rows arrive by
//   16-byte cp.async while the current pair computes, so every resident
//   block has a pair (13 KB at D = 64, n = 17) on its way from device memory.
// - Rows are staged as they lie (D floats, padded by 4 so that the 8 rows
//   a quarter-warp reads at one column fall in distinct bank groups); K is
//   read by the same 128-bit micro-tile loads as the tiled kernel's, not
//   copied and transposed. At n = 17 a stage is 14.7 KB (28.5 at D = 128):
//   6 blocks an SM at D = 64, 3 at D = 128.
// - Lanes: lane (a, b) = (lane / 8, lane % 8) holds a register micro-tile
//   of queries a + 4i (i < kQI) and keys b + 8j (j < KJ) of the score block,
//   so every lane works at n = 17; per 4 columns kQI + KJ loads feed
//   4·kQI·KJ FMAs. The row max and sum are reductions over the row's 8
//   lanes. P goes through the warp's slice of shared memory; for P·V the
//   lane holds the same queries and columns 4b + 32c, so output rows leave
//   as 16-byte stores and "− v" is read from the staged V.
// - A block is a team of up to 4 warps, one for each chunk of kChunk query
//   rows (12 at n <= 24, else 16): at n = 17 two warps share a pair's
//   stages and take 12 x 24 tiles of its 17 x 17 score block, so 12 warps
//   an SM hide each other's shared-memory latency (a warp a pair, 20 x 24
//   tiles and 6 warps an SM, was slower on the card).
// Exactly the f32 branch of JAX's grand_attend_tile: logits summed over d in
// order (the same bits as the tiled kernel's), exact expf, the row max then
// the sum, normalisation after P·V by one IEEE reciprocal: O · (1/l) − v.

// The micro-tile for groups of at most 8·KJ keys (KJ = 3, 4 or 8: n <= 24,
// 32, 64): queries a + 4i (i < kQI) of a chunk of kChunk query rows, keys
// b + 8j (j < KJ).
template <int D, int KJ>
struct SmallTile {
  static constexpr int kQI = KJ == 3 ? 3 : 4;
  static constexpr int kChunk = 4 * kQI;  // 12 query rows (n <= 24), else 16
  static constexpr int kKeys = 8 * KJ;    // keys a micro-tile spans
  static constexpr int kLd = D + 4;       // floats a staged row
  static constexpr int kLdP = (kKeys + 31) / 32 * 32 + 8;  // a row of P, 8 mod 32 banks
  static constexpr int kMaxTeam = 4;      // warps a block
};

// Offsets (floats) in the shared memory of one block: a stage holds Q (nq
// rows), K (n rows) and V (max(nq, n4) rows, n4 = n rounded up to 4; rows
// nq..n4-1 are zeros, read by P·V with P = 0), and is long enough that a
// micro-tile read past Q's or K's last row stays inside it (such rows give
// logits of pad queries, never stored, or of pad keys, masked). Two
// stages, then a P tile [kChunk][kLdP] for each warp of the team.
struct SmallLayout {
  int k, v, stage, p, total;
};

template <int D, int KJ>
__host__ __device__ inline SmallLayout small_layout(int n, int nq, int team) {
  using T = SmallTile<D, KJ>;
  const int n4 = (n + 3) & ~3, v_rows = nq > n4 ? nq : n4;
  const int q_read = (nq + T::kChunk - 1) / T::kChunk * T::kChunk;
  int rows = nq + n + v_rows;
  rows = rows > nq + T::kKeys ? rows : nq + T::kKeys;
  rows = rows > q_read ? rows : q_read;
  SmallLayout L;
  L.k = nq * T::kLd;
  L.v = (nq + n) * T::kLd;
  L.stage = rows * T::kLd;
  L.p = 2 * L.stage;
  L.total = L.p + team * T::kChunk * T::kLdP;
  return L;
}

// out = softmax(q kᵀ·scale) v − v for the B·H·outer pairs (z, b, h)
// of [B, H, n, D] operands (pair = (z·B + b)·H + h; z is the outer index of
// B2's layout, 0 elsewhere) with n_keys keys and n_queries >= n_keys query
// rows. Block x takes pairs x, x + gridDim.x, ...; gridDim.x <= pairs.
template <int D, int KJ>
__global__ void __launch_bounds__(32 * SmallTile<D, KJ>::kMaxTeam)
grand_attn_small_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, Strides sq,
                        Strides sk, Strides sv, Strides so, int pairs, int B, int H,
                        int n_keys, int n_queries, float scale, int d) {
  using T = SmallTile<D, KJ>;
  constexpr int kC = D / 32;   // 4-column groups a lane holds of an output row
  constexpr int kP4 = D / 4;   // 16-byte pieces a row
  extern __shared__ __align__(16) float small_smem[];
  const int team = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = lane >> 3, b = lane & 7;
  const int n = n_keys, nq = n_queries, n4 = (n + 3) & ~3;
  const SmallLayout L = small_layout<D, KJ>(n, nq, team);
  float* Pw = small_smem + L.p + warp * (T::kChunk * T::kLdP);
  const int chunks = (nq + T::kChunk - 1) / T::kChunk;

  // V's rows nq..n4-1 of both stages: zeros, written once (no cp.async
  // writes there).
  const int vpad = n4 > nq ? (n4 - nq) * kP4 : 0;
  for (int e = threadIdx.x; e < 2 * vpad; e += blockDim.x) {
    const int st = e / vpad, r = nq + (e % vpad) / kP4, c4 = (e % kP4) * 4;
    *reinterpret_cast<float4*>(small_smem + st * L.stage + L.v + r * T::kLd + c4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // The element offset of pair p's (b, h[, z]) in an operand.
  auto base = [&](int p, const Strides& s) {
    const int h = p % H, rest = p / H;
    return (long long)(rest % B) * s.b + (long long)h * s.h + (long long)(rest / B) * s.z;
  };
  // Pair p's Q, K and V rows into a stage, by every thread of the block;
  // columns at or past d zero-filled.
  auto issue = [&](int p, float* st) {
    const float* qb = q + base(p, sq);
    const float* kb = k + base(p, sk);
    const float* vb = v + base(p, sv);
    for (int e = threadIdx.x; e < nq * kP4; e += blockDim.x) {
      const int r = e / kP4, c4 = (e % kP4) * 4;
      const bool ok = c4 < d;
      cp_async16(st + r * T::kLd + c4, qb + (ok ? r * sq.n + c4 : 0), ok);
      cp_async16(st + L.v + r * T::kLd + c4, vb + (ok ? r * sv.n + c4 : 0), ok);
    }
    for (int e = threadIdx.x; e < n * kP4; e += blockDim.x) {
      const int r = e / kP4, c4 = (e % kP4) * 4;
      const bool ok = c4 < d;
      cp_async16(st + L.k + r * T::kLd + c4, kb + (ok ? r * sk.n + c4 : 0), ok);
    }
  };

  const int stride = gridDim.x;
  int pair = blockIdx.x;
  issue(pair, small_smem);
  cp_async_commit();
  for (int it = 0; pair < pairs; ++it, pair += stride) {
    const float* st = small_smem + (it & 1) * L.stage;
    if (pair + stride < pairs) issue(pair + stride, small_smem + ((it + 1) & 1) * L.stage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this pair's stage has landed, for every thread
    const float* Ks = st + L.k;
    const float* Vs = st + L.v;
    float* ob = out + base(pair, so);
    for (int c = warp; c < chunks; c += team) {
      const int r0 = c * T::kChunk;
      float s[T::kQI][KJ];
#pragma unroll
      for (int i = 0; i < T::kQI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int cc = 0; cc < D / 32; ++cc) {
        mm_rows<T::kQI, KJ, 4, 8>(s, st + 32 * cc, T::kLd, r0 + a, Ks + 32 * cc, T::kLd, b);
      }
      __syncwarp();  // every lane is done reading the previous chunk's P
      float inv[T::kQI];
#pragma unroll
      for (int i = 0; i < T::kQI; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = b + 8 * j < n ? s[i][j] * scale : -INFINITY;
          mt = fmaxf(mt, s[i][j]);
        }
        const float m = oct_max(mt);  // finite: key 0 is in every row
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float p = expf(s[i][j] - m);
          l += p;
          Pw[(a + 4 * i) * T::kLdP + b + 8 * j] = p;
        }
        inv[i] = 1.0f / oct_sum(l);
      }
      __syncwarp();  // P is complete
      float o[T::kQI][4 * kC];
#pragma unroll
      for (int i = 0; i < T::kQI; ++i)
#pragma unroll
        for (int e = 0; e < 4 * kC; ++e) o[i][e] = 0.f;
      mm_acc<T::kQI, 4, kC, 32>(o, Pw, T::kLdP, a, Vs, T::kLd, b, n4);
#pragma unroll
      for (int i = 0; i < T::kQI; ++i) {
        const int row = r0 + a + 4 * i;
        if (row >= nq) continue;
        const float* vi = Vs + row * T::kLd + 4 * b;
        float* oi = ob + (long long)row * so.n + 4 * b;
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          if (32 * cc + 4 * b >= d) continue;  // columns past the head's width
          const float4 vv = ld4(vi + 32 * cc);
          *reinterpret_cast<float4*>(oi + 32 * cc) =
              make_float4(o[i][4 * cc] * inv[i] - vv.x, o[i][4 * cc + 1] * inv[i] - vv.y,
                          o[i][4 * cc + 2] * inv[i] - vv.z, o[i][4 * cc + 3] * inv[i] - vv.w);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

template <int D, int KJ>
inline cudaError_t launch_small_keys(const float* q, const float* k, const float* v, float* out,
                                     Strides sq, Strides sk, Strides sv, Strides so, int B,
                                     int H, int n_keys, int n_queries, int d, float scale,
                                     cudaStream_t stream, int outer) {
  using T = SmallTile<D, KJ>;
  const int chunks = (n_queries + T::kChunk - 1) / T::kChunk;
  const int team = chunks < T::kMaxTeam ? chunks : T::kMaxTeam;
  const int bytes = small_layout<D, KJ>(n_keys, n_queries, team).total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(grand_attn_small_kernel<D, KJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grand_attn_small_kernel<D, KJ>, 32 * team, bytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long pairs = (long long)B * H * outer;
  if (pairs > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (long long)sms * per_sm < pairs ? sms * per_sm : (int)pairs;
  grand_attn_small_kernel<D, KJ><<<grid, 32 * team, bytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, (int)pairs, B, H, n_keys, n_queries, scale, d);
  return cudaGetLastError();
}

// The small-group kernel on (B, H[, outer]) groups of n_keys <= kSmallMaxN
// keys and n_keys <= n_queries <= kSmallMaxN query rows, head width d
// (takes_head_dim, on the instance_head_dim instance); strides as
// launch_grand_attn's. B6 takes it at n <= 64, the
// block's exact f32 attention step at n <= kSmallKeys.
inline cudaError_t launch_small(const float* q, const float* k, const float* v, float* out,
                                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                                int n_keys, int n_queries, int d, float scale,
                                cudaStream_t stream, int outer = 1) {
  if (n_keys <= 0 || n_keys > kSmallMaxN || n_queries < n_keys || n_queries > kSmallMaxN ||
      !takes_head_dim(d) || B <= 0 || H <= 0 || outer <= 0) {
    return cudaErrorInvalidValue;
  }
#define SMALL_ARGS q, k, v, out, sq, sk, sv, so, B, H, n_keys, n_queries, d, scale, stream, outer
  if (instance_head_dim(d) == 64) {
    return n_keys <= 24   ? launch_small_keys<64, 3>(SMALL_ARGS)
           : n_keys <= 32 ? launch_small_keys<64, 4>(SMALL_ARGS)
                          : launch_small_keys<64, 8>(SMALL_ARGS);
  }
  return n_keys <= 24   ? launch_small_keys<128, 3>(SMALL_ARGS)
         : n_keys <= 32 ? launch_small_keys<128, 4>(SMALL_ARGS)
                        : launch_small_keys<128, 8>(SMALL_ARGS);
#undef SMALL_ARGS
}

// The tiled kernel's instance D (instance_head_dim(d)) at head width d.
template <int D, bool kOuter>
inline cudaError_t launch_tiled(const float* q, const float* k, const float* v, float* out,
                                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                                int n_keys, int n_queries, int d, float scale,
                                cudaStream_t stream, int outer, float* stats) {
  constexpr size_t kBytes = FwdLayout<D>::kFloats * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(grand_attn_tiled_kernel<D, kOuter>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)kBytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (n_queries + kQT - 1) / kQT;
  grand_attn_tiled_kernel<D, kOuter>
      <<<dim3(B * q_tiles, H, outer), kThreads, kBytes, stream>>>(q, k, v, out, sq, sk, sv, so,
                                                                  n_keys, n_queries, q_tiles,
                                                                  scale, stats, d);
  return cudaGetLastError();
}

}  // namespace grand
