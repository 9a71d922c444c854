// bf16 GRAND attention backward on Hopper's warpgroup matrix multiply
// (sm_90a): B4 at bf16 (grand_attention.cu), head width 64 or 128, n <= 256;
// and, with f32 outputs (TO = float), B4 at f32 under the session
// precision "default" on bf16-rounded copies of its f32 operands.
//
// Replaces diff3dhpe_tpu/ops/attention.py::_grand_attn_bwd_kernel on bf16
// operands (its tile _grand_attn_bwd_tile, :275-300, under
// grand_attention_bwd_pallas) and keeps its rounding points. Per (group,
// head) pair:
//   S  = q·kᵀ summed in f32, P = softmax(S·scale) in f32, pad keys masked
//   dP = dO·vᵀ summed in f32, Dᵢ = Σⱼ dPᵢⱼ Pᵢⱼ in f32
//   dS = bf16(P ∘ (dP − D) · scale),  P̃ = bf16(P)
//   dq = bf16(dS·k),  dk = bf16(dSᵀ·q)   (f32 sums)
//   dv = bf16(P̃ᵀ·dO − dO)                 (f32 sum and difference, one rounding)
// With TO = float the outputs leave the f32 accumulators unrounded and dv's
// "− dO" takes the f32 dO (JAX's tile under "default": dot(pq, do) − dof,
// diff3dhpe_tpu/ops/attention.py:298); every other rounding point is the
// same, which is what "default" asks of an f32 backward. There S and dP are
// summed k16 step by k16 step in f32 (wgmma_ss_promoted): the tensor cores'
// own sums over a whole row part from exact f32 sums by enough to turn single
// bf16 roundings of dS the other way (2^-8 of a term of dq or dk). Measured
// at chip_smoke.py phase 21b's draws against S and dP summed exactly
// (utils/mode_attn_profile.py --parts bwd; H100 80GB HBM3, 700 W): with the
// tensor cores' own sums max 1.719e-3 of max|oracle| at d = 64 (the bar is
// 1e-3) and 7.57e-4 at d = 128, 1.313 and 1.136 ms; promoted 8.25e-4 and
// 8.35e-4, 1.520 and 1.301 ms.
// P is exp(S·scale − max·scale) times the row's 1/sum, both statistics in
// K1's (grand_attn_bf16.cuh) order of operations: the trainable forward's
// K1 writes them, and B4 called without them forms them in its dq pass
// (wgmma gives q·kᵀ the bits of K1's mma.sync, and the second warpgroup
// continues the first one's per-lane sums in key order), so both calls give
// the same bits. D is summed in f32 in another order than the plain
// version's; that flips single bf16 roundings of dS, within the bf16 bars
// (max 1e-2, mean 1e-3 of max|plain|).
//
// What bounds it on an H100: at the train shapes (G = B·H = 3,264 pairs of
// N = 243 at d = 64, or 1,632 at d = 128) the formulas' five products are
// 10·G·N²·d = 123 GFLOP (0.125 ms at 989 TFLOP/s) and q, k, v, dO, dq, dk,
// dv are 0.71 GB (0.21 ms at 3.35 TB/s): bytes bound it. PR 10's kernels
// on mma.sync took 1.38–1.39 ms: 16·N²·d FLOP issued from 8 warps an SM,
// time proportional to N², nothing overlapping the staging. What holds
// these kernels is the work between the products: a wgmma group's latency
// before the N² exponentials and score epilogues of each tile can start,
// and, in the dq pass, the two warpgroups meeting twice a tile.
//
// Design: two kernels, no atomics (the same inputs give the same bits),
// 14·N²·d FLOP, every product on wgmma. Both are persistent (one block an
// SM walks the work items) with a producer warpgroup, whose one thread
// keeps TMA loads in flight into mbarrier rings, and two consumer
// warpgroups; setmaxnreg moves the producer's registers to the consumers
// (40 and 232 a thread). TMA reads the strided [B, H, N, D] views through
// 4-D tensor maps into 128-byte-swizzled tiles of 64 columns (two panels
// at d = 128) and zero-fills rows at or past n; wgmma reads them as K-major
// operands (q·kᵀ and the like) and as MN-major ones (dS·k, P̃ᵀ·dO, dSᵀ·q),
// with A from registers where it is a score block just formed.
//   1. dq pass, query-major: a block holds one pair's K and V (a ring of
//      one or two pairs) and walks its 64-query tiles, each with that
//      tile's Q, dO and statistics from a 2- or 3-stage ring. Warpgroup w
//      takes keys [w·KW, w·KW + KW) (KW = 64 for n <= 128, else 128): S
//      and dP by wgmma, P from the statistics (or the row max and sum,
//      exchanged in shared memory), the row's partial Σ P∘dP, which the
//      two warpgroups add in shared memory (D, written out for pass 2), dS
//      packed into A fragments, and dq's partial dS·K. Each warpgroup hands
//      the other half of its f32 partial through the stage's Q and dO
//      tiles (free by then), adds the other's half to its own and rounds
//      once: 6·N²·d FLOP.
//   2. dk/dv pass, key-major: a block holds 128 keys of K and V (a ring of
//      two), warpgroup w 64 of them with dK and dV in registers, and walks
//      the pair's 64-query tiles: Sᵀ and dPᵀ by wgmma, Pᵀ and dSᵀ from the
//      statistics and D, then dV += P̃ᵀ·dO and dK += dSᵀ·Q with A from
//      registers: 8·N²·d FLOP. dv's "− dO" reads the keys' own dO rows in
//      the epilogue.
// Queuing the next tile's S and dP behind this tile's last products (a
// software pipeline in both passes) measured 12–13% slower at d = 64 on an
// H100 at 700 W, so each tile waits for its own products.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_wgmma.cuh"
#include "grand_attn_bf16.cuh"

namespace grand {
namespace tcb {

using bf16 = __nv_bfloat16;
using wg::fence_regs;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;

constexpr int kRows = kBwdTileRows;      // queries a tile
constexpr int kConsumerThreads = 256;    // two consumer warpgroups
constexpr int kThreads = 128 + kConsumerThreads;  // after the producer warpgroup
// Registers a thread after setmaxnreg: the producer gives up what the
// consumers take (128·40 + 256·232 <= 65,536).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kPanelBytes = 128;         // a swizzled row: 64 bf16
constexpr int kSmemLimit = 232448;       // what a block may take on sm_90

// ---- wgmma: fences, groups, and the products at the widths used here ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a 128-byte-swizzled bf16 tile read MN-major (the N index
// contiguous in a 128-byte row, K along the rows): 8-row groups 1024 bytes
// apart, 64-column panels lbo bytes apart. wg::make_desc is the K-major one.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x N] += a[64 x 16] · b[N x 16]ᵀ, both K-major in shared memory
// (acc = 0: d = a·bᵀ).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);
// d[64 x N] += a[64 x 16] · b[16 x N], a from registers (the A fragments of
// mma.m16n8k16, a warp's 16 rows each), b MN-major in shared memory.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15"
      " }, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      " }, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63"
      " }, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      " }, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63"
      " }, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[64 x N] = A · Bᵀ over kSteps k16 steps of K-major 128-byte-swizzled
// tiles, A's 64 rows at a and B's N rows at b (64-column panels pa and pb
// bytes apart), for S and dP at f32 outputs: each k16 step of each 32
// columns is its own wgmma group, summed by the tensor cores into t and
// added to d in f32, rounding to nearest. The tensor cores drop the bits
// below their accumulator's last place at every step, which over a whole
// row of d parts S and dP from f32 sums by enough to turn single bf16
// roundings of dS and P the other way. Each group is waited for.
template <int N, int kSteps>
__device__ __forceinline__ void wgmma_ss_promoted(float (&d)[N / 2], uint32_t a, int pa, uint32_t b,
                                                  int pb) {
#pragma unroll
  for (int c = 0; c < N / 32; ++c) {
#pragma unroll
    for (int kd = 0; kd < kSteps; ++kd) {
      float t[16];
      wgmma_fence();
      wgmma_ss<32>(t, wg::make_desc(a + (kd / 4) * pa + (kd % 4) * 32),
                   wg::make_desc(b + c * 32 * kPanelBytes + (kd / 4) * pb + (kd % 4) * 32), 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 16; ++i) d[16 * c + i] = kd == 0 ? t[i] : d[16 * c + i] + t[i];
    }
  }
}

// ---- TMA ----

// One box of a 4-D tensor map into shared memory; completion on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// Rows [row0, row0 + box rows) of head (b, h), all D columns, as D / 64
// panels of [box rows][64] (panel stride box_rows · 128 bytes). With swap
// the map's second and third dimensions are (h, row).
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int box_rows, int row0, int h, int b, bool swap) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
    tma_load_4d(dst + p * box_rows * kPanelBytes, map, bar, p * 64, swap ? h : row0,
                swap ? row0 : h, b);
  }
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kConsumerThreads) : "memory");
}
// Generic-proxy writes to shared memory made visible to later TMA writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The warp's lanes are done with a buffer: lane 0 arrives on its barrier.
__device__ __forceinline__ void warp_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// dS = bf16(P ∘ (dP − D) · scale), in JAX's order of operations.
__device__ __forceinline__ float bwd_ds(float p, float dp, float dsum, float scale) {
  return p * (dp - dsum) * scale;
}

// Two neighbouring values of an output row: bf16 rounded once (nearest
// even), or float; and two of dO's, as float.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The mbarriers of a kernel: a ring of `stages` tiles and one of `slots`
// pairs' keys, each a full and an empty barrier.
struct Bars {
  uint32_t full, empty, kv_full, kv_empty;
};
__device__ __forceinline__ Bars init_bars(uint32_t at, int stages, int slots) {
  const Bars b{at, at + 8 * stages, at + 16 * stages, at + 16 * stages + 8 * slots};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(b.full + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(b.empty + 8 * s, 8);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < slots; ++s) {
      mbar_init(b.kv_full + 8 * s, 1);
      mbar_init(b.kv_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return b;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// ---- pass 1: dq and D ----

// Shared memory of the dq pass: `slots` pairs' K and V, each [D / 64][2·KW
// keys][64]; `stages` tiles of Q and dO, each [D / 64][64][64]; the tiles'
// −max·scale and 1/sum [stages][2][64]; the warpgroups' exchanges: partial
// D and row maxima [2][2][64], the first group's partial sums [128][2], the
// rows' 1/sum [64].
template <int D, int KW>
struct DqLayout {
  static constexpr int kKeyBytes = D * 2 * KW * 2;  // K (or V) of a pair
  static constexpr int kSlot = 2 * kKeyBytes;
  static constexpr int kTile = D * kRows * 2;  // Q (or dO) of a tile
  static constexpr int kStage = 2 * kTile;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kSlots = 2 * kSlot + kStages * kStage + 8192 <= kSmemLimit ? 2 : 1;
  static constexpr int kStats = kSlots * kSlot + kStages * kStage;
  static constexpr int kXchg = kStats + kStages * 2 * kRows * 4;
  static constexpr int kXchgFloats = 4 * kRows + 256 + kRows;
  static constexpr int kBars = kXchg + kXchgFloats * 4;
  static constexpr int kBytes = kBars + 16 * (kStages + kSlots) + 1024;  // + alignment
  static_assert(kBytes <= kSmemLimit, "the dq pass fits a block");
  static_assert(kStage >= kRows * D * 4, "a stage holds the f32 exchange of dq");
};

// Pass 1 on pairs blockIdx.x, blockIdx.x + gridDim.x, ... (b = pair / H,
// h = pair % H). stats: [pairs][nt][3][64] floats. With kOwnStats the pass
// forms each row's −max·scale and 1/sum itself, in K1's order of operations
// (the max over both groups' keys; the sum of each lane's columns in key
// order, the second group continuing the first group's partial sums, then
// across the row's four lanes), and writes them; else it reads them. It
// writes D. dq: [B, H, n, D] of TO (bf16 or float) by strides.
template <int D, int KW, bool kOwnStats, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
grand_attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               float* __restrict__ stats, TO* __restrict__ dq, Strides sdq,
                               int H, int n, int nt, int pairs, int swap, float scale) {
  using L = DqLayout<D, KW>;
  extern __shared__ unsigned char bwd_dq_raw[];
  unsigned char* smem = align1024(bwd_dq_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t stages0 = base + L::kSlots * L::kSlot;
  float* st_ring = reinterpret_cast<float*>(smem + L::kStats);
  float* xd = reinterpret_cast<float*>(smem + L::kXchg);  // partial D [2][64]
  float* xm = xd + 2 * kRows;                             // row maxima [2][64]
  float* xs = xm + 2 * kRows;                             // first group's sums [128][2]
  float* xr = xs + 256;                                   // 1/sum [64]
  const Bars bars = init_bars(base + L::kBars, L::kStages, L::kSlots);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < 4) {
    // ---- producer warpgroup: lane 0 of warp 0 keeps both rings full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != 0 || lane != 0) return;
    int c = 0, it = 0;
    for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++it) {
      const int b = pair / H, h = pair % H;
      for (int qt = 0; qt < nt; ++qt, ++c) {
        const int s = c % L::kStages;
        mbar_wait(bars.empty + 8 * s, ((c / L::kStages) & 1) ^ 1);
        const uint32_t full = bars.full + 8 * s, dst = stages0 + s * L::kStage;
        mbar_expect_tx(full, L::kStage + (kOwnStats ? 0 : 2 * kRows * 4));
        load_rows<D>(dst, &map_q, full, kRows, qt * kRows, h, b, swap & 1);
        load_rows<D>(dst + L::kTile, &map_do, full, kRows, qt * kRows, h, b, swap & 8);
        if (!kOwnStats) {
          bulk_load(smem_u32(st_ring + s * 2 * kRows),
                    stats + ((size_t)pair * nt + qt) * kBwdStatFloats, 2 * kRows * 4, full);
        }
        if (qt == 0) {  // the pair's keys after its first tile, which may load sooner
          const int slot = it % L::kSlots;
          mbar_wait(bars.kv_empty + 8 * slot, ((it / L::kSlots) & 1) ^ 1);
          const uint32_t kv_full = bars.kv_full + 8 * slot, kdst = base + slot * L::kSlot;
          mbar_expect_tx(kv_full, L::kSlot);
          load_rows<D>(kdst, &map_k, kv_full, 2 * KW, 0, h, b, swap & 2);
          load_rows<D>(kdst + L::kKeyBytes, &map_v, kv_full, 2 * KW, 0, h, b, swap & 4);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ---- consumers: warpgroup wgi takes keys [wgi·KW, wgi·KW + KW) ----
  const int wgi = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // the thread's rows r0 and r0 + 8 of a tile
  const int key0 = wgi * KW + 2 * t;   // the thread's first key; then + 8·j + (e & 1)
  const bool edge = wgi * KW + KW > n;  // the group's keys reach past n
  constexpr int kKPanel = 2 * KW * kPanelBytes;  // panel stride of K and V
  constexpr int kQPanel = kRows * kPanelBytes;   // panel stride of Q and dO
  int c = 0, it = 0;
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++it) {
    const int b = pair / H, h = pair % H;
    const int slot = it % L::kSlots;
    mbar_wait(bars.kv_full + 8 * slot, (it / L::kSlots) & 1);
    const uint32_t kw = base + slot * L::kSlot + wgi * KW * kPanelBytes;  // this group's keys
    const uint32_t vw = kw + L::kKeyBytes;
    for (int qt = 0; qt < nt; ++qt, ++c) {
      const int s = c % L::kStages;
      mbar_wait(bars.full + 8 * s, (c / L::kStages) & 1);
      const uint32_t qb = stages0 + s * L::kStage, gb = qb + L::kTile;
      float* tile_stats = stats + ((size_t)pair * nt + qt) * kBwdStatFloats;

      // S = Q·Kᵀ and dP = dO·Vᵀ for the group's keys, two wgmma groups.
      float sc[KW / 2], dp[KW / 2];
      if constexpr (std::is_same_v<TO, float>) {  // B4 at f32: each k16 step added in f32
        wgmma_ss_promoted<KW, D / 16>(sc, qb, kQPanel, kw, kKPanel);
        wgmma_ss_promoted<KW, D / 16>(dp, gb, kQPanel, vw, kKPanel);
      } else {
#pragma unroll
        for (int i = 0; i < KW / 2; ++i) sc[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int off = (kd / 4) * kQPanel + (kd % 4) * 32;
          const int koff = (kd / 4) * kKPanel + (kd % 4) * 32;
          wgmma_ss<KW>(sc, wg::make_desc(qb + off), wg::make_desc(kw + koff), 1);
        }
        wgmma_commit();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int off = (kd / 4) * kQPanel + (kd % 4) * 32;
          const int koff = (kd / 4) * kKPanel + (kd % 4) * 32;
          wgmma_ss<KW>(dp, wg::make_desc(gb + off), wg::make_desc(vw + koff), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
      }

      // P = exp(S·scale − max·scale) · (1 / sum), zero at pad keys.
      float nm0, nm1, rs0, rs1;
      if constexpr (kOwnStats) {
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (edge && key0 + 8 * j + (e & 1) >= n) sc[4 * j + e] = -INFINITY;
          }
          m0 = fmaxf(m0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          m1 = fmaxf(m1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        if (t == 0) {
          xm[wgi * kRows + r0] = m0;
          xm[wgi * kRows + r0 + 8] = m1;
        }
        named_sync(3);
        nm0 = fmaxf(xm[r0], xm[kRows + r0]) * -scale;
        nm1 = fmaxf(xm[r0 + 8], xm[kRows + r0 + 8]) * -scale;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          sc[4 * j] = expf(fmaf(sc[4 * j], scale, nm0));
          sc[4 * j + 1] = expf(fmaf(sc[4 * j + 1], scale, nm0));
          sc[4 * j + 2] = expf(fmaf(sc[4 * j + 2], scale, nm1));
          sc[4 * j + 3] = expf(fmaf(sc[4 * j + 3], scale, nm1));
        }
        // The same lane of the other group holds the same columns mod KW.
        const int lid = threadIdx.x & 127;
        if (wgi == 1) {
          named_sync(4);
          sum0 = xs[2 * lid];
          sum1 = xs[2 * lid + 1];
        }
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          sum0 += sc[4 * j] + sc[4 * j + 1];
          sum1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        if (wgi == 0) {
          xs[2 * lid] = sum0;
          xs[2 * lid + 1] = sum1;
          named_sync(4);
        } else {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
          if (t == 0) {
            xr[r0] = 1.0f / sum0;
            xr[r0 + 8] = 1.0f / sum1;
            tile_stats[r0] = nm0;
            tile_stats[r0 + 8] = nm1;
            tile_stats[kRows + r0] = 1.0f / sum0;
            tile_stats[kRows + r0 + 8] = 1.0f / sum1;
          }
        }
        named_sync(5);
        rs0 = xr[r0];
        rs1 = xr[r0 + 8];
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          sc[4 * j] *= rs0;
          sc[4 * j + 1] *= rs0;
          sc[4 * j + 2] *= rs1;
          sc[4 * j + 3] *= rs1;
        }
      } else {
        const float* st = st_ring + s * 2 * kRows;
        nm0 = st[r0], nm1 = st[r0 + 8], rs0 = st[kRows + r0], rs1 = st[kRows + r0 + 8];
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * j + e] =
                expf(fmaf(sc[4 * j + e], scale, e < 2 ? nm0 : nm1)) * (e < 2 ? rs0 : rs1);
            if (edge && key0 + 8 * j + (e & 1) >= n) sc[4 * j + e] = 0.f;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);

      // D = Σ P ∘ dP over the row: the group's part, then both groups'.
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        d0 += sc[4 * j] * dp[4 * j] + sc[4 * j + 1] * dp[4 * j + 1];
        d1 += sc[4 * j + 2] * dp[4 * j + 2] + sc[4 * j + 3] * dp[4 * j + 3];
      }
      d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
      d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
      if (t == 0) {
        xd[wgi * kRows + r0] = d0;
        xd[wgi * kRows + r0 + 8] = d1;
      }
      named_sync(1);
      const float D0 = xd[r0] + xd[kRows + r0], D1 = xd[r0 + 8] + xd[kRows + r0 + 8];
      if (wgi == 0 && t == 0) {
        tile_stats[2 * kRows + r0] = D0;
        tile_stats[2 * kRows + r0 + 8] = D1;
      }

      // dS as the A fragments of dS·K: 16 keys a fragment.
      uint32_t a[KW / 16][4];
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        const float* p = sc + 8 * kk;
        const float* q = dp + 8 * kk;
        a[kk][0] = mma::pack_bf16(bwd_ds(p[0], q[0], D0, scale), bwd_ds(p[1], q[1], D0, scale));
        a[kk][1] = mma::pack_bf16(bwd_ds(p[2], q[2], D1, scale), bwd_ds(p[3], q[3], D1, scale));
        a[kk][2] = mma::pack_bf16(bwd_ds(p[4], q[4], D0, scale), bwd_ds(p[5], q[5], D0, scale));
        a[kk][3] = mma::pack_bf16(bwd_ds(p[6], q[6], D1, scale), bwd_ds(p[7], q[7], D1, scale));
      }

      // The group's partial dq = dS·K (K read MN-major: keys along the depth).
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        wgmma_rs<D>(acc, a[kk], desc_mn(kw + kk * 16 * kPanelBytes, kKPanel), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (qt == nt - 1) warp_release(bars.kv_empty + 8 * slot, lane);  // K and V read

      // Both groups' partials added in a fixed order through the stage's
      // Q and dO tiles, read for the last time above: group 0 finishes
      // columns [0, D/2), group 1 the rest. float[64][D], 8-float chunks
      // XOR-swizzled by the row (two wavefronts a warp's float2 access).
      float* xq = reinterpret_cast<float*>(smem + L::kSlots * L::kSlot + s * L::kStage);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if ((j < D / 16) != (wgi == 0)) {
          const int col = ((j ^ (r0 & 7)) << 3) + 2 * t;
          *reinterpret_cast<float2*>(xq + r0 * D + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(xq + (r0 + 8) * D + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      named_sync(2);
      TO* out = dq + b * sdq.b + h * sdq.h;
      const int row0 = qt * kRows + r0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if ((j < D / 16) == (wgi == 0)) {
          const int col = ((j ^ (r0 & 7)) << 3) + 2 * t;
          const float2 o0 = *reinterpret_cast<const float2*>(xq + r0 * D + col);
          const float2 o1 = *reinterpret_cast<const float2*>(xq + (r0 + 8) * D + col);
          if (row0 < n) {
            store2(out + row0 * sdq.n + 8 * j + 2 * t, acc[4 * j] + o0.x, acc[4 * j + 1] + o0.y);
          }
          if (row0 + 8 < n) {
            store2(out + (row0 + 8) * sdq.n + 8 * j + 2 * t, acc[4 * j + 2] + o1.x,
                   acc[4 * j + 3] + o1.y);
          }
        }
      }
      fence_proxy_async();  // the stage's next contents come by TMA
      warp_release(bars.empty + 8 * s, lane);
    }
  }
}

// ---- pass 2: dk and dv ----

// Shared memory of the dk/dv pass: two work items' keys, K and V each
// [D / 64][128][64]; `stages` tiles of Q and dO, each [D / 64][64][64];
// the tiles' −max·scale, 1/sum and D [stages][3][64].
template <int D>
struct DkdvLayout {
  static constexpr int kKeys = 128;  // keys a work item
  static constexpr int kKeyBytes = D * kKeys * 2;
  static constexpr int kSlot = 2 * kKeyBytes;
  static constexpr int kSlots = 2;
  static constexpr int kTile = D * kRows * 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kStats = kSlots * kSlot + kStages * kStage;
  static constexpr int kBars = kStats + kStages * kBwdStatFloats * 4;
  static constexpr int kBytes = kBars + 16 * (kStages + kSlots) + 1024;
  static_assert(kBytes <= kSmemLimit, "the dk/dv pass fits a block");
};

// Pass 2 on work items blockIdx.x, blockIdx.x + gridDim.x, ...: item =
// pair·nkb + key block (128 keys), over all nt query tiles of the pair.
// dout: dO of TO by strides (its rows at the keys, for dv's "− dO"); dk,
// dv: TO (bf16 or float).
template <int D, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
grand_attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const float* __restrict__ stats, const TO* __restrict__ dout,
                                 TO* __restrict__ dk, TO* __restrict__ dv, Strides sdo,
                                 Strides sdk, Strides sdv, int H, int n, int nt, int nkb,
                                 int items, int swap, float scale) {
  using L = DkdvLayout<D>;
  extern __shared__ unsigned char bwd_dkdv_raw[];
  unsigned char* smem = align1024(bwd_dkdv_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t stages0 = base + L::kSlots * L::kSlot;
  const float* st_ring = reinterpret_cast<const float*>(smem + L::kStats);
  const Bars bars = init_bars(base + L::kBars, L::kStages, L::kSlots);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != 0 || lane != 0) return;
    int c = 0, it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int pair = item / nkb, kb = item % nkb, b = pair / H, h = pair % H;
      for (int qt = 0; qt < nt; ++qt, ++c) {
        const int s = c % L::kStages;
        mbar_wait(bars.empty + 8 * s, ((c / L::kStages) & 1) ^ 1);
        const uint32_t full = bars.full + 8 * s, dst = stages0 + s * L::kStage;
        mbar_expect_tx(full, L::kStage + kBwdStatFloats * 4);
        load_rows<D>(dst, &map_q, full, kRows, qt * kRows, h, b, swap & 1);
        load_rows<D>(dst + L::kTile, &map_do, full, kRows, qt * kRows, h, b, swap & 8);
        bulk_load(smem_u32(st_ring + s * kBwdStatFloats),
                  stats + ((size_t)pair * nt + qt) * kBwdStatFloats, kBwdStatFloats * 4, full);
        if (qt == 0) {
          const int slot = it % L::kSlots;
          mbar_wait(bars.kv_empty + 8 * slot, ((it / L::kSlots) & 1) ^ 1);
          const uint32_t kv_full = bars.kv_full + 8 * slot, kdst = base + slot * L::kSlot;
          mbar_expect_tx(kv_full, L::kSlot);
          load_rows<D>(kdst, &map_k, kv_full, L::kKeys, kb * L::kKeys, h, b, swap & 2);
          load_rows<D>(kdst + L::kKeyBytes, &map_v, kv_full, L::kKeys, kb * L::kKeys, h, b,
                       swap & 4);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ---- consumers: warpgroup wgi takes keys 64·wgi ... + 63 of the item ----
  const int wgi = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  constexpr int kKPanel = L::kKeys * kPanelBytes, kQPanel = kRows * kPanelBytes;
  int c = 0, it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int pair = item / nkb, kb = item % nkb, b = pair / H, h = pair % H;
    const int slot = it % L::kSlots;
    mbar_wait(bars.kv_full + 8 * slot, (it / L::kSlots) & 1);
    const uint32_t kw = base + slot * L::kSlot + wgi * 64 * kPanelBytes;
    const uint32_t vw = kw + L::kKeyBytes;
    float dva[D / 2], dka[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;
    for (int qt = 0; qt < nt; ++qt, ++c) {
      const int s = c % L::kStages;
      mbar_wait(bars.full + 8 * s, (c / L::kStages) & 1);
      const uint32_t qb = stages0 + s * L::kStage, gb = qb + L::kTile;
      const float* st = st_ring + s * kBwdStatFloats;  // −max·scale, 1/sum, D of the queries
      const int q_end = n - qt * kRows;  // queries of the tile below n: all where >= 64

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: the group's 64 keys by the tile's 64 queries.
      float sc[kRows / 2], dp[kRows / 2];
      if constexpr (std::is_same_v<TO, float>) {  // B4 at f32: each k16 step added in f32
        wgmma_ss_promoted<kRows, D / 16>(sc, kw, kKPanel, qb, kQPanel);
        wgmma_ss_promoted<kRows, D / 16>(dp, vw, kKPanel, gb, kQPanel);
      } else {
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) sc[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int koff = (kd / 4) * kKPanel + (kd % 4) * 32;
          const int qoff = (kd / 4) * kQPanel + (kd % 4) * 32;
          wgmma_ss<kRows>(sc, wg::make_desc(kw + koff), wg::make_desc(qb + qoff), 1);
        }
        wgmma_commit();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int koff = (kd / 4) * kKPanel + (kd % 4) * 32;
          const int qoff = (kd / 4) * kQPanel + (kd % 4) * 32;
          wgmma_ss<kRows>(dp, wg::make_desc(vw + koff), wg::make_desc(gb + qoff), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
      }
      // Pᵀ from the queries' statistics, zero at pad queries.
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 nm = *reinterpret_cast<const float2*>(st + col);
        const float2 rs = *reinterpret_cast<const float2*>(st + kRows + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = expf(fmaf(sc[4 * j + e], scale, (e & 1) ? nm.y : nm.x)) *
                          ((e & 1) ? rs.y : rs.x);
          if (q_end < kRows && col + (e & 1) >= q_end) sc[4 * j + e] = 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dSᵀ, then P̃ᵀ and dSᵀ as A fragments: 16 queries a fragment.
      uint32_t pa[kRows / 16][4], da[kRows / 16][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 dd = *reinterpret_cast<const float2*>(st + 2 * kRows + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = bwd_ds(sc[4 * j + e], dp[4 * j + e], (e & 1) ? dd.y : dd.x, scale);
          if (q_end < kRows && col + (e & 1) >= q_end) dp[4 * j + e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        const float* p = sc + 8 * kk;
        const float* d = dp + 8 * kk;
        pa[kk][0] = mma::pack_bf16(p[0], p[1]);
        pa[kk][1] = mma::pack_bf16(p[2], p[3]);
        pa[kk][2] = mma::pack_bf16(p[4], p[5]);
        pa[kk][3] = mma::pack_bf16(p[6], p[7]);
        da[kk][0] = mma::pack_bf16(d[0], d[1]);
        da[kk][1] = mma::pack_bf16(d[2], d[3]);
        da[kk][2] = mma::pack_bf16(d[4], d[5]);
        da[kk][3] = mma::pack_bf16(d[6], d[7]);
      }
      // dV += P̃ᵀ·dO and dK += dSᵀ·Q (dO and Q read MN-major).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma_rs<D>(dva, pa[kk], desc_mn(gb + 16 * kk * kPanelBytes, kQPanel), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma_rs<D>(dka, da[kk], desc_mn(qb + 16 * kk * kPanelBytes, kQPanel), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      warp_release(bars.empty + 8 * s, lane);
    }
    warp_release(bars.kv_empty + 8 * slot, lane);

    // dv = TO(P̃ᵀ·dO − dO) at the keys' own dO rows, dk = TO(dSᵀ·Q).
    const int key0 = kb * L::kKeys + 64 * wgi + 16 * (warp & 3) + g;
    const TO* gsrc = dout + b * sdo.b + h * sdo.h;
    TO* dko = dk + b * sdk.b + h * sdk.h;
    TO* dvo = dv + b * sdv.b + h * sdv.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= n) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 gv = load2(gsrc + key * sdo.n + col);
        store2(dvo + key * sdv.n + col, dva[4 * j + 2 * half] - gv.x,
               dva[4 * j + 2 * half + 1] - gv.y);
        store2(dko + key * sdk.n + col, dka[4 * j + 2 * half], dka[4 * j + 2 * half + 1]);
      }
    }
  }
}

// ---- host side ----

// Tensor map of one [B, H, n, D] bf16 operand by element strides, read in
// boxes of box_rows x 64 in the 128-byte swizzle; rows past n read as
// zero. The dimensions go in order of stride: (d, row, h, b), or (d, h,
// row, b) where the heads lie closer than the rows (*swapped set).
inline bool make_head_map(CUtensorMap* map, const bf16* base, Strides s, int B, int H, int n,
                          int d, int box_rows, bool* swapped) {
  const wg::EncodeTiledFn encode = wg::encode_tiled();
  if (!encode) return false;
  *swapped = s.h < s.n;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(*swapped ? H : n),
                              (cuuint64_t)(*swapped ? n : H), (cuuint64_t)B};
  const long long s1 = *swapped ? s.h : s.n, s2 = *swapped ? s.n : s.h;
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(*swapped ? 1 : box_rows),
                             (cuuint32_t)(*swapped ? box_rows : 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return count;
}

// The four operands' maps at one box height, and which of them are swapped.
struct HeadMaps {
  CUtensorMap q, k, v, g;
  int swap;
};
inline bool make_maps(HeadMaps* m, const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                      Strides sq, Strides sk, Strides sv, Strides sg, int B, int H, int n, int d,
                      int key_rows) {
  bool sw[4];
  if (!make_head_map(&m->q, q, sq, B, H, n, d, kRows, &sw[0]) ||
      !make_head_map(&m->k, k, sk, B, H, n, d, key_rows, &sw[1]) ||
      !make_head_map(&m->v, v, sv, B, H, n, d, key_rows, &sw[2]) ||
      !make_head_map(&m->g, g, sg, B, H, n, d, kRows, &sw[3])) {
    return false;
  }
  m->swap = (sw[0] ? 1 : 0) | (sw[1] ? 2 : 0) | (sw[2] ? 4 : 0) | (sw[3] ? 8 : 0);
  return true;
}

template <int D, int KW, bool kOwnStats, typename TO>
inline cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                             float* stats, TO* dq, Strides sq, Strides sk, Strides sv,
                             Strides sdo, Strides sdq, int B, int H, int n, float scale,
                             int sms, cudaStream_t stream) {
  using L = DqLayout<D, KW>;
  // The runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread may have none), which encoding a
  // tensor map needs.
  const auto kernel = grand_attn_bwd_dq_wgmma_kernel<D, KW, kOwnStats, TO>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  HeadMaps m;
  if (!make_maps(&m, q, k, v, dout, sq, sk, sv, sdo, B, H, n, D, 2 * KW)) {
    return cudaErrorInvalidValue;
  }
  const int pairs = B * H, nt = (n + kRows - 1) / kRows;
  kernel<<<pairs < sms ? pairs : sms, kThreads, L::kBytes, stream>>>(
      m.q, m.k, m.v, m.g, stats, dq, sdq, H, n, nt, pairs, m.swap, scale);
  return cudaGetLastError();
}

// g: dO as the tensor maps read it (bf16); dres: dO for dv's "− dO".
template <int D, typename TO>
inline cudaError_t launch_dkdv(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                               const TO* dres, const float* stats, TO* dk, TO* dv, Strides sq,
                               Strides sk, Strides sv, Strides sg, Strides sres, Strides sdk,
                               Strides sdv, int B, int H, int n, float scale, int sms,
                               cudaStream_t stream) {
  using L = DkdvLayout<D>;
  const auto kernel = grand_attn_bwd_dkdv_wgmma_kernel<D, TO>;  // as launch_dq: this call first
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  HeadMaps m;
  if (!make_maps(&m, q, k, v, g, sq, sk, sv, sg, B, H, n, D, L::kKeys)) {
    return cudaErrorInvalidValue;
  }
  const int nt = (n + kRows - 1) / kRows, nkb = (n + L::kKeys - 1) / L::kKeys;
  const int items = B * H * nkb;
  kernel<<<items < sms ? items : sms, kThreads, L::kBytes, stream>>>(
      m.q, m.k, m.v, m.g, stats, dres, dk, dv, sres, sdk, sdv, H, n, nt, nkb, items, m.swap,
      scale);
  return cudaGetLastError();
}

}  // namespace tcb

// B4's tensor-core passes on (B, H) pairs of n <= kMaxN rows at head width
// D, on bf16 q, k, v and g (dO), with outputs of TO: bf16 (B4 at bf16), or
// float (B4 at f32 under "default", on rounded copies of f32 operands).
// dres: dO for dv's "− dO" by strides sres (g itself at bf16, the f32 dO
// at float). stats: [B·H][nt][3][64] floats (nt = n rounded up to 64, over
// 64); with have_stats it holds each row's −max·scale and 1/sum from the
// forward's K1, else the dq pass forms and writes them. The dq pass (which
// adds D), then the dk/dv pass. Adds one to *launches for each kernel
// launched; returns the first cudaError_t reported.
template <int D, typename TO>
inline cudaError_t launch_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, const __nv_bfloat16* g, const TO* dres,
                                   TO* dq, TO* dk, TO* dv, float* stats, bool have_stats,
                                   Strides sq, Strides sk, Strides sv, Strides sg, Strides sres,
                                   Strides sdq, Strides sdk, Strides sdv, int B, int H, int n,
                                   float scale, int* launches, cudaStream_t stream) {
  const int sms = tcb::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  cudaError_t err;
#define DQ_ARGS q, k, v, g, stats, dq, sq, sk, sv, sg, sdq, B, H, n, scale, sms, stream
  if (have_stats) {
    err = n <= 128 ? tcb::launch_dq<D, 64, false, TO>(DQ_ARGS)
                   : tcb::launch_dq<D, 128, false, TO>(DQ_ARGS);
  } else {
    err = n <= 128 ? tcb::launch_dq<D, 64, true, TO>(DQ_ARGS)
                   : tcb::launch_dq<D, 128, true, TO>(DQ_ARGS);
  }
#undef DQ_ARGS
  if (err != cudaSuccess) return err;
  ++*launches;
  err = tcb::launch_dkdv<D, TO>(q, k, v, g, dres, stats, dk, dv, sq, sk, sv, sg, sres, sdk, sdv, B,
                                H, n, scale, sms, stream);
  if (err != cudaSuccess) return err;
  ++*launches;
  return cudaSuccess;
}

}  // namespace grand
