// All-pairs score kernels for Hopper (sm_90a), int8 and bf16.
//
// Replaces the TPU kernels of apsim_tpu/ops/pallas_score.py,
// apsim_tpu/ops/panel.py and apsim_tpu/ops/panel_mesh.py:
//   score_bits_int8        <- _kernel_int8       (pallas_score_bits_int8)
//   score_bits_bf16        <- _kernel            (pallas_score_bits)
//   panel_score_bits_int8  <- _kernel_int8_cross (panel_score_bits_int8)
//   int8_matmul            <- _mm_kernel         (_int8_matmul)
// and, as kernels 5 and 6, the epilogues XLA builds behind the products of
// the mesh panel join and the stripe joins (no Pallas kernel; see
// pair_bits_kernel below):
//   pair_bits_int8         <- psum + int8_bound_mask + bitpack_mask
//   pair_bits_f32          <- psum + (s >= tau_eff) + bitpack_mask
// and, as kernel 7, the compaction of their hits (see compact_bits below):
//   compact_bits           <- _compact_bits (pallas_score.py:320, XLA ops)
// and peer_copy, one copy between cards for collectives.gather_rows (no
// kernel: the runtime's asynchronous peer copy, queued without the events
// and stream switches of torch's copy_ between cards).
//
// The score kernels.  For every block p of a block list (bi[p], bj[p])
// they score the tm x tn tile Xi[bi*tm:, :] . Xj[bj*tn:, :]^T over all of
// K, admit a cell when its score clears tau_eff AND its GLOBAL row is below
// its GLOBAL column, and write the same hit structure as the TPU kernels:
//   gb  [n_blocks, tm/8,  tn] uint8  bit o of byte (g, c) = row g*8+o
//   g64 [n_blocks, tm/64, tn] uint8  any hit among the 64 rows of a super
//   cnt [n_blocks, 3]         int32  (pairs, hit groups, hit supers)
// Global coordinates are the local ones plus a per-launch offset
// (off_row, off_col): the panel origins of a cross-panel rectangle, or 0
// for the dense upper triangle, which is the same launch with Xj = Xi.  An
// optional valid[n_blocks] (null = all valid) blanks a block: it writes
// zero bytes and adds no counts.  Every gb/g64 byte of every block is
// written (the wrappers allocate them with torch.empty); cnt must be zero
// on entry: counts are added with int32 atomicAdd, which is
// order-independent, so the totals are exact.
//
// int8 epilogue (pallas_score.py:478-483, panel.py:int8_bound_mask):
//   D = q_i . q_j in int32,  s_hat = D * (a_i a_j),
//   bound = 0.5 (a_j b_i + a_i b_j) + 0.25 (a_i a_j) min(n_i, n_j)
//   hit  <=>  s_hat + bound >= tau_eff.
// Written with __fmul_rn/__fadd_rn in exactly that order (and built with
// --fmad=false), so no FMA contraction: gb/g64/cnt are bit-identical to the
// plain PyTorch version.  The int32 accumulator is neither widened nor
// saturated; the engines only take this path while 127^2 * max_nnz < 2^30.
//
// bf16 epilogue (pallas_score.py:_kernel): hit <=> acc >= tau_eff, acc the
// fp32 sum of the bf16 products.  The tensor cores sum in their own order,
// so a cell whose score lies at tau_eff may differ from the plain version;
// the engine's margin (tau_eff = tau - margin) is orders of magnitude wider.
//
// int8_matmul (kernel 4) is the per-shard partial dot of the mesh panel
// join: out = xi . xj^T in int32 over the full m x n grid, no block list,
// no epilogue but the int32 stores.
//
// What bounds the kernels.  At the main paths' shapes (32,768 int8 or bf16
// elements of K per row; 4,096 for kernel 4 on eight shards) they do
// 2 * rows * cols * K operations on (rows + cols) * K operand elements plus
// their outputs: 1,600-5,500 operations per byte of HBM traffic in int8
// and half that in bf16, far above the card's ~590 and ~295 (1,979 TOPS
// and 989 TFLOP/s over 3.35 TB/s), so tensor-core operations bound all
// four.  What stands between a kernel and that bound is how fast operands
// reach the tensor cores, so one design serves both operand types (a row
// is a string of bytes to the loads; 128 bytes of K are 128 int8 or 64
// bf16 elements, and both wgmma forms eat 32 bytes of K per instruction):
//   - thread-block tiles of 128 x 256 (two consumer warpgroups of 64 x 256
//     each, 171 cells per operand byte of L2 traffic), or 64 x 128 (one
//     consumer warpgroup) for block tiles the large one does not divide
//     (chosen by shape: tm % 128 == 0 and tn % 256 == 0, or m and n for
//     kernel 4);
//   - one producer thread (its warpgroup gives up its registers) streams
//     one 128-byte K slice of both operand panels per stage with TMA
//     (byte tensor maps, 128-byte swizzle) into a ring of stages (4 of
//     48 KB, or 8 of 24 KB) with full / empty mbarriers, so loads run
//     ahead of the multiplies and no __syncthreads sits in the loop;
//   - wgmma.mma_async m64n256k32 (m64n128k32) s8.s8 -> s32, or m64n256k16
//     (m64n128k16) bf16.bf16 -> f32, both operands K-major from
//     shared-memory descriptors, one wgmma group in flight while the next
//     stage's is issued; setmaxnreg gives the consumers 232 registers (the
//     128 accumulators of n = 256) and the producer 40;
//   - persistent: one thread block per SM draws tiles from a global
//     counter (atomicAdd), the ring's phase carried from tile to tile, so
//     one tile's epilogue overlaps the next tile's loads and the tiles in
//     flight stay a contiguous window of the list: their operand panels
//     are shared in L2.  (A static round-robin let blocks drift apart over
//     the 128 tiles each has in the 32,768-row triangle, and kernel 1
//     varied from 25 to 47 ms between launches on an H100 80GB HBM3 at
//     700 W.)  Score kernels walk their sub-tiles in block-list order (row
//     panel major), the live sub-tiles first (the wrapper's list), so a
//     sub-tile below the diagonal costs its zero bytes and no loads; kernel
//     4 walks its grid in groups of 8 row tiles.
// The wgmma accumulator fragment is the same for s32 and f32: warp w of a
// warpgroup, lane 4g+t, holds rows 16w+g and 16w+g+8, columns 8j+2t and
// 8j+2t+1 of every 8-column block j.  So one bit-pack epilogue serves both:
// warp shuffles into a shared [8][cols] byte tile per
// warpgroup (64 rows: one super-group), which its 128 threads write out
// column-coalesced with the counts.  The aux rows the int8 epilogue
// thresholds with are loaded into registers before the K loop and staged in
// shared memory after it: read from global memory inside the epilogue,
// their latency stalled both warpgroups and cost kernel 3 a fifth of its
// time on the same card.  The bf16 epilogue has no aux rows.
// What still separates the kernels from the operations bound (H100 80GB
// HBM3, 700 W; PERF.md): kernel 4 at 1 shard runs at 80-90 % of peak;
// kernels 1 and 2 compute whole 128 x 256 tiles across the diagonal, where
// the bound counts only strict-upper cells; the score epilogue and the
// per-tile ring drain are not overlapped with the next tile's multiplies
// (one accumulator set per warpgroup).

#include <cstdint>
#include <climits>
#include <cstring>
#include <cuda.h>
#include <cuda_runtime.h>
#include <mutex>

namespace {

// The int8 epilogue's admit test for one cell: acc the int32 dot, (ai, bi,
// ni) / (aj, bj, nj) the aux rows (alpha, alpha * L1(q), nnz) of its row
// and column.
__device__ __forceinline__ bool int8_hit(int acc, float ai, float bi,
                                         float ni, float aj, float bj,
                                         float nj, float tau) {
  const float aa = __fmul_rn(ai, aj);
  const float s_hat = __fmul_rn(__int2float_rn(acc), aa);
  const float bound =
      __fadd_rn(__fmul_rn(0.5f, __fadd_rn(__fmul_rn(aj, bi), __fmul_rn(ai, bj))),
                __fmul_rn(__fmul_rn(0.25f, aa), fminf(ni, nj)));
  return __fadd_rn(s_hat, bound) >= tau;
}

// ------------------------------------------- TMA ring + wgmma mainloop

constexpr int KSTAGE = 128;        // bytes of K per ring stage (one
                                   // 128-byte swizzle row per operand row)
constexpr int RING_BYTES = 196608; // 192 KB of the SM's 227 KB

// A thread-block tile: NC consumer warpgroups of 64 rows x BN columns and
// one producer warpgroup (one thread issues the loads).
template <int NC_, int BN_>
struct Tile {
  static constexpr int NC = NC_;
  static constexpr int BM = 64 * NC_;
  static constexpr int BN = BN_;
  static constexpr int THREADS = 128 * (NC_ + 1);
  static constexpr int A_BYTES = BM * KSTAGE;
  static constexpr int STAGE_BYTES = (BM + BN) * KSTAGE;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  static constexpr int BITS_BYTES = 8 * BN;  // per consumer: [8][BN] bytes
  static constexpr int AUX = 64 + BN;        // per consumer: aux of its 64
  static constexpr int AUX_BYTES = 12 * AUX; // rows and BN columns, [3][AUX]
  static constexpr int WG_BYTES = BITS_BYTES + AUX_BYTES;
  // barriers: full / empty per stage, then full / empty per tile slot
  static constexpr int BAR_BYTES = 16 * STAGES + 32;
  // 1 KB of slack to align the ring to the 1,024-byte swizzle atom; the
  // two tile slots' ids last
  static constexpr int SMEM =
      1024 + RING_BYTES + NC * WG_BYTES + BAR_BYTES + 8;
};
using Big = Tile<2, 256>;    // 128 x 256, 4 stages of 48 KB
using Small = Tile<1, 128>;  // 64 x 128, 8 stages of 24 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one box [rows, 128 bytes] of a 2-D byte tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor of a K-major operand tile written by TMA
// with 128-byte swizzle: rows of 128 bytes, 8-row atoms 1,024 bytes apart
// (SBO), layout type 1 (128B swizzle); the leading offset is unused for
// this layout.  Adding 2 advances the start by 32 bytes: one k32 step of
// int8, one k16 step of bf16.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it sees each register as rewritten here)
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The accumulator registers of one wgmma, as the asm template names them
// and as operands with constraint C ("+r" for s32, "+f" for f32).
#define REGS_0_63 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define REGS_64_127 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define ACC8(C, d, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), \
  C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define ACC64(C, d, i) \
  ACC8(C, d, i), ACC8(C, d, i + 8), ACC8(C, d, i + 16), ACC8(C, d, i + 24), \
  ACC8(C, d, i + 32), ACC8(C, d, i + 40), ACC8(C, d, i + 48), \
  ACC8(C, d, i + 56)

// d += A[64 x 32 bytes] . B[N x 32 bytes]^T, both K-major from
// shared-memory descriptors; d is the m64nN accumulator of this thread
// (N = 2 x its length).  32 bytes of K are one k32 step of s8 x s8 -> s32
// or one k16 step of bf16 x bf16 -> f32.  The bf16 form also takes the
// immediates scale-a, scale-b (1: no negation) and trans-a, trans-b (0:
// K-major; a wrong bit gives plausible, wrong sums, not a fault).
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      REGS_0_63 ", " REGS_64_127
      "}, %128, %129, p;\n}\n"
      : ACC64("+r", d, 0), ACC64("+r", d, 64)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      REGS_0_63
      "}, %64, %65, p;\n}\n"
      : ACC64("+r", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      REGS_0_63 ", " REGS_64_127
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC64("+f", d, 0), ACC64("+f", d, 64)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      REGS_0_63
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64("+f", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

// The persistent warp-specialized mainloop of all four kernels.  Tiles
// are handed out dynamically: the producer takes the next tile index from
// *next_tile (zero on entry) with atomicAdd and passes it to the consumers
// through two shared slots with their own full / empty barriers, so the
// tiles in flight on the card stay a contiguous window of the list (their
// operand panels shared in L2) however far one block falls behind.  Job
// gives the accumulator type Acc (int: s8 operands, float: bf16) and the
// tile list: n_tiles, tile(t, ar, br) -> live (operand rows of
// the tile's row 0 and column 0; a dead tile is not loaded); prefetch(t,
// live, ar, br, wg, tid, pre) issues the epilogue's global loads into
// registers before the K loop, so their latency hides behind it; and
// epilogue(t, live, ar, br, wg, warp, lane, acc, pre, wg_smem), where
// wg_smem is the warpgroup's own WG_BYTES of shared memory.
template <class T, class Job>
__global__ void __launch_bounds__(T::THREADS, 1)
ring_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, int k_stages,
            int* __restrict__ next_tile, const Job job) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* wg_smem0 = smem_raw + (ring - raw) + RING_BYTES;
  const uint32_t full0 = ring + RING_BYTES + T::NC * T::WG_BYTES;
  const uint32_t empty0 = full0 + 8 * T::STAGES;
  const uint32_t tfull0 = empty0 + 8 * T::STAGES;  // tile slot k & 1 ...
  const uint32_t tempty0 = tfull0 + 16;
  volatile int* slot_tile = reinterpret_cast<volatile int*>(
      wg_smem0 + T::NC * T::WG_BYTES + T::BAR_BYTES);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);               // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * T::NC);      // one arrive per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(tfull0 + 8 * s, 1);
      mbar_init(tempty0 + 8 * s, 4 * T::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::NC) {
    // producer warpgroup: one thread keeps the ring full
    if constexpr (T::NC > 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    }
    if (threadIdx.x == T::NC * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0;; ++k) {
        const int t = atomicAdd(next_tile, 1);
        mbar_wait(tempty0 + 8 * (k & 1), ((k >> 1) & 1) ^ 1);
        slot_tile[k & 1] = t;
        mbar_arrive(tfull0 + 8 * (k & 1));
        if (t >= job.n_tiles) break;
        int ar, br;
        if (!job.tile(t, ar, br)) continue;
        for (int s = 0; s < k_stages; ++s) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = ring + stage * T::STAGE_BYTES;
          mbar_expect_tx(full, T::STAGE_BYTES);
          tma_load(a, &map_a, full, s * KSTAGE, ar);
          tma_load(a + T::A_BYTES, &map_b, full, s * KSTAGE, br);
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each tile
    if constexpr (T::NC > 1) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    }
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    int stage = 0;
    uint32_t phase = 0;
    for (int k = 0;; ++k) {
      mbar_wait(tfull0 + 8 * (k & 1), (k >> 1) & 1);
      const int t = slot_tile[k & 1];
      __syncwarp();
      if (lane == 0) mbar_arrive(tempty0 + 8 * (k & 1));
      if (t >= job.n_tiles) break;
      int ar, br;
      const bool live = job.tile(t, ar, br);
      typename Job::Pre pre;
      job.prefetch(t, live, ar, br, wg, threadIdx.x & 127, pre);
      typename Job::Acc acc[T::BN / 2];
#pragma unroll
      for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0;
      fence_acc(acc);
      if (live && k_stages > 0) {
        int prev = 0;
        for (int s = 0; s < k_stages; ++s) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t a = ring + stage * T::STAGE_BYTES;
          const uint64_t da = sw128_desc(a + wg * 64 * KSTAGE);
          const uint64_t db = sw128_desc(a + T::A_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KSTAGE / 32; ++kk)
            wgmma(acc, da + 2 * kk, db + 2 * kk);
          wgmma_commit();
          // the previous stage's group is done: release its slot
          wgmma_wait<1>();
          if (s > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
          prev = stage;
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
      job.epilogue(t, live, ar, br, wg, warp, lane, acc, pre,
                   wg_smem0 + wg * T::WG_BYTES);
    }
  }
}

// The admit test of a score kernel: the accumulator type, whether the test
// reads aux rows, and hit(acc, saux, ri, cj, tau) for the cell of row entry
// ri and column entry cj of the warpgroup's staged aux rows saux [3][AUX].
struct Int8Op {
  using Acc = int;
  static constexpr bool kAux = true;
  template <int AUX>
  static __device__ __forceinline__ bool hit(int acc, const float* saux,
                                             int ri, int cj, float tau) {
    return int8_hit(acc, saux[ri], saux[AUX + ri], saux[2 * AUX + ri],
                    saux[cj], saux[AUX + cj], saux[2 * AUX + cj], tau);
  }
};
struct Bf16Op {
  using Acc = float;
  static constexpr bool kAux = false;
  template <int AUX>
  static __device__ __forceinline__ bool hit(float acc, const float*, int,
                                             int, float tau) {
    return acc >= tau;
  }
};

// Kernels 1, 2 and 3: the sub-tiles of the block list, threshold +
// bit-pack.
template <class T, class Op>
struct ScoreJob {
  using Acc = typename Op::Acc;
  int n_tiles;
  const int* tiles;  // sub-tile ids (p * sub_m + cm) * sub_n + cn
  const int* bi;
  const int* bj;
  const int* valid;  // or null
  int sub_m, sub_n, tm, tn, off_row, off_col;
  const float* aux_i;
  const float* aux_j;
  int rows_i, rows_j;
  float tau;
  uint8_t* gb;
  uint8_t* g64;
  int* cnt;

  __device__ __forceinline__ void decode(int t, int& p, int& cm,
                                         int& cn) const {
    int id = tiles[t];
    cn = id % sub_n;
    id /= sub_n;
    cm = id % sub_m;
    p = id / sub_m;
  }

  // no cell with row < col when the smallest global row is >= the largest
  // global column; an invalid block has no cell at all
  __device__ __forceinline__ bool tile(int t, int& ar, int& br) const {
    int p, cm, cn;
    decode(t, p, cm, cn);
    ar = bi[p] * tm + cm * T::BM;
    br = bj[p] * tn + cn * T::BN;
    return (valid == nullptr || valid[p] != 0) &&
           off_row + ar < off_col + br + T::BN - 1;
  }

  // the aux rows (alpha, alpha * L1(q), nnz) of the warpgroup's 64 rows
  // and the tile's BN columns: entry i < 64 is row ar + 64 wg + i, entry
  // 64 + c column br + c; thread tid loads entries tid + 128 k (no entries
  // without Op::kAux: Pre is then never touched and costs no register)
  static constexpr int NPRE = (T::AUX + 127) / 128;
  struct Pre {
    float v[3][NPRE];
  };

  __device__ __forceinline__ void prefetch(int, bool live, int ar, int br,
                                           int wg, int tid, Pre& pre) const {
#pragma unroll
    for (int k = 0; k < NPRE; ++k) {
      const int i = tid + 128 * k;
      if (Op::kAux && live && i < T::AUX) {
        const bool row = i < 64;
        const float* src = row ? aux_i : aux_j;
        const long long n = row ? rows_i : rows_j;
        const int r = row ? ar + wg * 64 + i : br + i - 64;
#pragma unroll
        for (int a = 0; a < 3; ++a) pre.v[a][k] = __ldg(src + a * n + r);
      }
    }
  }

  template <int R>
  __device__ __forceinline__ void epilogue(int t, bool live, int ar, int br,
                                           int wg, int warp, int lane,
                                           const Acc (&acc)[R],
                                           const Pre& pre,
                                           uint8_t* wg_smem) const {
    uint8_t* sbits = wg_smem;  // [8][BN] hit bytes
    float* saux = reinterpret_cast<float*>(wg_smem + T::BITS_BYTES);
    const int tid = warp * 32 + lane;
    if constexpr (Op::kAux) {
      if (live) {
#pragma unroll
        for (int k = 0; k < NPRE; ++k) {
          const int i = tid + 128 * k;
          if (i < T::AUX) {
#pragma unroll
            for (int a = 0; a < 3; ++a) saux[a * T::AUX + i] = pre.v[a][k];
          }
        }
      }
      named_sync(1 + wg, 128);
    }
    int p, cm, cn;
    decode(t, p, cm, cn);
    const int g = lane >> 2, q = lane & 3;
    const int lr = warp * 16 + g;  // the warpgroup's rows lr, lr + 8
    const int row0 = off_row + ar + wg * 64, col0 = off_col + br;  // global
    // element e of column block j: row lr + 8 (e / 2), column
    // 8 j + 2 q + (e % 2); its bit in the group byte is g
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      uint32_t w = 0;
      if (live) {
        const int lc = 8 * j + 2 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = lr + 8 * (e >> 1), cj = 64 + lc + (e & 1);
          const bool hit =
              (row0 + ri < col0 + lc + (e & 1)) &&
              Op::template hit<T::AUX>(acc[4 * j + e], saux, ri, cj, tau);
          w |= (uint32_t)hit << (8 * e + g);
        }
      }
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      w |= __shfl_xor_sync(0xffffffffu, w, 8);
      w |= __shfl_xor_sync(0xffffffffu, w, 16);
      if (g == 0) {
        const int lc = 8 * j + 2 * q;
        uint8_t* s = sbits + 2 * warp * T::BN + lc;
        s[0] = (uint8_t)w;
        s[1] = (uint8_t)(w >> 8);
        s[T::BN] = (uint8_t)(w >> 16);
        s[T::BN + 1] = (uint8_t)(w >> 24);
      }
    }
    named_sync(1 + wg, 128);

    // 128 threads write the warpgroup's 64 rows (one super-group) out,
    // column-coalesced, with the counts
    const long long sup = (long long)p * (tm / 64) + cm * (T::BM / 64) + wg;
    uint8_t* gbp = gb + sup * 8 * (long long)tn + cn * T::BN;
    uint8_t* g64p = g64 + sup * (long long)tn + cn * T::BN;
    int pairs = 0, groups = 0, supers = 0;
#pragma unroll
    for (int c = tid; c < T::BN; c += 128) {
      uint8_t any = 0;
#pragma unroll
      for (int grp = 0; grp < 8; ++grp) {
        const uint8_t byte = sbits[grp * T::BN + c];
        gbp[grp * (long long)tn + c] = byte;
        pairs += __popc(byte);
        groups += byte != 0;
        any |= byte;
      }
      g64p[c] = any != 0;
      supers += any != 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pairs += __shfl_xor_sync(0xffffffffu, pairs, off);
      groups += __shfl_xor_sync(0xffffffffu, groups, off);
      supers += __shfl_xor_sync(0xffffffffu, supers, off);
    }
    if (lane == 0 && supers) {
      atomicAdd(&cnt[3 * p + 0], pairs);
      atomicAdd(&cnt[3 * p + 1], groups);
      atomicAdd(&cnt[3 * p + 2], supers);
    }
    named_sync(1 + wg, 128);  // sbits and saux are free for the next tile
  }
};

// Kernel 4: the full (m / BM) x (n / BN) grid in groups of GROUP row tiles
// (column tiles walk inside a group), int32 stores straight from the
// accumulators: lanes 4g..4g+3 write 32 contiguous bytes of one row.
template <class T>
struct MatmulJob {
  static constexpr int GROUP = 8;
  int n_tiles, tiles_m, tiles_n, n;
  int* out;
  using Acc = int;
  struct Pre {};

  __device__ __forceinline__ void prefetch(int, bool, int, int, int, int,
                                           Pre&) const {}

  __device__ __forceinline__ bool tile(int t, int& ar, int& br) const {
    const int per = GROUP * tiles_n;
    const int first = (t / per) * GROUP;
    const int rows = min(GROUP, tiles_m - first);
    const int r = t % per;
    ar = (first + r % rows) * T::BM;
    br = (r / rows) * T::BN;
    return true;
  }

  template <int R>
  __device__ __forceinline__ void epilogue(int, bool, int ar, int br, int wg,
                                           int warp, int lane,
                                           const int (&acc)[R], const Pre&,
                                           uint8_t*) const {
    const long long r = ar + wg * 64 + warp * 16 + (lane >> 2);
    int* o = out + r * n + br + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      *reinterpret_cast<int2*>(o + 8 * j) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(o + 8 * (long long)n + 8 * j) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, row_bytes] bytes (int8, or bf16 pairs: the bytes land where a
// K-major 128-byte-swizzled tile of either type wants them), boxes of
// box_rows x 128 bytes, 128-byte swizzle.
// TMA needs a 16-byte-aligned base; row_bytes % 128 == 0 gives the stride.
bool make_map(CUtensorMap* map, const void* base, long long rows,
              long long row_bytes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)KSTAGE, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One persistent launch: a thread block per SM, whatever the tile count
// (blocks that draw no tile exit at once); next_tile: one int32, zero.
template <class T, class Job>
int launch_ring(const void* xa, long long rows_a, const void* xb,
                long long rows_b, long long row_bytes, const Job& job,
                void* next_tile, void* stream) {
  CUtensorMap ma, mb;
  std::memset(&ma, 0, sizeof ma);
  std::memset(&mb, 0, sizeof mb);
  if (row_bytes > 0 && (!make_map(&ma, xa, rows_a, row_bytes, T::BM) ||
                        !make_map(&mb, xb, rows_b, row_bytes, T::BN)))
    return (int)cudaErrorInvalidValue;
  if (row_bytes / KSTAGE > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ring_kernel<T, Job>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
  if (e != cudaSuccess) return (int)e;
  ring_kernel<T, Job><<<sms, T::THREADS, T::SMEM,
                             (cudaStream_t)stream>>>(
      ma, mb, (int)(row_bytes / KSTAGE), (int*)next_tile, job);
  return (int)cudaGetLastError();
}

template <class T, class Op>
int launch_score(const void* xi, const void* xj, long long row_bytes,
                 const void* aux_i, int rows_i, const void* aux_j, int rows_j,
                 const void* tiles, const void* bi, const void* bj,
                 const void* valid, int off_row, int off_col, float tau,
                 int n_blocks, int tm, int tn, void* gb, void* g64, void* cnt,
                 void* next_tile, void* stream) {
  if (tm % T::BM || tn % T::BN || row_bytes % KSTAGE || rows_i % tm ||
      rows_j % tn || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles =
      (long long)n_blocks * (tm / T::BM) * (tn / T::BN);
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  ScoreJob<T, Op> job{(int)n_tiles, (const int*)tiles, (const int*)bi,
                  (const int*)bj, (const int*)valid, tm / T::BM, tn / T::BN,
                  tm, tn, off_row, off_col, (const float*)aux_i,
                  (const float*)aux_j, rows_i, rows_j, tau, (uint8_t*)gb,
                  (uint8_t*)g64, (int*)cnt};
  return launch_ring<T>(xi, rows_i, xj, rows_j, row_bytes, job, next_tile,
                        stream);
}

// the thread-block tile is chosen by shape: 128 x 256 where it divides the
// block tile, else 64 x 128 (the wrappers' thread_block_tile makes the same
// choice for the sub-tile list); row_bytes = K elements x the operand size,
// aux null for Bf16Op
template <class Op>
int score(const void* xi, const void* xj, long long row_bytes,
               const void* aux_i, int rows_i, const void* aux_j, int rows_j,
               const void* tiles, const void* bi, const void* bj,
               const void* valid, int off_row, int off_col, float tau,
               int n_blocks, int tm, int tn, void* gb, void* g64, void* cnt,
               void* next_tile, void* stream) {
  auto* f = (tm % Big::BM == 0 && tn % Big::BN == 0)
                ? launch_score<Big, Op>
                : launch_score<Small, Op>;
  return f(xi, xj, row_bytes, aux_i, rows_i, aux_j, rows_j, tiles, bi, bj,
           valid, off_row, off_col, tau, n_blocks, tm, tn, gb, g64, cnt,
           next_tile, stream);
}

template <class T>
int launch_matmul(const void* xi, const void* xj, int m, int n, int d,
                  void* out, void* next_tile, void* stream) {
  const long long n_tiles = (long long)(m / T::BM) * (n / T::BN);
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  MatmulJob<T> job{(int)n_tiles, m / T::BM, n / T::BN, n, (int*)out};
  return launch_ring<T>(xi, m, xj, n, d, job, next_tile, stream);
}

// ------------------------- kernels 5 and 6: the summed-partial epilogues
//
// pair_bits_int8 (kernel 5) and pair_bits_f32 (kernel 6) replace no Pallas
// kernel: they are the epilogues XLA builds behind the join's products.
// Kernel 5 is the one XLA fuses behind _int8_matmul in
// apsim_tpu/ops/panel_mesh.py:183-213 and behind the int8 stripes'
// product (apsim_tpu/ops/chunked.py:int8_join_epilogue, the mesh's
// chunked_mesh.py:174): the psum of the shards' int32 partial dots,
// int8_bound_mask, bitpack_mask and the counts.  Kernel 6 is the bf16 and
// fp32 stripes' (chunked.py:join_epilogue_bits, chunked_mesh.py:89): the
// psum of the shards' fp32 partial scores, s >= tau_eff, the strict upper
// mask and bitpack_mask.  The port first ran both as eager PyTorch.
//
// For one row slice of a rectangle (a panel pair, or a stripe's live rows)
// each sums the S partials of a cell, admits it by its test and the
// strict-upper test on global coordinates, and writes the score kernels'
// layout for one block: gb [1, rows/8, cols], g64 [1, rows/64, cols] and
// the counts, here int64 (a 65,536-row rectangle has 2^32 cells).  The
// sums: int32, exact in any order (every sum stays below 2^30 under the
// engines' int8 gate); fp32 left to right, ((p0 + p1) + p2) + ..., with
// __fadd_rn (and --fmad=false), which is the order of
// parallel/collectives.psum's one-process chain, so a cell's sum is bit
// for bit the one the lead card formed before.
//
// What bounds them: a few operations per 4 * S bytes read, so the memory
// (S partial values in per live cell, a bit out).  So every partial is
// read once, coalesced, and nothing else leaves the chip: a thread block
// of 128 threads covers 64 rows (one super-group) x 128 columns, a thread
// one column, so a warp's loads of a row are 128 contiguous bytes of each
// partial; a thread sums 8 rows of every partial at a time (8 independent
// loads in flight), assembles their group byte in a register and stores it
// (a warp writes 32 contiguous bytes); kernel 5's 64 rows of aux entries
// sit in shared memory (read as broadcasts), the column's in registers.  A
// cell with row >= col is neither loaded nor tested, so a diagonal pair
// reads half its bytes.  Counts: a warp reduction, then one 64-bit
// atomicAdd per warp that saw a hit.  The partials' addresses and row
// strides travel by value in the kernel's parameters (a __grid_constant__
// struct, read through the constant cache), so a launch copies nothing to
// the card first; a row stride lets a partial be a column slice of a wider
// product, and an aux table a column slice of the whole index's.
constexpr int PB_ROWS = 64;        // rows of a thread block: a super-group
constexpr int PB_COLS = 128;       // columns of a thread block, one a thread
constexpr int PB_MAX_PARTS = 64;   // partials summed per cell at most

template <class T>
struct PairParts {
  const T* p[PB_MAX_PARTS];   // the partials, row-major
  long long ld[PB_MAX_PARTS]; // the row stride of each, in elements
};

// Kernel 5's admit test: the int8 bound of the summed dot.  aux_i / aux_j
// are f32 [3, n] tables (alpha, alpha * L1(q), nnz) with row strides ld_i
// / ld_j.
struct BoundAdmit {
  using T = int;
  const float* aux_i;
  long long ld_i;
  const float* aux_j;
  long long ld_j;
  struct Rows {
    float a[PB_ROWS], b[PB_ROWS], n[PB_ROWS];
  };
  struct Col {
    float a, b, n;
  };
  static __device__ __forceinline__ int add(int s, int x) { return s + x; }
  __device__ __forceinline__ void load_rows(Rows& s, int r0, int tid) const {
    if (tid < PB_ROWS) {
      const float* p = aux_i + r0 + tid;
      s.a[tid] = __ldg(p);
      s.b[tid] = __ldg(p + ld_i);
      s.n[tid] = __ldg(p + 2 * ld_i);
    }
  }
  __device__ __forceinline__ Col col(int c) const {
    const float* p = aux_j + c;
    return {__ldg(p), __ldg(p + ld_j), __ldg(p + 2 * ld_j)};
  }
  __device__ __forceinline__ bool hit(int acc, const Rows& s, int r,
                                      const Col& j, float tau) const {
    return int8_hit(acc, s.a[r], s.b[r], s.n[r], j.a, j.b, j.n, tau);
  }
};

// Kernel 6's admit test: the summed fp32 score against tau_eff.
struct ThresholdAdmit {
  using T = float;
  struct Rows {};
  struct Col {};
  static __device__ __forceinline__ float add(float s, float x) {
    return __fadd_rn(s, x);
  }
  __device__ __forceinline__ void load_rows(Rows&, int, int) const {}
  __device__ __forceinline__ Col col(int) const { return {}; }
  __device__ __forceinline__ bool hit(float acc, const Rows&, int,
                                      const Col&, float tau) const {
    return acc >= tau;
  }
};

template <class Admit>
__global__ void __launch_bounds__(PB_COLS)
pair_bits_kernel(const __grid_constant__ PairParts<typename Admit::T> parts,
                 int n_parts, const Admit admit, int rows, int cols,
                 int row0, int col0, float tau, uint8_t* __restrict__ gb,
                 uint8_t* __restrict__ g64,
                 unsigned long long* __restrict__ cnt) {
  using T = typename Admit::T;
  __shared__ typename Admit::Rows srows;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * PB_ROWS;       // the block's first row
  const int c = blockIdx.x * PB_COLS + tid;  // this thread's column
  admit.load_rows(srows, r0, tid);
  __syncthreads();
  const bool in = c < cols;
  typename Admit::Col cj{};
  if (in) cj = admit.col(c);
  // the block's rows r < live lie strictly above the diagonal: global
  // row0 + r0 + r < global col0 + c
  const long long upper = (long long)col0 + c - row0 - r0;
  const int live = in ? (int)min(max(upper, 0LL), (long long)PB_ROWS) : 0;
  int pairs = 0, groups = 0;
  uint32_t any = 0;
#pragma unroll 1
  for (int g = 0; g < PB_ROWS / 8; ++g) {
    uint32_t byte = 0;
    const int lim = live - 8 * g;  // rows 8 g + o, o < lim, are live
    if (lim > 0) {
      const long long row = r0 + 8 * g;
      T acc[8];
      {
        const long long ld = parts.ld[0];
        const T* p = parts.p[0] + row * ld + c;
#pragma unroll
        for (int o = 0; o < 8; ++o)
          acc[o] = o < lim ? __ldg(p + o * ld) : T(0);
      }
      for (int s = 1; s < n_parts; ++s) {
        const long long ld = parts.ld[s];
        const T* p = parts.p[s] + row * ld + c;
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if (o < lim) acc[o] = Admit::add(acc[o], __ldg(p + o * ld));
      }
#pragma unroll
      for (int o = 0; o < 8; ++o)
        if (o < lim && admit.hit(acc[o], srows, 8 * g + o, cj, tau))
          byte |= 1u << o;
    }
    if (in) gb[(long long)(r0 / 8 + g) * cols + c] = (uint8_t)byte;
    pairs += __popc(byte);
    groups += byte != 0;
    any |= byte;
  }
  if (in) g64[(long long)blockIdx.y * cols + c] = any != 0;
  int supers = any != 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pairs += __shfl_xor_sync(0xffffffffu, pairs, off);
    groups += __shfl_xor_sync(0xffffffffu, groups, off);
    supers += __shfl_xor_sync(0xffffffffu, supers, off);
  }
  if ((tid & 31) == 0 && supers) {
    atomicAdd(cnt + 0, (unsigned long long)pairs);
    atomicAdd(cnt + 1, (unsigned long long)groups);
    atomicAdd(cnt + 2, (unsigned long long)supers);
  }
}

// Kernels 5 and 6 behind their C entries: the partials' addresses and row
// strides (host arrays of n_parts) copied into the parameter struct.
template <class Admit>
int launch_pair_bits(const void* parts, const void* lds, int n_parts,
                     const Admit& admit, int rows, int cols, int row0,
                     int col0, float tau, void* gb, void* g64, void* cnt,
                     void* stream) {
  using T = typename Admit::T;
  if (n_parts < 1 || n_parts > PB_MAX_PARTS || rows < 0 || cols < 0 ||
      rows % PB_ROWS || rows / PB_ROWS > 65535 || !parts || !lds)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  PairParts<T> pp;
  std::memset(&pp, 0, sizeof pp);
  for (int s = 0; s < n_parts; ++s) {
    pp.p[s] = ((const T* const*)parts)[s];
    pp.ld[s] = ((const long long*)lds)[s];
  }
  const dim3 grid((cols + PB_COLS - 1) / PB_COLS, rows / PB_ROWS);
  pair_bits_kernel<Admit><<<grid, PB_COLS, 0, (cudaStream_t)stream>>>(
      pp, n_parts, admit, rows, cols, row0, col0, tau, (uint8_t*)gb,
      (uint8_t*)g64, (unsigned long long*)cnt);
  return (int)cudaGetLastError();
}

// -------------------------------- kernel 7: compaction of the hit structure
//
// compact_bits replaces the XLA chain of apsim_tpu/ops/pallas_score.py
// (_compact_bits: nonzero over g64, then over the group bytes under its
// hits, then over their bits), which the port first ran as three eager
// torch.nonzero levels with a host wait at each.  It turns one hit
// structure (gb, g64 of a block list, as the score kernels and kernels 5
// and 6 write it) into the exact (row, col) int64 lists of its hits, in the
// order of that chain: by block, then column cell, then row, where a column
// cell is one column of one 512-row cell of a block with the pre-level (tm
// a multiple of 512, or the caller's override) and of one 64-row super
// without.  Within a cell the chain's super, group and bit order is row
// order.
//
// Order comes from a prefix over the cells' hit counts, never from
// atomics: pass 1 counts each thread block's tile of CB_TILE consecutive
// cells, pass 2 (one thread block) turns the tiles' counts into their
// offsets, pass 3 counts again, scans its tile in order and writes each
// cell's hits from its offset.  The output's length is the kernel's count,
// which the host already holds; a write past it is dropped, and pass 1
// adds the (pairs, hit groups, hit supers) it decodes into a device
// total, which the host checks against the counts (a mismatch raises).
//
// What bounds it: bytes.  It reads every g64 byte (1 MiB at an 8,192-row
// panel pair of 1024 x 512 blocks) and, under a hit super only, its 8 gb
// bytes, and writes 16 bytes a hit: a few microseconds at 3.35 TB/s.  So a
// thread reads one cell's g64 bytes a round, all before it tests any (a
// warp's loads are 32 consecutive columns), and every pass is one plain
// memory sweep; pass 3 reads again, from L2, only the tiles that hold a
// hit.  A thread that meets a dense cell writes its hits serially, which
// only an all-hit block makes long.
constexpr int CB_THREADS = 256;  // threads of a pass-1 / pass-3 block
constexpr int CB_ROUNDS = 4;     // cells a thread decodes, 256 apart
constexpr int CB_TILE = CB_THREADS * CB_ROUNDS;  // cells a block covers
constexpr int CB_SCAN = 1024;    // threads of the pass-2 block

struct CompactCells {
  const uint8_t* gb;   // [n_blocks, tm / 8, tn]
  const uint8_t* g64;  // [n_blocks, tm / 64, tn]
  const int* bi;       // the blocks' row and column tile ids
  const int* bj;
  long long n_cells;   // n_blocks * (tm / cell rows) * tn
  int tm, tn;
  int block_cells;     // cells of a block column: tm / cell rows
};

// Cell u of CS 64-row supers (8 with the pre-level, else 1): its block p,
// the block's super s of its first row (counted over every block) and its
// column c; h bit j says whether super s + j has a hit (its g64 byte, all
// CS loaded before any is tested).
template <int CS>
struct Cell {
  long long p, s;
  int c;
  uint32_t h;
  __device__ __forceinline__ Cell(const CompactCells& g, long long u) {
    const long long per = (long long)g.block_cells * g.tn;
    p = u / per;
    const long long rem = u - p * per;
    c = (int)(rem % g.tn);
    s = p * (g.tm / 64) + rem / g.tn * CS;
    const uint8_t* q = g.g64 + s * g.tn + c;
    uint8_t b[CS];
#pragma unroll
    for (int j = 0; j < CS; ++j) b[j] = __ldg(q + (long long)j * g.tn);
    h = 0;
#pragma unroll
    for (int j = 0; j < CS; ++j) h |= (uint32_t)(b[j] != 0) << j;
  }
  // the group byte o of super s + j
  __device__ __forceinline__ uint32_t group(const CompactCells& g, int j,
                                            int o) const {
    return __ldg(g.gb + ((s + j) * 8 + o) * g.tn + c);
  }
};

// Cell u's hits; with a non-null `out`, (pairs, hit groups, hit supers)
// are added to out[0..2].
template <int CS>
__device__ __forceinline__ int cell_count(const CompactCells& g, long long u,
                                          int* out) {
  const Cell<CS> cell(g, u);
  int pairs = 0;
  for (uint32_t h = cell.h; h; h &= h - 1) {
    const int j = __ffs(h) - 1;
    uint32_t v[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) v[o] = cell.group(g, j, o);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      pairs += __popc(v[o]);
      if (out) out[1] += v[o] != 0;
    }
  }
  if (out) {
    out[0] += pairs;
    out[2] += __popc(cell.h);
  }
  return pairs;
}

// Write cell u's hits from rows[pos] / cols[pos] on, in row order; a
// position at or past n_out is dropped.
template <int CS>
__device__ __forceinline__ void cell_write(const CompactCells& g, long long u,
                                          long long pos, long long n_out,
                                          long long* __restrict__ rows,
                                          long long* __restrict__ cols) {
  const Cell<CS> cell(g, u);
  const long long row0 = (long long)__ldg(g.bi + cell.p) * g.tm
      + (cell.s - cell.p * (g.tm / 64)) * 64;
  const long long col = (long long)__ldg(g.bj + cell.p) * g.tn + cell.c;
  for (uint32_t h = cell.h; h; h &= h - 1) {
    const int j = __ffs(h) - 1;
    for (int o = 0; o < 8; ++o) {
      for (uint32_t v = cell.group(g, j, o); v; v &= v - 1) {
        if (pos < n_out) {
          rows[pos] = row0 + j * 64 + o * 8 + __ffs(v) - 1;
          cols[pos] = col;
        }
        ++pos;
      }
    }
  }
}

// Inclusive prefix of v over a block of NT threads; `total` gets the
// block's sum.  warp_tot: shared [NT / 32], free again on return.
template <int NT>
__device__ __forceinline__ long long block_scan(long long v,
                                                long long* warp_tot,
                                                long long& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long x = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += x;
  }
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  if (w == 0) {
    long long t = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long x = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += x;
    }
    if (lane < NT / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  if (w > 0) v += warp_tot[w - 1];
  total = warp_tot[NT / 32 - 1];
  __syncthreads();
  return v;
}

// Pass 1: tile_sum[block] = the tile's hits; its decoded (pairs, groups,
// supers) added to decoded[0..2].
template <int CS>
__global__ void __launch_bounds__(CB_THREADS)
compact_count_kernel(const CompactCells g, long long* __restrict__ tile_sum,
                     unsigned long long* __restrict__ decoded) {
  __shared__ int part[CB_THREADS / 32][3];
  int n[3] = {0, 0, 0};
  const long long base = (long long)blockIdx.x * CB_TILE + threadIdx.x;
#pragma unroll
  for (int r = 0; r < CB_ROUNDS; ++r) {
    const long long u = base + r * CB_THREADS;
    if (u < g.n_cells) cell_count<CS>(g, u, n);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      n[k] += __shfl_xor_sync(0xffffffffu, n[k], off);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0)
    for (int k = 0; k < 3; ++k) part[w][k] = n[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t[3] = {0, 0, 0};
    for (int i = 0; i < CB_THREADS / 32; ++i)
      for (int k = 0; k < 3; ++k) t[k] += part[i][k];
    tile_sum[blockIdx.x] = t[0];
    if (t[2])
      for (int k = 0; k < 3; ++k)
        atomicAdd(decoded + k, (unsigned long long)t[k]);
  }
}

// Pass 2, one block: tile_off = the exclusive prefix of tile_sum.
__global__ void __launch_bounds__(CB_SCAN)
compact_scan_kernel(const long long* __restrict__ tile_sum,
                    long long* __restrict__ tile_off, long long n_tiles) {
  __shared__ long long warp_tot[CB_SCAN / 32];
  long long carry = 0;
  for (long long b0 = 0; b0 < n_tiles; b0 += CB_SCAN) {
    const long long i = b0 + threadIdx.x;
    const long long v = i < n_tiles ? tile_sum[i] : 0;
    long long total;
    const long long incl = block_scan<CB_SCAN>(v, warp_tot, total);
    if (i < n_tiles) tile_off[i] = carry + incl - v;
    carry += total;
  }
}

// Pass 3: a tile with hits scans its CB_THREADS cells a round in order
// from the tile's offset and writes their hits; a tile without returns.
template <int CS>
__global__ void __launch_bounds__(CB_THREADS)
compact_write_kernel(const CompactCells g,
                     const long long* __restrict__ tile_sum,
                     const long long* __restrict__ tile_off, long long n_out,
                     long long* __restrict__ rows,
                     long long* __restrict__ cols) {
  __shared__ long long warp_tot[CB_THREADS / 32];
  if (tile_sum[blockIdx.x] == 0) return;
  long long pos = tile_off[blockIdx.x];
  const long long base = (long long)blockIdx.x * CB_TILE + threadIdx.x;
  for (int r = 0; r < CB_ROUNDS; ++r) {
    const long long u = base + r * CB_THREADS;
    const int mine = u < g.n_cells ? cell_count<CS>(g, u, nullptr) : 0;
    long long total;
    const long long incl = block_scan<CB_THREADS>(mine, warp_tot, total);
    if (mine) cell_write<CS>(g, u, pos + incl - mine, n_out, rows, cols);
    pos += total;
  }
}

// The three passes over the cells of g (see above).  tile: scratch of
// 2 * n_tiles (the sums, then the offsets).
template <int CS>
void launch_compact(const CompactCells& g, long long* tile, long long n_tiles,
                    long long n_out, long long* rows, long long* cols,
                    unsigned long long* decoded, cudaStream_t s) {
  compact_count_kernel<CS><<<(unsigned)n_tiles, CB_THREADS, 0, s>>>(
      g, tile, decoded);
  if (n_out > 0) {
    compact_scan_kernel<<<1, CB_SCAN, 0, s>>>(tile, tile + n_tiles, n_tiles);
    compact_write_kernel<CS><<<(unsigned)n_tiles, CB_THREADS, 0, s>>>(
        g, tile, tile + n_tiles, n_out, rows, cols);
  }
}

// Peer access of card dev to card peer's memory, turned on once (a copy
// between cards without it is staged through host memory).  0 when on,
// or when the cards cannot reach each other (the copy is then staged).
int enable_peer(int dev, int peer) {
  static std::mutex mu;
  static bool done[64][64];
  if (dev < 0 || peer < 0 || dev >= 64 || peer >= 64)
    return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev][peer]) return (int)cudaSuccess;
  int can = 0, prev = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e == cudaSuccess && can) {
    if ((e = cudaGetDevice(&prev)) != cudaSuccess) return (int)e;
    if ((e = cudaSetDevice(dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
    cudaSetDevice(prev);
  }
  if (e == cudaSuccess) done[dev][peer] = true;
  return (int)e;
}

}  // namespace

extern "C" {

// Dense upper triangle.  xq int8 [row_cap, dim_cap], aux f32 [3, row_cap],
// bi/bj int32 [n_blocks], tiles int32 sub-tile ids (the wrapper's
// live-first list, n_blocks * (tm / BM) * (tn / BN) of them); outputs as in
// the header comment; next_tile one int32, zero on entry (the dynamic
// tile counter).  Returns cudaGetLastError() after the launch (0 =
// launched).
int score_bits_int8(const void* xq, const void* aux, const void* tiles,
                    const void* bi, const void* bj, float tau_eff,
                    int row_cap, int dim_cap, int n_blocks, int tm, int tn,
                    void* gb, void* g64, void* cnt, void* next_tile,
                    void* stream) {
  return score<Int8Op>(xq, xq, dim_cap, aux, row_cap, aux, row_cap, tiles, bi,
                    bj, nullptr, 0, 0, tau_eff, n_blocks, tm, tn, gb, g64,
                    cnt, next_tile, stream);
}

// x bf16 [row_cap, dim_cap] (a row is 2 * dim_cap bytes, so dim_cap % 64
// must be 0); no aux; the rest as score_bits_int8.
int score_bits_bf16(const void* x, const void* tiles, const void* bi,
                    const void* bj, float tau_eff, int row_cap, int dim_cap,
                    int n_blocks, int tm, int tn, void* gb, void* g64,
                    void* cnt, void* next_tile, void* stream) {
  return score<Bf16Op>(x, x, 2LL * dim_cap, nullptr, row_cap, nullptr,
                       row_cap, tiles, bi, bj, nullptr, 0, 0, tau_eff,
                       n_blocks, tm, tn, gb, g64, cnt, next_tile, stream);
}

// One cross-panel rectangle.  xi int8 [rows_i, dim_cap], xj int8
// [rows_j, dim_cap], auxi/auxj f32 [3, rows_i] / [3, rows_j], tiles as in
// score_bits_int8, bi/bj int32 [n_blocks] (local tile ids), valid int32
// [n_blocks] or null, (off_row, off_col) the global rows of xi's and xj's
// row 0; next_tile as in score_bits_int8.
int panel_score_bits_int8(const void* xi, const void* xj, const void* auxi,
                          const void* auxj, const void* tiles, const void* bi,
                          const void* bj, const void* valid, int off_row,
                          int off_col, float tau_eff, int rows_i, int rows_j,
                          int dim_cap, int n_blocks, int tm, int tn, void* gb,
                          void* g64, void* cnt, void* next_tile,
                          void* stream) {
  return score<Int8Op>(xi, xj, dim_cap, auxi, rows_i, auxj, rows_j, tiles, bi,
                    bj, valid, off_row, off_col, tau_eff, n_blocks, tm, tn,
                    gb, g64, cnt, next_tile, stream);
}

// Kernel 4.  xi int8 [m, d], xj int8 [n, d], out int32 [m, n] (every
// element written), next_tile as in score_bits_int8; m % 64, n % 128 and
// d % 128 must be 0.  128 x 256 thread-block tiles where m % 128 == 0 and
// n % 256 == 0, else 64 x 128.
int int8_matmul(const void* xi, const void* xj, int m, int n, int d,
                void* out, void* next_tile, void* stream) {
  if (m % Small::BM || n % Small::BN || d % KSTAGE || m < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaSuccess;
  if (d == 0) return (int)cudaMemsetAsync(out, 0, (size_t)m * n * sizeof(int),
                                          (cudaStream_t)stream);
  if (m % Big::BM == 0 && n % Big::BN == 0)
    return launch_matmul<Big>(xi, xj, m, n, d, out, next_tile, stream);
  return launch_matmul<Small>(xi, xj, m, n, d, out, next_tile, stream);
}

// Kernel 5, one row slice of a rectangle: a panel pair of the mesh join
// or a stripe of the int8 stripe join.  parts: a HOST array of n_parts
// device pointers (1 to 64), each to an int32 [rows, cols] partial whose
// rows are lds[s] elements apart (lds a host array of n_parts int64);
// aux_i f32 [3, rows] and aux_j f32 [3, cols] with row strides ld_i and
// ld_j; (row0, col0) the global row of the slice's row 0 and the global
// column of its column 0; gb uint8 [rows / 8, cols] and g64 uint8
// [rows / 64, cols] (every byte written); cnt int64 [3] (pairs, hit
// groups, hit supers), zero on entry.  rows % 64 must be 0.
int pair_bits_int8(const void* parts, const void* lds, int n_parts,
                   const void* aux_i, int ld_i, const void* aux_j, int ld_j,
                   int rows, int cols, int row0, int col0,
                   float tau_eff, void* gb, void* g64, void* cnt,
                   void* stream) {
  const BoundAdmit admit{(const float*)aux_i, ld_i, (const float*)aux_j,
                         ld_j};
  return launch_pair_bits(parts, lds, n_parts, admit, rows, cols, row0, col0,
                          tau_eff, gb, g64, cnt, stream);
}

// Kernel 6, one row slice of a stripe of the bf16 or fp32 stripe join:
// parts and lds as in pair_bits_int8, each partial fp32, summed left to
// right; a cell is a hit when its sum >= tau_eff and its global row lies
// below its global column; the rest as pair_bits_int8.
int pair_bits_f32(const void* parts, const void* lds, int n_parts, int rows,
                  int cols, int row0, int col0, float tau_eff, void* gb,
                  void* g64, void* cnt, void* stream) {
  return launch_pair_bits(parts, lds, n_parts, ThresholdAdmit{}, rows, cols,
                          row0, col0, tau_eff, gb, g64, cnt, stream);
}

// Kernel 7, one hit structure: gb uint8 [n_blocks, tm / 8, tn] and g64
// uint8 [n_blocks, tm / 64, tn] as the score kernels write them, bi / bj
// int32 [n_blocks] the blocks' row and column tile ids (a hit at local
// (r, c) of block p is (bi[p] * tm + r, bj[p] * tn + c)); pre_level 1
// scans 512-row cells (tm % 512 must be 0), 0 64-row supers; n_tiles =
// ceil(cells / 1024), cells = n_blocks * tm / 512 * tn (or tm / 64), and
// tile int64 [2 * n_tiles] scratch; rows / cols int64 [n_out], n_out the
// kernel's count of hits; decoded int64 [3] (pairs, hit groups, hit
// supers), added to.  tm % 64 must be 0.  Launches pass 1, then passes 2
// and 3 when n_out > 0.
int compact_bits(const void* gb, const void* g64, const void* bi,
                 const void* bj, int n_blocks, int tm, int tn, int pre_level,
                 void* tile, long long n_tiles, long long n_out, void* rows,
                 void* cols, void* decoded, void* stream) {
  const int cell_rows = pre_level ? 512 : 64;
  if (n_blocks < 0 || tm <= 0 || tn <= 0 || tm % cell_rows || n_out < 0)
    return (int)cudaErrorInvalidValue;
  const CompactCells g{(const uint8_t*)gb, (const uint8_t*)g64,
                       (const int*)bi, (const int*)bj,
                       (long long)n_blocks * (tm / cell_rows) * tn, tm, tn,
                       tm / cell_rows};
  if (n_tiles != (g.n_cells + CB_TILE - 1) / CB_TILE || n_tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  if (pre_level)
    launch_compact<8>(g, (long long*)tile, n_tiles, n_out, (long long*)rows,
                      (long long*)cols, (unsigned long long*)decoded,
                      (cudaStream_t)stream);
  else
    launch_compact<1>(g, (long long*)tile, n_tiles, n_out, (long long*)rows,
                      (long long*)cols, (unsigned long long*)decoded,
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// One copy between cards: bytes bytes from src on card src_dev to dst on
// card dst_dev, queued on stream (a stream of src_dev) without a host wait,
// with each card's peer access to the other on (enable_peer); the copy
// engines move it as torch's copy_ between cards does.  Returns the
// runtime's error code (0 = queued).
int peer_copy(void* dst, int dst_dev, const void* src, int src_dev,
              long long bytes, void* stream) {
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  int e = enable_peer(src_dev, dst_dev);
  if (e == 0) e = enable_peer(dst_dev, src_dev);
  if (e != 0) return e;
  return (int)cudaMemcpyPeerAsync(dst, dst_dev, src, src_dev, (size_t)bytes,
                                  (cudaStream_t)stream);
}

}  // extern "C"
