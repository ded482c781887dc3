// All-pairs score kernels for Hopper (sm_90a), int8 and bf16.
//
// Replaces the TPU kernels of apsim_tpu/ops/pallas_score.py,
// apsim_tpu/ops/panel.py and apsim_tpu/ops/panel_mesh.py:
//   score_bits_int8        <- _kernel_int8       (pallas_score_bits_int8)
//   score_bits_bf16        <- _kernel            (pallas_score_bits)
//   panel_score_bits_int8  <- _kernel_int8_cross (panel_score_bits_int8)
//   int8_matmul            <- _mm_kernel         (_int8_matmul)
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
// int8_matmul (kernel 4) is the per-shard partial dot of the mesh panel
// join: out = xi . xj^T in int32 over the full m x n grid, no block list,
// no epilogue but the int32 stores.
//
// What bounds the int8 kernels (1, 3, 4).  At the main paths' shapes (K =
// 32,768 bytes per row for kernels 1 and 3 and for kernel 4 on one shard,
// 4,096 on eight) they do 2 * rows * cols * K ops on (rows + cols) * K
// operand bytes plus their outputs: 1,600-5,500 ops per byte of HBM
// traffic, far above the card's ~590 (1,979 TOPS over 3.35 TB/s), so
// tensor-core operations bound them (kernel 4 at m = n = 8192, K = 32,768:
// 2.2 ms of operations against 0.24 ms of bytes).  What stands between a
// kernel and that bound is how fast operands reach the tensor cores: the
// first design (64 x 128 tiles, one shared stage, mma.sync) streamed 85
// ops per byte from L2 and ran at 22 % of peak.  The int8 design now:
//   - thread-block tiles of 128 x 256 (two consumer warpgroups of 64 x 256
//     each, 171 ops per byte of L2 traffic), or 64 x 128 (one consumer
//     warpgroup) for block tiles the large one does not divide (chosen by
//     shape: tm % 128 == 0 and tn % 256 == 0, or m and n for kernel 4);
//   - one producer thread (its warpgroup gives up its registers) streams
//     one 128-byte K slice of both operand panels per stage with TMA
//     (128-byte swizzle) into a ring of stages
//     (4 of 48 KB, or 8 of 24 KB) with full / empty mbarriers, so loads run
//     ahead of the multiplies and no __syncthreads sits in the loop;
//   - wgmma.mma_async m64n256k32 (m64n128k32) s8.s8 -> s32, both operands
//     read from shared-memory descriptors, one wgmma group in flight while
//     the next stage's is issued; setmaxnreg gives the consumers 232
//     registers (the 128 accumulators of n = 256) and the producer 40;
//   - persistent: one thread block per SM draws tiles from a global
//     counter (atomicAdd), the ring's phase carried from tile to tile, so
//     one tile's epilogue overlaps the next tile's loads and the tiles in
//     flight stay a contiguous window of the list: their operand panels
//     are shared in L2.  (A static round-robin let blocks drift apart over
//     the 128 tiles each has in the 32,768-row triangle, and kernel 1
//     varied from 25 to 47 ms between launches on an H100 80GB HBM3 at
//     700 W.)  Score kernels walk their
//     sub-tiles in block-list order (row panel major), the live sub-tiles
//     first (the wrapper's list); kernel 4 walks its grid in groups of 8
//     row tiles.
// The wgmma accumulator of each warp (rows 16w+g and 16w+g+8, columns
// 8j+2t and 8j+2t+1) is the mma.sync m16n8 layout, so the bit-pack
// epilogue is warp shuffles into a shared [8][cols] byte tile per
// warpgroup (64 rows: one super-group), which its 128 threads write out
// column-coalesced with the counts.  The aux rows it thresholds with are
// loaded into registers before the K loop and staged in shared memory
// after it: read from global memory inside the epilogue, their latency
// stalled both warpgroups and cost kernel 3 a fifth of its time on the
// same card.
// What still separates the kernels from the operations bound (H100 80GB
// HBM3, 700 W; PERF.md): kernel 4 at 1 shard runs at 80-90 % of peak;
// kernel 1 computes whole 128 x 256 tiles across the diagonal, where the
// bound counts only strict-upper cells; the score epilogue and the
// per-tile ring drain are not overlapped with the next tile's multiplies
// (one accumulator set per warpgroup).
//
// Kernel 2 (bf16) keeps the first design's mma.sync mainloop (below,
// `mainloop`): one thread block per 64 x 128 sub-tile, eight warps of
// 32 x 32 cells, one shared stage plus a register prefetch of the next.

#include <cstdint>
#include <climits>
#include <cstring>
#include <cuda.h>
#include <cuda_runtime.h>

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

// ------------------------------------------------ kernel 2: bf16, mma.sync

constexpr int BM = 64;            // rows per thread block (one super-group)
constexpr int BN = 128;           // columns per thread block
constexpr int KB = 128;           // bytes of K per row per stage
constexpr int KW = KB / 4;        // 32-bit words of K per row per stage
constexpr int LDS = KW + 4;       // padded shared row stride (words):
                                  // fragment reads hit 32 distinct banks
constexpr int THREADS = 256;      // 8 warps: 2 along rows x 4 along cols
constexpr int A_VECS = BM * KB / 16 / THREADS;  // uint4 loads per thread
constexpr int B_VECS = BN * KB / 16 / THREADS;

struct Bf16Op {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ bool hit(float acc, const float*, const float*,
                                             float tau) {
    return acc >= tau;
  }
};

// The bf16 mainloop: acc += xa[0:64, :] . xb[0:128, :]^T over all of K
// (row_bytes bytes per row, a multiple of KB), for the fragments this
// thread owns.  xa / xb point at the sub-tile's first operand row.  One
// shared stage of each panel, the next stage prefetched into registers
// while the MMAs of the current one run.
template <class Op>
__device__ __forceinline__ void mainloop(const uint8_t* __restrict__ xa,
                                         const uint8_t* __restrict__ xb,
                                         long long row_bytes, uint32_t* sA,
                                         uint32_t* sB,
                                         typename Op::Acc (&acc)[2][4][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n_stages = (int)(row_bytes / KB);
  uint4 ra[A_VECS], rb[B_VECS];
  auto load = [&](int s) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int u = tid + v * THREADS, r = u / (KB / 16), c = u % (KB / 16);
      ra[v] = __ldg(reinterpret_cast<const uint4*>(
          xa + r * row_bytes + (long long)s * KB + c * 16));
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int u = tid + v * THREADS, r = u / (KB / 16), c = u % (KB / 16);
      rb[v] = __ldg(reinterpret_cast<const uint4*>(
          xb + r * row_bytes + (long long)s * KB + c * 16));
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int u = tid + v * THREADS, r = u / (KB / 16), c = u % (KB / 16);
      *reinterpret_cast<uint4*>(&sA[r * LDS + c * 4]) = ra[v];
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int u = tid + v * THREADS, r = u / (KB / 16), c = u % (KB / 16);
      *reinterpret_cast<uint4*>(&sB[r * LDS + c * 4]) = rb[v];
    }
  };
  load(0);
  store();
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) load(s + 1);  // in flight during the MMAs
#pragma unroll
    for (int ks = 0; ks < KW / 8; ++ks) {
      const int kw = ks * 8;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* ra0 = &sA[(wm * 32 + mt * 16 + g) * LDS + kw + t];
        a[mt][0] = ra0[0];
        a[mt][1] = ra0[8 * LDS];
        a[mt][2] = ra0[4];
        a[mt][3] = ra0[8 * LDS + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* rb0 = &sB[(wn * 32 + nt * 8 + g) * LDS + kw + t];
        b[nt][0] = rb0[0];
        b[nt][1] = rb0[4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Op::mma(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
    if (s + 1 < n_stages) {
      store();
      __syncthreads();
    }
  }
}

// xi: [rows_i, row_bytes], xj: [rows_j, row_bytes] operand rows (bf16
// pairs: kernel 2, Bf16Op without aux, is the one instantiation; the aux,
// valid and offset arguments are the first design's int8 ones, kept so
// kernel 2's code is unchanged); one thread block per 64 x 128 sub-tile,
// p-major, then row, then column sub-tile.
template <class Op, bool kAux>
__global__ void __launch_bounds__(THREADS)
score_bits_kernel(const uint8_t* __restrict__ xi,
                  const uint8_t* __restrict__ xj, long long row_bytes,
                  const float* __restrict__ aux_i, int rows_i,
                  const float* __restrict__ aux_j, int rows_j,
                  const int* __restrict__ bi, const int* __restrict__ bj,
                  const int* __restrict__ valid, int off_row, int off_col,
                  float tau, int tm, int tn, uint8_t* __restrict__ gb,
                  uint8_t* __restrict__ g64, int* __restrict__ cnt) {
  __shared__ __align__(16) uint32_t sA[BM * LDS];
  __shared__ __align__(16) uint32_t sB[BN * LDS];
  __shared__ float sAuxI[BM][3];
  __shared__ float sAuxJ[BN][3];
  __shared__ uint8_t sBits[BM / 8][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma groupID / thread-in-group
  const int wm = warp >> 2, wn = warp & 3; // warp's 32 x 32 cell block

  // which sub-tile of which block: p-major, then row, then column sub-tile
  const int sub_m = tm / BM, sub_n = tn / BN;
  long long bid = blockIdx.x;
  const int cn = (int)(bid % sub_n);
  bid /= sub_n;
  const int cm = (int)(bid % sub_m);
  const long long p = bid / sub_m;
  const int lrow0 = bi[p] * tm + cm * BM;  // operand row of local row 0
  const int lcol0 = bj[p] * tn + cn * BN;  // operand row of local column 0
  const int row0 = off_row + lrow0;        // global row of local row 0
  const int col0 = off_col + lcol0;        // global column of local col 0
  const bool ok = valid == nullptr || valid[p] != 0;

  if (kAux) {
    for (int i = tid; i < BM + BN; i += THREADS) {
      const bool is_i = i < BM;
      const float* src = is_i ? aux_i : aux_j;
      const long long n = is_i ? rows_i : rows_j;
      const int r = is_i ? lrow0 + i : lcol0 + (i - BM);
      float* dst = is_i ? sAuxI[i] : sAuxJ[i - BM];
      dst[0] = src[r];
      dst[1] = src[n + r];
      dst[2] = src[2 * n + r];
    }
  }

  typename Op::Acc acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  // no cell with row < col when the smallest global row is >= the largest
  // global column; an invalid block has no cell at all
  const bool live = ok && row0 < col0 + BN - 1;
  if (live) {
    mainloop<Op>(xi + (long long)lrow0 * row_bytes,
                 xj + (long long)lcol0 * row_bytes, row_bytes, sA, sB, acc);
  } else if (kAux) {
    __syncthreads();  // the aux tiles are read below either way
  }

  // epilogue: threshold + triangle, bit-pack 8 rows per byte.  Fragment
  // element i of tile (mt, nt) sits at local row wm*32 + mt*16 + g + 8*(i/2),
  // column wn*32 + nt*8 + 2t + (i%2); its bit in the group byte is g.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lr = wm * 32 + mt * 16 + g + 8 * (i >> 1);
        const int lc = wn * 32 + nt * 8 + 2 * t + (i & 1);
        const bool h = ok && (row0 + lr < col0 + lc) &&
                       Op::hit(acc[mt][nt][i], sAuxI[lr], sAuxJ[lc], tau);
        w |= (uint32_t)h << (8 * i + g);
      }
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      w |= __shfl_xor_sync(0xffffffffu, w, 8);
      w |= __shfl_xor_sync(0xffffffffu, w, 16);
      if (g == 0) {
        const int grp = wm * 4 + mt * 2, lc = wn * 32 + nt * 8 + 2 * t;
        sBits[grp][lc] = (uint8_t)(w);
        sBits[grp][lc + 1] = (uint8_t)(w >> 8);
        sBits[grp + 1][lc] = (uint8_t)(w >> 16);
        sBits[grp + 1][lc + 1] = (uint8_t)(w >> 24);
      }
    }
  }
  __syncthreads();

  if (tid < BN) {
    const int c = tid;
    int pairs = 0, groups = 0;
    uint8_t any = 0;
    uint8_t* gbp = gb + ((p * (tm / 8) + cm * (BM / 8)) * (long long)tn) +
                   cn * BN + c;
#pragma unroll
    for (int grp = 0; grp < BM / 8; ++grp) {
      const uint8_t byte = sBits[grp][c];
      gbp[grp * (long long)tn] = byte;
      pairs += __popc(byte);
      groups += byte != 0;
      any |= byte;
    }
    g64[(p * (tm / BM) + cm) * (long long)tn + cn * BN + c] = any != 0;
    int supers = any != 0;
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
  }
}

// ------------------------------- kernels 1, 3, 4: int8, TMA ring + wgmma

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

// one box [rows, 128 bytes] of a 2-D int8 tensor map into shared memory
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
// this layout.  Adding 2 advances the start by 32 bytes, one k32 step.
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

// d += A[64 x 32 bytes] . B[N x 32 bytes]^T, s8 x s8 -> s32, both from
// shared-memory descriptors; d is the m64nN accumulator of this thread.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The persistent warp-specialized mainloop of kernels 1, 3 and 4.  Tiles
// are handed out dynamically: the producer takes the next tile index from
// *next_tile (zero on entry) with atomicAdd and passes it to the consumers
// through two shared slots with their own full / empty barriers, so the
// tiles in flight on the card stay a contiguous window of the list (their
// operand panels shared in L2) however far one block falls behind.  Job
// gives the tile list: n_tiles, tile(t, ar, br) -> live (operand rows of
// the tile's row 0 and column 0; a dead tile is not loaded); prefetch(t,
// live, ar, br, wg, tid, pre) issues the epilogue's global loads into
// registers before the K loop, so their latency hides behind it; and
// epilogue(t, live, ar, br, wg, warp, lane, acc, pre, wg_smem), where
// wg_smem is the warpgroup's own WG_BYTES of shared memory.
template <class T, class Job>
__global__ void __launch_bounds__(T::THREADS, 1)
int8_ring_kernel(const __grid_constant__ CUtensorMap map_a,
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
      int acc[T::BN / 2];
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
            wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
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

// Kernels 1 and 3: the sub-tiles of the block list, threshold + bit-pack.
template <class T>
struct ScoreJob {
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
  // 64 + c column br + c; thread tid loads entries tid + 128 k
  static constexpr int NPRE = (T::AUX + 127) / 128;
  struct Pre {
    float v[3][NPRE];
  };

  __device__ __forceinline__ void prefetch(int, bool live, int ar, int br,
                                           int wg, int tid, Pre& pre) const {
#pragma unroll
    for (int k = 0; k < NPRE; ++k) {
      const int i = tid + 128 * k;
      if (live && i < T::AUX) {
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
                                           const int (&acc)[R],
                                           const Pre& pre,
                                           uint8_t* wg_smem) const {
    uint8_t* sbits = wg_smem;  // [8][BN] hit bytes
    float* saux = reinterpret_cast<float*>(wg_smem + T::BITS_BYTES);
    const int tid = warp * 32 + lane;
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
              int8_hit(acc[4 * j + e], saux[ri], saux[T::AUX + ri],
                       saux[2 * T::AUX + ri], saux[cj], saux[T::AUX + cj],
                       saux[2 * T::AUX + cj], tau);
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

// [rows, row_bytes] int8, boxes of box_rows x 128 bytes, 128-byte swizzle.
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
    e = cudaFuncSetAttribute(int8_ring_kernel<T, Job>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
  if (e != cudaSuccess) return (int)e;
  int8_ring_kernel<T, Job><<<sms, T::THREADS, T::SMEM,
                             (cudaStream_t)stream>>>(
      ma, mb, (int)(row_bytes / KSTAGE), (int*)next_tile, job);
  return (int)cudaGetLastError();
}

template <class T>
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
  ScoreJob<T> job{(int)n_tiles, (const int*)tiles, (const int*)bi,
                  (const int*)bj, (const int*)valid, tm / T::BM, tn / T::BN,
                  tm, tn, off_row, off_col, (const float*)aux_i,
                  (const float*)aux_j, rows_i, rows_j, tau, (uint8_t*)gb,
                  (uint8_t*)g64, (int*)cnt};
  return launch_ring<T>(xi, rows_i, xj, rows_j, row_bytes, job, next_tile,
                        stream);
}

// the thread-block tile is chosen by shape: 128 x 256 where it divides the
// block tile, else 64 x 128 (the wrappers' int8_tile makes the same choice
// for the sub-tile list)
int score_int8(const void* xi, const void* xj, long long row_bytes,
               const void* aux_i, int rows_i, const void* aux_j, int rows_j,
               const void* tiles, const void* bi, const void* bj,
               const void* valid, int off_row, int off_col, float tau,
               int n_blocks, int tm, int tn, void* gb, void* g64, void* cnt,
               void* next_tile, void* stream) {
  auto* f = (tm % Big::BM == 0 && tn % Big::BN == 0) ? launch_score<Big>
                                                     : launch_score<Small>;
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
  return score_int8(xq, xq, dim_cap, aux, row_cap, aux, row_cap, tiles, bi,
                    bj, nullptr, 0, 0, tau_eff, n_blocks, tm, tn, gb, g64,
                    cnt, next_tile, stream);
}

// x bf16 [row_cap, dim_cap]; the rest as score_bits_int8, without tiles
// and next_tile.
int score_bits_bf16(const void* x, const void* bi, const void* bj,
                    float tau_eff, int row_cap, int dim_cap, int n_blocks,
                    int tm, int tn, void* gb, void* g64, void* cnt,
                    void* stream) {
  const long long row_bytes = 2LL * dim_cap;
  if (tm % BM || tn % BN || row_bytes % KB || row_cap % tm || row_cap % tn)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)n_blocks * (tm / BM) * (tn / BN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  score_bits_kernel<Bf16Op, false><<<(unsigned)grid, THREADS, 0,
                                     (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const uint8_t*)x, row_bytes, nullptr, row_cap,
      nullptr, row_cap, (const int*)bi, (const int*)bj, nullptr, 0, 0,
      tau_eff, tm, tn, (uint8_t*)gb, (uint8_t*)g64, (int*)cnt);
  return (int)cudaGetLastError();
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
  return score_int8(xi, xj, dim_cap, auxi, rows_i, auxj, rows_j, tiles, bi,
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

}  // extern "C"
