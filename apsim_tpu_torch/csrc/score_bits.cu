// All-pairs score kernels for Hopper (sm_90a), int8 and bf16.
//
// Replaces the TPU kernels of apsim_tpu/ops/pallas_score.py,
// apsim_tpu/ops/panel.py and apsim_tpu/ops/panel_mesh.py:
//   score_bits_int8        <- _kernel_int8       (pallas_score_bits_int8)
//   score_bits_bf16        <- _kernel            (pallas_score_bits)
//   panel_score_bits_int8  <- _kernel_int8_cross (panel_score_bits_int8)
//   int8_matmul            <- _mm_kernel         (_int8_matmul)
//
// int8_matmul is the plain per-shard partial dot of the mesh panel join:
// out = xi . xj^T in int32 over the full m x n grid, no block list, no
// epilogue; it shares the mainloop below and is described at its kernel.
// What bounds it: at the join's shapes (m = n = 8192, d = 32,768 on one
// shard, 4,096 on eight) it does 2 m n d ops on (m + n) d + 4 m n bytes:
// ~1,600 ops per byte at d = 4,096 and ~5,500 at 32,768, above the card's
// ~590 (1,979 TOPS over 3.35 TB/s), so operations bound it (2.2 ms against
// 0.24 ms of bytes at d = 32,768).  Its 64 x 128 tiles re-read operands
// from L2 at 85 ops per byte, as the score kernels do (below).
//
// The score kernels are one template.  For every block p of a block list
// (bi[p], bj[p]) it scores the tm x tn tile Xi[bi*tm:, :] . Xj[bj*tn:, :]^T
// over all of K, admits a cell when its score clears tau_eff AND its GLOBAL
// row is below its GLOBAL column, and writes the same hit structure as the
// TPU kernels:
//   gb  [n_blocks, tm/8,  tn] uint8  bit o of byte (g, c) = row g*8+o
//   g64 [n_blocks, tm/64, tn] uint8  any hit among the 64 rows of a super
//   cnt [n_blocks, 3]         int32  (pairs, hit groups, hit supers)
// Global coordinates are the local ones plus a per-launch offset
// (off_row, off_col): the panel origins of a cross-panel rectangle, or 0
// for the dense upper triangle, which is the same launch with Xj = Xi.  An
// optional valid[n_blocks] (null = all valid) blanks a block: it writes
// zero bytes and adds no counts.  Every gb/g64 byte of every block is
// written (the wrappers allocate them with torch.empty); cnt must be zero
// on entry: every thread block adds its counts with int32 atomicAdd, which
// is order-independent, so the totals are exact.
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
// Work layout.  A TPU block (1024 x 512) does not fit one SM, so one thread
// block owns a 64-row x 128-column sub-tile of one (bi, bj) block: 64 rows
// are one super-group, so its g64 byte and the 8 gb bytes of every column
// are produced inside the thread block.  It reads its own bi[p]/bj[p] (the
// TPU's scalar prefetch) and loops over all of K in 128-byte stages.  Eight
// warps (2 x 4) each own 32 x 32 cells and run mma.sync
// (m16n8k32 s8.s8->s32, m16n8k16 bf16.bf16->f32); both shapes consume 8
// 32-bit words of K per row per step, so one fragment loader serves both.
// Sub-tiles that lie wholly on or below the global diagonal, and invalid
// blocks, skip the K loop.  Hits are bit-packed with warp shuffles into a
// shared [8][128] byte tile, which 128 threads then write out
// column-coalesced with the counts.
//
// What bounds it on the card.  Each sub-tile streams its 64-row and
// 128-row operand panels over all of K: (64 + 128) * K bytes for
// 2 * 64 * 128 * K ops, 85 ops per byte.  At the int8 dense peak
// (1,979 TOPS) that needs ~23 TB/s of operand bandwidth, far beyond HBM
// (3.35 TB/s) and what L2 reuse recovers at these tile sizes, so the kernel
// is operand-bytes bound, not tensor-core bound.  The single-buffered
// shared tile with a register prefetch of the next stage also stalls on
// every __syncthreads.  Left for later: wgmma on 128 x 256 warpgroup tiles
// fed by a TMA ring of stages, and a persistent schedule over the block
// list that keeps operand panels in L2.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;            // rows per thread block (one super-group)
constexpr int BN = 128;           // columns per thread block
constexpr int KB = 128;           // bytes of K per row per stage
constexpr int KW = KB / 4;        // 32-bit words of K per row per stage
constexpr int LDS = KW + 4;       // padded shared row stride (words):
                                  // fragment reads hit 32 distinct banks
constexpr int THREADS = 256;      // 8 warps: 2 along rows x 4 along cols
constexpr int A_VECS = BM * KB / 16 / THREADS;  // uint4 loads per thread
constexpr int B_VECS = BN * KB / 16 / THREADS;

struct Int8Op {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // aux rows: alpha, alpha * L1(q), nnz
  static __device__ __forceinline__ bool hit(int acc, const float* ri,
                                             const float* cj, float tau) {
    const float ai = ri[0], bi = ri[1], ni = ri[2];
    const float aj = cj[0], bj = cj[1], nj = cj[2];
    const float aa = __fmul_rn(ai, aj);
    const float s_hat = __fmul_rn(__int2float_rn(acc), aa);
    const float bound =
        __fadd_rn(__fmul_rn(0.5f, __fadd_rn(__fmul_rn(aj, bi), __fmul_rn(ai, bj))),
                  __fmul_rn(__fmul_rn(0.25f, aa), fminf(ni, nj)));
    return __fadd_rn(s_hat, bound) >= tau;
  }
};

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

// The shared mainloop: acc += xa[0:64, :] . xb[0:128, :]^T over all of K
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

// xi: [rows_i, row_bytes], xj: [rows_j, row_bytes] operand rows (int8
// values or bf16 pairs); aux_i/aux_j: [3, rows_i] / [3, rows_j] f32 (int8
// only, else unused); valid: [n_blocks] int32 or null.
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

// Kernel 4: out[m, n] = xi[m, d] . xj[n, d]^T in int32, no epilogue.  One
// thread block per 64 x 128 output tile over the full (m/64) x (n/128) grid,
// column tiles fastest, the whole K loop inside the block (the Pallas grid's
// K axis and its VMEM accumulator become mainloop's registers).  Each warp
// stores its 32 x 32 cells as int2 pairs: lanes 4g..4g+3 write 32 contiguous
// bytes of one output row.
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const uint8_t* __restrict__ xi,
                   const uint8_t* __restrict__ xj, long long d, int n,
                   int* __restrict__ out) {
  __shared__ __align__(16) uint32_t sA[BM * LDS];
  __shared__ __align__(16) uint32_t sB[BN * LDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n_tiles = n / BN;
  const long long row0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int col0 = (int)(blockIdx.x % n_tiles) * BN;

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  mainloop<Int8Op>(xi + row0 * d, xj + (long long)col0 * d, d, sA, sB, acc);

  // fragment element i of tile (mt, nt): row wm*32 + mt*16 + g + 8*(i/2),
  // column wn*32 + nt*8 + 2t + (i%2)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const long long r = row0 + wm * 32 + mt * 16 + g;
      const int c = col0 + wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<int2*>(out + r * n + c) =
          make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(out + (r + 8) * n + c) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <class Op, bool kAux>
int launch(const void* xi, const void* xj, long long row_bytes,
           const void* aux_i, int rows_i, const void* aux_j, int rows_j,
           const void* bi, const void* bj, const void* valid, int off_row,
           int off_col, float tau, int n_blocks, int tm, int tn, void* gb,
           void* g64, void* cnt, void* stream) {
  if (tm % BM || tn % BN || row_bytes % KB || rows_i % tm || rows_j % tn)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)n_blocks * (tm / BM) * (tn / BN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  score_bits_kernel<Op, kAux><<<(unsigned)grid, THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)xi, (const uint8_t*)xj, row_bytes,
      (const float*)aux_i, rows_i, (const float*)aux_j, rows_j,
      (const int*)bi, (const int*)bj, (const int*)valid, off_row, off_col,
      tau, tm, tn, (uint8_t*)gb, (uint8_t*)g64, (int*)cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dense upper triangle.  xq int8 [row_cap, dim_cap], aux f32 [3, row_cap],
// bi/bj int32 [n_blocks]; outputs as in the header comment.  Returns
// cudaGetLastError() after the launch (0 = launched).
int score_bits_int8(const void* xq, const void* aux, const void* bi,
                    const void* bj, float tau_eff, int row_cap, int dim_cap,
                    int n_blocks, int tm, int tn, void* gb, void* g64,
                    void* cnt, void* stream) {
  return launch<Int8Op, true>(xq, xq, dim_cap, aux, row_cap, aux, row_cap,
                              bi, bj, nullptr, 0, 0, tau_eff, n_blocks, tm,
                              tn, gb, g64, cnt, stream);
}

// x bf16 [row_cap, dim_cap]; the rest as score_bits_int8.
int score_bits_bf16(const void* x, const void* bi, const void* bj,
                    float tau_eff, int row_cap, int dim_cap, int n_blocks,
                    int tm, int tn, void* gb, void* g64, void* cnt,
                    void* stream) {
  return launch<Bf16Op, false>(x, x, 2LL * dim_cap, nullptr, row_cap,
                               nullptr, row_cap, bi, bj, nullptr, 0, 0,
                               tau_eff, n_blocks, tm, tn, gb, g64, cnt,
                               stream);
}

// One cross-panel rectangle.  xi int8 [rows_i, dim_cap], xj int8
// [rows_j, dim_cap], auxi/auxj f32 [3, rows_i] / [3, rows_j], bi/bj int32
// [n_blocks] (local tile ids), valid int32 [n_blocks] or null, (off_row,
// off_col) the global rows of xi's and xj's row 0.
int panel_score_bits_int8(const void* xi, const void* xj, const void* auxi,
                          const void* auxj, const void* bi, const void* bj,
                          const void* valid, int off_row, int off_col,
                          float tau_eff, int rows_i, int rows_j, int dim_cap,
                          int n_blocks, int tm, int tn, void* gb, void* g64,
                          void* cnt, void* stream) {
  return launch<Int8Op, true>(xi, xj, dim_cap, auxi, rows_i, auxj, rows_j,
                              bi, bj, valid, off_row, off_col, tau_eff,
                              n_blocks, tm, tn, gb, g64, cnt, stream);
}

// Kernel 4.  xi int8 [m, d], xj int8 [n, d], out int32 [m, n] (every
// element written); m % 64, n % 128 and d % 128 must be 0.
int int8_matmul(const void* xi, const void* xj, int m, int n, int d,
                void* out, void* stream) {
  if (m % BM || n % BN || d % KB || m < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)(m / BM) * (n / BN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  if (d == 0) return (int)cudaMemsetAsync(out, 0, (size_t)m * n * sizeof(int),
                                          (cudaStream_t)stream);
  int8_matmul_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)xi, (const uint8_t*)xj, d, n, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
