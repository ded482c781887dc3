// Upper-triangle all-pairs score kernels for Hopper (sm_90a), int8 and bf16.
//
// Replaces the TPU kernels of apsim_tpu/ops/pallas_score.py:
//   score_bits_int8  <- _kernel_int8 (launched by pallas_score_bits_int8)
//   score_bits_bf16  <- _kernel      (launched by pallas_score_bits)
//
// For every block p of the upper-triangle block list (bi[p], bj[p]) the
// kernels score the tm x tn tile X[bi*tm:, :] . X[bj*tn:, :]^T over all of K,
// admit a cell when its score clears tau_eff AND its global row is below its
// global column, and write the same hit structure as the TPU kernels:
//   gb  [n_blocks, tm/8,  tn] uint8  bit o of byte (g, c) = row g*8+o
//   g64 [n_blocks, tm/64, tn] uint8  any hit among the 64 rows of a super
//   cnt [n_blocks, 3]         int32  (pairs, hit groups, hit supers)
// cnt must be zero on entry: every thread block adds its counts with int32
// atomicAdd, which is order-independent, so the totals are exact.
//
// int8 epilogue (pallas_score.py:478-483): D = q_i . q_j in int32,
//   s_hat = D * (a_i a_j),  bound = 0.5 (a_j b_i + a_i b_j)
//                                   + 0.25 (a_i a_j) min(n_i, n_j)
//   hit  <=>  s_hat + bound >= tau_eff.
// Written with __fmul_rn/__fadd_rn in exactly that order (and built with
// --fmad=false), so no FMA contraction: gb/g64/cnt are bit-identical to the
// plain PyTorch version.  The int32 accumulator is neither widened nor
// saturated; the engine only takes this path while 127^2 * max_nnz < 2^30.
//
// Work layout.  A TPU block (1024 x 512) does not fit one SM, so one thread
// block owns a 64-row x 128-column sub-tile of one (bi, bj) block: 64 rows
// are one super-group, so its g64 byte and the 8 gb bytes of every column
// are produced inside the thread block.  It reads its own bi[p]/bj[p] (the
// TPU's scalar prefetch) and loops over all of K in 128-byte stages.  Eight
// warps (2 x 4) each own 32 x 32 cells and run mma.sync
// (m16n8k32 s8.s8->s32, m16n8k16 bf16.bf16->f32); both shapes consume 8
// 32-bit words of K per row per step, so one fragment loader serves both.
// Sub-tiles that lie wholly on or below the diagonal skip the K loop.  Hits
// are bit-packed with warp shuffles into a shared [8][128] byte tile, which
// 128 threads then write out column-coalesced with the counts.
//
// What bounds it on the card.  Each sub-tile streams its 64-row and
// 128-row operand panels over all of K: (64 + 128) * K bytes for
// 2 * 64 * 128 * K ops, 85 ops per byte.  At the int8 dense peak
// (1,979 TOPS) that needs ~23 TB/s of operand bandwidth, far beyond HBM
// (3.35 TB/s) and what L2 reuse recovers at these tile sizes, so the kernel
// is operand-bytes bound, not tensor-core bound.  The single-buffered
// shared tile with a register prefetch of the next stage also stalls on
// every __syncthreads.  Left for later: wgmma on 128 x 256 warpgroup tiles
// fed by a TMA ring of stages, a persistent schedule over the block list
// that keeps operand panels in L2, and the row/column offsets plus the
// per-block valid flag of the cross-panel kernel (ops/panel.py:
// _kernel_int8_cross), which enter only where row0/col0 are formed.

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

// x: [row_cap, row_bytes] operand rows (int8 values or bf16 pairs);
// aux: [3, row_cap] f32 (int8 only, else unused).
template <class Op, bool kAux>
__global__ void __launch_bounds__(THREADS)
score_bits_kernel(const uint8_t* __restrict__ x, long long row_bytes,
                  const float* __restrict__ aux, int row_cap,
                  const int* __restrict__ bi, const int* __restrict__ bj,
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
  const int row0 = bi[p] * tm + cm * BM;  // global row of local row 0
  const int col0 = bj[p] * tn + cn * BN;  // global column of local column 0

  if (kAux) {
    for (int i = tid; i < BM + BN; i += THREADS) {
      const int r = i < BM ? row0 + i : col0 + (i - BM);
      float* dst = i < BM ? sAuxI[i] : sAuxJ[i - BM];
      dst[0] = aux[r];
      dst[1] = aux[row_cap + r];
      dst[2] = aux[2LL * row_cap + r];
    }
  }

  typename Op::Acc acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  // no cell with row < col when the smallest row is >= the largest column
  const bool live = row0 < col0 + BN - 1;
  if (live) {
    const uint8_t* xa = x + (long long)row0 * row_bytes;
    const uint8_t* xb = x + (long long)col0 * row_bytes;
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
        const bool h = (row0 + lr < col0 + lc) &&
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

template <class Op, bool kAux>
int launch(const void* x, long long row_bytes, const void* aux, int row_cap,
           const void* bi, const void* bj, float tau, int n_blocks, int tm,
           int tn, void* gb, void* g64, void* cnt, void* stream) {
  if (tm % BM || tn % BN || row_bytes % KB || row_cap % tm || row_cap % tn)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)n_blocks * (tm / BM) * (tn / BN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  score_bits_kernel<Op, kAux><<<(unsigned)grid, THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)x, row_bytes, (const float*)aux, row_cap,
      (const int*)bi, (const int*)bj, tau, tm, tn, (uint8_t*)gb,
      (uint8_t*)g64, (int*)cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xq int8 [row_cap, dim_cap], aux f32 [3, row_cap], bi/bj int32 [n_blocks];
// outputs as in the header comment.  Returns cudaGetLastError() after the
// launch (0 = launched).
int score_bits_int8(const void* xq, const void* aux, const void* bi,
                    const void* bj, float tau_eff, int row_cap, int dim_cap,
                    int n_blocks, int tm, int tn, void* gb, void* g64,
                    void* cnt, void* stream) {
  return launch<Int8Op, true>(xq, dim_cap, aux, row_cap, bi, bj, tau_eff,
                              n_blocks, tm, tn, gb, g64, cnt, stream);
}

// x bf16 [row_cap, dim_cap]; the rest as score_bits_int8.
int score_bits_bf16(const void* x, const void* bi, const void* bj,
                    float tau_eff, int row_cap, int dim_cap, int n_blocks,
                    int tm, int tn, void* gb, void* g64, void* cnt,
                    void* stream) {
  return launch<Bf16Op, false>(x, 2LL * dim_cap, nullptr, row_cap, bi, bj,
                               tau_eff, n_blocks, tm, tn, gb, g64, cnt,
                               stream);
}

}  // extern "C"
