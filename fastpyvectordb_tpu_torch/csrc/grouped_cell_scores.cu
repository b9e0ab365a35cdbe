// Grouped (cell-major) IVF cell scores for Hopper (sm_90a): every query slot
// of a probed cell against every row of that cell, metric epilogue and
// validity mask fused, -> (U, qcap, cmax) f32 scores, lower = closer.
//
// Replaces the TPU Pallas kernels in fastpyvectordb_tpu/kernels/pallas_ivf.py:
//   fpv_grouped_cell_scores    <- grouped_cell_scores    (_kernel_f, _epilogue):
//                                 bf16 slots x bf16 cells, f32 accumulation
//   fpv_grouped_cell_scores_i8 <- grouped_cell_scores_i8 (_kernel_i8):
//                                 s8 slots x s8 cells, s32 accumulation, then
//                                 cross = float(cross_i) * sscale + sconst
// Each kernel is one template; the two entries differ in the operand type
// and in the first step of the epilogue.
//
// What it computes, for each compact slot u < cell_ids[0] (the batch's
// unique probed cells; cell = cell_ids[1 + u]), query slot s < qcap and cell
// row c < cmax:
//   cross  = sum_d qblk[u, s, d] * cells[cell, c, d]
//   cosine: 1 - cross * qstat[u, s] * rsqrt(max(norms[cell, c], 1e-30))
//   l2:     max(qstat[u, s] + norms[cell, c] - 2 * cross, 0)
//   dot:    -cross
//   then MASKED (3e38) where okf[cell, c] <= 0.5.
// Rows u >= cell_ids[0] are left unwritten (the caller never reads them).
//
// Two kernels live here.  The launcher takes the cell stream below for every
// shape TMA can address (row pitch D * sizeof(T) a multiple of 16 bytes,
// 16-byte aligned bases: stream_ok) and the first-slice kernel (namespace
// first_slice, nvcuda::wmma, global -> registers -> shared loads) for the
// rest, by that explicit test of the operands and never on a failure.
//
// The cell stream (namespace cell_stream): one persistent 384-thread block an SM
// walks the work list (compact slot u, 128-row cmax tile, pass of NT query
// slots); it reads cell_ids[0] itself (the TPU kernel's scalar prefetch +
// pl.when), so no host sync learns n_uniq.
//   * Warpgroup 2's first thread is the producer: for every 128-byte K step
//     it issues two TMA loads into a ring of 128B-swizzled stages on
//     mbarriers, the cell tile from a 3-D map over (nlist, cmax, D) with the
//     cell id as a run-time coordinate (the gather cells[cell] costs
//     nothing) and the slot tile from a 3-D map over (U, qcap, D).  A box
//     never runs into the next cell or slot block, and TMA's zero fill masks
//     the ragged cmax, qcap and D edges.
//   * Warpgroups 0 and 1 are the consumers, 64 cell rows each.  Orientation:
//     the cell rows are wgmma's M side and the query slots its N side (NT =
//     16 ... 256 by qcap), both operands read from shared memory.  With the
//     cells as M, a narrow qcap (8-32) wastes no tensor-core rows and the
//     accumulators of the whole qcap (up to 256 slots a pass) fit one
//     thread's registers, so every cell byte leaves device memory once and
//     no second block reads it again.  The price is a transposed
//     accumulator, paid in the epilogue's staging tile.
//   * The epilogue runs from the accumulators: norms and okf of a thread's
//     two cell rows are read once a tile into registers, qstat / sscale /
//     sconst of the pass once a tile into shared memory; the same rounded,
//     uncontracted operations as the plain version; scores go 64 slots x 64
//     rows at a time through a swizzled staging tile (two in turn from
//     128 slots a pass on) and out by TMA (3-D map over (U, qcap, cmax):
//     clipped at the qcap and cmax edges), the last store draining under
//     the next tile's products.  Where cmax is
//     not a multiple of 4 (TMA needs 16-byte rows) they are stored from
//     registers.
//
// What bounds it: at the main path's shapes (U = 2048 probed cells, cmax 640,
// D 768; bf16 at nprobe 32: qcap 128, int8 at nprobe 16: qcap 64) the kernel
// streams the probed cells once (2.0 GB bf16 / 1.0 GB int8), the slots and
// the output: bytes, not products.  On an H100 80GB HBM3 at 700 W the bf16
// entry takes ~1.1 ms for its 3.09 GB (2.8 TB/s, 84% of the card's rate;
// the first-slice kernel 2.34 ms) and the int8 entry 0.49 ms (0.84);
// without the output stores 0.82 / 0.39 ms, without the products the same
// as with them (tools/kernel_variants.py): what is left over the bound is
// the epilogue, during which a block's ring fills and its loads pause.
//
// The first-slice kernel: one 128-thread block per (compact slot u, 128-row
// cmax tile, tile of query slots), flattened with the query-slot tile
// fastest.  Tile rows follow qcap: 8 rows (wmma 8x32x16) for qcap <= 8, 16
// for <= 16, 32 for <= 32, and 64-row tiles side by side above that.
// Ragged D, cmax and qcap edges are masked there (zero-filled operands,
// unwritten outputs): any shape is taken.  Its shared-memory layout: each
// 64-byte row slice of a chunk is split by wmma k-step into
// [k-step][row][16 elements], so every fragment pointer is 32-byte aligned
// for both operand types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_common.cuh"

using namespace nvcuda;

namespace {

constexpr float MASKED = 3.0e38f;

enum Metric { COSINE = 0, L2 = 1, DOT = 2 };

// ---------------------------------------------------------------------------
// the first-slice kernel: shapes TMA cannot address
// ---------------------------------------------------------------------------
namespace first_slice {

constexpr int BN = 128;            // cell rows per block
constexpr int THREADS = 128;       // 4 warps, each owning 32 cell rows
constexpr int ROW_BYTES = 64;      // bytes of one operand row per chunk
constexpr int VECS = ROW_BYTES / 16;  // 16-byte vectors per row per chunk

template <typename T> struct Op;
template <> struct Op<__nv_bfloat16> { using Acc = float; using Raw = uint16_t; };
template <> struct Op<signed char> { using Acc = int; using Raw = signed char; };

template <typename T> struct Cfg {
  static constexpr int ES = sizeof(T);
  static constexpr int PER = 16 / ES;            // elements per 16-byte vector
  static constexpr int KW = 16 * ES;             // bytes of one wmma k-step row
  static constexpr int KS = ROW_BYTES / KW;      // k-steps per chunk (2 or 4)
  static constexpr int CHUNK = ROW_BYTES / ES;   // elements per chunk
};

// One 16-byte vector of a row, starting at element e; zeros past D or for a
// row outside the tile.  `vec` (D a multiple of the vector, aligned bases)
// allows the single 16-byte load.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int e,
                                          int D, bool ok, bool vec) {
  using Raw = typename Op<T>::Raw;
  constexpr int PER = Cfg<T>::PER;
  if (!ok || e >= D) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + e));
  union {
    uint4 u;
    Raw r[PER];
  } x;
  x.u = make_uint4(0u, 0u, 0u, 0u);
  const Raw* p = reinterpret_cast<const Raw*>(row) + e;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (e + i < D) x.r[i] = __ldg(p + i);
  return x.u;
}

// The byte offset of vector v of row r in a [k-step][rows][KW] chunk buffer.
template <typename T>
__device__ __forceinline__ int slot_of(int r, int v, int rows) {
  const int byte = v * 16;
  return (byte / Cfg<T>::KW) * rows * Cfg<T>::KW + r * Cfg<T>::KW +
         byte % Cfg<T>::KW;
}

template <typename T, int TM, int FM>
__global__ void __launch_bounds__(THREADS)
grouped_kernel(const int* __restrict__ cell_ids,   // (U + 1,)
               const T* __restrict__ qblk,         // (U, qcap, D)
               const T* __restrict__ cells,        // (nlist, cmax, D)
               const float* __restrict__ norms,    // (nlist, cmax)
               const float* __restrict__ okf,      // (nlist, cmax)
               const float* __restrict__ sscale,   // (U, qcap), int8 only
               const float* __restrict__ sconst,   // (U, qcap), int8 only
               const float* __restrict__ qstat,    // (U, qcap)
               float* __restrict__ out,            // (U, qcap, cmax)
               int qcap, int cmax, int D, int metric, bool vec) {
  using C = Cfg<T>;
  using Acc = typename Op<T>::Acc;
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int BM = TM * FM;                 // query slots per block
  constexpr int TN = 256 / TM;                // wmma tile columns (16 / 32)
  constexpr int FN = 32 / TN;                 // tiles per warp across its 32 rows
  constexpr int QV = (BM * VECS + THREADS - 1) / THREADS;
  constexpr int CV = BN * VECS / THREADS;
  __shared__ __align__(128) unsigned char As[2][BM * ROW_BYTES];
  __shared__ __align__(128) unsigned char Bs[2][BN * ROW_BYTES];
  __shared__ __align__(128) Acc stage[THREADS / 32][TM * TN];

  const int tz = (qcap + BM - 1) / BM;
  const int ty = (cmax + BN - 1) / BN;
  const int u = blockIdx.x / (ty * tz);
  if (u >= __ldg(cell_ids)) return;  // the compact list's padding tail
  const int cell = __ldg(cell_ids + 1 + u);
  const int n0 = (blockIdx.x / tz) % ty * BN;
  const int m0 = blockIdx.x % tz * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* qbase = qblk + (size_t)u * qcap * D;
  const T* cbase = cells + (size_t)cell * cmax * D;

  uint4 qr[QV], cr[CV];
  // thread t loads vector t % 4 of rows t / 4 + 32 i: a warp reads 8 rows x
  // 64 contiguous bytes per instruction
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / VECS;
      const bool ok = idx < BM * VECS && m0 + r < qcap;
      qr[i] = load_vec<T>(qbase + (size_t)(ok ? m0 + r : 0) * D,
                          k0 + (idx % VECS) * C::PER, D, ok, vec);
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / VECS;
      const bool ok = n0 + r < cmax;
      cr[i] = load_vec<T>(cbase + (size_t)(ok ? n0 + r : 0) * D,
                          k0 + (idx % VECS) * C::PER, D, ok, vec);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < BM * VECS)
        *reinterpret_cast<uint4*>(
            &As[buf][slot_of<T>(idx / VECS, idx % VECS, BM)]) = qr[i];
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<uint4*>(
          &Bs[buf][slot_of<T>(idx / VECS, idx % VECS, BN)]) = cr[i];
    }
  };

  wmma::fragment<wmma::accumulator, TM, TN, 16, Acc> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const int nk = (D + C::CHUNK - 1) / C::CHUNK;
  fetch(0);
  put(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) fetch((kc + 1) * C::CHUNK);  // in flight during the MMAs
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      const T* a = reinterpret_cast<const T*>(&As[buf][ks * BM * C::KW]);
      const T* b = reinterpret_cast<const T*>(
          &Bs[buf][ks * BN * C::KW + warp * 32 * C::KW]);
      wmma::fragment<wmma::matrix_a, TM, TN, 16, T, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, TM, TN, 16, T, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + i * TM * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], b + j * TN * 16, 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kc + 1 < nk) put(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each lane finishes 8 consecutive cell rows of one slot
  Acc* st = stage[warp];
  constexpr int LPR = TN / 8;          // lanes per staging row
  const int r = lane / LPR;
  const int c0 = (lane % LPR) * 8;
  const bool vec_out = (cmax % 4) == 0;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], TN, wmma::mem_row_major);
      __syncwarp();
      const int s = m0 + i * TM + r;
      const int c = n0 + warp * 32 + j * TN + c0;
      if (s < qcap && c < cmax) {
        const size_t srow = (size_t)u * qcap + s;
        const float qs = __ldg(qstat + srow);
        float sc = 0.0f, so = 0.0f;
        if (INT8) {
          sc = __ldg(sscale + srow);
          so = __ldg(sconst + srow);
        }
        const float* nrm = norms + (size_t)cell * cmax + c;
        const float* okp = okf + (size_t)cell * cmax + c;
        float res[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          res[e] = MASKED;
          if (c + e < cmax && __ldg(okp + e) > 0.5f) {
            // rounded operations, no contraction: the plain version's
            // roundings, step by step
            const float cross =
                INT8 ? __fadd_rn(__fmul_rn(float(st[r * TN + c0 + e]), sc), so)
                     : float(st[r * TN + c0 + e]);
            const float nv = __ldg(nrm + e);
            if (metric == COSINE) {
              const float rinv = rsqrtf(fmaxf(nv, 1e-30f));
              res[e] = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(cross, qs), rinv));
            } else if (metric == L2) {
              res[e] = fmaxf(
                  __fsub_rn(__fadd_rn(qs, nv), __fmul_rn(2.0f, cross)), 0.0f);
            } else {
              res[e] = -cross;
            }
          }
        }
        float* dst = out + srow * cmax + c;
        if (vec_out && c + 8 <= cmax) {
          reinterpret_cast<float4*>(dst)[0] =
              make_float4(res[0], res[1], res[2], res[3]);
          reinterpret_cast<float4*>(dst)[1] =
              make_float4(res[4], res[5], res[6], res[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c + e < cmax) dst[e] = res[e];
        }
      }
      __syncwarp();
    }
  }
}

template <typename T, int TM, int FM>
void run(unsigned grid, cudaStream_t s, const int* ids, const T* q, const T* c,
         const float* norms, const float* okf, const float* sscale,
         const float* sconst, const float* qstat, float* out, int qcap,
         int cmax, int D, int metric, bool vec) {
  grouped_kernel<T, TM, FM><<<grid, THREADS, 0, s>>>(
      ids, q, c, norms, okf, sscale, sconst, qstat, out, qcap, cmax, D, metric,
      vec);
}

template <typename T>
int launch(const int* ids, const T* q, const T* c, const float* norms,
           const float* okf, const float* sscale, const float* sconst,
           const float* qstat, float* out, int U, int qcap, int cmax, int D,
           int metric, void* stream) {
  if (U <= 0 || qcap <= 0 || cmax <= 0 || D <= 0)
    return int(cudaGetLastError());
  const bool vec = (D % Cfg<T>::PER) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(c) % 16) == 0;
  const int bm = qcap <= 8 ? 8 : qcap <= 16 ? 16 : qcap <= 32 ? 32 : 64;
  const long long blocks = (long long)U * ((cmax + BN - 1) / BN) *
                           ((qcap + bm - 1) / bm);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const unsigned grid = unsigned(blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 8)
    run<T, 8, 1>(grid, s, ids, q, c, norms, okf, sscale, sconst, qstat, out,
                 qcap, cmax, D, metric, vec);
  else if (bm == 16)
    run<T, 16, 1>(grid, s, ids, q, c, norms, okf, sscale, sconst, qstat, out,
                  qcap, cmax, D, metric, vec);
  else if (bm == 32)
    run<T, 16, 2>(grid, s, ids, q, c, norms, okf, sscale, sconst, qstat, out,
                  qcap, cmax, D, metric, vec);
  else
    run<T, 16, 4>(grid, s, ids, q, c, norms, okf, sscale, sconst, qstat, out,
                  qcap, cmax, D, metric, vec);
  return int(cudaGetLastError());
}

}  // namespace first_slice

// ---------------------------------------------------------------------------
// the cell stream: TMA loads, wgmma from shared memory, TMA stores
// ---------------------------------------------------------------------------
namespace cell_stream {

using namespace fpv;

constexpr int BC = 128;                   // cell rows per tile (2 x m64)
constexpr int ROW_BYTES = 128;            // one K step of an operand row
constexpr int CELL_BYTES = BC * ROW_BYTES;
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int PRODUCERS = 128;            // one producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers a thread after setmaxnreg; the two claims leave slack in the
// SM's 65,536 (with none the consumers' claim can wait forever)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 224;
static_assert(PRODUCERS * kProducerRegs + CONSUMERS * kConsumerRegs <=
                  65536 - 2048, "register budget");
constexpr int STAGING = 64 * 64 * 4;      // a consumer's 64 x 64 staging tile
constexpr int TABLES = 3 * 256 * 4;       // its qstat, sscale, sconst of a pass
constexpr int SMEM_MAX = 232448;          // what a block may opt in to
// the cell table's map is given this many cells: the entry points are not
// told nlist, and the compact list only names cells that exist
constexpr int kAnyCells = 1 << 30;

// shared memory: each consumer's staging tiles, two sets of slot tables, then
// the ring (per stage the cell tile and the slot tile of one K step) and its
// barriers.  From 128 slots a pass on, a tile's epilogue takes several
// staging rounds and a consumer alternates two tiles, so that a round's
// writes do not wait for the store before it (bf16, qcap 128: 1.18 -> 1.10
// ms); below, one round a tile gains nothing from the second and the ring
// is better off with its bytes (int8, qcap 64: 0.49 -> 0.54 ms with two).
template <int NT>
struct Layout {
  static constexpr int STAGE = CELL_BYTES + NT * ROW_BYTES;
#ifdef FPV_GROUPED_ONE_BUF   // (tools/kernel_variants.py measures without)
  static constexpr int BUFS = 1;
#else
  static constexpr int BUFS = NT >= 128 ? 2 : 1;
#endif
  static constexpr int TAB = 2 * BUFS * STAGING;
  static constexpr int RING = TAB + 2 * TABLES;
  static constexpr int FIT = (SMEM_MAX - 1024 - RING - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BAR = RING + STAGES * STAGE;
  static constexpr int BYTES = BAR + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0 && RING % 1024 == 0,
                "stages keep the 1024-byte swizzle atoms");
  static_assert(STAGES >= 3, "a ring");
};

// one m64nNTk(32 bytes) wgmma, both operands from shared memory
template <typename T, int NT> struct Mma;

#define FPV_MMA_SS(T, NT, ACC, SHAPE, DLIST, ARGS, A, B, P, TAIL)          \
  template <> struct Mma<T, NT> {                                          \
    static __device__ __forceinline__ void run(ACC (&d)[NT / 2],           \
                                               uint64_t da, uint64_t db,   \
                                               int acc) {                  \
      asm volatile(                                                        \
          "{\n"                                                            \
          ".reg .pred p;\n"                                                \
          "setp.ne.b32 p, " P ", 0;\n"                                     \
          "wgmma.mma_async.sync.aligned." SHAPE " " DLIST ", " A ", " B    \
          ", p" TAIL ";\n"                                                 \
          "}\n"                                                            \
          : ARGS                                                           \
          : "l"(da), "l"(db), "r"(acc));                                   \
    }                                                                      \
  };

#define FPV_BF __nv_bfloat16
#define FPV_BF_TAIL ", 1, 1, 0, 0"
FPV_MMA_SS(FPV_BF, 16, float, "m64n16k16.f32.bf16.bf16", FPV_D8,
           FPV_ACC8(FPV_F, 0), "%8", "%9", "%10", FPV_BF_TAIL)
FPV_MMA_SS(FPV_BF, 32, float, "m64n32k16.f32.bf16.bf16", FPV_D16,
           FPV_ACC16(FPV_F, 0), "%16", "%17", "%18", FPV_BF_TAIL)
FPV_MMA_SS(FPV_BF, 64, float, "m64n64k16.f32.bf16.bf16", FPV_D32,
           FPV_ACC32(FPV_F, 0), "%32", "%33", "%34", FPV_BF_TAIL)
FPV_MMA_SS(FPV_BF, 128, float, "m64n128k16.f32.bf16.bf16", FPV_D64,
           FPV_ACC64(FPV_F, 0), "%64", "%65", "%66", FPV_BF_TAIL)
FPV_MMA_SS(FPV_BF, 256, float, "m64n256k16.f32.bf16.bf16", FPV_D128,
           FPV_ACC128(FPV_F), "%128", "%129", "%130", FPV_BF_TAIL)
FPV_MMA_SS(signed char, 16, int, "m64n16k32.s32.s8.s8", FPV_D8,
           FPV_ACC8(FPV_R, 0), "%8", "%9", "%10", "")
FPV_MMA_SS(signed char, 32, int, "m64n32k32.s32.s8.s8", FPV_D16,
           FPV_ACC16(FPV_R, 0), "%16", "%17", "%18", "")
FPV_MMA_SS(signed char, 64, int, "m64n64k32.s32.s8.s8", FPV_D32,
           FPV_ACC32(FPV_R, 0), "%32", "%33", "%34", "")
FPV_MMA_SS(signed char, 128, int, "m64n128k32.s32.s8.s8", FPV_D64,
           FPV_ACC64(FPV_R, 0), "%64", "%65", "%66", "")
FPV_MMA_SS(signed char, 256, int, "m64n256k32.s32.s8.s8", FPV_D128,
           FPV_ACC128(FPV_R), "%128", "%129", "%130", "")

struct Params {
  const int* cell_ids;    // (U + 1,)
  const float* norms;     // (nlist, cmax)
  const float* okf;       // (nlist, cmax)
  const float* sscale;    // (U, qcap), int8 only
  const float* sconst;    // (U, qcap), int8 only
  const float* qstat;     // (U, qcap)
  float* out;             // (U, qcap, cmax)
  int qcap, cmax, metric;
  int ksteps;             // 128-byte steps that cover a row
  int ctiles, passes;     // cmax tiles of a cell, slot passes of a tile
  int tma_out;            // the scores leave by TMA
};

// the plain version's roundings, step by step: no contraction
template <bool INT8, typename Acc>
__device__ __forceinline__ float score(int metric, Acc acc, float qs, float sc,
                                       float so, float nv, float rinv,
                                       float ok) {
  if (!(ok > 0.5f)) return MASKED;
  const float cross =
      INT8 ? __fadd_rn(__fmul_rn(float(acc), sc), so) : float(acc);
  if (metric == COSINE)
    return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(cross, qs), rinv));
  if (metric == L2)
    return fmaxf(__fsub_rn(__fadd_rn(qs, nv), __fmul_rn(2.0f, cross)), 0.0f);
  return -cross;
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 1)
stream_kernel(const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap omap, const Params p) {
  using L = Layout<NT>;
  using Acc = typename first_slice::Op<T>::Acc;
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int STAGES = L::STAGES;
  constexpr int KE = ROW_BYTES / int(sizeof(T));   // elements a K step
  constexpr int SB = NT < 64 ? NT : 64;            // slots a staging box
  constexpr int OUT_BOX = SB * 32 * 4;             // one SB x 32 f32 store box
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + L::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);               // the producer's arrive + its bytes
      mbar_init(&empty[s], CONSUMERS / 32); // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_cell = p.ctiles * p.passes;
  const int ntiles = __ldg(p.cell_ids) * per_cell;   // unique cells only

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring's TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != CONSUMERS) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int u = tile / per_cell;
      const int cell = __ldg(p.cell_ids + 1 + u);
      const int c0 = (tile / p.passes) % p.ctiles * BC;
      const int s0 = tile % p.passes * NT;
      for (int k = 0; k < p.ksteps; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * L::STAGE;
        mbar_arrive_tx(&full[stage], L::STAGE);
        tma_load_3d(st, &cmap, &full[stage], k * KE, c0, cell);
        tma_load_3d(st + CELL_BYTES, &qmap, &full[stage], k * KE, s0, u);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 cell rows of every tile each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = tid / 128;
  const int t = tid % 128;
  const int w = t / 32;
  const int lane = tid % 32;
  uint8_t* out_base = smem + g * L::BUFS * STAGING;
  int round = 0;
  float* tab = reinterpret_cast<float*>(smem + L::TAB + g * TABLES);
  Acc d[NT / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int u = tile / per_cell;
    const int cell = __ldg(p.cell_ids + 1 + u);
    const int n0 = (tile / p.passes) % p.ctiles * BC + 64 * g;  // group's rows
    const int s0 = tile % p.passes * NT;
    // this thread's accumulator rows: n0 + 16w + lane/4 and + 8
    float nv[2], rinv[2], ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 16 * w + lane / 4 + 8 * h;
      const size_t at = (size_t)cell * p.cmax + min(c, p.cmax - 1);
      nv[h] = __ldg(p.norms + at);
      ok[h] = c < p.cmax ? __ldg(p.okf + at) : 0.0f;
      rinv[h] = rsqrtf(fmaxf(nv[h], 1e-30f));
    }
    // the pass's per-slot tables; the previous tile's readers are done
    named_sync(1 + g, 128);
    for (int i = t; i < NT; i += 128) {
      const size_t at = (size_t)u * p.qcap + min(s0 + i, p.qcap - 1);
      tab[i] = __ldg(p.qstat + at);
      if (INT8) {
        tab[256 + i] = __ldg(p.sscale + at);
        tab[512 + i] = __ldg(p.sconst + at);
      }
    }

    int prev = 0;
    for (int k = 0; k < p.ksteps; ++k) {
      mbar_wait(&full[stage], phase);
      const uint8_t* st = ring + stage * L::STAGE;
      const uint64_t da = sw128_desc(st + g * 64 * ROW_BYTES);
      const uint64_t db = sw128_desc(st + CELL_BYTES);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#ifndef FPV_GROUPED_NO_MMA   // (tools/kernel_variants.py measures without)
        Mma<T, NT>::run(d, da + 2 * kk, db + 2 * kk, (k > 0 || kk > 0) ? 1 : 0);
#endif
      }
      wgmma_commit();
      if (k > 0) {
        // the previous step's products have completed: release its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    if (lane == 0) mbar_arrive(&empty[prev]);
    named_sync(1 + g, 128);   // the tables are written

    // accumulator layout of m64nNT: register 4i + e of warp w, lane l is
    // cell row 16w + l/4 (+8 for e >= 2) and slot 8i + 2(l%4) + (e & 1)
    const int cq = 2 * (lane % 4);
    if (p.tma_out) {
      // SB slots x 64 rows at a time through the staging tile: two swizzled
      // SB x 32 boxes, stored by the warpgroup's first thread
#pragma unroll
      for (int qc = 0; qc < NT / SB; ++qc) {
        // the store that last read this staging tile has done so
        uint8_t* out_s = out_base + (round++ % L::BUFS) * STAGING;
        if (t == 0) bulk_wait_read<L::BUFS - 1>();
        named_sync(1 + g, 128);
#pragma unroll
        for (int ii = 0; ii < SB / 8; ++ii) {
          const int i = (SB / 8) * qc + ii;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = 8 * ii + cq + (e & 1);          // slot in the box
            const int sl = SB * qc + qr;                   // slot in the pass
            const int col = 16 * w + lane / 4 + 8 * (e >> 1);
            const int h = e >> 1;
            const float s = score<INT8>(
                p.metric, d[4 * i + e], tab[sl], INT8 ? tab[256 + sl] : 0.0f,
                INT8 ? tab[512 + sl] : 0.0f, nv[h], rinv[h], ok[h]);
            *reinterpret_cast<float*>(out_s + (col / 32) * OUT_BOX +
                                      sw128_chunk(qr, (col % 32) / 4) +
                                      4 * (col % 4)) = s;
          }
        }
        fence_proxy_async();
        named_sync(1 + g, 128);
#ifndef FPV_GROUPED_NO_STORE
        if (t == 0 && n0 < p.cmax && s0 + SB * qc < p.qcap) {
          tma_store_3d(&omap, out_s, n0, s0 + SB * qc, u);
          if (n0 + 32 < p.cmax)
            tma_store_3d(&omap, out_s + OUT_BOX, n0 + 32, s0 + SB * qc, u);
          bulk_commit();
        }
#endif
      }
    } else {
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sl = 8 * i + cq + (e & 1);
          const int h = e >> 1;
          const int c = n0 + 16 * w + lane / 4 + 8 * h;
          if (s0 + sl < p.qcap && c < p.cmax)
            p.out[((size_t)u * p.qcap + s0 + sl) * p.cmax + c] = score<INT8>(
                p.metric, d[4 * i + e], tab[sl], INT8 ? tab[256 + sl] : 0.0f,
                INT8 ? tab[512 + sl] : 0.0f, nv[h], rinv[h], ok[h]);
        }
      }
    }
  }
  if (t == 0) bulk_wait_all();
}

template <typename T, int NT>
int run(const CUtensorMap& cmap, const CUtensorMap& qmap,
        const CUtensorMap& omap, const Params& p, long long tiles,
        cudaStream_t s) {
  const int bytes = 1024 + Layout<NT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      stream_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = int(tiles < sms ? tiles : sms);   // persistent blocks
  stream_kernel<T, NT><<<grid, THREADS, bytes, s>>>(cmap, qmap, omap, p);
  return int(cudaGetLastError());
}

// slots a pass (wgmma's N): the narrowest shape that holds qcap, 256 above
inline int pass_slots(int qcap) {
  return qcap <= 16 ? 16 : qcap <= 32 ? 32 : qcap <= 64 ? 64
         : qcap <= 128 ? 128 : 256;
}

template <typename T>
int launch(const int* ids, const T* q, const T* c, const float* norms,
           const float* okf, const float* sscale, const float* sconst,
           const float* qstat, float* out, int U, int qcap, int cmax, int D,
           int metric, void* stream) {
  constexpr int ES = int(sizeof(T));
  constexpr CUtensorMapDataType TYPE =
      ES == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int nt = pass_slots(qcap);
  const int sb = nt < 64 ? nt : 64;
  Params p;
  p.cell_ids = ids;
  p.norms = norms;
  p.okf = okf;
  p.sscale = sscale;
  p.sconst = sconst;
  p.qstat = qstat;
  p.out = out;
  p.qcap = qcap;
  p.cmax = cmax;
  p.metric = metric;
  p.ksteps = (D * ES + ROW_BYTES - 1) / ROW_BYTES;
  p.ctiles = (cmax + BC - 1) / BC;
  p.passes = (qcap + nt - 1) / nt;
  // the scores go out by TMA where their rows are whole 16-byte units
  p.tma_out = (cmax % 4) == 0 && (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  const long long tiles = (long long)U * p.ctiles * p.passes;
  if (tiles > 0x7FFFFFFFLL) return int(cudaErrorInvalidConfiguration);
  CUtensorMap cmap, qmap, omap;
  if (!encode_3d(&cmap, TYPE, ES, c, kAnyCells, cmax, D, BC, ROW_BYTES / ES) ||
      !encode_3d(&qmap, TYPE, ES, q, U, qcap, D, nt, ROW_BYTES / ES))
    return int(cudaErrorInvalidValue);
  if (p.tma_out && !encode_3d(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out,
                              U, qcap, cmax, sb, 32))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nt) {
    case 16: return run<T, 16>(cmap, qmap, omap, p, tiles, s);
    case 32: return run<T, 32>(cmap, qmap, omap, p, tiles, s);
    case 64: return run<T, 64>(cmap, qmap, omap, p, tiles, s);
    case 128: return run<T, 128>(cmap, qmap, omap, p, tiles, s);
    default: return run<T, 256>(cmap, qmap, omap, p, tiles, s);
  }
}

}  // namespace cell_stream

// Shapes the cell stream takes: TMA needs a row pitch of whole 16-byte
// units and 16-byte aligned bases.  Everything else goes to first_slice.
inline bool stream_ok(const void* q, const void* c, int D, int elem_bytes) {
  return (D * elem_bytes) % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(q) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(c) % 16) == 0;
}

template <typename T>
int launch(const int* ids, const T* q, const T* c, const float* norms,
           const float* okf, const float* sscale, const float* sconst,
           const float* qstat, float* out, int U, int qcap, int cmax, int D,
           int metric, void* stream) {
  if (U <= 0 || qcap <= 0 || cmax <= 0 || D <= 0)
    return int(cudaGetLastError());
  if (stream_ok(q, c, D, int(sizeof(T))))
    return cell_stream::launch<T>(ids, q, c, norms, okf, sscale, sconst,
                                  qstat, out, U, qcap, cmax, D, metric,
                                  stream);
  return first_slice::launch<T>(ids, q, c, norms, okf, sscale, sconst, qstat,
                                out, U, qcap, cmax, D, metric, stream);
}

}  // namespace

extern "C" {

// 1 where operands of this row width, element size and alignment go to the
// TMA / wgmma cell stream, 0 where they go to the first-slice kernel.
int fpv_grouped_design(const void* qblk, const void* cells, int D,
                       int elem_bytes) {
  return stream_ok(qblk, cells, D, elem_bytes) ? 1 : 0;
}

// cell_ids (U+1,) i32 [n_uniq, compact -> cell ids...]; qblk (U, qcap, D)
// bf16; cells (nlist, cmax, D) bf16; norms, okf (nlist, cmax) f32; qstat
// (U, qcap) f32; out (U, qcap, cmax) f32.  Returns cudaGetLastError().
int fpv_grouped_cell_scores(const void* cell_ids, const void* qblk,
                            const void* cells, const void* norms,
                            const void* okf, const void* qstat, void* out,
                            int U, int qcap, int cmax, int D, int metric,
                            void* stream) {
  return launch<__nv_bfloat16>(
      (const int*)cell_ids, (const __nv_bfloat16*)qblk,
      (const __nv_bfloat16*)cells, (const float*)norms, (const float*)okf,
      nullptr, nullptr, (const float*)qstat, (float*)out, U, qcap, cmax, D,
      metric, stream);
}

// As above with int8 qblk and cells, plus per-slot sscale and sconst (U,
// qcap) f32.  Returns cudaGetLastError().
int fpv_grouped_cell_scores_i8(const void* cell_ids, const void* qblk,
                               const void* cells, const void* norms,
                               const void* okf, const void* sscale,
                               const void* sconst, const void* qstat,
                               void* out, int U, int qcap, int cmax, int D,
                               int metric, void* stream) {
  return launch<signed char>(
      (const int*)cell_ids, (const signed char*)qblk,
      (const signed char*)cells, (const float*)norms, (const float*)okf,
      (const float*)sscale, (const float*)sconst, (const float*)qstat,
      (float*)out, U, qcap, cmax, D, metric, stream);
}

}  // extern "C"
