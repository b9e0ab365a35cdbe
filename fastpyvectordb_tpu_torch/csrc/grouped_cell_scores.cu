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
// One templated kernel; the two entries differ in the operand type and in
// the first step of the epilogue.
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
// Grid: one 128-thread block per (compact slot u, 128-row cmax tile, tile of
// query slots), flattened with the query-slot tile fastest, so the blocks
// that share a cell tile run back to back and all but the first read it
// from L2.  The block reads cell_ids[0] itself and returns at once past
// the unique count (the TPU kernel's scalar prefetch + pl.when), so no host
// sync learns n_uniq; it loads its own cell id and offsets into the full
// (nlist, cmax, D) table, so only probed cells are read.  Ragged D, cmax and
// qcap edges are masked here (zero-filled operands, unwritten outputs): any
// shape is taken, none of the TPU's 128/8 alignment is needed.
//
// Tile rows follow qcap (a power of two from grouped_qcap): 8 rows
// (wmma 8x32x16) for qcap <= 8, 16 for <= 16, 32 for <= 32, and 64-row tiles
// side by side above that, so at most half of a tile is padding.
//
// What bounds it: at the main path's shape (U = 2048 probed cells, qcap 32,
// cmax 640, D 768) the kernel streams the probed cells once, 1.0 GB of int8
// or 2.0 GB of bf16 (0.3 / 0.6 ms at 3.35 TB/s), against 64 GFLOP of
// products (0.07 ms at the bf16 tensor-core peak) and a 168 MB output: it
// is bound by reading the cells.  This first version is simple and right:
// each thread starts 16-byte loads of the next 64-byte slice of its rows
// into registers before the tensor cores work on the current slice from
// shared memory (double-buffered), with nvcuda::wmma tiles; TMA, wgmma and a
// persistent grid are later work.  On an H100 80GB HBM3 (700 W) it streams
// the probed cells at about 1.8 TB/s at qcap 32 (int8 0.54 ms, bf16
// 1.09 ms); at qcap 64-128 the 64-row tiles and their epilogue halve that.
//
// Shared-memory layout: each 64-byte row slice of a chunk is split by wmma
// k-step into [k-step][row][16 elements], so every fragment pointer is
// 32-byte aligned for both operand types (a 16-byte int8 k-step inside a
// 64-byte row would not be).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 128;            // cell rows per block
constexpr int THREADS = 128;       // 4 warps, each owning 32 cell rows
constexpr int ROW_BYTES = 64;      // bytes of one operand row per chunk
constexpr int VECS = ROW_BYTES / 16;  // 16-byte vectors per row per chunk
constexpr float MASKED = 3.0e38f;

enum Metric { COSINE = 0, L2 = 1, DOT = 2 };

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

}  // namespace

extern "C" {

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
