// Grouped (cell-major) IVF-PQ ADC sums for Hopper (sm_90a): every query
// slot of a probed cell against every row of that cell's PQ codes ->
// (U, qcap, cmax) f32, the code-dependent residual term of the score.
//
// Replaces the TPU Pallas kernel in fastpyvectordb_tpu/kernels/pallas_ivf.py:
//   fpv_grouped_cell_scores_pq <- grouped_cell_scores_pq (_kernel_pq)
//
// What it computes, for each compact slot u < cell_ids[0] (cell =
// cell_ids[1 + u]), each query slot s with q = qslot[u, s] >= 0 and each cell
// row c < cmax:
//   out[u, s, c] = sum_m float(lut[q, m*K + codes_t[cell, m, c]])
// summed over m in order, in f32.  lut is the per-query (B, M*K) bf16 table
// and qslot the (U, qcap) slot table of ann/ivf_grouped.py:invert_pairs; the
// TPU kernel takes the gathered (U, qcap, M*K) copy lut[slot_qc] instead and
// forms the same sum as a bf16 product with a one-hot expansion of the codes
// in VMEM.  Here the sum is a shared-memory table lookup: Hopper has no use
// for the one-hot, and the gathered copy (several GB a batch at B=1024,
// nprobe 32, M*K = 24,576) is never built.  Rows u >= cell_ids[0] and empty
// slots (qslot -1) are left unwritten; the caller never reads them.
//
// Grid: one 256-thread block per (compact slot u, cmax tile of 256*CPT rows,
// tile of 16 query slots), flattened with the slot tile fastest.  The block
// reads cell_ids[0] and returns past the unique count (the TPU kernel's
// scalar prefetch + pl.when), so no host sync learns it, and returns at once
// when its 16 slots are all empty: qcap has 8x headroom over the mean cell
// load, so most slot tiles are.  Each thread owns CPT code columns (cell
// rows) and 16 f32 sums per column.  Per chunk of MC subspaces the block
// stages the live slots' LUT rows (16-byte copies) and the chunk's code
// bytes in shared memory; each thread then reads its code byte per
// subspace and adds the 16 slots' table entries.  Ragged cmax, M, K and
// qcap are masked here: no alignment is asked of any of them.
//
// What bounds it: at the main path's shape (1M rows, nlist 2000, cmax 768,
// M 96, K 256, B=1024 at nprobe 64: 65,536 live (query, cell) pairs) it is
// 4.8 G table lookups and adds, out of shared memory with random bank
// conflicts (the codes are data), plus 3.1 GB of LUT rows staged (each
// pair's 48 KB table once per cmax tile, mostly from L2) and 0.2 GB of
// output: bound by shared-memory lookups (4.6 ms, ~1 T lookups/s, on an
// H100 80GB HBM3 at 700 W).  A register-resident table split across a
// warp, or K=16 codes in a tensor-core one-hot product, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ST = 16;                 // query slots per block
constexpr int SMEM_BUDGET = 48 * 1024; // dynamic shared memory, no opt-in

template <int CPT>
__global__ void __launch_bounds__(THREADS)
pq_kernel(const int* __restrict__ cell_ids,          // (U + 1,)
          const __nv_bfloat16* __restrict__ lut,     // (B, M * K)
          const int* __restrict__ qslot,             // (U, qcap), -1 = empty
          const unsigned char* __restrict__ codes_t, // (nlist, M, cmax)
          float* __restrict__ out,                   // (U, qcap, cmax)
          int qcap, int cmax, int M, int K, int MC, bool vec) {
  constexpr int CT = THREADS * CPT;    // cell rows per block
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ls = reinterpret_cast<__nv_bfloat16*>(smem);  // [ST][MC*K]
  unsigned char* cs = smem + (size_t)ST * MC * K * 2;          // [MC][CT]

  const int tz = (qcap + ST - 1) / ST;
  const int ty = (cmax + CT - 1) / CT;
  const int u = blockIdx.x / (ty * tz);
  if (u >= __ldg(cell_ids)) return;  // the compact list's padding tail
  const int cell = __ldg(cell_ids + 1 + u);
  const int c0 = (blockIdx.x / tz) % ty * CT;
  const int s0 = blockIdx.x % tz * ST;
  const int tid = threadIdx.x;

  int qid[ST];
  bool any = false;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    qid[s] = s0 + s < qcap ? __ldg(qslot + (size_t)u * qcap + s0 + s) : -1;
    any |= qid[s] >= 0;
  }
  if (!any) return;  // an empty slot tile (uniform across the block)

  const unsigned char* cbase = codes_t + (size_t)cell * M * cmax;
  const size_t row = (size_t)M * K;  // one query's table, in elements
  float acc[ST][CPT];
#pragma unroll
  for (int s = 0; s < ST; ++s)
#pragma unroll
    for (int x = 0; x < CPT; ++x) acc[s][x] = 0.0f;

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mc = min(MC, M - m0);
    const int len = mc * K;  // table entries of this chunk, per slot
    __syncthreads();         // the previous chunk has been consumed
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      if (qid[s] < 0) continue;
      const __nv_bfloat16* src = lut + (size_t)qid[s] * row + (size_t)m0 * K;
      __nv_bfloat16* dst = ls + (size_t)s * MC * K;
      if (vec) {
        for (int i = tid; i < len / 8; i += THREADS)
          reinterpret_cast<uint4*>(dst)[i] =
              __ldg(reinterpret_cast<const uint4*>(src) + i);
      } else {
        for (int i = tid; i < len; i += THREADS) dst[i] = src[i];
      }
    }
    for (int i = tid; i < mc * CT; i += THREADS) {
      const int j = i / CT;
      const int c = i - j * CT;
      cs[i] = c0 + c < cmax
                  ? __ldg(cbase + (size_t)(m0 + j) * cmax + c0 + c)
                  : (unsigned char)0;
    }
    __syncthreads();
    for (int j = 0; j < mc; ++j) {
      int code[CPT];
#pragma unroll
      for (int x = 0; x < CPT; ++x) code[x] = cs[j * CT + tid + x * THREADS];
      const __nv_bfloat16* lj = ls + (size_t)j * K;
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        if (qid[s] < 0) continue;
#pragma unroll
        for (int x = 0; x < CPT; ++x)
          acc[s][x] = __fadd_rn(
              acc[s][x], __bfloat162float(lj[(size_t)s * MC * K + code[x]]));
      }
    }
  }

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    if (qid[s] < 0) continue;
    float* dst = out + ((size_t)u * qcap + s0 + s) * cmax;
#pragma unroll
    for (int x = 0; x < CPT; ++x) {
      const int c = c0 + tid + x * THREADS;
      if (c < cmax) dst[c] = acc[s][x];
    }
  }
}

template <int CPT>
int run(unsigned grid, int mc, cudaStream_t st, const int* ids,
        const __nv_bfloat16* lut, const int* qslot, const unsigned char* codes,
        float* out, int qcap, int cmax, int M, int K, bool vec) {
  const size_t smem = (size_t)ST * mc * K * 2 + (size_t)mc * THREADS * CPT;
  pq_kernel<CPT><<<grid, THREADS, smem, st>>>(ids, lut, qslot, codes, out,
                                              qcap, cmax, M, K, mc, vec);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// cell_ids (U+1,) i32 [n_uniq, compact -> cell ids...]; lut (B, M*K) bf16;
// qslot (U, qcap) i32 query per slot, -1 = empty; codes_t (nlist, M, cmax)
// u8; out (U, qcap, cmax) f32.  Returns cudaGetLastError().
int fpv_grouped_cell_scores_pq(const void* cell_ids, const void* lut,
                               const void* qslot, const void* codes_t,
                               void* out, int U, int qcap, int cmax, int M,
                               int K, void* stream) {
  if (U <= 0 || qcap <= 0 || cmax <= 0) return int(cudaGetLastError());
  if (M <= 0 || K <= 0 || K > 256) return int(cudaErrorInvalidValue);
  const int cpt = cmax <= THREADS ? 1 : cmax <= 2 * THREADS ? 2
                  : cmax <= 3 * THREADS ? 3 : 4;
  // subspaces per staged chunk: the 16 slots' table rows plus the chunk's
  // code bytes within the shared-memory budget
  const int per_m = ST * K * 2 + THREADS * cpt;
  const int mc = max(1, min(M, SMEM_BUDGET / per_m));
  if ((size_t)ST * mc * K * 2 + (size_t)mc * THREADS * cpt > SMEM_BUDGET)
    return int(cudaErrorInvalidValue);
  const long long blocks = (long long)U * ((cmax + THREADS * cpt - 1) /
                                           (THREADS * cpt)) *
                           ((qcap + ST - 1) / ST);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const bool vec = (K % 8) == 0 &&
                   (reinterpret_cast<uintptr_t>(lut) % 16) == 0;
  const unsigned grid = unsigned(blocks);
  cudaStream_t st = (cudaStream_t)stream;
  const int* ids = (const int*)cell_ids;
  const __nv_bfloat16* l = (const __nv_bfloat16*)lut;
  const int* qs = (const int*)qslot;
  const unsigned char* c = (const unsigned char*)codes_t;
  float* o = (float*)out;
  switch (cpt) {
    case 1: return run<1>(grid, mc, st, ids, l, qs, c, o, qcap, cmax, M, K, vec);
    case 2: return run<2>(grid, mc, st, ids, l, qs, c, o, qcap, cmax, M, K, vec);
    case 3: return run<3>(grid, mc, st, ids, l, qs, c, o, qcap, cmax, M, K, vec);
    default: return run<4>(grid, mc, st, ids, l, qs, c, o, qcap, cmax, M, K, vec);
  }
}

}  // extern "C"
