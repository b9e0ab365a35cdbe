// Dequantize-on-load quantized scans for Hopper (sm_90a): int8 and packed
// int4 codes against f32 queries -> (B, N) f32 scores, lower = closer.
//
// Replaces the TPU Pallas kernels in fastpyvectordb_tpu/kernels/pallas_quant.py:
//   fpv_sq_scores   <- sq_scores   (_sq_kernel):   v = (c + 128) * scale/255 + vmin
//   fpv_int4_scores <- int4_scores (_int4_kernel): halves-packed nibbles,
//                      byte w = dim w (low nibble) | dim w + W (high nibble),
//                      v = c * scale/15 + vmin
// One templated kernel; the two entries differ only in the code loader.
//
// What it computes, per (query b, corpus row n):
//   cross = sum_d bf16(q[b,d]) * bf16(v[n,d])       (f32 accumulation)
//   vsq   = sum_d v[n,d]^2                           (from the f32 v, as the
//                                                      Pallas kernels do)
//   cosine: 1 - cross * rsqrt(max(vsq, 1e-30))       (q pre-normalised)
//   l2:     max(qsq[b] + vsq - 2 * cross, 0)
//   dot:    -cross
// The wrapper (kernels/quant_kernels.py) normalises cosine queries and
// forms qsq and rscale = scale/255 (int8) or scale/15 (int4).  Ragged B, N
// and D are masked here, so the caller pads nothing.
//
// What bounds it: at B=1024, N=1M, D=768 the product is 2*B*N*D = 1.6 TFLOP
// and the codes are N*D = 0.77 GB (int8) or N*D/2 = 0.38 GB (int4), but the
// (B, N) f32 output is 4.1 GB: the output write dominates the bytes
// (1.2 ms at 3.35 TB/s against 1.6 ms of bf16 tensor-core time at peak).  A
// fused top-k epilogue that keeps the scores on chip is what would remove
// that write; this first version writes them, and uses warp-level
// nvcuda::wmma bf16 16x16x16 tiles rather than wgmma/TMA (later work).
//
// Tiling: one 256-thread block (8 warps) computes a 128 x 128 (queries x
// rows) tile, looping over D in 32-wide chunks.  Each thread loads 16 dims
// of one query row and 16 dims of one corpus row per chunk — one 16-byte
// load of codes and four of queries when the widths allow (VEC), scalar
// loads with bounds checks otherwise — and converts them into shared
// memory as bf16, dequantising the codes on the way and accumulating vsq
// for its row from the f32 values.  The next chunk's loads are issued
// before the current chunk's products, so global latency overlaps the
// tensor-core work.  The warps form a 2 x 4 grid, each owning a 64 x 32
// sub-tile (4 x 2 wmma accumulators).  The epilogue goes through a 16 x 16
// per-warp staging tile in shared memory and writes the metric with
// 32-byte runs per lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // queries per block
constexpr int BN = 128;       // corpus rows per block
constexpr int BK = 32;        // dims per shared-memory chunk
constexpr int LDS = BK + 8;   // bf16 row stride (multiple of 8 for wmma)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = BK / 2;   // dims per thread per chunk (two per row)
constexpr int WM = 64;        // warp tile rows (queries)
constexpr int WN = 32;        // warp tile cols (corpus rows)
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
static_assert(BM == 2 * WM && BN == 4 * WN, "2 x 4 warp grid");
static_assert(BM == THREADS / 2 && BN == THREADS / 2, "two threads a row");

enum Metric { COSINE = 0, L2 = 1, DOT = 2 };
enum Kind { INT8 = 0, INT4 = 1 };

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[4], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// The registers one thread carries from a chunk's loads to its stores.
struct Chunk {
  float q[PER];       // query dims d0 .. d0+15 (0 past the edges)
  uint32_t code[4];   // the 16 code bytes those dims read
};

// Issue the global loads of chunk k0 for query row gq and corpus row gn.
// `cols` is D (int8) or W (int4): the code row width in bytes.
template <int KIND, bool VEC>
__device__ __forceinline__ void fetch(Chunk& c, const float* __restrict__ q,
                                      const uint8_t* __restrict__ codes,
                                      int gq, int gn, int d0, int B, int N,
                                      int De, int cols) {
  if (VEC && gq < B && d0 + PER <= De) {
    const float4* src = reinterpret_cast<const float4*>(q + (size_t)gq * De + d0);
#pragma unroll
    for (int i = 0; i < PER / 4; ++i) {
      const float4 f = __ldg(src + i);
      c.q[4 * i] = f.x; c.q[4 * i + 1] = f.y;
      c.q[4 * i + 2] = f.z; c.q[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      c.q[i] = (gq < B && d0 + i < De) ? __ldg(q + (size_t)gq * De + d0 + i)
                                       : 0.0f;
  }
  // first code byte of the run: int4 dims past W read the high nibbles of
  // bytes d - W (VEC guarantees W % 16 == 0, so a run never straddles W)
  const int b0 = (KIND == INT4 && d0 >= cols) ? d0 - cols : d0;
  if (VEC && gn < N && d0 + PER <= De) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        codes + (size_t)gn * cols + b0));
    c.code[0] = u.x; c.code[1] = u.y; c.code[2] = u.z; c.code[3] = u.w;
  } else {
    c.code[0] = c.code[1] = c.code[2] = c.code[3] = 0u;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = d0 + i;
      if (gn < N && d < De) {
        const int b = (KIND == INT4 && d >= cols) ? d - cols : d;
        c.code[i >> 2] |= uint32_t(__ldg(codes + (size_t)gn * cols + b))
                          << (8 * (i & 3));
      }
    }
  }
}

// Write chunk k0 into shared memory as bf16: queries converted, codes
// dequantised, vsq accumulated from the f32 values.
template <int KIND>
__device__ __forceinline__ void store(const Chunk& c, __nv_bfloat16* arow,
                                      __nv_bfloat16* brow, float& vsq,
                                      const float* __restrict__ vmin,
                                      const float* __restrict__ rscale,
                                      int gn, int d0, int N, int De,
                                      int cols) {
  __align__(16) __nv_bfloat162 a2[PER / 2];
  __align__(16) __nv_bfloat162 b2[PER / 2];
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = d0 + i;
    v[i] = 0.0f;
    if (gn < N && d < De) {
      const uint32_t byte = byte_of(c.code, i);
      float code;
      if (KIND == INT8) {
        code = float(int(int8_t(byte)) + 128);
      } else {
        code = float(d < cols ? (byte & 0xFu) : (byte >> 4));
      }
      // rounded multiply then add, no fused multiply-add: the same f32 v
      // (and so the same bf16 operand) as the plain version
      v[i] = __fadd_rn(__fmul_rn(code, __ldg(rscale + d)), __ldg(vmin + d));
      vsq += v[i] * v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < PER / 2; ++i) {
    a2[i] = __floats2bfloat162_rn(c.q[2 * i], c.q[2 * i + 1]);
    b2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  // 16 bf16 = two 16-byte stores each (row stride 80 B, offsets 0 / 32 B)
  reinterpret_cast<uint4*>(arow)[0] = reinterpret_cast<const uint4*>(a2)[0];
  reinterpret_cast<uint4*>(arow)[1] = reinterpret_cast<const uint4*>(a2)[1];
  reinterpret_cast<uint4*>(brow)[0] = reinterpret_cast<const uint4*>(b2)[0];
  reinterpret_cast<uint4*>(brow)[1] = reinterpret_cast<const uint4*>(b2)[1];
}

template <int KIND, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_scores_kernel(const float* __restrict__ q,       // (B, De)
                    const uint8_t* __restrict__ codes,  // (N, cols)
                    const float* __restrict__ vmin,     // (De,)
                    const float* __restrict__ rscale,   // (De,)
                    const float* __restrict__ qsq,      // (B,)
                    float* __restrict__ out,            // (B, N)
                    int B, int N, int De, int cols, int metric) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * LDS];
  __shared__ __align__(128) float stage[WARPS][16 * 16];
  __shared__ float vsq_s[BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int lrow = tid / 2;            // tile row this thread loads
  const int lcol = (tid % 2) * PER;    // first dim of its half-chunk
  const int warp_m = (warp / 4) * WM;
  const int warp_n = (warp % 4) * WN;
  const int gq = m0 + lrow;
  const int gn = n0 + lrow;
  __nv_bfloat16* arow = As + lrow * LDS + lcol;
  __nv_bfloat16* brow = Bs + lrow * LDS + lcol;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  float vsq = 0.0f;  // partial squared norm of corpus row gn
  Chunk c;
  fetch<KIND, VEC>(c, q, codes, gq, gn, lcol, B, N, De, cols);
  for (int k0 = 0; k0 < De; k0 += BK) {
    store<KIND>(c, arow, brow, vsq, vmin, rscale, gn, k0 + lcol, N, De,
                cols);
    __syncthreads();
    if (k0 + BK < De)
      fetch<KIND, VEC>(c, q, codes, gq, gn, k0 + BK + lcol, B, N, De, cols);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (warp_m + 16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (warp_n + 16 * j) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the two threads of a row are neighbouring lanes of one warp
  vsq += __shfl_xor_sync(0xffffffffu, vsq, 1);
  if ((tid % 2) == 0) vsq_s[lrow] = vsq;
  __syncthreads();

  float* st = stage[warp];
  const int r = lane / 2;          // staging row this lane writes out
  const int c0 = (lane % 2) * 8;   // its first of 8 columns
  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + warp_m + 16 * i + r;
      const int tc = warp_n + 16 * j + c0;   // column within the tile
      const int gc = n0 + tc;
      if (gr < B) {
        const float qs = qsq[gr];
        float s[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float cross = st[r * 16 + c0 + e];
          const float vs = vsq_s[tc + e];
          if (metric == COSINE) {
            s[e] = 1.0f - cross * rsqrtf(fmaxf(vs, 1e-30f));
          } else if (metric == L2) {
            s[e] = fmaxf(qs + vs - 2.0f * cross, 0.0f);
          } else {
            s[e] = -cross;
          }
        }
        float* dst = out + (size_t)gr * N + gc;
        if (vec_out && gc + 8 <= N) {
          reinterpret_cast<float4*>(dst)[0] = make_float4(s[0], s[1], s[2], s[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(s[4], s[5], s[6], s[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gc + e < N) dst[e] = s[e];
        }
      }
      __syncwarp();
    }
  }
}

template <int KIND>
int launch(const float* q, const uint8_t* codes, const float* vmin,
           const float* rscale, const float* qsq, float* out, int B, int N,
           int De, int cols, int metric, void* stream) {
  if (B <= 0 || N <= 0) return int(cudaGetLastError());
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  // 16-byte loads need 16-byte-aligned rows and runs that never cross an
  // int4 half boundary: code rows of a multiple of 16 bytes, query rows of
  // a multiple of 4 floats, aligned base pointers
  const bool vec = (cols % 16) == 0 && (De % 4) == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) % 16) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    quant_scores_kernel<KIND, true><<<grid, THREADS, 0, s>>>(
        q, codes, vmin, rscale, qsq, out, B, N, De, cols, metric);
  } else {
    quant_scores_kernel<KIND, false><<<grid, THREADS, 0, s>>>(
        q, codes, vmin, rscale, qsq, out, B, N, De, cols, metric);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, D) f32, codes (N, D) int8, vmin/rscale (D,) f32, qsq (B,) f32,
// out (B, N) f32.  Returns cudaGetLastError() after the launch.
int fpv_sq_scores(const void* q, const void* codes, const void* vmin,
                  const void* rscale, const void* qsq, void* out, int B,
                  int N, int D, int metric, void* stream) {
  return launch<INT8>((const float*)q, (const uint8_t*)codes,
                      (const float*)vmin, (const float*)rscale,
                      (const float*)qsq, (float*)out, B, N, D, D, metric,
                      stream);
}

// q (B, 2W) f32, packed (N, W) uint8 halves layout, vmin/rscale (2W,) f32,
// qsq (B,) f32, out (B, N) f32.  Returns cudaGetLastError().
int fpv_int4_scores(const void* q, const void* packed, const void* vmin,
                    const void* rscale, const void* qsq, void* out, int B,
                    int N, int W, int metric, void* stream) {
  return launch<INT4>((const float*)q, (const uint8_t*)packed,
                      (const float*)vmin, (const float*)rscale,
                      (const float*)qsq, (float*)out, B, N, 2 * W, W, metric,
                      stream);
}

}  // extern "C"
