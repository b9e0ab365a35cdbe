// Packed-bit Hamming distances for Hopper (sm_90a): XOR + popcount of
// 32-bit code words, summed over the words -> (B, N) counts.
//
// Replaces the TPU Pallas kernels in fastpyvectordb_tpu/kernels/pallas_quant.py:
//   fpv_hamming_mxu_scores <- hamming_mxu_scores (_hamming_mxu_kernel):
//                             the count as f32 (the binary two-stage scan)
//   fpv_hamming_scores     <- hamming_scores     (_hamming_kernel):
//                             the count as int32 (BinaryQuantizer, rerank <= 1)
// One templated kernel; the two entries differ only in the output type.
//
// What it computes, per (query b, corpus row n):
//   out[b, n] = sum_w popc(q[b, w] ^ c[n, w])
// Both operands are row-major packed words (the snapshot's own (N, W)
// codes; no word-major copy).  The TPU kernel of the two-stage scan
// expands the bits to a +-1 bf16 matrix product, (32W - q.c)/2, only
// because the TPU has no fast popcount; the count is the same integer, so
// both entries equal their plain versions bit for bit.  Zero padding bits
// past D are zero on both sides and add nothing.
//
// What bounds it: at the main path's B=1024 x N=1M x W=24 (768 dims) it is
// 24.6 G XOR + popcount + add, and popcount issues at 16 a clock per SM:
// ~6.6 ms on 132 SMs at 1.755 GHz, against 1.2 ms for its 4.1 GB f32
// output at 3.35 TB/s and 0.1 GB of codes.  It is bound by the popcount
// rate; the b1 tensor-core MMA (xor + popc on 256-bit fragments) is what
// would lift that bound (later work).
//
// Tiling: one 256-thread block computes a 64 x 128 (queries x rows) tile.
// Per chunk of up to 32 words it stages the tile's query and corpus words
// in shared memory, word-major, reading each row's contiguous words
// coalesced.  Each thread keeps an 8 x 4 register tile of counts: per word
// it reads 8 query words (two 16-byte loads, the same for the whole warp)
// and 4 corpus words (one 16-byte load) for 32 XOR + popcount.  A warp
// covers 128 consecutive rows, so the store writes 512 contiguous bytes a
// query row (16-byte stores when N % 4 == 0).  Ragged B, N and W are
// masked here (zero words, unwritten outputs): the caller pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;               // threads along the corpus rows
constexpr int TY = 8;                // threads along the queries
constexpr int THREADS = TX * TY;
constexpr int TN = 4;                // corpus rows per thread
constexpr int TM = 8;                // queries per thread
constexpr int BN = TX * TN;          // 128 rows per block
constexpr int BM = TY * TM;          // 64 queries per block
constexpr int WK = 32;               // words per staged chunk
constexpr int LDC = BN + 4;          // padded row stride, 16-byte aligned

__device__ __forceinline__ void store4(int* dst, const int (&v)[TN]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(float* dst, const int (&v)[TN]) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(float(v[0]), float(v[1]), float(v[2]), float(v[3]));
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
hamming_kernel(const uint32_t* __restrict__ q,   // (B, W)
               const uint32_t* __restrict__ c,   // (N, W)
               OutT* __restrict__ out,           // (B, N)
               int B, int N, int W) {
  __shared__ __align__(16) uint32_t qs[WK][BM];
  __shared__ __align__(16) uint32_t cs[WK][LDC];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < W; k0 += WK) {
    const int kn = min(WK, W - k0);
    // consecutive threads read consecutive words of a row: the tile's
    // words are contiguous in memory when the chunk spans the whole row
    for (int i = tid; i < BN * kn; i += THREADS) {
      const int r = i / kn;
      const int k = i - r * kn;
      const int n = n0 + r;
      cs[k][r] = n < N ? __ldg(c + (size_t)n * W + k0 + k) : 0u;
    }
    for (int i = tid; i < BM * kn; i += THREADS) {
      const int r = i / kn;
      const int k = i - r * kn;
      const int b = m0 + r;
      qs[k][r] = b < B ? __ldg(q + (size_t)b * W + k0 + k) : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const uint4 cv = *reinterpret_cast<const uint4*>(&cs[k][tx * TN]);
      const uint4 qa = *reinterpret_cast<const uint4*>(&qs[k][ty * TM]);
      const uint4 qb = *reinterpret_cast<const uint4*>(&qs[k][ty * TM + 4]);
      const uint32_t cw[TN] = {cv.x, cv.y, cv.z, cv.w};
      const uint32_t qw[TM] = {qa.x, qa.y, qa.z, qa.w,
                               qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += __popc(qw[i] ^ cw[j]);
    }
    __syncthreads();  // the tiles are rewritten by the next chunk
  }

  const int n = n0 + tx * TN;
  const bool vec = (N % 4) == 0 && n + TN <= N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = m0 + ty * TM + i;
    if (b >= B) break;
    OutT* dst = out + (size_t)b * N + n;
    if (vec) {
      store4(dst, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < N) dst[j] = OutT(acc[i][j]);
    }
  }
}

template <typename OutT>
int launch(const void* q, const void* c, void* out, int B, int N, int W,
           void* stream) {
  if (B <= 0 || N <= 0) return int(cudaGetLastError());
  if (W <= 0) return int(cudaErrorInvalidValue);
  const unsigned gx = unsigned((N + BN - 1) / BN);
  const unsigned gy = unsigned((B + BM - 1) / BM);
  if (gy > 65535u) return int(cudaErrorInvalidConfiguration);
  hamming_kernel<OutT><<<dim3(gx, gy), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)c, (OutT*)out, B, N, W);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, W) and c (N, W) packed 32-bit words; out (B, N) f32 Hamming
// distances.  Returns cudaGetLastError().
int fpv_hamming_mxu_scores(const void* q, const void* c, void* out, int B,
                           int N, int W, void* stream) {
  return launch<float>(q, c, out, B, N, W, stream);
}

// As above with an int32 output.  Returns cudaGetLastError().
int fpv_hamming_scores(const void* q, const void* c, void* out, int B, int N,
                       int W, void* stream) {
  return launch<int>(q, c, out, B, N, W, stream);
}

}  // extern "C"
