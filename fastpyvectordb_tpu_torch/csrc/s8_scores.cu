// Exact s8 x s8 -> s32 corpus scans for Hopper (sm_90a): (B, D) int8
// queries against a whole int8 corpus -> (B, N) int32 inner products.
//
// Replaces the TPU Pallas kernels in benchmarks/int8_mxu_lab.py:
//   fpv_s8_scores    <- pallas_s8    (_s8_kernel):    codes row-major (N, D)
//   fpv_s8_scores_tn <- pallas_s8_tn (_s8_tn_kernel): codes transposed (D, N)
// and, as pallas_s8's redesign for the int8 two-stage scan, fpv_s8_topc
// (+ fpv_s8_topc_merge): the same scan with the folded int8 scores, the
// mask and a running top-c in its epilogue (S8TopcOp below), so that the
// (B, N) block is never written.
// One templated kernel (hopper_scan.cuh's scan_kernel with S8Op); the two
// entries differ only in the corpus tile's layout and how the consumers
// read their fragments from it.  The Pallas grid's "N a multiple of the
// tile" rule is not carried over: any B, N and D are taken and the ragged
// edges are masked here.
//
// What it computes, per (query b, corpus row n):
//   out[b, n] = sum_d q[b, d] * c[n, d]
// on the tensor cores in s32, so the result is exact and equals an integer
// matrix product bit for bit (|q|, |c| <= 128: sums over any practical D
// stay far inside s32).
//
// What bounds it: at the int8 path's B=1024 x N=1M x D=768 the product is
// 2*B*N*D = 1.65 T int8 operations, 0.83 ms at 1,979 TOP/s; its bytes are
// the (B, N) 4-byte output (4.29 GB), the codes (0.81 GB) and the queries,
// 1.52 ms at 3.35 TB/s.  So it is bound by the output write.
//
// What the design does about it: wgmma (m64n256k32, s8 -> s32) on tiles of
// 128 corpus rows x 256 queries in a persistent, warp-specialised block
// (hopper_scan.cuh), with the corpus rows as wgmma's M side, taken from
// registers.  The wrapper hands over a (B, Kp) int8 query copy (zero past
// D, Kp a multiple of 128), which TMA loads into a 4-stage ring of swizzled
// tiles.  Beside each query tile lies the step's corpus tile, 128 corpus
// rows x 128 code bytes, one TMA load a step in TMA's 128-byte swizzle
// (16-byte chunk c of a tile row r at place c ^ (r & 7)); rows and dims
// past N and D arrive as zeros.  Rows that TMA cannot address (a pitch or
// a base off the 16-byte boundary) are loaded a byte at a time by the
// producer threads into the same layout.  The consumers read their A
// fragments from the tile:
//   (N, D): a tile row is a corpus row, and a fragment register is one
//     4-byte word of it.  The swizzle puts the eight rows a warp reads at
//     once on 32 different banks.  Copying the tile with cp.async, a row
//     a thread, cost 1.2 of 2.7 ms at the main path's shape.
//   (D, N): a tile row is a d-row (128 d-rows x 128 corpus bytes: the TMA
//     box swaps its coordinates), and wgmma takes 8-bit operands K-major
//     only, so the tile is transposed on chip, inside the fragment load:
//     the M order is free, so fragment rows frow, frow + 8 are made two
//     adjacent corpus rows, whose bytes at a d-row form one 16-bit word;
//     one ldmatrix.x4.trans a slice gathers a lane's 16 such words (four
//     8 x 8 matrices of d-rows; see S8Op::fragment for the order that
//     keeps them off each other's banks) and four byte permutes make its
//     four registers.  That is the same four shared-memory wavefronts a
//     warp and slice as the (N, D) loads, so the transpose, done anew for
//     each of the B / 256 query tiles, costs no more than B8's fragment
//     loads; the epilogue writes accumulator rows +0 / +8 to those two
//     corpus rows (one 8-byte staging store a query).
//     The first design had the producer warpgroup transpose each
//     tile on the way in: synchronous 16-byte __ldg loads (two rounds a K
//     step, four loads in flight a thread, at 40 registers), twelve byte
//     permutes and sixteen scattered 4-byte shared stores a thread, for
//     every query tile of every corpus tile (3.2 GB of transposing for
//     0.81 GB of codes at B = 1024).  The producer set the pace: 5.83-5.90
//     ms (26% of the bound), about 3.96 us a K step against 1.38 for
//     (N, D) (H100 80GB HBM3, 700 W; PERF.md).  A transpose in shared
//     memory (the raw tile by TMA into a second buffer, which cost the
//     fourth stage, turned K-major by the producer warpgroup) came to
//     2.56-2.61 ms against this design's 2.06-2.13 in the same runs.
// The epilogue stores the accumulators as they are through a swizzled
// staging tile with TMA.

#include "hopper_scan.cuh"

namespace {

template <bool TN>
struct S8Op {
  using Acc = int;
  using Out = int;
  static constexpr CUtensorMapDataType OUT_TYPE = CU_TENSOR_MAP_DATA_TYPE_INT32;
  static constexpr int KSTEP_ELEMS = 128;   // int8 a step
  static constexpr int CODE_BYTES = 128;    // a tile row a step
  static constexpr int STAGE_EXTRA = fpv::BC * CODE_BYTES;
  static constexpr int STAGES = 4;
  // (D, N): the tile is 128 d-rows x 128 corpus bytes, and fragment rows
  // frow, frow + 8 are adjacent corpus rows (hopper_scan.cuh)
  static constexpr bool CODES_DN = TN;
  static constexpr bool PAIRED_ROWS = TN;

  struct Params {
    int B, N;
    int* out;             // (B, N)
    const uint8_t* codes; // (N, D), or (D, N) for TN
    int D;
    int vec;              // rows TMA can address: 16-byte pitch and base
  };

  // byte offset in the stage's (N, D) corpus tile of 4-byte word `wi`
  // (0..31) of corpus row `r` (0..127): TMA's 128-byte swizzle
  static __device__ __forceinline__ int word_off(int r, int wi) {
    return r * CODE_BYTES + (((wi >> 2) ^ (r & 7)) << 4) + ((wi & 3) << 2);
  }

  // bring K step k of the tile whose row r is corpus row n into the stage
  // where TMA cannot (a pitch or a base off the 16-byte boundary), zero
  // past D or N, in the layout TMA would have made (chunk c of tile row r
  // at c ^ (r & 7)); false: no copy went by cp.async
  static __device__ __forceinline__ bool fetch(const Params& p, uint8_t* ex,
                                               int r, int n, int k) {
    if (TN) return fetch_dn(p, ex, r, n - r, k);
    // (N, D): thread r loads row n a byte at a time
    const int b0 = k * CODE_BYTES;
    const uint8_t* src = p.codes + (size_t)n * p.D + b0;
    uint8_t* row = ex + r * CODE_BYTES;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (n < p.N) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (b0 + 16 * c + j < p.D)
            w[j / 4] |= uint32_t(__ldg(src + 16 * c + j)) << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return false;
  }

  // (D, N): thread r loads d-row k * 128 + r of the tile that starts at
  // corpus row n0, a byte at a time (the chunk loop rolled: unrolled, it
  // spilled the producer's loop state at its 40 registers)
  static __device__ __forceinline__ bool fetch_dn(const Params& p,
                                                  uint8_t* ex, int r, int n0,
                                                  int k) {
    const int dr = k * KSTEP_ELEMS + r;
    const uint8_t* src = p.codes + (size_t)dr * p.N + n0;
    uint8_t* row = ex + r * CODE_BYTES;
#pragma unroll 1
    for (int c = 0; c < 8; ++c) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (dr < p.D) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n0 + 16 * c + j < p.N)
            w[j / 4] |= uint32_t(__ldg(src + 16 * c + j)) << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return false;
  }

  // the A fragment of slice kk (code bytes 32kk .. 32kk + 31 of the step)
  // for M rows frow, frow + 8 (frow = 64g + 16w + lane / 4): a[0] / a[1]
  // bytes 4q .. 4q + 3 of each row's slice, a[2] / a[3] bytes 16 + 4q ..
  // (q = lane % 4)
  static __device__ __forceinline__ void fragment(const Params&,
                                                  const uint8_t* ex, int frow,
                                                  int lane, int kk,
                                                  uint32_t (&a)[4], float&,
                                                  float&) {
    if constexpr (!TN) {
      // (N, D): M row = corpus row, one 4-byte word a register
      const int wi = 8 * kk + lane % 4;
      a[0] = *reinterpret_cast<const uint32_t*>(ex + word_off(frow, wi));
      a[1] = *reinterpret_cast<const uint32_t*>(ex + word_off(frow + 8, wi));
      a[2] = *reinterpret_cast<const uint32_t*>(ex + word_off(frow, wi + 4));
      a[3] = *reinterpret_cast<const uint32_t*>(
          ex + word_off(frow + 8, wi + 4));
    } else {
      // (D, N), straight from the raw tile: M rows frow, frow + 8 are the
      // corpus rows 2i, 2i + 1 (i = lane / 4) of the warp's 16, which are
      // chunk frow / 16 of every d-row; their two bytes at one d-row are
      // one 16-bit word.  One ldmatrix.x4.trans loads four 8 x 8 matrices
      // of such words, each row a d-row's chunk, and hands lane (i, q)
      // word i of matrix rows 2q, 2q + 1 of each.  Matrices 0 / 1 hold
      // d-rows 4q + {0, 1} and 4q + {2, 3} of the slice's first 16, 2 / 3
      // the same of its last 16, swapped for q >= 2 so that the eight rows
      // of a matrix fall on eight different swizzle keys (d and d + 8
      // share one): no bank conflict.  Byte permutes then gather each
      // corpus row's four d-bytes into a register.
      const int m = lane / 8, j = lane % 8, qq = j / 2;
      const int e = 16 * (m >> 1) + 4 * qq + 2 * ((m & 1) ^ (qq >> 1)) +
                    (j & 1);                 // d-row this lane addresses
      const uint32_t addr = fpv::smem_u32(ex) + 32 * kk * CODE_BYTES +
                            e * CODE_BYTES + (((frow / 16) ^ (e & 7)) << 4);
      uint32_t r0, r1, r2, r3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\n"
          : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
          : "r"(addr)
          : "memory");
      // r0 bytes: (d0, 2i), (d0, 2i + 1), (d0 + 1, 2i), (d0 + 1, 2i + 1)
      // with d0 = 4q (q < 2) or 4q + 2 (q >= 2); r1 the other pair
      const bool swap = (lane % 4) >= 2;
      const uint32_t even = swap ? 0x2064u : 0x6420u;
      const uint32_t odd = swap ? 0x3175u : 0x7531u;
      a[0] = __byte_perm(r0, r1, even);
      a[1] = __byte_perm(r0, r1, odd);
      a[2] = __byte_perm(r2, r3, even);
      a[3] = __byte_perm(r2, r3, odd);
    }
  }

  static __device__ __forceinline__ void mma(int (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " FPV_D128
        ", {%128, %129, %130, %131}, %132, p;\n"
        "}\n"
        : FPV_ACC128(FPV_R)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }

  static __device__ __forceinline__ float row_value(const Params&, float) {
    return 0.0f;
  }

  static __device__ __forceinline__ float query_value(const Params&, int) {
    return 0.0f;
  }

  static __device__ __forceinline__ int score(const Params&, int dot, float,
                                              float) {
    return dot;
  }
};

// The fused int8 coarse scan (fpv_s8_topc): S8Op's mainloop on row-major
// codes, with the folded dequantisation, the metric and the mask applied to
// the accumulators in registers and a running top-c kept per query
// (topc_epilogue.cuh) instead of the (B, N) store.  Each operation rounds
// where PyTorch's passes round in s8_kernels.py (folded_epilogue): one
// IEEE operation each by the _rn intrinsics, never contracted into an FMA
// (the division by qn by fpv::div_rn, which rounds as IEEE division does),
// so the scores equal the plain version's bit for bit.
//   cosine: 1 - ((x qscale + const) / qn) rinv[n]
//   l2:     max(qsq + vsq[n] - 2 (x qscale + const), 0)
//   dot:    -(x qscale + const)
// What bounds it: at the int8 path's B=1024 x N=1M x D=768 the products,
// 1.65 T int8 operations, 0.83 ms at 1,979 TOP/s; its bytes are the codes
// (0.81 GB), the row values and mask and the (B, c) result, 0.25 ms at 3.35
// TB/s.  What stands in the way is the epilogue, which runs while the
// tensor cores wait: some 20 scalar operations a score (the scores of a
// tile are 256 x 128), then the rows that enter a list and the lists'
// compactions (tools/kernel_variants.py topc measures each part).
enum { COSINE = 0, L2 = 1, DOT = 2 };

template <int METRIC>
struct S8TopcOp : S8Op<false> {
  static constexpr bool TOPC = true;

  struct Params : S8Op<false>::Params, fpv::TopcParams {
    // (B, 4): the folded query's int8 scale, q . bias, qn (cosine) or qsq
    // (l2), and RN(1 / qn) (cosine)
    const float4* qparams;
    const float* rstat;   // (N,) rinv (cosine), vsq (l2); unused for dot
  };

  static __device__ __forceinline__ float4 query_params(const Params& p,
                                                        int q) {
    return p.qparams[q];
  }

  static __device__ __forceinline__ float row_param(const Params& p, int n) {
    return METRIC == DOT ? 0.0f : p.rstat[n];
  }

  static __device__ __forceinline__ float topc_score(int dot, float4 v,
                                                     float rv) {
    const float x = __fadd_rn(__fmul_rn(__int2float_rn(dot), v.x), v.y);
    if (METRIC == COSINE)
      return __fadd_rn(1.0f, -__fmul_rn(fpv::div_rn(x, v.z, v.w), rv));
    if (METRIC == L2) {
      const float t = __fsub_rn(__fadd_rn(v.z, rv), __fmul_rn(2.0f, x));
      return t < 0.0f ? 0.0f : t;   // clamp(min=0): NaN stays NaN
    }
    return -x;
  }
};

// blocks a query tile of the top-c scan: enough to fill the card, no more
// than the corpus tiles
int topc_blocks(int B, int N) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int qtiles = (B + fpv::BQ - 1) / fpv::BQ;
  const int ctiles = (N + fpv::BC - 1) / fpv::BC;
  const int g = sms / qtiles;
  return g < 1 ? 1 : (g < ctiles ? g : ctiles);
}

template <int METRIC>
int launch_topc(const void* q, const void* codes, const void* qparams,
                const float* rstat, const uint8_t* mask, void* lists, int B,
                int N, int D, int kp, int c, void* stream) {
  using Op = S8TopcOp<METRIC>;
  if (D <= 0 || kp % Op::KSTEP_ELEMS != 0 || kp < D ||
      kp - Op::KSTEP_ELEMS >= D || c <= 0 || c > fpv::TOPC_MAX || c > N)
    return int(cudaErrorInvalidValue);
  typename Op::Params p;
  p.B = B;
  p.N = N;
  p.out = nullptr;
  p.codes = static_cast<const uint8_t*>(codes);
  p.D = D;
  p.vec = (D % 16) == 0 && (reinterpret_cast<uintptr_t>(codes) % 16) == 0;
  p.lists = static_cast<uint2*>(lists);
  p.mask = mask;
  p.c = c;
  p.L = c + fpv::TOPC_SLACK;
  p.G = topc_blocks(B, N);
  p.qparams = static_cast<const float4*>(qparams);
  p.rstat = rstat;
  return fpv::launch<Op>(q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kp, p, stream,
                         p.vec ? codes : nullptr, D);
}

template <bool TN>
int launch(const void* q, const void* codes, void* out, int B, int N, int D,
           int kp, void* stream) {
  using Op = S8Op<TN>;
  // the kp positions must cover the D dims and no more than one step past
  if (D <= 0 || kp % Op::KSTEP_ELEMS != 0 || kp < D ||
      kp - Op::KSTEP_ELEMS >= D)
    return int(cudaErrorInvalidValue);
  typename Op::Params p;
  p.B = B;
  p.N = N;
  p.out = static_cast<int*>(out);
  p.codes = static_cast<const uint8_t*>(codes);
  p.D = D;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  p.vec = ((TN ? N : D) % 16) == 0 && (base % 16) == 0;
  // codes with aligned rows come tile by tile through TMA
  return fpv::launch<Op>(q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kp, p, stream,
                         p.vec ? codes : nullptr, D);
}

}  // namespace

extern "C" {

// q (B, kp) int8 query copy (zero past D), codes (N, D) int8; out (B, N)
// int32 inner products.  Returns a cudaError_t as int.
int fpv_s8_scores(const void* q, const void* codes, void* out, int B, int N,
                  int D, int kp, void* stream) {
  return launch<false>(q, codes, out, B, N, D, kp, stream);
}

// As above with the corpus stored transposed: codes_t (D, N) int8.
int fpv_s8_scores_tn(const void* q, const void* codes_t, void* out, int B,
                     int N, int D, int kp, void* stream) {
  return launch<true>(q, codes_t, out, B, N, D, kp, stream);
}

// The fused int8 coarse scan: q (B, kp) folded int8 queries (zero past D),
// codes (N, D) int8, qparams (B, 4) f32 (qscale, q . bias, qn or qsq,
// RN(1 / qn)), per row rstat (N,) f32 and mask (N,) bool; metric 0 cosine,
// 1 l2, 2 dot.  Leaves each block's c best (key, row) per query in lists
// (B, G, c + 256) uint2 (G = fpv_s8_topc_blocks(B, N)), for
// fpv_s8_topc_merge.  1 <= c <= min(N, 1024).  Returns a cudaError_t as
// int.
int fpv_s8_topc(const void* q, const void* codes, const void* qparams,
                const void* rstat, const void* mask, void* lists, int B,
                int N, int D, int kp, int c, int metric, void* stream) {
  if (reinterpret_cast<uintptr_t>(qparams) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const auto* rs = static_cast<const float*>(rstat);
  const auto* m = static_cast<const uint8_t*>(mask);
  switch (metric) {
    case COSINE:
      return launch_topc<COSINE>(q, codes, qparams, rs, m, lists, B, N, D,
                                 kp, c, stream);
    case L2:
      return launch_topc<L2>(q, codes, qparams, rs, m, lists, B, N, D, kp,
                             c, stream);
    case DOT:
      return launch_topc<DOT>(q, codes, qparams, rs, m, lists, B, N, D, kp,
                              c, stream);
  }
  return int(cudaErrorInvalidValue);
}

// G of fpv_s8_topc's lists for a (B, N) scan.
int fpv_s8_topc_blocks(int B, int N) { return topc_blocks(B, N); }

// lists (B, G, L) of fpv_s8_topc -> vals (B, c) f32 ascending, rows (B, c)
// int64.  Returns a cudaError_t as int.
int fpv_s8_topc_merge(const void* lists, void* vals, void* rows, int B,
                      int G, int L, int c, void* stream) {
  return fpv::topc_merge(lists, vals, rows, B, G, L, c, stream);
}

#ifdef FPV_TOPC_STATS
// read and reset the counts of a -DFPV_TOPC_STATS build
int fpv_s8_topc_stats(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, fpv::topc_stats, sizeof(fpv::topc_stats));
  const unsigned long long zero[2] = {0ull, 0ull};
  cudaMemcpyToSymbol(fpv::topc_stats, zero, sizeof(zero));
  return int(cudaGetLastError());
}
#endif

}  // extern "C"
