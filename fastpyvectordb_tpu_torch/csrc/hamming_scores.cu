// Packed-bit Hamming distances for Hopper (sm_90a) as an exact int8
// tensor-core product -> (B, N) counts.
//
// Replaces the TPU Pallas kernels in fastpyvectordb_tpu/kernels/pallas_quant.py:
//   fpv_hamming_mxu_scores <- hamming_mxu_scores (_hamming_mxu_kernel):
//                             the count as f32 (the binary two-stage scan)
//   fpv_hamming_scores     <- hamming_scores     (_hamming_kernel):
//                             the count as int32 (BinaryQuantizer, rerank <= 1)
// One templated kernel (hopper_scan.cuh's scan_kernel with HammingOp); the
// two entries differ only in the output type.
//
// What it computes, per (query b, corpus row n):
//   out[b, n] = sum_w popc(q[b, w] ^ c[n, w]) = (32W - q+- . c+-) / 2
// where x+- maps each bit of the row-major (., W) int32 words to +1 (set)
// or -1 (clear), bit j of word w at position 32w + j, as the TPU kernel of
// the two-stage scan does.  Padding bits past D are clear on both sides,
// so they add +1 to the product and 0 to the count.  The product is
// s8 x s8 -> s32 on the tensor cores: sums of +-1 are exact in s32, so both
// entries equal their plain versions (a byte-table popcount) bit for bit.
//
// What bounds it: at the binary path's B=1024 x N=1M x W=24 (768 dims) the
// +-1 product is 2*B*N*32W = 1.57 T int8 operations, 0.79 ms at 1,979
// TOP/s; its bytes are the (B, N) 4-byte output (4.10 GB), the codes
// (0.10 GB) and the queries, 1.25 ms at 3.35 TB/s.  So it is bound by the
// output write.  XOR + popcount on the CUDA cores (16 popcounts a clock per
// SM) would take ~6.6 ms for the same count.
//
// What the design does about it: wgmma (m64n256k32, s8 -> s32) on tiles of
// 128 corpus rows x 256 queries in a persistent, warp-specialised block
// (hopper_scan.cuh), with the corpus rows as wgmma's M side, taken from
// registers.  The wrapper expands the query words once per call into a
// (B, Kp) +-1 int8 copy (zero past 32W, Kp a multiple of 128), which TMA
// loads into a 5-stage ring of swizzled tiles beside each step's corpus
// words (cp.async, by a producer warpgroup).  Each consumer thread expands
// the bits of its own A fragment, a nibble into 4 bytes with one
// multiply-and-mask (bit i -> byte i) and one multiply for the sign.  The
// epilogue forms (32W - dot) >> 1 from the accumulators and stores it
// through a staging tile with TMA.  On one H100 it runs the binary path's
// shape in ~1.8-1.9 ms against its 1.25 ms bound (PERF.md): the output
// store blocks the consumers for part of every tile.

#include <type_traits>

#include "hopper_scan.cuh"

namespace {

template <typename OutT>
struct HammingOp {
  using Acc = int;
  using Out = OutT;
  static constexpr CUtensorMapDataType OUT_TYPE =
      std::is_same<OutT, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_INT32;
  static constexpr int KSTEP_ELEMS = 128;   // int8 a step: 4 words
  static constexpr int CODE_BYTES = 16;     // a row a step
  static constexpr int STAGE_EXTRA = fpv::BC * CODE_BYTES;
  static constexpr int STAGES = 5;

  struct Params {
    int B, N;
    OutT* out;              // (B, N)
    const uint32_t* codes;  // (N, W)
    int W;
    int vec;                // 16-byte word copies: aligned rows
  };

  // copy words 4k .. 4k + 3 of corpus row n (thread r's row) into the
  // stage, zero past the row or N.  True if the copy went by cp.async.
  static __device__ __forceinline__ bool fetch(const Params& p, uint8_t* ex,
                                               int r, int n, int k) {
    const int w0 = 4 * k;
    const uint32_t* src = p.codes + (size_t)n * p.W + w0;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ex + r * CODE_BYTES);
    if (p.vec && n < p.N && w0 + 4 <= p.W) {
      fpv::cp_async16(dst, src);
      return true;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = (n < p.N && w0 + i < p.W) ? __ldg(src + i) : 0u;
    return false;
  }

  // 4 bits -> 4 bytes, +1 where the bit is set and -1 (0xFF) where clear
  static __device__ __forceinline__ uint32_t pm1_nibble(uint32_t x) {
    const uint32_t m = ((x & 0xFu) * 0x00204081u) & 0x01010101u;
    return ~(m * 0xFEu);
  }

  // the A fragment of slice kk (bits 32kk .. 32kk + 31 = word kk of the
  // step) for rows frow, frow + 8: a[0] / a[1] bits 4q .. 4q + 3 of each
  // row's word, a[2] / a[3] bits 16 + 4q .. (q = lane % 4)
  static __device__ __forceinline__ void fragment(const Params&,
                                                  const uint8_t* ex, int frow,
                                                  int lane, int kk,
                                                  uint32_t (&a)[4], float&,
                                                  float&) {
    const int q = lane % 4;
    const uint32_t x0 =
        reinterpret_cast<const uint32_t*>(ex + frow * CODE_BYTES)[kk];
    const uint32_t x1 =
        reinterpret_cast<const uint32_t*>(ex + (frow + 8) * CODE_BYTES)[kk];
    a[0] = pm1_nibble(x0 >> (4 * q));
    a[1] = pm1_nibble(x1 >> (4 * q));
    a[2] = pm1_nibble(x0 >> (16 + 4 * q));
    a[3] = pm1_nibble(x1 >> (16 + 4 * q));
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

  static __device__ __forceinline__ OutT score(const Params& p, int dot, float,
                                               float) {
    return OutT((32 * p.W - dot) >> 1);
  }
};

template <typename OutT>
int launch(const void* qpm, const void* codes, void* out, int B, int N, int W,
           int kp, void* stream) {
  using Op = HammingOp<OutT>;
  // the kp positions must cover the 32W bits and no more than one step past
  if (W <= 0 || kp % Op::KSTEP_ELEMS != 0 || kp < 32 * W ||
      kp - Op::KSTEP_ELEMS >= 32 * W)
    return int(cudaErrorInvalidValue);
  typename Op::Params p;
  p.B = B;
  p.N = N;
  p.out = static_cast<OutT*>(out);
  p.codes = static_cast<const uint32_t*>(codes);
  p.W = W;
  p.vec = (W % 4) == 0 && (reinterpret_cast<uintptr_t>(codes) % 16) == 0;
  return fpv::launch<Op>(qpm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kp, p, stream);
}

}  // namespace

extern "C" {

// qpm (B, kp) int8 +-1 query bits (zero past 32W), c (N, W) packed 32-bit
// words; out (B, N) f32 Hamming distances.  Returns a cudaError_t as int.
int fpv_hamming_mxu_scores(const void* qpm, const void* c, void* out, int B,
                           int N, int W, int kp, void* stream) {
  return launch<float>(qpm, c, out, B, N, W, kp, stream);
}

// As above with an int32 output.  Returns a cudaError_t as int.
int fpv_hamming_scores(const void* qpm, const void* c, void* out, int B, int N,
                       int W, int kp, void* stream) {
  return launch<int>(qpm, c, out, B, N, W, kp, stream);
}

}  // extern "C"
