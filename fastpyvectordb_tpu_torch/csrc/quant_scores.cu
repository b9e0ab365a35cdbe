// Dequantize-on-load quantized scans for Hopper (sm_90a): int8 and packed
// int4 codes against queries -> (B, N) f32 scores, lower = closer.
//
// Replaces the TPU Pallas kernels in fastpyvectordb_tpu/kernels/pallas_quant.py:
//   fpv_sq_scores   <- sq_scores   (_sq_kernel):   v = (c + 128) * scale/255 + vmin
//   fpv_int4_scores <- int4_scores (_int4_kernel): halves-packed nibbles,
//                      byte w = dim w (low nibble) | dim w + W (high nibble),
//                      v = c * scale/15 + vmin
// One templated kernel (hopper_scan.cuh's scan_kernel with QuantOp); the
// two entries differ only in the code loader.
//
// What it computes, per (query b, corpus row n):
//   cross = sum_d bf16(q[b,d]) * bf16(v[n,d])       (f32 accumulation)
//   vsq   = sum_d v[n,d]^2                           (from the f32 v, as the
//                                                      Pallas kernels do)
//   cosine: 1 - cross * rsqrt(max(vsq, 1e-30))       (q pre-normalised)
//   l2:     max(qsq[b] + vsq - 2 * cross, 0)
//   dot:    -cross
// with v = rn(rn(code * rscale_d) + vmin_d): a rounded multiply, then a
// rounded add, never a fused multiply-add, so that the bf16 operand is the
// plain version's.  The wrapper (kernels/quant_kernels.py) normalises cosine
// queries, forms qsq, and makes two tables in the kernel's dimension order:
// the (B, Kp) bf16 query copy (zero past the true width) and the (Kp,)
// (rscale, vmin) pairs (zero there too, so padding adds nothing).  That order
// is the natural one for int8; for int4 it interleaves the two halves, so
// one code byte gives two neighbouring bf16 values: K step j (64 positions)
// reads code bytes 32j .. 32j + 31, position 2i + h = nibble h of byte
// 32j + i = dim 32j + i + h * W.
//
// What bounds it: at the int4 path's B=1024 x N=1M x D=768 the product is
// 2*B*N*D = 1.57 TFLOP, 1.59 ms at 989 TFLOP/s bf16; the bytes are the
// (B, N) f32 output (4.10 GB), the codes (0.38 GB int4, 0.77 GB int8) and
// the queries, 1.34 ms (int4) at 3.35 TB/s.  So it is bound by the bf16
// tensor cores, with the output stream close behind.
//
// What the design does about it: wgmma (m64n256k16, bf16 -> f32) on
// tiles of 128 corpus rows x 256 queries in a persistent, warp-specialised
// block (hopper_scan.cuh), with the product transposed: the corpus rows
// are wgmma's M side, taken from registers.  The query operand is
// converted to bf16 once per call and arrives by TMA into a 5-stage (int8:
// 4) ring of swizzled tiles, beside each step's code bytes and (rscale,
// vmin) pairs, which a producer warpgroup copies with cp.async.  Each
// consumer thread dequantises exactly the elements of its own A fragment
// (codes to floats with integer bit tricks, not I2F), so the expanded
// corpus never passes through shared memory, and sums vsq for the rows of
// its own accumulators: the epilogue needs no per-row table.  The scores
// go out through a swizzled staging tile by TMA.
//
// What still holds it back (one H100, 1024 x 1M x 768: ~3.5-3.7 ms against
// the 1.59 ms bound; PERF.md): the dequantisation, ~8 instructions an
// element on the consumers' issue slots, and the 4.1 GB output, whose
// store blocks the consumers for part of every tile, as it does the
// library GEMM's.

#include <cuda_bf16.h>

#include "hopper_scan.cuh"

namespace {

using fpv::small_uint_to_float;

enum Metric { COSINE = 0, L2 = 1, DOT = 2 };
enum Kind { INT8 = 0, INT4 = 1 };

template <int KIND>
struct QuantOp {
  using Acc = float;
  using Out = float;
  static constexpr CUtensorMapDataType OUT_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int KSTEP_ELEMS = 64;                      // bf16 a step
  static constexpr int CODE_BYTES = KIND == INT8 ? 64 : 32;   // a row a step
  // a stage's extra: every row's code bytes of one K step, then the step's
  // 64 (rscale, vmin) pairs, padded to whole 1024-byte units
  static constexpr int SV_OFF = fpv::BC * CODE_BYTES;
  static constexpr int STAGE_EXTRA = (SV_OFF + KSTEP_ELEMS * 8 + 1023) / 1024 * 1024;
  static constexpr int STAGES = KIND == INT8 ? 4 : 5;

  struct Params {
    int B, N;
    float* out;            // (B, N)
    const uint8_t* codes;  // (N, row_bytes)
    const float* qsq;      // (B,)
    const float2* sv;      // (kp,) (rscale, vmin) in the kernel's order
    int row_bytes;         // D (int8) or W (int4)
    int metric;
    int vec;               // 16-byte code copies: aligned rows
  };

  // copy K step k of corpus row n (thread r's row) into the stage, zero
  // past the row or N; threads 0-31 copy the step's scale pairs.  True if
  // every copy went by cp.async, false if this thread wrote them itself.
  static __device__ __forceinline__ bool fetch(const Params& p, uint8_t* ex,
                                               int r, int n, int k) {
    const int b0 = k * CODE_BYTES;
    const uint8_t* src = p.codes + (size_t)n * p.row_bytes + b0;
    uint8_t* dst = ex + r * CODE_BYTES;
    const uint8_t* svsrc =
        reinterpret_cast<const uint8_t*>(p.sv + k * KSTEP_ELEMS) + 16 * r;
    uint8_t* svdst = ex + SV_OFF + 16 * r;
    if (p.vec && n < p.N && b0 + CODE_BYTES <= p.row_bytes) {
#pragma unroll
      for (int i = 0; i < CODE_BYTES / 16; ++i)
        fpv::cp_async16(dst + 16 * i, src + 16 * i);
      if (r < KSTEP_ELEMS * 8 / 16) fpv::cp_async16(svdst, svsrc);
      return true;
    }
#pragma unroll
    for (int i = 0; i < CODE_BYTES / 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n < p.N && b0 + 4 * i + j < p.row_bytes)
          word |= uint32_t(__ldg(src + 4 * i + j)) << (8 * j);
      reinterpret_cast<uint32_t*>(dst)[i] = word;
    }
    if (r < KSTEP_ELEMS * 8 / 16)
      *reinterpret_cast<uint4*>(svdst) =
          __ldg(reinterpret_cast<const uint4*>(svsrc));
    return false;
  }

  // two neighbouring positions of one row dequantised: rn(rn(code * rscale)
  // + vmin), never fused, as the plain version rounds; bf16x2 out, v^2 summed
  static __device__ __forceinline__ uint32_t dequant2(uint32_t c0, uint32_t c1,
                                                      const float4& s,
                                                      float& sum) {
    const float v0 = __fadd_rn(__fmul_rn(small_uint_to_float(c0), s.x), s.y);
    const float v1 = __fadd_rn(__fmul_rn(small_uint_to_float(c1), s.z), s.w);
    sum = fmaf(v0, v0, sum);
    sum = fmaf(v1, v1, sum);
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }

  // the two code bytes of positions 16kk + 2q, +1 and 16kk + 8 + 2q, +1 in
  // a row's step, as (c0, c1) pairs of codes: int4 reads byte 8kk + q
  // (both nibbles) and byte 8kk + 4 + q; int8 bytes 16kk + 2q, +1 and
  // 16kk + 8 + 2q, +1 (+ 128)
  static __device__ __forceinline__ void codes4(const uint8_t* row, int kk,
                                                int q, uint32_t (&c)[4]) {
    if (KIND == INT4) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + 8 * kk);
      const uint32_t b0 = (v.x >> (8 * q)) & 0xFFu;
      const uint32_t b1 = (v.y >> (8 * q)) & 0xFFu;
      c[0] = b0 & 0xFu;
      c[1] = b0 >> 4;
      c[2] = b1 & 0xFu;
      c[3] = b1 >> 4;
    } else {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(row + 16 * kk);
      const uint32_t h0 = w[q / 2] >> (16 * (q % 2));
      const uint32_t h1 = w[2 + q / 2] >> (16 * (q % 2));
      c[0] = (h0 & 0xFFu) ^ 0x80u;
      c[1] = ((h0 >> 8) & 0xFFu) ^ 0x80u;
      c[2] = (h1 & 0xFFu) ^ 0x80u;
      c[3] = ((h1 >> 8) & 0xFFu) ^ 0x80u;
    }
  }

  // the A fragment of slice kk (16 positions) for rows frow, frow + 8:
  // a[0] / a[1] positions 16kk + 2q, +1 of each row, a[2] / a[3] positions
  // 16kk + 8 + 2q, +1 (q = lane % 4); sums v^2 into rs0 / rs1
  static __device__ __forceinline__ void fragment(const Params&,
                                                  const uint8_t* ex, int frow,
                                                  int lane, int kk,
                                                  uint32_t (&a)[4], float& rs0,
                                                  float& rs1) {
    const int q = lane % 4;
    const float4* sv4 = reinterpret_cast<const float4*>(ex + SV_OFF);
    const float4 s0 = sv4[8 * kk + q], s1 = sv4[8 * kk + 4 + q];
    uint32_t c[4];
    codes4(ex + frow * CODE_BYTES, kk, q, c);
    a[0] = dequant2(c[0], c[1], s0, rs0);
    a[2] = dequant2(c[2], c[3], s1, rs0);
    codes4(ex + (frow + 8) * CODE_BYTES, kk, q, c);
    a[1] = dequant2(c[0], c[1], s0, rs1);
    a[3] = dequant2(c[2], c[3], s1, rs1);
  }

  static __device__ __forceinline__ void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FPV_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
        "}\n"
        : FPV_ACC128(FPV_F)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }

  // what the epilogue uses of a corpus row: rsqrt(vsq) for cosine, else vsq
  static __device__ __forceinline__ float row_value(const Params& p,
                                                    float vsq) {
    return p.metric == COSINE ? rsqrtf(fmaxf(vsq, 1e-30f)) : vsq;
  }

  static __device__ __forceinline__ float query_value(const Params& p, int q) {
    return p.metric == L2 ? __ldg(p.qsq + q) : 0.0f;
  }

  static __device__ __forceinline__ float score(const Params& p, float cross,
                                                float qs, float rv) {
    if (p.metric == COSINE) return 1.0f - cross * rv;
    if (p.metric == L2) return fmaxf(qs + rv - 2.0f * cross, 0.0f);
    return -cross;
  }
};

template <int KIND>
int launch(const void* qk, const void* codes, const void* sv, const void* qsq,
           void* out, int B, int N, int row_bytes, int kp, int metric,
           void* stream) {
  using Op = QuantOp<KIND>;
  const int ksteps = kp / Op::KSTEP_ELEMS;
  // the code bytes of kp positions must cover the row and no more
  if (row_bytes <= 0 || kp % Op::KSTEP_ELEMS != 0 ||
      ksteps * Op::CODE_BYTES < row_bytes ||
      (ksteps - 1) * Op::CODE_BYTES >= row_bytes)
    return int(cudaErrorInvalidValue);
  typename Op::Params p;
  p.B = B;
  p.N = N;
  p.out = static_cast<float*>(out);
  p.codes = static_cast<const uint8_t*>(codes);
  p.qsq = static_cast<const float*>(qsq);
  p.sv = static_cast<const float2*>(sv);
  p.row_bytes = row_bytes;
  p.metric = metric;
  p.vec = (row_bytes % 16) == 0 &&
          (reinterpret_cast<uintptr_t>(codes) % 16) == 0;
  if ((reinterpret_cast<uintptr_t>(sv) % 16) != 0)
    return int(cudaErrorInvalidValue);
  return fpv::launch<Op>(qk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kp, p,
                         stream);
}

}  // namespace

extern "C" {

// qk (B, kp) bf16 query copy, codes (N, D) int8, sv (kp, 2) f32 (rscale,
// vmin), qsq (B,) f32, out (B, N) f32.  Returns a cudaError_t as int.
int fpv_sq_scores(const void* qk, const void* codes, const void* sv,
                  const void* qsq, void* out, int B, int N, int D, int kp,
                  int metric, void* stream) {
  return launch<INT8>(qk, codes, sv, qsq, out, B, N, D, kp, metric, stream);
}

// qk (B, kp) bf16 in the interleaved-halves order, packed (N, W) uint8
// halves layout, sv (kp, 2) f32 in the same order, qsq (B,) f32, out (B, N)
// f32.  Returns a cudaError_t as int.
int fpv_int4_scores(const void* qk, const void* packed, const void* sv,
                    const void* qsq, void* out, int B, int N, int W, int kp,
                    int metric, void* stream) {
  return launch<INT4>(qk, packed, sv, qsq, out, B, N, W, kp, metric, stream);
}

}  // extern "C"
