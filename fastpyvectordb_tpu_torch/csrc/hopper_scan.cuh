// The warp-specialised wgmma scan shared by quant_scores.cu (B1, B4) and
// hamming_scores.cu (B5, B6): (B, K) queries x (N, packed codes) corpus ->
// (B, N) scores, for Hopper (sm_90a).
//
// The product runs transposed: the corpus rows are wgmma's M side, taken
// from registers, and the queries its N side (n256), read from shared
// memory.  So the codes are expanded by the threads that multiply them,
// straight into wgmma's register A fragments, and never pass through
// shared memory as an expanded operand.
//
// One persistent block per SM walks (128 corpus rows x 256 queries) tiles,
// the query tiles of one corpus tile next to each other so that their code
// rows come from L2.  Each block has three warpgroups:
//
//   * warpgroup 2, the producer, fills a ring of Op::STAGES shared-memory
//     stages, one K step each (128 bytes of every query row): its first
//     thread loads the step's query tile (256 x 128 B) with TMA into a
//     128-byte-swizzled tile; every thread copies one corpus row's packed
//     codes for the step with cp.async (threads 0-31 also the step's
//     Op table), and the stage's `full` mbarrier completes when all of
//     these have landed.  Where a step's corpus tile is itself 128 rows x
//     128 bytes of a row-major matrix (the s8 scan), the first thread
//     loads it with TMA as well and the others only arrive.
//   * warpgroups 0 and 1, the consumers: 64 corpus rows each.  For each
//     16- (bf16) or 32-deep (int8) slice a thread expands its fragment's
//     codes (Op::fragment: dequantise to bf16, or bits to +-1 int8) into
//     4 registers and issues one m64n256 wgmma against the query tile (128
//     accumulator registers a thread); two fragment buffers let the next
//     slice's expansion overlap the product in flight.  A stage is
//     released on `empty` once its last product has completed.  Where Op
//     keeps a per-row sum (the dequantised row's squared norm), each
//     thread sums its fragment's share and a quad of lanes adds them up:
//     the rows a thread sums are the rows of its accumulators.  The
//     epilogue turns the accumulators into scores (Op::score), writes them
//     32 queries x 64 rows a round into one half of a swizzled staging
//     tile, and stores that with TMA while the next round fills the other
//     half; the tile's last stores drain while the next tile's products
//     run.  Where N is not a multiple of 4 (TMA needs
//     16-byte rows) they are stored from registers instead.  An Op with
//     TOPC (topc_epilogue.cuh) keeps a running top-c of each query's
//     scores in place of the epilogue's store, in the staging area's room.
//     An Op with CODES_DN takes its corpus as a (D, N) byte matrix: a
//     step's tile is 128 d-rows x 128 corpus rows of it (the TMA
//     coordinates swap), and with PAIRED_ROWS the consumers' fragment rows
//     frow, frow + 8 are the adjacent corpus rows of their warp's 16 (the
//     epilogue writes each accumulator row to that corpus row).
//
// setmaxnreg moves registers from the producer to the consumers.  The
// query operand is a (B, Kp) copy made by the wrapper (bf16 or int8, Kp a
// multiple of one K step, zero past the true width); the TMA descriptors
// of it and of the output are built here in the launcher, with
// cuTensorMapEncodeTiled taken from the runtime's driver entry point (no
// -lcuda).  Query rows past B are zero-filled by TMA, corpus rows past N
// are read as zero codes, and outputs past (B, N) are clipped by TMA or
// masked.

#pragma once

#include "hopper_common.cuh"
#include "topc_epilogue.cuh"

namespace fpv {

constexpr int BQ = 256;                   // queries per tile (wgmma N)
constexpr int BC = 128;                   // corpus rows per tile (2 x m64)
constexpr int ROW_BYTES = 128;            // one K step of a query row
constexpr int Q_BYTES = BQ * ROW_BYTES;   // query tile of a stage
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int PRODUCERS = 128;            // one producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers a thread after setmaxnreg, moved from the producer to the
// consumers; the two claims must leave slack in the SM's 65,536 (with none
// the consumers' claim can wait forever)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 224;
static_assert(PRODUCERS * kProducerRegs + CONSUMERS * kConsumerRegs <=
                  65536 - 2048, "register budget");
constexpr int OUT_BOX = 32 * 32 * 4;      // one 32 x 32 4-byte TMA store box
constexpr int HALF = 2 * OUT_BOX;         // a round: 32 queries x 64 rows
constexpr int STAGING = 2 * HALF;         // a consumer's two staging halves

// an Op's optional hooks (header note): CODES_DN, PAIRED_ROWS
template <class Op, class = void>
struct CodesDN : std::false_type {};
template <class Op>
struct CodesDN<Op, std::void_t<decltype(Op::CODES_DN)>>
    : std::integral_constant<bool, Op::CODES_DN> {};
template <class Op, class = void>
struct PairedRows : std::false_type {};
template <class Op>
struct PairedRows<Op, std::void_t<decltype(Op::PAIRED_ROWS)>>
    : std::integral_constant<bool, Op::PAIRED_ROWS> {};

// corpus row, of a consumer warpgroup's 64, of accumulator register 4i + e
// of warp w, lane `lane`
template <class Op>
__device__ __forceinline__ int acc_row(int w, int lane, int e) {
  return PairedRows<Op>::value ? 16 * w + 2 * (lane / 4) + (e >> 1)
                               : 16 * w + lane / 4 + 8 * (e >> 1);
}

// shared memory of the scan: two staging tiles, then per stage the query
// tile, Op's codes and table (Op::STAGE_EXTRA bytes) and two barriers
template <class Op>
struct Layout {
  static constexpr int STAGE = Q_BYTES + Op::STAGE_EXTRA;
  static constexpr int RING = 2 * STAGING;
  static constexpr int BAR = RING + Op::STAGES * STAGE;
  static constexpr int BYTES = BAR + 2 * Op::STAGES * 8;
  static_assert(STAGE % 1024 == 0, "stages keep the 1024-byte swizzle atoms");
};

template <class Op>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap omap,
            const __grid_constant__ CUtensorMap cmap,
            const typename Op::Params p, int ntiles, int qtiles, int ksteps,
            int tma_out, int tma_codes) {
  using L = Layout<Op>;
  constexpr int STAGES = Op::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + L::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS + 1);    // producers + the TMA arrive
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one corpus row of every tile per thread ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int r = tid - CONSUMERS;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int n = (tile / qtiles) * BC + r;
      for (int k = 0; k < ksteps; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * L::STAGE;
        if (r == 0) {
          mbar_arrive_tx(&full[stage], Q_BYTES);
          tma_load_2d(st, &qmap, &full[stage], k * Op::KSTEP_ELEMS,
                      (tile % qtiles) * BQ);
        }
        // a corpus tile that is the stage's whole extra (tma_codes) comes
        // by TMA too, the first thread arriving a second time with its
        // bytes; else every thread copies its row: copies with cp.async
        // arrive when they land; others (ragged rows, written by this
        // thread) arrive at once
        if (tma_codes) {
          if (r == 0) {
            mbar_arrive_tx(&full[stage], Op::STAGE_EXTRA);
            const int c0 = k * Op::KSTEP_ELEMS, c1 = (tile / qtiles) * BC;
            if constexpr (CodesDN<Op>::value)
              tma_load_2d(st + Q_BYTES, &cmap, &full[stage], c1, c0);
            else
              tma_load_2d(st + Q_BYTES, &cmap, &full[stage], c0, c1);
          } else {
            mbar_arrive(&full[stage]);
          }
        } else if (Op::fetch(p, st + Q_BYTES, r, n, k)) {
          mbar_arrive_cp_async(&full[stage]);
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 corpus rows of every tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = tid / 128;
    const int w = (tid % 128) / 32;
    const int lane = tid % 32;
    const int frow = 64 * g + 16 * w + lane / 4;   // fragment rows: +0, +8
    uint8_t* out_s = smem + g * STAGING;
    typename Op::Acc d[128];
    uint32_t a[2][4];        // fragment buffers: slices alternate
    int stage = 0;
    uint32_t phase = 0;
    if constexpr (IsTopc<Op>::value)
      topc_begin<Op>(p, smem, blockIdx.x % qtiles, tid);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      float rs0 = 0.0f, rs1 = 0.0f;   // Op's row sums of rows frow, frow + 8
      int prev = 0;
      for (int k = 0; k < ksteps; ++k) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = ring + stage * L::STAGE;
        const uint64_t db = sw128_desc(st);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // the product that read a[kk & 1] two slices ago has completed
          wgmma_wait<1>();
          fence_regs(a[kk & 1]);
          // and at the second slice, the previous stage's last product
          if (kk == 1 && k > 0 && lane == 0) mbar_arrive(&empty[prev]);
          Op::fragment(p, st + Q_BYTES, frow, lane, kk, a[kk & 1], rs0, rs1);
          fence_regs(d);
          wgmma_fence();
          Op::mma(d, a[kk & 1], db + 2 * kk, (k > 0 || kk > 0) ? 1 : 0);
          wgmma_commit();
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
      if constexpr (IsTopc<Op>::value) {
        // the top-c epilogue keeps the tile's best scores instead
        topc_tile<Op>(p, d, smem, tile, qtiles, tid);
        continue;
      }

      // a quad of lanes shares its rows: add up their sums
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
      const float cv0 = Op::row_value(p, rs0), cv1 = Op::row_value(p, rs1);

      // accumulator layout of m64n256: register 4i + e of warp w, lane l is
      // corpus row 16w + l/4 (+8 for e >= 2) and query 8i + 2(l%4) + (e & 1)
      const int m0 = (tile % qtiles) * BQ;               // the tile's queries
      const int n0 = (tile / qtiles) * BC + 64 * g;      // this group's rows
      const int cq = 2 * (lane % 4);
      if (tma_out) {
        // 32 queries x 64 rows a round through one half of the staging
        // tile (two swizzled 32 x 32 boxes) while TMA still reads the other
        // half: every round commits a group, so once "all but the last"
        // have been read, the store that used this half is done with it
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (tid % 128 == 0) bulk_wait_read<1>();
          named_sync(1 + g, 128);
          uint8_t* buf = out_s + (r & 1) * HALF;
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int i = 4 * r + ii;
            if constexpr (PairedRows<Op>::value) {
              // registers e and e + 2 are the adjacent corpus rows col,
              // col + 1: one 8-byte store a query
              struct alignas(8) Pair { typename Op::Out lo, hi; };
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int qr = 8 * ii + cq + e;            // query in the box
                const int col = acc_row<Op>(w, lane, 0);
                const float qv = Op::query_value(p, min(m0 + 32 * r + qr,
                                                        p.B - 1));
                *reinterpret_cast<Pair*>(
                    buf + (col / 32) * OUT_BOX +
                    sw128_chunk(qr, (col % 32) / 4) + 4 * (col % 4)) =
                    Pair{Op::score(p, d[4 * i + e], qv, cv0),
                         Op::score(p, d[4 * i + e + 2], qv, cv1)};
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qr = 8 * ii + cq + (e & 1);      // query in the box
                const int col = acc_row<Op>(w, lane, e);
                const float qv = Op::query_value(p, min(m0 + 32 * r + qr,
                                                        p.B - 1));
                const typename Op::Out s =
                    Op::score(p, d[4 * i + e], qv, e < 2 ? cv0 : cv1);
                *reinterpret_cast<typename Op::Out*>(
                    buf + (col / 32) * OUT_BOX +
                    sw128_chunk(qr, (col % 32) / 4) + 4 * (col % 4)) = s;
              }
            }
          }
          fence_proxy_async();
          named_sync(1 + g, 128);
          if (tid % 128 == 0) {
            if (n0 < p.N && m0 + 32 * r < p.B) {
              tma_store_2d(&omap, buf, n0, m0 + 32 * r);
              tma_store_2d(&omap, buf + OUT_BOX, n0 + 32, m0 + 32 * r);
            }
            bulk_commit();
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = m0 + 8 * i + cq + (e & 1);
            const int n = n0 + acc_row<Op>(w, lane, e);
            if (q < p.B && n < p.N)
              p.out[(size_t)q * p.N + n] = Op::score(
                  p, d[4 * i + e], Op::query_value(p, q), e < 2 ? cv0 : cv1);
          }
        }
      }
    }
    if constexpr (IsTopc<Op>::value) topc_end<Op>(p, smem, qtiles, tid);
    if (tid % 128 == 0) bulk_wait_all();
  }
}

// Launch scan_kernel<Op> over the (B, N) output.  `q` is the (B, kp)
// query copy of `qtype` (bf16 or 8-bit), kp a multiple of one K step.
// `corpus`, if given, is a row-major (N, ccols) byte matrix ((ccols, N)
// for a CODES_DN Op) whose (BC rows x 128 bytes) tiles are a stage's whole
// extra in the 128-byte swizzle, with 16-byte-aligned rows: TMA loads them
// in place of Op::fetch.  Returns a
// cudaError_t as int: the last error after the launch, or the reason the
// launch was refused.
template <class Op>
int launch(const void* q, CUtensorMapDataType qtype, int elem_bytes, int kp,
           const typename Op::Params& p, void* stream,
           const void* corpus = nullptr, int ccols = 0) {
  if (p.B <= 0 || p.N <= 0) return int(cudaGetLastError());
  const int kstep = ROW_BYTES / elem_bytes;
  if (kp <= 0 || kp % kstep != 0 ||
      (reinterpret_cast<uintptr_t>(q) % 16) != 0)
    return int(cudaErrorInvalidValue);
  CUtensorMap qmap, omap, cmap = {};
  if (!encode_2d(&qmap, qtype, elem_bytes, q, p.B, kp, BQ, kstep))
    return int(cudaErrorInvalidValue);
  // (N, ccols), or (ccols, N) for a CODES_DN Op: 128 x 128-byte boxes
  const int crows = CodesDN<Op>::value ? ccols : p.N;
  if (corpus != nullptr &&
      (Op::STAGE_EXTRA != BC * ROW_BYTES ||
       !encode_2d(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, corpus, crows,
                  CodesDN<Op>::value ? p.N : ccols, BC, ROW_BYTES)))
    return int(cudaErrorInvalidValue);
  // the output goes out by TMA where its rows are whole 16-byte units (a
  // top-c scan stores none)
  const int tma_out = !IsTopc<Op>::value && (p.N % 4) == 0 &&
                      (reinterpret_cast<uintptr_t>(p.out) % 16) == 0;
  if (tma_out && !encode_2d(&omap, Op::OUT_TYPE, 4, p.out, p.B, p.N, 32, 32))
    return int(cudaErrorInvalidValue);

  const int bytes = 1024 + Layout<Op>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return int(e);
  const int qtiles = (p.B + BQ - 1) / BQ;
  const long long tiles = (long long)qtiles * ((p.N + BC - 1) / BC);
  if (tiles > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int grid = int(tiles < sms ? tiles : sms);   // persistent blocks
  if constexpr (IsTopc<Op>::value) {
    // G blocks a query tile, each keeping to it (topc_epilogue.cuh)
    static_assert(TOPC_SMEM <= 2 * STAGING, "top-c state fits the staging");
    grid = qtiles * p.G;
  }
  scan_kernel<Op><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      qmap, omap, cmap, p, int(tiles), qtiles, kp / kstep, tma_out,
      corpus != nullptr);
  return int(cudaGetLastError());
}

}  // namespace fpv
