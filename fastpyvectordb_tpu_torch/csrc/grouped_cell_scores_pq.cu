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
// The lookup is conflict-free by construction: a lane is a query slot.  A
// warp takes cell rows four at a time (one 32-bit broadcast read of their
// code bytes) and its 32 lanes read 32 different slots' tables at the same
// code; each slot's staged chunk is padded to an odd number of bank words,
// so the 32 reads fall into 32 banks.  A thread keeps the sums of its
// warp's rows for its slot in registers (up to 48), so a (slot, cell)
// pair's table is staged once, not once a cmax tile.
//
// Work list: a small plan kernel (a warp a compact slot u < cell_ids[0]; no
// host sync learns the count) reads each row's load, the index of its last
// live slot + 1 (invert_pairs fills a row's slots as a prefix; a hole is
// skipped, not mis-scored), and cuts it into tiles of 32 slots plus a tail
// sized to the load: a tile of W = 16 or 8 slots gives the warp's other
// lanes to 2 or 4 row groups, so a tail of 5 slots costs a quarter of a
// full tile.  The tiles of one cell lie next to each other in the list.
//
// Main kernel: one persistent 768-thread block an SM, with the card's 227 KB
// of shared memory opted in to, draws tiles from the list with an atomic
// counter.  Eight producer warps (40 registers a thread after setmaxnreg;
// the consumers take 96) stage, per chunk of MC subspaces (2 KB a
// slot: 4 subspaces at K 256), each live slot's table chunk
// lut[q, m0*K : (m0+MC)*K] (one contiguous run) and the chunk's code bytes
// into a ring of 3 stages with 4-byte cp.async copies that report to the
// stage's `full` mbarrier: the odd pitch that makes the lookup
// conflict-free is not a 16-byte multiple, which rules out TMA and 16-byte
// copies for the table.  Sixteen consumer warps look chunk i up while
// chunks i+1.. arrive, and release the stage on `empty`.  The tile's id
// travels in the stage's header.  Sums leave the registers as 16-byte
// stores, a thread's rows being contiguous.
// Ragged cmax, M, K and qcap take the same path; where K is odd or cmax
// not a multiple of 4 (or a base unaligned) the producers copy with plain
// loads and stores instead of cp.async.
//
// What bounds it: at the main path's shape (1M rows, nlist 2000, cmax 768,
// M 96, K 256, B=1024 at nprobe 64: 65,536 live (query, cell) pairs) it is
// 4.8 G table lookups and adds out of shared memory, one bank word a lane a
// clock at best (~0.6 ms), plus 3.2 GB of table rows staged (the 50 MB of
// tables ~64 times over, mostly from L2) and 0.2 GB of output.  The lookup
// loop is 5 instructions a lookup (code byte out of its word, scaled add,
// 2-byte load, shift, add; lookup_chunk forms the addresses by hand to keep
// it so).  ~1.6 ms on an H100 80GB HBM3 at 700 W (the first-slice kernel
// 4.6 ms); the lookups alone and the staging alone each take most of that
// (tools/kernel_variants.py: pq_no_stage, pq_no_lookup), so the two overlap
// only in part: the producer warps share their schedulers with sixteen
// consumer warps that are always ready to issue, which is why there are
// eight of them (four: ~1.7 ms) and their copies are unrolled at fixed
// offsets.  PERF.md has the times and the other designs that were
// measured.

#include <cuda_bf16.h>

#include "hopper_common.cuh"

// bytes of one slot's table chunk in a stage (sets MC, the subspaces a chunk)
#ifndef FPV_PQ_CHUNK_BYTES
#define FPV_PQ_CHUNK_BYTES 2048
#endif
// the narrowest tail tile (8, 16 or 32 slots)
#ifndef FPV_PQ_MIN_W
#define FPV_PQ_MIN_W 8
#endif
// the three below only for tools/kernel_variants.py: pad each slot's chunk
// to an odd number of bank words (0: without); FPV_PQ_NO_LOOKUP adds the code
// instead of the table entry; FPV_PQ_NO_STAGE never copies the tables
#ifndef FPV_PQ_PAD
#define FPV_PQ_PAD 1
#endif

namespace {

using namespace fpv;

constexpr int NW = 16;                 // consumer warps
constexpr int CONSUMERS = NW * 32;
// producer warps (4 or 8): eight get the staging twice the issue slots
// beside the consumers
#ifndef FPV_PQ_PRODUCER_WARPS
#define FPV_PQ_PRODUCER_WARPS 8
#endif
constexpr int PW = FPV_PQ_PRODUCER_WARPS;
constexpr int PRODUCERS = 32 * PW;
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers a thread: what the block is launched with, and after setmaxnreg
// the producers' and the consumers' shares of that pool
constexpr int kLaunchRegs = 65536 / THREADS / 8 * 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs =
    (THREADS * kLaunchRegs - PRODUCERS * kProducerRegs) / CONSUMERS / 8 * 8;
static_assert(CONSUMERS % 128 == 0 && PRODUCERS % 128 == 0,
              "setmaxnreg is a warpgroup's");
static_assert(kConsumerRegs <= 232 && kConsumerRegs >= kLaunchRegs, "pool");
constexpr int SLOTS = 32;              // slots a tile at most: a lane each
constexpr int HEAD = 512;              // barriers and the producers' tile box
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;       // what a block may opt in to
constexpr int HDR = 16;                // a stage's header: the tile's id

struct Params {
  const int* cell_ids;             // (U + 1,)
  const __nv_bfloat16* lut;        // (B, M * K)
  const int* qslot;                // (U, qcap), -1 = empty
  const unsigned char* codes_t;    // (nlist, M, cmax)
  float* out;                      // (U, qcap, cmax)
  int* scratch;                    // [n tiles, next tile, -, -, tiles (int4)...]
  int qcap, cmax, M, K;
  int MC;                          // subspaces a chunk
  int stages, stage_bytes, pitch;  // the ring; bytes from slot to slot
  int async;                       // copies go by cp.async
  int vec;                         // 16-byte stores of the sums
};

// the tail tiles of a row's `r` (< 32) remaining slots, widths and live
// counts: the narrowest width that holds r if r fills three quarters of it
// (or nothing narrower is allowed), else a full tile of half that width
// and the rest again
constexpr int MAX_TAIL = 4;
__device__ __forceinline__ int tail_tiles(int r, int minw, int (&w)[MAX_TAIL],
                                          int (&n)[MAX_TAIL]) {
  int cnt = 0;
  while (r > 0) {
    int width = minw;
    while (width < r) width *= 2;
    if (4 * r >= 3 * width || width == minw) {
      w[cnt] = width, n[cnt] = r, ++cnt;
      break;
    }
    w[cnt] = width / 2, n[cnt] = width / 2, ++cnt;
    r -= width / 2;
  }
  return cnt;
}

// One warp a compact slot: the row's load, then its tiles appended to the
// list (u, first slot, live | width << 8, first cell row).
__global__ void plan_kernel(const int* __restrict__ cell_ids,
                            const int* __restrict__ qslot, int* scratch,
                            int U, int qcap, int cmax, int CT, int minw) {
  const int u = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (u >= U || u >= __ldg(cell_ids)) return;   // the padding tail
  int last = -1;
  for (int i = lane; i < qcap; i += 32)
    if (__ldg(qslot + (size_t)u * qcap + i) >= 0) last = i;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if (lane != 0 || last < 0) return;
  const int load = last + 1;
  int tw[MAX_TAIL], tn[MAX_TAIL];
  const int nfull = load / 32;
  const int ntail = tail_tiles(load % 32, minw, tw, tn);
  const int ctiles = (cmax + CT - 1) / CT;
  const int base = atomicAdd(scratch, (nfull + ntail) * ctiles);
  int4* tiles = reinterpret_cast<int4*>(scratch + 4) + base;
  for (int c = 0; c < ctiles; ++c) {
    for (int f = 0; f < nfull; ++f)
      *tiles++ = make_int4(u, 32 * f, 32 | (32 << 8), c * CT);
    for (int f = 0, s0 = 32 * nfull; f < ntail; s0 += tw[f], ++f)
      *tiles++ = make_int4(u, s0, tn[f] | (tw[f] << 8), c * CT);
  }
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// One staged chunk for one lane: its slot's table at shared-memory address
// `tab`, the code bytes of its R = RPT * W / 32 rows at `cod` ([mc][NW *
// RPT]); adds each row's entry of each of the mc subspaces, in order, to
// acc[0 .. R).  The addresses are formed in 32 bits by hand (one byte
// extraction and one scaled add a lookup): left to the compiler, the
// generic pointers cost three more integer instructions a lookup, on the
// pipe that sets the kernel's pace.
template <int RPT, int W>
__device__ __forceinline__ void lookup_chunk(float (&acc)[RPT], uint32_t tab,
                                             uint32_t cod, int mc, int K) {
  constexpr int R = RPT * W / 32;
  static_assert(R % 4 == 0 && R > 0, "four rows a code read");
  for (int j = 0; j < mc; ++j) {
    uint32_t tj = tab + j * K * 2;
    const uint32_t cj = cod + j * (NW * RPT);
    // one register a subspace: not re-associated into every lookup's address
    asm volatile("" : "+r"(tj));
#pragma unroll
    for (int j4 = 0; j4 < R / 4; ++j4) {
      const uint32_t cw = lds_u32(cj + 4 * j4);   // four rows' codes, broadcast
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t code = __byte_perm(cw, 0u, 0x4440u | b);
#ifndef FPV_PQ_NO_LOOKUP
        const uint32_t e = lds_u16(tj + 2 * code);
#else
        const uint32_t e = code;
#endif
        acc[4 * j4 + b] =
            __fadd_rn(acc[4 * j4 + b], __uint_as_float(e << 16));
      }
    }
  }
}

template <int RPT>
__global__ void __launch_bounds__(THREADS, 1) pq_kernel(const Params p) {
  constexpr int CT = NW * RPT;         // cell rows a tile
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  int* tilebox = reinterpret_cast<int*>(smem + 2 * MAX_STAGES * 8);
  uint8_t* ring = smem + HEAD;
  const int tid = threadIdx.x;
  const int4* tiles = reinterpret_cast<const int4*>(p.scratch + 4);
  const int tab_off = HDR, codes_off = HDR + SLOTS * p.pitch;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], PRODUCERS + 1);   // the producers + the header
      mbar_init(&empty[s], NW);             // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;

  if (tid >= CONSUMERS) {
    // ---- producers: warp pw stages slots pw, pw + PW, ... ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - CONSUMERS, pw = pt / 32, lane = pt % 32;
    const int total = *reinterpret_cast<volatile int*>(p.scratch);
    for (int turn = 0;; turn ^= 1) {
      if (pt == 0) tilebox[turn] = atomicAdd(p.scratch + 1, 1);
      named_sync(1, PRODUCERS);
      const int ti = tilebox[turn];
      if (ti >= total) break;
      const int4 tl = __ldg(tiles + ti);
      const int u = tl.x, s0 = tl.y, n = tl.z & 0xFF, c0 = tl.w;
      const int cell = __ldg(p.cell_ids + 1 + u);
      int qv = -1;   // lane l < SLOTS / PW: the query of slot pw + PW l
      if (lane < SLOTS / PW && pw + PW * lane < n)
        qv = __ldg(p.qslot + (size_t)u * p.qcap + s0 + pw + PW * lane);
      for (int m0 = 0; m0 < p.M; m0 += p.MC) {
        const int mc = min(p.MC, p.M - m0);
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * p.stage_bytes;
        if (pt == 0) *reinterpret_cast<int*>(st) = ti;
#pragma unroll
        for (int k = 0; k < SLOTS / PW; ++k) {
          const int q = __shfl_sync(0xffffffffu, qv, k);
          if (q < 0) continue;
#ifdef FPV_PQ_NO_STAGE   // (tools/kernel_variants.py: the lookups alone)
          continue;
#endif
          const __nv_bfloat16* src = p.lut + ((size_t)q * p.M + m0) * p.K;
          uint8_t* dst = st + tab_off + (pw + PW * k) * p.pitch;
          if (p.async) {
            // eight copies an iteration at fixed offsets: the producers
            // get few issue slots beside the consumers, so no address
            // arithmetic between the copies
            const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
            const int words = mc * p.K / 2;
            int i = lane;
            for (; i + 7 * 32 < words; i += 8 * 32) {
#pragma unroll
              for (int r = 0; r < 8; ++r)
                cp_async4(dst + 4 * (i + 32 * r), s4 + i + 32 * r);
            }
            for (; i < words; i += 32) cp_async4(dst + 4 * i, s4 + i);
          } else {
            for (int i = lane; i < mc * p.K; i += 32)
              reinterpret_cast<__nv_bfloat16*>(dst)[i] = src[i];
          }
        }
        // the chunk's code bytes of this cmax tile, zero past cmax
        const unsigned char* cb =
            p.codes_t + ((size_t)cell * p.M + m0) * p.cmax + c0;
        uint8_t* cd = st + codes_off;
        if (p.async) {
          for (int i = pt; i < mc * (CT / 4); i += PRODUCERS) {
            const int j = i / (CT / 4), c = i % (CT / 4) * 4;
            const bool ok = c0 + c < p.cmax;
            cp_async4(cd + j * CT + c, ok ? cb + (size_t)j * p.cmax + c : cb,
                      ok ? 4 : 0);
          }
          mbar_arrive_cp_async(&full[stage]);
        } else {
          for (int i = pt; i < mc * CT; i += PRODUCERS) {
            const int j = i / CT, c = i % CT;
            cd[i] = c0 + c < p.cmax ? __ldg(cb + (size_t)j * p.cmax + c)
                                    : (unsigned char)0;
          }
          mbar_arrive(&full[stage]);
        }
        if (pt == 0) mbar_arrive(&full[stage]);   // the header is written
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // the list is exhausted: a stage whose header says so
    mbar_wait(&empty[stage], phase ^ 1);
    if (pt == 0) {
      *reinterpret_cast<int*>(ring + stage * p.stage_bytes) = -1;
      mbar_arrive(&full[stage]);
    }
    mbar_arrive(&full[stage]);
    return;
  }

  // ---- consumers: 16 warps, RPT cell rows of every tile each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // the warp's index, in a form the compiler knows to be the same for all
  // its lanes
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  float acc[RPT];
  for (;;) {
    mbar_wait(&full[stage], phase);
    const int ti = *reinterpret_cast<const int*>(ring + stage * p.stage_bytes);
    if (ti < 0) break;
    const int4 tl = __ldg(tiles + ti);
    const int u = tl.x, s0 = tl.y, n = tl.z & 0xFF, W = tl.z >> 8, c0 = tl.w;
    // lane = (row group, slot): W slots, 32 / W row groups of R rows
    const int s = lane & (W - 1);
    const int R = RPT * W / 32;
    const int row0 = warp * RPT + (lane / W) * R;
    const bool live =
        s < n && __ldg(p.qslot + (size_t)u * p.qcap + s0 + s) >= 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;

    for (int m0 = 0; m0 < p.M; m0 += p.MC) {
      const int mc = min(p.MC, p.M - m0);
      if (m0 > 0) mbar_wait(&full[stage], phase);
      const uint8_t* st = ring + stage * p.stage_bytes;
      if (live) {
        const uint32_t tab = smem_u32(st) + tab_off + s * p.pitch;
        const uint32_t cod = smem_u32(st) + codes_off + row0;
        switch (W) {
          case 32: lookup_chunk<RPT, 32>(acc, tab, cod, mc, p.K); break;
          case 16: lookup_chunk<RPT, 16>(acc, tab, cod, mc, p.K); break;
          default: lookup_chunk<RPT, 8>(acc, tab, cod, mc, p.K); break;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (live) {
      float* dst = p.out + ((size_t)u * p.qcap + s0 + s) * p.cmax + c0 + row0;
#pragma unroll
      for (int j4 = 0; j4 < RPT / 4; ++j4) {
        if (4 * j4 >= R) continue;
        const int c = c0 + row0 + 4 * j4;
        if (p.vec && c + 4 <= p.cmax) {
          reinterpret_cast<float4*>(dst)[j4] = make_float4(
              acc[4 * j4], acc[4 * j4 + 1], acc[4 * j4 + 2], acc[4 * j4 + 3]);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c + b < p.cmax) dst[4 * j4 + b] = acc[4 * j4 + b];
        }
      }
    }
  }
}

template <int RPT>
int run(const Params& p, int U, cudaStream_t st) {
  const int bytes = HEAD + p.stages * p.stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      pq_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return int(e);
  e = cudaMemsetAsync(p.scratch, 0, 16, st);
  if (e != cudaSuccess) return int(e);
  plan_kernel<<<(U + 7) / 8, 256, 0, st>>>(p.cell_ids, p.qslot, p.scratch, U,
                                           p.qcap, p.cmax, NW * RPT, FPV_PQ_MIN_W);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  pq_kernel<RPT><<<sms, THREADS, bytes, st>>>(p);   // persistent blocks
  return int(cudaGetLastError());
}

// cell rows a consumer warp sums in registers, by cmax
inline int rows_per_warp(int cmax) {
  return cmax <= NW * 16 ? 16 : cmax <= NW * 32 ? 32 : 48;
}

}  // namespace

extern "C" {

// The ints of scratch that fpv_grouped_cell_scores_pq needs for this shape:
// two counters and the tile list (at most qcap / 32 + 4 tiles a compact slot
// and cmax tile, four ints each).
// -1: too many for an int.
int fpv_grouped_cell_scores_pq_scratch(int U, int qcap, int cmax) {
  const int ct = NW * rows_per_warp(cmax);
  const long long n =
      4 + 4LL * U * (qcap / 32 + MAX_TAIL) * ((cmax + ct - 1) / ct);
  return n > 0x7FFFFFFFLL ? -1 : int(n);
}

// cell_ids (U+1,) i32 [n_uniq, compact -> cell ids...]; lut (B, M*K) bf16;
// qslot (U, qcap) i32 query per slot, -1 = empty; codes_t (nlist, M, cmax)
// u8; out (U, qcap, cmax) f32; scratch: i32, 16-byte aligned, at least
// fpv_grouped_cell_scores_pq_scratch(U, qcap, cmax) ints (uninitialised).
// Returns cudaGetLastError().
int fpv_grouped_cell_scores_pq(const void* cell_ids, const void* lut,
                               const void* qslot, const void* codes_t,
                               void* out, int U, int qcap, int cmax, int M,
                               int K, void* scratch, void* stream) {
  if (U <= 0 || qcap <= 0 || cmax <= 0) return int(cudaGetLastError());
  if (M <= 0 || K <= 0 || K > 256 || scratch == nullptr ||
      (reinterpret_cast<uintptr_t>(scratch) % 16) != 0)
    return int(cudaErrorInvalidValue);
  const int rpt = rows_per_warp(cmax);
  Params p;
  p.cell_ids = (const int*)cell_ids;
  p.lut = (const __nv_bfloat16*)lut;
  p.qslot = (const int*)qslot;
  p.codes_t = (const unsigned char*)codes_t;
  p.out = (float*)out;
  p.scratch = (int*)scratch;
  p.qcap = qcap;
  p.cmax = cmax;
  p.M = M;
  p.K = K;
  p.MC = max(1, min(M, FPV_PQ_CHUNK_BYTES / (2 * K)));
  // a slot's chunk, padded to an odd number of 4-byte bank words
  p.pitch = (p.MC * K * 2 + 3) / 4 * 4;
  if (FPV_PQ_PAD && (p.pitch / 4) % 2 == 0) p.pitch += 4;
  p.stage_bytes = (HDR + SLOTS * p.pitch + p.MC * NW * rpt + 15) / 16 * 16;
  p.stages = min(MAX_STAGES, (SMEM_MAX - HEAD) / p.stage_bytes);
  if (p.stages < 2) return int(cudaErrorInvalidValue);
  p.async = (K % 2) == 0 && (cmax % 4) == 0 &&
            (reinterpret_cast<uintptr_t>(lut) % 4) == 0 &&
            (reinterpret_cast<uintptr_t>(codes_t) % 4) == 0;
  p.vec = (cmax % 4) == 0 && (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rpt) {
    case 16: return run<16>(p, U, st);
    case 32: return run<32>(p, U, st);
    default: return run<48>(p, U, st);
  }
}

}  // extern "C"
