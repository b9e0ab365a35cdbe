// The graph index's beam search for Hopper (sm_90a): every round of a
// search in one launch, one thread block a query.
//
// Replaces no Pallas kernel.  The JAX package runs these rounds as a
// `lax.scan` of XLA ops (fastpyvectordb_tpu/ann/graph_ann.py,
// _beam_search_kernel); the port ran them as a Python loop of ~59 small
// PyTorch launches a round, which left the card idle ~93% of a one-query
// call while the host launched them.  The plain version of the same rounds
// is kernels/graph_kernels.py:graph_beam_plain.
//
// What it computes, for query b (block b): the beam after T rounds.
//   init   the e0 routed entry points (ids from the wrapper's routing),
//          scored where live, MASKED where not; W - e0 empty slots (-1).
//   round  pick the E best unexpanded entries (ties to the lower beam
//          position) and mark them expanded; gather their neighbour lists
//          (E x R ids, -1 for tombstoned targets and for picks that were
//          empty slots) and score them; sort the W + E*R entries by the
//          composite key 2 * id + !expanded (entries that are not real last,
//          in position order), so the first copy of an id, an expanded copy
//          before others, survives and the later copies score MASKED; keep
//          the best W by (score, id-sorted position); an entry scoring
//          >= MASKED / 2 becomes -1.
// Scores are the norm expansion of graph_ann._scores_vs_rows: the row's
// squared norm from the stored values and the cross term from compute-dtype
// operands, both summed in f32, then 1 - cross * qinv * rinv (cosine),
// max(qsq + vsq - 2 cross, 0) (l2) or -cross (dot).  Every ordering is by
// unique 64-bit keys (the value, then the position), so it is the stable
// order of the plain version's sorts; given equal scores the kernel takes
// the plain version's trajectory bit for bit.  Scores compare as 32-bit
// keys with NaN after +inf and -0 equal to +0, as torch's sorts do.
//
// What bounds it: the T dependent rounds.  A round's E*R rows (at the
// graph-b1 cell, 256 rows of 3 KB) are known only once the previous round
// has ordered its entries, so one query runs on one SM and leaves the
// card's bandwidth idle.  The bytes bound, (e0 + T*E*R) * D * itemsize at
// 3.35 TB/s, is ~2 us at that cell; on an H100 the kernel takes ~0.2 ms
// there, of which the row loads are ~0.03 ms and the rest the block's own
// work a round (scoring, three orderings, its barriers).  At B = 1,024 the
// blocks fill the card and the row reads bound it (PERF.md, B10).
//
// What the design does about it: each warp scores whole rows, ROWS rows at
// once with CHUNKS 16-byte loads a lane issued before any is summed, so a
// warp keeps ROWS x CHUNKS loads in flight; the row's squared norm and the
// cross term come from the same registers, so each gathered row is read
// once (the plain version reads it twice: one product for the norms, one
// for the cross term).  Everything else lives in shared memory: the beam,
// the merged entries and their keys, and the query (f32, or bf16-rounded
// for bf16 compute) where it fits beside them; a query too wide for what is
// left of the block's shared memory is read from global memory (its L1
// lines) and rounded as it is read.  Up to 2 x THREADS keys, each ordering
// is a rank pass (every thread counts the keys below each of its own, all
// compares independent) with no barrier inside: bitonic sorts of
// next_pow2(W + E*R) keys, ~45 dependent stages each, took ~40% of the
// kernel's time at the cell (0.31 ms a call with them, 0.28 with rank
// passes, both at 256 threads).  Past that a rank pass's O(n^2) compares
// cost more than a bitonic sort's O(n log^2 n) and its barriers (at W
// 4,096 on an H100: 21.6 ms a B = 1 search with rank passes), so wider
// orderings sort.  512 threads a block: at B = 1 more warps score and rank
// at once (0.21 ms); at B = 1,024 that costs ~10% against two blocks of
// 256 an SM.  The kernel allocates nothing,
// synchronises nothing with the host and uses no atomics; the wrapper
// allocates the outputs.  Rows whose byte width or base is not a multiple
// of 16 take the same loop with scalar loads.  Rows are f32, bf16 or f16
// (a 16-bit row unpacks to exact f32 values).
//
// The shapes it takes: W + E*R <= MAX_ENTRIES (5,120: a beam widened to
// 4,096 for k up to 4,096, with E*R up to 1,024; the arrays then take
// ~190 KB of the 227 KB a block may have) and E <= W; any B, D and metric.
// The wrapper refuses a search past the rule.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 2;                // rows a warp scores at once
constexpr int CHUNKS = 8;              // loads a lane issues a row, then sums
constexpr int MAX_ENTRIES = 5120;      // W + E*R, held by the wrapper
constexpr int POS_BITS = 13;           // entry positions < 8192
constexpr unsigned long long POS_MASK = (1ull << POS_BITS) - 1;
constexpr int RANKED = 2 * THREADS;    // orderings up to this many keys rank
constexpr unsigned long long PAD = ~0ull;  // sorts after every real key
constexpr float MASKED = 3.0e38f;          // kernels/distances.py MASKED
constexpr float HALF = MASKED * 0.5f;

enum Metric { COSINE = 0, L2 = 1, DOT = 2 };
enum Store { F32 = 0, BF16 = 1, F16 = 2 };   // the rows' dtype

struct Args {
  const float* q;                 // (B, D)
  const void* vectors;            // (cap, D) f32, bf16 or f16
  const int* nbr;                 // (N, R), tombstoned targets -1
  const int* init_ids;            // (B, e0)
  const unsigned char* init_ok;   // (B, e0)
  int* out_ids;                   // (B, W)
  float* out_scores;              // (B, W)
  int D, N, R, e0, W, E, T, metric;
  int P;                          // W + E*R rounded up to even
  int K;                          // keys: P, or next_pow2(P) past RANKED
};

// Shared memory: byte offsets of each array, 16-byte aligned; the total.
enum { KEYS, PERM, E_ID, E_SC, S_SC, B_ID, B_SC, X_ID, QV, RED, E_EX, B_EX,
       NOFF };

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// qd: the query's elements in shared memory (D, or 0 where it is read
// from global memory).
__host__ __device__ inline size_t layout(int P, int K, int W, int E, int qd,
                                         size_t* off) {
  const size_t sizes[NOFF] = {
      8 * size_t(K),                                // keys
      4 * size_t(P),                                // perm
      4 * size_t(P), 4 * size_t(P), 4 * size_t(P),  // e_id, e_sc, s_sc
      4 * size_t(W), 4 * size_t(W),                 // b_id, b_sc
      4 * size_t(E > 0 ? E : 1),                    // x_id
      4 * size_t(qd),                               // the query operand
      4 * size_t(WARPS + 1),                        // reduction
      size_t(P), size_t(W)};                        // e_ex, b_ex
  size_t o = 0;
  for (int i = 0; i < NOFF; ++i) {
    off[i] = o;
    o += up16(sizes[i]);
  }
  return o;
}

// A score as an unsigned key in float order: NaN after +inf, -0 as +0.
__device__ __forceinline__ unsigned int ord(float s) {
  unsigned int u = __float_as_uint(s);
  if (s != s) return 0xffffffffu;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The rank of each of the n unique keys k[0..n) among them, the place a
// sort would give it: each thread compares its keys (i = tid, tid +
// THREADS, ...) with all n, two at a time and each read a broadcast, and
// calls f(i, rank).  k[n] is PAD where n is odd.  Every compare is
// independent, so the pass runs at the issue rate with no barrier inside.
template <int NK, class F>
__device__ __forceinline__ void rank_pass(const unsigned long long* k, int n,
                                          F&& f) {
  unsigned long long mine[NK];
  int r[NK];
#pragma unroll
  for (int m = 0; m < NK; ++m) {
    const int i = threadIdx.x + m * THREADS;
    mine[m] = i < n ? k[i] : 0ull;
    r[m] = 0;
  }
  const ulonglong2* k2 = reinterpret_cast<const ulonglong2*>(k);
#pragma unroll 4
  for (int j = 0; j < (n + 1) >> 1; ++j) {
    const ulonglong2 kk = k2[j];
#pragma unroll
    for (int m = 0; m < NK; ++m)
      r[m] += static_cast<int>(kk.x < mine[m]) +
              static_cast<int>(kk.y < mine[m]);
  }
#pragma unroll
  for (int m = 0; m < NK; ++m) {
    const int i = threadIdx.x + m * THREADS;
    if (i < n) f(i, r[m]);
  }
}

// An ascending bitonic sort of k[0..n2), n2 a power of two, by the block.
__device__ void bitonic(unsigned long long* k, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n2 >> 1); t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = k[lo], y = k[hi];
        if ((x > y) == ((lo & size) == 0)) {
          k[lo] = y;
          k[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The order of the n unique keys k[0..n) (k[n] is PAD where n is odd):
// f(i, rank) for each i.  Up to RANKED keys by a rank pass, which leaves k
// as it was; past it by sorting k[0..next_pow2(n)) in place (the position
// rides in the low POS_BITS of every key).  Every thread of the block
// calls it with the same n.
template <class F>
__device__ __forceinline__ void order(unsigned long long* k, int n, F&& f) {
  if (n <= THREADS) {
    rank_pass<1>(k, n, f);
  } else if (n <= RANKED) {
    rank_pass<2>(k, n, f);
  } else {
    const int n2 = 1 << (32 - __clz(n - 1));
    for (int i = n + threadIdx.x; i < n2; i += THREADS) k[i] = PAD;
    __syncthreads();
    bitonic(k, n2);
    for (int r = threadIdx.x; r < n; r += THREADS)
      f(static_cast<int>(k[r] & POS_MASK), r);
  }
}

__device__ __forceinline__ float finish(int metric, float vsq, float cross,
                                        float qsq, float qinv) {
  if (metric == COSINE) {
    const float rinv = rsqrtf(vsq < 1e-30f ? 1e-30f : vsq);
    return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(cross, qinv), rinv));
  }
  if (metric == L2) {
    const float x = __fsub_rn(__fadd_rn(qsq, vsq), __fmul_rn(2.0f, cross));
    return x < 0.0f ? 0.0f : x;
  }
  return -cross;
}

// A 16-bit stored value (bf16 or f16) as its exact f32 value.
template <int S>
__device__ __forceinline__ float widen(unsigned int h) {
  if constexpr (S == BF16)
    return __uint_as_float(h << 16);
  else
    return __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
}

// Element e of a stored row as f32 (scalar loads).
template <int S>
__device__ __forceinline__ float load1(const void* v, size_t e) {
  if constexpr (S == F32)
    return __ldg(static_cast<const float*>(v) + e);
  else
    return widen<S>(__ldg(static_cast<const unsigned short*>(v) + e));
}

// The 16 bytes at element e (a multiple of 16 / itemsize) as f32 values.
template <int S>
__device__ __forceinline__ uint4 load16(const void* v, size_t e) {
  const char* p = static_cast<const char*>(v) + e * (S == F32 ? 4 : 2);
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int S>
__device__ __forceinline__ void unpack(const uint4& u, float* x) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (S == F32) {
      x[i] = __uint_as_float(w[i]);
    } else {
      x[2 * i] = widen<S>(w[i] & 0xffffu);
      x[2 * i + 1] = widen<S>(w[i] >> 16);
    }
  }
}

// Element i of the query operand: from shared memory, already rounded
// (QS), or from global memory, rounded here for bf16 compute.
template <bool QS, bool CBF>
__device__ __forceinline__ float qget(const float* qv, int i) {
  if constexpr (QS)
    return qv[i];
  else
    return CBF ? bf16_round(__ldg(qv + i)) : __ldg(qv + i);
}

// Scores of the n rows ids[0..n) (shared) into out[0..n) (shared): a warp
// scores ROWS rows at once, whole; a row is live where its id is >= 0 and,
// with ok (global), ok[i] is set; others score MASKED and are not read.
template <int S, bool CBF, bool WIDE, bool QS>
__device__ void score_rows(const Args& a, const float* qv, float qsq,
                           float qinv, const int* ids,
                           const unsigned char* ok, float* out, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = WIDE ? (S == F32 ? 4 : 8) : 1;  // elements a load
  constexpr int STEP = 32 * V;                  // elements a warp load
  const int D = a.D;
  for (int base = warp * ROWS; base < n; base += WARPS * ROWS) {
    size_t row[ROWS];
    bool live[ROWS];
    float vsq[ROWS], cross[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = base + r;
      const int id = i < n ? ids[i] : -1;
      live[r] = id >= 0 && (ok == nullptr || ok[i]);
      row[r] = static_cast<size_t>(id < 0 ? 0 : id) * D;
      vsq[r] = 0.0f;
      cross[r] = 0.0f;
    }
    for (int c0 = lane * V; c0 < D; c0 += STEP * CHUNKS) {
      if constexpr (WIDE) {
        uint4 buf[ROWS][CHUNKS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const int c = c0 + k * STEP;
            buf[r][k] = (live[r] && c < D) ? load16<S>(a.vectors, row[r] + c)
                                           : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const int c = c0 + k * STEP;
            if (!live[r] || c >= D) continue;
            float x[V];
            unpack<S>(buf[r][k], x);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              vsq[r] = fmaf(x[v], x[v], vsq[r]);
              const float xc = (CBF && S != BF16) ? bf16_round(x[v]) : x[v];
              cross[r] = fmaf(qget<QS, CBF>(qv, c + v), xc, cross[r]);
            }
          }
      } else {
        float buf[ROWS][CHUNKS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const int c = c0 + k * STEP;
            buf[r][k] = (live[r] && c < D) ? load1<S>(a.vectors, row[r] + c)
                                           : 0.0f;
          }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k) {
            const int c = c0 + k * STEP;
            if (!live[r] || c >= D) continue;
            const float x = buf[r][k];
            vsq[r] = fmaf(x, x, vsq[r]);
            const float xc = (CBF && S != BF16) ? bf16_round(x) : x;
            cross[r] = fmaf(qget<QS, CBF>(qv, c), xc, cross[r]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = warp_sum(vsq[r]);
      const float c = warp_sum(cross[r]);
      if (lane == 0 && base + r < n)
        out[base + r] = live[r] ? finish(a.metric, s, c, qsq, qinv) : MASKED;
    }
  }
}

template <int S, bool CBF, bool WIDE, bool QS>
__global__ void __launch_bounds__(THREADS) beam_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  size_t off[NOFF];
  layout(a.P, a.K, a.W, a.E, QS ? a.D : 0, off);
  auto* keys = reinterpret_cast<unsigned long long*>(smem + off[KEYS]);
  int* perm = reinterpret_cast<int*>(smem + off[PERM]);
  int* e_id = reinterpret_cast<int*>(smem + off[E_ID]);
  float* e_sc = reinterpret_cast<float*>(smem + off[E_SC]);
  float* s_sc = reinterpret_cast<float*>(smem + off[S_SC]);
  int* b_id = reinterpret_cast<int*>(smem + off[B_ID]);
  float* b_sc = reinterpret_cast<float*>(smem + off[B_SC]);
  int* x_id = reinterpret_cast<int*>(smem + off[X_ID]);
  const float* qg = a.q + static_cast<size_t>(blockIdx.x) * a.D;
  float* qs = reinterpret_cast<float*>(smem + off[QV]);
  const float* qv = QS ? qs : qg;
  float* red = reinterpret_cast<float*>(smem + off[RED]);
  unsigned char* e_ex = smem + off[E_EX];
  unsigned char* b_ex = smem + off[B_EX];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int W = a.W, R = a.R, ER = a.E * a.R, M = W + ER;

  // the query operand (f32, or rounded to bf16) and its f32 squared norm
  float part = 0.0f;
  for (int d = tid; d < a.D; d += THREADS) {
    const float x = qg[d];
    if constexpr (QS) qs[d] = CBF ? bf16_round(x) : x;
    part = fmaf(x, x, part);
  }
  part = warp_sum(part);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += red[w];
    red[WARPS] = s;
  }
  __syncthreads();
  const float qsq = red[WARPS];
  const float qn = sqrtf(qsq);
  const float qinv = 1.0f / (qn < 1e-30f ? 1e-30f : qn);

  // the entry points, scored where live; empty slots after them
  for (int i = tid; i < W; i += THREADS) {
    b_id[i] = i < a.e0 ? a.init_ids[static_cast<size_t>(b) * a.e0 + i] : -1;
    b_sc[i] = MASKED;
    b_ex[i] = 0;
  }
  __syncthreads();
  score_rows<S, CBF, WIDE, QS>(a, qv, qsq, qinv, b_id,
                             a.init_ok + static_cast<size_t>(b) * a.e0, b_sc,
                             a.e0);
  __syncthreads();

  const unsigned long long invalid = 2ull * static_cast<unsigned>(a.N) + 2ull;
  for (int t = 0; t < a.T; ++t) {
    // the E best unexpanded entries, ties to the lower position
    for (int i = tid; i < W + (W & 1); i += THREADS) {
      unsigned long long k = PAD;
      if (i < W) {
        const float s = (b_ex[i] || b_id[i] < 0) ? MASKED : b_sc[i];
        k = (static_cast<unsigned long long>(ord(s)) << 32) | i;
      }
      keys[i] = k;
    }
    __syncthreads();
    order(keys, W, [&](int i, int r) {
      if (r < a.E) {
        x_id[r] = b_id[i];
        b_ex[i] = 1;
      }
    });
    __syncthreads();
    // the merged entries: the beam, then the picks' neighbour lists
    for (int i = tid; i < W; i += THREADS) {
      e_id[i] = b_id[i];
      e_sc[i] = b_sc[i];
      e_ex[i] = b_ex[i];
    }
    for (int c = tid; c < ER; c += THREADS) {
      const int x = x_id[c / R];
      e_id[W + c] = x < 0 ? -1 : a.nbr[static_cast<size_t>(x) * R + c % R];
      e_ex[W + c] = 0;
    }
    __syncthreads();
    score_rows<S, CBF, WIDE, QS>(a, qv, qsq, qinv, e_id + W, nullptr,
                                 e_sc + W, ER);
    __syncthreads();
    // by (2 id + !expanded, position); entries that are not real last
    for (int p = tid; p < a.P; p += THREADS) {
      unsigned long long k = PAD;
      if (p < M) {
        const int id = e_id[p];
        const unsigned long long ik =
            (id >= 0 && e_sc[p] < HALF)
                ? 2ull * static_cast<unsigned>(id) + (e_ex[p] ? 0ull : 1ull)
                : invalid;
        k = (ik << POS_BITS) | p;
      }
      keys[p] = k;
    }
    __syncthreads();
    order(keys, M, [&](int p, int r) { perm[r] = p; });
    __syncthreads();
    // later copies of an id score MASKED; then by (score, id-sorted place)
    for (int j = tid; j < a.P; j += THREADS) {
      unsigned long long k = PAD;
      if (j < M) {
        const int o = perm[j];
        const bool dup = j > 0 && e_id[o] == e_id[perm[j - 1]];
        const float s = dup ? MASKED : e_sc[o];
        s_sc[j] = s;
        k = (static_cast<unsigned long long>(ord(s)) << 32) | j;
      }
      keys[j] = k;
    }
    __syncthreads();
    // the best W
    order(keys, M, [&](int j, int r) {
      if (r < W) {
        const int o = perm[j];
        const float s = s_sc[j];
        b_id[r] = s >= HALF ? -1 : e_id[o];
        b_sc[r] = s;
        b_ex[r] = e_ex[o];
      }
    });
    __syncthreads();
  }
  for (int i = tid; i < W; i += THREADS) {
    a.out_ids[static_cast<size_t>(b) * W + i] = b_id[i];
    a.out_scores[static_cast<size_t>(b) * W + i] = b_sc[i];
  }
}

template <int S, bool CBF, bool WIDE, bool QS>
int launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  auto kernel = beam_kernel<S, CBF, WIDE, QS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The block's shared memory: the query in it where it fits beside the
// beam's arrays in what a block may opt in to (227 KB on an H100), else
// read from global memory.
template <int S, bool CBF>
int launch_rows(const Args& a, int B, cudaStream_t stream) {
  static int optin[64];   // per device; a device's limit never changes
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (optin[dev] == 0) {
    e = cudaDeviceGetAttribute(&optin[dev],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  size_t off[NOFF];
  const size_t with_q = layout(a.P, a.K, a.W, a.E, a.D, off);
  const size_t without_q = layout(a.P, a.K, a.W, a.E, 0, off);
  if (without_q > static_cast<size_t>(optin[dev]))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool qs = with_q <= static_cast<size_t>(optin[dev]);
  const bool wide =
      (static_cast<size_t>(a.D) * (S == F32 ? 4 : 2)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.vectors) % 16 == 0;
  if (qs)
    return wide ? launch<S, CBF, true, true>(a, B, with_q, stream)
                : launch<S, CBF, false, true>(a, B, with_q, stream);
  return wide ? launch<S, CBF, true, false>(a, B, without_q, stream)
              : launch<S, CBF, false, false>(a, B, without_q, stream);
}

}  // namespace

extern "C" {

// q (B, D) f32; vectors (cap, D) f32, bf16 or f16 (store 0 / 1 / 2); nbr (N, R)
// int32 with tombstoned targets -1; init_ids (B, e0) int32 and init_ok
// (B, e0) bool, the routed entry points and their liveness; out_ids (B, W)
// int32 and out_scores (B, W) f32, the beam after T rounds (ids -1 and
// scores MASKED where empty).  metric 0 cosine, 1 l2, 2 dot; compute_bf16
// rounds both operands of the cross term to bf16 (f32 sums).  The wrapper
// holds W + E*R <= 5120 and E <= W.  Returns a cudaError_t as int.
int fpv_graph_beam(const void* q, const void* vectors, const void* nbr,
                   const void* init_ids, const void* init_ok, void* out_ids,
                   void* out_scores, int B, int D, int N, int R, int e0, int W,
                   int E, int T, int metric, int store, int compute_bf16,
                   void* stream) {
  if (B <= 0) return 0;
  Args a;
  a.q = static_cast<const float*>(q);
  a.vectors = vectors;
  a.nbr = static_cast<const int*>(nbr);
  a.init_ids = static_cast<const int*>(init_ids);
  a.init_ok = static_cast<const unsigned char*>(init_ok);
  a.out_ids = static_cast<int*>(out_ids);
  a.out_scores = static_cast<float*>(out_scores);
  a.D = D;
  a.N = N;
  a.R = R;
  a.e0 = e0;
  a.W = W;
  a.E = E;
  a.T = T;
  a.metric = metric;
  a.P = (W + E * R + 1) & ~1;
  a.K = a.P;
  if (a.P > RANKED)
    while (a.K & (a.K - 1)) a.K += a.K & -a.K;   // the next power of two
  if (W < 1 || E < 0 || E > W || W + E * R > MAX_ENTRIES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store == BF16)
    return compute_bf16 ? launch_rows<BF16, true>(a, B, s)
                        : launch_rows<BF16, false>(a, B, s);
  if (store == F16)
    return compute_bf16 ? launch_rows<F16, true>(a, B, s)
                        : launch_rows<F16, false>(a, B, s);
  return compute_bf16 ? launch_rows<F32, true>(a, B, s)
                      : launch_rows<F32, false>(a, B, s);
}

}  // extern "C"
