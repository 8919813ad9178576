// Exact cosine top-k with the score matrix never written to device memory.
//
// Replaces the TPU kernel latice_tpu/ops/topk_fused.py:cosine_topk_fused
// (body _topk_kernel, merge _extract_topk_tile). Same contract: queries are
// L2-normalized here (zero rows stay zero), the dictionary is taken as
// normalized, scores are full FP32 FMA (never TF32), columns >= n_valid
// score -inf, and the output is the best k per row ordered by
// (score descending, index ascending), the stable order of lax.top_k.
//
// What bounds it on an H100: operations. At the serving shape (B=256,
// N=100k, D=16) the scores are 2*B*N*D = 0.82 GFLOP of FP32 CUDA-core work
// (~12 us at 67 TFLOP/s) against a 6.4 MB dictionary (~2 us at 3.35 TB/s).
// So every byte a warp reads from shared memory has to feed several FMAs,
// and the selection has to cost little beside the FMAs.
//
// Scoring: a block of 8 warps owns 8 * QW queries (QW = 1 or 4 per warp,
// chosen by the caller from B) and one split of the dictionary, which it
// streams through shared memory in tiles of 32 KB, two in a ring:
// cp.async fills the next tile while the warps score this one. A tile is
// row-major as in device memory, its 16-byte chunks XOR-swizzled so that
// the 8 lanes of a quarter-warp read 8 distinct bank groups. Each lane
// holds R = 64/DMAX rows in registers (64 floats), loaded once per step,
// and scores them against each of its warp's QW queries in turn, the
// normalized queries read from shared memory as broadcast float4 loads:
// one row load feeds QW queries. Each (row, query) score is one FMA chain
// over d = 0..D-1, in order, as in the plain dot product.
//
// Selection: each query has, in shared memory, a sorted list of its best
// 32 * KW candidates so far and a buffer of pending ones; the warp holds
// the query's threshold score (the list's k-th entry) in registers. A step
// first computes all QW * R scores with no branch between them, so the FMA
// chains of different queries interleave, then folds the compares with
// the thresholds into one bit mask per lane and ORs the masks across the
// warp. Only for the (query, row) pairs some lane took does the warp take
// the slow path: check each candidate exactly, append it to the buffer (a
// ballot gives each its slot), and once 32 are pending call one routine,
// shared by every query and not inlined, that sorts them with a warp-wide
// bitonic network and merges the sorted run into the list. A split's first
// step fills each list at once with its 32 lanes' best candidates, sorted
// by the same network. Candidates are ordered by (score desc, index asc)
// throughout, the counterpart of _extract_topk_tile.
//
// Splits: with few queries the dictionary is cut into splits across
// blockIdx.y so that every SM has work; each split writes its partial
// top-k and a second kernel merges them. A split's list alone would take
// in ~k * (1 + ln(rows / k)) candidates, and the splits' k-th scores are
// all about the same quantile, so a bar made of the highest of them drops
// little. Instead each query has 32 slots in device memory, and split s
// raises slot s % 32 to its best score so far (atomicMax of an
// order-preserving key), on its first step and again at steps 1, 2, 4,
// 8, ...; at those steps the query's threshold rises to the k-th highest
// slot. The 32 slots hold rows of disjoint sets of splits, so k rows reach
// that score and so does the query's k-th best. Candidates strictly below
// a threshold are dropped and ties stay, so (score, index) order still
// decides; the merge starts from the same bound over the final slots.
// Only rows that cannot be in the answer are dropped, so the result does
// not depend on the order of the atomics.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileFloats = 8192;  // one 32 KB tile of dictionary rows
constexpr int kPending = 64;       // a query's buffer: up to 31 waiting, one ballot's 32

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Strict order of candidates: higher score first, then lower index.
__device__ __forceinline__ bool better(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// An unsigned key of a score that orders as the scores do; key 0 (what a
// zeroed slot holds) decodes to NaN and so raises no threshold.
__device__ __forceinline__ unsigned score_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Where 16-byte chunk L of a tile is stored: its low 3 bits XORed with
// bits 4-6. A lane's R rows are 16 consecutive chunks (R * DMAX = 64
// floats), so lane l's chunks land in bank group (chunk ^ l) % 8, and a
// quarter-warp's 8 loads of one step hit 8 distinct groups.
__device__ __forceinline__ int swizzle(int L) { return L ^ ((L >> 4) & 7); }

// Asynchronous 16- and 4-byte copies into shared memory; a source size
// of 0 writes zeros.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 4 : 0));
  }
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying `rows` dictionary rows from t0 into a tile (chunks
// swizzled, rows past `rows` and dimensions past D zero) as one group.
template <int C, int TR>
__device__ __forceinline__ void load_tile(float4* tile, const float* dict, int t0, int rows, int D,
                                          int vec) {
  for (int L = threadIdx.x; L < TR * C; L += kWarps * 32) {
    const int r = L / C, c = L % C;
    const bool in = r < rows;
    const float* src = in ? dict + static_cast<long long>(t0 + r) * D : dict;
    float4* dst = tile + swizzle(L);
    if (vec) {
      cp_async(dst, src + (in ? 4 * c : 0), 16, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && 4 * c + e < D;
        cp_async(reinterpret_cast<float*>(dst) + e, ok ? src + 4 * c + e : dict, 4, ok);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Warp-wide bitonic networks over one (score, index) candidate per lane,
// in the order of `better`, best in lane 0.

// Exchange with lane ^ j, keeping the better of the pair iff keep_better.
__device__ __forceinline__ void exchange(float& v, int& i, int j, bool keep_better) {
  const float ov = __shfl_xor_sync(kFull, v, j);
  const int oi = __shfl_xor_sync(kFull, i, j);
  if (better(ov, oi, v, i) == keep_better) {
    v = ov;
    i = oi;
  }
}

// Sort a bitonic sequence (5 exchanges).
__device__ __forceinline__ void warp_bitonic_merge(float& v, int& i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) exchange(v, i, j, (lane & j) == 0);
}

// Sort any sequence (15 exchanges).
__device__ __forceinline__ void warp_sort(float& v, int& i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool best_first = (lane & size) == 0;  // runs of `size` alternate
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) exchange(v, i, j, ((lane & j) == 0) == best_first);
  }
}

// Sort one score per lane, highest in lane 0.
__device__ __forceinline__ float warp_sort_scores(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, j);
      v = (((lane & j) == 0) == ((lane & size) == 0)) ? fmaxf(v, o) : fminf(v, o);
    }
  }
  return v;
}

// A score the query's k-th best is known to reach, from its 32 slots of
// split bests (keys; 0 where none yet): the k-th highest slot. -inf where
// k > 32 or fewer than k slots are written.
__device__ __forceinline__ float tops_bound(const unsigned* tops, int k) {
  const int lane = threadIdx.x & 31;
  const float m = fmaxf(neg_inf(), key_score(__ldcg(tops + lane)));  // drops NaN
  return k <= 32 ? __shfl_sync(kFull, warp_sort_scores(m), k - 1) : neg_inf();
}

// a and b sorted: a becomes the best 32 of the 64, sorted; b the other 32,
// as a bitonic sequence.
__device__ __forceinline__ void warp_merge(float& av, int& ai, float& bv, int& bi) {
  const int lane = threadIdx.x & 31;
  const float rv = __shfl_sync(kFull, bv, 31 - lane);
  const int ri = __shfl_sync(kFull, bi, 31 - lane);
  if (better(rv, ri, av, ai)) {
    bv = av;
    bi = ai;
    av = rv;
    ai = ri;
  } else {
    bv = rv;
    bi = ri;
  }
  warp_bitonic_merge(av, ai);
}

struct Threshold {
  float v;
  int i;
};

// One query's selection state in shared memory: its sorted list of 32 * KW
// entries and its buffer of kPending candidates, scores then indices, and
// meta = {the index half of its threshold, the count pending}.
template <int KW>
struct Sel {
  static constexpr int kEntries = 32 * KW + kPending;
  float* v;
  int* i;
  int* meta;
  __device__ __forceinline__ Sel(float* sv, int* si, int* sm, int slot)
      : v(sv + slot * kEntries), i(si + slot * kEntries), meta(sm + 2 * slot) {}
  __device__ __forceinline__ float* pend_v() const { return v + 32 * KW; }
  __device__ __forceinline__ int* pend_i() const { return i + 32 * KW; }

  __device__ __forceinline__ void init() const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      v[32 * w + lane] = neg_inf();
      i[32 * w + lane] = INT_MAX;
    }
    if (lane == 0) {
      meta[0] = INT_MAX;
      meta[1] = 0;
    }
  }

  // Append each lane's candidate where take (m = the warp's ballot of
  // take) behind the n pending ones.
  __device__ __forceinline__ void append(float s, int idx, bool take, unsigned m, int n) const {
    if (take) {
      const int at = n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
      pend_v()[at] = s;
      pend_i()[at] = idx;
    }
  }

  template <typename IdxT>
  __device__ __forceinline__ void store(float* out_v, IdxT* out_i, int k) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int p = 32 * w + lane;
      if (p < k) {
        out_v[p] = v[p];
        out_i[p] = static_cast<IdxT>(i[p]);
      }
    }
  }
};

// Merge the n pending candidates of one query's Sel into its list, 32 at a
// time (sort, then merge the sorted run). Returns the new threshold: the
// list's k-th entry, or the old threshold where that is higher (a bound).
// Called by the whole warp; not inlined, so the scoring loop keeps one
// short call per query in place of the networks.
template <int KW>
__device__ __noinline__ Threshold flush(float* sv, int* si, int n, int k, Threshold old) {
  const int lane = threadIdx.x & 31;
  float* pv = sv + 32 * KW;
  int* pi = si + 32 * KW;
  __syncwarp();
  for (int c0 = 0; c0 < n; c0 += 32) {
    const bool in = c0 + lane < n;
    float cv = in ? pv[c0 + lane] : neg_inf();
    int ci = in ? pi[c0 + lane] : INT_MAX;
    warp_sort(cv, ci);
#pragma unroll
    for (int w = 0; w < KW; ++w) {  // slot 0 keeps the best 32; the rest meet slot 1
      if (w > 0) warp_bitonic_merge(cv, ci);
      float av = sv[32 * w + lane];
      int ai = si[32 * w + lane];
      warp_merge(av, ai, cv, ci);
      sv[32 * w + lane] = av;
      si[32 * w + lane] = ai;
    }
  }
  __syncwarp();
  const Threshold t{sv[k - 1], si[k - 1]};
  return better(t.v, t.i, old.v, old.i) ? t : old;
}

// grid: (ceil(B / (kWarps * QW)), splits). Split s scores rows
// [s * N / splits, (s + 1) * N / splits) and writes each query's best k to
// out[(b * splits + s) * k ...] as int32 (splits > 1) or int64 indices.
// vec: D == DMAX and the dictionary is 16-byte aligned, so rows load as
// float4; otherwise the tile's dimensions past D are zero-filled.
template <int DMAX, int KW, int QW>
__global__ void __launch_bounds__(kWarps * 32)
    topk_partial(const float* __restrict__ q, const float* __restrict__ dict, int B, int N, int D,
                 int k, int n_valid, int splits, int vec, unsigned* __restrict__ tops,
                 float* __restrict__ out_v, int* __restrict__ out_i32,
                 long long* __restrict__ out_i64) {
  constexpr int C = DMAX / 4;             // 16-byte chunks per row
  constexpr int R = 64 / DMAX;            // rows a lane holds per step
  constexpr int S = 32 * R;               // rows a warp scores per step
  constexpr int TR = kTileFloats / DMAX;  // rows per tile, a multiple of S
  extern __shared__ __align__(16) float4 smem[];
  float4* ring = smem;                               // two tiles
  float4* qs = smem + 2 * TR * C;                    // the block's normalized queries
  float* sel_v = reinterpret_cast<float*>(qs + kWarps * QW * C);  // each query's Sel
  int* sel_i = reinterpret_cast<int*>(sel_v + kWarps * QW * Sel<KW>::kEntries);
  int* sel_m = sel_i + kWarps * QW * Sel<KW>::kEntries;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qb = (blockIdx.x * kWarps + warp) * QW;  // the warp's first query
  const int split = blockIdx.y;
  const int n0 = static_cast<int>(static_cast<long long>(split) * N / splits);
  const int n1 = static_cast<int>(static_cast<long long>(split + 1) * N / splits);
  const bool active = qb < B;  // the same on all lanes of a warp

  // Normalize the warp's queries into shared memory (zero rows stay zero).
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    const int b = qb + j;
    const float* src = q + static_cast<long long>(b) * D;
    float x[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) x[d] = b < B && d < D ? src[d] : 0.f;
    float ss = 0.f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) ss = fmaf(x[d], x[d], ss);
    float norm = sqrtf(ss);
    if (norm == 0.f) norm = 1.f;
    float* dst = reinterpret_cast<float*>(qs + (warp * QW + j) * C);
    for (int d = lane; d < DMAX; d += 32) dst[d] = (b < B && d < D) ? src[d] / norm : 0.f;
    Sel<KW>(sel_v, sel_i, sel_m, warp * QW + j).init();
  }

  // Each query's threshold score, the same on every lane: a candidate
  // below it is dropped. Its index half and the count of pending
  // candidates sit in shared memory (meta), read only where one is taken.
  float th[QW];
#pragma unroll
  for (int j = 0; j < QW; ++j) th[j] = qb + j < B ? neg_inf() : __int_as_float(0x7f800000);
  int step = 0;  // steps of this split so far
  const int tiles = (n1 - n0 + TR - 1) / TR;
  if (tiles > 0) load_tile<C, TR>(ring, dict, n0, min(TR, n1 - n0), D, vec);
  for (int t = 0; t < tiles; ++t) {
    const int t0 = n0 + t * TR;
    const int rows = min(TR, n1 - t0);
    const float4* tile = ring + (t & 1) * TR * C;
    if (t + 1 < tiles) {  // the next tile streams in while this one is scored
      load_tile<C, TR>(ring + ((t + 1) & 1) * TR * C, dict, t0 + TR, min(TR, n1 - t0 - TR), D,
                       vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and the queries) are in shared memory
    if (active) {
      for (int j0 = 0; j0 < rows; j0 += S) {
        // At steps 1, 2, 4, 8, ... of the split each query publishes its
        // best so far (listed or pending) and reads its slots; the reads
        // land while the step's FMAs run, and raise the thresholds after.
        const int st = step++;
        const bool refresh = tops != nullptr && st > 0 && (st & (st - 1)) == 0;
        unsigned slot[QW];
        if (refresh) {
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            const Sel<KW> sel(sel_v, sel_i, sel_m, warp * QW + j);
            unsigned own = lane < sel.meta[1] ? score_key(sel.pend_v()[lane]) : 0u;
            own = __reduce_max_sync(kFull, max(own, score_key(sel.v[0])));
            if (lane == 0 && qb + j < B && own > score_key(neg_inf())) {
              atomicMax(tops + (qb + j) * 32 + (split & 31), own);
            }
          }
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            slot[j] = qb + j < B ? __ldcg(tops + (qb + j) * 32 + lane) : 0u;
          }
        }
        float4 row[R][C];
#pragma unroll
        for (int u = 0; u < R; ++u) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            row[u][c] = tile[((j0 + lane * R) * C + u * C + c) ^ (lane & 7)];
          }
        }
        const int first = j0 + lane * R;  // the lane's first row in the tile
        // All QW * R scores first, with no branch between them, so that the
        // FMA chains of different queries interleave.
        float acc[QW][R];
#pragma unroll
        for (int j = 0; j < QW; ++j) {
#pragma unroll
          for (int u = 0; u < R; ++u) acc[j][u] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            const float4 qv = qs[(warp * QW + j) * C + c];
#pragma unroll
            for (int u = 0; u < R; ++u) {
              acc[j][u] = fmaf(qv.x, row[u][c].x, acc[j][u]);
              acc[j][u] = fmaf(qv.y, row[u][c].y, acc[j][u]);
              acc[j][u] = fmaf(qv.z, row[u][c].z, acc[j][u]);
              acc[j][u] = fmaf(qv.w, row[u][c].w, acc[j][u]);
            }
          }
        }
        if (refresh) {
          float m[QW];
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            m[j] = warp_sort_scores(fmaxf(neg_inf(), key_score(slot[j])));  // drops NaN
          }
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            const float bound = k <= 32 ? __shfl_sync(kFull, m[j], k - 1) : neg_inf();
            if (bound > th[j]) {
              th[j] = bound;
              if (lane == 0) Sel<KW>(sel_v, sel_i, sel_m, warp * QW + j).meta[0] = INT_MAX;
            }
          }
          __syncwarp();
        }
        if (t0 + j0 + S > n_valid) {  // warp-uniform: a step reaching the masked columns
#pragma unroll
          for (int u = 0; u < R; ++u) {
            if (t0 + first + u >= n_valid) {
#pragma unroll
              for (int j = 0; j < QW; ++j) acc[j][u] = neg_inf();
            }
          }
        }
        unsigned listed = 0;  // bit j * R + u: score (j, u) is in its list already
        if (t == 0 && j0 == 0 && k <= 32) {
          // A split's first step fills each list with the 32 lanes' best
          // candidates, sorted, and their k-th becomes the threshold: k
          // rows of this split reach it, so the query's k-th best does too.
          // The step then takes only the other candidates above it. The
          // highest is published at once as the split's best.
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            float bv = neg_inf();
            int bi = INT_MAX, bu = -1;
#pragma unroll
            for (int u = 0; u < R; ++u) {
              if (first + u < rows && better(acc[j][u], t0 + first + u, bv, bi)) {
                bv = acc[j][u];
                bi = t0 + first + u;
                bu = u;
              }
            }
            if (bu >= 0) listed |= 1u << (j * R + bu);
            warp_sort(bv, bi);
            const Sel<KW> sel(sel_v, sel_i, sel_m, warp * QW + j);
            sel.v[lane] = bv;
            sel.i[lane] = bi;
            const float seed_v = __shfl_sync(kFull, bv, k - 1);
            const int seed_i = __shfl_sync(kFull, bi, k - 1);
            if (tops != nullptr && lane == 0 && qb + j < B && bv > neg_inf()) {
              atomicMax(tops + (qb + j) * 32 + (split & 31), score_key(bv));
            }
            if (qb + j < B) {
              th[j] = seed_v;
              if (lane == 0) sel.meta[0] = seed_i;
            }
          }
          __syncwarp();
        }
        // Bit j * R + u: score (j, u) reaches its query's threshold.
        unsigned take = 0;
#pragma unroll
        for (int j = 0; j < QW; ++j) {
#pragma unroll
          for (int u = 0; u < R; ++u) take |= (acc[j][u] >= th[j] ? 1u : 0u) << (j * R + u);
        }
        take &= ~listed;
        if (j0 + S > rows) {  // warp-uniform: the last tile's rows past its end
#pragma unroll
          for (int u = 0; u < R; ++u) {
            if (first + u >= rows) {
#pragma unroll
              for (int j = 0; j < QW; ++j) take &= ~(1u << (j * R + u));
            }
          }
        }
        // Rare: the (query, row) pairs some lane took, one bit each.
        const unsigned taken = __reduce_or_sync(kFull, take);
        if (taken == 0) continue;
        // Append those that beat their threshold exactly, in the order of
        // `better`, and merge 32 at a time into the list.
#pragma unroll
        for (int j = 0; j < QW; ++j) {
          if (((taken >> (j * R)) & ((1u << R) - 1u)) == 0) continue;  // warp-uniform
          const Sel<KW> sel(sel_v, sel_i, sel_m, warp * QW + j);
          Threshold cur{th[j], sel.meta[0]};
          int pending = sel.meta[1];
#pragma unroll
          for (int u = 0; u < R; ++u) {
            if (((taken >> (j * R + u)) & 1u) == 0) continue;
            const int col = t0 + first + u;
            const bool ok = ((take >> (j * R + u)) & 1u) && better(acc[j][u], col, cur.v, cur.i);
            const unsigned m = __ballot_sync(kFull, ok);
            sel.append(acc[j][u], col, ok, m, pending);
            pending += __popc(m);
            if (pending >= 32) {
              cur = flush<KW>(sel.v, sel.i, pending, k, cur);
              pending = 0;
            }
          }
          th[j] = cur.v;
          __syncwarp();
          if (lane == 0) {
            sel.meta[0] = cur.i;
            sel.meta[1] = pending;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();  // every warp is done with this tile before it is refilled
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    const int b = qb + j;
    if (b >= B) break;
    const Sel<KW> sel(sel_v, sel_i, sel_m, warp * QW + j);
    const int pending = sel.meta[1];
    if (pending > 0) flush<KW>(sel.v, sel.i, pending, k, Threshold{th[j], sel.meta[0]});
    const long long base = (static_cast<long long>(b) * splits + split) * k;
    if (out_i64 != nullptr) {
      sel.store(out_v + base, out_i64 + base, k);
    } else {
      sel.store(out_v + base, out_i32 + base, k);
    }
  }
}

// grid: ceil(B / kWarps). Merges the splits' (B, splits * k) lists, one
// warp per query, taking only entries that reach the bound from the
// splits' final bests.
template <int KW>
__global__ void __launch_bounds__(kWarps * 32)
    topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
               const unsigned* __restrict__ tops, int B, int splits, int k,
               float* __restrict__ out_v, long long* __restrict__ out_i) {
  __shared__ float sel_v[kWarps * Sel<KW>::kEntries];
  __shared__ int sel_i[kWarps * Sel<KW>::kEntries];
  __shared__ int sel_m[kWarps * 2];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the same on all lanes of a warp
  const int lane = threadIdx.x & 31;
  const Sel<KW> sel(sel_v, sel_i, sel_m, warp);
  sel.init();
  Threshold th{tops_bound(tops + b * 32, k), INT_MAX};
  int pending = 0;
  const int m = splits * k;
  const long long base = static_cast<long long>(b) * m;
  for (int j0 = 0; j0 < m; j0 += 128) {  // four loads in flight per lane
    float s[4];
    int idx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u + lane;
      s[u] = j < m ? part_v[base + j] : neg_inf();
      idx[u] = j < m ? part_i[base + j] : INT_MAX;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool take = j0 + 32 * u + lane < m && better(s[u], idx[u], th.v, th.i);
      const unsigned mask = __ballot_sync(kFull, take);
      if (mask == 0) continue;
      sel.append(s[u], idx[u], take, mask, pending);
      pending += __popc(mask);
      if (pending >= 32) {
        th = flush<KW>(sel.v, sel.i, pending, k, th);
        pending = 0;
      }
    }
  }
  if (pending > 0) flush<KW>(sel.v, sel.i, pending, k, th);
  sel.store(out_v + static_cast<long long>(b) * k, out_i + static_cast<long long>(b) * k, k);
}

struct Args {
  const float* q;
  const float* dict;
  float* out_v;
  long long* out_i;
  float* part_v;
  int* part_i;
  unsigned* tops;
  int B, N, D, k, n_valid, splits, qw;
};

template <int DMAX, int KW, int QW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // Two tiles, the block's queries and their selection state.
  constexpr int bytes =
      (2 * kTileFloats + kWarps * QW * DMAX) * 4 + kWarps * QW * (Sel<KW>::kEntries + 1) * 8;
  cudaError_t e = cudaFuncSetAttribute(topk_partial<DMAX, KW, QW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int vec = a.D == DMAX && reinterpret_cast<uintptr_t>(a.dict) % 16 == 0;
  const dim3 grid((a.B + kWarps * QW - 1) / (kWarps * QW), a.splits);
  if (a.splits == 1) {
    topk_partial<DMAX, KW, QW><<<grid, kWarps * 32, bytes, stream>>>(
        a.q, a.dict, a.B, a.N, a.D, a.k, a.n_valid, 1, vec, nullptr, a.out_v, nullptr, a.out_i);
    return cudaGetLastError();
  }
  e = cudaMemsetAsync(a.tops, 0, sizeof(unsigned) * a.B * 32, stream);
  if (e != cudaSuccess) return e;
  topk_partial<DMAX, KW, QW><<<grid, kWarps * 32, bytes, stream>>>(
      a.q, a.dict, a.B, a.N, a.D, a.k, a.n_valid, a.splits, vec, a.tops, a.part_v, a.part_i,
      nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_merge<KW><<<(a.B + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      a.part_v, a.part_i, a.tops, a.B, a.splits, a.k, a.out_v, a.out_i);
  return cudaGetLastError();
}

template <int DMAX, int KW>
cudaError_t launch_qw(const Args& a, cudaStream_t stream) {
  return a.qw == 1 ? launch<DMAX, KW, 1>(a, stream) : launch<DMAX, KW, 4>(a, stream);
}

template <int DMAX>
cudaError_t launch_k(const Args& a, cudaStream_t stream) {
  return a.k <= 32 ? launch_qw<DMAX, 1>(a, stream) : launch_qw<DMAX, 2>(a, stream);
}

}  // namespace

extern "C" {

// q: (B, D) f32; dict: (N, D) f32; out_v: (B, k) f32; out_i: (B, k) int64;
// part_v / part_i / tops: (B, splits, k) f32, (B, splits, k) int32 and
// (B, 32) int32 scratch, unused when splits == 1. queries_per_warp is 1
// or 4. Requires 1 <= k <= 64, k <= N, 1 <= D <= 64. Returns
// cudaGetLastError() after the launches.
int latice_cosine_topk_fused(const void* q, const void* dict, void* out_v, void* out_i,
                             void* part_v, void* part_i, void* tops, int B, int N, int D, int k,
                             int n_valid, int splits, int queries_per_warp, void* stream) {
  const int qw = queries_per_warp;
  if (k < 1 || k > 64 || D < 1 || D > 64 || splits < 1 || (qw != 1 && qw != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(q), static_cast<const float*>(dict),
               static_cast<float*>(out_v),   static_cast<long long*>(out_i),
               static_cast<float*>(part_v),  static_cast<int*>(part_i),
               static_cast<unsigned*>(tops), B, N, D, k, n_valid, splits, qw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 16) {
    e = launch_k<16>(a, st);
  } else if (D <= 32) {
    e = launch_k<32>(a, st);
  } else {
    e = launch_k<64>(a, st);
  }
  return static_cast<int>(e);
}

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
