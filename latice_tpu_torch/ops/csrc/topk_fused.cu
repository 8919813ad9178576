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
// The TPU kernel's selection (k rounds of max extraction over every score
// tile) would add ~5*k operations per score on top, and so would a sorted
// list per lane: some lane of 32 nearly always has a candidate to insert,
// so the whole warp would run the insertion on most steps. This design is
// still well above the bound: each warp reads its whole dictionary slice
// from shared memory for a single query (one FMA per 4 bytes loaded), so
// shared-memory bandwidth is the likely limit. Scoring several queries per
// warp from each load is the next step.
//
// Design: one warp per query, 8 queries per block. The block streams tiles
// of dictionary rows through shared memory, stored dimension-major so that
// a lane reads four consecutive rows of one dimension with one 16-byte
// load; the normalized query sits in registers, and each lane scores four
// rows per step with four independent FMA chains. The warp keeps one
// sorted list of its best candidates, entry p in lane p % 32, and every
// lane holds a copy of the k-th entry as a threshold. A step costs one
// compare per score and a ballot; the rare candidates that beat the
// threshold are inserted one at a time, warp-uniformly (count the better
// entries with a ballot, shift the rest up by one lane). Candidates are
// ordered by (score desc, index asc) throughout, the counterpart of
// _extract_topk_tile. With few queries the dictionary is split across
// blockIdx.y so every SM has work: each split writes its partial top-k,
// and a second kernel merges the splits' lists with the same list.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBytes = 48 * 1024;

// Dictionary rows per shared tile: a multiple of the 128 rows a warp
// scores per step, within 48 KB of static shared memory.
template <int DMAX>
__host__ __device__ constexpr int tile_rows() {
  return (kTileBytes / (4 * DMAX)) / 128 * 128;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Strict order of candidates: higher score first, then lower index.
__device__ __forceinline__ bool better(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// A warp's best 32*KW candidates so far, sorted; entry p is slot p / 32 of
// lane p % 32. Every method is called by all 32 lanes together.
template <int KW>
struct WarpList {
  float v[KW];
  int i[KW];
  float tv;  // the k-th entry, the bar a candidate must beat
  int ti;
  int k;

  __device__ __forceinline__ void init(int k_) {
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      v[w] = neg_inf();
      i[w] = INT_MAX;
    }
    tv = neg_inf();
    ti = INT_MAX;
    k = k_;
  }

  // Insert (s, idx), the same on every lane and better than the k-th entry.
  __device__ __forceinline__ void insert(float s, int idx) {
    const int lane = threadIdx.x & 31;
    int pos = 0;
#pragma unroll
    for (int w = 0; w < KW; ++w) pos += __popc(__ballot_sync(kFull, better(v[w], i[w], s, idx)));
    float below_v = neg_inf();  // lane 31's old entry of the slot below
    int below_i = INT_MAX;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      float up_v = __shfl_up_sync(kFull, v[w], 1);
      int up_i = __shfl_up_sync(kFull, i[w], 1);
      const float last_v = __shfl_sync(kFull, v[w], 31);
      const int last_i = __shfl_sync(kFull, i[w], 31);
      if (lane == 0) {
        up_v = below_v;
        up_i = below_i;
      }
      const int p = w * 32 + lane;
      if (p == pos) {
        v[w] = s;
        i[w] = idx;
      } else if (p > pos) {
        v[w] = up_v;
        i[w] = up_i;
      }
      below_v = last_v;
      below_i = last_i;
    }
    const bool low = KW == 1 || k <= 32;
    tv = __shfl_sync(kFull, low ? v[0] : v[KW - 1], (k - 1) & 31);
    ti = __shfl_sync(kFull, low ? i[0] : i[KW - 1], (k - 1) & 31);
  }

  // Offer each lane's candidate (s, idx) where ok; those that beat the
  // k-th entry are inserted in lane order.
  __device__ __forceinline__ void offer(float s, int idx, bool ok) {
    unsigned m = __ballot_sync(kFull, ok && better(s, idx, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cs = __shfl_sync(kFull, s, src);
      const int ci = __shfl_sync(kFull, idx, src);
      if (better(cs, ci, tv, ti)) insert(cs, ci);
    }
  }

  template <typename IdxT>
  __device__ __forceinline__ void store(float* out_v, IdxT* out_i) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int p = w * 32 + lane;
      if (p < k) {
        out_v[p] = v[w];
        out_i[p] = static_cast<IdxT>(i[w]);
      }
    }
  }
};

// grid: (ceil(B / kWarps), splits). Split s scores rows
// [s * rows_per_split, min(N, (s + 1) * rows_per_split)) and writes its best
// k to out[(b * splits + s) * k ...] as int32 (splits > 1) or int64 indices.
// vec: D == DMAX and the dictionary is 16-byte aligned, so rows load as
// float4; otherwise the tile's dimensions past D are zero-filled.
template <int DMAX, int KW>
__global__ void __launch_bounds__(kWarps * 32)
    topk_partial(const float* __restrict__ q, const float* __restrict__ dict, int B, int N, int D,
                 int k, int n_valid, int rows_per_split, int vec, float* __restrict__ out_v,
                 int* __restrict__ out_i32, long long* __restrict__ out_i64) {
  constexpr int TR = tile_rows<DMAX>();
  __shared__ __align__(16) float tile[DMAX * TR];  // tile[d * TR + row]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const int split = blockIdx.y;
  const int n0 = split * rows_per_split;
  const int n1 = min(N, n0 + rows_per_split);
  const bool active = b < B;  // the same on all lanes of a warp

  float qr[DMAX];
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qr[d] = (active && d < D) ? q[static_cast<long long>(b) * D + d] : 0.f;
    ss = fmaf(qr[d], qr[d], ss);
  }
  float norm = sqrtf(ss);
  if (norm == 0.f) norm = 1.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) qr[d] = qr[d] / norm;

  WarpList<KW> list;
  list.init(k);
  for (int t0 = n0; t0 < n1; t0 += TR) {
    const int rows = min(TR, n1 - t0);
    __syncthreads();  // the previous tile is consumed
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* src = dict + static_cast<long long>(t0 + r) * D;
      if (vec) {
#pragma unroll
        for (int c = 0; c < DMAX / 4; ++c) {
          const float4 x = reinterpret_cast<const float4*>(src)[c];
          tile[(4 * c + 0) * TR + r] = x.x;
          tile[(4 * c + 1) * TR + r] = x.y;
          tile[(4 * c + 2) * TR + r] = x.z;
          tile[(4 * c + 3) * TR + r] = x.w;
        }
      } else {
#pragma unroll
        for (int d = 0; d < DMAX; ++d) tile[d * TR + r] = d < D ? src[d] : 0.f;
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < rows; j0 += 128) {
      const int j = j0 + 4 * lane;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        // Rows past `rows` hold stale values; they are never offered.
        const float4 t = *reinterpret_cast<const float4*>(tile + d * TR + j);
        acc[0] = fmaf(qr[d], t.x, acc[0]);
        acc[1] = fmaf(qr[d], t.y, acc[1]);
        acc[2] = fmaf(qr[d], t.z, acc[2]);
        acc[3] = fmaf(qr[d], t.w, acc[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = t0 + j + u;
        list.offer(col < n_valid ? acc[u] : neg_inf(), col, j + u < rows);
      }
    }
  }
  if (!active) return;
  const long long base = (static_cast<long long>(b) * gridDim.y + split) * k;
  if (out_i64 != nullptr) {
    list.store(out_v + base, out_i64 + base);
  } else {
    list.store(out_v + base, out_i32 + base);
  }
}

// grid: ceil(B / kWarps). Merges the splits' (B, m = splits * k) lists.
template <int KW>
__global__ void __launch_bounds__(kWarps * 32)
    topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i, int B, int m,
               int k, float* __restrict__ out_v, long long* __restrict__ out_i) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the same on all lanes of a warp
  const int lane = threadIdx.x & 31;
  WarpList<KW> list;
  list.init(k);
  const long long base = static_cast<long long>(b) * m;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < m;
    list.offer(ok ? part_v[base + j] : neg_inf(), ok ? part_i[base + j] : INT_MAX, ok);
  }
  list.store(out_v + static_cast<long long>(b) * k, out_i + static_cast<long long>(b) * k);
}

struct Args {
  const float* q;
  const float* dict;
  float* out_v;
  long long* out_i;
  float* part_v;
  int* part_i;
  int B, N, D, k, n_valid, splits;
};

template <int DMAX, int KW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rows_per_split = (a.N + a.splits - 1) / a.splits;
  const int vec = a.D == DMAX && reinterpret_cast<uintptr_t>(a.dict) % 16 == 0;
  const dim3 grid((a.B + kWarps - 1) / kWarps, a.splits);
  if (a.splits == 1) {
    topk_partial<DMAX, KW><<<grid, kWarps * 32, 0, stream>>>(
        a.q, a.dict, a.B, a.N, a.D, a.k, a.n_valid, rows_per_split, vec, a.out_v, nullptr,
        a.out_i);
    return cudaGetLastError();
  }
  topk_partial<DMAX, KW><<<grid, kWarps * 32, 0, stream>>>(
      a.q, a.dict, a.B, a.N, a.D, a.k, a.n_valid, rows_per_split, vec, a.part_v, a.part_i,
      nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_merge<KW><<<(a.B + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      a.part_v, a.part_i, a.B, a.splits * a.k, a.k, a.out_v, a.out_i);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_k(const Args& a, cudaStream_t stream) {
  return a.k <= 32 ? launch<DMAX, 1>(a, stream) : launch<DMAX, 2>(a, stream);
}

}  // namespace

extern "C" {

// q: (B, D) f32; dict: (N, D) f32; out_v: (B, k) f32; out_i: (B, k) int64;
// part_v / part_i: (B, splits, k) f32 / int32 scratch, unused when
// splits == 1. Requires 1 <= k <= 64, k <= N, 1 <= D <= 64.
// Returns cudaGetLastError() after the launches.
int latice_cosine_topk_fused(const void* q, const void* dict, void* out_v, void* out_i,
                             void* part_v, void* part_i, int B, int N, int D, int k, int n_valid,
                             int splits, void* stream) {
  if (k < 1 || k > 64 || D < 1 || D > 64 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(q), static_cast<const float*>(dict),
               static_cast<float*>(out_v),   static_cast<long long*>(out_i),
               static_cast<float*>(part_v),  static_cast<int*>(part_i),
               B, N, D, k, n_valid, splits};
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
