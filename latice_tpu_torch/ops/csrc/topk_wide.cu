// K5: exact cosine top-k of bf16 queries over a wide bf16 table on the
// tensor cores, with the (B, N) scores never written to device memory.
//
// Replaces no TPU kernel: the JAX package's exact engine is
// jnp.dot(q, d.T, preferred_element_type=f32) and lax.top_k, which XLA runs
// on the MXU. Added for pattern dictionary indexing, whose features are the
// pixels (D = 16,384 unbinned): there the exact engine made an f32 copy of
// the table and a (B, N) score matrix on every batch.
//
// Contract: topk_lower_index_first(q.float() @ table.float().T, k) for
// (B, D) bf16 queries over an (N, D) bf16 table, best first, the lower row
// first among equal scores. Products are exact in f32 and sums are f32 (the
// tensor cores' bf16 products with f32 accumulators). D must be a multiple
// of 8 (a row is whole 16-byte chunks, as TMA requires of its strides).
//
// What bounds it on an H100: max(2*B*N*D at 989 TFLOP/s, (N + B)*D*2 bytes
// at 3.35 TB/s). At the DI cell's shapes (B=256, N=333,227, D=16,384) the
// table's 10.9 GB take 3.26 ms and the 2.80 TFLOP 2.83 ms: a batch sits
// just below the ridge, so the table has to come from device memory once a
// batch and the tensor cores have to stay busy while it streams.
//
// Scoring: a block holds 256 queries (one chunk of the batch; 128 where
// the batch has no more) and walks its split, a run of 128-row tiles of the
// table. One producer thread keeps TMA loads in flight through a ring of
// stages, each the queries' 64-feature slice and the tile's 128 x 64 slice
// of one step along D, both in the 128-byte swizzle that wgmma reads. A
// consumer warpgroup of 128 queries (two of them in a block of 256) runs
// wgmma m64n128k16 (bf16 operands, f32 accumulators in registers, 128 a
// thread) over the stage, releases it to the producer once its products
// have read it, and so sums the tile's scores over all of D. Every block
// reads the same query slices (8 MB a tile at 256 queries, from L2) and its
// own table rows, so the table is read from device memory once a batch.
// Query rows past the batch arrive as zeros and are multiplied all the
// same: every wgmma of a block is unconditional, which keeps the compiler
// from serializing them. The splits are sized to fill one wave of the SMs.
//
// Selection, in the epilogue of each tile: a query's 128 scores lie in the
// four lanes of one quad of one warp (the wgmma fragment), 32 a lane. Each
// query keeps a list of its split's best k keys so far: the f32 score's
// order above the reversed row (index.knn.topk_lower_index_first's key), so
// one integer comparison orders candidates exactly. The list's lowest key
// is held in registers as the query's threshold; a tile whose scores all
// fall below every threshold of the warp costs one compare a score and one
// vote. Otherwise the quad takes its best remaining score while it beats
// the threshold, writes it over the lowest slot and rescans the list for
// the new lowest. The lists live in shared memory up to k = kSmemListK and
// in the partial output in device memory above it; each thread reaches
// them through one generic pointer. The epilogue is short beside the tile's
// 16,384-deep sum, and the producer keeps loading meanwhile.
//
// Merge: a second kernel, one block a query, sorts the splits' keys in
// shared memory (bitonic, descending) and writes the first k as scores and
// rows. Its smem holds at most kMergeKeys keys, so the wrapper takes at most
// kMergeKeys / k splits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;        // table rows a tile
constexpr int kBK = 64;         // features a stage: one 128-byte swizzled row
constexpr int kTBytes = kBN * kBK * 2;
constexpr int kSmemListK = 40;  // lists in shared memory up to this k
constexpr int kMaxK = 1024;
constexpr int kMergeKeys = 16384;
constexpr int kMergeThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kEmpty = LLONG_MIN;  // below every key of a real row

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The key of a score and a row: the score's order above the reversed row.
__device__ __forceinline__ long long make_key(float s, int row) {
  const int b = __float_as_int(s);
  const unsigned ordered = static_cast<unsigned>(b < 0 ? b ^ 0x7fffffff : b);
  return static_cast<long long>((static_cast<unsigned long long>(ordered) << 32) |
                                (0xffffffffull - static_cast<unsigned>(row)));
}
__device__ __forceinline__ float key_score(long long key) {
  const int hi = static_cast<int>(key >> 32);
  return __int_as_float(hi < 0 ? hi ^ 0x7fffffff : hi);
}

// mbarriers: the full barrier of a stage completes when its TMA bytes land,
// the empty one when every consumer warp has released it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA copy of the box at (c0 along D, c1 along rows); rows and features
// past the tensor's end arrive as zeros and still count their bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's view of a K-major tile in the 128-byte swizzle: 8-row groups
// 1,024 bytes apart; a step of 16 features is 32 bytes on the start.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T (+ d unless !accumulate).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The block's shape for C consumer warpgroups of 128 queries each: its
// queries, threads, ring stages (more where the query slices are fewer) and
// shared memory (the ring, its barriers and, for k <= kSmemListK, the lists).
template <int C>
struct Shape {
  static constexpr int kQueries = 128 * C;
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kQBytes = kQueries * kBK * 2;
  static constexpr int kStageBytes = kQBytes + kTBytes;
  static constexpr int kStages = C == 2 ? 3 : 5;
  static int smem(int k) {
    return 1024 + kStages * kStageBytes + 2 * kStages * 8 +
           (k <= kSmemListK ? kQueries * k * 8 : 0);
  }
};

// grid: (splits, ceil(B / (128 C))). Split s takes tiles [s * tiles_per_split,
// (s + 1) * tiles_per_split) and leaves each query's best k keys, in no
// order, at part[(b * splits + s) * k ...] (kEmpty where it has fewer rows).
// Both shapes compile to the register budget of the larger one's 384
// threads, which the warpgroups then trade (setmaxnreg) from the producer's
// to the consumers'.
template <int C>
__global__ void __launch_bounds__(Shape<2>::kThreads, 1)
    k5_cosine_topk_partial(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap tmap, long long* __restrict__ part,
                           int B, int N, int D, int k, int tiles_per_split, int splits) {
  using S = Shape<C>;
  extern __shared__ unsigned char smem_raw[];
  // The swizzled tiles want 1,024-byte alignment; the wrapper adds the slack.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  long long* slists = reinterpret_cast<long long*>(empty + S::kStages);
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * S::kQueries;
  const int t_first = split * tiles_per_split;
  const int t_last = min(t_first + tiles_per_split, (N + kBN - 1) / kBN);
  const int ksteps = (D + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C) {
    // The producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == C * 128) {
      int stage = 0, phase = 0;
      for (int t = t_first; t < t_last; ++t) {
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every stage free
          unsigned char* buf = smem + stage * S::kStageBytes;
          mbar_expect(&full[stage], S::kStageBytes);
          tma_load(buf, &qmap, ks * kBK, q0, &full[stage]);
          tma_load(buf + S::kQBytes, &tmap, ks * kBK, t * kBN, &full[stage]);
          if (++stage == S::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const bool in_smem = k <= kSmemListK;
    // This lane's four queries: slice s (64 queries), half h (row + 8 h of
    // the fragment); the quad (lane / 4) shares them. Query (s, h)'s list
    // starts at lists + (64 s + 8 h) * stride.
    const int ql0 = 128 * wg + 16 * warp + (lane >> 2);
    const long long stride = in_smem ? k : static_cast<long long>(splits) * k;
    long long* const lists =
        in_smem ? slists + static_cast<long long>(ql0) * k
                : part + (static_cast<long long>(q0 + ql0) * splits + split) * k;
    long long thr_key[2][2];  // the list's lowest key; LLONG_MAX for a padding query
    int thr_slot[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        thr_slot[s][h] = 0;
        thr_key[s][h] = q0 + ql0 + 64 * s + 8 * h < B ? kEmpty : LLONG_MAX;
        if (thr_key[s][h] == kEmpty) {
          long long* list = lists + (64 * s + 8 * h) * stride;
          for (int j = lane & 3; j < k; j += 4) list[j] = kEmpty;
        }
      }
    }
    __syncwarp();

    float acc[2][64];
    int stage = 0, phase = 0;
    for (int t = t_first; t < t_last; ++t) {
      int held = -1;  // the stage whose products may still be reading it
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&full[stage], phase);
        const uint32_t qa = smem_u32(smem + stage * S::kStageBytes) + 128 * wg * kBK * 2;
        const uint32_t ta = smem_u32(smem + stage * S::kStageBytes + S::kQBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            wgmma_m64n128k16(acc[s], smem_desc(qa + s * 64 * kBK * 2 + kk * 32),
                             smem_desc(ta + kk * 32), (ks | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

      // Epilogue: value i of slice s is query (s, (i >> 1) & 1), row
      // r0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1).
      const int r0 = t * kBN;
      if (r0 + kBN > N) {  // the table's last tile: rows past N score -inf
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            if (r0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) >= N) acc[s][i] = neg_inf();
          }
        }
      }
      // A score below its query's lowest key's score cannot enter the
      // list (a padding query's LLONG_MAX reads as NaN, which none reaches).
      float thr_s[2][2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          thr_s[s][h] = thr_key[s][h] == kEmpty ? neg_inf() : key_score(thr_key[s][h]);
        }
      }
      bool cand = false;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float v = acc[s][i];
          cand |= v > neg_inf() && v >= thr_s[s][(i >> 1) & 1];
        }
      }
      if (!__any_sync(kFull, cand)) continue;
      // Each round, every quad offers each of its queries its best
      // remaining score; those that beat their threshold replace the
      // list's lowest key, and the list is rescanned for the new lowest.
      while (true) {
        bool took[2][2];
        bool any = false;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float bv = neg_inf();
            int bc = INT_MAX;
#pragma unroll
            for (int g = 0; g < 16; ++g) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = acc[s][4 * g + 2 * h + e];
                if (v > bv) {  // rows ascend with g and e: the lower row wins a tie
                  bv = v;
                  bc = r0 + 8 * g + 2 * (lane & 3) + e;
                }
              }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              const float ov = __shfl_xor_sync(kFull, bv, off);
              const int oc = __shfl_xor_sync(kFull, bc, off);
              if (ov > bv || (ov == bv && oc < bc)) {
                bv = ov;
                bc = oc;
              }
            }
            const long long key = make_key(bv, bc);
            const bool take = bv > neg_inf() && key > thr_key[s][h];
            if (take) {
              if ((lane & 3) == 0) lists[(64 * s + 8 * h) * stride + thr_slot[s][h]] = key;
#pragma unroll
              for (int g = 0; g < 16; ++g) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (r0 + 8 * g + 2 * (lane & 3) + e == bc) acc[s][4 * g + 2 * h + e] = neg_inf();
                }
              }
            }
            took[s][h] = take;
            any |= take;
          }
        }
        if (!__any_sync(kFull, any)) break;
        __syncwarp();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            long long mk = LLONG_MAX;
            int ms = 0;
            if (took[s][h]) {
              const long long* list = lists + (64 * s + 8 * h) * stride;
              for (int j = lane & 3; j < k; j += 4) {
                const long long x = list[j];
                if (x < mk) {
                  mk = x;
                  ms = j;
                }
              }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              const long long om = __shfl_xor_sync(kFull, mk, off);
              const int os = __shfl_xor_sync(kFull, ms, off);
              if (om < mk || (om == mk && os < ms)) {
                mk = om;
                ms = os;
              }
            }
            if (took[s][h]) {
              thr_key[s][h] = mk;
              thr_slot[s][h] = ms;
            }
          }
        }
        __syncwarp();
      }
    }

    if (in_smem) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + ql0 + 64 * s + 8 * h;
          if (q < B) {
            long long* out = part + (static_cast<long long>(q) * splits + split) * k;
            const long long* list = lists + (64 * s + 8 * h) * stride;
            for (int j = lane & 3; j < k; j += 4) out[j] = list[j];
          }
        }
      }
    }
  }
}

// grid: B, dynamic smem n_keys * 8. Sorts query b's c keys (padded with
// kEmpty to n_keys, a power of two) in descending order and writes the
// first k as f32 scores and int64 rows.
__global__ void __launch_bounds__(kMergeThreads)
    k5_cosine_topk_merge(const long long* __restrict__ part, float* __restrict__ out_v,
                         long long* __restrict__ out_i, int c, int k, int n_keys) {
  extern __shared__ long long keys[];
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < n_keys; i += kMergeThreads) {
    keys[i] = i < c ? part[b * c + i] : kEmpty;
  }
  __syncthreads();
  for (int size = 2; size <= n_keys; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n_keys; i += kMergeThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const long long x = keys[i], y = keys[j];
          if (((i & size) == 0) == (x < y)) {  // runs alternate: descending where i & size == 0
            keys[i] = y;
            keys[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += kMergeThreads) {
    const long long key = keys[j];
    out_v[b * k + j] = key_score(key);
    out_i[b * k + j] = 0xffffffffll - (key & 0xffffffffll);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken from the libcuda.so.1 that the runtime loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A (rows, d) bf16 row-major tensor read in boxes of box_rows x kBK.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows, int d, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C>
cudaError_t launch_partial(const CUtensorMap& qmap, const CUtensorMap& tmap, long long* part,
                           int B, int N, int D, int k, int tiles_per_split, int splits,
                           cudaStream_t st) {
  using S = Shape<C>;
  const int smem = S::smem(k);
  const cudaError_t e = cudaFuncSetAttribute(
      k5_cosine_topk_partial<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(splits, (B + S::kQueries - 1) / S::kQueries);
  k5_cosine_topk_partial<C><<<grid, S::kThreads, smem, st>>>(qmap, tmap, part, B, N, D, k,
                                                             tiles_per_split, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, D) bf16; table: (N, D) bf16, both 16-byte aligned; part: (B,
// splits, k) int64 scratch; out_v: (B, k) f32; out_i: (B, k) int64;
// consumers: 1 or 2 warpgroups of 128 queries a block.
// Requires 1 <= k <= min(kMaxK, N), D % 8 == 0, splits * k <= n_keys <=
// kMergeKeys with n_keys a power of two, and the splits to cover the
// table's tiles. Returns cudaGetLastError() after the launches.
int latice_cosine_topk_wide(const void* q, const void* table, void* part, void* out_v,
                            void* out_i, int B, int N, int D, int k, int consumers,
                            int tiles_per_split, int splits, int n_keys, void* stream) {
  const int n_tiles = (N + kBN - 1) / kBN;
  if ((consumers != 1 && consumers != 2) || B < 1 || N < 1 || D < 8 || D % 8 != 0 || k < 1 || k > kMaxK || k > N || splits < 1 ||
      tiles_per_split < 1 || static_cast<long long>(splits) * tiles_per_split < n_tiles ||
      static_cast<long long>(splits) * k > n_keys || n_keys > kMergeKeys ||
      (n_keys & (n_keys - 1)) != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap qmap, tmap;
  if (!make_map(enc, &qmap, q, B, D, 128 * consumers) || !make_map(enc, &tmap, table, N, D, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* keys = static_cast<long long*>(part);
  cudaError_t e = consumers == 1
                      ? launch_partial<1>(qmap, tmap, keys, B, N, D, k, tiles_per_split, splits, st)
                      : launch_partial<2>(qmap, tmap, keys, B, N, D, k, tiles_per_split, splits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(k5_cosine_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           n_keys * 8);
  if (e != cudaSuccess) return static_cast<int>(e);
  k5_cosine_topk_merge<<<B, kMergeThreads, n_keys * 8, st>>>(
      static_cast<const long long*>(part), static_cast<float*>(out_v),
      static_cast<long long*>(out_i), splits * k, k, n_keys);
  return static_cast<int>(cudaGetLastError());
}

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
