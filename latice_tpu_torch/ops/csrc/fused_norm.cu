// Fused InstanceNorm(affine=False) + LeakyReLU over NCHW, forward (K2f)
// and backward (K2b), for float32 and bfloat16 tensors.
//
// Replaces the TPU kernels of latice_tpu/ops/fused_norm.py:
// instance_norm_leaky_relu, forward body _fwd_kernel (pallas_call in _fwd)
// and backward body _bwd_kernel (pallas_call in _bwd_rule). Same numerics,
// with every statistic and every product in f32 whatever the element type:
//   forward:  one pass for E[x] and E[x^2], var = max(E[x^2] - mean^2, 0),
//             rstd = rsqrt(var + eps), y = (x - mean) * rstd, then LeakyReLU;
//   backward: y recomputed from x, mean and rstd; g_y = g * lrelu'(y);
//             dx = rstd * (g_y - mean(g_y) - y * mean(g_y * y)).
//
// What bounds them on an H100: bytes. The forward does ~7 flops per element
// against 8 bytes moved at f32 (x in, y out), the backward ~10 against 12
// (x and g in, dx out), both far below the card's ~20 flop/byte balance
// point; at bf16 the bytes halve and the flops stay.
//
// Design: one block per (n, c) plane, both directions. The block reads its
// plane once with 16-byte loads (4 floats or 8 bfloat16s), keeps the raw
// elements in shared memory when they fit, block-reduces the plane's two
// sums, then makes its output from shared memory. So every input crosses
// device memory once and the output once, which is the byte floor. The
// backward caches x and g together: 128 KB for the largest f32 plane
// (128x128), under the 227 KB a block may use. Planes too large for the
// cache re-read their inputs (from L2 in practice). The TPU kernels' lane
// view (B, H, W*C), fold matrices and 8-row stat padding are TPU layout
// tricks and are not carried over: NCHW planes are contiguous here.
//
// K2f also takes channels_last (NHWC) tensors: the encoder runs in that
// layout on the card under bf16 autocast, because cuDNN's Hopper kernels
// take NHWC only. There an (n, c) plane is strided by C, and an image's
// planes together (1-2 MB at stage 0) outgrow one block's shared memory.
// So one thread-block cluster takes an image, or a group of its channels:
// its CTAs split the image's pixels, each caches its slice of pixel rows
// (cp.async, 16-byte channel vectors) and sums each channel's x and x^2
// from its cache; every CTA then adds up the cluster's partial sums over
// distributed shared memory behind one cluster barrier and normalizes its
// slice from its own cache. x is read once and y written once, as in the
// NCHW kernel. The plan (channel group, cluster size, pixels a CTA,
// threads) is `_nhwc_plan` of ops/fused_norm.py: groups of up to 128 bytes
// a pixel, slices of about 32 KB and at most 64 KB, so that three or more
// CTAs share an SM and one's stores overlap another's loads; clusters of
// up to 16 CTAs (above 8 needs the non-portable size) at stage 0, and of
// one for the small late-stage images.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFwdCacheBytes = 96 * 1024;
constexpr int kBwdCacheBytes = 128 * 1024;

// 16 bytes of T as floats: 4 floats or 8 bfloat16s.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of a and b over the block; every thread gets both totals.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < n_warps ? red[lane] : 0.f;
    b = lane < n_warps ? red[32 + lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      red[0] = a;
      red[32] = b;
    }
  }
  __syncthreads();
  a = red[0];
  b = red[32];
}

__device__ __forceinline__ float lrelu_norm(float v, float mean, float rstd, float slope) {
  const float t = (v - mean) * rstd;
  return t >= 0.f ? t : slope * t;
}

// K2f. grid: one block per plane. Dynamic shared memory: the plane's raw
// elements when cached. vec: the plane's length and both pointers allow
// 16-byte access.
template <typename T>
__global__ void __launch_bounds__(512)
    instance_norm_lrelu_fwd(const T* __restrict__ x, T* __restrict__ y,
                            float* __restrict__ mean_out, float* __restrict__ rstd_out, int hw,
                            float eps, float slope, int cached, int vec) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ uint4 smem[];
  __shared__ float red[64];
  const long long plane = blockIdx.x;
  const T* xp = x + plane * hw;
  T* yp = y + plane * hw;
  T* cache = reinterpret_cast<T*>(smem);

  float s = 0.f, ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xp);
    const int nv = hw / N;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 u = xv[i];
      float f[N];
      P::unpack(u, f);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s += f[j];
        ss += f[j] * f[j];
      }
      if (cached) smem[i] = u;
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const float v = P::load(xp + i);
      s += v;
      ss += v * v;
      if (cached) cache[i] = xp[i];
    }
  }
  block_sum2(s, ss, red);  // its barriers also publish the cache

  const float n = static_cast<float>(hw);
  const float mean = s / n;
  const float var = fmaxf(ss / n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (threadIdx.x == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }

  if (vec) {
    const uint4* src = cached ? smem : reinterpret_cast<const uint4*>(xp);
    uint4* yv = reinterpret_cast<uint4*>(yp);
    const int nv = hw / N;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      float f[N];
      P::unpack(src[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = lrelu_norm(f[j], mean, rstd, slope);
      yv[i] = P::pack(f);
    }
  } else {
    const T* src = cached ? cache : xp;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      P::store(yp + i, lrelu_norm(P::load(src + i), mean, rstd, slope));
    }
  }
}

// K2b. grid: one block per plane. Dynamic shared memory: the plane's raw x
// then its raw g, when cached.
template <typename T>
__global__ void __launch_bounds__(1024)
    instance_norm_lrelu_bwd(const T* __restrict__ x, const float* __restrict__ mean_in,
                            const float* __restrict__ rstd_in, const T* __restrict__ g,
                            T* __restrict__ dx, int hw, float slope, int cached, int vec) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ uint4 smem[];
  __shared__ float red[64];
  const long long plane = blockIdx.x;
  const T* xp = x + plane * hw;
  const T* gp = g + plane * hw;
  T* dxp = dx + plane * hw;
  const float mean = mean_in[plane];
  const float rstd = rstd_in[plane];

  // Pass 1: sum(g_y) and sum(g_y * y), caching the raw inputs.
  float sg = 0.f, sgy = 0.f;
  if (vec) {
    const int nv = hw / N;
    const uint4* xv = reinterpret_cast<const uint4*>(xp);
    const uint4* gv = reinterpret_cast<const uint4*>(gp);
    uint4* xc = smem;
    uint4* gc = smem + nv;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 ux = xv[i];
      const uint4 ug = gv[i];
      float fx[N], fg[N];
      P::unpack(ux, fx);
      P::unpack(ug, fg);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float yv = (fx[j] - mean) * rstd;
        const float gy = yv >= 0.f ? fg[j] : slope * fg[j];
        sg += gy;
        sgy += gy * yv;
      }
      if (cached) {
        xc[i] = ux;
        gc[i] = ug;
      }
    }
  } else {
    T* xc = reinterpret_cast<T*>(smem);
    T* gc = xc + hw;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const float yv = (P::load(xp + i) - mean) * rstd;
      const float gv = P::load(gp + i);
      const float gy = yv >= 0.f ? gv : slope * gv;
      sg += gy;
      sgy += gy * yv;
      if (cached) {
        xc[i] = xp[i];
        gc[i] = gp[i];
      }
    }
  }
  block_sum2(sg, sgy, red);  // its barriers also publish the cache

  const float n = static_cast<float>(hw);
  const float mean_g = sg / n;
  const float mean_gy = sgy / n;

  // Pass 2: dx from the cache (or from global memory again).
  if (vec) {
    const int nv = hw / N;
    const uint4* xs = cached ? smem : reinterpret_cast<const uint4*>(xp);
    const uint4* gs = cached ? smem + nv : reinterpret_cast<const uint4*>(gp);
    uint4* dxv = reinterpret_cast<uint4*>(dxp);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      float fx[N], fg[N];
      P::unpack(xs[i], fx);
      P::unpack(gs[i], fg);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float yv = (fx[j] - mean) * rstd;
        const float gy = yv >= 0.f ? fg[j] : slope * fg[j];
        fx[j] = rstd * (gy - mean_g - yv * mean_gy);
      }
      dxv[i] = P::pack(fx);
    }
  } else {
    const T* xs = cached ? reinterpret_cast<const T*>(smem) : xp;
    const T* gs = cached ? reinterpret_cast<const T*>(smem) + hw : gp;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const float yv = (P::load(xs + i) - mean) * rstd;
      const float gv = P::load(gs + i);
      const float gy = yv >= 0.f ? gv : slope * gv;
      P::store(dxp + i, rstd * (gy - mean_g - yv * mean_gy));
    }
  }
}

// The NHWC kernel's limits; ops/fused_norm.py's `_nhwc_plan` keeps to them.
constexpr int kNhwcThreads = 128;          // most threads a CTA
constexpr int kNhwcMaxGroup = 256;         // most channels a cluster reduces (plan: <= 128 B)
constexpr int kNhwcCacheBytes = 192 * 1024;  // most a CTA caches

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// A pixel's chunk of N channels: 16 bytes (kVec), or one element where C
// or an address does not allow 16-byte access.
template <typename T, bool kVec>
struct Chunk;

template <typename T>
struct Chunk<T, true> {
  using Raw = uint4;
  static constexpr int N = Pack<T>::N;
  __device__ __forceinline__ static Raw load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void store(T* p, const Raw& r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float* f) { Pack<T>::unpack(r, f); }
  __device__ __forceinline__ static Raw pack(const float* f) { return Pack<T>::pack(f); }
  __device__ __forceinline__ static void fetch(Raw* dst, const T* src) { cp_async16(dst, src); }
  __device__ __forceinline__ static void fetched() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

template <typename T>
struct Chunk<T, false> {
  using Raw = T;
  static constexpr int N = 1;
  __device__ __forceinline__ static Raw load(const T* p) { return *p; }
  __device__ __forceinline__ static void store(T* p, const Raw& r) { *p = r; }
  __device__ __forceinline__ static void unpack(const Raw& r, float* f) {
    f[0] = Pack<T>::load(&r);
  }
  __device__ __forceinline__ static Raw pack(const float* f) {
    Raw r;
    Pack<T>::store(&r, f[0]);
    return r;
  }
  __device__ __forceinline__ static void fetch(Raw* dst, const T* src) { *dst = *src; }
  __device__ __forceinline__ static void fetched() {}
};

// K2f into NHWC. grid: (image, channel group, CTA of the cluster), the
// last fastest; clusters of `cluster.num_blocks()` CTAs along x. A CTA
// takes pixels [rank * rows, rank * rows + rows) of its image and the
// group's `group` channels. Its threads are (pixel row, chunk column)
// pairs, blockDim = (group / N) * (rows in flight), for the NHWC output
// and, with an NHWC x, its input too: a thread keeps one column of chunks
// and reads back only what it fetched. With kNchwIn, x is NCHW (the first
// block's convolution, which cuDNN runs in NCHW for one input channel):
// the slice is cached channel by channel, its 16-byte chunks of pixels
// swizzled within each 128 bytes by the channel's output column so that
// the gather below hits 32 banks, a warp sums each channel, and the
// threads gather a pixel's channels from the cache to write NHWC. The
// second cluster barrier is split: a CTA arrives once it has read the
// cluster's sums and waits only before it exits, so no CTA idles there.
// Dynamic shared memory: the slice, rows x group elements, when cached.
template <typename T, bool kVec, bool kNchwIn>
__global__ void __launch_bounds__(kNhwcThreads)
    instance_norm_lrelu_fwd_nhwc(const T* __restrict__ x, T* __restrict__ y,
                                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                 int c, int hw, int group, int rows, float eps, float slope,
                                 int cached) {
  using C = Chunk<T, kVec>;
  using Raw = typename C::Raw;
  constexpr int N = C::N;
  extern __shared__ uint4 smem[];
  // Partial sums, [q * group + channel] for rows-in-flight index (or warp)
  // q; after the first cluster barrier, the group's mean and rstd.
  __shared__ float part[2][kNhwcThreads * 8];
  __shared__ float sums[2][kNhwcMaxGroup];  // this CTA's sums, read by the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long item = blockIdx.x / k;
  const int groups = c / group;
  const long long n = item / groups;
  const int g = static_cast<int>(item % groups);
  const int v = group / N;  // output chunks a pixel
  const int steps = blockDim.x / v;
  const int col = threadIdx.x % v;
  const int row0 = threadIdx.x / v;
  const int p0 = rank * rows;
  const int np = min(rows, hw - p0);
  T* ys = y + (n * hw + p0) * static_cast<long long>(c) + g * group + col * N;
  Raw* cache = reinterpret_cast<Raw*>(smem);
  // kNchwIn: channel ch of the group's slice at xp + ch * hw; else this
  // thread's column of pixel rows at xs + r * c.
  const T* xp = x + (n * c + g * group) * static_cast<long long>(hw) + p0;
  const T* xs = x + (n * hw + p0) * static_cast<long long>(c) + g * group + col * N;

  const int per_ch = rows / N;  // kNchwIn: cache chunks a channel (rows: a multiple of N)
  const bool swizzled = kVec && per_ch % 8 == 0;
  if constexpr (kNchwIn) {
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;  // whole warps; a ragged last one idles here
    if (cached) {
      for (int j = threadIdx.x; j < group * per_ch; j += blockDim.x) {
        const int ch = j / per_ch, q = j % per_ch;
        const int at = ch * per_ch + (swizzled ? q ^ ((ch / N) & 7) : q);
        if (q * N < np) C::fetch(cache + at, xp + static_cast<long long>(ch) * hw + q * N);
      }
      C::fetched();
      __syncthreads();
    }
    for (int ch = threadIdx.x >> 5; ch < group && (threadIdx.x >> 5) < warps; ch += warps) {
      float a = 0.f, b = 0.f;
      const int swz = swizzled ? (ch / N) & 7 : 0;
#pragma unroll 4
      for (int q = lane; q * N < np; q += 32) {
        float f[N];
        C::unpack(cached ? cache[ch * per_ch + (q ^ swz)]
                         : C::load(xp + static_cast<long long>(ch) * hw + q * N), f);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          a += f[j];
          b += f[j] * f[j];
        }
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        sums[0][ch] = a;
        sums[1][ch] = b;
      }
    }
  } else {
    if (cached) {
      for (int r = row0; r < np; r += steps) {
        C::fetch(cache + r * v + col, xs + static_cast<long long>(r) * c);
      }
      C::fetched();  // a thread reads back only its own chunks
    }
    float s[N], ss[N];
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = ss[j] = 0.f;
#pragma unroll 4
    for (int r = row0; r < np; r += steps) {
      float f[N];
      C::unpack(cached ? cache[r * v + col] : C::load(xs + static_cast<long long>(r) * c), f);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s[j] += f[j];
        ss[j] += f[j] * f[j];
      }
    }
    // Where a warp's lanes repeat columns (v divides 32), its lanes of one
    // column first add up by shuffles; part then has a row per warp.
    int parts = steps, slot = threadIdx.x;
    if (32 % v == 0) {
      for (int o = 16; o >= v; o >>= 1) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
          ss[j] += __shfl_xor_sync(0xffffffffu, ss[j], o);
        }
      }
      const int lane = threadIdx.x & 31;
      parts = blockDim.x >> 5;
      slot = lane < v ? (threadIdx.x >> 5) * v + lane : -1;
    }
    if (slot >= 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        part[0][slot * N + j] = s[j];
        part[1][slot * N + j] = ss[j];
      }
    }
    __syncthreads();
    for (int ch = threadIdx.x; ch < group; ch += blockDim.x) {
      float a = 0.f, b = 0.f;
      for (int q = 0; q < parts; ++q) {
        a += part[0][q * group + ch];
        b += part[1][q * group + ch];
      }
      sums[0][ch] = a;
      sums[1][ch] = b;
    }
  }
  cluster.sync();

  // Every CTA adds the cluster's sums in rank order, so all get the same
  // statistics; rank 0 stores them.
  const float count = static_cast<float>(hw);
  for (int ch = threadIdx.x; ch < group; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
#pragma unroll 4
    for (int q = 0; q < k; ++q) {
      const float* remote = cluster.map_shared_rank(&sums[0][0], q);
      a += remote[ch];
      b += remote[kNhwcMaxGroup + ch];
    }
    const float mean = a / count;
    const float var = fmaxf(b / count - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    part[0][ch] = mean;
    part[1][ch] = rstd;
    if (rank == 0) {
      mean_out[n * c + g * group + ch] = mean;
      rstd_out[n * c + g * group + ch] = rstd;
    }
  }
  // Done reading the cluster's sums; the matching wait is at the end, so
  // that no CTA leaves while another still reads its own.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();  // publishes part

  float mean[N], rstd[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mean[j] = part[0][col * N + j];
    rstd[j] = part[1][col * N + j];
  }
  const T* cached_el = reinterpret_cast<const T*>(smem);
  const int swz = swizzled ? col & 7 : 0;  // kNchwIn: the swizzle of this column's channels
#pragma unroll 4
  for (int r = row0; r < np; r += steps) {
    const long long at = static_cast<long long>(r) * c;
    float f[N];
    if constexpr (kNchwIn) {
      const int q = r / N, e = r % N;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int ch = col * N + j;
        f[j] = Pack<T>::load(cached ? cached_el + (ch * per_ch + (q ^ swz)) * N + e
                                    : xp + static_cast<long long>(ch) * hw + r);
      }
    } else {
      C::unpack(cached ? cache[r * v + col] : C::load(xs + at), f);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = lrelu_norm(f[j], mean[j], rstd[j], slope);
    C::store(ys + at, C::pack(f));
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Raise a kernel's dynamic shared-memory limit once per device; for a
// `clustered` kernel also ask for the SM's whole carveout as shared memory
// and allow clusters above the portable 8. The attributes are per device;
// setting them again from a racing thread is harmless. Each instantiation
// of the caller keeps its own flags.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done, bool clustered = false) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 64 && done[device]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && clustered) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess && clustered) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess && device < 64) done[device] = true;
  return e;
}

// About 16 elements per thread, between one warp and max_threads.
int threads_for(int hw, int max_threads) {
  int threads = 32;
  while (threads < max_threads && threads * 16 < hw) threads *= 2;
  return threads;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch_fwd(const void* x, void* y, void* mean, void* rstd, int planes, int hw, float eps,
               float slope, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t e = allow_smem(instance_norm_lrelu_fwd<T>, kFwdCacheBytes, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long bytes = static_cast<long long>(hw) * sizeof(T);
  const int cached = bytes <= kFwdCacheBytes;
  const int vec = (hw % Pack<T>::N == 0) && aligned16(x) && aligned16(y);
  const size_t smem = cached ? static_cast<size_t>(bytes) : 0;
  instance_norm_lrelu_fwd<T><<<planes, threads_for(hw, 512), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), hw, eps, slope, cached, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* mean, const void* rstd, const void* g, void* dx,
               int planes, int hw, float slope, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t e = allow_smem(instance_norm_lrelu_bwd<T>, kBwdCacheBytes, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long bytes = 2LL * hw * sizeof(T);
  const int cached = bytes <= kBwdCacheBytes;
  const int vec = (hw % Pack<T>::N == 0) && aligned16(x) && aligned16(g) && aligned16(dx);
  const size_t smem = cached ? static_cast<size_t>(bytes) : 0;
  instance_norm_lrelu_bwd<T><<<planes, threads_for(hw, 1024), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx), hw, slope, cached, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, bool kNchwIn>
int launch_fwd_nhwc(const void* x, void* y, void* mean, void* rstd, int n, int c, int hw,
                    int group, int cluster, int rows, int threads, int cached, float eps,
                    float slope, cudaStream_t stream) {
  static bool done[64] = {};
  const auto kernel = instance_norm_lrelu_fwd_nhwc<T, kVec, kNchwIn>;
  cudaError_t e = allow_smem(kernel, kNhwcCacheBytes, done, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(n) * (c / group) * cluster));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = cached ? static_cast<size_t>(rows) * group * sizeof(T) : 0;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<T*>(y),
                         static_cast<float*>(mean), static_cast<float*>(rstd), c, hw, group, rows,
                         eps, slope, cached);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, bool kNchwIn>
int launch_fwd_nhwc(const void* x, void* y, void* mean, void* rstd, int n, int c, int hw,
                    int group, int cluster, int rows, int threads, int cached, int vec, float eps,
                    float slope, cudaStream_t stream) {
  if (vec) {
    return launch_fwd_nhwc<T, true, kNchwIn>(x, y, mean, rstd, n, c, hw, group, cluster, rows,
                                             threads, cached, eps, slope, stream);
  }
  return launch_fwd_nhwc<T, false, kNchwIn>(x, y, mean, rstd, n, c, hw, group, cluster, rows,
                                            threads, cached, eps, slope, stream);
}

template <typename T>
int launch_fwd_nhwc(const void* x, void* y, void* mean, void* rstd, int n, int c, int hw,
                    int group, int cluster, int rows, int threads, int cached, int vec,
                    int nchw_in, float eps, float slope, cudaStream_t stream) {
  if (nchw_in) {
    return launch_fwd_nhwc<T, true>(x, y, mean, rstd, n, c, hw, group, cluster, rows, threads,
                                    cached, vec, eps, slope, stream);
  }
  return launch_fwd_nhwc<T, false>(x, y, mean, rstd, n, c, hw, group, cluster, rows, threads,
                                   cached, vec, eps, slope, stream);
}

}  // namespace

extern "C" {

// dtype: 0 for float32, 1 for bfloat16 (x, y, g and dx share it).
// x, y, g, dx: (planes, hw) contiguous; mean, rstd: (planes,) float32.
// Each returns cudaGetLastError() after its launch.

int latice_instance_norm_lrelu_fwd(const void* x, void* y, void* mean, void* rstd, int planes,
                                   int hw, float eps, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, y, mean, rstd, planes, hw, eps, slope, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, y, mean, rstd, planes, hw, eps, slope, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int latice_instance_norm_lrelu_bwd(const void* x, const void* mean, const void* rstd,
                                   const void* g, void* dx, int planes, int hw, float slope,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, mean, rstd, g, dx, planes, hw, slope, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(x, mean, rstd, g, dx, planes, hw, slope, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y: (n, hw, c) contiguous (an NCHW tensor in channels_last); x: the same,
// or with nchw_in (n, c, hw) contiguous; mean, rstd: (n, c) float32. group,
// cluster, rows, threads, cached and vec are ops/fused_norm.py's
// `_nhwc_plan` (vec: 16-byte chunks; its checks hold).
int latice_instance_norm_lrelu_fwd_nhwc(const void* x, void* y, void* mean, void* rstd, int n,
                                        int c, int hw, int group, int cluster, int rows,
                                        int threads, int cached, int vec, int nchw_in, float eps,
                                        float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group <= 0 || group > kNhwcMaxGroup || c % group || threads > kNhwcThreads ||
      (cached && static_cast<long long>(rows) * group * (dtype == 0 ? 4 : 2) > kNhwcCacheBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_fwd_nhwc<float>(x, y, mean, rstd, n, c, hw, group, cluster, rows, threads,
                                  cached, vec, nchw_in, eps, slope, s);
  }
  if (dtype == 1) {
    return launch_fwd_nhwc<__nv_bfloat16>(x, y, mean, rstd, n, c, hw, group, cluster, rows,
                                          threads, cached, vec, nchw_in, eps, slope, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
