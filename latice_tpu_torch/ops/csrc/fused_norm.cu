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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Raise a kernel's dynamic shared-memory limit once per device. The
// attribute is per device; setting it again from a racing thread is
// harmless. Each instantiation of the caller keeps its own flags.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 64 && done[device]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
