// Fused InstanceNorm(affine=False) + LeakyReLU forward over NCHW float32.
//
// Replaces the TPU kernel latice_tpu/ops/fused_norm.py:instance_norm_leaky_relu
// (forward body _fwd_kernel, pallas_call in _fwd). Same numerics: one pass
// for E[x] and E[x^2] in f32, var = max(E[x^2] - mean^2, 0),
// rstd = rsqrt(var + eps), y = (x - mean) * rstd, then LeakyReLU.
//
// What bounds it on an H100: bytes. It does ~6 flops per element against
// 8 bytes moved (x read once, y written once), far below the card's
// ~20 flop/byte balance point, so the floor is 8 B/element over HBM bandwidth.
//
// Design: one block per (n, c) plane. The block reads the plane once with
// 16-byte loads, keeps it in shared memory when it fits (the encoder's
// largest plane, 128x128 f32, is 64 KB), block-reduces sum and sum of
// squares, then normalizes and activates from shared memory. So x crosses
// device memory once and y once, which is the byte floor. Planes too large
// for the cache re-read x (from L2 in practice). The TPU kernel's lane view
// (B, H, W*C), fold matrices and 8-row stat padding are TPU layout tricks
// and are not carried over: NCHW planes are contiguous here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCacheBytes = 96 * 1024;

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

// grid: one block per plane. Dynamic shared memory: hw floats when cached.
__global__ void instance_norm_lrelu_fwd(const float* __restrict__ x, float* __restrict__ y,
                                        float* __restrict__ mean_out,
                                        float* __restrict__ rstd_out, int hw, float eps,
                                        float slope, int cached, int vec) {
  extern __shared__ float4 cache4[];
  __shared__ float red[64];
  float* cache = reinterpret_cast<float*>(cache4);
  const long long plane = blockIdx.x;
  const float* xp = x + plane * hw;
  float* yp = y + plane * hw;

  float s = 0.f, ss = 0.f;
  if (vec) {
    const float4* xp4 = reinterpret_cast<const float4*>(xp);
    const int n4 = hw >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = xp4[i];
      s += (v.x + v.y) + (v.z + v.w);
      ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      if (cached) cache4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const float v = xp[i];
      s += v;
      ss += v * v;
      if (cached) cache[i] = v;
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
    const float4* src4 = cached ? cache4 : reinterpret_cast<const float4*>(xp);
    float4* yp4 = reinterpret_cast<float4*>(yp);
    const int n4 = hw >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = src4[i];
      yp4[i] = make_float4(lrelu_norm(v.x, mean, rstd, slope), lrelu_norm(v.y, mean, rstd, slope),
                           lrelu_norm(v.z, mean, rstd, slope), lrelu_norm(v.w, mean, rstd, slope));
    }
  } else {
    const float* src = cached ? cache : xp;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      yp[i] = lrelu_norm(src[i], mean, rstd, slope);
    }
  }
}

}  // namespace

extern "C" {

// x, y: (planes, hw) contiguous f32; mean, rstd: (planes,) f32.
// Returns cudaGetLastError() after the launch.
int latice_instance_norm_lrelu_fwd(const void* x, void* y, void* mean, void* rstd, int planes,
                                   int hw, float eps, float slope, void* stream) {
  // The attribute is per device; set it once for each (setting it again
  // from a racing thread is harmless).
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !attr_set[device]) {
    e = cudaFuncSetAttribute(instance_norm_lrelu_fwd,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxCacheBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) attr_set[device] = true;
  }
  const long long bytes = static_cast<long long>(hw) * 4;
  const int cached = bytes <= kMaxCacheBytes;
  const int vec = (hw % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  // About 16 elements per thread, between one warp and 512 threads.
  int threads = 32;
  while (threads < 512 && threads * 16 < hw) threads *= 2;
  const size_t smem = cached ? static_cast<size_t>(bytes) : 0;
  instance_norm_lrelu_fwd<<<planes, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), hw, eps, slope, cached, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
