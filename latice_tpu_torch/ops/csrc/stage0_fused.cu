// The VAE encoder's stage 0, fused (K3): Conv3x3(1->C) + b1 -> InstanceNorm
// -> LeakyReLU -> bf16 -> Conv3x3(C->C) + b2 -> InstanceNorm -> LeakyReLU ->
// bf16 -> 2x2 max-pool, forward only, over (B, 1, H, W) float32 images; the
// output is (B, C, H/2, W/2) bfloat16, NCHW.
//
// Replaces the TPU kernel of latice_tpu/ops/stage0_fused.py: stage0_fused
// (body _kernel, pallas_call in stage0_fused), with its numerics: x, w1 and
// w2 rounded to bf16, every product exact in f32 and summed in f32, the
// biases added after the taps; statistics in f32 with var = max(E[v^2] -
// mean^2, 0); y1 rounded to bf16 before conv2; conv2's SAME padding is zeros
// of the normalized y1. The TPU kernel's 4-image lane packing and
// block-diagonal weights are TPU layout tricks and are not carried over.
//
// What bounds it on an H100: operations. conv2 is 2*9*C*C flops per pixel
// (18,432 at C=32), conv1 2*9*C; at B=256, 128x128, C=32 that is ~80 GFLOP,
// 0.081 ms at the 989 TFLOP/s bf16 tensor-core peak, against ~82 MB of
// unavoidable bytes (x in, the pooled bf16 out), 0.025 ms at 3.35 TB/s.
//
// Design: three launches, no float atomics, so repeated runs are bitwise
// equal. InstanceNorm needs a whole image's statistics before conv2 can
// start, and one image's C=32 activation (1 MiB in bf16) is larger than a
// block's shared memory.
//   (a) conv1_stats: one block per image computes conv1 + b1 at every pixel
//       and reduces each channel's sum and sum of squares in a fixed order
//       into (mean, rstd).
//   (b) conv2: one block per 16x16 output tile recomputes conv1 on the tile
//       plus a 1-pixel halo from x (9 FMAs a channel), normalizes, applies
//       LeakyReLU, rounds to bf16 and zeroes the halo outside the image into
//       shared memory; then conv2 runs as an implicit GEMM (M = 256 pixels,
//       N = C, K = 9*C) on the tensor cores, mma.sync m16n8k16 with bf16
//       operands and f32 accumulation, each warp owning two output rows.
//       acc2 + b2 goes to device memory in f32 with the tile's per-channel
//       partial sums.
//   (c) finish: one block per (image, channel) plane sums the tile partials
//       in order, then normalizes, applies LeakyReLU, rounds to bf16 and
//       max-pools. Normalization with rstd > 0, LeakyReLU and bf16 rounding
//       are all monotone non-decreasing, so the max of the transformed
//       values equals the transform of the max: the kernel pools the f32
//       acc2 first and transforms one value per output, exactly equal to
//       pooling the bf16 activations.
// The f32 acc2 round trip (~1.07 GB at B=256, C=32: 0.32 ms at 3.35 TB/s)
// is this design's own byte floor; keeping acc2 on chip is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;          // output pixels per tile side
constexpr int kHalo = kTile + 2;   // y1 tile with its 1-pixel halo
constexpr int kXTile = kTile + 4;  // x tile feeding the halo's conv1
constexpr int kWarps = 8;          // warp w owns output rows 2w and 2w+1
constexpr int kThreads = 32 * kWarps;
constexpr int kStatsThreads = 512;

// Shared memory of the conv2 block, in order: y1 tile [kHalo][kHalo][kPitch]
// and w2 [9][C][kPitch] as bf16 (a pixel's or an output channel's C inputs
// contiguous, padded by 8 so that the fragment loads of one warp hit 32
// distinct banks), then the x tile, conv1's weights and bias, stats1 and the
// cross-warp reduction, as f32.
template <int C>
struct Conv2Smem {
  static constexpr int kPitch = C + 8;
  static constexpr int kY1 = kHalo * kHalo * kPitch;
  static constexpr int kW2 = 9 * C * kPitch;
  static constexpr int kFloats = kXTile * kXTile + 9 * C + 3 * C + kWarps * C * 2;
  static constexpr int kBytes = 2 * (kY1 + kW2) + 4 * kFloats;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : slope * v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// conv1 + b1 of one channel at one pixel, from the pixel's 3x3 neighbourhood
// nb (bf16-rounded x, zero outside the image) and the channel's bf16-rounded
// taps w, both row-major. The products are exact in f32, so each fmaf adds
// one exact product, in the TPU kernel's tap order; the bias comes last.
__device__ __forceinline__ float conv1_at(const float* nb, const float* w, float bias) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) acc = fmaf(nb[k], w[k], acc);
  return acc + bias;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a) grid: one block per image. stats1: (B, C, 2) = (mean, rstd) of conv1 + b1.
template <int C>
__global__ void __launch_bounds__(kStatsThreads)
    stage0_conv1_stats(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, float* __restrict__ stats1, int h, int w,
                       float eps) {
  __shared__ float ws[9 * C];
  __shared__ float bs[C];
  __shared__ float red[kStatsThreads / 32][2][8];
  const int b = blockIdx.x;
  const float* xi = x + static_cast<long long>(b) * h * w;
  for (int i = threadIdx.x; i < 9 * C; i += blockDim.x) ws[i] = bf16_round(w1[i]);
  for (int i = threadIdx.x; i < C; i += blockDim.x) bs[i] = b1[i];
  __syncthreads();

  const int hw = h * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int c0 = 0; c0 < C; c0 += 8) {
    float s[8] = {}, ss[8] = {};
    for (int p = threadIdx.x; p < hw; p += blockDim.x) {
      const int y = p / w, xx = p - (p / w) * w;
      float nb[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int yy = y + k / 3 - 1, xk = xx + k % 3 - 1;
        const bool in = yy >= 0 && yy < h && xk >= 0 && xk < w;
        nb[k] = in ? bf16_round(__ldg(xi + yy * w + xk)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = conv1_at(nb, ws + (c0 + j) * 9, bs[c0 + j]);
        s[j] += v;
        ss[j] = fmaf(v, v, ss[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = warp_sum(s[j]);
      ss[j] = warp_sum(ss[j]);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[warp][0][j] = s[j];
        red[warp][1][j] = ss[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < 8) {
      float ts = 0.f, tss = 0.f;
      for (int i = 0; i < n_warps; ++i) {
        ts += red[i][0][threadIdx.x];
        tss += red[i][1][threadIdx.x];
      }
      const float n = static_cast<float>(hw);
      const float mean = ts / n;
      const float var = fmaxf(tss / n - mean * mean, 0.f);
      float* out = stats1 + (static_cast<long long>(b) * C + c0 + threadIdx.x) * 2;
      out[0] = mean;
      out[1] = rsqrtf(var + eps);
    }
    __syncthreads();
  }
}

// (b) grid: (tiles, B). w2t: (9, C, C) bf16, [ky*3+kx][co][ci]. acc2: (B, C,
// H, W) f32. part: (B, tiles, C, 2) per-tile (sum, sum of squares) of acc2.
template <int C>
__global__ void __launch_bounds__(kThreads)
    stage0_conv2(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ stats1,
                 const __nv_bfloat16* __restrict__ w2t, const float* __restrict__ b2,
                 float* __restrict__ acc2, float* __restrict__ part, int h, int w, int tiles_x,
                 float slope) {
  using S = Conv2Smem<C>;
  constexpr int P = S::kPitch;
  constexpr int NT = C / 8;  // n-tiles of 8 output channels
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws2 = ys + S::kY1;
  float* xs = reinterpret_cast<float*>(ws2 + S::kW2);
  float* w1s = xs + kXTile * kXTile;
  float* b1s = w1s + 9 * C;
  float* mean1 = b1s + C;
  float* rstd1 = mean1 + C;
  float* red = rstd1 + C;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTile;
  const int tx0 = (tile % tiles_x) * kTile;
  const float* xi = x + static_cast<long long>(b) * h * w;

  // Stage x (bf16-rounded, zero outside the image), conv1's weights, stats1
  // and w2 (16-byte copies of its rows into the padded layout).
  for (int i = tid; i < kXTile * kXTile; i += kThreads) {
    const int yy = ty0 - 2 + i / kXTile, xx = tx0 - 2 + i % kXTile;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    xs[i] = in ? bf16_round(__ldg(xi + yy * w + xx)) : 0.f;
  }
  for (int i = tid; i < 9 * C; i += kThreads) w1s[i] = bf16_round(w1[i]);
  for (int i = tid; i < C; i += kThreads) {
    b1s[i] = b1[i];
    mean1[i] = stats1[(static_cast<long long>(b) * C + i) * 2];
    rstd1[i] = stats1[(static_cast<long long>(b) * C + i) * 2 + 1];
  }
  for (int i = tid; i < 9 * C * (C / 8); i += kThreads) {
    const int row = i / (C / 8), q = i % (C / 8);
    *reinterpret_cast<uint4*>(ws2 + row * P + q * 8) =
        reinterpret_cast<const uint4*>(w2t + static_cast<long long>(row) * C)[q];
  }
  __syncthreads();

  // y1 over the halo tile, two channels per item: conv1, norm, LeakyReLU,
  // bf16; zero outside the image (SAME padding of the normalized y1).
  for (int i = tid; i < kHalo * kHalo * (C / 2); i += kThreads) {
    const int pix = i / (C / 2), c = 2 * (i % (C / 2));
    const int hy = pix / kHalo, hx = pix % kHalo;
    const int yy = ty0 - 1 + hy, xx = tx0 - 1 + hx;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      float nb[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) nb[k] = xs[(hy + k / 3) * kXTile + hx + k % 3];
      const float a0 = conv1_at(nb, w1s + c * 9, b1s[c]);
      const float a1 = conv1_at(nb, w1s + (c + 1) * 9, b1s[c + 1]);
      v = __floats2bfloat162_rn(lrelu((a0 - mean1[c]) * rstd1[c], slope),
                                lrelu((a1 - mean1[c + 1]) * rstd1[c + 1], slope));
    }
    *reinterpret_cast<__nv_bfloat162*>(ys + pix * P + c) = v;
  }
  __syncthreads();

  // conv2: per warp, two m16 tiles (output rows 2w, 2w+1; 16 pixels each)
  // times NT n8 tiles, K walked tap by tap in chunks of 16 input channels.
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][NT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
#pragma unroll
    for (int kc = 0; kc < C; kc += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat16* row = ys + ((2 * warp + r + ky) * kHalo + kx) * P + kc + 2 * t;
        a[r][0] = ld32(row + g * P);
        a[r][1] = ld32(row + (g + 8) * P);
        a[r][2] = ld32(row + g * P + 8);
        a[r][3] = ld32(row + (g + 8) * P + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* wrow = ws2 + (tap * C + j * 8 + g) * P + kc + 2 * t;
        const uint32_t b0 = ld32(wrow), b1v = ld32(wrow + 8);
        mma_bf16(acc[0][j], a[0], b0, b1v);
        mma_bf16(acc[1][j], a[1], b0, b1v);
      }
    }
  }

  // Epilogue: + b2, acc2 to device memory, the tile's per-channel sums.
  // Fragment element e of (r, j) is output row 2*warp + r, column g + 8*(e/2),
  // channel j*8 + 2t + e%2.
  float s[NT][2], ss[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = ss[j][0] = ss[j][1] = 0.f;
  }
  float* acc2_b = acc2 + static_cast<long long>(b) * C * h * w;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int oy = ty0 + 2 * warp + r;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = j * 8 + 2 * t + (e & 1);
        const int ox = tx0 + g + 8 * (e >> 1);
        if (oy < h && ox < w) {
          const float v = acc[r][j][e] + __ldg(b2 + co);
          acc2_b[(static_cast<long long>(co) * h + oy) * w + ox] = v;
          s[j][e & 1] += v;
          ss[j][e & 1] = fmaf(v, v, ss[j][e & 1]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], o);
        ss[j][e] += __shfl_xor_sync(0xffffffffu, ss[j][e], o);
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = j * 8 + 2 * t + e;
        red[(warp * C + co) * 2] = s[j][e];
        red[(warp * C + co) * 2 + 1] = ss[j][e];
      }
    }
  }
  __syncthreads();
  if (tid < 2 * C) {
    const int c = tid >> 1, which = tid & 1;
    float v = 0.f;
    for (int i = 0; i < kWarps; ++i) v += red[(i * C + c) * 2 + which];
    const long long tiles = static_cast<long long>(gridDim.x);
    part[((static_cast<long long>(b) * tiles + tile) * C + c) * 2 + which] = v;
  }
}

// (c) grid: one block per (image, channel) plane. out: (B, C, H/2, W/2) bf16.
__global__ void __launch_bounds__(256)
    stage0_finish(const float* __restrict__ acc2, const float* __restrict__ part,
                  __nv_bfloat16* __restrict__ out, int channels, int tiles, int h, int w,
                  float eps, float slope) {
  __shared__ float st[2];
  const long long plane = blockIdx.x;
  const long long b = plane / channels;
  const int c = static_cast<int>(plane % channels);
  if (threadIdx.x == 0) {
    float s = 0.f, ss = 0.f;
    for (int i = 0; i < tiles; ++i) {
      const float* p = part + ((b * tiles + i) * channels + c) * 2;
      s += p[0];
      ss += p[1];
    }
    const float n = static_cast<float>(h) * static_cast<float>(w);
    const float mean = s / n;
    const float var = fmaxf(ss / n - mean * mean, 0.f);
    st[0] = mean;
    st[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = st[0], rstd = st[1];
  const int oh = h / 2, ow = w / 2;
  const float* src = acc2 + plane * h * w;
  __nv_bfloat16* dst = out + plane * oh * ow;
  for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
    const int oy = i / ow, ox = i - (i / ow) * ow;
    const float2 top = *reinterpret_cast<const float2*>(src + (2 * oy) * w + 2 * ox);
    const float2 bot = *reinterpret_cast<const float2*>(src + (2 * oy + 1) * w + 2 * ox);
    const float m = fmaxf(fmaxf(top.x, top.y), fmaxf(bot.x, bot.y));
    dst[i] = __float2bfloat16(lrelu((m - mean) * rstd, slope));
  }
}

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

template <int C>
int launch(const float* x, const float* w1, const float* b1, const __nv_bfloat16* w2t,
           const float* b2, float* stats1, float* acc2, float* part, __nv_bfloat16* out,
           int batch, int h, int w, float eps, float slope, cudaStream_t stream) {
  static bool done[64] = {};
  constexpr int smem = Conv2Smem<C>::kBytes;
  cudaError_t e = allow_smem(stage0_conv2<C>, smem, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles = tiles_x * ((h + kTile - 1) / kTile);
  stage0_conv1_stats<C><<<batch, kStatsThreads, 0, stream>>>(x, w1, b1, stats1, h, w, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stage0_conv2<C><<<dim3(tiles, batch), kThreads, smem, stream>>>(
      x, w1, b1, stats1, w2t, b2, acc2, part, h, w, tiles_x, slope);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stage0_finish<<<batch * C, 256, 0, stream>>>(acc2, part, out, C, tiles, h, w, eps, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (batch, 1, h, w) f32; w1: (C, 1, 3, 3) f32; b1, b2: (C,) f32;
// w2t: (3, 3, C, C) bf16 = w2 (C, C, 3, 3) permuted to [ky][kx][co][ci];
// scratch stats1 (batch, C, 2), acc2 (batch, C, h, w) and part (batch,
// tiles, C, 2) f32, tiles = ceil(h/16) * ceil(w/16); out: (batch, C, h/2,
// w/2) bf16. h and w even. C is 16, 32 or 64. Returns cudaGetLastError()
// after the launches.
int latice_stage0_fused(const void* x, const void* w1, const void* b1, const void* w2t,
                        const void* b2, void* stats1, void* acc2, void* part, void* out,
                        int batch, int channels, int h, int w, float eps, float slope,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const __nv_bfloat16* w2b = static_cast<const __nv_bfloat16*>(w2t);
  const float* b2f = static_cast<const float*>(b2);
  float* st = static_cast<float*>(stats1);
  float* a2 = static_cast<float*>(acc2);
  float* pt = static_cast<float*>(part);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (channels) {
    case 16: return launch<16>(xf, w1f, b1f, w2b, b2f, st, a2, pt, o, batch, h, w, eps, slope, s);
    case 32: return launch<32>(xf, w1f, b1f, w2b, b2f, st, a2, pt, o, batch, h, w, eps, slope, s);
    case 64: return launch<64>(xf, w1f, b1f, w2b, b2f, st, a2, pt, o, batch, h, w, eps, slope, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
