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
// Both convolutions run on the tensor cores as wgmma.mma_async m64nCk16
// with bf16 operands and f32 accumulation: conv1 with K = its 9 taps padded
// to 16, conv2 with K = 9*C walked tap by tap.
//
// Design: three launches, no float atomics, so repeated runs are bitwise
// equal. InstanceNorm needs a whole image's statistics before conv2 can
// start, and one image's C=32 activation (1 MiB in bf16) is larger than a
// block's shared memory.
//   (a) conv1_stats: one block of four warpgroups per image computes conv1
//       + b1 at every pixel on the tensor cores and reduces each channel's
//       sum and sum of squares in a fixed order into (mean, rstd).
//   (b) conv2, persistent: about two blocks per SM (the grid comes from the
//       wrapper's planner) each stage w1, b1 and w2 once, then walk (image,
//       16x32 tile) work items in a fixed order, item blockIdx.x + k *
//       gridDim.x. While one item computes, the next item's 20x36 x window
//       and its image's (mean, rstd) arrive by cp.async. Per item:
//       - conv1 on the tile plus a 1-pixel halo (18x34 pixels) on the
//         tensor cores, 64 pixels at a time, then norm, LeakyReLU and bf16
//         into shared memory; zero outside the image.
//       - conv2 as an implicit GEMM on wgmma.mma_async m64nCk16 (bf16 in,
//         f32 accumulate): each of the two warpgroups owns two row pairs
//         (2 x 64 output pixels, each 2 rows x 32 columns) at a time, their
//         wgmma chains interleaved, and walks K = 9*C tap by tap. A comes
//         from registers through ldmatrix (each tap's shifted window does
//         not line up with a shared-memory descriptor's 8-row core
//         matrices; registers take any shift), double-buffered across taps;
//         B (w2) comes from shared memory in the canonical K-major layout
//         through a descriptor.
//       - epilogue: + b2, each channel's sum and sum of squares over every
//         pixel, and the 2x2 max of acc2 = conv2 + b2 (a thread holds both
//         rows of a pool window, lane ^ 4 the other column) in f32, staged
//         in shared memory and written 16 bytes a thread.
//       The tile's partial sums go to device memory, reduced across warps in
//       a fixed order.
//   (c) finish: one block per (image, channel) plane; one warp sums the tile
//       partials in a fixed order (lane-strided, then a butterfly), then the
//       block normalizes, applies LeakyReLU and rounds the pooled maxima to
//       bf16. Normalization with rstd > 0, LeakyReLU and bf16 rounding are
//       all monotone non-decreasing, so the max of the transformed values
//       equals the transform of the max: pooling the f32 acc2 first is
//       exactly equal to pooling the bf16 activations.
// The pooled f32 maxima make a round trip through device memory (~0.27 GB
// at B=256, C=32: 0.08 ms at 3.35 TB/s), this design's own byte floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16, kTileW = 32;              // output pixels per tile
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2;  // y1 tile and its halo
constexpr int kXH = kTileH + 4, kXW = kTileW + 4;        // x window of the halo's conv1
constexpr int kPoolW = kTileW / 2;                      // pooled columns of a tile
constexpr int kHaloPix = kHaloH * kHaloW;
constexpr int kHaloTiles = (kHaloPix + 63) / 64;         // m64 tiles of conv1 on the halo
constexpr int kThreads = 256;                        // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kStatsThreads = 512;     // four warpgroups

// Shared memory of the conv2 block, in order: w2 (9 taps x C x C bf16 in
// wgmma's canonical K-major layout: [tap][ci/8][co/8][co%8][ci%8], each 8x8
// core matrix 128 contiguous bytes), w1 as conv1's B operand (stage_w1), the
// y1 halo tile [kHaloH][kHaloW][kPitch] bf16 (a pixel's C channels
// contiguous, padded by 8 so that ldmatrix's rows and the epilogue's stores
// hit distinct banks), two x windows and two (mean, rstd) tables (cp.async
// double buffer), the cross-warp reduction, and the pooled maxima of a row
// pair per warpgroup, two buffers each, on their way to device memory.
// ops/stage0_fused.py:_smem_bytes mirrors kBytes.
template <int C>
struct Conv2Smem {
  static constexpr int kPitch = C + 8;
  static constexpr int kW2 = 9 * C * C * 2;
  static constexpr int kW1 = 16 * C * 2;
  static constexpr int kY1 = kHaloH * kHaloW * kPitch * 2;
  static constexpr int kX = 2 * kXH * kXW * 4;
  static constexpr int kStats = 2 * C * 2 * 4;
  static constexpr int kRed = kWarps * C * 2 * 4;
  static constexpr int kStage = 2 * 2 * C * kPoolW * 4;
  static constexpr int kBytes = kW2 + kW1 + kY1 + kX + kStats + kRed + kStage;
};

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : slope * v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A wgmma shared-memory matrix descriptor, no swizzle: start address, the
// byte offset between core matrices along K (leading) and along M or N
// (stride), each in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of the generic proxy made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Named barrier `id` among the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d (64 x N, f32, wgmma's accumulator layout) += a (64 x 16 bf16, four
// registers a thread, mma.sync's A layout per warp) * b (16 x N bf16, from
// the descriptor), all 128 threads of the warpgroup together.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t desc) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t desc) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// conv1 runs on the tensor cores as wgmma m64nCk16: 64 pixels (M) by C
// channels (N) by K = 16, the 9 taps and 7 zeros. Products of bf16 x and
// bf16 w1 are exact in f32 and summed in f32; the bias comes after the taps.
// B is w1 as a 16 x C matrix in the canonical K-major layout
// [tap/8][c/8][c%8][tap%8], 32*C bytes, staged here by nthreads threads.
template <int C>
__device__ __forceinline__ void stage_w1(const float* __restrict__ w1, __nv_bfloat16* w1c,
                                         int nthreads) {
  for (int i = threadIdx.x; i < 16 * C; i += nthreads) {
    const int tap = 8 * (i / (8 * C)) + i % 8, c = 8 * ((i / 64) % (C / 8)) + (i / 8) % 8;
    w1c[i] = __float2bfloat16(tap < 9 ? w1[c * 9 + tap] : 0.f);
  }
}

// conv1's A fragment for this thread's two M rows (mma.sync's A layout per
// warp: K columns 2t, 2t+1, 2t+8, 2t+9) from v[r] = row r's inputs at taps
// 2t, 2t+1 and 8; tap 8 is column 2t+8 of t == 0 alone, and columns 9..15
// are zero. The inputs are rounded to bf16 here.
__device__ __forceinline__ void conv1_fragment(uint32_t* a, const float (&v)[2][3], int t) {
  a[0] = pack_bf16(v[0][0], v[0][1]);
  a[1] = pack_bf16(v[1][0], v[1][1]);
  a[2] = pack_bf16(t == 0 ? v[0][2] : 0.f, 0.f);
  a[3] = pack_bf16(t == 0 ? v[1][2] : 0.f, 0.f);
}

// The inputs at taps 2t, 2t+1 and 8 (row offsets dy, column offsets dx) of
// this thread's two pixels (rows y, columns xx) of an h x w image, zero
// outside the image (SAME padding) and past its last row.
__device__ __forceinline__ void conv1_inputs(float (&v)[2][3], const float* __restrict__ xi,
                                             const int (&y)[2], const int (&xx)[2],
                                             const int (&dy)[3], const int (&dx)[3], int h,
                                             int w) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int yy = y[r] + dy[i], xk = xx[r] + dx[i];
      const bool in = static_cast<unsigned>(yy) < static_cast<unsigned>(h) &&
                      static_cast<unsigned>(xk) < static_cast<unsigned>(w) && y[r] < h;
      v[r][i] = in ? __ldg(xi + yy * w + xk) : 0.f;
    }
  }
}

// (a) grid: one block per image. stats1: (B, C, 2) = (mean, rstd) of conv1 + b1.
// Each warpgroup takes every other m64 tile of the image's pixels, loading
// the next tile's inputs while this one's wgmma runs; a thread sums its
// pixels' values per channel, and the sums are reduced over lanes by a
// butterfly and over warps in order.
template <int C>
__global__ void __launch_bounds__(kStatsThreads)
    stage0_conv1_stats(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, float* __restrict__ stats1, int h, int w,
                       float eps) {
  constexpr int NG = C / 8;
  constexpr int kGroups = kStatsThreads / 128;  // warpgroups
  __shared__ __align__(128) __nv_bfloat16 w1c[16 * C];
  __shared__ float red[kStatsThreads / 32][2 * C];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, wq = warp & 3;
  const int b = blockIdx.x, hw = h * w;
  const float* xi = x + static_cast<long long>(b) * hw;
  stage_w1<C>(w1, w1c, kStatsThreads);
  fence_async_smem();
  __syncthreads();

  float b1r[NG][2], s[NG][2], ss[NG][2];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b1r[j][e] = __ldg(b1 + 8 * j + 2 * t + e);
      s[j][e] = ss[j][e] = 0.f;
    }
  }
  const uint64_t desc = wgmma_desc(smem_u32(w1c), NG * 128, 128);
  const int n_tiles = (hw + 63) / 64;
  const int row = 16 * wq + g;  // this thread's M rows: row and row + 8
  int dy[3], dx[3];             // offsets of its taps 2t, 2t+1, 8
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int tap = i < 2 ? 2 * t + i : 8;
    dy[i] = tap / 3 - 1;
    dx[i] = tap % 3 - 1;
  }
  // Its pixels' coordinates, moved on by 64 * kGroups pixels a tile.
  const int sy = 64 * kGroups / w, sx = 64 * kGroups - sy * w;
  int y[2], xx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 64 * wg + row + 8 * r;
    y[r] = p / w;
    xx[r] = p - y[r] * w;
  }
  float v[2][3];
  conv1_inputs(v, xi, y, xx, dy, dx, h, w);
#pragma unroll 1
  for (int q = wg; q < n_tiles; q += kGroups) {
    uint32_t a[4];
    conv1_fragment(a, v, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xx[r] += sx;
      y[r] += sy;
      if (xx[r] >= w) {
        xx[r] -= w;
        ++y[r];
      }
    }
    conv1_inputs(v, xi, y, xx, dy, dx, h, w);  // the next tile's, under this one's wgmma
    float acc[C / 2];
#pragma unroll
    for (int k = 0; k < C / 2; ++k) acc[k] = 0.f;
    wgmma_fence();
    wgmma_rs<C>(acc, a, desc);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < C / 2; ++k) fence_operand(acc[k]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (64 * q + row + 8 * r < hw) {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float val = acc[4 * j + 2 * r + e] + b1r[j][e];
            s[j][e] += val;
            ss[j][e] = fmaf(val, val, ss[j][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NG; ++j) {
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
    for (int j = 0; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp][2 * (8 * j + 2 * t + e)] = s[j][e];
        red[warp][2 * (8 * j + 2 * t + e) + 1] = ss[j][e];
      }
    }
  }
  __syncthreads();
  if (tid < C) {
    float ts = 0.f, tss = 0.f;
    for (int i = 0; i < kStatsThreads / 32; ++i) {
      ts += red[i][2 * tid];
      tss += red[i][2 * tid + 1];
    }
    const float n = static_cast<float>(hw);
    const float mean = ts / n;
    const float var = fmaxf(tss / n - mean * mean, 0.f);
    float* out = stats1 + (static_cast<long long>(b) * C + tid) * 2;
    out[0] = mean;
    out[1] = rsqrtf(var + eps);
  }
}

// The x window of work item `item` (zeros outside the image) and its image's
// (mean, rstd) into buffer `buf`, by cp.async; the caller commits.
template <int C>
__device__ __forceinline__ void load_window(const float* __restrict__ x,
                                            const float* __restrict__ stats1, float* xs,
                                            float* st, int item, int tiles, int tiles_x, int h,
                                            int w) {
  const int b = item / tiles, tile = item - (item / tiles) * tiles;
  const int y0 = (tile / tiles_x) * kTileH - 2, x0 = (tile % tiles_x) * kTileW - 2;
  const float* xi = x + static_cast<long long>(b) * h * w;
  for (int i = threadIdx.x; i < kXH * kXW; i += kThreads) {
    const int yy = y0 + i / kXW, xx = x0 + i % kXW;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    cp_async4(smem_u32(xs + i), in ? xi + yy * w + xx : xi, in);
  }
  if (threadIdx.x < C / 2) {
    cp_async16(smem_u32(st + 4 * threadIdx.x),
               stats1 + static_cast<long long>(b) * C * 2 + 4 * threadIdx.x);
  }
}

// (b) grid: `blocks` persistent blocks (the wrapper's plan). w2c: w2 as bf16
// in the canonical layout of Conv2Smem. pooled: (B, C, H/2, W/2) f32, the
// 2x2 maxima of acc2 = conv2 + b2. part: (B, tiles, C, 2) per-tile (sum, sum
// of squares) of acc2.
template <int C>
__global__ void __launch_bounds__(kThreads, C == 64 ? 1 : 2)
    stage0_conv2(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ stats1,
                 const __nv_bfloat16* __restrict__ w2c, const float* __restrict__ b2,
                 float* __restrict__ pooled, float* __restrict__ part, int batch, int h, int w,
                 int tiles_x, int tiles, float slope) {
  using S = Conv2Smem<C>;
  constexpr int P = S::kPitch;
  constexpr int KC = C / 16;  // k16 chunks of one tap
  constexpr int NG = C / 8;   // core matrices along N (and along K) per tap
  constexpr int kSub = 2;    // row pairs a warpgroup takes at once
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w1c = reinterpret_cast<__nv_bfloat16*>(smem + S::kW2);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + S::kW2 + S::kW1);
  float* xs = reinterpret_cast<float*>(smem + S::kW2 + S::kW1 + S::kY1);
  float* st = xs + 2 * kXH * kXW;
  float* red = st + 2 * C * 2;
  float* stage = red + kWarps * C * 2;  // [buffer][warpgroup][C][kPoolW]
  int stage_n = 0;                      // row pairs this warpgroup has staged

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, and warp within it
  const int total = batch * tiles;
  const int oh = h / 2, ow = w / 2;

  // Once per block: w2 (16-byte copies, already in its shared layout), w1,
  // the biases of this thread's channels 8j + 2t + e, and the first item's
  // window.
  for (int i = tid; i < 9 * C * C / 8; i += kThreads) {
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(w2c)[i];
  }
  stage_w1<C>(w1, w1c, kThreads);
  if (blockIdx.x < total) load_window<C>(x, stats1, xs, st, blockIdx.x, tiles, tiles_x, h, w);
  cp_async_commit();
  fence_async_smem();
  float b1r[NG][2], b2r[NG][2];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b1r[j][e] = __ldg(b1 + 8 * j + 2 * t + e);
      b2r[j][e] = __ldg(b2 + 8 * j + 2 * t + e);
    }
  }

  // ldmatrix row of this lane: M row m = (lane & 7) + 8 * ((lane >> 3) & 1)
  // of its warp is output pixel (row m / 8, column 8 * wq + m % 8) of a
  // 2x32 sub-tile; lanes 16-31 read the k16 chunk's upper 8 channels.
  const uint32_t a_lane =
      smem_u32(ys + (((lane >> 3) & 1) * kHaloW + 8 * wq + (lane & 7)) * P + 8 * (lane >> 4));
  const uint64_t desc0 = wgmma_desc(smem_u32(w2s), NG * 128, 128);
  const uint64_t desc1 = wgmma_desc(smem_u32(w1c), NG * 128, 128);
  int xoff[3];  // x window offsets of this thread's conv1 inputs: taps 2t, 2t+1, 8
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int tap = i < 2 ? 2 * t + i : 8;
    xoff[i] = (tap / 3) * kXW + tap % 3;
  }

  int buf = 0;
  for (int item = blockIdx.x; item < total; item += gridDim.x, buf ^= 1) {
    const int b = item / tiles, tile = item - (item / tiles) * tiles;
    const int ty0 = (tile / tiles_x) * kTileH, tx0 = (tile % tiles_x) * kTileW;
    if (item + gridDim.x < total) {
      load_window<C>(x, stats1, xs + (buf ^ 1) * kXH * kXW, st + (buf ^ 1) * C * 2,
                     item + gridDim.x, tiles, tiles_x, h, w);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // y1 over the halo tile: conv1 of its kHaloPix pixels on the tensor
    // cores, 64 at a time (warpgroup wg takes tiles wg, wg + 2, ...), then
    // norm, LeakyReLU and bf16 into ys; zero outside the image (SAME padding
    // of the normalized y1).
    {
      const float* xb = xs + buf * kXH * kXW;
      const float2* stb = reinterpret_cast<const float2*>(st + buf * C * 2);
      float2 ms[NG][2];  // (mean, rstd) of this thread's channels
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        ms[j][0] = stb[8 * j + 2 * t];
        ms[j][1] = stb[8 * j + 2 * t + 1];
      }
#pragma unroll 1
      for (int q = wg; q < kHaloTiles; q += 2) {
        const int p0 = 64 * q + 16 * wq + g;
        float v[2][3];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = min(p0 + 8 * r, kHaloPix - 1);
          const float* base = xb + (p / kHaloW) * kXW + p % kHaloW;
#pragma unroll
          for (int i = 0; i < 3; ++i) v[r][i] = base[xoff[i]];
        }
        uint32_t a[4];
        conv1_fragment(a, v, t);
        float acc1[C / 2];
#pragma unroll
        for (int k = 0; k < C / 2; ++k) acc1[k] = 0.f;
        wgmma_fence();
        wgmma_rs<C>(acc1, a, desc1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int k = 0; k < C / 2; ++k) fence_operand(acc1[k]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + 8 * r;
          if (p < kHaloPix) {
            const int yy = ty0 - 1 + p / kHaloW, xx = tx0 - 1 + p % kHaloW;
            const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              const float y0 = lrelu((acc1[4 * j + 2 * r] + b1r[j][0] - ms[j][0].x) * ms[j][0].y,
                                     slope);
              const float y1 =
                  lrelu((acc1[4 * j + 2 * r + 1] + b1r[j][1] - ms[j][1].x) * ms[j][1].y, slope);
              *reinterpret_cast<uint32_t*>(ys + p * P + 8 * j + 2 * t) =
                  in ? pack_bf16(y0, y1) : 0u;
            }
          }
        }
      }
    }
    __syncthreads();

    // conv2: warpgroup wg takes kSub row pairs at a time, wg * kSub first,
    // their wgmma chains interleaved so that one's A loads hide under the
    // other's products.
    float s[NG][2], ss[NG][2];
#pragma unroll
    for (int j = 0; j < NG; ++j) s[j][0] = s[j][1] = ss[j][0] = ss[j][1] = 0.f;
#pragma unroll 1
    for (int rp0 = wg * kSub; rp0 < kTileH / 2; rp0 += 2 * kSub) {
      float acc[kSub][C / 2];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int i = 0; i < C / 2; ++i) acc[u][i] = 0.f;
      }
      const uint32_t a_rp = a_lane + 2 * rp0 * kHaloW * P * 2;
      constexpr uint32_t kRowPair = 2 * kHaloW * P * 2;  // bytes from one row pair to the next
      uint32_t fa[2][kSub][KC][4];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(fa[0][u][kc], a_rp + u * kRowPair + kc * 32);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            // B of (tap, kc): core matrices [tap][2kc .. 2kc+1][0 .. NG).
            const uint32_t off = ((tap * NG + 2 * kc) * NG * 128) >> 4;
            wgmma_rs<C>(acc[u], fa[tap & 1][u][kc], desc0 + off);
          }
        }
        wgmma_commit();
        if (tap + 1 < 9) {
          wgmma_wait<1>();  // the previous tap's A registers are free again
          const int ky = (tap + 1) / 3, kx = (tap + 1) % 3;
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
              ldmatrix_x4(fa[(tap + 1) & 1][u][kc],
                          a_rp + u * kRowPair + ((ky * kHaloW + kx) * P) * 2 + kc * 32);
            }
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int i = 0; i < C / 2; ++i) fence_operand(acc[u][i]);
      }

      // Epilogue. acc[u][4j + 2r + e] is output row 2(rp0 + u) + r, column
      // 8wq + g, channel 8j + 2t + e.
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int oy = ty0 + 2 * (rp0 + u), ox = tx0 + 8 * wq + g;
        float* stg_u = stage + ((stage_n & 1) * 2 + wg) * C * kPoolW;
        const bool valid = oy < h && ox < w;  // h, w and the origins even: whole windows
#pragma unroll
        for (int j = 0; j < NG; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v0 = acc[u][4 * j + e] + b2r[j][e];
            const float v1 = acc[u][4 * j + 2 + e] + b2r[j][e];
            if (valid) {
              s[j][e] += v0;
              ss[j][e] = fmaf(v0, v0, ss[j][e]);
              s[j][e] += v1;
              ss[j][e] = fmaf(v1, v1, ss[j][e]);
            }
            float m = fmaxf(v0, v1);
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
            if ((g & 1) == 0) stg_u[(8 * j + 2 * t + e) * kPoolW + 4 * wq + g / 2] = m;
          }
        }
        // The row pair's kPoolW pooled columns of each channel, 16 bytes a
        // thread. The other buffer takes the next row pair, so one barrier
        // orders both the writes before the reads and the reads before the
        // writes two row pairs on.
        warpgroup_sync(1 + wg);
        const int py = oy / 2, px0 = tx0 / 2;
        if (py < oh) {
          for (int i = tid & 127; i < C * kPoolW / 4; i += 128) {
            const int c = i / (kPoolW / 4), qd = i % (kPoolW / 4), px = px0 + 4 * qd;
            const float4 v4 = *reinterpret_cast<const float4*>(stg_u + c * kPoolW + 4 * qd);
            float* dst = pooled + ((static_cast<long long>(b) * C + c) * oh + py) * ow + px;
            if (ow % 4 == 0 && px + 3 < ow) {
              *reinterpret_cast<float4*>(dst) = v4;
            } else {
              const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
              for (int k = 0; k < 4; ++k) {
                if (px + k < ow) dst[k] = vv[k];
              }
            }
          }
        }
        ++stage_n;
      }
    }

    // The tile's per-channel sums: over g by shuffles, then over warps in order.
#pragma unroll
    for (int j = 0; j < NG; ++j) {
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
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          red[(warp * C + c) * 2] = s[j][e];
          red[(warp * C + c) * 2 + 1] = ss[j][e];
        }
      }
    }
    __syncthreads();
    if (tid < 2 * C) {
      const int c = tid >> 1, which = tid & 1;
      float v = 0.f;
      for (int i = 0; i < kWarps; ++i) v += red[(i * C + c) * 2 + which];
      part[((static_cast<long long>(b) * tiles + tile) * C + c) * 2 + which] = v;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// (c) grid: one block per (image, channel) plane. out: (B, C, H/2, W/2) bf16.
__global__ void __launch_bounds__(256)
    stage0_finish(const float* __restrict__ pooled, const float* __restrict__ part,
                  __nv_bfloat16* __restrict__ out, int channels, int tiles, int h, int w,
                  float eps, float slope) {
  __shared__ float st[2];
  const long long plane = blockIdx.x;
  const long long b = plane / channels;
  const int c = static_cast<int>(plane % channels);
  if (threadIdx.x < 32) {
    float s = 0.f, ss = 0.f;
    for (int i = threadIdx.x; i < tiles; i += 32) {
      const float* p = part + ((b * tiles + i) * channels + c) * 2;
      s += p[0];
      ss += p[1];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (threadIdx.x == 0) {
      const float n = static_cast<float>(h) * static_cast<float>(w);
      const float mean = s / n;
      const float var = fmaxf(ss / n - mean * mean, 0.f);
      st[0] = mean;
      st[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = st[0], rstd = st[1];
  const int n_out = (h / 2) * (w / 2);
  const float* src = pooled + plane * n_out;
  __nv_bfloat16* dst = out + plane * n_out;
  if (n_out % 4 == 0) {
    for (int i = threadIdx.x; i < n_out / 4; i += blockDim.x) {
      const float4 m = reinterpret_cast<const float4*>(src)[i];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(lrelu((m.x - mean) * rstd, slope),
                                                      lrelu((m.y - mean) * rstd, slope));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(lrelu((m.z - mean) * rstd, slope),
                                                      lrelu((m.w - mean) * rstd, slope));
      reinterpret_cast<__nv_bfloat162*>(dst)[2 * i] = lo;
      reinterpret_cast<__nv_bfloat162*>(dst)[2 * i + 1] = hi;
    }
  } else {
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      dst[i] = __float2bfloat16(lrelu((src[i] - mean) * rstd, slope));
    }
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
int launch(const float* x, const float* w1, const float* b1, const __nv_bfloat16* w2c,
           const float* b2, float* stats1, float* pooled, float* part, __nv_bfloat16* out,
           int batch, int h, int w, int blocks, float eps, float slope, cudaStream_t stream) {
  static bool done[64] = {};
  constexpr int smem = Conv2Smem<C>::kBytes;
  cudaError_t e = allow_smem(stage0_conv2<C>, smem, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((h + kTileH - 1) / kTileH);
  stage0_conv1_stats<C><<<batch, kStatsThreads, 0, stream>>>(x, w1, b1, stats1, h, w, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stage0_conv2<C><<<blocks, kThreads, smem, stream>>>(x, w1, b1, stats1, w2c, b2, pooled, part,
                                                      batch, h, w, tiles_x, tiles, slope);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stage0_finish<<<batch * C, 256, 0, stream>>>(pooled, part, out, C, tiles, h, w, eps, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (batch, 1, h, w) f32; w1: (C, 1, 3, 3) f32; b1, b2: (C,) f32; w2c: w2
// (C, C, 3, 3) as bf16 in the canonical layout [ky*3+kx][ci/8][co/8][co%8]
// [ci%8]; scratch stats1 (batch, C, 2), pooled (batch, C, h/2, w/2) and part
// (batch, tiles, C, 2) f32, tiles = ceil(h/tile_h) * ceil(w/tile_w); out:
// (batch, C, h/2, w/2) bf16. h and w even; C is 16, 32 or 64; blocks >= 1
// persistent conv2 blocks; tile_h and tile_w must be the kernel's own (the
// wrapper's plan states them). Returns cudaGetLastError() after the launches.
int latice_stage0_fused(const void* x, const void* w1, const void* b1, const void* w2c,
                        const void* b2, void* stats1, void* pooled, void* part, void* out,
                        int batch, int channels, int h, int w, int blocks, int tile_h,
                        int tile_w, float eps, float slope, void* stream) {
  if (blocks < 1 || tile_h != kTileH || tile_w != kTileW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const __nv_bfloat16* w2b = static_cast<const __nv_bfloat16*>(w2c);
  const float* b2f = static_cast<const float*>(b2);
  float* st = static_cast<float*>(stats1);
  float* pl = static_cast<float*>(pooled);
  float* pt = static_cast<float*>(part);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (channels) {
    case 16:
      return launch<16>(xf, w1f, b1f, w2b, b2f, st, pl, pt, o, batch, h, w, blocks, eps, slope, s);
    case 32:
      return launch<32>(xf, w1f, b1f, w2b, b2f, st, pl, pt, o, batch, h, w, blocks, eps, slope, s);
    case 64:
      return launch<64>(xf, w1f, b1f, w2b, b2f, st, pl, pt, o, batch, h, w, blocks, eps, slope, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The conv2 block's shared memory in bytes at `channels` (0 if unsupported).
int latice_stage0_smem_bytes(int channels) {
  switch (channels) {
    case 16: return Conv2Smem<16>::kBytes;
    case 32: return Conv2Smem<32>::kBytes;
    case 64: return Conv2Smem<64>::kBytes;
    default: return 0;
  }
}

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
