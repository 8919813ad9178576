// The symmetry-aware consensus of a batch's top-k candidates in one launch
// (K4): what index/pipeline.py's CandidateConsensus returns, from the
// search's (B, k) scores and dictionary rows, with no host sync.
//
// Replaces no TPU kernel. The JAX package's consensus
// (latice_tpu/index/consensus.py:consensus_orientations, called from
// latice_tpu/index/pipeline.py) is plain jnp that XLA fuses under jit. On
// the card the same code ran as eager PyTorch: several hundred small
// launches a batch, and host-to-device copies among them that made the host
// wait for the batch's encoder and search before it could launch the rest.
// This kernel computes the same function with the same formulas, in f32
// throughout: the trials, every symmetry image of every candidate, the
// 30-step power iteration of the chordal mean and the Euler branches.
//
// What bounds it on an H100: launch latency. A batch of 256 at k = 20 reads
// ~0.25 MB (the indices, the scores and 5,120 gathered rows, each one
// 32-byte sector), under 0.1 us at 3.35 TB/s, and does ~11 MFLOP (three
// trials, 24 images a candidate, 30 power steps), under 0.2 us at 67
// TFLOP/s FP32; a launch takes microseconds. On an H100 the kernel takes
// ~17 us at any B from 1 to 256: one warp's dependent chain (24 atan2f
// images a candidate, 30 power steps with IEEE divisions) sets its time,
// not the card's throughput, against 6-13 ms of encoder work a batch.
//
// Design: one warp per query, its lanes over the candidates (candidate
// lane, lane + 32, ...: any k). A trial's reference is loaded by the lane
// that owns it and handed to the others by __shfl_sync; each lane tests its
// candidates against it, and __ballot_sync and __popc count the matches.
// The first succeeding trial is chosen, else the last. The block's warps
// share the per-phase symmetry tables, (P, S, 4) f32 of a few KB, in shared
// memory. Each lane stores whether each of its candidates matches the chosen
// reference (the row's mask, one byte a candidate), snaps it to the image
// sym_s (x) cand nearest that reference (the first closest on a tie),
// weights it, and sums its part of the 4x4 mean matrix (10 distinct
// entries) and of the power iteration's start vector; warp shuffles add the
// parts, and every lane then runs the power iteration and the Euler
// conversion in registers. Candidate
// rows are gathered again in each pass rather than held, so k has no limit:
// after the first pass they come from L1.
//
// The match test is one out-of-line function, so that the trial that
// counted a candidate and the pass that averages it decide it with the same
// instructions.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPowerSteps = 30;                  // quat_mean's iterations
constexpr float kDeg = 57.295779513082323f;      // 180 / pi
constexpr int kMaxSharedBytes = 48 * 1024;

struct Quat {
  float w, x, y, z;
};

struct Cand {
  Quat q;
  int phase;
};

struct Args {
  const float* scores;  // (B, k)
  const void* indices;  // (B, k) int32 or int64
  const float* rows;    // (N, stride): w, x, y, z[, phase id]
  const float* sym;     // (P, S, 4)
  float* mean_euler;    // (B, 3)
  float* best;          // (B, 3)
  bool* success;        // (B,)
  long long* n_similar; // (B,)
  bool* mask;           // (B, k): the chosen trial's matches
  int* phase;           // (B,), or null without phases
  int idx64, n_rows, stride, n_phases, n_sym, B, k, iters, min_matches, degrees, weighted;
  float threshold, power;
};

__device__ __forceinline__ Quat mul(const Quat& a, const Quat& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// misorientation_angle: the angle of inv(r) (x) c, in radians.
__device__ __forceinline__ float misorientation(const Quat& r, const Quat& c) {
  const Quat d = mul({r.w, -r.x, -r.y, -r.z}, c);
  return 2.0f * atan2f(sqrtf(d.x * d.x + d.y * d.y + d.z * d.z), fabsf(d.w));
}

__device__ __noinline__ bool similar(Cand ref, Cand c, float threshold, int degrees) {
  float angle = misorientation(ref.q, c.q);
  if (degrees) angle = angle * kDeg;
  return angle < threshold && ref.phase == c.phase;
}

// quat_normalize: q over max(|q|, 1e-12).
__device__ __forceinline__ Quat normalize(const Quat& q) {
  const float n = fmaxf(sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z), 1e-12f);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

__device__ __forceinline__ Quat canonical(const Quat& q) {
  return q.w < 0.0f ? Quat{-q.w, -q.x, -q.y, -q.z} : q;
}

// The candidate's dictionary row; a row index outside [0, N) reads as NaN.
__device__ __forceinline__ Cand load_cand(const Args& a, int query, int c) {
  const long long at = static_cast<long long>(query) * a.k + c;
  const long long idx = a.idx64 ? __ldg(static_cast<const long long*>(a.indices) + at)
                                : __ldg(static_cast<const int*>(a.indices) + at);
  if (idx < 0 || idx >= a.n_rows) {
    const float nan = __int_as_float(0x7fc00000);
    return {{nan, nan, nan, nan}, -1};
  }
  const float* r = a.rows + idx * a.stride;
  return {{__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)},
          a.stride == 5 ? static_cast<int>(__ldg(r + 4)) : 0};
}

__device__ __forceinline__ Cand shfl(const Cand& c, int src) {
  return {{__shfl_sync(kFull, c.q.w, src), __shfl_sync(kFull, c.q.x, src),
           __shfl_sync(kFull, c.q.y, src), __shfl_sync(kFull, c.q.z, src)},
          __shfl_sync(kFull, c.phase, src)};
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A candidate's weight before the row's normalisation: (s / s_max) ** p of
// the clamped score, as CandidateConsensus computes it.
__device__ __forceinline__ float score_weight(const Args& a, int query, int c, float top) {
  const float s = fmaxf(__ldg(a.scores + static_cast<long long>(query) * a.k + c), 0.0f);
  return powf(s / top, a.power);
}

// to_euler_zxz_deg: matrix_to_euler_zxz_deg of quat_to_matrix(normalize(q)).
__device__ void euler_zxz_deg(Quat q, float* out) {
  q = normalize(q);
  const float w = q.w, x = q.x, y = q.y, z = q.z;
  const float r00 = 1.0f - 2.0f * (y * y + z * z);
  const float r02 = 2.0f * (x * z + w * y);
  const float r10 = 2.0f * (x * y + w * z);
  const float r12 = 2.0f * (y * z - w * x);
  const float r20 = 2.0f * (x * z - w * y);
  const float r21 = 2.0f * (y * z + w * x);
  const float r22 = 1.0f - 2.0f * (x * x + y * y);
  const float sin_phi = sqrtf(r20 * r20 + r21 * r21);
  const float big_phi = atan2f(sin_phi, r22);
  const bool lock = sin_phi < 1e-7f;  // gimbal lock: the fold goes to the first angle
  const float phi1 = lock ? 0.0f : atan2f(r02, -r12);
  const float phi2 = lock ? atan2f(r22 > 0.0f ? r10 : -r10, r00) : atan2f(r20, r21);
  out[0] = phi2 * kDeg;
  out[1] = big_phi * kDeg;
  out[2] = phi1 * kDeg;
}

__global__ void __launch_bounds__(kWarps * 32) consensus_fused(Args a) {
  extern __shared__ float sym_s[];  // (P, S, 4)
  for (int i = threadIdx.x; i < a.n_phases * a.n_sym * 4; i += blockDim.x) sym_s[i] = a.sym[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int query = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (query >= a.B) return;
  const int k = a.k;
  const Cand none = {{0.0f, 0.0f, 0.0f, 0.0f}, 0};

  // The trials: the first that reaches min_matches, else the last.
  int chosen = -1, n_chosen = 0, n_last = 0;
  Cand ref_chosen = none, ref_last = none;
  for (int t = 0; t < a.iters; ++t) {
    const Cand ref = shfl(lane == (t & 31) ? load_cand(a, query, t) : none, t & 31);
    int n = 0;
    for (int base = 0; base < k; base += 32) {
      const int c = base + lane;
      const bool in = c < k && similar(ref, load_cand(a, query, c), a.threshold, a.degrees);
      n += __popc(__ballot_sync(kFull, in));
    }
    if (chosen < 0 && n >= a.min_matches) {
      chosen = t;
      n_chosen = n;
      ref_chosen = ref;
    }
    n_last = n;
    ref_last = ref;
  }
  const bool success = chosen >= 0;
  if (!success) {
    n_chosen = n_last;
    ref_chosen = ref_last;
  }

  // Weights: the row's largest clamped score, then the largest weight among
  // the chosen trial's matches.
  float top = 0.0f, wmax = 0.0f;
  if (a.weighted) {
    for (int c = lane; c < k; c += 32) {
      top = fmaxf(top, fmaxf(__ldg(a.scores + static_cast<long long>(query) * k + c), 0.0f));
    }
    top = fmaxf(warp_max(top), 1e-30f);
    for (int base = 0; base < k; base += 32) {
      const int c = base + lane;
      if (c < k) {
        const float in = similar(ref_chosen, load_cand(a, query, c), a.threshold, a.degrees);
        wmax = fmaxf(wmax, in * score_weight(a, query, c, top));
      }
    }
    wmax = warp_max(wmax);
  }

  // Snap, weight and sum: m holds M = sum w q q^T (upper triangle), v0 the
  // sign-aligned weighted sum.
  const int group = min(max(ref_chosen.phase, 0), a.n_phases - 1);
  const float* sym = sym_s + group * a.n_sym * 4;
  float m[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float v0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = 0; base < k; base += 32) {
    const int c = base + lane;
    if (c >= k) continue;
    const Cand cand = load_cand(a, query, c);
    const bool in = similar(ref_chosen, cand, a.threshold, a.degrees);
    a.mask[static_cast<long long>(query) * k + c] = in;
    float w = in ? 1.0f : 0.0f;
    if (a.weighted) {
      const float raw = w * score_weight(a, query, c, top);
      w = wmax > 0.0f ? raw / wmax : w;  // all-zero weights: the uniform mean
    }
    Quat img = mul({sym[0], sym[1], sym[2], sym[3]}, cand.q);
    float nearest = misorientation(ref_chosen.q, img);
    for (int s = 1; s < a.n_sym; ++s) {
      const Quat other = mul({sym[4 * s], sym[4 * s + 1], sym[4 * s + 2], sym[4 * s + 3]}, cand.q);
      const float d = misorientation(ref_chosen.q, other);
      if (d < nearest) {
        nearest = d;
        img = other;
      }
    }
    const float q[4] = {img.w, img.x, img.y, img.z};
    const float qw[4] = {q[0] * w, q[1] * w, q[2] * w, q[3] * w};
    int e = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = i; j < 4; ++j) m[e++] += qw[i] * q[j];
    }
    const Quat cq = canonical(img);
    v0[0] += cq.w * w;
    v0[1] += cq.x * w;
    v0[2] += cq.y * w;
    v0[3] += cq.z * w;
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int e = 0; e < 10; ++e) m[e] += __shfl_xor_sync(kFull, m[e], o);
#pragma unroll
    for (int i = 0; i < 4; ++i) v0[i] += __shfl_xor_sync(kFull, v0[i], o);
  }

  // The chordal mean by power iteration from the normalised start vector
  // (the identity where it vanishes), as quat_mean.
  const bool flat =
      sqrtf(v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2] + v0[3] * v0[3]) < 1e-6f;
  Quat v = normalize(flat ? Quat{1.0f, 0.0f, 0.0f, 0.0f} : Quat{v0[0], v0[1], v0[2], v0[3]});
  for (int step = 0; step < kPowerSteps; ++step) {
    v = normalize({m[0] * v.w + m[1] * v.x + m[2] * v.y + m[3] * v.z,
                   m[1] * v.w + m[4] * v.x + m[5] * v.y + m[6] * v.z,
                   m[2] * v.w + m[5] * v.x + m[7] * v.y + m[8] * v.z,
                   m[3] * v.w + m[6] * v.x + m[8] * v.y + m[9] * v.z});
  }
  const Cand top1 = shfl(lane == 0 ? load_cand(a, query, 0) : none, 0);
  if (lane != 0) return;
  float mean[3], first[3];
  euler_zxz_deg(canonical(v), mean);
  euler_zxz_deg(top1.q, first);
  for (int i = 0; i < 3; ++i) {
    a.mean_euler[3 * query + i] = mean[i];
    a.best[3 * query + i] = success ? mean[i] : first[i];
  }
  a.success[query] = success;
  a.n_similar[query] = n_chosen;
  if (a.phase != nullptr) a.phase[query] = success ? ref_chosen.phase : top1.phase;
}

}  // namespace

extern "C" {

// scores: (B, k) f32; indices: (B, k) int64 (idx64 = 1) or int32; rows:
// (n_rows, stride) f32, stride 4 or 5 (the phase id as a 5th column); sym:
// (n_phases, n_sym, 4) f32; outputs mean_euler and best (B, 3) f32,
// success (B,) bool, n_similar (B,) int64, mask (B, k) bool (the chosen
// trial's matches) and, with stride 5, phase (B,) int32. Requires k >= 1 and 1 <= iters <= k (the wrapper checks them).
// Returns cudaErrorInvalidValue without launching if the tables exceed a
// block's 48 KB of shared memory, else cudaGetLastError() after the launch.
int latice_candidate_consensus_fused(const void* scores, const void* indices, int idx64,
                                     const void* rows, int n_rows, int stride, const void* sym,
                                     int n_phases, int n_sym, int B, int k, int iters,
                                     int min_matches, float threshold, int degrees, int weighted,
                                     float power, void* mean_euler, void* best, void* success,
                                     void* n_similar, void* mask, void* phase, void* stream) {
  const long long smem = 16LL * n_phases * n_sym;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(scores), indices, static_cast<const float*>(rows),
               static_cast<const float*>(sym), static_cast<float*>(mean_euler),
               static_cast<float*>(best), static_cast<bool*>(success),
               static_cast<long long*>(n_similar), static_cast<bool*>(mask),
               static_cast<int*>(phase), idx64, n_rows, stride, n_phases, n_sym, B, k, iters,
               min_matches, degrees, weighted, threshold, power};
  consensus_fused<<<(B + kWarps - 1) / kWarps, kWarps * 32, static_cast<int>(smem),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* latice_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
