// Linear blend skinning, f32:
//   verts[b, v] = (sum_j W[v, j] * A[b, j, :3, :]) @ [v_posed[b, v], 1]
//
// Replaces the Pallas kernel maed_tpu/ops/smpl_pallas.py::_skin_kernel
// (pallas_call in `skinning`), which the JAX package runs by default on the
// TPU inside SMPL's `lbs`.
//
// What bounds it on the H100: the f32 operations. At the flagship shape (B =
// 128 frames, V = 6890 vertices, J = 24) it moves 21 MB (v_posed in, verts
// out, W and A; 6.3 us at 3.35 TB/s) for 128 * 6890 * (24 * 12 + 12) ~ 265 M
// FMAs: 7.9 us at the 67 TFLOP/s of f32 outside the tensor cores. It stays
// f32 on the FMA pipes: TF32 keeps ~3 digits, millimetres on a 1.7 m body.
// The eager formulation materializes the per-vertex transforms T = W @ A as a
// (B, V, 3, 4) tensor (42 MB) and reads it back; here T lives in registers.
//
// Design: the TPU kernel's reuse of a W block across frames, without its
// (V, 4, B) lane-major layouts. A CTA takes a tile of kTile vertices over a
// run of at most kMaxRun frames, as many CTAs as the card holds at once. It
// loads the run's joint transforms (rows 0..2 of each 4x4) into shared
// memory and its W tile, coalesced through shared memory, into registers:
// each thread keeps the 24 weights of its kPerThread vertices. From there
// each warp streams on its own, with no block barrier: frame after frame a
// thread forms its vertices' 3x4 T from 16-byte broadcasts of the
// transforms (3 shared loads a joint for 12 * kPerThread FMAs), applies it
// to the v_posed row it loaded during the frame before, and writes the row.
// What holds it above its bound (PERF.md): the broadcasts, which the
// shared-memory pipe serves more slowly than the FMA pipes take their
// operands, and the FMA pipes' own throughput. It reads the JAX layouts
// directly: v_posed (B, V, 3), W (V, 24), A (B, 24, 4, 4), out (B, V, 3).

#include <cuda_runtime.h>

#include <algorithm>

#include "hopper.cuh"  // persistent_ctas (the SM count)

namespace {

constexpr int kJoints = 24;
constexpr int kRows = 12;  // the top 3 rows of a 4x4 transform
constexpr int kThreads = 128, kPerThread = 3, kTile = kThreads * kPerThread;
constexpr int kWPitch = kJoints + 1;  // floats a vertex's weights take in shared memory
constexpr int kA = kJoints * kRows;   // floats of a frame's transforms
constexpr int kMaxRun = 8;            // frames a CTA takes at most

// CTA (tile, run): vertices tile * kTile .., frames run * frames_per_run ..
__global__ void __launch_bounds__(kThreads) skinning_frames_kernel(
    const float* __restrict__ v_posed, const float* __restrict__ weights,
    const float* __restrict__ transforms, float* __restrict__ out, int B, int V,
    int frames_per_run) {
  __shared__ float w_s[kTile * kWPitch];
  __shared__ float4 a_s[kMaxRun * kA / 4];
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * kTile, nv = min(kTile, V - v0);
  const int b0 = blockIdx.y * frames_per_run, frames = min(B, b0 + frames_per_run) - b0;

  // this thread's vertices' v_posed rows of frame b0 + f, in flight while it
  // works on the frame before
  float x_r[kPerThread][3] = {};
  const auto fetch = [&](int f) {
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      const int v = tid + p * kThreads;
      if (v < nv) {
        const float* x_g = v_posed + (static_cast<size_t>(b0 + f) * V + v0 + v) * 3;
        x_r[p][0] = __ldg(x_g), x_r[p][1] = __ldg(x_g + 1), x_r[p][2] = __ldg(x_g + 2);
      }
    }
  };
  fetch(0);

  // the run's transforms (rows 0..2 of each joint) and the tile's weights,
  // nv x 24 contiguous floats, the weights' loads all in flight at once
  float* a_f = reinterpret_cast<float*>(a_s);
  const float* a_g = transforms + static_cast<size_t>(b0) * kJoints * 16;
  for (int i = tid; i < frames * kA; i += kThreads) a_f[i] = a_g[i / kRows * 16 + i % kRows];
  constexpr int kWPerThread = kTile * kJoints / kThreads;
  const float* w_g = weights + static_cast<size_t>(v0) * kJoints;
  float w_r[kWPerThread];
#pragma unroll
  for (int e = 0; e < kWPerThread; ++e) {
    const int i = tid + e * kThreads;
    w_r[e] = i < nv * kJoints ? w_g[i] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kWPerThread; ++e) {
    const int i = tid + e * kThreads;
    w_s[i / kJoints * kWPitch + i % kJoints] = w_r[e];
  }
  __syncthreads();
  float w[kPerThread][kJoints];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
#pragma unroll
    for (int j = 0; j < kJoints; ++j) w[p][j] = w_s[(tid + p * kThreads) * kWPitch + j];
  }

  // from here each warp streams on its own: no block barrier
  for (int f = 0; f < frames; ++f) {
    float x[kPerThread][3];
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[p][c] = x_r[p][c];
    }
    if (f + 1 < frames) fetch(f + 1);

    const float4* a = a_s + f * kA / 4;
    float t[kPerThread][kRows] = {};
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {  // the blend: T = sum_j w_j A_j[:3]
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float4 ajr = a[3 * j + r];
#pragma unroll
        for (int p = 0; p < kPerThread; ++p) {
          t[p][4 * r] = fmaf(w[p][j], ajr.x, t[p][4 * r]);
          t[p][4 * r + 1] = fmaf(w[p][j], ajr.y, t[p][4 * r + 1]);
          t[p][4 * r + 2] = fmaf(w[p][j], ajr.z, t[p][4 * r + 2]);
          t[p][4 * r + 3] = fmaf(w[p][j], ajr.w, t[p][4 * r + 3]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      const int v = tid + p * kThreads;
      if (v < nv) {
        float* o_g = out + (static_cast<size_t>(b0 + f) * V + v0 + v) * 3;
#pragma unroll
        for (int r = 0; r < 3; ++r)
          o_g[r] = t[p][4 * r] * x[p][0] + t[p][4 * r + 1] * x[p][1] + t[p][4 * r + 2] * x[p][2] +
                   t[p][4 * r + 3];
      }
    }
  }
}

}  // namespace

// B frames, V vertices, J = 24 joints; all arrays contiguous f32 on the device.
// The frames are cut into runs so that the (vertex tile, run) CTAs come to
// one wave: as many as the card holds at once.
extern "C" int maed_skinning_f32(const float* v_posed, const float* weights,
                                 const float* transforms, float* out, int B, int V,
                                 void* stream) {
  if (B < 1 || V < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static int resident = 0;  // CTAs an SM (the same on every H100)
  if (resident == 0) {
    if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, skinning_frames_kernel, kThreads, 0))
      return static_cast<int>(err);
  }
  const int tiles = (V + kTile - 1) / kTile;
  const long long want = persistent_ctas(1ll << 40, resident);
  const int runs = static_cast<int>(std::min<long long>(B, (want + tiles - 1) / tiles));
  const int per_run = std::min((B + runs - 1) / runs, kMaxRun);
  const dim3 grid(tiles, (B + per_run - 1) / per_run);
  skinning_frames_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v_posed, weights, transforms, out, B, V, per_run);
  return static_cast<int>(cudaGetLastError());
}
