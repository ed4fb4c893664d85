// Linear blend skinning, f32:
//   verts[b, v] = (sum_j W[v, j] * A[b, j, :3, :]) @ [v_posed[b, v], 1]
//
// Replaces the Pallas kernel maed_tpu/ops/smpl_pallas.py::_skin_kernel
// (pallas_call in `skinning`), which the JAX package runs by default on the
// TPU inside SMPL's `lbs`.
//
// What bounds it on the H100: memory. At the flagship shape (B = 128 frames,
// V = 6890 vertices, J = 24) it reads v_posed (10.6 MB) and writes verts
// (10.6 MB) for 128 * 6890 * (288 + 9) ~ 0.26 GFLOP: about 6 us at 3.35 TB/s.
// The XLA/eager formulation materializes the per-vertex transforms
// T = W @ A as a (B, V, 3, 4) tensor (42 MB) and reads it back; here T lives
// in registers only.
//
// Design: one thread per (frame, vertex). A block covers kThreads vertices of
// one frame and stages that frame's 24 joint transforms (rows 0..2 of each
// 4x4, 288 floats) in shared memory once; every thread reads its 24 weights,
// forms its 3x4 T in registers and applies it. It reads the JAX layouts
// directly: v_posed (B, V, 3), W (V, 24), A (B, 24, 4, 4), out (B, V, 3). The
// TPU kernel's (V, 4, B) lane-major transposes are not carried over. W
// (660 KB) is re-read by every frame from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kRows = 12;  // the top 3 rows of a 4x4 transform
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) skinning_kernel(
    const float* __restrict__ v_posed, const float* __restrict__ weights,
    const float* __restrict__ transforms, float* __restrict__ out, int V) {
  __shared__ float a_s[kJoints * kRows];
  const int b = blockIdx.y;
  const float* a_b = transforms + static_cast<size_t>(b) * kJoints * 16;
  for (int i = threadIdx.x; i < kJoints * kRows; i += kThreads) {
    a_s[i] = a_b[(i / kRows) * 16 + i % kRows];
  }
  __syncthreads();

  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;

  float t[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) t[k] = 0.f;
  const float* w = weights + static_cast<size_t>(v) * kJoints;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float wj = w[j];
#pragma unroll
    for (int k = 0; k < kRows; ++k) t[k] = fmaf(wj, a_s[j * kRows + k], t[k]);
  }

  const size_t row = (static_cast<size_t>(b) * V + v) * 3;
  const float x = v_posed[row], y = v_posed[row + 1], z = v_posed[row + 2];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    out[row + p] = t[p * 4] * x + t[p * 4 + 1] * y + t[p * 4 + 2] * z + t[p * 4 + 3];
  }
}

}  // namespace

// B frames, V vertices, J = 24 joints; all arrays contiguous f32 on the device.
extern "C" int maed_skinning_f32(const float* v_posed, const float* weights,
                                 const float* transforms, float* out, int B, int V,
                                 void* stream) {
  const dim3 grid((V + kThreads - 1) / kThreads, B);
  skinning_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v_posed, weights, transforms, out, V);
  return static_cast<int>(cudaGetLastError());
}
