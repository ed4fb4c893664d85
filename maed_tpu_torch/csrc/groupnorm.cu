// GroupNorm (+ residual) (+ ReLU) of the hybrid stem, f32 or bf16.
//
// Replaces the Pallas kernel maed_tpu/ops/groupnorm.py::_gn_kernel (pallas_call
// in `_gn_pallas`, public entry `fused_groupnorm`), which the stem norm and
// every bottleneck norm of the ResNetV2 stem reach: 52 calls per forward.
//
// What bounds it on the H100: memory. A call reads the activation once and
// writes it once and does a handful of operations per element; the 52 sites of
// a flagship request (128 frames, up to 112 x 112 x 64) move 2.9 GB in bf16,
// 1.7 ms at 3.35 TB/s, the stem norm alone 411 MB.
//
// The TPU kernel holds a frame (H, W, C) in VMEM and pools the per-channel
// moments with a (C, C) group-averaging matmul, because Mosaic cannot reshape
// across lanes. Here a block owns the channels of one group of one frame (or of
// a few neighbouring groups, see below): their elements are staged in shared
// memory while the f32 sums and sums of squares are taken, so the activation
// comes from device memory once; then y = x * mul + add is applied out of
// shared memory. A block whose elements do not fit is read a second time (from
// L2, mostly). No matmul: a block reduction gives the moments directly.
//
// The layout is channels last (B, HW, C), the JAX layout and what cuDNN hands
// the port's stem, which is fed channels-last frames: a group is cpg
// neighbouring channels of every pixel, a few bytes at a stride of C. Device
// memory moves 32-byte sectors, so a block takes as many neighbouring groups as
// share up to 128 bytes of a pixel and still fit in shared memory
// (pick_groups), a thread reads 16 bytes (V = 8 bf16 or 4 f32 channels) of them
// at the same place in every pixel it visits, and keeps a sum per channel
// slot; the slots are pooled per group at the end. 16-byte loads and stores
// where the widths and the alignment allow, else element by element (V = 1).
//
// Rounding points as groupnorm.py:83-108: f32 moments as E[x^2] - m^2 over the
// group, mul = scale * rsqrt(var + eps) and add = bias - mean * mul in f32 from
// f32 scale and bias, both rounded to x's dtype, then x * mul, + add,
// + residual, each rounded to x's dtype, then the ReLU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
// v as T would hold it
template <typename T>
__device__ __forceinline__ float rounded(float v) { return to_f32(from_f32<T>(v)); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

constexpr int kThreads = 256, kWarps = kThreads / 32;
// a block may stage this much of x in shared memory: two blocks to an SM
constexpr size_t kStageLimit = 104 * 1024, kPreferredStage = 52 * 1024;
constexpr int kMaxGroups = 32;  // groups a block may take

// floats of shared memory before the staged x: mul and add per channel, the
// per-channel totals, every warp's partial sums, the groups' mean and rstd
__host__ __device__ constexpr int reduce_floats(int W, int gpb) {
  return 2 * W + 2 * W + kWarps * 2 * (gpb > 1 ? W : 1) + 2 * gpb;
}
__host__ __device__ constexpr size_t stage_offset(int W, int gpb) {
  return (reduce_floats(W, gpb) * sizeof(float) + 15) / 16 * 16;
}

// A block takes gpb neighbouring groups of one frame: W = gpb * cpg channels,
// n = W * HW elements, walked in chunks of V. Element i is channel i % W of
// pixel i / W (W a multiple of V). Grid B * G / gpb, kThreads threads. With
// gpb > 1, W / V is a power of two that divides the warp, so a thread's chunks
// all start at the same channel, (tid % (W / V)) * V.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) groupnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ residual, T* __restrict__ out,
    const float* __restrict__ scale, const float* __restrict__ bias, int G, int cpg, int gpb,
    int HW, float eps, int relu, int stage) {
  const int W = gpb * cpg, n = W * HW, C = G * cpg;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* mul_s = reinterpret_cast<float*>(smem_raw);  // W
  float* add_s = mul_s + W;                           // W
  float* chan_s = add_s + W;                          // 2 x W: sum, sum of squares
  float* red_s = chan_s + 2 * W;                      // kWarps x 2 x (W or 1)
  float* stats_s = red_s + kWarps * 2 * (gpb > 1 ? W : 1);  // 2 x gpb: mean, rstd
  T* x_s = reinterpret_cast<T*>(smem_raw + stage_offset(W, gpb));
  using P = Pack<T, V>;

  const int b = blockIdx.x / (G / gpb), c_lo = blockIdx.x % (G / gpb) * W;
  const long long base = static_cast<long long>(b) * HW * C + c_lo;
  auto offset = [&](int i) -> long long {
    return base + static_cast<long long>(i / W) * C + i % W;
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // sums per chunk slot
  float s[V] = {}, ss[V] = {};
#pragma unroll 4
  for (int i = tid * V; i < n; i += kThreads * V) {
    const P p = *reinterpret_cast<const P*>(x + offset(i));
    if (stage) *reinterpret_cast<P*>(x_s + i) = p;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = to_f32(p.v[e]);
      s[e] += v;
      ss[e] += v * v;
    }
  }
  if (gpb == 1) {  // one group: pool everything
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a += s[e];
      c += ss[e];
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      red_s[warp * 2] = a;
      red_s[warp * 2 + 1] = c;
    }
    __syncthreads();
    if (tid < 2) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += red_s[w * 2 + tid];
      chan_s[tid] = total;  // [0] the sum, [1] the sum of squares
    }
  } else {  // slot e of this thread is channel (lane % cp) * V + e
    const int cp = W / V;
    for (int off = 16; off >= cp; off >>= 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
        ss[e] += __shfl_xor_sync(0xffffffffu, ss[e], off);
      }
    }
    if (lane < cp) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        red_s[(warp * 2) * W + lane * V + e] = s[e];
        red_s[(warp * 2 + 1) * W + lane * V + e] = ss[e];
      }
    }
    __syncthreads();
    for (int c = tid; c < 2 * W; c += kThreads) {  // per channel: c / W picks sum or squares
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += red_s[(w * 2 + c / W) * W + c % W];
      chan_s[c] = total;
    }
  }
  __syncthreads();
  if (tid < gpb) {
    float ts = 0.f, tss = 0.f;
    if (gpb == 1) {
      ts = chan_s[0];
      tss = chan_s[1];
    } else {
      for (int c = tid * cpg; c < (tid + 1) * cpg; ++c) {
        ts += chan_s[c];
        tss += chan_s[W + c];
      }
    }
    const float count = static_cast<float>(cpg) * HW, mean = ts / count;
    stats_s[tid] = mean;
    stats_s[gpb + tid] = rsqrtf(tss / count - mean * mean + eps);
  }
  __syncthreads();
  for (int c = tid; c < W; c += kThreads) {
    const int j = c / cpg;
    const float mul = scale[c_lo + c] * stats_s[gpb + j];
    mul_s[c] = rounded<T>(mul);
    add_s[c] = rounded<T>(bias[c_lo + c] - stats_s[j] * mul);
  }
  __syncthreads();

#pragma unroll 2
  for (int i = tid * V; i < n; i += kThreads * V) {
    const long long o = offset(i);
    const P p = stage ? *reinterpret_cast<const P*>(x_s + i) : *reinterpret_cast<const P*>(x + o);
    P r, y;
    if (residual != nullptr) r = *reinterpret_cast<const P*>(residual + o);
    const int c0 = i % W;  // the chunk's first channel
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = c0 + e;
      float v = rounded<T>(to_f32(p.v[e]) * mul_s[c]);
      v = rounded<T>(v + add_s[c]);
      if (residual != nullptr) v = rounded<T>(v + to_f32(r.v[e]));
      if (relu) v = fmaxf(v, 0.f);
      y.v[e] = from_f32<T>(v);
    }
    *reinterpret_cast<P*>(out + o) = y;
  }
}

// Groups for a block, or 0 if chunks of V do not fit:
// a power of two that divides G, with W = gpb * cpg a multiple of V and, for
// more than one group, W / V a power of two up to 32 and W at most 128 bytes.
// The widest whose elements fit in kPreferredStage of shared memory (four
// blocks to an SM), or wider up to kStageLimit while W is less than a 32-byte
// sector; if none fits at all, the narrowest that fills a sector.
inline int pick_groups(int G, int cpg, int HW, int V, size_t elem) {
  int staged = 0, unstaged = 0;
  for (int gpb = 1; gpb <= G && gpb <= kMaxGroups; gpb *= 2) {
    const int W = gpb * cpg, cp = W / V;
    if (G % gpb || W % V) continue;
    if (gpb > 1 && (cp > 32 || (cp & (cp - 1)))) continue;
    if (gpb > 1 && W * elem > 128) break;
    const size_t bytes = stage_offset(W, gpb) + static_cast<size_t>(W) * HW * elem;
    if (bytes <= kPreferredStage || (bytes <= kStageLimit && staged * cpg * elem < 32)) {
      staged = gpb;
    } else if (bytes > kStageLimit && unstaged * cpg * elem < 32) {
      unstaged = gpb;
    }
  }
  return staged ? staged : unstaged;
}

template <typename T, int V>
int launch(const void* x, const void* residual, void* out, const float* scale, const float* bias,
           int B, int G, int cpg, int gpb, int HW, float eps, int relu, cudaStream_t stream) {
  const int W = gpb * cpg;
  const size_t staged = stage_offset(W, gpb) + static_cast<size_t>(W) * HW * sizeof(T);
  const int stage = staged <= kStageLimit;
  const size_t smem = stage ? staged : stage_offset(W, gpb);
  auto kernel = groupnorm_kernel<T, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B * (G / gpb), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual), static_cast<T*>(out), scale,
      bias, G, cpg, gpb, HW, eps, relu, stage);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* residual, void* out, const float* scale,
             const float* bias, int B, int G, int cpg, int HW, float eps, int relu,
             cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  // whole 16-byte chunks need every chunk on a 16-byte boundary: C a multiple of V
  const bool aligned = !misaligned(x) && !misaligned(out) && !misaligned(residual);
  const int gpb = aligned && (G * cpg) % V == 0 ? pick_groups(G, cpg, HW, V, sizeof(T)) : 0;
  if (gpb)
    return launch<T, V>(x, residual, out, scale, bias, B, G, cpg, gpb, HW, eps, relu, stream);
  return launch<T, 1>(x, residual, out, scale, bias, B, G, cpg,
                      pick_groups(G, cpg, HW, 1, sizeof(T)), HW, eps, relu, stream);
}

}  // namespace

// x, residual (or null) and out: B frames of G groups of cpg channels over HW
// pixels, contiguous in one dtype (bf16 if is_bf16, else f32), channels last:
// element (b, s, c) at (b * HW + s) * G * cpg + c. scale, bias (G * cpg) f32.
// cpg * HW < 2^31.
extern "C" int maed_groupnorm(int is_bf16, const void* x, const void* residual, void* out,
                              const float* scale, const float* bias, int B, int G, int cpg,
                              int HW, float eps, int relu, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<bf16>(x, residual, out, scale, bias, B, G, cpg, HW, eps, relu, s);
  return dispatch<float>(x, residual, out, scale, bias, B, G, cpg, HW, eps, relu, s);
}
