// GroupNorm (+ residual) (+ ReLU) of the hybrid stem, f32 or bf16.
//
// Replaces the Pallas kernel maed_tpu/ops/groupnorm.py::_gn_kernel (pallas_call
// in `_gn_pallas`, public entry `fused_groupnorm`), which the stem norm and
// every bottleneck norm of the ResNetV2 stem reach: 52 calls per forward, the
// 16 bottlenecks' norm3 with the shortcut as the residual and the ReLU after it
// (the model's relu(norm3(y) + shortcut), fused).
//
// What bounds it on the H100: memory. A call reads the activation (and the
// residual) once and writes it once and does a handful of operations per
// element; the 52 sites of a flagship request (128 frames, 112 x 112 x 64 down
// to 14 x 14 x 1024) read 2.9 GB and write 2.9 GB in bf16, 5.83 GB: 1.74 ms at
// 3.35 TB/s, 2.19 ms with the 16 residual reads; the stem norm alone 411 MB.
//
// The TPU kernel holds a frame (H, W, C) in VMEM, one frame a grid step, and
// pools the per-channel moments with a (C, C) group-averaging matmul, because
// Mosaic cannot reshape across lanes. The layout is channels last (B, HW, C),
// the JAX layout and what cuDNN hands the port's stem, which is fed
// channels-last frames.
//
// bf16, groupnorm_cluster_kernel: a thread-block cluster of 1, 2, 4 or 8 CTAs
// owns a frame, as a grid step does on the TPU. CTA r takes the pixels
// [r * P, (r + 1) * P) with all C channels: one contiguous byte range, which
// one thread loads with TMA bulk copies (cp.async.bulk, kClChunks of them on
// as many mbarriers) into shared memory, so every element comes from device
// memory once, in whole 128-byte lines. The threads sum each chunk as it
// lands: thread t keeps the f32 sums and sums of squares of the 8 channels of
// one 16-byte column (t % (C / 8)) over every (256 / (C / 8))-th pixel; the
// block pools them per channel, then per group. The CTAs of the cluster
// exchange those per-group (sum, sum of squares) through distributed shared
// memory: each reads every member's (mapa + ld.shared::cluster, one float a
// thread, summed in rank order, so every member forms the same moments)
// between two cluster barriers. Then y = x * mul + add (+ residual) (ReLU) is
// applied out of shared memory in bf16x2 arithmetic (the roundings below, in
// a quarter of the instructions of f32 with a conversion after each step) and
// written once with 16-byte stores; the residual is prefetched into L2 by a
// bulk prefetch while the moments are taken and read with 16-byte loads, 8 in
// flight a thread. The clusters are persistent, as many as the card holds at
// once, each walking over frames: as soon as every thread has applied a
// chunk, its shared memory takes the next frame's chunk, so that frame's
// loads overlap this frame's stores. The wrapper
// (ops/groupnorm.py::cluster_size) gives a frame the fewest CTAs, at least 2,
// whose shares fit (a 1.6 MB frame: 8 of 196 KB, one CTA an SM); at most stem
// sites more CTAs with smaller shares were slower (tools/bench_kernels.py), as
// were 512 threads a CTA and non-portable clusters of 16 at two CTAs an SM.
//
// f32, and bf16 shapes the cluster kernel does not take (C not 8 x a power
// of two up to 2048, a frame over 8 CTAs' shared memory), groupnorm_kernel: a
// block owns the channels of one group of one frame (or of a few neighbouring
// groups): their elements are staged in shared memory while the f32 sums and
// sums of squares are taken, so the activation comes from device memory once;
// then y = x * mul + add is applied out of shared memory. A block whose
// elements do not fit is read a second time (from L2, mostly). A group is cpg
// neighbouring channels of every pixel, a few bytes at a stride of C. Device
// memory moves 32-byte sectors, so a block takes as many neighbouring groups as
// share up to 128 bytes of a pixel and still fit in shared memory
// (pick_groups), a thread reads 16 bytes (V = 8 bf16 or 4 f32 channels) of them
// at the same place in every pixel it visits, and keeps a sum per channel
// slot; the slots are pooled per group at the end. 16-byte loads and stores
// where the widths and the alignment allow, else element by element (V = 1).
//
// Rounding points as groupnorm.py:83-108, in both kernels: f32 moments as
// E[x^2] - m^2 over the group, mul = scale * rsqrt(var + eps) and add = bias -
// mean * mul in f32 from f32 scale and bias, both rounded to x's dtype, then
// x * mul, + add, + residual, each rounded to x's dtype, then the ReLU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"  // bulk copies, mbarriers, cluster barriers, distributed shared memory

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

// ------------------------------------------------- bf16: a cluster a frame

constexpr int kClThreads = 256, kClWarps = kClThreads / 32;
constexpr int kClChunks = 8;      // bulk copies, each on its own mbarrier, a CTA
// 16-byte chunks a thread applies at once: with a residual, as many of its
// loads in flight
template <bool kRes>
constexpr int kClUnroll = kRes ? 8 : 4;
constexpr int kClSmem = 232448;   // the dynamic shared memory a block may have
constexpr int kClMaxRanks = 8;    // CTAs a cluster
constexpr int kClMaxGroups = 64;

// Rows of partial sums the block pools, for C / 8 = cols 16-byte columns: a
// warp's lanes of one column are summed by shuffles where a warp spans whole
// pixels (one row a warp), else each thread's sums are a row of their own.
__host__ __device__ constexpr int cl_rows(int cols) {
  return cols < 32 ? kClWarps : kClThreads / cols;
}
// Shared memory before the staged x, in floats: the groups' (sum, sum of
// squares) that the cluster reads (2G); every member's as read from it
// (ranks x 2G); the channels' totals, then the groups' mean and rstd (2C);
// the partial rows (cl_rows x 2C). The mbarriers come first, x after,
// 128-byte aligned.
__host__ __device__ constexpr size_t cl_x_offset(int G, int C, int ranks) {
  return (kClChunks * 8 +
          (2 * G + ranks * 2 * G + 2 * C + cl_rows(C / 8) * 2 * C) * sizeof(float) + 127) /
         128 * 128;
}
// the dynamic shared memory of a CTA that stages P pixels of C bf16 channels
__host__ __device__ constexpr size_t cl_smem(int G, int C, int ranks, int P) {
  return cl_x_offset(G, C, ranks) + static_cast<size_t>(P) * C * sizeof(bf16);
}

// x (B, HW, C) normalised a frame at a time by persistent clusters of
// `ranks` CTAs (1D clusters along x): cluster k takes frames k, k + clusters,
// ...; CTA `rank` owns pixels [rank P, (rank + 1) P) of each (fewer, or none,
// at the end). C / 8 is a power of two up to 256, so thread t always holds
// channels 8 (t % (C / 8)) .. + 7. kRes: residual is read (else null).
template <bool kRes>
__global__ void __launch_bounds__(kClThreads) groupnorm_cluster_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ residual, bf16* __restrict__ out,
    const float* __restrict__ scale, const float* __restrict__ bias, int B, int G, int C, int HW,
    int P, float eps, int relu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rank = static_cast<int>(cluster_rank()), ranks = static_cast<int>(cluster_ranks());
  const int clusters = gridDim.x / ranks, p0 = rank * P;
  const int np = max(0, min(P, HW - p0));  // this CTA's pixels of every frame
  const int cols = C / 8, cpg = C / G, rows = cl_rows(cols);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t bars = smem_u32(smem_raw);
  float* part_s = reinterpret_cast<float*>(smem_raw + kClChunks * 8);  // 2G
  float* all_s = part_s + 2 * G;                                        // ranks x 2G
  float* chan_s = all_s + ranks * 2 * G;                                // 2C
  float* red_s = chan_s + 2 * C;                                        // rows x 2C
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw + cl_x_offset(G, C, ranks));
  const int per_chunk = (np + kClChunks - 1) / kClChunks;  // pixels a bulk copy
  const int chunks = per_chunk ? (np + per_chunk - 1) / per_chunk : 0;
  // the CTA's first element of frame f, and bulk copy i of that frame
  auto first = [&](int f) { return (static_cast<size_t>(f) * HW + p0) * C; };
  auto load = [&](int f, int i) {
    const int pixel = i * per_chunk;
    const uint32_t bytes = min(per_chunk, np - pixel) * C * sizeof(bf16);
    mbar_expect_tx(bars + 8 * i, bytes);
    bulk_load(smem_u32(x_s + static_cast<size_t>(pixel) * C),
              x + first(f) + static_cast<size_t>(pixel) * C, bytes, bars + 8 * i);
  };
  const int f0 = blockIdx.x / ranks;
  if (tid == 0) {
    for (int i = 0; i < chunks; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (f0 < B)
      for (int i = 0; i < chunks; ++i) load(f0, i);
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits on them

  const int col = tid % cols, row = tid / cols, step = kClThreads / cols;
  constexpr int kUnroll = kClUnroll<kRes>;
  for (int f = f0, it = 0; f < B; f += clusters, ++it) {
    const uint4* res = kRes ? reinterpret_cast<const uint4*>(residual + first(f)) : nullptr;
    if (kRes && tid == 0 && np > 0)  // read in the apply pass: from L2 by then
      bulk_prefetch_l2(residual + first(f), np * C * sizeof(bf16));
    // per channel of the thread's column: sums over every step-th pixel of
    // each chunk, as it lands
    float s[8] = {}, q[8] = {};
    for (int i = 0; i < chunks; ++i) {
      mbar_wait(bars + 8 * i, it & 1);
      const int end = min((i + 1) * per_chunk, np);
#pragma unroll 4
      for (int p = i * per_chunk + row; p < end; p += step) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(x_s + static_cast<size_t>(p) * C + col * 8);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float f = __bfloat162float(e[k]);
          s[k] += f;
          q[k] += f * f;
        }
      }
    }
    int prow = row;  // the partial row this thread writes, or -1
    if (cols < 32) {
      for (int off = 16; off >= cols; off >>= 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
          q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
        }
      }
      prow = lane < cols ? warp : -1;
    }
    if (prow >= 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        red_s[2 * prow * C + col * 8 + k] = s[k];
        red_s[(2 * prow + 1) * C + col * 8 + k] = q[k];
      }
    }
    __syncthreads();
    for (int c = tid; c < 2 * C; c += kClThreads) {  // c / C picks the sum or the squares
      float total = 0.f;
      for (int r = 0; r < rows; ++r) total += red_s[(2 * r + c / C) * C + c % C];
      chan_s[c] = total;
    }
    // the other members have read part_s of the last frame (since the arrive
    // after their reads)
    if (it > 0) cluster_wait();
    __syncthreads();
    for (int g = tid; g < G; g += kClThreads) {
      float a = 0.f, b = 0.f;
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
        a += chan_s[c];
        b += chan_s[C + c];
      }
      part_s[g] = a;
      part_s[G + g] = b;
    }
    // the residual of the first chunks applied, in flight across the exchange
    const int end0 = min(per_chunk, np) * cols;
    uint4 r[kUnroll];
    if (kRes) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = tid + u * kClThreads;
        r[u] = j < end0 ? __ldg(res + j) : make_uint4(0, 0, 0, 0);
      }
    }
    cluster_arrive();  // every member's part_s is written ...
    cluster_wait();
    // ... and read by every member, one float a thread
    for (int i = tid; i < ranks * 2 * G; i += kClThreads)
      all_s[i] = ld_cluster_f32(smem_u32(part_s + i % (2 * G)), i / (2 * G));
    cluster_arrive();  // done with the others' part_s: waited for before it is written again
    __syncthreads();
    for (int g = tid; g < G; g += kClThreads) {  // summed in rank order: every member alike
      float a = 0.f, b = 0.f;
      for (int r = 0; r < ranks; ++r) {
        a += all_s[r * 2 * G + g];
        b += all_s[r * 2 * G + G + g];
      }
      const float count = static_cast<float>(cpg) * HW, mean = a / count;
      chan_s[g] = mean;
      chan_s[G + g] = rsqrtf(b / count - mean * mean + eps);
    }
    __syncthreads();
    // the thread's channels' mul and add, rounded to bf16, as pairs
    __nv_bfloat162 m[4], a[4];
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      float mul[2], add[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col * 8 + k + h, g = c / cpg;
        mul[h] = __ldg(scale + c) * chan_s[G + g];
        add[h] = __ldg(bias + c) - chan_s[g] * mul[h];
      }
      m[k / 2] = __floats2bfloat162_rn(mul[0], mul[1]);
      a[k / 2] = __floats2bfloat162_rn(add[0], add[1]);
    }
    const int next = f + clusters;

    // chunk by chunk: once every thread has applied chunk i, its shared
    // memory takes the next frame's chunk i while the rest is applied
    const uint4* xs = reinterpret_cast<const uint4*>(x_s);
    uint4* dst = reinterpret_cast<uint4*>(out + first(f));
    for (int i = 0; i < chunks; ++i) {
      const int end = min((i + 1) * per_chunk, np) * cols;  // 16-byte chunks: column j % cols
      for (int j0 = i * per_chunk * cols + tid; j0 < end; j0 += kClThreads * kUnroll) {
        if (kRes && j0 != tid) {  // (the first block's are loaded)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u * kClThreads;
            r[u] = j < end ? __ldg(res + j) : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * kClThreads;
          if (j >= end) break;
          // bf16x2 arithmetic, each product and sum rounded once to bf16:
          // the same bits as the f32 operation rounded to bf16 (a product
          // of two bf16 values is exact in f32; a sum is too, or its smaller
          // term lies far below the larger's rounding step either way). The
          // _rn forms keep the compiler from contracting x * mul + add into
          // one fma, which would round once instead of twice.
          uint4 v = xs[j];
          __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&v);
          const __nv_bfloat162* re = reinterpret_cast<const __nv_bfloat162*>(&r[u]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            y[k] = __hadd2_rn(__hmul2_rn(y[k], m[k]), a[k]);
            if (kRes) y[k] = __hadd2_rn(y[k], re[k]);
            if (relu) y[k] = __hmax2(y[k], __float2bfloat162_rn(0.f));
          }
          dst[j] = v;
        }
      }
      if (next < B) {
        __syncthreads();  // chunk i is read by every thread
        if (tid == 0) load(next, i);
      }
    }
  }
  cluster_wait();  // no member leaves while another may still read its part_s
}

// Persistent clusters a device and shape, as many as can be resident at once
// (cudaOccupancyMaxActiveClusters, asked once for each (kernel, device,
// ranks, shared memory) and kept).
template <bool kRes>
int resident_clusters(const cudaLaunchConfig_t& config) {
  constexpr int kSlots = 64;
  struct Slot {
    int device, ranks;
    size_t smem;
    int clusters;
  };
  static Slot slots[kSlots];
  static int used = 0;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  const int ranks = static_cast<int>(config.attrs[0].val.clusterDim.x);
  for (int i = 0; i < used; ++i)
    if (slots[i].device == device && slots[i].ranks == ranks &&
        slots[i].smem == config.dynamicSmemBytes)
      return slots[i].clusters;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, groupnorm_cluster_kernel<kRes>, &config) !=
      cudaSuccess)
    return 0;
  if (used < kSlots) slots[used++] = Slot{device, ranks, config.dynamicSmemBytes, clusters};
  return clusters;
}

// B frames, by persistent clusters of `ranks` CTAs (1, 2, 4 or 8) of
// ceil(HW / ranks) pixels; C / 8 a power of two up to 256, G dividing C and
// at most kClMaxGroups, and the CTA's shared memory within kClSmem, else
// cudaErrorInvalidValue.
template <bool kRes>
int launch_cluster_kernel(cudaLaunchConfig_t& config, const void* x, const void* residual,
                          void* out, const float* scale, const float* bias, int B, int G, int C,
                          int HW, int P, int ranks, float eps, int relu) {
  if (const cudaError_t err = allow_smem<groupnorm_cluster_kernel<kRes>>(kClSmem))
    return static_cast<int>(err);
  config.gridDim = dim3(static_cast<unsigned>(min(B, 65535)) * ranks);
  const int resident = resident_clusters<kRes>(config);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  config.gridDim = dim3(static_cast<unsigned>(min(B, resident)) * ranks);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, groupnorm_cluster_kernel<kRes>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(residual), static_cast<bf16*>(out), scale, bias, B, G, C, HW, P,
      eps, relu);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// B frames, by persistent clusters of `ranks` CTAs (1, 2, 4 or 8) of
// ceil(HW / ranks) pixels; C / 8 a power of two up to 256, G dividing C and
// at most kClMaxGroups, and the CTA's shared memory within kClSmem, else
// cudaErrorInvalidValue.
int launch_cluster(const void* x, const void* residual, void* out, const float* scale,
                   const float* bias, int B, int G, int C, int HW, int ranks, float eps, int relu,
                   cudaStream_t stream) {
  const int cols = C / 8, P = (HW + ranks - 1) / ranks;
  if (C % 8 || cols > 256 || (cols & (cols - 1)) || G <= 0 || G > kClMaxGroups || C % G ||
      ranks < 1 || ranks > kClMaxRanks || (ranks & (ranks - 1)) ||
      cl_smem(G, C, ranks, P) > kClSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kClThreads);
  config.dynamicSmemBytes = cl_smem(G, C, ranks, P);
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return residual != nullptr
             ? launch_cluster_kernel<true>(config, x, residual, out, scale, bias, B, G, C, HW, P,
                                           ranks, eps, relu)
             : launch_cluster_kernel<false>(config, x, residual, out, scale, bias, B, G, C, HW,
                                            P, ranks, eps, relu);
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

// bf16 x, residual (or null) and out (B, HW, C), channels last, 16-byte
// aligned; scale, bias (C) f32; G groups, at most 64. A cluster of `ranks`
// CTAs (1, 2, 4 or 8) a frame; C / 8 a power of two up to 256, and the CTAs'
// share of a frame within their shared memory (ops/groupnorm.py::cluster_size).
extern "C" int maed_groupnorm_cluster(const void* x, const void* residual, void* out,
                                      const float* scale, const float* bias, int B, int G, int C,
                                      int HW, int ranks, float eps, int relu, void* stream) {
  return launch_cluster(x, residual, out, scale, bias, B, G, C, HW, ranks, eps, relu,
                        static_cast<cudaStream_t>(stream));
}
