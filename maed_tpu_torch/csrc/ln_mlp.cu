// The ViT block's fused dense paths, f32 or bf16:
//   the MLP half,          out = x + fc2(gelu(fc1(LayerNorm(x))))
//   the qkv projection,    qkv = LayerNorm(x) @ Wqkv^T + b
//   the attention's tail,  out = x + proj(y_t * a_t + y_s * a_s), with the
//                          per-frame, per-channel gate (a_s, a_t)
//
// Replaces the Pallas kernels maed_tpu/ops/mlp.py::_mlp_kernel (pallas_call in
// `_mlp_pallas`, public entry `fused_ln_mlp`), which the JAX package runs by
// default in the eval forward on the TPU, and ::_ln_dense_kernel (pallas_call
// in `_ln_dense_pallas`, public entry `fused_ln_dense`), which fuses norm1
// into the qkv projection, and ::_gate_proj_kernel (pallas_call in
// `_gate_proj_pallas`, public entry `fused_gate_proj`), the tail of the
// parallel attention: 6 calls each at the flagship depth.
//
// What bounds it on the H100: the two products. At the flagship shape
// (M = 25216 tokens, C = 768, H = 3072) they are 2 x 119 GFLOP: 0.24 ms at the
// bf16 tensor-core peak of 989 TFLOP/s, against 38.7 MB of x in and out. The
// TPU kernel keeps both weight matrices resident in VMEM and h on chip; 227 KB
// of shared memory cannot hold the 4.7 MB weights, so this version is two
// launches and h (155 MB in bf16) goes through device memory:
//
//   1. ln_fc1_gelu:   h   = gelu(LN(x) @ W1^T + b1)                 (M x H)
//   2. fc2_residual:  out = x + (h @ W2^T + b2)                     (M x C)
//
// The rounding points are those of mlp.py:99-113: f32 row statistics, LN(x)
// rounded to x's dtype, f32 accumulation, b1 and b2 added in f32, exact-erf GELU
// in f32, h rounded to x's dtype (as the TPU kernel does before fc2), the fc2
// result rounded to x's dtype and then added to x. So the split is exact.
//
// The qkv projection is launch 1 with a plain bias epilogue (M x 2304 out of
// K = 768: 89 GFLOP, 0.09 ms at the peak, against 158 MB moved), rounding as
// mlp.py:157-165: f32 statistics, LN(x) rounded to x's dtype, f32
// accumulation, the f32 bias added before the one rounding of the output.
//
// The attention's tail (mlp.py:272-296) reads the two branch outputs y_s and
// y_t (BT, N, C) and the block input x, 4 x 38.7 MB in bf16 (0.046 ms at
// 3.35 TB/s) against 30 GFLOP of proj (0.030 ms at the peak): memory bounds it.
// The TPU kernel takes one frame per grid step, so a step has the frame's two
// branch means, hence its gate, before it blends and projects. A 128-row GEMM
// tile here spans frames (N = 197), and the gate needs all N rows of a frame
// before the first blended one, so it is two launches:
//
//   1. gate_alpha: a block per frame takes the f32 means over N of y_s and
//      y_t (partial sums of row groups through shared memory), rounds them to
//      the dtype, multiplies them with the (2C x 2C) gate weight (a warp per
//      channel takes the two rows of its (spatial, temporal) logit pair; the
//      4.7 MB weight stays in L2 across the 128 blocks), adds the f32 bias and
//      writes the 2-way softmax, rounded, as alpha (BT, C, 2): what the TPU
//      kernel returns as its second output.
//   2. gate_proj: the GEMM below with the blend y_t * a_t + y_s * a_s (each
//      product and the sum rounded to the dtype, as mlp.py:292 in bf16) as its
//      prologue on the A tile, and launch 2's epilogue: + f32 bias, rounded,
//      + x. The TPU kernel's column permutation of the gate (lane-aligned
//      slices for Mosaic) is not needed: a pair is two neighbouring rows.
//
// All dense launches are one GEMM kernel, A (M x K) times W^T with W (N x K) as
// nn.Linear stores it (the column-major B operand the tensor cores want), with
// the LayerNorm or the gate's blend as an optional prologue and three epilogues:
//
// bf16 (the serving path): a block computes a 128 x 128 tile with 8 warps, each
// a 64 x 32 sub-tile of nvcuda::wmma 16x16x16 bf16 fragments with f32
// accumulators, walking K in steps of 32 through two shared-memory stages. The W
// tile (and the A tile of launch 2) arrive by 16-byte cp.async while the
// previous stage is multiplied; launch 1 first computes the f32 statistics of its
// 128 rows (one warp per row), then loads each next A tile into registers,
// normalizes it and stores it to the other stage (the blend likewise, from
// the two branches' tiles). The epilogue stages each
// 16 x 16 accumulator through shared memory and writes 16-byte rows. Rows and
// columns need a multiple of 8 elements (C and H here). wgmma, TMA, more
// stages and keeping h on chip are later work.
//
// f32 (the reference eval protocol's dtype): a 64 x 64 tile with 128 threads,
// each a 4 x 8 micro-tile of scalar FMAs, no TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// The prologues and epilogues, as types so that a profile names each launch:
// + bias (the qkv projection), + bias then GELU (fc1), + bias then + residual
// (fc2 and the attention's proj).
struct NoPrologue {};
struct LayerNormRows {};  // A = LayerNorm(a) over each row
struct GateBlend {};      // A = a2 * alpha[.., 1] + a * alpha[.., 0], alpha per frame and column
struct BiasOnly {};
struct BiasGelu {};
struct BiasResidual {};
template <typename A, typename B>
constexpr bool kSame = std::is_same<A, B>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// f32 row statistics of rows m0 .. m0 + rows - 1 of x (M x K), as E[x^2] - m^2,
// one warp per row: mean_s[r] and rstd_s[r] = rsqrt(var + eps).
template <typename T>
__device__ void row_stats(const T* __restrict__ x, int m0, int rows, int M, int K, float eps,
                          float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int r = warp; r < rows; r += warps) {
    const int m = m0 + r;
    float s = 0.f, ss = 0.f;
    if (m < M) {
      const T* row = x + static_cast<size_t>(m) * K;
      for (int k = lane; k < K; k += 32) {
        const float v = to_f32(row[k]);
        s += v;
        ss += v * v;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      const float mean = s / K;
      mean_s[r] = mean;
      rstd_s[r] = rsqrtf(ss / K - mean * mean + eps);
    }
  }
}

// ---------------------------------------------------------------- bf16

constexpr int BM = 128, BN = 128, BK = 32, kThreads = 256;
constexpr int kPitch = BK + 8;  // 80-byte rows: 16-byte aligned, as wmma and cp.async need

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Two blocks to an SM: at 256 threads that caps a thread at 128 registers,
// where the prologues would take 130-134 (a few bytes spill) and leave the SM
// with one block, which costs a third of the launch's time.
// a2, alpha and rows_per_frame serve GateBlend alone: row m belongs to frame
// m / rows_per_frame, whose gate is alpha + frame * 2K, (spatial, temporal)
// pairs per column.
template <typename Pro, typename Epi>
__global__ void __launch_bounds__(kThreads, 2) gemm_bf16_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ a2, const bf16* __restrict__ alpha,
    int rows_per_frame, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float eps, const bf16* __restrict__ w,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    bf16* __restrict__ out, int M, int N, int K) {
  constexpr bool kLayerNorm = kSame<Pro, LayerNormRows>, kBlend = kSame<Pro, GateBlend>;
  constexpr bool kThroughRegs = kLayerNorm || kBlend;  // the A tile is computed, not copied
  __shared__ __align__(128) bf16 a_s[2][BM * kPitch];
  __shared__ __align__(128) bf16 w_s[2][BN * kPitch];
  __shared__ float mean_s[BM];
  __shared__ float rstd_s[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32

  if constexpr (kLayerNorm) {
    row_stats(a, m0, BM, M, K, eps, mean_s, rstd_s);
    __syncthreads();
  }

  // Each thread moves 2 chunks of 8 elements of each 128 x 32 tile:
  // chunk c = tid + i * kThreads is row c / 4, columns (c % 4) * 8 .. + 7.
  auto load_async = [&](bf16* dst, const bf16* src, int rows, int row0, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8;
      const bool ok = row0 + r < rows && k0 + kc < K;
      cp_async16(dst + r * kPitch + kc,
                 ok ? src + static_cast<size_t>(row0 + r) * K + k0 + kc : src, ok);
    }
  };
  uint4 a_next[2], a2_next[kBlend ? 2 : 1];
  auto load_a_regs = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      const size_t o = static_cast<size_t>(m0 + r) * K + k0 + kc;
      a_next[i] = ok ? *reinterpret_cast<const uint4*>(a + o) : make_uint4(0, 0, 0, 0);
      if constexpr (kBlend)
        a2_next[i] = ok ? *reinterpret_cast<const uint4*>(a2 + o) : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_a_computed = [&](bf16* dst, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8, k = k0 + kc;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k < K) {
        const bf16* xv = reinterpret_cast<const bf16*>(&a_next[i]);
        bf16* yv = reinterpret_cast<bf16*>(&packed);
        if constexpr (kLayerNorm) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float x = __bfloat162float(xv[e]);
            yv[e] = __float2bfloat16((x - mean_s[r]) * rstd_s[r] * ln_scale[k + e] + ln_bias[k + e]);
          }
        } else {
          const bf16* tv = reinterpret_cast<const bf16*>(&a2_next[i]);
          const uint4* gate = reinterpret_cast<const uint4*>(
              alpha + (static_cast<size_t>((m0 + r) / rows_per_frame) * K + k) * 2);
          const uint4 pairs[2] = {gate[0], gate[1]};  // 8 (spatial, temporal) pairs
          const bf16* g = reinterpret_cast<const bf16*>(pairs);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bf16 t = __float2bfloat16(__bfloat162float(tv[e]) * __bfloat162float(g[2 * e + 1]));
            const bf16 s = __float2bfloat16(__bfloat162float(xv[e]) * __bfloat162float(g[2 * e]));
            yv[e] = __float2bfloat16(__bfloat162float(t) + __bfloat162float(s));
          }
        }
      }
      *reinterpret_cast<uint4*>(dst + r * kPitch + kc) = packed;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_async(w_s[0], w, N, n0, 0);
  if constexpr (kThroughRegs) {
    load_a_regs(0);
    store_a_computed(a_s[0], 0);
  } else {
    load_async(a_s[0], a, M, m0, 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < nk;
    if (more) {  // stage kt + 1 while stage kt is multiplied
      load_async(w_s[nxt], w, N, n0, (kt + 1) * BK);
      if constexpr (kThroughRegs) {
        load_a_regs((kt + 1) * BK);
      } else {
        load_async(a_s[nxt], a, M, m0, (kt + 1) * BK);
      }
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a_s[cur] + (wm * 64 + i * 16) * kPitch + kk, kPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfrag[j], w_s[cur] + (wn * 32 + j * 16) * kPitch + kk, kPitch);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfrag[j], acc[i][j]);
    }
    if (more) {
      if constexpr (kThroughRegs) store_a_computed(a_s[nxt], (kt + 1) * BK);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // Epilogue: each 16 x 16 accumulator goes through this warp's 1 KB of the
  // (now idle) A stages; lane l then finishes row l / 2, columns (l % 2) * 8 .. + 7.
  float* stage = reinterpret_cast<float*>(a_s[0]) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 64 + i * 16 + r, n = n0 + wn * 32 + j * 16 + c0;
      if (m < M && n < N) {  // N % 8 == 0: the 8 columns are all in or all out
        const size_t o = static_cast<size_t>(m) * N + n;
        uint4 packed;
        bf16* y = reinterpret_cast<bf16*>(&packed);
        if constexpr (kSame<Epi, BiasOnly>) {
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = __float2bfloat16(stage[r * 16 + c0 + e] + bias[n + e]);
        } else if constexpr (kSame<Epi, BiasGelu>) {
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = __float2bfloat16(gelu_erf(stage[r * 16 + c0 + e] + bias[n + e]));
        } else {
          const uint4 res4 = *reinterpret_cast<const uint4*>(residual + o);
          const bf16* res = reinterpret_cast<const bf16*>(&res4);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bf16 v = __float2bfloat16(stage[r * 16 + c0 + e] + bias[n + e]);
            y[e] = __float2bfloat16(__bfloat162float(res[e]) + __bfloat162float(v));
          }
        }
        *reinterpret_cast<uint4*>(out + o) = packed;
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int kF32Tile = 64, kF32K = 32, kF32Threads = 128;
constexpr int kF32Pitch = kF32K + 1;  // odd: the micro-tile's column reads spread over the banks
constexpr int kF32Ldc = kF32Tile + 4;

template <typename Pro, typename Epi>
__global__ void __launch_bounds__(kF32Threads) gemm_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ a2, const float* __restrict__ alpha,
    int rows_per_frame, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float eps, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int M, int N, int K) {
  __shared__ float a_s[kF32Tile * kF32Pitch];
  __shared__ float w_s[kF32Tile * kF32Pitch];
  __shared__ float c_s[kF32Tile * kF32Ldc];
  __shared__ float mean_s[kF32Tile];
  __shared__ float rstd_s[kF32Tile];

  constexpr bool kLayerNorm = kSame<Pro, LayerNormRows>, kBlend = kSame<Pro, GateBlend>;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kF32Tile, n0 = blockIdx.x * kF32Tile;
  if constexpr (kLayerNorm) {
    row_stats(a, m0, kF32Tile, M, K, eps, mean_s, rstd_s);
    __syncthreads();
  }

  const int ty = tid / 8, tx = tid % 8;  // rows ty*4 + i, columns tx + 8*j
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32K) {
    for (int idx = tid; idx < kF32Tile * kF32K; idx += kF32Threads) {
      const int r = idx / kF32K, c = idx % kF32K, m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < M && k < K) {
        v = a[static_cast<size_t>(m) * K + k];
        if constexpr (kLayerNorm) v = (v - mean_s[r]) * rstd_s[r] * ln_scale[k] + ln_bias[k];
        if constexpr (kBlend) {
          const float* g = alpha + (static_cast<size_t>(m / rows_per_frame) * K + k) * 2;
          v = a2[static_cast<size_t>(m) * K + k] * g[1] + v * g[0];
        }
      }
      a_s[r * kF32Pitch + c] = v;
    }
    for (int idx = tid; idx < kF32Tile * kF32K; idx += kF32Threads) {
      const int r = idx / kF32K, c = idx % kF32K, n = n0 + r, k = k0 + c;
      w_s[r * kF32Pitch + c] = (n < N && k < K) ? w[static_cast<size_t>(n) * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kF32K; ++kk) {
      float av[4], wv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[(ty * 4 + i) * kF32Pitch + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = w_s[(tx + 8 * j) * kF32Pitch + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c_s[(ty * 4 + i) * kF32Ldc + tx + 8 * j] = acc[i][j];
  __syncthreads();

  for (int idx = tid; idx < kF32Tile * kF32Tile; idx += kF32Threads) {
    const int r = idx / kF32Tile, c = idx % kF32Tile, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float v = c_s[r * kF32Ldc + c] + bias[n];
    const size_t o = static_cast<size_t>(m) * N + n;
    if constexpr (kSame<Epi, BiasOnly>) {
      out[o] = v;
    } else if constexpr (kSame<Epi, BiasGelu>) {
      out[o] = gelu_erf(v);
    } else {
      out[o] = residual[o] + v;
    }
  }
}

// ---------------------------------------------------------------- launches

// The gate's operands, for the GateBlend prologue alone.
struct Gate {
  const void* a2 = nullptr;
  const void* alpha = nullptr;
  int rows_per_frame = 1;
};

template <typename Pro, typename Epi>
int launch(int is_bf16, const void* a, Gate gate, const float* ln_scale, const float* ln_bias,
           float eps, const void* w, const float* bias, const void* residual, void* out, int M,
           int N, int K, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bf16_kernel<Pro, Epi><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(gate.a2),
        static_cast<const bf16*>(gate.alpha), gate.rows_per_frame, ln_scale, ln_bias, eps,
        static_cast<const bf16*>(w), bias, static_cast<const bf16*>(residual),
        static_cast<bf16*>(out), M, N, K);
  } else {
    const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
    gemm_f32_kernel<Pro, Epi><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(gate.a2),
        static_cast<const float*>(gate.alpha), gate.rows_per_frame, ln_scale, ln_bias, eps,
        static_cast<const float*>(w), bias, static_cast<const float*>(residual),
        static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- the gate

constexpr int kGateThreads = 512, kGateRowGroups = 4;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};
__device__ __forceinline__ void cast_to(float v, float& o) { o = v; }
__device__ __forceinline__ void cast_to(float v, bf16& o) { o = __float2bfloat16(v); }

// alpha (BT, C, 2) of frame blockIdx.x from y_s, y_t (BT, N, C), w_ts (2C, 2C)
// as nn.Linear stores it and b_ts (2C) f32. Rows are walked in chunks of V
// elements (C a multiple of V). Shared memory: kGateRowGroups x 2C partial
// sums, then the 2C means.
template <typename T, int V>
__global__ void __launch_bounds__(kGateThreads) gate_alpha_kernel(
    const T* __restrict__ ys, const T* __restrict__ yt, const T* __restrict__ w_ts,
    const float* __restrict__ b_ts, T* __restrict__ alpha, int N, int C) {
  extern __shared__ __align__(16) float gate_s[];
  float* part_s = gate_s;                            // kGateRowGroups x 2C
  float* mean_s = gate_s + kGateRowGroups * 2 * C;   // 2C: [mean y_s | mean y_t], rounded
  using P = Pack<T, V>;
  constexpr int kPerGroup = kGateThreads / kGateRowGroups;
  const int tid = threadIdx.x, group = tid / kPerGroup, member = tid % kPerGroup;
  const size_t frame = static_cast<size_t>(blockIdx.x) * N * C;

  // row group g sums rows g, g + kGateRowGroups, ... of both branches
  for (int which = 0; which < 2; ++which) {
    const T* src = (which ? yt : ys) + frame;
    for (int c = member * V; c < C; c += kPerGroup * V) {
      float sum[V] = {};
#pragma unroll 4
      for (int n = group; n < N; n += kGateRowGroups) {
        const P p = *reinterpret_cast<const P*>(src + static_cast<size_t>(n) * C + c);
#pragma unroll
        for (int e = 0; e < V; ++e) sum[e] += to_f32(p.v[e]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) part_s[(group * 2 + which) * C + c + e] = sum[e];
    }
  }
  __syncthreads();
  for (int j = tid; j < 2 * C; j += kGateThreads) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kGateRowGroups; ++g) total += part_s[g * 2 * C + j];
    T mean;
    cast_to(total / N, mean);
    mean_s[j] = to_f32(mean);
  }
  __syncthreads();

  // a warp per channel c: logits 2c (spatial) and 2c + 1 (temporal)
  const int warp = tid / 32, lane = tid % 32;
  for (int c = warp; c < C; c += kGateThreads / 32) {
    const T* row = w_ts + static_cast<size_t>(2 * c) * 2 * C;
    float ls = 0.f, lt = 0.f;
    for (int k = lane * V; k < 2 * C; k += 32 * V) {
      const P ws = *reinterpret_cast<const P*>(row + k);
      const P wt = *reinterpret_cast<const P*>(row + 2 * C + k);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ls = fmaf(mean_s[k + e], to_f32(ws.v[e]), ls);
        lt = fmaf(mean_s[k + e], to_f32(wt.v[e]), lt);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    }
    if (lane == 0) {
      ls += b_ts[2 * c];
      lt += b_ts[2 * c + 1];
      const float top = fmaxf(ls, lt), es = expf(ls - top), et = expf(lt - top);
      Pack<T, 2> pair;
      cast_to(es / (es + et), pair.v[0]);
      cast_to(et / (es + et), pair.v[1]);
      *reinterpret_cast<Pack<T, 2>*>(alpha + (static_cast<size_t>(blockIdx.x) * C + c) * 2) = pair;
    }
  }
}

template <typename T, int V>
int launch_gate_alpha(const void* ys, const void* yt, const void* w_ts, const float* b_ts,
                      void* alpha, int BT, int N, int C, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kGateRowGroups + 1) * 2 * C * sizeof(float);
  auto kernel = gate_alpha_kernel<T, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<BT, kGateThreads, smem, stream>>>(
      static_cast<const T*>(ys), static_cast<const T*>(yt), static_cast<const T*>(w_ts), b_ts,
      static_cast<T*>(alpha), N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch 1. x (M, C), w1 (H, C) and h (M, H) in one dtype (bf16 if is_bf16,
// else f32); ln_scale, ln_bias (C) and b1 (H) f32. All contiguous on the device;
// for bf16, C and H multiples of 8 and x, w1 16-byte aligned.
extern "C" int maed_ln_fc1_gelu(int is_bf16, const void* x, const float* ln_scale,
                                const float* ln_bias, float eps, const void* w1,
                                const float* b1, void* h, int M, int C, int H,
                                void* stream) {
  return launch<LayerNormRows, BiasGelu>(is_bf16, x, Gate{}, ln_scale, ln_bias, eps, w1, b1,
                                         nullptr, h, M, H, C, static_cast<cudaStream_t>(stream));
}

// The qkv projection: launch 1's kernel with the bias-only epilogue. x (M, C),
// w (O, C) and out (M, O) in one dtype; ln_scale, ln_bias (C) and b (O) f32.
extern "C" int maed_ln_dense(int is_bf16, const void* x, const float* ln_scale,
                             const float* ln_bias, float eps, const void* w, const float* b,
                             void* out, int M, int C, int O, void* stream) {
  return launch<LayerNormRows, BiasOnly>(is_bf16, x, Gate{}, ln_scale, ln_bias, eps, w, b,
                                         nullptr, out, M, O, C, static_cast<cudaStream_t>(stream));
}

// Launch 2. h (M, H), w2 (C, H), x and out (M, C) in one dtype; b2 (C) f32.
extern "C" int maed_fc2_residual(int is_bf16, const void* h, const void* w2,
                                 const float* b2, const void* x, void* out, int M,
                                 int H, int C, void* stream) {
  return launch<NoPrologue, BiasResidual>(is_bf16, h, Gate{}, nullptr, nullptr, 0.f, w2, b2, x,
                                          out, M, C, H, static_cast<cudaStream_t>(stream));
}

// The gate, launch 1 of the attention's tail. y_s, y_t (BT, N, C), w_ts
// (2C, 2C) and alpha (BT, C, 2) in one dtype; b_ts (2C) f32. For bf16, C a
// multiple of 8 and y_s, y_t, w_ts 16-byte aligned. (4 + 1) * 2C floats of
// shared memory must fit the block (227 KB).
extern "C" int maed_gate_alpha(int is_bf16, const void* y_s, const void* y_t, const void* w_ts,
                               const float* b_ts, void* alpha, int BT, int N, int C,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_gate_alpha<bf16, 8>(y_s, y_t, w_ts, b_ts, alpha, BT, N, C, s);
  return launch_gate_alpha<float, 1>(y_s, y_t, w_ts, b_ts, alpha, BT, N, C, s);
}

// Launch 2 of the attention's tail: out = x + ((y_t * a_t + y_s * a_s) @ w_p^T
// + b_p). y_s, y_t, x and out (BT * N, C), alpha (BT, C, 2) and w_p (C, C) in
// one dtype; b_p (C) f32. For bf16 also alpha 16-byte aligned.
extern "C" int maed_gate_proj(int is_bf16, const void* y_s, const void* y_t, const void* alpha,
                              const void* w_p, const float* b_p, const void* x, void* out,
                              int BT, int N, int C, void* stream) {
  Gate gate;
  gate.a2 = y_t;
  gate.alpha = alpha;
  gate.rows_per_frame = N;
  return launch<GateBlend, BiasResidual>(is_bf16, y_s, gate, nullptr, nullptr, 0.f, w_p, b_p, x,
                                         out, BT * N, C, C, static_cast<cudaStream_t>(stream));
}
