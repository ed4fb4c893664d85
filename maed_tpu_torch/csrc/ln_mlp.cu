// The ViT block's MLP half:  out = x + fc2(gelu(fc1(LayerNorm(x)))), f32 or bf16.
//
// Replaces the Pallas kernel maed_tpu/ops/mlp.py::_mlp_kernel (pallas_call in
// `_mlp_pallas`, public entry `fused_ln_mlp`), which the JAX package runs by
// default in the eval forward on the TPU: 6 calls at the flagship depth.
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
// Both launches are one GEMM kernel, A (M x K) times W^T with W (N x K) as
// nn.Linear stores it (the column-major B operand the tensor cores want), with
// the LayerNorm as an optional prologue and the two epilogues:
//
// bf16 (the serving path): a block computes a 128 x 128 tile with 8 warps, each
// a 64 x 32 sub-tile of nvcuda::wmma 16x16x16 bf16 fragments with f32
// accumulators, walking K in steps of 32 through two shared-memory stages. The W
// tile (and the A tile of launch 2) arrive by 16-byte cp.async while the
// previous stage is multiplied; launch 1 first computes the f32 statistics of its
// 128 rows (one warp per row), then loads each next A tile into registers,
// normalizes it and stores it to the other stage. The epilogue stages each
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

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

enum class Epilogue { kBiasGelu, kBiasResidual };

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

template <bool kLayerNorm, Epilogue kEpi>
__global__ void __launch_bounds__(kThreads) gemm_bf16_kernel(
    const bf16* __restrict__ a, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float eps, const bf16* __restrict__ w,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    bf16* __restrict__ out, int M, int N, int K) {
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
  uint4 a_next[2];
  auto load_a_regs = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8;
      a_next[i] = (m0 + r < M && k0 + kc < K)
                      ? *reinterpret_cast<const uint4*>(a + static_cast<size_t>(m0 + r) * K + k0 + kc)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_a_normalized = [&](bf16* dst, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8, k = k0 + kc;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k < K) {
        const bf16* xv = reinterpret_cast<const bf16*>(&a_next[i]);
        bf16* yv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = __bfloat162float(xv[e]);
          yv[e] = __float2bfloat16((x - mean_s[r]) * rstd_s[r] * ln_scale[k + e] + ln_bias[k + e]);
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
  if constexpr (kLayerNorm) {
    load_a_regs(0);
    store_a_normalized(a_s[0], 0);
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
      if constexpr (kLayerNorm) {
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
      if constexpr (kLayerNorm) store_a_normalized(a_s[nxt], (kt + 1) * BK);
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
        if constexpr (kEpi == Epilogue::kBiasGelu) {
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

template <bool kLayerNorm, Epilogue kEpi>
__global__ void __launch_bounds__(kF32Threads) gemm_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float eps, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int M, int N, int K) {
  __shared__ float a_s[kF32Tile * kF32Pitch];
  __shared__ float w_s[kF32Tile * kF32Pitch];
  __shared__ float c_s[kF32Tile * kF32Ldc];
  __shared__ float mean_s[kF32Tile];
  __shared__ float rstd_s[kF32Tile];

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
    if constexpr (kEpi == Epilogue::kBiasGelu) {
      out[o] = gelu_erf(v);
    } else {
      out[o] = residual[o] + v;
    }
  }
}

// ---------------------------------------------------------------- launches

template <bool kLayerNorm, Epilogue kEpi>
int launch(int is_bf16, const void* a, const float* ln_scale, const float* ln_bias, float eps,
           const void* w, const float* bias, const void* residual, void* out, int M, int N,
           int K, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bf16_kernel<kLayerNorm, kEpi><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(a), ln_scale, ln_bias, eps, static_cast<const bf16*>(w), bias,
        static_cast<const bf16*>(residual), static_cast<bf16*>(out), M, N, K);
  } else {
    const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
    gemm_f32_kernel<kLayerNorm, kEpi><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(a), ln_scale, ln_bias, eps, static_cast<const float*>(w), bias,
        static_cast<const float*>(residual), static_cast<float*>(out), M, N, K);
  }
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
  return launch<true, Epilogue::kBiasGelu>(is_bf16, x, ln_scale, ln_bias, eps, w1, b1, nullptr,
                                           h, M, H, C, static_cast<cudaStream_t>(stream));
}

// Launch 2. h (M, H), w2 (C, H), x and out (M, C) in one dtype; b2 (C) f32.
extern "C" int maed_fc2_residual(int is_bf16, const void* h, const void* w2,
                                 const float* b2, const void* x, void* out, int M,
                                 int H, int C, void* stream) {
  return launch<false, Epilogue::kBiasResidual>(is_bf16, h, nullptr, nullptr, 0.f, w2, b2, x,
                                                out, M, C, H, static_cast<cudaStream_t>(stream));
}
