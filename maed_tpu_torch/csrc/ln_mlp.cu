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
// What bounds the MLP on the H100: the two products. At the flagship shape
// (M = 25216 tokens, C = 768, H = 3072) they are 2 x 119 GFLOP: 0.24 ms at the
// bf16 tensor-core peak of 989 TFLOP/s, against 38.7 MB of x in and out. The
// TPU kernel keeps both weight matrices resident in VMEM and h on chip; 227 KB
// of shared memory cannot hold the 4.7 MB weights, so h (155 MB in bf16) goes
// through device memory. The qkv projection is 89 GFLOP (0.09 ms at the peak)
// against 158 MB moved.
//
// The rounding points are those of mlp.py:99-113 and :157-165: f32 row
// statistics as E[x^2] - m^2, LN(x) = (x - m) * rstd * scale + bias in f32
// rounded to x's dtype, f32 accumulation, the f32 bias added there, exact-erf
// GELU in f32, h rounded to x's dtype (as the TPU kernel does before fc2), the
// fc2 result rounded to x's dtype and then added to x. So every split below is
// exact.
//
// bf16 (the serving path), kernels C and D:
//
//   1. ln_rows_kernel: LN(x) rounded to bf16, a warp per row with 16-byte
//      loads, the row held in registers (up to 1024 wide). A GEMM tile meets
//      its rows in 9 (qkv) or 12 (fc1) column tiles, so normalizing once per
//      row costs one more read and write of x (2 x 38.7 MB, ~0.023 ms at 3.35
//      TB/s) instead of 9-12 normalizations of every A tile.
//   2. dense_bf16_kernel<Epi>: out = epilogue(A @ W^T), A (M x K) and W
//      (N x K, as nn.Linear stores it) both K-major, the layout wgmma reads
//      from shared memory without a transpose. Persistent and warp-specialised
//      (hopper.cuh): one TMA producer thread fills a ring of 4 stages, each a
//      128 x 64 tile of A and a 256 x 64 tile of W (16 + 32 KB of 128-byte rows
//      under the 128-byte swizzle); two consumer warpgroups each take 64 rows
//      of the 128 x 256 output tile as m64n256k16 wgmmas, one k-step's group
//      in flight while the previous step's stage is released. The tiles are
//      walked in groups of 8 row blocks per column sweep, so that the W tiles
//      of a sweep are read from L2 while they are hot. TMA zero-fills loads
//      past M, N and K. The epilogue (+ bias, then GELU or + residual, one
//      rounding to bf16 pairs) writes a consumer's outputs into a staging
//      buffer of its own in the swizzled layout of 64 x 64 TMA boxes, and one
//      thread stores the boxes by TMA (which leaves out what lies past M or
//      N) while the consumer goes on to its next tile; the producer has
//      meanwhile filled the ring with that tile's first stages.
//
//   C: ln_rows, dense<BiasGelu> -> h (M x H), dense<BiasResidual> (+ x).
//   D: ln_rows, dense<BiasOnly>.
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
//   2. gate_proj: the blend y_t * a_t + y_s * a_s (each product and the sum
//      rounded to the dtype, as mlp.py:292 in bf16) as the prologue of a GEMM
//      on the A tile, then + f32 bias, rounded, + x. The TPU kernel's column
//      permutation of the gate (lane-aligned slices for Mosaic) is not needed:
//      a pair is two neighbouring rows.
//
// bf16 gate_proj (gate_proj_bf16_kernel): a block computes a 128 x 128 tile
// with 8 warps, each a 64 x 32 sub-tile of nvcuda::wmma 16x16x16 bf16
// fragments with f32 accumulators, walking K in steps of 32 through two
// shared-memory stages: the W tile arrives by 16-byte cp.async while the
// previous stage is multiplied, the next blended A tile is loaded into
// registers, computed and stored to the other stage. The epilogue stages each
// 16 x 16 accumulator through shared memory and writes 16-byte rows. Rows and
// columns need a multiple of 8 elements.
//
// f32 (the reference eval protocol's dtype), all three: gemm_f32_kernel, a
// 64 x 64 tile with 128 threads, each a 4 x 8 micro-tile of scalar FMAs, no
// TF32, with the LayerNorm (statistics of the block's rows first) or the blend
// as the A tile's prologue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"  // TMA, mbarriers, setmaxnreg, wgmma

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
__device__ void row_stats(const float* __restrict__ x, int m0, int rows, int M, int K, float eps,
                          float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int r = warp; r < rows; r += warps) {
    const int m = m0 + r;
    float s = 0.f, ss = 0.f;
    if (m < M) {
      const float* row = x + static_cast<size_t>(m) * K;
      for (int k = lane; k < K; k += 32) {
        const float v = row[k];
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

// ------------------------------------------------------- bf16: LN once a row

constexpr int kLnWarps = 8;        // warps a block
constexpr int kLnMaxChunks = 4;    // 16-byte chunks a lane holds: rows of up to 1024
constexpr int kLnBlocksPerSm = 8;  // 2048 threads an SM

// out (M x K) = LN(x) rounded to bf16, a warp per row: warp w of the grid
// takes rows w, w + warps, ...; K a multiple of 8, x and out 16-byte aligned.
// Lane l takes the 16-byte chunks l, l + 32, ... of a row. With kChunks > 0
// (K <= 256 kChunks) it holds them in registers, so that a row is read once
// with all its loads in flight together, and the block first stages the LN
// scale and bias in shared memory (2K floats), read as float4: read per row
// from global memory, their scattered scalar loads took more L1 wavefronts
// than the row itself. With 0 (any K) a lane reads a row twice, the second
// time from L1, and the scale and bias from global memory. At (25216, 768)
// on an H100 the held kernel takes 0.032 ms, the loop 0.064, or 0.046 with
// the scale and bias staged (tools/bench_kernels.py, device time).
template <int kChunks>
__global__ void __launch_bounds__(kLnWarps * 32) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float eps, bf16* __restrict__ out, int M, int K) {
  extern __shared__ __align__(16) float ln_s[];  // kChunks > 0: scale (K), then bias (K)
  constexpr int kHeld = kChunks > 0 ? kChunks : 1;
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * kLnWarps;
  if constexpr (kChunks > 0) {
    for (int k = threadIdx.x; k < K; k += kLnWarps * 32) {
      ln_s[k] = __ldg(ln_scale + k);
      ln_s[K + k] = __ldg(ln_bias + k);
    }
    __syncthreads();
  }
  for (long long m = static_cast<long long>(blockIdx.x) * kLnWarps + threadIdx.x / 32; m < M;
       m += warps) {
    const bf16* row = x + m * K;
    bf16* dst = out + m * K;
    float s = 0.f, ss = 0.f;
    auto accumulate = [&](const uint4& chunk) {
      const bf16* v = reinterpret_cast<const bf16*>(&chunk);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __bfloat162float(v[e]);
        s += f;
        ss += f * f;
      }
    };
    uint4 held[kHeld];
    if constexpr (kChunks > 0) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int k = (lane + 32 * i) * 8;
        held[i] = k < K ? *reinterpret_cast<const uint4*>(row + k) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kChunks; ++i) accumulate(held[i]);
    } else {
      for (int k = lane * 8; k < K; k += 32 * 8)
        accumulate(*reinterpret_cast<const uint4*>(row + k));
    }
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mean = s / K, rstd = rsqrtf(ss / K - mean * mean + eps);
    auto normalize = [&](const uint4& chunk, int k, const float (&sc)[8], const float (&sh)[8]) {
      const bf16* v = reinterpret_cast<const bf16*>(&chunk);
      uint4 packed;
      bf16* y = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __float2bfloat16((__bfloat162float(v[e]) - mean) * rstd * sc[e] + sh[e]);
      *reinterpret_cast<uint4*>(dst + k) = packed;
    };
    if constexpr (kChunks > 0) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int k = (lane + 32 * i) * 8;
        if (k < K) {
          float sc[8], sh[8];
          *reinterpret_cast<float4*>(sc) = *reinterpret_cast<const float4*>(ln_s + k);
          *reinterpret_cast<float4*>(sc + 4) = *reinterpret_cast<const float4*>(ln_s + k + 4);
          *reinterpret_cast<float4*>(sh) = *reinterpret_cast<const float4*>(ln_s + K + k);
          *reinterpret_cast<float4*>(sh + 4) = *reinterpret_cast<const float4*>(ln_s + K + k + 4);
          normalize(held[i], k, sc, sh);
        }
      }
    } else {
      for (int k = lane * 8; k < K; k += 32 * 8) {
        float sc[8], sh[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[e] = __ldg(ln_scale + k + e);
          sh[e] = __ldg(ln_bias + k + e);
        }
        normalize(*reinterpret_cast<const uint4*>(row + k), k, sc, sh);
      }
    }
  }
}

// the kernel that holds a row in registers if K allows, else the one for any
// K, kLnBlocksPerSm blocks an SM walking over the rows
int launch_ln_rows(const void* x, const float* ln_scale, const float* ln_bias, float eps,
                   void* out, int M, int K, cudaStream_t stream) {
  const bool held = K <= kLnMaxChunks * 32 * 8;
  const size_t smem = held ? 2 * static_cast<size_t>(K) * sizeof(float) : 0;  // <= 8 KB
  const int grid = persistent_ctas((static_cast<long long>(M) + kLnWarps - 1) / kLnWarps,
                                   kLnBlocksPerSm);
  const auto kernel = held ? ln_rows_kernel<kLnMaxChunks> : ln_rows_kernel<0>;
  kernel<<<grid, kLnWarps * 32, smem, stream>>>(static_cast<const bf16*>(x), ln_scale, ln_bias,
                                                eps, static_cast<bf16*>(out), M, K);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- bf16: the dense GEMM (TMA + wgmma)

constexpr int kDnBM = 128, kDnBN = 256;  // the output tile
constexpr int kDnBK = 64;                // a k-step: 128-byte rows, one swizzle span
constexpr int kDnStages = 4;
constexpr int kDnGroupM = 8;             // row blocks a column sweep walks
constexpr int kDnA = kDnBM * kDnBK * 2;  // bytes of a stage's A tile (16 KB)
constexpr int kDnStage = kDnA + kDnBN * kDnBK * 2;  // + its W tile (32 KB)
// A consumer stores its 64 x 256 outputs in two rounds of 64 x 128 through a
// staging buffer of its own: two TMA boxes of 64 x 64 (128-byte rows under
// the 128-byte swizzle, 8 KB each)
constexpr int kDnBox = 64, kDnBoxBytes = kDnBox * kDnBox * 2;
constexpr int kDnOut = kDnStages * kDnStage;                 // the two staging buffers
constexpr int kDnBars = kDnOut + kConsumers * 2 * kDnBoxBytes;  // then the mbarriers
constexpr int kDnBytes = kDnBars + 2 * kDnStages * 8 + 1024;  // + alignment: 230464

// The origin (m0, n0) of output tile t: groups of kDnGroupM row blocks, each
// swept column tile by column tile, the row block fastest.
__device__ __forceinline__ void dense_tile(int t, int tiles_m, int tiles_n, int& m0, int& n0) {
  const int first = t / (kDnGroupM * tiles_n) * kDnGroupM;
  const int rows = min(kDnGroupM, tiles_m - first), local = t - first * tiles_n;
  m0 = (first + local % rows) * kDnBM;
  n0 = local / rows * kDnBN;
}

// The K-major operand of a stage's tile at `tile` (128-byte rows under the
// 128-byte swizzle; 8-row groups 1024 bytes apart): rows row0 .., the 16
// columns of k-step kk (32 bytes further along the swizzled row).
__device__ __forceinline__ uint64_t dense_desc(uint32_t tile, int row0, int kk) {
  return smem_desc(tile + row0 * kDnBK * 2 + kk * 32, 16, 8 * kDnBK * 2, 1);
}

// The consumer's 64 x 256 accumulator, rows row0 .., columns n0 ..: + bias,
// then Epi, rounded to bf16 pairs, in two rounds of 128 columns: the pairs go
// to the staging buffer `stage` (at `stage_s` in the shared window) as the
// TMA boxes lay them out, then one thread stores the round's boxes that lie
// below M and N (a box's part past them is not written). Thread t of warp w
// holds acc[4j + e] at row 16w + t/4 + 8(e/2), column 8j + 2(t%4) + e%2;
// within a box row r, the 16-byte chunk c lies at chunk c ^ (r % 8), so the
// 8 rows of a warp's store fall in 8 different banks.
template <typename Epi>
__device__ __forceinline__ void dense_epilogue(const float (&acc)[kDnBN / 2],
                                               const float* __restrict__ bias,
                                               const bf16* __restrict__ residual,
                                               const CUtensorMap& out_map, unsigned char* stage,
                                               uint32_t stage_s, int wg, int row0, int n0, int M,
                                               int N) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const bool leader = threadIdx.x % 128 == 0;
  const int r0 = 16 * warp + lane / 4, t = lane % 4;  // the thread's first row in the 64
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (leader) bulk_wait<0, true>();  // the previous round's boxes have left the buffer
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = 16 * h + jj, col = n0 + 8 * j + 2 * t;
      const bool live = col < N;  // N even: the pair is all in or all out
      const float b0 = live ? __ldg(bias + col) : 0.f, b1 = live ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const float v0 = acc[4 * j + 2 * r] + b0, v1 = acc[4 * j + 2 * r + 1] + b1;
        __nv_bfloat162 y;
        if constexpr (kSame<Epi, BiasOnly>) {
          y = __floats2bfloat162_rn(v0, v1);
        } else if constexpr (kSame<Epi, BiasGelu>) {
          y = __floats2bfloat162_rn(gelu_erf(v0), gelu_erf(v1));
        } else {
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          __nv_bfloat162 res = __floats2bfloat162_rn(0.f, 0.f);
          if (live && row0 + row < M)
            res = *reinterpret_cast<const __nv_bfloat162*>(
                residual + static_cast<size_t>(row0 + row) * N + col);
          y = __floats2bfloat162_rn(__low2float(res) + __low2float(v),
                                    __high2float(res) + __high2float(v));
        }
        const int box = jj / 8, chunk = (jj % 8) ^ (row % 8);
        *reinterpret_cast<__nv_bfloat162*>(stage + box * kDnBoxBytes + row * 128 + chunk * 16 +
                                           4 * t) = y;
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);
    if (leader && row0 < M) {
#pragma unroll
      for (int box = 0; box < 2; ++box) {
        const int c0 = n0 + 128 * h + kDnBox * box;
        if (c0 < N) tma_store_2d(out_map, stage_s + box * kDnBoxBytes, c0, row0);
      }
      bulk_commit();
    }
  }
}

// out (M x N) = Epi(A @ W^T + bias), A (M x K) and W (N x K) through the
// tensor maps a_map and w_map and out through out_map (make_matrix_map);
// residual (M x N) for BiasResidual. grid: persistent, one CTA a SM over the
// output tiles.
template <typename Epi>
__global__ void __launch_bounds__(kCtaThreads, 1) dense_bf16_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap out_map, const float* __restrict__ bias,
    const bf16* __restrict__ residual, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  const uint32_t smem = smem_u32(base);
  const uint32_t full = smem + kDnBars, empty = full + 8 * kDnStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDnStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_m = (M + kDnBM - 1) / kDnBM, tiles_n = (N + kDnBN - 1) / kDnBN;
  const int tiles = tiles_m * tiles_n, steps = (K + kDnBK - 1) / kDnBK;

  if (threadIdx.x < 128) {  // the producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        dense_tile(t, tiles_m, tiles_n, m0, n0);
        for (int k = 0; k < steps; ++k) {
          mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1);
          const uint32_t bar = full + 8 * ring.slot, stage = smem + ring.slot * kDnStage;
          mbar_expect_tx(bar, kDnStage);  // whole boxes, also where they lie past the matrix
          tma_load_2d(stage, a_map, bar, k * kDnBK, m0);
          tma_load_2d(stage + kDnA, w_map, bar, k * kDnBK, n0);
          ring.next(kDnStages);
        }
      }
    }
  } else {  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of a tile
    regs_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int out_off = kDnOut + wg * 2 * kDnBoxBytes;
    Ring ring;
    float acc[kDnBN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      dense_tile(t, tiles_m, tiles_n, m0, n0);
      int prev = 0;
      for (int k = 0; k < steps; ++k) {
        mbar_wait(full + 8 * ring.slot, ring.phase);
        const uint32_t a_t = smem + ring.slot * kDnStage, w_t = a_t + kDnA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDnBK / 16; ++kk)
          Wgmma<kDnBN>::ss(acc, dense_desc(a_t, 64 * wg, kk), dense_desc(w_t, 0, kk),
                           k > 0 || kk > 0);
        wgmma_commit();
        if (k > 0) {
          wgmma_wait<1>();  // step k - 1's products have read their stage
          mbar_arrive(empty + 8 * prev);
        }
        prev = ring.slot;
        ring.next(kDnStages);
      }
      wgmma_wait<0>();
      fence_regs<kDnBN / 2>(acc);
      mbar_arrive(empty + 8 * prev);
      dense_epilogue<Epi>(acc, bias, residual, out_map, base + out_off, smem + out_off, wg,
                          m0 + 64 * wg, n0, M, N);
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0, false>();  // the last stores have landed
  }
}

// The 2D tensor map of a row-major (rows x cols) bf16 matrix, in boxes of 64
// columns (128 bytes) by box_rows rows under the 128-byte swizzle; a box, or
// the part of one, past the matrix arrives as zeros (loads) or is not
// written (stores). Returns 0, or kTensorMapError + the encoder's CUresult.
int make_matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// The maps are built at each call (the operands' pointers change); the
// shared-memory limit is raised once.
template <typename Epi>
int launch_dense_bf16(const void* a, const void* w, const float* bias, const void* residual,
                      void* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (const int err = make_matrix_map(&maps[0], a, M, K, kDnBM)) return err;
  if (const int err = make_matrix_map(&maps[1], w, N, K, kDnBN)) return err;
  if (const int err = make_matrix_map(&maps[2], out, M, N, kDnBox)) return err;
  if (const cudaError_t err = allow_smem<dense_bf16_kernel<Epi>>(kDnBytes))
    return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((M + kDnBM - 1) / kDnBM) * ((N + kDnBN - 1) / kDnBN);
  dense_bf16_kernel<Epi><<<persistent_ctas(tiles), kCtaThreads, kDnBytes, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<const bf16*>(residual), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- bf16: gate_proj (wmma)

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

// out = x + (blend @ w^T + bias), blend = a2 * alpha[.., 1] + a * alpha[.., 0]:
// row m belongs to frame m / rows_per_frame, whose gate is alpha + frame * 2K,
// (spatial, temporal) pairs per column. Two blocks to an SM: at 256 threads
// that caps a thread at 128 registers, where the blend would take 130-134 (a
// few bytes spill) and leave the SM with one block, which costs a third of
// the launch's time.
__global__ void __launch_bounds__(kThreads, 2) gate_proj_bf16_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ a2, const bf16* __restrict__ alpha,
    int rows_per_frame, const bf16* __restrict__ w, const float* __restrict__ bias,
    const bf16* __restrict__ residual, bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 a_s[2][BM * kPitch];
  __shared__ __align__(128) bf16 w_s[2][BN * kPitch];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32

  // Each thread moves 2 chunks of 8 elements of each 128 x 32 tile:
  // chunk c = tid + i * kThreads is row c / 4, columns (c % 4) * 8 .. + 7.
  auto load_w_async = [&](bf16* dst, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8;
      const bool ok = n0 + r < N && k0 + kc < K;
      cp_async16(dst + r * kPitch + kc, ok ? w + static_cast<size_t>(n0 + r) * K + k0 + kc : w,
                 ok);
    }
  };
  uint4 a_next[2], a2_next[2];
  auto load_a_regs = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      const size_t o = static_cast<size_t>(m0 + r) * K + k0 + kc;
      a_next[i] = ok ? *reinterpret_cast<const uint4*>(a + o) : make_uint4(0, 0, 0, 0);
      a2_next[i] = ok ? *reinterpret_cast<const uint4*>(a2 + o) : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_a_blended = [&](bf16* dst, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8, k = k0 + kc;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k < K) {
        const bf16* xv = reinterpret_cast<const bf16*>(&a_next[i]);
        bf16* yv = reinterpret_cast<bf16*>(&packed);
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
      *reinterpret_cast<uint4*>(dst + r * kPitch + kc) = packed;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_w_async(w_s[0], 0);
  load_a_regs(0);
  store_a_blended(a_s[0], 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < nk;
    if (more) {  // stage kt + 1 while stage kt is multiplied
      load_w_async(w_s[nxt], (kt + 1) * BK);
      load_a_regs((kt + 1) * BK);
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
      store_a_blended(a_s[nxt], (kt + 1) * BK);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // Epilogue: each 16 x 16 accumulator goes through this warp's 1 KB of the
  // (now idle) A stages; lane l then finishes row l / 2, columns (l % 2) * 8 .. + 7:
  // + bias, rounded, + residual, rounded.
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
        const uint4 res4 = *reinterpret_cast<const uint4*>(residual + o);
        const bf16* res = reinterpret_cast<const bf16*>(&res4);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bf16 v = __float2bfloat16(stage[r * 16 + c0 + e] + bias[n + e]);
          y[e] = __float2bfloat16(__bfloat162float(res[e]) + __bfloat162float(v));
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
  const float* a2 = nullptr;
  const float* alpha = nullptr;
  int rows_per_frame = 1;
};

template <typename Pro, typename Epi>
int launch_f32(const float* a, Gate gate, const float* ln_scale, const float* ln_bias, float eps,
               const float* w, const float* bias, const float* residual, float* out, int M,
               int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
  gemm_f32_kernel<Pro, Epi><<<grid, kF32Threads, 0, stream>>>(
      a, gate.a2, gate.alpha, gate.rows_per_frame, ln_scale, ln_bias, eps, w, bias, residual,
      out, M, N, K);
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

// bf16 LN(x) rounded to bf16: x and out (M, C), ln_scale and ln_bias (C) f32;
// C a multiple of 8, x and out 16-byte aligned.
extern "C" int maed_ln_rows(const void* x, const float* ln_scale, const float* ln_bias,
                            float eps, void* out, int M, int C, void* stream) {
  return launch_ln_rows(x, ln_scale, ln_bias, eps, out, M, C, static_cast<cudaStream_t>(stream));
}

// bf16 out (M, N) = epilogue(a @ w^T + bias): a (M, K), w (N, K), bias (N)
// f32, residual (M, N) for epilogue 2; epilogue 0 is + bias, 1 + bias then
// GELU, 2 + bias, rounded, then + residual. K and N multiples of 8, a and w
// 16-byte aligned (a tensor map's rule), residual and out 4-byte aligned. A
// map the encoder refuses is kTensorMapError (10000) + its CUresult.
extern "C" int maed_dense_bf16(int epilogue, const void* a, const void* w, const float* bias,
                               const void* residual, void* out, int M, int N, int K,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0: return launch_dense_bf16<BiasOnly>(a, w, bias, residual, out, M, N, K, s);
    case 1: return launch_dense_bf16<BiasGelu>(a, w, bias, residual, out, M, N, K, s);
    case 2: return launch_dense_bf16<BiasResidual>(a, w, bias, residual, out, M, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32 out (M, N) = epilogue(A @ w^T + bias), epilogues as maed_dense_bf16's,
// each with the prologue its launch needs: A = LayerNorm(a) over each row
// (ln_scale, ln_bias (K)) for 0, D, and 1, C's fc1; A = a for 2, C's fc2.
extern "C" int maed_dense_f32(int epilogue, const float* a, const float* ln_scale,
                              const float* ln_bias, float eps, const float* w, const float* bias,
                              const float* residual, float* out, int M, int N, int K,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0:
      return launch_f32<LayerNormRows, BiasOnly>(a, Gate{}, ln_scale, ln_bias, eps, w, bias,
                                                 nullptr, out, M, N, K, s);
    case 1:
      return launch_f32<LayerNormRows, BiasGelu>(a, Gate{}, ln_scale, ln_bias, eps, w, bias,
                                                 nullptr, out, M, N, K, s);
    case 2:
      return launch_f32<NoPrologue, BiasResidual>(a, Gate{}, nullptr, nullptr, 0.f, w, bias,
                                                  residual, out, M, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  const auto s = static_cast<cudaStream_t>(stream);
  const int M = BT * N;
  if (is_bf16) {
    const dim3 grid((C + BN - 1) / BN, (M + BM - 1) / BM);
    gate_proj_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(y_s), static_cast<const bf16*>(y_t),
        static_cast<const bf16*>(alpha), N, static_cast<const bf16*>(w_p), b_p,
        static_cast<const bf16*>(x), static_cast<bf16*>(out), M, C, C);
    return static_cast<int>(cudaGetLastError());
  }
  Gate gate;
  gate.a2 = static_cast<const float*>(y_t);
  gate.alpha = static_cast<const float*>(alpha);
  gate.rows_per_frame = N;
  return launch_f32<GateBlend, BiasResidual>(static_cast<const float*>(y_s), gate, nullptr,
                                             nullptr, 0.f, static_cast<const float*>(w_p), b_p,
                                             static_cast<const float*>(x),
                                             static_cast<float*>(out), M, C, C, s);
}
