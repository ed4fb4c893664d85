// The ViT block's fused dense paths, f32 or bf16 (kernels C, D and E):
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
//   E: (below) the means, the gate and the blend, then dense<ProjResidual>.
//
// The attention's tail (mlp.py:272-296) reads the two branch outputs y_s and
// y_t (BT, N, C) and the block input x, 4 x 38.7 MB in bf16 (0.046 ms at
// 3.35 TB/s) against 30 GFLOP of proj (0.030 ms at the peak): memory bounds it.
// The TPU kernel takes one frame per grid step, so a step has the frame's two
// branch means, hence its gate, before it blends and projects. A GEMM tile
// here spans frames (N = 197), and the gate needs all N rows of a frame
// before the first blended one, so the tail is four launches, each over the
// whole card (kernel E, bf16, one C call, maed_gate_proj):
//
//   1. gate_means_kernel: the f32 means over N of y_s and y_t, rounded to the
//      dtype as mlp.py:277-279 rounds them, into (BT, 2C) = [mean y_s | mean
//      y_t] per frame. A block takes 256 channels of one branch of one frame
//      (8 row groups of 32 16-byte columns, pooled in shared memory): 768
//      blocks at the flagship shape, so the 77 MB are read by every SM.
//   2. gate_alpha_bf16_kernel: the gate as one batched product, (BT, 2C) x
//      w_ts^T + b_ts, bf16 operands and f32 accumulation with mma.sync
//      m16n8k16 (0.6 GFLOP: the tensor cores take it in a few microseconds,
//      where SIMT f32 would need ~10 at its peak). A block takes 64 frames x
//      32 logits through a 4-stage cp.async ring of 128-wide k-slices, so each
//      w_ts element comes from device memory once for every 64 frames (not
//      once a frame). The accumulator fragment holds neighbouring columns
//      (2c, 2c + 1) in one thread: the (spatial, temporal) pair's 2-way
//      softmax is taken there, and alpha is written rounded as (BT, C, 2),
//      what the TPU kernel returns as its second output.
//   3. gate_blend_kernel: y = rnd(rnd(y_t * a_t) + rnd(y_s * a_s)), the
//      dtype's roundings of mlp.py:292, into a bf16 (BT * N, C) buffer: like
//      ln_rows for C and D, one pass of 16-byte chunks (116 MB moved) instead
//      of a blend in the GEMM's A path, which TMA cannot compute.
//   4. dense_bf16_kernel<ProjResidual>: the GEMM of C and D with the bias +
//      residual epilogue, out = x + rnd(y @ w_p^T + b_p), the rounding of
//      mlp.py:294-295. ProjResidual is BiasResidual's code under a tag of
//      its own, so that a profile tells E's product from C's fc2.
//
// The TPU kernel's column permutation of the gate (lane-aligned slices for
// Mosaic) is not needed: a pair is two neighbouring rows of w_ts.

// f32 (the reference eval protocol's dtype), all three: gemm_f32_kernel, a
// 64 x 64 tile with 128 threads, each a 4 x 8 micro-tile of scalar FMAs, no
// TF32, with the LayerNorm (statistics of the block's rows first) or the blend
// as the A tile's prologue; E's means as in bf16, its gate product by
// gate_alpha_f32_kernel (a warp a logit pair and 8 frames, SIMT f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"  // TMA, mbarriers, setmaxnreg, wgmma

namespace {

using bf16 = __nv_bfloat16;

// The prologues and epilogues, as types so that a profile names each launch:
// + bias (the qkv projection), + bias then GELU (fc1), + bias then + residual
// (fc2; ProjResidual, the same code, the attention's proj).
struct NoPrologue {};
struct LayerNormRows {};  // A = LayerNorm(a) over each row
struct GateBlend {};      // A = a2 * alpha[.., 1] + a * alpha[.., 0], alpha per frame and column
struct BiasOnly {};
struct BiasGelu {};
struct BiasResidual {};
struct ProjResidual {};
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

// ------------------------------------------------- the gate (kernel E)

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};
__device__ __forceinline__ void cast_to(float v, float& o) { o = v; }
__device__ __forceinline__ void cast_to(float v, bf16& o) { o = __float2bfloat16(v); }

constexpr int kMeanThreads = 256, kMeanGroups = kMeanThreads / 32;  // row groups a block

// means (BT, 2C) = [mean_n y_s | mean_n y_t] per frame in f32, rounded to T:
// block (frame, branch, column block) takes 32 columns of V channels over
// the N rows, row group g (a warp) the rows g, g + kMeanGroups, ...; the
// groups' sums are pooled in shared memory in order. C a multiple of V.
template <typename T, int V>
__global__ void __launch_bounds__(kMeanThreads) gate_means_kernel(
    const T* __restrict__ ys, const T* __restrict__ yt, T* __restrict__ means, int N, int C) {
  __shared__ float part_s[kMeanGroups][32 * V];
  using P = Pack<T, V>;
  const int blocks_c = (C + 32 * V - 1) / (32 * V);
  const int cb = blockIdx.x % blocks_c, which = blockIdx.x / blocks_c % 2;
  const int frame = blockIdx.x / blocks_c / 2;
  const int lane = threadIdx.x % 32, group = threadIdx.x / 32;
  const int c = (cb * 32 + lane) * V;  // the thread's first channel
  const T* src = (which ? yt : ys) + static_cast<size_t>(frame) * N * C;
  float sum[V] = {};
  if (c < C) {
#pragma unroll 4
    for (int n = group; n < N; n += kMeanGroups) {
      const P p = *reinterpret_cast<const P*>(src + static_cast<size_t>(n) * C + c);
#pragma unroll
      for (int e = 0; e < V; ++e) sum[e] += to_f32(p.v[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part_s[group][lane * V + e] = sum[e];
  __syncthreads();
  for (int j = threadIdx.x; j < 32 * V; j += kMeanThreads) {
    const int ch = cb * 32 * V + j;
    if (ch >= C) break;
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kMeanGroups; ++g) total += part_s[g][j];
    T mean;
    cast_to(total / N, mean);
    means[static_cast<size_t>(frame) * 2 * C + which * C + ch] = mean;
  }
}

template <typename T, int V>
int launch_gate_means(const void* ys, const void* yt, void* means, int BT, int N, int C,
                      cudaStream_t stream) {
  const long long blocks = static_cast<long long>(BT) * 2 * ((C + 32 * V - 1) / (32 * V));
  gate_means_kernel<T, V><<<static_cast<unsigned>(blocks), kMeanThreads, 0, stream>>>(
      static_cast<const T*>(ys), static_cast<const T*>(yt), static_cast<T*>(means), N, C);
  return static_cast<int>(cudaGetLastError());
}

// the pair (ls, lt) of logits as its 2-way softmax (a_s, a_t)
__device__ __forceinline__ void pair_softmax(float ls, float lt, float& as, float& at) {
  const float top = fmaxf(ls, lt), es = expf(ls - top), et = expf(lt - top);
  as = es / (es + et);
  at = et / (es + et);
}

// bf16: a block of 4 warps takes kGtM frames x kGtN logits; warp w the 16
// frames 16w .., as one m16 tile against four n8 tiles.
constexpr int kGtThreads = 128, kGtM = 64, kGtN = 32, kGtK = 128, kGtStages = 4;
constexpr int kGtPitch = kGtK + 8;  // 272-byte rows: the fragments' 32 loads hit 32 banks
constexpr int kGtStage = (kGtM + kGtN) * kGtPitch;   // elements of a stage: A rows, then W rows
constexpr int kGtBytes = kGtStages * kGtStage * 2;   // 104,448

// alpha (BT, C, 2) = pair softmax of means (BT, K) x w^T + b, w (K, K) as
// nn.Linear stores it (K = 2C; row 2c is channel c's spatial logit, 2c + 1
// its temporal one), b (K) f32. K a multiple of 16, rows 16-byte aligned.
__global__ void __launch_bounds__(kGtThreads) gate_alpha_bf16_kernel(
    const bf16* __restrict__ means, const bf16* __restrict__ w, const float* __restrict__ b,
    bf16* __restrict__ alpha, int BT, int K) {
  extern __shared__ __align__(16) bf16 gt_s[];
  const int m0 = blockIdx.y * kGtM, n0 = blockIdx.x * kGtN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int steps = (K + kGtK - 1) / kGtK;

  // stage s: rows 0 .. kGtM - 1 are frames m0 .., the rest logits n0 .., each
  // the 16 16-byte chunks of k-slice s (zeros past BT, K and the K logits)
  auto load = [&](int s) {
    const uint32_t stage = smem_u32(gt_s + (s % kGtStages) * kGtStage);
    for (int i = tid; i < (kGtM + kGtN) * (kGtK / 8); i += kGtThreads) {
      const int r = i / (kGtK / 8), k = s * kGtK + i % (kGtK / 8) * 8;
      const bool a_row = r < kGtM;
      const int row = a_row ? m0 + r : n0 + r - kGtM;
      const bool ok = k < K && row < (a_row ? BT : K);
      const bf16* src = (a_row ? means : w) + (ok ? static_cast<size_t>(row) * K + k : 0);
      cp_async16(stage + (r * kGtPitch + i % (kGtK / 8) * 8) * 2, src, ok);
    }
  };
  for (int s = 0; s < kGtStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  float acc[kGtN / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kGtStages - 2>();  // stage s has landed (this thread's part) ...
    __syncthreads();                 // ... everyone's, and stage s - 1 is done with
    if (s + kGtStages - 1 < steps) load(s + kGtStages - 1);
    cp_async_commit();
    const bf16* st = gt_s + (s % kGtStages) * kGtStage;
    const bf16* a_lo = st + (16 * warp + g) * kGtPitch + 2 * t;
    const bf16* a_hi = a_lo + 8 * kGtPitch;
#pragma unroll
    for (int kk = 0; kk < kGtK; kk += 16) {
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(a_lo + kk),
                             *reinterpret_cast<const uint32_t*>(a_hi + kk),
                             *reinterpret_cast<const uint32_t*>(a_lo + kk + 8),
                             *reinterpret_cast<const uint32_t*>(a_hi + kk + 8)};
#pragma unroll
      for (int j = 0; j < kGtN / 8; ++j) {
        const bf16* wr = st + (kGtM + 8 * j + g) * kGtPitch + 2 * t + kk;
        mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(wr),
                 *reinterpret_cast<const uint32_t*>(wr + 8));
      }
    }
  }
  cp_async_wait<0>();

  const int C = K / 2;
#pragma unroll
  for (int j = 0; j < kGtN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;  // the pair's spatial logit; col + 1 its temporal
    if (col >= K) continue;
    const float bs = b[col], bt = b[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * warp + g + 8 * h;
      if (m >= BT) continue;
      float as, at;
      pair_softmax(acc[j][2 * h] + bs, acc[j][2 * h + 1] + bt, as, at);
      *reinterpret_cast<__nv_bfloat162*>(alpha + (static_cast<size_t>(m) * C + col / 2) * 2) =
          __floats2bfloat162_rn(as, at);
    }
  }
}

// f32: a warp takes logit pair c (rows 2c, 2c + 1 of w) for kGfFrames frames,
// its lanes the k's 32 apart, one shuffle sum at the end.
constexpr int kGfWarps = 8, kGfFrames = 8;

__global__ void __launch_bounds__(kGfWarps * 32) gate_alpha_f32_kernel(
    const float* __restrict__ means, const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ alpha, int BT, int C) {
  const int lane = threadIdx.x % 32, c = blockIdx.x * kGfWarps + threadIdx.x / 32;
  const int f0 = blockIdx.y * kGfFrames, K = 2 * C;
  if (c >= C) return;
  const float* ws = w + static_cast<size_t>(2 * c) * K;
  float ls[kGfFrames] = {}, lt[kGfFrames] = {};
  for (int k = lane; k < K; k += 32) {
    const float a = ws[k], bt = ws[K + k];
#pragma unroll
    for (int f = 0; f < kGfFrames; ++f) {
      if (f0 + f < BT) {
        const float m = means[static_cast<size_t>(f0 + f) * K + k];
        ls[f] = fmaf(m, a, ls[f]);
        lt[f] = fmaf(m, bt, lt[f]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kGfFrames; ++f) {
    for (int off = 16; off > 0; off >>= 1) {
      ls[f] += __shfl_xor_sync(0xffffffffu, ls[f], off);
      lt[f] += __shfl_xor_sync(0xffffffffu, lt[f], off);
    }
  }
  if (lane == 0) {
    for (int f = 0; f < kGfFrames && f0 + f < BT; ++f) {
      float* out = alpha + (static_cast<size_t>(f0 + f) * C + c) * 2;
      pair_softmax(ls[f] + b[2 * c], lt[f] + b[2 * c + 1], out[0], out[1]);
    }
  }
}

int launch_gate_alpha(int is_bf16, const void* means, const void* w, const float* b, void* alpha,
                      int BT, int C, cudaStream_t stream) {
  if (is_bf16) {
    if (const cudaError_t err = allow_smem<gate_alpha_bf16_kernel>(kGtBytes))
      return static_cast<int>(err);
    const dim3 grid((2 * C + kGtN - 1) / kGtN, (BT + kGtM - 1) / kGtM);
    gate_alpha_bf16_kernel<<<grid, kGtThreads, kGtBytes, stream>>>(
        static_cast<const bf16*>(means), static_cast<const bf16*>(w), b,
        static_cast<bf16*>(alpha), BT, 2 * C);
  } else {
    const dim3 grid((C + kGfWarps - 1) / kGfWarps, (BT + kGfFrames - 1) / kGfFrames);
    gate_alpha_f32_kernel<<<grid, kGfWarps * 32, 0, stream>>>(
        static_cast<const float*>(means), static_cast<const float*>(w), b,
        static_cast<float*>(alpha), BT, C);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBlendThreads = 256, kBlendBlocksPerSm = 8;

// y (rows, C) = rnd(rnd(y_t * a_t) + rnd(y_s * a_s)), a = alpha (BT, C, 2)
// of row / N's frame: 16-byte chunks, chunks = rows * C / 8, walked by a
// persistent grid.
__global__ void __launch_bounds__(kBlendThreads) gate_blend_kernel(
    const bf16* __restrict__ ys, const bf16* __restrict__ yt, const bf16* __restrict__ alpha,
    bf16* __restrict__ y, int chunks, int N, int C) {
  const int cols = C / 8;
  for (int i = blockIdx.x * kBlendThreads + threadIdx.x; i < chunks;
       i += gridDim.x * kBlendThreads) {
    const int row = i / cols, c = (i - row * cols) * 8;
    const uint4 s4 = __ldg(reinterpret_cast<const uint4*>(ys) + i);
    const uint4 t4 = __ldg(reinterpret_cast<const uint4*>(yt) + i);
    const uint4* gp =
        reinterpret_cast<const uint4*>(alpha + (static_cast<size_t>(row / N) * C + c) * 2);
    const uint4 pairs[2] = {__ldg(gp), __ldg(gp + 1)};  // 8 (spatial, temporal) pairs
    const bf16* sv = reinterpret_cast<const bf16*>(&s4);
    const bf16* tv = reinterpret_cast<const bf16*>(&t4);
    const bf16* gv = reinterpret_cast<const bf16*>(pairs);
    uint4 packed;
    bf16* yv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = __bfloat162float(__float2bfloat16(__bfloat162float(tv[e]) *
                                                        __bfloat162float(gv[2 * e + 1])));
      const float s = __bfloat162float(__float2bfloat16(__bfloat162float(sv[e]) *
                                                        __bfloat162float(gv[2 * e])));
      yv[e] = __float2bfloat16(t + s);
    }
    reinterpret_cast<uint4*>(y)[i] = packed;
  }
}

int launch_gate_blend(const void* ys, const void* yt, const void* alpha, void* y, int BT, int N,
                      int C, cudaStream_t stream) {
  const long long chunks = static_cast<long long>(BT) * N * (C / 8);
  if (C % 8 || chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = persistent_ctas((chunks + kBlendThreads - 1) / kBlendThreads,
                                   kBlendBlocksPerSm);
  gate_blend_kernel<<<grid, kBlendThreads, 0, stream>>>(
      static_cast<const bf16*>(ys), static_cast<const bf16*>(yt),
      static_cast<const bf16*>(alpha), static_cast<bf16*>(y), static_cast<int>(chunks), N, C);
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
// f32, residual (M, N) for epilogues 2 and 3; epilogue 0 is + bias, 1 + bias
// then GELU, 2 (C's fc2) and 3 (E's proj) + bias, rounded, then + residual.
// K and N multiples of 8, a and w 16-byte aligned (a tensor map's rule),
// residual and out 4-byte aligned. A map the encoder refuses is
// kTensorMapError (10000) + its CUresult.
extern "C" int maed_dense_bf16(int epilogue, const void* a, const void* w, const float* bias,
                               const void* residual, void* out, int M, int N, int K,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0: return launch_dense_bf16<BiasOnly>(a, w, bias, residual, out, M, N, K, s);
    case 1: return launch_dense_bf16<BiasGelu>(a, w, bias, residual, out, M, N, K, s);
    case 2: return launch_dense_bf16<BiasResidual>(a, w, bias, residual, out, M, N, K, s);
    case 3: return launch_dense_bf16<ProjResidual>(a, w, bias, residual, out, M, N, K, s);
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

// E's branch means (BT, 2C) of y_s, y_t (BT, N, C), in their dtype (bf16:
// C a multiple of 8 and 16-byte aligned rows).
extern "C" int maed_gate_means(int is_bf16, const void* y_s, const void* y_t, void* means,
                               int BT, int N, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_gate_means<bf16, 8>(y_s, y_t, means, BT, N, C, s);
  return launch_gate_means<float, 1>(y_s, y_t, means, BT, N, C, s);
}

// E's gate: alpha (BT, C, 2) from the means (BT, 2C), w_ts (2C, 2C) in one
// dtype and b_ts (2C) f32 (bf16: C a multiple of 8, 16-byte aligned rows).
extern "C" int maed_gate_alpha(int is_bf16, const void* means, const void* w_ts,
                               const float* b_ts, void* alpha, int BT, int C, void* stream) {
  return launch_gate_alpha(is_bf16, means, w_ts, b_ts, alpha, BT, C,
                           static_cast<cudaStream_t>(stream));
}

// E's blend, bf16: y (BT * N, C) from y_s, y_t (BT, N, C) and alpha (BT, C,
// 2); C a multiple of 8, all 16-byte aligned, BT * N * C / 8 < 2^31.
extern "C" int maed_gate_blend(const void* y_s, const void* y_t, const void* alpha, void* y,
                               int BT, int N, int C, void* stream) {
  return launch_gate_blend(y_s, y_t, alpha, y, BT, N, C, static_cast<cudaStream_t>(stream));
}

// The attention's tail, kernel E: out = x + ((y_t * a_t + y_s * a_s) @ w_p^T
// + b_p) and alpha (BT, C, 2), from y_s, y_t, x and out (BT, N, C), w_ts
// (2C, 2C) and w_p (C, C) in one dtype, b_ts (2C) and b_p (C) f32. means
// (BT, 2C) in the dtype and, for bf16, y (BT * N, C) are scratch. bf16: the
// means, the gate, the blend into y and the GEMM with the ProjResidual
// epilogue; f32: the means, the gate and the scalar GEMM with the blend as
// its A tile's prologue. Returns the first launch's error.
extern "C" int maed_gate_proj(int is_bf16, const void* y_s, const void* y_t, const void* x,
                              const void* w_ts, const float* b_ts, const void* w_p,
                              const float* b_p, void* means, void* alpha, void* y, void* out,
                              int BT, int N, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int M = BT * N;
  if (const int err = maed_gate_means(is_bf16, y_s, y_t, means, BT, N, C, stream)) return err;
  if (const int err = launch_gate_alpha(is_bf16, means, w_ts, b_ts, alpha, BT, C, s)) return err;
  if (is_bf16) {
    if (const int err = launch_gate_blend(y_s, y_t, alpha, y, BT, N, C, s)) return err;
    return launch_dense_bf16<ProjResidual>(y, w_p, b_p, x, out, M, C, C, s);
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
