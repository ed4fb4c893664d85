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
// Under tensor parallelism (models/vit.py, parallel/mesh.py) fc2 and proj
// are row-parallel: each rank's product over its input columns is a partial
// sum of the whole one, and bias and residual must enter it once. tp rank 0
// runs C's and E's GEMMs as they are (BiasResidual, ProjResidual: x +
// rnd(acc + bias)) on its shard, the other ranks dense<RowPartial>: out =
// rnd(acc), the product alone; the caller sums the ranks' outputs. In f32
// the result differs from one process's only by the order of the partial
// sums; in bf16 each rank's part is rounded, then their sum.
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

// f32 (the dtype of the eval CLI, the demo and the trainer), all three, split
// as bf16 is: ln_rows_f32_kernel (LN once a row, a warp a row held in
// registers as float4), gate_blend_f32_kernel, and gemm_f32_kernel<Epi>
// with the five epilogues. What bounds the GEMM: f32 FMAs on the CUDA cores
// (no TF32: the model's f32 is f32 arithmetic), 119 GFLOP a product of C
// at the flagship, 1.78 ms at the 67 TFLOP/s peak. So every shared-memory
// word a thread reads feeds 8 FMAs: a 128 x 128 tile a CTA of 256 threads,
// each thread 8 x 8 outputs from float4 reads of 8 rows of A and 8 of W
// along k (K-major in shared memory, as cp.async copies them, rows padded
// against bank conflicts), taken as outer products k by k; A and W stream
// through a ring of four 32-deep cp.async stages, three in flight while one
// is multiplied; persistent CTAs walk the tiles row-major (the column tile
// fastest), the k-steps of consecutive tiles one sequence, so the next
// tile's loads overlap this one's last products and its store, which goes
// through a staging buffer as float4 rows. No index is divided in the loop.
// f32_layout.cuh holds the layout. E's gate in f32 (0.6 GFLOP at the
// flagship, 9.0 us at the FMA peak; its means read 154.9 MB, 46.2 us at
// 3.35 TB/s): gate_means_kernel<float, 4> reads float4 columns (1536 blocks
// at the flagship); gate_alpha_f32_kernel cuts
// the product along k as well as into tiles of 32-128 frames x 48 logits,
// so that BT = 128 frames (or 16) still give every SM two CTAs, each a
// register-tiled product like the GEMM's over its run of k, the splits of a
// tile one cluster that sums them through distributed shared memory and
// takes the pair softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "f32_layout.cuh"  // the f32 GEMM's layout (also read by a host compiler)
#include "hopper.cuh"  // TMA, mbarriers, setmaxnreg, wgmma

using namespace maed_f32;

namespace {

using bf16 = __nv_bfloat16;

// The epilogues, as types so that a profile names each launch: + bias (the
// qkv projection), + bias then GELU (fc1), + bias then + residual (fc2;
// ProjResidual, the same code, the attention's proj).
struct BiasOnly {};
struct BiasGelu {};
struct BiasResidual {};
struct ProjResidual {};
struct RowPartial {};  // tensor parallelism's fc2 and proj past tp rank 0: the product alone
template <typename A, typename B>
constexpr bool kSame = std::is_same<A, B>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
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
      const bool with_bias = live && !kSame<Epi, RowPartial>;
      const float b0 = with_bias ? __ldg(bias + col) : 0.f;
      const float b1 = with_bias ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const float v0 = acc[4 * j + 2 * r] + b0, v1 = acc[4 * j + 2 * r + 1] + b1;
        __nv_bfloat162 y;
        if constexpr (kSame<Epi, BiasOnly> || kSame<Epi, RowPartial>) {
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

// out (M x K) = LN(x) in f32, a warp per row as ln_rows_kernel: with kChunks
// > 0 (K a multiple of 4, K <= 128 kChunks, x and out 16-byte aligned) lane
// l holds the float4 chunks l, l + 32, ... of a row, and the scale and bias
// come as float4 through the read-only path; with 0 (any K) a lane reads
// its elements twice, the second time from L1.
template <int kChunks>
__global__ void __launch_bounds__(kLnWarps * 32) ln_rows_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float eps, float* __restrict__ out, int M, int K) {
  constexpr int kHeld = kChunks > 0 ? kChunks : 1;
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * kLnWarps;
  for (long long m = static_cast<long long>(blockIdx.x) * kLnWarps + threadIdx.x / 32; m < M;
       m += warps) {
    const float* row = x + m * K;
    float* dst = out + m * K;
    float s = 0.f, ss = 0.f;
    float4 held[kHeld];
    if constexpr (kChunks > 0) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int k = (lane + 32 * i) * 4;
        held[i] = k < K ? *reinterpret_cast<const float4*>(row + k) : make_float4(0, 0, 0, 0);
        s += held[i].x + held[i].y + held[i].z + held[i].w;
        ss += held[i].x * held[i].x + held[i].y * held[i].y + held[i].z * held[i].z +
              held[i].w * held[i].w;
      }
    } else {
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
    const float mean = s / K, rstd = rsqrtf(ss / K - mean * mean + eps);
    if constexpr (kChunks > 0) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int k = (lane + 32 * i) * 4;
        if (k < K) {
          const float4 sc = __ldg(reinterpret_cast<const float4*>(ln_scale + k));
          const float4 sh = __ldg(reinterpret_cast<const float4*>(ln_bias + k));
          *reinterpret_cast<float4*>(dst + k) = make_float4(
              (held[i].x - mean) * rstd * sc.x + sh.x, (held[i].y - mean) * rstd * sc.y + sh.y,
              (held[i].z - mean) * rstd * sc.z + sh.z, (held[i].w - mean) * rstd * sc.w + sh.w);
        }
      }
    } else {
      for (int k = lane; k < K; k += 32)
        dst[k] = (row[k] - mean) * rstd * __ldg(ln_scale + k) + __ldg(ln_bias + k);
    }
  }
}

constexpr int kLnF32MaxChunks = 8;  // rows of up to 1024 held in registers

__host__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_ln_rows_f32(const float* x, const float* ln_scale, const float* ln_bias, float eps,
                       float* out, int M, int K, cudaStream_t stream) {
  const bool held = K % 4 == 0 && K <= kLnF32MaxChunks * 32 * 4 && aligned16(x) &&
                    aligned16(out) && aligned16(ln_scale) && aligned16(ln_bias);
  const int grid = persistent_ctas((static_cast<long long>(M) + kLnWarps - 1) / kLnWarps,
                                   kLnBlocksPerSm);
  const auto kernel = held ? ln_rows_f32_kernel<kLnF32MaxChunks> : ln_rows_f32_kernel<0>;
  kernel<<<grid, kLnWarps * 32, 0, stream>>>(x, ln_scale, ln_bias, eps, out, M, K);
  return static_cast<int>(cudaGetLastError());
}

// out (M x N) = Epi(A @ W^T + bias) in f32 on the CUDA cores (no TF32), A
// (M x K) and W (N x K) K-major, residual (M x N) for the residual
// epilogues; f32_layout.cuh's GEMM layout. Persistent: CTA b takes output
// tiles b, b + gridDim.x, ..., row-major (the column tile fastest), so the
// CTAs in flight share a few row panels of A and all of W, which at the
// model's widths (<= 26 MB) stays in L2. The k-steps of a CTA's tiles form
// one sequence through the ring, so the next tile's first stages are in
// flight while the current tile's last ones are multiplied and its outputs
// stored. cp.async zero-fills rows past M and N and columns past K. kVec
// (K and N multiples of 4, every pointer 16-byte aligned): 16-byte copies
// and float4 stores; else 4-byte copies and scalar stores.
static_assert(kGemmTM == 8 && kGemmTN == 8, "gemm_f32_kernel holds an 8 x 8 tile a thread");

template <typename Epi, bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ residual, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) float gm_s[];
  float* const c_s = gm_s + kGemmStages * kGemmStage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = (M + kGemmBM - 1) / kGemmBM * tiles_n;
  const int steps = (K + kGemmBK - 1) / kGemmBK;

  // The loads walk the CTA's (tile, k-step) sequence a few stages ahead of
  // the products; both keep their place in counters (no division a step).
  // A thread copies rows cr + j * kGap of each operand's tile, at column cc:
  // its source pointers and row masks are set once a tile and advanced by
  // one k-step a load.
  constexpr int kPer = kVec ? 4 : 1;  // floats a copy
  constexpr int kRow = kGemmBK / kPer, kGap = kGemmThreads / kRow;
  constexpr int kCopies = kGemmBM / kGap;  // of each operand, a load
  static_assert(kCopies <= 32, "a row mask a word");
  const int cr = tid / kRow, cc = tid % kRow * kPer;
  const size_t gap = static_cast<size_t>(kGap) * K;
  int ld_tile = blockIdx.x, ld_k = 0, ld_stage = 0;
  const float *pa = nullptr, *pw = nullptr;  // row cr of the tile's A and W panels, at the k-step
  uint32_t a_rows = 0, w_rows = 0;           // bit j: row cr + j * kGap lies below M (N)
  auto start_tile = [&]() {
    const int m0 = ld_tile / tiles_n * kGemmBM + cr, n0 = ld_tile % tiles_n * kGemmBN + cr;
    pa = a + static_cast<size_t>(m0) * K + cc;
    pw = w + static_cast<size_t>(n0) * K + cc;
    a_rows = w_rows = 0;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      a_rows |= static_cast<uint32_t>(m0 + j * kGap < M) << j;
      w_rows |= static_cast<uint32_t>(n0 + j * kGap < N) << j;
    }
  };
  if (ld_tile < tiles) start_tile();
  auto load_next = [&]() {  // one commit group, empty past the last tile
    if (ld_tile < tiles) {
      const uint32_t st = smem_u32(gm_s + ld_stage * kGemmStage + cr * kGemmPitch + cc);
      const bool k_ok = ld_k * kGemmBK + cc < K;
#pragma unroll
      for (int j = 0; j < kCopies; ++j) {
        const uint32_t dst = st + j * kGap * kGemmPitch * 4;
        const bool oka = k_ok && (a_rows >> j & 1), okw = k_ok && (w_rows >> j & 1);
        if constexpr (kVec) {
          cp_async16(dst, oka ? pa + j * gap : a, oka);
          cp_async16(dst + kGemmTile * 4, okw ? pw + j * gap : w, okw);
        } else {
          cp_async4(dst, oka ? pa + j * gap : a, oka);
          cp_async4(dst + kGemmTile * 4, okw ? pw + j * gap : w, okw);
        }
      }
      pa += kGemmBK;
      pw += kGemmBK;
      if (++ld_k == steps) {
        ld_k = 0;
        ld_tile += gridDim.x;
        if (ld_tile < tiles) start_tile();
      }
    }
    cp_async_commit();
    ld_stage = ld_stage + 1 == kGemmStages ? 0 : ld_stage + 1;
  };

  // the tile's outputs through the staging buffer: + bias, then Epi
  auto epilogue = [&](const float (&acc)[8][8], int m0, int n0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c_s[gemm_row(warp, lane, i) * kGemmOutPitch + gemm_col(warp, lane, j)] = acc[i][j];
    __syncthreads();
    if constexpr (kVec) {
      // a thread's 4 columns in every 8th row: the bias read once, the 16
      // rows' residual reads all in flight before the first is used
      constexpr int kRows = kGemmBM * kGemmBN / 4 / kGemmThreads;
      const int c = tid % (kGemmBN / 4) * 4, r0 = tid / (kGemmBN / 4), n = n0 + c;
      if (n < N) {
        const float4 b4 = kSame<Epi, RowPartial>
                              ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : __ldg(reinterpret_cast<const float4*>(bias + n));
        float4 r4[kRows];
        if constexpr (kSame<Epi, BiasResidual> || kSame<Epi, ProjResidual>) {
#pragma unroll
          for (int t = 0; t < kRows; ++t) {
            const int m = m0 + r0 + t * (kGemmThreads * 4 / kGemmBN);
            r4[t] = m < M ? *reinterpret_cast<const float4*>(residual + static_cast<size_t>(m) * N + n)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int r = r0 + t * (kGemmThreads * 4 / kGemmBN), m = m0 + r;
          if (m >= M) break;
          const float4 acc4 = *reinterpret_cast<const float4*>(c_s + r * kGemmOutPitch + c);
          float4 v = make_float4(acc4.x + b4.x, acc4.y + b4.y, acc4.z + b4.z, acc4.w + b4.w);
          if constexpr (kSame<Epi, BiasGelu>) {
            v = make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z), gelu_erf(v.w));
          } else if constexpr (kSame<Epi, BiasResidual> || kSame<Epi, ProjResidual>) {
            v = make_float4(r4[t].x + v.x, r4[t].y + v.y, r4[t].z + v.z, r4[t].w + v.w);
          }
          *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n) = v;
        }
      }
    } else {
      for (int idx = tid; idx < kGemmBM * kGemmBN; idx += kGemmThreads) {
        const int r = idx / kGemmBN, c = idx % kGemmBN, m = m0 + r, n = n0 + c;
        if (m >= M || n >= N) continue;
        float v = c_s[r * kGemmOutPitch + c];
        if constexpr (!kSame<Epi, RowPartial>) v += bias[n];
        if constexpr (kSame<Epi, BiasGelu>) {
          v = gelu_erf(v);
        } else if constexpr (kSame<Epi, BiasResidual> || kSame<Epi, ProjResidual>) {
          v = residual[static_cast<size_t>(m) * N + n] + v;
        }
        out[static_cast<size_t>(m) * N + n] = v;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) load_next();
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* const a_row = gm_s + gemm_row(warp, lane, 0) * kGemmPitch;
  const float* const w_row = gm_s + kGemmTile + gemm_col(warp, lane, 0) * kGemmPitch;
  int k_step = 0, stage = 0;
  for (int tile = blockIdx.x; tile < tiles;) {
    cp_async_wait<kGemmStages - 2>();  // this step has landed (this thread's copies) ...
    __syncthreads();                   // ... everyone's, and the previous step's stage is read
    load_next();
    const float* as = a_row + stage * kGemmStage;
    const float* ws = w_row + stage * kGemmStage;
    // 4 k at a time: the thread's 8 rows of A and 8 of W as float4 (the
    // next 4 k's read while these are multiplied), then their outer
    // products k by k (each A value feeds 8 FMAs in a row)
    float4 av[2][8], wv[2][8];
    auto fetch = [&](int buf, int kk) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[buf][i] = *reinterpret_cast<const float4*>(as + 4 * i * kGemmPitch + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wv[buf][j] = *reinterpret_cast<const float4*>(ws + 8 * j * kGemmPitch + kk);
    };
    fetch(0, 0);
#pragma unroll
    for (int g = 0; g < kGemmBK / 4; ++g) {
      if (g + 1 < kGemmBK / 4) fetch((g + 1) % 2, 4 * (g + 1));
      const float4(&a4)[8] = av[g % 2];
      const float4(&w4)[8] = wv[g % 2];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a4[i].x, w4[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a4[i].y, w4[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a4[i].z, w4[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a4[i].w, w4[j].w, acc[i][j]);
    }
    stage = stage + 1 == kGemmStages ? 0 : stage + 1;
    if (++k_step == steps) {
      epilogue(acc, tile / tiles_n * kGemmBM, tile % tiles_n * kGemmBN);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      k_step = 0;
      tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

template <typename Epi>
int launch_gemm_f32(const float* a, const float* w, const float* bias, const float* residual,
                    float* out, int M, int N, int K, cudaStream_t stream) {
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(w) &&
                   aligned16(bias) && aligned16(out) && (residual == nullptr || aligned16(residual));
  const auto kernel = vec ? gemm_f32_kernel<Epi, true> : gemm_f32_kernel<Epi, false>;
  const cudaError_t err = vec ? allow_smem<gemm_f32_kernel<Epi, true>>(kGemmBytes)
                              : allow_smem<gemm_f32_kernel<Epi, false>>(kGemmBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<persistent_ctas(tiles), kGemmThreads, kGemmBytes, stream>>>(a, w, bias, residual, out,
                                                                       M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- the gate (kernel E)

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};
__device__ __forceinline__ void cast_to(float v, bf16& o) { o = __float2bfloat16(v); }
__device__ __forceinline__ void cast_to(float v, float& o) { o = v; }

constexpr int kMeanThreads = 256, kMeanGroups = kMeanThreads / 32;  // row groups a block

// means (BT, 2C) = [mean_n y_s | mean_n y_t] per frame in f32, rounded to T
// (bf16: V 8; f32: V 4, float4 reads, where C is a multiple of 4 and the
// operands 16-byte aligned, else V 1): block (frame, branch, column block)
// takes 32 columns of V channels over the N rows, row group g (a warp) the
// rows g, g + kMeanGroups, ... (unrolled by four), summed in order; the
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
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
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

// f32: gate_f32_plan's tiles of gate_bm(TM) frames x kGaBN logits, each cut
// along k into plan.splits runs of plan.steps k-steps, one CTA a run and a
// cluster a tile (rank = the run); f32_layout.cuh's thread map. The CTA
// multiplies its run like gemm_f32_kernel (the k-steps through the ring,
// float4 reads of a thread's TM frames and 6 logits a 4-k group, the next
// group read while this one is multiplied; a warp whose frames all lie past
// BT only copies, which leaves the SM's issue slots to the warps that
// multiply, as for one clip's 16 frames in a tile of 32: tools/
// gate_variants.py), then writes its partial tile to
// shared memory; member r sums rows plan.rows r .. of the cluster's partial
// tiles in rank order (each thread's remote reads all issued before the
// first is added), adds b and writes each pair's softmax as a float2. kVec
// (K a multiple of 4, means and w_ts 16-byte aligned): 16-byte copies, else
// 4-byte ones (cp.async zero-fills past BT, K and the K logits).
template <bool kVec, int TM>
__global__ void __launch_bounds__(kGaThreads, 2) gate_alpha_f32_kernel(
    const float* __restrict__ means, const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ alpha, int BT, int K, int steps, int rows) {
  constexpr int kBM = gate_bm(TM), kStage = gate_stage(TM);
  extern __shared__ __align__(16) float ga_s[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = static_cast<int>(cluster_rank()), splits = static_cast<int>(cluster_ranks());
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x / splits * kGaBN;
  const int k_steps = (K + kGaBK - 1) / kGaBK;
  const int s0 = rank * steps, s1 = min(s0 + steps, k_steps);

  // stage of k-step s: rows 0 .. kBM - 1 the means of frames m0 .., then
  // w_ts' rows of logits n0 .. at gate_w_row; zeros past BT, K and the logits
  constexpr int kPer = kVec ? 4 : 1;  // floats a copy
  auto load = [&](int s) {
    const uint32_t stage = smem_u32(ga_s + (s - s0) % kGaStages * kStage);
    for (int i = tid; i < (kBM + kGaBN) * (kGaBK / kPer); i += kGaThreads) {
      const int r = i / (kGaBK / kPer), kk = i % (kGaBK / kPer) * kPer, k = s * kGaBK + kk;
      const bool a_row = r < kBM;
      const int row = a_row ? m0 + r : n0 + r - kBM;
      const bool ok = k < K && row < (a_row ? BT : K);
      const float* src = (a_row ? means : w) + (ok ? static_cast<size_t>(row) * K + k : 0);
      const int srow = a_row ? r : kBM + gate_w_row(r - kBM);
      if constexpr (kVec) {
        cp_async16(stage + (srow * kGaPitch + kk) * 4, src, ok);
      } else {
        cp_async4(stage + (srow * kGaPitch + kk) * 4, src, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kGaStages - 1; ++s) {
    if (s0 + s < s1) load(s0 + s);
    cp_async_commit();
  }
  float acc[TM][2 * kGaTP];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kGaTP; ++j) acc[i][j] = 0.f;
  const float* const a_row = ga_s + gate_row(TM, warp, lane, 0) * kGaPitch;
  const float* const w_row = ga_s + (kBM + gate_pair(lane, 0)) * kGaPitch;
  // a warp whose frames all lie past BT copies its share of the stages but
  // multiplies nothing
  const bool live = m0 + gate_row(TM, warp, 0, 0) < BT;
  for (int s = s0; s < s1; ++s) {
    cp_async_wait<kGaStages - 2>();  // step s has landed (this thread's copies) ...
    __syncthreads();                 // ... everyone's, and step s - 1's stage is read
    if (s + kGaStages - 1 < s1) load(s + kGaStages - 1);
    cp_async_commit();
    if (!live) continue;
    const int stage = (s - s0) % kGaStages * kStage;
    const float* as = a_row + stage;
    const float* ws = w_row + stage;
    // a thread's TM frames as float4 along k, and its 3 pairs' even and odd
    // logits (w_ts rows kGaBN / 2 apart in shared memory)
    float4 av[2][TM], wv[2][2 * kGaTP];
    auto fetch = [&](int buf, int kk) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[buf][i] = *reinterpret_cast<const float4*>(as + 4 * i * kGaPitch + kk);
#pragma unroll
      for (int j = 0; j < 2 * kGaTP; ++j)
        wv[buf][j] = *reinterpret_cast<const float4*>(
            ws + (j % 2 * (kGaBN / 2) + 8 * (j / 2)) * kGaPitch + kk);
    };
    fetch(0, 0);
#pragma unroll
    for (int g = 0; g < kGaBK / 4; ++g) {
      if (g + 1 < kGaBK / 4) fetch((g + 1) % 2, 4 * (g + 1));
      const float4(&a4)[TM] = av[g % 2];
      const float4(&w4)[2 * kGaTP] = wv[g % 2];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kGaTP; ++j) acc[i][j] = fmaf(a4[i].x, w4[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kGaTP; ++j) acc[i][j] = fmaf(a4[i].y, w4[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kGaTP; ++j) acc[i][j] = fmaf(a4[i].z, w4[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kGaTP; ++j) acc[i][j] = fmaf(a4[i].w, w4[j].w, acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place

  // the partial tile, logits in their order (a pair's two side by side)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kGaTP; ++j)  // acc[i][2j]: the even logit of pair j (wv's order)
      *reinterpret_cast<float2*>(ga_s + gate_row(TM, warp, lane, i) * kGaOutPitch +
                                 2 * gate_pair(lane, j)) =
          make_float2(acc[i][2 * j], acc[i][2 * j + 1]);
  cluster_arrive();  // every member's partial tile is written ...
  cluster_wait();
  const int r0 = rank * rows, C = K / 2;
  for (int idx = tid; idx < rows * (kGaBN / 2); idx += kGaThreads) {
    const int r = r0 + idx / (kGaBN / 2), p = idx % (kGaBN / 2);
    const int m = m0 + r, c = n0 / 2 + p;
    if (r >= kBM || m >= BT || c >= C) continue;
    const uint32_t local = smem_u32(ga_s + r * kGaOutPitch + 2 * p);
    float2 part[kGaMaxSplits];
#pragma unroll
    for (int q = 0; q < kGaMaxSplits; ++q)
      if (q < splits) part[q] = ld_cluster_f32x2(local, q);
    float ls = 0.f, lt = 0.f;
#pragma unroll
    for (int q = 0; q < kGaMaxSplits; ++q)
      if (q < splits) {
        ls += part[q].x;
        lt += part[q].y;
      }
    float2 out;
    pair_softmax(ls + b[2 * c], lt + b[2 * c + 1], out.x, out.y);
    *reinterpret_cast<float2*>(alpha + (static_cast<size_t>(m) * C + c) * 2) = out;
  }
  cluster_arrive();  // no member leaves while another may still read its tile
  cluster_wait();
}

// The clusters of `splits` CTAs of an instance the card holds at once
// (cudaOccupancyMaxActiveClusters, asked once for each device, instance and
// size, and kept); 0 if the query fails.
template <bool kVec, int TM>
int gate_resident_clusters(int splits, int bytes) {
  constexpr int kDevices = 64;
  static int held[kDevices][kGaMaxSplits + 1] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kDevices) return 0;
  if (held[device][splits] == 0) {
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(splits);
    config.blockDim = dim3(kGaThreads);
    config.dynamicSmemBytes = bytes;
    config.attrs = &cluster;
    config.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, gate_alpha_f32_kernel<kVec, TM>, &config) !=
        cudaSuccess)
      return 0;
    held[device][splits] = clusters;
  }
  return held[device][splits];
}

// gate_f32_plan's grid, its splits lowered while the card cannot hold all
// its clusters at once (a second wave of clusters would double the time)
template <bool kVec, int TM>
int launch_gate_tiles(const float* means, const float* w, const float* b, float* alpha, int BT,
                      int K, cudaStream_t stream) {
  const int sms = persistent_ctas(1LL << 30);
  GatePlan plan = gate_f32_plan(BT, K, sms);
  if (plan.splits == 0 || plan.tiles_m > 65535 ||
      static_cast<long long>(plan.tiles_n) * kGaMaxSplits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem<gate_alpha_f32_kernel<kVec, TM>>(plan.bytes))
    return static_cast<int>(err);
  while (plan.splits > 1 &&
         gate_resident_clusters<kVec, TM>(plan.splits, plan.bytes) < plan.tiles_m * plan.tiles_n)
    plan = gate_f32_plan(BT, K, sms, plan.splits - 1);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = plan.splits;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(plan.tiles_n * plan.splits, plan.tiles_m);
  config.blockDim = dim3(kGaThreads);
  config.dynamicSmemBytes = plan.bytes;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, gate_alpha_f32_kernel<kVec, TM>, means, w,
                                             b, alpha, BT, K, plan.steps, plan.rows);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kVec>
int launch_gate_alpha_f32(const float* means, const float* w, const float* b, float* alpha,
                          int BT, int K, cudaStream_t stream) {
  switch (gate_f32_plan(BT, K, 1).tm) {
    case 1: return launch_gate_tiles<kVec, 1>(means, w, b, alpha, BT, K, stream);
    case 2: return launch_gate_tiles<kVec, 2>(means, w, b, alpha, BT, K, stream);
    case 4: return launch_gate_tiles<kVec, 4>(means, w, b, alpha, BT, K, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
    return static_cast<int>(cudaGetLastError());
  }
  const auto mf = static_cast<const float*>(means), wf = static_cast<const float*>(w);
  const auto af = static_cast<float*>(alpha);
  if (C % 2 == 0 && aligned16(means) && aligned16(w))  // K = 2C a multiple of 4
    return launch_gate_alpha_f32<true>(mf, wf, b, af, BT, 2 * C, stream);
  return launch_gate_alpha_f32<false>(mf, wf, b, af, BT, 2 * C, stream);
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

// f32: y = y_t * a_t + y_s * a_s, each product and the sum rounded as the
// plain version rounds them (no contraction into an FMA); V elements a
// thread and step (4: C a multiple of 4 and 16-byte aligned operands).
template <int V>
__global__ void __launch_bounds__(kBlendThreads) gate_blend_f32_kernel(
    const float* __restrict__ ys, const float* __restrict__ yt, const float* __restrict__ alpha,
    float* __restrict__ y, long long vecs, int N, int C) {
  for (long long i = static_cast<long long>(blockIdx.x) * kBlendThreads + threadIdx.x; i < vecs;
       i += static_cast<long long>(gridDim.x) * kBlendThreads) {
    const long long e = i * V, row = e / C;
    const int c = static_cast<int>(e - row * C);
    const float* g = alpha + (row / N * C + c) * 2;  // V (spatial, temporal) pairs
    if constexpr (V == 4) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(ys) + i);
      const float4 t = __ldg(reinterpret_cast<const float4*>(yt) + i);
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(g));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(g) + 1);
      reinterpret_cast<float4*>(y)[i] = make_float4(
          __fadd_rn(__fmul_rn(t.x, g0.y), __fmul_rn(s.x, g0.x)),
          __fadd_rn(__fmul_rn(t.y, g0.w), __fmul_rn(s.y, g0.z)),
          __fadd_rn(__fmul_rn(t.z, g1.y), __fmul_rn(s.z, g1.x)),
          __fadd_rn(__fmul_rn(t.w, g1.w), __fmul_rn(s.w, g1.z)));
    } else {
      y[i] = __fadd_rn(__fmul_rn(__ldg(yt + i), __ldg(g + 1)), __fmul_rn(__ldg(ys + i), __ldg(g)));
    }
  }
}

int launch_gate_blend_f32(const float* ys, const float* yt, const float* alpha, float* y, int BT,
                          int N, int C, cudaStream_t stream) {
  const bool vec = C % 4 == 0 && aligned16(ys) && aligned16(yt) && aligned16(alpha) &&
                   aligned16(y);
  const long long vecs = static_cast<long long>(BT) * N * C / (vec ? 4 : 1);
  const int grid = persistent_ctas((vecs + kBlendThreads - 1) / kBlendThreads, kBlendBlocksPerSm);
  if (vec) {
    gate_blend_f32_kernel<4><<<grid, kBlendThreads, 0, stream>>>(ys, yt, alpha, y, vecs, N, C);
  } else {
    gate_blend_f32_kernel<1><<<grid, kBlendThreads, 0, stream>>>(ys, yt, alpha, y, vecs, N, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// LN(x) rounded to x's dtype (bf16 if is_bf16, else f32): x and out (M, C),
// ln_scale and ln_bias (C) f32; bf16: C a multiple of 8, x and out 16-byte
// aligned; f32: any C.
extern "C" int maed_ln_rows(int is_bf16, const void* x, const float* ln_scale,
                            const float* ln_bias, float eps, void* out, int M, int C,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_ln_rows(x, ln_scale, ln_bias, eps, out, M, C, s);
  return launch_ln_rows_f32(static_cast<const float*>(x), ln_scale, ln_bias, eps,
                            static_cast<float*>(out), M, C, s);
}

// bf16 out (M, N) = epilogue(a @ w^T + bias): a (M, K), w (N, K), bias (N)
// f32, residual (M, N) for epilogues 2 and 3; epilogue 0 is + bias, 1 + bias
// then GELU, 2 (C's fc2) and 3 (E's proj) + bias, rounded, then + residual;
// 4 (RowPartial: a row-parallel fc2 or proj past tp rank 0) the product
// alone, rounded (bias and residual unread, may be null).
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
    case 4: return launch_dense_bf16<RowPartial>(a, w, bias, residual, out, M, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32 out (M, N) = epilogue(a @ w^T + bias), the epilogues of maed_dense_bf16
// (none rounds: f32 throughout), any M, N, K.
extern "C" int maed_dense_f32(int epilogue, const float* a, const float* w, const float* bias,
                              const float* residual, float* out, int M, int N, int K,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0: return launch_gemm_f32<BiasOnly>(a, w, bias, residual, out, M, N, K, s);
    case 1: return launch_gemm_f32<BiasGelu>(a, w, bias, residual, out, M, N, K, s);
    case 2: return launch_gemm_f32<BiasResidual>(a, w, bias, residual, out, M, N, K, s);
    case 3: return launch_gemm_f32<ProjResidual>(a, w, bias, residual, out, M, N, K, s);
    case 4: return launch_gemm_f32<RowPartial>(a, w, bias, residual, out, M, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// E's branch means (BT, 2C) of y_s, y_t (BT, N, C), in their dtype (bf16:
// C a multiple of 8 and 16-byte aligned rows).
extern "C" int maed_gate_means(int is_bf16, const void* y_s, const void* y_t, void* means,
                               int BT, int N, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_gate_means<bf16, 8>(y_s, y_t, means, BT, N, C, s);
  if (C % 4 == 0 && aligned16(y_s) && aligned16(y_t) && aligned16(means))
    return launch_gate_means<float, 4>(y_s, y_t, means, BT, N, C, s);
  return launch_gate_means<float, 1>(y_s, y_t, means, BT, N, C, s);
}

// E's gate: alpha (BT, C, 2) from the means (BT, 2C), w_ts (2C, 2C) in one
// dtype and b_ts (2C) f32 (bf16: C a multiple of 8, 16-byte aligned rows).
extern "C" int maed_gate_alpha(int is_bf16, const void* means, const void* w_ts,
                               const float* b_ts, void* alpha, int BT, int C, void* stream) {
  return launch_gate_alpha(is_bf16, means, w_ts, b_ts, alpha, BT, C,
                           static_cast<cudaStream_t>(stream));
}

// E's blend: y (BT * N, C) from y_s, y_t (BT, N, C) and alpha (BT, C, 2),
// bf16 if is_bf16 (C a multiple of 8, all 16-byte aligned, BT * N * C / 8 <
// 2^31), else f32 (any C).
extern "C" int maed_gate_blend(int is_bf16, const void* y_s, const void* y_t, const void* alpha,
                               void* y, int BT, int N, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_gate_blend(y_s, y_t, alpha, y, BT, N, C, s);
  return launch_gate_blend_f32(static_cast<const float*>(y_s), static_cast<const float*>(y_t),
                               static_cast<const float*>(alpha), static_cast<float*>(y), BT, N,
                               C, s);
}

// The attention's tail, kernel E: out = x + ((y_t * a_t + y_s * a_s) @ w_p^T
// + b_p) and alpha (BT, C, 2), from y_s, y_t, x and out (BT, N, C), w_ts
// (2C, 2C) and w_p (C, C) in one dtype, b_ts (2C) and b_p (C) f32. means
// (BT, 2C) and y (BT * N, C) in the dtype are scratch. Four launches in
// either dtype: the means, the gate, the blend into y and the GEMM with the
// ProjResidual epilogue. Returns the first launch's error.
extern "C" int maed_gate_proj(int is_bf16, const void* y_s, const void* y_t, const void* x,
                              const void* w_ts, const float* b_ts, const void* w_p,
                              const float* b_p, void* means, void* alpha, void* y, void* out,
                              int BT, int N, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int M = BT * N;
  if (const int err = maed_gate_means(is_bf16, y_s, y_t, means, BT, N, C, stream)) return err;
  if (const int err = launch_gate_alpha(is_bf16, means, w_ts, b_ts, alpha, BT, C, s)) return err;
  if (const int err = maed_gate_blend(is_bf16, y_s, y_t, alpha, y, BT, N, C, stream)) return err;
  if (is_bf16) return launch_dense_bf16<ProjResidual>(y, w_p, b_p, x, out, M, C, C, s);
  return launch_gemm_f32<ProjResidual>(static_cast<const float*>(y), static_cast<const float*>(w_p),
                                       b_p, static_cast<const float*>(x), static_cast<float*>(out),
                                       M, C, C, s);
}
