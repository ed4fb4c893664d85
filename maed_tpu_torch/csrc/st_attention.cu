// The attention kernels of the spatio-temporal block, f32 or bf16: attention
// over the S tokens of a frame (spatial), over the T frames of a token
// (temporal) and over all T * N tokens of a clip (blocked, st_mode
// 'coupling'), each softmax(q k^T * scale) v per head.
//
// Replaces five Pallas kernels with three CUDA entry points:
//   maed_blocked_attention (blocked_attention_tma_kernel in bf16,
//   blocked_f32_kernel in f32; below the spatial ones, with their own note)
//     maed_tpu/ops/attention.py::_attn_blocked_kernel (pallas_call in
//       `_attention_blocked`, public entry `fused_attention`, S > 1024)
//   maed_spatial_attention (spatial_attention_tma_kernel in bf16,
//   spatial_f32_kernel in f32)
//     maed_tpu/ops/attention.py::_attn_oneshot_kernel (pallas_call in
//       `_attention_oneshot`, public entry `fused_attention`, S <= 1024)
//     maed_tpu/ops/st_attention.py::_spatial_kernel (pallas_call in
//       `_spatial_pallas`, public entry `spatial_attention`)
//   maed_temporal_attention (temporal_attention_mma_kernel in bf16,
//   temporal_f32_kernel in f32)
//     maed_tpu/ops/st_attention.py::_temporal_kernel (pallas_call in
//       `_temporal_pallas`, public entry `temporal_attention`)
//     maed_tpu/ops/st_attention.py::_temporal_v2_kernel (pallas_call in
//       `_temporal_v2_pallas`, public entry `temporal_attention_fused`)
// These kernels take head dims up to 128 (bf16 spatial and blocked: 16, 32,
// 64 or 128); every other multiple of 8 up to 768 runs on
// attention_general.cu, which the wrappers (ops/st_attention.py) pick.
// The TPU pairs differ only in the layouts they read and write, so here q, k, v
// and the output are addressed by strides (head dim contiguous): one kernel
// reads the qkv projection's natural (BT, N, 3, h, d) or a (B, h, S, d) triple
// and writes (BT, N, C), head-leading (h, BT, N, d) or (B, h, S, d). No
// transposed copy exists on either side.
//
// What bounds the spatial and temporal kernels on the H100: memory. At the
// flagship shape (BT 128, N 197, h 12, d 64, T 16) each reads the 116 MB qkv
// and writes 39 MB in bf16, 0.046 ms at 3.35 TB/s; the spatial products are
// 15.3 GFLOP (0.015 ms at the bf16 tensor-core peak), the temporal ones 1.2
// GFLOP. Neither writes scores to device memory.
//
// Spatial, bf16 with a head dim of 16, 32, 64 or 128 (the serving path):
// spatial_attention_tma_kernel, warp-specialised and persistent (see "Hopper
// building blocks"). A work item is one (frame, head): the producer loads its
// q, k and v once by TMA (a tensor map per operand over the strided
// (B, h, S, d) view, boxes of 64 rows that arrive zero-filled past S, under
// the swizzle wgmma reads) into one of two stages while the consumers work on
// the previous item from the other. A consumer takes query tiles w and w + 2
// of 64 rows; for each it forms the whole row of scores in registers, as
// m64n64k16 strips and, where the width asks, one m64n8k16 strip; takes the
// exact softmax in one go (row max and sum over the 4 lanes of a quad, p =
// exp(s - max) / sum rounded to bf16) over the columns below S; and feeds p
// from those registers as the A operand of p v (m64n{d}k16, v MN-major from
// shared memory). The score width is a template argument the host picks from
// S (kSpWidths: 200 = 3 x 64 + 8 at S 197, 100 registers a thread), since a
// run-time n between wgmmas makes ptxas serialise them. So K and V cross
// device memory once per (frame, head) and q k^T is formed once. A warp whose
// 16 rows all lie past S skips the softmax. The row max is that of the raw
// scores (their min for a negative scale), scaled once. What holds it above
// its bound is each consumer's chain q k^T, softmax, p v, store, with two
// consumers an SM, and the 4th tile of 5 rows at S 197 (PERF.md). For
// 256 < S <= 1024 (fused_attention's one-shot range; no model path) a work
// item is 128 query rows, and K passes in 256-key chunks twice through the
// two stages: once for each row's max and sum, once for p v, the exact
// two-pass softmax.
//
// Spatial, f32 (the dtype of the eval CLI, the demo and the trainer; bf16 has
// the path above alone), head dims up to 128: spatial_f32_kernel, the
// layout and plan of f32_layout.cuh. What bounds it: f32 FMAs (15.3 GFLOP at
// the flagship, 0.23 ms at the 67 TFLOP/s peak), so q k^T and p v are
// register tiles fed by float4 reads, every K and V row enters shared
// memory once per 64 query rows (197 tokens: 4 CTAs of 50 rows a (frame,
// head), two CTAs an SM), and the copies are in flight while the previous
// chunk is multiplied: q's rows and the keys' 16-column chunks through two
// cp.async stages, a 4-row x 16-key-group score tile a thread (keys tx +
// 16g); up to 256 keys the exact softmax is taken on those registers (a
// row's keys lie in a half warp) and p written to shared memory once; past
// 256 (fused_attention's one-shot range, no model path) 32 query rows a CTA
// and key tiles of 256 fill a score row of up to 1024 in shared memory,
// softmaxed there a warp a row. Then p v over 32-key tiles of v through the
// same stages, a 4 x 4 (d <= 64) or 4 x 8 output tile a thread.
//
// Temporal, bf16 (temporal_attention_mma_kernel): bound by bytes. At the
// flagship shape it reads the 116 MB qkv and writes 39 MB, 0.046 ms at 3.35
// TB/s; its products are 1.2 GFLOP, about 1 us on the tensor cores. A work
// item is (clip, token, a group of up to 4 heads): 3 x T rows of d elements a
// head (at the flagship a token's heads lie side by side in a frame, 1.5 KB
// of q, of k and of v). Persistent CTAs of one warp a head copy the next
// item's rows with cp.async (16 bytes a thread; every row padded by 16 bytes
// so that ldmatrix's 8 rows hit 8 bank groups; zeros past T, d and H) into
// one of two stages while the warps attend on the item in the other, all in
// bf16. A warp forms S = q k^T as one m16 tile (two for T > 16) on mma.sync
// m16n8k16, takes the softmax in the accumulators (a quad of lanes holds a
// row: max and sum by two shuffles, keys past T at -inf), feeds p, rounded
// to bf16, from those registers as the A operand of p v (v through
// ldmatrix.trans), and stores the bf16 output through its own q rows as
// 16-byte vectors. cp.async rather than TMA: a head's rows are 16-byte
// granular at any stride and the padding is per row. mma.sync rather than
// wgmma: wgmma's tiles have 64 rows and a head has 16 (or 32) frames, so
// filling them would stack 4 tokens into one block-diagonal tile, 4x the
// products for a kernel that the bytes bound. That stacking (NB tokens in
// one masked (NB T, NB T) product) is what the TPU kernels did to fill the
// 128 x 128 MXU, with the head-pair lane masks and the `lo` operand to keep
// their loads lane-aligned; none of it is carried over.
//
// Temporal, f32 (temporal_f32_kernel, with its own note below): the bf16
// kernel's plan on the CUDA cores. Every warp walks over (clip, token, head)
// items of its own, its next item's rows in flight through two cp.async
// stages; scores and p v are register tiles fed by float4 reads, the exact
// softmax taken on the scores' registers by shuffles within a quad.
//
// Rounding points as the Pallas bodies: f32 scores from x-dtype operands, times
// scale, f32 softmax (exp(s - max) / sum), p rounded to v's dtype, f32
// accumulation, the output rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "f32_layout.cuh"  // the f32 spatial kernel's layout and plan (also read by a host compiler)
#include "hopper.cuh"  // TMA, mbarriers, setmaxnreg, wgmma

namespace {

namespace mf = maed_f32;
using bf16 = __nv_bfloat16;


// ------------------------------------------- Hopper kernels (bf16)
//
// Built from hopper.cuh's blocks (see there): a TMA producer warpgroup and
// two wgmma consumer warpgroups a persistent CTA.

constexpr int kBox = 64;                             // rows of a TMA box

// A bf16 operand with head dim D as TMA writes it and wgmma reads it: rows of
// min(D, 64) elements (32, 64 or 128 bytes) under the swizzle of that width;
// D = 128 is two column halves, each a tile of its own (a box is at most one
// swizzle span wide). A tile of `rows` rows keeps half h at h * rows rows.
template <int D>
struct Operand {
  static constexpr int kRowBytes = (D < 64 ? D : 64) * 2;
  static constexpr int kHalves = D * 2 / kRowBytes;
  // wgmma's layout code for that swizzle: 1 = 128 bytes, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kN = D < 64 ? D : 64;         // the n of one P V wgmma
};


// The mbarriers of a CTA's two rings, from `at` in shared memory: `nq` query
// buffers and `stages` K/V stages, each with a full barrier (one arrival: the
// producer's expect_tx, completed by the TMA bytes) and an empty one (one
// arrival by every consumer thread). Thread 0 initialises them and the CTA
// syncs before it returns.
struct Barriers {
  uint32_t q_full, q_empty, kv_full, kv_empty;
};
__device__ __forceinline__ Barriers init_barriers(uint32_t at, int nq, int stages) {
  const Barriers bar{at, at + 8 * nq, at + 16 * nq, at + 16 * nq + 8 * stages};
  if (threadIdx.x == 0) {
    for (int i = 0; i < nq; ++i) {
      mbar_init(bar.q_full + 8 * i, 1);
      mbar_init(bar.q_empty + 8 * i, 128 * kConsumers);
    }
    for (int i = 0; i < stages; ++i) {
      mbar_init(bar.kv_full + 8 * i, 1);
      mbar_init(bar.kv_empty + 8 * i, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bar;
}

// one box of the (D, S, H, B) tensor map at (c0, row, h, b) into shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0,
                                        int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(row), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// rows row0 .. row0 + 64 * boxes - 1 of (b, h)'s (S, D) matrix into the tile at
// dst (`rows` rows a half); rows at or beyond S arrive as zeros. Returns the
// bytes the barrier is to expect.
template <int D>
__device__ __forceinline__ uint32_t tma_rows(uint32_t dst, int rows, const CUtensorMap& map,
                                             uint32_t bar, int b, int h, int row0, int boxes) {
  using Op = Operand<D>;
  for (int half = 0; half < Op::kHalves; ++half)
    for (int box = 0; box < boxes; ++box)
      tma_box(dst + (half * rows + box * kBox) * Op::kRowBytes, map, bar,
              half * (Op::kRowBytes / 2), row0 + box * kBox, h, b);
  return static_cast<uint32_t>(boxes) * kBox * D * 2;
}

// K-major operand (q or k: its rows along M or N, the head dim along K): rows
// row0 .. of the tile at `tile`, the 16 head-dim columns of step kk. Groups of
// 8 rows lie 8 rows apart (SBO); a step moves 32 bytes within the swizzled row.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows, int row0, int kk) {
  using Op = Operand<D>;
  const int half = kk * 32 / Op::kRowBytes, within = kk * 32 % Op::kRowBytes;
  return smem_desc(tile + (half * rows + row0) * Op::kRowBytes + within, 16, 8 * Op::kRowBytes,
                   Op::kLayout);
}
// MN-major B operand (v: keys along K, the head dim along N): keys key0 ..
// key0 + 15 of head-dim half `half`. Groups of 8 keys lie 8 rows apart (SBO);
// the next 64 columns of N would lie a half away (LBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows, int key0, int half) {
  using Op = Operand<D>;
  return smem_desc(tile + (half * rows + key0) * Op::kRowBytes, rows * Op::kRowBytes,
                   8 * Op::kRowBytes, Op::kLayout);
}


// e^x for x <= 0 as 2^(x log2 e) is what __expf computes; with the scores kept
// in units of log 2 the multiplication is paid once, in the scale. -inf gives 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool kLowest = false>
__device__ __forceinline__ float extreme(float a, float b) {
  return kLowest ? fminf(a, b) : fmaxf(a, b);
}
// the max (or, kLowest, the min) of v across the 4 lanes of a quad: a row's
template <bool kLowest = false>
__device__ __forceinline__ float quad_max(float v) {
  v = extreme<kLowest>(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return extreme<kLowest>(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The thread's two rows of a warpgroup's 64 x D output (rows row0 + 16w + t/4
// and + 8, those below S), times mul[row] and rounded, as bf16 pairs.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long os, const float (&o)[D / 2],
                                           int row0, int S, const float (&mul)[2]) {
  const int lane = threadIdx.x % 32, row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  bf16* dst = out + 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8 * r) * os + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * mul[r], o[4 * j + 2 * r + 1] * mul[r]);
  }
}

// The (D, S, H, B) tensor map of a (B, H, S, D) bf16 view with element
// strides sb, sh, ss (the head dim contiguous), in boxes of 64 rows of one
// column half, under the swizzle wgmma reads (Operand<D>). Returns 0, or
// kTensorMapError + the encoder's CUresult.
template <int D>
int make_tensor_map(CUtensorMap* map, const void* base, int B, int H, int S, long long sb,
                    long long sh, long long ss) {
  using Op = Operand<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {Op::kRowBytes / 2, kBox, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = Op::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Op::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// A bf16 call of the TMA kernels: q, k, v as (B, H, S, D) views with element
// strides sb, sh, ss (the head dim contiguous), the output as one with
// strides ob, oh, os.
struct TmaCall {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, H, S;
  long long sb, sh, ss, ob, oh, os;
  float scale;
  cudaStream_t stream;
};


// Launch Kernel (a TMA kernel's instantiation for head dim D) for call c:
// the tensor maps of q, k and v, built at each call since the views'
// pointers change; `smem` bytes of shared memory; one persistent CTA a SM
// over the B * H * ceil(S / item_rows) work items.
template <auto Kernel, int D>
int launch_tma(const TmaCall& c, int smem, int item_rows) {
  CUtensorMap maps[3];
  const void* bases[3] = {c.q, c.k, c.v};
  for (int i = 0; i < 3; ++i)
    if (const int err = make_tensor_map<D>(&maps[i], bases[i], c.B, c.H, c.S, c.sb, c.sh, c.ss))
      return err;
  if (const cudaError_t err = allow_smem<Kernel>(smem)) return static_cast<int>(err);
  const long long items = static_cast<long long>(c.B) * c.H * ((c.S + item_rows - 1) / item_rows);
  Kernel<<<persistent_ctas(items), kCtaThreads, smem, c.stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(c.out), c.B, c.H, c.S, c.ob, c.oh, c.os,
      c.scale);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, d>()) for a head dim the wgmma kernels take
// (16, 32, 64, 128), else cudaErrorInvalidValue
template <typename F>
int by_head_dim(int d, F f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// ------------------------------------------------- spatial, bf16 (TMA + wgmma)

constexpr int kSpChunk = 256;  // keys of a chunk; query rows of a block when S fits one chunk

template <int D>
struct SpatialLayout {
  static constexpr int kQBufs = D <= 64 ? 2 : 1, kStages = D <= 64 ? 2 : 1;
  static constexpr int kTile = kSpChunk * D * 2;  // bytes of 256 rows
  static constexpr int kQ = 0;                    // kQBufs query blocks
  static constexpr int kKV = kQ + kQBufs * kTile;  // kStages of (K chunk, V chunk)
  static constexpr int kBars = kKV + kStages * 2 * kTile;
  static constexpr int kBytes = kBars + 2 * (kQBufs + kStages) * 8 + 1024;  // + alignment
};

// The score columns a kernel forms for a query tile: the smallest of these
// that holds S rounded up to whole 8-key groups (past one chunk, 256). A
// width of 64k + 8 is k m64n64 strips and one m64n8 strip: 200 is the
// flagship's (N 197), for which four whole strips would form 28% more
// scores than it needs.
constexpr int kSpWidths[] = {64, 128, 192, 200, kSpChunk};

// s = q k^T (f32, unscaled) of query tile `tile` of the block at qt against
// the chunk's first kCols keys at kt. Thread t of warp w holds the score of
// column 8g + 2(t%4) + e%2 of its rows at s[4g + e], whichever strip it came
// from (the accumulator layout of Wgmma). The strips are formed whole
// whatever S is (the rows past S are zeros): a run-time n, or a branch
// between the wgmmas, makes ptxas serialise them, so the width is chosen on
// the host.
template <int D, int kCols>
__device__ __forceinline__ void spatial_scores(float (&s)[kCols / 2], uint32_t qt, int tile,
                                               uint32_t kt) {
  constexpr int kStrips = kCols / 64, kTail = kCols % 64;
  wgmma_fence();
#pragma unroll
  for (int strip = 0; strip < kStrips; ++strip)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<64>::ss(s + 32 * strip, desc_k_major<D>(qt, kSpChunk, 64 * tile, kk),
                    desc_k_major<D>(kt, kSpChunk, 64 * strip, kk), kk);
  if constexpr (kTail != 0) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kTail>::ss(s + 32 * kStrips, desc_k_major<D>(qt, kSpChunk, 64 * tile, kk),
                       desc_k_major<D>(kt, kSpChunk, 64 * kStrips, kk), kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<kCols / 2>(s);
}

// The max (kLowest: the min) of each of the thread's two rows of raw scores
// over the columns below `cols` (the chunk's share of the score width) and
// below S, across the row's 4 lanes. Only the one 8-key group that reaches S
// is looked at column by column.
template <bool kLowest, int kCols>
__device__ __forceinline__ void spatial_extreme(const float (&s)[kCols / 2], int k0, int cols,
                                                int S, float (&m)[2]) {
  const int t = threadIdx.x % 4;
  m[0] = m[1] = kLowest ? INFINITY : -INFINITY;
#pragma unroll
  for (int g = 0; g < kCols / 8; ++g) {
    const int c = k0 + 8 * g;  // the group's first key
    if (8 * g >= cols) continue;
    if (c + 8 > S) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + 2 * t + (e & 1) < S) m[e >> 1] = extreme<kLowest>(m[e >> 1], s[4 * g + e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = extreme<kLowest>(m[e >> 1], s[4 * g + e]);
    }
  }
  m[0] = quad_max<kLowest>(m[0]);
  m[1] = quad_max<kLowest>(m[1]);
}

// m2: each row's max of the scaled scores s * scale2 (in units of log 2, with
// scale2 = scale * log2 e), over the columns spatial_extreme takes. That is
// the max of the raw scores times scale2, or their min where scale2 < 0: the
// softmax costs a few instructions a score and is what bounds this kernel,
// so no score is scaled or masked that need not be.
template <int kCols>
__device__ __forceinline__ void spatial_max(const float (&s)[kCols / 2], int k0, int cols, int S,
                                            float scale2, float (&m2)[2]) {
  float m[2];
  if (scale2 < 0.f) {
    spatial_extreme<true, kCols>(s, k0, cols, S, m);
  } else {
    spatial_extreme<false, kCols>(s, k0, cols, S, m);
  }
  m2[0] = m[0] * scale2;
  m2[1] = m[1] * scale2;
}

// s = 2^(s * scale2 - m2) over the columns below `cols` and below S, 0 at the
// others (no exponential taken there); sum: the thread's share of each row's
// sum. As in spatial_extreme, only a group that reaches S (or lies past the
// width) is looked at column by column: a test a score would cost as much as
// the exponential.
template <int kCols>
__device__ __forceinline__ void spatial_exp(float (&s)[kCols / 2], int k0, int cols, int S,
                                            float scale2, const float (&m2)[2],
                                            float (&sum)[2]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int g = 0; g < kCols / 8; ++g) {
    const int c = k0 + 8 * g;
    if (8 * g >= cols || c + 8 > S) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * g + e];
        const bool live = 8 * g < cols && c + 2 * t + (e & 1) < S;
        x = live ? fast_exp2(fmaf(x, scale2, -m2[e >> 1])) : 0.f;
        sum[e >> 1] += x;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * g + e];
        x = fast_exp2(fmaf(x, scale2, -m2[e >> 1]));
        sum[e >> 1] += x;
      }
    }
  }
}

// o += round_bf16(s * inv_l) v over the first kCols keys rounded up to 16, 16
// at a time (p is 0 past S and v's rows past S are zeros): k-step i is the
// accumulator's 8-column groups 2i and 2i + 1 as they lie in the registers
// (for a width of 64k + 8 the last step's second group is zeros).
template <int D, int kCols>
__device__ __forceinline__ void spatial_pv(float (&o)[D / 2], const float (&s)[kCols / 2],
                                           const float (&inv_l)[2], uint32_t vt) {
  using Op = Operand<D>;
  constexpr int kGroups = kCols / 8, kSteps = (kGroups + 1) / 2;
  uint32_t p[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = 2 * ks + i;
      const float* f = &s[4 * (g < kGroups ? g : 0)];
      p[ks][2 * i] = g < kGroups ? pack_bf16(f[0] * inv_l[0], f[1] * inv_l[0]) : 0u;
      p[ks][2 * i + 1] = g < kGroups ? pack_bf16(f[2] * inv_l[1], f[3] * inv_l[1]) : 0u;
    }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int half = 0; half < Op::kHalves; ++half)
      Wgmma<Op::kN>::rs(o + 32 * half, p[ks], desc_mn_major<D>(vt, kSpChunk, 16 * ks, half), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(o);
}

// Work item: (b, h, query block), the block fastest. S <= 256: a block is the
// whole (frame, head), one chunk of K and V serves its 4 query tiles (consumer
// w takes tiles w and w + 2), each against kCols keys, and the softmax is
// exact in one go. S > 256 (kCols 256 only): a block is 128 rows (one tile a
// consumer), K passes in chunks twice: once for each row's max and sum, once
// for p v. Element (b, h, s, :) of out at b * ob + h * oh + s * os.
template <int D, int kCols>
__global__ void __launch_bounds__(kCtaThreads, 1) spatial_attention_tma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, int B, int H, int S,
    long long ob, long long oh, long long os, float scale) {
  using L = SpatialLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = smem_u32(align_smem(smem_raw));
  const auto [q_full, q_empty, kv_full, kv_empty] =
      init_barriers(smem + L::kBars, L::kQBufs, L::kStages);

  const int chunks = (S + kSpChunk - 1) / kSpChunk;
  const int block_rows = chunks == 1 ? kSpChunk : 2 * 64;
  const int blocks = (S + block_rows - 1) / block_rows;
  const long long items = static_cast<long long>(B) * H * blocks;

  if (threadIdx.x < 128) {  // the producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring qr, kr;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int pair = static_cast<int>(item / blocks), b = pair / H, h = pair % H;
        const int row0 = static_cast<int>(item % blocks) * block_rows;
        const int boxes = (min(S - row0, block_rows) + kBox - 1) / kBox;
        mbar_wait(q_empty + 8 * qr.slot, qr.phase ^ 1);
        const uint32_t qbar = q_full + 8 * qr.slot;
        mbar_expect_tx(qbar, static_cast<uint32_t>(boxes) * kBox * D * 2);
        tma_rows<D>(smem + L::kQ + qr.slot * L::kTile, kSpChunk, q_map, qbar, b, h, row0, boxes);
        qr.next(L::kQBufs);
        // pass 0: K alone (the rows' max and sum); pass 1: K and V
        for (int pass = chunks == 1 ? 1 : 0; pass < 2; ++pass)
          for (int c = 0; c < chunks; ++c) {  // whole chunks: past S they arrive as zeros
            mbar_wait(kv_empty + 8 * kr.slot, kr.phase ^ 1);
            const uint32_t bar = kv_full + 8 * kr.slot, kt = smem + L::kKV + kr.slot * 2 * L::kTile;
            mbar_expect_tx(bar, (pass + 1) * L::kTile);
            tma_rows<D>(kt, kSpChunk, k_map, bar, b, h, c * kSpChunk, kSpChunk / kBox);
            if (pass == 1)
              tma_rows<D>(kt + L::kTile, kSpChunk, v_map, bar, b, h, c * kSpChunk, kSpChunk / kBox);
            kr.next(L::kStages);
          }
      }
    }
  } else {  // the consumers
    regs_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 % 4;
    const float scale2 = scale * 1.4426950408889634f;  // scores in units of log 2
    const int width = (S + 7) / 8 * 8;  // score columns that count: S in whole 8-key groups
    const float one[2] = {1.f, 1.f};
    Ring qr, kr;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int pair = static_cast<int>(item / blocks), b = pair / H, h = pair % H;
      const int row0 = static_cast<int>(item % blocks) * block_rows;
      const int rows = min(S - row0, block_rows);
      bf16* out_bh = out + b * ob + h * oh;
      mbar_wait(q_full + 8 * qr.slot, qr.phase);
      const uint32_t qt = smem + L::kQ + qr.slot * L::kTile;
      if (chunks == 1) {
        mbar_wait(kv_full + 8 * kr.slot, kr.phase);
        const uint32_t kt = smem + L::kKV + kr.slot * 2 * L::kTile, vt = kt + L::kTile;
        for (int tile = wg; 64 * tile < rows; tile += kConsumers) {
          float s[kCols / 2], inv_l[2];
          spatial_scores<D, kCols>(s, qt, tile, kt);
          if (64 * tile + 16 * warp < rows) {  // else the warp's 16 rows all lie past S
            float m2[2], l[2] = {0.f, 0.f};
            spatial_max<kCols>(s, 0, width, S, scale2, m2);
            spatial_exp<kCols>(s, 0, width, S, scale2, m2, l);
            inv_l[0] = 1.f / quad_sum(l[0]);
            inv_l[1] = 1.f / quad_sum(l[1]);
          }
          float o[D / 2] = {};
          spatial_pv<D, kCols>(o, s, inv_l, vt);
          store_rows<D>(out_bh, os, o, row0 + 64 * tile, S, one);
        }
        mbar_arrive(kv_empty + 8 * kr.slot);
        kr.next(L::kStages);
      } else if constexpr (kCols == kSpChunk) {
        // this consumer's tile holds rows below S; this warp's 16 rows too
        const bool mine = 64 * wg < rows, live = 64 * wg + 16 * warp < rows;
        float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        for (int c = 0; c < chunks; ++c) {  // pass 0: running max and sum
          mbar_wait(kv_full + 8 * kr.slot, kr.phase);
          if (mine) {
            const int k0 = c * kSpChunk, cols = min(width - k0, kSpChunk);
            float s[kSpChunk / 2], mx[2], sum[2] = {0.f, 0.f};
            spatial_scores<D, kSpChunk>(s, qt, wg, smem + L::kKV + kr.slot * 2 * L::kTile);
            if (live) {
              spatial_max<kSpChunk>(s, k0, cols, S, scale2, mx);
              const float m_new[2] = {fmaxf(m2[0], mx[0]), fmaxf(m2[1], mx[1])};
              spatial_exp<kSpChunk>(s, k0, cols, S, scale2, m_new, sum);
#pragma unroll
              for (int r = 0; r < 2; ++r) {  // the first chunk has a column below S: alpha 0
                l[r] = l[r] * fast_exp2(m2[r] - m_new[r]) + sum[r];
                m2[r] = m_new[r];
              }
            }
          }
          mbar_arrive(kv_empty + 8 * kr.slot);
          kr.next(L::kStages);
        }
        const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
        float o[D / 2] = {};
        for (int c = 0; c < chunks; ++c) {  // pass 1: p = 2^(s - m) / l, o += p v
          mbar_wait(kv_full + 8 * kr.slot, kr.phase);
          if (mine) {
            const int k0 = c * kSpChunk, cols = min(width - k0, kSpChunk);
            const uint32_t kt = smem + L::kKV + kr.slot * 2 * L::kTile;
            float s[kSpChunk / 2], sum[2] = {0.f, 0.f};
            spatial_scores<D, kSpChunk>(s, qt, wg, kt);
            if (live) spatial_exp<kSpChunk>(s, k0, cols, S, scale2, m2, sum);
            spatial_pv<D, kSpChunk>(o, s, inv_l, kt + L::kTile);
          }
          mbar_arrive(kv_empty + 8 * kr.slot);
          kr.next(L::kStages);
        }
        if (mine) store_rows<D>(out_bh, os, o, row0 + 64 * wg, S, one);
      }
      mbar_arrive(q_empty + 8 * qr.slot);
      qr.next(L::kQBufs);
    }
  }
}

// the kernel of the first of kSpWidths[i..] that holds S's score width
template <int D, int i = 0>
int launch_spatial_tma(const TmaCall& c) {
  constexpr int kCols = kSpWidths[i];
  if constexpr (kCols < kSpChunk) {
    if ((c.S + 7) / 8 * 8 > kCols) return launch_spatial_tma<D, i + 1>(c);
  }
  return launch_tma<spatial_attention_tma_kernel<D, kCols>, D>(
      c, SpatialLayout<D>::kBytes, c.S <= kSpChunk ? kSpChunk : 128);
}

// ------------------------------------------------------ spatial, f32
//
// f32_layout.cuh's layout and plan. grid: (batch, head) items x row blocks,
// the row block fastest, so that the CTAs of one item run at the same time
// and its K and V come from device memory once. Element (b, h, s, :) of q,
// k, v at b * sb + h * sh + s * ss, of out at b * ob + h * oh + s * os;
// vec_out: out and its strides 16-byte granular (float4 stores).
template <int RPT, int G, int NB>
__global__ void __launch_bounds__(mf::kSpThreads, G <= 13 ? 2 : 1) spatial_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int H, int S, int d, long long sb, long long sh, long long ss,
    long long ob, long long oh, long long os, float scale, int key_tiles, int blocks, int rows,
    int vec_out) {
  constexpr int kRows = 16 * RPT, kKeys = 16 * G, kCp = mf::kSpChunkPitch, kDc = mf::kSpDc;
  constexpr int kStage = mf::spatial_stage(RPT, G);
  constexpr int kVPitch = mf::spatial_v_pitch(NB), kV = mf::kSpVKeys * kVPitch;
  constexpr int kRing = 2 * kStage > 2 * kV ? 2 * kStage : 2 * kV;
  constexpr bool kOneTile = RPT == 4;  // the plan's S <= 256: one key tile, softmax in registers
  extern __shared__ __align__(16) float sp_smem[];
  const int width = key_tiles * kKeys, p_pitch = mf::spatial_p_pitch(RPT, width);
  float* const p_s = sp_smem + kRing;  // the score rows, then p

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long item = blockIdx.x / blocks;
  const int row0 = static_cast<int>(blockIdx.x % blocks) * rows;
  const int nrows = min(rows, S - row0);
  const bool live = 2 * RPT * (tid / 32) < nrows;  // warp w: rows 2 RPT w .. 2 RPT w + 2 RPT - 1
  const long long in_base = item / H * sb + item % H * sh;
  q += in_base;
  k += in_base;
  v += in_base;
  out += item / H * ob + item % H * oh;

  // step s: column chunk s % chunks of q's rows and of key tile s / chunks
  const int chunks = (d + kDc - 1) / kDc, steps = key_tiles * chunks;
  auto load_qk = [&](int s) {
    float* st = sp_smem + (s & 1) * kStage;
    const int key0 = s / chunks * kKeys, c0 = s % chunks * kDc;
    for (int i = tid; i < (kRows + kKeys) * (kDc / 4); i += mf::kSpThreads) {
      const int r = i / (kDc / 4), c = c0 + i % (kDc / 4) * 4;
      const bool is_q = r < kRows;
      const int row = is_q ? row0 + r : key0 + r - kRows;
      const bool ok = (is_q ? r < nrows : row < S) && c < d;
      cp_async16(smem_u32(st + r * kCp + c - c0), ok ? (is_q ? q : k) + row * ss + c : q, ok);
    }
    cp_async_commit();
  };
  float acc[G][RPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[g][i] = 0.f;
  load_qk(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_qk(s + 1);
    } else {
      cp_async_commit();  // an empty group keeps the count
    }
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const float* qs = sp_smem + (s & 1) * kStage + RPT * ty * kCp;
      const float* ks = sp_smem + (s & 1) * kStage + (kRows + tx) * kCp;
#pragma unroll
      for (int c = 0; c < kDc; c += 4) {
        float4 qv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + i * kCp + c);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + 16 * g * kCp + c);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc[g][i] = fmaf(qv[i].x, kv.x, acc[g][i]);
            acc[g][i] = fmaf(qv[i].y, kv.y, acc[g][i]);
            acc[g][i] = fmaf(qv[i].z, kv.z, acc[g][i]);
            acc[g][i] = fmaf(qv[i].w, kv.w, acc[g][i]);
          }
        }
      }
    }
    if (s % chunks == chunks - 1) {  // the key tile's scores are whole
      const int key0 = s / chunks * kKeys;
      if constexpr (kOneTile) {
        // the exact softmax in registers: a row's keys lie in the 16 lanes
        // of a half warp; p (0 from S on) into the score rows
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float mx = -INFINITY, sum = 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][i] = 16 * g + tx < S ? acc[g][i] * scale : -INFINITY;
            mx = fmaxf(mx, acc[g][i]);
          }
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][i] = expf(acc[g][i] - mx);
            sum += acc[g][i];
          }
          for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          const float inv = 1.f / sum;
#pragma unroll
          for (int g = 0; g < G; ++g) p_s[(RPT * ty + i) * p_pitch + 16 * g + tx] = acc[g][i] * inv;
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int key = key0 + 16 * g + tx;
            p_s[(RPT * ty + i) * p_pitch + key] = key < S ? acc[g][i] * scale : -INFINITY;
          }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[g][i] = 0.f;
    }
    __syncthreads();
  }

  // v's 32-key tiles through the two stages' memory, the first one in flight
  // while the softmax runs
  const int vtiles = (S + mf::kSpVKeys - 1) / mf::kSpVKeys;
  auto load_v = [&](int t) {
    float* st = sp_smem + (t & 1) * kV;
    for (int i = tid; i < mf::kSpVKeys * 16 * NB; i += mf::kSpThreads) {
      const int r = i / (16 * NB), c = i % (16 * NB) * 4, key = t * mf::kSpVKeys + r;
      const bool ok = key < S && c < d;
      cp_async16(smem_u32(st + r * kVPitch + c), ok ? v + key * ss + c : v, ok);
    }
    cp_async_commit();
  };
  load_v(0);
  if constexpr (!kOneTile) {  // the exact softmax of each row, a warp a row; 0 from S on
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < nrows; r += mf::kSpThreads / 32) {
      float* row = p_s + r * p_pitch;
      float mx = -INFINITY, sum = 0.f;
      for (int j = lane; j < width; j += 32) mx = fmaxf(mx, row[j]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      for (int j = lane; j < width; j += 32) {
        const float e = expf(row[j] - mx);
        row[j] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int j = lane; j < width; j += 32) row[j] = row[j] / sum;
    }
  }

  // out = p v: o[i][b] holds columns spatial_col(b, tx, 0 .. 3) of row RPT ty + i
  const int keys4 = (S + 3) / 4 * 4;  // p is 0 and v's rows are zeros from S on
  float o[RPT][NB][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][b][c] = 0.f;
  for (int t = 0; t < vtiles; ++t) {
    if (t + 1 < vtiles) {
      load_v(t + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();  // the tile has landed; every row's p is written
    if (live) {
      const float* vs = sp_smem + (t & 1) * kV + mf::spatial_col(0, tx, 0);
      const float* ps = p_s + RPT * ty * p_pitch + t * mf::kSpVKeys;
      const int keys = min(mf::kSpVKeys, keys4 - t * mf::kSpVKeys);
#pragma unroll 2
      for (int key = 0; key < keys; key += 4) {
        float4 pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          pv[i] = *reinterpret_cast<const float4*>(ps + i * p_pitch + key);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vs + (key + e) * kVPitch + 64 * b);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
              o[i][b][0] = fmaf(pe, vv.x, o[i][b][0]);
              o[i][b][1] = fmaf(pe, vv.y, o[i][b][1]);
              o[i][b][2] = fmaf(pe, vv.z, o[i][b][2]);
              o[i][b][3] = fmaf(pe, vv.w, o[i][b][3]);
            }
          }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = RPT * ty + i;
    if (row >= nrows) break;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int col = mf::spatial_col(b, tx, 0);
      if (col >= d) continue;  // d a multiple of 8: 4 columns all in or all out
      float* dst = out + (row0 + row) * os + col;
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[i][b][0], o[i][b][1], o[i][b][2], o[i][b][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = o[i][b][c];
      }
    }
  }
}

template <int RPT, int G, int NB>
int launch_spatial_f32_instance(const TmaCall& c, int d, const mf::SpatialPlan& p, int vec_out) {
  const auto kernel = spatial_f32_kernel<RPT, G, NB>;
  if (const cudaError_t err = allow_smem<spatial_f32_kernel<RPT, G, NB>>(mf::kMaxSmem))
    return static_cast<int>(err);
  const long long ctas = static_cast<long long>(c.B) * c.H * p.blocks;
  kernel<<<static_cast<unsigned>(ctas), mf::kSpThreads, p.bytes, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<float*>(c.out), c.H, c.S, d, c.sb, c.sh, c.ss,
      c.ob, c.oh, c.os, c.scale, p.key_tiles, p.blocks, p.rows, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int RPT, int G>
int launch_spatial_f32_nb(const TmaCall& c, int d, const mf::SpatialPlan& p, int vec_out) {
  return p.nb == 1 ? launch_spatial_f32_instance<RPT, G, 1>(c, d, p, vec_out)
                   : launch_spatial_f32_instance<RPT, G, 2>(c, d, p, vec_out);
}

// the instance of spatial_f32_plan(S, d), or cudaErrorInvalidValue
int launch_spatial_f32(const TmaCall& c, int d) {
  const mf::SpatialPlan p = mf::spatial_f32_plan(c.S, d);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (p.bytes == 0 || p.bytes > mf::kMaxSmem || !aligned(c.q) || !aligned(c.k) ||
      !aligned(c.v) || c.sb % 4 || c.sh % 4 || c.ss % 4 ||
      static_cast<long long>(c.B) * c.H * p.blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_out = aligned(c.out) && c.ob % 4 == 0 && c.oh % 4 == 0 && c.os % 4 == 0;
  if (p.rpt == 2) return launch_spatial_f32_nb<2, 16>(c, d, p, vec_out);
  switch (p.g) {
    case 2: return launch_spatial_f32_nb<4, 2>(c, d, p, vec_out);
    case 4: return launch_spatial_f32_nb<4, 4>(c, d, p, vec_out);
    case 8: return launch_spatial_f32_nb<4, 8>(c, d, p, vec_out);
    case 12: return launch_spatial_f32_nb<4, 12>(c, d, p, vec_out);
    case 13: return launch_spatial_f32_nb<4, 13>(c, d, p, vec_out);
    case 16: return launch_spatial_f32_nb<4, 16>(c, d, p, vec_out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------- blocked (online softmax)
//
// Replaces maed_tpu/ops/attention.py::_attn_blocked_kernel: one pass over the
// keys with a running max m, a running sum l and an f32 accumulator per query
// row. For a key tile: s = q k^T * scale in f32 (columns beyond S at -inf),
// m_new = max(m, rowmax s), alpha = exp(m - m_new), p = exp(s - m_new); l =
// alpha l + sum p over the UNROUNDED p; acc = alpha acc + round(p) v with p
// rounded to v's dtype unnormalised; out = acc / l once at the end. (The
// spatial kernel normalises p before it rounds, so the two differ in bf16.)
//
// What bounds it on the H100: operations. At the coupling shape (B 8, h 12,
// S 3152, d 64) the two products are 2.44e11 FLOP, 0.247 ms at the bf16
// tensor-core peak, against 0.046 ms for its 155 MB; and 9.5e8 exponentials,
// which the SM's special-function units take about as long as the products
// take the tensor cores. So the scores are formed once, never leave
// registers, and the exponentials of one key tile run while the tensor cores
// multiply the previous tile's p into v.
//
// bf16 (head dim 16, 32, 64 or 128), warp-specialised as the spatial kernel:
// a work item is 128 query rows of one (batch, head), consumer w takes rows
// 64w .. 64w + 63; the producer streams 128-key tiles of K and V through a
// ring (4 stages up to head dim 64, 2 at 128) and the next item's q into the
// other of two query buffers. Per key tile j a consumer issues s_j = q k_j^T
// (m64n128k16, q and k from shared memory) and o += p_{j-1} v_{j-1}
// (m64nDk16, p from registers as the scores' accumulator lies, v MN-major),
// waits for s_j alone, and computes its max, alpha and exponentials while the
// p v product runs; then it rescales o, releases tile j - 1 and packs p_j.
// The scores are kept in units of log 2 (scale * log2 e in one
// multiplication), so every exponential is one ex2. S is not padded anywhere:
// the last tile's missing rows arrive as zeros from TMA and its columns at or
// beyond S are -inf (the first tile always has a column below S). A 128-key
// tile moves the running max at other columns than the plain version's
// 512-key blocks, so an unnormalised p may round to the neighbouring bf16 value.
//
// f32 (blocked_f32_kernel, below): the same steps on the CUDA cores (no
// TF32), 128 query rows a persistent CTA (64 at head dims above 64) and
// 128-key tiles through a cp.async ring.

constexpr int kBkTile = 128;  // keys of a tile; query rows of a work item
// TMA boxes of a tile: all of them, also past S (they arrive as zeros), since
// a row of v that holds stale shared memory would give 0 * NaN in p v
constexpr int kBoxes = kBkTile / kBox;

// key tiles of a row of S keys, the last one partial
__device__ __forceinline__ int key_tiles(int S) { return (S + kBkTile - 1) / kBkTile; }

template <int D>
struct BlockedLayout {
  static constexpr int kStages = D <= 64 ? 4 : 2;
  static constexpr int kTile = kBkTile * D * 2;  // bytes of 128 rows
  static constexpr int kQ = 0;                   // two query buffers
  static constexpr int kKV = 2 * kTile;          // kStages of (K tile, V tile)
  static constexpr int kBars = kKV + kStages * 2 * kTile;
  static constexpr int kBytes = kBars + 2 * (2 + kStages) * 8 + 1024;  // + alignment
};

// issue s = q k^T (unscaled) for the consumer's 64 query rows against the
// tile's 128 keys; no commit
template <int D>
__device__ __forceinline__ void blocked_scores(float (&s)[64], uint32_t qt, int wg, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<128>::ss(s, desc_k_major<D>(qt, kBkTile, 64 * wg, kk),
                   desc_k_major<D>(kt, kBkTile, 0, kk), kk);
}

// issue o += p v over the tile's 128 keys; no commit
template <int D>
__device__ __forceinline__ void blocked_pv(float (&o)[D / 2], const uint32_t (&p)[8][4],
                                           uint32_t vt) {
  using Op = Operand<D>;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int half = 0; half < Op::kHalves; ++half)
      Wgmma<Op::kN>::rs(o + 32 * half, p[ks], desc_mn_major<D>(vt, kBkTile, 16 * ks, half), 1);
}

// scores into units of log 2, columns at or beyond S (from k0 on) at -inf;
// returns the max of the thread's two rows across the row's 4 lanes
__device__ __forceinline__ void blocked_mask_max(float (&s)[64], int k0, int S, float scale2,
                                                 float (&mx)[2]) {
  const int t = threadIdx.x % 4;
  mx[0] = mx[1] = -INFINITY;
  const bool ragged = k0 + kBkTile > S;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      x = !ragged || k0 + 8 * j + 2 * t + (e & 1) < S ? x * scale2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// The consumers take turns to issue their products: consumer w waits on
// named barrier 1 + w before it issues and then arrives on the other's, so
// that one's softmax runs while the other's wgmmas do. (256 threads a
// barrier: the 128 that wait and the 128 that arrive; barrier 0 is
// __syncthreads'.)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// s = 2^(s - m); sum: the thread's share of each row's sum of the unrounded p
__device__ __forceinline__ void blocked_exp(float (&s)[64], const float (&m)[2], float (&sum)[2]) {
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
}

// p rounded to bf16, unnormalised: k-step i of the p v product is the
// accumulator's 8-column groups 2i and 2i + 1 as they lie in the registers
__device__ __forceinline__ void blocked_pack(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[ks][r] = pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
}

// grid: persistent; work item (b, h, block of 128 query rows), the block
// fastest. Addressing as spatial_attention_tma_kernel.
template <int D>
__global__ void __launch_bounds__(kCtaThreads, 1) blocked_attention_tma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, int B, int H, int S,
    long long ob, long long oh, long long os, float scale) {
  using L = BlockedLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = smem_u32(align_smem(smem_raw));
  const auto [q_full, q_empty, kv_full, kv_empty] = init_barriers(smem + L::kBars, 2, L::kStages);

  const int tiles = key_tiles(S), blocks = (S + kBkTile - 1) / kBkTile;
  const long long items = static_cast<long long>(B) * H * blocks;

  if (threadIdx.x < 128) {  // the producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring qr, kr;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int pair = static_cast<int>(item / blocks), b = pair / H, h = pair % H;
        const int row0 = static_cast<int>(item % blocks) * kBkTile;
        mbar_wait(q_empty + 8 * qr.slot, qr.phase ^ 1);
        const uint32_t qbar = q_full + 8 * qr.slot;
        mbar_expect_tx(qbar, L::kTile);
        tma_rows<D>(smem + L::kQ + qr.slot * L::kTile, kBkTile, q_map, qbar, b, h, row0, kBoxes);
        qr.next(2);
        for (int j = 0; j < tiles; ++j) {
          mbar_wait(kv_empty + 8 * kr.slot, kr.phase ^ 1);
          const uint32_t bar = kv_full + 8 * kr.slot, kt = smem + L::kKV + kr.slot * 2 * L::kTile;
          mbar_expect_tx(bar, 2 * L::kTile);
          tma_rows<D>(kt, kBkTile, k_map, bar, b, h, j * kBkTile, kBoxes);
          tma_rows<D>(kt + L::kTile, kBkTile, v_map, bar, b, h, j * kBkTile, kBoxes);
          kr.next(L::kStages);
        }
      }
    }
  } else {  // the consumers
    regs_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const float scale2 = scale * 1.4426950408889634f;  // scores in units of log 2
    Ring qr, kr;
    if (wg == 1) turn_pass(wg);  // consumer 0 issues first
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int pair = static_cast<int>(item / blocks), b = pair / H, h = pair % H;
      const int row0 = static_cast<int>(item % blocks) * kBkTile + 64 * wg;
      mbar_wait(q_full + 8 * qr.slot, qr.phase);
      const uint32_t qt = smem + L::kQ + qr.slot * L::kTile;
      {  // rows at or past S (zeros) are computed too, for the turns, and not stored
        float s[64], o[D / 2] = {}, m[2], l[2], mx[2];
        uint32_t p[8][4];
        // tile 0
        mbar_wait(kv_full + 8 * kr.slot, kr.phase);
        uint32_t kt = smem + L::kKV + kr.slot * 2 * L::kTile;
        turn_wait(wg);
        wgmma_fence();
        blocked_scores<D>(s, qt, wg, kt);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs<64>(s);
        blocked_mask_max(s, 0, S, scale2, m);
        blocked_exp(s, m, l);
        blocked_pack(p, s);
        int prev = kr.slot;
        uint32_t v_prev = kt + L::kTile;
        kr.next(L::kStages);
        for (int j = 1; j < tiles; ++j) {
          mbar_wait(kv_full + 8 * kr.slot, kr.phase);
          kt = smem + L::kKV + kr.slot * 2 * L::kTile;
          turn_wait(wg);
          wgmma_fence();
          blocked_scores<D>(s, qt, wg, kt);
          wgmma_commit();
          blocked_pv<D>(o, p, v_prev);
          wgmma_commit();
          turn_pass(wg);
          wgmma_wait<1>();  // the scores; p v still runs
          fence_regs<64>(s);
          blocked_mask_max(s, j * kBkTile, S, scale2, mx);
          float alpha[2], sum[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], mx[r]);
            alpha[r] = fast_exp2(m[r] - m_new);
            m[r] = m_new;
          }
          blocked_exp(s, m, sum);
          wgmma_wait<0>();
          fence_regs<D / 2>(o);
          mbar_arrive(kv_empty + 8 * prev);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
          l[0] = l[0] * alpha[0] + sum[0];
          l[1] = l[1] * alpha[1] + sum[1];
          blocked_pack(p, s);
          prev = kr.slot;
          v_prev = kt + L::kTile;
          kr.next(L::kStages);
        }
        turn_wait(wg);
        wgmma_fence();
        blocked_pv<D>(o, p, v_prev);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        mbar_arrive(kv_empty + 8 * prev);
        // alpha is the same in a row's 4 lanes, so the shares of l add up now
        const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
        store_rows<D>(out + b * ob + h * oh, os, o, row0, S, inv_l);
      }
      mbar_arrive(q_empty + 8 * qr.slot);
      qr.next(2);
    }
    if (wg == 0) turn_wait(wg);  // the last turn consumer 1 passed
  }
}

// f32, a head dim that is a multiple of 8 up to 128: blocked_f32_kernel, the
// layout and plan of f32_layout.cuh (see there). What bounds it: f32 FMAs
// (2.44e11 FLOP at the coupling shape, 3.64 ms at the 67 TFLOP/s peak,
// against 0.046 ms for its bytes), so both products are register tiles fed
// by float4 reads as in the f32 GEMM (gemm_f32_kernel), every K and V row
// enters shared memory once per 128 query rows, and the copies of the next
// tiles (and of the next item's q) are in flight while the current one is
// multiplied. Per key tile: s = q k^T * scale (in units of log 2, so every
// exponential is one ex2; keys at or past S at -inf, the first tile always
// has a key below S), the row's max by shuffles within its half warp, alpha =
// 2^(m - m_new), p = 2^(s - m_new) into shared memory once, the thread's
// share of l = alpha l + sum p; then each run of p v rescales its partial
// sums by its rows' alpha and adds p v over its dp keys. At the end of an
// item the runs' sums are added and divided by l once. Rows past S are
// computed on zeros and not stored. The unroll factors (8 steps of q k^T, 4
// of p v) were the fastest of those timed at the flagship (1 to 16 each;
// PERF.md §6).
template <int DP>
__global__ void __launch_bounds__(mf::kBkThreads, 1) blocked_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int B, int H, int S, int d, long long sb, long long sh,
    long long ss, long long ob, long long oh, long long os, float scale, int vec_out) {
  constexpr int kRows = mf::blocked_rows(DP), kTm = mf::blocked_tm(DP);
  constexpr int kStages = mf::blocked_stages(DP), kPitch = mf::blocked_pitch(DP);
  constexpr int kSlot = mf::blocked_slot_floats(DP), kKeys = mf::kBkKeys;
  constexpr int kRg = mf::kBkRowGroups, kPp = mf::kBkPPitch, kThreads = mf::kBkThreads;
  constexpr int kCopies = kKeys * DP / 4 / kThreads;  // 16-byte copies of a thread, a K or V tile
  constexpr int kQCopies = kRows * DP / 4 / kThreads;
  extern __shared__ __align__(16) float bk_s[];
  float* const q_s = bk_s;
  float* const ring = q_s + mf::blocked_q_floats(DP);
  float* const p_s = ring + kStages * kSlot;  // p; the runs' sums at the end of an item
  float* const alpha_s = p_s + mf::blocked_p_floats(DP);
  float* const l_s = alpha_s + kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int blocks = (S + kRows - 1) / kRows, tiles = (S + kKeys - 1) / kKeys;
  const long long items = static_cast<long long>(B) * H * blocks;
  const float scale2 = scale * 1.4426950408889634f;  // scores in units of log 2
  auto head_offset = [&](long long item) {
    const long long bh = item / blocks;
    return bh / H * sb + bh % H * sh;
  };
  // rows row0 .. of a q, K or V tile from src into dst (zeros past S and d):
  // copy n of the thread is row (tid + 256 n) / (DP / 4) of the tile
  auto copy_rows = [&](float* dst, const float* src, int row0, auto copies) {
#pragma unroll
    for (int n = 0; n < decltype(copies)::value; ++n) {
      const int idx = tid + kThreads * n, r = idx / (DP / 4), c = idx % (DP / 4) * 4;
      const bool ok = row0 + r < S && c < d;
      cp_async16(smem_u32(dst + r * kPitch + c), ok ? src + (row0 + r) * ss + c : src, ok);
    }
  };
  auto load_q = [&](long long item) {
    copy_rows(q_s, q + head_offset(item), static_cast<int>(item % blocks) * kRows,
              std::integral_constant<int, kQCopies>());
  };

  // The loads walk the CTA's sequence of tiles (K 0, V 0, K 1, ... of each
  // of its items) kStages - 1 tiles ahead of the products, slot by slot.
  long long ld_item = blockIdx.x;
  int ld_unit = 0, ld_slot = 0;
  long long ld_off = ld_item < items ? head_offset(ld_item) : 0;
  auto load_next = [&]() {  // no commit
    if (ld_item < items) {
      copy_rows(ring + ld_slot * kSlot, (ld_unit & 1 ? v : k) + ld_off, (ld_unit >> 1) * kKeys,
                std::integral_constant<int, kCopies>());
      if (++ld_unit == 2 * tiles) {
        ld_unit = 0;
        ld_item += gridDim.x;
        if (ld_item < items) ld_off = head_offset(ld_item);
      }
    }
    ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
  };

  if (blockIdx.x >= items) return;
  load_q(blockIdx.x);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_next();
    cp_async_commit();
  }

  const int split = mf::blocked_o_split(DP, tid);
  const float* const q_row = q_s + mf::blocked_s_row(warp, lane, 0) * kPitch;
  const float* const p_row = p_s + mf::blocked_o_row(DP, tid, 0) * kPp + split * DP;
  float m[kTm], l[kTm], o[kTm][8];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  int slot = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int row0 = static_cast<int>(item % blocks) * kRows;
#pragma unroll
    for (int i = 0; i < kTm; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int j = 0; j < tiles; ++j) {
      // K tile j: the scores, the softmax, p
      if (j == 0) {
        cp_async_wait<0>();  // the item's q came with the last group
      } else {
        cp_async_wait<kStages - 2>();
      }
      __syncthreads();  // the tile has landed; the previous p and alpha are read
      load_next();
      cp_async_commit();
      {
        const float* const k_row = ring + slot * kSlot + mf::blocked_s_key(lane, 0) * kPitch;
        float s[kTm][8];
#pragma unroll
        for (int i = 0; i < kTm; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
        for (int c = 0; c < DP; c += 4) {
          float4 qv[kTm], kv[8];
#pragma unroll
          for (int i = 0; i < kTm; ++i)
            qv[i] = *reinterpret_cast<const float4*>(q_row + kRg * i * kPitch + c);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            kv[jj] = *reinterpret_cast<const float4*>(k_row + 16 * jj * kPitch + c);
#pragma unroll
          for (int i = 0; i < kTm; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
              s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
              s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
              s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
            }
        }
        const bool ragged = (j + 1) * kKeys > S;
#pragma unroll
        for (int i = 0; i < kTm; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const bool masked = ragged && mf::blocked_masked(j, mf::blocked_s_key(lane, jj), S);
            s[i][jj] = masked ? -INFINITY : s[i][jj] * scale2;
            mx = fmaxf(mx, s[i][jj]);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = fast_exp2(m[i] - m_new);  // 0 on the first tile
          m[i] = m_new;
          float sum = 0.f;
          const int row = mf::blocked_s_row(warp, lane, i);
          float* const prow = p_s + row * kPp + mf::blocked_s_key(lane, 0);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float p = fast_exp2(s[i][jj] - m_new);
            sum += p;
            prow[16 * jj] = p;
          }
          l[i] = l[i] * alpha + sum;
          if (lane % 16 == 0) alpha_s[row] = alpha;
        }
      }
      slot = slot + 1 == kStages ? 0 : slot + 1;

      // V tile j: each run of p v over its DP keys
      cp_async_wait<kStages - 2>();
      __syncthreads();  // the tile has landed; p and alpha are written
      if (j == tiles - 1 && item + gridDim.x < items) load_q(item + gridDim.x);
      load_next();
      cp_async_commit();
      {
        const float* const v_row =
            ring + slot * kSlot + split * DP * kPitch + mf::blocked_o_col(DP, tid, 0);
#pragma unroll
        for (int i = 0; i < kTm; ++i) {
          const float a = alpha_s[mf::blocked_o_row(DP, tid, i)];
#pragma unroll
          for (int c = 0; c < 8; ++c) o[i][c] *= a;
        }
#pragma unroll 4
        for (int key = 0; key < DP; key += 4) {
          float4 pv[kTm];
#pragma unroll
          for (int i = 0; i < kTm; ++i)
            pv[i] = *reinterpret_cast<const float4*>(p_row + kRg * i * kPp + key);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 v0 = *reinterpret_cast<const float4*>(v_row + (key + e) * kPitch);
            const float4 v1 =
                *reinterpret_cast<const float4*>(v_row + (key + e) * kPitch + DP / 2);
#pragma unroll
            for (int i = 0; i < kTm; ++i) {
              const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
              o[i][0] = fmaf(pe, v0.x, o[i][0]);
              o[i][1] = fmaf(pe, v0.y, o[i][1]);
              o[i][2] = fmaf(pe, v0.z, o[i][2]);
              o[i][3] = fmaf(pe, v0.w, o[i][3]);
              o[i][4] = fmaf(pe, v1.x, o[i][4]);
              o[i][5] = fmaf(pe, v1.y, o[i][5]);
              o[i][6] = fmaf(pe, v1.z, o[i][6]);
              o[i][7] = fmaf(pe, v1.w, o[i][7]);
            }
          }
        }
      }
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }

    // the item's end: l whole (alpha is the same in a row's 16 lanes), the
    // runs' sums through shared memory, divided once, stored
#pragma unroll
    for (int i = 0; i < kTm; ++i) {
      float t = l[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane % 16 == 0) l_s[mf::blocked_s_row(warp, lane, i)] = t;
    }
    __syncthreads();  // every run's reads of p are done
    {
      float* const sums = p_s + split * kRows * kPitch;
#pragma unroll
      for (int i = 0; i < kTm; ++i) {
        float* const at =
            sums + mf::blocked_o_row(DP, tid, i) * kPitch + mf::blocked_o_col(DP, tid, 0);
        *reinterpret_cast<float4*>(at) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
        *reinterpret_cast<float4*>(at + DP / 2) = make_float4(o[i][4], o[i][5], o[i][6], o[i][7]);
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
      }
    }
    __syncthreads();
    float* const dst = out + item / blocks / H * ob + item / blocks % H * oh;
#pragma unroll
    for (int n = 0; n < mf::blocked_store_steps(DP); ++n) {
      const int r = mf::blocked_store_row(DP, tid, n), c = mf::blocked_store_col(DP, tid, n);
      if (row0 + r >= S || c >= d) continue;
      float4 acc = *reinterpret_cast<const float4*>(p_s + r * kPitch + c);
#pragma unroll
      for (int sp = 1; sp < mf::blocked_splits(DP); ++sp) {
        const float4 part = *reinterpret_cast<const float4*>(p_s + (sp * kRows + r) * kPitch + c);
        acc = make_float4(acc.x + part.x, acc.y + part.y, acc.z + part.z, acc.w + part.w);
      }
      const float lr = l_s[r];
      acc = make_float4(acc.x / lr, acc.y / lr, acc.z / lr, acc.w / lr);
      float* const at = dst + (row0 + r) * os + c;
      if (vec_out) {
        *reinterpret_cast<float4*>(at) = acc;
      } else {
        at[0] = acc.x;
        at[1] = acc.y;
        at[2] = acc.z;
        at[3] = acc.w;
      }
    }
  }
  cp_async_wait<0>();
}

template <int DP>
int launch_blocked_f32_instance(const TmaCall& c, int d, const mf::BlockedPlan& p, int vec_out) {
  const auto kernel = blocked_f32_kernel<DP>;
  if (const cudaError_t err = allow_smem<blocked_f32_kernel<DP>>(p.bytes))
    return static_cast<int>(err);
  const long long items = static_cast<long long>(c.B) * c.H * p.blocks;
  kernel<<<persistent_ctas(items, p.per_sm), mf::kBkThreads, p.bytes, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<float*>(c.out), c.B, c.H, c.S, d, c.sb, c.sh,
      c.ss, c.ob, c.oh, c.os, c.scale, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// the instance of blocked_f32_plan(S, d), or cudaErrorInvalidValue
int launch_blocked_f32(const TmaCall& c, int d) {
  const mf::BlockedPlan p = mf::blocked_f32_plan(c.S, d);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (p.bytes == 0 || c.B < 1 || c.H < 1 || !aligned(c.q) || !aligned(c.k) || !aligned(c.v) ||
      c.sb % 4 || c.sh % 4 || c.ss % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_out = aligned(c.out) && c.ob % 4 == 0 && c.oh % 4 == 0 && c.os % 4 == 0;
  switch (p.dp) {
    case 32: return launch_blocked_f32_instance<32>(c, d, p, vec_out);
    case 64: return launch_blocked_f32_instance<64>(c, d, p, vec_out);
    case 128: return launch_blocked_f32_instance<128>(c, d, p, vec_out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- temporal

// f32 (the eval CLI's, the demo's and the trainer's dtype): temporal_f32_kernel,
// the plan and thread maps of f32_layout.cuh (see there). What bounds it:
// bytes (the 232 MB qkv in and 77 MB out at the flagship shape, 0.0925 ms at
// 3.35 TB/s, against 1.2 GFLOP), so every warp keeps its next item's copies
// in flight while it attends on rows already in shared memory. Frame t of
// item (clip g, token n, head h) is row q + (g T + t) s_frame + n s_token + h
// s_head (k and v alike), its output row out + (g T + t) o_frame + n o_token
// + h o_head; vec_out: out and its strides 16-byte granular (float4 stores).
struct TemporalF32Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int G, T, N, H, d;
  long long s_frame, s_token, s_head, o_frame, o_token, o_head;
  float scale;
  int vec_out;
};

template <int DP, int TP>
__global__ void __launch_bounds__(mf::kTpMaxWarps * 32) temporal_f32_kernel(
    const TemporalF32Args a) {
  constexpr int kPitch = mf::temporal_pitch(DP), kOp = mf::temporal_op_floats(TP, DP);
  constexpr int kPp = mf::temporal_p_pitch(TP), kChunks = DP / 4;
  constexpr int kCopies = TP * kChunks / 32;  // 16-byte copies of a lane, an operand
  constexpr int kSr = TP / 8, kSk = TP / 4;   // a lane's score rows and keys
  constexpr int kOr = mf::temporal_o_rows(TP, DP), kPass = kOr < 8 ? kOr : 8;
  static_assert(TP <= DP, "p fits the q rows it overwrites");
  extern __shared__ __align__(16) float tf_s[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* const stages = tf_s + warp * 2 * 3 * kOp;
  const long long items = static_cast<long long>(a.G) * a.N * a.H;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  // the first row of item it's (clip, token, head), in elements
  auto offset = [&](long long it, long long s_frame, long long s_token, long long s_head) {
    const long long nh = it % (static_cast<long long>(a.N) * a.H);
    return it / (static_cast<long long>(a.N) * a.H) * a.T * s_frame + nh / a.H * s_token +
           nh % a.H * s_head;
  };

  // item it's q, k, v rows into stage st (zeros past T and d)
  auto load = [&](long long it, int st) {
    const long long base = offset(it, a.s_frame, a.s_token, a.s_head);
    float* const dst = stages + st * 3 * kOp;
#pragma unroll
    for (int op = 0; op < 3; ++op) {
      const float* const src = (op == 0 ? a.q : op == 1 ? a.k : a.v) + base;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int idx = lane + 32 * i, t = idx / kChunks, c = idx % kChunks * 4;
        const bool ok = t < a.T && c < a.d;
        cp_async16(smem_u32(dst + op * kOp + t * kPitch + c), ok ? src + t * a.s_frame + c : src,
                   ok);
      }
    }
  };

  long long it = static_cast<long long>(blockIdx.x) * warps + warp;
  if (it < items) load(it, 0);
  cp_async_commit();
  for (int st = 0; it < items; it += stride, st ^= 1) {
    if (it + stride < items) load(it + stride, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this lane's copies of item it have landed ...
    __syncwarp();        // ... and the warp's
    float* const qs = stages + st * 3 * kOp;
    const float* const ks = qs + kOp;
    const float* const vs = qs + 2 * kOp;

    // the scores, a kSr x kSk tile a lane
    float s[kSr][kSk];
#pragma unroll
    for (int i = 0; i < kSr; ++i)
#pragma unroll
      for (int j = 0; j < kSk; ++j) s[i][j] = 0.f;
    const float* const q_row = qs + mf::temporal_s_row(lane, 0) * kPitch;
    const float* const k_row = ks + mf::temporal_s_key(lane, 0) * kPitch;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[kSr], kv[kSk];
#pragma unroll
      for (int i = 0; i < kSr; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_row + 8 * i * kPitch + c);
#pragma unroll
      for (int j = 0; j < kSk; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_row + 4 * j * kPitch + c);
#pragma unroll
      for (int i = 0; i < kSr; ++i)
#pragma unroll
        for (int j = 0; j < kSk; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    // the exact softmax: a row's keys lie in a quad of lanes; keys past T at -inf
#pragma unroll
    for (int i = 0; i < kSr; ++i) {
      float mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSk; ++j) {
        s[i][j] = mf::temporal_s_key(lane, j) < a.T ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = quad_max(mx);
#pragma unroll
      for (int j = 0; j < kSk; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      sum = quad_sum(sum);
#pragma unroll
      for (int j = 0; j < kSk; ++j) s[i][j] = s[i][j] / sum;
    }
    __syncwarp();  // every lane's reads of q are done: p takes its rows
#pragma unroll
    for (int i = 0; i < kSr; ++i)
#pragma unroll
      for (int j = 0; j < kSk; ++j)
        qs[mf::temporal_s_row(lane, i) * kPp + mf::temporal_s_key(lane, j)] = s[i][j];
    __syncwarp();

    // out = p v over the keys below T rounded up to 4 (p is 0 and v's rows
    // are zeros from T on), kPass rows of a lane's float4 columns at a time
    const int col = mf::temporal_o_col(DP, lane), keys4 = (a.T + 3) & ~3;
    const float* const v_col = vs + col;
    float* const out0 = a.out + offset(it, a.o_frame, a.o_token, a.o_head) + col;
#pragma unroll
    for (int r0 = 0; r0 < kOr; r0 += kPass) {
      float4 o[kPass];
#pragma unroll
      for (int i = 0; i < kPass; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int key = 0; key < keys4; key += 4) {
        float4 vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = *reinterpret_cast<const float4*>(v_col + (key + e) * kPitch);
#pragma unroll
        for (int i = 0; i < kPass; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(
              qs + mf::temporal_o_row(DP, lane, r0 + i) * kPp + key);
          const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[i].x = fmaf(pe[e], vv[e].x, o[i].x);
            o[i].y = fmaf(pe[e], vv[e].y, o[i].y);
            o[i].z = fmaf(pe[e], vv[e].z, o[i].z);
            o[i].w = fmaf(pe[e], vv[e].w, o[i].w);
          }
        }
      }
      if (col < a.d) {
#pragma unroll
        for (int i = 0; i < kPass; ++i) {
          const int t = mf::temporal_o_row(DP, lane, r0 + i);
          if (t >= a.T) continue;
          float* const at = out0 + t * a.o_frame;
          if (a.vec_out) {
            *reinterpret_cast<float4*>(at) = o[i];
          } else {
            at[0] = o[i].x;
            at[1] = o[i].y;
            at[2] = o[i].z;
            at[3] = o[i].w;
          }
        }
      }
    }
    __syncwarp();  // the stage is free for the load two items on
  }
  cp_async_wait<0>();
}

template <int DP, int TP>
int launch_temporal_f32_instance(const TemporalF32Args& a, const mf::TemporalPlan& p,
                                 cudaStream_t stream) {
  const auto kernel = temporal_f32_kernel<DP, TP>;
  if (const cudaError_t err = allow_smem<temporal_f32_kernel<DP, TP>>(p.bytes))
    return static_cast<int>(err);
  const long long items = static_cast<long long>(a.G) * a.N * a.H;
  kernel<<<persistent_ctas((items + p.warps - 1) / p.warps, p.per_sm), p.warps * 32, p.bytes,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_temporal_f32_dp(const TemporalF32Args& a, const mf::TemporalPlan& p,
                           cudaStream_t stream) {
  switch (p.tp) {
    case 8: return launch_temporal_f32_instance<DP, 8>(a, p, stream);
    case 16: return launch_temporal_f32_instance<DP, 16>(a, p, stream);
    case 32: return launch_temporal_f32_instance<DP, 32>(a, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the instance of temporal_f32_plan(T, d), or cudaErrorInvalidValue
int launch_temporal_f32(TemporalF32Args a, cudaStream_t stream) {
  const mf::TemporalPlan p = mf::temporal_f32_plan(a.T, a.d);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (p.bytes == 0 || a.G < 1 || a.N < 1 || a.H < 1 || !aligned(a.q) || !aligned(a.k) ||
      !aligned(a.v) || a.s_frame % 4 || a.s_token % 4 || a.s_head % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec_out = aligned(a.out) && a.o_frame % 4 == 0 && a.o_token % 4 == 0 && a.o_head % 4 == 0;
  switch (p.dp) {
    case 32: return launch_temporal_f32_dp<32>(a, p, stream);
    case 64: return launch_temporal_f32_dp<64>(a, p, stream);
    case 128: return launch_temporal_f32_dp<128>(a, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16: a work item is (clip g, token n, a group of hg <= kTmHeads heads);
// warp w of the CTA takes head h0 + w on the tensor cores. DP is d rounded up
// to 16, 32, 64 or 128 and TP is T rounded up to 16 or 32: the padding is
// zeros in shared memory.
constexpr int kTmHeads = 4;

struct TemporalArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  int G, T, N, H, d, hg;
  long long s_frame, s_token, s_head, o_frame, o_token, o_head;
  float scale;
};

template <int DP, int TP>
struct TemporalTile {
  static constexpr int kPitch = DP + 8;       // a row and 16 bytes: 8 rows hit 8 bank groups
  static constexpr int kHead = TP * kPitch;   // one head's q (or k, or v) in a stage
  static constexpr int kMaxBytes = 2 * 3 * kTmHeads * kHead * 2;  // two stages of 4 heads
};

// one warp: softmax(q k^T * scale) v of one head's TP x DP tiles in shared
// memory (q rows of a 16-row tile, once its scores are formed, stage that
// tile's bf16 output), written to out0 + t * o_frame, t < T
template <int DP, int TP>
__device__ __forceinline__ void temporal_head(bf16* qs, const bf16* ks, const bf16* vs,
                                              bf16* out0, const TemporalArgs& a, int lane) {
  constexpr int kPitch = TemporalTile<DP, TP>::kPitch;
  const int g4 = lane / 4, t4 = lane % 4;
  const int keys = a.T;
  for (int m0 = 0; m0 < a.T; m0 += 16) {
    // S = q k^T: one m16 tile against TP / 8 key tiles, DP / 16 steps
    float s[TP / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_u32(qs + (m0 + lane % 16) * kPitch + kk + lane / 16 * 8));
#pragma unroll
      for (int n0 = 0; n0 < TP; n0 += 16) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(ks + (n0 + lane % 8 + lane / 16 * 8) * kPitch + kk +
                                 lane / 8 % 2 * 8));
        mma_bf16(s[n0 / 8], qa, kb[0], kb[1]);
        mma_bf16(s[n0 / 8 + 1], qa, kb[2], kb[3]);
      }
    }
    // the softmax in the accumulators: a quad of lanes holds rows g4 and g4 + 8
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = j * 8 + 2 * t4 + e % 2 < keys ? s[j][e] * a.scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < TP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e / 2]);
        sum[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    // p rounded to bf16, in registers as the A operand of p v
    uint32_t p[TP / 16][4];
#pragma unroll
    for (int j = 0; j < TP / 16; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // rows g4 (r even) and g4 + 8 of keys 16j .., 16j + 8 ..
        p[j][r] = pack_bf16(s[2 * j + r / 2][2 * (r % 2)] / sum[r % 2],
                            s[2 * j + r / 2][2 * (r % 2) + 1] / sum[r % 2]);
      }
    }
    // O = p v: v through ldmatrix.trans, DP / 8 column tiles
    float o[DP / 8][4] = {};
#pragma unroll
    for (int j = 0; j < TP / 16; ++j) {
#pragma unroll
      for (int c0 = 0; c0 < DP; c0 += 16) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vs + (16 * j + lane % 8 + lane / 8 % 2 * 8) * kPitch +
                                       c0 + lane / 16 * 8));
        mma_bf16(o[c0 / 8], p[j], vb[0], vb[1]);
        mma_bf16(o[c0 / 8 + 1], p[j], vb[2], vb[3]);
      }
    }
    // the output rounded once, staged in this tile's q rows, stored in 16 bytes
    __syncwarp();
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<uint32_t*>(qs + (m0 + g4 + 8 * r) * kPitch + 8 * c + 2 * t4) =
            pack_bf16(o[c][2 * r], o[c][2 * r + 1]);
      }
    }
    __syncwarp();
    const int chunks = a.d / 8;
    for (int i = lane; i < 16 * chunks; i += 32) {
      const int t = m0 + i / chunks, c = i % chunks * 8;
      if (t < a.T) {
        *reinterpret_cast<uint4*>(out0 + t * a.o_frame + c) =
            *reinterpret_cast<const uint4*>(qs + t * kPitch + c);
      }
    }
  }
}

// Persistent CTAs of hg warps walk over the work items; each loads item i + 1
// (cp.async, 16 bytes a thread, zeros past T, d and H) into one of two
// stages while its warps attend on item i from the other.
template <int DP, int TP>
__global__ void __launch_bounds__(kTmHeads * 32) temporal_attention_mma_kernel(
    const TemporalArgs a) {
  using Tile = TemporalTile<DP, TP>;
  constexpr int kChunks = DP / 8;
  extern __shared__ __align__(16) bf16 tm_s[];
  const int hg = a.hg, groups = (a.H + hg - 1) / hg, warp = threadIdx.x / 32;
  const int stage = 3 * hg * Tile::kHead;  // elements: q, k, v of hg heads
  const long long items = static_cast<long long>(a.G) * a.N * groups;

  // rows (operand, head j, frame t) of item `it` into stage `st`
  auto load = [&](long long it, int st) {
    const int h0 = it % groups * hg, n = it / groups % a.N;
    const long long g = it / groups / a.N;
    const long long base = g * a.T * a.s_frame + n * a.s_token + h0 * a.s_head;
    const uint32_t dst = smem_u32(tm_s + st * stage);
    const int per_op = hg * TP * kChunks;
    for (int i = threadIdx.x; i < 3 * per_op; i += blockDim.x) {
      const int op = i / per_op, r = i - op * per_op;
      const int j = r / (TP * kChunks), t = r / kChunks % TP, c = r % kChunks * 8;
      const bool ok = t < a.T && c < a.d && h0 + j < a.H;
      const bf16* src = op == 0 ? a.q : op == 1 ? a.k : a.v;
      cp_async16(dst + ((op * hg + j) * Tile::kHead + t * Tile::kPitch + c) * 2,
                 ok ? src + base + t * a.s_frame + j * a.s_head + c : src, ok);
    }
  };

  long long it = blockIdx.x;
  if (it < items) load(it, 0);
  cp_async_commit();
  for (int st = 0; it < items; it += gridDim.x, st ^= 1) {
    if (it + gridDim.x < items) load(it + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of item it have landed ...
    __syncthreads();     // ... and everyone's
    const int h = it % groups * hg + warp, n = it / groups % a.N;
    const long long g = it / groups / a.N;
    if (h < a.H) {
      bf16* qs = tm_s + st * stage + warp * Tile::kHead;
      temporal_head<DP, TP>(qs, qs + hg * Tile::kHead, qs + 2 * hg * Tile::kHead,
                            a.out + g * a.T * a.o_frame + n * a.o_token + h * a.o_head, a,
                            threadIdx.x % 32);
    }
    __syncthreads();  // the stage is free for item it + 2 * gridDim.x
  }
  cp_async_wait<0>();
}

template <int DP, int TP>
int launch_temporal_mma(const TemporalArgs& a, cudaStream_t stream) {
  const auto kernel = temporal_attention_mma_kernel<DP, TP>;
  using Tile = TemporalTile<DP, TP>;
  if (const cudaError_t err = allow_smem<temporal_attention_mma_kernel<DP, TP>>(Tile::kMaxBytes))
    return static_cast<int>(err);
  const int threads = a.hg * 32, smem = 2 * 3 * a.hg * Tile::kHead * 2;
  // resident CTAs an SM at each head group, asked once per device
  constexpr int kDevices = 64;
  static int per_sm[kDevices][kTmHeads + 1] = {};
  int device = 0;
  if (const cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
  if (device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int& resident = per_sm[device][a.hg];
  if (resident == 0) {
    if (const cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem))
      return static_cast<int>(err);
    if (resident == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long items =
      static_cast<long long>(a.G) * a.N * ((a.H + a.hg - 1) / a.hg);
  kernel<<<persistent_ctas(items, resident), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_temporal_bf16(TemporalArgs a, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (a.G < 1 || a.N < 1 || a.H < 1 || a.T < 1 || a.T > 32 || a.d < 8 || a.d > 128 ||
      a.d % 8 || !aligned(a.q) || !aligned(a.k) || !aligned(a.v) || !aligned(a.out) ||
      a.s_frame % 8 || a.s_token % 8 || a.s_head % 8 || a.o_frame % 8 || a.o_token % 8 ||
      a.o_head % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  // 4 heads a work item, fewer where that leaves fewer than two items an SM
  // (st_mode temporal: one token a frame)
  const int sms = persistent_ctas(1ll << 40);
  a.hg = a.H < kTmHeads ? a.H : kTmHeads;
  while (a.hg > 1 && static_cast<long long>(a.G) * a.N * ((a.H + a.hg - 1) / a.hg) < 2ll * sms)
    a.hg = (a.hg + 1) / 2;
  const int dp = a.d <= 16 ? 16 : a.d <= 32 ? 32 : a.d <= 64 ? 64 : 128;
  return by_head_dim(dp, [&](auto dim) {
    constexpr int DP = decltype(dim)::value;
    return a.T <= 16 ? launch_temporal_mma<DP, 16>(a, stream)
                     : launch_temporal_mma<DP, 32>(a, stream);
  });
}

// What the TMA kernels ask beyond the wrappers' checks: q, k, v 16-byte aligned
// with strides of whole 16 bytes (a tensor map's), an output of 4-byte pairs.
bool tma_operands(const void* q, const void* k, const void* v, const void* out, long long sb,
                  long long sh, long long ss, long long ob, long long oh, long long os) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return aligned(q, 16) && aligned(k, 16) && aligned(v, 16) && sb % 8 == 0 && sh % 8 == 0 &&
         ss % 8 == 0 && aligned(out, 4) && ob % 2 == 0 && oh % 2 == 0 && os % 2 == 0;
}

}  // namespace

// q, k, v, out in one dtype (bf16 if is_bf16, else f32), head dim contiguous,
// d a multiple of 8 and at most 128, S at most 1024; every row 16-byte aligned
// (pointers aligned, strides multiples of 8 elements). Strides in elements.
// bf16 has one path, the TMA + wgmma kernel: d of 16, 32, 64 or 128 and an
// output of 4-byte aligned pairs (even strides), else cudaErrorInvalidValue;
// a tensor map that cuTensorMapEncodeTiled refuses is kTensorMapError (10000)
// + its CUresult.
extern "C" int maed_spatial_attention(int is_bf16, const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int S, int d, long long sb,
                                      long long sh, long long ss, long long ob, long long oh,
                                      long long os, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const TmaCall call{q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, scale, s};
  if (!is_bf16) return launch_spatial_f32(call, d);
  if (S < 1 || S > 4 * kSpChunk || !tma_operands(q, k, v, out, sb, sh, ss, ob, oh, os))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(d, [&](auto dim) { return launch_spatial_tma<decltype(dim)::value>(call); });
}

// As maed_spatial_attention, for any S: the online-softmax kernels (one pass
// over the keys), which round an unnormalised p where the spatial kernels
// round a normalised one.
extern "C" int maed_blocked_attention(int is_bf16, const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int S, int d, long long sb,
                                      long long sh, long long ss, long long ob, long long oh,
                                      long long os, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const TmaCall call{q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, scale, s};
  if (!is_bf16) return launch_blocked_f32(call, d);
  if (S < 1 || !tma_operands(q, k, v, out, sb, sh, ss, ob, oh, os))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch_tma<blocked_attention_tma_kernel<D>, D>(call, BlockedLayout<D>::kBytes, kBkTile);
  });
}

// As above for G clips of T frames (T at most 32) of N tokens of H heads.
// bf16: temporal_attention_mma_kernel, which also asks 16-byte aligned output
// rows (pointer and strides), else cudaErrorInvalidValue; f32:
// temporal_f32_kernel.
extern "C" int maed_temporal_attention(int is_bf16, const void* q, const void* k, const void* v,
                                       void* out, int G, int T, int N, int H, int d,
                                       long long s_frame, long long s_token, long long s_head,
                                       long long o_frame, long long o_token, long long o_head,
                                       float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const TemporalArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(out), G, T, N, H, d, 0,
                         s_frame, s_token, s_head, o_frame, o_token, o_head, scale};
    return launch_temporal_bf16(a, s);
  }
  const TemporalF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<float*>(out), G, T, N, H, d,
                          s_frame, s_token, s_head, o_frame, o_token, o_head, scale, 0};
  return launch_temporal_f32(a, s);
}
