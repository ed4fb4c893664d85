// Attention at any head dim the JAX models form: softmax(q k^T * scale) v per
// head for d a multiple of 8 from 8 to 768, f32 or bf16, where the kernels of
// st_attention.cu take a narrower set (f32 up to 128; bf16 spatial and
// blocked 16, 32, 64 or 128; bf16 temporal up to 128). 768 is the widest head
// the JAX encoder forms (embed 768, one head); the tools' small
// configuration runs 2 heads of 384, the stock ViTs 96 and 80.
//
// Replaces, for those head dims, the same Pallas kernels as st_attention.cu:
//   maed_tpu/ops/st_attention.py::_spatial_kernel (pallas_call in
//     `_spatial_pallas`) and maed_tpu/ops/attention.py::_attn_oneshot_kernel
//     (pallas_call in `_attention_oneshot`): the exact softmax;
//   maed_tpu/ops/st_attention.py::_temporal_kernel and `_temporal_v2_kernel`
//     (pallas_calls in `_temporal_pallas`, `_temporal_v2_pallas`): the exact
//     softmax over the T frames of a (clip, token, head);
//   maed_tpu/ops/attention.py::_attn_blocked_kernel (pallas_call in
//     `_attention_blocked`): the online softmax.
// One entry point, maed_general_attention, serves the three: a head's rows
// are addressed as row r of batch item (i0, i1, i2) at i0 * s0 + i1 * s1 +
// i2 * s2 + r * srow (the output likewise), so spatial is (B, H, 1) over
// the S tokens of a frame and temporal (G, N, H) over the T frames of a clip.
// Rounding points as the plain versions (ops/st_attention.py::_attend,
// ops/attention.py::attention_blocked_reference): f32 scores, the exact
// softmax rounds the normalised p to v's dtype, the online one the
// unnormalised p while its sum takes the unrounded p; f32 accumulation, the
// output rounded once.
//
// What bounds each form on the H100 (at the flagship's tokens, 128 frames x
// 197 tokens, 768 channels in 768 / d heads): spatial and temporal are bound
// by bytes in bf16 (the 116 MB qkv read, 39 MB written: 0.046 ms at 3.35
// TB/s; their products 15.3 and 1.2 GFLOP) and spatial by operations in f32
// (15.3 GFLOP at 67 TFLOP/s, 0.23 ms); the blocked form (8 clips x 3152
// tokens) by operations in both (2.4e11 FLOP: 0.25 ms on the bf16 tensor
// cores, 3.6 ms on the f32 CUDA cores). So no score is formed twice where it
// can be avoided, K and V cross device memory once per query tile, shared by
// the tile's rows, and every load is in flight while earlier data is
// multiplied. The wrapper's plan (ops/st_attention.py::general_plan) picks
// one of three forms and passes it here; the launcher takes its shared
// memory from general_layout.cuh, the one layout its kernels follow:
//
// frames (the exact softmax at S <= 32: temporal, and spatial at 64 px): a
//   warp an item, T rows padded to TP = 16 or 32, four warps a CTA, each
//   streaming its item's column blocks (64 head-dim columns) of q and k, then
//   of v, through its own ring of three cp.async stages, the next item's
//   first blocks loaded while the current one's last are multiplied. The
//   scores accumulate over the column blocks (formed once), the softmax runs
//   in registers, and each column block of the output is p v_c, stored when
//   done. bf16 on mma.sync m16n8k16 (p from the accumulators), not wgmma: an
//   item has 16 rows, and wgmma's 64-row tiles would stack four items into a
//   block-diagonal product, 4x the operations for a form the bytes bound.
//   f32 on the CUDA cores: a lane forms a 2 x 4 (TP 32: 4 x 8) tile of
//   scores from float4 reads, p goes through shared memory transposed, and a
//   lane accumulates two output columns of every row. Shared memory: bf16
//   55 KB (TP 16) or 108 KB a CTA; f32 106 KB or 220 KB; at any d.
//
// rows (the exact softmax at 32 < S <= 256: spatial). bf16: TMA + wgmma,
//   warp-specialised and persistent (hopper.cuh): a work item is 128 query
//   rows of one (frame, head), a consumer warpgroup 64 of them. The producer
//   streams, per 64-column block of the head dim, q's block and k's block
//   (the score width's keys, W = 64, 128, 192, 200 or 256 from S, zero-filled
//   past S and past d by TMA) into a ring of four 48 KB stages, then v's
//   blocks. A consumer accumulates its whole row of scores in registers over
//   the blocks (m64n64 strips, and an m64n8 strip at W 200; each stage
//   released once its products are done, the next block's already issued),
//   takes the exact softmax there once, keeps the normalised p rounded to
//   bf16 in registers as the A operand, and forms each 64-column block of the
//   output as m64n64k16 products against v's block, two blocks' accumulators
//   in turn so that one is stored while the next is formed: d costs no extra
//   score formation. 193 KB of shared memory at any d. f32: a CTA of 256
//   threads takes a block of up to 64 query rows (the S rows spread evenly
//   over ceil(S / 64) blocks: 197 as four of 50, since a CTA lasts as long as
//   its busiest warp); q's and k's 32-column blocks pass through two cp.async
//   stages, each thread forming a 4 x 4 tile of scores (rows 4ty .., keys tx
//   + 16g) for all W keys (64, 128, 192, 208 or 256: 208 at 197 tokens) at
//   once; the score rows stay in shared memory (64 x W floats), are softmaxed
//   there by a warp a row, and the output is formed 192 columns at a time, a
//   4 x 12 tile a thread, from float4 reads of p and of v's double-buffered
//   64-key tiles. 151 KB at W 208, 163 KB at 256.
//
// tiled (the online softmax, any S; the exact softmax at S > 256 in two
//   passes, the first for each row's max and sum, the second for p v: the
//   scores formed twice there, on no model path), 128-key tiles in bf16.
//   What bounds it in practice is the bytes that enter shared memory: a
//   128-key tile of k and v is 64 FLOP a byte for 64 query rows, which the
//   SMs' share of L2 cannot feed at the tensor cores' rate; the query rows a
//   CTA serves set the reuse. bf16 up to d 128 (narrow): a work item is 128
//   query rows of one (batch, head), consumer w owns rows 64w .. 64w + 63
//   and the whole output (at most two 64-column blocks, 64 registers a
//   thread), so the two share the stages and nothing else: q's blocks stay
//   for the item, the producer streams k's column blocks of each tile and
//   v's of the tile before as 16 KB stages, and a consumer issues its
//   scores s_j (m64n128k16) with o += p_{j-1} v_{j-1} (p from the
//   accumulators as wgmma's register A operand), waits for s_j alone and
//   takes tile j's running max and sum while the p v product runs; the
//   consumers take turns to issue (named barriers), as K's kernel does,
//   so that one's softmax runs while the other's products do. The last
//   column block's k-steps and output width follow d (96: 2 steps, 32
//   columns). 161 KB of shared memory.
//   bf16 above d 128 (wide): a work item is 64 query rows and, where the
//   output would not fit the registers (d > 384), a part of its columns: the
//   scores are then formed ceil(d / 384) times. q's column blocks stay for
//   the item; the producer streams k's column blocks of each tile, then v's
//   (the part's). Consumer w forms the scores of keys 64w .. 64w + 63 of the
//   tile (m64n64k16 over the column blocks); the two exchange each row's
//   tile max through shared memory (named barrier 1), take the same running
//   max, and exchange their p (rounded to bf16 in the accumulator layout,
//   which is wgmma's register A layout; barrier 2), so each holds p for all
//   128 keys and forms its own column blocks of the output (up to 3, 96
//   registers a thread): the scores of a key tile are formed once a CTA.
//   Every stage is released as soon as the products reading it are done, so
//   the producer stays a tile ahead (holding v's stages to overlap p v with
//   the next softmax starved it: measured slower). Shared memory: q's blocks
//   (48 KB at d 384, 96 at 768), 32 KB of p (by tile parity), 2 KB of row
//   statistics and 8 (at 768: 5) stages: 211 KB at d 384 and 768. f32: 64 query rows (spread as above) and up
//   to 384 output columns (six 64-column blocks) a CTA of 256 threads,
//   64-key tiles; with one part (d <= 384) q's rows stay in shared memory
//   for the item and k's 64-column blocks pass through two stages, a slice
//   of v's tile with each (beyond 384, q's blocks come with k's); a 4 x 4
//   tile of scores a thread, the running max across the 16 threads of a row
//   group, p through the stages' memory, a 4 x 24 tile of output a thread.
//   226 KB at d 384, 164 KB at 768.
//
// f32 runs on the CUDA cores throughout (no TF32: the port holds f32 to 1e-5
// against its plain version). Every form is held against its plain version
// at its tolerance by tests/test_torch_port_cuda.py and chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "general_layout.cuh"  // the forms' shared memory (also read by a host compiler)
#include "hopper.cuh"  // TMA, mbarriers, setmaxnreg, wgmma, mma.sync, cp.async

using namespace maed_general;

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

struct GeneralArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int n0, n1, n2, S, d;
  long long s0, s1, s2, srow;  // q, k, v (elements)
  long long o0, o1, o2, orow;  // out
  float scale;
};

// offsets of batch item b (flat over (i0, i1, i2), i2 fastest) in q, k, v and out
__device__ __forceinline__ void item_offsets(const GeneralArgs& a, long long b, long long& in,
                                             long long& out) {
  const long long i2 = b % a.n2, i1 = b / a.n2 % a.n1, i0 = b / a.n2 / a.n1;
  in = i0 * a.s0 + i1 * a.s1 + i2 * a.s2;
  out = i0 * a.o0 + i1 * a.o1 + i2 * a.o2;
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// across the 16 lanes of a half warp (the f32 CTA kernels' row groups)
__device__ __forceinline__ float half_max(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void store_pair(bf16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// ------------------------------------------------------- TMA + wgmma (bf16)

// one 64 x 64 box of the (d, S, n1, n0) tensor map at (c0, row, i1, i0)
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0,
                                        int row, int i1, int i0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(row), "r"(i1), "r"(i0), "r"(bar)
      : "memory");
}

// wgmma descriptors of a column-block tile (rows of 128 bytes under the
// 128-byte swizzle, 8-row groups 1 KB apart): K-major (q or k, the head dim
// along K) from row `row0`, k-step kk (16 columns); MN-major (v, keys along
// K, the head dim along N) from key `key0`, N = 64.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return smem_desc(tile + row0 * kCbBytes + kk * 32, 16, 8 * kCbBytes, 1);
}
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int key0) {
  return smem_desc(tile + key0 * kCbBytes, kBoxBytes, 8 * kCbBytes, 1);
}

// This thread's consumer warpgroup (0 or 1), through a shuffle so that ptxas
// sees it uniform in the warp: a branch on it around wgmma then needs no
// serialising warpgroup barrier.
__device__ __forceinline__ int consumer_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0) - 1;
}

__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty, int n) {
  for (int i = 0; i < n; ++i) {
    mbar_init(full + 8 * i, 1);
    mbar_init(empty + 8 * i, 128 * kConsumers);
  }
}

// ----------------------------------------------------- rows, bf16 (S <= 256)

// s (+)= q_c k_c^T over the column block's 4 k-steps for the consumer's 64
// rows against the first W keys: m64n64 strips and, at W = 64k + 8, one m64n8
// strip. Thread t of warp w holds the score of key 8g + 2(t%4) + e%2 of its
// rows at s[4g + e]. acc 0: the first block overwrites.
template <int W>
__device__ __forceinline__ void rows_scores(float (&s)[W / 2], uint32_t qt, int wg, uint32_t kt,
                                            int acc) {
  constexpr int kStrips = W / 64, kTail = W % 64;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int on = acc | (kk != 0);
#pragma unroll
    for (int strip = 0; strip < kStrips; ++strip)
      Wgmma<64>::ss(s + 32 * strip, desc_k(qt, 64 * wg, kk), desc_k(kt, 64 * strip, kk), on);
    if constexpr (kTail != 0)
      Wgmma<kTail>::ss(s + 32 * kStrips, desc_k(qt, 64 * wg, kk), desc_k(kt, 64 * kStrips, kk),
                       on);
  }
}

// The exact softmax of the thread's two rows over keys below S (in units of
// log 2), p normalised and rounded to bf16 as the A operand of p v: k-step i
// is the accumulator's 8-key groups 2i and 2i + 1 (zeros past W).
template <int W>
__device__ __forceinline__ void rows_softmax(float (&s)[W / 2], uint32_t (&p)[(W / 8 + 1) / 2][4],
                                             int S, float scale2) {
  constexpr int kGroups = W / 8;
  const int t = threadIdx.x % 4;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * g + e];
      x = 8 * g + 2 * t + (e & 1) < S ? x * scale2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  mx[0] = quad_max(mx[0]);  // finite: key 0 lies below S
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    s[i] = fast_exp2(s[i] - mx[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
  for (int ks = 0; ks < (kGroups + 1) / 2; ++ks)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = 2 * ks + i;
      const float* f = &s[4 * (g < kGroups ? g : 0)];
      p[ks][2 * i] = g < kGroups ? pack_bf16(f[0] * inv[0], f[1] * inv[0]) : 0u;
      p[ks][2 * i + 1] = g < kGroups ? pack_bf16(f[2] * inv[1], f[3] * inv[1]) : 0u;
    }
}

// The thread's two rows of a warpgroup's 64 x N output block (rows row0 +
// 16w + t/4 and + 8 below S, columns c0 + 8j + 2(t%4) below d), times mul.
template <int N = 64>
__device__ __forceinline__ void store_block(bf16* out, long long orow, const float* o, int row0,
                                            int S, int c0, int d, const float (&mul)[2]) {
  const int lane = threadIdx.x % 32, row = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= S) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane % 4);
      if (col < d)  // d is a multiple of 8: a pair lies inside or outside
        store_pair(out + (row + 8 * r) * orow + col, o[4 * j + 2 * r] * mul[r],
                   o[4 * j + 2 * r + 1] * mul[r]);
    }
  }
}

// Work item (i0, i1, block of 128 query rows), the block fastest; n2 is 1.
template <int W>
__global__ void __launch_bounds__(kCtaThreads, 1) general_rows_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const GeneralArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = smem_u32(align_smem(smem_raw));
  const uint32_t full = smem + kRowsBars, empty = full + 8 * kRowsStages;
  if (threadIdx.x == 0) {
    init_ring(full, empty, kRowsStages);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  constexpr int kKeyBoxes = (W + kBoxRows - 1) / kBoxRows;
  const int ncb = (a.d + kCb - 1) / kCb, blocks = (a.S + kRowsBlock - 1) / kRowsBlock;
  const long long items = static_cast<long long>(a.n0) * a.n1 * blocks;

  if (threadIdx.x < 128) {  // the producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring r;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int pair = static_cast<int>(item / blocks), i0 = pair / a.n1, i1 = pair % a.n1;
        const int row0 = static_cast<int>(item % blocks) * kRowsBlock;
        const int qboxes = (min(a.S - row0, kRowsBlock) + kBoxRows - 1) / kBoxRows;
        for (int pass = 0; pass < 2; ++pass)  // q's and k's blocks, then v's
          for (int cb = 0; cb < ncb; ++cb) {
            mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
            const uint32_t bar = full + 8 * r.slot, st = smem + r.slot * kRowsStage;
            mbar_expect_tx(bar, ((pass == 0 ? qboxes : 0) + kKeyBoxes) * kBoxBytes);
            if (pass == 0)
              for (int b = 0; b < qboxes; ++b)
                tma_box(st + b * kBoxBytes, q_map, bar, cb * kCb, row0 + b * kBoxRows, i1, i0);
            for (int b = 0; b < kKeyBoxes; ++b)  // whole boxes: past S they arrive as zeros
              tma_box(st + kRowsQ + b * kBoxBytes, pass == 0 ? k_map : v_map, bar, cb * kCb,
                      b * kBoxRows, i1, i0);
            r.next(kRowsStages);
          }
      }
    }
  } else {  // the consumers
    regs_inc<kConsumerRegs>();
    const int wg = consumer_index();
    const float scale2 = a.scale * kLog2e;  // scores in units of log 2
    const float one[2] = {1.f, 1.f};
    bf16* const out = static_cast<bf16*>(a.out);
    Ring r;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int pair = static_cast<int>(item / blocks), i0 = pair / a.n1, i1 = pair % a.n1;
      const int row0 = static_cast<int>(item % blocks) * kRowsBlock;
      // the tile holds rows below S (else its q block was not loaded)
      if (64 * wg >= a.S - row0) {
        for (int n = 0; n < 2 * ncb; ++n) {  // its stages, released unread
          mbar_wait(full + 8 * r.slot, r.phase);
          mbar_arrive(empty + 8 * r.slot);
          r.next(kRowsStages);
        }
        continue;
      }
      // s = q k^T over the column blocks, each stage released once the
      // products reading it are done (the next block's already issued)
      float s[W / 2];
      uint32_t prev = 0;
      for (int cb = 0; cb < ncb; ++cb) {
        mbar_wait(full + 8 * r.slot, r.phase);
        const uint32_t st = smem + r.slot * kRowsStage;
        wgmma_fence();
        rows_scores<W>(s, st, wg, st + kRowsQ, cb != 0);
        wgmma_commit();
        if (cb > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty + 8 * prev);
        }
        prev = r.slot;
        r.next(kRowsStages);
      }
      wgmma_wait<0>();
      fence_regs<W / 2>(s);
      mbar_arrive(empty + 8 * prev);
      uint32_t p[(W / 8 + 1) / 2][4];
      rows_softmax<W>(s, p, a.S, scale2);
      bf16* const o_item = out + i0 * a.o0 + i1 * a.o1;
      for (int cb = 0; cb < ncb; ++cb) {  // o_c = p v_c, stored when done
        mbar_wait(full + 8 * r.slot, r.phase);
        const uint32_t vt = smem + r.slot * kRowsStage + kRowsQ;
        float o[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < (W / 8 + 1) / 2; ++ks)
          Wgmma<64>::rs(o, p[ks], desc_v(vt, 16 * ks), ks != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(o);
        mbar_arrive(empty + 8 * r.slot);
        r.next(kRowsStages);
        store_block(o_item, a.orow, o, row0 + 64 * wg, a.S, cb * kCb, a.d, one);
      }
    }
  }
}

// -------------------------------- tiled, bf16, d > 128 (online, two-pass)

// Work item (i0, i1, block of 64 query rows, part of the output columns), the
// part fastest; n2 is 1. Consumer w owns keys 64w .. 64w + 63 of every tile
// and column blocks cb0 + w * OB .. + OB - 1 of the output. online: the
// running max and sum over the tiles; else the exact softmax in two passes.
// The ring carries, per key tile, k's column blocks, then (in the second
// pass) v's of the part; each stage is released as soon as the products
// reading it are done, which keeps the producer a tile ahead.
template <int OB>
__global__ void __launch_bounds__(kCtaThreads, 1) general_tiled_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const GeneralArgs a, int online, int stages,
    int parts) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = align_smem(smem_raw);
  const uint32_t smem = smem_u32(base);
  const int ncb = (a.d + kCb - 1) / kCb;
  const TiledLayout L = tiled_layout(ncb, stages);
  const uint32_t q_full = smem + L.bars, q_empty = q_full + 8, full = q_full + 16,
                 empty = full + 8 * stages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * kConsumers);
    init_ring(full, empty, stages);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (a.S + kTlKeys - 1) / kTlKeys, blocks = (a.S + kTlRows - 1) / kTlRows;
  const long long items = static_cast<long long>(a.n0) * a.n1 * blocks * parts;
  const int first_pass = online ? 1 : 0;

  if (threadIdx.x < 128) {  // the producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring r;
      uint32_t q_phase = 0;
      // column block cb of k's (is_k) or v's tile j into the next stage
      auto stage = [&](bool is_k, int cb, int j, int i1, int i0) {
        mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
        const uint32_t bar = full + 8 * r.slot, st = smem + L.kv + r.slot * kTlStage;
        mbar_expect_tx(bar, kTlStage);
        for (int b = 0; b < kTlKeys / kBoxRows; ++b)  // whole boxes: past S they arrive as zeros
          tma_box(st + b * kBoxBytes, is_k ? k_map : v_map, bar, cb * kCb,
                  j * kTlKeys + b * kBoxRows, i1, i0);
        r.next(stages);
      };
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int part = static_cast<int>(item % parts);
        const long long rest = item / parts;
        const int row0 = static_cast<int>(rest % blocks) * kTlRows;
        const int pair = static_cast<int>(rest / blocks), i0 = pair / a.n1, i1 = pair % a.n1;
        const int cb0 = part * 2 * OB, cb1 = min(ncb, cb0 + 2 * OB);
        mbar_wait(q_empty, q_phase ^ 1);
        mbar_expect_tx(q_full, ncb * kBoxBytes);
        for (int cb = 0; cb < ncb; ++cb)
          tma_box(smem + L.q + cb * kBoxBytes, q_map, q_full, cb * kCb, row0, i1, i0);
        q_phase ^= 1;
        for (int pass = first_pass; pass < 2; ++pass)
          for (int j = 0; j < tiles; ++j) {
            for (int cb = 0; cb < ncb; ++cb) stage(true, cb, j, i1, i0);
            if (pass == 1)
              for (int cb = cb0; cb < cb1; ++cb) stage(false, cb, j, i1, i0);
          }
      }
    }
  } else {  // the consumers
    regs_inc<kConsumerRegs>();
    const int wg = consumer_index(), tid = threadIdx.x % 128, t = tid % 4;
    const int row = tid / 32 * 16 + tid % 32 / 4;  // the thread's rows: row and row + 8
    const float scale2 = a.scale * kLog2e;        // scores in units of log 2
    float* const row_max = reinterpret_cast<float*>(base + L.stats);
    float* const row_sum = row_max + 4 * kTlRows;
    uint32_t* const pex = reinterpret_cast<uint32_t*>(base + L.pex);  // [parity][consumer][16][128]
    bf16* const out = static_cast<bf16*>(a.out);
    Ring r;
    uint32_t q_phase = 0;
    float s[32];
    // s = q k_j^T over the column blocks, in units of log 2, keys at or past S
    // at -inf; each stage released once its products are done
    auto scores = [&](int j) {
      uint32_t prev = 0;
      for (int cb = 0; cb < ncb; ++cb) {
        mbar_wait(full + 8 * r.slot, r.phase);
        const uint32_t kt = smem + L.kv + r.slot * kTlStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<64>::ss(s, desc_k(smem + L.q + cb * kBoxBytes, 0, kk), desc_k(kt, 64 * wg, kk),
                        (cb != 0) | (kk != 0));
        wgmma_commit();
        if (cb > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty + 8 * prev);
        }
        prev = r.slot;
        r.next(stages);
      }
      wgmma_wait<0>();
      fence_regs<32>(s);
      mbar_arrive(empty + 8 * prev);
      const int k0 = j * kTlKeys + 64 * wg;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = k0 + 8 * (i >> 2) + 2 * t + (i & 1) < a.S ? s[i] * scale2 : -INFINITY;
    };
    // the running max over tile j (both consumers' keys) and s = 2^(s - max);
    // returns each row's rescale of what came before
    auto running = [&](int j, float (&m)[2], float (&l)[2], float (&alpha)[2]) {
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      // by tile parity: in the first pass of two, nothing else orders this
      // write after the other consumer's read of the last tile's
      float* const maxes = row_max + (j & 1) * 2 * kTlRows;
      if (t == 0) {
        maxes[wg * kTlRows + row] = mx[0];
        maxes[wg * kTlRows + row + 8] = mx[1];
      }
      bar_sync(1, 128 * kConsumers);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // finite: key j * 128 of the tile lies below S
        const float m_new = fmaxf(m[h], fmaxf(mx[h], maxes[(1 - wg) * kTlRows + row + 8 * h]));
        alpha[h] = fast_exp2(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
    };
    // each row's sum: the two consumers' shares (alpha is the same in both)
    auto total = [&](const float (&l)[2], float (&inv)[2]) {
      const float mine[2] = {quad_sum(l[0]), quad_sum(l[1])};
      if (t == 0) {
        row_sum[wg * kTlRows + row] = mine[0];
        row_sum[wg * kTlRows + row + 8] = mine[1];
      }
      bar_sync(1, 128 * kConsumers);
      inv[0] = 1.f / (mine[0] + row_sum[(1 - wg) * kTlRows + row]);
      inv[1] = 1.f / (mine[1] + row_sum[(1 - wg) * kTlRows + row + 8]);
      bar_sync(2, 128 * kConsumers);  // both have read row_sum before it is written again
    };
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int part = static_cast<int>(item % parts);
      const long long rest = item / parts;
      const int row0 = static_cast<int>(rest % blocks) * kTlRows;
      const int pair = static_cast<int>(rest / blocks), i0 = pair / a.n1, i1 = pair % a.n1;
      const int cb0 = part * 2 * OB, cb1 = min(ncb, cb0 + 2 * OB);
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {1.f, 1.f}, alpha[2];
      if (!online) {  // the first of two passes: each row's max and sum
        for (int j = 0; j < tiles; ++j) {
          scores(j);
          running(j, m, l, alpha);
        }
        total(l, inv_l);
      }
      float o[OB * 32];
#pragma unroll
      for (int i = 0; i < OB * 32; ++i) o[i] = 0.f;
      for (int j = 0; j < tiles; ++j) {
        scores(j);
        if (j == tiles - 1) mbar_arrive(q_empty);  // the item's last use of q
        if (online) {
          running(j, m, l, alpha);
#pragma unroll
          for (int i = 0; i < OB * 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]) * inv_l[(i >> 1) & 1];
        }
        // p (unnormalised online, normalised in the second pass) rounded to
        // bf16 as the A operand's k-steps: this consumer's keys its own, the
        // other's through shared memory, by tile parity (in the second of two
        // passes no other barrier orders this write after the other's read)
        uint32_t* const mine = pex + ((j & 1) * 2 + wg) * 16 * 128 + tid;
        const uint32_t* const theirs = pex + ((j & 1) * 2 + 1 - wg) * 16 * 128 + tid;
        uint32_t own[4][4], p[8][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            own[ks][e] = pack_bf16(s[8 * ks + 2 * e], s[8 * ks + 2 * e + 1]);
            mine[(4 * ks + e) * 128] = own[ks][e];
          }
        bar_sync(2, 128 * kConsumers);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // selects, not a run-time index: p stays in registers
            const uint32_t other = theirs[(4 * ks + e) * 128];
            p[ks][e] = wg == 0 ? own[ks][e] : other;
            p[4 + ks][e] = wg == 0 ? other : own[ks][e];
          }
        // o += p v on this consumer's column blocks, each stage released once
        // read; the other's blocks (before consumer 1's, after consumer 0's)
        // released unread
        const int mine0 = min(cb1, cb0 + wg * OB), mine1 = min(cb1, mine0 + OB);
        for (int c = cb0; c < mine0; ++c) {
          mbar_wait(full + 8 * r.slot, r.phase);
          mbar_arrive(empty + 8 * r.slot);
          r.next(stages);
        }
#pragma unroll
        for (int b = 0; b < OB; ++b) {
          if (mine0 + b >= mine1) break;
          mbar_wait(full + 8 * r.slot, r.phase);
          const uint32_t vt = smem + L.kv + r.slot * kTlStage;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) Wgmma<64>::rs(o + 32 * b, p[ks], desc_v(vt, 16 * ks), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<OB * 32>(o);
          mbar_arrive(empty + 8 * r.slot);
          r.next(stages);
        }
        for (int c = mine1; c < cb1; ++c) {
          mbar_wait(full + 8 * r.slot, r.phase);
          mbar_arrive(empty + 8 * r.slot);
          r.next(stages);
        }
      }
      if (online) total(l, inv_l);
      const float mul[2] = {online ? inv_l[0] : 1.f, online ? inv_l[1] : 1.f};
      bf16* const o_item = out + i0 * a.o0 + i1 * a.o1;
#pragma unroll
      for (int ob = 0; ob < OB; ++ob) {
        const int cb = cb0 + wg * OB + ob;
        if (cb < cb1) store_block(o_item, a.orow, o + 32 * ob, row0, a.S, cb * kCb, a.d, mul);
      }
    }
  }
}

// ------------------------------- tiled, bf16, d <= 128 (online, two-pass)

// Work item (i0, i1, block of 128 query rows): consumer w owns rows 64w ..
// 64w + 63 and the whole output (NCB column blocks, at most 64 registers a
// thread), so K and V cross shared memory once for 128 query rows and the
// consumers share nothing but the stages. q's blocks stay for the item; the
// ring carries k's column blocks of tile 0, then of tile j and v's of tile
// j - 1 for j = 1, 2, ..., then v's of the last tile (the first of two
// passes: k's alone). A consumer issues s_j = q k_j^T and o += p_{j-1}
// v_{j-1} together, waits for s_j alone and takes its softmax while the p v
// product runs; the two consumers take turns to issue (named barriers 1 and
// 2), so that one's softmax runs while the other's products do.
// consumer w waits for its turn to issue, then passes it to the other
__device__ __forceinline__ void turn_wait(int wg) { bar_sync(1 + wg, 128 * kConsumers); }
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(128 * kConsumers) : "memory");
}

// TK (1 .. 4) and TN (32 or 64): the k-steps and output columns of the last
// column block, from d (96: two and 32), so that no product runs on the
// zeros past d beyond what a 16-column step or a 32-column output needs.
template <int NCB, int TK, int TN>
__global__ void __launch_bounds__(kCtaThreads, 1) general_narrow_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const GeneralArgs a, int online, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = smem_u32(align_smem(smem_raw));
  const uint32_t kv = smem + NCB * 2 * kBoxBytes;  // after q's blocks of 128 rows
  const uint32_t q_full = kv + stages * kTlStage, q_empty = q_full + 8, full = q_full + 16,
                 empty = full + 8 * stages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * kConsumers);
    init_ring(full, empty, stages);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (a.S + kTlKeys - 1) / kTlKeys, blocks = (a.S + kNwRows - 1) / kNwRows;
  const long long items = static_cast<long long>(a.n0) * a.n1 * blocks;
  const int first_pass = online ? 1 : 0;

  if (threadIdx.x < 128) {  // the producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring r;
      uint32_t q_phase = 0;
      // column blocks of k's (is_k) or v's tile j into the next NCB stages
      auto stage = [&](bool is_k, int j, int i1, int i0) {
        for (int cb = 0; cb < NCB; ++cb) {
          mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
          const uint32_t bar = full + 8 * r.slot, st = kv + r.slot * kTlStage;
          mbar_expect_tx(bar, kTlStage);
          for (int b = 0; b < kTlKeys / kBoxRows; ++b)  // past S they arrive as zeros
            tma_box(st + b * kBoxBytes, is_k ? k_map : v_map, bar, cb * kCb,
                    j * kTlKeys + b * kBoxRows, i1, i0);
          r.next(stages);
        }
      };
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int pair = static_cast<int>(item / blocks), i0 = pair / a.n1, i1 = pair % a.n1;
        const int row0 = static_cast<int>(item % blocks) * kNwRows;
        mbar_wait(q_empty, q_phase ^ 1);
        mbar_expect_tx(q_full, NCB * 2 * kBoxBytes);
        for (int cb = 0; cb < NCB; ++cb)
          for (int b = 0; b < 2; ++b)  // rows past S arrive as zeros
            tma_box(smem + (2 * cb + b) * kBoxBytes, q_map, q_full, cb * kCb, row0 + b * kBoxRows,
                    i1, i0);
        q_phase ^= 1;
        for (int pass = first_pass; pass < 2; ++pass) {
          for (int j = 0; j < tiles; ++j) {
            stage(true, j, i1, i0);
            if (pass == 1 && j > 0) stage(false, j - 1, i1, i0);
          }
          if (pass == 1) stage(false, tiles - 1, i1, i0);
        }
      }
    }
  } else {  // the consumers
    regs_inc<kConsumerRegs>();
    const int wg = consumer_index(), t = threadIdx.x % 4;
    const float scale2 = a.scale * kLog2e;  // scores in units of log 2
    bf16* const out = static_cast<bf16*>(a.out);
    Ring r;
    uint32_t q_phase = 0;
    float s[64], o[NCB * 32];
    uint32_t p[8][4];
    // issue s = q k_j^T over the next NCB stages (no commit); the first stage's place
    auto issue_scores = [&]() {
      const Ring first = r;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        mbar_wait(full + 8 * r.slot, r.phase);
        const uint32_t kt = kv + r.slot * kTlStage;
#pragma unroll
        for (int kk = 0; kk < (cb == NCB - 1 ? TK : 4); ++kk)
          Wgmma<128>::ss(s, desc_k(smem + 2 * cb * kBoxBytes, 64 * wg, kk), desc_k(kt, 0, kk),
                         (cb != 0) | (kk != 0));
        r.next(stages);
      }
      return first;
    };
    // issue o += p v over the next NCB stages (no commit); the first stage's place
    auto issue_pv = [&]() {
      const Ring first = r;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        mbar_wait(full + 8 * r.slot, r.phase);
        const uint32_t vt = kv + r.slot * kTlStage;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (cb == NCB - 1 && TN == 32) {
            Wgmma<32>::rs(o + 32 * cb, p[ks], desc_v(vt, 16 * ks), 1);
          } else {
            Wgmma<64>::rs(o + 32 * cb, p[ks], desc_v(vt, 16 * ks), 1);
          }
        }
        r.next(stages);
      }
      return first;
    };
    auto release = [&](Ring at) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        mbar_arrive(empty + 8 * at.slot);
        at.next(stages);
      }
    };
    // s into units of log 2, keys at or past S at -inf; the running max and
    // sum (rescale in alpha) and s = 2^(s - max), or (normalised) the second
    // pass's p
    auto softmax = [&](int j, bool normalised, float (&m)[2], float (&l)[2],
                       const float (&inv_l)[2], float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        s[i] = j * kTlKeys + 8 * (i >> 2) + 2 * t + (i & 1) < a.S ? s[i] * scale2 : -INFINITY;
      if (normalised) {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]) * inv_l[(i >> 1) & 1];
        return;
      }
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // finite: key j * 128 lies below S
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = fast_exp2(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
    };
    // p rounded to bf16 as the A operand of p v, as the scores' accumulator lies
    auto pack = [&]() {
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[ks][e] = pack_bf16(s[8 * ks + 2 * e], s[8 * ks + 2 * e + 1]);
    };
    if (wg == 1) turn_pass(wg);  // consumer 0 issues first
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const int pair = static_cast<int>(item / blocks), i0 = pair / a.n1, i1 = pair % a.n1;
      const int row0 = static_cast<int>(item % blocks) * kNwRows;
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {1.f, 1.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < NCB * 32; ++i) o[i] = 0.f;
      for (int pass = first_pass; pass < 2; ++pass) {
        // tile 0 (in the first of two passes, every tile so)
        for (int j = 0; j < (pass == 0 ? tiles : 1); ++j) {
          turn_wait(wg);
          wgmma_fence();
          const Ring ks = issue_scores();
          wgmma_commit();
          turn_pass(wg);
          wgmma_wait<0>();
          fence_regs<64>(s);
          release(ks);
          if (pass == 1 && tiles == 1) mbar_arrive(q_empty);  // the item's last use of q
          softmax(j, pass == 1 && !online, m, l, inv_l, alpha);
        }
        if (pass == 0) {
          inv_l[0] = 1.f / quad_sum(l[0]);
          inv_l[1] = 1.f / quad_sum(l[1]);
          continue;
        }
        pack();
        for (int j = 1; j < tiles; ++j) {
          turn_wait(wg);
          wgmma_fence();
          const Ring ks = issue_scores();
          wgmma_commit();
          const Ring vs = issue_pv();
          wgmma_commit();
          turn_pass(wg);
          wgmma_wait<1>();  // s_j; p_{j-1} v_{j-1} still runs
          fence_regs<64>(s);
          release(ks);
          if (j == tiles - 1) mbar_arrive(q_empty);
          softmax(j, !online, m, l, inv_l, alpha);
          wgmma_wait<0>();
          fence_regs<NCB * 32>(o);
          release(vs);
          if (online) {
#pragma unroll
            for (int i = 0; i < NCB * 32; ++i) o[i] *= alpha[(i >> 1) & 1];
          }
          pack();
        }
        turn_wait(wg);
        wgmma_fence();
        const Ring vs = issue_pv();
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs<NCB * 32>(o);
        release(vs);
      }
      const float mul[2] = {online ? 1.f / quad_sum(l[0]) : 1.f, online ? 1.f / quad_sum(l[1]) : 1.f};
      bf16* const o_item = out + i0 * a.o0 + i1 * a.o1;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        if (cb == NCB - 1 && TN == 32) {
          store_block<32>(o_item, a.orow, o + 32 * cb, row0 + 64 * wg, a.S, cb * kCb, a.d, mul);
        } else {
          store_block(o_item, a.orow, o + 32 * cb, row0 + 64 * wg, a.S, cb * kCb, a.d, mul);
        }
      }
    }
    if (wg == 0) turn_wait(wg);  // the last turn consumer 1 passed
  }
}

// --------------------------------------------------- frames (S <= 32, exact)

template <typename T, int TP>
using Frames = FramesLayout<static_cast<int>(sizeof(T)), TP>;

// rows 0 .. TP - 1 and columns c0 .. c0 + 63 of an operand (src at its item)
// into a warp's stage, 16 bytes a lane by cp.async, zeros past S and past d
template <typename T, int TP>
__device__ __forceinline__ void frames_load(T* dst, const T* src, long long srow, int S, int c0,
                                            int d, int lane) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T)), kChunks = kCb / kPer;
  for (int i = lane; i < TP * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks * kPer;
    const bool ok = r < S && c0 + c < d;
    cp_async16(smem_u32(dst + r * Frames<T, TP>::kPitch + c), ok ? src + r * srow + c0 + c : src,
               ok);
  }
}

// Persistent warps, each over items first, first + all warps, ...; a warp's
// loads are one sequence (an item: q's and k's column blocks, then v's),
// kFrStages - 1 of them in flight ahead of the one multiplied.
template <typename T, int TP>
__global__ void __launch_bounds__(kFrWarps * 32) general_frames_kernel(const GeneralArgs a) {
  using L = Frames<T, TP>;
  constexpr int kPitch = L::kPitch;
  extern __shared__ __align__(16) unsigned char fr_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* const mine = fr_smem + warp * L::kWarp;
  const int ncb = (a.d + kCb - 1) / kCb, per_item = 2 * ncb;
  const long long items = static_cast<long long>(a.n0) * a.n1 * a.n2;
  const long long warps = static_cast<long long>(gridDim.x) * kFrWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kFrWarps + warp;
  const long long my_items = first < items ? (items - 1 - first) / warps + 1 : 0;
  const long long total = my_items * per_item;
  const T* const q = static_cast<const T*>(a.q);
  const T* const k = static_cast<const T*>(a.k);
  const T* const v = static_cast<const T*>(a.v);
  T* const out = static_cast<T*>(a.out);
  auto stage = [&](long long g) { return reinterpret_cast<T*>(mine + g % kFrStages * L::kStage); };
  auto load = [&](long long g) {
    if (g < total) {
      long long in, o_at;
      item_offsets(a, first + g / per_item * warps, in, o_at);
      const int idx = static_cast<int>(g % per_item);
      T* const dst = stage(g);
      if (idx < ncb) {
        frames_load<T, TP>(dst, q + in, a.srow, a.S, idx * kCb, a.d, lane);
        frames_load<T, TP>(dst + TP * kPitch, k + in, a.srow, a.S, idx * kCb, a.d, lane);
      } else {
        frames_load<T, TP>(dst, v + in, a.srow, a.S, (idx - ncb) * kCb, a.d, lane);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // the stage of position g landed for every lane; position g + stages - 1
  // goes into the slot that position g - 1 (done by every lane) used
  auto advance = [&](long long g) {
    cp_async_wait<kFrStages - 2>();
    __syncwarp();
    load(g + kFrStages - 1);
    return stage(g);
  };
  for (int g = 0; g < kFrStages - 1; ++g) load(g);
  long long g = 0;
  for (long long n = 0; n < my_items; ++n) {
    long long in, o_at;
    item_offsets(a, first + n * warps, in, o_at);
    T* const o_item = out + o_at;
    if constexpr (L::kBf16) {
      constexpr int kM = TP / 16, kN = TP / 8;  // m16 tiles of rows, n8 tiles of keys
      const int g4 = lane / 4, t4 = lane % 4;
      float s[kM][kN][4] = {};
      for (int cb = 0; cb < ncb; ++cb, ++g) {
        const bf16* qs = advance(g);
        const bf16* ks = qs + TP * kPitch;
#pragma unroll
        for (int kk = 0; kk < kCb; kk += 16)
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) {
            uint32_t qa[4];
            ldmatrix_x4(qa, smem_u32(qs + (16 * mt + lane % 16) * kPitch + kk + lane / 16 * 8));
#pragma unroll
            for (int n0 = 0; n0 < TP; n0 += 16) {
              uint32_t kb[4];
              ldmatrix_x4(kb, smem_u32(ks + (n0 + lane % 8 + lane / 16 * 8) * kPitch + kk +
                                       lane / 8 % 2 * 8));
              mma_bf16(s[mt][n0 / 8], qa, kb[0], kb[1]);
              mma_bf16(s[mt][n0 / 8 + 1], qa, kb[2], kb[3]);
            }
          }
      }
      // the exact softmax in the accumulators: a quad holds rows g4 and g4 + 8 of a tile
      uint32_t p[kM][TP / 16][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[mt][j][e];
            x = 8 * j + 2 * t4 + e % 2 < a.S ? x * a.scale : -INFINITY;
            mx[e / 2] = fmaxf(mx[e / 2], x);
          }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
#pragma unroll
        for (int j = 0; j < kN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][j][e] = expf(s[mt][j][e] - mx[e / 2]);
            sum[e / 2] += s[mt][j][e];
          }
        const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
        for (int j = 0; j < TP / 16; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)  // rows g4 (r even) and g4 + 8 of keys 16j .., 16j + 8 ..
            p[mt][j][r] = pack_bf16(s[mt][2 * j + r / 2][2 * (r % 2)] * inv[r % 2],
                                    s[mt][2 * j + r / 2][2 * (r % 2) + 1] * inv[r % 2]);
      }
      for (int cb = 0; cb < ncb; ++cb, ++g) {
        const bf16* vs = advance(g);
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          float o[8][4] = {};
#pragma unroll
          for (int j = 0; j < TP / 16; ++j)
#pragma unroll
            for (int c0 = 0; c0 < kCb; c0 += 16) {
              uint32_t vb[4];
              ldmatrix_x4_trans(vb, smem_u32(vs + (16 * j + lane % 8 + lane / 8 % 2 * 8) * kPitch +
                                             c0 + lane / 16 * 8));
              mma_bf16(o[c0 / 8], p[mt][j], vb[0], vb[1]);
              mma_bf16(o[c0 / 8 + 1], p[mt][j], vb[2], vb[3]);
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * mt + g4 + 8 * r;
            if (row >= a.S) continue;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int col = cb * kCb + 8 * c + 2 * t4;
              if (col < a.d) store_pair(o_item + row * a.orow + col, o[c][2 * r], o[c][2 * r + 1]);
            }
          }
        }
      }
    } else {
      // lane (ri, kj) forms rows ri + 8i and keys kj + 4j
      constexpr int kRi = TP / 8, kKj = TP / 4;
      const int ri = lane / 4, kj = lane % 4;
      float* const ps = reinterpret_cast<float*>(mine + kFrStages * L::kStage);  // [key][row]
      float s[kRi][kKj] = {};
      for (int cb = 0; cb < ncb; ++cb, ++g) {
        const float* qs = advance(g);
        const float* ks = qs + TP * kPitch;
#pragma unroll 4
        for (int c = 0; c < kCb; c += 4) {
          float4 qv[kRi], kv[kKj];
#pragma unroll
          for (int i = 0; i < kRi; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qs + (ri + 8 * i) * kPitch + c);
#pragma unroll
          for (int j = 0; j < kKj; ++j)
            kv[j] = *reinterpret_cast<const float4*>(ks + (kj + 4 * j) * kPitch + c);
#pragma unroll
          for (int i = 0; i < kRi; ++i)
#pragma unroll
            for (int j = 0; j < kKj; ++j) {
              s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
              s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
              s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
              s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < kRi; ++i) {  // row ri + 8i: its keys in the quad's 4 lanes
        float mx = -INFINITY, sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKj; ++j) {
          s[i][j] = kj + 4 * j < a.S ? s[i][j] * a.scale : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        mx = quad_max(mx);
#pragma unroll
        for (int j = 0; j < kKj; ++j) {
          s[i][j] = expf(s[i][j] - mx);
          sum += s[i][j];
        }
        const float inv = 1.f / quad_sum(sum);
#pragma unroll
        for (int j = 0; j < kKj; ++j) ps[(kj + 4 * j) * TP + ri + 8 * i] = s[i][j] * inv;
      }
      for (int cb = 0; cb < ncb; ++cb, ++g) {
        const float* vs = advance(g);  // its __syncwarp also orders ps's writes before the reads
        float o[TP][2] = {};
        for (int key = 0; key < a.S; ++key) {
          const float2 vv = *reinterpret_cast<const float2*>(vs + key * kPitch + 2 * lane);
#pragma unroll
          for (int u = 0; u < TP / 4; ++u) {
            const float4 pp = *reinterpret_cast<const float4*>(ps + key * TP + 4 * u);
            const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[4 * u + e][0] = fmaf(pr[e], vv.x, o[4 * u + e][0]);
              o[4 * u + e][1] = fmaf(pr[e], vv.y, o[4 * u + e][1]);
            }
          }
        }
        const int col = cb * kCb + 2 * lane;
        if (col < a.d) {
#pragma unroll
          for (int row = 0; row < TP; ++row)
            if (row < a.S)
              *reinterpret_cast<float2*>(o_item + row * a.orow + col) =
                  make_float2(o[row][0], o[row][1]);
        }
      }
      __syncwarp();  // ps read before the next item's softmax writes it
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------ f32 CTA kernels

// The row blocks of S rows: ceil(S / 64) of them, the rows spread evenly
// (197: four of 50, not three of 64 and one of 5: a CTA's time is its
// slowest warp's, so a block of 5 rows would cost as much as one of 64).
__device__ __forceinline__ int ft_blocks(int S) { return (S + kFtRows - 1) / kFtRows; }
__device__ __forceinline__ int ft_block_rows(int S) {
  const int blocks = ft_blocks(S);
  return (S + blocks - 1) / blocks;
}

// rows r0 .. and columns c0 .. c0 + kWidth - 1 of an f32 operand into dst at
// `pitch` floats a row, by the CTA's threads i0, i0 + 256, ... over chunks
// [begin, end) of the rows x kWidth / 4 16-byte chunks (zeros past S and d)
template <int kWidth>
__device__ __forceinline__ void ft_load(float* dst, int pitch, const float* src, long long srow,
                                        int r0, int S, int c0, int d, int begin, int end) {
  constexpr int kPerRow = kWidth / 4;
  for (int i = begin + static_cast<int>(threadIdx.x); i < end; i += kFtThreads) {
    const int r = i / kPerRow, c = i % kPerRow * 4;
    const bool ok = r0 + r < S && c0 + c < d;
    cp_async16(smem_u32(dst + r * pitch + c), ok ? src + (r0 + r) * srow + c0 + c : src, ok);
  }
}

// The column blocks of q and k through a ring of kStages cp.async stages:
// load(c) fills stage c % kStages (and commits one group), compute(c, slot)
// runs once its stage has landed for every thread, kStages - 1 ahead in flight.
template <int kStages, typename Load, typename Compute>
__device__ __forceinline__ void ft_ring(int chunks, Load load, Compute compute) {
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) {
      load(c);
    } else {
      cp_async_commit();
    }
  }
  for (int c = 0; c < chunks; ++c) {
    if (c + kStages - 1 < chunks) {
      load(c + kStages - 1);
    } else {
      cp_async_commit();  // an empty group keeps the count
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();
    compute(c, c % kStages);
    __syncthreads();
  }
}

// acc[g][i] += q[4ty + i] . k[16g + tx] over a column block of kDc, k at
// kDc + 4 floats a row (the 4: 8 rows of a quarter warp hit 8 bank groups),
// q at q_pitch
template <int kDc, int G>
__device__ __forceinline__ void ft_scores(float (&acc)[G][4], const float* qs, int q_pitch,
                                          const float* ks, int tx, int ty) {
  constexpr int kPitch = kDc + 4;
#pragma unroll 2
  for (int c = 0; c < kDc; c += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * q_pitch + c);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + (16 * g + tx) * kPitch + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[g][i] = fmaf(qv[i].x, kv.x, acc[g][i]);
        acc[g][i] = fmaf(qv[i].y, kv.y, acc[g][i]);
        acc[g][i] = fmaf(qv[i].z, kv.z, acc[g][i]);
        acc[g][i] = fmaf(qv[i].w, kv.w, acc[g][i]);
      }
    }
  }
}

// o[i][b][c] += p[4ty + i][key] v[key][64b + 4tx + c] over the first `keys`
// keys of a tile (p is 0 and v's rows are zeros past S)
template <int NB>
__device__ __forceinline__ void ft_pv(float (&o)[4][NB][4], const float* ps, int p_pitch,
                                      const float* vs, int v_pitch, int tx, int ty, int keys) {
#pragma unroll 2
  for (int key = 0; key < keys; key += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * p_pitch + key);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + (key + e) * v_pitch + 64 * b + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
          o[i][b][0] = fmaf(pe, vv.x, o[i][b][0]);
          o[i][b][1] = fmaf(pe, vv.y, o[i][b][1]);
          o[i][b][2] = fmaf(pe, vv.z, o[i][b][2]);
          o[i][b][3] = fmaf(pe, vv.w, o[i][b][3]);
        }
      }
  }
}

// rows, f32 (general_layout.cuh's F32Rows)
// grid: items x row blocks (ft_blocks), the block fastest. A warp whose 8
// rows (4ty .. 4ty + 3 of its two ty) all lie past its block skips the
// arithmetic.
template <int G>
__global__ void __launch_bounds__(kFtThreads) general_rows_f32_kernel(const GeneralArgs a) {
  using L = F32Rows<G>;
  extern __shared__ __align__(16) float ft_smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int blocks = ft_blocks(a.S), per_block = ft_block_rows(a.S);
  const int row0 = static_cast<int>(blockIdx.x % blocks) * per_block;
  const int rows = min(per_block, a.S - row0);
  const bool live = 8 * (tid / 32) < rows;
  long long in, o_at;
  item_offsets(a, blockIdx.x / blocks, in, o_at);
  const float* const q = static_cast<const float*>(a.q) + in;
  const float* const k = static_cast<const float*>(a.k) + in;
  const float* const v = static_cast<const float*>(a.v) + in;
  float* const out = static_cast<float*>(a.out) + o_at;
  float* const sm = ft_smem + L::kA / 4;  // the score rows, then p

  constexpr int kQChunks = kFtRows * kRowsDc / 4, kKChunks = 16 * G * kRowsDc / 4;
  float acc[G][4] = {};
  ft_ring<2>((a.d + kRowsDc - 1) / kRowsDc,
             [&](int c) {
               float* st = ft_smem + c % 2 * (L::kStage / 4);
               ft_load<kRowsDc>(st, kRowsDc + 4, q, a.srow, row0, a.S, c * kRowsDc, a.d, 0, kQChunks);
               ft_load<kRowsDc>(st + kFtRows * (kRowsDc + 4), kRowsDc + 4, k, a.srow, 0, a.S,
                              c * kRowsDc, a.d, 0, kKChunks);
               cp_async_commit();
             },
             [&](int, int slot) {
               const float* qs = ft_smem + slot * (L::kStage / 4);
               if (live) ft_scores<kRowsDc, G>(acc, qs, kRowsDc + 4, qs + kFtRows * (kRowsDc + 4), tx, ty);
             });
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 16 * g + tx;
      sm[(4 * ty + i) * L::kSPitch + key] = key < a.S ? acc[g][i] * a.scale : -INFINITY;
    }
  __syncthreads();
  {  // the exact softmax of each row, a warp a row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += kFtThreads / 32) {
      float* row = sm + r * L::kSPitch;
      float x[G / 2 + 1], mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int u = 0; u < G / 2 + 1; ++u) {
        x[u] = lane + 32 * u < 16 * G ? row[lane + 32 * u] : -INFINITY;
        mx = fmaxf(mx, x[u]);
      }
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
#pragma unroll
      for (int u = 0; u < G / 2 + 1; ++u) {
        x[u] = expf(x[u] - mx);
        sum += x[u];
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float inv = 1.f / sum;
#pragma unroll
      for (int u = 0; u < G / 2 + 1; ++u)
        if (lane + 32 * u < 16 * G) row[lane + 32 * u] = x[u] * inv;
    }
  }
  __syncthreads();
  // out = p v, 192 columns at a time, v's 64-key tiles through two stages
  const int tiles = (a.S + kFtKeys - 1) / kFtKeys;
  const int total = (a.d + kRowsNb * kCb - 1) / (kRowsNb * kCb) * tiles;
  auto v_stage = [&](int i) { return ft_smem + i * (L::kVTile / 4); };
  auto load_v = [&](int n) {
    ft_load<kRowsNb * kCb>(v_stage(n & 1), L::kVPitch, v, a.srow, kFtKeys * (n % tiles), a.S,
                         n / tiles * kRowsNb * kCb, a.d, 0, kFtKeys * kRowsNb * kCb / 4);
    cp_async_commit();
  };
  load_v(0);
  float o[4][kRowsNb][4];
  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) {
      load_v(n + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    const int kt = n % tiles;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < kRowsNb; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][b][c] = 0.f;
    }
    if (live)
      ft_pv<kRowsNb>(o, sm + kFtKeys * kt, L::kSPitch, v_stage(n & 1), L::kVPitch, tx, ty,
                   min(kFtKeys, (a.S - kFtKeys * kt + 3) / 4 * 4));
    __syncthreads();
    if (kt == tiles - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * ty + i;
#pragma unroll
        for (int b = 0; b < kRowsNb; ++b) {
          const int col = (n / tiles * kRowsNb + b) * kCb + 4 * tx;
          if (row < rows && col < a.d)
            *reinterpret_cast<float4*>(out + (row0 + row) * a.orow + col) =
                make_float4(o[i][b][0], o[i][b][1], o[i][b][2], o[i][b][3]);
        }
      }
    }
  }
}

// tiled, f32 (general_layout.cuh's F32Tiled)
// grid: items x row blocks (ft_blocks) x parts, the part fastest
template <int NB>
__global__ void __launch_bounds__(kFtThreads) general_tiled_f32_kernel(const GeneralArgs a,
                                                                       int online, int parts) {
  using L = F32Tiled<NB>;
  extern __shared__ __align__(16) float ft_smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int blocks = ft_blocks(a.S), per_block = ft_block_rows(a.S);
  const int part = static_cast<int>(blockIdx.x % parts);
  const int row0 = static_cast<int>(blockIdx.x / parts % blocks) * per_block;
  const int rows = min(per_block, a.S - row0);
  const bool live = 8 * (tid / 32) < rows, resident = parts == 1;
  long long in, o_at;
  item_offsets(a, blockIdx.x / parts / blocks, in, o_at);
  const float* const q = static_cast<const float*>(a.q) + in;
  const float* const k = static_cast<const float*>(a.k) + in;
  const float* const v = static_cast<const float*>(a.v) + in;
  float* const out = static_cast<float*>(a.out) + o_at;
  float* const qr = ft_smem;  // resident q
  float* const ring = ft_smem + (resident ? kFtRows * L::kWide : 0);
  const int stage_floats = (resident ? 0 : L::kQStage / 4) + L::kKStage / 4;
  float* const vs = ring + kFtStages * stage_floats;
  float* const ps = ring;
  const int c0 = part * NB * kCb;  // the part's first output column
  const int chunks = (a.d + kFtDc - 1) / kFtDc, tiles = (a.S + kFtKeys - 1) / kFtKeys;
  constexpr int kBlockChunks = kFtRows * kFtDc / 4, kVChunks = kFtKeys * NB * kCb / 4;
  if (resident) {  // q's rows, all of d: waited with the first column block
    ft_load<NB * kCb>(qr, L::kWide, q, a.srow, row0, a.S, 0, a.d, 0, kFtRows * NB * kCb / 4);
    cp_async_commit();
  }

  float m[4], l[4], inv_l[4], o[4][NB][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    inv_l[i] = 1.f;
  }
  for (int pass = online ? 1 : 0; pass < 2; ++pass) {
    for (int j = 0; j < tiles; ++j) {
      float acc[4][4] = {};
      // k's column block c (and q's, streamed), and (pass 1) the c-th slice of v's tile
      ft_ring<kFtStages>(
          chunks,
          [&](int c) {
            float* st = ring + c % kFtStages * stage_floats;
            if (!resident) {
              ft_load<kFtDc>(st, L::kPitch, q, a.srow, row0, a.S, c * kFtDc, a.d, 0, kBlockChunks);
              st += L::kQStage / 4;
            }
            ft_load<kFtDc>(st, L::kPitch, k, a.srow, j * kFtKeys, a.S, c * kFtDc, a.d, 0,
                           kBlockChunks);
            if (pass == 1)
              ft_load<NB * kCb>(vs, L::kWide, v, a.srow, j * kFtKeys, a.S, c0, a.d,
                                kVChunks * c / chunks, kVChunks * (c + 1) / chunks);
            cp_async_commit();
          },
          [&](int c, int slot) {
            const float* st = ring + slot * stage_floats;
            const float* ks = resident ? st : st + L::kQStage / 4;
            if (live) {
              if (resident) {
                ft_scores<kFtDc, 4>(acc, qr + c * kFtDc, L::kWide, ks, tx, ty);
              } else {
                ft_scores<kFtDc, 4>(acc, st, L::kPitch, ks, tx, ty);
              }
            }
          });
      const int keys = a.S - j * kFtKeys;  // the tile's keys below S (or more)
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // row 4ty + i: its 64 keys in the half warp's 16 lanes
#pragma unroll
        for (int g = 0; g < 4; ++g)
          p[i][g] = 16 * g + tx < keys ? acc[g][i] * a.scale : -INFINITY;
        if (online || pass == 0) {
          float mx = fmaxf(fmaxf(p[i][0], p[i][1]), fmaxf(p[i][2], p[i][3]));
          const float m_new = fmaxf(m[i], half_max(mx));  // finite: key 64j lies below S
          const float alpha = expf(m[i] - m_new);
          m[i] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            p[i][g] = expf(p[i][g] - m_new);
            sum += p[i][g];
          }
          l[i] = l[i] * alpha + sum;
          if (pass == 1) {
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) o[i][b][cc] *= alpha;
          }
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) p[i][g] = expf(p[i][g] - m[i]) * inv_l[i];
        }
      }
      if (pass == 0) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) ps[(4 * ty + i) * L::kPPitch + 16 * g + tx] = p[i][g];
      __syncthreads();  // p written; v's tile landed (waited with the last column block)
      if (live) ft_pv<NB>(o, ps, L::kPPitch, vs, L::kWide, tx, ty, min(kFtKeys, (keys + 3) / 4 * 4));
      __syncthreads();  // p and v read before the next tile's loads
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) inv_l[i] = 1.f / half_sum(l[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    const float mul = online ? 1.f / half_sum(l[i]) : 1.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int col = c0 + b * kCb + 4 * tx;
      if (row < rows && col < a.d)
        *reinterpret_cast<float4*>(out + (row0 + row) * a.orow + col) =
            make_float4(o[i][b][0] * mul, o[i][b][1] * mul, o[i][b][2] * mul, o[i][b][3] * mul);
    }
  }
}

// ----------------------------------------------------------------- host

// Raise Kernel's dynamic shared memory limit to what a block may use, once per
// kernel and device (its launches then take any size up to it).
template <auto Kernel>
int allow_max_smem() {
  return static_cast<int>(allow_smem<Kernel>(kMaxSmem));
}

// The (d, S, n1, n0) tensor map of a bf16 operand (n2 is 1), in 64 x 64 boxes
// under the 128-byte swizzle; boxes past d or S arrive as zeros.
int general_map(CUtensorMap* map, const void* base, const GeneralArgs& a) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.d), static_cast<cuuint64_t>(a.S),
                              static_cast<cuuint64_t>(a.n1), static_cast<cuuint64_t>(a.n0)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.srow) * 2,
                                 static_cast<cuuint64_t>(a.s1) * 2,
                                 static_cast<cuuint64_t>(a.s0) * 2};
  const cuuint32_t box[4] = {kCb, kBoxRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// A TMA kernel on `items` work items: its three tensor maps (built at each
// call: the views' pointers change), persistent CTAs, `smem` bytes.
template <auto Kernel, typename... Extra>
int launch_tma(const GeneralArgs& a, long long items, int smem, cudaStream_t stream,
               Extra... extra) {
  CUtensorMap maps[3];
  const void* bases[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i)
    if (const int err = general_map(&maps[i], bases[i], a)) return err;
  if (const int err = allow_max_smem<Kernel>()) return err;
  Kernel<<<persistent_ctas(items), kCtaThreads, smem, stream>>>(maps[0], maps[1], maps[2], a,
                                                                 extra...);
  return static_cast<int>(cudaGetLastError());
}

// A kernel of `threads` threads on `ctas` CTAs (at most the resident ones
// with `persistent`), `smem` bytes.
template <auto Kernel, typename... Extra>
int launch_plain(const GeneralArgs& a, long long ctas, int threads, int smem, bool persistent,
                 cudaStream_t stream, Extra... extra) {
  if (const int err = allow_max_smem<Kernel>()) return err;
  if (persistent) {
    constexpr int kDevices = 64;
    static int resident[kDevices] = {};  // CTAs an SM, asked once per device
    int device = 0;
    if (const cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
    if (device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[device] == 0) {
      if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &resident[device], Kernel, threads, smem))
        return static_cast<int>(err);
      if (resident[device] == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    ctas = persistent_ctas(ctas, resident[device]);
  }
  if (ctas < 1 || ctas >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  Kernel<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(a, extra...);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T, int TP>
int launch_frames(const GeneralArgs& a, int smem, cudaStream_t stream) {
  const long long items = static_cast<long long>(a.n0) * a.n1 * a.n2;
  return launch_plain<general_frames_kernel<T, TP>>(a, (items + kFrWarps - 1) / kFrWarps,
                                                    kFrWarps * 32, smem, true, stream);
}

int launch_rows(bool is_bf16, const GeneralArgs& a, int width, int smem, cudaStream_t stream) {
  if (is_bf16) {
    if (a.n2 != 1) return kInvalid;
    const long long items =
        static_cast<long long>(a.n0) * a.n1 * ((a.S + kRowsBlock - 1) / kRowsBlock);
    switch (width) {
      case 64: return launch_tma<general_rows_bf16_kernel<64>>(a, items, smem, stream);
      case 128: return launch_tma<general_rows_bf16_kernel<128>>(a, items, smem, stream);
      case 192: return launch_tma<general_rows_bf16_kernel<192>>(a, items, smem, stream);
      case 200: return launch_tma<general_rows_bf16_kernel<200>>(a, items, smem, stream);
      case 256: return launch_tma<general_rows_bf16_kernel<256>>(a, items, smem, stream);
    }
    return kInvalid;
  }
  const long long ctas =
      static_cast<long long>(a.n0) * a.n1 * a.n2 * ((a.S + kFtRows - 1) / kFtRows);
  auto go = [&](auto groups) {
    constexpr int G = decltype(groups)::value;
    return launch_plain<general_rows_f32_kernel<G>>(a, ctas, kFtThreads, smem, false, stream);
  };
  switch (width) {
    case 64: return go(std::integral_constant<int, 4>());
    case 128: return go(std::integral_constant<int, 8>());
    case 192: return go(std::integral_constant<int, 12>());
    case 208: return go(std::integral_constant<int, 13>());
    case 256: return go(std::integral_constant<int, 16>());
  }
  return kInvalid;
}

int launch_tiled(bool is_bf16, bool online, const GeneralArgs& a, int width, int cols, int parts,
                 int smem, cudaStream_t stream) {
  const int ncb = (a.d + kCb - 1) / kCb;
  const long long blocks = (a.S + kTlRows - 1) / kTlRows;  // kFtRows alike
  if (is_bf16) {
    if (a.n2 != 1) return kInvalid;
    if (width == kNwRows) {  // d <= 128: consumers own rows
      const long long items = static_cast<long long>(a.n0) * a.n1 * ((a.S + kNwRows - 1) / kNwRows);
      const int tail = a.d - kCb * (ncb - 1);  // the last column block's columns
      auto go = [&](auto blocks, auto steps) {
        constexpr int NCB = decltype(blocks)::value, TK = decltype(steps)::value;
        return launch_tma<general_narrow_bf16_kernel<NCB, TK, TK <= 2 ? 32 : 64>>(
            a, items, smem, stream, int(online), kTlMaxStages);
      };
      auto by_steps = [&](auto blocks) {
        switch ((tail + 15) / 16) {
          case 1: return go(blocks, std::integral_constant<int, 1>());
          case 2: return go(blocks, std::integral_constant<int, 2>());
          case 3: return go(blocks, std::integral_constant<int, 3>());
        }
        return go(blocks, std::integral_constant<int, 4>());
      };
      return ncb == 1 ? by_steps(std::integral_constant<int, 1>())
                      : by_steps(std::integral_constant<int, 2>());
    }
    const int stages = tiled_stages(ncb);
    const long long items = static_cast<long long>(a.n0) * a.n1 * blocks * parts;
    switch (cols) {
      case 256: return launch_tma<general_tiled_bf16_kernel<2>>(a, items, smem, stream, int(online), stages, parts);
      case 384: return launch_tma<general_tiled_bf16_kernel<3>>(a, items, smem, stream, int(online), stages, parts);
    }
    return kInvalid;
  }
  const long long ctas = static_cast<long long>(a.n0) * a.n1 * a.n2 * blocks * parts;
  auto go = [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    return launch_plain<general_tiled_f32_kernel<NB>>(a, ctas, kFtThreads, smem, false, stream,
                                                      int(online), parts);
  };
  switch (cols / kCb) {
    case 1: return go(std::integral_constant<int, 1>());
    case 2: return go(std::integral_constant<int, 2>());
    case 3: return go(std::integral_constant<int, 3>());
    case 4: return go(std::integral_constant<int, 4>());
    case 5: return go(std::integral_constant<int, 5>());
    case 6: return go(std::integral_constant<int, 6>());
  }
  return kInvalid;
}

}  // namespace

// softmax(q k^T * scale) v for d a multiple of 8 from 8 to 768, S >= 1 rows
// a batch item, batch items (i0, i1, i2) of sizes (n0, n1, n2); row r of
// item (i0, i1, i2) of q, k and v at i0 * s0 + i1 * s1 + i2 * s2 + r * srow,
// of out at i0 * o0 + i1 * o1 + i2 * o2 + r * orow (elements, the head dim
// contiguous). bf16 if is_bf16, else f32; the online softmax of the blocked
// kernels if online, else the exact softmax of the spatial and temporal
// ones. q, k, v and out 16-byte aligned with strides of whole 16 bytes.
// The plan (ops/st_attention.py::general_plan): kind 0 (frames: exact, S <=
// width, width 16 or 32), 1 (rows: exact, S <= width; bf16 widths 64, 128,
// 192, 200, 256, f32 64, 128, 192, 208, 256) or 2 (tiled: `width` query rows
// a CTA, 128 for bf16 up to d 128 and 64 else; `cols` output columns a part
// over `parts` parts); the TMA kernels (bf16 rows and tiled) ask n2 = 1. Its
// shared memory, and the bf16 tiled forms' K/V stages, come from
// general_layout.cuh. Anything else is cudaErrorInvalidValue; a tensor map
// the encoder refuses is kTensorMapError (10000) + its CUresult.
extern "C" int maed_general_attention(int is_bf16, int online, const void* q, const void* k,
                                      const void* v, void* out, int n0, int n1, int n2, int S,
                                      int d, long long s0, long long s1, long long s2,
                                      long long srow, long long o0, long long o1, long long o2,
                                      long long orow, float scale, int kind, int width, int cols,
                                      int parts, void* stream) {
  const long long per16 = is_bf16 ? 8 : 4;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n0 < 1 || n1 < 1 || n2 < 1 || S < 1 || d < 8 || d > kGnMaxD || d % 8 || !aligned(q) ||
      !aligned(k) || !aligned(v) || !aligned(out) || s0 % per16 || s1 % per16 || s2 % per16 ||
      srow % per16 || o0 % per16 || o1 % per16 || o2 % per16 || orow % per16)
    return kInvalid;
  const int smem = general_smem(is_bf16, kind, width, cols, parts, d);
  if (smem < 0 || smem > kMaxSmem) return kInvalid;
  const GeneralArgs a{q, k, v, out, n0, n1, n2, S, d, s0, s1, s2, srow, o0, o1, o2, orow, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kFrames:
      if (online || S > width) return kInvalid;
      if (width == 16)
        return is_bf16 ? launch_frames<bf16, 16>(a, smem, st) : launch_frames<float, 16>(a, smem, st);
      if (width == 32)
        return is_bf16 ? launch_frames<bf16, 32>(a, smem, st) : launch_frames<float, 32>(a, smem, st);
      return kInvalid;
    case kRows:
      if (online || S > width) return kInvalid;
      return launch_rows(is_bf16, a, width, smem, st);
    case kTiled:
      return launch_tiled(is_bf16, online, a, width, cols, parts, smem, st);
  }
  return kInvalid;
}
