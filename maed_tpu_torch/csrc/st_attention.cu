// The attention kernels of the spatio-temporal block, f32 or bf16: attention
// over the S tokens of a frame (spatial), over the T frames of a token
// (temporal) and over all T * N tokens of a clip (blocked, st_mode
// 'coupling'), each softmax(q k^T * scale) v per head.
//
// Replaces five Pallas kernels with three CUDA kernels:
//   blocked_attention_kernel (below the spatial ones, with its own note)
//     maed_tpu/ops/attention.py::_attn_blocked_kernel (pallas_call in
//       `_attention_blocked`, public entry `fused_attention`, S > 1024)
//   spatial_attention_kernel
//     maed_tpu/ops/attention.py::_attn_oneshot_kernel (pallas_call in
//       `_attention_oneshot`, public entry `fused_attention`, S <= 1024)
//     maed_tpu/ops/st_attention.py::_spatial_kernel (pallas_call in
//       `_spatial_pallas`, public entry `spatial_attention`)
//   temporal_attention_kernel
//     maed_tpu/ops/st_attention.py::_temporal_kernel (pallas_call in
//       `_temporal_pallas`, public entry `temporal_attention`)
//     maed_tpu/ops/st_attention.py::_temporal_v2_kernel (pallas_call in
//       `_temporal_v2_pallas`, public entry `temporal_attention_fused`)
// The TPU pairs differ only in the layouts they read and write, so here q, k, v
// and the output are addressed by strides (head dim contiguous): one kernel
// reads the qkv projection's natural (BT, N, 3, h, d) or a (B, h, S, d) triple
// and writes (BT, N, C), head-leading (h, BT, N, d) or (B, h, S, d). No
// transposed copy exists on either side.
//
// What bounds them on the H100: memory. At the flagship shape (BT 128, N 197,
// h 12, d 64, T 16) each reads the 116 MB qkv and writes 39 MB in bf16, 0.046 ms
// at 3.35 TB/s; the spatial products are 15.3 GFLOP (0.015 ms at the bf16
// tensor-core peak), the temporal ones 1.2 GFLOP. Neither writes scores to
// device memory.
//
// Spatial, bf16 with a head dim of 16, 32, 64 or 128 (the serving path): the
// products run on the tensor cores (mma.sync m16n8k16, f32 accumulate). A block
// takes 64 query rows of one (frame, head), a warp 16 of them with its q
// fragments in registers; keys and values pass through shared memory 64 at a
// time. The softmax stays the exact two-pass one without a score buffer: pass 1
// forms every score tile and keeps only each row's running max and sum; pass 2
// forms the tiles again, turns them into p = exp(s - max) / sum rounded to bf16
// in the registers of the next product's A operand, and accumulates p v. The
// second q k^T costs 7.6 GFLOP at the flagship and saves the (S x S) scores'
// trip through shared memory. The ragged S (197) masks score columns to -inf
// and zero-fills the key and value rows beyond it.
//
// Spatial, f32 (the reference protocol's dtype; bf16 has the path above
// alone), any head dim that is a multiple of 8: a block
// takes 32 query rows, a warp 4 of them. The keys pass through shared memory in
// tiles of 64 (as f32, rows padded by one word against bank conflicts); a lane
// takes every 32nd key of the tile and forms its score with 4 rows at once on
// the CUDA cores (no TF32). The rows' scores stay in shared memory (S <= 1024
// floats a row), then the values pass through the same tile buffer and a lane
// accumulates output columns lane, lane + 32, ... of its 4 rows.
//
// Temporal: one warp per (clip, token, head). Its T x d q, k and v rows lie
// N * 3C elements apart in the qkv tensor (128-byte rows in bf16 at d 64, read
// as 16-byte chunks); they go to the warp's shared memory as f32, the T x T
// scores are formed there, softmaxed row by row, and multiplied into v. The
// TPU kernels' stacking of 8 tokens into one masked (8T, 8T) product, the
// head-pair lane masks and the `lo` operand exist for the MXU and are not
// carried over.
//
// Rounding points as the Pallas bodies: f32 scores from x-dtype operands, times
// scale, f32 softmax (exp(s - max) / sum), p rounded to v's dtype, f32
// accumulation, the output rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
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

// 16 bytes of T
template <typename T>
struct alignas(16) Chunk {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// d elements at src (16-byte aligned, d a multiple of 8) -> f32 at dst, by a warp
template <typename T>
__device__ __forceinline__ void load_row(float* dst, const T* src, int d, int lane) {
  constexpr int kN = Chunk<T>::kN;
  for (int c = lane * kN; c < d; c += 32 * kN) {
    const Chunk<T> chunk = *reinterpret_cast<const Chunk<T>*>(src + c);
#pragma unroll
    for (int e = 0; e < kN; ++e) dst[c + e] = to_f32(chunk.v[e]);
  }
}

constexpr int kMaxD = 128, kColsPerLane = kMaxD / 32;

// ---------------------------------------------------------------- spatial

constexpr int kSpWarps = 8, kSpThreads = kSpWarps * 32;
constexpr int kRowsPerWarp = 4, kQueryTile = kSpWarps * kRowsPerWarp, kKeyTile = 64;

// rows of K or V, k0 .. k0 + kn - 1, into the tile buffer at `pitch` floats a row
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int pitch, const T* src, long long ss,
                                          int k0, int kn, int d) {
  constexpr int kN = Chunk<T>::kN;
  const int per_row = d / kN;
  for (int idx = threadIdx.x; idx < kn * per_row; idx += kSpThreads) {
    const int key = idx / per_row, c = (idx % per_row) * kN;
    const Chunk<T> chunk = *reinterpret_cast<const Chunk<T>*>(src + (k0 + key) * ss + c);
#pragma unroll
    for (int e = 0; e < kN; ++e) tile[key * pitch + c + e] = to_f32(chunk.v[e]);
  }
}

// grid (B * H, ceil(S / kQueryTile)). Element (b, h, s, :) of q, k, v at
// b * sb + h * sh + s * ss, of out at b * ob + h * oh + s * os.
template <typename T>
__global__ void __launch_bounds__(kSpThreads) spatial_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int S, int d, long long sb, long long sh, long long ss,
    long long ob, long long oh, long long os, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // kQueryTile x d
  float* kv_s = q_s + kQueryTile * d;         // kKeyTile x (d + 1)
  float* p_s = kv_s + kKeyTile * (d + 1);     // kQueryTile x S

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kQueryTile;
  const long long in_base = b * sb + h * sh;
  q += in_base;
  k += in_base;
  v += in_base;
  out += b * ob + h * oh;
  const int r0 = warp * kRowsPerWarp;  // this warp's first row within the tile

  for (int r = warp; r < kQueryTile; r += kSpWarps) {
    if (q0 + r < S) {
      load_row(q_s + r * d, q + (q0 + r) * ss, d, lane);
    } else {
      for (int c = lane; c < d; c += 32) q_s[r * d + c] = 0.f;
    }
  }

  // scores of the tile's rows against every key
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    const int kn = min(kKeyTile, S - k0);
    __syncthreads();  // q_s written; the previous tile read
    load_tile(kv_s, d + 1, k, ss, k0, kn, d);
    __syncthreads();
    for (int key = lane; key < kn; key += 32) {
      const float* kr = kv_s + key * (d + 1);
      float acc[kRowsPerWarp] = {};
      for (int c = 0; c < d; c += 4) {
        const float k0v = kr[c], k1v = kr[c + 1], k2v = kr[c + 2], k3v = kr[c + 3];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + (r0 + r) * d + c);
          acc[r] = fmaf(qv.x, k0v, acc[r]);
          acc[r] = fmaf(qv.y, k1v, acc[r]);
          acc[r] = fmaf(qv.z, k2v, acc[r]);
          acc[r] = fmaf(qv.w, k3v, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) p_s[(r0 + r) * S + k0 + key] = acc[r] * scale;
    }
  }
  __syncwarp();

  // softmax of this warp's rows, p rounded as v's dtype holds it
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (q0 + r0 + r >= S) break;
    float* pr = p_s + (r0 + r) * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, pr[j]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < S; j += 32) pr[j] = to_f32(from_f32<T>(pr[j] / sum));
  }

  // out = p v
  float acc[kRowsPerWarp][kColsPerLane] = {};
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    const int kn = min(kKeyTile, S - k0);
    __syncthreads();  // the previous tile read (and every warp's p_s written)
    load_tile(kv_s, d, v, ss, k0, kn, d);
    __syncthreads();
    for (int key = 0; key < kn; ++key) {
      float vv[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < d ? kv_s[key * d + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = p_s[(r0 + r) * S + k0 + key];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= S) break;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < d) out[row * os + c] = from_f32<T>(acc[r][j]);
    }
  }
}

// ------------------------------------------------- spatial, bf16 tensor cores

constexpr int kMmaWarps = 4, kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16 * kMmaWarps, kMmaKeys = 64;

// c += a b for one m16n8k16 tile: a (16 x 16, row major) and b (16 x 8, column
// major) bf16 fragments, c (16 x 8) f32. With g = lane / 4 and t = lane % 4:
// a[0], a[1] hold columns 2t, 2t + 1 of rows g and g + 8, a[2], a[3] the same
// rows at columns 2t + 8, 2t + 9; b[0], b[1] hold rows 2t, 2t + 1 and 2t + 8,
// 2t + 9 of column g; c[0], c[1] are row g, columns 2t, 2t + 1; c[2], c[3] row g + 8.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 tiles from row-major shared memory, transposed: lane l gives
// the address of row l % 8 of tile l / 8, and receives of each tile the
// elements (2t, g) and (2t + 1, g): a b fragment of a row-major (k x n) operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows row0 .. row0 + kMmaKeys - 1 of src (those from `valid` on as zeros)
// into a tile of `pitch` elements a row
template <int D>
__device__ __forceinline__ void load_block_bf16(bf16* tile, int pitch, const bf16* src,
                                                long long ss, int row0, int valid) {
  for (int idx = threadIdx.x; idx < kMmaKeys * (D / 8); idx += kMmaThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const uint4 chunk = r < valid ? *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c)
                                  : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(tile + r * pitch + c) = chunk;
  }
}

// grid (B * H, ceil(S / kMmaRows)); addressing as spatial_attention_kernel.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) spatial_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int H, int S, long long sb, long long sh, long long ss,
    long long ob, long long oh, long long os, float scale) {
  // rows of D + 8: 16-byte aligned, and the fragments' 4-byte reads (8 rows
  // x 4 columns a warp) fall into 32 different banks
  constexpr int kPitch = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kMmaRows x kPitch
  bf16* k_s = q_s + kMmaRows * kPitch;            // kMmaKeys x kPitch
  bf16* v_s = k_s + kMmaKeys * kPitch;            // kMmaKeys x kPitch

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kMmaRows;
  const long long in_base = b * sb + h * sh;
  q += in_base;
  k += in_base;
  v += in_base;
  out += b * ob + h * oh;

  load_block_bf16<D>(q_s, kPitch, q, ss, q0, S - q0);
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const bf16* lo = q_s + (warp * 16 + g) * kPitch + 2 * t;
    const bf16* hi = lo + 8 * kPitch;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(lo + kk * 16);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(hi + kk * 16);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(lo + kk * 16 + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(hi + kk * 16 + 8);
    }
  }

  // scaled scores of this warp's 16 rows against keys k0 + 8j .. + 7 of the
  // block in k_s; columns beyond S are -inf
  auto score_tile = [&](int k0, int j, float (&c)[4]) {
    c[0] = c[1] = c[2] = c[3] = 0.f;
    const bf16* kr = k_s + (j * 8 + g) * kPitch + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_16816(c, qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
    const int col = k0 + j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = col + (e & 1) < S ? c[e] * scale : -INFINITY;
  };

  // pass 1: the max m and the sum l of exp(s - m) of rows g (0) and g + 8 (1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += kMmaKeys) {
    const int kn = min(kMmaKeys, S - k0);
    __syncthreads();  // the previous block read
    load_block_bf16<D>(k_s, kPitch, k, ss, k0, kn);
    __syncthreads();
    for (int j = 0; j < (kn + 7) / 8; ++j) {  // every such tile has a column below S
      float c[4];
      score_tile(k0, j, c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tile_max = fmaxf(c[2 * r], c[2 * r + 1]);
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        const float m_new = fmaxf(m[r], tile_max);
        l[r] = l[r] * __expf(m[r] - m_new) + __expf(c[2 * r] - m_new) +
               __expf(c[2 * r + 1] - m_new);
        m[r] = m_new;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row's 8 columns of a tile lie in 4 lanes
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // exp by the fast intrinsic and a multiplication by 1 / l: a few f32 ulps from
  // expf and a division, far below the bf16 rounding of p that follows
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: p = exp(s - m) / l rounded to bf16, out = p v
  float o[D / 8][4] = {};
  for (int k0 = 0; k0 < S; k0 += kMmaKeys) {
    const int kn = min(kMmaKeys, S - k0);
    __syncthreads();
    load_block_bf16<D>(k_s, kPitch, k, ss, k0, kn);
    load_block_bf16<D>(v_s, kPitch, v, ss, k0, kn);
    __syncthreads();
    for (int jj = 0; jj < (kn + 15) / 16; ++jj) {  // 16 keys: two score tiles, one k step
      float c_lo[4], c_hi[4];
      score_tile(k0, 2 * jj, c_lo);
      score_tile(k0, 2 * jj + 1, c_hi);
      uint32_t pa[4];
      pa[0] = pack_bf16(__expf(c_lo[0] - m[0]) * inv_l[0], __expf(c_lo[1] - m[0]) * inv_l[0]);
      pa[1] = pack_bf16(__expf(c_lo[2] - m[1]) * inv_l[1], __expf(c_lo[3] - m[1]) * inv_l[1]);
      pa[2] = pack_bf16(__expf(c_hi[0] - m[0]) * inv_l[0], __expf(c_hi[1] - m[0]) * inv_l[0]);
      pa[3] = pack_bf16(__expf(c_hi[2] - m[1]) * inv_l[1], __expf(c_hi[3] - m[1]) * inv_l[1]);
      // lanes 0-15 address the 16 keys' rows at column tile nd, lanes 16-31 at nd + 1
      const bf16* vr = v_s + (jj * 16 + lane % 16) * kPitch + (lane / 16) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + nd * 8);
        mma_16816(o[nd], pa, vb[0], vb[1]);
        mma_16816(o[nd + 1], pa, vb[2], vb[3]);
      }
    }
  }

  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    bf16* dst = out + nd * 8 + 2 * t;
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * os) = __floats2bfloat162_rn(o[nd][0], o[nd][1]);
    if (row + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8) * os) =
          __floats2bfloat162_rn(o[nd][2], o[nd][3]);
  }
}

template <int D>
int launch_spatial_mma(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
                       long long sb, long long sh, long long ss, long long ob, long long oh,
                       long long os, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kMmaRows + 2 * kMmaKeys) * (D + 8) * sizeof(bf16);
  auto kernel = spatial_attention_mma_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + kMmaRows - 1) / kMmaRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, S, sb, sh, ss, ob, oh, os, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spatial(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
                   int d, long long sb, long long sh, long long ss, long long ob, long long oh,
                   long long os, float scale, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kQueryTile) * d + kKeyTile * (d + 1) + static_cast<size_t>(kQueryTile) * S) *
      sizeof(float);
  auto kernel = spatial_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + kQueryTile - 1) / kQueryTile);
  kernel<<<grid, kSpThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<T*>(out), H, S,
                                             d, sb, sh, ss, ob, oh, os, scale);
  return static_cast<int>(cudaGetLastError());
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
// tensor-core peak, against 0.046 ms for its 155 MB; forming the 3152^2 scores
// twice, as the spatial kernel's exact softmax does, would add half again. So
// the scores are formed once and never leave registers.
//
// bf16 (head dim 16, 32, 64 or 128): a block of 8 warps takes 128 query rows of
// one (batch, head), a warp 16 of them with q fragments in registers (mma.sync
// m16n8k16, f32 accumulate; up to head dim 64 capped at 128 registers, so that
// two blocks share an SM). Keys and values come 64 at a time by 16-byte
// cp.async into two shared-memory stages, the next tile in flight while this
// one is multiplied; both operands' fragments are read with ldmatrix. The
// scores are kept in units of log 2 (scale * log2 e in one multiplication), so
// every exponential is one ex2. S is not padded anywhere: the key loop ends at
// S, the last tile's missing rows are zero-filled on the way in and its columns
// masked. The TPU kernel's 512 x 512 blocks, its host padding of S to a
// multiple of 512 and its scratch carried across grid steps are not carried
// over; a 64-key tile moves the running max more often than a 512-key block, so
// an unnormalised p may round to the neighbouring bf16 value. (A first version
// with 4 warps and 64 rows a block, the keys' fragments by 4-byte loads and
// __expf took 1.34 ms at the coupling shape against this one's 1.19; 8 warps
// without the register cap, one block an SM, took 1.46.)
//
// f32, any head dim that is a multiple of 8: a block takes 64 query rows, a warp
// 8 of them, on the CUDA cores (no TF32). A lane forms the scores of keys lane
// and lane + 32 of the tile with its warp's 8 rows at once, p goes through
// shared memory, and a lane accumulates output columns lane, lane + 32, ...

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// e^x for x <= 0 as 2^(x log2 e) is what __expf computes; with the scores kept
// in units of log 2 the multiplication is paid once, in the scale. -inf gives 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 bf16 tiles from row-major shared memory, as they lie: lane l gives
// the address of row l % 8 of tile l / 8, and receives of each tile the elements
// (g, 2t) and (g, 2t + 1): a b fragment of a row-major (n x k) operand.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

constexpr int kBlkWarps = 8, kBlkThreads = kBlkWarps * 32, kBlkRows = 16 * kBlkWarps;

// rows row0 .. row0 + kRows - 1 of src (those from `valid` on as zeros) into a
// tile of `pitch` elements a row, without waiting: commit and wait are the caller's
template <int D, int kRows>
__device__ __forceinline__ void load_rows_async(bf16* tile, int pitch, const bf16* src,
                                                long long ss, int row0, int valid) {
  for (int idx = threadIdx.x; idx < kRows * (D / 8); idx += kBlkThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool ok = r < valid;
    cp_async16(tile + r * pitch + c, ok ? src + (row0 + r) * ss + c : src, ok);
  }
}

// grid (B * H, ceil(S / kBlkRows)); addressing as spatial_attention_kernel.
template <int D>
__global__ void __launch_bounds__(kBlkThreads, D <= 64 ? 2 : 1) blocked_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int H, int S, long long sb, long long sh, long long ss,
    long long ob, long long oh, long long os, float scale) {
  constexpr int kPitch = D + 8, kTile = kMmaKeys * kPitch;  // see spatial_attention_mma_kernel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kBlkRows x kPitch
  bf16* k_s = q_s + kBlkRows * kPitch;            // two stages of kMmaKeys x kPitch
  bf16* v_s = k_s + 2 * kTile;                    // two stages of kMmaKeys x kPitch

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kBlkRows;
  const long long in_base = b * sb + h * sh;
  q += in_base;
  k += in_base;
  v += in_base;
  out += b * ob + h * oh;
  scale *= 1.4426950408889634f;  // scores in units of log 2: see fast_exp2

  load_rows_async<D, kBlkRows>(q_s, kPitch, q, ss, q0, S - q0);
  load_rows_async<D, kMmaKeys>(k_s, kPitch, k, ss, 0, S);
  load_rows_async<D, kMmaKeys>(v_s, kPitch, v, ss, 0, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const bf16* lo = q_s + (warp * 16 + g) * kPitch + 2 * t;
    const bf16* hi = lo + 8 * kPitch;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(lo + kk * 16);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(hi + kk * 16);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(lo + kk * 16 + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(hi + kk * 16 + 8);
    }
  }

  // rows g (0) and g + 8 (1): running max, this lane's share of the running
  // sum (alpha is the same in the row's 4 lanes, so the shares add up at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4] = {};
  const int tiles = (S + kMmaKeys - 1) / kMmaKeys;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kMmaKeys;
    const bf16* k_cur = k_s + (it & 1) * kTile;
    const bf16* v_cur = v_s + (it & 1) * kTile;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; every warp has left the other stage
    if (it + 1 < tiles) {
      const int nxt = (it + 1) & 1, k1 = k0 + kMmaKeys;
      load_rows_async<D, kMmaKeys>(k_s + nxt * kTile, kPitch, k, ss, k1, S - k1);
      load_rows_async<D, kMmaKeys>(v_s + nxt * kTile, kPitch, v, ss, k1, S - k1);
      cp_async_commit();
    }

    // scaled scores of this warp's 16 rows against the tile's 64 keys, 8 at a
    // time; columns beyond S are -inf (the first tile always has a column below S)
    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (D >= 32) {  // the 8 keys' fragments of two k steps in one load
        const bf16* kr = k_cur + (j * 8 + lane % 8) * kPitch + (lane / 8) * 8;
#pragma unroll
        for (int kk = 0; kk < D / 16; kk += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kr + kk * 16);
          mma_16816(s[j], qa[kk], kb[0], kb[1]);
          mma_16816(s[j], qa[kk + 1], kb[2], kb[3]);
        }
      } else {
        const bf16* kr = k_cur + (j * 8 + g) * kPitch + 2 * t;
        mma_16816(s[j], qa[0], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
      const int col = k0 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = col + (e & 1) < S ? s[j][e] * scale : -INFINITY;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMmaKeys / 8; ++j)
        tile_max = fmaxf(tile_max, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      const float m_new = fmaxf(m[r], tile_max);
      const float alpha = fast_exp2(m[r] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMmaKeys / 8; ++j) {
        s[j][2 * r] = fast_exp2(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = fast_exp2(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][2 * r] *= alpha;
        o[nd][2 * r + 1] *= alpha;
      }
    }

    // o += round(p) v, 16 keys (two score tiles, one k step) at a time
#pragma unroll
    for (int jj = 0; jj < kMmaKeys / 16; ++jj) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * jj][0], s[2 * jj][1]);
      pa[1] = pack_bf16(s[2 * jj][2], s[2 * jj][3]);
      pa[2] = pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]);
      pa[3] = pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3]);
      const bf16* vr = v_cur + (jj * 16 + lane % 16) * kPitch + (lane / 16) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + nd * 8);
        mma_16816(o[nd], pa, vb[0], vb[1]);
        mma_16816(o[nd + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    bf16* dst = out + nd * 8 + 2 * t;
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * os) =
          __floats2bfloat162_rn(o[nd][0] / l[0], o[nd][1] / l[0]);
    if (row + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8) * os) =
          __floats2bfloat162_rn(o[nd][2] / l[1], o[nd][3] / l[1]);
  }
}

template <int D>
int launch_blocked_mma(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
                       long long sb, long long sh, long long ss, long long ob, long long oh,
                       long long os, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBlkRows + 4 * kMmaKeys) * (D + 8) * sizeof(bf16);
  auto kernel = blocked_attention_mma_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + kBlkRows - 1) / kBlkRows);
  kernel<<<grid, kBlkThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, S, sb, sh, ss, ob, oh, os, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBkWarps = 8, kBkThreads = kBkWarps * 32;
constexpr int kBkRowsPerWarp = 8, kBkRows = kBkWarps * kBkRowsPerWarp, kBkKeys = 64;

// rows k0 .. k0 + kBkKeys - 1 of K or V (those from `kn` on as zeros) into the
// tile buffer at `pitch` floats a row
__device__ __forceinline__ void load_tile_zero(float* tile, int pitch, const float* src,
                                               long long ss, int k0, int kn, int d) {
  const int per_row = d / 4;
  for (int idx = threadIdx.x; idx < kBkKeys * per_row; idx += kBkThreads) {
    const int key = idx / per_row, c = (idx % per_row) * 4;
    const float4 chunk = key < kn ? *reinterpret_cast<const float4*>(src + (k0 + key) * ss + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = tile + key * pitch + c;
    dst[0] = chunk.x;
    dst[1] = chunk.y;
    dst[2] = chunk.z;
    dst[3] = chunk.w;
  }
}

// grid (B * H, ceil(S / kBkRows)); addressing as spatial_attention_kernel.
__global__ void __launch_bounds__(kBkThreads) blocked_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int H, int S, int d, long long sb, long long sh, long long ss,
    long long ob, long long oh, long long os, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // kBkRows x d
  float* k_s = q_s + kBkRows * d;          // kBkKeys x (d + 1), against bank conflicts
  float* v_s = k_s + kBkKeys * (d + 1);    // kBkKeys x d
  float* p_s = v_s + kBkKeys * d;          // kBkRows x kBkKeys

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kBkRows;
  const long long in_base = b * sb + h * sh;
  q += in_base;
  k += in_base;
  v += in_base;
  out += b * ob + h * oh;
  const int r0 = warp * kBkRowsPerWarp;  // this warp's first row within the block

  for (int r = warp; r < kBkRows; r += kBkWarps) {
    if (q0 + r < S) {
      load_row(q_s + r * d, q + (q0 + r) * ss, d, lane);
    } else {
      for (int c = lane; c < d; c += 32) q_s[r * d + c] = 0.f;
    }
  }

  // per row: running max, this lane's share of the running sum, and this
  // lane's output columns lane, lane + 32, ...
  float m[kBkRowsPerWarp], l[kBkRowsPerWarp], acc[kBkRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kBkRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBkKeys) {
    const int kn = min(kBkKeys, S - k0);
    __syncthreads();  // q_s written; the previous tile and its p read
    load_tile_zero(k_s, d + 1, k, ss, k0, kn, d);
    load_tile_zero(v_s, d, v, ss, k0, kn, d);
    __syncthreads();

    // scores of the warp's rows against keys lane (a) and lane + 32 (b)
    float s_lo[kBkRowsPerWarp] = {}, s_hi[kBkRowsPerWarp] = {};
    const float* ka = k_s + lane * (d + 1);
    const float* kb = ka + 32 * (d + 1);
    for (int c = 0; c < d; c += 4) {
      const float a0 = ka[c], a1 = ka[c + 1], a2 = ka[c + 2], a3 = ka[c + 3];
      const float b0 = kb[c], b1 = kb[c + 1], b2 = kb[c + 2], b3 = kb[c + 3];
#pragma unroll
      for (int r = 0; r < kBkRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (r0 + r) * d + c);
        s_lo[r] = fmaf(qv.x, a0, s_lo[r]);
        s_lo[r] = fmaf(qv.y, a1, s_lo[r]);
        s_lo[r] = fmaf(qv.z, a2, s_lo[r]);
        s_lo[r] = fmaf(qv.w, a3, s_lo[r]);
        s_hi[r] = fmaf(qv.x, b0, s_hi[r]);
        s_hi[r] = fmaf(qv.y, b1, s_hi[r]);
        s_hi[r] = fmaf(qv.z, b2, s_hi[r]);
        s_hi[r] = fmaf(qv.w, b3, s_hi[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kBkRowsPerWarp; ++r) {
      const float xa = lane < kn ? s_lo[r] * scale : -INFINITY;  // key 0 of a tile is below S
      const float xb = lane + 32 < kn ? s_hi[r] * scale : -INFINITY;
      float tile_max = fmaxf(xa, xb);
      for (int off = 16; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[r], tile_max);
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      const float pa = expf(xa - m_new), pb = expf(xb - m_new);
      l[r] = l[r] * alpha + pa + pb;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[r][j] *= alpha;
      p_s[(r0 + r) * kBkKeys + lane] = pa;
      p_s[(r0 + r) * kBkKeys + lane + 32] = pb;
    }
    __syncwarp();

    // acc += p v, 4 keys at a time (the rows beyond kn are zeros, and so is their p)
    for (int key = 0; key < kBkKeys; key += 4) {
      float vv[4][kColsPerLane];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = lane + 32 * j;
          vv[e][j] = c < d ? v_s[(key + e) * d + c] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kBkRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + (r0 + r) * kBkKeys + key);
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          acc[r][j] = fmaf(p.x, vv[0][j], acc[r][j]);
          acc[r][j] = fmaf(p.y, vv[1][j], acc[r][j]);
          acc[r][j] = fmaf(p.z, vv[2][j], acc[r][j]);
          acc[r][j] = fmaf(p.w, vv[3][j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kBkRowsPerWarp; ++r) {
    for (int off = 16; off > 0; off >>= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    const int row = q0 + r0 + r;
    if (row < S) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        if (c < d) out[row * os + c] = acc[r][j] / l[r];
      }
    }
  }
}

int launch_blocked_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
                       int d, long long sb, long long sh, long long ss, long long ob,
                       long long oh, long long os, float scale, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kBkRows) * d + kBkKeys * (d + 1) +
                       static_cast<size_t>(kBkKeys) * d + kBkRows * kBkKeys) * sizeof(float);
  auto kernel = blocked_attention_f32_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + kBkRows - 1) / kBkRows);
  kernel<<<grid, kBkThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, S, d, sb, sh, ss, ob, oh, os, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- temporal

constexpr int kTpWarps = 4;

// floats of shared memory one warp needs: q and k at d + 1 a row, v at d, p at T + 1
__host__ __device__ constexpr int temporal_warp_floats(int T, int d) {
  return 2 * T * (d + 1) + T * d + T * (T + 1);
}

// One warp per (clip g, token n, head h), h fastest. Frame t of that triple is
// row q + (g * T + t) * s_frame + n * s_token + h * s_head (k and v alike),
// and its output row out + (g * T + t) * o_frame + n * o_token + h * o_head.
template <typename T>
__global__ void __launch_bounds__(kTpWarps * 32) temporal_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int G, int frames, int N, int H, int d, long long s_frame,
    long long s_token, long long s_head, long long o_frame, long long o_token,
    long long o_head, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long wid = static_cast<long long>(blockIdx.x) * kTpWarps + warp;
  if (wid >= static_cast<long long>(G) * N * H) return;  // whole warps leave; no block barrier below
  const int h = wid % H, n = (wid / H) % N, g = wid / (static_cast<long long>(H) * N);

  float* q_s = smem + warp * temporal_warp_floats(frames, d);  // frames x (d + 1)
  float* k_s = q_s + frames * (d + 1);                         // frames x (d + 1)
  float* v_s = k_s + frames * (d + 1);                         // frames x d
  float* p_s = v_s + frames * d;                               // frames x (frames + 1)

  const long long in0 = static_cast<long long>(g) * frames * s_frame + n * s_token + h * s_head;
  {  // every lane takes 16-byte chunks of q, k and v: frames * d / kN of each
    constexpr int kN = Chunk<T>::kN;
    const int per_row = d / kN;
#pragma unroll 2
    for (int idx = lane; idx < frames * per_row; idx += 32) {
      const int t = idx / per_row, c = (idx % per_row) * kN;
      const long long at = in0 + t * s_frame + c;
      const Chunk<T> cq = *reinterpret_cast<const Chunk<T>*>(q + at);
      const Chunk<T> ck = *reinterpret_cast<const Chunk<T>*>(k + at);
      const Chunk<T> cv = *reinterpret_cast<const Chunk<T>*>(v + at);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        q_s[t * (d + 1) + c + e] = to_f32(cq.v[e]);
        k_s[t * (d + 1) + c + e] = to_f32(ck.v[e]);
        v_s[t * d + c + e] = to_f32(cv.v[e]);
      }
    }
  }
  __syncwarp();

  for (int idx = lane; idx < frames * frames; idx += 32) {
    const int i = idx / frames, j = idx % frames;
    const float* qr = q_s + i * (d + 1);
    const float* kr = k_s + j * (d + 1);
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
    p_s[i * (frames + 1) + j] = acc * scale;
  }
  __syncwarp();

  for (int i = lane; i < frames; i += 32) {
    float* pr = p_s + i * (frames + 1);
    float m = -INFINITY;
    for (int j = 0; j < frames; ++j) m = fmaxf(m, pr[j]);
    float sum = 0.f;
    for (int j = 0; j < frames; ++j) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int j = 0; j < frames; ++j) pr[j] = to_f32(from_f32<T>(pr[j] / sum));
  }
  __syncwarp();

  T* out0 = out + static_cast<long long>(g) * frames * o_frame + n * o_token + h * o_head;
  for (int i = 0; i < frames; ++i) {
    float acc[kColsPerLane] = {};
    for (int j = 0; j < frames; ++j) {
      const float p = p_s[i * (frames + 1) + j];
#pragma unroll
      for (int jj = 0; jj < kColsPerLane; ++jj) {
        const int c = lane + 32 * jj;
        if (c < d) acc[jj] = fmaf(p, v_s[j * d + c], acc[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kColsPerLane; ++jj) {
      const int c = lane + 32 * jj;
      if (c < d) out0[i * o_frame + c] = from_f32<T>(acc[jj]);
    }
  }
}

template <typename T>
int launch_temporal(const void* q, const void* k, const void* v, void* out, int G, int frames,
                    int N, int H, int d, long long s_frame, long long s_token, long long s_head,
                    long long o_frame, long long o_token, long long o_head, float scale,
                    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTpWarps) * temporal_warp_floats(frames, d) * sizeof(float);
  auto kernel = temporal_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long warps = static_cast<long long>(G) * N * H;
  const unsigned blocks = static_cast<unsigned>((warps + kTpWarps - 1) / kTpWarps);
  kernel<<<blocks, kTpWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), G, frames, N, H, d, s_frame, s_token, s_head, o_frame, o_token,
      o_head, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out in one dtype (bf16 if is_bf16, else f32), head dim contiguous,
// d a multiple of 8 and at most 128, S at most 1024; every row 16-byte aligned
// (pointers aligned, strides multiples of 8 elements). Strides in elements.
// bf16 has one path, the tensor-core kernel: d of 16, 32, 64 or 128 and an
// output of 4-byte aligned pairs (even strides), else cudaErrorInvalidValue.
extern "C" int maed_spatial_attention(int is_bf16, const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int S, int d, long long sb,
                                      long long sh, long long ss, long long ob, long long oh,
                                      long long os, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_spatial<float>(q, k, v, out, B, H, S, d, sb, sh, ss, ob, oh, os, scale, s);
  // the tensor-core kernel writes 4-byte pairs and has its head dim at compile time
  const bool pairs = reinterpret_cast<uintptr_t>(out) % 4 == 0 && ob % 2 == 0 && oh % 2 == 0 &&
                     os % 2 == 0;
#define MAED_SPATIAL_MMA(D) \
  launch_spatial_mma<D>(q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, scale, s)
  if (pairs && d == 16) return MAED_SPATIAL_MMA(16);
  if (pairs && d == 32) return MAED_SPATIAL_MMA(32);
  if (pairs && d == 64) return MAED_SPATIAL_MMA(64);
  if (pairs && d == 128) return MAED_SPATIAL_MMA(128);
#undef MAED_SPATIAL_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// As maed_spatial_attention, for any S: the online-softmax kernel (one pass over
// the keys), which rounds an unnormalised p where the spatial kernel rounds a
// normalised one.
extern "C" int maed_blocked_attention(int is_bf16, const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int S, int d, long long sb,
                                      long long sh, long long ss, long long ob, long long oh,
                                      long long os, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_blocked_f32(q, k, v, out, B, H, S, d, sb, sh, ss, ob, oh, os, scale, s);
  const bool pairs = reinterpret_cast<uintptr_t>(out) % 4 == 0 && ob % 2 == 0 && oh % 2 == 0 &&
                     os % 2 == 0;
#define MAED_BLOCKED_MMA(D) \
  launch_blocked_mma<D>(q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, scale, s)
  if (pairs && d == 16) return MAED_BLOCKED_MMA(16);
  if (pairs && d == 32) return MAED_BLOCKED_MMA(32);
  if (pairs && d == 64) return MAED_BLOCKED_MMA(64);
  if (pairs && d == 128) return MAED_BLOCKED_MMA(128);
#undef MAED_BLOCKED_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above for G clips of T frames (T at most 32) of N tokens of H heads.
extern "C" int maed_temporal_attention(int is_bf16, const void* q, const void* k, const void* v,
                                       void* out, int G, int T, int N, int H, int d,
                                       long long s_frame, long long s_token, long long s_head,
                                       long long o_frame, long long o_token, long long o_head,
                                       float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_temporal<bf16>(q, k, v, out, G, T, N, H, d, s_frame, s_token, s_head, o_frame,
                                 o_token, o_head, scale, s);
  return launch_temporal<float>(q, k, v, out, G, T, N, H, d, s_frame, s_token, s_head, o_frame,
                                o_token, o_head, scale, s);
}
