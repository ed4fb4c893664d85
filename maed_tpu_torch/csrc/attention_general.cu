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
//     `_attention_blocked`): the online softmax (kOnline).
// One entry point, maed_general_attention, serves the three: a head's rows
// are addressed as row r of batch item (i0, i1, i2) at i0 * s0 + i1 * s1 +
// i2 * s2 + r * srow (the output likewise), so spatial is (B, H, 1) over
// the S tokens of a frame and temporal (G, N, H) over the T frames of a clip.
//
// Design, right and simple first: a warp owns one work item, 16 query rows of
// one batch item, and four independent warps share a CTA. Shared memory
// stays bounded at any d because both products walk the head dim in chunks
// of 64 columns: the scores of 32 keys are summed over the chunks of q and k
// (bf16: mma.sync m16n8k16 from ldmatrix; f32: a lane a key on the CUDA
// cores), and the output is formed one 64-column chunk at a time, each chunk
// walking all the keys again with its scores formed anew. The exact softmax
// takes a first pass for each row's max and sum, then p = exp(s - max) / sum
// rounded to v's dtype; the online softmax keeps a running max and sum in
// every chunk's pass and rounds the unnormalised p, as the plain versions do
// (ops/st_attention.py::_attend, ops/attention.py::attention_blocked_reference).
// Scores and both products accumulate in f32.
//
// What bounds it on the H100: at these head dims the operations, formed
// (1 + d / 64) times for the scores (the price of the bounded shared
// memory), on mma.sync at no pipelining. Speed is later work; PERF.md holds
// its times beside its bound and the library's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"  // cp.async, ldmatrix, mma.sync, allow_smem

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGnWarps = 4;     // warps a CTA, each on its own work item
constexpr int kGnRows = 16;     // query rows of a work item
constexpr int kGnKeys = 32;     // keys of a tile
constexpr int kGnCols = 64;     // head-dim columns of a chunk, in both products
constexpr int kGnMaxD = 768;

struct GeneralArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int n1, n2, S, d;
  long long items;                // batch items x query tiles
  long long s0, s1, s2, srow;     // q, k, v (elements)
  long long o0, o1, o2, orow;     // out
  float scale;
};

// This warp's work item: the offsets of its batch item in q, k, v and out,
// and its first query row. False past the last item.
__device__ __forceinline__ bool general_item(const GeneralArgs& a, long long& in,
                                             long long& out, int& row0) {
  const int tiles = (a.S + kGnRows - 1) / kGnRows;
  const long long w = static_cast<long long>(blockIdx.x) * kGnWarps + threadIdx.x / 32;
  if (w >= a.items) return false;
  const long long b = w / tiles;
  const long long i2 = b % a.n2, i1 = b / a.n2 % a.n1, i0 = b / a.n2 / a.n1;
  in = i0 * a.s0 + i1 * a.s1 + i2 * a.s2;
  out = i0 * a.o0 + i1 * a.o1 + i2 * a.o2;
  row0 = static_cast<int>(w % tiles) * kGnRows;
  return true;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------------ bf16

constexpr int kGnPitch = kGnCols + 8;  // a row and 16 bytes: ldmatrix's 8 rows hit 8 bank groups
constexpr int kGnWarpElems = (kGnRows + 2 * kGnKeys) * kGnPitch;

// Rows r0 .. r0 + rows - 1 and columns c0 .. c0 + 63 of an operand (src at
// its item's offset) into a warp's tile, 16 bytes a lane by cp.async, zeros
// past S and past d; committed, not waited for.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, long long srow, int r0,
                                           int rows, int S, int c0, int d, int lane) {
  constexpr int kPerRow = kGnCols / 8;
  for (int i = lane; i < rows * kPerRow; i += 32) {
    const int r = i / kPerRow, c = i % kPerRow * 8;
    const bool ok = r0 + r < S && c0 + c < d;
    cp_async16(smem_u32(dst + r * kGnPitch + c), ok ? src + (r0 + r) * srow + c0 + c : src, ok);
  }
  cp_async_commit();
}

// s = q k^T * scale of the warp's 16 rows against keys k0 .. k0 + 31 (keys
// past S at -inf), over the head dim in chunks. Thread (g, t) = (lane / 4,
// lane % 4) holds rows g (s[j][0..1]) and g + 8 (s[j][2..3]) at keys
// k0 + 8j + 2t and + 1.
__device__ __forceinline__ void scores_bf16(float (&s)[4][4], bf16* qs, bf16* ks, const bf16* q,
                                            const bf16* k, const GeneralArgs& a, int row0,
                                            int k0, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int c0 = 0; c0 < a.d; c0 += kGnCols) {
    __syncwarp();  // the previous chunk has been read
    load_chunk(qs, q, a.srow, row0, kGnRows, a.S, c0, a.d, lane);
    load_chunk(ks, k, a.srow, k0, kGnKeys, a.S, c0, a.d, lane);
    cp_async_wait<0>();
    __syncwarp();
    const int width = min(kGnCols, a.d - c0);  // zeros beyond it
    for (int kk = 0; kk < width; kk += 16) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_u32(qs + lane % 16 * kGnPitch + kk + lane / 16 * 8));
#pragma unroll
      for (int n0 = 0; n0 < kGnKeys; n0 += 16) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(ks + (n0 + lane % 8 + lane / 16 * 8) * kGnPitch + kk +
                                 lane / 8 % 2 * 8));
        mma_bf16(s[n0 / 8], qa, kb[0], kb[1]);
        mma_bf16(s[n0 / 8 + 1], qa, kb[2], kb[3]);
      }
    }
  }
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = k0 + 8 * j + 2 * t + e % 2 < a.S ? s[j][e] * a.scale : -INFINITY;
}

// The running max m and this thread's share of the running sum l of its two
// rows over one more tile of scores; returns each row's rescale alpha, and
// leaves exp(s - new max) in s.
__device__ __forceinline__ void online_bf16(float (&s)[4][4], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = quad_max(mx);  // finite: key k0 of every tile lies below S
    alpha[r] = expf(m[r] - mx);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j][2 * r] = expf(s[j][2 * r] - mx);
      s[j][2 * r + 1] = expf(s[j][2 * r + 1] - mx);
      sum += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// Grid: ceil(items / kGnWarps) CTAs of kGnWarps warps, a warp an item.
template <bool kOnline>
__global__ void __launch_bounds__(kGnWarps * 32) general_attention_mma_kernel(const GeneralArgs a) {
  __shared__ __align__(16) uint16_t tiles[kGnWarps * kGnWarpElems];  // bf16 bits
  long long in, out_at;
  int row0;
  if (!general_item(a, in, out_at, row0)) return;  // whole warps leave; no CTA barrier below
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  bf16* qs = reinterpret_cast<bf16*>(tiles) + threadIdx.x / 32 * kGnWarpElems;
  bf16* ks = qs + kGnRows * kGnPitch;
  bf16* vs = ks + kGnKeys * kGnPitch;
  const bf16* q = static_cast<const bf16*>(a.q) + in;
  const bf16* k = static_cast<const bf16*>(a.k) + in;
  const bf16* v = static_cast<const bf16*>(a.v) + in;
  bf16* out = static_cast<bf16*>(a.out) + out_at;

  // the exact softmax: each row's max and sum first
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (!kOnline) {
    for (int k0 = 0; k0 < a.S; k0 += kGnKeys) {
      float s[4][4], alpha[2];
      scores_bf16(s, qs, ks, q, k, a, row0, k0, lane);
      online_bf16(s, m, l, alpha);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }

  for (int c0 = 0; c0 < a.d; c0 += kGnCols) {
    float o[8][4] = {};
    if constexpr (kOnline) {
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
    for (int k0 = 0; k0 < a.S; k0 += kGnKeys) {
      float s[4][4];
      scores_bf16(s, qs, ks, q, k, a, row0, k0, lane);
      if constexpr (kOnline) {
        float alpha[2];
        online_bf16(s, m, l, alpha);  // s = exp(s - running max), unnormalised
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c][e] *= alpha[e / 2];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e / 2]) / l[e / 2];
      }
      // p rounded to bf16, in registers as the A operand of p v
      uint32_t p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[j][r] = pack_bf16(s[2 * j + r / 2][2 * (r % 2)], s[2 * j + r / 2][2 * (r % 2) + 1]);
      __syncwarp();  // the previous v chunk has been read
      load_chunk(vs, v, a.srow, k0, kGnKeys, a.S, c0, a.d, lane);
      cp_async_wait<0>();
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int cc = 0; cc < kGnCols; cc += 16) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_u32(vs + (16 * j + lane % 8 + lane / 8 % 2 * 8) * kGnPitch +
                                         cc + lane / 16 * 8));
          mma_bf16(o[cc / 8], p[j], vb[0], vb[1]);
          mma_bf16(o[cc / 8 + 1], p[j], vb[2], vb[3]);
        }
      }
    }
    float mul[2] = {1.f, 1.f};
    if constexpr (kOnline) {
      mul[0] = 1.f / quad_sum(l[0]);
      mul[1] = 1.f / quad_sum(l[1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= a.S) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = c0 + 8 * c + 2 * t;
        if (col >= a.d) continue;  // d is a multiple of 8: a pair lies inside or outside
        out[row * a.orow + col] = __float2bfloat16_rn(o[c][2 * r] * mul[r]);
        out[row * a.orow + col + 1] = __float2bfloat16_rn(o[c][2 * r + 1] * mul[r]);
      }
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int kGnKPitch = kGnCols + 1;  // k rows, read a lane a key: no bank conflicts
constexpr int kGnPPitch = kGnKeys + 1;
constexpr int kGnWarpFloats =
    kGnRows * kGnCols + kGnKeys * kGnKPitch + kGnKeys * kGnCols + kGnRows * kGnPPitch;

// Rows and columns as load_chunk, as f32 at `pitch` floats a row.
__device__ __forceinline__ void load_chunk_f32(float* dst, int pitch, const float* src,
                                               long long srow, int r0, int rows, int S, int c0,
                                               int d, int lane) {
  constexpr int kPerRow = kGnCols / 4;
  for (int i = lane; i < rows * kPerRow; i += 32) {
    const int r = i / kPerRow, c = i % kPerRow * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c0 + c < d) x = *reinterpret_cast<const float4*>(src + (r0 + r) * srow + c0 + c);
    float* row = dst + r * pitch + c;
    row[0] = x.x;
    row[1] = x.y;
    row[2] = x.z;
    row[3] = x.w;
  }
}

// s[r] = q_r . k_{k0 + lane} * scale for the warp's 16 rows (-inf past S).
__device__ __forceinline__ void scores_f32(float (&s)[kGnRows], float* qs, float* ks,
                                           const float* q, const float* k, const GeneralArgs& a,
                                           int row0, int k0, int lane) {
#pragma unroll
  for (int r = 0; r < kGnRows; ++r) s[r] = 0.f;
  for (int c0 = 0; c0 < a.d; c0 += kGnCols) {
    __syncwarp();
    load_chunk_f32(qs, kGnCols, q, a.srow, row0, kGnRows, a.S, c0, a.d, lane);
    load_chunk_f32(ks, kGnKPitch, k, a.srow, k0, kGnKeys, a.S, c0, a.d, lane);
    __syncwarp();
    const int width = min(kGnCols, a.d - c0);
    const float* kr = ks + lane * kGnKPitch;
    for (int c = 0; c < width; c += 4) {
      const float k0v = kr[c], k1v = kr[c + 1], k2v = kr[c + 2], k3v = kr[c + 3];
#pragma unroll
      for (int r = 0; r < kGnRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * kGnCols + c);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }
  }
  const bool key_ok = k0 + lane < a.S;
#pragma unroll
  for (int r = 0; r < kGnRows; ++r) s[r] = key_ok ? s[r] * a.scale : -INFINITY;
}

// As online_bf16, a row a register across the warp's lanes (a lane a key).
__device__ __forceinline__ void online_f32(float (&s)[kGnRows], float (&m)[kGnRows],
                                           float (&l)[kGnRows], float (&alpha)[kGnRows]) {
#pragma unroll
  for (int r = 0; r < kGnRows; ++r) {
    const float mx = fmaxf(m[r], warp_max(s[r]));
    alpha[r] = expf(m[r] - mx);
    m[r] = mx;
    s[r] = expf(s[r] - mx);
    l[r] = l[r] * alpha[r] + s[r];
  }
}

template <bool kOnline>
__global__ void __launch_bounds__(kGnWarps * 32) general_attention_f32_kernel(const GeneralArgs a) {
  extern __shared__ __align__(16) float gn_smem[];
  long long in, out_at;
  int row0;
  if (!general_item(a, in, out_at, row0)) return;
  const int lane = threadIdx.x % 32;
  float* qs = gn_smem + threadIdx.x / 32 * kGnWarpFloats;  // 16 x 64
  float* ks = qs + kGnRows * kGnCols;                      // 32 x 65
  float* vs = ks + kGnKeys * kGnKPitch;                    // 32 x 64
  float* ps = vs + kGnKeys * kGnCols;                      // 16 x 33
  const float* q = static_cast<const float*>(a.q) + in;
  const float* k = static_cast<const float*>(a.k) + in;
  const float* v = static_cast<const float*>(a.v) + in;
  float* out = static_cast<float*>(a.out) + out_at;

  float m[kGnRows], l[kGnRows], alpha[kGnRows];
#pragma unroll
  for (int r = 0; r < kGnRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  if constexpr (!kOnline) {
    for (int k0 = 0; k0 < a.S; k0 += kGnKeys) {
      float s[kGnRows];
      scores_f32(s, qs, ks, q, k, a, row0, k0, lane);
      online_f32(s, m, l, alpha);
    }
#pragma unroll
    for (int r = 0; r < kGnRows; ++r) l[r] = warp_sum(l[r]);
  }

  for (int c0 = 0; c0 < a.d; c0 += kGnCols) {
    float o[kGnRows][2] = {};  // columns c0 + lane and c0 + 32 + lane
    if constexpr (kOnline) {
#pragma unroll
      for (int r = 0; r < kGnRows; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
      }
    }
    for (int k0 = 0; k0 < a.S; k0 += kGnKeys) {
      float s[kGnRows];
      scores_f32(s, qs, ks, q, k, a, row0, k0, lane);
      if constexpr (kOnline) {
        online_f32(s, m, l, alpha);
#pragma unroll
        for (int r = 0; r < kGnRows; ++r) {
          o[r][0] *= alpha[r];
          o[r][1] *= alpha[r];
        }
      } else {
#pragma unroll
        for (int r = 0; r < kGnRows; ++r) s[r] = expf(s[r] - m[r]) / l[r];
      }
      __syncwarp();  // the previous tile's p and v have been read
#pragma unroll
      for (int r = 0; r < kGnRows; ++r) ps[r * kGnPPitch + lane] = s[r];
      load_chunk_f32(vs, kGnCols, v, a.srow, k0, kGnKeys, a.S, c0, a.d, lane);
      __syncwarp();
      for (int key = 0; key < kGnKeys; ++key) {
        const float v0 = vs[key * kGnCols + lane], v1 = vs[key * kGnCols + 32 + lane];
#pragma unroll
        for (int r = 0; r < kGnRows; ++r) {
          const float pr = ps[r * kGnPPitch + key];
          o[r][0] = fmaf(pr, v0, o[r][0]);
          o[r][1] = fmaf(pr, v1, o[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kGnRows; ++r) {
      const int row = row0 + r;
      const float mul = kOnline ? 1.f / warp_sum(l[r]) : 1.f;
      if (row >= a.S) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + 32 * h + lane;
        if (col < a.d) out[row * a.orow + col] = o[r][h] * mul;
      }
    }
  }
}

template <auto Kernel>
int launch_general(const GeneralArgs& a, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024)
    if (const cudaError_t err = allow_smem<Kernel>(smem)) return static_cast<int>(err);
  const long long ctas = (a.items + kGnWarps - 1) / kGnWarps;
  if (ctas >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  Kernel<<<static_cast<unsigned>(ctas), kGnWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// softmax(q k^T * scale) v for d a multiple of 8 from 8 to 768, S >= 1 rows
// a batch item, batch items (i0, i1, i2) of sizes (n0, n1, n2); row r of
// item (i0, i1, i2) of q, k and v at i0 * s0 + i1 * s1 + i2 * s2 + r * srow,
// of out at i0 * o0 + i1 * o1 + i2 * o2 + r * orow (elements, the head dim
// contiguous). bf16 if is_bf16, else f32; the online softmax of the blocked
// kernels if online, else the exact softmax of the spatial and temporal
// ones. q, k and v 16-byte aligned with strides of whole 16 bytes, else
// cudaErrorInvalidValue.
extern "C" int maed_general_attention(int is_bf16, int online, const void* q, const void* k,
                                      const void* v, void* out, int n0, int n1, int n2, int S,
                                      int d, long long s0, long long s1, long long s2,
                                      long long srow, long long o0, long long o1, long long o2,
                                      long long orow, float scale, void* stream) {
  const long long per16 = is_bf16 ? 8 : 4;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n0 < 1 || n1 < 1 || n2 < 1 || S < 1 || d < 8 || d > kGnMaxD || d % 8 || !aligned(q) ||
      !aligned(k) || !aligned(v) || s0 % per16 || s1 % per16 || s2 % per16 || srow % per16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (S + kGnRows - 1) / kGnRows;
  const GeneralArgs a{q, k, v, out, n1, n2, S, d,
                      static_cast<long long>(n0) * n1 * n2 * tiles,
                      s0, s1, s2, srow, o0, o1, o2, orow, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return online ? launch_general<general_attention_mma_kernel<true>>(a, 0, s)
                  : launch_general<general_attention_mma_kernel<false>>(a, 0, s);
  const int smem = kGnWarps * kGnWarpFloats * static_cast<int>(sizeof(float));
  return online ? launch_general<general_attention_f32_kernel<true>>(a, smem, s)
                : launch_general<general_attention_f32_kernel<false>>(a, smem, s);
}
