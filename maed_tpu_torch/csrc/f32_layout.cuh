// The shared-memory layouts and thread maps of the f32 kernels on the CUDA
// cores: the GEMM of C, D and E (ln_mlp.cu, gemm_f32_kernel) and the
// spatial attention at head dims up to 128 (st_attention.cu,
// spatial_f32_kernel), with spatial_f32_plan(), which the launcher takes
// each call's instance and bytes from. Plain C++ (no CUDA header), so that a
// host compiler reads the same layout: tests/test_torch_port_f32_kernels.py
// compiles it on the CPU and holds every plan (S 1-1024, d 8-128) and the
// GEMM to the shared memory a CTA may use and to writing each output column
// once.
#pragma once

#ifdef __CUDACC__
#define MAED_F32_HD __host__ __device__
#else
#define MAED_F32_HD
#endif

namespace maed_f32 {

constexpr int kMaxSmem = 232448;  // shared memory a block may use on the H100

// ------------------------------------------------------------------- GEMM
//
// A 128 x 128 output tile a CTA of 256 threads, 32-deep k-steps through a
// ring of kGemmStages cp.async stages, each the A and W tiles K-major (rows
// of 32 floats padded to 36: the float4 reads of 4 or 8 consecutive rows hit
// distinct bank groups); a thread's 8 x 8 outputs are rows gemm_row(.., i)
// and columns gemm_col(.., j); the tile goes out through its own staging
// buffer (rows padded to 136: the scalar writes of a warp's 4 x 8 block hit
// 32 banks).
constexpr int kGemmThreads = 256;
constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 32;
constexpr int kGemmTM = 8, kGemmTN = 8;  // a thread's outputs
constexpr int kGemmStages = 4;
constexpr int kGemmPitch = kGemmBK + 4;
constexpr int kGemmTile = kGemmBM * kGemmPitch;  // floats of one operand's stage (BM == BN)
constexpr int kGemmStage = 2 * kGemmTile;        // A's, then W's
constexpr int kGemmOutPitch = kGemmBN + 8;
constexpr int kGemmBytes = (kGemmStages * kGemmStage + kGemmBM * kGemmOutPitch) * 4;
static_assert(kGemmBytes <= kMaxSmem, "the GEMM's stages and staging buffer fit a CTA");
static_assert(kGemmThreads * kGemmTM * kGemmTN == kGemmBM * kGemmBN, "the threads cover the tile");

// warp w of 8 takes rows 32 (w % 4) .. and columns 64 (w / 4) ..; lane l
// rows l / 8 + 4i (i < 8) and columns l % 8 + 8j (j < 8) of them
MAED_F32_HD constexpr int gemm_row(int warp, int lane, int i) {
  return 32 * (warp % 4) + lane / 8 + 4 * i;
}
MAED_F32_HD constexpr int gemm_col(int warp, int lane, int j) {
  return 64 * (warp / 4) + lane % 8 + 8 * j;
}

// ---------------------------------------------------------------- spatial
//
// A CTA of 256 threads (16 x 16: tx the fastest) takes `rows` query rows of
// one (batch, head), rows_per_thread (RPT) each: row RPT ty + i. It forms
// their scores against key tiles of 16 G keys, key 16g + tx of a tile in
// the thread's acc[g][i], over 16-column chunks of q and k through two
// cp.async stages. With one key tile (S <= 256) it takes the exact softmax
// on those registers and writes p into the score rows in shared memory;
// with more it writes the scaled scores there (`width` = key_tiles x 16 G
// keys, -inf past S) and takes the softmax a warp a row. Then out = p v
// over 32-key tiles of v through the same two stages' memory, output
// column spatial_col(b, tx, c) = 64b + 4tx + c (b < NB, c < 4) of each of
// its rows.
constexpr int kSpThreads = 256;
constexpr int kSpMaxS = 1024, kSpMaxD = 128;
constexpr int kSpDc = 16;          // head-dim columns of a q / k chunk
constexpr int kSpChunkPitch = kSpDc + 4;
constexpr int kSpVKeys = 32;       // keys of a v tile
constexpr int kSpOneTile = 256;    // the widest score row of one key tile (64 rows a CTA)
// the score width of one key tile, 16 G keys, for S <= 256 keys: G 2, 4, 8,
// 12, 13 or 16 (the launcher's instances); 197 tokens (224 px) take 208
inline int spatial_groups(int S) {
  return S <= 32 ? 2 : S <= 64 ? 4 : S <= 128 ? 8 : S <= 192 ? 12 : S <= 208 ? 13 : 16;
}

MAED_F32_HD constexpr int spatial_col(int b, int tx, int c) { return 64 * b + 4 * tx + c; }

// floats of a q / k stage, of a v tile, of a score row's pitch (the pitch
// puts the two rows of a warp's score writes 16 banks apart)
MAED_F32_HD constexpr int spatial_stage(int rpt, int g) { return (16 * rpt + 16 * g) * kSpChunkPitch; }
MAED_F32_HD constexpr int spatial_v_pitch(int nb) { return 64 * nb + 4; }
MAED_F32_HD constexpr int spatial_p_pitch(int rpt, int width) { return width + 16 / rpt; }

struct SpatialPlan {
  int rpt;        // query rows a thread (64 or 32 rows a CTA)
  int g;          // a key tile's 16-key groups
  int nb;         // 64-column blocks of the output (d <= 64: 1, else 2)
  int key_tiles;  // key tiles a score row spans
  int rows;       // query rows a CTA: S spread evenly over ceil(S / (16 rpt)) blocks
  int blocks;     // CTAs an item
  int width;      // the score row: key_tiles x 16 g >= S
  int bytes;      // shared memory
};

// The instance of a call of S tokens at head dim d (S 1-1024, d a multiple
// of 8 up to 128): one key tile of the narrowest width that holds S and 64
// query rows a CTA up to 256 keys; beyond, key tiles of 256 and 32 rows a
// CTA, so that a score row of up to 1024 keys fits. bytes 0: no instance.
inline SpatialPlan spatial_f32_plan(int S, int d) {
  SpatialPlan p{0, 0, 0, 0, 0, 0, 0, 0};
  if (S < 1 || S > kSpMaxS || d < 8 || d > kSpMaxD || d % 8) return p;
  p.nb = d <= 64 ? 1 : 2;
  if (S <= kSpOneTile) {
    p.rpt = 4;
    p.key_tiles = 1;
    p.g = spatial_groups(S);
  } else {
    p.rpt = 2;
    p.g = 16;
    p.key_tiles = (S + 16 * p.g - 1) / (16 * p.g);
  }
  const int cta_rows = 16 * p.rpt;
  p.blocks = (S + cta_rows - 1) / cta_rows;
  p.rows = (S + p.blocks - 1) / p.blocks;
  p.width = p.key_tiles * 16 * p.g;
  const int ring = 2 * spatial_stage(p.rpt, p.g);
  const int v = 2 * kSpVKeys * spatial_v_pitch(p.nb);
  p.bytes = ((ring > v ? ring : v) + cta_rows * spatial_p_pitch(p.rpt, p.width)) * 4;
  return p;
}

}  // namespace maed_f32
