// The shared memory of attention_general.cu's forms: the sizes its kernels
// lay their tiles out by, and general_smem(), which its launcher takes each
// call's bytes from. Plain C++ (no CUDA header), so that a host compiler
// reads the same layout: tests/test_torch_port_general_attention.py compiles
// general_smem() on the CPU and holds every plan of
// ops/st_attention.py::general_plan to a form this file has, within the
// shared memory a CTA may use.
#pragma once

#ifdef __CUDACC__
#define MAED_HD __host__ __device__
#else
#define MAED_HD
#endif

namespace maed_general {

constexpr int kGnMaxD = 768;
constexpr int kMaxSmem = 232448;                // shared memory a block may use
constexpr int kCb = 64;                         // head-dim columns of a column block
constexpr int kCbBytes = 2 * kCb;               // a bf16 column block's row: one 128-byte swizzle span
constexpr int kBoxRows = 64;                    // rows of a TMA box
constexpr int kBoxBytes = kBoxRows * kCbBytes;  // 8 KB

enum Kind { kFrames = 0, kRows = 1, kTiled = 2 };

// ------------------------------------------------------------------ frames

constexpr int kFrWarps = 4, kFrStages = 3;

// kSize: bytes an element (2: bf16, 4: f32); TP: an item's rows padded to 16 or 32
template <int kSize, int TP>
struct FramesLayout {
  static constexpr bool kBf16 = kSize == 2;
  // a row and 16 bytes: ldmatrix's 8 rows (bf16) or float4 reads of 8 rows (f32) hit 8 bank groups
  static constexpr int kPitch = kCb + 16 / kSize;
  static constexpr int kOperand = TP * kPitch * kSize;
  static constexpr int kStage = 2 * kOperand;  // q's and k's column blocks, or v's
  static constexpr int kP = kBf16 ? 0 : TP * TP * 4;  // f32: p transposed
  static constexpr int kWarp = kFrStages * kStage + kP;
  static constexpr int kBytes = kFrWarps * kWarp;
};

// -------------------------------------------------------------- rows, bf16

constexpr int kRowsBlock = 128;                     // query rows of a work item
constexpr int kRowsStages = 4;
constexpr int kRowsQ = kRowsBlock * kCbBytes;       // a column block of q: 16 KB
constexpr int kRowsStage = kRowsQ + 256 * kCbBytes;  // + one of k (or of v): 32 KB
constexpr int kRowsBars = kRowsStages * kRowsStage;
constexpr int kRowsBytes = kRowsBars + 2 * kRowsStages * 8 + 1024;  // + alignment

// ------------------------------------------------------------- tiled, bf16

constexpr int kTlRows = 64, kTlKeys = 128;  // query rows of a work item, keys of a tile
constexpr int kTlStage = kTlKeys * kCbBytes;  // a column block of a key tile: 16 KB
constexpr int kTlPex = 2 * 2 * 16 * 128 * 4;  // p: 2 tile parities x 2 consumers x 16 registers
constexpr int kTlMaxStages = 8;

// d > 128 (wide): offsets in an item's shared memory of ncb column blocks
struct TiledLayout {
  int q, pex, stats, kv, bars, bytes;
};
MAED_HD inline TiledLayout tiled_layout(int ncb, int stages) {
  TiledLayout l;
  l.q = 0;
  l.pex = ncb * kBoxBytes;  // q's column blocks of the item's 64 rows
  l.stats = l.pex + kTlPex;  // row max [tile parity][consumer][64], row sum [consumer][64]
  l.kv = l.stats + 2048;
  l.bars = l.kv + stages * kTlStage;  // q full, q empty, then the ring's full and empty
  l.bytes = l.bars + (2 + 2 * stages) * 8 + 1024;  // + alignment
  return l;
}

// the wide form's stages: as many as fit, up to kTlMaxStages (5 at d 768)
inline int tiled_stages(int ncb) {
  int stages = kTlMaxStages;
  while (stages > 2 && tiled_layout(ncb, stages).bytes > kMaxSmem) --stages;
  return stages;
}

// d <= 128 (narrow): 128 query rows a work item, kTlMaxStages stages, which
// hold k's column blocks of a tile two at a time
constexpr int kNwRows = 128;
static_assert(kTlMaxStages >= 4, "the narrow form holds two tiles' column blocks");
MAED_HD inline int narrow_bytes(int ncb, int stages) {
  return ncb * 2 * kBoxBytes + stages * kTlStage + (2 + 2 * stages) * 8 + 1024;
}

// --------------------------------------------------------------------- f32

constexpr int kFtThreads = 256, kFtRows = 64, kFtKeys = 64;  // threads, query rows, keys of a tile

// rows, f32: a score width of 16G keys (S <= 16G <= 256); q's and k's
// 32-column blocks through two stages, then v's tiles of 64 keys x 192
// columns through two stages (the same memory), beside the score rows
constexpr int kRowsDc = 32, kRowsNb = 3;
template <int G>
struct F32Rows {
  static constexpr int kStage = (kFtRows + 16 * G) * (kRowsDc + 4) * 4;
  static constexpr int kVPitch = kRowsNb * kCb + 4;
  static constexpr int kVTile = kFtKeys * kVPitch * 4;
  static constexpr int kA = 2 * kStage > 2 * kVTile ? 2 * kStage : 2 * kVTile;
  static constexpr int kSPitch = 16 * G + 4;
  static constexpr int kBytes = kA + kFtRows * kSPitch * 4;
};

// tiled, f32: up to NB 64-column blocks of the output a CTA, 64-key tiles.
// With one part (d <= 384) q stays in shared memory for the item and the
// ring carries k's 64-column blocks alone; with more, q's blocks come with
// k's. A slice of v's tile comes with each block; p takes the ring's memory
// once the tile's scores are formed. The resident q and v's tile are read
// as broadcasts and as 16-byte runs of a quarter warp: no row padding.
constexpr int kFtDc = 64, kFtStages = 2;
template <int NB>
struct F32Tiled {
  static constexpr int kPitch = kFtDc + 4;                    // q's and k's column blocks
  static constexpr int kKStage = kFtKeys * kPitch * 4;
  static constexpr int kQStage = kFtRows * kPitch * 4;
  static constexpr int kWide = kCb * NB;                      // q (resident), v
  static constexpr int kV = kFtKeys * kWide * 4;
  static constexpr int kPPitch = kFtKeys + 4;
  static constexpr int kResident = kFtRows * kWide * 4 + kFtStages * kKStage + kV;
  static constexpr int kStreamed = kFtStages * (kQStage + kKStage) + kV;
};

// ------------------------------------------------------------------- plans

template <int NB>
inline int f32_tiled_bytes(int parts) {
  return parts == 1 ? F32Tiled<NB>::kResident : F32Tiled<NB>::kStreamed;
}

// The bytes of shared memory a CTA takes under the plan (kind, width, cols,
// parts) at head dim d (ops/st_attention.py::GeneralPlan; the launcher's
// argument checks), or -1 where the launcher has no such instance.
inline int general_smem(int is_bf16, int kind, int width, int cols, int parts, int d) {
  const int ncb = (d + kCb - 1) / kCb;
  if (d < 8 || d > kGnMaxD || d % 8 || parts < 1 || cols < kCb || cols % kCb ||
      parts * cols < ncb * kCb)
    return -1;
  switch (kind) {
    case kFrames:
      if (width == 16) return is_bf16 ? FramesLayout<2, 16>::kBytes : FramesLayout<4, 16>::kBytes;
      if (width == 32) return is_bf16 ? FramesLayout<2, 32>::kBytes : FramesLayout<4, 32>::kBytes;
      return -1;
    case kRows:
      if (is_bf16)
        return width == 64 || width == 128 || width == 192 || width == 200 || width == 256
                   ? kRowsBytes
                   : -1;
      switch (width) {
        case 64: return F32Rows<4>::kBytes;
        case 128: return F32Rows<8>::kBytes;
        case 192: return F32Rows<12>::kBytes;
        case 208: return F32Rows<13>::kBytes;
        case 256: return F32Rows<16>::kBytes;
      }
      return -1;
    case kTiled:
      if (is_bf16 && width == kNwRows)
        return ncb <= 2 && cols == ncb * kCb && parts == 1 ? narrow_bytes(ncb, kTlMaxStages) : -1;
      if (is_bf16)
        return width == kTlRows && (cols == 256 || cols == 384)
                   ? tiled_layout(ncb, tiled_stages(ncb)).bytes
                   : -1;
      if (width != kFtRows) return -1;
      switch (cols / kCb) {
        case 1: return f32_tiled_bytes<1>(parts);
        case 2: return f32_tiled_bytes<2>(parts);
        case 3: return f32_tiled_bytes<3>(parts);
        case 4: return f32_tiled_bytes<4>(parts);
        case 5: return f32_tiled_bytes<5>(parts);
        case 6: return f32_tiled_bytes<6>(parts);
      }
      return -1;
  }
  return -1;
}

}  // namespace maed_general
