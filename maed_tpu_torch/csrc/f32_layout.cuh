// The shared-memory layouts and thread maps of the f32 kernels on the CUDA
// cores: the GEMM of C, D and E (ln_mlp.cu, gemm_f32_kernel), E's gate
// product (gate_alpha_f32_kernel), the spatial
// attention at head dims up to 128 (st_attention.cu, spatial_f32_kernel),
// the blocked attention (blocked_f32_kernel) and the temporal attention
// (temporal_f32_kernel), with the plans their launchers take each call's
// instance and bytes from. Plain C++ (no CUDA header), so that a host
// compiler reads the same layout: tests/test_torch_port_f32_kernels.py and
// tests/test_torch_port_f32_attention.py compile it on the CPU and hold every
// plan to the shared memory a CTA may use and the residency it claims, and
// each thread map to writing every output row and column once.
#pragma once

#ifdef __CUDACC__
#define MAED_F32_HD __host__ __device__
#else
#define MAED_F32_HD
#endif

namespace maed_f32 {

constexpr int kMaxSmem = 232448;  // shared memory a block may use on the H100
constexpr int kSmSmem = 233472;   // an SM's shared memory, 1 KB of it reserved per CTA

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

// ------------------------------------------------------------------- gate
//
// E's gate product, logits (BT, K = 2C) = means (BT, K) x w_ts^T + b_ts, each
// (2c, 2c + 1) pair then softmaxed (gate_alpha_f32_kernel<kVec, TM>). BT is
// small (128 frames at the flagship, 16 for one clip), so the grid is cut
// along k as well: a CTA of 256 threads takes a tile of gate_bm(TM) = 32 TM
// frames x kGaBN logits over one of `splits` runs of k-steps, and the splits
// of a tile are one thread-block cluster, which sums their partial tiles
// through distributed shared memory in rank order (no atomics: the same sums
// every run) and takes the pair softmax on them. k-steps of kGaBK through a
// ring of kGaStages cp.async stages, the means' and w_ts' rows K-major in
// each (pitch 36 floats, as the GEMM's); w_ts' rows of a tile lie even logits
// first, then odd ones (gate_w_row), so that the float4 reads of a warp's 8
// pair lanes hit 8 bank groups. The thread of warp w and lane l holds frames
// gate_row(TM, w, l, i) (i < TM) by pairs gate_pair(l, j) (j < kGaTP), both
// logits of each, from float4 reads along k (TM + 6 reads feed 24 TM FMAs).
// The partial tile goes through shared memory with rows of kGaOutPitch
// floats (the float2 writes of a warp's 4 rows hit 32 banks twice). Two
// CTAs an SM.
constexpr int kGaThreads = 256;
constexpr int kGaBN = 48, kGaBK = 32, kGaTP = 3;  // logits a tile, k a step, pairs a thread
constexpr int kGaStages = 4;
constexpr int kGaMaxSplits = 8;  // a portable cluster
constexpr int kGaPitch = kGaBK + 4;
constexpr int kGaOutPitch = kGaBN + 8;
static_assert(2 * 8 * kGaTP == kGaBN && kGaThreads == 8 * 32,
              "8 warps along the frames, each lane's pairs 8 apart over the tile");

MAED_F32_HD constexpr int gate_bm(int tm) { return 32 * tm; }
// floats of a stage (the means' rows, then w_ts'), and the CTA's bytes: the
// ring, which the partial tile reuses
MAED_F32_HD constexpr int gate_stage(int tm) { return (gate_bm(tm) + kGaBN) * kGaPitch; }
MAED_F32_HD constexpr int gate_bytes(int tm) {
  return (kGaStages * gate_stage(tm) > gate_bm(tm) * kGaOutPitch ? kGaStages * gate_stage(tm)
                                                                 : gate_bm(tm) * kGaOutPitch) * 4;
}
static_assert(2 * (gate_bytes(4) + 1024) <= kSmSmem && 2 * (gate_bytes(2) + 1024) <= kSmSmem &&
                  2 * (gate_bytes(1) + 1024) <= kSmSmem,
              "two CTAs an SM at every tile");

// warp w takes frames 4 TM w ..; lane l frames l / 8 + 4i (i < TM) of them
// and pairs l % 8 + 8j (j < 3) of the tile
MAED_F32_HD constexpr int gate_row(int tm, int warp, int lane, int i) {
  return 4 * tm * warp + lane / 8 + 4 * i;
}
MAED_F32_HD constexpr int gate_pair(int lane, int j) { return lane % 8 + 8 * j; }
// the shared-memory row of a tile's logit n (< kGaBN)
MAED_F32_HD constexpr int gate_w_row(int n) { return n % 2 * (kGaBN / 2) + n / 2; }

struct GatePlan {
  int tm;       // frames a thread: the instance (1, 2 or 4)
  int tiles_m;  // frame tiles of gate_bm(tm)
  int tiles_n;  // logit tiles
  int splits;   // CTAs a tile: a cluster along x
  int steps;    // k-steps a split (the last split may take fewer)
  int rows;     // rows of a tile each member of the cluster reduces
  int bytes;    // shared memory
};

// The grid of a call of BT frames and K = 2C logits (BT >= 1, K >= 2 even)
// on a card of `sms` SMs: the narrowest frame tile that holds BT (or 128),
// then as many splits as fill two CTAs an SM, at most max_splits (<=
// kGaMaxSplits; the launcher lowers it while the card cannot hold the
// grid's clusters at once), each at least one k-step; splits 0: no plan.
inline GatePlan gate_f32_plan(int BT, int K, int sms, int max_splits = kGaMaxSplits) {
  GatePlan p{0, 0, 0, 0, 0, 0, 0};
  if (BT < 1 || K < 2 || K % 2 || sms < 1 || max_splits < 1) return p;
  p.tm = BT <= 32 ? 1 : BT <= 64 ? 2 : 4;
  p.tiles_m = (BT + gate_bm(p.tm) - 1) / gate_bm(p.tm);
  p.tiles_n = (K + kGaBN - 1) / kGaBN;
  const int tiles = p.tiles_m * p.tiles_n, k_steps = (K + kGaBK - 1) / kGaBK;
  const int cap = max_splits < kGaMaxSplits ? max_splits : kGaMaxSplits;
  int splits = 2 * sms / tiles;
  splits = splits < 1 ? 1 : splits > cap ? cap : splits;
  splits = splits > k_steps ? k_steps : splits;
  p.steps = (k_steps + splits - 1) / splits;
  p.splits = (k_steps + p.steps - 1) / p.steps;  // none left without a k-step
  p.rows = (gate_bm(p.tm) + p.splits - 1) / p.splits;
  p.bytes = gate_bytes(p.tm);
  return p;
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

// ---------------------------------------------------------------- blocked
//
// The online softmax over any S (blocked_f32_kernel). A work item is `rows`
// query rows of one (batch, head): 128, or 64 at a padded head dim of 128.
// A persistent CTA of 256 threads keeps the item's q in shared memory and
// streams the keys in tiles of 128, K tile j then V tile j, each into the
// next slot of a ring of `stages` slots (cp.async, zeros past S and d); the
// next item's q is copied while the last V tile is multiplied. Scores: the
// thread of warp w and lane l forms rows blocked_s_row(w, l, i) (i < tm) by
// keys blocked_s_key(l, j) (j < 8) of a tile from float4 reads along d (tm +
// 8 reads feed 32 tm FMAs); a row's 128 keys lie in the 16 lanes of a half
// warp, so its max is four shuffles, and p is written to shared memory once.
// p v: the tile's keys are cut into `splits` = 128 / dp runs of dp keys, and
// thread t of run blocked_o_split(dp, t) sums rows blocked_o_row(dp, t, i) by
// columns blocked_o_col(dp, t, c) (c < 8) over its run, so that no FMA
// multiplies a padded column at d = dp; the runs' sums meet in shared memory
// once an item and leave as float4 stores (blocked_store_*). Rows of q, k, v
// and p are padded by 4 floats: the float4 reads of 8 consecutive rows hit
// 32 banks.
constexpr int kBkThreads = 256;
constexpr int kBkKeys = 128;      // keys of a tile
constexpr int kBkRowGroups = 16;  // a thread's rows lie 16 apart
constexpr int kAttMaxD = 128;  // the widest head dim of the f32 attention plans

// the head dim padded to 32, 64 or 128 (every kernel instance's)
MAED_F32_HD constexpr int padded_dim(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }
MAED_F32_HD constexpr int blocked_rows(int dp) { return dp == 128 ? 64 : 128; }
MAED_F32_HD constexpr int blocked_tm(int dp) { return blocked_rows(dp) / kBkRowGroups; }
MAED_F32_HD constexpr int blocked_splits(int dp) { return kBkKeys / dp; }
MAED_F32_HD constexpr int blocked_stages(int dp) { return dp == 32 ? 4 : dp == 64 ? 3 : 2; }
MAED_F32_HD constexpr int blocked_pitch(int dp) { return dp + 4; }
constexpr int kBkPPitch = kBkKeys + 4;

// floats of q, of a ring slot, of p (which holds the runs' sums at the end
// of an item), then the row statistics (alpha, l)
MAED_F32_HD constexpr int blocked_q_floats(int dp) { return blocked_rows(dp) * blocked_pitch(dp); }
MAED_F32_HD constexpr int blocked_slot_floats(int dp) { return kBkKeys * blocked_pitch(dp); }
MAED_F32_HD constexpr int blocked_p_floats(int dp) {
  return blocked_rows(dp) * (kBkPPitch > blocked_splits(dp) * blocked_pitch(dp)
                                 ? kBkPPitch
                                 : blocked_splits(dp) * blocked_pitch(dp));
}
MAED_F32_HD constexpr int blocked_bytes(int dp) {
  return (blocked_q_floats(dp) + blocked_stages(dp) * blocked_slot_floats(dp) +
          blocked_p_floats(dp) + 2 * blocked_rows(dp)) * 4;
}

// scores: warp w, lane l: rows 2w + l / 16 + 16 i, keys l % 16 + 16 j
MAED_F32_HD constexpr int blocked_s_row(int warp, int lane, int i) {
  return 2 * warp + lane / 16 + kBkRowGroups * i;
}
MAED_F32_HD constexpr int blocked_s_key(int lane, int j) { return lane % 16 + 16 * j; }
// a key of tile `tile` at or past S scores -inf
MAED_F32_HD constexpr bool blocked_masked(int tile, int key, int S) {
  return tile * kBkKeys + key >= S;
}
// p v: thread t in run t / (2 dp); within it, column group t % (dp / 8) and
// row group t % (2 dp) / (dp / 8): rows rg + 16 i, columns 4 cg + c (c < 4)
// and dp / 2 + 4 cg + c - 4 (c >= 4), so that 8 lanes read 32 consecutive
// floats of v
MAED_F32_HD constexpr int blocked_o_split(int dp, int t) { return t / (2 * dp); }
MAED_F32_HD constexpr int blocked_o_row(int dp, int t, int i) {
  return t % (2 * dp) / (dp / 8) + kBkRowGroups * i;
}
MAED_F32_HD constexpr int blocked_o_col(int dp, int t, int c) {
  return 4 * (t % (dp / 8)) + c / 4 * (dp / 2) + c % 4;
}
// the stores: step n of thread t takes 4 columns of a row of the item
MAED_F32_HD constexpr int blocked_store_steps(int dp) {
  return blocked_rows(dp) * dp / 4 / kBkThreads;
}
MAED_F32_HD constexpr int blocked_store_row(int dp, int t, int n) {
  return (t + kBkThreads * n) / (dp / 4);
}
MAED_F32_HD constexpr int blocked_store_col(int dp, int t, int n) {
  return (t + kBkThreads * n) % (dp / 4) * 4;
}

struct BlockedPlan {
  int dp;      // the padded head dim: the instance
  int rows;    // query rows a work item
  int tm;      // rows a thread
  int splits;  // runs of p v
  int stages;  // ring slots
  int blocks;  // work items a (batch, head)
  int tiles;   // key tiles
  int bytes;   // shared memory
  int per_sm;  // CTAs an SM holds
};

// The instance of a call of S tokens at head dim d (S >= 1, d a multiple of
// 8 up to 128); bytes 0: no instance.
inline BlockedPlan blocked_f32_plan(int S, int d) {
  BlockedPlan p{0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (S < 1 || d < 8 || d > kAttMaxD || d % 8) return p;
  p.dp = padded_dim(d);
  p.rows = blocked_rows(p.dp);
  p.tm = blocked_tm(p.dp);
  p.splits = blocked_splits(p.dp);
  p.stages = blocked_stages(p.dp);
  p.blocks = (S + p.rows - 1) / p.rows;
  p.tiles = (S + kBkKeys - 1) / kBkKeys;
  p.bytes = blocked_bytes(p.dp);
  p.per_sm = kSmSmem / (p.bytes + 1024);
  return p;
}

// --------------------------------------------------------------- temporal
//
// The exact softmax over the T frames of each (clip, token, head)
// (temporal_f32_kernel). Every warp walks over work items of its own, one
// (clip, token, head) each, heads fastest, so that the warps of a CTA take
// neighbouring heads at once; it copies the next item's q, k and v rows
// (tp rows of dp floats, padded by 4; zeros past T and d) into one of its
// two stages with cp.async while it attends on the item in the other, and
// no barrier wider than the warp is needed. Scores: lane l forms rows
// temporal_s_row(l, i) (i < tp / 8) by keys temporal_s_key(l, j) (j < tp /
// 4) from float4 reads; a row's keys lie in a quad of lanes, so its max and
// sum are two shuffles each; p overwrites the warp's q rows (pitch tp + 4).
// p v: lane l holds columns temporal_o_col(dp, l) .. + 3 of rows
// temporal_o_row(dp, l, i) (i < tp dp / 128) and stores them as float4.
constexpr int kTpMaxT = 32;
constexpr int kTpMaxWarps = 4;

MAED_F32_HD constexpr int temporal_tp(int T) { return T <= 8 ? 8 : T <= 16 ? 16 : 32; }
MAED_F32_HD constexpr int temporal_pitch(int dp) { return dp + 4; }
MAED_F32_HD constexpr int temporal_p_pitch(int tp) { return tp + 4; }
// floats of one operand's rows, and of a warp's two stages
MAED_F32_HD constexpr int temporal_op_floats(int tp, int dp) { return tp * temporal_pitch(dp); }
MAED_F32_HD constexpr int temporal_warp_bytes(int tp, int dp) {
  return 2 * 3 * temporal_op_floats(tp, dp) * 4;
}
MAED_F32_HD constexpr int temporal_s_row(int lane, int i) { return lane / 4 + 8 * i; }
MAED_F32_HD constexpr int temporal_s_key(int lane, int j) { return lane % 4 + 4 * j; }
MAED_F32_HD constexpr int temporal_o_rows(int tp, int dp) { return tp * dp / 128; }
MAED_F32_HD constexpr int temporal_o_row(int dp, int lane, int i) {
  return lane / (dp / 4) + 128 / dp * i;
}
MAED_F32_HD constexpr int temporal_o_col(int dp, int lane) { return 4 * (lane % (dp / 4)); }

struct TemporalPlan {
  int tp;      // frames padded to 8, 16 or 32: the instance
  int dp;      // the padded head dim: the instance
  int warps;   // warps a CTA
  int bytes;   // shared memory
  int per_sm;  // CTAs an SM holds
};

// The instance of a call of T frames (1-32) at head dim d (a multiple of 8
// up to 128); bytes 0: no instance.
inline TemporalPlan temporal_f32_plan(int T, int d) {
  TemporalPlan p{0, 0, 0, 0, 0};
  if (T < 1 || T > kTpMaxT || d < 8 || d > kAttMaxD || d % 8) return p;
  p.tp = temporal_tp(T);
  p.dp = padded_dim(d);
  const int per_warp = temporal_warp_bytes(p.tp, p.dp);
  p.warps = kMaxSmem / per_warp < kTpMaxWarps ? kMaxSmem / per_warp : kTpMaxWarps;
  p.bytes = p.warps * per_warp;
  p.per_sm = kSmSmem / (p.bytes + 1024);
  return p;
}

}  // namespace maed_f32
