"""The f32 blocked (K) and temporal (G/H) attention kernels, on the CPU.

- ``csrc/f32_layout.cuh``, the plans and thread maps that
  ``blocked_f32_kernel`` and ``temporal_f32_kernel`` and their launchers
  follow, compiled with the host's C++ compiler: every K plan (S 1, 37, 64,
  65, 1025, 3152, 4096; d 8-128) and every G/H plan (T 1-32, d 8-128) fits
  the H100's shared memory and the residency it claims, the score maps form
  each (row, key) once with a row's keys within the lanes its shuffles
  reach, keys past S (T) are masked, and the p v maps and the stores write
  each output row and column below S (T) and d exactly once.
- The plain versions the kernels are held to on the card against the JAX
  package's Pallas kernels in interpret mode in f32: K's
  ``attention_blocked_reference`` at the kernel's key tile (128) as
  ``block_k`` against ``_attention_blocked`` at 128-row and 128-key blocks,
  at atol 2e-5 (the same online-softmax steps over the same key tiles,
  summed in another order: the products over d and the p v sums over a tile
  of 128 keys, whose terms are below 1, and the rescales by alpha); G/H's
  ``temporal_reference`` and ``temporal_reference_btc`` against
  ``temporal_attention`` and ``temporal_attention_fused`` at T 1, 3, 17 and
  32, at atol 1e-5 (one exact softmax over at most 32 keys, summed in
  another order). The JAX outputs are computed once a module.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.ops import attention as JA
from maed_tpu.ops import st_attention as JST
from maed_tpu_torch import kernels as TK
from maed_tpu_torch.ops import attention as TA
from maed_tpu_torch.ops import st_attention as TST
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import assert_close, to_torch

SMEM_LIMIT = 232448  # bytes of shared memory a CTA may use on the H100
SM_SMEM = 233472     # an SM's shared memory, 1 KB of it reserved per CTA
THREADS, KEYS = 256, 128  # K: threads a CTA, keys a tile
BLOCKED_S = (1, 37, 64, 65, 1025, 3152, 4096)
HEAD_DIMS = range(8, TST.FAST_HEAD_DIM + 1, 8)


class BlockedPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in
                ("dp", "rows", "tm", "splits", "stages", "blocks", "tiles", "bytes", "per_sm")]


class TemporalPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ("tp", "dp", "warps", "bytes", "per_sm")]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """``f32_layout.cuh`` compiled for the host: the two plans and their
    thread maps."""
    tmp = tmp_path_factory.mktemp("f32_attention_layout")
    shim = tmp / "shim.cpp"
    shim.write_text(
        '#include "f32_layout.cuh"\n'
        'using namespace maed_f32;\n'
        'extern "C" BlockedPlan bplan(int S, int d) { return blocked_f32_plan(S, d); }\n'
        'extern "C" int b_s_row(int w, int l, int i) { return blocked_s_row(w, l, i); }\n'
        'extern "C" int b_s_key(int l, int j) { return blocked_s_key(l, j); }\n'
        'extern "C" int b_masked(int t, int k, int S) { return blocked_masked(t, k, S); }\n'
        'extern "C" int b_split(int dp, int t) { return blocked_o_split(dp, t); }\n'
        'extern "C" int b_o_row(int dp, int t, int i) { return blocked_o_row(dp, t, i); }\n'
        'extern "C" int b_o_col(int dp, int t, int c) { return blocked_o_col(dp, t, c); }\n'
        'extern "C" int b_steps(int dp) { return blocked_store_steps(dp); }\n'
        'extern "C" int b_st_row(int dp, int t, int n) { return blocked_store_row(dp, t, n); }\n'
        'extern "C" int b_st_col(int dp, int t, int n) { return blocked_store_col(dp, t, n); }\n'
        'extern "C" int b_p_floats(int dp) { return blocked_p_floats(dp); }\n'
        'extern "C" int b_pitch(int dp) { return blocked_pitch(dp); }\n'
        'extern "C" TemporalPlan tplan(int T, int d) { return temporal_f32_plan(T, d); }\n'
        'extern "C" int t_s_row(int l, int i) { return temporal_s_row(l, i); }\n'
        'extern "C" int t_s_key(int l, int j) { return temporal_s_key(l, j); }\n'
        'extern "C" int t_o_rows(int tp, int dp) { return temporal_o_rows(tp, dp); }\n'
        'extern "C" int t_o_row(int dp, int l, int i) { return temporal_o_row(dp, l, i); }\n'
        'extern "C" int t_o_col(int dp, int l) { return temporal_o_col(dp, l); }\n'
        'extern "C" int t_pitch(int dp) { return temporal_pitch(dp); }\n'
        'extern "C" int t_p_pitch(int tp) { return temporal_p_pitch(tp); }\n')
    lib = tmp / "f32_layout.so"
    subprocess.run([shutil.which("c++") or "g++", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(TK.CSRC_DIR), str(shim), "-o", str(lib)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.bplan.restype = BlockedPlan
    lib.tplan.restype = TemporalPlan
    return lib


def blocked_maps(layout, dp, rows, tm):
    """K's thread maps at a padded head dim: the scores' (row, key) of every
    thread, whether a row's keys share a half warp, the p v (split, row,
    column), and the stores' (row, column)."""
    scores = np.zeros((rows, KEYS), dtype=int)
    lanes_of_row = {}
    for w in range(THREADS // 32):
        for lane in range(32):
            for i in range(tm):
                row = layout.b_s_row(w, lane, i)
                lanes_of_row.setdefault(row, set()).add((w, lane // 16))
                for j in range(8):
                    scores[row, layout.b_s_key(lane, j)] += 1
    splits = KEYS // dp
    pv = np.zeros((splits, rows, dp), dtype=int)
    for t in range(THREADS):
        for i in range(tm):
            for c in range(8):
                pv[layout.b_split(dp, t), layout.b_o_row(dp, t, i), layout.b_o_col(dp, t, c)] += 1
    stores = np.zeros((rows, dp), dtype=int)
    for t in range(THREADS):
        for n in range(layout.b_steps(dp)):
            r, c = layout.b_st_row(dp, t, n), layout.b_st_col(dp, t, n)
            stores[r, c:c + 4] += 1
    return scores, lanes_of_row, pv, stores


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_blocked_plan_takes_every_shape(layout, d):
    """For S 1, 37, 64, 65, 1025, 3152 and 4096 at head dim d: one instance
    of a padded head dim, within a CTA's shared memory and the residency it
    claims; every score of an item's rows formed once, a row's keys in one
    half warp; every output column of a row summed once by exactly one run
    of p v, the runs covering the 128 keys of a tile once; key tiles and row
    blocks covering S once, keys from S on masked; every output element below
    S and d stored exactly once."""
    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    first = layout.bplan(1, d)
    rows, tm = first.rows, first.tm
    assert (first.dp, rows, 16 * tm, first.splits * dp) == (dp, 64 if dp == 128 else 128, rows, KEYS)
    scores, lanes_of_row, pv, stores = blocked_maps(layout, dp, rows, tm)
    assert (scores == 1).all() and sorted(lanes_of_row) == list(range(rows))
    assert all(len(lanes) == 1 for lanes in lanes_of_row.values())  # one half warp a row
    assert (pv == 1).all()  # each run: every (row, column) once
    assert (stores == 1).all()
    # the runs' sums fit the p region they are staged in
    assert first.splits * rows * layout.b_pitch(dp) <= layout.b_p_floats(dp)
    for S in BLOCKED_S:
        p = layout.bplan(S, d)
        case = (S, d, p.dp, p.rows, p.tm, p.splits, p.stages, p.blocks, p.tiles, p.bytes, p.per_sm)
        assert (p.dp, p.rows, p.tm, p.splits) == (dp, rows, tm, first.splits), case
        assert 0 < p.bytes <= SMEM_LIMIT and p.per_sm >= 1, case
        assert p.per_sm * (p.bytes + 1024) <= SM_SMEM, case
        assert p.stages >= 2, case
        assert p.blocks == -(-S // rows) and p.tiles == -(-S // KEYS), case
        # keys: the live ones of all tiles are 0 .. S - 1, each once
        live = [t * KEYS + k for t in range(p.tiles) for k in range(KEYS)
                if not layout.b_masked(t, k, S)]
        assert live == list(range(S)), case
        # outputs: rows below S (of every row block) and columns below d, once
        written = np.zeros((p.blocks * rows, dp), dtype=int)
        for b in range(p.blocks):
            written[b * rows:(b + 1) * rows] += stores
        stored = written[:S, :d]
        assert (stored == 1).all() and written.shape[0] >= S, case


def test_blocked_plan_refuses_what_it_lacks(layout):
    for S, d in ((0, 64), (37, 136), (37, 12), (37, 0), (-1, 64)):
        assert layout.bplan(S, d).bytes == 0, (S, d)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_temporal_plan_takes_every_shape(layout, d):
    """For T 1-32 at head dim d: one instance (frames padded to 8, 16 or 32,
    d to 32, 64 or 128), 1 to 4 warps a CTA within its shared memory and the
    residency it claims; every score formed once, a row's keys in one quad of
    lanes, keys from T on masked; p within the q rows it overwrites; every
    output row below T and column below d written once."""
    for T in range(1, TST.MAX_FRAMES + 1):
        p = layout.tplan(T, d)
        case = (T, d, p.tp, p.dp, p.warps, p.bytes, p.per_sm)
        assert p.tp == min(t for t in (8, 16, 32) if t >= T), case
        assert p.dp == (32 if d <= 32 else 64 if d <= 64 else 128), case
        assert 1 <= p.warps <= 4 and 0 < p.bytes <= SMEM_LIMIT, case
        assert p.bytes == p.warps * 2 * 3 * p.tp * layout.t_pitch(p.dp) * 4, case
        assert p.per_sm >= 1 and p.per_sm * (p.bytes + 1024) <= SM_SMEM, case
        tp, dp = p.tp, p.dp
        scores = np.zeros((tp, tp), dtype=int)
        quad = {}
        for lane in range(32):
            for i in range(tp // 8):
                row = layout.t_s_row(lane, i)
                quad.setdefault(row, set()).add(lane // 4)
                for j in range(tp // 4):
                    scores[row, layout.t_s_key(lane, j)] += 1
        assert (scores == 1).all() and all(len(q) == 1 for q in quad.values()), case
        live = sorted({layout.t_s_key(lane, j) for lane in range(32) for j in range(tp // 4)
                       if layout.t_s_key(lane, j) < T})
        assert live == list(range(T)), case
        # p (tp rows at pitch tp + 4) within the tp rows of q at pitch dp + 4
        assert (tp - 1) * layout.t_p_pitch(tp) + tp <= tp * layout.t_pitch(dp), case
        out = np.zeros((tp, dp), dtype=int)
        for lane in range(32):
            c = layout.t_o_col(dp, lane)
            for i in range(layout.t_o_rows(tp, dp)):
                out[layout.t_o_row(dp, lane, i), c:c + 4] += 1
        assert (out == 1).all(), case
        assert (out[:T, :d] == 1).all(), case


def test_temporal_plan_refuses_what_it_lacks(layout):
    for T, d in ((0, 64), (33, 64), (16, 136), (16, 12), (16, 0)):
        assert layout.tplan(T, d).bytes == 0, (T, d)


# ------------------------------------- the plain versions against the Pallas kernels

BLOCKED_SHAPES = [(1, 2, 336, 16),  # two whole key tiles and a last one of 80 keys, as 3152's
                  (2, 1, 257, 32),  # a last tile of one key
                  (1, 1, 1, 8)]     # one token
TEMPORAL_SHAPES = [(4, 3, 2, 16, 1), (6, 5, 2, 8, 3), (34, 3, 2, 16, 17), (32, 2, 2, 8, 32)]


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's f32 outputs by (kind, shape), each computed once; the inputs are
    remade from their seeds by each test."""
    cache = {}

    def get(kind, shape, args):
        if (kind, shape) not in cache:
            saved = JST._INTERPRET
            JST._INTERPRET = True
            try:
                with jax.default_matmul_precision("highest"):
                    if kind == "blocked":
                        q, k, v = (jnp.asarray(a) for a in args)
                        out = JA._attention_blocked(q, k, v, shape[-1] ** -0.5, block_q=KEYS,
                                                    block_k=KEYS)
                        cache[(kind, shape)] = np.asarray(out)
                    else:
                        qkv, T = jnp.asarray(args[0]), shape[-1]
                        scale = shape[-2] ** -0.5
                        cache[(kind, shape)] = (
                            np.asarray(JST.temporal_attention(qkv, T, scale)),
                            np.asarray(JST.temporal_attention_fused(qkv, T, scale)))
            finally:
                JST._INTERPRET = saved
        return cache[(kind, shape)]

    return get


@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_blocked_reference_at_the_kernel_tile_matches_the_pallas_kernel(jax_outputs, shape):
    """K's plain version with the kernel's 128-key tiles against the Pallas
    kernel at 128-key blocks, f32 at 2e-5."""
    rng = np.random.RandomState(sum(shape))
    args = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    want = jax_outputs("blocked", shape, args)
    q, k, v = (to_torch(a) for a in args)
    got = TA.attention_blocked_reference(q, k, v, shape[-1] ** -0.5, block_k=KEYS)
    assert got.shape == shape and got.dtype == torch.float32
    assert_close(got, want, 2e-5)
    # the wrapper takes this plain version for a CPU tensor
    assert torch.equal(TA.attention_blocked(q, k, v),
                       TA.attention_blocked_reference(q, k, v, shape[-1] ** -0.5))


@pytest.mark.parametrize("shape", TEMPORAL_SHAPES)
def test_temporal_references_match_the_pallas_kernels(jax_outputs, shape):
    """G/H's plain versions (head-leading and (BT, N, C)) against the Pallas
    kernels, f32 at 1e-5: T 1, 3, 17 (a tile of 16 and one frame) and 32."""
    BT, N, h, d, T = shape
    qkv = np.random.RandomState(BT + N + T).randn(BT, N, 3, h, d).astype(np.float32)
    want, want_btc = jax_outputs("temporal", shape, [qkv])
    got = TST.temporal_reference(to_torch(qkv), T, d ** -0.5)
    got_btc = TST.temporal_reference_btc(to_torch(qkv), T, d ** -0.5)
    assert got.shape == (h, BT, N, d) and got_btc.shape == (BT, N, h * d)
    assert_close(got, want, 1e-5)
    assert_close(got_btc, want_btc, 1e-5)
    assert torch.equal(TST.temporal_attention_fused(to_torch(qkv), T, d ** -0.5), got_btc)
