"""The f32 kernels of C, D, E and the f32 spatial attention, on the CPU.

- ``csrc/f32_layout.cuh``, the layout and plan the kernels and their
  launchers follow, compiled with the host's C++ compiler: every f32 spatial
  plan (S 1-1024, d 8-128) and the GEMM fit the H100's shared memory and
  write each output element once.
- The f32 chains as the card launches them (the LN pre-pass into the GEMM
  with the GELU, then the residual epilogue; the pre-pass into the bias
  epilogue; the gate's blend into the proj), through the port's plain
  versions, against the JAX package's Pallas kernels in interpret mode in
  f32, at the widths of the stock ViTs (768/2304, 1024/4096, 1280/5120) cut
  to a few rows. The JAX outputs are computed once a module. f32 at atol
  2e-5: the Pallas bodies and torch sum K up to 5120 products in other
  orders (outputs of magnitude ~1-5), and _mlp_kernel's A&S erf is off by
  up to 1.5e-7. The kernels themselves are held against these plain
  versions on the card by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.ops import mlp as JMLP
from maed_tpu_torch import kernels as TK
from maed_tpu_torch.ops import mlp as TMLP
from maed_tpu_torch.ops import st_attention as TST
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import assert_close, mlp_inputs, to_torch, torch_mlp_args

SMEM_LIMIT = 232448  # bytes of shared memory a CTA may use on the H100
SM_SMEM = 233472     # an SM's shared memory, 1 KB of it reserved per CTA
GROUPS = (2, 4, 8, 12, 13, 16)  # the launcher's instances of a one-tile score width (16 G keys)


class Plan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in
                ("rpt", "g", "nb", "key_tiles", "rows", "blocks", "width", "bytes")]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """``f32_layout.cuh`` compiled for the host: its spatial plan, the thread
    maps and the GEMM's bytes."""
    tmp = tmp_path_factory.mktemp("f32_layout")
    shim = tmp / "shim.cpp"
    shim.write_text(
        '#include "f32_layout.cuh"\n'
        'using namespace maed_f32;\n'
        'extern "C" SpatialPlan plan(int S, int d) { return spatial_f32_plan(S, d); }\n'
        'extern "C" int spatial_column(int b, int tx, int c) { return spatial_col(b, tx, c); }\n'
        'extern "C" int p_pitch(int rpt, int width) { return spatial_p_pitch(rpt, width); }\n'
        'extern "C" int gemm_bytes() { return kGemmBytes; }\n'
        'extern "C" int gemm_tile() { return kGemmBM * 1000 + kGemmBN; }\n'
        'extern "C" int gemm_threads() { return kGemmThreads; }\n'
        'extern "C" int gemm_thread_tile() { return kGemmTM * 1000 + kGemmTN; }\n'
        'extern "C" int row_of(int w, int l, int i) { return gemm_row(w, l, i); }\n'
        'extern "C" int col_of(int w, int l, int j) { return gemm_col(w, l, j); }\n')
    lib = tmp / "f32_layout.so"
    subprocess.run([shutil.which("c++") or "g++", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(TK.CSRC_DIR), str(shim), "-o", str(lib)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.plan.restype = Plan
    return lib


def spatial_columns(layout, nb, d):
    """How often each of the head dim's d columns is written: thread tx of
    a row writes spatial_col(b, tx, c) for b < nb, c < 4, those below d."""
    covered = np.zeros(d, dtype=int)
    for b in range(nb):
        for tx in range(16):
            for c in range(4):
                col = layout.spatial_column(b, tx, c)
                if col < d:
                    covered[col] += 1
    return covered


@pytest.mark.parametrize("d", range(8, TST.FAST_HEAD_DIM + 1, 8))
def test_f32_spatial_plan_takes_every_shape(layout, d):
    """For every S up to MAX_TOKENS at head dim d: an instance the launcher
    has, within a CTA's shared memory (two CTAs an SM where the kernel's
    launch bounds ask for two), a score row that holds S keys, row blocks
    that cover the S query rows once, and each output column written once."""
    covered = spatial_columns(layout, 1 if d <= 64 else 2, d)
    assert (covered == 1).all(), d
    for S in range(1, TST.MAX_TOKENS + 1):
        p = layout.plan(S, d)
        case = (S, d, p.rpt, p.g, p.nb, p.key_tiles, p.rows, p.blocks, p.width, p.bytes)
        assert 0 < p.bytes <= SMEM_LIMIT, case
        assert p.nb == (1 if d <= 64 else 2) and 64 * p.nb >= d, case
        if S <= 256:  # one key tile, the narrowest width that holds S, 64 rows a CTA
            assert (p.rpt, p.key_tiles) == (4, 1), case
            assert p.g == min(g for g in GROUPS if 16 * g >= S), case
            if p.g <= 13:  # __launch_bounds__(256, 2)
                assert 2 * (p.bytes + 1024) <= SM_SMEM, case
        else:  # key tiles of 256, 32 rows a CTA
            assert (p.rpt, p.g) == (2, 16) and p.key_tiles == -(-S // 256), case
        assert p.width == 16 * p.g * p.key_tiles and S <= p.width < S + 16 * p.g, case
        assert p.rows <= 16 * p.rpt and p.blocks * p.rows >= S > (p.blocks - 1) * p.rows, case
        assert p.blocks == -(-S // (16 * p.rpt)), case
        # the two rows of a warp's score writes 16 banks apart; rows float4-aligned
        pitch = layout.p_pitch(p.rpt, p.width)
        assert pitch % 4 == 0 and p.rpt * pitch % 32 == 16, case


def test_f32_spatial_plan_refuses_what_it_lacks(layout):
    for S, d in ((0, 64), (1025, 64), (197, 136), (197, 12), (197, 0)):
        assert layout.plan(S, d).bytes == 0, (S, d)


def test_f32_gemm_layout(layout):
    """The GEMM's stages and staging buffer fit a CTA, and the threads'
    outputs (8 x 8 each) cover the 128 x 128 tile once."""
    assert 0 < layout.gemm_bytes() <= SMEM_LIMIT
    assert layout.gemm_tile() == 128 * 1000 + 128
    tm, tn = divmod(layout.gemm_thread_tile(), 1000)
    assert (tm, tn) == (8, 8)
    covered = np.zeros((128, 128), dtype=int)
    for w in range(layout.gemm_threads() // 32):
        for lane in range(32):
            for i in range(tm):
                for j in range(tn):
                    covered[layout.row_of(w, lane, i), layout.col_of(w, lane, j)] += 1
    assert (covered == 1).all()


# ------------------------------------ the f32 chains against the Pallas kernels

WIDTHS = [(768, 2304), (1024, 4096), (1280, 5120)]  # (C, H): the MLP's and the dense widths
ROWS = (2, 3)  # a few rows of the tokens, cut from the model's BT x N
ATOL = 2e-5


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's f32 outputs by (function, C, H), each computed once; the inputs
    are remade from their seeds by each test."""
    cache = {}

    def get(name, C, H, args):
        if (name, C, H) not in cache:
            saved = JMLP._INTERPRET
            JMLP._INTERPRET = True
            try:
                with jax.default_matmul_precision("highest"):
                    fn = {"mlp": JMLP.fused_ln_mlp, "dense": JMLP.fused_ln_dense,
                          "gate": JMLP.fused_gate_proj}[name]
                    out = fn(*(jnp.asarray(a) for a in args))
                cache[(name, C, H)] = jax.tree_util.tree_map(np.asarray, out)
            finally:
                JMLP._INTERPRET = saved
        return cache[(name, C, H)]

    return get


def f32(args):
    return [np.asarray(a, dtype=np.float32) for a in args]


@pytest.mark.parametrize("C, H", WIDTHS)
def test_f32_ln_mlp_chain_matches_the_pallas_kernel(jax_outputs, C, H):
    """C in f32 as the card runs it: ln_rows, dense "gelu", dense "residual"."""
    args = f32(mlp_inputs(np.random.RandomState(C + H), ROWS + (C,), H))
    want = jax_outputs("mlp", C, H, args)
    x, s, b, w1, b1, w2, b2 = torch_mlp_args(args, torch.float32)
    h = TMLP.dense_reference(TMLP.ln_rows_reference(x, s, b, 1e-6), w1, b1, "gelu")
    got = TMLP.dense_reference(h, w2, b2, "residual", x)
    assert got.dtype == torch.float32 and got.shape == ROWS + (C,)
    assert_close(got, want, ATOL)
    assert torch.equal(got, TMLP.fused_ln_mlp(x, s, b, w1, b1, w2, b2))


@pytest.mark.parametrize("C, O", WIDTHS)
def test_f32_ln_dense_chain_matches_the_pallas_kernel(jax_outputs, C, O):
    """D in f32 as the card runs it: ln_rows, dense "bias"."""
    args = f32(mlp_inputs(np.random.RandomState(C + O + 1), ROWS + (C,), O)[:5])
    want = jax_outputs("dense", C, O, args)
    x, s, b, w, bw = (to_torch(a) for a in args)
    w = w.T.contiguous()
    got = TMLP.dense_reference(TMLP.ln_rows_reference(x, s, b, 1e-6), w, bw, "bias")
    assert got.dtype == torch.float32 and got.shape == ROWS + (O,)
    assert_close(got, want, ATOL)
    assert torch.equal(got, TMLP.fused_ln_dense(x, s, b, w, bw))


@pytest.mark.parametrize("C, H", WIDTHS)
def test_f32_gate_proj_chain_matches_the_pallas_kernel(jax_outputs, C, H):
    """E in f32 as the card runs it: the means, the gate, gate_blend, then
    dense "proj"; 2 frames of 3 tokens at C channels. alpha at 1e-5, as
    test_torch_port_kernels.py holds it: its logits sum 2C products in
    another order."""
    rng = np.random.RandomState(C + 2)
    BT, N = ROWS
    args = f32((rng.randn(BT, N, C), rng.randn(BT, N, C) + 0.3, rng.randn(BT, N, C),
                rng.randn(2 * C, 2 * C) / np.sqrt(2 * C), rng.randn(2 * C) * 0.1,
                rng.randn(C, C) / np.sqrt(C), rng.randn(C) * 0.1))
    want, want_alpha = jax_outputs("gate", C, H, args)
    y_s, y_t, x, w_ts, b_ts, w_p, b_p = (to_torch(a) for a in args)
    w_ts, w_p = w_ts.T.contiguous(), w_p.T.contiguous()
    alpha = TMLP.gate_alpha_reference(TMLP.gate_means_reference(y_s, y_t), w_ts, b_ts)
    y = TMLP.gate_blend_reference(y_s, y_t, alpha)
    got = TMLP.dense_reference(y, w_p, b_p, "proj", x)
    assert got.dtype == torch.float32 and got.shape == (BT, N, C)
    assert_close(alpha, want_alpha, 1e-5)
    assert_close(got, want, ATOL)
    ref, ref_alpha = TMLP.fused_gate_proj(y_s, y_t, x, w_ts, b_ts, w_p, b_p)
    assert torch.equal(got, ref) and torch.equal(alpha, ref_alpha)
