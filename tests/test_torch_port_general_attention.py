"""The yardstick of ``csrc/attention_general.cu`` on the CPU, and its host plan.

The card holds that kernel to the port's plain versions (``spatial_reference``,
``temporal_reference`` and their ``_btc`` forms, ``attention_blocked_reference``)
at the head dims it takes. Here those plain versions are held against the JAX
package at 80 and 96 (the stock ViTs' heads) and 384 (the tools' two heads):
in f32 at 1e-5 against its Pallas kernels, run in interpret mode as the JAX
package's own tests run them (dots at "highest" precision), and in f64 at
1e-9 against the softmax written out in numpy.

``ops/st_attention.py::general_plan`` picks the kernel's form and template
instance from (S, d, dtype, softmax); it is checked for every head dim the
kernel takes at the token counts the port runs: a form exists, every output
column is written once, and the shared memory fits. The last two come from
the kernel's own layout, ``csrc/general_layout.cuh``, built here with the
host's C++ compiler.
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

DIMS = (80, 96, 384)
BT, N, H, T = 4, 13, 2, 2  # frames, tokens, heads, frames a clip
# the blocked form over a clip's T * N = 26 tokens, in key blocks of 8: a tail of 2
BLOCK_Q, BLOCK_K = 16, 8


def qkv_input(d):
    return np.random.RandomState(d).randn(BT, N, 3, H, d)


def clip_views(qkv):
    """q, k, v (B, h, S, d) over each clip's T * N tokens (the coupling mode)."""
    clips = qkv.reshape(BT // T, T * N, 3, H, qkv.shape[-1])
    return [np.ascontiguousarray(np.swapaxes(clips[:, :, i], 1, 2)) for i in range(3)]


def numpy_attention(q, k, v, scale, scores, mix):
    """softmax(q k * scale) v in f64 by the two einsums."""
    logits = np.einsum(scores, q, k) * scale
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum(mix, probs / probs.sum(-1, keepdims=True), v)


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's spatial, temporal and blocked attention at each of DIMS in f32,
    computed once for the module's cases."""
    outs = {}
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(JST, "_INTERPRET", True)
        for d in DIMS:
            qkv = jnp.asarray(qkv_input(d).astype(np.float32))
            scale = d ** -0.5
            q, k, v = (jnp.asarray(a.astype(np.float32)) for a in clip_views(qkv_input(d)))
            outs[d] = {
                "spatial": JST.spatial_attention(qkv, scale),
                "temporal": JST.temporal_attention(qkv, T, scale),
                "temporal_fused": JST.temporal_attention_fused(qkv, T, scale),
                "blocked": JA._attention_blocked(q, k, v, scale, block_q=BLOCK_Q,
                                                 block_k=BLOCK_K),
            }
    return {d: {name: np.asarray(a) for name, a in out.items()} for d, out in outs.items()}


@pytest.mark.parametrize("d", DIMS)
def test_general_plain_versions_match_the_pallas_kernels(jax_outputs, d):
    """f32 at 1e-5: spatial head-leading and (BT, N, C) (the latter is F's
    output transposed), temporal in both layouts, and the blocked online
    softmax over the same key blocks as the TPU kernel."""
    want = jax_outputs[d]
    qkv = to_torch(qkv_input(d), torch.float32)
    scale = d ** -0.5
    assert_close(TST.spatial_reference(qkv, scale), want["spatial"], 1e-5)
    assert_close(TST.spatial_reference_btc(qkv, scale),
                 np.transpose(want["spatial"], (1, 2, 0, 3)).reshape(BT, N, H * d), 1e-5)
    assert_close(TST.temporal_reference(qkv, T, scale), want["temporal"], 1e-5)
    assert_close(TST.temporal_reference_btc(qkv, T, scale), want["temporal_fused"], 1e-5)
    q, k, v = (to_torch(a, torch.float32) for a in clip_views(qkv_input(d)))
    got = TA.attention_blocked_reference(q, k, v, scale, block_k=BLOCK_K)
    assert got.shape == q.shape
    assert_close(got, want["blocked"], 1e-5)


@pytest.mark.parametrize("d", DIMS)
def test_general_plain_versions_match_numpy_f64(d):
    """In f64 nothing is rounded on the way: every plain version is the
    softmax written out in numpy at 1e-9, the blocked one at any key block."""
    qkv = qkv_input(d)
    scale = d ** -0.5
    q, k, v = (qkv[:, :, i] for i in range(3))
    spatial = numpy_attention(q, k, v, scale, "bqhd,bkhd->bhqk", "bhqk,bkhd->hbqd")
    qc, kc, vc = (a.reshape(BT // T, T, N, H, d) for a in (q, k, v))
    temporal = numpy_attention(qc, kc, vc, scale, "bqnhd,bknhd->bnhqk",
                               "bnhqk,bknhd->hbqnd").reshape(H, BT, N, d)

    def btc(a):
        return np.transpose(a, (1, 2, 0, 3)).reshape(BT, N, H * d)

    t = to_torch(qkv)
    for got, want in ((TST.spatial_reference(t, scale), spatial),
                      (TST.spatial_reference_btc(t, scale), btc(spatial)),
                      (TST.temporal_reference(t, T, scale), temporal),
                      (TST.temporal_reference_btc(t, T, scale), btc(temporal))):
        assert got.dtype == torch.float64
        assert_close(got, want, 1e-9)
    qb, kb, vb = clip_views(qkv)
    exact = numpy_attention(qb, kb, vb, scale, "bhsd,bhtd->bhst", "bhst,bhtd->bhsd")
    for block_k in (BLOCK_K, 512):
        got = TA.attention_blocked_reference(to_torch(qb), to_torch(kb), to_torch(vb), scale,
                                             block_k)
        assert_close(got, exact, 1e-9)


SMEM_LIMIT = 232448  # bytes of shared memory a CTA may use on the H100


@pytest.fixture(scope="module")
def general_smem(tmp_path_factory):
    """``general_layout.cuh``'s general_smem(is_bf16, kind, width, cols,
    parts, d): a CTA's bytes of shared memory, -1 for a form the launcher
    does not have."""
    tmp = tmp_path_factory.mktemp("general_layout")
    shim = tmp / "shim.cpp"
    shim.write_text('#include "general_layout.cuh"\n'
                    'extern "C" int general_smem(int b, int k, int w, int c, int p, int d) '
                    '{ return maed_general::general_smem(b, k, w, c, p, d); }\n')
    lib = tmp / "general_layout.so"
    subprocess.run([shutil.which("c++") or "g++", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(TK.CSRC_DIR), str(shim), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib)).general_smem


def written_columns(plan, d, is_bf16):
    """The output columns [c0, c1) each part of ``plan`` (and, TILED bf16 at
    64 query rows, each of its two consumer warpgroups) writes, as the
    kernel assigns them."""
    if plan.kind != TST.TILED or plan.width == 128:  # TILED 128: the consumers split rows
        return [(0, d)]
    share = plan.cols // 2 if is_bf16 else plan.cols
    return [(c0, min(d, c0 + share))
            for part in range(plan.parts)
            for c0 in range(part * plan.cols, (part + 1) * plan.cols, share) if c0 < d]


@pytest.mark.parametrize("S", [1, 16, 17, 32, 197, 256, 1024, 1100, 3152])
def test_general_plan_takes_every_head_dim(general_smem, S):
    """For every head dim from 8 to 768 in steps of 8, both dtypes and both
    softmaxes: a form and instance the launcher has, with shared memory a
    CTA may have, and each output column written by exactly one part (and
    consumer). The exact softmax runs a warp an item up to 32 rows, in one
    pass over at most 256 keys above that, and in two passes beyond; the
    online one always tiled."""
    for d in range(8, TST.MAX_HEAD_DIM + 1, 8):
        for is_bf16 in (0, 1):
            for online in (False, True):
                plan = TST.general_plan(S, d, is_bf16, online)
                case = (S, d, is_bf16, online, plan)
                assert 0 < general_smem(is_bf16, *plan, d) <= SMEM_LIMIT, case
                covered = np.zeros(d, dtype=int)
                for c0, c1 in written_columns(plan, d, is_bf16):
                    assert 0 <= c0 < c1 <= d and c0 % 64 == 0, case
                    covered[c0:c1] += 1
                assert (covered == 1).all(), case
                if not online and S <= TST.FRAME_ROWS:
                    assert plan.kind == TST.FRAMES and plan.width in (16, 32), case
                    assert S <= plan.width and (plan.width == 16) == (S <= 16), case
                elif not online and S <= TST.ROW_KEYS:
                    assert plan.kind == TST.ROWS and S <= plan.width, case
                    widths = TST.ROW_WIDTHS[is_bf16]
                    assert plan.width == min(w for w in widths if w >= S), case
                else:
                    assert plan.kind == TST.TILED and plan.parts == -(-d // 384), case
                    narrow = bool(is_bf16) and d <= 128
                    assert plan.width == (128 if narrow else 64), case
                    assert plan.cols <= 384 and plan.cols % (128 if is_bf16 and not narrow
                                                            else 64) == 0, case


def test_general_layout_refuses_forms_it_lacks(general_smem):
    """The layout's instance table is what the launcher checks a plan
    against: widths, column counts and parts outside it give -1."""
    assert general_smem(1, TST.ROWS, 208, 384, 1, 384) == -1  # 208 is f32's width
    assert general_smem(0, TST.ROWS, 200, 384, 1, 384) == -1  # and 200 bf16's
    assert general_smem(0, TST.FRAMES, 24, 64, 1, 64) == -1
    assert general_smem(1, TST.TILED, 128, 192, 1, 192) == -1  # narrow: d <= 128
    assert general_smem(1, TST.TILED, 64, 320, 1, 320) == -1   # wide: 128-column pairs
    assert general_smem(0, TST.TILED, 64, 448, 1, 448) == -1   # f32: at most 6 blocks a part
    assert general_smem(0, TST.TILED, 64, 384, 1, 768) == -1   # columns left unwritten
    assert general_smem(0, TST.TILED, 64, 64, 1, 100) == -1    # d not a multiple of 8
