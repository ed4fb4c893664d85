"""The port's kernels against their plain versions on the card, at small and
ragged shapes (chip_smoke.py checks them at the flagship shapes).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run these there with:

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from maed_tpu_torch import kernels
from maed_tpu_torch.core.evaluate import Evaluator
from maed_tpu_torch.models import resnetv2 as TR
from maed_tpu_torch.models.vit import ST_MODES, Block
from maed_tpu_torch.ops import attention as TA
from maed_tpu_torch.ops import groupnorm as TGN
from maed_tpu_torch.ops import layernorm as TLN
from maed_tpu_torch.ops import mlp as TMLP
from maed_tpu_torch.ops import skinning as TK
from maed_tpu_torch.ops.metrics import eval_metrics
from maed_tpu_torch.ops.procrustes import batch_similarity_transform
from maed_tpu_torch.ops import st_attention as TST
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model
from torch_port_common import assert_close, ln_inputs, mlp_inputs, to_torch, torch_mlp_args

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels run only on the card")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize("V", [1000, 1111, 6890])
@pytest.mark.parametrize("B", [1, 3, 17, 128])
def test_skinning_kernel(cuda, B, V):
    """f32 at atol 1e-5 (m): the kernel and the einsums sum the 24 joints in
    different orders. No V is a multiple of the 384-vertex tile (1111 is
    odd); at B 128 and V 6890 the launch cuts runs of 6 frames, the last of 2."""
    rng = np.random.RandomState(4)
    W = rng.rand(V, 24)
    W /= W.sum(axis=1, keepdims=True)
    A = rng.randn(B, 24, 4, 4) * 0.3
    args = [to_torch(a, torch.float32).to(cuda) for a in (rng.randn(B, V, 3), W, A)]
    before = kernels.LAUNCHES["skinning"]
    got = TK.skinning(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["skinning"] == before + 1
    assert_close(got, TK.skinning_reference(*args), 1e-5)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-5, 0.0),
                                               (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("C", [768, 100])
def test_layernorm_kernel(cuda, dtype, atol, rtol, C):
    """bf16 at 2e-2 abs + 1e-2 rel: one bf16 rounding of outputs up to ~5."""
    x, s, b = ln_inputs(np.random.RandomState(5), (37, C))
    x = to_torch(x, dtype).to(cuda)
    s, b = (to_torch(a, torch.float32).to(cuda) for a in (s, b))
    before = kernels.LAUNCHES["layernorm"]
    got = TLN.fast_layernorm(x, s, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["layernorm"] == before + 1
    assert got.dtype == dtype
    assert_close(got.float(), TLN.layernorm_reference(x, s, b, 1e-6).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 5e-2, 2e-2)])
@pytest.mark.parametrize("M, C, H", [(256, 768, 3072), (100, 80, 176)])
def test_ln_mlp_kernel(cuda, dtype, atol, rtol, M, C, H):
    """(100, 80, 176) leaves ragged tiles on every axis: M past a 64 tile
    (f32) and short of a 128 one (bf16), N short of a 256 tile, K past a 64
    step. bf16 (the LN pre-pass, then two GEMM launches) tolerates an h
    element rounding to the neighbouring bf16 value on one side only."""
    args = torch_mlp_args(mlp_inputs(np.random.RandomState(6), (M, C), H), dtype)
    args = [a.to(cuda) for a in args]
    before = [kernels.LAUNCHES[k] for k in ("ln_rows", "ln_mlp_fc1", "ln_mlp_fc2")]
    got = TMLP.fused_ln_mlp(*args)
    torch.cuda.synchronize()
    assert [kernels.LAUNCHES[k] for k in ("ln_rows", "ln_mlp_fc1", "ln_mlp_fc2")] == \
        [before[0] + (dtype == torch.bfloat16), before[1] + 1, before[2] + 1]
    assert got.dtype == dtype
    assert_close(got.float(), TMLP.ln_mlp_reference(*args, 1e-6).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("M, C, O", [(256, 768, 2304), (100, 80, 176)])
def test_ln_dense_kernel(cuda, dtype, atol, rtol, M, C, O):
    """The qkv projection's kernel; (100, 80, 176) is ragged on every axis.
    bf16 at 2e-2 abs + 1e-2 rel: one bf16 rounding of outputs up to ~5."""
    x, s, b, w, bw = mlp_inputs(np.random.RandomState(8), (M, C), O)[:5]
    args = [to_torch(a, dt).to(cuda) for a, dt in
            ((x, dtype), (s, torch.float32), (b, torch.float32), (w.T, dtype),
             (bw, torch.float32))]
    before = kernels.LAUNCHES["ln_rows"], kernels.LAUNCHES["ln_dense"]
    got = TMLP.fused_ln_dense(*args)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["ln_rows"], kernels.LAUNCHES["ln_dense"]) == \
        (before[0] + (dtype == torch.bfloat16), before[1] + 1)
    assert got.dtype == dtype and got.shape == (M, O)
    assert_close(got.float(), TMLP.ln_dense_reference(*args, 1e-6).float(), atol, rtol)


# bf16 limits of one GEMM launch by epilogue: one rounding of outputs up to
# ~5 (bias, gelu); for the residual, v rounded and then x + v rounded, where
# a v one step off moves the sum by that step (C's limit)
DENSE_LIMITS = {"bias": (2e-2, 1e-2), "gelu": (2e-2, 1e-2), "residual": (5e-2, 2e-2)}


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
@pytest.mark.parametrize("K", [8, 80, 776, 3072])
@pytest.mark.parametrize("N", [8, 176, 264, 2304])
@pytest.mark.parametrize("M", [1, 63, 100, 256, 8500])
def test_dense_kernel(cuda, M, N, K, epilogue):
    """The bf16 TMA + wgmma GEMM of C and D against its plain version at
    ragged shapes: M one row, short of and past a 64-row consumer half, two
    whole 128-row tiles, and 67 tiles (8500), which with N = 2304 make 603
    output tiles, so that a persistent CTA takes several in turn; N a single
    8-column group, short of a 256 tile, just past one, and 9 whole ones (the
    qkv width); K short of one 64-wide k-step, past one, past 12 (776) and 48
    (3072). It counts under the kernel whose product it is."""
    rng = np.random.RandomState(M * 7 + N + K)
    a = to_torch(rng.randn(M, K), torch.bfloat16).to(cuda)
    w = to_torch(rng.randn(N, K) / np.sqrt(K), torch.bfloat16).to(cuda)
    b = to_torch(rng.randn(N) * 0.1, torch.float32).to(cuda)
    res = to_torch(rng.randn(M, N), torch.bfloat16).to(cuda) if epilogue == "residual" else None
    count = {"bias": "ln_dense", "gelu": "ln_mlp_fc1", "residual": "ln_mlp_fc2"}[epilogue]
    before = dict(kernels.LAUNCHES)
    got = TMLP.dense(a, w, b, epilogue, res)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(before, **{count: before[count] + 1})
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    want = TMLP.dense_reference(a, w, b, epilogue, res)
    assert_close(got.float(), want.float(), *DENSE_LIMITS[epilogue])


@pytest.mark.parametrize("M, C", [(1, 8), (63, 80), (100, 768), (300, 776), (37, 3072)])
def test_ln_rows_kernel(cuda, M, C):
    """The bf16 LN pre-pass against its plain version within one bf16 step
    of each output (2^-7 of it): the f32 statistics are summed in another
    order, which may move a value across a rounding boundary. C of one
    16-byte chunk, past one 256-element sweep of a warp (776), several."""
    x, s, b = ln_inputs(np.random.RandomState(M + C), (M, C))
    x = to_torch(x, torch.bfloat16).to(cuda)
    s, b = (to_torch(a, torch.float32).to(cuda) for a in (s, b))
    before = kernels.LAUNCHES["ln_rows"]
    got = TMLP.ln_rows(x, s, b, 1e-6)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ln_rows"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, C)
    assert_close(got.float(), TMLP.ln_rows_reference(x, s, b, 1e-6).float(), 1e-6, 2.0 ** -7)


def test_dense_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    launches = dict(kernels.LAUNCHES)
    a, w, b = (torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16),
               torch.zeros(8, 16, device=cuda, dtype=torch.bfloat16), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):  # f32: the pre-pass is the bf16 path's
        TMLP.ln_rows(a.float(), torch.ones(16, device=cuda), b.repeat(2))
    with pytest.raises(ValueError):  # C = 12 is not a multiple of 8
        TMLP.ln_rows(a[:, :12].contiguous(), torch.ones(12, device=cuda),
                     torch.zeros(12, device=cuda))
    with pytest.raises(ValueError):  # the residual epilogue without a residual
        TMLP.dense(a, w, b, "residual")
    with pytest.raises(ValueError):  # a residual of another shape
        TMLP.dense(a, w, b, "residual", torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # N = 12 is not a multiple of 8
        TMLP.dense(a, torch.zeros(12, 16, device=cuda, dtype=torch.bfloat16),
                   torch.zeros(12, device=cuda))
    with pytest.raises(ValueError):  # w in another dtype
        TMLP.dense(a, w.float(), b)
    with pytest.raises(ValueError):  # f32: there the GEMM of C and D normalizes its own A
        TMLP.dense(a.float(), w.float(), b)
    with pytest.raises(ValueError):  # an unknown epilogue
        TMLP.dense(a, w, b, "relu")
    assert kernels.LAUNCHES == launches


# the launches of one fused_gate_proj, by dtype
GATE_LAUNCHES = {torch.float32: ("gate_means", "gate_alpha", "gate_proj"),
                 torch.bfloat16: ("gate_means", "gate_alpha", "gate_blend", "gate_proj")}


def gate_inputs(rng, BT, N, C, dtype, device):
    """y_s, y_t, x, w_ts, b_ts, w_p, b_p of the attention's tail."""
    return [to_torch(a, dt).to(device) for a, dt in (
        (rng.randn(BT, N, C), dtype), (rng.randn(BT, N, C) + 0.3, dtype),
        (rng.randn(BT, N, C), dtype), (rng.randn(2 * C, 2 * C) / np.sqrt(2 * C), dtype),
        (rng.randn(2 * C) * 0.1, torch.float32), (rng.randn(C, C) / np.sqrt(C), dtype),
        (rng.randn(C) * 0.1, torch.float32))]


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 3e-2, 2e-2)])
@pytest.mark.parametrize("BT, N, C", [(4, 197, 768), (3, 37, 80), (5, 1, 8), (2, 130, 264),
                                      (1, 197, 768), (128, 197, 768), (3, 197, 256),
                                      (3, 50, 256), (65, 3, 16)])
def test_gate_proj_kernel(cuda, dtype, atol, rtol, BT, N, C):
    """The attention's tail, one C call of three (f32) or four (bf16)
    launches; a 128-row GEMM tile spans frames (N 37, 50, 130, 197), C past
    a 32 step and a 128 tile (80, 264), BT one frame, 65 and 128 (past one
    and at two 64-frame tiles of the gate's product), the flagship shape.
    alpha at 1e-6 (f32) or one bf16 step of a probability (4e-3). The output
    in bf16 at 3e-2 abs + 2e-2 rel: an alpha that rounds to the neighbouring
    bf16 value moves a whole frame's blend by 2^-8 of it before the proj's
    sum of C terms."""
    args = gate_inputs(np.random.RandomState(12), BT, N, C, dtype, cuda)
    before = dict(kernels.LAUNCHES)
    got, alpha = TMLP.fused_gate_proj(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(before, **{k: before[k] + 1 for k in GATE_LAUNCHES[dtype]})
    assert got.dtype == dtype and got.shape == (BT, N, C) and alpha.shape == (BT, 1, C, 2)
    want, want_alpha = TMLP.gate_proj_reference(*args)
    assert_close(alpha.float(), want_alpha.float(), 1e-6 if dtype == torch.float32 else 4e-3)
    assert_close(got.float(), want.float(), atol, rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BT, N, C", [(1, 197, 768), (3, 37, 80), (65, 197, 256),
                                      (128, 197, 768)])
def test_gate_pieces(cuda, dtype, BT, N, C):
    """E's pieces one launch each against their plain versions: the means
    within one step of the dtype (2^-8 relative in bf16: the f32 sums are
    taken in another order), alpha from the same means at the limits of
    test_gate_proj_kernel, the blend from the same alpha bit for bit (each
    product and the sum rounded as the plain version rounds them), and the
    GEMM's "proj" epilogue, counted under gate_proj, at C's fc2 limits."""
    y_s, y_t, x, w_ts, b_ts, w_p, b_p = gate_inputs(np.random.RandomState(BT + N + C), BT, N, C,
                                                    dtype, cuda)
    means = TMLP.gate_means(y_s, y_t)
    want = TMLP.gate_means_reference(y_s, y_t)
    assert means.shape == (BT, 2 * C) and means.dtype == dtype
    assert_close(means.float(), want.float(), 1e-6, 0.0 if dtype == torch.float32 else 2.0 ** -8)
    alpha = TMLP.gate_alpha(want, w_ts, b_ts)
    assert alpha.shape == (BT, 1, C, 2) and alpha.dtype == dtype
    assert_close(alpha.float(), TMLP.gate_alpha_reference(want, w_ts, b_ts).float(),
                 1e-6 if dtype == torch.float32 else 4e-3)
    if dtype == torch.float32:
        with pytest.raises(ValueError):  # in f32 the GEMM blends its own A tile
            TMLP.gate_blend(y_s, y_t, alpha)
        return
    y = TMLP.gate_blend(y_s, y_t, alpha)
    assert torch.equal(y, TMLP.gate_blend_reference(y_s, y_t, alpha))
    before = kernels.LAUNCHES["gate_proj"]
    got = TMLP.dense(y, w_p, b_p, "proj", x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gate_proj"] == before + 1
    assert_close(got.float(), TMLP.dense_reference(y, w_p, b_p, "proj", x).float(),
                 *DENSE_LIMITS["residual"])


def test_gate_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    launches = dict(kernels.LAUNCHES)
    bf = torch.bfloat16
    y = torch.zeros(2, 5, 16, device=cuda, dtype=bf)
    w_ts, b_ts = torch.zeros(32, 32, device=cuda, dtype=bf), torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):  # C = 12 is not a multiple of 8 in bf16
        TMLP.gate_means(y[..., :12].contiguous(), y[..., :12].contiguous())
    with pytest.raises(ValueError):  # means of an odd width
        TMLP.gate_alpha(torch.zeros(2, 31, device=cuda, dtype=bf), w_ts, b_ts)
    with pytest.raises(ValueError):  # a bf16 gate bias
        TMLP.gate_alpha(torch.zeros(2, 32, device=cuda, dtype=bf), w_ts, b_ts.to(bf))
    with pytest.raises(ValueError):  # alpha of another frame count
        TMLP.gate_blend(y, y, torch.zeros(3, 1, 16, 2, device=cuda, dtype=bf))
    with pytest.raises(ValueError):  # f32: the blend is the bf16 path's pre-pass
        TMLP.gate_blend(y.float(), y.float(), torch.zeros(2, 1, 16, 2, device=cuda))
    with pytest.raises(ValueError):  # the proj epilogue without a residual
        TMLP.dense(y, torch.zeros(16, 16, device=cuda, dtype=bf), torch.zeros(16, device=cuda),
                   "proj")
    with pytest.raises(ValueError):  # C = 100 is not a multiple of 8 in bf16
        TMLP.fused_gate_proj(*gate_inputs(np.random.RandomState(0), 2, 5, 100, bf, cuda))
    with pytest.raises(ValueError):  # no tokens
        TMLP.fused_gate_proj(*gate_inputs(np.random.RandomState(0), 2, 0, 16, bf, cuda))
    assert kernels.LAUNCHES == launches


def _channel_major(t):
    """The same (B, ..., C) values over channel-major memory."""
    return t.movedim(-1, 1).contiguous().movedim(1, -1)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("shape, groups, relu, with_res", [
    ((3, 14, 14, 64), 32, True, False),     # 2 channels a group: 16 bytes span 4 groups
    ((2, 9, 9, 64), 32, False, True),       # odd side
    ((2, 6, 10, 256), 32, True, True),      # 8 channels a group
    ((3, 7, 7, 96), 32, False, False),      # 3 channels a group: element by element
    ((2, 5, 32), 32, True, False),          # 1 channel a group, one spatial axis
    ((2, 40, 40, 1024), 32, True, False),   # 32 channels a group
])
def test_groupnorm_kernel(cuda, dtype, atol, rtol, shape, groups, relu, with_res):
    """Chunked and element-by-element paths, one and several groups a block. bf16 at
    2e-2 abs + 1e-2 rel: mul, add or an output up to ~5 rounding to the
    neighbouring bf16 value."""
    rng = np.random.RandomState(9)
    C = shape[-1]
    x, res, s, b = groupnorm_inputs(rng, shape, dtype, with_res, cuda)
    hw = int(np.prod(shape[1:-1]))
    cluster = dtype == torch.bfloat16 and TGN.cluster_size(hw, C, groups) is not None
    count = "groupnorm" if cluster else "groupnorm_strided"
    before = dict(kernels.LAUNCHES)
    got = TGN.fused_groupnorm(x, s, b, groups, 1e-5, relu, res)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(before, **{count: before[count] + 1})
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    want = TGN.groupnorm_reference(x, s, b, groups, 1e-5, relu, res)
    assert_close(got.float(), want.float(), atol, rtol)


def groupnorm_inputs(rng, shape, dtype, with_res, device):
    """x, the residual (or None), scale and bias."""
    C = shape[-1]
    x = to_torch(rng.randn(*shape) * 2 + 0.5, dtype).to(device)
    res = to_torch(rng.randn(*shape), dtype).to(device) if with_res else None
    s, b = (to_torch(a, torch.float32).to(device) for a in (rng.rand(C) + 0.5, rng.randn(C) * 0.1))
    return x, res, s, b


# (shape, groups) of the cluster kernel's card test
CLUSTER_SHAPES = [
    ((2, 7, 9, 256), 32),    # 63 pixels: no cluster divides them
    ((3, 5, 64), 32),        # 5 pixels: 4 CTAs take 2, 2, 1 and 0 (no cluster of 8)
    ((2, 28, 28, 128), 32),  # the stage-2 norm2 shape at 2 frames
    ((2, 4, 4, 2048), 32),   # 256 16-byte columns: a pass of the block is one pixel
    ((2, 6, 6, 8), 8),       # one 16-byte column, one channel a group
    ((2, 9, 9, 512), 8),     # 64 channels a group
]


@pytest.mark.parametrize("relu, with_res", [(False, False), (True, False), (True, True),
                                            (False, True)])
@pytest.mark.parametrize("ranks, shape, groups", [
    (ranks, shape, groups) for shape, groups in CLUSTER_SHAPES for ranks in TGN.CLUSTERS
    if TGN.cluster_fits(int(np.prod(shape[1:-1])), shape[-1], groups, ranks)])
def test_groupnorm_cluster_kernel(cuda, ranks, shape, groups, relu, with_res):
    """The bf16 cluster kernel at each cluster size that fits the shape,
    pixels shared unevenly (or not at all) among the CTAs, at the limits of
    test_groupnorm_kernel."""
    hw = int(np.prod(shape[1:-1]))
    x, res, s, b = groupnorm_inputs(np.random.RandomState(ranks + hw), shape, torch.bfloat16,
                                    with_res, cuda)
    before = kernels.LAUNCHES["groupnorm"]
    got = TGN.cluster_groupnorm(x, s, b, groups, 1e-5, relu, res, ranks=ranks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["groupnorm"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = TGN.groupnorm_reference(x, s, b, groups, 1e-5, relu, res)
    assert_close(got.float(), want.float(), 2e-2, 1e-2)


# the stem's GroupNorm sites at 224 px: (side, channels, ReLU, residual)
STEM_GROUPNORMS = [(112, 64, True, False), (56, 64, True, False), (56, 256, False, False),
                   (56, 256, True, True), (56, 128, True, False), (28, 128, True, False),
                   (28, 512, False, False), (28, 512, True, True), (28, 256, True, False),
                   (14, 256, True, False), (14, 1024, False, False), (14, 1024, True, True)]


@pytest.mark.parametrize("site", STEM_GROUPNORMS)
def test_groupnorm_at_the_stem_shapes(cuda, site):
    """fused_groupnorm at every stem site, 3 frames, in bf16 (the cluster
    kernel, at the cluster the site gets) and f32 (the strided kernel)."""
    side, C, relu, with_res = site
    assert TGN.cluster_size(side * side, C, 32) is not None
    for dtype, count, atol, rtol in ((torch.bfloat16, "groupnorm", 2e-2, 1e-2),
                                     (torch.float32, "groupnorm_strided", 1e-4, 0.0)):
        x, res, s, b = groupnorm_inputs(np.random.RandomState(side + C), (3, side, side, C),
                                        dtype, with_res, cuda)
        before = kernels.LAUNCHES[count]
        got = TGN.fused_groupnorm(x, s, b, 32, 1e-5, relu, res)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[count] == before + 1
        assert_close(got.float(), TGN.groupnorm_reference(x, s, b, 32, 1e-5, relu, res).float(),
                     atol, rtol)


@pytest.mark.parametrize("shape, ranks, with_res", [
    ((40, 56, 56, 256), 8, True),    # 8 CTAs of 196 KB: ~16 clusters resident, 2-3 frames each
    ((100, 28, 28, 512), 8, False),  # 8 of 98 KB: several frames each
    ((400, 28, 28, 128), 1, True),   # one CTA of 196 KB a frame: 3 frames a CTA
    ((300, 13, 7, 1024), 4, True),   # 23 pixels a CTA, the last 22: ragged chunks
])
def test_groupnorm_cluster_kernel_loops_over_frames(cuda, shape, ranks, with_res):
    """More frames than resident clusters: each persistent cluster takes
    several, the next frame's chunks loading into the shared memory of the
    chunks already applied."""
    x, res, s, b = groupnorm_inputs(np.random.RandomState(shape[0]), shape, torch.bfloat16,
                                    with_res, cuda)
    got = TGN.cluster_groupnorm(x, s, b, 32, 1e-5, True, res, ranks=ranks)
    want = TGN.groupnorm_reference(x, s, b, 32, 1e-5, True, res)
    assert_close(got.float(), want.float(), 2e-2, 1e-2)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 5e-2, 2e-2)])
def test_bottleneck_through_the_kernels(cuda, dtype, atol, rtol):
    """A stem bottleneck with its downsample through the kernels against the
    same block through the plain versions: four GroupNorm launches, norm3
    with the shortcut as its residual and the ReLU. bf16 at 5e-2 abs + 2e-2
    rel: each of the three norms before the sum may round one value to the
    neighbouring bf16 step, which the convs carry on (outputs up to ~5)."""
    torch.manual_seed(5)
    block = TR.Bottleneck(64, 256, stride=2, has_downsample=True, dtype=dtype).to(cuda)
    for p in block.parameters():
        torch.nn.init.normal_(p, 0.0, 0.2)
    x = torch.randn(3, 64, 28, 28, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    kernels.reset_launches()
    with torch.inference_mode():
        got = block(x)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = block(x, plain=True)
    assert launches == {"groupnorm" if dtype == torch.bfloat16 else "groupnorm_strided": 4}
    assert got.shape == (3, 256, 14, 14) and got.dtype == dtype
    assert_close(got.float(), want.float(), atol, rtol)


def qkv_input(seed, BT, N, h, d, dtype, device):
    return to_torch(np.random.RandomState(seed).randn(BT, N, 3, h, d), dtype).to(device)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-5, 0.0),
                                               (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("BT, N, h, d", [(4, 197, 12, 64), (3, 37, 2, 16), (2, 70, 3, 128),
                                         (2, 130, 2, 32), (3, 37, 2, 24), (1, 1, 1, 8),
                                         (3, 1, 2, 64), (2, 64, 2, 64), (2, 65, 2, 64),
                                         (2, 256, 2, 64), (2, 257, 2, 64), (2, 577, 2, 64),
                                         (1, 1024, 2, 64)])
def test_spatial_attention_kernel(cuda, dtype, atol, rtol, BT, N, h, d):
    """Both output layouts and the (B, h, S, d) entry. N is ragged against the
    64-row query tiles and TMA boxes and against the 8-column score steps
    (197, 65, 37); one token; a full tile (64) and a full 256-key chunk; and
    the two-pass range past one chunk (257 = a last chunk of one key, 577,
    1024 = 4 chunks). bf16 is the tensor-core kernel, which takes head dims
    16, 32, 64, 128 and raises for 24 and 8; f32 takes them all. bf16 at 1e-2
    abs + 1e-2 rel: a probability or an output (below 1) rounding to the
    neighbouring value."""
    if dtype == torch.bfloat16 and d not in TST.MMA_HEAD_DIMS:
        before = dict(kernels.LAUNCHES)
        with pytest.raises(ValueError, match="tensor cores"):
            TST.spatial_attention_btc(qkv_input(10, BT, N, h, d, dtype, cuda), d ** -0.5)
        assert kernels.LAUNCHES == before
        return
    qkv = qkv_input(10, BT, N, h, d, dtype, cuda)
    scale = d ** -0.5
    before = kernels.LAUNCHES["spatial_attention"]
    btc = TST.spatial_attention_btc(qkv, scale)
    lead = TST.spatial_attention(qkv, scale)
    q, k, v = (a.transpose(1, 2).contiguous() for a in qkv.unbind(2))
    bhsd = TA.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spatial_attention"] == before + 3
    assert btc.shape == (BT, N, h * d) and lead.shape == (h, BT, N, d) and bhsd.shape == q.shape
    assert_close(btc.float(), TST.spatial_reference_btc(qkv, scale).float(), atol, rtol)
    assert_close(lead.float(), TST.spatial_reference(qkv, scale).float(), atol, rtol)
    assert_close(bhsd.float(), TA._xla_attention(q, k, v, scale).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-5, 0.0),
                                               (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("BT, T, N, h, d", [(32, 16, 197, 12, 64), (6, 3, 5, 2, 16),
                                            (4, 2, 7, 3, 128), (32, 32, 3, 1, 8),
                                            (5, 1, 7, 5, 64), (30, 15, 200, 6, 24),
                                            (34, 17, 60, 5, 128), (64, 32, 5, 3, 24),
                                            (16, 16, 1, 12, 64)])
def test_temporal_attention_kernel(cuda, dtype, atol, rtol, sliced, BT, T, N, h, d):
    """Both output layouts. T 1, 2, 3, 15, 16 (one 16-frame tile), 17, 32 (two);
    d 8, 16, 24 (padded to 16 and 32 in bf16), 64, 128; one token a frame.
    The bf16 kernel takes 4 heads a work item, or 2 or 1 where that leaves
    fewer than two items an SM: h 12 in groups of 4, 6 in 4 + 2, 5 in 2 + 2
    + 1 (T 17), and the small shapes one head an item.
    ``sliced``: q, k, v in a view of a larger projection (every other head of
    tokens 1 ..), so that no stride is the natural one."""
    qkv = qkv_input(11, BT, N, h, d, dtype, cuda)
    if sliced:
        qkv = qkv_input(11, BT, N + 1, 2 * h, d, dtype, cuda)[:, 1:, :, ::2]
    scale = d ** -0.5
    before = kernels.LAUNCHES["temporal_attention"]
    btc = TST.temporal_attention_fused(qkv, T, scale)
    lead = TST.temporal_attention(qkv, T, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["temporal_attention"] == before + 2
    assert btc.shape == (BT, N, h * d) and lead.shape == (h, BT, N, d)
    assert_close(btc.float(), TST.temporal_reference_btc(qkv, T, scale).float(), atol, rtol)
    assert_close(lead.float(), TST.temporal_reference(qkv, T, scale).float(), atol, rtol)


def coupling_views(qkv, T):
    """q, k, v (B, h, T * N, d) as in-place views of a (BT, N, 3, h, d) projection."""
    BT, N, _, h, d = qkv.shape
    return [a.transpose(1, 2) for a in qkv.view(BT // T, T * N, 3, h, d).unbind(2)]


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 2e-5, 0.0),
                                               (torch.bfloat16, 2e-3, 1e-2)])
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("S", [1025, 1088, 1152, 1576, 3152])
def test_blocked_attention_kernel(cuda, dtype, atol, rtol, in_place, d, S):
    """Kernel K against its plain version, through ``fused_attention``'s
    dispatch: S just above the one-shot limit (1025 = 8 * 128 + 1: a last
    tile of one key), 1088 (a multiple of 64 but not of the bf16 kernel's
    128-key tile), 1152 (9 whole tiles), 1576 and the coupling length 3152
    (24 * 128 + 80), on contiguous tensors and on the views of a qkv
    projection with the output written into a (BT, N, h * d) tensor. f32 at
    2e-5: the kernels' key tiles (64 in f32, 128 in bf16) and the plain
    version's 512-key blocks rescale and sum in different orders. bf16 at
    2e-3 abs + 1e-2 rel: the outputs are means of v over hundreds of keys
    (|out| ~0.05), so rel carries one bf16 step of an output and abs the
    unnormalised p that round to the neighbouring bf16 value; a last tile
    dropped or left unmasked moves outputs by ~1e-2 or more."""
    h = 3
    T = 8 if S % 8 == 0 else 1  # frames of a clip; S = T * N
    N = S // T
    qkv = qkv_input(20 + d, 2 * T, N, h, d, dtype, cuda)
    q, k, v = coupling_views(qkv, T)
    scale = d ** -0.5
    before = dict(kernels.LAUNCHES)
    if in_place:
        result = torch.empty(2 * T, N, h * d, dtype=dtype, device=cuda)
        got = TA.fused_attention(q, k, v, scale, out=result.view(2, S, h, d).transpose(1, 2))
        assert got.data_ptr() == result.data_ptr()
    else:
        q, k, v = (a.contiguous() for a in (q, k, v))
        got = TA.fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_blocked"] == before["attention_blocked"] + 1
    assert kernels.LAUNCHES["spatial_attention"] == before["spatial_attention"]
    assert got.shape == (2, h, S, d) and got.dtype == dtype
    assert_close(got.float(), TA.attention_blocked_reference(q, k, v, scale).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 2e-5, 0.0),
                                               (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("B, h, S, d", [(2, 2, 37, 16), (1, 3, 64, 128), (3, 1, 130, 32),
                                        (1, 2, 1, 64), (2, 1, 70, 24)])
def test_blocked_attention_kernel_small(cuda, dtype, atol, rtol, B, h, S, d):
    """The blocked kernel called directly below the dispatch limit: one tile,
    a full 64-row TMA box, S ragged against the 128-row and 128-key tiles
    (130: a second key tile of 2 keys and a second query block of 2 rows),
    one token; head dim 24 runs in f32 and raises in bf16 (tensor cores
    alone)."""
    rng = np.random.RandomState(30)
    q, k, v = (to_torch(rng.randn(B, h, S, d), dtype).to(cuda) for _ in range(3))
    if dtype == torch.bfloat16 and d not in TST.MMA_HEAD_DIMS:
        with pytest.raises(ValueError, match="tensor cores"):
            TA.attention_blocked(q, k, v)
        return
    got = TA.attention_blocked(q, k, v)
    torch.cuda.synchronize()
    assert_close(got.float(), TA.attention_blocked_reference(q, k, v, d ** -0.5).float(),
                 atol, rtol)
    # the two kernels compute one function: in f32 they agree to rounding
    if dtype == torch.float32:
        assert_close(got, TA.fused_attention(q, k, v), 2e-5)


def test_blocked_attention_raises_on_what_the_kernel_does_not_take(cuda):
    launches = dict(kernels.LAUNCHES)
    q = torch.zeros(1, 2, 1030, 16, device=cuda)
    with pytest.raises(ValueError):  # f16
        TA.fused_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):  # f64
        TA.fused_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):  # k with other strides than q
        TA.fused_attention(q, torch.zeros(1, 1030, 2, 16, device=cuda).transpose(1, 2), q)
    with pytest.raises(ValueError):  # head dim 12
        TA.fused_attention(*(torch.zeros(1, 2, 1030, 12, device=cuda),) * 3)
    with pytest.raises(ValueError):  # head dim not contiguous
        t = torch.zeros(1, 2, 16, 1030, device=cuda).transpose(2, 3)
        TA.fused_attention(t, t, t)
    with pytest.raises(ValueError):  # an output of another shape
        TA.fused_attention(q, q, q, out=torch.zeros(1, 2, 1030, 8, device=cuda))
    with pytest.raises(ValueError):  # (B, S, d)
        TA.fused_attention(q[0], q[0], q[0])
    assert kernels.LAUNCHES == launches


@pytest.mark.parametrize("scale", [-0.125, 0.0, 3.0])
@pytest.mark.parametrize("S", [197, 577])
def test_spatial_attention_kernel_takes_any_scale(cuda, scale, S):
    """The bf16 spatial kernel takes each row's max of the raw scores (their
    min for a negative scale) and scales it once; a zero scale is the mean of
    v. Both the one-chunk and the two-pass range, at the bf16 limit."""
    rng = np.random.RandomState(S)
    q, k, v = (to_torch(rng.randn(2, 3, S, 64), torch.bfloat16).to(cuda) for _ in range(3))
    before = kernels.LAUNCHES["spatial_attention"]
    got = TA.fused_attention(q, k, v, scale)
    assert kernels.LAUNCHES["spatial_attention"] == before + 1
    assert_close(got.float(), TA._xla_attention(q, k, v, scale).float(), 1e-2, 1e-2)


# launches of one block per st_mode, beside the MLP's (in bf16 each of
# ln_dense's and the MLP's products also has its LN pre-pass, ln_rows)
BLOCK_LAUNCHES = {
    "vanilla": {"ln_dense": 1, "spatial_attention": 1},
    "spatial": {"ln_dense": 1, "spatial_attention": 1},
    "temporal": {"layernorm": 1, "temporal_attention": 1},
    "coupling": {"ln_dense": 1, "attention_blocked": 1},
    "parallel": {"ln_dense": 1, "spatial_attention": 1, "temporal_attention": 1,
                 "gate_means": 1, "gate_alpha": 1, "gate_proj": 1},
    "series": {"ln_dense": 1, "spatial_attention": 1, "temporal_attention": 1},
}


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 1e-1, 5e-2)])
@pytest.mark.parametrize("mode", ST_MODES)
def test_block_of_every_mode_through_the_kernels(cuda, mode, dtype, atol, rtol):
    """A transformer block of each st_mode through the kernels against the
    same block through their plain versions, with the launches it makes. 8
    frames of 150 tokens in clips of 4: the coupling attention sees 600
    tokens (the one-shot kernel) and, at 300 tokens a frame, 1200 (the
    blocked one); the temporal mode hands the temporal kernel N = 1. f32 at
    1e-4 as the kernels one by one; bf16 at 1e-1 abs + 5e-2 rel: four kernels
    in a row, each with its own roundings, on outputs up to ~10."""
    torch.manual_seed(3)
    block = Block(128, 2, st_mode=mode, dtype=dtype).to(cuda)
    for p in block.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    for norm in (block.norm1, block.norm2):
        torch.nn.init.normal_(norm.weight, 1.0, 0.1)
    for N in (150, 300):
        x = torch.randn(8, N, 128, device=cuda).to(dtype)
        want_blocked = mode == "coupling" and 4 * N > TST.MAX_TOKENS
        kernels.reset_launches()
        with torch.inference_mode():
            got = block(x, 4)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            want = block(x, 4, plain=True)
        expect = dict(BLOCK_LAUNCHES[mode], ln_mlp_fc1=1, ln_mlp_fc2=1)
        if mode == "coupling" and not want_blocked:
            expect = dict(ln_dense=1, spatial_attention=1, ln_mlp_fc1=1, ln_mlp_fc2=1)
        if dtype == torch.bfloat16:
            expect["ln_rows"] = 1 + expect.get("ln_dense", 0)
            if mode == "parallel":
                expect["gate_blend"] = 1
        assert launches == expect
        assert got.shape == x.shape and got.dtype == dtype
        assert_close(got.float(), want.float(), atol, rtol)


def test_procrustes_and_metrics_on_the_card(cuda):
    """The batched 3 x 3 SVD goes through another library on the card; its U
    and V may differ in sign from the CPU's, R does not. f64 on the card
    against f64 on the CPU at 1e-9, with a mirrored set that needs the
    reflection fix; f32 on the card within 1e-4 of f64 for point sets of
    unit scale (thousands of frames, as the eval protocol hands over)."""
    rng = np.random.RandomState(40)
    S1 = rng.randn(4000, 14, 3)
    q, _ = np.linalg.qr(rng.randn(4000, 3, 3))
    S2 = 1.3 * S1 @ q + rng.randn(4000, 1, 3) + 0.05 * rng.randn(4000, 14, 3)
    S2[::7] = S1[::7] * np.array([1.0, 1.0, -1.0]) + 0.01 * rng.randn(14, 3)
    want = batch_similarity_transform(to_torch(S1), to_torch(S2))
    got = batch_similarity_transform(to_torch(S1).to(cuda), to_torch(S2).to(cuda))
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)
    got32 = batch_similarity_transform(to_torch(S1, torch.float32).to(cuda),
                                       to_torch(S2, torch.float32).to(cuda))
    assert_close(got32, want, 1e-4)
    vis = to_torch((rng.rand(4000, 14, 1) < 0.9).astype(np.float64))
    cpu = eval_metrics(to_torch(S1), to_torch(S2), vis)
    card = eval_metrics(to_torch(S1).to(cuda), to_torch(S2).to(cuda), vis.to(cuda))
    for key in cpu:
        assert_close(card[key], cpu[key], 1e-9, what=key)


def test_evaluator_uploads_sub_clips_unchanged(cuda):
    """The Evaluator on the card stages each strided sub-clip in a pinned
    buffer that it writes again in the next window batch, and uploads without
    blocking the host. With a forward whose outputs are each frame's pixel sum
    (exact in f32) the accumulators over three window batches, the last one
    ragged, equal those of the same run on the CPU bit for bit."""
    rng = np.random.RandomState(50)
    pool, seqlen, joints = 8, 2, 14

    def windows():
        for n in (2, 2, 1):
            kp3d = np.ones((n, pool, joints, 4), np.float32)
            yield {"images": rng.randint(0, 256, (n, pool, 32, 32, 3), dtype=np.uint8),
                   "kp_3d": kp3d, "kp_2d": kp3d[..., :3], "valid": rng.rand(n, pool) < 0.8,
                   "theta": np.zeros((n, pool, 85), np.float32)}

    def forward(images, jreg):
        assert jreg is None and images.dtype == torch.uint8 and images.is_contiguous()
        total = images.sum(dim=(2, 3, 4)).float()  # below 2^24
        mk = lambda *shape: total.reshape(total.shape + (1,) * len(shape)).expand(  # noqa: E731
            total.shape + shape)
        return {"verts": mk(64, 3), "kp_3d": mk(joints, 3), "kp_2d": mk(joints, 2),
                "theta": mk(85), "rotmat": mk(24, 3, 3)}

    batches = list(windows())
    runs = []
    for device in (torch.device("cpu"), cuda):
        ev = Evaluator(synthetic_smpl_model(num_verts=64, device=device))
        ev.inference(forward, batches, seqlen=seqlen, dataset_name="testset", batch_size=2,
                     verbose=False)
        runs.append({k: np.concatenate(v, axis=0) for k, v in ev.accumulators.items()})
    want, got = runs
    assert set(got) == set(want) and len(got["pred_theta"]) == sum(b["valid"].sum() for b in batches)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    frame_sums = np.concatenate([b["images"].reshape(-1, 32 * 32 * 3).sum(axis=1)[b["valid"].reshape(-1)]
                                 for b in batches])
    np.testing.assert_array_equal(got["pred_theta"][:, 0], frame_sums)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """dtype, strides, and a T or d outside the kernels' range."""
    launches = dict(kernels.LAUNCHES)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    x = torch.zeros(2, 8, 8, 64, device=cuda)
    with pytest.raises(ValueError):  # f64
        TGN.fused_groupnorm(x.double(), ones, zeros, 32, 1e-5, True)
    with pytest.raises(ValueError):  # not contiguous: a transposed view
        TGN.fused_groupnorm(x.transpose(1, 2), ones, zeros, 32, 1e-5, True)
    with pytest.raises(ValueError):  # not contiguous: channel-major memory
        TGN.fused_groupnorm(_channel_major(x), ones, zeros, 32, 1e-5, True)
    with pytest.raises(ValueError):  # bf16 scale
        TGN.fused_groupnorm(x, ones.bfloat16(), zeros, 32, 1e-5, True)
    with pytest.raises(ValueError):  # the residual in another layout
        TGN.fused_groupnorm(x, ones, zeros, 32, 1e-5, True,
                            _channel_major(torch.zeros_like(x)))
    with pytest.raises(ValueError):  # the cluster kernel takes bf16 alone
        TGN.cluster_groupnorm(x, ones, zeros, 32, 1e-5, True)
    xb = x.bfloat16()
    for ranks in (3, 32):  # a cluster of 1, 2, 4, 8 or 16 CTAs
        with pytest.raises(ValueError):
            TGN.cluster_groupnorm(xb, ones, zeros, 32, 1e-5, True, ranks=ranks)
    with pytest.raises(ValueError):  # 96 channels: 12 16-byte columns
        TGN.cluster_groupnorm(torch.zeros(2, 8, 8, 96, device=cuda, dtype=torch.bfloat16),
                              ones.repeat(2)[:96], zeros.repeat(2)[:96], 32, 1e-5, True)
    with pytest.raises(ValueError):  # a 3.2 MB frame: beyond 8 CTAs' shared memory
        TGN.cluster_groupnorm(torch.zeros(1, 40, 40, 1024, device=cuda, dtype=torch.bfloat16),
                              ones.repeat(16), zeros.repeat(16), 32, 1e-5, True)
    qkv = torch.zeros(4, 5, 3, 2, 16, device=cuda)
    with pytest.raises(ValueError):  # f16
        TST.spatial_attention(qkv.half(), 0.25)
    with pytest.raises(ValueError):  # head dim 12
        TST.spatial_attention_btc(torch.zeros(4, 5, 3, 2, 12, device=cuda), 0.25)
    with pytest.raises(ValueError):  # head dim 136
        TST.temporal_attention_fused(torch.zeros(4, 5, 3, 1, 136, device=cuda), 2, 0.25)
    with pytest.raises(ValueError):  # 33 frames
        TST.temporal_attention(torch.zeros(33, 5, 3, 2, 16, device=cuda), 33, 0.25)
    with pytest.raises(ValueError):  # 4 frames do not split into clips of 3
        TST.temporal_attention_fused(qkv, 3, 0.25)
    with pytest.raises(ValueError):  # head dim not contiguous
        TST.spatial_attention(torch.zeros(4, 5, 3, 16, 2, device=cuda).transpose(3, 4), 0.25)
    q = torch.zeros(1, 2, 5, 16, device=cuda)
    with pytest.raises(ValueError):  # k with other strides than q
        TA.fused_attention(q, torch.zeros(1, 5, 2, 16, device=cuda).transpose(1, 2), q)
    args = torch_mlp_args(mlp_inputs(np.random.RandomState(7), (16, 64), 100), torch.bfloat16)
    with pytest.raises(ValueError):  # O = 100 is not a multiple of 8
        TMLP.fused_ln_dense(*(a.to(cuda) for a in args[:5]))
    y = torch.zeros(2, 5, 16, device=cuda)
    gate = (torch.zeros(32, 32, device=cuda), torch.zeros(32, device=cuda),
            torch.zeros(16, 16, device=cuda), torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):  # a branch that is a strided view
        TMLP.fused_gate_proj(y, torch.zeros(2, 5, 32, device=cuda)[..., :16], y, *gate)
    with pytest.raises(ValueError):  # f64
        TMLP.fused_gate_proj(*(t.double() for t in (y, y, y, *gate)))
    with pytest.raises(ValueError):  # the gate's weight as flax stores half of it
        TMLP.fused_gate_proj(y, y, y, gate[0][:16], *gate[1:])
    assert kernels.LAUNCHES == launches


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """No quiet fallback: a CUDA tensor the kernel cannot take raises."""
    x = torch.zeros(4, 16, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        TLN.fast_layernorm(x, torch.ones(16, device=cuda), torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):
        TK.skinning(torch.zeros(2, 8, 3, device=cuda, dtype=torch.bfloat16),
                    torch.zeros(8, 24, device=cuda), torch.zeros(2, 24, 4, 4, device=cuda))
    # the bf16 MLP kernel moves 16-byte rows: C = 100 is not a multiple of 8
    args = torch_mlp_args(mlp_inputs(np.random.RandomState(7), (16, 100), 64), torch.bfloat16)
    with pytest.raises(ValueError):
        TMLP.fused_ln_mlp(*(a.to(cuda) for a in args))


# --- the kernels' autograd Functions on the card -------------------------------

def _leaf(rng, shape, dtype, device, scale=1.0):
    return (to_torch(rng.randn(*shape) * scale, dtype).to(device)).requires_grad_(True)


def _function_case(name, shape, dtype, device):
    """(function, plain version, arguments) of one entry point at ``shape``;
    the floating tensors among the arguments require a gradient."""
    rng = np.random.RandomState(12)
    f32 = torch.float32

    def leaf(s, dt=dtype, scale=1.0):
        return _leaf(rng, s, dt, device, scale)

    if name == "fast_layernorm":
        M, C = shape
        return TLN.fast_layernorm, TLN.layernorm_reference, (
            leaf((M, C), scale=2.0), leaf((C,), f32), leaf((C,), f32), 1e-6)
    if name == "fused_ln_dense":
        M, C, O = shape
        return TMLP.fused_ln_dense, TMLP.ln_dense_reference, (
            leaf((M, C)), leaf((C,), f32), leaf((C,), f32), leaf((O, C), scale=C ** -0.5),
            leaf((O,), f32, 0.1), 1e-6)
    if name == "fused_ln_mlp":
        M, C, H = shape
        return TMLP.fused_ln_mlp, TMLP.ln_mlp_reference, (
            leaf((M, C)), leaf((C,), f32), leaf((C,), f32), leaf((H, C), scale=C ** -0.5),
            leaf((H,), f32, 0.1), leaf((C, H), scale=H ** -0.5), leaf((C,), f32, 0.1), 1e-6)
    if name == "fused_gate_proj":
        BT, N, C = shape
        return (lambda *a: TMLP.fused_gate_proj(*a)[0]),\
            (lambda *a: TMLP.gate_proj_reference(*a)[0]), (
            leaf(shape), leaf(shape), leaf(shape), leaf((2 * C, 2 * C), scale=(2 * C) ** -0.5),
            leaf((2 * C,), f32, 0.1), leaf((C, C), scale=C ** -0.5), leaf((C,), f32, 0.1))
    if name == "spatial_attention_btc":
        return TST.spatial_attention_btc, TST.spatial_reference_btc, (
            leaf(shape), shape[-1] ** -0.5)
    if name == "temporal_attention_fused":
        T, shape = shape[0], shape[1:]
        return TST.temporal_attention_fused, TST.temporal_reference_btc, (
            leaf(shape), T, shape[-1] ** -0.5)
    if name == "fused_groupnorm":
        C = shape[-1]
        return TGN.fused_groupnorm, TGN.groupnorm_reference, (
            leaf(shape, scale=2.0), leaf((C,), f32), leaf((C,), f32, 0.1), 32, 1e-5, True,
            leaf(shape))
    if name == "skinning":
        B, V = shape
        W = rng.rand(V, 24)
        W /= W.sum(axis=1, keepdims=True)
        return TK.skinning, TK.skinning_reference, (
            leaf((B, V, 3), f32, 0.3), to_torch(W, f32).to(device), leaf((B, 24, 4, 4), f32, 0.3))
    if name in ("fused_attention", "attention_blocked"):
        reference = TA._xla_attention if name == "fused_attention" \
            else TA.attention_blocked_reference
        return TA.fused_attention, reference, (
            leaf(shape, scale=0.5), leaf(shape, scale=0.5), leaf(shape), shape[-1] ** -0.5)
    raise KeyError(name)


# (flagship shape, odd shape) of each entry point
FUNCTION_SHAPES = {
    "fast_layernorm": ((25216, 768), (37, 100)),
    "fused_ln_dense": ((25216, 768, 2304), (100, 80, 176)),
    "fused_ln_mlp": ((25216, 768, 3072), (100, 80, 176)),
    "fused_gate_proj": ((128, 197, 768), (3, 37, 80)),
    "spatial_attention_btc": ((128, 197, 3, 12, 64), (3, 37, 3, 2, 16)),
    "temporal_attention_fused": ((16, 128, 197, 3, 12, 64), (3, 6, 5, 3, 2, 16)),
    "fused_groupnorm": ((128, 56, 56, 256), (3, 5, 7, 64)),
    "skinning": ((128, 6890), (3, 1111)),
    "fused_attention": ((128, 12, 197, 64), (2, 2, 37, 16)),
    "attention_blocked": ((8, 12, 3152, 64), (2, 2, 1025, 32)),
}
# each gradient against the plain version's autograd.grad at this share of
# its largest magnitude: both are autograd through the same plain function
# on the same inputs, so they differ only where a library reduction sums in
# another order
FUNCTION_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FUNCTION_SHAPES))
def test_function_backward_on_the_card(cuda, name, dtype, odd):
    """Under grad the entry point launches what it launches without grad
    (its kernels alone, once each), its backward launches nothing, and its
    gradients are those of autograd through its plain version."""
    if name == "skinning" and dtype == torch.bfloat16:
        pytest.skip("the skinning kernel is f32 only: SMPL runs in f32 in a bf16 model")
    fn, plain, args = _function_case(name, FUNCTION_SHAPES[name][odd], dtype, cuda)
    with torch.no_grad():
        before = dict(kernels.LAUNCHES)
        fn(*args)
        torch.cuda.synchronize()
        no_grad = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert sum(no_grad.values()) > 0
    before = dict(kernels.LAUNCHES)
    out = fn(*args)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == no_grad
    assert type(out.grad_fn).__name__ == "_RecomputeBackward"
    inputs = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
    g_out = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    g_out = g_out.to(out.dtype)
    after_forward = dict(kernels.LAUNCHES)
    got = torch.autograd.grad(out, inputs, g_out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == after_forward
    want = torch.autograd.grad(plain(*args), inputs, g_out)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g).all(), i
        assert_close(g.float(), w.float(), FUNCTION_GRAD_TOL[dtype] * w.abs().max().item(),
                     what=f"{name} gradient {i}")
