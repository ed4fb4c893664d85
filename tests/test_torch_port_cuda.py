"""The port's kernels against their plain versions on the card, at small and
ragged shapes (chip_smoke.py checks them at the flagship shapes), the
attention kernels at every head dim the JAX models form, also
inside the stage-1 model (the ResNet-50 with BatchNorm, whose only kernel
is SMPL's skinning); the native
JPEG decoder of the card's machine against cv2's pixels of the fixture
frames and its encoder's round trip, the accept tool's oracle, and the
loader's workers under a live CUDA context.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run these there with:

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

from pathlib import Path

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
    """(100, 80, 176) leaves ragged tiles on every axis: M short of a 128
    tile, N past a 128 tile (f32) and short of a 256 one (bf16), K past a 64
    step. The LN pre-pass, then two GEMM launches, in both dtypes; bf16
    tolerates an h element rounding to the neighbouring bf16 value on one
    side only."""
    args = torch_mlp_args(mlp_inputs(np.random.RandomState(6), (M, C), H), dtype)
    args = [a.to(cuda) for a in args]
    before = [kernels.LAUNCHES[k] for k in ("ln_rows", "ln_mlp_fc1", "ln_mlp_fc2")]
    got = TMLP.fused_ln_mlp(*args)
    torch.cuda.synchronize()
    assert [kernels.LAUNCHES[k] for k in ("ln_rows", "ln_mlp_fc1", "ln_mlp_fc2")] == \
        [before[0] + 1, before[1] + 1, before[2] + 1]
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
        (before[0] + 1, before[1] + 1)
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


@pytest.mark.parametrize("M, C", [(1, 8), (63, 80), (100, 768), (300, 776), (37, 3072),
                                  (5, 1024), (9, 1280), (7, 13)])
def test_ln_rows_f32_kernel(cuda, M, C):
    """The f32 LN pre-pass against its plain version at the layernorm
    kernel's f32 limit (1e-5: the same function, its statistics summed in
    another order): the widths of test_ln_rows_kernel, the stock ViTs' 1024
    and 1280 (past the rows a warp holds in registers) and 13 (no multiple
    of 4: element by element)."""
    x, s, b = ln_inputs(np.random.RandomState(M + C), (M, C))
    x = to_torch(x, torch.float32).to(cuda)
    s, b = (to_torch(a, torch.float32).to(cuda) for a in (s, b))
    before = kernels.LAUNCHES["ln_rows"]
    got = TMLP.ln_rows(x, s, b, 1e-6)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ln_rows"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, C)
    assert_close(got, TMLP.ln_rows_reference(x, s, b, 1e-6), 1e-5)


@pytest.mark.parametrize("K", [8, 80, 776, 3072])
@pytest.mark.parametrize("N", [8, 176, 264, 768, 2304, 3072])
@pytest.mark.parametrize("M", [1, 63, 100, 129, 8500, 25216])
def test_dense_f32_kernel(cuda, M, N, K):
    """The f32 GEMM of C, D and E against its plain version, every epilogue,
    at C's and D's f32 limit (1e-4): M one row, short of and past a 128-row
    tile, 67 tiles, the flagship's 25216 tokens; N a part of one 128-column
    tile, past one (176, 264), the proj's 768, the qkv's 2304, fc1's 3072; K
    short of one 32-deep k-step, past one, past 24 (776), 96. Each launch
    counts under the kernel whose product it is."""
    rng = np.random.RandomState(M * 7 + N + K)
    a = to_torch(rng.randn(M, K), torch.float32).to(cuda)
    w = to_torch(rng.randn(N, K) / np.sqrt(K), torch.float32).to(cuda)
    b = to_torch(rng.randn(N) * 0.1, torch.float32).to(cuda)
    res = to_torch(rng.randn(M, N), torch.float32).to(cuda)
    for epilogue, count in (("bias", "ln_dense"), ("gelu", "ln_mlp_fc1"),
                            ("residual", "ln_mlp_fc2"), ("proj", "gate_proj")):
        r = res if epilogue in ("residual", "proj") else None
        before = dict(kernels.LAUNCHES)
        got = TMLP.dense(a, w, b, epilogue, r)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == dict(before, **{count: before[count] + 1})
        assert got.dtype == torch.float32 and got.shape == (M, N)
        assert_close(got, TMLP.dense_reference(a, w, b, epilogue, r), 1e-4, what=epilogue)


def _misaligned(t):
    """The values of t, contiguous, 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("M, N, K", [(37, 7, 13), (130, 129, 131), (3, 3072, 5), (65, 1, 768),
                                     (100, 264, 776)])
def test_dense_f32_kernel_any_width(cuda, M, N, K):
    """f32 takes widths that are no multiple of 4 and operands 4 bytes off a
    16-byte boundary (4-byte copies, scalar stores), each epilogue at 1e-4."""
    rng = np.random.RandomState(M + N + K)
    a = _misaligned(to_torch(rng.randn(M, K), torch.float32).to(cuda))
    w = _misaligned(to_torch(rng.randn(N, K) / np.sqrt(K), torch.float32).to(cuda))
    b = to_torch(rng.randn(N) * 0.1, torch.float32).to(cuda)
    res = to_torch(rng.randn(M, N), torch.float32).to(cuda)
    for epilogue in ("bias", "gelu", "residual", "proj"):
        r = res if epilogue in ("residual", "proj") else None
        got = TMLP.dense(a, w, b, epilogue, r)
        assert_close(got, TMLP.dense_reference(a, w, b, epilogue, r), 1e-4, what=epilogue)


# the row-parallel epilogue of tensor parallelism (the product alone): fc2's
# and proj's shard shapes at tp = 2 (25216 flagship tokens, 768 outputs,
# 1536 / 384 inputs) and ragged ones
@pytest.mark.parametrize("M, N, K", [(25216, 768, 1536), (25216, 768, 384), (100, 264, 776),
                                     (63, 8, 80), (1, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_partial_epilogue(cuda, dtype, M, N, K):
    """The GEMM with the RowPartial epilogue (``dense``'s "fc2_partial" and
    "proj_partial") against its plain version, f32 at C's f32 limit (1e-4),
    bf16 at the bias epilogue's (one rounding); each launch counts under its
    own name."""
    rng = np.random.RandomState(M + N + K)
    a = to_torch(rng.randn(M, K), dtype).to(cuda)
    w = to_torch(rng.randn(N, K) / np.sqrt(K), dtype).to(cuda)
    limits = (1e-4, 0.0) if dtype == torch.float32 else DENSE_LIMITS["bias"]
    for epilogue, count in (("fc2_partial", "ln_mlp_fc2_partial"),
                            ("proj_partial", "gate_proj_partial")):
        before = dict(kernels.LAUNCHES)
        got = TMLP.dense(a, w, None, epilogue)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == dict(before, **{count: before[count] + 1})
        assert got.dtype == dtype and got.shape == (M, N)
        assert_close(got.float(), TMLP.dense_reference(a, w, None, epilogue).float(), *limits,
                     what=epilogue)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_mlp_sums_to_the_whole(cuda, dtype):
    """C split at tp = 2 in one process: tp rank 0's fused_ln_mlp on the
    first half of the hidden columns (b2 and the residual added there) and
    rank 1's fused_ln_mlp_partial on the second, each against its plain
    version at C's limits, and the two summed (in f32, rounded once) against
    the whole fused_ln_mlp at the same limits."""
    args = [a.to(cuda) for a in torch_mlp_args(mlp_inputs(np.random.RandomState(19), (197, 768),
                                                          3072), dtype)]
    x, s, b, w1, b1, w2, b2 = args
    limits = (1e-4, 0.0) if dtype == torch.float32 else (5e-2, 2e-2)
    parts = []
    for t, (fused, plain) in enumerate(((TMLP.fused_ln_mlp, TMLP.ln_mlp_reference),
                                        (TMLP.fused_ln_mlp_partial,
                                         TMLP.ln_mlp_partial_reference))):
        cols = slice(t * 1536, (t + 1) * 1536)
        part = (x, s, b, w1[cols].contiguous(), b1[cols].contiguous(), w2[:, cols].contiguous(),
                *((b2,) if t == 0 else ()))
        got = fused(*part, 1e-6)
        assert_close(got.float(), plain(*part, 1e-6).float(), *limits)
        parts.append(got.float())
    assert_close((parts[0] + parts[1]).to(dtype).float(), TMLP.fused_ln_mlp(*args).float(),
                 *limits)


@pytest.mark.parametrize("M, C, H", [(100, 1024, 4096), (100, 1280, 5120), (100, 768, 2304)])
def test_f32_block_products_at_the_stock_widths(cuda, M, C, H):
    """C, D and E in f32 at the stock ViTs' widths (C 1024 and 1280 with
    their 4C hidden, and 768 with H 2304) against their plain versions at
    their f32 limits, alpha at 1e-5 (its logits sum 2C = 2560 products at
    1280 in another order): the pre-passes and the GEMM, as the card runs
    them."""
    args = [a.to(cuda) for a in torch_mlp_args(mlp_inputs(np.random.RandomState(C), (M, C), H),
                                                torch.float32)]
    assert_close(TMLP.fused_ln_mlp(*args), TMLP.ln_mlp_reference(*args, 1e-6), 1e-4)
    x, s, b, w1, b1 = args[:5]
    assert_close(TMLP.fused_ln_dense(x, s, b, w1, b1), TMLP.ln_dense_reference(x, s, b, w1, b1,
                                                                               1e-6), 1e-4)
    gate = gate_inputs(np.random.RandomState(C + 1), 4, 25, C, torch.float32, cuda)
    got, alpha = TMLP.fused_gate_proj(*gate)
    want, want_alpha = TMLP.gate_proj_reference(*gate)
    assert_close(alpha, want_alpha, 1e-5)  # the gate's logits sum 2C products
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("M, C, H", [(100, 1024, 4096), (100, 1280, 5120), (100, 768, 2304)])
def test_bf16_block_products_at_the_stock_widths(cuda, M, C, H):
    """C and D in bf16 at the stock ViTs' widths, at test_ln_mlp_kernel's and
    test_ln_dense_kernel's bf16 limits: the pre-pass and the TMA + wgmma
    GEMM, as the card runs them."""
    args = [a.to(cuda) for a in torch_mlp_args(mlp_inputs(np.random.RandomState(C), (M, C), H),
                                                torch.bfloat16)]
    assert_close(TMLP.fused_ln_mlp(*args).float(), TMLP.ln_mlp_reference(*args, 1e-6).float(),
                 5e-2, 2e-2)
    x, s, b, w1, b1 = args[:5]
    assert_close(TMLP.fused_ln_dense(x, s, b, w1, b1).float(),
                 TMLP.ln_dense_reference(x, s, b, w1, b1, 1e-6).float(), 2e-2, 1e-2)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 2e-2, 1e-2)])
def test_ln_dense_kernel_with_a_zero_bias(cuda, dtype, atol, rtol):
    """A qkv without a bias (vit_small_patch16_224's) runs D with a zero f32
    bias, as the JAX package feeds its kernel zeros: the same answer as the
    plain product with no bias at all, at test_ln_dense_kernel's limits."""
    x, s, b, w = mlp_inputs(np.random.RandomState(9), (100, 768), 2304)[:4]
    x, w = to_torch(x, dtype).to(cuda), to_torch(w.T, dtype).to(cuda)
    s, b = (to_torch(a, torch.float32).to(cuda) for a in (s, b))
    got = TMLP.fused_ln_dense(x, s, b, w, torch.zeros(2304, device=cuda))
    xn = TMLP.ln_rows_reference(x, s, b, 1e-6).float()
    assert_close(got.float(), (xn @ w.float().t()).to(dtype).float(), atol, rtol)


def test_dense_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    launches = dict(kernels.LAUNCHES)
    a, w, b = (torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16),
               torch.zeros(8, 16, device=cuda, dtype=torch.bfloat16), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):  # f64: the kernels take f32 or bf16
        TMLP.ln_rows(a.double(), torch.ones(16, device=cuda), b.repeat(2))
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
    with pytest.raises(ValueError):  # f64: the kernels take f32 or bf16
        TMLP.dense(a.double(), w.double(), b)
    with pytest.raises(ValueError):  # an unknown epilogue
        TMLP.dense(a, w, b, "relu")
    assert kernels.LAUNCHES == launches


# the launches of one fused_gate_proj, in either dtype
GATE_LAUNCHES = ("gate_means", "gate_alpha", "gate_blend", "gate_proj")


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
    """The attention's tail, one C call of four launches; a 128-row GEMM tile spans frames (N 37, 50, 130, 197), C past
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
    assert kernels.LAUNCHES == dict(before, **{k: before[k] + 1 for k in GATE_LAUNCHES})
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
    y = TMLP.gate_blend(y_s, y_t, alpha)
    assert torch.equal(y, TMLP.gate_blend_reference(y_s, y_t, alpha))
    before = kernels.LAUNCHES["gate_proj"]
    got = TMLP.dense(y, w_p, b_p, "proj", x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gate_proj"] == before + 1
    limits = (1e-4, 0.0) if dtype == torch.float32 else DENSE_LIMITS["residual"]
    assert_close(got.float(), TMLP.dense_reference(y, w_p, b_p, "proj", x).float(), *limits)


@pytest.mark.parametrize("C", [8, 100, 768, 1024, 1280])
@pytest.mark.parametrize("BT", [1, 7, 128, 129])
def test_f32_gate_means_and_alpha_at_every_width(cuda, BT, C):
    """E's f32 means (float4 reads) and gate product (gate_f32_plan's tiles
    of 32 TM frames x 48 logits, TM 1, 2 or 4 by BT, cut along k into a
    cluster; the warps whose frames lie past BT multiply nothing) against
    their plain versions: BT one frame, short of a tile, a whole one and a
    row past it; C a 2C of 16 (one k-step, one split),
    200 (a last tile of 8 logits) and the stock widths (1536, 2048 and 2560
    logits). The means within 1e-6 (test_gate_pieces), alpha within 1e-6 up
    to C 768 (test_gate_pieces) and 1e-5 at 1024 and 1280
    (test_f32_block_products_at_the_stock_widths: 2C products summed in
    another order)."""
    y_s, y_t, _, w_ts, b_ts, _, _ = gate_inputs(np.random.RandomState(BT + C), BT, 17, C,
                                                torch.float32, cuda)
    before = kernels.LAUNCHES["gate_means"], kernels.LAUNCHES["gate_alpha"]
    means = TMLP.gate_means(y_s, y_t)
    want = TMLP.gate_means_reference(y_s, y_t)
    alpha = TMLP.gate_alpha(want, w_ts, b_ts)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["gate_means"], kernels.LAUNCHES["gate_alpha"]) == \
        (before[0] + 1, before[1] + 1)
    assert_close(means, want, 1e-6)
    assert_close(alpha, TMLP.gate_alpha_reference(want, w_ts, b_ts), 1e-6 if C <= 768 else 1e-5)


@pytest.mark.parametrize("C, offset", [(5, 0), (6, 0), (768, 1), (100, 2)])
def test_f32_gate_means_and_alpha_scalar_paths(cuda, C, offset):
    """The f32 means and gate where a float4 does not fit: C not a multiple of
    4 (5: 2C = 10 no multiple of 4 either; 6: the gate's float4 copies, the
    means' scalar reads) or operands that start off a 16-byte boundary
    (contiguous views ``offset`` floats into a buffer); limits of
    test_f32_gate_means_and_alpha_at_every_width."""
    rng = np.random.RandomState(C + offset)

    def shifted(a):
        buf = torch.zeros(a.size + offset, device=cuda)
        view = buf[offset:].view(a.shape)
        view.copy_(to_torch(a, torch.float32))
        return view

    BT, N = 9, 13
    y_s, y_t = shifted(rng.randn(BT, N, C)), shifted(rng.randn(BT, N, C) + 0.3)
    w_ts = shifted(rng.randn(2 * C, 2 * C) / np.sqrt(2 * C))
    b_ts = to_torch(rng.randn(2 * C) * 0.1, torch.float32).to(cuda)
    want = TMLP.gate_means_reference(y_s, y_t)
    assert_close(TMLP.gate_means(y_s, y_t), want, 1e-6)
    m = shifted(want.cpu().numpy())
    assert_close(TMLP.gate_alpha(m, w_ts, b_ts), TMLP.gate_alpha_reference(m, w_ts, b_ts), 1e-6)


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
    with pytest.raises(ValueError):  # f64: the kernels take f32 or bf16
        TMLP.gate_blend(y.double(), y.double(), torch.zeros(2, 1, 16, 2, device=cuda,
                                                            dtype=torch.float64))
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
    1024 = 4 chunks). bf16 is the tensor-core kernel at head dims 16, 32, 64,
    128, and the general kernel (csrc/attention_general.cu) at 24 and 8; f32
    takes them all. bf16 at 1e-2 abs + 1e-2 rel: a probability or an output
    (below 1) rounding to the neighbouring value."""
    qkv = qkv_input(10, BT, N, h, d, dtype, cuda)
    scale = d ** -0.5
    count = ("spatial_attention_general" if TST.general_head_dim(d, dtype == torch.bfloat16)
             else "spatial_attention")
    before = kernels.LAUNCHES[count]
    btc = TST.spatial_attention_btc(qkv, scale)
    lead = TST.spatial_attention(qkv, scale)
    q, k, v = (a.transpose(1, 2).contiguous() for a in qkv.unbind(2))
    bhsd = TA.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[count] == before + 3
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
                                            (16, 16, 1, 12, 64), (64, 32, 3, 2, 128),
                                            (21, 7, 1, 5, 40)])
def test_temporal_attention_kernel(cuda, dtype, atol, rtol, sliced, BT, T, N, h, d):
    """Both output layouts. T 1, 2, 3, 7, 15, 16 (one 16-frame tile), 17, 32
    (two); d 8, 16, 24 (padded to 16 and 32 in bf16, 32 in f32), 40, 64, 128;
    one token a frame. The bf16 kernel takes 4 heads a work item, or 2 or 1
    where that leaves fewer than two items an SM: h 12 in groups of 4, 6 in
    4 + 2, 5 in 2 + 2 + 1 (T 17), and the small shapes one head an item. The
    f32 kernel takes one (clip, token, head) a warp, 4 warps a CTA (2 at T 32
    and d 128, whose two stages take 101 KB a warp): 15 items (3 clips of
    one token, 5 heads) leave its last CTA a warp short.
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
    2e-5: the kernels' 128-key tiles and the plain version's 512-key blocks
    rescale and sum in different orders. bf16 at
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
                                        (1, 2, 1, 64), (2, 1, 70, 24), (2, 1, 129, 8),
                                        (1, 2, 257, 120)])
def test_blocked_attention_kernel_small(cuda, dtype, atol, rtol, B, h, S, d):
    """The blocked kernel called directly below the dispatch limit: one tile,
    a full 64-row TMA box (and the f32 kernel's 64-row item at d 128), S
    ragged against the 128-row and 128-key tiles (130: a second key tile of
    2 keys and a second query block of 2 rows; 129 and 257: a last tile of
    one key, 257 also a fifth 64-row item at d 120), one token; head dims 8,
    24 and 120 run on the f32 kernel (padded to 32 and 128), and in bf16 on
    the general kernel."""
    rng = np.random.RandomState(30)
    q, k, v = (to_torch(rng.randn(B, h, S, d), dtype).to(cuda) for _ in range(3))
    count = ("attention_blocked_general" if TST.general_head_dim(d, dtype == torch.bfloat16)
             else "attention_blocked")
    before = kernels.LAUNCHES[count]
    got = TA.attention_blocked(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[count] == before + 1
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


GENERAL_HEAD_DIMS = (8, 24, 56, 80, 96, 120, 384, 768)


def _general_count(name, d, dtype):
    """The LAUNCHES key of the kernel that takes head dim d in dtype."""
    temporal = name == "temporal_attention"
    general = TST.general_head_dim(d, dtype == torch.bfloat16, temporal=temporal)
    return f"{name}_general" if general else name


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-5, 0.0),
                                               (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("d", GENERAL_HEAD_DIMS)
@pytest.mark.parametrize("BT, N, h", [(4, 1, 2), (3, 17, 2), (3, 37, 2), (2, 197, 1),
                                      (1, 1024, 2)])
def test_spatial_attention_any_head_dim(cuda, dtype, atol, rtol, d, BT, N, h):
    """Every head dim the JAX models form (a multiple of 8 up to 768): 80 and
    96 of the stock ViTs, 384 of the tools' 2-head model, 768 of one head,
    56 and 120 (a last column block of 3 and 4 k-steps in bf16);
    the general kernel takes the ones the older kernels do not (all but 8
    and 24 in f32, all in bf16). Tokens: 1 and 17 (the general kernel's
    warp-an-item form, 17 the accept tool's 64 px), 37 and 197 (its one-pass
    form), 1024 (its two-pass form). Tolerances as
    test_spatial_attention_kernel."""
    qkv = qkv_input(40 + d, BT, N, h, d, dtype, cuda)
    scale = d ** -0.5
    count = _general_count("spatial_attention", d, dtype)
    before = kernels.LAUNCHES[count]
    btc = TST.spatial_attention_btc(qkv, scale)
    lead = TST.spatial_attention(qkv, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[count] == before + 2
    assert_close(btc.float(), TST.spatial_reference_btc(qkv, scale).float(), atol, rtol)
    assert_close(lead.float(), TST.spatial_reference(qkv, scale).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-5, 0.0),
                                               (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("d", [64, 80, 96])
@pytest.mark.parametrize("N", [577, 145])
def test_spatial_attention_at_the_stock_token_counts(cuda, dtype, atol, rtol, d, N):
    """The stock ViTs' frames: 577 tokens (384 px, patch 16) and 145 (384 px,
    patch 32) at their head dims, 64 (F/J in both dtypes), 80 and 96 (the
    general kernel in bf16, F/J's f32 kernel in f32). Tolerances as
    test_spatial_attention_kernel."""
    qkv = qkv_input(60 + d + N, 2, N, 2, d, dtype, cuda)
    scale = d ** -0.5
    count = _general_count("spatial_attention", d, dtype)
    before = kernels.LAUNCHES[count]
    got = TST.spatial_attention_btc(qkv, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[count] == before + 1
    assert_close(got.float(), TST.spatial_reference_btc(qkv, scale).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-5, 0.0),
                                               (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("d", GENERAL_HEAD_DIMS)
@pytest.mark.parametrize("BT, T, N, h, natural", [(32, 16, 5, 2, False), (34, 17, 3, 1, False),
                                                   (32, 16, 5, 2, True)])
def test_temporal_attention_any_head_dim(cuda, dtype, atol, rtol, d, BT, T, N, h, natural):
    """As test_spatial_attention_any_head_dim over frames: T 16 (one
    16-row query tile) and 17 (a second tile of one row), the projection
    sliced so that no stride is the natural one, and T 16 in the qkv
    projection's natural (BT, N, 3, h, d) layout."""
    qkv = qkv_input(50 + d, BT, N + 1, 2 * h, d, dtype, cuda)
    qkv = qkv[:, :N, :, :h] if natural else qkv[:, 1:, :, ::2]
    if natural:
        qkv = qkv.contiguous()
    scale = d ** -0.5
    count = _general_count("temporal_attention", d, dtype)
    before = kernels.LAUNCHES[count]
    btc = TST.temporal_attention_fused(qkv, T, scale)
    lead = TST.temporal_attention(qkv, T, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[count] == before + 2
    assert_close(btc.float(), TST.temporal_reference_btc(qkv, T, scale).float(), atol, rtol)
    assert_close(lead.float(), TST.temporal_reference(qkv, T, scale).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 2e-5, 0.0),
                                               (torch.bfloat16, 2e-3, 1e-2)])
@pytest.mark.parametrize("d", GENERAL_HEAD_DIMS)
@pytest.mark.parametrize("S", [70, 1025, 3152])
def test_blocked_attention_any_head_dim(cuda, dtype, atol, rtol, d, S):
    """The blocked kernel's online softmax at every head dim, called
    directly (S 70: a partial key tile of the general kernel) and through
    fused_attention's dispatch with the output written in place, a strided
    view of a (B, S, h * d) result (S 1025 and the coupling mode's 3152).
    Tolerances as test_blocked_attention_kernel: the general kernel's key
    tiles (128 keys in bf16, 64 in f32) and the plain version's 512-key
    blocks move the running max at other keys."""
    h = 2
    qkv = qkv_input(60 + d, 2, S, h, d, dtype, cuda)
    q, k, v = coupling_views(qkv, 1)
    scale = d ** -0.5
    count = _general_count("attention_blocked", d, dtype)
    before = kernels.LAUNCHES[count]
    if S > TST.MAX_TOKENS:
        result = torch.empty(2, S, h * d, dtype=dtype, device=cuda)
        got = TA.fused_attention(q, k, v, scale, out=result.view(2, S, h, d).transpose(1, 2))
        assert got.data_ptr() == result.data_ptr()
    else:
        got = TA.attention_blocked(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[count] == before + 1
    assert_close(got.float(), TA.attention_blocked_reference(q, k, v, scale).float(), atol, rtol)


@pytest.mark.parametrize("d", [12, 776, 1024])
def test_attention_refuses_head_dims_outside_the_rule(cuda, d):
    """A head dim that is not a multiple of 8, or above 768, raises in both
    dtypes and every kernel, and the message says what the kernels take."""
    launches = dict(kernels.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.zeros(4, 5, 3, 1, d, device=cuda, dtype=dtype)
        for call in (lambda: TST.spatial_attention(qkv, 0.25),
                     lambda: TST.temporal_attention_fused(qkv, 2, 0.25),
                     lambda: TA.attention_blocked(*coupling_views(qkv, 4))):
            with pytest.raises(ValueError, match="multiple of 8 from 8 to 768"):
                call()
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


# launches of one block per st_mode, beside the MLP's (each of ln_dense's and
# the MLP's products also has its LN pre-pass, ln_rows; E its blend)
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
        expect["ln_rows"] = 1 + expect.get("ln_dense", 0)
        if mode == "parallel":
            expect["gate_blend"] = 1
        assert launches == expect
        assert got.shape == x.shape and got.dtype == dtype
        assert_close(got.float(), want.float(), atol, rtol)


def stage1_model(monkeypatch, device, decoder, dtype=torch.float32):
    """The stage-1 MAED (cnn + ``decoder``) with a narrow ResNet-50 (patched
    into its module) and seeded weights on ``device``, in eval mode."""
    import functools

    from maed_tpu_torch.core.builder import empty_model, init_weights_
    from maed_tpu_torch.models import maed as maed_module
    from maed_tpu_torch.models.resnet import ResNet50

    monkeypatch.setattr(maed_module, "ResNet50", functools.partial(
        ResNet50, layers=(1, 1, 1, 1), channels=(32, 64, 128, 256)))
    model = empty_model(device, encoder="cnn", decoder=decoder, hidden_dim=64, dtype=dtype)
    init_weights_(model, 3)
    return model.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoder", ["ktd", "iterative"])
def test_stage1_model_through_the_kernels(cuda, monkeypatch, decoder, dtype):
    """The stage-1 model's eval forward (2 clips x 4 frames at 64 px) launches
    kernel A once and nothing else, and agrees with its plain forward: the
    ResNet runs the same cuDNN calls on both paths and SMPL runs in f32 in
    either dtype, so verts and kp_3d within 1e-4 m and theta within 1e-3,
    as f32 forwards through the kernels are held."""
    model = stage1_model(monkeypatch, cuda, decoder, dtype)
    smpl = synthetic_smpl_model(6890, 0, device=cuda)
    clips = torch.randint(0, 256, (2, 4, 64, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1)).to(cuda)
    kernels.reset_launches()
    got = model(clips, smpl)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"skinning": 1}
    want = model(clips, smpl, plain=True)
    for key, atol in (("verts", 1e-4), ("kp_3d", 1e-4), ("theta", 1e-3)):
        assert torch.isfinite(got[key]).all(), key
        assert_close(got[key], want[key], atol)


@pytest.mark.parametrize("decoder", ["ktd", "iterative"])
def test_stage1_train_forward_through_the_kernels(cuda, monkeypatch, decoder):
    """A training forward of the stage-1 model in f32 (8 images at 64 px, the
    decoder's dropout from one generator seed on both paths): through kernel
    A (one launch; its backward is the plain version's, no launch) and
    through its plain version, from the same weights and running
    statistics. The statistics after it equal bit for bit (the ResNet does
    not reach A), and the gradient of a loss on verts and theta lies within
    1e-4 relative L2 of the plain one."""
    model = stage1_model(monkeypatch, cuda, decoder).train()
    smpl = synthetic_smpl_model(6890, 0, device=cuda)
    frames = torch.randint(0, 256, (8, 1, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2)).to(cuda)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for plain in (False, True):
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        kernels.reset_launches()
        out = model(frames, smpl, plain=plain, generator=torch.Generator(cuda).manual_seed(5))
        loss = out["verts"].square().mean() + out["theta"].square().mean()
        loss.backward()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        assert launches == ({} if plain else {"skinning": 1})
        runs.append((torch.cat([p.grad.reshape(-1) for p in model.parameters()]),
                     {k: v.clone() for k, v in model.state_dict().items() if "running" in k}))
    (grad, stats), (plain_grad, plain_stats) = runs
    assert not torch.equal(stats["encoder.bn1.running_var"], start["encoder.bn1.running_var"])
    for k, v in stats.items():
        assert torch.equal(v, plain_stats[k]), k
    assert ((grad - plain_grad).norm() / plain_grad.norm()).item() <= 1e-4


@pytest.mark.parametrize("shape", [(8, 64, 28, 28), (3, 256, 7, 9)])
def test_batchnorm_of_a_one_rank_group_on_the_card(cuda, shape):
    """BatchNorm's training forward under a process group of one (NCCL; the
    moments summed over the ranks in f64, ``parallel.dist``) against its
    no-group path (cuDNN's batch norm) in f32, on a channels-last input:
    the output and the running statistics within 1e-5, the gradients of
    x, the scale and the bias within 1e-5 relative L2."""
    import torch.distributed as tdist

    from maed_tpu_torch.models.resnet import BatchNorm
    from torch_port_common import free_port

    g = torch.Generator().manual_seed(6)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(cuda).to(
        memory_format=torch.channels_last)
    r = torch.randn(shape, generator=g).to(cuda)
    runs = []
    for grouped in (False, True):
        bn = BatchNorm(shape[1]).to(cuda)
        bn.reset_()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator(cuda).manual_seed(1))
            bn.bias.normal_(0.0, 0.1, generator=torch.Generator(cuda).manual_seed(2))
        xi = x.clone().requires_grad_(True)
        if grouped:
            tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                     world_size=1, rank=0)
        try:
            y = bn(xi, train=True)
            (y * r).sum().backward()
            torch.cuda.synchronize()
        finally:
            if grouped:
                tdist.destroy_process_group()
        runs.append((y.detach(), bn.running_mean.clone(), bn.running_var.clone(),
                     xi.grad, bn.weight.grad, bn.bias.grad))
    for name, a, b in zip(("y", "running_mean", "running_var"), runs[0][:3], runs[1][:3]):
        assert_close(b, a, 1e-5, what=name)
    for name, a, b in zip(("x", "scale", "bias"), runs[0][3:], runs[1][3:]):
        assert ((b - a).norm() / a.norm()).item() <= 1e-5, name


def test_remat_step_through_the_kernels(cuda):
    """A stage-2 step in f32 through the kernels (2 blocks, 2 clips x 4
    frames and 2 images at 64 px, KTD's dropout from one generator seed),
    with and without remat, from the same weights, with cuDNN's
    deterministic algorithms: the same loss terms and gradient, bit for
    bit. With remat a block's kernels run again in the recomputation in the
    backward, the stem's do not."""
    from maed_tpu_torch.core.builder import build_train_model
    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    class Optim:
        OPTIM, LR, WD, MOMENTUM = "adam", 1e-4, 0.0, 0.9
        WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES = 0, 0.1, [3]

    rng = np.random.RandomState(8)

    def kp(*shape):
        return to_torch(np.concatenate([rng.randn(*shape, 3), np.ones(shape + (1,))], -1),
                        torch.float32).to(cuda)

    vid = {"images": torch.from_numpy(rng.randint(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)).to(cuda),
           "target_2d": {"kp_2d": kp(1, 4, 49)[..., 1:]},
           "target_3d": {"kp_2d": kp(1, 4, 49)[..., 1:], "kp_3d": kp(1, 4, 49),
                         "theta": to_torch(rng.randn(1, 4, 85) * 0.1, torch.float32).to(cuda),
                         "w_smpl": torch.ones(1, 4, device=cuda)}}
    img = {"image": torch.from_numpy(rng.randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)).to(cuda),
           "kp_2d": kp(2, 49)[..., 1:], "kp_3d": kp(2, 49),
           "theta": to_torch(rng.randn(2, 85) * 0.1, torch.float32).to(cuda)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for remat in (False, True):
            model, smpl = build_train_model(num_blocks=2, num_heads=12, hidden_dim=64, img_size=64,
                                            device=cuda, seed=0, allow_synthetic_smpl=True,
                                            smpl_dir="absent", remat=remat)
            step = make_train_step(model, make_optimizer(Optim, 10, model.parameters()), smpl,
                                   LossWeights(), torch.Generator(cuda).manual_seed(3))
            kernels.reset_launches()
            metrics = step(vid, img)
            torch.cuda.synchronize()
            runs.append((metrics, torch.cat([p.grad.reshape(-1) for p in model.parameters()]),
                         dict(kernels.LAUNCHES)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m0, g0, l0), (m1, g1, l1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert torch.isfinite(g0).all() and torch.equal(g0, g1)
    for name in ("ln_dense", "spatial_attention", "temporal_attention", "gate_proj"):
        assert l0[name] > 0 and l1[name] == 2 * l0[name], (name, l0[name], l1[name])
    # the checkpoint's recomputation stops once it has what the backward
    # saved: the block's last kernel, whose output nothing inside saves, may not rerun
    assert l1["ln_mlp_fc1"] in (l0["ln_mlp_fc1"], 2 * l0["ln_mlp_fc1"])
    for name in ("groupnorm_strided", "skinning", "layernorm"):
        assert l1[name] == l0[name] > 0, (name, l0[name], l1[name])


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
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 768"):  # head dim 776
        TST.temporal_attention_fused(torch.zeros(4, 5, 3, 1, 776, device=cuda), 2, 0.25)
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


FIXTURE_DIR = Path(__file__).resolve().parent / "torch_port_data"
DECODE_BOUND = 0.06  # after the crop and the normalize: tests/test_data.py's bound for two decoders


def test_native_decoder_against_cv2s_pixels(cuda):
    """The native library's decoder on this machine (nvJPEG where libjpeg is
    absent) on the fixture frames (made by
    tests/test_torch_port_data.py::make_fixture_frames): its fused decode +
    crop + normalize within DECODE_BOUND of the same crop of the pixels cv2
    decoded from them, through the bytes path and through the single-image
    decode."""
    from maed_tpu_torch import native
    from maed_tpu_torch.data.transforms import FusedCropNormalize

    stored = np.load(FIXTURE_DIR / "decoded.npz")
    blobs = [(FIXTURE_DIR / f"frame_{k}.jpg").read_bytes() for k in range(len(stored["sha256"]))]
    want = stored["crop"].astype(np.float32)
    crop = FusedCropNormalize(112, 112)
    for clip in (blobs, [native.decode(b) for b in blobs]):
        got = crop({"clip": clip, "bbox": stored["bbox"]}, None)["clip"]
        assert np.abs(got - want).max() < DECODE_BOUND
    assert all(native.decode(b).shape == (360, 480, 3) for b in blobs)
    with pytest.raises(IOError):
        native.decode(blobs[0][:100])


def test_native_jpeg_encoder_round_trip(cuda):
    """The native library's encoder on this machine (nvJPEG's where libjpeg
    is absent) at quality 95, 4:2:0: the fixture frames (blurred noise)
    decode within 4 levels of luma (1.0 on average) and 2.5 on average a
    channel of the pixels encoded (libjpeg's encoder: 1.82, 0.24, 1.56;
    nvJPEG's: 2.60, 0.597, 2.08); a frame of the accept tool's coloured
    disks, whose chroma 4:2:0 halves, within 24 levels of luma (1.5 on
    average) and 12 on average a channel (libjpeg: 18.1, 0.41, 3.6;
    nvJPEG's chroma loses more there: 10.4, 1.13, 10.07). A refused encode
    raises."""
    from maed_tpu_torch import native
    from maed_tpu_torch.tools import accept_synthetic as PA

    luma = np.array([0.299, 0.587, 0.114])
    frames = [native.decode(p.read_bytes()) for p in sorted(FIXTURE_DIR.glob("frame_*.jpg"))]
    rng = np.random.RandomState(8)
    disks = PA.render_frame(rng.uniform(0, 64, (49, 2)), rng.randn(49), 64,
                            PA.joint_palette(49), 2)[..., ::-1]
    for rgb, luma_max, luma_mean, mean in ((np.stack(frames), 4.0, 1.0, 2.5),
                                           (disks[None], 24.0, 1.5, 12.0)):
        err = np.stack([native.decode(native.encode(x, 95)).astype(np.int32) - x for x in rgb])
        y = np.abs(err @ luma)
        print(f"{native.decoder()} q95: luma max {y.max():.2f} mean {y.mean():.3f}, "
              f"channel mean {np.abs(err).mean():.3f}")
        assert y.max() <= luma_max and y.mean() <= luma_mean and np.abs(err).mean() <= mean
    blob = native.encode(frames[0])
    assert blob[:3] == b"\xff\xd8\xff" and native.jpeg_size(blob) == frames[0].shape[:2]
    with pytest.raises(IOError):
        native.encode(frames[0], quality=0)
    with pytest.raises(ValueError):
        native.encode(frames[0][..., :2])


def test_accept_oracle_on_the_card(cuda, tmp_path):
    """The port's accept tool on the card: generate (1 + 2 videos of 40
    frames at 48 px; the SMPL forwards through kernel A, the frames through
    the native encoder) and the GT oracle through the eval protocol, every
    metric below 0.01 mm as on the CPU."""
    from maed_tpu_torch.tools import accept_synthetic as PA

    kernels.reset_launches()
    PA.generate(str(tmp_path), n_videos=1, frames_per_video=40, size=48, device=cuda)
    assert kernels.LAUNCHES["skinning"] == 3
    metrics = PA.oracle(str(tmp_path), tol_mm=0.1, device=cuda)
    for k in ("mpjpe", "pa-mpjpe", "pve"):
        assert metrics[k] < 0.01, (k, metrics)
    assert kernels.LAUNCHES["skinning"] > 3


def test_loader_workers_under_a_live_cuda_context(cuda, monkeypatch):
    """With a CUDA context in the process the workers start from a
    forkserver, and give the batches of the in-process loader."""
    from maed_tpu_torch.core.config import get_cfg_defaults
    from maed_tpu_torch.data import loaders as TL
    from maed_tpu_torch.data.dataset import VideoDataset
    from maed_tpu_torch.data.transforms import build_train_transforms

    monkeypatch.delenv("MAED_LOADER_MP", raising=False)
    torch.zeros(1, device=cuda)
    assert torch.cuda.is_initialized() and TL._default_start_method() == "forkserver"
    rng = np.random.RandomState(0)
    frames = [str(p) for p in sorted(FIXTURE_DIR.glob("frame_*.jpg"))]
    n = 48
    db = {"vid_name": np.repeat(["a", "b"], n // 2), "img_name": np.array(frames * (n // 4)),
          "frame_id": np.arange(n), "bbox": np.tile([240.0, 180.0, 160.0, 160.0], (n, 1)),
          "joints2D": np.concatenate([rng.rand(n, 49, 2) * 300, np.ones((n, 49, 1))], -1),
          "joints3D": np.concatenate([rng.randn(n, 49, 3), np.ones((n, 49, 1))], -1),
          "pose": rng.randn(n, 72) * 0.2, "shape": rng.randn(n, 10)}
    d = get_cfg_defaults().DATASET
    d.update(WIDTH=64, HEIGHT=64)
    ds = VideoDataset("syn", "train", build_train_transforms(d), seqlen=4, sample_pool=8,
                      db=db, verbose=False)
    got, want = (list(TL.ShardedLoader(ds, 2, shuffle=True, seed=5, num_workers=w).iter_from(1))
                 for w in (2, 0))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert np.array_equal(np.asarray(g[key]), np.asarray(w[key])), key


def test_demo_inference_through_the_kernels(cuda):
    """``demo.infer`` (the demo's windowed inference over JPEG frames) on the
    card with a two-block parallel model in f32 at the released crop size
    (224 px), 10 frames of the fixture JPEGs: through the kernels against
    the same run through their plain versions (verts 1e-4 m, theta 1e-3,
    phase_f32's limits), every kernel of the f32 parallel forward launched,
    K not. (At 96 px one frame of these random weights sits near a
    degenerate 6D output, which turns the kernels' f32 rounding into 2.4e-4 m
    of verts: the chaos of random weights that PERF.md notes, not a kernel
    error; each kernel is held at 1e-5 alone above.)"""
    from maed_tpu_torch import demo
    from maed_tpu_torch.core.builder import build_eval_model
    from maed_tpu_torch.core.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.EVAL.update(SEQLEN=4, SAMPLE_POOL=8, BATCH_SIZE=2)
    model, smpl = build_eval_model(num_blocks=2, num_heads=12, dtype=torch.float32, device=cuda,
                                   seed=3, allow_synthetic_smpl=True)
    frames = [str(p) for p in sorted(FIXTURE_DIR.glob("frame_*.jpg"))]
    paths = [frames[i % len(frames)] for i in range(10)]
    boxes = np.tile([240.0, 180.0, 170.0, 170.0], (10, 1)).astype(np.float32)
    kernels.reset_launches()
    got = demo.infer(model, smpl, cfg, paths, boxes).accumulators
    launches = dict(kernels.LAUNCHES)
    want = demo.infer(model, smpl, cfg, paths, boxes, plain=True).accumulators
    for key, atol in (("pred_verts", 1e-4), ("pred_theta", 1e-3)):
        g, w = np.concatenate(got[key]), np.concatenate(want[key])
        assert g.shape == w.shape and g.shape[0] == 10, key
        assert_close(g, w, atol, what=key)
    used = [k for k, v in launches.items() if v]
    assert sorted(used) == sorted(["skinning", "layernorm", "ln_rows", "ln_mlp_fc1", "ln_mlp_fc2",
                                   "ln_dense", "gate_means", "gate_alpha", "gate_blend",
                                   "gate_proj", "groupnorm_strided", "spatial_attention",
                                   "temporal_attention"]), launches


def test_threedpw_read_data_through_the_skinning_kernel(cuda, tmp_path, monkeypatch):
    """The 3DPW preprocessor on the card (2 sequences of 2 people, 300
    frames, the train split's joint bank and, with a regressor file, the
    test split's J14) against the same read through the skinning's plain
    version: joints3D within 1e-4 m, every other field equal; one launch a
    person's sequence, two with a chunk of 128 frames."""
    import pickle

    from maed_tpu_torch.data.preprocess import threedpw

    rng = np.random.RandomState(8)
    T = 300
    for split in ("train", "test"):
        (tmp_path / "sequenceFiles" / split).mkdir(parents=True)
        for s in range(2):
            q, _ = np.linalg.qr(rng.randn(T, 3, 3))
            cam = np.tile(np.eye(4), (T, 1, 1))
            cam[:, :3, :3] = q * np.sign(np.linalg.det(q))[:, None, None]
            p2d = np.concatenate([rng.uniform(300, 900, (2, T, 2, 18)),
                                  rng.uniform(0.2, 1.0, (2, T, 1, 18))], axis=2)
            seq = {"poses": [rng.randn(T, 72) * 0.3 for _ in range(2)],
                   "betas": [rng.randn(10) * 0.5 for _ in range(2)], "poses2d": list(p2d),
                   "campose_valid": [rng.rand(T) > 0.1 for _ in range(2)], "cam_poses": cam,
                   "img_frame_ids": np.arange(T)}
            with open(tmp_path / "sequenceFiles" / split / f"s{s}.pkl", "wb") as f:
                pickle.dump(seq, f)
    jreg = rng.rand(17, 6890) ** 8
    np.save(tmp_path / "J_regressor_h36m.npy", jreg / jreg.sum(1, keepdims=True))
    smpl = synthetic_smpl_model(6890, device=cuda)
    for split, chunk in (("train", threedpw.FRAMES_A_FORWARD), ("test", 128)):
        monkeypatch.setattr(threedpw, "FRAMES_A_FORWARD", chunk)
        kernels.reset_launches()
        got = threedpw.read_data(str(tmp_path), split, smpl, data_dir=str(tmp_path))
        assert kernels.LAUNCHES["skinning"] == 4 * -(-T // chunk)
        want = threedpw.read_data(str(tmp_path), split, smpl, data_dir=str(tmp_path), plain=True)
        assert sorted(got) == sorted(want)
        for key in want:
            if key == "joints3D":
                assert_close(got[key], want[key], 1e-4, what=split)
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        shape = np.tile(rng.randn(1, 10), (T, 1)).astype(np.float32)
        pose = (rng.randn(T, 72) * 0.3).astype(np.float32)
        kernels.reset_launches()
        j3d = threedpw.sequence_joints(smpl, shape, pose)
        assert kernels.LAUNCHES["skinning"] == -(-T // chunk)
        assert_close(j3d, threedpw.sequence_joints(smpl, shape, pose, plain=True), 1e-4)
