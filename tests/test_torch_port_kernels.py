"""The port's kernel modules held against the JAX package's Pallas kernels,
on the CPU.

The JAX kernels run in interpret mode, as tests/test_pallas_fused and
tests/test_groupnorm_pallas run them (``ops/attention.py`` interprets by
itself off the TPU), against what the port's wrappers run for a CPU tensor
(their plain versions), in f32 at atol 1e-5 (the Pallas bodies compute in f32
even for f64 input, and _mlp_kernel's A&S erf is off by up to 1.5e-7; the
blocked attention at 5e-5, its own test's bound), with
JAX's dots at ``jax.default_matmul_precision("highest")``. The JAX plain
references and the port's are compared in f64 at atol 1e-9. The kernels
themselves are held against these plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.

Two exceptions to 1e-9, where a JAX reference computes a part in f32
whatever x is, while the JAX model promotes (f64 stays f64) and the port's
plain versions follow the model, which the whole slice is held to at 1e-8 in
f64:

- ``maed_tpu.ops.groupnorm.groupnorm_reference`` takes its moments in f32. The
  port's is held at 1e-9 against the model's ``_GroupNormCore`` (residual and
  ReLU applied to its output as the kernel applies them) and at 1e-5 against
  the f32-moment reference.
- ``spatial_reference``, ``temporal_reference``, ``temporal_reference_btc``
  and ``_xla_attention`` take their softmax in f32. The port's are held to
  them at 1e-6 (probabilities below 1 at f32 resolution), and at 1e-9 to the
  same formula written out in numpy f64; the model's f64 attention is held
  at 1e-9 by tests/test_torch_port_models.py::test_block_matches_jax_f64.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.models.resnetv2 import _GroupNormCore
from maed_tpu.ops import attention as JA
from maed_tpu.ops import groupnorm as JGN
from maed_tpu.ops import layernorm as JLN
from maed_tpu.ops import mlp as JMLP
from maed_tpu.ops import st_attention as JST
from maed_tpu_torch.ops import attention as TA
from maed_tpu_torch.ops import groupnorm as TGN
from maed_tpu_torch.ops import layernorm as TLN
from maed_tpu_torch.ops import mlp as TMLP
from maed_tpu_torch.ops import st_attention as TST
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import assert_close, ln_inputs, mlp_inputs, to_torch, torch_mlp_args


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JLN, "_INTERPRET", True)
    monkeypatch.setattr(JMLP, "_INTERPRET", True)
    monkeypatch.setattr(JGN, "_INTERPRET", True)
    monkeypatch.setattr(JST, "_INTERPRET", True)


def test_layernorm_matches_the_pallas_kernel(interpret):
    args = [a.astype(np.float32) for a in ln_inputs(np.random.RandomState(0))]
    want = JLN.fast_layernorm(*(jnp.asarray(a) for a in args), 1e-6)
    got = TLN.fast_layernorm(*(to_torch(a) for a in args), 1e-6)
    assert_close(got, want, 1e-5)


def test_layernorm_reference_matches_jax_f64():
    args = ln_inputs(np.random.RandomState(1))
    with jax.enable_x64(True):
        want = JLN.layernorm_reference(*(jnp.asarray(a) for a in args), 1e-6)
    got = TLN.layernorm_reference(*(to_torch(a) for a in args), 1e-6)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)


def test_ln_mlp_matches_the_pallas_kernel(interpret):
    args = [a.astype(np.float32) for a in mlp_inputs(np.random.RandomState(2))]
    with jax.default_matmul_precision("highest"):
        want = JMLP.fused_ln_mlp(*(jnp.asarray(a) for a in args))
    got = TMLP.fused_ln_mlp(*torch_mlp_args(args, torch.float32))
    assert_close(got, want, 1e-5)


def test_ln_mlp_reference_matches_jax_f64():
    args = mlp_inputs(np.random.RandomState(3))
    with jax.enable_x64(True):
        want = JMLP.ln_mlp_reference(*(jnp.asarray(a) for a in args), 1e-6)
    got = TMLP.ln_mlp_reference(*torch_mlp_args(args, torch.float64), 1e-6)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)


# ------------------------------------------------------------- LN + dense (D)

def ln_dense_inputs(rng, shape, O):
    """x, ln scale and bias, w (C, O) as flax stores it, b."""
    return mlp_inputs(rng, shape, O)[:5]


def torch_ln_dense_args(args, dtype):
    x, s, b, w, bw = args
    pdt = torch.promote_types(dtype, torch.float32)
    return (to_torch(x, dtype), to_torch(s, pdt), to_torch(b, pdt), to_torch(w.T, dtype),
            to_torch(bw, pdt))


def test_ln_dense_matches_the_pallas_kernel(interpret):
    args = [a.astype(np.float32) for a in ln_dense_inputs(np.random.RandomState(4), (3, 7, 64), 192)]
    with jax.default_matmul_precision("highest"):
        want = JMLP.fused_ln_dense(*(jnp.asarray(a) for a in args))
    got = TMLP.fused_ln_dense(*torch_ln_dense_args(args, torch.float32))
    assert got.shape == (3, 7, 192)
    assert_close(got, want, 1e-5)


def test_ln_dense_reference_matches_jax_f64():
    args = ln_dense_inputs(np.random.RandomState(5), (5, 48), 100)
    with jax.enable_x64(True):
        want = JMLP.ln_dense_reference(*(jnp.asarray(a) for a in args), 1e-6)
    got = TMLP.ln_dense_reference(*torch_ln_dense_args(args, torch.float64), 1e-6)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)


# ------------------------------------- the bf16 split of C and D: pre-pass + GEMM

SPLIT_DTYPES = [torch.float64, torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", SPLIT_DTYPES)
def test_ln_dense_reference_equals_its_split(dtype):
    """Kernel D runs in bf16 as the LN pre-pass and then the GEMM with the
    bias epilogue; chained, their plain versions are D's reference bit for
    bit, because the split lies where the TPU kernel rounds (LN(x) to x's
    dtype)."""
    x, s, b, w, bw = torch_ln_dense_args(ln_dense_inputs(np.random.RandomState(15), (3, 7, 64), 48),
                                         dtype)
    xn = TMLP.ln_rows_reference(x, s, b, 1e-6)
    assert xn.dtype == dtype
    got = TMLP.dense_reference(xn, w, bw, "bias")
    want = TMLP.ln_dense_reference(x, s, b, w, bw, 1e-6)
    assert got.dtype == dtype and torch.equal(got, want)
    # the wrappers take these plain versions for a CPU tensor
    assert torch.equal(TMLP.dense(TMLP.ln_rows(x, s, b, 1e-6), w, bw), want)


@pytest.mark.parametrize("dtype", SPLIT_DTYPES)
def test_ln_mlp_reference_equals_its_split(dtype):
    """Kernel C runs in bf16 as the LN pre-pass, the GEMM with the GELU
    epilogue (h rounded to x's dtype, where the TPU kernel rounds it) and the
    GEMM with the residual epilogue: bit for bit C's reference."""
    x, s, b, w1, b1, w2, b2 = torch_mlp_args(mlp_inputs(np.random.RandomState(16), (3, 7, 64), 96),
                                             dtype)
    h = TMLP.dense_reference(TMLP.ln_rows_reference(x, s, b, 1e-6), w1, b1, "gelu")
    assert h.dtype == dtype and h.shape == (3, 7, 96)
    got = TMLP.dense_reference(h, w2, b2, "residual", x)
    want = TMLP.ln_mlp_reference(x, s, b, w1, b1, w2, b2, 1e-6)
    assert got.dtype == dtype and torch.equal(got, want)
    h_cpu = TMLP.dense(TMLP.ln_rows(x, s, b, 1e-6), w1, b1, "gelu")
    assert torch.equal(TMLP.dense(h_cpu, w2, b2, "residual", x), want)


def test_ln_rows_reference_matches_jax_f64():
    args = ln_inputs(np.random.RandomState(17), (4, 9, 48))
    with jax.enable_x64(True):
        want = JLN.layernorm_reference(*(jnp.asarray(a) for a in args), 1e-6)
    got = TMLP.ln_rows_reference(*(to_torch(a) for a in args), 1e-6)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_dense_reference_matches_jax_f64(epilogue):
    """Each epilogue of the GEMM's plain version against the same steps in
    JAX (its exact-erf GELU) in f64; w as flax stores it, (K, N)."""
    rng = np.random.RandomState(18)
    a, w, bw, res = rng.randn(5, 40), rng.randn(40, 24) / np.sqrt(40), rng.randn(24), rng.randn(5, 24)
    with jax.enable_x64(True):
        y = jnp.dot(jnp.asarray(a), jnp.asarray(w)) + jnp.asarray(bw)
        want = np.asarray({"bias": y, "gelu": JMLP._gelu_exact(y),
                           "residual": jnp.asarray(res) + y}[epilogue])
    got = TMLP.dense_reference(to_torch(a), to_torch(w.T), to_torch(bw), epilogue,
                               to_torch(res) if epilogue == "residual" else None)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)


def test_dense_raises_on_an_unknown_epilogue():
    a = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="epilogue"):
        TMLP.dense_reference(a, torch.zeros(8, 8), torch.zeros(8), "relu")
    with pytest.raises(ValueError, match="epilogue"):
        TMLP.dense(a, torch.zeros(8, 8), torch.zeros(8), "relu")


# ------------------------------------------------------------ gate + proj (E)

GATE_SHAPES = [(4, 13, 32), (2, 197, 16), (3, 1, 8)]   # BT, N, C; odd and single token counts


def gate_proj_inputs(rng, BT, N, C):
    """y_s, y_t, x_res, then w_ts (2C, 2C), b_ts, w_p (C, C), b_p as flax stores them."""
    return (rng.randn(BT, N, C), rng.randn(BT, N, C) + 0.3, rng.randn(BT, N, C),
            rng.randn(2 * C, 2 * C) / np.sqrt(2 * C), rng.randn(2 * C) * 0.1,
            rng.randn(C, C) / np.sqrt(C), rng.randn(C) * 0.1)


def torch_gate_proj_args(args, dtype):
    y_s, y_t, x, w_ts, b_ts, w_p, b_p = args
    pdt = torch.promote_types(dtype, torch.float32)
    return (to_torch(y_s, dtype), to_torch(y_t, dtype), to_torch(x, dtype),
            to_torch(w_ts.T, dtype), to_torch(b_ts, pdt), to_torch(w_p.T, dtype),
            to_torch(b_p, pdt))


@pytest.mark.parametrize("BT, N, C", GATE_SHAPES)
def test_gate_proj_matches_the_pallas_kernel(interpret, BT, N, C):
    args = [a.astype(np.float32) for a in gate_proj_inputs(np.random.RandomState(13), BT, N, C)]
    with jax.default_matmul_precision("highest"):
        want, want_alpha = JMLP.fused_gate_proj(*(jnp.asarray(a) for a in args))
    targs = torch_gate_proj_args(args, torch.float32)
    got, alpha = TMLP.fused_gate_proj(*targs)
    assert got.shape == (BT, N, C) and alpha.shape == (BT, 1, C, 2)
    assert_close(got, want, 1e-5)
    assert_close(alpha, want_alpha, 1e-5)
    got, alpha = gate_proj_by_pieces(*targs)  # the pieces the kernels compute
    assert_close(got, want, 1e-5)
    assert_close(alpha, want_alpha, 1e-5)


@pytest.mark.parametrize("BT, N, C", GATE_SHAPES)
def test_gate_proj_reference_matches_jax_f64(BT, N, C):
    args = gate_proj_inputs(np.random.RandomState(14), BT, N, C)
    with jax.enable_x64(True):
        want, want_alpha = JMLP.gate_proj_reference(*(jnp.asarray(a) for a in args))
        want, want_alpha = np.asarray(want), np.asarray(want_alpha)
    targs = torch_gate_proj_args(args, torch.float64)
    got, alpha = TMLP.gate_proj_reference(*targs)
    assert got.dtype == torch.float64 and alpha.dtype == torch.float64
    assert_close(got, want, 1e-9)
    assert_close(alpha, want_alpha, 1e-9)
    got, alpha = gate_proj_by_pieces(*targs)
    assert_close(got, want, 1e-9)
    assert_close(alpha, want_alpha, 1e-9)


def gate_proj_by_pieces(y_s, y_t, x, w_ts, b_ts, w_p, b_p):
    """E's plain pieces chained as the bf16 kernels run them: the branch
    means, the gate, the blend, the proj with the residual."""
    alpha = TMLP.gate_alpha(TMLP.gate_means(y_s, y_t), w_ts, b_ts)
    y = TMLP.gate_blend(y_s, y_t, alpha)
    return TMLP.dense(y, w_p, b_p, "proj", x), alpha


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BT, N, C", GATE_SHAPES)
def test_gate_proj_pieces_equal_the_reference(dtype, BT, N, C):
    """The pieces' plain versions (what the wrappers run for a CPU tensor)
    chained equal gate_proj_reference bit for bit: they round where it
    does."""
    args = torch_gate_proj_args(gate_proj_inputs(np.random.RandomState(15), BT, N, C), dtype)
    got, alpha = gate_proj_by_pieces(*args)
    want, want_alpha = TMLP.gate_proj_reference(*args)
    assert got.dtype == dtype and alpha.shape == (BT, 1, C, 2)
    assert torch.equal(got, want) and torch.equal(alpha, want_alpha)
    means = TMLP.gate_means_reference(args[0], args[1])
    assert means.shape == (BT, 2 * C) and means.dtype == dtype
    assert torch.equal(TMLP.gate_alpha_reference(means, args[3], args[4]), want_alpha)


# ------------------------------------------------------------- GroupNorm (I)

# the stem's GroupNorm shapes at 224 px (side, channels) and the cluster each
# takes in the bf16 kernel
STEM_CLUSTERS = [((112, 64), 8), ((56, 64), 2), ((56, 256), 8), ((56, 128), 4),
                 ((28, 128), 2), ((28, 512), 4), ((28, 256), 2), ((14, 256), 2),
                 ((14, 1024), 2)]


@pytest.mark.parametrize("site, ranks", STEM_CLUSTERS)
def test_groupnorm_cluster_size_at_the_stem_shapes(site, ranks):
    """The cluster kernel takes every stem site: the fewest CTAs, at least
    2, whose shares of the frame fit in shared memory."""
    side, C = site
    hw = side * side
    assert TGN.cluster_size(hw, C, 32) == ranks
    assert TGN.cluster_fits(hw, C, 32, ranks)
    assert TGN.cluster_smem(32, C, ranks, -(-hw // ranks)) <= 232448
    assert not any(TGN.cluster_fits(hw, C, 32, r) for r in TGN.CLUSTERS if 2 <= r < ranks)


@pytest.mark.parametrize("hw, C, groups", [(6400, 256, 32), (1600, 1024, 32), (49, 96, 32),
                                           (49, 64, 128), (49, 4096, 32), (49, 60, 30)])
def test_groupnorm_cluster_size_declines(hw, C, groups):
    """Frames the cluster kernel does not take go to the strided kernel: a
    3.2 MB frame (beyond 8 CTAs), 12 or 512 16-byte columns, 128 groups,
    widths not a multiple of 8."""
    assert TGN.cluster_size(hw, C, groups) is None

GN_SHAPES = [((2, 9, 9, 64), 32),    # 2 channels a group, odd side
             ((3, 5, 7, 32), 32),    # 1 channel a group
             ((2, 6, 96), 32)]       # 3 channels a group, one spatial axis


def groupnorm_inputs(rng, shape):
    C = shape[-1]
    return rng.randn(*shape) * 3 + 1, rng.rand(C) + 0.5, rng.randn(C) * 0.1, rng.randn(*shape)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape, groups", GN_SHAPES)
def test_groupnorm_matches_the_pallas_kernel(interpret, shape, groups, relu, with_res):
    x, s, b, r = (a.astype(np.float32) for a in groupnorm_inputs(np.random.RandomState(6), shape))
    r = r if with_res else None
    want = JGN.fused_groupnorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups, 1e-5,
                               relu, None if r is None else jnp.asarray(r))
    got = TGN.fused_groupnorm(to_torch(x), to_torch(s), to_torch(b), groups, 1e-5, relu,
                              None if r is None else to_torch(r))
    assert_close(got, want, 1e-5)
    # a strided view (channel-major memory): the plain version reads any strides
    view = to_torch(x).movedim(-1, 1).contiguous().movedim(1, -1)
    assert not view.is_contiguous() or view.shape[-1] == 1
    got = TGN.fused_groupnorm(view, to_torch(s), to_torch(b), groups, 1e-5, relu,
                              None if r is None else to_torch(r))
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape, groups", GN_SHAPES)
def test_groupnorm_reference_matches_jax_f64(shape, groups, relu, with_res):
    """1e-9 against the model's _GroupNormCore, 1e-5 against the reference
    with f32 moments (see the module doc)."""
    x, s, b, r = groupnorm_inputs(np.random.RandomState(7), shape)
    r = r if with_res else None
    core = _GroupNormCore(num_groups=groups, dtype=jnp.float64)
    with jax.enable_x64(True):
        want = core.apply({"params": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}},
                          jnp.asarray(x))
        if r is not None:
            want = want + r
        want = np.asarray(jnp.maximum(want, 0) if relu else want)
        loose = np.asarray(JGN.groupnorm_reference(
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups, 1e-5, relu,
            None if r is None else jnp.asarray(r)))
    got = TGN.groupnorm_reference(to_torch(x), to_torch(s), to_torch(b), groups, 1e-5, relu,
                                  None if r is None else to_torch(r))
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)
    assert_close(got, loose, 1e-5)


# ------------------------------------------------- attention (F, G, H and J)

QKV_SHAPES = [(4, 13, 2, 16, 2),    # BT, N, h, d, T; N odd: a partial block of 8 tokens
              (6, 5, 4, 8, 3),      # T 3
              (2, 197, 2, 16, 2)]   # the flagship's token count


def qkv_inputs(seed, BT, N, h, d):
    return np.random.RandomState(seed).randn(BT, N, 3, h, d)


def numpy_attention(q, k, v, scale, scores, mix):
    """softmax(q k * scale) v in f64 by the two einsums."""
    logits = np.einsum(scores, q, k) * scale
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum(mix, probs / probs.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("BT, N, h, d, T", QKV_SHAPES)
def test_st_attention_matches_the_pallas_kernels(interpret, BT, N, h, d, T):
    """F (spatial, head-leading), G (temporal, head-leading) and H (temporal,
    token-major); the port's token-major spatial output is F's, transposed."""
    qkv = qkv_inputs(8, BT, N, h, d).astype(np.float32)
    scale = d ** -0.5
    with jax.default_matmul_precision("highest"):
        want_s = JST.spatial_attention(jnp.asarray(qkv), scale)
        want_t = JST.temporal_attention(jnp.asarray(qkv), T, scale)
        want_t2 = JST.temporal_attention_fused(jnp.asarray(qkv), T, scale)
    assert_close(TST.spatial_attention(to_torch(qkv), scale), want_s, 1e-5)
    assert_close(TST.spatial_attention_btc(to_torch(qkv), scale),
                 np.transpose(want_s, (1, 2, 0, 3)).reshape(BT, N, h * d), 1e-5)
    assert_close(TST.temporal_attention(to_torch(qkv), T, scale), want_t, 1e-5)
    assert_close(TST.temporal_attention_fused(to_torch(qkv), T, scale), want_t2, 1e-5)


@pytest.mark.parametrize("BT, N, h, d, T", QKV_SHAPES)
def test_st_attention_references_match_jax_f64(BT, N, h, d, T):
    qkv = qkv_inputs(9, BT, N, h, d)
    scale = d ** -0.5
    with jax.enable_x64(True):
        want_s = np.asarray(JST.spatial_reference(jnp.asarray(qkv), scale))
        want_t = np.asarray(JST.temporal_reference(jnp.asarray(qkv), T, scale))
        want_t2 = np.asarray(JST.temporal_reference_btc(jnp.asarray(qkv), T, scale))
    q, k, v = (qkv[:, :, i] for i in range(3))
    exact_s = numpy_attention(q, k, v, scale, "bqhd,bkhd->bhqk", "bhqk,bkhd->hbqd")
    qc, kc, vc = (a.reshape(BT // T, T, N, h, d) for a in (q, k, v))
    exact_t = numpy_attention(qc, kc, vc, scale, "bqnhd,bknhd->bnhqk", "bnhqk,bknhd->hbqnd")
    exact_t = exact_t.reshape(h, BT, N, d)

    def btc(a):
        return np.transpose(a, (1, 2, 0, 3)).reshape(BT, N, h * d)

    got = TST.spatial_reference(to_torch(qkv), scale)
    assert got.dtype == torch.float64 and got.shape == (h, BT, N, d)
    for got, want, exact in (
            (got, want_s, exact_s),
            (TST.spatial_reference_btc(to_torch(qkv), scale), btc(want_s), btc(exact_s)),
            (TST.temporal_reference(to_torch(qkv), T, scale), want_t, exact_t),
            (TST.temporal_reference_btc(to_torch(qkv), T, scale), want_t2, btc(exact_t))):
        assert_close(got, want, 1e-6)
        assert_close(got, exact, 1e-9)


def bhsd_inputs(seed, B, h, S, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, h, S, d) for _ in range(3)]


@pytest.mark.parametrize("B, h, S, d", [(2, 3, 37, 16), (1, 2, 197, 8)])
def test_fused_attention_matches_the_pallas_kernel(B, h, S, d):
    q, k, v = (a.astype(np.float32) for a in bhsd_inputs(10, B, h, S, d))
    with jax.default_matmul_precision("highest"):
        want = JA.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = TA.fused_attention(to_torch(q), to_torch(k), to_torch(v))
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("B, h, S, d", [(2, 3, 37, 16), (1, 2, 197, 8)])
def test_xla_attention_matches_jax_f64(B, h, S, d):
    q, k, v = bhsd_inputs(11, B, h, S, d)
    with jax.enable_x64(True):
        want = np.asarray(JA._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3))
    got = TA._xla_attention(to_torch(q), to_torch(k), to_torch(v), 0.3)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-6)
    assert_close(got, numpy_attention(q, k, v, 0.3, "bhsd,bhtd->bhst", "bhst,bhtd->bhsd"), 1e-9)


def test_fused_attention_takes_the_plain_version_only_on_the_cpu():
    """On the CPU the dispatch picks the plain version of the kernel the card
    would launch: up to 1024 tokens the spatial kernel's, beyond them the
    blocked kernel's (not ``_xla_attention``, which rounds elsewhere); the two
    are one function, apart in f64 by rounding alone. ``out`` is filled in
    place."""
    q = to_torch(np.random.RandomState(12).randn(1, 1, 1030, 8))
    got = TA.fused_attention(q, q, q)
    assert got.shape == q.shape
    assert_close(got, TA.attention_blocked_reference(q, q, q, 8 ** -0.5), 0.0)
    assert_close(got, TA._xla_attention(q, q, q, 8 ** -0.5), 1e-12)
    short = q[:, :, :1024]
    assert_close(TA.fused_attention(short, short, short),
                 TA._xla_attention(short, short, short, 8 ** -0.5), 0.0)
    out = torch.empty(1, 1030, 1, 8, dtype=q.dtype).transpose(1, 2)
    assert TA.fused_attention(q, q, q, out=out) is out
    assert_close(out, got, 0.0)


# ------------------------------------------------------ blocked attention (K)

@pytest.mark.parametrize("B, h, S, d, blocks", [
    (1, 2, 1576, 32, {}),                                # 8 * 197, padded to 2048 by the TPU kernel
    (2, 2, 150, 16, dict(block_q=64, block_k=32)),       # a last key block of 22: the tail mask
])
def test_attention_blocked_reference_matches_the_pallas_kernel(B, h, S, d, blocks):
    """K's plain version against the Pallas kernel in interpret mode, f32 at
    5e-5 (the bound tests/test_attention_pallas.py holds the kernel to): the
    same steps in the same key blocks, summed in another order."""
    q, k, v = (a.astype(np.float32) for a in bhsd_inputs(13, B, h, S, d))
    scale = d ** -0.5
    with jax.default_matmul_precision("highest"):
        want = JA._attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                     **blocks)
    got = TA.attention_blocked_reference(to_torch(q), to_torch(k), to_torch(v), scale,
                                         block_k=blocks.get("block_k", 512))
    assert got.shape == (B, h, S, d) and got.dtype == torch.float32
    assert_close(got, want, 5e-5)


@pytest.mark.parametrize("block_k", [512, 64, 37])
def test_attention_blocked_reference_matches_numpy_f64(block_k):
    """In f64 nothing is rounded on the way, so any key-block size gives the
    softmax written out in numpy, at 1e-9."""
    q, k, v = bhsd_inputs(14, 2, 2, 300, 16)
    got = TA.attention_blocked_reference(to_torch(q), to_torch(k), to_torch(v), 0.25, block_k)
    assert got.dtype == torch.float64
    assert_close(got, numpy_attention(q, k, v, 0.25, "bhsd,bhtd->bhst", "bhst,bhtd->bhsd"), 1e-9)


def test_attention_blocked_key_block_size_costs_a_bf16_rounding():
    """The CUDA kernel walks 64 keys at a time (``kMmaKeys`` in
    csrc/st_attention.cu), the plain version 512 as the TPU kernel. The
    running max moves at other columns, so the unnormalised p = exp(s - m) is
    rounded to bf16 at another scale: each p moves by at most one bf16 step
    (2^-8 relative). The outputs are means of v over hundreds of keys (|out|
    ~0.04, at most ~0.3), where those steps average out to a few 1e-4, and
    are rounded once more to bf16: within 2e-3 + 1e-2 |out|, the bound the
    card tests hold the kernel to. In f32 the same change is ~1e-6."""
    kernel_keys = 64
    q, k, v = (to_torch(a, torch.bfloat16) for a in bhsd_inputs(15, 1, 2, 1100, 32))
    scale = 32 ** -0.5
    at_512 = TA.attention_blocked_reference(q, k, v, scale)
    at_64 = TA.attention_blocked_reference(q, k, v, scale, kernel_keys)
    assert at_64.dtype == torch.bfloat16
    assert not torch.equal(at_64, at_512)
    assert_close(at_64.float(), at_512.float(), 2e-3, 1e-2)
    exact = TA.attention_blocked_reference(q.double(), k.double(), v.double(), scale)
    assert_close(at_64.double(), exact, 2e-3, 1e-2)
    q32, k32, v32 = q.float(), k.float(), v.float()
    assert_close(TA.attention_blocked_reference(q32, k32, v32, scale, kernel_keys),
                 TA.attention_blocked_reference(q32, k32, v32, scale), 2e-5)
