"""The ViT block's fused dense paths: the MLP half, x + fc2(gelu(fc1(LN(x)))),
the qkv projection, Dense(LN(x)), and the parallel attention's tail, x +
proj(gated blend of the two branches); the CUDA kernels of ``csrc/ln_mlp.cu``
and their plain PyTorch versions.

Counterpart of ``maed_tpu/ops/mlp.py``: ``fused_ln_mlp`` and
``ln_mlp_reference``, ``fused_ln_dense`` and ``ln_dense_reference``,
``fused_gate_proj`` and ``gate_proj_reference``. In bf16 the first two are
split where the TPU kernels round: ``ln_rows`` (LN(x) rounded to the dtype)
and then ``dense`` (the product with a bias, GELU or residual epilogue) once
or twice; ``ln_rows_reference`` and ``dense_reference`` are those pieces'
plain versions, and chained they equal the whole references bit for bit.
The attention's tail is split likewise, in every dtype: ``gate_means`` (the
branch means, rounded), ``gate_alpha`` (the gate product and its pair
softmax), in bf16 ``gate_blend`` (the blended branches) and ``dense`` with
the "proj" epilogue; ``gate_means_reference``, ``gate_alpha_reference``,
``gate_blend_reference`` and ``dense_reference`` chained equal
``gate_proj_reference`` bit for bit. ``fused_gate_proj`` launches its pieces
from one C call. The weights are taken as
``nn.Linear`` stores them: w1 (H, C), w2 (C, H), w (O, C), w_ts (2C, 2C) and
w_p (C, C), in x's dtype; the biases stay f32, as in the TPU kernels. The JAX
package gates its MLP kernel on the weights fitting in VMEM
(``vit.py:473-479``); the CUDA kernels have no such limit and take f32 and
bf16 alike.

The three fused entry points have a gradient: autograd through their plain
versions on the saved inputs (``ops.recompute``), as the JAX package's
custom VJPs recompute theirs; ``fused_gate_proj``'s gate weights go out
detached.
"""

from __future__ import annotations

import torch

from maed_tpu_torch import kernels
from maed_tpu_torch.ops.recompute import differentiable


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    # 0.5 x (1 + erf(x / sqrt(2)))
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def _layernorm(x, ln_scale, ln_bias, eps):
    """LN(x) in promote(x.dtype, f32), not yet rounded."""
    st = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(st)
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - m * m
    xn = (xf - m) * torch.rsqrt(var + eps)
    return xn * ln_scale.to(st) + ln_bias.to(st)


def _product(a, w, dtype):
    """a @ w.T of operands rounded to ``dtype``, accumulated in promote(dtype, f32)."""
    st = torch.promote_types(dtype, torch.float32)
    return torch.matmul(a.to(dtype).to(st), w.to(dtype).to(st).t())


def ln_rows_reference(x, ln_scale, ln_bias, eps):
    """LN(x) rounded to x's dtype: statistics in promote(x.dtype, f32) as
    E[x^2] - m^2, (x - m) * rstd * scale + bias there, one rounding. The
    operand that fc1 and the qkv projection read."""
    return _layernorm(x, ln_scale, ln_bias, eps).to(x.dtype)


# the epilogues of the dense GEMM: the code its C entry takes, and the count a
# launch goes under (the kernel whose product it is)
_EPILOGUES = {"bias": (0, "ln_dense"), "gelu": (1, "ln_mlp_fc1"), "residual": (2, "ln_mlp_fc2"),
              "proj": (3, "gate_proj")}


def _epilogue(epilogue):
    if epilogue not in _EPILOGUES:
        raise ValueError(f"dense: epilogue {epilogue!r}, want one of {sorted(_EPILOGUES)}")
    return _EPILOGUES[epilogue]


def dense_reference(a, w, b, epilogue="bias", residual=None):
    """a @ w.T (w (N, K)) accumulated in promote(a.dtype, f32), + b there,
    then by ``epilogue``: "bias" rounds once to a's dtype; "gelu" takes the
    exact-erf GELU there and rounds; "residual" (C's fc2) and "proj" (E's
    proj, the same function) round, then add it to ``residual`` in a's
    dtype."""
    _epilogue(epilogue)
    st = torch.promote_types(a.dtype, torch.float32)
    y = _product(a, w, a.dtype) + b.to(st)
    if epilogue == "gelu":
        return _gelu_exact(y).to(a.dtype)
    if epilogue in ("residual", "proj"):
        return residual + y.to(a.dtype)
    return y.to(a.dtype)


def ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    """x + fc2(gelu(fc1(LN(x)))); statistics and accumulation in
    promote(x.dtype, f32), LN(x) and h rounded to x's dtype before each
    product, as the TPU kernel does. w1 (H, C), w2 (C, H)."""
    st = torch.promote_types(x.dtype, torch.float32)
    h = _gelu_exact(_product(_layernorm(x, ln_scale, ln_bias, eps), w1, x.dtype) + b1.to(st))
    y = _product(h, w2, x.dtype) + b2.to(st)
    return x + y.to(x.dtype)


def ln_dense_reference(x, ln_scale, ln_bias, w, b, eps):
    """Dense(LN(x)): LN(x) rounded to x's dtype, the product accumulated in
    promote(x.dtype, f32), the bias added there, one rounding of the result.
    w (O, C)."""
    st = torch.promote_types(x.dtype, torch.float32)
    y = _product(_layernorm(x, ln_scale, ln_bias, eps), w, x.dtype) + b.to(st)
    return y.to(x.dtype)


def gate_proj_reference(y_s, y_t, x_res, w_ts, b_ts, w_p, b_p):
    """The tail of the parallel attention; returns (x_res + proj(y), alpha
    (BT, 1, C, 2)). The branch means over the N tokens of y_s and y_t
    (BT, N, C) are taken in promote(dtype, f32) and rounded; their concat
    times w_ts (2C, 2C) plus b_ts, accumulated there, is read as C
    (spatial, temporal) pairs and softmaxed per pair, alpha rounded to the
    dtype; y = y_t * alpha[..., 1] + y_s * alpha[..., 0] in the dtype; proj
    accumulates in promote(dtype, f32), adds b_p there and is rounded once
    before the residual add."""
    BT, _, C = y_s.shape
    dt = y_s.dtype
    st = torch.promote_types(dt, torch.float32)
    means = torch.cat([y_s.to(st).mean(dim=1, keepdim=True),
                       y_t.to(st).mean(dim=1, keepdim=True)], dim=-1)
    logits = (_product(means, w_ts, dt) + b_ts.to(st)).reshape(BT, 1, C, 2)
    alpha = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    alpha = (alpha / alpha.sum(dim=-1, keepdim=True)).to(dt)
    y = y_t * alpha[..., 1] + y_s * alpha[..., 0]
    out = _product(y, w_p, dt) + b_p.to(st)
    return x_res + out.to(dt), alpha


def gate_means_reference(y_s, y_t):
    """E's first piece: (BT, 2C) = [mean y_s | mean y_t] over the N tokens
    of y_s, y_t (BT, N, C), taken in promote(dtype, f32) and rounded to the
    dtype, as the gate's product reads them."""
    st = torch.promote_types(y_s.dtype, torch.float32)
    return torch.cat([y_s.to(st).mean(dim=1), y_t.to(st).mean(dim=1)], dim=-1).to(y_s.dtype)


def gate_alpha_reference(means, w_ts, b_ts):
    """E's gate: alpha (BT, 1, C, 2) from the means (BT, 2C): means times
    w_ts (2C, 2C) plus b_ts accumulated in promote(dtype, f32), read as C
    (spatial, temporal) pairs, softmaxed per pair and rounded to the dtype."""
    BT, K = means.shape
    dt = means.dtype
    st = torch.promote_types(dt, torch.float32)
    logits = (_product(means, w_ts, dt) + b_ts.to(st)).reshape(BT, 1, K // 2, 2)
    alpha = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return (alpha / alpha.sum(dim=-1, keepdim=True)).to(dt)


def gate_blend_reference(y_s, y_t, alpha):
    """E's blend: y_t * alpha[..., 1] + y_s * alpha[..., 0] in the dtype
    (each product and the sum rounded), alpha (BT, 1, C, 2)."""
    return y_t * alpha[..., 1] + y_s * alpha[..., 0]


def _check_operands(name, x, expected, widths, aligned):
    """Raise unless every (tensor, dtype, shape) of ``expected`` is a
    contiguous tensor of that dtype and shape on x's CUDA device and, for
    bf16, ``widths`` are multiples of 8 and ``aligned`` 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: the kernel takes f32 or bf16, got {x.dtype}")
    for t, dtype, shape in expected:
        if t.dtype != dtype or t.shape != shape or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} "
                             f"{tuple(shape)} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.dtype == torch.bfloat16 and (any(w % 8 for w in widths)
                                      or any(t.data_ptr() % 16 for t in aligned)):
        raise ValueError(f"{name}: the bf16 kernel moves 16-byte rows: the widths {widths} "
                         "must be multiples of 8 and x and the weights 16-byte aligned")
    if -(-x.numel() // x.shape[-1] // 64) > 65535:
        raise ValueError(f"{name}: {x.numel() // x.shape[-1]} rows exceed the grid")


def _launch_ln_rows(x2, ln_scale, ln_bias, eps):
    """LN of the rows of the checked bf16 (M, C) x2, rounded: one launch."""
    out = torch.empty_like(x2)
    lib = kernels.library()
    with torch.cuda.device(x2.device):
        kernels.check(lib.maed_ln_rows(
            x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), eps, out.data_ptr(),
            x2.shape[0], x2.shape[1], torch.cuda.current_stream().cuda_stream), "maed_ln_rows")
    kernels.LAUNCHES["ln_rows"] += 1
    return out


def _launch_dense(epilogue, a2, w, b, residual=None, ln=None):
    """epilogue(A @ w.T + b) of the checked (M, K) a2: one launch, the TMA +
    wgmma kernel in bf16, the scalar one in f32, which takes ``ln`` =
    (ln_scale, ln_bias, eps) for "bias" and "gelu" and normalizes a2's rows
    as its A there."""
    code, count = _epilogue(epilogue)
    (M, K), N = a2.shape, w.shape[0]
    out = torch.empty((M, N), dtype=a2.dtype, device=a2.device)
    res = None if residual is None else residual.data_ptr()
    lib = kernels.library()
    with torch.cuda.device(a2.device):
        stream = torch.cuda.current_stream().cuda_stream
        if a2.dtype == torch.bfloat16:
            status = lib.maed_dense_bf16(code, a2.data_ptr(), w.data_ptr(), b.data_ptr(), res,
                                         out.data_ptr(), M, N, K, stream)
        else:
            scale, shift, eps = (None, None, 0.0) if ln is None else \
                (ln[0].data_ptr(), ln[1].data_ptr(), ln[2])
            status = lib.maed_dense_f32(code, a2.data_ptr(), scale, shift, eps, w.data_ptr(),
                                        b.data_ptr(), res, out.data_ptr(), M, N, K, stream)
        kernels.check(status, f"maed_dense ({epilogue})")
    kernels.LAUNCHES[count] += 1
    return out


def ln_rows(x, ln_scale, ln_bias, eps=1e-6):
    """:func:`ln_rows_reference` as one CUDA launch (bf16 x, any leading
    shape): the pre-pass of :func:`fused_ln_mlp` and :func:`fused_ln_dense`
    in bf16."""
    if x.device.type == "cpu":
        return ln_rows_reference(x, ln_scale, ln_bias, eps)
    C = x.shape[-1]
    _check_operands("ln_rows", x, (
        (x, x.dtype, x.shape), (ln_scale, torch.float32, (C,)),
        (ln_bias, torch.float32, (C,))), widths=(C,), aligned=(x,))
    if x.dtype != torch.bfloat16:
        raise ValueError("ln_rows: the kernel takes bf16 (in f32 the GEMM normalizes its A tile)")
    return _launch_ln_rows(x.reshape(-1, C), ln_scale, ln_bias, eps).reshape(x.shape)


def dense(a, w, b, epilogue="bias", residual=None):
    """:func:`dense_reference` as one CUDA launch (bf16 a, any leading
    shape, (..., K) -> (..., N)). It counts under the kernel whose product
    the epilogue is: "bias" D, "gelu" C's fc1, "residual" C's fc2, "proj"
    E's proj."""
    if a.device.type == "cpu":
        return dense_reference(a, w, b, epilogue, residual)
    _epilogue(epilogue)
    if a.dtype != torch.bfloat16:
        raise ValueError("dense: the kernel takes bf16 (in f32 fused_ln_mlp and fused_ln_dense "
                         "normalize in the GEMM)")
    K, N = a.shape[-1], w.shape[0]
    expected = [(a, a.dtype, a.shape), (w, a.dtype, (N, K)), (b, torch.float32, (N,))]
    aligned = [a, w]
    if epilogue in ("residual", "proj"):
        if residual is None:
            raise ValueError(f"dense: the {epilogue} epilogue needs a residual")
        expected.append((residual, a.dtype, a.shape[:-1] + (N,)))
        aligned.append(residual)
    _check_operands("dense", a, expected, widths=(K, N), aligned=aligned)
    out = _launch_dense(epilogue, a.reshape(-1, K), w, b,
                        None if residual is None else residual.reshape(-1, N))
    return out.reshape(a.shape[:-1] + (N,))


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """:func:`ln_mlp_reference` on the card (x f32 or bf16; any leading
    shape): in bf16 :func:`ln_rows`, then the GEMM with the GELU and the
    residual epilogue; in f32 two launches, the first normalizing its rows."""
    return differentiable(_ln_mlp_kernel, ln_mlp_reference, x, ln_scale, ln_bias, w1, b1, w2,
                          b2, eps)


def _ln_mlp_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    C = x.shape[-1]
    H = w1.shape[0]
    _check_operands("fused_ln_mlp", x, (
        (x, x.dtype, x.shape), (w1, x.dtype, (H, C)), (w2, x.dtype, (C, H)),
        (ln_scale, torch.float32, (C,)), (ln_bias, torch.float32, (C,)),
        (b1, torch.float32, (H,)), (b2, torch.float32, (C,))), widths=(C, H), aligned=(x, w1, w2))
    x2 = x.reshape(-1, C)
    if x.dtype == torch.bfloat16:
        h = _launch_dense("gelu", _launch_ln_rows(x2, ln_scale, ln_bias, eps), w1, b1)
    else:
        h = _launch_dense("gelu", x2, w1, b1, ln=(ln_scale, ln_bias, eps))
    return _launch_dense("residual", h, w2, b2, x2).reshape(x.shape)


def fused_ln_dense(x, ln_scale, ln_bias, w, b, eps=1e-6):
    """:func:`ln_dense_reference` on the card (x f32 or bf16): in bf16
    :func:`ln_rows`, then the GEMM with the bias epilogue; in f32 one launch
    that normalizes its rows; any leading shape, (..., C) -> (..., O)."""
    return differentiable(_ln_dense_kernel, ln_dense_reference, x, ln_scale, ln_bias, w, b, eps)


def _ln_dense_kernel(x, ln_scale, ln_bias, w, b, eps):
    C = x.shape[-1]
    O = w.shape[0]
    _check_operands("fused_ln_dense", x, (
        (x, x.dtype, x.shape), (w, x.dtype, (O, C)),
        (ln_scale, torch.float32, (C,)), (ln_bias, torch.float32, (C,)),
        (b, torch.float32, (O,))), widths=(C, O), aligned=(x, w))
    x2 = x.reshape(-1, C)
    if x.dtype == torch.bfloat16:
        out = _launch_dense("bias", _launch_ln_rows(x2, ln_scale, ln_bias, eps), w, b)
    else:
        out = _launch_dense("bias", x2, w, b, ln=(ln_scale, ln_bias, eps))
    return out.reshape(x.shape[:-1] + (O,))


def _check_gate(name, y_s, y_t, *others):
    """Raise unless y_s and y_t are (BT, N, C) tensors the gate kernels
    take, with ``others`` as (tensor, dtype, shape) beside them; returns
    (BT, N, C)."""
    if y_s.ndim != 3:
        raise ValueError(f"{name}: y_s must be (BT, N, C), got {tuple(y_s.shape)}")
    BT, N, C = y_s.shape
    _check_operands(name, y_s, ((y_s, y_s.dtype, y_s.shape), (y_t, y_s.dtype, y_s.shape),
                                *others),
                    widths=(C,), aligned=[y_s, y_t] + [t for t, dt, _ in others if dt == y_s.dtype])
    if BT == 0 or N == 0 or BT * N > 2 ** 31 - 1 or BT * N * C // 8 > 2 ** 31 - 1:
        raise ValueError(f"{name}: {BT} frames of {N} tokens of {C} channels")
    return BT, N, C


def gate_means(y_s, y_t):
    """:func:`gate_means_reference` as one CUDA launch (f32 or bf16)."""
    if y_s.device.type == "cpu":
        return gate_means_reference(y_s, y_t)
    BT, N, C = _check_gate("gate_means", y_s, y_t)
    means = torch.empty((BT, 2 * C), dtype=y_s.dtype, device=y_s.device)
    lib = kernels.library()
    with torch.cuda.device(y_s.device):
        kernels.check(lib.maed_gate_means(
            int(y_s.dtype == torch.bfloat16), y_s.data_ptr(), y_t.data_ptr(), means.data_ptr(),
            BT, N, C, torch.cuda.current_stream().cuda_stream), "maed_gate_means")
    kernels.LAUNCHES["gate_means"] += 1
    return means


def gate_alpha(means, w_ts, b_ts):
    """:func:`gate_alpha_reference` as one CUDA launch (f32 or bf16 means
    (BT, 2C)): in bf16 a tensor-core product with the pair softmax in its
    epilogue."""
    if means.device.type == "cpu":
        return gate_alpha_reference(means, w_ts, b_ts)
    if means.ndim != 2 or means.shape[1] % 2:
        raise ValueError(f"gate_alpha: means must be (BT, 2C), got {tuple(means.shape)}")
    BT, K = means.shape
    _check_operands("gate_alpha", means, (
        (means, means.dtype, means.shape), (w_ts, means.dtype, (K, K)),
        (b_ts, torch.float32, (K,))), widths=(K // 2,), aligned=(means, w_ts))
    if BT == 0:
        raise ValueError("gate_alpha: no frames")
    alpha = torch.empty((BT, 1, K // 2, 2), dtype=means.dtype, device=means.device)
    lib = kernels.library()
    with torch.cuda.device(means.device):
        kernels.check(lib.maed_gate_alpha(
            int(means.dtype == torch.bfloat16), means.data_ptr(), w_ts.data_ptr(),
            b_ts.data_ptr(), alpha.data_ptr(), BT, K // 2,
            torch.cuda.current_stream().cuda_stream), "maed_gate_alpha")
    kernels.LAUNCHES["gate_alpha"] += 1
    return alpha


def gate_blend(y_s, y_t, alpha):
    """:func:`gate_blend_reference` as one CUDA launch (bf16: in f32 the
    GEMM blends its own A tile)."""
    if y_s.device.type == "cpu":
        return gate_blend_reference(y_s, y_t, alpha)
    alpha_shape = (y_s.shape[0], 1, y_s.shape[-1], 2)
    BT, N, C = _check_gate("gate_blend", y_s, y_t, (alpha, y_s.dtype, alpha_shape))
    if y_s.dtype != torch.bfloat16:
        raise ValueError("gate_blend: the kernel takes bf16 (in f32 the GEMM blends its A tile)")
    y = torch.empty_like(y_s)
    lib = kernels.library()
    with torch.cuda.device(y_s.device):
        kernels.check(lib.maed_gate_blend(
            y_s.data_ptr(), y_t.data_ptr(), alpha.data_ptr(), y.data_ptr(), BT, N, C,
            torch.cuda.current_stream().cuda_stream), "maed_gate_blend")
    kernels.LAUNCHES["gate_blend"] += 1
    return y


def fused_gate_proj(y_s, y_t, x_res, w_ts, b_ts, w_p, b_p):
    """:func:`gate_proj_reference` on the card (f32 or bf16), one C call:
    the branch means, the gate alpha, and in bf16 the blend and the TMA +
    wgmma GEMM with the "proj" epilogue, in f32 the scalar GEMM that blends
    its A tile. y_s, y_t, x_res (BT, N, C). Only the first output, the
    block state, has a gradient; alpha goes out detached."""
    return differentiable(_gate_proj_kernel, gate_proj_reference, y_s, y_t, x_res, w_ts, b_ts,
                          w_p, b_p, n_diff=1)


def _gate_proj_kernel(y_s, y_t, x_res, w_ts, b_ts, w_p, b_p):
    C = y_s.shape[-1]
    BT, N, C = _check_gate("fused_gate_proj", y_s, y_t, (x_res, y_s.dtype, y_s.shape),
                           (w_ts, y_s.dtype, (2 * C, 2 * C)), (w_p, y_s.dtype, (C, C)),
                           (b_ts, torch.float32, (2 * C,)), (b_p, torch.float32, (C,)))
    is_bf16 = y_s.dtype == torch.bfloat16
    means = torch.empty((BT, 2 * C), dtype=y_s.dtype, device=y_s.device)
    alpha = torch.empty((BT, 1, C, 2), dtype=y_s.dtype, device=y_s.device)
    y = torch.empty_like(y_s) if is_bf16 else None
    out = torch.empty_like(y_s)
    lib = kernels.library()
    with torch.cuda.device(y_s.device):
        kernels.check(lib.maed_gate_proj(
            int(is_bf16), y_s.data_ptr(), y_t.data_ptr(), x_res.data_ptr(), w_ts.data_ptr(),
            b_ts.data_ptr(), w_p.data_ptr(), b_p.data_ptr(), means.data_ptr(),
            alpha.data_ptr(), None if y is None else y.data_ptr(), out.data_ptr(), BT, N, C,
            torch.cuda.current_stream().cuda_stream), "maed_gate_proj")
    for name in ("gate_means", "gate_alpha", "gate_blend", "gate_proj") if is_bf16 else \
            ("gate_means", "gate_alpha", "gate_proj"):
        kernels.LAUNCHES[name] += 1
    return out, alpha
