"""The ViT block's fused dense paths: the MLP half, x + fc2(gelu(fc1(LN(x)))),
the qkv projection, Dense(LN(x)), and the parallel attention's tail, x +
proj(gated blend of the two branches); the CUDA kernels of ``csrc/ln_mlp.cu``
and their plain PyTorch versions.

Counterpart of ``maed_tpu/ops/mlp.py``: ``fused_ln_mlp`` and
``ln_mlp_reference``, ``fused_ln_dense`` and ``ln_dense_reference``,
``fused_gate_proj`` and ``gate_proj_reference``. The weights are taken as
``nn.Linear`` stores them: w1 (H, C), w2 (C, H), w (O, C), w_ts (2C, 2C) and
w_p (C, C), in x's dtype; the biases stay f32, as in the TPU kernels. The JAX
package gates its MLP kernel on the weights fitting in VMEM
(``vit.py:473-479``); the CUDA kernels have no such limit and take f32 and
bf16 alike.
"""

from __future__ import annotations

import torch

from maed_tpu_torch import kernels


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


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """:func:`ln_mlp_reference` as two CUDA launches (x f32 or bf16); any
    leading shape."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    C = x.shape[-1]
    H = w1.shape[0]
    _check_operands("fused_ln_mlp", x, (
        (x, x.dtype, x.shape), (w1, x.dtype, (H, C)), (w2, x.dtype, (C, H)),
        (ln_scale, torch.float32, (C,)), (ln_bias, torch.float32, (C,)),
        (b1, torch.float32, (H,)), (b2, torch.float32, (C,))), widths=(C, H), aligned=(x, w1, w2))
    is_bf16 = int(x.dtype == torch.bfloat16)
    x2 = x.reshape(-1, C)
    M = x2.shape[0]
    h = torch.empty((M, H), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x2)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.check(lib.maed_ln_fc1_gelu(
            is_bf16, x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), eps,
            w1.data_ptr(), b1.data_ptr(), h.data_ptr(), M, C, H, stream),
            "maed_ln_fc1_gelu")
        kernels.LAUNCHES["ln_mlp_fc1"] += 1
        kernels.check(lib.maed_fc2_residual(
            is_bf16, h.data_ptr(), w2.data_ptr(), b2.data_ptr(), x2.data_ptr(),
            out.data_ptr(), M, H, C, stream), "maed_fc2_residual")
        kernels.LAUNCHES["ln_mlp_fc2"] += 1
    return out.reshape(x.shape)


def fused_ln_dense(x, ln_scale, ln_bias, w, b, eps=1e-6):
    """:func:`ln_dense_reference` as one CUDA launch (x f32 or bf16): the
    first launch of :func:`fused_ln_mlp` with a plain bias epilogue; any
    leading shape, (..., C) -> (..., O)."""
    if x.device.type == "cpu":
        return ln_dense_reference(x, ln_scale, ln_bias, w, b, eps)
    C = x.shape[-1]
    O = w.shape[0]
    _check_operands("fused_ln_dense", x, (
        (x, x.dtype, x.shape), (w, x.dtype, (O, C)),
        (ln_scale, torch.float32, (C,)), (ln_bias, torch.float32, (C,)),
        (b, torch.float32, (O,))), widths=(C, O), aligned=(x, w))
    x2 = x.reshape(-1, C)
    M = x2.shape[0]
    out = torch.empty((M, O), dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.maed_ln_dense(
            int(x.dtype == torch.bfloat16), x2.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), eps, w.data_ptr(), b.data_ptr(), out.data_ptr(), M, C, O,
            torch.cuda.current_stream().cuda_stream), "maed_ln_dense")
    kernels.LAUNCHES["ln_dense"] += 1
    return out.reshape(x.shape[:-1] + (O,))


def fused_gate_proj(y_s, y_t, x_res, w_ts, b_ts, w_p, b_p):
    """:func:`gate_proj_reference` as two CUDA launches (f32 or bf16): the
    gate alpha from the branch means, then blend, proj and residual in one
    GEMM. y_s, y_t, x_res (BT, N, C)."""
    if y_s.device.type == "cpu":
        return gate_proj_reference(y_s, y_t, x_res, w_ts, b_ts, w_p, b_p)
    if y_s.ndim != 3:
        raise ValueError(f"fused_gate_proj: y_s must be (BT, N, C), got {tuple(y_s.shape)}")
    BT, N, C = y_s.shape
    _check_operands("fused_gate_proj", y_s, (
        (y_s, y_s.dtype, y_s.shape), (y_t, y_s.dtype, y_s.shape), (x_res, y_s.dtype, y_s.shape),
        (w_ts, y_s.dtype, (2 * C, 2 * C)), (w_p, y_s.dtype, (C, C)),
        (b_ts, torch.float32, (2 * C,)), (b_p, torch.float32, (C,))),
        widths=(C,), aligned=(y_s, y_t, x_res, w_ts, w_p))
    if BT == 0 or N == 0 or BT > 2 ** 31 - 1 or BT * N > 2 ** 31 - 1:
        raise ValueError(f"fused_gate_proj: {BT} frames of {N} tokens")
    if 5 * 2 * C * 4 > 227 * 1024:
        raise ValueError(f"fused_gate_proj: the gate of {C} channels exceeds a block's "
                         "shared memory (5 x 2C floats in 227 KB)")
    is_bf16 = int(y_s.dtype == torch.bfloat16)
    alpha = torch.empty((BT, 1, C, 2), dtype=y_s.dtype, device=y_s.device)
    out = torch.empty_like(y_s)
    lib = kernels.library()
    with torch.cuda.device(y_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.check(lib.maed_gate_alpha(
            is_bf16, y_s.data_ptr(), y_t.data_ptr(), w_ts.data_ptr(), b_ts.data_ptr(),
            alpha.data_ptr(), BT, N, C, stream), "maed_gate_alpha")
        kernels.LAUNCHES["gate_alpha"] += 1
        kernels.check(lib.maed_gate_proj(
            is_bf16, y_s.data_ptr(), y_t.data_ptr(), alpha.data_ptr(), w_p.data_ptr(),
            b_p.data_ptr(), x_res.data_ptr(), out.data_ptr(), BT, N, C, stream),
            "maed_gate_proj")
        kernels.LAUNCHES["gate_proj"] += 1
    return out, alpha
