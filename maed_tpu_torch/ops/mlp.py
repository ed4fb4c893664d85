"""The ViT block's MLP half, x + fc2(gelu(fc1(LN(x)))): the CUDA kernel
``csrc/ln_mlp.cu`` and its plain PyTorch version.

Counterpart of ``maed_tpu/ops/mlp.py::fused_ln_mlp`` and
``ln_mlp_reference``. The weights are taken as ``nn.Linear`` stores them:
w1 (H, C) and w2 (C, H), in x's dtype; b1 and b2 stay f32, as in the TPU
kernel. The JAX package gates its kernel on the weights fitting in VMEM
(``vit.py:473-479``); the CUDA kernel has no such limit and takes f32 and
bf16 alike.
"""

from __future__ import annotations

import torch

from maed_tpu_torch import kernels


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    # 0.5 x (1 + erf(x / sqrt(2)))
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    """x + fc2(gelu(fc1(LN(x)))); statistics and accumulation in
    promote(x.dtype, f32), LN(x) and h rounded to x's dtype before each
    product, as the TPU kernel does. w1 (H, C), w2 (C, H)."""
    st = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(st)
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - m * m
    xn = (xf - m) * torch.rsqrt(var + eps)
    xn = xn * ln_scale.to(st) + ln_bias.to(st)

    def product(a, w):  # a @ w.T of x-dtype operands, accumulated in st
        return torch.matmul(a.to(x.dtype).to(st), w.to(x.dtype).to(st).t())

    h = _gelu_exact(product(xn, w1) + b1.to(st))
    y = product(h, w2) + b2.to(st)
    return x + y.to(x.dtype)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """:func:`ln_mlp_reference` as two CUDA launches (x f32 or bf16); any
    leading shape."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp: no kernel for device {x.device}")
    C = x.shape[-1]
    H = w1.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_ln_mlp: the kernel takes f32 or bf16, got {x.dtype}")
    expected = ((x, x.dtype, x.shape), (w1, x.dtype, (H, C)), (w2, x.dtype, (C, H)),
                (ln_scale, torch.float32, (C,)), (ln_bias, torch.float32, (C,)),
                (b1, torch.float32, (H,)), (b2, torch.float32, (C,)))
    for t, dtype, shape in expected:
        if t.dtype != dtype or t.shape != shape or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"fused_ln_mlp: expected contiguous {dtype} "
                             f"{tuple(shape)} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    is_bf16 = int(x.dtype == torch.bfloat16)
    if is_bf16 and (C % 8 or H % 8 or any(t.data_ptr() % 16 for t in (x, w1, w2))):
        raise ValueError("fused_ln_mlp: the bf16 kernel moves 16-byte rows: C and H "
                         f"must be multiples of 8 and x, w1, w2 16-byte aligned (C {C}, H {H})")
    x2 = x.reshape(-1, C)
    M = x2.shape[0]
    if -(-M // 64) > 65535:
        raise ValueError(f"fused_ln_mlp: {M} rows exceed the grid")
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
