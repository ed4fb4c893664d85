"""Where the plain reference rounds, so that it can stand in a lower precision.

``Precision("f32")`` rounds nothing: the reference proper. ``"fp8"`` is the
control of a bf16 configuration: the reference computed in float8 e4m3, each
operand of a product and each layer's output rounded to it with a scale per
tensor (its largest magnitude at 448, e4m3's largest), the products
accumulated in float32. TF32, the control of an f32 configuration, is a
switch of the backends (``torch.backends.cuda.matmul.allow_tf32``), not of
this class.
"""

from __future__ import annotations

import torch

MODES = ("f32", "fp8")
E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} is not one of {MODES}")
        self.mode = mode

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product (a matmul's, a conv's, the attention's) or
        a layer's output, as a program in this precision holds it."""
        return round_fp8(x) if self.mode == "fp8" else x
