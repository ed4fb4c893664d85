"""Carry the JAX package's parameters across to the port.

A flax MAED parameter tree is mapped onto the reference torch MAED's
state_dict names and layouts (conv HWIO -> OIHW, dense (in, out) -> (out,
in), norm scale -> weight). The port's modules use those names, so the result
loads with ``load_state_dict(..., strict=True)``, as the released
``.pth.tar`` will.

The mapping is the port's own copy of ``maed_tpu/utils/torch_convert.py``'s
inverse direction (``_flatten``, ``translate_flax_path``,
``convert_params_to_state_dict``), for the modules the port has: it needs
numpy and ``re`` only, and the port imports nothing of the JAX package.
``tests/test_torch_port_slice.py`` holds the copy equal to the original key
for key.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


# (flax-path regex, torch-key replacement); the value's layout follows from
# the leaf's name
_RENAMES = [
    (r"^encoder/patch_embed/backbone/stem_conv/",
     r"encoder.patch_embed.backbone.stem.conv/"),
    (r"^encoder/patch_embed/backbone/stem_norm/GroupNorm_0/",
     r"encoder.patch_embed.backbone.stem.norm/"),
    (r"^encoder/patch_embed/backbone/stage(\d+)/block(\d+)/downsample/conv/",
     r"encoder.patch_embed.backbone.stages.\1.blocks.\2.downsample.conv/"),
    (r"^encoder/patch_embed/backbone/stage(\d+)/block(\d+)/downsample/norm/GroupNorm_0/",
     r"encoder.patch_embed.backbone.stages.\1.blocks.\2.downsample.norm/"),
    (r"^encoder/patch_embed/backbone/stage(\d+)/block(\d+)/(norm\d)/GroupNorm_0/",
     r"encoder.patch_embed.backbone.stages.\1.blocks.\2.\3/"),
    (r"^encoder/patch_embed/backbone/stage(\d+)/block(\d+)/",
     r"encoder.patch_embed.backbone.stages.\1.blocks.\2."),
    (r"^encoder/blocks_(\d+)/", r"encoder.blocks.\1."),
    (r"^encoder/pre_logits/", r"encoder.pre_logits.fc/"),
    (r"^decoder/joint_reg(\d+)/", r"decoder.joint_regs.\1."),
]


def translate_flax_path(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """flax parameter path and value -> (torch key, torch value)."""
    p = path
    for pat, repl in _RENAMES:
        p = re.sub(pat, repl, p)
    p = p.replace("/", ".")
    leaf = p.rsplit(".", 1)[-1]
    stem = p[: -len(leaf) - 1]
    if leaf == "kernel":
        if value.ndim == 4:
            return f"{stem}.weight", np.transpose(value, (3, 2, 0, 1))
        return f"{stem}.weight", np.transpose(value, (1, 0))
    if leaf == "scale":
        return f"{stem}.weight", value
    return p, value


def convert_params_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """flax parameter tree -> reference-named torch state_dict (numpy)."""
    return dict(translate_flax_path(path, v) for path, v in _flatten(params).items())


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A flax MAED parameter tree (numpy leaves) -> the port's state_dict."""
    return {key: torch.from_numpy(np.ascontiguousarray(value))
            for key, value in convert_params_to_state_dict(params).items()}
