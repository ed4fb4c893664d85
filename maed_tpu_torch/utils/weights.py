"""Carry the JAX package's parameters across to the port.

A flax MAED parameter tree is mapped onto the reference torch MAED's
state_dict names and layouts (conv HWIO -> OIHW, dense (in, out) -> (out,
in), norm scale -> weight), and a ``batch_stats`` tree (the 'cnn' encoder's
BatchNorm) onto ``running_mean`` / ``running_var``, with the
``num_batches_tracked`` that torch keeps and flax does not synthesized as
int64 0. The port's modules use those names, so the result loads with
``load_state_dict(..., strict=True)``, as the released ``.pth.tar`` will.

The mapping is the port's own copy of ``maed_tpu/utils/torch_convert.py``'s
inverse direction (``_flatten``, ``translate_flax_path``,
``convert_params_to_state_dict``), for the modules the port has: it needs
numpy and ``re`` only, and the port imports nothing of the JAX package.
``tests/test_torch_port_slice.py`` holds the copy equal to the original key
for key. Beyond it: the trees of a bare stock ViT and of a bare
(pre-activation) ResNetV2 (``_ROOTS``, ``_EXTRA_RENAMES``), which
``tests/test_torch_port_surface.py`` loads with ``strict=True``.
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
    # the torchvision ResNet-50 ('cnn' encoder)
    (r"^encoder/layer(\d)_(\d+)/downsample_conv/", r"encoder.layer\1.\2.downsample.0/"),
    (r"^encoder/layer(\d)_(\d+)/downsample_bn/", r"encoder.layer\1.\2.downsample.1/"),
    (r"^encoder/layer(\d)_(\d+)/", r"encoder.layer\1.\2."),
]


# Trees of the port's modules that are not a MAED: the prefix that places a
# bare tree's paths where a MAED holds that module, and the torch prefix taken
# off again. "vit": a bare VisionTransformer (the stock factories', or a
# hybrid one); "resnetv2": a bare ResNetV2, pre-activation or not.
_ROOTS = {"maed": ("", ""), "vit": ("encoder/", "encoder."),
          "resnetv2": ("encoder/patch_embed/backbone/", "encoder.patch_embed.backbone.")}

# The rules for what a MAED tree never holds, applied after _RENAMES: the
# pre-activation ResNetV2's final norm.
_EXTRA_RENAMES = [
    (r"^encoder/patch_embed/backbone/norm/GroupNorm_0/",
     r"encoder.patch_embed.backbone.norm/"),
]


def translate_flax_path(path: str, value: np.ndarray,
                        collection: str = "params") -> tuple[str, np.ndarray]:
    """flax path and value of ``collection`` ('params' or 'batch_stats') ->
    (torch key, torch value)."""
    p = path
    for pat, repl in _RENAMES + _EXTRA_RENAMES:
        p = re.sub(pat, repl, p)
    p = p.replace("/", ".")
    leaf = p.rsplit(".", 1)[-1]
    stem = p[: -len(leaf) - 1]
    if collection == "batch_stats":
        field = {"mean": "running_mean", "var": "running_var"}[leaf]
        return f"{stem}.{field}", value
    if leaf == "kernel":
        if value.ndim == 4:
            return f"{stem}.weight", np.transpose(value, (3, 2, 0, 1))
        return f"{stem}.weight", np.transpose(value, (1, 0))
    if leaf == "scale":
        return f"{stem}.weight", value
    return p, value


def convert_params_to_state_dict(params: dict,
                                 batch_stats: dict | None = None) -> dict[str, np.ndarray]:
    """flax (params, batch_stats) -> reference-named torch state_dict
    (numpy): the parameters, then each BatchNorm's statistics and its
    ``num_batches_tracked`` (0)."""
    sd = dict(translate_flax_path(path, v) for path, v in _flatten(params).items())
    for path, v in _flatten(batch_stats or {}).items():
        key, value = translate_flax_path(path, v, "batch_stats")
        sd[key] = value
        sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def state_dict_from_jax(params: dict, batch_stats: dict | None = None,
                        root: str = "maed") -> dict[str, torch.Tensor]:
    """A flax parameter tree (numpy leaves) of a MAED, with the 'cnn'
    encoder's ``batch_stats`` tree, or of a bare module (``root`` "vit" or
    "resnetv2", ``_ROOTS``) -> the port's state_dict of that module."""
    if root not in _ROOTS:
        raise ValueError(f"state_dict_from_jax: root {root!r}, want one of {sorted(_ROOTS)}")
    flax_prefix, torch_prefix = _ROOTS[root]
    for part in reversed(flax_prefix.strip("/").split("/") if flax_prefix else []):
        params = {part: params}
    sd = convert_params_to_state_dict(params, batch_stats)
    return {key[len(torch_prefix):]: torch.from_numpy(np.ascontiguousarray(value))
            for key, value in sd.items()}
