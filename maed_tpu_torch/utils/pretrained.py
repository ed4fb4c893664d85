"""The published encoder init (``--init_backbone``) of the stage-2 recipe.

Port of ``maed_tpu/utils/pretrained.py``. The reference builds its encoder
from timm's ``jx_vit_base_resnet50_224_in21k`` weights; this module reads
both forms that init is published in and copies it into the port's MAED:

  * ``.npz``, the original JAX/TF naming (``resnet/root_block/...``,
    ``resnet/block{i}/unit{j}/{a,b,c}/...``, ``Transformer/encoderblock_{i}/
    ...``, ``cls``, ``embedding/kernel``): :func:`convert_timm_npz` maps it
    onto the flax parameter paths (q, k and v merged into one ``qkv``;
    flax's layout, so no transpose), and ``utils.weights`` onto the port's
    reference names and torch layouts (OIHW convs, (out, in) dense);
  * ``.pth`` / ``.pth.tar``, timm's torch state_dict (reference names
    already): each key takes the prefix ``encoder.``, ``head.*`` is dropped.

Only keys of the model with the same shape are copied: pretrained blocks
beyond the model's depth are left out, as the reference's ``strict=False``
load leaves them, and MAED's own parameters (the attention's gate,
``temp_embed``) keep their init.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from maed_tpu_torch.utils.checkpoint import load_pretrained_state
from maed_tpu_torch.utils.weights import state_dict_from_jax

_CONV = {"a": "conv1", "b": "conv2", "c": "conv3"}
_NORM = {"a": "norm1", "b": "norm2", "c": "norm3"}
_GN = {"gamma": "scale", "beta": "bias"}
_STAGES = "patch_embed/backbone"


def _npz_path(key: str, value: np.ndarray):
    """The flax path (under the encoder) and value of one npz entry, None for
    q/k/v (merged by :func:`convert_timm_npz`), or False if unmatched."""
    if key == "resnet/root_block/standardized_conv2d/kernel":
        return f"{_STAGES}/stem_conv/kernel", value
    if m := re.fullmatch(r"resnet/group_norm/(gamma|beta)", key):
        return f"{_STAGES}/stem_norm/GroupNorm_0/{_GN[m[1]]}", value
    if m := re.fullmatch(r"resnet/block(\d+)/unit(\d+)/(a/proj|[abc])/"
                         r"(standardized_conv2d/kernel|group_norm/(gamma|beta))", key):
        block = f"{_STAGES}/stage{int(m[1]) - 1}/block{int(m[2]) - 1}"
        if m[3] == "a/proj":
            if m[5] is None:
                return f"{block}/downsample/conv/kernel", value
            return f"{block}/downsample/norm/GroupNorm_0/{_GN[m[5]]}", value
        if m[5] is None:
            return f"{block}/{_CONV[m[3]]}/kernel", value
        return f"{block}/{_NORM[m[3]]}/GroupNorm_0/{_GN[m[5]]}", value
    if key in ("embedding/kernel", "embedding/bias"):
        return f"patch_embed/proj/{key.split('/')[-1]}", value
    if key == "cls":
        return "cls_token", value.reshape(1, 1, -1)
    if key == "Transformer/posembed_input/pos_embedding":
        return "pos_embed", value
    if m := re.fullmatch(r"Transformer/encoder_norm/(scale|bias)", key):
        return f"norm/{m[1]}", value
    if m := re.fullmatch(r"pre_logits/(kernel|bias)", key):
        return f"pre_logits/{m[1]}", value
    if m := re.fullmatch(r"Transformer/encoderblock_(\d+)/(.+)", key):
        base, rest = f"blocks_{int(m[1])}", m[2]
        if mm := re.fullmatch(r"LayerNorm_([02])/(scale|bias)", rest):
            return f"{base}/{'norm1' if mm[1] == '0' else 'norm2'}/{mm[2]}", value
        if mm := re.fullmatch(r"MlpBlock_3/Dense_(\d)/(kernel|bias)", rest):
            return f"{base}/mlp/{'fc1' if mm[1] == '0' else 'fc2'}/{mm[2]}", value
        if mm := re.fullmatch(r"MultiHeadDotProductAttention_1/out/(kernel|bias)", rest):
            # the kernel (h, d, C) -> (C, C)
            v = value.reshape(-1, value.shape[-1]) if mm[1] == "kernel" else value
            return f"{base}/attn/proj/{mm[1]}", v
        if re.fullmatch(r"MultiHeadDotProductAttention_1/(query|key|value)/(kernel|bias)", rest):
            return None
    return False


def _set(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


def convert_timm_npz(weights: dict) -> tuple[dict, list]:
    """The npz entries (TF/JAX naming) -> (the encoder's flax parameter
    subtree, the keys that map nowhere). Each block's separate q, k and v
    kernels (C, h, d) and biases become one ``qkv`` (C, 3C) and (3C,)."""
    tree: dict = {}
    unmatched = []
    for key, value in weights.items():
        out = _npz_path(key, value)
        if out is False:
            unmatched.append(key)
        elif out is not None:
            _set(tree, *out)
    blocks = sorted({int(m[1]) for k in weights
                     if (m := re.fullmatch(r"Transformer/encoderblock_(\d+)/.*", k))})
    for i in blocks:
        prefix = f"Transformer/encoderblock_{i}/MultiHeadDotProductAttention_1"
        kernels = [f"{prefix}/{n}/kernel" for n in ("query", "key", "value")]
        if not all(k in weights for k in kernels):
            continue
        C = weights[kernels[0]].shape[0]
        _set(tree, f"blocks_{i}/attn/qkv/kernel",
             np.concatenate([weights[k].reshape(C, -1) for k in kernels], axis=1))
        _set(tree, f"blocks_{i}/attn/qkv/bias",
             np.concatenate([weights[f"{prefix}/{n}/bias"].reshape(-1)
                             for n in ("query", "key", "value")], axis=0))
    return tree, unmatched


def load_pretrained_backbone(path: str) -> dict[str, torch.Tensor]:
    """A published init as the port's encoder state_dict (``encoder.*``)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            weights = dict(f)
        tree, unmatched = convert_timm_npz(weights)
        if unmatched:
            print(f"[pretrained] {len(unmatched)} unmatched npz keys, e.g. {unmatched[:5]}")
        return state_dict_from_jax({"encoder": tree})
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    return {"encoder." + k: torch.as_tensor(v) for k, v in sd.items()
            if not k.startswith(("head.", "module.head."))}


def apply_pretrained_backbone(model: torch.nn.Module, path: str) -> list[str]:
    """Copy a published init into ``model`` where the key exists and the
    shape matches; returns the keys of the file not used."""
    unused = load_pretrained_state(model, load_pretrained_backbone(path))
    if unused:
        print(f"[pretrained] {len(unused)} unused keys (depth mismatch is normal), "
              f"e.g. {unused[:3]}")
    return unused
