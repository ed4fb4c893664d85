"""Build the MAED: the entry points of the port's eval forward and of its
training.

Port of ``maed_tpu/core/builder.py::build_eval_model``. It takes keyword
arguments instead of a yaml config (pyyaml is not promised where the port
runs), and seeded random weights when no state_dict is given. As in the JAX
builder, weight standardization is folded into the stem's weights, so the
model runs the ``standardize_ws=False`` path. :func:`build_train_model`
builds the model that ``parallel.train_step`` trains: f32 master weights,
cast at use, and the standardization in the forward.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.models.resnetv2 import GroupNormAct, StdConv
from maed_tpu_torch.models.vit import FastLayerNorm, Mlp, StAttention
from maed_tpu_torch.ops.smpl import SMPLModel
from maed_tpu_torch.utils.checkpoint import fold_weight_standardization
from maed_tpu_torch.utils.smpl_io import find_smpl_model


def init_weights_(model: MAED, seed: int) -> None:
    """Seeded random weights, drawn on the model's device, with the scales of
    the JAX package's initializers: He-normal (fan-out) stem convs,
    LeCun-normal dense layers, xavier-uniform with gain 0.01 for the
    decoder's output regressors, N(0, 0.02) embeddings, unit norms."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    dec = model.decoder
    small = {id(m) for m in (dec.decshape, dec.deccam, *dec.joint_regs)}
    done = set()

    def normal(p, std):
        nn.init.normal_(p, 0.0, std, generator=g)
        done.add(id(p))

    def const(p, value):
        nn.init.constant_(p, value)
        done.add(id(p))

    for mod in model.modules():
        if isinstance(mod, StdConv):
            out_chs, _, kh, kw = mod.weight.shape
            normal(mod.weight, math.sqrt(2.0 / (out_chs * kh * kw)))
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_out, fan_in = mod.weight.shape[0], mod.weight[0].numel()
            if id(mod) in small:
                bound = 0.01 * math.sqrt(6.0 / (fan_in + fan_out))
                nn.init.uniform_(mod.weight, -bound, bound, generator=g)
                done.add(id(mod.weight))
            else:
                normal(mod.weight, math.sqrt(1.0 / fan_in))
            const(mod.bias, 0.0)
        elif isinstance(mod, (GroupNormAct, FastLayerNorm)):
            const(mod.weight, 1.0)
            const(mod.bias, 0.0)
    enc = model.encoder
    embeds = [enc.cls_token, enc.pos_embed]
    if hasattr(enc, "temp_embed"):  # the modes that mix frames by position
        embeds.append(enc.temp_embed)
    for p in embeds:
        nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=g)
        done.add(id(p))
    missed = [name for name, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise RuntimeError(f"init_weights_: no initializer for {missed}")


def cast_weights_(model: MAED, dtype: torch.dtype) -> None:
    """Cast, once, every parameter the forward casts to ``dtype`` where it is
    used: the dense, MLP and conv weights, the dense and conv biases and the
    embeddings. The same rounding as the cast at use, without a copy per
    call. The norms' parameters and the biases that a kernel takes in f32
    stay f32: the MLP's, the qkv projection's (but in st_mode 'temporal',
    whose projection is a plain product) and, in st_mode 'parallel', the
    gate's and the output projection's."""
    keep = set()
    for mod in model.modules():
        if isinstance(mod, (FastLayerNorm, GroupNormAct)):
            keep.update(id(p) for p in mod.parameters())
        elif isinstance(mod, Mlp):
            keep.update((id(mod.fc1.bias), id(mod.fc2.bias)))
        elif isinstance(mod, StAttention):
            if mod.st_mode != "temporal":
                keep.add(id(mod.qkv.bias))
            if mod.st_mode == "parallel":
                keep.update((id(mod.ts_attn.bias), id(mod.proj.bias)))
    for p in model.parameters():
        if id(p) not in keep:
            p.data = p.data.to(dtype)


def build_train_model(*, num_blocks: int = 6, num_heads: int = 12,
                      hidden_dim: int = 1024, img_size: int = 224,
                      st_mode: str = "parallel", dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda", seed: int = 0,
                      state_dict: dict | None = None, allow_synthetic_smpl: bool = False,
                      smpl_dir: str = "data/smpl_data") -> tuple[MAED, SMPLModel]:
    """(model, smpl) for ``parallel.train_step.make_train_step``, the model in
    training mode.

    The model is the released stage-2 recipe's (KTD dropout 0.5, no other
    dropout). ``dtype`` is the compute dtype, f32 (the recipe's) or bf16;
    the parameters stay f32 master weights whatever it is, and the forward
    casts them at use. The stem standardizes its weights in the forward
    (``standardize_ws=True``), which is what training differentiates, so
    nothing is folded. Weights and body as in :func:`build_eval_model`.
    """
    with torch.device("meta"):
        model = MAED(num_blocks=num_blocks, num_heads=num_heads, hidden_dim=hidden_dim,
                     img_size=img_size, standardize_ws=True, st_mode=st_mode, dtype=dtype)
    model = model.to_empty(device=device)
    if state_dict is None:
        init_weights_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    model.train()
    smpl = find_smpl_model(smpl_dir, allow_synthetic=allow_synthetic_smpl, device=device)
    return model, smpl


def build_eval_model(*, num_blocks: int = 6, num_heads: int = 12,
                     hidden_dim: int = 1024, img_size: int = 224,
                     st_mode: str = "parallel", dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cuda", seed: int = 0,
                     state_dict: dict | None = None,
                     allow_synthetic_smpl: bool = False,
                     smpl_dir: str = "data/smpl_data") -> tuple[MAED, SMPLModel]:
    """(model, smpl) ready for ``model(clips, smpl, J_regressor=...)``.

    The defaults are the released stage-2 model; ``st_mode`` picks another
    attention mode of ``models.vit.ST_MODES``. ``state_dict`` holds
    reference-named weights (``utils.weights.state_dict_from_jax`` or a
    reference checkpoint's); without it the weights are random from
    ``seed``. ``dtype`` is the activation dtype (bf16 serves, f32 is the
    reference eval protocol); the weights used in ``dtype`` are cast to it
    once (``cast_weights_``), the rest stay f32. The SMPL body comes from
    ``smpl_dir``, or is the synthetic 6890-vertex body when
    ``allow_synthetic_smpl`` allows the fallback.
    """
    with torch.device("meta"):
        model = MAED(num_blocks=num_blocks, num_heads=num_heads, hidden_dim=hidden_dim,
                     img_size=img_size, standardize_ws=False, st_mode=st_mode, dtype=dtype)
    model = model.to_empty(device=device)
    if state_dict is None:
        init_weights_(model, seed)
        state_dict = model.state_dict()
    model.load_state_dict(fold_weight_standardization(state_dict), strict=True)
    cast_weights_(model, dtype)
    model.eval()
    smpl = find_smpl_model(smpl_dir, allow_synthetic=allow_synthetic_smpl, device=device)
    return model, smpl
