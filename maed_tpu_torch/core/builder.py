"""Build the MAED: the entry points of the port's eval forward and of its
training.

Port of ``maed_tpu/core/builder.py::build_eval_model``. It takes keyword
arguments (:func:`model_config` makes them from a config), and seeded
random weights when no state_dict is given. Either model of the two-stage
recipe: the stage-2 MAED (encoder 'ste', decoder 'ktd') and the stage-1 one
(encoder 'cnn', the ResNet-50 with BatchNorm; decoder 'ktd' or
'iterative'). As in the JAX builder, the ViT's weight standardization is
folded into the stem's weights for eval, so that model runs the
``standardize_ws=False`` path; the ResNet's BatchNorm statistics travel in
the state_dict as buffers. :func:`build_train_model` builds the model that
``parallel.train_step`` trains: f32 master weights, cast at use, and the
standardization in the forward. :func:`load_weights` reads the weights
of a ``.pth.tar``: the port's own checkpoints and the reference-layout file
``python -m maed_tpu.utils.torch_convert`` exports from a JAX run (orbax
directories are not read: that converter is the way across).
:func:`build_encoder` builds an encoder alone: a stock ViT of the factory
catalog, or a (pre-activation) ResNetV2. Under tensor parallelism (``mesh=``
of ``parallel.mesh.make_mesh`` with tp > 1) both model builders take the
full, reference-named weights (or draw them whole from the seed) and keep
the rank's shards (``parallel.mesh.shard_state_dict``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.models.resnet import BatchNorm
from maed_tpu_torch.models.resnetv2 import GroupNormAct, StdConv
from maed_tpu_torch.models.spin import IterativeRegressor
from maed_tpu_torch.models.vit import FACTORIES, FastLayerNorm, Mlp, StAttention
from maed_tpu_torch.ops.smpl import SMPLModel
from maed_tpu_torch.parallel.mesh import shard_state_dict
from maed_tpu_torch.utils.checkpoint import (fold_weight_standardization, load_checkpoint,
                                             state_dict_of)
from maed_tpu_torch.utils.smpl_io import find_smpl_model


def model_config(cfg) -> dict:
    """The model keyword arguments of :func:`build_train_model` and
    :func:`build_eval_model` from a config's MODEL and DATASET sections:
    the encoder ('ste' or 'cnn') and decoder ('ktd' or 'iterative') with
    their sizes."""
    enc, dec, d = cfg.MODEL.ENCODER, cfg.MODEL.DECODER, cfg.DATASET
    if d.WIDTH != d.HEIGHT:
        raise ValueError(f"DATASET.WIDTH {d.WIDTH} != HEIGHT {d.HEIGHT}: the model takes square crops")
    return dict(encoder=enc.BACKBONE.lower(), decoder=dec.BACKBONE.lower(),
                num_blocks=enc.NUM_BLOCKS, num_heads=enc.NUM_HEADS, hidden_dim=dec.HIDDEN_DIM,
                img_size=d.WIDTH, st_mode=enc.SPA_TEMP_MODE)


def load_weights(path: str) -> dict:
    """The reference-named state_dict of a ``.pth(.tar)`` checkpoint."""
    if not path.endswith((".pth", ".pth.tar", ".pt", ".tar")):
        raise ValueError(f"{path}: the port reads .pth.tar checkpoints; convert an orbax "
                         "directory with `python -m maed_tpu.utils.torch_convert`")
    return state_dict_of(load_checkpoint(path))


def device_of(cfg) -> torch.device:
    """The device a config runs on: the CPU for DEVICE 'cpu', else the card
    (the schema's default 'tpu' and the reference's 'cuda' alike), which
    must be present: a run meant for the card never carries on on the CPU."""
    if str(cfg.DEVICE).lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"DEVICE {cfg.DEVICE!r} needs a CUDA device and none is visible; "
                           "set DEVICE cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def configure_backends(cfg) -> None:
    """cuDNN's flags from the config's CUDNN section, as the reference sets
    them, and TF32 off: the model's f32 is f32 arithmetic."""
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    torch.backends.cudnn.deterministic = bool(cfg.CUDNN.DETERMINISTIC)
    torch.backends.cudnn.enabled = bool(cfg.CUDNN.ENABLED)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def init_weights_(model: nn.Module, seed: int) -> None:
    """Seeded random weights of a MAED (or of an encoder alone:
    :func:`build_encoder`), drawn on the model's device, with the scales of
    the JAX package's initializers: He-normal (fan-out) stem convs of the
    ViT, LeCun-normal ResNet convs and dense layers (and the stock ViTs'
    patch conv), xavier-uniform with gain 0.01 for the decoder's output
    regressors, N(0, 0.02) embeddings, unit norms; BatchNorm as flax starts
    it (scale 1, bias 0, running mean 0, variance 1, no batch tracked)."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    small = set()
    if isinstance(model, MAED):
        dec = model.decoder
        small = {id(m) for m in (dec.decshape, dec.deccam, *getattr(dec, "joint_regs", ()))}
        if isinstance(dec, IterativeRegressor):
            small.add(id(dec.decpose))
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
            if mod.bias is not None:
                const(mod.bias, 0.0)
        elif isinstance(mod, (GroupNormAct, FastLayerNorm)):
            const(mod.weight, 1.0)
            const(mod.bias, 0.0)
        elif isinstance(mod, BatchNorm):
            mod.reset_()
            done.update((id(mod.weight), id(mod.bias)))
    enc = model.encoder if isinstance(model, MAED) else model
    # the ViT's; temp_embed only in the modes that mix frames by position
    embeds = [p for p in (getattr(enc, name, None) for name in
                          ("cls_token", "pos_embed", "temp_embed")) if p is not None]
    for p in embeds:
        nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=g)
        done.add(id(p))
    missed = [name for name, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise RuntimeError(f"init_weights_: no initializer for {missed}")


def cast_weights_(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast, once, every parameter the forward casts to ``dtype`` where it is
    used: the dense, MLP and conv weights, the dense and conv biases and the
    embeddings. The same rounding as the cast at use, without a copy per
    call. The norms' parameters and the biases that a kernel takes in f32
    stay f32: the MLP's, the qkv projection's (but in st_mode 'temporal',
    whose projection is a plain product) and, in st_mode 'parallel', the
    gate's and the output projection's. BatchNorm's affine stays f32, as
    its running statistics (buffers, never cast) do."""
    keep = set()
    for mod in model.modules():
        if isinstance(mod, (FastLayerNorm, GroupNormAct, BatchNorm)):
            keep.update(id(p) for p in mod.parameters())
        elif isinstance(mod, Mlp):
            keep.update((id(mod.fc1.bias), id(mod.fc2.bias)))
        elif isinstance(mod, StAttention):
            if mod.st_mode != "temporal" and mod.qkv.bias is not None:
                keep.add(id(mod.qkv.bias))
            if mod.st_mode == "parallel":
                keep.update((id(mod.ts_attn.bias), id(mod.proj.bias)))
    for p in model.parameters():
        if id(p) not in keep:
            p.data = p.data.to(dtype)


def empty_model(device, **kwargs) -> MAED:
    """``MAED(**kwargs)`` on ``device`` with its weights uninitialized (built
    on the meta device, no weight drawn twice) and the iterative decoder's
    mean parameters in place."""
    with torch.device("meta"):
        model = MAED(**kwargs)
    # to_empty's empty_like of a meta tensor loads the meta decompositions at
    # its first call in a process (about a second); torch.empty does not
    model = model._apply(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device))
    if isinstance(model.decoder, IterativeRegressor):
        model.decoder.reset_mean_params_()
    return model


def split_model(model: MAED, mesh, device, **kwargs) -> MAED:
    """The MAED of ``mesh``'s tp rank (``empty_model(device, mesh=mesh,
    **kwargs)``) holding its shards of ``model``'s weights; ``model`` itself
    without a mesh or at tp = 1."""
    if mesh is None or mesh.tp == 1:
        return model
    local = empty_model(device, mesh=mesh, **kwargs)
    local.load_state_dict(shard_state_dict(model.state_dict(), mesh), strict=True)
    return local


def build_train_model(*, encoder: str = "ste", decoder: str = "ktd", num_blocks: int = 6,
                      num_heads: int = 12, hidden_dim: int = 1024, img_size: int = 224,
                      st_mode: str = "parallel", dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda", seed: int = 0,
                      state_dict: dict | None = None, allow_synthetic_smpl: bool = False,
                      smpl_dir: str = "data/smpl_data",
                      remat: bool = False, mesh=None) -> tuple[MAED, SMPLModel]:
    """(model, smpl) for ``parallel.train_step.make_train_step``, the model in
    training mode.

    The defaults are the released stage-2 recipe's model (KTD dropout 0.5,
    no other dropout); encoder 'cnn' is stage 1's (the ResNet-50, whose
    BatchNorm normalizes by the batch and updates its running statistics
    in a training forward). ``dtype`` is the compute dtype, f32 (the
    recipe's) or bf16; the parameters stay f32 master weights whatever it
    is, and the forward casts them at use. The ViT's stem standardizes its
    weights in the forward (``standardize_ws=True``), which is what
    training differentiates, so nothing is folded. ``remat`` recomputes
    each ViT block in the backward instead of keeping its activations (the
    JAX package's ``MAED.remat``). Weights and body as in
    :func:`build_eval_model`; with a ``mesh`` of tp > 1 the rank's shards of
    them (Adam then runs on the shards).
    """
    kwargs = dict(encoder=encoder, decoder=decoder, num_blocks=num_blocks, num_heads=num_heads,
                  hidden_dim=hidden_dim, img_size=img_size, standardize_ws=True, st_mode=st_mode,
                  smpl_dir=smpl_dir, remat=remat, dtype=dtype)
    model = empty_model(device, **kwargs)
    if state_dict is None:
        init_weights_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    model = split_model(model, mesh, device, **kwargs)
    model.train()
    smpl = find_smpl_model(smpl_dir, allow_synthetic=allow_synthetic_smpl, device=device)
    return model, smpl


def build_eval_model(*, encoder: str = "ste", decoder: str = "ktd", num_blocks: int = 6,
                     num_heads: int = 12, hidden_dim: int = 1024, img_size: int = 224,
                     st_mode: str = "parallel", dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cuda", seed: int = 0,
                     state_dict: dict | None = None,
                     allow_synthetic_smpl: bool = False,
                     smpl_dir: str = "data/smpl_data", mesh=None) -> tuple[MAED, SMPLModel]:
    """(model, smpl) ready for ``model(clips, smpl, J_regressor=...)``.

    The defaults are the released stage-2 model; ``st_mode`` picks another
    attention mode of ``models.vit.ST_MODES``, and encoder 'cnn' with
    decoder 'ktd' or 'iterative' the stage-1 model, which normalizes by
    its BatchNorm's running statistics. ``state_dict`` holds
    reference-named weights (``utils.weights.state_dict_from_jax`` or a
    reference checkpoint's; the BatchNorm statistics with them); without it
    the weights are random from ``seed``. ``dtype`` is the activation dtype
    (bf16 serves, f32 is the reference eval protocol); the weights used in
    ``dtype`` are cast to it once (``cast_weights_``), the rest stay f32.
    The SMPL body comes from ``smpl_dir``, or is the synthetic 6890-vertex
    body when ``allow_synthetic_smpl`` allows the fallback. With a ``mesh``
    of tp > 1 the model holds the rank's shards of the weights and every
    rank of its tp group must call it and the model's forward together.
    """
    kwargs = dict(encoder=encoder, decoder=decoder, num_blocks=num_blocks, num_heads=num_heads,
                  hidden_dim=hidden_dim, img_size=img_size, standardize_ws=False,
                  st_mode=st_mode, smpl_dir=smpl_dir, dtype=dtype)
    model = empty_model(device, **kwargs)
    if state_dict is None:
        init_weights_(model, seed)
        state_dict = model.state_dict()
    # the fold touches the ViT stem's convs only: the ResNet has no StdConv
    model.load_state_dict(fold_weight_standardization(state_dict), strict=True)
    model = split_model(model, mesh, device, **kwargs)
    cast_weights_(model, dtype)
    model.eval()
    smpl = find_smpl_model(smpl_dir, allow_synthetic=allow_synthetic_smpl, device=device)
    return model, smpl


def build_encoder(factory, *, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cuda", seed: int = 0,
                  state_dict: dict | None = None, **kwargs) -> nn.Module:
    """An encoder alone, in eval mode, ready for ``encoder(frames, seqlen=T)``
    (a ViT: (B*T, H, W, 3) frames) or ``encoder(x)`` (a ResNetV2: (B, 3, H,
    W)): ``factory(dtype=dtype, **kwargs)`` on ``device``, ``factory`` a name
    of ``models.vit.FACTORIES`` (the stock ViTs, e.g.
    ``build_encoder("vit_large_patch16_384", st_mode="parallel")``), one of
    those functions, or any callable that builds a ViT or a ResNetV2
    (``functools.partial(ResNetV2, preact=True)``). The weights are
    ``state_dict``'s (reference-named: ``utils.weights.state_dict_from_jax(
    params, root="vit" | "resnetv2")``), loaded strictly, or seeded random
    ones; those used in ``dtype`` are cast to it once (:func:`cast_weights_`).
    A stem's weight standardization stays in the forward. Unlike a MAED's,
    the encoder's forward enters no ``torch.inference_mode()``: the caller
    does."""
    if isinstance(factory, str):
        if factory not in FACTORIES:
            raise ValueError(f"build_encoder: no factory {factory!r}; the catalog is "
                             f"{sorted(FACTORIES)}")
        factory = FACTORIES[factory]
    with torch.device("meta"):
        model = factory(dtype=dtype, **kwargs)
    model = model._apply(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device))
    if state_dict is None:
        init_weights_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    cast_weights_(model, dtype)
    return model.eval()
