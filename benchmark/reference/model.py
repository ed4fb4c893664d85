"""The plain reference of MAED (arXiv:2109.02303), in float32 torch.

Two configurations share the decoder:

- encoder ``ste``: the R50+ViT-B/16 hybrid. A ResNetV2 stem (weight-
  standardized convs with TF "SAME" padding, GroupNorm(32), bottlenecks of
  layers (3, 4, 9)), a 1x1 projection to 768-wide tokens, a cls token,
  position and clip-frame embeddings, then blocks of spatio-temporal
  attention in the ``parallel`` mode (one qkv projection feeds attention
  over a frame's tokens and attention over a clip's frames, blended per
  channel by a softmax gate of the two branches' means), an MLP, the final
  LayerNorm and the tanh pre-logits of the cls token;
- encoder ``cnn``: ResNet-50 v1.5 with BatchNorm (the batch's biased
  moments in training, the running ones in eval), globally mean-pooled;
- decoder ``ktd``: two dense layers (dropout after each in training), the
  shape and camera heads, and 24 joint regressors in kinematic order, each
  fed the trunk feature and its ancestors' 6D rotations; then SMPL
  (``body.smpl``), the eval regressor's joints or the 49-joint bank, the
  weak-perspective projection and theta = (camera, axis-angle pose, shape).

The parameters are a flat dict under the reference MAED's names, the
names the port's state_dict uses; :func:`param_specs` lists them with their
shapes and how the benchmark draws them. Nothing of the port is imported:
this file and its neighbours are the yardstick the port is held to.
``Precision`` says where a lower-precision control rounds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.body import ancestors, rot6d_to_rotmat, rotmat_to_axis_angle, smpl
from benchmark.reference.body import weak_perspective
from benchmark.reference.precision import Precision

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ANCESTORS = ancestors()
# the hybrid stem's ResNetV2: (out channels, stride of the first block)
STEM_STAGES = ((256, 1), (512, 2), (1024, 2))
R50_LAYERS, R50_CHANNELS = (3, 4, 6, 3), (256, 512, 1024, 2048)


def make_div(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


# ------------------------------------------------------------ the parameters

def param_specs(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, how it is drawn) of every parameter (and BatchNorm
    buffer) of the configuration. How: ("he", fan_out) He-normal for the
    standardized stem convs, ("lecun", fan_in) for the other convs and dense
    layers, ("small", fan_in, fan_out) for the decoder's output regressors
    (Xavier at gain 0.01), ("embed",) N(0, 0.02) cut at 0.04, ("const", v)."""
    specs = []

    def dense(name, n_in, n_out, bias=0.0, init=None):
        specs.append((f"{name}.weight", (n_out, n_in), init or ("lecun", n_in)))
        specs.append((f"{name}.bias", (n_out,), ("const", bias)))

    def norm(name, n):
        specs.append((f"{name}.weight", (n,), ("const", 1.0)))
        specs.append((f"{name}.bias", (n,), ("const", 0.0)))

    def std_conv(name, n_in, n_out, k):
        specs.append((f"{name}.weight", (n_out, n_in, k, k), ("he", n_out * k * k)))

    if cfg["encoder"] == "ste":
        C, depth = cfg["embed_dim"], cfg["num_blocks"]
        hidden = int(C * cfg["mlp_ratio"])
        stem = "encoder.patch_embed.backbone"
        std_conv(f"{stem}.stem.conv", 3, 64, 7)
        norm(f"{stem}.stem.norm", 64)
        in_chs = 64
        for s, ((chs, _), n_blocks) in enumerate(zip(STEM_STAGES, cfg["stem_layers"])):
            mid = make_div(chs * 0.25)
            for b in range(n_blocks):
                pre = f"{stem}.stages.{s}.blocks.{b}"
                if b == 0:
                    std_conv(f"{pre}.downsample.conv", in_chs, chs, 1)
                    norm(f"{pre}.downsample.norm", chs)
                std_conv(f"{pre}.conv1", in_chs if b == 0 else chs, mid, 1)
                norm(f"{pre}.norm1", mid)
                std_conv(f"{pre}.conv2", mid, mid, 3)
                norm(f"{pre}.norm2", mid)
                std_conv(f"{pre}.conv3", mid, chs, 1)
                norm(f"{pre}.norm3", chs)
            in_chs = chs
        specs.append(("encoder.patch_embed.proj.weight", (C, in_chs, 1, 1), ("lecun", in_chs)))
        specs.append(("encoder.patch_embed.proj.bias", (C,), ("const", 0.0)))
        tokens = (cfg["img_size"] // 16) ** 2 + 1
        specs.append(("encoder.cls_token", (1, 1, C), ("embed",)))
        specs.append(("encoder.pos_embed", (1, tokens, C), ("embed",)))
        specs.append(("encoder.temp_embed", (1, cfg["seqlen"], 1, C), ("embed",)))
        for i in range(depth):
            pre = f"encoder.blocks.{i}"
            norm(f"{pre}.norm1", C)
            dense(f"{pre}.attn.qkv", C, 3 * C)
            dense(f"{pre}.attn.proj", C, C)
            dense(f"{pre}.attn.ts_attn", 2 * C, 2 * C)
            norm(f"{pre}.norm2", C)
            dense(f"{pre}.mlp.fc1", C, hidden)
            dense(f"{pre}.mlp.fc2", hidden, C)
        norm("encoder.norm", C)
        dense("encoder.pre_logits.fc", C, C)
        feat = C
    else:
        specs.append(("encoder.conv1.weight", (64, 3, 7, 7), ("lecun", 3 * 49)))
        _bn(specs, "encoder.bn1", 64)
        in_chs = 64
        for si, (depth, chs) in enumerate(zip(R50_LAYERS, R50_CHANNELS)):
            mid = chs // 4
            for bi in range(depth):
                pre = f"encoder.layer{si + 1}.{bi}"
                for n, (a, b, k) in enumerate(((in_chs, mid, 1), (mid, mid, 3), (mid, chs, 1))):
                    specs.append((f"{pre}.conv{n + 1}.weight", (b, a, k, k), ("lecun", a * k * k)))
                    _bn(specs, f"{pre}.bn{n + 1}", b)
                if bi == 0:
                    specs.append((f"{pre}.downsample.0.weight", (chs, in_chs, 1, 1),
                                  ("lecun", in_chs)))
                    _bn(specs, f"{pre}.downsample.1", chs)
                in_chs = chs
        feat = R50_CHANNELS[-1]
    H = cfg["hidden_dim"]
    dense("decoder.fc1", feat, H)
    dense("decoder.fc2", H, H)
    dense("decoder.decshape", H, 10, init=("small", H, 10))
    dense("decoder.deccam", H, 3, init=("small", H, 3))
    for j, anc in enumerate(ANCESTORS):
        n_in = H + 6 * len(anc)
        dense(f"decoder.joint_regs.{j}", n_in, 6, init=("small", n_in, 6))
    return specs


def _bn(specs, name, n):
    specs += [(f"{name}.weight", (n,), ("const", 1.0)), (f"{name}.bias", (n,), ("const", 0.0)),
              (f"{name}.running_mean", (n,), ("const", 0.0)),
              (f"{name}.running_var", (n,), ("const", 1.0)),
              (f"{name}.num_batches_tracked", (), ("count",))]


def std_of(init) -> float:
    """The standard deviation a draw of ``init`` scales a unit normal by."""
    kind = init[0]
    if kind == "he":
        return math.sqrt(2.0 / init[1])
    if kind == "lecun":
        return math.sqrt(1.0 / init[1])
    if kind == "small":  # Xavier-uniform at gain 0.01, as a normal of its variance
        return 0.01 * math.sqrt(2.0 / (init[1] + init[2]))
    if kind == "embed":
        return 0.02
    raise ValueError(kind)


# ------------------------------------------------------------ the layers

def _linear(p, name, x, pr: Precision):
    y = torch.matmul(pr.round(x), pr.round(p[f"{name}.weight"]).t())
    return pr.round(y + p[f"{name}.bias"])


def _layernorm(p, name, x, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _pad_same(x, k, stride, value=0.0):
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _std_conv(p, name, x, stride, pr):
    w = p[f"{name}.weight"]
    var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0, keepdim=True)
    w = (w - mean) / (torch.sqrt(var) + 1e-5)
    x = _pad_same(x, w.shape[-1], stride)
    return pr.round(F.conv2d(pr.round(x), pr.round(w), stride=stride))


def _groupnorm(p, name, x, pr, relu, residual=None):
    y = F.group_norm(x, 32, p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)
    if residual is not None:
        y = y + residual
    return pr.round(torch.relu(y) if relu else y)


def hybrid_stem(p, x, cfg, pr):
    """(B, 3, H, W) normalized frames -> (B, H/16 * W/16, C) tokens."""
    stem = "encoder.patch_embed.backbone"
    y = _groupnorm(p, f"{stem}.stem.norm", _std_conv(p, f"{stem}.stem.conv", x, 2, pr), pr, True)
    y = F.max_pool2d(_pad_same(y, 3, 2, value=-math.inf), 3, 2)
    for s, ((_, stride), n_blocks) in enumerate(zip(STEM_STAGES, cfg["stem_layers"])):
        for b in range(n_blocks):
            pre = f"{stem}.stages.{s}.blocks.{b}"
            st = stride if b == 0 else 1
            if b == 0:
                short = _groupnorm(p, f"{pre}.downsample.norm",
                                   _std_conv(p, f"{pre}.downsample.conv", y, st, pr), pr, False)
            else:
                short = y
            h = _groupnorm(p, f"{pre}.norm1", _std_conv(p, f"{pre}.conv1", y, 1, pr), pr, True)
            h = _groupnorm(p, f"{pre}.norm2", _std_conv(p, f"{pre}.conv2", h, st, pr), pr, True)
            y = _groupnorm(p, f"{pre}.norm3", _std_conv(p, f"{pre}.conv3", h, 1, pr), pr, True,
                           residual=short)
    w, b = p["encoder.patch_embed.proj.weight"], p["encoder.patch_embed.proj.bias"]
    tok = pr.round(F.conv2d(pr.round(y), pr.round(w)) + b[:, None, None])
    return tok.flatten(2).transpose(1, 2)


def _attend(q, k, v, scale, scores, mix, pr):
    s = torch.einsum(scores, pr.round(q), pr.round(k)) * scale
    probs = torch.softmax(s, dim=-1)
    return pr.round(torch.einsum(mix, pr.round(probs), pr.round(v)))


def st_block(p, i, x, T, cfg, pr):
    """One block of the parallel mode on (BT, N, C) tokens of clips of T."""
    pre = f"encoder.blocks.{i}"
    BT, N, C = x.shape
    h = cfg["num_heads"]
    d = C // h
    qkv = _linear(p, f"{pre}.attn.qkv", _layernorm(p, f"{pre}.norm1", x), pr)
    q, k, v = qkv.reshape(BT, N, 3, h, d).unbind(2)
    scale = d ** -0.5
    y_s = _attend(q, k, v, scale, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd", pr).reshape(BT, N, C)
    if T == 1:  # attention over one frame: its one weight is 1
        y_t = v.reshape(BT, N, C)
    else:
        q, k, v = (a.reshape(BT // T, T, N, h, d) for a in (q, k, v))
        y_t = _attend(q, k, v, scale, "bqnhd,bknhd->bnhqk", "bnhqk,bknhd->bqnhd", pr)
        y_t = y_t.reshape(BT, N, C)
    means = torch.cat([y_s.mean(dim=1), y_t.mean(dim=1)], dim=-1)
    alpha = torch.softmax(_linear(p, f"{pre}.attn.ts_attn", pr.round(means), pr)
                          .reshape(BT, 1, C, 2), dim=-1)
    y = pr.round(y_t * alpha[..., 1] + y_s * alpha[..., 0])
    x = pr.round(x + _linear(p, f"{pre}.attn.proj", y, pr))
    m = torch.nn.functional.gelu(_linear(p, f"{pre}.mlp.fc1", _layernorm(p, f"{pre}.norm2", x),
                                         pr))
    return pr.round(x + _linear(p, f"{pre}.mlp.fc2", pr.round(m), pr))


def vit(p, frames, T, cfg, pr):
    """(B*T, 3, H, W) normalized frames of clips of T -> (B*T, C) features."""
    tok = hybrid_stem(p, frames, cfg, pr)
    BT, _, C = tok.shape
    x = torch.cat([p["encoder.cls_token"].expand(BT, 1, C), tok], dim=1) + p["encoder.pos_embed"]
    N = x.shape[1]
    x = pr.round((x.reshape(-1, T, N, C) + p["encoder.temp_embed"][:, :T]).reshape(BT, N, C))
    for i in range(cfg["num_blocks"]):
        x = st_block(p, i, x, T, cfg, pr)
    feat = pr.round(_layernorm(p, "encoder.norm", x)[:, 0])
    return torch.tanh(_linear(p, "encoder.pre_logits.fc", feat, pr))


def _batchnorm(p, name, x, train, eps=1e-5):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = w * torch.rsqrt(var + eps)
    return x * scale[:, None, None] + (b - mean * scale)[:, None, None]


def resnet50(p, x, train, pr):
    """(B, 3, H, W) normalized frames -> (B, 2048) features."""
    def conv(name, y, stride):
        w = p[f"{name}.weight"]
        return pr.round(F.conv2d(pr.round(y), pr.round(w), None, stride, w.shape[-1] // 2))

    y = torch.relu(_batchnorm(p, "encoder.bn1", conv("encoder.conv1", x, 2), train))
    y = F.max_pool2d(y, 3, 2, padding=1)
    for si, depth in enumerate(R50_LAYERS):
        for bi in range(depth):
            pre = f"encoder.layer{si + 1}.{bi}"
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            short = y
            if bi == 0:
                short = _batchnorm(p, f"{pre}.downsample.1",
                                   conv(f"{pre}.downsample.0", y, stride), train)
            h = torch.relu(_batchnorm(p, f"{pre}.bn1", conv(f"{pre}.conv1", y, 1), train))
            h = torch.relu(_batchnorm(p, f"{pre}.bn2", conv(f"{pre}.conv2", h, stride), train))
            y = torch.relu(_batchnorm(p, f"{pre}.bn3", conv(f"{pre}.conv3", h, 1), train) + short)
    return y.mean(dim=(2, 3))


def _dropout(x, rate, generator):
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def ktd(p, feat, body, cfg, pr, jreg=None, train=False, generator=None):
    """Features (nt, F) -> the five outputs of nt frames."""
    rate = cfg["decoder_drop"] if train else 0.0
    x = _linear(p, "decoder.fc1", feat, pr)
    if rate:
        x = _dropout(x, rate, generator)
    x = _linear(p, "decoder.fc2", x, pr)
    if rate:
        x = _dropout(x, rate, generator)
    shape = _linear(p, "decoder.decshape", x, pr)
    cam = _linear(p, "decoder.deccam", x, pr)
    pose = []
    for j, anc in enumerate(ANCESTORS):
        pose.append(_linear(p, f"decoder.joint_regs.{j}", torch.cat([x] + [pose[a] for a in anc],
                                                                       dim=1), pr))
    nt = x.shape[0]
    rotmat = rot6d_to_rotmat(torch.cat(pose, dim=1)).reshape(nt, 24, 3, 3)
    verts, joints = smpl(body, shape, rotmat)
    if jreg is not None:
        joints = torch.einsum("jv,bvk->bjk", jreg, verts)
    theta = torch.cat([cam, rotmat_to_axis_angle(rotmat).reshape(nt, 72), shape], dim=1)
    return {"theta": theta, "verts": verts, "kp_2d": weak_perspective(joints, cam),
            "kp_3d": joints, "rotmat": rotmat}


def normalize(clips):
    """uint8 (..., 3) pixels -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=clips.device)
    std = torch.tensor(IMAGENET_STD, device=clips.device)
    return (clips.float() / 255.0 - mean) / std


def forward(p, clips, body, cfg, pr=None, jreg=None, train=False, generator=None):
    """The model on clips (N, T, H, W, 3): {'theta' (N, T, 85), 'verts' (N,
    T, V, 3), 'kp_2d' (N, T, J, 2), 'kp_3d' (N, T, J, 3), 'rotmat' (N, T, 24,
    3, 3)}; J = 14 with the eval regressor ``jreg``, else the 49-joint bank.
    ``train`` draws the decoder's dropout from ``generator`` and takes the
    ResNet's BatchNorm moments from the batch."""
    pr = pr or Precision()
    N, T = clips.shape[:2]
    frames = normalize(clips).reshape((N * T,) + clips.shape[2:]).permute(0, 3, 1, 2)
    if cfg["encoder"] == "ste":
        feat = vit(p, frames, T, cfg, pr)
    else:
        feat = resnet50(p, frames, train, pr)
    out = ktd(p, feat, body, cfg, pr, jreg, train, generator)
    return {k: v.reshape((N, T) + v.shape[1:]) for k, v in out.items()}
