"""The Spatial-Temporal Encoder: R50+ViT-B/16 hybrid with multi-level attention.

Port of ``maed_tpu/models/vit.py``: every ``st_mode``, the frame-major (B*T,
N, C) token layout, and the training forward's dropout (after the
embeddings, on the attention probabilities, after the attention's and the
MLP's products) and drop-path, each drawn from the step's generator. Module
and parameter names follow the reference torch MAED, so a state_dict
converted from the JAX parameters (``utils.weights``) loads with
``strict=True``.

A block runs through the port's kernels, as the JAX package does with all its
fused paths on: norm1 and the qkv projection as ``ops.mlp.fused_ln_dense``,
the temporal and spatial attention as ``ops.st_attention``'s kernels and the
coupling mode's attention over a clip's T*N tokens as
``ops.attention.fused_attention`` (its blocked kernel beyond 1024 tokens),
all reading that projection in place; the parallel mode's gate, blend, output
projection and residual as ``ops.mlp.fused_gate_proj`` (the other modes'
output projection is a plain product, as in the JAX package); norm2 and the
MLP as ``ops.mlp.fused_ln_mlp``, and the final norm as
``ops.layernorm.fast_layernorm``; ``plain=True`` asks for their plain
versions.

Training (``train=True``) keeps these paths while every rate is 0, as the
published recipe has them. As in the JAX package's ``Block``, a positive
attention-dropout rate sends the two attention branches to their plain
versions with the dropout on their probabilities (the seqlen == 1 shortcut
stands down too), and a positive dropout or drop-path rate sends the
parallel mode's gated tail and the MLP to their plain forms, with the
residual added outside.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maed_tpu_torch.models.layers import Dropout, DropPath, dense
from maed_tpu_torch.models.resnetv2 import ResNetV2
from maed_tpu_torch.ops.attention import (_xla_attention, attention_blocked_reference,
                                          fused_attention)
from maed_tpu_torch.ops.layernorm import fast_layernorm, layernorm_reference
from maed_tpu_torch.ops.mlp import (_gelu_exact, fused_gate_proj, fused_ln_dense, fused_ln_mlp,
                                    gate_proj_reference, ln_dense_reference, ln_mlp_reference)
from maed_tpu_torch.ops.st_attention import (MAX_TOKENS, _attend, spatial_attention_btc,
                                             spatial_reference_btc, temporal_attention_fused,
                                             temporal_reference_btc)

ST_MODES = ("vanilla", "spatial", "temporal", "coupling", "parallel", "series")
TEMP_EMBED_MODES = ("coupling", "parallel", "series")  # the modes that mix frames by position


class FastLayerNorm(nn.Module):
    """LayerNorm (eps 1e-6) with nn.LayerNorm's parameters, through the
    Triton kernel on the card."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        norm = layernorm_reference if plain else fast_layernorm
        return norm(x.to(self.dtype), self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 and fc2 of the block's MLP, and its dropout; the compute is the
    fused kernel."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, norm: FastLayerNorm, plain: bool = False):
        """x + fc2(gelu(fc1(norm(x)))) in x's dtype; b1 and b2 stay f32."""
        mlp = ln_mlp_reference if plain else fused_ln_mlp
        return mlp(x, norm.weight, norm.bias, self.fc1.weight.to(x.dtype), self.fc1.bias,
                   self.fc2.weight.to(x.dtype), self.fc2.bias, norm.eps)

    def branch(self, x: torch.Tensor, norm: FastLayerNorm, generator: torch.Generator):
        """The training form with dropout, without the residual:
        drop(fc2(drop(gelu(fc1(norm(x)))))), each product and bias in x's
        dtype, as the JAX package's plain MLP path."""
        dt = x.dtype
        y = layernorm_reference(x, norm.weight, norm.bias, norm.eps)
        y = self.drop(_gelu_exact(dense(y, self.fc1, dt)), True, generator)
        return self.drop(dense(y, self.fc2, dt), True, generator)


class StAttention(nn.Module):
    """Multi-level spatio-temporal attention on (B*T, N, C) tokens with clip
    length ``seqlen``:

    - vanilla, spatial: attention over the N tokens of each frame;
    - temporal: the tokens' mean per frame attends over the T frames;
    - coupling: joint attention over all T*N tokens of a clip;
    - parallel: a spatial and a temporal branch from one qkv projection,
      blended by a learned per-channel softmax gate;
    - series: spatial attention, the same qkv weights applied again (without
      a norm), then temporal attention.

    ``forward`` returns x + proj(attention(norm(x))). ``last_gate`` holds the
    parallel mode's gate weights (BT, 1, C, 2) of the latest call, detached,
    for ``core.evaluate.Evaluator.count_attn``.
    """

    def __init__(self, dim: int, num_heads: int, st_mode: str = "parallel",
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if st_mode not in ST_MODES:
            raise ValueError(f"st_mode {st_mode!r} is not one of {ST_MODES}")
        self.num_heads, self.st_mode, self.dtype = num_heads, st_mode, dtype
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)
        if st_mode == "parallel":
            # input is the concat of the two branch means: (2C) -> (2C)
            self.ts_attn = nn.Linear(dim * 2, dim * 2)
        self.last_gate = None

    def _qkv(self, x, norm: FastLayerNorm | None, plain: bool):
        """(BT, N, C) -> the projection (BT, N, 3, h, d), never transposed;
        with ``norm`` the LayerNorm runs inside the projection's kernel."""
        BT, N, C = x.shape
        dt, h = self.dtype, self.num_heads
        if norm is None:
            y = dense(x, self.qkv, dt)
        else:
            ln_dense = ln_dense_reference if plain else fused_ln_dense
            y = ln_dense(x, norm.weight, norm.bias, self.qkv.weight.to(dt), self.qkv.bias,
                         norm.eps)
        return y.reshape(BT, N, 3, h, C // h)

    def _drop(self, train: bool, generator):
        """The attention dropout as the plain versions take it, or None
        where it draws nothing (and the kernels run)."""
        if not train or self.attn_drop.rate == 0.0:
            return None
        return lambda probs: self.attn_drop(probs, True, generator)

    def _spatial(self, qkv, plain: bool, drop):
        d = qkv.shape[-1]
        if drop is not None:
            return spatial_reference_btc(qkv, d ** -0.5, drop)
        return (spatial_reference_btc if plain else spatial_attention_btc)(qkv, d ** -0.5)

    def _temporal(self, qkv, seqlen: int, plain: bool, drop):
        BT, N, _, h, d = qkv.shape
        if drop is not None:
            return temporal_reference_btc(qkv, seqlen, d ** -0.5, drop)
        if seqlen == 1:
            # attention over a single frame is the identity over v
            return qkv[:, :, 2].reshape(BT, N, h * d).contiguous()
        temporal = temporal_reference_btc if plain else temporal_attention_fused
        return temporal(qkv, seqlen, d ** -0.5)

    def _coupling(self, qkv, seqlen: int, plain: bool, drop):
        """Attention over the T*N tokens of each clip: q, k, v are (B, h,
        T*N, d) views of the projection and the kernel writes a view of the
        (BT, N, h*d) result, so nothing is transposed on either side (under
        grad the kernel returns its own tensor, which is transposed)."""
        BT, N, _, h, d = qkv.shape
        B = BT // seqlen
        q, k, v = (a.transpose(1, 2) for a in qkv.view(B, seqlen * N, 3, h, d).unbind(2))
        if drop is not None:
            y = _attend(q, k, v, d ** -0.5, "bhsd,bhtd->bhst", "bhst,bhtd->bhsd", drop)
        elif plain:
            reference = attention_blocked_reference if seqlen * N > MAX_TOKENS else _xla_attention
            y = reference(q, k, v, d ** -0.5)
        elif torch.is_grad_enabled() and qkv.requires_grad:
            y = fused_attention(q, k, v, d ** -0.5)
        else:
            y = torch.empty((BT, N, h * d), dtype=qkv.dtype, device=qkv.device)
            fused_attention(q, k, v, d ** -0.5, out=y.view(B, seqlen * N, h, d).transpose(1, 2))
            return y
        return y.transpose(1, 2).reshape(BT, N, h * d)

    def _gate(self, y_s, y_t):
        """The parallel mode's gate and blend in plain form, each step in the
        dtype, as the JAX package's unfused path."""
        BT, _, C = y_s.shape
        alpha = torch.cat([y_s.mean(dim=1, keepdim=True), y_t.mean(dim=1, keepdim=True)], dim=-1)
        alpha = torch.softmax(dense(alpha, self.ts_attn, self.dtype).reshape(BT, 1, C, 2), dim=-1)
        self.last_gate = alpha.detach()
        return y_t * alpha[..., 1] + y_s * alpha[..., 0]

    def forward(self, x: torch.Tensor, seqlen: int, norm: FastLayerNorm, plain: bool = False,
                train: bool = False, generator: torch.Generator | None = None,
                residual: bool = True) -> torch.Tensor:
        """x: the block's pre-norm input (BT, N, C), ``norm`` its norm1.
        ``residual=False`` returns the dropped-out proj(attention) alone,
        through the plain gate in the parallel mode (a block with a
        positive dropout or drop-path rate adds the residual itself)."""
        dt, mode = self.dtype, self.st_mode
        x = x.to(dt)
        drop = self._drop(train, generator)
        if mode == "parallel":
            qkv = self._qkv(x, norm, plain)
            y_t = self._temporal(qkv, seqlen, plain, drop)
            y_s = self._spatial(qkv, plain, drop)
            if not residual:
                y = self._gate(y_s, y_t)
            else:
                # the gate [mean y_s || mean y_t] @ ts_attn, softmaxed per channel's
                # (spatial, temporal) pair, blends the branches; then proj and residual
                out, alpha = (gate_proj_reference if plain else fused_gate_proj)(
                    y_s, y_t, x, self.ts_attn.weight.to(dt), self.ts_attn.bias,
                    self.proj.weight.to(dt), self.proj.bias)
                self.last_gate = alpha.detach()
                return out
        elif mode in ("vanilla", "spatial"):
            y = self._spatial(self._qkv(x, norm, plain), plain, drop)
        elif mode == "temporal":
            xn = norm(x, plain)
            y = self._temporal(self._qkv(xn.mean(dim=1, keepdim=True), None, plain), seqlen,
                               plain, drop)
        elif mode == "coupling":
            y = self._coupling(self._qkv(x, norm, plain), seqlen, plain, drop)
        else:  # series
            y = self._spatial(self._qkv(x, norm, plain), plain, drop)
            y = self._temporal(self._qkv(y, None, plain), seqlen, plain, drop)
        # temporal: the (BT, 1, C) result broadcasts over the N tokens
        y = self.proj_drop(dense(y, self.proj, dt), train, generator)
        return x + y if residual else y


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 st_mode: str = "parallel", drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = FastLayerNorm(dim, dtype=dtype)
        self.attn = StAttention(dim, num_heads, st_mode, attn_drop, drop, dtype=dtype)
        self.norm2 = FastLayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, seqlen: int, plain: bool = False, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not (train and (self.mlp.drop.rate > 0.0 or self.drop_path.rate > 0.0)):
            # norm1 runs inside the qkv kernel (temporal mode: by itself, before
            # the mean), the residuals inside the tail's and the MLP's kernels
            x = self.attn(x, seqlen, self.norm1, plain, train, generator)
            return self.mlp(x, self.norm2, plain)
        y = self.attn(x, seqlen, self.norm1, plain, train, generator, residual=False)
        x = x.to(self.dtype) + self.drop_path(y, train, generator)
        return x + self.drop_path(self.mlp.branch(x, self.norm2, generator), train, generator)


class HybridEmbed(nn.Module):
    """ResNetV2 feature map -> patch tokens through a 1x1 projection."""

    def __init__(self, embed_dim: int = 768, standardize: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetV2(layers=(3, 4, 9), standardize=standardize, dtype=dtype)
        self.proj = nn.Conv2d(self.backbone.num_features, embed_dim, 1)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x: (B, H, W, 3) frames -> (B, H/16 * W/16, C) tokens in row-major (H, W)."""
        feat = self.backbone(x.permute(0, 3, 1, 2), plain)
        tok = F.conv2d(feat.to(self.dtype), self.proj.weight.to(self.dtype))
        tok = tok + self.proj.bias.to(self.dtype)[:, None, None]
        return tok.flatten(2).transpose(1, 2)


class PreLogits(nn.Module):
    def __init__(self, dim: int, representation_size: int):
        super().__init__()
        self.fc = nn.Linear(dim, representation_size)


def num_patches(img_size: int) -> int:
    """Tokens the hybrid stem makes of a square frame: four stride-2 SAME
    reductions (stem conv, max-pool, stages 1 and 2)."""
    side = img_size
    for _ in range(4):
        side = -(-side // 2)
    return side * side


class VisionTransformer(nn.Module):
    """The hybrid ViT with spatio-temporal attention of one ``st_mode``;
    returns the pre-logits cls feature.

    Input: (B*T, H, W, 3) frames with clip length ``seqlen``.
    Output: (B*T, representation_size).
    """

    def __init__(self, embed_dim: int = 768, depth: int = 6, num_heads: int = 12,
                 mlp_ratio: float = 4.0, representation_size: int = 768,
                 max_seqlen: int = 16, img_size: int = 224, standardize: bool = True,
                 st_mode: str = "parallel", drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.st_mode = dtype, st_mode
        self.patch_embed = HybridEmbed(embed_dim, standardize=standardize, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches(img_size) + 1, embed_dim))
        if st_mode in TEMP_EMBED_MODES:
            self.temp_embed = nn.Parameter(torch.empty(1, max_seqlen, 1, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        # the drop-path rate grows linearly over the depth, from 0
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, st_mode, drop_rate, attn_drop_rate,
                  float(rate), dtype=dtype)
            for rate in np.linspace(0.0, drop_path_rate, depth))
        self.norm = FastLayerNorm(embed_dim, dtype=dtype)
        self.pre_logits = PreLogits(embed_dim, representation_size)

    def forward(self, x: torch.Tensor, seqlen: int, plain: bool = False, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        tokens = self.patch_embed(x, plain)
        BT, _, C = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(BT, 1, C)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        N = tokens.shape[1]
        if self.st_mode in TEMP_EMBED_MODES:
            tokens = tokens.reshape(-1, seqlen, N, C) + self.temp_embed[:, :seqlen].to(tokens.dtype)
            tokens = tokens.reshape(BT, N, C)
        tokens = self.pos_drop(tokens, train, generator)
        for block in self.blocks:
            tokens = block(tokens, seqlen, plain, train, generator)
        feat = self.norm(tokens, plain)[:, 0]
        return torch.tanh(dense(feat, self.pre_logits.fc, self.dtype))
