"""The Spatial-Temporal Encoder: R50+ViT-B/16 hybrid with multi-level attention.

Port of ``maed_tpu/models/vit.py`` for the eval path: every ``st_mode``, the
frame-major (B*T, N, C) token layout, no dropout or drop-path. Module
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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maed_tpu_torch.models.layers import dense
from maed_tpu_torch.models.resnetv2 import ResNetV2
from maed_tpu_torch.ops.attention import (_xla_attention, attention_blocked_reference,
                                          fused_attention)
from maed_tpu_torch.ops.layernorm import fast_layernorm, layernorm_reference
from maed_tpu_torch.ops.mlp import (fused_gate_proj, fused_ln_dense, fused_ln_mlp,
                                    gate_proj_reference, ln_dense_reference, ln_mlp_reference)
from maed_tpu_torch.ops.st_attention import (MAX_TOKENS, spatial_attention_btc,
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
    """fc1 and fc2 of the block's MLP; the compute is the fused kernel."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, norm: FastLayerNorm, plain: bool = False):
        """x + fc2(gelu(fc1(norm(x)))) in x's dtype; b1 and b2 stay f32."""
        mlp = ln_mlp_reference if plain else fused_ln_mlp
        return mlp(x, norm.weight, norm.bias, self.fc1.weight.to(x.dtype), self.fc1.bias,
                   self.fc2.weight.to(x.dtype), self.fc2.bias, norm.eps)


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
    parallel mode's gate weights (BT, 1, C, 2) of the latest call, for
    ``core.evaluate.Evaluator.count_attn``.
    """

    def __init__(self, dim: int, num_heads: int, st_mode: str = "parallel",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if st_mode not in ST_MODES:
            raise ValueError(f"st_mode {st_mode!r} is not one of {ST_MODES}")
        self.num_heads, self.st_mode, self.dtype = num_heads, st_mode, dtype
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
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

    def _temporal(self, qkv, seqlen: int, plain: bool):
        BT, N, _, h, d = qkv.shape
        if seqlen == 1:
            # attention over a single frame is the identity over v
            return qkv[:, :, 2].reshape(BT, N, h * d).contiguous()
        temporal = temporal_reference_btc if plain else temporal_attention_fused
        return temporal(qkv, seqlen, d ** -0.5)

    def _coupling(self, qkv, seqlen: int, plain: bool):
        """Attention over the T*N tokens of each clip: q, k, v are (B, h,
        T*N, d) views of the projection and the kernel writes a view of the
        (BT, N, h*d) result, so nothing is transposed on either side."""
        BT, N, _, h, d = qkv.shape
        B = BT // seqlen
        q, k, v = (a.transpose(1, 2) for a in qkv.view(B, seqlen * N, 3, h, d).unbind(2))
        if plain:
            reference = attention_blocked_reference if seqlen * N > MAX_TOKENS else _xla_attention
            return reference(q, k, v, d ** -0.5).transpose(1, 2).reshape(BT, N, h * d)
        y = torch.empty((BT, N, h * d), dtype=qkv.dtype, device=qkv.device)
        fused_attention(q, k, v, d ** -0.5, out=y.view(B, seqlen * N, h, d).transpose(1, 2))
        return y

    def forward(self, x: torch.Tensor, seqlen: int, norm: FastLayerNorm,
                plain: bool = False) -> torch.Tensor:
        """x: the block's pre-norm input (BT, N, C), ``norm`` its norm1."""
        BT, N, C = x.shape
        dt, mode = self.dtype, self.st_mode
        x = x.to(dt)
        scale = (C // self.num_heads) ** -0.5
        spatial = spatial_reference_btc if plain else spatial_attention_btc
        if mode == "parallel":
            qkv = self._qkv(x, norm, plain)
            y_t = self._temporal(qkv, seqlen, plain)
            y_s = spatial(qkv, scale)
            # the gate [mean y_s || mean y_t] @ ts_attn, softmaxed per channel's
            # (spatial, temporal) pair, blends the branches; then proj and residual
            out, self.last_gate = (gate_proj_reference if plain else fused_gate_proj)(
                y_s, y_t, x, self.ts_attn.weight.to(dt), self.ts_attn.bias,
                self.proj.weight.to(dt), self.proj.bias)
            return out
        if mode in ("vanilla", "spatial"):
            y = spatial(self._qkv(x, norm, plain), scale)
        elif mode == "temporal":
            xn = norm(x, plain)
            y = self._temporal(self._qkv(xn.mean(dim=1, keepdim=True), None, plain), seqlen, plain)
        elif mode == "coupling":
            y = self._coupling(self._qkv(x, norm, plain), seqlen, plain)
        else:  # series
            y = spatial(self._qkv(x, norm, plain), scale)
            y = self._temporal(self._qkv(y, None, plain), seqlen, plain)
        # temporal: the (BT, 1, C) result broadcasts over the N tokens
        return x + dense(y, self.proj, dt)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 st_mode: str = "parallel", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = FastLayerNorm(dim, dtype=dtype)
        self.attn = StAttention(dim, num_heads, st_mode, dtype=dtype)
        self.norm2 = FastLayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, seqlen: int, plain: bool = False) -> torch.Tensor:
        # norm1 runs inside the qkv kernel (temporal mode: by itself, before the mean)
        x = self.attn(x, seqlen, self.norm1, plain)
        return self.mlp(x, self.norm2, plain)


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
                 st_mode: str = "parallel", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.st_mode = dtype, st_mode
        self.patch_embed = HybridEmbed(embed_dim, standardize=standardize, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches(img_size) + 1, embed_dim))
        if st_mode in TEMP_EMBED_MODES:
            self.temp_embed = nn.Parameter(torch.empty(1, max_seqlen, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, st_mode, dtype=dtype) for _ in range(depth))
        self.norm = FastLayerNorm(embed_dim, dtype=dtype)
        self.pre_logits = PreLogits(embed_dim, representation_size)

    def forward(self, x: torch.Tensor, seqlen: int, plain: bool = False) -> torch.Tensor:
        tokens = self.patch_embed(x, plain)
        BT, _, C = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(BT, 1, C)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        N = tokens.shape[1]
        if self.st_mode in TEMP_EMBED_MODES:
            tokens = tokens.reshape(-1, seqlen, N, C) + self.temp_embed[:, :seqlen].to(tokens.dtype)
            tokens = tokens.reshape(BT, N, C)
        for block in self.blocks:
            tokens = block(tokens, seqlen, plain)
        feat = self.norm(tokens, plain)[:, 0]
        return torch.tanh(dense(feat, self.pre_logits.fc, self.dtype))
