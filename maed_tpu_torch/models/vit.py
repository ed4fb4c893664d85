"""The Spatial-Temporal Encoder: R50+ViT-B/16 hybrid with parallel attention.

Port of ``maed_tpu/models/vit.py`` for the eval path: st_mode 'parallel',
the frame-major (B*T, N, C) token layout, no dropout or drop-path. Module
and parameter names follow the reference torch MAED, so a state_dict
converted from the JAX parameters (``utils.weights``) loads with
``strict=True``.

A block runs through the port's kernels, as the JAX package does with all its
fused paths on: norm1 and the qkv projection as ``ops.mlp.fused_ln_dense``,
the temporal and spatial branches as ``ops.st_attention``'s kernels reading
that projection in place, the gate, blend, output projection and residual as
``ops.mlp.fused_gate_proj``, norm2 and the MLP as ``ops.mlp.fused_ln_mlp``,
and the final norm as ``ops.layernorm.fast_layernorm``; ``plain=True`` asks
for their plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maed_tpu_torch.models.layers import dense
from maed_tpu_torch.models.resnetv2 import ResNetV2
from maed_tpu_torch.ops.layernorm import fast_layernorm, layernorm_reference
from maed_tpu_torch.ops.mlp import (fused_gate_proj, fused_ln_dense, fused_ln_mlp,
                                    gate_proj_reference, ln_dense_reference, ln_mlp_reference)
from maed_tpu_torch.ops.st_attention import (spatial_attention_btc, spatial_reference_btc,
                                             temporal_attention_fused,
                                             temporal_reference_btc)


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
    """Parallel multi-level attention: spatial attention over the N tokens of
    each frame and temporal attention over the T frames of each token, from
    one qkv projection, blended by a learned per-channel softmax gate."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        # input is the concat of the two branch means: (2C) -> (2C)
        self.ts_attn = nn.Linear(dim * 2, dim * 2)

    def forward(self, x: torch.Tensor, seqlen: int, norm: FastLayerNorm,
                plain: bool = False) -> torch.Tensor:
        """x: the block's pre-norm input (BT, N, C), ``norm`` its norm1;
        returns x + attention(norm(x))."""
        BT, N, C = x.shape
        dt, h = self.dtype, self.num_heads
        x = x.to(dt)
        scale = (C // h) ** -0.5
        ln_dense = ln_dense_reference if plain else fused_ln_dense
        qkv = ln_dense(x, norm.weight, norm.bias, self.qkv.weight.to(dt), self.qkv.bias,
                       norm.eps).reshape(BT, N, 3, h, C // h)
        if seqlen == 1:
            # attention over a single frame is the identity over v
            y_t = qkv[:, :, 2].reshape(BT, N, C).contiguous()
        else:
            temporal = temporal_reference_btc if plain else temporal_attention_fused
            y_t = temporal(qkv, seqlen, scale)
        y_s = (spatial_reference_btc if plain else spatial_attention_btc)(qkv, scale)
        # the gate [mean y_s || mean y_t] @ ts_attn, softmaxed per channel's
        # (spatial, temporal) pair, blends the branches; then proj and residual
        out, _ = (gate_proj_reference if plain else fused_gate_proj)(
            y_s, y_t, x, self.ts_attn.weight.to(dt), self.ts_attn.bias,
            self.proj.weight.to(dt), self.proj.bias)
        return out


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = FastLayerNorm(dim, dtype=dtype)
        self.attn = StAttention(dim, num_heads, dtype=dtype)
        self.norm2 = FastLayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, seqlen: int, plain: bool = False) -> torch.Tensor:
        x = self.attn(x, seqlen, self.norm1, plain)  # norm1 runs inside the qkv kernel
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
    """The hybrid ViT with parallel attention; returns the pre-logits cls feature.

    Input: (B*T, H, W, 3) frames with clip length ``seqlen``.
    Output: (B*T, representation_size).
    """

    def __init__(self, embed_dim: int = 768, depth: int = 6, num_heads: int = 12,
                 mlp_ratio: float = 4.0, representation_size: int = 768,
                 max_seqlen: int = 16, img_size: int = 224, standardize: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = HybridEmbed(embed_dim, standardize=standardize, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches(img_size) + 1, embed_dim))
        self.temp_embed = nn.Parameter(torch.empty(1, max_seqlen, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype=dtype) for _ in range(depth))
        self.norm = FastLayerNorm(embed_dim, dtype=dtype)
        self.pre_logits = PreLogits(embed_dim, representation_size)

    def forward(self, x: torch.Tensor, seqlen: int, plain: bool = False) -> torch.Tensor:
        tokens = self.patch_embed(x, plain)
        BT, _, C = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(BT, 1, C)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        N = tokens.shape[1]
        tokens = tokens.reshape(-1, seqlen, N, C) + self.temp_embed[:, :seqlen].to(tokens.dtype)
        tokens = tokens.reshape(BT, N, C)
        for block in self.blocks:
            tokens = block(tokens, seqlen, plain)
        feat = self.norm(tokens, plain)[:, 0]
        return torch.tanh(dense(feat, self.pre_logits.fc, self.dtype))
