"""The Spatial-Temporal Encoder: R50+ViT-B/16 hybrid with parallel attention.

Port of ``maed_tpu/models/vit.py`` for the eval path: st_mode 'parallel',
the frame-major (B*T, N, C) token layout, no dropout or drop-path. Module
and parameter names follow the reference torch MAED, so a state_dict
converted from the JAX parameters (``utils.weights``) loads with
``strict=True``.

Attention is the plain formulation of ``_softmax_drop``: product, softmax in
f32, cast, product. The LayerNorms go through ``ops.layernorm.fast_layernorm``
(the Triton kernel on the card) and the MLP half through
``ops.mlp.fused_ln_mlp`` (the CUDA kernel), unless ``plain=True`` asks for
their plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maed_tpu_torch.models.layers import dense
from maed_tpu_torch.models.resnetv2 import ResNetV2
from maed_tpu_torch.ops.layernorm import fast_layernorm, layernorm_reference
from maed_tpu_torch.ops.mlp import fused_ln_mlp, ln_mlp_reference


def _softmax_f32(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Softmax over the last axis, accumulated in promote(dtype, f32)."""
    st = torch.promote_types(logits.dtype, torch.float32)
    return torch.softmax(logits.to(st), dim=-1).to(dtype)


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

    def _spatial(self, qkv: torch.Tensor) -> torch.Tensor:
        BT, N, _, h, d = qkv.shape
        q, k, v = qkv.unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d ** -0.5)
        probs = _softmax_f32(logits, q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(BT, N, h * d)

    def _temporal(self, qkv: torch.Tensor, seqlen: int) -> torch.Tensor:
        """Attention over the frames of each clip, batched per (token, head):
        rows (G*T, N) regrouped as (G, T, N, h, d)."""
        BT, N, _, h, d = qkv.shape
        q, k, v = qkv.unbind(2)
        if seqlen == 1:
            # attention over a single frame is the identity over v
            return v.reshape(BT, N, h * d)
        G = BT // seqlen

        def to_g(a):
            return a.reshape(G, seqlen, N, h, d)

        logits = torch.einsum("bqnhd,bknhd->bnhqk", to_g(q), to_g(k)) * (d ** -0.5)
        probs = _softmax_f32(logits, q.dtype)
        return torch.einsum("bnhqk,bknhd->bqnhd", probs, to_g(v)).reshape(BT, N, h * d)

    def forward(self, x: torch.Tensor, seqlen: int, residual: torch.Tensor) -> torch.Tensor:
        """x: the normalized block input (BT, N, C); returns residual + attention."""
        BT, N, C = x.shape
        dt = self.dtype
        qkv = dense(x, self.qkv, dt).reshape(BT, N, 3, self.num_heads, C // self.num_heads)
        y_t = self._temporal(qkv, seqlen)
        y_s = self._spatial(qkv)
        # the gate: [mean y_s || mean y_t] @ ts_attn, read as interleaved
        # (spatial, temporal) pairs per channel, softmaxed in the compute dtype
        alpha = torch.cat([y_s.mean(dim=1, keepdim=True), y_t.mean(dim=1, keepdim=True)],
                          dim=-1)
        alpha = dense(alpha, self.ts_attn, dt).reshape(BT, 1, C, 2)
        alpha = torch.exp(alpha - alpha.amax(dim=-1, keepdim=True))
        alpha = alpha / alpha.sum(dim=-1, keepdim=True)
        y = y_t * alpha[..., 1] + y_s * alpha[..., 0]
        y = dense(y, self.proj, dt)
        return residual.to(y.dtype) + y


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
        x = self.attn(self.norm1(x, plain), seqlen, residual=x)
        return self.mlp(x.to(self.dtype), self.norm2, plain)


class HybridEmbed(nn.Module):
    """ResNetV2 feature map -> patch tokens through a 1x1 projection."""

    def __init__(self, embed_dim: int = 768, standardize: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetV2(layers=(3, 4, 9), standardize=standardize, dtype=dtype)
        self.proj = nn.Conv2d(self.backbone.num_features, embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) frames -> (B, H/16 * W/16, C) tokens in row-major (H, W)."""
        feat = self.backbone(x.permute(0, 3, 1, 2))
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
        tokens = self.patch_embed(x)
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
