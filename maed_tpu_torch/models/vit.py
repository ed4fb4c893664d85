"""The Spatial-Temporal Encoder: R50+ViT-B/16 hybrid with multi-level attention.

Port of ``maed_tpu/models/vit.py``: every ``st_mode``, the stock ViTs'
options (``PatchEmbed``, a qkv without bias, no pre-logits) and their factory
catalog (``FACTORIES``), the frame-major (B*T,
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

``remat=True`` (the JAX package's ``nn.remat(Block)``) keeps no block's
activations in a training forward under grad: each block runs under
``torch.utils.checkpoint`` and its forward runs again in the backward
(:func:`remat_block`), for the memory of one block's activations instead of
``depth`` blocks'. The recomputation draws the first run's dropout masks.

Tensor parallelism (``mesh``, a ``parallel.mesh.Mesh`` with tp > 1): each
block holds its rank's shards as its own contiguous parameters (qkv the q,
k and v rows of its h / tp heads, proj the matching input columns, fc1 its
4C / tp hidden columns, fc2 their rows) and every kernel runs on them. The
block's input enters through ``parallel.tensor.copy_to_tp``; norm1 and the
qkv run through kernel D on the rank's 3C / tp outputs (the LN
replicated), the attention kernels on its heads; the parallel mode's tail
runs as its pieces: the branch means on the rank's C / tp channels,
gathered over the group into the full [mean y_s || mean y_t], the gate
over the replicated ts_attn, the rank's channels of alpha blended, and
proj, whose partial sums ``parallel.tensor.reduce_from_tp`` adds. The MLP
runs likewise: the LN pre-pass, fc1 with the GELU epilogue on the rank's
hidden columns, fc2, the sum. Bias and residual enter on tp rank 0 only:
it runs C's and E's GEMMs as one process does, on its shard, and the other
ranks the product alone (``RowPartial``). A replicated parameter of a block
is then used on each rank for its channels only, and its gradient there is
partial (``parallel.mesh.tp_partial_parameters``, summed over the group
before the update). Dropout masks are drawn whole from the data rank's
generator and cut to the rank's heads or hidden columns, so tp ranks draw
the masks of one process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from maed_tpu_torch.models.layers import Dropout, DropPath, dense
from maed_tpu_torch.models.resnetv2 import ResNetV2
from maed_tpu_torch.ops.attention import (_xla_attention, attention_blocked_reference,
                                          fused_attention)
from maed_tpu_torch.ops.layernorm import fast_layernorm, layernorm_reference
from maed_tpu_torch.ops.mlp import (_gelu_exact, fused_gate_proj, fused_ln_dense, fused_ln_mlp,
                                    fused_ln_mlp_partial, gate_alpha, gate_alpha_reference,
                                    gate_blend, gate_blend_reference, gate_means,
                                    gate_means_reference, gate_proj_reference, ln_dense_reference,
                                    ln_mlp_partial_reference, ln_mlp_reference)
from maed_tpu_torch.ops.mlp import dense as gemm
from maed_tpu_torch.ops.mlp import dense_reference as gemm_reference
from maed_tpu_torch.ops.st_attention import (MAX_TOKENS, _attend, spatial_attention_btc,
                                             spatial_reference_btc, temporal_attention_fused,
                                             temporal_reference_btc)
from maed_tpu_torch.parallel.tensor import copy_to_tp, gather_segments, reduce_from_tp

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


def _tp_mesh(mesh, what: str, **widths):
    """``mesh`` when it splits the block (tp > 1), else None; raises unless
    tp divides each of ``widths``."""
    if mesh is None or mesh.tp == 1:
        return None
    for name, width in widths.items():
        if width % mesh.tp:
            raise ValueError(f"{what}: MAED_MESH_TP={mesh.tp} must divide the {name} ({width})")
    return mesh


class Mlp(nn.Module):
    """fc1 and fc2 of the block's MLP, and its dropout; the compute is the
    fused kernel. Under a mesh with tp > 1, fc1 holds the rank's hidden
    columns and fc2 their rows."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0, mesh=None):
        super().__init__()
        self.mesh = _tp_mesh(mesh, "Mlp", hidden_width=hidden)
        tp = 1 if self.mesh is None else self.mesh.tp
        self.hidden = hidden
        self.fc1 = nn.Linear(dim, hidden // tp)
        self.fc2 = nn.Linear(hidden // tp, dim)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, norm: FastLayerNorm, plain: bool = False):
        """x + fc2(gelu(fc1(norm(x)))) in x's dtype; b1 and b2 stay f32."""
        mesh = self.mesh
        if mesh is None:
            mlp = ln_mlp_reference if plain else fused_ln_mlp
            return mlp(x, norm.weight, norm.bias, self.fc1.weight.to(x.dtype), self.fc1.bias,
                       self.fc2.weight.to(x.dtype), self.fc2.bias, norm.eps)
        # tp rank 0 adds fc2's bias and the residual, the others their part alone
        x = copy_to_tp(x, mesh)
        args = (x, norm.weight, norm.bias, self.fc1.weight.to(x.dtype), self.fc1.bias,
                self.fc2.weight.to(x.dtype))
        if mesh.tp_rank == 0:
            out = (ln_mlp_reference if plain else fused_ln_mlp)(*args, self.fc2.bias, norm.eps)
        else:
            out = (ln_mlp_partial_reference if plain else fused_ln_mlp_partial)(*args, norm.eps)
        return reduce_from_tp(out, mesh)

    def branch(self, x: torch.Tensor, norm: FastLayerNorm, generator: torch.Generator):
        """The training form with dropout, without the residual:
        drop(fc2(drop(gelu(fc1(norm(x)))))), each product and bias in x's
        dtype, as the JAX package's plain MLP path."""
        dt, mesh = x.dtype, self.mesh
        if mesh is None:
            y = layernorm_reference(x, norm.weight, norm.bias, norm.eps)
            y = self.drop(_gelu_exact(dense(y, self.fc1, dt)), True, generator)
            return self.drop(dense(y, self.fc2, dt), True, generator)
        x = copy_to_tp(x, mesh)
        y = layernorm_reference(x, norm.weight, norm.bias, norm.eps)
        cols = self.fc1.weight.shape[0]
        y = self.drop(_gelu_exact(dense(y, self.fc1, dt)), True, generator,
                      (-1, mesh.tp_rank * cols, self.hidden))
        y = torch.matmul(y.to(dt), self.fc2.weight.to(dt).t())
        if mesh.tp_rank == 0:
            y = y + self.fc2.bias.to(dt)
        return self.drop(reduce_from_tp(y, mesh), True, generator)


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
    parallel mode's gate weights (BT, 1, C, 2) of the latest eager call,
    detached, for ``core.evaluate.Evaluator.count_attn`` (the whole gate
    under tensor parallelism too). Under a mesh with tp > 1 the qkv holds
    the rank's heads and proj their input columns.
    """

    def __init__(self, dim: int, num_heads: int, st_mode: str = "parallel",
                 attn_drop: float = 0.0, proj_drop: float = 0.0, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        if st_mode not in ST_MODES:
            raise ValueError(f"st_mode {st_mode!r} is not one of {ST_MODES}")
        self.mesh = _tp_mesh(mesh, "StAttention", heads=num_heads, width=dim)
        tp = 1 if self.mesh is None else self.mesh.tp
        self.num_heads, self.st_mode, self.dtype = num_heads, st_mode, dtype
        self.local_heads, self.head_dim = num_heads // tp, dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3 // tp, bias=qkv_bias)
        self.proj = nn.Linear(dim // tp, dim)
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)
        if st_mode == "parallel":
            # input is the concat of the two branch means: (2C) -> (2C)
            self.ts_attn = nn.Linear(dim * 2, dim * 2)
        self.last_gate = None

    def _qkv(self, x, norm: FastLayerNorm | None, plain: bool):
        """(BT, N, C) -> the projection (BT, N, 3, h, d) (h the rank's heads),
        never transposed; with ``norm`` the LayerNorm runs inside the
        projection's kernel."""
        BT, N, C = x.shape
        dt = self.dtype
        if norm is None:
            y = dense(x, self.qkv, dt)
        else:
            ln_dense = ln_dense_reference if plain else fused_ln_dense
            # a qkv without a bias feeds the kernel zeros, as the JAX package does
            bias = self.qkv.bias
            if bias is None:
                bias = torch.zeros(self.qkv.weight.shape[0], device=x.device)
            y = ln_dense(x, norm.weight, norm.bias, self.qkv.weight.to(dt), bias, norm.eps)
        return y.reshape(BT, N, 3, self.local_heads, self.head_dim)

    def _drop(self, train: bool, generator):
        """The attention dropout as the plain versions take it, a function
        of the probabilities and their head axis, or None where it draws
        nothing (and the kernels run). Under tensor parallelism the mask is
        drawn for every head and cut to the rank's."""
        if not train or self.attn_drop.rate == 0.0:
            return None
        if self.mesh is None:
            return lambda probs, axis: self.attn_drop(probs, True, generator)
        first = self.mesh.tp_rank * self.local_heads
        return lambda probs, axis: self.attn_drop(probs, True, generator,
                                                  (axis, first, self.num_heads))

    def _spatial(self, qkv, plain: bool, drop):
        d = qkv.shape[-1]
        if drop is not None:  # probabilities (BT, h, N, N)
            return spatial_reference_btc(qkv, d ** -0.5, lambda p: drop(p, 1))
        return (spatial_reference_btc if plain else spatial_attention_btc)(qkv, d ** -0.5)

    def _temporal(self, qkv, seqlen: int, plain: bool, drop):
        BT, N, _, h, d = qkv.shape
        if drop is not None:  # probabilities (B, N, h, T, T)
            return temporal_reference_btc(qkv, seqlen, d ** -0.5, lambda p: drop(p, 2))
        if seqlen == 1:
            # attention over a single frame is the identity over v
            return qkv[:, :, 2].reshape(BT, N, h * d).contiguous()
        temporal = temporal_reference_btc if plain else temporal_attention_fused
        return temporal(qkv, seqlen, d ** -0.5)

    def _coupling(self, qkv, seqlen: int, plain: bool, drop):
        """Attention over the T*N tokens of each clip: q, k, v are (B, h,
        T*N, d) views of the projection and the kernel writes a view of the
        (BT, N, h*d) result, so nothing is transposed on either side (under
        grad, and in an export, whose graph holds no write into a view, the
        kernel returns its own tensor, which is transposed)."""
        BT, N, _, h, d = qkv.shape
        B = BT // seqlen
        q, k, v = (a.transpose(1, 2) for a in qkv.view(B, seqlen * N, 3, h, d).unbind(2))
        if drop is not None:
            y = _attend(q, k, v, d ** -0.5, "bhsd,bhtd->bhst", "bhst,bhtd->bhsd",
                        lambda p: drop(p, 1))
        elif plain:
            reference = attention_blocked_reference if seqlen * N > MAX_TOKENS else _xla_attention
            y = reference(q, k, v, d ** -0.5)
        elif torch.is_grad_enabled() and qkv.requires_grad or torch.compiler.is_exporting():
            y = fused_attention(q, k, v, d ** -0.5)
        else:
            y = torch.empty((BT, N, h * d), dtype=qkv.dtype, device=qkv.device)
            fused_attention(q, k, v, d ** -0.5, out=y.view(B, seqlen * N, h, d).transpose(1, 2))
            return y
        return y.transpose(1, 2).reshape(BT, N, h * d)

    def _gate(self, y_s, y_t):
        """The parallel mode's gate and blend in plain form, each step in the
        dtype, as the JAX package's unfused path."""
        BT = y_s.shape[0]
        alpha = torch.cat([y_s.mean(dim=1, keepdim=True), y_t.mean(dim=1, keepdim=True)], dim=-1)
        alpha = gather_segments(alpha, 2, self.mesh)
        C = alpha.shape[-1] // 2
        alpha = torch.softmax(dense(alpha, self.ts_attn, self.dtype).reshape(BT, 1, C, 2), dim=-1)
        self._keep_gate(alpha)
        alpha = self._channels(alpha)
        return y_t * alpha[..., 1] + y_s * alpha[..., 0]

    def _channels(self, alpha):
        """The rank's channels of the gate (BT, 1, C, 2): all of them
        without a mesh."""
        if self.mesh is None:
            return alpha
        width = self.local_heads * self.head_dim
        return alpha[:, :, self.mesh.tp_rank * width:(self.mesh.tp_rank + 1) * width]

    def _split_tail(self, y_s, y_t, x, plain: bool):
        """The parallel mode's tail under tensor parallelism, x + proj(gated
        blend), from the rank's channels of the branches: E's pieces one by
        one, the branch means gathered over the group between the first two,
        proj with the bias and residual on tp rank 0 and through the
        row-parallel epilogue on the others, the ranks' parts summed."""
        mesh, dt = self.mesh, self.dtype
        means = (gate_means_reference if plain else gate_means)(y_s, y_t)
        means = gather_segments(means, 2, mesh)
        alpha = (gate_alpha_reference if plain else gate_alpha)(
            means, self.ts_attn.weight.to(dt), self.ts_attn.bias)
        self._keep_gate(alpha)
        y = (gate_blend_reference if plain else gate_blend)(
            y_s, y_t, self._channels(alpha).contiguous())
        gemm_fn = gemm_reference if plain else gemm
        if mesh.tp_rank == 0:
            out = gemm_fn(y, self.proj.weight.to(dt), self.proj.bias, "proj", x)
        else:
            out = gemm_fn(y, self.proj.weight.to(dt), None, "proj_partial")
        return reduce_from_tp(out, mesh)

    def _proj(self, y):
        """proj(y) as a plain product (the modes other than the parallel
        one's fused tail, as in the JAX package); under tensor parallelism
        the rank's partial product, the bias on tp rank 0, summed."""
        if self.mesh is None:
            return dense(y, self.proj, self.dtype)
        y = torch.matmul(y.to(self.dtype), self.proj.weight.to(self.dtype).t())
        if self.mesh.tp_rank == 0:
            y = y + self.proj.bias.to(self.dtype)
        return reduce_from_tp(y, self.mesh)

    def _keep_gate(self, alpha):
        """``last_gate`` of an eager call; an exported program keeps no state."""
        if not torch.compiler.is_exporting():
            self.last_gate = alpha.detach()

    def forward(self, x: torch.Tensor, seqlen: int, norm: FastLayerNorm, plain: bool = False,
                train: bool = False, generator: torch.Generator | None = None,
                residual: bool = True) -> torch.Tensor:
        """x: the block's pre-norm input (BT, N, C), ``norm`` its norm1.
        ``residual=False`` returns the dropped-out proj(attention) alone,
        through the plain gate in the parallel mode (a block with a
        positive dropout or drop-path rate adds the residual itself)."""
        dt, mode, mesh = self.dtype, self.st_mode, self.mesh
        x = x.to(dt)
        drop = self._drop(train, generator)
        # the block's input to the column-parallel products (no-op without a mesh)
        xc = copy_to_tp(x, mesh)
        if mode == "parallel":
            qkv = self._qkv(xc, norm, plain)
            y_t = self._temporal(qkv, seqlen, plain, drop)
            y_s = self._spatial(qkv, plain, drop)
            if not residual:
                y = self._gate(y_s, y_t)
            elif mesh is not None:
                return self._split_tail(y_s, y_t, xc, plain)
            else:
                # the gate [mean y_s || mean y_t] @ ts_attn, softmaxed per channel's
                # (spatial, temporal) pair, blends the branches; then proj and residual
                out, alpha = (gate_proj_reference if plain else fused_gate_proj)(
                    y_s, y_t, x, self.ts_attn.weight.to(dt), self.ts_attn.bias,
                    self.proj.weight.to(dt), self.proj.bias)
                self._keep_gate(alpha)
                return out
        elif mode in ("vanilla", "spatial"):
            y = self._spatial(self._qkv(xc, norm, plain), plain, drop)
        elif mode == "temporal":
            xn = norm(xc, plain)
            y = self._temporal(self._qkv(xn.mean(dim=1, keepdim=True), None, plain), seqlen,
                               plain, drop)
        elif mode == "coupling":
            y = self._coupling(self._qkv(xc, norm, plain), seqlen, plain, drop)
        else:  # series: the second projection reads every head of the first's result
            y = self._spatial(self._qkv(xc, norm, plain), plain, drop)
            y = self._temporal(self._qkv(gather_segments(y, 1, mesh), None, plain), seqlen, plain,
                               drop)
        # temporal: the (BT, 1, C) result broadcasts over the N tokens
        y = self.proj_drop(self._proj(y), train, generator)
        return x + y if residual else y


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 st_mode: str = "parallel", drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = FastLayerNorm(dim, dtype=dtype)
        self.attn = StAttention(dim, num_heads, st_mode, attn_drop, drop, qkv_bias, dtype=dtype,
                                mesh=mesh)
        self.norm2 = FastLayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, mesh=mesh)
        self.mesh = self.attn.mesh
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


def remat_block(block: Block, x: torch.Tensor, seqlen: int, plain: bool,
                generator: torch.Generator | None) -> torch.Tensor:
    """``block(x, seqlen, plain, train=True, generator)`` without keeping its
    activations: the backward runs the block's forward again.

    The masks come from ``generator``, which the checkpoint does not save
    (its ``preserve_rng_state`` keeps the default CPU and CUDA generators
    only): the first run draws from it, so that it ends the step where a
    step without remat leaves it, and the recomputation draws from a copy
    of its state before the block, so that it draws the same masks. The
    kernels' autograd Functions nest inside: the recomputation runs their
    forwards again, their backwards still go through the plain versions."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(block, x, seqlen, plain, True, None,
                                                 use_reentrant=False)
    before = generator.get_state()
    first = [True]

    def run(x):
        g = generator
        if not first[0]:
            g = torch.Generator(device=generator.device)
            g.set_state(before)
        first[0] = False
        return block(x, seqlen, plain, True, g)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


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


class PatchEmbed(nn.Module):
    """The stock ViTs' patchification: a p x p conv of stride p, VALID (a
    frame's edge past a whole patch is dropped), tokens in row-major (H, W).
    The conv stays on cuDNN, as the JAX package leaves it to XLA."""

    def __init__(self, embed_dim: int = 768, patch_size: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.patch_size = dtype, patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x: (B, H, W, 3) frames -> (B, (H/p) * (W/p), C) tokens."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        tok = F.conv2d(x, self.proj.weight.to(self.dtype), stride=self.patch_size)
        tok = tok + self.proj.bias.to(self.dtype)[:, None, None]
        return tok.flatten(2).transpose(1, 2)


class PreLogits(nn.Module):
    def __init__(self, dim: int, representation_size: int):
        super().__init__()
        self.fc = nn.Linear(dim, representation_size)


def num_patches(img_size: int, hybrid: bool = True, patch_size: int = 16) -> int:
    """Tokens the stem makes of a square frame: the hybrid stem's four
    stride-2 SAME reductions (stem conv, max-pool, stages 1 and 2), or
    PatchEmbed's whole patches."""
    if not hybrid:
        return (img_size // patch_size) ** 2
    side = img_size
    for _ in range(4):
        side = -(-side // 2)
    return side * side


class VisionTransformer(nn.Module):
    """The ViT with spatio-temporal attention of one ``st_mode``; returns the
    pre-logits cls feature, or the normed cls token without
    ``representation_size``.

    The stem is the ResNetV2 hybrid (``hybrid=True``, MAED's) or the stock
    ViTs' ``PatchEmbed`` of ``patch_size``; ``img_size`` sizes ``pos_embed``
    (the JAX package reads it off its first input). ``qkv_bias=False`` gives
    the qkv projection no bias parameter.

    Input: (B*T, H, W, 3) frames with clip length ``seqlen``.
    Output: (B*T, representation_size or embed_dim).
    """

    def __init__(self, embed_dim: int = 768, depth: int = 6, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 representation_size: int | None = 768, max_seqlen: int = 16,
                 img_size: int = 224, hybrid: bool = True, patch_size: int = 16,
                 standardize: bool = True, st_mode: str = "parallel", drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 remat: bool = False, dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.dtype, self.st_mode, self.remat = dtype, st_mode, remat
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.mlp_ratio, self.qkv_bias, self.hybrid = mlp_ratio, qkv_bias, hybrid
        self.patch_size, self.representation_size = patch_size, representation_size
        self.img_size = img_size
        if hybrid:
            self.patch_embed = HybridEmbed(embed_dim, standardize=standardize, dtype=dtype)
        else:
            self.patch_embed = PatchEmbed(embed_dim, patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, num_patches(img_size, hybrid, patch_size) + 1, embed_dim))
        if st_mode in TEMP_EMBED_MODES:
            self.temp_embed = nn.Parameter(torch.empty(1, max_seqlen, 1, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        # the drop-path rate grows linearly over the depth, from 0
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, st_mode, drop_rate, attn_drop_rate,
                  float(rate), qkv_bias, dtype=dtype, mesh=mesh)
            for rate in np.linspace(0.0, drop_path_rate, depth))
        self.norm = FastLayerNorm(embed_dim, dtype=dtype)
        if representation_size:
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
        remat = self.remat and train and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                tokens = remat_block(block, tokens, seqlen, plain, generator)
            else:
                tokens = block(tokens, seqlen, plain, train, generator)
        feat = self.norm(tokens, plain)[:, 0]
        if not self.representation_size:
            return feat
        return torch.tanh(dense(feat, self.pre_logits.fc, self.dtype))


# ---------------------------------------------------------------------------
# The factory catalog of the JAX package (maed_tpu/models/vit.py:628-682),
# with its names and hyperparameters; ``st_mode``, ``dtype`` and the rest
# come through ``**kw``. The *_384 ones default to 384 px frames (the JAX
# package reads the size off its input; here it sizes pos_embed).


def vit_small_patch16_224(**kw):
    return VisionTransformer(embed_dim=768, depth=8, num_heads=8, mlp_ratio=3.0,
                             qkv_bias=False, hybrid=False, patch_size=16,
                             representation_size=None, **kw)


def vit_base_patch16_224(**kw):
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, hybrid=False,
                             patch_size=16, representation_size=None, **kw)


def vit_base_patch16_384(**kw):
    return vit_base_patch16_224(**{"img_size": 384, **kw})


def vit_base_patch32_384(**kw):
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, hybrid=False,
                             patch_size=32, representation_size=None,
                             **{"img_size": 384, **kw})


def vit_large_patch16_224(**kw):
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16, hybrid=False,
                             patch_size=16, representation_size=None, **kw)


def vit_large_patch16_384(**kw):
    return vit_large_patch16_224(**{"img_size": 384, **kw})


def vit_large_patch32_384(**kw):
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16, hybrid=False,
                             patch_size=32, representation_size=None,
                             **{"img_size": 384, **kw})


def vit_huge_patch16_224(**kw):
    return VisionTransformer(embed_dim=1280, depth=32, num_heads=16, hybrid=False,
                             patch_size=16, representation_size=None, **kw)


def vit_huge_patch32_384(**kw):
    return VisionTransformer(embed_dim=1280, depth=32, num_heads=16, hybrid=False,
                             patch_size=32, representation_size=None,
                             **{"img_size": 384, **kw})


def vit_base_resnet50_224_in21k(**kw):
    """R50+ViT-B/16 hybrid (the in21k-pretrained stem + 12-block variant)."""
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, hybrid=True,
                             representation_size=768, **kw)


def vit_custom_resnet50_224_in21k(num_blocks, num_heads, st_mode, **kw):
    """The MAED STE factory: hybrid stem + custom depth/heads/st_mode."""
    return VisionTransformer(embed_dim=768, depth=num_blocks, num_heads=num_heads,
                             st_mode=st_mode, hybrid=True, representation_size=768, **kw)


FACTORIES = {f.__name__: f for f in (
    vit_small_patch16_224, vit_base_patch16_224, vit_base_patch16_384, vit_base_patch32_384,
    vit_large_patch16_224, vit_large_patch16_384, vit_large_patch32_384, vit_huge_patch16_224,
    vit_huge_patch32_384, vit_base_resnet50_224_in21k, vit_custom_resnet50_224_in21k)}
