"""MAED's forward, counted from its shapes: the products' operations (the
model FLOPs behind ``mfu.*``) and the operations that the port carries out
in kernels of its own, each with its operations and bytes (behind
``*_roofline``).

The FLOPs are those of the plain reference's products (``reference.model``),
so that ``torch.utils.flop_counter.FlopCounterMode`` over the reference
counts the same (a CPU test holds the two equal). The kernel operations
are counted by what the operation computes at the cell's shapes, not by
what a kernel does: LN + qkv (kernel D), the spatial and temporal
attention (F/J, G/H), the gate, blend, projection and residual (E), LN + MLP
+ residual (C), the final LayerNorm (B), each GroupNorm of the stem (I) and
the skinning (A).
"""

from __future__ import annotations

from benchmark.counts import attention, conv, dense, norm, smpl
from benchmark.counts.peaks import ELEMENT_BYTES
from benchmark.reference.model import ANCESTORS, R50_CHANNELS, R50_LAYERS, STEM_STAGES, make_div


def _stem(cfg, frames):
    """(conv FLOPs, GroupNorm sites (elements, residual), side, channels) of
    the hybrid stem's ResNetV2."""
    side = conv.out_size(cfg["img_size"], 2)
    f = conv.flops(frames, 3, 64, 7, side)
    sites = [(frames * 64 * side * side, False)]
    side = conv.out_size(side, 2)  # the max-pool
    in_chs = 64
    for (chs, stride), n_blocks in zip(STEM_STAGES, cfg["stem_layers"]):
        mid = make_div(chs * 0.25)
        for b in range(n_blocks):
            st = stride if b == 0 else 1
            new = conv.out_size(side, st)
            src = in_chs if b == 0 else chs
            if b == 0:
                f += conv.flops(frames, src, chs, 1, new)
                sites.append((frames * chs * new * new, False))
            f += conv.flops(frames, src, mid, 1, side)
            f += conv.flops(frames, mid, mid, 3, new)
            f += conv.flops(frames, mid, chs, 1, new)
            sites += [(frames * mid * side * side, False), (frames * mid * new * new, False),
                      (frames * chs * new * new, True)]
            side = new
        in_chs = chs
    return f, sites, side, in_chs


def _resnet50_flops(cfg, frames):
    side = conv.out_size(cfg["img_size"], 2)
    f = conv.flops(frames, 3, 64, 7, side)
    side = conv.out_size(side, 2)
    in_chs = 64
    for si, (depth, chs) in enumerate(zip(R50_LAYERS, R50_CHANNELS)):
        mid = chs // 4
        for bi in range(depth):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            new = conv.out_size(side, stride)
            src = in_chs if bi == 0 else chs
            f += conv.flops(frames, src, mid, 1, side)
            f += conv.flops(frames, mid, mid, 3, new)
            f += conv.flops(frames, mid, chs, 1, new)
            if bi == 0:
                f += conv.flops(frames, src, chs, 1, new)
            side = new
        in_chs = chs
    return f


def _dims(cfg, frames, T):
    C, h = cfg["embed_dim"], cfg["num_heads"]
    N = (cfg["img_size"] // 16) ** 2 + 1
    return C, h, C // h, N, frames * N, frames // T


def forward_flops(cfg: dict, clips: int, T: int, eval_regressor: bool) -> int:
    """FLOPs of the forward over ``clips`` clips of ``T`` frames: the
    encoder, the decoder and SMPL (with the J14 regressor's joints when
    ``eval_regressor``)."""
    frames = clips * T
    if cfg["encoder"] == "ste":
        f, _, side, chs = _stem(cfg, frames)
        C, h, d, N, M, B = _dims(cfg, frames, T)
        f += conv.flops(frames, chs, C, 1, side)
        hidden = int(C * cfg["mlp_ratio"])
        temporal = attention.flops(B * N * h, T, d) if T > 1 else 0
        per_block = (dense.flops(M, C, 3 * C) + attention.flops(frames * h, N, d)
                     + temporal + dense.flops(frames, 2 * C, 2 * C)
                     + dense.flops(M, C, C) + dense.flops(M, C, hidden)
                     + dense.flops(M, hidden, C))
        f += cfg["num_blocks"] * per_block + dense.flops(frames, C, C)
        feat = C
    else:
        f = _resnet50_flops(cfg, frames)
        feat = R50_CHANNELS[-1]
    H = cfg["hidden_dim"]
    f += dense.flops(frames, feat, H) + dense.flops(frames, H, H)
    f += dense.flops(frames, H, 10) + dense.flops(frames, H, 3)
    f += sum(dense.flops(frames, H + 6 * len(anc), 6) for anc in ANCESTORS)
    return f + smpl.flops(frames, cfg["num_verts"], 14 if eval_regressor else 0)


def kernel_ops(cfg: dict, clips: int, T: int, dtype: str) -> list[tuple[str, float, float, str]]:
    """(operation, FLOPs, bytes, the type it computes in) of every
    operation a forward runs through the port's own kernels. Only the
    ``ste`` encoder has them, and the skinning step of either."""
    frames = clips * T
    ops = []
    if cfg["encoder"] == "ste":
        es = ELEMENT_BYTES[dtype]
        _, sites, _, _ = _stem(cfg, frames)
        for elements, residual in sites:
            ops.append(("groupnorm", 0.0, norm.nbytes(elements, es, residual), dtype))
        C, h, d, N, M, B = _dims(cfg, frames, T)
        hidden = int(C * cfg["mlp_ratio"])
        for _ in range(cfg["num_blocks"]):
            ops.append(("ln_qkv", dense.flops(M, C, 3 * C), dense.nbytes(M, C, 3 * C, es), dtype))
            ops.append(("spatial_attention", attention.flops(frames * h, N, d),
                        attention.nbytes(frames * h, N, d, es), dtype))
            if T > 1:  # attention over one frame is its v: no kernel runs
                ops.append(("temporal_attention", attention.flops(B * N * h, T, d),
                            attention.nbytes(B * N * h, T, d, es), dtype))
            ops.append(("gate_proj", dense.flops(frames, 2 * C, 2 * C) + dense.flops(M, C, C),
                        (4 * M * C + 5 * C * C) * es, dtype))
            ops.append(("ln_mlp", dense.flops(M, C, hidden) + dense.flops(M, hidden, C),
                        (2 * M * C + 2 * C * hidden) * es, dtype))
        ops.append(("layernorm", 0.0, norm.nbytes(M * C, es), dtype))
    ops.append(("skinning", smpl.skinning_flops(frames, cfg["num_verts"]),
                smpl.skinning_bytes(frames, cfg["num_verts"]), "f32"))
    return ops
