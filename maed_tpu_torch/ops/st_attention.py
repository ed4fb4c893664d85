"""The attention branches of the parallel spatio-temporal block: the CUDA
kernels of ``csrc/st_attention.cu`` and their plain PyTorch versions.

Counterpart of ``maed_tpu/ops/st_attention.py``. All functions read the qkv
projection's natural (BT, N, 3, h, d) layout:

- spatial, over the N tokens of each frame: ``spatial_attention`` writes the
  head-leading (h, BT, N, d) of the Pallas ``_spatial_kernel``;
  ``spatial_attention_btc`` writes the (BT, N, h*d) the block consumes (the
  JAX model gets there through ``fused_attention`` and two transposes);
- temporal, over the T frames of each (token, head): ``temporal_attention``
  writes (h, BT, N, d) as ``_temporal_kernel`` does, and
  ``temporal_attention_fused`` (BT, N, h*d) as ``_temporal_v2_kernel`` does.

One CUDA kernel serves each branch, addressed by strides, so no layout is
copied. Every kernel takes a head dim d that is a multiple of 8 from 8 to
768 (768: embed 768 in one head, the widest the JAX encoder forms), in f32
and bf16, and raises for another. The kernels of ``csrc/st_attention.cu``
take the head dims they were built for (f32 up to 128; bf16 spatial 16, 32,
64 or 128 on the TMA + wgmma kernel; bf16 temporal up to 128); every other
d goes to ``csrc/attention_general.cu``, counted apart in
``kernels.LAUNCHES`` (``*_general``). ``*_reference*`` are the plain versions with the kernels' rounding
points: scores of x-dtype operands accumulated in promote(dtype, f32), times
scale, softmax there, p rounded to v's dtype, the p v product accumulated in
promote(dtype, f32). The four entry points have a gradient: autograd through
the plain versions on the saved projection (``ops.recompute``), as the JAX
package's custom VJPs recompute theirs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from maed_tpu_torch import kernels
from maed_tpu_torch.ops import library
from maed_tpu_torch.ops.recompute import differentiable

MAX_HEAD_DIM = 768   # the general kernel (csrc/attention_general.cu) walks d in chunks
FAST_HEAD_DIM = 128  # st_attention.cu's kernels keep 4 output columns per lane
MAX_TOKENS = 1024    # spatial: a row's scores in shared memory (f32), 4 key chunks (bf16)
MAX_FRAMES = 32      # temporal: two 16-frame tiles (bf16), a warp's shared memory (f32)
MMA_HEAD_DIMS = (16, 32, 64, 128)  # spatial and blocked in bf16: the wgmma kernels' head dims


def general_head_dim(d: int, is_bf16: int, temporal: bool = False) -> bool:
    """Whether head dim ``d`` runs on the general kernel: beyond FAST_HEAD_DIM,
    or, for spatial and blocked attention in bf16, outside MMA_HEAD_DIMS."""
    return d > FAST_HEAD_DIM or (bool(is_bf16) and not temporal and d not in MMA_HEAD_DIMS)


FRAME_ROWS = 32  # the general kernel's 'frames' form: a warp an item of up to 32 rows
ROW_KEYS = 256   # its 'rows' form: the exact softmax in one pass over up to 256 keys
# the 'rows' form's score widths: 197 tokens (224 px) take 200 (bf16) or 208 (f32)
ROW_WIDTHS = {1: (64, 128, 192, 200, 256), 0: (64, 128, 192, 208, 256)}
FRAMES, ROWS, TILED = 0, 1, 2


class GeneralPlan(NamedTuple):
    """How ``csrc/attention_general.cu`` runs one call (see its note); the
    shared memory each form takes is ``csrc/general_layout.cuh``'s."""
    kind: int   # FRAMES (exact, S <= 32), ROWS (exact, S <= 256) or TILED
    width: int  # FRAMES: rows padded to 16 or 32; ROWS: the score width; TILED: query rows a CTA
    cols: int   # output columns of a part (ROWS and FRAMES: all, a 64-column block at a time)
    parts: int  # CTAs over an item's output columns (TILED beyond 384 columns)


def general_plan(S: int, d: int, is_bf16: int, online: bool) -> GeneralPlan:
    """The form and template instance of a general-kernel call of S rows an
    item at head dim d. The exact softmax runs as FRAMES up to FRAME_ROWS
    rows, as ROWS up to ROW_KEYS keys (one pass), else as TILED in two
    passes; the online softmax always as TILED, whose output columns a CTA
    holds in registers: at most 384 (six 64-column blocks), the rest in
    further parts, each forming the scores again. TILED bf16 takes 128 query
    rows a CTA up to d 128 (each consumer warpgroup 64 rows and every
    column), else 64 (the two consumers split a part's columns, so a part is
    a whole number of 128-column pairs)."""
    blocks = -(-d // 64)  # 64-column blocks of the head dim
    if not online and S <= FRAME_ROWS:
        return GeneralPlan(FRAMES, 16 if S <= 16 else 32, 64 * blocks, 1)
    if not online and S <= ROW_KEYS:
        width = next(w for w in ROW_WIDTHS[int(is_bf16)] if w >= S)
        return GeneralPlan(ROWS, width, 64 * blocks, 1)
    if is_bf16 and blocks <= 2:
        return GeneralPlan(TILED, 128, 64 * blocks, 1)
    parts = -(-blocks // 6)
    per = -(-blocks // parts)  # column blocks a part
    return GeneralPlan(TILED, 64, 128 * -(-per // 2) if is_bf16 else 64 * per, parts)


def launch_general(name: str, count: str, is_bf16: int, online: bool, q, k, v, out,
                   sizes, strides, o_strides, S: int, scale) -> None:
    """One launch of ``csrc/attention_general.cu``: batch items of ``sizes``
    (n0, n1, n2), S rows each, q, k, v at ``strides`` (s0, s1, s2, srow) and
    out at ``o_strides`` (o0, o1, o2, orow), all in elements, run as
    :func:`general_plan` says."""
    per16 = 16 // out.element_size()
    if out.data_ptr() % 16 or any(s % per16 for s in o_strides):
        raise ValueError(f"{name}: the kernel writes 16-byte rows: the output's rows must be "
                         f"16-byte aligned (strides {out.stride()})")
    plan = general_plan(S, q.shape[-1], is_bf16, online)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        kernels.check(lib.maed_general_attention(
            is_bf16, int(online), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *sizes, S, q.shape[-1], *strides, *o_strides, scale, *plan,
            torch.cuda.current_stream().cuda_stream), f"{name} (maed_general_attention)")
    kernels.LAUNCHES[count] += 1


def _attend(q, k, v, scale, scores: str, mix: str, drop=None) -> torch.Tensor:
    """softmax(q k * scale) v by the two einsums, rounded as the kernels round;
    ``drop``, if given, applies to the rounded probabilities (the attention
    dropout of a training model, which no kernel takes)."""
    st = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum(scores, q.to(st), k.to(st)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if drop is not None:
        probs = drop(probs)
    return torch.einsum(mix, probs.to(st), v.to(st)).to(v.dtype)


def _split(qkv: torch.Tensor):
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (BT, N, 3, h, d), got {tuple(qkv.shape)}")
    return qkv.unbind(2)


def spatial_reference(qkv, scale):
    """qkv (BT, N, 3, h, d) -> (h, BT, N, d), head-leading."""
    q, k, v = _split(qkv)
    return _attend(q, k, v, scale, "bqhd,bkhd->bhqk", "bhqk,bkhd->hbqd")


def spatial_reference_btc(qkv, scale, drop=None):
    """qkv (BT, N, 3, h, d) -> (BT, N, h*d); ``drop`` as in :func:`_attend`."""
    q, k, v = _split(qkv)
    BT, N, h, d = q.shape
    return _attend(q, k, v, scale, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd",
                   drop).reshape(BT, N, h * d)


def _clips(qkv, seqlen):
    q, k, v = _split(qkv)
    BT, N, h, d = q.shape
    if seqlen < 1 or BT % seqlen:
        raise ValueError(f"{BT} frames do not split into clips of {seqlen}")
    return [a.reshape(BT // seqlen, seqlen, N, h, d) for a in (q, k, v)]


def temporal_reference(qkv, seqlen, scale):
    """qkv (BT, N, 3, h, d) -> (h, BT, N, d); attention over T per (n, h)."""
    BT, N, _, h, d = qkv.shape
    q, k, v = _clips(qkv, seqlen)
    out = _attend(q, k, v, scale, "bqnhd,bknhd->bnhqk", "bnhqk,bknhd->hbqnd")
    return out.reshape(h, BT, N, d)


def temporal_reference_btc(qkv, seqlen, scale, drop=None):
    """qkv (BT, N, 3, h, d) -> (BT, N, h*d); attention over T per (n, h);
    ``drop`` as in :func:`_attend`."""
    BT, N, _, h, d = qkv.shape
    q, k, v = _clips(qkv, seqlen)
    out = _attend(q, k, v, scale, "bqnhd,bknhd->bnhqk", "bnhqk,bknhd->bqnhd", drop)
    return out.reshape(BT, N, h * d)


def check_operands(name: str, q, k, v) -> int:
    """What both kernels ask of q, k, v (each (..., d)): CUDA, one dtype of
    f32 or bf16, the same shape and strides, head dim contiguous, d a
    multiple of 8 up to MAX_HEAD_DIM and every row 16-byte aligned. Returns
    is_bf16."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: the kernel takes f32 or bf16, got {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device or t.shape != q.shape \
                or t.stride() != q.stride():
            raise ValueError(f"{name}: q, k, v must share dtype, device, shape and strides; "
                             f"got {t.dtype} {tuple(t.shape)} {t.stride()} on {t.device} "
                             f"beside {q.dtype} {tuple(q.shape)} {q.stride()} on {q.device}")
    d = q.shape[-1]
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernels take a head dim that is a multiple of 8 from 8 "
                         f"to {MAX_HEAD_DIM}, got {d}")
    per16 = 16 // q.element_size()
    if q.stride(-1) != 1 or any(s % per16 for s in q.stride()[:-1]) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel reads 16-byte chunks: the head dim must be "
                         f"contiguous and every row 16-byte aligned (strides {q.stride()})")
    if q.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}")
    return int(q.dtype == torch.bfloat16)


def launch_bhsd(name: str, q, k, v, out, scale, blocked: bool = False) -> None:
    """One attention kernel on q, k, v and out, all (B, h, S, d) views: the
    spatial kernel (S up to MAX_TOKENS), or with ``blocked`` the
    online-softmax kernel of ``ops.attention`` (any S). Both take the same
    operands."""
    is_bf16 = check_operands(name, q, k, v)
    B, h, S, d = q.shape
    if not blocked and S > MAX_TOKENS:
        raise ValueError(f"{name}: the kernel takes at most {MAX_TOKENS} tokens, got {S}")
    if B * h >= 2 ** 31 or -(-S // 32) > 65535:
        raise ValueError(f"{name}: {B} x {h} x {S} exceeds the grid")
    if out.shape != q.shape or out.stride(-1) != 1 or out.dtype != q.dtype:
        raise ValueError(f"{name}: bad output view {tuple(out.shape)} {out.stride()}")
    if general_head_dim(d, is_bf16):
        launch_general(name, "attention_blocked_general" if blocked else
                       "spatial_attention_general", is_bf16, blocked, q, k, v, out, (B, h, 1),
                       (*q.stride()[:2], 0, q.stride(2)), (*out.stride()[:2], 0, out.stride(2)),
                       S, scale)
        return
    if is_bf16 and (d not in MMA_HEAD_DIMS or any(s % 2 for s in out.stride()[:3])
                    or out.data_ptr() % 4):
        raise ValueError(f"{name}: bf16 runs on the tensor cores alone, which take a head dim "
                         f"of {MMA_HEAD_DIMS} and an output of aligned pairs; got d {d}, "
                         f"output strides {out.stride()}")
    lib = kernels.library()
    entry, count = (("maed_blocked_attention", "attention_blocked") if blocked
                    else ("maed_spatial_attention", "spatial_attention"))
    with torch.cuda.device(q.device):
        kernels.check(getattr(lib, entry)(
            is_bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, h, S, d,
            *q.stride()[:3], *out.stride()[:3], scale,
            torch.cuda.current_stream().cuda_stream), entry)
    kernels.LAUNCHES[count] += 1


def _spatial(name, qkv, scale, btc: bool):
    q, k, v = (a.transpose(1, 2) for a in _split(qkv))  # (BT, h, N, d) views
    BT, h, N, d = q.shape
    if btc:
        out = torch.empty((BT, N, h * d), dtype=qkv.dtype, device=qkv.device)
        view = out.view(BT, N, h, d).transpose(1, 2)
    else:
        out = torch.empty((h, BT, N, d), dtype=qkv.dtype, device=qkv.device)
        view = out.transpose(0, 1)
    launch_bhsd(name, q, k, v, view, scale)
    return out


_spatial_heads = functools.partial(_spatial, "spatial_attention", btc=False)
_spatial_btc = functools.partial(_spatial, "spatial_attention_btc", btc=True)
library.define("spatial_attention(Tensor qkv, float scale) -> Tensor", _spatial_heads,
               spatial_reference)
library.define("spatial_attention_btc(Tensor qkv, float scale) -> Tensor", _spatial_btc,
               spatial_reference_btc)


def spatial_attention(qkv, scale):
    """:func:`spatial_reference` as one CUDA launch: (h, BT, N, d)."""
    return differentiable(_spatial_heads, spatial_reference, qkv, scale)


def spatial_attention_btc(qkv, scale):
    """:func:`spatial_reference_btc` as one CUDA launch: (BT, N, h*d)."""
    return differentiable(_spatial_btc, spatial_reference_btc, qkv, scale)


def _temporal(name, qkv, seqlen, scale, btc: bool):
    q, k, v = _split(qkv)
    is_bf16 = check_operands(name, q, k, v)
    BT, N, h, d = q.shape
    if not 1 <= seqlen <= MAX_FRAMES or BT % seqlen:
        raise ValueError(f"{name}: the kernel takes clips of 1 to {MAX_FRAMES} frames that "
                         f"divide the {BT} frames given, got seqlen {seqlen}")
    if BT // seqlen * N * h >= 2 ** 33:
        raise ValueError(f"{name}: {BT // seqlen} x {N} x {h} exceeds the grid")
    if btc:
        out = torch.empty((BT, N, h * d), dtype=qkv.dtype, device=qkv.device)
        o_strides = (N * h * d, h * d, d)       # frame, token, head
    else:
        out = torch.empty((h, BT, N, d), dtype=qkv.dtype, device=qkv.device)
        o_strides = (N * d, d, BT * N * d)
    if general_head_dim(d, is_bf16, temporal=True):
        # batch items (clip, token, head), a clip's frames its rows
        s_frame, s_token, s_head = q.stride()[:3]
        launch_general(name, "temporal_attention_general", is_bf16, False, q, k, v, out,
                       (BT // seqlen, N, h), (seqlen * s_frame, s_token, s_head, s_frame),
                       (seqlen * o_strides[0], *o_strides[1:], o_strides[0]), seqlen, scale)
        return out
    lib = kernels.library()
    with torch.cuda.device(qkv.device):
        kernels.check(lib.maed_temporal_attention(
            is_bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BT // seqlen, seqlen, N, h, d, *q.stride()[:3], *o_strides, scale,
            torch.cuda.current_stream().cuda_stream), "maed_temporal_attention")
    kernels.LAUNCHES["temporal_attention"] += 1
    return out


_temporal_heads = functools.partial(_temporal, "temporal_attention", btc=False)
_temporal_btc = functools.partial(_temporal, "temporal_attention_fused", btc=True)
library.define("temporal_attention(Tensor qkv, int seqlen, float scale) -> Tensor",
               _temporal_heads, temporal_reference)
library.define("temporal_attention_btc(Tensor qkv, int seqlen, float scale) -> Tensor",
               _temporal_btc, temporal_reference_btc)


def temporal_attention(qkv, seqlen, scale):
    """:func:`temporal_reference` as one CUDA launch: (h, BT, N, d)."""
    return differentiable(_temporal_heads, temporal_reference, qkv, seqlen, scale)


def temporal_attention_fused(qkv, seqlen, scale):
    """:func:`temporal_reference_btc` as one CUDA launch: (BT, N, h*d)."""
    return differentiable(_temporal_btc, temporal_reference_btc, qkv, seqlen, scale)
