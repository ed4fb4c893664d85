"""The numbers that decide ``correct``, and the verdict against a cell's limits.

A served cell's answers are compared over the sampled requests' clips:
the rotations (``rotmat``) by the widest relative gap ``|P - R| / |R|`` of
a clip (L2 over its frames), so that one clip answered wrong fails; theta,
the mesh and the joints (``verts``, ``kp_2d``, ``kp_3d``) by the relative
gap over the whole sample, since their widest clip's gap swings from seed
to seed by as much as the float8 control lies above it.

A training cell's are taken by the worst leaf: the gap between the
program's norm and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger: of the first step's gradient as
Adam takes it (``grad``) and of the parameters' change over the checked
steps (``update``, leaving out leaves whose reference gradient is under a
thousandth of the median leaf's, which move by round-off alone); and the
largest relative gap of the checked steps' losses (``loss``). A number that
is not finite reads as infinite.
"""

from __future__ import annotations

import math
import statistics

import torch

OUTPUTS = ("theta", "verts", "kp_2d", "kp_3d", "rotmat")
BY_CLIP = ("rotmat",)  # the rest over the whole sample
QUIET_LEAF = 1e-3  # a leaf whose reference gradient norm is under this x the median's


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def answer_gaps(prog: list, ref: list) -> dict:
    """The compared numbers of the sampled requests' answers: lists of
    {output: (N, T, ...)} of the program and of the reference."""
    out = {}
    for k in OUTPUTS:
        p = torch.cat([a[k].double().reshape(a[k].shape[0], -1) for a in prog])
        r = torch.cat([a[k].double().reshape(a[k].shape[0], -1) for a in ref])
        if k in BY_CLIP:
            gap = ((p - r).norm(dim=1) / r.norm(dim=1)).max().item()
        else:
            gap = ((p - r).norm() / r.norm()).item()
        out[k] = _finite(gap)
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        if not math.isfinite(prog[n]):
            return math.inf
        worst = max(worst, abs(prog[n] - ref[n]) / max(ref[n], med))
    return worst


def worst_leaves(prog: dict, ref: dict, k: int = 3) -> dict:
    """The ``k`` leaves with the widest gaps of ``grad`` and of ``update``:
    {number: [[leaf, gap, program norm, reference norm], ...]}."""
    out = {}
    for key in ("grad", "update"):
        p, r = prog[key], ref[key]
        med = statistics.median(r.values())
        gaps = sorted(((abs(p[n] - r[n]) / max(r[n], med), n) for n in r), reverse=True)[:k]
        out[key] = [[n, g, p[n], r[n]] for g, n in gaps]
    return out


def train_gaps(prog: dict, ref: dict) -> dict:
    """prog, ref: {'losses': [...], 'grad': {leaf: norm}, 'update': {leaf: norm}}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad"].values())
    moving = {n for n, v in ref["grad"].items() if v >= QUIET_LEAF * med}
    return {"loss": _finite(loss), "grad": leaf_gap(prog["grad"], ref["grad"]),
            "update": leaf_gap(prog["update"], ref["update"], moving)}


def leaf_norms(tensors: dict) -> dict:
    """{name: float norm}, read back in one transfer."""
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().double().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) of the numbers the cell's limits
    name: correct where each is at or under its limit (a cell with no
    limits is never correct)."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok and bool(checks), checks
