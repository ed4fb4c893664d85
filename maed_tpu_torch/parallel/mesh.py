"""The rank layout of tensor and data parallelism, its process groups, and
the partition rules of the ViT's parameters.

Counterpart of ``maed_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ('dcn', 'dp', 'tp') mesh, shards the batch over ('dcn',
'dp') jointly and the ViT's qkv, proj, fc1 and fc2 Megatron-style over
'tp' (fc1 and qkv by output columns, proj and fc2 by input rows), and
lets GSPMD place the collectives. Here the devices are torchrun's
processes: :func:`make_mesh` lays the W ranks out as the JAX reshape
``reshape(dcn, dp, tp)`` does (tp fastest), makes each rank's tp group
(the ranks of one (dcn, dp) index) and data group (the dcn x dp ranks of
one tp index), and makes the data group the one that ``parallel.dist``'s
data collectives reduce over. The 'dcn' axis is only the layout: the
batch goes over (dcn, dp) jointly, and NCCL picks its own hierarchical
all-reduce across nodes.

There is no partitioner: each rank holds its own shard of the sharded
parameters as contiguous parameters of its modules (``models.vit``), and
launches its kernels on it, the collectives written out in
``parallel.tensor``. :data:`_TP_RULES` is the port's copy of the JAX
rules over the port's state_dict names (torch layout: a Linear's weight is
(out, in), so the flax kernel's spec reversed). The math is JAX's; one
placement differs: JAX's ``P(None, 'tp')`` on the fused (C, 3C) qkv kernel
cuts the 3C axis into contiguous blocks, so that at tp = 2 rank 0 would
hold q and half of k, which GSPMD then reshards. Without GSPMD the qkv is
sharded by head: rank t holds rows j C + c0 .. j C + c1 (j = 0, 1, 2 for
q, k, v; c0 = t C / tp) of torch's (3C, C) weight, the q, k and v of its
h / tp heads, and proj takes the matching input columns c0 .. c1.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist

from maed_tpu_torch.parallel import dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dcn, dp, tp) layout and its groups.
    ``tp_group`` is None when tp = 1, ``data_group`` None when it is every
    rank (tp = 1, or no process group)."""

    dcn: int
    dp: int
    tp: int
    rank: int = 0
    tp_group: object = None
    data_group: object = None

    @property
    def shape(self) -> dict:
        """The axis sizes by name, as the JAX mesh's ``shape`` (no 'dcn'
        axis at dcn = 1)."""
        axes = {"dp": self.dp, "tp": self.tp}
        return {"dcn": self.dcn, **axes} if self.dcn > 1 else axes

    @property
    def coords(self) -> tuple:
        """This rank's (dcn, dp, tp) indices."""
        return tuple(int(i) for i in np.unravel_index(self.rank, (self.dcn, self.dp, self.tp)))

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def data_rank(self) -> int:
        """Which shard of the data this rank takes: its (dcn, dp) index."""
        return self.rank // self.tp

    @property
    def data_world(self) -> int:
        return self.dcn * self.dp

    def ranks(self) -> np.ndarray:
        """The global ranks in the mesh's layout, as the JAX mesh's
        ``devices`` holds the devices: (dp, tp), or (dcn, dp, tp)."""
        layout = np.arange(self.dcn * self.dp * self.tp).reshape(self.dcn, self.dp, self.tp)
        return layout if self.dcn > 1 else layout[0]


def make_mesh(dp: int | None = None, tp: int = 1, dcn: int = 1) -> Mesh:
    """The mesh of torchrun's W ranks (W = 1 without a process group): dp
    defaults to W // (tp dcn), and dcn dp tp must equal W. Every rank must
    call it at the same point (it makes the groups). It makes the mesh's
    data group ``parallel.dist``'s."""
    world, rank = dist.world(), dist.rank()
    if dp is None:
        dp = world // (tp * dcn) if tp * dcn and world % (tp * dcn) == 0 else 0
    need = dcn * dp * tp
    if min(dcn, dp, tp) < 1 or need != world:
        raise ValueError(f"mesh {dcn}x{dp}x{tp} (dcn x dp x tp) needs {need} processes; this "
                         f"run has {world}")
    layout = np.arange(world).reshape(dcn, dp, tp)
    tp_group = data_group = None
    if tp > 1:
        # every rank makes every group, in one order
        for members in layout.reshape(-1, tp):
            group = tdist.new_group(members.tolist())
            if rank in members:
                tp_group = group
        for t in range(tp):
            members = layout[..., t].reshape(-1)
            group = tdist.new_group(members.tolist())
            if rank in members:
                data_group = group
    dist.set_data_group(data_group)
    return Mesh(dcn, dp, tp, rank, tp_group, data_group)


# (regex over the port's state_dict name, spec in torch's layout) — the
# first match wins, anything else is replicated. A spec names the mesh axis
# each dimension is split over (None: whole), as a PartitionSpec does.
_TP_RULES = [
    (r".*attn\.qkv\.weight$", ("tp", None)),
    (r".*attn\.qkv\.bias$", ("tp",)),
    (r".*attn\.proj\.weight$", (None, "tp")),
    (r".*mlp\.fc1\.weight$", ("tp", None)),
    (r".*mlp\.fc1\.bias$", ("tp",)),
    (r".*mlp\.fc2\.weight$", (None, "tp")),
]
_BY_HEAD = re.compile(r".*attn\.qkv\.(weight|bias)$")


def param_spec(name: str) -> tuple:
    """The partition spec of a state_dict name: () for a replicated one."""
    for pattern, spec in _TP_RULES:
        if re.match(pattern, name):
            return spec
    return ()


def _split_dim(name: str):
    spec = param_spec(name)
    return spec.index("tp") if "tp" in spec else None


def _index(name: str, full: int, tp: int, t: int):
    """The indices of rank t's shard along the split dimension of length
    ``full``: contiguous, or for the qkv the rows of its heads in each of
    q, k and v."""
    if _BY_HEAD.match(name):
        if full % (3 * tp):
            raise ValueError(f"{name}: 3C = {full} rows do not split over tp = {tp}")
        c, w = full // 3, full // 3 // tp
        return torch.cat([torch.arange(j * c + t * w, j * c + (t + 1) * w) for j in range(3)])
    if full % tp:
        raise ValueError(f"{name}: {full} do not split over tp = {tp}")
    w = full // tp
    return torch.arange(t * w, (t + 1) * w)


def shard_tensor(name: str, full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank ``mesh.tp_rank``'s shard of the full tensor of ``name``, a
    contiguous copy (the tensor itself when replicated)."""
    dim = _split_dim(name)
    if dim is None or mesh.tp == 1:
        return full
    idx = _index(name, full.shape[dim], mesh.tp, mesh.tp_rank).to(full.device)
    return full.index_select(dim, idx).contiguous()


def gather_tensor(name: str, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full tensor of ``name`` from every rank's shard (a collective over
    the tp group: each rank places its shard in zeros, then one all-reduce,
    since gloo gathers no CUDA tensor). Replicated: ``local``."""
    dim = _split_dim(name)
    if dim is None or mesh.tp == 1:
        return local
    shape = list(local.shape)
    shape[dim] *= mesh.tp
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    idx = _index(name, shape[dim], mesh.tp, mesh.tp_rank).to(local.device)
    full.index_copy_(dim, idx, local)
    tdist.all_reduce(full, group=mesh.tp_group)
    return full


def shard_state_dict(state_dict: dict, mesh: Mesh) -> dict:
    """The full, reference-named state_dict -> this rank's (the sharded
    entries cut to its shard, the rest as they are)."""
    return {k: shard_tensor(k, v, mesh) for k, v in state_dict.items()}


def gather_state_dict(state_dict: dict, mesh: Mesh) -> dict:
    """A rank's state_dict -> the full, reference-named one, on every rank
    (a collective over the tp group, in the dict's order)."""
    return {k: gather_tensor(k, v, mesh) for k, v in state_dict.items()}


def _moments(optimizer_state: dict, names: list, convert) -> dict:
    """An optimizer's state_dict with each sharded parameter's moments
    (the tensors shaped as the parameter: Adam's exp_avg and exp_avg_sq,
    SGD's momentum buffer) passed through ``convert(name, tensor)``."""
    state = {}
    for idx, per in optimizer_state["state"].items():
        name = names[idx]
        state[idx] = {k: convert(name, v) if isinstance(v, torch.Tensor) and v.ndim else v
                      for k, v in per.items()}
    return {**optimizer_state, "state": state}


def gather_optimizer_state(optimizer_state: dict, names: list, mesh: Mesh) -> dict:
    """An optimizer's state_dict over this rank's shards -> over the full
    parameters; ``names`` are the parameters' state_dict names in the
    optimizer's order. A collective over the tp group."""
    return _moments(optimizer_state, names, lambda n, t: gather_tensor(n, t, mesh))


def shard_optimizer_state(optimizer_state: dict, names: list, mesh: Mesh) -> dict:
    """The inverse of :func:`gather_optimizer_state`."""
    return _moments(optimizer_state, names, lambda n, t: shard_tensor(n, t, mesh))


def model_mesh(model: torch.nn.Module) -> Mesh | None:
    """The mesh a model's tensor-parallel blocks run on, or None."""
    return next((m.mesh for m in model.modules() if getattr(m, "mesh", None) is not None), None)


def tp_partial_parameters(model: torch.nn.Module) -> list:
    """The replicated parameters of the model's tensor-parallel blocks: the
    norms in front of a column-parallel product, the gate's ts_attn, and
    the biases of proj and fc2, which tp rank 0 alone adds. Each is used
    on a rank for its channels only, so its gradient there is partial and
    must be summed over the tp group (``parallel.dist.sum_gradients``)."""
    return [p for m in model.modules() if getattr(m, "mesh", None) is not None
            and hasattr(m, "norm1") for name, p in m.named_parameters() if param_spec(name) == ()]
