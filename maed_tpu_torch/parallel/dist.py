"""Data parallelism across processes: the process group, and the few
collectives that training needs.

Port of the data-parallel role of ``maed_tpu/parallel/mesh.py`` (the 'dp'
axis) and of the ``multihost_utils`` calls of ``maed_tpu/core/trainer.py``
and ``core/evaluate.py``. One process a card, started by
``torch.distributed.run`` (torchrun), which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; NCCL on the card, gloo on the CPU.
Each process holds 1/W of the global batch. The loss terms that are not
plain means (``core.loss``) and BatchNorm's moments (``models.resnet``) are
summed across the processes inside the forward (:func:`sum_over_ranks`,
whose backward sums the gradient across them too), and the gradient is
averaged after the backward (:func:`average_gradients`): W processes then
train as one process does on the whole batch.

Under tensor parallelism (``parallel.mesh.make_mesh`` with tp > 1) the
ranks of a tp group hold the same batch, so what means "over the data"
runs over the data group (the 'dcn' x 'dp' ranks of one tp index, the JAX
package's ``_data_axes``): :func:`sum_over_ranks`, :func:`mean_over_ranks`,
:func:`weighted_mean`, :func:`gather_objects` and
:func:`average_gradients`; summing over a tp group would count its batch tp
times. :func:`any_rank`, :func:`barrier` and :func:`broadcast_str_from_rank0`
stay over every rank. Without a mesh the data group is every rank.

Without a launcher no group is made, and every function here is the
one-process identity: rank 0 of 1.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


# the group that "over the data" reduces over: None is every rank
_data_group = None


def set_data_group(group) -> None:
    """Make ``group`` the data group (``parallel.mesh.make_mesh`` calls it;
    None: every rank)."""
    global _data_group
    _data_group = group


def data_rank() -> int:
    """This rank's index in its data group: which shard of the data it takes."""
    return dist.get_rank(_data_group) if initialized() else 0


def data_world() -> int:
    """The number of shards of the data: the data group's size."""
    return dist.get_world_size(_data_group) if initialized() else 1


def init_from_env(cpu: bool, backend: str | None = None) -> tuple[int, int]:
    """Join the process group that the launcher's environment describes and
    return (rank, world). The backend is NCCL, or gloo when ``cpu`` (or
    ``backend`` when given); on the card each process first takes the card
    LOCAL_RANK names. Without RANK in the environment (no launcher) it makes
    no group and returns (0, 1); with WORLD_SIZE > 1 but no RANK, or a group
    that cannot start, it raises: a run meant for W processes never carries
    on as one."""
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if "RANK" not in os.environ:
        if world_size > 1:
            raise RuntimeError(f"WORLD_SIZE={world_size} but no RANK: start the processes with "
                               "python -m torch.distributed.run")
        return 0, 1
    if initialized():
        return rank(), world()
    backend = backend or ("gloo" if cpu else "nccl")
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("a process group on the card needs a CUDA device and none is "
                               "visible; set DEVICE cpu to train on the CPU over gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://", world_size=world_size,
                            rank=int(os.environ["RANK"]))
    return rank(), world()


def shutdown() -> None:
    """Leave the group (at the end of a run, on every rank)."""
    set_data_group(None)
    if initialized():
        dist.destroy_process_group()


def _device() -> torch.device:
    """Where the group's own small tensors live: the card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def broadcast_str_from_rank0(value: str, max_len: int = 1024) -> str:
    """Rank 0's ``value`` on every rank, e.g. the checkpoint that TRAIN.RESUME
    auto resolved: ranks that resolved it against their own view of the
    output directory could start at different epochs and hang each other's
    next collective. A value longer than ``max_len`` bytes raises on every
    rank, never a truncated path. One process: ``value``."""
    if world() <= 1:
        return value
    buf = torch.zeros(max_len + 1, dtype=torch.uint8, device=_device())
    raw = value.encode()
    if rank() == 0:
        if len(raw) > max_len:
            buf[max_len] = 1
        elif raw:
            buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    dist.broadcast(buf, 0)
    data = buf.cpu().numpy()
    if data[max_len]:
        raise ValueError(f"broadcast_str_from_rank0: rank 0's value is longer than max_len="
                         f"{max_len} bytes (path too deep?)" + (f": {value[:120]}..."
                                                                if rank() == 0 else ""))
    return bytes(data[data != 0]).decode()


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (an all-reduce MAX): a stop that
    one rank saw becomes every rank's. Every rank must call it at the same
    point."""
    if world() <= 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def mean_over_ranks(values: torch.Tensor) -> torch.Tensor:
    """The mean over the data group of ``values`` (f64; a copy on one
    process)."""
    values = values.detach().to(torch.float64)
    if data_world() <= 1:
        return values
    values = values.to(_device())
    dist.all_reduce(values, group=_data_group)
    return values / data_world()


def weighted_mean(values: dict, count: int) -> tuple[dict, int]:
    """The mean of every metric over the data group, each rank's weighted by
    its ``count`` (its predictions), and the total count: one all-reduce of
    [value * count ..., count] in f64. One shard: the arguments."""
    if data_world() <= 1:
        return values, count
    keys = list(values)
    local = torch.tensor([values[k] * count for k in keys] + [count], dtype=torch.float64,
                         device=_device())
    dist.all_reduce(local, group=_data_group)
    total = local.tolist()
    n = max(total[-1], 1.0)
    return {k: total[i] / n for i, k in enumerate(keys)}, int(total[-1])


def gather_objects(obj) -> list | None:
    """Every data rank's ``obj`` (picklable), in data-rank order, on data
    rank 0 of each data group (global rank 0 among them); None on the
    others. One shard: [obj]."""
    if data_world() <= 1:
        return [obj]
    root = dist.get_global_rank(_data_group, 0) if _data_group is not None else 0
    out = [None] * data_world() if data_rank() == 0 else None
    dist.gather_object(obj, out, dst=root, group=_data_group)
    return out


class _SumOverRanks(torch.autograd.Function):
    """Σ over the data group; the gradient of each rank's input is Σ over
    the group of the output's gradient."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=_data_group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group, differentiably. With each rank's
    loss a function of the sum, the rank's gradient is then the sum over
    the group of their losses' gradients: what :func:`average_gradients`
    divides by the data W is the gradient of the global batch's mean loss.
    No group: ``t``."""
    if not initialized():
        return t
    return _SumOverRanks.apply(t)


def _all_reduce_grads(grads, group, divisor: int = 1) -> None:
    """Each tensor of ``grads`` summed over ``group`` (then divided by
    ``divisor``), in one all-reduce of their concatenation."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat /= divisor
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def average_gradients(params) -> None:
    """Replace each parameter's ``.grad`` by its mean over the data group, in
    one all-reduce of their concatenation. The ranks run the same model on
    the same composition of batch, so the same parameters have a gradient
    on each; those without one are left so."""
    if data_world() <= 1:
        return
    _all_reduce_grads([p.grad for p in params if p.grad is not None], _data_group,
                      data_world())


def sum_gradients(params, group) -> None:
    """Replace each parameter's ``.grad`` by its sum over ``group`` (a tp
    group), a zero gradient standing for a rank's missing one: the
    replicated parameters of a tensor-parallel block, whose use on a rank
    covers only its channels (``parallel.mesh.tp_partial_parameters``)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _all_reduce_grads([p.grad for p in params], group)


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (the start of data
    parallel training: every rank built the same model from the same seed,
    and this makes it so whatever they loaded)."""
    if world() <= 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
