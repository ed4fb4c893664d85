"""A rank of maed_tpu_torch's data-parallel tests, on the CPU over gloo. It
imports torch and the port only.

    python tests/torch_port_ranks.py steps <jobs.pt> <out_dir>

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set
(``torch_port_common.Ranks`` starts the ranks): joins the group through
``parallel.dist.init_from_env`` and, for each job of ``jobs.pt``, builds the
port's MAED in f64 from the job's state_dict and calls
``make_train_step``'s step on this rank's slice of each call's batches.
Writes ``<out_dir>/rank<r>.pt``: per job, each call's metrics averaged over
the ranks (``dist.mean_over_ranks``, the trainer's reduction) and whether
the rank's parameters, gradients and BatchNorm running statistics after
the calls equal rank 0's bit for bit; rank 0 also writes those tensors.
A job's ``mesh`` (``parallel.mesh.make_mesh``'s arguments; default: data
parallel over every rank) lays the ranks out: a rank takes the calls'
batches of its data rank and draws its masks from a generator seeded with
its data rank, the model holds its tp shards, and the tensors written are
the full ones (``gather_state_dict``). ``narrow_stem`` builds the hybrid
stem with one bottleneck a stage. For a job ``{"collectives": True}``: what
each of ``parallel.dist``'s collectives gave this rank; ``{"layout":
mesh}``: the rank's place in that mesh and its groups' members;
``{"checkpoint": ...}``: a tensor-parallel trainer's checkpoint written
(``Trainer.state``, full names) to ``<out_dir>/tp_checkpoint.pth.tar`` and
resumed by a trainer of other weights, whether its shards then equal the
writer's bit for bit.

    python -m torch.distributed.run --nproc_per_node 2 tests/torch_port_ranks.py \\
        cli <record_dir> <stop_rank> <stop_after> <train CLI arguments ...>

runs ``maed_tpu_torch.train.main`` with the CLI arguments, recording in
``<record_dir>/rank<r>.json`` this rank's own step metrics and the
(metrics, count) pairs its validation hands to ``Evaluator.sync_metrics``.
Rank ``stop_rank`` sends itself SIGTERM after its ``stop_after``-th step
(-1: never).

    python -m torch.distributed.run --nproc_per_node 2 tests/torch_port_ranks.py \
        eval <record_dir> <eval CLI arguments ...>

runs ``maed_tpu_torch.eval.main`` and writes what it returned on this rank
(the metrics and the pose count) to ``<record_dir>/rank<r>.json``.
"""

import functools
import json
import os
import signal
import sys
from pathlib import Path


def build(job: dict, mesh):
    """The job's MAED in f64 in training mode, holding this rank's shards of
    ``job["state_dict"]``."""
    import torch

    from maed_tpu_torch.models import maed as maed_module
    from maed_tpu_torch.models import vit
    from maed_tpu_torch.models.resnet import ResNet50
    from maed_tpu_torch.models.resnetv2 import ResNetV2
    from maed_tpu_torch.parallel.mesh import shard_state_dict

    if job.get("resnet"):  # the narrow ResNet the JAX side builds too
        maed_module.ResNet50 = functools.partial(ResNet50, **job["resnet"])
    if job.get("narrow_stem"):
        vit.ResNetV2 = lambda **kw: ResNetV2(**dict(kw, layers=(1, 1, 1)))
    model = maed_module.MAED(**job["model"], dtype=torch.float64, mesh=mesh).double()
    model.load_state_dict(shard_state_dict(job["state_dict"], mesh), strict=True)
    return model.train()


def run_job(job: dict, rank: int) -> dict:
    import torch

    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.parallel import dist
    from maed_tpu_torch.parallel import train_step as TS
    from maed_tpu_torch.parallel.mesh import gather_state_dict, make_mesh
    from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model

    mesh = make_mesh(**job.get("mesh", {}))
    model = build(job, mesh)
    optim = type("Optim", (), job["optim"])
    step = TS.make_train_step(model, TS.make_optimizer(optim, 10, model.parameters()),
                              synthetic_smpl_model(job["num_verts"], 0, device="cpu"),
                              LossWeights(), torch.Generator().manual_seed(mesh.data_rank))
    metrics = []
    for vid, img in job["calls"]:
        m = step(vid and vid[mesh.data_rank], img and img[mesh.data_rank])
        keys = sorted(m)
        metrics.append(dict(zip(keys, dist.mean_over_ranks(
            torch.stack([m[k] for k in keys])).tolist())))
    named = dict(model.named_parameters())
    out = {"metrics": metrics,
           "grads": gather_state_dict({k: p.grad.clone() for k, p in named.items()}, mesh),
           "params": gather_state_dict({k: p.detach().clone() for k, p in named.items()}, mesh),
           "stats": {k: v.clone() for k, v in model.state_dict().items() if "running" in k}}
    # whether this rank ends as rank 0 does, bit for bit; rank 0 alone keeps
    # the tensors (a tiny model in f64 still has 22.7 M parameters)
    out["same_as_rank0"] = all(same_as_rank0(out[key]) for key in ("grads", "params", "stats"))
    if rank:
        del out["grads"], out["params"], out["stats"]
    return out


def same_as_rank0(tensors: dict) -> bool:
    """Whether every tensor of ``tensors`` equals rank 0's, bit for bit."""
    import torch
    import torch.distributed

    same = True
    for value in tensors.values():
        ref = value.clone()
        torch.distributed.broadcast(ref, 0)
        same = same and torch.equal(ref, value)
    return same


def layout(args: dict, rank: int) -> dict:
    """This rank's place in ``make_mesh(**args)`` and the global ranks of
    its tp and data groups."""
    import torch.distributed

    from maed_tpu_torch.parallel import dist
    from maed_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(**args)

    def members(group):
        return torch.distributed.get_process_group_ranks(group) if group is not None else None

    return {"coords": mesh.coords, "tp_rank": mesh.tp_rank, "data_rank": mesh.data_rank,
            "data_world": mesh.data_world, "shape": mesh.shape, "ranks": mesh.ranks().tolist(),
            "tp_group": members(mesh.tp_group), "data_group": members(mesh.data_group),
            "dist_data": (dist.data_rank(), dist.data_world()),
            "mean": dist.mean_over_ranks(torch.tensor([rank + 1.0])).tolist()}


def checkpoint(job: dict, rank: int, out_dir: str) -> dict:
    """One step of a tensor-parallel model, its trainer's checkpoint (full
    names) written by rank 0, then resumed by a trainer of the job's
    ``other_state_dict``: whether every rank's shards of the parameters and
    of Adam's moments, and its generator, then equal the writer's."""
    import torch

    from maed_tpu_torch.core.config import get_cfg_defaults
    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.core.trainer import Trainer
    from maed_tpu_torch.parallel import dist
    from maed_tpu_torch.parallel import train_step as TS
    from maed_tpu_torch.parallel.mesh import make_mesh
    from maed_tpu_torch.utils import checkpoint as ckpt
    from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model

    mesh = make_mesh(**job["mesh"])
    smpl = synthetic_smpl_model(job["num_verts"], 0, device="cpu")
    optim = type("Optim", (), job["optim"])
    cfg = get_cfg_defaults()

    def trainer(state_dict):
        model = build(dict(job, state_dict=state_dict), mesh)
        opt = TS.make_optimizer(optim, 10, model.parameters())
        generator = torch.Generator().manual_seed(mesh.data_rank)
        step = TS.make_train_step(model, opt, smpl, LossWeights(), generator)
        return Trainer({}, step, model, opt, generator, smpl, cfg, logdir=out_dir,
                       num_iters_per_epoch=1)

    writer = trainer(job["state_dict"])
    vid, img = job["call"]
    writer.train_step(vid[mesh.data_rank], img[mesh.data_rank])
    state = writer.state(0, 1.0)
    if rank == 0:
        ckpt.save_checkpoint(out_dir, state, name="tp_checkpoint")
    dist.barrier()
    reader = trainer(job["other_state_dict"])
    reader.resume(str(Path(out_dir) / "tp_checkpoint.pth.tar"))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    opt_w, opt_r = (t.optimizer.optimizer.state_dict()["state"] for t in (writer, reader))
    return {"params": same(writer.model.state_dict().values(), reader.model.state_dict().values()),
            "moments": all(same(opt_w[i].values(), opt_r[i].values()) for i in opt_w),
            "generator": torch.equal(writer.generator.get_state(), reader.generator.get_state()),
            "local_qkv": writer.model.state_dict()["encoder.blocks.0.attn.qkv.weight"].clone(),
            "calls": reader.optimizer.calls}


def collectives(rank: int) -> dict:
    """Each collective of ``parallel.dist`` on inputs that differ by rank."""
    import torch

    from maed_tpu_torch.parallel import dist

    out = {"broadcast": dist.broadcast_str_from_rank0("resume/" * (rank + 1)),
           "any": (dist.any_rank(rank == 1), dist.any_rank(False)),
           "weighted": dist.weighted_mean({"mpjpe": 10.0 * (rank + 1), "pve": 1.0}, rank + 1),
           "gathered": dist.gather_objects({"rank": rank}),
           "mean": dist.mean_over_ranks(torch.tensor([rank + 1.0])).tolist()}
    try:
        dist.broadcast_str_from_rank0("x" * 9 if rank == 0 else "", max_len=8)
    except ValueError as e:
        out["too_long"] = str(e)
    x = torch.tensor([rank + 1.0], dtype=torch.float64, requires_grad=True)
    y = dist.sum_over_ranks(x * x)
    y.backward()
    out["sum"], out["sum_grad"] = y.item(), x.grad.item()
    layer = torch.nn.Linear(2, 1).double()
    with torch.no_grad():
        layer.weight.fill_(rank)
        layer.bias.fill_(rank)
    dist.broadcast_module(layer)
    layer(torch.full((1, 2), rank + 1.0, dtype=torch.float64)).sum().backward()
    dist.average_gradients(layer.parameters())
    out["module"] = [p.detach().tolist() for p in layer.parameters()]
    out["grads"] = [p.grad.tolist() for p in layer.parameters()]
    return out


def steps(jobs_path: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from maed_tpu_torch.parallel import dist

    rank, world = dist.init_from_env(cpu=True)
    assert world == int(os.environ["WORLD_SIZE"]) > 1
    from maed_tpu_torch.parallel.mesh import make_mesh

    jobs = torch.load(jobs_path, weights_only=False)
    results = []
    for job in jobs:
        if job.get("collectives"):
            make_mesh()  # over every rank
            results.append(collectives(rank))
        elif "layout" in job:
            results.append(layout(job["layout"], rank))
        elif "checkpoint" in job:
            results.append(checkpoint(job, rank, out_dir))
        else:
            results.append(run_job(job, rank))
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    dist.shutdown()


def cli(record_dir: str, stop_rank: int, stop_after: int, argv) -> None:
    from maed_tpu_torch import train as train_cli
    from maed_tpu_torch.core.evaluate import Evaluator
    from maed_tpu_torch.parallel import train_step as TS

    rank = int(os.environ["RANK"])
    record = {"steps": [], "sync": []}

    def dump():
        with open(Path(record_dir) / f"rank{rank}.json", "w") as f:
            json.dump(record, f)

    make = TS.make_train_step

    def make_recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(*batches):
            out = step(*batches)
            record["steps"].append({k: float(v) for k, v in out.items()})
            dump()
            if rank == stop_rank and len(record["steps"]) == stop_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return recorded

    sync = Evaluator.sync_metrics

    def sync_recorded(self, eval_dict, num_pred):
        record["sync"].append([dict(eval_dict), int(num_pred)])
        dump()
        return sync(self, eval_dict, num_pred)

    TS.make_train_step = make_recording
    Evaluator.sync_metrics = sync_recorded
    train_cli.main(argv)


def eval_cli(record_dir: str, argv) -> None:
    from maed_tpu_torch import eval as eval_module

    metrics, poses = eval_module.main(argv)
    with open(Path(record_dir) / f"rank{os.environ['RANK']}.json", "w") as f:
        json.dump({"metrics": metrics, "poses": int(poses)}, f)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    if sys.argv[1] == "steps":
        steps(*sys.argv[2:4])
    elif sys.argv[1] == "eval":
        eval_cli(sys.argv[2], sys.argv[3:])
    else:
        cli(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5:])
