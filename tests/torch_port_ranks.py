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
For a job ``{"collectives": True}``: what each of ``parallel.dist``'s
collectives gave this rank.

    python -m torch.distributed.run --nproc_per_node 2 tests/torch_port_ranks.py \\
        cli <record_dir> <stop_rank> <stop_after> <train CLI arguments ...>

runs ``maed_tpu_torch.train.main`` with the CLI arguments, recording in
``<record_dir>/rank<r>.json`` this rank's own step metrics and the
(metrics, count) pairs its validation hands to ``Evaluator.sync_metrics``.
Rank ``stop_rank`` sends itself SIGTERM after its ``stop_after``-th step
(-1: never).
"""

import functools
import json
import os
import signal
import sys
from pathlib import Path


def run_job(job: dict, rank: int) -> dict:
    import torch

    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.models import maed as maed_module
    from maed_tpu_torch.models.resnet import ResNet50
    from maed_tpu_torch.parallel import dist
    from maed_tpu_torch.parallel import train_step as TS
    from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model

    if job.get("resnet"):  # the narrow ResNet the JAX side builds too
        maed_module.ResNet50 = functools.partial(ResNet50, **job["resnet"])
    model = maed_module.MAED(**job["model"], dtype=torch.float64).double()
    model.load_state_dict(job["state_dict"], strict=True)
    model.train()
    optim = type("Optim", (), job["optim"])
    step = TS.make_train_step(model, TS.make_optimizer(optim, 10, model.parameters()),
                              synthetic_smpl_model(job["num_verts"], 0, device="cpu"),
                              LossWeights(), torch.Generator().manual_seed(rank))
    metrics = []
    for vid, img in job["calls"]:
        m = step(vid and vid[rank], img and img[rank])
        keys = sorted(m)
        metrics.append(dict(zip(keys, dist.mean_over_ranks(
            torch.stack([m[k] for k in keys])).tolist())))
    named = dict(model.named_parameters())
    out = {"metrics": metrics,
           "grads": {k: p.grad.clone() for k, p in named.items()},
           "params": {k: p.detach().clone() for k, p in named.items()},
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
    jobs = torch.load(jobs_path, weights_only=False)
    results = [collectives(rank) if job.get("collectives") else run_job(job, rank)
               for job in jobs]
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


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    if sys.argv[1] == "steps":
        steps(*sys.argv[2:4])
    else:
        cli(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5:])
