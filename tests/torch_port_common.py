"""Shared helpers of the tests of maed_tpu_torch.

Inputs are made with numpy from a seed and handed to both sides: to the JAX
package as numpy arrays, to the port as tensors. This module imports no JAX,
so the tests that run on the card, where JAX is absent, can use it.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

RANKS_SCRIPT = Path(__file__).resolve().parent / "torch_port_ranks.py"
REPO = RANKS_SCRIPT.parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' shapes are tiny: torch's thread pool would only contend
    with the other test workers. A test module that imports this fixture
    runs its torch ops on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(_numpy(got), _numpy(want), atol=atol, rtol=rtol, err_msg=what)


def ln_inputs(rng, shape=(3, 7, 64)):
    """x, LayerNorm scale and bias."""
    C = shape[-1]
    return (rng.randn(*shape) * 2 + 0.5, rng.rand(C) + 0.5, rng.randn(C) * 0.1)


def mlp_inputs(rng, shape=(3, 7, 64), H=128):
    """x, ln scale and bias, then w1 (C, H), b1, w2 (H, C), b2 as flax stores
    them; the weights scaled by 1/sqrt(fan_in), so outputs stay O(1) at any width."""
    C = shape[-1]
    return (rng.randn(*shape), rng.rand(C) + 0.5, rng.randn(C) * 0.1,
            rng.randn(C, H) / np.sqrt(C), rng.randn(H) * 0.1, rng.randn(H, C) / np.sqrt(H),
            rng.randn(C) * 0.1)


def torch_mlp_args(args, dtype):
    """The flax-layout MLP inputs as the port takes them: nn.Linear's (out,
    in) weights in x's dtype, the LN parameters and biases f32 (f64 for an
    f64 x, as the JAX f64 reference has them)."""
    x, s, b, w1, b1, w2, b2 = args
    pdt = torch.promote_types(dtype, torch.float32)

    def T(a, dt=pdt):
        return to_torch(a).to(dt)

    return (T(x, dtype), T(s), T(b), T(w1.T, dtype), T(b1), T(w2.T, dtype), T(b2))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ranks_env(**extra) -> dict:
    """The environment of a process of the port's data-parallel tests: the
    repository importable, torch on one thread."""
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1", **extra)


class Ranks:
    """``tests/torch_port_ranks.py steps`` on ``jobs`` in ``world`` gloo
    processes on a free localhost port, started at construction: the caller
    goes on (a JAX compile) while they run. :meth:`results` waits for them
    and returns each rank's results."""

    def __init__(self, jobs, tmp_path, world=2):
        self.tmp_path, self.world = tmp_path, world
        torch.save(jobs, tmp_path / "jobs.pt")
        port = free_port()
        self.procs, self.logs, self._results = [], [], None
        for rank in range(world):
            env = ranks_env(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                            MASTER_ADDR="localhost", MASTER_PORT=str(port))
            self.logs.append(tmp_path / f"rank{rank}.log")
            with open(self.logs[-1], "w") as out:  # files, not pipes: a full pipe would stall a rank
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(RANKS_SCRIPT), "steps", str(tmp_path / "jobs.pt"),
                     str(tmp_path)], env=env, stdout=out, stderr=subprocess.STDOUT))

    def results(self, timeout=300):
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=timeout)
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for rank, p in enumerate(self.procs):
                assert p.returncode == 0, f"rank {rank}:\n{self.logs[rank].read_text()[-3000:]}"
            paths = [self.tmp_path / f"rank{r}.pt" for r in range(self.world)]
            self._results = [torch.load(path, weights_only=False) for path in paths]
            for path in paths + [self.tmp_path / "jobs.pt"]:  # hundreds of MB: not kept on disk
                path.unlink()
        return self._results


# The port's test models for export: the hybrid stem with one bottleneck a
# stage (its widths and every kind of GroupNorm site kept) and the narrow
# stage-1 ResNet-50 of tests/test_torch_port_stage1.py. An export's cost,
# and its artifact's save and load, grow with the nodes of the graph.
NARROW_STEM_LAYERS = (1, 1, 1)
NARROW_RESNET = dict(layers=(1, 1, 1, 1), channels=(16, 32, 64, 128))


def narrow_models(monkeypatch):
    """Build the port's MAEDs with the narrow stem and ResNet-50 while
    ``monkeypatch`` holds."""
    import functools

    from maed_tpu_torch.models import maed, vit
    from maed_tpu_torch.models.resnet import ResNet50
    from maed_tpu_torch.models.resnetv2 import ResNetV2

    monkeypatch.setattr(vit, "ResNetV2",
                        lambda **kw: ResNetV2(**dict(kw, layers=NARROW_STEM_LAYERS)))
    monkeypatch.setattr(maed, "ResNet50", functools.partial(ResNet50, **NARROW_RESNET))
