"""The check that decides ``correct`` comes out false where the timed path is
broken, and the control (the reference in a lower precision, in the
program's place) fails the limits.

Each fault test drives a whole run on the CPU at a tiny size (everything of
``run.py`` but its look for a card), with the program broken underneath:
an answer altered where it is produced; half of the batch left out; a
train step that leaves its state unchanged. A served cell's tiny run is
in f32 (the CPU's), so that its sound run sits within the limits and the
fault is what fails it; a training cell's is f32 as on the card.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import check, drive
from benchmark.tests import tiny

CPU = torch.device("cpu")
INFER, TRAIN = ["stage2_infer_b32", "stage2_infer_b8"], ["stage2_train", "stage1_train"]


def run(name, **mix):
    cell = tiny.cell(name)
    cell.mix.update(mix)
    return drive.run_cell(cell, 2 ** 31 + 17, 0.5, False, CPU, time.perf_counter())


def patch_forward(monkeypatch, change):
    from maed_tpu_torch.models import maed

    forward = maed.MAED.forward

    def broken(self, x, *args, **kwargs):
        return change(forward, self, x, args, kwargs)

    monkeypatch.setattr(maed.MAED, "forward", broken)


def altered(forward, model, x, args, kwargs):
    """The last clip answered with the first clip's answer."""
    out = forward(model, x, *args, **kwargs)
    return {k: torch.cat([v[:-1], v[:1]]) for k, v in out.items()}


def half_batch(forward, model, x, args, kwargs):
    n = x.shape[0]
    out = forward(model, x[: n // 2], *args, **kwargs)
    return {k: torch.cat([v, v[: n - n // 2]]) for k, v in out.items()}


@pytest.mark.parametrize("name", INFER)
def test_infer_sound_run_is_correct(name):
    assert run(name, dtype="f32")["correct"]


@pytest.mark.parametrize("fault", [altered, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", INFER)
def test_infer_fault_is_not_correct(monkeypatch, name, fault):
    patch_forward(monkeypatch, fault)
    assert not run(name, dtype="f32")["correct"]


@pytest.mark.parametrize("name", INFER)
def test_infer_control_fails(name):
    """The reference in float8 in the program's place, on the requests a
    run sampled, fails the cell's limits."""
    cell = tiny.cell(name)
    r = drive.Run(cell, 2 ** 31 + 3, CPU, time.perf_counter())
    r.setup()
    r.window(0.5)
    r.free_program()
    numbers = r.reference_numbers(program=lambda pool_i: r.reference_outputs(pool_i, "fp8"))
    assert not check.verdict(numbers, cell.limits)[0]


@pytest.mark.parametrize("name", TRAIN)
def test_train_sound_run_is_correct(name):
    assert run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_state_unchanged_is_not_correct(monkeypatch, name):
    from maed_tpu_torch.parallel import train_step

    monkeypatch.setattr(train_step.TrainOptimizer, "step", lambda self: True)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_half_batch_is_not_correct(monkeypatch, name):
    from maed_tpu_torch.parallel import train_step

    make = train_step.make_train_step

    def halved(*args, **kwargs):
        step = make(*args, **kwargs)
        mix = tiny.cell(name).mix
        return lambda vid, img: step(drive._half(vid, mix), drive._half(img, mix))

    monkeypatch.setattr(train_step, "make_train_step", halved)
    assert not run(name)["correct"]


@pytest.mark.cuda
def test_train_control_tf32_fails():
    """The reference with TF32 on in the program's place fails the stage-2
    step's limits (on the card, at one 2D + one 3D clip and two images)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    cell = tiny.full_cell("stage2_train")
    cell.mix.update(clips_2d=1, clips_3d=1, images=2)
    r = drive.Run(cell, 2 ** 31 + 5, torch.device("cuda", 0), time.perf_counter())
    r.setup()
    r.free_program()
    numbers = check.train_gaps(r.reference_steps(tf32=True), r.reference_steps())
    assert not check.verdict(numbers, cell.limits)[0]
