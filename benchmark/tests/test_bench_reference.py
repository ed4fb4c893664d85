"""The plain reference against the port's CPU path (its kernels' plain
versions) on the same weights, body and inputs, at a tiny size; and the
reference's parameters against the port's state_dict."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import check, drive
from benchmark.harness.weights import make_weights
from benchmark.reference import model as ref_model
from benchmark.reference.body import make_body
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["maed_stage2", "maed_stage1"])
def test_parameters_are_the_ports(name):
    from maed_tpu_torch.core.builder import build_train_model

    cfg = tiny.config(name)
    model, _ = build_train_model(**drive.builder_kwargs(cfg), device=CPU, seed=0,
                                 allow_synthetic_smpl=True)
    ours = {k: tuple(v.shape) for k, v in make_weights(cfg, 1, CPU).items()}
    assert ours == {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["maed_stage2", "maed_stage1"])
def test_eval_forward_matches_the_port(name):
    from maed_tpu_torch.core.builder import build_eval_model

    cfg = tiny.config(name)
    body, state = make_body(3, CPU), make_weights(cfg, 4, CPU)
    size = cfg["img_size"]
    clips = torch.randint(0, 256, (2, 4, size, size, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(5))
    model, _ = build_eval_model(**drive.builder_kwargs(cfg), dtype=torch.float32, device=CPU,
                                state_dict=state, allow_synthetic_smpl=True)
    out = model(clips, drive.smpl_model(body), J_regressor=body["jreg14"])
    ref = ref_model.forward(state, clips, body, cfg, jreg=body["jreg14"])
    gaps = check.answer_gaps([out], [ref])
    # f32 on both sides, the sums in another order: round-off
    assert max(gaps.values()) < 1e-4, gaps


@pytest.mark.parametrize("name", ["stage2_train", "stage1_train"])
def test_train_steps_match_the_port(name):
    run = drive.Run(tiny.cell(name), 9, CPU, time.perf_counter())
    run.setup()
    run.free_program()
    ref = run.reference_steps()
    assert run.first_steps["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-5)
    gaps = check.train_gaps(run.first_steps, ref)
    # f32 round-off through the tiny model's BatchNorm and GroupNorm backward,
    # which Adam's normalised first steps (lr x the sign of each gradient
    # element) carry into the change and the later losses
    assert gaps["grad"] < 2e-2 and gaps["update"] < 0.1 and gaps["loss"] < 1e-2, gaps
