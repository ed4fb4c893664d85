"""The FLOPs that benchmark/counts counts from shapes against
torch.utils.flop_counter.FlopCounterMode over the plain reference."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts.maed import forward_flops, kernel_ops
from benchmark.counts.peaks import least_time
from benchmark.harness.weights import make_weights
from benchmark.reference import model as ref_model
from benchmark.reference.body import make_body
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,clips,T,jreg", [
    ("maed_stage2", 2, 4, True), ("maed_stage2", 3, 1, False), ("maed_stage1", 4, 1, False)])
def test_forward_flops_equal_the_counter(name, clips, T, jreg):
    cfg = tiny.config(name)
    cfg["num_verts"] = 500
    body = make_body(1, CPU, cfg["num_verts"])
    state = make_weights(cfg, 2, CPU)
    size = cfg["img_size"]
    x = torch.randint(0, 256, (clips, T, size, size, 3), dtype=torch.uint8)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref_model.forward(state, x, body, cfg, jreg=body["jreg14"] if jreg else None)
    assert forward_flops(cfg, clips, T, jreg) == counter.get_total_flops()


def test_kernel_ops_are_bounded_by_their_least_time():
    cfg = tiny.config("maed_stage2")
    ops = kernel_ops(cfg, 2, 4, "bf16")
    names = [op[0] for op in ops]
    # 52 GroupNorm sites of the stem, five kernel families a block, B, A
    assert names.count("groupnorm") == 52 and names.count("ln_mlp") == 1
    assert names[-2:] == ["layernorm", "skinning"]
    assert all(least_time(f, b, dt) > 0 for _, f, b, dt in ops)
    assert "temporal_attention" not in [op[0] for op in kernel_ops(cfg, 2, 1, "f32")]
