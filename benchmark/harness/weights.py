"""The weights of a configuration, drawn on the device from the seed.

One unit-normal draw on the device covers every drawn parameter, each scaled
by its initializer's deviation (``reference.model.std_of``); norms and biases
are constants, and a configuration's ``bias_init`` may set chosen biases (see
its ``assumed``). The result is a reference-named state dict in float32,
the master weights; the program casts what it serves in a lower precision.
"""

from __future__ import annotations

import fnmatch

import torch

from benchmark.reference.model import param_specs, std_of

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def make_weights(cfg: dict, seed: int, device) -> dict:
    specs = param_specs(cfg)
    drawn = [(name, shape, init) for name, shape, init in specs
             if init[0] not in ("const", "count")]
    total = sum(torch.Size(shape).numel() for _, shape, _ in drawn)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, offset = {}, 0
    for name, shape, init in drawn:
        n = torch.Size(shape).numel()
        w = flat[offset:offset + n].view(shape) * std_of(init)
        if init[0] == "embed":  # N(0, 0.02) cut at two deviations
            w = w.clamp_(-0.04, 0.04)
        out[name] = w
        offset += n
    for name, shape, init in specs:
        if init[0] == "const":
            out[name] = torch.full(shape, float(init[1]), device=device)
        elif init[0] == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    for pattern, value in cfg.get("bias_init", {}).items():
        hits = [k for k in out if fnmatch.fnmatchcase(k, pattern)]
        if not hits:
            raise KeyError(f"bias_init: {pattern!r} names no parameter")
        for k in hits:
            out[k] = torch.tensor(value, dtype=torch.float32, device=device).expand_as(
                out[k]).clone()
    return {name: out[name] for name, _, _ in specs}


def trainable(state: dict) -> list[str]:
    """The names of the parameters an optimizer updates (not BatchNorm's
    buffers), in the state dict's order."""
    return [k for k in state if k.rsplit(".", 1)[-1] not in BUFFERS]
