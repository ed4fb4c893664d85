"""What each metric reads from a run (``drive.Observed``); each file of
``benchmark/metrics`` names one of these as its ``read``. A reader returns
None where the run has nothing for it to read."""

from __future__ import annotations

import statistics

import numpy as np

from benchmark.counts.peaks import PEAK_FLOPS


def _kind(obs, kind):
    return obs.cell.mix["kind"] == kind


def clips_per_s(obs):
    """Clips whose answers landed in host memory in the window, per second of
    the window (host clock)."""
    return obs.clips / obs.window_s if _kind(obs, "infer") else None


def request_p95_ms(obs):
    """The 95th percentile of every request of the window, each timed from
    when it was due (the previous answer landed) to when its answers are
    in host memory."""
    if not _kind(obs, "infer") or not obs.latencies_s:
        return None
    return float(np.percentile(np.asarray(obs.latencies_s) * 1e3, 95))


def train_step_ms(obs):
    """The window's ms (to the last step's end) over the steps it completed;
    each step includes its batch's upload."""
    return obs.window_s * 1e3 / obs.items if _kind(obs, "train") and obs.items else None


def setup_s(obs):
    """Process start to the first timed request or step."""
    return obs.setup_s


def model_build_s(obs):
    """Set-up's kernel library load (or build) and the model's build."""
    return obs.build_s


def enqueue_ms(obs):
    """The median host ms from the forward's call to its return, before any
    wait, over the window's requests."""
    if not _kind(obs, "infer") or not obs.enqueue_s:
        return None
    return statistics.median(obs.enqueue_s) * 1e3


def idle_share(obs):
    """The share of the traced segment in which no operation (kernel, copy
    or set) ran on the device: 1 - (the union of their intervals) / the
    segment."""
    t = obs.traced
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(obs):
    """Model FLOPs done in the window (counted from shapes, counts/maed.py:
    a request's forward, or 3 x a step's forwards) over the window's seconds,
    as a share of the card's dense peak in the cell's type."""
    mix = obs.cell.mix
    done = obs.clips / mix["clips"] if mix["kind"] == "infer" else obs.items
    if not done:
        return None
    return 100.0 * obs.item_flops * done / (obs.window_s * PEAK_FLOPS[mix["dtype"]])


def kernel_roofline(obs):
    """The least time of the operations the port's kernels carry out
    (counts/maed.py::kernel_ops at the cell's shapes) over the trace's
    device time of the port's kernels."""
    t = obs.traced
    if t is None or t["port_kernel_s"] <= 0:
        return None
    return 100.0 * obs.item_kernel_least_s * t["items"] / t["port_kernel_s"]


def _phase_ms(obs, phase):
    t = obs.traced
    if t is None or not t["phase_s"].get(phase):
        return None
    return t["phase_s"][phase] * 1e3 / t["items"]


def optimizer_ms(obs):
    """Device ms a step of the kernels launched under ``Optimizer.step``."""
    return _phase_ms(obs, "optimizer")


def recompute_ms(obs):
    """Device ms a step of the kernels launched under the backward of the
    port's autograd Functions (``evaluate_function: _Recompute``): the
    recompute through the kernels' plain versions and its gradient."""
    return _phase_ms(obs, "recompute")
