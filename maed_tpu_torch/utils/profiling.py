"""Profiling hooks of the trainer: the port's counterpart of
``maed_tpu/utils/profiling.py``.

Set MAED_PROFILE_DIR=/path (and optionally MAED_PROFILE_STEPS=N, default 5)
to trace the first N train steps of a run with ``torch.profiler`` (host
and, on the card, CUDA activity). The trace is exported as a Chrome trace,
``<dir>/maed_trace_<pid>.json``, when step N - 1 ends, or when the run ends
first (:func:`stop_trace`); chrome://tracing or Perfetto open it. The JAX
package writes an XProf trace there instead.
"""

from __future__ import annotations

import contextlib
import os

import torch

_active = None  # the running profiler and its directory


def profile_dir() -> str | None:
    return os.environ.get("MAED_PROFILE_DIR") or None


def profile_steps() -> int:
    return int(os.environ.get("MAED_PROFILE_STEPS", "5"))


def start_trace(directory: str) -> None:
    """Start tracing host and (where there is a card) CUDA activity."""
    global _active
    if _active is not None:
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _active = (prof, directory)


def stop_trace() -> str | None:
    """Stop the running trace and export it; returns the trace's path, or
    None when nothing was being traced."""
    global _active
    if _active is None:
        return None
    prof, directory = _active
    _active = None
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"maed_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(step: int):
    """Trace the configured window of steps: starts at step 0, stops and
    exports after step MAED_PROFILE_STEPS - 1."""
    d = profile_dir()
    if d and step == 0:
        start_trace(d)
    try:
        yield
    finally:
        if d and step == profile_steps() - 1:
            stop_trace()


def annotate(name: str):
    """A named region of the trace (a ``record_function``)."""
    return torch.profiler.record_function(name)
