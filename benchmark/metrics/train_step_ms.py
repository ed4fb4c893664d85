"""ms a train step over the window (readers.train_step_ms)."""

from benchmark.harness.readers import train_step_ms as read  # noqa: F401
