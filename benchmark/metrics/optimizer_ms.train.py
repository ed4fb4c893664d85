"""Device ms a step under Optimizer.step (readers.optimizer_ms)."""

from benchmark.harness.readers import optimizer_ms as read  # noqa: F401
