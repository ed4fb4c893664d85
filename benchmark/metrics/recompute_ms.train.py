"""Device ms a step under the _Recompute backward (readers.recompute_ms)."""

from benchmark.harness.readers import recompute_ms as read  # noqa: F401
