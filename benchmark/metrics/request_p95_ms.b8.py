"""The 95th percentile of the 8-clip served requests (readers.request_p95_ms)."""

from benchmark.harness.readers import request_p95_ms as read  # noqa: F401
