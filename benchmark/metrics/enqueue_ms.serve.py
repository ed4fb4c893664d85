"""The forward's host enqueue, median over the window (readers.enqueue_ms)."""

from benchmark.harness.readers import enqueue_ms as read  # noqa: F401
