"""Clips answered a second in the window of the 8-clip served request (readers.clips_per_s)."""

from benchmark.harness.readers import clips_per_s as read  # noqa: F401
