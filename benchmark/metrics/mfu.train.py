"""3 x the step's forward FLOPs as a share of the f32 peak (readers.mfu)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
