"""The served forward's model FLOPs as a share of the bf16 peak (readers.mfu)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
