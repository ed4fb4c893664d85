"""Process start to the first timed request or step (readers.setup_s)."""

from benchmark.harness.readers import setup_s as read  # noqa: F401
