"""The port's kernels against their roofline in the traced steps (readers.kernel_roofline)."""

from benchmark.harness.readers import kernel_roofline as read  # noqa: F401
