"""Set-up's library load and model build (readers.model_build_s)."""

from benchmark.harness.readers import model_build_s as read  # noqa: F401
