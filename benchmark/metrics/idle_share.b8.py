"""The device's idle share of the traced segment (readers.idle_share)."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
