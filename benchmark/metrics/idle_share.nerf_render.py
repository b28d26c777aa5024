"""The device's idle share of the traced window, in %: 1 - busy / window,
busy the union of the device operations' intervals."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
