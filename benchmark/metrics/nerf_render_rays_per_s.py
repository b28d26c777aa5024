"""Rays rendered per second: pixels x views completed over the whole
window, each view read back to the host, on the host clock."""

from benchmark.harness.readers import rate as read  # noqa: F401
