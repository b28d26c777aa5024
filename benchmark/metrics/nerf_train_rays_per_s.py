"""Rays trained per second: batch x steps completed over the whole window,
on the host clock."""

from benchmark.harness.readers import rate as read  # noqa: F401
