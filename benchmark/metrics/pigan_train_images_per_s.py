"""Images trained per second: batch x iterations (a D step, then a G
step) completed over the whole window, on the host clock."""

from benchmark.harness.readers import rate as read  # noqa: F401
