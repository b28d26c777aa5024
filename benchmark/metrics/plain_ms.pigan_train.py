"""ms per iteration of the device operations that are not the port's
kernels (the discriminator on cuDNN, the mapping network, the render, Adam),
from the trace."""

from benchmark.harness.readers import plain_ms as read  # noqa: F401
