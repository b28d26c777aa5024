"""ms per step of the device operations that are not the port's kernels
(PyTorch's own: sampling, sort, compositing, loss, Adam), from the trace."""

from benchmark.harness.readers import plain_ms as read  # noqa: F401
