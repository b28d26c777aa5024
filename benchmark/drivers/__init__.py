"""One module per entry the measured window drives, each with a ``Driver``
class; the harness finds it by the traffic file's ``driver`` name."""
