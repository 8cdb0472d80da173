"""Share (%) of the traced window in which nothing ran on the device
(torch.profiler trace: kernels, copies and sets)."""
from bench_port.readers import idle_pct as read  # noqa: F401
