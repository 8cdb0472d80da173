"""Device operations (kernels, copies, sets) per mul_relin call in the
torch.profiler trace."""
from bench_port.readers import launches_per_step as read  # noqa: F401
