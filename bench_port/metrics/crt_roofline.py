"""The step's reconstructions and lift: their bound (roofline.Step.crt_ms)
over the device time of crt_pass_kernel, crt_kernel and lift_kernel per
call."""
from bench_port.readers import CRT_KERNELS, kernels_roofline


def read(r):
    return kernels_roofline(r, CRT_KERNELS, lambda s: s.crt_ms())
