"""The tensor product and the keyswitch dot: their bound
(roofline.Step.modular_ms) over the device time of tensor_product_kernel
and keyswitch_dot_kernel per call."""
from bench_port.readers import MODULAR_KERNELS, kernels_roofline


def read(r):
    return kernels_roofline(r, MODULAR_KERNELS, lambda s: s.modular_ms())
