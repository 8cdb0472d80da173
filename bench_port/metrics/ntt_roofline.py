"""The step's transforms: their bound (roofline.Step.ntt_ms) over the
device time of ct_mma_kernel per call."""
from bench_port.readers import NTT_KERNELS, kernels_roofline


def read(r):
    return kernels_roofline(r, NTT_KERNELS, lambda s: s.ntt_ms())
