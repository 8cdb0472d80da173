"""The forward transform of the 4 lifted parts: its bound (one term of
roofline.Step.ntt_ms) over the device time per call of the operations
tagged with the program's span fhe.ct_fwd (by_span).  None on a dense
step and where no operation carries the tag."""
from bench_port.by_span import ntt_roofline


def read(r):
    return ntt_roofline(r, "fhe.ct_fwd")
