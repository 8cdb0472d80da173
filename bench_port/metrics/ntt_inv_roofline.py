"""The two inverse transforms (3 tensored parts on the full chain, 2
keyswitched parts on the keyswitch basis): their bound (two terms of
roofline.Step.ntt_ms) over the device time per call of the operations
tagged with the program's span fhe.ct_inv (by_span).  None on a dense
step and where no operation carries the tag."""
from bench_port.by_span import ntt_roofline


def read(r):
    return ntt_roofline(r, "fhe.ct_inv")
