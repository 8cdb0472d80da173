"""The keyswitch dot: its bound (roofline.Step.modular_ms's second term,
K = 3 x ndigits) over the device time per call of the operations tagged
with the program's span fhe.keyswitch_dot (by_span).  None where no
operation carries the tag."""
from bench_port.by_span import KEYSWITCH, keyswitch_ms, span_roofline


def read(r):
    return span_roofline(r, KEYSWITCH, keyswitch_ms(r.step))
