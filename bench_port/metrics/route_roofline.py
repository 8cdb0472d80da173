"""The matmul route's four transforms: their FP64 bound
(roofline_route.route_ms) over the device time per call of the kernels
that aten::mm, matmul, bmm, addmm or baddbmm launched, the route's stage
products.  None on a step without a Cooley-Tukey split or with no such
kernel in the trace."""
from bench_port.readers import DENSE_OPS, roofline_pct
from bench_port.roofline_route import route_ms


def read(r):
    if r.step.split is None:
        return None
    us = sum(o.dur for o in r.trace.ops if o.op in DENSE_OPS)
    return roofline_pct(r, route_ms(r.step), us)
