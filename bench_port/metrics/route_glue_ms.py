"""Device ms per call of the operations around the matmul route's stage
products: every device operation that is neither a GEMM (launched by
aten::mm, matmul, bmm, addmm or baddbmm) nor one of the port's
hand-written kernels.  On the route that is the float64 casts, the
reductions mod q, the twiddles, the permutes and the phim <-> N
re-indexing, and the key rows' gather.  None where no GEMM ran (a ring
off the route)."""
import re

from bench_port.readers import DENSE_OPS

HAND_WRITTEN = re.compile(
    r"\b(ct_mma_kernel|crt_pass_kernel|crt_kernel|lift_kernel"
    r"|tensor_product_kernel|keyswitch_dot_kernel|byte_decomp_kernel)\b")


def read(r):
    if not r.trace.calls or not any(o.op in DENSE_OPS for o in r.trace.ops):
        return None
    us = sum(o.dur for o in r.trace.ops
             if o.op not in DENSE_OPS and not HAND_WRITTEN.search(o.name))
    return us / r.trace.calls / 1e3
