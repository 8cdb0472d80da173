"""Device ms per call of the plain phim <-> N steps around the tensor-core
kernel on a mixed-radix ring (m = 2^a * q^b, q an odd prime; the program's
pad_to_N, drop_excluded, insert_excluded and fold_mod_phim): every device
operation that is none of the port's hand-written kernels, no GEMM
(launched by aten::mm, matmul, bmm, addmm or baddbmm) and not the key
rows' gather (launched by aten::index_select).  It reads the operations'
names, not the steps' spans, so it reads a program without them too.
None off the kernel's mixed-radix rings: on the dense family (no split),
on a power-of-two ring (N = phim) and on the matmul route (a GEMM in the
trace)."""
import re

from bench_port.readers import DENSE_OPS

HAND_WRITTEN = re.compile(
    r"\b(ct_mma_kernel|crt_pass_kernel|crt_kernel|lift_kernel"
    r"|tensor_product_kernel|keyswitch_dot_kernel|byte_decomp_kernel"
    r"|route_enter_kernel|route_leave_kernel)\b")
GATHER = "aten::index_select"


def read(r):
    split = r.step.split
    if (split is None or split[0] == r.step.phim or not r.trace.calls
            or any(o.op in DENSE_OPS for o in r.trace.ops)):
        return None
    us = sum(o.dur for o in r.trace.ops
             if o.op != GATHER and not HAND_WRITTEN.search(o.name))
    return us / r.trace.calls / 1e3
