"""Device ms per call of every operation that none of the program's
fhe.* spans tags and no GEMM (aten::mm, matmul, bmm, addmm, baddbmm)
launched (by_span.plain_ms): the key rows' gather, the dense transform's
float64 conversions, any plain step around the hand-written kernels.
None where no operation carries a tag."""
from bench_port.by_span import plain_ms as read  # noqa: F401
