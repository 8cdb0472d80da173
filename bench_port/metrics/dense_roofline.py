"""The step's float64 transform products on a dense ring: their FP64
bound (roofline.Step.dense_ms) over the device time of the kernels that
aten::mm, matmul, bmm, addmm or baddbmm launched, per call."""
from bench_port.readers import dense_roofline as read  # noqa: F401
