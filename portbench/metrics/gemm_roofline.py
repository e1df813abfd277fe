"""The least time of the products (aten mm, addmm, bmm, baddbmm), their work
from the shapes of one step's product ops counted under a dispatch mode,
over the device time of the kernels those ops launched, in percent. The
least time of a call is the larger of its bytes at the HBM rate and its
operations at the peak (``work``)."""


def read(run):
    t = run.trace
    if t is None or not t.device_s.get("gemm") or not t.bound_s.get("gemm"):
        return None
    return 100.0 * t.bound_s["gemm"] / t.device_s["gemm"]
