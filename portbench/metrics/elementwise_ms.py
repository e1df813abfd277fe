"""Device milliseconds per optimizer step in kernels that are neither a
product nor one of the port's kernel calls: PyTorch's own elementwise,
reduction and copy kernels (the models' glue and AdamW)."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    return 1e3 * t.device_s.get("other", 0.0) / t.steps
