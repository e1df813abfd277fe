"""``torch.cuda.max_memory_allocated()`` over the traced window, after
``reset_peak_memory_stats()``, in GiB."""


def read(run):
    t = run.trace
    if t is None or not t.peak_bytes:
        return None
    return t.peak_bytes / 2 ** 30
