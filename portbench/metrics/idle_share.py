"""The share of the traced window in which no kernel ran on the device: one
minus the union of the kernels' intervals over the window, in percent."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
