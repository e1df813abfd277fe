"""Seconds from the process's start to the first timed step: imports, the
kernels loaded (or built), the state, weights and batches made, and the
checked first steps, which warm every shape of the cell."""


def read(run):
    return run.setup_s if run.trace is None else None
