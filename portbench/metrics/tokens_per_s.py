"""Training tokens of every whole optimizer step in the window, over the
window's time (host clock, ended by one ``torch.cuda.synchronize()``)."""


def read(run):
    if run.trace is not None or not run.window_s:
        return None
    return run.steps * run.tokens_per_step / run.window_s
