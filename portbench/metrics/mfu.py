"""The model's products per optimizer step (``work.model_flops_per_step``:
one forward and its backward, no recompute) over the step's time and the
card's bf16 peak, in percent. The step's time is the mean over the traced
run's ``trace_steps`` steps timed without the profiler (host clock, ended by
a synchronize)."""
from portbench import work


def read(run):
    if not run.step_s:
        return None
    t = run.traffic
    flops = work.model_flops_per_step(run.model, t["micro_batch"], t["seq"], t["accum_steps"])
    return 100.0 * flops / (run.step_s * work.PEAK_BF16)
