"""The least time of the flash_attention calls, forward and backward, their
work from each call's shapes over the valid causal pairs, over the device
time of the kernels those calls launched, in percent. The least time of a
call is the larger of its bytes at the HBM rate and its operations at the
peak (``work``)."""


def read(run):
    t = run.trace
    if t is None or not t.device_s.get("flash_attention") or not t.bound_s.get("flash_attention"):
        return None
    return 100.0 * t.bound_s["flash_attention"] / t.device_s["flash_attention"]
