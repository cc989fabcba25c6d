"""Share of the flash kernels' device time that MAISI's step's 22 multi-head
attention calls at head dim 32 need at least (11 forward, 11 backward: 8
heads over 32768 tokens, 16 heads over 4096): their bound over the device
seconds a step of the kernels that ``kernels/flash.json`` names; the formula
of ``flash_roofline``."""

from benchmark import rooflines, trace


def read(r):
    dev = trace.family_seconds(r.trace, r.kernels["flash"]) / r.trace["steps"]
    if dev <= 0 or not r.calls["flash"]:
        return None
    return 100.0 * rooflines.bound_s(r.calls["flash"], r.peak) / dev
