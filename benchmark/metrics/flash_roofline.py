"""Share of the flash kernels' device time that the step's attention calls
need at least: the bound of every call the model makes (forward, and
backward where it trains) over the device seconds a step of the kernels that
``kernels/flash.json`` names."""

from benchmark import rooflines, trace


def read(r):
    dev = trace.family_seconds(r.trace, r.kernels["flash"]) / r.trace["steps"]
    if dev <= 0 or not r.calls["flash"]:
        return None
    return 100.0 * rooflines.bound_s(r.calls["flash"], r.peak) / dev
