"""Share of the GroupNorm kernels' device time that the step's GroupNorm
calls need at least (each bound by its bytes): the bound of every call the
step's models make over the device seconds a step of the kernels that
``kernels/groupnorm.json`` names."""

from benchmark import rooflines, trace


def read(r):
    dev = trace.family_seconds(r.trace, r.kernels["groupnorm"]) / r.trace["steps"]
    if dev <= 0 or not r.calls["groupnorm"]:
        return None
    return 100.0 * rooflines.bound_s(r.calls["groupnorm"], r.peak) / dev
