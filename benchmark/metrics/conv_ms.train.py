"""Device milliseconds a train step in the convolution kernels that
``kernels/conv.json`` names (cuDNN's forward, data and weight gradients)."""

from benchmark import trace


def read(r):
    ms = 1e3 * trace.family_seconds(r.trace, r.kernels["conv"]) / r.trace["steps"]
    return ms if ms > 0 else None
