"""Share of a train step in which no operation runs on the device: one minus
the device's busy time a traced step over the untraced window's time a step.
(The traced window's own idle share, ``busy_s`` over ``window_s``, also holds
the profiler's host overhead, which a host-paced step feels in full.)"""


def read(r):
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["steps"] / r.step_s)
