"""device_idle.train (%, device trace): the share of a step's time in the
measured window in which nothing ran on the device. A step's busy time is
the union of the device's intervals (kernels, copies, sets) in the
profiler's trace of the steps after the window, over those steps; a
step's time is the unprofiled window's length over its steps. So the
profiler's own host cost a launch, which the traced steps carry, does not
count as idle."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.units:
        return None
    busy = t.busy_s / run.traffic["profile_units"]
    return 100.0 * (1.0 - busy / (run.window_s / run.units))
