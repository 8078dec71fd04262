"""train_mfu (%, host clock): 3 x the forward's model FLOPs of each step
of the traced window (``portbench.flops.train_flops``; recomputation not
counted) over its seconds and the H100's bf16 peak."""

from portbench import flops


def read(run):
    tr = run.traffic
    work = flops.train_flops(run.config, tr["batch"], tr["seq_len"]) * run.units
    return 100.0 * work / (run.window_s * flops.PEAK_FLOPS)
