"""prefill_mfu (%, host clock): the model FLOPs of the traced window's
prefills (``portbench.flops.forward_flops``: parameter products, the
attended band, the SSD's recurrence) over its seconds and the H100's bf16
peak."""

from portbench import flops


def read(run):
    tr = run.traffic
    work = flops.forward_flops(run.config, tr["batch"], tr["seq_len"]) * run.units
    return 100.0 * work / (run.window_s * flops.PEAK_FLOPS)
