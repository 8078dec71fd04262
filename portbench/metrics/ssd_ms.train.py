"""ssd_ms.train (ms, program span): device ms of the SSD in a training step,
by the program's ``ssd`` spans (``repro_torch.models.ssm.ssd``) in its
three phases: the forward, checkpoint's recompute and the backward (from
the SSD's output boundary to its input boundary, less a recompute that
autograd runs inside it), summed a step and averaged over the traced
window's steps."""

from portbench import program


def read(run):
    n = program.expected(run.config)
    return program.ms_a_unit(run, "ssd", {"forward": n["ssd"], "recompute": n["ssd_recomputed"],
                                          "backward": n["ssd"]})
