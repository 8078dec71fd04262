"""recompute_ms.train (ms, program span): device ms of remat's second
forward in a training step, by the program's ``block`` spans
(``models.transformer._train_block``) that checkpoint runs inside the
backward (phase ``recompute``: every layer after the prefix), summed a
step and averaged over the traced window's steps."""

from portbench import program


def read(run):
    n = program.expected(run.config)
    return program.ms_a_unit(run, "block", {"forward": n["layers"], "recompute": n["layers_recomputed"]},
                             phases=("recompute",))
