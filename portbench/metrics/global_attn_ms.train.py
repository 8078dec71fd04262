"""global_attn_ms.train (ms, program span): device ms of the global
attention layers' core in a training step, by the program's
``attn.global`` spans (``models.layers.attention``'s ``_masked_attention``
branch of a layer without a window) in the forward, the recompute and the
backward, summed a step and averaged over the traced window's steps."""

from portbench import program


def read(run):
    n = program.expected(run.config)
    return program.ms_a_unit(run, "attn.global", {"forward": n["global"], "recompute": n["global_recomputed"],
                                                  "backward": n["global"]})
