"""global_attn_ms.prefill (ms, program span): device ms of the global
attention layers' core in a prefill, by the program's ``attn.global``
spans (``models.layers.attention``'s ``_masked_attention`` branch of a
layer without a window), summed a request and averaged over the traced
window's requests."""

from portbench import program


def read(run):
    return program.ms_a_unit(run, "attn.global", {"forward": program.expected(run.config)["global"]})
