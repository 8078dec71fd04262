"""ssd_intra_ms.prefill (ms, program span): device ms of the SSD's
intra-chunk part in a prefill (C.B over each chunk, the float32 Q x Q
decay matrix of ``models.ssm._intra_chunk`` and its product with the
inputs), by the program's ``ssd.intra`` spans, summed a request and
averaged over the traced window's requests."""

from portbench import program


def read(run):
    return program.ms_a_unit(run, "ssd.intra", {"forward": program.expected(run.config)["ssd"]})
