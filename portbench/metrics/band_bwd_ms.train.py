"""band_bwd_ms.train (ms, program span): device ms of K5's backward
(``kernels.band_attn.ops.banded_attention_backward``) in a training step,
by CUDA events around each call, summed a step and averaged over the
traced window's steps."""

SPANS = {"band_bwd": "repro_torch.kernels.band_attn.ops:banded_attention_backward"}


def read(run):
    calls = run.spans.get("band_bwd", [])
    if not calls or not run.units:
        return None
    return sum(calls) / run.units
