"""band_attn_roofline.prefill (%, program span): K5's bound
(``portbench.flops.k5_work`` at the cell's batch, sequence, heads and
window, bf16) over the device ms of a windowed attention call, by CUDA
events at the port's banded-attention entry (``layers.banded_attention``,
so the call's copies count), summed over the traced window's calls."""

from portbench import flops

SPANS = {"band_attn": "repro_torch.models.layers:banded_attention"}


def read(run):
    calls = run.spans.get("band_attn", [])
    windows = {layer.get("window") for layer in flops.layer_defs(run.config)} - {None}
    if not calls or len(windows) != 1:
        return None
    tr = run.traffic
    bound = flops.k5_bound_ms(run.config, tr["batch"], tr["seq_len"], windows.pop())
    return 100.0 * bound * len(calls) / sum(calls)
