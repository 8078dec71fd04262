"""prefill_tokens_per_s (tokens/s, host clock): the prompt tokens of every
prefill of the window over the window's seconds, from its first issue to
its last completion."""

from portbench.traffic import tokens_per_unit


def read(run):
    return tokens_per_unit(run.traffic) * run.units / run.window_s
