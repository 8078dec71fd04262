"""train_tokens_per_s (tokens/s, host clock): the tokens of every step of
the window over the time from the window's start to its last completion."""

from portbench.traffic import tokens_per_unit


def read(run):
    return tokens_per_unit(run.traffic) * run.units / run.window_s
