"""A run driven on the CPU at tiny widths (everything but the look for a
card), with the timed path broken underneath, comes out not correct: for
each fault a cell of its kind can have. A prefill cell: an answer altered
where it is produced (the prompts' logits swapped), half of the batch left
out (its answers copied from the other half). A training cell: a step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest. No cell runs across chips, so no cell has an
exchange between chips to leave out. Each is held against the sound run,
which comes out correct. The tiny cells compute in float32: the limits are
set for the cells' bfloat16 at full size, where rounding averages over far
more terms than at these widths."""

import pytest
import torch

from portbench import run
from portbench.tests.helpers import tiny

CPU = torch.device("cpu")
SEED = 3_000_000_017


def _result(cell):
    return run.execute(tiny(cell, compute_dtype="float32"), SEED, 0.3, False, CPU)


def _swap_answers(monkeypatch):
    from repro_torch.models import transformer as T

    real = T._logits
    monkeypatch.setattr(T, "_logits", lambda params, h, cfg: real(params, h, cfg).roll(1, 0))


def _half_prompts(monkeypatch):
    from repro_torch.models import transformer as T

    real = T.prefill

    def half(params, tokens, cfg, extras=None, max_len=None):
        logits, caches = real(params, tokens[: tokens.shape[0] // 2], cfg, extras, max_len)
        return torch.cat([logits, logits]), caches

    monkeypatch.setattr(T, "prefill", half)


def _state_unchanged(monkeypatch):
    from repro_torch.launch import train
    from repro_torch.optim import global_norm

    monkeypatch.setattr(train, "adamw_update",
                        lambda grads, state, params, cfg, lr_scale=1.0: (params, state,
                                                                         global_norm(grads.values())))


def _half_batch(monkeypatch):
    from repro_torch.launch import train

    real = train.loss_of

    def half(model, batch, cfg):
        return real(model, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, cfg)

    monkeypatch.setattr(train, "loss_of", half)


PREFILL_FAULTS = {"answer_altered": _swap_answers, "half_batch": _half_prompts}
TRAIN_FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}


@pytest.mark.parametrize("cell", ["mamba2-prefill-4k", "hymba-prefill-4k", "hymba-train-4k",
                                  "mamba2-train-4k"])
def test_sound_run_is_correct(cell):
    res = _result(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["mamba2-prefill-4k", "hymba-prefill-4k"])
@pytest.mark.parametrize("fault", sorted(PREFILL_FAULTS))
def test_prefill_fault_is_caught(cell, fault, monkeypatch):
    PREFILL_FAULTS[fault](monkeypatch)
    res = _result(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["hymba-train-4k", "mamba2-train-4k"])
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_caught(cell, fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    res = _result(cell)
    assert not res["correct"], res["checks"]
