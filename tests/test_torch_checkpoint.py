"""The port's checkpoints (``repro_torch.checkpoint``): the cases of
``tests/test_checkpoint.py`` over the port's state (dicts of tensors and an
``OptState``), the async save's snapshot of parameters the trainer updates
in place, and a resumed training run bitwise equal to an uninterrupted one.
Runs on the CPU; imports no JAX."""

import json
import shutil
import time

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.launch import train
from repro_torch.optim import OptState


def _tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4),
                   "h": torch.linspace(-2, 2, 6).to(torch.bfloat16)},
        "opt": OptState(torch.tensor(3, dtype=torch.int32), {"w": torch.zeros(2)},
                        {"w": torch.full((2, 2), 7.0)}),
        "extra": [np.arange(3), 2.5],
    }


def _leaves(tree):
    return ckpt_manager._flatten(tree)[0]


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(tmp_path / "ck", t, step=5, extra={"note": "hi"})
    restored, manifest = restore_pytree(tmp_path / "ck", t)
    assert manifest["step"] == 5
    assert manifest["extra"]["note"] == "hi"
    assert manifest["num_leaves"] == 8 and "bfloat16" in manifest["dtypes"]
    assert isinstance(restored["opt"], OptState) and isinstance(restored["extra"], list)
    assert list(restored["params"]) == ["w", "b", "h"]
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert _equal(a, torch.as_tensor(b) if not isinstance(a, torch.Tensor) else b)


def test_structure_mismatch_raises(tmp_path):
    save_pytree(tmp_path / "ck", _tree(), step=1)
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree(tmp_path / "ck", {"just": torch.zeros(1)})
    wrong = _tree()
    wrong["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(tmp_path / "ck", wrong)


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in [10, 20, 30]:
        mgr.save(step, _tree())
    assert mgr.latest_step() == 30
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000020", "step_00000030"]


def test_manager_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), async_=True)
    mgr.wait()
    restored, manifest = mgr.restore_latest(_tree())
    assert manifest["step"] == 1


def test_crash_mid_save_keeps_previous(tmp_path):
    """A stale .tmp dir (a crashed save) must not shadow the good one."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    bad = tmp_path / "step_00000002.tmp"
    bad.mkdir()
    (bad / "leaves.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    restored, manifest = mgr.restore_latest(_tree())
    assert manifest["step"] == 1


def test_restore_empty_returns_none(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree, manifest = mgr.restore_latest(_tree())
    assert tree is None and manifest is None


def test_async_save_snapshots_before_an_in_place_step(tmp_path, monkeypatch):
    """Save async, update the parameters in place (as the trainer's step
    does), wait, restore: the pre-step values. On the CPU ``tensor.cpu()``
    and ``.numpy()`` alias the live tensor, so a snapshot that kept them
    would write the step's values; the write is held back here until the
    step has run."""
    real = ckpt_manager._write
    monkeypatch.setattr(ckpt_manager, "_write", lambda *a: (time.sleep(0.3), real(*a)))
    model = torch.nn.Linear(4, 3)
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": params}, async_=True)
    with torch.no_grad():
        for p in params.values():
            p.add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore_latest({"params": params})
    for n in params:
        assert torch.equal(restored["params"][n], before[n]), n
        assert not torch.equal(params[n], before[n])


def _ckpt_arrays(path):
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "leaves.npz")
    return manifest, [data[f"l{i}"] for i in range(manifest["num_leaves"])]


@pytest.mark.parametrize("arch", ["granite-3-8b", "seamless-m4t-medium"])
def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, arch, capsys):
    """6 steps straight (a checkpoint after 3, async, and at the end) equal
    3 steps + save + restore + 3 steps bitwise: parameters, both moments,
    the step and the pipeline's cursor (the enc-dec's frames are seeded by
    the step)."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "8",
            "--ckpt-every", "3", "--ckpt-dir", str(tmp_path), "--lr", "1e-3"]
    train.main(args)
    straight = _ckpt_arrays(tmp_path / "step_00000006")
    shutil.rmtree(tmp_path / "step_00000006")
    assert CheckpointManager(tmp_path).latest_step() == 3
    train.main(args + ["--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    resumed = _ckpt_arrays(tmp_path / "step_00000006")
    assert straight[0] == resumed[0]
    assert straight[0]["extra"]["pipeline"] == {"step": 6, "seed": 0}
    for a, b in zip(straight[1], resumed[1]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_train_lm_example_on_cpu(tmp_path, capsys):
    """examples/train_lm_torch.py's flow at a small size on the CPU: the
    loss falls, the resumed run ends on the uninterrupted run's bits."""
    import runpy
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"
    nums = runpy.run_path(str(path))["run"]("granite-3-8b", 30, 4, 32, torch.device("cpu"), tmp_path)
    assert nums["resumed_bitwise"] and nums["resumed_from"] == 15
    assert nums["final_loss"] < nums["first_loss"]
    assert np.isfinite(nums["loss_after_10_more"])
    assert "resumed from step 30" in capsys.readouterr().out
