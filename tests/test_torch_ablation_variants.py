"""The ablation tools' variants (``kernels/{fitpdf,moments,band_attn}/ablation.py``)
quote statements of ``csrc/`` word for word; an edit of the kernels'
sources that changes a quoted statement, comments included, breaks the
tool before anything builds. Each quoted statement is held here to the
source it edits, and every variant is written out as the tool writes it."""

import importlib

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _ablation, _build  # noqa: E402

TOOLS = ("fitpdf", "moments", "band_attn")
VARIANTS = {tool: importlib.import_module(f"repro_torch.kernels.{tool}.ablation").VARIANTS
            for tool in TOOLS}
EDITS = [(tool, name, i, fname, old)
         for tool, variants in VARIANTS.items()
         for name, edits in variants.items()
         for i, (fname, old, _) in enumerate(edits)]


@pytest.mark.parametrize("tool, variant, i, fname, statement", EDITS,
                         ids=[f"{t}-{v}-{i}" for t, v, i, _, _ in EDITS])
def test_variant_statement_is_in_its_source_once(tool, variant, i, fname, statement):
    text = (_build.CSRC / fname).read_text()
    assert text.count(statement) == 1, (
        f"{tool} ablation, variant {variant}: edit {i} quotes a statement of {fname} "
        f"that occurs {text.count(statement)} times: {statement!r}")


@pytest.mark.parametrize("tool", TOOLS)
def test_every_variant_is_written(tool, tmp_path):
    for name, edits in VARIANTS[tool].items():
        d = _ablation._write_variant(name, edits, tmp_path)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            assert new in text and (old in new or old not in text), (name, fname)
