"""``repro_torch.launch.dryrun``, ``dryrun_pdf`` and ``report``: the counting
mode on meta tensors against hand counts, the kernels charged by their work
models and never as their plain versions' operators, the affine-in-depth
counts the reference's extrapolation assumes, the records and the table
against the reference's ``repro.launch.report``. The reference's
``dryrun_pdf`` module sets XLA flags when imported, so its constants are
read from its source."""

import ast
import json
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from repro.launch import report as jreport
from repro_torch.configs import registry
from repro_torch.configs.base import BlockDef
from repro_torch.configs.shapes import SHAPES, ShapeDef
from repro_torch.core import distributions as dists
from repro_torch.kernels import _launch
from repro_torch.launch import dryrun, dryrun_pdf, report
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]


def granite(layers=2):
    return registry.get("granite-3-8b").reduced().replace(num_layers=layers)


def test_dense_prefill_flops_equal_a_hand_count():
    """Every matrix product of a reduced dense prefill, counted by hand."""
    cfg = granite()
    b, s = 2, 24
    rec = dryrun.run_cell(cfg, ShapeDef("t", "prefill", s, b), verbose=False)
    d, h, kv, hd, ff, v = cfg.d_model, cfg.q_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab
    t = b * s
    layer = (2 * t * d * h * hd + 2 * (2 * t * d * kv * hd)  # q, k, v
             + 2 * (2 * b * h * s * s * hd)  # scores and the weighted sum
             + 2 * t * h * hd * d  # wo
             + 3 * (2 * t * d * ff))  # gate, in, out
    want = cfg.num_layers * layer + 2 * b * d * v  # the last position's logits
    assert rec["flops_per_device"] == want
    assert rec["kernels"] == {} and rec["costs_extrapolated"] is False
    assert rec["model_flops"] == rl.model_flops_prefill(cfg, b, s)


def windowed_gemma3(block_local: bool):
    cfg = registry.get("gemma3-12b").reduced()
    pattern = tuple(BlockDef(mixer=bd.mixer, window=16 if bd.window else None, ffn=bd.ffn)
                    for bd in cfg.pattern)
    return cfg.replace(pattern=pattern, block_local_attn=block_local)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_k5_is_charged_by_its_work_model(kind):
    """A windowed layer on the banded path launches K5 on meta: charged
    k5_work's bytes and operations, not the plain path's products (a
    prefill's FLOPs drop by exactly those of the windowed layers' masked
    attention). Under autograd the backward is the blocked plain form,
    counted as the operators it is."""
    b, s = 2, 48
    banded, plain = (dryrun.run_cell(windowed_gemma3(bl), ShapeDef("t", kind, s, b), verbose=False)
                     for bl in (True, False))
    cfg = windowed_gemma3(True)
    local = sum(1 for bd in cfg.layer_defs() if bd.window)
    k5 = rl.k5_work(b, s, cfg.q_heads, cfg.kv_heads, cfg.head_dim, 16, cfg.compute_dtype)
    launches = local * (2 if cfg.remat == "full" else 1) if kind == "train" else local
    assert banded["kernels"] == {"banded_attention_kernel": dict(
        launches=launches, bytes=launches * k5.bytes, f32_ops=launches * k5.f32_ops, f64_ops=0,
        bf16_ops=0)}
    assert banded["f32_ops_per_device"] == launches * k5.f32_ops  # float32 compute: CUDA cores
    assert plain["kernels"] == {}
    if kind == "prefill":
        masked = local * 2 * (2 * b * cfg.q_heads * s * s * cfg.head_dim)
        assert banded["flops_per_device"] == plain["flops_per_device"] - masked


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_counts_are_affine_in_the_repeats(kind):
    """The counts at r = 2 and r = 4 repeats extrapolate affinely to the
    full-depth count, the assumption of the reference's extrapolation
    (which the port does not need: it counts every layer)."""
    cfg = granite(layers=7)
    shape = ShapeDef("t", kind, 16, 2)
    c = {r: dryrun.run_cell(dryrun.truncate_cfg(cfg, r), shape, verbose=False) for r in (2, 4)}
    full = dryrun.run_cell(cfg, shape, verbose=False)
    for key in ("flops_per_device", "bytes_per_device"):
        slope = (c[4][key] - c[2][key]) / 2.0
        assert c[2][key] + slope * (cfg.num_repeats - 2) == pytest.approx(full[key], rel=1e-12)


def test_argument_bytes_are_the_meta_tensors():
    cfg = granite()
    model = dryrun.meta_model(cfg)
    n = sum(p.numel() for p in model.parameters())
    rec = dryrun.run_cell(cfg, ShapeDef("t", "train", 16, 2), verbose=False)
    args = rec["memory_analysis"]["arguments"]
    assert args == {"params": 4 * n, "batch": 2 * 2 * 16 * 4, "optimizer": 2 * 4 * n + 4}
    assert rec["memory_analysis"]["argument_size_in_bytes"] == sum(args.values())
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0 and rec["memory_analysis"]["fits"]
    dec = dryrun.run_cell(cfg, ShapeDef("t", "decode", 32, 2), verbose=False)
    kv = cfg.num_layers * 2 * (2 * 32 * cfg.kv_heads * cfg.head_dim) * 4
    assert dec["memory_analysis"]["arguments"]["caches"] == kv


def test_optimizer_from_the_config():
    """Adafactor's factored state, AdamW's bf16 moments: the dry run's
    argument bytes are the port's own optimizer state on meta."""
    cfg = granite()
    model = dryrun.meta_model(cfg)
    n = sum(p.numel() for p in model.parameters())
    ada = dryrun.run_cell(cfg.replace(use_adafactor=True), ShapeDef("t", "train", 16, 2), verbose=False)
    assert 4 < ada["memory_analysis"]["arguments"]["optimizer"] < 4 * n
    bf16 = dryrun.run_cell(cfg.replace(adam_moments_bf16=True), ShapeDef("t", "train", 16, 2),
                           verbose=False)
    assert bf16["memory_analysis"]["arguments"]["optimizer"] == 2 * 2 * n + 4


def test_moe_dispatch_is_stated():
    cfg = registry.get("arctic-480b").reduced()
    rec = dryrun.run_cell(cfg, ShapeDef("t", "prefill", 160, 2), verbose=False)
    assert rec["moe_dispatch"] == dryrun.MOE_DISPATCH
    assert "moe_dispatch" not in dryrun.run_cell(granite(), ShapeDef("t", "prefill", 8, 2),
                                                 verbose=False)


def test_meshes_above_one_card_give_per_device_argument_bytes():
    """On 16x16 the record is the sharded step's, counted on one device:
    FLOPs, bytes and collective traffic a device, the collective term in
    its roofline, and the argument bytes of the local shards."""
    cfg = registry.get("granite-3-8b")
    rec = dryrun.run_cell(cfg, SHAPES["train_4k"], make_production_mesh(), verbose=False)
    assert rec["ok"] and "skipped" not in rec and rec["chips"] == 256
    one = rl.model_flops_train(cfg, 256 * 4096) / 256
    assert one <= rec["flops_per_device"] < 4 * one
    assert 0 < rec["bytes_per_device"] and 0 < rec["collective_traffic_per_device"]
    assert rec["collective_traffic_per_device"] == sum(rec["collective_traffic_by_op"].values())
    assert rec["terms_seconds"]["collective"] == rec["collective_traffic_per_device"] / rl.LINK_BW
    assert sum(rec["collective_ops"].values()) == sum(rec["comm_debug_counts"].values())
    args = rec["memory_analysis"]["arguments"]
    total = sum(p.numel() * 4 for p in dryrun.meta_model(cfg).parameters())
    assert total / 16 <= args["params"] < total
    assert args["batch"] == 256 * 4096 * 4 * 2 // 16


def test_op_bytes():
    m = dryrun.Meter()
    x = torch.empty((64, 32), device="meta")
    with m:
        y = x.t().reshape(64, 32)  # a copy (transpose, then reshape)
        assert m.bytes == 2 * x.numel() * 4
        x.view(32, 64)  # a view moves nothing
        assert m.bytes == 2 * x.numel() * 4
        x.to(torch.bfloat16)  # read f32, write bf16
        assert m.bytes == 2 * x.numel() * 4 + x.numel() * 6
        before = m.bytes
        y.copy_(x)  # read the source, write the destination
        assert m.bytes - before == 2 * x.numel() * 4
        before = m.bytes
        x + torch.empty((1, 32), device="meta").expand(64, 32)  # the broadcast row read once
        assert m.bytes - before == x.numel() * 4 + 32 * 4 + x.numel() * 4
        before = m.bytes
        x[torch.empty((5,), dtype=torch.long, device="meta")]  # gather 5 rows
        assert m.bytes - before == 5 * 8 + 2 * 5 * 32 * 4
    assert _launch.METERS == []


def test_temporaries_peak():
    m = dryrun.Meter()
    with m:
        a = torch.zeros((1024,), device="meta")
        b = torch.zeros((2048,), device="meta")
        del a
        c = torch.zeros((512,), device="meta")
        del b, c
    assert m.peak_bytes == 4 * (1024 + 2048) and m.live == 0


def test_cli_writes_records_and_skips_what_is_not_ported(tmp_path, monkeypatch):
    """Records for a flash-decode config and an SSM; only the reference's
    own skip (full attention at 500k) is left. On one card there is no
    mesh, so flash decode's cell is the plain decode's, as the reference's
    decode takes the plain path without one."""
    real = registry.get

    def get(name):
        cfg = real(name)
        return cfg.replace(flash_decode=True) if name == "granite-3-8b" else cfg

    monkeypatch.setattr(dryrun.registry, "get", get)
    for arch in ("granite-3-8b", "mamba2-780m"):
        dryrun.main(["--arch", arch, "--shape", "long_500k", "--out", str(tmp_path)])
        dryrun.main(["--arch", arch, "--shape", "decode_32k", "--out", str(tmp_path)])
    recs = {f.name: json.loads(f.read_text()) for f in tmp_path.glob("*.json")}
    assert set(recs) == {f"{a}__{s}__1x1.json" for a in ("granite-3-8b", "mamba2-780m")
                         for s in ("long_500k", "decode_32k")}
    assert recs["granite-3-8b__long_500k__1x1.json"]["reason"] == "skip(full-attn)"
    flash = recs["granite-3-8b__decode_32k__1x1.json"]
    assert flash["ok"] and flash["kernels"] == {}
    assert flash["flops_per_device"] == dryrun.run_cell(registry.get("granite-3-8b"),
                                                        SHAPES["decode_32k"],
                                                        verbose=False)["flops_per_device"]
    for s in ("long_500k", "decode_32k"):
        rec = recs[f"mamba2-780m__{s}__1x1.json"]
        assert rec["ok"] and rec["costs_extrapolated"] is False and rec["kernels"] == {}
    table = report.markdown_table(report.load_cells(tmp_path, "1x1"))
    assert table.count("\n") == 5 and "skip(full-attn)" in table and "not ported" not in table


def ref_constants() -> dict:
    """The module-level constants of ``repro/launch/dryrun_pdf.py``, read
    from its source (importing it sets XLA_FLAGS)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun_pdf.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_pdf_constants_equal_the_reference():
    ref = ref_constants()
    assert dryrun_pdf.PDF_SHAPES == ref["PDF_SHAPES"]
    assert dryrun_pdf.VARIANTS == ref["VARIANTS"]
    assert dryrun_pdf.NUM_BINS == ref["NUM_BINS"]
    assert dryrun_pdf.TYPES == dists.TYPES_4
    points, obs, t, L = 6656, 1000, 4, 20
    assert dryrun_pdf.model_flops(points, obs, t, L) == points * obs * (5.0 + 2.0) + points * t * L * 25.0


@pytest.mark.parametrize("shape", list(dryrun_pdf.PDF_SHAPES))
@pytest.mark.parametrize("variant", ["fused", "faithful", "fused_scatter"])
def test_pdf_records(variant, shape):
    rec = dryrun_pdf.run_pdf_cell(variant, shape, verbose=False)
    points, obs = dryrun_pdf.PDF_SHAPES[shape]
    assert rec["ok"] and (rec["points"], rec["obs"]) == (points, obs)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == points * obs * 4
    launches = {k: v["launches"] for k, v in rec["kernels"].items()}
    t, L = len(dryrun_pdf.TYPES), dryrun_pdf.NUM_BINS
    if variant == "fused":
        assert launches == {"moments_edges_stats": 1, "fit_error_counts": 1}
        k1, k2 = rl.k1_work(points, obs, L), rl.k2_work(points, obs, t, L)
        assert rec["f32_ops_per_device"] == k1.f32_ops + k2.f32_ops
        assert rec["bytes_per_device"] > k1.bytes + k2.bytes
    elif variant == "faithful":
        assert launches == {"moments_stats": 1, "hist_counts": t}
        assert rec["kernels"]["hist_counts"]["bytes"] == t * rl.k4_work(points, obs, L).bytes
    else:
        assert launches == {} and rec["f32_ops_per_device"] == 0
    assert rec["dominant"] == "memory"


@pytest.mark.parametrize("variant", dryrun_pdf.MESH_VARIANTS)
def test_pdf_mesh_variants_raise(variant):
    """The mesh variants run on the production mesh: one device's rows,
    the global grouping's all-gather of the (P, 2) int64 keys priced by
    the ring factor, no collective in the per-rank window step."""
    rec = dryrun_pdf.run_pdf_cell(variant, "window_small", verbose=False)
    points = dryrun_pdf.PDF_SHAPES["window_small"][0]
    assert rec["ok"] and rec["mesh"] == [16, 16] and rec["chips"] == 256
    assert rec["memory_analysis"]["argument_size_in_bytes"] == points // 256 * 1000 * 4
    if variant == "grouping_global":
        assert rec["collective_ops"] == {"all-gather": 1}
        assert rec["collective_traffic_per_device"] == rl.collective_traffic(
            "all-gather", points * 2 * 8, 256)
        assert set(rec["kernels"]) == {"moments_stats", "hist_counts"}
    else:
        assert rec["collective_ops"] == {} and rec["kernels"] == {}


def test_pdf_cli(tmp_path):
    dryrun_pdf.main(["--all", "--out", str(tmp_path)])
    recs = [json.loads(f.read_text()) for f in tmp_path.glob("*.json")]
    assert len(recs) == 15
    assert sum(r["ok"] for r in recs) == 15
    assert {r["variant"] for r in recs if r["mesh"] == [16, 16]} == set(dryrun_pdf.MESH_VARIANTS)


def fake_cells() -> dict:
    ok = dict(arch="gemma3-12b", shape="train_4k", ok=True, flops_per_device=1.5e15,
              bytes_per_device=3.2e12, collective_traffic_per_device=0.0, useful_ratio=0.71,
              roofline_fraction=0.123, dominant="memory",
              terms_seconds={"compute": 1.5, "memory": 0.95, "collective": 0.0},
              memory_analysis={"argument_size_in_bytes": 7e10, "temp_size_in_bytes": 2.5e9})
    small = dict(ok, shape="decode_32k", terms_seconds={"compute": 2e-4, "memory": 3e-3,
                                                         "collective": 0.0},
                 bytes_per_device=900.0, memory_analysis={"argument_size_in_bytes": 512})
    return {("gemma3-12b", "train_4k"): ok, ("gemma3-12b", "decode_32k"): small,
            ("granite-3-8b", "long_500k"): dict(arch="granite-3-8b", shape="long_500k", ok=False,
                                                skipped=True, reason="skip(full-attn)"),
            ("hymba-1.5b", "train_4k"): dict(arch="hymba-1.5b", shape="train_4k", ok=False,
                                             error="RuntimeError: boom")}


def test_report_table_equals_the_reference():
    cells = fake_cells()
    want = jreport.markdown_table(cells).replace("HLO GFLOPs/dev", "GFLOPs/dev")
    assert report.markdown_table(cells) == want
    for x in (None, 0.5, 2.0, 1e-4):
        assert report.fmt_s(x) == jreport.fmt_s(x)
    for x in (None, 12.0, 3e3, 4e6, 5e9, 6e12):
        assert report.fmt_b(x) == jreport.fmt_b(x)


def test_report_reads_the_records(tmp_path, capsys):
    for (arch, shape), rec in fake_cells().items():
        (tmp_path / f"{arch}__{shape}__1x1.json").write_text(json.dumps(rec))
        (tmp_path / f"{arch}__{shape}__16x16.json").write_text(json.dumps(rec))
    assert report.load_cells(tmp_path, "1x1") == fake_cells()
    assert report.main(["--dir", str(tmp_path)]) == (2, 1, 1)
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "cells: 2 ok, 1 skipped-by-design, 1 failed"
    opt = tmp_path / "opt"
    opt.mkdir()
    for (arch, shape), rec in fake_cells().items():
        (opt / f"{arch}__{shape}__1x1__opt.json").write_text(json.dumps(rec))
    assert report.compare_tables(tmp_path, opt) == jreport.compare_tables(tmp_path, opt, "1x1")
