"""The dry run above 1x1 (``launch/dryrun.py``, ``dryrun_pdf.py``): the
sharded step on meta tensors in a fake world of the mesh's size, one
device's FLOPs, bytes and collectives.

On one reduced cell (granite's ``reduced()``) at 1x4 and 2x2: the argument
bytes a device equal ``per_device_bytes`` of the placements and the local
shards' bytes; the counts scale with the shards; the collectives the meter
prices are those ``CommDebugMode`` sees; and one tensor-parallel block of
the same cell communicates what a hand count says. Which operators the
two partitioners choose (DTensor's here, XLA's SPMD in the reference) is
compared in PERF.md, not asserted: they choose differently. The reduced
MoE configs' cells count on 2x2 with the dispatch's bound stated, and a
rank's expert products split with the experts over ``model``."""

import contextlib

import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeDef, input_specs
from repro_torch.launch import dryrun, dryrun_pdf, report
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as rl
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh

MESHES = [(1, 4), (2, 2)]
B, S = 4, 32


def cfg():
    return registry.get("granite-3-8b").reduced()


@pytest.fixture(scope="module")
def records():
    out = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeDef("t", kind, S, B)
        out[(kind, (1, 1))] = dryrun.run_cell(cfg(), shape, verbose=False)
        for m in MESHES:
            out[(kind, m)] = dryrun.run_cell(cfg(), shape, M.make_mesh(m, ("data", "model")),
                                             verbose=False)
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_argument_bytes_are_the_local_shards(records, kind, shape):
    """Each argument's bytes a device equal ``per_device_bytes`` of its
    placements: the parameters by ``make_pspecs``, the moments as their
    parameters, the batch and caches by ``input_specs``."""
    rec = records[(kind, shape)]
    mesh = M.make_mesh(shape, ("data", "model"))
    model = dryrun.meta_model(cfg())
    pspecs = sh.make_pspecs(cfg(), mesh, model)
    args = rec["memory_analysis"]["arguments"]
    assert args["params"] == sh.per_device_bytes(model, pspecs, mesh)
    batch, specs = input_specs(cfg(), ShapeDef("t", kind, S, B), mesh)
    rest = {k: v for k, v in batch.items() if k != "caches"}
    assert args["batch"] == sum(sh.per_device_bytes(v, specs[k], mesh) for k, v in rest.items())
    if kind == "train":
        assert args["optimizer"] == 4 + 2 * args["params"]  # the int32 step, mu and nu
    if kind == "decode":
        assert args["caches"] == sh.per_device_bytes(batch["caches"], specs["caches"], mesh)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == sum(args.values())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_counts_split_with_the_shards(records, kind):
    """Data parallel halves the products (the batch splits), tensor
    parallel too (heads and the FFN split, the residual stream whole
    between layers), in the forward and the backward alike; the collective
    term prices the
    traffic a device at the link rate, and the meter saw every collective
    CommDebugMode saw."""
    one = records[(kind, (1, 1))]
    for shape in MESHES:
        rec = records[(kind, shape)]
        assert rec["ok"] and rec["chips"] == 4 and rec["costs_extrapolated"] is False
        assert rec["flops_per_device"] < one["flops_per_device"]
        assert sum(rec["collective_ops"].values()) == sum(rec["comm_debug_counts"].values()) > 0
        assert rec["collective_traffic_per_device"] == pytest.approx(
            sum(rec["collective_traffic_by_op"].values()))
        assert rec["terms_seconds"]["collective"] == pytest.approx(
            rec["collective_traffic_per_device"] / rl.LINK_BW)
    # The batch over data, heads and FFN over model, the backward's
    # products as the forward's (the residual stream's gradient reduced
    # between layers, the attention core on each rank's heads): exactly a
    # quarter at 2x2. At 1x4 the cell's 2 KV heads do not divide the model
    # axis (make_pspecs keeps wk and wv whole there). Each rank projects
    # only the KV head its one query head reads (sharding.own_kv_heads): 1
    # of the 2, in training's forward and backward (dx and dW) a quarter
    # plus 1/4 of the K and V products. A prefill also builds its block of
    # the cache's sequence with every KV head (layers.own_cache: a quarter
    # of the products more); a decode step projects every KV head of the
    # new token (a quarter plus 3/4).
    quarter = one["flops_per_device"] / 4
    assert records[(kind, (2, 2))]["flops_per_device"] == quarter
    c = cfg()
    tokens = B * (1 if kind == "decode" else S)
    kv_products = c.num_layers * 2 * 2 * tokens * c.d_model * c.kv_heads * c.head_dim
    own = len({h // (c.q_heads // c.kv_heads) for h in range(c.q_heads // 4)})  # rank 0's: 1 of 2
    share = {"train": (own * 4 - c.kv_heads, 4 * c.kv_heads), "prefill": (own, c.kv_heads),
             "decode": (3, 4)}[kind]  # the rank's share of the products less the quarter
    kv_term = kv_products * (3 if kind == "train" else 1) * share[0] // share[1]
    assert records[(kind, (1, 4))]["flops_per_device"] == quarter + kv_term


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_whole_heads_and_vocabulary_split_rows_over_model(kind):
    """A reduced granite with 6 query heads and a vocabulary of 510 at 1x4:
    neither divides the model axis, so the attention's weights and the LM
    head are whole there (the reference's placements); each model rank
    takes its own rows of the attention block and of the training loss's
    head (``sharding.rows_over_model``), and the cell's FLOPs a device are
    exactly a quarter of one card's, the K and V projections' included; a
    prefill's last-position logits (B rows) stay whole on each rank, 3/4
    of their head product over the quarter."""
    c = cfg().replace(q_heads=6, kv_heads=2, vocab=510)
    shape = ShapeDef("t", kind, S, B)
    one = dryrun.run_cell(c, shape, verbose=False)
    rec = dryrun.run_cell(c, shape, M.make_mesh((1, 4), ("data", "model")), verbose=False)
    head = 0 if kind == "train" else 2 * B * c.d_model * c.vocab * 3 // 4
    assert rec["flops_per_device"] * 4 == one["flops_per_device"] + 4 * head


def tp_block_counts(shape, block):
    """(forward, backward) collectives of layer 0's ``block`` ("mlp" or
    "attn") of the cell's model placed on ``shape``: x split over data
    only, the output brought back to x's placement, the backward's dx too."""
    from torch.distributed.tensor.debug import CommDebugMode

    c = cfg()
    with M.fake_world(4):
        dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
        model = dryrun.meta_model(c).requires_grad_(True)
        sh.distribute_params(c, dm, model)
        rows = sh.batch_sharding(dm, 3)
        x = sh.place(torch.empty((B, S, c.d_model), device="meta"), rows).requires_grad_(True)
        pos = torch.arange(S, device="meta").expand(B, S)
        p = model.layers[0]
        with sh.implicit_replication(), CommDebugMode() as fwd:
            if block == "mlp":
                y = L.mlp(p.mlp, x, c)
            else:
                y = L.attention(p.attn, x, cfg=c, positions=pos)
            y = y.redistribute(dm, rows.placements)
        with sh.implicit_replication(), CommDebugMode() as bwd:
            (g,) = torch.autograd.grad(y.sum(), x)
            g.redistribute(dm, rows.placements)

    def named(comm):
        return {str(op).split(".")[-1]: n for op, n in comm.get_comm_counts().items()}

    return named(fwd), named(bwd)


@pytest.mark.parametrize("block", ["mlp", "attn"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_block_collectives_equal_a_hand_count(shape, block):
    """Megatron's count for a tensor-parallel block: the row-parallel
    output (``wo``, ``w_out``) is a partial sum, one all-reduce forward;
    the column-parallel inputs (``wq``/``wk``/``wv``, ``w_gate``/``w_in``)
    give dx as a partial sum, one all-reduce backward. The cell has 2 KV
    heads: on a 4-way model axis they do not divide, so wk and wv are
    whole there and each rank projects only the KV head its query head
    reads (``sharding.own_kv_heads``): their dx joins the same partial sum,
    and nothing else moves; on 2x2 they divide."""
    fwd, bwd = tp_block_counts(shape, block)
    assert fwd == {"all_reduce": 1}
    assert bwd == {"all_reduce": 1}


def test_cli_writes_mesh_records_and_the_report_reads_them(tmp_path):
    dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k", "--mesh", "2x2", "--out",
                 str(tmp_path)])
    cells = report.load_cells(tmp_path, "2x2")
    rec = cells[("mamba2-780m", "long_500k")]
    assert rec["ok"] and rec["mesh"] == [2, 2] and rec["collective_ops"]
    assert "mamba2-780m" in report.markdown_table(cells)


def test_pdf_mesh_variant_on_a_small_mesh():
    """``grouping_global`` on 2x2: every rank's keys all-gathered once over
    the world; a quarter of the rows a device."""
    mesh = M.make_mesh((2, 2), ("data", "model"))
    rec = dryrun_pdf.run_pdf_cell("grouping_global", "window_small", verbose=False, mesh=mesh)
    points = dryrun_pdf.PDF_SHAPES["window_small"][0]
    assert rec["mesh"] == [2, 2] and rec["collective_ops"] == {"all-gather": 1}
    assert rec["comm_debug_counts"] == {"c10d.allgather_": 1}
    assert rec["collective_traffic_per_device"] == points * 2 * 8 * 3 / 4
    one = dryrun_pdf.run_pdf_cell("faithful", "window_small", verbose=False)
    assert rec["kernels"]["hist_counts"]["bytes"] * 4 == one["kernels"]["hist_counts"]["bytes"]


# -- the MoE on a mesh -----------------------------------------------------------------

MOE_ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cells_count_on_a_small_mesh(arch, kind):
    """The reduced MoE configs' cells on 2x2: ok, the dispatch's bound
    stated, each collective the meter priced one CommDebugMode saw, fewer
    FLOPs a device than on one card."""
    c = registry.get(arch).reduced()
    shape = ShapeDef("t", kind, S, B)
    rec = dryrun.run_cell(c, shape, M.make_mesh((2, 2), ("data", "model")), verbose=False)
    assert rec["ok"] and rec["chips"] == 4
    assert rec["moe_dispatch"] == dryrun.MOE_DISPATCH
    assert sum(rec["collective_ops"].values()) == sum(rec["comm_debug_counts"].values()) > 0
    assert rec["flops_per_device"] < dryrun.run_cell(c, shape, verbose=False)["flops_per_device"]


class ExpertMeter(dryrun.LocalMeter):
    """``LocalMeter`` that also keeps the ``bmm`` FLOPs apart."""

    def __init__(self):
        super().__init__()
        self.bmm_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func is torch.ops.aten.bmm.default:
            self.bmm_flops += self.flops - before
        return out


def expert_bmm_flops(shape, b, s) -> int:
    """A rank's expert ``bmm`` FLOPs in reduced arctic's first MoE layer on
    meta, x (b, s, d) split as a batch: one card without a world, else rank
    0 of a fake world of the mesh."""
    c = registry.get("arctic-480b").reduced()
    n = shape[0] * shape[1]
    with M.fake_world(n) if n > 1 else contextlib.nullcontext():
        model = dryrun.meta_model(c)
        x = torch.empty((b, s, c.d_model), device="meta")
        if n > 1:
            dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
            sh.distribute_params(c, dm, model)
            x = sh.place(x, sh.batch_sharding(dm, 3))
        with sh.implicit_replication(), torch.no_grad(), ExpertMeter() as meter:
            L.moe(model.layers[0].moe, x, c)
    return meter.bmm_flops


def test_expert_products_split_over_the_model_axis():
    """The all-kept bound by hand: one card runs the three products over
    the (E, C, d) buffer, 3 x 2 E C d f FLOPs; at 1x4 a rank holds E / 4
    experts and every token (min(C, T k) = C rows), a quarter; at 2x2 it
    holds E / 2 experts and min(C, T k / 2) = C rows, a half (the bound
    cannot see that a data shard keeps about C / 2 of an expert's choices:
    PERF.md section 7)."""
    c = registry.get("arctic-480b").reduced()
    b, s = 2, 160  # T = 320 > 256: C = int(k T / E x 1.25) = 100
    cap = L.moe_capacity(b * s, c.num_experts, c.moe_top_k)
    one = expert_bmm_flops((1, 1), b, s)
    assert one == 3 * 2 * c.num_experts * cap * c.d_model * c.d_ff
    assert expert_bmm_flops((1, 4), b, s) * 4 == one
    assert expert_bmm_flops((2, 2), b, s) * 2 == one
