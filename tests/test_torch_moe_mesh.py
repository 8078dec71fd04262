"""The MoE on a mesh: ``models.layers.moe``, ``moe_route`` and
``moe_aux_loss`` on DTensors (``sharding.local_experts``), in gloo worlds
on the CPU at 1x1, 2x2 and 1x4, on the reduced arctic-480b and kimi-k2-1t
(8 experts, top-2) in float32.

The reference's ``moe`` is jitted over the global batch: the capacity
comes from all B S tokens and a choice's position counts every earlier
choice of its expert in token-major order. The sharded layer must keep
exactly that set (``reference_kept``), which ``CASES`` (drops engaged by a
shared direction past 256 tokens and at factor 1.0) and ``hot`` hold: in
``hot`` batch row 1, the second data shard at 2x2, fills an expert that
row 0 already uses, so a capacity or positions counted a shard would keep
choices the reference drops. Outputs within the reference's prefill
tolerance of the reference and of the one-device port, bitwise the
one-device port at 1x1. Each rank's expert buffer has as many rows as the
largest kept count among its slab's experts from its own tokens.

The reduced models also train one AdamW step (the CE plus the aux loss)
with drops engaged, against the port's one-device step within the
sharded-train tolerances (``tests/test_torch_sharded_train.py``), bitwise
at 1x1; on 2x2 they prefill and decode 3 steps within the decode
oracle's tolerance of the one-device port, and the trainer's ``--mesh
2x2`` trains reduced arctic as on one device. ~90 s on 8 CPU cores."""

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as M
from test_torch_moe import CASES, DECODE_TOL, MOE_ARCHS, PREFILL_TOL, _x, reference_kept
from test_torch_sharded_train import LOSS_TOL, STEP_TOL

TIMEOUT = 300
WORLDS = {1: [(1, 1)], 4: [(2, 2), (1, 4)]}
LAYER_CASES = dict(CASES, hot=(2, 160, None))
STACKS = ("w_gate", "w_in", "w_out")
HOT_EXPERT, HOT_ROW0 = 3, 60  # row 0: its first 60 tokens pick the hot expert; row 1: all 160
TRAIN_BATCH, TRAIN_SEQ, TRAIN_VOCAB_USED = 4, 80, 6  # T = 320 > 256, few distinct tokens: drops
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = 2, 160, 3


def _hot_x(router: np.ndarray, d: int) -> np.ndarray:
    """``_x`` with row 0's first HOT_ROW0 tokens and every token of row 1
    along HOT_EXPERT's router column (its top choice for them)."""
    b, s, _ = LAYER_CASES["hot"]
    x = _x((b, s, d), seed=11)
    col = router[:, HOT_EXPERT] / np.linalg.norm(router[:, HOT_EXPERT])
    x[0, :HOT_ROW0] += 8 * col
    x[1] += 8 * col
    return x.astype(np.float32)


def shard_kept(idx: np.ndarray, cap_of, shards: int) -> np.ndarray:
    """The kept mask a dispatch counted on each of ``shards`` batch shards
    alone would give: positions among the shard's own choices, capacity
    ``cap_of(tokens of the shard)``."""
    t, k = idx.shape
    per = t // shards
    keep = np.zeros((t, k), bool)
    for s in range(shards):
        seen: dict = {}
        for row in range(s * per, (s + 1) * per):
            for j in range(k):
                e = int(idx[row, j])
                keep[row, j] = seen.get(e, 0) < cap_of(per)
                seen[e] = seen.get(e, 0) + 1
    return keep


def reference_grads(jp, x, jcfg, factor, seed) -> list:
    """``layer_grads`` of the reference's ``moe``: the gradients of <y, c>
    with respect to x and the expert stacks, as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL

    c = jnp.asarray(np.random.default_rng(seed).normal(size=x.shape).astype(np.float32))

    def inner(xx, *stacks):
        q = {**jp, **dict(zip(STACKS, stacks))}
        return jnp.sum(JL.moe(q, xx, jcfg, capacity_factor=factor) * c)

    grads = jax.grad(inner, argnums=(0, 1, 2, 3))(jnp.asarray(x), *(jp[n] for n in STACKS))
    return [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's weights (numpy), the port's config, each
    layer case's input, the reference's experts, kept set and output."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro_torch.models import layers as L
    from test_torch_lm import port_cfg

    out = {}
    for arch in MOE_ARCHS:
        jcfg = jregistry.get(arch).reduced()
        tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
        jp = jax.tree.map(lambda a: a[0], tree["groups"][0]["moe"])
        cases = {}
        for name, (b, s, factor) in LAYER_CASES.items():
            x = _hot_x(jp["router"], jcfg.d_model) if name == "hot" else _x((b, s, jcfg.d_model), seed=s)
            cap = L.moe_capacity(b * s, jcfg.num_experts, jcfg.moe_top_k, factor)
            idx, keep = reference_kept(jp, x, jcfg, cap)
            jpj = jax.tree.map(jnp.asarray, jp)
            y = np.asarray(JL.moe(jpj, jnp.asarray(x), jcfg, capacity_factor=factor))
            cases[name] = dict(x=x, factor=factor, cap=cap, idx=idx, keep=keep, y=y,
                               grads=reference_grads(jpj, x, jcfg, factor, len(name)))
        out[arch] = dict(tree=tree, cfg=port_cfg(jcfg), cases=cases)
    return out


# -- one rank's work ------------------------------------------------------------------


class BmmShapes(TorchDispatchMode):
    """Records the first operand's shape of every ``bmm`` a rank runs on its
    plain tensors (DTensor operators are handed on to DTensor), and each
    collective's name and first tensor operand's shape."""

    def __init__(self):
        super().__init__()
        self.shapes = []
        self.collectives = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops.aten.bmm.default:
            self.shapes.append(tuple(args[0].shape))
        if func.namespace in ("_c10d_functional", "c10d") and not func.__name__.startswith(("_", "wait")):
            first = next((a for a in args if isinstance(a, torch.Tensor)), None)
            if first is not None:
                self.collectives.append((func.__name__, tuple(first.shape)))
        return func(*args, **(kwargs or {}))


def _whole(t):
    from repro_torch.models import sharding as sh

    return (t.full_tensor() if sh.is_dtensor(t) else t).detach().clone()


def layer_grads(p, x, cfg, factor, seed):
    """The gradients of <y, c> (c a fixed normal cotangent) with respect to
    x and the expert stacks, whole."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    c = torch.from_numpy(np.random.default_rng(seed).normal(size=tuple(x.shape)).astype(np.float32))
    if sh.is_dtensor(x):
        c = sh.place(c, sh.batch_sharding(x.device_mesh, 3))
    x = x.detach().requires_grad_(True)
    stacks = [getattr(p, n) for n in ("w_gate", "w_in", "w_out")]
    for w in stacks:
        w.requires_grad_(True)
    grads = torch.autograd.grad((L.moe(p, x, cfg, factor) * c).sum(), [x] + stacks)
    for w in stacks:
        w.requires_grad_(False)
    return [_whole(g) for g in grads]


def layer_cases(tree, cfg, cases, dmesh):
    """Every layer case on the first MoE layer: the one-device port's
    output, positions and gradients, then the sharded layer's (params
    placed on ``dmesh``, x split by ``batch_sharding``) with the rows of
    this rank's expert buffer and the collectives of its forward."""
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    model = lm_params_from_numpy(tree, cfg, "cpu")
    p = model.layers[len(cfg.prefix)].moe
    out = {}
    for name, c in cases.items():
        x = torch.from_numpy(c["x"])
        t = x.shape[0] * x.shape[1]
        with torch.no_grad():
            out[name] = dict(y1=L.moe(p, x, cfg, c["factor"]),
                             pos1=L.moe_route(p, x.reshape(t, -1), cfg)[2])
        out[name]["grads1"] = layer_grads(p, x, cfg, c["factor"], len(name))
    sh.distribute_params(cfg, dmesh, model)
    with sh.implicit_replication():
        for name, c in cases.items():
            x = torch.from_numpy(c["x"])
            t = x.shape[0] * x.shape[1]
            xd = sh.place(x, sh.batch_sharding(dmesh, 3))
            with torch.no_grad():
                with BmmShapes() as rec:
                    y = L.moe(p, xd, cfg, c["factor"])
                pos = L.moe_route(p, sh.place(x.reshape(t, -1), sh.batch_sharding(dmesh, 2)), cfg)[2]
            out[name].update(y=_whole(y), pos=_whole(pos), bmm=rec.shapes, collectives=rec.collectives,
                             grads=layer_grads(p, xd, cfg, c["factor"], len(name)))
    return out


def train_batch(cfg):
    rng = np.random.default_rng(4)
    used = rng.choice(cfg.vocab, TRAIN_VOCAB_USED, replace=False)
    toks = used[rng.integers(0, TRAIN_VOCAB_USED, (TRAIN_BATCH, TRAIN_SEQ))].astype(np.int32)
    return toks, rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)


def train_step(tree, cfg, dmesh=None):
    """(loss, aux loss of the first MoE layer, {name: parameter after one
    AdamW step}, MoE drops a layer) of ``train.build_step`` from ``tree`` on
    ``train_batch``, on ``dmesh`` when given."""
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh
    from repro_torch.optim import AdamWConfig

    model = lm_params_from_numpy(tree, cfg, "cpu").requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-3)
    if dmesh is not None:
        sh.distribute_params(cfg, dmesh, model)
    batch = train.make_batch(cfg, *train_batch(cfg), 0, "cpu")
    if dmesh is not None:
        batch = sh.shard_batch(batch, dmesh)
    first = len(cfg.prefix)
    drops, saved = [], L.moe

    def counted(p, x, cfg_, capacity_factor=None):
        t = x.shape[0] * x.shape[1]
        cap = L.moe_capacity(t, cfg_.num_experts, cfg_.moe_top_k, capacity_factor)
        with torch.no_grad():
            pos = L.moe_route(p, x.reshape(t, -1), cfg_)[2]
        drops.append(int(_whole(pos >= cap).sum()))
        return saved(p, x, cfg_, capacity_factor)

    with torch.no_grad(), sh.implicit_replication() if dmesh is not None else nullcontext():
        h = sh.as_rows(model.embed[batch["tokens"]].to(cfg.compute_dtype))
        aux = _whole(L.moe_aux_loss(model.layers[first].moe, h, cfg))
    opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
    L.moe = counted
    try:
        model, opt, loss, _ = train.build_step(cfg, opt_cfg, total_steps=10)(model, opt, batch)
    finally:
        L.moe = saved
    return (float(_whole(loss)), float(aux), {n: _whole(p) for n, p in model.named_parameters()},
            drops)


def decode(tree, cfg, dmesh=None):
    """Prefill logits and DECODE_STEPS decode steps' logits, the tokens
    drawn from a seed (the same on one device and on the mesh)."""
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch import serve_decode as sd
    from repro_torch.models import sharding as sh

    model = lm_params_from_numpy(tree, cfg, "cpu")
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, TRAIN_VOCAB_USED, (DECODE_BATCH, DECODE_PROMPT)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (DECODE_STEPS, DECODE_BATCH)))
    if dmesh is not None:
        sh.distribute_params(cfg, dmesh, model)
        prompt = sh.place(prompt, sh.batch_sharding(dmesh, 2))
    logits, caches = sd.prefill(cfg, model, prompt, None, DECODE_PROMPT + DECODE_STEPS)
    out = [_whole(logits)]
    for i, tok in enumerate(steps):
        if dmesh is not None:
            tok = sh.place(tok, sh.batch_sharding(dmesh, 1))
        logits, caches = sd.decode_step(cfg, model, tok, caches, DECODE_PROMPT + i)
        out.append(_whole(logits))
    return out


def moe_world(rank, world_size, models, shapes):
    torch.set_num_threads(2)  # the ranks share the host's cores
    out = {}
    for arch, m in models.items():
        tree, cfg = m["tree"], m["cfg"]
        out[(arch, "train", None)] = train_step(tree, cfg)
        if world_size == 4:
            out[(arch, "decode", None)] = decode(tree, cfg)
        for shape in shapes:
            dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
            out[(arch, "coords", shape)] = (dm.get_local_rank("data"), dm.get_local_rank("model"))
            out[(arch, "layer", shape)] = layer_cases(tree, cfg, m["cases"], dm)
            out[(arch, "train", shape)] = train_step(tree, cfg, dm)
            if shape == (2, 2):
                out[(arch, "decode", shape)] = decode(tree, cfg, dm)
    if world_size == 4:
        from repro_torch.launch import train

        argv = ["--arch", "arctic-480b", "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
                "--seq", "16"]
        out["cli"] = (train.main(argv + ["--mesh", "2x2"]), train.main(argv))
    return out


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    models = {a: dict(tree=r["tree"], cfg=r["cfg"],
                      cases={n: dict(x=c["x"], factor=c["factor"]) for n, c in r["cases"].items()})
              for a, r in reference.items()}
    with ThreadPoolExecutor(len(WORLDS)) as pool:  # the two worlds side by side
        runs = {n: pool.submit(M.run_world, moe_world, n, "gloo", tmp_path_factory.mktemp(f"moe{n}"),
                               args=(models, shapes), timeout=TIMEOUT)
                for n, shapes in WORLDS.items()}
        return {n: run.result() for n, run in runs.items()}


MESHES = [(n, s) for n, shapes in WORLDS.items() for s in shapes]
MESH_IDS = [f"{s[0]}x{s[1]}" for _, s in MESHES]


# -- the layer ----------------------------------------------------------------------


def test_hot_case_tells_a_global_capacity_from_a_per_shard_one(reference):
    """In ``hot`` a dispatch that counted each data shard of a 2-way split
    alone, with its own capacity or with the global one, would keep
    choices the reference drops."""
    from repro_torch.models import layers as L

    for arch, r in reference.items():
        c, cfg = r["cases"]["hot"], r["cfg"]
        assert (c["idx"][LAYER_CASES["hot"][1]:] == HOT_EXPERT).any(1).all()
        per_shard_cap = shard_kept(c["idx"], lambda t: L.moe_capacity(t, cfg.num_experts,
                                                                      cfg.moe_top_k), 2)
        global_cap = shard_kept(c["idx"], lambda t: c["cap"], 2)
        assert np.array_equal(shard_kept(c["idx"], lambda t: c["cap"], 1), c["keep"]), arch
        for wrong in (per_shard_cap, global_cap):
            assert (wrong & ~c["keep"]).sum() > 0, arch


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_sharded_layer_keeps_the_reference_set(worlds, reference, n, shape, arch, case):
    """On every rank: the positions of the sharded ``moe_route`` give the
    reference's kept set over the whole batch (drops engaged but in
    ``drop_free``); the sharded ``moe``'s output is within PREFILL_TOL of
    the reference's and of the one-device port's, and bitwise the latter
    at 1x1."""
    ref = reference[arch]["cases"][case]
    t, k = ref["idx"].shape
    for rank_out in worlds[n]:
        got = rank_out[(arch, "layer", shape)][case]
        keep = (got["pos"] < ref["cap"]).reshape(t, k).numpy()
        np.testing.assert_array_equal(keep, ref["keep"])
        np.testing.assert_array_equal(got["pos"].numpy(), got["pos1"].numpy())
        assert int((~keep).sum()) == 0 if case == "drop_free" else int((~keep).sum()) > 0
        np.testing.assert_allclose(got["y"].numpy(), ref["y"], **PREFILL_TOL)
        if shape == (1, 1):
            assert torch.equal(got["y"], got["y1"])
        else:
            torch.testing.assert_close(got["y"], got["y1"], **PREFILL_TOL)


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_buffer_rows_are_the_rank_own_kept_choices(worlds, reference, n, shape, arch, case):
    """Each rank runs three ``bmm`` over its slab of E / model experts, on a
    buffer of as many rows as the largest kept count among those experts
    from its own batch shard's tokens (the capacity itself at 1x1, the
    reference's buffer). Under FSDP at 2x2 (both configs) the slab's d is
    split over data: where the rank moves its rows (``moves_rows``) its
    products run over every data rank's kept choices, each rank's padded
    to the largest of their counts, on its block of d (the gate and input
    products) and of the output's d (``w_out``'s), as many FLOPs as its
    own rows with d whole; where it gathers the blocks, over its own rows
    as without FSDP."""
    ref, cfg = reference[arch]["cases"][case], reference[arch]["cfg"]
    d_size, m_size = shape
    e_slab = cfg.num_experts // m_size
    t, k = ref["idx"].shape

    def kept_rows(di, mi):
        rows = slice(di * t // d_size, (di + 1) * t // d_size)
        idx, keep = ref["idx"][rows], ref["keep"][rows]
        return max(int(((idx == e) & keep).sum()) for e in range(mi * e_slab, (mi + 1) * e_slab))

    for rank_out in worlds[n]:
        di, mi = rank_out[(arch, "coords", shape)]
        bmm = rank_out[(arch, "layer", shape)][case]["bmm"]
        want = ref["cap"] if shape == (1, 1) else kept_rows(di, mi)
        if d_size > 1 and cfg.fsdp and moves_rows(cfg, t // d_size, shape):
            rows = d_size * max(kept_rows(dj, mi) for dj in range(d_size))
            blk = cfg.d_model // d_size
            assert bmm == [(e_slab, rows, blk)] * 2 + [(e_slab, rows, cfg.d_ff)], (bmm, rows)
        else:
            assert len(bmm) == 3 and all(s[:2] == (e_slab, want) for s in bmm), (bmm, want)
        if shape == (2, 2) and case == "drop_free":  # 40 tokens a rank: under the capacity of 80
            assert want <= t // d_size < ref["cap"]


def moves_rows(cfg, tokens: int, shape) -> bool:
    """The byte rule by hand: a rank of ``tokens`` tokens (k choices each)
    moves its activations, the tokens (d), the gate and input products and
    the activation (3 k d_ff) and the output's blocks (k d / D), when they
    are at most the three stacks' blocks of its E / M experts (3 E / M
    d_ff d / D); all float32."""
    d_size, m_size = shape
    k, d, f = cfg.moe_top_k, cfg.d_model, cfg.d_ff
    return tokens * (d + 3 * k * f + k * d // d_size) <= 3 * cfg.num_experts // m_size * f * d // d_size


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_fsdp_layer_moves_rows_or_blocks_by_bytes(worlds, reference, arch, case):
    """At 2x2 under FSDP the sharded layer either exchanges its rows'
    activations over data (all-gathers of the tokens and of the
    activation, a reduce-scatter of the gate and input products, an
    all-to-all of the output's blocks) and moves no expert stack, no
    collective's operand ending in a stack block's (d / 2, d_ff) or
    (d_ff, d / 2); or it all-gathers the three stacks' blocks, whichever
    moves fewer bytes (40 tokens a rank move, 160 gather)."""
    cfg = reference[arch]["cfg"]
    assert cfg.fsdp
    t = LAYER_CASES[case][0] * LAYER_CASES[case][1] // 2
    assert moves_rows(cfg, t, (2, 2)) == (t == 40)
    blocks = {(cfg.d_model // 2, cfg.d_ff), (cfg.d_ff, cfg.d_model // 2)}
    for rank_out in worlds[4]:
        moved = rank_out[(arch, "layer", (2, 2))][case]["collectives"]
        names = [name.split(".")[0] for name, _ in moved]
        slabs = [shape for _, shape in moved if shape[-2:] in blocks]
        if moves_rows(cfg, t, (2, 2)):
            assert {"all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single"} <= set(names)
            assert not slabs, moved
        else:
            assert len(slabs) == 3 and "all_to_all_single" not in names, moved


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_sharded_layer_gradients(worlds, reference, n, shape, arch, case):
    """The gradients of the sharded layer's output against a fixed
    cotangent, with respect to x and the expert stacks (each stack's
    gradient placed as the stack, its FSDP block whole over data), within
    PREFILL_TOL of the reference's ``moe`` gradients on the same inputs
    and of the one-device layer's, bitwise at 1x1."""
    want = reference[arch]["cases"][case]["grads"]
    for rank_out in worlds[n]:
        got = rank_out[(arch, "layer", shape)][case]
        for g, g1, w, what in zip(got["grads"], got["grads1"], want, ("x", *STACKS), strict=True):
            np.testing.assert_allclose(g.numpy(), w, **PREFILL_TOL, err_msg=what)
            if shape == (1, 1):
                assert torch.equal(g, g1), what
            else:
                torch.testing.assert_close(g, g1, **PREFILL_TOL, msg=what)


# -- training and serving ------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_sharded_train_step(worlds, n, shape, arch):
    """``train.build_step`` on DTensor parameters: the loss (CE plus the aux
    loss) within LOSS_TOL of the one-device step's, the first MoE layer's
    aux loss on the sharded residual stream within LOSS_TOL, every
    parameter after one AdamW step within STEP_TOL, bitwise at 1x1; the
    capacity drops choices in every MoE layer, as many on the mesh."""
    for rank_out in worlds[n]:
        loss, aux, params, drops = rank_out[(arch, "train", shape)]
        loss1, aux1, params1, drops1 = rank_out[(arch, "train", None)]
        assert drops == drops1 and len(drops1) >= 2 and all(d > 0 for d in drops1), drops1
        if shape == (1, 1):
            assert loss == loss1 and aux == aux1
            for name, p in params.items():
                assert torch.equal(p, params1[name]), name
            continue
        np.testing.assert_allclose(loss, loss1, **LOSS_TOL)
        np.testing.assert_allclose(aux, aux1, **LOSS_TOL)
        for name, p in params.items():
            torch.testing.assert_close(p, params1[name], **STEP_TOL, msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_prefill_and_decode(worlds, arch):
    """On 2x2: the prefill (T = 320, drops engaged) and DECODE_STEPS decode
    steps' logits within DECODE_TOL of the one-device port's."""
    for rank_out in worlds[4]:
        got, want = rank_out[(arch, "decode", (2, 2))], rank_out[(arch, "decode", None)]
        assert len(got) == DECODE_STEPS + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **DECODE_TOL)


def test_trainer_trains_arctic_on_a_mesh(worlds):
    """``train.main(["--arch", "arctic-480b", "--reduced", "--mesh", "2x2",
    ...])`` on the ranks of a world trains the same two steps as the
    one-device trainer."""
    for rank_out in worlds[4]:
        sharded, one = rank_out["cli"]
        np.testing.assert_allclose(sharded, one, **LOSS_TOL)
