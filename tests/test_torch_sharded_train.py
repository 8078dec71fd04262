"""The sharded train step: ``models.sharding``'s DTensor placements,
``launch.train``'s step on DTensor parameters over meshes 1x1, 2x1, 1x2
and 2x2 in gloo worlds, the optimizers on DTensors, the trainer's
``--mesh DxM``, and the checkpoints' sharded save and elastic restore.

The reference's own sharded step fails under JAX 0.9.0
(``tests/test_mesh_multidevice.py::test_sharded_train_step_runs``: a
``ShardingTypeError`` on the embedding gather, ROADMAP queue 3), so the
port's sharded step is held against the reference's one-device
``loss_fn`` (the loss within the train tests' rtol 1e-5) and against the
port's own one-device step (the parameters after one AdamW step within
rtol 1e-5, atol 1e-6, and bitwise on 1x1). The model is the reference
test's reduced granite (``tests/test_mesh_multidevice.py:38-40``). The
elastic restore is the reference's case (l.57-83) at 4 ranks: saved from
a (2, 2) world, restored in a (2, 1) world with the placements swapped,
bitwise. Where the KV heads do not divide the model axis while the query
heads do (``sharding.own_kv_heads``), the same holds of a reduced granite
with 1 KV head at 1x2 and 2x2 (also under FSDP) and of the reduced
gemma3-12b with its banded windows at 1x4, each from the reference's
weights and against its loss."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M

TIMEOUT = 300
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
BATCH, SEQ = 4, 32
# The reduced gemma3-12b keeps the registry's window of 1,024; the CPU
# case cuts it to 8, so SEQ = 32 tokens span 4 windows.
GEMMA3_WINDOW = 8
# (config, mesh) whose KV heads do not divide the model axis while the
# query heads do, so that each model rank projects only its own query
# heads' KV heads (sharding.own_kv_heads): own_kv_cfgs' configs.
OWN_CASES = [("kv1", (1, 2)), ("kv1", (2, 2)), ("kv1-fsdp", (2, 2)), ("gemma3", (1, 4))]


def reference_cfg():
    from repro.configs import registry as jregistry

    return jregistry.get("granite-3-8b").reduced().replace(
        d_model=64, d_ff=128, q_heads=8, kv_heads=4, vocab=512)


def port_cfg(jcfg, **knobs):
    from repro_torch.configs import base as tb

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for key in ("pattern", "prefix"):
        kw[key] = tuple(tb.BlockDef(**dataclasses.asdict(b)) for b in kw[key])
    kw["param_dtype"] = kw["compute_dtype"] = torch.float32
    return tb.ArchConfig(**kw).replace(**knobs)


def tokens():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
            rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32))


@pytest.fixture(scope="module")
def reference():
    """The reference's weights (numpy) and its one-device loss on them."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    jcfg = reference_cfg()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    toks, tgts = tokens()
    loss = jax.jit(lambda p: JT.loss_fn(p, jnp.asarray(toks), jnp.asarray(tgts), jcfg))(jp)
    return jax.tree.map(np.asarray, jp), float(loss), jcfg


def own_kv_cfgs():
    """label -> (the reference's config, the port's knobs beyond it) of
    OWN_CASES: ``reference_cfg`` with 4 query heads and 1 KV head, alone
    and under FSDP (``d`` over ``data``), and the reduced gemma3-12b (4
    query heads, 2 KV heads; 5 windowed layers and 1 global a pattern)
    with ``block_local_attn`` on and its window cut to GEMMA3_WINDOW."""
    from repro.configs import registry as jregistry

    kv1 = reference_cfg().replace(q_heads=4, kv_heads=1)
    g = jregistry.get("gemma3-12b").reduced()
    pattern = tuple(dataclasses.replace(b, window=GEMMA3_WINDOW) if b.window else b for b in g.pattern)
    return {"kv1": (kv1, {}), "kv1-fsdp": (kv1, {"fsdp": True}),
            "gemma3": (g.replace(pattern=pattern, block_local_attn=True), {})}


@pytest.fixture(scope="module")
def own_references():
    """label -> (the reference's weights (numpy, seed 0), its one-device
    loss on them, the port's config) for ``own_kv_cfgs``."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    toks, tgts = tokens()
    out, done = {}, {}
    for label, (jcfg, knobs) in own_kv_cfgs().items():
        if id(jcfg) not in done:
            jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
            loss = jax.jit(lambda p, jcfg=jcfg: JT.loss_fn(p, jnp.asarray(toks), jnp.asarray(tgts), jcfg))(jp)
            done[id(jcfg)] = (jax.tree.map(np.asarray, jp), float(loss))
        out[label] = done[id(jcfg)] + (port_cfg(jcfg, **knobs),)
    return out


def one_step(tree, cfg, dmesh=None):
    """(loss, {name: parameter after one step}) of the port's step from
    ``tree``, on ``dmesh`` when given (DTensor parameters, the batch over
    ``data``)."""
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch import train
    from repro_torch.models import sharding as sh
    from repro_torch.optim import AdamWConfig

    model = lm_params_from_numpy(tree, cfg, "cpu").requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-3)
    if dmesh is not None:
        sh.distribute_params(cfg, dmesh, model)
    opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
    toks, tgts = tokens()
    batch = train.make_batch(cfg, toks, tgts, 0, "cpu")
    if dmesh is not None:
        batch = sh.shard_batch(batch, dmesh)
    model, opt, loss, _ = train.build_step(cfg, opt_cfg, total_steps=10)(model, opt, batch)

    def whole(t):
        return (t.full_tensor() if sh.is_dtensor(t) else t).detach().clone()

    moments = {n: whole(t) for n, t in (opt.mu if hasattr(opt, "mu") else opt.vr).items()}
    return float(whole(loss)), {n: whole(p) for n, p in model.named_parameters()}, moments


def step_world(rank, world_size, tree, cfgs, shapes, own, ckpt_dir):
    """For each config and mesh shape: the one-device step and the sharded
    step on this rank; for each of OWN_CASES on this world's size, the
    one-device step and ``own_steps`` on its mesh (``own``: label -> the
    reference's weights and the port's config). In the world of 4, also a
    sharded checkpoint save and the trainer's --mesh 2x2 over two steps."""
    from repro_torch.launch import train

    out = {}
    for label, cfg in cfgs.items():
        out[(label, None)] = one_step(tree, cfg)
        for shape in shapes:
            dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
            out[(label, shape)] = one_step(tree, cfg, dm)
    for label, shape in OWN_CASES:
        if shape[0] * shape[1] == world_size:
            if ("own", label, None) not in out:
                out[("own", label, None)] = one_step(*own[label])
            out[("own", label, shape)] = own_steps(*own[label], shape)
    if world_size == 4:
        out["saved"] = save_sharded(ckpt_dir)
        argv = ["--arch", "granite-3-8b", "--reduced", "--device", "cpu", "--steps", "2",
                "--batch", "4", "--seq", "16"]
        out["cli"] = (train.main(argv + ["--mesh", "2x2", "--ckpt-dir", str(Path(ckpt_dir) / "cli")]),
                      train.main(argv))
    return out


@pytest.fixture(scope="module")
def worlds(reference, own_references, tmp_path_factory):
    tree, _, jcfg = reference
    own = {label: (t, cfg) for label, (t, _, cfg) in own_references.items()}
    ckpt = tmp_path_factory.mktemp("ckpt")
    cfgs = {"adamw": port_cfg(jcfg), "adamw_bf16": port_cfg(jcfg, adam_moments_bf16=True),
            "adafactor": port_cfg(jcfg, use_adafactor=True)}
    run = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2)]}
    out = {}
    for n, shapes in run.items():
        use = cfgs if n == 4 else {"adamw": cfgs["adamw"]}
        out[n] = M.run_world(step_world, n, "gloo", tmp_path_factory.mktemp(f"world{n}"),
                             args=(tree, use, shapes, own, ckpt), timeout=TIMEOUT)
    return out, ckpt


MESH_CASES = [(1, (1, 1)), (2, (2, 1)), (2, (1, 2)), (4, (2, 2))]


@pytest.mark.parametrize("n,shape", MESH_CASES, ids=[f"{s[0]}x{s[1]}" for _, s in MESH_CASES])
def test_sharded_step(worlds, reference, n, shape):
    """The sharded step's loss equals the reference's one-device loss; its
    parameters and moments after one AdamW step equal the port's
    one-device step's (bitwise on 1x1), on every rank."""
    _, jloss, _ = reference
    for rank_out in worlds[0][n]:
        loss, params, mu = rank_out[("adamw", shape)]
        loss1, params1, mu1 = rank_out[("adamw", None)]
        np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
        for name, p in params.items():
            if shape == (1, 1):
                assert torch.equal(p, params1[name]), name
                assert torch.equal(mu[name], mu1[name]), name
            else:
                torch.testing.assert_close(p, params1[name], **STEP_TOL, msg=name)
                torch.testing.assert_close(mu[name], mu1[name], rtol=1e-4, atol=1e-5, msg=name)
        if shape == (1, 1):
            assert loss == loss1


def own_steps(tree, cfg, shape):
    """The step of ``one_step`` on a mesh of ``shape``, and the local
    shapes of q and k at each ``banded_attention`` call and of the K and V
    projections ``sharding.own_kv_heads`` made."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
    calls, own, saved = [], [], (L.banded_attention, sh.own_kv_heads)

    def recorded(q, k, v, window):
        calls.append((tuple(q.shape), tuple(k.shape), window))
        return saved[0](q, k, v, window)

    def counted(*args):
        out = saved[1](*args)
        own.append(tuple(out.to_local().shape))
        return out

    L.banded_attention, sh.own_kv_heads = recorded, counted
    try:
        return one_step(tree, cfg, dm), calls, own
    finally:
        L.banded_attention, sh.own_kv_heads = saved


def check_own_step(worlds, own_references, label, shape):
    """On every rank of ``label``'s world on ``shape``: each K and V
    projection of each attention layer was each rank's own query heads'
    (``sharding.own_kv_heads``: its rows, H / model heads); the loss
    within LOSS_TOL of the reference's one-device loss; the parameters and
    first moments after one AdamW step as in ``test_sharded_step``,
    against the one-device step. Returns each rank's ``banded_attention``
    calls."""
    _, jloss, cfg = own_references[label]
    layers = sum(1 for bd in cfg.layer_defs() if bd.mixer == "attn")
    heads = (BATCH // shape[0], SEQ, cfg.q_heads // shape[1], cfg.head_dim)
    out = []
    for rank_out in worlds[0][shape[0] * shape[1]]:
        loss1, params1, mu1 = rank_out[("own", label, None)]
        (loss, params, mu), calls, own = rank_out[("own", label, shape)]
        assert len(own) >= 2 * layers and all(o == heads for o in own), own
        np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
        for name, p in params.items():
            torch.testing.assert_close(p, params1[name], **STEP_TOL, msg=name)
            torch.testing.assert_close(mu[name], mu1[name], rtol=1e-4, atol=1e-5, msg=name)
        out.append(calls)
    return out


KV1_CASES = [(label, shape) for label, shape in OWN_CASES if label != "gemma3"]


@pytest.mark.parametrize("label,shape", KV1_CASES, ids=[f"{c}-{s[0]}x{s[1]}" for c, s in KV1_CASES])
def test_own_kv_heads_step(worlds, own_references, label, shape):
    """``reference_cfg`` with 4 query heads and 1 KV head: the KV head does
    not divide the 2-way model axis (wk and wv whole there, as 8 KV heads
    on a 16-way axis), so each rank projects it for its 2 query heads
    only, with the batch over ``data`` at 2x2 and, under FSDP, wk and wv
    split over ``data`` too; their gradients partial sums over ``model``
    and the rows' ``data``. ``check_own_step``."""
    assert not any(check_own_step(worlds, own_references, label, shape))


def test_gemma3_own_kv_heads_through_k5(worlds, own_references):
    """The reduced gemma3-12b at 1x4 with ``block_local_attn`` and a
    sequence of 4 windows, from the reference's weights: its 2 KV heads do
    not divide the model axis, so each rank projects only the KV head its
    one query head reads and its windowed layers reach
    ``banded_attention`` through ``local_heads`` on that head's q, k and v.
    ``check_own_step``."""
    cfg = own_references["gemma3"][2]
    windowed = sum(1 for bd in cfg.layer_defs() if bd.window)
    local = (BATCH, SEQ, 1, cfg.head_dim)
    for calls in check_own_step(worlds, own_references, "gemma3", (1, 4)):
        assert windowed and len(calls) >= windowed
        assert all(c == (local, local, GEMMA3_WINDOW) for c in calls), calls


@pytest.mark.parametrize("label", ["adamw_bf16", "adafactor"])
def test_optimizers_step_dtensors(worlds, label):
    """AdamW with bfloat16 moments and Adafactor (its factored moments
    placed by the reference's vr/vc rules) step DTensor parameters on 2x2
    as they step the one-device parameters."""
    for rank_out in worlds[0][4]:
        loss, params, moments = rank_out[(label, (2, 2))]
        loss1, params1, moments1 = rank_out[(label, None)]
        np.testing.assert_allclose(loss, loss1, **LOSS_TOL)
        for name, p in params.items():
            torch.testing.assert_close(p, params1[name], **STEP_TOL, msg=name)
            torch.testing.assert_close(moments[name].float(), moments1[name].float(), rtol=1e-3,
                                       atol=1e-5, msg=name)


def test_trainer_runs_a_mesh_under_a_world(worlds):
    """``train.main(["--mesh", "2x2", ...])`` on the ranks of a world trains
    (and checkpoints) the same two steps as the one-device trainer."""
    for rank_out in worlds[0][4]:
        sharded, one = rank_out["cli"]
        np.testing.assert_allclose(sharded, one, **LOSS_TOL)
    ckpt = worlds[1] / "cli"
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000002"]


# -- placements ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (16, 16)])
def test_placements_follow_the_pspecs(shape):
    """``make_shardings`` turns each ``make_pspecs`` entry into DTensor
    placements (an axis -> Shard(dim) on its mesh dimension, or Replicate
    where that dimension has one device; None -> Replicate),
    ``distribute_params`` places the model so, and each local
    shard's bytes equal ``per_device_bytes``. Counted as rank 0 of a fake
    world (full width on meta at 16x16)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as sh

    cfg = registry.get("granite-3-8b")
    if shape != (16, 16):
        cfg = cfg.reduced().replace(d_model=64, d_ff=128, q_heads=8, kv_heads=4, vocab=512)
    mesh = M.make_mesh(shape, ("data", "model"))
    with M.fake_world(mesh.size):
        dm = M.device_mesh(mesh, "cpu")
        model = dryrun.meta_model(cfg)
        specs = sh.make_pspecs(cfg, mesh, model)
        shardings = sh.make_shardings(cfg, dm, model)
        for name, spec in specs.items():
            want = [Replicate(), Replicate()]
            for dim, axis in enumerate(spec):
                if axis is not None and mesh.axis_sizes[axis] > 1:
                    want[mesh.axis_names.index(axis)] = Shard(dim)
            assert shardings[name].placements == tuple(want), name
        assert specs["layers.0.attn.wq"][1] == "model"
        sh.distribute_params(cfg, dm, model)
        local = sum(p.to_local().numel() * p.to_local().element_size() for p in model.parameters())
        assert local == sh.per_device_bytes(model, specs, mesh)
        assert all(tuple(p.placements) == shardings[n].placements
                   for n, p in model.named_parameters())


def test_batch_sharding_over_every_non_model_axis():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import sharding as sh

    mesh = M.make_mesh((2, 2, 2), ("pod", "data", "model"))
    with M.fake_world(mesh.size):
        dm = M.device_mesh(mesh, "cpu")
        assert sh.batch_sharding(dm, 2).placements == (Shard(0), Shard(0), Replicate())
        batch = sh.shard_batch({"tokens": torch.zeros((8, 16), dtype=torch.long)}, dm)
        assert batch["tokens"].to_local().shape == (2, 16)


# -- checkpoints ------------------------------------------------------------------------


W = np.arange(64.0, dtype=np.float32).reshape(8, 8)


def save_sharded(ckpt_dir):
    """The reference's elastic case, saved from this rank of a (2, 2)
    world: w placed P("data", "model")."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import sharding as sh

    dm = M.device_mesh(M.make_mesh((2, 2), ("data", "model")), "cpu")
    w = sh.place(torch.from_numpy(W), sh.Sharding(dm, sh.to_placements(("data", "model"), dm)))
    CheckpointManager(Path(ckpt_dir) / "elastic").save(1, {"w": w})
    return tuple(w.to_local().shape)


def restore_world(rank, world_size, ckpt_dir):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import sharding as sh

    dm = M.device_mesh(M.make_mesh((2, 1), ("data", "model")), "cpu")
    where = sh.Sharding(dm, sh.to_placements(("model", "data"), dm))
    restored, manifest = CheckpointManager(Path(ckpt_dir) / "elastic").restore_latest(
        {"w": torch.zeros(8, 8)}, placements={"w": where})
    w = restored["w"]
    return (w.full_tensor().numpy(), tuple(w.placements) == where.placements,
            tuple(w.to_local().shape), manifest["step"])


def test_elastic_restore(worlds, tmp_path):
    """Saved from a (2, 2) world (each rank a 4 x 4 block, rank 0 writing
    the whole tensor), restored in a (2, 1) world with the placements
    swapped: bitwise the saved values, placed as asked (the columns split
    over data)."""
    assert all(r["saved"] == (4, 4) for r in worlds[0][4])
    for full, placed, local, step in M.run_world(restore_world, 2, "gloo", tmp_path,
                                                 args=(worlds[1],), timeout=TIMEOUT):
        np.testing.assert_array_equal(full, W)
        assert placed and local == (8, 4) and step == 1


def test_shardings_of_and_plain_restore(tmp_path):
    """Without a world a checkpoint is the one-device one it always was;
    ``shardings_of`` marks a tree's plain leaves None."""
    from repro_torch.checkpoint import restore_pytree, save_pytree, shardings_of

    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    assert shardings_of(tree) == {"a": None, "b": [None]}
    save_pytree(tmp_path / "c", tree, step=3)
    got, manifest = restore_pytree(tmp_path / "c", tree, placements=shardings_of(tree))
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"][0], tree["b"][0])
    assert manifest["step"] == 3
