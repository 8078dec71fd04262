"""Decode on a mesh without gathering the caches: ``layers.decode_attention``
on a DTensor KV cache (its sequence split over ``model``, full and ring
layers) and ``ssm.ssd_decode`` on a DTensor SSD cache (the state's heads and
the conv ring's channels split over ``model``), in one gloo world of 4
ranks on 2x2 and 1x4 meshes.

The caches are placed as the reference's ``cache_pspecs`` places them.
Each sharded step is held to the port's one-device step on the same numpy
inputs: the attention output within the reference's mesh tolerance
(``tests/test_mesh_multidevice.py:190``, atol 2e-5) and the written cache
within 1e-6; the SSD's outputs and caches within ``test_torch_ssm``'s SSD
tolerance, and the reduced mamba2 and hymba models' decode logits within
its decode tolerance. Each is also held to ``repro`` on the same inputs:
the one-device attention decode to its ``decode_attention``, the split
SSD's outputs and caches to its ``ssd_decode`` from the same state, conv
ring and tokens, and the models' logits (the reference's weights, carried
by ``interop.lm_params_from_numpy``) to its ``prefill`` and
``decode_step``. After every step each cache keeps its placement, and the
reduced granite decode's collective bytes a device do not grow with the
cache's length."""

import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M

TIMEOUT = 300
MESHES = ((2, 2), (1, 4))
MESH_FLASH_TOL = dict(rtol=0.0, atol=2e-5)
CACHE_TOL = dict(rtol=0.0, atol=1e-6)
SSD_TOL = dict(rtol=0.0, atol=1e-4)  # tests/test_torch_ssm.py
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_torch_ssm.py
B, D, H, KV, HD = 4, 64, 8, 2, 16
# A full layer of 32 slots (8 a shard at 1x4, 16 at 2x2) and a ring of 16
# (4 a shard at 1x4, 8 at 2x2). Positions on both sides of shard
# boundaries, and past the ring's wrap.
LAYERS = {"full": (None, 32, (7, 8, 15, 16, 31)), "ring": (16, 16, (3, 4, 8, 15, 16, 21, 37))}
SSD_STEPS, MODEL_PROMPT, MODEL_STEPS = 4, 16, 4
MODEL_ARCHS = ("mamba2-780m", "hymba-1.5b")


def attn_cfg():
    from repro_torch.configs.base import ArchConfig

    return ArchConfig("t", "dense", 2, D, H, KV, HD, 128, 256, qk_norm=True,
                      param_dtype=torch.float32, compute_dtype=torch.float32, remat="none")


def attn_inputs(layer: str, pos: int) -> dict:
    _, length, _ = LAYERS[layer]
    rng = np.random.default_rng(pos + 100 * (layer == "ring"))
    out = {"wq": rng.normal(size=(D, H, HD)) / 8, "wk": rng.normal(size=(D, KV, HD)) / 8,
           "wv": rng.normal(size=(D, KV, HD)) / 8, "wo": rng.normal(size=(H, HD, D)) / np.sqrt(H * HD),
           "q_norm": rng.normal(0, 0.3, size=(HD,)), "k_norm": rng.normal(0, 0.3, size=(HD,)),
           "x": rng.normal(size=(B, 1, D)), "ck": rng.normal(size=(B, length, KV, HD)),
           "cv": rng.normal(size=(B, length, KV, HD))}
    return {k: v.astype(np.float32) for k, v in out.items()}


def port_attention(a: dict):
    from repro_torch.models import layers as L

    p = L.Attention(attn_cfg(), "cpu")
    with torch.no_grad():
        for k in ("wq", "wk", "wv", "wo"):
            getattr(p, k).copy_(torch.from_numpy(a[k]))
        p.q_norm.scale.copy_(torch.from_numpy(a["q_norm"]))
        p.k_norm.scale.copy_(torch.from_numpy(a["k_norm"]))
    return p


def ssd_cfg(groups: int):
    """``test_torch_ssm``'s SSD shape (d_model 32, d_inner 64, 4 heads of 16,
    N = 8): its heads (4), conv channels (80 / 96) and packed projection
    (148 / 164) split evenly over a model axis of 2 or 4."""
    return types.SimpleNamespace(d_model=32, ssm_expand=2, ssm_head_dim=16, ssm_state=8,
                                 ssm_groups=groups, ssm_conv=4, ssm_chunk=8, fsdp=False,
                                 param_dtype=torch.float32, compute_dtype=torch.float32)


def ssd_inputs(groups: int) -> dict:
    from repro_torch.models import ssm as S

    rng = np.random.default_rng(groups)
    cfg = ssd_cfg(groups)
    mod = S.SSD(cfg)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy((rng.standard_normal(p.shape) * 0.3).astype(np.float32)))
    cache = S.init_ssd_cache(cfg, B, torch.float32)
    return dict(params={n: p.detach().clone() for n, p in mod.named_parameters()},
                state=rng.normal(size=cache["state"].shape).astype(np.float32),
                conv=rng.normal(size=cache["conv"].shape).astype(np.float32),
                xs=(0.5 * rng.standard_normal((SSD_STEPS, B, 1, 32))).astype(np.float32))


def ssd_module(groups: int, a: dict):
    from repro_torch.models import ssm as S

    mod = S.SSD(ssd_cfg(groups))
    with torch.no_grad():
        for n, p in mod.named_parameters():
            p.copy_(a["params"][n])
    return mod


def placed_cache(cache: dict, dm):
    """``cache`` (whole) placed on ``dm`` as ``cache_pspecs`` says."""
    from repro_torch.models import sharding as sh

    specs = sh.cache_pspecs(M.describe(dm), cache, B)
    return {k: sh.place(t, sh.Sharding(dm, sh.to_placements(specs[k], dm))) for k, t in cache.items()}


def _whole(t):
    from repro_torch.models import sharding as sh

    return (t.full_tensor() if sh.is_dtensor(t) else t).detach().clone()


def _placements(caches) -> list:
    return [{kind: {k: tuple(t.placements) for k, t in part.items()} for kind, part in c.items()}
            for c in caches]


# -- one-device paths ----------------------------------------------------------------


def attn_one_device(layer: str, pos: int):
    from repro_torch.models import layers as L

    window, _, _ = LAYERS[layer]
    a = attn_inputs(layer, pos)
    cache = {"k": torch.from_numpy(a["ck"]).clone(), "v": torch.from_numpy(a["cv"]).clone()}
    with torch.no_grad():
        y, c = L.decode_attention(port_attention(a), torch.from_numpy(a["x"]), cache, pos,
                                  cfg=attn_cfg(), window=window)
    return y, c["k"], c["v"]


def ssd_one_device(groups: int):
    from repro_torch.models import ssm as S

    a = ssd_inputs(groups)
    mod = ssd_module(groups, a)
    cache = {"state": torch.from_numpy(a["state"]).clone(), "conv": torch.from_numpy(a["conv"]).clone()}
    ys = []
    with torch.no_grad():
        for x in a["xs"]:
            y, cache = S.ssd_decode(mod, torch.from_numpy(x), cache, ssd_cfg(groups))
            ys.append(y)
    return ys, cache


def model_tokens(vocab: int):
    """(prompt (B, MODEL_PROMPT), the MODEL_STEPS decode tokens (B,) each)."""
    rng = np.random.default_rng(5)
    return rng.integers(0, vocab, (B, MODEL_PROMPT)), rng.integers(0, vocab, (MODEL_STEPS, B))


def ssd_reference(groups: int):
    """The outputs a step and the final cache of ``repro``'s ``ssd_decode``
    on ``ssd_inputs(groups)``."""
    import jax.numpy as jnp

    from repro.models import ssm as JS

    a = ssd_inputs(groups)
    jcfg = types.SimpleNamespace(**{**vars(ssd_cfg(groups)), "param_dtype": jnp.float32,
                                    "compute_dtype": jnp.float32})
    jp = {}
    for name, t in a["params"].items():
        *path, last = name.split(".")
        leaf = jp
        for key in path:
            leaf = leaf.setdefault(key, {})
        leaf[last] = jnp.asarray(t.numpy())
    cache = {"state": jnp.asarray(a["state"]), "conv": jnp.asarray(a["conv"])}
    ys = []
    for x in a["xs"]:
        y, cache = JS.ssd_decode(jp, jnp.asarray(x), cache, jcfg)
        ys.append(torch.tensor(np.asarray(y)))
    return ys, {k: torch.tensor(np.asarray(v)) for k, v in cache.items()}


def model_decode(arch: str, tree, dm=None):
    """Prefill and MODEL_STEPS decode steps of the reduced ``arch`` on the
    reference's weights ``tree`` (its logits each step), on ``dm`` when
    given, with each step's cache placements."""
    from repro_torch.configs import registry
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch import serve_decode as sd
    from repro_torch.models import sharding as sh

    cfg = registry.get(arch).reduced()
    model = lm_params_from_numpy(tree, cfg, "cpu")
    prompt, steps = (torch.from_numpy(t) for t in model_tokens(cfg.vocab))
    if dm is not None:
        sh.distribute_params(cfg, dm, model)
        prompt = sh.place(prompt, sh.batch_sharding(dm, 2))
    logits, caches = sd.prefill(cfg, model, prompt, None, MODEL_PROMPT + MODEL_STEPS)
    out, placements = [_whole(logits)], []
    if dm is not None:
        placements.append(_placements(caches))
    for i, tok in enumerate(steps):
        if dm is not None:
            tok = sh.place(tok, sh.batch_sharding(dm, 1))
        logits, caches = sd.decode_step(cfg, model, tok, caches, MODEL_PROMPT + i)
        out.append(_whole(logits))
        if dm is not None:
            placements.append(_placements(caches))
    return out, placements


# -- the world ------------------------------------------------------------------------


def decode_world(rank, world_size, trees):
    """Every case on both meshes: the attention layer's output, written
    cache and placements before and after; the SSD's outputs a step, final
    cache and placements; the reduced models' logits and placements."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh
    from repro_torch.models import ssm as S

    torch.set_num_threads(1)  # the ranks share the host's cores
    out = {}
    for shape in MESHES:
        dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
        with torch.no_grad(), sh.implicit_replication():
            for layer, (window, _, positions) in LAYERS.items():
                for pos in positions:
                    a = attn_inputs(layer, pos)
                    p = sh.distribute_params(attn_cfg(), dm, port_attention(a))
                    cache = placed_cache({"k": torch.from_numpy(a["ck"]), "v": torch.from_numpy(a["cv"])},
                                         dm)
                    before = {k: tuple(t.placements) for k, t in cache.items()}
                    x = sh.place(torch.from_numpy(a["x"]), sh.batch_sharding(dm, 3))
                    y, c = L.decode_attention(p, x, cache, pos, cfg=attn_cfg(), window=window)
                    out[("attn", shape, layer, pos)] = (
                        _whole(y), _whole(c["k"]), _whole(c["v"]), before,
                        {k: tuple(t.placements) for k, t in c.items()})
            a = attn_inputs("full", 0)
            p = sh.distribute_params(attn_cfg(), dm, port_attention(a))
            cache = placed_cache({"k": torch.from_numpy(a["ck"]), "v": torch.from_numpy(a["cv"])}, dm)
            x = sh.place(torch.from_numpy(a["x"]), sh.batch_sharding(dm, 3))
            try:
                L.decode_attention(p, x, cache, LAYERS["full"][1], cfg=attn_cfg())
                out[("past", shape)] = None
            except IndexError as e:
                out[("past", shape)] = str(e)
            for groups in (1, 2):
                a = ssd_inputs(groups)
                cfg = ssd_cfg(groups)
                mod = sh.distribute_params(cfg, dm, ssd_module(groups, a))
                cache = placed_cache({"state": torch.from_numpy(a["state"]),
                                      "conv": torch.from_numpy(a["conv"])}, dm)
                before = {k: tuple(t.placements) for k, t in cache.items()}
                ys, after = [], []
                for xn in a["xs"]:
                    x = sh.place(torch.from_numpy(xn), sh.batch_sharding(dm, 3))
                    y, cache = S.ssd_decode(mod, x, cache, cfg)
                    ys.append(_whole(y))
                    after.append({k: tuple(t.placements) for k, t in cache.items()})
                out[("ssd", shape, groups)] = (ys, {k: _whole(t) for k, t in cache.items()}, before,
                                               after)
        for arch in MODEL_ARCHS:
            out[("model", shape, arch)] = model_decode(arch, trees[arch], dm)
    return out


@pytest.fixture(scope="module")
def reference_models():
    """Per arch: the reference's weights (numpy, seed 3) and its prefill
    and decode logits on ``model_tokens``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import transformer as JT

    out = {}
    for arch in MODEL_ARCHS:
        jcfg = jregistry.get(arch).reduced()
        tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(3)))
        jp = jax.tree.map(jnp.asarray, tree)
        prompt, steps = model_tokens(jcfg.vocab)
        logits, cache = JT.prefill(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                                   max_len=MODEL_PROMPT + MODEL_STEPS)
        want = [logits]
        jstep = jax.jit(lambda p, t, c, pos, jcfg=jcfg: JT.decode_step(p, t, c, pos, jcfg))
        for i, tok in enumerate(steps):
            logits, cache = jstep(jp, jnp.asarray(tok, jnp.int32), cache, MODEL_PROMPT + i)
            want.append(logits)
        out[arch] = (tree, [torch.tensor(np.asarray(w)) for w in want])
    return out


@pytest.fixture(scope="module")
def world(reference_models, tmp_path_factory):
    trees = {arch: tree for arch, (tree, _) in reference_models.items()}
    return M.run_world(decode_world, 4, "gloo", tmp_path_factory.mktemp("world"), args=(trees,),
                       timeout=TIMEOUT)


ATTN_CASES = [(shape, layer, pos) for shape in MESHES for layer, (_, _, ps) in LAYERS.items()
              for pos in ps]


@pytest.mark.parametrize("shape,layer,pos", ATTN_CASES,
                         ids=[f"{s[0]}x{s[1]}-{l}-pos{p}" for s, l, p in ATTN_CASES])
def test_attention_decode_on_a_split_cache(world, shape, layer, pos):
    """The sharded plain decode against the one-device decode: the output
    within atol 2e-5, the written cache within 1e-6 (only the slot of
    ``pos``, or ``pos mod W`` in the ring, changes), and the cache's
    placements as they were (the sequence still split over model)."""
    want_y, want_k, want_v = attn_one_device(layer, pos)
    a = attn_inputs(layer, pos)
    window, length, _ = LAYERS[layer]
    slot = pos % length if window else pos
    for rank_out in world:
        y, k, v, before, after = rank_out[("attn", shape, layer, pos)]
        torch.testing.assert_close(y, want_y, **MESH_FLASH_TOL)
        torch.testing.assert_close(k, want_k, **CACHE_TOL)
        torch.testing.assert_close(v, want_v, **CACHE_TOL)
        assert np.nonzero((k.numpy() != a["ck"]).any(axis=(0, 2, 3)))[0].tolist() == [slot]
        assert after == before and before["k"][1].is_shard(1)  # the sequence over model


@pytest.mark.parametrize("shape", (None,) + MESHES, ids=lambda s: f"{s[0]}x{s[1]}" if s else "plain")
def test_decode_past_a_full_cache_raises(world, shape):
    """A full layer's decode at its cache's length (one position past
    ``max_len``) raises ``IndexError``, on the plain cache and on every
    rank of a split one, where no block owns the slot."""
    length = LAYERS["full"][1]
    if shape is None:
        with pytest.raises(IndexError, match=f"position {length} is past"):
            attn_one_device("full", length)
        return
    for rank_out in world:
        assert rank_out[("past", shape)] == f"decode position {length} is past the cache's {length} slots"


def test_one_device_decode_matches_reference():
    """The port's one-device plain decode (full and ring layers, the slots
    of every case) against ``repro.models.layers.decode_attention`` on the
    same inputs, within atol 2e-5; the written caches within 1e-6."""
    import jax.numpy as jnp

    from repro.configs.base import ArchConfig
    from repro.models import layers as JL

    jcfg = ArchConfig("t", "dense", 2, D, H, KV, HD, 128, 256, qk_norm=True,
                      param_dtype=jnp.float32, compute_dtype=jnp.float32, remat="none")
    for layer, (window, _, positions) in LAYERS.items():
        for pos in positions:
            a = attn_inputs(layer, pos)
            jp = {k: jnp.asarray(a[k]) for k in ("wq", "wk", "wv", "wo")}
            jp["q_norm"] = {"scale": jnp.asarray(a["q_norm"])}
            jp["k_norm"] = {"scale": jnp.asarray(a["k_norm"])}
            jy, jc = JL.decode_attention(jp, jnp.asarray(a["x"]),
                                         {"k": jnp.asarray(a["ck"]), "v": jnp.asarray(a["cv"])},
                                         jnp.int32(pos), cfg=jcfg, window=window)
            y, k, v = attn_one_device(layer, pos)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MESH_FLASH_TOL)
            np.testing.assert_allclose(k.numpy(), np.asarray(jc["k"]), **CACHE_TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(jc["v"]), **CACHE_TOL)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ssd_decode_on_split_state(world, shape, groups):
    """``ssd_decode`` over SSD_STEPS tokens with the state's heads and the
    conv ring's channels split over model: each step's output and the
    final state and ring within the SSD tolerance of the one-device
    decode and of ``repro``'s ``ssd_decode``, and the placements unchanged
    after every step."""
    wants = (ssd_one_device(groups), ssd_reference(groups))
    for rank_out in world:
        ys, cache, before, after = rank_out[("ssd", shape, groups)]
        for want_ys, want_cache in wants:
            for t, (y, want) in enumerate(zip(ys, want_ys, strict=True)):
                torch.testing.assert_close(y, want, **SSD_TOL, msg=f"step {t}")
            for key in ("state", "conv"):
                torch.testing.assert_close(cache[key], want_cache[key], **SSD_TOL, msg=key)
        assert all(a == before for a in after)
        assert before["state"][1].is_shard(1) and before["conv"][1].is_shard(2)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_decode_on_a_mesh(world, reference_models, shape, arch):
    """The reduced mamba2 and hymba models' prefill and decode steps with
    DTensor parameters: logits within the decode tolerance of the
    one-device model's and of the reference's on the same weights and
    tokens; the prefill leaves every cache placed as ``cache_pspecs`` says
    and each step keeps it so."""
    tree, reference = reference_models[arch]
    one_device, _ = model_decode(arch, tree)
    for rank_out in world:
        got, placements = rank_out[("model", shape, arch)]
        for want in (one_device, reference):
            for i, (g, w) in enumerate(zip(got, want, strict=True)):
                torch.testing.assert_close(g, w, **DECODE_TOL, msg=f"step {i}")
        assert all(p == placements[0] for p in placements)
        for c in placements[0]:
            if "ssm" in c:
                assert c["ssm"]["state"][1].is_shard(1) and c["ssm"]["conv"][1].is_shard(2)
            if "attn" in c:
                assert c["attn"]["k"][1].is_shard(1)


def test_decode_collective_bytes_do_not_grow_with_the_cache():
    """The reduced granite decode step at 1x4 (dry run on meta): the same
    collective bytes a device with a cache of 64 and of 128 positions,
    since only the token's activations and the softmax's partial
    statistics move."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import ShapeDef
    from repro_torch.launch import dryrun

    cfg = registry.get("granite-3-8b").reduced()
    mesh = M.make_mesh((1, 4), ("data", "model"))
    recs = [dryrun.run_cell(cfg, ShapeDef("t", "decode", s, B), mesh, verbose=False) for s in (64, 128)]
    assert recs[0]["collective_traffic_per_device"] == recs[1]["collective_traffic_per_device"] > 0
    assert recs[0]["collective_ops"] == recs[1]["collective_ops"]
