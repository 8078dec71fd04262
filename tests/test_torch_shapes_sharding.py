"""``repro_torch.configs.shapes``, ``launch.mesh`` and ``models.sharding``
against the reference's ``repro.configs.shapes`` and
``repro.models.sharding``: the shapes and their applicability, the input
specs' shapes, dtypes and placements, the parameter counts of the meta
models, and every parameter's and cache tensor's placement on the
production meshes (the reference's spec with its leading stack dimension
dropped). The reference reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in with a numpy ``devices`` array serves
as its mesh."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.models import encdec as JED
from repro.models import sharding as jsh
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.configs import shapes
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as sh

ARCHS = registry.names()
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def ref_mesh(shape, axes):
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))


def spec_tuple(p) -> tuple:
    return tuple(p)


def flat_specs(tree) -> dict:
    """{path names: tuple} of a reference PartitionSpec tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = spec_tuple(leaf)
    return out


def flat_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


def ref_key(cfg, name: str):
    """The reference path of the leaf a port parameter is (a slice of), and
    whether that leaf is stacked."""
    head, *rest = name.split(".")
    if head == "layers":
        i, leaf = int(rest[0]), tuple(rest[1:])
        n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
        if i < n_pre:
            return ("prefix", str(i)) + leaf, False
        return ("groups", str((i - n_pre) % n_pat)) + leaf, True
    if head in ("encoder", "decoder"):
        return (head,) + tuple(rest[1:]), True
    return (head, *rest), False


def port_cache_items(cache):
    """((layer or None, path), tensor) of a port cache: a list of per-layer
    dicts (transformer) or the enc-dec's stacked dict."""
    if isinstance(cache, list):
        for i, layer in enumerate(cache):
            for mixer, kv in layer.items():
                for leaf, t in kv.items():
                    yield (i, (mixer, leaf)), t
    else:
        for part, kv in cache.items():
            for leaf, t in kv.items():
                yield (None, (part, leaf)), t


def ref_cache_key(cfg, layer, path):
    if layer is None:
        return path, False
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    if layer < n_pre:
        return ("prefix", str(layer)) + path, False
    return ("groups", str((layer - n_pre) % n_pat)) + path, True


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def test_shapes_and_constants_equal_the_reference():
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch) for k, v in shapes.SHAPES.items()} == \
        {k: (v.name, v.kind, v.seq_len, v.global_batch) for k, v in jshapes.SHAPES.items()}
    assert shapes.ENCDEC_PROMPT == jshapes.ENCDEC_PROMPT


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_equal_the_reference(name, shape):
    """Applicability, and every input's shape, dtype and placement on a 1x1
    mesh: the caches' per layer, the reference's stacked leaves with their
    repeat dimension dropped."""
    cfg, jcfg = registry.get(name), jregistry.get(name)
    sdef, jdef = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert shapes.applicable(cfg, sdef) == jshapes.applicable(jcfg, jdef)
    mesh = M.make_mesh((1, 1), ("data", "model"))
    args, specs = shapes.input_specs(cfg, sdef, mesh)
    jargs, jspecs = jshapes.input_specs(jcfg, jdef, ref_mesh((1, 1), ("data", "model")))
    assert set(args) == set(jargs)
    for key, t in args.items():
        if key == "caches":
            continue
        assert t.device.type == "meta"
        assert (tuple(t.shape), dtype_name(t.dtype)) == (jargs[key].shape, str(jargs[key].dtype))
        assert specs[key] == spec_tuple(jspecs[key])
    if "caches" not in args:
        return
    jleaves, jcspecs = flat_leaves(jargs["caches"]), flat_specs(jspecs["caches"])
    cspecs = dict(port_cache_items(specs["caches"]))
    seen = set()
    for (layer, path), t in port_cache_items(args["caches"]):
        key, stacked = ref_cache_key(cfg, layer, path)
        want = jleaves[key]
        want_shape = want.shape[1:] if stacked else want.shape
        assert (tuple(t.shape), dtype_name(t.dtype)) == (want_shape, str(want.dtype)), key
        want_spec = jcspecs[key][1:] if stacked else jcspecs[key]
        assert cspecs[(layer, path)] == want_spec, key
        seen.add(key)
    assert seen == set(jleaves)


@pytest.mark.parametrize("name", ARCHS)
def test_meta_model_counts_the_reference_tree(name):
    """The port's model on meta holds as many parameters as
    ``jax.eval_shape(init_params)``'s tree has elements."""
    cfg, jcfg = registry.get(name), jregistry.get(name)
    init = JED.init_params if jcfg.family == "encdec" else JT.init_params
    tree = jax.eval_shape(lambda: init(jcfg, jax.random.PRNGKey(0)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))
    model = dryrun.meta_model(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_placements_equal_the_reference(name, mesh_name):
    shape, axes = MESHES[mesh_name]
    cfg, jcfg = registry.get(name), jregistry.get(name)
    for fsdp in (False, True):
        cfg_f, jcfg_f = cfg.replace(fsdp=fsdp), jcfg.replace(fsdp=fsdp)
        init = JED.init_params if jcfg.family == "encdec" else JT.init_params
        tree = jax.eval_shape(lambda: init(jcfg_f, jax.random.PRNGKey(0)))
        want = flat_specs(jsh.make_pspecs(jcfg_f, ref_mesh(shape, axes), tree))
        got = sh.make_pspecs(cfg_f, M.make_mesh(shape, axes), dryrun.meta_model(cfg_f))
        used = set()
        for pname, spec in got.items():
            key, stacked = ref_key(cfg, pname)
            assert spec == (want[key][1:] if stacked else want[key]), (pname, fsdp)
            used.add(key)
        assert used == set(want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("batch", [128, 1])
def test_cache_placements_equal_the_reference(name, mesh_name, batch):
    shape, axes = MESHES[mesh_name]
    cfg, jcfg = registry.get(name), jregistry.get(name)
    s = 32_768
    if cfg.family == "encdec":
        from repro_torch.models import encdec as ED

        cache = ED.init_cache(cfg, batch, s, mem_len=s, device="meta")
        jcache = jax.eval_shape(lambda: JED.init_cache(jcfg, batch, s, mem_len=s))
    else:
        from repro_torch.models import transformer as T

        cache = T.init_cache(cfg, batch, s, device="meta")
        jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, batch, s))
    want = flat_specs(jsh.cache_pspecs(ref_mesh(shape, axes), jcache, batch))
    got = dict(port_cache_items(sh.cache_pspecs(M.make_mesh(shape, axes), cache, batch)))
    for (layer, path), spec in got.items():
        key, stacked = ref_cache_key(cfg, layer, path)
        assert spec == (want[key][1:] if stacked else want[key]), key


def test_batch_and_cache_pspec_equal_the_reference():
    for shape, axes in MESHES.values():
        rm, pm = ref_mesh(shape, axes), M.make_mesh(shape, axes)
        assert sh.batch_pspec(pm) == spec_tuple(jsh.batch_pspec(rm))
        for seq in (True, False):
            assert sh.cache_pspec(pm, seq) == spec_tuple(jsh.cache_pspec(rm, seq))


def test_per_device_bytes():
    cfg = registry.get("granite-3-8b")
    model = dryrun.meta_model(cfg)
    one = M.make_mesh((1, 1), ("data", "model"))
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    assert sh.per_device_bytes(model, sh.make_pspecs(cfg, one, model), one) == total
    mesh = M.make_production_mesh()
    specs = sh.make_pspecs(cfg, mesh, model)
    want = 0
    for n, p in model.named_parameters():
        cut = 16 if "model" in specs[n] else 1
        want += -(-p.numel() * p.element_size() // cut)
    assert sh.per_device_bytes(model, specs, mesh) == want < total
    cache = [{"attn": {"k": torch.empty((32, 64, 8, 128), device="meta")}}]
    cspecs = sh.cache_pspecs(mesh, cache, 32)  # batch over data (16), sequence over model (16)
    assert cspecs == [{"attn": {"k": ("data", "model", None, None)}}]
    assert sh.per_device_bytes(cache, cspecs, mesh) == 32 * 64 * 8 * 128 * 4 // 256


def test_meshes():
    assert M.make_production_mesh() == M.Mesh((16, 16), ("data", "model"))
    pod2 = M.make_production_mesh(multi_pod=True)
    assert (pod2.shape, pod2.axis_names, pod2.size) == ((2, 16, 16), ("pod", "data", "model"), 512)
    assert M.parse_mesh("1x1") == M.make_mesh((1, 1), ("data", "model"))
    assert M.parse_mesh("2x16x16") == pod2
    with pytest.raises(ValueError):
        M.parse_mesh("4")
    with pytest.raises(ValueError):
        M.make_mesh((2, 2), ("data",))
