"""``models.layers.flash_decode_attention`` and its dispatch in
``models.transformer.decode_step``: one-token attention against a KV
cache split over the mesh's ``model`` axis, combined by ``all_reduce``.

The reference's ``flash_decode_attention`` runs in a subprocess on 4
forced host devices (``tests/test_mesh_multidevice.py:16-25``) on 2x2 and
1x4 meshes; the port in a gloo world of 4 ranks through ``run_world`` on
the same numpy inputs and weights. Tolerances are the reference's own
(``tests/test_mesh_multidevice.py:190-191``): the output within atol 2e-5
of the reference's flash decode and of the plain decode, the written
cache within 1e-6. With ``pos`` in each shard in turn the new K/V lands in
the shard that owns ``pos`` and nowhere else."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
MESHES = ((2, 2), (1, 4))
POSITIONS = (3, 11, 21, 29)  # on 1x4 one in each 8-long shard; on 2x2 two in each half
B, S, D, H, KV, HD = 4, 32, 64, 8, 4, 16


def inputs(qk_norm: bool) -> dict:
    rng = np.random.default_rng(7 + qk_norm)
    out = {"wq": rng.normal(size=(D, H, HD)) / 8, "wk": rng.normal(size=(D, KV, HD)) / 8,
           "wv": rng.normal(size=(D, KV, HD)) / 8, "wo": rng.normal(size=(H, HD, D)) / np.sqrt(H * HD),
           "x": rng.normal(size=(B, 1, D)), "ck": rng.normal(size=(B, S, KV, HD)),
           "cv": rng.normal(size=(B, S, KV, HD))}
    if qk_norm:
        out["q_norm"] = rng.normal(0, 0.3, size=(HD,))
        out["k_norm"] = rng.normal(0, 0.3, size=(HD,))
    return {k: v.astype(np.float32) for k, v in out.items()}


REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ArchConfig
from repro.launch.mesh import make_mesh
from repro.models import layers as L

sys.path.insert(0, sys.argv[2])
from test_torch_flash_decode import MESHES, POSITIONS, inputs

out = {}
for qk in (False, True):
    cfg = ArchConfig("t", "dense", 2, 64, 8, 4, 16, 128, 256, qk_norm=qk,
                     param_dtype=jnp.float32, compute_dtype=jnp.float32, remat="none")
    a = inputs(qk)
    p = {k: jnp.asarray(a[k]) for k in ("wq", "wk", "wv", "wo")}
    if qk:
        p["q_norm"] = {"scale": jnp.asarray(a["q_norm"])}
        p["k_norm"] = {"scale": jnp.asarray(a["k_norm"])}
    x = jnp.asarray(a["x"])
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        spec = NamedSharding(mesh, P("data", "model", None, None))
        for pos in POSITIONS:
            cache = {"k": jax.device_put(jnp.asarray(a["ck"]), spec),
                     "v": jax.device_put(jnp.asarray(a["cv"]), spec)}
            y, c = L.flash_decode_attention(p, x, cache, pos, cfg=cfg, mesh=mesh)
            tag = f"{int(qk)}_{shape[0]}x{shape[1]}_{pos}"
            out[f"y_{tag}"] = np.asarray(y)
            out[f"k_{tag}"] = np.asarray(c["k"])
            out[f"v_{tag}"] = np.asarray(c["v"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "out.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), str(out),
                        str(Path(__file__).parent)], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT, stdin=subprocess.DEVNULL)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


def port_cfg(qk_norm: bool):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig("t", "dense", 2, D, H, KV, HD, 128, 256, qk_norm=qk_norm,
                      param_dtype=torch.float32, compute_dtype=torch.float32, remat="none")


def port_attention(qk_norm: bool):
    from repro_torch.models import layers as L

    a = inputs(qk_norm)
    p = L.Attention(port_cfg(qk_norm), "cpu")
    with torch.no_grad():
        for k in ("wq", "wk", "wv", "wo"):
            getattr(p, k).copy_(torch.from_numpy(a[k]))
        if qk_norm:
            p.q_norm.scale.copy_(torch.from_numpy(a["q_norm"]))
            p.k_norm.scale.copy_(torch.from_numpy(a["k_norm"]))
    return p, a


def flash_world(rank, world_size):
    """Every (qk_norm, mesh, pos) case on this rank: the output, the
    written cache (gathered whole) and whether this rank's block of it
    changed."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    out = {}
    for qk in (False, True):
        cfg = port_cfg(qk)
        p, a = port_attention(qk)
        x = torch.from_numpy(a["x"])
        for shape in MESHES:
            dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
            where = sh.Sharding(dm, sh.to_placements(("data", "model", None, None), dm))
            for pos in POSITIONS:
                cache = {k: sh.place(torch.from_numpy(a[f"c{k}"]).clone(), where) for k in "kv"}
                before = cache["k"].to_local().clone()
                with torch.no_grad():
                    y, c = L.flash_decode_attention(p, x, cache, pos, cfg=cfg, mesh=dm)
                changed = not torch.equal(before, c["k"].to_local())
                owner = dm.get_local_rank("model") == pos // (S // shape[1])
                out[(qk, shape, pos)] = (y.numpy(), c["k"].full_tensor().numpy(),
                                         c["v"].full_tensor().numpy(), changed, owner)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return M.run_world(flash_world, 4, "gloo", tmp_path_factory.mktemp("world"), timeout=TIMEOUT)


def plain(qk: bool, pos: int):
    """The port's plain decode on the whole cache (the reference's plain
    decode is held to it by ``tests/test_torch_lm.py``)."""
    from repro_torch.models import layers as L

    p, a = port_attention(qk)
    cache = {"k": torch.from_numpy(a["ck"]).clone(), "v": torch.from_numpy(a["cv"]).clone()}
    with torch.no_grad():
        y, c = L.decode_attention(p, torch.from_numpy(a["x"]), cache, pos, cfg=port_cfg(qk))
    return y.numpy(), c["k"].numpy(), c["v"].numpy()


CASES = [(qk, shape, pos) for qk in (False, True) for shape in MESHES for pos in POSITIONS]


@pytest.mark.parametrize("qk,shape,pos", CASES,
                         ids=[f"qk{int(q)}-{s[0]}x{s[1]}-pos{p}" for q, s, p in CASES])
def test_flash_decode_matches_reference_and_plain(world, reference, qk, shape, pos):
    tag = f"{int(qk)}_{shape[0]}x{shape[1]}_{pos}"
    want_y, want_k, want_v = plain(qk, pos)
    for rank_out in world:
        y, k, v, _, _ = rank_out[(qk, shape, pos)]
        np.testing.assert_allclose(y, reference[f"y_{tag}"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(y, want_y, atol=2e-5, rtol=0)
        np.testing.assert_allclose(k, reference[f"k_{tag}"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(v, reference[f"v_{tag}"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(k, want_k, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_new_kv_lands_only_in_the_owner_shard(world, shape):
    """For pos in each shard in turn: the rank whose sequence block holds
    pos changes its block of the cache, every other rank keeps its own;
    and of the whole cache only position pos differs from the input."""
    a = inputs(False)
    for pos in POSITIONS:
        for rank_out in world:
            _, k, v, changed, owner = rank_out[(False, shape, pos)]
            assert changed == owner, (pos, changed, owner)
            diff = np.nonzero((k != a["ck"]).any(axis=(0, 2, 3)))[0]
            assert diff.tolist() == [pos]


def decode_world(rank, world_size):
    """A reduced dense model with flash_decode on a 2x2 mesh through
    serve_decode.generate, against the same model without a mesh."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve_decode as sd
    from repro_torch.models import transformer as T

    cfg = registry.get("granite-3-8b").reduced().replace(flash_decode=True)
    dm = M.device_mesh(M.make_mesh((2, 2), ("data", "model")), "cpu")
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 12)))
    extras = {"mesh": dm}
    logits, caches = sd.prefill(cfg, model, prompt, max_len=20)
    plain_logits, plain_caches = sd.prefill(cfg, model, prompt, max_len=20)
    caches = T.shard_decode_caches(cfg, caches, extras)
    tok = torch.argmax(logits, -1)
    out = []
    for i in range(4):
        logits, caches = sd.decode_step(cfg, model, tok, caches, 12 + i, extras)
        plain_logits, plain_caches = sd.decode_step(cfg, model, tok, plain_caches, 12 + i)
        out.append((logits.numpy(), plain_logits.numpy()))
        tok = torch.argmax(plain_logits, -1)
    tokens = sd.generate(cfg, model, prompt, 6, extras), sd.generate(cfg, model, prompt, 6)
    return out, [t.numpy() for t in tokens], type(caches[0]["attn"]["k"]).__name__


def test_decode_step_dispatches_to_flash_decode(tmp_path):
    """decode_step with flash_decode and a mesh in extras decodes against
    DTensor caches (the sequence split over model) and gives the plain
    decode's logits within atol 2e-5; generate gives its tokens."""
    for steps, (flash_tokens, plain_tokens), kind in M.run_world(decode_world, 4, "gloo", tmp_path,
                                                                  timeout=TIMEOUT):
        assert kind == "DTensor"
        for got, want in steps:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(flash_tokens, plain_tokens)
