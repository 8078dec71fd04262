"""Port vs reference: cross-attention (``models/layers.py`` ``attention``
with ``kv_x``, ``cross_decode_attention``) and the VLM family of the LM
serving path (llama-3.2-vision-90b: four self-attention layers, then one
cross-attention layer to the image patches), in float32 on the CPU.

The reference's weights are carried into the port by
``interop.lm_params_from_numpy``; the stub memory (B, num_patches,
d_model) and the tokens are made with numpy from a seed. The tolerances
are the reference's own: layers 2e-5 (as tests/test_torch_lm.py), prefill
logits and caches rtol = atol = 1e-4 and decode logits 1e-3
(tests/test_models.py:28-44).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry
from repro.launch import serve_decode as jserve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.launch import serve_decode
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_lm import _carried, _np, port_cfg
from test_torch_ssm import _caches_close

LAYER_TOL = dict(rtol=0.0, atol=2e-5)
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
NAME = "llama-3.2-vision-90b"
S_LEN, STEPS, BATCH = 24, 6, 2
CROSS = 4  # the pattern's cross-attention position (layers 4 and 9)


def _memory(jcfg, seed=11, batch=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (batch, jcfg.num_patches, jcfg.d_model)).astype(np.float32)


def test_cross_attention_matches_reference():
    """A cross layer's prefill attention: K/V from the memory, no mask, no
    RoPE, against ``repro.models.layers.attention(kv_x=...)``; its
    ``return_kv`` keys and values are the memory's projections."""
    jcfg = jregistry.get(NAME).reduced()
    jparams, model, pcfg = _carried(jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][CROSS]["attn"])
    p = model.layers[CROSS].attn
    x = np.random.default_rng(3).standard_normal((BATCH, S_LEN, jcfg.d_model)).astype(np.float32)
    mem = _memory(jcfg)
    pos = np.broadcast_to(np.arange(S_LEN, dtype=np.int32), (BATCH, S_LEN)).copy()
    want = JL.attention(jp, jnp.asarray(x), cfg=jcfg, positions=jnp.asarray(pos),
                        kv_x=jnp.asarray(mem), causal=False, use_rope=False)
    with torch.inference_mode():
        got, k, v = L.attention(p, torch.from_numpy(x), cfg=pcfg, positions=torch.from_numpy(pos),
                                kv_x=torch.from_numpy(mem), causal=False, use_rope=False,
                                return_kv=True)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    assert k.shape == v.shape == (BATCH, jcfg.num_patches, jcfg.kv_heads, jcfg.head_dim)
    np.testing.assert_allclose(_np(k), np.einsum("btd,dhk->bthk", mem, np.asarray(jp["wk"])),
                               **LAYER_TOL)
    # The queries' positions do not enter: cross-attention rotates nothing.
    with torch.inference_mode():
        shifted = L.attention(p, torch.from_numpy(x), cfg=pcfg, positions=torch.from_numpy(pos + 100),
                              kv_x=torch.from_numpy(mem), causal=False, use_rope=False)
    assert torch.equal(shifted, got)


def test_cross_decode_equals_cross_attention_of_one_token():
    """``cross_decode_attention`` on the cached memory K/V computes what
    the prefill's cross-attention computes for the same query token."""
    cfg = registry.get(NAME).reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = model.layers[CROSS].attn
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((BATCH, 5, cfg.d_model), generator=gen)
    mem = torch.randn((BATCH, cfg.num_patches, cfg.d_model), generator=gen)
    pos = torch.arange(5, dtype=torch.int32).expand(BATCH, 5)
    with torch.inference_mode():
        full, k, v = L.attention(p, x, cfg=cfg, positions=pos, kv_x=mem, causal=False, use_rope=False,
                                 return_kv=True)
        for i in range(5):
            one = L.cross_decode_attention(p, x[:, i:i + 1], {"k": k, "v": v}, cfg=cfg)
            torch.testing.assert_close(one, full[:, i:i + 1], rtol=0.0, atol=2e-6)


def test_prefill_and_decode_match_reference():
    """Prefill logits and caches (the self layers' K/V and the cross
    layers' memory K/V, ref transformer.py:243-247, 356-361), then STEPS
    greedy decode steps reading the cross K/V from the cache: logits
    within the reference's tolerances, the same greedy tokens, and the
    caches again at the end (the cross K/V unchanged by the steps)."""
    jcfg = jregistry.get(NAME).reduced()
    jparams, model, pcfg = _carried(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (BATCH, S_LEN)).astype(np.int32)
    mem = _memory(jcfg)
    jext, text = {"memory": jnp.asarray(mem)}, {"memory": torch.from_numpy(mem)}
    max_len = S_LEN + STEPS
    jlog, jcache = jax.jit(lambda p, t, e: JT.prefill(p, t, jcfg, e, max_len=max_len))(
        jparams, jnp.asarray(toks), jext)
    tlog, tcache = T.prefill(model, torch.from_numpy(toks), pcfg, text, max_len=max_len)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **PREFILL_TOL)
    _caches_close(jcache, tcache, jcfg, PREFILL_TOL)
    assert [set(c) for c in tcache] == [{"cross"} if i % 5 == CROSS else {"attn"} for i in range(4 * 2 + 2)]
    cross_before = [c["cross"]["k"].clone() for c in tcache if "cross" in c]

    jstep = jax.jit(lambda p, t, c, pos, e: JT.decode_step(p, t, c, pos, jcfg, e))
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)
    for i in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jlog, jcache = jstep(jparams, jtok, jcache, S_LEN + i, jext)
        tlog, tcache = T.decode_step(model, ttok, tcache, S_LEN + i, pcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **DECODE_TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _caches_close(jcache, tcache, jcfg, DECODE_TOL)
    assert all(torch.equal(a, c["cross"]["k"]) for a, c in zip(cross_before, [c for c in tcache if "cross" in c]))


def test_init_cache_matches_reference_layout():
    """``init_cache`` has the reference's per-layer layout
    (``init_block_cache``: a (B, num_patches, KV, hd) cross K/V for a
    cross layer, a (B, max_len, KV, hd) K/V for a self layer) and
    ``prefill``'s."""
    jcfg = jregistry.get(NAME).reduced()
    cfg = port_cfg(jcfg)
    jc = JT.init_cache(jcfg, BATCH, 30)
    want = []
    for j, bd in enumerate(jcfg.pattern * jcfg.num_repeats):
        grp = jc["groups"][j % len(jcfg.pattern)]
        want.append({kind: {key: tuple(a.shape[1:]) for key, a in sub.items()} for kind, sub in grp.items()})
    got = [{kind: {key: tuple(t.shape) for key, t in sub.items()} for kind, sub in c.items()}
           for c in T.init_cache(cfg, BATCH, 30)]
    assert got == want
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    mem = torch.randn((BATCH, cfg.num_patches, cfg.d_model), generator=gen)
    _, caches = T.prefill(model, torch.randint(0, cfg.vocab, (BATCH, 12), generator=gen), cfg,
                          {"memory": mem}, max_len=30)
    assert [{kind: {key: tuple(t.shape) for key, t in sub.items()} for kind, sub in c.items()}
            for c in caches] == want


def test_decode_matches_forward_in_the_port():
    """The port's own oracle (the reference's test_vlm_decode_oracle):
    prefill's last logits equal forward's, each decode step's logits equal
    forward over the extended sequence with the same memory."""
    cfg = registry.get(NAME).reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    seq = torch.randint(0, cfg.vocab, (BATCH, 16), generator=gen)
    extras = {"memory": torch.randn((BATCH, cfg.num_patches, cfg.d_model), generator=gen)}
    logits, caches = T.prefill(model, seq, cfg, extras, max_len=16 + 3)
    torch.testing.assert_close(logits, T.forward(model, seq, cfg, extras)[:, -1], **PREFILL_TOL)
    for i in range(3):
        nxt = torch.argmax(logits, -1)
        logits, caches = T.decode_step(model, nxt, caches, 16 + i, cfg)
        seq = torch.cat([seq, nxt[:, None]], 1)
        torch.testing.assert_close(logits, T.forward(model, seq, cfg, extras)[:, -1], **DECODE_TOL)


def test_generate_matches_reference():
    jcfg = jregistry.get(NAME).reduced()
    jparams, model, pcfg = _carried(jcfg, seed=1)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, (BATCH, S_LEN)).astype(np.int32)
    mem = _memory(jcfg, seed=12)
    want = np.asarray(jserve.generate(jcfg, jparams, jnp.asarray(prompt), 4, {"memory": jnp.asarray(mem)}))
    got = serve_decode.generate(pcfg, model, torch.from_numpy(prompt), 4, {"memory": torch.from_numpy(mem)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_registry_config_builds_the_reference_tree():
    """The full-width config: the port's parameter names and shapes for the
    first pattern period are the reference's (``jax.eval_shape``), and the
    count is the full model's."""
    jcfg = jregistry.get(NAME)
    cfg = registry.get(NAME)
    assert cfg == port_cfg(jcfg)
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "groups":
            keys, shape = ["layers", keys[1]] + keys[2:], leaf.shape[1:]
        else:
            shape = leaf.shape
        want[".".join(map(str, keys))] = tuple(shape)
    model = T.Transformer(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()
           if not n.startswith("layers.") or int(n.split(".")[1]) < len(cfg.pattern)}
    assert got == want
    assert T.count_params(model) == JT.count_params(shapes)
    assert T.count_params(T.Transformer(cfg.replace(num_layers=5), device="meta")) == 6_379_626_496


def test_main_on_cpu(capsys):
    out = serve_decode.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--tokens", "3"])
    assert out.shape == (2, 3) and ((0 <= out) & (out < 512)).all()
    assert "generated (2, 3)" in capsys.readouterr().out


def test_stub_memory_is_seeded_normals():
    """``serve_decode.stub_extras``: the VLM's memory (B, num_patches, d)
    from the generator, the same for the same seed; none for a decoder-only
    family."""
    cfg = registry.get(NAME).reduced()
    a = serve_decode.stub_extras(cfg, 3, 8, torch.Generator().manual_seed(4), "cpu")
    b = serve_decode.stub_extras(cfg, 3, 8, torch.Generator().manual_seed(4), "cpu")
    assert set(a) == {"memory"} and a["memory"].shape == (3, cfg.num_patches, cfg.d_model)
    assert torch.equal(a["memory"], b["memory"])
    assert abs(float(a["memory"].std()) - 1) < 0.1
    assert serve_decode.stub_extras(registry.get("granite-3-8b").reduced(), 3, 8,
                                    torch.Generator().manual_seed(4), "cpu") is None


@pytest.mark.parametrize("fault", ["missing_cross_leaf", "misshapen_cross_wk"])
def test_lm_params_from_numpy_rejects_cross(fault):
    from repro_torch.interop import lm_params_from_numpy

    jcfg = jregistry.get(NAME).reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    attn = tree["groups"][CROSS]["attn"]
    if fault == "missing_cross_leaf":
        del attn["wv"]
    else:
        attn["wk"] = attn["wk"][..., :-1]
    with pytest.raises(ValueError):
        lm_params_from_numpy(tree, port_cfg(jcfg), "cpu")


def test_reference_cross_decode_skips_qk_norm():
    """A divergence of the reference, not of the port (ROADMAP queue 3):
    its decode step of a cross layer applies no ``q_norm``/``k_norm``
    while its prefill's ``attention`` applies both, so with ``qk_norm`` a
    VLM's decode logits leave ``forward``'s. No config of the registry
    sets ``qk_norm`` with a cross layer; the port's decode follows the
    reference (no ``q_norm``)."""
    assert not any(c.qk_norm and any(bd.mixer == "cross_attn" for bd in c.pattern + c.prefix)
                   for c in map(registry.get, registry.names()))
    jcfg = jregistry.get(NAME).reduced().replace(qk_norm=True)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.5 if path[-1].key == "scale" else a, params)
    toks = jnp.asarray(np.random.default_rng(1).integers(0, jcfg.vocab, (BATCH, 12)), jnp.int32)
    ext = {"memory": jnp.asarray(_memory(jcfg))}
    lg, cache = JT.prefill(params, toks, jcfg, ext, max_len=13)
    nxt = jnp.argmax(lg, -1).astype(jnp.int32)
    step, _ = JT.decode_step(params, nxt, cache, 12, jcfg, ext)
    full = JT.forward(params, jnp.concatenate([toks, nxt[:, None]], 1), jcfg, ext)[:, -1]
    assert float(jnp.abs(step - full).max()) > 1e-2
