"""Port vs reference: the encoder-decoder (``models/encdec.py``, the
seamless-m4t-medium backbone) of the LM serving path, in float32 on the
CPU.

The reference's weights (``repro.models.encdec.init_params``, the encoder
and decoder stacked over their layers by ``jax.vmap``) are carried into
the port by ``interop.encdec_params_from_numpy``; the stub frames (B,
S_enc, d_model) and the tokens are made with numpy from a seed. The
tolerances are the reference's own (tests/test_models.py:89-101): the
encoder's memory, prefill logits and caches rtol = atol = 1e-4, decode
logits 1e-3.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry
from repro.launch import serve_decode as jserve
from repro.models import encdec as JED
from repro_torch.configs import registry
from repro_torch.interop import encdec_params_from_numpy
from repro_torch.launch import serve_decode
from repro_torch.models import encdec as ED
from test_torch_lm import _np, port_cfg

PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
NAME = "seamless-m4t-medium"
S_ENC, S_LEN, STEPS, BATCH = 20, 24, 6, 2


def _carried(seed=0):
    """(reference params, the port's EncDec holding them, reference cfg,
    port cfg). Every norm scale is moved off its zero init."""
    jcfg = jregistry.get(NAME).reduced()
    tree = jax.tree.map(np.asarray, JED.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        return a + rng.normal(0, 0.1, a.shape).astype(a.dtype) if path[-1].key == "scale" else a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    pcfg = port_cfg(jcfg)
    return jax.tree.map(jnp.asarray, tree), encdec_params_from_numpy(tree, pcfg, "cpu"), jcfg, pcfg


def _inputs(jcfg, seed=5, batch=BATCH, s_enc=S_ENC, s=S_LEN):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, s_enc, jcfg.d_model)).astype(np.float32)
    return frames, rng.integers(0, jcfg.vocab, (batch, s)).astype(np.int32)


def test_encode_matches_reference():
    """The encoder: non-causal self-attention with RoPE, then the MLP, over
    the stub frames; the memory within 1e-4."""
    jparams, model, jcfg, pcfg = _carried()
    frames, _ = _inputs(jcfg)
    want = JED.encode(jparams, jnp.asarray(frames), jcfg)
    got = ED.encode(model, torch.from_numpy(frames), pcfg)
    assert got.shape == (BATCH, S_ENC, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **PREFILL_TOL)
    # Non-causal: the first frame's memory sees the last frame.
    moved = frames.copy()
    moved[:, -1] += 1.0
    assert not torch.equal(ED.encode(model, torch.from_numpy(moved), pcfg)[:, 0], got[:, 0])


def test_forward_matches_reference():
    jparams, model, jcfg, pcfg = _carried()
    frames, toks = _inputs(jcfg)
    want = JED.forward(jparams, jnp.asarray(frames), jnp.asarray(toks), jcfg)
    got = ED.forward(model, torch.from_numpy(frames), torch.from_numpy(toks), pcfg)
    np.testing.assert_allclose(_np(got), _np(want), **PREFILL_TOL)


def _caches_close(jc, tc, tol):
    assert set(tc) == set(jc) == {"self", "cross"}
    for kind in ("self", "cross"):
        for kv in ("k", "v"):
            assert tuple(tc[kind][kv].shape) == tuple(jc[kind][kv].shape), (kind, kv)
            np.testing.assert_allclose(_np(tc[kind][kv]), _np(jc[kind][kv]), **tol, err_msg=f"{kind}.{kv}")


def test_prefill_and_decode_match_reference():
    """Prefill logits and the self and cross caches, then STEPS greedy
    decode steps (the self K/V written at each position, the cross K/V
    read as they are): logits within the reference's tolerances, the same
    greedy tokens, the caches again at the end."""
    jparams, model, jcfg, pcfg = _carried()
    frames, toks = _inputs(jcfg)
    max_len = S_LEN + STEPS
    jlog, jcache = jax.jit(lambda p, f, t: JED.prefill(p, f, t, jcfg, max_len=max_len))(
        jparams, jnp.asarray(frames), jnp.asarray(toks))
    tlog, tcache = ED.prefill(model, torch.from_numpy(frames), torch.from_numpy(toks), pcfg, max_len=max_len)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **PREFILL_TOL)
    _caches_close(jcache, tcache, PREFILL_TOL)
    cross_k = tcache["cross"]["k"].clone()

    jstep = jax.jit(lambda p, t, c, pos: JED.decode_step(p, t, c, pos, jcfg))
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)
    for i in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jlog, jcache = jstep(jparams, jtok, jcache, S_LEN + i)
        tlog, tcache = ED.decode_step(model, ttok, tcache, S_LEN + i, pcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **DECODE_TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _caches_close(jcache, tcache, DECODE_TOL)
    assert torch.equal(tcache["cross"]["k"], cross_k)


def test_init_cache_matches_reference_layout():
    jcfg = jregistry.get(NAME).reduced()
    cfg = port_cfg(jcfg)
    want = jax.tree.map(lambda a: tuple(a.shape), JED.init_cache(jcfg, BATCH, 30, S_ENC))
    got = {kind: {kv: tuple(t.shape) for kv, t in sub.items()}
           for kind, sub in ED.init_cache(cfg, BATCH, 30, S_ENC).items()}
    assert got == want


def test_decode_matches_forward_in_the_port():
    """The port's own oracle (the reference's test_encdec_decode_oracle,
    here over several steps): prefill's last logits equal forward's, each
    decode step's equal forward over the extended sequence."""
    cfg = registry.get(NAME).reduced()
    model = ED.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn((BATCH, 10, cfg.d_model), generator=gen)
    seq = torch.randint(0, cfg.vocab, (BATCH, 12), generator=gen)
    logits, caches = ED.prefill(model, frames, seq, cfg, max_len=16)
    torch.testing.assert_close(logits, ED.forward(model, frames, seq, cfg)[:, -1], **PREFILL_TOL)
    for i in range(4):
        nxt = torch.argmax(logits, -1)
        logits, caches = ED.decode_step(model, nxt, caches, 12 + i, cfg)
        seq = torch.cat([seq, nxt[:, None]], 1)
        torch.testing.assert_close(logits, ED.forward(model, frames, seq, cfg)[:, -1], **DECODE_TOL)


def test_generate_matches_reference():
    jparams, model, jcfg, pcfg = _carried(seed=1)
    frames, prompt = _inputs(jcfg, seed=6, s_enc=S_LEN)
    want = np.asarray(jserve.generate(jcfg, jparams, jnp.asarray(prompt), 4, {"frames": jnp.asarray(frames)}))
    got = serve_decode.generate(pcfg, model, torch.from_numpy(prompt), 4, {"frames": torch.from_numpy(frames)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_distributions_count_and_device_rule(monkeypatch):
    """``init_params``: the reference's distributions and parameter count
    (the full width's too, from ``jax.eval_shape``), the same weights for
    the same seed, cuda unless the caller asks for the CPU."""
    jcfg = jregistry.get(NAME).reduced()
    cfg = port_cfg(jcfg)
    model = ED.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(JED.init_params(jcfg, jax.random.PRNGKey(0))))
    d, h, hd, ff = cfg.d_model, cfg.q_heads, cfg.head_dim, cfg.d_ff
    blk = model.decoder[0]
    for w, std in ((model.embed, 1.0), (model.lm_head, d**-0.5), (blk.cross_attn.wq, d**-0.5),
                   (blk.self_attn.wo, (h * hd) ** -0.5), (model.encoder[1].mlp.w_out, ff**-0.5)):
        assert abs(float(w.std()) / std - 1) < 0.1
    assert not any(float(m.scale.abs().max()) for m in (blk.ln1, blk.lnx, model.enc_norm))
    again = ED.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))

    full = jax.eval_shape(lambda: JED.init_params(jregistry.get(NAME), jax.random.PRNGKey(0)))
    meta = ED.EncDec(registry.get(NAME), device="meta")
    assert sum(p.numel() for p in meta.parameters()) == sum(a.size for a in jax.tree.leaves(full)) \
        == 977_758_208

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ED.init_params(cfg)


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen", "unstacked", "no_decoder"])
def test_encdec_params_from_numpy_rejects(fault):
    jcfg = jregistry.get(NAME).reduced()
    tree = jax.tree.map(np.asarray, JED.init_params(jcfg, jax.random.PRNGKey(0)))
    if fault == "missing":
        del tree["decoder"]["cross_attn"]["wq"]
    elif fault == "extra":
        tree["encoder"]["attn"]["bias"] = np.zeros((2, 8), np.float32)
    elif fault == "misshapen":
        tree["decoder"]["lnx"]["scale"] = tree["decoder"]["lnx"]["scale"][:, :-1]
    elif fault == "unstacked":
        tree["encoder"]["ln1"]["scale"] = tree["encoder"]["ln1"]["scale"][0]
    else:
        del tree["decoder"]
    with pytest.raises(ValueError):
        encdec_params_from_numpy(tree, port_cfg(jcfg), "cpu")


def test_main_on_cpu(capsys):
    out = serve_decode.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--tokens", "3"])
    assert out.shape == (2, 3) and ((0 <= out) & (out < 512)).all()
    assert "generated (2, 3)" in capsys.readouterr().out
    frames = serve_decode.stub_extras(registry.get(NAME).reduced(), 2, 8,
                                      torch.Generator().manual_seed(0), "cpu")["frames"]
    assert frames.shape == (2, 8, 64)


def test_serve_alias_is_serve_decode():
    """``repro_torch.launch.serve``: the reference's deprecated alias of
    ``serve_decode``, warning on import."""
    import importlib
    import sys

    sys.modules.pop("repro_torch.launch.serve", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod = importlib.import_module("repro_torch.launch.serve")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert mod.generate is serve_decode.generate and mod.main is serve_decode.main
