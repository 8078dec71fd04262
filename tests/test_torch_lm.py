"""Port vs reference: the LM serving path (configs, layers, transformer,
serve_decode, ``interop.lm_params_from_numpy``), in float32 on the CPU.

The reference's parameters are carried into the port with
``lm_params_from_numpy``; inputs are made with numpy from a seed. The
tolerances are the reference's own: layers 2e-5 (test_band_attn_kernel.py),
prefill logits and caches rtol = atol = 1e-4 and decode logits 1e-3
(test_models.py:28-44). Windowed layers with ``block_local_attn`` go through
``banded_attention``, whose plain version runs here (the kernel, K5, on the
card: test_torch_kernels_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry
from repro.configs.base import BlockDef as JBlockDef
from repro.launch import serve_decode as jserve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as tb
from repro_torch.configs import registry
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels.band_attn import kernel as band_kernel
from repro_torch.launch import serve_decode
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

LAYER_TOL = dict(rtol=0.0, atol=2e-5)
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
_DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}

S, STEPS, BATCH = 40, 8, 2


def port_cfg(c) -> tb.ArchConfig:
    """The port's ``ArchConfig`` with every field of the reference's ``c``."""
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    for key in ("pattern", "prefix"):
        kw[key] = tuple(tb.BlockDef(**dataclasses.asdict(b)) for b in kw[key])
    for key in ("param_dtype", "compute_dtype"):
        kw[key] = _DTYPES[jnp.dtype(kw[key])]
    return tb.ArchConfig(**kw)


def gemma3_tiny():
    """gemma3-12b's shape at the reference's reduced() widths: 5 local
    layers (window 16) and 1 global per pattern, 12 layers, qk-norm, the
    banded path on; S = 40 > W."""
    return jregistry.get("gemma3-12b").reduced().replace(
        pattern=(JBlockDef(window=16),) * 5 + (JBlockDef(),), block_local_attn=True)


def _jax_cfg(name):
    return gemma3_tiny() if name == "gemma3-12b" else jregistry.get(name).reduced()


def _carried(jcfg, seed=0):
    """(reference params, the port's model holding them, port cfg). Every
    norm scale is moved off its zero init, so ``1 + scale`` is exercised."""
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        return a + rng.normal(0, 0.1, a.shape).astype(a.dtype) if path[-1].key == "scale" else a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    pcfg = port_cfg(jcfg)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, pcfg, "cpu"), pcfg


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


# -- configs ---------------------------------------------------------------------


def test_registry_lists_the_dense_configs_with_reference_fields():
    """The registry lists all ten of the reference's configs (the dense
    ones, enc-dec, VLM, MoE, SSM and hybrid), each field for field, and
    the port runs every one."""
    assert registry.names() == jregistry.names()
    for name in registry.names():
        want = port_cfg(jregistry.get(name))
        assert registry.get(name) == want
        assert registry.get(name).reduced() == port_cfg(jregistry.get(name).reduced())
        assert tb.unported(registry.get(name)) == []
    g = registry.get("gemma3-12b")
    assert g.num_repeats == 8 and g.layer_defs()[5].window is None and g.layer_defs()[0].window == 1024


@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b", "seamless-m4t-medium", "llama-3.2-vision-90b",
                                  "arctic-480b"])
def test_unported_configs_raise_naming_roadmap(name):
    """These four configs are ported (MoE, enc-dec, VLM), and so is
    ``flash_decode``: with it each config builds, and without a mesh in
    ``extras`` it decodes as the plain path does, as the reference's
    (``repro/models/transformer.py:272``: flash decode needs a mesh; its
    enc-dec decode has no such branch)."""
    cfg = port_cfg(jregistry.get(name).reduced())
    assert tb.unported(cfg) == []
    flash = cfg.replace(flash_decode=True)
    assert tb.unported(flash) == []
    gen = torch.Generator().manual_seed(0)
    model = serve_decode.init_params(flash, gen, "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    extras = serve_decode.stub_extras(cfg, 2, 8, gen, "cpu")
    want = serve_decode.generate(cfg, model, prompt, 4, extras)
    assert torch.equal(serve_decode.generate(flash, model, prompt, 4, extras), want)


@pytest.mark.parametrize("knob", ["flash_decode", "adam_moments_bf16", "use_adafactor"])
def test_unported_knobs_raise(knob):
    """Every knob is ported: ``flash_decode`` acts in decode given a mesh
    (``tests/test_torch_flash_decode.py``), the optimizer knobs in
    ``launch/train.py``; with each the model builds."""
    cfg = registry.get("granite-3-8b").reduced().replace(**{knob: True})
    assert tb.unported(cfg) == []
    assert T.count_params(T.init_params(cfg, device="cpu")) > 0


# -- layers ------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    scale = rng.normal(0, 0.3, 16).astype(np.float32)
    p = L.RMSNorm(16, torch.float32)
    with torch.no_grad():
        p.scale.copy_(torch.from_numpy(scale))
    for eps in (1e-6, 1e-5):
        want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), eps)
        np.testing.assert_allclose(_np(L.rmsnorm(p, torch.from_numpy(x), eps)), _np(want), **LAYER_TOL)


def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("branch", ["full_causal", "window_masked", "block_local", "gqa_repeat_kv"])
def test_attention_branches_match_reference(branch):
    # gqa_repeat_kv has no effect in the port: its grouped einsum must match
    # the reference's repeated-K/V path.
    jcfg = gemma3_tiny()
    window = None if branch in ("full_causal", "gqa_repeat_kv") else 16
    jcfg = jcfg.replace(block_local_attn=branch == "block_local", gqa_repeat_kv=branch == "gqa_repeat_kv")
    jparams, model, pcfg = _carried(jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["attn"])  # layer 0
    x = np.random.default_rng(3).standard_normal((BATCH, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (BATCH, S))
    want = JL.attention(jp, jnp.asarray(x), cfg=jcfg, positions=jnp.asarray(pos), window=window)
    with torch.inference_mode():
        got = L.attention(model.layers[0].attn, torch.from_numpy(x), cfg=pcfg,
                          positions=torch.from_numpy(pos.copy()), window=window)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_block_local_equals_window_masked_in_the_port():
    """The banded path and the plain masked path compute the same values."""
    jparams, model, pcfg = _carried(gemma3_tiny())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((BATCH, S, pcfg.d_model)).astype(np.float32))
    pos = torch.arange(S, dtype=torch.int32).expand(BATCH, S)
    with torch.inference_mode():
        a = L.attention(model.layers[0].attn, x, cfg=pcfg, positions=pos, window=16)
        b = L.attention(model.layers[0].attn, x, cfg=pcfg.replace(block_local_attn=False),
                        positions=pos, window=16)
    torch.testing.assert_close(a, b, rtol=0.0, atol=2e-5)


# -- the model --------------------------------------------------------------------


def _caches_close(jcache, tcache, cfg):
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    assert len(tcache) == cfg.num_layers
    for j, grp in enumerate(jcache["groups"]):
        for r in range(cfg.num_repeats):
            for kv in ("k", "v"):
                got = tcache[n_pre + r * n_pat + j]["attn"][kv]
                np.testing.assert_allclose(_np(got), _np(grp["attn"][kv][r]), **PREFILL_TOL,
                                           err_msg=f"layer {n_pre + r * n_pat + j} {kv}")


@pytest.mark.parametrize("name", ["gemma3-12b", "granite-3-8b", "mistral-nemo-12b", "command-r-35b"])
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and caches, then STEPS greedy decode steps: logits
    within the reference's tolerances and the same greedy tokens."""
    jcfg = _jax_cfg(name)
    jparams, model, pcfg = _carried(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (BATCH, S)).astype(np.int32)
    max_len = S + STEPS
    jlog, jcache = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, max_len=max_len))(jparams, jnp.asarray(toks))
    before = band_kernel.banded_attention_kernel.launches
    tlog, tcache = T.prefill(model, torch.from_numpy(toks), pcfg, max_len=max_len)
    assert band_kernel.banded_attention_kernel.launches == before
    np.testing.assert_allclose(_np(tlog), _np(jlog), **PREFILL_TOL)
    _caches_close(jcache, tcache, jcfg)

    jstep = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)
    for i in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jlog, jcache = jstep(jparams, jtok, jcache, S + i)
        tlog, tcache = T.decode_step(model, ttok, tcache, S + i, pcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **DECODE_TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_decode_matches_forward_in_the_port():
    """The port's own oracle: prefill's last logits equal forward's, and
    each decode step's logits equal forward over the extended sequence
    (the ring caches of the windowed layers wrap after 16 steps)."""
    cfg = port_cfg(gemma3_tiny()).replace(num_layers=6)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    seq = torch.randint(0, cfg.vocab, (BATCH, 20), generator=gen)
    steps = 14
    logits, caches = T.prefill(model, seq, cfg, max_len=20 + steps)
    torch.testing.assert_close(logits, T.forward(model, seq, cfg)[:, -1], **PREFILL_TOL)
    zeros = T.init_cache(cfg, BATCH, 20 + steps)
    assert [{kv: t.shape for kv, t in c["attn"].items()} for c in zeros] == \
        [{kv: t.shape for kv, t in c["attn"].items()} for c in caches]
    for i in range(steps):
        nxt = torch.argmax(logits, -1)
        logits, caches = T.decode_step(model, nxt, caches, 20 + i, cfg)
        seq = torch.cat([seq, nxt[:, None]], 1)
        torch.testing.assert_close(logits, T.forward(model, seq, cfg)[:, -1], **DECODE_TOL)


def test_init_params_distributions_and_count():
    jcfg = jregistry.get("granite-3-8b").reduced()
    cfg = port_cfg(jcfg)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert T.count_params(model) == JT.count_params(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    blk = model.layers[0]
    d, h, hd, ff = cfg.d_model, cfg.q_heads, cfg.head_dim, cfg.d_ff
    for w, std in ((model.embed, 1.0), (model.lm_head, d**-0.5), (blk.attn.wq, d**-0.5),
                   (blk.attn.wo, (h * hd) ** -0.5), (blk.mlp.w_out, ff**-0.5)):
        assert abs(float(w.std()) / std - 1) < 0.1
    assert not any(float(n.abs().max()) for n in (blk.ln1.scale, blk.ln2.scale, model.final_norm.scale))
    again = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_init_params_runs_on_cuda_unless_asked(monkeypatch):
    """The entry points' device rule: cuda by default, and an error naming
    ``device='cpu'`` when there is none; the CPU only on request."""
    cfg = registry.get("granite-3-8b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    model = T.init_params(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    seeded = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), seeded.parameters()))


# -- interop -----------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen", "unstacked"])
def test_lm_params_from_numpy_rejects(fault):
    jcfg = gemma3_tiny()
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    if fault == "missing":
        del tree["groups"][2]["attn"]["k_norm"]
    elif fault == "extra":
        tree["groups"][0]["attn"]["bias"] = np.zeros((2, 8), np.float32)
    elif fault == "misshapen":
        tree["lm_head"] = tree["lm_head"][:, :-1]
    elif fault == "unstacked":
        tree["groups"][1]["ln1"]["scale"] = tree["groups"][1]["ln1"]["scale"][0]
    with pytest.raises(ValueError):
        lm_params_from_numpy(tree, port_cfg(jcfg), "cpu")


# -- launch ------------------------------------------------------------------------


def test_generate_matches_reference():
    jcfg = gemma3_tiny()
    jparams, model, pcfg = _carried(jcfg, seed=1)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, (BATCH, S)).astype(np.int32)
    want = np.asarray(jserve.generate(jcfg, jparams, jnp.asarray(prompt), 4))
    got = serve_decode.generate(pcfg, model, torch.from_numpy(prompt), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_main_on_cpu(capsys):
    out = serve_decode.main(["--arch", "gemma3-12b", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--tokens", "3"])
    assert out.shape == (2, 3) and ((0 <= out) & (out < 512)).all()
    assert "generated (2, 3)" in capsys.readouterr().out


def test_main_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_decode.main(["--arch", "gemma3-12b"])
