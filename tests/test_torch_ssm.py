"""Port vs reference: the Mamba-2 SSD mixer (``models/ssm.py``) and the SSM
and hybrid families of the LM serving path (mamba2-780m, hymba-1.5b), in
float32 on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages; a model's weights are the reference's ``init_params``, carried
into the port by ``interop.lm_params_from_numpy``. The tolerances are the
reference's own (tests/test_models.py): the SSD's outputs and states atol
1e-4 (l.103-134), prefill logits and caches rtol = atol = 1e-4 and decode
logits 1e-3 (l.28-44). The reference carries the state across chunks with
``lax.associative_scan``, the port with a sequential float32 loop: the two
differ by rounding only.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry
from repro.configs.base import BlockDef as JBlockDef
from repro.launch import serve_decode as jserve
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve_decode
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from test_torch_lm import _np, port_cfg

SSD_TOL = dict(rtol=0.0, atol=1e-4)
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)

S_LEN, STEPS, BATCH = 40, 8, 2


def ssd_cfgs(groups: int = 1, chunk: int = 8, conv: int = 4):
    """The reference's SSD test shape (tests/test_models.py:103-113), as a
    (reference, port) pair of configs: d_model 32, d_inner 64, 4 heads of
    16, N = 8, Q = chunk, in float32."""
    kw = dict(d_model=32, ssm_expand=2, ssm_head_dim=16, ssm_state=8, ssm_groups=groups,
              ssm_conv=conv, ssm_chunk=chunk)
    return (types.SimpleNamespace(**kw, param_dtype=jnp.float32, compute_dtype=jnp.float32),
            types.SimpleNamespace(**kw, param_dtype=torch.float32, compute_dtype=torch.float32))


def ssd_params(pcfg, seed=0):
    """(reference leaves, the port's SSD holding them). Every leaf is
    moved off its init (A != -1, dt_bias, D, conv_b and the norm scale
    non-trivial), so each enters the comparison."""
    rng = np.random.default_rng(seed)
    mod = S.SSD(pcfg)
    tree = {}
    for name, p in mod.named_parameters():
        if name in ("in_proj", "conv_w", "out_proj"):
            a = rng.standard_normal(p.shape) * p.shape[0] ** -0.5
        elif name == "a_log":
            a = rng.normal(0.0, 0.5, p.shape)
        elif name == "d_skip":
            a = 1.0 + rng.normal(0.0, 0.3, p.shape)
        else:  # conv_b, dt_bias, norm.scale
            a = rng.normal(0.0, 0.3, p.shape)
        a = a.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.from_numpy(a))
        leaf = tree
        *path, last = name.split(".")
        for key in path:
            leaf = leaf.setdefault(key, {})
        leaf[last] = jnp.asarray(a)
    return tree, mod


def _x(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _carried(jcfg, seed=0):
    """(reference params, the port's model holding them, port cfg). Norm
    scales, A, dt_bias, D and conv_b are moved off their init."""
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        key = path[-1].key
        if key in ("scale", "a_log", "dt_bias", "conv_b"):
            return a + rng.normal(0, 0.3, a.shape).astype(a.dtype)
        if key == "d_skip":
            return a * (1 + rng.normal(0, 0.3, a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    pcfg = port_cfg(jcfg)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, pcfg, "cpu"), pcfg


def hymba_banded():
    """hymba-1.5b at the reference's reduced() widths with its windowed
    layers at W = 8 and the banded path on: at S = 40 > W, two of its three
    layers go through ``banded_attention`` (K5's plain version here)."""
    return jregistry.get("hymba-1.5b").reduced().replace(
        pattern=(JBlockDef(mixer="hybrid", window=8, ffn="dense"),), block_local_attn=True)


MODELS = {
    "mamba2-780m": lambda: jregistry.get("mamba2-780m").reduced(),
    "hymba-1.5b": lambda: jregistry.get("hymba-1.5b").reduced(),
    "hymba-1.5b-banded": hymba_banded,
}


# -- the SSD mixer ------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("seq", [24, 21, 5])
def test_ssd_matches_reference(seq, groups):
    """Outputs, final state and conv tail at S a multiple of Q (24) and not
    (21, 5: padded to 24 and 8), with one and two groups of B/C."""
    jcfg, pcfg = ssd_cfgs(groups)
    jp, mod = ssd_params(pcfg, seed=seq + groups)
    x = _x((2, seq, 32), seed=seq)
    jy, (jstate, jtail) = JS.ssd(jp, jnp.asarray(x), jcfg, return_final_state=True)
    with torch.inference_mode():
        y, (state, tail) = S.ssd(mod, torch.from_numpy(x), pcfg, return_final_state=True)
    assert y.shape == (2, seq, 32) and state.shape == (2, 4, 8, 16) \
        and tail.shape == (2, 3, 64 + 16 * groups)
    np.testing.assert_allclose(_np(y), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(_np(state), _np(jstate), **SSD_TOL)
    np.testing.assert_allclose(_np(tail), _np(jtail), **SSD_TOL)
    with torch.inference_mode():
        alone = S.ssd(mod, torch.from_numpy(x), pcfg)
    assert torch.equal(alone, y)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_decode_matches_reference(groups):
    """Four decode steps from a non-zero cache: outputs and the cache."""
    jcfg, pcfg = ssd_cfgs(groups)
    jp, mod = ssd_params(pcfg, seed=7)
    rng = np.random.default_rng(8)
    state = (0.3 * rng.standard_normal((2, 4, 8, 16))).astype(np.float32)
    conv = (0.3 * rng.standard_normal((2, 3, 64 + 2 * groups * 8))).astype(np.float32)
    jcache = {"state": jnp.asarray(state), "conv": jnp.asarray(conv)}
    cache = {"state": torch.from_numpy(state.copy()), "conv": torch.from_numpy(conv.copy())}
    x = _x((2, 4, 32), seed=9)
    for t in range(4):
        jy, jcache = JS.ssd_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        with torch.inference_mode():
            y, cache2 = S.ssd_decode(mod, torch.from_numpy(x[:, t:t + 1]), cache, pcfg)
        assert cache2 is cache
        np.testing.assert_allclose(_np(y), _np(jy), **SSD_TOL, err_msg=f"step {t}")
        for key in ("state", "conv"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **SSD_TOL,
                                       err_msg=f"step {t} {key}")


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("seq", [24, 13])
def test_ssd_chunked_equals_sequential_in_the_port(seq, groups):
    """The port's chunked form against its own token-by-token recurrence
    from the zero cache (the reference's test_ssd_chunked_equals_sequential),
    outputs, state and conv ring."""
    _, pcfg = ssd_cfgs(groups)
    _, mod = ssd_params(pcfg, seed=11)
    x = torch.from_numpy(_x((2, seq, 32), seed=12))
    with torch.inference_mode():
        y, (state, tail) = S.ssd(mod, x, pcfg, return_final_state=True)
        cache = S.init_ssd_cache(pcfg, 2, torch.float32)
        ys = [S.ssd_decode(mod, x[:, t:t + 1], cache, pcfg)[0] for t in range(seq)]
    torch.testing.assert_close(torch.cat(ys, 1), y, **SSD_TOL)
    torch.testing.assert_close(cache["state"], state, **SSD_TOL)
    torch.testing.assert_close(cache["conv"], tail, **SSD_TOL)


@pytest.mark.parametrize("seq", [1, 2, 3])
def test_short_prompt_decodes_as_the_recurrence(seq):
    """A prompt shorter than K - 1 = 3 tokens: the port's conv tail is
    left-padded with zeros, so prefill + decode equals the token-by-token
    recurrence from the zero cache. The reference's tail comes out with
    fewer than K - 1 rows there (``xbc_raw[:, s-(K-1):s]`` with a negative
    start), and its next decode step differs (ROADMAP, queue 3)."""
    jcfg, pcfg = ssd_cfgs()
    jp, mod = ssd_params(pcfg, seed=13)
    x = torch.from_numpy(_x((2, seq + 4, 32), seed=14))
    with torch.inference_mode():
        _, (state, tail) = S.ssd(mod, x[:, :seq], pcfg, return_final_state=True)
        cache = {"state": state, "conv": tail}
        after = [S.ssd_decode(mod, x[:, t:t + 1], cache, pcfg)[0] for t in range(seq, seq + 4)]
        rec = S.init_ssd_cache(pcfg, 2, torch.float32)
        want = [S.ssd_decode(mod, x[:, t:t + 1], rec, pcfg)[0] for t in range(seq + 4)][seq:]
    assert tail.shape == (2, 3, 80)
    torch.testing.assert_close(torch.cat(after, 1), torch.cat(want, 1), **SSD_TOL)
    _, (_, jtail) = JS.ssd(jp, jnp.asarray(x[:, :seq].numpy()), jcfg, return_final_state=True)
    assert (jtail.shape[1] < 3) == (seq < 3)


def test_ssd_masked_exponent_stays_finite():
    """Strong decay (A = -e^4 with large dt) makes exp(ca_i - ca_j)
    overflow above the diagonal; the where keeps the outputs finite and
    equal to the reference's."""
    jcfg, pcfg = ssd_cfgs(chunk=16)
    jp, mod = ssd_params(pcfg, seed=15)
    big = np.full(4, 4.0, np.float32)
    jp["a_log"], jp["dt_bias"] = jnp.asarray(big), jnp.asarray(big)
    with torch.no_grad():
        mod.a_log.fill_(4.0)
        mod.dt_bias.fill_(4.0)
    x = _x((2, 16, 32), seed=16)
    with torch.inference_mode():
        y = S.ssd(mod, torch.from_numpy(x), pcfg)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(_np(y), _np(JS.ssd(jp, jnp.asarray(x), jcfg)), **SSD_TOL)


# -- the models -----------------------------------------------------------------------


def _caches_close(jcache, tcache, cfg, tol):
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    assert len(tcache) == cfg.num_layers
    pairs = [(i, c) for i, c in enumerate(jcache["prefix"])]
    pairs += [(n_pre + r * n_pat + j, jax.tree.map(lambda a, r=r: a[r], grp))
              for j, grp in enumerate(jcache["groups"]) for r in range(cfg.num_repeats)]
    for i, jc in pairs:
        assert set(tcache[i]) == set(jc), (i, set(tcache[i]), set(jc))
        for kind, sub in jc.items():
            for key, want in sub.items():
                np.testing.assert_allclose(_np(tcache[i][kind][key]), _np(want), **tol,
                                           err_msg=f"layer {i} {kind}.{key}")


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_reference(name, monkeypatch):
    """Prefill logits and caches (K/V rings, SSD states and conv tails),
    then STEPS greedy decode steps (past the W = 8 ring in the banded case):
    logits within the reference's tolerances, the same greedy tokens and,
    at the end, the caches."""
    jcfg = MODELS[name]()
    jparams, model, pcfg = _carried(jcfg)
    calls = []

    def counting(q, k, v, window, _inner=L.banded_attention):
        calls.append(window)
        return _inner(q, k, v, window)

    monkeypatch.setattr(L, "banded_attention", counting)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (BATCH, S_LEN)).astype(np.int32)
    max_len = S_LEN + STEPS
    jlog, jcache = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, max_len=max_len))(jparams, jnp.asarray(toks))
    tlog, tcache = T.prefill(model, torch.from_numpy(toks), pcfg, max_len=max_len)
    assert calls == ([8, 8] if name.endswith("banded") else [])
    np.testing.assert_allclose(_np(tlog), _np(jlog), **PREFILL_TOL)
    _caches_close(jcache, tcache, jcfg, PREFILL_TOL)

    jstep = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)
    for i in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jlog, jcache = jstep(jparams, jtok, jcache, S_LEN + i)
        tlog, tcache = T.decode_step(model, ttok, tcache, S_LEN + i, pcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **DECODE_TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _caches_close(jcache, tcache, jcfg, DECODE_TOL)
    assert len(calls) == (2 if name.endswith("banded") else 0)  # none in decode


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_matches_forward_in_the_port(name):
    """The port's own oracle: prefill's last logits equal forward's, and
    each decode step's logits equal forward over the extended sequence;
    ``init_cache`` has prefill's layout and its SSM cache does not grow."""
    cfg = port_cfg(MODELS[name]())
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = torch.randint(0, cfg.vocab, (BATCH, 20), generator=torch.Generator().manual_seed(1))
    steps = 12
    # init_cache sizes a ring at min(W, max_len), prefill at W: the same
    # layout once max_len covers every window (hymba's reduced W is 1,024).
    max_len = max([20 + steps] + [bd.window or 0 for bd in cfg.layer_defs()])
    logits, caches = T.prefill(model, seq, cfg, max_len=max_len)
    torch.testing.assert_close(logits, T.forward(model, seq, cfg)[:, -1], **PREFILL_TOL)

    def layout(cs):
        return [{kind: {key: t.shape for key, t in sub.items()} for kind, sub in c.items()} for c in cs]

    assert layout(T.init_cache(cfg, BATCH, max_len)) == layout(caches)
    ssm_shapes = [c["ssm"]["state"].shape for c in caches]
    assert len(ssm_shapes) == cfg.num_layers
    for i in range(steps):
        nxt = torch.argmax(logits, -1)
        logits, caches = T.decode_step(model, nxt, caches, 20 + i, cfg)
        seq = torch.cat([seq, nxt[:, None]], 1)
        torch.testing.assert_close(logits, T.forward(model, seq, cfg)[:, -1], **DECODE_TOL)
    assert [c["ssm"]["state"].shape for c in caches] == ssm_shapes


@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_generate_matches_reference(name):
    jcfg = MODELS[name]()
    jparams, model, pcfg = _carried(jcfg, seed=1)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, (BATCH, S_LEN)).astype(np.int32)
    want = np.asarray(jserve.generate(jcfg, jparams, jnp.asarray(prompt), 4))
    got = serve_decode.generate(pcfg, model, torch.from_numpy(prompt), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_registry_configs_build_the_reference_tree(name):
    """The full-width configs' layer structure: the port's parameter names
    and shapes are those of the reference's tree (from ``jax.eval_shape``,
    nothing allocated), with ``ffn="none"`` leaving out ``ln2``/``mlp``."""
    jcfg = jregistry.get(name)
    cfg = registry.get(name)
    assert cfg == port_cfg(jcfg)
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "groups":  # stacked over the repeats: compare repeat 0's layer
            keys = ["layers", len(jcfg.prefix) + keys[1]] + keys[2:]
            want[".".join(map(str, keys))] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        elif keys[0] == "prefix":
            want[".".join(map(str, ["layers"] + keys[1:]))] = (tuple(leaf.shape), str(leaf.dtype))
        else:
            want[".".join(map(str, keys))] = (tuple(leaf.shape), str(leaf.dtype))
    model = T.Transformer(cfg, device="meta")
    first = len(cfg.prefix) + len(cfg.pattern)
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()
           if not n.startswith("layers.") or int(n.split(".")[1]) < first}
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    assert n == {"mamba2-780m": 857_379_072, "hymba-1.5b": 1_641_692_864}[name]


def test_init_distributions_and_float32_leaves():
    """``SSD.reset_parameters`` draws the reference's distributions; under a
    bf16 ``param_dtype`` A, D and dt_bias stay float32 in both packages and
    through ``lm_params_from_numpy``."""
    jcfg = jregistry.get("mamba2-780m").reduced().replace(param_dtype=jnp.bfloat16)
    cfg = port_cfg(jcfg)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert T.count_params(model) == JT.count_params(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    ssd = model.layers[0].ssm
    f32 = {"a_log", "d_skip", "dt_bias"}
    for name, p in ssd.named_parameters():
        assert p.dtype == (torch.float32 if name in f32 else torch.bfloat16), name
    d, k, d_inner = cfg.d_model, cfg.ssm_conv, ssd.out_proj.shape[0]
    for w, std in ((ssd.in_proj, d**-0.5), (ssd.conv_w, k**-0.5), (ssd.out_proj, d_inner**-0.5)):
        assert abs(float(w.float().std()) / std - 1) < 0.1
    for w, value in ((ssd.conv_b, 0.0), (ssd.a_log, 0.0), (ssd.dt_bias, 0.0), (ssd.d_skip, 1.0),
                     (ssd.norm.scale, 0.0)):
        assert bool((w == value).all())
    assert not hasattr(model.layers[0], "ln2") and not hasattr(model.layers[0], "mlp")

    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert {tree["groups"][0]["ssm"][k].dtype for k in f32} == {np.dtype(np.float32)}
    carried = lm_params_from_numpy(tree, cfg, "cpu")
    for name, p in carried.layers[1].ssm.named_parameters():
        assert p.dtype == (torch.float32 if name in f32 else torch.bfloat16), name
    np.testing.assert_array_equal(carried.layers[1].ssm.d_skip.numpy(), tree["groups"][0]["ssm"]["d_skip"][1])


@pytest.mark.parametrize("fault", ["missing_ssm_leaf", "missing_norm_ssm", "extra_ssm_leaf",
                                   "misshapen_state_dim"])
def test_lm_params_from_numpy_rejects(fault):
    name = "mamba2-780m" if fault != "missing_norm_ssm" else "hymba-1.5b"
    jcfg = jregistry.get(name).reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    grp = tree["groups"][0]
    if fault == "missing_ssm_leaf":
        del grp["ssm"]["dt_bias"]
    elif fault == "missing_norm_ssm":
        del grp["norm_ssm"]
    elif fault == "extra_ssm_leaf":
        grp["ssm"]["bias"] = np.zeros((2, 8), np.float32)
    else:
        grp["ssm"]["in_proj"] = grp["ssm"]["in_proj"][..., :-1]
    with pytest.raises(ValueError):
        lm_params_from_numpy(tree, port_cfg(jcfg), "cpu")


@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_main_on_cpu(name, capsys):
    out = serve_decode.main(["--arch", name, "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--tokens", "3"])
    assert out.shape == (2, 3) and ((0 <= out) & (out < 512)).all()
    assert "generated (2, 3)" in capsys.readouterr().out


def test_serve_lm_example_on_cpu(capsys):
    """examples/serve_lm_torch.py serves its seven models (one of each
    family) through the port on the CPU."""
    import runpy
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_lm_torch.py"
    runpy.run_path(str(path))["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    archs = ("mamba2-780m", "granite-3-8b", "hymba-1.5b", "seamless-m4t-medium",
             "llama-3.2-vision-90b", "arctic-480b", "kimi-k2-1t-a32b")
    for arch in archs:
        assert f"=== {arch} (reduced) ===" in out
    assert out.count("generated (4, 16)") == len(archs)
