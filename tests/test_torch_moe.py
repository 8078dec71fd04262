"""Port vs reference: the top-k MoE (``models/layers.py`` ``MoE``, ``moe``,
``moe_route``, ``moe_capacity``) and the MoE family of the LM serving path
(arctic-480b's ``moe_dense``, kimi-k2-1t's dense prefix and shared
expert), in float32 on the CPU.

A model's weights are the reference's ``init_params``, carried into the
port by ``interop.lm_params_from_numpy``; inputs are made with numpy from
a seed. The tolerances are the reference's own (tests/test_models.py:
28-44): prefill logits and caches rtol = atol = 1e-4, decode logits 1e-3;
the MoE alone is held at the prefill's. Above 256 tokens, and at any T
with ``capacity_factor``, the capacity drops choices: the port must keep
the same (token, choice) pairs as the reference, whose kept set the tests
compute from its own router, ``lax.top_k`` and cumsum
(``repro/models/layers.py:435-460``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry
from repro.launch import serve_decode as jserve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as tb
from repro_torch.configs import registry
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve_decode
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_lm import _carried, _np, port_cfg
from test_torch_ssm import _caches_close

PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
MOE_ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]
S_LEN, STEPS, BATCH = 40, 6, 2
# (batch, seq, capacity_factor): drop-free at T = 80 <= 256; T = 320 past
# 256 at the default factor 1.25; T = 80 at factor 1.0.
CASES = {"drop_free": (2, 40, None), "past_256": (2, 160, None), "factor_1": (2, 40, 1.0)}


def _moe_params(jparams, jcfg):
    """The reference's first MoE layer's leaves (the pattern's, repeat 0)."""
    return jax.tree.map(lambda a: a[0], jparams["groups"][0]["moe"])


def _port_moe(model, cfg):
    return model.layers[len(cfg.prefix)].moe


def _x(shape, seed):
    """Normals plus one direction shared by every token, as real
    activations have: the router then prefers some experts, so past 256
    tokens their capacity drops choices (with zero-mean tokens the load
    stays within the 1.25 factor)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1.5 * rng.standard_normal(shape[-1])).astype(np.float32)


def reference_kept(jp, x, jcfg, cap):
    """The reference's experts (T, k) and kept mask (T, k), from its own
    router, ``lax.top_k`` and cumsum (layers.py:435-460)."""
    t, e, k = x.shape[0] * x.shape[1], jcfg.num_experts, jcfg.moe_top_k
    xt = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = onehot.reshape(t * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat).reshape(t, k, e) * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos < cap)


# -- the MoE layer -----------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_matches_reference(name, case):
    """``moe`` against ``repro.models.layers.moe`` on the same weights and
    input: the same experts in the same order, the same kept set (drops
    engaged in the ``past_256`` and ``factor_1`` cases), the output within
    1e-4."""
    jcfg = jregistry.get(name).reduced()
    jparams, model, pcfg = _carried(jcfg)
    jp, p = _moe_params(jparams, jcfg), _port_moe(model, pcfg)
    b, s, factor = CASES[case]
    x = _x((b, s, jcfg.d_model), seed=s)
    t, e, k = b * s, jcfg.num_experts, jcfg.moe_top_k
    cap = L.moe_capacity(t, e, k, factor)
    want_cap = t if factor is None and t <= 256 else max(1, int(k * t / e * (factor or 1.25)))
    assert cap == want_cap

    want_idx, want_keep = reference_kept(jp, x, jcfg, cap)
    with torch.inference_mode():
        gates, experts, pos = L.moe_route(p, torch.from_numpy(x).reshape(t, -1), pcfg)
    np.testing.assert_array_equal(experts.numpy(), want_idx)
    keep = (pos < cap).reshape(t, k).numpy()
    np.testing.assert_array_equal(keep, want_keep)
    dropped = int((~keep).sum())
    assert dropped == 0 if case == "drop_free" else dropped > 0
    torch.testing.assert_close(gates.sum(-1), torch.ones(t))

    want = JL.moe(jp, jnp.asarray(x), jcfg, capacity_factor=factor)
    with torch.inference_mode():
        got = L.moe(p, torch.from_numpy(x), pcfg, capacity_factor=factor)
    np.testing.assert_allclose(_np(got), _np(want), **PREFILL_TOL)


def test_moe_positions_count_earlier_choices():
    """``moe_route``'s positions are each choice's rank among the earlier
    choices of its expert in token-major order (a loop over the choices),
    and two calls give the same bits."""
    jcfg = jregistry.get("arctic-480b").reduced()
    _, model, pcfg = _carried(jcfg)
    p = _port_moe(model, pcfg)
    xt = torch.from_numpy(_x((300, jcfg.d_model), seed=3))
    with torch.inference_mode():
        gates, experts, pos = L.moe_route(p, xt, pcfg)
        again = L.moe(p, xt[None], pcfg)
        assert torch.equal(L.moe(p, xt[None], pcfg), again)
    seen, want = {}, []
    for ex in experts.reshape(-1).tolist():
        want.append(seen.get(ex, 0))
        seen[ex] = want[-1] + 1
    assert pos.tolist() == want
    assert torch.all(gates[:, 0] >= gates[:, 1])


def test_moe_scan_dispatch_changes_no_bit():
    """``moe_scan_dispatch`` is accepted and changes no bit in the port: the
    reference's blocked prefix sum computes the cumsum's positions (its own
    outputs agree both ways), so the port computes them one way."""
    jcfg = jregistry.get("kimi-k2-1t-a32b").reduced()
    jparams, model, pcfg = _carried(jcfg)
    jp, p = _moe_params(jparams, jcfg), _port_moe(model, pcfg)
    x = _x((2, 160, jcfg.d_model), seed=7)
    scan_cfg = pcfg.replace(moe_scan_dispatch=True)
    assert tb.unported(scan_cfg) == []
    with torch.inference_mode():
        plain = L.moe(p, torch.from_numpy(x), pcfg)
        scan = L.moe(p, torch.from_numpy(x), scan_cfg)
    assert torch.equal(plain, scan)
    jplain = JL.moe(jp, jnp.asarray(x), jcfg)
    jscan = JL.moe(jp, jnp.asarray(x), jcfg.replace(moe_scan_dispatch=True))
    np.testing.assert_array_equal(np.asarray(jscan), np.asarray(jplain))

    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (BATCH, 150)).astype(np.int32)
    a, _ = T.prefill(model, torch.from_numpy(toks), pcfg)
    b, _ = T.prefill(model, torch.from_numpy(toks), scan_cfg)
    assert torch.equal(a, b)


def test_moe_init_distributions_and_float32_router():
    """``MoE.reset_parameters`` draws the reference's distributions (the
    expert stacks' fan-in is E, ``_dense_init``'s first dimension); under a
    bf16 ``param_dtype`` the router stays float32 in both packages and
    through ``lm_params_from_numpy``; the counts match."""
    jcfg = jregistry.get("kimi-k2-1t-a32b").reduced().replace(param_dtype=jnp.bfloat16)
    cfg = port_cfg(jcfg)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert T.count_params(model) == JT.count_params(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    moe = model.layers[1].moe
    assert moe.router.dtype == torch.float32
    assert {moe.w_gate.dtype, moe.w_in.dtype, moe.w_out.dtype, moe.shared.w_in.dtype} == {torch.bfloat16}
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    for w, std in ((moe.router, d**-0.5), (moe.w_gate, e**-0.5), (moe.w_in, e**-0.5),
                   (moe.w_out, ff**-0.5), (moe.shared.w_in, d**-0.5)):
        assert abs(float(w.float().std()) / std - 1) < 0.1
    assert hasattr(model.layers[0], "mlp") and not hasattr(model.layers[0], "moe")  # dense layer 0

    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert tree["groups"][0]["moe"]["router"].dtype == np.float32
    carried = lm_params_from_numpy(tree, cfg, "cpu")
    assert carried.layers[2].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(carried.layers[2].moe.router.numpy(),
                                  tree["groups"][0]["moe"]["router"][1])


# -- the models ----------------------------------------------------------------------


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_prefill_and_decode_match_reference(name):
    """arctic's ``moe_dense`` layers and kimi's dense layer 0 + MoE layers
    with a shared expert: prefill logits and caches, then STEPS greedy
    decode steps, logits within the reference's tolerances and the same
    greedy tokens."""
    jcfg = jregistry.get(name).reduced()
    jparams, model, pcfg = _carried(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (BATCH, S_LEN)).astype(np.int32)
    max_len = S_LEN + STEPS
    jlog, jcache = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, max_len=max_len))(jparams, jnp.asarray(toks))
    tlog, tcache = T.prefill(model, torch.from_numpy(toks), pcfg, max_len=max_len)
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


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_prefill_with_drops_matches_reference(name, monkeypatch):
    """A prefill of 2 x 160 tokens (T = 320 > 256) of a repetitive text (16
    distinct tokens), so that capacity drops choices in every MoE layer:
    logits within 1e-4 of the reference's."""
    jcfg = jregistry.get(name).reduced()
    jparams, model, pcfg = _carried(jcfg, seed=2)
    dropped = []

    def counting(p, x, cfg, capacity_factor=None, _inner=L.moe):
        t = x.shape[0] * x.shape[1]
        cap = L.moe_capacity(t, cfg.num_experts, cfg.moe_top_k, capacity_factor)
        dropped.append(int((L.moe_route(p, x.reshape(t, -1).to(cfg.compute_dtype), cfg)[2] >= cap).sum()))
        return _inner(p, x, cfg, capacity_factor)

    monkeypatch.setattr(L, "moe", counting)
    toks = np.random.default_rng(9).integers(0, 16, (2, 160)).astype(np.int32)
    jlog, _ = jax.jit(lambda p, t: JT.prefill(p, t, jcfg))(jparams, jnp.asarray(toks))
    tlog, _ = T.prefill(model, torch.from_numpy(toks), pcfg)
    assert len(dropped) == sum(bd.ffn != "dense" for bd in pcfg.layer_defs()) and min(dropped) > 0
    np.testing.assert_allclose(_np(tlog), _np(jlog), **PREFILL_TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_forward_in_the_port(name):
    """The port's own oracle (the reference's test_moe_decode_oracle): at
    T <= 256 the MoE is drop-free, so prefill's last logits equal
    forward's and each decode step's logits equal forward over the
    extended sequence."""
    cfg = registry.get(name).reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = torch.randint(0, cfg.vocab, (BATCH, 16), generator=torch.Generator().manual_seed(1))
    logits, caches = T.prefill(model, seq, cfg, max_len=16 + 3)
    torch.testing.assert_close(logits, T.forward(model, seq, cfg)[:, -1], **PREFILL_TOL)
    for i in range(3):
        nxt = torch.argmax(logits, -1)
        logits, caches = T.decode_step(model, nxt, caches, 16 + i, cfg)
        seq = torch.cat([seq, nxt[:, None]], 1)
        torch.testing.assert_close(logits, T.forward(model, seq, cfg)[:, -1], **DECODE_TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_generate_matches_reference(name):
    jcfg = jregistry.get(name).reduced()
    jparams, model, pcfg = _carried(jcfg, seed=1)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, (BATCH, S_LEN)).astype(np.int32)
    want = np.asarray(jserve.generate(jcfg, jparams, jnp.asarray(prompt), 4))
    got = serve_decode.generate(pcfg, model, torch.from_numpy(prompt), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_registry_configs_build_the_reference_tree(name):
    """The full-width configs: the port's parameter names, shapes and
    types are those of the reference's tree (``jax.eval_shape``, nothing
    allocated), and the parameter counts are the full models'."""
    jcfg = jregistry.get(name)
    cfg = registry.get(name)
    assert cfg == port_cfg(jcfg)
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "groups":
            want[".".join(map(str, ["layers", len(jcfg.prefix) + keys[1]] + keys[2:]))] = \
                (tuple(leaf.shape[1:]), str(leaf.dtype))
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
    assert T.count_params(model) == JT.count_params(shapes)


@pytest.mark.parametrize("knob", ["flash_decode", "use_adafactor", "adam_moments_bf16"])
@pytest.mark.parametrize("name", MOE_ARCHS + ["llama-3.2-vision-90b"])
def test_check_ported_still_refuses(name, knob):
    """Every knob is ported: ``flash_decode`` (it acts in decode given a
    mesh, ``tests/test_torch_flash_decode.py``) and the optimizer knobs
    (``launch/train.py`` builds the optimizer they name); with each, as
    without any, ``check_ported`` refuses nothing and the config builds."""
    cfg = registry.get(name).reduced()
    assert tb.unported(cfg) == []
    knobbed = cfg.replace(**{knob: True})
    assert tb.unported(knobbed) == []
    assert T.count_params(T.init_params(knobbed, device="cpu")) == T.count_params(T.Transformer(cfg))


@pytest.mark.parametrize("fault", ["misshapen_expert_stack", "missing_router", "extra_shared_leaf"])
def test_lm_params_from_numpy_rejects_moe(fault):
    jcfg = jregistry.get("kimi-k2-1t-a32b").reduced()
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    moe = tree["groups"][0]["moe"]
    if fault == "misshapen_expert_stack":
        moe["w_gate"] = moe["w_gate"][:, :-1]
    elif fault == "missing_router":
        del moe["router"]
    else:
        moe["shared"]["bias"] = np.zeros((2, 8), np.float32)
    with pytest.raises(ValueError):
        lm_params_from_numpy(tree, port_cfg(jcfg), "cpu")


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_main_on_cpu(name, capsys):
    out = serve_decode.main(["--arch", name, "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--tokens", "3"])
    assert out.shape == (2, 3) and ((0 <= out) & (out < 512)).all()
    assert "generated (2, 3)" in capsys.readouterr().out


def test_reduced_configs_are_the_references():
    for name in MOE_ARCHS:
        got = registry.get(name).reduced()
        assert got == port_cfg(jregistry.get(name).reduced())
        assert dataclasses.asdict(got)["num_experts"] == 8 and got.moe_top_k == 2
