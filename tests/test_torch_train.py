"""Port vs reference: LM training (``loss_fn`` and its gradients, the MoE aux
loss, the banded path's ``autograd.Function``, the SSD's masked exponent,
``build_step`` with its optimizers, ``launch/train.py``), in float32 on the
CPU.

The reference's parameters are carried into the port with ``interop``,
the port's gradients carried back with ``interop.params_to_numpy``;
inputs are made with numpy from a seed. Tolerances: the loss rtol 1e-5,
every gradient rtol 1e-4 / atol 1e-5 (float32 sums in another order, the
reference's scan against the port's loop), a training step's parameters
rtol 1e-5 / atol 1e-6 (the step moves each by lr times an O(1) update, and
the gradients behind it agree to 1e-4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry
from repro.configs.base import BlockDef as JBlockDef
from repro.launch import train as jtrain
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import OptState as JOptState
from repro.optim import adafactor_init as jadafactor_init
from repro.optim import adafactor_update as jadafactor_update
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro_torch.configs import registry
from repro_torch.interop import (adamw_state_from_numpy, encdec_params_from_numpy,
                                 lm_params_from_numpy, params_to_numpy)
from repro_torch.kernels.band_attn import ops as band_ops
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adafactor_init
from test_torch_lm import _np, port_cfg
from test_torch_ssm import _x, ssd_cfgs, ssd_params

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
B, SEQ = 2, 16


def windowed(name):
    """A reduced config whose windowed layers take the banded path at S = 20
    > W = 8 (20 is no multiple of 8: the blocked backward pads)."""
    c = jregistry.get(name).reduced()
    if name == "gemma3-12b":
        return c.replace(pattern=(JBlockDef(window=8),) * 5 + (JBlockDef(),), block_local_attn=True)
    return c.replace(pattern=(JBlockDef(mixer="hybrid", window=8, ffn="dense"),), block_local_attn=True)


CASES = {name: (lambda name=name: jregistry.get(name).reduced(), SEQ) for name in jregistry.names()}
CASES["gemma3-12b-banded"] = (lambda: windowed("gemma3-12b"), 20)
CASES["hymba-1.5b-banded"] = (lambda: windowed("hymba-1.5b"), 20)


def carried(jcfg, seed=0):
    """(reference params, the port's model holding them, port cfg). Norm
    scales and the SSD's A, dt_bias, D and conv_b are moved off their
    init, so each enters the gradients."""
    init = JED.init_params if jcfg.family == "encdec" else JT.init_params
    tree = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(seed)))
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
    carry = encdec_params_from_numpy if jcfg.family == "encdec" else lm_params_from_numpy
    return jax.tree.map(jnp.asarray, tree), carry(tree, pcfg, "cpu").requires_grad_(True), pcfg


def batch_np(jcfg, seq, seed=0, batch=B):
    """tokens, targets (int32) and the family's stub input (the VLM's
    memory, the enc-dec's frames), standard normals."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32),
           "targets": rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)}
    if jcfg.family == "vlm":
        out["memory"] = rng.standard_normal((batch, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "encdec":
        out["frames"] = rng.standard_normal((batch, seq, jcfg.d_model)).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def reference_value_and_grad(jp, jcfg, batch):
    """``jax.value_and_grad`` of the reference's loss under ``jax.jit``."""

    def loss(p):
        if jcfg.family == "encdec":
            return JED.loss_fn(p, batch["frames"], batch["tokens"], batch["targets"], jcfg)
        extras = {"memory": batch["memory"]} if "memory" in batch else None
        return JT.loss_fn(p, batch["tokens"], batch["targets"], jcfg, extras)

    return jax.jit(jax.value_and_grad(loss))(jp)


@functools.cache
def reference_case(name):
    """(loss, gradients) of the reference's ``loss_fn`` on CASES[name]'s
    params and batch, computed once a process."""
    make, seq = CASES[name]
    jcfg = make()
    jp, _, _ = carried(jcfg)
    return reference_value_and_grad(jp, jcfg, {k: jnp.asarray(v) for k, v in batch_np(jcfg, seq).items()})


def assert_trees_close(got, want, tol, what):
    flat_got, tree_got = jax.tree_util.tree_flatten_with_path(got)
    flat_want, tree_want = jax.tree_util.tree_flatten_with_path(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), **tol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_reference(name, monkeypatch):
    """``loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``: each registry
    config's ``reduced()`` (the MoE's aux term, the enc-dec's frames and
    the VLM's memory included) and two with windowed layers on the banded
    path, whose ``BandedAttention`` backward (the blocked plain form) is
    what autograd differentiates there."""
    make, seq = CASES[name]
    jcfg = make()
    jp, model, pcfg = carried(jcfg)
    batch = batch_np(jcfg, seq)
    backward_calls = []
    real = band_ops.banded_attention_backward
    monkeypatch.setattr(band_ops, "banded_attention_backward",
                        lambda *a: backward_calls.append(1) or real(*a))
    loss, grads = train.value_and_grad(model, to_torch(batch), pcfg)
    jloss, jgrads = reference_case(name)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert_trees_close(params_to_numpy(model, pcfg, grads), jgrads, GRAD_TOL, f"{name} gradient")
    banded = sum(1 for bd in pcfg.layer_defs() if bd.window and pcfg.block_local_attn and seq > bd.window)
    assert len(backward_calls) == banded
    assert banded == (10 if name == "gemma3-12b-banded" else 2 if name == "hymba-1.5b-banded" else 0)


@pytest.mark.parametrize("name", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_aux_loss_matches_reference(name):
    jcfg = jregistry.get(name).reduced()
    jp, model, pcfg = carried(jcfg)
    layer = len(jcfg.prefix)  # the first MoE layer of both
    x = (np.random.default_rng(3).standard_normal((B, SEQ, jcfg.d_model))).astype(np.float32)
    want = JL.moe_aux_loss(jax.tree.map(lambda a: a[0], jp["groups"][0])["moe"], jnp.asarray(x), jcfg)
    got = L.moe_aux_loss(model.layers[layer].moe, torch.from_numpy(x), pcfg).detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["gemma3-12b-banded", "seamless-m4t-medium", "arctic-480b"])
def test_remat_gives_the_same_gradients(name, remat, monkeypatch):
    """``remat="full"`` and ``"dots"`` (the layers after the prefix
    recomputed in the backward, all of them or all but the products) give
    the bits of ``"none"``; under ``"full"`` the banded layers' forward
    runs twice (the recompute), their backward once."""
    make, seq = CASES[name]
    _, model, pcfg = carried(make())
    batch = to_torch(batch_np(make(), seq))
    loss, grads = train.value_and_grad(model, batch, pcfg)
    forwards = []
    real = band_ops.banded_attention_kernel
    monkeypatch.setattr(band_ops, "banded_attention_kernel", lambda *a: forwards.append(1) or real(*a))
    loss_r, grads_r = train.value_and_grad(model, batch, pcfg.replace(remat=remat))
    assert torch.equal(loss, loss_r)
    for n in grads:
        assert torch.equal(grads[n], grads_r[n]), n
    banded = sum(1 for bd in pcfg.layer_defs() if bd.window and pcfg.block_local_attn)
    assert len(forwards) == 2 * banded


# -- the SSD's masked exponent ---------------------------------------------------------


def _strong_decay(chunk=256, seq=512):
    """A narrow SSD at a chunk of 256 whose decay over a chunk passes 88
    (exp overflows float32): A = -1, dt_bias 2, so dt ~ 2.1 a step."""
    jcfg, pcfg = ssd_cfgs(chunk=chunk)
    jp, mod = ssd_params(pcfg, seed=7)
    with torch.no_grad():
        mod.a_log.zero_()
        mod.dt_bias.fill_(2.0)
    jp["a_log"], jp["dt_bias"] = jnp.zeros(4, jnp.float32), jnp.full(4, 2.0, jnp.float32)
    x = _x((1, seq, 32), seed=8)
    w = np.random.default_rng(9).standard_normal((1, seq, 32)).astype(np.float32)
    return jcfg, pcfg, jp, mod, x, w


def test_ssd_gradient_at_chunk_256_reference_nan_port_finite():
    """At a chunk of 256 with a chunk's decay past 88 the reference's
    gradient is NaN (its backward multiplies exp's inf above the diagonal
    by the where's zero cotangent: 0 * inf); the port masks the exponent
    before the exp, so its gradient is finite, and equal to the
    reference's wherever that one is finite: rtol 1e-4, atol 1e-4 of the
    leaf's largest gradient (float32 sums over 512 steps of terms up to
    ~20, where GRAD_TOL's atol is below their rounding). The forwards
    agree."""
    jcfg, pcfg, jp, mod, x, w = _strong_decay()
    mod.requires_grad_(True)

    def jloss(p, xx):
        return jnp.sum(JS.ssd(p, xx, jcfg) * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = S.ssd(mod, xt, pcfg)
    np.testing.assert_allclose(_np(y.detach()), _np(JS.ssd(jp, jnp.asarray(x), jcfg)), rtol=0.0, atol=1e-4)
    val = torch.sum(y * torch.from_numpy(w))
    names, params = zip(*mod.named_parameters())
    grads = dict(zip((*names, "x"), torch.autograd.grad(val, (*params, xt))))
    jflat = {"x": np.asarray(jgx)}
    for path, a in jax.tree_util.tree_flatten_with_path(jg)[0]:
        jflat[".".join(str(k.key) for k in path)] = np.asarray(a)
    assert not np.isfinite(jflat["in_proj"]).all(), "the reference's gradient should be NaN here"
    assert sum(int(np.isnan(a).sum()) for a in jflat.values()) > 0
    for n, g in grads.items():
        g = _np(g)
        assert np.isfinite(g).all(), n
        ok = np.isfinite(jflat[n])
        np.testing.assert_allclose(g[ok], jflat[n][ok], rtol=1e-4, atol=1e-4 * np.abs(g).max(),
                                   err_msg=n)


def test_ssd_forward_bits_unchanged_by_the_mask():
    """The exponent is masked before the exp only under autograd; the
    forward gives the same bits with and without it: the strong-decay SSD
    at a chunk of 256, and mamba2-780m and hymba-1.5b reduced, whose
    ``forward`` logits with gradients on (the masked exponent) equal the
    serving path's (``torch.inference_mode``, no mask)."""
    _, pcfg, _, mod, x, _ = _strong_decay()
    with torch.inference_mode():
        serving = S.ssd(mod, torch.from_numpy(x), pcfg)
    mod.requires_grad_(True)
    training = S.ssd(mod, torch.from_numpy(x), pcfg)
    assert training.requires_grad and torch.equal(training.detach(), serving)
    for name in ("mamba2-780m", "hymba-1.5b"):
        cfg = registry.get(name).reduced()
        model = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        tokens = torch.randint(0, cfg.vocab, (2, 21), generator=torch.Generator().manual_seed(2))
        serving = T.forward(model, tokens, cfg)
        model.requires_grad_(True)
        training = T.forward.__wrapped__(model, tokens, cfg)
        assert training.requires_grad and torch.equal(training.detach(), serving), name


# -- training steps ----------------------------------------------------------------------


def mid_training_state(jp, seed=5, step=5, moment_dtype=jnp.float32):
    """A reference AdamW state as after a few steps: mu ~ 1e-3 N(0, 1),
    nu ~ (1e-3 N(0, 1))^2 + 1e-8, step 5 (the cosine scale past 0)."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32), jp)
    nu = jax.tree.map(lambda a: ((1e-3 * rng.standard_normal(a.shape)) ** 2 + 1e-8).astype(np.float32),
                      jp)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, moment_dtype), t)
    return JOptState(jnp.asarray(step, jnp.int32), cast(mu), cast(nu))


@pytest.mark.parametrize("name,accum", [("granite-3-8b", 1), ("hymba-1.5b-banded", 1),
                                        ("granite-3-8b", 2)])
def test_build_step_matches_reference(name, accum):
    """One ``build_step`` step (AdamW, lr 1e-3, cosine over 20 steps) from
    a mid-training state against the reference's ``build_step`` under
    ``jax.jit``: loss, gnorm, every parameter and both moments; with
    ``accum=2`` the batch leads with (2, B/2, ...) on both sides."""
    make, seq = CASES[name]
    jcfg = make()
    jp, model, pcfg = carried(jcfg)
    jopt = mid_training_state(jp)
    batch = batch_np(jcfg, seq, batch=2 * B if accum > 1 else B)
    if accum > 1:
        batch = {k: v.reshape(accum, -1, *v.shape[1:]) for k, v in batch.items()}
    jstep = jax.jit(jtrain.build_step(jcfg, JAdamWConfig(lr=1e-3), 20, accum))
    jparams, jopt2, jloss, jgnorm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = adamw_state_from_numpy(jopt.step, jax.tree.map(np.asarray, jopt.mu),
                                 jax.tree.map(np.asarray, jopt.nu), pcfg, "cpu")
    step = train.build_step(pcfg, AdamWConfig(lr=1e-3), 20, accum)
    model, opt, loss, gnorm = step(model, opt, to_torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-4)
    assert int(opt.step) == int(jopt2.step) == 6
    assert_trees_close(params_to_numpy(model, pcfg), jparams, STEP_TOL, f"{name} params")
    assert_trees_close(params_to_numpy(model, pcfg, opt.mu), jopt2.mu, GRAD_TOL, "mu")
    assert_trees_close(params_to_numpy(model, pcfg, opt.nu), jopt2.nu, GRAD_TOL, "nu")


def test_accum_two_equals_one_on_the_same_rows():
    """``accum=2`` over (2, B/2) halves of a batch gives what ``accum=1``
    gives on the whole batch (a mean of means of equal halves), within
    float32 rounding."""
    jcfg = jregistry.get("granite-3-8b").reduced()
    batch = batch_np(jcfg, SEQ, batch=4)
    out = []
    for accum in (1, 2):
        _, model, pcfg = carried(jcfg)
        opt = train.init_optimizer(pcfg, dict(model.named_parameters()), AdamWConfig(lr=1e-3))
        opt = opt._replace(step=torch.tensor(5, dtype=torch.int32))
        b = batch if accum == 1 else {k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}
        model, opt, loss, _ = train.build_step(pcfg, AdamWConfig(lr=1e-3), 20, accum)(model, opt, to_torch(b))
        out.append((float(loss), params_to_numpy(model, pcfg)))
    np.testing.assert_allclose(out[1][0], out[0][0], **LOSS_TOL)
    assert_trees_close(out[1][1], out[0][1], STEP_TOL, "accum 2 vs 1")


def per_layer(tree, pcfg):
    """A reference tree as ``{port parameter name: array}``: each layer's
    leaves apart, as the port holds them."""
    carry = encdec_params_from_numpy if pcfg.family == "encdec" else lm_params_from_numpy
    module = carry(jax.tree.map(np.asarray, tree), pcfg, "cpu")
    return {n: jnp.asarray(p.detach().numpy()) for n, p in module.named_parameters()}


@pytest.mark.parametrize("knob", ["adam_moments_bf16", "use_adafactor"])
def test_optimizer_from_config(knob):
    """The optimizer comes from the config, as the reference's dry-run
    builds it: bf16 AdamW moments under ``adam_moments_bf16``, Adafactor
    (with the trainer's lr and schedule) under ``use_adafactor``; one step
    against the reference's gradient and optimizer composed the same way.

    Adafactor's update is held to the reference's ``adafactor_update`` on
    the port's per-layer leaves: on its own stacked tree the reference
    clips each leaf by the RMS over all the repeats stacked in it, and
    factors a stacked vector (ROADMAP queue 3)."""
    jcfg = jregistry.get("granite-3-8b").reduced().replace(**{knob: True})
    jp, model, pcfg = carried(jcfg)
    batch = batch_np(jcfg, SEQ)
    jloss, jg = reference_case("granite-3-8b")  # the knobs leave the loss as it is
    scale = jcosine_schedule(5, warmup=1, total=20)
    step = train.build_step(pcfg, AdamWConfig(lr=1e-3), 20)
    if knob == "use_adafactor":
        flat_p = per_layer(jp, pcfg)
        jstate = jadafactor_init(flat_p)._replace(step=jnp.asarray(5, jnp.int32))
        jnew, _ = jax.jit(jadafactor_update)(per_layer(jg, pcfg), jstate, flat_p, lr=1e-3 * scale)
        opt = adafactor_init(dict(model.named_parameters()))._replace(step=torch.tensor(5, dtype=torch.int32))
        model, opt, loss, _ = step(model, opt, to_torch(batch))
        assert int(opt.step) == 6 and opt.vc["embed"].shape == (jcfg.d_model,)
        got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    else:
        jopt = mid_training_state(jp, moment_dtype=jnp.bfloat16)
        jnew, jopt2, _ = jax.jit(jadamw_update, static_argnums=3)(
            jg, jopt, jp, JAdamWConfig(lr=1e-3, moment_dtype=jnp.bfloat16), scale)
        opt = adamw_state_from_numpy(jopt.step, jax.tree.map(np.asarray, jopt.mu),
                                     jax.tree.map(np.asarray, jopt.nu), pcfg, "cpu")
        assert opt.mu["embed"].dtype == torch.bfloat16
        model, opt, loss, _ = step(model, opt, to_torch(batch))
        assert opt.mu["embed"].dtype == torch.bfloat16
        got = params_to_numpy(model, pcfg)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert_trees_close(got, jnew, STEP_TOL, f"{knob} params")


# -- the launcher ------------------------------------------------------------------------


@pytest.mark.parametrize("name", registry.names())
def test_main_trains_every_reduced_config_on_cpu(name, capsys):
    loss = train.main(["--arch", name, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16"])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "step     1  loss" in out and "gnorm" in out
    assert "training done; final loss" in out


def test_main_accumulates_and_refuses_a_mesh():
    assert np.isfinite(train.main(["--arch", "granite-3-8b", "--reduced", "--device", "cpu", "--steps",
                                   "1", "--batch", "4", "--seq", "8", "--accum", "2"]))
    # A mesh above 1x1 needs a world of its size (tests/test_torch_sharded_train.py
    # runs one): without one the trainer says how to launch it.
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 8"):
        train.main(["--arch", "granite-3-8b", "--reduced", "--device", "cpu", "--mesh", "2x4"])


def test_main_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-3-8b", "--reduced", "--steps", "1"])
