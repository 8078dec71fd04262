"""Port vs reference: the optimizers, the schedule, int8 compression
(``repro_torch.optim``) and the token pipeline (``repro_torch.data.tokens``),
on the CPU.

The same numpy inputs go through both packages: the reference's functions
take ``{name: array}`` trees, the port's ``{name: tensor}`` mappings.
Tolerances: the schedule atol 1e-7; one update's parameters and moments
rtol 1e-6 / atol 1e-7 (the same float32 formulas, eager on both sides);
the pipeline's batches bitwise. Then the port's counterparts of
``tests/test_optim.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import OptState as JOptState
from repro.optim import adafactor_init as jadafactor_init
from repro.optim import adafactor_update as jadafactor_update
from repro.optim import adamw_update as jadamw_update
from repro.optim import compress_int8 as jcompress_int8
from repro.optim import cosine_schedule as jcosine_schedule
from repro_torch.data.tokens import TokenPipeline
from repro_torch.optim import (AdamWConfig, OptState, adafactor_init, adafactor_update, adamw_init,
                               adamw_update, compress_int8, cosine_schedule, decompress_int8)

UPDATE_TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"embed": (12, 8), "wq": (8, 2, 4), "scale": (8,), "wo": (2, 4, 8)}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _draw(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = {}
    for n, shape in SHAPES.items():
        a = scale * rng.standard_normal(shape)
        out[n] = (a * a + 1e-8 if positive else a).astype(np.float32)
    return out


def _torch(tree, dtype=torch.float32):
    return {n: torch.from_numpy(a.copy()).to(dtype) for n, a in tree.items()}


def test_cosine_schedule_matches_reference_at_every_step():
    for step in range(101):
        want = float(jcosine_schedule(step, warmup=5, total=100))
        got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32), warmup=5, total=100))
        assert abs(got - want) <= 1e-7, step
        assert abs(float(cosine_schedule(step, 5, 100)) - got) == 0.0


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """One update from a mid-training state (step 7, clipping active):
    parameters, both moments, the step and gnorm."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[moments]
    params, grads = _draw(0), _draw(1, scale=3.0)
    mu, nu = _draw(2, scale=0.1), _draw(3, scale=0.1, positive=True)
    jstate = JOptState(jnp.asarray(7, jnp.int32), {n: jnp.asarray(a, jdt) for n, a in mu.items()},
                       {n: jnp.asarray(a, jdt) for n, a in nu.items()})
    jp, jst, jgnorm = jadamw_update({n: jnp.asarray(a) for n, a in grads.items()}, jstate,
                                    {n: jnp.asarray(a) for n, a in params.items()},
                                    JAdamWConfig(lr=1e-2, moment_dtype=jdt), lr_scale=0.7)
    tparams = _torch(params)
    state = OptState(torch.tensor(7, dtype=torch.int32), _torch(mu, tdt), _torch(nu, tdt))
    out, st, gnorm = adamw_update(_torch(grads), state, tparams, AdamWConfig(lr=1e-2, moment_dtype=tdt),
                                  lr_scale=0.7)
    assert out is tparams and st.mu is state.mu  # in place
    assert int(st.step) == int(jst.step) == 8
    np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)
    assert float(gnorm) > 1.0  # the clip acts
    for n in SHAPES:
        np.testing.assert_allclose(_np(out[n]), _np(jp[n]), **UPDATE_TOL, err_msg=n)
        assert st.mu[n].dtype == tdt
        np.testing.assert_allclose(_np(st.mu[n]), _np(jst.mu[n]), **UPDATE_TOL, err_msg=n)
        np.testing.assert_allclose(_np(st.nu[n]), _np(jst.nu[n]), **UPDATE_TOL, err_msg=n)


def test_adafactor_update_matches_reference():
    """One update after one earlier (non-zero moments), with weight decay:
    factored rank-2 and rank-3 leaves, the full moment of a vector."""
    params, grads, grads2 = _draw(4), _draw(5), _draw(6, scale=2.0)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jst = jadafactor_init(jp)
    tp = _torch(params)
    st = adafactor_init(tp)
    for g in (grads, grads2):
        jp, jst = jadafactor_update({n: jnp.asarray(a) for n, a in g.items()}, jst, jp, lr=1e-2,
                                    weight_decay=0.1)
        tp, st = adafactor_update(_torch(g), st, tp, lr=1e-2, weight_decay=0.1)
    assert int(st.step) == int(jst.step) == 2
    for n in SHAPES:
        np.testing.assert_allclose(_np(tp[n]), _np(jp[n]), **UPDATE_TOL, err_msg=n)
        np.testing.assert_allclose(_np(st.vr[n]), _np(jst.vr[n]), **UPDATE_TOL, err_msg=n)
        np.testing.assert_allclose(_np(st.vc[n]), _np(jst.vc[n]), **UPDATE_TOL, err_msg=n)
    assert st.vr["wq"].shape == (8, 2) and st.vc["wq"].shape == (8, 4) and st.vc["scale"].shape == (1,)


def test_int8_compression_matches_reference():
    x = np.random.default_rng(7).normal(size=(256,)).astype(np.float32)
    jq, jscale = jcompress_int8(jnp.asarray(x))
    q, scale = compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


# -- the reference's tests/test_optim.py, for the port --------------------------------


def _quadratic_params():
    return {"a": torch.tensor([3.0, -2.0]), "b.c": torch.tensor([[1.5]])}


def _quadratic_grads(params):
    return {n: 2 * p for n, p in params.items()}


def _loss(params):
    return float(sum(torch.sum(p**2) for p in params.values()))


def test_adamw_converges_on_quadratic():
    params = _quadratic_params()
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = adamw_update(_quadratic_grads(params), state, params, cfg)
    assert _loss(params) < 1e-3
    assert int(state.step) == 200


def test_adamw_clips_global_norm():
    params = {"a": torch.zeros(3)}
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    state = adamw_init(params, cfg)
    newp, state, gnorm = adamw_update({"a": torch.tensor([1e6, 0.0, 0.0])}, state, params, cfg)
    assert float(gnorm) == 1e6
    assert bool(torch.isfinite(newp["a"]).all())
    # the first step's update is bounded by lr whatever the gradient's scale
    assert float(newp["a"].abs().max()) <= 1.0 + 1e-5


def test_adamw_bf16_moments():
    params = {"w": torch.ones((8, 8))}
    cfg = AdamWConfig(moment_dtype=torch.bfloat16)
    state = adamw_init(params, cfg)
    assert state.mu["w"].dtype == torch.bfloat16
    newp, state, _ = adamw_update({"w": torch.ones((8, 8))}, state, params, cfg)
    assert state.mu["w"].dtype == torch.bfloat16
    assert newp["w"].dtype == torch.float32


def test_adafactor_converges_and_is_factored():
    params = {"w": torch.full((16, 4), 2.0)}
    state = adafactor_init(params)
    assert state.vr["w"].shape == (16,)
    assert state.vc["w"].shape == (4,)
    for _ in range(300):
        params, state = adafactor_update({"w": 2 * params["w"]}, state, params, lr=0.05)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_cosine_schedule_shape():
    s0 = float(cosine_schedule(0, warmup=10, total=100))
    s_w = float(cosine_schedule(10, warmup=10, total=100))
    s_end = float(cosine_schedule(100, warmup=10, total=100))
    assert s0 == 0.0
    assert abs(s_w - 1.0) < 1e-6
    assert abs(s_end - 0.1) < 1e-2
    mid = [float(cosine_schedule(t, 10, 100)) for t in range(10, 101, 10)]
    assert all(a >= b - 1e-9 for a, b in zip(mid, mid[1:])), "monotone decay"


def test_int8_compression_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)).astype(np.float32))
    q, scale = compress_int8(x)
    assert q.dtype == torch.int8
    back = decompress_int8(q, scale)
    # the largest quantization error is scale / 2 = max|x| / 254
    assert float((back - x).abs().max()) <= float(scale) / 2 + 1e-7


# -- the token pipeline ---------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 4, 0), (32001, 128, 2, 3), (7, 9, 3, 1)])
def test_token_pipeline_is_the_reference_bitwise(vocab, seq, batch, seed):
    """Every batch of a run bitwise the reference's, and again after a
    restore to a cursor mid-run."""
    ours, ref = TokenPipeline(vocab, seq, batch, seed), JTokenPipeline(vocab, seq, batch, seed)
    for _ in range(4):
        (t, y), (jt, jy) = ours.next_batch(), ref.next_batch()
        assert t.dtype == np.int32 and t.shape == (batch, seq)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(y, jy)
    assert ours.state() == ref.state() == {"step": 4, "seed": seed}
    again = TokenPipeline(vocab, seq, batch, seed)
    again.restore({"step": 2, "seed": seed})
    ref.restore({"step": 2, "seed": seed})
    for _ in range(3):
        (t, y), (jt, jy) = again.next_batch(), ref.next_batch()
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(y, jy)
