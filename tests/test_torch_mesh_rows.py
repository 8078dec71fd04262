"""The sharded step where a weight is whole over the ``model`` axis: a
reduced granite with 6 query heads, 2 KV heads and a vocabulary of 510,
so at 1x4 neither the heads nor the vocabulary divide the axis and ``wq``,
``wk``, ``wv``, ``wo`` and the LM head are replicated over ``model`` (the
reference's placements). Each model rank then takes its own rows
(``sharding.rows_over_model``): the attention block's and the LM head's,
gathered back into the residual stream. At 2x2 both divide and the block
is Megatron's.

The weights are the reference's (``repro``'s ``init_params``, carried by
``interop.lm_params_from_numpy``). In one gloo world of 4 ranks, one
AdamW step and a prefill on the same tokens are held to the reference:
the loss to its ``loss_fn`` and the parameters and first moments (a
tenth of the gradients) to its ``build_step`` within the sharded-train
tolerances (``tests/test_torch_sharded_train.py``), and the prefill's
logits to its ``prefill`` within the prefill tolerance
(``tests/test_torch_lm.py``). Each is also held to the port's one-device
step and prefill."""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M
from test_torch_sharded_train import LOSS_TOL, STEP_TOL

TIMEOUT = 300
MESHES = ((1, 4), (2, 2))
BATCH, SEQ = 4, 32
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_lm.py
MOMENT_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_sharded_train.py


def reference_cfg():
    from repro.configs import registry as jregistry

    return jregistry.get("granite-3-8b").reduced().replace(q_heads=6, kv_heads=2, vocab=510)


def tokens():
    rng = np.random.default_rng(2)
    return (rng.integers(0, 510, (BATCH, SEQ)).astype(np.int32),
            rng.integers(0, 510, (BATCH, SEQ)).astype(np.int32))


def _whole(t):
    from repro_torch.models import sharding as sh

    return (t.full_tensor() if sh.is_dtensor(t) else t).detach().clone()


def by_name(tree, cfg) -> dict:
    """A reference tree as ``{port parameter name: tensor}``."""
    from repro_torch.interop import lm_params_from_numpy

    return {n: p.detach() for n, p in lm_params_from_numpy(tree, cfg, "cpu").named_parameters()}


@pytest.fixture(scope="module")
def reference():
    """The reference's weights (numpy), the port's config, and the
    reference's loss, parameters and first moments after one AdamW step
    and prefill logits on ``tokens()``."""
    import jax
    import jax.numpy as jnp

    from repro.launch import train as jtrain
    from repro.models import transformer as JT
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as jadamw_init
    from test_torch_lm import port_cfg

    jcfg = reference_cfg()
    cfg = port_cfg(jcfg)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1)))
    jp = jax.tree.map(jnp.asarray, tree)
    toks, tgts = tokens()
    opt_cfg = JAdamWConfig(lr=1e-3)
    jstep = jax.jit(jtrain.build_step(jcfg, opt_cfg, 10))
    params, opt, loss, _ = jstep(jp, jadamw_init(jp, opt_cfg),
                                 {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    logits, _ = jax.jit(lambda p, t: JT.prefill(p, t, jcfg))(jp, jnp.asarray(toks))
    numpy = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return dict(tree=tree, cfg=cfg, loss=float(loss), params=by_name(numpy(params), cfg),
                mu=by_name(numpy(opt.mu), cfg), logits=torch.tensor(np.asarray(logits)))


def step(tree, cfg, dm=None):
    """(loss, {name: parameter after one AdamW step}, {name: first moment},
    prefill logits) of the port's step and prefill from ``tree``, on ``dm``
    when given."""
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch import serve_decode as sd
    from repro_torch.launch import train
    from repro_torch.models import sharding as sh
    from repro_torch.optim import AdamWConfig

    model = lm_params_from_numpy(tree, cfg, "cpu").requires_grad_(True)
    toks, tgts = tokens()
    prompt = torch.from_numpy(toks).long()
    if dm is not None:
        sh.distribute_params(cfg, dm, model)
        prompt = sh.place(prompt, sh.batch_sharding(dm, 2))
    logits, _ = sd.prefill(cfg, model, prompt)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
    batch = train.make_batch(cfg, toks, tgts, 0, "cpu")
    if dm is not None:
        batch = sh.shard_batch(batch, dm)
    model, opt, loss, _ = train.build_step(cfg, opt_cfg, total_steps=10)(model, opt, batch)
    return (float(_whole(loss)), {n: _whole(p) for n, p in model.named_parameters()},
            {n: _whole(m) for n, m in opt.mu.items()}, _whole(logits))


def rows_world(rank, world_size, tree, cfg):
    torch.set_num_threads(1)  # the ranks share the host's cores
    out = {}
    for shape in MESHES:
        dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
        out[shape] = step(tree, cfg, dm)
    return out


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    return M.run_world(rows_world, 4, "gloo", tmp_path_factory.mktemp("world"),
                       args=(reference["tree"], reference["cfg"]), timeout=TIMEOUT)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step_and_prefill_with_whole_heads(world, reference, shape):
    """The sharded step's loss, parameters and first moments, and the
    sharded prefill's logits, against the reference's and the one-device
    port's on the same weights and tokens."""
    loss1, params1, mu1, logits1 = step(reference["tree"], reference["cfg"])
    for rank_out in world:
        loss, params, mu, logits = rank_out[shape]
        for want_loss, want_params, want_mu, want_logits in (
                (reference["loss"], reference["params"], reference["mu"], reference["logits"]),
                (loss1, params1, mu1, logits1)):
            np.testing.assert_allclose(loss, want_loss, **LOSS_TOL)
            for name, p in params.items():
                torch.testing.assert_close(p, want_params[name], **STEP_TOL, msg=name)
                torch.testing.assert_close(mu[name], want_mu[name], **MOMENT_TOL, msg=name)
            torch.testing.assert_close(logits, want_logits, **PREFILL_TOL)
