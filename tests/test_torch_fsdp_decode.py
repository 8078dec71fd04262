"""FSDP decode without gathering the attention's weights: on a decode step
whose attention weights have their ``d`` split over ``data`` (FSDP), the
data ranks exchange their tokens' rows (``layers._project_rows`` for
``wq``/``wk``/``wv``, ``layers._out_rows`` for ``wo``) instead of
all-gathering the weights' blocks, whichever moves fewer bytes
(``sharding.moves_rows``, the rule the MoE's exchange shares).

In gloo worlds on the CPU, the reduced arctic-480b and command-r-35b
(both FSDP) prefill and decode on 2x1 and 2x2 meshes, and on 2x2 a reduced
arctic with 3 query heads and 1 KV head, so that, as arctic's 56 heads on
a 16-way axis, its query heads do not divide ``model`` and ``wq`` is
whole there and split over ``data``. Each decode step's logits are held
to the one-device port's and to the reference's (``repro``'s ``prefill``
and ``decode_step`` on the same weights, carried by
``interop.lm_params_from_numpy``) within ``test_model_decode_on_a_mesh``'s
tolerance; the decode steps move no block of an attention weight, the
prefill gathers them. On meta (the dry run's fake worlds): a decode
step's collective bytes grow with the tokens' rows, not with the
attention's weights, while the prefill's grow with the weights; and the
shared rule picks rows at the registry's decode sizes and blocks at its
prefill and training sizes, for the attention and the MoE alike, and
the rows move only without autograd."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as M

TIMEOUT = 300
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_torch_decode_mesh.py (test_model_decode_on_a_mesh)
B, PROMPT, STEPS = 4, 16, 3
# label: (arch, the reduced config's replaced fields).
CASES = {"arctic": ("arctic-480b", {}), "command-r": ("command-r-35b", {}),
         "arctic-3h": ("arctic-480b", dict(q_heads=3, kv_heads=1))}
WORLDS = {2: {(2, 1): ("arctic", "command-r")}, 4: {(2, 2): ("arctic", "command-r", "arctic-3h")}}
ATTN = ("wq", "wk", "wv", "wo")


def port_cfg(label: str):
    from repro_torch.configs import registry

    arch, knobs = CASES[label]
    return registry.get(arch).reduced().replace(**knobs)


def tokens(vocab: int):
    """(prompt (B, PROMPT), the STEPS decode tokens (B,) each)."""
    rng = np.random.default_rng(8)
    return rng.integers(0, vocab, (B, PROMPT)), rng.integers(0, vocab, (STEPS, B))


class Collectives(TorchDispatchMode):
    """The name and first tensor operand's shape of every collective a rank
    runs on its plain tensors (DTensor operators are handed on to
    DTensor, which issues its collectives as such operators)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace in ("_c10d_functional", "c10d") and not func.__name__.startswith(("_", "wait")):
            first = next((a for a in args if isinstance(a, torch.Tensor)), None)
            if first is not None:
                self.seen.append((func.__name__.split(".")[0], tuple(first.shape)))
        return func(*args, **(kwargs or {}))


def _whole(t):
    from repro_torch.models import sharding as sh

    return (t.full_tensor() if sh.is_dtensor(t) else t).detach().clone()


def decode(tree, cfg, dm=None):
    """Prefill and STEPS decode steps of ``cfg`` on the reference's weights
    ``tree``: the logits of each, and on ``dm`` the collectives of the
    prefill and of the decode steps and this rank's attention weight
    blocks' shapes."""
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch import serve_decode as sd
    from repro_torch.models import sharding as sh

    model = lm_params_from_numpy(tree, cfg, "cpu")
    prompt, steps = (torch.from_numpy(t) for t in tokens(cfg.vocab))
    if dm is not None:
        sh.distribute_params(cfg, dm, model)
        prompt = sh.place(prompt, sh.batch_sharding(dm, 2))
    with Collectives() as pre:
        logits, caches = sd.prefill(cfg, model, prompt, None, PROMPT + STEPS)
    out = [_whole(logits)]
    with Collectives() as dec:
        for i, tok in enumerate(steps):
            if dm is not None:
                tok = sh.place(tok, sh.batch_sharding(dm, 1))
            logits, caches = sd.decode_step(cfg, model, tok, caches, PROMPT + i)
            out.append(_whole(logits))
    if dm is None:
        return out
    blocks = {tuple(getattr(layer.attn, n).to_local().shape) for layer in model.layers for n in ATTN}
    return out, pre.seen, dec.seen, blocks


def fsdp_world(rank, world_size, trees, meshes):
    torch.set_num_threads(1)  # the ranks share the host's cores
    out = {}
    for shape, labels in meshes.items():
        dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
        for label in labels:
            out[(label, None)] = decode(trees[label], port_cfg(label))
            out[(label, shape)] = decode(trees[label], port_cfg(label), dm)
    return out


@pytest.fixture(scope="module")
def reference():
    """Per case: the reference's weights (numpy, seed 5) and its prefill
    and decode logits on ``tokens``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import transformer as JT

    out = {}
    for label, (arch, knobs) in CASES.items():
        jcfg = jregistry.get(arch).reduced().replace(**knobs)
        tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(5)))
        jp = jax.tree.map(jnp.asarray, tree)
        prompt, steps = tokens(jcfg.vocab)
        logits, cache = JT.prefill(jp, jnp.asarray(prompt, jnp.int32), jcfg, max_len=PROMPT + STEPS)
        want = [logits]
        jstep = jax.jit(lambda p, t, c, pos, jcfg=jcfg: JT.decode_step(p, t, c, pos, jcfg))
        for i, tok in enumerate(steps):
            logits, cache = jstep(jp, jnp.asarray(tok, jnp.int32), cache, PROMPT + i)
            want.append(logits)
        out[label] = (tree, [torch.tensor(np.asarray(w)) for w in want])
    return out


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    trees = {label: tree for label, (tree, _) in reference.items()}
    with ThreadPoolExecutor(len(WORLDS)) as pool:  # the two worlds side by side
        runs = {n: pool.submit(M.run_world, fsdp_world, n, "gloo", tmp_path_factory.mktemp(f"fsdp{n}"),
                               args=(trees, meshes), timeout=TIMEOUT)
                for n, meshes in WORLDS.items()}
        return {n: run.result() for n, run in runs.items()}


MESH_CASES = [(n, shape, label) for n, meshes in WORLDS.items() for shape, labels in meshes.items()
              for label in labels]
MESH_IDS = [f"{s[0]}x{s[1]}-{label}" for _, s, label in MESH_CASES]


def test_a_case_has_query_heads_whole_over_model():
    """``arctic-3h``'s 3 query heads do not divide the 2x2 mesh's model
    axis: ``wq`` is whole there and split over data, as arctic-480b's
    56 heads on 16x16; its 1 KV head is whole over model too."""
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as sh

    cfg = port_cfg("arctic-3h")
    specs = sh.make_pspecs(cfg, M.make_mesh((2, 2), ("data", "model")), dryrun.meta_model(cfg))
    assert cfg.fsdp
    assert specs["layers.0.attn.wq"] == ("data", None, None)
    assert specs["layers.0.attn.wk"] == ("data", None, None)
    assert specs["layers.0.attn.wo"] == (None, None, "data")


@pytest.mark.parametrize("n,shape,label", MESH_CASES, ids=MESH_IDS)
def test_fsdp_decode_matches_one_device_and_reference(worlds, reference, n, shape, label):
    """The prefill's and every decode step's logits on the mesh within
    DECODE_TOL of the one-device port's and of the reference's on the
    same weights and tokens."""
    _, want_ref = reference[label]
    for rank_out in worlds[n]:
        got = rank_out[(label, shape)][0]
        one = rank_out[(label, None)]
        assert len(got) == STEPS + 1
        for want in (one, want_ref):
            for i, (g, w) in enumerate(zip(got, want, strict=True)):
                torch.testing.assert_close(g, w, **DECODE_TOL, msg=f"step {i}")


@pytest.mark.parametrize("n,shape,label", MESH_CASES, ids=MESH_IDS)
def test_fsdp_decode_moves_rows_and_prefill_gathers_blocks(worlds, n, shape, label):
    """The decode steps exchange the tokens' rows (all-to-alls, the
    projections' reduce-scatters) and no collective takes a block of an
    attention weight; the prefill all-gathers those blocks, as FSDP
    does."""
    for rank_out in worlds[n]:
        _, prefill, steps, blocks = rank_out[(label, shape)]
        names = {name for name, _ in steps}
        assert {"all_to_all_single", "reduce_scatter_tensor"} <= names, names
        assert not [c for c in steps if c[1] in blocks], steps
        gathered = {s for name, s in prefill if name == "all_gather_into_tensor"}
        assert gathered & blocks, (prefill, blocks)


# -- on meta: what moves, and the shared rule ------------------------------------------


def test_decode_bytes_grow_with_rows_not_weights():
    """The reduced arctic decode at 2x1 (dry run, fake world) with a head
    dimension of 16 and of 64 at the same batch: the weights of every
    attention layer grow 4x, and the decode's collective bytes a device
    grow by exactly the rows' share, the reduce-scatter of each token's q,
    k and v (H + 2 KV heads) and the all-gather of its attention output
    (H heads), under a quarter of what gathering the grown blocks would
    add; the prefill's bytes grow by at least the blocks' gather."""
    from repro_torch.configs.shapes import ShapeDef
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl

    mesh = M.make_mesh((2, 1), ("data", "model"))
    cfgs = [port_cfg("arctic").replace(head_dim=hd) for hd in (16, 64)]
    c = cfgs[0]
    layers = sum(1 for bd in c.layer_defs() if bd.mixer == "attn")
    t, n = B // 2, 2
    cols = [(c.q_heads + 2 * c.kv_heads) * cf.head_dim + c.q_heads * cf.head_dim for cf in cfgs]
    rows = layers * rl.collective_traffic("reduce-scatter", t * (cols[1] - cols[0]) * 4, n)
    blocks = [4 * c.d_model // n * (2 * c.q_heads + 2 * c.kv_heads) * cf.head_dim for cf in cfgs]
    gather = layers * rl.collective_traffic("all-gather", n * (blocks[1] - blocks[0]), n)
    assert rows < gather / 4
    dec = [dryrun.run_cell(cf, ShapeDef("t", "decode", 64, B), mesh, verbose=False) for cf in cfgs]
    grown = dec[1]["collective_traffic_per_device"] - dec[0]["collective_traffic_per_device"]
    assert grown == pytest.approx(rows)
    pre = [dryrun.run_cell(cf, ShapeDef("t", "prefill", 64, B), mesh, verbose=False) for cf in cfgs]
    assert pre[1]["collective_traffic_per_device"] - pre[0]["collective_traffic_per_device"] >= gather


def test_rows_move_only_without_autograd():
    """``layers._rows_split`` on the reduced arctic's first attention layer
    at 2x1 (a fake world, on meta), a decode step's rows (B / 2 tokens a
    rank): without autograd, as the serving entry points run, the rows
    move for ``wq``/``wk``/``wv`` and for ``wo``; under autograd the
    blocks are gathered (FSDP's backward then reduce-scatters their
    gradients)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    cfg = port_cfg("arctic")
    mesh = M.make_mesh((2, 1), ("data", "model"))
    with M.fake_world(mesh.size):
        dm = M.device_mesh(mesh, "cpu")
        model = dryrun.meta_model(cfg)
        sh.distribute_params(cfg, dm, model)
        p = model.layers[0].attn
        x = sh.place(torch.empty((B, 1, cfg.d_model), device="meta"), sh.batch_sharding(dm, 3))
        out = sh.place(torch.empty((B, 1, cfg.q_heads, cfg.head_dim), device="meta"), sh.batch_sharding(dm, 4))
        cases = [(x, (p.wq, p.wk, p.wv), 0), (out, (p.wo,), 2)]
        with torch.no_grad():
            assert all(L._rows_split(*case) is not None for case in cases)
        assert all(L._rows_split(*case) is None for case in cases)


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b", "command-r-35b", "llama-3.2-vision-90b"])
def test_shared_rule_moves_rows_at_decode_and_blocks_at_prefill_and_train(arch):
    """``sharding.moves_rows`` on the FSDP configs at full width on 16x16,
    from the counts every path gives it (``layers.qkv_elems``,
    ``out_elems``, ``experts_elems``): a rank's tokens of ``decode_32k``
    (8) move for the attention's projections, its output projection and
    the MoE; those of ``prefill_32k`` and ``train_4k`` gather the
    blocks."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    cfg = registry.get(arch)
    assert cfg.fsdp
    d_size = m_size = 16
    heads = lambda h: h // m_size if h % m_size == 0 else h  # noqa: E731 - make_pspecs' rule
    hd, cdt, pdt = cfg.head_dim, cfg.compute_dtype, cfg.param_dtype
    qh = heads(cfg.q_heads)
    exchanges = {"qkv": L.qkv_elems(cfg.d_model, d_size, (qh + 2 * heads(cfg.kv_heads)) * hd),
                 "out": L.out_elems(cfg.d_model, d_size, qh * hd if qh < cfg.q_heads
                                    else cfg.q_heads * hd // m_size)}
    if cfg.num_experts:
        exchanges["moe"] = L.experts_elems(cfg.d_model, d_size, cfg.moe_top_k,
                                           cfg.num_experts // m_size, cfg.d_ff)
    for name in ("decode_32k", "prefill_32k", "train_4k"):
        shape = SHAPES[name]
        tokens = shape.global_batch // d_size * (1 if shape.kind == "decode" else shape.seq_len)
        for what, elems in exchanges.items():
            assert sh.moves_rows(tokens, *elems, cdt, pdt) == (shape.kind == "decode"), (name, what)
