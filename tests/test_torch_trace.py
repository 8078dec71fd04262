"""The port's spans (``runtime/trace.py``) on the CPU: off they change
nothing, on they change no bit and give each prefill and training step the
span tree the model implies, with backward spans opened and closed by
autograd, and host ranges in a ``torch.profiler`` trace."""

import collections
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry
from repro_torch.configs.base import BlockDef
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import trace

S_LEN, BATCH = 32, 2
SSD_PARTS = ("ssd.proj", "ssd.intra", "ssd.states", "ssd.scan", "ssd.inter", "ssd.out")


def mamba2():
    return registry.get("mamba2-780m").reduced().replace(remat="full")


def hymba():
    """hymba reduced, laid out as the published model: a global prefix
    layer, then windowed and global hybrid layers in turn, K5's path for
    the windowed ones; remat full as the benchmark trains it."""
    glob = BlockDef(mixer="hybrid", window=None, ffn="dense")
    return registry.get("hymba-1.5b").reduced().replace(
        prefix=(glob,), pattern=(BlockDef(mixer="hybrid", window=8, ffn="dense"), glob), num_layers=5,
        block_local_attn=True, remat="full")


CONFIGS = {"mamba2": mamba2, "hymba": hymba}


@pytest.fixture(autouse=True)
def tracing_left_off():
    yield
    trace.disable()
    trace.drain()


def _model(cfg):
    return T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")


def _tokens(cfg):
    return torch.randint(0, cfg.vocab, (BATCH, S_LEN), generator=torch.Generator().manual_seed(0))


def _prefill(cfg, tokens):
    return T.prefill(_model(cfg), tokens, cfg, max_len=S_LEN + 4)


def _steps(cfg, tokens, n=2):
    """n training steps from the same weights: the parameters and the
    last loss."""
    model = _model(cfg)
    model.requires_grad_(True)
    opt_cfg = AdamWConfig()
    opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
    step = train.build_step(cfg, opt_cfg, 10)
    batch = {"tokens": tokens, "targets": tokens.roll(1, 1)}
    for _ in range(n):
        model, opt, loss, _ = step(model, opt, batch)
    return [p.detach().clone() for p in model.parameters()] + [loss]


def _graph_nodes(cfg, tokens) -> collections.Counter:
    """The loss's autograd nodes, by type name."""
    model = _model(cfg)
    model.requires_grad_(True)
    loss = T.loss_fn(model, tokens, tokens.roll(1, 1), cfg)
    seen, todo, names = set(), [loss.grad_fn], collections.Counter()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names[type(node).__name__] += 1
        todo.extend(n for n, _ in node.next_functions)
    return names


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_off_records_nothing_and_adds_no_node(name):
    cfg, tokens = CONFIGS[name](), _tokens(CONFIGS[name]())
    assert not trace.enabled() and trace.span("ssd") is trace.OFF
    logits, _ = _prefill(cfg, tokens)
    assert torch.equal(logits, _prefill(cfg, tokens)[0])
    assert _equal(_steps(cfg, tokens), _steps(cfg, tokens))
    off = _graph_nodes(cfg, tokens)
    assert not {"_OutBoundaryBackward", "_InBoundaryBackward"} & set(off) and trace.drain() == []
    trace.enable("cpu")
    on = _graph_nodes(cfg, tokens)
    layers = cfg.layer_defs()
    bounded = len(layers) + sum(bd.window is None for bd in layers if bd.mixer == "hybrid")
    assert on - off == collections.Counter({"_OutBoundaryBackward": bounded, "_InBoundaryBackward": bounded})
    assert off - on == collections.Counter()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_on_changes_no_bit(name):
    cfg, tokens = CONFIGS[name](), _tokens(CONFIGS[name]())
    logits, caches = _prefill(cfg, tokens)
    params = _steps(cfg, tokens)
    trace.enable("cpu")
    logits_on, caches_on = _prefill(cfg, tokens)
    assert torch.equal(logits, logits_on)
    for c, c_on in zip(caches, caches_on):
        for mixer in c:
            assert _equal(c[mixer].values(), c_on[mixer].values())
    assert _equal(params, _steps(cfg, tokens))
    assert trace.drain()


def _by_unit(spans) -> dict:
    units = collections.defaultdict(list)
    for s in spans:
        units[s.unit].append(s)
    return units


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_span_tree_of_a_prefill_and_a_step(name):
    cfg, tokens = CONFIGS[name](), _tokens(CONFIGS[name]())
    layers = cfg.layer_defs()
    n, n_pre = len(layers), len(cfg.prefix)
    glob = [i for i, bd in enumerate(layers) if bd.mixer in ("attn", "hybrid") and bd.window is None]
    band = [i for i, bd in enumerate(layers) if bd.window is not None]
    ffn = sum(bd.ffn != "none" for bd in layers)
    trace.enable("cpu")
    _prefill(cfg, tokens)
    _steps(cfg, tokens, n=1)
    units = _by_unit(trace.drain())
    assert None not in units and len(units) == 2
    prefill, step = (units[u] for u in sorted(units))

    roots = [s for s in prefill if s.parent is None]
    assert [r.name for r in roots] == ["prefill"] and prefill[0] is roots[0]
    counts = collections.Counter((s.name, s.phase) for s in prefill)
    want = {("prefill", "forward"): 1, ("block", "forward"): n, ("ssd", "forward"): n,
            ("attn.global", "forward"): len(glob), ("attn.band", "forward"): len(band),
            ("ffn", "forward"): ffn, **{(p, "forward"): n for p in SSD_PARTS}}
    assert counts == collections.Counter({k: v for k, v in want.items() if v})
    assert [s.layer for s in prefill if s.name == "block"] == list(range(n))
    assert [s.layer for s in prefill if s.name == "attn.global"] == glob
    for s in prefill[1:]:
        assert s.parent is not None and s.parent in prefill and s in s.parent.children
        assert s.parent.name == {"block": "prefill", "ssd": "block", "attn.global": "block",
                                 "attn.band": "block", "ffn": "block"}.get(s.name, "ssd")

    assert [s.name for s in step if s.parent is None] == ["train.step"]
    assert [s.name for s in step[0].children] == ["train.forward", "train.backward", "train.optimizer"]
    counts = collections.Counter((s.name, s.phase) for s in step)
    rec = n - n_pre
    rec_glob = [i for i in glob if i >= n_pre]
    want = {("train.step", None): 1, ("train.forward", "forward"): 1, ("train.backward", "backward"): 1,
            ("train.optimizer", None): 1, ("optim", None): 1, ("optim.norm", None): 1,
            ("optim.update", None): 1,
            ("block", "forward"): n, ("block", "recompute"): rec,
            ("ssd", "forward"): n, ("ssd", "recompute"): rec, ("ssd", "backward"): n,
            ("attn.global", "forward"): len(glob), ("attn.global", "recompute"): len(rec_glob),
            ("attn.global", "backward"): len(glob),
            ("attn.band", "forward"): len(band), ("attn.band", "recompute"): len(band),
            ("band_bwd", "backward"): len(band),
            ("ffn", "forward"): ffn, ("ffn", "recompute"): ffn - sum(bd.ffn != "none" for bd in cfg.prefix),
            **{(p, "forward"): n for p in SSD_PARTS}, **{(p, "recompute"): rec for p in SSD_PARTS}}
    assert counts == collections.Counter({k: v for k, v in want.items() if v})
    # recompute only outside the prefix, each layer once
    redone = sorted(s.layer for s in step if s.name == "block" and s.phase == "recompute")
    assert redone == list(range(n_pre, n))
    assert sorted(s.layer for s in step if s.name == "ssd" and s.phase == "backward") == list(range(n))
    backward = next(s for s in step if s.name == "train.backward")
    for s in step:
        if s.phase in ("backward", "recompute") and s.name != "train.backward":
            up = s.parent
            while up is not None and up is not backward:
                up = up.parent
            assert up is backward  # every backward and recompute span runs inside train.backward
        assert s.t0_ns <= s.t1_ns


def test_hybrid_ssd_backward_closes_before_attention_backward_opens():
    """In a hybrid layer the SSD's backward nodes, created after the
    attention's, run between the SSD's two boundaries and before any of
    the attention's: the spans do not overlap."""
    cfg, tokens = hymba(), _tokens(hymba())
    trace.enable("cpu")
    _steps(cfg, tokens, n=1)
    spans = trace.drain()
    ssd = {s.layer: s for s in spans if s.name == "ssd" and s.phase == "backward"}
    attn = {s.layer: s for s in spans if s.name == "attn.global" and s.phase == "backward"}
    assert attn and set(attn) <= set(ssd)
    for layer, a in attn.items():
        assert ssd[layer].t1_ns <= a.t0_ns
        assert a.parent is not ssd[layer] and ssd[layer].parent is a.parent


def test_profiler_sees_the_spans_as_host_ranges():
    from torch.profiler import ProfilerActivity, profile

    cfg, tokens = mamba2(), _tokens(mamba2())
    model = _model(cfg)
    trace.enable("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.prefill(model, tokens, cfg, max_len=S_LEN + 4)
    events = prof.events()
    ranges = {name: [e for e in events if e.name == name] for name in ("prefill", "ssd", "ssd.scan")}
    assert [len(ranges[k]) for k in ranges] == [1, cfg.num_layers, cfg.num_layers]
    for scan in ranges["ssd.scan"]:
        r = scan.time_range
        inside = [e.name for e in events if e.name.startswith("aten::") and e.thread == scan.thread
                  and r.start <= e.time_range.start and e.time_range.end <= r.end]
        assert "aten::stack" in inside  # _chunk_scan's ops run inside the range
        assert any(s.time_range.start <= r.start and r.end <= s.time_range.end for s in ranges["ssd"])
    r = ranges["prefill"][0].time_range
    assert all(r.start <= s.time_range.start and s.time_range.end <= r.end for s in ranges["ssd"])


def test_self_time_is_the_duration_less_the_children():
    trace.enable("cpu")
    with trace.span("outer", unit=True, phase="backward"):
        time.sleep(0.002)
        with trace.span("inner"):  # forward code inside a backward: a recompute
            time.sleep(0.004)
        with trace.span("inner", phase="backward"):
            time.sleep(0.001)
    outer, inner, same = trace.drain()
    assert inner.phase == "recompute" and same.phase == "backward" and outer.children == [inner, same]
    assert outer.unit == inner.unit == same.unit and inner.parent is outer and inner.layer is None
    assert outer.ms == outer.host_ms >= inner.ms + same.ms
    assert outer.self_ms == pytest.approx(outer.ms - inner.ms - same.ms)
    assert outer.self_ms >= 1.9
    assert outer.phase_ms == pytest.approx(outer.ms - inner.ms)
    assert inner.self_ms == inner.ms and trace.drain() == []


def test_a_span_open_at_a_drain_is_not_recorded():
    trace.enable("cpu")
    with trace.span("unit", unit=True):
        with trace.span("before"):
            pass
        assert [s.name for s in trace.drain()] == ["before"]
        with trace.span("after"):
            pass
    (after,) = trace.drain()
    assert after.name == "after" and after.parent is None and after.unit is not None


def test_recompute_inside_a_backward_span_is_left_out_of_its_phase():
    """In mamba2 each layer's first saved tensor is inside the SSD, so
    checkpoint's recompute of the layer runs inside the SSD's backward
    span; ``phase_ms`` leaves that child out."""
    cfg, tokens = mamba2(), _tokens(mamba2())
    trace.enable("cpu")
    _steps(cfg, tokens, n=1)
    spans = trace.drain()
    for s in (s for s in spans if s.name == "ssd" and s.phase == "backward"):
        assert [(c.name, c.phase, c.layer) for c in s.children] == [("block", "recompute", s.layer)]
        assert s.phase_ms == pytest.approx(s.ms - s.children[0].ms)


def test_a_backward_span_left_open_closes_with_its_parent():
    """An SSD whose input takes no gradient (its parameters do) gets no
    input boundary: its backward span, opened at the output, closes when
    the span around the backward does."""
    from repro_torch.models import ssm as S

    cfg = mamba2()
    p = _model(cfg).layers[0].ssm.requires_grad_(True)
    x = torch.randn(BATCH, S_LEN, cfg.d_model, generator=torch.Generator().manual_seed(2))
    trace.enable("cpu")
    with trace.span("step", unit=True):
        out = S.ssd(p, x, cfg)
        with trace.span("backward", phase="backward"):
            out.sum().backward()
        with trace.span("after"):
            pass
    spans = trace.drain()
    bwd, after = (next(s for s in spans if s.name == n) for n in ("backward", "after"))
    ssd_bwd = [s for s in spans if s.name == "ssd" and s.phase == "backward"]
    assert len(ssd_bwd) == 1 and ssd_bwd[0].parent is bwd and ssd_bwd[0].t1_ns <= bwd.t1_ns
    assert after.parent is spans[0] and after.phase is None
