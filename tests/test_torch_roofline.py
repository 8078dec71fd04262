"""``repro_torch.launch.roofline`` against the reference's
``repro.launch.roofline`` (model FLOPs, parameter counts, the ring model's
collective factors) and the kernels' work models against the bounds
``chip_smoke.py`` computed inline before they moved into the module."""

import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry
from repro.launch import roofline as jrl
from repro_torch.configs import registry
from repro_torch.core import distributions as dists
from repro_torch.launch import roofline as rl

ARCHS = registry.names()

# The H100 peaks and the bound as chip_smoke.py had them inline.
PRE_HBM, PRE_F32, PRE_F64, PRE_BF16 = 3.35e12, 67e12, 34e12, 989e12


def premove_bound_ms(bytes_moved, f32_ops, f64_ops=0):
    t_bytes = bytes_moved / PRE_HBM * 1e3
    t_ops = max(f32_ops / PRE_F32, f64_ops / PRE_F64) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def test_registry_order_is_the_reference():
    assert ARCHS == jregistry.names()


@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(name):
    cfg, jcfg = registry.get(name), jregistry.get(name)
    assert rl.active_param_count(cfg) == jrl.active_param_count(jcfg)
    assert rl.total_param_count(cfg) == jrl.total_param_count(jcfg)
    assert rl._full_attn_layers(cfg) == jrl._full_attn_layers(jcfg)
    for tokens in (1, 4096 * 256):
        assert rl.model_flops_train(cfg, tokens) == jrl.model_flops_train(jcfg, tokens)
    for b, s in ((1, 1), (32, 32_768), (128, 524_288)):
        assert rl.model_flops_prefill(cfg, b, s) == jrl.model_flops_prefill(jcfg, b, s)
        assert rl.model_flops_decode(cfg, b, s) == jrl.model_flops_decode(jcfg, b, s)


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


@pytest.mark.parametrize("op", COLLECTIVES)
@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("start", ["", "-start"])
def test_collective_traffic_equals_parse_collectives(op, group, start):
    """One synthetic post-SPMD HLO line per collective kind and group size:
    the reference parses its result bytes and group; the port's ring model
    gives the same traffic from them."""
    members = ",".join(str(i) for i in range(group))
    line = (f"  %x = bf16[64,128]{{1,0}} {op}{start}(bf16[64,128]{{1,0}} %y), "
            f"replica_groups={{{{{members}}}}}, dimensions={{0}}")
    stats = jrl.parse_collectives(line, total_devices=256)
    want = stats.op_traffic[op]
    assert rl.collective_traffic(op, 64 * 128 * 2, group) == want
    port = rl.CollectiveStats()
    port.add(op, rl.collective_traffic(op, 64 * 128 * 2, group))
    assert (port.op_counts, port.op_traffic, port.per_device_traffic_bytes) == \
        (stats.op_counts, stats.op_traffic, stats.per_device_traffic_bytes)


def test_collective_traffic_refuses_an_unknown_op():
    with pytest.raises(ValueError):
        rl.collective_traffic("all-shuffle", 1024, 4)


def test_roofline_terms_with_the_h100_constants():
    coll = rl.CollectiveStats()
    coll.add("all-reduce", 2e9)
    r = rl.make_roofline(1e15, 1e12, coll, 4, 2e15)
    assert r.compute_s == 4e15 / (4 * 989e12)
    assert r.memory_s == 4e12 / (4 * 3.35e12)
    assert r.collective_s == 2e9 / rl.LINK_BW
    assert r.dominant == "compute" and r.bound_s == r.compute_s
    assert r.useful_ratio == 2e15 / 4e15
    assert r.roofline_fraction == (2e15 / (989e12 * 4)) / r.bound_s
    assert rl.make_roofline(0, 0, rl.CollectiveStats(), 1, 0).roofline_fraction == 0.0


# The Set1 window of chip_smoke.py's [time] phases, its 818 grouped
# representatives and the two K5 shapes.
P, N, G = 6275, 1000, 818


@pytest.mark.parametrize("types, L, f64", [(4, 64, 0), (10, 20, 60_900_000), (4, 1000, 0),
                                           (4, 4000, 0), (4, 12000, 0)])
def test_k2_bound_is_the_premove_float(types, L, f64):
    want = premove_bound_ms(4 * (P * N + 2 * P + P * (L + 1) + 3 * types * P + types * P),
                            4 * P * N + 30 * P * types * (L + 1) + 3 * P * types * L, f64)
    assert rl.bound_ms(*rl.k2_work(P, N, types, L, f64_ops=f64)) == want


def test_kernel_bounds_are_the_premove_floats():
    L, t = 64, 4
    assert rl.bound_ms(*rl.k1_work(P, N, L)) == premove_bound_ms(4 * (P * N + 8 * P + P * (L + 1)),
                                                                 10 * P * N)
    assert rl.bound_ms(*rl.k3_work(P, N)) == premove_bound_ms(4 * (P * N + 8 * P), 10 * P * N)
    for L4 in (64, 1000, 4000, 12000):
        assert rl.bound_ms(*rl.k4_work(P, N, L4)) == premove_bound_ms(
            4 * (P * N + 2 * P + P * L4), 4 * P * N)
    assert rl.bound_ms(*rl.k2_work(P, N, t, L, rows=G)) == premove_bound_ms(
        4 * (G * N + 2 * G + G * (L + 1) + 3 * t * G + t * G) + 8 * G,
        4 * G * N + 30 * G * t * (L + 1) + 3 * G * t * L)


@pytest.mark.parametrize("case, want_ms", [((4, 4096, 16, 8, 256, 1024), 0.2432),
                                           ((4, 4096, 25, 5, 64, 1024), 0.0950)])
def test_k5_bound_is_the_premove_float(case, want_ms):
    b, s, h, kv, hd, w = case
    flops = 4 * hd * (w * (w + 1) // 2 + (s - w) * w) * b * h
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    t_ops, t_bytes = flops / PRE_BF16 * 1e3, nbytes / PRE_HBM * 1e3
    want = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    work = rl.k5_work(b, s, h, kv, hd, w, torch.bfloat16)
    assert work == rl.Work(nbytes, bf16_ops=flops)
    assert rl.bound_ms(*work) == want
    assert round(want[0], 4) == want_ms
    # float32 K5 runs on the CUDA cores: its products at the float32 peak.
    f32 = rl.k5_work(b, s, h, kv, hd, w, torch.float32)
    assert f32 == rl.Work(2 * nbytes, f32_ops=flops)


def test_set1_bounds_are_perf_md_s_column():
    """The kernel table's bound column: K1, K2 at T = 4 and T = 10, K2 over
    818 rows, K3 and K4, rounded as PERF.md writes them."""
    got = [rl.bound_ms(*w)[0] for w in (
        rl.k1_work(P, N, 64), rl.k2_work(P, N, 4, 64), rl.k2_work(P, N, 10, 20),
        rl.k2_work(P, N, 4, 64, rows=G), rl.k3_work(P, N), rl.k4_work(P, N, 64))]
    assert [round(x, 4) for x in got] == [0.0080, 0.0081, 0.0080, 0.0011, 0.0076, 0.0080]


def test_band_pairs():
    for s, w in ((1, 4), (4, 4), (5, 4), (4096, 1024), (700, 1024)):
        brute = sum(min(i + 1, w) for i in range(s))
        assert rl.band_pairs(s, w) == brute


def test_special_function_ops_counts_only_gamma_and_student_t():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.gamma(3.0, 2.0, size=(16, 200)).astype(np.float32))
    m = dists.moments_from_values(x)
    from repro_torch.core import pdf_error as pe

    edges = pe.interval_edges(m.vmin, m.vmax, 20).numpy()
    plain = [t for t in dists.TYPES_10 if t not in ("gamma", "student_t")]
    params = dists.fit_all(tuple(plain), m).reshape(16, -1).numpy()
    assert rl.special_function_ops(params, edges, plain) == 0
    both = ("gamma", "student_t")
    params = dists.fit_all(both, m).reshape(16, -1).numpy()
    ops = rl.special_function_ops(params, edges, both)
    assert ops > 0 and ops == rl.special_function_ops(params, edges, both)
    assert rl.special_function_ops(params[:, :3], edges, ("gamma",)) < ops


def test_h100_constants():
    assert (rl.PEAK_FLOPS, rl.F32_FLOPS, rl.F64_FLOPS, rl.HBM_BW) == (989e12, 67e12, 34e12, 3.35e12)
    assert math.isclose(rl.LINK_BW, 450e9)
    assert rl.bound_ms(3.35e9) == (1.0, "bytes")
    assert rl.bound_ms(0, f64_ops=34e9) == (1.0, "operations")
