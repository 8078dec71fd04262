"""The SSD's intra-chunk product on the CPU: which calls take the kernel's
wrapper, that the CPU runs the plain version under it, and that the dry
run charges its work model.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
Here its rule (``ops.kernel_takes`` and no gradient asked for) is held on
compute types and chunk lengths and on meta tensors, the plain path on
real tensors: CPU tensors never launch, a grad-requiring call takes the
plain path, meta tensors charge ``roofline.ssd_intra_work`` where the card
would launch, and the wrapper refuses what the kernel would refuse, on any
device.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts
from repro_torch.kernels.ssd_intra import kernel as tsk
from repro_torch.kernels.ssd_intra import ops, ssd_intra, ssd_intra_ref
from repro_torch.kernels.ssd_intra.ref import intra_matrix
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import Meter
from repro_torch.models import ssm as S


def _inputs(b=2, nc=2, q=64, h=4, p=6, g=2, n=8, dtype=torch.bfloat16, device="cpu", seed=0):
    rng = np.random.default_rng(seed)

    def draw(shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).to(device)

    cm, bm = draw((b, nc, q, g, n), n ** -0.5).to(dtype), draw((b, nc, q, g, n)).to(dtype)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cm, bm)
    ca = torch.cumsum(-torch.from_numpy(rng.uniform(0.0, 0.1, (b, nc, q, h)).astype(np.float32)), 2)
    return cb, ca.to(device), draw((b, nc, q, h, p)).to(dtype)


SRC = Path(__file__).resolve().parents[1] / "src"


def test_module_imports_without_a_card():
    """With no card visible the SSD and the kernel's package import, bind
    and build nothing, and run the plain path."""
    code = ("import torch; from repro_torch.models import ssm; from repro_torch.kernels import _launch, "
            "launch_counts; from repro_torch.kernels.ssd_intra import ssd_intra; "
            "x = torch.ones(1, 1, 64, 8, 2, dtype=torch.bfloat16); "
            "y = ssd_intra(torch.ones(1, 1, 1, 64, 64, dtype=torch.bfloat16), torch.zeros(1, 1, 64, 8), x); "
            "print(torch.cuda.is_available(), sorted(_launch._bound), launch_counts()['ssd_intra_kernel'], "
            "float(y[0, 0, -1, 0, 0]))")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         stdin=subprocess.DEVNULL, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "[]", "0", "64.0"]
    assert "ssd_intra_kernel" in launch_counts()


@pytest.mark.parametrize("dtype,q,want", [
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 256, True),
    (torch.bfloat16, 1024, True),
    (torch.float32, 256, False),
    (torch.float16, 256, False),
    (torch.bfloat16, 8, False),
    (torch.bfloat16, 32, False),
    (torch.bfloat16, 96, False),
])
def test_kernel_rule(dtype, q, want):
    """bf16 and a chunk that is a multiple of 64: each condition alone
    turns the kernel's wrapper off."""
    assert ops.kernel_takes(dtype, q) is want


@pytest.mark.parametrize("which", [0, 1, 2])
def test_kernel_rule_grad(which):
    """Any one of the three inputs requiring grad, with grad on, takes the
    plain path: on meta tensors nothing is charged. Under ``no_grad`` or
    ``inference_mode`` the same inputs go to the wrapper, which charges
    the kernel's work."""
    ins = [t.to("meta") for t in _inputs()]
    ins[which] = ins[which].requires_grad_()
    with Meter() as meter:
        assert ssd_intra(*ins).grad_fn is not None
    assert meter.kernels == {}
    for mode in (torch.no_grad, torch.inference_mode):
        with Meter() as meter, mode():
            assert ssd_intra(*ins).grad_fn is None
        assert meter.kernels["ssd_intra_kernel"]["launches"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("q", [8, 64, 128])
def test_cpu_takes_the_plain_path(dtype, g, q):
    """On the CPU ``ssd_intra`` is the plain version, bit for bit, and
    launches nothing."""
    before = tsk.ssd_intra_kernel.launches
    cb, ca, xdt = _inputs(q=q, g=g, dtype=dtype)
    got = ssd_intra(cb, ca, xdt)
    assert got.dtype == dtype and got.shape == xdt.shape
    assert torch.equal(got, ssd_intra_ref(cb, ca, xdt))
    assert tsk.ssd_intra_kernel.launches == before


def test_plain_version_is_the_ssd_operations():
    """The plain version is the SSD's operations: C.B repeated over each
    group's heads, the masked decay matrix in float32, its bf16 rounding,
    the product with xdt."""
    cb, ca, xdt = _inputs(h=6, g=3)
    m = torch.zeros(2, 2, 6, 64, 64)
    for h in range(6):
        for i in range(64):
            m[:, :, h, i, :i + 1] = cb[:, :, h // 2, i, :i + 1].float() * torch.exp(
                ca[:, :, i, h, None] - ca[:, :, :i + 1, h])
    want = torch.einsum("bchqk,bckhp->bcqhp", m.bfloat16(), xdt)
    assert torch.equal(ssd_intra_ref(cb, ca, xdt), want)


def test_meta_takes_the_plain_path():
    """Meta tensors (the dry run) in bf16 with a chunk of 64 are charged
    the kernel's work model (``roofline.ssd_intra_work``), not the plain
    version's operators; in float32 they take the plain path's operators
    and no charge. Neither counts a launch."""
    before = tsk.ssd_intra_kernel.launches
    cb, ca, xdt = (t.to("meta") for t in _inputs())
    with Meter() as meter:
        got = ssd_intra(cb, ca, xdt)
    assert got.device.type == "meta" and got.shape == xdt.shape and got.dtype == torch.bfloat16
    want = rl.ssd_intra_work(2, 2, 64, 4, 6, 2)
    assert meter.kernels == {"ssd_intra_kernel": dict(launches=1, **want._asdict())}
    assert meter.bytes == want.bytes
    cb, ca, xdt = (t.float().to("meta") for t in _inputs())
    with Meter() as meter:
        got = ssd_intra(cb, ca, xdt)
    assert got.device.type == "meta" and got.dtype == torch.float32
    assert meter.kernels == {} and meter.bytes > want.bytes
    assert tsk.ssd_intra_kernel.launches == before


def test_meta_training_counts_the_plain_path():
    """On meta tensors that require grad the forward and its backward are
    the plain version's operators, counted one by one, and no kernel is
    charged."""
    cb, ca, xdt = (t.to("meta").requires_grad_() for t in _inputs())
    with Meter() as meter:
        y = ssd_intra(cb, ca, xdt)
        grads = torch.autograd.grad(y, (cb, ca, xdt), torch.empty_like(y))
    assert meter.kernels == {} and meter.bytes > rl.ssd_intra_work(2, 2, 64, 4, 6, 2).bytes
    assert [g.shape for g in grads] == [cb.shape, ca.shape, xdt.shape]


@pytest.mark.parametrize("needs", [(True, True, True), (False, True, False), (False, False, True)],
                         ids=["all", "ca", "xdt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_grad_takes_the_plain_path(dtype, needs):
    """Inputs that require grad take the plain path, bit for bit, whose
    gradients are finite even past a decay of 88 (the masked exponent)."""
    before = tsk.ssd_intra_kernel.launches
    cb, ca, xdt = _inputs(dtype=dtype)
    ca = ca * 2000.0
    ins = [t.detach().requires_grad_(n) for t, n in zip((cb, ca, xdt), needs)]
    y = ssd_intra(*ins)
    assert torch.equal(y, ssd_intra_ref(*ins))
    y.float().sum().backward()
    for t, n in zip(ins, needs):
        assert (t.grad is not None and bool(torch.isfinite(t.grad).all())) if n else t.grad is None
    assert tsk.ssd_intra_kernel.launches == before


def test_intra_matrix_masks_above_the_diagonal():
    """Above the diagonal the matrix is 0 where the exponent is inf."""
    cb, ca, _ = _inputs(q=8, g=1, h=1, dtype=torch.float32)
    m = intra_matrix(cb, ca * 1e4)
    assert bool(torch.isfinite(m).all())
    assert bool((m.triu(1) == 0).all())


@pytest.mark.parametrize("bad,err", [
    (dict(dtype=torch.float32), TypeError),
    (dict(dtype=torch.float16), TypeError),
    (dict(q=32), ValueError),
    (dict(q=96), ValueError),
    (dict(p=5), ValueError),
    (dict(p=258), ValueError),
    (dict(p=252), ValueError),
    (dict(h=3, g=1, p=6), ValueError),
])
def test_kernel_wrapper_refuses_on_any_device(bad, err):
    """What the kernel would refuse, its wrapper refuses on the CPU too."""
    with pytest.raises(err):
        tsk.ssd_intra_kernel(*_inputs(**bad))


def test_kernel_wrapper_refuses_mismatched_operands():
    cb, ca, xdt = _inputs()
    with pytest.raises(TypeError):
        tsk.ssd_intra_kernel(cb, ca.double(), xdt)
    with pytest.raises(ValueError):
        tsk.ssd_intra_kernel(cb[:, :1], ca, xdt)
    with pytest.raises(ValueError):
        tsk.ssd_intra_kernel(cb, ca[..., :2], xdt)
    with pytest.raises(ValueError):  # 4 heads in 3 groups
        tsk.ssd_intra_kernel(torch.cat([cb, cb[:, :, :1]], 2), ca, xdt)
    with pytest.raises(ValueError):
        tsk.ssd_intra_kernel(cb, ca.to("meta"), xdt)
    assert torch.equal(tsk.ssd_intra_kernel(cb, ca, xdt), ssd_intra_ref(cb, ca, xdt))


def _bf16_ssd(g=2, chunk=64):
    cfg = types.SimpleNamespace(d_model=16, ssm_expand=2, ssm_head_dim=8, ssm_state=8, ssm_groups=g,
                                ssm_conv=4, ssm_chunk=chunk, param_dtype=torch.float32,
                                compute_dtype=torch.bfloat16)
    mod = S.SSD(cfg)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    mod.requires_grad_()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 100, 16)).astype(np.float32))
    return cfg, mod, x


def test_ssd_in_bf16_on_the_cpu_launches_nothing():
    """A whole bf16 ``ssd`` on the CPU, with and without grad, runs the
    plain version: the same output bits both ways."""
    cfg, mod, x = _bf16_ssd()
    before = tsk.ssd_intra_kernel.launches
    with torch.no_grad():
        got = S.ssd(mod, x, cfg)
    with_grad = S.ssd(mod, x.requires_grad_(), cfg)
    assert torch.equal(got, with_grad.detach())
    assert tsk.ssd_intra_kernel.launches == before


def test_ssd_bf16_gradients_are_the_plain_paths(monkeypatch):
    """A whole bf16 ``ssd``'s backward gives every parameter and the input
    the gradient of the plain path's own autograd, bit for bit."""
    cfg, mod, x = _bf16_ssd()
    grad = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 100, 16)).astype(np.float32))

    def grads():
        xr = x.detach().requires_grad_()
        out = S.ssd(mod, xr, cfg)
        params = [p for _, p in sorted(mod.named_parameters())]
        return torch.autograd.grad(out, [xr, *params], grad)

    got = grads()
    monkeypatch.setattr(S, "ssd_intra", ssd_intra_ref)
    want = grads()
    assert len(got) == len(want) == len(mod.state_dict()) + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_work_model_at_the_cells_shapes():
    """``roofline.ssd_intra_work``: xdt and y_intra, C.B and ca once each,
    2 P operations a pair of the lower-triangular tiles; bound by bytes at
    both cells' shapes (B 4, 16 chunks of 256)."""
    w = rl.ssd_intra_work(4, 16, 256, 48, 64, 1)
    assert w.bytes == 2 * 100_663_296 + 8_388_608 + 3_145_728
    assert w.bf16_ops == 2 * 64 * 10 * 64 * 64 * 4 * 16 * 48
    assert rl.bound_ms(*w)[1] == "bytes"
    w = rl.ssd_intra_work(4, 16, 256, 64, 50, 1)
    assert w.bytes == 2 * 104_857_600 + 8_388_608 + 4_194_304
    assert rl.bound_ms(*w)[1] == "bytes"
