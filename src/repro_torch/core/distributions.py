"""Candidate distribution types (§6.1 of the paper): fitters and CDFs.

Port of ``repro.core.distributions``. Every formula keeps the reference's
operation order, in float32, so the fitters agree with the JAX package to
float32 rounding. Every distribution is parameterized by a fixed-width
``(..., 3)`` parameter slot so all types stack into one ``(..., T, 3)``
tensor (Algorithm 3's fit-all-types path is then an ``argmin`` over the
type axis).

Two functions torch lacks are written here: ``cbrt`` (as
``sign(x)·|x|^(1/3)``, within an ulp or two of a correctly rounded cube
root) and ``betainc``, the regularized incomplete beta of ``cdf_student_t``
(a continued fraction with a fixed iteration count, in float64).

Moment conventions: ``mean``, ``var`` (unbiased, n-1), ``skew`` (g1 =
m3/sigma^3), ``kurt`` (excess, m4/sigma^4 - 3), ``vmin``, ``vmax``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

# The paper's two candidate sets (§6.1).
TYPES_4: tuple[str, ...] = ("normal", "uniform", "exponential", "lognormal")
TYPES_10: tuple[str, ...] = TYPES_4 + (
    "cauchy",
    "gamma",
    "geometric",
    "logistic",
    "student_t",
    "weibull",
)

_EPS = 1e-12
_BIG = 1e30


class Moments(NamedTuple):
    """Per-point summary statistics; every field has the same leading shape."""

    mean: torch.Tensor
    var: torch.Tensor
    skew: torch.Tensor
    kurt: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.var, min=0.0))


def moments_from_values(values: torch.Tensor, axis: int = -1) -> Moments:
    """Reference moment computation (two-pass, centred); the fitpdf moments
    kernel computes the shifted-sum form and is held to this at 2e-3."""
    n = values.shape[axis]
    mean = torch.mean(values, dim=axis)
    centered = values - mean.unsqueeze(axis)
    m2 = torch.mean(centered * centered, dim=axis)
    m3 = torch.mean(centered * (centered * centered), dim=axis)
    c2 = centered * centered
    m4 = torch.mean(c2 * c2, dim=axis)
    var = m2 * n / max(n - 1, 1)  # unbiased, Eq. 2 of the paper
    sig = torch.sqrt(torch.clamp(m2, min=_EPS))
    skew = m3 / (sig * (sig * sig))
    m2c = torch.clamp(m2, min=_EPS)
    kurt = m4 / (m2c * m2c) - 3.0
    return Moments(mean, var, skew, kurt, torch.amin(values, dim=axis),
                   torch.amax(values, dim=axis))


# ---------------------------------------------------------------------------
# Per-type method-of-moments fitters. Each returns (..., 3) params.
# Parameter slot layout is documented per function; unused slots are zero.
# ---------------------------------------------------------------------------


def _pack(*ps: torch.Tensor) -> torch.Tensor:
    ps = ps + (torch.zeros_like(ps[0]),) * (3 - len(ps))
    return torch.stack(ps, dim=-1)


def fit_normal(m: Moments) -> torch.Tensor:
    """[mu, sigma, 0]"""
    return _pack(m.mean, torch.clamp(m.std, min=_EPS))


def fit_uniform(m: Moments) -> torch.Tensor:
    """[a, b, 0] — observed support, as the paper's R fitter uses the data range."""
    return _pack(m.vmin, torch.maximum(m.vmax, m.vmin + _EPS))


def fit_exponential(m: Moments) -> torch.Tensor:
    """[rate, 0, 0] — rate = 1/mean."""
    return _pack(1.0 / torch.clamp(m.mean, min=_EPS))


def fit_lognormal(m: Moments) -> torch.Tensor:
    """[mu, sigma, 0] of log-space."""
    mean = torch.clamp(m.mean, min=_EPS)
    sigma2 = torch.log1p(torch.clamp(m.var, min=0.0) / (mean * mean))
    mu = torch.log(mean) - 0.5 * sigma2
    return _pack(mu, torch.sqrt(torch.clamp(sigma2, min=_EPS)))


def fit_cauchy(m: Moments) -> torch.Tensor:
    """[loc, scale, 0]: the robust fallback loc=mean, scale=std/2 of the
    reference (the moment pipeline carries no median/IQR)."""
    return _pack(m.mean, torch.clamp(0.5 * m.std, min=_EPS))


def fit_gamma(m: Moments) -> torch.Tensor:
    """[k (shape), theta (scale), 0]."""
    mean = torch.clamp(m.mean, min=_EPS)
    var = torch.clamp(m.var, min=_EPS)
    k = mean * mean / var
    theta = var / mean
    return _pack(torch.clamp(k, min=_EPS), torch.clamp(theta, min=_EPS))


def fit_geometric(m: Moments) -> torch.Tensor:
    """[p, 0, 0] on support {0,1,2,...}: p = 1/(1+mean)."""
    p = 1.0 / (1.0 + torch.clamp(m.mean, min=0.0))
    return _pack(torch.clamp(p, _EPS, 1.0))


def fit_logistic(m: Moments) -> torch.Tensor:
    """[loc, s, 0]: s = std*sqrt(3)/pi."""
    s = m.std * math.sqrt(3.0) / math.pi
    return _pack(m.mean, torch.clamp(s, min=_EPS))


def fit_student_t(m: Moments) -> torch.Tensor:
    """[loc, scale, nu] — location-scale t; nu from excess kurtosis
    (gamma2 = 6/(nu-4) => nu = 4 + 6/gamma2), clamped to (4.5, 50)."""
    g2 = torch.clamp(m.kurt, min=_EPS)
    nu = torch.clamp(4.0 + 6.0 / g2, 4.5, 50.0)
    scale = torch.sqrt(torch.clamp(m.var, min=_EPS) * (nu - 2.0) / nu)
    return _pack(m.mean, torch.clamp(scale, min=_EPS), nu)


def _weibull_cv2(k: torch.Tensor) -> torch.Tensor:
    """Squared coefficient of variation of Weibull(k, 1)."""
    lg1 = torch.lgamma(1.0 + 1.0 / k)
    lg2 = torch.lgamma(1.0 + 2.0 / k)
    return torch.exp(lg2 - 2.0 * lg1) - 1.0


def fit_weibull(m: Moments, iters: int = 20) -> torch.Tensor:
    """[k (shape), lam (scale), 0] — solve CV^2(k) = var/mean^2 by bisection
    (20 halvings of (0.2, 50) give k to ~1e-4 relative)."""
    mean = torch.clamp(m.mean, min=_EPS)
    target = torch.clamp(torch.clamp(m.var, min=_EPS) / (mean * mean), 1e-6, 1e4)

    lo = torch.full_like(mean, 0.2)
    hi = torch.full_like(mean, 50.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        # CV^2 is decreasing in k.
        too_small_k = _weibull_cv2(mid) < target  # need smaller k
        hi = torch.where(too_small_k, mid, hi)
        lo = torch.where(too_small_k, lo, mid)
    k = 0.5 * (lo + hi)
    lam = mean / torch.exp(torch.lgamma(1.0 + 1.0 / k))
    return _pack(k, lam)


_FITTERS = {
    "normal": fit_normal,
    "uniform": fit_uniform,
    "exponential": fit_exponential,
    "lognormal": fit_lognormal,
    "cauchy": fit_cauchy,
    "gamma": fit_gamma,
    "geometric": fit_geometric,
    "logistic": fit_logistic,
    "student_t": fit_student_t,
    "weibull": fit_weibull,
}


def fit_all(types: Sequence[str], m: Moments) -> torch.Tensor:
    """Algorithm 3 line 3 for every candidate type: (..., T, 3) params."""
    return torch.stack([_FITTERS[t](m) for t in types], dim=-2)


# ---------------------------------------------------------------------------
# Special functions torch does not have.
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)
_BETACF_ITERS = 64  # the student_t case (a in [2.25, 25], b = 1/2) converges in < 30
_TINY = 1e-300


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, ``sign(x)·|x|^(1/3)``: within an ulp or two of a
    correctly rounded cube root (torch has no ``cbrt``)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _betacf(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Continued fraction of the incomplete beta (modified Lentz), a fixed
    number of terms so the computation has no data-dependent control flow."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0

    def fix(v):
        return torch.where(v.abs() < _TINY, torch.full_like(v, _TINY), v)

    c = torch.ones_like(x)
    d = 1.0 / fix(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETACF_ITERS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / fix(1.0 + aa * d)
        c = fix(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / fix(1.0 + aa * d)
        c = fix(1.0 + aa / c)
        h = h * d * c
    return h


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b), computed in float64 and
    returned in ``x``'s dtype. Uses the continued fraction on the side of
    (a+1)/(a+b+2) where it converges, and I_x(a,b) = 1 - I_{1-x}(b,a) on the
    other."""
    out_dtype = x.dtype
    a, b, x = torch.broadcast_tensors(a.double(), b.double(), x.double())
    inside = (x > 0.0) & (x < 1.0)
    xs = torch.where(inside, x, torch.full_like(x, 0.5))
    swap = xs > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - xs, xs)
    front = torch.exp(
        torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
        + aa * torch.log(xx) + bb * torch.log1p(-xx)
    )
    part = front * _betacf(aa, bb, xx) / aa
    res = torch.where(swap, 1.0 - part, part)
    res = torch.where(x <= 0.0, torch.zeros_like(x), res)
    res = torch.where(x >= 1.0, torch.ones_like(x), res)
    res = torch.where(torch.isnan(x) | torch.isnan(a) | torch.isnan(b), x + a + b, res)
    return res.to(out_dtype)


# ---------------------------------------------------------------------------
# CDFs. cdf_<type>(params (...,3), x (...)) -> (...). Broadcasting applies.
# ---------------------------------------------------------------------------


def _phi(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def cdf_normal(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _phi((x - p[..., 0]) / p[..., 1])


def cdf_uniform(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x - p[..., 0]) / (p[..., 1] - p[..., 0]), 0.0, 1.0)


def cdf_exponential(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0, 0.0, 1.0 - torch.exp(-p[..., 0] * torch.clamp(x, min=0.0))
    )


def cdf_lognormal(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    safe_x = torch.clamp(x, min=_EPS)
    return torch.where(x <= 0, 0.0, _phi((torch.log(safe_x) - p[..., 0]) / p[..., 1]))


def cdf_cauchy(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return 0.5 + torch.atan((x - p[..., 0]) / p[..., 1]) / math.pi


# Above this shape parameter the reference switches to the Wilson-Hilferty
# cube-root normal approximation (its f32 incomplete gamma is slow and
# ulp-unstable there); the port keeps the switch so both compute the same
# function.
_GAMMA_WH_K = 1e4


def cdf_gamma(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    k, theta = p[..., 0], p[..., 1]
    xs = torch.clamp(x, min=0.0) / theta
    # The reference clamps the exact branch's inputs (its where evaluates
    # both branches); for k <= _GAMMA_WH_K the clamp of xs is inert.
    exact = torch.special.gammainc(
        torch.clamp(k, max=_GAMMA_WH_K), torch.clamp(xs, max=2.0 * _GAMMA_WH_K)
    )
    kk = torch.clamp(k, min=_EPS)
    z = (cbrt(xs / kk) - (1.0 - 1.0 / (9.0 * kk))) * torch.sqrt(9.0 * kk)
    return torch.where(x <= 0, 0.0, torch.where(k > _GAMMA_WH_K, _phi(z), exact))


def cdf_geometric(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # Support {0,1,...}: F(x) = 1 - (1-p)^(floor(x)+1) for x >= 0. The
    # clamp's bound 1 - 1e-12 rounds to 1.0 in float32, as in the reference.
    k = torch.floor(torch.clamp(x, min=0.0))
    q = torch.log1p(-torch.clamp(p[..., 0], max=1 - _EPS))
    return torch.where(x < 0, 0.0, 1.0 - torch.exp((k + 1.0) * q))


def cdf_logistic(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid((x - p[..., 0]) / p[..., 1])


def cdf_student_t(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    loc, scale, nu = p[..., 0], p[..., 1], p[..., 2]
    t = (x - loc) / scale
    ib = betainc(0.5 * nu, torch.full_like(nu, 0.5), nu / (nu + t * t))
    return torch.where(t >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


def cdf_weibull(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    k, lam = p[..., 0], p[..., 1]
    z = torch.clamp(x, min=0.0) / lam
    return torch.where(x <= 0, 0.0, -torch.expm1(-torch.pow(z, k)))


_CDFS = {
    "normal": cdf_normal,
    "uniform": cdf_uniform,
    "exponential": cdf_exponential,
    "lognormal": cdf_lognormal,
    "cauchy": cdf_cauchy,
    "gamma": cdf_gamma,
    "geometric": cdf_geometric,
    "logistic": cdf_logistic,
    "student_t": cdf_student_t,
    "weibull": cdf_weibull,
}


def cdf(type_name: str, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _CDFS[type_name](params, x)


def cdf_all(types: Sequence[str], params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """params (..., T, 3), x (..., K) -> (..., T, K): every type's CDF at x."""
    # params[..., t, None, :] is (..., 1, 3); its param columns broadcast
    # (..., 1) against x (..., K) -> (..., K). Stack over the T types.
    return torch.stack(
        [_CDFS[t](params[..., i, None, :], x) for i, t in enumerate(types)], dim=-2
    )

