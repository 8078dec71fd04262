"""Mamba-2 SSD (state-space duality) mixer: the chunked prefill form and the
O(1)-state decode step.

Port of ``repro.models.ssm``. Within a chunk of Q steps the output is a
masked quadratic form (two einsums); across chunks a small (H, N, P) state
is carried. The reference carries it with ``lax.associative_scan``; the port
with a sequential float32 loop over the S / Q chunks (16 at S = 4,096,
Q = 256), which differs from it by rounding only. Decode keeps that state
plus the last K - 1 inputs of the causal convolution, so the cache's size
does not depend on the sequence length.

The SSD has no Pallas kernel in the reference (einsums, cumsum, exp and the
scan), so it is plain PyTorch here too, but for the intra-chunk product
where no gradient is asked for: on the card in bf16 that is a hand-written
kernel (``kernels/ssd_intra``), which keeps the (B, Nc, H, Q, Q) decay
matrix out of device memory. The casts are the reference's, so bf16 compute
rounds where JAX rounds: ``dt`` goes to the compute type before it scales
x, the intra-chunk matrix is built in float32 and then cast, the chunk
states and the scan are float32, and the state before each chunk is cast
back.

One difference from the reference, on purpose: after a prompt shorter than
K - 1 tokens the reference's conv tail (``xbc_raw[:, s-(K-1):s]``) has a
negative start and comes out empty, so its first decode step is wrong. The
port left-pads the tail with zeros, the state ``init_ssd_cache`` starts
from, so it decodes as the token-by-token recurrence does.

Shapes: B batch, S sequence, H SSM heads, P head dim, N state dim, G groups
(B and C shared by H / G heads), Q chunk length, K conv width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_intra.ops import ssd_intra
from repro_torch.models.layers import RMSNorm, dense_init_, empty_param, rmsnorm, scaled_rmsnorm
from repro_torch.models import sharding as sh
from repro_torch.runtime import trace


def ssm_dims(cfg) -> tuple[int, int]:
    """(d_inner, SSM heads)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim


def _conv_dim(cfg) -> int:
    return ssm_dims(cfg)[0] + 2 * cfg.ssm_groups * cfg.ssm_state


class SSD(nn.Module):
    """The reference's ``init_ssd`` leaves: ``in_proj`` (d, 2 d_inner +
    2 G N + H) packing [z, x, B, C, dt], ``conv_w`` (K, conv_dim),
    ``conv_b``, ``a_log``, ``d_skip``, ``dt_bias`` (H,), ``norm.scale``
    (d_inner,) and ``out_proj`` (d_inner, d). ``a_log``, ``d_skip`` and
    ``dt_bias`` are float32 whatever ``cfg.param_dtype`` is, as in the
    reference."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, n, g, k = cfg.d_model, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
        d_inner, h = ssm_dims(cfg)
        dt, conv_dim = cfg.param_dtype, _conv_dim(cfg)
        self.in_proj = empty_param((d, 2 * d_inner + 2 * g * n + h), dt, device)
        self.conv_w = empty_param((k, conv_dim), dt, device)
        self.conv_b = empty_param((conv_dim,), dt, device)
        self.a_log = empty_param((h,), torch.float32, device)  # A = -exp(a_log)
        self.d_skip = empty_param((h,), torch.float32, device)
        self.dt_bias = empty_param((h,), torch.float32, device)
        self.norm = RMSNorm(d_inner, dt, device)
        self.out_proj = empty_param((d_inner, d), dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init_ssd``'s distributions: ``in_proj`` N(0, 1/d), ``conv_w``
        N(0, 1/K), ``out_proj`` N(0, 1/d_inner); ``conv_b``, ``a_log``
        (so A = -1), ``dt_bias`` and the norm zero, ``d_skip`` one."""
        k, d_inner = self.conv_w.shape[0], self.out_proj.shape[0]
        dense_init_(self.in_proj, generator)
        dense_init_(self.conv_w, generator, scale=k**-0.5)
        dense_init_(self.out_proj, generator, scale=d_inner**-0.5)
        self.conv_b.zero_()
        self.a_log.zero_()
        self.d_skip.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.reset_parameters()


def _split_proj(p: SSD, x: torch.Tensor, cfg):
    """x (..., d) in the compute type -> z (..., d_inner), xbc (...,
    conv_dim), dt (..., H)."""
    d_inner, h = ssm_dims(cfg)
    proj = x @ p.in_proj.to(x.dtype)
    return torch.split(proj, [d_inner, _conv_dim(cfg), h], dim=-1)


def _causal_conv(p: SSD, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU. xbc (B, S, C)."""
    k, s = p.conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * p.conv_w[i].to(xbc.dtype) for i in range(k))
    return F.silu(out + p.conv_b.to(xbc.dtype))


def _chunk_scan(bx: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """The inter-chunk recurrence h_after_c = gamma_c h_before_c + S_c from
    h = 0, in float32, one chunk after another (the reference's
    ``lax.associative_scan``). bx (B, Nc, H, N, P), gamma (B, Nc, H) ->
    the state after each chunk (B, Nc, H, N, P)."""
    run = bx[:, 0]
    states = [run]
    for c in range(1, bx.shape[1]):
        run = run * gamma[:, c, :, None, None] + bx[:, c]
        states.append(run)
    return torch.stack(states, dim=1)


def ssd(p: SSD, x_in: torch.Tensor, cfg, return_final_state: bool = False):
    """Chunked SSD forward. x_in (B, S, d) -> (B, S, d) [+ (state (B, H, N,
    P), conv_tail (B, K - 1, conv_dim)) if requested, both in the compute
    type: the cache ``ssd_decode`` continues from]. On DTensors each rank
    runs it on its own rows with the parameters whole
    (``sharding.local_rows``)."""
    return sh.local_rows(_ssd, p, x_in, cfg, return_final_state)


def _ssd(p: SSD, x_in: torch.Tensor, cfg, return_final_state: bool = False):
    """``ssd`` on plain tensors, traced as the span ``ssd``, its backward
    too (on DTensors: each rank's, on its own rows). The backward's
    boundaries sit just outside the span, so its parts cover it."""
    sp = trace.span("ssd")
    (x_in,) = sp.grad_in(x_in)
    with sp:
        out = _ssd_parts(p, x_in, cfg, return_final_state)
    return out if return_final_state else sp.grad_out(out)


def _ssd_parts(p: SSD, x_in: torch.Tensor, cfg, return_final_state: bool):
    """The SSD's six parts, each a span: ssd.proj ... ssd.out cover it whole."""
    with trace.span("ssd.proj"):
        cdt = cfg.compute_dtype
        b, orig_s, _ = x_in.shape
        g, n, q, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk, cfg.ssm_conv
        d_inner, h = ssm_dims(cfg)
        pdim, hpg = cfg.ssm_head_dim, h // g
        # Pad S to a chunk multiple; padded steps get dt = 0 (identity state
        # transition, zero input), so the outputs and the final state do not
        # see them.
        pad = (-orig_s) % q
        if pad:
            x_in = F.pad(x_in, (0, 0, 0, pad))
        s = orig_s + pad
        nc = s // q

        z, xbc_raw, dt_raw = _split_proj(p, x_in.to(cdt), cfg)
        xbc = _causal_conv(p, xbc_raw)
        x, bmat, cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)

        dt = F.softplus(dt_raw.float() + p.dt_bias)  # (B, S, H)
        if pad:
            valid = (torch.arange(s, device=dt.device) < orig_s)[None, :, None]
            dt = torch.where(valid, dt, torch.zeros((), dtype=dt.dtype, device=dt.device))
        da = dt * -torch.exp(p.a_log)  # (B, S, H) log-decay a step

        xh = x.reshape(b, nc, q, h, pdim)
        bm = bmat.reshape(b, nc, q, g, n)
        cm = cmat.reshape(b, nc, q, g, n)
        ca = torch.cumsum(da.reshape(b, nc, q, h), dim=2)  # inclusive, float32
        xdt = xh * dt.reshape(b, nc, q, h)[..., None].to(cdt)

    with trace.span("ssd.intra"):
        y_intra = ssd_intra(torch.einsum("bcqgn,bckgn->bcgqk", cm, bm), ca, xdt)  # C.B (B, Nc, G, Q, Q)

    # Chunk states S_c = sum_j exp(ca_last - ca_j) B_j (dt_j x_j)^T, in
    # float32 from here to the scan.
    with trace.span("ssd.states"):
        tail = torch.exp(ca[..., -1:, :] - ca)  # (B, Nc, Q, H)
        bx = torch.einsum("bcqhn,bcqhp->bchnp", bm.repeat_interleave(hpg, dim=3),
                          xdt * tail[..., None].to(cdt)).float()
        gamma = torch.exp(ca[:, :, -1, :])  # (B, Nc, H) a chunk's total decay

    with trace.span("ssd.scan"):
        states = _chunk_scan(bx, gamma)

    with trace.span("ssd.inter"):
        h_before = torch.cat([torch.zeros_like(states[:, :1]), states[:, :-1]], dim=1).to(cdt)
        y_inter = torch.einsum("bcqhn,bchnp->bcqhp", cm.repeat_interleave(hpg, dim=3),
                               h_before) * torch.exp(ca)[..., None].to(cdt)

    with trace.span("ssd.out"):
        y = (y_intra + y_inter + xh * p.d_skip.to(cdt)[:, None]).reshape(b, s, d_inner)
        y = rmsnorm(p.norm, y * F.silu(z))
        out = (y @ p.out_proj.to(cdt))[:, :orig_s]

        if not return_final_state:
            return out
        final_state = states[:, -1].to(cdt)  # (B, H, N, P): padded steps have dt = 0
        # The last K - 1 pre-conv inputs, zeros before the first token.
        conv_tail = F.pad(xbc_raw[:, :orig_s], (0, 0, k - 1, 0))[:, orig_s:orig_s + k - 1]
        return out, (final_state, conv_tail)


def init_ssd_cache(cfg, batch: int, dtype, device=None) -> dict[str, torch.Tensor]:
    d_inner, h = ssm_dims(cfg)
    return {
        "state": torch.zeros((batch, h, cfg.ssm_state, cfg.ssm_head_dim), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, _conv_dim(cfg)), dtype=dtype, device=device),
    }


def ssd_decode(p: SSD, x_in: torch.Tensor, cache: dict[str, torch.Tensor], cfg):
    """One-token SSD step. x_in (B, 1, d) -> (B, 1, d), cache (updated in
    place and returned).

    State update: h <- exp(dt A) h + B (dt x)^T; y = C . h + D x. On a
    DTensor cache each rank steps its own heads (``_ssd_decode_on_shards``)."""
    if sh.is_dtensor(cache["state"]):
        return _ssd_decode_on_shards(p, x_in, cache, cfg), cache
    cdt = cfg.compute_dtype
    d_inner, h = ssm_dims(cfg)
    z, xbc_raw, dt_raw = _split_proj(p, x_in.to(cdt), cfg)
    y = _ssd_decode_core(z, xbc_raw, dt_raw, cache["state"], cache["conv"], p.conv_w, p.conv_b,
                         p.dt_bias, p.a_log, p.d_skip, p.norm.scale, cfg, slice(0, h),
                         slice(0, _conv_dim(cfg)))
    return y @ p.out_proj.to(cdt), cache


def _ssd_decode_core(z, xbc_raw, dt_raw, state, conv, conv_w, conv_b, dt_bias, a_log, d_skip,
                     norm_scale, cfg, heads: slice, chans: slice, gather=None, group=None):
    """One token on plain tensors, for the heads ``heads`` of H and the
    conv channels ``chans`` that ``state`` (B, H_rank, N, P) and ``conv``
    (B, K - 1, C_rank) hold; the whole cache is heads (0, H) and channels
    (0, C). z (B, 1, d_inner), xbc_raw (B, 1, C) and dt_raw (B, 1, H) are
    the token's whole projection, and the weights are whole. ``gather``
    brings the rank's channels of the convolution's output (B, C_rank) to
    all C; ``group`` is the process group the heads are split over (the
    gated norm's sum of squares is all-reduced over it). Updates ``state``
    and ``conv`` in place and returns the gated norm's output
    (B, 1, H_rank P), before ``out_proj``."""
    cdt = cfg.compute_dtype
    g, n, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    d_inner, h = ssm_dims(cfg)
    pdim, hpg = cfg.ssm_head_dim, h // g

    # The conv over the ring of the last K - 1 raw inputs and this one.
    hist = torch.cat([conv.to(cdt), xbc_raw[..., chans]], dim=1)  # (B, K, C_rank)
    conv_w, conv_b = conv_w[:, chans], conv_b[chans]
    conv_out = sum(hist[:, i] * conv_w[i].to(cdt) for i in range(k))
    xbc = F.silu(conv_out + conv_b.to(cdt))  # (B, C_rank)
    conv.copy_(hist[:, 1:])
    if gather is not None:
        xbc = gather(xbc)
    x, bmat, cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)

    b = x.shape[0]
    dt = F.softplus(dt_raw[:, 0].float() + dt_bias)[:, heads]  # (B, H_rank)
    decay = torch.exp(dt * -torch.exp(a_log[heads]))
    xh = x.reshape(b, h, pdim)[:, heads]
    bmg = bmat.reshape(b, g, n).repeat_interleave(hpg, dim=1)[:, heads]  # (B, H_rank, N)
    cmg = cmat.reshape(b, g, n).repeat_interleave(hpg, dim=1)[:, heads]

    xdt = xh * dt[..., None].to(cdt)
    new_state = (state.to(cdt) * decay[..., None, None].to(cdt)
                 + bmg[..., :, None] * xdt[..., None, :])  # (B, H_rank, N, P)
    y = torch.einsum("bhn,bhnp->bhp", cmg, new_state) + xh * d_skip[heads].to(cdt)[:, None]
    cols = slice(heads.start * pdim, heads.stop * pdim)
    y = scaled_rmsnorm(y.reshape(b, 1, xh.shape[1] * pdim) * F.silu(z[..., cols]),
                       norm_scale[cols], group=group, width=d_inner)
    state.copy_(new_state)
    return y


def _ssd_decode_on_shards(p: SSD, x_in, cache: dict, cfg):
    """``ssd_decode`` against a DTensor cache placed as
    ``sharding.cache_pspecs`` says (the state's heads and the conv ring's
    channels over ``model``, the batch over the data axes): each rank
    steps its own heads' state and its own channels' conv ring in place
    (``_ssd_decode_core``), and neither moves. Only the token's
    activations do: the packed projection (B_rows, 1, packed) is gathered
    whole over ``model``, the rank's channels of the convolution's output
    (B_rows, C) too, and each rank keeps the columns of its heads. The
    gated norm's sum of squares is one all-reduce over ``model``;
    ``out_proj`` on the rank's rows of d_inner (its heads) leaves a
    partial sum over ``model`` that the residual stream reduces. Returns
    (B, 1, d), a DTensor."""
    from torch.distributed.tensor import DTensor, Shard

    cdt = cfg.compute_dtype
    d_inner, h = ssm_dims(cfg)
    state, conv = cache["state"], cache["conv"]
    mesh = state.device_mesh
    rows = sh.ssm_cache_rows(state, conv)
    mi = mesh.mesh_dim_names.index(sh.MODEL_AXIS)
    r = mesh.get_local_rank(sh.MODEL_AXIS)
    heads_split, chans_split = state.placements[mi] == Shard(1), conv.placements[mi] == Shard(2)

    proj = x_in.to(cdt) @ sh.fsdp_whole(p.in_proj).to(cdt)
    z, xbc_raw, dt_raw = torch.split(sh.local_as(proj, mesh, rows), [d_inner, _conv_dim(cfg), h], dim=-1)
    conv_l, state_l = conv.to_local(), state.to_local()
    c_n, h_n = conv_l.shape[-1], state_l.shape[1]
    chans = slice(r * c_n, (r + 1) * c_n) if chans_split else slice(0, c_n)
    heads = slice(r * h_n, (r + 1) * h_n) if heads_split else slice(0, h)

    def gather(xbc):
        return sh.local_as(DTensor.from_local(xbc, mesh, sh.split_over(rows, mesh, 1), run_check=False),
                           mesh, rows)

    y = _ssd_decode_core(z, xbc_raw, dt_raw, state_l, conv_l,
                         *(sh.local_as(t, mesh) for t in (p.conv_w, p.conv_b, p.dt_bias, p.a_log,
                                                          p.d_skip, p.norm.scale)),
                         cfg, heads, chans, gather if chans_split else None,
                         mesh.get_group(sh.MODEL_AXIS) if heads_split else None)
    y = DTensor.from_local(y, mesh, sh.split_over(rows, mesh, 2) if heads_split else rows,
                           run_check=False)
    return y @ sh.fsdp_whole(p.out_proj).to(cdt)
