"""The plain reference of the benchmark's models: float32 PyTorch, no kernel,
no cache, no batching tricks; written from the models' equations, not from
the program.

A model is an embedding, ``num_layers`` residual blocks and a normed LM
head. A block (``layer_defs``: ``mixer`` ``attn``, ``ssm`` or ``hybrid``,
an optional ``window``, ``ffn`` ``dense`` or ``none``) is

    x = rmsnorm(h)                     # x / rms(x) * (1 + scale)
    h = h + mixer(x)                   # hybrid: 0.5 (rmsnorm(attn(x)) + rmsnorm(ssm(x)))
    h = h + mlp(rmsnorm(h))            # gated SiLU MLP, when ffn is dense

* attention: GQA with RoPE (half-split rotation, base ``rope_theta``),
  causal, key j valid for query i iff i - window < j <= i; softmax in
  float32; computed a block of queries at a time so that S x S never lives
  whole;
* SSM: Mamba-2's SSD. The input projection packs [z, x, B, C, dt]; a
  depthwise causal convolution of width K and SiLU over [x, B, C];
  dt = softplus(dt + dt_bias), A = -exp(a_log); the scan
  h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T, y_t = C_t h_t + D x_t, in
  the chunked form of the Mamba-2 paper's minimal SSD (``segsum``: the
  decays as sums of the log-decays inside each chunk, no differences of
  cumulative sums); then rmsnorm(y * silu(z)) and the output projection.

``quant`` rounds both operands of every product (projections, attention's
two products, the SSD's four, the head) before it is taken: identity for
the reference, float8 e4m3 with one scale a tensor for the control
(``fp8``); the rounding passes gradients straight through.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.flops import layer_defs, ssm_dims

_BLOCK = 512  # queries a block of attention scores


def no_quant(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in float32; the gradient passes as if x were
    not rounded."""
    xd = x.detach()
    scale = 448.0 / xd.abs().amax().clamp(min=1e-30)
    q = (xd * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - xd)


def no_tf32() -> None:
    """Float32 products in float32 (TF32 off), as the reference needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated at positions 0 .. S - 1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i
    (0 on the diagonal), -inf above it."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)  # [i, j] = a[i]
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~below, 0.0)
    out = torch.cumsum(x, dim=-2)
    on_or_below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(0)
    return out.masked_fill(~on_or_below, float("-inf"))


class Reference:
    """The model of ``config`` on the weights ``params`` ({name: float32
    tensor}, the names of ``portbench.weights.layout``)."""

    def __init__(self, config: dict, params: dict, quant=no_quant):
        self.c = config
        self.p = params
        self.q = quant
        self.eps = config.get("norm_eps", 1e-6)
        self.layers = layer_defs(config)

    # -- products ----------------------------------------------------------------

    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    # -- mixers -------------------------------------------------------------------

    def attention(self, x: torch.Tensor, pre: str, window: int | None) -> torch.Tensor:
        c, p = self.c, self.p
        b, s, _ = x.shape
        h, kvh, hd = c["q_heads"], c["kv_heads"], c["head_dim"]
        q = self.ein("bsd,dhk->bshk", x, p[pre + "attn.wq"])
        k = self.ein("bsd,dhk->bshk", x, p[pre + "attn.wk"])
        v = self.ein("bsd,dhk->bshk", x, p[pre + "attn.wv"])
        if c.get("qk_norm"):
            q = rmsnorm(q, p[pre + "attn.q_norm.scale"], self.eps)
            k = rmsnorm(k, p[pre + "attn.k_norm.scale"], self.eps)
        theta = c.get("rope_theta", 10000.0)
        q, k = rope(q, theta), rope(k, theta)
        k = k.repeat_interleave(h // kvh, dim=2)  # query head i reads KV head i // (H / KV)
        v = v.repeat_interleave(h // kvh, dim=2)
        blocks = []
        for i0 in range(0, s, _BLOCK):
            i1 = min(s, i0 + _BLOCK)
            j0 = 0 if window is None else max(0, i0 - window + 1)
            scores = self.ein("bqhd,bkhd->bhqk", q[:, i0:i1], k[:, j0:i1]) * hd**-0.5
            qi = torch.arange(i0, i1, device=x.device)[:, None]
            kj = torch.arange(j0, i1, device=x.device)[None, :]
            ok = kj <= qi
            if window is not None:
                ok = ok & (kj > qi - window)
            w = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
            blocks.append(self.ein("bhqk,bkhd->bqhd", w, v[:, j0:i1]))
        out = torch.cat(blocks, dim=1)
        return self.ein("bshk,hkd->bsd", out, p[pre + "attn.wo"])

    def ssm(self, x: torch.Tensor, pre: str) -> torch.Tensor:
        c, p = self.c, self.p
        b, s, _ = x.shape
        d_inner, heads, conv = ssm_dims(c)
        g, n, k, pd = c["ssm_groups"], c["ssm_state"], c["ssm_conv"], c["ssm_head_dim"]
        proj = self.mm(x, p[pre + "ssm.in_proj"])
        z, xbc, dt = torch.split(proj, [d_inner, conv, heads], dim=-1)
        w = p[pre + "ssm.conv_w"]
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        xbc = F.silu(sum(pad[:, i:i + s] * w[i] for i in range(k)) + p[pre + "ssm.conv_b"])
        xs, bm, cm = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
        dt = F.softplus(dt + p[pre + "ssm.dt_bias"])  # (B, S, H)
        a = -torch.exp(p[pre + "ssm.a_log"])
        xh = xs.reshape(b, s, heads, pd)
        rep = heads // g
        bh = bm.reshape(b, s, g, n).repeat_interleave(rep, dim=2)
        ch = cm.reshape(b, s, g, n).repeat_interleave(rep, dim=2)
        y = self.scan(xh * dt[..., None], dt * a, bh, ch)
        y = y + xh * p[pre + "ssm.d_skip"][:, None]
        y = rmsnorm(y.reshape(b, s, d_inner) * F.silu(z), p[pre + "ssm.norm.scale"], self.eps)
        return self.mm(y, p[pre + "ssm.out_proj"])

    def scan(self, x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
        """The SSD scan from a zero state: x (B, S, H, P) (dt x), a (B, S, H)
        (dt A), bm, cm (B, S, H, N) -> y (B, S, H, P), chunked by the
        configuration's ``ssm_chunk`` (a sequence that is not a multiple
        is padded with a = 0, x = 0, which change nothing)."""
        q = self.c["ssm_chunk"]
        b, s, h, pd = x.shape
        pad = (-s) % q
        if pad:
            x, bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bm, cm))
            a = F.pad(a, (0, 0, 0, pad))
        nc = (s + pad) // q
        x = x.reshape(b, nc, q, h, pd)
        bm = bm.reshape(b, nc, q, h, -1)
        cm = cm.reshape(b, nc, q, h, -1)
        a = a.reshape(b, nc, q, h).permute(0, 3, 1, 2)  # (B, H, Nc, Q)
        a_cs = torch.cumsum(a, dim=-1)
        # Within a chunk: y_i = sum_{j <= i} (C_i . B_j) exp(a_{j+1} + ... + a_i) x_j.
        cb = self.ein("bclhn,bcshn->bhcls", cm, bm)
        y_diag = self.ein("bhcls,bcshp->bclhp", cb * torch.exp(segsum(a)), x)
        # Each chunk's state from its own inputs, then the states carried across chunks.
        decay = torch.exp(a_cs[..., -1:] - a_cs).permute(0, 2, 3, 1)[..., None]  # (B, Nc, Q, H, 1)
        states = self.ein("bclhn,bclhp->bchpn", bm * decay, x)
        states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
        across = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))  # (B, H, Nc + 1, Nc + 1)
        states = self.ein("bhzc,bchpn->bzhpn", across, states)[:, :-1]  # the state before each chunk
        y_off = self.ein("bclhn,bchpn->bclhp", cm, states)
        y_off = y_off * torch.exp(a_cs).permute(0, 2, 3, 1)[..., None]
        return (y_diag + y_off).reshape(b, nc * q, h, pd)[:, :s]

    def mlp(self, x: torch.Tensor, pre: str) -> torch.Tensor:
        p = self.p
        gate = F.silu(self.mm(x, p[pre + "mlp.w_gate"]))
        return self.mm(gate * self.mm(x, p[pre + "mlp.w_in"]), p[pre + "mlp.w_out"])

    def block(self, i: int, h: torch.Tensor) -> torch.Tensor:
        layer, pre, p = self.layers[i], f"layers.{i}.", self.p
        x = rmsnorm(h, p[pre + "ln1.scale"], self.eps)
        a = self.attention(x, pre, layer.get("window")) if layer["mixer"] in ("attn", "hybrid") else None
        m = self.ssm(x, pre) if layer["mixer"] in ("ssm", "hybrid") else None
        if a is not None and m is not None:
            mix = 0.5 * (rmsnorm(a, p[pre + "norm_attn.scale"], self.eps)
                         + rmsnorm(m, p[pre + "norm_ssm.scale"], self.eps))
        else:
            mix = a if m is None else m
        h = h + mix
        if layer["ffn"] == "dense":
            h = h + self.mlp(rmsnorm(h, p[pre + "ln2.scale"], self.eps), pre)
        return h

    # -- model ---------------------------------------------------------------------

    def hidden(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """tokens (B, S) -> the final norm's output (B, S, d); with
        ``remat`` each block is recomputed in the backward (plain
        ``torch.utils.checkpoint``), so a training step fits."""
        h = self.p["embed"][tokens]
        for i in range(len(self.layers)):
            fn = functools.partial(self.block, i)
            h = checkpoint(fn, h, use_reentrant=False) if remat else fn(h)
        return rmsnorm(h, self.p["final_norm.scale"], self.eps)

    def last_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, V) float32 logits at each prompt's last position."""
        return self.mm(self.hidden(tokens)[:, -1], self.p["lm_head"])

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The mean next-token cross entropy over every position."""
        h = self.hidden(tokens, remat=True)
        logits = self.mm(h, self.p["lm_head"])
        return torch.mean(torch.logsumexp(logits, dim=-1)
                          - logits.gather(-1, targets[..., None]).squeeze(-1))
