"""Recurrent sequence mixers of the port: RG-LRU (RecurrentGemma / Griffin)
and RWKV6 (Finch), the reference's ``repro.models.recurrent`` function for
function, in plain PyTorch.

Both are linear recurrences, so a full sequence runs without a token loop:

  * RG-LRU: the elementwise ``h_t = a_t * h_{t-1} + b_t`` runs as a
    log-depth doubling scan (``_linear_scan``: ceil(log2 S) steps of the
    reference's associative combine), in fp32, differentiable;
  * RWKV6: the matrix state ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` runs
    as chunked linear attention over chunks of ``RWKV_CHUNK`` tokens, the
    sequence padded to whole chunks with decay 0 (``w = 1``) as in the
    reference; the intra-chunk products of all chunks run at once, and
    only the state carried from chunk to chunk is a loop.  A one-token
    decode step pads to a whole chunk too: the reference's values, at the
    reference's cost.

Decode carries constant-size state: ``{"h": (B, W), "conv": (B, 3, W)}``
for RG-LRU and ``{"S": (B, H, dk, dv), "prev": (B, 1, D)}`` (time mix) /
``{"prev": (B, 1, D)}`` (channel mix) for RWKV6, all fp32.  Given a
state, an ``apply`` function writes the new one INTO it (``copy_``) and
returns the same dict, as the port's ring-buffer caches are written: the
caller's state is consumed (the reference returns a new one).  Without a
state it returns a new one, as the reference does.

Params are nested dicts of fp32 tensors with the reference's keys;
``init`` functions take a ``torch.Generator`` and ``lead`` dims (the
stacked layer axis) as ``layers.py``'s do, and draw the reference's
distribution (not its values).  The deterministic leaves (``a_param``,
``conv_b``, the RWKV mixes, decay base and norm scale) are the
reference's values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from . import hooks
from .hooks import merge_heads, split_heads
from .layers import _gelu, _init, rmsnorm

RWKV_CHUNK = 128
LRU_C = 8.0  # Griffin's fixed recurrence-sharpness constant
CONV_WIDTH = 4
RWKV_LORA = 32


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block: in-proj -> conv1d -> RG-LRU -> gate)
# ---------------------------------------------------------------------------


def _a_param(w: int, device) -> torch.Tensor:
    """``-log(expm1(-log(linspace(0.9, 0.999, w))))`` in fp32, so that
    ``sigmoid(a_param)`` spans [0.9, 0.999].  The linspace takes
    ``jnp.linspace``'s own form (``start * (1 - i / n) + stop * i / n``,
    the stop exact); XLA's vectorised division still rounds up to 2 ulp of
    it differently, which ``-log`` near 0.999 magnifies to ~1e-5
    relative."""
    if w == 1:
        lin = torch.full((1,), 0.9, dtype=torch.float32, device=device)
    else:
        step = torch.arange(w - 1, dtype=torch.float32, device=device) / (w - 1)
        start = torch.tensor(0.9, dtype=torch.float32, device=device)
        stop = torch.tensor(0.999, dtype=torch.float32, device=device)
        lin = torch.cat([start * (1 - step) + stop * step, stop[None]])
    return -torch.log(torch.expm1(-torch.log(lin)))


def rglru_init(generator, cfg: ModelConfig, *, lead: tuple = (), device=None):
    d = cfg.d_model
    w = cfg.lru_width or d

    def mat(shape):
        return _init(generator, (*lead, *shape), device)

    return {
        "w_x": mat((d, w)),
        "w_gate": mat((d, w)),
        "conv_w": mat((CONV_WIDTH, w)),
        "conv_b": torch.zeros((*lead, w), dtype=torch.float32, device=device),
        "w_rg": mat((w, w)),  # recurrence gate
        "w_ig": mat((w, w)),  # input gate
        "a_param": _a_param(w, device).expand(*lead, w).clone(),
        "w_out": mat((w, d)),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d of width ``CONV_WIDTH``.  state: (B, W-1, C)
    tail of the previous tokens (decode).  The products are summed in the
    compute dtype in the reference's order (Python's ``sum`` from 0, then
    ``+ b``) -> (y, new tail (B, W-1, C) in x's dtype)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros_like(x[:, :1]).expand(-1, width - 1, -1)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(width)) + b.to(x.dtype)
    return y, xp[:, -(width - 1):]


def _linear_scan(a, b, h0=None):
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 (h_{-1} = ``h0`` or 0) ->
    every h_t.  Hillis-Steele doubling with the reference's associative
    combine ``(a_l, b_l), (a_r, b_r) -> (a_l a_r, b_r + a_r b_l)``:
    ceil(log2 S) steps of whole-tensor ops, out of place (autograd goes
    through it).  A carried ``h0`` enters as ``a_0 h0 + b_0``, which for
    one token is the reference's sequential decode step."""
    if h0 is not None:
        b = torch.cat([a[:, :1] * h0[:, None] + b[:, :1], b[:, 1:]], dim=1)
    s, k = a.shape[1], 1
    while k < s:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        if 2 * k < s:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_apply(cfg: ModelConfig, p, x, *, state=None):
    """x: (B, S, D) -> (out (B, S, D), state).  ``state`` (decode): {"h":
    (B, W), "conv": (B, 3, W)} fp32, written in place and returned;
    without one a new state.  The gates and the recurrence run in fp32:
    ``log a = -LRU_C * r * softplus(a_param)``, ``b = sqrt(max(1 - a^2,
    1e-12)) * i * x``."""
    dt = x.dtype
    xb = x @ p["w_x"].to(dt)
    gate = _gelu(x @ p["w_gate"].to(dt))  # the tanh form, jax.nn.gelu's default
    xc, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"])
    r = torch.sigmoid((xc @ p["w_rg"].to(dt)).float())
    i = torch.sigmoid((xc @ p["w_ig"].to(dt)).float())
    log_a = -LRU_C * r * F.softplus(p["a_param"])  # (B, S, W) fp32, <= 0
    a = torch.exp(log_a)
    gated_x = i * xc.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated_x
    h = _linear_scan(a, b, None if state is None else state["h"].float())
    out = (h.to(dt) * gate) @ p["w_out"].to(dt)
    if state is None:
        return out, {"h": h[:, -1].float(), "conv": new_conv.float()}
    state["h"].copy_(h[:, -1])
    state["conv"].copy_(new_conv)
    return out, state


def rglru_state_init(cfg: ModelConfig, batch: int, *, lead: tuple = (), device=None):
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, CONV_WIDTH - 1, w), dtype=torch.float32,
                            device=device),
    }


# ---------------------------------------------------------------------------
# RWKV6 (Finch) time-mix + channel-mix
# ---------------------------------------------------------------------------


def rwkv6_timemix_init(generator, cfg: ModelConfig, *, lead: tuple = (), device=None):
    d = cfg.d_model

    def mat(shape, scale=0.02):
        return _init(generator, (*lead, *shape), device, scale)

    def const(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32, device=device)

    return {
        "mix_base": const((5, d), 0.5),  # r, k, v, w, g shift mixes
        "mix_lora_a": mat((d, RWKV_LORA * 5)),
        "mix_lora_b": mat((5, RWKV_LORA, d)),
        "w_r": mat((d, d)),
        "w_k": mat((d, d)),
        "w_v": mat((d, d)),
        "w_g": mat((d, d)),
        "w_o": mat((d, d)),
        "decay_base": const((d,), -6.0),
        "decay_lora_a": mat((d, 64)),
        "decay_lora_b": mat((64, d)),
        "bonus_u": mat((d,), scale=0.5),
        "ln_scale": const((d,), 1.0),
    }


def _token_shift(x, prev):
    """prev: (B, 1, D) last token of the previous segment (or zeros)."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, logw, u, head_dim: int, state=None):
    """Chunked WKV: r, k, v (B, S, D); logw (B, S, D) per-channel log decay
    (< 0); u (D,) bonus; state (B, H, dk, dv) carried -> (out (B, S, D)
    fp32, new state (B, H, dk, dv) fp32).

    The reference's chunk step, in fp32: within a chunk, with ``csum`` the
    inclusive cumulative log decay, token i reads the state decayed by
    ``exp(csum_i - w_i)``, every earlier token j of the chunk through
    ``<r_i exp(csum_i - w_i), k_j exp(min(-csum_j, 30))>`` (the strictly
    lower triangle; the clip is the reference's), and itself through the
    bonus ``(r_i . (u * k_i)) v_i``; the state leaves the chunk as
    ``diag(exp(csum_C)) S + sum_j exp(csum_C - csum_j) k_j v_j^T``.  Those
    products do not depend on the state, so they run for all chunks at
    once; the state then walks the chunks in a loop and the inter-chunk
    term is one product over every chunk's entry state."""
    b, s, d = r.shape
    h = d // head_dim
    c = RWKV_CHUNK
    n = -(-s // c)
    pad = n * c - s
    if pad:  # pad decay 0 => w = 1; padded k, v are 0 (zeros shaped, and placed, as t's rows)
        r, k, v, logw = (torch.cat([t, torch.zeros_like(t[:, :1]).expand(-1, pad, -1)], dim=1)
                         for t in (r, k, v, logw))

    def hsplit(t):  # (B, n * C, D) -> (n, B, H, C, hd) fp32
        return split_heads(t, -1, h).reshape(b, n, c, h, head_dim).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, wc = hsplit(r), hsplit(k), hsplit(v), hsplit(logw)
    uu = u.reshape(h, head_dim).float()
    csum = torch.cumsum(wc, dim=3)  # inclusive cumulative log decay
    r_dec = rc * torch.exp(csum - wc)  # decay through token i - 1: <= 0, bounded
    kj = kc * torch.exp(torch.clamp(-csum, max=30.0))
    scores = torch.einsum("nbhck,nbhjk->nbhcj", r_dec, kj)
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32, device=r.device), diagonal=-1)
    intra = torch.einsum("nbhcj,nbhjv->nbhcv", scores * tri, vc)
    bonus = torch.einsum("nbhck,nbhck->nbhc", rc, uu[:, None, :] * kc)
    total = csum[..., -1:, :]  # (n, B, H, 1, dk)
    kv = torch.einsum("nbhjk,nbhjv->nbhkv", kc * torch.exp(total - csum), vc)
    decay = torch.exp(total[..., 0, :, None])  # (n, B, H, dk, 1)
    S = torch.zeros_like(kv[0]) if state is None else state.float()
    entry = []
    for i in range(n):
        entry.append(S)
        S = decay[i] * S + kv[i]
    out = torch.einsum("nbhck,nbhkv->nbhcv", r_dec, torch.stack(entry))
    out = out + intra
    out = out + bonus[..., None] * vc
    return merge_heads(out.permute(1, 0, 3, 2, 4).reshape(b, n * c, d), -1, h)[:, :s], S


def rwkv6_timemix_apply(cfg: ModelConfig, p, x, *, state=None):
    """x (B, S, D) -> (out, state).  ``state`` (decode): {"S": (B, H, dk,
    dv), "prev": (B, 1, D)} fp32, written in place and returned; "prev"
    is the last token of ``x`` (the normed block input)."""
    dt = x.dtype
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    # zeros shaped, and placed, as x's rows
    prev = torch.zeros_like(x[:, :1]) if state is None else state["prev"].to(dt)
    xs = _token_shift(x, prev)
    # data-dependent shift mixes (5 lora heads: r, k, v, w, g)
    delta = xs - x
    lora = split_heads(torch.tanh(x @ p["mix_lora_a"].to(dt)), -1, 5).reshape(b, s, 5, RWKV_LORA)
    mixes = p["mix_base"].to(dt)[None, None] + torch.einsum(
        "bslr,lrd->bsld", lora, p["mix_lora_b"].to(dt))
    xr, xk, xv, xw, xg = (x + delta * mixes[:, :, i] for i in range(5))
    r = xr @ p["w_r"].to(dt)
    k = xk @ p["w_k"].to(dt)
    v = xv @ p["w_v"].to(dt)
    g = F.silu(xg @ p["w_g"].to(dt))
    decay_in = torch.tanh(xw @ p["decay_lora_a"].to(dt)) @ p["decay_lora_b"].to(dt)
    logw = -torch.exp(p["decay_base"].float() + decay_in.float())  # (B, S, D) < 0
    wkv, new_S = hooks.wkv(_wkv_chunked, r, k, v, logw, p["bonus_u"], hd,
                           None if state is None else state["S"])
    # per-head groupnorm (fp32, unit scale), then the learned output scale
    wkv = rmsnorm(split_heads(wkv, -1, d // hd).reshape(b, s, d // hd, hd),
                  torch.ones(hd, dtype=torch.float32, device=x.device)).reshape(b, s, d)
    wkv = merge_heads(wkv, -1, d // hd)
    wkv = wkv.to(dt) * p["ln_scale"].to(dt)
    out = (wkv * g) @ p["w_o"].to(dt)
    if state is None:
        return out, {"S": new_S, "prev": x[:, -1:].float()}
    state["S"].copy_(new_S)
    state["prev"].copy_(x[:, -1:])
    return out, state


def rwkv6_channelmix_init(generator, cfg: ModelConfig, *, lead: tuple = (), device=None):
    d = cfg.d_model

    def mat(shape):
        return _init(generator, (*lead, *shape), device)

    return {
        "mix_k": torch.full((*lead, d), 0.5, dtype=torch.float32, device=device),
        "mix_r": torch.full((*lead, d), 0.5, dtype=torch.float32, device=device),
        "w_k": mat((d, cfg.d_ff)),
        "w_v": mat((cfg.d_ff, d)),
        "w_r": mat((d, d)),
    }


def rwkv6_channelmix_apply(cfg: ModelConfig, p, x, *, state=None):
    """x (B, S, D) -> (out, state); ``state`` (decode): {"prev": (B, 1,
    D)} fp32, written in place and returned."""
    dt = x.dtype
    prev = torch.zeros_like(x[:, :1]) if state is None else state["prev"].to(dt)
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * p["mix_k"].to(dt)
    xr = x + (xs - x) * p["mix_r"].to(dt)
    kk = torch.square(torch.relu(xk @ p["w_k"].to(dt)))
    rr = torch.sigmoid(xr @ p["w_r"].to(dt))
    out = rr * (kk @ p["w_v"].to(dt))
    if state is None:
        return out, {"prev": x[:, -1:].float()}
    state["prev"].copy_(x[:, -1:])
    return out, state


def rwkv6_state_init(cfg: ModelConfig, batch: int, *, lead: tuple = (), device=None):
    d, hd = cfg.d_model, cfg.rwkv_head_dim

    def zeros(shape):
        return torch.zeros((*lead, *shape), dtype=torch.float32, device=device)

    return {
        "time": {"S": zeros((batch, d // hd, hd, hd)), "prev": zeros((batch, 1, d))},
        "channel": {"prev": zeros((batch, 1, d))},
    }
