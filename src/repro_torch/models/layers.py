"""Shared neural building blocks of the port (plain PyTorch functions).

The reference's ``repro.models.layers``, function for function:

  * params are nested dicts of fp32 tensors (the master copy); ``apply``
    functions cast weights to the input's compute dtype (bf16) at the
    edges and keep norms and softmax in fp32, as the reference does;
  * attention (GQA, and DeepSeek-V2's multi-head latent attention with
    its compressed cache) runs a full sequence (dense, or kv-chunked above
    ``BLOCKWISE_THRESHOLD``) or a short decode against a ring-buffer
    cache, which it updates IN PLACE (the reference returns a new one);
  * the MoE layer keeps the reference's grouped capacity dispatch (groups
    of ``MOE_GROUP`` tokens, top-k routing, an expert's slots filled in
    (token, choice) order, the overflow dropped) in index form: tokens are
    gathered into their (expert, slot) rows and gathered back, where the
    reference multiplies by one-hot dispatch tensors; one term is picked
    either way, so the two agree exactly;
  * weights are stored (d_in, d_out), as in the reference, so its trees
    carry across key for key (``repro_torch.convert``).

The sentinels are the reference's: the mask bias is -1e30 (not -inf),
empty cache slots and the blockwise key padding sit at position 2**30,
and the online softmax starts its running max at -1e30.  Top-k routing
breaks ties to the lower expert index, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .config import MLAConfig, ModelConfig, MoEConfig
from .hooks import attend, constrain, merge_heads, ring_write, split_heads

COMPUTE_DTYPE = torch.bfloat16
MASK = -1e30  # additive bias of a masked (query, key) pair
EMPTY_POS = 2**30  # position of an empty cache slot or a padded key: "the future"


def _init(generator, shape, device, scale=0.02):
    """``scale * truncated_normal(-2, 2)`` in fp32, drawn with ``generator``
    on its own device and placed on ``device``.  Without a generator (shape
    trees on the meta device) an empty tensor.  The values differ from
    ``jax.random``'s; the tests carry the reference's values across."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(device)


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)  # jnp.var: the population variance
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def norm_init(cfg: ModelConfig, d: int, *, lead: tuple = (), device=None):
    """Norm parameters (scale ones, bias zeros), ``lead`` dims in front."""
    if cfg.norm == "layernorm":
        return {
            "scale": torch.ones((*lead, d), device=device),
            "bias": torch.zeros((*lead, d), device=device),
        }
    return {"scale": torch.ones((*lead, d), device=device)}


def norm_apply(cfg: ModelConfig, p, x):
    x = constrain(x)  # on a mesh: a row-parallel product's pending sum settled first
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  The head
    splits into halves (not even/odd pairs), as in the reference."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, x.device)  # (dim/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, dim/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu / geglu / gelu)
# ---------------------------------------------------------------------------


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default is the tanh form


def mlp_init(generator, cfg: ModelConfig, d_model: int, d_ff: int, *, lead: tuple = (),
             device=None):
    def w(shape):
        return _init(generator, (*lead, *shape), device)

    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": w((d_model, d_ff)),
            "w_up": w((d_model, d_ff)),
            "w_down": w((d_ff, d_model)),
        }
    return {"w_up": w((d_model, d_ff)), "w_down": w((d_ff, d_model))}


def mlp_apply(cfg: ModelConfig, p, x):
    dt = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    else:
        h = _gelu(x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Dense attention (GQA; full / sliding-window / local), prefill + decode
# ---------------------------------------------------------------------------

BLOCKWISE_THRESHOLD = 8_192  # above this, use the kv-chunked online-softmax path
KV_CHUNK = 1_024


def set_blockwise_threshold(n: int) -> None:
    "Perf knob: sequence length above which attention goes kv-chunked."
    global BLOCKWISE_THRESHOLD
    BLOCKWISE_THRESHOLD = n


def set_compute_dtype(dtype: torch.dtype) -> None:
    """Check knob: the dtype of activations, of the weights' casts and of a
    new KV cache (bf16, as the reference).  An fp32 run of the same weights
    and inputs is the truth that bf16 runs on different hardware are held
    to (``chip_smoke.py`` phase 13e)."""
    global COMPUTE_DTYPE
    COMPUTE_DTYPE = dtype


def attention_init(generator, cfg: ModelConfig, *, lead: tuple = (), device=None):
    d, hd = cfg.d_model, cfg.head_dim_

    def w(shape):
        return _init(generator, (*lead, *shape), device)

    return {
        "w_q": w((d, cfg.n_heads * hd)),
        "w_k": w((d, cfg.n_kv_heads * hd)),
        "w_v": w((d, cfg.n_kv_heads * hd)),
        "w_o": w((cfg.n_heads * hd, d)),
    }


def _heads(t, head_dim: int, n: Optional[int] = None):
    """(..., H * head_dim) -> (..., H, head_dim); ``n``, if given, is H."""
    n = t.shape[-1] // head_dim if n is None else n
    return split_heads(t, -1, n).reshape(*t.shape[:-1], n, head_dim)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """(..., Sq, Sk) additive mask in fp32: 0 where the query may read the
    key, -1e30 elsewhere."""
    ok = None  # every pair; the tests below narrow it
    if causal:
        ok = q_pos[..., :, None] >= k_pos[..., None, :]
    if window > 0:
        near = q_pos[..., :, None] - k_pos[..., None, :] < window
        ok = near if ok is None else ok & near
    if ok is None:
        ok = torch.ones_like(q_pos[..., :, None] == k_pos[..., None, :])
    return torch.where(ok, 0.0, MASK).to(torch.float32)


def _scaled(scores, scale: float, bias):
    """``scores * scale + bias``, in place unless autograd records: then
    ``scores`` may be a tensor it holds (in fp32 compute the product itself,
    which a selective checkpoint saves)."""
    if scores.requires_grad:
        return scores * scale + bias
    return scores.mul_(scale).add_(bias)


def _sdpa(q, k, v, bias):
    """q:(B,Sq,H,D) k,v:(B,Sk,Hkv,D) bias:(B,Sq,Sk) -> (B,Sq,H,D).

    Query head ``j * group + i`` reads kv head ``j`` (the reference's
    ``reshape(b, s, hkv, group, d)``).  One kv head at a time: its keys and
    values are strided views of ``k`` / ``v``, so a decode cache is read
    where it lies (one product over batch and heads would copy it first).
    The products round to q's dtype before the fp32 scale, bias and
    softmax, as the reference's bf16 einsums do; the probabilities go back
    to q's dtype for the value product."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    # (b, hkv, group * sq, d): the rows of one kv head's query group
    qg = split_heads(q, 2, hkv).reshape(b, sq, hkv, group, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, group * sq, d)
    outs = []
    for j in range(hkv):
        scores = torch.bmm(qg[:, j], k[:, :, j].transpose(1, 2)).float()
        sk = scores.shape[-1]
        scores = _scaled(scores.view(b, group, sq, sk), scale, bias[:, None])
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.bmm(probs.view(b, group * sq, sk), v[:, :, j]))
    out = torch.stack(outs, dim=1).view(b, hkv, group, sq, d)
    return merge_heads(out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d), 2, hkv)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, *, causal: bool, window: int):
    """kv-chunked online-softmax attention: O(Sq * chunk) live memory.

    Walks the kv chunks keeping (m, l, acc) -- running max, normalizer and
    weighted accumulator per query -- the flash-attention recurrence in
    plain torch, as the reference's ``lax.scan``.  Keys are padded to whole
    chunks at position 2**30, which the causal mask excludes."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    sk = k.shape[1]
    chunk = KV_CHUNK
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=EMPTY_POS)
    qg = split_heads(q, 2, hkv).reshape(b, sq, hkv, group, d)
    scale = 1.0 / math.sqrt(d)
    # the running state, shaped (and placed, on a mesh) as the queries
    rows = qg.permute(0, 2, 3, 1, 4)  # (b, hkv, group, sq, d)
    m = torch.full_like(rows[..., 0], MASK, dtype=torch.float32,
                        memory_format=torch.contiguous_format)
    norm = torch.zeros_like(m)
    acc = torch.zeros_like(rows, dtype=torch.float32, memory_format=torch.contiguous_format)
    for c in range(n_chunks):
        kb, vb = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        pb = k_pos[:, c * chunk:(c + 1) * chunk]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb).float()
        bias = _mask_bias(q_pos, pb, causal=causal, window=window)[:, None, None]
        scores = _scaled(scores, scale, bias)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        if scores.requires_grad:  # amax saved the scores: leave them as they are
            p = torch.exp(scores - m_new[..., None])
        else:
            p = scores.sub_(m_new[..., None]).exp_()
        norm = norm * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), vb).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(norm, min=1e-30)[..., None]
    return merge_heads(out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d), 2, hkv).to(q.dtype)


def attention_apply(
    cfg: ModelConfig,
    p,
    x,
    *,
    positions,
    causal: bool = True,
    window: int = 0,
    cache: Optional[dict] = None,
    kv_override: Optional[tuple] = None,
    n_kv_heads: Optional[int] = None,
):
    """GQA attention -> (out, cache).

    ``cache`` (decode): one layer's {"k", "v", "pos", "index"} ring buffer.
    The step writes one slot per position for every row, ``(index +
    arange(s)) % size``, records ``positions`` there, advances ``index``
    -- all IN PLACE on the device, no host sync -- and returns the same
    dict: the caller's cache is consumed.  A cache shorter than the decode
    wraps and overwrites its oldest entries.  ``kv_override``: (k, v,
    k_pos) for cross-attention.  Without a cache the second result is
    None, as in the reference."""
    dt = x.dtype
    b, s, _ = x.shape
    hd = cfg.head_dim_
    n_kv = n_kv_heads if n_kv_heads is not None else cfg.n_kv_heads
    q = _heads(x @ p["w_q"].to(dt), hd)
    if kv_override is None:
        k = _heads(x @ p["w_k"].to(dt), hd, n_kv)
        v = _heads(x @ p["w_v"].to(dt), hd, n_kv)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v, k_positions = kv_override
    new_cache = None
    if cache is not None and kv_override is None:
        idx = cache["index"]
        size = cache["k"].shape[1]
        slot = (idx.long() + torch.arange(s, device=x.device)) % size
        ring_write(cache["k"], 1, slot, k.to(cache["k"].dtype))
        ring_write(cache["v"], 1, slot, v.to(cache["v"].dtype))
        ring_write(cache["pos"], 1, slot, positions.to(cache["pos"].dtype))
        idx.add_(s)
        new_cache = cache
        bias = _mask_bias(positions, cache["pos"], causal=True, window=window)
        out = attend(_sdpa, q, cache["k"].to(dt), cache["v"].to(dt), bias)
    elif kv_override is not None:
        bias = _mask_bias(positions, k_positions, causal=False, window=0)
        out = attend(_sdpa, q, k, v, bias)
    elif s > BLOCKWISE_THRESHOLD:
        out = _sdpa_blockwise(q, k, v, positions, positions, causal=causal, window=window)
    else:
        bias = _mask_bias(positions, positions, causal=causal, window=window)
        out = attend(_sdpa, q, k, v, bias)
    return merge_heads(out.reshape(b, s, -1), -1, out.shape[2]) @ p["w_o"].to(dt), new_cache


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int, window: int = 0, *,
                         lead: tuple = (), device=None):
    """Ring-buffer cache, ``lead`` dims in front (the stacked layer axis);
    windowed attention only keeps ``window`` slots."""
    size = min(max_len, window) if window > 0 else max_len
    hd = cfg.head_dim_
    kv = (*lead, batch, size, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(kv, dtype=COMPUTE_DTYPE, device=device),
        "v": torch.zeros(kv, dtype=COMPUTE_DTYPE, device=device),
        # empty slots sit in the "future" so the causal mask excludes them
        "pos": torch.full((*lead, batch, size), EMPTY_POS, dtype=torch.int32, device=device),
        "index": torch.zeros(lead, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MoE (grouped capacity dispatch, in index form)
# ---------------------------------------------------------------------------

MOE_GROUP = 256  # tokens per dispatch group

_moe_observer: Optional[Callable] = None


def set_moe_observer(fn: Optional[Callable]) -> None:
    """Check knob: every ``moe_apply`` call passes ``fn(logits, experts,
    keep)`` its routing, detached, on its device: the fp32 router logits
    (G, Sg, E), the chosen experts (G, Sg, K) in choice order and whether
    each assignment (G, Sg * K), in (token, choice) order, was kept under
    capacity.  None, the default, calls nothing."""
    global _moe_observer
    _moe_observer = fn


def moe_init(generator, cfg: ModelConfig, moe: MoEConfig, *, lead: tuple = (), device=None):
    """The reference's keys: router (D, E) at scale 0.01, w_gate / w_up
    (E, D, F) and w_down (E, F, D); no w_up under ``act == "gelu"``;
    ``shared``, one MLP of ``n_shared x d_ff_shared``, when there are
    shared experts.  ``lead`` dims in front (the stacked layer axis)."""
    d, e, f = cfg.d_model, moe.n_experts, moe.d_ff_expert

    def w(shape, scale=0.02):
        return _init(generator, (*lead, *shape), device, scale)

    p = {"router": w((d, e), 0.01), "w_gate": w((e, d, f))}
    if cfg.act in ("swiglu", "geglu"):
        p["w_up"] = w((e, d, f))
    p["w_down"] = w((e, f, d))
    if moe.n_shared:
        p["shared"] = mlp_init(generator, cfg, d, moe.d_ff_shared * moe.n_shared, lead=lead,
                               device=device)
    return p


def _top_k(probs, k: int):
    """The ``k`` largest entries of the last axis and their indices, ties
    to the lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none, and a flipped tie changes which assignment capacity drops)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _slots(experts, n_experts: int):
    """experts (G, N): the expert of each assignment of a group, in
    (token, choice) order -> (pos, counts): ``pos[g, j]`` the number of
    earlier assignments of group g to the same expert (the reference's
    cumsum of the one-hot, minus one), ``counts`` (G, E) the assignments
    per expert."""
    g, n = experts.shape
    counts = torch.zeros((g, n_experts), dtype=torch.int64, device=experts.device).scatter_add(
        1, experts, torch.ones_like(experts))
    order = torch.argsort(experts, dim=1, stable=True)  # by expert, (token, choice) order kept
    first = (torch.cumsum(counts, dim=1) - counts).gather(1, experts.gather(1, order))
    rank = torch.arange(n, device=experts.device) - first
    return torch.zeros_like(experts).scatter(1, order, rank), counts


def moe_apply(cfg: ModelConfig, p, x, moe: MoEConfig, own: Optional[slice] = None):
    """Grouped capacity dispatch -> (y, aux_loss), the reference's MoE.

    The ``b * s`` tokens split into ``max(n // MOE_GROUP, 1)`` groups (a
    count that does not divide raises ``ValueError``, where the reference's
    reshape raises); each token's router probabilities (the compute-dtype
    product, then fp32 softmax) pick its top_k experts, whose gates are
    renormalised by their sum.  An expert takes ``cap = max(sg * k / E *
    capacity_factor, 4)`` assignments per group, earlier tokens first and a
    token's first choice before its second; the rest are dropped, and the
    kept gates are not renormalised.  Each expert runs on its (G x cap)
    slot rows as one batched product; a token's output is the sum of its
    kept experts' rows, each times its gate rounded to the compute dtype,
    summed in fp32 and rounded once.  ``aux`` is the Switch load-balancing
    loss over the pre-capacity routing.

    ``own`` (expert parallelism on a mesh): the experts whose weights
    ``p`` holds; only their slot rows are computed, the others' rows read
    zeros, so ``y`` is this rank's part of a sum over ranks."""
    dt = x.dtype
    b, s, d = x.shape
    n_tok = b * s
    g = max(n_tok // MOE_GROUP, 1)
    if n_tok % g:
        raise ValueError(f"moe_apply: {n_tok} tokens do not split into {g} equal groups")
    sg, e, k = n_tok // g, moe.n_experts, moe.top_k
    xt = x.reshape(g, sg, d)
    logits = (xt @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, k)  # (G, Sg, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(sg * k / e * moe.capacity_factor, 4))
    experts = idx.reshape(g, sg * k)
    pos, counts = _slots(experts, e)
    keep = pos < cap
    # the slot table's rows run (expert, group, slot); a dropped assignment
    # points one past its end, at a row of zeros
    n_slots = e * g * cap
    grp = torch.arange(g, device=x.device)[:, None]
    row = torch.where(keep, (experts * g + grp) * cap + pos, n_slots)
    tok = grp * sg + torch.arange(sg * k, device=x.device) // k
    src = torch.full((n_slots + 1,), n_tok, dtype=torch.int64, device=x.device).index_copy(
        0, row.reshape(-1), tok.reshape(-1))[:n_slots]  # an empty slot reads the zero row
    xe = F.pad(x.reshape(n_tok, d), (0, 0, 0, 1))[src].view(e, g * cap, d)
    n_rows = n_slots
    if own is not None:
        xe = xe[own]
        n_rows = xe.shape[0] * g * cap
        lo = own.start * g * cap
        row = torch.where((row >= lo) & (row < lo + n_rows), row - lo, n_rows)
    act = F.silu if cfg.act == "swiglu" else _gelu
    hid = act(torch.bmm(xe, p["w_gate"].to(dt)))
    if "w_up" in p:
        hid = hid * torch.bmm(xe, p["w_up"].to(dt))
    ye = F.pad(torch.bmm(hid, p["w_down"].to(dt)).view(n_rows, d), (0, 0, 0, 1))
    w = gate.to(dt).float().view(n_tok, k)  # the reference rounds the gate before the product
    rows = row.view(n_tok, k)
    y = w[:, :1] * ye[rows[:, 0]].float()
    for j in range(1, k):
        y = y + w[:, j:j + 1] * ye[rows[:, j]].float()
    y = y.to(dt).view(g, sg, d)
    density = counts.float() / (sg * k)  # the one-hot's mean over tokens and choices
    aux = (density * probs.mean(dim=1)).sum(-1).mean() * (e**2 / k)
    if moe.n_shared:
        y = y + mlp_apply(cfg, p["shared"], xt)
    if _moe_observer is not None:
        _moe_observer(logits.detach(), idx, keep)
    return y.reshape(b, s, d), aux.float()


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention) with a compressed KV cache
# ---------------------------------------------------------------------------

SCORE_BYTES = 1 << 30  # fp32 scores ``_sdpa_mixed`` holds at once (one head group's)


def mla_init(generator, cfg: ModelConfig, mla: MLAConfig, *, lead: tuple = (), device=None):
    d, h = cfg.d_model, cfg.n_heads
    qk = mla.qk_nope_dim + mla.qk_rope_dim

    def w(shape):
        return _init(generator, (*lead, *shape), device)

    return {
        "w_dq": w((d, mla.q_lora_rank)),
        "q_norm": torch.ones((*lead, mla.q_lora_rank), device=device),
        "w_uq": w((mla.q_lora_rank, h * qk)),
        "w_dkv": w((d, mla.kv_lora_rank)),
        "kv_norm": torch.ones((*lead, mla.kv_lora_rank), device=device),
        "w_kr": w((d, mla.qk_rope_dim)),
        "w_uk": w((mla.kv_lora_rank, h * mla.qk_nope_dim)),
        "w_uv": w((mla.kv_lora_rank, h * mla.v_head_dim)),
        "w_o": w((h * mla.v_head_dim, d)),
    }


def mla_apply(cfg: ModelConfig, p, x, *, positions, cache: Optional[dict] = None):
    """Multi-head latent attention -> (out, cache), the reference's
    non-absorbed form: queries through the q low-rank path, keys and
    values re-expanded from the normed latent ``ckv`` every call, RoPE on
    the ``qk_rope`` split of the queries and on one key head shared by all
    heads, keys ``concat(k_nope, krope)`` at head dim ``qk_nope +
    qk_rope``.  Above ``BLOCKWISE_THRESHOLD`` without a cache the kv-chunked
    path runs on values padded to the key dim (``v_pad``), sliced back.

    ``cache`` (decode): one layer's compressed ring {"ckv", "krope", "pos",
    "index"}, written IN PLACE as ``attention_apply``'s (the caller's
    cache is consumed); without one the second result is None."""
    mla = cfg.mla
    dt = x.dtype
    b, s, _ = x.shape
    h = cfg.n_heads
    cq = rmsnorm(x @ p["w_dq"].to(dt), p["q_norm"])
    q = _heads(cq @ p["w_uq"].to(dt), mla.qk_nope_dim + mla.qk_rope_dim)
    q_nope, q_rope = q.split([mla.qk_nope_dim, mla.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rmsnorm(x @ p["w_dkv"].to(dt), p["kv_norm"])  # (b, s, kv_lora)
    krope = apply_rope(_heads(x @ p["w_kr"].to(dt), mla.qk_rope_dim), positions,
                       cfg.rope_theta)
    new_cache = None
    if cache is not None:
        idx = cache["index"]
        size = cache["ckv"].shape[1]
        slot = (idx.long() + torch.arange(s, device=x.device)) % size
        ring_write(cache["ckv"], 1, slot, ckv.to(cache["ckv"].dtype))
        ring_write(cache["krope"], 1, slot, krope[:, :, 0].to(cache["krope"].dtype))
        ring_write(cache["pos"], 1, slot, positions.to(torch.int32))
        idx.add_(s)
        new_cache = cache
        # every head reads the whole latent (its width may be sharded in the cache)
        ckv_all = split_heads(cache["ckv"].to(dt), -1, 1)
        krope_all, k_pos = cache["krope"].to(dt), cache["pos"]
    else:
        ckv_all, krope_all, k_pos = ckv, krope[:, :, 0], positions
    k_nope = _heads(ckv_all @ p["w_uk"].to(dt), mla.qk_nope_dim)
    v = _heads(ckv_all @ p["w_uv"].to(dt), mla.v_head_dim)
    k = torch.cat([k_nope, krope_all[:, :, None].expand(*k_nope.shape[:3], mla.qk_rope_dim)],
                  dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    if s > BLOCKWISE_THRESHOLD and cache is None:
        out = _sdpa_blockwise(q_full, k, v_pad(v, k), positions, k_pos, causal=True, window=0)
        out = out[..., :mla.v_head_dim]
    else:
        out = attend(_sdpa_mixed, q_full, k, v, _mask_bias(positions, k_pos, causal=True, window=0))
    return merge_heads(out.reshape(b, s, -1), -1, out.shape[2]) @ p["w_o"].to(dt), new_cache


def v_pad(v, k):
    """Pad v's head dim up to k's so the blockwise path (equal q / k / v
    dims) can be reused; the caller slices back."""
    pad = k.shape[-1] - v.shape[-1]
    if pad <= 0:
        return v
    return F.pad(v, (0, pad))


def _sdpa_mixed(q, k, v, bias):
    """MHA attention where v's head dim differs from q and k's: q (B, Sq,
    H, Dqk), k (B, Sk, H, Dqk), v (B, Sk, H, Dv), bias (B, Sq, Sk) -> (B,
    Sq, H, Dv).  Heads go in groups whose fp32 scores stay under
    ``SCORE_BYTES`` (deepseek-v2's 128 heads at 1 x 4,096 positions would
    hold 8 GiB at once); each head's arithmetic is the reference's: the
    product rounded to q's dtype, then fp32 scale, bias and softmax, the
    probabilities back in q's dtype for the value product."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    group = max(1, min(h, SCORE_BYTES // (4 * b * sq * sk)))
    outs = []
    for h0 in range(0, h, group):
        hs = slice(h0, h0 + group)
        scores = torch.matmul(q[:, :, hs].transpose(1, 2), k[:, :, hs].permute(0, 2, 3, 1)).float()
        scores = _scaled(scores, scale, bias[:, None])
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.matmul(probs, v[:, :, hs].transpose(1, 2)))
    return torch.cat(outs, dim=1).transpose(1, 2)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, lead: tuple = (),
                   device=None):
    """The compressed ring cache, ``lead`` dims in front: the normed latent
    ``ckv`` and the shared RoPE key ``krope`` per position (kv_lora +
    qk_rope values, not 2 x H x head_dim), 2**30 where empty."""
    mla = cfg.mla
    return {
        "ckv": torch.zeros((*lead, batch, max_len, mla.kv_lora_rank), dtype=COMPUTE_DTYPE,
                           device=device),
        "krope": torch.zeros((*lead, batch, max_len, mla.qk_rope_dim), dtype=COMPUTE_DTYPE,
                             device=device),
        # empty slots sit in the "future" so the causal mask excludes them
        "pos": torch.full((*lead, batch, max_len), EMPTY_POS, dtype=torch.int32, device=device),
        "index": torch.zeros(lead, dtype=torch.int32, device=device),
    }
