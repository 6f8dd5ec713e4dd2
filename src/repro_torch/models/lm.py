"""Model assembly of the port: init, forward, prefill and decode for the
language-model family (the reference's ``repro.models.lm``).

    params       = init_params(cfg, generator)            # fp32 master copy
    hidden, aux  = forward(cfg, params, batch)
    loss, aux    = loss_fn(cfg, params, batch)            # train
    logits       = prefill(cfg, params, batch)            # (B, V) fp32
    cache        = init_cache(cfg, batch, max_len)
    logits, c    = decode_step(cfg, params, cache, batch) # cache consumed

Parameters and caches are nested dicts with the reference's keys and its
stacked leading layer axis, one stack per kind of block (``_stacks``):

  * ``family == "lm"``: ``"dense_blocks"`` holds the layers with a dense
    MLP (all of them without MoE, else the first ``n_dense_layers``),
    ``"blocks"`` the MoE layers after them; each layer attends with GQA
    or, where the config has MLA, with multi-head latent attention and
    its compressed cache;
  * ``"rglru"`` (recurrentgemma): ``"super_blocks"`` holds one
    ``block_pattern`` per entry (``{"l0", "l1", "l2"}``: RG-LRU, RG-LRU,
    local attention over ``cfg.window``), ``"tail_blocks"`` the layers
    left over, each of ``pattern[0]``; a whole super-block is one remat
    unit, as in the reference's scan;
  * ``"rwkv6"``: ``"blocks"`` of time mix and channel mix;
  * ``"encdec"`` (whisper): ``"enc_blocks"`` and ``"enc_final_norm"``
    encode the (stub) audio frames without a causal mask, ``"blocks"``
    decode with self-attention, cross-attention to the encoder output
    (its K / V recomputed from it by every layer at every call) and an
    MLP; both add the fp32 sinusoid to their inputs, and both RoPE their
    self-attention; the cache carries ``"enc_out"``.

A Python loop over views of the stacked tensors takes the place of the
reference's ``lax.scan`` over layers.  ``forward`` takes the layer views
from one ``torch.unbind`` per stacked leaf, so under autograd each leaf's
gradient is assembled once, and while autograd records each layer (or
super-block) runs under the remat policy (``set_remat_policy``:
``torch.utils.checkpoint``).  It returns the MoE layers' summed
load-balancing loss beside the hidden states.  Cross-entropy runs in
chunks of ``CE_CHUNK`` positions, so the (B, S, V) logits are never
built.  ``LanguageModel`` is a thin ``nn.Module`` over the same tree.

Every function runs on the device its tensors are on; ``init_params``
and ``init_cache`` put them on the CUDA card unless given a device.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from .config import ModelConfig
from . import hooks, layers
from .hooks import constrain
from .layers import (
    _init,
    attention_apply,
    attention_cache_init,
    attention_init,
    mla_apply,
    mla_cache_init,
    mla_init,
    mlp_apply,
    mlp_init,
    moe_apply,
    moe_init,
    norm_apply,
    norm_init,
)
from .recurrent import (
    rglru_apply,
    rglru_init,
    rglru_state_init,
    rwkv6_channelmix_apply,
    rwkv6_channelmix_init,
    rwkv6_state_init,
    rwkv6_timemix_apply,
    rwkv6_timemix_init,
)


CE_CHUNK = 256

# The reference's remat policies (``jax.checkpoint`` policies) mapped onto
# torch checkpointing: "nothing" saves no residual of a layer (recompute it
# all in backward), "dots" saves the matmul outputs and recomputes the rest
# (selective activation checkpointing), "everything" is no checkpoint.
_REMAT_POLICIES = ("nothing", "dots", "everything")
_remat_policy_name = "nothing"


def set_remat_policy(name: str) -> None:
    "Perf knob: which residuals the per-layer checkpoint saves."
    if name not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; one of {_REMAT_POLICIES}")
    if name == "dots" and not hasattr(_ckpt, "create_selective_checkpoint_contexts"):
        raise NotImplementedError(
            f"remat policy 'dots' needs torch.utils.checkpoint."
            f"create_selective_checkpoint_contexts, which torch {torch.__version__} lacks")
    global _remat_policy_name
    _remat_policy_name = name


def _save_matmuls(ctx, op, *args, **kwargs):
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn):
    """``fn`` under the current remat policy (call it only while autograd
    records)."""
    if _remat_policy_name == "everything":
        return fn
    kw = {}
    if _remat_policy_name == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False, **kw)


def _stacks(cfg: ModelConfig) -> list:
    """[(stack key, entries, block kind)] in the order the layers run (the
    decoder's, for encdec; ``_encode`` runs the encoder's).  A family's
    empty stacks are left out, as the reference leaves them out, except
    the rglru super-blocks, which the reference always builds."""
    if cfg.family == "lm":
        n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
        stacks = [("dense_blocks", cfg.n_layers - n_moe, "dense"), ("blocks", n_moe, "moe")]
        return [s for s in stacks if s[1]]
    if cfg.family == "rglru":
        n_super, n_tail = divmod(cfg.n_layers, len(cfg.block_pattern))
        tail = [("tail_blocks", n_tail, cfg.block_pattern[0])] if n_tail else []
        return [("super_blocks", n_super, "super")] + tail
    if cfg.family == "rwkv6":
        return [("blocks", cfg.n_layers, "rwkv")]
    if cfg.family == "encdec":
        return [("blocks", cfg.n_layers, "dec")]
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Blocks, layer views
# ---------------------------------------------------------------------------


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views, so in-place writes (the decode
    cache) land in the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unbind_layers(tree: dict, n: int) -> list:
    """The ``n`` layer trees of a stacked tree from one ``torch.unbind`` per
    leaf.  Under autograd each ``v[i]`` would add a gradient the size of the
    whole leaf; the views of one unbind add theirs into one leaf gradient."""
    per_key = {k: _unbind_layers(v, n) if isinstance(v, dict) else torch.unbind(v)
               for k, v in tree.items()}
    return [{k: per_key[k][i] for k in tree} for i in range(n)]


def _records(*trees) -> bool:
    """Whether autograd records what reads these tensors or trees of
    tensors (training)."""
    if not torch.is_grad_enabled():
        return False
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif t.requires_grad:
            return True
    return False


def _lm_block_apply(cfg: ModelConfig, p, x, positions, cache=None):
    """One layer -> (x, aux, cache): aux is the MoE layer's load-balancing
    loss, None for a dense MLP (the reference's zero)."""
    window = cfg.window if cfg.attn_kind == "swa" else 0
    h = norm_apply(cfg, p["norm1"], x)
    if cfg.mla is not None:
        attn_out, new_cache = mla_apply(cfg, p["mla"], h, positions=positions, cache=cache)
    else:
        attn_out, new_cache = attention_apply(
            cfg, p["attn"], h, positions=positions, causal=True, window=window, cache=cache
        )
    x = x + attn_out
    h = norm_apply(cfg, p["norm2"], x)
    aux = None
    if "moe" in p:
        mlp_out, aux = hooks.moe(moe_apply, cfg, p["moe"], h)
    else:
        mlp_out = mlp_apply(cfg, p["mlp"], h)
    return x + mlp_out, aux, new_cache


def _mixer_block_apply(cfg: ModelConfig, kind: str, p, x, positions, state=None):
    """One recurrentgemma layer (``kind`` "rec": RG-LRU, "attn": local
    attention over ``cfg.window``) -> (x, state)."""
    h = norm_apply(cfg, p["norm1"], x)
    if kind == "rec":
        mix_out, new_state = rglru_apply(cfg, p["rec"], h, state=state)
    else:
        mix_out, new_state = attention_apply(
            cfg, p["attn"], h, positions=positions, causal=True, window=cfg.window, cache=state)
    x = x + mix_out
    h = norm_apply(cfg, p["norm2"], x)
    return x + mlp_apply(cfg, p["mlp"], h), new_state


def _rwkv_block_apply(cfg: ModelConfig, p, x, state=None):
    tstate = None if state is None else state["time"]
    cstate = None if state is None else state["channel"]
    h, new_t = rwkv6_timemix_apply(cfg, p["time"], norm_apply(cfg, p["norm1"], x), state=tstate)
    x = x + h
    h, new_c = rwkv6_channelmix_apply(cfg, p["channel"], norm_apply(cfg, p["norm2"], x),
                                      state=cstate)
    return x + h, {"time": new_t, "channel": new_c}


def _sinusoidal(positions, d: int) -> torch.Tensor:
    """(..., S) positions -> (..., S, d) fp32 ``[sin, cos]`` of position x
    frequency; the frequencies in float64, then fp32, as the reference's
    NumPy constants reach JAX, computed on the positions' device (a host
    copy would make a decode step wait for the host)."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float64, device=positions.device) / half)
    ang = positions[..., None].float() * freqs.float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _cross_kv(cfg: ModelConfig, p, enc):
    """Cross-attention K / V of the encoder output, in its dtype."""
    dt = enc.dtype
    b, se, _ = enc.shape
    hd = cfg.head_dim_
    k = layers._heads(enc @ p["w_k"].to(dt), hd, cfg.n_kv_heads)
    v = layers._heads(enc @ p["w_v"].to(dt), hd, cfg.n_kv_heads)
    return k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, -1)


def _enc_block_apply(cfg: ModelConfig, p, x, positions):
    h1 = norm_apply(cfg, p["norm1"], x)
    a_out, _ = attention_apply(cfg, p["attn"], h1, positions=positions, causal=False)
    x = x + a_out
    h2 = norm_apply(cfg, p["norm2"], x)
    return x + mlp_apply(cfg, p["mlp"], h2)


def _dec_block_apply(cfg: ModelConfig, p, x, positions, enc, cache=None):
    """One whisper decoder layer -> (x, cache): causal self-attention (the
    ring cache in decode), cross-attention to ``enc`` (K / V recomputed
    from it here, queries not roped), MLP."""
    h1 = norm_apply(cfg, p["norm1"], x)
    a_out, new_cache = attention_apply(cfg, p["attn"], h1, positions=positions, causal=True,
                                       cache=cache)
    x = x + a_out
    h2 = norm_apply(cfg, p["norm2"], x)
    k, v = _cross_kv(cfg, p["cross"], enc)
    enc_pos = constrain(_positions(enc.shape[0], enc.shape[1], enc.device))
    c_out, _ = attention_apply(cfg, p["cross"], h2, positions=positions,
                               kv_override=(k, v, enc_pos))
    x = x + c_out
    h3 = norm_apply(cfg, p["norm3"], x)
    return x + mlp_apply(cfg, p["mlp"], h3), new_cache


def _block_apply(cfg: ModelConfig, kind: str, p, x, positions, state=None, enc=None):
    """One entry of a stack -> (x, aux, state): ``aux`` the MoE layer's
    load-balancing loss, None elsewhere (the reference's zero); ``state``
    the entry's cache or recurrent state, written in place in decode."""
    if kind == "super":
        for i, sub in enumerate(cfg.block_pattern):
            x, _ = _mixer_block_apply(cfg, sub, p[f"l{i}"], x, positions,
                                      None if state is None else state[f"l{i}"])
        return x, None, state
    if kind in ("rec", "attn"):
        x, state = _mixer_block_apply(cfg, kind, p, x, positions, state)
        return x, None, state
    if kind == "rwkv":
        x, state = _rwkv_block_apply(cfg, p, x, state)
        return x, None, state
    if kind == "dec":
        x, state = _dec_block_apply(cfg, p, x, positions, enc, state)
        return x, None, state
    if kind == "enc":
        return _enc_block_apply(cfg, p, x, positions), None, None
    return _lm_block_apply(cfg, p, x, positions, cache=state)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_init(cfg: ModelConfig, kind: str, generator, lead: tuple, device) -> dict:
    """The parameters of a stack of ``lead`` entries of one kind of block."""
    d = cfg.d_model
    if kind == "super":
        return {f"l{i}": _block_init(cfg, sub, generator, lead, device)
                for i, sub in enumerate(cfg.block_pattern)}
    norms = ("norm1", "norm2", "norm3") if kind == "dec" else ("norm1", "norm2")
    block = {name: norm_init(cfg, d, lead=lead, device=device) for name in norms}
    if kind == "rwkv":
        block["time"] = rwkv6_timemix_init(generator, cfg, lead=lead, device=device)
        block["channel"] = rwkv6_channelmix_init(generator, cfg, lead=lead, device=device)
        return block
    if kind == "rec":
        block["rec"] = rglru_init(generator, cfg, lead=lead, device=device)
    elif cfg.mla is not None:
        block["mla"] = mla_init(generator, cfg, cfg.mla, lead=lead, device=device)
    else:
        block["attn"] = attention_init(generator, cfg, lead=lead, device=device)
    if kind == "dec":
        block["cross"] = attention_init(generator, cfg, lead=lead, device=device)
    if kind == "moe":
        block["moe"] = moe_init(generator, cfg, cfg.moe, lead=lead, device=device)
    else:
        block["mlp"] = mlp_init(generator, cfg, d, cfg.d_ff, lead=lead, device=device)
    return block


def _param_tree(cfg: ModelConfig, generator, device) -> dict:
    d = cfg.d_model
    params: dict = {
        "embed": _init(generator, (cfg.vocab, d), device),
        "final_norm": norm_init(cfg, d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _init(generator, (d, cfg.vocab), device)
    for key, n, kind in _stacks(cfg):
        params[key] = _block_init(cfg, kind, generator, (n,), device)
    if cfg.family == "encdec":
        params["enc_blocks"] = _block_init(cfg, "enc", generator, (cfg.n_enc_layers,), device)
        params["enc_final_norm"] = norm_init(cfg, d, device=device)
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """The fp32 master parameters, drawn with ``generator`` on its device
    and placed on ``device`` (None: the CUDA card; raises without one).
    Matrices are ``0.02 * truncated_normal(-2, 2)``, norms start at one
    (scale) and zero (bias), as in the reference."""
    return _param_tree(cfg, generator, resolve_device(device))


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes, on the meta device."""
    return _param_tree(cfg, None, torch.device("meta"))


class _ParamTree(torch.nn.Module):
    """A nested dict of tensors held as (frozen) parameters and submodules."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, _ParamTree(leaf))
            else:
                self.register_parameter(name, torch.nn.Parameter(leaf, requires_grad=False))

    def tree(self) -> dict:
        out = dict(self.named_parameters(recurse=False))
        out.update((name, child.tree()) for name, child in self.named_children())
        return out


class LanguageModel(_ParamTree):
    """A thin ``nn.Module`` over a parameter tree: its leaves are parameters
    (``.to(device)``, ``state_dict`` keys such as ``dense_blocks.attn.w_q``)
    and ``prefill`` / ``decode`` call the functions of this module."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def prefill(self, batch: dict) -> torch.Tensor:
        return prefill(self.cfg, self.tree(), batch)

    def decode(self, cache: dict, batch: dict):
        return decode_step(self.cfg, self.tree(), cache, batch)


# ---------------------------------------------------------------------------
# Forward (prefill) and decode
# ---------------------------------------------------------------------------


def _embed(params, tokens):
    # gather then cast, as the reference's take(embed).astype(bf16)
    return hooks.embedding(tokens, params["embed"]).to(layers.COMPUTE_DTYPE)


def _lm_head(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return hooks.gather(params["embed"]).T
    return hooks.gather(params["lm_head"])


def _logits(cfg: ModelConfig, params, x):
    """Last-position logits: bf16 product with the head, then fp32."""
    return (x[:, -1] @ _lm_head(cfg, params).to(layers.COMPUTE_DTYPE)).float()


def _run_stack(cfg: ModelConfig, kind: str, stacked: dict, n: int, x, positions, enc=None):
    """The ``n`` entries of one stack over ``x`` -> (x, the entries' summed
    aux, None without MoE).  While autograd records, each entry (a layer,
    or a whole rglru super-block) runs under the remat policy; the
    decoder's encoder output ``enc`` is an argument of the remat unit."""
    def block(p, h, *memory):
        h, aux, _ = _block_apply(cfg, kind, hooks.gather(p), h, positions,
                                 enc=memory[0] if memory else None)
        return h, aux

    memory = () if enc is None else (enc,)
    run = _remat(block) if _records(x, stacked, *memory) else block
    aux = None
    for layer in _unbind_layers(stacked, n):
        x, layer_aux = run(layer, x, *memory)
        x = constrain(x)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux
    return x, aux


def _encode(cfg: ModelConfig, params, frames):
    """The encoder over (B, enc_seq, D) frames: the fp32 sinusoid added in
    the compute dtype, ``n_enc_layers`` non-causal blocks (RoPE on their
    attention, as the reference), the final norm."""
    x = frames.to(layers.COMPUTE_DTYPE)
    b, s, _ = x.shape
    positions = constrain(_positions(b, s, x.device))
    x = constrain(x + _sinusoidal(positions, cfg.d_model).to(x.dtype))
    x, _ = _run_stack(cfg, "enc", params["enc_blocks"], cfg.n_enc_layers, x, positions)
    return norm_apply(cfg, hooks.gather(params["enc_final_norm"]), x)


def forward(cfg: ModelConfig, params, batch: dict):
    """Full-sequence forward -> final hidden states (B, S, D) and the aux
    loss: the MoE layers' load-balancing losses summed per stack, then over
    the stacks, in fp32 (zero without MoE).

    batch: {"tokens": (B, S) int} plus, for a VLM, {"patches": (B,
    vision_prefix, D)} (the stub vision tower's output), prepended to the
    text and stripped from the result, and for encdec {"frames": (B,
    enc_seq, D)} (the stub audio frontend's output), which the encoder
    reads."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = constrain(_embed(params, tokens))
    n_prefix = 0
    if cfg.vision_prefix and "patches" in batch:
        prefix = batch["patches"].to(layers.COMPUTE_DTYPE)
        n_prefix = prefix.shape[1]
        x = torch.cat([prefix, x], dim=1)
    positions = constrain(_positions(b, s + n_prefix, x.device))
    enc = None
    if cfg.family == "encdec":
        enc = _encode(cfg, params, batch["frames"])
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for key, n, kind in _stacks(cfg):
        x, stack_aux = _run_stack(cfg, kind, params[key], n, x, positions, enc)
        if stack_aux is not None:
            aux = aux + stack_aux
    x = norm_apply(cfg, hooks.gather(params["final_norm"]), x)
    if n_prefix:
        x = x[:, n_prefix:]
    return x, aux


def _ce_chunk(h, head, t, m):
    """(sum of masked NLL, mask sum) of one chunk: the head product in the
    compute dtype, then fp32 logsumexp."""
    nll = hooks.nll((h @ head).float(), t) * m
    return nll.sum(), m.sum()


def chunked_ce(cfg: ModelConfig, params, hidden, targets, mask) -> torch.Tensor:
    """Mean next-token CE without building the (B, S, V) logits: one step
    per ``CE_CHUNK`` positions, each under the remat policy while autograd
    records.  The reference pads the tail chunk with masked positions; a
    shorter tail adds the same sums."""
    head = _lm_head(cfg, params).to(layers.COMPUTE_DTYPE)
    step = _remat(_ce_chunk) if _records(hidden, head) else _ce_chunk
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, hidden.shape[1], CE_CHUNK):
        sl = slice(c, c + CE_CHUNK)
        nll, n = step(hidden[:, sl], head, targets[:, sl], mask[:, sl])
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params, batch: dict):
    """-> (ce + 0.01 * aux, {"ce", "aux"}): the next-token cross-entropy
    (targets are the tokens rolled by one, the last position masked)."""
    hidden, aux = forward(cfg, params, batch)
    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)  # rolled by one
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    mask = constrain(mask)
    ce = chunked_ce(cfg, params, hidden, targets, mask)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """Full-prompt forward returning last-position logits (B, V) fp32."""
    hidden, _ = forward(cfg, params, batch)
    return _logits(cfg, params, hidden)


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, lead: tuple,
                 device) -> dict:
    """The decode state of a stack of ``lead`` entries of one kind."""
    if kind == "super":
        return {f"l{i}": _block_cache(cfg, sub, batch, max_len, lead, device)
                for i, sub in enumerate(cfg.block_pattern)}
    if kind == "rec":
        return rglru_state_init(cfg, batch, lead=lead, device=device)
    if kind == "rwkv":
        return rwkv6_state_init(cfg, batch, lead=lead, device=device)
    if cfg.mla is not None:
        return mla_cache_init(cfg, batch, max_len, lead=lead, device=device)
    window = cfg.window if kind == "attn" or cfg.attn_kind == "swa" else 0
    return attention_cache_init(cfg, batch, max_len, window, lead=lead, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """The stacked decode caches, one per stack (``_stacks``), on
    ``device`` (None: the CUDA card).  An attention layer keeps a ring
    {"k", "v": (L, B, size, Hkv, D) bf16, "pos": (L, B, size) int32
    (2**30 where empty), "index": (L,) int32}, size clamped to the window
    under SWA and in recurrentgemma's local attention; with MLA the
    compressed {"ckv": (L, B, max_len, kv_lora), "krope": (L, B, max_len,
    qk_rope), "pos", "index"}; an RG-LRU layer {"h": (L, B, W), "conv":
    (L, B, 3, W)} and an RWKV6 layer {"time": {"S": (L, B, H, dk, dv),
    "prev": (L, B, 1, D)}, "channel": {"prev"}}, fp32 zeros.  encdec adds
    "enc_out", (B, enc_seq, D) zeros in the compute dtype: the encoder
    output that decode reads (nothing fills it, as in the reference)."""
    dev = resolve_device(device)
    cache = {key: _block_cache(cfg, kind, batch, max_len, (n,), dev)
             for key, n, kind in _stacks(cfg)}
    if cfg.family == "encdec":
        cache["enc_out"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                       dtype=layers.COMPUTE_DTYPE, device=dev)
    return cache


def decode_step(cfg: ModelConfig, params, cache: dict, batch: dict):
    """One-token step.  batch: {"tokens": (B, 1), "positions": (B, 1)} on
    the parameters' device -> (logits (B, V) fp32, cache).

    The cache is updated IN PLACE and returned: the caller's cache is
    consumed (the reference returns a new one and leaves its input).  Ring
    slots, positions and indices, and the recurrent states, are written
    into the stacked tensors on the device, so a step makes no host sync.
    encdec reads ``cache["enc_out"]`` (every layer recomputes its cross
    K / V from it) and leaves it as it is."""
    tokens, positions = batch["tokens"], batch["positions"]
    x = constrain(_embed(params, tokens))
    enc = None
    if cfg.family == "encdec":
        enc = cache["enc_out"].to(layers.COMPUTE_DTYPE)
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
    for key, n, kind in _stacks(cfg):
        blocks, caches = params[key], cache[key]
        for i in range(n):
            x, _, _ = _block_apply(cfg, kind, hooks.gather(_layer(blocks, i)), x, positions,
                                   state=_layer(caches, i), enc=enc)
            x = constrain(x)
    x = norm_apply(cfg, hooks.gather(params["final_norm"]), x)
    return _logits(cfg, params, x), cache
