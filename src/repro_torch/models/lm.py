"""Model assembly of the port: init, forward, prefill and decode for the
language-model family (the reference's ``repro.models.lm``).

    params       = init_params(cfg, generator)            # fp32 master copy
    hidden, aux  = forward(cfg, params, batch)
    loss, aux    = loss_fn(cfg, params, batch)            # train
    logits       = prefill(cfg, params, batch)            # (B, V) fp32
    cache        = init_cache(cfg, batch, max_len)
    logits, c    = decode_step(cfg, params, cache, batch) # cache consumed

Parameters and caches are nested dicts with the reference's keys and its
stacked leading layer axis: ``"dense_blocks"`` holds the layers with a
dense MLP (all of them without MoE, else the first ``n_dense_layers``),
``"blocks"`` the MoE layers after them; each layer attends with GQA or,
where the config has MLA, with multi-head latent attention and its
compressed cache.  A Python loop over views of the stacked tensors takes
the place of the reference's ``lax.scan`` over layers.  ``forward`` takes
the layer views from one ``torch.unbind`` per stacked leaf, so under
autograd each leaf's gradient is assembled once, and while autograd
records each layer runs under the remat policy (``set_remat_policy``:
``torch.utils.checkpoint`` per layer).  It returns the MoE layers' summed
load-balancing loss beside the hidden states.  Cross-entropy runs in
chunks of ``CE_CHUNK`` positions, so the (B, S, V) logits are never
built.  ``LanguageModel`` is a thin ``nn.Module`` over the same tree.

This slice runs ``family == "lm"`` (dense, MoE, MLA); the recurrent,
RWKV and encoder-decoder families raise ``NotImplementedError`` naming
the ROADMAP item that brings them.  Every function runs on the device its
tensors are on; ``init_params`` and ``init_cache`` put them on the CUDA
card unless given a device.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from .config import ModelConfig
from . import layers
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


def require_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family this slice does not run:
    rglru, rwkv6 and encdec (ROADMAP A9c brings them)."""
    if cfg.family != "lm":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP A9c)"
        )


def _stacks(cfg: ModelConfig) -> list:
    """[(stack key, layers, MoE?)] in the order the layers run: the dense
    stack, then the MoE stack; an empty stack is left out."""
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
    n_dense = cfg.n_layers - n_moe
    return [(key, n, moe) for key, n, moe in (("dense_blocks", n_dense, False),
                                               ("blocks", n_moe, True)) if n]


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
        mlp_out, aux = moe_apply(cfg, p["moe"], h, cfg.moe)
    else:
        mlp_out = mlp_apply(cfg, p["mlp"], h)
    return x + mlp_out, aux, new_cache


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param_tree(cfg: ModelConfig, generator, device) -> dict:
    d = cfg.d_model
    params: dict = {
        "embed": _init(generator, (cfg.vocab, d), device),
        "final_norm": norm_init(cfg, d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _init(generator, (d, cfg.vocab), device)
    for key, n, use_moe in _stacks(cfg):
        lead = (n,)
        block = {
            "norm1": norm_init(cfg, d, lead=lead, device=device),
            "norm2": norm_init(cfg, d, lead=lead, device=device),
        }
        if cfg.mla is not None:
            block["mla"] = mla_init(generator, cfg, cfg.mla, lead=lead, device=device)
        else:
            block["attn"] = attention_init(generator, cfg, lead=lead, device=device)
        if use_moe:
            block["moe"] = moe_init(generator, cfg, cfg.moe, lead=lead, device=device)
        else:
            block["mlp"] = mlp_init(generator, cfg, d, cfg.d_ff, lead=lead, device=device)
        params[key] = block
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """The fp32 master parameters, drawn with ``generator`` on its device
    and placed on ``device`` (None: the CUDA card; raises without one).
    Matrices are ``0.02 * truncated_normal(-2, 2)``, norms start at one
    (scale) and zero (bias), as in the reference."""
    require_supported(cfg)
    return _param_tree(cfg, generator, resolve_device(device))


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes, on the meta device."""
    require_supported(cfg)
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
        require_supported(cfg)
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
    return F.embedding(tokens, params["embed"]).to(layers.COMPUTE_DTYPE)


def _lm_head(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _logits(cfg: ModelConfig, params, x):
    """Last-position logits: bf16 product with the head, then fp32."""
    return (x[:, -1] @ _lm_head(cfg, params).to(layers.COMPUTE_DTYPE)).float()


def forward(cfg: ModelConfig, params, batch: dict):
    """Full-sequence forward -> final hidden states (B, S, D) and the aux
    loss: the MoE layers' load-balancing losses summed per stack, then over
    the stacks, in fp32 (zero without MoE).

    batch: {"tokens": (B, S) int} plus, for a VLM, {"patches": (B,
    vision_prefix, D)} (the stub vision tower's output), prepended to the
    text and stripped from the result."""
    require_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = constrain(_embed(params, tokens))
    n_prefix = 0
    if cfg.vision_prefix and "patches" in batch:
        prefix = batch["patches"].to(layers.COMPUTE_DTYPE)
        n_prefix = prefix.shape[1]
        x = torch.cat([prefix, x], dim=1)
    positions = torch.arange(s + n_prefix, dtype=torch.int32, device=x.device).expand(b, -1)

    def block(p, h):
        return _lm_block_apply(cfg, p, h, positions)[:2]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for key, n, _ in _stacks(cfg):
        run = _remat(block) if _records(x, params[key]) else block
        stack_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in _unbind_layers(params[key], n):
            x, layer_aux = run(layer, x)
            x = constrain(x)
            if layer_aux is not None:
                stack_aux = stack_aux + layer_aux
        aux = aux + stack_aux
    x = norm_apply(cfg, params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    return x, aux


def _ce_chunk(h, head, t, m):
    """(sum of masked NLL, mask sum) of one chunk: the head product in the
    compute dtype, then fp32 logsumexp."""
    logits = (h @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None].long())[..., 0]
    nll = (lse - gold) * m
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
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    ce = chunked_ce(cfg, params, hidden, targets, mask)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """Full-prompt forward returning last-position logits (B, V) fp32."""
    hidden, _ = forward(cfg, params, batch)
    return _logits(cfg, params, hidden)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """The stacked ring-buffer caches, one per stack of layers ("dense_blocks",
    "blocks"), on ``device`` (None: the CUDA card): {"k", "v": (L, B, size,
    Hkv, D) bf16, "pos": (L, B, size) int32 (2**30 where empty), "index":
    (L,) int32}, size clamped to the window under SWA; with MLA the
    compressed {"ckv": (L, B, max_len, kv_lora), "krope": (L, B, max_len,
    qk_rope), "pos", "index"}."""
    require_supported(cfg)
    dev = resolve_device(device)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    cache = {}
    for key, n, _ in _stacks(cfg):
        if cfg.mla is not None:
            cache[key] = mla_cache_init(cfg, batch, max_len, lead=(n,), device=dev)
        else:
            cache[key] = attention_cache_init(cfg, batch, max_len, window, lead=(n,), device=dev)
    return cache


def decode_step(cfg: ModelConfig, params, cache: dict, batch: dict):
    """One-token step.  batch: {"tokens": (B, 1), "positions": (B, 1)} on
    the parameters' device -> (logits (B, V) fp32, cache).

    The cache is updated IN PLACE and returned: the caller's cache is
    consumed (the reference returns a new one and leaves its input).  The
    slot arithmetic runs on the device, so a step makes no host sync."""
    require_supported(cfg)
    tokens, positions = batch["tokens"], batch["positions"]
    x = constrain(_embed(params, tokens))
    for key, n, _ in _stacks(cfg):
        blocks, caches = params[key], cache[key]
        for i in range(n):
            x, _, _ = _lm_block_apply(cfg, _layer(blocks, i), x, positions,
                                      cache=_layer(caches, i))
            x = constrain(x)
    x = norm_apply(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), cache
