"""Sharding rules of the port: parameter / optimizer / batch / cache specs
and their DTensor placements (the reference's ``repro.launch.shardings``).

Baseline scheme, the reference's rule for rule:

  * weights:  FSDP over the ``data`` axis x tensor-parallel over ``model``.
    "in" projections (d -> wide) put d on data and the wide dim on model;
    "out" projections (wide -> d) the reverse (Megatron pairing);
  * embeddings: vocab on model, d_model on data;
  * MoE experts: expert axis on model (EP), falling back to TP over d_ff
    when the expert count does not divide ``model``;
  * batch: sharded over ("pod", "data"), placed on the batch mesh where
    the two are one flattened axis (``launch.mesh.batch_mesh``);
  * decode caches: batch over the data axes; kv heads / state width on
    model when divisible, else the sequence (flash-decode style); batch 1
    moves the data axes to the sequence.

A SPEC is the reference's ``PartitionSpec`` as data: a plain tuple with one
entry per tensor dimension (None, an axis name, or a tuple of axis names
sharding that dimension major-first), single-axis tuples written as the
bare name, as ``PartitionSpec`` normalises them.  The spec functions take
any mesh-like object (a ``DeviceMesh``, or anything with ``.axis_names``
and a ``.shape`` mapping), so the production shapes can be checked without
256 ranks.  ``to_placements`` maps a spec onto DTensor placements and the
tree functions return ``NamedSharding`` records carrying both;
``distribute_tree`` places a tree by them.

Parameter trees are nested dicts; a leaf's PATH is the tuple of its keys.
Grads inherit the param specs, and so do AdamW's moments (ZeRO-1 for free
under FSDP).  The spec functions never look at values, so meta-device
trees (``param_specs``, ``cache_specs``) work as well as real ones.

    PYTHONPATH=src python -m repro_torch.launch.shardings --selftest

spawns 4 gloo ranks on a 2x2 mesh and holds the sharded train, prefill and
decode steps of four reduced families to the unsharded port on every rank.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Any

import torch

from ..models.config import ModelConfig
from .mesh import DATA, MODEL, POD, POD_DATA, axis_sizes, batch_mesh, data_axes


def _P(*entries) -> tuple:
    """A spec: lists become tuples and one-axis tuples their bare name."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def _spec(ndim: int, *trailing) -> tuple:
    """Spec for the trailing dims, None-padded for stacked layers."""
    return _P(*([None] * (ndim - len(trailing)) + list(trailing)))


_IN = (DATA, MODEL)  # (d_model, wide)
_OUT = (MODEL, DATA)  # (wide, d_model)

# name -> trailing-dims spec, optionally keyed by parent
_RULES: dict[str, Any] = {
    "embed": ("exact", (MODEL, DATA)),
    "lm_head": ("exact", (DATA, MODEL)),
    "w_q": ("trail", _IN),
    "w_qkv": ("trail", _IN),
    "w_o": ("trail", _OUT),
    "w_gate": ("trail", _IN),
    "w_up": ("trail", _IN),
    "w_down": ("trail", _OUT),
    "router": ("trail", (DATA, None)),
    # MLA
    "w_dq": ("trail", (DATA, None)),
    "w_uq": ("trail", (None, MODEL)),
    "w_dkv": ("trail", (DATA, None)),
    "w_kr": ("trail", (DATA, None)),
    "w_uk": ("trail", (None, MODEL)),
    "w_uv": ("trail", (None, MODEL)),
    # RG-LRU
    "w_x": ("trail", _IN),
    "conv_w": ("trail", (None, MODEL)),
    "conv_b": ("trail", (MODEL,)),
    "a_param": ("trail", (MODEL,)),
    "w_rg": ("trail", (MODEL, None)),
    "w_ig": ("trail", (MODEL, None)),
    "w_out": ("trail", _OUT),
    # RWKV6 low-rank factors (the rest of its small tensors replicate)
    "mix_lora_a": ("trail", (DATA, None)),
    "decay_lora_a": ("trail", (DATA, None)),
}

_PARENT_RULES: dict[tuple[str, str], tuple] = {
    # MoE expert-parallel weights: (E, D, F) / (E, F, D)
    ("moe", "w_gate"): ("trail", (MODEL, DATA, None)),
    ("moe", "w_up"): ("trail", (MODEL, DATA, None)),
    ("moe", "w_down"): ("trail", (MODEL, None, DATA)),
    # attention K/V projections (d, kv*hd): wide dim on model
    ("attn", "w_k"): ("trail", _IN),
    ("attn", "w_v"): ("trail", _IN),
    ("cross", "w_k"): ("trail", _IN),
    ("cross", "w_v"): ("trail", _IN),
    # rwkv time-mix square projections: Megatron pairing
    ("time", "w_r"): ("trail", _IN),
    ("time", "w_k"): ("trail", _IN),
    ("time", "w_v"): ("trail", _IN),
    ("time", "w_g"): ("trail", _IN),
    ("time", "w_o"): ("trail", _OUT),
    # rwkv channel-mix
    ("channel", "w_k"): ("trail", _IN),
    ("channel", "w_v"): ("trail", _OUT),
    ("channel", "w_r"): ("trail", _IN),
}


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= sizes[a]
        return size
    return sizes[axis]


def _fit(mesh, spec: tuple, shape) -> tuple:
    """Drop mesh axes from dims they do not divide (MQA kv=1, 8-expert MoE,
    batch=1 decode cells, ...)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    return _P(*(None if axis is None or extent % _axis_size(mesh, axis) else axis
                for extent, axis in zip(shape, dims)))


def param_pspec(path, leaf, mesh=None) -> tuple:
    """The spec of the parameter at ``path`` (its tuple of keys)."""
    names = [str(p) for p in path]
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    shape = tuple(getattr(leaf, "shape", ()))
    nd = len(shape)
    rule = _PARENT_RULES.get((parent, name)) or _RULES.get(name)
    if rule is None:
        return ()  # norms, biases, gates: replicated
    kind, spec = rule
    spec = _P(*spec) if kind == "exact" else _spec(nd, *spec)
    if mesh is None:
        return spec
    if parent == "moe" and name in ("w_gate", "w_up", "w_down"):
        # EP wants the expert axis on 'model'; with fewer experts than the
        # model axis (mixtral: 8 < 16) fall back to TP over d_ff instead.
        if shape[nd - 3] % axis_sizes(mesh)[MODEL] != 0:
            alt = (None, DATA, MODEL) if name in ("w_gate", "w_up") else (None, MODEL, DATA)
            spec = _spec(nd, *alt)
    return _fit(mesh, spec, shape)


def serve_param_pspec(path, leaf, mesh) -> tuple:
    """Inference-time weights: the TP part of ``param_pspec``, no FSDP (the
    data axis replicates, so a decode step all-gathers no weight)."""
    spec = param_pspec(path, leaf, mesh)
    return _fit(mesh, _P(*(None if ax == DATA else ax for ax in spec)), tuple(leaf.shape))


def batch_leaf_pspec(mesh, shape) -> tuple:
    """A batch leaf: dimension 0 over the data axes when they divide it."""
    nd = len(shape)
    if not nd:
        return ()
    return _fit(mesh, _spec(nd, *([data_axes(mesh)] + [None] * (nd - 1))), tuple(shape))


_TRAILING = {"k": 4, "v": 4, "pos": 2, "ckv": 3, "krope": 3, "h": 2, "conv": 3,
             "S": 4, "prev": 3, "enc_out": 3}


def _trailing_rank(name: str) -> int:
    """dims after (and including) batch for each cache leaf kind."""
    return _TRAILING.get(name, 1)


def _join_axes(ax, extra):
    """Combine mesh axes on one dim: None+m -> m; ('data',)+m -> ('data', m)."""
    if ax is None:
        return extra
    if isinstance(ax, (tuple, list)):
        return tuple(ax) + (extra,)
    return (ax, extra)


def cache_pspec(path, leaf, mesh, cfg: ModelConfig) -> tuple:
    """Decode-cache specs: batch over dp; head/width dims on model.

    When the batch dim cannot take the dp axes (long_500k has batch=1), the
    sequence dim of KV-style caches takes them instead (sequence
    parallelism).  Non-dividing extents are dropped by _fit (MQA kv=1,
    RWKV H=40)."""
    names = [str(p) for p in path]
    name = names[-1] if names else ""
    shape = tuple(getattr(leaf, "shape", ()))
    nd = len(shape)
    model = axis_sizes(mesh)[MODEL]
    dp = data_axes(mesh)
    if len(dp) == 1:
        dp = dp[0]
    if name == "index" or nd == 0:
        return ()
    batch_ok = nd >= 2 and shape[-_trailing_rank(name)] % _axis_size(mesh, dp) == 0

    def bdim():
        """(batch_axis, seq_axis): move dp to seq when batch can't shard."""
        return (dp, None) if batch_ok else (None, dp)

    if name in ("k", "v"):  # (L, B, S, kv_heads, hd)
        b_ax, s_ax = bdim()
        kv_ok = shape[-2] % model == 0
        if not kv_ok:
            # kv heads cannot take the model axis: shard the cache SEQUENCE
            # over model instead (flash-decode style)
            s_ax = _join_axes(s_ax, MODEL)
        return _fit(mesh, _spec(nd, b_ax, s_ax, MODEL if kv_ok else None, None), shape)
    if name == "pos":  # (L, B, S) -- must match the k/v seq sharding
        b_ax, s_ax = bdim()
        s_ax = _join_axes(s_ax, MODEL) if cfg.n_kv_heads % model else s_ax
        return _fit(mesh, _spec(nd, b_ax, s_ax), shape)
    if name == "ckv":  # (L, B, S, kv_lora)
        b_ax, s_ax = bdim()
        return _fit(mesh, _spec(nd, b_ax, s_ax, MODEL), shape)
    if name == "krope":  # (L, B, S, rope_dim)
        b_ax, s_ax = bdim()
        return _fit(mesh, _spec(nd, b_ax, s_ax, None), shape)
    if name == "h":  # (L, B, W)
        return _fit(mesh, _spec(nd, dp, MODEL), shape)
    if name == "conv":  # (L, B, 3, W)
        return _fit(mesh, _spec(nd, dp, None, MODEL), shape)
    if name == "S":  # (L, B, H, dk, dv)
        return _fit(mesh, _spec(nd, dp, MODEL, None, None), shape)
    if name == "prev":  # (L, B, 1, D)
        return _fit(mesh, _spec(nd, dp, None, None), shape)
    if name == "enc_out":  # (B, S_enc, D)
        return _fit(mesh, _spec(nd, dp, None, None), shape)
    return _fit(mesh, _spec(nd, dp), shape)


def logits_pspec(mesh, batch: int, vocab: int) -> tuple:
    """(B, V) logits: batch over dp if divisible, vocab over model."""
    return _fit(mesh, _P(data_axes(mesh), MODEL), (batch, vocab))


# ---------------------------------------------------------------------------
# Placements and trees
# ---------------------------------------------------------------------------


def _mesh_axes(mesh, entry) -> tuple:
    """The axes of ``mesh`` that shard a dimension whose spec entry is
    ``entry``: on a batch mesh ("pod", "data") is its one "pod_data" axis,
    and either alone has no axis there."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    if POD_DATA not in axis_sizes(mesh) or not ({POD, DATA} & set(axes)):
        return axes
    i = axes.index(POD) if POD in axes else -1
    if i < 0 or axes[i:i + 2] != (POD, DATA):
        raise ValueError(f"spec entry {entry} shards over 'pod' or 'data' alone; the "
                         f"batch mesh {tuple(axis_sizes(mesh))} has them flattened")
    return axes[:i] + (POD_DATA,) + axes[i + 2:]


def to_placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec``, one per mesh axis: an axis that
    shards dimension d is ``Shard(d)``, every other axis ``Replicate()``.
    A dimension sharded by a tuple of axes is split major-first, which is
    DTensor's order when the axes run in mesh order (as every rule's do).
    On a batch mesh ("pod", "data") maps to its flattened axis."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _mesh_axes(mesh, entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} does not run in mesh order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``) and the DTensor
    placements it implies.  ``mesh`` is the mesh the tensor is placed on:
    the batch mesh for batch, cache and logits shardings."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


def local_shape(sharding: NamedSharding, shape) -> tuple:
    """The per-device shard shape of a tensor of ``shape`` placed by
    ``sharding`` (``_fit`` leaves only axes that divide their dims)."""
    sizes = axis_sizes(sharding.mesh)
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        for a in (_mesh_axes(sharding.mesh, entry) if entry else ()):
            out[d] //= sizes[a]
    return tuple(out)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict (paths are key tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(mesh, params_tree):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(path, leaf, mesh)), params_tree)


def serve_param_shardings(mesh, params_tree):
    """Inference-time weights: TP over 'model' only, NO FSDP."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, serve_param_pspec(path, leaf, mesh)),
        params_tree)


def batch_shardings(mesh, batch_tree):
    on = batch_mesh(mesh)
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(on, batch_leaf_pspec(mesh, tuple(leaf.shape))),
        batch_tree)


def cache_shardings(mesh, cfg: ModelConfig, cache_tree):
    on = batch_mesh(mesh)
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(on, cache_pspec(path, leaf, mesh, cfg)), cache_tree)


def opt_shardings(mesh, params_tree):
    """AdamW state: ``m`` and ``v`` as the parameters, ``count`` replicated."""
    sh = param_shardings(mesh, params_tree)
    return {"m": sh, "v": sh, "count": NamedSharding(mesh, ())}


def replicated(mesh, tree):
    return tree_map_with_path(lambda path, leaf: NamedSharding(mesh, ()), tree)


def logits_sharding(mesh, batch: int, vocab: int) -> NamedSharding:
    return NamedSharding(batch_mesh(mesh), logits_pspec(mesh, batch, vocab))


def distribute_tree(tree, shardings):
    """Place every tensor of ``tree`` by its ``NamedSharding`` (same
    structure), on the sharding's mesh: each rank keeps its shard of the
    full tensor it holds (every rank must hold the same values, as after
    a shared seed)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return distribute_tensor(tree, shardings.mesh, shardings.placements)


def full_tree(tree):
    """The full tensors of a tree of DTensors (an all-gather each); other
    leaves as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


# ---------------------------------------------------------------------------
# The model's placement hooks on a mesh
# ---------------------------------------------------------------------------


def _across(placements, src, dst) -> list:
    """``placements`` on mesh ``src`` re-expressed on ``dst``, one of the two
    a batch mesh of the other: the "pod_data" axis holds what "pod" and
    "data" both hold (a part of a sum over its ranks is one over each of
    the two axes in turn, a shard over it two nested ones, major first)."""
    src_names, dst_names = list(axis_sizes(src)), list(axis_sizes(dst))
    at = {a: placements[i] for i, a in enumerate(src_names)}
    if POD_DATA in at:
        at[POD] = at[DATA] = at.pop(POD_DATA)
    elif POD_DATA in dst_names:
        if at[POD] != at[DATA]:
            raise ValueError(f"{tuple(placements)} on {tuple(src_names)} differ over "
                             "'pod' and 'data': no placement of the batch mesh holds them")
        at[POD_DATA] = at.pop(POD)
    return [at[a] for a in dst_names]


class _Remesh(torch.autograd.Function):
    """A parameter gathered to ``placements`` on its own mesh, then moved to
    another mesh over the same ranks in the same order (the multi-pod mesh
    and its batch mesh): the same local shard, the placements re-expressed
    (``_across``).  Its gradient is moved back the same way and reduced
    into the parameter's own shards over "data" first, then over "pod" on
    those shards, so the sum across pods moves a shard, not the gathered
    parameter."""

    @staticmethod
    def forward(ctx, x, placements, mesh):
        from torch.distributed.tensor import DTensor

        ctx.own, ctx.placements = x.device_mesh, tuple(x.placements)
        gathered = x.redistribute(x.device_mesh, placements)
        ctx.shape, ctx.stride = gathered.shape, gathered.stride()
        return DTensor.from_local(gathered.to_local(), mesh,
                                  _across(gathered.placements, x.device_mesh, mesh),
                                  run_check=False, shape=gathered.shape, stride=gathered.stride())

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        own = ctx.own
        moved = DTensor.from_local(grad.to_local(), own,
                                   _across(grad.placements, grad.device_mesh, own),
                                   run_check=False, shape=ctx.shape, stride=ctx.stride)
        pod = list(axis_sizes(own)).index(POD)
        first = [p if i == pod else ctx.placements[i] for i, p in enumerate(moved.placements)]
        return moved.redistribute(own, first).redistribute(own, ctx.placements), None, None


def activation_constraint_fn(mesh, whole=None):
    """The placement hooks of ``mesh`` (register with
    ``models.hooks.activation_sharding``); ``whole``, if given, converts a
    tensor every rank built whole before it is placed (the dry run makes
    it fake, so no rank-sized mask is computed on the host):

      * ``constrain``: a plain tensor every rank built whole (the
        positions) keeps its rows of the batch on the data axes; a DTensor
        activation's pending sums (``Partial``, e.g. after a row-parallel
        product) are reduced first, then, when the data axes divide
        dimension 0, it is placed as the reference's ``P(dp, None, ...)``
        constraint places it: batch over the data axes, whole on the
        others.  Its gradient is placed the same way (without that, the
        backward of a sum over the batch hands every rank the whole
        batch's gradient);
      * ``gather``: a parameter's shards over the data axes all-gathered
        (FSDP), its tensor-parallel shards kept, so every product runs
        Megatron-style without a choice left to DTensor's per-op solver;
        on the multi-pod mesh the gathered parameter then moves to the
        batch mesh, where the activations live (``launch.mesh.batch_mesh``),
        and its gradient back, summed into the parameter's shards over
        "data" before the sum over "pod";
      * ``split_heads``: a dimension about to be split into ``n`` groups
        is gathered over the axes whose combined size does not divide
        ``n`` (smollm's 9 heads, mixtral's 8 kv heads, RWKV's 40 on a
        16-way ``model`` axis);
      * ``attend``: an attention kernel run by ``local_map`` on each
        rank's own heads and rows, where heads and batch divide (the
        same kernel, on fewer heads, as one card runs it);
      * ``wkv``: RWKV6's chunked WKV run likewise on each rank's rows and
        heads (every head where they do not divide ``model``);
      * ``moe``: the MoE layer run by ``local_map`` on each rank's token
        groups (all of them where the groups do not split over the data
        ranks) and its experts (expert parallel) or d_ff slice (the
        tensor-parallel fallback); the output a partial sum over
        ``model``;
      * ``merge_heads``: the same for the gradient of a merged dimension,
        which backward splits;
      * ``embedding``: the lookup in the vocab-sharded table with the
        tokens sharded over the data axes and whole over ``model``, so each
        rank looks up only its rows (DTensor's masked partial sum is only
        right when its mask and the rows it masks come from the same
        tokens), then ``constrain``;
      * ``nll``: the cross-entropy terms in the vocab-parallel form;
      * ``ring_write``: a decode ring whose sequence is sharded takes
        each slot on the rank whose shard holds it, in place;
      * ``scope``: DTensor's implicit replication, so the models'
        plain-tensor constants act as replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication, local_map

    from ..models.hooks import Placement
    from ..models import layers as moe_layers
    from ..models.layers import MOE_GROUP
    from ..train.optimizer import tree_flatten as _flatten

    mesh = batch_mesh(mesh)  # where activations, batches and caches live
    sizes = axis_sizes(mesh)
    names = list(sizes)
    dp_idx = [names.index(a) for a in data_axes(mesh)]
    model_idx, model_size = names.index(MODEL), sizes[MODEL]
    dp_size = _axis_size(mesh, data_axes(mesh)) if dp_idx else 1

    def _rows(x):
        """x's rows sharded over the data axes and whole over the others,
        or None where the data axes do not divide them."""
        if x.ndim < 1 or not dp_idx or x.shape[0] % dp_size:
            return None
        return [Shard(0) if i in dp_idx else Replicate() for i in range(len(names))]

    class _Mesh(Placement):
        def constrain(self, x):
            y = self._place(x)
            if isinstance(y, DTensor) and y.requires_grad:
                # the gradient takes the same placement, as the transpose of
                # the reference's constraint does
                want = y.placements
                y.register_hook(
                    lambda g: g if g.placements == want else g.redistribute(mesh, want))
            return y

        def _place(self, x):
            if not isinstance(x, DTensor):
                want = _rows(x)
                if want is None:
                    return x
                # a tensor every rank built whole (positions): keep its rows
                x = x if whole is None else whole(x)
                return distribute_tensor(x, mesh, want, src_data_rank=None)
            if x.ndim < 2:
                return x
            cur = list(x.placements)
            if any(p.is_partial() for p in cur):
                cur = [Replicate() if p.is_partial() else p for p in cur]
                x = x.redistribute(mesh, cur)
            want = _rows(x)
            if want is not None and want != cur:
                x = x.redistribute(mesh, want)
            return x

        def gather(self, tree):
            if isinstance(tree, dict):
                return {k: self.gather(v) for k, v in tree.items()}
            if not isinstance(tree, DTensor):
                return tree
            own = tree.device_mesh
            own_dp = [i for i, a in enumerate(axis_sizes(own)) if a in data_axes(own)]
            want = [Replicate() if i in own_dp else p for i, p in enumerate(tree.placements)]
            if own != mesh:
                return _Remesh.apply(tree, want, mesh)
            return tree if want == list(tree.placements) else tree.redistribute(own, want)

        def split_heads(self, x, dim, n):
            if not isinstance(x, DTensor):
                return x
            dim = dim % x.ndim
            on = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
            split = 1
            for i in on:
                split *= sizes[names[i]]
            if not on or n % split == 0:
                return x
            want = [Replicate() if i in on else p for i, p in enumerate(x.placements)]
            return x.redistribute(mesh, want)

        def attend(self, fn, q, k, v, bias):
            # each rank runs the kernel on its own heads (the port's kernels
            # loop over kv heads or head groups, and a loop index into a
            # sharded head dimension would gather it); where heads or the
            # batch do not divide, the kernel runs on the DTensors and DTensor
            # places it (a sequence-sharded decode ring: the scores gather)
            if not isinstance(q, DTensor) or q.shape[2] % model_size or k.shape[2] % model_size \
                    or (dp_idx and q.shape[0] % dp_size):
                return fn(q, k, v, bias)
            heads = tuple(Shard(0) if i in dp_idx else Shard(2) if i == model_idx else Replicate()
                          for i in range(len(names)))
            rows = tuple(Shard(0) if i in dp_idx else Replicate() for i in range(len(names)))
            return local_map(fn, out_placements=list(heads), in_placements=(heads, heads, heads, rows),
                             device_mesh=mesh, redistribute_inputs=True)(q, k, v, bias)

        def wkv(self, fn, r, k, v, logw, u, head_dim, state):
            # RWKV6's heads are independent: each rank runs the chunked WKV
            # on its own rows and heads (the bonus' gradient a part of a sum
            # over the data axes); where the heads do not divide the model
            # axis (40 on 16), on its rows and every head, as the inputs
            # come (``split_heads`` gathered them over the model axis): the
            # model ranks repeat the work, and DTensor meets none of the
            # kernel's views.  A batch the data axes do not divide: DTensor
            # places it
            n_heads = r.shape[-1] // head_dim
            if not isinstance(r, DTensor) or r.shape[0] % dp_size:
                return fn(r, k, v, logw, u, head_dim, state)
            split = n_heads % model_size == 0
            axes = range(len(names))
            rows = tuple(Shard(0) if i in dp_idx else Shard(2) if i == model_idx and split
                         else Replicate() for i in axes)
            heads = tuple(Shard(0) if i in dp_idx else Shard(1) if i == model_idx and split
                          else Replicate() for i in axes)
            bonus = tuple(Shard(0) if i == model_idx and split else Replicate() for i in axes)
            bonus_grad = tuple(Partial() if i in dp_idx else p_ for i, p_ in enumerate(bonus))
            if state is None:
                return local_map(lambda *a: fn(*a, head_dim, None), out_placements=(rows, heads),
                                 in_placements=(rows, rows, rows, rows, bonus),
                                 in_grad_placements=(rows, rows, rows, rows, bonus_grad),
                                 device_mesh=mesh, redistribute_inputs=True)(r, k, v, logw, u)
            return local_map(lambda *a: fn(*a[:5], head_dim, a[5]),
                             out_placements=(rows, heads),
                             in_placements=(rows, rows, rows, rows, bonus, heads),
                             in_grad_placements=(rows, rows, rows, rows, bonus_grad, heads),
                             device_mesh=mesh, redistribute_inputs=True)(r, k, v, logw, u, state)

        def moe(self, fn, cfg, p, x):
            # Each rank routes its token groups (routing is per group) and
            # runs its own experts (EP) or d_ff slice (TP): its output is a
            # part of a sum over the model axis.  Where the groups split
            # over the data ranks each takes its own; else (a decode step's
            # one group) every rank takes them all.  The parts come out
            # stacked on a new leading dimension sharded over the axes they
            # are parts over and are reduced as DTensors (a Partial output
            # of local_map would hand backward a gradient divided by the
            # axis size), aux as aux / model over every axis it varies on;
            # the inputs' gradients are parts of sums likewise (over split
            # data axes, and over the model axis where a tensor is whole).
            if not isinstance(x, DTensor):
                return fn(cfg, p, x, cfg.moe)
            n_tok = x.shape[0] * x.shape[1]
            split = dp_size == 1 or (n_tok % MOE_GROUP == 0 and x.shape[0] % dp_size == 0
                                     and (n_tok // MOE_GROUP) % dp_size == 0)
            dp_rows = Shard(0) if split else Replicate()
            w = p["w_gate"]
            ep = isinstance(w.placements[model_idx], Shard) and w.placements[model_idx].dim == 0
            leaves, rebuild = _flatten(p)
            axes = range(len(names))
            rows = tuple(dp_rows if i in dp_idx else Replicate() for i in axes)
            part = [(Shard(1) if split else Replicate()) if i in dp_idx
                    else Shard(0) if i == model_idx else Replicate() for i in axes]
            every = [(dp_rows if i in dp_idx else Shard(0)) for i in axes]
            x_grad = tuple(dp_rows if i in dp_idx else Partial() for i in axes)
            w_grads = [tuple((Partial() if split else Replicate()) if i in dp_idx
                             else p_ if isinstance(p_, Shard) else Partial()
                             for i, p_ in enumerate(t.placements)) for t in leaves]
            n_local = cfg.moe.n_experts // model_size

            def local(x, *local_leaves):
                own = None
                if ep:
                    lo = mesh.get_local_rank(model_idx) * n_local
                    own = slice(lo, lo + n_local)
                y, aux = fn(cfg, rebuild(list(local_leaves)), x, cfg.moe, own)
                return y[None], (aux / model_size)[None]

            observer, routes = moe_layers._moe_observer, []
            if observer is not None:  # it sees the routing as DTensors, as elsewhere
                moe_layers.set_moe_observer(lambda *r: routes.append(r))
            try:
                y, aux = local_map(local, out_placements=(part, every),
                                   in_placements=(rows, *(t.placements for t in leaves)),
                                   in_grad_placements=(x_grad, *w_grads),
                                   device_mesh=mesh, redistribute_inputs=True)(x, *leaves)
            finally:
                moe_layers.set_moe_observer(observer)
            for r in routes:
                observer(*(DTensor.from_local(t, mesh, rows, run_check=False) for t in r))
            return y.sum(0), aux.sum(0) / (dp_size if split else 1)

        def embedding(self, tokens, table):
            # each rank looks up its own rows of the batch (sharded over the
            # data axes, whole over the vocab axis) in its vocab slice, so
            # the masked partial sums settle over the vocab axis alone
            if isinstance(tokens, DTensor):
                want = _rows(tokens) or [Replicate() for _ in names]
                if list(tokens.placements) != want:
                    tokens = tokens.redistribute(mesh, want)
            return self.constrain(torch.nn.functional.embedding(tokens, self.gather(table)))

        def nll(self, logits, targets):
            # the vocab-parallel form: a max, a sum of exponentials and the
            # gold logit, each a partial over the vocab shards
            top = logits.detach().amax(dim=-1, keepdim=True)
            lse = torch.log(torch.exp(logits - top).sum(dim=-1)) + top[..., 0]
            vocab = torch.arange(logits.shape[-1], device=targets.device)
            gold = torch.where(vocab == targets[..., None].long(), logits, 0.0).sum(dim=-1)
            return self.constrain(lse - gold)

        def ring_write(self, buf, dim, slot, values):
            if not isinstance(buf, DTensor):
                buf.index_copy_(dim, slot, values)
                return
            whole = tuple(Replicate() for _ in names) if isinstance(slot, DTensor) else None
            on_dim = [i for i, p in enumerate(buf.placements)
                      if isinstance(p, Shard) and p.dim == dim]
            if not on_dim:
                # the written dim is whole on every rank: each writes its shard
                local_map(lambda b, s, v: b.index_copy_(dim, s, v), out_placements=None,
                          in_placements=(buf.placements, whole, buf.placements),
                          device_mesh=mesh, redistribute_inputs=True)(buf, slot, values)
                return
            # the ring's slots are spread over ranks, data-major as the
            # placements shard them (DTensor's in-place index_copy_ would
            # index a shard with global slots): every rank writes the slots
            # in its range; the others are pointed at one it writes, with
            # the same value, or, when it writes none, at a slot's own value
            shard = 0
            for i in on_dim:
                shard = shard * mesh.size(i) + mesh.get_local_rank(i)
            rows = tuple(Replicate() if i in on_dim else p for i, p in enumerate(buf.placements))

            def write(b, s, v):
                n = b.shape[dim]
                at = s - shard * n
                mine = (at >= 0) & (at < n)
                first = mine.int().argmax().view(1)  # 0 when no slot is this rank's
                src = torch.where(mine, torch.arange(s.shape[0], device=s.device), first)
                at = torch.where(mine, at, at.index_select(0, first)).clamp(0, n - 1)
                b.index_copy_(dim, at, torch.where(mine.any(), v.index_select(dim, src),
                                                   b.index_select(dim, at)))

            local_map(write, out_placements=None, in_placements=(buf.placements, whole, rows),
                      device_mesh=mesh, redistribute_inputs=True)(buf, slot, values)

        def merge_heads(self, x, dim, n):
            if isinstance(x, DTensor) and x.requires_grad:
                x.register_hook(lambda g: self.split_heads(g, dim, n))
            return x

        def scope(self):
            return implicit_replication()

    return _Mesh()


# ---------------------------------------------------------------------------
# Selftest: the sharded steps against the unsharded port (every rank)
# ---------------------------------------------------------------------------

SELFTEST_ARCHS = ("smollm-135m", "mixtral-8x22b", "deepseek-v2-236b", "rwkv6-3b")
RTOL, ATOL = 1e-4, 1e-5  # fp32 compute (ROADMAP's fp32 rule)
# the train step's AdamW: the full lr on step 1, so the update (about lr x
# sign(g) + lr x wd x p) is hundreds of times the parameters' tolerance
SELFTEST_OPT = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1)


def _compare(got, want, what: str, exact: bool = False, scaled: bool = False) -> None:
    """Every leaf of ``got`` (DTensors, gathered) against ``want``;
    ``scaled``: the absolute tolerance is ATOL x the leaf's own max |want|
    (AdamW's moments, whose ``v`` is ~0.05 g^2)."""
    if isinstance(want, dict):
        for k in want:
            _compare(got[k], want[k], f"{what}.{k}", exact, scaled)
        return
    got = full_tree(got)
    if exact or not want.is_floating_point():
        ok = torch.equal(got, want)
    else:
        atol = ATOL * float(want.abs().max()) if scaled else ATOL
        ok = torch.allclose(got.float(), want.float(), rtol=RTOL, atol=atol)
    if not ok:
        diff = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else None
        raise AssertionError(f"{what}: sharded != unsharded (max |diff| {diff}, "
                             f"shapes {tuple(got.shape)} / {tuple(want.shape)})")


def hold_update(opt, before, got, want, m0, m, v, count: int, what: str) -> None:
    """The update ``got - before`` against ``want - before``, leaf by leaf
    (lists of leaves; DTensors gathered), one AdamW step of ``opt`` from
    moments ``m0`` to ``want``'s ``m`` / ``v`` at step ``count``: RTOL x
    |update| + ATOL x the leaf's max |update|, plus the gradient's
    tolerance (RTOL x |g| + ATOL x max |g|) carried through Adam's step
    by its derivative (a gradient near zero may take either sign)."""
    bc1, bc2 = 1 - opt.b1**count, 1 - opt.b2**count
    lr = opt.lr * min(1.0, count / max(opt.warmup_steps, 1))
    for i, leaves in enumerate(zip(before, got, want, m0, m, v)):
        p, g_new, w_new, m0_, m_, v_ = (full_tree(t).double() for t in leaves)
        upd, ref = g_new - p, w_new - p
        grad = (m_ - opt.b1 * m0_) / (1 - opt.b1)  # the clipped gradient
        big_m, root = m_ / bc1, torch.sqrt(v_ / bc2)
        d_root = torch.where(root > 0, (1 - opt.b2) * grad / (bc2 * root), 0.0)
        d_step = (((1 - opt.b1) / bc1 * (root + opt.eps) - big_m * d_root)
                  / (root + opt.eps) ** 2).abs()
        tol = (RTOL * ref.abs() + ATOL * ref.abs().max()
               + lr * d_step * (RTOL * grad.abs() + ATOL * grad.abs().max()))
        bad = (upd - ref).abs() > tol
        if bad.any():
            raise AssertionError(f"{what} leaf {i}: {int(bad.sum())} updates off (max |diff| "
                                 f"{float((upd - ref).abs()[bad].max())}, |update| max "
                                 f"{float(ref.abs().max())})")


def _check_local_shards(tree, shardings_tree, what: str) -> None:
    """Every DTensor's local shard has the shape its spec implies."""
    if isinstance(tree, dict):
        for k in tree:
            _check_local_shards(tree[k], shardings_tree[k], f"{what}.{k}")
        return
    want = local_shape(shardings_tree, tree.shape)
    if tuple(tree.to_local().shape) != want:
        raise AssertionError(f"{what}: local shard {tuple(tree.to_local().shape)}, "
                             f"spec {shardings_tree.spec} implies {want}")


def _check_ring_write(mesh, placement, cfg) -> None:
    """A ring whose sequence is sharded (kv heads that do not divide
    ``model``; at batch 1 over the data axes too) written through the hook
    equals ``index_copy_``: one slot, slots across two shards, and slots
    that wrap."""
    from dataclasses import replace

    from ..models import init_cache

    mqa = replace(cfg, n_kv_heads=1)
    gen = torch.Generator().manual_seed(1)
    for batch in (4, 1):
        cache = init_cache(mqa, batch, 8, device="cpu")
        key = next(iter(cache))
        shard = cache_shardings(mesh, mqa, cache)
        if shard[key]["k"].spec[2] is None:
            raise AssertionError(f"the check needs a sequence-sharded ring, got "
                                 f"{shard[key]['k']}")
        want = cache[key]["k"][0]
        ring = distribute_tree(cache[key]["k"], shard[key]["k"])
        for slot in ([5], [0], [3, 4], [6, 7, 0, 1]):
            slot = torch.tensor(slot)
            values = torch.randn(batch, len(slot), 1, want.shape[-1], generator=gen).to(want.dtype)
            want.index_copy_(1, slot, values)
            with placement.scope():
                placement.ring_write(ring[0], 1, slot, distribute_tree(
                    values, NamedSharding(batch_mesh(mesh), batch_leaf_pspec(mesh, values.shape))))
            _compare(ring[0], want, f"ring {shard[key]['k'].spec} write at slots "
                     f"{slot.tolist()}", exact=True)


def _route_log():
    """A MoE observer and its log of (experts, kept) per call, gathered."""
    log: list = []

    def observe(logits, experts, keep):
        log.append((full_tree(experts), full_tree(keep)))

    return log, observe


def _selftest_cases(archs, model: int) -> list:
    """(name, reduced config) of each arch, and mixtral with an expert
    count ``model`` does not divide (the MoE's tensor-parallel fallback)."""
    import dataclasses

    from ..configs import get_config
    from ..models import reduced_config

    cases = [(arch, reduced_config(get_config(arch))) for arch in archs]
    for arch, cfg in list(cases):
        if cfg.moe is not None and cfg.moe.n_experts % model == 0 and model > 1:
            n = cfg.moe.n_experts - 1
            while n % model == 0:
                n -= 1
            cases.append((f"{arch} with {n} experts",
                          dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=n))))
            break
    return cases


def selftest(data: int = 2, model: int = 2, *, archs=SELFTEST_ARCHS, batch: int = 8,
             seq: int = 64, decode_steps: int = 3, seed: int = 0,
             check_ring: bool = True, pod: int = 1) -> list:
    """On every rank of a ``data x model`` gloo group (``pod x data x
    model`` with a "pod" axis for ``pod > 1``, the batch then on the batch
    mesh, parameters crossing to it): one train step, a
    prefill and ``decode_steps`` decode steps of each reduced config in
    fp32 compute, sharded by the rules on a CPU mesh and unsharded on the
    rank alone, AdamW at ``SELFTEST_OPT``; loss, grad norm, logits, caches
    and MoE routes must agree (routes exactly, the rest at rtol 1e-4 /
    atol 1e-5), AdamW's moments at atol 1e-5 x each leaf's max, and each
    parameter's update by ``hold_update``.  ``batch x seq`` tokens make 2 MoE groups, one per
    data rank (the MoE's local dispatch); a decode step's one group takes
    DTensor's placement.  Every distributed tree's local shards must have
    the shapes their specs imply, and (``check_ring``, which needs a
    model axis that shards the first arch's ring sequence) a ring whose
    sequence is sharded must be written as ``index_copy_`` writes it.
    Returns the cases checked."""
    from ..configs import get_config
    from ..models import hooks, layers, reduced_config
    from ..models import init_cache, init_params
    from ..train import AdamWConfig, init_train_state, make_prefill_step, make_serve_step
    from ..train import make_train_step
    from ..train.optimizer import tree_flatten
    from .mesh import make_debug_mesh

    mesh = make_debug_mesh(data, model, device_type="cpu", pod=pod)
    placement = activation_constraint_fn(mesh)
    prev_dtype = layers.COMPUTE_DTYPE
    layers.set_compute_dtype(torch.float32)
    try:
        if model > 1 and check_ring:
            _check_ring_write(mesh, placement, reduced_config(get_config(archs[0])))
        cases = _selftest_cases(archs, model)
        adamw = AdamWConfig(**SELFTEST_OPT)
        for arch, cfg in cases:
            gen = torch.Generator().manual_seed(seed)
            params = init_params(cfg, gen, device="cpu")
            tokens = torch.randint(0, cfg.vocab - 1, (batch, seq), generator=gen)
            train_batch = {"tokens": tokens}
            if cfg.family == "encdec":
                train_batch["frames"] = torch.randn(batch, cfg.enc_seq, cfg.d_model, generator=gen)
            opt = init_train_state(cfg, params)
            runs = {}
            for sharded in (False, True):
                log, observe = _route_log()
                layers.set_moe_observer(observe)
                p, o, b = params, opt, train_batch
                ctx = hooks.activation_sharding(placement) if sharded else nullcontext()
                with ctx:
                    if sharded:
                        trees = ((params, param_shardings(mesh, params)),
                                 (opt, opt_shardings(mesh, params)),
                                 (train_batch, batch_shardings(mesh, train_batch)))
                        p, o, b = (distribute_tree(t, s) for t, s in trees)
                        for (_, s), d, what in zip(trees, (p, o, b), ("params", "opt", "batch")):
                            _check_local_shards(d, s, f"{arch} {what}")
                    new_p, new_o, metrics = make_train_step(cfg, adamw)(p, o, b)
                    if sharded:
                        p = distribute_tree(params, serve_param_shardings(mesh, params))
                    logits = make_prefill_step(cfg)(p, b)
                    cache = init_cache(cfg, batch, seq, device="cpu")
                    if sharded:
                        cache_sh = cache_shardings(mesh, cfg, cache)
                        cache = distribute_tree(cache, cache_sh)
                        _check_local_shards(cache, cache_sh, f"{arch} cache")
                    serve = make_serve_step(cfg)
                    steps = []
                    for t in range(decode_steps):
                        db = {"tokens": tokens[:, t:t + 1],
                              "positions": torch.full((batch, 1), t, dtype=torch.int32)}
                        if sharded:
                            db = distribute_tree(db, batch_shardings(mesh, db))
                        step_logits, cache = serve(p, cache, db)
                        steps.append(step_logits)
                layers.set_moe_observer(None)
                runs[sharded] = dict(params=new_p, m=new_o["m"], v=new_o["v"],
                                     loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                                     prefill=logits, cache=cache,
                                     **{f"decode{t}": x for t, x in enumerate(steps)},
                                     routes=log)
            want, got = runs[False], runs[True]
            for key in want:
                if key == "routes":
                    if len(got[key]) != len(want[key]):
                        raise AssertionError(f"{arch}: {len(got[key])} MoE calls sharded, "
                                             f"{len(want[key])} unsharded")
                    for i, (g, w) in enumerate(zip(got[key], want[key])):
                        _compare(g[0], w[0], f"{arch} route {i} experts", exact=True)
                        _compare(g[1], w[1], f"{arch} route {i} kept", exact=True)
                elif key == "params":
                    flat = [tree_flatten(t)[0] for t in (params, got[key], want[key], opt["m"],
                                                         want["m"], want["v"])]
                    hold_update(adamw, *flat, count=1, what=f"{arch} params")
                else:
                    _compare(got[key], want[key], f"{arch} {key}", scaled=key in ("m", "v"))
    finally:
        layers.set_compute_dtype(prev_dtype)
        layers.set_moe_observer(None)
    return [name for name, _ in cases]


def _selftest_rank(rank: int, world: int, init_file: str, data: int, model: int,
                   archs: tuple, check_ring: bool, pod: int) -> None:
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        archs = selftest(data, model, archs=archs, check_ring=check_ring, pod=pod)
        if rank == 0:
            shape = f"{pod}x{data}x{model}" if pod > 1 else f"{data}x{model}"
            print(f"rank 0 of {world}: {shape} gloo mesh, sharded == unsharded for "
                  f"{', '.join(archs)}", flush=True)
    finally:
        dist.destroy_process_group()


def spawn_selftest(data: int = 2, model: int = 2, archs=SELFTEST_ARCHS,
                   check_ring: bool = True, pod: int = 1) -> int:
    """``selftest`` on ``pod * data * model`` spawned CPU ranks (gloo,
    joined by a ``file://`` store).  A failing rank fails the run."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    world = pod * data * model
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_selftest_rank,
                           args=(world, os.path.join(tmp, "store"), data, model, tuple(archs),
                                 check_ring, pod),
                           nprocs=world, start_method="spawn")
    return world


def main(argv=None) -> int:
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--pod", type=int, default=1)
    args = ap.parse_args(argv)
    if not args.selftest:
        print("nothing to do (pass --selftest)")
        return 0
    t0 = time.perf_counter()
    n = spawn_selftest(args.data, args.model, pod=args.pod)
    print(f"sharded model selftest OK on {n} ranks in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    # run from the package's module, not ``__main__``: the spawned ranks
    # then share the classes the rest of the package imports
    from repro_torch.launch.shardings import main as _main

    raise SystemExit(_main())
