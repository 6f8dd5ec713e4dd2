"""The answers the benchmark's cells hold the program to, in plain torch.

  * ``flat_sets``: a flat cluster's R-replica node sets;
  * ``rack_sets``: a rack-aware cluster's R-replica (rack, node) sets --
    R distinct racks drawn over the table of racks, then in each chosen
    rack one total placement over its nodes of the id salted with the
    rack (``fmix32(id ^ rack * GOLDEN)``), so that the racks' choices are
    independent;
  * ``align``: the minimal per-slot alignment of a replica set before
    and after a membership change (a slot moves exactly when its owner
    is not in the old set; the k-th new owner takes the k-th vacated
    one's bytes);
  * ``serve_batch``: one batch of the serving driver's rule -- the
    power-of-two choice between two distinct replicas by the load
    counted before the batch, then the counts and queues after it.

Each takes the tables as ``TableModel`` / ``HierarchyModel`` hand them
out; none reads anything the program made.
"""

from __future__ import annotations

import math

import torch

from .asura import GOLDEN, M32, Counts, StackedTables, Table, fmix32, mul32, place_in_rows, place_replicas, widen
from .tables import HierarchyModel, TableModel
from .threefry import lane_words

BIG = 2**31 - 1  # an unfilled slot's load: it always loses


def flat_table(model, device) -> Table:
    """A ``TableModel``'s current table, or a version's ``(len32, owner,
    top)`` as its ``arrays()`` gave them, on ``device``."""
    len32, owner, top = model if isinstance(model, tuple) else model.arrays()
    return Table(len32.astype("int64"), owner, top, device)


def flat_sets(ids, model: TableModel, R: int, *, device, number="exact", counts=None, **kw):
    """(n, R) int64 node sets under ``model``'s current table."""
    return place_replicas(ids, flat_table(model, device), R, number=number, counts=counts, **kw)


def rack_sets(ids, model: HierarchyModel, R: int, *, device, number="exact",
              counts: tuple[Counts, Counts] | None = None, **kw):
    """(2, R, n) int64: plane 0 the racks, plane 1 the nodes, -1 where the
    distinct-rack draw left a slot unfilled.  ``counts`` is the pair
    (rack level, node level)."""
    ids = widen(ids)
    racks = model.rack_ids()
    rack_table = flat_table(model.racks, device)
    node_tables = StackedTables([flat_table(model.nodes[r], device) for r in racks], device)
    row_of = torch.full((max(racks) + 1,), -1, dtype=torch.int64)
    row_of[torch.tensor(racks)] = torch.arange(len(racks))
    row_of = row_of.to(device)
    c1, c2 = counts if counts is not None else (None, None)
    chosen = place_replicas(ids, rack_table, R, number=number, counts=c1, **kw)
    n = int(ids.shape[0])
    out = torch.full((2, R, n), -1, dtype=torch.int64, device=ids.device)
    for r in range(R):
        lanes = torch.nonzero(chosen[:, r] >= 0).flatten()
        rack = chosen[lanes, r]
        salted = fmix32(ids[lanes] ^ mul32(rack & M32, GOLDEN))
        out[0, r, lanes] = rack
        out[1, r, lanes] = place_in_rows(salted, row_of[rack], node_tables, number=number,
                                         counts=c2, **kw)
    return out


def align(before: torch.Tensor, after: torch.Tensor):
    """(moved, src, dst, src_slot) of two (n, R) owner sets."""
    R = after.shape[1]
    new = ~(after[:, :, None] == before[:, None, :]).any(dim=2)
    lost = ~(before[:, :, None] == after[:, None, :]).any(dim=2)
    rank_new = torch.cumsum(new.to(torch.int64), 1) - new.to(torch.int64)
    rank_lost = torch.cumsum(lost.to(torch.int64), 1) - lost.to(torch.int64)
    match = lost[:, None, :] & (rank_lost[:, None, :] == rank_new[:, :, None])
    src = torch.where(match, before[:, None, :], 0).sum(dim=2)
    slots = torch.arange(R, device=after.device)
    src_slot = torch.where(match, slots[None, None, :], 0).sum(dim=2)
    return new, torch.where(new, src, after), after, torch.where(new, src_slot, slots[None, :])


def service_rate(batch: int, n_nodes: int) -> int:
    """Requests a node serves per batch: 25% over the mean arrival."""
    return max(1, math.ceil(1.25 * batch / max(1, n_nodes)))


def serve_batch(owners, key: tuple[int, int], step: int, counts, queue, service: int):
    """The serving rule on one batch -> ``(chosen, counts_after,
    queue_after)``.

    ``owners`` (n, R) int64 are the requests' replica sets; the selection
    word of lane i is word 0 of the stream ``key`` at ``step``, lane i.
    Two distinct slots are drawn from it (``i = w % R``, ``j = (i + 1 +
    (w >> 16) % (R - 1)) % R``) and the one with the smaller count before
    the batch wins (ties and unfilled slots to the first)."""
    n, R = owners.shape
    lanes = torch.arange(n, dtype=torch.int64, device=owners.device)
    w = lane_words(key, step, lanes, 1)[:, 0]
    prim = owners[:, 0].clamp(min=0)
    counts = counts.to(torch.int64)
    if R == 1:
        chosen = prim
    else:
        i = w % R
        j = (i + 1 + (w >> 16) % (R - 1)) % R
        a = owners.gather(1, i[:, None])[:, 0]
        b = owners.gather(1, j[:, None])[:, 0]
        la = torch.where(a >= 0, counts[a.clamp(min=0)], BIG)
        lb = torch.where(b >= 0, counts[b.clamp(min=0)], BIG)
        chosen = torch.where(lb < la, b, a)
        chosen = torch.where(chosen >= 0, chosen, prim)
    hist = torch.bincount(chosen, minlength=counts.shape[0])
    after = counts + hist
    queue = torch.clamp(queue.to(torch.int64) + hist - service, min=0)
    return chosen, after, queue
