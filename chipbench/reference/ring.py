"""Consistent hashing in plain torch: the benchmark's own reference ring
and replica sets.

Written from the paper's consistent-hashing setup (Ishikawa 2013, section
IV: V virtual nodes per node on a 32-bit ring, a datum's hash resolved to
the first ring point clockwise) with the same counter-based generator as
``asura.py``, and independent of the program under test:

  * the ring holds, for every node ``u`` and ``v < V``, the point
    ``draw(u, 0, v)`` owned by ``u``, sorted stably from the lower node
    id and the lower ``v`` up (equal points keep that order);
  * a lookup of the u32 value ``x`` hashes it, ``h = fmix32(x)``, and
    takes the owner of the first point ``>= h``; past the last point it
    wraps to the first;
  * an R-replica set takes the lookup of the id as its primary, then
    looks up ``draw(id, REPLICA_LEVEL, k)`` for ``k = 1 .. MAX_TRIES``
    and keeps each owner that is new to the set, until it has R
    (-1 marks a slot left unfilled).  A Dynamo-style store walks the ring
    clockwise instead; both give R distinct nodes.

u32 values travel in ``int64`` tensors.  The functions run on any device;
on the card they judge the program at the timed sizes.

``number="float32"`` is the control: the same search with the ring's
points and the hashes rounded to float32, the precision below the exact
u32 compare.  Points ~4,295 apart on a 10^6-point ring then share a float
with their neighbours, and the lookups that fall between them resolve to
another owner.

``ring_sets`` can also count the lookups it makes (``Counts``), from
which ``harness/ring_bounds.py`` counts the operations of the bound.
"""

from __future__ import annotations

import torch

from .asura import NUMBERS, draw, fmix32, widen

REPLICA_LEVEL = 0x52455031  # the re-lookups' generator level ("REP1")
MAX_TRIES = 64


class Counts(dict):
    """Work a replica fan-out needed: ``lookups`` (every ring lookup, the
    primaries included), ``relookups`` (the lookups of ``k >= 1``, each
    tested against the set) and ``seeded`` (ids that made a re-lookup:
    the generator's seed hashed once per id)."""

    def __init__(self):
        super().__init__(lookups=0, relookups=0, seeded=0)


def ring(node_ids, virtual_nodes: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(points, owners), both int64 on ``device``: ``virtual_nodes`` points
    per node, sorted stably (ties: the lower node id, then the lower
    virtual index, first)."""
    nodes = torch.as_tensor(sorted(int(u) for u in node_ids), dtype=torch.int64, device=device)
    if nodes.numel() == 0:
        raise ValueError("a ring needs at least one node")
    V = int(virtual_nodes)
    owner = nodes.repeat_interleave(V)
    virtual = torch.arange(V, dtype=torch.int64, device=device).repeat(nodes.numel())
    points, order = torch.sort(draw(owner, 0, virtual), stable=True)
    return points, owner[order]


def ring_sets(
    ids: torch.Tensor,
    points: torch.Tensor,
    owners: torch.Tensor,
    n_replicas: int,
    *,
    number: str = "exact",
    counts: Counts | None = None,
    max_tries: int = MAX_TRIES,
) -> torch.Tensor:
    """(batch, R) int64 owners, primary first, -1 where a lane found fewer
    than R distinct owners in ``max_tries`` re-lookups."""
    if number not in NUMBERS:
        raise ValueError(f"number must be one of {NUMBERS}, got {number!r}")
    ids = widen(ids)
    n, R = int(ids.shape[0]), int(n_replicas)
    n_points = int(points.shape[0])
    f32 = number == "float32"
    sorted_points = points.to(torch.float32) if f32 else points

    def lookup(x: torch.Tensor) -> torch.Tensor:
        h = fmix32(x)
        idx = torch.searchsorted(sorted_points, h.to(torch.float32) if f32 else h, side="left")
        return owners[torch.where(idx == n_points, 0, idx)]

    slots = torch.full((n, R), -1, dtype=torch.int64, device=ids.device)
    slots[:, 0] = lookup(ids)
    found = torch.ones(n, dtype=torch.int64, device=ids.device)
    short = torch.arange(n if R > 1 else 0, device=ids.device)
    relookups, seeded = 0, int(short.numel())
    for k in range(1, max_tries + 1):
        if short.numel() == 0:
            break
        cand = lookup(draw(ids[short], REPLICA_LEVEL, torch.full_like(short, k)))
        relookups += int(short.numel())
        take = ~(slots[short] == cand[:, None]).any(dim=1)
        rows = short[take]
        slots[rows, found[rows]] = cand[take]
        found[rows] += 1
        short = short[found[short] < R]
    if counts is not None:
        counts["lookups"] += n + relookups
        counts["relookups"] += relookups
        counts["seeded"] += seeded
    return slots
