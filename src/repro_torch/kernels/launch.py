"""The launch plan of the staged CH / RS searches, as pure functions of sizes.

B5, B6 and the baselines' fan-out (``csrc/baselines.cu``) stage a sampled
index of the sorted table in shared memory -- every S-th key, S the least
power of two whose index fits ``INDEX_BUDGET`` bytes (S = 1 stages the
whole table) -- once per block, and walk the ids grid-stride from a
persistent grid; each lookup then counts the keys of one S-key bucket in
global memory.  The CUDA launcher computes this plan itself, from the
sizes it is given (no host read of device data, no caller's choice); the
functions here restate it so that it can be tested without a card, and
``baselines.launch_plan`` reads the launcher's own plan back on a card to
hold the two to each other.
"""

from __future__ import annotations

# csrc/baselines.cu
SEARCH_THREADS = 512  # block of the persistent CH / RS kernels
THREADS = 256  # the WRH launches: one thread per id
INDEX_BUDGET = 112 * 1024  # shared bytes of one block's sampled index
KEY_BYTES = 4

PLAN_FIELDS = ("shift", "smem", "block", "blocks_per_sm", "sms", "grid")


def blocks_for(n: int, block: int) -> int:
    """Blocks of ``block`` threads that give every id a thread."""
    return -(-n // block)


def persistent_grid(n: int, block: int, sm_count: int, blocks_per_sm: int) -> int:
    """The persistent grid: as many blocks as the card holds at once
    (SMs x resident blocks per SM), or fewer when ``n`` needs fewer."""
    if sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"need >= 1 SM and >= 1 block per SM, got {sm_count}, {blocks_per_sm}")
    return min(blocks_for(n, block), sm_count * blocks_per_sm)


def index_shift(n_keys: int, budget: int = INDEX_BUDGET) -> int:
    """log2 of the index stride S: the least power of two with
    ceil(n_keys / S) keys in ``budget`` bytes."""
    if n_keys < 1:
        raise ValueError(f"a search table holds >= 1 key, got {n_keys}")
    shift = 0
    while blocks_for(n_keys, 1 << shift) * KEY_BYTES > budget:
        shift += 1
    return shift


def index_entries(n_keys: int) -> int:
    """Keys in the sampled index: ceil(n_keys / S)."""
    return blocks_for(n_keys, 1 << index_shift(n_keys))


def index_bytes(n_keys: int) -> int:
    """Dynamic shared memory of one block of the CH / RS kernels."""
    return KEY_BYTES * index_entries(n_keys)


def baseline_plan(algorithm: str, n: int, n_keys: int, sm_count: int, blocks_per_sm: int) -> dict:
    """The plan of B5 / B6 / the fan-out on ``n`` ids: the index shift
    (log2 S), its shared bytes, the block, resident blocks per SM, SMs and
    the grid; wrh stages nothing and runs one thread per id."""
    if algorithm == "wrh":
        return dict(zip(PLAN_FIELDS, (0, 0, THREADS, blocks_per_sm, sm_count,
                                      blocks_for(n, THREADS))))
    return dict(zip(PLAN_FIELDS, (
        index_shift(n_keys), index_bytes(n_keys), SEARCH_THREADS, blocks_per_sm, sm_count,
        persistent_grid(n, SEARCH_THREADS, sm_count, blocks_per_sm))))

