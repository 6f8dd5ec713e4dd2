"""Quickstart on PyTorch: ASURA through the port, on the card by default.

The same walk as ``examples/quickstart.py`` through ``repro_torch``:
  1. build a capacity-weighted cluster (STEP 1),
  2. place data (STEP 2) -- the host oracle and the engine's kernel path,
  3. add a node and observe optimal data movement (the migration planner),
  4. replicate placements and read the section-2.D metadata,
  5. route through the paper's baselines behind the same engine.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(without ``--device`` it runs on the CUDA card and raises without one).
"""

import argparse

import numpy as np

from repro_torch.core import Cluster, addition_number, make_cluster, remove_numbers
from repro_torch.migrate import MigrationPlanner
from repro_torch.serve import Router


def main(device=None) -> None:
    # --- STEP 1: nodes -> segments, proportional to capacity (Fig. 3) -----
    cluster = make_cluster([1.5, 0.7, 1.0], device=device)  # TB per node, say
    print(f"engine on {cluster.engine.device}; segment table:")
    for nid, info in cluster.nodes.items():
        segs = [(s, round(float(cluster.seg_lengths()[s]), 3)) for s in info.segments]
        print(f"  node {nid} (cap {info.capacity}): segments {segs}")

    # --- STEP 2: datum id -> node -----------------------------------------
    ids = np.arange(100_000, dtype=np.uint32)
    owners = cluster.place_nodes(ids)  # one launch of the fused kernel
    frac = np.bincount(owners, minlength=3) / ids.size
    print(f"distribution: {frac.round(4)} (capacity fractions "
          f"{(np.array([1.5, 0.7, 1.0]) / 3.2).round(4)})")
    assert all(cluster.place_node(int(i)) == owners[i] for i in range(0, 100_000, 9973))
    print("the kernel path matches the scalar oracle")

    # --- optimal movement on node addition --------------------------------
    v0 = cluster.version
    cluster.engine.artifact()  # keep the v table for the two-version diff
    cluster.add_node(3, 1.0)
    plan = MigrationPlanner(cluster.engine).plan(ids, v0, cluster.version)
    print(f"added node 3: {100 * plan.moved_fraction:.2f}% of data moved "
          f"(ideal {100 * 1.0 / 4.2:.2f}%), all to node 3: {bool((plan.dst == 3).all())}")

    # --- replication + section 2.D metadata --------------------------------
    print(f"3-way replicas for the first 5 ids:\n{cluster.place_replicas(ids[:5], 3)}")
    lengths, node_of = cluster.seg_lengths(), cluster.seg_to_node()
    print(f"datum 0: ADDITION NUMBER {addition_number(0, lengths, node_of)}, "
          f"REMOVE NUMBERS {remove_numbers(0, lengths, node_of, 3)}")

    # --- the shared state is just a small table ----------------------------
    blob = cluster.to_json()
    clone = Cluster.from_json(blob, device=device)
    assert np.array_equal(clone.place_nodes(ids[:1000]), cluster.place_nodes(ids[:1000]))
    print(f"the table serializes to {len(blob)} bytes and places identically "
          "when loaded elsewhere")

    # --- the same interface serves the paper's baselines --------------------
    caps = {0: 1.5, 1: 0.7, 2: 1.0}
    for algorithm in ("asura", "ch", "wrh", "rs"):
        router = Router(caps, algorithm=algorithm, device=device)
        share = np.bincount(router.route(ids[:20_000]), minlength=3) / 20_000
        print(f"  {algorithm:>5} routing shares: {share.round(3)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
