"""Elastic storage on PyTorch: a checkpoint that survives failures.

The scenario of ``examples/elastic_storage.py`` through ``repro_torch``:
save a model state of torch tensors with 3-way ASURA replication, kill
two nodes (crash = no drain) and restore anyway, repair one as a
throttled live replica migration (only the dead node's replica mass
re-replicates, a budgeted batch of copies per round, readable
throughout), repair the other atomically, and grow the cluster live
while reads keep restoring bit-identical state.  Placement runs on the
card by default (the replica kernel), and the state's tensors live
there too.

Run:  PYTHONPATH=src python examples/torch_elastic_storage.py [--device cpu]
"""

import argparse

import torch

from repro_torch.checkpoint import AsuraCheckpointStore, CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.obs import TraceLedger


def usage(store) -> str:
    return " ".join(f"n{n}:{node.used_bytes() // 1024}K" for n, node in sorted(store.nodes.items()))


def same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in b)


def drain(migration, clock, what: str) -> None:
    while not migration.done:
        clock["now"] += 1.0
        for matrix in migration.pump():
            flows = " ".join(f"n{s}->n{d}:{c}" for (s, d), c in sorted(matrix.items()))
            print(f"  t={clock['now']:>3.0f}s  {what} {flows}")


def main(device=None) -> None:
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    state = {name: torch.randn(2048, 2048, generator=gen).to(dev)
             for name in ("layer0.weight", "layer1.weight", "opt.m")}
    state["layer0.bias"] = torch.randn(2048, generator=gen).to(dev, torch.bfloat16)
    store = AsuraCheckpointStore({i: 1.0 for i in range(10)}, n_replicas=3, device=dev)
    ledger = TraceLedger()
    mgr = CheckpointManager(store, ledger=ledger)

    saved = {k: v.clone() for k, v in state.items()}
    mgr.save_async(100, state)  # snapshots now, writes on a thread
    for t in state.values():
        t.mul_(0.5)  # the next training step updates in place meanwhile
    mgr.wait()
    print(f"saved a 48 MiB state of tensors on {dev}, 3-way replicated")
    print("usage:", usage(store))

    store.fail_node(2)
    store.fail_node(7)
    assert same(mgr.restore(100, state), saved)
    print("restored bit-identical with nodes 2 and 7 DOWN")

    clock = {"now": 0.0}
    repair = store.begin_remove_node(2, ingress=6, clock=lambda: clock["now"], ledger=ledger)
    print(f"repairing node 2 live: {repair.live.state.plan.n_moves} replica copies, "
          "ingress 6 per round")
    drain(repair, clock, "repair moved")
    assert same(mgr.restore(100, state), saved)
    print(f"node 2 repaired: {repair.copies_moved} copies (its replica mass)")
    print(f"repaired node 7 atomically: {store.remove_node_and_repair(7)} copies")

    clock["now"] = 0.0
    grow = store.begin_add_node(20, 2.0, ingress=8, clock=lambda: clock["now"], ledger=ledger)
    print(f"added node 20 (capacity 2.0) live: {grow.live.state.plan.n_moves} copies to move")
    drain(grow, clock, "moved")
    assert same(mgr.restore(100, state), saved)
    print("usage:", usage(store))
    rounds = ledger.events(kind="migrate.round")
    print(f"restore still bit-identical; telemetry: {len(rounds)} migration rounds, "
          f"{sum(e.get('bytes', 0) for e in rounds) // (1 << 20)} MiB moved")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
