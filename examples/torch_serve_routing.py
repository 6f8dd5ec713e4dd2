"""Serving scenario on PyTorch: ASURA request routing across elastic replicas.

The same walk as ``examples/serve_routing.py`` through ``repro_torch``:
routes a stream of session ids to serving replicas with ASURA; kills a
replica and shows that only its sessions re-route (sticky sessions keep
their KV caches everywhere else); adds a warm standby, which takes
sessions only for itself; then runs real batched decode for replica 0's
share via ``repro_torch.launch.serve``.

Run:  PYTHONPATH=src python examples/torch_serve_routing.py [--device cpu]
(without ``--device`` it runs on the CUDA card and raises without one).
"""

import argparse

import numpy as np

from repro_torch.core import make_uniform_cluster
from repro_torch.launch.serve import main as serve_main


def main(device=None) -> None:
    routing = make_uniform_cluster(6, device=device)
    sessions = np.arange(10_000, dtype=np.uint32)
    before = routing.place_nodes(sessions)
    print("sessions per replica:", np.bincount(before, minlength=6))

    routing.remove_node(3)  # replica 3 dies
    after = routing.place_nodes(sessions)
    moved = before != after
    print(
        f"replica 3 died: {moved.sum()} sessions re-routed "
        f"({(before == 3).sum()} lived there; equal: {moved.sum() == (before == 3).sum()})"
    )
    assert (before[moved] == 3).all()

    routing.add_node(6, 1.0)  # warm standby joins
    after2 = routing.place_nodes(sessions)
    moved2 = after != after2
    print(f"standby joined: {moved2.sum()} sessions moved, all to the standby:"
          f" {bool((after2[moved2] == 6).all())}")

    print("\n-- decoding this replica's share with the real model --")
    serve_main(
        [
            "--arch", "smollm-135m", "--reduced",
            "--replicas", "6", "--replica-id", "0",
            "--requests", "32", "--batch", "8", "--decode-len", "4",
            *(["--device", str(device)] if device is not None else []),
        ]
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
