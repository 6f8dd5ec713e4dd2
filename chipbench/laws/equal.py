"""The capacity law ``{"kind": "equal", "capacity": c}``: every node has
capacity ``c`` (the paper's and CRUSH's evaluation clusters, whose nodes
are alike)."""

import numpy as np


def draw(law: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.full(n, float(law["capacity"]), dtype=np.float64)
