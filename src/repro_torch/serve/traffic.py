"""Device-resident request-stream generator (DESIGN.md section 12).

The port of the reference's ``TrafficModel``: a traffic law (uniform,
Zipf, hot-set over ``n_keys`` ranked keys) becomes exact u32 CDF
thresholds on the host, and the device sampler draws per-request words
with a counter-based generator, maps them to ranks with one integer
``searchsorted`` and ranks to datum ids through the ``fmix32``
bijection.

The per-request words must be the reference's words, or the two request
streams diverge.  The reference takes them from jax's threefry2x32 in its
default (partitionable) mode: the batch key is ``fold_in(root_key,
step)``, each lane folds in its GLOBAL lane index, and ``bits(key, (2,),
uint32)`` gives word ``j`` as ``x0 ^ x1`` of ``threefry2x32(key, (0, j))``.
``threefry2x32`` below is that function (20 rounds, key schedule with
0x1BD11BDA) written once for Python ints and int64 tensors alike: the
host computes the batch key, the device computes one fold-in and two
words per lane: on the card in one launch of a hand-written kernel
(``kernels/csrc/traffic.cu``), on the CPU in its plain-torch twin
``lane_words_twin``.  Lanes are u32 values in int64, so lanes >= 2**31
need no special case.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rng import fmix32_np
from ..kernels.ref import fmix32
from ..kernels.traffic import lane_words_cuda
from ..kernels.u32 import M32, add32

LAWS = ("uniform", "zipf", "hotset")

_TWO32 = float(2**32)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl32(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) -> (y0, y1); ints or int64 tensors of u32
    values, broadcasting like the arithmetic they feed."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = add32(x0, ks[0])
    x1 = add32(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add32(x0, x1)
            x1 = _rotl32(x1, r) ^ x0
        x0 = add32(x0, ks[(i + 1) % 3])
        x1 = add32(x1, add32(ks[(i + 2) % 3], i + 1))
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """The raw threefry key of ``jax.random.PRNGKey(seed)`` (32-bit seeds)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return 0, seed & M32


def fold_in(key, data):
    """``jax.random.fold_in``: threefry of the key over ``(0, data)``."""
    return threefry2x32(key[0], key[1], 0, data & M32)


def lane_words_twin(batch_key, lanes: torch.Tensor, n_words: int) -> torch.Tensor:
    """The plain-torch twin of ``lane_words_cuda``: (len(lanes), n_words)
    int64 u32 words ``bits(fold_in(batch_key, lane), (n_words,))``, on the
    lanes' device."""
    k0, k1 = fold_in(batch_key, lanes & M32)
    words = []
    for j in range(n_words):
        y0, y1 = threefry2x32(k0, k1, 0, j)
        words.append(y0 ^ y1)
    return torch.stack(words, dim=1)


class TrafficModel:
    """One traffic law over ``n_keys`` ranked keys, ready for device use."""

    def __init__(
        self,
        n_keys: int,
        *,
        law: str = "zipf",
        alpha: float = 1.1,
        hot_fraction: float = 0.9,
        hot_keys: int = 64,
        seed: int = 0,
    ):
        if law not in LAWS:
            raise ValueError(f"law must be one of {LAWS}, got {law!r}")
        if n_keys < 1:
            raise ValueError("n_keys must be >= 1")
        self.n_keys = int(n_keys)
        self.law = law
        self.alpha = float(alpha)
        self.hot_fraction = float(hot_fraction)
        self.hot_keys = min(int(hot_keys), self.n_keys)
        # rank -> id bijection salt, derived from the seed
        self.id_salt = int(
            fmix32_np(np.asarray([seed ^ 0x7261666B], dtype=np.uint32))[0]
        )
        self._pmf = self._build_pmf()
        cum = np.cumsum(self._pmf)
        cum[-1] = 1.0  # kill float64 cumsum drift before quantizing
        thr = np.round(cum * _TWO32).astype(np.uint64) - 1
        self._thresholds = np.minimum(thr, np.uint64(2**32 - 1)).astype(np.uint32)
        self._on_device: dict = {}

    def _build_pmf(self) -> np.ndarray:
        n = self.n_keys
        if self.law == "uniform":
            p = np.full(n, 1.0 / n, dtype=np.float64)
        elif self.law == "zipf":
            p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), self.alpha)
            p /= p.sum()
        else:  # hotset
            k, h = self.hot_keys, self.hot_fraction
            p = np.full(n, (1.0 - h) / n, dtype=np.float64)
            p[:k] += h / k
            p /= p.sum()
        return p

    @property
    def pmf(self) -> np.ndarray:
        """Target probability per rank (float64, sums to 1)."""
        return self._pmf

    @property
    def thresholds(self) -> np.ndarray:
        """Inclusive u32 upper bounds per rank: ``searchsorted(thresholds,
        u, 'left')`` maps a raw u32 draw to its rank."""
        return self._thresholds

    def thresholds_on(self, device) -> torch.Tensor:
        """``thresholds`` as int64 on ``device`` (uploaded once per device)."""
        dev = torch.device(device)
        t = self._on_device.get(dev)
        if t is None:
            t = self._on_device[dev] = torch.from_numpy(
                self._thresholds.astype(np.int64)
            ).to(dev)
        return t

    # -- device sampler --------------------------------------------------------

    @staticmethod
    def lane_words(root_key, step_idx: int, lanes: torch.Tensor, n_words: int = 2):
        """(len(lanes), n_words) int64 u32 words for GLOBAL lane indices:
        ``bits(fold_in(fold_in(root_key, step), lane), (n_words,))``.

        CUDA lanes go to the hand-written kernel (``lane_words_cuda``, one
        launch, ``n_words`` 1 or 2) or raise; CPU lanes to its twin
        ``lane_words_twin``."""
        batch_key = fold_in(root_key, int(step_idx))
        if lanes.device.type == "cuda":
            return lane_words_cuda(batch_key, lanes, n_words)
        if lanes.device.type != "cpu":
            raise ValueError(f"lane_words runs on cuda or cpu, not {lanes.device}")
        return lane_words_twin(batch_key, lanes, n_words)

    @staticmethod
    def ranks_from_words(words: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        """u32 draws -> ranks via the exact-u32 CDF (one searchsorted)."""
        ranks = torch.searchsorted(thresholds, words.contiguous(), right=False)
        return ranks.clamp(max=thresholds.shape[0] - 1)

    @staticmethod
    def ids_from_ranks(ranks: torch.Tensor, id_salt: int) -> torch.Tensor:
        """Bijective rank -> datum-id map (fmix32 of the salted rank)."""
        return fmix32(add32(ranks, id_salt))

    @staticmethod
    def draw(root_key, step_idx: int, lanes, thresholds, id_salt: int):
        """One generator step -> (datum_ids, selection_words), int64 u32.

        Word 0 of each lane samples the rank (then id); word 1 goes to the
        replica-selection policy untouched."""
        words = TrafficModel.lane_words(root_key, step_idx, lanes, 2)
        ranks = TrafficModel.ranks_from_words(words[:, 0], thresholds)
        return TrafficModel.ids_from_ranks(ranks, id_salt), words[:, 1]

    # -- host-facing helpers ----------------------------------------------------

    def rank_to_id_np(self, ranks) -> np.ndarray:
        """NumPy twin of ``ids_from_ranks`` (bit-identical)."""
        r = np.asarray(ranks, dtype=np.uint32)
        with np.errstate(over="ignore"):
            return fmix32_np(r + np.uint32(self.id_salt))

    def sample_ranks(
        self, seed: int, n: int, batch: int = 1 << 14, *, device=None
    ) -> np.ndarray:
        """Draw ``n`` ranks at a fixed seed (the per-lane stream the driver
        consumes), as a NumPy array."""
        from ..device import resolve_device

        dev = resolve_device(device)
        key = prng_key(seed)
        thr = self.thresholds_on(dev)
        out = []
        step = 0
        remaining = n
        while remaining > 0:
            take = min(batch, remaining)
            lanes = torch.arange(take, dtype=torch.int64, device=dev)
            words = self.lane_words(key, step, lanes, 1)
            out.append(self.ranks_from_words(words[:, 0], thr).cpu().numpy())
            step += 1
            remaining -= take
        return np.concatenate(out)
