"""Device-plane metrics: one u32 slab the serving step accumulates into.

The port of the reference's ``MetricsRegistry``.  The registry owns one
contiguous device tensor (the "slab"); counters and histograms are
append-only layout entries -- a name maps to a fixed ``(offset, size)``
window -- so the helpers (``add`` / ``add_hist``) are plain slice updates
with static offsets and cost no host sync.  The slab keeps u32 semantics
(every add is mod 2**32, matching the reference's uint32 slab bit for
bit); it is stored as ``int64`` under the rule of ``kernels/u32.py``.

Metrics drain through ONE explicit ``snapshot()`` transfer, which zeroes
the device slab and accumulates into host ``uint64`` totals.  A disabled
registry (``enabled=False``) makes every helper a no-op.  Host-plane
counters (planner prefilter counts, migration bytes) go through
``inc_host`` and drain through the same ``snapshot()`` dict.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.u32 import M32, as_u32


class MetricsRegistry:
    """Append-only u32 device slab of named counters and histograms.

    ``device`` is where the slab lives (None: the card)."""

    def __init__(self, *, enabled: bool = True, device=None):
        self.enabled = bool(enabled)
        self._device = device
        self._layout: dict[str, tuple[int, int]] = {}  # name -> (offset, size)
        self._size = 0
        self._slab: torch.Tensor | None = None
        self._totals: dict[str, np.ndarray] = {}  # drained device totals (u64)
        self._host: dict[str, int] = {}  # host-plane counters (inc_host)

    # -- layout (host side, registration time) -------------------------------

    def _ensure(self, name: str, size: int) -> str:
        if not self.enabled:
            return name
        prev = self._layout.get(name)
        if prev is not None:
            if prev[1] != size:
                raise ValueError(
                    f"metric {name!r} already registered with size {prev[1]}, "
                    f"got {size}"
                )
            return name
        if size < 1:
            raise ValueError(f"metric {name!r} needs size >= 1, got {size}")
        self._layout[name] = (self._size, int(size))
        self._size += int(size)
        return name

    def counter(self, name: str) -> str:
        """Register (idempotently) a scalar counter; returns ``name``."""
        return self._ensure(name, 1)

    def histogram(self, name: str, n_bins: int) -> str:
        """Register (idempotently) an ``n_bins``-wide histogram."""
        return self._ensure(name, n_bins)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._layout)

    @property
    def size(self) -> int:
        return self._size

    # -- the device slab ------------------------------------------------------

    def slab(self) -> torch.Tensor:
        """The current device slab, grown (zero-padded) to the layout;
        offsets are append-only, so growing keeps every live window."""
        if self._slab is None or int(self._slab.shape[0]) != self._size:
            old = self._slab
            dev = old.device if old is not None else resolve_device(self._device)
            self._slab = torch.zeros(self._size, dtype=torch.int64, device=dev)
            if old is not None and old.shape[0]:
                self._slab[: old.shape[0]] = old
        return self._slab

    def set_slab(self, slab: torch.Tensor) -> None:
        """Store an updated slab (the helpers below update in place and
        need no call; a caller that built a new slab tensor stores it)."""
        self._slab = slab

    # -- accumulation helpers (static offsets, no host sync) ------------------

    def add(self, slab: torch.Tensor, name: str, value=1) -> torch.Tensor:
        """``slab[name] += value`` mod 2**32, in place (value: int or 0-d
        tensor); returns ``slab``."""
        if not self.enabled:
            return slab
        off, _ = self._layout[name]
        if isinstance(value, torch.Tensor):
            value = as_u32(value.reshape(1))
        else:
            value = int(value) & M32
        slab[off : off + 1] = (slab[off : off + 1] + value) & M32
        return slab

    def add_hist(self, slab: torch.Tensor, name: str, values: torch.Tensor) -> torch.Tensor:
        """Add a whole per-bin vector into histogram ``name`` (mod 2**32, in
        place); returns ``slab``."""
        if not self.enabled:
            return slab
        off, size = self._layout[name]
        n = int(values.shape[0])
        if n > size:
            raise ValueError(f"histogram {name!r} holds {size} bins, got {n}")
        slab[off : off + n] = (slab[off : off + n] + as_u32(values)) & M32
        return slab

    def bucket_add(self, slab: torch.Tensor, name: str, idx, weight=1) -> torch.Tensor:
        """Scatter-add ``weight`` into histogram ``name`` at the (clipped)
        bucket ``idx`` (mod 2**32, in place); returns ``slab``."""
        if not self.enabled:
            return slab
        off, size = self._layout[name]
        i = torch.as_tensor(idx, device=slab.device).to(torch.int64).reshape(-1)
        i = i.clamp(0, size - 1) + off
        w = torch.as_tensor(weight, device=slab.device)
        w = as_u32(w.reshape(-1)).expand(i.shape)
        slab.index_add_(0, i, w)
        slab[off : off + size] &= M32
        return slab

    # -- host plane ------------------------------------------------------------

    def inc_host(self, name: str, n=1) -> int:
        """Host-side counter (control-path metrics: planner prefilter
        counts, migration bytes) -- drains through the same snapshot."""
        self._host[name] = c = self._host.get(name, 0) + int(n)
        return c

    # -- drain ----------------------------------------------------------------

    def _drain(self) -> None:
        if not (self.enabled and self._slab is not None and self._size):
            return
        drained = np.zeros(self._size, np.uint64)
        live = self._slab.cpu().numpy().astype(np.uint64)  # the ONE transfer
        drained[: live.shape[0]] = live
        self._slab = torch.zeros(self._size, dtype=torch.int64, device=self._slab.device)
        for name, (off, size) in self._layout.items():
            tot = self._totals.get(name)
            if tot is None:
                tot = self._totals[name] = np.zeros(size, np.uint64)
            tot += drained[off : off + size]

    def totals(self) -> dict:
        """Accumulated totals WITHOUT touching the device (what the last
        snapshot drained, plus the host-plane counters)."""
        out: dict = {}
        for name, (_, size) in self._layout.items():
            tot = self._totals.get(name)
            if tot is None:
                tot = np.zeros(size, np.uint64)
            out[name] = int(tot[0]) if size == 1 else tot.copy()
        for name, v in self._host.items():
            out[name] = int(v)
        return out

    def snapshot(self) -> dict:
        """Drain the device slab (one device->host copy; the slab resets to
        zero) and return the cumulative ``{name: int | uint64 array}``."""
        self._drain()
        return self.totals()
