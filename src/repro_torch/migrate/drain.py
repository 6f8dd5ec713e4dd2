"""The shared drain-driver loop (the port's own copy of the reference's).

Every layer that advances a migration exposes the same three verbs --
``round()`` (one primitive round -> its movement matrix), ``pump()`` (the
rounds an injected clock says are due) and ``run(max_rounds)`` (drain to
completion, raising if the budget can never finish).  ``DrainDriver``
hosts that loop once for ``ThrottledMover`` and ``LiveMigration``.

Subclasses implement:

  * ``done``            -- is the drain complete?
  * ``_round()``        -- one primitive round -> its (src, dst) matrix,
  * ``_pump_rounds()``  -- the clock-paced batch of rounds (the default is
                          clockless: one round when not done; the mover
                          overrides it with the injected-clock pacing, and
                          wrappers delegate to the wrapped object so clock
                          accounting lives in exactly one place),
  * ``_advance(fn)``    -- optional wrapper applied uniformly around every
                          public verb (liveness guards) so a hook can never
                          be skipped by calling one verb instead of another.

A driver that carries a ``ledger`` attribute (an ``obs.TraceLedger``) gets
one structured ``migrate.round`` event per completed round -- round
index, per-(src, dst) pair count, rows moved, and bytes when a
``bytes_per_row`` attribute is set -- emitted from the public verbs only,
so wrappers that delegate ``_pump_rounds`` to an inner driver never
double-count.  The events annotate; the returned round dicts are the
same with or without a ledger.
"""

from __future__ import annotations


class DrainDriver:
    """Mixin: the round()/pump()/run() drain loop over one primitive."""

    @property
    def done(self) -> bool:
        raise NotImplementedError

    def _round(self) -> dict:
        raise NotImplementedError

    def _advance(self, fn):
        return fn()

    def _pump_rounds(self) -> list:
        return [] if self.done else [self._round()]

    def _pending_desc(self) -> str:
        return "work still pending"

    def _emit_rounds(self, matrices: list) -> list:
        """Ledger/metrics hook: one ``migrate.round`` event per matrix."""
        ledger = getattr(self, "ledger", None)
        if ledger is None or not matrices:
            return matrices
        bytes_per_row = int(getattr(self, "bytes_per_row", 0) or 0)
        metrics = getattr(self, "metrics", None)
        for matrix in matrices:
            moves = sum(matrix.values())
            fields = {
                "round": ledger.incr("migrate.rounds"),
                "moves": moves,
                "pairs": len(matrix),
            }
            ledger.incr("migrate.rows_moved", moves)
            if bytes_per_row:
                fields["bytes"] = moves * bytes_per_row
                ledger.incr("migrate.bytes_moved", moves * bytes_per_row)
                if metrics is not None:
                    metrics.inc_host(
                        "migrate.bytes_moved", moves * bytes_per_row
                    )
            ledger.event("migrate.round", type(self).__name__, **fields)
        return matrices

    def round(self) -> dict:
        """One round; returns its per-(src, dst) movement matrix."""
        [matrix] = self._emit_rounds(self._advance(lambda: [self._round()]))
        return matrix

    def pump(self) -> list:
        """Run the rounds the injected clock says are due (0 if none)."""
        return self._emit_rounds(self._advance(self._pump_rounds))

    def run(self, max_rounds: int = 100_000) -> list:
        """Drain to completion; returns the per-round matrices."""

        def drain():
            out = []
            for _ in range(max_rounds):
                if self.done:
                    break
                out.append(self._round())
            if not self.done:
                raise RuntimeError(
                    f"drain did not complete within {max_rounds} rounds "
                    f"({self._pending_desc()}) -- zero budget?"
                )
            return out

        return self._emit_rounds(self._advance(drain))
