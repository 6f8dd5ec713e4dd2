"""Live migration on the card: plan, throttled drain, dual-version serving.

Three layers over one membership change v -> v+1:

  1. ``MigrationPlanner``  -- streaming version-diff planner: places every
     id under both cached table versions in one launch of the two-version
     diff kernels (ADDITION-NUMBER prefilter for add-node events) and
     emits the minimal ``MigrationPlan``.
  2. ``ThrottledMover``    -- drains the plan in rounds under per-node
     ingress/egress budgets (injected clock), keeping the landed bitmap in
     ``MigrationState`` and per-round movement matrices.
  3. ``LiveMigration``     -- dual-version serving: routes every read to
     the node that holds the datum mid-drain (v owner while its move is
     pending, v+1 owner after), host and device paths, with free rollback
     of half-landed migrations.

The unit of work is a replica SLOT: plan rows are ``(id, replica_slot,
src, dst)`` and ``LiveMigration.route_replicas[_device]`` serves
mixed-version replica sets, each slot v or v+1 by its own landed bit --
the paper's minimal data movement even if data are replicated.  The
round/pump/run loop lives in ``drain.DrainDriver``.
"""

from .drain import DrainDriver
from .live import LiveMigration
from .mover import MigrationState, ThrottledMover
from .planner import DEFAULT_CHUNK, MigrationPlan, MigrationPlanner

__all__ = [
    "DEFAULT_CHUNK",
    "DrainDriver",
    "LiveMigration",
    "MigrationPlan",
    "MigrationPlanner",
    "MigrationState",
    "ThrottledMover",
]
