from .sharded import AsuraCheckpointStore, CheckpointManager, StoreMigration

__all__ = ["AsuraCheckpointStore", "CheckpointManager", "StoreMigration"]
