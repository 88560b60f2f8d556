"""Checkpointing and recovery: step-aligned snapshots, storage, restart
strategies (counterpart of `flink_tpu/checkpoint/`)."""

from flink_tpu_torch.checkpoint.storage import (
    CheckpointStorage,
    CorruptCheckpointError,
    FsCheckpointStorage,
    MemoryCheckpointStorage,
)
from flink_tpu_torch.checkpoint.coordinator import (
    CheckpointCoordinator,
    CheckpointFailuresExhaustedError,
)
from flink_tpu_torch.checkpoint.restart import restart_strategy_from_config
