from repro_torch.checkpoint.checkpointer import Checkpointer, CheckpointWriteError

__all__ = ["Checkpointer", "CheckpointWriteError"]
