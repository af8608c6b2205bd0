from .checkpoint import (latest_step, restore_checkpoint, save_checkpoint,
                         AsyncCheckpointer)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint",
           "AsyncCheckpointer"]
