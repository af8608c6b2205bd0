from .adamw import adamw_init, adamw_update, clip_by_global_norm, \
    global_norm_sq
from .schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "global_norm_sq"]
