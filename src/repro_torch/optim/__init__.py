from .adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    opt_state_logical,
)

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
    "global_norm", "opt_state_logical",
]
