"""Optimizers of the port."""
from .adamw import adamw_state, adamw_update, cosine_schedule, global_norm

__all__ = ["adamw_state", "adamw_update", "cosine_schedule", "global_norm"]
