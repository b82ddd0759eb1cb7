"""Model factory: ArchConfig → model instance by family."""
from __future__ import annotations

from .base import ArchConfig


def build_model(cfg: ArchConfig, params=None, *, device=None, seed: int = 0):
    """The port's model for ``cfg``. ``params`` (a parameter tree, e.g.
    from :func:`repro_torch.convert.params_from_reference`) or, without
    it, weights drawn from ``seed`` on ``device`` (default ``cuda``)."""
    if cfg.family == "ssm":
        from .rwkv6 import RWKV6

        return RWKV6(cfg, params, device=device, seed=seed)
    if cfg.family == "hybrid":
        from .hymba import Hymba

        return Hymba(cfg, params, device=device, seed=seed)
    if cfg.family == "audio":
        from .whisper import Whisper

        return Whisper(cfg, params, device=device, seed=seed)
    raise NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) is not ported yet "
        "(ROADMAP Queue 1 item 9)")
