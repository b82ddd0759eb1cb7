"""K6 in the port: the warp-shaped data movement of the SSAM model.

The JAX package's ``core/engine_gpu.py`` emulates K1 and K5 in warp shape
(``_gpu_window_kernel``, ``_gpu_scan_kernel``); its one primitive is
:func:`warp_shift`, a lane roll decomposed the way a GPU warp carries it
out. The port's CUDA kernels do that data movement themselves
(``__shfl_up_sync`` / ``__shfl_down_sync`` in ``csrc/ssam_window.cuh``
and ``csrc/ssam_scan.cu``), so this module is their plain spec, held to
``torch.roll`` bit for bit by ``tests/test_torch_warp_shift.py``.
"""
from __future__ import annotations

import torch

from .plan import GPU_WARP_LANES


def warp_shift(v: torch.Tensor, shift: int,
               warp: int = GPU_WARP_LANES) -> torch.Tensor:
    """Shift ``v`` along the lane (last) axis the way a GPU warp would.

    ``shift = q·warp + r`` (``0 ≤ r < warp``, Python's floor divmod, so a
    negative shift is the shift_data variant's ``__shfl_down_sync``): the
    ``q``-warp part is a whole-warp hand-off (warp ``i``'s registers go to
    warp ``i+q``, on the card a shared-memory exchange); the ``r``-lane
    part is ``__shfl_up_sync(full, x, r)`` inside each warp, the ``r``
    lanes below the delta taking the previous warp's top ``r`` registers
    (the shared-memory hand-off at the boundary). The composition is
    exactly ``torch.roll(v, shift, -1)``. A lane extent that is not a
    whole number of warps takes the plain roll (same values).
    """
    if shift == 0:
        return v
    S = v.shape[-1]
    if S % warp:
        return torch.roll(v, shift, dims=-1)
    q, r = divmod(shift, warp)
    if q:
        v = torch.roll(v, q * warp, dims=-1)     # whole-warp hand-off
    if r:
        w = v.reshape(v.shape[:-1] + (S // warp, warp))
        intra = torch.roll(w, r, dims=-1)        # __shfl_up_sync(…, r)
        tail = torch.roll(torch.roll(w, 1, dims=-2), r, dims=-1)
        lane = torch.arange(warp, device=v.device)
        v = torch.where(lane < r, tail, intra).reshape(v.shape)
    return v
