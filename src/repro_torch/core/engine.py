"""The plan engine: windowed plans (K1) and scan plans (K5), each a CUDA
kernel beside its plain version.

:func:`run_window_plan` runs a windowed :class:`SystolicPlan` (2-D and
3-D stencils, dense 2-D convolution, with leading batch axes) over an
input whose lane axis is last. The tensor's device decides how:

* a CUDA tensor launches K1, the hand-written kernel in
  ``csrc/ssam_window.cu`` (it replaces the JAX package's
  ``core/engine.py::_window_kernel``); a failure raises, it never
  falls back;
* a CPU tensor runs :func:`run_window_plan_reference`, the plain torch
  version: the reference's ``_apply_plan_once`` block walk, both
  variants, over overlapped blocks padded per :func:`origin_pads`.

The geometry is the reference ``_window_call``'s: output shape
``in + t·(lead+trail) − t·(ext−1)`` per axis, blocks of the output tiled
disjointly, each read from a ``t``-widened overlapped input block.
Plans outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

:func:`run_scan_plan` runs a scan plan (``combine='add'``: prefix sum;
``'linrec'``: ``h_t = a_t·h_{t−1} + b_t``) over ``(R, T)`` rows, with an
optional carry in and out: a CUDA tensor launches K5
(``csrc/ssam_scan.cu``, replacing ``_scan_kernel``), a CPU tensor runs
:func:`run_scan_plan_reference`. :func:`run_scan_plan_chunked` streams
``(R, chunk)`` slabs through it, threading the carry.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from .. import _build
from .halo import origin_pads
from .plan import SystolicPlan

VARIANTS = ("shift_psum", "shift_data")
WARP = 32
SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
TABLE_SLOTS = 1024           # the kernel's tap-table limit (steps · D · N)


def check_supported(plan: SystolicPlan, time_steps: int, variant: str) -> None:
    """Raise for what this slice of the port does not run yet."""
    todo = []
    if plan.reduce_axes or plan.out_axes:
        todo.append("reduce/out axes (ROADMAP Queue 1 item 4)")
    if plan.stride is not None and any(v > 1 for v in plan.stride):
        todo.append("output stride (ROADMAP Queue 1 item 4)")
    if plan.epilogue:
        todo.append("epilogues (ROADMAP Queue 1 item 4)")
    if plan.stages:
        todo.append("fused stages (ROADMAP Queue 1 item 7)")
    if plan.coeff_mode == "perlane":
        todo.append("per-lane coefficients (ROADMAP Queue 1 item 5)")
    if plan.strategy == "mxu":
        todo.append("strategy='mxu' (K2, ROADMAP Queue 1 item 8)")
    if plan.combine != "fma":
        raise ValueError(f"{plan.kind!r} plan has combine={plan.combine!r}: "
                         "scan plans run through run_scan_plan")
    if todo:
        raise NotImplementedError(
            f"{plan.kind!r} plan: {', '.join(todo)} not ported yet")
    if plan.coeff_mode not in ("table", "dense"):
        raise ValueError(f"unknown coeff_mode {plan.coeff_mode!r}")
    if plan.strategy not in (None, "lanes"):
        raise ValueError(f"unknown lowering strategy {plan.strategy!r}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if int(time_steps) != time_steps or time_steps < 1:
        raise ValueError(f"time_steps must be an int >= 1, got {time_steps}")


def _geometry(plan, x_shape, block, time_steps):
    nb, nd = plan.batch_axes, plan.ndim_spatial
    if len(x_shape) != nb + nd:
        raise ValueError(f"{plan.kind!r} plan takes a {nb + nd}-D input "
                         f"(batch axes {nb}), got shape {tuple(x_shape)}")
    if len(block) != nd:
        raise ValueError(f"block {block} must have {nd} entries")
    spatial_in = tuple(x_shape[nb:])
    out_sp = plan.out_shape(spatial_in, time_steps)
    if any(o < 1 for o in out_sp):
        raise ValueError(f"input {spatial_in} is smaller than the plan's "
                         f"footprint {plan.exts} over {time_steps} steps")
    B = tuple(min(b, o) for b, o in zip(block, out_sp))
    g = tuple(-(-o // b) for o, b in zip(out_sp, B))
    return spatial_in, out_sp, B, g


# ---------------------------------------------------------------------------
# The plain version: the reference block walk in torch
# ---------------------------------------------------------------------------

def _coeff(plan: SystolicPlan, w, tap):
    if plan.coeff_mode == "table":
        return plan.coeffs[tap.coeff_id[-1]]
    return w[tap.coeff_id].float()


def _tap_read(xb, tap, valid):
    if len(valid) == 3:
        return xb[..., tap.z_offset:tap.z_offset + valid[0],
                  tap.row_offset:tap.row_offset + valid[1], :]
    return xb[..., tap.row_offset:tap.row_offset + valid[0], :]


def apply_plan_once(xb: torch.Tensor, plan: SystolicPlan, w,
                    variant: str) -> torch.Tensor:
    """One valid application of ``plan`` on blocks ``xb`` (fp32).

    The last ``plan.ndim_spatial`` axes are the block; any leading axes
    are independent blocks. The torch twin of the reference's
    ``_apply_plan_once`` (lanes strategy, stride 1): ``shift_psum`` rolls
    the partial sums one lane per column step and keeps lanes
    ``[M−1, W)``; ``shift_data`` rolls the data by the cumulative shift
    and keeps lanes ``[0, W−M+1)``. Same products, same order.
    """
    nd = plan.ndim_spatial
    valid = tuple(n - (e - 1) for n, e in zip(xb.shape[-nd:], plan.exts))
    s = xb.new_zeros(xb.shape[:-nd] + valid[:-1] + (xb.shape[-1],))
    if variant == "shift_psum":
        for step in plan.steps:
            if step.shift:
                s = torch.roll(s, step.shift, dims=-1)
            for tap in step.taps:
                s = s + _tap_read(xb, tap, valid) * _coeff(plan, w, tap)
        return s[..., plan.M - 1:plan.M - 1 + valid[-1]]
    if variant == "shift_data":
        cum = 0
        for step in plan.steps:
            cum += step.shift
            xs = torch.roll(xb, -cum, dims=-1) if cum else xb
            for tap in step.taps:
                s = s + _tap_read(xs, tap, valid) * _coeff(plan, w, tap)
        return s[..., :valid[-1]]
    raise ValueError(variant)


def run_window_plan_reference(x: torch.Tensor, w=None, *, plan: SystolicPlan,
                              block=None, time_steps: int = 1,
                              variant: str = "shift_psum") -> torch.Tensor:
    """The plain version of K1, on any device.

    Pads ``x`` per :func:`origin_pads` (``t·lead`` zeros ahead, enough
    behind for the last block), cuts it into the overlapped input blocks
    of the disjoint output tiling (a strided view), runs ``time_steps``
    applications of :func:`apply_plan_once` on every block at once, crops
    each block to its output tile and stitches the tiles.
    """
    check_supported(plan, time_steps, variant)
    block = tuple(block or default_block(plan, time_steps))
    t = time_steps
    nb, nd = plan.batch_axes, plan.ndim_spatial
    spatial_in, out_sp, B, g = _geometry(plan, x.shape, block, t)
    pads = origin_pads(plan, spatial_in, g, B, t)
    xp = F.pad(x.float(), [v for lo_hi in reversed(pads) for v in lo_hi])
    in_block = plan.block_in_shape(B, t)
    blocks = xp
    for a in range(nd):
        blocks = blocks.unfold(nb + a, in_block[a], B[a])
    blocks = blocks[(slice(None),) * nb + tuple(slice(0, gi) for gi in g)]
    for _ in range(t):
        blocks = apply_plan_once(blocks, plan, w, variant)
    blocks = blocks[(...,) + tuple(slice(0, b) for b in B)]
    perm = list(range(nb)) + [d for a in range(nd)
                              for d in (nb + a, nb + nd + a)]
    out = blocks.permute(perm).reshape(
        tuple(x.shape[:nb]) + tuple(gi * bi for gi, bi in zip(g, B)))
    out = out[(slice(None),) * nb + tuple(slice(0, o) for o in out_sp)]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# K1: the CUDA kernel
# ---------------------------------------------------------------------------

class WindowKernel:
    """Wrapper of K1. ``launches`` counts the kernel launches it made."""

    name = "ssam_window"
    source = "src/repro_torch/csrc/ssam_window.cu"
    replaces = "src/repro/core/engine.py:361 (_window_kernel, pallas_call at 587)"

    def __init__(self, library: _build.Library):
        self.library = library
        self.launches = 0

    def __call__(self, x: torch.Tensor, w, *, plan: SystolicPlan, block,
                 time_steps: int, variant: str) -> torch.Tensor:
        if not x.is_cuda:
            raise ValueError(f"K1 takes a CUDA tensor, got {x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"K1 takes float32 or bfloat16, got {x.dtype}")
        t = time_steps
        nb, nd = plan.batch_axes, plan.ndim_spatial
        spatial_in, out_sp, B, _ = _geometry(plan, x.shape, block, t)
        table = tap_table(plan, None if w is None else tuple(w.shape))
        cidx, shifts, cvals = _device_table(table, x.device)
        if plan.coeff_mode == "dense":
            if w.device != x.device:
                raise ValueError("a dense plan takes its filter w on the "
                                 "same device as x")
            cvals = w.detach().to(torch.float32).contiguous()
        smem = smem_bytes(plan, B, t)
        if smem > SMEM_LIMIT:
            raise ValueError(f"block {B} needs {smem} bytes of shared memory "
                             f"(limit {SMEM_LIMIT}); pass a smaller block")
        x = x.contiguous()
        batch = 1
        for d in x.shape[:nb]:
            batch *= d
        out = torch.empty(tuple(x.shape[:nb]) + out_sp, dtype=x.dtype,
                          device=x.device)
        pad3 = (1,) * (3 - nd)
        zin, hin, win = pad3 + spatial_in
        zo, ho, wo = pad3 + out_sp
        lead, _ = plan.lead_trail()
        lz, ly, lx = (0,) * (3 - nd) + tuple(t * v for v in lead)
        bz, bh, bw = pad3 + B
        lib = self.library.get()
        err = lib.ssam_window_launch(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            cvals.data_ptr(), cidx.data_ptr(), shifts.data_ptr(),
            batch, zin, hin, win, zo, ho, wo, lz, ly, lx, nd,
            plan.depth if nd == 3 else 1, plan.N, len(plan.steps),
            table.lanes_used, t, VARIANTS.index(variant), bz, bh, bw, smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                               f"({plan.kind}, block {B}, t={t})")
        self.launches += 1
        return out


WINDOW_KERNEL = WindowKernel(_build.LIBRARY)


@dataclasses.dataclass(frozen=True)
class TapTable:
    """A plan's taps as the kernel reads them: ``cidx`` holds, per slot
    ``(step, dz, row)``, an index into the coefficient array (the plan's
    immediates or the flattened dense filter), ``-1`` for no tap."""

    cidx: tuple[int, ...]
    shifts: tuple[int, ...]
    coeffs: tuple[float, ...] | None
    lanes_used: int           # M: the lanes one output's column steps span


@functools.lru_cache(maxsize=256)
def tap_table(plan: SystolicPlan, w_shape) -> TapTable:
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, steps = plan.N, len(plan.steps)
    reach = sum(s.shift for s in plan.steps)
    if nd == 3 and (D > 5 or N > 5):
        raise ValueError(f"K1 builds 3-D plans up to a 5x5 (depth x rows) "
                         f"footprint, got {D}x{N}")
    if N > 32:
        raise ValueError(f"K1 builds plans of up to 32 rows, got N={N}")
    if reach + 1 != plan.M or plan.M > WARP or steps > WARP:
        raise ValueError(
            f"K1 maps the lane axis onto one {WARP}-lane warp: the plan's "
            f"column steps (shift total {reach}, M={plan.M}, {steps} steps) "
            "must fit in it")
    if steps * D * N > TABLE_SLOTS:
        raise ValueError(f"plan has {steps * D * N} tap slots, K1 holds "
                         f"{TABLE_SLOTS}")
    cidx = [-1] * (steps * D * N)
    for m, step in enumerate(plan.steps):
        for tap in step.taps:
            if not (0 <= tap.row_offset < N and 0 <= tap.z_offset < D):
                raise ValueError(f"tap {tap} lies outside the footprint")
            slot = (m * D + tap.z_offset) * N + tap.row_offset
            if cidx[slot] != -1:
                raise ValueError(f"two taps of step {m} read the same "
                                 f"cell {tap}")
            if plan.coeff_mode == "table":
                if not 0 <= tap.coeff_id[-1] < len(plan.coeffs or ()):
                    raise ValueError(f"tap {tap} has no coefficient in the "
                                     "plan's table")
                cidx[slot] = tap.coeff_id[-1]
            else:
                if len(tap.coeff_id) != len(w_shape) or not all(
                        0 <= i < n for i, n in zip(tap.coeff_id, w_shape)):
                    raise ValueError(f"tap {tap} lies outside the filter of "
                                     f"shape {w_shape}")
                flat = 0
                for i, n in zip(tap.coeff_id, w_shape):
                    flat = flat * n + i
                cidx[slot] = flat
    shifts = [s.shift for s in plan.steps]
    return TapTable(tuple(cidx), tuple(shifts), plan.coeffs, plan.M)


@functools.lru_cache(maxsize=256)
def _device_table(table: TapTable, device):
    """Device copies of a tap table (slot indices, shifts and the plan's
    immediates), kept per (table, device)."""
    cidx = torch.tensor(table.cidx, dtype=torch.int32, device=device)
    shifts = torch.tensor(table.shifts, dtype=torch.int32, device=device)
    const = torch.tensor(table.coeffs or (0.0,), dtype=torch.float32,
                         device=device)
    return cidx, shifts, const


def smem_bytes(plan: SystolicPlan, block, time_steps: int) -> int:
    """Dynamic shared memory of one K1 block: the tap table, the staged
    skirt and, for ``t > 1``, the buffer of the first intermediate iterate
    (layout of ``ssam_window.cuh``)."""
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M, steps = plan.N, plan.M, len(plan.steps)
    bz, bh, bw = (1,) * (3 - nd) + tuple(block)
    words = (steps * D * N + steps * D + steps + 3) & ~3

    def tile(k):
        return (bz + k * (D - 1)) * (bh + k * (N - 1)) * (bw + k * (M - 1))

    t = time_steps
    words += tile(t) + (tile(t - 1) if t > 1 else 0)
    return 4 * words


def default_block(plan: SystolicPlan, time_steps: int = 1) -> tuple[int, ...]:
    """K1's output tile: four warp-widths of valid lanes across, 64 rows
    (2-D) or 16 rows by 8 slices (3-D), halved until the block fits in
    shared memory."""
    V = max(1, WARP - (plan.M - 1))
    if plan.ndim_spatial == 3:
        block = [8, 16, 2 * V]
    else:
        block = [64, 4 * V]
    while smem_bytes(plan, block, time_steps) > SMEM_LIMIT // 2:
        i = max(range(len(block) - 1), key=lambda a: block[a])
        if block[i] == 1:
            break
        block[i] = max(1, block[i] // 2)
    return tuple(block)


def run_window_plan(x: torch.Tensor, w=None, *, plan: SystolicPlan,
                    block=None, time_steps: int = 1,
                    variant: str = "shift_psum") -> torch.Tensor:
    """Run a windowed plan: K1 for a CUDA tensor, the plain version for a
    CPU tensor, an error for anything else.

    Args:
      x: ``batch_axes + ndim_spatial``-dim input, lane axis last.
      w: the dense ``(N, M)`` filter for ``coeff_mode='dense'`` plans,
        None for ``'table'`` plans.
      block: output tile per windowed axis (default :func:`default_block`).
      time_steps: fused applications (§6.4), pad-once semantics.
      variant: ``'shift_psum'`` (paper) or ``'shift_data'``.
    """
    check_supported(plan, time_steps, variant)
    if plan.coeff_mode == "dense" and w is None:
        raise ValueError("a dense plan needs its filter w")
    block = tuple(block or default_block(plan, time_steps))
    if x.device.type == "cuda":
        return WINDOW_KERNEL(x, w, plan=plan, block=block,
                             time_steps=time_steps, variant=variant)
    if x.device.type == "cpu":
        return run_window_plan_reference(x, w, plan=plan, block=block,
                                         time_steps=time_steps,
                                         variant=variant)
    raise ValueError(f"no windowed engine for device {x.device}")


# ---------------------------------------------------------------------------
# Scan family: cumsum / linear recurrence (K5)
# ---------------------------------------------------------------------------

COMBINES = ("add", "linrec")


def check_scan_plan(plan: SystolicPlan, operands) -> None:
    """Raise for a scan plan or operands this port does not run."""
    if plan.combine not in COMBINES:
        raise ValueError(f"{plan.kind!r} plan has combine={plan.combine!r}: "
                         f"run_scan_plan takes {COMBINES}; windowed plans "
                         "run through run_window_plan")
    if plan.epilogue:
        raise NotImplementedError(
            f"{plan.kind!r} plan: epilogues on scan plans are not ported "
            "yet (ROADMAP Queue 1 item 4)")
    want = 2 if plan.combine == "linrec" else 1
    if len(operands) != want:
        raise ValueError(f"combine={plan.combine!r} takes {want} operand(s), "
                         f"got {len(operands)}")
    shape = operands[0].shape
    if (len(shape) != 2 or 0 in shape
            or any(o.shape != shape for o in operands)):
        raise ValueError(f"scan operands must share one non-empty (R, T) "
                         f"shape, got {[tuple(o.shape) for o in operands]}")


def _carry_rows(carry, R, like):
    """``carry`` (``(R,)`` or ``(R, 1)``) as ``(R, 1)`` in the operands'
    dtype, as the reference casts it before the kernel reads it."""
    return carry.reshape(R, 1).to(like.dtype)


def run_scan_plan_reference(*operands: torch.Tensor, plan: SystolicPlan,
                            block_r: int = 8, carry=None,
                            return_carry: bool = False):
    """The plain version of K5, on any device: the reference
    ``_scan_kernel`` body over the ``_scan_call`` tiling.

    Operands pad with the combine's identity (``add``: 0; ``linrec``:
    ``(1, 0)``) to ``(gr·BR, gt·S)`` and split into ``(BR, S)`` tiles.
    Row tiles are independent, so they run as one batch. In every tile
    the Kogge–Stone steps of ``plan.steps`` shift by ``d`` and combine
    under ``lane >= d`` (``linrec``: ``A, B = A·As, A·Bs + B``, f_t ∘
    f_{t−d}); the in-tile scan does not read the carry, so all T tiles
    scan at once. The carry then walks the T tiles in order: seeded from
    ``carry`` (else 0), ``add`` adds it after the scan, ``linrec`` applies
    the prefix to it (``h = A·carry + B``), and the tile's last lane is
    the next carry. fp32 accumulation; the output, and the ``(R, 1)``
    carry-out, in the operands' dtype.
    """
    check_scan_plan(plan, operands)
    x0 = operands[0]
    R, T = x0.shape
    S = plan.S
    BR = min(block_r, R)
    gr, gt = -(-R // BR), -(-T // S)
    pad = (0, gt * S - T, 0, gr * BR - R)
    if plan.combine == "linrec":
        A = F.pad(operands[0].float(), pad, value=1.0)
        B = F.pad(operands[1].float(), pad)
    else:
        A = None
        B = F.pad(operands[0].float(), pad)
    tiles = (gr * BR, gt, S)
    B = B.reshape(tiles)
    if A is not None:
        A = A.reshape(tiles)
    lane = torch.arange(S, device=x0.device)
    for step in plan.steps:
        ctrl = lane >= step.shift
        Bs = torch.where(ctrl, torch.roll(B, step.shift, dims=-1), 0.0)
        if A is None:
            B = B + Bs
            continue
        As = torch.where(ctrl, torch.roll(A, step.shift, dims=-1), 1.0)
        A, B = A * As, A * Bs + B
    c = (x0.new_zeros((R, 1), dtype=torch.float32) if carry is None
         else _carry_rows(carry, R, x0).float())
    c = F.pad(c, (0, 0, 0, gr * BR - R))
    outs = []
    for j in range(gt):
        h = B[:, j] + c if A is None else A[:, j] * c + B[:, j]
        c = h[:, -1:]
        outs.append(h)
    out = torch.stack(outs, dim=1).reshape(gr * BR, gt * S)[:R, :T]
    out = out.to(x0.dtype)
    if return_carry:
        return out, c[:R].to(x0.dtype)
    return out


class ScanKernel:
    """Wrapper of K5. ``launches`` counts the kernel launches it made."""

    name = "ssam_scan"
    source = "src/repro_torch/csrc/ssam_scan.cu"
    replaces = "src/repro/core/engine.py:897 (_scan_kernel, pallas_call at 1015)"

    def __init__(self, library: _build.Library):
        self.library = library
        self.launches = 0

    def __call__(self, *operands: torch.Tensor, plan: SystolicPlan,
                 carry=None, return_carry: bool = False):
        check_scan_plan(plan, operands)
        x0 = operands[0]
        if not all(o.is_cuda and o.device == x0.device for o in operands):
            raise ValueError(f"K5 takes CUDA tensors on one device, got "
                             f"{[str(o.device) for o in operands]}")
        if x0.dtype not in (torch.float32, torch.bfloat16) or any(
                o.dtype != x0.dtype for o in operands):
            raise TypeError(f"K5 takes float32 or bfloat16 operands of one "
                            f"dtype, got {[o.dtype for o in operands]}")
        R, T = x0.shape
        ops_c = [o.contiguous() for o in operands]
        out = torch.empty_like(ops_c[0])
        cin = None
        if carry is not None:
            if carry.device != x0.device:
                raise ValueError("the carry must lie on the operands' device")
            cin = _carry_rows(carry, R, x0).contiguous()
        cout = (torch.empty((R, 1), dtype=x0.dtype, device=x0.device)
                if return_carry else None)
        err = self.library.get().ssam_scan_launch(
            ops_c[0].data_ptr(),
            ops_c[1].data_ptr() if len(ops_c) == 2 else None,
            None if cin is None else cin.data_ptr(), out.data_ptr(),
            None if cout is None else cout.data_ptr(), R, T,
            COMBINES.index(plan.combine), int(x0.dtype == torch.bfloat16),
            torch.cuda.current_stream(x0.device).cuda_stream)
        if err:
            raise RuntimeError(f"K5 launch failed: CUDA error {err} "
                               f"({plan.combine}, R={R}, T={T})")
        self.launches += 1
        return (out, cout) if return_carry else out


SCAN_KERNEL = ScanKernel(_build.LIBRARY)


def run_scan_plan(*operands: torch.Tensor, plan: SystolicPlan,
                  block_r: int = 8, carry=None, return_carry: bool = False):
    """Run a scan plan over ``(R, T)`` operands: K5 for CUDA tensors, the
    plain version for CPU tensors, an error for anything else.

    ``carry`` (``(R,)`` or ``(R, 1)``) seeds the state h₋₁ entering the
    first tile (default 0); ``return_carry=True`` also returns the final
    raw state ``(R, 1)``. ``plan.S`` and ``block_r`` set the plain
    version's ``(block_r, S)`` tile; K5 walks each row in 32-lane pieces
    whatever the plan's tile. The two compute the same function and
    differ only in rounding.
    """
    check_scan_plan(plan, operands)
    dev = operands[0].device
    if dev.type == "cuda":
        return SCAN_KERNEL(*operands, plan=plan, carry=carry,
                           return_carry=return_carry)
    if dev.type == "cpu":
        return run_scan_plan_reference(*operands, plan=plan, block_r=block_r,
                                       carry=carry, return_carry=return_carry)
    raise ValueError(f"no scan engine for device {dev}")


def check_chunk_geometry(plan: SystolicPlan, chunk: int) -> None:
    """Guards of the chunk-streamed scan schedule: no epilogues (the
    streamed schedule carries the raw state between chunks), and a chunk
    that holds a whole number of lane tiles."""
    if plan.epilogue_op_count():
        raise ValueError(
            f"{plan.kind}: epilogue stages are illegal under chunking — the "
            "chunk-streamed schedule carries the raw scan state between "
            "chunks and recomputes it on backward; apply activations to "
            "the streamed output instead")
    if chunk < plan.S:
        raise ValueError(
            f"{plan.kind}: chunk={chunk} is smaller than the lane tile "
            f"S={plan.S}; a chunk must hold at least one Kogge–Stone tile")
    if chunk % plan.S:
        raise ValueError(
            f"{plan.kind}: chunk={chunk} is not a multiple of the lane "
            f"tile S={plan.S}; partial tiles would shift the carry "
            "hand-off off the tile boundary")


def run_scan_plan_chunked(*operands: torch.Tensor, plan: SystolicPlan,
                          chunk: int, block_r: int = 8, carry=None,
                          return_carry: bool = False):
    """Stream a scan plan over ``(R, chunk)`` slabs: one
    :func:`run_scan_plan` call per slab (one K5 launch on the card), the
    carry threaded from each slab to the next. T pads to whole chunks
    with the combine's identity."""
    check_chunk_geometry(plan, chunk)
    check_scan_plan(plan, operands)
    x0 = operands[0]
    R, T = x0.shape
    nc = -(-T // chunk)
    pad = (0, nc * chunk - T)
    if plan.combine == "linrec":
        padded = (F.pad(operands[0], pad, value=1.0), F.pad(operands[1], pad))
    else:
        padded = (F.pad(operands[0], pad),)
    c = (x0.new_zeros((R, 1)) if carry is None else _carry_rows(carry, R, x0))
    outs = []
    for i in range(nc):
        out, c = run_scan_plan(
            *(o[:, i * chunk:(i + 1) * chunk] for o in padded), plan=plan,
            block_r=block_r, carry=c, return_carry=True)
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :T]
    return (out, c) if return_carry else out
