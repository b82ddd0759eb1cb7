"""K3's channel path (the weight gradient on the tensor cores) and the
strided cotangent it reads in place, on the CPU, against the JAX package.

* The plain weight gradient of a strided plan, on the cotangent the
  forward produced, equals the stride-free plan's on that cotangent
  scattered onto the dense lattice, and ``jax.grad`` of the reference's
  ``conv2d_nchw`` subsampled by the stride.
* The kernel's geometry (``engine.wgrad_tc_layout``): tiles, slices,
  the TMA ring and shared memory, the per-tap box coordinates (16-byte
  aligned starts, the tap's shift inside the box, its column phase), the
  column-phase split of x, the pitch-padding decision and
  ``launches_for`` at the Whisper stem's shapes and at the card tests'
  shapes; and a CPU emulation of its TMA boxes (zero outside the tensor)
  and k-block walk, summed slice by slice, against the plain version.
* The two repairs: ``ref.conv2d_nchw``'s fourth argument is ``groups``
  (stride keyword-only), and a scan plan's input adjoint points to
  ``reversed_recurrence_coeffs``, both as in the reference.

Tolerance: fp32 ``rtol = 3e-5, atol = 3e-5·max|ref|`` (DESIGN.md §6),
bf16 3e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import plan as jplan
from repro.kernels import ref as jref
from repro_torch.core import adjoint, engine, plan
from repro_torch.kernels import ops, ref, ssam_conv2d

STRIDES = [(1, 2), (2, 1), (2, 2)]
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
# The NCHW shapes of test_torch_cuda.py's WGRAD_CASES: (x, w, mode, stride)
CARD_CASES = [
    ((2, 5, 3, 300), (37, 5, 3, 3), "same", (1, 1)),
    ((8, 80, 1, 700), (64, 80, 1, 3), "same", (1, 1)),
    ((1, 1, 1, 1), (1, 1, 1, 1), "valid", (1, 1)),
    ((2, 3, 9, 70), (130, 3, 2, 5), "valid", (1, 1)),
    ((2, 512, 1, 3000), (512, 512, 1, 3), "same", (1, 2)),
    ((3, 19, 5, 257), (37, 19, 3, 2), "valid", (2, 3)),
    ((2, 6, 1, 90), (8, 6, 1, 3), "same", (1, 2)),
]


def _close(got, want, rtol=3e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _plan(xs, ws, mode, stride):
    return dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                               stride=None if stride == (1, 1) else stride)


def _operands(xs, ws, mode, stride, dtype=torch.float32, seed=30):
    p = _plan(xs, ws, mode, stride)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (xs[0], ws[0]) + p.out_shape(xs[2:])).astype(np.float32))
    return x.to(dtype), g.to(dtype), p


# --- the strided cotangent, read in place ----------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("stride", STRIDES, ids=str)
def test_strided_weight_grad_reference(stride, mode, dtype):
    x, g, p = _operands((2, 3, 7, 17), (4, 3, 2, 3), mode, stride,
                        getattr(torch, dtype))
    got = engine.run_weight_grad_plan_reference(x, g, plan=p)
    assert got.dtype == torch.float32 and got.shape == (4, 3, 2, 3)
    # the stride-free plan on the cotangent scattered onto the dense lattice
    dense = dataclasses.replace(p, stride=None)
    gd = g.new_zeros(g.shape[:2] + dense.out_shape(x.shape[2:]))
    gd[..., ::stride[0], ::stride[1]] = g
    _close(got, engine.run_weight_grad_plan_reference(x, gd, plan=dense),
           TOL[dtype])
    # jax.grad of the reference's oracle, subsampled by the stride
    xf, gf = x.float().numpy(), g.float().numpy()
    want = jax.grad(lambda ww: jnp.sum(jref.conv2d_nchw(
        jnp.asarray(xf), ww, mode)[..., ::stride[0], ::stride[1]] * gf))(
        jnp.zeros((4, 3, 2, 3), jnp.float32))
    _close(got, want, TOL[dtype])


def test_strided_backward_reads_the_cotangent_in_place(monkeypatch):
    """dW takes the strided plan and the cotangent of the strided output
    (the real positions only); dx still takes the scattered one."""
    seen = []
    run = engine.run_weight_grad_plan
    monkeypatch.setattr(engine, "run_weight_grad_plan",
                        lambda x, g, *, plan: seen.append(
                            (tuple(g.shape), plan.stride))
                        or run(x, g, plan=plan))
    x = torch.randn(2, 3, 1, 12, requires_grad=True)
    w = torch.randn(4, 3, 1, 3, requires_grad=True)
    y = ops.conv2d(x, w, stride=(1, 2), epilogue="gelu")
    y.sum().backward()
    assert seen == [((2, 4, 1, 6), (1, 2))]
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


def test_single_channel_kernel_refuses_a_stride():
    # a stride no longer refused: the gradient runs per phase of x, each
    # phase one launch of the stride-1 walk (one tile, one block here)
    p = dataclasses.replace(ssam_conv2d.plan_for((3, 3), "same"),
                            stride=(1, 2))
    assert [(ph.n, ph.m) for ph in engine.wgrad_phases(p)] == [(3, 2),
                                                               (3, 1)]
    assert engine.WGRAD_KERNEL.launches_for(torch.zeros(9, 12),
                                            torch.zeros(9, 6), plan=p) == 2
    with pytest.raises(ValueError, match="not the output"):
        engine.WGRAD_KERNEL.launches_for(torch.zeros(9, 12),
                                         torch.zeros(9, 12), plan=p)


# --- the kernel's geometry ---------------------------------------------------

def test_stem_layouts():
    # conv2: 512 -> 512 channels, 3 taps, stride (1, 2), 1500 real positions
    lay = engine.wgrad_tc_layout(8, 512, 512, 1, 1500, 1, 3, lead=(0, 1),
                                 stride=(1, 2))
    assert (lay.ci_tile, lay.taps_per_tile, lay.ci_tiles, lay.tap_groups) \
        == (128, 1, 4, 3)
    assert (lay.kb, lay.kblocks_per_row, lay.kblocks) == (32, 47, 8 * 47)
    # 8 slices: 384 blocks, 3 waves of one block per SM, 47 k-blocks each
    assert lay.grid == (12, 4, 8) and lay.slices == 8
    # x read in place: boxes of 68 columns (2·31 + 1 used) from a 16-byte
    # aligned start, every 2nd column taken
    assert (lay.xstep, lay.phases, lay.box_w) == (2, 1, 68)
    assert (lay.stages, lay.stage_bytes) == (3, 16384 + 34816)
    assert lay.smem == 3 * 51200 + 4 * 16384 + 32 + 512 + 1024 \
        <= engine.SMEM_LIMIT
    # tap m reads x column 2·ox + m − 1
    assert (lay.tap_col, lay.tap_shift, lay.tap_row, lay.tap_phase) == \
        ((-4, 0, 0), (3, 0, 1), (0, 0, 0), (0, 0, 0))
    assert lay.box(0, 5, 0, 32, 256) == (60, 0, 256, 5)
    # conv1: 80 -> 512, three taps side by side in one N tile
    lay = engine.wgrad_tc_layout(8, 80, 512, 1, 3000, 1, 3, lead=(0, 1))
    assert (lay.ci_tile, lay.taps_per_tile, lay.ci_tiles, lay.tap_groups) \
        == (40, 3, 2, 1)
    assert lay.kblocks == 8 * 94 and lay.grid == (2, 4, 16)   # one wave
    assert (lay.xstep, lay.phases, lay.box_w, lay.stages) == (1, 1, 36, 4)
    assert (lay.tap_col, lay.tap_shift) == ((-4, 0, 0), (3, 0, 1))
    # bf16: 64 positions per 128-byte k-block, no small part
    lay = engine.wgrad_tc_layout(8, 512, 512, 1, 1500, 1, 3, lead=(0, 1),
                                 stride=(1, 2), elem_bytes=2)
    assert lay.kblocks == 8 * 24 and (lay.box_w, lay.stages) == (136, 3)
    assert lay.slices == 8
    assert lay.smem == 3 * 51200 + 2 * 16384 + 32 + 512 + 1024 \
        <= engine.SMEM_LIMIT
    assert lay.tap_shift == (7, 0, 1)
    # a stride whose box passes TMA's 256 columns: x in 4 column phases,
    # tap m reading phase (m − 1) mod 4 at column ox + (m − 1) div 4
    lay = engine.wgrad_tc_layout(8, 512, 512, 1, 750, 1, 3, lead=(0, 1),
                                 stride=(1, 4), elem_bytes=2)
    assert (lay.xstep, lay.phases, lay.box_w) == (1, 4, 72)
    assert (lay.tap_col, lay.tap_shift, lay.tap_phase) == \
        ((-8, 0, 0), (7, 0, 0), (3, 0, 1))
    assert lay.box(0, 1, 0, 64, 0) == (56, 3, 0, 1)
    # filters of any size: no tap table bounds them, a block walks its own
    # N tile's taps (a 9 x 9 once refused at 64 taps)
    lay = engine.wgrad_tc_layout(1, 1, 1, 9, 9, 9, 9, lead=(4, 4))
    assert (lay.ci_tile, lay.taps_per_tile, lay.tap_groups) == (8, 16, 6)
    assert lay.tap_col[:9] == (-4, -4, -4, -4, 0, 0, 0, 0, 4)
    assert lay.tap_row[::9] == tuple(range(-4, 5))
    # AlexNet's conv1: 11 x 11 at stride 4 over 3 channels, 121 taps
    lay = engine.wgrad_tc_layout(64, 3, 96, 55, 55, 11, 11, stride=(4, 4))
    assert (lay.ci_tile, lay.taps_per_tile, lay.tap_groups) == (8, 16, 8)
    assert (lay.xstep, lay.phases, lay.box_w) == (1, 4, 36)   # in phases
    assert lay.smem <= engine.SMEM_LIMIT
    for tap in range(121):
        col, shift, row, ph = engine.wgrad_tc_tap(tap, 11, (0, 0), 1, 4)
        assert (col + shift, row, ph) == (tap % 11, tap // 11, 0)


@pytest.mark.parametrize("xs,ws,mode,stride", CARD_CASES, ids=str)
def test_card_case_layouts_and_launches(xs, ws, mode, stride):
    x, g, p = _operands(xs, ws, mode, stride)
    for dtype in (torch.float32, torch.bfloat16):
        xx, gg = x.to(dtype), g.to(dtype)
        x4, g4, lay = engine._wgrad_tc_geometry(xx, gg, p)
        co_tiles = -(-ws[0] // engine.WGRAD_TC_TILE)
        assert lay.grid == (lay.ci_tiles * lay.tap_groups, co_tiles,
                            lay.slices)
        assert lay.ci_tile % 8 == 0 and \
            lay.taps_per_tile * lay.ci_tile <= engine.WGRAD_TC_TILE
        assert lay.ci_tiles * lay.ci_tile >= xs[1]
        assert lay.tap_groups * lay.taps_per_tile >= ws[2] * ws[3]
        assert 1 <= lay.slices <= max(1, lay.kblocks // 8)
        assert lay.smem <= engine.SMEM_LIMIT
        assert lay.kb * xx.element_size() == engine.WGRAD_TC_ROW_BYTES
        # every box starts 16 bytes aligned and holds the tap's kb columns
        align = engine.TMA_ALIGN // xx.element_size()
        assert lay.xstep * lay.phases == stride[1]
        assert lay.row_stride == stride[0]
        assert all(c % align == 0 for c in lay.tap_col)
        assert all(0 <= s < align for s in lay.tap_shift)
        assert all(0 <= p < lay.phases for p in lay.tap_phase)
        assert max(lay.tap_shift) + lay.xstep * (lay.kb - 1) < lay.box_w \
            <= engine.TMA_MAX_BOX and lay.box_w % align == 0
        assert lay.stages >= 3
        assert engine.WGRAD_KERNEL.launches_for(xx, gg, plan=p) == \
            1 + (lay.slices > 1)


@pytest.mark.parametrize("width,elem,pitch", [
    (3000, 4, 3000), (1500, 4, 1500), (1, 4, 4), (70, 4, 72), (90, 4, 92),
    (257, 4, 260), (3000, 2, 3000), (1500, 2, 1504), (70, 2, 72)])
def test_tma_pitch_padding(width, elem, pitch):
    assert engine.tma_pitch(width, elem) == pitch
    t = torch.randn(2, 3, width).to(torch.float32 if elem == 4
                                    else torch.bfloat16)
    got, p = engine._tma_operand(t)
    assert p == pitch and (got is t) == (pitch == width)
    assert got.stride(-2) == pitch
    assert torch.equal(got[..., :width], t)
    # a non-contiguous view is copied at the pitch, too
    got, p = engine._tma_operand(t.transpose(0, 1))
    assert p == pitch and got.is_contiguous()
    assert torch.equal(got[..., :width], t.transpose(0, 1))


def test_phase_split():
    x = torch.arange(2 * 7, dtype=torch.float32).reshape(1, 1, 2, 7)
    xs = engine.phase_split(x, 3)
    assert xs.shape == (1, 1, 2, 3, 3)
    for p in range(3):
        for j in range(3):
            c = 3 * j + p
            want = x[..., c] if c < 7 else torch.zeros(1, 1, 2)
            assert torch.equal(xs[..., p, j], want)
    assert engine.phase_split(x[..., :6], 2)._base is not None   # a view


def _emulate(x, g, p, lay):
    """The channel kernel's walk on the CPU: per block (N tile, C_out tile,
    slice), the TMA boxes of each k-block (zero outside the tensor; x as
    it is or in its column phases), each tap's positions taken from its x
    box at its shift and step, contracted in fp32 into a partial tile;
    then the slices' tiles added in slice order and their columns placed
    in dW's layout."""
    x4, g4 = engine._wgrad_operands(x, g, p)
    B, Ci, H, W = x4.shape
    Co, Ho, Wo = g4.shape[1:]
    N, M = p.exts
    taps, T = N * M, engine.WGRAD_TC_TILE
    xs = (engine.phase_split(x4, lay.phases) if lay.phases > 1
          else x4[:, :, :, None]).float().flatten(2, 3)  # rows: (h, phase)
    gf = g4.float()

    def box(t, col, row, c0, b):
        raw = torch.zeros(lay.ci_tile, lay.box_w)
        cols = col + torch.arange(lay.box_w)
        ok = (cols >= 0) & (cols < xs.shape[-1])
        if 0 <= row < xs.shape[2]:
            slab = xs[b, c0:c0 + lay.ci_tile, row]
            raw[:slab.shape[0], ok] = slab[:, cols[ok]]
        return raw[:, lay.tap_shift[t] + lay.xstep * torch.arange(lay.kb)]

    def g_box(ox0, oy, co0, b):
        tile = torch.zeros(T, lay.kb)
        slab = gf[b, co0:co0 + T, oy, ox0:ox0 + lay.kb]
        tile[:slab.shape[0], :slab.shape[1]] = slab
        return tile

    # partial tiles as the kernel stores them: (slice, N tile, C_out, 128)
    parts = torch.zeros(lay.slices, lay.grid[0], Co, T)
    for nt in range(lay.grid[0]):
        tg, cs = divmod(nt, lay.ci_tiles)
        c0, tap0 = cs * lay.ci_tile, tg * lay.taps_per_tile
        ntap = min(lay.taps_per_tile, taps - tap0)
        for ct in range(lay.grid[1]):
            co0 = ct * T
            for s in range(lay.slices):
                acc = torch.zeros(T, T)
                for kb in range(s * lay.kblocks // lay.slices,
                                (s + 1) * lay.kblocks // lay.slices):
                    row, j = divmod(kb, lay.kblocks_per_row)
                    b, oy = divmod(row, Ho)
                    ox0 = j * lay.kb
                    xb = torch.cat([box(tap0 + t, *lay.box(tap0 + t, b, oy,
                                                           ox0, c0))
                                    for t in range(ntap)])
                    acc[:, :xb.shape[0]] += g_box(ox0, oy, co0, b) @ xb.T
                parts[s, nt, co0:co0 + T] = acc[:Co - co0]
    # the second launch: dW[co, ci, tap] from N tile (tap // tpt)·ci_tiles
    # + ci // ci_tile, column (tap % tpt)·ci_tile + ci % ci_tile
    total = parts[0]
    for s in range(1, lay.slices):
        total = total + parts[s]
    out = torch.empty(Co, Ci, taps)
    for tap in range(taps):
        for ci in range(Ci):
            nt = (tap // lay.taps_per_tile) * lay.ci_tiles + ci // lay.ci_tile
            col = (tap % lay.taps_per_tile) * lay.ci_tile + ci % lay.ci_tile
            out[:, ci, tap] = total[nt, :, col]
    return out.reshape(Co, Ci, N, M)


EMULATED = [c for c in CARD_CASES if c[0][1] * c[0][3] <= 5000] + [
    ((2, 4, 4, 40), (9, 4, 2, 3), "same", (2, 2)),
    ((1, 3, 2, 33), (5, 3, 1, 4), "valid", (1, 3)),
    ((1, 3, 2, 70), (5, 3, 1, 3), "same", (1, 5)),
    # beyond 64 taps: a 9 x 9 'same' and AlexNet's 11 x 11 at stride 4
    ((1, 3, 10, 21), (4, 3, 9, 9), "same", (1, 1)),
    ((1, 3, 23, 23), (5, 3, 11, 11), "valid", (4, 4))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,ws,mode,stride", EMULATED, ids=str)
def test_emulated_tma_walk_matches_plain_version(xs, ws, mode, stride, dtype):
    x, g, p = _operands(xs, ws, mode, stride, getattr(torch, dtype))
    _, _, lay = engine._wgrad_tc_geometry(x, g, p)
    _close(_emulate(x, g, p, lay),
           engine.run_weight_grad_plan_reference(x, g, plan=p))


# --- the repairs -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["same", "valid"])
def test_ref_conv2d_nchw_groups_is_the_fourth_argument(mode):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 4, 5, 9)).astype(np.float32)
    w = rng.standard_normal((6, 2, 2, 3)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = np.asarray(jref.conv2d_nchw(jnp.asarray(x), jnp.asarray(w), mode,
                                       2))
    _close(ref.conv2d_nchw(xt, wt, mode, 2), want)
    _close(ref.conv2d_nchw(xt, wt, mode, 2, stride=(1, 2)), want[..., ::2])
    _close(ref.conv2d_nchw(xt, wt[:, :1].repeat(1, 4, 1, 1) / 4, mode),
           np.asarray(jref.conv2d_nchw(jnp.asarray(x), jnp.asarray(
               np.repeat(w[:, :1], 4, axis=1) / 4), mode)))
    with pytest.raises(TypeError):
        ref.conv2d_nchw(xt, wt, mode, 2, (1, 2))
    with pytest.raises(ValueError, match="groups=3"):
        ref.conv2d_nchw(xt, wt, mode, 3)


def test_scan_plan_adjoint_message_is_the_reference():
    with pytest.raises(ValueError) as got:
        adjoint.input_adjoint_plan(plan.scan_plan(16))
    with pytest.raises(ValueError) as want:
        jadj.input_adjoint_plan(jplan.scan_plan(16))
    assert str(got.value) == str(want.value)
    assert "reversed_recurrence_coeffs" in str(got.value)
    assert hasattr(adjoint, "reversed_recurrence_coeffs")
