"""K2's channel-reduce kernel (``csrc/ssam_mxu_tc.cu``) walked on the CPU:
its layout (``engine.mxu_tc_layout``) and a torch emulation of what the
kernel computes, block by block, against the plain version of K2.

The walk reads only what the kernel reads: the phase table, the filter
gathered into k-blocks of 32 channels of one tap (``kcols``), x in
16-byte chunks (``engine._tma_operand``: rows padded with zeros to a
multiple of 16 bytes), one TMA box per x stage starting at the 16-byte
chunk at or below the tile's first column, zero outside the tensor, and
each thread's A fragment at ``channel·pitch + tap offset + shift +
position·sw``. It checks that every gather stays inside its stage, that
every output is written exactly once, and that the result equals
``engine.apply_plan_mxu`` (through ``run_window_plan_reference`` and
``run_adjoint_phases_reference`` on mxu plans) at fp32 3e-5 (bf16 3e-2),
forward and the phased dx of strided plans, in both x-staging modes, at
rows of 17 and 257 fp32 and 150
bf16 columns (no multiple of 16 bytes).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.core import adjoint, engine
from repro_torch.kernels import ops, ssam_conv2d


def _close(got, want, rtol=3e-5):
    got, want = got.detach().float().numpy(), want.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _plan(xs, ws, mode, stride):
    return dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                               stride=None if stride == (1, 1) else stride,
                               strategy="mxu")


def _layout(phases, x4, w, read_stride, *, per_kblock=None):
    """The kernel's layout; ``per_kblock``, where given, is asserted."""
    lay = engine.mxu_tc_layout(
        tuple(phases), batch=x4.shape[0], c_in=x4.shape[1],
        c_out=w.shape[0], fsz=w.shape[2] * w.shape[3],
        read_stride=tuple(read_stride), elem_bytes=x4.element_size())
    assert per_kblock is None or lay.x_per_kblock == per_kblock
    return lay


def _walk(x4, w, phases, read_stride, out_stride, out_spatial, lay):
    """What csrc/ssam_mxu_tc.cu computes from the layout: per block its
    k-blocks in (slab, tap) order, x boxes as TMA stages them, the
    fragments gathered at the table's offsets, the filter's k-block as the
    B tile, the phases stored at the output stride. Returns the output and
    how often each output was written."""
    B, Cr, H, W = x4.shape
    Co, fsz = w.shape[0], w.shape[2] * w.shape[3]
    es = x4.element_size()
    per = 16 // es
    xs, pitch = engine._tma_operand(x4)
    assert pitch % per == 0 and bool((xs[..., W:] == 0).all())
    xs = xs.float()
    wb = F.pad(w.float().reshape(Co, Cr * fsz), (0, 1))[:, list(lay.kcols)]
    sh, sw = read_stride
    osh, osw = out_stride
    t, L, rows = lay.table, lay.row_len, lay.rows
    chunks = L // per
    assert L % per == 0 and chunks <= engine.MXU_TC_MAX_CHUNKS
    stage = 32 * rows * L
    pitch_c = rows * L                      # channel pitch in the stage
    out = torch.zeros((B, Co) + tuple(out_spatial))
    hits = torch.zeros(out.shape, dtype=torch.int64)
    gx, gy, gz = lay.grid
    P, CO = engine.MXU_TC_POS, engine.MXU_TC_CO
    pos = torch.arange(P)
    for z in range(gz):
        ph_i = z % len(phases)
        co_t, b = (z // len(phases)) % lay.co_tiles, \
            (z // len(phases)) // lay.co_tiles
        py, px, hq, wq, T, dcmin, kb0, tofs = t[8 * ph_i:8 * ph_i + 8]
        co0 = co_t * CO
        nkb = T * lay.slabs
        xg = 1 if lay.x_per_kblock else T
        for oy in range(gy):
            for bx in range(gx):
                ox0 = bx * P
                if oy >= hq or ox0 >= wq:
                    continue
                # the box starts at the 16-byte chunk at or below the
                # first column read
                a0, shift = engine.staged_row_start(ox0 * sw + dcmin, es)
                c0 = a0 // per
                assert 0 <= shift < per and a0 % per == 0
                acc = torch.zeros(CO, P)
                box = None
                for j in range(nkb):
                    if j % xg == 0:   # a new x stage: one TMA box
                        j0 = j
                        slab, tap0 = divmod(j0, T)
                        r0 = oy * sh + t[tofs + 2 * tap0]
                        box = torch.zeros(32, rows, L)
                        cols = torch.arange(c0 * per, c0 * per + L)
                        cok = (cols >= 0) & (cols < pitch)
                        for c in range(32):
                            ci = slab * 32 + c
                            for r in range(rows):
                                y = r0 + r
                                if ci < Cr and 0 <= y < H:
                                    box[c, r] = torch.where(
                                        cok, xs[b, ci, y, cols.clamp(
                                            0, pitch - 1)], 0.0)
                        box = box.reshape(-1)
                    off = t[tofs + 2 * (j % T) + 1]
                    e = (torch.arange(32)[:, None] * pitch_c + off + shift
                         + pos[None] * sw)
                    assert int(e.min()) >= 0 and int(e.max()) < stage
                    a = box[e]                          # (32 channels, pos)
                    bt = torch.zeros(CO, 32)
                    n = max(0, min(CO, Co - co0))
                    bt[:n] = wb[co0:co0 + n, (kb0 + j) * 32:(kb0 + j + 1) * 32]
                    acc += bt @ a
                n = max(0, min(CO, Co - co0))
                keep = ox0 + pos < wq
                cols = (ox0 + pos[keep]) * osw + px
                row = oy * osh + py
                out[b, co0:co0 + n, row, cols] = acc[:n][:, keep]
                hits[b, co0:co0 + n, row, cols] += 1
    return out.to(x4.dtype), hits


WALK_CASES = [
    # (x shape, w shape, mode, stride, dtype): rows of 17 and 257 fp32 and
    # 150 bf16 columns are no multiple of 16 bytes; C_out 130 takes two
    # channel tiles, the second 2 wide
    ((2, 5, 3, 17), (6, 5, 3, 3), "same", (1, 2), torch.float32),
    ((1, 3, 1, 257), (130, 3, 1, 3), "same", (1, 1), torch.float32),
    ((2, 4, 5, 150), (5, 4, 2, 5), "valid", (2, 3), torch.bfloat16),
    ((1, 34, 2, 40), (3, 34, 1, 3), "same", (1, 2), torch.float32),
]


@pytest.mark.parametrize("xs,ws,mode,stride,dtype", WALK_CASES, ids=str)
def test_kernel_walk(xs, ws, mode, stride, dtype):
    rng = np.random.default_rng(51)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal(ws).astype(np.float32))
    p = _plan(xs, ws, mode, stride)
    rtol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    ph = engine.forward_phase(p, xs[2:])
    want = engine.run_window_plan_reference(x, w, plan=p)
    lay = _layout((ph,), x, w, p.stride_per_axis())
    got, hits = _walk(x, w, (ph,), p.stride_per_axis(), (1, 1), ph.extent,
                      lay)
    assert bool((hits == 1).all())
    _close(got, want, rtol)
    if stride != (1, 1):
        # the strided adjoint: every phase in one walk, written in place
        g = torch.from_numpy(rng.standard_normal(
            (xs[0], ws[0]) + p.out_shape(xs[2:])).astype(np.float32)).to(dtype)
        wa = adjoint.adjoint_coeff_array(p, w)
        phases = engine.adjoint_reduce_phases(p, xs[2:])
        lay = _layout(phases, g, wa, (1, 1))
        got, hits = _walk(g, wa, phases, (1, 1), p.stride_per_axis(),
                          xs[2:], lay)
        assert bool((hits == 1).all())
        _close(got, engine.run_adjoint_phases_reference(
            g, wa, plan=p, in_spatial=xs[2:]), rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_walk_x_per_kblock(dtype):
    """An x box per k-block (the tap's row only), where a slab's rows do
    not fit in shared memory: a 9 x 9 filter at stride (3, 3) reaches 9
    rows of 32 channels over 128 positions' span."""
    xs, ws = (1, 2, 12, 40), (3, 2, 9, 9)
    rng = np.random.default_rng(52)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal(ws).astype(np.float32))
    p = _plan(xs, ws, "same", (3, 3))
    ph = engine.forward_phase(p, xs[2:])
    lay = _layout((ph,), x, w, (3, 3), per_kblock=True)
    assert lay.rows == 1 and len(lay.kcols) == 81 * 32
    got, hits = _walk(x, w, (ph,), (3, 3), (1, 1), ph.extent, lay)
    assert bool((hits == 1).all())
    _close(got, engine.run_window_plan_reference(x, w, plan=p),
           3e-2 if dtype == torch.bfloat16 else 3e-5)


def test_layout_at_the_stem():
    """The Whisper stem's three K2 calls: 128 positions x 128 channels,
    x staged a slab at a time, 4 filter and 2 x stages, the row padded so
    the fragment loads meet at most two-way bank conflicts (none at
    stride 1)."""
    x2 = torch.empty(8, 512, 1, 3000)
    w2 = torch.empty(512, 512, 1, 3)
    mel, w1 = torch.empty(8, 80, 1, 3000), torch.empty(512, 80, 1, 3)
    p2 = _plan(x2.shape, w2.shape, "same", (1, 2))
    p1 = _plan(mel.shape, w1.shape, "same", (1, 1))
    fwd2 = _layout((engine.forward_phase(p2, (1, 3000)),), x2, w2, (1, 2))
    phases = engine.adjoint_reduce_phases(p2, (1, 3000))
    assert [len(ph.taps) for ph in phases] == [1, 2]
    dx2 = _layout(phases, torch.empty(8, 512, 1, 1500),
                  adjoint.adjoint_coeff_array(p2, w2), (1, 1))
    fwd1 = _layout((engine.forward_phase(p1, (1, 3000)),), mel, w1, (1, 1))
    for lay in (fwd2, dx2, fwd1):
        assert not lay.x_per_kblock and lay.rows == 1
        assert (lay.b_stages, lay.x_stages) == (4, 2)
        assert lay.smem <= engine.SMEM_LIMIT
    assert fwd2.grid == (12, 1, 32) and fwd2.row_len == 264
    assert dx2.grid == (12, 1, 64) and dx2.row_len == 136
    assert fwd1.grid == (24, 1, 32) and fwd1.slabs == 3
    # k-blocks: 16 slabs x 3 taps; the dx 16 x 1 + 16 x 2 (18.87 GFLOP's
    # worth, not the scattered lattice's 16 x 3 x 2)
    assert len(fwd2.kcols) == 48 * 32 and len(dx2.kcols) == 48 * 32
    assert engine.gather_wavefronts(264, 2, 4) == 2
    assert engine.gather_wavefronts(136, 1, 4) == 1
    # the padded channels of conv1's last slab read the zero column
    assert fwd1.kcols[-1] == 80 * 3 and fwd1.kcols.count(80 * 3) == 3 * 16


def test_layout_stages_x_by_what_fits():
    """x a slab at a time (the rows of all a phase's taps) where that fits,
    else a k-block at a time; the grid in tiles of 128 positions x 128
    channels. A 9 x 9 filter at stride 3 reaches 9 rows forward, its
    phased dx 3 a phase."""
    p = _plan((1, 2, 12, 400), (3, 2, 9, 9), "same", (3, 3))
    fwd = engine.mxu_tc_layout((engine.forward_phase(p, (12, 400)),),
                               batch=1, c_in=2, c_out=3, fsz=81,
                               read_stride=(3, 3))
    assert fwd.x_per_kblock and fwd.rows == 1 and fwd.grid == (2, 4, 1)
    phases = engine.adjoint_reduce_phases(p, (12, 400))
    dx = engine.mxu_tc_layout(phases, batch=1, c_in=3, c_out=2, fsz=81)
    assert not dx.x_per_kblock and dx.rows == 3 and len(phases) == 9
    assert dx.grid == (2, 4, 9) and dx.smem <= engine.SMEM_LIMIT
    # C_out 200: two channel tiles, the second 72 wide
    q = _plan((1, 16, 23, 300), (200, 16, 1, 3), "same", (1, 1))
    lay = engine.mxu_tc_layout((engine.forward_phase(q, (23, 300)),),
                               batch=1, c_in=16, c_out=200, fsz=3)
    assert lay.co_tiles == 2 and lay.grid == (3, 23, 2)


def test_tma_operand_pads_with_zeros():
    """K2 reads x's rows in 16-byte chunks: the pitch padding is zero."""
    x = torch.randn(2, 3, 4, 17)
    xs, pitch = engine._tma_operand(x)
    assert pitch == 20 and xs.shape == (2, 3, 4, 20)
    assert torch.equal(xs[..., :17], x) and not xs[..., 17:].any()
    xb = torch.randn(1, 2, 3, 150).bfloat16()
    xs, pitch = engine._tma_operand(xb)
    assert pitch == 152 and not xs[..., 150:].any()


def test_cpu_conv_matches_reference_nchw_oracle():
    """The op a user calls, under mxu on the CPU, against the reference's
    NCHW oracle (the kernel's plain version is what the walk holds)."""
    rng = np.random.default_rng(53)
    x = rng.standard_normal((2, 34, 2, 40)).astype(np.float32)
    w = rng.standard_normal((3, 34, 1, 3)).astype(np.float32)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), mode="same",
                     strategy="mxu")
    _close(got, torch.from_numpy(np.array(jref.conv2d_nchw(x, w, "same"))))
