"""K3's single-channel schedule (``csrc/ssam_wgrad.cuh``: lanes own 16
bytes of x's columns, the cotangent's row read as a shifted window, a
register cache of x rows, per-tap sums in registers, persistent blocks on
a TMA ring, a fixed-order reduction) walked on the CPU.

``engine.emulate_wgrad_kernel`` walks the kernel's units block by block,
each unit's three TMA boxes (zeros outside the tensors), every warp's band
and row group, each lane's window of the cotangent with its halo, the
register cache's rows and the butterfly, row-group and block-order sums.
It is held against the plain version and against ``jax.grad`` of the
reference's oracles ``repro.kernels.ref.conv2d_same``, ``conv2d_valid``
and ``conv2d_batched`` with respect to the filter (the JAX windowed engine
does not run here, ROADMAP R1). Tolerances: fp32 rtol 3e-5 with atol
3e-5·max|ref| (DESIGN.md §6), bf16 3e-2. The layout tests pin the grid,
bands, ring, shared memory, blocks an SM, the 16-byte aligned box starts,
the tiles that cut a footprint wider or taller than one block holds, the
walk the layout refuses, and the kernels' table generated from the
layout's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import engine
from repro_torch.kernels import ssam_conv2d

TOL = {"float32": 3e-5, "bfloat16": 3e-2}
# (x shape, filter, mode, dtype, max_grid): every filter of the list in
# both modes; widths 1, 127, 129 and 333 (none a multiple of 32·V); heights
# below N; one image and batches of 3; bf16; a capped grid walks several
# units a block through the ring; footprints cut into tiles: 32 x 32 (two
# row tiles in fp32 and bf16), 40 columns (two column tiles), 130 rows
CASES = [
    ((9, 1), (1, 1), "same", "float32", None),
    ((3, 127, 129), (1, 1), "valid", "float32", 2),
    ((40, 129), (2, 2), "same", "float32", None),
    ((20, 333), (2, 2), "valid", "bfloat16", None),
    ((2, 1), (3, 3), "same", "float32", None),
    ((3, 40, 333), (3, 3), "valid", "float32", 3),
    ((37, 127), (5, 5), "same", "float32", None),
    ((3, 40, 333), (5, 5), "same", "float32", 2),
    ((3, 40, 333), (5, 5), "same", "bfloat16", 2),
    ((12, 129), (5, 5), "valid", "float32", None),
    ((3, 21, 1), (1, 7), "same", "float32", None),
    ((6, 127), (1, 7), "valid", "bfloat16", None),
    ((5, 333), (7, 1), "same", "float32", None),
    ((3, 9, 129), (7, 1), "valid", "float32", None),
    ((4, 333), (9, 9), "same", "float32", None),
    ((40, 129), (9, 9), "valid", "bfloat16", None),
    ((3, 11, 127), (13, 2), "same", "float32", None),
    ((45, 333), (13, 2), "valid", "float32", 1),
    ((3, 17, 129), (20, 20), "same", "float32", None),
    ((36, 333), (20, 20), "valid", "float32", 2),
    ((24, 129), (20, 20), "same", "bfloat16", None),
    ((40, 129), (32, 32), "same", "float32", 3),
    ((3, 35, 127), (32, 32), "valid", "bfloat16", 2),
    ((20, 333), (5, 40), "same", "float32", None),
    ((3, 9, 129), (33, 40), "same", "bfloat16", None),
    ((140, 40), (130, 2), "valid", "float32", None),
]
IDS = [f"{'x'.join(map(str, xs))}-{n}x{m}-{mode}-{dt}-g{mg}"
       for xs, (n, m), mode, dt, mg in CASES]


def _close(got, want, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _plan(xs, filt, mode):
    fn = ssam_conv2d.plan_for_batched if len(xs) == 3 else \
        ssam_conv2d.plan_for
    return fn(filt, mode)


def _operands(xs, filt, mode, dtype, seed=40):
    p = _plan(xs, filt, mode)
    rng = np.random.default_rng(seed)
    xn = rng.standard_normal(xs).astype(np.float32)
    gn = rng.standard_normal(
        tuple(xs[:-2]) + p.out_shape(xs[-2:])).astype(np.float32)
    dt = getattr(torch, dtype)
    x, g = torch.from_numpy(xn).to(dt), torch.from_numpy(gn).to(dt)
    # the oracle sees the values the kernel sees (bf16-rounded for bf16)
    return x, g, p, x.float().numpy(), g.float().numpy()


def _oracle(xn, gn, filt, mode):
    """``jax.grad`` of Σ conv(x, w)·g with respect to the filter."""
    if xn.ndim == 3:
        def conv(w):
            return jref.conv2d_batched(jnp.asarray(xn), w, mode)
    else:
        fn = jref.conv2d_same if mode == "same" else jref.conv2d_valid

        def conv(w):
            return fn(jnp.asarray(xn), w)
    w0 = jnp.zeros(filt, jnp.float32)
    return np.asarray(jax.grad(lambda w: jnp.sum(conv(w) * gn))(w0))


@pytest.mark.parametrize("xs,filt,mode,dtype,max_grid", CASES, ids=IDS)
def test_emulation_matches_plain_version_and_oracle(xs, filt, mode, dtype,
                                                    max_grid):
    x, g, p, xn, gn = _operands(xs, filt, mode, dtype)
    got = engine.emulate_wgrad_kernel(x, g, plan=p, max_grid=max_grid)
    assert got.dtype == torch.float32 and tuple(got.shape) == filt
    want = engine.run_weight_grad_plan_reference(x, g, plan=p)
    _close(got.numpy(), want.numpy(), TOL[dtype])
    _close(got.numpy(), _oracle(xn, gn, filt, mode), TOL[dtype])


def test_emulation_sums_in_a_fixed_order():
    # the same inputs give the same bits; another grid sums the partials
    # in another order (the kernel's grid is fixed by the layout)
    x, g, p, _, _ = _operands((3, 40, 333), (5, 5), "same", "float32")
    a = engine.emulate_wgrad_kernel(x, g, plan=p, max_grid=3)
    assert torch.equal(a, engine.emulate_wgrad_kernel(x, g, plan=p,
                                                      max_grid=3))
    _close(a.numpy(), engine.emulate_wgrad_kernel(x, g, plan=p).numpy(),
           3e-5)


# --- the layout --------------------------------------------------------------

def _layout(B, H, W, N, M, mode="same", es=4):
    lead = ((N - 1) // 2, (M - 1) // 2) if mode == "same" else (0, 0)
    Ho, Wo = (H, W) if mode == "same" else (H - N + 1, W - M + 1)
    return engine.wgrad_layout(B, H, W, Ho, Wo, N, M, lead=lead,
                               elem_bytes=es)


def test_layout_at_8192_squared():
    lay = _layout(1, 8192, 8192, 5, 5)
    assert (lay.V, lay.mb, lay.nb, lay.bands(5)) == (4, 5, 8, ((0, 5),))
    assert (lay.row_groups, lay.warps, lay.rows) == (16, 16, 64)
    assert (lay.strips, lay.chunks, lay.units) == (64, 128, 8192)
    assert lay.tiles == (engine.WgradTile(0, 0, 5, 5, 2, -4, 2),)
    assert lay.hw == 8 and lay.launches == 2
    # one block of 16 warps at 128 registers an SM, a ring of two stages
    assert lay.blocks_per_sm == 1 and lay.grid == engine.H100_SMS
    assert lay.warps * engine.WARP * engine.WGRAD_REGS <= engine.H100_SM_REGS
    assert lay.stages == 2 and lay.stage_bytes == 69632
    assert lay.smem + 1024 <= engine.H100_SM_SMEM
    # about 32 KB in flight an SM: the stage that refills while one is read
    assert lay.blocks_per_sm * (lay.stages - 1) * lay.stage_bytes \
        >= engine.WGRAD_FLIGHT_BYTES
    # bf16: 8 values a lane, strips of 256 columns
    lay = _layout(1, 8192, 8192, 5, 5, es=2)
    assert (lay.V, lay.nb, lay.strips, lay.tiles[0].d, lay.hw) == (
        8, 6, 32, 6, 16)
    assert (lay.blocks_per_sm, lay.grid, lay.warps) == (1, 132, 16)
    # batched (16, 2048, 2048)
    lay = _layout(16, 2048, 2048, 5, 5)
    assert lay.units == 16 * 32 * 16 and lay.grid == 132
    # a chunk's rows halve until x's box and two stages fit
    lay = _layout(1, 8192, 8192, 128, 3)
    assert lay.rows == 32 and lay.nbands == 16 and len(lay.tiles) == 1
    assert lay.smem <= engine.SMEM_LIMIT


@pytest.mark.parametrize("N,M,es,tiles,bands,warps", [
    (3, 3, 4, 1, 1, 16), (9, 9, 4, 1, 2, 16), (20, 20, 4, 1, 4, 8),
    (13, 2, 4, 1, 2, 16), (24, 32, 4, 1, 8, 8), (1, 7, 4, 1, 1, 16),
    (7, 1, 4, 1, 1, 16), (40, 3, 4, 1, 5, 15), (9, 9, 2, 1, 3, 15),
    (16, 32, 2, 1, 8, 8),
    # tiles: 32 rows at 3 (fp32) or 2 (bf16) a band, 8 bands a block
    (32, 32, 4, 2, 6, 6), (32, 32, 2, 2, 8, 8), (25, 32, 4, 2, 5, 5),
    # 40 and 64 columns in tiles of at most 32; 129 rows at width 3
    (5, 40, 4, 2, 1, 8), (32, 64, 4, 4, 6, 6), (129, 3, 4, 2, 9, 9)])
def test_bands_and_blocks(N, M, es, tiles, bands, warps):
    lay = _layout(1, 8192, 8192, N, M, es=es)
    assert (len(lay.tiles), lay.nbands, lay.warps) == (tiles, bands, warps)
    # the tiles cover the footprint once, in tiles of at most 32 columns
    # and of bands of at most nb rows
    cover = np.zeros((N, M), int)
    for t in lay.tiles:
        cover[t.n0:t.n0 + t.n, t.m0:t.m0 + t.m] += 1
        assert t.m <= lay.mb <= 32 and t.n <= lay.nbands * lay.nb
        bands_t = lay.bands(t.n)
        assert bands_t[0][0] == 0 and sum(r for _, r in bands_t) == t.n
        assert all(n0 + r == n1 for (n0, r), (n1, _) in
                   zip(bands_t, bands_t[1:]))
        assert max(r for _, r in bands_t) <= lay.nb
    assert (cover == 1).all()
    assert lay.nb == engine.WGRAD_BAND_ROWS[lay.V][lay.mb]
    assert lay.warps * engine.WARP <= (
        256 if engine.wgrad_wide(lay.mb) else 512)
    assert lay.warps == lay.nbands * lay.row_groups
    assert lay.smem <= engine.SMEM_LIMIT
    assert 2 <= lay.stages <= engine.WGRAD_MAX_STAGES
    assert lay.blocks_per_sm == 1 and lay.grid == 132
    assert lay.smem + 1024 <= engine.H100_SM_SMEM
    assert lay.launches == tiles + 1


@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 7, 9, 20, 32, 40])
def test_box_starts_are_16_byte_aligned(M, mode):
    for es in (4, 2):
        lay = _layout(2, 64, 1000, 3, M, mode, es)
        lx = (M - 1) // 2 if mode == "same" else 0
        SW = engine.WARP * lay.V
        gh, x, end = lay.regions
        assert gh % 128 == 0 and x % 128 == 0 and end <= lay.stage_bytes
        for t in lay.tiles:
            assert t.goff + t.d == lx - t.m0 - (t.m - 1) and 0 <= t.d < lay.V
            assert lay.hw % lay.V == 0 and lay.hw >= t.d + t.m - 1
            for u in range(lay.units):
                _, _, sx = lay.unit(u)
                for col in (sx * SW, sx * SW + t.goff,
                            sx * SW + t.goff + SW):
                    assert (col * es) % engine.TMA_ALIGN == 0


def test_layout_refuses_what_it_cannot_hold():
    # every footprint is held (tiles); the walk counts units in 31 bits
    assert len(_layout(1, 300, 64, 129, 3).tiles) == 2
    assert len(_layout(1, 300, 300, 64, 65).tiles) == 6
    with pytest.raises(ValueError, match="31 bits"):
        _layout(2 ** 25, 128, 8192, 5, 5)
    x, g = torch.zeros(9, 40), torch.zeros(9, 40)
    assert engine.WGRAD_KERNEL.launches_for(
        x, g, plan=ssam_conv2d.plan_for((3, 33), "same")) == 2


def test_launches_for():
    p = ssam_conv2d.plan_for((5, 5), "same")
    K3 = engine.WGRAD_KERNEL
    # one block: its partial is the result; else the pass that adds them
    assert K3.launches_for(torch.zeros(20, 100), torch.zeros(20, 100),
                           plan=p) == 1
    assert K3.launches_for(torch.zeros(200, 300), torch.zeros(200, 300),
                           plan=p) == 2
    # a tile each, then the pass that adds the partials
    p = ssam_conv2d.plan_for((32, 32), "same")
    assert K3.launches_for(torch.zeros(200, 300), torch.zeros(200, 300),
                           plan=p) == 3


def test_kernel_tables_match_the_layout(monkeypatch):
    # the kernels' instantiations and band rows come from the layout's
    # table, in a header the build writes; the sources hold no table
    import pathlib

    from repro_torch import _build

    head = _build.GENERATED["ssam_wgrad_table.h"]
    assert head == engine.wgrad_table_header()
    for V, name in ((4, "SSAM_WGRAD_F32"), (8, "SSAM_WGRAD_BF16")):
        line = next(ln for ln in head.splitlines()
                    if ln.startswith(f"#define {name}(X)"))
        assert line.split("(X) ")[1] == " ".join(
            f"X({mb}, {nb})" for mb, nb in engine.WGRAD_BAND_ROWS[V].items())
    assert f"#define SSAM_WGRAD_WIDE_FROM {engine.WGRAD_WIDE_FROM}" in head
    csrc = pathlib.Path(engine.__file__).resolve().parents[1] / "csrc"
    assert '#include "ssam_wgrad_table.h"' in (
        csrc / "ssam_wgrad.cuh").read_text()
    for name, macro in (("ssam_wgrad_f32.cu", "SSAM_WGRAD_F32(SSAM_WG)"),
                        ("ssam_wgrad_bf16.cu", "SSAM_WGRAD_BF16(SSAM_WG)")):
        assert macro in (csrc / name).read_text()
    # another table is another library
    before = _build._source_hash()
    monkeypatch.setitem(_build.GENERATED, "ssam_wgrad_table.h", head + "\n")
    assert _build._source_hash() != before
    cmd = _build.compile_command(csrc / "ssam_wgrad_f32.cu",
                                 pathlib.Path("k.o"), include=pathlib.Path(
                                     "inc"))
    assert cmd[cmd.index("-I") + 1] == "inc"


# A strided plan's weight gradient: each phase (pn, pm) of the filter is
# the stride-1 gradient of x's phase image (engine.wgrad_phases,
# engine.wgrad_phase_images), PR 22's walk unchanged, one launch set a
# phase; jax.grad of the dense oracle subsampled is the witness
STRIDED_CASES = [
    ((37, 70), (5, 5), "same", (2, 2), "float32", None),
    ((3, 29, 83), (5, 5), "same", (1, 2), "float32", 2),
    ((37, 70), (4, 7), "valid", (3, 3), "float32", None),
    ((2, 31, 40), (5, 5), "valid", (2, 1), "bfloat16", None),
    ((40, 130), (1, 3), "same", (2, 3), "float32", 1),
]


@pytest.mark.parametrize("xs,filt,mode,stride,dtype,max_grid", STRIDED_CASES,
                         ids=str)
def test_strided_emulation_matches_plain_version_and_oracle(
        xs, filt, mode, stride, dtype, max_grid):
    x, _, p, xn, _ = _operands(xs, filt, mode, dtype)
    p = dataclasses.replace(p, stride=stride)
    gn = np.random.default_rng(41).standard_normal(
        tuple(xs[:-2]) + p.out_shape(xs[-2:])).astype(np.float32)
    g = torch.from_numpy(gn).to(getattr(torch, dtype))
    gn = g.float().numpy()
    got = engine.emulate_wgrad_kernel(x, g, plan=p, max_grid=max_grid)
    _close(got.numpy(), engine.run_weight_grad_plan_reference(
        x, g, plan=p).numpy(), TOL[dtype])
    # the oracle: the dense correlation's gradient with the cotangent
    # scattered onto the lattice the stride keeps
    dense = tuple(xs[:-2]) + _plan(xs, filt, mode).out_shape(xs[-2:])
    full = np.zeros(dense, np.float32)
    full[..., ::stride[0], ::stride[1]] = gn
    _close(got.numpy(), _oracle(xn, full, filt, mode), TOL[dtype])
    # every phase's layout fits the card; the launches add up per phase
    x3 = x.reshape((-1,) + tuple(xs[-2:]))
    phases = engine.wgrad_phases(p)
    lays = engine._wgrad_geometry(x, g, p)[3]
    assert len(phases) == len(lays) == min(stride[0], filt[0]) * min(
        stride[1], filt[1])
    assert all(lay.smem <= engine.SMEM_LIMIT for lay in lays)
    assert engine.WGRAD_KERNEL.launches_for(x, g, plan=p) == sum(
        lay.launches for lay in lays)
    assert engine.wgrad_phase_images(x3, stride).shape[:2] == stride


def test_strided_layout_at_8192_squared():
    """A 5x5 at stride 2 on 8192²: four phases of 3x3, 3x2, 2x3 and 2x2
    taps on 4096² phase images, each one tile."""
    p = dataclasses.replace(ssam_conv2d.plan_for((5, 5), "same"),
                            stride=(2, 2))
    phases = engine.wgrad_phases(p)
    assert [(ph.n, ph.m) for ph in phases] == [(3, 3), (3, 2), (2, 3),
                                              (2, 2)]
    # lead 2 = 2·1 + 0 for phase 0, 2·1 + 1 − 1 for phase 1 of x
    assert [ph.lead for ph in phases] == [(1, 1)] * 4
    assert [ph.xphase for ph in phases] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for ph in phases:
        lay = engine.wgrad_layout(1, 4096, 4096, 4096, 4096, ph.n, ph.m,
                                  lead=ph.lead)
        assert len(lay.tiles) == 1 and lay.smem <= engine.SMEM_LIMIT
