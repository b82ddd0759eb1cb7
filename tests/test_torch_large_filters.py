"""Filters of any size, on the CPU, against the JAX package.

The port's plain versions of ``ops.conv2d`` ('same', 'valid', batched and
NCHW) are held to ``repro.kernels.ref`` for footprints that one walk of
K1's warp does not hold (33 x 33, 51 x 5, 5 x 51, 1 x 127, 64 x 64) on
grids of about 100 x 140, and the NCHW backward of filters of more than
64 taps (a 9 x 9 'same', AlexNet's 11 x 11 at stride 4) to ``jax.grad``
of the JAX package's ``ops.conv2d(impl="xla")`` (the windowed JAX engine
is never called, ROADMAP R1). The kernels' CPU walks are held to the plain
version: K1's banded walk (``engine.band_walk``, the banded
instantiations' rows, one fp32 accumulator a tile), K2's streamed walk
(``engine.mxu_streamed``: the B tiles a group of entries at a time through
two ring slots, the sums carried across groups, F3's vote on the final
sums) and K3's channel layout beyond 64 taps. Inputs from a numpy seed.
Tolerance: fp32 ``rtol = 3e-5, atol = 3e-5·max|ref|`` (DESIGN.md §6),
bf16 3e-2.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import engine
from repro_torch.kernels import ops, ssam_conv2d, ssam_stencil2d, \
    ssam_stencil3d, stencils

FOOTPRINTS = [(33, 33), (51, 5), (5, 51), (1, 127), (64, 64)]


def _close(got, want, rtol=3e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("nm", FOOTPRINTS, ids=lambda nm: f"{nm[0]}x{nm[1]}")
def test_plain_versions_match_the_jax_reference(nm):
    """'same' and 'valid' on one image, 'same' on a batch of two."""
    N, M = nm
    x = _np((2, 100, 140), N * 1000 + M)
    w = _np(nm, N * 1000 + M + 1, (N * M) ** -0.5)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    _close(ops.conv2d(torch.from_numpy(x[0]), tw, mode="same"),
           jref.conv2d_same(jnp.asarray(x[0]), jw))
    _close(ops.conv2d(torch.from_numpy(x[0]), tw, mode="valid"),
           jref.conv2d_valid(jnp.asarray(x[0]), jw))
    _close(ops.conv2d(torch.from_numpy(x), tw, mode="same"),
           jref.conv2d_batched(jnp.asarray(x), jw, "same"))


NCHW = [
    # (x shape, w shape, mode, stride)
    ((2, 3, 14, 17), (4, 3, 9, 9), "same", (1, 1)),
    ((2, 3, 31, 35), (5, 3, 11, 11), "valid", (4, 4)),
]


@pytest.mark.parametrize("case", NCHW, ids=lambda c: f"{c[1][2]}x{c[1][3]}")
def test_nchw_backward_beyond_64_taps_matches_jax_grad(case):
    """Forward against ``jref.conv2d_nchw`` (strided by slicing), ``dx``
    and ``dW`` against ``jax.grad`` of the JAX package's ``conv2d``."""
    xs, ws, mode, stride = case
    x, w = _np(xs, 5), _np(ws, 6, (ws[1] * ws[2] * ws[3]) ** -0.5)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = ops.conv2d(tx, tw, mode=mode, stride=stride)
    full = np.asarray(jref.conv2d_nchw(jnp.asarray(x), jnp.asarray(w), mode))
    _close(y, full[..., ::stride[0], ::stride[1]])
    g = _np(tuple(y.shape), 7)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))

    def loss(xx, ww):
        out = jops.conv2d(xx, ww, mode=mode, stride=stride, impl="xla")
        return jnp.sum(out * jnp.asarray(g))

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(dx, jdx)
    _close(dw, jdw)


def _emulated(strategy, nm, shape, *, dtype=torch.float32,
              variant="shift_psum", batched=False):
    x = torch.from_numpy(_np(shape, 11)).to(dtype)
    w = torch.from_numpy(_np(nm, 12, (nm[0] * nm[1]) ** -0.5))
    build = ssam_conv2d.plan_for_batched if batched else ssam_conv2d.plan_for
    p = dataclasses.replace(build(nm, "same"), strategy=strategy)
    if strategy == "mxu":
        got = engine.emulate_mxu_kernel(x, w, plan=p)
    else:
        got = engine.emulate_window_kernel(x, w, plan=p, variant=variant)
    return got, engine.run_window_plan_reference(x, w, plan=p), p


# (footprint, grid): K1's bands of at most 32 rows and 17 columns
BANDED = [((33, 33), (40, 50)), ((64, 64), (20, 30)), ((51, 5), (60, 20)),
          ((5, 51), (12, 60)), ((1, 127), (4, 140)), ((127, 1), (140, 4)),
          ((1, 255), (3, 260)), ((255, 1), (260, 3))]


@pytest.mark.parametrize("nm,shape", BANDED, ids=lambda v: "x".join(
    map(str, v)))
def test_banded_walk_matches_plain_version(nm, shape):
    got, want, p = _emulated("lanes", nm, shape)
    assert engine.banded(p) and engine.tap_table_refusal(p) is None
    _close(got, want)


def test_banded_walk_schedule():
    """33 x 33: three row bands of 11 rows (a banded instantiation's, so
    every column step is dense) by two column bands of 17 and 16; every
    tap once; shift_data walks the same records; bf16 at 3e-2."""
    p = ssam_conv2d.plan_for((33, 33), "same")
    steps, records, taps = engine.band_walk(p)
    assert engine.window_inst(p) == (1, 11)
    assert [(r[3] & 0xFFFF, r[3] >> 16, r[2] & 255, r[2] >> 16)
            for r in records] == [(r0, c0, 11, m) for r0 in (0, 11, 22)
                                  for c0, m in ((0, 17), (17, 16))]
    assert len(taps) == 33 * 33 and all(st[3] for st in steps)
    assert sorted((t.row_offset, t.coeff_id) for _, t in taps) == sorted(
        (t.row_offset, t.coeff_id) for st in p.steps for t in st.taps)
    got, want, _ = _emulated("lanes", (33, 33), (40, 50),
                             variant="shift_data")
    _close(got, want)
    got, want, _ = _emulated("lanes", (33, 33), (2, 40, 50),
                             dtype=torch.bfloat16, batched=True)
    assert got.dtype == torch.bfloat16
    _close(got, want.float(), 3e-2)


def test_banded_depthwise_filter_per_image():
    """A depthwise 51 x 5 over 2 x 3 images, a filter each, one banded
    walk (the tap records rewritten per image)."""
    x = torch.from_numpy(_np((2, 3, 40, 30), 13))
    w = torch.from_numpy(_np((3, 1, 51, 5), 14, 51 ** -0.5))
    p = ops.depthwise_plan(tuple(x.shape), tuple(w.shape), groups=3,
                           mode="same")
    assert p is not None and engine.banded(p)
    got = engine.emulate_window_kernel(x.reshape(6, 40, 30), w.reshape(3, 51, 5),
                                       plan=p)
    _close(got.reshape(x.shape), ops.conv2d(x, w, groups=3))


def test_banded_limits_refuse_by_name():
    """129 x 129 needs 40 bands (K1 holds 32), 1 x 600 36; a strided plan
    beyond one walk is refused: each names ROADMAP Queue 2."""
    for nm, what in (((129, 129), "40 bands"), ((1, 600), "36 bands")):
        why = engine.tap_table_refusal(ssam_conv2d.plan_for(nm, "same"))
        assert what in why and "ROADMAP Queue 2" in why
    sp = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                             stride=(2, 2))
    assert "output stride" in engine.tap_table_refusal(sp)


# (footprint, grid): K2's streamed walk (more than 1024 taps) and the
# resident one, whatever the size of the B tiles (255 x 1: 64 KB)
STREAMED = [((33, 33), (40, 50)), ((64, 64), (20, 30))]
RESIDENT = [((51, 5), (60, 20)), ((5, 51), (12, 60)), ((1, 127), (4, 140)),
            ((127, 1), (140, 4)), ((255, 1), (40, 3))]


@pytest.mark.parametrize("nm,shape", STREAMED + RESIDENT,
                         ids=lambda v: "x".join(map(str, v)))
def test_mxu_walk_matches_plain_version(nm, shape):
    got, want, p = _emulated("mxu", nm, shape)
    assert engine.mxu_streamed(p) == ((nm, shape) in STREAMED)
    assert engine.mxu_chain_refusal(p) is None
    _close(got, want)


def _box_stencil(name, ndim, exts):
    offsets = tuple(itertools.product(*(range(n) for n in exts)))
    sd = stencils.StencilDef(name, ndim, offsets,
                             stencils._norm_coeffs(len(offsets)), 1, 0)
    mod = ssam_stencil2d if ndim == 2 else ssam_stencil3d
    return dataclasses.replace(mod.plan_for(sd), strategy="mxu")


# Plans of at most 1024 taps whose B tiles pass 32 KB and which K2's
# streamed walk would refuse (an output stride, 3-D, t > 1): they keep
# their tiles resident. (name, plan, time steps, grid, full-size grid)
RESIDENT_BEYOND_32KB = [
    ("11x11 stride 4", dataclasses.replace(
        ssam_conv2d.plan_for((11, 11), "valid"), stride=(4, 4),
        strategy="mxu"), 1, (47, 61), (8192, 8192)),
    ("5x5x27 3-D", _box_stencil("box5x5x27", 3, (5, 5, 27)), 1,
     (6, 9, 40), (512, 512, 512)),
    ("31x31 t=2", _box_stencil("box31x31", 2, (31, 31)), 2, (70, 45),
     (8192, 8192)),
]


@pytest.mark.parametrize("case", RESIDENT_BEYOND_32KB, ids=lambda c: c[0])
def test_mxu_resident_beyond_32kb_of_tiles(case):
    """K2 streams only the B tiles a block cannot keep: these plans' tiles
    (8448, 9600 and 11904 words) stay resident, their full-size layout
    builds with no stream, and the resident walk equals the plain
    version."""
    _, p, t, shape, full = case
    assert engine._mxu_b_shape(p)[1] > 8192
    assert not engine.mxu_streamed(p) and engine.mxu_chain_refusal(p) is None
    nd = p.ndim_spatial
    block = engine.default_block(p, t)
    out = p.out_shape(full, t)
    lead = tuple(t * v for v in p.lead_trail()[0])
    pad3 = (1,) * (3 - nd)
    head = (1,) + pad3 + full + pad3 + tuple(out) + (0,) * (3 - nd) + lead
    w_shape = p.exts if p.coeff_mode == "dense" else None
    lay = engine.mxu_layout(p, head, pad3 + block, t, 4, full[-1],
                            engine.mxu_entries(p, w_shape))
    assert lay.stream is None and lay.smem <= engine.SMEM_LIMIT
    x = torch.from_numpy(_np(shape, 21))
    w = torch.from_numpy(_np(p.exts, 22, 1 / 11)) if w_shape else None
    _close(engine.emulate_mxu_kernel(x, w, plan=p, time_steps=t),
           engine.run_window_plan_reference(x, w, plan=p, time_steps=t))


def test_mxu_stream_groups_and_layout():
    """64 x 64 at 8192²: 192 entries (three a row: 25, 25 and 14
    columns) in groups of whole entries that fill a slot, the layout's
    smem within one block, its geometry's last three ints the groups;
    the streamed bf16 walk at 3e-2; a row of 255 columns refused (one TMA
    box)."""
    p = dataclasses.replace(ssam_conv2d.plan_for((64, 64), "same"),
                            strategy="mxu")
    ents = engine.mxu_entries(p, (64, 64))
    assert len(ents.entries) == 192 and ents.b_words == 64 * 704
    block = engine.default_block(p)
    head = (1, 1, 8192, 8192, 1, 8192, 8192, 0, 31, 31)
    lay = engine.mxu_layout(p, head, (1,) + block, 1, 4, 8192, ents)
    st = lay.stream
    assert st is not None and lay.smem <= engine.SMEM_LIMIT
    assert sum(g[1] for g in st.groups) == 192
    assert all(g[3] <= st.slot_words for g in st.groups)
    assert [g[2] for g in st.groups] == [ents.entries[g[0]][5]
                                         for g in st.groups]
    assert lay.geom[43:] == (len(st.groups), st.slot_words, len(ents.table))
    assert lay.table[len(ents.table):] == tuple(
        v for g in st.groups for v in g)
    got, want, _ = _emulated("mxu", (33, 33), (1, 30, 40),
                             dtype=torch.bfloat16, batched=True)
    _close(got, want.float(), 3e-2)
    wide = dataclasses.replace(ssam_conv2d.plan_for((1, 255), "same"),
                               strategy="mxu")
    assert "TMA box" in engine.mxu_chain_refusal(wide)


def test_mxu_streamed_nonfinite_reach():
    """An inf and a nan in x under the 33 x 33 streamed walk: the
    non-finite outputs are exactly the plain version's (the vote on the
    sums carried across groups, the re-sum over every group's entries),
    the rest equal."""
    x = torch.from_numpy(_np((40, 50), 15))
    x[11, 20], x[30, 31] = float("inf"), float("nan")
    w = torch.from_numpy(_np((33, 33), 16, 1 / 33))
    p = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                            strategy="mxu")
    got = engine.emulate_mxu_kernel(x, w, plan=p)
    want = engine.run_window_plan_reference(x, w, plan=p)
    bad = ~torch.isfinite(want)
    assert bad.any() and torch.equal(~torch.isfinite(got), bad)
    _close(got[~bad], want[~bad])


@pytest.mark.parametrize("t,dt", [(2, "float32"), (3, "float32"),
                                  (2, "bfloat16")], ids=str)
def test_mxu_streamed_time_steps(t, dt):
    """A 33 x 33 box stencil (1089 taps, streamed) at t > 1: each
    application walks every group again, its sums carried in the buffer
    its iterate then takes; the layout of the dtype's default tile at
    8192² fits one block and its two sums buffers hold the iterates; the
    walk equals the plain version, and an inf and a nan reach exactly the
    plain version's outputs."""
    p = _box_stencil("box33x33", 2, (33, 33))
    assert engine.mxu_streamed(p) and engine.mxu_chain_refusal(p) is None
    dtype = getattr(torch, dt)
    es = torch.empty((), dtype=dtype).element_size()
    block = engine.default_block(p, t, es)
    head = (1, 1, 8192, 8192, 1, 8192, 8192, 0, 16 * t, 16 * t)
    lay = engine.mxu_layout(p, head, (1,) + block, t, es, 8192,
                            engine.mxu_entries(p, None))
    assert lay.stream is not None and lay.smem <= engine.SMEM_LIMIT
    for k in range(t):
        g = t - 1 - k
        need = (block[0] + 32 * g) * engine.mxu_pitch(block[1] + 32 * g)
        assert need <= lay.bufs[1 + (k & 1)]
    x = torch.from_numpy(_np((50, 70), 23)).to(dtype)
    if dt == "float32":
        x[17, 20], x[40, 61] = float("inf"), float("nan")
    got = engine.emulate_mxu_kernel(x, plan=p, time_steps=t).float()
    want = engine.run_window_plan_reference(x, plan=p, time_steps=t).float()
    bad = ~torch.isfinite(want)
    assert torch.equal(~torch.isfinite(got), bad)
    assert bad.any() == (dt == "float32")
    _close(got[~bad], want[~bad], 3e-5 if dt == "float32" else 3e-2)
