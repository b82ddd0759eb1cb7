"""K2 with fused stages, and chains cut into segments, on the CPU.

``ops.pipeline(strategy="mxu")`` runs a chain as one launch of K2's
single-channel kernel (``csrc/ssam_mxu.cuh``, instantiated for chains in
``ssam_mxu_chain.cu``); its CPU walk, ``engine.emulate_mxu_kernel`` on a
fused plan (each stage's entries and Toeplitz B tiles, its own shrink, its
mid-chain ops after the non-finite check, the ping-pong iterates), is held
to the plain version (``engine._apply_stages`` on ``apply_plan_mxu``),
and the plain version to the JAX package's ``ops.pipeline(strategy="mxu",
impl="xla")`` and ``jax.grad`` of it (the JAX windowed engine is never
called, ROADMAP R1). ``engine.mxu_chain_refusal`` and
``ops.chain_segments`` are pure functions of the plans; a chain that no
launch holds runs as ``ops.pipeline_segments``, which on the CPU runs
each segment's plain version and equals the fused plain version.
Tolerance: fp32 ``rtol = 3e-5, atol = 3e-5·max|want|`` (DESIGN.md §6),
gradients 3e-5·max|leaf|, bf16 3e-2.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import adjoint, engine, fuse
from repro_torch.kernels import ops, ssam_conv2d

CSRC = Path(engine.__file__).resolve().parents[1] / "csrc"


def _close(got, want, rtol=3e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _desc(chain, w5, w3, mk):
    """A descriptor chain with ``"W5"``/``"W3"`` standing for the filters
    (numpy), made into ``mk``'s arrays; tuples carry epilogues."""
    def one(d):
        if isinstance(d, tuple):
            return (one(d[0]), d[1])
        return {"W5": mk(w5), "W3": mk(w3)}.get(d, d) \
            if isinstance(d, str) else d
    return [one(d) for d in chain]


def _fused(x, chain, strategy="mxu"):
    """``(plans, fused plan, filters)`` of a descriptor chain."""
    res = [ops._pipeline_stage_plan(x, d, i) for i, d in enumerate(chain)]
    plans = [ops._strategy_plan(p, strategy, "pipeline") for p, _ in res]
    return plans, fuse.fuse_plans(*plans), tuple(w for _, w in res)


def _epi(codes, shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape if c == "r" else (1,)).astype(
        np.float32) for c in codes)


W5 = _x((5, 5), 1) / 5
W3 = _x((3, 3), 2) / 3
CONV = [("W5", ("bias", "gelu")), ("W3", "bias"), ("W5", "residual_add")]


# ---------------------------------------------------------------------------
# K2's walk of a chain against the plain version
# ---------------------------------------------------------------------------

WALK = [
    ("2d", (37, 61), ["2d5pt", "2d9pt", "2d5pt"], (), None),
    # the later stages have fewer rows than the first
    ("2d-rows", (29, 70), ["2d25pt", ("2d5pt", ("relu", ("scale", 0.5))),
                           "2d9pt"], (), (16, 32)),
    ("conv", (33, 47), CONV, ("b", "b", "r"), None),
    ("3d", (9, 11, 37), ["3d7pt", "3d27pt"], (), (4, 8, 16)),
    ("bf16", (25, 41), ["2d9pt", ("2d5pt", "bias")], ("b",), None),
]


@pytest.mark.parametrize("case", WALK, ids=lambda c: c[0])
def test_chain_walk_matches_plain_version(case):
    tag, shape, chain, codes, block = case
    x = torch.from_numpy(_x(shape, 3))
    if tag == "bf16":
        x = x.to(torch.bfloat16)
    _, p, ws = _fused(x, _desc(chain, W5, W3, torch.from_numpy))
    args = tuple(map(torch.from_numpy, _epi(codes, shape, 4)))
    got = engine.emulate_mxu_kernel(x, ws, plan=p, block=block,
                                    epilogue_args=args)
    want = engine.run_window_plan_reference(x, ws, plan=p, block=block,
                                            epilogue_args=args)
    assert got.dtype == x.dtype and p.strategy == "mxu"
    _close(got, want, 3e-5 if tag != "bf16" else 3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_walk_nonfinite_set_is_the_plain_versions(dtype):
    """An inf and a nan reach a stage's iterate: the walk re-sums every
    item whose sums are not finite in every application, so its
    non-finite set is the plain version's. The reference's oracle
    materializes each stage's dense filter, whose zeros meet the inf too:
    its non-finite set holds the plain version's, and the values agree
    where it is finite."""
    xn = _x((41, 67), 5)
    xn[20, 30] = np.inf
    xn[5, 60] = np.nan
    x = torch.from_numpy(xn).to(getattr(torch, dtype))
    chain = ["2d5pt", ("2d9pt", "gelu"), "2d5pt"]
    _, p, ws = _fused(x, chain)
    got = engine.emulate_mxu_kernel(x, ws, plan=p, block=(16, 32))
    want = engine.run_window_plan_reference(x, ws, plan=p, block=(16, 32))
    xj = jnp.asarray(x.float().numpy())
    if dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    ref = torch.from_numpy(np.array(jops.pipeline(
        xj, chain, impl="xla", strategy="mxu"), np.float32))
    rtol = 3e-5 if dtype == "float32" else 3e-2
    got, want = got.float(), want.float()
    bad = ~torch.isfinite(want)
    assert bad.any() and torch.equal(~torch.isfinite(got), bad)
    _close(got[~bad], want[~bad], rtol)
    ok = torch.isfinite(ref)
    assert not (ok & bad).any()
    _close(want[ok], ref[ok], rtol)


# ---------------------------------------------------------------------------
# The plain version against the reference
# ---------------------------------------------------------------------------

REF = [
    ("2d", (40, 72), ["2d5pt", "2d9pt", "2d5pt"], ()),
    ("mid-ops", (40, 72), [("2d5pt", "relu"), ("2d9pt", ("scale", 0.5)),
                           ("2d25pt", "silu")], ()),
    ("conv", (30, 50), CONV, ("b", "b", "r")),
    ("3d", (10, 14, 40), ["3d7pt", "3d27pt"], ()),
]


@pytest.mark.parametrize("case", REF, ids=lambda c: c[0])
def test_mxu_pipeline_matches_reference(case):
    tag, shape, chain, codes = case
    xn = _x(shape, 6)
    args = _epi(codes, shape, 7)
    got = ops.pipeline(torch.from_numpy(xn),
                       _desc(chain, W5, W3, torch.from_numpy),
                       strategy="mxu",
                       epilogue_args=tuple(map(torch.from_numpy, args)))
    want = jops.pipeline(jnp.asarray(xn), _desc(chain, W5, W3, jnp.asarray),
                         impl="xla", strategy="mxu",
                         epilogue_args=tuple(map(jnp.asarray, args)))
    _close(got, want)


def test_mxu_linear_chain_gradient_is_one_reversed_launch():
    xn = _x((28, 56), 8)
    chain = ["2d5pt", "2d9pt"]
    x = torch.from_numpy(xn).requires_grad_(True)
    adjoint.reset_lowering_counts()
    ops.pipeline(x, chain, strategy="mxu").sum().backward()
    assert dict(adjoint.BACKWARD_LOWERINGS) == {
        "pipe2_adj_stencil2d+adj_stencil2d": 1}
    want = jax.grad(lambda v: jnp.sum(jops.pipeline(
        v, chain, impl="xla", strategy="mxu")))(jnp.asarray(xn))
    _close(x.grad, want)


def test_mxu_conv_chain_gradients_stage_by_stage(monkeypatch):
    """The conv chain's backward: a recompute and a dx a stage on the
    mxu strategy (2 engine calls a stage, every one pinned to mxu) and a
    dW a dense stage, each leaf against ``jax.grad``."""
    xn, rn = _x((24, 40), 9), _x((24, 40), 10)
    b = [np.float32(v).reshape(1) for v in (0.5, -0.25)]
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xn, W5, W3, *b, rn)]
    x, w5, w3, b0, b1, r = leaves
    chain = lambda f5, f3: [(f5, ("bias", "gelu")), (f3, "bias"),
                            (f5, "residual_add")]
    seen = []
    real = engine.run_window_plan

    def spy(xx, w=None, **kw):
        seen.append(kw["plan"].strategy)
        return real(xx, w, **kw)

    y = ops.pipeline(x, chain(w5, w3), strategy="mxu",
                     epilogue_args=(b0, b1, r))
    monkeypatch.setattr(engine, "run_window_plan", spy)
    adjoint.reset_lowering_counts()
    (y ** 2).sum().backward()
    assert seen == ["mxu"] * 6
    assert adjoint.BACKWARD_LOWERINGS["wgrad_conv2d"] == 3
    want = jax.grad(lambda v, f5, f3, c0, c1, rr: jnp.sum(jops.pipeline(
        v, chain(f5, f3), impl="xla", strategy="mxu",
        epilogue_args=(c0, c1, rr)) ** 2), tuple(range(6)))(
        *map(jnp.asarray, (xn, W5, W3, *b, rn)))
    for got, exp in zip(leaves, want):
        _close(got.grad, exp)


# ---------------------------------------------------------------------------
# What one launch holds, and the cut of a chain
# ---------------------------------------------------------------------------

def _stages(names, strategy=None):
    x = torch.zeros(16, 16)
    return [ops._strategy_plan(ops._pipeline_stage_plan(x, n, i)[0],
                               strategy, "pipeline")
            for i, n in enumerate(names)]


def test_mxu_chain_refusal_is_a_pure_function_of_the_plan():
    refuse = lambda names: engine.mxu_chain_refusal(
        fuse.fuse_plans(*_stages(names, "mxu")))
    assert refuse(["2d121pt"] * 3) is None
    assert refuse(["2d5pt", "2d9pt", "2d5pt"]) is None
    assert "33 stages" in refuse(["2d5pt"] * 33)
    assert "1089 taps" in refuse(["2d121pt"] * 9)
    relu6 = [("2d5pt", ("relu",) * 6)] * 3 + ["2d5pt"]
    assert "18 mid-chain epilogue ops" in refuse(relu6)
    big = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                              strategy="mxu")
    p5 = _stages(["2d5pt"], "mxu")[0]
    # a 33 x 33 stage alone streams its B tiles; no chain fuses it
    assert engine.mxu_chain_refusal(fuse.fuse_plans(p5, big)).startswith(
        "stage 1 (conv2d): its B tiles pass what a K2 block keeps")
    assert engine.mxu_chain_refusal(p5) is None
    assert engine.mxu_chain_refusal(big) is None
    huge = dataclasses.replace(ssam_conv2d.plan_for((129, 129), "same"),
                               strategy="mxu")
    assert "774 entries" in engine.mxu_chain_refusal(huge)
    with pytest.raises(NotImplementedError, match="Queue 2, K2"):
        engine.mxu_chain_table(fuse.fuse_plans(*_stages(["2d5pt"] * 33,
                                                        "mxu")))


def test_chain_segments_cut_greedily():
    big = _stages(["2d121pt"] * 3)
    # 33 column steps: K1 holds 32 a launch, K2 all of them
    assert ops.chain_segments(big) == [(0, 1), (2,)]
    assert ops.chain_segments(_stages(["2d121pt"] * 3, "mxu"),
                              "mxu") == [(0, 1, 2)]
    assert ops.chain_segments(_stages(["2d5pt", "2d9pt", "2d5pt"])) == [
        (0, 1, 2)]
    # 2d5pt has 3 column steps: 10 stages a K1 launch; K2 holds 32 stages
    many = _stages(["2d5pt"] * 33)
    assert [len(s) for s in ops.chain_segments(many)] == [10, 10, 10, 3]
    assert [len(s) for s in ops.chain_segments(
        _stages(["2d5pt"] * 33, "mxu"), "mxu")] == [32, 1]
    # a stage that one launch holds only alone (K1 in bands, K2 streaming
    # its B tiles) is a segment of its own
    wide = ssam_conv2d.plan_for((3, 33), "same")
    assert ops.chain_segments(_stages(["2d5pt"]) + [wide]) == [(0,), (1,)]
    big = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                              strategy="mxu")
    assert ops.chain_segments([big] + _stages(["2d5pt"] * 2, "mxu"),
                              "mxu") == [(0,), (1, 2)]
    # a stage no launch holds alone: nothing to cut
    huge = ssam_conv2d.plan_for((129, 129), "same")
    with pytest.raises(NotImplementedError, match="stage 1.*bands.*Queue 2"):
        ops.chain_segments(_stages(["2d5pt"]) + [huge])
    with pytest.raises(NotImplementedError,
                       match="stage 0.*entries.*Queue 2"):
        ops.chain_segments([dataclasses.replace(huge, strategy="mxu")]
                           + _stages(["2d5pt"], "mxu"), "mxu")


SEGMENTED = [
    ("lanes", (40, 70), ["2d121pt"] * 3, (), None),
    ("mxu", (40, 70), ["2d5pt"] * 33, (), "mxu"),
    ("conv", (36, 52), [("W5", ("bias", "gelu")), ("2d121pt", "bias"),
                        "2d121pt", ("2d121pt", "silu"),
                        ("W3", ("bias", "residual_add"))],
     ("b", "b", "b", "r"), None),
]


@pytest.mark.parametrize("case", SEGMENTED, ids=lambda c: c[0])
def test_segmented_sequence_equals_fused_plain_version(case):
    """Pad once, each segment valid-mode on the previous one's fp32
    output: the fused plain version's result and gradients (a linear
    chain's backward one adjoint launch a segment)."""
    tag, shape, chain, codes, strategy = case
    xn = _x(shape, 11)
    args = _epi(codes, shape, 12)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xn, W5, W3, *args)]

    def run(segmented):
        x, f5, f3, *epi = [a.detach().clone().requires_grad_(True)
                           for a in leaves]
        plans, p, ws = _fused(x, _desc(chain, f5, f3, lambda t: t),
                              strategy)
        segs = ops.chain_segments(plans, strategy)
        assert len(segs) > 1
        if segmented:
            y = ops.pipeline_segments(x, plans, ws, tuple(epi), segs)
        else:
            y = engine.run_window_plan_reference(x, ws, plan=p,
                                                 epilogue_args=tuple(epi))
        (y ** 2).sum().backward()
        return y, [t.grad for t in (x, f5, f3, *epi)]

    adjoint.reset_lowering_counts()
    y, grads = run(True)
    if tag != "conv":       # linear: the reversed segments
        assert sum(adjoint.BACKWARD_LOWERINGS.values()) == 2
    want_y, want = run(False)
    _close(y, want_y)
    for g, e in zip(grads, want):
        if e is not None:
            _close(g, e)
    xb = torch.from_numpy(xn).to(torch.bfloat16)
    plans, p, ws = _fused(xb, _desc(chain, W5, W3, torch.from_numpy),
                          strategy)
    ea = tuple(torch.from_numpy(a) for a in args)
    got = ops.pipeline_segments(xb, plans, ws, ea,
                                ops.chain_segments(plans, strategy))
    assert got.dtype == torch.bfloat16
    _close(got, engine.run_window_plan_reference(xb, ws, plan=p,
                                                 epilogue_args=ea), 3e-2)


def test_adjoint_of_a_valid_mode_chain_is_full():
    """A segment runs its composite in valid mode; its adjoint is the
    reversed chain in 'full' mode, and a shape-preserving chain's adjoint
    is the frame fuse_plans sums (as before)."""
    p5, p9 = _stages(["2d5pt", "2d9pt"])
    same = fuse.fuse_plans(p5, p9)
    valid = dataclasses.replace(same, lead=None, trail=None)
    av = adjoint.input_adjoint_plan(valid)
    assert av.lead_trail() == ((6, 6), (6, 6))
    assert av.out_shape((20, 30)) == (26, 36)
    assert adjoint.input_adjoint_plan(same).lead_trail() == same.lead_trail()
    g = torch.from_numpy(_x((20, 30), 13))
    x = torch.from_numpy(_x((26, 36), 14)).requires_grad_(True)
    y = engine.run_window_plan_reference(x, (None, None), plan=valid)
    (want,) = torch.autograd.grad(y, x, g)
    _close(engine.run_window_plan_reference(g, (None, None), plan=av), want)


# ---------------------------------------------------------------------------
# K2's chain tables and layout
# ---------------------------------------------------------------------------

def test_mxu_chain_table_and_layout():
    """The stages' entries one after another (B offsets and column tables
    continued, coefficient indices into the concatenated array, the
    mid-chain bias after the filters), one record a stage; the iterates
    shrink by each stage's own footprint; the kernel's limits equal the
    engine's."""
    x = torch.zeros(40, 80)
    chain = [("W3", ("bias", "relu")), "2d25pt", "2d5pt"]
    _, p, _ = _fused(x, _desc(chain, W5, W3, torch.from_numpy))
    ct = engine.mxu_chain_table(p)
    parts = [engine.mxu_entries(st, st.exts if st.coeff_mode == "dense"
                                else None) for st in p.stages]
    counts = [len(e.entries) for e in parts]
    assert [r[:2] for r in ct.records] == [(0, 3), (3, 5), (8, 3)]
    assert counts == [3, 5, 3] and ct.ents.b_words == sum(
        e.b_words for e in parts)
    assert [(r[2] & 255, r[2] >> 16) for r in ct.records] == [
        (3, 3), (5, 5), (3, 3)]
    assert ct.records[0][3] == 0 | 2 << 8 and ct.records[1][3] == 0
    n25 = len(p.stages[1].coeffs)
    assert ct.mid == ((1, 0.0, 9 + n25 + len(p.stages[2].coeffs)),
                      (4, 0.0, -1))
    # stage 1's first entry: its B tiles after stage 0's, its column
    # table after every entry record, its indices past the 3x3 filter
    e = ct.ents.entries[3]
    assert e[5] == parts[0].b_words
    assert e[6] >= engine.MXU_ENT_INTS * 11
    cols = ct.ents.table[e[6]:e[6] + e[3]]
    assert min(c for c in cols if c >= 0) >= 9
    lay = engine.mxu_layout(p, (1, 1, 40, 80, 1, 40, 80, 0, 4, 4),
                            (1, 16, 64), 1, 4, 80, ct.ents)
    assert lay.chain == ct.ints() and lay.chain[:2] == (3, 2)
    # application 0 writes the tile widened by 4 + 2 (even), 1 by 2 (odd)
    assert lay.bufs[1] == (16 + 6) * engine.mxu_pitch(64 + 6)
    assert lay.bufs[2] == (16 + 2) * engine.mxu_pitch(64 + 2)
    assert lay.geom[1:5] == (1, 9, 9, 1)
    head = (CSRC / "ssam_mxu.cuh").read_text()
    assert int(re.search(r"kMxMaxChain = (\d+)", head).group(1)) == \
        engine.MXU_MAX_CHAIN
    assert int(re.search(r"kMxMaxMid = (\d+)", head).group(1)) == \
        engine.WINDOW_MAX_MID
    inst = (CSRC / "ssam_mxu_chain.cu").read_text()
    assert sorted(int(v) for v in re.findall(
        r"mxu_window_kernel<(\d), false, true>", inst)) == [1, 2, 3, 4]
    assert engine.default_block(p) == engine._mxu_block(p, 1)
