"""K1, K2, K3, K4 and K5 on the card against their plain versions (needs
a CUDA card).

This file imports only torch and the port, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every case skips. Tolerance: K1 fp32 3e-5 relative to
the largest plain value (DESIGN.md §6), bf16 3e-2; K1's channel-reduce
path and K3 fp32 rtol 1e-4 with atol 1e-4·max|plain| (sums over up to a
few thousand products taken in another order than the plain version's
per-tap contractions); K5 fp32 rtol 1e-5 with atol 1e-5·max|plain| (the
kernel and the plain version differ only in the order of the prefix
products), bf16 3e-2. K2 (3xTF32 on the tensor cores) against its plain
version at K1's tolerances (3e-5 single-channel, 1e-4 NCHW and its
phased dx, bf16 3e-2), and against K1 at 1e-4, the reference's
lanes-versus-mxu tolerance. K1's per-lane
(depthwise conv1d) path at fp32 3e-5, bf16 3e-2; K4 (per-lane weight
gradient, sums over B·T products in another order) at fp32 1e-4, bf16
3e-2; gradients through K1, K4 and K5 against the CPU's at 1e-4. A
depthwise conv2d (one K1 launch over its images, a filter each; K3 a
gradient per channel) against the CPU at 1e-4, bf16 3e-2; K2's
non-finite outputs exactly the plain version's. A fused pipeline (one
K1 launch for the chain, one K2 launch under ``strategy="mxu"``; a chain
no launch holds one launch a segment) against the plain version at K1's
tolerances, its gradients against the CPU's at 1e-4.
"""
import numpy as np
import pytest
import torch

import dataclasses
import itertools

from repro_torch import convert
from repro_torch.config import get_config
from repro_torch.configs import whisper_base
from repro_torch.core import adjoint, engine, fuse, plan
from repro_torch.data import TokenDataset
from repro_torch.configs import hymba_1g5b
from repro_torch.core.plan import normalize_epilogue
from repro_torch.kernels import ops, ref, ssam_conv1d, ssam_conv2d
from repro_torch.kernels import ssam_stencil2d
from repro_torch.kernels import ssam_stencil3d, stencils
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.nn import spec

pytestmark = pytest.mark.cuda
VARIANTS = engine.VARIANTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol=3e-5):
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale)


def _grid(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    return convert.from_numpy(rng.standard_normal(shape).astype(np.float32),
                              device)


def _box_stencil(name, exts):
    offsets = tuple(itertools.product(*(range(n) for n in exts)))
    return stencils.StencilDef(name, len(exts), offsets,
                               stencils._norm_coeffs(len(offsets)), 1, 0)


@pytest.mark.parametrize("name", sorted(stencils.BENCHMARKS))
def test_stencil_matches_plain_version(cuda, name):
    sd = stencils.BENCHMARKS[name]
    mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
    x = _grid((97, 203) if sd.ndim == 2 else (21, 30, 75), cuda)
    for variant in VARIANTS:
        for t in (1, 2, 3):
            got = ops.stencil(x, name, time_steps=t, variant=variant)
            _close(got, engine.run_window_plan_reference(
                x, plan=mod.plan_for(sd), time_steps=t, variant=variant))
            _close(got, ref.stencil_iterate(x, sd, t))


@pytest.mark.parametrize("k", [1, 2, 5, 20, 32])
@pytest.mark.parametrize("mode", ["valid", "same"])
def test_conv2d_matches_plain_version(cuda, mode, k):
    x = _grid((130, 260), cuda, 1)
    w = _grid((k, (k + 1) // 2), cuda, 2)
    for variant in VARIANTS:
        got = ops.conv2d(x, w, mode=mode, variant=variant)
        want = ref.conv2d_same(x, w) if mode == "same" \
            else ref.conv2d_valid(x, w)
        _close(got, want)
        _close(got, engine.run_window_plan_reference(
            x, w, plan=ssam_conv2d.plan_for(tuple(w.shape), mode),
            variant=variant))


def test_batched_conv_and_small_blocks(cuda):
    x = _grid((3, 50, 90), cuda, 3)
    w = _grid((5, 3), cuda, 4)
    for block in (None, (7, 13), (1, 1)):
        _close(ops.conv2d(x, w, mode="same", block=block),
               ref.conv2d_batched(x, w, "same"))


def test_bf16_io(cuda):
    x = _grid((64, 300), cuda, 5).to(torch.bfloat16)
    sd = stencils.BENCHMARKS["2d13pt"]
    got = ops.stencil(x, sd, time_steps=2)
    assert got.dtype == torch.bfloat16
    _close(got, engine.run_window_plan_reference(
        x, plan=ssam_stencil2d.plan_for(sd), time_steps=2), rtol=3e-2)


# K1's single-channel ring on its edges: pitches that are not a multiple of
# 16 bytes (a pitch-padded copy for TMA), a one-tile grid, t = 3, bf16 at
# odd widths, a 32 x 32 filter, the 3-D 5 x 5 x 5 box, several x-boxes.
RING_CASES = [
    ("2d5pt", (37, 41), None, 1),          # rows of 164 bytes
    ("2d9pt", (3, 45), None, 3),           # odd in every axis, t = 3
    ("2d121pt", (20, 33), (20, 33), 2),    # one tile: the whole output
    ("3d125pt", (9, 11, 13), None, 3),     # 5 x 5 x 5, ragged, t = 3
    ("poisson", (5, 6, 7), (5, 6, 7), 1),  # a one-tile 3-D grid
    ("2d13pt", (40, 700), (6, 600), 1),    # a tile of 3 x-boxes
]


@pytest.mark.parametrize("name,shape,block,t", RING_CASES, ids=str)
def test_ring_edge_cases(cuda, name, shape, block, t):
    sd = stencils.BENCHMARKS[name]
    mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
    x = _grid(shape, cuda, 7)
    p = mod.plan_for(sd)
    for variant in VARIANTS:
        got = engine.run_window_plan(x, plan=p, block=block, time_steps=t,
                                     variant=variant)
        _close(got, engine.run_window_plan_reference(
            x, plan=p, block=block, time_steps=t, variant=variant))
        _close(got, engine.emulate_window_kernel(
            x.cpu(), plan=p, block=block, time_steps=t,
            variant=variant).to(cuda))


@pytest.mark.parametrize("shape", [(33, 77), (2, 19, 101)])
def test_ring_bf16_at_odd_widths(cuda, shape):
    x = _grid(shape, cuda, 8).to(torch.bfloat16)
    w = _grid((5, 4), cuda, 9)
    for mode in ("same", "valid"):
        got = ops.conv2d(x, w, mode=mode)
        assert got.dtype == torch.bfloat16
        p = (ssam_conv2d.plan_for_batched((5, 4), mode) if len(shape) == 3
             else ssam_conv2d.plan_for((5, 4), mode))
        _close(got.float(), engine.run_window_plan_reference(
            x, w, plan=p).float(), rtol=3e-2)


def test_ring_thirty_two_by_thirty_two_filter(cuda):
    x = _grid((70, 97), cuda, 10)
    w = _grid((32, 32), cuda, 11)
    for mode in ("same", "valid"):
        for variant in VARIANTS:
            got = ops.conv2d(x, w, mode=mode, variant=variant)
            _close(got, engine.run_window_plan_reference(
                x, w, plan=ssam_conv2d.plan_for((32, 32), mode),
                variant=variant))


def test_cuda_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached on the card")

    monkeypatch.setattr(engine, "run_window_plan_reference", boom)
    before = engine.WINDOW_KERNEL.launches
    ops.stencil(_grid((40, 80), cuda), "2d9pt")
    ops.conv2d(_grid((40, 80), cuda), _grid((3, 3), cuda))
    assert engine.WINDOW_KERNEL.launches == before + 2


def test_bad_calls_raise_on_the_card(cuda):
    x = _grid((40, 80), cuda)
    with pytest.raises(ValueError, match="same device"):
        ops.conv2d(x, torch.ones(3, 3))
    with pytest.raises(ValueError, match="shared memory"):
        ops.stencil(_grid((600, 600), cuda), "2d121pt", block=(512, 512))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.stencil(x.double(), "2d5pt")


# --- K5: the scan kernel ----------------------------------------------------

def _scan_operands(combine, shape, device, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    xs = (a, b) if combine == "linrec" else (b,)
    return [convert.from_numpy(x, device).to(dtype) for x in xs]


def _scan_plan(combine, T):
    S = 1 << (min(128, T).bit_length() - 1)
    return (plan.linear_recurrence_plan(S) if combine == "linrec"
            else plan.scan_plan(S))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("T", [1, 7, 32, 33, 300])
@pytest.mark.parametrize("combine", ["add", "linrec"])
def test_scan_kernel_matches_plain_version(cuda, combine, T, carry):
    R = 13                                      # ragged against 8 warps
    xs = _scan_operands(combine, (R, T), cuda)
    p = _scan_plan(combine, T)
    c = convert.from_numpy(np.linspace(-1, 1, R, dtype=np.float32), cuda) \
        if carry else None
    before = engine.SCAN_KERNEL.launches
    out, co = engine.run_scan_plan(*xs, plan=p, carry=c, return_carry=True)
    assert engine.SCAN_KERNEL.launches == before + 1
    want, wco = engine.run_scan_plan_reference(*xs, plan=p, carry=c,
                                               return_carry=True)
    _close(out, want, rtol=1e-5)
    _close(co, wco, rtol=1e-5)
    _close(engine.run_scan_plan(*xs, plan=p, carry=c), want, rtol=1e-5)
    oracle = (ref.linear_recurrence if combine == "linrec"
              else ref.cumsum)(*xs)
    if not carry:
        _close(out, oracle, rtol=1e-5)


@pytest.mark.parametrize("combine", ["add", "linrec"])
def test_scan_kernel_bf16(cuda, combine):
    xs = _scan_operands(combine, (37, 300), cuda, torch.bfloat16, seed=1)
    p = _scan_plan(combine, 300)
    c = torch.full((37,), 0.5, device=cuda)
    out, co = engine.run_scan_plan(*xs, plan=p, carry=c, return_carry=True)
    assert out.dtype == co.dtype == torch.bfloat16
    want, wco = engine.run_scan_plan_reference(*xs, plan=p, carry=c,
                                               return_carry=True)
    _close(out, want, rtol=3e-2)
    _close(co, wco, rtol=3e-2)


def test_scan_ops_on_the_card(cuda):
    a, b = _scan_operands("linrec", (6, 4, 500), cuda, seed=2)
    want = ref.linear_recurrence(a, b)
    for impl in ("engine", "engine_unchunked"):
        _close(ops.chunked_linear_recurrence(a, b, chunk=64, impl=impl),
               want, rtol=1e-5)
    x = b[0]
    _close(ops.cumsum(x), ref.cumsum(x), rtol=1e-5)
    _close(ops.sat(x), ref.sat(x), rtol=1e-5)
    h, hT = ops.linear_recurrence_carry(a[0], b[0], b[1, :, 0])
    b2 = b[0].clone()
    b2[:, 0] += a[0, :, 0] * b[1, :, 0]
    _close(h, ref.linear_recurrence(a[0], b2), rtol=1e-5)
    _close(hT[:, 0], h[:, -1], rtol=1e-5)


def test_scan_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached on the card")

    monkeypatch.setattr(engine, "run_scan_plan_reference", boom)
    a, b = _scan_operands("linrec", (16, 200), cuda)
    before = engine.SCAN_KERNEL.launches
    ops.cumsum(b)
    ops.linear_recurrence(a, b)
    ops.chunked_linear_recurrence(a, b, chunk=64)         # 4 chunks
    assert engine.SCAN_KERNEL.launches == before + 6
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        ops.linear_recurrence(a, b.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.cumsum(b.double())


def test_rwkv6_serving_on_the_card_goes_through_k5(cuda):
    cfg = get_config("rwkv6-1.6b", smoke=True)
    model = build_model(cfg, device=cuda, seed=0)
    toks = torch.randint(0, cfg.vocab, (1, 40), device=cuda)
    before = engine.SCAN_KERNEL.launches
    log, st = model.prefill(toks)
    # ⌈40/16⌉ chunks in each of the 2 layers
    assert engine.SCAN_KERNEL.launches == before + 2 * 3
    state = spec.init_params(model.decode_state_specs(1, 64), device=cuda)
    for i in range(40):
        seq_log, state = model.serve_step(state, toks[:, i:i + 1])
    _close(log, seq_log, rtol=1e-4)
    _close(st["S"], state["S"], rtol=1e-4)
    before = engine.SCAN_KERNEL.launches
    server = serve.DecodeServer(model, slots=2, cache_len=64)
    reqs = [serve.Request(i, np.arange(5 + 20 * i, dtype=np.int32), 4)
            for i in range(3)]
    done = server.run(reqs)
    assert all(len(r.out) == 4 for r in done)
    assert engine.SCAN_KERNEL.launches == before + 2 * (1 + 2 + 3)


# --- K1's channel-reduce path and K3 --------------------------------------

REDUCE_CASES = [
    # (x shape, w shape, mode, stride, epilogue)
    ((2, 5, 3, 300), (37, 5, 3, 3), "same", (1, 1), None),
    ((2, 5, 3, 300), (37, 5, 3, 3), "valid", (1, 2), ("bias", "gelu")),
    ((3, 19, 1, 257), (40, 19, 1, 3), "same", (1, 2), ("bias", "gelu")),
    ((1, 33, 6, 70), (8, 33, 2, 5), "same", (2, 2), ("relu", ("scale", 2.0))),
    ((2, 4, 5, 129), (3, 4, 4, 1), "valid", (2, 1), ("bias", "silu")),
    # C_out of 4, 130 and 129 (one partial 128-channel tile or two), widths
    # that are no multiple of a column tile, fp32 rows of 17 and 257
    # columns (no multiple of 16 bytes), stride 3
    ((2, 7, 2, 17), (4, 7, 1, 3), "same", (1, 1), None),
    ((1, 64, 1, 1000), (130, 64, 1, 3), "same", (1, 2), ("bias", "gelu")),
    ((2, 9, 3, 257), (129, 9, 3, 3), "valid", (1, 3), ("relu",)),
    ((1, 20, 4, 500), (16, 20, 2, 5), "same", (3, 3), None),
]


@pytest.mark.parametrize("xs,ws,mode,stride,epi", REDUCE_CASES, ids=str)
def test_reduce_kernel_matches_plain_version(cuda, xs, ws, mode, stride, epi):
    x, w = _grid(xs, cuda, 11), _grid(ws, cuda, 12)
    b = _grid(ws[:1], cuda, 13)
    p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                            stride=None if stride == (1, 1) else stride,
                            epilogue=plan.normalize_epilogue(epi))
    args = (b,) if epi and "bias" in epi else ()
    before = engine.WINDOW_KERNEL.launches
    got = engine.run_window_plan(x, w, plan=p, epilogue_args=args)
    assert engine.WINDOW_KERNEL.launches == before + 1
    _close(got, engine.run_window_plan_reference(x, w, plan=p,
                                                 epilogue_args=args), 1e-4)
    if not epi:
        _close(got, ref.conv2d_nchw(x, w, mode, stride=stride), 1e-4)
    # the input adjoint of the stride-free plan (a full-mode plan for
    # 'valid'), on the cotangent's shape
    lin = dataclasses.replace(p, stride=None, epilogue=())
    a = adjoint.input_adjoint_plan(lin)
    g = _grid((xs[0], ws[0]) + lin.out_shape(xs[2:]), cuda, 14)
    wa = adjoint.adjoint_coeff_array(lin, w)
    _close(engine.run_window_plan(g, wa, plan=a),
           engine.run_window_plan_reference(g, wa, plan=a), 1e-4)


@pytest.mark.parametrize("xs,ws,mode,stride,epi", REDUCE_CASES, ids=str)
def test_reduce_phased_dx_matches_plain_version(cuda, xs, ws, mode, stride,
                                                epi):
    """dx of the (strided) linear plan through K1's phases, one launch,
    against the plain version's phases and the scattered formulation (K1
    on the stride-free plan's adjoint of the cotangent scattered onto the
    dense lattice)."""
    w = _grid(ws, cuda, 12)
    p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                            stride=None if stride == (1, 1) else stride)
    g = _grid((xs[0], ws[0]) + p.out_shape(xs[2:]), cuda, 14)
    wa = adjoint.adjoint_coeff_array(p, w)
    before = engine.WINDOW_KERNEL.launches
    got = engine.run_adjoint_phases(g, wa, plan=p, in_spatial=xs[2:])
    assert engine.WINDOW_KERNEL.launches == before + 1
    assert got.shape == (xs[0],) + xs[1:]
    _close(got, engine.run_adjoint_phases_reference(
        g, wa, plan=p, in_spatial=xs[2:]), 1e-4)
    dense = dataclasses.replace(p, stride=None)
    gd = g.new_zeros(g.shape[:2] + dense.out_shape(xs[2:]))
    gd[..., ::stride[0], ::stride[1]] = g
    _close(got, engine.run_window_plan(
        gd, wa, plan=adjoint.input_adjoint_plan(dense)), 1e-4)


def test_reduce_kernel_is_deterministic(cuda):
    """No atomics, no split of C_in: two calls give the same bits, forward
    and phased dx, fp32 and bf16."""
    xs, ws = (2, 512, 1, 3000), (512, 512, 1, 3)
    p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, "same"),
                            stride=(1, 2))
    w = _grid(ws, cuda, 40)
    wa = adjoint.adjoint_coeff_array(p, w)
    for dtype in (torch.float32, torch.bfloat16):
        x = _grid(xs, cuda, 41).to(dtype)
        g = _grid((2, 512, 1, 1500), cuda, 42).to(dtype)
        for run in (lambda: engine.run_window_plan(x, w, plan=p),
                    lambda: engine.run_adjoint_phases(g, wa, plan=p,
                                                      in_spatial=(1, 3000))):
            assert torch.equal(run(), run())


def test_reduce_kernel_bf16_rows_of_1500(cuda):
    """bf16 rows of 1500 (3000 bytes, no multiple of 16): the forward at
    stride 1 on them, and the phased dx reading a cotangent of 1500."""
    x = _grid((2, 24, 1, 1500), cuda, 43).to(torch.bfloat16)
    w, b = _grid((40, 24, 1, 3), cuda, 44), _grid((40,), cuda, 45)
    p = dataclasses.replace(
        ssam_conv2d.plan_for_nchw(x.shape, w.shape, "same"),
        epilogue=plan.normalize_epilogue(("bias", "gelu")))
    got = engine.run_window_plan(x, w, plan=p, epilogue_args=(b,))
    assert got.dtype == torch.bfloat16
    _close(got.float(), engine.run_window_plan_reference(
        x, w, plan=p, epilogue_args=(b,)).float(), 3e-2)
    ps = dataclasses.replace(ssam_conv2d.plan_for_nchw(
        (2, 24, 1, 3000), w.shape, "same"), stride=(1, 2))
    g = _grid((2, 40, 1, 1500), cuda, 46).to(torch.bfloat16)
    wa = adjoint.adjoint_coeff_array(ps, w)
    got = engine.run_adjoint_phases(g, wa, plan=ps, in_spatial=(1, 3000))
    _close(got.float(), engine.run_adjoint_phases_reference(
        g, wa, plan=ps, in_spatial=(1, 3000)).float(), 3e-2)


def test_reduce_kernel_bf16(cuda):
    xs, ws = (2, 24, 1, 200), (16, 24, 1, 3)
    x = _grid(xs, cuda, 15).to(torch.bfloat16)
    w, b = _grid(ws, cuda, 16), _grid((16,), cuda, 17)
    got = ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
                     epilogue_args=(b,))
    assert got.dtype == torch.bfloat16
    p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, "same"),
                            stride=(1, 2),
                            epilogue=plan.normalize_epilogue(("bias", "gelu")))
    _close(got.float(), engine.run_window_plan_reference(
        x, w, plan=p, epilogue_args=(b,)).float(), 3e-2)


WGRAD_CASES = [
    # (x shape, w shape, or (N, M) or None (5 x 7) for the (N, M)
    # layout, mode, stride)
    ((2, 5, 3, 300), (37, 5, 3, 3), "same", (1, 1)),
    ((8, 80, 1, 700), (64, 80, 1, 3), "same", (1, 1)),
    ((1, 1, 1, 1), (1, 1, 1, 1), "valid", (1, 1)),
    ((2, 3, 9, 70), (130, 3, 2, 5), "valid", (1, 1)),
    ((2, 512, 1, 3000), (512, 512, 1, 3), "same", (1, 2)),  # conv2, batch 2
    ((3, 19, 5, 257), (37, 19, 3, 2), "valid", (2, 3)),     # strided, odd
    ((4, 130, 70), None, "same", (1, 1)),     # (N, M) layout, batched
    ((500, 333), None, "valid", (1, 1)),      # (N, M) layout, one image
    # the (N, M) layout's filters, widths 1 and 129, a batch of 3 (each
    # also in bf16)
    ((300, 129), (3, 3), "same", (1, 1)),
    ((70, 333), (9, 9), "valid", (1, 1)),
    ((90, 300), (20, 20), "same", (1, 1)),
    ((40, 1), (1, 7), "same", (1, 1)),
    ((3, 64, 129), (5, 5), "same", (1, 1)),
    # footprints cut into tiles: 32 x 32 (two row tiles), 40 columns (two
    # column tiles)
    ((70, 300), (32, 32), "same", (1, 1)),
    ((2, 50, 200), (9, 40), "valid", (1, 1)),
]


def _wgrad_case(xs, ws, mode, stride, device):
    x = _grid(xs, device, 18)
    if ws is None or len(ws) == 2:
        p = (ssam_conv2d.plan_for_batched if len(xs) == 3
             else ssam_conv2d.plan_for)(ws or (5, 7), mode)
        lead = xs[:len(xs) - 2]
    else:
        p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                                stride=None if stride == (1, 1) else stride)
        lead = (xs[0], ws[0])
    return x, _grid(lead + p.out_shape(xs[-2:]), device, 19), p


@pytest.mark.parametrize("xs,ws,mode,stride", WGRAD_CASES, ids=str)
def test_wgrad_kernel_matches_plain_version(cuda, xs, ws, mode, stride):
    x, g, p = _wgrad_case(xs, ws, mode, stride, cuda)
    before = engine.WGRAD_KERNEL.launches
    got = engine.run_weight_grad_plan(x, g, plan=p)
    assert engine.WGRAD_KERNEL.launches == before + \
        engine.WGRAD_KERNEL.launches_for(x, g, plan=p)
    want = engine.run_weight_grad_plan_reference(x, g, plan=p)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, 1e-4)
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    _close(engine.run_weight_grad_plan(xb, gb, plan=p),
           engine.run_weight_grad_plan_reference(xb, gb, plan=p), 3e-2)
    if stride != (1, 1):
        # the stride-free plan on the scattered cotangent, as before
        dense = dataclasses.replace(p, stride=None)
        gd = g.new_zeros(g.shape[:2] + dense.out_shape(xs[2:]))
        gd[..., ::stride[0], ::stride[1]] = g
        _close(engine.run_weight_grad_plan(x, gd, plan=dense), want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_wgrad_kernel_is_deterministic(cuda, dtype):
    for case in (WGRAD_CASES[1], WGRAD_CASES[4], WGRAD_CASES[5],
                 WGRAD_CASES[6], WGRAD_CASES[10], WGRAD_CASES[13]):
        x, g, p = _wgrad_case(*case, cuda)
        x, g = x.to(dtype), g.to(dtype)
        first = engine.run_weight_grad_plan(x, g, plan=p)
        assert torch.equal(first, engine.run_weight_grad_plan(x, g, plan=p))


def test_conv_autograd_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached on the card")

    monkeypatch.setattr(engine, "run_window_plan_reference", boom)
    monkeypatch.setattr(engine, "run_adjoint_phases_reference", boom)
    monkeypatch.setattr(engine, "run_weight_grad_plan_reference", boom)
    k1, k3 = engine.WINDOW_KERNEL.launches, engine.WGRAD_KERNEL.launches
    for i, stride in enumerate(((1, 2), (2, 2))):
        x = _grid((2, 6, 3, 90), cuda, 20).requires_grad_()
        w = _grid((8, 6, 1, 3), cuda, 21).requires_grad_()
        b = _grid((8,), cuda, 22).requires_grad_()
        y = ops.conv2d(x, w, stride=stride, epilogue=("bias", "gelu"),
                       epilogue_args=(b,))
        y.square().sum().backward()
        # forward, recomputed pre-activation, dx (its phases in one
        # launch); dW on the strided cotangent (its split reduction)
        p = dataclasses.replace(ssam_conv2d.plan_for_nchw(
            x.shape, w.shape, "same"), stride=stride)
        k3 += engine.WGRAD_KERNEL.launches_for(x, y, plan=p)
        assert engine.WINDOW_KERNEL.launches == k1 + 3 * (i + 1)
        assert engine.WGRAD_KERNEL.launches == k3
        assert x.grad.is_cuda and w.grad.is_cuda and b.grad.is_cuda
    s = _grid((30, 40), cuda, 23).requires_grad_()
    ops.stencil(s, "2d9pt", time_steps=2).sum().backward()
    assert engine.WINDOW_KERNEL.launches == k1 + 8
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        engine.run_weight_grad_plan(x.detach(), y.detach().cpu(), plan=p)


def test_conv_gradients_on_the_card_match_the_cpu(cuda):
    xs, ws = (2, 12, 1, 150), (16, 12, 1, 3)
    xc = _grid(xs, "cpu", 24)
    wc, bc = _grid(ws, "cpu", 25), _grid((16,), "cpu", 26)
    grads = []
    for dev in ("cpu", cuda):
        x, w, b = (t.detach().to(dev).requires_grad_()
                   for t in (xc, wc, bc))
        y = ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
                       epilogue_args=(b,))
        (y * y).sum().backward()
        grads.append([t.grad.cpu() for t in (x, w, b)])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


def _stem_k3_launches(cfg, batch: int) -> int:
    """K3's launches for one step of the whisper stem: its two dW calls
    (conv1, and conv2 on its strided cotangent)."""
    T = 2 * cfg.n_frames
    mel = torch.empty(batch, cfg.n_mels, 1, T)
    h = torch.empty(batch, cfg.d_model, 1, T)
    p1 = ssam_conv2d.plan_for_nchw(mel.shape, (cfg.d_model, cfg.n_mels, 1, 3),
                                   "same")
    p2 = dataclasses.replace(ssam_conv2d.plan_for_nchw(
        h.shape, (cfg.d_model, cfg.d_model, 1, 3), "same"), stride=(1, 2))
    launches = engine.WGRAD_KERNEL.launches_for
    return (launches(mel, h, plan=p1)
            + launches(h, h[..., ::2], plan=p2))


def test_whisper_train_steps_go_through_k1_and_k3(cuda):
    k3_step = _stem_k3_launches(whisper_base.SMOKE_CONV, 2)
    before = engine.WINDOW_KERNEL.launches, engine.WGRAD_KERNEL.launches
    res = train.main(["--arch", "whisper-base", "--conv-frontend", "--smoke",
                      "--steps", "2", "--batch", "2", "--seq", "16"])
    assert all(np.isfinite(res.losses))
    assert engine.WINDOW_KERNEL.launches == before[0] + 5 * 2
    assert engine.WGRAD_KERNEL.launches == before[1] + k3_step * 2
    # the same stem pinned to mxu runs K2 where it ran K1
    before = (engine.WINDOW_KERNEL.launches, engine.MXU_KERNEL.launches,
              engine.WGRAD_KERNEL.launches)
    model = build_model(whisper_base.SMOKE_CONV_MXU, device=cuda, seed=0)
    batch = train.make_batch(model, TokenDataset(model.cfg.vocab, 16), 0, 2,
                             cuda)
    loss = model.loss(batch)
    torch.autograd.grad(loss, [p for _, p in spec.module_leaves(
        model.params)])
    assert np.isfinite(loss.item())
    assert engine.WINDOW_KERNEL.launches == before[0]
    assert engine.MXU_KERNEL.launches == before[1] + 5
    assert engine.WGRAD_KERNEL.launches == before[2] + k3_step


# --- K2: the tensor-core kernel (strategy='mxu') ---------------------------

def _mxu_and_lanes(run, **kw):
    """``run`` under both strategies, with K2's and K1's launches."""
    k1, k2 = engine.WINDOW_KERNEL.launches, engine.MXU_KERNEL.launches
    got = run(strategy="mxu", **kw)
    assert engine.MXU_KERNEL.launches == k2 + 1
    assert engine.WINDOW_KERNEL.launches == k1
    return got, run(strategy="lanes", **kw)


@pytest.mark.parametrize("name", sorted(stencils.BENCHMARKS))
def test_mxu_stencil_matches_plain_version(cuda, name):
    sd = stencils.BENCHMARKS[name]
    mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
    p = dataclasses.replace(mod.plan_for(sd), strategy="mxu")
    x = _grid((97, 203) if sd.ndim == 2 else (21, 30, 75), cuda)
    for t in (1, 2):
        got, lanes = _mxu_and_lanes(
            lambda **kw: ops.stencil(x, name, time_steps=t, **kw))
        _close(got, engine.run_window_plan_reference(x, plan=p,
                                                     time_steps=t))
        _close(got, lanes, 1e-4)
        _close(got, ref.stencil_iterate(x, sd, t), 1e-4)


@pytest.mark.parametrize("fshape", [(1, 1), (3, 3), (1, 7), (5, 2), (7, 7),
                                    (20, 20), (32, 32)], ids=str)
@pytest.mark.parametrize("mode", ["valid", "same"])
def test_mxu_conv2d_matches_plain_version(cuda, mode, fshape):
    """Tap counts that are and are not multiples of 8, on a grid whose
    edges are not multiples of the tile, with several block shapes."""
    x = _grid((131, 259), cuda, 31)
    w = _grid(fshape, cuda, 32)
    p = dataclasses.replace(ssam_conv2d.plan_for(fshape, mode),
                            strategy="mxu")
    for block in (None, (7, 13)):
        got, lanes = _mxu_and_lanes(
            lambda **kw: ops.conv2d(x, w, mode=mode, block=block, **kw))
        _close(got, engine.run_window_plan_reference(x, w, plan=p))
        _close(got, lanes, 1e-4)
    xs = _grid((3, 50, 90), cuda, 33)
    got = ops.conv2d(xs, w[:5, :5], mode=mode, strategy="mxu")
    _close(got, ref.conv2d_batched(xs, w[:5, :5], mode), 1e-4)


# K2's single-channel path (Toeplitz tiles, TMA ring): (tag, grid shape,
# plan, filter shape or None, t, block, dtype); ragged edges, 3-D, t = 2,
# bf16, a one-column filter and the 1024-tap footprint
def _mxu_single_cases():
    sd = stencils.BENCHMARKS
    s2, s3 = ssam_stencil2d.plan_for, ssam_stencil3d.plan_for
    return [
        ("2d13pt ragged", (131, 259), s2(sd["2d13pt"]), None, 1, (13, 29),
         "float32"),
        ("3d125pt", (21, 30, 75), s3(sd["3d125pt"]), None, 1, None,
         "float32"),
        ("3d7pt t=2 ragged", (19, 23, 67), s3(sd["3d7pt"]), None, 2,
         (3, 7, 21), "float32"),
        ("conv 7x7 t=2", (131, 259), ssam_conv2d.plan_for((7, 7), "same"),
         (7, 7), 2, None, "float32"),
        ("2d25pt bf16 t=2", (131, 259), s2(sd["2d25pt"]), None, 2, None,
         "bfloat16"),
        ("conv 9x1 one column", (131, 259),
         ssam_conv2d.plan_for((9, 1), "same"), (9, 1), 1, (16, 40),
         "float32"),
        ("conv 32x32 1024 taps", (131, 259),
         ssam_conv2d.plan_for((32, 32), "same"), (32, 32), 1, None,
         "float32"),
    ]


@pytest.mark.parametrize("case", _mxu_single_cases(), ids=lambda c: c[0])
def test_mxu_single_channel_kernel_matches_plain_version(cuda, case):
    """K2's single-channel kernel against its plain version (and the CPU
    walk of its schedule), one launch a call, two calls equal bits."""
    tag, shape, p, fshape, t, block, dt = case
    p = dataclasses.replace(p, strategy="mxu")
    x = _grid(shape, cuda, 41).to(getattr(torch, dt))
    w = None if fshape is None else _grid(fshape, cuda, 42)
    before = engine.MXU_KERNEL.launches
    got = engine.run_window_plan(x, w, plan=p, block=block, time_steps=t)
    assert engine.MXU_KERNEL.launches == before + 1
    rtol = 3e-5 if dt == "float32" else 3e-2
    _close(got.float(), engine.run_window_plan_reference(
        x, w, plan=p, block=block, time_steps=t).float(), rtol)
    _close(got.float().cpu(), engine.emulate_mxu_kernel(
        x.cpu(), None if w is None else w.cpu(), plan=p, block=block,
        time_steps=t).float(), rtol)
    again = engine.run_window_plan(x, w, plan=p, block=block, time_steps=t)
    assert torch.equal(got, again)           # no atomics: deterministic


# K2's channel path: REDUCE_CASES, C_out 200 on 23 rows (a second channel
# tile 72 wide) and a 9x9 filter at stride 3, whose forward stages x a
# k-block at a time
MXU_REDUCE_CASES = REDUCE_CASES + [
    ((1, 16, 23, 300), (200, 16, 1, 3), "same", (1, 1), ("bias", "gelu")),
    ((1, 2, 12, 40), (3, 2, 9, 9), "same", (3, 3), None),
]


def _mxu_case_plan(xs, ws, mode, stride, epi=None):
    return dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                               stride=None if stride == (1, 1) else stride,
                               epilogue=plan.normalize_epilogue(epi),
                               strategy="mxu")


@pytest.mark.parametrize("xs,ws,mode,stride,epi", MXU_REDUCE_CASES, ids=str)
def test_mxu_reduce_matches_plain_version(cuda, xs, ws, mode, stride, epi):
    x, w = _grid(xs, cuda, 11), _grid(ws, cuda, 12)
    b = _grid(ws[:1], cuda, 13)
    p = _mxu_case_plan(xs, ws, mode, stride, epi)
    args = (b,) if epi and "bias" in epi else ()
    got, lanes = _mxu_and_lanes(
        lambda **kw: engine.run_window_plan(x, w, plan=p, epilogue_args=args,
                                            **kw))
    _close(got, engine.run_window_plan_reference(x, w, plan=p,
                                                 epilogue_args=args), 1e-4)
    _close(got, lanes, 1e-4)
    lin = dataclasses.replace(p, stride=None, epilogue=())
    a = adjoint.input_adjoint_plan(lin)
    assert a.strategy == "mxu"
    g = _grid((xs[0], ws[0]) + lin.out_shape(xs[2:]), cuda, 14)
    wa = adjoint.adjoint_coeff_array(lin, w)
    _close(engine.run_window_plan(g, wa, plan=a),
           engine.run_window_plan_reference(g, wa, plan=a), 1e-4)


@pytest.mark.parametrize("xs,ws,mode,stride,epi", MXU_REDUCE_CASES, ids=str)
def test_mxu_phased_dx_matches_plain_version(cuda, xs, ws, mode, stride,
                                             epi):
    """dx of the (strided) linear plan through K2's phases, one launch,
    against the plain mxu phases and K1's phased dx."""
    w = _grid(ws, cuda, 12)
    p = _mxu_case_plan(xs, ws, mode, stride)
    g = _grid((xs[0], ws[0]) + p.out_shape(xs[2:]), cuda, 14)
    wa = adjoint.adjoint_coeff_array(p, w)
    k1, k2 = engine.WINDOW_KERNEL.launches, engine.MXU_KERNEL.launches
    got = engine.run_adjoint_phases(g, wa, plan=p, in_spatial=xs[2:])
    assert engine.MXU_KERNEL.launches == k2 + 1
    assert engine.WINDOW_KERNEL.launches == k1
    assert got.shape == (xs[0],) + xs[1:]
    _close(got, engine.run_adjoint_phases_reference(
        g, wa, plan=p, in_spatial=xs[2:]), 1e-4)
    _close(got, engine.run_adjoint_phases(
        g, wa, plan=dataclasses.replace(p, strategy="lanes"),
        in_spatial=xs[2:]), 1e-4)


def test_mxu_reduce_kernel_is_deterministic(cuda):
    """No atomics, no split of K: two calls give the same bits, forward and
    phased dx at the stem's conv2 (batch 2), fp32 and bf16; bf16 against
    the plain version at 3e-2."""
    xs, ws = (2, 512, 1, 3000), (512, 512, 1, 3)
    p = _mxu_case_plan(xs, ws, "same", (1, 2))
    w = _grid(ws, cuda, 40)
    wa = adjoint.adjoint_coeff_array(p, w)
    for dtype in (torch.float32, torch.bfloat16):
        x = _grid(xs, cuda, 41).to(dtype)
        g = _grid((2, 512, 1, 1500), cuda, 42).to(dtype)
        for run, plain in (
                (lambda: engine.run_window_plan(x, w, plan=p),
                 lambda: engine.run_window_plan_reference(x, w, plan=p)),
                (lambda: engine.run_adjoint_phases(g, wa, plan=p,
                                                   in_spatial=(1, 3000)),
                 lambda: engine.run_adjoint_phases_reference(
                     g, wa, plan=p, in_spatial=(1, 3000)))):
            first = run()
            assert torch.equal(first, run())
            _close(first.float(), plain().float(),
                   1e-4 if dtype == torch.float32 else 3e-2)


def test_mxu_strided_backward_counts_k2(cuda, monkeypatch):
    """A strided mxu conv's forward and backward launch K2 three times
    (forward, recomputed pre-activation, the phased dx) and K3 for dW;
    never K1 or a plain version."""
    def boom(*a, **k):
        raise AssertionError("K1 or a plain version reached on the card")

    for name in ("run_window_plan_reference", "run_adjoint_phases_reference",
                 "WINDOW_KERNEL"):
        monkeypatch.setattr(engine, name, boom)
    x = _grid((2, 40, 1, 300), cuda, 47).requires_grad_()
    w = _grid((24, 40, 1, 3), cuda, 48).requires_grad_()
    b = _grid((24,), cuda, 49).requires_grad_()
    k2 = engine.MXU_KERNEL.launches
    y = ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
                   epilogue_args=(b,), strategy="mxu")
    y.square().sum().backward()
    assert engine.MXU_KERNEL.launches == k2 + 3
    assert x.grad.is_cuda and w.grad.is_cuda and b.grad.is_cuda


def test_mxu_bf16(cuda):
    xs, ws = (2, 24, 1, 200), (16, 24, 1, 3)
    x = _grid(xs, cuda, 15).to(torch.bfloat16)
    w, b = _grid(ws, cuda, 16), _grid((16,), cuda, 17)
    got = ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
                     epilogue_args=(b,), strategy="mxu")
    assert got.dtype == torch.bfloat16
    p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, "same"),
                            stride=(1, 2), strategy="mxu",
                            epilogue=plan.normalize_epilogue(("bias", "gelu")))
    _close(got.float(), engine.run_window_plan_reference(
        x, w, plan=p, epilogue_args=(b,)).float(), 3e-2)
    s = _grid((64, 300), cuda, 5).to(torch.bfloat16)
    sd = stencils.BENCHMARKS["2d13pt"]
    got = ops.stencil(s, sd, time_steps=2, strategy="mxu")
    assert got.dtype == torch.bfloat16
    _close(got, engine.run_window_plan_reference(
        s, plan=dataclasses.replace(ssam_stencil2d.plan_for(sd),
                                    strategy="mxu"), time_steps=2), 3e-2)


def test_mxu_never_retreats(cuda, monkeypatch):
    """K2 counts its launches; an mxu plan on the card never reaches K1 or
    the plain version, and a launch K2 refuses raises."""
    def boom(*a, **k):
        raise AssertionError("K1 or the plain version reached on the card")

    monkeypatch.setattr(engine, "run_window_plan_reference", boom)
    monkeypatch.setattr(engine, "WINDOW_KERNEL", boom)
    before = engine.MXU_KERNEL.launches
    ops.stencil(_grid((40, 80), cuda), "2d9pt", strategy="mxu")
    ops.conv2d(_grid((40, 80), cuda), _grid((3, 3), cuda), strategy="mxu")
    x = _grid((2, 6, 1, 90), cuda, 20).requires_grad_()
    w = _grid((8, 6, 1, 3), cuda, 21).requires_grad_()
    y = ops.conv2d(x, w, stride=(1, 2), epilogue="gelu", strategy="mxu")
    y.square().sum().backward()          # recomputed pre-activation, dx
    assert engine.MXU_KERNEL.launches == before + 5
    with pytest.raises(ValueError, match="shared memory"):
        ops.stencil(_grid((600, 600), cuda), "2d121pt", block=(512, 512),
                    strategy="mxu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.stencil(_grid((40, 80), cuda).double(), "2d5pt", strategy="mxu")
    # a per-lane plan under mxu runs K2's per-lane path, never K1
    x1, w1 = _grid((1, 20, 40), cuda), _grid((3, 40), cuda)
    got = engine.run_window_plan(x1, w1, plan=plan.depthwise_conv1d_plan(3),
                                 strategy="mxu")
    assert engine.MXU_KERNEL.launches == before + 6
    monkeypatch.undo()
    mxu = dataclasses.replace(plan.depthwise_conv1d_plan(3), strategy="mxu")
    _close(got, engine.run_window_plan_reference(x1, w1, plan=mxu))


def test_mxu_gradients_on_the_card_match_the_cpu(cuda):
    xs, ws = (2, 12, 1, 150), (16, 12, 1, 3)
    xc = _grid(xs, "cpu", 24)
    wc, bc = _grid(ws, "cpu", 25), _grid((16,), "cpu", 26)
    grads = []
    for dev in ("cpu", cuda):
        x, w, b = (t.detach().to(dev).requires_grad_()
                   for t in (xc, wc, bc))
        y = ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
                       epilogue_args=(b,), strategy="mxu")
        (y * y).sum().backward()
        grads.append([t.grad.cpu() for t in (x, w, b)])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


# --- K1's per-lane path and K4: the depthwise conv1d -------------------------

# (B, T, D, K): D not a multiple of 128, T < K, T not a multiple of the
# 64-row tile, B > 1, Hymba's (2, 2048, 3200)
PERLANE = [(2, 24, 100, 4), (3, 37, 100, 4), (1, 2, 5, 4), (2, 130, 300, 3),
           (1, 65, 129, 8), (2, 2048, 3200, 4)]
PERLANE_IDS = [f"{b}x{t}x{d}-K{k}" for b, t, d, k in PERLANE]


def _perlane_data(B, T, D, K, device, seed=0):
    x = _grid((B, T, D), device, seed)
    w = _grid((K, D), device, seed + 1) / K ** 0.5
    b = _grid((D,), device, seed + 2) * 0.1
    g = _grid((B, T, D), device, seed + 3)
    return x, w, b, g


@pytest.mark.parametrize("B,T,D,K", PERLANE, ids=PERLANE_IDS)
def test_perlane_kernel_matches_plain_version(cuda, B, T, D, K):
    """K1's per-lane path: the forward with bias+SiLU fused (lead K−1),
    the linear forward, and the input adjoint (trail K−1, the reflected
    coefficient rows), each against the plain version."""
    x, w, b, g = _perlane_data(B, T, D, K, cuda)
    p = ssam_conv1d.plan_for(K)
    pe = dataclasses.replace(p, epilogue=normalize_epilogue(("bias", "silu")))
    a = adjoint.input_adjoint_plan(p)
    before = engine.WINDOW_KERNEL.launches
    for pl, inp, epi in ((pe, x, (b,)), (p, x, ()), (a, g, ())):
        got = engine.run_window_plan(inp, w, plan=pl, epilogue_args=epi)
        _close(got, engine.run_window_plan_reference(inp, w, plan=pl,
                                                     epilogue_args=epi))
    assert engine.WINDOW_KERNEL.launches == before + 3
    _close(engine.run_window_plan(x, w, plan=p), ref.conv1d_causal(x, w))


@pytest.mark.parametrize("B,T,D,K", PERLANE, ids=PERLANE_IDS)
def test_perlane_wgrad_kernel_matches_plain_version(cuda, B, T, D, K):
    x, _, _, g = _perlane_data(B, T, D, K, cuda, 4)
    p = ssam_conv1d.plan_for(K)
    before = engine.PERLANE_WGRAD_KERNEL.launches
    got = engine.run_weight_grad_plan(x, g, plan=p)
    assert got.shape == (K, D) and got.dtype == torch.float32
    _close(got, engine.run_weight_grad_plan_reference(x, g, plan=p),
           rtol=1e-4)
    assert engine.PERLANE_WGRAD_KERNEL.launches == before + \
        engine.PERLANE_WGRAD_KERNEL.launches_for(x, g, plan=p)
    again = engine.run_weight_grad_plan(x, g, plan=p)
    assert torch.equal(got, again)           # a fixed order: deterministic


def test_perlane_kernels_bf16(cuda):
    x, w, b, g = _perlane_data(2, 77, 300, 4, cuda, 5)
    xb, gb = x.bfloat16(), g.bfloat16()
    pe = dataclasses.replace(ssam_conv1d.plan_for(4),
                             epilogue=normalize_epilogue(("bias", "silu")))
    got = engine.run_window_plan(xb, w, plan=pe, epilogue_args=(b,))
    assert got.dtype == torch.bfloat16
    _close(got.float(), engine.run_window_plan_reference(
        xb, w, plan=pe, epilogue_args=(b,)).float(), rtol=3e-2)
    p = ssam_conv1d.plan_for(4)
    _close(engine.run_weight_grad_plan(xb, gb, plan=p),
           engine.run_weight_grad_plan_reference(xb, gb, plan=p), rtol=3e-2)


def test_conv1d_gradients_on_the_card_match_the_cpu(cuda, monkeypatch):
    """``ops.conv1d_causal`` with bias+SiLU: forward, recomputed
    pre-activation and dx through K1, dW through K4, never the plain
    versions; the gradients equal the CPU's."""
    xc, wc, bc, gc = _perlane_data(2, 150, 200, 4, "cpu", 6)
    grads = {}
    for dev in ("cpu", cuda):
        x, w, b = (t.detach().to(dev).requires_grad_() for t in (xc, wc, bc))
        if dev == cuda:
            def boom(*a, **k):
                raise AssertionError("plain version reached on the card")
            for name in ("run_window_plan_reference",
                         "run_weight_grad_plan_reference"):
                monkeypatch.setattr(engine, name, boom)
            before = (engine.WINDOW_KERNEL.launches,
                      engine.PERLANE_WGRAD_KERNEL.launches,
                      engine.WGRAD_KERNEL.launches)
        y = ops.conv1d_causal(x, w, epilogue=("bias", "silu"),
                              epilogue_args=(b,))
        grads[str(dev)] = [v.cpu() for v in torch.autograd.grad(
            y, (x, w, b), gc.to(dev))]
    assert (engine.WINDOW_KERNEL.launches, engine.PERLANE_WGRAD_KERNEL.launches,
            engine.WGRAD_KERNEL.launches) == (
        before[0] + 3, before[1] + engine.PERLANE_WGRAD_KERNEL.launches_for(
            xc, gc, plan=ssam_conv1d.plan_for(4)), before[2])
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("chain", [(), ("bias", "silu"), ("relu",),
                                   ("bias", "gelu", ("scale", 0.5)),
                                   ("silu",)], ids=str)
@pytest.mark.parametrize("D", [99, 3200])
def test_perlane_rows_and_chains(cuda, D, chain):
    """K1's per-lane path at an odd T (131) for D = 99 (masked element-wise
    rows) and 3200 (16-byte rows), every epilogue instance (the last the
    generic one), fp32 and bf16, forward and dx, each against the plain
    version and twice for equal bits."""
    x, w, b, g = _perlane_data(2, 131, D, 4, cuda, 9)
    p = ssam_conv1d.plan_for(4)
    pe = dataclasses.replace(p, epilogue=normalize_epilogue(chain) if chain
                             else ())
    args = (b,) if "bias" in chain else ()
    a = adjoint.input_adjoint_plan(p)
    for dt, rtol in (("float32", 3e-5), ("bfloat16", 3e-2)):
        xx, gg = x.to(getattr(torch, dt)), g.to(getattr(torch, dt))
        for pl, inp, ea in ((pe, xx, args), (a, gg, ())):
            before = engine.WINDOW_KERNEL.launches
            got = engine.run_window_plan(inp, w, plan=pl, epilogue_args=ea)
            assert engine.WINDOW_KERNEL.launches == before + 1
            assert got.dtype == inp.dtype
            _close(got.float(), engine.run_window_plan_reference(
                inp, w, plan=pl, epilogue_args=ea).float(), rtol)
            assert torch.equal(got, engine.run_window_plan(
                inp, w, plan=pl, epilogue_args=ea))
    # inputs far into SiLU's tails: exp(-v) overflows to inf (gives 0)
    xl = 60 * x
    _close(engine.run_window_plan(xl, w, plan=pe, epilogue_args=args),
           engine.run_window_plan_reference(xl, w, plan=pe,
                                            epilogue_args=args))


@pytest.mark.parametrize("B,T,D,K", PERLANE + [(1, 300, 64, 1),
                                          (2, 257, 3200, 2)],
                         ids=PERLANE_IDS + ["1x300x64-K1", "2x257x3200-K2"])
def test_mxu_perlane_kernel_matches_plain_version(cuda, B, T, D, K):
    """K2's per-lane path (``strategy="mxu"``): the forward with bias+SiLU,
    the linear forward and the input adjoint, each against the plain mxu
    version (3e-5), K1's per-lane path (1e-4) and the CPU emulation of
    its schedule; three K2 launches, no K1 launch; twice for equal
    bits."""
    x, w, b, g = _perlane_data(B, T, D, K, cuda, 11)
    p = dataclasses.replace(ssam_conv1d.plan_for(K), strategy="mxu")
    pe = dataclasses.replace(p, epilogue=normalize_epilogue(("bias", "silu")))
    a = adjoint.input_adjoint_plan(p)
    assert a.strategy == "mxu"
    before = engine.MXU_KERNEL.launches, engine.WINDOW_KERNEL.launches
    outs = []
    for pl, inp, epi in ((pe, x, (b,)), (p, x, ()), (a, g, ())):
        got = engine.run_window_plan(inp, w, plan=pl, epilogue_args=epi)
        outs.append((got, pl, inp, epi))
    assert (engine.MXU_KERNEL.launches,
            engine.WINDOW_KERNEL.launches) == (before[0] + 3, before[1])
    for got, pl, inp, epi in outs:
        _close(got, engine.run_window_plan_reference(inp, w, plan=pl,
                                                     epilogue_args=epi))
        lanes = dataclasses.replace(pl, strategy="lanes")
        _close(got, engine.run_window_plan(inp, w, plan=lanes,
                                           epilogue_args=epi), 1e-4)
        if inp.numel() <= 1 << 16:
            _close(got.cpu(), engine.emulate_mxu_perlane_kernel(
                inp.cpu(), w.cpu(), plan=pl,
                epilogue_args=tuple(t.cpu() for t in epi)))
        assert torch.equal(got, engine.run_window_plan(
            inp, w, plan=pl, epilogue_args=epi))


@pytest.mark.parametrize("chain", [(), ("bias", "silu"), ("relu",),
                                   ("bias", "gelu", ("scale", 0.5)),
                                   ("silu", "residual_add")], ids=str)
@pytest.mark.parametrize("D", [99, 3200])
def test_mxu_perlane_rows_chains_and_bf16(cuda, D, chain):
    """K2's per-lane path at an odd T (131) for D = 99 (element-wise rows)
    and 3200 (16-byte rows), every epilogue op and a residual, fp32 and
    bf16 I/O, forward and dx, against the plain mxu version."""
    x, w, b, g = _perlane_data(2, 131, D, 4, cuda, 12)
    r = _grid(x.shape, cuda, 13)
    p = dataclasses.replace(ssam_conv1d.plan_for(4), strategy="mxu")
    pe = dataclasses.replace(p, epilogue=normalize_epilogue(chain) if chain
                             else ())
    a = adjoint.input_adjoint_plan(p)
    for dt, rtol in (("float32", 3e-5), ("bfloat16", 3e-2)):
        xx, gg, rr = (t.to(getattr(torch, dt)) for t in (x, g, r))
        args = tuple(b if st.op == "bias" else rr
                     for st in pe.epilogue if st.op in ("bias",
                                                        "residual_add"))
        for pl, inp, ea in ((pe, xx, args), (a, gg, ())):
            before = engine.MXU_KERNEL.launches
            got = engine.run_window_plan(inp, w, plan=pl, epilogue_args=ea)
            assert engine.MXU_KERNEL.launches == before + 1
            assert got.dtype == inp.dtype
            _close(got.float(), engine.run_window_plan_reference(
                inp, w, plan=pl, epilogue_args=ea).float(), rtol)


@pytest.mark.parametrize("adj", [False, True], ids=["forward", "adjoint"])
def test_mxu_perlane_nonfinite_input_reach(cuda, adj):
    """K2's per-lane path on an inf at one step ``s`` of one lane and a
    nan at another step of another lane, fp32 and bf16: its non-finite
    outputs are exactly the plain version's (a chunk that holds one is
    summed tap by tap), and every other output equals the plain
    version's."""
    T, D, K, s, lane = 300, 64, 4, 200, 5
    x, w, _, _ = _perlane_data(1, T, D, K, cuda, 15)
    x[0, s, lane] = float("inf")
    x[0, 37, 60] = float("nan")
    p = dataclasses.replace(ssam_conv1d.plan_for(K), strategy="mxu")
    pl = adjoint.input_adjoint_plan(p) if adj else p
    for dt, rtol in ((torch.float32, 3e-5), (torch.bfloat16, 3e-2)):
        xx = x.to(dt)
        got = engine.run_window_plan(xx, w, plan=pl).float()
        want = engine.run_window_plan_reference(xx, w, plan=pl).float()
        torch.cuda.synchronize()
        bad_got, bad_want = ~torch.isfinite(got), ~torch.isfinite(want)
        assert bad_want[0, :, lane].any() and bad_want[0, :, 60].any()
        assert torch.equal(bad_got, bad_want)
        ok = ~bad_want
        _close(got[ok], want[ok], rtol)


# K2's single-channel path on non-finite inputs: (tag, grid, plan, filter,
# t, stride, dtype); a star stencil (zeros inside the band), a dense
# filter, t = 2 (the iterate carries them on), a stride and bf16
def _mxu_nonfinite_cases():
    sd = stencils.BENCHMARKS
    s2 = ssam_stencil2d.plan_for
    conv = ssam_conv2d.plan_for
    return [
        ("2d5pt", (70, 130), s2(sd["2d5pt"]), None, 1, None, "float32"),
        ("2d9pt t=2", (70, 130), s2(sd["2d9pt"]), None, 2, None, "float32"),
        ("conv 5x3", (70, 130), conv((5, 3), "same"), (5, 3), 1, None,
         "float32"),
        ("conv 5x5 stride 2", (70, 130), conv((5, 5), "same"), (5, 5), 1,
         (2, 2), "float32"),
        ("conv 7x7 bf16", (70, 130), conv((7, 7), "valid"), (7, 7), 1,
         None, "bfloat16"),
        # B tiles streamed in groups: the vote on the final sums, the
        # re-sum over every group's entries
        ("conv 33x33 streamed", (150, 200), conv((33, 33), "same"),
         (33, 33), 1, None, "float32"),
        ("conv 64x64 streamed bf16", (150, 200), conv((64, 64), "same"),
         (64, 64), 1, None, "bfloat16"),
        # each application of a streamed plan votes on its own sums
        ("box 33x33 streamed t=2", (150, 200),
         s2(_box_stencil("box33x33", (33, 33))), None, 2, None, "float32"),
    ]


@pytest.mark.parametrize("case", _mxu_nonfinite_cases(), ids=lambda c: c[0])
def test_mxu_single_channel_nonfinite_input_reach(cuda, case):
    """K2's single-channel path (Toeplitz tiles, whose zeros meet every
    staged column of an entry's window) on an inf and a nan in x: its
    non-finite outputs are exactly the plain version's, and every other
    output equals the plain version's."""
    _, shape, p, fshape, t, stride, dt = case
    x = _grid(shape, cuda, 81)
    x[31, 40] = float("inf")
    x[50, 101] = float("nan")
    x = x.to(getattr(torch, dt))
    w = None if fshape is None else _grid(fshape, cuda, 82)
    pl = dataclasses.replace(p, strategy="mxu", stride=stride)
    got = engine.run_window_plan(x, w, plan=pl, time_steps=t).float()
    want = engine.run_window_plan_reference(x, w, plan=pl,
                                            time_steps=t).float()
    torch.cuda.synchronize()
    bad_got, bad_want = ~torch.isfinite(got), ~torch.isfinite(want)
    assert bad_want.any()
    assert torch.equal(bad_got, bad_want)
    ok = ~bad_want
    _close(got[ok], want[ok], 3e-5 if dt == "float32" else 3e-2)


def test_conv1d_mxu_gradients_on_the_card_match_the_cpu(cuda, monkeypatch):
    """``ops.conv1d_causal(strategy="mxu")`` with bias+SiLU: forward,
    recomputed pre-activation and dx through K2's per-lane path, dW
    through K4, never K1 or the plain versions; the gradients equal the
    CPU's."""
    xc, wc, bc, gc = _perlane_data(2, 150, 200, 4, "cpu", 14)
    grads = {}
    for dev in ("cpu", cuda):
        x, w, b = (t.detach().to(dev).requires_grad_() for t in (xc, wc, bc))
        if dev == cuda:
            def boom(*a, **k):
                raise AssertionError("plain version or K1 reached")
            for name in ("run_window_plan_reference",
                         "run_weight_grad_plan_reference", "WINDOW_KERNEL"):
                monkeypatch.setattr(engine, name, boom)
            before = (engine.MXU_KERNEL.launches,
                      engine.PERLANE_WGRAD_KERNEL.launches)
        y = ops.conv1d_causal(x, w, epilogue=("bias", "silu"),
                              epilogue_args=(b,), strategy="mxu")
        grads[str(dev)] = [v.cpu() for v in torch.autograd.grad(
            y, (x, w, b), gc.to(dev))]
    assert (engine.MXU_KERNEL.launches,
            engine.PERLANE_WGRAD_KERNEL.launches) == (
        before[0] + 3, before[1] + engine.PERLANE_WGRAD_KERNEL.launches_for(
            xc, gc, plan=ssam_conv1d.plan_for(4)))
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


def test_perlane_bad_calls_raise_on_the_card(cuda):
    x = _grid((1, 20, 40), cuda)
    with pytest.raises(ValueError, match="same device"):
        ops.conv1d_causal(x, torch.ones(4, 40))
    with pytest.raises(ValueError, match="up to 8 taps"):
        ops.conv1d_causal(x, _grid((9, 40), cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.conv1d_causal(x.double(), _grid((4, 40), cuda).double())
    with pytest.raises(ValueError, match="up to 8 taps"):
        ops.conv1d_causal(x, _grid((9, 40), cuda), strategy="mxu")
    before = engine.MXU_KERNEL.launches, engine.WINDOW_KERNEL.launches
    ops.conv1d_causal(x, _grid((4, 40), cuda), strategy="mxu")
    assert (engine.MXU_KERNEL.launches,
            engine.WINDOW_KERNEL.launches) == (before[0] + 1, before[1])


def test_scan_gradients_on_the_card_go_through_k5(cuda):
    """The streamed recurrence's backward on the card: per chunk K5 runs
    the checkpoint's recomputed forward and the reversed λ-recurrence;
    the gradients equal the CPU's."""
    a, b = _scan_operands("linrec", (64, 300), "cpu", seed=7)
    g = _grid((64, 300), "cpu", 8)
    grads = {}
    for dev in ("cpu", cuda):
        ta, tb = (t.to(dev).requires_grad_() for t in (a, b))
        out = ops.chunked_linear_recurrence(ta, tb, chunk=128)
        before = engine.SCAN_KERNEL.launches
        grads[str(dev)] = [v.cpu() for v in torch.autograd.grad(
            out, (ta, tb), g.to(dev))]
    assert engine.SCAN_KERNEL.launches == before + 2 * 3
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


def test_hymba_train_steps_go_through_k1_k4_and_k5(cuda):
    """Two steps of the train CLI on Hymba's SMOKE config at 300 tokens
    (three scan chunks): the counters move by ``hymba.train_launches`` per
    step, K2 and K3 stay idle, and the losses are finite."""
    from repro_torch.models import hymba

    kernels = (engine.WINDOW_KERNEL, engine.PERLANE_WGRAD_KERNEL,
               engine.SCAN_KERNEL, engine.MXU_KERNEL, engine.WGRAD_KERNEL)
    before = [k.launches for k in kernels]
    res = train.main(["--arch", "hymba-1.5b", "--smoke", "--steps", "2",
                      "--batch", "2", "--seq", "300"])
    assert all(np.isfinite(res.losses)) and len(res.peak_mem_gb) == 2
    want = hymba.train_launches(hymba_1g5b.SMOKE, 300, 2)
    got = [k.launches - b for k, b in zip(kernels, before)]
    assert got == [2 * want["k1"], 2 * want["k4"], 2 * want["k5"], 0, 0]


# Epilogues, residuals, output strides and groups on every windowed path:
# each against its plain version on the card, one K1/K2 launch a fused
# forward, the strided forward's dx (one launch a phase) and dW (K3, per
# phase of x) beside it.
EPI_CASES = [
    ("2d9pt", (97, 203), ("bias", "relu"), 1),
    ("2d9pt", (97, 203), ("bias", "relu"), 2),
    ("2d5pt", (64, 300), ("gelu",), 2),
    ("3d7pt", (21, 30, 75), ("silu", "residual_add"), 2),
]


def _epi_args(chain, out_shape, device, like=None):
    args = []
    for st in normalize_epilogue(chain):
        if st.op == "bias":
            args.append(torch.tensor([0.25], device=device))
        elif st.op == "residual_add":
            args.append(like if like is not None
                        else _grid(out_shape, device, 77))
    return tuple(args)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("name,shape,chain,t", EPI_CASES, ids=str)
def test_stencil_epilogue_at_the_store(cuda, strategy, name, shape, chain, t):
    x = _grid(shape, cuda, 61)
    args = _epi_args(chain, shape, cuda)
    sd = stencils.BENCHMARKS[name]
    mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
    p = dataclasses.replace(mod.plan_for(sd), strategy=strategy,
                            epilogue=normalize_epilogue(chain))
    kernel = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
    for variant in VARIANTS:
        before = kernel.launches
        got = ops.stencil(x, name, time_steps=t, variant=variant,
                          epilogue=chain, epilogue_args=args,
                          strategy=strategy)
        assert kernel.launches == before + 1       # fused: one launch
        _close(got, engine.run_window_plan_reference(
            x, plan=p, time_steps=t, variant=variant, epilogue_args=args))


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_conv_residual_is_x(cuda, strategy, dtype):
    """'same' 5x5 with ("bias", "gelu", "residual_add") and the residual x
    itself, forward and the gradients of x, w, the bias and the residual
    (in the operand's shape and dtype)."""
    x = _grid((3, 90, 131), cuda, 62).to(dtype).requires_grad_(True)
    w = _grid((5, 5), cuda, 63).requires_grad_(True)
    b = torch.tensor([0.1], device=cuda, requires_grad=True)
    chain = ("bias", "gelu", "residual_add")
    kernel = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
    before = kernel.launches
    y = ops.conv2d(x, w, mode="same", epilogue=chain, epilogue_args=(b, x),
                   strategy=strategy)
    assert kernel.launches == before + 1
    p = dataclasses.replace(ssam_conv2d.plan_for_batched((5, 5), "same"),
                            strategy=strategy,
                            epilogue=normalize_epilogue(chain))
    rtol = 3e-5 if dtype == torch.float32 else 3e-2
    _close(y.float(), engine.run_window_plan_reference(
        x.detach(), w.detach(), plan=p,
        epilogue_args=(b.detach(), x.detach())).float(), rtol)
    r = x.detach().clone().requires_grad_(True)
    g = _grid(y.shape, cuda, 64).to(dtype)
    gx, gw, gb, gr = torch.autograd.grad(
        ops.conv2d(x, w, mode="same", epilogue=chain, epilogue_args=(b, r),
                   strategy=strategy), (x, w, b, r), g)
    assert gb.shape == b.shape and gr.shape == r.shape and gr.dtype == dtype
    xc, wc, bc, rc = (t.detach().cpu().float().requires_grad_(True)
                      for t in (x, w, b, r))
    want = torch.autograd.grad(ops.conv2d(
        xc, wc, mode="same", epilogue=chain, epilogue_args=(bc, rc)),
        (xc, wc, bc, rc), g.cpu().float())
    for got, exp in zip((gx, gw, gb, gr), want):
        _close(got.float().cpu(), exp, 1e-4 if dtype == torch.float32
               else 3e-2)


STRIDED = [((2, 2), "same"), ((1, 2), "same"), ((2, 1), "valid"),
           ((3, 3), "valid")]


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("shape", [(131, 259), (3, 67, 97)], ids=str)
@pytest.mark.parametrize("stride,mode", STRIDED, ids=str)
def test_strided_single_channel_conv(cuda, strategy, shape, stride, mode):
    """Forward (one launch, only the kept outputs), dx (one launch a phase
    a tap reaches) and dW (K3, per phase of x) of a strided 5x5 against
    the plain versions."""
    x = _grid(shape, cuda, 65)
    w = _grid((5, 5), cuda, 66)
    base = (ssam_conv2d.plan_for if len(shape) == 2
            else ssam_conv2d.plan_for_batched)((5, 5), mode)
    p = dataclasses.replace(base, stride=stride, strategy=strategy)
    kernel = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
    before = kernel.launches
    y = engine.run_window_plan(x, w, plan=p)
    assert kernel.launches == before + 1
    _close(y, engine.run_window_plan_reference(x, w, plan=p))
    g = _grid(y.shape, cuda, 67)
    wa = adjoint.adjoint_coeff_array(p, w)
    phases = [ph for ph in adjoint.strided_input_adjoint_phases(p)
              if ph.plan is not None and all(ph.extent(shape[-2:]))]
    before = kernel.launches
    dx = engine.run_adjoint_phases(g, wa, plan=p, in_spatial=shape[-2:])
    assert kernel.launches == before + len(phases)
    _close(dx, engine.run_adjoint_phases_reference(g, wa, plan=p,
                                                    in_spatial=shape[-2:]),
           1e-4)
    before = engine.WGRAD_KERNEL.launches
    dw = engine.run_weight_grad_plan(x, g, plan=p)
    assert engine.WGRAD_KERNEL.launches == before + \
        engine.WgradKernel.launches_for(x, g, plan=p)
    _close(dw, engine.run_weight_grad_plan_reference(x, g, plan=p), 1e-4)
    xb = x.to(torch.bfloat16)
    _close(engine.run_window_plan(xb, w, plan=p).float(),
           engine.run_window_plan_reference(xb, w, plan=p).float(), 3e-2)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
def test_residual_on_the_reduce_paths(cuda, strategy):
    xs, ws = (2, 16, 23, 75), (24, 16, 3, 3)
    x, w = _grid(xs, cuda, 68), _grid(ws, cuda, 69)
    b = _grid(ws[:1], cuda, 70)
    for stride in ((1, 1), (2, 2)):
        p = dataclasses.replace(
            ssam_conv2d.plan_for_nchw(xs, ws, "same"),
            stride=None if stride == (1, 1) else stride, strategy=strategy,
            epilogue=normalize_epilogue(("bias", "gelu", "residual_add")))
        r = _grid((2, 24) + p.out_shape(xs[2:]), cuda, 71)
        kernel = engine.MXU_KERNEL if strategy == "mxu" \
            else engine.WINDOW_KERNEL
        for rr in (r, r.to(torch.bfloat16)):        # converted once
            before = kernel.launches
            got = engine.run_window_plan(x, w, plan=p, epilogue_args=(b, rr))
            assert kernel.launches == before + 1
            _close(got, engine.run_window_plan_reference(
                x, w, plan=p, epilogue_args=(b, rr.float())), 1e-4)


def test_residual_on_the_perlane_path(cuda):
    x, w, b, g = _perlane_data(2, 131, 99, 4, cuda, 10)
    r = _grid(x.shape, cuda, 72)
    p = dataclasses.replace(ssam_conv1d.plan_for(4), epilogue=(
        normalize_epilogue(("bias", "silu", "residual_add"))))
    assert engine.perlane_layout(p, 2, 131, 99, 4).chain == "generic"
    for dt, rtol in (("float32", 3e-5), ("bfloat16", 3e-2)):
        xx, rr = x.to(getattr(torch, dt)), r.to(getattr(torch, dt))
        before = engine.WINDOW_KERNEL.launches
        got = engine.run_window_plan(xx, w, plan=p, epilogue_args=(b, rr))
        assert engine.WINDOW_KERNEL.launches == before + 1
        _close(got.float(), engine.run_window_plan_reference(
            xx, w, plan=p, epilogue_args=(b, rr)).float(), rtol)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("groups", [2, 8])
def test_grouped_conv2d(cuda, strategy, groups):
    """One launch a group; forward and gradients against the CPU."""
    x = _grid((2, 8, 20, 37), cuda, 73).requires_grad_(True)
    w = _grid((16, 8 // groups, 3, 3), cuda, 74).requires_grad_(True)
    b = _grid((16,), cuda, 75).requires_grad_(True)
    kernel = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
    before = kernel.launches
    y = ops.conv2d(x, w, groups=groups, epilogue=("bias", "relu"),
                   epilogue_args=(b,), strategy=strategy)
    assert kernel.launches == before + groups
    xc, wc, bc = (t.detach().cpu().requires_grad_(True) for t in (x, w, b))
    yc = ops.conv2d(xc, wc, groups=groups, epilogue=("bias", "relu"),
                    epilogue_args=(bc,))
    _close(y.detach().cpu(), yc.detach(), 1e-4)
    g = _grid(y.shape, cuda, 76)
    got = torch.autograd.grad(y, (x, w, b), g)
    want = torch.autograd.grad(yc, (xc, wc, bc), g.cpu())
    for a, e in zip(got, want):
        _close(a.cpu(), e, 1e-4)


# Depthwise conv2d (groups == C_in == C_out): one K1 launch over the B·C
# images, a filter per image; dx one K1 launch (a launch a phase when
# strided), dW K3's launches: (B, C, H, W, filter, mode, stride, dtype).
# C = 1024 at 7x7 holds more filters than a block's shared memory would.
DEPTHWISE = [
    (2, 8, 37, 70, (3, 3), "same", None, "float32"),
    (2, 5, 30, 41, (5, 5), "valid", None, "float32"),
    (3, 6, 33, 50, (3, 3), "same", (2, 2), "float32"),
    (2, 4, 29, 61, (7, 7), "same", (1, 2), "float32"),
    (1, 1024, 20, 24, (7, 7), "same", None, "float32"),
    (2, 8, 37, 70, (3, 3), "same", None, "bfloat16"),
]


@pytest.mark.parametrize("case", DEPTHWISE, ids=lambda c: "x".join(
    map(str, c[:4])) + f"-{c[4][0]}x{c[4][1]}-{c[5]}-{c[6]}-{c[7]}")
def test_depthwise_conv2d_one_launch(cuda, case):
    """Forward with bias+GELU+residual in one K1 launch; dx (K1), dW (K3,
    ``launches_for`` its launches), the bias row's and the residual's
    gradients; all against the CPU's (fp32 1e-4, bf16 3e-2)."""
    B, C, H, W, (N, M), mode, stride, dt = case
    dtype = getattr(torch, dt)
    rtol = 1e-4 if dt == "float32" else 3e-2
    x = _grid((B, C, H, W), cuda, 91).to(dtype).requires_grad_(True)
    w = (_grid((C, 1, N, M), cuda, 92) / (N * M) ** 0.5).requires_grad_(True)
    b = _grid((C,), cuda, 93).requires_grad_(True)
    chain = ("bias", "gelu", "residual_add")
    p = ops.depthwise_plan(tuple(x.shape), tuple(w.shape), groups=C,
                           mode=mode, stride=stride, epilogue=chain)
    assert p is not None and p.filters == C
    out = (B, C) + p.out_shape((H, W))
    r = _grid(out, cuda, 94).to(dtype).requires_grad_(True)
    K1, K3 = engine.WINDOW_KERNEL, engine.WGRAD_KERNEL
    before = K1.launches
    y = ops.conv2d(x, w, groups=C, mode=mode, stride=stride,
                   epilogue=chain, epilogue_args=(b, r))
    assert K1.launches == before + 1 and y.dtype == dtype
    g = _grid(out, cuda, 95).to(dtype)
    k1, k3 = K1.launches, K3.launches
    got = torch.autograd.grad(y, (x, w, b, r), g)
    lin = dataclasses.replace(p, epilogue=())
    phases = (sum(1 for ph in adjoint.strided_input_adjoint_phases(lin)
                  if ph.plan is not None and all(ph.extent((H, W))))
              if stride else 1)
    assert K1.launches - k1 == 1 + phases       # recompute, then dx
    assert K3.launches - k3 == K3.launches_for(
        x.detach().reshape(B * C, H, W), g.reshape((B * C,) + out[2:]),
        plan=lin)
    xc, wc, bc, rc = (t.detach().cpu().float().requires_grad_(True)
                      for t in (x, w, b, r))
    yc = ops.conv2d(xc, wc, groups=C, mode=mode, stride=stride,
                    epilogue=chain, epilogue_args=(bc, rc))
    _close(y.detach().cpu().float(), yc.detach(), rtol)
    want = torch.autograd.grad(yc, (xc, wc, bc, rc), g.cpu().float())
    for a, e in zip(got, want):
        _close(a.cpu().float(), e, rtol)


def test_depthwise_launch_failure_raises(cuda, monkeypatch):
    """A K1 launch that fails on the depthwise route raises; nothing
    falls back to the per-group route or the plain version."""
    x = _grid((2, 8, 20, 30), cuda, 96)
    w = _grid((8, 1, 3, 3), cuda, 97)
    lib = engine.WINDOW_KERNEL.library.get()
    monkeypatch.setattr(lib, "ssam_window_launch", lambda *a: 1)

    def boom(*a, **k):
        raise AssertionError("the plain version was reached")

    monkeypatch.setattr(engine, "run_window_plan_reference", boom)
    before = engine.WINDOW_KERNEL.launches
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        ops.conv2d(x, w, groups=8)
    assert engine.WINDOW_KERNEL.launches == before


# -- fused pipelines: a chain of stages in one K1 launch -----------------

def _chain(names, device, seed, conv=False):
    """Stage descriptors: stencil names, and with ``conv`` the conv chain
    ``[(w5, ("bias", "gelu")), (w3, "bias"), w5]`` (filters scaled to a
    unit gain) with its two mid-chain biases."""
    if not conv:
        return list(names), ()
    w5 = _grid((5, 5), device, seed) / 5
    w3 = _grid((3, 3), device, seed + 1) / 3
    b0 = torch.tensor([0.25], device=device)
    b1 = torch.tensor(-0.5, device=device)
    return [(w5, ("bias", "gelu")), (w3, "bias"), w5], (b0, b1)


def _fused_plan(x, stages):
    plans = [ops._pipeline_stage_plan(x, d, i) for i, d in enumerate(stages)]
    return (fuse.fuse_plans(*[p for p, _ in plans]),
            tuple(w for _, w in plans))


PIPE_CASES = [
    ("2d", (97, 203), ["2d5pt", "2d9pt", "2d5pt"], False, "float32"),
    ("2d-mid", (131, 259), ["2d5pt", ("2d9pt", ("relu", ("scale", 0.5))),
                            ("2d25pt", "silu")], False, "float32"),
    ("2d-conv", (77, 141), (), True, "float32"),
    ("2d-bf16", (97, 203), ["2d5pt", "2d9pt", "2d5pt"], False, "bfloat16"),
    ("2d-conv-bf16", (77, 141), (), True, "bfloat16"),
    ("3d", (21, 30, 75), ["3d7pt", "3d27pt"], False, "float32"),
    ("3d-mixed", (14, 22, 45), ["3d7pt", "3d125pt", "3d13pt"], False,
     "float32"),
    ("batched", (3, 67, 97), ["2d9pt", "2d5pt"], False, "float32"),
    ("nchw", (2, 3, 41, 70), (), True, "float32"),
]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", PIPE_CASES, ids=lambda c: c[0])
def test_pipeline_fused_one_launch(cuda, case, variant):
    """One K1 launch for the whole chain (mid-chain epilogues on the
    iterates, the final residual at the store for the conv chains), held
    to the plain version on the card (fp32 3e-5, bf16 3e-2) and to the
    CPU walk of the kernel."""
    tag, shape, names, conv, dt = case
    dtype = getattr(torch, dt)
    rtol = 3e-5 if dt == "float32" else 3e-2
    x = _grid(shape, cuda, 101).to(dtype)
    stages, mids = _chain(names, cuda, 102, conv)
    if conv:
        stages[-1] = (stages[-1], "residual_add")
    args = mids + ((_grid(shape, cuda, 103).to(dtype),) if conv else ())
    plan, ws = _fused_plan(x, stages)
    K1 = engine.WINDOW_KERNEL
    before = K1.launches
    y = ops.pipeline(x, stages, variant=variant, epilogue_args=args)
    assert K1.launches == before + 1 and y.dtype == dtype
    plain = engine.run_window_plan_reference(x, ws, plan=plan,
                                             variant=variant,
                                             epilogue_args=args)
    _close(y.float(), plain.float(), rtol)
    if dt == "float32" and x.numel() < 50_000:
        emu = engine.emulate_window_kernel(
            x.cpu(), tuple(None if w is None else w.cpu() for w in ws),
            plan=plan, variant=variant,
            epilogue_args=tuple(a.cpu() for a in args))
        _close(y.cpu(), emu, rtol)


def test_pipeline_launch_counts(cuda):
    """Fused forward 1 launch, a linear chain's gradient 1 more,
    ``fuse=False`` one a stage (and its backward one a stage); a conv
    chain's backward recomputes each stage (K1), then per stage dW (K3)
    and dx (K1); each equals the CPU's."""
    K1, K3 = engine.WINDOW_KERNEL, engine.WGRAD_KERNEL
    x = _grid((97, 203), cuda, 111).requires_grad_(True)
    chain = ["2d5pt", "2d9pt", "2d5pt"]
    k1 = K1.launches
    y = ops.pipeline(x, chain)
    assert K1.launches - k1 == 1
    g = _grid(y.shape, cuda, 112)
    (dx,) = torch.autograd.grad(y, x, g)
    assert K1.launches - k1 == 2
    k1 = K1.launches
    yu = ops.pipeline(x, chain, fuse=False)
    assert K1.launches - k1 == 3
    (dxu,) = torch.autograd.grad(yu, x, g)
    assert K1.launches - k1 == 6
    _close(yu, y)
    _close(dxu, dx)
    xc = x.detach().cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(ops.pipeline(xc, chain), xc, g.cpu())
    _close(dx.cpu(), want)
    # the conv chain: 3 recomputes, 2 dW, 3 dx
    stages, mids = _chain((), cuda, 113, conv=True)
    ws = [d[0] if isinstance(d, tuple) else d for d in stages]
    for w in ws:
        w.requires_grad_(True)
    mids = tuple(m.clone().requires_grad_(True) for m in mids)
    y = ops.pipeline(x, stages, epilogue_args=mids)
    k1, k3 = K1.launches, K3.launches
    got = torch.autograd.grad(y, (x, ws[0], ws[1], *mids), g)
    assert K1.launches - k1 == 6
    assert K3.launches - k3 == sum(K3.launches_for(
        torch.empty(sh, device=cuda), torch.empty(so, device=cuda),
        plan=p) for sh, so, p in _conv_chain_wgrads(x.shape, stages))
    cpu = [t.detach().cpu().requires_grad_(True)
           for t in (x, ws[0], ws[1], *mids)]
    cstages = [(cpu[1], ("bias", "gelu")), (cpu[2], "bias"), cpu[1]]
    yc = ops.pipeline(cpu[0], cstages, epilogue_args=tuple(cpu[3:]))
    want = torch.autograd.grad(yc, cpu, g.cpu())
    for a, e in zip(got, want):
        _close(a.cpu(), e, 1e-4)


def _conv_chain_wgrads(shape, stages):
    """``(x shape, g shape, plan)`` of each dW the conv chain's backward
    runs: the 'valid' stage plans on the pad-once intermediates."""
    plans = [ops._pipeline_stage_plan(torch.empty(shape), d, i)[0]
             for i, d in enumerate(stages)]
    lead, trail = fuse.summed_lead_trail(plans)
    cur = tuple(n + l + r for n, l, r in zip(shape, lead, trail))
    out = []
    for p in plans:
        nxt = tuple(n - e + 1 for n, e in zip(cur, p.exts))
        if p.coeff_mode == "dense":
            out.append((cur, nxt, dataclasses.replace(
                p, lead=None, trail=None, epilogue=())))
        cur = nxt
    return out


def test_pipeline_beyond_k1_raises(cuda):
    """A legal chain K1 cannot hold in one launch (three 2d121pt stages:
    33 column steps of 32) runs as its segments, a 2-stage chain and one
    stage (2 K1 launches), equal to the fused plain version; a stage that
    only a banded launch holds (a 3 x 33 filter: columns beyond one warp)
    is a segment of its own; a stage that no launch holds (129 x 129: 40
    bands) still raises NotImplementedError naming the limit, before
    anything launches; ``fuse=False`` runs a launch a stage."""
    x = _grid((64, 96), cuda, 121)
    K1 = engine.WINDOW_KERNEL
    before = K1.launches
    y = ops.pipeline(x, ["2d121pt"] * 3)
    assert K1.launches == before + 2
    plan, ws = _fused_plan(x, ["2d121pt"] * 3)
    _close(y, engine.run_window_plan_reference(x, ws, plan=plan))
    before = K1.launches
    w = _grid((3, 33), cuda, 122) / 10
    y = ops.pipeline(x, ["2d5pt", w])
    assert K1.launches == before + 2
    plan, ws = _fused_plan(x, ["2d5pt", w])
    _close(y, engine.run_window_plan_reference(x, ws, plan=plan))
    before = K1.launches
    with pytest.raises(NotImplementedError, match="bands.*Queue 2"):
        ops.pipeline(x, ["2d5pt", _grid((129, 129), cuda, 122)])
    assert K1.launches == before
    y = ops.pipeline(x, ["2d121pt"] * 3, fuse=False)
    assert K1.launches == before + 3
    _close(y.cpu(), ops.pipeline(x.cpu(), ["2d121pt"] * 3), 1e-4)


def test_pipeline_mxu_raises(cuda):
    """A chain pinned to ``strategy='mxu'`` is one K2 launch and no K1
    launch (K2's stage loop), equal to the plain version; ``fuse=False``
    runs K2 a stage."""
    x = _grid((64, 96), cuda, 131)
    K1, K2 = engine.WINDOW_KERNEL, engine.MXU_KERNEL
    k1, k2 = K1.launches, K2.launches
    y = ops.pipeline(x, ["2d5pt", "2d9pt"], strategy="mxu")
    assert (K1.launches - k1, K2.launches - k2) == (0, 1)
    plan, ws = _mxu_stages(x, ["2d5pt", "2d9pt"])
    _close(y, engine.run_window_plan_reference(x, ws, plan=plan))
    yu = ops.pipeline(x, ["2d5pt", "2d9pt"], strategy="mxu", fuse=False)
    assert (K1.launches - k1, K2.launches - k2) == (0, 3)
    _close(yu.cpu(), ops.pipeline(x.cpu(), ["2d5pt", "2d9pt"]), 1e-4)


def _mxu_stages(x, stages):
    """``(fused mxu plan, filters)`` of a descriptor chain."""
    res = [ops._pipeline_stage_plan(x, d, i) for i, d in enumerate(stages)]
    return (fuse.fuse_plans(*[ops._strategy_plan(p, "mxu", "pipeline")
                              for p, _ in res]),
            tuple(w for _, w in res))


@pytest.mark.parametrize("case", PIPE_CASES, ids=lambda c: c[0])
def test_pipeline_mxu_one_k2_launch(cuda, case):
    """K2 with stages: one K2 launch and no K1 launch for the whole chain
    pinned to mxu (each stage's entries and B tiles, its mid-chain
    epilogue on the iterate, the final residual at the store), held to
    the plain version on the card (fp32 3e-5, bf16 3e-2) and to the CPU
    walk of the kernel."""
    tag, shape, names, conv, dt = case
    dtype = getattr(torch, dt)
    rtol = 3e-5 if dt == "float32" else 3e-2
    x = _grid(shape, cuda, 141).to(dtype)
    stages, mids = _chain(names, cuda, 142, conv)
    if conv:
        stages[-1] = (stages[-1], "residual_add")
    args = mids + ((_grid(shape, cuda, 143).to(dtype),) if conv else ())
    plan, ws = _mxu_stages(x, stages)
    K1, K2 = engine.WINDOW_KERNEL, engine.MXU_KERNEL
    k1, k2 = K1.launches, K2.launches
    y = ops.pipeline(x, stages, strategy="mxu", epilogue_args=args)
    assert (K1.launches - k1, K2.launches - k2) == (0, 1)
    assert y.dtype == dtype
    plain = engine.run_window_plan_reference(x, ws, plan=plan,
                                             epilogue_args=args)
    _close(y.float(), plain.float(), rtol)
    if dt == "float32" and x.numel() < 50_000:
        emu = engine.emulate_mxu_kernel(
            x.cpu(), tuple(None if w is None else w.cpu() for w in ws),
            plan=plan, epilogue_args=tuple(a.cpu() for a in args))
        _close(y.cpu(), emu, rtol)


def test_pipeline_mxu_gradient_routes(cuda):
    """A linear mxu chain's gradient is one K2 launch of the reversed
    chain; the conv chain's backward recomputes each stage on K2, then
    per stage dW (K3) and dx (K2): 6 K2 launches and K3's
    ``launches_for``, no K1 launch; each against the CPU's at 1e-4."""
    K1, K2, K3 = engine.WINDOW_KERNEL, engine.MXU_KERNEL, engine.WGRAD_KERNEL
    x = _grid((97, 203), cuda, 151).requires_grad_(True)
    chain = ["2d5pt", "2d9pt", "2d5pt"]
    y = ops.pipeline(x, chain, strategy="mxu")
    g = _grid(y.shape, cuda, 152)
    k1, k2 = K1.launches, K2.launches
    (dx,) = torch.autograd.grad(y, x, g)
    assert (K1.launches - k1, K2.launches - k2) == (0, 1)
    xc = x.detach().cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(ops.pipeline(xc, chain, strategy="mxu"),
                                  xc, g.cpu())
    _close(dx.cpu(), want, 1e-4)
    stages, mids = _chain((), cuda, 153, conv=True)
    ws = [d[0] if isinstance(d, tuple) else d for d in stages]
    for w in ws:
        w.requires_grad_(True)
    mids = tuple(m.clone().requires_grad_(True) for m in mids)
    y = ops.pipeline(x, stages, strategy="mxu", epilogue_args=mids)
    k1, k2, k3 = K1.launches, K2.launches, K3.launches
    got = torch.autograd.grad(y, (x, ws[0], ws[1], *mids), g)
    assert (K1.launches - k1, K2.launches - k2) == (0, 6)
    assert K3.launches - k3 == sum(K3.launches_for(
        torch.empty(sh, device=cuda), torch.empty(so, device=cuda),
        plan=p) for sh, so, p in _conv_chain_wgrads(x.shape, stages))
    cpu = [t.detach().cpu().requires_grad_(True)
           for t in (x, ws[0], ws[1], *mids)]
    cstages = [(cpu[1], ("bias", "gelu")), (cpu[2], "bias"), cpu[1]]
    yc = ops.pipeline(cpu[0], cstages, strategy="mxu",
                      epilogue_args=tuple(cpu[3:]))
    want = torch.autograd.grad(yc, cpu, g.cpu())
    for a, e in zip(got, want):
        _close(a.cpu(), e, 1e-4)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_pipeline_mxu_nonfinite_input_reach(cuda, dt):
    """An inf and a nan in the input of an mxu chain: the kernel's
    non-finite outputs are exactly the plain version's (each stage's
    warp items re-summed where an iterate carries them), the rest equal
    it."""
    x = _grid((97, 203), cuda, 161)
    x[40, 50] = float("inf")
    x[10, 180] = float("nan")
    x = x.to(getattr(torch, dt))
    chain = ["2d5pt", ("2d9pt", "gelu"), "2d5pt"]
    plan, ws = _mxu_stages(x, chain)
    y = ops.pipeline(x, chain, strategy="mxu").float()
    want = engine.run_window_plan_reference(x, ws, plan=plan).float()
    torch.cuda.synchronize()
    bad = ~torch.isfinite(want)
    assert bad.any() and torch.equal(~torch.isfinite(y), bad)
    _close(y[~bad], want[~bad], 3e-5 if dt == "float32" else 3e-2)


SEGMENT_CASES = [
    # (tag, chain, strategy, launches of the forward)
    ("2d121pt x 3 lanes", ["2d121pt"] * 3, None, 2),
    ("2d121pt x 3 mxu", ["2d121pt"] * 3, "mxu", 1),
    ("2d5pt x 33 lanes", ["2d5pt"] * 33, None, 4),
    ("2d5pt x 33 mxu", ["2d5pt"] * 33, "mxu", 2),
]


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=lambda c: c[0])
def test_pipeline_segments_on_both_strategies(cuda, case):
    """A chain no launch holds runs as the fewest launches of sub-chains
    (``ops.chain_segments``) on the chain's strategy's kernel, the
    intermediates in fp32, equal to the fused plain version; its linear
    gradient one launch a segment, equal to the CPU's."""
    tag, chain, strategy, launches = case
    K = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
    other = engine.WINDOW_KERNEL if strategy == "mxu" else engine.MXU_KERNEL
    x = _grid((131, 259), cuda, 171).requires_grad_(True)
    k, o = K.launches, other.launches
    y = ops.pipeline(x, chain, strategy=strategy)
    assert (K.launches - k, other.launches - o) == (launches, 0)
    plans = [ops._strategy_plan(ops._pipeline_stage_plan(x, n, i)[0],
                                strategy, "pipeline")
             for i, n in enumerate(chain)]
    assert len(ops.chain_segments(plans, strategy)) == launches
    p = fuse.fuse_plans(*plans)
    _close(y, engine.run_window_plan_reference(x.detach(), (None,) * len(
        chain), plan=p))
    g = _grid(y.shape, cuda, 172)
    k = K.launches
    (dx,) = torch.autograd.grad(y, x, g)
    assert K.launches - k == launches
    xc = x.detach().cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(ops.pipeline(xc, chain, strategy=strategy),
                                  xc, g.cpu())
    _close(dx.cpu(), want, 1e-4)
    xb = x.detach().to(torch.bfloat16)
    yb = ops.pipeline(xb, chain, strategy=strategy)
    assert yb.dtype == torch.bfloat16
    _close(yb.float(), engine.run_window_plan_reference(
        xb, (None,) * len(chain), plan=p).float(), 3e-2)


def test_pipeline_segments_with_filters_and_epilogues(cuda):
    """A segmented chain of conv and stencil stages with mid-chain biases
    and a final residual, on both strategies: the fused plain version's
    output, and gradients against the CPU's at 1e-4."""
    x = _grid((97, 203), cuda, 181)
    w5, w3 = _grid((5, 5), cuda, 182) / 5, _grid((3, 3), cuda, 183) / 3
    b = [torch.tensor([v], device=cuda) for v in (0.3, -0.2, 0.1)]
    r = _grid((97, 203), cuda, 184)
    chain = [(w5, ("bias", "gelu")), ("2d121pt", "bias"), "2d121pt",
             ("2d121pt", "silu"), (w3, ("bias", "residual_add"))]
    for strategy in (None, "mxu"):
        K = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
        leaves = [t.clone().requires_grad_(True) for t in (x, w5, w3, *b, r)]
        xl, w5l, w3l, b0, b1, b2, rl = leaves
        cl = [(w5l, ("bias", "gelu")), ("2d121pt", "bias"), "2d121pt",
              ("2d121pt", "silu"), (w3l, ("bias", "residual_add"))]
        k = K.launches
        y = ops.pipeline(xl, cl, strategy=strategy,
                         epilogue_args=(b0, b1, b2, rl))
        assert K.launches - k == (1 if strategy == "mxu" else 2)
        res = [ops._pipeline_stage_plan(x, d, i) for i, d in enumerate(chain)]
        p = fuse.fuse_plans(*[ops._strategy_plan(q, strategy, "pipeline")
                              for q, _ in res])
        _close(y, engine.run_window_plan_reference(
            x, tuple(w for _, w in res), plan=p,
            epilogue_args=(*b, r)))
        g = _grid(y.shape, cuda, 185)
        got = torch.autograd.grad(y, leaves, g)
        cpu = [t.detach().cpu().requires_grad_(True) for t in leaves]
        cc = [(cpu[1], ("bias", "gelu")), ("2d121pt", "bias"), "2d121pt",
              ("2d121pt", "silu"), (cpu[2], ("bias", "residual_add"))]
        want = torch.autograd.grad(ops.pipeline(
            cpu[0], cc, strategy=strategy, epilogue_args=tuple(cpu[3:])),
            cpu, g.cpu())
        for a, e in zip(got, want):
            _close(a.cpu(), e, 1e-4)


# -- filters of any size: K1 in bands, K2 streaming its B tiles, K3 -------

LARGE = [(33, 33), (64, 64), (51, 5), (5, 51), (1, 127), (127, 1),
         (1, 255), (255, 1)]
# (footprint, strategy): K2 stages a tile's input row as one TMA box, so a
# filter of 255 columns stays K1's
LARGE_CASES = [(nm, s) for nm in LARGE for s in ("lanes", "mxu")
               if (nm, s) != ((1, 255), "mxu")]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("nm,strategy", LARGE_CASES,
                         ids=lambda v: f"{v[0]}x{v[1]}"
                         if isinstance(v, tuple) else v)
def test_large_filter_conv2d(cuda, nm, dt, strategy):
    """A batched single-channel 'same' conv whose filter one walk of K1's
    warp (or K2's resident B tiles) does not hold: one launch forward and
    one for dx (K1 walking the footprint in bands, K2 streaming its
    Toeplitz tiles in groups), dW on K3; forward and dx against the plain
    version at 3e-5 (bf16 3e-2), dW at 1e-4."""
    N, M = nm
    dtype = getattr(torch, dt)
    rtol = 3e-5 if dt == "float32" else 3e-2
    x = _grid((2, 150, 230), cuda, 141).to(dtype).requires_grad_(True)
    w = (_grid(nm, cuda, 142) / (N * M) ** 0.5).requires_grad_(True)
    K = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
    K3 = engine.WGRAD_KERNEL
    k = K.launches
    y = ops.conv2d(x, w, strategy=strategy)
    assert K.launches == k + 1 and y.dtype == dtype
    p = dataclasses.replace(ssam_conv2d.plan_for_batched(nm, "same"),
                            strategy=strategy)
    _close(y.detach().float(), engine.run_window_plan_reference(
        x.detach(), w.detach(), plan=p).float(), rtol)
    g = _grid(y.shape, cuda, 143).to(dtype)
    k, k3 = K.launches, K3.launches
    dx, dw = torch.autograd.grad(y, (x, w), g)
    assert K.launches == k + 1
    lin = dataclasses.replace(p, strategy="lanes")
    assert K3.launches - k3 == K3.launches_for(x.detach(), g, plan=lin)
    ap = adjoint.input_adjoint_plan(p)
    _close(dx.float(), engine.run_window_plan_reference(
        g, adjoint.adjoint_coeff_array(p, w.detach()), plan=ap).float(),
        rtol)
    _close(dw.float(), engine.run_weight_grad_plan_reference(
        x.detach(), g, plan=lin).float(), 1e-4 if dt == "float32" else 3e-2)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
def test_large_filter_launches_and_refusals(cuda, strategy):
    """A 33 x 33 'same' conv at a grid of several thousand tiles is one
    launch; a footprint beyond the banded walk (129 x 129: 40 bands) and
    beyond K2's streamed entries (774 of 256), and on K2 a row of 255
    columns (one TMA box), raise ``NotImplementedError`` naming ROADMAP
    Queue 2 before anything launches."""
    K = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
    x = _grid((1100, 1300), cuda, 144)
    w = _grid((33, 33), cuda, 145) / 33
    k = K.launches
    y = ops.conv2d(x, w, strategy=strategy)
    assert K.launches == k + 1
    p = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                            strategy=strategy)
    _close(y, engine.run_window_plan_reference(x, w, plan=p))
    k = K.launches
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        ops.conv2d(x[:300, :300], _grid((129, 129), cuda, 146),
                   strategy=strategy)
    if strategy == "mxu":
        with pytest.raises(NotImplementedError, match="TMA box"):
            ops.conv2d(x[:300, :300], _grid((1, 255), cuda, 146),
                       strategy=strategy)
    assert K.launches == k


@pytest.mark.parametrize("case", ["11x11 stride 4", "5x5x27 3-D",
                                  "31x31 t=2"])
def test_mxu_resident_beyond_32kb_of_tiles(cuda, case):
    """Plans of at most 1024 taps whose B tiles pass 32 KB and which K2's
    streamed walk would refuse (an output stride, 3-D, t > 1) keep their
    tiles resident on K2: one launch each, against the plain version at
    3e-5; the strided conv's dx through K2's phases too."""
    K = engine.MXU_KERNEL
    k = K.launches
    if case == "11x11 stride 4":
        x = _grid((2, 227, 227), cuda, 151).requires_grad_(True)
        w = _grid((11, 11), cuda, 152) / 11
        y = ops.conv2d(x, w, mode="valid", stride=4, strategy="mxu")
        assert K.launches == k + 1
        p = dataclasses.replace(ssam_conv2d.plan_for_batched((11, 11),
                                                             "valid"),
                                stride=(4, 4), strategy="mxu")
        _close(y.detach(), engine.run_window_plan_reference(
            x.detach(), w, plan=p))
        g = _grid(y.shape, cuda, 153)
        k = K.launches
        (dx,) = torch.autograd.grad(y, (x,), g)
        assert K.launches > k
        _close(dx, engine.run_adjoint_phases_reference(
            g, adjoint.adjoint_coeff_array(p, w), plan=p,
            in_spatial=(227, 227)))
        return
    sd, shape, t = ((_box_stencil("box5x5x27", (5, 5, 27)), (20, 40, 90), 1)
                    if case == "5x5x27 3-D" else
                    (_box_stencil("box31x31", (31, 31)), (300, 400), 2))
    x = _grid(shape, cuda, 154)
    y = ops.stencil(x, sd, time_steps=t, strategy="mxu")
    assert K.launches == k + 1
    mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
    p = dataclasses.replace(mod.plan_for(sd), strategy="mxu")
    _close(y, engine.run_window_plan_reference(x, plan=p, time_steps=t))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [2, 3])
def test_mxu_streamed_time_steps(cuda, t, dt):
    """A 33 x 33 box stencil (1089 taps: K2 streams its B tiles) at t > 1:
    one K2 launch, each application walking every group again, against
    the plain version at 3e-5 (bf16 3e-2)."""
    sd = _box_stencil("box33x33", (33, 33))
    x = _grid((300, 400), cuda, 155).to(getattr(torch, dt))
    K = engine.MXU_KERNEL
    k = K.launches
    y = ops.stencil(x, sd, time_steps=t, strategy="mxu")
    assert K.launches == k + 1 and y.dtype == x.dtype
    p = dataclasses.replace(ssam_stencil2d.plan_for(sd), strategy="mxu")
    _close(y.float(), engine.run_window_plan_reference(
        x, plan=p, time_steps=t).float(), 3e-5 if dt == "float32" else 3e-2)


@pytest.mark.parametrize("nm", [(51, 5), (5, 51)], ids=str)
def test_large_depthwise_one_launch(cuda, nm):
    """ConvNeXt-style depthwise stripes (SLaK's 51 x 5 and 5 x 51) with a
    bias: one K1 launch over the B·C images forward; the backward one K1
    launch for the pre-activation and one for dx, dW on K3; against the
    CPU at 1e-4."""
    N, M = nm
    B, C, H, W = 2, 96, 56, 56
    x = _grid((B, C, H, W), cuda, 147).requires_grad_(True)
    w = (_grid((C, 1, N, M), cuda, 148) / (N * M) ** 0.5).requires_grad_(True)
    b = _grid((C,), cuda, 149).requires_grad_(True)
    assert ops.depthwise_plan(tuple(x.shape), tuple(w.shape), groups=C,
                              mode="same", epilogue=("bias",)) is not None
    K1 = engine.WINDOW_KERNEL
    k1 = K1.launches
    y = ops.conv2d(x, w, groups=C, epilogue=("bias",), epilogue_args=(b,))
    assert K1.launches == k1 + 1
    g = _grid(y.shape, cuda, 150)
    k1 = K1.launches
    got = torch.autograd.grad(y, (x, w, b), g)
    assert K1.launches == k1 + 2
    xc, wc, bc = (t.detach().cpu().requires_grad_(True) for t in (x, w, b))
    yc = ops.conv2d(xc, wc, groups=C, epilogue=("bias",), epilogue_args=(bc,))
    _close(y.detach().cpu(), yc.detach(), 1e-4)
    want = torch.autograd.grad(yc, (xc, wc, bc), g.cpu())
    for a, e in zip(got, want):
        _close(a.cpu(), e, 1e-4)


NCHW_LARGE = [
    # (x shape, w shape, mode, stride): a 9 x 9 'same' (81 taps) and
    # AlexNet's conv1, 11 x 11 at stride 4 (121 taps, x in column phases)
    ((2, 16, 40, 50), (24, 16, 9, 9), "same", None),
    ((2, 3, 227, 227), (96, 3, 11, 11), "valid", (4, 4)),
]


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", NCHW_LARGE, ids=lambda c: f"{c[1][2]}x"
                         f"{c[1][3]}")
def test_nchw_backward_beyond_64_taps(cuda, case, dt, strategy):
    """The backward of an NCHW conv of more than 64 taps: dW on K3's
    channel kernel (its taps computed from their index, no table), dx on
    the strategy's kernel; against the plain version (fp32 1e-4, bf16
    3e-2)."""
    xs, ws, mode, stride = case
    dtype = getattr(torch, dt)
    rtol = 1e-4 if dt == "float32" else 3e-2
    x = _grid(xs, cuda, 151).to(dtype).requires_grad_(True)
    w = (_grid(ws, cuda, 152) / (ws[1] * ws[2] * ws[3]) ** 0.5
         ).requires_grad_(True)
    y = ops.conv2d(x, w, mode=mode, stride=stride, strategy=strategy)
    g = _grid(y.shape, cuda, 153).to(dtype)
    K3 = engine.WGRAD_KERNEL
    p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                            stride=stride)
    k3 = K3.launches
    dx, dw = torch.autograd.grad(y, (x, w), g)
    assert K3.launches - k3 == K3.launches_for(x.detach(), g, plan=p)
    _close(dw.float(), engine.run_weight_grad_plan_reference(
        x.detach(), g, plan=p).float(), rtol)
    xc, wc = (t.detach().cpu().float().requires_grad_(True) for t in (x, w))
    yc = ops.conv2d(xc, wc, mode=mode, stride=stride)
    _close(y.detach().cpu().float(), yc.detach(), rtol)
    (want,) = torch.autograd.grad(yc, xc, g.cpu().float())
    _close(dx.cpu().float(), want, rtol)


def test_large_filter_pipeline_segment(cuda):
    """``ops.pipeline(x, ["2d5pt", w_3x33])`` on K1: the 3 x 33 stage, which
    no fused chain holds (K1 walks it in bands), runs as a segment of its
    own; on K2 (which holds a 3 x 33 stage in a chain) a 33 x 33 stage,
    whose B tiles K2 streams, does; each equal to the fused plain
    version."""
    x = _grid((64, 96), cuda, 154)
    for strategy, w in ((None, _grid((3, 33), cuda, 155) / 10),
                        ("mxu", _grid((33, 33), cuda, 156) / 33)):
        K = engine.MXU_KERNEL if strategy == "mxu" else engine.WINDOW_KERNEL
        k = K.launches
        y = ops.pipeline(x, ["2d5pt", w], strategy=strategy)
        assert K.launches - k == 2
        plans = [ops._strategy_plan(ops._pipeline_stage_plan(x, d, i)[0],
                                    strategy, "pipeline")
                 for i, d in enumerate(["2d5pt", w])]
        assert ops.chain_segments(plans, strategy) == [(0,), (1,)]
        _close(y, engine.run_window_plan_reference(
            x, (None, w), plan=fuse.fuse_plans(*plans)))
