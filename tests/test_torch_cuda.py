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
version at K1's tolerances (3e-5 single-channel, 1e-4 NCHW), and against
K1 at 1e-4, the reference's lanes-versus-mxu tolerance. K1's per-lane
(depthwise conv1d) path at fp32 3e-5, bf16 3e-2; K4 (per-lane weight
gradient, sums over B·T products in another order) at fp32 1e-4, bf16
3e-2; gradients through K1, K4 and K5 against the CPU's at 1e-4.
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch import convert
from repro_torch.config import get_config
from repro_torch.configs import whisper_base
from repro_torch.core import adjoint, engine, plan
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
        _close(got, ref.conv2d_nchw(x, w, mode, stride), 1e-4)
    # the input adjoint of the stride-free plan (a full-mode plan for
    # 'valid'), on the cotangent's shape
    lin = dataclasses.replace(p, stride=None, epilogue=())
    a = adjoint.input_adjoint_plan(lin)
    g = _grid((xs[0], ws[0]) + lin.out_shape(xs[2:]), cuda, 14)
    wa = adjoint.adjoint_coeff_array(lin, w)
    _close(engine.run_window_plan(g, wa, plan=a),
           engine.run_window_plan_reference(g, wa, plan=a), 1e-4)


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
    ((2, 5, 3, 300), (37, 5, 3, 3), "same"),
    ((8, 80, 1, 700), (64, 80, 1, 3), "same"),
    ((1, 1, 1, 1), (1, 1, 1, 1), "valid"),
    ((2, 3, 9, 70), (130, 3, 2, 5), "valid"),
    ((4, 130, 70), None, "same"),            # (N, M) layout, batched
    ((500, 333), None, "valid"),             # (N, M) layout, one image
]


@pytest.mark.parametrize("xs,ws,mode", WGRAD_CASES, ids=str)
def test_wgrad_kernel_matches_plain_version(cuda, xs, ws, mode):
    x = _grid(xs, cuda, 18)
    if ws is None:
        p = (ssam_conv2d.plan_for_batched if len(xs) == 3
             else ssam_conv2d.plan_for)((5, 7), mode)
    else:
        p = ssam_conv2d.plan_for_nchw(xs, ws, mode)
    lead = xs[:len(xs) - 2]
    if ws is not None:
        lead = (xs[0], ws[0])
    g = _grid(lead + p.out_shape(xs[-2:]), cuda, 19)
    before = engine.WGRAD_KERNEL.launches
    got = engine.run_weight_grad_plan(x, g, plan=p)
    assert engine.WGRAD_KERNEL.launches == before + \
        engine.WGRAD_KERNEL.launches_for(x, g, plan=p)
    want = engine.run_weight_grad_plan_reference(x, g, plan=p)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, 1e-4)
    if len(xs) == 4:
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        _close(engine.run_weight_grad_plan(xb, gb, plan=p),
               engine.run_weight_grad_plan_reference(xb, gb, plan=p), 3e-2)


def test_conv_autograd_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached on the card")

    monkeypatch.setattr(engine, "run_window_plan_reference", boom)
    monkeypatch.setattr(engine, "run_weight_grad_plan_reference", boom)
    x = _grid((2, 6, 1, 90), cuda, 20).requires_grad_()
    w = _grid((8, 6, 1, 3), cuda, 21).requires_grad_()
    b = _grid((8,), cuda, 22).requires_grad_()
    k1, k3 = engine.WINDOW_KERNEL.launches, engine.WGRAD_KERNEL.launches
    y = ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
                   epilogue_args=(b,))
    y.square().sum().backward()
    # forward, recomputed pre-activation, dx; dW (its split reduction)
    assert engine.WINDOW_KERNEL.launches == k1 + 3
    assert engine.WGRAD_KERNEL.launches == k3 + \
        engine.WGRAD_KERNEL.launches_for(x, torch.empty(2, 8, 1, 90),
                                         plan=ssam_conv2d.plan_for_nchw(
                                             x.shape, w.shape, "same"))
    assert x.grad.is_cuda and w.grad.is_cuda and b.grad.is_cuda
    s = _grid((30, 40), cuda, 23).requires_grad_()
    ops.stencil(s, "2d9pt", time_steps=2).sum().backward()
    assert engine.WINDOW_KERNEL.launches == k1 + 5
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        engine.run_weight_grad_plan(x.detach(), y.detach().cpu(),
                                    plan=ssam_conv2d.plan_for_nchw(
                                        x.shape, w.shape, "same"))


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
    (conv1 and conv2, the latter on the scattered, stride-free cotangent)."""
    T = 2 * cfg.n_frames
    mel = torch.empty(batch, cfg.n_mels, 1, T)
    h = torch.empty(batch, cfg.d_model, 1, T)
    launches = engine.WGRAD_KERNEL.launches_for
    return sum(launches(x, h, plan=ssam_conv2d.plan_for_nchw(
        x.shape, (cfg.d_model, x.shape[1], 1, 3), "same")) for x in (mel, h))


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


@pytest.mark.parametrize("xs,ws,mode,stride,epi", REDUCE_CASES, ids=str)
def test_mxu_reduce_matches_plain_version(cuda, xs, ws, mode, stride, epi):
    x, w = _grid(xs, cuda, 11), _grid(ws, cuda, 12)
    b = _grid(ws[:1], cuda, 13)
    p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                            stride=None if stride == (1, 1) else stride,
                            epilogue=plan.normalize_epilogue(epi),
                            strategy="mxu")
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
    with pytest.raises(NotImplementedError, match="5c"):
        engine.run_window_plan(_grid((20, 40), cuda), _grid((3, 40), cuda),
                               plan=plan.depthwise_conv1d_plan(3),
                               strategy="mxu")
    assert engine.MXU_KERNEL.launches == before + 5


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


def test_perlane_bad_calls_raise_on_the_card(cuda):
    x = _grid((1, 20, 40), cuda)
    with pytest.raises(ValueError, match="same device"):
        ops.conv1d_causal(x, torch.ones(4, 40))
    with pytest.raises(ValueError, match="up to 8 taps"):
        ops.conv1d_causal(x, _grid((9, 40), cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.conv1d_causal(x.double(), _grid((4, 40), cuda).double())
    with pytest.raises(NotImplementedError, match="5c"):
        ops.conv1d_causal(x, _grid((4, 40), cuda), strategy="mxu")


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
