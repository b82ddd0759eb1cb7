"""K1 and K5 on the card against their plain versions (needs a CUDA card).

This file imports only torch and the port, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every case skips. Tolerance: K1 fp32 3e-5 relative to
the largest plain value (DESIGN.md §6), bf16 3e-2; K5 fp32 rtol 1e-5 with
atol 1e-5·max|plain| (the kernel and the plain version differ only in
the order of the prefix products), bf16 3e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.config import get_config
from repro_torch.core import engine, plan
from repro_torch.kernels import ops, ref, ssam_conv2d, ssam_stencil2d
from repro_torch.kernels import ssam_stencil3d, stencils
from repro_torch.launch import serve
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
