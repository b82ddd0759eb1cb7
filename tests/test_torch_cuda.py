"""K1 on the card against its plain version (needs a CUDA card).

This file imports only torch and the port, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every case skips. Tolerance: fp32 3e-5 relative to the
largest plain value (DESIGN.md §6), bf16 3e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.kernels import ops, ref, ssam_conv2d, ssam_stencil2d
from repro_torch.kernels import ssam_stencil3d, stencils

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
