"""K6's spec in the port: ``repro_torch.core.engine_gpu.warp_shift``.

The identities of ``tests/test_engine_gpu.py::TestWarpShift`` carried
over: the warp decomposition of a lane roll equals ``torch.roll`` bit for
bit, and equals the JAX package's ``warp_shift`` on the same numpy
inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine_gpu import warp_shift as jwarp_shift
from repro_torch.core.engine_gpu import warp_shift


def _v(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bitwise(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shift", [0, 1, 5, 31, 32, 33, 64, 95, 127])
@pytest.mark.parametrize("lanes", [32, 64, 128, 256])
def test_bitwise_roll_warp_aligned(lanes, shift):
    v = _v((6, lanes), lanes + shift)
    got = warp_shift(torch.from_numpy(v), shift)
    _bitwise(got, torch.roll(torch.from_numpy(v), shift, dims=-1))
    _bitwise(got, jwarp_shift(jnp.asarray(v), shift))


@pytest.mark.parametrize("shift", [1, 17, 32, 40])
def test_negative_shift_shfl_down(shift):
    v = _v((4, 128), shift)
    got = warp_shift(torch.from_numpy(v), -shift)
    _bitwise(got, torch.roll(torch.from_numpy(v), -shift, dims=-1))
    _bitwise(got, jwarp_shift(jnp.asarray(v), -shift))


@pytest.mark.parametrize("lanes", [8, 48, 100])
def test_fractional_warp_falls_back(lanes):
    v = _v((3, lanes), lanes)
    got = warp_shift(torch.from_numpy(v), 3)
    _bitwise(got, torch.roll(torch.from_numpy(v), 3, dims=-1))
    _bitwise(got, jwarp_shift(jnp.asarray(v), 3))


def test_nd_leading_axes():
    v = _v((2, 3, 4, 64), 1)
    got = warp_shift(torch.from_numpy(v), 33)
    _bitwise(got, torch.roll(torch.from_numpy(v), 33, dims=-1))
    _bitwise(got, jwarp_shift(jnp.asarray(v), 33))


def test_custom_warp_width():
    v = _v((2, 64), 2)
    got = warp_shift(torch.from_numpy(v), 10, warp=16)
    _bitwise(got, torch.roll(torch.from_numpy(v), 10, dims=-1))
    _bitwise(got, jwarp_shift(jnp.asarray(v), 10, warp=16))


def test_lanes_below_the_delta_take_the_previous_warp():
    """Inside a warp the shuffle keeps lanes ``l ≥ r`` of the warp; lanes
    below ``r`` come from the previous warp's top (the hand-off)."""
    v = torch.arange(64.0)[None]
    got = warp_shift(v, 3)[0]
    assert got[3:32].equal(torch.arange(0.0, 29.0))
    assert got[32:35].tolist() == [29.0, 30.0, 31.0]
    assert got[:3].tolist() == [61.0, 62.0, 63.0]
