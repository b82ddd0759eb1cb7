"""Plain-torch oracles for the windowed kernels — the ground truth in tests.

Each function is a direct statement of the math with no systolic
structure: shifted-slice sums in fp32, no library convolution (whose
TF32 default on the card would not meet the fp32 tolerance). The scan
oracles are fp32 and sequential.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .stencils import StencilDef


def conv2d_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation: out[y,x] = Σ_{n,m} x[y+n, x+m]·w[n,m]."""
    N, M = w.shape
    H, W = x.shape[-2:]
    xf, wf = x.float(), w.float()
    out = xf.new_zeros(x.shape[:-2] + (H - N + 1, W - M + 1))
    for n in range(N):
        for m in range(M):
            out = out + xf[..., n:n + H - N + 1, m:m + W - M + 1] * wf[n, m]
    return out.to(x.dtype)


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'Same' zero-boundary cross-correlation, anchor at filter centre."""
    N, M = w.shape
    top, left = (N - 1) // 2, (M - 1) // 2
    return conv2d_valid(F.pad(x, (left, M - 1 - left, top, N - 1 - top)), w)


def conv2d_batched(x: torch.Tensor, w: torch.Tensor,
                   mode: str = "valid") -> torch.Tensor:
    """Minibatch of single-channel images against one filter: (B, H, W)."""
    return conv2d_same(x, w) if mode == "same" else conv2d_valid(x, w)


def conv2d_nchw(x: torch.Tensor, w: torch.Tensor, mode: str = "valid",
                groups: int = 1, *, stride=(1, 1)) -> torch.Tensor:
    """Batched multi-channel cross-correlation, then an output stride.

    x: (B, C_in, H, W); w: (C_out, C_in/groups, N, M) → (B, C_out, H', W'):
    ``out[b,o,y,x] = Σ_{c,n,m} xp[b, c, y·sh + n, x·sw + m]·w[o,c,n,m]``,
    ``c`` over the input channels of ``o``'s group. 'same' mode anchors at
    the filter centre (top = (N−1)//2), as :func:`conv2d_same`; ``groups``
    runs one correlation per channel slice and concatenates them on C_out
    (the reference's ``feature_group_count``); a stride keeps every
    ``s``-th output of the dense result. The channel sum is one fp32
    (fp64 for fp64 inputs) contraction per tap.
    """
    if int(groups) != groups or groups < 1 or x.shape[1] % groups \
            or w.shape[0] % groups or w.shape[1] * groups != x.shape[1]:
        raise ValueError(f"conv2d_nchw: groups={groups} does not split x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)}")
    if groups > 1:
        return torch.cat([conv2d_nchw(xg, wg, mode, stride=stride)
                          for xg, wg in zip(x.chunk(groups, 1),
                                            w.chunk(groups, 0))], dim=1)
    N, M = w.shape[2:]
    sh, sw = stride
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, wf = x.to(acc), w.to(acc)
    if mode == "same":
        top, left = (N - 1) // 2, (M - 1) // 2
        xf = F.pad(xf, (left, M - 1 - left, top, N - 1 - top))
    H, W = xf.shape[-2:]
    Ho, Wo = (H - N) // sh + 1, (W - M) // sw + 1
    out = xf.new_zeros((x.shape[0], w.shape[0], Ho, Wo))
    for n in range(N):
        for m in range(M):
            patch = xf[..., n:n + (Ho - 1) * sh + 1:sh,
                       m:m + (Wo - 1) * sw + 1:sw]
            out = out + torch.einsum("bchw,oc->bohw", patch, wf[:, :, n, m])
    return out.to(x.dtype)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: y[b,t,d] = Σ_k x[b, t−K+1+k, d]·w[k,d], in
    fp32 (fp64 for fp64 inputs)."""
    T = x.shape[1]
    K = w.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (0, 0, K - 1, 0))
    out = xp.new_zeros(x.shape)
    for k in range(K):
        out = out + xp[:, k:k + T, :] * w[k, :].to(acc)
    return out.to(x.dtype)


def stencil_apply(x: torch.Tensor, sdef: StencilDef) -> torch.Tensor:
    """One same-shape stencil application with zeros outside the domain."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for off, c in zip(sdef.offsets, sdef.coeffs):
        shifted = x.float()
        for axis, d in enumerate(off):
            if d == 0:
                continue
            shifted = torch.roll(shifted, -d, dims=axis)
            idx = torch.arange(x.shape[axis], device=x.device)
            mask = idx < x.shape[axis] - d if d > 0 else idx >= -d
            shape = [1] * x.ndim
            shape[axis] = x.shape[axis]
            shifted = shifted * mask.reshape(shape)
        out = out + shifted * c
    return out.to(x.dtype)


def stencil_iterate(x: torch.Tensor, sdef: StencilDef,
                    steps: int) -> torch.Tensor:
    """``steps`` applications with the *pad-once* (trapezoidal) semantics:
    the domain is zero-padded once by ``steps`` footprints, then ``steps``
    valid applications follow (the intermediate iterates are not
    re-zeroed outside the domain)."""
    los = [min(o[a] for o in sdef.offsets) for a in range(sdef.ndim)]
    his = [max(o[a] for o in sdef.offsets) for a in range(sdef.ndim)]
    pad = []
    for lo, hi in reversed(list(zip(los, his))):
        pad += [steps * -lo, steps * hi]
    xp = F.pad(x.float(), pad)
    for _ in range(steps):
        new_shape = tuple(s - (hi - lo)
                          for s, lo, hi in zip(xp.shape, los, his))
        out = xp.new_zeros(new_shape)
        for off, c in zip(sdef.offsets, sdef.coeffs):
            sl = tuple(slice(d - lo, d - lo + n)
                       for d, lo, n in zip(off, los, new_shape))
            out = out + xp[sl] * c
        xp = out
    return xp.to(x.dtype)


def stencil_iterate_dirichlet(x: torch.Tensor, sdef: StencilDef,
                              steps: int) -> torch.Tensor:
    """Classic iteration: re-apply zero boundary conditions every step."""
    for _ in range(steps):
        x = stencil_apply(x, sdef)
    return x


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.float(), dim=-1).to(x.dtype)


def sat(x: torch.Tensor) -> torch.Tensor:
    """Summed-area table: SAT[y,x] = Σ_{i≤y,j≤x} X[i,j]."""
    s = torch.cumsum(x.float(), dim=-1)
    return torch.cumsum(s, dim=-2).to(x.dtype)


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequential gold: h_t = a_t·h_{t−1} + b_t along the last axis, fp32."""
    a32, b32 = a.float(), b.float()
    h = a32.new_zeros(a.shape[:-1])
    hs = []
    for t in range(a.shape[-1]):
        h = a32[..., t] * h + b32[..., t]
        hs.append(h)
    return torch.stack(hs, dim=-1).to(a.dtype)
