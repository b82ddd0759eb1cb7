"""RWKV6 ("Finch") blocks over the SSAM linear-recurrence plan.

The WKV state recurrence ``S_t = diag(exp(logw_t))·S_{t−1} + k_tᵀv_t`` is
diagonal per ``(head, k, v)`` channel, so it runs as scalar rows
``h_t = a_t·h_{t−1} + b_t`` through the scan engine — K5 on the card.
Schedules (:func:`wkv6_chunked`'s ``impl``):

* ``'engine'`` (the default) streams ``(B, chunk, H, K, V)`` slabs, one
  engine call per chunk with the state as its carry;
* ``'engine_unchunked'`` runs all of T in one engine call.

The reference's ``'chunked'`` matmul (GLA) schedule and the Mamba half of
the reference module are not ported yet (ROADMAP Queue 1 items 5b, 5c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .spec import ParamSpec

WKV_IMPLS = ("engine", "engine_unchunked")


def rwkv6_timemix_specs(d: int, *, n_heads: int, head_k: int, head_v: int,
                        shift_lora: int = 32, decay_lora: int = 64) -> dict:
    return {
        "mu_x": ParamSpec((d,), ("embed",), init="small"),
        "mu": ParamSpec((5, d), (None, "embed"), init="small"),
        "shift_w1": ParamSpec((d, 5 * shift_lora), ("embed", "lora"),
                              init="small"),
        "shift_w2": ParamSpec((5, shift_lora, d), (None, "lora", "embed"),
                              init="small"),
        "w0": ParamSpec((n_heads, head_k), ("heads", "head_dim"),
                        init="small"),
        "decay_w1": ParamSpec((d, decay_lora), ("embed", "lora"),
                              init="small"),
        "decay_w2": ParamSpec((decay_lora, n_heads, head_k),
                              ("lora", "heads", "head_dim"), init="small"),
        "u": ParamSpec((n_heads, head_k), ("heads", "head_dim"),
                       init="small"),
        "wr": ParamSpec((d, n_heads, head_k), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, n_heads, head_k), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, n_heads, head_v), ("embed", "heads", "head_dim")),
        "wg": ParamSpec((d, n_heads, head_v), ("embed", "heads", "head_dim")),
        "ln_x": ParamSpec((n_heads, head_v), ("heads", "head_dim"),
                          init="ones"),
        "wo": ParamSpec((n_heads, head_v, d), ("heads", "head_dim", "embed")),
    }


def _wkv_out(r32, S_prev, diag_u, k32, v32):
    """``y_t = r_t·S_{t−1} + (r_t⊙u⊙k_t)·v_t`` over (B, L, H, ·)."""
    diag = (r32 * diag_u * k32).sum(-1)
    return (torch.einsum("blhk,blhkv->blhv", r32, S_prev)
            + diag[..., None] * v32)


def _transfer_pairs(k, v, logw, shape):
    """The WKV transfer pairs ``(exp(logw)[k], k[k]·v[v])`` as (…, K, V)."""
    k32 = k.float()
    a = torch.exp(logw.float())[..., None].expand(shape)
    b = k32[..., None] * v.float()[..., None, :]
    return a, b


def _wkv6_engine(r, k, v, logw, u):
    """WKV6 in one engine call over all of T: materializes the
    (B, T, H, K, V) state history (the validation schedule)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    a, b = _transfer_pairs(k, v, logw, (B, T, H, K, V))
    S = ops.chunked_linear_recurrence(a.movedim(1, -1), b.movedim(1, -1),
                                      impl="engine_unchunked")
    S = S.movedim(-1, 1)                                          # (B,T,H,K,V)
    S_prev = torch.cat([torch.zeros_like(S[:, :1]), S[:, :-1]], dim=1)
    y = _wkv_out(r.float(), S_prev, u[None, None].float(), k.float(),
                 v.float())
    return y.to(r.dtype), S[:, -1]


def _wkv6_engine_stream(r, k, v, logw, u, *, chunk):
    """Chunk-streamed WKV6: each ``(B, L, H, K, V)`` slab's recurrence runs
    as ``B·H·K·V`` rows through one ``ops.linear_recurrence_carry`` call
    (one K5 launch on the card) seeded with the state, and the output
    contraction happens before the next chunk. The state of the chunk's
    first position is the carry-in. T pads to whole chunks with
    ``logw = 0`` and ``k = v = 0``: identity steps."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    L = min(chunk, T)
    pad = (-T) % L
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    u32 = u[None, None].float()
    S = torch.zeros((B * H * K * V, 1), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(0, T + pad, L):
        r_k, k_k, v_k, w_k = (t[:, c:c + L] for t in (r, k, v, logw))
        a, b = _transfer_pairs(k_k, v_k, w_k, (B, L, H, K, V))
        rows_a = a.movedim(1, -1).reshape(-1, L)                  # (B·H·K·V, L)
        rows_b = b.movedim(1, -1).reshape(-1, L)
        Ss, S_new = ops.linear_recurrence_carry(rows_a, rows_b, S)
        Ss = Ss.reshape(B, H, K, V, L).movedim(-1, 1)             # (B,L,H,K,V)
        S_prev = torch.cat([S.reshape(B, 1, H, K, V), Ss[:, :-1]], dim=1)
        ys.append(_wkv_out(r_k.float(), S_prev, u32, k_k.float(),
                           v_k.float()))
        S = S_new
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(r.dtype), S.reshape(B, H, K, V)


def wkv6_chunked(r, k, v, logw, u, *, chunk: int = 64,
                 impl: str = "engine"):
    """WKV6: y_t = r_t·S_{t−1} + (r_t⊙u⊙k_t)·v_t,
    S_t = diag(exp(logw_t))·S_{t−1} + k_tᵀv_t.

    r, k, logw: (B, T, H, K); v: (B, T, H, V); u: (H, K). logw ≤ 0.
    Returns (y, S_last) with S_last (B, H, K, V) fp32. ``impl`` names the
    schedule: 'engine' (chunk-streamed) or 'engine_unchunked'.
    """
    if impl == "engine":
        return _wkv6_engine_stream(r, k, v, logw, u, chunk=chunk)
    if impl == "engine_unchunked":
        return _wkv6_engine(r, k, v, logw, u)
    if impl == "chunked":
        raise NotImplementedError(
            "wkv6_chunked(impl='chunked'), the GLA matmul schedule, is not "
            "ported yet (ROADMAP Queue 1 item 5b)")
    raise ValueError(f"impl must be one of {WKV_IMPLS}, got {impl!r}")


def wkv6_sequential(r, k, v, logw, u):
    """Sequential oracle for wkv6 (a loop over time, fp32)."""
    B, T, H, K = r.shape
    r, k, v, logw = r.float(), k.float(), v.float(), logw.float()
    u32 = u[None].float()
    S = torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                    device=r.device)
    ys = []
    for t in range(T):
        r_t, k_t, v_t = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, S)
                  + (r_t * u32 * k_t).sum(-1)[..., None] * v_t)
        S = (torch.exp(logw[:, t])[..., None] * S
             + k_t[..., None] * v_t[..., None, :])
    return torch.stack(ys, dim=1), S


def _token_shift(x, shifted=None):
    """Previous-token stream: the width-2 SSAM conv1d special case."""
    if shifted is not None:
        return shifted
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _previous(x, state):
    return (_token_shift(x) if state is None
            else torch.cat([state["prev"], x[:, :-1]], dim=1))


def rwkv6_timemix_apply(p, x, *, n_heads: int, head_k: int, head_v: int,
                        chunk: int = 64, state=None,
                        wkv_impl: str = "engine"):
    """RWKV6 time-mix. state (decode): {"S": (B,H,K,V), "prev": (B,1,d)}.

    Without a state the WKV runs over the whole sequence through
    :func:`wkv6_chunked` (``wkv_impl`` the schedule); with one, one token
    steps the recurrence in plain torch.
    """
    B, T, d = x.shape
    dt = x.dtype
    dx = _previous(x, state) - x
    # data-dependent token shift (ddlerp, the "Finch" contribution)
    xxx = x + dx * p["mu_x"].to(dt)
    lora = torch.tanh(xxx @ p["shift_w1"].to(dt)).reshape(B, T, 5, -1)
    mix = torch.einsum("btfl,fld->btfd", lora, p["shift_w2"].to(dt))
    mix = mix + p["mu"].to(dt)[None, None]
    xw, xk, xv, xr, xg = [x + dx * mix[:, :, i] for i in range(5)]

    def heads(xi, name):
        return torch.einsum("btd,dhk->bthk", xi, p[name].to(dt))

    r, kk, vv, g = heads(xr, "wr"), heads(xk, "wk"), heads(xv, "wv"), \
        heads(xg, "wg")
    dec = xw @ p["decay_w1"].to(dt)
    w = p["w0"].float() + torch.einsum(
        "btl,lhk->bthk", torch.tanh(dec).float(), p["decay_w2"].float())
    logw = -torch.exp(w)                                # log decay ≤ 0

    if state is None:
        y, S = wkv6_chunked(r, kk, vv, logw.to(r.dtype), p["u"],
                            chunk=chunk, impl=wkv_impl)
    else:
        S = state["S"]
        r1, k1, v1 = r[:, 0].float(), kk[:, 0].float(), vv[:, 0].float()
        y = torch.einsum("bhk,bhkv->bhv", r1, S) + (
            (r1 * p["u"][None].float() * k1).sum(-1)[..., None] * v1)
        S = (torch.exp(logw[:, 0])[..., None] * S
             + k1[..., None] * v1[..., None, :])
        y = y[:, None].to(dt)
    new_state = {"S": S, "prev": x[:, -1:]}

    # per-head group norm (population variance), gate, project out
    y32 = y.float()
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    y = (y32 - mu) * torch.rsqrt(var + 64e-5) * p["ln_x"].float()
    y = y.to(dt) * F.silu(g)
    out = torch.einsum("bthv,hvd->btd", y, p["wo"].to(dt))
    return out, new_state


def rwkv6_channelmix_specs(d: int, ff: int) -> dict:
    return {
        "mu_k": ParamSpec((d,), ("embed",), init="small"),
        "mu_r": ParamSpec((d,), ("embed",), init="small"),
        "wk": ParamSpec((d, ff), ("embed", "ff")),
        "wv": ParamSpec((ff, d), ("ff", "embed")),
        "wr": ParamSpec((d, d), ("embed", None)),
    }


def rwkv6_channelmix_apply(p, x, *, state=None):
    dt = x.dtype
    dx = _previous(x, state) - x
    xk = x + dx * p["mu_k"].to(dt)
    xr = x + dx * p["mu_r"].to(dt)
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    out = torch.sigmoid(xr @ p["wr"].to(dt)) * (k @ p["wv"].to(dt))
    return out, {"prev": x[:, -1:]}
