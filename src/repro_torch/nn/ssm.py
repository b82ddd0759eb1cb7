"""State-space blocks over the SSAM linear-recurrence plan: Mamba (the
Hymba branch) and RWKV6 ("Finch").

Both recurrences are diagonal, so they run as scalar rows ``h_t =
a_t·h_{t−1} + b_t`` through the scan engine — K5 on the card, forward
and, for training, the time-reversed λ-recurrence of the backward.

* Mamba (:func:`mamba_apply`): in-projection, the depthwise causal conv1d
  with its bias and SiLU fused (``ops.conv1d_causal``: K1's per-lane path,
  K4 for its weight gradient), the selective scan
  (:func:`selective_scan`) and the gated out-projection. Schedules:
  ``'engine'`` (the default) streams ``(B, chunk, Di, N)`` slabs, one
  engine call per chunk with the state as its carry, each chunk
  checkpointed under autograd (O(chunk) live state);
  ``'engine_unchunked'`` runs all of T in one call.
* RWKV6 (:func:`wkv6_chunked`): the same two schedules over the WKV
  state ``S_t = diag(exp(logw_t))·S_{t−1} + k_tᵀv_t``, the streamed
  chunks checkpointed under autograd as Mamba's are.

The reference's ``'chunked'`` matmul schedules (ROADMAP Queue 1 item 5b)
and the Mamba decode step (Hymba serving, item 9) are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .spec import ParamSpec

WKV_IMPLS = ("engine", "engine_unchunked")     # the schedules of both blocks


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — Hymba's parallel Mamba heads
# ---------------------------------------------------------------------------

def mamba_specs(d: int, *, d_inner: int, ssm_state: int, conv_k: int = 4,
                dt_rank: int | None = None) -> dict:
    dt_rank = dt_rank or max(d // 16, 1)
    return {
        "in_proj": ParamSpec((d, 2 * d_inner), ("embed", "ff")),
        "conv_w": ParamSpec((conv_k, d_inner), ("conv", "ff")),
        "conv_b": ParamSpec((d_inner,), ("ff",), init="zeros"),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * ssm_state),
                            ("ff", "lora")),
        "dt_w": ParamSpec((dt_rank, d_inner), ("lora", "ff")),
        "dt_b": ParamSpec((d_inner,), ("ff",), init="small"),
        "A_log": ParamSpec((d_inner, ssm_state), ("ff", "state"),
                           init="small"),
        "D": ParamSpec((d_inner,), ("ff",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("ff", "embed")),
    }


def _transfer(A, delta, Bmat, x):
    """The selective scan's transfer pairs ``a = exp(Δ·A)``, ``b = (Δ·x)·B``
    as (B, L, Di, N) fp32."""
    d32 = delta.float()
    a = torch.exp(d32[..., None] * A)
    b = (d32 * x.float())[..., None] * Bmat.float()[:, :, None, :]
    return a, b


def _selective_scan_engine(delta, A_log, Bmat, Cmat, x):
    """The selective scan in one engine call over all of T: materializes
    the (B, T, Di, N) transfer pairs and state history (the validation
    schedule)."""
    A = -torch.exp(A_log.float())                                 # (Di, N)
    a, b = _transfer(A, delta, Bmat, x)
    hs = ops.chunked_linear_recurrence(a.movedim(1, -1), b.movedim(1, -1),
                                       impl="engine_unchunked")
    hs = hs.movedim(-1, 1)                                        # (B,T,Di,N)
    y = torch.einsum("btin,btn->bti", hs, Cmat.float())
    return y.to(x.dtype), hs[:, -1]


def _scan_chunk(A, h, delta, Bmat, Cmat, x):
    """One chunk of the streamed selective scan: its ``B·Di·N`` rows through
    one ``ops.linear_recurrence_carry`` call (one K5 launch on the card)
    from the carry ``h``, contracted against ``C`` at once. Returns the
    new carry and the chunk's ``y`` (B, L, Di) fp32. Building the rows
    (time last) and reading them back are transposing copies, as in the
    reference's ``moveaxis(…, 1, -1).reshape(-1, L)``."""
    Bsz, L, Di = x.shape
    N = A.shape[1]
    a, b = _transfer(A, delta, Bmat, x)
    rows_a = a.movedim(1, -1).reshape(-1, L)                      # (B·Di·N, L)
    rows_b = b.movedim(1, -1).reshape(-1, L)
    hs, h_new = ops.linear_recurrence_carry(rows_a, rows_b, h)
    hs = hs.reshape(Bsz, Di, N, L).movedim(-1, 1)                 # (B,L,Di,N)
    return h_new, torch.einsum("blin,bln->bli", hs, Cmat.float())


def _selective_scan_engine_stream(delta, A_log, Bmat, Cmat, x, *, chunk):
    """Chunk-streamed selective scan: ``(B, L, Di, N)`` slabs, each through
    :func:`_scan_chunk` with the state as its carry. Under autograd each
    chunk is checkpointed (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of the chunk step): the backward keeps only the
    chunk-boundary carries, re-runs each chunk's forward and then its
    λ-recurrence, both through the engine. T pads to whole chunks with
    Δ = 0: identity transfers."""
    Bsz, T, Di = x.shape
    N = A_log.shape[1]
    L = min(chunk, T)
    pad = (-T) % L
    if pad:
        delta, Bmat, Cmat, x = (F.pad(t, (0, 0, 0, pad))
                                for t in (delta, Bmat, Cmat, x))
    A = -torch.exp(A_log.float())                                 # (Di, N)
    h = torch.zeros((Bsz * Di * N, 1), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(0, T + pad, L):
        args = (A, h) + tuple(t[:, c:c + L] for t in (delta, Bmat, Cmat, x))
        if torch.is_grad_enabled():
            h, y = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            h, y = _scan_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(x.dtype), h.reshape(Bsz, Di, N)


def selective_scan(delta, A_log, Bmat, Cmat, x, *, chunk: int = 128,
                   work_dtype=torch.float32, impl: str | None = None):
    """Selective scan: ``h[t] = exp(Δ_t·A)⊙h[t−1] + (Δ_t·x_t)·B_t``,
    ``y[t] = C_t·h[t]`` (the D term is the caller's).

    delta, x: (B, T, Di); Bmat, Cmat: (B, T, N); A_log: (Di, N). Returns
    ``(y, h_last)``, ``h_last`` (B, Di, N) fp32. ``impl``: None or
    'engine' (chunk-streamed, the reference's TPU default), or
    'engine_unchunked'; 'chunked' (the matmul schedule, where
    ``work_dtype`` would apply) is not ported.
    """
    impl = impl or "engine"
    if impl == "engine":
        return _selective_scan_engine_stream(delta, A_log, Bmat, Cmat, x,
                                             chunk=chunk)
    if impl == "engine_unchunked":
        return _selective_scan_engine(delta, A_log, Bmat, Cmat, x)
    if impl == "chunked":
        raise NotImplementedError(
            "selective_scan(impl='chunked'), the matmul schedule, is not "
            "ported yet (ROADMAP Queue 1 item 5b)")
    raise ValueError(f"impl must be one of {WKV_IMPLS}, got {impl!r}")


def _softplus(x):
    """``log(1 + eˣ)`` as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_apply(p, x, *, ssm_state: int, conv_k: int = 4, chunk: int = 128,
                state=None, work_dtype=torch.float32,
                scan_impl: str | None = None):
    """Mamba block over x (B, T, d) for training and prefill
    (``state=None``). The depthwise conv rides ``ops.conv1d_causal`` with
    the bias and SiLU as its fused epilogue (the reference's engine path);
    the selective scan runs :func:`selective_scan` (``scan_impl``).
    Returns ``(out, {"h", "conv"})``. The single-token decode step
    (``state`` given) is not ported yet and raises."""
    if state is not None:
        raise NotImplementedError(
            "mamba_apply with a decode state (the O(1) Mamba step) is not "
            "ported yet: Hymba serving, ROADMAP Queue 1 item 9")
    T = x.shape[1]
    Di = p["in_proj"].shape[1] // 2
    dt_rank = p["dt_w"].shape[0]
    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = xz[..., :Di], xz[..., Di:]
    xs = ops.conv1d_causal(xs, p["conv_w"], epilogue=("bias", "silu"),
                           epilogue_args=(p["conv_b"],))
    dbc = xs @ p["x_proj"].to(x.dtype)
    dt = _softplus(dbc[..., :dt_rank] @ p["dt_w"].to(x.dtype)
                   + p["dt_b"].to(x.dtype))
    Bmat = dbc[..., dt_rank:dt_rank + ssm_state]
    Cmat = dbc[..., dt_rank + ssm_state:]
    y, h_last = selective_scan(dt, p["A_log"], Bmat, Cmat, xs, chunk=chunk,
                               work_dtype=work_dtype, impl=scan_impl)
    y = y + xs * p["D"].to(x.dtype)
    new_state = {"h": h_last,
                 "conv": xs[:, -(conv_k - 1):, :] if T >= conv_k - 1
                 else None}
    out = (y * F.silu(z)) @ p["out_proj"].to(x.dtype)
    return out, new_state


# ---------------------------------------------------------------------------
# RWKV6 ("Finch"): data-dependent token shift + WKV recurrence
# ---------------------------------------------------------------------------


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


def _wkv_chunk(u32, S, r_k, k_k, v_k, w_k):
    """One chunk of the streamed WKV6: its ``B·H·K·V`` rows through one
    ``ops.linear_recurrence_carry`` call (one K5 launch on the card)
    seeded with the state ``S``, and the output contraction. Returns the
    new state and the chunk's ``y`` (B, L, H, V) fp32."""
    B, L, H, K = r_k.shape
    V = v_k.shape[-1]
    a, b = _transfer_pairs(k_k, v_k, w_k, (B, L, H, K, V))
    rows_a = a.movedim(1, -1).reshape(-1, L)                      # (B·H·K·V, L)
    rows_b = b.movedim(1, -1).reshape(-1, L)
    Ss, S_new = ops.linear_recurrence_carry(rows_a, rows_b, S)
    Ss = Ss.reshape(B, H, K, V, L).movedim(-1, 1)                 # (B,L,H,K,V)
    S_prev = torch.cat([S.reshape(B, 1, H, K, V), Ss[:, :-1]], dim=1)
    return S_new, _wkv_out(r_k.float(), S_prev, u32, k_k.float(),
                           v_k.float())


def _wkv6_engine_stream(r, k, v, logw, u, *, chunk):
    """Chunk-streamed WKV6: each ``(B, L, H, K, V)`` slab's recurrence runs
    through :func:`_wkv_chunk` seeded with the state, and the output
    contraction happens before the next chunk. The state of the chunk's
    first position is the carry-in. Under autograd each chunk is
    checkpointed (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of the chunk step): the backward keeps only the
    chunk-boundary states, O(B·H·K·V) each, re-runs each chunk's forward
    and then its λ-recurrence, both through the engine. T pads to whole
    chunks with ``logw = 0`` and ``k = v = 0``: identity steps."""
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
        args = (u32, S) + tuple(t[:, c:c + L] for t in (r, k, v, logw))
        if torch.is_grad_enabled():
            S, y = checkpoint(_wkv_chunk, *args, use_reentrant=False)
        else:
            S, y = _wkv_chunk(*args)
        ys.append(y)
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
