#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed N] [--out DIR]

Five paths. The first is the paper's experiment: the 15 Table-3
stencils at 8192² (2-D) and 512³ (3-D) in fp32, both schedule variants,
t ∈ {1, 2}, one bf16 case, and 2-D convolution ('same' and 'valid') at
8192² over the Fig. 4 filter sweep plus a (16, 2048, 2048) batched 5×5,
all through ``repro_torch.kernels.ops`` on CUDA tensors, i.e. through
K1, the CUDA windowed-plan kernel. The second serves rwkv6-1.6b at full
width (weights from ``--seed``) through ``repro_torch.launch.serve``,
whose prefill runs the WKV recurrence through K5, the CUDA scan kernel.
The third trains whisper-base with the mel conv stem at full width
through ``repro_torch.launch.train``: the stem's forward runs K1's
channel-reduce path, its backward K1 on the input-adjoint plan and K3,
the CUDA weight-gradient kernel. The fourth runs the same stencil,
convolution and stem calls with ``strategy="mxu"``, i.e. through K2, the
tensor-core kernel, and trains whisper-base with the stem pinned to it.
The fifth trains hymba-1.5b at full width through
``repro_torch.launch.train``: its Mamba branch runs the depthwise conv1d
through K1's per-lane path, the conv's weight gradient through K4 and
the selective scan, forward and backward, through K5.
Phases, one JSON line each:

1. build: compile K1, K2, K3, K4 and K5 from ``src/repro_torch/csrc``
   (nvcc, sm_90a, one process per source, all started together);
2. stencils and 3. convolution: every case against the plain torch
   version on the card, ``rtol=3e-5, atol=3e-5·max|plain|`` (bf16:
   3e-2), and small cases against the torch oracles;
4. launch count: K1's counter, zeroed before the main path, must equal
   the number of calls the main path made;
5. times at t = 1: kernel, plain version and the library yardstick
   (``F.conv2d``/``F.conv3d`` with TF32 off, never called by the port):
   one call with ``padding=``, and ``F.pad`` then a valid call, each the
   median of CUDA-event timed calls, beside the card's bound (bytes over
   3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is larger);
6. scan ops at (8192, 8192) fp32 (cumsum, sat, linear_recurrence,
   chunked_linear_recurrence with chunk 128; one bf16
   linear_recurrence) and linear_recurrence_carry at the WKV chunk shape
   (131072, 64): each against ``engine.run_scan_plan_reference`` on the
   card (fp32 rtol 1e-5, atol 1e-5·max|plain|; bf16 3e-2), K5's launches
   counted, and timed beside its byte bound, the plain version and
   ``torch.cumsum`` where one call computes the same function. ``ms``
   is the call's device time (events on a card kept busy while the host
   enqueues the call); ``call_ms`` also counts the host time of the
   wrapper (events on an idle card, as phase 5 times K1);
7. serving: rwkv6-1.6b (1,465,503,744 parameters) in a 4-slot
   ``DecodeServer`` over 8 requests (prompts of 64, 200, 511 and 1024
   tokens, twice; 16 new tokens each). K5's counter, zeroed before
   ``server.run``, must read 24 × Σ⌈(L−1)/64⌉ = 1392 after it. Prefill
   and decode times, tok/s and the profiler's top device ops of one
   1024-token prefill are reported. The K5 prefill of the 64- and
   511-token prompts is held against the token-by-token ``serve_step``
   path (plain torch, no kernel) at rtol 1e-4, atol 1e-4·max|plain|, and
   the server's greedy tokens against a token-by-token greedy decode of
   each request wherever the plain top-2 logit gap exceeds 100× that
   tolerance;
8. training: (a) K1 and K3 at the stem's full-width shapes (batch 8,
   mel (8, 80, 1, 3000), d_model 512): conv1 and conv2 forward (conv2 at
   stride (1, 2), both with bias+GELU), conv2's dx on the input-adjoint
   plan, the dW of both, one single-channel 5×5 dW at 8192² and one bf16
   forward, each against its plain version on the card (fp32 rtol 1e-4,
   atol 1e-4·max|plain|; bf16 3e-2); (b) the stem's gradients (both
   filters and biases, and conv2's input) through the kernels against
   torch autograd through the plain versions, same tolerance;
   (c) whisper-base with the stem (89,150,976 parameters, weights from
   ``--seed``, TF32 off), batch 8, 128 tokens, 6 steps of
   ``launch.train.main``: every loss finite, K1's counter (zeroed before)
   at 5 per step (2 forwards, 2 recomputed pre-activations, 1 dx) and
   K3's at its launches for the 2 dW calls of a step (4: each call splits
   its reduction and adds the partials in a second launch); (d) step time and samples/s, K1 and K3 device
   times beside their bound, the plain versions and the library
   yardsticks (``F.conv2d`` + tanh-GELU, ``torch.nn.grad.conv2d_input``
   / ``conv2d_weight``, TF32 off, never called by the port), and the
   profiler's top device ops of one step with the stem's share;
9. tensor cores: (a) the 15 stencils at 8192² / 512³, t ∈ {1, 2}, and
   the 'same' filter sweep at 8192² with ``strategy="mxu"`` through K2,
   each against the plain mxu version on the card (fp32 rtol 3e-5; one
   bf16 2d9pt at 3e-2) and against K1's lanes result (1e-4, the
   reference's own lanes-versus-mxu tolerance); (b) the stem's conv1 and
   conv2 forwards and conv2's dx through K2 against the plain version and
   K1 (1e-4; one bf16 forward at 3e-2), and the stem's gradients through
   K2 and K3 against torch autograd through the plain mxu versions
   (1e-4); K2's counter, zeroed before (a), must equal the calls of (a)
   and (b); (c) whisper-base with ``conv_strategy="mxu"`` (the JAX CLI
   has no flag for it, so the script builds the config and drives
   ``launch.train.Trainer``), batch 8, 128 tokens, 6 steps: every loss
   finite, K2 at 5 launches per step, K3 as in phase 8 and K1 at 0;
   before it, the
   first step's loss with the stem on K2 and on K1, same weights and
   batch, within 1e-5 relative with the weight matrices scaled by 0.3,
   and recorded at the reference's init beside the change a 1e-7
   relative perturbation of the weights makes there (ROADMAP R4); (d) K2's times at the stem's shapes
   and for 2d5pt, 2d121pt, 3d125pt and the 20×20 'same' convolution at
   t = 1, beside two bounds (bytes over 3.35 TB/s against fp32
   operations over 67 TFLOP/s, and against the same operations counted
   once over 495 TFLOP/s of TF32), K1's time, the plain version's and
   the cuDNN yardstick with TF32 off and, labelled as less precise, on;
   the mxu train step's time, samples/s and the stem's share of a
   profiled step;
10. Hymba: (a) K1's per-lane path at (2, 2048, 3200) — the conv1d
   forward with bias+SiLU and its input adjoint (trail-only, reflected
   coefficient rows) — at fp32 rtol 3e-5, K4 at 1e-4, bf16 cases at 3e-2,
   the odd shape (3, 37, 100), the λ-recurrence through K5 and
   ``LinrecCarryOp``'s backward at (102400, 128) at 1e-5, each against
   its plain version on the card (atol rtol·max|plain|); (b) layer 0 of
   the seeded full-width model, its gradients through the kernels
   against autograd through the plain versions at 1e-4·max|leaf|, beside
   the spread a 1e-7 relative change of the layer's parameters makes;
   (c) hymba-1.5b (1,611,062,400 parameters, weights from ``--seed``,
   TF32 off), batch 2 × 2048 tokens, 6 steps of ``launch.train.main``:
   every loss finite, the counters (zeroed before) at
   ``models.hymba.train_launches`` per step (K1 128, K4 64: 32 calls of
   two launches each, K5 2048) and
   K2, K3 at 0, step time, samples/s and peak memory; (d) K1 (forward,
   dx), K4 and the reversed K5 chunk timed beside their byte bounds, the
   plain versions and the library calls (``F.conv1d(groups=D)`` + SiLU,
   ``torch.nn.grad.conv1d_input`` / ``conv1d_weight`` on the (B, D, T)
   layout, never called by the port), and one profiled step with its top
   device ops, the share of K1/K4/K5 and of copies.

It exits non-zero if there is no card, if a build, launch or check fails,
and when run outside a checkout of the repository. The full results go
to ``DIR/chip_smoke.json`` (default ``build/chip_smoke/``); the last
lines are the kernel table, the card's name and power limit, and
``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12              # fp32 outside the tensor cores
CONV_SIZES = (2, 3, 5, 7, 9, 13, 17, 20)
SCAN_N = 8192                   # scan ops at (8192, 8192)
WKV_ROWS = 32 * 64 * 64         # B·H·K·V rows of one rwkv6-1.6b sequence
WKV_CHUNK = 64
PROMPTS = (64, 200, 511, 1024)  # prompt lengths, each served twice
CHECKED_PROMPTS = (64, 511)     # K5 prefill against token-by-token
MAX_NEW = 16
FULL_PARAMS = 1_465_503_744     # rwkv6-1.6b
SERVE_RTOL = 1e-4
K5_SERVE_LAUNCHES = 1392        # 24 layers × Σ⌈(L−1)/64⌉ over the prompts
SPIN_CYCLES_PER_MS = 2_000_000  # SM cycles per ms at ≤ 2 GHz: spins err long
TRAIN_PARAMS = 89_150_976       # whisper-base with the conv stem (n_mels 80)
TRAIN_STEPS = 6
TRAIN_BATCH = 8
TRAIN_SEQ = 128
N_MELS, N_FRAMES, D_MODEL = 80, 1500, 512
STEM_RTOL = 1e-4                # K1 reduce path and K3 against plain, fp32
TF32_FLOPS = 495e12             # dense TF32 on the tensor cores
MXU_RTOL = 3e-5                 # K2 single-channel against plain, fp32
MXU_VS_LANES = 1e-4             # K2 against K1: the reference's own tolerance
MXU_TIMED = ("2d5pt", "2d121pt", "3d125pt")
GRID_2D, GRID_3D = 8192, 512    # phase 9's grids: 8192², 512³
LOSS_RTOL = 1e-5                # first-step loss, mxu against lanes
SOFT_SCALE = 0.3                # weight matrices' scale of the softer point
PERTURB_REL = 1e-7              # relative parameter change of the spread probe
TIME_REPS = 10                  # timed calls of phases 5 and 9 (others: 20)
HYMBA_PARAMS = 1_611_062_400    # hymba-1.5b
HYMBA_STEPS = 6
HYMBA_BATCH, HYMBA_SEQ = 2, 2048
HYMBA_DI, HYMBA_K, HYMBA_N = 3200, 4, 16   # d_inner, conv taps, ssm_state
HYMBA_CHUNK = 128               # selective-scan chunk: rows x 128 per K5 call
PERLANE_RTOL = 3e-5             # K1 per-lane against plain, fp32
K4_RTOL = 1e-4                  # K4 against plain: sums of 4096 products
LAYER_RTOL = 1e-4               # a layer's gradients, kernels against plain


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def ptxas_summary(log: str) -> dict:
    """Most registers and most spill bytes over the kernels ptxas built,
    in all and per source file (the build log's ``== name`` sections)."""
    def summary(text):
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
        spills = [int(v)
                  for v in re.findall(r"(\d+) bytes spill stores", text)]
        return {"kernels": len(regs), "max_registers": max(regs, default=0),
                "max_spill_store_bytes": max(spills, default=0)}

    parts = re.split(r"^== (\S+)$", log, flags=re.M)
    return {**summary(log), "by_source": {
        name: summary(text) for name, text in zip(parts[1::2], parts[2::2])}}


def event_ms(fn, reps):
    """Median of ``reps`` CUDA-event timed calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, reps):
    """Median of ``reps`` CUDA-event timed calls after one warm-up, each
    timed while a spin kernel keeps the card busy until the host has
    enqueued the whole call: the events bracket the call's device work,
    not the host time of the wrapper around it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int((2 * enqueue_ms + 0.5) * SPIN_CYCLES_PER_MS)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(spin)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_ms(fn, reps):
    """Median host time of ``reps`` calls, each ended by a synchronize,
    after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare(tag, y, plain, rtol, results):
    """Hold ``y`` against ``plain`` at ``rtol``, atol ``rtol·max|plain|``;
    record and return the largest difference."""
    import torch

    torch.cuda.synchronize()
    require(tuple(y.shape) == tuple(plain.shape), (tag, y.shape, plain.shape))
    require(bool(torch.isfinite(y).all()), (tag, "non-finite output"))
    scale = plain.float().abs().max().item()
    err = (y.float() - plain.float()).abs().max().item()
    torch.testing.assert_close(y.float(), plain.float(), rtol=rtol,
                               atol=rtol * scale, msg=lambda m: f"{tag}: {m}")
    rec = {"case": tag, "max_abs_err": err, "max_abs_plain": scale,
           "rtol": rtol, "atol": rtol * scale}
    results["checks"].append(rec)
    emit({"phase": "check", **rec})
    return err


def scan_phase(args, dev, card, results) -> dict:
    """Phase 6: the scan ops through K5, checked against the plain version
    on the card, then timed."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import engine, plan
    from repro_torch.kernels import ops

    K1, K5 = engine.WINDOW_KERNEL, engine.SCAN_KERNEL
    rng = np.random.default_rng(args.seed + 1)

    def put(x):
        return convert.from_numpy(x.astype(np.float32), dev)

    n = SCAN_N
    a = put(rng.uniform(0.5, 1.0, (n, n)))
    b = put(rng.standard_normal((n, n), dtype=np.float32))
    wa = put(rng.uniform(0.5, 1.0, (WKV_ROWS, WKV_CHUNK)))
    wb = put(rng.standard_normal((WKV_ROWS, WKV_CHUNK), dtype=np.float32))
    h0 = put(rng.standard_normal((WKV_ROWS,), dtype=np.float32))
    a16, b16 = a.bfloat16(), b.bfloat16()
    plain = engine.run_scan_plan_reference
    add, lin = plan.scan_plan(128), plan.linear_recurrence_plan(128)
    wkv = plan.linear_recurrence_plan(WKV_CHUNK)
    cells = n * n
    # (tag, kernel call, plain call, rtol, bytes moved, library call, launches)
    cases = [
        ("cumsum (8192, 8192) fp32", lambda: ops.cumsum(b),
         lambda: plain(b, plan=add), 1e-5, 8 * cells,
         lambda: torch.cumsum(b, dim=-1), 1),
        ("sat (8192, 8192) fp32", lambda: ops.sat(b),
         lambda: plain(plain(b, plan=add).T.contiguous(), plan=add).T, 1e-5,
         8 * cells, lambda: torch.cumsum(torch.cumsum(b, dim=-1), dim=-2), 2),
        ("linear_recurrence (8192, 8192) fp32",
         lambda: ops.linear_recurrence(a, b), lambda: plain(a, b, plan=lin),
         1e-5, 12 * cells, None, 1),
        ("chunked_linear_recurrence chunk=128 (8192, 8192) fp32",
         lambda: ops.chunked_linear_recurrence(a, b, chunk=128),
         lambda: plain(a, b, plan=lin), 1e-5, 12 * cells, None, n // 128),
        ("linear_recurrence_carry (131072, 64) fp32",
         lambda: ops.linear_recurrence_carry(wa, wb, h0),
         lambda: plain(wa, wb, plan=wkv, carry=h0, return_carry=True), 1e-5,
         12 * WKV_ROWS * WKV_CHUNK + 8 * WKV_ROWS, None, 1),
        ("linear_recurrence (8192, 8192) bf16",
         lambda: ops.linear_recurrence(a16, b16),
         lambda: plain(a16, b16, plan=lin), 3e-2, 6 * cells, None, 1),
    ]
    worst = 0.0
    K1.launches = K5.launches = 0
    for tag, kern, ref_fn, rtol, _, _, _ in cases:
        got, want = kern(), ref_fn()
        if isinstance(got, tuple):
            worst = max(worst, compare(tag + " carry-out", got[1], want[1],
                                       rtol, results))
            got, want = got[0], want[0]
        worst = max(worst, compare(tag, got, want, rtol, results))
        del got, want
    calls = sum(c[-1] for c in cases)
    rec = {"kernel": K5.name, "launches": K5.launches, "calls": calls,
           "k1_launches": K1.launches}
    results["scan_launches"] = rec
    emit({"phase": "scan_launches", **rec})
    require(K5.launches == calls and K1.launches == 0, rec)

    headline = None
    for tag, kern, ref_fn, _, nbytes, lib, _ in cases:
        ms = device_ms(kern, 20)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"case": tag, "ms": ms, "call_ms": event_ms(kern, 20),
               "plain_ms": device_ms(ref_fn, 3),
               "library_ms": None if lib is None else device_ms(lib, 20),
               "library": None if lib is None else (
                   "torch.cumsum" if "cumsum" in tag else
                   "torch.cumsum twice"),
               "bound_ms": b_ms, "bound_by": "bytes", "bytes": nbytes,
               "hbm_share": b_ms / ms, "card": card}
        if tag.startswith("sat"):
            rec["two_pass_bound_ms"] = 2 * b_ms
        results["times"].append(rec)
        emit({"phase": "scan_time", **rec})
        if tag.startswith("linear_recurrence_carry"):
            headline = rec
    return {"worst_abs": worst, "headline": headline}


def device_ops(prof, top: int = 5, match=None):
    """Kernels of a ``torch.profiler`` run by device time: the ``top``
    largest, the total, and for each ``name: pattern`` of ``match``
    (default K5's) the time, calls and share of the kernels whose name
    holds the pattern."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    out = {"device_ms": total,
           "top": [{"op": k[:160], "ms": ms, "calls": c,
                    "share": ms / total} for k, ms, c in rows[:top]]}
    for name, pattern in (match or {"k5": "ssam_scan_kernel"}).items():
        hit = [r for r in rows if pattern in r[0]]
        ms = sum(r[1] for r in hit)
        out.update({f"{name}_ms": ms, f"{name}_calls": sum(r[2] for r in hit),
                    f"{name}_share": ms / total if total else None})
    return out


def serve_phase(args, dev, card, results) -> dict:
    """Phase 7: serve rwkv6-1.6b at full width through K5's prefill."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.core import engine
    from repro_torch.launch import serve
    from repro_torch.models import build_model, rwkv6
    from repro_torch.nn import spec

    K1, K5 = engine.WINDOW_KERNEL, engine.SCAN_KERNEL
    cfg = get_config("rwkv6-1.6b")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=args.seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    rec = {"arch": cfg.name, "params": n_params,
           "spec_params": spec.param_count(rwkv6.specs(cfg)),
           "init_s": time.perf_counter() - t0, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": cfg.n_heads,
           "head_k": cfg.head_k, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "wkv_chunk": cfg.wkv_chunk, "dtype": cfg.dtype}
    results["serve_model"] = rec
    emit({"phase": "serve_model", **rec})
    require(n_params == rec["spec_params"] == FULL_PARAMS, rec)

    rng = np.random.default_rng(args.seed + 2)
    lens = PROMPTS * 2
    prompts = [rng.integers(0, cfg.vocab, L, dtype=np.int32) for L in lens]

    def tokens(p):
        return torch.as_tensor(np.asarray(p, np.int64)[None], device=dev)

    # -- the main path: the server, counts zeroed just before -------------
    server = serve.DecodeServer(model, slots=4, cache_len=2048,
                                seed=args.seed)
    reqs = [serve.Request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    K1.launches = K5.launches = 0
    t0 = time.perf_counter()
    done = server.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k5, k1 = K5.launches, K1.launches
    want = cfg.n_layers * sum(-(-(L - 1) // cfg.wkv_chunk) for L in lens)
    n_tok = sum(len(r.out) for r in done)
    steps_ms = [t * 1e3 for t in server.step_seconds]
    rec = {"requests": len(done), "slots": server.B, "prompts": list(lens),
           "max_new": MAX_NEW, "tokens_out": n_tok, "run_s": run_s,
           "tok_per_s": n_tok / run_s, "steps": server.steps,
           "decode_step_ms_median": statistics.median(steps_ms),
           "decode_step_ms_min": min(steps_ms),
           "decode_step_ms_max": max(steps_ms),
           "k5_launches": k5, "k5_launches_expected": want,
           "k1_launches": k1, "card": card}
    results["serve"] = rec
    emit({"phase": "serve", **rec})
    require(k5 == want == K5_SERVE_LAUNCHES,
            ("K5 launches across server.run", k5, want))
    require(len(done) == len(reqs) and all(
        r.error is None and len(r.out) == MAX_NEW
        and all(0 <= t < cfg.vocab for t in r.out) for r in done),
        "every request finishes with MAX_NEW tokens in the vocabulary")

    # -- prefill times (extra prefills, counted apart) ---------------------
    K5.launches = 0
    for L in PROMPTS:
        toks = tokens(prompts[lens.index(L)][:-1])
        ms = host_ms(lambda: model.prefill(toks), 3)
        rec = {"prompt": L, "tokens": L - 1, "ms": ms,
               "tok_per_s": (L - 1) / ms * 1e3, "card": card}
        results.setdefault("serve_prefill", []).append(rec)
        emit({"phase": "serve_prefill", **rec})
    longest = max(PROMPTS)
    full = tokens(prompts[lens.index(longest)])
    model.prefill(full)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(full)
        torch.cuda.synchronize()
    rec = {"prompt": longest, **device_ops(prof), "card": card}
    results["serve_profile"] = rec
    emit({"phase": "serve_profile", **rec})

    # -- (b) K5 prefill against the token-by-token path --------------------
    checked = {lens.index(L): None for L in CHECKED_PROMPTS}
    for i in checked:
        log, st = model.prefill(tokens(prompts[i]))
        checked[i] = (log[0], st["S"][:, 0])
    extra = K5.launches

    # -- (c) one token-by-token greedy decode per request, in lock-step ----
    # Rows of the batch are independent requests (RWKV6 mixes nothing
    # across the batch); serve_step is plain torch, no kernel.
    B = len(prompts)
    state = spec.init_params(model.decode_state_specs(B, 2048), device=dev)
    gen = [[] for _ in range(B)]
    gaps = [[] for _ in range(B)]
    tok = np.array([[p[0]] for p in prompts], np.int64)
    for t in range(max(lens) + MAX_NEW - 1):
        logits, state = model.serve_step(state, torch.as_tensor(tok,
                                                                device=dev))
        for i in checked:
            if t == lens[i] - 1:
                log, S = checked[i]
                compare(f"prefill logits, {lens[i]}-token prompt", log,
                        logits[i], SERVE_RTOL, results)
                compare(f"prefill state S, {lens[i]}-token prompt", S,
                        state["S"][:, i], SERVE_RTOL, results)
        top = logits.topk(2, dim=-1)
        vals = top.values.cpu().numpy()
        best = top.indices[:, 0].cpu().numpy()
        amax = logits.abs().amax(-1).cpu().numpy()
        for r in range(B):
            if t >= lens[r] - 1 and len(gen[r]) < MAX_NEW:
                gen[r].append(int(best[r]))
                gaps[r].append((float(vals[r, 0] - vals[r, 1]),
                                100 * SERVE_RTOL * float(amax[r])))
            tok[r, 0] = (prompts[r][t + 1] if t + 1 < lens[r]
                         else gen[r][-1])
    require(K5.launches == extra, "the token-by-token path launched K5")
    near = []
    matched = 0
    for r in done:
        for j, (got, want_tok) in enumerate(zip(r.out, gen[r.rid])):
            gap, thr = gaps[r.rid][j]
            if got == want_tok:
                matched += 1
                continue
            require(gap <= thr, ("greedy token differs at a clear gap",
                                 r.rid, j, got, want_tok, gap, thr))
            # a near tie: the two decodes part here, so stop comparing
            near.append({"request": r.rid, "prompt": lens[r.rid],
                         "position": j, "server": got, "plain": want_tok,
                         "gap": gap, "threshold": thr})
            break
    rec = {"tokens_matched": matched, "tokens": n_tok, "near_ties": near,
           "min_gap": min(g for gs in gaps for g, _ in gs),
           "k5_launches_checks": extra}
    results["serve_greedy"] = rec
    emit({"phase": "serve_greedy", **rec})
    return {"k5_launches": k5}


def stem_cases(dev, seed):
    """The Whisper stem's full-width operands at batch 8 (fp32, from the
    numpy generator): mel, both filters and biases, conv1's output and
    conv2's cotangent scattered onto the dense 3000-lane lattice."""
    import numpy as np

    from repro_torch import convert

    rng = np.random.default_rng(seed)

    def put(*shape, scale=1.0):
        return convert.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32), dev)

    B, T, D = TRAIN_BATCH, 2 * N_FRAMES, D_MODEL
    return {"mel": put(B, N_MELS, 1, T),
            "w1": put(D, N_MELS, 1, 3, scale=N_MELS ** -0.5),
            "b1": put(D, scale=0.1),
            "x2": put(B, D, 1, T),
            "w2": put(D, D, 1, 3, scale=D ** -0.5),
            "b2": put(D, scale=0.1),
            "g1": put(B, D, 1, T),
            "g2": put(B, D, 1, T // 2)}


def train_phase(args, dev, card, results) -> dict:
    """Phase 8: train whisper-base with the conv stem at full width; the
    stem runs K1 (forward, recomputed pre-activations, dx) and K3 (dW)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import adjoint, engine
    from repro_torch.core.plan import normalize_epilogue
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import ops, ssam_conv2d
    from repro_torch.launch import train

    K1, K3, K5 = engine.WINDOW_KERNEL, engine.WGRAD_KERNEL, engine.SCAN_KERNEL
    c = stem_cases(dev, args.seed + 3)
    B, T, D = TRAIN_BATCH, 2 * N_FRAMES, D_MODEL
    epi = ("bias", "gelu")

    def nchw(x, w, stride=None, epilogue=None):
        return dataclasses.replace(
            ssam_conv2d.plan_for_nchw(x.shape, w.shape, "same"),
            stride=stride, epilogue=normalize_epilogue(epilogue))

    p1 = nchw(c["mel"], c["w1"], None, epi)
    p2 = nchw(c["x2"], c["w2"], (1, 2), epi)
    lin2 = nchw(c["x2"], c["w2"])
    adj2 = adjoint.input_adjoint_plan(lin2)
    wa2 = adjoint.adjoint_coeff_array(lin2, c["w2"])
    g2d = torch.zeros_like(c["g1"])
    g2d[..., ::2] = c["g2"]                      # the scattered cotangent
    rng = np.random.default_rng(args.seed + 4)
    x8k = torch.as_tensor(rng.standard_normal((8192, 8192), np.float32),
                          device=dev)
    g8k = torch.as_tensor(rng.standard_normal((8192, 8192), np.float32),
                          device=dev)
    p8k = ssam_conv2d.plan_for((5, 5), "same")
    ref = engine.run_window_plan_reference
    wref = engine.run_weight_grad_plan_reference
    run, wrun = engine.run_window_plan, engine.run_weight_grad_plan
    x2_bf16 = c["x2"].to(torch.bfloat16)
    F32 = STEM_RTOL
    # (tag, kernel, plain, rtol, operations, bytes, library, counter)
    cases = [
        ("K1 conv1 forward (8,80,1,3000)->(8,512,1,3000) bias+gelu",
         lambda: run(c["mel"], c["w1"], plan=p1, epilogue_args=(c["b1"],)),
         lambda: ref(c["mel"], c["w1"], plan=p1, epilogue_args=(c["b1"],)),
         F32, 2 * D * N_MELS * 3 * B * T,
         4 * (B * N_MELS * T + D * N_MELS * 3 + D + B * D * T),
         lambda: F.gelu(F.conv2d(c["mel"], c["w1"], c["b1"],
                                 padding=(0, 1)), approximate="tanh"), K1),
        ("K1 conv2 forward stride (1,2) (8,512,1,3000)->(8,512,1,1500) "
         "bias+gelu",
         lambda: run(c["x2"], c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         lambda: ref(c["x2"], c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         F32, 2 * D * D * 3 * B * (T // 2),
         4 * (B * D * T + D * D * 3 + D + B * D * T // 2),
         lambda: F.gelu(F.conv2d(c["x2"], c["w2"], c["b2"], stride=(1, 2),
                                 padding=(0, 1)), approximate="tanh"), K1),
        ("K1 conv2 dx, adjoint plan on the scattered cotangent "
         "(8,512,1,3000)",
         lambda: run(g2d, wa2, plan=adj2), lambda: ref(g2d, wa2, plan=adj2),
         F32, 2 * D * D * 3 * B * T, 4 * (2 * B * D * T + D * D * 3),
         lambda: torch.nn.grad.conv2d_input(
             c["x2"].shape, c["w2"], c["g2"], stride=(1, 2), padding=(0, 1)),
         K1),
        ("K3 conv1 dW (8,80,1,3000) x (8,512,1,3000) -> (512,80,1,3)",
         lambda: wrun(c["mel"], c["g1"], plan=p1),
         lambda: wref(c["mel"], c["g1"], plan=p1),
         F32, 2 * D * N_MELS * 3 * B * T,
         4 * (B * N_MELS * T + B * D * T + D * N_MELS * 3),
         lambda: torch.nn.grad.conv2d_weight(
             c["mel"], c["w1"].shape, c["g1"], padding=(0, 1)), K3),
        ("K3 conv2 dW on the scattered cotangent -> (512,512,1,3)",
         lambda: wrun(c["x2"], g2d, plan=lin2),
         lambda: wref(c["x2"], g2d, plan=lin2),
         F32, 2 * D * D * 3 * B * T, 4 * (2 * B * D * T + D * D * 3),
         lambda: torch.nn.grad.conv2d_weight(
             c["x2"], c["w2"].shape, c["g2"], stride=(1, 2), padding=(0, 1)),
         K3),
        ("K3 dense (N, M) 5x5 'same' 8192x8192 -> (5,5)",
         lambda: wrun(x8k, g8k, plan=p8k), lambda: wref(x8k, g8k, plan=p8k),
         F32, 2 * 25 * 8192 * 8192, 4 * (2 * 8192 * 8192 + 25),
         lambda: torch.nn.grad.conv2d_weight(
             x8k[None, None], (1, 1, 5, 5), g8k[None, None], padding=2), K3),
        ("K1 conv2 forward bf16 I/O",
         lambda: run(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         lambda: ref(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         3e-2, 2 * D * D * 3 * B * (T // 2),
         2 * (B * D * T + B * D * T // 2) + 4 * (D * D * 3 + D), None, K1),
    ]
    # K3's launches per train step: the stem's two dW calls at these shapes
    k3_step = (K3.launches_for(c["mel"], c["g1"], plan=p1)
               + K3.launches_for(c["x2"], g2d, plan=lin2))
    # -- (a) each kernel against its plain version at the stem's shapes ----
    worst = {"K1": 0.0, "K3": 0.0}
    for tag, kern, plain, rtol, *_ in cases:
        got, want = kern(), plain()
        err = compare(tag, got, want, rtol, results)
        if rtol == F32:
            worst[tag[:2]] = max(worst[tag[:2]], err)
        del got, want
    torch.cuda.empty_cache()

    # -- (b) the stem's autograd against the plain path ---------------------
    # Kernel path: ops.conv2d (K1 forward, recompute and dx, K3 dW).
    # Plain path: torch autograd through run_window_plan_reference.
    leaves = {k: c[k].clone().requires_grad_() for k in
              ("w1", "b1", "w2", "b2")}
    grads = {}
    for path in ("kernel", "plain"):
        p = {k: v.detach().clone().requires_grad_() for k, v in
             leaves.items()}
        if path == "kernel":
            y1 = ops.conv2d(c["mel"], p["w1"], epilogue=epi,
                            epilogue_args=(p["b1"],))
            y1.retain_grad()
            y2 = ops.conv2d(y1, p["w2"], stride=(1, 2), epilogue=epi,
                            epilogue_args=(p["b2"],))
        else:
            y1 = ref(c["mel"], p["w1"], plan=p1, epilogue_args=(p["b1"],))
            y1.retain_grad()
            y2 = ref(y1, p["w2"], plan=p2, epilogue_args=(p["b2"],))
        (y2 * c["g2"]).sum().backward()
        grads[path] = {**{k: v.grad for k, v in p.items()}, "x2": y1.grad}
    for k in ("w1", "b1", "w2", "b2", "x2"):
        compare(f"stem autograd d{k}: kernel path vs plain path",
                grads["kernel"][k], grads["plain"][k], F32, results)
    del grads, leaves
    torch.cuda.empty_cache()

    # -- (c) the main path: the trainer at full width ------------------------
    argv = ["--arch", "whisper-base", "--conv-frontend", "--steps",
            str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--seed", str(args.seed), "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = K3.launches = K5.launches = 0
    t0 = time.perf_counter()
    res = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k1, k3, k5 = K1.launches, K3.launches, K5.launches
    model = res.trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    steady = res.step_seconds[1:]
    step_ms = statistics.median(steady) * 1e3
    rec = {"arch": model.cfg.name, "params": n_params,
           "n_mels": model.cfg.n_mels, "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": res.losses,
           "grad_norms": res.grad_norms,
           "step_ms": [t * 1e3 for t in res.step_seconds],
           "step_ms_median_after_first": step_ms,
           "samples_per_s": TRAIN_BATCH / step_ms * 1e3, "run_s": run_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "k1_launches": k1, "k3_launches": k3, "k5_launches": k5,
           "card": card}
    results["train"] = rec
    emit({"phase": "train", **rec})
    require(n_params == TRAIN_PARAMS, ("whisper-base parameters", n_params))
    require(all(np.isfinite(res.losses)), ("non-finite loss", res.losses))
    require(k1 == 5 * TRAIN_STEPS and k3 == k3_step * TRAIN_STEPS
            and k5 == 0,
            (f"train launches (K1 5/step, K3 {k3_step}/step)", k1, k3, k5))

    # -- (d) times at the stem's shapes, and one profiled step --------------
    for tag, kern, plain, _, flops, nbytes, lib, _ in cases:
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        if "bf16" in tag:
            continue
        ms = device_ms(kern, 20)
        rec = {"case": tag, "ms": ms, "call_ms": event_ms(kern, 20),
               "plain_ms": device_ms(plain, 3),
               "library_ms": device_ms(lib, 20), "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "gflop": flops / 1e9, "bytes": nbytes,
               "roofline_share": max(b_ms, f_ms) / ms, "card": card}
        results["times"].append(rec)
        emit({"phase": "train_time", **rec})
    ds = TokenDataset(model.cfg.vocab, TRAIN_SEQ, seed=args.seed)
    batch = train.make_batch(model, ds, TRAIN_STEPS, TRAIN_BATCH, dev)
    res.trainer.step(batch)
    torch.cuda.synchronize()
    before = K1.launches, K3.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, _ = res.trainer.step(batch)
        float(loss)
        torch.cuda.synchronize()
    rec = {**device_ops(prof, match={"k1": "window_reduce_kernel",
                                     "k3": "wgrad"}),
           "k1_launches": K1.launches - before[0],
           "k3_launches": K3.launches - before[1], "card": card}
    rec["stem_share"] = ((rec["k1_ms"] + rec["k3_ms"]) / rec["device_ms"]
                         if rec["device_ms"] else None)
    # The same step's stem from the timed calls of (d): each forward twice
    # (the backward recomputes the pre-activation), conv2's dx, both dW.
    timed = {r["case"][:14]: r["ms"] for r in results["times"]
             if r["case"].startswith(("K1 conv", "K3 conv"))}
    rec["stem_ms_from_timed_calls"] = (
        2 * timed["K1 conv1 forwa"] + 2 * timed["K1 conv2 forwa"]
        + timed["K1 conv2 dx, a"] + timed["K3 conv1 dW (8"]
        + timed["K3 conv2 dW on"])
    kernels = {}
    for e in prof.events():
        if "ssam" in e.name and e.device_type == DeviceType.CUDA:
            kernels[e.name[:60]] = kernels.get(e.name[:60], 0) + 1
    rec["stem_kernel_events"] = kernels
    results["train_profile"] = rec
    emit({"phase": "train_profile", **rec})
    return {"k1_launches": k1, "k3_launches": k3, "k3_step": k3_step,
            "worst": worst, "first_loss": res.losses[0], "step_ms": step_ms,
            "k3_headline": next(r for r in results["times"]
                                if r["case"].startswith("K3 conv2 dW")),
            "k1_headline": next(r for r in results["times"]
                                if r["case"].startswith("K1 conv2 dx"))}


def mxu_phase(args, dev, card, results, lanes) -> dict:
    """Phase 9: K2, the tensor-core kernel, on the stencil and convolution
    path and the Whisper stem, then whisper-base trained with the stem
    pinned to it. ``lanes`` is phase 8's result (its first loss)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.core import adjoint, engine
    from repro_torch.core.plan import normalize_epilogue
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import ops, ssam_conv2d, ssam_stencil2d
    from repro_torch.kernels import ssam_stencil3d, stencils
    from repro_torch.launch import train
    from repro_torch.models import build_model

    K1, K2 = engine.WINDOW_KERNEL, engine.MXU_KERNEL
    K3, K5 = engine.WGRAD_KERNEL, engine.SCAN_KERNEL
    ref = engine.run_window_plan_reference
    rng = np.random.default_rng(args.seed + 5)

    def randn(*shape):
        return convert.from_numpy(
            rng.standard_normal(shape, dtype=np.float32), dev)

    def mxu(p):
        return dataclasses.replace(p, strategy="mxu")

    def stencil_plan(sd):
        mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
        return mxu(mod.plan_for(sd))

    worst = {"abs": 0.0, "stem": 0.0}

    def check(tag, y, plain, lanes_y, rtol, key="abs"):
        err = compare(f"K2 {tag}", y, plain, rtol, results)
        worst[key] = max(worst[key], err)
        if lanes_y is not None:
            compare(f"K2 {tag} vs K1", y, lanes_y, MXU_VS_LANES, results)

    # -- (a) the stencil and convolution path through K2 -------------------
    K1.launches = K2.launches = K3.launches = K5.launches = 0
    calls = 0
    grids = {2: randn(GRID_2D, GRID_2D), 3: randn(GRID_3D, GRID_3D, GRID_3D)}
    for name, sd in stencils.BENCHMARKS.items():
        x = grids[sd.ndim]
        for t in (1, 2):
            y = ops.stencil(x, name, time_steps=t, strategy="mxu")
            calls += 1
            check(f"{name} t={t}", y, ref(x, plan=stencil_plan(sd),
                                          time_steps=t),
                  ops.stencil(x, name, time_steps=t), MXU_RTOL)
            del y
    xb16 = grids[2].to(torch.bfloat16)
    y = ops.stencil(xb16, "2d9pt", time_steps=2, strategy="mxu")
    calls += 1
    check("2d9pt bf16 t=2", y, ref(xb16, plan=stencil_plan(
        stencils.BENCHMARKS["2d9pt"]), time_steps=2), None, 3e-2)
    del xb16, y
    x = grids[2]
    filters = {k: randn(k, k) for k in CONV_SIZES}
    for k, w in filters.items():
        y = ops.conv2d(x, w, mode="same", strategy="mxu")
        calls += 1
        check(f"conv2d {k}x{k} same", y,
              ref(x, w, plan=mxu(ssam_conv2d.plan_for((k, k), "same"))),
              ops.conv2d(x, w, mode="same"), MXU_RTOL)
        del y
    torch.cuda.synchronize()

    # -- (b) the stem's full-width calls through K2 --------------------------
    c = stem_cases(dev, args.seed + 3)
    epi = ("bias", "gelu")

    def nchw(x, w, stride=None, epilogue=None):
        return mxu(dataclasses.replace(
            ssam_conv2d.plan_for_nchw(x.shape, w.shape, "same"),
            stride=stride, epilogue=normalize_epilogue(epilogue)))

    p1 = nchw(c["mel"], c["w1"], None, epi)
    p2 = nchw(c["x2"], c["w2"], (1, 2), epi)
    lin2 = nchw(c["x2"], c["w2"])
    adj2 = adjoint.input_adjoint_plan(lin2)
    require(adj2.strategy == "mxu", "the adjoint plan keeps strategy='mxu'")
    wa2 = adjoint.adjoint_coeff_array(lin2, c["w2"])
    g2d = torch.zeros_like(c["g1"])
    g2d[..., ::2] = c["g2"]
    run = engine.run_window_plan
    B, T, D = TRAIN_BATCH, 2 * N_FRAMES, D_MODEL
    # (tag, K2 call, K1 call, plain call, rtol, fp32 operations, bytes,
    #  library call)
    stem = [
        ("conv1 forward (8,80,1,3000)->(8,512,1,3000) bias+gelu",
         lambda: run(c["mel"], c["w1"], plan=p1, epilogue_args=(c["b1"],)),
         lambda: run(c["mel"], c["w1"], plan=p1, epilogue_args=(c["b1"],),
                     strategy="lanes"),
         lambda: ref(c["mel"], c["w1"], plan=p1, epilogue_args=(c["b1"],)),
         STEM_RTOL, 2 * D * N_MELS * 3 * B * T,
         4 * (B * N_MELS * T + D * N_MELS * 3 + D + B * D * T),
         lambda: F.gelu(F.conv2d(c["mel"], c["w1"], c["b1"], padding=(0, 1)),
                        approximate="tanh")),
        ("conv2 forward stride (1,2) (8,512,1,3000)->(8,512,1,1500) "
         "bias+gelu",
         lambda: run(c["x2"], c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         lambda: run(c["x2"], c["w2"], plan=p2, epilogue_args=(c["b2"],),
                     strategy="lanes"),
         lambda: ref(c["x2"], c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         STEM_RTOL, 2 * D * D * 3 * B * (T // 2),
         4 * (B * D * T + D * D * 3 + D + B * D * T // 2),
         lambda: F.gelu(F.conv2d(c["x2"], c["w2"], c["b2"], stride=(1, 2),
                                 padding=(0, 1)), approximate="tanh")),
        ("conv2 dx, adjoint plan on the scattered cotangent (8,512,1,3000)",
         lambda: run(g2d, wa2, plan=adj2),
         lambda: run(g2d, wa2, plan=adj2, strategy="lanes"),
         lambda: ref(g2d, wa2, plan=adj2), STEM_RTOL, 2 * D * D * 3 * B * T,
         4 * (2 * B * D * T + D * D * 3),
         lambda: torch.nn.grad.conv2d_input(
             c["x2"].shape, c["w2"], c["g2"], stride=(1, 2), padding=(0, 1))),
    ]
    for tag, kern, lanes_fn, plain, rtol, *_ in stem:
        got = kern()
        calls += 1
        check(tag, got, plain(), lanes_fn(), rtol, "stem")
        del got
    x2_bf16 = c["x2"].to(torch.bfloat16)
    y = run(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],))
    calls += 1
    check("conv2 forward bf16 I/O", y,
          ref(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],)), None, 3e-2)
    del y, x2_bf16
    torch.cuda.empty_cache()

    # the stem's autograd: K2 (forwards, recomputed pre-activations, dx) and
    # K3 (dW) against torch autograd through the plain mxu versions
    grads = {}
    for path in ("kernel", "plain"):
        p = {k: c[k].detach().clone().requires_grad_() for k in
             ("w1", "b1", "w2", "b2")}
        if path == "kernel":
            y1 = ops.conv2d(c["mel"], p["w1"], epilogue=epi,
                            epilogue_args=(p["b1"],), strategy="mxu")
            y1.retain_grad()
            y2 = ops.conv2d(y1, p["w2"], stride=(1, 2), epilogue=epi,
                            epilogue_args=(p["b2"],), strategy="mxu")
            calls += 5
        else:
            y1 = ref(c["mel"], p["w1"], plan=p1, epilogue_args=(p["b1"],))
            y1.retain_grad()
            y2 = ref(y1, p["w2"], plan=p2, epilogue_args=(p["b2"],))
        (y2 * c["g2"]).sum().backward()
        grads[path] = {**{k: v.grad for k, v in p.items()}, "x2": y1.grad}
    for k in ("w1", "b1", "w2", "b2", "x2"):
        compare(f"K2 stem autograd d{k}: kernel path vs plain path",
                grads["kernel"][k], grads["plain"][k], STEM_RTOL, results)
    del grads
    torch.cuda.synchronize()
    rec = {"kernel": K2.name, "launches": K2.launches, "calls": calls}
    results["mxu_launches"] = rec
    emit({"phase": "mxu_launches", **rec})
    require(K2.launches == calls, rec)
    launches = K2.launches
    torch.cuda.empty_cache()

    # -- (c) the main path: whisper-base trained with the stem on K2 ---------
    cfg = dataclasses.replace(get_config("whisper-base"), conv_frontend=True,
                              n_mels=N_MELS, conv_strategy="mxu",
                              dtype="float32")
    ds = TokenDataset(cfg.vocab, TRAIN_SEQ, seed=args.seed)
    first = first_loss_parity(cfg, ds, dev, args.seed, card, results)
    model = build_model(cfg, device=dev, seed=args.seed)
    trainer = train.Trainer(model, lr=3e-4,
                            warmup=max(TRAIN_STEPS // 10, 10),
                            total=max(TRAIN_STEPS, 100))
    n_params = sum(p.numel() for p in model.parameters())
    losses, step_s = [], []
    torch.cuda.synchronize()
    K1.launches = K2.launches = K3.launches = K5.launches = 0
    for step in range(TRAIN_STEPS):
        batch = train.make_batch(model, ds, step, TRAIN_BATCH, dev)
        t0 = time.perf_counter()
        loss, _ = trainer.step(batch)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    k1, k2, k3, k5 = K1.launches, K2.launches, K3.launches, K5.launches
    step_ms = statistics.median(step_s[1:]) * 1e3
    rel = abs(losses[0] - lanes["first_loss"]) / abs(lanes["first_loss"])
    init_spread = first[1.0]["lanes_perturbed_rel"]
    rec = {"arch": cfg.name, "conv_strategy": cfg.conv_strategy,
           "params": n_params, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "losses": losses,
           "step_ms": [t * 1e3 for t in step_s],
           "step_ms_median_after_first": step_ms,
           "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
           "lanes_first_loss": lanes["first_loss"],
           "first_loss_rel_diff": rel,
           "lanes_perturbed_rel_at_init": init_spread,
           "lanes_step_ms_median_after_first": lanes["step_ms"],
           "k1_launches": k1, "k2_launches": k2, "k3_launches": k3,
           "k5_launches": k5, "card": card}
    results["train_mxu"] = rec
    emit({"phase": "train_mxu", **rec})
    require(n_params == TRAIN_PARAMS, ("whisper-base parameters", n_params))
    require(all(np.isfinite(losses)), ("non-finite loss", losses))
    require(first[SOFT_SCALE]["mxu_vs_lanes_rel"] <= LOSS_RTOL,
            ("first-step loss, mxu against lanes, weights x "
             f"{SOFT_SCALE}", first[SOFT_SCALE]))
    # At the reference's init the loss moves by more than LOSS_RTOL under a
    # rounding-level change of the weights (ROADMAP R4), so there the two
    # strategies can only agree to that spread's order: it is recorded.
    require(k2 == 5 * TRAIN_STEPS and k3 == lanes["k3_step"] * TRAIN_STEPS
            and k1 == k5 == 0,
            (f"mxu train launches (K2 5/step, K3 {lanes['k3_step']}/step, "
             "K1 0)", k1, k2, k3))

    # -- (d) times: K2 beside both bounds, K1, plain and cuDNN ---------------
    def record(tag, kern, lanes_fn, plain, flops, nbytes, lib):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        tc_ms = flops / TF32_FLOPS * 1e3
        ms = device_ms(kern, TIME_REPS)
        rec = {"case": tag, "ms": ms, "call_ms": event_ms(kern, TIME_REPS),
               "k1_ms": device_ms(lanes_fn, TIME_REPS),
               "plain_ms": device_ms(plain, 3),
               "library_ms": device_ms(lib, TIME_REPS),
               "library_tf32_ms": device_ms(cudnn_tf32(lib), TIME_REPS),
               "bound_ms": max(b_ms, tc_ms),
               "bound_by": "bytes" if b_ms >= tc_ms else "operations",
               "fp32_bound_ms": max(b_ms, f_ms),
               "fp32_bound_by": "bytes" if b_ms >= f_ms else "operations",
               "bytes_ms": b_ms, "tensor_core_ms": tc_ms, "fp32_ms": f_ms,
               "gflop": flops / 1e9, "bytes": nbytes,
               "roofline_share": max(b_ms, tc_ms) / ms, "card": card}
        results["times"].append(rec)
        emit({"phase": "mxu_time", **rec})
        return rec

    timed = {}
    for tag, kern, lanes_fn, plain, _, flops, nbytes, lib in stem:
        timed[tag[:14]] = record(f"K2 {tag}", kern, lanes_fn, plain, flops,
                                 nbytes, lib)
    for name in MXU_TIMED:
        sd = stencils.BENCHMARKS[name]
        x = grids[sd.ndim]
        wt, pads = dense_filter(sd, dev)
        cells = x.numel()
        timed[name] = record(
            f"K2 {name} t=1", lambda: ops.stencil(x, name, strategy="mxu"),
            lambda: ops.stencil(x, name),
            lambda: ref(x, plan=stencil_plan(sd)),
            (2 * len(sd.offsets) - 1) * cells, 8 * cells,
            lambda: library(x, wt, pads))
    x, w = grids[2], filters[20]
    pads = [(9, 10), (9, 10)]
    timed["conv20"] = record(
        "K2 conv2d 20x20 same t=1",
        lambda: ops.conv2d(x, w, mode="same", strategy="mxu"),
        lambda: ops.conv2d(x, w, mode="same"),
        lambda: ref(x, w, plan=mxu(ssam_conv2d.plan_for((20, 20), "same"))),
        (2 * 400 - 1) * x.numel(), 8 * x.numel(),
        lambda: library(x, w, pads))
    del grids, filters, x, w
    torch.cuda.empty_cache()

    batch = train.make_batch(model, ds, TRAIN_STEPS, TRAIN_BATCH, dev)
    trainer.step(batch)
    torch.cuda.synchronize()
    before = K2.launches, K3.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, _ = trainer.step(batch)
        float(loss)
        torch.cuda.synchronize()
    rec = {**device_ops(prof, match={"k2": "mxu_reduce_kernel",
                                     "k3": "wgrad"}),
           "k2_launches": K2.launches - before[0],
           "k3_launches": K3.launches - before[1], "card": card}
    rec["stem_share"] = ((rec["k2_ms"] + rec["k3_ms"]) / rec["device_ms"]
                         if rec["device_ms"] else None)
    results["train_mxu_profile"] = rec
    emit({"phase": "train_mxu_profile", **rec})
    return {"launches": launches, "train_launches": k2, "worst": worst,
            "headline": timed["2d5pt"],
            "stem_headline": timed["conv2 dx, adjo"]}


class _PlainKernels:
    """Within the block the engine's wrappers of K1, K4 and K5 are replaced
    by the plain versions, so the same model code runs autograd through
    them on the card (the kernels' counters stay put)."""

    def __enter__(self):
        from repro_torch.core import engine

        self.saved = (engine.WINDOW_KERNEL, engine.PERLANE_WGRAD_KERNEL,
                      engine.SCAN_KERNEL)
        engine.WINDOW_KERNEL = engine.run_window_plan_reference
        engine.PERLANE_WGRAD_KERNEL = engine.run_weight_grad_plan_reference
        engine.SCAN_KERNEL = engine.run_scan_plan_reference
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine

        (engine.WINDOW_KERNEL, engine.PERLANE_WGRAD_KERNEL,
         engine.SCAN_KERNEL) = self.saved
        return False


def hymba_phase(args, dev, card, results) -> dict:
    """Phase 10: train hymba-1.5b at full width; its Mamba branch runs K1's
    per-lane path (the conv1d forward, its recomputed pre-activation and
    dx), K4 (the conv's dW) and K5 (the selective scan forward and its
    reversed λ-recurrence)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.core import adjoint, engine, plan
    from repro_torch.core.plan import normalize_epilogue
    from repro_torch.kernels import ops, ssam_conv1d
    from repro_torch.launch import train
    from repro_torch.models import build_model, hymba
    from repro_torch.nn import spec

    K1, K2, K3 = engine.WINDOW_KERNEL, engine.MXU_KERNEL, engine.WGRAD_KERNEL
    K4, K5 = engine.PERLANE_WGRAD_KERNEL, engine.SCAN_KERNEL
    rng = np.random.default_rng(args.seed + 7)

    def put(*shape, scale=1.0, low=None):
        a = (rng.uniform(low, 1.0, shape) if low is not None
             else scale * rng.standard_normal(shape))
        return convert.from_numpy(a.astype(np.float32), dev)

    B, T, D, K = HYMBA_BATCH, HYMBA_SEQ, HYMBA_DI, HYMBA_K
    x, g = put(B, T, D), put(B, T, D)
    w, b = put(K, D, scale=K ** -0.5), put(D, scale=0.1)
    p = ssam_conv1d.plan_for(K)
    pe = dataclasses.replace(p, epilogue=normalize_epilogue(("bias", "silu")))
    adj = adjoint.input_adjoint_plan(p)
    xo, go = put(3, 37, 100), put(3, 37, 100)
    wo, bo = put(K, 100, scale=0.5), put(100, scale=0.1)
    xb16, gb16 = x.bfloat16(), g.bfloat16()
    R, L = B * D * HYMBA_N, HYMBA_CHUNK
    sa, sb, sg = put(R, L, low=0.5), put(R, L), put(R, L)
    sh0, sgc = put(R, 1), put(R, 1)
    lin = plan.linear_recurrence_plan(L)
    run, ref = engine.run_window_plan, engine.run_window_plan_reference
    wrun, wref = engine.run_weight_grad_plan, engine.run_weight_grad_plan_reference
    # the library's layout: channels ahead of time, (B, D, T)
    xt, wt = x.transpose(1, 2).contiguous(), w.T[:, None, :].contiguous()
    gt = F.pad(g.transpose(1, 2), (0, K - 1)).contiguous()
    abar = adjoint.time_reversed(adjoint.reversed_recurrence_coeffs(sa))
    grev = adjoint.time_reversed(sg)
    elems = B * T * D
    # (tag, kernel, plain, rtol, bytes, operations, library, counted)
    cases = [
        ("K1 per-lane conv1d forward (2,2048,3200) K=4 bias+silu fp32",
         lambda: run(x, w, plan=pe, epilogue_args=(b,)),
         lambda: ref(x, w, plan=pe, epilogue_args=(b,)), PERLANE_RTOL,
         4 * (2 * elems + K * D + D), 2 * K * elems,
         lambda: F.silu(F.conv1d(xt, wt, b, padding=K - 1,
                                 groups=D)[..., :T]), True),
        ("K1 per-lane conv1d dx, the input-adjoint plan (2,2048,3200)",
         lambda: run(g, w, plan=adj), lambda: ref(g, w, plan=adj),
         PERLANE_RTOL, 4 * (2 * elems + K * D), 2 * K * elems,
         lambda: torch.nn.grad.conv1d_input(xt.shape, wt, gt, padding=K - 1,
                                            groups=D), True),
        ("K4 per-lane dW (2,2048,3200) -> (4,3200)",
         lambda: wrun(x, g, plan=p), lambda: wref(x, g, plan=p), K4_RTOL,
         4 * (2 * elems + K * D), 2 * K * elems,
         lambda: torch.nn.grad.conv1d_weight(xt, wt.shape, gt,
                                             padding=K - 1, groups=D), True),
        ("K5 reversed chunk, the lambda-recurrence (102400,128)",
         lambda: engine.run_scan_plan(abar, grev, plan=lin),
         lambda: engine.run_scan_plan_reference(abar, grev, plan=lin), 1e-5,
         12 * R * L, 3 * R * L, None, True),
        ("K1 per-lane conv1d forward (3,37,100) bias+silu fp32",
         lambda: run(xo, wo, plan=pe, epilogue_args=(bo,)),
         lambda: ref(xo, wo, plan=pe, epilogue_args=(bo,)), PERLANE_RTOL,
         0, 0, None, False),
        ("K1 per-lane conv1d dx (3,37,100)", lambda: run(go, wo, plan=adj),
         lambda: ref(go, wo, plan=adj), PERLANE_RTOL, 0, 0, None, False),
        ("K4 per-lane dW (3,37,100)", lambda: wrun(xo, go, plan=p),
         lambda: wref(xo, go, plan=p), K4_RTOL, 0, 0, None, False),
        ("K1 per-lane conv1d forward bf16 I/O (2,2048,3200)",
         lambda: run(xb16, w, plan=pe, epilogue_args=(b,)),
         lambda: ref(xb16, w, plan=pe, epilogue_args=(b,)), 3e-2, 0, 0, None,
         False),
        ("K4 per-lane dW bf16 inputs (2,2048,3200)",
         lambda: wrun(xb16, gb16, plan=p), lambda: wref(xb16, gb16, plan=p),
         3e-2, 0, 0, None, False),
    ]
    # -- (a) each kernel against its plain version at the slice's shapes ----
    worst = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
    K1.launches = K4.launches = K5.launches = 0
    for tag, kern, plain, rtol, *_ in cases:
        err = compare(tag, kern(), plain(), rtol, results)
        if rtol < 3e-2:
            worst[tag[:2]] = max(worst[tag[:2]], err)
    k4_want = sum(K4.launches_for(xx, gg, plan=p)
                  for xx, gg in ((x, g), (xo, go), (xb16, gb16)))
    require((K1.launches, K4.launches, K5.launches) == (5, k4_want, 1),
            ("phase 10 (a) launches", K1.launches, K4.launches, K5.launches))
    # the scan adjoint: LinrecCarryOp's backward through K5 against the same
    # adjoint spelled out with the plain version
    ta, tb, th = (t.clone().requires_grad_() for t in (sa, sb, sh0))
    h, hT = ops.linear_recurrence_carry(ta, tb, th)
    got = torch.autograd.grad((h, hT), (ta, tb, th), (sg, sgc))
    hp = engine.run_scan_plan_reference(sa, sb, plan=lin, carry=sh0)
    gg = sg.clone()
    gg[:, -1:] += sgc
    lam = adjoint.time_reversed(engine.run_scan_plan_reference(
        abar, adjoint.time_reversed(gg), plan=lin))
    want = (lam * adjoint.shifted_state(hp, sh0), lam,
            adjoint.chunk_carry_cotangent(sa, lam))
    for name, gv, wv in zip(("da", "db", "dh0"), got, want):
        worst["K5"] = max(worst["K5"], compare(
            f"K5 scan adjoint {name}, LinrecCarryOp backward (102400,128)",
            gv, wv, 1e-5, results))
    del ta, tb, th, h, hT, got, hp, gg, lam, want
    torch.cuda.empty_cache()

    # -- (b) one full-width layer: kernels against the plain versions -------
    cfg = get_config("hymba-1.5b")
    model = build_model(cfg, device=dev, seed=args.seed)
    n_params = sum(q.numel() for q in model.parameters())
    require(n_params == spec.param_count(hymba.specs(cfg)) == HYMBA_PARAMS,
            ("hymba-1.5b parameters", n_params))
    p0 = model.params["layers"][0]
    leaves0 = list(spec.module_leaves(p0))
    xl = put(B, T, cfg.d_model)
    gl = put(B, T, cfg.d_model)
    pos = torch.arange(T, device=dev)

    def layer_grads():
        xx = xl.clone().requires_grad_()
        y = model.layer(p0, xx, positions=pos, is_global=True)
        return torch.autograd.grad(y, [xx] + [q for _, q in leaves0], gl)

    before = K1.launches, K4.launches, K5.launches
    kern_g = layer_grads()
    layer_launches = tuple(k.launches - v for k, v in
                           zip((K1, K4, K5), before))
    with _PlainKernels():
        plain_g = layer_grads()
    k4_layer = engine.perlane_wgrad_launches(B, T, cfg.d_inner)
    require(layer_launches == (3, k4_layer, 3 * (T // L)),
            (f"one layer's launches (K1 3, K4 {k4_layer}, K5 3 per chunk)",
             layer_launches))
    # conditioning: the same gradients after a relative 1e-7 change of the
    # layer's parameters (kernels again)
    with torch.no_grad():
        saved = [q.clone() for _, q in leaves0]
        gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
        for _, q in leaves0:
            q.mul_(1 + PERTURB_REL * torch.randn(q.shape, generator=gen,
                                                 device=dev))
    moved_g = layer_grads()
    with torch.no_grad():
        for (_, q), s0 in zip(leaves0, saved):
            q.copy_(s0)
    names = ["x"] + [".".join(map(str, path)) for path, _ in leaves0]
    spread = max(float((m - k).abs().max() / k.abs().max().clamp_min(1e-30))
                 for m, k in zip(moved_g, kern_g))
    layer_worst = 0.0
    for name, kg, pg in zip(names, kern_g, plain_g):
        scale = pg.abs().max().item()
        err = (kg - pg).abs().max().item()
        layer_worst = max(layer_worst, err / max(scale, 1e-30))
        torch.testing.assert_close(
            kg, pg, rtol=0, atol=LAYER_RTOL * scale,
            msg=lambda m, n=name: f"layer 0 d{n}: {m}")
    rec = {"case": "hymba-1.5b layer 0, full width (2,2048,1600), is_global",
           "leaves": len(names), "worst_rel_to_scale": layer_worst,
           "perturbed_spread_rel": spread, "perturbation": PERTURB_REL,
           "rtol": LAYER_RTOL, "launches": dict(zip(("k1", "k4", "k5"),
                                                   layer_launches)),
           "card": card}
    results["hymba_layer"] = rec
    emit({"phase": "hymba_layer", **rec})
    del kern_g, plain_g, moved_g, saved, model, p0, leaves0
    torch.cuda.empty_cache()

    # -- (c) the main path: the trainer at full width -------------------------
    argv = ["--arch", "hymba-1.5b", "--steps", str(HYMBA_STEPS), "--batch",
            str(HYMBA_BATCH), "--seq", str(HYMBA_SEQ), "--seed",
            str(args.seed), "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = K2.launches = K3.launches = K4.launches = K5.launches = 0
    t0 = time.perf_counter()
    res = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {"k1": K1.launches, "k2": K2.launches, "k3": K3.launches,
           "k4": K4.launches, "k5": K5.launches}
    per_step = hymba.train_launches(cfg, HYMBA_SEQ, HYMBA_BATCH)
    want = {"k1": HYMBA_STEPS * per_step["k1"], "k2": 0, "k3": 0,
            "k4": HYMBA_STEPS * per_step["k4"],
            "k5": HYMBA_STEPS * per_step["k5"]}
    model = res.trainer.model
    step_ms = statistics.median(res.step_seconds[1:]) * 1e3
    rec = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_inner": cfg.d_inner,
           "window": cfg.window, "steps": HYMBA_STEPS, "batch": HYMBA_BATCH,
           "seq": HYMBA_SEQ, "losses": res.losses,
           "grad_norms": res.grad_norms,
           "step_ms": [t * 1e3 for t in res.step_seconds],
           "step_ms_median_after_first": step_ms,
           "samples_per_s": HYMBA_BATCH / step_ms * 1e3,
           "tokens_per_s": HYMBA_BATCH * HYMBA_SEQ / step_ms * 1e3,
           "run_s": run_s, "peak_mem_gb_per_step": res.peak_mem_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": got, "launches_expected": want,
           "launches_per_step": per_step, "card": card}
    results["train_hymba"] = rec
    emit({"phase": "train_hymba", **rec})
    require(all(np.isfinite(res.losses)), ("non-finite loss", res.losses))
    require(got == want, ("hymba train launches", got, want))

    # -- (d) times at the slice's shapes, and one profiled step --------------
    timed = {}
    for tag, kern, plain, _, nbytes, flops, lib, counted in cases:
        if not counted:
            continue
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        ms = device_ms(kern, 20)
        rec = {"case": tag, "ms": ms, "call_ms": event_ms(kern, 20),
               "plain_ms": device_ms(plain, 3),
               "library_ms": None if lib is None else device_ms(lib, 20),
               "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "bytes": nbytes, "roofline_share": max(b_ms, f_ms) / ms,
               "card": card}
        results["times"].append(rec)
        emit({"phase": "hymba_time", **rec})
        timed[tag[:2] + (" dx" if " dx" in tag else "")] = rec
    from repro_torch.data import TokenDataset

    ds = TokenDataset(cfg.vocab, HYMBA_SEQ, seed=args.seed)
    batch = train.make_batch(model, ds, HYMBA_STEPS, HYMBA_BATCH, dev)
    before = K1.launches, K4.launches, K5.launches
    # device activity only: the step's ~10⁵ host-side ops would cost the
    # profiler more than the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss, _ = res.trainer.step(batch)
        float(loss)
        torch.cuda.synchronize()
    rec = {**device_ops(prof, match={"k1": "window_perlane_kernel",
                                     "k4": "wgrad_perlane",
                                     "k5": "ssam_scan_kernel",
                                     "copies": "copy"}),
           "launches": {k: v.launches - n for k, v, n in
                        zip(("k1", "k4", "k5"), (K1, K4, K5), before)},
           "card": card}
    rec["k1_k4_k5_share"] = ((rec["k1_ms"] + rec["k4_ms"] + rec["k5_ms"])
                             / rec["device_ms"] if rec["device_ms"] else None)
    results["train_hymba_profile"] = rec
    emit({"phase": "train_hymba_profile", **rec})
    if rec["device_ms"]:
        # the counters count launches: the profiler sees as many kernels
        seen = {k: rec[f"{k}_calls"] for k in ("k1", "k4", "k5")}
        require(seen == rec["launches"],
                ("profiled launches against the counters", seen,
                 rec["launches"]))
    return {"launches": got, "worst": worst, "timed": timed,
            "step_ms": step_ms}


def first_loss_parity(cfg, ds, dev, seed, card, results) -> dict:
    """The first step's loss of whisper-base with the stem on K2 (``cfg``)
    and on K1 (the same config with ``conv_strategy=None``), on the same
    weights (from ``seed``) and batch, at the reference's init and with
    the weight matrices scaled by SOFT_SCALE, where the attention is no
    longer nearly one-hot (ROADMAP R4). Beside each pair: how far the
    lanes loss moves when every parameter moves by a relative
    PERTURB_REL, the conditioning that a rounding difference in the stem
    meets. No gradient is taken; the kernels' counters move."""
    import dataclasses

    import torch

    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.nn import spec

    out = {}
    for scale in (1.0, SOFT_SCALE):
        losses = {}
        for name, c in (("mxu", cfg),
                        ("lanes", dataclasses.replace(cfg,
                                                      conv_strategy=None))):
            model = build_model(c, device=dev, seed=seed)
            batch = train.make_batch(model, ds, 0, TRAIN_BATCH, dev)
            with torch.no_grad():
                for path, p in spec.module_leaves(model.params):
                    if p.ndim >= 2 and path[-1].startswith("w"):
                        p.mul_(scale)
                losses[name] = float(model.loss(batch))
                if name == "lanes":
                    gen = torch.Generator(device=dev).manual_seed(seed + 6)
                    for _, p in spec.module_leaves(model.params):
                        p.mul_(1 + PERTURB_REL * torch.randn(
                            p.shape, generator=gen, device=dev))
                    losses["lanes_perturbed"] = float(model.loss(batch))
            del model
            torch.cuda.empty_cache()
        lanes_loss = losses["lanes"]
        rec = {"weight_scale": scale, **{f"{k}_loss": v for k, v in
                                        losses.items()},
               "mxu_vs_lanes_rel": abs(losses["mxu"] - lanes_loss)
               / abs(lanes_loss),
               "lanes_perturbed_rel": abs(losses["lanes_perturbed"]
                                          - lanes_loss) / abs(lanes_loss),
               "perturbation": PERTURB_REL, "card": card}
        out[scale] = rec
        results.setdefault("first_loss_parity", []).append(rec)
        emit({"phase": "first_loss_parity", **rec})
    return out


def dense_filter(sd, dev):
    """A stencil's taps as a dense filter, and the (lo, hi) zero padding per
    axis that makes one correlation with it the stencil."""
    import torch

    los = [min(o[a] for o in sd.offsets) for a in range(sd.ndim)]
    his = [max(o[a] for o in sd.offsets) for a in range(sd.ndim)]
    wt = torch.zeros([h - l + 1 for l, h in zip(los, his)], device=dev)
    for off, c in zip(sd.offsets, sd.coeffs):
        wt[tuple(d - l for d, l in zip(off, los))] = c
    return wt, [(-l, h) for l, h in zip(los, his)]


def library(x, wt, pads):
    """The same zero-boundary correlation as one cuDNN call. Only 2d64pt's
    corner-anchored pad has no padding= form: it pays an F.pad first."""
    import torch.nn.functional as F

    conv = F.conv2d if x.ndim == 2 else F.conv3d
    if all(lo == hi for lo, hi in pads):
        return conv(x[None, None], wt[None, None],
                    padding=tuple(lo for lo, _ in pads))[0, 0]
    if all(lo == (lo + hi) // 2 for lo, hi in pads):
        return conv(x[None, None], wt[None, None], padding="same")[0, 0]
    return library_padded(x, wt, pads)


def library_padded(x, wt, pads):
    """F.pad, then a valid cuDNN correlation: two calls, but cuDNN picks
    faster algorithms for them than for a padded call."""
    import torch.nn.functional as F

    conv = F.conv2d if x.ndim == 2 else F.conv3d
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    return conv(F.pad(x[None, None], flat), wt[None, None])[0, 0]


def cudnn_tf32(fn):
    """``fn`` run with cuDNN's TF32 on (less precise: three digits), the
    setting restored after."""
    import torch

    def run():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    return run


def _row(rec) -> dict:
    """A timed case's numbers as the kernel line carries them."""
    return {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "case")}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the numpy generator for grids and "
                             "filters")
    parser.add_argument("--out", default=os.path.join(ROOT, "build",
                                                      "chip_smoke"),
                        help="directory for chip_smoke.json")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch import _build, convert
    from repro_torch.core import engine
    from repro_torch.kernels import ops, ref, ssam_conv2d, stencils
    from repro_torch.kernels import ssam_stencil2d, ssam_stencil3d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    def randn(*shape):
        return convert.from_numpy(
            rng.standard_normal(shape, dtype=np.float32), dev)

    card = card_line()
    K1, K3, K5 = engine.WINDOW_KERNEL, engine.WGRAD_KERNEL, engine.SCAN_KERNEL
    K2, K4 = engine.MXU_KERNEL, engine.PERLANE_WGRAD_KERNEL
    results = {"card": card, "seed": args.seed, "checks": [], "times": []}

    marks = [("1-5 build, stencils, convolution", time.perf_counter())]

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    results["build"] = {"seconds": time.perf_counter() - t0,
                        "nvcc_seconds": _build.LIBRARY.build_seconds,
                        **ptxas_summary(_build.LIBRARY.ptxas_log)}
    emit({"phase": "build", **results["build"], "card": card})

    def stencil_plan(sd):
        mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
        return mod.plan_for(sd)

    worst = {"abs": 0.0}

    def check(tag, y, plain, rtol, shape):
        require(tuple(y.shape) == tuple(shape), (tag, y.shape, shape))
        worst["abs"] = max(worst["abs"], compare(tag, y, plain, rtol, results))

    # -- 2./3. the main path ----------------------------------------------
    K1.launches = K2.launches = K3.launches = K5.launches = 0
    calls = 0
    grids = {2: randn(8192, 8192), 3: randn(512, 512, 512)}
    for name, sd in stencils.BENCHMARKS.items():
        x = grids[sd.ndim]
        for variant in engine.VARIANTS:
            for t in (1, 2):
                y = ops.stencil(x, name, time_steps=t, variant=variant)
                calls += 1
                plain = engine.run_window_plan_reference(
                    x, plan=stencil_plan(sd), time_steps=t, variant=variant)
                check(f"{name} {variant} t={t}", y, plain, 3e-5, x.shape)
                del y, plain
    xb16 = grids[2].to(torch.bfloat16)
    y = ops.stencil(xb16, "2d9pt", time_steps=2)
    calls += 1
    plain = engine.run_window_plan_reference(
        xb16, plan=stencil_plan(stencils.BENCHMARKS["2d9pt"]), time_steps=2)
    check("2d9pt bf16 t=2", y, plain, 3e-2, xb16.shape)
    del xb16, y, plain

    x = grids[2]
    filters = {k: randn(k, k) for k in CONV_SIZES}
    for k, w in filters.items():
        for mode in ("same", "valid"):
            y = ops.conv2d(x, w, mode=mode)
            calls += 1
            plain = engine.run_window_plan_reference(
                x, w, plan=ssam_conv2d.plan_for((k, k), mode))
            shape = x.shape if mode == "same" else (8192 - k + 1,) * 2
            check(f"conv2d {k}x{k} {mode}", y, plain, 3e-5, shape)
            del y, plain
    xs = randn(16, 2048, 2048)
    y = ops.conv2d(xs, filters[5], mode="same")
    calls += 1
    plain = engine.run_window_plan_reference(
        xs, filters[5], plan=ssam_conv2d.plan_for_batched((5, 5), "same"))
    check("conv2d batched (16,2048,2048) 5x5 same", y, plain, 3e-5, xs.shape)
    del xs, y, plain

    # Small inputs against the oracles, which state the math directly.
    small = randn(64, 96)
    small3 = randn(16, 24, 40)
    for name, xsm in (("2d121pt", small), ("2d64pt", small),
                      ("3d125pt", small3), ("poisson", small3)):
        for t in (1, 3):
            y = ops.stencil(xsm, name, time_steps=t, variant="shift_data")
            calls += 1
            check(f"{name} t={t} vs ref.stencil_iterate", y,
                  ref.stencil_iterate(xsm, stencils.BENCHMARKS[name], t),
                  3e-5, xsm.shape)
    y = ops.conv2d(small, filters[7], mode="same")
    calls += 1
    check("conv2d 7x7 same vs ref.conv2d_same", y,
          ref.conv2d_same(small, filters[7]), 3e-5, small.shape)
    torch.cuda.synchronize()

    # -- 4. launch count --------------------------------------------------
    launches = K1.launches
    results["launches"] = {"kernel": K1.name, "launches": launches,
                           "calls": calls, "k2_launches": K2.launches,
                           "k3_launches": K3.launches,
                           "k5_launches": K5.launches}
    emit({"phase": "launches", **results["launches"]})
    require(launches == calls and K2.launches == K3.launches == K5.launches
            == 0, results["launches"])

    # -- 5. times at t = 1 --------------------------------------------------
    def bound(in_elems, out_elems, elem_bytes, flops):
        b_ms = (in_elems + out_elems) * elem_bytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")

    def record(tag, kernel_fn, plain_fn, x, wt, pads, in_elems, out_elems,
               flops):
        b_ms, by = bound(in_elems, out_elems, 4, flops)
        k_ms = event_ms(kernel_fn, TIME_REPS)
        rec = {"case": tag, "ms": k_ms, "plain_ms": event_ms(plain_fn, 3),
               "library_ms": event_ms(lambda: library(x, wt, pads),
                                      TIME_REPS),
               "library_pad_then_conv_ms": event_ms(
                   lambda: library_padded(x, wt, pads), TIME_REPS),
               "bound_ms": b_ms,
               "bound_by": by, "gcells_per_s": out_elems / k_ms / 1e6,
               "hbm_share": (in_elems + out_elems) * 4
               / (k_ms * 1e-3) / HBM_BYTES_PER_S,
               "roofline_share": b_ms / k_ms, "card": card}
        results["times"].append(rec)
        emit({"phase": "time", **rec})
        return rec

    headline = None
    for name, sd in stencils.BENCHMARKS.items():
        x = grids[sd.ndim]
        plan = stencil_plan(sd)
        wt, pads = dense_filter(sd, dev)
        cells = x.numel()
        for variant in engine.VARIANTS:
            rec = record(
                f"{name} {variant} t=1",
                lambda: ops.stencil(x, name, variant=variant),
                lambda: engine.run_window_plan_reference(
                    x, plan=plan, variant=variant),
                x, wt, pads, cells, cells, (2 * len(sd.offsets) - 1) * cells)
            if name == "2d5pt" and variant == "shift_psum":
                headline = rec
    x = grids[2]
    for k, w in filters.items():
        plan = ssam_conv2d.plan_for((k, k), "same")
        pads = [((k - 1) // 2, k - 1 - (k - 1) // 2)] * 2
        record(f"conv2d {k}x{k} same",
               lambda: ops.conv2d(x, w, mode="same"),
               lambda: engine.run_window_plan_reference(x, w, plan=plan),
               x, w, pads, x.numel(), x.numel(), (2 * k * k - 1) * x.numel())

    del grids, filters, x
    torch.cuda.empty_cache()
    marks.append(("6 scan ops", time.perf_counter()))
    scan = scan_phase(args, dev, card, results)
    marks.append(("7 serve rwkv6-1.6b", time.perf_counter()))
    served = serve_phase(args, dev, card, results)
    torch.cuda.empty_cache()
    marks.append(("8 train whisper-base", time.perf_counter()))
    trained = train_phase(args, dev, card, results)
    torch.cuda.empty_cache()
    marks.append(("9 tensor cores", time.perf_counter()))
    mxu = mxu_phase(args, dev, card, results, trained)
    torch.cuda.empty_cache()
    marks.append(("10 train hymba-1.5b", time.perf_counter()))
    hy = hymba_phase(args, dev, card, results)
    marks.append(("end", time.perf_counter()))
    results["phase_seconds"] = {name: t1 - t0 for (name, t0), (_, t1)
                                in zip(marks, marks[1:])}
    emit({"phase": "phase_seconds", **results["phase_seconds"]})

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    wkv = scan["headline"]
    k3h, k1t = trained["k3_headline"], trained["k1_headline"]
    k2h, k2t = mxu["headline"], mxu["stem_headline"]
    emit({"kernels": [{
        "name": K1.name, "route": "cuda", "source": K1.source,
        "replaces": K1.replaces, "launches": launches,
        "max_abs_err": worst["abs"], "ms": headline["ms"],
        "plain_ms": headline["plain_ms"], "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "case": headline["case"] + " 8192x8192 fp32",
        "train": {"launches": trained["k1_launches"],
                  "max_abs_err": trained["worst"]["K1"], "ms": k1t["ms"],
                  "plain_ms": k1t["plain_ms"], "bound_ms": k1t["bound_ms"],
                  "bound_by": k1t["bound_by"],
                  "library_ms": k1t["library_ms"], "case": k1t["case"]},
        "hymba": {"launches": hy["launches"]["k1"],
                  "max_abs_err": hy["worst"]["K1"],
                  **_row(hy["timed"]["K1"]),
                  "dx": _row(hy["timed"]["K1 dx"])}}, {
        "name": K5.name, "route": "cuda", "source": K5.source,
        "replaces": K5.replaces, "launches": served["k5_launches"],
        "max_abs_err": scan["worst_abs"], "ms": wkv["ms"],
        "plain_ms": wkv["plain_ms"], "bound_ms": wkv["bound_ms"],
        "bound_by": wkv["bound_by"], "library_ms": wkv["library_ms"],
        "case": wkv["case"],
        "hymba": {"launches": hy["launches"]["k5"],
                  "max_abs_err": hy["worst"]["K5"],
                  **_row(hy["timed"]["K5"])}}, {
        "name": K3.name, "route": "cuda", "source": K3.source,
        "replaces": K3.replaces, "launches": trained["k3_launches"],
        "max_abs_err": trained["worst"]["K3"], "ms": k3h["ms"],
        "plain_ms": k3h["plain_ms"], "bound_ms": k3h["bound_ms"],
        "bound_by": k3h["bound_by"], "library_ms": k3h["library_ms"],
        "case": k3h["case"]}, {
        "name": K2.name, "route": "cuda", "source": K2.source,
        "replaces": K2.replaces, "launches": mxu["launches"],
        "max_abs_err": mxu["worst"]["abs"], "ms": k2h["ms"],
        "plain_ms": k2h["plain_ms"], "bound_ms": k2h["bound_ms"],
        "bound_by": k2h["bound_by"], "library_ms": k2h["library_ms"],
        "case": k2h["case"] + " 8192x8192 fp32",
        "train": {"launches": mxu["train_launches"],
                  "max_abs_err": mxu["worst"]["stem"], "ms": k2t["ms"],
                  "plain_ms": k2t["plain_ms"], "bound_ms": k2t["bound_ms"],
                  "bound_by": k2t["bound_by"],
                  "library_ms": k2t["library_ms"], "case": k2t["case"]}}, {
        "name": K4.name, "route": "cuda", "source": K4.source,
        "replaces": K4.replaces, "launches": hy["launches"]["k4"],
        "max_abs_err": hy["worst"]["K4"], **_row(hy["timed"]["K4"])}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
