#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed N] [--out DIR]

Two paths. The first is the paper's experiment: the 15 Table-3 stencils
at 8192² (2-D) and 512³ (3-D) in fp32, both schedule variants,
t ∈ {1, 2}, one bf16 case, and 2-D convolution ('same' and 'valid') at
8192² over the Fig. 4 filter sweep plus a (16, 2048, 2048) batched 5×5,
all through ``repro_torch.kernels.ops`` on CUDA tensors, i.e. through
K1, the CUDA windowed-plan kernel. The second serves rwkv6-1.6b at full
width (weights from ``--seed``) through ``repro_torch.launch.serve``,
whose prefill runs the WKV recurrence through K5, the CUDA scan kernel.
Phases, one JSON line each:

1. build: compile K1 and K5 from ``src/repro_torch/csrc`` (nvcc, sm_90a);
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
   tolerance.

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def ptxas_summary(log: str) -> dict:
    """Most registers and most spill bytes over the kernels ptxas built."""
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", log)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "max_spill_store_bytes": max(spills, default=0)}


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


def device_ops(prof, top: int = 5):
    """Kernels of a ``torch.profiler`` run by device time: the ``top``
    largest, the total, and K5's share."""
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
    k5 = [r for r in rows if "ssam_scan_kernel" in r[0]]
    k5_ms = sum(r[1] for r in k5)
    return {"device_ms": total,
            "top": [{"op": k[:160], "ms": ms, "calls": c,
                     "share": ms / total} for k, ms, c in rows[:top]],
            "k5_ms": k5_ms, "k5_calls": sum(r[2] for r in k5),
            "k5_share": k5_ms / total if total else None}


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
    K1, K5 = engine.WINDOW_KERNEL, engine.SCAN_KERNEL
    results = {"card": card, "seed": args.seed, "checks": [], "times": []}

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
    K1.launches = K5.launches = 0
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
                           "calls": calls, "k5_launches": K5.launches}
    emit({"phase": "launches", **results["launches"]})
    require(launches == calls and K5.launches == 0, results["launches"])

    # -- 5. times at t = 1 --------------------------------------------------
    def bound(in_elems, out_elems, elem_bytes, flops):
        b_ms = (in_elems + out_elems) * elem_bytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")

    def dense_filter(sd):
        los = [min(o[a] for o in sd.offsets) for a in range(sd.ndim)]
        his = [max(o[a] for o in sd.offsets) for a in range(sd.ndim)]
        wt = torch.zeros([h - l + 1 for l, h in zip(los, his)], device=dev)
        for off, c in zip(sd.offsets, sd.coeffs):
            wt[tuple(d - l for d, l in zip(off, los))] = c
        return wt, [(-l, h) for l, h in zip(los, his)]

    def library(x, wt, pads):
        """The same zero-boundary correlation as one cuDNN call. Only
        2d64pt's corner-anchored pad has no padding= form: it pays an
        F.pad first."""
        conv = F.conv2d if x.ndim == 2 else F.conv3d
        if all(lo == hi for lo, hi in pads):
            return conv(x[None, None], wt[None, None],
                        padding=tuple(lo for lo, _ in pads))[0, 0]
        if all(lo == (lo + hi) // 2 for lo, hi in pads):
            return conv(x[None, None], wt[None, None], padding="same")[0, 0]
        return library_padded(x, wt, pads)

    def library_padded(x, wt, pads):
        """F.pad, then a valid cuDNN correlation: two calls, but cuDNN
        picks faster algorithms for them than for a padded call."""
        conv = F.conv2d if x.ndim == 2 else F.conv3d
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        return conv(F.pad(x[None, None], flat), wt[None, None])[0, 0]

    def record(tag, kernel_fn, plain_fn, x, wt, pads, in_elems, out_elems,
               flops):
        b_ms, by = bound(in_elems, out_elems, 4, flops)
        k_ms = event_ms(kernel_fn, 20)
        rec = {"case": tag, "ms": k_ms, "plain_ms": event_ms(plain_fn, 3),
               "library_ms": event_ms(lambda: library(x, wt, pads), 20),
               "library_pad_then_conv_ms": event_ms(
                   lambda: library_padded(x, wt, pads), 20),
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
        wt, pads = dense_filter(sd)
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
    scan = scan_phase(args, dev, card, results)
    served = serve_phase(args, dev, card, results)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    wkv = scan["headline"]
    emit({"kernels": [{
        "name": K1.name, "route": "cuda", "source": K1.source,
        "replaces": K1.replaces, "launches": launches,
        "max_abs_err": worst["abs"], "ms": headline["ms"],
        "plain_ms": headline["plain_ms"], "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "case": headline["case"] + " 8192x8192 fp32"}, {
        "name": K5.name, "route": "cuda", "source": K5.source,
        "replaces": K5.replaces, "launches": served["k5_launches"],
        "max_abs_err": scan["worst_abs"], "ms": wkv["ms"],
        "plain_ms": wkv["plain_ms"], "bound_ms": wkv["bound_ms"],
        "bound_by": wkv["bound_by"], "library_ms": wkv["library_ms"],
        "case": wkv["case"]}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
