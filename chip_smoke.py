#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--out DIR]

The main path is the paper's experiment: the 15 Table-3 stencils at
8192² (2-D) and 512³ (3-D) in fp32, both schedule variants, t ∈ {1, 2},
one bf16 case, and 2-D convolution ('same' and 'valid') at 8192² over the
Fig. 4 filter sweep plus a (16, 2048, 2048) batched 5×5, all through
``repro_torch.kernels.ops`` on CUDA tensors, i.e. through K1, the CUDA
windowed-plan kernel. Phases, one JSON line each:

1. build: compile K1 from ``src/repro_torch/csrc`` (nvcc, sm_90a);
2. stencils and 3. convolution: every case against the plain torch
   version on the card, ``rtol=3e-5, atol=3e-5·max|plain|`` (bf16:
   3e-2), and small cases against the torch oracles;
4. launch count: K1's counter, zeroed before the main path, must equal
   the number of calls the main path made;
5. times at t = 1: kernel, plain version and the library yardstick
   (``F.conv2d``/``F.conv3d`` with TF32 off, never called by the port):
   one call with ``padding=``, and ``F.pad`` then a valid call, each the
   median of CUDA-event timed calls, beside the card's bound (bytes over
   3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is larger).

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
    K1 = engine.WINDOW_KERNEL
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
        torch.cuda.synchronize()
        require(tuple(y.shape) == tuple(shape), (tag, y.shape, shape))
        require(bool(torch.isfinite(y).all()), (tag, "non-finite output"))
        scale = plain.float().abs().max().item()
        err = (y.float() - plain.float()).abs().max().item()
        torch.testing.assert_close(y, plain, rtol=rtol, atol=rtol * scale,
                                   msg=lambda m: f"{tag}: {m}")
        worst["abs"] = max(worst["abs"], err)
        rec = {"case": tag, "max_abs_err": err, "max_abs_plain": scale,
               "rtol": rtol}
        results["checks"].append(rec)
        emit({"phase": "check", **rec})

    # -- 2./3. the main path ----------------------------------------------
    K1.launches = 0
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
                           "calls": calls}
    emit({"phase": "launches", **results["launches"]})
    require(launches == calls, (launches, calls))

    # -- 5. times at t = 1 --------------------------------------------------
    def event_ms(fn, reps):
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

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    emit({"kernels": [{
        "name": K1.name, "route": "cuda", "source": K1.source,
        "replaces": K1.replaces, "launches": launches,
        "max_abs_err": worst["abs"], "ms": headline["ms"],
        "plain_ms": headline["plain_ms"], "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "case": headline["case"] + " 8192x8192 fp32"}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
