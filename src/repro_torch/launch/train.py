"""Training entry point of the port.

    python -m repro_torch.launch.train --arch whisper-base --conv-frontend \
        [--steps 100] [--batch 8] [--seq 128] [--lr 3e-4] [--device cuda]
    python -m repro_torch.launch.train --arch hymba-1.5b --batch 2 \
        --seq 2048 --steps 6 [--scan-impl engine]
    python -m repro_torch.launch.train --arch rwkv6-1.6b --batch 2 \
        --seq 2048 --steps 6 [--scan-impl engine]

Config → model (weights from ``--seed``) → per step: a synthetic token
batch (:class:`repro_torch.data.TokenDataset`) and, for the audio
family, a random-normal mel input from a ``torch.Generator`` seeded with
the step, the loss, its gradients through autograd and one AdamW update
under the reference's warm-up/cosine schedule (warm-up ``max(steps //
10, 10)``, total ``max(steps, 100)``). On the card Whisper's mel stem
runs backward through K1 and K3; Hymba's Mamba branch through K1's
per-lane path, K4 and K5 (the λ-recurrence); RWKV6's WKV through K5,
forward and λ. A step-time watchdog flags
stragglers (> EMA + 2.5σ and > 1.5× EMA). The flags and defaults are the
JAX CLI's; ``--device`` (default ``cuda``) is the port's. Checkpointing
(``--ckpt-dir``, ROADMAP Queue 1 item 10) and model parallelism
(``--model-axis > 1``, item 12) are not ported and raise; the audio
(whisper), hybrid (hymba) and ssm (rwkv6) families train.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..nn.spec import module_leaves
from ..optim import adamw_state, adamw_update, cosine_schedule


class Trainer:
    """A model, its AdamW state and the learning-rate schedule: each
    :meth:`step` takes the loss, its gradients and one update."""

    def __init__(self, model, *, lr: float, warmup: int, total: int):
        self.model = model
        self.params = [p for _, p in module_leaves(model.params)]
        self.state = adamw_state(self.params)
        self.lr, self.warmup, self.total = lr, warmup, total

    def step(self, batch: dict):
        """``(loss, grad_norm)`` of one step, as device scalars."""
        loss = self.model.loss(batch)
        grads = torch.autograd.grad(loss, self.params)
        lr_t = cosine_schedule(self.state["step"], base_lr=self.lr,
                               warmup=self.warmup, total=self.total)
        gnorm = adamw_update(self.params, grads, self.state, lr=lr_t)
        return loss.detach(), gnorm


def make_batch(model, ds, step: int, batch: int, device) -> dict:
    """Training batch ``step``: tokens and labels from ``ds``, and the
    encoder input (``model.train_inputs``: mel ``(B, n_mels, 2·n_frames)``
    for the conv stem, frame embeddings otherwise), random normal from a
    generator seeded with ``step``."""
    out = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
           for k, v in ds.batch(step, batch).items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(step)
    for key, (shape, dtype) in model.train_inputs(batch, ds.seq_len).items():
        if key not in out:
            out[key] = torch.randn(shape, generator=gen, device=device,
                                   dtype=dtype)
    return out


@dataclasses.dataclass
class TrainResult:
    losses: list
    grad_norms: list
    step_seconds: list
    stragglers: int
    trainer: Trainer
    peak_mem_gb: list = dataclasses.field(default_factory=list)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--conv-frontend", action="store_true",
                    help="audio archs: train the real mel conv stem through "
                         "the SSAM engine instead of stub frame embeddings")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the token stream")
    ap.add_argument("--scan-impl", default=None,
                    choices=("engine", "engine_unchunked", "chunked"),
                    help="recurrence schedule for ssm/hybrid archs: "
                         "'engine' streams (R, chunk) slabs through the "
                         "scan engine (O(chunk) memory); default 'engine'")
    ap.add_argument("--metrics-file", default="")
    ap.add_argument("--device", default="cuda",
                    help="device of the weights and batches (default cuda)")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP Queue 1 item 10)")
    if args.model_axis > 1:
        raise NotImplementedError(
            "model parallelism is not ported yet (ROADMAP Queue 1 item 12)")

    from ..config import get_config
    from ..data import TokenDataset
    from ..models import build_model

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in ("audio", "hybrid", "ssm"):
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported yet (ROADMAP "
            "Queue 1 item 9)")
    if args.conv_frontend:
        if cfg.family != "audio":
            ap.error(f"--conv-frontend is for audio archs, not {cfg.family}")
        n_mels = cfg.n_mels or (8 if args.smoke else 80)
        cfg = dataclasses.replace(cfg, conv_frontend=True, n_mels=n_mels)
    if args.scan_impl:
        cfg = dataclasses.replace(cfg, scan_impl=args.scan_impl)
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    device = torch.device(args.device)
    model = build_model(cfg, device=device, seed=args.seed)
    trainer = Trainer(model, lr=args.lr, warmup=max(args.steps // 10, 10),
                      total=max(args.steps, 100))
    ds = TokenDataset(cfg.vocab, args.seq, seed=args.seed)
    res = TrainResult([], [], [], 0, trainer)
    ema, emvar = None, 0.0
    metrics_f = open(args.metrics_file, "a") if args.metrics_file else None
    try:
        for step in range(args.steps):
            batch = make_batch(model, ds, step, args.batch, device)
            t0 = time.perf_counter()
            loss, gnorm = trainer.step(batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            res.losses.append(loss)
            res.grad_norms.append(float(gnorm))
            res.step_seconds.append(dt)
            peak = ""
            if device.type == "cuda":
                res.peak_mem_gb.append(
                    torch.cuda.max_memory_allocated(device) / 1e9)
                peak = f" peak {res.peak_mem_gb[-1]:.2f}GB"
            if ema is None:
                ema = dt
            else:
                d = dt - ema
                ema += 0.1 * d
                emvar = 0.9 * (emvar + 0.1 * d * d)
                if (step > 5 and dt > ema + 2.5 * max(emvar, 1e-12) ** 0.5
                        and dt > 1.5 * ema):
                    res.stragglers += 1
                    print(f"[watchdog] step {step} straggled: {dt:.3f}s "
                          f"(ema {ema:.3f}s)", flush=True)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {res.grad_norms[-1]:8.3f} {dt * 1e3:7.1f}ms"
                      f"{peak}", flush=True)
            if metrics_f:
                metrics_f.write(json.dumps(
                    {"step": step, "loss": loss, "dt": dt}) + "\n")
                metrics_f.flush()
    finally:
        if metrics_f:
            metrics_f.close()
    print(f"[train] done: loss {res.losses[0]:.4f} → {res.losses[-1]:.4f}, "
          f"median step {np.median(res.step_seconds) * 1e3:.1f}ms, "
          f"stragglers flagged: {res.stragglers}", flush=True)
    return res


if __name__ == "__main__":
    main()
