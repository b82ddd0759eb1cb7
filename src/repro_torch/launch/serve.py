"""Batched decode server with continuous batching.

A fixed pool of B decode slots advances in lock-step through one
``serve_step`` per token; a finished request's slot is refilled from the
queue at once while the other slots keep decoding.

Prefill: the model's ``prefill`` runs the whole prompt but its last
token in one call (for RWKV6, through the chunk-streamed scan engine:
K5 on the card), and only the resulting O(1) state lands in the slot;
the last prompt token then rides the normal decode step, so the slot's
state trajectory is the token-by-token one.

Greedy sampling by default; temperature sampling draws from an explicit
``torch.Generator``. A step that raises propagates: there is no retry or
load shedding in this port yet.

Usage (weights drawn from ``--seed``; the card by default):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..nn.spec import init_params


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (L,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_assign: float = 0.0       # slot-assignment wall time (latency metric)
    deadline_s: float | None = None   # wall-clock budget from slot assignment
    error: str | None = None    # why the request failed (None = clean finish)


class DecodeServer:
    """Continuous-batching decode server over a fixed slot pool, on the
    model's device. ``step_seconds`` holds the host time of every
    lock-step decode (each ends when the sampled tokens reach the host)."""

    def __init__(self, model, *, slots: int, cache_len: int,
                 temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.device = model.device
        self.B = slots
        self.cache_len = cache_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = init_params(model.decode_state_specs(slots, cache_len),
                                 device=self.device)
        self.index = np.zeros((slots,), np.int32)     # per-slot positions
        self.slot_req: list[Request | None] = [None] * slots
        self.prompt_left: list[np.ndarray] = [np.zeros((0,), np.int32)] * slots
        self.tokens = np.zeros((slots, 1), np.int64)
        self.active_mask = np.zeros((slots,), bool)
        self.steps = 0
        self.step_seconds: list[float] = []

    def assign(self, req: Request, slot: int):
        req.t_assign = time.perf_counter()
        self.slot_req[slot] = req
        self.index[slot] = 0
        self.active_mask[slot] = True
        # zero this slot's state so a stale one cannot leak across requests
        for s in self.state.values():
            s[:, slot] = 0
        if len(req.prompt) > 1:
            _, st = self.model.prefill(torch.as_tensor(
                np.asarray(req.prompt[None, :-1], np.int64),
                device=self.device))
            for k, s in self.state.items():
                s[:, slot] = st[k][:, 0].to(s.dtype)
            self.index[slot] = len(req.prompt) - 1
            self.tokens[slot, 0] = req.prompt[-1]
            self.prompt_left[slot] = np.zeros((0,), np.int32)
        else:
            self.tokens[slot, 0] = req.prompt[0]
            self.prompt_left[slot] = req.prompt[1:]

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.cpu().numpy().astype(np.int64)

    def step(self):
        """One lock-step decode across all slots."""
        t0 = time.perf_counter()
        logits, self.state = self.model.serve_step(
            self.state, torch.as_tensor(self.tokens, device=self.device),
            torch.as_tensor(self.index, device=self.device))
        nxt = self._sample(logits)
        self.steps += 1
        self.step_seconds.append(time.perf_counter() - t0)
        for b in range(self.B):
            if not self.active_mask[b]:
                continue
            req = self.slot_req[b]
            self.index[b] += 1
            if len(self.prompt_left[b]):               # still prefilling
                self.tokens[b, 0] = self.prompt_left[b][0]
                self.prompt_left[b] = self.prompt_left[b][1:]
            else:
                req.out.append(int(nxt[b]))
                self.tokens[b, 0] = nxt[b]
                if (len(req.out) >= req.max_new
                        or self.index[b] >= self.cache_len - 1):
                    req.done = True
                    self.active_mask[b] = False
                    self.slot_req[b] = None

    def free_slots(self):
        return [b for b in range(self.B) if not self.active_mask[b]]

    def _fail_slot(self, b: int, reason: str):
        """Reclaim slot ``b``: its request comes back done with ``.error``
        set, and the slot takes the next queued request."""
        req = self.slot_req[b]
        if req is not None:
            req.error = reason
            req.done = True
        self.active_mask[b] = False
        self.slot_req[b] = None
        self.prompt_left[b] = np.zeros((0,), np.int32)

    def _sweep_deadlines(self):
        now = time.perf_counter()
        for b in range(self.B):
            req = self.slot_req[b]
            if (req is not None and req.deadline_s is not None
                    and now - req.t_assign > req.deadline_s):
                self._fail_slot(b, "deadline")

    def run(self, requests: list[Request]) -> list[Request]:
        """Drain ``requests`` through the slot pool, sweeping per-request
        deadlines every iteration. Every request comes back ``done``;
        ``.error`` tells a deadline miss from a clean finish."""
        queue = list(requests)
        done: list[Request] = []
        while queue or self.active_mask.any():
            self._sweep_deadlines()
            for b in self.free_slots():
                if not queue:
                    break
                self.assign(queue.pop(0), b)
            if self.active_mask.any():
                self.step()
            for r in requests:
                if r.done and r not in done:
                    done.append(r)
        return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the arch")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--scan-impl", default=None,
                    choices=("engine", "engine_unchunked"),
                    help="recurrence schedule: chunk-streamed engine "
                         "(default) or one engine call over the prompt")
    ap.add_argument("--device", default="cuda",
                    help="device of the weights and state (default cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the requests")
    args = ap.parse_args(argv)

    from ..config import get_config
    from ..models import build_model

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.scan_impl:
        cfg = dataclasses.replace(cfg, scan_impl=args.scan_impl)
    model = build_model(cfg, device=args.device, seed=args.seed)
    server = DecodeServer(model, slots=args.slots, cache_len=args.cache_len,
                          seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32), args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = server.run(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in done)
    print(f"[serve] {cfg.name} on {server.device}: {len(done)} requests, "
          f"{tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s, "
          f"{server.steps} batched steps)")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}…")
    return done


if __name__ == "__main__":
    main()
