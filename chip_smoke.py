#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed N] [--out DIR]

Ten paths. The first is the paper's experiment: the 15 Table-3
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
the selective scan, forward and backward, through K5. The sixth runs the
windowed ops' whole surface at full size: fused epilogues and residuals,
output strides on single-channel convolution (forward, dx and dW) and
grouped convolution (a depthwise conv one K1 launch over its images, a
filter each, and one K3 walk with a gradient per channel), through K1,
K2 and K3. The seventh runs Hymba's
depthwise conv1d with ``strategy="mxu"``: forward and dx through K2's
per-lane path (``csrc/ssam_mxu_perlane.cu``), dW through K4. The eighth
trains rwkv6-1.6b at full width through ``repro_torch.launch.train``:
its WKV runs forward through K5 in checkpointed chunks and backward
through K5's λ-recurrence. The ninth runs fused plan pipelines
(``ops.pipeline``): a chain of stencil or conv stages in one launch of
K1's single-channel kernel or, pinned to ``strategy="mxu"``, of K2's,
the intermediates kept in shared memory; a chain no launch holds as
launches of its segments. The tenth runs filters of any size: K1's
single-channel path walking a footprint in bands, K2's streaming its
Toeplitz tiles a group of entries at a time, K3's channel path beyond 64
taps.
Phases, one JSON line each:

1. build: compile K1, K2, K3, K4 and K5 from ``src/repro_torch/csrc``
   (nvcc, sm_90a, one process per source, all started together), with
   the counts of ``HGMMA`` and ``UTMALDG`` in K3's channel kernel and of
   ``HGMMA``, ``UTMALDG``, ``LDS`` and ``STS`` in K2's, the registers
   and spills of K1's reduce kernel and K2's channel kernel (neither may
   spill; K2's must hold ``HGMMA``), per K1 single-channel
   instantiation that phases 2–5 and 14 launch, its registers, spills and
   ``UTMALDG``, ``LDGSTS``, ``SHFL``, ``FFMA`` and ``BRX`` counts (none
   may spill; each must hold ``UTMALDG``), per instantiation of K2's
   single-channel kernel (1–4 k-steps an entry; the strided one; the four
   of fused pipelines) its registers, spills and
   ``HMMA``, ``HGMMA``, ``UTMALDG`` and ``LDS`` counts (none may spill;
   each must hold ``HMMA`` and ``UTMALDG``), and per instance of K1's
   per-lane kernel its registers (none may spill), with the path's
   ``LDG.E.128``, ``STG.E.128``, ``LDGSTS`` and ``LDS.128`` counts, and
   per width bucket of K3's single-channel kernel (``engine.WGRAD_M_BUCKETS``,
   fp32 and bf16) its
   registers (none may spill), with the path's ``FFMA``, ``LDS``,
   ``UTMALDG`` and ``SHFL`` counts;
2. stencils and 3. convolution: every case against the plain torch
   version on the card, ``rtol=3e-5, atol=3e-5·max|plain|`` (bf16:
   3e-2), and small cases against the torch oracles;
4. launch count: K1's counter, zeroed before the main path, must equal
   the number of calls the main path made;
5. times of the stencils at t = 1 and 2 and of the 'same' filter sweep:
   the kernel's device time ``ms`` (events on a card kept busy while the
   host enqueues the call, ``device_ms``) and its call time ``call_ms``
   (events on an idle card: the wrapper's host time in, ``event_ms``),
   the plain version and the library yardstick (``F.conv2d``/``F.conv3d``
   with TF32 off, never called by the port): one call with ``padding=``
   (t = 1 only), and ``F.pad`` then one valid call per step, each the
   median of CUDA-event timed calls, beside the card's bound (bytes over
   3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is larger).
   Where ``build/parent/probe.py`` exists (an uncommitted probe that
   builds earlier kernels from their own sources) and offers an earlier
   K1, that kernel's device and call times stand beside, from the same
   process on the same card, after its output is held to this kernel's
   at 3e-5;
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
   stride (1, 2), both with bias+GELU), conv2's dx through the phases of
   the strided adjoint (one launch, the cotangent read as the forward
   produced it) and on the input-adjoint plan of the cotangent scattered
   onto the dense lattice (the two held against each other too), K1's
   reduce path on small edge cases (C_out 4, 37, 129, 130; strides up to
   (3, 3); rows of 17 and 257 fp32 columns; bf16 rows of 1500), each
   forward and phased dx, the dW of both (conv2's on the strided cotangent, and again on
   the cotangent scattered onto the dense lattice; once more in bf16),
   and one bf16 forward, each against
   its plain version on the card (fp32 rtol 1e-4, atol 1e-4·max|plain|;
   bf16 3e-2), and each K3 call twice for equal bits; (b) the stem's
   gradients (both
   filters and biases, and conv2's input) through the kernels against
   torch autograd through the plain versions, same tolerance;
   (c) whisper-base with the stem (89,150,976 parameters, weights from
   ``--seed``, TF32 off), batch 8, 128 tokens, 6 steps of
   ``launch.train.main``: every loss finite, K1's counter (zeroed before)
   at 5 per step (2 forwards, 2 recomputed pre-activations, 1 dx) and
   K3's at its launches for the 2 dW calls of a step (4: each call splits
   its reduction and adds the partials in a second launch); (d) step time
   and samples/s, K1 (conv1 and conv2 forward, conv2's dx through the
   phases and on the scattered cotangent) and K3 device times beside their
   bound (K3's channel path as K2's: the operations
   counted once at the TF32 rate, the fp32 bound beside it), the plain
   versions and the library yardsticks (``F.conv2d`` + tanh-GELU,
   ``torch.nn.grad.conv2d_input`` / ``conv2d_weight``, TF32 off, and for
   K3 also on; never called by the port), and the profiler's top device
   ops of one step (host and device activity traced) with the stem's
   share, its ``window_reduce`` kernels equal to K1's counter (5) and
   its ``wgrad`` kernels to K3's, then the same step traced on the device
   only (its K3 kernels equal to the counter, its K1 kernels recorded);
   these steps run in a fresh process (``--profile-train-step``), since
   after phase 7 this process's traces lose some of K1's launches;
   (e) K3's single-channel path ('same' at 8192² fp32 with filters 5×5,
   3×3, 9×9 and 20×20, a batched (16, 2048, 2048) 5×5 and a bf16 5×5):
   each against its plain version (fp32 1e-4, bf16 3e-2), twice for equal
   bits, K3's counter (zeroed before) at ``launches_for``, then its
   device and call times beside its bound (fp32 FMAs, or the bytes), the
   plain version, the earlier kernel in turns where the probe offers one,
   and ``conv2d_weight`` on 5×5 fp32 (3 calls: seconds each); (f) a 1 GiB
   device-to-device ``copy_``: the card's sustainable bandwidth beside
   the published 3.35 TB/s; (g) the op path: one training step of a
   learned 5×5 filter on an 8192² field (``ops.conv2d``, a squared
   error, ``backward()``), its counters (zeroed before) at K1 1 and K3
   ``launches_for``, ``w.grad`` against autograd through the plain
   versions (1e-4), its device time and K3's share of it;
9. tensor cores: (a) the 15 stencils at 8192² / 512³, t ∈ {1, 2}, and
   the 'same' filter sweep at 8192² with ``strategy="mxu"`` through K2,
   each against the plain mxu version on the card (fp32 rtol 3e-5; one
   bf16 2d9pt at 3e-2) and against K1's lanes result (1e-4, the
   reference's own lanes-versus-mxu tolerance); (b) the stem's conv1 and
   conv2 forwards, conv2's dx through the phases of the strided adjoint
   (one launch, the cotangent read as the forward produced it) and on the
   cotangent scattered onto the dense lattice (the two held against each
   other), each through K2's channel kernel against the plain version and
   K1 (1e-4) and twice for equal bits, one bf16 forward and one bf16
   phased dx at 3e-2, K2's forward and phased dx on phase 8's edge cases
   plus C_out 200 on 23 rows (a second channel tile 72 wide) and a 9×9
   filter at stride 3, and the stem's gradients through K2 and K3 against torch
   autograd through the plain mxu versions (1e-4); K2's counter, zeroed
   before (a), must equal the calls of (a) and (b); (c) whisper-base with
   ``conv_strategy="mxu"`` (the JAX CLI
   has no flag for it, so the script builds the config and drives
   ``launch.train.Trainer``), batch 8, 128 tokens, 6 steps: every loss
   finite, K2 at 5 launches per step, K3 as in phase 8 and K1 at 0;
   before it, the
   first step's loss with the stem on K2 and on K1, same weights and
   batch, within 1e-5 relative with the weight matrices scaled by 0.3,
   and recorded at the reference's init beside the change a 1e-7
   relative perturbation of the weights makes there (ROADMAP R4); (d) K2's times at the stem's shapes
   beside two bounds (bytes over 3.35 TB/s against fp32 operations over
   67 TFLOP/s, and against the same operations counted once over 495
   TFLOP/s of TF32), K1's time, the plain version's and the cuDNN
   yardstick with TF32 off and, labelled as less precise, on (conv2's dx
   counted at the 18.87 GFLOP of its real products, on the scattered
   cotangent too), and conv2's forward and phased dx with bf16 x and
   cotangent beside a bound at 989 TFLOP/s of bf16 and cuDNN in bf16;
   K2's single-channel device and call times on every Table-3 stencil
   (t = 1 and 2) and every 'same' filter of the sweep, beside both bounds
   and phase 5's K1, plain, cuDNN ``padding=`` and ``F.pad`` + valid
   times of the same case and input (not timed again), and, where the
   probe offers an earlier K2, that kernel's device and call times in
   turns after its output is held to K2's at 1e-4; the mxu train step's
   time and samples/s;
   one pinned step profiled in a fresh process (``--profile-train-step
   --profile-strategy mxu``): its ``mxu_tc`` kernels equal to K2's
   counter (5) in the host-and-device trace, its ``wgrad`` kernels to
   K3's in both traces, and the stem's share;
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
   K2, K3 at 0, step time, samples/s and peak memory; (d) K1 (the
   forward with bias+SiLU and without an epilogue, the chains the port
   launches, and the dx), K4 and the reversed K5 chunk timed beside their
   byte bounds, the plain versions and the library calls
   (``F.conv1d(groups=D)`` with and without SiLU,
   ``torch.nn.grad.conv1d_input`` / ``conv1d_weight`` on the (B, D, T)
   layout, never called by the port), K1's beside an earlier per-lane
   kernel in turns where the probe offers one, and one profiled step with
   its top device ops, the share of K1/K4/K5 and of copies;
11. epilogues, residuals, strides, groups: (a) K1 and K2 single-channel
   at 8192² fp32 with the chain fused at the store: 2d9pt with bias+ReLU
   at t = 1 (K1 in both variants), 2d5pt with GELU at t = 2, a bf16
   2d9pt with bias+ReLU, and conv 5×5 'same' with bias, GELU and the
   residual x itself; (b) strided single-channel 5×5 ('same' at stride 2
   and (1, 2), 'valid' at (3, 3), each at 8192², and 'same' stride 2 on
   (16, 2048, 2048)): the forward (one launch, only the kept outputs) and
   the phased dx (one launch a phase a tap reaches) through K1 and K2,
   the dW through K3 (per phase of x); (c) ``residual_add`` with
   bias+GELU on the whisper stem's conv2 shape through K1's reduce path
   and K2's channel path, and with bias+SiLU on Hymba's conv1d shape (2,
   2048, 3200) through K1's per-lane generic instance; (d) grouped NCHW
   'same', forward and backward: ResNeXt-like (8, 256, 56, 56) 3×3 at
   groups=32 with bias+GELU (one K1 launch a group), depthwise (8, 64,
   256, 256) 3×3 at groups=64 with bias+GELU and ConvNeXt's depthwise
   (64, 96, 56, 56) 7×7 at groups=96 with bias (one K1 launch forward
   over the B·C images, a filter each; backward 2 K1 launches, recompute
   and dx, and ``K3.launches_for`` K3 launches), each against the port's
   plain per-group backward and cuDNN's autograd at 1e-4, the depthwise
   ones also beside the parent's per-group route (a launch a group) timed
   in turns and K3's dW alone. Each case is
   held to its plain version on the card (single-channel 3e-5, reduce
   paths and K3 1e-4, bf16 3e-2; the grouped gradients to torch's
   autograd at 1e-4), its launches counted (K1, K2 and K3 zeroed before
   the phase and read after), and timed (``device_ms``) beside its bound
   (the bytes read and written once, the residual included, or its fp32
   operations), the unfused sequence (the same kernel without the
   epilogue, then torch's elementwise ops), the library call
   (``F.conv2d``/``F.conv1d`` with ``stride=``, ``padding=``,
   ``groups=``, TF32 off, plus the elementwise ops; ``conv2d_input`` and
   ``conv2d_weight`` for dx and dW; the grouped backward through cuDNN's
   autograd) and the plain version.

12. K2's per-lane path at Hymba's conv shape (2, 2048, 3200), K = 4:
   (a) ``ops.conv1d_causal(strategy="mxu")`` with bias+SiLU forward and
   backward once, the counters zeroed before and read after (K2 3: the
   forward, the recomputed pre-activation and dx; K4 its dW launches; K1
   0), its output and gradients against autograd through the plain
   versions at 1e-4; (b) the forward with bias+SiLU, the linear forward,
   bias+SiLU+residual and dx, fp32 and bf16, each against the plain mxu
   version (3e-5, bf16 3e-2) and K1's per-lane path (1e-4); (c) their
   device and call times beside the byte bound, the plain version, K1's
   per-lane path and the library call (``F.conv1d(groups=D)`` and the
   elementwise ops, ``conv1d_input``), beside an earlier per-lane kernel
   in turns where the probe offers one (``run_mxu_perlane``: the cost of
   the non-finite check); the build line carries
   ``mxu_perlane`` (registers, spills, ``HMMA``) and fails if an instance
   spills or lacks ``HMMA``;
13. train rwkv6-1.6b (1,465,503,744 parameters, weights from ``--seed``,
   TF32 off), batch 2 × 2048 tokens: (a) layer 0 of the full-width
   model, its output and gradients through K5 against autograd through
   the plain versions at 1e-4·max|leaf|, beside a 1e-7 relative
   perturbation's spread, K5 3 launches a chunk; (b) 6 steps of
   ``launch.train.main``: every loss finite, the counters (zeroed
   before) at ``models.rwkv6.train_launches`` per step (K5 3072, K1-K4
   0), step time, samples/s and peak memory; (c) K5's forward chunk with
   its carry and the reversed λ-recurrence at the training chunk's rows
   (262144, 64) against the plain versions, timed beside their byte
   bounds; one step on the host clock alone, then the next profiled
   (device only): device time, K5's and the copies' shares, and the
   card's idle share of that profiled step, over its own wall time and
   over its trace's span;
14. fused pipelines (``ops.pipeline``, K1's stage loop) at 8192² fp32:
   (a) ``["2d5pt", "2d9pt", "2d5pt"]`` fused (1 K1 launch) and with
   ``fuse=False`` (3), ``["2d5pt"] × 3`` equal to ``ops.stencil(
   time_steps=3)``, the conv chain ``[(w5, gelu), (w3, bias), (w5,
   residual_add)]``, ``["3d7pt", "3d27pt"]`` at 512³ and the 2-D chain on
   bf16 input (fused and unfused, each against its own plain version),
   each against the plain version on the card (fp32 3e-5, bf16 3e-2);
   (b) the linear chain's gradient (1 K1 launch: the reversed chain) and
   the conv chain's (6 K1 launches: the stages recomputed, dx a stage;
   K3's ``launches_for`` each dense stage's dW) against torch autograd
   through the plain version at 1e-4·max|leaf|; K1's and K3's counters,
   zeroed before (a), equal the calls' launches; (c) device times of the
   fused chain beside the unfused sequence, the byte bound and its share,
   the plain version and the library yardstick (``F.pad`` once, then a
   cuDNN call a stage with the same filters, TF32 off: three calls, no
   single PyTorch call computes a chain), for the chain, its backward
   launch, ``["2d5pt"] × 3`` beside ``time_steps=3``, the conv chain, the
   3-D chain and bf16; (d) the same chains pinned to ``strategy="mxu"``,
   each one K2 launch and no K1 launch (``fuse=False`` 3 K2 launches):
   the 2-D chain fused and unfused, the conv chain, the 3-D chain at
   512³, the 2-D chain on bf16 input and on an input with an inf and a
   nan (its non-finite set equal to the plain version's), each against
   the plain version on the card (fp32 3e-5, bf16 3e-2), the linear
   chain's gradient (1 K2 launch, the reversed chain) and the conv
   chain's (6 K2 launches and K3's) at 1e-4·max|leaf|; (e)
   ``["2d121pt"] × 3``, whose 33 column steps no K1 launch holds, as its
   segments (2 K1 launches: a 2-stage chain, then one stage, the
   intermediate in fp32) and as one K2 launch, each against the fused
   plain version; K1's, K2's and K3's counters, zeroed before (a), equal
   the calls' launches; (f) the times of (d) and (e) as in (c), K2's
   bound with the operations counted once at TF32's 495 TFLOP/s (the fp32
   bound beside) and K1's fused chain of the same case beside. The build
   line's K1 instantiations include the chains' (``PIPELINE_CHAINS``, the
   2-stage 2d121pt segment).
15. large filters at 8192² fp32 (the paper's grid): (a) ``ops.conv2d``
   'same' with 33×33, 64×64, 51×5, 5×51, 1×127 and 127×1 filters on
   ``strategy="lanes"`` (one K1 launch, the footprint walked in bands) and
   ``"mxu"`` (one K2 launch, its B tiles streamed where they pass 1024
   taps), a bf16 33×33 on both, a 33×33 box stencil at t = 2 on both
   (K2 streaming its tiles through both applications), and the 33×33 on
   K2 with one inf
   and one nan in x (its non-finite outputs exactly the plain version's);
   (b) a learned 33×33 filter step, forward, dx and dW (K1, K1, K3; then
   K2, K2, K3); (c) SLaK's depthwise 51×5 and 5×51 with a bias at
   ConvNeXt-T's first stage (64, 96, 56, 56): one K1 launch forward over
   the B·C images, backward 2 K1 launches and K3's; (d) the NCHW
   backward of a 9×9 'same' on (8, 64, 128, 128) → 64 and of AlexNet's
   conv1, 11×11 at stride 4 'valid' on (64, 3, 227, 227) → 96: forward
   and dx on K1's reduce path, dW on K3's channel kernel. Each against
   its plain version on the card (fp32 3e-5; K3, the reduce path and the
   depthwise gradients 1e-4; bf16 3e-2), the counters (zeroed before the
   phase) equal to the launches the calls must make, and each timed
   (``device_ms`` and ``call_ms``, 3 calls) beside its bound (bytes over
   3.35 TB/s or fp32 operations over 67 TFLOP/s; K2 and K3's channel path
   the operations once at 495 TFLOP/s of TF32, the fp32 bound beside), the
   plain version (the one timed call the check made) and cuDNN with TF32
   off and on (``F.conv2d(padding=)``, ``conv2d_input``,
   ``conv2d_weight``, ``groups=96`` and its autograd for the depthwise;
   an even filter ``F.pad`` first, outside the timing), each cuDNN call
   first timed on a crop and not made where that predicts more than
   ``LARGE_LIB_MAX_MS`` (its prediction recorded). The build line's K1
   instantiations include the banded ones (key suffix ``x1``) and K2's
   the four streamed ones (``…x0x0x1``).

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
BF16_FLOPS = 989e12             # dense bf16 on the tensor cores
MXU_RTOL = 3e-5                 # K2 single-channel against plain, fp32
MXU_VS_LANES = 1e-4             # K2 against K1: the reference's own tolerance
GRID_2D, GRID_3D = 8192, 512    # phase 9's grids: 8192², 512³
LOSS_RTOL = 1e-5                # first-step loss, mxu against lanes
SOFT_SCALE = 0.3                # weight matrices' scale of the softer point
PERTURB_REL = 1e-7              # relative parameter change of the spread probe
TIME_REPS = 10                  # timed calls of phases 5 and 9 (others: 20)
SURFACE_REPS = 5                # timed calls of phase 11
# phase 11's strided 5x5 cases at 8192² (the first also batched)
SURFACE_STRIDES = (("same", (2, 2)), ("same", (1, 2)), ("valid", (3, 3)))
HYMBA_PARAMS = 1_611_062_400    # hymba-1.5b
HYMBA_STEPS = 6
HYMBA_BATCH, HYMBA_SEQ = 2, 2048
HYMBA_DI, HYMBA_K, HYMBA_N = 3200, 4, 16   # d_inner, conv taps, ssm_state
HYMBA_CHUNK = 128               # selective-scan chunk: rows x 128 per K5 call
PERLANE_RTOL = 3e-5             # K1 per-lane against plain, fp32
K4_RTOL = 1e-4                  # K4 against plain: sums of 4096 products
LAYER_RTOL = 1e-4               # a layer's gradients, kernels against plain
MXU_PL_RTOL = 3e-5              # K2 per-lane against plain, fp32
RWKV6_STEPS = 6
RWKV6_BATCH, RWKV6_SEQ = 2, 2048
# K1's reduce path on small edge cases (x, w, mode, stride, epilogue, dtype):
# tests/test_torch_cuda.py's REDUCE_CASES and bf16 rows of 1500
REDUCE_EDGE_CASES = [
    ((2, 5, 3, 300), (37, 5, 3, 3), "same", (1, 1), None, "float32"),
    ((2, 5, 3, 300), (37, 5, 3, 3), "valid", (1, 2), ("bias", "gelu"),
     "float32"),
    ((3, 19, 1, 257), (40, 19, 1, 3), "same", (1, 2), ("bias", "gelu"),
     "float32"),
    ((1, 33, 6, 70), (8, 33, 2, 5), "same", (2, 2), ("relu", ("scale", 2.0)),
     "float32"),
    ((2, 4, 5, 129), (3, 4, 4, 1), "valid", (2, 1), ("bias", "silu"),
     "float32"),
    ((2, 7, 2, 17), (4, 7, 1, 3), "same", (1, 1), None, "float32"),
    ((1, 64, 1, 1000), (130, 64, 1, 3), "same", (1, 2), ("bias", "gelu"),
     "float32"),
    ((2, 9, 3, 257), (129, 9, 3, 3), "valid", (1, 3), ("relu",), "float32"),
    ((1, 20, 4, 500), (16, 20, 2, 5), "same", (3, 3), None, "float32"),
    ((2, 24, 1, 1500), (40, 24, 1, 3), "same", (1, 1), ("bias", "gelu"),
     "bfloat16"),
    ((2, 24, 1, 3000), (40, 24, 1, 3), "same", (1, 2), None, "bfloat16"),
]
# K2's channel path on the same edge cases, C_out 200 on 23 rows (a second
# channel tile 72 wide) and a 9x9 filter at stride 3 whose forward stages x
# a k-block at a time (tests/test_torch_cuda.py)
# K3's single-channel path in phase 8, 'same' mode: (tag, x shape,
# filter, dtype); the first is the row of the kernel table
WGRAD_ROWS_CASES = [
    ("5x5 'same' 8192x8192 fp32", (8192, 8192), (5, 5), "float32"),
    ("3x3 'same' 8192x8192 fp32", (8192, 8192), (3, 3), "float32"),
    ("9x9 'same' 8192x8192 fp32", (8192, 8192), (9, 9), "float32"),
    ("20x20 'same' 8192x8192 fp32", (8192, 8192), (20, 20), "float32"),
    ("5x5 'same' batched (16,2048,2048) fp32", (16, 2048, 2048), (5, 5),
     "float32"),
    ("5x5 'same' 8192x8192 bf16 in", (8192, 8192), (5, 5), "bfloat16"),
    ("32x32 'same' 8192x8192 fp32, two tiles", (8192, 8192), (32, 32),
     "float32"),
]
WGRAD_ROWS_HEADLINE = "K3 single-channel " + WGRAD_ROWS_CASES[0][0]
PIPELINE_CHAINS = (("2d5pt", "2d9pt", "2d5pt"), ("3d7pt", "3d27pt"))
PIPELINE_SIDE, PIPELINE_SIDE3 = 8192, 512   # phase 14's 2-D and 3-D sides
COPY_BYTES = 1 << 30            # the bandwidth probe's copy: 1 GiB each way
STEP_SHAPE = (8192, 8192)       # the op path's field (phase 8 (g))
# phase 15: filters of any size
LARGE_SIDE = 8192
LARGE_FILTERS = ((33, 33), (64, 64), (51, 5), (5, 51), (1, 127), (127, 1))
LARGE_DEPTHWISE = (64, 96, 56, 56)      # ConvNeXt-T's first stage
LARGE_NCHW = (
    ("NCHW 9x9 'same' (8, 64, 128, 128) -> 64", (8, 64, 128, 128),
     (64, 64, 9, 9), "same", None),
    ("NCHW AlexNet conv1 11x11 stride 4 'valid' (64, 3, 227, 227) -> 96",
     (64, 3, 227, 227), (96, 3, 11, 11), "valid", (4, 4)))
LARGE_REPS = 3                  # timed calls of phase 15
LARGE_LIB_MAX_MS = 3000.0       # cuDNN calls predicted longer are not made
MXU_EDGE_CASES = REDUCE_EDGE_CASES + [
    ((1, 16, 23, 300), (200, 16, 1, 3), "same", (1, 1), ("bias", "gelu"),
     "float32"),
    ((1, 2, 12, 40), (3, 2, 9, 9), "same", (3, 3), None, "float32"),
]


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


_SASS = {}


def ptxas_entries(log: str, pattern: str) -> dict:
    """Registers and spill stores of each kernel entry whose mangled name
    matches ``pattern`` (its groups joined by 'x' name the entry)."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        m = re.match(pattern, block.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs:
            out["x".join(m.groups())] = {
                "registers": int(regs.group(1)),
                "spill_store_bytes": int(spill.group(1)) if spill else 0}
    return out


def sass_counts(lib_path: str, kernel: str, opcodes) -> dict | None:
    """How often each SASS opcode occurs in the functions of the built
    library whose name holds ``kernel`` (``cuobjdump -sass``, run once per
    library); None where the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    if lib_path not in _SASS:
        _SASS[lib_path] = subprocess.run(
            [tool, "-sass", lib_path], capture_output=True,
            text=True).stdout.split("Function : ")[1:]
    funcs = [f for f in _SASS[lib_path] if kernel in f.split("\n", 1)[0]]
    return {"functions": len(funcs),
            **{op: sum(len(re.findall(rf"\b{op}\b", f)) for f in funcs)
               for op in opcodes}}


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


def moved_bytes(*tensors) -> int:
    """Bytes of the distinct tensors among ``tensors``, each counted once:
    a residual that is the input itself is read once."""
    seen, total = set(), 0
    for t in tensors:
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


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
    ends = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    span = (max(b for _, b in ends) - min(a for a, _ in ends)) / 1e3 \
        if ends else None
    out = {"device_ms": total, "span_ms": span,
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
    the cotangents of both convolutions (conv2's at its strided width)."""
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

    from repro_torch.core import adjoint, engine
    from repro_torch.core.plan import normalize_epilogue
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
    lin2s = nchw(c["x2"], c["w2"], (1, 2))       # conv2's linear plan
    adj2 = adjoint.input_adjoint_plan(lin2)
    wa2 = adjoint.adjoint_coeff_array(lin2, c["w2"])
    phased = engine.run_adjoint_phases
    phased_ref = engine.run_adjoint_phases_reference
    g2d = torch.zeros_like(c["g1"])
    g2d[..., ::2] = c["g2"]                      # the scattered cotangent
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
        # the real products only: 8 x 1500 cotangent positions x 3 taps
        ("K1 conv2 dx, phases of the strided adjoint (8,512,1,1500) -> "
         "(8,512,1,3000)",
         lambda: phased(c["g2"], wa2, plan=lin2s, in_spatial=(1, T)),
         lambda: phased_ref(c["g2"], wa2, plan=lin2s, in_spatial=(1, T)),
         F32, 2 * D * D * 3 * B * (T // 2),
         4 * (B * D * T // 2 + D * D * 3 + B * D * T),
         lambda: torch.nn.grad.conv2d_input(
             c["x2"].shape, c["w2"], c["g2"], stride=(1, 2), padding=(0, 1)),
         K1),
        # the formulation before: the stride-free adjoint on the cotangent
        # scattered onto the dense lattice, half its products with zeros;
        # its bound counts what the function needs, as the phases' does
        ("K1 conv2 dx, scattered cotangent, adjoint plan (8,512,1,3000)",
         lambda: run(g2d, wa2, plan=adj2), lambda: ref(g2d, wa2, plan=adj2),
         F32, 2 * D * D * 3 * B * (T // 2),
         4 * (B * D * T // 2 + D * D * 3 + B * D * T),
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
        # the real positions only: 8 x 1500 per dW element
        ("K3 conv2 dW on the strided cotangent (8,512,1,3000) x "
         "(8,512,1,1500) -> (512,512,1,3)",
         lambda: wrun(c["x2"], c["g2"], plan=lin2s),
         lambda: wref(c["x2"], c["g2"], plan=lin2s),
         F32, 2 * D * D * 3 * B * (T // 2),
         4 * (B * D * T + B * D * T // 2 + D * D * 3),
         lambda: torch.nn.grad.conv2d_weight(
             c["x2"], c["w2"].shape, c["g2"], stride=(1, 2), padding=(0, 1)),
         K3),
        # the stride-free plan on the scattered cotangent: the same dW
        ("K3 conv2 dW, the scattered cotangent (8,512,1,3000) -> "
         "(512,512,1,3)",
         lambda: wrun(c["x2"], g2d, plan=lin2),
         lambda: wref(c["x2"], g2d, plan=lin2),
         F32, 2 * D * D * 3 * B * T, 4 * (2 * B * D * T + D * D * 3),
         lambda: torch.nn.grad.conv2d_weight(
             c["x2"], c["w2"].shape, c["g2"], stride=(1, 2), padding=(0, 1)),
         K3),
        ("K1 conv2 forward bf16 I/O",
         lambda: run(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         lambda: ref(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         3e-2, 2 * D * D * 3 * B * (T // 2),
         2 * (B * D * T + B * D * T // 2) + 4 * (D * D * 3 + D), None, K1),
    ]
    # K3's launches per train step: the stem's two dW calls at these shapes
    k3_step = (K3.launches_for(c["mel"], c["g1"], plan=p1)
               + K3.launches_for(c["x2"], c["g2"], plan=lin2s))
    # -- (a) each kernel against its plain version at the stem's shapes ----
    worst = {"K1": 0.0, "K3": 0.0}
    for tag, kern, plain, rtol, *_ in cases:
        got, want = kern(), plain()
        err = compare(tag, got, want, rtol, results)
        if rtol == F32:
            worst[tag[:2]] = max(worst[tag[:2]], err)
        if tag.startswith(("K3", "K1 conv2")):
            # no atomics: a second call gives the same bits
            require(torch.equal(got, kern()), (tag, "not deterministic"))
        if tag.startswith("K1 conv2 dx, phases"):
            dx_phases = got
        if tag.startswith("K1 conv2 dx, scattered"):
            compare("K1 conv2 dx: phases against the scattered cotangent",
                    dx_phases, got, F32, results)
            del dx_phases
        del got, want
    # K1's reduce path on the edge cases: forward, and the phased dx of the
    # linear plan (one launch) against its plain version
    for xs, ws, mode, stride, epi_e, dt in REDUCE_EDGE_CASES:
        gen = np.random.default_rng(args.seed + 5)
        dtype = getattr(torch, dt)
        xe = torch.as_tensor(gen.standard_normal(xs, np.float32),
                             device=dev).to(dtype)
        we = torch.as_tensor(gen.standard_normal(ws, np.float32), device=dev)
        be = torch.as_tensor(gen.standard_normal(ws[:1], np.float32),
                             device=dev)
        pe = dataclasses.replace(
            ssam_conv2d.plan_for_nchw(xs, ws, mode),
            stride=None if stride == (1, 1) else stride,
            epilogue=normalize_epilogue(epi_e))
        eargs = (be,) if epi_e and "bias" in epi_e else ()
        tol = F32 if dt == "float32" else 3e-2
        tag = f"K1 edge {xs} x {ws} {mode} stride {stride} {epi_e} {dt}"
        compare(tag + " forward", run(xe, we, plan=pe, epilogue_args=eargs),
                ref(xe, we, plan=pe, epilogue_args=eargs), tol, results)
        le = dataclasses.replace(pe, epilogue=())
        ge = torch.as_tensor(gen.standard_normal(
            (xs[0], ws[0]) + le.out_shape(xs[2:]), np.float32),
            device=dev).to(dtype)
        wae = adjoint.adjoint_coeff_array(le, we)
        compare(tag + " phased dx",
                phased(ge, wae, plan=le, in_spatial=xs[2:]),
                phased_ref(ge, wae, plan=le, in_spatial=xs[2:]), tol,
                results)
    xb, gb = c["x2"].bfloat16(), c["g2"].bfloat16()
    compare("K3 conv2 dW on the strided cotangent, bf16 in",
            wrun(xb, gb, plan=lin2s), wref(xb, gb, plan=lin2s), 3e-2,
            results)
    del xb, gb
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
    for tag, kern, plain, _, flops, nbytes, lib, kernel in cases:
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        if "bf16" in tag:
            continue
        ms = device_ms(kern, 20)
        rec = {"case": tag, "ms": ms, "call_ms": event_ms(kern, 20),
               "plain_ms": device_ms(plain, 3),
               "library_ms": device_ms(lib, 20),
               "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "gflop": flops / 1e9, "bytes": nbytes,
               "roofline_share": max(b_ms, f_ms) / ms, "card": card}
        if kernel is K3:
            # K3's channel path runs on the tensor cores: its bound as K2's,
            # the operations counted once at the TF32 rate, the fp32 bound
            # beside it; cuDNN also with TF32 on (less precise)
            tc_ms = flops / TF32_FLOPS * 1e3
            rec.update({
                "bound_ms": max(b_ms, tc_ms),
                "bound_by": "bytes" if b_ms >= tc_ms else "operations",
                "fp32_bound_ms": max(b_ms, f_ms),
                "fp32_bound_by": "bytes" if b_ms >= f_ms else "operations",
                "roofline_share": max(b_ms, tc_ms) / ms,
                "library_tf32_ms": device_ms(cudnn_tf32(lib), 20)})
        results["times"].append(rec)
        emit({"phase": "train_time", **rec})
    # The pass K3's wrapper would make to split conv2's x into 2 column
    # phases; it reads x in place instead (a wider, 16-byte aligned box).
    nbytes = 2 * 4 * B * D * T
    ms = device_ms(
        lambda: engine._tma_operand(engine.phase_split(c["x2"], 2)), 20)
    rec = {"case": "x of conv2 split in 2 column phases (not on the path)",
           "ms": ms, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "card": card}
    results["times"].append(rec)
    emit({"phase": "train_time", **rec})
    # One profiled step, in a fresh process: after phase 7 this process's
    # traces lose some of K1's launches (PERF.md §7); a fresh process's
    # host-and-device trace has held all of them in every run so far.
    rec = {**profiled_train_step(args.seed), "card": card}
    results["train_profile"] = rec
    emit({"phase": "train_profile", **rec})
    # every K1 launch (2 forwards, 2 recomputed pre-activations, the phased
    # dx) is a kernel whose name holds "window_reduce_kernel", every K3
    # launch (partial sums, the pass that adds them) one with "wgrad"; the
    # device-only trace is recorded beside (it has dropped the stem's
    # forwards in some runs, PERF.md §7)
    require(rec["k1_calls"] == rec["k1_launches"] == 5,
            ("profiled K1 kernels against the counter", rec["k1_calls"],
             rec["k1_launches"]))
    for trace in (rec, rec["device_only"]):
        require(trace["k3_calls"] == trace["k3_launches"] == k3_step,
                ("profiled K3 kernels against the counter",
                 trace["k3_calls"], trace["k3_launches"], k3_step))
    rows = wgrad_rows_phase(args, dev, card, results)
    return {"k1_launches": k1, "k3_launches": k3, "k3_step": k3_step,
            "k3_rows": rows,
            "worst": worst, "first_loss": res.losses[0], "step_ms": step_ms,
            "k3_headline": next(r for r in results["times"]
                                if r["case"].startswith("K3 conv2 dW on")),
            "k3_conv1": next(r for r in results["times"]
                             if r["case"].startswith("K3 conv1 dW")),
            "k1_headline": next(r for r in results["times"]
                                if r["case"].startswith(
                                    "K1 conv2 dx, phases"))}


def copy_bandwidth(card) -> dict:
    """The card's sustainable bandwidth: a 1 GiB device-to-device
    ``copy_`` (1 GiB read, 1 GiB written) timed with CUDA events."""
    import torch

    src = torch.empty(COPY_BYTES // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    src.fill_(1.0)
    ms = event_ms(lambda: dst.copy_(src), 20)
    rec = {"bytes": 2 * COPY_BYTES, "ms": ms,
           "gb_per_s": 2 * COPY_BYTES / (ms * 1e-3) / 1e9,
           "published_gb_per_s": HBM_BYTES_PER_S / 1e9, "card": card}
    del src, dst
    return rec


def wgrad_rows_phase(args, dev, card, results) -> dict:
    """Phase 8 (e)-(g): K3's single-channel path. Each case of
    ``WGRAD_ROWS_CASES`` against the plain version (fp32 rtol 1e-4, atol
    1e-4·max|plain|: sums of 67M products in another order; bf16 3e-2),
    twice for equal bits, K3's counter at ``launches_for``, then timed
    beside its bound, the plain version, the earlier kernel in turns where
    the probe offers it (``run_wgrad``) and, on 5×5 fp32 only (seconds a
    call), ``torch.nn.grad.conv2d_weight``; the card's copy bandwidth;
    and the op path: one training step of a learned 5×5 filter on an
    8192² field through ``ops.conv2d`` and ``backward()``."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import ops, ssam_conv2d

    K1, K3 = engine.WINDOW_KERNEL, engine.WGRAD_KERNEL
    wrun = engine.run_weight_grad_plan
    wref = engine.run_weight_grad_plan_reference
    probe = parent_probe()
    has_parent = probe is not None and hasattr(probe, "run_wgrad")
    rng = np.random.default_rng(args.seed + 4)
    rows, worst = {}, 0.0
    for tag, xs, filt, dt in WGRAD_ROWS_CASES:
        plan = (ssam_conv2d.plan_for_batched if len(xs) == 3
                else ssam_conv2d.plan_for)(filt, "same")
        x = torch.as_tensor(rng.standard_normal(xs, np.float32),
                            device=dev).to(getattr(torch, dt))
        g = torch.as_tensor(rng.standard_normal(xs, np.float32),
                            device=dev).to(x.dtype)
        tag = f"K3 single-channel {tag}"
        K3.launches = 0
        got = wrun(x, g, plan=plan)
        torch.cuda.synchronize()
        want_launches = K3.launches_for(x, g, plan=plan)
        require(K3.launches == want_launches,
                (tag, "launches", K3.launches, want_launches))
        rtol = STEM_RTOL if dt == "float32" else 3e-2
        err = compare(tag, got, wref(x, g, plan=plan), rtol, results)
        worst = max(worst, err) if dt == "float32" else worst
        require(torch.equal(got, wrun(x, g, plan=plan)),
                (tag, "not deterministic"))
        kern = (lambda: wrun(x, g, plan=plan))
        N, M = filt
        elems = x.numel()
        nbytes = x.element_size() * 2 * elems + 4 * N * M
        flops = 2 * N * M * elems
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        rec = {"case": tag, "launches": want_launches, "max_abs_err": err,
               "parent_ms": None, "parent_call_ms": None}
        if has_parent:          # in turns: kernel, parent, parent, kernel
            parent = (lambda: probe.run_wgrad(x, g, plan))
            compare(tag + " earlier kernel", parent(), got, rtol, results)
            k0 = device_ms(kern, 10)
            p0, p1 = device_ms(parent, 5), device_ms(parent, 5)
            ms = (k0 + device_ms(kern, 10)) / 2
            rec["parent_ms"] = (p0 + p1) / 2
            rec["parent_call_ms"] = event_ms(parent, 5)
        else:
            ms = device_ms(kern, 20)
        lib = None
        if filt == (5, 5) and len(xs) == 2 and dt == "float32":
            lib = device_ms(lambda: torch.nn.grad.conv2d_weight(
                x[None, None], (1, 1, N, M), g[None, None],
                padding=(N // 2, M // 2)), 3)
        rec.update({
            "ms": ms, "call_ms": event_ms(kern, 20),
            "plain_ms": device_ms(lambda: wref(x, g, plan=plan), 3),
            "library_ms": lib, "bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations",
            "bytes": nbytes, "gflop": flops / 1e9,
            "roofline_share": max(b_ms, f_ms) / ms, "card": card})
        results["times"].append(rec)
        emit({"phase": "train_time", **rec})
        rows[tag] = rec
        del x, g, got
        torch.cuda.empty_cache()

    # -- (f) the card's sustainable bandwidth --------------------------------
    rec = copy_bandwidth(card)
    results["copy_bandwidth"] = rec
    emit({"phase": "copy_bandwidth", **rec})

    # -- (g) the op path: one step of a learned 5x5 filter -----------------
    x = torch.as_tensor(rng.standard_normal(STEP_SHAPE, np.float32),
                        device=dev)
    target = torch.as_tensor(rng.standard_normal(STEP_SHAPE, np.float32),
                             device=dev)
    w0 = torch.as_tensor(rng.standard_normal((5, 5), np.float32) / 5,
                         device=dev)
    plan = ssam_conv2d.plan_for((5, 5), "same")
    w = w0.clone().requires_grad_()

    def step():
        w.grad = None
        ((ops.conv2d(x, w, mode="same") - target) ** 2).sum().backward()

    torch.cuda.synchronize()
    K1.launches = K3.launches = 0
    step()
    torch.cuda.synchronize()
    k1, k3 = K1.launches, K3.launches
    k3_want = K3.launches_for(x, x, plan=plan)
    require(k1 == 1 and k3 == k3_want,
            ("op-path step launches (K1 1, K3 launches_for)", k1, k3,
             k3_want))
    wp = w0.clone().requires_grad_()
    ((engine.run_window_plan_reference(x, wp, plan=plan) - target)
     ** 2).sum().backward()
    err = compare("K3 single-channel op path: w.grad against autograd "
                  "through the plain versions", w.grad, wp.grad, STEM_RTOL,
                  results)
    step_ms = device_ms(step, 5)
    k3_ms = rows[WGRAD_ROWS_HEADLINE]["ms"]
    rec = {"k1_launches": k1, "k3_launches": k3, "max_abs_err": err,
           "step_ms": step_ms, "step_call_ms": event_ms(step, 5),
           "k3_ms": k3_ms, "k3_share": k3_ms / step_ms, "card": card}
    results["wgrad_rows_step"] = rec
    emit({"phase": "train_wgrad_rows_step", **rec})
    del x, target, wp
    torch.cuda.empty_cache()
    return {"rows": rows, "worst": worst, "step": rec,
            "headline": rows[WGRAD_ROWS_HEADLINE]}


def profile_step_main(seed: int, strategy: str) -> int:
    """``--profile-train-step``: one whisper-base train step (the shapes of
    phase 8's main path, or with ``--profile-strategy mxu`` phase 9's: the
    stem pinned to K2) after a warm-up step, traced twice, host and device
    activity, then the device only; prints one JSON line."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.core import engine
    from repro_torch.data import TokenDataset
    from repro_torch.launch import train
    from repro_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    K1, K2, K3 = engine.WINDOW_KERNEL, engine.MXU_KERNEL, engine.WGRAD_KERNEL
    dev = torch.device("cuda", 0)
    if strategy == "mxu":
        cfg = dataclasses.replace(get_config("whisper-base"),
                                  conv_frontend=True, n_mels=N_MELS,
                                  conv_strategy="mxu", dtype="float32")
        model = build_model(cfg, device=dev, seed=seed)
        trainer = train.Trainer(model, lr=3e-4,
                                warmup=max(TRAIN_STEPS // 10, 10),
                                total=max(TRAIN_STEPS, 100))
        ds = TokenDataset(cfg.vocab, TRAIN_SEQ, seed=seed)
        trainer.step(train.make_batch(model, ds, 0, TRAIN_BATCH, dev))
    else:
        res = train.main(["--arch", "whisper-base", "--conv-frontend",
                          "--steps", "1", "--batch", str(TRAIN_BATCH),
                          "--seq", str(TRAIN_SEQ), "--seed", str(seed),
                          "--log-every", "1000"])
        trainer, model = res.trainer, res.trainer.model
        ds = TokenDataset(model.cfg.vocab, TRAIN_SEQ, seed=seed)
    batch = train.make_batch(model, ds, TRAIN_STEPS, TRAIN_BATCH, dev)
    trainer.step(batch)
    torch.cuda.synchronize()

    def traced(activities):
        before = K1.launches, K2.launches, K3.launches
        with profile(activities=activities) as prof:
            loss, _ = trainer.step(batch)
            float(loss)
            torch.cuda.synchronize()
        return {**device_ops(prof, match={"k1": "window_reduce_kernel",
                                          "k2": "mxu_tc_kernel",
                                          "k3": "wgrad"}),
                "k1_launches": K1.launches - before[0],
                "k2_launches": K2.launches - before[1],
                "k3_launches": K3.launches - before[2]}

    out = traced([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    out["device_only"] = traced([ProfilerActivity.CUDA])
    out["strategy"] = strategy
    out["stem_share"] = ((out["k1_ms"] + out["k2_ms"] + out["k3_ms"])
                         / out["device_ms"] if out["device_ms"] else None)
    print(json.dumps(out), flush=True)
    return 0


def profiled_train_step(seed: int, strategy: str = "lanes") -> dict:
    """Run :func:`profile_step_main` in a fresh process; its JSON line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--profile-train-step", "--profile-strategy", strategy, "--seed",
         str(seed)], capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            ("profiled train step", strategy, proc.stdout[-2000:],
             proc.stderr[-4000:]))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def mxu_phase(args, dev, card, results, lanes, single) -> dict:
    """Phase 9: K2, the tensor-core kernel, on the stencil and convolution
    path and the Whisper stem, then whisper-base trained with the stem
    pinned to it. ``lanes`` is phase 8's result (its first loss),
    ``single`` phase 5's timed rows by case (K1, plain and cuDNN beside
    K2's single-channel times)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

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

    def plain_block(p, t):
        # the plain version's tiles as phase 2 cuts them (its result does
        # not depend on them; K2's small 3-D tiles at t = 2 would make it
        # stack 8 taps' views of ~4x the grid)
        return engine.default_block(dataclasses.replace(p, strategy=None), t)

    worst = {"abs": 0.0, "stem": 0.0, "edge": 0.0}

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
            p = stencil_plan(sd)
            check(f"{name} t={t}", y, ref(x, plan=p, time_steps=t,
                                          block=plain_block(p, t)),
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
    lin2s = nchw(c["x2"], c["w2"], (1, 2))       # conv2's linear plan
    lanes2s = dataclasses.replace(lin2s, strategy="lanes")
    adj2 = adjoint.input_adjoint_plan(lin2)
    require(adj2.strategy == "mxu", "the adjoint plan keeps strategy='mxu'")
    wa2 = adjoint.adjoint_coeff_array(lin2, c["w2"])
    g2d = torch.zeros_like(c["g1"])
    g2d[..., ::2] = c["g2"]
    run = engine.run_window_plan
    phased = engine.run_adjoint_phases
    phased_ref = engine.run_adjoint_phases_reference
    B, T, D = TRAIN_BATCH, 2 * N_FRAMES, D_MODEL
    dx_lib = (lambda: torch.nn.grad.conv2d_input(
        c["x2"].shape, c["w2"], c["g2"], stride=(1, 2), padding=(0, 1)))
    # (tag, K2 call, K1 call, plain call, rtol, operations, bytes, library
    #  call); conv2's dx counts the real products only, 8 x 1500 cotangent
    # positions x 3 taps, also on the scattered cotangent
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
        ("conv2 dx, phases of the strided adjoint (8,512,1,1500) -> "
         "(8,512,1,3000)",
         lambda: phased(c["g2"], wa2, plan=lin2s, in_spatial=(1, T)),
         lambda: phased(c["g2"], wa2, plan=lanes2s, in_spatial=(1, T)),
         lambda: phased_ref(c["g2"], wa2, plan=lin2s, in_spatial=(1, T)),
         STEM_RTOL, 2 * D * D * 3 * B * (T // 2),
         4 * (B * D * T // 2 + D * D * 3 + B * D * T), dx_lib),
        # the formulation before: the stride-free adjoint on the cotangent
        # scattered onto the dense lattice, half its products with zeros
        ("conv2 dx, scattered cotangent, adjoint plan (8,512,1,3000)",
         lambda: run(g2d, wa2, plan=adj2),
         lambda: run(g2d, wa2, plan=adj2, strategy="lanes"),
         lambda: ref(g2d, wa2, plan=adj2), STEM_RTOL,
         2 * D * D * 3 * B * (T // 2),
         4 * (B * D * T // 2 + D * D * 3 + B * D * T), dx_lib),
    ]
    for tag, kern, lanes_fn, plain, rtol, *_ in stem:
        got = kern()
        check(tag, got, plain(), lanes_fn(), rtol, "stem")
        # no atomics: a second call gives the same bits
        require(torch.equal(got, kern()), (f"K2 {tag}", "not deterministic"))
        calls += 2
        if tag.startswith("conv2 dx, phases"):
            dx_phases = got
        if tag.startswith("conv2 dx, scattered"):
            compare("K2 conv2 dx: phases against the scattered cotangent",
                    dx_phases, got, STEM_RTOL, results)
            del dx_phases
        del got
    x2_bf16, g2_bf16 = c["x2"].to(torch.bfloat16), c["g2"].to(torch.bfloat16)
    y = run(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],))
    calls += 1
    check("conv2 forward bf16 I/O", y,
          ref(x2_bf16, c["w2"], plan=p2, epilogue_args=(c["b2"],)), None, 3e-2)
    y = phased(g2_bf16, wa2, plan=lin2s, in_spatial=(1, T))
    calls += 1
    check("conv2 dx, phases, bf16 I/O", y,
          phased_ref(g2_bf16, wa2, plan=lin2s, in_spatial=(1, T)), None, 3e-2)
    del y, x2_bf16, g2_bf16
    torch.cuda.empty_cache()
    # K2's channel path on the edge cases: forward and the phased dx of the
    # linear plan (one launch), against the plain mxu version and K1
    for xs, ws, mode, stride, epi_e, dt in MXU_EDGE_CASES:
        gen = np.random.default_rng(args.seed + 6)
        dtype = getattr(torch, dt)
        xe = torch.as_tensor(gen.standard_normal(xs, np.float32),
                             device=dev).to(dtype)
        we = torch.as_tensor(gen.standard_normal(ws, np.float32), device=dev)
        be = torch.as_tensor(gen.standard_normal(ws[:1], np.float32),
                             device=dev)
        pe = mxu(dataclasses.replace(
            ssam_conv2d.plan_for_nchw(xs, ws, mode),
            stride=None if stride == (1, 1) else stride,
            epilogue=normalize_epilogue(epi_e)))
        eargs = (be,) if epi_e and "bias" in epi_e else ()
        f32 = dt == "float32"
        tag = f"edge {xs} x {ws} {mode} stride {stride} {epi_e} {dt}"
        y = run(xe, we, plan=pe, epilogue_args=eargs)
        calls += 1
        check(tag + " forward", y, ref(xe, we, plan=pe, epilogue_args=eargs),
              run(xe, we, plan=pe, epilogue_args=eargs, strategy="lanes")
              if f32 else None, STEM_RTOL if f32 else 3e-2, "edge")
        le = dataclasses.replace(pe, epilogue=())
        ge = torch.as_tensor(gen.standard_normal(
            (xs[0], ws[0]) + le.out_shape(xs[2:]), np.float32),
            device=dev).to(dtype)
        wae = adjoint.adjoint_coeff_array(le, we)
        y = phased(ge, wae, plan=le, in_spatial=xs[2:])
        calls += 1
        check(tag + " phased dx", y,
              phased_ref(ge, wae, plan=le, in_spatial=xs[2:]),
              phased(ge, wae, plan=dataclasses.replace(le, strategy="lanes"),
                     in_spatial=xs[2:]) if f32 else None,
              STEM_RTOL if f32 else 3e-2, "edge")
        del y
    torch.cuda.synchronize()

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
    def record(tag, kern, lanes_fn, plain, flops, nbytes, lib,
               tc_flops=TF32_FLOPS):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        tc_ms = flops / tc_flops * 1e3
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
    # conv2 with x and the cotangent in bf16 (the filter fp32: K2 runs its
    # TF32 path with two products, K1 its fp32 sums), bound at the bf16
    # tensor-core rate; cuDNN on bf16 x, filter and bias
    xb, gb = c["x2"].to(torch.bfloat16), c["g2"].to(torch.bfloat16)
    w2b, b2b = c["w2"].to(torch.bfloat16), c["b2"].to(torch.bfloat16)
    conv2_flops = 2 * D * D * 3 * B * (T // 2)
    bf16_stem = [
        ("conv2 bf16 forward stride (1,2) (8,512,1,3000)->(8,512,1,1500) "
         "bias+gelu",
         lambda: run(xb, c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         lambda: run(xb, c["w2"], plan=p2, epilogue_args=(c["b2"],),
                     strategy="lanes"),
         lambda: ref(xb, c["w2"], plan=p2, epilogue_args=(c["b2"],)),
         2 * (B * D * T + B * D * T // 2) + 4 * (D * D * 3 + D),
         lambda: F.gelu(F.conv2d(xb, w2b, b2b, stride=(1, 2),
                                 padding=(0, 1)), approximate="tanh")),
        ("conv2 bf16 dx, phases of the strided adjoint (8,512,1,1500) -> "
         "(8,512,1,3000)",
         lambda: phased(gb, wa2, plan=lin2s, in_spatial=(1, T)),
         lambda: phased(gb, wa2, plan=lanes2s, in_spatial=(1, T)),
         lambda: phased_ref(gb, wa2, plan=lin2s, in_spatial=(1, T)),
         2 * (B * D * T // 2 + B * D * T) + 4 * D * D * 3,
         lambda: torch.nn.grad.conv2d_input(xb.shape, w2b, gb, stride=(1, 2),
                                            padding=(0, 1))),
    ]
    for tag, kern, lanes_fn, plain, nbytes, lib in bf16_stem:
        timed[tag[:14]] = record(f"K2 {tag}", kern, lanes_fn, plain,
                                 conv2_flops, nbytes, lib, BF16_FLOPS)
    del xb, gb, w2b, b2b, bf16_stem
    # K2's single-channel path over the whole suite: its device and call
    # times (and the parent's K2 where the probe exists, in turns) beside
    # phase 5's K1, plain and cuDNN times of the same case and input
    probe = parent_probe()

    def record_single(tag, kern, p5, flops, nbytes, parent_fn):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        tc_ms = flops / TF32_FLOPS * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        rec = {"case": f"K2 {tag}", "parent_ms": None, "parent_call_ms": None}
        if not parent_fn:
            ms = device_ms(kern, TIME_REPS)
        else:           # in turns: kernel, parent, parent, kernel
            compare(f"K2 {tag} parent kernel", parent_fn(), kern(),
                    MXU_VS_LANES, results)
            half = TIME_REPS // 2
            k0 = device_ms(kern, half)
            p0, p1 = device_ms(parent_fn, half), device_ms(parent_fn, half)
            ms = (k0 + device_ms(kern, half)) / 2
            rec["parent_ms"] = (p0 + p1) / 2
            rec["parent_call_ms"] = event_ms(parent_fn, half)
        rec.update({
            "ms": ms, "call_ms": event_ms(kern, TIME_REPS),
            "k1_ms": p5["ms"], "k1_call_ms": p5["call_ms"],
            "plain_ms": p5["plain_ms"], "library_ms": p5["library_ms"],
            "library_pad_then_conv_ms": p5["library_pad_then_conv_ms"],
            "yardsticks_from": p5["case"],
            "bound_ms": max(b_ms, tc_ms),
            "bound_by": "bytes" if b_ms >= tc_ms else "operations",
            "fp32_bound_ms": max(b_ms, f_ms),
            "fp32_bound_by": "bytes" if b_ms >= f_ms else "operations",
            "bytes_ms": b_ms, "tensor_core_ms": tc_ms, "fp32_ms": f_ms,
            "gflop": flops / 1e9, "bytes": nbytes,
            "roofline_share": max(b_ms, tc_ms) / ms, "card": card})
        results["times"].append(rec)
        emit({"phase": "mxu_time", **rec})
        return rec

    for name, sd in stencils.BENCHMARKS.items():
        x = grids[sd.ndim]
        cells = x.numel()
        for t in (1, 2):
            timed[f"{name} t={t}"] = record_single(
                f"{name} t={t}",
                lambda: ops.stencil(x, name, time_steps=t, strategy="mxu"),
                single[f"{name} shift_psum t={t}"],
                t * (2 * len(sd.offsets) - 1) * cells, 8 * cells,
                probe and hasattr(probe, "run_mxu") and (
                    lambda: probe.run_mxu(x, None, stencil_plan(sd), t)))
    x = grids[2]
    for k, w in filters.items():
        timed[f"conv{k}"] = record_single(
            f"conv2d {k}x{k} same t=1",
            lambda: ops.conv2d(x, w, mode="same", strategy="mxu"),
            single[f"conv2d {k}x{k} same"], (2 * k * k - 1) * x.numel(),
            8 * x.numel(), probe and hasattr(probe, "run_mxu") and (
                lambda: probe.run_mxu(
                    x, w, mxu(ssam_conv2d.plan_for((k, k), "same")), 1)))
    del grids, filters, x, w
    torch.cuda.empty_cache()

    # One profiled step of the pinned stem in a fresh process, as phase 8
    # traces its own (after phase 7 this process's traces lose kernels,
    # PERF.md §7): every K2 launch (2 forwards, 2 recomputed
    # pre-activations, the phased dx) is a kernel whose name holds
    # "mxu_tc_kernel", every K3 launch one with "wgrad"
    del trainer, model
    torch.cuda.empty_cache()
    rec = {**profiled_train_step(args.seed, "mxu"), "card": card}
    results["train_mxu_profile"] = rec
    emit({"phase": "train_mxu_profile", **rec})
    require(rec["k2_calls"] == rec["k2_launches"] == 5
            and rec["k1_launches"] == 0,
            ("profiled K2 kernels against the counter", rec["k2_calls"],
             rec["k2_launches"], rec["k1_launches"]))
    for trace in (rec, rec["device_only"]):
        require(trace["k3_calls"] == trace["k3_launches"] == lanes["k3_step"],
                ("profiled K3 kernels against the counter",
                 trace["k3_calls"], trace["k3_launches"], lanes["k3_step"]))
    return {"launches": launches, "train_launches": k2, "worst": worst,
            "headline": timed["2d5pt t=1"],
            "stem_headline": timed["conv2 dx, phas"],
            "stem_rows": {"conv2_forward": timed["conv2 forward "],
                          "conv1_forward": timed["conv1 forward "],
                          "dx_scattered": timed["conv2 dx, scat"],
                          "conv2_forward_bf16": timed["conv2 bf16 for"],
                          "conv2_dx_phases_bf16": timed["conv2 bf16 dx,"]}}


class _PlainKernels:
    """Within the block the engine's wrappers of K1, K2, K4 and K5 are
    replaced by the plain versions, so the same model code runs autograd
    through them on the card (the kernels' counters stay put)."""

    def __enter__(self):
        from repro_torch.core import engine

        self.saved = (engine.WINDOW_KERNEL, engine.MXU_KERNEL,
                      engine.PERLANE_WGRAD_KERNEL, engine.SCAN_KERNEL)
        engine.WINDOW_KERNEL = engine.run_window_plan_reference
        engine.MXU_KERNEL = engine.run_window_plan_reference
        engine.PERLANE_WGRAD_KERNEL = engine.run_weight_grad_plan_reference
        engine.SCAN_KERNEL = engine.run_scan_plan_reference
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine

        (engine.WINDOW_KERNEL, engine.MXU_KERNEL,
         engine.PERLANE_WGRAD_KERNEL, engine.SCAN_KERNEL) = self.saved
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
        # the recomputed pre-activation: the forward without an epilogue
        ("K1 per-lane conv1d forward linear (2,2048,3200) K=4 fp32",
         lambda: run(x, w, plan=p), lambda: ref(x, w, plan=p), PERLANE_RTOL,
         4 * (2 * elems + K * D), 2 * K * elems,
         lambda: F.conv1d(xt, wt, padding=K - 1, groups=D)[..., :T], True),
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
    require((K1.launches, K4.launches, K5.launches) == (6, k4_want, 1),
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
    # K1's per-lane path for each epilogue chain the port launches (bias +
    # SiLU, none) and its dx, beside the parent's per-lane kernel where the
    # probe exists (in turns: kernel, parent, parent, kernel)
    probe = parent_probe()
    parents = {cases[0][0]: (x, pe, (b,)), cases[1][0]: (g, adj, ()),
               cases[2][0]: (x, p, ())}
    timed = {}
    for tag, kern, plain, _, nbytes, flops, lib, counted in cases:
        if not counted:
            continue
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        rec = {"parent_ms": None}
        if probe is not None and hasattr(probe, "run_perlane") \
                and tag in parents:
            xi, pl, ea = parents[tag]
            parent_fn = (lambda: probe.run_perlane(xi, w, pl, ea))
            compare(tag + " parent kernel", parent_fn(), kern(),
                    PERLANE_RTOL, results)
            k0 = device_ms(kern, 10)
            p0, p1 = device_ms(parent_fn, 10), device_ms(parent_fn, 10)
            ms = (k0 + device_ms(kern, 10)) / 2
            rec["parent_ms"] = (p0 + p1) / 2
        else:
            ms = device_ms(kern, 20)
        rec = {"case": tag, **rec, "ms": ms, "call_ms": event_ms(kern, 20),
               "plain_ms": device_ms(plain, 3),
               "library_ms": None if lib is None else device_ms(lib, 20),
               "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "bytes": nbytes, "roofline_share": max(b_ms, f_ms) / ms,
               "card": card}
        results["times"].append(rec)
        emit({"phase": "hymba_time", **rec})
        timed[tag[:2] + (" dx" if " dx" in tag
                         else " linear" if " linear" in tag else "")] = rec
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


def surface_phase(args, dev, card, results) -> dict:
    """Phase 11: epilogues, residuals, strides and groups on K1, K2 and K3
    at the port's full sizes, each against its plain version, its
    launches counted, its times beside its bound, the unfused sequence,
    the library call and the plain version."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import convert
    from repro_torch.core import adjoint, engine
    from repro_torch.core.plan import normalize_epilogue
    from repro_torch.kernels import ops, ssam_conv1d, ssam_conv2d
    from repro_torch.kernels import ssam_stencil2d, stencils

    K1, K2, K3 = engine.WINDOW_KERNEL, engine.MXU_KERNEL, engine.WGRAD_KERNEL
    rng = np.random.default_rng(args.seed + 11)

    def randn(*shape, scale=1.0):
        return convert.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32), dev)

    kernels = {"K1": K1, "K2": K2, "K3": K3}
    worst = {name: 0.0 for name in kernels}
    rows = {name: {} for name in kernels}
    K1.launches = K2.launches = K3.launches = 0
    expected = {name: 0 for name in kernels}

    def run(kname, launches, fn):
        """One call of ``fn`` that must launch ``kname`` ``launches``
        times."""
        before = kernels[kname].launches
        out = fn()
        torch.cuda.synchronize()
        got = kernels[kname].launches - before
        require(got == launches, (kname, "launches", got, launches))
        expected[kname] += launches
        return out

    def held(kname, tag, y, plain, rtol):
        worst[kname] = max(worst[kname], compare(
            f"phase 11 {kname} {tag}", y, plain, rtol, results))

    def time_case(kname, tag, fused, plain, bytes_, flops, *, unfused=None,
                  lib=None, lib_reps=SURFACE_REPS):
        """Device time of the kernel's call beside the bound, the plain
        version, the unfused sequence and the library call (launches made
        here are timing runs, not the main path's). K2's operations count
        once at the TF32 rate (its 3xTF32 split is the kernel's choice),
        the fp32 bound beside; K1's and K3's at the fp32 rate."""
        b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        f_ms = flops / (TF32_FLOPS if kname == "K2" else FP32_FLOPS) * 1e3
        counts = {k: v.launches for k, v in kernels.items()}
        rec = {"case": tag, "kernel": kname,
               "ms": device_ms(fused, SURFACE_REPS),
               "unfused_ms": (device_ms(unfused, SURFACE_REPS)
                              if unfused else None),
               "library_ms": event_ms(lib, lib_reps) if lib else None,
               "plain_ms": event_ms(plain, 1) if plain else None,
               "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "fp32_bound_ms": max(b_ms, flops / FP32_FLOPS * 1e3),
               "card": card}
        for k, v in kernels.items():
            v.launches = counts[k]
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
        rows[kname][tag] = rec
        results["times"].append(rec)
        emit({"phase": "time", **rec})
        return rec

    # -- (a) epilogues and residuals on the single-channel paths --------
    x = randn(8192, 8192)
    cells = x.numel()
    bias = torch.tensor([0.25], device=dev)
    for strategy, kname in (("lanes", "K1"), ("mxu", "K2")):
        variants = engine.VARIANTS if strategy == "lanes" else ("shift_psum",)
        cases = [("2d9pt", ("bias", "relu"), 1, v, torch.float32)
                 for v in variants]
        cases += [("2d5pt", ("gelu",), 2, "shift_psum", torch.float32),
                  ("2d9pt", ("bias", "relu"), 1, "shift_psum",
                   torch.bfloat16)]
        for name, chain, t, variant, dt in cases:
            sd = stencils.BENCHMARKS[name]
            xx = x.to(dt)
            args_ = (bias,) if "bias" in chain else ()
            p = dataclasses.replace(ssam_stencil2d.plan_for(sd),
                                    strategy=strategy,
                                    epilogue=normalize_epilogue(chain))
            lin = dataclasses.replace(p, epilogue=())
            tag = (f"{name} {'+'.join(chain)} t={t} {variant} "
                   f"{str(dt)[6:]} 8192^2")

            def fused(xx=xx, chain=chain, args_=args_, t=t, variant=variant,
                      name=name):
                return ops.stencil(xx, name, time_steps=t, variant=variant,
                                   epilogue=chain, epilogue_args=args_,
                                   strategy=strategy)

            y = run(kname, 1, fused)
            plain = engine.run_window_plan_reference(
                xx, plan=p, time_steps=t, variant=variant,
                epilogue_args=args_)
            held(kname, tag, y, plain, 3e-5 if dt == torch.float32
                 else 3e-2)
            del y, plain
            wt, pads = dense_filter(sd, dev)
            es = xx.element_size()
            time_case(
                kname, tag, fused,
                lambda xx=xx, p=p, t=t, variant=variant, args_=args_:
                    engine.run_window_plan_reference(
                        xx, plan=p, time_steps=t, variant=variant,
                        epilogue_args=args_),
                2 * cells * es,
                t * (2 * len(sd.offsets) - 1) * cells
                + len(normalize_epilogue(chain)) * cells,
                unfused=lambda xx=xx, lin=lin, p=p, t=t, variant=variant,
                args_=args_: adjoint.apply_epilogue(
                    p, engine.run_window_plan(xx, plan=lin, time_steps=t,
                                              variant=variant), args_),
                lib=(lambda xx=xx, wt=wt, pads=pads, p=p, t=t, args_=args_:
                     adjoint.apply_epilogue(
                         p, (library(xx, wt.to(xx.dtype), pads) if t == 1
                             else library_padded(xx, wt.to(xx.dtype), pads,
                                                 t)), args_)))
        # conv 5x5 'same' with bias, GELU and the residual x itself
        w5 = randn(5, 5, scale=0.2)
        chain = ("bias", "gelu", "residual_add")
        p = dataclasses.replace(ssam_conv2d.plan_for((5, 5), "same"),
                                strategy=strategy,
                                epilogue=normalize_epilogue(chain))
        lin = dataclasses.replace(p, epilogue=())
        tag = "conv 5x5 same bias+gelu+residual(x) float32 8192^2"

        def fused5(w5=w5, chain=chain):
            return ops.conv2d(x, w5, mode="same", epilogue=chain,
                              epilogue_args=(bias, x), strategy=strategy)

        y = run(kname, 1, fused5)
        held(kname, tag, y, engine.run_window_plan_reference(
            x, w5, plan=p, epilogue_args=(bias, x)), 3e-5)
        del y
        time_case(
            kname, tag, fused5,
            lambda: engine.run_window_plan_reference(
                x, w5, plan=p, epilogue_args=(bias, x)),
            moved_bytes(x, w5, bias, x) + cells * 4,
            (2 * 25 - 1 + 3) * cells,
            unfused=lambda: adjoint.apply_epilogue(
                p, engine.run_window_plan(x, w5, plan=lin), (bias, x)),
            lib=lambda: adjoint.apply_epilogue(
                p, F.conv2d(x[None, None], w5[None, None], padding=2)[0, 0],
                (bias, x)))

    # -- (b) output strides: forward, dx and dW --------------------------
    xb = randn(16, 2048, 2048)
    w5 = randn(5, 5, scale=0.2)
    strided = [(mode, st, x) for mode, st in SURFACE_STRIDES] + [
        (SURFACE_STRIDES[0][0], SURFACE_STRIDES[0][1], xb)]
    for mode, stride, xin in strided:
        shape = tuple(xin.shape)
        base = (ssam_conv2d.plan_for if xin.ndim == 2
                else ssam_conv2d.plan_for_batched)((5, 5), mode)
        pad = 2 if mode == "same" else 0
        x4 = xin.reshape((-1, 1) + shape[-2:])
        label = f"5x5 {mode} stride {stride} {'x'.join(map(str, shape))}"
        g = None
        for strategy, kname in (("lanes", "K1"), ("mxu", "K2")):
            p = dataclasses.replace(base, stride=stride, strategy=strategy)
            y = run(kname, 1, lambda: engine.run_window_plan(xin, w5, plan=p))
            held(kname, f"{label} forward", y,
                 engine.run_window_plan_reference(xin, w5, plan=p), 3e-5)
            outs = y.numel()
            time_case(
                kname, f"{label} forward",
                lambda p=p: engine.run_window_plan(xin, w5, plan=p),
                lambda p=p: engine.run_window_plan_reference(xin, w5,
                                                             plan=p),
                (xin.numel() + outs) * 4, (2 * 25 - 1) * outs,
                lib=lambda: F.conv2d(x4, w5[None, None], stride=stride,
                                     padding=pad))
            if g is None:
                g = randn(*y.shape)
            del y
            phases = [ph for ph in adjoint.strided_input_adjoint_phases(p)
                      if ph.plan is not None and all(ph.extent(shape[-2:]))]
            dx = run(kname, len(phases), lambda p=p: engine.run_adjoint_phases(
                g, w5, plan=p, in_spatial=shape[-2:]))
            held(kname, f"{label} dx", dx,
                 engine.run_adjoint_phases_reference(
                     g, w5, plan=p, in_spatial=shape[-2:]), 3e-5)
            del dx
            g4 = g.reshape((-1, 1) + tuple(g.shape[-2:]))
            time_case(
                kname, f"{label} dx",
                lambda p=p: engine.run_adjoint_phases(
                    g, w5, plan=p, in_spatial=shape[-2:]),
                lambda p=p: engine.run_adjoint_phases_reference(
                    g, w5, plan=p, in_spatial=shape[-2:]),
                (g.numel() + xin.numel()) * 4, (2 * 25 - 1) * g.numel(),
                lib=lambda: torch.nn.grad.conv2d_input(
                    x4.shape, w5[None, None], g4, stride=stride,
                    padding=pad))
        p = dataclasses.replace(base, stride=stride)
        n3 = engine.WgradKernel.launches_for(xin, g, plan=p)
        dw = run("K3", n3, lambda: engine.run_weight_grad_plan(xin, g,
                                                                plan=p))
        held("K3", f"{label} dW", dw,
             engine.run_weight_grad_plan_reference(xin, g, plan=p), 1e-4)
        g4 = g.reshape((-1, 1) + tuple(g.shape[-2:]))
        time_case(
            "K3", f"{label} dW",
            lambda: engine.run_weight_grad_plan(xin, g, plan=p),
            lambda: engine.run_weight_grad_plan_reference(xin, g, plan=p),
            (xin.numel() + g.numel()) * 4, 2 * 25 * g.numel(),
            lib=lambda: torch.nn.grad.conv2d_weight(
                x4, (1, 1, 5, 5), g4, stride=stride, padding=pad),
            lib_reps=1)
        del g, g4
    del x, xb
    torch.cuda.empty_cache()

    # -- (c) residual_add on the reduce paths and the per-lane path ------
    st = stem_cases(dev, args.seed + 11)
    x2, w2, b2 = st["x2"], st["w2"], st["b2"]
    chain = ("bias", "gelu", "residual_add")
    r2 = randn(TRAIN_BATCH, D_MODEL, 1, N_FRAMES)
    for strategy, kname in (("lanes", "K1"), ("mxu", "K2")):
        p = dataclasses.replace(
            ssam_conv2d.plan_for_nchw(x2.shape, w2.shape, "same"),
            stride=(1, 2), strategy=strategy,
            epilogue=normalize_epilogue(chain))
        lin = dataclasses.replace(p, epilogue=())
        tag = "whisper conv2 (8,512,1,3000) stride (1,2) bias+gelu+residual"

        def fusedr(p=p):
            return engine.run_window_plan(x2, w2, plan=p,
                                          epilogue_args=(b2, r2))

        y = run(kname, 1, fusedr)
        held(kname, tag, y, engine.run_window_plan_reference(
            x2, w2, plan=p, epilogue_args=(b2, r2)), 1e-4)
        del y
        outs = r2.numel()
        time_case(
            kname, tag, fusedr,
            lambda p=p: engine.run_window_plan_reference(
                x2, w2, plan=p, epilogue_args=(b2, r2)),
            moved_bytes(x2, w2, b2, r2) + outs * 4,
            2 * D_MODEL * 3 * outs + 3 * outs,
            unfused=lambda p=p, lin=lin: adjoint.apply_epilogue(
                p, engine.run_window_plan(x2, w2, plan=lin), (b2, r2)),
            lib=lambda p=p: adjoint.apply_epilogue(
                p, F.conv2d(x2, w2, stride=(1, 2), padding=(0, 1)),
                (b2, r2)))
    del st, x2, w2, b2, r2
    xh = randn(2, 2048, 3200)
    wh = randn(4, 3200, scale=0.5)
    bh = randn(3200, scale=0.1)
    rh = randn(2, 2048, 3200)
    chain = ("bias", "silu", "residual_add")
    p = dataclasses.replace(ssam_conv1d.plan_for(4),
                            epilogue=normalize_epilogue(chain))
    require(engine.perlane_layout(p, 2, 2048, 3200, 4).chain == "generic",
            "the residual chain runs K1's generic per-lane instance")
    lin = dataclasses.replace(p, epilogue=())
    tag = "hymba conv1d (2,2048,3200) bias+silu+residual"
    # the library's layout: channels ahead of time, (B, D, T)
    xt, wt = xh.transpose(1, 2).contiguous(), wh.T[:, None, :].contiguous()
    rt = rh.transpose(1, 2).contiguous()

    def fusedh():
        return ops.conv1d_causal(xh, wh, epilogue=chain,
                                 epilogue_args=(bh, rh))

    y = run("K1", 1, fusedh)
    held("K1", tag, y, engine.run_window_plan_reference(
        xh, wh, plan=p, epilogue_args=(bh, rh)), 3e-5)
    del y
    time_case(
        "K1", tag, fusedh,
        lambda: engine.run_window_plan_reference(xh, wh, plan=p,
                                                 epilogue_args=(bh, rh)),
        moved_bytes(xh, wh, bh, rh) + xh.numel() * 4,
        (2 * 4 - 1 + 3) * xh.numel(),
        unfused=lambda: adjoint.apply_epilogue(
            p, engine.run_window_plan(xh, wh, plan=lin), (bh, rh)),
        lib=lambda: F.silu(F.conv1d(xt, wt, bh, padding=3,
                                    groups=3200)[..., :2048]) + rt)
    del xh, wh, bh, rh, xt, wt, rt

    # -- (d) grouped NCHW forward and backward ---------------------------
    # The ResNeXt-like case runs a launch a group; the depthwise ones
    # (groups == C_in == C_out) one K1 launch forward, and K1's recompute
    # and dx and K3's launches backward. Each against the port's plain
    # per-group version and cuDNN's autograd, timed beside its byte bound,
    # cuDNN and (depthwise) the per-group route of the parent, in turns.
    depthwise = {}
    for xs, ws, groups, label, chain in (
            ((8, 256, 56, 56), (256, 8, 3, 3), 32, "ResNeXt-like",
             ("bias", "gelu")),
            ((8, 64, 256, 256), (64, 1, 3, 3), 64, "depthwise",
             ("bias", "gelu")),
            ((64, 96, 56, 56), (96, 1, 7, 7), 96, "ConvNeXt depthwise",
             ("bias",))):
        xg = randn(*xs).requires_grad_(True)
        wg = randn(*ws, scale=(ws[1] * ws[2] * ws[3]) ** -0.5
                   ).requires_grad_(True)
        bg = randn(ws[0], scale=0.1).requires_grad_(True)
        gy = randn(xs[0], ws[0], xs[2], xs[3])
        pad, fk = ws[2] // 2, f"{ws[2]}x{ws[3]}"
        dw = ops.depthwise_plan(xs, ws, groups=groups, mode="same",
                                epilogue=chain)
        tag = (f"grouped {label} {'x'.join(map(str, xs))} {fk} "
               f"groups={groups} {'+'.join(chain)}")

        def fwd(xg=xg, wg=wg, bg=bg, groups=groups, chain=chain):
            return ops.conv2d(xg, wg, groups=groups, epilogue=chain,
                              epilogue_args=(bg,))

        def per_group(xg=xg, wg=wg, bg=bg, groups=groups, chain=chain):
            """The parent's route: one NCHW call a group (K1's reduce
            path), the outputs concatenated."""
            Cg, Og = xg.shape[1] // groups, wg.shape[0] // groups
            return torch.cat([ops.conv2d(
                xg[:, i * Cg:(i + 1) * Cg], wg[i * Og:(i + 1) * Og],
                epilogue=chain, epilogue_args=(bg[i * Og:(i + 1) * Og],))
                for i in range(groups)], dim=1)

        def plain_fwd(xg=xg, wg=wg, bg=bg, groups=groups, xs=xs, ws=ws,
                      chain=chain, dw=dw):
            if dw is not None:      # the plain version of the one launch
                return engine.run_window_plan_reference(
                    xg.detach().reshape(-1, *xs[2:]),
                    wg.detach().reshape(ws[0], *ws[2:]), plan=dw,
                    epilogue_args=(bg.detach(),)).reshape(gy.shape)
            Cg, Og = xs[1] // groups, ws[0] // groups
            p = dataclasses.replace(
                ssam_conv2d.plan_for_nchw((xs[0], Cg) + xs[2:],
                                          (Og,) + ws[1:], "same"),
                epilogue=normalize_epilogue(chain))
            return torch.cat([engine.run_window_plan_reference(
                xg[:, i * Cg:(i + 1) * Cg].detach(),
                wg[i * Og:(i + 1) * Og].detach(), plan=p,
                epilogue_args=(bg[i * Og:(i + 1) * Og].detach(),))
                for i in range(groups)], dim=1)

        def lib_fwd(xg=xg, wg=wg, bg=bg, groups=groups, pad=pad,
                    chain=chain):
            y = F.conv2d(xg, wg, bg, padding=pad, groups=groups)
            return F.gelu(y, approximate="tanh") if "gelu" in chain else y

        fwd_launches = 1 if dw is not None else groups
        with torch.no_grad():
            n0 = K1.launches
            y = run("K1", fwd_launches, fwd)
            k1_fwd = K1.launches - n0
            held("K1", f"{tag} forward", y, plain_fwd(), 1e-4)
            if dw is not None:
                held("K1", f"{tag} forward vs the per-group route", y,
                     run("K1", groups, per_group), 1e-4)
        with torch.enable_grad():
            y = fwd()
            before = {k: v.launches for k, v in kernels.items()}
            grads = torch.autograd.grad(y, (xg, wg, bg), gy)
            torch.cuda.synchronize()
            k1_bwd = K1.launches - before["K1"]
            k3_bwd = K3.launches - before["K3"]
            if dw is not None:
                lin = dataclasses.replace(dw, epilogue=())
                want_k3 = K3.launches_for(xg.detach().reshape(-1, *xs[2:]),
                                          gy.reshape(-1, *xs[2:]), plan=lin)
                require(k1_bwd == 2 and k3_bwd == want_k3,
                        (tag, "backward launches", k1_bwd, k3_bwd, want_k3))
            else:
                require(k1_bwd == 2 * groups and k3_bwd >= groups,
                        (tag, "backward launches", k1_bwd, k3_bwd))
            expected["K1"] += fwd_launches + k1_bwd
            expected["K3"] += k3_bwd
            # against the port's plain per-group backward, and against
            # cuDNN's autograd of the same function
            plain = plain_grouped_backward(xg, wg, bg, gy, groups, chain)
            for name_, a, e in zip(("dx", "dW", "db"), grads, plain):
                held("K3" if name_ == "dW" else "K1",
                     f"{tag} {name_} vs plain", a, e, 1e-4)
            del plain
            xd, wd, bd = (t.detach().requires_grad_(True)
                          for t in (xg, wg, bg))
            want = torch.autograd.grad(lib_fwd(xd, wd, bd), (xd, wd, bd),
                                       gy)
            for name_, a, e in zip(("dx", "dW", "db"), grads, want):
                held("K3" if name_ == "dW" else "K1", f"{tag} {name_}", a, e,
                     1e-4)
            del y, grads, want
        outs = gy.numel()
        flops = 2 * outs * ws[1] * ws[2] * ws[3]
        counts = {k: v.launches for k, v in kernels.items()}
        if dw is not None:      # the per-group route first, in turns
            pg0 = device_ms(lambda: per_group().detach(), SURFACE_REPS)
        rec_f = time_case(
            "K1", f"{tag} forward", lambda: fwd().detach(),
            lambda: plain_fwd(), (xg.numel() + wg.numel() + outs) * 4, flops,
            unfused=(lambda xg=xg, wg=wg, bg=bg, groups=groups: F.gelu(
                ops.conv2d(xg.detach(), wg.detach(), groups=groups)
                + bg.detach()[:, None, None], approximate="tanh"))
            if "gelu" in chain else None,
            lib=lib_fwd)

        def bwd(fn):
            def go():
                with torch.enable_grad():
                    return torch.autograd.grad(fn(), (xg, wg, bg), gy)
            return go

        # (the plain versions run no backward on the card: no plain_ms);
        # its bytes: x and g read, dx written, the filter and the bias
        # read, dW and db written
        rec_b = time_case("K1", f"{tag} backward", bwd(fwd), None,
                          (2 * xg.numel() + outs + 2 * wg.numel()
                           + 2 * bg.numel()) * 4,
                          2 * flops, lib=bwd(lib_fwd))
        # the launches the op's own calls made above, in this run
        rec_f["launches"], rec_b["launches"] = k1_fwd, k1_bwd
        if dw is not None:
            pg1 = device_ms(lambda: per_group().detach(), SURFACE_REPS)
            pgb = [device_ms(bwd(per_group), SURFACE_REPS)
                   for _ in range(2)]
            rec_f["per_group_ms"] = (pg0 + pg1) / 2
            rec_b["per_group_ms"] = sum(pgb) / 2
            # the same launch without the chain at the store
            rec_f["bare_ms"] = device_ms(
                lambda: ops.conv2d(xg.detach(), wg.detach(), groups=groups),
                SURFACE_REPS)
            # the same launch at tiles that cover a row in fewer tiles
            # than the default, whose last tile of a row is narrow: timed in
            # turns beside it (the choice is the tuner's)
            db = tuple(engine.default_block(dw))
            if db[-1] < xs[3] <= 256:
                def at(blk):
                    return lambda: ops.conv2d(
                        xg.detach(), wg.detach(), groups=groups,
                        epilogue=chain, epilogue_args=(bg.detach(),),
                        block=blk).detach()
                y0 = fwd().detach()
                tiles = {}
                for blk in (db, (32, xs[3]), (64, 128), db):
                    held("K1", f"{tag} forward at block {blk}", at(blk)(), y0,
                         3e-5)
                    tiles.setdefault(str(blk), []).append(
                        device_ms(at(blk), SURFACE_REPS))
                rec_f["tiles_ms"] = {k: sum(v) / len(v)
                                     for k, v in tiles.items()}
                del y0
            # K3's part of the backward alone, on the recomputed cotangent
            gz = gy.reshape(-1, *xs[2:])
            xz = xg.detach().reshape(-1, *xs[2:])
            rec_w = {"case": f"{tag} dW (K3)", "kernel": "K3",
                     "ms": device_ms(lambda: K3(xz, gz, plan=lin),
                                     SURFACE_REPS),
                     "plain_ms": event_ms(lambda: engine.
                                          run_weight_grad_plan_reference(
                                              xz, gz, plan=lin), 1),
                     "library_ms": event_ms(
                         lambda: torch.nn.grad.conv2d_weight(
                             xg.detach(), ws, gy, padding=pad,
                             groups=groups), SURFACE_REPS),
                     "bound_ms": (xz.numel() + gz.numel() + wg.numel()) * 4
                     / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "launches": k3_bwd,
                     "unfused_ms": None, "card": card}
            rec_w["roofline_share"] = rec_w["bound_ms"] / rec_w["ms"]
            rows["K3"][rec_w["case"]] = rec_w
            results["times"].append(rec_w)
            emit({"phase": "time", **rec_w})
            emit({"phase": "time_per_group", "case": tag,
                  "forward_ms": rec_f["ms"], "backward_ms": rec_b["ms"],
                  "per_group_forward_ms": rec_f["per_group_ms"],
                  "per_group_backward_ms": rec_b["per_group_ms"],
                  "bare_forward_ms": rec_f["bare_ms"],
                  "forward_ms_by_tile": rec_f.get("tiles_ms"),
                  "card": card})
            depthwise[label] = {"forward": rec_f, "backward": rec_b,
                                "dW": rec_w}
        for k, v in kernels.items():    # (timing runs, not the main path)
            v.launches = counts[k]
        del xg, wg, bg, gy
        torch.cuda.empty_cache()

    launches = {k: v.launches for k, v in kernels.items()}
    emit({"phase": "surface_launches", "launches": launches,
          "expected": expected})
    require(launches == expected and all(launches.values()),
            ("phase 11 launches", launches, expected))
    return {"launches": launches, "worst": worst, "rows": rows,
            "depthwise": depthwise}


def large_filter_phase(args, dev, card, results) -> dict:
    """Phase 15: filters of any size. K1's single-channel path walks a
    footprint in bands (one launch), K2's streams its Toeplitz B tiles a
    group of entries at a time (one launch), K3's channel path takes any
    number of taps. Each case against its plain version on the card, the
    launches counted (K1, K2 and K3 zeroed before the phase and read
    after), and timed beside its bound (bytes, fp32 operations, and for
    the tensor-core kernels the operations once at TF32's rate), the plain
    version (one timed call: the one the check ran) and cuDNN with TF32
    off and on. cuDNN's single-channel weight gradient of a large filter
    takes seconds (5×5 at 8192²: 3989 ms, PERF.md); each cuDNN call is
    first timed on a crop, and where that predicts more than
    ``LARGE_LIB_MAX_MS`` the full call is not made ("not measured",
    with the prediction)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import convert
    from repro_torch.core import adjoint, engine
    from repro_torch.kernels import ops, ssam_conv2d, ssam_stencil2d, stencils

    K1, K2, K3 = engine.WINDOW_KERNEL, engine.MXU_KERNEL, engine.WGRAD_KERNEL
    kernels = {"K1": K1, "K2": K2, "K3": K3}
    rng = np.random.default_rng(args.seed + 15)

    def randn(*shape, scale=1.0):
        return convert.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32), dev)

    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    expected = {"K1": 0, "K2": 0, "K3": 0}
    rows = {"K1": {}, "K2": {}, "K3": {}}

    def run(want, fn):
        """``fn()`` on the main path: its launches must be ``want``."""
        before = {k: v.launches for k, v in kernels.items()}
        out = fn()
        torch.cuda.synchronize()
        got = {k: v.launches - before[k] for k, v in kernels.items()}
        full = {k: want.get(k, 0) for k in kernels}
        require(got == full, ("phase 15 launches", got, full))
        for k, v in got.items():
            expected[k] += v
        return out

    def plain_timed(fn):
        """One call of a plain version, timed with events: ``(out, ms)``."""
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)

    def held(kernel, tag, y, plain, rtol):
        worst[kernel] = max(worst[kernel], compare(
            f"phase 15 {tag}", y, plain, rtol, results))

    def lib_ms(full, crop, ratio):
        """cuDNN's time for ``full``: first ``crop`` (``1/ratio`` of the
        work) once; where that predicts more than LARGE_LIB_MAX_MS the full
        call is not made (``(None, predicted)``), else ``(ms, None)``."""
        crop()
        torch.cuda.synchronize()
        predicted = event_ms(crop, 1) * ratio
        if predicted > LARGE_LIB_MAX_MS:
            return None, predicted
        return event_ms(full, LARGE_REPS), None

    def timed(kernel, tag, fn, plain_ms, flops, nbytes, libs, tc=False,
              launches=None):
        """Device and call time of ``fn`` beside its bound, the plain
        version's ``plain_ms`` and cuDNN (``libs``: label -> (full, crop,
        ratio) or None); the launches it makes are not the main path's."""
        counts = {k: v.launches for k, v in kernels.items()}
        ms = device_ms(fn, LARGE_REPS)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f32 = flops / FP32_FLOPS * 1e3
        ops_ms = flops / TF32_FLOPS * 1e3 if tc else f32
        rec = {"case": tag, "kernel": kernel, "ms": ms,
               "call_ms": event_ms(fn, LARGE_REPS), "plain_ms": plain_ms,
               "bound_ms": max(b_ms, ops_ms),
               "bound_by": "bytes" if b_ms >= ops_ms else "operations",
               "fp32_bound_ms": max(b_ms, f32), "bytes_bound_ms": b_ms,
               "gflop": flops / 1e9, "launches": launches, "card": card}
        for label, spec in libs.items():
            if spec is None:
                rec[label], rec[label + "_predicted"] = None, None
                continue
            full, crop, ratio = spec
            rec[label], rec[label + "_predicted"] = lib_ms(full, crop, ratio)
            rec[label + "_tf32"], rec[label + "_tf32_predicted"] = lib_ms(
                cudnn_tf32(full), cudnn_tf32(crop), ratio)
        rec["library_ms"] = rec.get("cudnn_ms")
        rec["library_tf32_ms"] = rec.get("cudnn_ms_tf32")
        rec["roofline_share"] = rec["bound_ms"] / ms
        results["times"].append(rec)
        emit({"phase": "time", **rec})
        rows[kernel][tag] = rec
        for k, v in kernels.items():
            v.launches = counts[k]
        return rec

    def conv_lib(x, w, pad, crop):
        """``F.conv2d(padding=)`` on ``x`` (2-D) and on a crop of it."""
        x4, w4 = x[None, None], w[None, None]
        return ((lambda: F.conv2d(x4, w4, padding=pad)),
                (lambda: F.conv2d(x4[..., :crop, :crop], w4, padding=pad)),
                x.numel() / crop ** 2)

    for k in kernels.values():
        k.launches = 0
    n = LARGE_SIDE
    x = randn(n, n)
    cells = x.numel()
    crop = min(512, n // 4)     # the side of cuDNN's probe on a crop

    # -- (a) 'same' at 8192² on both strategies, a launch each ---------
    filters = {nm: randn(*nm, scale=(nm[0] * nm[1]) ** -0.5)
               for nm in LARGE_FILTERS}
    for nm, w in filters.items():
        N, M = nm
        pad = ((N - 1) // 2, (M - 1) // 2) if N % 2 and M % 2 else None
        pads = [(N - 1) // 2, N - 1 - (N - 1) // 2, (M - 1) // 2,
                M - 1 - (M - 1) // 2]
        for strategy in ("lanes", "mxu"):
            kernel = "K2" if strategy == "mxu" else "K1"
            p = dataclasses.replace(ssam_conv2d.plan_for(nm, "same"),
                                    strategy=strategy)
            tag = f"{strategy} conv2d {N}x{M} 'same' {n}x{n} fp32"
            y = run({kernel: 1}, lambda: ops.conv2d(x, w,
                                                    strategy=strategy))
            plain, plain_ms = plain_timed(
                lambda: engine.run_window_plan_reference(x, w, plan=p))
            held(kernel, tag, y, plain, 3e-5)
            del y, plain
            # cuDNN: F.conv2d with its own padding where the filter is odd,
            # else F.pad then a valid call
            if pad is not None:
                lib = conv_lib(x, w, pad, crop)
            else:
                x4 = F.pad(x[None, None], pads[2:] + pads[:2])
                lib = ((lambda: F.conv2d(x4, w[None, None])),
                       (lambda: F.conv2d(x4[..., :crop + N - 1,
                                            :crop + M - 1], w[None, None])),
                       cells / crop ** 2)
            timed(kernel, tag, lambda: ops.conv2d(x, w, strategy=strategy),
                  plain_ms, 2 * N * M * cells, 2 * cells * 4,
                  {"cudnn_ms": lib}, tc=strategy == "mxu", launches=1)
            torch.cuda.empty_cache()
    # bf16 33x33 and the non-finite reach of the streamed K2
    w33 = filters[(33, 33)]
    xb = x.to(torch.bfloat16)
    for strategy in ("lanes", "mxu"):
        kernel = "K2" if strategy == "mxu" else "K1"
        p = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                                strategy=strategy)
        tag = f"{strategy} conv2d 33x33 'same' {n}x{n} bf16"
        y = run({kernel: 1}, lambda: ops.conv2d(xb, w33, strategy=strategy))
        require(y.dtype == torch.bfloat16, (tag, y.dtype))
        plain, plain_ms = plain_timed(
            lambda: engine.run_window_plan_reference(xb, w33, plan=p))
        held(kernel, tag, y, plain, 3e-2)
        del y, plain
        timed(kernel, tag, lambda: ops.conv2d(xb, w33, strategy=strategy),
              plain_ms, 2 * 33 * 33 * cells, 2 * cells * 2,
              {"cudnn_ms": conv_lib(xb, w33.to(torch.bfloat16), 16, crop)},
              tc=strategy == "mxu", launches=1)
    del xb
    # a 33x33 box stencil (1089 taps) at t = 2: K1's bands, and K2
    # streaming its B tiles through both applications; cuDNN pads once and
    # makes a valid call a step
    sd = stencils.StencilDef("box 33x33", 2, stencils.box2d(16),
                             stencils._norm_coeffs(33 * 33), 16, 0)
    wbox = torch.full((1, 1, 33, 33), 1.0 / (33 * 33), device=dev)

    def box_lib(side):
        xp = F.pad(x[None, None, :side, :side], (32, 32, 32, 32))
        return lambda: F.conv2d(F.conv2d(xp, wbox), wbox)

    for strategy in ("lanes", "mxu"):
        kernel = "K2" if strategy == "mxu" else "K1"
        p = dataclasses.replace(ssam_stencil2d.plan_for(sd),
                                strategy=strategy)
        tag = f"{strategy} stencil box 33x33 t=2 {n}x{n} fp32"
        y = run({kernel: 1}, lambda: ops.stencil(x, sd, time_steps=2,
                                                 strategy=strategy))
        plain, plain_ms = plain_timed(
            lambda: engine.run_window_plan_reference(x, plan=p,
                                                     time_steps=2))
        held(kernel, tag, y, plain, 3e-5)
        del y, plain
        timed(kernel, tag, lambda: ops.stencil(x, sd, time_steps=2,
                                               strategy=strategy),
              plain_ms, 2 * 2 * 33 * 33 * cells, 2 * cells * 4,
              {"cudnn_ms": (box_lib(n), box_lib(crop), cells / crop ** 2)},
              tc=strategy == "mxu", launches=1)
        torch.cuda.empty_cache()
    xn = x.clone()
    xn[n // 8, n // 4], xn[5 * n // 8, 7 * n // 8] = float("inf"), float("nan")
    pm = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                             strategy="mxu")
    y = run({"K2": 1}, lambda: ops.conv2d(xn, w33, strategy="mxu"))
    plain = engine.run_window_plan_reference(xn, w33, plan=pm)
    torch.cuda.synchronize()
    bad_y, bad_p = ~torch.isfinite(y), ~torch.isfinite(plain)
    nonfinite = {"case": "mxu conv2d 33x33 with an inf and a nan",
                 "nonfinite_plain": int(bad_p.sum()),
                 "nonfinite_kernel": int(bad_y.sum()),
                 "equal_sets": bool(torch.equal(bad_y, bad_p))}
    emit({"phase": "check_nonfinite", **nonfinite})
    require(nonfinite["equal_sets"] and nonfinite["nonfinite_plain"] > 0,
            nonfinite)
    held("K2", "mxu conv2d 33x33 with an inf and a nan, finite outputs",
         y[~bad_p], plain[~bad_p], 3e-5)
    del xn, y, plain, bad_y, bad_p
    torch.cuda.empty_cache()

    # -- (b) a learned 33x33 filter step: forward, dx and dW -----------
    g = randn(n, n)
    for strategy in ("lanes", "mxu"):
        kernel = "K2" if strategy == "mxu" else "K1"
        p = dataclasses.replace(ssam_conv2d.plan_for((33, 33), "same"),
                                strategy=strategy)
        lin = dataclasses.replace(p, strategy="lanes")
        ap = adjoint.input_adjoint_plan(p)
        xg = x.clone().requires_grad_(True)
        wg = w33.clone().requires_grad_(True)
        k3n = K3.launches_for(x, g, plan=lin)

        def step(xg=xg, wg=wg, strategy=strategy):
            with torch.enable_grad():
                y = ops.conv2d(xg, wg, strategy=strategy)
                return torch.autograd.grad(y, (xg, wg), g)

        dx, dw = run({kernel: 2, "K3": k3n}, step)
        wa = adjoint.adjoint_coeff_array(p, w33)
        plain_dx, dx_ms = plain_timed(
            lambda: engine.run_window_plan_reference(g, wa, plan=ap))
        plain_dw, dw_ms = plain_timed(
            lambda: engine.run_weight_grad_plan_reference(x, g, plan=lin))
        tag = f"{strategy} learned 33x33 step {n}x{n} fp32"
        held(kernel, f"{tag} dx", dx, plain_dx, 3e-5)
        held("K3", f"{tag} dW", dw, plain_dw, 1e-4)
        del dx, dw, plain_dx, plain_dw
        flops = 2 * 33 * 33 * cells
        x4, g4, w4 = x[None, None], g[None, None], w33[None, None]
        timed(kernel, f"{tag} dx", lambda: engine.run_window_plan(
            g, wa, plan=ap), dx_ms, flops, 2 * cells * 4,
            {"cudnn_ms": (
                lambda: torch.nn.grad.conv2d_input(x4.shape, w4, g4,
                                                   padding=16),
                lambda: torch.nn.grad.conv2d_input(
                    (1, 1, crop, crop), w4, g4[..., :crop, :crop],
                    padding=16), cells / crop ** 2)},
            tc=strategy == "mxu", launches=1)
        timed("K3", f"{tag} dW", lambda: engine.run_weight_grad_plan(
            x, g, plan=lin), dw_ms, flops, 2 * cells * 4,
            {"cudnn_ms": (
                lambda: torch.nn.grad.conv2d_weight(x4, w4.shape, g4,
                                                    padding=16),
                lambda: torch.nn.grad.conv2d_weight(
                    x4[..., :crop, :crop], w4.shape, g4[..., :crop, :crop],
                    padding=16), cells / crop ** 2)},
            launches=k3n)
        counts = {k: v.launches for k, v in kernels.items()}
        rs = {"case": f"{tag}: forward, dx, dW", "kernel": kernel,
              "ms": device_ms(lambda: step(), LARGE_REPS),
              "launches": {kernel: 2, "K3": k3n}, "card": card}
        for k, v in kernels.items():
            v.launches = counts[k]
        results["times"].append(rs)
        emit({"phase": "time", **rs})
        del xg, wg
    del g
    torch.cuda.empty_cache()

    # -- (c) depthwise 51x5 and 5x51 with a bias, ConvNeXt-T's stage 1 --
    B, C, H, W = LARGE_DEPTHWISE
    for nm in ((51, 5), (5, 51)):
        N, M = nm
        xs, ws = (B, C, H, W), (C, 1, N, M)
        xg = randn(*xs).requires_grad_(True)
        wg = randn(*ws, scale=(N * M) ** -0.5).requires_grad_(True)
        bg = randn(C, scale=0.1).requires_grad_(True)
        gy = randn(*xs)
        dwp = ops.depthwise_plan(xs, ws, groups=C, mode="same",
                                 epilogue=("bias",))
        require(dwp is not None and engine.banded(dwp),
                ("depthwise", nm, "not one banded launch"))
        lin = dataclasses.replace(dwp, epilogue=())
        tag = f"depthwise {'x'.join(map(str, xs))} {N}x{M} bias"
        x3, g3 = xg.detach().reshape(B * C, H, W), gy.reshape(B * C, H, W)
        w3 = wg.detach().reshape(C, N, M)
        k3n = K3.launches_for(x3, g3, plan=lin)

        def fwd(xg=xg, wg=wg, bg=bg):
            return ops.conv2d(xg, wg, groups=C, epilogue=("bias",),
                              epilogue_args=(bg,))

        def bwd(xg=xg, wg=wg, bg=bg, gy=gy, fn=fwd):
            with torch.enable_grad():
                return torch.autograd.grad(fn(), (xg, wg, bg), gy)

        with torch.no_grad():
            y = run({"K1": 1}, fwd)
        plain, plain_ms = plain_timed(
            lambda: engine.run_window_plan_reference(
                x3, w3, plan=dwp, epilogue_args=(bg.detach(),)))
        held("K1", f"{tag} forward", y, plain.reshape(xs), 3e-5)
        del y, plain
        # the forward, then its backward: the pre-activation recomputed,
        # dx, and K3's dW
        got = run({"K1": 3, "K3": k3n}, bwd)
        # the plain backward: the bias's VJP is the identity
        wa = adjoint.adjoint_coeff_array(lin, w3)
        pdx = engine.run_window_plan_reference(
            g3, wa, plan=adjoint.input_adjoint_plan(lin)).reshape(xs)
        pdw = engine.run_weight_grad_plan_reference(x3, g3, plan=lin)
        held("K1", f"{tag} dx", got[0], pdx, 3e-5)
        held("K3", f"{tag} dW", got[1], pdw.reshape(ws), 1e-4)
        held("K1", f"{tag} db", got[2], gy.sum((0, 2, 3)), 1e-4)
        del got, pdx, pdw
        pad = ((N - 1) // 2, (M - 1) // 2)

        def lib_f(xg=xg, wg=wg, bg=bg, pad=pad, n_img=B):
            return F.conv2d(xg[:n_img], wg, bg, padding=pad, groups=C)

        def lib_b(n_img=B, xg=xg, wg=wg, bg=bg, gy=gy, pad=pad):
            xd, wd, bd = (t.detach().requires_grad_(True)
                          for t in (xg[:n_img], wg, bg))
            with torch.enable_grad():
                return torch.autograd.grad(
                    F.conv2d(xd, wd, bd, padding=pad, groups=C),
                    (xd, wd, bd), gy[:n_img])

        flops = 2 * xg.numel() * N * M
        timed("K1", f"{tag} forward", lambda: fwd().detach(), plain_ms,
              flops, (2 * xg.numel() + wg.numel() + C) * 4,
              {"cudnn_ms": (lambda: lib_f(), lambda: lib_f(n_img=8),
                            B / 8)}, launches=1)
        timed("K1", f"{tag} forward and backward", bwd, None, 3 * flops,
              (2 * xg.numel() + gy.numel() + 2 * wg.numel() + 2 * C) * 4,
              {"cudnn_ms": (lambda: lib_b(), lambda: lib_b(n_img=8),
                            B / 8)},
              launches={"K1": 3, "K3": k3n})
        del xg, wg, bg, gy
        torch.cuda.empty_cache()

    # -- (d) NCHW backward beyond 64 taps: dW on K3's channel path ------
    for tag, xs, ws, mode, stride in LARGE_NCHW:
        xg = randn(*xs).requires_grad_(True)
        wg = randn(*ws, scale=(ws[1] * ws[2] * ws[3]) ** -0.5
                   ).requires_grad_(True)
        p = dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                                stride=stride)
        with torch.no_grad():
            y = run({"K1": 1}, lambda: ops.conv2d(xg, wg, mode=mode,
                                                  stride=stride))
        plain, fwd_ms = plain_timed(lambda: engine.run_window_plan_reference(
            xg.detach(), wg.detach(), plan=p))
        held("K1", f"{tag} forward", y, plain, 1e-4)
        gy = randn(*y.shape)
        del y, plain
        k3n = K3.launches_for(xg.detach(), gy, plan=p)

        def bwd(xg=xg, wg=wg, gy=gy, mode=mode, stride=stride):
            with torch.enable_grad():
                return torch.autograd.grad(
                    ops.conv2d(xg, wg, mode=mode, stride=stride), (xg, wg),
                    gy)

        dx, dw = run({"K1": 2, "K3": k3n}, bwd)
        wa = adjoint.adjoint_coeff_array(p, wg.detach())
        if stride:
            pdx, dx_ms = plain_timed(
                lambda: engine.run_adjoint_phases_reference(
                    gy, wa, plan=p, in_spatial=xs[2:]))
        else:
            pdx, dx_ms = plain_timed(lambda: engine.run_window_plan_reference(
                gy, wa, plan=adjoint.input_adjoint_plan(p)))
        pdw, dw_ms = plain_timed(lambda: engine.run_weight_grad_plan_reference(
            xg.detach(), gy, plan=p))
        held("K1", f"{tag} dx", dx, pdx, 1e-4)
        held("K3", f"{tag} dW", dw, pdw, 1e-4)
        del dx, dw, pdx, pdw
        outs = gy.numel() // ws[0]
        flops = 2 * outs * ws[0] * ws[1] * ws[2] * ws[3]
        st = stride or (1, 1)
        pad = (ws[2] // 2, ws[3] // 2) if mode == "same" else (0, 0)
        xd, wd = xg.detach(), wg.detach()
        xb_, gb_ = xs[0] // 4, xs[0] // 4     # cuDNN's crops: a quarter
        timed("K1", f"{tag} forward", lambda: ops.conv2d(
            xd, wd, mode=mode, stride=stride), fwd_ms, flops,
            (xd.numel() + wd.numel() + gy.numel()) * 4,
            {"cudnn_ms": (lambda: F.conv2d(xd, wd, stride=st, padding=pad),
                          lambda: F.conv2d(xd[:xb_], wd, stride=st,
                                           padding=pad), 4)}, launches=1)
        timed("K1", f"{tag} dx", lambda: engine.run_adjoint_phases(
            gy, wa, plan=p, in_spatial=xs[2:]) if stride else
            engine.run_window_plan(gy, wa,
                                   plan=adjoint.input_adjoint_plan(p)),
            dx_ms, flops, (xd.numel() + wd.numel() + gy.numel()) * 4,
            {"cudnn_ms": (
                lambda: torch.nn.grad.conv2d_input(xs, wd, gy, stride=st,
                                                   padding=pad),
                lambda: torch.nn.grad.conv2d_input(
                    (xb_,) + xs[1:], wd, gy[:gb_], stride=st, padding=pad),
                4)}, launches=1)
        timed("K3", f"{tag} dW", lambda: engine.run_weight_grad_plan(
            xd, gy, plan=p), dw_ms, flops,
            (xd.numel() + gy.numel() + wd.numel()) * 4,
            {"cudnn_ms": (
                lambda: torch.nn.grad.conv2d_weight(xd, ws, gy, stride=st,
                                                    padding=pad),
                lambda: torch.nn.grad.conv2d_weight(
                    xd[:xb_], ws, gy[:gb_], stride=st, padding=pad), 4)},
            tc=True, launches=k3n)
        del xg, wg, gy, xd, wd, wa
        torch.cuda.empty_cache()

    counts = {k: v.launches for k, v in kernels.items()}
    emit({"phase": "large_filter_launches", "launches": counts,
          "expected": expected})
    require(counts == expected and all(counts.values()),
            ("phase 15 launches", counts, expected))
    return {"launches": counts, "worst": worst, "rows": rows,
            "nonfinite": nonfinite}


def _large(big, kname) -> dict:
    """Phase 15's cases of one kernel as the kernel line carries them."""
    return {"launches": big["launches"][kname],
            "max_abs_err": big["worst"][kname],
            "cases": {tag: {**_row(rec), "call_ms": rec["call_ms"],
                            "launches": rec["launches"],
                            "fp32_bound_ms": rec["fp32_bound_ms"],
                            "library_tf32_ms": rec["library_tf32_ms"]}
                      for tag, rec in big["rows"][kname].items()}}


def plain_grouped_backward(x, w, b, gy, groups: int, chain) -> tuple:
    """``(dx, dW, db)`` of the grouped NCHW 'same' conv ``ops.conv2d(x, w,
    groups=, epilogue=chain, epilogue_args=(b,))`` through the port's
    plain versions, group by group as the op's backward runs: the
    epilogue's VJP at the plain pre-activation, then the plain weight
    gradient and the plain input-adjoint plan on that cotangent."""
    import dataclasses

    import torch

    from repro_torch.core import adjoint, engine
    from repro_torch.core.plan import normalize_epilogue
    from repro_torch.kernels import ssam_conv2d

    B, C, H, W = x.shape
    Cg, Og = C // groups, w.shape[0] // groups
    lin = ssam_conv2d.plan_for_nchw((B, Cg, H, W), (Og,) + tuple(w.shape[1:]),
                                    "same")
    p = dataclasses.replace(lin, epilogue=normalize_epilogue(chain))
    aplan = adjoint.input_adjoint_plan(lin)
    dxs, dws, dbs = [], [], []
    for i in range(groups):
        xi = x[:, i * Cg:(i + 1) * Cg].detach()
        wi = w[i * Og:(i + 1) * Og].detach()
        o = slice(i * Og, (i + 1) * Og)
        z = engine.run_window_plan_reference(xi, wi, plan=lin)
        with torch.enable_grad():
            zz = z.requires_grad_(True)
            bb = b[o].detach().requires_grad_(True)
            gz, db = torch.autograd.grad(
                adjoint.apply_epilogue(p, zz, (bb,)), (zz, bb), gy[:, o])
        dws.append(engine.run_weight_grad_plan_reference(xi, gz, plan=lin))
        dxs.append(engine.run_window_plan_reference(
            gz, adjoint.adjoint_coeff_array(lin, wi), plan=aplan))
        dbs.append(db)
    return torch.cat(dxs, 1), torch.cat(dws, 0), torch.cat(dbs)


def mxu_perlane_phase(args, dev, card, results) -> dict:
    """Phase 12: K2's per-lane path, ``conv1d_causal(strategy="mxu")``, at
    Hymba's conv shape (2, 2048, 3200), K = 4: (a) the op's forward and
    backward once with bias+SiLU (the main path: K2 the forward, the
    recomputed pre-activation and dx, K4 dW, K1 never), its gradients
    against autograd through the plain versions; (b) the forward with
    bias+SiLU, the linear forward, bias+SiLU+residual and dx, fp32 and
    bf16, each against the plain mxu version and K1's per-lane path; (c)
    their times beside the byte bound, the plain version, K1's per-lane
    path and the library call (``F.conv1d(groups=D)`` + the ops,
    ``conv1d_input``)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import convert
    from repro_torch.core import adjoint, engine
    from repro_torch.core.plan import normalize_epilogue
    from repro_torch.kernels import ops, ssam_conv1d

    K1, K2 = engine.WINDOW_KERNEL, engine.MXU_KERNEL
    K4 = engine.PERLANE_WGRAD_KERNEL
    rng = np.random.default_rng(args.seed + 12)

    def put(*shape, scale=1.0):
        return convert.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32), dev)

    B, T, D, K = HYMBA_BATCH, HYMBA_SEQ, HYMBA_DI, HYMBA_K
    x, g, r = put(B, T, D), put(B, T, D), put(B, T, D)
    w, b = put(K, D, scale=K ** -0.5), put(D, scale=0.1)

    # -- (a) the main path: the op forward and backward, counted ----------
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    K1.launches = K2.launches = K4.launches = 0

    def op_grads(*ts):
        y = ops.conv1d_causal(ts[0], ts[1], epilogue=("bias", "silu"),
                              epilogue_args=(ts[2],), strategy="mxu")
        return (y,) + torch.autograd.grad(y, ts, g)

    got = op_grads(*leaves)
    torch.cuda.synchronize()
    launches = {"k1": K1.launches, "k2": K2.launches, "k4": K4.launches}
    want = {"k1": 0, "k2": 3,
            "k4": K4.launches_for(x, g, plan=ssam_conv1d.plan_for(K))}
    require(launches == want, ("phase 12 launches", launches, want))
    with _PlainKernels():
        plain = op_grads(*[t.clone().requires_grad_() for t in (x, w, b)])
    worst = 0.0
    for name, kg, pg in zip(("y", "dx", "dw", "db"), got, plain):
        worst = max(worst, compare(
            f"phase 12 conv1d_causal(strategy='mxu') {name}, kernels "
            "against the plain versions", kg, pg, LAYER_RTOL, results))
    del got, plain, leaves

    # -- (b) each case against the plain mxu version and K1 --------------
    p = dataclasses.replace(ssam_conv1d.plan_for(K), strategy="mxu")
    pe = dataclasses.replace(p, epilogue=normalize_epilogue(("bias",
                                                             "silu")))
    pr = dataclasses.replace(p, epilogue=normalize_epilogue(
        ("bias", "silu", "residual_add")))
    adj = adjoint.input_adjoint_plan(p)
    run, ref = engine.run_window_plan, engine.run_window_plan_reference
    elems = B * T * D
    wt = w.T[:, None, :].contiguous()
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        eb = torch.finfo(dt).bits // 8
        xx, gg, rr = x.to(dt), g.to(dt), r.to(dt)
        # the library's layout: channels ahead of time, (B, D, T)
        xt = xx.transpose(1, 2).contiguous()
        gt = F.pad(gg.transpose(1, 2), (0, K - 1)).contiguous()
        rt = rr.transpose(1, 2).contiguous()
        wl, bl = wt.to(dt), b.to(dt)

        def conv(xt=xt, wl=wl, bias=None):
            return F.conv1d(xt, wl, bias, padding=K - 1, groups=D)[..., :T]

        name = "fp32" if dt == torch.float32 else "bf16"
        w_bytes = 4 * K * D
        cases += [
            (f"forward bias+silu {name}", pe, xx, (b,),
             2 * eb * elems + w_bytes + 4 * D,
             lambda conv=conv, bl=bl: F.silu(conv(bias=bl))),
            (f"forward linear {name}", p, xx, (),
             2 * eb * elems + w_bytes, lambda conv=conv: conv()),
            (f"forward bias+silu+residual {name}", pr, xx, (b, rr),
             3 * eb * elems + w_bytes + 4 * D,
             lambda conv=conv, bl=bl, rt=rt: F.silu(conv(bias=bl)) + rt),
            (f"dx, the input-adjoint plan {name}", adj, gg, (),
             2 * eb * elems + w_bytes,
             lambda xt=xt, wl=wl, gt=gt: torch.nn.grad.conv1d_input(
                 xt.shape, wl, gt, padding=K - 1, groups=D)),
        ]
    timed = {}
    probe = parent_probe()
    for tag, pl, inp, ea, nbytes, lib in cases:
        rtol = MXU_PL_RTOL if inp.dtype == torch.float32 else 3e-2

        def kern(pl=pl, inp=inp, ea=ea):
            return run(inp, w, plan=pl, epilogue_args=ea)

        def plain_fn(pl=pl, inp=inp, ea=ea):
            return ref(inp, w, plan=pl, epilogue_args=ea)

        def lanes_fn(pl=pl, inp=inp, ea=ea):
            return run(inp, w, plan=dataclasses.replace(pl, strategy="lanes"),
                       epilogue_args=ea)

        y = kern()
        err = compare(f"phase 12 K2 per-lane {tag}", y, plain_fn(), rtol,
                      results)
        if inp.dtype == torch.float32:
            worst = max(worst, err)
        compare(f"phase 12 K2 per-lane {tag} against K1", y, lanes_fn(),
                MXU_VS_LANES if inp.dtype == torch.float32 else 3e-2,
                results)
        counts = (K1.launches, K2.launches)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = 2 * K * elems / TF32_FLOPS * 1e3
        parent_ms = None
        if probe is not None and hasattr(probe, "run_mxu_perlane"):
            # the parent's kernel (no non-finite check), in turns
            parent_fn = (lambda pl=pl, inp=inp, ea=ea:
                         probe.run_mxu_perlane(inp, w, pl, ea))
            compare(f"phase 12 K2 per-lane {tag} parent kernel",
                    parent_fn(), y, rtol, results)
            k0 = device_ms(kern, 10)
            p0, p1 = device_ms(parent_fn, 10), device_ms(parent_fn, 10)
            ms = (k0 + device_ms(kern, 10)) / 2
            parent_ms = (p0 + p1) / 2
        else:
            ms = device_ms(kern, 20)
        del y
        rec = {"case": f"K2 per-lane conv1d (2,2048,3200) K=4 {tag}",
               "ms": ms, "parent_ms": parent_ms,
               "call_ms": event_ms(kern, 20),
               "k1_ms": device_ms(lanes_fn, 20),
               "plain_ms": device_ms(plain_fn, 3),
               "library_ms": device_ms(lib, 20),
               "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "bytes": nbytes, "roofline_share": max(b_ms, f_ms) / ms,
               "card": card}
        K1.launches, K2.launches = counts
        results["times"].append(rec)
        emit({"phase": "mxu_perlane_time", **rec})
        timed[tag] = rec
    return {"launches": launches["k2"], "worst": worst, "timed": timed,
            "headline": timed["forward bias+silu fp32"]}


def rwkv6_train_phase(args, dev, card, results) -> dict:
    """Phase 13: train rwkv6-1.6b at full width; its WKV runs forward
    through K5 in streamed, checkpointed chunks and backward through K5's
    λ-recurrence in reversed time: (a) layer 0 of the seeded full-width
    model, its output and gradients through the kernels against autograd
    through the plain versions at 1e-4·max|leaf| beside a 1e-7 relative
    perturbation's spread; (b) 6 steps of ``launch.train.main --arch
    rwkv6-1.6b --batch 2 --seq 2048`` (every loss finite, K5 at
    ``models.rwkv6.train_launches`` per step, K1-K4 at 0, step time and
    peak memory); (c) K5's forward chunk and λ-recurrence at the training
    chunk's rows (262144, 64) against their plain versions, timed beside
    their byte bounds; one step timed alone, then the next profiled:
    device time, K5's and the copies' shares, and the idle share of the
    profiled step over its own wall time and over its trace's span."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.core import adjoint, engine, plan
    from repro_torch.data import TokenDataset
    from repro_torch.launch import train
    from repro_torch.models import build_model, rwkv6
    from repro_torch.nn import spec

    kernels = {"k1": engine.WINDOW_KERNEL, "k2": engine.MXU_KERNEL,
               "k3": engine.WGRAD_KERNEL, "k4": engine.PERLANE_WGRAD_KERNEL,
               "k5": engine.SCAN_KERNEL}
    K5 = kernels["k5"]
    rng = np.random.default_rng(args.seed + 13)

    def put(*shape, scale=1.0, low=None):
        a = (rng.uniform(low, 1.0, shape) if low is not None
             else scale * rng.standard_normal(shape))
        return convert.from_numpy(a.astype(np.float32), dev)

    B, T = RWKV6_BATCH, RWKV6_SEQ
    cfg = get_config("rwkv6-1.6b")
    # -- (a) one full-width layer: kernels against the plain versions -------
    model = build_model(cfg, device=dev, seed=args.seed)
    n_params = sum(q.numel() for q in model.parameters())
    require(n_params == spec.param_count(rwkv6.specs(cfg)) == FULL_PARAMS,
            ("rwkv6-1.6b parameters", n_params))
    p0 = model.params["layers"][0]
    leaves0 = list(spec.module_leaves(p0))
    xl, gl = put(B, T, cfg.d_model), put(B, T, cfg.d_model)

    def layer_grads():
        xx = xl.clone().requires_grad_()
        y = model._layer(p0, xx)[0]
        return (y.detach(),) + torch.autograd.grad(
            y, [xx] + [q for _, q in leaves0], gl)

    before = K5.launches
    kern_g = layer_grads()
    torch.cuda.synchronize()
    layer_launches = K5.launches - before
    chunks = -(-T // cfg.wkv_chunk)
    require(layer_launches == 3 * chunks,
            ("one layer's K5 launches (3 a chunk)", layer_launches))
    with _PlainKernels():
        plain_g = layer_grads()
    with torch.no_grad():
        saved = [q.clone() for _, q in leaves0]
        gen = torch.Generator(device=dev).manual_seed(args.seed + 14)
        for _, q in leaves0:
            q.mul_(1 + PERTURB_REL * torch.randn(q.shape, generator=gen,
                                                 device=dev))
    moved_g = layer_grads()
    with torch.no_grad():
        for (_, q), s0 in zip(leaves0, saved):
            q.copy_(s0)
    names = ["y", "x"] + [".".join(map(str, path)) for path, _ in leaves0]
    spread = max(float((m - k).abs().max() / k.abs().max().clamp_min(1e-30))
                 for m, k in zip(moved_g, kern_g))
    layer_worst = 0.0
    for name, kg, pg in zip(names, kern_g, plain_g):
        scale = pg.abs().max().item()
        err = (kg - pg).abs().max().item()
        layer_worst = max(layer_worst, err / max(scale, 1e-30))
        torch.testing.assert_close(
            kg, pg, rtol=0, atol=LAYER_RTOL * scale,
            msg=lambda m, n=name: f"rwkv6 layer 0 {n}: {m}")
    rec = {"case": "rwkv6-1.6b layer 0, full width (2,2048,2048)",
           "leaves": len(names), "worst_rel_to_scale": layer_worst,
           "perturbed_spread_rel": spread, "perturbation": PERTURB_REL,
           "rtol": LAYER_RTOL, "k5_launches": layer_launches, "card": card}
    results["rwkv6_layer"] = rec
    emit({"phase": "rwkv6_layer", **rec})
    del kern_g, plain_g, moved_g, saved, model, p0, leaves0, xl, gl
    torch.cuda.empty_cache()

    # -- (b) the main path: the trainer at full width -------------------------
    argv = ["--arch", "rwkv6-1.6b", "--steps", str(RWKV6_STEPS), "--batch",
            str(B), "--seq", str(T), "--seed", str(args.seed),
            "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {name: k.launches for name, k in kernels.items()}
    per_step = rwkv6.train_launches(cfg, T, B)
    want = {name: RWKV6_STEPS * n for name, n in per_step.items()}
    step_ms = statistics.median(res.step_seconds[1:]) * 1e3
    rec = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "wkv_chunk": cfg.wkv_chunk, "steps": RWKV6_STEPS, "batch": B,
           "seq": T, "losses": res.losses, "grad_norms": res.grad_norms,
           "step_ms": [t * 1e3 for t in res.step_seconds],
           "step_ms_median_after_first": step_ms,
           "samples_per_s": B / step_ms * 1e3,
           "tokens_per_s": B * T / step_ms * 1e3, "run_s": run_s,
           "peak_mem_gb_per_step": res.peak_mem_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": got, "launches_expected": want,
           "launches_per_step": per_step, "card": card}
    results["train_rwkv6"] = rec
    emit({"phase": "train_rwkv6", **rec})
    require(all(np.isfinite(res.losses)), ("non-finite loss", res.losses))
    require(got == want, ("rwkv6 train launches", got, want))

    # -- (c) K5 at the training chunk's rows, and one profiled step ----------
    R, L = B * cfg.n_heads * cfg.head_k * cfg.head_v, cfg.wkv_chunk
    sa, sb, sh0 = put(R, L, low=0.5), put(R, L), put(R, 1)
    lin = plan.linear_recurrence_plan(L)
    abar = adjoint.time_reversed(adjoint.reversed_recurrence_coeffs(sa))
    grev = adjoint.time_reversed(sb)
    worst = 0.0
    timed = {}
    for tag, kern, plain_fn, nbytes in (
            ("K5 WKV training chunk forward with carry (262144,64)",
             lambda: engine.run_scan_plan(sa, sb, plan=lin, carry=sh0),
             lambda: engine.run_scan_plan_reference(sa, sb, plan=lin,
                                                    carry=sh0),
             4 * (3 * R * L + 2 * R)),
            ("K5 WKV training chunk lambda-recurrence, reversed (262144,64)",
             lambda: engine.run_scan_plan(abar, grev, plan=lin),
             lambda: engine.run_scan_plan_reference(abar, grev, plan=lin),
             12 * R * L)):
        n0 = K5.launches
        y, yp = kern(), plain_fn()
        if isinstance(y, tuple):
            y, yp = torch.cat([y[0], y[1]], 1), torch.cat([yp[0], yp[1]], 1)
        worst = max(worst, compare(tag, y, yp, 1e-5, results))
        del y, yp
        ms = device_ms(kern, 20)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"case": tag, "ms": ms, "call_ms": event_ms(kern, 20),
               "plain_ms": device_ms(plain_fn, 3), "library_ms": None,
               "bound_ms": b_ms, "bound_by": "bytes",
               "roofline_share": b_ms / ms, "card": card}
        K5.launches = n0
        results["times"].append(rec)
        emit({"phase": "rwkv6_time", **rec})
        timed["forward" if "forward" in tag else "lambda"] = rec
    model = res.trainer.model
    ds = TokenDataset(cfg.vocab, T, seed=args.seed)
    batch = train.make_batch(model, ds, RWKV6_STEPS, B, dev)
    # the idle share comes from one step: the profiled one's device time
    # over its own wall time (the profiler's host cost included) and over
    # its trace's span; the step before it, on the host clock alone,
    # shows what the profiler adds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = res.trainer.step(batch)
    float(loss)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    before = K5.launches
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss, _ = res.trainer.step(batch)
        float(loss)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3
    rec = {**device_ops(prof, match={"k5": "ssam_scan_kernel",
                                     "copies": "copy"}),
           "launches": {"k5": K5.launches - before},
           "traced_step_host_ms": traced_ms,
           "untraced_step_host_ms": untraced_ms, "card": card}
    rec["idle_share"] = (1 - rec["device_ms"] / traced_ms
                         if rec["device_ms"] else None)
    rec["idle_share_in_span"] = (1 - rec["device_ms"] / rec["span_ms"]
                                 if rec["device_ms"] and rec["span_ms"]
                                 else None)
    results["train_rwkv6_profile"] = rec
    emit({"phase": "train_rwkv6_profile", **rec})
    if rec["device_ms"]:
        require(rec["k5_calls"] == rec["launches"]["k5"],
                ("profiled K5 launches against the counter",
                 rec["k5_calls"], rec["launches"]))
    del res, model
    return {"launches": got["k5"], "per_step": per_step["k5"],
            "worst": max(worst, layer_worst), "step_ms": step_ms,
            "timed": timed}


def pipeline_phase(args, dev, card, results) -> dict:
    """Phase 14: fused plan pipelines through K1's single-channel kernel
    and, pinned to ``strategy="mxu"``, through K2's, a chain of stages in
    one launch, at full size; a chain that no launch holds as the fewest
    launches of its segments. Each case against the plain version on the
    card, the launches counted (K1, K2 and K3 zeroed before the phase's
    main path and read after), the gradients against torch autograd
    through the plain version, and the times beside the byte bound, the
    unfused sequence, the plain version and the library yardstick
    (``F.pad`` once, then a cuDNN call a stage with the stages' filters,
    TF32 off: there is no single PyTorch call for a chain)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import convert
    from repro_torch.core import adjoint, engine, fuse
    from repro_torch.kernels import ops, stencils

    K1, K2, K3 = engine.WINDOW_KERNEL, engine.MXU_KERNEL, engine.WGRAD_KERNEL
    rng = np.random.default_rng(args.seed + 14)

    def randn(*shape, scale=1.0):
        return convert.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32), dev)

    def fused_plan(x, stages, strategy=None):
        res = [ops._pipeline_stage_plan(x, d, i)
               for i, d in enumerate(stages)]
        return (fuse.fuse_plans(*[ops._strategy_plan(p, strategy, "pipeline")
                                  for p, _ in res]),
                tuple(w for _, w in res))

    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "grad": 0.0, "K2 grad": 0.0}
    expected = {"K1": 0, "K2": 0, "K3": 0}

    def run(k1, k3, fn, k2=0):
        b1, b2, b3 = K1.launches, K2.launches, K3.launches
        out = fn()
        torch.cuda.synchronize()
        got = (K1.launches - b1, K2.launches - b2, K3.launches - b3)
        require(got == (k1, k2, k3),
                ("phase 14 launches", got, (k1, k2, k3)))
        expected["K1"] += k1
        expected["K2"] += k2
        expected["K3"] += k3
        return out

    def held(tag, y, plain, rtol, kernel="K1"):
        worst[kernel] = max(worst[kernel], compare(
            f"phase 14 {tag}", y, plain, rtol, results))

    def grads_held(tag, got, want, key="grad"):
        """Gradients at 1e-4·max|leaf| against autograd through the plain
        version."""
        for i, (a, e) in enumerate(zip(got, want)):
            worst[key] = max(worst[key], compare(
                f"phase 14 {tag} grad {i}", a, e, 1e-4, results))

    chain5, chain3 = map(list, PIPELINE_CHAINS)
    big = ["2d121pt"] * 3
    n, n3 = PIPELINE_SIDE, PIPELINE_SIDE3
    x = randn(n, n)
    cells = x.numel()
    p5, w5s = fused_plan(x, chain5)
    pm5, _ = fused_plan(x, chain5, "mxu")
    K1.launches = K2.launches = K3.launches = 0

    # -- (a) the main path: forwards ------------------------------------
    y = run(1, 0, lambda: ops.pipeline(x, chain5))
    plain5 = engine.run_window_plan_reference(x, w5s, plan=p5)
    held("2d5pt+2d9pt+2d5pt fused 8192^2", y, plain5, 3e-5)
    yu = run(3, 0, lambda: ops.pipeline(x, chain5, fuse=False))
    held("2d5pt+2d9pt+2d5pt unfused 8192^2", yu, plain5, 3e-5)
    del y, yu, plain5
    yh = run(1, 0, lambda: ops.pipeline(x, ["2d5pt"] * 3))
    yt = run(1, 0, lambda: ops.stencil(x, "2d5pt", time_steps=3))
    require(torch.equal(yh, yt), "2d5pt x 3 differs from time_steps=3")
    del yh, yt
    w5, w3 = randn(5, 5, scale=0.2), randn(3, 3, scale=1 / 3)
    bias, r = torch.tensor([0.25], device=dev), randn(n, n)
    conv = [(w5, "gelu"), (w3, "bias"), (w5, "residual_add")]
    pc, wcs = fused_plan(x, conv)
    pcm, _ = fused_plan(x, conv, "mxu")
    yc = run(1, 0, lambda: ops.pipeline(x, conv, epilogue_args=(bias, r)))
    plainc = engine.run_window_plan_reference(x, wcs, plan=pc,
                                              epilogue_args=(bias, r))
    held("conv 5x5 gelu + 3x3 bias + 5x5 residual fused 8192^2", yc, plainc,
         3e-5)
    del yc, plainc
    x3 = randn(n3, n3, n3)
    p3, w3s = fused_plan(x3, chain3)
    p3m, _ = fused_plan(x3, chain3, "mxu")
    y3 = run(1, 0, lambda: ops.pipeline(x3, chain3))
    held("3d7pt+3d27pt fused 512^3", y3,
         engine.run_window_plan_reference(x3, w3s, plan=p3), 3e-5)
    del y3
    xb = x.to(torch.bfloat16)
    yb = run(1, 0, lambda: ops.pipeline(xb, chain5))
    held("2d5pt+2d9pt+2d5pt fused bf16 8192^2", yb,
         engine.run_window_plan_reference(xb, w5s, plan=p5), 3e-2)
    ybu = run(3, 0, lambda: ops.pipeline(xb, chain5, fuse=False))
    lead, trail = fuse.summed_lead_trail(p5.stages)
    h = F.pad(xb, (lead[1], trail[1], lead[0], trail[0]))
    for st in p5.stages:      # the unfused sequence's own plain version
        h = engine.run_window_plan_reference(
            h, plan=dataclasses.replace(st, lead=None, trail=None))
    held("2d5pt+2d9pt+2d5pt unfused bf16 8192^2", ybu, h, 3e-2)
    del yb, ybu, h
    torch.cuda.empty_cache()
    # the same chains pinned to the tensor cores: one K2 launch, no K1
    ym = run(0, 0, lambda: ops.pipeline(x, chain5, strategy="mxu"), k2=1)
    plainm5 = engine.run_window_plan_reference(x, w5s, plan=pm5)
    held("mxu 2d5pt+2d9pt+2d5pt fused 8192^2", ym, plainm5, 3e-5, "K2")
    ymu = run(0, 0, lambda: ops.pipeline(x, chain5, strategy="mxu",
                                         fuse=False), k2=3)
    held("mxu 2d5pt+2d9pt+2d5pt unfused 8192^2", ymu, plainm5, 3e-5, "K2")
    del ym, ymu, plainm5
    ycm = run(0, 0, lambda: ops.pipeline(x, conv, strategy="mxu",
                                         epilogue_args=(bias, r)), k2=1)
    held("mxu conv 5x5 gelu + 3x3 bias + 5x5 residual fused 8192^2", ycm,
         engine.run_window_plan_reference(x, wcs, plan=pcm,
                                          epilogue_args=(bias, r)),
         3e-5, "K2")
    del ycm
    y3m = run(0, 0, lambda: ops.pipeline(x3, chain3, strategy="mxu"), k2=1)
    held("mxu 3d7pt+3d27pt fused 512^3", y3m,
         engine.run_window_plan_reference(x3, w3s, plan=p3m), 3e-5, "K2")
    del y3m
    ybm = run(0, 0, lambda: ops.pipeline(xb, chain5, strategy="mxu"), k2=1)
    held("mxu 2d5pt+2d9pt+2d5pt fused bf16 8192^2", ybm,
         engine.run_window_plan_reference(xb, w5s, plan=pm5), 3e-2, "K2")
    del ybm
    # an inf and a nan: the non-finite set is the plain version's
    xn = x.clone()
    xn[n // 3, n // 5] = float("inf")
    xn[n // 2, 7] = float("nan")
    yn = run(0, 0, lambda: ops.pipeline(xn, chain5, strategy="mxu"), k2=1)
    plainn = engine.run_window_plan_reference(xn, w5s, plan=pm5)
    bad = ~torch.isfinite(plainn)
    require(bool(bad.any()) and torch.equal(~torch.isfinite(yn), bad),
            ("phase 14 mxu non-finite set", int((~torch.isfinite(yn)).sum()),
             int(bad.sum())))
    held("mxu 2d5pt+2d9pt+2d5pt inf and nan 8192^2 (finite part)",
         torch.where(bad, 0.0, yn), torch.where(bad, 0.0, plainn), 3e-5,
         "K2")
    nonfinite = int(bad.sum())
    del yn, plainn, bad
    torch.cuda.empty_cache()
    # a chain no launch of K1 holds (33 column steps of 32): its segments,
    # a 2-stage chain and one stage; K2 holds it in one launch
    pb, wbs = fused_plan(x, big)
    pbm, _ = fused_plan(x, big, "mxu")
    require([len(sg) for sg in ops.chain_segments(list(pb.stages))] == [2, 1],
            "2d121pt x 3 does not cut into 2 + 1 on lanes")
    ys = run(2, 0, lambda: ops.pipeline(x, big))
    held("2d121pt x 3 segmented (2 K1 launches) 8192^2", ys,
         engine.run_window_plan_reference(x, wbs, plan=pb), 3e-5)
    del ys
    ysm = run(0, 0, lambda: ops.pipeline(x, big, strategy="mxu"), k2=1)
    held("mxu 2d121pt x 3 fused 8192^2", ysm,
         engine.run_window_plan_reference(x, wbs, plan=pbm), 3e-5, "K2")
    del ysm
    torch.cuda.empty_cache()

    # -- (b) the main path: gradients -----------------------------------
    g = randn(n, n)
    for strategy, tag, key in ((None, "linear chain", "grad"),
                               ("mxu", "mxu linear chain", "K2 grad")):
        mxu = strategy == "mxu"
        xg = x.clone().requires_grad_(True)
        y = run(0 if mxu else 1, 0, lambda: ops.pipeline(
            xg, chain5, strategy=strategy), k2=int(mxu))
        (dx,) = run(0 if mxu else 1, 0, lambda: torch.autograd.grad(
            y, xg, g), k2=int(mxu))
        xr = x.clone().requires_grad_(True)
        want = torch.autograd.grad(engine.run_window_plan_reference(
            xr, w5s, plan=pm5 if mxu else p5), xr, g)
        grads_held(tag, (dx,), want, key)
        del y, dx, want, xr
        torch.cuda.empty_cache()
    k3 = sum(K3.launches_for(h_, g_, plan=p_) for h_, g_, p_ in
             _chain_wgrads(x, pc))
    for strategy, tag, key in ((None, "conv chain", "grad"),
                               ("mxu", "mxu conv chain", "K2 grad")):
        mxu = strategy == "mxu"
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, w5, w3, bias, r)]
        xl, w5l, w3l, bl, rl = leaves
        conv_l = [(w5l, "gelu"), (w3l, "bias"), (w5l, "residual_add")]
        y = run(0 if mxu else 1, 0, lambda: ops.pipeline(
            xl, conv_l, strategy=strategy, epilogue_args=(bl, rl)),
            k2=int(mxu))
        # the stages recomputed and a dx a stage: 6 launches, K3 a dW
        got = run(0 if mxu else 6, k3, lambda: torch.autograd.grad(
            y, leaves, g), k2=6 if mxu else 0)
        del y
        torch.cuda.empty_cache()
        ref_leaves = [t.detach().clone().requires_grad_(True)
                      for t in leaves]
        xr, w5r, w3r, br, rr = ref_leaves
        yr = engine.run_window_plan_reference(
            xr, (w5r, w3r, w5r), plan=pcm if mxu else pc,
            epilogue_args=(br, rr))
        want = torch.autograd.grad(yr, ref_leaves, g)
        grads_held(tag, got, want, key)
        del yr, want, got, ref_leaves, leaves, xl
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {"K1": K1.launches, "K2": K2.launches, "K3": K3.launches}
    emit({"phase": "pipeline_launches", **launches, "expected": expected})
    require(launches == expected, ("phase 14 launches", launches, expected))
    torch.cuda.empty_cache()

    # -- (c) times ----------------------------------------------------------
    rows = {}

    def time_case(tag, fused, unfused, plain, lib, lib_label, bytes_, flops,
                  peak=FP32_FLOPS, k1_ms=None):
        """``peak``: the operations' rate (K2's counted once at TF32's,
        the fp32 bound beside)."""
        counts = (K1.launches, K2.launches, K3.launches)
        b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        f_ms = flops / peak * 1e3
        rec = {"case": tag, "ms": device_ms(fused, SURFACE_REPS),
               "unfused_ms": (device_ms(unfused, SURFACE_REPS)
                              if unfused else None),
               "plain_ms": event_ms(plain, 1),
               "library_ms": event_ms(lib, SURFACE_REPS),
               "library": lib_label,
               "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "fp32_bound_ms": max(b_ms, flops / FP32_FLOPS * 1e3),
               "k1_ms": k1_ms, "card": card}
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
        K1.launches, K2.launches, K3.launches = counts
        rows[tag] = rec
        results["times"].append(rec)
        emit({"phase": "time", **rec})
        return rec

    def flops(p, n):
        return sum(2 * sum(len(s.taps) for s in st.steps) - 1
                   for st in p.stages) * n

    def lib_chain(xx, sds, pads_all):
        """F.pad by the summed pads, then one valid cuDNN correlation a
        stage."""
        conv_fn = F.conv2d if xx.ndim == 2 else F.conv3d
        flat = [v for lo_hi in reversed(pads_all) for v in lo_hi]
        yy = F.pad(xx[None, None], flat)
        for wt in sds:
            yy = conv_fn(yy, wt[None, None])
        return yy[0, 0]

    def lib_of(names):
        wts = [dense_filter(stencils.BENCHMARKS[n], dev) for n in names]
        pads = [tuple(sum(p[a][i] for _, p in wts) for i in (0, 1))
                for a in range(len(wts[0][1]))]
        return [w for w, _ in wts], pads

    wt5, pads5 = lib_of(chain5)
    headline = time_case(
        "2d5pt+2d9pt+2d5pt fp32 8192^2",
        lambda: ops.pipeline(x, chain5),
        lambda: ops.pipeline(x, chain5, fuse=False),
        lambda: engine.run_window_plan_reference(x, w5s, plan=p5),
        lambda: lib_chain(x, wt5, pads5), "F.pad + 3 x F.conv2d (3 calls)",
        2 * cells * 4, flops(p5, cells))
    ap5 = adjoint.input_adjoint_plan(p5)
    back = time_case(
        "2d5pt+2d9pt+2d5pt backward (one launch of the reversed chain) "
        "fp32 8192^2",
        lambda: engine.run_window_plan(g, (None,) * 3, plan=ap5),
        None,
        lambda: engine.run_window_plan_reference(g, (None,) * 3, plan=ap5),
        lambda: lib_chain(g, [torch.flip(w, (0, 1)) for w in wt5[::-1]],
                          [tuple(reversed(pd)) for pd in pads5]),
        "F.pad + 3 x F.conv2d (3 calls)", 2 * cells * 4, flops(ap5, cells))
    time_case(
        "2d5pt x 3 (time_steps=3 beside) fp32 8192^2",
        lambda: ops.pipeline(x, ["2d5pt"] * 3),
        lambda: ops.stencil(x, "2d5pt", time_steps=3),
        lambda: engine.run_window_plan_reference(
            x, (None,) * 3, plan=fused_plan(x, ["2d5pt"] * 3)[0]),
        lambda: library_padded(x, *dense_filter(
            stencils.BENCHMARKS["2d5pt"], dev), 3),
        "F.pad + 3 x F.conv2d (3 calls)", 2 * cells * 4,
        flops(fused_plan(x, ["2d5pt"] * 3)[0], cells))
    (ly, lx), (ty, tx) = fuse.summed_lead_trail(pc.stages)

    def lib_conv():
        yy = F.pad(x[None, None], [lx, tx, ly, ty])
        yy = F.gelu(F.conv2d(yy, w5[None, None]), approximate="tanh")
        yy = F.conv2d(yy, w3[None, None]) + bias
        return F.conv2d(yy, w5[None, None])[0, 0] + r

    conv_rec = time_case(
        "conv 5x5 gelu + 3x3 bias + 5x5 residual fp32 8192^2",
        lambda: ops.pipeline(x, conv, epilogue_args=(bias, r)),
        lambda: ops.pipeline(x, conv, fuse=False, epilogue_args=(bias, r)),
        lambda: engine.run_window_plan_reference(x, wcs, plan=pc,
                                                 epilogue_args=(bias, r)),
        lib_conv, "F.pad + 3 x F.conv2d + the elementwise ops",
        3 * cells * 4, flops(pc, cells))
    wt3, pads3 = lib_of(chain3)
    rec3 = time_case(
        "3d7pt+3d27pt fp32 512^3",
        lambda: ops.pipeline(x3, chain3),
        lambda: ops.pipeline(x3, chain3, fuse=False),
        lambda: engine.run_window_plan_reference(x3, w3s, plan=p3),
        lambda: lib_chain(x3, wt3, pads3), "F.pad + 2 x F.conv3d (2 calls)",
        2 * x3.numel() * 4, flops(p3, x3.numel()))
    recb = time_case(
        "2d5pt+2d9pt+2d5pt bf16 8192^2",
        lambda: ops.pipeline(xb, chain5),
        lambda: ops.pipeline(xb, chain5, fuse=False),
        lambda: engine.run_window_plan_reference(xb, w5s, plan=p5),
        lambda: lib_chain(xb, [w.to(torch.bfloat16) for w in wt5], pads5),
        "F.pad + 3 x F.conv2d (3 calls, bf16)", 2 * cells * 2,
        flops(p5, cells))
    wtb, padsb = lib_of(big)
    time_case(
        "2d121pt x 3 segmented (2 K1 launches; unfused 3) fp32 8192^2",
        lambda: ops.pipeline(x, big),
        lambda: ops.pipeline(x, big, fuse=False),
        lambda: engine.run_window_plan_reference(x, wbs, plan=pb),
        lambda: lib_chain(x, wtb, padsb), "F.pad + 3 x F.conv2d (3 calls)",
        2 * cells * 4, flops(pb, cells))
    # K2's chains: the operations counted once at the TF32 rate, the fp32
    # bound beside; K1's fused chain of the same case beside
    mxu_rows = {}

    def time_mxu(tag, *a, k1_ms=None, **kw):
        mxu_rows[tag] = time_case("mxu " + tag, *a, peak=TF32_FLOPS,
                                  k1_ms=k1_ms, **kw)

    time_mxu("2d5pt+2d9pt+2d5pt fp32 8192^2",
             lambda: ops.pipeline(x, chain5, strategy="mxu"),
             lambda: ops.pipeline(x, chain5, strategy="mxu", fuse=False),
             lambda: engine.run_window_plan_reference(x, w5s, plan=pm5),
             lambda: lib_chain(x, wt5, pads5),
             "F.pad + 3 x F.conv2d (3 calls)", 2 * cells * 4,
             flops(pm5, cells), k1_ms=headline["ms"])
    apm5 = adjoint.input_adjoint_plan(pm5)
    time_mxu("2d5pt+2d9pt+2d5pt backward (one K2 launch of the reversed "
             "chain) fp32 8192^2",
             lambda: engine.run_window_plan(g, (None,) * 3, plan=apm5),
             None,
             lambda: engine.run_window_plan_reference(g, (None,) * 3,
                                                      plan=apm5),
             lambda: lib_chain(g, [torch.flip(w, (0, 1))
                                   for w in wt5[::-1]],
                               [tuple(reversed(pd)) for pd in pads5]),
             "F.pad + 3 x F.conv2d (3 calls)", 2 * cells * 4,
             flops(apm5, cells), k1_ms=back["ms"])
    time_mxu("conv 5x5 gelu + 3x3 bias + 5x5 residual fp32 8192^2",
             lambda: ops.pipeline(x, conv, strategy="mxu",
                                  epilogue_args=(bias, r)),
             lambda: ops.pipeline(x, conv, strategy="mxu", fuse=False,
                                  epilogue_args=(bias, r)),
             lambda: engine.run_window_plan_reference(
                 x, wcs, plan=pcm, epilogue_args=(bias, r)),
             lib_conv, "F.pad + 3 x F.conv2d + the elementwise ops",
             3 * cells * 4, flops(pcm, cells), k1_ms=conv_rec["ms"])
    time_mxu("3d7pt+3d27pt fp32 512^3",
             lambda: ops.pipeline(x3, chain3, strategy="mxu"),
             lambda: ops.pipeline(x3, chain3, strategy="mxu", fuse=False),
             lambda: engine.run_window_plan_reference(x3, w3s, plan=p3m),
             lambda: lib_chain(x3, wt3, pads3),
             "F.pad + 2 x F.conv3d (2 calls)", 2 * x3.numel() * 4,
             flops(p3m, x3.numel()), k1_ms=rec3["ms"])
    time_mxu("2d5pt+2d9pt+2d5pt bf16 8192^2",
             lambda: ops.pipeline(xb, chain5, strategy="mxu"),
             lambda: ops.pipeline(xb, chain5, strategy="mxu", fuse=False),
             lambda: engine.run_window_plan_reference(xb, w5s, plan=pm5),
             lambda: lib_chain(xb, [w.to(torch.bfloat16) for w in wt5],
                               pads5),
             "F.pad + 3 x F.conv2d (3 calls, bf16)", 2 * cells * 2,
             flops(pm5, cells), k1_ms=recb["ms"])
    time_mxu(f"2d5pt+2d9pt+2d5pt with an inf and a nan ({nonfinite} "
             "non-finite outputs) fp32 8192^2",
             lambda: ops.pipeline(xn, chain5, strategy="mxu"), None,
             lambda: engine.run_window_plan_reference(xn, w5s, plan=pm5),
             lambda: lib_chain(xn, wt5, pads5),
             "F.pad + 3 x F.conv2d (3 calls)", 2 * cells * 4,
             flops(pm5, cells))
    time_mxu("2d121pt x 3 (one K2 launch; unfused 3) fp32 8192^2",
             lambda: ops.pipeline(x, big, strategy="mxu"),
             lambda: ops.pipeline(x, big, strategy="mxu", fuse=False),
             lambda: engine.run_window_plan_reference(x, wbs, plan=pbm),
             lambda: lib_chain(x, wtb, padsb),
             "F.pad + 3 x F.conv2d (3 calls)", 2 * cells * 4,
             flops(pbm, cells),
             k1_ms=rows["2d121pt x 3 segmented (2 K1 launches; unfused 3) "
                        "fp32 8192^2"]["ms"])
    k1_rows = {tag: rec for tag, rec in rows.items()
               if not tag.startswith("mxu ")}
    return {"launches": launches, "worst": worst, "rows": k1_rows,
            "mxu_rows": mxu_rows, "headline": headline,
            "mxu_headline": mxu_rows["2d5pt+2d9pt+2d5pt fp32 8192^2"]}


def _chain_wgrads(x, plan):
    """``(h, g, plan)`` shapes of each dW a fused chain's backward runs:
    the 'valid' stage plans on the pad-once intermediates (empty tensors
    on x's device, for ``launches_for``)."""
    import dataclasses

    import torch

    from repro_torch.core import fuse

    lead, trail = fuse.summed_lead_trail(plan.stages)
    cur = tuple(n + l + t for n, l, t in zip(x.shape, lead, trail))
    out = []
    for st in plan.stages:
        nxt = tuple(n - e + 1 for n, e in zip(cur, st.exts))
        if st.coeff_mode == "dense":
            out.append((torch.empty(cur, device=x.device),
                        torch.empty(nxt, device=x.device),
                        dataclasses.replace(st, lead=None, trail=None,
                                            epilogue=())))
        cur = nxt
    return out


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


def library_padded(x, wt, pads, t: int = 1):
    """F.pad (t-fold), then t valid cuDNN correlations: the pad-once
    semantics of t fused steps; at t = 1 two calls, but cuDNN picks faster
    algorithms for them than for a padded call."""
    import torch.nn.functional as F

    conv = F.conv2d if x.ndim == 2 else F.conv3d
    flat = [t * v for lo_hi in reversed(pads) for v in lo_hi]
    y = F.pad(x[None, None], flat)
    for _ in range(t):
        y = conv(y, wt[None, None])
    return y[0, 0]


def parent_probe():
    """The module ``build/parent/probe.py`` where a probe of earlier kernels
    was built into the checkout (never committed), else None. It may offer
    ``run(x, w, plan, time_steps, variant)`` (an earlier K1 single-channel
    kernel, phase 5), ``run_mxu(x, w, plan, time_steps)`` (an earlier K2
    single-channel kernel, phase 9), ``run_perlane(x, w, plan,
    epilogue_args)`` (an earlier K1 per-lane kernel, phase 10),
    ``run_wgrad(x, g, plan)`` (an earlier K3 single-channel kernel, phase
    8) and ``run_mxu_perlane(x, w, plan, epilogue_args)`` (an earlier K2
    per-lane kernel, phase 12)."""
    import importlib.util

    path = os.path.join(ROOT, "build", "parent", "probe.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("parent_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _surface(surf, kname) -> dict:
    """Phase 11's cases of one kernel as the kernel line carries them:
    its launches and largest error there, and per case the times."""
    return {"launches": surf["launches"][kname],
            "max_abs_err": surf["worst"][kname],
            "cases": {tag: {**_row(rec), "unfused_ms": rec["unfused_ms"]}
                      for tag, rec in surf["rows"][kname].items()}}


def _depthwise(surf, kname) -> dict:
    """Phase 11's depthwise cases as the kernel line carries them under
    K1 (forward and backward) and K3 (dW), each with the launches its
    op's call made in the run, beside the parent's per-group route (K1)."""
    out = {}
    for label, recs in surf["depthwise"].items():
        if kname == "K3":
            out[label] = {**_row(recs["dW"]),
                          "launches": recs["dW"]["launches"],
                          "max_abs_err": surf["worst"]["K3"]}
            continue
        out[label] = {
            key: {**_row(recs[key]), "launches": recs[key]["launches"],
                  "max_abs_err": surf["worst"]["K1"],
                  "per_group_ms": recs[key]["per_group_ms"]}
            for key in ("forward", "backward")}
    return out


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
    parser.add_argument("--profile-train-step", action="store_true",
                        help=argparse.SUPPRESS)   # phases 8/9's fresh process
    parser.add_argument("--profile-strategy", default="lanes",
                        choices=("lanes", "mxu"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.profile_train_step:
        return profile_step_main(args.seed, args.profile_strategy)
    import torch.nn.functional as F

    from repro_torch import _build, convert
    from repro_torch.core import engine, fuse
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
                        **ptxas_summary(_build.LIBRARY.ptxas_log),
                        # K3's channel path: wgmma (HGMMA) fed by TMA
                        # (UTMALDG) in its SASS
                        "wgrad_tc_sass": sass_counts(
                            str(_build.LIBRARY.path), "wgrad_tc_kernel",
                            ("HGMMA", "UTMALDG"))}
    # K1's reduce path: its registers and spills (ptxas -v), and its FFMAs
    # and shared loads in SASS (every instantiation summed)
    reduce_build = results["build"]["by_source"]["ssam_window_reduce.cu"]
    results["build"]["window_reduce_sass"] = sass_counts(
        str(_build.LIBRARY.path), "window_reduce_kernel",
        ("FFMA", "LDS", "LDGSTS"))
    # K2's channel path: wgmma (HGMMA) on TMA-staged tiles (UTMALDG), the
    # fragments gathered by shared loads (LDS), no spills
    mxu_build = results["build"]["by_source"]["ssam_mxu_tc.cu"]
    mxu_sass = sass_counts(str(_build.LIBRARY.path), "mxu_tc_kernel",
                           ("HGMMA", "UTMALDG", "LDS", "STS"))
    results["build"]["mxu_tc_sass"] = mxu_sass
    # K2's single-channel path: each instantiation (the plan's largest
    # entry, 1-4 k-steps; one of 4 for the strided plans; 1-4 for fused
    # pipelines, key suffix 1), its registers and spills, its mma.sync (HMMA)
    # on TMA-staged tiles (UTMALDG) and its fragment loads (LDS), no spills;
    # K1's per-lane path: each instance's registers and its 16-byte global
    # accesses (the cp.async ring's LDGSTS, STG.E.128, LDG.E.128)
    mxu_single = {}
    for key, rec in ptxas_entries(
            _build.LIBRARY.ptxas_log,
            r".*mxu_window_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)E").items():
        kk, s, ch, st = key.split("x")
        mxu_single[key] = {**rec, "sass": sass_counts(
            str(_build.LIBRARY.path),
            f"mxu_window_kernelILi{kk}ELb{s}ELb{ch}ELb{st}E",
            ("HMMA", "HGMMA", "UTMALDG", "LDS", "LDGSTS"))}
    results["build"]["mxu_single_channel"] = mxu_single
    perlane = ptxas_entries(_build.LIBRARY.ptxas_log,
                            r".*window_perlane_kernelILi(\d)ELi(\d)E"
                            r"NS_\d+(Epi\w*?)E+vNS_11PerlaneArgsE")
    results["build"]["window_perlane"] = {
        "instances": perlane, "sass": sass_counts(
            str(_build.LIBRARY.path), "window_perlane_kernel",
            ("LDG.E.128", "STG.E.128", "LDGSTS", "LDS.128"))}
    # K2's per-lane path: each instance's (fp32, bf16) registers and
    # spills, its mma.sync (HMMA), its 16-byte shared loads of the fragments
    # and its cp.async copies
    mxu_perlane = ptxas_entries(_build.LIBRARY.ptxas_log,
                                r".*mxu_perlane_kernelILb(\d)E")
    results["build"]["mxu_perlane"] = {
        "instances": mxu_perlane, "sass": sass_counts(
            str(_build.LIBRARY.path), "mxu_perlane_kernel",
            ("HMMA", "LDS.128", "LDGSTS", "STG.E.128"))}
    # K3's single-channel path: each width bucket's registers and spills,
    # and its FMAs, shared loads and TMA loads in SASS (all summed)
    wgrad_rows = ptxas_entries(
        _build.LIBRARY.ptxas_log,
        r".*wgrad_rows_kernelILb(\d)ELi(\d+)ELi\d+ELb(\d)E")
    results["build"]["wgrad_rows"] = {
        "instances": wgrad_rows, "sass": sass_counts(
            str(_build.LIBRARY.path), "wgrad_rows_kernel",
            ("FFMA", "LDS", "UTMALDG", "SHFL"))}
    emit({"phase": "build", **results["build"], "card": card})
    require(len(wgrad_rows) == 4 * len(engine.WGRAD_M_BUCKETS) and all(
        r["spill_store_bytes"] == 0 for r in wgrad_rows.values()),
        ("K3's single-channel kernel spills or lacks an instance",
         wgrad_rows))
    require(len(mxu_single) == 13 and all(
        r["spill_store_bytes"] == 0 and (r["sass"] is None or (
            r["sass"]["HMMA"] > 0 and r["sass"]["UTMALDG"] > 0))
        for r in mxu_single.values()),
        ("K2's single-channel kernel spills, lacks HMMA or TMA loads",
         mxu_single))
    require(len(perlane) >= 4 and all(r["spill_store_bytes"] == 0
                                       for r in perlane.values()),
            ("K1's per-lane kernel spills", perlane))
    mpl_sass = results["build"]["mxu_perlane"]["sass"]
    require(len(mxu_perlane) == 2 and all(
        r["spill_store_bytes"] == 0 for r in mxu_perlane.values())
        and (mpl_sass is None or mpl_sass["HMMA"] > 0),
        ("K2's per-lane kernel spills or lacks HMMA", mxu_perlane, mpl_sass))
    require(reduce_build["kernels"] >= 1
            and reduce_build["max_spill_store_bytes"] == 0,
            ("K1's reduce kernel spills", reduce_build))
    require(mxu_build["kernels"] >= 1
            and mxu_build["max_spill_store_bytes"] == 0
            and mxu_sass is not None and mxu_sass["HGMMA"] > 0,
            ("K2's channel kernel spills or has no HGMMA", mxu_build,
             mxu_sass))

    def stencil_plan(sd):
        mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
        return mod.plan_for(sd)

    # K1's single-channel path: each instantiation (N, D, P) that phases
    # 2-5 launch, its registers and spills (ptxas -v), and its TMA loads,
    # shuffles, FMAs and jump-table branches in SASS
    # (and the output-strided instantiations phase 11 launches: N the
    # bucket of the cache's ceil(N / sh) rows, engine.window_rows, key
    # suffix 1)
    k1_plans = [stencil_plan(sd) for sd in stencils.BENCHMARKS.values()] + [
        ssam_conv2d.plan_for((k, k), "same") for k in CONV_SIZES] + [
        dataclasses.replace(ssam_conv2d.plan_for((5, 5), mode), stride=st)
        for mode, st in SURFACE_STRIDES] + [
        fuse.fuse_plans(*[stencil_plan(stencils.BENCHMARKS[n])
                          for n in chain])
        for chain in PIPELINE_CHAINS + (("2d5pt",) * 3, ("2d121pt",) * 2)] + [
        ssam_conv2d.plan_for(nm, "same") for nm in LARGE_FILTERS + (
            (3, 33),)]
    k1_used = sorted({
        (engine.window_rows(p), engine.window_inst(p)[0],
         engine.window_p(p),
         512 if p.ndim_spatial == 3 else 256,
         int(any(v > 1 for v in p.stride_per_axis())), int(bool(p.stages)),
         int(engine.banded(p)))
        for p in k1_plans})
    k1_regs = ptxas_entries(
        _build.LIBRARY.ptxas_log,
        r".*window_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi\d+ELb(\d)ELb(\d)"
        r"ELb(\d)E")
    k1_build = {}
    for n, d, pr, threads, s, ch, bd in k1_used:
        key = f"{n}x{d}x{pr}x{s}x{ch}x{bd}"
        k1_build[key] = {**k1_regs.get(key, {}), "sass": sass_counts(
            str(_build.LIBRARY.path),
            f"window_kernelILi{n}ELi{d}ELi{pr}ELi{threads}ELb{s}ELb{ch}"
            f"ELb{bd}E", ("UTMALDG", "LDGSTS", "SHFL", "FFMA", "BRX"))}
    results["build"]["window_single_channel"] = k1_build
    emit({"phase": "build_k1", "instantiations": k1_build, "card": card})
    for key, rec in k1_build.items():
        require("registers" in rec and rec["spill_store_bytes"] == 0
                and (rec["sass"] is None or rec["sass"]["UTMALDG"] > 0),
                (f"K1 single-channel kernel {key} (N x D x P x strided x "
                 "chain x banded) "
                 "spills or "
                 "has no TMA load", rec))

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

    # -- 5. times --------------------------------------------------------------
    probe = parent_probe()

    def bound(in_elems, out_elems, elem_bytes, flops):
        b_ms = (in_elems + out_elems) * elem_bytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS * 1e3
        return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")

    def record(tag, kernel_fn, plain_fn, x, wt, pads, in_elems, out_elems,
               flops, t=1, parent_fn=None):
        b_ms, by = bound(in_elems, out_elems, 4, flops)
        rec = {"case": tag, "parent_ms": None, "parent_call_ms": None}
        if not parent_fn:
            k_ms = device_ms(kernel_fn, TIME_REPS)
        else:           # in turns: kernel, parent, parent, kernel
            y, y_parent = kernel_fn(), parent_fn()
            compare(tag + " parent kernel", y_parent, y, 3e-5, results)
            del y, y_parent
            half = TIME_REPS // 2
            k0 = device_ms(kernel_fn, half)
            p0, p1 = device_ms(parent_fn, half), device_ms(parent_fn, half)
            k_ms = (k0 + device_ms(kernel_fn, half)) / 2
            rec["parent_ms"] = (p0 + p1) / 2
            rec["parent_call_ms"] = event_ms(parent_fn, TIME_REPS)
        rec.update({
            "ms": k_ms, "call_ms": event_ms(kernel_fn, TIME_REPS),
            "plain_ms": event_ms(plain_fn, 3),
            "library_ms": (event_ms(lambda: library(x, wt, pads), TIME_REPS)
                           if t == 1 else None),
            "library_pad_then_conv_ms": event_ms(
                lambda: library_padded(x, wt, pads, t), TIME_REPS),
            "bound_ms": b_ms, "bound_by": by,
            "gcells_per_s": out_elems / k_ms / 1e6,
            "hbm_share": (in_elems + out_elems) * 4
            / (k_ms * 1e-3) / HBM_BYTES_PER_S,
            "roofline_share": b_ms / k_ms, "card": card})
        results["times"].append(rec)
        emit({"phase": "time", **rec})
        single[tag] = rec
        return rec

    single = {}     # phase 5's rows by case, K2's yardsticks in phase 9
    headline = None
    for name, sd in stencils.BENCHMARKS.items():
        x = grids[sd.ndim]
        plan = stencil_plan(sd)
        wt, pads = dense_filter(sd, dev)
        cells = x.numel()
        for t in (1, 2):
            for variant in engine.VARIANTS:
                rec = record(
                    f"{name} {variant} t={t}",
                    lambda: ops.stencil(x, name, time_steps=t,
                                        variant=variant),
                    lambda: engine.run_window_plan_reference(
                        x, plan=plan, time_steps=t, variant=variant),
                    x, wt, pads, cells, cells,
                    t * (2 * len(sd.offsets) - 1) * cells, t,
                    probe and hasattr(probe, "run") and (
                        lambda: probe.run(x, None, plan, t, variant)))
                if name == "2d5pt" and variant == "shift_psum" and t == 1:
                    headline = rec
    x = grids[2]
    for k, w in filters.items():
        plan = ssam_conv2d.plan_for((k, k), "same")
        pads = [((k - 1) // 2, k - 1 - (k - 1) // 2)] * 2
        record(f"conv2d {k}x{k} same",
               lambda: ops.conv2d(x, w, mode="same"),
               lambda: engine.run_window_plan_reference(x, w, plan=plan),
               x, w, pads, x.numel(), x.numel(), (2 * k * k - 1) * x.numel(),
               1, probe and hasattr(probe, "run") and (
                   lambda: probe.run(x, w, plan, 1, "shift_psum")))

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
    mxu = mxu_phase(args, dev, card, results, trained, single)
    torch.cuda.empty_cache()
    marks.append(("10 train hymba-1.5b", time.perf_counter()))
    hy = hymba_phase(args, dev, card, results)
    torch.cuda.empty_cache()
    marks.append(("11 epilogues, residuals, strides, groups",
                  time.perf_counter()))
    surf = surface_phase(args, dev, card, results)
    torch.cuda.empty_cache()
    marks.append(("12 K2 per-lane conv1d", time.perf_counter()))
    mpl = mxu_perlane_phase(args, dev, card, results)
    torch.cuda.empty_cache()
    marks.append(("13 train rwkv6-1.6b", time.perf_counter()))
    rw = rwkv6_train_phase(args, dev, card, results)
    torch.cuda.empty_cache()
    marks.append(("14 fused pipelines", time.perf_counter()))
    pipe = pipeline_phase(args, dev, card, results)
    torch.cuda.empty_cache()
    marks.append(("15 large filters", time.perf_counter()))
    big = large_filter_phase(args, dev, card, results)
    marks.append(("end", time.perf_counter()))
    results["phase_seconds"] = {name: t1 - t0 for (name, t0), (_, t1)
                                in zip(marks, marks[1:])}
    emit({"phase": "phase_seconds", **results["phase_seconds"]})

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    wkv = scan["headline"]
    k3h, k1t = trained["k3_headline"], trained["k1_headline"]
    k3r = trained["k3_rows"]
    k2h, k2t = mxu["headline"], mxu["stem_headline"]
    emit({"kernels": [{
        "name": K1.name, "route": "cuda", "source": K1.source,
        "replaces": K1.replaces, "launches": launches,
        "max_abs_err": worst["abs"], "ms": headline["ms"],
        "call_ms": headline["call_ms"], "parent_ms": headline["parent_ms"],
        "plain_ms": headline["plain_ms"], "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "case": headline["case"] + " 8192x8192 fp32",
        "train": {"launches": trained["k1_launches"],
                  "max_abs_err": trained["worst"]["K1"], "ms": k1t["ms"],
                  "plain_ms": k1t["plain_ms"], "bound_ms": k1t["bound_ms"],
                  "bound_by": k1t["bound_by"],
                  "library_ms": k1t["library_ms"], "case": k1t["case"],
                  **{key: _row(next(r for r in results["times"]
                                    if r["case"].startswith(prefix)))
                     for key, prefix in (
                         ("conv2_forward", "K1 conv2 forward"),
                         ("conv1_forward", "K1 conv1 forward"),
                         ("dx_scattered", "K1 conv2 dx, scattered"))}},
        "hymba": {"launches": hy["launches"]["k1"],
                  "max_abs_err": hy["worst"]["K1"],
                  **_row(hy["timed"]["K1"]),
                  "parent_ms": hy["timed"]["K1"]["parent_ms"],
                  "dx": {**_row(hy["timed"]["K1 dx"]),
                         "parent_ms": hy["timed"]["K1 dx"]["parent_ms"]},
                  "forward_linear": {
                      **_row(hy["timed"]["K1 linear"]),
                      "parent_ms": hy["timed"]["K1 linear"]["parent_ms"]}},
        "surface": _surface(surf, "K1"),
        "depthwise": _depthwise(surf, "K1"),
        "pipeline": {"launches": pipe["launches"]["K1"],
                     "max_abs_err": pipe["worst"]["K1"],
                     "grad_max_abs_err": pipe["worst"]["grad"],
                     "cases": {tag: {**_row(rec),
                                     "unfused_ms": rec["unfused_ms"],
                                     "library": rec["library"]}
                               for tag, rec in pipe["rows"].items()}},
        "large_filters": _large(big, "K1")},
        {
        "name": K5.name, "route": "cuda", "source": K5.source,
        "replaces": K5.replaces, "launches": served["k5_launches"],
        "max_abs_err": scan["worst_abs"], "ms": wkv["ms"],
        "plain_ms": wkv["plain_ms"], "bound_ms": wkv["bound_ms"],
        "bound_by": wkv["bound_by"], "library_ms": wkv["library_ms"],
        "case": wkv["case"],
        "hymba": {"launches": hy["launches"]["k5"],
                  "max_abs_err": hy["worst"]["K5"],
                  **_row(hy["timed"]["K5"])},
        "rwkv6_train": {"launches": rw["launches"],
                        "launches_per_step": rw["per_step"],
                        "max_abs_err": rw["worst"],
                        "step_ms": rw["step_ms"],
                        **_row(rw["timed"]["lambda"]),
                        "forward": _row(rw["timed"]["forward"])}}, {
        "name": K3.name, "route": "cuda", "source": K3.source,
        "replaces": K3.replaces, "launches": trained["k3_launches"],
        "max_abs_err": trained["worst"]["K3"], "ms": k3h["ms"],
        "plain_ms": k3h["plain_ms"], "bound_ms": k3h["bound_ms"],
        "bound_by": k3h["bound_by"], "library_ms": k3h["library_ms"],
        "case": k3h["case"], "fp32_bound_ms": k3h["fp32_bound_ms"],
        "library_tf32_ms": k3h["library_tf32_ms"],
        "conv1": {**_row(trained["k3_conv1"]),
                  "fp32_bound_ms": trained["k3_conv1"]["fp32_bound_ms"],
                  "library_tf32_ms": trained["k3_conv1"]["library_tf32_ms"]},
        "single_channel": {
            "source": K3.single_channel_source,
            "launches": k3r["step"]["k3_launches"],
            "max_abs_err": k3r["worst"], **_row(k3r["headline"]),
            "call_ms": k3r["headline"]["call_ms"],
            "parent_ms": k3r["headline"]["parent_ms"],
            "case": k3r["headline"]["case"],
            "cases": {tag: {**_row(r), "parent_ms": r["parent_ms"]}
                      for tag, r in k3r["rows"].items()}},
        "surface": _surface(surf, "K3"),
        "depthwise": _depthwise(surf, "K3"),
        "pipeline": {"launches": pipe["launches"]["K3"]},
        "large_filters": _large(big, "K3")},
        {
        "name": K2.name, "route": "cuda", "source": K2.source,
        "replaces": K2.replaces, "launches": mxu["train_launches"],
        "max_abs_err": max(mxu["worst"]["stem"], mxu["worst"]["edge"]),
        "ms": k2t["ms"], "plain_ms": k2t["plain_ms"],
        "bound_ms": k2t["bound_ms"], "bound_by": k2t["bound_by"],
        "library_ms": k2t["library_ms"], "case": k2t["case"],
        "fp32_bound_ms": k2t["fp32_bound_ms"],
        "library_tf32_ms": k2t["library_tf32_ms"], "k1_ms": k2t["k1_ms"],
        **{key: {**_row(rec), "k1_ms": rec["k1_ms"],
                 "library_tf32_ms": rec["library_tf32_ms"]}
           for key, rec in mxu["stem_rows"].items()},
        "single_channel": {"source": K2.single_channel_source,
                           "launches_checks": mxu["launches"],
                           "max_abs_err": mxu["worst"]["abs"], **_row(k2h),
                           "call_ms": k2h["call_ms"], "k1_ms": k2h["k1_ms"],
                           "parent_ms": k2h["parent_ms"],
                           "case": k2h["case"] + " 8192x8192 fp32"},
        "surface": _surface(surf, "K2"),
        "pipeline": {"source": K2.chain_source,
                     "replaces": K2.chain_replaces,
                     "launches": pipe["launches"]["K2"],
                     "max_abs_err": pipe["worst"]["K2"],
                     "grad_max_abs_err": pipe["worst"]["K2 grad"],
                     **_row(pipe["mxu_headline"]),
                     "k1_ms": pipe["mxu_headline"]["k1_ms"],
                     "cases": {tag: {**_row(rec),
                                     "unfused_ms": rec["unfused_ms"],
                                     "k1_ms": rec["k1_ms"],
                                     "fp32_bound_ms": rec["fp32_bound_ms"],
                                     "library": rec["library"]}
                               for tag, rec in pipe["mxu_rows"].items()}},
        "large_filters": {**_large(big, "K2"),
                          "source": "src/repro_torch/csrc/ssam_mxu_stream.cu",
                          "nonfinite": big["nonfinite"]}},
        {
        "name": K4.name, "route": "cuda", "source": K4.source,
        "replaces": K4.replaces, "launches": hy["launches"]["k4"],
        "max_abs_err": hy["worst"]["K4"], **_row(hy["timed"]["K4"])}, {
        "name": "ssam_mxu_perlane", "route": "cuda",
        "source": K2.perlane_source, "replaces": K2.perlane_replaces,
        "launches": mpl["launches"], "max_abs_err": mpl["worst"],
        **_row(mpl["headline"]), "call_ms": mpl["headline"]["call_ms"],
        "k1_ms": mpl["headline"]["k1_ms"],
        "parent_ms": mpl["headline"]["parent_ms"],
        "cases": {tag: {**_row(rec), "call_ms": rec["call_ms"],
                        "k1_ms": rec["k1_ms"], "parent_ms": rec["parent_ms"]}
                  for tag, rec in mpl["timed"].items()}}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
