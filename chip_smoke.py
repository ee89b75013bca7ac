#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Environment: the card's name and power limit, the CUDA version, whether
   ``triton`` imports, ``nvcc``, the build of the kernels from
   ``src/repro_torch/kernels/csrc/`` into ``build/``, every kernel
   instance's registers and spills, and the tensor-core (``HMMA``,
   ``HGMMA``) and ``FFMA`` instructions of each attention and fold-conv
   instance in its SASS (``cuobjdump -sass``): the bf16 attention
   instances and every tensor-core fold instance (``ws_tc_kernel``,
   ``os_tc_kernel``, ``psum_tc_kernel``) must hold ``HMMA``, and no FFMA
   ``ws_kernel``, ``os_kernel`` or ``psum_kernel`` instance may take bf16
   operands; for each of the 36 fixed-tap depthwise instances, whether it
   issues every ``LDG`` before its first ``FFMA`` (fp32 and bf16; int8's
   taps are IMADs).
2. Kernels: each CUDA kernel (WS, OS, depthwise) against its plain-torch
   version on the card over random shapes and every epilogue the zoo
   models fuse, grouped 1 < G < C included (the JAX tests' shapes and
   ResNeXt-50 32x4d's grouped 3x3), then the kernel, its plain version and
   ``torch.nn.functional.conv2d`` timed (device time) at the 13 VGG-16
   layer shapes, at every conv of full-width MobileNetV2 and ResNet-18 at
   32x32, batch 4, and at the ResNeXt layer beside
   ``F.conv2d(groups=32)``; the dense head kernel against its plain
   version at every head shape of the main paths (VGG-16's three fc
   layers at 224, its fc1 at 32, the ResNet-18 and MobileNetV2
   classifiers), row i bitwise across batch widths 1, 2, 4 and 8, with
   each layer's K chunks, CTAs and a checksum of its outputs (equal
   across commits that keep the sum order), one device kernel per call
   (the nodes of a captured CUDA graph), and timed beside ``torch.addmm``
   at batch 1 and 4.
   ``[dw strips]``: the depthwise kernel at every strip it has (TQ 2, 4,
   8 outputs a thread along Q; 2, 4 under the pool) on phase 2's
   depthwise geometries and MobileNetV2's 17 depthwise layers at 32,
   batch 4 and 1: bitwise across strips and batch widths, against the
   plain version, each zoo layer's strips timed beside ``dw_geometry``'s
   pick (again in int8 in phase 9 and in bf16 in ``[bf16]``).
3. Full-width VGG-16 at 224x224, batch 1 and 4: fold reuse, one WS launch
   per conv and one head launch per dense layer, logits against the
   reference policy, and the conv trunk bitwise-identical across batch
   widths.
4. Full-width VGG-16 at 32x32, batch 4: 2 WS + 11 OS launches per forward.
5. Serving: ``VisionEngine`` at 224 over buckets (1, 2, 4), its bucket
   forwards CUDA graphs (``jit``, the default) and then eager: served
   logits bitwise equal to an eager direct forward.
6. Full-width MobileNetV2 at 32x32 with random batch-norm statistics,
   batch 1 and 4: fold reuse 52/30/22, 17 depthwise + 7 WS + 28 OS
   launches per forward, logits against the reference policy, the conv
   trunk bitwise-identical across batch widths, fused bitwise-equal to
   unfused.
7. Full-width ResNet-18 at 32x32, batch 1 and 4: fold reuse 20/11/9,
   5 WS + 15 OS launches per forward, logits against the reference policy.
8. Serving full-width MobileNetV2 through ``serving_summary`` (what
   ``python -m repro_torch.launch.serve --vision`` runs) over buckets
   (1, 2, 4, 8), jitted and then eager: none lost, served logits bitwise
   equal to an eager direct forward.
9. Int8 kernels: each int8 kernel (WS, OS, depthwise) bitwise against its
   plain version on every requant epilogue the zoo fuses and on the
   grouped layers of phase 2, the psum-staging
   kernel against its plain version (a forced WS spill included), then
   each int8 kernel timed per layer (device time) beside the fp32 kernel,
   the plain version and its int8 bound, and psum staging against the
   in-kernel WS reduction on VGG-16's layers (the paper's Fig. 5).
10. Int8 forwards at full width: VGG-16 at 224 and ResNet-18 and
    MobileNetV2 at 32, batch 1 and 4, one calibrated recipe per model:
    launches per forward equal to the fp32 ones (under the int8 kernels'
    names), logits against the int8 reference policy and against the fp32
    forward (top-1 agreement on a batch of 16).
11. Int8 serving: MobileNetV2 through ``serving_summary(precision=
    "int8")``, jitted and then eager: none lost, served logits bitwise
    equal to an eager direct forward, the int8 trunk bitwise-identical
    across the bucket widths.
12. The psum path: ``ops.conv2d(impl="fold_ws_psum")`` over VGG-16's 13
    layers at 224, batch 1, and the WS spill of an unfused layer, each
    against the plain walk on its own inputs and plan.
12b. foldlint on the card: ``python -m repro_torch.analysis.foldlint
    --model all --device cuda`` at full width, img 32, batch 4, and
    VGG-16 at 224, batch 1: no error finding (graph lint, fusion
    legality, every conv's plan, launch index maps and CTA tile at the
    card's SM count), and the launch audit's fold calls per forward (13
    WS at 224; 2 WS + 11 OS; 5 WS + 15 OS; 17 DW + 7 WS + 28 OS); then
    the ``[verify]`` summary: the host ms each model's first compile
    spent in ``compile_network``'s default ``verify=True``, and the memo
    hits of a recompile.
12c. The serving runtime, at full width.  ``[tune]``:
    ``compile_network(autotune=True, tuning_path=...)`` on VGG-16 at 224
    (batch 1, fp32), MobileNetV2 (batch 4, fp32, the depthwise
    candidates) and ResNet-18 (batch 4, int8): every candidate proven,
    then timed on the card; the tuning's host seconds, each key's race
    (candidates, failures, the analytical pick's ms beside the winner's),
    the tuned forward against the reference policy, jitted bitwise the
    eager one with equal launch counts, its jitted and device ms beside
    the untuned forward's; a fresh cache that loads the file measures
    nothing and gets the same schedules; files tagged ``tpu``, ``cpu`` or
    ``torch-cpu`` load nothing.  ``[serve-runtime]``: MobileNetV2 served
    through ``serving_summary`` over buckets (1, 2, 4, 8), 40 requests,
    tuned, with a metrics registry and a deadline on every 2nd request,
    the tracer off and on: nothing lost, no degraded / failed /
    non-finite batch, every request from the primary rung, bitwise a
    direct forward, the trace and the snapshot valid, the Prometheus text
    parseable, the fold-counter table, images/s, p50 / p99 and the
    runtime's host µs a batch (``metrics_dict()["host_us_per_batch"]``,
    timed inside ``VisionEngine._complete``) beside phase 8's.
    ``[chaos]``: every chaos profile on MobileNetV2 and on
    VGG-16 at 32 (``chaos_summary``: every recovery invariant, the
    profile's counters nonzero, the faults fired equal to the schedule),
    a poisoned request quarantined alone with its batchmates bitwise the
    reference rung's direct forward, a slow dispatch flagged hung and
    served by the primary rung.  Every non-chaos serving phase (5, 8, 11,
    12c) holds 0 degraded, failed and non-finite batches, every request
    served by the primary rung.
12d. ``[bf16]``: each bf16 kernel instance (``fold_conv_{ws,os,dw,
    psum}_bf16``, ``dense_bf16``) against its plain version on phase 2's
    geometries, the head shapes, VGG-16's 13 layers at 224 b1 and
    MobileNetV2's at 32 b4, within one bf16 step of each element
    (``2^-7·|plain|``, the psum staging's widened by its depth folds'
    magnitudes) plus ``1e-4·max(1, max|plain|)``; every tensor-core tile
    of the WS, OS and psum kernels forced through the launcher at g_c =
    1, 3 and 4 with a ragged P, Q and NF; every OS tensor-core tile forced
    on phase 2's geometries (grouped ones included) and on the 54 OS
    layers of VGG-16, ResNet-18 and MobileNetV2 at 32, batch 1 and 4:
    bitwise across tiles and batch widths, and bitwise the same layer and
    plan launched weight-stationary (the WS and OS kernels run one chain
    of 16-tap steps); timed beside the fp32 instance (WS, OS and psum per
    layer with the tile picked, and the FFMA instances' times before the
    redesign), ``F.conv2d`` / ``torch.addmm`` in bf16 and the bf16
    tensor-core bound; then the bf16 main path: VGG-16 at
    224 b1 and MobileNetV2 / ResNet-18 at 32 b4 from ``init_params(dtype=
    torch.bfloat16)``, jitted bitwise eager, one bf16 launch per conv
    and dense layer, bf16 logits within ``3e-2·max(1, max|ref|)`` of the
    bf16 reference policy, ms beside fp32; ``ops.conv2d(impl=
    "fold_ws_psum")`` in bf16 over VGG-16's 13 layers; the bf16 VGG-16
    trunk at 224 bitwise across batch widths 1 and 4; bf16 VGG-16 served
    at 224 by ``VisionEngine`` over buckets (1, 2, 4), as phase 5 serves
    fp32, and bf16 MobileNetV2 at 32 over (1, 2, 4, 8): nothing lost,
    every request from the primary rung, served logits bitwise an eager
    direct forward.
12e. ``[http]``: full-width MobileNetV2 (phase 8's configuration and
    stream, base64 bodies, 8 keep-alive clients) through
    ``launch/server.start_server`` with 2 in-process workers (and again
    with the interpreter's switch interval at 0.1 ms), 1, then one
    ``--spawn`` worker: every 200 from the primary rung and bitwise a
    direct ``EngineWorker`` submission of the same images, ``/stats``
    with 0 lost, a 400, a 413, a 429 or 504, ``/metrics`` parseable and
    ``/metrics.json`` valid, the spawned worker's boot seconds and its
    SIGTERM drain (503 on ``/healthz`` and ``/v1/infer``, exit 0);
    images/s and p50 / p99 over the wire beside phase 8's.
12f. ``[simulator]``: ``simulate_cycles`` and ``stream_counts`` over
    VGG-16's 13 layers on ``PEArray(64, 64)`` with the KIPS model beside
    them (analytical MAVeC cycles), then ``execute_conv_by_folds`` on the
    card for conv3_1 (56x56, b1; 104 fold pairs) within
    ``1e-5·max(1, max|ref|)`` of the fp32 WS kernel on the same operands,
    with the seconds it took.
12g. ``[vgg per-layer]``: full-width VGG-16 at 224, batch 1 and 4,
    through ``vgg.forward`` with ``impl`` fold_ws, fold_os, fold_auto
    (with and without a ``ScheduleCache``), im2col, direct and torch,
    each within ``1e-4·max|ref|`` of the compiled engine's logits; 13
    conv launches (fold_ws: 13 WS, fold_os: 13 OS) and 3 head launches a
    fold forward, 8 schedules / 5 hits with the cache; eager ms of each
    beside the jitted engine's.
13. LM kernels: the causal conv1d kernel bitwise against its plain
    version (fp32 and bf16; zamba2's prefill shape, a ragged D, T = 1,
    K = 1, 2, 3 and 8, T < K - 1, D = 8k + 3 and an x off the 16-byte
    grid (the scalar path), the cache-prefixed form) and the fold-attention
    kernel against its plain version (fp32 and bf16; zamba2's causal case,
    GQA, MQA, a 1024-token window, non-causal, a ragged T, hd 128), and
    one device kernel per attention call.
14. Prefill: zamba2-1.2b at full width, bf16, random weights, B = 2 x
    2048 tokens through ``make_prefill_step``: 38 conv1d launches per
    prefill, prefill ms and prompt tokens/s.
15. Consistency: the same model in fp32, prefill 32 tokens and decode 8,
    against ``forward`` on the 40 within 2e-3·max|logits|.
16. Token serving: ``BatchEngine`` at full width, bf16, batch 4, 8
    requests of 16 prompt and 16 new tokens, its decode step captured as
    one CUDA graph: none lost; decode launches no kernel.  A functional
    check; its tokens/s is no serving rate.  Then the same requests
    through a captured engine and an eager one (``make_decode_step``'s
    functional step): every served token and each decode call's logits
    bitwise equal, the captured engine's cache at fixed addresses, one
    capture; the ``[decode]`` line: the decode step's host ms beside its
    device work (a graph replay) and busy share, captured and eager, its
    graph nodes, and the prompt stepping's ms, captured and eager.
16b. ``[dense lm]``: gemma3-12b at its published config (48 layers, d
    3840, 16 heads of 256, window 1024, 5:1 local:global, ~22 GiB of
    bf16 weights from a seeded generator): prefill B=1 x 1024 (ms,
    prompt tokens/s), then ``BatchEngine`` at batch 4 with
    ``window_cache`` (8 requests of 16 + 16 tokens) captured against
    eager (``decode_capture``: tokens and logits bitwise, 0 lost); the
    ring against the full cache (12 layers, fp32, 1088 positions, the
    rings wrap) within ``2e-3·max|logits|``; llama3-8b, qwen3-4b and
    qwen2.5-14b at full width and 4 layers (fp32): prefill and captured
    decode within ``2e-3·max|logits|`` of ``forward``.  No kernel of the
    port runs on the dense family's path (checked).
16c. ``[lm families]``: the other five LM families, each model freed
    before the next (its parameter count, GiB and peak memory printed),
    no kernel of the port launched on any of their paths (checked):
    rwkv6-1.6b at its published config (24 layers, d 2048, ~3 GiB bf16):
    prefill B=1 x 1024 (ms, prompt tokens/s), its WKV time loop's kernels
    and device ms a layer, ``decode_capture``; at full width and 4
    layers, fp32: prefill 32 + 8 captured decode steps within
    ``2e-3·max|logits|`` of ``forward``, and a time mix split in two
    halves (state and last x carried) against the whole.
    granite-moe-1b-a400m and qwen2-moe-a2.7b at their published configs
    (~28 GiB bf16 for qwen2-moe): prefill B=1 x 1024, ``decode_capture``
    with the B=4 step's device ms beside the whole expert stack's read
    bound; at 4 layers, fp32, capacity factor n_experts / top_k: decode
    against ``forward``.  seamless-m4t-medium at its published config:
    fp32 prefill of 512 source frames and 64 tokens, 8 decode steps on
    the cached cross K/V against ``forward``; bf16 ``decode_capture``.
    internvl2-26b at published widths and 4 layers: fp32 prefill of 256
    patch embeddings and 32 tokens, 8 decode steps against ``forward``
    with the patches; bf16 ``decode_capture``.
16d. ``[train]``: zamba2-1.2b at its published config (1.17B
    parameters, bf16 with fp32 AdamW state, ``remat="full"``: ``none``
    does not fit beside the optimizer state) trained on the synthetic
    ``TokenPipeline`` at B=4 x 1024 under
    ``torch.use_deterministic_algorithms``: 6 steps through ``Trainer``
    (every loss and grad norm finite; step ms, mean and spread of steps
    2-6, tokens/s, peak device memory; 114 conv1d launches a step: 38
    forward, 38 recomputed, 38 dx through the kernel); the restart, a
    ``Trainer`` that checkpoints at step 3 into a temporary directory and
    a new one that restores and runs to 6, bitwise the uninterrupted run
    (parameters, optimizer state, losses); then one step at the seeded
    weights with the kernel against the same step with the plain conv1d
    (``ssm``'s ``conv1d_causal`` swapped for its ``impl="ref"`` form):
    the loss, every gradient and the new parameters bitwise, and every
    parameter leaf's gradient finite and nonzero (a detach would leave
    zeros).  Only the conv1d kernel launches on the path (checked).
16e. ``[fold grads]``: gradients through ``ops.conv2d_fused`` on the
    card for a full-width ResNet-18 basic block (s2b1, 16x16, the
    residual fused) with fold_ws, fold_os and fold_auto, a full-width
    MobileNetV2 inverted residual (b2, 32x32, BN / ReLU6 fused, the
    depthwise on fold_dw, the projection's residual fused), and one conv
    on fold_ws_psum, batch 4, fp32: each within 1e-4 of its max of the
    reference chain's (``impl="direct"``), every fold kernel launched.
16f. ``[mesh vision]`` and ``[mesh lm]``, the scale-out path: VGG-16 at
    its published widths, 224, buckets (2, 4), six requests of 1-4
    images, fp32 then bf16, through the mesh-less engine (CUDA graphs)
    and ``VisionEngine(mesh=make_local_mesh(1, 1))`` over NCCL, logits
    bitwise; zamba2-1.2b's [train] step (B=4 x 1024, the seeded weights,
    the first batch) under ``set_context(mesh, make_rules(cfg, mesh))``
    bitwise the step without a context, and ``compressed_psum`` over the
    batch's whole gradient tree on the one-rank NCCL group bitwise
    ``int8_roundtrip``.  Then two processes on the card, one rank each,
    joined over ``distributed/hostgloo.py``'s group (NCCL refuses two
    ranks on one device; the card's tensors cross through CUDA IPC
    buffers, gloo carries the meetings): VGG-16 on 2x1 (each rank runs
    half of every batch's rows, the logits gathered) and 1x2 (each rank
    holds half of every conv's filters, runs the fold kernel on them and
    gathers the output channels), fp32 and bf16, every rank's logits
    bitwise the mesh-less engine's; MobileNetV2 at its full width and its
    own 32 px (batch-norm statistics drawn as ``randomize_bn`` draws
    them) on 1x2 the same way, fp32 and bf16, which splits the depthwise,
    output- and weight-stationary fold kernels with the batch-norm
    scale / shift and the fused residual sliced alike, each rank's
    depthwise and OS launches above 0; and zamba2-1.2b's 38 mamba2 layers
    as a two-stage GPipe pipeline (4 microbatches of 1 x 512, the conv1d
    kernel in every layer) bitwise the sequential emulation.  Then
    zamba2-1.2b at its published config on 2x1 and 1x2: two steps of
    [train]'s run (bf16, B=4 x 1024, remat full) through
    ``Trainer(mesh=)``, each rank's conv1d launches above 0, the first
    loss within 1e-2·|loss| of [train]'s one-rank first loss, every loss
    and gradient norm finite, and a checkpoint after step 1 restored by a
    fresh mesh ``Trainer`` whose step 2 is bitwise the uninterrupted
    one; two fp32 steps of the model cut to two repeats of its layer
    pattern (14 of 38 layers, full width), B=2 x 256: both losses within
    1e-5·|loss| of the one-rank steps' (the second taken after the first
    update), the first step's first moment within 1e-4 of each leaf's
    max|mu|, its new parameters within 2·lr and within what that error
    can move them; and ``token_serving_summary(mesh=)`` against the
    mesh-less engine: fp32 (B=4, 8 requests, 4-token prompts, 12 new
    tokens) every decode call's logits within 1e-5·max|logits| and every
    next token equal (a one-rank top-2 gap under that bound is reported
    as a tie and its row compared no further), bf16 (4 requests, 2-token
    prompts, 2 new tokens) the first call's logits within 3e-2·max(1,
    max|logits|), 0 lost.  The dry-run's cells run on the
    host's cores meanwhile.  Images/s, step ms, peak GiB, decode ms and
    each rank's kernel launches and collectives are printed; two ranks
    on one card measure no scale-out.
16g. ``[dryrun]``: ``launch/dryrun.run_cell`` on zamba2-1.2b train_4k
    at 16x16 and llama3-8b decode_32k at 2x16x16, each in a subprocess of
    its own on the host's cores (a fake process group of 256 / 512 ranks,
    ``DTensor``s of ``meta`` tensors: nothing reaches the card): per-device
    GiB, the three roofline terms on the H100, the dominant one, the
    collectives and each cell's seconds; a cell that is not ``ok`` fails.
16h. ``[roofline]``: ``op_cost.analyze_step`` over [train]'s own step
    (zamba2-1.2b, B=4 x 1024, remat full, one card) and [dense lm]'s
    captured decode step (gemma3-12b, B=4, window cache), both traced on
    ``meta`` tensors: t_compute, t_memory, the bound and the roofline
    fraction beside the step ms measured in this run, and MFU = model
    flops / (step s x 989 TFLOP/s), with the card's name and power limit
    on the same line.  Neither phase launches a kernel (checked).
16i. ``[elastic]``, the elastic restart (``examples/torch_elastic_
    restart.py``), right after 16f's two ranks have exited: (a) the
    example at its defaults on the card in a process of its own (reduced
    qwen3-4b, 30 steps with checkpoints, rank 217 of 512 declared dead,
    the (16, 16) plan for 508 devices, a fresh ``Trainer`` to step 60),
    rc 0, the JAX demo's dead-rank, plan and ``OK`` lines word for word
    and its loss falling, with its seconds; (b) the survivor of 16f's
    2x1 zamba2-1.2b run (published config, bf16, B=4 x 1024, remat
    full): the example's ``HeartbeatMonitor`` phase over both ranks'
    beats of that run, rank 1 silent after step 2, must declare [1] dead;
    ``solve_elastic_mesh(1, 1, 4, max_per_device_batch=2)`` must give
    mesh (1, 1), per-device batch 2, accumulation 2; then this process
    builds ``make_local_mesh(1, 1)`` and the example's fresh ``Trainer``
    (``n_micro`` 2, remat full), which restores the two ranks' step-1
    checkpoint and runs step 2: its loss within 1e-5·|loss| of the two
    ranks' step 2, its first moment within 5e-2 of each leaf's max|mu| of
    their step-2 checkpoint, each fp32 master weight within the cut fp32
    step's bound (``cut_param_tol``) for that moment's error and each
    bf16 parameter within that plus one bf16 step (bf16 at full width:
    one rank's whole-batch step from the same state, run first for the
    scale, lands 0.23 of max|mu| away, and the survivor's moment
    must be nearer than its), the AdamW step 2, every parameter and
    moment finite, and 228 conv1d
    launches in the step (38 forward, 38 recomputed, 38 dx for each of
    the two microbatches) and no other kernel's.  Restore seconds, step
    ms and peak GiB are printed with the card's name and power limit.
17. The fold-attention op at zamba2's shared-attention shape (no model
    calls it), then both LM kernels timed at the prefill cell's shapes
    (the conv1d on its vector path and on its scalar path),
    then the prefill replayed as a CUDA graph and the prefill and the
    captured decode steps under ``torch.profiler`` (gemma3-12b's prefill
    and decode step, and one decode step of rwkv6-1.6b and of
    qwen2-moe-a2.7b too, and one training step with its busy share
    against ``[train]``'s step time): last, because once the profiler
    has run every kernel of the process reads slower.

Every conv forward of phases 3, 4, 6, 7 and 10 is a compiled network
at the default ``jit`` and ``verify``: its graph, plans, launches and CTA
tiles proven before a kernel is bound (the ``[verify]`` lines), then one
CUDA graph, captured on its first call.  Its
launches are counted on its eager forward (``net.eager``) and on its
capture, which must agree (a replay ticks no counter), and its output
must be bitwise the eager one; each such cell prints the jitted
forward's latency beside the eager forward's and the device work (the
eager forward replayed as a CUDA graph), and the ``[jit]`` lines sum
them up with the served images/s of phases 5, 8 and 11, jitted beside
eager.

Each main path is driven with the kernel launch counts set to 0 just
before it and read just after: phases 3-8 (fp32, the head kernel's
count too), 10-11 (int8), 12 (psum), 12d (bf16), 12c and 12e (the
serving runtime and HTTP serving; launches tick at warm-ups and
captures), 12g (the per-layer VGG-16 path), 14-16 (the LM path), 16b
(the dense family, which launches no kernel), 16c (the other families,
none either: every kernel's count), 16d (training: the conv1d kernel
only, forward and backward), 16e (the fold convs' gradients), 16f (the
scale-out path: the parent's one-rank phases, and each rank's own
counts, reported by its process), 16i (the survivor's restart step:
the conv1d kernel only), 16g-16h (the dry-run and the roofline: none),
17 (the attention op).  The second-to-last
line is a JSON object with one entry per kernel; the last line is ``{"ok": true, "device": {...}}``.  Details
(per-layer times, serving metrics, the compiler's resource report and
the registers and spills of every fold_conv instance) go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import importlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense int8 and
# bf16 on the tensor cores, HBM3 rate
FP32_PEAK = 67e12
INT8_PEAK = 1979e12
BF16_TC_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12
# device ms of the kernels before their redesign, from this script at the
# parent commit on an H100 80GB HBM3 at 700 W, printed beside this run's
# (compare two versions only within one run of both, on one card)
BEFORE_REDESIGN = {"fold_conv_psum": 6.667, "fold_conv_dw": 0.1047,
                   "fold_conv_dw_i8": 0.1019, "dense_b1": 0.1876,
                   "dense_b4": 0.1931, "attention_fold_float32": 2.8094,
                   "attention_fold_bfloat16": 3.09,
                   "conv1d_causal": 0.0889,
                   # the FFMA bf16 instances, VGG-16's 13 layers at 224 b1
                   "fold_conv_ws_bf16": 4.2103,
                   "fold_conv_psum_bf16": 4.0023,
                   # and MobileNetV2's 28 OS layers at 32 b4; the bf16
                   # head's 8-byte loads, VGG-16's fc1-fc3 at 224 b1
                   # (kernel_ab.py, the parent's mean of four runs)
                   "fold_conv_os_bf16": 0.7252, "dense_bf16": 0.1108}
SEED = 0
TOL_KERNEL = 1e-4      # kernel vs plain: two fp32 sums in different orders
TOL_MODEL = 1e-4       # kernel path vs reference policy, over the network
TOL_DENSE = 1e-5       # head kernel vs plain: chunked and unchunked sums
TOL_INT8_REF = 1e-5    # int8 kernel path vs int8 reference, when not bitwise
# int8 vs fp32 forward (the JAX package's gate, tests/test_quant.py)
INT8_TOP1, INT8_SPREAD = 0.98, 0.15


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls between two CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_graph_ms(torch, fn, reps: int) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed between two CUDA events, after one eager warm-up call, so
    the host's dispatch work is out of the time.  ``fn`` runs eagerly
    (a compiled network's ``eager`` forward, never a jitted call, which
    is itself a graph replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_nodes(torch, fn):
    """The nodes of one call of ``fn`` captured as a CUDA graph (after one
    eager warm-up call), counted by ``cuGraphGetNodes`` of ``libcuda``
    (the caching allocator adds no node); None where this torch cannot
    hand the captured graph out.  ``fn`` runs eagerly, as for
    ``time_graph_ms``."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    return count.value if err == 0 else None


def graph_kernels(torch, fn, what):
    """Device kernels in one call of ``fn``, which must be one
    (``graph_nodes``)."""
    nodes = graph_nodes(torch, fn)
    check(nodes in (None, 1), f"{what}: {nodes} kernels in one call")
    return nodes


def bound(flops, nbytes, peak=FP32_PEAK):
    """(bound ms, op ms, byte ms) of one call: its operations over the peak
    rate of their type (fp32 FFMA by default), its bytes (each operand read
    once, the output written once; the input without its zero halo, which
    no conv has to read) over the memory rate."""
    op_ms, byte_ms = 1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_PER_S
    return max(op_ms, byte_ms), op_ms, byte_ms


# bf16: a kernel against its plain version, element by element, within one
# bf16 step of the value (2^-7·|plain|: both round fp32 sums once) plus
# TOL_KERNEL·max(1, max|plain|) for the sums' order
BF16_STEP = 2.0 ** -7
# a whole bf16 forward, kernel policy against the reference policy, which
# rounds to bf16 at other points (the kernels once at each layer's store,
# the reference after the conv and after each epilogue step): the JAX
# package's bf16 conv tolerance (tests/test_kernels.py:58), scaled by
# max(1, max|reference|)
TOL_BF16_MODEL = 3e-2


def bf16_err(torch, got, want, what, extra=None):
    """Hold a bf16 kernel result against its plain version under the bf16
    rule; ``extra`` (psum staging, which rounds each depth fold's partial
    sums to bf16) adds 2^-7 of the folds' magnitudes to each element's
    step.  Returns the largest error."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    mag = w.abs() if extra is None else w.abs() + extra
    lim = BF16_STEP * mag + TOL_KERNEL * max(1.0, w.abs().max().item())
    worst = err.max().item()
    check(got.dtype == want.dtype == torch.bfloat16
          and got.shape == want.shape and bool((err <= lim).all()),
          f"{what}: the bf16 kernel disagrees with its plain version "
          f"(max abs err {worst:.3e})")
    return worst


def epi_operands(torch, gen, dev, epi, n, nf, p, q):
    """Random bias / BN scale and shift / shortcut for an epilogue, as
    keyword arguments of ``conv2d_folded``."""
    ops = {}
    if epi.bias:
        ops["bias"] = torch.randn(nf, device=dev, generator=gen)
    if epi.scale:
        ops["scale"] = 1.0 + 0.2 * torch.randn(nf, device=dev, generator=gen)
        ops["shift"] = 0.2 * torch.randn(nf, device=dev, generator=gen)
    if epi.residual:
        ops["residual"] = torch.randn(n, nf, p, q, device=dev, generator=gen)
    return ops


def randomize_bn(torch, params, seed=7):
    """Non-trivial batch-norm statistics, drawn as the JAX package's
    MobileNetV2 tests draw them (the init statistics are the identity)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for name, leaf in params.items():
        if not name.endswith("_bn"):
            continue
        n, dev = leaf["gamma"].shape[0], leaf["gamma"].device
        draws = {"gamma": 1.0 + 0.2 * rng.standard_normal(n),
                 "beta": 0.2 * rng.standard_normal(n),
                 "mean": 0.3 * rng.standard_normal(n),
                 "var": rng.uniform(0.5, 1.5, n)}
        for k, v in draws.items():
            leaf[k] = torch.as_tensor(v, dtype=leaf[k].dtype, device=dev)
    return params


def phase_environment(torch):
    from repro_torch.kernels import build
    print(f"[env] nvidia-smi: {smi_line()}")
    print(f"[env] torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    try:
        import triton
        print(f"[env] triton {triton.__version__} imports")
    except ImportError as e:
        print(f"[env] triton does not import: {e}")
    print(f"[env] nvcc: {build.nvcc_path()}")
    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    print(f"[env] kernel library {info['path']} built in "
          f"{info['seconds']:.2f} s ({time.perf_counter() - t0:.2f} s "
          "with loading)")
    return {"build_s": info["seconds"], "ptxas": info["ptxas"],
            "fold_conv_resources": kernel_resources(info["ptxas"]),
            "sass": kernel_sass(info["path"])}


def kernel_resources(log: str):
    """Registers and spill bytes of every kernel instance, from the
    compiler's ``-Xptxas -v`` report (names demangled by ``c++filt``
    where it exists)."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"mangled": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    keep = [e for e in out if any(k in e["mangled"] for k in (
        "ws_kernel", "os_kernel", "dw_kernel", "psum_kernel", "_tc_kernel",
        "dense_", "attention_", "conv1d_causal"))]
    for e, name in zip(keep, demangle([e["mangled"] for e in keep])):
        e["name"] = name
    for e in keep:
        print(f"[env] ptxas {e.get('name', e['mangled'])}: "
              f"{e.get('registers')} registers, spill stores "
              f"{e.get('spill_stores')} B, loads {e.get('spill_loads')} B")
    return keep


def demangle(names):
    """``c++filt`` of each name, where it exists; else the names."""
    import shutil
    if not names or not shutil.which("c++filt"):
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


# the kernels whose SASS phase 1 reads, and those that must run on the
# tensor cores
SASS_KERNELS = ("attention_", "ws_kernel", "os_kernel", "psum_kernel",
                "dw_kernel", "ws_tc_kernel", "os_tc_kernel", "psum_tc_kernel")
TC_INSTANCES = ("attention_tc_kernel", "ws_tc_kernel", "os_tc_kernel",
                "psum_tc_kernel")


def kernel_sass(lib_path: str):
    """The tensor-core (HMMA, HGMMA) and FFMA instructions of every
    attention and fold-conv kernel instance in the built library, from
    ``cuobjdump -sass``; fails if a tensor-core instance (bf16 attention,
    the bf16 WS, OS and psum fold kernels) holds no HMMA, if one of them
    is missing, or if an FFMA ``ws_kernel`` / ``os_kernel`` /
    ``psum_kernel`` instance takes bf16 operands.  An empty dict where
    ``cuobjdump`` is not there to ask."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(build.nvcc_path()).parent / "cuobjdump")
    if not pathlib.Path(tool).exists():
        print("[env] cuobjdump not found: SASS not read")
        return {}
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        print(f"[env] cuobjdump -sass failed: {proc.stderr.strip()[:200]}")
        return {}
    counts, cur, at = {}, None, 0
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(k in m.group(1)
                                    for k in SASS_KERNELS) else None
            if cur:
                counts[cur] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0, "LDG": 0,
                               "last_ldg": None, "first_ffma": None}
                at = 0
            continue
        if cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            at += 1
            m = re.search(r"\s(HMMA|HGMMA|FFMA|LDG)\b", line)
            if m:
                counts[cur][m.group(1)] += 1
                if m.group(1) == "LDG":
                    counts[cur]["last_ldg"] = at
                elif m.group(1) == "FFMA":
                    counts[cur]["first_ffma"] = counts[cur]["first_ffma"] or at
    names = demangle(list(counts))
    out = {}
    for mangled, name in zip(counts, names):
        out[name] = counts[mangled]
        if "attention_" in name or "bfloat16" in name or any(
                k in name for k in TC_INSTANCES):
            # the fp32 / int8 fold instances are in the report only
            print(f"[env] SASS {name}: HMMA {counts[mangled]['HMMA']}, "
                  f"HGMMA {counts[mangled]['HGMMA']}, FFMA "
                  f"{counts[mangled]['FFMA']}")
        if any(k in name for k in TC_INSTANCES):
            check(counts[mangled]["HMMA"] + counts[mangled]["HGMMA"] > 0,
                  f"{name} runs no tensor-core instruction")
        check(not (any(f"::{k}<" in name for k in (
                       "ws_kernel", "os_kernel", "psum_kernel"))
                   and "bfloat16" in name),
              f"{name}: an FFMA fold instance on bf16 operands")
    for k in TC_INSTANCES:
        check(any(k in n for n in out), f"no {k} instance in the SASS")
    # the fixed-tap depthwise instances (KR > 0): whether each issues
    # every load before its first multiply-add (FFMA for fp32 and bf16;
    # int8's are IMADs, which SASS does not tell from address arithmetic).
    # ptxas moves a few loads past the first FFMAs in some of them; a CTA
    # fence that forbids it made no layer faster and the forward slower
    # (PERF.md), so this is read, not required
    fixed = {n: c for n, c in out.items() if re.search(
        r"dw_kernel<[^>]*, 3, 3, [12], \d, (true|false)>", n)}
    check(len(fixed) == 36, f"expected 36 fixed-tap depthwise instances in "
          f"the SASS, found {len(fixed)}")
    ffma = {n: c for n, c in fixed.items() if c["first_ffma"] is not None}
    late = {n: c for n, c in ffma.items() if c["last_ldg"] > c["first_ffma"]}
    print(f"[env] SASS dw_kernel: {len(fixed)} fixed-tap instances, "
          f"{len(ffma)} with FFMA taps (fp32, bf16), {len(ffma) - len(late)} "
          f"of them with every LDG before the first FFMA; the others "
          + ", ".join(f"{n.split('dw_kernel')[1].split('(')[0]} "
                      f"({c['LDG']} LDG, last at {c['last_ldg']}, first "
                      f"FFMA at {c['first_ffma']})" for n, c in late.items()))
    return out


def check_kernel(torch, cw, name, x, w, errs, what, **kw):
    """One launch of a kernel against its plain version on the same
    inputs, within TOL_KERNEL·max(1, max|plain|)."""
    before = cw.launch_counts()[name]
    got = cw.conv2d_folded(x, w, **kw)
    torch.cuda.synchronize()
    check(cw.launch_counts()[name] == before + 1, f"{name} did not launch")
    want = cw.conv2d_folded_plain(x, w, **kw)
    err = (got - want).abs().max().item()
    tol = TOL_KERNEL * max(1.0, want.abs().max().item())
    print(f"[kernels] {name} {what} epi={kw.get('epilogue')} "
          f"max_abs_err={err:.3e} (tol {tol:.3e})")
    check(got.shape == want.shape and err <= tol,
          f"{name} disagrees with its plain version")
    errs[name] = max(errs[name], err)


def phase_kernels(torch, dev):
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.mapping import ConvBlockPlan
    from repro_torch.kernels import conv2d_ws as cw

    id_, br, brp = (Epilogue(), Epilogue(bias=True, relu=True),
                    Epilogue(bias=True, relu=True, pool="max2"))
    sc, sc6, scr, brr = (Epilogue(scale=True),
                         Epilogue(scale=True, relu6=True),
                         Epilogue(scale=True, residual=True),
                         Epilogue(bias=True, residual=True, relu=True))
    # (n, c, h, w, nf, r, s, stride, pad, epilogue, forced plan or None)
    cases = [
        (1, 3, 32, 32, 64, 3, 3, 1, 1, br, None),           # C = 3
        (3, 16, 13, 10, 20, 3, 3, 1, 1, brp, None),         # odd P, pool
        (1, 24, 12, 21, 12, 3, 3, 1, 1, id_, None),         # ragged Q
        (3, 40, 18, 18, 30, 3, 3, 1, 1, brp,                # g_c = 3
         ConvBlockPlan(nf_block=24, c_block=16, p_block=5, grid=(2, 3, 4),
                       vmem_bytes=0)),
        (3, 8, 17, 15, 9, 5, 5, 2, 2, id_, None),           # stride 2, 5x5
        (1, 256, 28, 28, 256, 3, 3, 1, 1, brp, None),       # VGG conv4-ish
        (3, 33, 9, 7, 13, 3, 3, 1, 1, br,                   # g_c = 2, ragged
         ConvBlockPlan(nf_block=8, c_block=17, p_block=3, grid=(2, 2, 3),
                       vmem_bytes=0)),
        # the epilogues ResNet-18 and MobileNetV2 fuse
        (4, 96, 16, 16, 24, 1, 1, 1, 0, sc, None),          # project
        (4, 32, 32, 32, 192, 1, 1, 1, 0, sc6, None),        # expand
        (3, 40, 9, 11, 24, 1, 1, 1, 0, scr, None),          # project + skip
        (3, 33, 9, 7, 13, 3, 3, 1, 1, scr,                  # g_c = 2 + skip
         ConvBlockPlan(nf_block=8, c_block=17, p_block=3, grid=(2, 2, 3),
                       vmem_bytes=0)),
        (4, 64, 16, 16, 128, 3, 3, 2, 1, br, None),         # stride-2 3x3
        (4, 128, 8, 8, 128, 3, 3, 1, 1, brr, None),         # residual block
        (4, 64, 16, 16, 128, 1, 1, 2, 0, Epilogue(bias=True), None),
        # every step at once: no zoo layer fuses it
        (3, 33, 9, 7, 13, 3, 3, 1, 1,
         Epilogue(bias=True, scale=True, residual=True, relu6=True),
         ConvBlockPlan(nf_block=8, c_block=17, p_block=3, grid=(2, 2, 3),
                       vmem_bytes=0)),
    ]
    # depthwise: (n, c, h, w, stride, epilogue, forced c_block or None);
    # c_pad > C where the c_block does not divide C
    dw_cases = [
        (4, 96, 32, 32, 1, sc6, None),
        (4, 144, 32, 32, 2, sc6, None),                     # stride 2, even
        (2, 24, 15, 15, 2, sc6, None),                      # stride 2, odd
        (3, 40, 9, 11, 1, scr, None),                       # odd, skip
        (4, 960, 4, 4, 1, sc6, None),                       # c_pad 1024
        (4, 576, 8, 8, 2, id_, None),                       # c_pad 1024, s2
        (2, 20, 11, 10, 1, scr, 8),                         # c_pad 24
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"fold_conv_ws": 0.0, "fold_conv_os": 0.0, "fold_conv_dw": 0.0}
    for (n, c, h, w_, nf, r, s, st, pad, epi, plan) in cases:
        x = torch.randn(n, c, h + 2 * pad, w_ + 2 * pad, device=dev,
                        generator=gen)
        w = torch.randn(nf, c, r, s, device=dev, generator=gen)
        p, q = (h + 2 * pad - r) // st + 1, (w_ + 2 * pad - s) // st + 1
        ops = epi_operands(torch, gen, dev, epi, n, nf, p, q)
        for name, df in (("fold_conv_ws", "weight_stationary"),
                         ("fold_conv_os", "output_stationary")):
            check_kernel(torch, cw, name, x, w, errs,
                         f"n={n} c={c} {h}x{w_} nf={nf} {r}x{s}/s{st}",
                         stride=st, plan=plan, dataflow=df, epilogue=epi,
                         **ops)
    for (n, c, h, w_, st, epi, c_b) in dw_cases:
        x = torch.randn(n, c, h + 2, w_ + 2, device=dev, generator=gen)
        w = torch.randn(c, 1, 3, 3, device=dev, generator=gen)
        p, q = (h - 1) // st + 1, (w_ - 1) // st + 1
        plan = None if c_b is None else ConvBlockPlan(
            nf_block=c_b, c_block=c_b, p_block=4, grid=(1, -(-c // c_b), 1),
            vmem_bytes=0, groups=c)
        check_kernel(torch, cw, "fold_conv_dw", x, w, errs,
                     f"n={n} c={c} {h}x{w_} 3x3/s{st}", stride=st,
                     plan=plan, dataflow="depthwise", epilogue=epi,
                     groups=c, **epi_operands(torch, gen, dev, epi, n, c,
                                              p, q))
    for (n, c, h, nf, g, r, st, pad, epi) in grouped_cases():
        x = torch.randn(n, c, h + 2 * pad, h + 2 * pad, device=dev,
                        generator=gen)
        w = torch.randn(nf, c // g, r, r, device=dev, generator=gen)
        p = (h + 2 * pad - r) // st + 1
        ops = epi_operands(torch, gen, dev, epi, n, nf, p, p)
        for name, df in (("fold_conv_ws", "weight_stationary"),
                         ("fold_conv_os", "output_stationary")):
            check_kernel(torch, cw, name, x, w, errs,
                         f"grouped n={n} c={c} {h}x{h} nf={nf} G={g} "
                         f"{r}x{r}/s{st}", stride=st, dataflow=df,
                         epilogue=epi, groups=g, **ops)
    # the same geometries serve the int8 phase
    return errs, cases, dw_cases


DW_NAMES = {"float32": "fold_conv_dw", "int8": "fold_conv_dw_i8",
            "bfloat16": "fold_conv_dw_bf16"}


def dw_operands(torch, gen, dev, dtype, n, c, h, w_, st, epi, plan):
    """A depthwise layer's operands in ``dtype`` (int8: quantized, with
    its requant vectors), its input padded by 1: (x, w, keyword arguments
    of ``conv2d_folded``)."""
    pad = torch.nn.functional.pad
    x = torch.randn(n, c, h, w_, device=dev, generator=gen)
    w = torch.randn(c, 1, 3, 3, device=dev, generator=gen)
    p, q = (h - 1) // st + 1, (w_ - 1) // st + 1
    kw = dict(stride=st, plan=plan, dataflow="depthwise", groups=c)
    if dtype == torch.int8:
        xq, wq, ops = int8_operands(torch, gen, dev, x, w, epi, n, c, p, q)
        return pad(xq, (1, 1, 1, 1)), wq, {**kw, **ops}
    ops = epi_operands(torch, gen, dev, epi, n, c, p, q)
    if dtype == torch.bfloat16:
        ops = {k: v.to(dtype) for k, v in ops.items()}
        w = w / 3.0
    return (pad(x, (1, 1, 1, 1)).to(dtype), w.to(dtype),
            {**kw, "epilogue": epi, **ops})


def dw_strips(torch, dev, cw, x, w, kw, what, reps=0):
    """One depthwise launch at every strip the kernel has for it
    (``dw_tq_choices``): bitwise across strips, at x's batch and at batch
    1 (its first image), and against the plain version (fp32 within
    TOL_KERNEL·max(1, max|plain|), bf16 under the bf16 rule, int8
    bitwise).  With ``reps``, each strip's device time at x's batch.
    Returns (max abs err against the plain version, {tq: ms}, the strip
    ``dw_geometry`` picks)."""
    name = DW_NAMES[str(x.dtype).split(".")[-1]]
    outs, ms = {}, {}
    for n in (x.shape[0], 1):
        xn = x[:n].contiguous()
        kwn = {k: (v[:n].contiguous() if k == "residual" else v)
               for k, v in kw.items()}
        spec, *ops = cw.prepare(xn, w, kwn["stride"], kwn.get("plan"),
                                "depthwise", kwn.get("bias"),
                                kwn["epilogue"], kwn["groups"],
                                kwn.get("residual"), kwn.get("scale"),
                                kwn.get("shift"))
        for tq in cw.dw_tq_choices(spec):
            before = cw.launch_counts()[name]
            got = cw._finish(spec, cw.launch_dw(spec, *ops, tq=tq))
            torch.cuda.synchronize()
            check(cw.launch_counts()[name] == before + 1,
                  f"{name} did not launch")
            ref = outs.setdefault(n, got)
            check(torch.equal(got, ref), f"{name} {what} b{n}: strip {tq} "
                  "is not bitwise the other strips")
            if n == x.shape[0] and reps:
                ms[tq] = time_graph_ms(
                    torch, lambda: cw.launch_dw(spec, *ops, tq=tq), reps)
        if n == x.shape[0]:
            picked = cw.dw_geometry(spec, n, cw._sm_count(dev), x.dtype).tq
    check(torch.equal(outs[x.shape[0]][:1], outs[1]),
          f"{name} {what}: batch 1 is not bitwise the batch's first image")
    want = cw.conv2d_folded_plain(x, w, **kw)
    got = outs[x.shape[0]]
    if x.dtype == torch.bfloat16:
        err = bf16_err(torch, got, want, f"{name} {what}")
    else:
        err = (got.float() - want.float()).abs().max().item()
        tol = 0.0 if x.dtype == torch.int8 else \
            TOL_KERNEL * max(1.0, want.abs().max().item())
        check(got.shape == want.shape and err <= tol
              and (x.dtype != torch.int8 or torch.equal(got, want)),
              f"{name} {what} disagrees with its plain version "
              f"(max abs err {err:.3e})")
    return err, ms, picked


def phase_dw_strips(torch, dev, dw_cases, dtype):
    """The depthwise kernel in ``dtype`` at every strip (``dw_strips``) on
    phase 2's depthwise geometries and on MobileNetV2's 17 depthwise
    layers at 32, batch 4 and 1, each strip of the zoo layers timed
    (device time): which strip ``dw_geometry`` picks beside the fastest.
    Returns (max abs err, per-layer rows)."""
    from repro_torch.core.mapping import ConvBlockPlan
    from repro_torch.kernels import conv2d_ws as cw
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    tag = str(dtype).split(".")[-1]
    err, launches0 = 0.0, cw.launch_counts()[DW_NAMES[tag]]
    for (n, c, h, w_, st, epi, c_b) in dw_cases:
        plan = None if c_b is None else ConvBlockPlan(
            nf_block=c_b, c_block=c_b, p_block=4, grid=(1, -(-c // c_b), 1),
            vmem_bytes=0, groups=c)
        x, w, kw = dw_operands(torch, gen, dev, dtype, n, c, h, w_, st, epi,
                               plan)
        err = max(err, dw_strips(torch, dev, cw, x, w, kw,
                                 f"n={n} c={c} {h}x{w_} 3x3/s{st}")[0])
    rows = []
    for name, sched, cv, epi in model_layers("mobilenetv2", 32, 4):
        if sched.dataflow != "depthwise":
            continue
        x, w, kw = dw_operands(torch, gen, dev, dtype, cv.n, cv.c, cv.x,
                               cv.y, cv.stride, epi, sched.plan)
        e, ms, picked = dw_strips(torch, dev, cw, x, w, kw, name, reps=10)
        err = max(err, e)
        rows.append({"layer": name, "c": cv.c, "h": cv.x,
                     "stride": cv.stride, "picked": picked,
                     "fastest": min(ms, key=ms.get), "ms": ms})
    check(len(rows) == 17, "expected 17 depthwise layers in MobileNetV2")
    picked = sum(r["ms"][r["picked"]] for r in rows)
    best = sum(min(r["ms"].values()) for r in rows)
    print(f"[dw strips] {tag}: every strip bitwise the others at the batch "
          f"and at batch 1, within the plain version's rule "
          f"({len(dw_cases)} geometries, 17 MobileNetV2 layers at b4 and b1, "
          f"{cw.launch_counts()[DW_NAMES[tag]] - launches0} launches), max "
          f"abs err {err:.3e}; ms a strip (TQ), b4: "
          + ", ".join(f"{r['layer']} " + "/".join(
              f"{t}:{v:.4f}" for t, v in r["ms"].items())
              + f" (picked {r['picked']})" for r in rows)
          + f"; picked sum {picked:.4f} ms, fastest sum {best:.4f}")
    return err, rows


def grouped_cases():
    """Grouped 1 < G < C layers: (n, c, h, nf, G, r, stride, pad,
    epilogue).  The JAX package's grouped shapes (tests/test_mobilenet.py's
    three, tests/test_quant.py's int8 one) and ResNeXt-50 32x4d's
    first-stage grouped 3x3 (C = NF = 128, G = 32, 56x56; arXiv:1611.05431,
    Table 1) with its BN + ReLU."""
    from repro_torch.core.epilogue import Epilogue
    br = Epilogue(bias=True, relu=True)
    return [(2, 8, 13, 16, 4, 3, 1, 1, br),
            (2, 12, 17, 12, 3, 3, 2, 1,
             Epilogue(bias=True, relu=True, pool="max2")),
            (2, 6, 8, 18, 2, 1, 1, 0, Epilogue(scale=True, residual=True)),
            (2, 8, 6, 8, 2, 3, 1, 1, br),
            (1, 128, 56, 128, 32, 3, 1, 1, Epilogue(scale=True, relu=True))]


def head_shapes():
    """(label, K, N) of every dense layer the main paths run, each shape
    once: VGG-16's fc1-fc3 at 224 and its fc1 at 32, the ResNet-18 and
    MobileNetV2 classifiers at 32 (full width)."""
    import torch
    from repro_torch.models import mobilenet, resnet, vgg
    out, seen = [], set()
    for label, module, img in (("vgg16_224", vgg, 224), ("vgg16_32", vgg, 32),
                               ("resnet18_32", resnet, 32),
                               ("mobilenetv2_32", mobilenet, 32)):
        params = module.init_params(torch.Generator(), img=img, device="meta")
        for name in sorted(k for k in params if k.startswith("fc")):
            k, n = (int(d) for d in params[name]["w"].shape)
            if (k, n) not in seen:
                seen.add((k, n))
                out.append((f"{label} {name}", k, n))
    return out


def phase_dense(torch, dev, dtype=None):
    """The head kernel against its plain version at every head shape of
    the main paths, batch 8, 4, 2 and 1: within TOL_DENSE·max|plain|, and
    row i of each narrower batch bitwise equal to row i of the batch of
    8; then one call at batch 1, which must be one device kernel
    (``graph_kernels``).  Prints each layer's K chunks and groups, its
    CTAs and a checksum of its batch-8 outputs (the inputs are seeded, so
    two commits with one sum order print one checksum).  Returns the
    largest error and the checksums."""
    import hashlib
    from repro_torch.kernels import dense as dn
    dtype = dtype or torch.float32
    half = dtype == torch.bfloat16
    name = dn.KERNEL_BF16 if half else dn.KERNEL
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    err, sums = 0.0, {}
    for label, k, n in head_shapes():
        w = (torch.randn(k, n, device=dev, generator=gen) / k ** 0.5).to(
            dtype)
        b = torch.randn(n, device=dev, generator=gen).to(dtype)
        x8 = torch.randn(8, k, device=dev, generator=gen).to(dtype)
        full, worst = None, 0.0
        for rows in (8, 4, 2, 1):
            before = dn.launch_counts()[name]
            got = dn.dense(x8[:rows], w, b)
            torch.cuda.synchronize()
            check(dn.launch_counts()[name] == before + 1,
                  f"{name} did not launch")
            want = dn.dense_plain(x8[:rows], w, b)
            if half:
                e = bf16_err(torch, got, want, f"head {label} b{rows}")
            else:
                e = (got - want).abs().max().item()
                check(got.shape == want.shape
                      and e <= TOL_DENSE * want.abs().max().item(),
                      f"head {label} b{rows}: outside tolerance of the "
                      "plain version")
            worst = max(worst, e / want.abs().max().item())
            err = max(err, e)
            if full is None:
                full = got
            else:
                check(torch.equal(got, full[:rows]),
                      f"head {label}: rows differ between batch {rows} and 8")
        cols, groups, row_tiles = dn.launch_grid(8, k, n, dtype)
        sums[label] = hashlib.sha256(
            full.float().cpu().numpy().tobytes()).hexdigest()[:16]
        per_call = graph_kernels(torch, lambda: dn.launch(x8[:1], w, b),
                                 f"head {label}")
        print(f"[kernels] {name} {label} K={k} N={n}: K chunk "
              f"{dn.k_chunk(k, n)}, {-(-k // dn.k_chunk(k, n))} chunks in "
              f"{groups} groups, {cols * groups} CTAs per row tile "
              f"({cols * groups * row_tiles} at batch 8), "
              f"device kernels per call {per_call}, within "
              f"{worst:.2e}·max|plain| of the plain version, rows bitwise "
              f"at batch 1, 2, 4 and 8, output checksum {sums[label]}")
    return err, sums


def time_dense(torch, dev, batch, reps, dtype=None):
    """VGG-16's head at 224 (fc1, fc2, fc3) at ``batch``: the head kernel,
    its plain version and ``torch.addmm`` (one PyTorch call of the same
    function), device time by CUDA-graph replay, with the bound (the
    weights, x, b and the output moved once; fp32 operations, or bf16
    ones on the tensor cores for ``dtype`` bf16)."""
    from repro_torch.kernels import dense as dn
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    rows = []
    for label, k, n in head_shapes()[:3]:
        w = (torch.randn(k, n, device=dev, generator=gen) / k ** 0.5).to(
            dtype)
        b = torch.randn(n, device=dev, generator=gen).to(dtype)
        x = torch.randn(batch, k, device=dev, generator=gen).to(dtype)
        row = {"layer": label, "batch": batch, "k": k, "n": n,
               "ms": time_graph_ms(torch, lambda: dn.launch(x, w, b), reps),
               "plain_ms": time_graph_ms(
                   torch, lambda: dn.dense_plain(x, w, b), reps),
               "library_ms": time_graph_ms(
                   torch, lambda: torch.addmm(b, x, w), reps)}
        row["bound_ms"], row["op_ms"], row["byte_ms"] = bound(
            2.0 * batch * k * n,
            x.element_size() * (k * n + batch * k + n + batch * n),
            BF16_TC_PEAK if dtype == torch.bfloat16 else FP32_PEAK)
        rows.append(row)
    return rows


def resnext_layer():
    """ResNeXt-50 32x4d's first-stage grouped 3x3 at batch 1 as the engine
    schedules it: (name, schedule, loop nest, epilogue), a
    ``model_layers`` row."""
    from repro_torch.core.engine import ScheduleCache
    from repro_torch.core.loopnest import ConvLoopNest
    n, c, h, nf, g, r, st, pad, epi = grouped_cases()[-1]
    cv = ConvLoopNest(n=n, nf=nf, c=c, r=r, s=r, x=h, y=h, stride=st,
                      pad=pad, groups=g)
    return ("resnext50_conv2_g32", ScheduleCache().schedule_for(cv), cv, epi)


def vgg_layer_specs(img: int, batch: int):
    """(name, schedule, fused epilogue, batch, input height) of VGG-16's 13
    convs as the engine compiles them at full width."""
    import torch
    from repro_torch.core.engine import compile_network
    from repro_torch.models import vgg
    params = vgg.init_params(torch.Generator().manual_seed(SEED),
                             img=img, device="meta")
    net = compile_network(params, vgg.to_graph(), (batch, 3, img, img),
                          device="meta")
    epis = {nd.name: nd.epilogue for nd in net.graph.nodes
            if nd.op == "conv"}
    out, h = [], img
    for name, sched in net.layer_schedules:
        out.append((name, sched, epis[name], batch, h))
        if epis[name].pool:
            h //= 2
    return out


def time_layers(torch, dev, layers, dataflows, reps, dtype=None):
    """Time the kernel(s) (``<dataflow>_ms``: device time, CUDA-graph
    replay of the bare launch on prepared operands; ``<dataflow>_call_ms``:
    the eager ``conv2d_folded`` call, host work included), the plain
    version and F.conv2d at each layer's main-path shape, in fp32 or in
    ``dtype`` (bf16: each kernel's output is held against its plain
    version under the bf16 rule, ``max_abs_err`` in the row, and the
    bound counts 2-byte elements and the bf16 tensor-core rate).  Returns
    per-layer rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_ws as cw
    dtype = dtype or torch.float32
    half = dtype == torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, sched, epi, batch, h in layers:
        cv = sched.nest          # its channels; the extent is the layer's own
        x = torch.randn(batch, cv.c, h + 2, h + 2, device=dev,
                        generator=gen).to(dtype)
        w = torch.randn(cv.nf, cv.c, 3, 3, device=dev, generator=gen)
        w = (w / (cv.c * 9) ** 0.5 if half else w).to(dtype)
        b = torch.randn(cv.nf, device=dev, generator=gen).to(dtype)
        row = {"layer": name, "batch": batch, "h": h,
               "c": cv.c, "nf": cv.nf, "epilogue": str(epi)}
        for df in dataflows:
            kw = dict(plan=sched.plan, dataflow=df, epilogue=epi, bias=b)
            spec, *prepared = cw.prepare(x, w, 1, sched.plan, df, b, epi, 1,
                                         None, None, None)
            launch = cw.LAUNCHERS[spec.dataflow]
            row[f"{df}_tile"] = cw.fold_tile(spec, batch, cw._sm_count(dev),
                                             dtype=dtype).index
            row[f"{df}_ms"] = time_graph_ms(
                torch, lambda: launch(spec, *prepared), reps)
            row[f"{df}_call_ms"] = time_ms(
                torch, lambda: cw.conv2d_folded(x, w, **kw), reps)
        kw = dict(plan=sched.plan, dataflow=dataflows[0], epilogue=epi,
                  bias=b)
        row["plain_ms"] = time_graph_ms(
            torch, lambda: cw.conv2d_folded_plain(x, w, **kw), 2)
        xin = x[:, :, 1:-1, 1:-1].contiguous()
        row["library_ms"] = time_graph_ms(
            torch, lambda: F.conv2d(xin, w, b, padding=1), max(reps, 10))
        out = cw.conv2d_folded(x, w, **kw)
        if half:
            for df in dataflows:
                row[f"{df}_max_abs_err"] = bf16_err(
                    torch, cw.conv2d_folded(x, w, **dict(kw, dataflow=df)),
                    cw.conv2d_folded_plain(x, w, **dict(kw, dataflow=df)),
                    f"bf16 {name} {df}")
        row["bound_ms"], row["op_ms"], row["byte_ms"] = bound(
            2.0 * batch * cv.nf * cv.c * 9 * h * h,
            x.element_size() * (batch * cv.c * h * h + w.numel()
                                + b.numel() + out.numel()),
            BF16_TC_PEAK if half else FP32_PEAK)
        rows.append(row)
    return rows


def model_layers(name: str, img: int, batch: int):
    """(layer, schedule, its own loop nest, fused epilogue) of a zoo
    model's convs as the engine compiles them at full width."""
    import torch
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.models import zoo
    spec = zoo.get_conv_model(name)
    params = spec.init_params(torch.Generator(), img=img, device="meta")
    net = zoo.compile_forward(spec, params, img=img, batch=batch,
                              device="meta")
    epis = {nd.name: nd.epilogue or Epilogue() for nd in net.graph.nodes
            if nd.op == "conv"}
    nests = dict(net.layer_nests)
    return [(lname, sched, nests[lname], epis[lname])
            for lname, sched in net.layer_schedules]


def time_model_layers(torch, dev, layers, reps, dtype=None):
    """Time each conv of a model at its main-path shape, with its bound:
    ``ms`` the launch of the kernel its schedule selects on prepared
    operands, ``plain_ms`` the plain version and ``library_ms`` one
    ``F.conv2d`` call (bias included, no epilogue), all three as device
    time (CUDA-graph replay); ``call_ms`` the eager ``conv2d_folded`` call,
    host work included.  In fp32 or in ``dtype`` (bf16: each kernel held
    against its plain version under the bf16 rule, ``max_abs_err`` in the
    row, 2-byte elements and the bf16 tensor-core rate in the bound)."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_ws as cw
    dtype = dtype or torch.float32
    half = dtype == torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, sched, cv, epi in layers:
        pad = cv.pad
        x = torch.randn(cv.n, cv.c, cv.x + 2 * pad, cv.y + 2 * pad,
                        device=dev, generator=gen).to(dtype)
        w = torch.randn(cv.nf, cv.c // cv.groups, cv.r, cv.s, device=dev,
                        generator=gen)
        w = (w / (cv.c // cv.groups * cv.r * cv.s) ** 0.5 if half
             else w).to(dtype)
        ops = {k: v.to(dtype) for k, v in epi_operands(
            torch, gen, dev, epi, cv.n, cv.nf, cv.p, cv.q).items()}
        kw = dict(stride=cv.stride, plan=sched.plan,
                  dataflow=sched.dataflow, epilogue=epi, groups=cv.groups,
                  **ops)
        row = {"layer": name, "batch": cv.n, "h": cv.x, "c": cv.c,
               "nf": cv.nf, "rs": f"{cv.r}x{cv.s}", "stride": cv.stride,
               "groups": cv.groups, "dataflow": sched.dataflow,
               "epilogue": str(epi)}
        spec, *prepared = cw.prepare(
            x, w, cv.stride, sched.plan, sched.dataflow, ops.get("bias"),
            epi, cv.groups, ops.get("residual"), ops.get("scale"),
            ops.get("shift"))
        launch = cw.LAUNCHERS[spec.dataflow]
        if spec.dataflow != "depthwise":
            t = cw.fold_tile(spec, cv.n, cw._sm_count(dev), dtype=dtype)
            row["tile"] = f"{t.core}{t.index}"
        row["ms"] = time_graph_ms(torch, lambda: launch(spec, *prepared),
                                  reps)
        row["call_ms"] = time_ms(
            torch, lambda: cw.conv2d_folded(x, w, **kw), reps)
        row["plain_ms"] = time_graph_ms(
            torch, lambda: cw.conv2d_folded_plain(x, w, **kw), 2)
        xin = x[:, :, pad:x.shape[2] - pad, pad:x.shape[3] - pad] \
            .contiguous()
        row["library_ms"] = time_graph_ms(
            torch, lambda: F.conv2d(xin, w, ops.get("bias"),
                                    stride=cv.stride, padding=pad,
                                    groups=cv.groups), reps)
        out = cw.conv2d_folded(x, w, **kw)
        if half:
            row["max_abs_err"] = bf16_err(
                torch, out, cw.conv2d_folded_plain(x, w, **kw),
                f"bf16 {name}")
        vec = cv.nf * (int(epi.bias) + 2 * int(epi.scale))
        res = out.numel() if epi.residual else 0
        row["bound_ms"], row["op_ms"], row["byte_ms"] = bound(
            2.0 * cv.n * cv.nf * (cv.c // cv.groups) * cv.r * cv.s
            * cv.p * cv.q,
            x.element_size() * (cv.n * cv.c * cv.x * cv.y + w.numel() + vec
                                + res + out.numel()),
            BF16_TC_PEAK if half else FP32_PEAK)
        rows.append(row)
    return rows


def summarize(rows, key):
    keys = (key, "plain_ms", "library_ms", "bound_ms", "op_ms", "byte_ms")
    tot = {k: sum(r[k] for r in rows) for k in keys}
    return {"ms": tot[key], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["op_ms"] >= tot["byte_ms"]
                         else "bytes")}


def launches_of(**counts):
    """Launches per kernel name, every kernel the library has, zero unless
    given."""
    from repro_torch.kernels.conv2d_ws import KERNELS
    return dict(dict.fromkeys(KERNELS, 0), **counts)


def forward_counts(torch, net, params, x):
    """One forward of a compiled network: its output and its fold-kernel
    launches by name.  The eager forward (``net.eager``) is counted as it
    runs.  A jitted network is then called once: its launches are those
    of its capture (``capture_launches``; a replay ticks no counter),
    which must equal the eager forward's, and its output must be bitwise
    the eager one.  The head kernel must launch once per dense layer."""
    from repro_torch.core.engine import kernel_launch_counts
    from repro_torch.kernels import dense as dn
    with torch.inference_mode():
        before = kernel_launch_counts()
        y = net.eager(params, x)
        after = kernel_launch_counts()
        counts = {k: after[k] - before[k] for k in after}
        if net.jit:
            y_jit = net(params, x)
    torch.cuda.synchronize()
    if net.jit:
        check(net.captures >= 1 and net.apply.capture_launches == counts,
              f"the capture launched {net.apply.capture_launches}, the "
              f"eager forward {counts}")
        check(torch.equal(y_jit, y), "the jitted forward is not bitwise "
              "the eager one")
        y = y_jit
    want = sum(nd.op == "dense" for nd in net.graph.nodes)
    head = dn.KERNEL_BF16 if net.dtype == torch.bfloat16 else dn.KERNEL
    check(counts[head] == want, f"{counts[head]} {head} launches, "
          f"expected {want}, one per dense layer")
    return y, {k: v for k, v in counts.items()
               if k not in (dn.KERNEL, dn.KERNEL_BF16)}


# one row per conv cell: the jitted forward, the eager one, device work
JIT_ROWS = []
# one row per compile of a conv model: the host ms compile_network's
# verify (the default) took, a first compile's proofs or the memo's lookups
VERIFY_ROWS = []


def note_verify(what, net):
    row = {"compile": what, "verify_ms": 1e3 * net.verify_s,
           "conv_layers": len(net.layer_schedules)}
    VERIFY_ROWS.append(row)
    print(f"[verify] {what}: {row['verify_ms']:.3f} ms verifying "
          f"{row['conv_layers']} conv layers")


def jit_cell(torch, what, net, params, x, reps):
    """A conv cell's three times, in one call: the jitted forward's
    latency and the eager forward's (CUDA events around ``reps`` calls,
    host work included), and the device work (the eager forward captured
    ``reps // 2`` times in one CUDA graph and replayed), with the busy
    share (device work over latency) of each; and the host's own time
    per jitted call (host clock around ``reps`` calls that queue without
    a synchronisation)."""
    check(net.jit, f"{what}: the network is not jitted")
    with torch.inference_mode():
        jit_ms = time_ms(torch, lambda: net(params, x), reps)
        eager_ms = time_ms(torch, lambda: net.eager(params, x), reps)
        device_ms = time_graph_ms(torch, lambda: net.eager(params, x),
                                  max(1, reps // 2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            net(params, x)
        host_ms = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
    row = {"cell": what, "jit_ms": jit_ms, "eager_ms": eager_ms,
           "device_ms": device_ms, "busy_jit": device_ms / jit_ms,
           "busy_eager": device_ms / eager_ms, "jit_host_ms": host_ms}
    print(f"[jit] {what}: jitted {jit_ms:.4f} ms (busy share "
          f"{row['busy_jit']:.3f}; host {host_ms:.4f} ms a call), eager "
          f"{eager_ms:.4f} ms (busy share {row['busy_eager']:.3f}), device "
          f"work {device_ms:.4f} ms")
    JIT_ROWS.append(row)
    return row


def close(torch, got, want, tol_rel, what):
    err = (got - want).abs().max().item()
    tol = tol_rel * want.abs().max().item()
    print(f"[{what}] max_abs_err={err:.3e} (tol {tol:.3e})")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(err <= tol, f"{what}: outside tolerance")


def phase_model_224(torch, dev, params):
    from repro_torch.core.engine import compile_network
    from repro_torch.models import vgg
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x4 = torch.randn(4, 3, 224, 224, device=dev, generator=gen)
    nets = {b: vgg.compile_forward(params, img=224, batch=b, device=dev)
            for b in (1, 4)}
    for b, net in nets.items():
        note_verify(f"vgg16 224 b{b} (first compile)", net)
    fr = nets[1].fold_reuse()
    print(f"[model224] fold_reuse {fr}")
    check((fr["conv_layers"], fr["distinct_schedules"], fr["hits"],
           fr["misses"]) == (13, 8, 5, 8), "fold reuse is not 13/8/5/8")
    desc = nets[1].describe()
    print(desc)
    check(sum(" weight_stationary " in ln for ln in desc.splitlines()) == 13,
          "describe() does not list WS for all 13 layers")
    for b, net in nets.items():
        x = x4[:b]
        y, counts = forward_counts(torch, net, params, x)
        print(f"[model224] batch {b}: launches {counts}")
        check(counts == launches_of(fold_conv_ws=13),
              f"batch {b}: expected 13 WS launches per forward")
        ref = vgg.compile_forward(params, img=224, batch=b,
                                  policy="reference", device=dev)
        with torch.inference_mode():
            want = ref(params, x)
        check(y.shape == (b, 1000), f"logits shape {tuple(y.shape)}")
        close(torch, y, want, TOL_MODEL, f"model224 b{b} vs reference")
        cell = jit_cell(torch, f"vgg16 224 b{b}", net, params, x, 6)
        with torch.inference_mode():
            out[f"reference_b{b}_ms"] = time_ms(
                torch, lambda: ref(params, x), 3)
        out.update({f"forward_b{b}_ms": cell["jit_ms"],
                    f"eager_b{b}_ms": cell["eager_ms"],
                    f"device_b{b}_ms": cell["device_ms"]})
        print(f"[model224] batch {b}: forward {cell['jit_ms']:.3f} ms "
              f"(eager {cell['eager_ms']:.3f}), reference policy "
              f"{out[f'reference_b{b}_ms']:.3f} ms")
    trunks = {b: compile_network(params, vgg.to_graph(include_head=False),
                                 (b, 3, 224, 224), device=dev)
              for b in (1, 4)}
    for b, net in trunks.items():
        note_verify(f"vgg16 224 trunk b{b} (the memo)", net)
    with torch.inference_mode():
        t4 = trunks[4](params, x4)
        for i in range(4):
            t1 = trunks[1](params, x4[i:i + 1])
            check(torch.equal(t1[0], t4[i]),
                  f"trunk row {i} differs between batch 1 and batch 4")
    print("[model224] trunk rows bitwise-equal at batch 1 and batch 4")
    return out


def phase_model_32(torch, dev):
    from repro_torch.models import vgg
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    params = vgg.init_params(gen, img=32, device=dev)
    x = torch.randn(4, 3, 32, 32, device=dev, generator=gen)
    net = vgg.compile_forward(params, img=32, batch=4, device=dev)
    note_verify("vgg16 32 b4 (first compile)", net)
    print(net.describe())
    y, counts = forward_counts(torch, net, params, x)
    print(f"[model32] batch 4: launches {counts}")
    check(counts == launches_of(fold_conv_ws=2, fold_conv_os=11),
          "expected 2 WS + 11 OS launches per forward at 32x32")
    ref = vgg.compile_forward(params, img=32, batch=4, policy="reference",
                              device=dev)
    with torch.inference_mode():
        want = ref(params, x)
    close(torch, y, want, TOL_MODEL, "model32 b4 vs reference")
    jit_cell(torch, "vgg16 32 b4", net, params, x, 10)
    return net


def phase_serving(torch, dev, params, jit, module=None, img=224,
                  buckets=(1, 2, 4)):
    """A zoo model (VGG-16 by default) served at ``img`` over ``buckets``
    (VGG-16: 224, (1, 2, 4)), 8 requests of 1 to the widest bucket less
    one images, its bucket forwards CUDA graphs (``jit``) or eager; each
    request's logits bitwise equal to an eager direct forward of its
    images (in the parameters' type: fp32, or bf16, whose engine rounds
    the images to bf16 and widens the logits to fp32)."""
    import numpy as np
    from repro_torch.models import vgg
    from repro_torch.serve.vision import VisionEngine
    module = module or vgg
    eng = VisionEngine(params, module.to_graph(), img=img, buckets=buckets,
                       jit=jit, device=dev)
    what = ("jitted" if jit else "eager") + (
        "" if eng.input_dtype == torch.float32 else " bf16") + (
        "" if module is vgg else f" {module.__name__.split('.')[-1]}")
    eng.warmup()
    rng = np.random.default_rng(SEED)
    imgs = [rng.standard_normal((int(k), 3, img, img)).astype(np.float32)
            for k in rng.integers(1, max(buckets), 8)]
    reqs = [eng.submit(im) for im in imgs]
    m = eng.run()
    for req, im in zip(reqs, imgs):
        check(req.outcome.value == "ok", f"request {req.rid} ended "
              f"{req.outcome.value}")
        direct = module.compile_forward(params, img=img, batch=im.shape[0],
                                        cache=eng.compiler.cache, jit=False,
                                        device=dev)
        with torch.inference_mode():
            want = direct(params, torch.from_numpy(im).to(dev).to(
                eng.input_dtype)).float()
        got = torch.from_numpy(req.logits).to(dev)
        print(f"[serve {what}] request {req.rid} ({im.shape[0]} images): "
              f"bitwise="
              f"{torch.equal(got, want)} max_abs_err="
              f"{(got - want).abs().max().item():.3e}")
        check(torch.equal(got, want), f"serve request {req.rid}: served "
              "logits differ from a direct forward")
        check(req.served_by == "primary", f"serve request {req.rid}: "
              f"served by the {req.served_by} rung")
    d = eng.metrics_dict()
    rb = d["robustness"]
    check(not (rb["degraded_batches"] or rb["failed"]
               or rb["nonfinite_batches"]),
          f"serve {what}: degraded / failed / non-finite {rb}")
    lat = d["latency"]
    print(f"[serve {what}] {d['requests']} requests / {d['images']} "
          f"images in "
          f"{d['elapsed_s']:.4f} s: {d['images_per_s']:.3f} images/s "
          f"(KIPS {d['kips']}), p50 {lat['p50_s'] * 1e3:.3f} ms, p99 "
          f"{lat['p99_s'] * 1e3:.3f} ms, batches per bucket "
          f"{d['per_bucket_batches']}")
    check(d["robustness"]["lost_requests"] == 0, "requests lost")
    return d


def model_forwards(torch, dev, module, params, x4, counts_want, reuse_want,
                   what):
    """Batch 1 and 4 forwards of a zoo model: fold reuse, launches per
    forward, logits against the reference policy, and the times of both.
    Returns (ms by name, the compiled networks by batch)."""
    out, nets = {}, {}
    for b in (1, 4):
        nets[b] = module.compile_forward(params, img=32, batch=b, device=dev)
        note_verify(f"{what} 32 b{b} (first compile)", nets[b])
    fr = nets[4].fold_reuse()
    print(f"[{what}] fold_reuse {fr}")
    print(nets[4].describe())
    check((fr["conv_layers"], fr["distinct_schedules"], fr["hits"])
          == reuse_want, f"{what}: fold reuse is not {reuse_want}")
    for b, net in nets.items():
        x = x4[:b]
        y, counts = forward_counts(torch, net, params, x)
        print(f"[{what}] batch {b}: launches {counts}")
        check(counts == counts_want,
              f"{what} batch {b}: expected launches {counts_want}")
        ref = module.compile_forward(params, img=32, batch=b,
                                     policy="reference", device=dev)
        with torch.inference_mode():
            want = ref(params, x)
        check(y.shape == (b, module.n_classes),
              f"logits shape {tuple(y.shape)}")
        close(torch, y, want, TOL_MODEL, f"{what} b{b} vs reference")
        cell = jit_cell(torch, f"{what} b{b}", net, params, x, 10)
        with torch.inference_mode():
            out[f"reference_b{b}_ms"] = time_ms(
                torch, lambda: ref(params, x), 3)
        out.update({f"forward_b{b}_ms": cell["jit_ms"],
                    f"eager_b{b}_ms": cell["eager_ms"],
                    f"device_b{b}_ms": cell["device_ms"]})
        print(f"[{what}] batch {b}: forward {cell['jit_ms']:.3f} ms "
              f"(eager {cell['eager_ms']:.3f}, device work "
              f"{cell['device_ms']:.3f}), reference policy "
              f"{out[f'reference_b{b}_ms']:.3f} ms")
    return out, nets


def phase_mobilenet(torch, dev):
    from repro_torch.core.engine import compile_network
    from repro_torch.models import mobilenet
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    params = randomize_bn(torch, mobilenet.init_params(gen, img=32,
                                                       device=dev))
    x4 = torch.randn(4, 3, 32, 32, device=dev, generator=gen)
    out, nets = model_forwards(
        torch, dev, mobilenet, params, x4,
        launches_of(fold_conv_ws=7, fold_conv_os=28, fold_conv_dw=17),
        (52, 30, 22), "mobilenetv2")
    unfused = mobilenet.compile_forward(params, img=32, batch=4,
                                        fuse_epilogues=False,
                                        cache=nets[4].cache, device=dev)
    with torch.inference_mode():
        check(torch.equal(nets[4](params, x4), unfused(params, x4)),
              "mobilenetv2: fused logits differ from unfused")
    print("[mobilenetv2] fused logits bitwise-equal to unfused at batch 4")
    trunks = {b: compile_network(params,
                                 mobilenet.to_graph(include_head=False),
                                 (b, 3, 32, 32), device=dev)
              for b in (1, 4)}
    with torch.inference_mode():
        t4 = trunks[4](params, x4)
        for i in range(4):
            t1 = trunks[1](params, x4[i:i + 1])
            check(torch.equal(t1[0], t4[i]),
                  f"mobilenetv2 trunk row {i} differs between batch 1 "
                  "and batch 4")
    print("[mobilenetv2] trunk rows bitwise-equal at batch 1 and batch 4")
    return out


def phase_resnet(torch, dev):
    from repro_torch.models import resnet
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    params = resnet.init_params(gen, img=32, device=dev)
    x4 = torch.randn(4, 3, 32, 32, device=dev, generator=gen)
    out, _ = model_forwards(
        torch, dev, resnet, params, x4,
        launches_of(fold_conv_ws=5, fold_conv_os=15),
        (20, 11, 9), "resnet18")
    return out


PHASE8_REQUESTS = 40


def set_numerics(torch):
    """Full fp32 matmuls and convs (TF32 off) for every torch call of the
    process: the kernels are held against plain torch at fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def serve_phase8(dev, jit=True):
    """Phase 8's stream: full-width MobileNetV2, fp32, buckets (1, 2, 4,
    8), ``PHASE8_REQUESTS`` requests of 1-8 images from ``SEED``, through
    the ``serving_summary`` of whichever ``repro_torch`` is first on
    ``sys.path`` (``serve_ab.py`` times a second checkout with it)."""
    from repro_torch.serve.vision import serving_summary
    return serving_summary("mobilenetv2", requests=PHASE8_REQUESTS, img=32,
                           width_mult=1.0, buckets=(1, 2, 4, 8), seed=SEED,
                           device=dev, jit=jit)


def phase_serving_mobilenet(torch, dev, jit):
    requests = PHASE8_REQUESTS
    d = serve_phase8(dev, jit)
    lat, v = d["latency"], d["verify"]
    what = "jitted" if jit else "eager"
    print(f"[serve mobilenetv2 {what}] {d['requests']} requests / "
          f"{d['images']} "
          f"images in {d['elapsed_s']:.4f} s: {d['images_per_s']:.3f} "
          f"images/s, p50 {lat['p50_s'] * 1e3:.3f} ms, p99 "
          f"{lat['p99_s'] * 1e3:.3f} ms, batches per bucket "
          f"{d['per_bucket_batches']}, fold reuse {d['compile']}, runtime "
          f"host {d['host_us_per_batch']:.3f} us a batch")
    rb = d["robustness"]
    print(f"[serve mobilenetv2 {what}] served vs direct bitwise="
          f"{v['bitwise']} "
          f"max_abs_err={v['max_abs_err']:.3e}")
    check(rb["lost_requests"] == 0 and rb["outcomes"] == {"ok": requests},
          f"mobilenetv2 serving: outcomes {rb['outcomes']}, lost "
          f"{rb['lost_requests']}")
    check(v["requests"] == requests and v["bitwise"],
          "mobilenetv2 serving: served logits differ from a direct forward")
    check_primary(d, f"mobilenetv2 serving {what}")
    return d


# --------------------------------------------------------------------------
# the serving runtime: measured tuning, robust serving, chaos
# --------------------------------------------------------------------------

def check_primary(d, what):
    """A non-chaos serving run: no degraded, failed or non-finite batch,
    every request served OK by the primary rung (a broken kernel must not
    pass as a degraded success)."""
    rb = d["robustness"]
    bad = {k: rb[k] for k in ("degraded_batches", "failed",
                              "nonfinite_batches") if rb[k]}
    check(not bad, f"{what}: {bad}")
    check(d["served_by"] == {"primary": d["verify"]["requests"],
                             "reference": 0},
          f"{what}: served by {d['served_by']}")


def tune_network(torch, dev, module, params, img, batch, precision, what,
                 tmp):
    """``compile_network(autotune=True, tuning_path=...)`` on one network:
    the tuning's host seconds, each key's race (candidates, failures, the
    analytical pick's ms beside the winner's), the tuned forward against
    the reference policy, jitted = eager bitwise with equal launch counts,
    its jitted and device ms beside the untuned forward's; a fresh cache
    that loads the file re-measures nothing and gets the same schedules;
    files tagged for another backend load nothing."""
    import warnings
    from repro_torch.core.engine import ScheduleCache
    path = str(tmp / f"{what.replace(' ', '_')}.json")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn(batch, 3, img, img, device=dev, generator=gen)
    kw = dict(img=img, batch=batch, device=dev, precision=precision)
    untuned = module.compile_forward(params, **kw)
    if precision == "int8":
        kw["quant"] = untuned.quant
    t0 = time.perf_counter()
    net = module.compile_forward(params, autotune=True, tuning_path=path,
                                 cache=ScheduleCache(), **kw)
    tune_s = time.perf_counter() - t0
    check(net.autotuned and all(s.source == "measured"
                                for _, s in net.layer_schedules),
          f"{what}: not every schedule was measured")
    analytical = {s.key: s for s in untuned.cache.schedules()}
    keys = []
    for s in net.cache.schedules():
        ms = dict(s.timings)
        pick = f"base/{analytical[s.key].dataflow}"
        row = {"key": str(s.key), "raced": len(s.timings),
               "failed": len(s.failed), "winner": s.timings[0][0],
               "winner_ms": s.measured_ms, "analytical": pick,
               "analytical_ms": ms.get(pick)}
        keys.append(row)
        gap = (row["analytical_ms"] / row["winner_ms"]
               if row["analytical_ms"] else float("nan"))
        print(f"[tune] {what} {row['key']:<22} raced {row['raced']:>2} "
              f"failed {row['failed']}: analytical {pick} "
              f"{row['analytical_ms']:.4f} ms, winner {row['winner']} "
              f"{row['winner_ms']:.4f} ms ({gap:.3f}x)")
        for label, err in s.failed:
            print(f"[tune]   failed {label}: {err[:160]}")
    print(f"[tune] {what}: {len(keys)} keys tuned in {tune_s:.3f} s (host), "
          f"{sum(r['raced'] for r in keys)} candidates raced, "
          f"{sum(r['failed'] for r in keys)} failed")
    y, counts = forward_counts(torch, net, params, x)
    check(sum(counts.values()) == len(net.layer_schedules),
          f"{what}: {counts} launches for {len(net.layer_schedules)} convs")
    ref = module.compile_forward(params, policy="reference", **kw)
    with torch.inference_mode():
        want = ref(params, x)
    if precision == "int8":
        err = (y - want).abs().max().item()
        check(torch.equal(y, want) or err <= TOL_INT8_REF *
              want.abs().max().item(), f"{what}: tuned forward outside "
              "tolerance of the int8 reference")
        # int32 sums are exact whatever the plan: tuning changes no bit
        with torch.inference_mode():
            check(torch.equal(y, untuned.eager(params, x)),
                  f"{what}: the tuned int8 forward is not bitwise the "
                  "untuned one")
        print(f"[tune] {what}: tuned vs int8 reference max_abs_err "
              f"{err:.3e}; bitwise the untuned forward")
    else:
        close(torch, y, want, TOL_MODEL, f"tune {what} vs reference")
    tuned_cell = jit_cell(torch, f"{what} tuned", net, params, x, 10)
    untuned_cell = jit_cell(torch, f"{what} untuned", untuned, params, x,
                            10)
    print(f"[tune] {what}: tuned jitted {tuned_cell['jit_ms']:.4f} ms "
          f"(device {tuned_cell['device_ms']:.4f}) vs untuned "
          f"{untuned_cell['jit_ms']:.4f} ms (device "
          f"{untuned_cell['device_ms']:.4f})")
    # a fresh cache that loads the file measures nothing
    calls = []

    def never(plan, df):
        calls.append((plan, df))
        raise RuntimeError("re-measured after load_tuning")
    fresh = ScheduleCache()
    n = fresh.load_tuning(path, device=dev)
    again = module.compile_forward(params, autotune=True, tuning_path=path,
                                   autotune_timer=never, cache=fresh, **kw)
    check(n == len(keys) and not calls, f"{what}: loaded {n} of "
          f"{len(keys)} entries, re-measured {len(calls)} candidates")
    same = [(s.key, s.plan, s.dataflow) for _, s in again.layer_schedules] \
        == [(s.key, s.plan, s.dataflow) for _, s in net.layer_schedules]
    check(same, f"{what}: the reloaded schedules differ")
    payload = json.loads(pathlib.Path(path).read_text())
    foreign = {}
    for tag in ("tpu", "cpu", "torch-cpu"):
        bad = tmp / f"foreign_{tag}.json"
        bad.write_text(json.dumps(dict(payload, backend=tag)))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            foreign[tag] = ScheduleCache().load_tuning(str(bad), device=dev)
        check(foreign[tag] == 0 and any("measured on backend" in
                                        str(c.message) for c in caught),
              f"{what}: a {tag!r} tuning file loaded {foreign[tag]} "
              "entries")
    print(f"[tune] {what}: reloaded {n} entries from {payload['backend']!r}"
          f" with 0 measurements, same schedules; foreign tags load "
          f"{foreign}")
    # the tuned network's rows (trunk and head kernel): the same bits at
    # batch 1 and batch 4
    from repro_torch.core.engine import compile_network
    x4 = torch.randn(4, 3, img, img, device=dev, generator=gen)
    trunks = {b: compile_network(params, module.to_graph(),
                                 (b, 3, img, img), cache=net.cache,
                                 autotune=True, autotune_timer=never,
                                 device=dev, precision=precision,
                                 quant=kw.get("quant"))
              for b in (1, 4)}
    with torch.inference_mode():
        t4 = trunks[4](params, x4)
        for i in range(4):
            check(torch.equal(trunks[1](params, x4[i:i + 1])[0], t4[i]),
                  f"{what}: tuned row {i} differs between batch 1 and "
                  "batch 4")
    check(not calls, f"{what}: the recompiles re-measured {len(calls)}")
    print(f"[tune] {what}: tuned logits rows bitwise-equal at batch 1 and "
          "batch 4")
    return {"tune_s": tune_s, "keys": keys, "backend": payload["backend"],
            "tuned": tuned_cell, "untuned": untuned_cell}


def phase_tune(torch, dev, vgg_params):
    import tempfile
    from repro_torch.models import mobilenet, resnet, vgg
    out = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        out["vgg16_224_b1"] = tune_network(torch, dev, vgg, vgg_params,
                                           224, 1, "fp32", "vgg16 224 b1",
                                           tmp)
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        params = randomize_bn(torch, mobilenet.init_params(gen, img=32,
                                                           device=dev))
        out["mobilenetv2_b4"] = tune_network(torch, dev, mobilenet, params,
                                             32, 4, "fp32",
                                             "mobilenetv2 b4", tmp)
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        params = resnet.init_params(gen, img=32, device=dev)
        out["resnet18_b4_int8"] = tune_network(torch, dev, resnet, params,
                                               32, 4, "int8",
                                               "resnet18 b4 int8", tmp)
    return out


def prometheus_parses(text):
    """Every sample line of a Prometheus text exposition: a metric name,
    optional labels and a number."""
    import re
    line_re = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')
    for ln in text.splitlines():
        if not ln or ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        if not line_re.match(ln):
            return False
        value = ln.rsplit(" ", 1)[1]
        if value != "+Inf":
            float(value)
    return True


def phase_serve_runtime(torch, dev, phase8):
    """MobileNetV2 fp32 served through ``serving_summary`` at buckets
    (1, 2, 4, 8), 40 requests, with ``autotune``, a metrics registry and a
    5 s deadline on every 2nd request, once with the tracer off and once
    on: nothing lost, no degraded / failed / non-finite batch, every
    request OK from the primary rung, served logits bitwise a direct
    forward from the same cache, the trace and the metrics snapshot
    valid, the Prometheus text parseable."""
    from repro_torch.obs.metrics import (MetricsRegistry,
                                         validate_metrics_snapshot)
    from repro_torch.obs.report import check_trace_outcomes
    from repro_torch.obs.trace import Tracer, validate_trace
    from repro_torch.serve.vision import serving_summary
    requests = 40
    out = {}
    for traced in (False, True):
        what = "tracer on" if traced else "tracer off"
        tracer = Tracer(time.monotonic) if traced else None
        registry = MetricsRegistry()
        d = serving_summary("mobilenetv2", requests=requests, img=32,
                            width_mult=1.0, buckets=(1, 2, 4, 8), seed=SEED,
                            device=dev, autotune=True, deadline_s=5.0,
                            deadline_every=2, tracer=tracer,
                            registry=registry, verbose=traced)
        rb, lat = d["robustness"], d["latency"]
        check(rb["lost_requests"] == 0 and rb["outcomes"] == {"ok": requests},
              f"serve-runtime {what}: outcomes {rb['outcomes']}, lost "
              f"{rb['lost_requests']}")
        check(rb["deadline_total"] == requests // 2
              and rb["deadline_hits"] == rb["deadline_total"],
              f"serve-runtime {what}: deadlines {rb['deadline_hits']} of "
              f"{rb['deadline_total']}")
        check_primary(d, f"serve-runtime {what}")
        check(d["verify"]["bitwise"], f"serve-runtime {what}: served "
              "logits differ from a direct forward")
        check(all(s["layers"] for s in
                  d["observability"]["schedules"].values()),
              f"serve-runtime {what}: empty fold-counter rows")
        snap = registry.snapshot()
        problems = validate_metrics_snapshot(snap)
        check(not problems, f"metrics snapshot: {problems}")
        check(prometheus_parses(registry.to_prometheus()),
              "the Prometheus text does not parse")
        if traced:
            trace = tracer.to_json()
            problems = validate_trace(trace) or \
                check_trace_outcomes(trace, requests)
            check(not problems, f"trace: {problems[:5]}")
            print(f"[serve-runtime] trace: {len(trace['traceEvents'])} "
                  f"events, {requests} request spans, valid")
        print(f"[serve-runtime] mobilenetv2 {what}: "
              f"{d['images_per_s']:.3f} images/s, p50 "
              f"{lat['p50_s'] * 1e3:.3f} ms, p99 {lat['p99_s'] * 1e3:.3f} "
              f"ms; {len(snap['counters'])} counters, "
              f"{len(snap['gauges'])} gauges; deadlines "
              f"{rb['deadline_hits']}/{rb['deadline_total']}, hung "
              f"{rb['hung_batches']}, stragglers {rb['straggler_events']}; "
              f"runtime host {d['host_us_per_batch']:.3f} us a batch")
        out["traced" if traced else "untraced"] = d
    p8 = phase8["latency"]
    print(f"[serve-runtime] beside phase 8 (jitted, no tuning, no tracer, "
          f"no registry): {phase8['images_per_s']:.3f} images/s, p50 "
          f"{p8['p50_s'] * 1e3:.3f} ms, p99 {p8['p99_s'] * 1e3:.3f} ms, "
          f"runtime host {phase8['host_us_per_batch']:.3f} us a batch")
    return out


def phase_chaos(torch, dev):
    """``ChaosInjector.from_profile(p, seed)`` for every profile on
    MobileNetV2 fp32 and VGG-16 at 32 (``chaos_summary``, which raises on
    any broken recovery invariant: zero lost, primary logits bitwise a
    direct kernel forward, reference logits bitwise a direct reference
    forward, the profile's counters nonzero, deadlined requests shed), the
    faults injected equal to the schedule over the primary dispatches;
    then a poisoned request quarantined alone with its batchmates served
    by the reference rung, and a slow dispatch flagged hung but served by
    the primary rung."""
    import numpy as np
    from repro_torch.models import mobilenet
    from repro_torch.serve.admission import RequestOutcome
    from repro_torch.serve.batcher import ImageRequest
    from repro_torch.serve.chaos import (PROFILE_EXPECTATIONS, PROFILES,
                                         ChaosInjector, Fault,
                                         _direct_logits, chaos_summary)
    from repro_torch.serve.vision import VisionEngine
    out = {}
    for model in ("mobilenetv2", "vgg16"):
        for profile in PROFILES:
            t0 = time.perf_counter()
            d = chaos_summary(model, profile=profile, seed=SEED + 7,
                              requests=12, img=32, width_mult=1.0,
                              device=dev, deadline_s=1e-5)
            rb, ch = d["robustness"], d["chaos"]
            want = dict.fromkeys(("kernel", "nan", "slow"), 0)
            for i, kind in ch["schedule"].items():
                if int(i) < d["batches"]:
                    want[kind] += 1
            got = {k: ch["injected"][k] for k in want}
            check(got == want, f"chaos {model} {profile}: injected {got}, "
                  f"the schedule over {d['batches']} dispatches {want}")
            check(all(rb[k] for k in PROFILE_EXPECTATIONS[profile]),
                  f"chaos {model} {profile}: {rb}")
            print(f"[chaos] {model} {profile}: {time.perf_counter() - t0:.2f}"
                  f" s, outcomes {rb['outcomes']}, injected {got} over "
                  f"{d['batches']} dispatches, degraded "
                  f"{rb['degraded_batches']}, non-finite "
                  f"{rb['nonfinite_batches']}, hung {rb['hung_batches']}, "
                  f"shed {rb['shed']}, lost {rb['lost_requests']}")
            out[f"{model}_{profile}"] = rb
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    params = randomize_bn(torch, mobilenet.init_params(gen, img=32,
                                                       device=dev))
    rng = np.random.default_rng(SEED + 8)
    eng = VisionEngine(params, mobilenet.to_graph(), img=32,
                       buckets=(1, 2, 4), device=dev,
                       chaos=ChaosInjector(fault_on_nan_input=True))
    good = [rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
            for _ in range(3)]
    poison = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    poison[0, 0, 0, 0] = np.inf
    # the poison slips past submit's validation straight into the queue:
    # data that turns bad after the front door
    reqs = [eng.submit(good[0]), eng.submit(good[1])]
    bad = ImageRequest(rid=999, images=poison)
    eng.batcher.queue.append(bad)
    eng.metrics.submitted += 1
    reqs.append(eng.submit(good[2]))
    m = eng.run()
    check(bad.outcome is RequestOutcome.FAILED and m.failed == 1
          and m.outcomes == {"ok": 3, "failed": 1},
          f"poison: {bad.outcome}, outcomes {m.outcomes}")
    for req, im in zip(reqs, good):
        want = _direct_logits(eng, im, "reference")
        check(req.served_by == "reference"
              and np.array_equal(req.logits, want),
              f"poison batchmate {req.rid}: served by {req.served_by}, "
              "not bitwise the reference rung's direct forward")
    print(f"[chaos] poison quarantined alone ({bad.error[:60]}), 3 "
          f"batchmates served by the reference rung bitwise its direct "
          f"forward; degraded {m.degraded_batches}, poison faults "
          f"{eng.chaos.injected['poison']}")
    eng = VisionEngine(params, mobilenet.to_graph(), img=32, buckets=(2,),
                       device=dev, hang_timeout_s=0.05,
                       chaos=ChaosInjector({0: Fault("slow", slow_s=0.2)}))
    eng.warmup()
    im = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    req = eng.submit(im)
    m = eng.run()
    check(req.outcome is RequestOutcome.OK and req.served_by == "primary"
          and m.hung_batches == 1 and m.degraded_batches == 0
          and np.array_equal(req.logits, _direct_logits(eng, im, "auto")),
          f"slow fault: {req.outcome} by {req.served_by}, hung "
          f"{m.hung_batches}, degraded {m.degraded_batches}")
    print("[chaos] slow dispatch (0.2 s, hang timeout 0.05 s) flagged hung, "
          "served by the primary rung, bitwise a direct forward")
    return out


# --------------------------------------------------------------------------
# int8 and psum staging
# --------------------------------------------------------------------------

def spill_plan():
    """The schedule plan of VGG-16's conv1_2 geometry (64 -> 64, 3x3) at
    288x288, batch 1: on it a WS layer with an identity epilogue keeps
    nf_b * p_pad * q * 4 = 20.25 MiB of partial sums, over
    WS_ACC_BYTES_LIMIT, and spills to psum staging."""
    from repro_torch.core.engine import ScheduleCache
    from repro_torch.core.loopnest import ConvLoopNest
    return ScheduleCache().schedule_for(ConvLoopNest(
        n=1, nf=64, c=64, r=3, s=3, x=288, y=288, stride=1, pad=1)).plan


def int8_operands(torch, gen, dev, x, w, epi, n, nf, p, q):
    """Quantize a layer's fp32 operands as ``conv2d_int8`` does and build
    its requant vectors: returns (x int8, w int8, keyword arguments of
    ``conv2d_folded``)."""
    from repro_torch.core import quant
    ops = epi_operands(torch, gen, dev, epi, n, nf, p, q)
    xs = quant.act_scale(x)
    wq, w_scale = quant.quantize_weight(w)
    scale, shift = quant.requant_affine(
        w_scale * torch.tensor(xs, device=dev), epi, ops.pop("bias", None),
        ops.pop("scale", None), ops.pop("shift", None))
    return quant.quantize_act(x, xs), wq, dict(
        epilogue=quant.requant_epilogue(epi), scale=scale, shift=shift,
        **ops)


def check_int8_kernel(torch, cw, name, x, w, what, **kw):
    """One launch of an int8 kernel against its plain version on the same
    inputs: bitwise (exact int32 sums, the flush rounded step by step)."""
    before = cw.launch_counts()[name]
    got = cw.conv2d_folded(x, w, **kw)
    torch.cuda.synchronize()
    check(cw.launch_counts()[name] == before + 1, f"{name} did not launch")
    want = cw.conv2d_folded_plain(x, w, **kw)
    err = (got - want).abs().max().item()
    print(f"[int8 kernels] {name} {what} epi={kw['epilogue']} "
          f"bitwise={torch.equal(got, want)} max_abs_err={err:.3e}")
    check(got.shape == want.shape and torch.equal(got, want),
          f"{name} is not bitwise its plain version")
    return err


def phase_int8_kernels(torch, dev, cases, dw_cases):
    """The int8 WS / OS / depthwise kernels bitwise against their plain
    versions on the fp32 phase's geometries, each epilogue in its requant
    form; the psum kernel within TOL_KERNEL·max(1, max|plain|)."""
    from repro_torch.core.mapping import ConvBlockPlan
    from repro_torch.kernels import conv2d_ws as cw
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    errs = dict.fromkeys(("fold_conv_ws_i8", "fold_conv_os_i8",
                          "fold_conv_dw_i8", "fold_conv_psum"), 0.0)
    for (n, c, h, w_, nf, r, s, st, pad, epi, plan) in cases:
        x = torch.randn(n, c, h, w_, device=dev, generator=gen)
        w = torch.randn(nf, c, r, s, device=dev, generator=gen)
        p, q = (h + 2 * pad - r) // st + 1, (w_ + 2 * pad - s) // st + 1
        xq, wq, kw = int8_operands(torch, gen, dev, x, w, epi, n, nf, p, q)
        xq = torch.nn.functional.pad(xq, (pad, pad, pad, pad))
        for name, df in (("fold_conv_ws_i8", "weight_stationary"),
                         ("fold_conv_os_i8", "output_stationary")):
            errs[name] = max(errs[name], check_int8_kernel(
                torch, cw, name, xq, wq,
                f"n={n} c={c} {h}x{w_} nf={nf} {r}x{s}/s{st}", stride=st,
                plan=plan, dataflow=df, **kw))
    for (n, c, h, w_, st, epi, c_b) in dw_cases:
        x = torch.randn(n, c, h, w_, device=dev, generator=gen)
        w = torch.randn(c, 1, 3, 3, device=dev, generator=gen)
        p, q = (h - 1) // st + 1, (w_ - 1) // st + 1
        plan = None if c_b is None else ConvBlockPlan(
            nf_block=c_b, c_block=c_b, p_block=4, grid=(1, -(-c // c_b), 1),
            vmem_bytes=0, groups=c)
        xq, wq, kw = int8_operands(torch, gen, dev, x, w, epi, n, c, p, q)
        errs["fold_conv_dw_i8"] = max(errs["fold_conv_dw_i8"],
                                      check_int8_kernel(
            torch, cw, "fold_conv_dw_i8",
            torch.nn.functional.pad(xq, (1, 1, 1, 1)), wq,
            f"n={n} c={c} {h}x{w_} 3x3/s{st}", stride=st, plan=plan,
            dataflow="depthwise", groups=c, **kw))
    for (n, c, h, nf, g, r, st, pad, epi) in grouped_cases():
        x = torch.randn(n, c, h, h, device=dev, generator=gen)
        w = torch.randn(nf, c // g, r, r, device=dev, generator=gen)
        p = (h + 2 * pad - r) // st + 1
        xq, wq, kw = int8_operands(torch, gen, dev, x, w, epi, n, nf, p, p)
        xq = torch.nn.functional.pad(xq, (pad, pad, pad, pad))
        for name, df in (("fold_conv_ws_i8", "weight_stationary"),
                         ("fold_conv_os_i8", "output_stationary")):
            errs[name] = max(errs[name], check_int8_kernel(
                torch, cw, name, xq, wq,
                f"grouped n={n} c={c} {h}x{h} nf={nf} G={g} {r}x{r}/s{st}",
                stride=st, dataflow=df, groups=g, **kw))
    # psum staging: forced g_c > 1 plans, and the WS spill of an
    # identity-epilogue layer
    psum_cases = [
        (3, 40, 18, 18, 30, "weight_stationary_psum",
         ConvBlockPlan(nf_block=24, c_block=16, p_block=5, grid=(2, 3, 4),
                       vmem_bytes=0)),
        (3, 33, 9, 7, 13, "weight_stationary_psum",
         ConvBlockPlan(nf_block=8, c_block=17, p_block=3, grid=(2, 2, 3),
                       vmem_bytes=0)),
        (1, 256, 28, 28, 256, "weight_stationary_psum", None),
        (1, 64, 288, 288, 64, "weight_stationary", spill_plan()),
    ]
    for (n, c, h, w_, nf, df, plan) in psum_cases:
        x = torch.randn(n, c, h + 2, w_ + 2, device=dev, generator=gen)
        w = torch.randn(nf, c, 3, 3, device=dev, generator=gen)
        spec = cw.fold_kernel_spec(tuple(x.shape), tuple(w.shape), plan=plan,
                                   dataflow=df)
        check(spec.dataflow == "weight_stationary_psum",
              f"{df} n={n} c={c} {h}x{w_} did not land on psum staging")
        what = (f"n={n} c={c} {h}x{w_} nf={nf} g_c={spec.cg_folds}"
                + (" (WS spill: VGG-16 conv1_2 at 288)"
                   if df == "weight_stationary" else ""))
        check_kernel(torch, cw, "fold_conv_psum", x, w, errs, what,
                     plan=plan, dataflow=df)
    return errs


def int8_bound(n, nf, cg, rs, p, q, x_elems, w_elems, vec, res, out):
    """The int8 layer bound: ops over the dense int8 tensor-core peak;
    bytes with x and w at one byte, vector columns, shortcut and output at
    four."""
    return bound(2.0 * n * nf * cg * rs * p * q,
                 1.0 * (x_elems + w_elems) + 4.0 * (vec + res + out),
                 INT8_PEAK)


def time_int8_layers(torch, dev, layers, reps):
    """Each conv of ``layers`` (``model_layers`` rows) at its main-path
    shape: the int8 kernel, the fp32 kernel and the int8 plain version as
    device time (CUDA-graph replay of the bare launch on prepared
    operands), with the int8 bound.  PyTorch has no int8 convolution on
    CUDA, so there is no library time."""
    from repro_torch.kernels import conv2d_ws as cw
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rows = []
    for name, sched, cv, epi in layers:
        pad = cv.pad
        x = torch.randn(cv.n, cv.c, cv.x, cv.y, device=dev, generator=gen)
        w = torch.randn(cv.nf, cv.c // cv.groups, cv.r, cv.s, device=dev,
                        generator=gen)
        xq, wq, kw = int8_operands(torch, gen, dev, x, w, epi, cv.n, cv.nf,
                                   cv.p, cv.q)
        xq = torch.nn.functional.pad(xq, (pad, pad, pad, pad))
        kw.update(stride=cv.stride, plan=sched.plan, dataflow=sched.dataflow,
                  groups=cv.groups)
        row = {"layer": name, "batch": cv.n, "h": cv.x, "c": cv.c,
               "nf": cv.nf, "rs": f"{cv.r}x{cv.s}", "stride": cv.stride,
               "groups": cv.groups, "dataflow": sched.dataflow,
               "epilogue": str(kw["epilogue"])}
        spec, *prepared = cw.prepare(
            xq, wq, cv.stride, sched.plan, sched.dataflow, None,
            kw["epilogue"], cv.groups, kw.get("residual"), kw["scale"],
            kw["shift"])
        launch = cw.LAUNCHERS[spec.dataflow]
        row["ms"] = time_graph_ms(torch, lambda: launch(spec, *prepared),
                                  reps)
        row["plain_ms"] = time_graph_ms(
            torch, lambda: cw.conv2d_folded_plain(xq, wq, **kw), 1)
        # the fp32 kernel as the fp32 forward runs it: its own epilogue
        xf = torch.nn.functional.pad(x, (pad, pad, pad, pad))
        ops32 = epi_operands(torch, gen, dev, epi, cv.n, cv.nf, cv.p, cv.q)
        spec32, *prep32 = cw.prepare(
            xf, w, cv.stride, sched.plan, sched.dataflow, ops32.get("bias"),
            epi, cv.groups, ops32.get("residual"), ops32.get("scale"),
            ops32.get("shift"))
        row["fp32_ms"] = time_graph_ms(
            torch, lambda: launch(spec32, *prep32), reps)
        row["library_ms"] = None
        out = launch(spec, *prepared)
        out_elems = cv.n * cv.nf * spec.p_valid * spec.q_valid
        check(out.shape[0] == cv.n, "int8 timing launch gave no output")
        row["bound_ms"], row["op_ms"], row["byte_ms"] = int8_bound(
            cv.n, cv.nf, cv.c // cv.groups, cv.r * cv.s, cv.p, cv.q,
            cv.n * cv.c * cv.x * cv.y, w.numel(), 2 * cv.nf,
            out_elems if kw["epilogue"].residual else 0, out_elems)
        rows.append(row)
    return rows


def summarize_int8(rows):
    keys = ("ms", "fp32_ms", "plain_ms", "bound_ms", "op_ms", "byte_ms")
    tot = {k: sum(r[k] for r in rows) for k in keys}
    return {"ms": tot["ms"], "fp32_ms": tot["fp32_ms"],
            "plain_ms": tot["plain_ms"], "library_ms": None,
            "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["op_ms"] >= tot["byte_ms"]
                         else "bytes")}


def time_psum_vs_ws(torch, dev, layers, reps):
    """The paper's Fig. 5 comparison on VGG-16's layers at 224, batch 1,
    identity epilogue: the psum-staging kernel alone and with its
    ``torch.sum`` over the depth folds, against the in-kernel WS reduction
    on the same plan (device time), with the psum kernel's bound (fp32
    operations; bytes of x, w and the staging buffer written once).  The
    schedules at 224 have one depth fold each, so every layer with C >= 64
    is timed again with its channels cut into 4 depth folds (``gc4_*``),
    as the JAX package's kernel benchmark forces g_c > 1."""
    import dataclasses
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.kernels import conv2d_ws as cw
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rows = []
    for name, sched, _, batch, h in layers:
        cv = sched.nest
        x = torch.randn(batch, cv.c, h + 2, h + 2, device=dev, generator=gen)
        w = torch.randn(cv.nf, cv.c, 3, 3, device=dev, generator=gen)
        spec, *ops = cw.prepare(x, w, 1, sched.plan, "weight_stationary_psum",
                                None, Epilogue(), 1, None, None, None)
        ws_spec, *ws_ops = cw.prepare(x, w, 1, sched.plan,
                                      "weight_stationary", None, Epilogue(),
                                      1, None, None, None)
        row = {"layer": name, "h": h, "c": cv.c, "nf": cv.nf,
               "g_c": spec.cg_folds}
        row["ms"] = time_graph_ms(
            torch, lambda: cw.launch_psum(spec, *ops), reps)
        row["with_sum_ms"] = time_graph_ms(
            torch, lambda: cw.launch_psum(spec, *ops).sum(dim=0), reps)
        row["ws_ms"] = time_graph_ms(
            torch, lambda: cw.launch_ws(ws_spec, *ws_ops), reps)
        row["plain_ms"] = time_graph_ms(
            torch, lambda: cw.conv2d_folded_plain(
                x, w, plan=sched.plan, dataflow="weight_stationary_psum"), 1)
        import torch.nn.functional as F
        xin = x[:, :, 1:-1, 1:-1].contiguous()
        row["library_ms"] = time_graph_ms(
            torch, lambda: F.conv2d(xin, w, padding=1), reps)
        staging = 1
        for d in spec.output.array_shape:
            staging *= d
        row["bound_ms"], row["op_ms"], row["byte_ms"] = bound(
            2.0 * batch * cv.nf * cv.c * 9 * h * h,
            4.0 * (batch * cv.c * h * h + w.numel() + staging))
        if cv.c >= 64:
            plan4 = dataclasses.replace(
                sched.plan, c_block=cv.c // 4,
                grid=(sched.plan.grid[0], 4, sched.plan.grid[2]))
            s4, *o4 = cw.prepare(x, w, 1, plan4, "weight_stationary_psum",
                                 None, Epilogue(), 1, None, None, None)
            w4, *wo4 = cw.prepare(x, w, 1, plan4, "weight_stationary", None,
                                  Epilogue(), 1, None, None, None)
            check(s4.cg_folds == 4 and w4.cg_folds == 4,
                  f"{name}: the forced plan has {s4.cg_folds} depth folds")
            row["gc4_ms"] = time_graph_ms(
                torch, lambda: cw.launch_psum(s4, *o4), reps)
            row["gc4_with_sum_ms"] = time_graph_ms(
                torch, lambda: cw.launch_psum(s4, *o4).sum(dim=0), reps)
            row["gc4_ws_ms"] = time_graph_ms(
                torch, lambda: cw.launch_ws(w4, *wo4), reps)
        rows.append(row)
    return rows


def int8_model_forwards(torch, dev, module, params, img, x16, counts_want,
                        what):
    """Int8 forwards of a zoo model at full width: launches per forward at
    batch 1 and 4, logits against the int8 reference policy (bitwise, else
    within TOL_INT8_REF·max|ref|) and against the fp32 forward (top-1 on a
    batch of 16), and the forward times."""
    # one recipe per model, calibrated as serving calibrates it, shared by
    # every compile of the model
    recipe = module.bucket_compiler(params, img=img, device=dev,
                                    precision="int8").quant
    out = {"max_abs_err_vs_reference": 0.0}
    for b in (1, 4):
        kw = dict(img=img, batch=b, device=dev, precision="int8",
                  quant=recipe)
        net = module.compile_forward(params, **kw)
        note_verify(f"{what} int8 b{b} (first compile)", net)
        if b == 4:
            print(net.describe())
            check(all(str(s.key).endswith("/int8")
                      for _, s in net.layer_schedules),
                  f"{what}: not every schedule key is int8")
        x = x16[:b]
        y, counts = forward_counts(torch, net, params, x)
        print(f"[{what} int8] batch {b}: launches {counts}")
        check(counts == counts_want,
              f"{what} int8 batch {b}: expected launches {counts_want}")
        ref = module.compile_forward(params, policy="reference", **kw)
        with torch.inference_mode():
            want = ref(params, x)
        check(bool(torch.isfinite(y).all()) and y.shape == want.shape,
              f"{what} int8: non-finite or misshapen logits")
        err = (y - want).abs().max().item()
        tol = TOL_INT8_REF * want.abs().max().item()
        bitwise = torch.equal(y, want)
        print(f"[{what} int8] batch {b} vs int8 reference: bitwise="
              f"{bitwise} max_abs_err={err:.3e} (tol {tol:.3e})")
        check(bitwise or err <= tol,
              f"{what} int8 batch {b}: outside tolerance of the reference")
        out[f"bitwise_vs_reference_b{b}"] = bitwise
        out["max_abs_err_vs_reference"] = max(
            out["max_abs_err_vs_reference"], err)
        cell = jit_cell(torch, f"{what} int8 b{b}", net, params, x, 6)
        out.update({f"forward_b{b}_ms": cell["jit_ms"],
                    f"eager_b{b}_ms": cell["eager_ms"],
                    f"device_b{b}_ms": cell["device_ms"]})
    # against fp32: the JAX package's accuracy gate on a batch of 16
    q16 = module.compile_forward(params, img=img, batch=16, device=dev,
                                 precision="int8", quant=recipe)
    f16 = module.compile_forward(params, img=img, batch=16, device=dev)
    with torch.inference_mode():
        yq, yf = q16(params, x16), f16(params, x16)
    agree = (yq.argmax(-1) == yf.argmax(-1)).float().mean().item()
    spread = (yf.max() - yf.min()).item()
    delta = (yq - yf).abs().max().item()
    print(f"[{what} int8] vs fp32 at batch 16: top-1 agreement {agree:.4f}"
          f" (gate {INT8_TOP1}), max|delta| {delta:.4e} <= "
          f"{INT8_SPREAD} x spread {spread:.4e}")
    check(agree >= INT8_TOP1, f"{what}: int8 top-1 agreement {agree}")
    check(delta <= INT8_SPREAD * spread, f"{what}: int8 logits diverge")
    out.update(top1_agreement_b16=agree, max_abs_delta_vs_fp32=delta,
               fp32_spread=spread)
    return out


def phase_int8_models(torch, dev, vgg_params):
    from repro_torch.models import mobilenet, resnet, vgg
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x16 = torch.randn(16, 3, 224, 224, device=dev, generator=gen)
    out["vgg16_224"] = int8_model_forwards(
        torch, dev, vgg, vgg_params, 224, x16,
        launches_of(fold_conv_ws_i8=13),
        "vgg16 224")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    params = resnet.init_params(gen, img=32, device=dev)
    x16 = torch.randn(16, 3, 32, 32, device=dev, generator=gen)
    out["resnet18_32"] = int8_model_forwards(
        torch, dev, resnet, params, 32, x16,
        launches_of(fold_conv_ws_i8=5, fold_conv_os_i8=15),
        "resnet18")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    params = randomize_bn(torch, mobilenet.init_params(gen, img=32,
                                                       device=dev))
    x16 = torch.randn(16, 3, 32, 32, device=dev, generator=gen)
    out["mobilenetv2_32"] = int8_model_forwards(
        torch, dev, mobilenet, params, 32, x16,
        launches_of(fold_conv_ws_i8=7, fold_conv_os_i8=28,
                    fold_conv_dw_i8=17), "mobilenetv2")
    return out


def phase_int8_serving(torch, dev):
    """MobileNetV2 served in int8 through ``serving_summary`` (what
    ``launch.serve --vision --precision int8`` runs), its bucket forwards
    CUDA graphs and then eager: none lost, served logits bitwise equal to
    an eager direct forward with the same recipe; and the int8 conv trunk
    bitwise-identical across the bucket widths."""
    from repro_torch.core.engine import compile_network
    from repro_torch.models import mobilenet
    from repro_torch.serve.vision import VisionEngine, serving_summary
    requests = 24
    served = {}
    for jit in (True, False):
        what = "jitted" if jit else "eager"
        d = serving_summary("mobilenetv2", requests=requests, img=32,
                            width_mult=1.0, buckets=(1, 2, 4, 8), seed=SEED,
                            device=dev, precision="int8", jit=jit)
        lat, v = d["latency"], d["verify"]
        print(f"[serve int8 mobilenetv2 {what}] {d['requests']} requests / "
              f"{d['images']} images in {d['elapsed_s']:.4f} s: "
              f"{d['images_per_s']:.3f} images/s, p50 "
              f"{lat['p50_s'] * 1e3:.3f} ms, p99 {lat['p99_s'] * 1e3:.3f} "
              f"ms, batches per bucket {d['per_bucket_batches']}")
        rb = d["robustness"]
        print(f"[serve int8 mobilenetv2 {what}] served vs direct bitwise="
              f"{v['bitwise']} max_abs_err={v['max_abs_err']:.3e}")
        check(d["workload"]["precision"] == "int8", "served in the wrong "
              "precision")
        check(rb["lost_requests"] == 0
              and rb["outcomes"] == {"ok": requests},
              f"int8 serving: outcomes {rb['outcomes']}, lost "
              f"{rb['lost_requests']}")
        check(v["requests"] == requests and v["bitwise"],
              "int8 serving: served logits differ from a direct forward")
        check_primary(d, f"int8 serving {what}")
        served["jit" if jit else "eager"] = d
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    params = randomize_bn(torch, mobilenet.init_params(gen, img=32,
                                                       device=dev))
    eng = VisionEngine(params, mobilenet.to_graph(), img=32,
                       buckets=(1, 2, 4, 8), device=dev, precision="int8")
    check(eng.reference_compiler.quant is eng.compiler.quant,
          "the reference rung does not share the int8 recipe")
    x8 = torch.randn(8, 3, 32, 32, device=dev, generator=gen)
    trunk = mobilenet.to_graph(include_head=False)
    with torch.inference_mode():
        rows = {b: compile_network(params, trunk, (b, 3, 32, 32),
                                   device=dev, precision="int8",
                                   quant=eng.compiler.quant)
                for b in (1, 2, 4, 8)}
        t8 = rows[8](params, x8)
        for b in (1, 2, 4):
            for i in range(0, 8, b):
                check(torch.equal(rows[b](params, x8[i:i + b]), t8[i:i + b]),
                      f"int8 trunk rows {i}..{i + b} differ between bucket "
                      f"widths {b} and 8")
    print("[serve int8 mobilenetv2] int8 trunk rows bitwise-equal at bucket "
          "widths 1, 2, 4 and 8")
    return served


def phase_psum(torch, dev, layers):
    """The psum path through the user entry point, as the JAX package's
    kernel benchmark runs it: ``ops.conv2d(impl="fold_ws_psum")`` on each
    of VGG-16's 13 layers at 224, batch 1, and an unfused
    (identity-epilogue) WS layer whose accumulator spills.  Each output is
    held against the plain psum walk on the same inputs and plan, within
    TOL_KERNEL·max(1, max|plain|), and, as a second check, against the
    in-kernel WS (the 13 layers) or OS (the spill) kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    err = err_ws = 0.0
    for name, sched, _, batch, h in layers:
        cv = sched.nest
        x = torch.randn(batch, cv.c, h, h, device=dev, generator=gen)
        w = torch.randn(cv.nf, cv.c, 3, 3, device=dev, generator=gen)
        got = ops.conv2d(x, w, pad=1, impl="fold_ws_psum", plan=sched.plan)
        plain = cw.conv2d_folded_plain(F.pad(x, (1, 1, 1, 1)), w,
                                       plan=sched.plan,
                                       dataflow="weight_stationary_psum")
        e = (got - plain).abs().max().item()
        check(got.shape == plain.shape
              and e <= TOL_KERNEL * max(1.0, plain.abs().max().item()),
              f"psum {name}: outside tolerance of the plain psum walk")
        err = max(err, e)
        want = ops.conv2d(x, w, pad=1, impl="fold_ws", plan=sched.plan)
        e = (got - want).abs().max().item()
        check(e <= TOL_KERNEL * max(1.0, want.abs().max().item()),
              f"psum {name}: outside tolerance of fold_ws")
        err_ws = max(err_ws, e)
    plan = spill_plan()
    x = torch.randn(1, 64, 288, 288, device=dev, generator=gen)
    w = torch.randn(64, 64, 3, 3, device=dev, generator=gen)
    got = ops.conv2d(x, w, pad=1, impl="fold_ws", plan=plan)
    plain = cw.conv2d_folded_plain(F.pad(x, (1, 1, 1, 1)), w, plan=plan,
                                   dataflow="weight_stationary")
    e_spill = (got - plain).abs().max().item()
    check(got.shape == plain.shape
          and e_spill <= TOL_KERNEL * max(1.0, plain.abs().max().item()),
          "WS spill to psum: outside tolerance of the plain WS walk")
    want = ops.conv2d(x, w, pad=1, impl="fold_os", plan=plan)
    e_os = (got - want).abs().max().item()
    check(e_os <= TOL_KERNEL * max(1.0, want.abs().max().item()),
          "WS spill to psum: outside tolerance of fold_os")
    print(f"[psum] 13 VGG-16 layers at 224 vs the plain psum walk "
          f"max_abs_err {err:.3e} (vs fold_ws {err_ws:.3e}); WS spill "
          f"(conv1_2 geometry at 288) vs the plain WS walk {e_spill:.3e} "
          f"(vs fold_os {e_os:.3e})")
    return {"max_abs_err_vs_plain": max(err, e_spill),
            "max_abs_err_vs_ws": err, "spill_max_abs_err_vs_os": e_os}


# --------------------------------------------------------------------------
# bf16 through the fold engine and the head
# --------------------------------------------------------------------------

BF16_KERNELS = ("fold_conv_ws_bf16", "fold_conv_os_bf16", "fold_conv_dw_bf16",
                "fold_conv_psum_bf16")


def psum_extra(torch, x, w, stride=1, pad=0):
    """An upper bound of the magnitudes of a psum layer's depth folds,
    summed: ``F.conv2d(|x|, |w|)`` in fp32 (each fold's partial sum is
    rounded to bf16 on its own, so the kernel and the plain walk may
    differ by a bf16 step of each fold)."""
    import torch.nn.functional as F
    return F.conv2d(x.float().abs(), w.float().abs(), stride=stride,
                    padding=pad)


def phase_bf16_kernels(torch, dev, cases, dw_cases):
    """Each bf16 kernel instance against its plain version on phase 2's
    geometries (every epilogue, the depthwise and grouped cases), the
    psum staging on each dense geometry with an identity epilogue (forced
    depth folds included), under the bf16 rule.  Returns the largest
    error by kernel."""
    from repro_torch.kernels import conv2d_ws as cw
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    errs = dict.fromkeys(BF16_KERNELS, 0.0)

    def rand(*shape, fan=1):
        return (torch.randn(*shape, device=dev, generator=gen)
                / fan ** 0.5).to(bf)

    def run(name, x, w, what, **kw):
        before = cw.launch_counts()[name]
        got = cw.conv2d_folded(x, w, **kw)
        torch.cuda.synchronize()
        check(cw.launch_counts()[name] == before + 1, f"{name} did not "
              "launch")
        extra = None
        if kw["dataflow"] == "weight_stationary_psum":
            extra = psum_extra(torch, x, w, kw.get("stride", 1))
        errs[name] = max(errs[name], bf16_err(
            torch, got, cw.conv2d_folded_plain(x, w, **kw),
            f"{name} {what}", extra))

    def ops_of(epi, n, nf, p, q):
        return {k: v.to(bf) for k, v in epi_operands(
            torch, gen, dev, epi, n, nf, p, q).items()}

    for (n, c, h, w_, nf, r, s, st, pad, epi, plan) in cases:
        x = rand(n, c, h + 2 * pad, w_ + 2 * pad)
        w = rand(nf, c, r, s, fan=c * r * s)
        p, q = (h + 2 * pad - r) // st + 1, (w_ + 2 * pad - s) // st + 1
        what = f"n={n} c={c} {h}x{w_} nf={nf} {r}x{s}/s{st}"
        ops = ops_of(epi, n, nf, p, q)
        for name, df in (("fold_conv_ws_bf16", "weight_stationary"),
                         ("fold_conv_os_bf16", "output_stationary")):
            run(name, x, w, what, stride=st, plan=plan, dataflow=df,
                epilogue=epi, **ops)
        run("fold_conv_psum_bf16", x, w, what, stride=st, plan=plan,
            dataflow="weight_stationary_psum")
    for (n, c, h, w_, st, epi, c_b) in dw_cases:
        from repro_torch.core.mapping import ConvBlockPlan
        x = rand(n, c, h + 2, w_ + 2)
        w = rand(c, 1, 3, 3, fan=9)
        p, q = (h - 1) // st + 1, (w_ - 1) // st + 1
        plan = None if c_b is None else ConvBlockPlan(
            nf_block=c_b, c_block=c_b, p_block=4, grid=(1, -(-c // c_b), 1),
            vmem_bytes=0, groups=c)
        run("fold_conv_dw_bf16", x, w, f"n={n} c={c} {h}x{w_} 3x3/s{st}",
            stride=st, plan=plan, dataflow="depthwise", epilogue=epi,
            groups=c, **ops_of(epi, n, c, p, q))
    for (n, c, h, nf, g, r, st, pad, epi) in grouped_cases():
        x = rand(n, c, h + 2 * pad, h + 2 * pad)
        w = rand(nf, c // g, r, r, fan=c // g * r * r)
        p = (h + 2 * pad - r) // st + 1
        ops = ops_of(epi, n, nf, p, p)
        for name, df in (("fold_conv_ws_bf16", "weight_stationary"),
                         ("fold_conv_os_bf16", "output_stationary")):
            run(name, x, w, f"grouped n={n} c={c} {h}x{h} nf={nf} G={g}",
                stride=st, dataflow=df, epilogue=epi, groups=g, **ops)
    print("[bf16] kernels against their plain versions (phase 2's "
          "geometries, psum on each dense one): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def bf16_psum_operands(torch, dev, layers):
    """bf16 x (unpadded) and w of each of ``layers``, from one seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    out = []
    for name, sched, _, batch, h in layers:
        cv = sched.nest
        x = torch.randn(batch, cv.c, h, h, device=dev, generator=gen)
        w = torch.randn(cv.nf, cv.c, 3, 3, device=dev, generator=gen)
        out.append((name, sched, x.to(torch.bfloat16),
                    (w / (cv.c * 9) ** 0.5).to(torch.bfloat16)))
    return out


def phase_bf16_psum(torch, dev, layers):
    """The bf16 psum path through the user entry point:
    ``ops.conv2d(impl="fold_ws_psum")`` on each of VGG-16's 13 layers at
    224, batch 1, in bf16, held against the plain psum walk (the bf16
    rule, widened by the folds' magnitudes).  Returns the largest
    error."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.kernels import ops
    err = 0.0
    for name, sched, x, w in bf16_psum_operands(torch, dev, layers):
        got = ops.conv2d(x, w, pad=1, impl="fold_ws_psum", plan=sched.plan)
        err = max(err, bf16_err(
            torch, got, cw.conv2d_folded_plain(
                F.pad(x, (1, 1, 1, 1)), w, plan=sched.plan,
                dataflow="weight_stationary_psum"),
            f"bf16 psum {name}", psum_extra(torch, x, w, pad=1)))
    print(f"[bf16] psum path: 13 VGG-16 layers at 224 vs the plain psum "
          f"walk, max abs err {err:.3e}")
    return err


def time_bf16_psum(torch, dev, layers, reps):
    """The bf16 psum staging kernel on VGG-16's 13 layers at 224, batch 1:
    its launch (device time), the plain walk and ``F.conv2d`` in bf16,
    with the bound (2-byte elements, the bf16 tensor-core rate)."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_ws as cw
    rows = []
    for name, sched, x, w in bf16_psum_operands(torch, dev, layers):
        cv = sched.nest
        batch, h = x.shape[0], x.shape[2]
        xp = F.pad(x, (1, 1, 1, 1))
        kw = dict(plan=sched.plan, dataflow="weight_stationary_psum")
        spec, xk, wk, *_ = cw.prepare(xp, w, 1, sched.plan,
                                      "weight_stationary_psum", None, None,
                                      1, None, None, None)
        row = {"layer": name, "c": cv.c, "nf": cv.nf, "h": h,
               "g_c": spec.cg_folds,
               "tile": cw.fold_tile(spec, batch, cw._sm_count(dev),
                                    dtype=torch.bfloat16).index}
        row["ms"] = time_graph_ms(torch, lambda: cw.launch_psum(spec, xk, wk),
                                  reps)
        row["plain_ms"] = time_graph_ms(
            torch, lambda: cw.conv2d_folded_plain(xp, w, **kw), 2)
        row["library_ms"] = time_graph_ms(
            torch, lambda: F.conv2d(x, w, padding=1), max(reps, 10))
        row["bound_ms"], row["op_ms"], row["byte_ms"] = bound(
            2.0 * batch * cv.nf * cv.c * 9 * h * h,
            2.0 * (x.numel() + w.numel() + batch * cv.nf * h * h),
            BF16_TC_PEAK)
        rows.append(row)
    return rows


def phase_bf16_tc_tiles(torch, dev):
    """Each tensor-core tile (``TC_TILES``; WS and psum the first
    ``TC_WS_TILES``) forced through ``launch_ws(tile=)``,
    ``launch_os(tile=)`` and ``launch_psum(tile=)``, against the plain walk
    under the bf16 rule: 2 images of 48 channels, 17 x 19 outputs (ragged
    P and Q against every tile), 40 filters (ragged against 16, 32 and
    64), 3x3, at g_c = 1, 3 and 4 (c_block 48, 16, 12), WS and OS with
    bias + ReLU + pool and with every step but the pool, psum with its
    identity; each OS tile bitwise the WS tiles on the same epilogue.
    Returns the largest error by kernel."""
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.mapping import ConvBlockPlan
    from repro_torch.kernels import conv2d_ws as cw
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    n, c, h, w_, nf = 2, 48, 17, 19, 40

    def rand(*shape, fan=1):
        return (torch.randn(*shape, device=dev, generator=gen)
                / fan ** 0.5).to(bf)

    x, w = rand(n, c, h + 2, w_ + 2), rand(nf, c, 3, 3, fan=c * 9)
    ops = {"bias": rand(nf), "shift": rand(nf), "residual": rand(n, nf, h, w_),
           "scale": (1.0 + 0.2 * torch.randn(nf, device=dev,
                                             generator=gen)).to(bf)}
    every = Epilogue(bias=True, scale=True, residual=True, relu6=True)
    pooled = Epilogue(bias=True, relu=True, pool="max2")
    errs = {"fold_conv_ws_bf16": 0.0, "fold_conv_os_bf16": 0.0,
            "fold_conv_psum_bf16": 0.0}
    runs = 0
    for c_b in (48, 16, 12):
        plan = ConvBlockPlan(nf_block=nf, c_block=c_b, p_block=6,
                             grid=(1, c // c_b, 3), vmem_bytes=0)
        first = {}
        for name, df, epi in (
                ("fold_conv_ws_bf16", "weight_stationary", pooled),
                ("fold_conv_ws_bf16", "weight_stationary", every),
                ("fold_conv_os_bf16", "output_stationary", pooled),
                ("fold_conv_os_bf16", "output_stationary", every),
                ("fold_conv_psum_bf16", "weight_stationary_psum",
                 Epilogue())):
            kw = {k: v for k, v in ops.items()
                  if getattr(epi, k, False) or (k == "shift" and epi.scale)}
            spec, *prep = cw.prepare(x, w, 1, plan, df, kw.get("bias"), epi,
                                     1, kw.get("residual"), kw.get("scale"),
                                     kw.get("shift"))
            check(spec.cg_folds == c // c_b, f"g_c {spec.cg_folds}")
            want = cw.conv2d_folded_plain(x, w, plan=plan, dataflow=df,
                                          epilogue=epi, **kw)
            extra = psum_extra(torch, x, w) if name.startswith(
                "fold_conv_psum") else None
            for t in range(cw.tile_count("tc", df)):
                got = cw._finish(spec, cw.LAUNCHERS[df](spec, *prep, tile=t),
                                 bf)
                errs[name] = max(errs[name], bf16_err(
                    torch, got, want, f"{name} g_c={c // c_b} "
                    f"epi={epi} tensor-core tile {t}", extra))
                runs += 1
                ref = first.setdefault(str(epi), got)
                check(torch.equal(got, ref), f"{name} g_c={c // c_b} "
                      f"epi={epi} tile {t}: not bitwise the WS tiles")
    print(f"[bf16] every tensor-core tile forced ({runs} launches, g_c 1, "
          f"3, 4, ragged P, Q and NF) against the plain walk, OS bitwise "
          f"WS: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def os_tiles_bitwise(torch, cw, x, w, what, **kw):
    """One bf16 layer launched output-stationary with every tensor-core
    tile and weight-stationary with its picked tile, on one plan: every
    output bitwise the first OS tile's, which is held against the plain
    walk under the bf16 rule.  Returns (the OS output, its largest error,
    the launches made)."""
    args = (x, w, kw.get("stride", 1), kw.get("plan"))
    outs, launches = [], 0
    for df in ("output_stationary", "weight_stationary"):
        spec, *ops = cw.prepare(*args, df, kw.get("bias"), kw.get("epilogue"),
                                kw.get("groups", 1), kw.get("residual"),
                                kw.get("scale"), kw.get("shift"))
        if spec.dataflow != df:
            continue            # WS spilled to another kernel: no partner
        tiles = range(cw.tile_count("tc", df)) if df == "output_stationary" \
            else [None]
        for t in tiles:
            outs.append(cw._finish(spec, cw.LAUNCHERS[df](spec, *ops, tile=t),
                                   torch.bfloat16))
            launches += 1
    err = bf16_err(torch, outs[0], cw.conv2d_folded_plain(
        x, w, dataflow="output_stationary", **{
            k: v for k, v in kw.items() if k != "dataflow"}), f"bf16 OS {what}")
    for i, o in enumerate(outs[1:], 1):
        check(torch.equal(o, outs[0]), f"bf16 {what}: "
              + ("OS tile " + str(i) if i < cw.tile_count(
                  "tc", "output_stationary") else "the WS launch")
              + " is not bitwise OS tile 0")
    return outs[0], err, launches


def phase_bf16_os(torch, dev, cases):
    """Every OS tensor-core tile forced on phase 2's geometries (every
    epilogue; the grouped layers too) and on the 54 OS layers of VGG-16,
    ResNet-18 and MobileNetV2 at 32 (full width), each at batch 4 and on
    its first image alone: the tiles bitwise one another and the
    weight-stationary launch of the same layer and plan, batch 1 bitwise
    row 0 of batch 4, within the bf16 rule of the plain walk.  Returns
    the largest error."""
    from repro_torch.kernels import conv2d_ws as cw
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 46)

    def rand(*shape, fan=1):
        return (torch.randn(*shape, device=dev, generator=gen)
                / fan ** 0.5).to(bf)

    def ops_of(epi, n, nf, p, q):
        return {k: v.to(bf) for k, v in epi_operands(
            torch, gen, dev, epi, n, nf, p, q).items()}

    err, launches, geoms = 0.0, 0, 0
    for (n, c, h, w_, nf, r, s_, st, pad, epi, plan) in cases:
        x = rand(n, c, h + 2 * pad, w_ + 2 * pad)
        w = rand(nf, c, r, s_, fan=c * r * s_)
        p, q = (h + 2 * pad - r) // st + 1, (w_ + 2 * pad - s_) // st + 1
        _, e, k = os_tiles_bitwise(
            torch, cw, x, w, f"n={n} c={c} {h}x{w_} nf={nf} {r}x{s_}/s{st}",
            stride=st, plan=plan, epilogue=epi, **ops_of(epi, n, nf, p, q))
        err, launches, geoms = max(err, e), launches + k, geoms + 1
    for (n, c, h, nf, g, r, st, pad, epi) in grouped_cases():
        x = rand(n, c, h + 2 * pad, h + 2 * pad)
        w = rand(nf, c // g, r, r, fan=c // g * r * r)
        p = (h + 2 * pad - r) // st + 1
        _, e, k = os_tiles_bitwise(
            torch, cw, x, w, f"grouped n={n} c={c} {h}x{h} nf={nf} G={g}",
            stride=st, epilogue=epi, groups=g, **ops_of(epi, n, nf, p, p))
        err, launches, geoms = max(err, e), launches + k, geoms + 1
    zoo = 0
    for model in ("vgg16", "resnet18", "mobilenetv2"):
        for name, sched, cv, epi in model_layers(model, 32, 4):
            if sched.dataflow != "output_stationary":
                continue
            x = rand(cv.n, cv.c, cv.x + 2 * cv.pad, cv.y + 2 * cv.pad)
            w = rand(cv.nf, cv.c // cv.groups, cv.r, cv.s,
                     fan=cv.c // cv.groups * cv.r * cv.s)
            ops = ops_of(epi, cv.n, cv.nf, cv.p, cv.q)
            kw = dict(stride=cv.stride, plan=sched.plan, epilogue=epi,
                      groups=cv.groups)
            y4, e, k = os_tiles_bitwise(torch, cw, x, w,
                                        f"{model} {name} b4", **kw, **ops)
            y1, e1, k1 = os_tiles_bitwise(
                torch, cw, x[:1], w, f"{model} {name} b1", **kw,
                **{key: v[:1] if key == "residual" else v
                   for key, v in ops.items()})
            check(torch.equal(y1[0], y4[0]), f"bf16 OS {model} {name}: "
                  "batch 1 is not bitwise row 0 of batch 4")
            err, launches, zoo = max(err, e, e1), launches + k + k1, zoo + 1
    check(zoo == 54, f"{zoo} OS layers in the zoo at 32, expected 54")
    print(f"[bf16] OS: every tensor-core tile on {geoms} phase 2 "
          f"geometries and the zoo's {zoo} OS layers at 32 (batch 4 and 1), "
          f"{launches} launches: bitwise across tiles, batch widths and the "
          f"weight-stationary launch of the same layer; max abs err vs the "
          f"plain walk {err:.3e}")
    return err


def phase_bf16_trunk(torch, dev, params):
    """The bf16 VGG-16 trunk at 224 (full width, ``params`` in bf16) row
    by row bitwise at batch widths 1 and 4, as phase 3 holds fp32's: the
    tensor-core sums' 16-tap steps do not depend on the batch."""
    from repro_torch.core.engine import compile_network
    from repro_torch.models import vgg
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    x4 = torch.randn(4, 3, 224, 224, device=dev,
                     generator=gen).to(torch.bfloat16)
    trunks = {b: compile_network(params, vgg.to_graph(include_head=False),
                                 (b, 3, 224, 224), device=dev)
              for b in (1, 4)}
    with torch.inference_mode():
        t4 = trunks[4](params, x4)
        for i in range(4):
            t1 = trunks[1](params, x4[i:i + 1])
            check(t1.dtype == torch.bfloat16 and torch.equal(t1[0], t4[i]),
                  f"bf16 trunk row {i} differs between batch 1 and batch 4")
    print("[bf16] VGG-16 224 trunk rows bitwise-equal at batch 1 and "
          "batch 4")


def phase_bf16_models(torch, dev, fp32_ms):
    """bf16 forwards compiled from ``init_params(dtype=torch.bfloat16)``:
    VGG-16 at 224, batch 1, and MobileNetV2 (random batch-norm statistics)
    and ResNet-18 at 32, batch 4.  Each: one launch of a bf16 instance
    per conv and of the bf16 head per dense layer, counted on the eager
    forward and on the capture; the jitted forward bitwise the eager one;
    bf16 logits within TOL_BF16_MODEL·max(1, max|ref|) of the reference
    policy on the same bf16 parameters; its jitted / eager / device ms
    beside the fp32 forward's (``fp32_ms``, from phases 3, 6 and 7)."""
    from repro_torch.models import mobilenet, resnet, vgg
    bf = torch.bfloat16
    out = {}
    for what, module, img, b, counts_want in (
            ("vgg16 224", vgg, 224, 1,
             launches_of(fold_conv_ws_bf16=13)),
            ("mobilenetv2 32", mobilenet, 32, 4,
             launches_of(fold_conv_ws_bf16=7, fold_conv_os_bf16=28,
                         fold_conv_dw_bf16=17)),
            ("resnet18 32", resnet, 32, 4,
             launches_of(fold_conv_ws_bf16=5, fold_conv_os_bf16=15))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 50)
        params = module.init_params(gen, img=img, device=dev, dtype=bf)
        if module is mobilenet:
            randomize_bn(torch, params)
        x = torch.randn(b, 3, img, img, device=dev, generator=gen).to(bf)
        net = module.compile_forward(params, img=img, batch=b, device=dev)
        check(net.dtype == bf, f"bf16 {what}: compiled for {net.dtype}")
        y, counts = forward_counts(torch, net, params, x)
        check(counts == counts_want, f"bf16 {what}: launches {counts}")
        ref = module.compile_forward(params, img=img, batch=b,
                                     policy="reference", device=dev)
        with torch.inference_mode():
            want = ref(params, x)
        check(y.dtype == want.dtype == bf and y.shape == want.shape,
              f"bf16 {what}: logits {y.dtype} {tuple(y.shape)}")
        check(bool(torch.isfinite(y.float()).all()),
              f"bf16 {what}: non-finite logits")
        e = (y.float() - want.float()).abs().max().item()
        tol = TOL_BF16_MODEL * max(1.0, want.float().abs().max().item())
        cell = jit_cell(torch, f"{what} b{b} bf16", net, params, x,
                        6 if img == 224 else 10)
        row = {"jit_ms": cell["jit_ms"], "eager_ms": cell["eager_ms"],
               "device_ms": cell["device_ms"], "max_abs_err_vs_ref": e,
               "tol": tol, "fp32_jit_ms": fp32_ms[what]}
        print(f"[bf16] {what} b{b}: launches "
              f"{ {k: v for k, v in counts.items() if v} }, jitted bitwise "
              f"the eager forward, logits vs the reference policy max abs "
              f"err {e:.3e} (tol {tol:.3e}); jitted {cell['jit_ms']:.4f} ms "
              f"(eager {cell['eager_ms']:.4f}, device work "
              f"{cell['device_ms']:.4f}) against fp32's jitted "
              f"{fp32_ms[what]:.4f} ms")
        check(e <= tol, f"bf16 {what}: outside tolerance of the reference "
              "policy")
        out[what] = row
    return out


# --------------------------------------------------------------------------
# HTTP serving: the transport, the router, in-process and spawned workers
# --------------------------------------------------------------------------

HTTP_USERS = 8        # concurrent keep-alive clients over the wire


class _Guard:
    requested = False


def wire_stream():
    """Phase 8's stream as ``serving_summary`` draws it: PHASE8_REQUESTS
    requests of 1-8 images of 3x32x32 from ``SEED``."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(1, 9, PHASE8_REQUESTS)
    return [rng.standard_normal((int(n), 3, 32, 32)).astype(np.float32)
            for n in sizes]


async def wire_serve(host, port, imgs, users):
    """Every request of ``imgs`` over the wire, base64 payloads (encoded
    before the clock starts), from ``users`` concurrent keep-alive
    clients; returns (responses in request order, wall seconds, each
    request's seconds)."""
    import asyncio
    from repro_torch.serve.transport import HttpClient, encode_images_payload
    payloads = [encode_images_payload(im) for im in imgs]
    todo = list(range(len(imgs)))
    results, lat = [None] * len(imgs), [0.0] * len(imgs)

    async def user():
        client = HttpClient(host, port)
        try:
            while todo:
                i = todo.pop(0)
                t0 = time.perf_counter()
                results[i] = await client.request("POST", "/v1/infer",
                                                  payloads[i])
                lat[i] = time.perf_counter() - t0
        finally:
            await client.close()

    t0 = time.perf_counter()
    await asyncio.gather(*(user() for _ in range(users)))
    return results, time.perf_counter() - t0, lat


def http_call(handle, method, path, payload=None, headers=None):
    import asyncio
    from repro_torch.serve.transport import http_json
    return asyncio.run(http_json(handle.host, handle.port, method, path,
                                 payload, headers))


def serve_wire(torch, handle, imgs, direct, what):
    """Serve ``imgs`` through a running server; every response 200 from
    the primary rung, its logits bitwise a direct submission of the same
    images to an in-process ``VisionEngine`` worker (``direct``: by worker
    name, or one worker for all); /stats with no lost request.  Returns
    images/s and latency percentiles over the wire."""
    import asyncio
    import numpy as np
    results, wall, lat = asyncio.run(wire_serve(handle.host, handle.port,
                                                imgs, HTTP_USERS))
    workers = {}
    for (status, obj), im in zip(results, imgs):
        check(status == 200 and obj.get("outcome") == "ok"
              and obj.get("served_by") == "primary",
              f"{what}: a request ended {status} {obj.get('outcome')}")
        worker = direct.get(obj["worker"], direct.get("*"))
        want = worker.submit(im).result(120.0)
        check(want.outcome.value == "ok" and np.array_equal(
            np.asarray(obj["logits"], np.float32), want.logits),
            f"{what}: served logits differ from a direct submission")
        workers[obj["worker"]] = workers.get(obj["worker"], 0) + 1
    status, stats = http_call(handle, "GET", "/stats")
    check(status == 200 and stats["totals"]["lost_requests"] == 0,
          f"{what}: /stats {status} lost {stats['totals']['lost_requests']}")
    n_img = sum(im.shape[0] for im in imgs)
    lat_ms = np.asarray(lat) * 1e3
    row = {"requests": len(imgs), "images": n_img, "wall_s": wall,
           "images_per_s": n_img / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "by_worker": workers, "lost_requests": 0}
    print(f"[http] {what}: {len(imgs)} requests / {n_img} images over the "
          f"wire ({HTTP_USERS} clients) in {wall:.4f} s: "
          f"{row['images_per_s']:.3f} images/s, p50 {row['p50_ms']:.3f} "
          f"ms, p99 {row['p99_ms']:.3f} ms, by worker {workers}; every "
          "logit bitwise a direct submission, 0 lost")
    return row


def wire_status_checks(torch, handle):
    """One 400 (an empty body, and images in NHWC), one 413 (a declared
    body over the cap, refused from the headers), one 429 or 504 (a
    deadline no batch can meet), /metrics parseable and /metrics.json
    valid."""
    import asyncio
    import numpy as np
    from repro_torch.obs.metrics import validate_metrics_snapshot
    from repro_torch.serve.transport import encode_images_payload
    got = {}
    got["empty"] = http_call(handle, "POST", "/v1/infer")[0]
    got["nhwc"] = http_call(handle, "POST", "/v1/infer", encode_images_payload(
        np.zeros((1, 32, 32, 3), np.float32)))[0]

    async def oversized():
        reader, writer = await asyncio.open_connection(handle.host,
                                                       handle.port)
        writer.write(b"POST /v1/infer HTTP/1.1\r\n"
                     b"Content-Length: 999999999\r\n\r\n")
        await writer.drain()
        line = await reader.readline()
        writer.close()
        return int(line.split()[1])

    got["oversized"] = asyncio.run(oversized())
    got["deadline"] = http_call(
        handle, "POST", "/v1/infer",
        encode_images_payload(wire_stream()[0]),
        headers={"X-Deadline-S": "0.000001"})[0]
    status, text = http_call(handle, "GET", "/metrics")
    got["metrics"] = status
    status, snap = http_call(handle, "GET", "/metrics.json")
    got["metrics_json"] = status
    problems = validate_metrics_snapshot(snap)
    print(f"[http] statuses {got}; /metrics parses "
          f"{prometheus_parses(text)}, /metrics.json problems {problems}")
    check(got["empty"] == got["nhwc"] == 400, "expected 400s")
    check(got["oversized"] == 413, "expected 413")
    check(got["deadline"] in (429, 504), "expected 429 or 504")
    check(got["metrics"] == got["metrics_json"] == 200
          and prometheus_parses(text) and problems == [],
          "metrics endpoints")
    return got


async def drain_probe(host, port, proc):
    """SIGTERM ``proc`` (a spawned worker) with two keep-alive connections
    open to it: /healthz on one until it reports draining, then a POST on
    the other.  The worker finishes its shutdown only when its
    connections close, so both are answered during the drain."""
    import asyncio
    import signal
    from repro_torch.serve.transport import HttpClient, encode_images_payload
    health, infer = HttpClient(host, port), HttpClient(host, port)
    try:
        for c in (health, infer):
            check((await c.request("GET", "/healthz"))[0] == 200,
                  "spawned worker not healthy before SIGTERM")
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30.0
        while True:
            h_status, h_obj = await health.request("GET", "/healthz")
            if h_status == 503 or time.monotonic() > deadline:
                break
            await asyncio.sleep(0.005)
        i_status, i_obj = await infer.request(
            "POST", "/v1/infer", encode_images_payload(wire_stream()[0]))
        return (h_status, h_obj), (i_status, i_obj)
    finally:
        await health.close()
        await infer.close()


def phase_http(torch, dev, phase8):
    """Full-width MobileNetV2 (phase 8's configuration) served over HTTP
    through ``launch/server.start_server``: 2 in-process workers, 1
    in-process worker, then one ``--spawn`` worker subprocess; phase 8's
    stream of requests each time (``serve_wire``), the status checks on
    the 2-worker server, and the spawned worker's SIGTERM drain (503 on
    /healthz and /v1/infer while it drains, exit 0)."""
    import asyncio
    from repro_torch.launch.server import start_server
    imgs = wire_stream()
    kw = dict(img=32, width_mult=1.0, classes=10, buckets=(1, 2, 4, 8),
              seed=SEED, device=dev)
    out = {}
    two = start_server("mobilenetv2", n_workers=2, guard=_Guard(), **kw)
    spawned = None
    try:
        direct = {w.name: w.worker for w in two.workers}
        out["in_process_2"] = serve_wire(torch, two, imgs, direct,
                                         "2 in-process workers")
        # the same stream with the interpreter's thread switch interval at
        # 0.1 ms (5 ms by default): a request crosses four threads of this
        # process (the clients' loop, the server's loop, a worker and back)
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            out["in_process_2_switch_0p1ms"] = serve_wire(
                torch, two, imgs, direct,
                "2 in-process workers, switch interval 0.1 ms")
        finally:
            sys.setswitchinterval(switch)
        out["statuses"] = wire_status_checks(torch, two)
        one = start_server("mobilenetv2", n_workers=1, guard=_Guard(), **kw)
        try:
            out["in_process_1"] = serve_wire(
                torch, one, imgs, {"*": one.workers[0].worker},
                "1 in-process worker")
        finally:
            one.stop()
        t0 = time.perf_counter()
        spawned = start_server("mobilenetv2", n_workers=1, spawn=True,
                               guard=_Guard(), **kw)
        out["spawn_boot_s"] = time.perf_counter() - t0
        print(f"[http] spawned worker booted in {out['spawn_boot_s']:.2f} s "
              "(torch import, compile, captures of 4 buckets)")
        out["spawned_1"] = serve_wire(torch, spawned, imgs,
                                      {"*": two.workers[0].worker},
                                      "1 spawned worker")
        remote = spawned.workers[0]
        (h_status, h_obj), (i_status, i_obj) = asyncio.run(
            drain_probe(remote.host, remote.port, remote.proc))
        code = remote.proc.wait(120)
        print(f"[http] spawned worker SIGTERM: /healthz {h_status} "
              f"{h_obj.get('status')}, /v1/infer {i_status} "
              f"{i_obj.get('outcome')}, exit code {code}")
        check(h_status == 503 and i_status == 503
              and i_obj.get("outcome") == "draining" and code == 0,
              "the spawned worker's SIGTERM drain")
        out["sigterm"] = {"healthz": h_status, "infer": i_status,
                          "exit": code}
    finally:
        if spawned is not None:
            spawned.stop()
        two.stop()
    print(f"[http] images/s over the wire: 2 in-process workers "
          f"{out['in_process_2']['images_per_s']:.3f}, 1 in-process "
          f"{out['in_process_1']['images_per_s']:.3f}, 1 spawned "
          f"{out['spawned_1']['images_per_s']:.3f}; phase 8 in-process "
          f"(no wire) {phase8['images_per_s']:.3f} images/s, p50 "
          f"{phase8['latency']['p50_s'] * 1e3:.3f} ms, p99 "
          f"{phase8['latency']['p99_s'] * 1e3:.3f} ms")
    return out


# --------------------------------------------------------------------------
# the LM side: the causal conv1d and fold-attention kernels, zamba2-1.2b
# --------------------------------------------------------------------------

ZAMBA = "zamba2-1.2b"
PREFILL_B, PREFILL_T = 2, 2048       # the prefill cell: batch 2, 2048 tokens
# zamba2's shared attention at the prefill cell: (B, T, H, KV, hd)
ZAMBA_ATTN = (PREFILL_B, PREFILL_T, 32, 32, 64)
# the attention kernel against its plain version: tests/test_attention_
# kernel.py's tolerances (fp32 sums in another order; bf16 output
# rounding), scaled by max(1, max|plain|).  bf16 is held element by element
# as well: both sides do fp32 math on the same bf16 inputs and round once,
# so each output lies within one bf16 step (2^-7 of its value) of the
# plain one, plus the fp32 tolerance for the sums' order.
TOL_ATTN = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_STEP = 2.0 ** -7
TOL_DECODE = 2e-3    # decode vs forward (tests/test_decode_consistency.py)


def conv1d_case(torch, gen, dev, dtype, b, t, d, k, prefix, offset=False):
    """Random x (B, T, D) and w (K, D) in ``dtype``; with ``prefix`` the
    model's cache-prefixed form: K-1 random cached rows in front of x,
    their outputs dropped after the conv; with ``offset`` x starts one
    element into its storage, off the 16-byte grid."""
    x = torch.randn(b, t, d, device=dev, generator=gen).to(dtype)
    w = torch.randn(k, d, device=dev, generator=gen).to(dtype)
    if prefix:
        tail = torch.randn(b, k - 1, d, device=dev, generator=gen).to(dtype)
        x = torch.cat([tail, x], dim=1)
    if offset:
        buf = torch.empty(x.numel() + 1, device=dev, dtype=dtype)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    return x, w


def phase_lm_kernels(torch, dev):
    """The conv1d kernel bitwise against its plain version, the attention
    kernel within TOL_ATTN of its plain version, in fp32 and bf16 (bf16
    also element by element within BF16_STEP)."""
    from repro_torch.kernels import attention_fold as af
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    # (B, T, D, K, cache prefix, x off the 16-byte grid); the vector path
    # takes D a multiple of 8 (bf16) or 4 (fp32) on 16-byte boundaries
    conv_cases = [
        (PREFILL_B, PREFILL_T, 4224, 4, False, False),  # zamba2's prefill
        (2, 100, 300, 4, False, False),   # D not a multiple of 8 or 128
        (2, 1, 4224, 4, False, False),    # T = 1
        (2, 77, 256, 2, False, False), (2, 77, 256, 3, False, False),
        (2, 77, 256, 1, False, False), (2, 77, 256, 8, False, False),
        (1, 2, 64, 4, False, False),      # T < K - 1
        (2, 77, 267, 4, False, False),    # D = 8k + 3: the scalar path
        (2, 77, 4224, 4, False, True),    # off the grid: the scalar path
        (2, 16, 4224, 4, True, False),    # the cache-prefixed form
    ]
    # the fp32 and bf16 attention instances: af.KERNEL and its _bf16 entry
    errs = {cc.KERNEL: 0.0, af.KERNEL: 0.0, f"{af.KERNEL}_bf16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, d, k, prefix, offset in conv_cases:
            x, w = conv1d_case(torch, gen, dev, dtype, b, t, d, k, prefix,
                               offset)
            path = "vector" if cc.vector_path(x, w) else "scalar"
            drop = k - 1 if prefix else 0   # the cached rows' outputs
            want = cc.conv1d_causal_plain(x, w)[:, drop:]
            # a bf16 x with its w in bf16 (the model's; widened in the
            # kernel) and in fp32
            for wk in [w] if dtype == torch.float32 else [w, w.float()]:
                before = cc.launch_counts()[cc.KERNEL]
                got = cc.conv1d_causal_folded(x, wk)
                torch.cuda.synchronize()
                check(cc.launch_counts()[cc.KERNEL] == before + 1,
                      "conv1d_causal did not launch")
                got = got[:, drop:]
                same = got.shape == want.shape and torch.equal(got, want)
                print(f"[lm kernels] conv1d_causal {str(dtype)[6:]} B={b} "
                      f"T={t} D={d} K={k} w {str(wk.dtype)[6:]}"
                      f"{' cache-prefixed' if prefix else ''}"
                      f"{' offset' if offset else ''} {path} path "
                      f"bitwise={same}")
                check(same, "conv1d_causal is not bitwise its plain version")
    # (B, T, H, KV, hd, causal, window)
    attn_cases = [
        ZAMBA_ATTN + (True, 0),                   # zamba2's causal case
        (1, 512, 32, 8, 64, True, 0),             # GQA
        (1, 256, 8, 1, 64, True, 0),              # MQA
        (1, PREFILL_T, 8, 8, 64, True, 1024),     # a 1024-token window
        (1, 512, 8, 4, 64, False, 0),             # non-causal
        (2, 1000, 4, 2, 64, True, 0),             # T not a multiple of 64
        (1, 256, 4, 4, 128, True, 0),             # hd 128
    ]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for b, t, h, kv, hd, causal, window in attn_cases:
            q = torch.randn(b, t, h, hd, device=dev, generator=gen).to(dtype)
            k = torch.randn(b, t, kv, hd, device=dev, generator=gen).to(dtype)
            v = torch.randn(b, t, kv, hd, device=dev, generator=gen).to(dtype)
            kw = dict(causal=causal, window=window)
            before = af.launch_counts()[af.KERNEL]
            got = af.flash_attention_folded(q, k, v, **kw)
            torch.cuda.synchronize()
            check(af.launch_counts()[af.KERNEL] == before + 1,
                  "attention_fold did not launch")
            want = af.flash_attention_folded_plain(q, k, v, **kw)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  "attention_fold: wrong output shape or type")
            diff = (got.float() - want.float()).abs()
            scale = max(1.0, want.float().abs().max().item())
            err, tol = diff.max().item(), TOL_ATTN[name] * scale
            worst = 0.0     # the largest share of its element-wise limit
            if dtype == torch.bfloat16:
                limit = (BF16_STEP * want.float().abs()
                         + TOL_ATTN["float32"] * scale)
                worst = (diff / limit).max().item()
            print(f"[lm kernels] attention_fold {name} B={b} T={t} H={h} "
                  f"KV={kv} hd={hd} causal={causal} window={window} "
                  f"max_abs_err={err:.3e} (tol {tol:.3e})"
                  + (f" worst/element-limit={worst:.3f}"
                     if dtype == torch.bfloat16 else ""))
            check(err <= tol and worst <= 1.0,
                  "attention_fold disagrees with its plain version")
            key = af.KERNEL + ("_bf16" if dtype == torch.bfloat16 else "")
            errs[key] = max(errs[key], err)
    # one device kernel per call, at zamba2's shape
    per_call = {}
    b, t, h, kv, hd = ZAMBA_ATTN
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(b, t, n, hd, device=dev, generator=gen)
                   .to(dtype) for n in (h, kv, kv))
        per_call[str(dtype)[6:]] = graph_kernels(
            torch, lambda: af.launch(q, k, v, causal=True, window=0),
            f"attention {str(dtype)[6:]}")
        print(f"[lm kernels] attention_fold {str(dtype)[6:]}: device kernels "
              f"per call {per_call[str(dtype)[6:]]}")
    return errs, per_call


def time_lm_kernels(torch, dev, attn_per_call):
    """Each LM kernel at the prefill cell's shape: the bare launch, the
    plain version and one PyTorch call of the same function, device time
    by CUDA-graph replay, and the bound from this run's inputs;
    ``attn_per_call`` holds the attention kernels' device kernels per call
    (``phase_lm_kernels``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention_fold as af
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rows = {}
    b, t, d, k = PREFILL_B, PREFILL_T, 4224, 4
    x = torch.randn(b, t, d, device=dev, generator=gen).bfloat16()
    w = torch.randn(k, d, device=dev, generator=gen).bfloat16()
    xt, wt = x.transpose(1, 2), w.T[:, None, :].contiguous()
    # the same x one element into its storage: the scalar path, the
    # kernel's design before its redesign
    xs, _ = conv1d_case(torch, gen, dev, torch.bfloat16, b, t, d, k, False,
                        offset=True)
    check(cc.vector_path(x, w) and not cc.vector_path(xs, w),
          "conv1d: the prefill shape does not take the vector path")
    out = torch.empty_like(x)
    op_ms = 1e3 * 2.0 * k * b * t * d / FP32_PEAK
    byte_ms = 1e3 * 2.0 * (2 * x.numel() + w.numel()) / HBM_BYTES_PER_S
    rows[cc.KERNEL] = {
        "shape": f"x ({b}, {t}, {d}) bf16, w ({k}, {d}) bf16",
        "ms": time_graph_ms(torch, lambda: cc.launch(x, w), 20),
        "plain_ms": time_graph_ms(
            torch, lambda: cc.conv1d_causal_plain(x, w), 5),
        "library_ms": time_graph_ms(
            torch, lambda: F.conv1d(xt, wt, groups=d, padding=k - 1)
            [..., :t], 20),
        "bound_ms": max(op_ms, byte_ms), "op_ms": op_ms, "byte_ms": byte_ms,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "scalar_path_ms": time_graph_ms(torch, lambda: cc.launch(xs, w), 20),
        # torch's copy of x: the same bytes moved, with no halo and no math
        "copy_ms": time_graph_ms(torch, lambda: out.copy_(x), 20),
        "before_redesign_ms": BEFORE_REDESIGN[cc.KERNEL]}
    b, t, h, kv, hd = ZAMBA_ATTN
    pairs = b * h * t * (t + 1) / 2          # causal: the visible (q, k)
    flops = 4.0 * hd * pairs                 # q.k and p.v, 2 each
    for dtype in (torch.float32, torch.bfloat16):
        # fp32 runs FFMA; bf16 the tensor cores, bounded by the function's
        # work at their rate (the hi / lo split's second P.V not counted)
        peak = FP32_PEAK if dtype == torch.float32 else BF16_TC_PEAK
        q = torch.randn(b, t, h, hd, device=dev, generator=gen).to(dtype)
        k_ = torch.randn(b, t, kv, hd, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, t, kv, hd, device=dev, generator=gen).to(dtype)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k_, v))
        op_ms = 1e3 * flops / peak
        byte_ms = 1e3 * q.element_size() * 4 * q.numel() / HBM_BYTES_PER_S
        rows[f"{af.KERNEL}_{str(dtype)[6:]}"] = {
            "shape": f"q, k, v ({b}, {t}, {h}, {hd}) {str(dtype)[6:]}, "
                     "causal",
            "ms": time_graph_ms(
                torch, lambda: af.launch(q, k_, v, causal=True, window=0),
                5),
            "plain_ms": time_graph_ms(
                torch, lambda: af.flash_attention_folded_plain(q, k_, v), 2),
            "library_ms": time_graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), 5),
            "bound_ms": max(op_ms, byte_ms), "op_ms": op_ms,
            "byte_ms": byte_ms,
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "kernels_per_call": attn_per_call[str(dtype)[6:]],
            # the same operations at the fp32 FFMA rate
            "bound_ffma_ms": max(1e3 * flops / FP32_PEAK, byte_ms),
            "before_redesign_ms": BEFORE_REDESIGN[
                f"{af.KERNEL}_{str(dtype)[6:]}"]}
    r = rows[cc.KERNEL]
    print(f"[lm kernels] {cc.KERNEL} at the same shape on its scalar path "
          f"(x off the 16-byte grid): {r['scalar_path_ms']:.4f} ms; before "
          f"the redesign {r['before_redesign_ms']}; torch's copy of x "
          f"{r['copy_ms']:.4f} ms")
    for name, r in rows.items():
        print(f"[lm kernels] {name} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})"
              + (f", FFMA bound {r['bound_ffma_ms']:.4f}, device kernels "
                 f"per call {r['kernels_per_call']}, "
                 f"before the redesign {r['before_redesign_ms']}"
                 if "bound_ffma_ms" in r else ""))
    return rows


def phase_attention_op(torch, dev):
    """The fold-attention kernel's path: the op itself (no model calls
    it), once at zamba2's shared-attention shape in bf16."""
    from repro_torch.kernels import attention_fold as af
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    b, t, h, kv, hd = ZAMBA_ATTN
    q = torch.randn(b, t, h, hd, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, t, kv, hd, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, t, kv, hd, device=dev, generator=gen).bfloat16()
    out = af.flash_attention_folded(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(out.shape == q.shape and bool(torch.isfinite(out).all()),
          "attention op: bad output")


def lm_params(torch, dev, cfg, policy, seed):
    from repro_torch.models import api
    return api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dtype_policy=policy, device=dev)


def phase_prefill(torch, dev):
    """zamba2-1.2b at full width, bf16 policy, random weights: prefill of
    B=2 x 2048 tokens through ``make_prefill_step``, 38 conv1d launches
    per prefill (one per Mamba2 layer).  Returns the summary, the prefill
    call and a call of 4 decode steps after it (``BatchEngine``'s
    captured step, one CUDA graph), to be profiled once the launch counts
    are read."""
    from repro_torch.configs.registry import get_config
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    from repro_torch.models import api
    from repro_torch.models.common import DTypePolicy
    from repro_torch.serve.engine import CapturedDecode
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    cfg = get_config(ZAMBA)
    params = lm_params(torch, dev, cfg, DTypePolicy(), SEED + 23)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_T), device=dev,
                           generator=gen)
    step = make_prefill_step(cfg)

    def run():
        cache = api.init_cache(cfg, PREFILL_B, PREFILL_T + 8, device=dev)
        with torch.inference_mode():
            return step(params, {"tokens": tokens}, cache)
    reps, out = 3, {}
    before = cc.launch_counts()[cc.KERNEL]
    tok, logits, cache = run()                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tok, logits, cache = run()
    torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    launches = cc.launch_counts()[cc.KERNEL] - before
    per = cfg.n_layers
    print(f"[prefill] {ZAMBA} B={PREFILL_B} T={PREFILL_T} bf16: "
          f"{launches} conv1d launches over {reps + 1} prefills")
    check(launches == per * (reps + 1),
          f"expected {per} conv1d launches per prefill")
    check(logits.shape == (PREFILL_B, cfg.padded_vocab)
          and bool(torch.isfinite(logits[:, :cfg.vocab]).all())
          and bool((logits[:, cfg.vocab:] < -1e29).all())
          and bool(((tok >= 0) & (tok < cfg.vocab)).all()),
          "prefill: bad logits or tokens")
    check(bool(torch.isfinite(cache["mamba"]["h"]).all())
          and int(cache["attn"]["k"][:, :, :PREFILL_T].abs().sum(-1)
                  .eq(0).sum()) == 0,
          "prefill: the cache is not filled")
    out["prompt_tokens_per_s"] = PREFILL_B * PREFILL_T \
        / (out["prefill_ms"] / 1e3)
    out["conv1d_launches_per_prefill"] = per
    print(f"[prefill] {out['prefill_ms']:.3f} ms per prefill (eager, host "
          f"clock), {out['prompt_tokens_per_s']:.1f} prompt tokens/s")

    # 4 decode steps after the prefill through the engine's captured step,
    # each read back as the engine reads it (its capture on the first
    # call: the warm-up outside the profile)
    decoder = CapturedDecode(make_decode_step(cfg, donate=True), dev)

    def decode():
        nxt = tok.cpu()
        for i in range(4):
            nxt = decoder(params, nxt, cache, PREFILL_T + i)[0].cpu()
    return out, run, decode


def profile_device(torch, fn, top=6):
    """One call of ``fn`` under ``torch.profiler``: the summed device time
    of its kernels (ms), their number, and the kernels that take most of
    it; (None, 0, []) where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        return None, 0, []
    total = sum(r[0] for r in rows)
    return total, sum(r[2] for r in rows), [
        {"kernel": k[:90], "ms": ms, "calls": n, "share": ms / total}
        for ms, k, n in rows[:top]]


def phase_lm_device(torch, pre, prefill_run, decode_run):
    """Where the LM path's time goes, once the main path's counts are
    read: the prefill replayed as a CUDA graph (its device work and busy
    share), and the prefill and 4 captured decode steps under
    ``torch.profiler`` (device time by kernel; the decode steps' host-clock
    time beside their device time)."""
    pre["device_ms"] = time_graph_ms(torch, prefill_run, 1)
    pre["busy_share"] = pre["device_ms"] / pre["prefill_ms"]
    print(f"[prefill] device work {pre['device_ms']:.3f} ms per prefill "
          f"when replayed as a CUDA graph: busy share "
          f"{pre['busy_share']:.3f}")
    pre["profile_device_ms"], pre["kernels"], pre["top_kernels"] = \
        profile_device(torch, prefill_run)
    decode_run()                                  # warm-up
    t0 = time.perf_counter()
    decode_run()
    dec = {"step_ms": 1e3 * (time.perf_counter() - t0) / 4}
    dev_ms, n, dec["top_kernels"] = profile_device(torch, decode_run)
    dec["device_ms"] = None if dev_ms is None else dev_ms / 4
    dec["kernels"] = n / 4
    for what, d, total in (("prefill", pre, pre["profile_device_ms"]),
                           ("decode step", dec, dec["device_ms"])):
        if total is None:
            print(f"[profile] {what}: torch.profiler recorded no device "
                  "time")
            continue
        print(f"[profile] {what}: {total:.3f} ms of kernels in "
              f"{d['kernels']:.0f} launches; top: "
              + "; ".join(f"{r['kernel'][:48]} {r['ms']:.3f} ms "
                          f"({r['share']:.3f}, {r['calls']} calls)"
                          for r in d["top_kernels"][:4]))
    if dec["device_ms"] is not None:
        dec["busy_share"] = dec["device_ms"] / dec["step_ms"]
        print(f"[profile] captured decode step (B={PREFILL_B}, after the "
              f"prefill): {dec['step_ms']:.3f} ms host clock, "
              f"{dec['device_ms']:.3f} ms of kernels: busy share "
              f"{dec['busy_share']:.3f}")
    return dec


def phase_consistency(torch, dev):
    """fp32 policy at full width: prefill 32 tokens, decode 8, against
    ``forward`` on the 40 within TOL_DECODE·max|logits|.  The prefill and
    the forward run the conv1d kernel; decode its window einsum."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api, transformer
    from repro_torch.models.common import DTypePolicy
    cfg = get_config(ZAMBA)
    params = lm_params(torch, dev, cfg, DTypePolicy.fp32(), SEED + 25)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    b, k, s = 2, 32, 40
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
    with torch.inference_mode():
        logits_f = transformer.forward(params, cfg, tokens)
        cache = api.init_cache(cfg, b, s, dtype=torch.float32, device=dev)
        lp, cache = api.prefill(params, cfg, {"tokens": tokens[:, :k]},
                                cache)
        got = [lp]
        for i in range(k, s):
            lg, cache = api.decode_step(params, cfg, tokens[:, i], cache, i)
            got.append(lg)
    # the real vocabulary's logits: the padded rows are -1e30 on both sides
    v = cfg.vocab
    scale = logits_f[..., :v].abs().max().item()
    errs = [(g[:, :v] - logits_f[:, k - 1 + j, :v]).abs().max().item()
            for j, g in enumerate(got)]
    print(f"[consistency] {ZAMBA} fp32, prefill {k} + decode {s - k} vs "
          f"forward on {s}: max_abs_err {max(errs):.3e} (tol "
          f"{TOL_DECODE * scale:.3e}, max|logits| {scale:.3e})")
    check(bool(torch.isfinite(logits_f).all())
          and max(errs) <= TOL_DECODE * scale,
          "decode disagrees with forward")
    return {"max_abs_err": max(errs), "max_abs_logits": scale}


def phase_lm_serving(torch, dev):
    """``BatchEngine`` at full width (what ``python -m repro_torch.launch.
    serve --full`` runs), bf16, batch 4: 8 requests, prompt 16, 16 new
    tokens each, through its captured decode step.  A functional check:
    so few tokens are dominated by prompt stepping and refill, so the
    rate it prints is no serving throughput.  Then the capture against
    the eager step (``decode_capture``)."""
    from repro_torch.serve.engine import token_serving_summary
    d = token_serving_summary(ZAMBA, full=True, batch=4, max_len=64,
                              prompt_len=16, new_tokens=16, requests=8,
                              seed=SEED + 27, device=dev)
    print(f"[serve {ZAMBA}] {d['requests_done']}/{d['requests']} requests "
          f"done, {d['requests_lost']} lost, {d['tokens']} tokens in "
          f"{d['elapsed_s']:.3f} s: {d['tokens_per_s']:.3f} tokens/s, "
          f"decode step {d['decode_step_ms']:.3f} ms, {d['prefill_calls']} "
          f"prompt-stepping decode calls in {d['prefill_ms']:.3f} ms "
          f"(a functional check's reading, not a serving rate)")
    check(d["requests_done"] == 8 and d["requests_lost"] == 0
          and d["tokens"] == 8 * 16, "token serving lost requests")
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import DTypePolicy
    cfg = get_config(ZAMBA)
    d["decode"] = decode_capture(
        torch, dev, cfg, lm_params(torch, dev, cfg, DTypePolicy(), SEED + 28))
    return d


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def decode_capture(torch, dev, cfg, params):
    """8 requests (prompt 16, 16 new tokens, batch 4; ``cfg`` and
    ``params`` at full width, bf16) served by a ``BatchEngine`` through its
    captured decode step and
    by one whose step is ``make_decode_step``'s functional eager step:
    every served token and each decode call's logits bitwise equal, the
    captured engine's cache tensors at the same addresses throughout, one
    capture.  Then the decode step's host-clock ms (the engines' own
    ``decode_s``, each step ending in the readback of its tokens) beside
    its device work (the donated step captured once and its graph
    replayed between CUDA events) and the busy share, the graph's nodes
    per step, and the prompt-stepping ms of both engines."""
    import numpy as np
    from repro_torch.models import api
    from repro_torch.serve import engine as se
    from repro_torch.serve.steps import make_decode_step
    functional = make_decode_step(cfg)
    runs = {}
    for what in ("captured", "eager"):
        eng = se.BatchEngine(cfg, params, batch=4, max_len=64, device=dev)
        captured = eng.decode
        if what == "eager":
            eng.decode = lambda p, tok, cache, pos: functional(
                p, tok.to(dev), cache, pos)
        # each call's logits copied into rows made beforehand, so the
        # recording allocates nothing inside the timed steps
        step, logits = eng.decode, torch.empty(
            (256, 4, cfg.padded_vocab), device=dev)
        calls = [0]

        def recorded(*args, step=step, logits=logits, calls=calls):
            out = step(*args)
            logits[calls[0]].copy_(out[1])
            calls[0] += 1
            return out
        eng.decode = recorded
        cache = eng.cache
        ptrs = [t.data_ptr() for t in _leaves(cache)]
        rng = np.random.default_rng(SEED + 29)
        reqs = [se.Request(rid=i, prompt=rng.integers(0, cfg.vocab, 16,
                                                      dtype=np.int32),
                           max_new_tokens=16) for i in range(8)]
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        runs[what] = {
            "elapsed_s": time.perf_counter() - t0,
            "tokens": [r.output for r in reqs],
            "logits": logits[:calls[0]],
            "step_ms": 1e3 * eng.decode_s / max(eng.decode_steps, 1),
            "decode_steps": eng.decode_steps,
            "prompt_ms": 1e3 * eng.prefill_s,
            "prompt_calls": eng.prefill_calls,
            "fixed": eng.cache is cache
            and [t.data_ptr() for t in _leaves(eng.cache)] == ptrs,
            "captures": captured.captures}
    cap, eag = runs["captured"], runs["eager"]
    check(all(len(t) == 16 for t in cap["tokens"]),
          "decode capture: a request did not finish")
    check(cap["tokens"] == eag["tokens"],
          "decode capture: served tokens differ from the eager engine's")
    check(len(cap["logits"]) == len(eag["logits"])
          and torch.equal(cap["logits"], eag["logits"]),
          "decode capture: a decode call's logits differ from the eager "
          "step's")
    check(cap["fixed"], "decode capture: the cache moved")
    check(cap["captures"] == 1 and eag["captures"] == 0,
          f"decode capture: {cap['captures']} captures")
    # the step's device work and nodes: the donated step on a scratch
    # cache of the engine's shapes
    donated = make_decode_step(cfg, donate=True)
    scratch = api.init_cache(cfg, 4, 64, device=dev)
    tok = torch.zeros(4, dtype=torch.long, device=dev)
    pos = torch.tensor(16, device=dev)
    with torch.inference_mode():
        one = lambda: donated(params, tok, scratch, pos)  # noqa: E731
        device_ms = time_graph_ms(torch, one, 5)
        nodes = graph_nodes(torch, one)
    out = {"step_ms": cap["step_ms"], "eager_step_ms": eag["step_ms"],
           "device_ms": device_ms, "busy_share": device_ms / cap["step_ms"],
           "eager_busy_share": device_ms / eag["step_ms"],
           "graph_nodes": nodes, "decode_steps": cap["decode_steps"],
           "prompt_ms": cap["prompt_ms"],
           "eager_prompt_ms": eag["prompt_ms"],
           "prompt_calls": cap["prompt_calls"],
           "calls_bitwise": len(cap["logits"]),
           "elapsed_s": cap["elapsed_s"],
           "eager_elapsed_s": eag["elapsed_s"],
           "requests_done": sum(len(t) == 16 for t in cap["tokens"]),
           "requests_lost": sum(len(t) != 16 for t in cap["tokens"])}
    print(f"[decode] {cfg.name} B=4 bf16: step {out['step_ms']:.3f} ms host "
          f"clock captured, {out['eager_step_ms']:.3f} eager; device work "
          f"{device_ms:.3f} ms (graph replay): busy share "
          f"{out['busy_share']:.3f} captured, {out['eager_busy_share']:.3f}"
          f" eager; {nodes} graph nodes a step; prompt stepping "
          f"{out['prompt_ms']:.3f} ms captured, {out['eager_prompt_ms']:.3f}"
          f" eager ({out['prompt_calls']} calls); "
          f"{out['calls_bitwise']} decode calls' logits and every served "
          f"token bitwise the eager engine's; cache fixed; 1 capture")
    return out


# -- the paper's planning and oracle side, the per-layer VGG-16 path and
# the dense attention LM family -------------------------------------------

SIM_LAYER = "conv3_1"      # the fold walk's full-size layer: 56x56, b1
TOL_FOLD_WALK = 1e-5       # fold walk vs the fp32 WS kernel, of max|ref|
VGG_PER_LAYER_IMPLS = ("fold_ws", "fold_os", "fold_auto", "im2col", "direct",
                       "torch")
VGG_PER_LAYER_IMG = 224
DENSE_SERVED = "gemma3-12b"         # at its published config
DENSE_PREFILL = (1, 1024)           # B x prompt tokens
DENSE_RING_LAYERS = 12              # two 6-layer local:global groups
DENSE_CUT = ("llama3-8b", "qwen3-4b", "qwen2.5-14b")
DENSE_CUT_LAYERS = 4


def phase_simulator(torch, dev):
    """``[simulator]``: the cycle accounting and the message stream over
    VGG-16's 13 layers on ``PEArray(64, 64)`` (store-and-forward
    multicast) with the KIPS model beside them (analytical, no card
    time), then ``execute_conv_by_folds`` on the card for conv3_1 at
    56x56, b1: every (filter fold, depth fold) pair of the schedule,
    held within TOL_FOLD_WALK·max(1, max|ref|) of the fp32 WS kernel on
    the same operands, with the seconds it took."""
    from repro_torch.core import (PEArray, decompose, execute_conv_by_folds,
                                  kips, simulate_cycles, vgg16_conv_layers)
    from repro_torch.core.streaming import stream_counts
    from repro_torch.kernels import ops
    pe = PEArray(64, 64)
    layers = vgg16_conv_layers()
    cycles, msgs = {}, {}
    for _, cv in layers:
        for k, v in simulate_cycles(cv, pe).as_dict().items():
            cycles[k] = cycles.get(k, 0) + v
        for k, v in stream_counts(decompose(cv, pe)).items():
            msgs[k] = msgs.get(k, 0) + v
    model = kips([cv for _, cv in layers], pe)
    print(f"[simulator] VGG-16's 13 layers on PEArray(64, 64), multicast "
          f"hops: cycles {cycles}; stream messages {msgs['total']} "
          f"(MCAST_COL {msgs['MCAST_COL']}, PROG_WEIGHT "
          f"{msgs['PROG_WEIGHT']}, MAC {msgs['MAC']}); KIPS model "
          f"{model['kips']:.4f} at util {model['util_avg_pct']:.2f}% "
          "(analytical MAVeC cycles, not a card time)")
    cv = dict(layers)[SIM_LAYER]
    plan = decompose(cv, pe)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    x = torch.randn(cv.n, cv.c, cv.x, cv.y, device=dev, generator=gen)
    w = torch.randn(cv.nf, cv.c, cv.r, cv.s, device=dev, generator=gen)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = execute_conv_by_folds(x, w, cv, pe)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        want = ops.conv2d(x, w, stride=cv.stride, pad=cv.pad, impl="fold_ws")
    err = (got - want).abs().max().item()
    tol = TOL_FOLD_WALK * max(1.0, want.abs().max().item())
    pairs = plan.n_row_splits * plan.n_col_splits
    print(f"[simulator] execute_conv_by_folds {SIM_LAYER} ({cv}, b1) on the "
          f"card: {pairs} fold pairs ({plan.n_row_splits} filter x "
          f"{plan.n_col_splits} depth) in {seconds:.3f} s; max_abs_err vs "
          f"the fp32 WS kernel {err:.3e} (tol {tol:.3e})")
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and err <= tol, "the fold walk disagrees with the WS kernel")
    return {"cycles": cycles, "messages": msgs, "kips": model,
            "fold_walk": {"layer": SIM_LAYER, "fold_pairs": pairs,
                          "seconds": seconds, "max_abs_err": err,
                          "tol": tol}}


def phase_vgg_per_layer(torch, dev, params):
    """``[vgg per-layer]``: full-width VGG-16 at 224, batch 1 and 4,
    through ``vgg.forward`` with every impl (``fold_auto`` with and
    without a ``ScheduleCache``), each held within TOL_MODEL·max|ref| of
    the compiled engine's logits; the fold impls launch 13 conv kernels
    and the 3 head kernels a forward, the cache plans 8 schedules with 5
    hits; the eager ms of each impl beside the jitted engine's."""
    from repro_torch.core.engine import ScheduleCache, kernel_launch_counts
    from repro_torch.kernels import dense as dn
    from repro_torch.models import vgg
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    img = VGG_PER_LAYER_IMG
    x4 = torch.randn(4, 3, img, img, device=dev, generator=gen)
    out = {}
    runs = [(impl, False) for impl in VGG_PER_LAYER_IMPLS] \
        + [("fold_auto", True)]
    for b in (1, 4):
        x = x4[:b]
        net = vgg.compile_forward(params, img=img, batch=b, device=dev)
        with torch.inference_mode():
            want = net(params, x)
            jit_ms = time_ms(torch, lambda: net(params, x), 5)
        scale = want.abs().max().item()
        rows = []
        for impl, cached in runs:
            cache = ScheduleCache() if cached else None

            def fwd(impl=impl, cache=cache):
                return vgg.forward(params, x, impl=impl, cache=cache)
            with torch.inference_mode():
                before = kernel_launch_counts()
                y = fwd()
                torch.cuda.synchronize()
                after = kernel_launch_counts()
                stats = (cache.distinct, cache.stats.hits) if cached \
                    else None
                ms = time_ms(torch, fwd, 3)
            counts = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
            head = counts.pop(dn.KERNEL, 0)
            err = (y - want).abs().max().item()
            what = f"vgg.forward({impl}{', cache' if cached else ''}) b{b}"
            rows.append({"impl": impl, "cache": cached, "ms": ms,
                         "max_abs_err": err, "launches": counts,
                         "head_launches": head, "schedules": stats})
            print(f"[vgg per-layer] {what}: {ms:.3f} ms eager, "
                  f"max_abs_err {err:.3e} (tol {TOL_MODEL * scale:.3e}), "
                  f"conv launches {counts}, head {head}"
                  + (f", {stats[0]} schedules / {stats[1]} hits"
                     if cached else ""))
            check(y.shape == (b, 1000) and bool(torch.isfinite(y).all())
                  and err <= TOL_MODEL * scale,
                  f"{what} disagrees with the compiled engine")
            check(head == 3, f"{what}: {head} head launches, expected 3")
            folds = impl.startswith("fold_")
            check(sum(counts.values()) == (13 if folds else 0),
                  f"{what}: conv launches {counts}")
            if impl in ("fold_ws", "fold_os"):
                name = "fold_conv_" + impl[-2:]
                check(counts == {name: 13}, f"{what}: launches {counts}")
            if cached:
                check(stats == (8, 5), f"{what}: schedules/hits {stats}")
        out[f"b{b}"] = {"jit_ms": jit_ms, "rows": rows}
        print(f"[vgg per-layer] b{b}: jitted engine {jit_ms:.3f} ms; eager "
              "per-layer " + ", ".join(
                  f"{r['impl']}{'+cache' if r['cache'] else ''} "
                  f"{r['ms']:.3f}" for r in rows) + " ms")
    return out


def dense_cfg(arch, n_layers=None, **replace):
    """An arch's published config, its depth cut to ``n_layers``."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return dataclasses.replace(cfg, **replace)


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_dense_served(torch, dev):
    """gemma3-12b at its published config (48 layers, d 3840, 16 heads of
    256, window 1024, 5:1 local:global, tied 262144-row vocabulary), bf16
    weights from a seeded generator: prefill B=1 x 1024 (last-token
    logits), then ``BatchEngine`` at batch 4 with ``window_cache`` (40
    local layers on 1024-slot rings), 8 requests of 16 + 16 tokens,
    captured against eager (``decode_capture``).  Returns the summary and,
    for the profiler, which runs last, the prefill and one captured decode
    step (batch 4, position 16); they hold the weights until then."""
    import dataclasses
    from repro_torch.models import api
    from repro_torch.models.common import DTypePolicy
    from repro_torch.serve.engine import CapturedDecode
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    cfg = dense_cfg(DENSE_SERVED)
    t0 = time.perf_counter()
    params = lm_params(torch, dev, cfg, DTypePolicy(), SEED + 62)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    out = {"init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in leaves),
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in leaves)}
    print(f"[dense lm] {cfg.name}: {out['params']} parameters, "
          f"{out['weight_bytes'] / 2**30:.2f} GiB bf16, drawn in "
          f"{out['init_s']:.1f} s")
    b, t = DENSE_PREFILL
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)
    tokens = torch.randint(0, cfg.vocab, (b, t), device=dev, generator=gen)
    step = make_prefill_step(cfg)

    def run():
        cache = api.init_cache(cfg, b, t, device=dev)
        with torch.inference_mode():
            return step(params, {"tokens": tokens}, cache)
    tok, logits, cache = run()                    # warm-up
    torch.cuda.synchronize()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        tok, logits, cache = run()
    torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    out["prompt_tokens_per_s"] = b * t / (out["prefill_ms"] / 1e3)
    check(logits.shape == (b, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all())
          and bool(((tok >= 0) & (tok < cfg.vocab)).all())
          and int(cache["k"][:, :, :t].abs().sum(-1).eq(0).sum()) == 0,
          "dense prefill: bad logits, tokens or cache")
    print(f"[dense lm] {cfg.name} prefill B={b} x {t} bf16: "
          f"{out['prefill_ms']:.3f} ms (host clock, eager), "
          f"{out['prompt_tokens_per_s']:.1f} prompt tokens/s")
    del cache, logits
    _free(torch)
    wcfg = dataclasses.replace(cfg, window_cache=True)
    out["serving"] = decode_capture(torch, dev, wcfg, params)
    check(out["serving"]["requests_lost"] == 0,
          "dense serving lost requests")
    decoder = CapturedDecode(make_decode_step(wcfg, donate=True), dev)
    scratch = api.init_cache(wcfg, 4, 64, device=dev)
    token = torch.zeros(4, dtype=torch.long, device=dev)

    def decode_step():
        with torch.inference_mode():
            decoder(params, token, scratch, 16)
    decode_step()                                 # the capture
    return out, {"prefill": run, "decode step": decode_step}


def phase_dense_ring(torch, dev):
    """gemma3-12b at full width and DENSE_RING_LAYERS layers (two
    local:global groups), fp32: ``decode_step`` over W + 64 positions
    with the ring-buffer window cache and with the full-length cache,
    each a captured donated step; the ring's logits within
    TOL_DECODE·max|logits| of the full cache's at every position (the
    rings wrap at W)."""
    import dataclasses
    from repro_torch.models import api
    from repro_torch.models.common import DTypePolicy
    from repro_torch.serve.engine import CapturedDecode
    from repro_torch.serve.steps import make_decode_step
    cfg = dense_cfg(DENSE_SERVED, DENSE_RING_LAYERS)
    ring_cfg = dataclasses.replace(cfg, window_cache=True)
    params = lm_params(torch, dev, cfg, DTypePolicy.fp32(), SEED + 64)
    b, s = 2, cfg.sliding_window + 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 65)
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
    caches = {"ring": api.init_cache(ring_cfg, b, s, dtype=torch.float32,
                                     device=dev),
              "full": api.init_cache(cfg, b, s, dtype=torch.float32,
                                     device=dev)}
    steps = {"ring": CapturedDecode(make_decode_step(ring_cfg, donate=True),
                                    dev),
             "full": CapturedDecode(make_decode_step(cfg, donate=True),
                                    dev)}
    err = torch.zeros((), device=dev)
    scale = torch.zeros((), device=dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(s):
            _, lr, caches["ring"] = steps["ring"](params, tokens[:, i],
                                                  caches["ring"], i)
            _, lf, caches["full"] = steps["full"](params, tokens[:, i],
                                                  caches["full"], i)
            err = torch.maximum(err, (lr - lf).abs().max())
            scale = torch.maximum(scale, lf.abs().max())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nbytes = {k: sum(t.numel() * t.element_size() for t in _leaves(c))
              for k, c in caches.items()}
    out = {"layers": cfg.n_layers, "positions": s, "seconds": seconds,
           "max_abs_err": err.item(), "max_abs_logits": scale.item(),
           "cache_bytes": nbytes}
    print(f"[dense lm] ring vs full cache: {cfg.name} at full width, "
          f"{cfg.n_layers} layers, fp32, B={b}, {s} positions (W "
          f"{cfg.sliding_window}: the rings wrap): max_abs_err "
          f"{out['max_abs_err']:.3e} (tol "
          f"{TOL_DECODE * out['max_abs_logits']:.3e}), caches "
          f"{nbytes['ring'] / 2**20:.1f} MiB ring vs "
          f"{nbytes['full'] / 2**20:.1f} MiB full, {seconds:.2f} s for both "
          f"captured walks")
    check(out["max_abs_err"] <= TOL_DECODE * out["max_abs_logits"]
          and out["max_abs_logits"] > 0, "the ring decode disagrees with the "
          "full-cache decode")
    del params, caches, steps
    _free(torch)
    return out


def phase_dense_cut(torch, dev):
    """llama3-8b, qwen3-4b and qwen2.5-14b (40 heads padded to 48) at full
    width and DENSE_CUT_LAYERS layers, fp32: prefill 32 tokens at batch 2,
    then 8 captured decode steps, held within TOL_DECODE·max|logits| of
    ``forward``'s logits at each of those positions
    (``decode_vs_forward``)."""
    from repro_torch.models.common import DTypePolicy
    out = {}
    for i, arch in enumerate(DENSE_CUT):
        cfg = dense_cfg(arch, DENSE_CUT_LAYERS)
        params = lm_params(torch, dev, cfg, DTypePolicy.fp32(),
                           SEED + 66 + i)
        gen = torch.Generator(device=dev).manual_seed(SEED + 70 + i)
        tokens = torch.randint(0, cfg.vocab, (2, 40), device=dev,
                               generator=gen)
        out[arch] = decode_vs_forward(
            torch, dev, cfg, params, {"tokens": tokens}, 32,
            f"[dense lm] {arch} full width, {cfg.n_layers} layers, "
            f"{cfg.n_heads} heads ({cfg.padded_heads} padded)")
        out[arch]["padded_heads"] = cfg.padded_heads
        del params
        _free(torch)
    return out


# -- the other LM families: rwkv6, the MoE pair, the enc-dec, the VLM -------

FAMILY_PREFILL = (1, 1024)          # B x prompt tokens, bf16
FAMILY_CUT_LAYERS = 4
RWKV = "rwkv6-1.6b"
MOE_ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")
ENCDEC = "seamless-m4t-medium"
VLM = "internvl2-26b"
ENCDEC_SRC = 512                    # source frames of the enc-dec prefill


def family_params(torch, dev, cfg, policy, seed, what):
    """Random weights of ``cfg`` from a seeded generator, with their
    parameter count and bytes printed; the peak-memory count restarts
    here (``held_gib``: what the process held before)."""
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    params = lm_params(torch, dev, cfg, policy, seed)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    out = {"layers": cfg.n_layers, "params": sum(t.numel() for t in leaves),
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in leaves),
           "init_s": time.perf_counter() - t0, "held_gib": held}
    kind = "bf16" if policy.param == torch.bfloat16 else "fp32"
    print(f"[lm families] {what}: {out['params']} parameters, "
          f"{out['weight_bytes'] / 2**30:.2f} GiB {kind}, drawn in "
          f"{out['init_s']:.1f} s")
    return params, out


def peak_gib(torch, dev):
    """The process's peak device memory since ``family_params``, GiB."""
    return torch.cuda.max_memory_allocated(dev) / 2**30


def family_prefill(torch, dev, cfg, params, seed):
    """bf16 prefill of B=1 x 1024 random tokens through
    ``make_prefill_step``: the second call's host-clock ms (the first
    warms up), prompt tokens/s, and finite logits, in-vocabulary tokens
    and a finite, filled cache."""
    from repro_torch.models import api
    from repro_torch.serve.steps import make_prefill_step
    b, t = FAMILY_PREFILL
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, t), device=dev, generator=gen)
    step = make_prefill_step(cfg)

    def run():
        cache = api.init_cache(cfg, b, t, device=dev)
        with torch.inference_mode():
            return step(params, {"tokens": tokens}, cache)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, logits, cache = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    leaves = _leaves(cache)
    check(logits.shape == (b, cfg.padded_vocab)
          and bool(torch.isfinite(logits[:, :cfg.vocab]).all())
          and bool(((tok >= 0) & (tok < cfg.vocab)).all())
          and all(bool(torch.isfinite(x).all()) for x in leaves)
          and all(bool(x.any()) for x in leaves),
          f"{cfg.name} prefill: bad logits, tokens or cache")
    out = {"prefill_ms": ms, "prompt_tokens_per_s": b * t / (ms / 1e3)}
    print(f"[lm families] {cfg.name} prefill B={b} x {t} bf16: {ms:.3f} ms "
          f"(host clock, eager), {out['prompt_tokens_per_s']:.1f} prompt "
          f"tokens/s")
    return out


def decode_vs_forward(torch, dev, cfg, params, batch, k, what):
    """fp32: ``make_prefill_step`` on the first ``k`` tokens of
    ``batch["tokens"]`` (with the batch's source frames or patch
    embeddings), then one captured donated decode step (``CapturedDecode``)
    per token after them, each step's logits within
    TOL_DECODE·max|logits| of the teacher-forced forward's at that
    position."""
    from repro_torch.models import api, encdec, transformer
    from repro_torch.serve.engine import CapturedDecode
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    tokens = batch["tokens"]
    b, s = tokens.shape
    off = batch["patches"].shape[1] if "patches" in batch else 0
    decoder = CapturedDecode(make_decode_step(cfg, donate=True), dev)
    with torch.inference_mode():
        if cfg.is_encdec:
            logits_f = encdec.forward(params, cfg, batch)
        else:
            logits_f = transformer.forward(params, cfg, tokens,
                                           extra_embeds=batch.get("patches"))
        cache = api.init_cache(cfg, b, off + s, dtype=torch.float32,
                               device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lp, cache = make_prefill_step(cfg)(
            params, dict(batch, tokens=tokens[:, :k]), cache)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        got = [lp]
        for j in range(k, s):
            if j == k + 1:           # the first call captured the graph
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            _, lg, cache = decoder(params, tokens[:, j], cache, off + j)
            got.append(lg)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / (s - k - 1)
    v = cfg.vocab
    scale = logits_f[..., :v].abs().max().item()
    err = max((g[:, :v] - logits_f[:, off + k - 1 + j, :v]).abs().max()
              .item() for j, g in enumerate(got))
    out = {"layers": cfg.n_layers, "prefill_ms": prefill_ms,
           "decode_step_ms": step_ms, "captures": decoder.captures,
           "max_abs_err": err, "max_abs_logits": scale}
    front = f"{off} patch embeddings and " if off else ""
    print(f"{what}, fp32, B={b}: prefill {front}{k} tokens "
          f"{prefill_ms:.3f} ms (first call), captured decode "
          f"{step_ms:.3f} ms a step (host clock, after the capture); "
          f"prefill + {s - k} decode steps vs forward max_abs_err "
          f"{err:.3e} (tol {TOL_DECODE * scale:.3e})")
    check(bool(torch.isfinite(logits_f[..., :v]).all())
          and err <= TOL_DECODE * scale and decoder.captures == 1,
          f"{what}: decode disagrees with forward")
    return out


def phase_rwkv(torch, dev):
    """rwkv6-1.6b at its published config, bf16: prefill B=1 x 1024, the
    WKV time loop of one layer at that shape (its kernels, captured, and
    its device ms replayed), ``decode_capture``; then fp32 at full width
    and FAMILY_CUT_LAYERS layers: prefill 32 + 8 captured decode steps
    against ``forward``, and one layer's time mix over 64 tokens split at
    29 (the WKV state and last x carried) against the whole."""
    from repro_torch.models import rwkv
    from repro_torch.models.common import DTypePolicy
    cfg = dense_cfg(RWKV)
    params, out = family_params(torch, dev, cfg, DTypePolicy(), SEED + 80,
                                f"{RWKV} (published)")
    out.update(family_prefill(torch, dev, cfg, params, SEED + 81))
    h, hd = cfg.n_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(SEED + 82)
    shape = (FAMILY_PREFILL[0], FAMILY_PREFILL[1], h, hd)
    r, k, v = (torch.randn(shape, device=dev, generator=gen).bfloat16()
               for _ in range(3))
    w = torch.rand(shape, device=dev, generator=gen) * 0.5 + 0.4
    u = torch.randn((h, hd), device=dev, generator=gen)
    s0 = torch.zeros((shape[0], h, hd, hd), device=dev)
    with torch.inference_mode():
        scan = lambda: rwkv._wkv_scan(r, k, v, w, u, s0)  # noqa: E731
        nodes = graph_nodes(torch, scan)
        wkv_ms = time_graph_ms(torch, scan, 1)
    out.update(wkv_kernels_per_layer=nodes, wkv_device_ms_per_layer=wkv_ms,
               wkv_share=wkv_ms * cfg.n_layers / out["prefill_ms"])
    per_step = "?" if nodes is None else f"{nodes / FAMILY_PREFILL[1]:.2f}"
    print(f"[lm families] {RWKV} WKV time loop at the prefill's shape "
          f"{shape}: {nodes} kernels a layer ({per_step} a step), "
          f"{wkv_ms:.3f} ms of device work a layer (graph replay), x "
          f"{cfg.n_layers} layers = {out['wkv_share']:.3f} of the "
          f"prefill's host-clock ms")
    out["serving"] = decode_capture(torch, dev, cfg, params)
    out["peak_gib"] = peak_gib(torch, dev)
    del params
    _free(torch)

    cut = dense_cfg(RWKV, FAMILY_CUT_LAYERS)
    params, _ = family_params(torch, dev, cut, DTypePolicy.fp32(),
                              SEED + 83, f"{RWKV} cut to "
                              f"{FAMILY_CUT_LAYERS} layers")
    gen = torch.Generator(device=dev).manual_seed(SEED + 84)
    tokens = torch.randint(0, cut.vocab, (2, 40), device=dev, generator=gen)
    out["cut"] = decode_vs_forward(
        torch, dev, cut, params, {"tokens": tokens}, 32,
        f"[lm families] {RWKV} {FAMILY_CUT_LAYERS} layers")
    lp = {name: t[0] for name, t in params["blocks"]["rwkv"].items()}
    x = torch.randn((2, 64, cut.d_model), device=dev, generator=gen)
    with torch.inference_mode():
        full, sf, _ = rwkv.rwkv_time_mix(lp, cut, x)
        o1, s1, x1 = rwkv.rwkv_time_mix(lp, cut, x[:, :29])
        o2, s2, _ = rwkv.rwkv_time_mix(lp, cut, x[:, 29:], last_x=x1, s0=s1)
    err = max((torch.cat([o1, o2], 1) - full).abs().max().item(),
              (s2 - sf).abs().max().item())
    ref = max(full.abs().max().item(), sf.abs().max().item())
    out["halves"] = {"max_abs_err": err, "max_abs_ref": ref}
    print(f"[lm families] {RWKV} time mix, 64 tokens split at 29 (state "
          f"and last x carried) vs the whole: max_abs_err {err:.3e} (tol "
          f"{TOL_KERNEL * max(1.0, ref):.3e})")
    check(err <= TOL_KERNEL * max(1.0, ref),
          "rwkv6: the split time mix disagrees with the whole")
    del params
    _free(torch)
    return out


def phase_moe(torch, dev, arch, seed):
    """A MoE arch at its published config, bf16: prefill B=1 x 1024
    (routing groups of 512), ``decode_capture`` with the B=4 step's
    device work beside the least time to read the whole expert stack
    (the dispatch einsums cover every expert, so a decode step reads all
    of them); then fp32 at full width and FAMILY_CUT_LAYERS layers with
    the lossless capacity factor n_experts / top_k (at the default 1.25
    a 512-token group drops tokens that a one-token decode group keeps):
    prefill 32 + 8 captured decode steps against ``forward``."""
    import dataclasses
    from repro_torch.models.common import DTypePolicy
    cfg = dense_cfg(arch)
    params, out = family_params(torch, dev, cfg, DTypePolicy(), seed,
                                f"{arch} (published)")
    moe = params["blocks"]["moe"]
    expert_bytes = sum(moe[n].numel() * moe[n].element_size()
                       for n in ("wi_gate", "wi_up", "wo"))
    out["expert_bytes"] = expert_bytes
    out["expert_read_bound_ms"] = 1e3 * expert_bytes / HBM_BYTES_PER_S
    out.update(family_prefill(torch, dev, cfg, params, seed + 1))
    out["serving"] = decode_capture(torch, dev, cfg, params)
    out["peak_gib"] = peak_gib(torch, dev)
    print(f"[lm families] {arch}: {cfg.n_experts} experts padded to "
          f"{moe['wo'].shape[1]}, top-{cfg.top_k}, "
          f"{cfg.shared_experts} shared; the decode step's dispatch "
          f"einsums read every expert: {expert_bytes / 2**30:.2f} GiB, so "
          f">= {out['expert_read_bound_ms']:.3f} ms a step at 3.35 TB/s, "
          f"beside the B=4 step's measured device work "
          f"{out['serving']['device_ms']:.3f} ms (graph replay)")
    del params, moe
    _free(torch)

    cut = dataclasses.replace(
        dense_cfg(arch, FAMILY_CUT_LAYERS),
        moe_capacity_factor=cfg.n_experts / cfg.top_k)
    params, _ = family_params(torch, dev, cut, DTypePolicy.fp32(),
                              seed + 2, f"{arch} cut to "
                              f"{FAMILY_CUT_LAYERS} layers")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    tokens = torch.randint(0, cut.vocab, (2, 40), device=dev, generator=gen)
    out["cut"] = decode_vs_forward(
        torch, dev, cut, params, {"tokens": tokens}, 32,
        f"[lm families] {arch} {FAMILY_CUT_LAYERS} layers, capacity factor "
        f"{cut.moe_capacity_factor:g}")
    del params
    _free(torch)
    return out


def phase_encdec(torch, dev):
    """seamless-m4t-medium at its published config (12 + 12 layers):
    fp32, prefill over 512 source frames (random ``src_embeds``) and 64
    tokens, then 8 captured decode steps on the cached cross K/V, against
    the teacher-forced forward; bf16 ``decode_capture`` (the engine
    decodes over the zero cross K/V of its ``max_len`` rows)."""
    from repro_torch.models.common import DTypePolicy
    cfg = dense_cfg(ENCDEC)
    params, out = family_params(torch, dev, cfg, DTypePolicy.fp32(),
                                SEED + 100, f"{ENCDEC} (published)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 101)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 72), device=dev,
                                     generator=gen),
             "src_embeds": torch.randn((2, ENCDEC_SRC, cfg.d_model),
                                       device=dev, generator=gen)}
    out["check"] = decode_vs_forward(
        torch, dev, cfg, params, batch, 64,
        f"[lm families] {ENCDEC} ({ENCDEC_SRC} source frames)")
    del params
    _free(torch)
    params, out["bf16"] = family_params(torch, dev, cfg, DTypePolicy(),
                                        SEED + 102, f"{ENCDEC} (published)")
    out["held_gib"] = out["bf16"]["held_gib"]
    out["serving"] = decode_capture(torch, dev, cfg, params)
    out["peak_gib"] = peak_gib(torch, dev)
    del params
    _free(torch)
    return out


def phase_vlm(torch, dev):
    """internvl2-26b at its published widths cut to FAMILY_CUT_LAYERS
    layers: fp32, prefill of 256 patch embeddings (through
    ``frontend_proj``) and 32 tokens, then 8 captured decode steps at
    positions 288-295, against ``forward`` with the patches; bf16
    ``decode_capture`` (tokens only)."""
    from repro_torch.models.common import DTypePolicy
    cfg = dense_cfg(VLM, FAMILY_CUT_LAYERS)
    params, out = family_params(torch, dev, cfg, DTypePolicy.fp32(),
                                SEED + 110, f"{VLM} cut to "
                                f"{FAMILY_CUT_LAYERS} layers")
    gen = torch.Generator(device=dev).manual_seed(SEED + 111)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), device=dev,
                                     generator=gen),
             "patches": torch.randn((2, cfg.frontend_len, cfg.d_model),
                                    device=dev, generator=gen)}
    out["check"] = decode_vs_forward(
        torch, dev, cfg, params, batch, 32,
        f"[lm families] {VLM} {FAMILY_CUT_LAYERS} layers "
        f"({cfg.frontend_len} patches)")
    del params
    _free(torch)
    params, out["bf16"] = family_params(
        torch, dev, cfg, DTypePolicy(), SEED + 112,
        f"{VLM} cut to {FAMILY_CUT_LAYERS} layers")
    out["held_gib"] = out["bf16"]["held_gib"]
    out["serving"] = decode_capture(torch, dev, cfg, params)
    out["peak_gib"] = peak_gib(torch, dev)
    del params
    _free(torch)
    return out


def profile_lm_families(torch, dev):
    """Where a decode step's device time goes: one captured decode step
    (B=4, position 16, bf16) of rwkv6-1.6b and of qwen2-moe-a2.7b at
    their published configs under ``torch.profiler`` (run with the other
    profiles, last): its kernels' ms, their number and the top ones."""
    from repro_torch.models import api
    from repro_torch.models.common import DTypePolicy
    from repro_torch.serve.engine import CapturedDecode
    from repro_torch.serve.steps import make_decode_step
    out = {}
    for arch, seed in ((RWKV, SEED + 120), (MOE_ARCHS[1], SEED + 121)):
        cfg = dense_cfg(arch)
        params = lm_params(torch, dev, cfg, DTypePolicy(), seed)
        decoder = CapturedDecode(make_decode_step(cfg, donate=True), dev)
        cache = api.init_cache(cfg, 4, 64, device=dev)
        token = torch.zeros(4, dtype=torch.long, device=dev)

        def step():
            with torch.inference_mode():
                decoder(params, token, cache, 16)
        step()                                    # the capture
        ms, n, top = profile_device(torch, step, top=8)
        out[arch] = {"device_ms": ms, "kernels": n, "top_kernels": top}
        if ms is not None:
            print(f"[profile] {arch} decode step (captured, B=4, bf16, "
                  f"position 16): {ms:.3f} ms of kernels in {n} launches; "
                  "top: " + "; ".join(
                      f"{r['kernel'][:56]} {r['ms']:.3f} ms "
                      f"({r['share']:.3f}, {r['calls']} calls)"
                      for r in top))
        del params, decoder, cache
        _free(torch)
    return out


def phase_lm_families(torch, dev):
    """``[lm families]``: rwkv6-1.6b, granite-moe-1b-a400m,
    qwen2-moe-a2.7b, seamless-m4t-medium and internvl2-26b, each model
    freed before the next, with its peak device memory."""
    out = {RWKV: phase_rwkv(torch, dev)}
    for i, arch in enumerate(MOE_ARCHS):
        out[arch] = phase_moe(torch, dev, arch, SEED + 90 + 5 * i)
    out[ENCDEC] = phase_encdec(torch, dev)
    out[VLM] = phase_vlm(torch, dev)
    for arch, d in out.items():
        print(f"[lm families] {arch}: peak device memory "
              f"{d['peak_gib']:.2f} GiB from its bf16 weights' draw to "
              f"the end of their serving ({d['held_gib']:.2f} GiB held by "
              f"earlier phases before it)")
    return out


# --------------------------------------------------------------------------
# training: zamba2-1.2b at its published config, the conv1d kernel under
# autograd, and the fold convs' gradients
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_T = 4, 1024          # 4,096 tokens a step
TRAIN_STEPS, TRAIN_SAVE_AT = 6, 3   # the restart: save at 3, resume to 6
TRAIN_SEED = SEED + 31
TRAIN_LR = 3e-4
# "none" keeps every activation the backward reads: 64.8 GiB for the
# gradient alone, and beside AdamW's 13 GiB of state the step runs out of
# the card's memory (PERF.md, the training findings); "full" recomputes
# each layer body
TRAIN_REMAT = "full"
TOL_GRAD = 1e-4     # fold-conv grads vs the reference chain's, of max|ref|


def train_setup():
    """zamba2-1.2b's published config, the synthetic pipeline (B x T) and
    AdamW with a 2-step warm-up and cosine decay over the run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    cfg = get_config(ZAMBA)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_T,
                      global_batch=TRAIN_B, seed=TRAIN_SEED)
    opt = AdamWConfig(lr=TRAIN_LR, schedule=warmup_cosine(TRAIN_LR, 2,
                                                           TRAIN_STEPS))
    return cfg, data, opt


def train_conv1d_launches(cfg):
    """conv1d launches a step: the forward and dx through the kernel, and
    the forward once more under a remat that recomputes it."""
    return (3 if TRAIN_REMAT != "none" else 2) * cfg.n_layers


def train_params(torch, dev, cfg):
    """The weights ``Trainer`` draws for seed ``TRAIN_SEED`` (bf16)."""
    from repro_torch.models import api
    return api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), device=dev)


def leaves_equal(torch, got, want):
    """Names of the leaves of two trees that differ in type, shape or
    bits (empty: bitwise equal)."""
    from repro_torch.tree import leaves_with_path
    bad = []
    for (path, a), (_, b) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        if a.dtype != b.dtype or not torch.equal(a, b.to(a.device)):
            bad.append("/".join(map(str, path)))
    return bad


def phase_train_grads(torch, dev, cfg, data, opt):
    """One step at the seeded weights on the first batch, the conv1d
    kernel against the plain conv1d: the smoke swaps ``ssm``'s
    ``conv1d_causal`` for its ``impl="ref"`` form.  The kernel's forward
    is bitwise its plain version and so is dx through it (the forward of
    the time-reversed gradient), so the loss, every gradient and the new
    parameters must be bitwise equal.  Every leaf's gradient finite and
    not all zero (a detach would leave zeros), and the conv1d launches of
    the step counted."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models.settings import remat
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.train.steps import batch_to, lm_grads
    from repro_torch.tree import leaves_with_path
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    params = train_params(torch, dev, cfg)
    batch = batch_to(TokenPipeline(data).next_batch(), dev)

    def step():
        before = cc.launch_counts()[cc.KERNEL]
        with remat(TRAIN_REMAT):
            m, g = lm_grads(params, cfg, batch)
        new, _, om = adamw_update(params, g, init_opt_state(params), opt)
        torch.cuda.synchronize()
        return m, g, new, om, cc.launch_counts()[cc.KERNEL] - before

    out = {}
    m_k, g_k, p_k, om_k, n_k = step()
    want = train_conv1d_launches(cfg)
    print(f"[train] one step at the seeded weights: {n_k} conv1d launches "
          f"({cfg.n_layers} forward + {cfg.n_layers} dx"
          + (f" + {cfg.n_layers} recompute" if TRAIN_REMAT != "none"
             else "") + f"), loss {float(m_k['loss']):.6f}, grad norm "
          f"{float(om_k['grad_norm']):.4f}")
    check(n_k == want, f"train step: {n_k} conv1d launches, {want} "
          "expected")
    dead = [("/".join(map(str, p)), bool(torch.isfinite(g).all()))
            for p, g in leaves_with_path(g_k)
            if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    n_leaves = len(leaves_with_path(g_k))
    print(f"[train] {n_leaves} parameter leaves: every gradient finite "
          f"and nonzero: {not dead}")
    check(not dead, f"leaves with no usable gradient (name, finite): "
          f"{dead}")
    orig = ssm.conv1d_causal
    ssm.conv1d_causal = lambda x, w, impl=None: ops.conv1d_causal(
        x, w, impl="ref")
    try:
        m_r, g_r, p_r, om_r, n_r = step()
    finally:
        ssm.conv1d_causal = orig
    check(n_r == 0, "the plain conv1d launched the kernel")
    bad = {"loss": [] if torch.equal(m_k["loss"], m_r["loss"]) else
           ["loss"], "grads": leaves_equal(torch, g_k, g_r),
           "params": leaves_equal(torch, p_k, p_r)}
    bitwise = not any(bad.values())
    worst = 0.0
    for (path, a), (_, b) in zip(leaves_with_path(g_k),
                                 leaves_with_path(g_r)):
        err = (a.float() - b.float()).abs()
        worst = max(worst, err.max().item()
                    / max(b.float().abs().max().item(), 1e-30))
        if not bitwise:
            # the fallback: the bf16 element limit scaled by the leaf
            lim = BF16_STEP * b.float().abs() + TOL_KERNEL * \
                b.float().abs().max().item()
            check(bool((err <= lim).all()),
                  f"train: kernel vs plain conv1d, {path} beyond the bf16 "
                  "element limit")
    print(f"[train] the step with the kernel against the step with the "
          f"plain conv1d (deterministic algorithms): loss, {n_leaves} "
          f"gradients and the new parameters bitwise: {bitwise}"
          + ("" if bitwise else f" (differing: {bad}; largest gradient "
             f"error {worst:.3e} of its leaf's max)"))
    out.update(conv1d_launches_per_step=n_k, leaves=n_leaves,
               kernel_vs_plain_bitwise=bitwise, differing=bad,
               max_rel_grad_err=worst, loss=float(m_k["loss"]),
               grad_norm=float(om_k["grad_norm"]))
    return out


def phase_train(torch, dev, cfg, data, opt):
    """Six steps through ``Trainer`` (each timed between two syncs, its
    conv1d launches counted), the peak device memory, then the restart:
    a ``Trainer`` that checkpoints at step 3 into a directory under the
    temporary directory and a new one that restores and runs to step 6,
    held bitwise to the uninterrupted run (parameters, optimizer state
    and every step's loss)."""
    import shutil
    import tempfile
    from repro_torch.train.steps import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    step = make_train_step(cfg, opt, remat=TRAIN_REMAT)
    rec = {"ms": [], "launches": []}

    def timed(params, opt_state, batch):
        torch.cuda.synchronize()
        n0, t0 = cc.launch_counts()[cc.KERNEL], time.perf_counter()
        out = step(params, opt_state, batch)
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["launches"].append(cc.launch_counts()[cc.KERNEL] - n0)
        return out

    def trainer(total, ckpt_dir=None, step_fn=timed):
        return Trainer(cfg, TrainerConfig(
            total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=TRAIN_SAVE_AT,
            log_every=1, seed=TRAIN_SEED, remat=TRAIN_REMAT), opt_cfg=opt,
            data_cfg=data, step_fn=step_fn, device=dev)

    _free(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2**30
    whole = trainer(TRAIN_STEPS)
    t0 = time.perf_counter()
    p_ref, o_ref = whole.run()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    hist = whole.history
    check(len(hist) == TRAIN_STEPS and all(
        math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
        for h in hist), "train: a non-finite loss or grad norm")
    want = train_conv1d_launches(cfg)
    check(rec["launches"] == [want] * TRAIN_STEPS,
          f"train: conv1d launches per step {rec['launches']}, {want} "
          "expected")
    steady = rec["ms"][1:]
    mean = sum(steady) / len(steady)
    out = {"step_ms": rec["ms"], "step_ms_mean": mean,
           "step_ms_min": min(steady), "step_ms_max": max(steady),
           "tokens_per_s": TRAIN_B * TRAIN_T / (mean / 1e3),
           "peak_gib": peak, "held_before_gib": held,
           "conv1d_launches_per_step": want, "remat": TRAIN_REMAT,
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "params": cfg.param_count(), "run_s": run_s}
    print(f"[train] {ZAMBA} ({cfg.param_count():,} parameters, bf16, "
          f"remat {TRAIN_REMAT}) B={TRAIN_B} x T={TRAIN_T}: steps 2-"
          f"{TRAIN_STEPS} {mean:.2f} ms mean ({min(steady):.2f}-"
          f"{max(steady):.2f}), {out['tokens_per_s']:.1f} tokens/s; step 1 "
          f"{rec['ms'][0]:.2f} ms; peak device memory {peak:.2f} GiB "
          f"({held:.2f} GiB held before); {want} conv1d launches a step")
    print("[train] losses " + ", ".join(f"{x:.4f}" for x in out["losses"])
          + "; grad norms " + ", ".join(f"{x:.3f}" for x in
                                        out["grad_norms"]))
    ref = [t.cpu() for t in leaves({"params": p_ref, "opt": o_ref})]
    del p_ref, o_ref, whole
    _free(torch)

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        first = trainer(TRAIN_SAVE_AT, d)
        first.run()
        second = trainer(TRAIN_STEPS, d)
        p, o = second.run()
        t2 = time.perf_counter()
        got = leaves({"params": p, "opt": o})
        bad = [i for i, (a, b) in enumerate(zip(got, ref))
               if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
        losses = [h["loss"] for h in first.history + second.history]
        # the directory holds steps 3 and 6: two checkpoints of one size
        ckpt_gib = sum(f.stat().st_size for f in pathlib.Path(d).rglob(
            "*.npy")) / 2**30 / 2
    finally:
        shutil.rmtree(d, ignore_errors=True)
    step_s = sum(rec["ms"][TRAIN_STEPS:]) / 1e3
    out.update(restart_bitwise=not bad and losses == out["losses"],
               restart_s=t2 - t0, restart_steps_s=step_s,
               checkpoint_gib=ckpt_gib)
    print(f"[train] restart: checkpoint at step {TRAIN_SAVE_AT} "
          f"({ckpt_gib:.2f} GiB on disk), a new Trainer restores and runs "
          f"to {TRAIN_STEPS}: {t2 - t0:.1f} s ({step_s:.1f} s of it "
          f"steps); parameters, optimizer state and losses bitwise the "
          f"uninterrupted run: {out['restart_bitwise']}"
          + ("" if not bad else f" ({len(bad)} leaves differ)"))
    check(out["restart_bitwise"], "train: the restart is not bitwise the "
          "uninterrupted run")
    del p, o, got, ref
    _free(torch)
    return out


def profile_train(torch, dev, cfg, data, opt, host_ms):
    """One training step under ``torch.profiler`` after a warm-up step:
    its device time by kernel and the busy share against the steps'
    host-clock mean."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import batch_to, make_train_step
    params = train_params(torch, dev, cfg)
    state = init_opt_state(params)
    batch = batch_to(TokenPipeline(data).next_batch(), dev)
    step = make_train_step(cfg, opt, remat=TRAIN_REMAT)
    step(params, state, batch)
    ms, n, top = profile_device(torch, lambda: step(params, state, batch),
                                top=8)
    out = {"device_ms": ms, "kernels": n, "top_kernels": top}
    if ms is not None:
        out["busy_share"] = ms / host_ms
        print(f"[profile] train step ({ZAMBA}, B={TRAIN_B} x {TRAIN_T}): "
              f"{ms:.3f} ms of kernels in {n} launches against "
              f"{host_ms:.2f} ms on the host clock: busy share "
              f"{out['busy_share']:.3f}; top: "
              + "; ".join(f"{r['kernel'][:56]} {r['ms']:.3f} ms "
                          f"({r['share']:.3f}, {r['calls']} calls)"
                          for r in top))
    del params, state
    _free(torch)
    return out


def grads_of(torch, fn, tensors):
    """Gradients of ``mean(fn() ** 2)`` with respect to ``tensors``."""
    live = [t.detach().clone().requires_grad_(True) for t in tensors]
    y = fn(*live)
    return y, torch.autograd.grad((y.float() ** 2).mean(), live)


def hold_grads(torch, got, want, names, what):
    """Each gradient within TOL_GRAD of its reference's max |value|;
    returns the largest error relative to it."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst = max(worst, err)
        check(err <= TOL_GRAD, f"{what}: d{name} off the reference chain's "
              f"by {err:.3e} of its max")
    return worst


def phase_fold_grads(torch, dev):
    """Gradients through ``ops.conv2d_fused`` on the fold impls, on the
    card, each against the reference chain's (``impl="direct"``: the
    plain conv and ``apply_epilogue``) on the same operands: a full-width
    ResNet-18 basic block (s2b1, 128 channels at 16x16, the residual
    fused) with fold_ws, fold_os and fold_auto; a full-width MobileNetV2
    inverted residual (b2: 24 -> 144 -> 24 at 32x32, BN and ReLU6 fused,
    the depthwise on fold_dw, the projection's residual fused) with its
    1x1s on fold_ws and fold_os; one conv on fold_ws_psum; batch 4, fp32.
    Returns {impl: largest error} and the kernels' launches."""
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.graph import bn_scale_shift
    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.kernels import ops
    from repro_torch.models import mobilenet, resnet
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    rp = resnet.init_params(gen, img=32, device=dev)
    mp = randomize_bn(torch, mobilenet.init_params(gen, img=32, device=dev))
    errs = {}
    cw.reset_launch_counts()

    # ResNet-18 s2b1: relu(conv(x)+b) -> conv(.)+b + x -> relu
    c1, c2 = rp["s2b1_c1"], rp["s2b1_c2"]
    xr = torch.randn(4, 128, 16, 16, device=dev, generator=gen)
    br = Epilogue(bias=True, relu=True)
    brr = Epilogue(bias=True, relu=True, residual=True)

    def resnet_block(impl):
        def fn(x, w1, b1, w2, b2):
            h = ops.conv2d_fused(x, w1, b1, pad=1, epilogue=br, impl=impl)
            return ops.conv2d_fused(h, w2, b2, pad=1, epilogue=brr,
                                    impl=impl, residual=x)
        return fn
    r_ops = [xr, c1["w"], c1["b"], c2["w"], c2["b"]]
    r_names = ["x", "c1.w", "c1.b", "c2.w", "c2.b"]
    _, r_ref = grads_of(torch, resnet_block("direct"), r_ops)

    # MobileNetV2 b2: 1x1 expand (BN, ReLU6) -> 3x3 depthwise (BN,
    # ReLU6) -> 1x1 project (BN) + x
    ex, dw, pr = (mp[f"b2_{k}"] for k in ("exp", "dw", "proj"))
    bn = {k: mp[f"b2_{k}_bn"] for k in ("exp", "dw", "proj")}
    xm = torch.randn(4, 24, 32, 32, device=dev, generator=gen)
    act = Epilogue(scale=True, relu6=True)
    lin = Epilogue(scale=True, residual=True)
    m_names = ["x", "exp.w", "dw.w", "proj.w"] + [
        f"{k}_bn.{s}" for k in ("exp", "dw", "proj")
        for s in ("gamma", "beta", "mean", "var")]
    m_ops = [xm, ex["w"], dw["w"], pr["w"]] + [
        bn[k][s] for k in ("exp", "dw", "proj")
        for s in ("gamma", "beta", "mean", "var")]
    hidden = dw["w"].shape[0]

    def mnv2_block(impl, dw_impl):
        def fn(x, we, wd, wp, *stats):
            s = [bn_scale_shift(dict(zip(("gamma", "beta", "mean", "var"),
                                         stats[4 * i:4 * i + 4])))
                 for i in range(3)]
            h = ops.conv2d_fused(x, we, epilogue=act, impl=impl,
                                 scale=s[0][0], shift=s[0][1])
            h = ops.conv2d_fused(h, wd, pad=1, epilogue=act, impl=dw_impl,
                                 scale=s[1][0], shift=s[1][1],
                                 groups=hidden)
            return ops.conv2d_fused(h, wp, epilogue=lin, impl=impl,
                                    residual=x, scale=s[2][0],
                                    shift=s[2][1])
        return fn
    _, m_ref = grads_of(torch, mnv2_block("direct", "direct"), m_ops)

    launched = {}
    for impl in ("fold_ws", "fold_os", "fold_auto"):
        before = cw.launch_counts()
        _, g = grads_of(torch, resnet_block(impl), r_ops)
        errs[f"resnet18 s2b1 {impl}"] = hold_grads(
            torch, g, r_ref, r_names, f"resnet18 s2b1 {impl}")
        dw_impl = "fold_dw"
        _, g = grads_of(torch, mnv2_block(impl, dw_impl), m_ops)
        errs[f"mobilenetv2 b2 {impl} + fold_dw"] = hold_grads(
            torch, g, m_ref, m_names, f"mobilenetv2 b2 {impl}")
        after = cw.launch_counts()
        launched[impl] = {k: after[k] - before[k] for k in after
                          if after[k] > before[k]}
    # one conv on psum staging: its identity epilogue, bias and ReLU after
    psum_fn = lambda impl: (  # noqa: E731
        lambda x, w, b: torch.relu(ops.conv2d_fused(
            x, w, pad=1, epilogue=Epilogue(), impl=impl)
            + b[None, :, None, None]))
    p_ops = [xr, c1["w"], c1["b"]]
    _, p_ref = grads_of(torch, psum_fn("direct"), p_ops)
    before = cw.launch_counts()
    _, g = grads_of(torch, psum_fn("fold_ws_psum"), p_ops)
    after = cw.launch_counts()
    launched["fold_ws_psum"] = {k: after[k] - before[k] for k in after
                                if after[k] > before[k]}
    errs["resnet18 s2b1_c1 fold_ws_psum"] = hold_grads(
        torch, g, p_ref, ["x", "w", "b"], "psum")
    for what, e in errs.items():
        print(f"[fold grads] {what}: every gradient within {e:.3e} of its "
              f"reference chain's max (limit {TOL_GRAD:g})")
    print(f"[fold grads] kernel launches by impl (forward only: the "
          f"backward recomputes through the reference): {launched}")
    for impl, kernels in (("fold_ws", "fold_conv_ws"),
                          ("fold_os", "fold_conv_os"),
                          ("fold_ws_psum", "fold_conv_psum")):
        check(launched[impl].get(kernels, 0) > 0,
              f"fold grads: {impl} launched no {kernels}")
    check(all(launched[i].get("fold_conv_dw", 0) > 0
              for i in ("fold_ws", "fold_os", "fold_auto")),
          "fold grads: the depthwise layer launched no fold_conv_dw")
    return {"max_rel_err": errs, "launches": launched}


# fold calls per forward by kernel that foldlint's launch audit must count
FOLDLINT_LAUNCHES = {
    ("vgg16", 224, 1): {"fold_conv_ws": 13},
    ("vgg16", 32, 4): {"fold_conv_ws": 2, "fold_conv_os": 11},
    ("resnet18", 32, 4): {"fold_conv_ws": 5, "fold_conv_os": 15},
    ("mobilenetv2", 32, 4): {"fold_conv_dw": 17, "fold_conv_ws": 7,
                             "fold_conv_os": 28}}


def phase_foldlint(torch, dev):
    """``python -m repro_torch.analysis.foldlint --model all --device cuda``
    at full width, batch 4 and img 32 (the shapes phases 4, 6 and 7
    compile), and VGG-16 at 224, batch 1 (phase 3's): no error finding,
    every conv's plan, launch and CTA tile (at the card's SM count)
    proven, and the launch audit's fold calls per forward by kernel."""
    import contextlib
    import io
    from repro_torch.analysis import foldlint
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = foldlint.main(["--model", "all", "--device", "cuda",
                            "--width-mult", "1.0", "--batch", "4",
                            "--json"])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    rows.append(foldlint.lint_model("vgg16", img=224, width_mult=1.0,
                                    batch=1, classes=1000, device=dev))
    seconds = time.perf_counter() - t0
    for r in rows:
        key = (r["model"], r["input_shape"][2], r["input_shape"][0])
        rep = r["report"]
        print(f"[foldlint] {key[0]} {key[1]} b{key[2]} on {r['device']} "
              f"({r['sm_count']} SMs): ok={r['ok']}, {r['conv_layers']} "
              f"conv layers, {r['fold_calls']} fold calls "
              f"{r['launches']}, {rep['errors']} errors, "
              f"{rep['warnings']} warnings")
        check(r["ok"] and rep["errors"] == 0,
              f"foldlint {key}: {rep['findings']}")
        check(r["launches"] == FOLDLINT_LAUNCHES[key]
              and r["fold_calls"] == r["conv_layers"],
              f"foldlint {key}: the audit counted {r['launches']}")
    check(rc == 0, f"foldlint exited {rc}")
    print(f"[foldlint] 4 networks in {seconds:.3f} s")
    return {"rows": rows, "seconds": seconds}


# -- [mesh vision] / [mesh lm]: the scale-out path ---------------------------

MESH_IMG, MESH_WIDTH = 224, 1.0     # VGG-16 at its published widths
MESH_BUCKETS = (2, 4)
MESH_REQUESTS = 6                   # requests of 1-4 images from MESH_SEED
MESH_SEED = SEED + 80
MESH_SHAPES = ((2, 1), (1, 2))      # the two-rank meshes (data x model)
# (model, image size, the two-rank meshes it runs on), each at full
# width; MobileNetV2 (CIFAR-scale, 32 px) splits fold_dw, fold_os, the
# batch norm's scale / shift and the fused residual
MESH_MODELS = (("vgg16", MESH_IMG, MESH_SHAPES),
               ("mobilenetv2", 32, ((1, 2),)))
MESH_DTYPES = ("float32", "bfloat16")
PIPE_STAGES, PIPE_MICRO, PIPE_T = 2, 4, 512   # 4 microbatches of 1 x 512
PIPE_SEED = SEED + 81
MESH_RANK_TIMEOUT_S = 720           # both ranks, start to finish


def mesh_images(img):
    """The [mesh vision] stream: ``MESH_REQUESTS`` requests of 1-4 images
    at ``img``, fp32, from ``MESH_SEED``."""
    import numpy as np
    rng = np.random.default_rng(MESH_SEED)
    return [rng.standard_normal((int(k), 3, img, img)).astype(
        np.float32) for k in rng.integers(1, max(MESH_BUCKETS) + 1,
                                          MESH_REQUESTS)]


def mesh_params(torch, dev, model, img, dtype):
    """``model``'s weights for the mesh phases, from a generator on
    ``dev`` seeded ``MESH_SEED`` (MobileNetV2's batch-norm statistics
    from ``randomize_bn``): every rank's process draws the same bits."""
    from repro_torch.models import zoo
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    params = zoo.get_conv_model(model).init_params(
        gen, img=img, width_mult=MESH_WIDTH, device=dev,
        dtype=getattr(torch, dtype))
    return randomize_bn(torch, params) if model == "mobilenetv2" else params


def fold_launches():
    """Every fold-conv and head-kernel count, in one dict."""
    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.kernels import dense as dn
    out = dict(cw.launch_counts())
    out.update(dn.launch_counts())
    return out


def serve_mesh_stream(torch, dev, model, params, mesh, imgs, jit=True):
    """The stream through a ``VisionEngine`` of ``model`` (on ``mesh``, or
    none): (logits of every request in order, the metrics, the kernel
    launches of the engine's whole life: compile, warm-up, capture,
    serving)."""
    import numpy as np
    from repro_torch.models import zoo
    from repro_torch.serve.vision import VisionEngine
    before = fold_launches()
    eng = VisionEngine(params, zoo.get_conv_model(model).to_graph(),
                       img=imgs[0].shape[-1],
                       buckets=MESH_BUCKETS, jit=jit, device=dev, mesh=mesh)
    eng.warmup()
    reqs = [eng.submit(im) for im in imgs]
    eng.run()
    for r in reqs:
        check(r.outcome.value == "ok" and r.served_by == "primary",
              f"mesh {None if mesh is None else mesh.shape}: request "
              f"{r.rid} {r.outcome.value} by {r.served_by}")
    d = eng.metrics_dict()
    rb = d["robustness"]
    check(not (rb["degraded_batches"] or rb["failed"]
               or rb["nonfinite_batches"] or rb["lost_requests"]),
          f"mesh serving: degraded / failed / non-finite / lost {rb}")
    after = fold_launches()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] - before.get(k, 0)}
    return np.concatenate([r.logits for r in reqs]), d, launches


def mesh_line(what, d, launches, bitwise, err):
    lat = d["latency"]
    return (f"[mesh vision] {what}: {d['requests']} requests / "
            f"{d['images']} images, {d['images_per_s']:.3f} images/s, p50 "
            f"{lat['p50_s'] * 1e3:.3f} ms; mesh {d['mesh']}, buckets "
            f"{d['buckets']}; launches {launches}; logits bitwise the "
            f"mesh-less engine's: {bitwise} (max abs diff {err:.3e})")


def phase_mesh_vision_one_rank(torch, dev, mesh, out_dir):
    """VGG-16 at 224 through the mesh-less engine (CUDA graphs) and
    through ``VisionEngine(mesh=make_local_mesh(1, 1))`` (NCCL), fp32 then
    bf16: the mesh's logits bitwise the mesh-less ones.  MobileNetV2's
    mesh-less logits too.  The mesh-less logits go to ``out_dir`` for the
    two-rank phases."""
    import numpy as np
    out = {}
    for model, img, _ in MESH_MODELS:
        imgs = mesh_images(img)
        for dtype in MESH_DTYPES:
            params = mesh_params(torch, dev, model, img, dtype)
            ref, d0, l0 = serve_mesh_stream(torch, dev, model, params, None,
                                            imgs)
            np.save(out_dir / f"{model}_{dtype}.npy", ref)
            print(mesh_line(f"{model} {dtype} mesh-less (CUDA graphs)", d0,
                            l0, True, 0.0))
            out[f"{model} {dtype}"] = {"alone": {
                "images_per_s": d0["images_per_s"], "launches": l0}}
            if model == "vgg16":
                got, d1, l1 = serve_mesh_stream(torch, dev, model, params,
                                                mesh, imgs)
                bitwise = bool(np.array_equal(got, ref))
                err = float(np.abs(got - ref).max())
                print(mesh_line(f"{model} {dtype} 1x1 ({mesh.backend})", d1,
                                l1, bitwise, err))
                check(bitwise, f"mesh vision 1x1 {model} {dtype}: logits "
                      "differ from the mesh-less engine's")
                out[f"{model} {dtype}"]["1x1"] = {
                    "images_per_s": d1["images_per_s"], "launches": l1,
                    "bitwise": bitwise, "backend": mesh.backend}
            del params
            _free(torch)
    return out


def phase_mesh_lm_one_rank(torch, dev, mesh):
    """[train]'s setup (zamba2-1.2b, B=4 x 1024, the seeded weights, the
    first batch): one step under ``set_context(mesh, make_rules(cfg,
    mesh))`` bitwise the step without a context (loss, new parameters,
    optimizer state), then ``compressed_psum`` over that batch's full
    gradient tree on the mesh's one-rank group bitwise
    ``int8_roundtrip``; under deterministic algorithms."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import sharding
    from repro_torch.distributed.compression import (compressed_psum,
                                                     int8_roundtrip)
    from repro_torch.models.settings import remat
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import batch_to, lm_grads, make_train_step
    from repro_torch.tree import leaves
    cfg, data, opt = train_setup()
    params = train_params(torch, dev, cfg)
    batch = batch_to(TokenPipeline(data).next_batch(), dev)
    step = make_train_step(cfg, opt, remat=TRAIN_REMAT)
    rules = sharding.make_rules(cfg, mesh)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        p0, s0, m0 = step(params, init_opt_state(params), batch)
        torch.cuda.synchronize()
        ms_plain = 1e3 * (time.perf_counter() - t0)
        want = [t.cpu() for t in leaves((p0, s0))] + [m0["loss"].cpu()]
        del p0, s0
        _free(torch)
        sharding.set_context(mesh, rules)
        try:
            t0 = time.perf_counter()
            p1, s1, m1 = step(params, init_opt_state(params), batch)
            torch.cuda.synchronize()
            ms_ctx = 1e3 * (time.perf_counter() - t0)
            got = leaves((p1, s1)) + [m1["loss"]]
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
            del p1, s1, got, want
            _free(torch)
            with remat(TRAIN_REMAT):
                _, grads = lm_grads(params, cfg, batch)
        finally:
            sharding.clear_context()
        group = mesh.group("data")
        t0 = time.perf_counter()
        psum_bad = [i for i, g in enumerate(leaves(grads))
                    if not torch.equal(compressed_psum(g, group),
                                       int8_roundtrip(g))]
        torch.cuda.synchronize()
        psum_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    n_leaves = len(leaves(grads))
    print(f"[mesh lm] {ZAMBA} step B={TRAIN_B} x {TRAIN_T} under a 1x1 "
          f"({mesh.backend}) sharding context: loss {float(m1['loss']):.6f}"
          f", parameters, optimizer state and loss bitwise the step "
          f"without one: {not bad} ({ms_ctx:.1f} ms under the context, "
          f"{ms_plain:.1f} ms without)")
    print(f"[mesh lm] compressed_psum over the step's {n_leaves} gradient "
          f"leaves on the one-rank {mesh.backend} group, bitwise "
          f"int8_roundtrip: {not psum_bad} ({psum_s:.2f} s)")
    check(not bad, f"mesh lm: the step under a 1x1 context differs from "
          f"the step without one ({len(bad)} leaves)")
    check(not psum_bad, f"mesh lm: compressed_psum differs from "
          f"int8_roundtrip on {len(psum_bad)} leaves")
    del params, grads
    _free(torch)
    return {"step_bitwise": not bad, "step_ms_context": ms_ctx,
            "step_ms_plain": ms_plain, "psum_bitwise": not psum_bad,
            "psum_leaves": n_leaves, "psum_s": psum_s}


def pipe_inputs(torch, dev):
    """zamba2-1.2b's 38 stacked mamba2 layers (bf16, from ``PIPE_SEED``)
    and the pipeline's microbatches: (PIPE_MICRO, 1, PIPE_T, d_model)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    cfg = get_config(ZAMBA)
    gen = torch.Generator(device=dev).manual_seed(PIPE_SEED)
    blocks = transformer.init_params(cfg, gen, device=dev)["blocks"]
    x = torch.randn((PIPE_MICRO, 1, PIPE_T, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    return cfg, blocks, x


# [mesh lm] on two ranks: zamba2-1.2b at its published config through
# Trainer(mesh=) and token_serving_summary(mesh=)
# 1x2 first: its checkpoints are gone before 2x1 writes the ones
# [elastic] restores (the disk never holds more than two of these
# 15.3 GiB checkpoints at once)
MESH_LM_SHAPES = ((1, 2), (2, 1))
MESH_TRAIN_STEPS = 2                # the restart saves after step 1
MESH_CUT_B, MESH_CUT_T = 2, 256     # the fp32 step, depth cut
MESH_CUT_SEED = SEED + 82
MESH_CUT_LR = 1e-3
# each prompt token is a decode call (the engine steps prompts through
# decode) of up to ~1 s on 1x2: 4-token prompts, two waves of requests
# (8-token ones took the smoke past 1050 s once [elastic] ran too)
MESH_SERVE = {"batch": 4, "max_len": 64, "prompt_len": 4,
              "new_tokens": 12, "requests": 8}
# bf16 is held on its first call alone: one batch of requests, 2-token
# prompts, 2 new tokens
MESH_SERVE_BY_DTYPE = {"float32": MESH_SERVE,
                       "bfloat16": dict(MESH_SERVE, requests=4, prompt_len=2,
                                        new_tokens=2)}
MESH_SERVE_SEED = SEED + 83
TOL_MESH_LOSS = 1e-2                # bf16 two-rank loss vs one rank
TOL_MESH_FP32 = 1e-5                # fp32 loss, logits, the tie gap
TOL_MESH_MU = 1e-4                  # fp32 first moment, of each leaf's max
TOL_MESH_BF16 = 3e-2                # bf16 first logits, of max(1, max|ref|)
MESH_PARENT_GIB = 8.0               # the most the parent may hold then


def mesh_serve_refs(torch, dev, out_dir):
    """The one-rank engine (mesh-less, its decode step captured) over the
    [mesh lm] serving stream, fp32 then bf16: each decode call's logits
    go to ``out_dir`` for the ranks; returns the summaries."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import token_serving_summary
    vocab = get_config(ZAMBA).vocab
    out = {}
    for dtype in MESH_DTYPES:
        d = token_serving_summary(ZAMBA, full=True, seed=MESH_SERVE_SEED,
                                  device=dev, fp32=dtype == "float32",
                                  record_logits=True,
                                  **MESH_SERVE_BY_DTYPE[dtype])
        # the real vocab: the padded rows hold -1e30 on both sides
        np.save(out_dir / f"serve_{dtype}.npy", np.stack(
            d.pop("step_logits"))[..., :vocab])
        check(d["requests_lost"] == 0, f"mesh lm serve one rank {dtype}: "
              f"{d['requests_lost']} requests lost")
        out[dtype] = d
        print(f"[mesh lm] serve {ZAMBA} {dtype} one rank ({d['decode']}): "
              f"{d['requests_done']}/{d['requests']} requests, "
              f"{d['tokens']} tokens, {d['tokens_per_s']:.3f} tokens/s, "
              f"decode step {d['decode_step_ms']:.3f} ms (each call's "
              "logits read back)")
        _free(torch)
    return out


def held_steps(ref, got, rel):
    """Each decode call's logits of the mesh engine (``got``) against the
    one-rank engine's (``ref``), both (calls, batch, vocab): (the largest
    error over the call's max|ref|, the ties, the rows whose next token
    differs).  A row whose one-rank top-2 gap at a call is below
    ``rel·max|ref|`` is a tie: it is reported, and that row is compared
    no further (its tokens may part from there)."""
    import numpy as np
    worst, ties, differ, dropped = 0.0, [], [], set()
    for i in range(ref.shape[0]):
        scale = float(np.abs(ref[i]).max())
        for r in range(ref.shape[1]):
            if r in dropped:
                continue
            worst = max(worst, float(np.abs(got[i, r] - ref[i, r]).max())
                        / scale)
            top = np.sort(ref[i, r])[-2:]
            if top[1] - top[0] < rel * scale:
                ties.append([i, r])
                dropped.add(r)
            elif int(got[i, r].argmax()) != int(ref[i, r].argmax()):
                differ.append([i, r])
    return worst, ties, differ


def staged_collectives(mesh):
    """(calls, host seconds) of the collectives this rank has run on the
    mesh's groups of more than one rank (``distributed/hostgloo.py``'s
    counters: the ranks share the card)."""
    stats = [mesh.group(a).stats for a in mesh.axis_names
             if mesh.shape[a] > 1]
    return (sum(st["calls"] for st in stats),
            sum(st["seconds"] for st in stats))


def mesh_lm_train(torch, dev, mesh, ckpt_dir, keep=False):
    """zamba2-1.2b's [train] setup (published config, bf16 compute and
    fp32 master, B=4 x 1024, remat full, the seeded weights) through
    ``Trainer(mesh=)`` for ``MESH_TRAIN_STEPS`` steps, each timed between
    two syncs and its conv1d launches counted (the counts from 0 just
    before, read just after); the peak device memory; then the restart:
    a mesh ``Trainer`` that checkpoints after step 1 into ``ckpt_dir``
    and a fresh one that restores there and runs step 2, each rank's
    shards bitwise the uninterrupted run's.  ``keep``: leave both
    checkpoints in ``ckpt_dir`` (for [elastic]), else rank 0 removes
    them."""
    import shutil
    import torch.distributed as dist
    from repro_torch.train.steps import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    cfg, data, opt = train_setup()
    step = make_train_step(cfg, opt, remat=TRAIN_REMAT)
    rec = {"ms": [], "launches": []}

    def timed(params, opt_state, batch):
        torch.cuda.synchronize(dev)
        n0, t0 = cc.launch_counts()[cc.KERNEL], time.perf_counter()
        out = step(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["launches"].append(cc.launch_counts()[cc.KERNEL] - n0)
        return out

    def trainer(total, directory=None):
        return Trainer(cfg, TrainerConfig(
            total_steps=total, ckpt_dir=directory, ckpt_every=1,
            log_every=1, seed=TRAIN_SEED, remat=TRAIN_REMAT), opt_cfg=opt,
            data_cfg=data, step_fn=timed, device=dev, mesh=mesh)

    _free(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    cc.reset_launch_counts()
    calls0, coll0 = staged_collectives(mesh)
    t0 = time.perf_counter()
    whole = trainer(MESH_TRAIN_STEPS)
    p, o = whole.run()
    run_s = time.perf_counter() - t0
    launches = cc.launch_counts()[cc.KERNEL]
    calls1, coll1 = staged_collectives(mesh)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    hist = whole.history
    ref = [t.to_local().cpu() for t in leaves((p, o))]
    del p, o, whole
    _free(torch)
    t0 = time.perf_counter()
    first = trainer(1, str(ckpt_dir))
    first.run()
    second = trainer(MESH_TRAIN_STEPS, str(ckpt_dir))
    p, o = second.run()
    restart_s = time.perf_counter() - t0
    bad = sum(not torch.equal(a.to_local().cpu(), b)
              for a, b in zip(leaves((p, o)), ref))
    del p, o, ref
    _free(torch)
    dist.barrier()
    if dist.get_rank() == 0 and not keep:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "restart_losses": [h["loss"] for h in first.history
                               + second.history],
            "step_ms": rec["ms"][:MESH_TRAIN_STEPS],
            "restart_step_ms": rec["ms"][MESH_TRAIN_STEPS:],
            "launches": launches,
            "launches_per_step": rec["launches"][:MESH_TRAIN_STEPS],
            "restart_launches": sum(rec["launches"][MESH_TRAIN_STEPS:]),
            "peak_gib": peak, "run_s": run_s, "restart_s": restart_s,
            "restart_leaves_differ": bad,
            "collectives": calls1 - calls0,
            "collective_s": coll1 - coll0}


def mesh_lm_cut(torch, dev, mesh):
    """The fp32 contract at full width: zamba2-1.2b with its depth cut to
    two repeats of its layer pattern (``dryrun.depth_plan``), fp32
    weights and compute, B=2 x 256, two AdamW steps on one rank and then
    the sharded steps on ``mesh`` (their trees laid out by
    ``specs.step_layout``), each on the same batch.  Held: both losses
    within ``TOL_MESH_FP32·|loss|`` (the second is taken after the first
    update); after the first step the first moment of every leaf (the
    clipped gradient times 1 - b1) within ``TOL_MESH_MU·max|mu|`` of the
    one-rank step's, and every new parameter within 2·lr and within
    ``cut_param_tol`` (what that moment's error can move it)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import depth_plan
    from repro_torch.launch.specs import step_layout
    from repro_torch.models import api
    from repro_torch.models.common import DTypePolicy
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.steps import batch_to, make_train_step
    from repro_torch.tree import leaves
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    full = get_config(ZAMBA)
    depth = depth_plan(full)[3]
    cfg = dataclasses.replace(full, n_layers=depth)
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(MESH_CUT_SEED),
        dtype_policy=DTypePolicy.fp32(), device=dev)
    batch = batch_to(TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=MESH_CUT_T, global_batch=MESH_CUT_B,
        seed=MESH_CUT_SEED)).next_batch(), dev)
    adam = AdamWConfig(lr=MESH_CUT_LR)
    step = make_train_step(cfg, adam)
    want_p, want_o, want_m = step(params, init_opt_state(params), batch)
    want = [float(want_m["loss"]),
            float(step(want_p, want_o, batch)[2]["loss"])]
    want_mu = leaves(want_o["mu"])
    del want_o
    lay = step_layout(cfg, "train", mesh, MESH_CUT_B)
    p_sh, o_sh, b_sh = lay.shardings
    args = (sharding.distribute_tree(params, p_sh),
            init_opt_state(params, o_sh),
            sharding.distribute_tree(batch, b_sh))
    del params
    cc.reset_launch_counts()
    sharding.set_context(mesh, lay.rules)
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got_p, got_o, got_m = step(*args)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = cc.launch_counts()[cc.KERNEL]
        del args
        got_m2 = step(got_p, got_o, sharding.distribute_tree(batch, b_sh))[2]
    finally:
        sharding.clear_context()
    # DTensors: the sharded steps
    got = [float(got_m["loss"].full_tensor()),
           float(got_m2["loss"].full_tensor())]
    worst = mu_worst = tight = 0.0
    for a, b, ma, mb in zip(leaves(got_p), leaves(want_p),
                            leaves(got_o["mu"]), want_mu):
        err = (a.full_tensor() - b).abs()
        worst = max(worst, float(err.max()))
        scale = max(float(mb.abs().max()), 1e-30)
        mu_err = float((ma.full_tensor() - mb).abs().max())
        mu_worst = max(mu_worst, mu_err / scale)
        dmu = TOL_MESH_MU * scale
        tight = max(tight, float((err / cut_param_tol(torch, b, mb, dmu,
                                                      adam)).max()))
    del got_p, got_o, want_p, want_mu
    _free(torch)
    return {"depth": depth, "layers_full": full.n_layers, "loss": got,
            "loss_one_rank": want,
            "loss_rel_err": max(abs(g - w) / abs(w)
                                for g, w in zip(got, want)),
            "mu_rel_err": mu_worst, "param_err_over_tol": tight,
            "param_err_over_2lr": worst / (2 * MESH_CUT_LR), "ms": ms,
            "launches": launches}


def cut_param_tol(torch, want, mu, dmu, adam):
    """Each new parameter's bound against the one-rank step's ``want``:
    ``1e-6 + 1e-5·|p|`` plus what an error ``dmu`` of the first moment
    ``mu`` can move it (AdamW's first step moves a weight by
    lr·g/(|g| + eps), so an error dg in g moves it by up to
    2·lr·dg/(|g| + eps), with g = mu / (1 - b1))."""
    g, dg = mu.abs() / (1 - adam.b1), dmu / (1 - adam.b1)
    return 1e-6 + 1e-5 * want.abs() + 2 * adam.lr * dg / (g + adam.eps)


def mesh_lm_serve(torch, dev, mesh, out_dir):
    """``token_serving_summary(mesh=)`` over the [mesh lm] stream, fp32
    then bf16, every decode call's logits recorded and held against the
    one-rank engine's (``held_steps``; bf16: the first call's)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import token_serving_summary
    vocab = get_config(ZAMBA).vocab
    out = {}
    for dtype in MESH_DTYPES:
        calls0, coll0 = staged_collectives(mesh)
        d = token_serving_summary(ZAMBA, full=True, seed=MESH_SERVE_SEED,
                                  device=dev, mesh=mesh,
                                  fp32=dtype == "float32",
                                  record_logits=True,
                                  **MESH_SERVE_BY_DTYPE[dtype])
        calls1, coll1 = staged_collectives(mesh)
        d["collectives"], d["collective_s"] = calls1 - calls0, coll1 - coll0
        got = np.stack(d.pop("step_logits"))[..., :vocab]
        ref = np.load(out_dir / f"serve_{dtype}.npy")
        d["calls"], d["calls_one_rank"] = len(got), len(ref)
        if dtype == "float32" and got.shape == ref.shape:
            d["max_err"], d["ties"], d["differ"] = held_steps(
                ref, got, TOL_MESH_FP32)
        else:
            d["max_err"] = float(np.abs(got[0] - ref[0]).max()) / max(
                1.0, float(np.abs(ref[0]).max()))
        del d["outputs"]
        out[dtype] = d
        _free(torch)
    return out


def mesh_lm_rank(torch, dev, out_dir):
    """The LM part of a rank of the two-rank phases: on 2x1 and 1x2,
    zamba2-1.2b training (``mesh_lm_train``; the ``ELASTIC_FROM`` run's
    checkpoints kept for [elastic]), the fp32 step at cut depth
    (``mesh_lm_cut``) and serving (``mesh_lm_serve``)."""
    from repro_torch.launch.mesh import make_local_mesh
    out = {}
    for data, model in MESH_LM_SHAPES:
        mesh = make_local_mesh(data, model, device=dev)
        key = f"{data}x{model}"
        t0 = time.perf_counter()
        out[key] = {"train": mesh_lm_train(torch, dev, mesh,
                                           out_dir / f"ckpt_{key}",
                                           keep=key == ELASTIC_FROM),
                    "cut": mesh_lm_cut(torch, dev, mesh),
                    "serve": mesh_lm_serve(torch, dev, mesh, out_dir)}
        out[key]["seconds"] = time.perf_counter() - t0
    return out


def mesh_rank_main(rank, port, out_dir, dev_name):
    """One rank of the two-rank phases (a process of its own, gloo on the
    one card): VGG-16 on the 2x1 and 1x2 meshes and MobileNetV2 on 1x2,
    in fp32 and bf16, against the parent's mesh-less logits, then the
    two-stage pipeline over
    zamba2's mamba2 stack against the sequential emulation, then
    zamba2-1.2b's training, fp32 step and serving on 2x1 and 1x2
    (``mesh_lm_rank``).  Writes ``rank<r>.json``; any failed check raises
    and fails the run."""
    import numpy as np
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import make_pipelined_stack
    from repro_torch.launch.mesh import (make_local_mesh, make_mesh,
                                         start_process_group)
    from repro_torch.models import transformer
    set_numerics(torch)
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    dev = torch.device(dev_name)
    out_dir = pathlib.Path(out_dir)
    start_process_group(rank, 2, port, device=dev)   # gloo: 2 ranks, 1 card
    res = {"vision": {}}
    for name, img, shapes in MESH_MODELS:
        imgs = mesh_images(img)
        for dtype in MESH_DTYPES:
            params = mesh_params(torch, dev, name, img, dtype)
            ref = np.load(out_dir / f"{name}_{dtype}.npy")
            for data, model in shapes:
                mesh = make_local_mesh(data, model, device=dev)
                got, d, launches = serve_mesh_stream(torch, dev, name,
                                                     params, mesh, imgs)
                bitwise = bool(np.array_equal(got, ref))
                key = f"{name} {dtype} {data}x{model}"
                res["vision"][key] = {
                    "line": mesh_line(
                        f"{key} ({mesh.backend}) rank {rank}", d, launches,
                        bitwise, float(np.abs(got - ref).max())),
                    "bitwise": bitwise, "images_per_s": d["images_per_s"],
                    "launches": launches}
            del params
            _free(torch)
    cfg, blocks, x = pipe_inputs(torch, dev)

    def layer_fn(lp, act):
        return transformer._mamba_layer(lp, cfg, act)[0]
    mesh = make_mesh((PIPE_STAGES,), ("pod",), device=dev)
    torch.use_deterministic_algorithms(True)
    with torch.inference_mode():
        seq = make_pipelined_stack(cfg, layer_fn, n_stages=PIPE_STAGES)
        piped = make_pipelined_stack(cfg, layer_fn, n_stages=PIPE_STAGES,
                                     mesh=mesh)
        want = seq(blocks, x)
        dist.barrier()
        torch.cuda.synchronize(dev)
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        got = piped(blocks, x)
        torch.cuda.synchronize(dev)
        pipe_s = time.perf_counter() - t0
        n_pipe = cc.launch_counts()[cc.KERNEL]
        t0 = time.perf_counter()
        again = seq(blocks, x)
        torch.cuda.synchronize(dev)
        seq_s = time.perf_counter() - t0
    res["pipeline"] = {
        "bitwise": bool(torch.equal(got, want)),
        "seq_repeatable": bool(torch.equal(again, want)),
        "finite": bool(torch.isfinite(got.float()).all()),
        "conv1d_launches": n_pipe, "pipeline_s": pipe_s, "seq_s": seq_s,
        "max_abs_diff": float((got.float() - want.float()).abs().max())}
    del blocks, x, got, want, again
    _free(torch)
    # still under deterministic algorithms: the restart is held bitwise
    res["lm"] = mesh_lm_rank(torch, dev, out_dir)
    torch.use_deterministic_algorithms(False)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh_two_ranks(torch, dev, out_dir, first_loss):
    """The one-rank serving references (``mesh_serve_refs``), then spawn
    the two ranks (after the parent has built the kernels and freed its
    memory), wait for both under ``MESH_RANK_TIMEOUT_S``, print their
    lines and check them (the two-rank training's first loss against
    ``first_loss``, [train]'s one-rank first loss on the same batch).  A
    rank that fails fails the run; at the deadline both are killed and
    the run fails."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    t0 = time.perf_counter()
    serve_refs = mesh_serve_refs(torch, dev, out_dir)
    refs_s = time.perf_counter() - t0
    _free(torch)
    # each rank's step: about half of [train]'s one-rank 35.5 GiB (its
    # 63.32 GiB peak less the 27.78 held then) plus its share of the AdamW
    # state, so this process must hold little
    held = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[mesh] the parent holds {held:.2f} GiB "
          f"({torch.cuda.memory_reserved(dev) / 2**30:.2f} reserved) as the "
          "two ranks start")
    check(held < MESH_PARENT_GIB, f"mesh: the parent holds {held:.2f} GiB; "
          "the two ranks' steps would not fit beside it")
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank_main,
                             args=(free_port(), str(out_dir), str(dev)),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_RANK_TIMEOUT_S:
                raise RuntimeError("the two-rank mesh phases passed "
                                   f"{MESH_RANK_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    seconds = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(2)]
    for key in ranks[0]["vision"]:
        for r in ranks:
            print(r["vision"][key]["line"])
            check(r["vision"][key]["bitwise"], f"mesh vision {key}: a "
                  "rank's logits differ from the mesh-less engine's")
    # MobileNetV2's split depthwise and OS kernels ran on every rank
    for key in (k for k in ranks[0]["vision"] if k.startswith("mobilenet")):
        sfx = "_bf16" if "bfloat16" in key else ""
        for i, r in enumerate(ranks):
            got = r["vision"][key]["launches"]
            for k in ("fold_conv_dw", "fold_conv_os"):
                check(got.get(k + sfx, 0) > 0, f"mesh vision {key}: rank "
                      f"{i} launched no {k + sfx}")
    from repro_torch.configs.registry import get_config
    cfg_layers = get_config(ZAMBA).n_layers
    per_stage = cfg_layers // PIPE_STAGES * PIPE_MICRO
    for i, r in enumerate(ranks):
        p = r["pipeline"]
        print(f"[mesh lm] pipeline rank {i}: {ZAMBA}'s {cfg_layers} mamba2 "
              f"layers in {PIPE_STAGES} stages on 2 ranks (gloo), "
              f"{PIPE_MICRO} microbatches of 1 x {PIPE_T}: output bitwise "
              f"the sequential emulation: {p['bitwise']} (max abs diff "
              f"{p['max_abs_diff']:.3e}); {p['conv1d_launches']} conv1d "
              f"launches on this rank ({per_stage} expected); "
              f"{p['pipeline_s'] * 1e3:.1f} ms pipelined, "
              f"{p['seq_s'] * 1e3:.1f} ms sequential")
        check(p["bitwise"] and p["finite"] and p["seq_repeatable"],
              f"mesh lm: pipeline rank {i} differs from the sequential "
              "emulation")
        check(p["conv1d_launches"] == per_stage,
              f"mesh lm: pipeline rank {i} launched conv1d "
              f"{p['conv1d_launches']} times, {per_stage} expected")
    lm = report_mesh_lm(ranks, serve_refs, first_loss)
    print(f"[mesh] the two-rank phases took {seconds:.1f} s, the one-rank "
          f"serving references {refs_s:.1f} s before them (two processes "
          "on one card over gloo: their times are not scale-out numbers)")
    return {"ranks": ranks, "seconds": seconds, "lm": lm,
            "serve_refs": serve_refs, "serve_refs_s": refs_s}


def report_mesh_lm(ranks, serve_refs, first_loss):
    """Print and check the ranks' [mesh lm] results: each rank's conv1d
    launches above 0, the first loss within ``TOL_MESH_LOSS·|loss|`` of
    the one-rank first loss, every loss and gradient norm finite, the
    restart bitwise; the fp32 step within ``TOL_MESH_FP32·|loss|`` /
    2·lr; the served logits and tokens under the tie rule, 0 lost."""
    out = {}
    for key in ranks[0]["lm"]:
        rows = [r["lm"][key] for r in ranks]
        tr = [r["train"] for r in rows]
        h = tr[0]
        err = abs(h["losses"][0] - first_loss) / abs(first_loss)
        print(f"[mesh lm] train {ZAMBA} {key} (2 ranks on one card, "
              f"hostgloo; bf16, remat {TRAIN_REMAT}, B={TRAIN_B} x "
              f"{TRAIN_T}): losses "
              + ", ".join(f"{x:.6f}" for x in h["losses"])
              + "; grad norms " + ", ".join(f"{x:.4f}" for x in
                                            h["grad_norms"])
              + f"; first loss {err:.3e} of |loss| off the one-rank "
              f"{first_loss:.6f}; step ms " + "; ".join(
                  f"rank {i} " + ", ".join(f"{x:.1f}" for x in t["step_ms"])
                  for i, t in enumerate(tr))
              + "; peak GiB " + ", ".join(f"{t['peak_gib']:.2f}" for t in tr)
              + "; conv1d launches a rank " + ", ".join(
                  f"{t['launches']} ({t['launches_per_step']} a step)"
                  for t in tr)
              + "; collectives a rank over the two steps " + ", ".join(
                  f"{t['collectives']} ({t['collective_s']:.1f} s)"
                  for t in tr))
        print(f"[mesh lm] train {key} restart: checkpoint after step 1, a "
              f"fresh mesh Trainer restores and runs step 2 in "
              + ", ".join(f"{t['restart_s']:.1f}" for t in tr)
              + " s a rank; leaves that differ from the uninterrupted run "
              + ", ".join(str(t["restart_leaves_differ"]) for t in tr)
              + f"; losses {h['restart_losses']}")
        check(all(t["launches"] > 0 for t in tr), f"mesh lm {key}: a rank "
              "launched no conv1d kernel in training")
        check(all(math.isfinite(x) for x in h["losses"] + h["grad_norms"]),
              f"mesh lm {key}: a non-finite loss or grad norm")
        check(err <= TOL_MESH_LOSS, f"mesh lm {key}: first loss "
              f"{h['losses'][0]} vs one rank {first_loss}")
        check(all(t["restart_leaves_differ"] == 0 for t in tr)
              and h["restart_losses"] == h["losses"],
              f"mesh lm {key}: the restart is not bitwise the uninterrupted "
              "run")
        cut = [r["cut"] for r in rows]
        c = cut[0]
        print(f"[mesh lm] fp32 {ZAMBA} at depth {c['depth']} of "
              f"{c['layers_full']} (two repeats of its layer pattern; full "
              f"width), B={MESH_CUT_B} x {MESH_CUT_T}, two steps on {key}: "
              "losses " + ", ".join(f"{x:.7f}" for x in c["loss"])
              + " against one rank's " + ", ".join(
                  f"{x:.7f}" for x in c["loss_one_rank"])
              + f" ({c['loss_rel_err']:.3e} of |loss| at most); after step "
              "1 the first moment within " + ", ".join(
                  f"{x['mu_rel_err']:.3e}" for x in cut)
              + " of each leaf's max|mu|, new parameters within " + ", ".join(
                  f"{x['param_err_over_2lr']:.3e}" for x in cut)
              + " of 2·lr and " + ", ".join(
                  f"{x['param_err_over_tol']:.3e}" for x in cut)
              + " of the bound that moment's error allows; step 1 ms "
              + ", ".join(f"{x['ms']:.1f}" for x in cut)
              + "; conv1d launches a rank in step 1 " + ", ".join(
                  str(x["launches"]) for x in cut))
        check(all(x["loss_rel_err"] <= TOL_MESH_FP32
                  and x["mu_rel_err"] <= TOL_MESH_MU
                  and x["param_err_over_tol"] <= 1.0
                  and x["param_err_over_2lr"] <= 1.0 for x in cut),
              f"mesh lm {key}: the fp32 steps are off the one-rank steps")
        check(all(x["launches"] > 0 for x in cut), f"mesh lm {key}: a rank "
              "launched no conv1d kernel in the fp32 step")
        for dtype, ref in serve_refs.items():
            sv = [r["serve"][dtype] for r in rows]
            d = sv[0]
            ties = d.get("ties", [])
            print(f"[mesh lm] serve {ZAMBA} {dtype} {key} ({d['decode']}): "
                  f"{d['requests_done']}/{d['requests']} requests, "
                  f"{d['requests_lost']} lost, {d['tokens']} tokens; "
                  f"decode step {d['decode_step_ms']:.3f} ms, "
                  f"{d['tokens_per_s']:.3f} tokens/s (one rank: "
                  f"{ref['decode_step_ms']:.3f} ms, {ref['tokens_per_s']:.3f}"
                  f" tokens/s); {d['collectives']} collectives on rank 0 "
                  f"({d['collective_s']:.1f} s); logits within "
                  f"{d['max_err']:.3e} of the "
                  + ("one-rank engine's max|logits| over every call"
                     if dtype == "float32" else
                     "one-rank engine's max(1, max|logits|) at the first "
                     "call")
                  + (f"; ties {ties}; rows whose next token differs "
                     f"{d['differ']}" if dtype == "float32" else ""))
            check(all(x["requests_lost"] == 0
                      and x["calls"] == x["calls_one_rank"] for x in sv),
                  f"mesh lm serve {dtype} {key}: lost requests or another "
                  "call sequence")
            if dtype == "float32":
                check(all(x["max_err"] <= TOL_MESH_FP32 and not x["differ"]
                          for x in sv), f"mesh lm serve fp32 {key}: logits "
                      "or tokens off the one-rank engine's")
            else:
                check(all(x["max_err"] <= TOL_MESH_BF16 for x in sv),
                      f"mesh lm serve bf16 {key}: first logits off")
        out[key] = {"seconds": [r["seconds"] for r in rows]}
    return out


# --------------------------------------------------------------------------
# [elastic]: the elastic restart (examples/torch_elastic_restart.py)
# --------------------------------------------------------------------------

ELASTIC_EXAMPLE = ROOT / "examples" / "torch_elastic_restart.py"
ELASTIC_EXAMPLE_TIMEOUT_S = 300
# the JAX demo's lines (examples/elastic_restart.py), word for word
ELASTIC_LINES = ("heartbeat monitor: dead ranks = [217]",
                 "elastic plan: mesh (16, 16) (256 of 508 devices, 252 "
                 "idle), per-device batch 16 x accum 1",
                 "OK: survived the failure with exact data-cursor resume")
ELASTIC_LOSS_LINE = " across failure + re-mesh + restart"
ELASTIC_FROM = "2x1"                # the two-rank run whose rank 1 dies
ELASTIC_DEAD = 1
ELASTIC_MAX_PER_DEVICE = 2          # the survivor's rows a microbatch
ELASTIC_TIMEOUT_STEPS = 3           # the monitor's timeout: slowest steps
# the survivor's first moment after step 2 against the two ranks', of
# each leaf's max|mu|, and the error it allows the parameters
# (``cut_param_tol`` with dmu = TOL_ELASTIC_MU·max|mu|): bf16 at full
# width, where the same step from the same weights parts by far more
# than the fp32 cut step's TOL_MESH_MU.  [elastic] prints the scale: one
# rank's whole-batch step from the same state (0.23 on an H100,
# PERF.md), against the survivor's, whose two microbatches have the
# ranks' shapes (2.95e-2)
TOL_ELASTIC_MU = 5e-2


def elastic_example():
    """``examples/torch_elastic_restart.py`` as a module: its phases."""
    sys.path.insert(0, str(ELASTIC_EXAMPLE.parent))
    return importlib.import_module(ELASTIC_EXAMPLE.stem)


def phase_elastic_example(args=()):
    """(a) The example at its defaults (the card) in a process of its
    own: rc 0, the JAX demo's dead-rank, plan and ``OK`` lines and one
    loss line whose loss fell.  Returns its lines and seconds."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ELASTIC_EXAMPLE), *args],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=ELASTIC_EXAMPLE_TIMEOUT_S,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"elastic example: rc {out.returncode}: "
          f"{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    loss = [ln for ln in lines if ln.startswith("loss ")
            and ln.endswith(ELASTIC_LOSS_LINE)]
    check(len(loss) == 1, f"elastic example: loss lines {loss}")
    first, last = (float(x) for x in loss[0].split()[1:4:2])
    for want in ELASTIC_LINES:
        check(want in lines, f"elastic example: no line {want!r}")
    check(last < first, f"elastic example: loss {first} -> {last}")
    shown = [ln for ln in lines if ln in ELASTIC_LINES[:2]] + loss + \
        [ELASTIC_LINES[2]]
    for ln in shown:
        print(f"[elastic] (a) {ln}")
    print(f"[elastic] (a) examples/torch_elastic_restart.py on the card "
          f"(reduced qwen3-4b, 8 x 48, 30 + 30 steps): rc 0 in "
          f"{seconds:.1f} s")
    return {"lines": shown, "seconds": seconds, "first_loss": first,
            "last_loss": last}


def elastic_beats(runs):
    """The two-rank run's beats, (seconds, rank, step): each rank beats
    after each of its steps, on the clock of its summed step times."""
    beats = []
    for rank, tr in enumerate(runs):
        t = 0.0
        for i, ms in enumerate(tr["step_ms"]):
            t += ms / 1e3
            beats.append((t, rank, i + 1))
    return beats


def elastic_param_bound(torch, got, want, mu, adam):
    """(the worst error over its bound of a new fp32 master leaf against
    the two-rank run's, the worst over that bound plus one bf16 step of
    |p| for its bf16 parameter, whether that parameter is bitwise, the
    master's worst error over the fp32 cut step's bound): ``got`` and
    ``want`` are (master, parameter) pairs, ``mu`` the two-rank run's
    first moment.  The bound is ``cut_param_tol``'s, ``1e-6 + 1e-5·|p| +
    2·lr·dg/(|g| + eps)``, the first moment's error ``TOL_ELASTIC_MU``
    of the leaf's max|mu| (the fp32 cut step's: ``TOL_MESH_MU``)."""
    top = max(float(mu.abs().max()), 1e-30)
    strict = cut_param_tol(torch, want[0], mu, TOL_MESH_MU * top, adam)
    tol = cut_param_tol(torch, want[0], mu, TOL_ELASTIC_MU * top, adam)
    err = (got[0] - want[0]).abs()
    p, q = got[1].float(), want[1].float()
    param = float(((p - q).abs() / (tol + BF16_STEP * q.abs())).max())
    return (float((err / tol).max()), param,
            bool(torch.equal(got[1], want[1])), float((err / strict).max()))


def phase_elastic_restart(torch, dev, out_dir, ranks, smi):
    """(b) Rank 1 of the [mesh lm] ``ELASTIC_FROM`` run dies after step
    2: ``HeartbeatMonitor`` (the example's phase 2) gets both ranks' beats
    of that run, then rank 1 stops beating; ``solve_elastic_mesh`` plans
    the one survivor (TP 1, the global batch of 4 as 2 x 2); with both
    rank processes gone, this process's ``restart_trainer`` (the
    example's phase 4) builds ``make_local_mesh(1, 1)`` and a fresh
    ``Trainer`` with ``n_micro = grad_accum`` that restores the two
    ranks' step-1 checkpoint and runs step 2.  The two ranks' step-2
    checkpoint, the reference, is read into host memory first and
    removed (the disk never holds more than two of them at once).  For
    the scale of bf16's spread, one rank's whole-batch step runs first
    from the same restored state (neither timed nor counted).
    Held against the two-rank run's step 2: the loss within
    ``TOL_MESH_FP32·|loss|`` of its fresh mesh Trainer's; the first
    moment within ``TOL_ELASTIC_MU`` of each leaf's max|mu| of its
    checkpoint, each fp32 master weight within ``elastic_param_bound``
    and each bf16 parameter within that plus one bf16 step, and the
    first moment nearer to the ranks' than the whole-batch step's; the
    AdamW step 2; every parameter and moment finite; the step's kernel
    launches, counted from 0 just before it, the conv1d kernel's
    ``grad_accum`` x [train]'s a step and no other kernel's."""
    import shutil
    from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint
    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.kernels import dense as dn
    from repro_torch.models import api
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves, leaves_with_path, tree_map
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    af = importlib.import_module("repro_torch.kernels.attention_fold")
    counted = (cw, dn, cc, af)
    ex = elastic_example()
    cfg, data, opt = train_setup()
    runs = [r["lm"][ELASTIC_FROM]["train"] for r in ranks]
    # the control plane, sized to the card: a timeout of a few steps
    slowest = max(ms for tr in runs for ms in tr["step_ms"]) / 1e3
    timeout = ELASTIC_TIMEOUT_STEPS * slowest
    dead = ex.phase_control_plane(n_ranks=len(runs), dead_rank=ELASTIC_DEAD,
                                  step=MESH_TRAIN_STEPS, timeout_s=timeout,
                                  beats=elastic_beats(runs))
    print(f"[elastic] (b) heartbeat monitor over the {ELASTIC_FROM} run's "
          f"beats ({len(runs)} ranks, timeout {timeout:.1f} s = "
          f"{ELASTIC_TIMEOUT_STEPS} of its slowest steps), rank "
          f"{ELASTIC_DEAD} silent after step {MESH_TRAIN_STEPS}: dead ranks "
          f"= {dead}")
    check(dead == [ELASTIC_DEAD], f"elastic: dead ranks {dead}")
    plan = ex.replan(available=len(runs) - 1, model_parallel=1,
                     global_batch=data.global_batch,
                     max_per_device_batch=ELASTIC_MAX_PER_DEVICE)
    print(f"[elastic] (b) {ex.plan_line(plan, available=len(runs) - 1)}")
    check(plan.mesh_shape == (1, 1) and plan.per_device_batch == 2
          and plan.grad_accum == 2, f"elastic: plan {plan}")
    # the reference into host memory, its files off the disk: the
    # survivor restores the newest checkpoint left, step 1
    src = out_dir / f"ckpt_{ELASTIC_FROM}"
    check(latest_step(str(src)) == MESH_TRAIN_STEPS, "elastic: the "
          f"{ELASTIC_FROM} run left no step-{MESH_TRAIN_STEPS} checkpoint")
    zeros = tree_map(lambda t: 0, api.init_params(cfg, abstract=True))
    t0 = time.perf_counter()
    ref = restore_checkpoint(str(src), {"params": zeros, "opt": {
        "master": zeros, "mu": zeros, "step": 0}}, step=MESH_TRAIN_STEPS)[0]
    ref_s = time.perf_counter() - t0
    shutil.rmtree(src / f"step_{MESH_TRAIN_STEPS:09d}")
    check(latest_step(str(src)) == MESH_TRAIN_STEPS - 1,
          "elastic: no step-1 checkpoint of the two ranks")
    _free(torch)
    tr = ex.restart_trainer(plan, cfg, data, opt, str(src), dev,
                            total_steps=MESH_TRAIN_STEPS, ckpt_every=1,
                            log_every=1, mesh=True, seed=TRAIN_SEED,
                            remat=TRAIN_REMAT)
    step, rec = tr.step_fn, {}

    def timed(params, opt_state, batch):
        torch.cuda.synchronize(dev)
        rec["restore_s"] = time.perf_counter() - t0
        # the scale of bf16's spread: one rank's whole-batch step from the
        # same state (its moments and masters kept on the host)
        whole = make_train_step(cfg, opt, remat=TRAIN_REMAT)(
            params, opt_state, batch)[1]
        rec["whole"] = {k: [t.cpu() for t in leaves(whole[k])]
                        for k in ("mu", "master")}
        del whole
        _free(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        for mod in counted:
            mod.reset_launch_counts()
        t1 = time.perf_counter()
        out = step(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        rec["ms"] = 1e3 * (time.perf_counter() - t1)
        rec["launches"] = {k: n for mod in counted
                           for k, n in mod.launch_counts().items() if n}
        return out
    tr.step_fn = timed
    # the two ranks' algorithms: the step repeats bit for bit
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        p, o = tr.run()
        run_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    h = tr.history[0]
    want_loss = runs[0]["restart_losses"][-1]
    loss_err = abs(h["loss"] - want_loss) / abs(want_loss)
    worst = dict.fromkeys(("master", "param", "strict", "mu",
                           "whole_master", "whole_mu"), 0.0)
    where = {}
    bitwise = 0

    def mu_err(got, want):
        return float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
    for (path, a), b, am, bm, mu, bmu, wm, wmu in zip(
            leaves_with_path(p), leaves(ref["params"]), leaves(o["master"]),
            leaves(ref["opt"]["master"]), leaves(o["mu"]),
            leaves(ref["opt"]["mu"]), rec["whole"]["master"],
            rec["whole"]["mu"]):
        bm, b, bmu = bm.to(dev), b.to(dev), bmu.to(dev)
        m, q, same, st = elastic_param_bound(torch, (am, a), (bm, b), bmu,
                                             opt)
        wm = elastic_param_bound(torch, (wm.to(dev), a), (bm, b), bmu,
                                 opt)[0]
        for k, v in (("master", m), ("param", q), ("strict", st),
                     ("mu", mu_err(mu, bmu)), ("whole_master", wm),
                     ("whole_mu", mu_err(wmu.to(dev), bmu))):
            if v > worst[k]:
                worst[k], where[k] = v, "/".join(map(str, path))
        bitwise += same
    n_leaves = len(leaves(p))
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in leaves((p, o["mu"], o["nu"], o["master"])))
    adam_step = int(o["step"])
    ref_step = int(ref["opt"]["step"])
    del p, o, ref
    _free(torch)
    want = plan.grad_accum * train_conv1d_launches(cfg)
    n = rec["launches"].get(cc.KERNEL, 0)
    out = {"dead": dead, "timeout_s": timeout,
           "plan": {"mesh_shape": list(plan.mesh_shape),
                    "per_device_batch": plan.per_device_batch,
                    "grad_accum": plan.grad_accum},
           "restore_s": rec["restore_s"], "step_ms": rec["ms"],
           "save_s": run_s - rec["restore_s"] - rec["ms"] / 1e3,
           "reference_read_s": ref_s, "peak_gib": peak, "loss": h["loss"],
           "loss_two_ranks": want_loss, "loss_rel_err": loss_err,
           "grad_norm": h["grad_norm"],
           "grad_norm_two_ranks": runs[0]["grad_norms"][-1],
           "master_err_over_tol": worst["master"],
           "param_err_over_tol": worst["param"],
           "master_err_over_pr30_tol": worst["strict"],
           "mu_rel_err": worst["mu"],
           "whole_batch_mu_rel_err": worst["whole_mu"],
           "whole_batch_master_err_over_tol": worst["whole_master"],
           "worst_leaves": where,
           "params_bitwise": bitwise,
           "leaves": n_leaves, "finite": finite, "adam_step": adam_step,
           "launches": rec["launches"], "conv1d_launches": n}
    print(f"[elastic] (b) survivor restart of {ZAMBA} (bf16, remat "
          f"{TRAIN_REMAT}, B={TRAIN_B} x {TRAIN_T} as {plan.grad_accum} x "
          f"{plan.per_device_batch}) on make_local_mesh(1, 1) from the "
          f"{ELASTIC_FROM} run's step-1 checkpoint: restore "
          f"{rec['restore_s']:.2f} s, step 2 {rec['ms']:.1f} ms, its "
          f"checkpoint {out['save_s']:.2f} s, peak {peak:.2f} GiB; {smi}")
    print(f"[elastic] (b) step-2 loss {h['loss']:.6f} against the two "
          f"ranks' {want_loss:.6f} ({loss_err:.3e} of |loss|), grad norm "
          f"{h['grad_norm']:.5f} against {out['grad_norm_two_ranks']:.5f}; "
          f"against their step-2 checkpoint (read in {ref_s:.2f} s, step "
          f"{ref_step}): first moment within {worst['mu']:.3e} of each "
          f"leaf's max|mu|, fp32 master within {worst['master']:.3e} of "
          f"the bound ({worst['strict']:.3e} of the fp32 one; worst "
          f"leaves {where}), bf16 "
          f"parameters within {worst['param']:.3e} of it plus one bf16 "
          f"step ({bitwise} of {n_leaves} leaves bitwise); one rank's "
          f"whole-batch step from the same state: first moment within "
          f"{worst['whole_mu']:.3e}, masters {worst['whole_master']:.3e} "
          f"of the bound; AdamW step "
          f"{adam_step}; every parameter and moment finite: {finite}; "
          f"kernel launches in the step {rec['launches']} ({n} conv1d, "
          f"{want} expected: {cfg.n_layers} forward + {cfg.n_layers} "
          f"recomputed + {cfg.n_layers} dx a microbatch)")
    check(loss_err <= TOL_MESH_FP32, f"elastic: step-2 loss {h['loss']} "
          f"vs the two ranks' {want_loss}")
    check(worst["mu"] <= TOL_ELASTIC_MU, f"elastic: the survivor's first "
          f"moment is {worst['mu']} of max|mu| off the two ranks'")
    check(worst["mu"] < worst["whole_mu"], "elastic: the survivor's step, "
          "split as the ranks split the batch, is no nearer to theirs than "
          "one rank's whole-batch step")
    check(worst["master"] <= 1.0 and worst["param"] <= 1.0, "elastic: the "
          "survivor's parameters are off the two ranks' step 2")
    check(adam_step == MESH_TRAIN_STEPS and ref_step == MESH_TRAIN_STEPS,
          f"elastic: AdamW step {adam_step}, reference {ref_step}")
    check(finite, "elastic: a non-finite parameter or moment")
    check(n > 0 or not want, "elastic: the conv1d kernel never launched "
          "in the step")
    check(rec["launches"] == ({cc.KERNEL: want} if want else {}),
          f"elastic: kernel launches {rec['launches']}, {want} conv1d "
          "expected and no other kernel")
    return out


# --------------------------------------------------------------------------
# the dry-run and the H100 roofline: planning, on the host's cores
# --------------------------------------------------------------------------

DRYRUN_CELLS = (("zamba2-1.2b", "train_4k", False),
                ("llama3-8b", "decode_32k", True))
DRYRUN_TIMEOUT_S = 900


def start_dryrun(out_dir):
    """Start ``launch/dryrun.run_cell`` on two production cells, each in a
    subprocess of its own (its fake process group of 256 or 512 ranks
    never meets this process's groups; no card visible to it): (the
    start time, the processes by cell).  They run on the host's cores
    beside the card's phases that follow (the two-rank mesh phases);
    ``phase_dryrun`` collects them."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = {}
    for arch, shape, multi_pod in DRYRUN_CELLS:
        tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
        code = ("import sys, pathlib\n"
                "from repro_torch.launch.dryrun import run_cell\n"
                f"r = run_cell({arch!r}, {shape!r}, {multi_pod!r}, "
                f"pathlib.Path({str(out_dir)!r}))\n"
                "sys.exit(0 if r.get('ok') else 1)\n")
        procs[tag] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return t0, procs


def stop_dryrun(started) -> None:
    """Kill what is left of ``start_dryrun``'s processes."""
    for proc in started[1].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_dryrun(out_dir, started):
    """Wait for ``start_dryrun``'s cells under ``DRYRUN_TIMEOUT_S``: per
    cell the per-device GiB, the three roofline terms, the dominant one,
    the collectives and the seconds it took.  A cell that is not ``ok``
    fails the run."""
    t0, procs = started
    ended, logs = {}, {}
    try:
        while len(ended) < len(procs):
            for tag, proc in procs.items():
                if tag not in ended and proc.poll() is not None:
                    ended[tag] = time.perf_counter() - t0
                    logs[tag] = proc.stdout.read()
            check(time.perf_counter() - t0 < DRYRUN_TIMEOUT_S,
                  "dryrun: a cell ran past its time limit")
            time.sleep(0.2)
    finally:
        stop_dryrun(started)
    out = {}
    for tag, proc in procs.items():
        path = out_dir / f"{tag}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        check(proc.returncode == 0 and rec.get("ok") is True,
              f"dryrun {tag}: {rec.get('error') or logs[tag][-2000:]}")
        m, rl = rec["memory"], rec["roofline"]
        counts = {k: int(v) for k, v in rl["collectives"]["count"].items()}
        print(f"[dryrun] {tag}: {ended[tag]:.1f} s (trace "
              f"{rec['compile_s']:.1f} s at depths {rec['traced_depths']}, "
              f"{rec['ops_counted']:.0f} ops counted); per device: "
              f"arguments {m['argument_bytes'] / 2**30:.3f} GiB, outputs "
              f"{m['output_bytes'] / 2**30:.3f}, donated "
              f"{m['alias_bytes'] / 2**30:.3f}, temp (estimate) "
              f"{m['temp_bytes'] / 2**30:.3f}, total "
              f"{m['total_per_device'] / 2**30:.3f} GiB; t_compute "
              f"{rl['t_compute_s'] * 1e3:.4f} ms, t_memory "
              f"{rl['t_memory_s'] * 1e3:.4f} ms, t_collective "
              f"{rl['t_collective_s'] * 1e3:.4f} ms, dominant "
              f"{rl['dominant']}; useful flops ratio "
              f"{rl['useful_flops_ratio']:.4f}, roofline fraction "
              f"{rl['roofline_fraction']:.4f}; collectives {counts}")
        out[tag] = {"seconds": ended[tag], "record": rec}
    return out


def roofline_line(torch, what, cost, model_flops, step_ms, smi,
                  device_ms=None):
    """One ``[roofline]`` line: the traced step's terms on the H100 beside
    the step's measured ms, and its MFU."""
    from repro_torch.roofline import H100_SXM, roofline_terms
    rep = roofline_terms(cost, chips=1, model_flops=model_flops)
    mfu = model_flops / (step_ms / 1e3 * H100_SXM.peak_flops)
    row = {"t_compute_ms": rep.t_compute * 1e3,
           "t_memory_ms": rep.t_memory * 1e3,
           "bound_ms": rep.bound_time * 1e3, "dominant": rep.dominant,
           "roofline_fraction": rep.roofline_fraction,
           "useful_flops_ratio": rep.useful_flops_ratio,
           "flops": cost.flops, "bytes_hbm": cost.bytes_hbm,
           "model_flops": model_flops, "step_ms": step_ms,
           "device_ms": device_ms,
           "bound_over_step": rep.bound_time * 1e3 / step_ms, "mfu": mfu}
    dev = ("" if device_ms is None else
           f" (device work {device_ms:.3f} ms, bound over it "
           f"{row['bound_ms'] / device_ms:.4f})")
    print(f"[roofline] {what}: t_compute {row['t_compute_ms']:.4f} ms, "
          f"t_memory {row['t_memory_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({rep.dominant}), roofline fraction "
          f"{rep.roofline_fraction:.4f}, useful flops ratio "
          f"{rep.useful_flops_ratio:.4f}; measured step {step_ms:.3f} ms"
          f"{dev}: the bound is {row['bound_over_step']:.4f} of it, mfu "
          f"{mfu:.5f}; {smi}")
    return row


def phase_roofline(torch, train_step_ms, decode_step_ms, decode_device_ms,
                   smi):
    """``op_cost.analyze_step`` over [train]'s own step (zamba2-1.2b at its
    published config, B x T of ``TRAIN_B`` x ``TRAIN_T``, remat
    ``TRAIN_REMAT``, AdamW, one card, no mesh) and [dense lm]'s captured
    decode step (gemma3-12b, B=4, ``window_cache``, a 64-slot cache at
    position 16), each traced on ``meta`` tensors of the same shapes:
    nothing runs on the card.  Beside each, the step ms the phase
    measured in this run and MFU = model flops / (step s x peak)."""
    import dataclasses
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import model_flops_for
    from repro_torch.models import api
    from repro_torch.op_cost import analyze_step
    from repro_torch.optim.adamw import abstract_opt_state
    from repro_torch.serve.steps import make_decode_step
    from repro_torch.train.steps import make_train_step
    out = {}
    tcfg, _, topt = train_setup()
    params = api.init_params(tcfg, abstract=True)
    batch = {k: torch.empty((TRAIN_B, TRAIN_T), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    cost = analyze_step(make_train_step(tcfg, topt, remat=TRAIN_REMAT),
                        params, abstract_opt_state(params), batch)
    out["train"] = roofline_line(
        torch, f"{ZAMBA} train step B={TRAIN_B} x {TRAIN_T}, remat "
        f"{TRAIN_REMAT}, 1 chip (traced in "
        f"{time.perf_counter() - t0:.1f} s)", cost,
        model_flops_for(tcfg, ShapeSpec("train", TRAIN_T, TRAIN_B,
                                         "train")), train_step_ms, smi)
    wcfg = dataclasses.replace(dense_cfg(DENSE_SERVED), window_cache=True)
    params = api.init_params(wcfg, abstract=True)
    t0 = time.perf_counter()
    cost = analyze_step(make_decode_step(wcfg, donate=True), params,
                        torch.empty(4, dtype=torch.long, device="meta"),
                        api.init_cache(wcfg, 4, 64, abstract=True), 16)
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    out["decode"] = roofline_line(
        torch, f"{DENSE_SERVED} decode step B=4, window cache, captured "
        f"(traced in {time.perf_counter() - t0:.1f} s; HBM bytes "
        f"{cost.bytes_hbm / weights:.4f}x its {weights / 2**30:.2f} GiB of "
        "weights)", cost,
        model_flops_for(wcfg, ShapeSpec("decode", 64, 4, "decode")),
        decode_step_ms, smi, device_ms=decode_device_ms)
    out["decode"]["hbm_over_weights"] = cost.bytes_hbm / weights
    return out


def main() -> int:
    # cuBLAS's deterministic workspace, read when cuBLAS is first set up:
    # the training phase's bitwise checks run under
    # torch.use_deterministic_algorithms, which asks for it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    set_numerics(torch)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    report = {"nvidia_smi": smi_line()}

    report["env"] = phase_environment(torch)
    errs, cases, dw_cases = phase_kernels(torch, dev)
    dw_err, report["dw_strips_fp32"] = phase_dw_strips(torch, dev, dw_cases,
                                                       torch.float32)
    errs["fold_conv_dw"] = max(errs["fold_conv_dw"], dw_err)
    errs.update(phase_int8_kernels(torch, dev, cases, dw_cases))
    dw_err, report["dw_strips_int8"] = phase_dw_strips(torch, dev, dw_cases,
                                                       torch.int8)
    errs["fold_conv_dw_i8"] = max(errs["fold_conv_dw_i8"], dw_err)

    from repro_torch.kernels import conv2d_ws as cw
    from repro_torch.kernels import dense as dn
    errs[dn.KERNEL], report["dense_checksums"] = phase_dense(torch, dev)
    dense_rows = {b: time_dense(torch, dev, b, 10) for b in (1, 4)}
    for b, rows in dense_rows.items():
        t = summarize(rows, "ms")
        print(f"[kernels] dense VGG-16 head at 224 (fc1-fc3), batch {b}: "
              + ", ".join(f"{r['layer'].split()[-1]} {r['ms']:.4f} ms "
                          f"(torch.addmm {r['library_ms']:.4f}, bound "
                          f"{r['bound_ms']:.4f})" for r in rows)
              + f"; sum kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f},"
              f" torch.addmm {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']}), before the redesign "
              f"{BEFORE_REDESIGN[f'dense_b{b}']}")
    report["dense_vgg16_224"] = dense_rows
    from repro_torch.models import vgg
    ws_layers = vgg_layer_specs(224, 1)
    os_layers = [row for row in vgg_layer_specs(32, 4)
                 if row[1].dataflow == "output_stationary"]
    check(len(os_layers) == 11, "expected 11 OS layers at 32x32")
    rows224 = time_layers(torch, dev, ws_layers,
                          ("weight_stationary", "output_stationary"), 5)
    rows32 = time_layers(torch, dev, vgg_layer_specs(32, 4),
                         ("output_stationary",), 10)
    rows32_os = [r for r in rows32
                 if r["layer"] in {row[0] for row in os_layers}]
    print("[kernels] VGG-16 layers at 224, batch 1 (ms):")
    for r in rows224:
        print(f"  {r['layer']:<8} c={r['c']:<4} nf={r['nf']:<4} h={r['h']:<4}"
              f" ws={r['weight_stationary_ms']:.4f} "
              f"os={r['output_stationary_ms']:.4f} "
              f"plain={r['plain_ms']:.4f} F.conv2d={r['library_ms']:.4f} "
              f"bound={r['bound_ms']:.4f}")
    report["layers_224_b1"] = rows224
    report["layers_32_b4"] = rows32
    zoo_rows = {m: time_model_layers(torch, dev, model_layers(m, 32, 4), 10)
                for m in ("mobilenetv2", "resnet18")}
    for m, rows in zoo_rows.items():
        print(f"[kernels] {m} layers at 32, batch 4 (ms):")
        for r in rows:
            print(f"  {r['layer']:<9} {r['rs']}/s{r['stride']} "
                  f"c={r['c']:<4} nf={r['nf']:<4} h={r['h']:<3} "
                  f"{r['dataflow']:<18} {r['epilogue']:<20} "
                  f"kernel={r['ms']:.4f} call={r['call_ms']:.4f} "
                  f"plain={r['plain_ms']:.4f} "
                  f"F.conv2d={r['library_ms']:.4f} "
                  f"bound={r['bound_ms']:.4f}")
        for df in ("weight_stationary", "output_stationary", "depthwise"):
            sel = [r for r in rows if r["dataflow"] == df]
            if sel:
                t = summarize(sel, "ms")
                calls = sum(r["call_ms"] for r in sel)
                before = ("" if df != "depthwise" else
                          f", before the redesign "
                          f"{BEFORE_REDESIGN['fold_conv_dw']}")
                print(f"[kernels] {m} {df}: {len(sel)} layers, kernel "
                      f"{t['ms']:.4f} ms (eager call {calls:.4f}), plain "
                      f"{t['plain_ms']:.4f}, "
                      f"F.conv2d {t['library_ms']:.4f}, bound "
                      f"{t['bound_ms']:.4f} ({t['bound_by']}){before}")
        report[f"layers_{m}_32_b4"] = rows
    # grouped 1 < G < C at a public model's full width: ResNeXt-50 32x4d
    rx = resnext_layer()
    report["grouped_resnext50"] = {
        "fp32": time_model_layers(torch, dev, [rx], 10),
        "int8": time_int8_layers(torch, dev, [rx], 10)}
    r, r8 = (report["grouped_resnext50"][k][0] for k in ("fp32", "int8"))
    print(f"[kernels] grouped {r['layer']} (C=NF=128, G=32, 56x56, b1, "
          f"{r['dataflow']}): kernel {r['ms']:.4f} ms (eager call "
          f"{r['call_ms']:.4f}), plain {r['plain_ms']:.4f}, "
          f"F.conv2d(groups=32) {r['library_ms']:.4f}, bound "
          f"{r['bound_ms']:.5f}; int8 kernel {r8['ms']:.4f}, bound "
          f"{r8['bound_ms']:.6f}")
    dw_rows = [r for r in zoo_rows["mobilenetv2"]
               if r["dataflow"] == "depthwise"]
    check(len(dw_rows) == 17, "expected 17 depthwise layers in MobileNetV2")

    # -- the main path: counts from 0 just before, read just after --------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = vgg.init_params(gen, img=224, device=dev)
    cw.reset_launch_counts()
    dn.reset_launch_counts()
    report["model224"] = phase_model_224(torch, dev, params)
    phase_model_32(torch, dev)
    report["serving"] = phase_serving(torch, dev, params, jit=True)
    report["serving_eager"] = phase_serving(torch, dev, params, jit=False)
    report["mobilenetv2"] = phase_mobilenet(torch, dev)
    report["resnet18"] = phase_resnet(torch, dev)
    report["serving_mobilenetv2"] = phase_serving_mobilenet(torch, dev, True)
    report["serving_mobilenetv2_eager"] = phase_serving_mobilenet(
        torch, dev, False)
    launches = cw.launch_counts()
    launches[dn.KERNEL] = dn.launch_counts()[dn.KERNEL]
    print(f"[main path] launches {launches}")
    for name in ("fold_conv_ws", "fold_conv_os", "fold_conv_dw", dn.KERNEL):
        check(launches[name] > 0, f"{name} never launched on the main path")

    # -- the planning side, then the per-layer VGG-16 path: counts from 0
    # just before the path, read just after --------------------------------
    report["simulator"] = phase_simulator(torch, dev)
    cw.reset_launch_counts()
    dn.reset_launch_counts()
    t_pl = time.perf_counter()
    report["vgg_per_layer"] = phase_vgg_per_layer(torch, dev, params)
    per_layer = cw.launch_counts()
    per_layer[dn.KERNEL] = dn.launch_counts()[dn.KERNEL]
    report["vgg_per_layer"]["seconds"] = time.perf_counter() - t_pl
    print(f"[vgg per-layer path] launches "
          f"{ {k: v for k, v in per_layer.items() if v} }, "
          f"{report['vgg_per_layer']['seconds']:.1f} s")
    for name in ("fold_conv_ws", "fold_conv_os", dn.KERNEL):
        check(per_layer[name] > 0,
              f"{name} never launched on the per-layer VGG-16 path")

    # -- the int8 main path: counts from 0 just before, read just after ---
    cw.reset_launch_counts()
    dn.reset_launch_counts()
    report["int8"] = phase_int8_models(torch, dev, params)
    served_int8 = phase_int8_serving(torch, dev)
    report["serving_int8_mobilenetv2"] = served_int8["jit"]
    report["serving_int8_mobilenetv2_eager"] = served_int8["eager"]
    int8_launches = cw.launch_counts()
    print(f"[int8 main path] launches {int8_launches}, head "
          f"{dn.launch_counts()[dn.KERNEL]}")
    check(dn.launch_counts()[dn.KERNEL] > 0,
          "the head kernel never launched on the int8 main path")
    for name in ("fold_conv_ws_i8", "fold_conv_os_i8", "fold_conv_dw_i8"):
        check(int8_launches[name] > 0,
              f"{name} never launched on the int8 main path")
    launches.update({k: v for k, v in int8_launches.items()
                     if k.endswith("_i8")})

    # -- the psum path: counts from 0 just before, read just after --------
    cw.reset_launch_counts()
    report["psum"] = phase_psum(torch, dev, ws_layers)
    launches["fold_conv_psum"] = cw.launch_counts()["fold_conv_psum"]
    errs["fold_conv_psum"] = max(errs["fold_conv_psum"],
                                 report["psum"]["max_abs_err_vs_plain"])
    print(f"[psum path] launches {cw.launch_counts()}")
    check(launches["fold_conv_psum"] == 14,
          "expected 14 psum launches: 13 VGG layers and the WS spill")

    # -- bf16: each instance against its plain version, and its times (not
    # a main path) -------------------------------------------------------
    bf = torch.bfloat16
    t_bf16 = time.perf_counter()
    errs.update(phase_bf16_kernels(torch, dev, cases, dw_cases))
    dw_err, report["dw_strips_bf16"] = phase_dw_strips(torch, dev, dw_cases,
                                                       bf)
    errs["fold_conv_dw_bf16"] = max(errs["fold_conv_dw_bf16"], dw_err)
    for name, e in phase_bf16_tc_tiles(torch, dev).items():
        errs[name] = max(errs[name], e)
    errs["fold_conv_os_bf16"] = max(errs["fold_conv_os_bf16"],
                                    phase_bf16_os(torch, dev, cases))
    errs[dn.KERNEL_BF16], _ = phase_dense(torch, dev, bf)
    bf16_rows224 = time_layers(torch, dev, ws_layers,
                               ("weight_stationary",), 5, dtype=bf)
    errs["fold_conv_ws_bf16"] = max(
        [errs["fold_conv_ws_bf16"]]
        + [r["weight_stationary_max_abs_err"] for r in bf16_rows224])
    bf16_mb_rows = time_model_layers(
        torch, dev, model_layers("mobilenetv2", 32, 4), 10, dtype=bf)
    bf16_os_rows = {m: [r for r in time_model_layers(
        torch, dev, model_layers(m, 32, 4), 10, dtype=bf)
        if r["dataflow"] == "output_stationary"]
        for m in ("vgg16", "resnet18")}
    bf16_os_rows["mobilenetv2"] = [r for r in bf16_mb_rows
                                   if r["dataflow"] == "output_stationary"]
    for name, df in (("fold_conv_ws_bf16", "weight_stationary"),
                     ("fold_conv_os_bf16", "output_stationary"),
                     ("fold_conv_dw_bf16", "depthwise")):
        errs[name] = max([errs[name]] + [r["max_abs_err"] for r in bf16_mb_rows
                                         if r["dataflow"] == df])
    errs["fold_conv_os_bf16"] = max(
        [errs["fold_conv_os_bf16"]] + [r["max_abs_err"] for r in
                                       bf16_os_rows["vgg16"]
                                       + bf16_os_rows["resnet18"]])
    # the fp32 instance on the same layers (phase 2's rows)
    fp32_os = {m: {r["layer"]: r["ms"] for r in zoo_rows[m]}
               for m in ("mobilenetv2", "resnet18")}
    fp32_os["vgg16"] = {r["layer"]: r["output_stationary_ms"]
                        for r in rows32_os}
    for m, rows in bf16_os_rows.items():
        t = summarize(rows, "ms")
        print(f"[bf16] OS layers of {m} at 32, batch 4 (ms, device time; "
              f"tile, fp32 instance, F.conv2d in bf16): "
              + ", ".join(f"{r['layer']} {r['ms']:.4f} ({r['tile']}, "
                          f"{fp32_os[m][r['layer']]:.4f}, "
                          f"{r['library_ms']:.4f})" for r in rows)
              + f"; {len(rows)} layers: {t['ms']:.4f} ms, fp32 instance "
              f"{sum(fp32_os[m][r['layer']] for r in rows):.4f}, F.conv2d "
              f"in bf16 {t['library_ms']:.4f}, bound {t['bound_ms']:.5f} "
              f"({t['bound_by']})")
    bf16_dense_rows = time_dense(torch, dev, 1, 10, dtype=bf)
    bf16_psum_rows = time_bf16_psum(torch, dev, ws_layers, 5)
    print("[bf16] VGG-16 layers at 224, batch 1 (ms, device time): bf16 "
          "WS (its tensor-core tile) / bf16 psum (tile) / fp32 WS / plain / "
          "F.conv2d in bf16 / bf16 bound")
    for r, rp, r32 in zip(bf16_rows224, bf16_psum_rows, rows224):
        print(f"  {r['layer']:<8} c={r['c']:<4} nf={r['nf']:<4} "
              f"h={r['h']:<4} ws={r['weight_stationary_ms']:.4f} "
              f"(tc{r['weight_stationary_tile']}) "
              f"psum={rp['ms']:.4f} (tc{rp['tile']}) "
              f"fp32={r32['weight_stationary_ms']:.4f} "
              f"plain={r['plain_ms']:.4f} F.conv2d={r['library_ms']:.4f} "
              f"bound={r['bound_ms']:.5f}")
    report["bf16_layers"] = {"vgg16_224_b1": bf16_rows224,
                             "mobilenetv2_32_b4": bf16_mb_rows,
                             "os_vgg16_32_b4": bf16_os_rows["vgg16"],
                             "os_resnet18_32_b4": bf16_os_rows["resnet18"],
                             "dense_vgg16_224_b1": bf16_dense_rows,
                             "psum_vgg16_224_b1": bf16_psum_rows}

    # -- the bf16 main path: counts from 0 just before, read just after ---
    cw.reset_launch_counts()
    dn.reset_launch_counts()
    report["bf16_models"] = phase_bf16_models(torch, dev, {
        "vgg16 224": report["model224"]["forward_b1_ms"],
        "mobilenetv2 32": report["mobilenetv2"]["forward_b4_ms"],
        "resnet18 32": report["resnet18"]["forward_b4_ms"]})
    errs["fold_conv_psum_bf16"] = max(errs["fold_conv_psum_bf16"],
                                      phase_bf16_psum(torch, dev, ws_layers))
    from repro_torch.models import vgg
    bf16_vgg = vgg.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 50), img=224,
        device=dev, dtype=bf)
    phase_bf16_trunk(torch, dev, bf16_vgg)
    report["serving_bf16"] = phase_serving(torch, dev, bf16_vgg, jit=True)
    del bf16_vgg
    from repro_torch.models import mobilenet
    bf16_mb = randomize_bn(torch, mobilenet.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 52), img=32,
        device=dev, dtype=bf))
    report["serving_bf16_mobilenetv2"] = phase_serving(
        torch, dev, bf16_mb, jit=True, module=mobilenet, img=32,
        buckets=(1, 2, 4, 8))
    del bf16_mb
    bf16_launches = cw.launch_counts()
    bf16_launches[dn.KERNEL_BF16] = dn.launch_counts()[dn.KERNEL_BF16]
    report["bf16_seconds"] = time.perf_counter() - t_bf16
    print(f"[bf16 main path] launches "
          f"{ {k: v for k, v in bf16_launches.items() if v} }; [bf16] "
          f"took {report['bf16_seconds']:.1f} s with its kernel checks and "
          "timings")
    for name in BF16_KERNELS + (dn.KERNEL_BF16,):
        check(bf16_launches[name] > 0,
              f"{name} never launched on the bf16 main path")
    check(bf16_launches["fold_conv_psum_bf16"] == 13,
          "expected 13 bf16 psum launches: VGG-16's 13 layers")
    launches.update({k: bf16_launches[k]
                     for k in BF16_KERNELS + (dn.KERNEL_BF16,)})

    # -- the serving runtime (measured tuning, robust serving, chaos):
    # counts from 0 just before, read just after ---------------------------
    cw.reset_launch_counts()
    dn.reset_launch_counts()
    t_rt = time.perf_counter()
    report["tune"] = phase_tune(torch, dev, params)
    report["serve_runtime"] = phase_serve_runtime(
        torch, dev, report["serving_mobilenetv2"])
    report["chaos"] = phase_chaos(torch, dev)
    runtime_launches = cw.launch_counts()
    runtime_launches[dn.KERNEL] = dn.launch_counts()[dn.KERNEL]
    report["runtime_seconds"] = time.perf_counter() - t_rt
    print(f"[runtime path] launches {runtime_launches} (the tuner's counted "
          f"at its warm-ups and captures), {report['runtime_seconds']:.1f} s")
    for name in ("fold_conv_ws", "fold_conv_os", "fold_conv_dw",
                 "fold_conv_ws_i8", "fold_conv_os_i8", dn.KERNEL):
        check(runtime_launches[name] > 0,
              f"{name} never launched on the serving-runtime path")

    # -- HTTP serving (transport, router, in-process and spawned workers):
    # counts from 0 just before, read just after; a spawned worker's
    # launches are its own process's -------------------------------------
    cw.reset_launch_counts()
    dn.reset_launch_counts()
    t_http = time.perf_counter()
    report["http"] = phase_http(torch, dev, report["serving_mobilenetv2"])
    http_launches = cw.launch_counts()
    http_launches[dn.KERNEL] = dn.launch_counts()[dn.KERNEL]
    report["http_seconds"] = time.perf_counter() - t_http
    print(f"[http path] launches "
          f"{ {k: v for k, v in http_launches.items() if v} } (at the "
          f"workers' warm-ups and captures), "
          f"{report['http_seconds']:.1f} s")
    for name in ("fold_conv_ws", "fold_conv_os", "fold_conv_dw", dn.KERNEL):
        check(http_launches[name] > 0,
              f"{name} never launched on the HTTP serving path")

    # -- foldlint on the card (not a main path) ----------------------------
    report["foldlint"] = phase_foldlint(torch, dev)
    first = [r for r in VERIFY_ROWS if "first compile" in r["compile"]]
    memo = [r for r in VERIFY_ROWS if "memo" in r["compile"]]
    print(f"[verify] compile_network(verify=True): first compiles "
          + ", ".join(f"{r['compile'].split(' (')[0]} {r['verify_ms']:.3f}"
                      for r in first)
          + " ms; memo hits " + ", ".join(
              f"{r['compile'].split(' (')[0]} {r['verify_ms']:.3f}"
              for r in memo) + " ms")
    report["verify"] = VERIFY_ROWS

    # -- int8 and psum kernel times (not a main path) ----------------------
    i8_rows = {
        "vgg16_224_b1": time_int8_layers(torch, dev,
                                         model_layers("vgg16", 224, 1), 5),
        "vgg16_32_b4": time_int8_layers(
            torch, dev, [r for r in model_layers("vgg16", 32, 4)
                         if r[1].dataflow == "output_stationary"], 10),
        "mobilenetv2_32_b4": time_int8_layers(
            torch, dev, model_layers("mobilenetv2", 32, 4), 10),
        "resnet18_32_b4": time_int8_layers(
            torch, dev, model_layers("resnet18", 32, 4), 10),
    }
    for m, rows in i8_rows.items():
        print(f"[int8 kernels] {m} per layer (ms, device time):")
        for r in rows:
            print(f"  {r['layer']:<9} {r['rs']}/s{r['stride']} "
                  f"c={r['c']:<4} nf={r['nf']:<4} h={r['h']:<4} "
                  f"{r['dataflow']:<18} {r['epilogue']:<20} "
                  f"int8={r['ms']:.4f} fp32={r['fp32_ms']:.4f} "
                  f"plain={r['plain_ms']:.4f} bound={r['bound_ms']:.5f}")
        for df in ("weight_stationary", "output_stationary", "depthwise"):
            sel = [r for r in rows if r["dataflow"] == df]
            if sel:
                t = summarize_int8(sel)
                before = ("" if df != "depthwise" else
                          f", before the redesign "
                          f"{BEFORE_REDESIGN['fold_conv_dw_i8']}")
                print(f"[int8 kernels] {m} {df}: {len(sel)} layers, int8 "
                      f"{t['ms']:.4f} ms, fp32 {t['fp32_ms']:.4f}, plain "
                      f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.5f} "
                      f"({t['bound_by']}){before}")
        report[f"int8_layers_{m}"] = rows
    psum_rows = time_psum_vs_ws(torch, dev, ws_layers, 5)
    print("[psum] VGG-16 at 224, batch 1, identity epilogue (ms, device):")
    for r in psum_rows:
        gc4 = (f" | g_c=4: psum={r['gc4_ms']:.4f} psum+sum="
               f"{r['gc4_with_sum_ms']:.4f} ws={r['gc4_ws_ms']:.4f}"
               if "gc4_ms" in r else "")
        print(f"  {r['layer']:<8} c={r['c']:<4} nf={r['nf']:<4} h={r['h']:<4}"
              f" g_c={r['g_c']} psum={r['ms']:.4f} psum+sum="
              f"{r['with_sum_ms']:.4f} in-kernel ws={r['ws_ms']:.4f} "
              f"plain={r['plain_ms']:.4f} F.conv2d={r['library_ms']:.4f} "
              f"bound={r['bound_ms']:.4f}{gc4}")
    tot = {k: sum(r.get(k, 0.0) for r in psum_rows)
           for k in ("ms", "with_sum_ms", "ws_ms", "gc4_ms",
                     "gc4_with_sum_ms", "gc4_ws_ms", "library_ms",
                     "bound_ms")}
    print(f"[psum] sums: schedule plans psum {tot['ms']:.4f} / psum+sum "
          f"{tot['with_sum_ms']:.4f} / in-kernel ws {tot['ws_ms']:.4f} ms "
          f"(F.conv2d {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}, "
          f"psum before the redesign {BEFORE_REDESIGN['fold_conv_psum']}); "
          f"g_c=4 (12 layers) psum {tot['gc4_ms']:.4f} / psum+sum "
          f"{tot['gc4_with_sum_ms']:.4f} / ws {tot['gc4_ws_ms']:.4f} ms")
    report["psum_vs_ws_224_b1"] = psum_rows
    bf16_sum = {
        "fold_conv_ws_bf16": (summarize(bf16_rows224, "weight_stationary_ms"),
                              sum(r["weight_stationary_ms"] for r in rows224),
                              "VGG-16 13 layers at 224 b1"),
        "fold_conv_os_bf16": (summarize(
            [r for r in bf16_mb_rows if r["dataflow"] == "output_stationary"],
            "ms"), sum(r["ms"] for r in zoo_rows["mobilenetv2"]
                       if r["dataflow"] == "output_stationary"),
            "MobileNetV2 28 OS layers at 32 b4"),
        "fold_conv_dw_bf16": (summarize(
            [r for r in bf16_mb_rows if r["dataflow"] == "depthwise"], "ms"),
            sum(r["ms"] for r in dw_rows),
            "MobileNetV2 17 depthwise layers at 32 b4"),
        "fold_conv_psum_bf16": (summarize(bf16_psum_rows, "ms"),
                                sum(r["ms"] for r in psum_rows),
                                "VGG-16 13 layers at 224 b1, identity"),
        dn.KERNEL_BF16: (summarize(bf16_dense_rows, "ms"),
                         sum(r["ms"] for r in dense_rows[1]),
                         "VGG-16 fc1-fc3 at 224 b1")}
    for name, (t, fp32, what) in bf16_sum.items():
        before = (f", the instance before the redesign "
                  f"{BEFORE_REDESIGN[name]}" if name in BEFORE_REDESIGN
                  else "")
        print(f"[bf16] {name} ({what}): {t['ms']:.4f} ms (fp32 instance "
              f"{fp32:.4f}{before}), plain {t['plain_ms']:.4f}, library in "
              f"bf16 {t['library_ms']:.4f}, bound {t['bound_ms']:.5f} "
              f"({t['bound_by']}), max abs err vs plain {errs[name]:.3e}")

    # -- the LM kernels against their plain versions (not a main path) ----
    from repro_torch.kernels import attention_fold as af
    cc = importlib.import_module("repro_torch.kernels.conv1d_causal")
    lm_errs, attn_per_call = phase_lm_kernels(torch, dev)
    errs.update(lm_errs)

    # -- the LM main path: counts from 0 just before, read just after -----
    cc.reset_launch_counts()
    af.reset_launch_counts()
    report["prefill_zamba2"], prefill_run, decode_run = phase_prefill(
        torch, dev)
    n_prefill = cc.launch_counts()[cc.KERNEL]
    report["consistency_zamba2"] = phase_consistency(torch, dev)
    n_check = cc.launch_counts()[cc.KERNEL] - n_prefill
    report["serving_zamba2"] = phase_lm_serving(torch, dev)
    n_serve = cc.launch_counts()[cc.KERNEL] - n_prefill - n_check
    n_layers = report["prefill_zamba2"]["conv1d_launches_per_prefill"]
    print(f"[lm main path] conv1d_causal launches: prefill {n_prefill}, "
          f"consistency {n_check} (one forward and one prefill), serving "
          f"{n_serve}: decode launches no kernel (the engine steps prompts "
          f"through the decode step, as the JAX engine does); "
          f"attention_fold {af.launch_counts()[af.KERNEL]} (no model calls "
          "it)")
    check(n_check == 2 * n_layers and n_serve == 0,
          "unexpected conv1d launches off the prefill")
    check(af.launch_counts()[af.KERNEL] == 0,
          "a model path launched the attention kernel")
    launches[cc.KERNEL] = cc.launch_counts()[cc.KERNEL]

    # -- the attention kernel's path, the op itself: counts from 0 --------
    af.reset_launch_counts()
    phase_attention_op(torch, dev)
    launches[af.KERNEL] = af.launch_counts()[af.KERNEL]
    print(f"[attention op] {af.KERNEL} launches {launches[af.KERNEL]}")
    check(launches[af.KERNEL] == 1, "the attention op did not launch once")
    lm_rows = time_lm_kernels(torch, dev, attn_per_call)
    report["lm_kernels"] = lm_rows

    # -- the dense attention family: no kernel of the port on its path
    # (the JAX package's attention is plain einsum too) --------------------
    del params
    _free(torch)
    cc.reset_launch_counts()
    af.reset_launch_counts()
    t_dense = time.perf_counter()
    served, dense_runs = phase_dense_served(torch, dev)
    report["dense_lm"] = {"served": served,
                          "ring": phase_dense_ring(torch, dev),
                          "cut": phase_dense_cut(torch, dev)}
    report["dense_lm"]["seconds"] = time.perf_counter() - t_dense
    print(f"[dense lm] {report['dense_lm']['seconds']:.1f} s; conv1d "
          f"{cc.launch_counts()[cc.KERNEL]}, attention_fold "
          f"{af.launch_counts()[af.KERNEL]} launches (the dense family "
          "runs none)")
    check(cc.launch_counts()[cc.KERNEL] == 0
          and af.launch_counts()[af.KERNEL] == 0,
          "the dense family launched an LM kernel")

    # -- the other LM families: no kernel of the port on their paths (the
    # JAX package's RWKV-6, MoE, enc-dec and VLM reach no Pallas call) ----
    counted = (cw, dn, cc, af)
    for mod in counted:
        mod.reset_launch_counts()
    t_fam = time.perf_counter()
    report["lm_families"] = phase_lm_families(torch, dev)
    report["lm_families"]["seconds"] = time.perf_counter() - t_fam
    fam_launches = {k: n for mod in counted
                    for k, n in mod.launch_counts().items()}
    print(f"[lm families] {report['lm_families']['seconds']:.1f} s; "
          f"launches of the port's kernels: "
          f"{sum(fam_launches.values())} over {len(fam_launches)} kernels "
          "(the families run none)")
    check(not any(fam_launches.values()),
          f"an LM family launched a kernel of the port: {fam_launches}")

    # -- training: zamba2-1.2b through Trainer, the conv1d kernel in the
    # forward and in the backward's dx; counts from 0 just before, read
    # just after; deterministic algorithms for the bitwise checks --------
    for mod in counted:
        mod.reset_launch_counts()
    t_train = time.perf_counter()
    tcfg, tdata, topt = train_setup()
    torch.use_deterministic_algorithms(True)
    try:
        report["train"] = phase_train(torch, dev, tcfg, tdata, topt)
        report["train"]["grads"] = phase_train_grads(torch, dev, tcfg, tdata,
                                                     topt)
    finally:
        torch.use_deterministic_algorithms(False)
    report["train"]["seconds"] = time.perf_counter() - t_train
    train_launches = {k: n for mod in counted
                      for k, n in mod.launch_counts().items() if n}
    # the steps that run the kernel: the uninterrupted run, the restart's
    # two runs, and the kernel's side of the A/B step
    n_train_steps = 2 * TRAIN_STEPS + 1
    print(f"[train] {report['train']['seconds']:.1f} s; kernel launches "
          f"over {n_train_steps} kernel steps: {train_launches}")
    check(train_launches == {cc.KERNEL: n_train_steps
                             * train_conv1d_launches(tcfg)},
          f"train: unexpected kernel launches {train_launches}")
    launches_train = train_launches[cc.KERNEL]

    # -- the fold convs' gradients on the card (counts from 0 inside) -----
    report["fold_grads"] = phase_fold_grads(torch, dev)

    # torch.profiler after every timed phase of this process but the mesh
    # ones: once it has run, every kernel of the process reads ~1.3 us
    # slower, graph replay included (PERF.md, section 6).  The mesh
    # phases compare within themselves or time in their ranks' own
    # processes, and they need the card's memory that the profiled runs
    # held (gemma3-12b's weights and zamba2's prefill and decode runs)
    report["decode_zamba2"] = phase_lm_device(
        torch, report["prefill_zamba2"], prefill_run, decode_run)
    del prefill_run, decode_run
    for what, fn in dense_runs.items():
        ms, n, top = profile_device(torch, fn, top=8)
        served[f"profile_{what.replace(' ', '_')}"] = {
            "device_ms": ms, "kernels": n, "top_kernels": top}
        if ms is not None:
            print(f"[profile] {DENSE_SERVED} {what} (prefill B=1 x 1024; "
                  f"the decode step captured, B=4, window cache, position "
                  f"16): {ms:.3f} ms of kernels in {n} launches; top: "
                  + "; ".join(f"{r['kernel'][:56]} {r['ms']:.3f} ms "
                              f"({r['share']:.3f}, {r['calls']} calls)"
                              for r in top))
    # the loop's last closure holds gemma3-12b's weights and decode graph
    del dense_runs, fn
    report["lm_families"]["profile"] = profile_lm_families(torch, dev)
    report["train"]["profile"] = profile_train(
        torch, dev, tcfg, tdata, topt, report["train"]["step_ms_mean"])
    _free(torch)

    # -- the scale-out path: VGG-16 and zamba2 on meshes; counts from 0
    # just before, read just after (the two ranks count in their own
    # processes and report it) ------------------------------------------
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    for mod in counted:
        mod.reset_launch_counts()
    t_mesh = time.perf_counter()
    mesh_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    plan_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dryrun = None
    try:
        mesh = make_local_mesh(1, 1, device=dev)
        report["mesh"] = {"vision": phase_mesh_vision_one_rank(
            torch, dev, mesh, mesh_dir)}
        report["mesh"]["lm"] = phase_mesh_lm_one_rank(torch, dev, mesh)
        mesh_launches = {k: n for mod in counted
                         for k, n in mod.launch_counts().items() if n}
        # the dry-run's two cells trace on the host's cores while the two
        # ranks run on the card
        dryrun = start_dryrun(plan_dir)
        report["mesh"]["two_ranks"] = phase_mesh_two_ranks(
            torch, dev, mesh_dir, report["train"]["losses"][0])
        report["mesh"]["seconds"] = time.perf_counter() - t_mesh
        # -- the elastic restart: the example on the card, then the
        # survivor's restart of the two ranks' checkpoint in this process
        # (both rank processes have exited); the step's launches counted
        # from 0 just before it, read just after --------------------------
        t_el = time.perf_counter()
        report["elastic"] = {"example": phase_elastic_example()}
        report["elastic"]["restart"] = phase_elastic_restart(
            torch, dev, mesh_dir, report["mesh"]["two_ranks"]["ranks"],
            report["nvidia_smi"])
        report["elastic"]["seconds"] = time.perf_counter() - t_el
        print(f"[elastic] {report['elastic']['seconds']:.1f} s")
    except BaseException:
        if dryrun is not None:
            stop_dryrun(dryrun)
        shutil.rmtree(plan_dir, ignore_errors=True)
        raise
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[mesh] one-rank path launches {mesh_launches}; "
          f"{report['mesh']['seconds']:.1f} s with the two ranks")
    for name in ("fold_conv_ws", "fold_conv_ws_bf16", dn.KERNEL,
                 dn.KERNEL_BF16, cc.KERNEL):
        check(mesh_launches.get(name, 0) > 0,
              f"{name} never launched on the one-rank mesh path")
    mesh_total = dict(mesh_launches)
    for r in report["mesh"]["two_ranks"]["ranks"]:
        for v in r["vision"].values():
            for k, n in v["launches"].items():
                mesh_total[k] = mesh_total.get(k, 0) + n
        mesh_total[cc.KERNEL] = mesh_total.get(cc.KERNEL, 0) + \
            r["pipeline"]["conv1d_launches"] + sum(
                m["train"]["launches"] + m["cut"]["launches"]
                for m in r["lm"].values())
    for name in ("fold_conv_ws", "fold_conv_ws_bf16", dn.KERNEL,
                 dn.KERNEL_BF16):
        for i, r in enumerate(report["mesh"]["two_ranks"]["ranks"]):
            check(any(v["launches"].get(name, 0) > 0
                      for v in r["vision"].values()),
                  f"{name} never launched on mesh rank {i}")
    # -- the dry-run and the roofline: traced on the host, nothing runs on
    # the card (every count from 0 just before, none after) -------------
    for mod in counted:
        mod.reset_launch_counts()
    t_plan = time.perf_counter()
    try:
        report["dryrun"] = phase_dryrun(plan_dir, dryrun)
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    report["roofline"] = phase_roofline(
        torch, report["train"]["step_ms_mean"],
        served["serving"]["step_ms"], served["serving"]["device_ms"],
        report["nvidia_smi"])
    plan_launches = {k: n for mod in counted
                     for k, n in mod.launch_counts().items() if n}
    check(not plan_launches, f"dryrun / roofline launched {plan_launches}")
    print(f"[dryrun] the two phases took {time.perf_counter() - t_plan:.1f}"
          " s past the two-rank mesh phases (the cells started with them) "
          "and launched no kernel")


    # the jit rows, side by side: every conv cell, then served images/s
    print("[jit] conv cells, ms: jitted / eager / device work (busy share "
          "jitted, eager; host ms a jitted call)")
    for r in JIT_ROWS:
        print(f"[jit]   {r['cell']:<22} {r['jit_ms']:.4f} / "
              f"{r['eager_ms']:.4f} / {r['device_ms']:.4f} "
              f"({r['busy_jit']:.3f}, {r['busy_eager']:.3f}; "
              f"{r['jit_host_ms']:.4f})")
    slower = [r["cell"] for r in JIT_ROWS if r["jit_ms"] > r["eager_ms"]]
    print(f"[jit] cells where the jitted forward is slower than the eager "
          f"one: {slower or 'none'}")
    for what, key in (("vgg16 224", "serving"),
                      ("mobilenetv2", "serving_mobilenetv2"),
                      ("mobilenetv2 int8", "serving_int8_mobilenetv2")):
        jd, ed = report[key], report[f"{key}_eager"]
        print(f"[jit] serving {what}: jitted {jd['images_per_s']:.3f} "
              f"images/s, p50 {jd['latency']['p50_s'] * 1e3:.3f} ms, p99 "
              f"{jd['latency']['p99_s'] * 1e3:.3f} ms; eager "
              f"{ed['images_per_s']:.3f} images/s, p50 "
              f"{ed['latency']['p50_s'] * 1e3:.3f} ms, p99 "
              f"{ed['latency']['p99_s'] * 1e3:.3f} ms")
    report["jit_cells"] = JIT_ROWS

    # ms_kind "device": CUDA-graph replay of the bare launch on prepared
    # operands, beside F.conv2d and the plain version replayed the same
    # way; call_ms is the eager wrapper call, host work included
    kernels = []
    for name, key, rows, line in (
            ("fold_conv_ws", "weight_stationary_", rows224, 131),
            ("fold_conv_os", "output_stationary_", rows32_os, 176),
            ("fold_conv_dw", "", dw_rows, 202)):
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/fold_conv.cuh",
                 "replaces": f"src/repro/kernels/conv2d_ws.py:{line}",
                 "launches": launches[name], "max_abs_err": errs[name],
                 "ms_kind": "device",
                 "call_ms": sum(r[f"{key}call_ms"] for r in rows)}
        entry.update(summarize(rows, f"{key}ms"))
        kernels.append(entry)
    for name, rows, line in (
            ("fold_conv_ws_i8", i8_rows["vgg16_224_b1"], 131),
            ("fold_conv_os_i8", i8_rows["vgg16_32_b4"], 176),
            ("fold_conv_dw_i8", [r for r in i8_rows["mobilenetv2_32_b4"]
                                 if r["dataflow"] == "depthwise"], 202)):
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/fold_conv.cuh",
                 "replaces": f"src/repro/kernels/conv2d_ws.py:{line}",
                 "launches": launches[name], "max_abs_err": errs[name],
                 "ms_kind": "device"}
        entry.update(summarize_int8(rows))
        kernels.append(entry)
    entry = {"name": "fold_conv_psum", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fold_conv.cuh",
             "replaces": "src/repro/kernels/conv2d_ws.py:234",
             "launches": launches["fold_conv_psum"],
             "max_abs_err": errs["fold_conv_psum"], "ms_kind": "device"}
    entry.update(summarize(psum_rows, "ms"))
    kernels.append(entry)
    # the head kernel has no TPU counterpart: the JAX package's head is the
    # dense op of its compiled forward
    entry = {"name": dn.KERNEL, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/dense.cu",
             "replaces": "src/repro/core/engine.py:1242",
             "tpu_kernel": False, "launches": launches[dn.KERNEL],
             "max_abs_err": errs[dn.KERNEL], "ms_kind": "device"}
    entry.update(summarize(dense_rows[1], "ms"))
    kernels.append(entry)
    # the bf16 instances: VGG-16's layers at 224 (WS, psum, the head) and
    # MobileNetV2's at 32 b4 (OS, depthwise), beside their fp32 instance
    for name, (t, fp32, what) in bf16_sum.items():
        head = name == dn.KERNEL_BF16
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/" + {
                     dn.KERNEL_BF16: "dense.cu",
                     "fold_conv_ws_bf16": "fold_conv_tc.cuh",
                     "fold_conv_os_bf16": "fold_conv_tc.cuh",
                     "fold_conv_psum_bf16": "fold_conv_tc.cuh"}.get(
                         name, "fold_conv.cuh"),
                 "replaces": ("src/repro/core/engine.py:1242" if head else
                              "src/repro/kernels/conv2d_ws.py:"
                              + {"fold_conv_ws_bf16": "131",
                                 "fold_conv_os_bf16": "176",
                                 "fold_conv_dw_bf16": "202",
                                 "fold_conv_psum_bf16": "234"}[name]),
                 "launches": launches[name], "max_abs_err": errs[name],
                 "ms_kind": "device", "fp32_ms": fp32, "shapes": what}
        if head:
            entry["tpu_kernel"] = False
        entry.update(t)
        kernels.append(entry)
    # the LM kernels at the prefill cell's shape: conv1d in bf16 (the
    # model's type), attention in fp32 (FFMA) and in bf16 (the tensor
    # cores); both attention instances share one launch counter, and the
    # op's run is bf16
    for name, row, src, line in (
            (cc.KERNEL, lm_rows[cc.KERNEL], "conv1d_causal", 28),
            (af.KERNEL, lm_rows[f"{af.KERNEL}_float32"], "attention_fold",
             41),
            (f"{af.KERNEL}_bf16", lm_rows[f"{af.KERNEL}_bfloat16"],
             "attention_fold", 41)):
        base = name if name == cc.KERNEL else af.KERNEL
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                 "replaces": f"src/repro/kernels/{src}.py:{line}",
                 "launches": launches[base], "max_abs_err": errs[name],
                 "ms_kind": "device"}
        entry.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")})
        if name == cc.KERNEL:
            # the training path: its own count, from 0 (forward and dx)
            entry.update(train_launches=launches_train,
                         train_launches_per_step=train_conv1d_launches(
                             tcfg))
        kernels.append(entry)
    for entry in kernels:
        # the scale-out path's launches (the parent's one-rank phases and
        # both ranks' processes), beside the main path's
        entry["mesh_launches"] = mesh_total.get(entry["name"], 0)
        if entry["name"] == cc.KERNEL:
            # [elastic]'s survivor step, its own count from 0
            entry["elastic_launches"] = \
                report["elastic"]["restart"]["conv1d_launches"]
            # [mesh lm]'s training and fp32 steps, each rank's count
            entry["mesh_lm_launches"] = {
                key: [{"train": r["lm"][key]["train"]["launches"],
                       "fp32_step": r["lm"][key]["cut"]["launches"]}
                      for r in report["mesh"]["two_ranks"]["ranks"]]
                for key in report["mesh"]["two_ranks"]["ranks"][0]["lm"]}
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
