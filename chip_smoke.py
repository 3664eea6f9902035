#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Phases, each of which exits non-zero on failure:

1. environment: torch/CUDA versions, the card's name and power limit
   (``nvidia-smi``); requires compute capability 9.0 (Hopper);
2. build: compiles every kernel of the path from ``src/repro_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the shapes both main paths give it and larger ones, with CUDA-event
   times: ``fused_tick`` (K2's one tick), ``fused_interval`` (K2 as the
   fused engine runs it: a decision interval of K ticks a launch, at (rows,
   K) = (8, 12), (288, 12), (37, 1) and (37, 100); lag and the nine
   metrics bit for bit, the detector within 1e-12, equal triggers),
   ``rls_update`` (K1's one step, float64 and float32), ``arima_chunk``
   (K1 as the forecast bank runs it: a flush of T ticks a launch, at
   k = 5, 9, 17, 8 and 288 streams, T = 4, 12, 128, and as the fleet soak
   flushes it, 1 000 streams at k = 9, T = 1; every output within 1e-12
   of each stream's scale, no spill at these orders), each of the
   last two also timed against the per-tick path it replaced and its
   host wall,
   ``decode_attention`` (K3, split over positions: the serving shape beside
   ``scaled_dot_product_attention``, one row of 32 768 positions,
   deepseek-moe-16b's G = 1 over 16 KV heads, and a sweep over groups and
   head dims, 14 and 96 among them (zero-padded to the kernel's next);
   zeros at length 0 and the same bits on a second call),
   ``ssd_scan`` (K5, three passes: the mamba2 and zamba2 prefill shapes
   in bf16 and float32, the reference tests' shapes in float32, and
   strong decay, within 5e-5 in float32 and 2e-2 in bf16 of its plain
   version, atol and rtol, and the same bits on a second call) and
   ``flash_attention`` (K4: the hubert-xlarge and pixtral-12b shapes in
   bf16 beside ``scaled_dot_product_attention``, one layer of the
   reference's prefill_32k encoder cell, the reference tests' shapes in
   float32 both causal and not, gemma's head dim and a ragged length of
   300; within 2e-5 in float32 and 2e-2 in bf16), each K3, K4, K5 and K6
   row naming the design that ran (``split-kv``, ``wgmma-tma``,
   ``tensor-cores``, ``mma.sync`` or ``cuda-cores``) and its kernels'
   registers and spills from ``-Xptxas -v``, ``grouped_matmul`` (K6:
   deepseek-moe-16b's decode step, 16 tokens x top-6 over 64 experts at
   blk_m 16 (and 128, its time only), and a 2048-token prompt at blk_m
   128 and 64, gate/up 2048 -> 1408 and down 1408 -> 2048 in bf16 beside
   ``torch._grouped_mm`` and the capacity buffer's einsums, and the
   reference tests' shapes in float32; within 1e-4 of the plain version's
   scale in float32 and 2e-2 in bf16, padding tiles zero, the same bits on
   a second call) and ``fused_rmsnorm`` (K7: the reference
   tests' shapes and 16 x 4096 rows of 2048 beside ``F.rms_norm``; 1e-5 in
   float32, one bf16 ulp of each element in bf16), and ``gp_lbfgs`` (the
   GP bank's whole fit, a CTA a row; not a TPU kernel: the reference's fit
   is plain JAX) at ``GP_FIT_SHAPES`` on its tiled body (phase 5's 96
   members at n_max 64, 3 members at n_max 32, 96 members at n_max 32 and
   16, and the Demeter path's most common launch, 1 member at n_max 8; each
   row with its time an evaluation, design, registers and spills) and at 8 members of 129-256
   points (n_max 256, the general body, in global scratch) against its
   plain version, the batched L-BFGS over the autograd objective (iterates
   after 1 and 2 iterations within 1e-3 of theta's scale, best objectives
   after 60 within 1e-3 relative);
4. baseline path: ``SweepEngine``/``run_sweep`` over a baseline-controller
   grid (traces ysb and tsw x static/reactive/ds2 x seeds 0-47 = 288
   scenarios, the paper's 18 h at dt = 5 s, a failure every 45 minutes) on
   the fused engine on the card, then on the NumPy batched engine and the
   fused engine on the CPU; every scenario must agree with the batched
   engine at rtol 1e-9, the detector triggers with the CPU run's, and K2
   (``fused_interval``) must have launched once per ``step_interval``
   call and the per-tick ``fused_tick`` never;
5. components on the card: a 288-stream mixed-family ``ForecastBank``
   against the scalar zoo (rtol 1e-9, equal binned-forecast decisions), a
   96-member ``GPBank.fit`` against the scalar ``GP.fit`` (posterior
   within 5% of scale, except on ``OTHER_OPTIMA``, where scipy reaches a
   lower optimum than the bank's algorithm and the reference's bank
   misses the bar too: there the CPU bank's objective), and the same
   profiling batch selected either way; the
   bank launches K1 (``arima_chunk``) once per ARIMA chunk;
6. the Demeter main path: ``paper_grid(controllers=("demeter",),
   trace_kinds=("ysb", "tsw"))`` at the paper's 18 h under the default
   ``EngineConfig()`` (fused engine, forecast bank with K1, GP bank,
   acquisition, all on the card); finite results, a failure in every
   scenario, GP fits made, K1 (``arima_chunk``) launched once per ARIMA
   chunk replayed, K2 (``fused_interval``) once per ``step_interval``
   call, ``gp_lbfgs`` once per GP bank fit (with the largest padded
   training size it fitted, the fits by rows and padded size and the
   kernel's device time), and the per-tick kernels never;
7. the Demeter path, card against CPU: a 3-scenario, 2 h grid with the
   scalar GP fits, run on ``cuda`` and on ``cpu``; every scenario must agree
   at rtol 1e-9 with equal reconfiguration, fit and forecast-update counts;
8. the serving main path: qwen2-7b at full width in bfloat16 (random
   weights from seed 0), ``ServingEngine(n_slots=16, max_len=4096)``
   serving 32 requests with prompts of 256-2048 tokens and 64 new tokens
   each; every request completes with 64 tokens, every logit is finite,
   and the decode-attention kernel (K3, checked and timed in phase 3 at
   these shapes beside ``scaled_dot_product_attention``) launches once per
   layer and decode step;
9. serving, card against CPU: qwen2-7b at full width but 2 layers, float32,
   TF32 off, 4 short requests on ``cuda`` (K3) and on ``cpu`` (its plain
   version); equal greedy tokens, or a first difference where the top-2
   logit gap is below the logits' measured difference;
10. autoscaled serving: ``run_autoscaled`` calibrates a full-width qwen2-7b
    replica on the card and lets the Demeter controller (on the card) run
    a simulated fleet for 3600 s;
11. the SSM serving main path: mamba2-1.3b at full width in bfloat16 (all
    48 layers), phase 8's engine and traffic (32 requests, 64 new tokens);
    every request completes, every logit is finite, the second wave of
    prefills reuses slots, and K5 launches once per layer and prefill
    (48 x 32 = 1 536);
12. mamba2, card against CPU: 2 layers at full width, float32, TF32 off,
    4 requests of 300-700 prompt tokens (across the SSD chunk), judged as
    phase 9;
13. zamba2-2.7b at full width in bfloat16 (54 layers, the shared block's
    KV cache for 16 x 4096 positions), 16 requests of 256-2048 prompt
    tokens, 32 new tokens; K5 launches 54 x 16 = 864 times;
14. zamba2, card against CPU: one super-layer (6 layers), float32, 2
    requests, judged as phase 9;
15. the encoder path: hubert-xlarge at full width in bfloat16 (48 layers)
    ``encode``s 8 clips of 4096 frames 3 times after a warm-up; every logit
    is finite, of shape (8, 4096, 504), and K4 launches 48 times a call;
    frames/s, the wall per call, peak memory and one call's device busy
    and idle share;
16. hubert, card against CPU: 2 layers at full width, float32, TF32 off, 2
    clips of 300 frames (a partial K4 tile); logits within 1e-4 of their
    scale, per-frame classes equal or parted by less than the difference;
17. the vlm path: pixtral-12b at full width in bfloat16 (40 layers) takes
    ``train_loss`` of 2 x 4096 tokens with a 512-patch prefix; the loss is
    finite, K4 launches 40 times, and the same model on the plain
    attention route gives the loss within 1e-2;
18. pixtral, card against CPU: 2 layers at full width, float32, TF32 off,
    1 x 256 tokens with 64 patches; the loss within 1e-5 and the logits
    within 1e-4 of their scale;
19. the MoE serving path: deepseek-moe-16b at full width in bfloat16 (28
    layers: layer 0 a dense FFN, then 64 routed experts of 1408, top-6,
    and 2 shared), phase 8's engine and traffic; every request completes,
    every logit is finite, the second wave reuses slots, K6 launches 3 x
    27 times per prefill and decode step and K3 28 times per decode step;
    two prompts' last prefill logits on the K6 route against the capacity
    buffer's einsums (``MOE_ROUTE_BAR``);
20. deepseek-moe, card against CPU: 2 layers (the dense one and an MoE
    one) at full width, float32, TF32 off, 4 requests, judged as phase 9;
21. deepseek-v2-lite-16b at full width in bfloat16 (27 layers of
    multi-head latent attention, a 512-wide latent cache), phase 19's
    traffic; K6 launches 3 x 26 times per call, and one absorbed decode
    step equals the naive path from the same cache within 2e-2;
22. deepseek-v2-lite, card against CPU: as phase 20;
23. the detector bank: a ``DetectorBank`` of 1 024 streams (the fleet
    service's slab) on the card over 1 080 samples (18 h of 60-s epochs),
    a quarter of the streams with outages to zero, half with NaN gaps and
    an eighth inactive half the time; flags equal to the port's CPU bank
    on every sample and the first 64 streams' equal to ``MetricDetector``;
    the state one sample at a time from the CPU bank's (every 108th
    sample) within 1e-12 of each stream's scale; K1 (``arima_chunk``,
    phase 3 at the detector's shapes) launched once per ``observe``; the
    host wall and device time per ``observe``;
24. the paper's per-cell protocol: ``run_experiment`` for static,
    reactive, ds2 and demeter on ysb and tsw at the paper's 18 h (dt = 5
    s, a failure every 45 minutes, seed 0) under ``EngineConfig()``;
    finite results, one failure record per failure, profiling cost for
    Demeter only, Demeter's K1 launches equal to its forecast bank's ARIMA
    chunks, ``gp_lbfgs``'s to its GP bank fits (printed by rows and padded
    size); a Table-3 row each;
25. card against CPU: ``run_experiment`` of the four methods on ysb (2 h,
    seed 3, scalar GP fits) on ``cuda`` and ``cpu`` (arrays at rtol 1e-9,
    equal reconfigurations and failure records); phase 7's grid with the
    bank detector against phase 7's card run, and on the scalar engine
    against the batched engine, at rtol 1e-9;
26. obs on the sweep stack: phase 7's grid (bank GP fits) on the card with
    obs off, then on: ``to_json()`` equal apart from the walls; the spans
    ``sweep.run``, ``engine.fused.interval``, ``forecast.flush``,
    ``gp_bank.fit`` and ``demeter.acquire`` present; ``sweep.intervals``
    equal to K2's launches and K1's launches between the ARIMA
    flush-and-rolls and those plus the flushes; the per-phase walls; a
    Chrome trace written under ``build/obs/`` and loaded back; the aten-op
    probe over one ``step_interval`` and one forecast-bank flush on the
    card (equal operation counts with obs off and on); the reference
    test's overhead bound (best of 5, at most 2% plus 2 ms an interval),
    printed with the relative overhead, a fresh executor's first interval
    and the steady state's;
27. the fleet service: ``run_soak`` at the loadgen's defaults (1 000 jobs,
    8 epochs, seed 0) on the card twice (the second with obs on: the walls
    of its spans) and on the CPU: equal digests and ``stats()``; K1 once
    per forecast-bank flush and once per detector sample; the 64-job x
    30-epoch profiling soak (seed 7) card against CPU under the scalar GP
    fits, then on the card with the bank fits and obs on, timed, with the
    scalar fits' decisions and ``gp_lbfgs`` launched once per GP bank fit
    (printed by rows and padded size); ``python -m
    repro_torch.fleet --device cuda`` fed a JSON-lines script with a
    ``"serving"`` job on phase 10's measured profile, answering as an
    in-process CPU service does;
28. the training path: deepseek-7b at full width in bfloat16, cut to 2
    layers, on the plain attention route (the reference trains there: no
    kernel has a backward), ``ElasticTrainer`` with int8 error-feedback
    compression and 2 microbatches on batches of 4 x 1 024 tokens: 6 steps
    with a checkpoint at step 4, a failure, then the restore of step 4,
    the replay of steps 4-5 (their losses bit for bit the first pass's) and
    steps 6-7 (a second checkpoint at 8); finite losses, positive grad
    norms, no launch of any of the port's kernels; the median step, the
    save (host copy), write and restore walls, the peak device memory, one
    step's device idle share and the step's bound;
29. training, card against CPU: the trainer on the smoke config in
    float32 (TF32 off), 4 steps from the same parameters; losses, grad
    norms and final parameters within 1e-5;
30. contracts on the card: ``scripts/check_contracts_torch.py`` over the
    five registries with ``device="cuda"``: every launch budget holds, no
    probe syncs with the host (also under
    ``torch.cuda.set_sync_debug_mode("error")``), K2's ``fused_interval``,
    K1's ``arima_chunk`` and ``gp_lbfgs`` are captured in a CUDA graph and
    replayed bit-equal, the seeded violation breaks ``forbid_host_sync``,
    ``dtype_ceiling`` and ``in_place``; each probe's time is printed;
31. the scenario mesh on this machine: ``EngineConfig(devices=1)`` runs a
    small baseline grid equal to the default config bit for bit; a mesh of
    ``torch.cuda.device_count() + 1`` cards and ``sim_backend="sharded"``
    on one card raise with the port's hint; the sharded engine over 4 CPU
    host partitions (``REPRO_TORCH_HOST_DEVICES=4``) equals the batched
    engine at rtol 1e-9; with 2 cards or more, the fused engine and a
    Demeter grid over 2 cards equal 1 card bit for bit, else the phase
    prints that this leg did not run;
32. the model-parallel mesh: a one-rank NCCL process group; qwen2-7b at
    full width in bf16 on the kernel route serves 4 prompts (16 decode
    steps) inside ``sharding_context`` on a (1, 1) mesh and outside it:
    equal tokens and K3 launches (16 x 28 each); ``ring_allreduce`` and
    ``hierarchical_allreduce`` on one rank return their input bit for bit;
    ``ElasticTrainer(mesh=...)`` on deepseek-7b at phase 28's width (2
    layers, bf16, the default ``TrainConfig``) on a (pod=1, data=1,
    model=1) mesh, the reference's multi-pod axes (the regions of
    ``distributed.sharding`` run the attention per head): 5 steps with a
    checkpoint after 4, a failure, the restore onto ``surviving_mesh``
    (the pod axis lost: (data, model)) and the replay: every loss within 1e-5 of the meshless trainer's (bit for
    bit is expected on one rank and is printed), both median step times
    and the first sharded step; with 2 cards or more, 2 NCCL ranks hold the
    ring against ``all_reduce`` and the smoke ``train_loss`` on a (data=1,
    model=2) mesh against one rank's, else the phase prints that this leg
    did not run. The group is destroyed at the end;
33. the dry-run on this machine's PyTorch: ``lower_cell(arch, "train_4k",
    multi_pod=False, cfg_override=smoke_config(arch))`` for one smoke
    config of every family (a fake 256-rank group on the CPU, in two
    subprocesses, the cards hidden); each record is printed and every one
    must be ``ok``;
34. the examples: each ``examples/<name>_torch.py``'s ``main`` in this
    process at the reference's default arguments (``EXAMPLE_ARGS``), its
    lines captured into ``build/examples/``: quickstart (90 minutes; K1 once
    per ARIMA chunk, ``gp_lbfgs`` once per GP bank fit), dsp_repro (3 h,
    the four methods; K1 and ``gp_lbfgs``), dsp_sweep --verify (1 h, 18
    scenarios; ``fused_interval`` once per ``step_interval`` call, and
    "equivalence OK"), serve_autoscale (qwen2-7b's smoke config, 4
    simulated hours; K3, and K1 and ``gp_lbfgs`` in phase 2's controller)
    and train_elastic (300 steps, the failure at 160: no kernel, the
    replayed losses bit for bit); each run fails if another kernel ran.
    Card against CPU: quickstart's and dsp_repro's lines equal (dsp_repro's
    arrays at rtol 1e-9, its profiling cost at 2e-9), dsp_sweep's lines
    equal but the walls, serve_autoscale's phase-1 tokens equal (float32,
    TF32 off). quickstart's and dsp_repro's card runs print how near
    their Demeter picks came to another choice (``pick_margins``: a float32
    near-tie that a fit kernel's rounding could flip card vs CPU). Rehearse
    with ``examples_phase(("cpu", "cpu"))``.

The last four lines of standard output are the ``{"examples": {...}}``
line (each example's card wall, launches and agreement), the
``nvidia-smi`` line, the ``{"kernels": [...]}`` line and ``{"ok": true,
"device": {...}}``. The
``kernels`` line reports each kernel's launches on its own main path (K1
and K2 on the Demeter path, as ``arima_chunk`` and ``fused_interval``, K3
on the qwen2-7b serving path, K5 on the mamba2-1.3b one, K4 on the
hubert-xlarge encoder path, K6 on the deepseek-moe-16b one) beside its
times at that path's shapes; ``arima_chunk`` also lists, under
``paths``, its launches on the detector bank's path (phase 23, beside its
times at 1 024 streams), on ``run_experiment``'s Demeter cells (phase
24) and on the fleet soak (phase 27, beside its times at the soak's
forecast shape). ``fused_tick`` and ``rls_update`` keep their
phase-3 times with the launches the Demeter path counted, and K7, which
no model of the reference calls, those counted on the deepseek-moe-16b
run: the script fails unless these three are 0. Beside the list,
``training`` holds every kernel's launches over phase 28's first step and
over the whole phase: all 0, or the script fails.

    python3 chip_smoke.py                     # from the root of a checkout
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NoReturn

REPO = Path(__file__).resolve().parent

#: H100 SXM data sheet: HBM3 bandwidth and the rates outside the tensor
#: cores (the kernels here do scalar float64 / float32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
#: H100 SXM data sheet: dense TF32 tensor-core rate, the SSD scan's peak
TF32_OPS_PER_S = 494.7e12
#: H100 SXM data sheet: dense bf16 tensor-core rate
BF16_OPS_PER_S = 989.4e12

#: Row counts the fused-tick check uses; 288 is the baseline path's width,
#: and the Demeter main path's own row count is added.
KERNEL_ROWS = (3, 37, 288, 65_536)
BASELINE_ROWS = 288
LAM, THRESH, DT = 0.995, 3.0, 5.0
#: float64 operations per row of one fused tick, counted from
#: csrc/fused_tick.cu (log1p counted as one): lag update 7, prediction and
#: error 5, flag 2, Pphi 6, quadratic form and denominator 4, gains 2,
#: weights 4, covariance 12.
FUSED_TICK_OPS_PER_ROW = 42
#: (rows, ticks) of the fused-interval checks: the Demeter path's width
#: and the baseline's at an interval of 12 ticks (a 60-s decision interval
#: at dt = 5 s), a one-tick interval and a long one.
INTERVAL_SHAPES = ((8, 12), (288, 12), (37, 1), (37, 100))
#: ticks of a decision interval on the main paths (60 s at dt = 5 s), and
#: of the chunk the kernels line reports K1 at
MAIN_INTERVAL = MAIN_CHUNK = 12
#: float64 operations per row and tick of one fused interval: the metrics
#: as step_batch_arrays writes them 60 (noise and capacity 4, lag update 9,
#: throughput 2, utilisation and rho 6, base latency 5, backlog 2, memory
#: per slot 2, GC penalty 5, noisy latency and its cap 7, CPU usage 5,
#: state, memory need and fraction 10, memory usage 2, down 1), the
#: detector 35 as FUSED_TICK_OPS_PER_ROW counts it and the trigger count 1.
FUSED_INTERVAL_OPS_PER_ROW_TICK = 96
#: bytes of state and config a row (112 read: lag, w, P, y, trig and five
#: config operands; 72 written: lag, w, P, y, trig) and a row and tick
#: (34 of planes in, 72 of metrics out)
INTERVAL_BYTES_PER_ROW, INTERVAL_BYTES_PER_ROW_TICK = 184, 106
#: Rows and orders the RLS check uses (k = p_max + 1 of the forecast bank:
#: 5, 9 and 17); the Demeter main path's own row count is added.
RLS_ROWS = (16, 288, 65_536)
RLS_ORDERS = (5, 9, 17)
#: streams and chunk lengths of the ARIMA-chunk checks, at each of
#: RLS_ORDERS: the Demeter path's width and the baseline's; a short flush,
#: the sweep's usual one (~12 ticks between reads) and a full queue
CHUNK_STREAMS, CHUNK_TICKS = (8, 288), (4, 12, 128)
#: the forecast bank's default ARIMA order p = 8 gives k = 9
MAIN_K = 9
#: K1 at the detector bank's shapes: a chunk of one tick a sample, order
#: p = 4 (k = 5), d = 1; two streams in a profiling clone's RecoveryTracker
#: (throughput and consumer lag) and the fleet service's slab of 1 024
DETECTOR_K, DETECTOR_CHUNKS = 5, ((2, 1), (1024, 1))
#: Phase 23: the fleet's slab (FleetConfig.capacity) over 18 h of its 60 s
#: epochs; the first DETECTOR_SCALAR streams also through MetricDetector;
#: the state is held one sample at a time from the CPU bank's state at
#: every DETECTOR_CHECK_EVERY-th sample
DETECTOR_STREAMS, DETECTOR_SAMPLES = 1024, 1080
DETECTOR_SCALAR, DETECTOR_CHECK_EVERY = 64, 108
#: Phase 24: the paper's per-cell protocol, each method on each trace
PAPER_METHODS = ("static", "reactive", "ds2", "demeter")
#: Phase 25: run_experiment card against CPU (ysb, 2 h, seed 3)
PROTOCOL_CARD_VS_CPU = (2 * 3600.0, 3)
#: Demeter main path width: paper seeds (2 scenarios each; seed 0 alone is
#: the paper's own two 18 h runs, §3.4, Figs. 5-6). On NVIDIA H100 80GB
#: HBM3, 700.00 W the path took 75.0 s at 1 seed and 153.0 s at 3 (about
#: 39 s a seed, nearly all host-bound GP fits). With every later phase the
#: whole script took 589.4 s and, on a slower host, 822.2 s: inside the
#: 1200-s limit, though not inside half of it on the slower host.
DEMETER_SEEDS = 4
#: Phase 3's second GP-fit row: 8 members of 129-256 points (n_max 256),
#: where the fit kernel keeps its n x n factors in global scratch
GP_FIT_LARGE = (8, 5, (129, 257))
#: Phase 3's GP-fit rows at the tiled body's sizes (d = 5, 2 restarts,
#: ``gp_datasets`` as phase 5 builds them): (label, members, seed, sizes).
#: The first is the kernels line's row. Phase 6 counts the Demeter path's
#: launches by rows x n_max: on an H100 at 4 seeds, 254 of 361 were 2 rows
#: (one member's restarts) at n_max 8, 40 were 2 x 16, none above n_max 32.
GP_FIT_SHAPES = (("96 members at n_max 64", 96, 12, (3, 61)),
                 ("3 members at n_max 32", 3, 12, (17, 33)),
                 ("96 members at n_max 32", 96, 12, (3, 33)),
                 ("96 members at n_max 16", 96, 12, (3, 17)),
                 ("1 member at n_max 8", 1, 12, (3, 9)))
#: Phase 5: the members of ``gp_datasets(96, 12)`` on which the bank's
#: optimizer (optax's L-BFGS, the reference's) stops at another optimum
#: than the scalar fit's scipy L-BFGS-B, so that the reference's own bank
#: misses the 5% bar there (``tests/test_torch_gp.py`` shows it on the
#: CPU); each is held to the port's bank on the CPU instead
OTHER_OPTIMA = frozenset({49})

SWEEP_ARRAYS = ("rates", "latencies", "usage_cpu", "usage_mem_mb", "workers",
                "consumer_lag")

#: The serving main path: qwen2-7b (28 layers, 28 query heads over 4 KV
#: heads of 128) at full width in bfloat16, 16 slots of 4096 positions, 32
#: requests of 256-2048 prompt tokens and 64 new tokens each.
SERVE_ARCH = "qwen2_7b"
SERVE_SLOTS, SERVE_MAX_LEN = 16, 4096
SERVE_REQUESTS, SERVE_PROMPTS, SERVE_NEW_TOKENS = 32, (256, 2048), 64
#: The state-space serving paths: mamba2-1.3b (48 mamba2 layers, 64 heads
#: of 64, state 128) with the qwen2-7b path's traffic, and zamba2-2.7b (54
#: mamba2 layers of 80 heads, state 64, and a shared attention block every
#: 6) with half of it; both at full width in bfloat16, 16 slots of 4096.
SSM_ARCH, HYBRID_ARCH = "mamba2_1p3b", "zamba2_2p7b"
SSM_REQUESTS, SSM_NEW_TOKENS = SERVE_REQUESTS, SERVE_NEW_TOKENS
HYBRID_REQUESTS, HYBRID_NEW_TOKENS = 16, 32
#: card against CPU: (arch, layers, requests, prompt lengths, new tokens);
#: prompts of 300-700 tokens cross the SSD chunk of 256 on the card
CARD_VS_CPU = {SERVE_ARCH: (2, 4, (16, 32), 8),
               SSM_ARCH: (2, 4, (300, 700), 8),
               HYBRID_ARCH: (6, 2, (300, 700), 8)}
#: K3's checks: the serving shapes in both dtypes, then a sweep over groups
#: and head dims; bars against the plain version (which rounds the softmax
#: weights to bf16 before the weighted sum, where the kernel keeps float32)
ATTN_BARS = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_SWEEP_GROUPS, ATTN_SWEEP_DIMS = (1, 4, 7), (14, 64, 96, 128, 256)
#: K5's bars against its plain version (atol and rtol): the reference's
#: own in float32, and in bf16 the output's rounding to bf16
SSD_BARS = {"float32": 5e-5, "bfloat16": 2e-2}
#: the reference tests' shapes (tests/test_kernels.py::TestSSDScan: B, S,
#: H, P, G, N, chunk), a ragged chunk of 20 and the smoke configs' 16
SSD_TEST_SHAPES = ((2, 512, 4, 64, 1, 128, 128), (1, 256, 8, 64, 2, 128, 256),
                   (2, 256, 4, 64, 4, 128, 128), (1, 100, 3, 32, 1, 32, 20),
                   (2, 64, 4, 16, 1, 16, 16))
#: The cacheless forward: hubert-xlarge (48 layers, 16 heads of 80,
#: bidirectional) encodes 8 clips of 4096 frames (82 s of audio each at
#: 50 Hz), 3 times after a warm-up; pixtral-12b (40 layers, 32 query heads
#: over 8 of 128, causal) takes the training loss of 2 sequences of 4096
#: tokens with its 512-patch prefix; both at full width in bfloat16
ENCODER_ARCH, VLM_ARCH = "hubert_xlarge", "pixtral_12b"
ENCODE_CLIPS, ENCODE_FRAMES, ENCODE_CALLS = 8, 4096, 3
VLM_BATCH, VLM_SEQ = 2, 4096
#: card against CPU: (layers, batch, sequence, patch prefix); 300 frames
#: end in a partial tile of K4
ENCODER_CARD_VS_CPU = (2, 2, 300, 0)
VLM_CARD_VS_CPU = (2, 1, 256, 64)
#: The training path (phase 28): deepseek-7b at full width in bfloat16, cut
#: to 2 layers, as the reference's examples/train_elastic.py wires it
#: (int8 error-feedback compression), with 2 microbatches, batches of
#: TRAIN_BATCH x TRAIN_SEQ tokens, a checkpoint every TRAIN_CKPT_EVERY steps
#: and a failure after TRAIN_FAIL_AFTER steps (restore, replay, train on to
#: TRAIN_UNTIL); phase 29 runs the smoke config card against CPU
TRAIN_ARCH = "deepseek_7b"
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_CKPT_EVERY, TRAIN_FAIL_AFTER, TRAIN_UNTIL = 4, 6, 8
TRAIN_CKPT = REPO / "build" / "train_ckpt"
TRAIN_CARD_VS_CPU = (4, 32, 4)       # batch, sequence, steps
#: card against CPU: losses, grad norms and final parameters (of each
#: tensor's scale), float32 with TF32 off
TRAIN_CARD_VS_CPU_BAR = 1e-5
#: K4's checks (B, Sq, Hq, Hkv, D, causal): the reference tests' shapes
#: (tests/test_kernels.py::TestFlashAttention) in float32, both causal
#: settings; gemma's head dim of 256 and a ragged length of 300 in both
#: dtypes; bars as K3's (ATTN_BARS), atol and rtol
FLASH_TEST_SHAPES = ((2, 256, 4, 2, 64), (1, 128, 8, 8, 128),
                     (2, 256, 4, 1, 64), (1, 384, 2, 2, 256))
FLASH_EXTRA_SHAPES = ((1, 512, 16, 16, 256, True), (2, 300, 16, 16, 80, False),
                      (2, 300, 32, 8, 128, True))
#: one layer of the reference's prefill_32k cell for the encoder
#: (launch/dryrun.py) at batch 1: 32 768 frames, hubert's heads
PREFILL_32K = 32_768
#: The MoE serving paths, with phase 8's engine and traffic, at full width
#: in bfloat16: deepseek-moe-16b (28 layers of 16 heads of 128; layer 0 a
#: dense FFN of 10 944, the rest 64 routed experts of 1 408, top-6, and 2
#: shared) and deepseek-v2-lite-16b (27 layers of multi-head latent
#: attention, a 512-wide latent and a 64-wide RoPE key a token)
MOE_ARCH, MLA_ARCH = "deepseek_moe_16b", "deepseek_v2_lite_16b"
CARD_VS_CPU.update({MOE_ARCH: (2, 4, (16, 32), 8),
                    MLA_ARCH: (2, 4, (16, 32), 8)})
#: K6's bars against its plain version, relative to the output's scale:
#: float32 sums in another order; in bf16 one rounding of each either way
GMM_BARS = {"float32": 1e-4, "bfloat16": 2e-2}
#: the reference tests' K6 shapes (tests/test_kernels.py::TestGroupedMatmul:
#: tokens, E, K, N), one expert a token, blk_m 128, float32
GMM_TEST_SHAPES = ((300, 4, 128, 256), (1000, 8, 256, 128),
                   (64, 2, 128, 128))
#: K7's shapes: the reference tests' (tests/test_kernels.py::
#: TestFusedRMSNorm), and 16 x 4096 rows of deepseek's 2048 (timed)
RMSNORM_SHAPES = ((4, 37, 512), (2, 256, 128), (7, 64))
RMSNORM_MAIN = (SERVE_SLOTS * SERVE_MAX_LEN, 2048)
#: The K6 route against the capacity buffer's einsums at full depth in
#: bf16: last prefill logits within 2e-2 of their scale, the bf16 bar of
#: phase 3. Both routes round each product once from float32 sums; on the
#: H100 the two prompts' logits came out equal on both MoE models.
MOE_ROUTE_BAR = 2e-2
#: one absorbed MLA decode step against the naive path from the same
#: cache, bf16 (the two round at different places): 2e-2 of the scale
MLA_ABSORBED_BAR = 2e-2
#: kernels that no model of the reference calls: every serving path counts
#: their launches and must count none
NO_MODEL_PATH = ("fused_rmsnorm",)
#: the direct counterparts of the Pallas K2 and K1, checked in phase 3; the
#: paths launch fused_interval and arima_chunk instead, and the Demeter
#: path must count none of these
PER_TICK_KERNELS = ("fused_tick", "rls_update")


def kernel_module(name: str):
    """The module ``repro_torch.kernels.<name>``: the package exports the
    wrapper of the same name, which shadows the module as an attribute."""
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def fail(msg: str) -> NoReturn:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def device_ms(fn, n: int = 60, warmup: int = 10, host_n: int = 100) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, in ms.

    Before each call a sleep kernel holds the stream while the host
    enqueues the call between its pair of events, so the events measure
    the device's work and not the host's dispatch (timed first over
    ``host_n`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = host_ms(fn, n=host_n) * 1e-3
    # at most ~2 GHz: this many cycles outlast twice the host's enqueue time
    cycles = int(4e9 * host_s) + 200_000
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_ms(fn, n: int = 100) -> float:
    """Mean wall time per call of ``fn`` when called back to back, in ms
    (what a caller on the host waits: dispatch included)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate, whichever is larger."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


#: registers and spills of each kernel function as ``nvcc -Xptxas -v``
#: reported them when phase 2 built it, by "name<template ints>"
PTXAS: dict = {}


def template_args(rest: str) -> list:
    """The template arguments at the head of the rest of a mangled name
    (``I...E``): integers (``Li64E``), float and double, and class types
    (``13__nv_bfloat16``)."""
    import re
    args = []
    if not rest.startswith("I"):
        return args
    j = 1
    while j < len(rest) and rest[j] != "E":
        m = re.match(r"Li(\d+)E", rest[j:])
        d = re.match(r"\d+", rest[j:])
        if m:
            args.append(m.group(1))
            j += m.end()
        elif rest[j] in "fd":
            args.append({"f": "float", "d": "double"}[rest[j]])
            j += 1
        elif d:
            args.append(rest[j + d.end():j + d.end() + int(d.group())])
            j += d.end() + int(d.group())
        else:
            break
    return args


def ptxas_table(log: str) -> dict:
    """Each entry function of a ``-Xptxas -v`` log: its registers and spill
    bytes, under its name and template arguments (as
    ``flash_wgmma_kernel<80>`` or ``ssd_state_kernel<float,64,128>``)."""
    import re
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:   # the mangled name: length-prefixed identifiers (a hash
            # before one may end in digits, so try each digit start)
            mangled, name = m.group(1), m.group(1)
            for i in range(len(mangled)):
                d = re.match(r"\d+", mangled[i:])
                j = i + d.end() if d else i
                ident = mangled[j:j + int(d.group())] if d else ""
                if ident.endswith("_kernel") \
                        and re.fullmatch(r"[A-Za-z_]\w*", ident):
                    args = template_args(mangled[j + len(ident):])
                    name = ident + (f"<{','.join(args)}>" if args else "")
                    break
            table[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            table[name]["spill_stores"] = int(m.group(1))
            table[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name]["registers"] = int(m.group(1))
    return table


def ptxas_of(*names: str) -> dict:
    """The phase-2 ``-Xptxas -v`` figures of the named kernel functions."""
    return {n: PTXAS.get(n, "not in the build log") for n in names}


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def tick_operands(n: int, seed: int, device):
    """Random fused-tick operands shaped like the main path's."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = dict(lag=rng.uniform(0.0, 1e5, n), lag_add=rng.uniform(0.0, 1e4, n),
             rates=rng.uniform(1e4, 9e4, n), cap=rng.uniform(1e4, 8e4, n),
             down_pre=rng.random(n) < 0.3, w=rng.normal(size=(n, 2)) * 0.1,
             P=np.broadcast_to(10.0 * np.eye(2), (n, 2, 2)).copy(),
             y_prev=rng.uniform(0.0, 12.0, n))
    return {k: torch.from_numpy(v).to(device) for k, v in a.items()}


def check_fused_tick(n: int) -> dict:
    """The CUDA fused tick against its plain version on ``n`` rows."""
    import torch
    from repro_torch.kernels import fused_tick as kmod
    from repro_torch.kernels.ref import fused_tick_ref
    ops = tick_operands(n, seed=n, device="cuda")
    got = kmod.fused_tick(**ops, lam=LAM, thresh=THRESH, dt=DT)
    torch.cuda.synchronize()
    want = fused_tick_ref(**ops, lam=LAM, thresh=THRESH, dt=DT)
    if not torch.equal(got[0], want[0]):
        fail(f"fused_tick B={n}: new_lag differs from the plain version "
             f"(max {float((got[0] - want[0]).abs().max())})")
    for g, r, name in zip(got[1:4], want[1:4], ("w'", "P'", "err")):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12,
                                   msg=f"fused_tick B={n}: {name}")
    if not torch.equal(got[4], want[4]):
        fail(f"fused_tick B={n}: flag differs from the plain version")
    max_err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip(got, want))
    n_bytes = sum(t.numel() * t.element_size() for t in ops.values()) \
        + sum(t.numel() * t.element_size() for t in got)
    call = lambda: kmod.fused_tick(**ops, lam=LAM, thresh=THRESH,  # noqa
                                   dt=DT)
    plain = lambda: fused_tick_ref(**ops, lam=LAM, thresh=THRESH,  # noqa
                                   dt=DT)
    return {"rows": n, "max_abs_err": max_err, "bytes": n_bytes,
            "ms": device_ms(call), "plain_ms": device_ms(plain),
            "dispatch_ms": host_ms(call), "plain_dispatch_ms": host_ms(plain),
            **bound(n_bytes, FUSED_TICK_OPS_PER_ROW * n, FP64_OPS_PER_S)}


def rls_operands(B: int, k: int, dtype, device):
    """Random symmetric positive definite covariances, regressors and
    forgetting factors (the reference's own test case, widened)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(B * 100 + k)
    a = rng.normal(0, 1, (B, k, k))
    P = a @ a.transpose(0, 2, 1) + np.eye(k)
    phi = rng.normal(0, 1, (B, k))
    lam = np.full(B, 0.995)
    return [torch.as_tensor(v, dtype=dtype, device=device)
            for v in (P, phi, lam)]


def check_rls(B: int, k: int, dtype) -> dict:
    """The CUDA RLS step against its plain version: error relative to the
    largest magnitude of each output, at most 1e-12 in float64 (the
    reference's bar for its kernel) and 1e-5 in float32."""
    import torch
    from repro_torch.kernels import rls_update as kmod
    from repro_torch.kernels.ref import rls_rank1_update_ref
    P, phi, lam = rls_operands(B, k, dtype, "cuda")
    got = kmod.rls_rank1_update(P, phi, lam)
    torch.cuda.synchronize()
    want = rls_rank1_update_ref(P, phi, lam)
    rel = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got, want))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    name = f"rls_update B={B} k={k} {str(dtype).split('.')[-1]}"
    if not rel <= tol:
        fail(f"{name}: relative error {rel} exceeds {tol}")
    max_err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    item = P.element_size()
    call = lambda: kmod.rls_rank1_update(P, phi, lam)  # noqa: E731
    plain = lambda: rls_rank1_update_ref(P, phi, lam)  # noqa: E731
    return {"rows": B, "k": k, "dtype": str(dtype).split(".")[-1],
            "max_rel_err": rel, "max_abs_err": max_err,
            "ms": device_ms(call), "plain_ms": device_ms(plain),
            "dispatch_ms": host_ms(call), "plain_dispatch_ms": host_ms(plain),
            **bound(item * (2 * k * k + 2 * k + 1) * B,
                    (5 * k * k + 2 * k) * B,
                    FP64_OPS_PER_S if dtype == torch.float64
                    else FP32_OPS_PER_S)}


@contextlib.contextmanager
def per_tick_kernels():
    """The path before the interval and chunk kernels, as the yardstick of
    their time: the plain versions' loops with the per-tick kernels (K2's
    ``fused_tick``, K1's ``rls_rank1_update``) in place of the plain tick
    and the plain RLS step, as ``dsp/fused.py`` and the forecast bank ran
    them."""
    from repro_torch.kernels import fused_tick as k2
    from repro_torch.kernels import ref
    from repro_torch.kernels import rls_update as k1
    saved = ref.fused_tick_ref, ref.rls_rank1_update_ref
    ref.fused_tick_ref, ref.rls_rank1_update_ref = (k2.fused_tick,
                                                    k1.rls_rank1_update)
    try:
        yield
    finally:
        ref.fused_tick_ref, ref.rls_rank1_update_ref = saved


def slow_ms(fn) -> dict:
    """Device time and host wall per call of a path of hundreds of small
    launches (a plain version, the per-tick path), from few calls."""
    return {"device": device_ms(fn, n=8, warmup=2, host_n=4),
            "host": host_ms(fn, n=4)}


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN payloads included (``torch.equal`` calls two
    NaNs different)."""
    import torch
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.shape == b.shape and torch.equal(a, b)


def interval_operands(S: int, K: int, seed: int, device):
    """One fused-engine interval's operands: the state mid-run, mixed
    configs, rows down before and after ticks (z2 = 0 where down after, as
    the host draws it) and rollback lag on some ticks."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    down_pre = rng.random((K, S)) < 0.15
    down_post = down_pre & (rng.random((K, S)) < 0.7)
    z2 = np.abs(rng.normal(size=(K, S)))
    z2[down_post] = 0.0
    a = dict(
        lag=rng.uniform(0.0, 2e5, S) * (rng.random(S) < 0.6),
        det_w=rng.normal(size=(S, 2)) * 0.1,
        det_p=np.broadcast_to(10.0 * np.eye(2), (S, 2, 2)).copy(),
        det_y=rng.uniform(0.0, 12.0, S),
        det_trig=rng.integers(0, 5, S).astype(np.int64),
        rates=rng.uniform(1e4, 9e4, (K, S)),
        lag_add=rng.uniform(0.0, 5e4, (K, S)) * (rng.random((K, S)) < 0.1),
        down_pre=down_pre, down_post=down_post,
        z1=rng.normal(size=(K, S)), z2=z2,
        workers=rng.integers(1, 25, S).astype(np.float64),
        cpu_cores=rng.integers(1, 5, S).astype(np.float64),
        memory_mb=rng.choice([1024.0, 2048.0, 4096.0], S),
        task_slots=rng.integers(1, 4, S).astype(np.float64),
        cap_base=rng.uniform(1e4, 8e4, S))
    return {k: torch.from_numpy(v).to(device) for k, v in a.items()}


INTERVAL_STATE = ("lag", "det_w", "det_p", "det_y", "det_trig")
INTERVAL_REST = ("rates", "lag_add", "down_pre", "down_post", "z1", "z2",
                 "workers", "cpu_cores", "memory_mb", "task_slots",
                 "cap_base")


def check_fused_interval(S: int, K: int) -> dict:
    """The CUDA fused interval against its plain version on ``S`` rows and
    ``K`` ticks: lag and the nine metrics bit for bit, the detector within
    1e-12 with equal trigger counts, the same bits on a second call; timed
    beside the plain version and the per-tick path it replaces."""
    import torch
    from repro_torch.dsp import ClusterModel
    from repro_torch.kernels import fused_tick as kmod
    from repro_torch.kernels.ref import METRIC_KEYS, fused_interval_ref
    t = interval_operands(S, K, seed=S * 1000 + K, device="cuda")
    model = ClusterModel()
    rest = [t[k] for k in INTERVAL_REST]

    def run(fn, state=None):
        state = state or [t[k].clone() for k in INTERVAL_STATE]
        return fn(model, *state, *rest, LAM, THRESH, DT), state
    got, got_state = run(kmod.fused_interval)
    torch.cuda.synchronize()
    want, want_state = run(fused_interval_ref)
    name = f"fused_interval S={S} K={K}"
    for q, key in enumerate(METRIC_KEYS):
        if not torch.equal(got[q], want[q]):
            fail(f"{name}: {key} differs from the plain version (max "
                 f"{float((got[q] - want[q]).abs().max())})")
    if not torch.equal(got_state[0], want_state[0]):
        fail(f"{name}: lag differs from the plain version")
    for key, g, r in zip(INTERVAL_STATE[1:4], got_state[1:4],
                         want_state[1:4]):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12,
                                   msg=f"{name}: {key}")
    if not torch.equal(got_state[4], want_state[4]):
        fail(f"{name}: trigger counts differ from the plain version")
    again, again_state = run(kmod.fused_interval)
    torch.cuda.synchronize()
    if not (same_bits(again, got) and all(
            same_bits(a, g) for a, g in zip(again_state, got_state))):
        fail(f"{name}: a second call gave other bits")
    max_err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip([got, *got_state], [want, *want_state]))
    state = [t[k].clone() for k in INTERVAL_STATE]   # advanced by the timing
    call = lambda: run(kmod.fused_interval, state)  # noqa: E731
    plain = slow_ms(lambda: run(fused_interval_ref, state))
    with per_tick_kernels():
        old = slow_ms(lambda: run(fused_interval_ref, state))
    n_bytes = S * (INTERVAL_BYTES_PER_ROW + INTERVAL_BYTES_PER_ROW_TICK * K)
    return {"rows": S, "ticks": K, "max_abs_err": max_err, "bytes": n_bytes,
            "ms": device_ms(call), "dispatch_ms": host_ms(call),
            "plain_ms": plain["device"], "plain_dispatch_ms": plain["host"],
            "per_tick_path_ms": old["device"],
            "per_tick_path_host_ms": old["host"],
            **bound(n_bytes, FUSED_INTERVAL_OPS_PER_ROW_TICK * S * K,
                    FP64_OPS_PER_S),
            "ptxas": ptxas_of("fused_interval_kernel")}


def chunk_operands(B: int, k: int, T: int, seed: int, device,
                   defaults: bool = False):
    """The ARIMA family's state after a 40-tick warm-up and a (T, B) chunk
    of ticks in thousands of events/s: orders p up to k - 1, depths 1 and
    2, 5% NaN gaps, two padding ticks at the end of a chunk of 4 or more,
    and one stream whose 1e308 spike overflows its next step (the
    divergence reset). ``defaults`` gives every stream the banks' default
    model instead (p = k - 1, d = 1: one tail, forgetting 0.995, ridge 10;
    the detector's at k = 5, the fleet's forecaster at k = 9) and no
    spike.
    Returns (state, params with the trace cap, vals)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import arima_chunk_ref
    rng = np.random.default_rng(seed)
    p = rng.integers(1, k, B)
    p[0] = k - 1
    d = rng.integers(1, 3, B)
    ridge = rng.uniform(1.0, 20.0, B)
    lam = rng.uniform(0.97, 1.0, B)
    if defaults:
        p, d = np.full(B, k - 1), np.ones(B, np.int64)
        ridge, lam = np.full(B, 10.0), np.full(B, 0.995)
    ts = np.arange(T + 40)[:, None]
    vals = 40.0 + 8.0 * np.sin(2 * np.pi * ts / 37.0 + rng.uniform(0, 6, B)) \
        + rng.normal(0, 0.5, (T + 40, B))
    vals[rng.random(vals.shape) < 0.05] = np.nan
    chunk = vals[40:]
    if T >= 4:
        chunk[-2:] = np.nan
    spike = max(T - 4, 0)
    if not defaults:
        chunk[spike, -1] = 1e308
        if spike + 1 < T:
            chunk[spike + 1, -1] = 40.0
    f64 = dict(dtype=torch.float64, device=device)
    state = [torch.zeros((B, k), **f64),
             torch.as_tensor(ridge[:, None, None] * np.eye(k), **f64),
             torch.zeros((B, k - 1), **f64),
             torch.zeros((B, 1 if defaults else 2), **f64),
             torch.zeros(B, dtype=torch.int64, device=device),
             torch.zeros(B, **f64)]
    params = [torch.as_tensor(p, device=device),
              torch.as_tensor(d, device=device), torch.as_tensor(lam, **f64),
              torch.as_tensor(ridge, **f64)]
    cap = params[3] * (params[0] + 1).double() * 1e4    # P_TRACE_CAP
    arima_chunk_ref(*state, *params, cap, torch.as_tensor(vals[:40], **f64))
    return state, params + [cap], torch.as_tensor(chunk, **f64)


def rel_by_stream(got, want, stream_dim: int = 0, also=None) -> float:
    """The largest difference relative to each stream's largest finite
    magnitude in ``want`` (and in ``also``, where given: the same array
    before the step that made ``want``); fails unless the non-finite
    entries match in place."""
    import torch
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        fail("non-finite entries differ from the plain version's")
    mag = want.abs() if also is None else torch.maximum(want.abs(),
                                                        also.abs())
    g, w, f, m = (x.movedim(stream_dim, 0).reshape(x.shape[stream_dim], -1)
                  for x in (got, want, fin, mag))
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    scale = torch.where(f & torch.isfinite(m), m, zero).amax(1) \
        .clamp_min(1e-300)
    return float((torch.where(f, (g - w).abs(), zero).amax(1) / scale).max())


def arima_design(k: int) -> str:
    """The arima_chunk instantiation that runs order k (csrc dispatch)."""
    kc = k if k in (5, 9, 17) else 32 if k <= 32 else 64
    return f"arima_chunk_kernel<{kc}>"


def check_arima_chunk(B: int, k: int, T: int, model: str = "forecast bank"
                      ) -> dict:
    """The CUDA ARIMA chunk against its plain version: every output within
    1e-12 of each stream's scale, do_rls and count equal, the same bits on
    a second call, no spill at the bank's orders; timed beside the plain
    version and the per-tick path it replaces. ``model``: "forecast bank"
    (mixed orders and depths), or "detector" / "fleet forecaster" (the
    banks' default model, see :func:`chunk_operands`)."""
    import torch
    from repro_torch.kernels import rls_update as kmod
    from repro_torch.kernels.ref import arima_chunk_ref
    state, params, vals = chunk_operands(
        B, k, T, seed=B * 1000 + k * 10 + T, device="cuda",
        defaults=model != "forecast bank")

    def run(fn, st=None):
        st = st or [x.clone() for x in state]
        return fn(*st, *params, vals), st
    (resid, do), got_state = run(kmod.arima_chunk)
    torch.cuda.synchronize()
    (resid_r, do_r), want_state = run(arima_chunk_ref)
    name = f"arima_chunk B={B} k={k} T={T}"
    if not torch.equal(do, do_r):
        fail(f"{name}: do_rls differs from the plain version")
    rels = {"resid": rel_by_stream(resid, resid_r, stream_dim=1)}
    for key, g, r in zip(("w", "P", "lags", "tails", "count", "last"),
                         got_state, want_state):
        if g.dtype == torch.int64:
            if not torch.equal(g, r):
                fail(f"{name}: {key} differs from the plain version")
        else:
            rels[key] = rel_by_stream(g, r)
    worst = max(rels.values())
    if not worst <= 1e-12:
        fail(f"{name}: relative error {rels} exceeds 1e-12")
    (resid2, do2), again_state = run(kmod.arima_chunk)
    torch.cuda.synchronize()
    if not (same_bits(resid2, resid) and same_bits(do2, do) and all(
            same_bits(a, g) for a, g in zip(again_state, got_state))):
        fail(f"{name}: a second call gave other bits")
    design = arima_design(k)
    spill = PTXAS.get(design, {}).get("spill_stores")
    if spill is None or spill > 0:
        fail(f"{name}: {design} spills ({PTXAS.get(design)})")
    fin = torch.isfinite(resid) & torch.isfinite(resid_r)
    max_err = max([float((resid - resid_r)[fin].abs().max())]
                  + [float((g - r).double().abs().max())
                     for g, r in zip(got_state, want_state)
                     if torch.isfinite(r).all()])
    n_state = sum(x.numel() * x.element_size() for x in state)
    n_bytes = 2 * n_state + sum(x.numel() * x.element_size()
                                for x in params) + 17 * T * B
    n_valid = int(torch.isfinite(vals).sum())
    st = [x.clone() for x in state]        # advanced by the timing
    call = lambda: run(kmod.arima_chunk, st)  # noqa: E731
    plain = slow_ms(lambda: run(arima_chunk_ref, st))
    with per_tick_kernels():
        old = slow_ms(lambda: run(arima_chunk_ref, st))
    return {"streams": B, "k": k, "ticks": T,
            "model": model,
            "max_rel_err": worst,
            "max_abs_err": max_err, "bytes": n_bytes,
            "ms": device_ms(call), "dispatch_ms": host_ms(call),
            "plain_ms": plain["device"], "plain_dispatch_ms": plain["host"],
            "per_tick_path_ms": old["device"],
            "per_tick_path_host_ms": old["host"],
            **bound(n_bytes, (8 * k * k + 8 * k) * n_valid, FP64_OPS_PER_S),
            "ptxas": ptxas_of(design)}


def attention_operands(B: int, S: int, Hkv: int, G: int, D: int, dtype,
                       seed: int = 0):
    """Random decode-attention operands on the card, in the cache's layout,
    with ragged lengths that include 0, 1 and S_max (a batch of fewer than
    three rows: S_max first)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, shape), dtype=dtype,
                               device="cuda")
               for shape in ((B, 1, Hkv * G, D), (B, S, Hkv, D),
                             (B, S, Hkv, D)))
    lengths = rng.integers(1, S + 1, B)
    special = [0, 1, S] if B >= 3 else [S]
    lengths[:len(special)] = special
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32,
                                    device="cuda")


def check_decode_attention(B: int, S: int, Hkv: int, G: int, D: int, dtype,
                           timed: bool) -> dict:
    """The CUDA decode attention against its plain version; with ``timed``
    also its device and dispatch times, the plain version's, the bound and
    ``scaled_dot_product_attention`` on the same inputs (the library call,
    timed only: it reads the whole cache, under a length mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import decode_attention_ref
    kmod = kernel_module("decode_attention")
    q, k, v, lengths = attention_operands(B, S, Hkv, G, D, dtype)
    got = kmod.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, lengths)
    err = float((got.float() - want.float()).abs().max())
    name = str(dtype).split(".")[-1]
    label = f"decode_attention B={B} S={S} Hkv={Hkv} G={G} D={D} {name}"
    if not err <= ATTN_BARS[name]:
        fail(f"{label}: max abs error {err} exceeds {ATTN_BARS[name]}")
    if int(lengths[0]) == 0 and got[0].any():
        fail(f"{label}: a row of length 0 is not zero")
    if not torch.equal(kmod.decode_attention(q, k, v, lengths), got):
        fail(f"{label}: a second call is not bit for bit the first")
    chunk, n_split = kmod.split_plan(
        B, S, Hkv, torch.cuda.get_device_properties(0).multi_processor_count)
    Dp = kmod.padded_head_dim(D)       # the width the kernel runs at
    pass1 = (f"decode_split_bf16_kernel<{Dp}>" if dtype == torch.bfloat16
             else f"decode_split_f32_kernel<{Dp},{1 << (G - 1).bit_length()}>")
    out = {"B": B, "S_max": S, "Hkv": Hkv, "G": G, "D": D, "dtype": name,
           "max_abs_err": err, "design": "split-kv", "chunk": chunk,
           "n_split": n_split,
           "ptxas": ptxas_of(pass1, "decode_merge_kernel")}
    call = lambda: kmod.decode_attention(q, k, v, lengths)  # noqa: E731
    out["ms"] = device_ms(call)
    if not timed:
        return out
    item = q.element_size()
    valid = int(lengths.clamp(0, S).sum())
    n_bytes = valid * Hkv * D * 2 * item + 2 * q.numel() * item \
        + lengths.numel() * 4
    # per valid position and query head: q.k and p.v, 2 D operations each
    # (the softmax's few per position are not counted)
    n_ops = 4 * D * valid * Hkv * G
    mask = (torch.arange(S, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    plain = lambda: decode_attention_ref(q, k, v, lengths)  # noqa: E731
    out.update({"valid_positions": valid, "bytes": n_bytes,
                "plain_ms": device_ms(plain), "library_ms": device_ms(library),
                "dispatch_ms": host_ms(call),
                "plain_dispatch_ms": host_ms(plain),
                **bound(n_bytes, n_ops, FP32_OPS_PER_S)})
    return out


def ssd_operands(B: int, S: int, H: int, P: int, G: int, N: int, dtype, *,
                 a_log_max: float, dt_max: float, seed: int = 0):
    """Random SSD-scan operands on the card: x, b, c normal in ``dtype``,
    dt uniform in [0.001, dt_max] and a_log in [0, a_log_max] (float32)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device="cuda")
    return (t(rng.normal(size=(B, S, H, P))),
            t(rng.uniform(0.001, dt_max, (B, S, H)), torch.float32),
            t(rng.uniform(0.0, a_log_max, H), torch.float32),
            t(rng.normal(size=(B, S, G, N))), t(rng.normal(size=(B, S, G, N))))


def check_ssd_scan(B: int, S: int, H: int, P: int, G: int, N: int,
                   chunk: int, dtype, *, a_log_max: float = 1.5,
                   dt_max: float = 0.1, timed: bool = False) -> dict:
    """The CUDA SSD scan against its plain version: ``y`` and the final
    state within ``SSD_BARS`` (atol and rtol) of the plain version's and
    finite (``bar_share_*``: the largest share of the bar an element
    uses); with ``timed`` also its device and dispatch times, the plain
    version's and the bound (FLOPs over the dense TF32 rate or bytes over
    HBM, the larger). No single PyTorch call computes the scan, so there is
    no library time."""
    import torch
    from repro_torch.kernels.ref import ssd_scan_ref
    kmod = kernel_module("ssd_scan")
    ops = ssd_operands(B, S, H, P, G, N, dtype, a_log_max=a_log_max,
                       dt_max=dt_max)
    got = kmod.ssd_scan(*ops, chunk=chunk)
    torch.cuda.synchronize()
    want = ssd_scan_ref(*ops, chunk)
    name = str(dtype).split(".")[-1]
    label = (f"ssd_scan B={B} S={S} H={H} P={P} G={G} N={N} Q={chunk} "
             f"{name} a_log<={a_log_max:.3f} dt<={dt_max}")
    tol = SSD_BARS[name]
    out = {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": chunk,
           "dtype": name, "a_log_max": a_log_max, "dt_max": dt_max}
    for key, g, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        g, w = g.float(), w.float()
        if not bool(g.isfinite().all()):
            fail(f"{label}: the kernel's {key} is not finite")
        err = (g - w).abs()
        out[f"max_abs_err_{key}"] = float(err.max())
        # the largest share of the bar tol + tol|plain| any element uses
        out[f"bar_share_{key}"] = share = float(
            (err / (tol * (1.0 + w.abs()))).max())
        if not share <= 1.0:
            fail(f"{label}: {key} differs from the plain version by "
                 f"{float(err.max())} (bar {tol} + {tol}|plain|)")
    out["max_abs_err"] = max(out["max_abs_err_y"], out["max_abs_err_state"])
    again = kmod.ssd_scan(*ops, chunk=chunk)
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        fail(f"{label}: a second call is not bit for bit the first")
    out["design"] = design = kmod.design(dtype, P, N, chunk)
    ctype = {"float32": "float", "bfloat16": "__nv_bfloat16"}[name]
    tc, t = (("_tc", f"<{N}>") if design == "tensor-cores"
             else ("", f"<{ctype},{P},{N}>"))
    out["ptxas"] = ptxas_of(f"ssd_state{tc}_kernel{t}", "ssd_pass_kernel",
                            f"ssd_output{tc}_kernel{t}")
    call = lambda: kmod.ssd_scan(*ops, chunk=chunk)  # noqa: E731
    out["ms"] = device_ms(call, n=20, warmup=3)
    if not timed:
        return out
    item = ops[0].element_size()
    q = chunk
    n_ops = B * (S // q) * (G * 2 * q * q * N
                            + H * (2 * q * q * P + 4 * q * P * N))
    n_bytes = (2 * B * S * H * P * item + 2 * B * S * G * N * item
               + B * S * H * 4 + H * 4 + B * H * P * N * 4)
    plain = lambda: ssd_scan_ref(*ops, chunk)  # noqa: E731
    out.update({"flops": n_ops, "bytes": n_bytes,
                "plain_ms": device_ms(plain, n=10, warmup=2),
                "library_ms": None, "dispatch_ms": host_ms(call, n=20),
                **bound(n_bytes, n_ops, TF32_OPS_PER_S)})
    return out


def flash_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs flash attention computes: all of them, or, when
    causal, key j <= query i (top-left aligned)."""
    if not causal:
        return sq * skv
    m = min(sq, skv)
    return m * (m + 1) // 2 + (sq - m) * skv


def check_flash_attention(B: int, Sq: int, Hq: int, Hkv: int, D: int, dtype,
                          causal: bool, *, timed: bool = False,
                          plain_rows: int = 0, n: int = 20) -> dict:
    """The CUDA flash attention against its plain version, every output
    within ``ATTN_BARS`` (atol and rtol) and finite; its device time; with
    ``timed`` also the plain version's, the bound (4 D operations per
    (query, key) pair over the bf16 or TF32 tensor-core rate, or each
    input read and the output written once over HBM, the larger) and
    ``scaled_dot_product_attention`` on the same values laid out as it
    wants them, ``(B, H, S, D)`` (the library call, timed only).
    ``plain_rows`` > 0 runs the plain version on that many query rows at a
    time (not causal only), where its float32 scores would not fit
    whole."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import flash_attention_ref
    kmod = kernel_module("flash_attention")
    g = torch.Generator(device="cuda").manual_seed(B * 7 + Sq + D)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((B, Sq, Hq, D), (B, Sq, Hkv, D),
                             (B, Sq, Hkv, D)))
    got = kmod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    label = (f"flash_attention B={B} S={Sq} Hq={Hq} Hkv={Hkv} D={D} {name} "
             f"{'causal' if causal else 'bidirectional'}")
    tol = ATTN_BARS[name]
    if not bool(got.isfinite().all()):
        fail(f"{label}: the kernel's output is not finite")
    err = share = 0.0
    step = plain_rows or Sq
    if plain_rows and causal:
        fail(f"{label}: the plain version by row blocks is not causal")
    for i in range(0, Sq, step):
        want = flash_attention_ref(q[:, i:i + step], k, v,
                                   causal=causal).float()
        diff = (got[:, i:i + step].float() - want).abs()
        err = max(err, float(diff.max()))
        share = max(share, float((diff / (tol * (1.0 + want.abs()))).max()))
        del want, diff
    if not share <= 1.0:
        fail(f"{label}: differs from the plain version by {err} (bar {tol} "
             f"+ {tol}|plain|)")
    design = kmod.design(D, dtype)
    fn = (f"flash_wgmma_kernel<{D}>" if design == "wgmma-tma" else
          f"flash_{'bf16' if dtype == torch.bfloat16 else 'f32'}_kernel"
          f"<{kmod.padded_head_dim(D)}>")
    out = {"B": B, "S": Sq, "Hq": Hq, "Hkv": Hkv, "D": D, "dtype": name,
           "causal": causal, "max_abs_err": err, "bar_share": share,
           "design": design, "ptxas": ptxas_of(fn)}
    call = lambda: kmod.flash_attention(q, k, v, causal=causal)  # noqa: E731
    out["ms"] = device_ms(call, n=n, warmup=3, host_n=n)
    if not timed:
        return out
    item = q.element_size()
    n_bytes = 2 * (q.numel() + k.numel()) * item
    n_ops = 4 * B * Hq * D * flash_pairs(Sq, Sq, causal)
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    plain = lambda: flash_attention_ref(q, k, v, causal=causal)  # noqa: E731
    out.update({"flops": n_ops, "bytes": n_bytes,
                "plain_ms": device_ms(plain, n=5, warmup=1, host_n=3),
                "library_ms": device_ms(library, n=n, warmup=3, host_n=n),
                "dispatch_ms": host_ms(call, n=n),
                **bound(n_bytes, n_ops, rate)})
    return out


def gmm_operands(n_tok: int, top_k: int, E: int, K: int, N: int, blk: int,
                 dtype, seed: int = 0):
    """The model path's grouped-matmul operands on the card: ``n_tok``
    tokens each routed to ``top_k`` distinct experts of ``E`` (uniformly,
    as random router weights route them), every assignment kept, sorted
    into the statically sized buffer of ``sort_assignments``; the tokens
    and the expert weights ``(E, K, N)`` drawn on the card from N(0, 1)
    and N(0, 1/K). Returns ``(lhs, rhs, sort, expert ids, tokens)``."""
    import torch
    from repro_torch.kernels.grouped_matmul import sort_assignments
    g = torch.Generator(device="cuda").manual_seed(seed)
    eids = torch.rand((n_tok, E), generator=g, device="cuda"
                      ).argsort(dim=1)[:, :top_k]
    flat_e = eids.T.reshape(-1)
    keep = torch.ones_like(flat_e, dtype=torch.bool)
    srt = sort_assignments(flat_e, keep, E, blk)
    x = torch.randn((n_tok, K), generator=g, device="cuda").to(dtype)
    lhs = torch.zeros((srt.rows + 1, K), dtype=dtype, device="cuda")
    lhs[srt.dest] = x.repeat(top_k, 1)
    rhs = (torch.randn((E, K, N), generator=g, device="cuda")
           / math.sqrt(K)).to(dtype)
    return lhs[:srt.rows], rhs, srt, flat_e, x


def grouped_mm_library(x, flat_e, rhs, top_k: int):
    """``torch._grouped_mm`` (bf16, group offsets) on the same products,
    the assignments packed by expert without padding: the library call of
    the kernel table, timed only. None where this torch has no such call
    or refuses these operands (the reason is printed)."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or x.dtype != torch.bfloat16:
        print("kernel grouped_matmul: no torch._grouped_mm for these "
              "operands", flush=True)
        return None
    order = torch.sort(flat_e, stable=True).indices
    a = x.repeat(top_k, 1)[order].contiguous()
    offs = torch.cumsum(torch.bincount(flat_e, minlength=rhs.shape[0]),
                        0).to(torch.int32)
    try:
        fn(a, rhs, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        print(f"kernel grouped_matmul: torch._grouped_mm refused "
              f"({str(e).splitlines()[0][:160]})", flush=True)
        return None
    return lambda: fn(a, rhs, offs=offs)  # noqa: E731


def check_grouped_matmul(n_tok: int, top_k: int, E: int, K: int, N: int,
                         blk: int, dtype, timed: bool = False) -> dict:
    """The CUDA grouped matmul against its plain version at one of the
    path's shapes: the largest difference relative to the plain version's
    scale within ``GMM_BARS`` (float32 sums in another order; in bf16 one
    rounding of each either way); tiles past the last group zero; its
    device time. With ``timed`` also the plain version's, the bound (the
    weights of every expert that owns a tile and each assignment's row of
    lhs and of the output, each moved once, over HBM; or 2 K N operations
    per assignment over the bf16 rate, the larger: padding rows are the
    kernel's layout, not the function's work), ``torch._grouped_mm`` (the
    library call) and the reference route's three batched products over
    its (E, C, d) capacity buffer at these shapes (``einsum_ms``: gate, up
    and down; timed only)."""
    import torch
    from repro_torch.kernels.ref import grouped_matmul_ref
    kmod = kernel_module("grouped_matmul")
    lhs, rhs, srt, flat_e, x = gmm_operands(n_tok, top_k, E, K, N, blk,
                                            dtype)
    te = srt.tile_expert
    got = kmod.grouped_matmul(lhs, rhs, te, blk_m=blk)
    torch.cuda.synchronize()
    want = grouped_matmul_ref(lhs, rhs, te, blk)
    name = str(dtype).split(".")[-1]
    label = (f"grouped_matmul tokens={n_tok} top_k={top_k} E={E} K={K} "
             f"N={N} blk_m={blk} {name}")
    if not bool(got.isfinite().all()):
        fail(f"{label}: the kernel's output is not finite")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rel = err / float(want.float().abs().max())
    if not rel <= GMM_BARS[name]:
        fail(f"{label}: differs from the plain version by {rel} of its "
             f"scale (bar {GMM_BARS[name]})")
    if got.view(-1, blk, N)[te < 0].any():
        fail(f"{label}: a tile past the last group is not zero")
    if not torch.equal(kmod.grouped_matmul(lhs, rhs, te, blk_m=blk), got):
        fail(f"{label}: a second call is not bit for bit the first")
    design = kmod.design(blk, dtype)
    fn = {"wgmma-tma": "gmm_wgmma_kernel", "mma.sync": "gmm_bf16_kernel",
          "cuda-cores": "gmm_f32_kernel"}[design]
    out = {"tokens": n_tok, "top_k": top_k, "E": E, "K": K, "N": N,
           "blk_m": blk, "rows": srt.rows, "dtype": name,
           "max_abs_err": err, "max_rel_err": rel, "design": design,
           "ptxas": ptxas_of(f"{fn}<{blk}>")}
    call = lambda: kmod.grouped_matmul(lhs, rhs, te, blk_m=blk)  # noqa: E731
    out["ms"] = device_ms(call, n=30, warmup=3)
    if not timed:
        return out
    item = lhs.element_size()
    used = int((te >= 0).sum())
    experts = int(torch.unique(te[te >= 0]).numel())
    n_bytes = (experts * K * N + flat_e.numel() * (K + N)) * item
    n_ops = 2 * flat_e.numel() * K * N
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    library = grouped_mm_library(x, flat_e, rhs, top_k)
    # the reference route: the capacity buffer's gate, up and down products
    cap = int(torch.bincount(flat_e, minlength=E).max())
    buf = torch.randn(E, cap, K, device="cuda").to(dtype)
    w_down = torch.randn(E, N, K, device="cuda").to(dtype)

    def einsums():
        g = torch.einsum("ecd,edf->ecf", buf, rhs)
        u = torch.einsum("ecd,edf->ecf", buf, rhs)
        return torch.einsum("ecf,efd->ecd", g * u, w_down)
    plain = lambda: grouped_matmul_ref(lhs, rhs, te, blk)  # noqa: E731
    out.update({"assignments": flat_e.numel(), "used_tiles": used,
                "experts_read": experts, "bytes": n_bytes, "flops": n_ops,
                "plain_ms": device_ms(plain, n=5, warmup=1, host_n=3),
                "library_ms": (device_ms(library, n=30, warmup=3)
                               if library is not None else None),
                "einsum_ms": device_ms(einsums, n=10, warmup=2, host_n=10),
                "dispatch_ms": host_ms(call, n=30),
                **bound(n_bytes, n_ops, rate)})
    return out


def check_fused_rmsnorm(shape, dtype, timed: bool = False) -> dict:
    """The CUDA fused RMSNorm against its plain version: y and s within
    1e-5 (atol and rtol) in float32 and one bf16 ulp of each element in
    bf16; its device time. With ``timed`` also the plain version's, the
    bound (x and res read, y and s written, once each, over HBM) and
    ``F.rms_norm(x + res, (d,), 1 + scale, eps)`` (the library yardstick,
    timed only; it does not return the sum)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as kmod
    from repro_torch.kernels.ref import fused_rmsnorm_ref
    g = torch.Generator(device="cuda").manual_seed(shape[-1])
    x, res = (torch.randn(shape, generator=g, device="cuda").to(dtype)
              for _ in range(2))
    scale = (0.1 * torch.randn(shape[-1:], generator=g, device="cuda")
             ).to(dtype)
    got = kmod.fused_rmsnorm(x, res, scale)
    torch.cuda.synchronize()
    want = fused_rmsnorm_ref(x, res, scale)
    name = str(dtype).split(".")[-1]
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -7, 0.0)
    err = share = 0.0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / (atol + rtol * b.float().abs())
                                  ).nan_to_num(0.0).max()))
    if not share <= 1.0:
        fail(f"fused_rmsnorm {shape} {name}: differs from the plain version "
             f"by {err} (bar {atol} + {rtol}|plain|)")
    out = {"shape": list(shape), "dtype": name, "max_abs_err": err,
           "bar_share": share}
    call = lambda: kmod.fused_rmsnorm(x, res, scale)  # noqa: E731
    out["ms"] = device_ms(call)
    if not timed:
        return out
    item = x.element_size()
    n_bytes = 4 * x.numel() * item + scale.numel() * item
    d = shape[-1]
    w = 1.0 + scale
    library = lambda: F.rms_norm(x + res, (d,), w, 1e-6)  # noqa: E731
    plain = lambda: fused_rmsnorm_ref(x, res, scale)  # noqa: E731
    out.update({"bytes": n_bytes, "plain_ms": device_ms(plain),
                "library_ms": device_ms(library),
                "dispatch_ms": host_ms(call),
                **bound(n_bytes, 6 * x.numel(), FP32_OPS_PER_S)})
    return out


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

def largest_rel_diff(a, b) -> float:
    import numpy as np
    worst = 0.0
    for sa, sb in zip(a.scenarios, b.scenarios):
        for f in SWEEP_ARRAYS:
            x, y = getattr(sa, f), getattr(sb, f)
            d = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
            worst = max(worst, float(np.max(d, initial=0.0)))
    return worst


def check_result(res, n_scenarios: int, n_steps: int) -> None:
    """The repo's own checks on a sweep result: shapes and finite values."""
    import numpy as np
    if len(res.scenarios) != n_scenarios or res.n_steps != n_steps:
        fail(f"{res.engine}: {len(res.scenarios)} scenarios x "
             f"{res.n_steps} steps, expected {n_scenarios} x {n_steps}")
    for s in res.scenarios:
        for f in SWEEP_ARRAYS:
            a = getattr(s, f)
            if a.shape != (n_steps,) or not np.all(np.isfinite(a)):
                fail(f"{res.engine} {s.name}: {f} is not {n_steps} finite "
                     f"values")
        if not s.failures:
            fail(f"{res.engine} {s.name}: no failure was injected")


def baseline_path() -> int:
    """Phase 4; returns K2's launches in the card sweep (one a decision
    interval: ``fused_interval``)."""
    import numpy as np
    from repro_torch.core import EngineConfig
    from repro_torch.dsp import SweepEngine, paper_grid
    from repro_torch.kernels import fused_tick as kmod
    seeds = range(BASELINE_ROWS // 6)
    specs = paper_grid(controllers=("static", "reactive", "ds2"),
                       seeds=seeds, trace_kinds=("ysb", "tsw"))
    S = len(specs)
    runs = {}
    for label, config in (
            ("fused-cuda", EngineConfig(sim_backend="fused", device="cuda")),
            ("batched", EngineConfig(sim_backend="batched", device="cpu")),
            ("fused-cpu", EngineConfig(sim_backend="fused", device="cpu"))):
        eng = SweepEngine(specs, config=config)
        if label == "fused-cuda":
            kmod.fused_interval.launches = kmod.fused_tick.launches = 0
        res = eng.run()
        if label == "fused-cuda":
            launches = kmod.fused_interval.launches
            per_tick = kmod.fused_tick.launches
            intervals = eng.executor.intervals_stepped
            ticks_stepped = eng.executor.step_index + 1
        check_result(res, S, eng.n_steps)
        runs[label] = (res, eng.executor)
        print(f"sweep {label}: {S} scenarios x {res.n_steps} ticks, "
              f"wall_s {res.wall_s}, scenario-ticks/s "
              f"{S * res.n_steps / res.wall_s}", flush=True)
    batched = runs["batched"][0]
    for label in ("fused-cuda", "fused-cpu"):
        res = runs[label][0]
        bad = [a.name for a, b in zip(res.scenarios, batched.scenarios)
               if a.name != b.name or not a.allclose(b, rtol=1e-9)]
        if bad:
            fail(f"{label} differs from batched in {len(bad)} scenarios, "
                 f"e.g. {bad[:3]}")
        print(f"{label} vs batched: all {S} scenarios allclose at rtol 1e-9; "
              f"largest relative difference {largest_rel_diff(res, batched)}")
    trig_cuda = runs["fused-cuda"][1].anomaly_triggers
    trig_cpu = runs["fused-cpu"][1].anomaly_triggers
    if not np.array_equal(trig_cuda, trig_cpu):
        fail(f"anomaly_triggers differ between cuda and cpu in "
             f"{int(np.sum(trig_cuda != trig_cpu))} scenarios")
    print(f"anomaly_triggers equal on cuda and cpu (total "
          f"{int(trig_cuda.sum())})")
    n_steps = runs["fused-cuda"][0].n_steps
    if ticks_stepped != n_steps:
        fail(f"the fused engine stepped {ticks_stepped} of {n_steps} ticks")
    if not launches == intervals > 0 or per_tick != 0:
        fail(f"fused_interval launched {launches} times for {intervals} "
             f"step_interval calls (fused_tick {per_tick} times)")
    print(f"baseline path: fused_interval launches {launches} (one per "
          f"step_interval call, {n_steps} ticks)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def check_forecast_bank(device: str) -> dict:
    """288 mixed-family streams fed one value per minute of 18 h traces
    (in thousands of events/s) against the scalar zoo."""
    import numpy as np
    from repro_torch.core import ForecastBank, binned_forecast
    from repro_torch.core.forecast import make_scalar_forecaster
    from repro_torch.dsp import TRACE_GENERATORS, make_trace
    from repro_torch.kernels import rls_update as kmod
    n, kinds = 288, ("arima", "holt", "seasonal")
    trace_kinds = sorted(TRACE_GENERATORS)
    vals = np.stack([make_trace(trace_kinds[j % len(trace_kinds)],
                                duration_s=18 * 3600.0, dt_s=60.0,
                                seed=1000 + j).rates / 1000.0
                     for j in range(n)], axis=1)
    row_kinds = [kinds[j % 3] for j in range(n)]
    bank = ForecastBank(row_kinds, horizon=10, device=device)
    views = bank.views()
    scalars = [make_scalar_forecaster(k) for k in row_kinds]
    launches0 = (kmod.arima_chunk.launches, kmod.rls_rank1_update.launches)
    worst, n_reads = 0.0, 0
    t0 = time.perf_counter()
    for t in range(vals.shape[0]):
        for j in range(n):
            views[j].update(vals[t, j])
            scalars[j].update(vals[t, j])
        if t % 10 == 9:                       # a read epoch every 10 minutes
            n_reads += 1
            for j in range(n):
                got, want = views[j].forecast(10), scalars[j].forecast(10)
                if not np.allclose(got, want, rtol=1e-9, atol=1e-9):
                    fail(f"forecast bank row {j} ({row_kinds[j]}) at tick "
                         f"{t}: {got} != {want}")
                worst = max(worst, float(np.max(
                    np.abs(got - want) / np.maximum(np.abs(want), 1e-300))))
                b, w = binned_forecast(views[j], 10, 5), \
                    binned_forecast(scalars[j], 10, 5)
                # the decision the controller takes from it: the segment
                if int(b * 1000 // 10_000) != int(w * 1000 // 10_000):
                    fail(f"forecast bank row {j}: binned-forecast decision "
                         f"{b} vs {w}")
    launches = kmod.arima_chunk.launches - launches0[0]
    per_step = kmod.rls_rank1_update.launches - launches0[1]
    if device == "cuda" and not (launches == bank.arima_chunks > 0
                                 and per_step == 0):
        fail(f"forecast bank: {launches} arima_chunk launches for "
             f"{bank.arima_chunks} ARIMA chunks (rls_update {per_step})")
    return {"streams": n, "ticks": int(vals.shape[0]), "reads": n_reads,
            "max_rel_diff": worst, "arima_chunk_launches": launches,
            "arima_chunks": bank.arima_chunks,
            "arima_ticks": bank.arima_ticks,
            "update_wall_s": bank.update_wall_s,
            "wall_s": time.perf_counter() - t0}


def gp_datasets(n_sets: int, seed: int, sizes=(3, 61)):
    """Seeded controller-shaped datasets: d = 5, ``sizes`` (a half-open
    range: 3 to 60 points by default) points each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    datasets = []
    for i in range(n_sets):
        n = int(rng.integers(*sizes))
        x = rng.uniform(0, 1, (n, 5))
        y = (1.0 + 0.3 * (i % 7)) * (1.2 - x[:, 0]) + 0.4 * x[:, 1] ** 2 \
            + rng.normal(0, 0.05, n)
        datasets.append((x, y))
    return datasets, [i * 131 for i in range(n_sets)]


class count_fit_calls:
    """Counts the GP bank's batched fits (``gp_bank._fit_packed`` calls),
    the largest padded training size among them and the fits by ``"rows x
    n_max"`` (``by_shape``: a fit is one ``gp_lbfgs`` launch of (member,
    restart) rows at that padded size on the card), until ``restore()``.
    CUDA events around each ``ops.gp_lbfgs`` call on the card (no host
    sync) give the fit kernel's device time, ``kernel_ms()``."""

    def __init__(self, gp_bank):
        from repro_torch.kernels import ops
        self.mod, self.fn, self.n = gp_bank, gp_bank._fit_packed, 0
        self.n_max, self.by_shape = 0, {}
        self.ops, self.ops_fn, self.events = ops, ops.gp_lbfgs, []

        def timed(x, *a, **k):
            if x.device.type != "cuda":
                return self.ops_fn(x, *a, **k)
            import torch
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = self.ops_fn(x, *a, **k)
            end.record()
            self.events.append((start, end))
            return out
        ops.gp_lbfgs = timed

        def counted(x, y, mask, t0s, *a, **k):
            self.n += 1
            self.n_max = max(self.n_max, x.shape[1])
            key = f"{t0s.shape[0] * t0s.shape[1]}x{x.shape[1]}"
            self.by_shape[key] = self.by_shape.get(key, 0) + 1
            return self.fn(x, y, mask, t0s, *a, **k)
        gp_bank._fit_packed = counted

    def restore(self):
        self.mod._fit_packed = self.fn
        self.ops.gp_lbfgs = self.ops_fn

    def kernel_ms(self) -> float:
        """The summed device time of the timed fit launches, in ms."""
        for _, end in self.events[-1:]:
            end.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


class pick_margins:
    """How near the Demeter controller's picks came to another choice,
    until ``restore()``. At every ``_pick_config`` with a posterior it
    reads the predictions the pick itself asks for (no extra fit, no extra
    launch) and keeps the smallest, over the picks, of: a candidate's
    predicted latency from the latency constraint (``latency``), its
    predicted recovery time from the recovery constraint (``recovery``),
    each relative to the constraint (a candidate there leaves or joins the
    feasible set), and the picked candidate's predicted usage from its
    neighbours' in the feasible order, relative to its own (``usage``: a
    swap moves the safety buffer's pick). A kernel change whose float32
    rounding flips a card-vs-CPU decision shows here as a small margin."""

    def __init__(self):
        import numpy as np
        from repro_torch.core import demeter
        self.cls, self.fn = demeter.DemeterController, \
            demeter.DemeterController._pick_config
        self.picks = 0
        self.margin = {"latency": np.inf, "recovery": np.inf,
                       "usage": np.inf}

        def pick(ctl, segment):
            seen, posteriors = {}, ctl._posteriors

            def watched(seg, metric):
                post = posteriors(seg, metric)
                if post is None:
                    return None

                def read(xq):
                    out = post(xq)
                    seen[metric] = np.asarray(out[0], dtype=np.float64)
                    return out
                return read
            ctl._posteriors = watched
            try:
                return self.fn(ctl, segment)
            finally:
                del ctl._posteriors
                self.note(ctl, seen, demeter)
        self.cls._pick_config = pick

    def note(self, ctl, seen, demeter):
        import numpy as np
        lc = ctl.lc.constraint()
        mu_u, mu_l = seen.get(demeter.USAGE), seen.get(demeter.LATENCY)
        if lc is None or mu_u is None or mu_l is None:
            return
        self.picks += 1
        m = self.margin
        m["latency"] = min(m["latency"],
                           float(np.abs(mu_l - lc).min()) / abs(lc))
        feasible = mu_l < lc
        rmu = seen.get(demeter.RECOVERY)
        if rmu is not None:
            rc = ctl.hp.recovery_constraint_s
            m["recovery"] = min(m["recovery"],
                                float(np.abs(rmu - rc).min()) / rc)
            feasible &= rmu <= rc
        u = np.sort(mu_u[feasible])
        if len(u) > 1:
            k = min(int(np.floor(ctl.hp.safety_buffer * len(u))), len(u) - 1)
            gap = min(u[k] - u[k - 1] if k > 0 else np.inf,
                      u[k + 1] - u[k] if k + 1 < len(u) else np.inf)
            m["usage"] = min(m["usage"], float(gap) / max(abs(u[k]), 1e-12))

    def summary(self) -> dict:
        """The picks seen and each smallest relative margin (None where no
        pick had that decision)."""
        return {"picks": self.picks,
                **{k: (v if v != float("inf") else None)
                   for k, v in self.margin.items()}}

    def restore(self):
        self.cls._pick_config = self.fn


def fit_operands(datasets, seeds, device):
    """``GPBank.fit``'s packed float32 operands of ``datasets``: x, y, mask
    (B, n_max, ...) and the restarts' starts (B, R, d + 2)."""
    import numpy as np
    import torch
    from repro_torch.core.demeter import FIT_RESTARTS
    from repro_torch.core.gp import restart_inits
    from repro_torch.core.gp_bank import bucket_pow2
    b, dim = len(datasets), datasets[0][0].shape[1]
    n_max = bucket_pow2(max(len(y) for _, y in datasets))
    xs, ys = np.zeros((b, n_max, dim)), np.zeros((b, n_max))
    mask = np.zeros((b, n_max))
    t0s = np.zeros((b, FIT_RESTARTS, dim + 2))
    for i, (x, y) in enumerate(datasets):
        n = len(y)
        xs[i, :n], ys[i, :n] = x, (y - y.mean()) / (y.std() or 1.0)
        mask[i, :n] = 1.0
        t0s[i] = restart_inits(dim, FIT_RESTARTS, seeds[i])
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (xs, ys, mask, t0s)]


#: the GP fit's float32 operations per objective evaluation at n points:
#: the factor and its inverse (n^3 / 6 each), K^-1 (n^3 / 3), the kernel
#: matrix and the gradient's traces (~40 n^2 at d = 5)
def gp_eval_ops(n: int) -> float:
    return 2 * (n ** 3 / 6 + n ** 3 / 6 + n ** 3 / 3) + 40 * n * n


def check_gp_fit(n_sets: int = 96, seed: int = 12, sizes=(3, 61),
                 timed: bool = True, device: str = "cuda") -> dict:
    """The GP bank's fit kernel against its plain version on the card, on
    ``gp_datasets(n_sets, seed, sizes)`` (by default phase 5's datasets:
    96 members, 2 restarts, n up to 60): the iterates after 1 and 2
    iterations within 1e-3 of theta's scale (the first steps, a zoom
    search among them, before float32 rounding parts the paths), and after
    the full 60 iterations each member's best objective within 1e-3
    relative (the optimum the algorithm reaches). ``max_abs_err`` is the
    early iterates' largest absolute difference in theta. Timed (with
    ``timed``): one launch against the plain version's whole loop."""
    import numpy as np
    import torch
    from repro_torch.core.demeter import FIT_MAX_ITER
    from repro_torch.core.gp import neg_mll_and_grad
    from repro_torch.kernels import build
    from repro_torch.kernels.gp_fit import gp_lbfgs
    from repro_torch.kernels.ref import gp_lbfgs_ref
    datasets, seeds = gp_datasets(n_sets, seed, sizes)
    x, y, mask, t0s = fit_operands(datasets, seeds, device)
    B, R, D = t0s.shape
    xr, yr, mr = (t.repeat_interleave(R, dim=0) for t in (x, y, mask))
    t0 = t0s.reshape(B * R, D)
    worst_early = worst_abs = 0.0
    for it in (1, 2):
        got = gp_lbfgs(x, y, mask, t0, restarts=R, max_iter=it)[0]
        want = gp_lbfgs_ref(x, y, mask, t0, R, it)[0]
        both_nan = torch.isnan(got) & torch.isnan(want)
        diff = torch.where(both_nan, 0.0, (got - want).abs())
        err = float(diff.max() / want.nan_to_num().abs().max())
        if not err < 1e-3:
            fail(f"gp_lbfgs (n_max {x.shape[1]}): theta after {it} "
                 f"iterations parts from the plain version by {err} of "
                 f"scale")
        worst_early = max(worst_early, err)
        worst_abs = max(worst_abs, float(diff.max()))
    sync(device)
    t_plain = time.perf_counter()
    want = gp_lbfgs_ref(x, y, mask, t0, R, FIT_MAX_ITER)[0]
    sync(device)
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    theta, counts, evals = gp_lbfgs(x, y, mask, t0, restarts=R,
                                    max_iter=FIT_MAX_ITER)
    # the body the C entry point launches at this size
    tile = build.load("gp_fit").gp_lbfgs_body(x.shape[1])
    body, fn = ((f"tiled-{tile}", f"gp_tile_kernel<{tile}>") if tile else
                ("general", "gp_lbfgs_kernel"))
    ms = (device_ms(lambda: gp_lbfgs(x, y, mask, t0, restarts=R,
                                     max_iter=FIT_MAX_ITER), n=5, warmup=1,
                    host_n=5) if timed and device == "cuda" else None)
    f_k = neg_mll_and_grad(theta, xr, yr, mr)[0].reshape(B, R)
    f_p = neg_mll_and_grad(want, xr, yr, mr)[0].reshape(B, R)
    inf = torch.tensor(float("inf"), device=device)
    best_k = torch.where(torch.isfinite(f_k), f_k, inf).min(1).values
    best_p = torch.where(torch.isfinite(f_p), f_p, inf).min(1).values
    rel = ((best_k - best_p).abs() / best_p.abs().clamp_min(1.0)).max()
    rel = float(rel)
    if not rel < 1e-3:
        fail(f"gp_lbfgs (n_max {x.shape[1]}): best objectives part from "
             f"the plain version's by {rel} (relative)")
    n_real = mask.sum(1).repeat_interleave(R).cpu().numpy()
    ops = float(np.sum(evals.cpu().numpy() * np.vectorize(gp_eval_ops)(
        n_real)))
    n_bytes = sum(t.numel() * 4 for t in (x, y, mask, t0, theta)) \
        + 8 * B * R
    per_row = float(evals.float().mean())
    out = {"members": B, "restarts": R, "n_max": x.shape[1],
           "iterations": int(counts.max()), "evals_per_row": per_row,
           "evals_max": int(evals.max()), "max_abs_err": worst_abs,
           "early_iterate_rel_err": worst_early, "objective_rel_err": rel,
           "ms": ms, "us_per_eval": None if ms is None else ms * 1e3 / per_row,
           "plain_ms": plain_ms, **bound(n_bytes, ops, FP32_OPS_PER_S),
           "library_ms": None, "design": body, "ptxas": ptxas_of(fn)}
    return out


def check_gp_bank(device: str, n_sets: int = 96) -> dict:
    """``GPBank.fit`` on ``device`` against the scalar ``GP.fit`` on the
    host: every member's posterior within 5% of scale (the reference's
    bar), except the members of ``OTHER_OPTIMA``. There the bank's
    optimizer (the reference's: optax's L-BFGS with the zoom line search)
    and the scalar fit's (scipy's L-BFGS-B) stop at different optima from
    the same starts: on member 49 the reference's bank and the port's both
    stop at 4.032 where scipy reaches 3.536. Such a member passes if the
    bank's objective is above the scalar fit's and equals, within 1e-3,
    the port's bank on the CPU (which the CPU tests hold to the
    reference's bank): the card finds the optimum the reference's
    algorithm finds. Any other member off the 5% bar fails."""
    import numpy as np
    import torch
    from repro_torch.core import GP, GPBank
    from repro_torch.core.demeter import FIT_MAX_ITER, FIT_RESTARTS
    from repro_torch.core.gp import _neg_mll
    datasets, seeds = gp_datasets(n_sets, seed=12)
    t0 = time.perf_counter()
    bank = GPBank.fit(datasets, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                      seeds=seeds, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    bank_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    scalars = [GP.fit(x, y, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                      seed=s) for (x, y), s in zip(datasets, seeds)]
    scalar_wall = time.perf_counter() - t0
    xq = np.random.default_rng(0).uniform(0, 1, (128, 5))
    mu_b, var_b = bank.posterior(xq)

    def objective(theta, x, y):
        f32 = lambda a: torch.as_tensor(np.asarray(a),  # noqa: E731
                                        dtype=torch.float32)[None]
        ys = (y - y.mean()) / (y.std() or 1.0)
        return float(_neg_mll(f32(theta), f32(x), f32(ys),
                              torch.ones(1, len(y)))[0])
    worst_mu = worst_var = 0.0
    other_optima = {}
    for i, ((x, y), gp) in enumerate(zip(datasets, scalars)):
        mu, var = gp.posterior(xq)
        scale = np.std(y) or 1.0
        dm = float(np.max(np.abs(mu - mu_b[i])) / scale)
        dv = float(np.max(np.abs(var - var_b[i])) / scale ** 2)
        if dm < 0.05 and dv < 0.05:
            worst_mu, worst_var = max(worst_mu, dm), max(worst_var, dv)
            continue
        if i not in OTHER_OPTIMA:
            fail(f"GPBank member {i} (n={len(y)}): posterior drifted from "
                 f"the scalar fit (mean {dm}, variance {dv} of scale)")
        f_bank, f_scalar = (objective(t, x, y)
                            for t in (bank.theta[i], gp.theta))
        f_cpu = objective(GPBank.fit(
            [(x, y)], restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
            seeds=[seeds[i]], device="cpu").theta[0], x, y)
        if not (f_bank > f_scalar and abs(f_bank - f_cpu)
                <= 1e-3 * abs(f_cpu)):
            fail(f"GPBank member {i} (n={len(y)}): posterior drifted from "
                 f"the scalar fit (mean {dm}, variance {dv} of scale; "
                 f"objective {f_bank} on {device}, {f_cpu} on the CPU bank, "
                 f"{f_scalar} scalar)")
        other_optima[i] = {"n": len(y), "mean_diff": dm, "var_diff": dv,
                           "objective": f_bank, "cpu_bank_objective": f_cpu,
                           "scalar_objective": f_scalar}
    return {"members": n_sets, "bank_fit_wall_s": bank_wall,
            "scalar_fit_wall_s": scalar_wall, "max_mean_diff": worst_mu,
            "max_var_diff": worst_var, "other_optima": other_optima}


def check_selection(device: str) -> list:
    """The same profiling batch from the scalar fits + NumPy EHVI as from
    the GP bank + batched EHVI on ``device`` (three seeds)."""
    import numpy as np
    from repro_torch.core import GP, GPBank, select_profiling_batch
    from repro_torch.core.demeter import FIT_MAX_ITER, FIT_RESTARTS

    def posterior(gu, gl):
        def post(xq):
            mu_u, var_u = gu.posterior(xq)
            mu_l, var_l = gl.posterior(xq)
            return np.stack([mu_u, mu_l], 1), np.stack([var_u, var_l], 1)
        return post

    picks = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        n = 15
        x = rng.uniform(0, 1, (n, 4))
        usage = 1.5 - x[:, 0] + 0.2 * x[:, 1] + rng.normal(0, 0.03, n)
        lat = 0.5 + x[:, 0] ** 2 + rng.normal(0, 0.03, n)
        su = GP.fit(x, usage, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                    seed=3)
        sl = GP.fit(x, lat, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                    seed=4)
        bank = GPBank.fit([(x, usage), (x, lat)], restarts=FIT_RESTARTS,
                          max_iter=FIT_MAX_ITER, seeds=[3, 4], device=device)
        cand = rng.uniform(0, 1, (96, 4))
        front = np.stack([usage, lat], 1)
        ref = (float(usage.max()) * 1.2, float(lat.max()) * 1.2)
        a = select_profiling_batch(cand, posterior(su, sl), None, front, ref,
                                   q=3, backend="numpy")
        b = select_profiling_batch(
            cand, posterior(bank.member(0), bank.member(1)), None, front,
            ref, q=3, backend="torch", device=device)
        if a != b:
            fail(f"selection seed {seed}: scalar picked {a}, bank {b}")
        picks.append(a)
    return picks


# ---------------------------------------------------------------------------
# the Demeter path
# ---------------------------------------------------------------------------

def demeter_specs(n_seeds: int):
    from repro_torch.dsp import paper_grid
    return paper_grid(controllers=("demeter",), seeds=range(n_seeds),
                      trace_kinds=("ysb", "tsw"))


class LayerTimers:
    """Host wall per layer of a sweep, by wrapping the layers' entry points
    on the instances and classes of one run (the sweep's own walls cover
    the forecast bank and the model updates)."""

    def __init__(self):
        self.wall = {}
        self.calls = {}
        self._undo = []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.wall[label] = self.wall.get(label, 0.0) \
                    + time.perf_counter() - t0
                self.calls[label] = self.calls.get(label, 0) + 1
        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []


def demeter_main_path(n_seeds: int, device: str = "cuda") -> dict:
    """Phase 6: the Demeter grid under ``EngineConfig(device=device)``."""
    import torch
    from repro_torch.core import EngineConfig
    from repro_torch.core.demeter import DemeterController
    from repro_torch.dsp import FusedSweepExecutor, SweepEngine
    from repro_torch.dsp.executor import SweepExecutorBase
    from repro_torch.core import gp_bank
    from repro_torch.kernels import fused_tick as k2
    from repro_torch.kernels import gp_fit as kgp
    from repro_torch.kernels import rls_update as k1
    specs = demeter_specs(n_seeds)
    S = len(specs)
    eng = SweepEngine(specs, config=EngineConfig(device=device))
    timers = LayerTimers()
    fit_calls = count_fit_calls(gp_bank)
    timers.wrap(FusedSweepExecutor, "step_interval", "fused engine")
    timers.wrap(SweepExecutorBase, "profile", "profiling clones")
    timers.wrap(DemeterController, "_pick_config", "pick config")
    timers.wrap(DemeterController, "_select_profiles", "select profiles")
    k1.arima_chunk.launches = k1.rls_rank1_update.launches = 0
    k2.fused_interval.launches = k2.fused_tick.launches = 0
    kgp.gp_lbfgs.launches = 0
    try:
        res = eng.run()
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        timers.restore()
        fit_calls.restore()
    launches = {"arima_chunk": k1.arima_chunk.launches,
                "fused_interval": k2.fused_interval.launches,
                "gp_lbfgs": kgp.gp_lbfgs.launches,
                "rls_update": k1.rls_rank1_update.launches,
                "fused_tick": k2.fused_tick.launches}
    check_result(res, S, eng.n_steps)
    if not res.n_model_fits > 0:
        fail("Demeter main path fitted no GP")
    chunks = eng.forecast_bank.arima_chunks
    intervals = eng.executor.intervals_stepped
    if device == "cuda":
        if not launches["arima_chunk"] == chunks > 0:
            fail(f"arima_chunk launched {launches['arima_chunk']} times for "
                 f"{chunks} ARIMA chunks replayed")
        if not launches["fused_interval"] == intervals > 0:
            fail(f"fused_interval launched {launches['fused_interval']} "
                 f"times for {intervals} step_interval calls")
        if not launches["gp_lbfgs"] == fit_calls.n > 0:
            fail(f"gp_lbfgs launched {launches['gp_lbfgs']} times for "
                 f"{fit_calls.n} GP bank fits")
        if launches["rls_update"] or launches["fused_tick"]:
            fail(f"the per-tick kernels ran on the Demeter path: {launches}")
    out = {"scenarios": S, "n_steps": res.n_steps, "wall_s": res.wall_s,
           "model_update_wall_s": res.model_update_wall_s,
           "model_update_compile_wall_s": res.model_update_compile_wall_s,
           "forecast_update_wall_s": res.forecast_update_wall_s,
           "forecast_update_compile_wall_s":
               res.forecast_update_compile_wall_s,
           "n_model_fits": res.n_model_fits,
           "n_forecast_updates": res.n_forecast_updates,
           "reconfigurations": sum(s.n_reconfigurations
                                   for s in res.scenarios),
           "arima_ticks": eng.forecast_bank.arima_ticks,
           "arima_chunks": chunks, "intervals": intervals,
           "gp_bank_fits": fit_calls.n, "gp_fit_n_max": fit_calls.n_max,
           "gp_fits_by_rows_x_n_max": fit_calls.by_shape,
           "gp_lbfgs_device_s": fit_calls.kernel_ms() * 1e-3,
           "launches": launches, "layer_wall_s": timers.wall,
           "layer_calls": timers.calls}
    print("demeter main path " + json.dumps(out), flush=True)
    for s in res.scenarios:
        print("table3 " + json.dumps(s.summary()), flush=True)
    return out


def first_difference(a, b) -> str:
    """Where two runs of one scenario part: the first tick whose worker
    count or rate-path metrics differ, and the configs chosen there."""
    import numpy as np
    for f in SWEEP_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        bad = np.flatnonzero(~np.isclose(x, y, rtol=1e-9, atol=1e-9))
        if len(bad):
            i = int(bad[0])
            return (f"first at tick {i} (t = {a.times[i]} s) in {f}: "
                    f"{x[i]} vs {y[i]}; workers {a.workers[i]} vs "
                    f"{b.workers[i]}")
    return "no array differs (a count does)"


def decision_margin(eng_a, eng_b, j: int) -> str:
    """The two runs' reconfiguration events of scenario ``j`` where they
    first differ, with each config's predicted usage under the first run's
    models (the margin between the two candidates)."""
    ca, cb = eng_a.policies[j].ctl, eng_b.policies[j].ctl
    ea = [e for e in ca.events if e[0] == "reconfigure"]
    eb = [e for e in cb.events if e[0] == "reconfigure"]
    for k, (x, y) in enumerate(zip(ea, eb)):
        if x != y:
            seg = ca.store.segment_for(ca.predicted_rate())
            ua = ca._predicted_usage(seg, x[1]["config"])
            ub = ca._predicted_usage(seg, y[1]["config"])
            return (f"event {k}: {x[1]} vs {y[1]}; predicted usage "
                    f"{ua} vs {ub}, margin "
                    f"{None if ua is None or ub is None else abs(ua - ub)}")
    return f"events agree on their common prefix ({len(ea)} vs {len(eb)})"


def demeter_grid():
    """Phase 7's grid and config: 3 Demeter scenarios (one a forecaster
    family), 2 h, failures every 45 minutes, the scalar GP fits and
    profiling every 10 minutes."""
    from repro_torch.core import EngineConfig
    from repro_torch.core.demeter import DemeterHyperParams
    from repro_torch.dsp import PeriodicFailures, ScenarioSpec, make_trace
    specs = [ScenarioSpec(trace=make_trace(k, duration_s=2 * 3600.0),
                          controller="demeter", seed=s,
                          failures=PeriodicFailures(2700.0), forecaster=f)
             for s, (k, f) in enumerate((("diurnal", "arima"),
                                         ("flash", "holt"),
                                         ("regime", "seasonal")))]
    return specs, EngineConfig(fit_backend="scalar", hp=DemeterHyperParams(
        profile_interval_s=600))


def demeter_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """Phase 7: the same 3-scenario, 2 h grid with scalar fits on each
    device; every scenario must agree at rtol 1e-9."""
    from repro_torch.dsp import SweepEngine
    specs, config = demeter_grid()
    engines, results = {}, {}
    for dev in devices:
        eng = SweepEngine(specs, config=config.replace(device=dev))
        results[dev] = eng.run()
        engines[dev] = eng
        check_result(results[dev], len(specs), eng.n_steps)
        r = results[dev]
        print(f"demeter 2 h on {dev}: wall_s {r.wall_s}, n_model_fits "
              f"{r.n_model_fits}, n_forecast_updates {r.n_forecast_updates}, "
              f"reconfigurations "
              f"{[s.n_reconfigurations for s in r.scenarios]}", flush=True)
    a, b = (results[d] for d in devices)
    problems = []
    for j, (sa, sb) in enumerate(zip(a.scenarios, b.scenarios)):
        if not sa.allclose(sb, rtol=1e-9) \
                or sa.n_reconfigurations != sb.n_reconfigurations:
            problems.append(f"{sa.name}: {first_difference(sa, sb)}; "
                            f"{decision_margin(*engines.values(), j)}")
    for key in ("n_model_fits", "n_forecast_updates"):
        if getattr(a, key) != getattr(b, key):
            problems.append(f"{key}: {getattr(a, key)} vs {getattr(b, key)}")
    if problems:
        fail("Demeter card vs CPU: " + " | ".join(problems))
    out = {"scenarios": len(specs), "n_model_fits": a.n_model_fits,
           "n_forecast_updates": a.n_forecast_updates,
           "largest_rel_diff": largest_rel_diff(a, b),
           "wall_s": {d: results[d].wall_s for d in devices}}
    print("demeter card vs cpu " + json.dumps(out), flush=True)
    out["results"] = results
    return out


# ---------------------------------------------------------------------------
# the detector bank and the paper's per-cell protocol
# ---------------------------------------------------------------------------

def detector_streams(n: int, T: int, seed: int = 0):
    """(values (T, n), active (T, n)): throughput-like streams in events/s
    (1e3-8e4, a periodic swing, 1% noise); a quarter of the streams (every
    fourth) drop to zero three times, half (the even ones) have 3% NaN
    gaps, and an eighth (j = 2 mod 8) are inactive 20 samples in 40."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    base = rng.uniform(1e3, 8e4, n)[None, :]
    period = rng.uniform(30.0, 200.0, n)[None, :]
    v = base * (1 + 0.1 * np.sin(2 * np.pi * t / period)) \
        * (1 + 0.01 * rng.normal(0, 1, (T, n)))
    for j in range(0, n, 4):
        for start in rng.integers(60, T - 60, 3):
            v[start:start + rng.integers(5, 40), j] = 0.0
    gaps = rng.random((T, n)) < 0.03
    gaps[:, 1::2] = False
    v[gaps] = np.nan
    act = np.ones((T, n), bool)
    act[(t[:, 0] // 20) % 2 == 1, 2::8] = False
    return v, act


def detector_state(bank, device=None) -> list:
    """Copies of a DetectorBank's state, ring and ring counts."""
    return [x.detach().to(device or x.device, copy=True)
            for x in (*bank._state, bank._ring, bank._rn)]


def detector_bank_path(n: int = DETECTOR_STREAMS, T: int = DETECTOR_SAMPLES,
                       device: str = "cuda") -> dict:
    """Phase 23: a DetectorBank of ``n`` streams on ``device`` over ``T``
    samples against the port's CPU bank (equal flags on every sample) and
    the scalar MetricDetector (the first DETECTOR_SCALAR streams); the state
    one sample at a time from the CPU bank's: equal counts, and every float
    array of every stream that takes the sample (not flagged) within 1e-12
    of the stream's scale (its largest magnitude before or after the
    sample). A flagged stream coasts on its own prediction: its residual
    is zero up to rounding, and its lags may have run away by decades, so
    its residual ring and P hold rounding noise; their differences are
    printed, not held. K1 (``arima_chunk``) once per observe."""
    import numpy as np
    import torch
    from repro_torch.core import DetectorBank, MetricDetector
    from repro_torch.kernels import rls_update as k1
    vals, act = detector_streams(n, T)
    card = DetectorBank(n, device=device)
    cpu = DetectorBank(n, device="cpu")
    scalars = [MetricDetector(f"m{j}") for j in range(DETECTOR_SCALAR)]
    checks = set(range(DETECTOR_CHECK_EVERY // 2, T, DETECTOR_CHECK_EVERY))
    before, after, flags_at = {}, {}, {}
    n_flags = 0
    k1.arima_chunk.launches = k1.rls_rank1_update.launches = 0
    for i in range(T):
        if i in checks:
            before[i] = detector_state(cpu)
        got = card.observe(vals[i], act[i])
        with CpuThreads():
            want = cpu.observe(vals[i], act[i])
        if i in checks:
            after[i], flags_at[i] = detector_state(cpu), want
        if not np.array_equal(got, want):
            fail(f"detector bank: {int((got != want).sum())} flags differ "
                 f"from the CPU bank at sample {i}")
        for j, det in enumerate(scalars):
            if bool(got[j]) != (det.observe(vals[i, j]) if act[i, j]
                                else False):
                fail(f"detector bank: stream {j} differs from "
                     f"MetricDetector at sample {i}")
        n_flags += int(got.sum())
    launches = k1.arima_chunk.launches
    per_step = k1.rls_rank1_update.launches
    if device == "cuda" and not (launches == card.n_samples == T
                                 and per_step == 0):
        fail(f"detector bank: {launches} arima_chunk launches for "
             f"{card.n_samples} observes (rls_update {per_step})")
    # the state, one sample at a time from the CPU bank's
    probe = DetectorBank(n, device=device)
    worst, coasting = {}, {}
    for i in sorted(before):
        *state, ring, rn = (x.to(probe.device) for x in before[i])
        probe.load_state(state, ring, rn)
        if not np.array_equal(probe.observe(vals[i], act[i]), flags_at[i]):
            fail(f"detector bank: flags from a shared state differ at {i}")
        flagged = torch.as_tensor(np.pad(flags_at[i], (0, probe.b - n)))
        for name, b, g, w in zip(probe._state._fields + ("ring", "rn"),
                                 before[i], detector_state(probe, "cpu"),
                                 after[i]):
            if g.dtype == torch.int64:
                if not torch.equal(g, w):
                    fail(f"detector bank: {name} differs at sample {i}")
                continue
            for into, rows in ((worst, ~flagged), (coasting, flagged)):
                if rows.any():
                    into[name] = max(into.get(name, 0.0), rel_by_stream(
                        g[rows], w[rows], also=b[rows]))
    print(f"detector bank state, one sample from a shared state: largest "
          f"difference by field relative to each stream's scale: streams "
          f"that take the sample {worst}; flagged streams, coasting "
          f"{coasting}", flush=True)
    if not max(worst.values()) <= 1e-12:
        fail(f"detector bank: the state differs by more than 1e-12: {worst}")
    # device time per observe (the probe, off the count), and what one
    # profiling clone's bank of two streams costs to build
    busy = device_busy(lambda: [probe.observe(vals[i], act[i])
                                for i in range(20)]) if device == "cuda" \
        else {}
    t0 = time.perf_counter()
    for _ in range(50):
        DetectorBank(2, device=device)
    build_ms = (time.perf_counter() - t0) / 50 * 1e3
    out = {"streams": n, "samples": T, "flags": n_flags,
           "arima_chunk_launches": launches,
           "host_ms_per_observe": card.wall_s / card.n_samples * 1e3,
           "cpu_host_ms_per_observe": cpu.wall_s / cpu.n_samples * 1e3,
           "device_busy_ms_per_observe": busy.get("device_busy_ms", 0.0)
           / 20, "idle_share": busy.get("idle_share"),
           "top_kernels_ms_per_20": busy.get("top_kernels_ms"),
           "state_checks": len(before),
           "max_state_rel": max(worst.values()),
           "max_state_rel_coasting": coasting,
           "bank_of_2_build_ms": build_ms}
    print("detector bank " + json.dumps(out), flush=True)
    return out


class Recorder:
    """Records the DemeterControllers that ``run_experiment`` builds (their
    forecast banks count the ARIMA chunks)."""

    def __enter__(self):
        from repro_torch.dsp import runner
        self.made = made = []
        self.cls = base = runner.DemeterController

        class Recording(base):
            def __post_init__(self):
                super().__post_init__()
                made.append(self)
        runner.DemeterController = Recording
        return self

    def __exit__(self, *exc):
        from repro_torch.dsp import runner
        runner.DemeterController = self.cls


def table3_row(res, wall_s: float) -> dict:
    """A Table-3 row of one run: latencies under 2 s, reconfigurations,
    recoveries (NR: a reconfiguration overlapped; 6m+: past the cap), and
    CPU core-hours and memory GB-hours with and without profiling."""
    rec = res.recovery_times()
    done = [r for r in rec if r is not None and math.isfinite(r)]
    return {"trace": res.trace, "method": res.method,
            "latency_below_2s": res.frac_latency_below(2.0),
            "reconfigurations": res.n_reconfigurations,
            "failures": len(rec), "recovered": len(done),
            "NR": sum(r is None for r in rec),
            "6m+": sum(r is not None and not math.isfinite(r) for r in rec),
            "mean_recovery_s": statistics.mean(done) if done else None,
            "cpu_core_h": res.cumulative_cpu_s() / 3600.0,
            "cpu_core_h_no_profiling": res.cumulative_cpu_s(False) / 3600.0,
            "mem_gb_h": res.cumulative_mem_mb_s() / 3600.0 / 1024.0,
            "mem_gb_h_no_profiling":
                res.cumulative_mem_mb_s(False) / 3600.0 / 1024.0,
            "wall_s": wall_s}


def paper_protocol(device: str = "cuda", duration_s: float = 18 * 3600.0
                   ) -> dict:
    """Phase 24: ``run_experiment`` for every method on ysb and tsw at the
    paper's 18 h (dt = 5 s, a failure every 45 minutes, seed 0) under
    ``EngineConfig(device=device)``."""
    from repro_torch.core import gp_bank
    from repro_torch.dsp import (FAILURE_INTERVAL_S, PeriodicFailures,
                                 tsw_like, ysb_like)
    from repro_torch.kernels import gp_fit as kgp
    schedule = PeriodicFailures(FAILURE_INTERVAL_S)
    n_fail = len(schedule.times(duration_s))
    rows, launches = [], {}
    fits = count_fit_calls(gp_bank)
    kgp.gp_lbfgs.launches = 0
    try:
        for make in (ysb_like, tsw_like):
            rows += protocol_cells(make, duration_s, schedule, n_fail,
                                   device, launches)
    finally:
        fits.restore()
    if device == "cuda" and not kgp.gp_lbfgs.launches == fits.n > 0:
        fail(f"run_experiment: gp_lbfgs launched {kgp.gp_lbfgs.launches} "
             f"times for {fits.n} GP bank fits")
    print(f"run_experiment gp_lbfgs launches {kgp.gp_lbfgs.launches}, "
          f"fits by rows x n_max {fits.by_shape}", flush=True)
    return {"rows": rows, "arima_chunk_launches": launches,
            "gp_lbfgs_launches": kgp.gp_lbfgs.launches,
            "gp_fits_by_rows_x_n_max": fits.by_shape}


def protocol_cells(make, duration_s: float, schedule, n_fail: int,
                   device: str, launches: dict) -> list:
    """Phase 24's four cells on one trace; each Demeter cell's K1 launches
    go into ``launches`` under the trace's name."""
    import numpy as np
    from repro_torch.core import EngineConfig
    from repro_torch.dsp import run_experiment
    from repro_torch.kernels import rls_update as k1
    rows = []
    trace = make(duration_s=duration_s, dt_s=5.0)
    for method in PAPER_METHODS:
        k1.arima_chunk.launches = k1.rls_rank1_update.launches = 0
        t0 = time.perf_counter()
        with Recorder() as made:
            res = run_experiment(trace, method, seed=0,
                                 failures_schedule=schedule,
                                 config=EngineConfig(device=device))
        wall = time.perf_counter() - t0
        name = f"{trace.name}/{method}"
        for f in ("latencies", "rates", "usage_cpu", "usage_mem_mb",
                  "workers"):
            a = getattr(res, f)
            if a.shape != (int(duration_s / 5.0),) \
                    or not np.isfinite(a).all():
                fail(f"run_experiment {name}: {f} is not finite")
        if len(res.failures) != n_fail:
            fail(f"run_experiment {name}: {len(res.failures)} failure "
                 f"records for {n_fail} failures")
        if (res.profile_cpu_s > 0) != (method == "demeter"):
            fail(f"run_experiment {name}: profiling cost "
                 f"{res.profile_cpu_s}")
        if method == "demeter":
            chunks = made.made[0].tsf.bank.arima_chunks
            n = k1.arima_chunk.launches
            if device == "cuda" and not (
                    n == chunks > 0 and k1.rls_rank1_update.launches == 0):
                fail(f"run_experiment {name}: {n} arima_chunk launches "
                     f"for {chunks} ARIMA chunks")
            launches[trace.name] = n
        row = table3_row(res, wall)
        rows.append(row)
        print("table3 " + json.dumps(row), flush=True)
    return rows


def paper_protocol_card_vs_cpu(grid_results, devices=("cuda", "cpu")) -> dict:
    """Phase 25: ``run_experiment`` of every method on ysb (2 h, seed 3,
    the scalar GP fits) on each device: arrays at rtol 1e-9, equal
    reconfigurations and failure records; then phase 7's grid on the first
    device with the bank detector against phase 7's run (the scalar one),
    and on the scalar engine against the batched engine, at rtol 1e-9."""
    import numpy as np
    from repro_torch.core import EngineConfig
    from repro_torch.dsp import SweepEngine, run_experiment, ysb_like
    duration, seed = PROTOCOL_CARD_VS_CPU
    trace = ysb_like(duration_s=duration)
    out = {}
    for method in PAPER_METHODS:
        a, b = (run_experiment(trace, method, seed=seed,
                               config=EngineConfig(device=d,
                                                   fit_backend="scalar"))
                for d in devices)
        for f in ("times", "rates", "latencies", "usage_cpu", "usage_mem_mb",
                  "workers"):
            if not np.allclose(getattr(a, f), getattr(b, f), rtol=1e-9,
                               atol=0.0):
                fail(f"run_experiment {method}: {f} differs between "
                     f"{devices}")
        recs = [[(r.t_inject, r.workload, r.recovery_s, r.capped)
                 for r in x.failures] for x in (a, b)]
        if a.n_reconfigurations != b.n_reconfigurations or recs[0] != recs[1]:
            fail(f"run_experiment {method}: reconfigurations "
                 f"{a.n_reconfigurations} vs {b.n_reconfigurations}, "
                 f"failures {recs[0]} vs {recs[1]}")
        out[method] = {"reconfigurations": a.n_reconfigurations,
                       "failures": len(a.failures),
                       "profile_cpu_s": [a.profile_cpu_s, b.profile_cpu_s]}
    print("run_experiment card vs cpu " + json.dumps(out), flush=True)
    specs, config = demeter_grid()
    config = config.replace(device=devices[0])
    grids = {"scalar detector (phase 7)": grid_results[devices[0]]}
    for label, kw in (("bank detector", dict(detector_backend="bank")),
                      ("scalar engine", dict(sim_backend="scalar")),
                      ("batched engine", dict(sim_backend="batched"))):
        t0 = time.perf_counter()
        eng = SweepEngine(specs, config=config.replace(**kw))
        grids[label] = eng.run()
        check_result(grids[label], len(specs), eng.n_steps)
        print(f"demeter 2 h, {label}: wall_s {time.perf_counter() - t0}",
              flush=True)
    for x, y in (("bank detector", "scalar detector (phase 7)"),
                 ("scalar engine", "batched engine")):
        for sa, sb in zip(grids[x].scenarios, grids[y].scenarios):
            if not sa.allclose(sb, rtol=1e-9) \
                    or sa.n_reconfigurations != sb.n_reconfigurations:
                fail(f"Demeter grid, {x} vs {y}: {sa.name}: "
                     f"{first_difference(sa, sb)}")
        if grids[x].n_model_fits != grids[y].n_model_fits:
            fail(f"Demeter grid, {x} vs {y}: n_model_fits differ")
        print(f"demeter 2 h grid: {x} equals {y} at rtol 1e-9 (largest "
              f"relative difference {largest_rel_diff(grids[x], grids[y])})",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# obs and the fleet service
# ---------------------------------------------------------------------------

#: SweepResult keys that are timers or the engine label (copied from the
#: reference's tests/helpers/sharded_diff.py): obs off and on must agree on
#: everything else bit for bit
VOLATILE = ("engine", "wall_s", "model_update_wall_s",
            "forecast_update_wall_s", "model_update_compile_wall_s",
            "forecast_update_compile_wall_s")
#: Phase 26's spans that the Demeter grid must open
OBS_SPANS = ("sweep.run", "engine.fused.interval", "forecast.flush",
             "gp_bank.fit", "demeter.acquire")
#: where phase 26 writes its Chrome trace (build/ is ignored by git)
OBS_TRACE = REPO / "build" / "obs" / "phase26_trace.json"
#: Phase 27: the loadgen CLI's defaults (1 000 jobs, 8 epochs, seed 0; the
#: slab sized to the jobs) and the reference test's profiling soak
SOAK_MAIN = dict(n_jobs=1000, epochs=8, seed=0)
#: K1 as that soak flushes its forecast bank (phase 3 checks and times it):
#: one stream a job, the ARIMA forecaster's default model (p = 8, so k = 9;
#: d = 1) and one staged mean a job and epoch (T = 1)
FLEET_CHUNK = (SOAK_MAIN["n_jobs"], MAIN_K, 1)
SOAK_PROFILING = dict(n_jobs=64, epochs=30, seed=7, profiling=True)
#: spans whose walls phase 27 prints
FLEET_SPANS = ("fleet.epoch", "fleet.ingest.drain", "forecast.flush",
               "detector.observe", "fleet.profile", "gp_bank.fit")


def strip_volatile(res) -> dict:
    return {k: v for k, v in res.to_json().items() if k not in VOLATILE}


def span_walls(tracer, names) -> dict:
    """Each named span's count and summed wall (ms) in ``tracer``."""
    out = {}
    for name in names:
        durs = [r.dur_ns for r in tracer.events if r.name == name]
        out[name] = {"count": len(durs), "wall_ms": sum(durs) / 1e6}
    return out


def obs_phase(device: str = "cuda") -> dict:
    """Phase 26: phase 7's grid (bank GP fits) on ``device`` with obs off,
    then on: equal ``to_json()`` apart from the walls, the spans present,
    ``sweep.intervals`` equal to K2's launches and the forecast-flush
    counters bracketing K1's; the per-phase walls; a Chrome trace written
    and loaded back; the aten-op probe over one ``step_interval`` and one
    forecast-bank flush; the overhead bound of the reference's test."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import ForecastBank
    from repro_torch.dsp import (ClusterModel, FusedSweepExecutor, JobConfig,
                                 SweepEngine)
    from repro_torch.kernels import fused_tick as k2
    from repro_torch.kernels import rls_update as k1
    specs, config = demeter_grid()
    config = config.replace(device=device, fit_backend="bank")
    runs, engines, walls = {}, {}, {}
    for on in (False, True):
        eng = SweepEngine(specs, config=config)
        obs.disable()
        obs.reset()
        if on:
            obs.enable()
        k1.arima_chunk.launches = k2.fused_interval.launches = 0
        t0 = time.perf_counter()
        try:
            runs[on] = eng.run()
            sync(device)
        finally:
            obs.disable()
        walls[on] = time.perf_counter() - t0
        engines[on] = eng
    launches = {"fused_interval": k2.fused_interval.launches,
                "arima_chunk": k1.arima_chunk.launches}
    eng = engines[True]
    if strip_volatile(runs[True]) != strip_volatile(runs[False]):
        fail("obs: the Demeter grid's results differ with obs on: "
             + first_difference(runs[True].scenarios[0],
                                runs[False].scenarios[0]))
    snap = obs.snapshot()
    counters, gauges = snap["counters"], snap["gauges"]
    names = {r.name for r in obs.tracer().events}
    missing = [n for n in OBS_SPANS if n not in names]
    if missing:
        fail(f"obs: spans {missing} missing from the Demeter grid's trace")
    if not counters["sweep.intervals"] == eng.executor.intervals_stepped \
            == (launches["fused_interval"] if device == "cuda"
                else counters["sweep.intervals"]) > 0:
        fail(f"obs: sweep.intervals {counters['sweep.intervals']} for "
             f"{launches['fused_interval']} fused_interval launches")
    # K1 runs once per ARIMA chunk: in a flush that found ARIMA rows staged
    # (a forecast.flush span) or in an ARIMA read's flush_and_roll
    rolls = sum(1 for r in obs.tracer().events
                if r.name == "forecast.flush_and_roll"
                and r.attrs.get("family") == "arima")
    chunks = eng.forecast_bank.arima_chunks
    if device == "cuda" and not (
            launches["arima_chunk"] == chunks
            == gauges["launches.arima_chunk"] > 0
            and rolls <= chunks <= rolls
            + counters["sweep.forecast_flushes"]):
        fail(f"obs: arima_chunk launched {launches['arima_chunk']} times "
             f"for {chunks} chunks, {rolls} ARIMA flush-and-rolls and "
             f"{counters['sweep.forecast_flushes']} flushes")
    phase_walls = {k: v for k, v in counters.items()
                   if k.startswith("phase.")}
    OBS_TRACE.parent.mkdir(parents=True, exist_ok=True)
    obs.write_chrome_trace(str(OBS_TRACE))
    doc = json.loads(OBS_TRACE.read_text())
    if doc["otherData"]["schema"] != obs.TRACE_SCHEMA or \
            len(doc["traceEvents"]) != len(obs.tracer().events) or \
            doc["otherData"]["metrics"]["counters"] != counters:
        fail(f"obs: the Chrome trace {OBS_TRACE} did not load back")
    # the aten-op probe on the card: one interval and one flush
    ex = FusedSweepExecutor(ClusterModel(), [JobConfig()] * 8,
                            seeds=range(8), dt=DT, n_steps=64,
                            device=device)
    rates = np.full((MAIN_INTERVAL, 8), 4.0e4)
    ex.step_interval(rates)              # the config copies, once
    bank = ForecastBank(["arima"] * 8, device=device)
    rng = np.random.default_rng(0)

    def flush():
        for _ in range(MAIN_CHUNK):
            for r in range(8):
                bank.stage(r, float(rng.uniform(1e3, 8e4)))
        bank.flush()

    flush()
    probes = {}
    for label, fn, args in (("step_interval", ex.step_interval, (rates,)),
                            ("forecast flush", flush, ())):
        rep = obs.instrumentation_probe(label, fn, args)
        if not rep.ok:
            fail(f"obs probe {label}: {rep.violations}")
        probes[label] = {"aten_ops": rep.baseline,
                         "with_obs": rep.with_obs}

    overhead = obs_overhead(device)
    out = {"grid_wall_s": {"off": walls[False], "on": walls[True]},
           "spans": len(names), "span_names": sorted(names),
           "counters": {k: v for k, v in counters.items()
                        if not k.startswith("phase.")},
           "phase_walls_s": phase_walls, "gauges": gauges,
           "launches": launches, "arima_flush_and_rolls": rolls,
           "trace": str(OBS_TRACE.relative_to(REPO)),
           "trace_events": len(doc["traceEvents"]),
           "probe": probes, "overhead": overhead}
    print("obs " + json.dumps(out), flush=True)
    return out


def obs_overhead(device: str = "cuda", fresh: int = 10,
                 steady: int = 200) -> dict:
    """What obs costs the fused engine's interval (4 scenarios, 16 ticks).
    The reference test's bound: a fresh executor's first interval, best of
    5 with obs off and on in turn, at most 2% plus 2 ms; printed with the
    relative overhead beside the 2%. Then the same first interval at best
    of ``fresh``, and the steady state: one executor stepped ``steady``
    intervals with obs on and off in turn (medians)."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.dsp import ClusterModel, FusedSweepExecutor, JobConfig
    rates = np.full((16, 4), 1000.0)

    def make_ex(intervals: int = 8):
        return FusedSweepExecutor(ClusterModel(), [JobConfig()] * 4,
                                  seeds=range(4), dt=DT,
                                  n_steps=16 * intervals, device=device)

    def run_once(ex, on: bool) -> float:
        if on:
            obs.enable(clear=True)
        try:
            t0 = time.perf_counter()
            ex.step_interval(rates)
            sync(device)
            return time.perf_counter() - t0
        finally:
            obs.disable()

    def first_intervals(n: int) -> dict:
        best = {False: math.inf, True: math.inf}
        for _ in range(n):
            for on in (False, True):
                best[on] = min(best[on], run_once(make_ex(), on))
        return {"off": best[False], "on": best[True],
                "extra_us": (best[True] - best[False]) * 1e6,
                "rel": best[True] / best[False] - 1.0}

    run_once(make_ex(), False)
    ref = first_intervals(5)
    ref["bound_s"] = ref["off"] * 1.02 + 2e-3
    if not ref["on"] <= ref["bound_s"]:
        fail(f"obs overhead: {ref['off']} s -> {ref['on']} s an interval, "
             f"bound {ref['bound_s']} s")
    first = first_intervals(fresh)
    ex = make_ex(2 * steady + 1)
    run_once(ex, False)
    walls = {False: [], True: []}
    for i in range(2 * steady):
        walls[bool(i % 2)].append(run_once(ex, bool(i % 2)))
    med = {on: float(np.median(w)) for on, w in walls.items()}
    obs.reset()
    out = {"reference_test": ref, "first_interval": first,
           "steady": {"off": med[False], "on": med[True],
                      "extra_us": (med[True] - med[False]) * 1e6,
                      "rel": med[True] / med[False] - 1.0,
                      "intervals": steady}}
    print(f"obs overhead: reference test {ref['off'] * 1e3:.4f} -> "
          f"{ref['on'] * 1e3:.4f} ms an interval ({ref['rel']:+.2%}; bound "
          f"2% + 2 ms = {ref['bound_s'] * 1e3:.4f} ms); first interval, "
          f"best of {fresh}: {first['extra_us']:+.1f} us "
          f"({first['rel']:+.2%}); steady state, median of {steady}: "
          f"{out['steady']['extra_us']:+.1f} us "
          f"({out['steady']['rel']:+.2%})", flush=True)
    return out


#: one JSON-lines script for the service on the card: two sim jobs and one
#: serving job (phase 10's measured profile), telemetry, epochs, an error,
#: a departure
def fleet_script(decode_step_s: float, prefill_s: float) -> list:
    script = [{"op": "register_job", "job_id": "a", "backend": "sim"},
              {"op": "register_job", "job_id": "b", "backend": "sim",
               "params": {"seed": 3}},
              {"op": "register_job", "job_id": "s", "backend": "serving",
               "params": {"decode_step_s": decode_step_s,
                          "prefill_s": prefill_s}}]
    for epoch in range(6):
        t = 60.0 * epoch + 30.0
        # the serving job overloads once while cold: a revert to C_max
        script += [{"op": "report_telemetry", "job_id": j, "t": t,
                    "metrics": {"rate": r + 50.0 * epoch, "latency": lat,
                                "usage": 0.95 if (j, epoch) == ("s", 2)
                                else 0.5}}
                   for j, r, lat in (("a", 800.0, 1.2), ("b", 2e3, 1.8),
                                     ("s", 40.0, 0.9))]
        script.append({"op": "run_epoch"})
    script += [{"op": "recommend", "job_id": "s"},
               {"op": "recommend", "job_id": "a"},
               {"op": "nope"}, {"op": "deregister_job", "job_id": "b"},
               {"op": "run_epoch"}, {"op": "stats"}, {"op": "shutdown"}]
    return script


def fleet_service(decode_step_s: float, prefill_s: float,
                  device: str = "cuda") -> dict:
    """``python -m repro_torch.fleet --device <device>`` as a subprocess
    fed a JSON-lines script; its responses must equal an in-process CPU
    service's to the same script."""
    import io
    import os
    from repro_torch.core import EngineConfig
    from repro_torch.fleet import FleetAPI, FleetConfig, serve_jsonl
    script = "".join(json.dumps(r) + "\n"
                     for r in fleet_script(decode_step_s, prefill_s))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.fleet", "--capacity", "8",
         "--device", device], input=script, env=env, cwd=str(REPO),
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"fleet service: exit {proc.returncode}: {proc.stderr[-2000:]}")
    want = io.StringIO()
    serve_jsonl(FleetAPI(config=EngineConfig(device="cpu"),
                         fleet=FleetConfig(capacity=8)),
                io.StringIO(script), want)
    if proc.stdout != want.getvalue():
        fail("fleet service: the responses on the card differ from the "
             "CPU's:\n" + proc.stdout[-2000:] + "\n---\n"
             + want.getvalue()[-2000:])
    responses = [json.loads(line) for line in proc.stdout.splitlines()]
    rec = responses[-7]
    if rec.get("policy") != "demeter" or "replicas" not in rec["config"] \
            or responses[-2]["decisions"] != 1:
        fail(f"fleet service: the serving job did not revert and warm: "
             f"{rec}, {responses[-2]}")
    out = {"requests": len(responses), "wall_s": wall,
           "serving_job": rec, "stats": responses[-2]}
    print("fleet service " + json.dumps(out), flush=True)
    return out


def fleet_phase(decode_step_s: float, prefill_s: float,
                device: str = "cuda") -> dict:
    """Phase 27: the 1 000-job soak on the card twice (the second with obs
    on) and on the CPU: equal digests and stats; K1 once per forecast-bank
    flush and once per detector sample; the 64 x 30 profiling soak card
    against CPU under scalar fits, then on the card with the bank fits and
    obs on (the same digest, its span walls and its wall); the
    JSON-lines service on the card (``device``; the CPU legs stay on the
    CPU)."""
    from repro_torch import obs
    from repro_torch.core import EngineConfig, gp_bank
    from repro_torch.fleet import SoakConfig, run_soak
    from repro_torch.kernels import gp_fit as kgp
    from repro_torch.kernels import rls_update as k1
    main = SoakConfig(**SOAK_MAIN)
    runs, launches = {}, {}
    for label, dev, on in (("card", device, False),
                           ("card, obs on", device, True),
                           ("cpu", "cpu", False)):
        obs.reset()
        if on:
            obs.enable()
        k1.arima_chunk.launches = 0
        try:
            runs[label] = run_soak(main, EngineConfig(device=dev))
            sync(dev)
        finally:
            obs.disable()
        launches[label] = k1.arima_chunk.launches
        if on:
            snap, walls = obs.snapshot(), span_walls(obs.tracer(),
                                                     FLEET_SPANS)
    ref = runs["card"]
    for label, r in runs.items():
        if r["decision_digest"] != ref["decision_digest"] \
                or r["stats"] != ref["stats"]:
            fail(f"fleet soak: {label} differs from the card's first run: "
                 f"{r['stats']} vs {ref['stats']}")
    c = snap["counters"]
    k1_per_flush = c["sweep.forecast_flushes"] + c["sweep.detector_samples"]
    if not (launches["card"] == launches["card, obs on"]
            == (k1_per_flush if device == "cuda" else 0)
            and c["sweep.detector_samples"] == main.epochs
            and launches["cpu"] == 0):
        fail(f"fleet soak: arima_chunk launches {launches} for "
             f"{c['sweep.forecast_flushes']} flushes and "
             f"{c['sweep.detector_samples']} detector samples")
    if not (ref["decisions"] > 0 and ref["churned"] > 0
            and ref["stats"]["warm"] > 0.9 * main.n_jobs):
        fail(f"fleet soak: {ref['stats']}")
    # the profiling soak: card against CPU on the scalar fits, then the
    # bank fits on the card (ModelBank.batch_refresh on the GP bank)
    prof = SoakConfig(**SOAK_PROFILING)
    on_card, on_cpu = (run_soak(prof, EngineConfig(device=d,
                                                   fit_backend="scalar"))
                       for d in (device, "cpu"))
    if on_card["decision_digest"] != on_cpu["decision_digest"] \
            or on_card["stats"] != on_cpu["stats"]:
        fail(f"profiling soak: card {on_card['stats']} vs CPU "
             f"{on_cpu['stats']}")
    # the bank fits, timed and traced in one run with obs on: the same
    # decisions as the scalar fits (as on the CPU)
    obs.reset()
    obs.enable()
    fits = count_fit_calls(gp_bank)
    kgp.gp_lbfgs.launches = 0
    try:
        bank = run_soak(prof, EngineConfig(device=device))
    finally:
        obs.disable()
        fits.restore()
    if device == "cuda" and not kgp.gp_lbfgs.launches == fits.n > 0:
        fail(f"profiling soak: gp_lbfgs launched {kgp.gp_lbfgs.launches} "
             f"times for {fits.n} GP bank fits")
    print(f"profiling soak gp_lbfgs launches {kgp.gp_lbfgs.launches}, fits "
          f"by rows x n_max {fits.by_shape}", flush=True)
    prof_walls = span_walls(obs.tracer(), FLEET_SPANS)
    gp_fits = obs.snapshot()["counters"].get("sweep.gp_fits", 0)
    obs.reset()
    if bank["decision_digest"] != on_card["decision_digest"] \
            or not gp_fits > 0 or not prof_walls["fleet.profile"]["count"]:
        fail(f"profiling soak on the bank fits: {gp_fits} GP fits, "
             f"{prof_walls}, digests {bank['decision_digest']} (bank) / "
             f"{on_card['decision_digest']} (scalar)")
    sync(device)
    service = fleet_service(decode_step_s, prefill_s, device)
    keys = ("wall_s", "decisions", "decisions_per_s",
            "ingest_samples_per_s", "delivered", "held_late", "lost",
            "failures", "churned")
    out = {"soak": SOAK_MAIN,
           "card": {k: ref[k] for k in keys},
           "card_obs_on": {k: runs["card, obs on"][k] for k in keys},
           "cpu": {k: runs["cpu"][k] for k in keys},
           "digest": ref["decision_digest"], "stats": ref["stats"],
           "arima_chunk_launches": launches["card"],
           "forecast_flushes": c["sweep.forecast_flushes"],
           "detector_samples": c["sweep.detector_samples"],
           "span_walls": walls,
           "phase_walls_s": {k: v for k, v in c.items()
                             if k.startswith("phase.")},
           "profiling_soak": {
               "config": SOAK_PROFILING,
               "scalar_fits_wall_s": {"card": on_card["wall_s"],
                                      "cpu": on_cpu["wall_s"]},
               "bank_fits_obs_on_wall_s": bank["wall_s"],
               "decisions": bank["decisions"], "gp_fits": gp_fits,
               "gp_lbfgs_launches": kgp.gp_lbfgs.launches,
               "gp_fits_by_rows_x_n_max": fits.by_shape,
               "stats": bank["stats"], "span_walls": prof_walls},
           "service_wall_s": service["wall_s"]}
    print("fleet " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

class CpuThreads:
    """All of the host's cores for torch while a full-width CPU leg runs
    (the script keeps torch on one thread otherwise)."""

    def __enter__(self):
        import os
        import torch
        self.n = torch.get_num_threads()
        torch.set_num_threads(os.cpu_count() or 1)

    def __exit__(self, *exc):
        import torch
        torch.set_num_threads(self.n)


class NoTF32:
    """float32 products in full float32 on the card (no TF32) inside."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = self.saved


def device_busy(fn) -> dict:
    """One call of ``fn`` on the host clock and under ``torch.profiler``:
    the device's busy time (the sum of its kernels), its idle share of the
    call and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"call_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               for e in top}}


def largest_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


class LogitsWatch:
    """Wraps the serving engine's ``prefill`` and ``decode_step`` for one
    run: a device-side flag that every logit seen was finite (read once at
    the end, so the engine's one sync per step stays its only one), and,
    with ``keep``, a host copy of every call's logits."""

    def __init__(self, keep: bool = False):
        import torch
        from repro_torch.serving import engine
        self.engine, self.keep = engine, keep
        self.finite = torch.ones((), dtype=torch.bool)
        self.logits, self._undo = [], []
        for name in ("prefill", "decode_step"):
            fn = getattr(engine, name)
            setattr(engine, name, self._wrap(fn))
            self._undo.append((name, fn))

    def _wrap(self, fn):
        def watched(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            if self.finite.device != logits.device:
                self.finite = self.finite.to(logits.device)
            self.finite &= logits.isfinite().all()
            if self.keep:
                self.logits.append(logits.float().cpu())
            return logits, cache
        return watched

    def restore(self) -> bool:
        """Undo the wrapping; returns whether every logit was finite."""
        for name, fn in self._undo:
            setattr(self.engine, name, fn)
        return bool(self.finite)


def serve(eng, prompts, max_tokens: int, keep_logits: bool = False):
    """Submit every prompt at once and run the engine until all complete;
    returns (wall seconds, the watch over its logits)."""
    import torch
    from repro_torch.serving import Request
    watch = LogitsWatch(keep=keep_logits)
    try:
        t0 = time.perf_counter()
        for i, pr in enumerate(prompts):
            eng.submit(Request(f"r{i}", pr, max_tokens=max_tokens,
                               arrival_s=eng.clock()))
        while eng.queue or eng.cache_mgr.active():
            eng.admit()
            eng.step()
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        finite = watch.restore()
    if not finite:
        fail("serving: a logit was not finite")
    for i in range(len(prompts)):
        out = eng.requests[f"r{i}"].output
        if len(out) != max_tokens:
            fail(f"serving: request r{i} produced {len(out)} tokens, not "
                 f"{max_tokens}")
    if eng.metrics.completed != len(prompts):
        fail(f"serving: {eng.metrics.completed} of {len(prompts)} requests "
             f"completed")
    return wall, watch


def decode_profile(eng, prompts, warmup: int = 3, steps: int = 5) -> dict:
    """Fill every slot of ``eng`` with ``prompts``, then time ``steps``
    full-batch decode steps on the host clock and trace the same number
    under ``torch.profiler`` (:func:`device_busy`): the device's busy time
    per step, its idle share of the step and the kernels that take the
    most device time."""
    from repro_torch.serving import Request
    for i, pr in enumerate(prompts):
        eng.submit(Request(f"p{i}", pr, max_tokens=warmup + 2 * steps + 2,
                           arrival_s=eng.clock()))
    eng.admit()
    for _ in range(warmup):
        eng.step()

    def run_steps():
        for _ in range(steps):
            eng.step()
    p = device_busy(run_steps)
    return {"step_ms": p["call_ms"] / steps,
            "device_busy_ms": p["device_busy_ms"] / steps,
            "idle_share": p["idle_share"],
            "top_kernels_ms_per_step": {k: v / steps for k, v in
                                        p["top_kernels_ms"].items()}}


def expected_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """Each kernel's launches on a serving run: K3 once per layer and decode
    step of a model with per-head KV (dense, and moe without MLA); K5 once
    per mamba layer and prefill of more than one token (the ssm and hybrid
    families; the hybrid's shared block uses the plain attention, as the
    reference's does); K6 three times (gate, up, down) per MoE layer and
    model call, prefill or decode step; K7 never (no model calls it)."""
    kv_heads = cfg.family == "dense" or (cfg.family == "moe"
                                         and cfg.mla is None)
    moe_layers = (cfg.n_layers - cfg.moe.first_dense_layers
                  if cfg.family == "moe" else 0)
    return {"decode_attention": decode_steps * cfg.n_layers if kv_heads
            else 0,
            "ssd_scan": (prefills * cfg.n_layers
                         if cfg.family in ("ssm", "hybrid") else 0),
            "grouped_matmul": 3 * moe_layers * (prefills + decode_steps),
            "fused_rmsnorm": 0}


def serving_main_path(device: str = "cuda", arch: str = SERVE_ARCH,
                      n_requests: int = SERVE_REQUESTS,
                      new_tokens: int = SERVE_NEW_TOKENS) -> dict:
    """A serving path at full width on ``device`` (phase 8: qwen2-7b;
    phases 11 and 13: mamba2-1.3b and zamba2-2.7b; phases 19 and 21:
    deepseek-moe-16b and deepseek-v2-lite-16b): ``n_requests`` prompts
    of 256-2048 tokens through 16 slots, so a second wave reuses slots;
    returns the kernels' launches and the path's numbers. On the card an
    MoE model's routes are compared (:func:`moe_route_check`), and an MLA
    model's absorbed decode with its naive path
    (:func:`mla_absorbed_check`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models import init_params, logits_from_hidden
    from repro_torch.serving import ServingEngine
    k3 = kernel_module("decode_attention")
    k5 = kernel_module("ssd_scan")
    k6 = kernel_module("grouped_matmul")
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=device)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServingEngine(cfg, model, n_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, device=device)
    cache_gb = sum(v.numel() * v.element_size() for k, v in eng.cache.items()
                   if k != "index") / 1e9
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    slots = []                  # the slot of every prefill, in order
    admit = eng._prefill_into_slot
    eng._prefill_into_slot = lambda slot, req: (slots.append(slot),
                                                admit(slot, req))
    timers = LayerTimers()
    timers.wrap(eng, "_prefill_into_slot", "prefill")
    timers.wrap(eng, "step", "decode step")
    k3.decode_attention.launches = 0
    k5.ssd_scan.launches = 0
    k6.grouped_matmul.launches = 0
    k7.fused_rmsnorm.launches = 0
    try:
        wall, _ = serve(eng, prompts, new_tokens)
    finally:
        timers.restore()
        del eng._prefill_into_slot
    launches = {"decode_attention": k3.decode_attention.launches,
                "ssd_scan": k5.ssd_scan.launches,
                "grouped_matmul": k6.grouped_matmul.launches,
                "fused_rmsnorm": k7.fused_rmsnorm.launches}
    steps = eng.metrics.decode_steps
    reused = len(slots) - len(set(slots))
    want = expected_launches(cfg, len(slots), steps)
    if on_card and launches != want:
        fail(f"{arch}: kernel launches {launches}, expected {want} "
             f"({len(slots)} prefills, {steps} decode steps, "
             f"{cfg.n_layers} layers)")
    if reused < n_requests - SERVE_SLOTS:
        fail(f"{arch}: {reused} prefills went into a reused slot, expected "
             f"{n_requests - SERVE_SLOTS}")
    # the LM head alone at the decode batch, on the device, and a profile
    # of full-batch decode steps
    h = torch.randn(SERVE_SLOTS, 1, cfg.d_model, device=device,
                    dtype=torch.bfloat16)
    lm_head_ms = (device_ms(lambda: logits_from_hidden(model, h))
                  if on_card else None)
    extra = {}
    if on_card and cfg.family == "moe":
        extra["route_check"] = moe_route_check(model, cfg, prompts[:2])
    if on_card and cfg.mla is not None:
        extra["absorbed_check"] = mla_absorbed_check(model, cfg, eng.cache)
    profile = decode_profile(eng, prompts[:SERVE_SLOTS]) if on_card else None
    out = {"arch": arch, "params": n_params, "init_s": init_s,
           "cache_gb": cache_gb, "requests": n_requests,
           "prompt_tokens": int(lens.sum()),
           "new_tokens": n_requests * new_tokens, "wall_s": wall,
           "decode_steps": steps, "reused_slot_prefills": reused,
           "mean_step_s": float(np.mean(np.fromiter(
               eng.metrics.step_times, float))),
           "p95_latency_s": eng.metrics.p95_latency(),
           "tokens_per_s": n_requests * new_tokens / wall,
           "layer_wall_s": timers.wall, "layer_calls": timers.calls,
           "lm_head_ms": lm_head_ms, "decode_profile": profile,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None),
           "launches": launches, **extra}
    print(f"serving main path {arch} " + json.dumps(out), flush=True)
    return out


def moe_route_check(model, cfg, prompts) -> dict:
    """Phases 19 and 21: each prompt's last prefill logits on the kernel
    route (K6) against the reference route (the capacity buffer's einsums),
    the same weights, on the card: within ``MOE_ROUTE_BAR`` of their scale,
    and the greedy token equal or, where it differs, the top-2 gap (on the
    reference route) below the largest logit difference."""
    import dataclasses
    import torch
    from repro_torch.models import init_cache, prefill
    param = next(model.parameters())
    rels, same = [], []
    try:
        for pr in prompts:
            runs = []
            for impl in ("kernel", "reference"):
                model.cfg = dataclasses.replace(cfg, attention_impl=impl)
                cache = init_cache(cfg, 1, len(pr), dtype=param.dtype,
                                   device=param.device)
                logits, _ = prefill(model, torch.as_tensor(
                    pr, device=param.device)[None], cache)
                runs.append(logits[0].float().cpu())
                del cache
            a, b = runs
            rels.append(largest_rel(a, b))
            same.append(int(a.argmax()) == int(b.argmax()))
            top2 = b.topk(2).values
            if not (same[-1] or float(top2[0] - top2[1])
                    < float((a - b).abs().max())):
                fail(f"{cfg.name}: the K6 and einsum routes pick tokens "
                     f"{int(a.argmax())} and {int(b.argmax())} beyond "
                     f"rounding")
    finally:
        model.cfg = cfg
    if not max(rels) <= MOE_ROUTE_BAR:
        fail(f"{cfg.name}: the K6 route's prefill logits differ from the "
             f"einsum route's by {max(rels)} of their scale (bar "
             f"{MOE_ROUTE_BAR})")
    return {"prompt_tokens": [len(p) for p in prompts],
            "max_rel_logit_diff": rels, "same_greedy_token": same}


def mla_absorbed_check(model, cfg, cache) -> dict:
    """Phase 21: one decode step of an MLA layer (layer 1) in latent space
    against the naive path, from the same cache (the engine's, as its
    last requests left it) at random per-row ages, bf16: within
    ``MLA_ABSORBED_BAR`` of the output's scale."""
    import torch
    from repro_torch.models import mla
    layer = 1
    cc, cr = cache["c_kv"][layer], cache["k_rope"][layer]
    g = torch.Generator(device=cc.device).manual_seed(5)
    b = cc.shape[0]
    x = torch.randn(b, 1, cfg.d_model, generator=g, device=cc.device
                    ).to(cc.dtype)
    ages = torch.randint(1, cc.shape[1], (b,), generator=g,
                         device=cc.device)
    p = model.blocks[layer].mixer
    with torch.no_grad():
        q_nope, q_rope = mla._queries(p, cfg, x, ages[:, None])
        got = mla._absorbed_decode(p, cfg, q_nope, q_rope, cc, cr, ages + 1)
        want = mla._naive(p, cfg, q_nope, q_rope, cc, cr,
                          q_positions=ages[:, None], kv_valid_len=ages + 1)
    rel = largest_rel(got.float(), want.float())
    if not (bool(got.isfinite().all()) and rel <= MLA_ABSORBED_BAR):
        fail(f"{cfg.name}: the absorbed decode differs from the naive path "
             f"by {rel} of its scale (bar {MLA_ABSORBED_BAR})")
    return {"rows": b, "max_rel_diff": rel}


def first_token_difference(a, b):
    """Where two runs' greedy picks first part, call by call and row by row:
    ``(call, description, explained)``, with ``explained`` true when the
    top-2 logit gap there (in the second run) is below the largest logit
    difference of that row; ``(None, "", True)`` when every pick agrees."""
    for c, (x, y) in enumerate(zip(a, b)):
        for r in range(x.shape[0]):
            if int(x[r].argmax()) == int(y[r].argmax()):
                continue
            top2 = y[r].topk(2).values
            gap = float(top2[0] - top2[1])
            diff = float((x[r] - y[r]).abs().max())
            return c, (f"call {c} row {r}: {int(x[r].argmax())} vs "
                       f"{int(y[r].argmax())}; top-2 gap {gap}, logit "
                       f"difference {diff}"), gap < diff
    return None, "", True


def serving_card_vs_cpu(devices=("cuda", "cpu"), arch: str = SERVE_ARCH
                        ) -> dict:
    """Phases 9, 12 and 14: the same weights and requests at full width but
    few layers (``CARD_VS_CPU``) on the card (the kernels) and on the CPU
    (their plain versions), float32 with TF32 off."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    layers, n_requests, prompt_lens, new_tokens = CARD_VS_CPU[arch]
    cfg = get_config(arch).scaled(n_layers=layers)
    with NoTF32():
        first = init_params(cfg, seed=0, device=devices[0],
                            dtype=torch.float32)
        models = [first, copy.deepcopy(first).to(devices[1])]
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, int(n))
                   for n in rng.integers(prompt_lens[0], prompt_lens[1] + 1,
                                         n_requests)]
        max_len = 64 * -(-(prompt_lens[1] + new_tokens) // 64)
        runs = []
        for dev, model in zip(devices, models):
            eng = ServingEngine(cfg, model, n_slots=n_requests,
                                max_len=max_len, device=dev)
            wall, watch = serve(eng, prompts, new_tokens, keep_logits=True)
            runs.append((wall, watch.logits,
                         [eng.requests[f"r{i}"].output
                          for i in range(n_requests)]))
    (card_wall, a, card_out), (cpu_wall, b, cpu_out) = runs
    if len(a) != len(b):
        fail(f"{arch} card vs CPU: {len(a)} vs {len(b)} model calls")
    call, where, explained = first_token_difference(a, b)
    # logits stay comparable up to the first differing pick
    calls = len(a) if call is None else call + 1
    rel = max(largest_rel(x, y) for x, y in zip(a[:calls], b[:calls]))
    if card_out != cpu_out or call is not None:
        print(f"{arch} card vs CPU: picks differ at {where}", flush=True)
        if not explained:
            fail(f"{arch} card vs CPU: picks differ beyond rounding: "
                 f"{where}")
    out = {"arch": arch, "layers": cfg.n_layers, "requests": len(prompts),
           "prompt_tokens": [len(pr) for pr in prompts],
           "tokens_equal": card_out == cpu_out,
           "max_rel_logit_diff": rel, "calls_compared": calls,
           "wall_s": dict(zip(devices, (card_wall, cpu_wall)))}
    print(f"serving card vs cpu {arch} " + json.dumps(out), flush=True)
    return out


def autoscaled_serving(device: str = "cuda") -> dict:
    """Phase 10: ``run_autoscaled`` on ``device`` for 3600 simulated s."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_autoscaled
    t0 = time.perf_counter()
    res = run_autoscaled(get_config(SERVE_ARCH),
                         types.SimpleNamespace(rate=8.0, duration_s=3600.0),
                         device=device)
    p = res["profile"]
    for key in ("decode_step_s", "prefill_s"):
        v = getattr(p, key)
        if not (math.isfinite(v) and v > 0):
            fail(f"autoscaled serving: calibrated {key} = {v}")
    if not all(math.isfinite(v) for v in res["final_telemetry"].values()):
        fail(f"autoscaled serving: telemetry {res['final_telemetry']}")
    out = {"decode_step_s": p.decode_step_s, "prefill_s": p.prefill_s,
           "base_slots": p.base_slots,
           "reconfigurations": res["reconfigurations"],
           "final_config": res["final_config"],
           "final_telemetry": res["final_telemetry"],
           "wall_s": time.perf_counter() - t0}
    print("autoscaled serving " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# the cacheless forward: encoder and vlm
# ---------------------------------------------------------------------------

def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def encoder_main_path(device: str = "cuda", clips: int = ENCODE_CLIPS,
                      frames: int = ENCODE_FRAMES) -> dict:
    """Phase 15: hubert-xlarge at full width in bfloat16 encodes ``clips``
    clips of ``frames`` frames ``ENCODE_CALLS`` times after a warm-up; K4
    launches once per layer and call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encode, init_params
    k4 = kernel_module("flash_attention")
    on_card = device == "cuda"
    cfg = get_config(ENCODER_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=device).manual_seed(0)
    batch = {"frames": torch.randn((clips, frames, cfg.frontend.d_in),
                                   generator=g, device=device
                                   ).to(torch.bfloat16)}
    encode(model, batch)                                   # warm-up
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    k4.flash_attention.launches = 0
    walls, finite = [], True
    for _ in range(ENCODE_CALLS):
        t0 = time.perf_counter()
        logits = encode(model, batch)
        sync(device)
        walls.append(time.perf_counter() - t0)
        finite = finite and bool(logits.isfinite().all())
    launches = k4.flash_attention.launches
    want_shape = (clips, frames, cfg.vocab_size)
    if tuple(logits.shape) != want_shape or not finite:
        fail(f"{ENCODER_ARCH} encode: logits {tuple(logits.shape)} "
             f"(expected {want_shape}), finite {finite}")
    if on_card and launches != ENCODE_CALLS * cfg.n_layers:
        fail(f"{ENCODER_ARCH} encode: {launches} flash_attention launches "
             f"in {ENCODE_CALLS} calls, expected {cfg.n_layers} per call")
    wall = statistics.median(walls)
    out = {"arch": ENCODER_ARCH, "params": sum(p.numel()
                                               for p in model.parameters()),
           "init_s": init_s, "clips": clips, "frames": frames,
           "calls": ENCODE_CALLS, "wall_s": walls, "median_wall_s": wall,
           "frames_per_s": clips * frames / wall,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None),
           "launches": {"flash_attention": launches},
           "launches_per_call": launches // ENCODE_CALLS,
           "profile": (device_busy(lambda: encode(model, batch))
                       if on_card else None)}
    print("encoder main path " + json.dumps(out), flush=True)
    return out


def encoder_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """Phase 16: hubert-xlarge at full width but ``ENCODER_CARD_VS_CPU``'s
    layers, float32 with TF32 off, the same weights and frames on the card
    (K4) and on the CPU (its plain version); the logits within 1e-4 of
    their scale, and each frame's class equal or, where it differs, its
    top-2 gap (on the CPU) below the frame's logit difference."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encode, init_params
    k4 = kernel_module("flash_attention")
    layers, b, s, _ = ENCODER_CARD_VS_CPU
    cfg = get_config(ENCODER_ARCH).scaled(n_layers=layers)
    frames = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (b, s, cfg.frontend.d_in)).astype(np.float32))
    with NoTF32():
        model = init_params(cfg, seed=0, device=devices[0],
                            dtype=torch.float32)
        k4.flash_attention.launches = 0
        card = encode(model, {"frames": frames.to(devices[0])}).cpu()
        launches = k4.flash_attention.launches
    model = model.to(devices[1])
    with CpuThreads():
        cpu = encode(model, {"frames": frames.to(devices[1])}).cpu()
    if devices[0] == "cuda" and launches != layers:
        fail(f"{ENCODER_ARCH} card vs CPU: {launches} flash_attention "
             f"launches, expected {layers}")
    rel = largest_rel(card, cpu)
    a, c = card.reshape(-1, card.shape[-1]), cpu.reshape(-1, cpu.shape[-1])
    differ = (a.argmax(-1) != c.argmax(-1)).nonzero().flatten().tolist()
    for r in differ:
        top2 = c[r].topk(2).values
        gap, diff = float(top2[0] - top2[1]), float((a[r] - c[r]).abs().max())
        if not gap < diff:
            fail(f"{ENCODER_ARCH} card vs CPU: frame {r} classes "
                 f"{int(a[r].argmax())} vs {int(c[r].argmax())}, top-2 gap "
                 f"{gap} >= logit difference {diff}")
    if not rel < 1e-4:
        fail(f"{ENCODER_ARCH} card vs CPU: relative logit difference {rel}")
    out = {"arch": ENCODER_ARCH, "layers": layers, "clips": b, "frames": s,
           "max_rel_logit_diff": rel, "classes_differ": len(differ),
           "launches": launches}
    print("encoder card vs cpu " + json.dumps(out), flush=True)
    return out


def vlm_batch(cfg, b: int, s: int, prefix: int, dtype, device, seed: int = 0):
    """Random tokens and labels (seeded NumPy) and a patch prefix of
    ``prefix`` embeddings for a vlm's ``train_loss``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, s))).to(device),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, s))).to(device),
            "patches": torch.from_numpy(rng.normal(
                0, 1, (b, prefix, cfg.frontend.d_in)).astype(np.float32)
            ).to(device=device, dtype=dtype)}


def vlm_main_path(device: str = "cuda", seq: int = VLM_SEQ) -> dict:
    """Phase 17: pixtral-12b at full width in bfloat16 takes the training
    loss of ``VLM_BATCH`` sequences of ``VLM_SEQ`` tokens with its patch
    prefix; K4 launches once per layer; the same model on the reference
    route (the plain attention) gives the loss within 1e-2."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.pixtral_12b import PATCH_PREFIX
    from repro_torch.models import init_params, train_loss
    k4 = kernel_module("flash_attention")
    on_card = device == "cuda"
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    batch = vlm_batch(cfg, VLM_BATCH, seq, PATCH_PREFIX, torch.bfloat16,
                      device)
    train_loss(model, batch)                               # warm-up
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    k4.flash_attention.launches = 0
    t0 = time.perf_counter()
    loss, parts = train_loss(model, batch)
    loss = float(loss)
    wall = time.perf_counter() - t0
    launches = k4.flash_attention.launches
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if on_card
               else None)
    if on_card and launches != cfg.n_layers:
        fail(f"{VLM_ARCH} train_loss: {launches} flash_attention launches, "
             f"expected {cfg.n_layers}")
    model.cfg = dataclasses.replace(cfg, attention_impl="reference")
    t0 = time.perf_counter()
    with torch.no_grad():           # that route keeps autograd's graph
        ref_loss = float(train_loss(model, batch)[0])
    ref_wall = time.perf_counter() - t0
    model.cfg = cfg
    rel = abs(loss - ref_loss) / abs(ref_loss)
    if not (math.isfinite(loss) and rel < 1e-2):
        fail(f"{VLM_ARCH} train_loss: {loss} on the kernel route, "
             f"{ref_loss} on the reference route")
    out = {"arch": VLM_ARCH, "params": sum(p.numel()
                                           for p in model.parameters()),
           "init_s": init_s, "batch": VLM_BATCH, "seq": seq,
           "patches": PATCH_PREFIX, "loss": loss, "ce": float(parts["ce"]),
           "reference_route_loss": ref_loss, "rel_diff": rel,
           "wall_s": wall, "reference_route_wall_s": ref_wall,
           "tokens_per_s": VLM_BATCH * seq / wall,
           "peak_memory_gb": peak_gb,
           "launches": {"flash_attention": launches}}
    print("vlm main path " + json.dumps(out), flush=True)
    return out


def vlm_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """Phase 18: pixtral-12b at full width but ``VLM_CARD_VS_CPU``'s
    layers, float32 with TF32 off, on the card and on the CPU: the loss
    within 1e-5 and the logits (with the patch prefix) within 1e-4 of
    their scale."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (forward, init_params, logits_from_hidden,
                                    train_loss)
    layers, b, s, prefix = VLM_CARD_VS_CPU
    cfg = get_config(VLM_ARCH).scaled(n_layers=layers)
    batch = vlm_batch(cfg, b, s, prefix, torch.float32, "cpu", seed=3)

    def run(model, device):
        on = {k: v.to(device) for k, v in batch.items()}
        loss = float(train_loss(model, on)[0])
        with torch.no_grad():
            logits = logits_from_hidden(model, forward(
                model, on["tokens"], patches=on["patches"])).cpu()
        return loss, logits
    with NoTF32():
        model = init_params(cfg, seed=0, device=devices[0],
                            dtype=torch.float32)
        card = run(model, devices[0])
    model = model.to(devices[1])
    with CpuThreads():
        cpu = run(model, devices[1])
    del model
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    rel = largest_rel(card[1], cpu[1])
    if not (loss_rel < 1e-5 and rel < 1e-4):
        fail(f"{VLM_ARCH} card vs CPU: loss {card[0]} vs {cpu[0]} "
             f"(relative {loss_rel}), relative logit difference {rel}")
    out = {"arch": VLM_ARCH, "layers": layers, "batch": b, "seq": s,
           "patches": prefix, "loss": dict(zip(("cuda", "cpu"),
                                               (card[0], cpu[0]))),
           "loss_rel_diff": loss_rel, "max_rel_logit_diff": rel}
    print("vlm card vs cpu " + json.dumps(out), flush=True)
    return out


def launch_counted():
    """Every kernel wrapper that counts its launches: K1-K7, the per-tick
    counterparts of K2 and K1, and the GP fit."""
    from repro_torch.kernels import fused_tick, gp_fit, rls_update, rmsnorm
    decode_attention, flash_attention, grouped_matmul, ssd_scan = (
        kernel_module(name) for name in ("decode_attention",
                                         "flash_attention", "grouped_matmul",
                                         "ssd_scan"))
    return (fused_tick.fused_interval, rls_update.arima_chunk,
            decode_attention.decode_attention, ssd_scan.ssd_scan,
            flash_attention.flash_attention, grouped_matmul.grouped_matmul,
            rmsnorm.fused_rmsnorm, fused_tick.fused_tick,
            rls_update.rls_rank1_update, gp_fit.gp_lbfgs)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count."""
    return {f.__name__: f.launches for f in launch_counted()}


def reset_kernel_launches() -> None:
    for f in launch_counted():
        f.launches = 0


def record_grad_norms(tr, norms: list, after_first=None):
    """Wrap ``tr``'s train step so that each step appends its grad norm to
    ``norms`` (and ``after_first()`` runs after the first); returns the
    unwrapped step."""
    step_fn = tr._step_fn

    def step(*a):
        out = step_fn(*a)
        norms.append(float(out[2]["grad_norm"]))
        if after_first is not None and len(norms) == 1:
            after_first()
        return out
    tr._step_fn = step
    return step_fn


def train_step_bound(cfg, batch: int, seq: int, state_bytes: float) -> dict:
    """The least time of one train step on the card: the matmuls' 6 N D
    (N the matmul parameters, D the tokens) plus the plain attention's
    score and value products (forward and backward, the full S x S the
    route computes) at the dense bf16 peak, against reading and writing
    the parameters, moments and error feedback once at the memory rate."""
    d, L = cfg.d_model, cfg.n_layers
    per_layer = 4 * d * d + 3 * d * cfg.d_ff
    matmul_params = L * per_layer + d * cfg.vocab_size
    attn = 3 * 4 * batch * seq ** 2 * d * L
    ops = 6 * matmul_params * batch * seq + attn
    return {"matmul_params": matmul_params, "tflop": ops / 1e12,
            **bound(2 * state_bytes, ops, BF16_OPS_PER_S)}


def training_main_path(device: str = "cuda", layers: int = TRAIN_LAYERS,
                       seq: int = TRAIN_SEQ, arch: str = TRAIN_ARCH) -> dict:
    """Phase 28: ``ElasticTrainer`` on ``arch`` at full width in bfloat16
    (``layers`` layers) on the plain attention route, with int8
    error-feedback compression and 2 microbatches: TRAIN_FAIL_AFTER steps
    with a checkpoint every TRAIN_CKPT_EVERY, a failure, then steps until
    TRAIN_UNTIL (the restore of the newest checkpoint and the replay of the
    steps after it, then a second checkpoint). The replayed losses equal the
    first pass's bit for bit, every loss is finite and every grad norm
    positive, and no kernel of the port launches (the reference's training
    runs none of its Pallas kernels). Prints the median step time, the
    save (host copy), write and restore walls, the peak device memory and
    one step's device idle share."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.training import (DataConfig, ElasticTrainer, FTConfig,
                                      OptimizerConfig, TrainConfig)
    on_card = device == "cuda"
    cfg = get_config(arch).scaled(n_layers=layers,
                                  attention_impl="reference")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = ElasticTrainer(
        cfg, TrainConfig(optimizer=OptimizerConfig(
            lr=6e-4, warmup_steps=2, total_steps=TRAIN_UNTIL),
            accum_steps=2, compress_grads=True),
        DataConfig(batch_per_host=TRAIN_BATCH, seq_len=seq),
        FTConfig(checkpoint_dir=str(TRAIN_CKPT),
                 checkpoint_interval_steps=TRAIN_CKPT_EVERY),
        device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    walls = {"save_s": [], "write_wait_s": [], "restore_s": []}
    norms, first_step = [], {}

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            sync(device)
            walls[key].append(time.perf_counter() - t)
            return out
        return run

    step_fn = record_grad_norms(
        tr, norms, lambda: first_step.update(kernel_launches()))
    tr.ckpt.save = timed("save_s", tr.ckpt.save)
    tr.ckpt.wait = timed("write_wait_s", tr.ckpt.wait)
    tr._recover = timed("restore_s", tr._recover)
    reset_kernel_launches()
    tr.run(TRAIN_FAIL_AFTER)
    first = {e.step: e.loss for e in tr.events}
    tr.inject_failure()
    tr.run(TRAIN_UNTIL - TRAIN_CKPT_EVERY)
    launches = kernel_launches()
    replay = tr.events[TRAIN_FAIL_AFTER:]
    replayed = [e for e in replay if e.step in first]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    steps = [e.step for e in tr.events]
    want = list(range(TRAIN_FAIL_AFTER)) + list(range(TRAIN_CKPT_EVERY,
                                                      TRAIN_UNTIL))
    if steps != want or tr.step != TRAIN_UNTIL:
        fail(f"training: step events {steps}, expected {want}")
    if not replayed or any(e.loss != first[e.step] for e in replayed):
        fail(f"training: the replay parts from the first pass: "
             f"{[(e.step, e.loss, first[e.step]) for e in replayed]}")
    if not all(math.isfinite(e.loss) for e in tr.events) \
            or not all(n > 0 and math.isfinite(n) for n in norms):
        fail(f"training: losses {[e.loss for e in tr.events]}, grad norms "
             f"{norms}")
    if any(launches.values()) or any(first_step.values()):
        fail(f"training launched the port's kernels: {launches}")
    if tr.ckpt.list_steps() != [TRAIN_CKPT_EVERY, TRAIN_UNTIL]:
        fail(f"training: checkpoints {tr.ckpt.list_steps()}")
    state_bytes = sum(t.numel() * t.element_size() for t in
                      [*tr.model.parameters(),
                       *tr.state["opt"]["m"].values(),
                       *tr.state["opt"]["v"].values(),
                       *tr.state["ef"].values()])
    tokens = TRAIN_BATCH * seq
    durations = [e.duration_s for e in tr.events[1:]]
    out = {"arch": arch, "layers": layers, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in tr.model.parameters()),
           "batch": TRAIN_BATCH, "seq": seq, "accum_steps": 2,
           "compress_grads": True, "init_s": init_s,
           "losses": [e.loss for e in tr.events], "grad_norms": norms,
           "replayed_steps": [e.step for e in replayed],
           "first_step_s": tr.events[0].duration_s,
           "step_s_median": statistics.median(durations),
           "tokens_per_s": tokens / statistics.median(durations),
           "checkpoint_gb": state_bytes / 1e9, **walls,
           "peak_memory_gb": peak_gb,
           "launches_first_step": first_step, "launches": launches,
           "bound": train_step_bound(cfg, TRAIN_BATCH, seq, state_bytes)}
    if on_card:
        batch = tr.batch(tr.step)
        out["one_step"] = device_busy(
            lambda: step_fn(tr.model, tr.state, batch))
        out["bound"]["share_of_median_step"] = \
            out["bound"]["bound_ms"] / (out["step_s_median"] * 1e3)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    del tr
    print("training main path " + json.dumps(out), flush=True)
    return out


def training_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """Phase 29: the trainer on deepseek-7b's smoke config in float32
    (TF32 off) with 2 microbatches, TRAIN_CARD_VS_CPU's steps on each
    device from the same parameters: losses, grad norms and final
    parameters within TRAIN_CARD_VS_CPU_BAR. Adam's eps is 1e-3 here, not
    1e-8, where an entry whose gradient is a few ulps of its terms would
    move by a fraction of the learning rate that those last bits decide;
    and the gradients are not compressed, since an int8 code one ulp from
    a rounding tie may round either way on the two devices."""
    import shutil
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.training import (DataConfig, ElasticTrainer, FTConfig,
                                      OptimizerConfig, TrainConfig)
    b, s, steps = TRAIN_CARD_VS_CPU
    cfg = smoke_config(TRAIN_ARCH).scaled(attention_impl="reference",
                                          dtype="float32")
    runs, base = {}, None
    for dev in devices:
        d = TRAIN_CKPT.with_name(f"train_ckpt_{dev}")
        shutil.rmtree(d, ignore_errors=True)
        norms = []
        with NoTF32(), (CpuThreads() if dev == "cpu"
                        else contextlib.nullcontext()):
            tr = ElasticTrainer(
                cfg, TrainConfig(optimizer=OptimizerConfig(
                    lr=1e-3, warmup_steps=0, total_steps=steps, eps=1e-3),
                    accum_steps=2),
                DataConfig(batch_per_host=b, seq_len=s),
                FTConfig(checkpoint_dir=str(d),
                         checkpoint_interval_steps=steps), device=dev)
            if base is None:
                base = {k: v.cpu() for k, v in tr.model.state_dict().items()}
            tr.model.load_state_dict(base)
            record_grad_norms(tr, norms)
            if dev == "cuda":
                reset_kernel_launches()
            tr.run(steps)
            launches = kernel_launches() if dev == "cuda" else None
        runs[dev] = ([e.loss for e in tr.events], norms,
                     {k: p.detach().cpu()
                      for k, p in tr.model.named_parameters()}, launches)
        shutil.rmtree(d, ignore_errors=True)
    (lc, nc, pc, launches), (lh, nh, ph, _) = (runs[d] for d in devices)
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))  # noqa
    loss_rel, norm_rel = rel(lc, lh), rel(nc, nh)
    param_err = max(float((pc[k] - p).abs().max() / p.abs().max())
                    for k, p in ph.items())
    bar = TRAIN_CARD_VS_CPU_BAR
    if not (loss_rel < bar and norm_rel < bar and param_err < bar):
        fail(f"training card vs CPU: losses {lc} vs {lh}, grad norms {nc} "
             f"vs {nh}, parameters {param_err} of scale")
    if devices[0] == "cuda" and any(launches.values()):
        fail(f"training card vs CPU launched the port's kernels: {launches}")
    out = {"arch": cfg.name, "steps": steps, "batch": b, "seq": s,
           "losses": dict(zip(devices, (lc, lh))), "loss_rel_diff": loss_rel,
           "grad_norm_rel_diff": norm_rel, "param_err_of_scale": param_err,
           "bar": bar, "launches": launches}
    print("training card vs cpu " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# contracts and the scenario mesh
# ---------------------------------------------------------------------------

#: the probes whose CUDA-graph replay phase 30 requires: K2's interval, K1's
#: chunk and the GP fit kernel
GRAPH_PROBES = ("engine:fused", "forecast backend:bank", "kernel:gp-lbfgs")
#: the fields the seeded violation must break
SEEDED_FIELDS = {"forbid_host_sync", "dtype_ceiling", "in_place"}


def contracts_phase(device: str = "cuda") -> dict:
    """Phase 30: ``scripts/check_contracts_torch.py`` over the five
    registries on ``device``: every contract holds (launch budgets, no host
    sync, on the card also under the sync debug mode), the graph probes
    replay bit-equal from a CUDA graph on the card, and the seeded
    violation is red. Each probe's time is printed."""
    sys.path.insert(0, str(REPO / "scripts"))
    import check_contracts_torch as cc
    from repro_torch.analysis.contracts import run_probe
    from repro_torch.core.registry import SIM_ENGINES

    reports = cc.check_all(device, out=lambda line: print(
        f"contract {line}", flush=True))
    bad = [r.summary() for r in reports if not r.ok]
    if bad:
        fail("contracts: " + " | ".join(bad))
    by_name = {r.name: r for r in reports}
    for name in GRAPH_PROBES:
        r = by_name[name]
        if device == "cuda" and r.skipped:
            fail(f"contract {name} skipped {r.skipped} on the card")
    cc.seed_violation()
    try:
        seeded = [run_probe(p) for p in [SIM_ENGINES.contract_for(
            "seeded-violation")(device)]][0]
    finally:
        SIM_ENGINES.unregister("seeded-violation")
    fields = {v.field for v in seeded.violations}
    if seeded.ok or fields != SEEDED_FIELDS:
        fail(f"the seeded violation broke {sorted(fields)}, not "
             f"{sorted(SEEDED_FIELDS)}")
    out = {"device": device, "contracts": len(reports),
           "seconds": {r.name: r.seconds for r in reports},
           "launches": {r.name: r.launches for r in reports if r.launches},
           "graph_replayed": [n for n in GRAPH_PROBES
                              if not by_name[n].skipped],
           "seeded_fields": sorted(fields)}
    print("contracts " + json.dumps(out), flush=True)
    return out


def mesh_grid():
    """Phase 31's grid: 2 traces x static/reactive, 15 minutes, a failure
    every 7 minutes (the reference's uniform differential case)."""
    from repro_torch.dsp import PeriodicFailures, make_trace, scenario_grid
    traces = [make_trace(k, duration_s=900.0, dt_s=5.0)
              for k in ("diurnal", "flash")]
    return scenario_grid(traces, ("static", "reactive"), (0, 1),
                         failures=PeriodicFailures(420.0))


def same_scenarios(a, b) -> bool:
    """Every scenario's arrays bit for bit equal, and its decisions and
    failure records."""
    import numpy as np
    arrays = ("times", "rates", "latencies", "usage_cpu", "usage_mem_mb",
              "workers", "consumer_lag")
    return len(a.scenarios) == len(b.scenarios) and all(
        sa.name == sb.name
        and all(np.array_equal(getattr(sa, f), getattr(sb, f),
                               equal_nan=True) for f in arrays)
        and json.dumps(sa.summary(), sort_keys=True)
        == json.dumps(sb.summary(), sort_keys=True)
        for sa, sb in zip(a.scenarios, b.scenarios))


def mesh_phase(device: str = "cuda") -> dict:
    """Phase 31: the scenario mesh on this machine. ``devices=1`` equals
    the default config bit for bit on ``device``; a mesh wider than the
    visible cards and the sharded engine on one card raise with the port's
    hint; the sharded engine over 4 CPU host partitions equals the batched
    engine at rtol 1e-9; with two cards or more, the fused engine and a
    Demeter grid over 2 cards equal 1 card bit for bit."""
    import os

    import torch
    from repro_torch.core import EngineConfig
    from repro_torch.distributed.mesh import HOST_DEVICES_ENV
    from repro_torch.dsp import SweepEngine, run_sweep

    specs = mesh_grid()
    base = EngineConfig(device=device)
    default = run_sweep(specs, config=base)
    one = run_sweep(specs, config=base.replace(devices=1))
    if not same_scenarios(one, default):
        fail("devices=1 differs from the default config")
    out = {"device": device, "scenarios": len(specs),
           "devices_1_equal": True}

    cards = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda":
        for bad in (dict(devices=cards + 1),
                    dict(sim_backend="sharded") if cards == 1 else None):
            if bad is None:
                continue
            try:
                EngineConfig(device="cuda", **bad)
            except ValueError as e:
                if "torch.cuda.device_count()" not in str(e):
                    fail(f"EngineConfig({bad}) raised without the hint: {e}")
                print(f"mesh: EngineConfig({bad}) raises: {e}", flush=True)
            else:
                fail(f"EngineConfig({bad}) accepted on {cards} card(s)")

    saved = os.environ.get(HOST_DEVICES_ENV)
    os.environ[HOST_DEVICES_ENV] = "4"
    try:
        cpu = EngineConfig(device="cpu")
        batched = run_sweep(specs, config=cpu.replace(sim_backend="batched"))
        eng = SweepEngine(specs, config=cpu.replace(sim_backend="sharded"))
        sharded = eng.run()
    finally:
        if saved is None:
            os.environ.pop(HOST_DEVICES_ENV, None)
        else:
            os.environ[HOST_DEVICES_ENV] = saved
    if eng.executor.n_devices != 4:
        fail(f"the sharded engine spanned {eng.executor.n_devices} host "
             f"partitions, not 4")
    bad = [a.name for a, b in zip(sharded.scenarios, batched.scenarios)
           if not a.allclose(b, rtol=1e-9)]
    if bad:
        fail(f"sharded over 4 host partitions differs from batched: {bad}")
    out["sharded_host_partitions"] = 4

    if device == "cuda" and cards >= 2:
        two = run_sweep(specs, config=base.replace(devices=2))
        if not same_scenarios(two, one):
            fail("the fused engine over 2 cards differs from 1 card")
        gspecs, gconfig = demeter_grid()
        gconfig = gconfig.replace(fit_backend="bank", device="cuda")
        grids = {d: run_sweep(gspecs, config=gconfig.replace(devices=d))
                 for d in (1, 2)}
        if not same_scenarios(grids[2], grids[1]):
            fail("the Demeter grid over 2 cards differs from 1 card")
        out["two_cards"] = "ran: fused and Demeter equal to one card"
    else:
        out["two_cards"] = (f"did not run: this machine shows {cards} CUDA "
                            f"device(s), the leg needs 2")
        print(f"mesh: the 2-card leg did not run: this machine shows "
              f"{cards} CUDA device(s)", flush=True)
    print("mesh " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# the model-parallel mesh
# ---------------------------------------------------------------------------

#: Phase 32 (a): qwen2-7b served at full width inside a sharding context on a
#: (1, 1) mesh and outside it: 4 prompts of 64-256 tokens, 16 decode steps
MESH_SERVE = dict(slots=4, max_len=1024, prompts=(64, 256), decode_steps=16)
#: (b): the sharded trainer at phase 28's width (2 layers, bf16) on the
#: default TrainConfig: 5 steps with a checkpoint after step 4, a failure,
#: the restore onto surviving_mesh and the replay of step 4 (6 step events)
MESH_TRAIN_CKPT, MESH_TRAIN_FAIL = 4, 5
MESH_TRAIN_CKPT_DIR = REPO / "build" / "mesh_ckpt"
#: (b): the sharded losses against the meshless ones, relative; on one rank
#: every shard is the whole tensor and the same kernels run, so bit for
#: bit is expected
MESH_TRAIN_BAR = 1e-5
#: (d): the 2-card legs against one rank: float32 rounding of the sum of
#: two buffers, and of the sharded loss
MESH_TWO_CARD_BAR = 1e-5


def free_port() -> int:
    """A free TCP port on this host, for a process group's rendezvous."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def init_group(device: str, rank: int = 0, world: int = 1,
               port: int = 0) -> None:
    """A process group on this host: NCCL on the cards (rank on card
    ``rank``), gloo on the CPU."""
    import torch
    import torch.distributed as dist
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port or free_port()}", rank=rank,
        world_size=world, **kw)


def mesh_decode(mesh, device: str, arch: str = SERVE_ARCH) -> dict:
    """Phase 32 (a): ``arch`` at full width on the kernel route served
    outside a sharding context and inside one on ``mesh``: the greedy
    tokens and K3's launches must be equal (on one rank the parameters are
    plain tensors, the hooks return their inputs and K3 launches as
    before)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding_context
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    k3 = kernel_module("decode_attention")
    cfg = get_config(arch)
    model = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(32)
    lo, hi = MESH_SERVE["prompts"]
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(lo, hi + 1, MESH_SERVE["slots"])]
    runs = {}
    for label, ctx in (("outside", contextlib.nullcontext()),
                       ("inside", sharding_context(mesh))):
        eng = ServingEngine(cfg, model, n_slots=MESH_SERVE["slots"],
                            max_len=MESH_SERVE["max_len"], device=device)
        k3.decode_attention.launches = 0
        with ctx:
            wall, _ = serve(eng, prompts, MESH_SERVE["decode_steps"] + 1)
        runs[label] = {
            "wall_s": wall, "decode_steps": eng.metrics.decode_steps,
            "launches": k3.decode_attention.launches,
            "tokens": [list(map(int, eng.requests[f"r{i}"].output))
                       for i in range(len(prompts))]}
        del eng
    a, b = runs["outside"], runs["inside"]
    if a["tokens"] != b["tokens"]:
        fail(f"phase 32: decode inside a sharding context parts from the "
             f"decode outside it: {b['tokens']} vs {a['tokens']}")
    want = MESH_SERVE["decode_steps"] * cfg.n_layers
    if device == "cuda" and not a["launches"] == b["launches"] == want:
        fail(f"phase 32: K3 launched {b['launches']} times inside the "
             f"context, {a['launches']} outside, expected {want}")
    del model
    return {"arch": arch, "layers": cfg.n_layers, "requests": len(prompts),
            "decode_steps": b["decode_steps"],
            "launches": {k: runs[k]["launches"] for k in runs},
            "wall_s": {k: runs[k]["wall_s"] for k in runs},
            "tokens_equal": True}


def one_rank_collectives(device: str) -> dict:
    """Phase 32 (c): ``ring_allreduce`` over each axis of a (1, 1) mesh and
    ``hierarchical_allreduce`` over a (pod=1, data=1) mesh return their
    input bit for bit."""
    import torch
    from repro_torch.distributed import hierarchical_allreduce, ring_allreduce
    from repro_torch.launch.mesh import make_mesh
    g = torch.Generator(device=device).manual_seed(32)
    x = torch.randn(1000, 3, generator=g, device=device)
    dm = make_mesh((1, 1), ("data", "model"), device=device)
    pd = make_mesh((1, 1), ("pod", "data"), device=device)
    outs = {f"ring over {a}": ring_allreduce(x, dm, a)
            for a in ("data", "model")}
    outs["hierarchical"] = hierarchical_allreduce(x, pd)
    bad = [k for k, y in outs.items() if not same_bits(y, x)]
    if bad:
        fail(f"phase 32: {bad} on one rank differ from their input")
    return {"checked": sorted(outs), "bit_equal": True}


def sharded_trainer(device: str, arch: str = TRAIN_ARCH,
                    layers: int = TRAIN_LAYERS, seq: int = TRAIN_SEQ) -> dict:
    """Phase 32 (b): ``ElasticTrainer`` on a (pod=1, data=1, model=1) mesh
    against the meshless trainer on the default ``TrainConfig``: the
    meshless one runs MESH_TRAIN_FAIL steps; the sharded one the same
    steps with a checkpoint after MESH_TRAIN_CKPT, then a failure, the
    restore onto ``surviving_mesh`` (the reference's single-pod
    (data, model) mesh: the pod axis lost) and the replay. Every loss within MESH_TRAIN_BAR of the meshless
    run's; the median step times of both (the DTensor dispatch's cost on
    one rank) and the first sharded step (DTensor's sharding
    propagation)."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import surviving_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import (DataConfig, ElasticTrainer, FTConfig,
                                      TrainConfig)
    cfg = get_config(arch).scaled(n_layers=layers,
                                  attention_impl="reference")
    dc = DataConfig(batch_per_host=TRAIN_BATCH, seq_len=seq)
    shutil.rmtree(MESH_TRAIN_CKPT_DIR, ignore_errors=True)
    ft = FTConfig(checkpoint_dir=str(MESH_TRAIN_CKPT_DIR),
                  checkpoint_interval_steps=MESH_TRAIN_CKPT)
    plain = ElasticTrainer(cfg, TrainConfig(), dc,
                           FTConfig(checkpoint_dir=str(MESH_TRAIN_CKPT_DIR),
                                    checkpoint_interval_steps=10 ** 9),
                           device=device)
    plain.run(MESH_TRAIN_FAIL)
    base = [(e.step, e.loss, e.duration_s) for e in plain.events]
    del plain
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # the reference's multi-pod axes: the weights sharded on "data" and
    # "model" by the rules, the heads on "model" in the attention's
    # regions, the batch on "pod" and "data"
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device=device)
    tr = ElasticTrainer(cfg, TrainConfig(), dc, ft, mesh=mesh, device=device)
    tr.run(MESH_TRAIN_FAIL)
    tr.inject_failure()
    t0 = time.perf_counter()
    tr._recover(new_mesh=surviving_mesh(mesh))
    restore_s = time.perf_counter() - t0
    tr.run(1)
    events = [(e.step, e.loss, e.duration_s) for e in tr.events]
    shutil.rmtree(MESH_TRAIN_CKPT_DIR, ignore_errors=True)
    steps = [s for s, _, _ in events]
    want = list(range(MESH_TRAIN_FAIL)) + [MESH_TRAIN_CKPT]
    if steps != want or tr.mesh.mesh_dim_names != ("data", "model"):
        fail(f"phase 32: sharded trainer events {steps} on "
             f"{tr.mesh.mesh_dim_names} after the restore, expected {want} "
             f"on (data, model)")
    first = {s: loss for s, loss, _ in base}
    rel = [abs(loss - first[s]) / abs(first[s]) for s, loss, _ in events]
    if not all(math.isfinite(loss) for _, loss, _ in events) \
            or max(rel) > MESH_TRAIN_BAR:
        fail(f"phase 32: sharded losses {events} against the meshless "
             f"{base}: {max(rel)} > {MESH_TRAIN_BAR}")
    del tr
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"arch": arch, "layers": layers, "dtype": cfg.dtype,
            "batch": TRAIN_BATCH, "seq": seq, "steps": steps,
            "losses": [loss for _, loss, _ in events],
            "meshless_losses": [loss for _, loss, _ in base],
            "max_rel_diff": max(rel),
            "bit_equal": all(loss == first[s] for s, loss, _ in events),
            "first_step_s": events[0][2],
            "replay_step_s": events[-1][2],
            "step_s_median": statistics.median(
                d for _, _, d in events[1:MESH_TRAIN_FAIL]),
            "meshless_step_s_median": statistics.median(
                d for _, _, d in base[1:]),
            "restore_s": restore_s, "bar": MESH_TRAIN_BAR}


def two_card_worker(rank: int, world: int, port: int, device: str,
                    out: str) -> None:
    """Phase 32 (d), one rank: the ring against ``dist.all_reduce`` over
    the ``model`` axis of a (data=1, model=2) mesh, and deepseek-7b's smoke
    ``train_loss`` (float32, TF32 off) on it, its heads split over the two
    ranks, against this rank's unsharded one; writes the differences to
    ``<out>.<rank>.json``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import (rescale, ring_allreduce,
                                         set_parameters, sharding_context)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, train_loss
    from repro_torch.training import DataConfig, make_pipeline
    from repro_torch.training.train import parameters
    init_group(device, rank, world, port)
    try:
        dev = torch.device(device, rank) if device == "cuda" else "cpu"
        g = torch.Generator(device=dev).manual_seed(rank)
        x = torch.randn(4099, generator=g, device=dev)
        mesh = make_mesh((1, world), ("data", "model"), device=device)
        ring = ring_allreduce(x, mesh, "model")
        want = x.clone()
        dist.all_reduce(want)
        with NoTF32():
            cfg = smoke_config(TRAIN_ARCH).scaled(
                attention_impl="reference", dtype="float32")
            model = init_params(cfg, seed=0, device=device)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     make_pipeline(cfg, DataConfig(batch_per_host=4,
                                                   seq_len=32))
                     .batch(0).items()}
            plain = float(train_loss(model, batch)[0])
            set_parameters(model, rescale(parameters(model), mesh))
            with sharding_context(mesh):
                sharded = float(train_loss(model, batch)[0].full_tensor())
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump({"ring_err_of_scale": largest_rel(ring, want),
                       "loss_plain": plain, "loss_sharded": sharded}, f)
    finally:
        dist.destroy_process_group()


def two_card_leg(device: str, world: int = 2) -> dict:
    """Phase 32 (d): :func:`two_card_worker` on ``world`` processes, one a
    card (or gloo processes on the CPU); each rank's ring within
    MESH_TWO_CARD_BAR of ``dist.all_reduce`` and its sharded loss of its
    unsharded one."""
    import torch.multiprocessing as mp
    out = str(REPO / "build" / "two_card")
    (REPO / "build").mkdir(exist_ok=True)
    mp.spawn(two_card_worker, args=(world, free_port(), device, out),
             nprocs=world, join=True)
    res = []
    for r in range(world):
        with open(f"{out}.{r}.json") as f:
            res.append(json.load(f))
    for r, x in enumerate(res):
        rel = abs(x["loss_sharded"] - x["loss_plain"]) / abs(x["loss_plain"])
        if x["ring_err_of_scale"] > MESH_TWO_CARD_BAR \
                or rel > MESH_TWO_CARD_BAR:
            fail(f"phase 32: rank {r} of {world}: {x}")
    return {"ranks": world, "results": res}


def model_parallel_phase(device: str = "cuda", decode_arch: str = SERVE_ARCH,
                         train_seq: int = TRAIN_SEQ) -> dict:
    """Phase 32: the model-parallel mesh on this machine. A one-rank
    process group (NCCL on the card) and (a) the serving decode inside a
    sharding context on a (1, 1) mesh equal to the decode outside it,
    tokens and K3 launches; (c) the explicit collectives on one rank
    return their input; (b) the sharded elastic trainer against the
    meshless one, restored onto ``surviving_mesh``; (d) with two cards or
    more, 2 NCCL ranks: the ring against ``all_reduce`` and the sharded
    ``train_loss`` against one rank's, else a line saying that this leg did
    not run. The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    print(f"model-parallel mesh: PyTorch {torch.__version__}", flush=True)
    init_group(device)
    try:
        out = {"device": device, "torch": torch.__version__}
        t0 = time.perf_counter()
        out["decode"] = mesh_decode(make_mesh((1, 1), ("data", "model"),
                                              device=device), device,
                                    decode_arch)
        out["decode_s"] = time.perf_counter() - t0
        out["collectives"] = one_rank_collectives(device)
        t0 = time.perf_counter()
        out["trainer"] = sharded_trainer(device, seq=train_seq)
        out["trainer_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if cards >= 2:
        out["two_cards"] = two_card_leg(device)
    else:
        out["two_cards"] = (f"did not run: this machine shows {cards} CUDA "
                            f"device(s), the leg needs 2")
        print(f"model-parallel mesh: the 2-card leg did not run: this "
              f"machine shows {cards} CUDA device(s)", flush=True)
    print("model-parallel mesh " + json.dumps(out), flush=True)
    return out


#: Phase 33: the dry-run's train cell of one smoke config of every family
#: (both MoE configs: with and without latent attention), in two
#: subprocesses run together, and their time limit
DRYRUN_ARCHS = (("deepseek_7b", "deepseek_moe_16b", "hubert_xlarge",
                 "pixtral_12b"),
                ("deepseek_v2_lite_16b", "mamba2_1p3b", "zamba2_2p7b"))
DRYRUN_TIMEOUT_S = 300


def dryrun_phase() -> list:
    """Phase 33: the dry-run's CLI (``python -m repro_torch.launch.dryrun
    --smoke --shape train_4k --mesh single``) over the archs of
    DRYRUN_ARCHS on this machine's PyTorch: a fake 256-rank group on the
    CPU in subprocesses (the cards hidden; the dry-run refuses to start
    beside another process group). Every record is printed and must be
    ``ok``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    outs = [REPO / "build" / f"dryrun_smoke.{i}.json"
            for i in range(len(DRYRUN_ARCHS))]
    (REPO / "build").mkdir(exist_ok=True)
    for out in outs:
        out.unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--shape", "train_4k", "--mesh", "single", "--out", str(out),
         "--arch", *archs], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for out, archs in zip(outs, DRYRUN_ARCHS)]
    recs, errs = [], []
    try:
        for proc, out in zip(procs, outs):
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            errs.append(err[-2000:])
            if out.exists():
                recs += list(json.loads(out.read_text()).values())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rec in recs:
        print("dry-run " + json.dumps({k: rec.get(k) for k in (
            "arch", "shape", "mesh", "status", "devices", "trace_s", "flops",
            "collective_total", "error", "trace")}), flush=True)
    got = {rec.get("arch"): rec.get("status") for rec in recs}
    want = [a for archs in DRYRUN_ARCHS for a in archs]
    if any(got.get(a) != "ok" for a in want):
        fail(f"phase 33: dry-run train_4k cells {got}, expected every one "
             f"of {want} ok; stderr tails: {errs}")
    return recs


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

#: phase 34: each example at the reference's default arguments (dsp_repro
#: at 3 h, dsp_sweep with --verify); train_elastic's failure at step 160,
#: not its default 150, which falls on a checkpoint and replays no step
EXAMPLE_ARGS = {"quickstart": [], "dsp_repro": ["--hours", "3"],
                "dsp_sweep": ["--verify"],
                "serve_autoscale": ["--arch", SERVE_ARCH],
                "train_elastic": ["--fail-at", "160"]}
#: where phase 34 writes each run's printed lines (build/ is ignored)
EXAMPLE_LOGS = REPO / "build" / "examples"
#: the wall-clock figures of the examples' lines, left out card vs CPU
EXAMPLE_WALLS = (r"[\d.]+ s wall", r"speedup [\d.]+x")


def load_example(name: str):
    """``examples/<name>_torch.py`` as a fresh module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", REPO / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, device: str) -> dict:
    """``main([*EXAMPLE_ARGS[name], "--device", device])`` of the example
    ``name`` in this process, its standard output captured (and written
    under ``EXAMPLE_LOGS``): its result, lines, wall and every kernel's
    launches over the call."""
    import io
    import torch
    mod = load_example(name)
    buf = io.StringIO()
    reset_kernel_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main([*EXAMPLE_ARGS[name], "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    EXAMPLE_LOGS.mkdir(parents=True, exist_ok=True)
    (EXAMPLE_LOGS / f"{name}_{device}.log").write_text(buf.getvalue())
    return {"out": out, "lines": lines, "wall_s": wall,
            "launches": kernel_launches()}


def same_lines(a: list, b: list) -> bool:
    """The lines equal but for their wall-clock figures."""
    import re

    def strip(lines):
        out = []
        for line in lines:
            for pat in EXAMPLE_WALLS:
                line = re.sub(pat, "<wall>", line)
            out.append(line)
        return out
    return strip(a) == strip(b)


def first_line_difference(a: list, b: list) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"line {i}: {x!r} vs {y!r}"
    return f"{len(a)} vs {len(b)} lines"


def launched(counts: dict, expect: tuple, name: str,
             device: str = "cuda") -> dict:
    """The nonzero launch counts; on the card, fails unless each kernel of
    ``expect`` was launched and no other was."""
    got = {k: v for k, v in counts.items() if v}
    if device != "cuda":
        return got
    missing = [k for k in expect if not got.get(k)]
    extra = sorted(set(got) - set(expect))
    if missing or extra:
        fail(f"example {name}: kernels {missing} not launched, {extra} "
             f"launched unexpectedly: {counts}")
    return got


def example_quickstart(devices=("cuda", "cpu")) -> dict:
    """quickstart (90 minutes) on the card: K1 once per ARIMA chunk of its
    forecast bank and ``gp_lbfgs`` once per GP bank fit; then on the CPU:
    the same lines (profiling, reconfigurations, final state)."""
    from repro_torch.core import gp_bank
    fits, margins = count_fit_calls(gp_bank), pick_margins()
    try:
        card = run_example("quickstart", devices[0])
    finally:
        fits.restore()
        margins.restore()
    got = launched(card["launches"], ("arima_chunk", "gp_lbfgs"),
                   "quickstart", devices[0])
    chunks = card["out"].tsf.bank.arima_chunks
    if devices[0] == "cuda" and (got["arima_chunk"] != chunks
                                 or got["gp_lbfgs"] != fits.n):
        fail(f"example quickstart: {got} for {chunks} ARIMA chunks and "
             f"{fits.n} GP bank fits")
    cpu = run_example("quickstart", devices[1])
    if card["lines"] != cpu["lines"]:
        fail(f"example quickstart, card vs CPU: "
             f"{first_line_difference(card['lines'], cpu['lines'])}")
    return {"wall_s": card["wall_s"], "launches": got,
            "reconfigurations": card["out"].n_reconfigurations,
            "agreement": "lines equal card vs CPU",
            "pick_margins": margins.summary(),
            "cpu_wall_s": cpu["wall_s"]}


def example_dsp_repro(devices=("cuda", "cpu")) -> dict:
    """dsp_repro --hours 3 on the card (K1 and ``gp_lbfgs`` in its Demeter
    cell), then on the CPU: equal lines and reconfigurations and failure
    records, the arrays at rtol 1e-9 and the profiling cost at 2e-9 (the
    forecast bank's float64 RLS on raw rates, ROADMAP.md §3)."""
    import numpy as np
    margins = pick_margins()
    try:
        card = run_example("dsp_repro", devices[0])
    finally:
        margins.restore()
    got = launched(card["launches"], ("arima_chunk", "gp_lbfgs"),
                   "dsp_repro", devices[0])
    cpu = run_example("dsp_repro", devices[1])
    worst = 0.0
    for method, a in card["out"].items():
        b = cpu["out"][method]
        for f in ("times", "rates", "latencies", "usage_cpu",
                  "usage_mem_mb", "workers"):
            if not np.allclose(getattr(a, f), getattr(b, f), rtol=1e-9,
                               atol=0.0):
                fail(f"example dsp_repro {method}: {f} differs card vs CPU")
        recs = [[(r.t_inject, r.workload, r.recovery_s, r.capped)
                 for r in x.failures] for x in (a, b)]
        if a.n_reconfigurations != b.n_reconfigurations or recs[0] != recs[1]:
            fail(f"example dsp_repro {method}: reconfigurations "
                 f"{a.n_reconfigurations} vs {b.n_reconfigurations}, "
                 f"failures {recs[0]} vs {recs[1]}")
        for f in ("profile_cpu_s", "profile_mem_mb_s"):
            x, y = getattr(a, f), getattr(b, f)
            rel = abs(x - y) / abs(y) if y else abs(x)
            worst = max(worst, rel)
            if rel > 2e-9:
                fail(f"example dsp_repro {method}: {f} {x} vs {y}")
    if card["lines"] != cpu["lines"]:
        fail(f"example dsp_repro, card vs CPU: "
             f"{first_line_difference(card['lines'], cpu['lines'])}")
    return {"wall_s": card["wall_s"], "launches": got,
            "agreement": f"lines equal; arrays at rtol 1e-9; profiling cost "
                         f"within {worst:.3g} relative (bar 2e-9)",
            "pick_margins": margins.summary(),
            "cpu_wall_s": cpu["wall_s"]}


def example_dsp_sweep(devices=("cuda", "cpu")) -> dict:
    """dsp_sweep --verify (1 h, 18 scenarios) on the fused engine of the
    card: K2 once per ``step_interval`` call, "equivalence OK" against the
    scalar engine; then on the CPU: the same lines but the walls."""
    from repro_torch.dsp import FusedSweepExecutor
    timers = LayerTimers()
    timers.wrap(FusedSweepExecutor, "step_interval", "intervals")
    try:
        card = run_example("dsp_sweep", devices[0])
    finally:
        timers.restore()
    got = launched(card["launches"], ("fused_interval",), "dsp_sweep",
                   devices[0])
    intervals = timers.calls.get("intervals", 0)
    if devices[0] == "cuda" and got["fused_interval"] != intervals:
        fail(f"example dsp_sweep: {got['fused_interval']} fused_interval "
             f"launches for {intervals} step_interval calls")
    if not card["lines"][-1].endswith("equivalence OK"):
        fail(f"example dsp_sweep: {card['lines'][-1]!r}")
    cpu = run_example("dsp_sweep", devices[1])
    if not same_lines(card["lines"], cpu["lines"]):
        fail(f"example dsp_sweep, card vs CPU: "
             f"{first_line_difference(card['lines'], cpu['lines'])}")
    return {"wall_s": card["wall_s"], "launches": got,
            "step_interval_calls": intervals,
            "scenarios": len(card["out"].scenarios),
            "agreement": "equivalence OK (scalar engine); lines equal card "
                         "vs CPU but the walls",
            "cpu_wall_s": cpu["wall_s"]}


def example_serve_autoscale(devices=("cuda", "cpu")) -> dict:
    """serve_autoscale --arch qwen2_7b (4 simulated hours) on the card:
    K3 in phase 1's engine and ``calibrate``'s steps, K1 and ``gp_lbfgs``
    in phase 2's controller. Card against CPU: phase 1 alone, on one
    float32 draw of the smoke config (2 layers) with TF32 off, as phases 9,
    12 and 14 hold serving: the same tokens for every request (phase 2
    runs on measured step times, so no two runs share its decisions)."""
    import copy
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    card = run_example("serve_autoscale", devices[0])
    got = launched(card["launches"], ("decode_attention", "arima_chunk",
                                      "gp_lbfgs"), "serve_autoscale",
                   devices[0])
    eng, demeter = card["out"]
    mod = load_example("serve_autoscale")
    cfg = smoke_config(SERVE_ARCH).scaled(dtype="float32")
    model = init_params(cfg, seed=0, device="cpu")
    mod.init_params = lambda cfg, seed, device: copy.deepcopy(model).to(
        device)
    ids = [f"req-{i}" for i in range(12)]
    tokens = {}
    with NoTF32(), contextlib.redirect_stdout(sys.stderr):
        for dev in devices:
            e = mod.phase1_real_engine(cfg, dev)
            tokens[dev] = [e.requests[i].output for i in ids]
    a, b = (tokens[d] for d in devices)
    if a != b or not all(len(t) == 8 for t in a):
        fail(f"example serve_autoscale phase 1, card vs CPU: tokens {a} "
             f"vs {b}")
    return {"wall_s": card["wall_s"], "launches": got,
            "completed": eng.metrics.completed,
            "decode_steps": eng.metrics.decode_steps,
            "reconfigurations": demeter.n_reconfigurations,
            "agreement": "phase 1 tokens equal card vs CPU (float32, 2 "
                         "layers); phase 2 not compared"}


def example_train_elastic(devices=("cuda", "cpu")) -> dict:
    """train_elastic (300 steps of 8 x 128, the failure at step 160) on the
    card: no kernel launched (the plain attention route), finite losses,
    and the steps replayed after the restore from step 150 equal the first
    pass's losses bit for bit."""
    card = run_example("train_elastic", devices[0])
    launched(card["launches"], (), "train_elastic", devices[0])
    events = card["out"].events
    first = {}
    replayed = []
    for e in events:
        if e.step in first:
            replayed.append((e.step, e.loss, first[e.step]))
        else:
            first[e.step] = e.loss
    if len(events) != 300 or not all(math.isfinite(e.loss)
                                     for e in events):
        fail(f"example train_elastic: {len(events)} events")
    if [s for s, _, _ in replayed] != list(range(150, 160)) or any(
            a != b for _, a, b in replayed):
        fail(f"example train_elastic: replay {replayed}")
    return {"wall_s": card["wall_s"], "launches": {},
            "events": len(events), "replayed_steps": len(replayed),
            "loss": [events[0].loss, events[-1].loss],
            "agreement": "replayed losses equal the first pass bit for bit"}


def examples_phase(devices=("cuda", "cpu")) -> dict:
    """Phase 34: every example's ``main`` in this process on the card
    (``devices[0]``), with its checks; returns each one's summary.
    Rehearse on the CPU with ``examples_phase(("cpu", "cpu"))``."""
    out = {}
    for name, fn in (("quickstart", example_quickstart),
                     ("dsp_repro", example_dsp_repro),
                     ("dsp_sweep", example_dsp_sweep),
                     ("serve_autoscale", example_serve_autoscale),
                     ("train_elastic", example_train_elastic)):
        t0 = time.perf_counter()
        out[name] = fn(devices)
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"example {name} " + json.dumps(out[name]), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch ({e}); run it from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.moe import block_m

    # The port's host-side work (scalar GP fits, posteriors on the host, the
    # CPU legs of the comparisons) is thousands of tiny tensor operations,
    # which run fastest on one thread: the 96 scalar fits of phase 5 took
    # 183.7 s on the default 8 threads of an NVIDIA H100 80GB HBM3,
    # 700.00 W machine's host and 28.2 s on one.
    torch.set_num_threads(1)
    t_start = time.perf_counter()
    # -- 1. environment ------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    print(f"card: {name}  capability {cap}  nvidia-smi: {smi}", flush=True)
    if cap != (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all(["fused_tick", "rls_update", "decode_attention",
                            "ssd_scan", "flash_attention", "grouped_matmul",
                            "rmsnorm", "gp_fit"])
    for lib_name in libs:
        build.load(lib_name)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for lib_name, lib in sorted(libs.items()):
        log = lib.with_suffix(".log")
        if log.exists():
            PTXAS.update(ptxas_table(log.read_text()))
            print(f"ptxas {lib_name}: " + " | ".join(
                ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln or "stack" in ln),
                flush=True)

    # -- 3. kernels against their plain versions -----------------------------
    # the Demeter main path's widths: K2 steps every scenario, K1 every
    # ARIMA stream of the forecast bank
    specs = demeter_specs(DEMETER_SEEDS)
    main_tick_rows = len(specs)
    main_rls_rows = sum(1 for s in specs if s.forecaster == "arima")
    tick_rows, rls_rows = {}, {}
    for n in sorted({main_tick_rows, *KERNEL_ROWS}):
        tick_rows[n] = r = check_fused_tick(n)
        print("kernel fused_tick " + json.dumps(r), flush=True)
    for B in sorted({main_rls_rows, *RLS_ROWS}):
        for k in RLS_ORDERS:
            for dtype in (torch.float64, torch.float32):
                r = check_rls(B, k, dtype)
                rls_rows[(B, k, r["dtype"])] = r
                print("kernel rls_update " + json.dumps(r), flush=True)
    # K2 and K1 as the paths run them: a decision interval a launch, and a
    # flush of the forecast bank a launch
    interval_rows, chunk_rows = {}, {}
    for S, K in sorted({(main_tick_rows, MAIN_INTERVAL), *INTERVAL_SHAPES}):
        interval_rows[(S, K)] = r = check_fused_interval(S, K)
        print("kernel fused_interval " + json.dumps(r), flush=True)
    for k in RLS_ORDERS:
        for B in sorted({main_rls_rows, *CHUNK_STREAMS}):
            for T in CHUNK_TICKS:
                chunk_rows[(B, k, T)] = r = check_arima_chunk(B, k, T)
                print("kernel arima_chunk " + json.dumps(r), flush=True)
    # K1 as the detector bank runs it: a chunk of one tick a sample at
    # p = 4, d = 1, in a profiling clone (2 streams) and the fleet's slab
    det_rows = {}
    for B, T in DETECTOR_CHUNKS:
        det_rows[B] = r = check_arima_chunk(B, DETECTOR_K, T, "detector")
        print("kernel arima_chunk detector " + json.dumps(r), flush=True)
    # ... and as the fleet soak (phase 27) flushes its forecast bank
    fleet_chunk = check_arima_chunk(*FLEET_CHUNK, "fleet forecaster")
    print("kernel arima_chunk fleet " + json.dumps(fleet_chunk), flush=True)
    # K3 at the serving path's shapes (qwen2-7b: Hkv = 4, G = 7, D = 128;
    # 16 slots of 4096), then over groups and head dims
    serve_cfg = get_config(SERVE_ARCH)
    serve_shape = (SERVE_SLOTS, SERVE_MAX_LEN, serve_cfg.n_kv_heads,
                   serve_cfg.n_heads // serve_cfg.n_kv_heads,
                   serve_cfg.resolved_head_dim)
    attn_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = check_decode_attention(*serve_shape, dtype, timed=True)
        attn_rows[r["dtype"]] = r
        print("kernel decode_attention " + json.dumps(r), flush=True)
    # one row of 32 768 positions (a CTA per row and head would take it
    # alone) and deepseek-moe-16b's decode (G = 1, Hkv = 16)
    moe_cfg = get_config(MOE_ARCH)
    for shape in ((1, PREFILL_32K) + serve_shape[2:],
                  (SERVE_SLOTS, SERVE_MAX_LEN, moe_cfg.n_kv_heads,
                   moe_cfg.n_heads // moe_cfg.n_kv_heads,
                   moe_cfg.resolved_head_dim)):
        r = check_decode_attention(*shape, torch.bfloat16, timed=True)
        print("kernel decode_attention " + json.dumps(r), flush=True)
    for G in ATTN_SWEEP_GROUPS:
        for D in ATTN_SWEEP_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                r = check_decode_attention(SERVE_SLOTS, SERVE_MAX_LEN, 4, G,
                                           D, dtype, timed=False)
                print("kernel decode_attention " + json.dumps(r), flush=True)
    # K5 at the serving paths' prefill shapes (mamba2-1.3b: H = 64, P = 64,
    # N = 128; zamba2-2.7b: H = 80, N = 64; a 2048-token prompt, chunk
    # 256), at the reference tests' shapes in float32, and under strong
    # decay (A up to 16, dt up to 1)
    ssd_rows = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        c = get_config(arch)
        heads = c.ssm.expand * c.d_model // c.ssm.head_dim
        for dtype in (torch.bfloat16, torch.float32):
            r = check_ssd_scan(1, SERVE_PROMPTS[1], heads, c.ssm.head_dim,
                               c.ssm.n_groups, c.ssm.d_state, c.ssm.chunk,
                               dtype, a_log_max=math.log(16), timed=True)
            ssd_rows[(arch, r["dtype"])] = r
            print("kernel ssd_scan " + json.dumps(r), flush=True)
    # a one-chunk prompt (256 tokens: the third pass splits each chunk's
    # rows over CTAs) at both architectures
    for arch in (SSM_ARCH, HYBRID_ARCH):
        c = get_config(arch)
        heads = c.ssm.expand * c.d_model // c.ssm.head_dim
        r = check_ssd_scan(1, c.ssm.chunk, heads, c.ssm.head_dim,
                           c.ssm.n_groups, c.ssm.d_state, c.ssm.chunk,
                           torch.bfloat16, a_log_max=math.log(16))
        print("kernel ssd_scan one chunk " + json.dumps(r), flush=True)
    for shape in SSD_TEST_SHAPES:
        r = check_ssd_scan(*shape, torch.float32)
        print("kernel ssd_scan " + json.dumps(r), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        r = check_ssd_scan(1, SERVE_PROMPTS[1], 64, 64, 1, 128, 256, dtype,
                           a_log_max=math.log(16), dt_max=1.0)
        print("kernel ssd_scan strong decay " + json.dumps(r), flush=True)
    # K4 at the encoder path's shape (hubert-xlarge) and the vlm path's
    # (pixtral-12b), one layer of the reference's prefill_32k encoder cell
    # at batch 1 (the plain version by blocks of query rows: its whole
    # float32 score matrix would take 69 GB), then the reference tests'
    # shapes in float32, gemma's head dim and a ragged length
    enc, vlm = get_config(ENCODER_ARCH), get_config(VLM_ARCH)
    flash_rows = {}
    for key, (B, S, c, causal) in (("encoder", (ENCODE_CLIPS, ENCODE_FRAMES,
                                                enc, False)),
                                   ("vlm", (VLM_BATCH, VLM_SEQ, vlm, True))):
        r = check_flash_attention(B, S, c.n_heads, c.n_kv_heads,
                                  c.resolved_head_dim, torch.bfloat16,
                                  causal, timed=True)
        flash_rows[key] = r
        print("kernel flash_attention " + json.dumps(r), flush=True)
    r = check_flash_attention(1, PREFILL_32K, enc.n_heads, enc.n_kv_heads,
                              enc.resolved_head_dim, torch.bfloat16, False,
                              plain_rows=2048, n=5)
    print("kernel flash_attention prefill_32k " + json.dumps(r), flush=True)
    for shape in FLASH_TEST_SHAPES:
        for causal in (True, False):
            r = check_flash_attention(*shape, torch.float32, causal)
            print("kernel flash_attention " + json.dumps(r), flush=True)
    for *shape, causal in FLASH_EXTRA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            r = check_flash_attention(*shape, dtype, causal)
            print("kernel flash_attention " + json.dumps(r), flush=True)
    # K6 at deepseek-moe-16b's shapes: a decode step's 16 tokens at the
    # path's blk_m (timed beside the plain version, torch._grouped_mm and
    # the einsums) and at blk_m 128 (its time only), and a 2048-token
    # prompt, top-6 over 64 experts, timed at both blk_m of the wgmma body
    # (128, the path's, and 64); gate/up 2048 -> 1408, down 1408 -> 2048;
    # then the reference tests' shapes in float32
    e = moe_cfg.moe
    gmm_rows = {}
    for key, n_tok in (("decode", SERVE_SLOTS), ("prefill", SERVE_PROMPTS[1])):
        blk = block_m(n_tok * e.top_k, e.n_routed)
        for K, N in ((moe_cfg.d_model, e.d_expert),
                     (e.d_expert, moe_cfg.d_model)):
            r = check_grouped_matmul(n_tok, e.top_k, e.n_routed, K, N, blk,
                                     torch.bfloat16, timed=True)
            gmm_rows[(key, K)] = r
            print(f"kernel grouped_matmul {key} " + json.dumps(r), flush=True)
            other = 64 if blk == 128 else 128
            r = check_grouped_matmul(n_tok, e.top_k, e.n_routed, K, N, other,
                                     torch.bfloat16, timed=key == "prefill")
            print(f"kernel grouped_matmul {key} blk_m {other} "
                  + json.dumps(r), flush=True)
    r = check_grouped_matmul(SERVE_SLOTS, e.top_k, e.n_routed,
                             moe_cfg.d_model, e.d_expert, 16, torch.float32)
    print("kernel grouped_matmul decode " + json.dumps(r), flush=True)
    for n_tok, n_exp, K, N in GMM_TEST_SHAPES:
        r = check_grouped_matmul(n_tok, 1, n_exp, K, N, 128, torch.float32)
        print("kernel grouped_matmul " + json.dumps(r), flush=True)
    # K7 at the reference tests' shapes, and 16 x 4096 rows of 2048 (timed)
    rms_rows = {}
    for shape in RMSNORM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            r = check_fused_rmsnorm(shape, dtype)
            print("kernel fused_rmsnorm " + json.dumps(r), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        rms_rows[str(dtype).split(".")[-1]] = r = check_fused_rmsnorm(
            RMSNORM_MAIN, dtype, timed=True)
        print("kernel fused_rmsnorm " + json.dumps(r), flush=True)
    # the GP bank's fit on the tiled body (GP_FIT_SHAPES), and above
    # SHARED_N points (the general body, in the global scratch)
    gp_rows = {}
    for label, n_sets, seed, sizes in GP_FIT_SHAPES:
        gp_rows[label] = r = {"shape": label, **check_gp_fit(n_sets, seed,
                                                             sizes)}
        print("kernel gp_lbfgs " + json.dumps(r), flush=True)
    gp_fit = gp_rows[GP_FIT_SHAPES[0][0]]
    gp_fit_large = check_gp_fit(*GP_FIT_LARGE, timed=False)
    print("kernel gp_lbfgs " + json.dumps(gp_fit_large), flush=True)
    print(f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. the baseline path ------------------------------------------------
    baseline_path()
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # -- 5. components on the card -------------------------------------------
    fb = check_forecast_bank("cuda")
    print("component forecast_bank " + json.dumps(fb), flush=True)
    gb = check_gp_bank("cuda")
    print("component gp_bank " + json.dumps(gb), flush=True)
    picks = check_selection("cuda")
    print(f"component selection: same batches {picks}", flush=True)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # -- 6. the Demeter main path --------------------------------------------
    main_path = demeter_main_path(DEMETER_SEEDS)
    print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. the Demeter path, card against CPU -------------------------------
    grid = demeter_card_vs_cpu()
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # -- 8. the serving main path -------------------------------------------
    serve_path = serving_main_path()
    gc.collect()                # the engine and its model, for phase 9's room
    torch.cuda.empty_cache()
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # -- 9. serving, card against CPU ----------------------------------------
    serving_card_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # -- 10. autoscaled serving ---------------------------------------------
    autoscale = autoscaled_serving()
    print(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # -- 11. the SSM serving main path (mamba2-1.3b) ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    ssm_path = serving_main_path(arch=SSM_ARCH, n_requests=SSM_REQUESTS,
                                 new_tokens=SSM_NEW_TOKENS)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")

    # -- 12. mamba2, card against CPU ---------------------------------------
    serving_card_vs_cpu(arch=SSM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")

    # -- 13. the hybrid serving path (zamba2-2.7b) --------------------------
    hybrid_path = serving_main_path(arch=HYBRID_ARCH,
                                    n_requests=HYBRID_REQUESTS,
                                    new_tokens=HYBRID_NEW_TOKENS)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")

    # -- 14. zamba2 (one super-layer), card against CPU ---------------------
    serving_card_vs_cpu(arch=HYBRID_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")

    # -- 15. the encoder path (hubert-xlarge encode) ------------------------
    encoder_path = encoder_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15 done at {time.perf_counter() - t_start:.1f} s")

    # -- 16. hubert, card against CPU ---------------------------------------
    encoder_card_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16 done at {time.perf_counter() - t_start:.1f} s")

    # -- 17. the vlm path (pixtral-12b train_loss) --------------------------
    vlm_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17 done at {time.perf_counter() - t_start:.1f} s")

    # -- 18. pixtral, card against CPU --------------------------------------
    vlm_card_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 18 done at {time.perf_counter() - t_start:.1f} s")

    # -- 19. the MoE serving path (deepseek-moe-16b) ------------------------
    moe_path = serving_main_path(arch=MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 19 done at {time.perf_counter() - t_start:.1f} s")

    # -- 20. deepseek-moe, card against CPU ---------------------------------
    serving_card_vs_cpu(arch=MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20 done at {time.perf_counter() - t_start:.1f} s")

    # -- 21. the MLA serving path (deepseek-v2-lite-16b) --------------------
    mla_path = serving_main_path(arch=MLA_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 21 done at {time.perf_counter() - t_start:.1f} s")

    # -- 22. deepseek-v2-lite, card against CPU -----------------------------
    serving_card_vs_cpu(arch=MLA_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 22 done at {time.perf_counter() - t_start:.1f} s")

    # -- 23. the detector bank: the fleet's slab of 1 024 streams -----------
    detector = detector_bank_path()
    print(f"phase 23 done at {time.perf_counter() - t_start:.1f} s")

    # -- 24. the paper's per-cell protocol (run_experiment, 18 h) -----------
    protocol = paper_protocol()
    print(f"phase 24 done at {time.perf_counter() - t_start:.1f} s")

    # -- 25. the protocol and the grid's backends, card against CPU ---------
    paper_protocol_card_vs_cpu(grid["results"])
    print(f"phase 25 done at {time.perf_counter() - t_start:.1f} s")

    # -- 26. obs on the sweep stack ------------------------------------------
    t_phase = time.perf_counter()
    obs_phase()
    print(f"phase 26 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 27. the fleet service: 1 000 jobs, K1 in every epoch ---------------
    t_phase = time.perf_counter()
    fleet = fleet_phase(autoscale["decode_step_s"], autoscale["prefill_s"])
    print(f"phase 27 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 28. the training path: deepseek-7b at full width, 2 layers ---------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    train = training_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 28 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 29. training, card against CPU --------------------------------------
    t_phase = time.perf_counter()
    training_card_vs_cpu()
    print(f"phase 29 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 30. contracts on the card -------------------------------------------
    # (the probes launch the per-tick kernels; the kernels line takes every
    # count from the main-path phases above, never the global counters)
    t_phase = time.perf_counter()
    contracts_phase()
    print(f"phase 30 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 31. the scenario mesh on this machine --------------------------------
    t_phase = time.perf_counter()
    mesh_phase()
    print(f"phase 31 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 32. the model-parallel mesh -----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    model_parallel_phase()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 32 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 33. the dry-run on this machine's PyTorch ----------------------------
    t_phase = time.perf_counter()
    dryrun_phase()
    print(f"phase 33 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 34. the examples ----------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    examples = examples_phase()
    print(f"phase 34 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t_phase:.1f} s)")

    # -- summary lines: each kernel's launches on its main path and its
    # times at that path's shapes
    tick = tick_rows[main_tick_rows]
    rls = rls_rows[(main_rls_rows, MAIN_K, "float64")]
    interval = interval_rows[(main_tick_rows, MAIN_INTERVAL)]
    chunk = chunk_rows[(main_rls_rows, MAIN_K, MAIN_CHUNK)]
    attn = attn_rows["bfloat16"]
    ssd = ssd_rows[(SSM_ARCH, "bfloat16")]
    flash = flash_rows["encoder"]
    print(f"Demeter path launches {main_path['launches']}; serving path "
          f"launches {serve_path['launches']}; {SSM_ARCH} launches "
          f"{ssm_path['launches']}; {HYBRID_ARCH} launches "
          f"{hybrid_path['launches']}; {ENCODER_ARCH} launches "
          f"{encoder_path['launches']}; {MOE_ARCH} launches "
          f"{moe_path['launches']}; {MLA_ARCH} launches "
          f"{mla_path['launches']}; fused_rmsnorm (K7) has no model path")
    gmm = gmm_rows[("decode", moe_cfg.d_model)]
    rms = rms_rows["bfloat16"]
    kernels = [{
        "name": "fused_interval", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_tick.cu",
        "replaces": "src/repro/kernels/fused_tick.py:72",
        "launches": main_path["launches"]["fused_interval"],
        "max_abs_err": max(r["max_abs_err"] for r in interval_rows.values()),
        "ms": interval["ms"], "plain_ms": interval["plain_ms"],
        "bound_ms": interval["bound_ms"], "bound_by": interval["bound_by"],
        "library_ms": None,
    }, {
        "name": "arima_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/rls_update.cu",
        "replaces": "src/repro/kernels/rls_update.py:41",
        "launches": main_path["launches"]["arima_chunk"],
        "max_abs_err": max(r["max_abs_err"] for r in
                           (*chunk_rows.values(), *det_rows.values(),
                            fleet_chunk)),
        "ms": chunk["ms"], "plain_ms": chunk["plain_ms"],
        "bound_ms": chunk["bound_ms"], "bound_by": chunk["bound_by"],
        "library_ms": None,
        # K1 on the other paths: the detector bank (phase 23, one launch a
        # sample, timed at its shape) and run_experiment's Demeter cells
        "paths": {"detector bank": {
            "launches": detector["arima_chunk_launches"],
            "streams": DETECTOR_STREAMS, **{
                key: det_rows[DETECTOR_STREAMS][key]
                for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "max_abs_err")}},
            "run_experiment demeter": {
                "launches": protocol["arima_chunk_launches"]},
            # the soak's flushes, timed at their shape (its detector
            # samples run at the detector bank's shape above)
            "fleet soak": {
                "launches": fleet["arima_chunk_launches"], **SOAK_MAIN,
                "forecast_flushes": fleet["forecast_flushes"],
                "detector_samples": fleet["detector_samples"],
                "streams": FLEET_CHUNK[0], "k": FLEET_CHUNK[1],
                "ticks": FLEET_CHUNK[2], **{
                    key: fleet_chunk[key]
                    for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "max_abs_err")}}},
    }, {
        "name": "fused_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_tick.cu",
        "replaces": "src/repro/kernels/fused_tick.py:72",
        "launches": main_path["launches"]["fused_tick"],
        "max_abs_err": max(r["max_abs_err"] for r in tick_rows.values()),
        "ms": tick["ms"], "plain_ms": tick["plain_ms"],
        "bound_ms": tick["bound_ms"], "bound_by": tick["bound_by"],
        "library_ms": None,
    }, {
        "name": "rls_update", "route": "cuda",
        "source": "src/repro_torch/csrc/rls_update.cu",
        "replaces": "src/repro/kernels/rls_update.py:41",
        "launches": main_path["launches"]["rls_update"],
        "max_abs_err": max(r["max_abs_err"] for r in rls_rows.values()
                           if r["dtype"] == "float64"),
        "ms": rls["ms"], "plain_ms": rls["plain_ms"],
        "bound_ms": rls["bound_ms"], "bound_by": rls["bound_by"],
        "library_ms": None,
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:71",
        "launches": serve_path["launches"]["decode_attention"],
        "design": attn["design"],
        "max_abs_err": attn["max_abs_err"],
        "ms": attn["ms"], "plain_ms": attn["plain_ms"],
        "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
        "library_ms": attn["library_ms"],
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:74",
        "launches": ssm_path["launches"]["ssd_scan"],
        "design": ssd["design"],
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": encoder_path["launches"]["flash_attention"],
        "design": flash["design"],
        "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
    }, {
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:44",
        "launches": moe_path["launches"]["grouped_matmul"],
        "design": gmm["design"],
        "max_abs_err": max(r["max_abs_err"] for r in gmm_rows.values()),
        "ms": gmm["ms"], "plain_ms": gmm["plain_ms"],
        "bound_ms": gmm["bound_ms"], "bound_by": gmm["bound_by"],
        "library_ms": gmm["library_ms"],
    }, {
        "name": "gp_lbfgs", "route": "cuda",
        "source": "src/repro_torch/csrc/gp_fit.cu",
        # not a TPU kernel: the reference's fit is plain JAX (optax.lbfgs in
        # a lax.while_loop), which this one launch replaces
        "replaces": "src/repro/core/gp_bank.py:112",
        "launches": main_path["launches"]["gp_lbfgs"],
        "design": gp_fit["design"],
        "max_abs_err": max(r["max_abs_err"] for r in
                           (*gp_rows.values(), gp_fit_large)),
        "ms": gp_fit["ms"], "plain_ms": gp_fit["plain_ms"],
        "bound_ms": gp_fit["bound_ms"], "bound_by": gp_fit["bound_by"],
        "library_ms": None,
        # each of phase 3's tiled rows (the first gives the times above)
        "shapes": {label: {k: r[k] for k in (
            "members", "n_max", "design", "ms", "us_per_eval", "plain_ms",
            "bound_ms", "bound_by")} for label, r in gp_rows.items()},
        # the fits by (rows, padded size) on each path that fits GPs
        "paths": {
            "demeter": {"launches": main_path["launches"]["gp_lbfgs"],
                        "by_rows_x_n_max":
                            main_path["gp_fits_by_rows_x_n_max"]},
            "run_experiment": {
                "launches": protocol["gp_lbfgs_launches"],
                "by_rows_x_n_max": protocol["gp_fits_by_rows_x_n_max"]},
            "fleet profiling soak": {
                "launches": fleet["profiling_soak"]["gp_lbfgs_launches"],
                "by_rows_x_n_max":
                    fleet["profiling_soak"]["gp_fits_by_rows_x_n_max"]}},
    }, {
        "name": "fused_rmsnorm", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:32",
        "launches": moe_path["launches"]["fused_rmsnorm"],
        "max_abs_err": rms["max_abs_err"],
        "ms": rms["ms"], "plain_ms": rms["plain_ms"],
        "bound_ms": rms["bound_ms"], "bound_by": rms["bound_by"],
        "library_ms": rms["library_ms"],
    }]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err") + (
                ("library_ms",) if k["library_ms"] is not None else ()):
            if not math.isfinite(k[key]):
                fail(f"{k['name']}: {key} is not finite")
        if k["name"] in NO_MODEL_PATH + PER_TICK_KERNELS:
            if k["launches"] != 0:
                fail(f"{k['name']} launched {k['launches']} times on a "
                     f"path that calls it nowhere")
        elif not k["launches"] > 0:
            fail(f"{k['name']} was not launched on the main path")
        for label, path in k.get("paths", {}).items():
            n = path["launches"]
            if not (min(n.values()) if isinstance(n, dict) else n) > 0:
                fail(f"{k['name']} was not launched on the {label} path")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"examples": examples}))
    print(nvidia_smi_line())
    # the training path runs none of them (phase 28 fails otherwise)
    print(json.dumps({"kernels": kernels, "training": {
        "launches_one_step": train["launches_first_step"],
        "launches_phase": train["launches"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
