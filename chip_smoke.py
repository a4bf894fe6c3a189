#!/usr/bin/env python3
"""On-card smoke run of raft_tpu_torch, the PyTorch and CUDA port.

    python3 chip_smoke.py            # every phase, on one CUDA card

Phases, each of which fails loudly (nothing is caught):

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
   TF32 is turned off for cuDNN convs and matmuls, so fp32 means fp32;
2. build the kernels from ``raft_tpu_torch/csrc`` (seconds, ``-Xptxas
   -v``'s registers, shared memory and spills, each kernel's dynamic shared
   memory, and the tensor-core instructions in K5's SASS by ``cuobjdump``);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (the Sintel demo geometry padded to 440x1024: the 1/8 grid is
   55x128, N = 7040, levels 55x128, 27x64, 13x32, 6x16); the four GRU
   kernels also on operands as the update block hands them (the z and r
   halves of a channels-last double-width gate conv output, ``drh`` a
   channel slice of a channels-last concatenation's gradient) and on the
   same views of NCHW tensors, at that grid at batch 1 and 4 and at the
   training grid at batch 10, fp32 and bf16: each output dense in its
   operands' layout, each launch counted by ``kernels.launch_layouts()``
   under that layout;
4. time each kernel, its plain version and, for the lookup, the reference's
   formulation (one ``F.grid_sample`` per level): device time from
   ``torch.profiler`` with the L2 flushed before each call (and warm, for
   the kernel; for the GRU tails the median and range of five sessions),
   and a wrapper call's time with CUDA events (host
   included), beside its bound: the larger of its bytes at 3.35 TB/s and
   its operations at 67 TFLOP/s (the H100 SXM's HBM rate and fp32
   non-tensor-core peak); K1's in-range window rows also counted in whole
   32-byte sectors; each GRU kernel (K2's gates and blend, K4's backward
   of each) also on the operands phase 3 holds in both layouts, at the
   serving grid (batch 1 and 4) and the training one (batch 10);
5. drive the main path through ``cli/demo.flow_pairs`` on 4 pairs of
   seeded synthetic 436x1024 frames at iters=20: the basic model at full
   width with seeded random weights (``corr_impl="pallas",
   gru_impl="fused"``, every launch counted) against the plain
   configuration (``corr_impl="gather", gru_impl="xla"``; every GRU
   launch on the ``channels_last`` route), held after one
   step to a bound and after 20 steps to the gap the plain path opens
   against itself on frames moved by one ulp; and the small model with
   its trained fixture, kernel lookup against plain lookup; one
   basic-model pair is profiled for the device's busy and idle time;
6. hold all six kernels (the lookup and its scatter, the gates and blend
   and their backward) against their plain versions at the training
   geometry (the chairs recipe's 368x496 crops at batch 10: the 1/8 grid
   is 46x62, B·N = 28,520 queries, levels 46x62, 23x31, 11x15, 5x7; the
   GRU's z/r halves strided views of a double-width conv output), two
   scatter calls bitwise equal, and time all six there as in phase 4,
   with the scatter's library yardstick, the backward of one
   ``F.grid_sample`` per level, and K1's sector bytes;
7. train through ``training.trainer.train`` on the chairs recipe (basic
   model at full width, batch 10, 368x496, iters 12, lr 4e-4, fp32, batch
   norms trained, ``pallas``+``fused``) for 6 steps on seeded synthetic
   batches whose ground truth is their known shift: ms per step, pairs per
   second, peak memory, launches per step of each kernel (every GRU
   launch on the ``channels_last`` route), the idle share of one profiled
   step and its top device ops; the ``.pth`` it writes
   loads back with ``strict=True``;
8. from the same weights and batch, one step's loss and gradients with the
   kernels against the plain configuration, the gradients held to the gap
   the plain path opens against itself on frames moved by one ulp: the
   basic model at iters=1, and the trained small fixture at iters=12
   (kernel lookup against plain lookup); then the basic model at iters=12
   to 10x that gap, a witness that random weights make unable to fail;
9. hold K5, the on-the-fly lookup of ``alternate_corr``, against its plain
   version at the two KITTI geometries: ``validate_kitti``'s (phase 10's
   path: a 375x1242 frame padded to 376x1248 and bucketed to 384x1280, so
   the 1/8 grid is 48x160, N = 7,680, fmap2 levels 48x160, 24x80, 12x40,
   6x20) and the unbucketed submission writer's (grid 47x156, N = 7,332);
   C=256 r=4 and C=128 r=3; on two coordinate fields (``FIELDS``: the
   smooth flow a trained model gives, with one motion boundary, and i.i.d.
   noise, the field the earlier K5 was timed on), each with a tenth of the
   queries 150 px out, which must give exact zeros; at validate_kitti's
   geometry also with fmaps three times unit variance (twice the model's); K5's branch counter read after each call (the smooth
   field must tile at least SMOOTH_TILED_MIN of its tiles); two calls
   bitwise equal; against the materialized
   path on the same fmaps (the all-pairs volume, its pooling and K1, K1
   itself against its plain version there); its gradients against plain
   autograd, and the GRU kernels (K2) at the path's (1,128,48,160); time
   K5 at the validator's geometry on both fields as in phase 4, beside its
   bound restated for tensor cores (bytes at 3.35 TB/s or the three TF32
   products of the error-compensated split at 495 TFLOP/s) with the fp32
   figure, and the materialized path's build and K1;
10. evaluate through ``cli/evaluate.main --dataset kitti --alternate_corr
   --corr_impl pallas --gru_impl fused``: the basic model at full width
   with seeded random weights saved as a ``.pth``, over a KITTI-layout
   dataset written under a temporary directory (4 seeded synthetic
   375x1242 pairs shifted by a known flow, 16-bit flow PNGs with a valid
   mask): ms per pair, peak memory, launches (24 K5 a pair, no K1), K5's
   branch shares; then
   the materialized path; the two held to each other after one step, and
   with the small trained fixture at iters=24;
11. the Sintel submission with warm start over ``demo-frames/`` in a
   ``test/{clean,final}/<scene>/`` layout, read with the port's PNG codec:
   the small fixture with K5 (its branch shares: a trained model's flow on
   real frames) against the materialized path with K1, the
   written ``.flo`` files read back and compared: cold pairs within 5e-4
   px; each warm pair run again by each path from the other's init, each
   within 5e-4 px of the other path from that init; the chained gap
   (each pair starts from the last one's flow, so the gap feeds forward)
   held to the materialized path's own response to the two inits plus
   5e-4 px;
12. train from the command line, ``cli/train.main --stage chairs
   --mixed_schedule --mixed_precision --synthetic 40 --num_steps 6
   --val_freq 3 --validation kitti --num_workers 4 --corr_impl pallas
   --gru_impl fused`` (the basic model at full width on the
   ``train_mixed.sh`` chairs recipe: batch 8, 368x496, iters 12, lr
   2.5e-4; 40 seeded 384x512 chairs-shaped pairs written with the port's
   PPM and ``.flo`` writers, augmented and batched by the port's loader;
   phase 10's KITTI split as the validation data): every kernel's launches
   and the dtype each ran in (K2 and K4 in bf16 on every iteration), the
   loader's share of the loop, peak memory, the KITTI metrics in the log,
   the final ``.pth`` loading with ``strict=True``; the full state saved,
   restored bitwise, then ``--resume --num_steps 8`` continuing the step
   count and the learning rate; ms per step and pairs per second at batch
   8 in bf16 and in fp32 (in turns), one profiled step of each (idle share,
   top device ops, the FFT convolutions' time); one bf16 step's loss and
   gradients, kernels against the plain configuration, held to the gap
   one bf16 ulp of input opens in the plain bf16 path; and ``remat=True``
   against ``remat=False`` at iters 12, gradients within the same kind of
   gap, with peak memory and time;
13. memory at 1080x1920: the basic model at iters=20, alternate path
   against materialized, peak ``max_memory_allocated`` and ms per pair
   (``profile_hd_pair.py`` profiles such a pair); K1 against its plain
   version at that size (N^2 = 1.05e9 indices) and K5 against K1, both
   timed (the median of 5 profiler sessions, with their spread);
14. the demo CLI (``cli/demo.main``) over ``demo-frames/`` with the small
   fixture, its PNGs read back;
15. the supervised drill: ``python -m raft_tpu_torch.cli.train --supervise
   --hang_s 15 --num_workers 1`` (the basic model at full width, batch 2,
   368x496, iters 12, fp32, ``pallas``+``fused``, 6 steps on 2 seeded
   synthetic chairs samples, a full-state save every 2 steps) under a
   fault plan that zero-fills the second save (step 3) and hangs the
   fourth step of attempt 0: the watchdog's exit 3, the supervisor's
   restart, the restore sandbox's exit 4 on step 3 and its quarantine, the
   resume from step 1 and the run's end are required, with the recovered
   run's launches of K1-K4 (from its ``metrics.jsonl``); its final weights
   against an uninterrupted control run's, both with cuDNN deterministic
   and TF32 off (set in the children by a ``sitecustomize``), bitwise or
   within the gap between two control runs; restarts, the time from the
   wedge to the restored state, the steps redone and the time lost;
16. each measuring CLI once, in this process, the launch counts set to 0
   before each and read after: ``cli/envelope`` (matmul peaks in bf16,
   fp32 and TF32, the copy bandwidth over 2 GiB, the launch time),
   ``cli/infer_bench`` at 440x1024 materialized and alternate,
   ``cli/corr_bench --grad`` over ``gather``, ``pallas`` (K1/K3), ``alt``,
   ``alt_pallas`` (K5) and the ``F.grid_sample`` yardstick, each within
   CORR_BENCH_TOL of the first route of its kind, ``cli/profile_step
   --trace-dir`` (bf16, batch 8) and ``cli/trace_summary`` on its trace
   (the port's kernels must show), ``cli/loader_bench`` against the
   profiled step's pairs/s; then each kernel's bound at the measured
   envelope, and the GRU tails' share of it at the inference geometry;
17. the serving engine (``serving.engine.RAFTEngine``): engine A, the
   basic model at full width with seeded random weights, ``pallas`` +
   ``fused``, iters 20, u8 wire, warm start, buckets (1, 440, 1024) and (4,
   440, 1024) and the ragged class (4, 440, 1024), each captured as a CUDA
   graph (seconds each, peak memory); phase 5's pairs served singly and
   four at a time, each replay against the eager ``RAFT.forward`` of the
   same padded bucket inputs (within SERVE_TOL); ms a pair by host clock
   and by CUDA events, replay against eager; one profiled dispatch's busy
   and idle share and its K1/K2 launches by kernel name (20 K1, 40 gates,
   40 blends a replay); one ragged replay of four request shapes against
   the eager ``forward_ragged``, no new capture; the hot swap (one thread
   dispatching, one swapping two seeded weight sets: every output bitwise
   one set's, no new capture); engine B, the small fixture with the
   feature cache over ``demo-frames/``, each warm pair within 5e-4 px of
   the plain twin engine's with the same ``flow_init``, its H2D bytes and
   encoder saving; ``export_program`` of the small fixture loaded in a
   fresh process (batch 1 and 2 against eager, K1 in its profile); and
   ``cli/parity`` over ``demo-frames/`` (within 5e-4 px);
18. the serving front end (``serving.scheduler`` over the engine,
   ``serving.session``, the feature-cache pool, breakers and watchdog,
   tracing) through ``cli/serve_bench.run_drill``: the basic model at full
   width with seeded random weights (``pallas`` + ``fused``, iters 20, u8
   wire, warm start, TF32 convolutions as phase 17's engine A), buckets of
   4 at 440x1024 and 368x496, 48 requests from 2 submitters and 2 video
   sessions of 8 pairs, at ``pipeline_depth`` 1 and 2 on the same seeded
   traffic: pairs/s, p50/p99, occupancy, dispatch gap, overlap, H2D bytes
   a request, captures, each run's replayed K1/K2 launches (20, 40, 40 a
   dispatch) and the idle share of a profiled 16-request window (run 1
   traced, its spans read back with ``cli/serve_trace``; one profiled
   dispatch's launches by kernel name); the small fixture through the
   scheduler on mixed crops of ``demo-frames/`` (each future within 5e-4
   px of the engine's direct ``infer_batch``, nothing stranded, the
   accounting identity), the same traffic through one ragged class against
   the buckets, feature-cache sessions over ``demo-frames/`` (each warm
   pair within 5e-4 px of the plain twin fed the same ``flow_init``, one
   u8 frame of H2D a pair, against plain warm-start sessions), device-state
   sessions (``flow_low`` a CUDA tensor throughout, the device warp
   bitwise across two runs), and one ``--chaos 2`` drill (raise and hang
   at ``serve.request``, ``serve.dispatch_exec``, ``engine.compile``: no
   invariant broken, the clean round healthy with the documented graphs);
19. multi-model serving and the replica fleet (``serving.registry``,
   ``serving.guardian``, the scheduler's fleet), every engine built with
   TF32 convolutions as phase 18's: (a) ``cli/serve_bench.
   run_registry_drill`` with two models on the card, the basic model at
   full width (seeded weights, iters 20, u8 wire, warm start) and the
   small fixture, buckets of 4 at 440x1024 and 368x496, 48 requests from 2
   submitters at priority mix 1:1 under an admission budget, a same-arch
   basic canary (a second seed) at 0.25 promoted after traffic: per model
   and priority pairs/s, p50/p99 and ``admission_rejected``; each future
   within SERVE_TOL of its own variant's direct ``infer_batch`` (the
   variant read from its span), the promote capturing nothing, nothing
   stranded, the accounting identity; (b) the SLO guardian as
   ``tests/test_guardian.py``'s acceptance drills: a canary whose
   dispatches fault at ``serve.request`` rolled back inside its bake
   window on ``err_rate`` with live outputs bitwise unchanged, and a
   clean canary auto-promoted as a weight swap; (c) the replica fleet:
   one replica spawned (seconds, captures, memory added), phase 18's
   traffic at ``replicas`` 1 (``pipeline_depth`` 1 and 2) and 2 (depth 1;
   the fleet takes no completion stage), three runs of each, interleaved:
   every run's pairs/s and occupancy, the median run's latency, each
   lane's dispatches and peak memory, a profiled window's idle share;
   the fleet-atomic swap under traffic, clean and then with
   ``scheduler.swap`` armed at the second lane: every output bitwise one
   weight set's, every lane on the old set after the failed one; (d)
   ``run_registry_chaos`` for 2 rounds with the guardian (plans over
   ``registry.load``, ``guardian.decide``, ``serve.request``,
   ``serve.dispatch_exec``, ``engine.compile``): no invariant broken,
   the clean round promoted by the guardian;
20. the program store, the transport and the host fleet
   (``serving.aot``, ``serving.transport``, ``serving.hosts``,
   ``serving.host_worker``, the scheduler's host lanes), every engine built
   under a fresh process's defaults (TF32 convolutions): (a) the basic
   model at full width (seeded weights, ``pallas`` + ``fused``, iters 20,
   u8 wire, warm start) with buckets (4, 440, 1024) and (4, 368, 496) over
   an empty store (misses, exports, stored bytes), an engine without a
   store (the live module's graphs) and one warm from the store (hits
   equal to programs, no trace): each replay within SERVE_TOL of the live
   module's, bitwise or not, a loaded program's K1/K2 launches in one
   replay by the profiler (20, 40, 40), one entry corrupted on disk (the
   ``aot.load`` site) read as a miss and traced again, and the join time
   of a fresh ``host_worker`` process from an empty store (cold) and from
   a pushed one (warm), split into start and CUDA init, push, load or
   export, warm-up and capture, with the warm worker's replay against
   this process's through the socket and the wire's share of a remote
   call; (b) ``cli/serve_bench.run_drill`` with 2 loopback host lanes on
   phase 18's one-shot traffic, each future within SERVE_TOL of the
   primary's forward of its own micro-batch (from the dispatch span),
   pairs/s, occupancy, a profiled window's idle share; (c) the socket kill
   drill: two ``host_worker`` processes on the card (bucket (1, 440,
   1024), ``max_batch=1``), push and prewarm, h0 SIGKILLed after 6 of 16
   requests, every future settled once within SERVE_TOL of the primary's
   forward of the pair, then a rejoin on a fresh port for 6 more; the
   times from the kill to the dead verdict, the failover and the last
   future; (d) ``run_chaos_drill`` with ``hosts=2`` and a store, 2 rounds
   (plans over the serving sites, ``transport.send``, ``transport.recv``,
   ``host.heartbeat``, and an ``aot.load`` corruption): no invariant
   broken;
21. the JAX trainer's weights and data-parallel training
   (``tools.msgpack``, ``tools.convert``, ``parallel``), TF32 off, cuDNN
   deterministic: (a) the small fixture's ``.msgpack`` through
   ``load_weights``, its flow on 4 demo pairs at iters 20 bitwise the
   ``.pth``'s, again after ``save_converted`` wrote and ``load_weights``
   read it, with each format's load time; (b) 6 bf16 basic-model steps at
   batch 8, 368x496 (``pallas`` + ``fused``) through ``train``, mesh-less
   and then after ``initialize`` over NCCL at world size 1 and
   ``make_mesh``: the final weights bitwise; (c) two processes on cuda:0
   joined by gloo (NCCL refuses two ranks on one device) run one
   basic-model chairs step at global batch 4, 368x496, at iters 1 and 12,
   no noise, rank 1's rows 30% valid: both ranks' weights bitwise equal,
   and against one rank's step on the whole batch the gradients within
   phase 8's one-ulp rule (a gradient under 1e-4 of the largest within
   that), the loss within STEP_LOSS_TOL (within its one-ulp gap if larger:
   random weights amplify rounding over 12 iterations), the grad norm
   within the gradient rule's bound, epe, batch-norm statistics and new
   parameters within the gap one ulp of input opens (or 1e-5, 2 lr); each
   rank's launches at iters 12, the step's ms and the gradient
   all-reduce's ms (a subprocess each, DP_TIMEOUT_S each, both killed when
   one fails);
22. the ``spatial`` mesh axis (``parallel.halo``, ``RAFTEngine(mesh=)``,
   the train step over bands), TF32 off, cuDNN deterministic, two
   processes on cuda:0 joined by gloo on a ``(1, 2)`` mesh (a subprocess
   each, SP_TIMEOUT_S each, both killed when one fails): (a) one seeded
   1080x1920 pair (bucket 1x1088x1920, 68 feature rows a band) through the
   sharded engine, the basic model (``pallas`` + ``fused``) at iters 1
   within BASIC_STEP_TOL of the one-device engine on the same card (its
   bucket the same, so the same zero rows fill it) and
   the small trained fixture at iters 20 within SMALL_TOL, both ranks'
   results bitwise equal, each rank's pyramid exactly half the one-device
   one's, each rank's peak memory beside the one-device engine's, the
   basic pair's ms a rank and the share of it its all-reduces take (each
   timed alone: the halos, the norms' sums, the fmap2 and output
   gathers), no capture; (b) the chairs step on phase 21 (c)'s rows
   (368x496, 23 feature rows a band): the basic model on its weights at
   iters 1 and the small trained fixture at iters 12, each held to one
   rank's step on the whole batch by phase 21's rules, with each side's
   rounding witnessed by its own steps on image1, then image2, moved by
   one ulp (the bounds the largest witness a side, summed over the
   sides); (c) each rank's launches in the counted runs;
23. follower ranks (``parallel.follow``): the scheduler's ``"shard"``
   route and a replica lane over the ``(1, 2)`` mesh, TF32 off, cuDNN
   deterministic, two processes on cuda:0 joined by gloo (a subprocess
   each, FW_TIMEOUT_S each, both killed when one fails). Rank 0 runs
   ``MicroBatchScheduler`` over the leading primary engine (wire u8,
   buckets 1x1088x1920 and 4x368x496) with one replica lane on a sibling
   mesh and ``shard_px_threshold`` 1080x1920 (the key is the request's
   extent); rank 1 runs ``follow.follow``. (a) The basic model at iters 1:
   2 seeded 1080x1920 pairs on the ``"shard"`` route and 8 368x496 pairs
   on the ``"replicate"`` route, a weight swap, the same again on the
   second weights; (b) the small trained fixture at iters 20: the 4
   1080x1920 pairs on the ``"shard"`` route. Each future within
   BASIC_STEP_TOL (basic) or SMALL_TOL (small) of a one-device engine on
   the same card on its own micro-batch, bucket and weights; rank 1's
   flows bitwise rank 0's futures; pairs/s and p50/p99 ms per route; the
   channel's bytes and ms a dispatch and their share of a sharded pair;
   each rank's launches (K1, K2), counted from zero before each session;
   (c) the kill drill: rank 1 SIGKILLed with futures in flight: every
   future settled exactly once, with an error, and the seconds from the
   SIGKILL to the last; the scheduler closes;
24. JPEG frames, the flow video and the native flow codec, TF32 off:
   (a) the 10 ``demo-frames/`` PNGs written by ``data.jpeg.write_jpeg`` at
   its default (quality 90, 4:2:0) and at quality 95 4:4:4, read back by
   ``data.frame_utils.read_gen``: each setting's worst PSNR against its PNG
   (at least VIDEO_PSNR_MIN, what cv2's MJPG writer, the JAX package's
   video path, gives frame_0016) and ms a frame to encode and to decode
   (host clock); (b) ``cli/parity.main --small --path <the default-quality
   JPEGs> --video``: the small fixture, plain forward against the engine
   within SMALL_TOL, the AVI read back by ``testing.avi.read_mjpg_avi`` and
   ``read_jpeg``: 9 frames of 872x1024 at 30 fps, each within
   VIDEO_PSNR_MIN of ``flow_to_image`` of the engine's flow under its
   frame, the launches (the plain path, the capture's warm-up and capture,
   and the replays); (c) ``cli/demo.main`` over the same frames, the basic
   model with seeded weights saved as a ``.pth``, iters 20, cuDNN
   deterministic: its PNGs bitwise ``flow_to_image`` of ``flow_pairs`` on
   the decoded frames, 180 K1, 360 gates and 360 blends; (d) the native
   ``.flo``/``.pfm`` codec (``raft_tpu_torch.native``, g++ at first use):
   built, a seeded 436x1024 ``.flo`` written and read by native and numpy
   bitwise both ways, a 540x960x3 ``.pfm`` read by both bitwise, each one's
   ms, and phase 16's ``loader_bench`` (on the native reader) beside the
   18.39 pairs/s it gave on the numpy reader (``PERF.md`` §5);
25. GMA (``kernels.gma``, ``csrc/gma.cu``), TF32 off but where said:
   (a) K6 and K7 at the GMA cell's 135x240 grid (1080x1920 frames),
   batch 1 and 2, on q and k as halves of one channels-last tensor: each
   against float64 on 256 sampled rows within twice its plain version's
   own error there (cuBLAS in float32) or 1e-5 of the largest value, the
   largest gap to the plain version on the whole output, and device times
   of the kernel and the plain version beside the bound at TF32's 495
   TFLOP/s (and at fp32's 67); K7 must beat its plain version at both
   batches; (b) ``RAFTEngine`` on a GMA bucket (2, 1080, 1920), iters 20,
   TF32 convolutions as the cell runs them, cuDNN deterministic (so that
   the replay and the eager forward take the same algorithms; the eager
   forward runs first, the two together outgrow the card): the capture's
   launches, one replay
   with the counts set to 0 just before it (1 K6 and 20 K7 replayed, by
   the engine's count and by the device trace's kernel names; no wrapper
   call), its busy time and K6+K7's share, the peak memory, the flow
   against the eager forward within 1e-3 px on the mean;
26. print the drill's, the envelope's, the serving phases', phase 21's,
   phase 22's, phase 23's, phase 24's and phase 25's numbers
   (``{"gma": ...}``, ``{"serving_frontend": ...}``, ``{"serving_registry": ...}``,
   ``{"serving_store_hosts": ...}``, ``{"parallel": ...}``,
   ``{"spatial": ...}``, ``{"follow": ...}`` and ``{"video": ...}``
   lines), the ``{"kernels": [...]}`` line (with ``launches_serving``,
   ``launches_serving_frontend``, ``launches_registry``,
   ``launches_fleet``, ``launches_store_hosts`` and ``launches_video`` on
   K1 and K2, ``launches_parallel`` and ``launches_spatial`` on K1-K4,
   ``launches_follow`` a rank on every kernel), the ``nvidia-smi`` line,
   and last the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import functools
import glob
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # H100 SXM TF32 on the tensor cores, dense
SECTOR = 32                     # bytes the DRAM moves per access, at least
GRID = (55, 128)                # 1/8 grid of the 440x1024 padded Sintel frame
FRAME_HW = (436, 1024)
PAIRS = 4
ITERS = 20
LOOKUP_TOL = 1e-5               # fp32 lerp of identical window values
GRU_TOL = 1e-6                  # expf/tanhf vs PyTorch's, ~1 ulp
BASIC_STEP_TOL = 2e-3           # px, basic model, one refinement step
SMALL_TOL = 5e-4                # px, the ROADMAP's end-to-end bound
TRAIN_HW = (368, 496)           # chairs crops (train_standard.sh stage 1)
TRAIN_B = 10
TRAIN_GRID = (46, 62)
TRAIN_ITERS = 12
TRAIN_STEPS = 6
TRAIN_FLOW = (-3.0, -2.0)       # synthetic_frames' shift, frame to frame
SCATTER_TOL = 1e-5              # fp32: the same taps summed in another order
# One train step, kernels vs plain, raw gradients (no clip), cuDNN
# deterministic: the loss within 1e-5 relative (a mean of fp32 terms that
# differ by fp32 rounding); the gradients within what one ulp of input does
# to the plain path in the same run (phase 8 measures it): for each
# parameter, its gradient gap relative to its largest gradient, and the
# median of those over the parameters. The kernels change only the order
# of fp32 sums, a perturbation of the same size as one ulp of input.
STEP_LOSS_TOL = 1e-5
KITTI_HW = (375, 1242)          # KITTI-15 frames
# 1/8 grid of the 376x1248 padded frame, unbucketed (the submission
# writer's); validate_kitti's bucketed grid comes from kitti_eval_grid()
KITTI_GRID = (47, 156)
KITTI_PAIRS = 4
KITTI_ITERS = 24                # ITERS_EVAL["kitti"]
KITTI_FLOW = (-3.0, -2.0)       # synthetic_frames' shift
# K5 against its plain version: the same fp32 products summed over C in
# another order (and interpolate-then-dot against dot-then-interpolate)
ALT_ATOL = ALT_RTOL = 1e-5
ALT_MAT_TOL = 1e-4              # K5 vs the materialized path, of max |out|
# K5's coordinate fields (phase 9): "iid" is grid + 12 px i.i.d. noise per
# query (neighbouring windows unrelated: the worst case for a tiled kernel);
# "smooth" is grid + KITTI_FLOW + a low-frequency flow of up to +-8 px (a
# wavelength of the grid width) + one vertical motion boundary where the
# flow jumps by SMOOTH_JUMP px; both with a tenth of the queries 150 px out
FIELDS = ("smooth", "iid")
SMOOTH_AMP = 8.0
SMOOTH_JUMP = 20.0
SMOOTH_TILED_MIN = 0.9          # share of K5 tiles the smooth field must tile
HD_HW = (1080, 1920)            # the memory regime alternate_corr is for
HD_ITERS = 20
CLI_PAIRS = 40                  # phase 12's synthetic chairs samples
CLI_STEPS = 6
CLI_RESUME_STEPS = 8
CLI_VAL_FREQ = 3
MIXED_B = 8                     # train_mixed.sh's chairs batch
CORR_BENCH_TOL = 1e-4           # corr_bench --grad: each route vs its kind's
                                # first, gradients as a share of the largest


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, ending in the seconds since the start."""
    print(f"{msg} (+{time.perf_counter() - _T0:.1f} s)", flush=True)


def device_events(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_busy_ms(prof) -> float:
    """Milliseconds in which at least one kernel or copy ran on the card:
    the union of the device events' intervals (``cli.profile_step.busy_ms``;
    a sum of their times counts twice what overlaps, as cuDNN's kernels on
    its own streams do)."""
    from raft_tpu_torch.cli.profile_step import busy_ms

    busy = busy_ms([e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA])
    if not busy > 0:
        raise RuntimeError("torch.profiler recorded no device intervals")
    return busy


def kernel_ms(fn, reps: int = 50, flush=None):
    """Device milliseconds per call of ``fn``: the device time of everything
    it ran on the card, from ``torch.profiler``, over ``reps`` calls after a
    warm-up, divided by the calls the profiler recorded. With ``flush`` (a
    device-to-device copy larger than the 50 MB L2), each call finds the L2
    cold; the copies' own time is left out.

    A session can lose device events: two or three of a session of any
    length (a one-call session of K5 recorded none, one of the materialized
    build 2 of its 5 kernels, ten of it 48 of 50), once all of them, once
    all but one of 20 calls. So each session starts and ends on eight small
    device-to-device copies, left out like the flushes, and the calls
    recorded are counted by the costliest kernel: its events over how many
    one call runs (its events per call, rounded). A session that recorded
    fewer than three quarters of its calls, or more than 5% over the calls
    it made, is taken again, up to four times; raises if none was whole
    enough."""
    from torch.profiler import ProfilerActivity, profile

    pad_src = torch.empty(2 ** 20, device="cuda")
    pad_dst = torch.empty_like(pad_src)

    def pad():
        for _ in range(8):
            pad_dst.copy_(pad_src)
        torch.cuda.synchronize()

    fn()  # warm-up: one-time set-up launches stay out of the count below
    torch.cuda.synchronize()
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad()
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            pad()
        evs = {e.key: (e.self_device_time_total, e.count)
               for e in device_events(prof)
               if not e.key.startswith("Memcpy DtoD")}
        us = sum(t for t, _ in evs.values())
        key, (_, n) = max(evs.items(), key=lambda kv: kv[1][0],
                          default=(None, (0.0, 0)))
        per_call = round(n / reps)
        calls = n / per_call if per_call else 0.0
        if us > 0 and 0.75 * reps <= calls <= 1.05 * reps:
            return us / calls / 1e3
        log(f"    torch.profiler recorded {calls:.2f} of {reps} calls "
            f"({sum(c for _, c in evs.values())} events, {n} of {key!r}; "
            f"session {attempt + 1} of 4)")
    raise RuntimeError("torch.profiler recorded too few or too many calls")


def median_kernel_ms(fn, reps: int, sessions: int, flush=None):
    """(median, least, most) of ``sessions`` ``kernel_ms`` readings, for a
    call whose time spreads from one session to the next."""
    ms = sorted(kernel_ms(fn, reps, flush=flush) for _ in range(sessions))
    return float(np.median(ms)), ms[0], ms[-1]


def bound_ms(nbytes: float, ops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulp_ok(got, want) -> bool:
    """Within one bf16 ulp: |diff| <= 2^-7 * max(|plain|, 1) (one bf16
    rounding of the same fp32 value may land one ulp apart)."""
    return bool(((got.float() - want.float()).abs()
                 <= 2 ** -7 * want.float().abs().clamp(min=1)).all())


def hold_gru(tag: str, pairs, dtype, shape: str, err, err_bf16) -> None:
    """Phases 3 and 6: each ``name: (kernel outputs, plain outputs)``
    within GRU_TOL in fp32 and one bf16 ulp in bf16; the largest error
    over both phases goes into ``err`` or ``err_bf16``."""
    for name, (got, want) in pairs.items():
        e = max(max_err(a, w) for a, w in zip(got, want))
        if dtype == torch.float32:
            ok, bound = e <= GRU_TOL, f"tol {GRU_TOL:g}"
            err[name] = max(err.get(name, 0.0), e)
        else:
            ok = all(bf16_ulp_ok(a, w) for a, w in zip(got, want))
            bound = "bound one bf16 ulp: 2^-7*max(|plain|,1)"
            err_bf16[name] = max(err_bf16.get(name, 0.0), e)
        log(f"[{tag}] {name} {str(dtype)[6:]} {shape}: max abs err {e:.3e} "
            f"({bound})")
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version")


def l2_flusher():
    """A 128 MB device-to-device copy, more than the 50 MB L2: run before a
    call, it leaves the L2 cold (``kernel_ms`` leaves its time out)."""
    src = torch.empty(32 * 2 ** 20, device="cuda")
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def time_kernels(tag: str, work, smi: str, reps: int, plain_reps: int,
                 where: str = ""):
    """Phases 4 and 6: for each ``name: (kernel, plain, library or None,
    bytes, operations)``, device times L2 cold (a 128 MB copy, more than
    the 50 MB L2, before each call; the copies' own time left out) and,
    for the kernel, L2 warm, beside the bound; logged with the card."""
    flush = l2_flusher()
    times = {}
    for name, (kern, plain, library, nb, ops) in work.items():
        t = times[name] = dict(
            ms=kernel_ms(kern, reps, flush=flush),
            ms_l2_warm=kernel_ms(kern, reps),
            plain_ms=kernel_ms(plain, plain_reps, flush=flush),
            library_ms=(None if library is None
                        else kernel_ms(library, plain_reps, flush=flush)),
            bound=bound_ms(nb, ops), mbytes=nb / 1e6, nbytes=nb, ops=ops)
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms']:.4f} ms")
        log(f"[{tag}] {name}{where}: kernel {t['ms']:.4f} ms (profiler, L2 "
            f"cold; {t['ms_l2_warm']:.4f} ms L2 warm), plain {t['plain_ms']:.4f} "
            f"ms{lib}, bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
            f"({nb / 1e6:.2f} MB); {smi}")
    return times


# ---------------------------------------------------------------------------
# phase 3-4 inputs and yardsticks
# ---------------------------------------------------------------------------

def lookup_inputs(gen: torch.Generator, dtype: torch.dtype, B: int = 1,
                  grid=GRID):
    """A pyramid (B, N, Hl, Wl) and coords (B, H, W, 2) at a path's
    geometry (by default the inference path's, N = 7040 on a 55x128 grid):
    grid + random flow, with a tenth of the queries far outside the image."""
    H, W = grid
    N = H * W
    vol = torch.randn((B, N, H, W), generator=gen, device="cuda")
    pyramid = [vol]
    for _ in range(3):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    pyramid = [v.to(dtype).contiguous() for v in pyramid]
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda", dtype=torch.float32),
                            torch.arange(W, device="cuda", dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1)[None].expand(B, H, W, 2)
    coords = coords + 12.0 * torch.randn(coords.shape, generator=gen,
                                         device="cuda")
    far = torch.rand((B, H, W, 1), generator=gen, device="cuda") < 0.1
    coords = torch.where(far, coords + 150.0 * torch.sign(
        torch.randn(coords.shape, generator=gen, device="cuda")), coords)
    return pyramid, coords.contiguous()


def in_range_taps(coords, level: int, Hl: int, Wl: int, radius: int):
    """Per query, how many taps of its (2r+2)² window at ``level`` lie
    inside the Hl x Wl level (coords clamped as the kernels clamp them)."""
    K = 2 * radius + 1

    def span(c, size):
        c = (c / 2 ** level).clamp(-(radius + 2.0), size + radius + 1.0)
        lo = torch.floor(c) - radius
        return ((lo + K).clamp(max=size - 1) - lo.clamp(min=0) + 1).clamp(min=0)

    return span(coords[..., 0], Wl) * span(coords[..., 1], Hl)


def lookup_bytes(pyramid, coords, radius: int) -> float:
    """Bytes this run's lookup must move: the in-range part of every
    (2r+2)² window read once, coords read once, the output written once."""
    K = 2 * radius + 1
    total = coords.numel() * 4 + coords[..., 0].numel() * len(pyramid) * K * K * 4
    for i, vol in enumerate(pyramid):
        Hl, Wl = vol.shape[-2:]
        taps = in_range_taps(coords, i, Hl, Wl, radius)
        total += float(taps.sum()) * vol.element_size()
    return total


def lookup_sector_bytes(pyramid, coords, radius: int) -> float:
    """``lookup_bytes`` with each in-range window row counted in the whole
    32-byte sectors it touches (the unit the DRAM moves; the levels are
    allocated sector-aligned): the bytes a design that reads each window
    row once still moves."""
    B, H, W, _ = coords.shape
    K = 2 * radius + 1
    P = K + 1
    n = B * H * W
    total = coords.numel() * 4 + n * len(pyramid) * K * K * 4
    q = torch.arange(n, device=coords.device, dtype=torch.float64)
    for i, vol in enumerate(pyramid):
        Hl, Wl = vol.shape[-2:]
        es = vol.element_size()

        def origin(c, size):
            c = (c.reshape(-1) / 2 ** i).clamp(-(radius + 2.0), size + radius + 1.0)
            return torch.floor(c).double() - radius

        x0, y0 = origin(coords[..., 0], Wl), origin(coords[..., 1], Hl)
        lo, hi = x0.clamp(min=0), (x0 + P - 1).clamp(max=Wl - 1)
        for dy in range(P):
            iy = y0 + dy
            ok = (iy >= 0) & (iy < Hl) & (lo <= hi)
            start = ((q * Hl + iy) * Wl + lo) * es
            end = ((q * Hl + iy) * Wl + hi) * es + es - 1
            sectors = torch.floor(end / SECTOR) - torch.floor(start / SECTOR) + 1
            total += float(torch.where(ok, sectors, 0).sum()) * SECTOR
    return total


def note_sectors(tag: str, t: dict, pyramid, coords, smi: str) -> None:
    """Phases 4 and 6: K1's bytes counted in whole 32-byte sectors beside
    its bound, and the shares of each that its time reaches."""
    sb = lookup_sector_bytes(pyramid, coords, 4)
    t["sector_mbytes"] = sb / 1e6
    t["sector_ms"] = sb / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] corr_lookup: in-range window rows in whole 32-byte sectors "
        f"{sb / 1e6:.2f} MB ({sb / (t['mbytes'] * 1e6):.2f}x the bound's "
        f"{t['mbytes']:.2f} MB), {t['sector_ms']:.4f} ms at 3.35 TB/s; kernel "
        f"at {t['bound'][0] / t['ms']:.1%} of its bound, "
        f"{t['sector_ms'] / t['ms']:.1%} of the sector time; {smi}")


# ---------------------------------------------------------------------------
# phase 5 inputs
# ---------------------------------------------------------------------------

def synthetic_frames(seed: int, n: int, hw=FRAME_HW):
    """``n`` frames of a smooth random texture, each shifted by (2, 3) px
    from the last (a flow of (-3, -2) in (x, y)), as (H, W, 3) float32 in
    [0, 255]."""
    H, W = hw
    m = 4 * n
    rng = np.random.RandomState(seed)
    noise = rng.randn(H + m, W + m, 3)
    f = np.fft.fft2(noise, axes=(0, 1))
    ky = np.fft.fftfreq(H + m)[:, None, None]
    kx = np.fft.fftfreq(W + m)[None, :, None]
    f *= np.exp(-(kx ** 2 + ky ** 2) / (2 * 0.03 ** 2))
    t = np.real(np.fft.ifft2(f, axes=(0, 1)))
    t = ((t - t.min()) / (t.max() - t.min()) * 255).astype(np.float32)
    return [t[2 * k:2 * k + H, 3 * k:3 * k + W] for k in range(n)]


def run_pairs(model, config, frames, iters: int):
    """One timed ``flow_pairs`` run: (flows, ms per pair, peak MB)."""
    from raft_tpu_torch.cli.demo import flow_pairs
    from raft_tpu_torch.evaluation.evaluate import make_forward

    fwd, _ = make_forward(config, iters, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flows = flow_pairs(functools.partial(fwd, model), frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    for f in flows:
        if not np.isfinite(f).all() or f.shape != frames[0].shape[:2] + (2,):
            raise RuntimeError(f"bad flow: shape {f.shape}, finite "
                               f"{np.isfinite(f).all()}")
    return flows, ms, peak


def flow_diff(a, b) -> float:
    return float(max(np.abs(x - y).max() for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# phases 6-8: the training path
# ---------------------------------------------------------------------------

def scatter_bytes(pyramid, coords, radius: int) -> float:
    """Bytes the lookup's backward must move: the cotangent and coords
    read once, the whole gradient volume written once (zero outside the
    windows)."""
    K = 2 * radius + 1
    n = coords[..., 0].numel()
    return (n * len(pyramid) * K * K * 4 + coords.numel() * 4
            + sum(v.numel() * v.element_size() for v in pyramid))


def gru_bwd_inputs(gen: torch.Generator, dtype: torch.dtype, B: int = TRAIN_B,
                   grid=TRAIN_GRID, layout: str = "channels_last"):
    """A path's GRU operands, forward and backward, by default the training
    path's (10, 128, 46, 62) as the update block hands them: zl and rl the
    channel halves of a double-width gate conv output, ``drh`` a channel
    slice of a concatenation's gradient, all channels-last (NHWC rows of
    128 channels, 256 or 384 apart); ``layout="contiguous"`` gives the
    same views of NCHW tensors (one run a batch element)."""
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)

    def rand(C):
        return (3 * torch.randn((B, C) + tuple(grid), generator=gen,
                                device=gen.device)).to(dtype).contiguous(
                                    memory_format=fmt)

    zl, rl = rand(256).split(128, 1)
    h, ql, dz, g = (rand(128) / 3 for _ in range(4))
    drh = (rand(384) / 3)[:, :128]
    z = torch.sigmoid(rand(128).float()).to(dtype)
    return zl, rl, h, ql, dz, drh, g, z


#: the GRU layout holds' and times' geometries: the serving cells' 1/8 grid
#: of 440x1024 at batch 1 and 4, and the chairs recipe's at batch 10
GRU_GEOMETRIES = {"inference_b1": (1, GRID), "inference_b4": (4, GRID),
                  "training_b10": (TRAIN_B, TRAIN_GRID)}
GRU_NAMES = ("gru_gates", "gru_blend", "gru_gates_bwd", "gru_blend_bwd")
#: operands read and written a call, in units of one (B, 128, H, W) tensor
GRU_TENSORS = {"gru_gates": 5, "gru_blend": 4, "gru_gates_bwd": 8,
               "gru_blend_bwd": 7}
GRU_OPS = {"gru_gates": 9, "gru_blend": 6, "gru_gates_bwd": 16,
           "gru_blend_bwd": 12}


def gru_calls(zl, rl, h, ql, dz, drh, g, z):
    """``name: (kernel call, plain call)`` for the four GRU kernels."""
    from raft_tpu_torch.kernels import gru as kg

    return {"gru_gates": (lambda: kg.gru_gates(zl, rl, h),
                          lambda: kg.gru_gates_plain(zl, rl, h)),
            "gru_blend": (lambda: (kg.gru_blend(z, h, ql),),
                          lambda: (kg.gru_blend_plain(z, h, ql),)),
            "gru_gates_bwd": (lambda: kg.gru_gates_bwd(zl, rl, h, dz, drh),
                              lambda: kg.gru_gates_bwd_plain(zl, rl, h, dz,
                                                             drh)),
            "gru_blend_bwd": (lambda: kg.gru_blend_bwd(z, h, ql, g),
                              lambda: kg.gru_blend_bwd_plain(z, h, ql, g))}


def hold_gru_layouts(tag: str, gen: torch.Generator, err, err_bf16) -> None:
    """Phase 3: the four GRU kernels against their plain versions on
    operands built as :func:`gru_bwd_inputs` builds them, channels-last
    (the main path's route) and NCHW, at each of :data:`GRU_GEOMETRIES`, in
    fp32 and bf16: within GRU_TOL or one bf16 ulp (:func:`hold_gru`), each
    output dense in the operands' layout, and each launch counted by
    ``kernels.launch_layouts()`` under that layout and no other."""
    from raft_tpu_torch import kernels

    for geo, (B, grid) in GRU_GEOMETRIES.items():
        for layout in ("channels_last", "contiguous"):
            fmt = (torch.channels_last if layout == "channels_last"
                   else torch.contiguous_format)
            for dtype in (torch.float32, torch.bfloat16):
                ops = gru_bwd_inputs(gen, dtype, B, grid, layout)
                before = kernels.launch_layouts()
                pairs = {name: (kern(), plain()) for name, (kern, plain)
                         in gru_calls(*ops).items()}
                torch.cuda.synchronize()
                after = kernels.launch_layouts()
                for name in GRU_NAMES:
                    moved = {r: after[name][r] - before[name][r]
                             for r in after[name]}
                    want = {r: int(r == layout) for r in after[name]}
                    if moved != want:
                        raise RuntimeError(
                            f"{name} on {layout} operands: launch_layouts "
                            f"moved by {moved}, want {want}")
                    for a in pairs[name][0]:
                        if not a.is_contiguous(memory_format=fmt):
                            raise RuntimeError(
                                f"{name}'s output {tuple(a.stride())} is "
                                f"not dense {layout}")
                hold_gru(tag, pairs, dtype,
                         f"{geo} {layout} {tuple(ops[2].shape)}", err,
                         err_bf16)
                del ops, pairs


def time_gru_layouts(tag: str, gen: torch.Generator, smi: str) -> dict:
    """Phase 4: each GRU kernel's device time (:func:`kernel_ms`, L2
    flushed before every call) on :func:`gru_bwd_inputs`' fp32 operands in
    both layouts at each of :data:`GRU_GEOMETRIES`, beside the bound its
    bytes set at HBM_BYTES_PER_S."""
    flush = l2_flusher()
    out = {}
    for geo, (B, grid) in GRU_GEOMETRIES.items():
        for layout in ("channels_last", "contiguous"):
            ops = gru_bwd_inputs(gen, torch.float32, B, grid, layout)
            n = ops[2].numel()
            for name, (kern, _) in gru_calls(*ops).items():
                nbytes = GRU_TENSORS[name] * n * 4
                bound = bound_ms(nbytes, GRU_OPS[name] * n)[0]
                ms = kernel_ms(kern, 50, flush=flush)
                out[f"{geo}.{layout}.{name}"] = dict(
                    ms=ms, bound_ms=bound, mbytes=nbytes / 1e6,
                    share_pct=100.0 * bound / ms)
                log(f"[{tag}] {name} {geo} {layout} {tuple(ops[2].shape)}: "
                    f"{ms:.4f} ms (profiler, L2 cold), bound {bound:.4f} ms "
                    f"({100 * bound / ms:.1f}%); {smi}")
            del ops
    return out


def gru_layouts_all(tag: str, launched: dict, layouts: dict) -> None:
    """The main path's GRU launches (``launched``, from
    ``kernels.launch_counts()``) all on the channels-last route by
    ``layouts`` (``kernels.launch_layouts()`` over the same calls)."""
    for name in GRU_NAMES:
        n = launched.get(name, 0)
        want = {"channels_last": n, "contiguous": 0}
        if layouts[name] != want:
            raise RuntimeError(f"{name}: launch_layouts {layouts[name]}, "
                               f"want {want}")
    log(f"[{tag}] launch_layouts {layouts}: every GRU launch on the "
        "channels_last route")


def train_batch(seed: int):
    """A chairs-geometry batch on the loader's uint8 wire: TRAIN_B pairs of
    consecutive synthetic frames, ground truth their known shift, every
    pixel valid."""
    H, W = TRAIN_HW
    frames = synthetic_frames(seed, TRAIN_B + 1, TRAIN_HW)
    frames = [np.round(f).astype(np.uint8) for f in frames]
    return {"image1": np.stack(frames[:-1]), "image2": np.stack(frames[1:]),
            "flow": np.broadcast_to(np.float32(TRAIN_FLOW),
                                    (TRAIN_B, H, W, 2)).copy(),
            "valid": np.ones((TRAIN_B, H, W), np.uint8)}


class TimedLoader:
    """The batches, with the host clock read (device synchronised) each time
    the trainer asks for the next one: mark k+1 - mark k is step k."""

    def __init__(self, batches):
        self.batches = batches
        self.marks = []

    def __iter__(self):
        for b in self.batches:
            torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            yield b


def train_config(**kw):
    from raft_tpu_torch.config import stage_config

    base = dict(batch_size=TRAIN_B, image_size=TRAIN_HW, iters=TRAIN_ITERS,
                validation=())
    base.update(kw)
    return stage_config("chairs", **base)


def step_grads(config, weights, batch, iters: int):
    """One train step from ``weights`` on ``batch``: (loss, raw gradient of
    every parameter). The clip is set out of reach so the gradients are the
    backward's own."""
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    model = RAFT(config)
    model.load_state_dict(weights)
    tc = train_config(iters=iters, clip=float("inf"))
    state = create_train_state(model.cuda(), tc)
    metrics = make_train_step(config, tc)(state, batch)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    return float(metrics["loss"]), grads


def step_gap(a, b):
    """Between two ``step_grads`` results: (relative loss gap; the largest
    and the median over parameters of max|grad gap| / max|grad|; each
    parameter's (max|grad gap|, max|grad|); the model's largest gradient).
    Parameters whose gradient is under 1e-4 of the model's largest (biases
    in front of a norm, zero in exact arithmetic) are left out of the
    largest and the median; the per-parameter bound covers them."""
    (la, ga), (lb, gb) = a, b
    gmax = max(float(g.abs().max()) for g in gb.values())
    rel, worst = [], {}
    for k in gb:
        scale = float(gb[k].abs().max())
        err = float((ga[k] - gb[k]).abs().max())
        worst[k] = (err, scale)
        if scale > 1e-4 * gmax:
            rel.append(err / scale)
    return abs(la - lb) / abs(lb), max(rel), float(np.median(rel)), worst, gmax


def witness_bounds(witnesses, base):
    """The largest relative loss gap, largest-parameter gradient gap and
    median gradient gap of ``witnesses`` (``step_grads``-shaped results)
    to ``base``."""
    gaps = [step_gap(w, base)[:3] for w in witnesses]
    return tuple(max(g[i] for g in gaps) for i in range(3))


def check_step(name, plain, kernels, ulp, tag="8", bf16=False,
               across_ranks=False, ulp2=()):
    """Phases 8 and 12: one step's kernels-vs-plain gap against the plain
    path's gap against itself on inputs moved by one ulp (``ulp``). For the
    gradients: each parameter's within the largest relative one-ulp gap of
    the model plus an absolute floor, and the median within the one-ulp
    median. In fp32 (phase 8) the loss is held to STEP_LOSS_TOL and the
    floor is 1e-6 of the model's largest gradient. In bf16 (phase 12) the
    loss is held to the one-ulp loss gap, and the floor is the largest
    one-ulp gap among the parameters under 1e-4 of the model's largest
    gradient: conv biases in front of a norm that subtracts the batch's or
    the instance's mean, whose gradient is zero in exact arithmetic and
    rounding noise in bf16 (2^-8 relative to the terms that cancel, not
    to the tiny result). ``across_ranks`` (phase 21's two ranks against
    one): the loss within the larger of STEP_LOSS_TOL and its one-ulp gap
    (at iters 12 random weights amplify a rounding difference past 1e-5),
    and a parameter whose gradient is under 1e-4 of the model's largest
    (zero in exact arithmetic: a bias in front of a batch norm, whose
    statistics the two paths sum by other formulas) within that 1e-4.
    ``ulp`` may be a list of such witnesses (each an input moved by one
    ulp another way): each bound is then the largest of theirs. ``ulp2``
    (phase 22's bands, which round every conv and norm another way than
    one rank): a list of ``kernels``' own steps on inputs moved by one
    ulp, whose largest gaps to ``kernels`` are added to the bounds, one
    rounding noise for each side."""
    dl, worst_rel, median, worst, gmax = step_gap(kernels, plain)
    ulps = ulp if isinstance(ulp, list) else [ulp]
    ulp_worst = step_gap(ulps[0], plain)[3]
    ulp_loss, grad_tol, median_tol = witness_bounds(ulps, plain)
    if ulp2:
        more = witness_bounds(ulp2, kernels)
        ulp_loss, grad_tol, median_tol = (
            a + b for a, b in zip((ulp_loss, grad_tol, median_tol), more))
    loss_tol, floor = STEP_LOSS_TOL, 1e-6 * gmax
    if across_ranks:
        loss_tol = max(STEP_LOSS_TOL, ulp_loss)
    if bf16:
        loss_tol = ulp_loss
        floor = max([floor] + [e for e, s in ulp_worst.values()
                               if s <= 1e-4 * gmax])
    small = 1e-4 * gmax if across_ranks else 0.0
    bad = [(k, e, s) for k, (e, s) in worst.items()
           if not e <= max(grad_tol * s + floor, small if s <= small
                           else 0.0)]
    log(f"[{tag}] {name}: loss gap {dl:.3e} (tol {loss_tol:.3e}), gradient "
        f"gap largest {worst_rel:.3e} of a parameter's largest (bound: one "
        f"ulp of input, {grad_tol:.3e}, + {floor:.3e}, "
        f"{floor / gmax:.2e} of the model's largest), median {median:.3e} "
        f"(bound: one ulp of input, {median_tol:.3e})")
    if not (dl <= loss_tol and not bad and median <= median_tol):
        raise RuntimeError(f"{name}: kernels disagree with plain: {bad[:5]}")


def bf16_ulp_batch(batch):
    """``batch`` with every image pixel moved so that the normalized input
    2·img/255 − 1 that the bf16 convs read moves by one bf16 ulp: one ulp
    of input in the precision the mixed path computes in."""
    out = dict(batch)
    for k in ("image1", "image2"):
        x = torch.from_numpy(2.0 * (batch[k] / np.float32(255.0)) - 1.0)
        up = torch.nextafter(x.to(torch.bfloat16),
                             torch.tensor(np.inf, dtype=torch.bfloat16))
        out[k] = ((up.float() + 1.0) * 127.5).numpy().astype(np.float32)
    return out


def full_state(state):
    """A train state's parameters, buffers, AdamW state, schedule and step,
    copied to the host."""
    def host(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().clone()
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(host(v) for v in tree)
        return tree

    return host({"model": state.model.state_dict(),
                 "optimizer": state.optimizer.state_dict(),
                 "scheduler": state.scheduler.state_dict(),
                 "step": state.step})


def same_tree(a, b, path="") -> str:
    """'' when ``a`` and ``b`` are bitwise equal, else the first path that
    differs."""
    if isinstance(a, torch.Tensor):
        ok = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
              and torch.equal(a, b))
        return "" if ok else path
    if isinstance(a, dict):
        if not isinstance(b, dict) or sorted(a) != sorted(b):
            return path
        return next((p for k in a
                     for p in [same_tree(a[k], b[k], f"{path}/{k}")] if p), "")
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return path
        return next((p for i, (x, y) in enumerate(zip(a, b))
                     for p in [same_tree(x, y, f"{path}/{i}")] if p), "")
    return "" if a == b else path


def timed_steps(state, step_fn, batches):
    """ms of each step of ``step_fn`` over ``batches`` (device batches),
    the device synchronised around each."""
    ms = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def fft_conv_ms(evs) -> float:
    """Device ms of cuDNN's FFT convolutions among ``evs``: the FFT kernels
    and the complex GEMMs between them."""
    return sum(e.self_device_time_total for e in evs
               if "fft" in e.key.lower() or "cf32" in e.key.lower()) / 1e3


def profile_step(step_fn, state, batch):
    """One step under the profiler: (wall ms, device busy ms, device
    events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, device_busy_ms(prof), device_events(prof)


def grads_with_peak(config, weights, batch, iters: int):
    """``step_grads`` with the peak device memory (MiB) and wall ms of the
    step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step_grads(config, weights, batch, iters)
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() / 2 ** 20,
            (time.perf_counter() - t0) * 1e3)


# ---------------------------------------------------------------------------
# phases 9-13: the alternate path (K5) and evaluation
# ---------------------------------------------------------------------------

def smooth_flow(grid, device, amp: float = SMOOTH_AMP,
                jump: float = SMOOTH_JUMP):
    """(1, H, W, 2) flow like a trained model's: KITTI_FLOW, plus a
    low-frequency field of up to +-``amp`` px whose wavelength is the grid
    width, plus ``jump`` px in x right of a vertical motion boundary that
    cuts a column of 8x8 tiles (at W/2 + 3)."""
    H, W = grid
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    u = KITTI_FLOW[0] + amp * torch.sin(2 * np.pi * (xs + ys) / W)
    v = KITTI_FLOW[1] + amp * torch.cos(2 * np.pi * (xs - ys) / W)
    u = u + jump * (xs >= W // 2 + 3)
    return torch.stack([u, v], -1)[None]


def alt_inputs(gen: torch.Generator, C: int, radius: int, grid,
               levels: int = 4, field: str = "iid", scale: float = 1.0):
    """K5's operands at a path's 1/8 grid, on ``gen``'s device: fmap1 (1,
    H, W, C) and the NHWC fmap2 pyramid pooled from a random fmap2, both
    ``scale`` times unit variance, and coords
    = grid + a flow (``field``: "iid", 12 px of i.i.d. noise per query, or
    "smooth", ``smooth_flow``) with a tenth of the queries 150 px out and
    the first query's window straddling the top-left corner."""
    from raft_tpu_torch.models.corr import AlternateCorrBlock

    H, W = grid
    dev = gen.device
    f1, f2 = (scale * torch.randn((1, H, W, C), generator=gen, device=dev)
              for _ in range(2))
    block = AlternateCorrBlock(f1, f2, levels, radius)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1)[None]
    if field == "iid":
        coords = coords + 12.0 * torch.randn(coords.shape, generator=gen,
                                             device=dev)
    elif field == "smooth":
        coords = coords + smooth_flow(grid, dev)
    else:
        raise ValueError(f"field {field!r}: one of {FIELDS}")
    far = torch.rand((1, H, W, 1), generator=gen, device=dev) < 0.1
    coords = torch.where(far, coords + 150.0 * torch.sign(
        torch.randn(coords.shape, generator=gen, device=dev)), coords)
    coords[0, 0, 0] = torch.tensor([-0.5, -1.5])
    return block.fmap1, block.fmap2_pyramid, coords.contiguous()


def kitti_bucket():
    """``validate_kitti``'s default ``shape_bucket``."""
    from raft_tpu_torch.evaluation.evaluate import validate_kitti

    return inspect.signature(validate_kitti).parameters["shape_bucket"].default


def kitti_eval_grid():
    """The 1/8 grid that ``validate_kitti`` hands the model for a KITTI
    frame: padded to a multiple of 8, then edge-filled to its default
    ``shape_bucket`` (375x1242 -> 384x1280, grid 48x160)."""
    from raft_tpu_torch.evaluation.evaluate import _to_device_pair

    frame = np.zeros(KITTI_HW + (3,), np.float32)
    i1, _, _, _ = _to_device_pair(frame, frame, "kitti", kitti_bucket(),
                                  device="cpu")
    return i1.shape[1] // 8, i1.shape[2] // 8


def k5_branches(fn, device):
    """``fn()`` with K5's branch counters on ``device`` set to 0 just
    before: (its result, (tiles on the tiled branch, tiles on the per-query
    branch)). On the CPU, where the wrappers run the plain version, (0, 0)."""
    from raft_tpu_torch.kernels.corr_alt import branch_counts

    if torch.device(device).type != "cuda":
        return fn(), (0, 0)
    counts = branch_counts(device)
    counts.zero_()
    out = fn()
    tiled, per_query = counts.tolist()
    return out, (tiled, per_query)


def branch_note(branches) -> str:
    tiled, per_query = branches
    n = tiled + per_query
    if not n:
        return "no corr_alt tiles"
    return (f"{tiled} tiles tiled, {per_query} per-query ({tiled / n:.1%} "
            "tiled)")


def check_alt(gen: torch.Generator, grid, C: int, radius: int, where: str,
              field: str = "iid", scale: float = 1.0):
    """Phase 9 at one geometry, coordinate field and fmap magnitude
    (``scale`` times unit variance): K5 against its plain version (ALT_ATOL
    + ALT_RTOL, exact zeros for the far-out queries, two calls bitwise
    equal; the error also logged as a fraction of sum |fmap1| |fmap2| /
    sqrt(C), the scale of fp32 rounding in the dots), and against the
    materialized path on the same fmaps, whose K1 is held against its plain
    version too. Returns (K5's error, K1's, K5's (tiled, per-query)
    tiles)."""
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda
    from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda
    from raft_tpu_torch.models.corr import (alt_corr_lookup,
                                            build_corr_pyramid,
                                            corr_lookup_gather)

    f1, pyr, coords = alt_inputs(gen, C, radius, grid, field=field,
                                 scale=scale)
    got, branches = k5_branches(
        lambda: alt_corr_lookup_cuda(f1, pyr, coords, radius), coords.device)
    again = alt_corr_lookup_cuda(f1, pyr, coords, radius)
    want = alt_corr_lookup(f1, pyr, coords, radius)
    diff = (got - want).abs()
    e = float(diff.max())
    within = bool((diff <= ALT_ATOL + ALT_RTOL * want.abs()).all())
    used = float((diff / (ALT_ATOL + ALT_RTOL * want.abs())).max())
    mag = alt_corr_lookup(f1.abs(), [v.abs() for v in pyr], coords, radius)
    frac = float((diff / mag.clamp(min=1e-30)).max())
    far = far_queries(coords, radius)
    zeros = bool(far.any()) and not bool(got[far].any())
    bitwise = torch.equal(got, again)
    shape = (f"C={C} r={radius}, grid {grid[0]}x{grid[1]} ({where}), {field} "
             f"field, fmaps {scale:g} x randn")
    log(f"[9] corr_alt {shape}: max abs err {e:.3e} vs the plain version "
        f"(tol {ALT_ATOL:g} + {ALT_RTOL:g} relative: {used:.3f} of it used; "
        f"{frac:.3e} of sum|fmap1||fmap2|/sqrt(C)); {int(far.sum())} "
        f"far-out queries exact zeros: {zeros}; two calls bitwise equal: "
        f"{bitwise}; {branch_note(branches)}")
    if not (within and zeros and bitwise):
        raise RuntimeError("corr_alt disagrees with its plain version")
    mat_pyr = build_corr_pyramid(f1, pyr[0])
    mat = corr_lookup_cuda(mat_pyr, coords, radius)
    e_k1 = max_err(mat, corr_lookup_gather(mat_pyr, coords, radius))
    e_mat, scale = max_err(got, mat), float(mat.abs().max())
    log(f"[9] corr_alt {shape} vs the materialized path (volume + pooling "
        f"+ corr_lookup): max abs err {e_mat:.3e}, {e_mat / scale:.3e} of "
        f"the largest output {scale:.3f} (tol {ALT_MAT_TOL:g}); that "
        f"corr_lookup vs its plain version {e_k1:.3e} (tol {LOOKUP_TOL:g})")
    if not e_mat <= ALT_MAT_TOL * scale:
        raise RuntimeError("corr_alt disagrees with the materialized path")
    if not e_k1 <= LOOKUP_TOL:
        raise RuntimeError("corr_lookup disagrees with its plain version")
    return e, e_k1, branches


def sass_mma_counts(lib_path: str) -> dict:
    """Per kernel of the built library whose name holds "corr": how many
    tensor-core matrix multiply instructions (HMMA, and HGMMA for wgmma) its
    SASS has, read with the toolkit's ``cuobjdump -sass``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if "corr" in name:
                counts[name] = 0
        elif name in counts and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def alt_bound(nbytes: float, ops: float):
    """K5's bound, restated for tensor cores: the larger of its bytes at
    3.35 TB/s and its operations done as three TF32 products each (the
    error-compensated split) at 495 TFLOP/s; and the fp32 figure, the
    operations at 67 TFLOP/s on the CUDA cores, which a tensor-core kernel
    can beat."""
    return (bound_ms(nbytes, 3 * ops, TF32_FLOPS_PER_S),
            bound_ms(nbytes, ops, FP32_FLOPS_PER_S))


def alt_cost(fmap1, pyramid, coords, radius: int):
    """(bytes, operations) this run's K5 call needs: fmap1, the pyramid and
    coords read once and the output written once; 2·C operations for each
    in-range tap of each (2r+2)² window (out-of-range taps are not dotted)
    and 10 for each output's lerp and scale."""
    C = fmap1.shape[-1]
    K = 2 * radius + 1
    n = coords[..., 0].numel()
    taps = sum(float(in_range_taps(coords, i, v.shape[1], v.shape[2],
                                   radius).sum())
               for i, v in enumerate(pyramid))
    nbytes = 4 * (fmap1.numel() + sum(v.numel() for v in pyramid)
                  + coords.numel() + n * len(pyramid) * K * K)
    return nbytes, taps * 2 * C + n * len(pyramid) * K * K * 10


def far_queries(coords, radius: int, levels: int = 4):
    """Queries whose windows miss every level: more than (r+1)·2^(L-1) px
    outside the level-0 grid."""
    _, H, W, _ = coords.shape
    m = (radius + 1) * 2 ** (levels - 1) + 1
    x, y = coords[..., 0], coords[..., 1]
    return (x < -m) | (x > W - 1 + m) | (y < -m) | (y > H - 1 + m)


def write_kitti(root: str, n: int = KITTI_PAIRS):
    """A KITTI-15 training split in its on-disk layout: ``n`` pairs of
    seeded synthetic 375x1242 frames (``image_2/*_10.png``, ``*_11.png``),
    the second shifted by KITTI_FLOW, and 16-bit flow PNGs
    (``flow_occ/*_10.png``: (u, v, valid) with a third of the pixels
    invalid, as KITTI's sparse ground truth)."""
    from raft_tpu_torch.data.png import write_png

    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(root, "training", d), exist_ok=True)
    rng = np.random.RandomState(7)
    H, W = KITTI_HW
    for i in range(n):
        f1, f2 = (np.round(f).astype(np.uint8)
                  for f in synthetic_frames(10 + i, 2, KITTI_HW))
        write_png(os.path.join(root, "training", "image_2", f"{i:06d}_10.png"), f1)
        write_png(os.path.join(root, "training", "image_2", f"{i:06d}_11.png"), f2)
        uv = np.broadcast_to(np.float32(KITTI_FLOW), (H, W, 2))
        valid = (rng.rand(H, W, 1) > 1 / 3).astype(np.float64)
        px = np.concatenate([64.0 * uv + 2 ** 15, valid], -1).astype(np.uint16)
        write_png(os.path.join(root, "training", "flow_occ", f"{i:06d}_10.png"), px)


def kitti_flows(model, config, root: str, iters: int):
    """The validator's flows over the KITTI split under ``root``, pair by
    pair (bucketed and cropped as ``validate_kitti`` does)."""
    from raft_tpu_torch.data.datasets import KITTI
    from raft_tpu_torch.evaluation.evaluate import (_crop, _to_device_pair,
                                                    make_forward)

    fwd, _ = make_forward(config, iters, device="cuda")
    val = KITTI(split="training", root=os.path.join(root, "KITTI"))
    out = []
    for i in range(len(val)):     # indexing wraps around: no iteration
        img1, img2, _, _ = val[i]
        i1, i2, padder, crop = _to_device_pair(img1, img2, "kitti",
                                               kitti_bucket())
        out.append(padder.unpad(_crop(fwd(model, i1, i2)[1], crop))[0]
                   .cpu().numpy())
    return out


def run_evaluate(argv, pairs: int):
    """One timed ``cli/evaluate.main`` run: (metrics, ms per pair with the
    frames' decoding, peak MiB, launches)."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.cli.evaluate import main as evaluate_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = evaluate_main(argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / pairs
    return (metrics, ms, torch.cuda.max_memory_allocated() / 2 ** 20,
            kernels.launch_counts())


def expected_launches(**counts):
    """Every kernel's launch count: those given, 0 for the rest."""
    names = ("corr_lookup", "corr_scatter", "gru_gates", "gru_blend",
             "gru_gates_bwd", "gru_blend_bwd", "corr_alt")
    return {k: counts.get(k, 0) for k in names}


def sintel_submission(model, config, root: str, out: str,
                      device: str = "cuda"):
    """``create_sintel_submission`` with warm start over the Sintel test
    layout under ``root``; returns the written flows by path (relative to
    ``out``) and, per pair, the (low-res flow, forward-interpolated init)
    that ``forward_interpolate`` saw and gave."""
    from raft_tpu_torch.data.frame_utils import read_flow
    from raft_tpu_torch.evaluation import evaluate as ev

    warps = []
    interp = ev.forward_interpolate

    def recording(flow):
        init = interp(flow)
        warps.append((flow, init))
        return init

    ev.forward_interpolate = recording
    try:
        ev.create_sintel_submission(model, config, warm_start=True,
                                    output_path=out, data_root=root,
                                    device=device)
    finally:
        ev.forward_interpolate = interp
    flows = {}
    for d, _, files in sorted(os.walk(out)):
        for f in sorted(files):
            flows[os.path.relpath(os.path.join(d, f), out)] = read_flow(
                os.path.join(d, f))
    return flows, warps


def check_sintel_chain(subs, frames, models) -> None:
    """Phase 11: the two paths' warm-started submissions over one scene of
    ``frames`` in clean and final. ``subs`` maps "alternate" and
    "materialized" to ``sintel_submission``'s result, ``models`` each to
    its (``fwd_init``, model).

    A cold pair is held within SMALL_TOL. A warm pair starts from the last
    pair's low-res flow, forward-interpolated, so the two paths start from
    inits that differ by the last link's gap. Each warm pair is run again
    by each path from the other's init: from one init, only the lookups
    differ, and each path is held within SMALL_TOL of the other there (the
    gates). The chained gap is then at most the gate plus the materialized
    path's own response to the inits' gap (the triangle inequality), and
    is held to that; the response, K1 alone from two inits, shows how the
    warm-start chain feeds a gap forward, link by link."""
    (flows_a, warps_a), (flows_m, warps_m) = (subs["alternate"],
                                              subs["materialized"])
    pairs = len(frames) - 1
    if sorted(flows_a) != sorted(flows_m) or len(flows_a) != 2 * pairs:
        raise RuntimeError(f"submissions wrote {sorted(flows_a)} and "
                           f"{sorted(flows_m)}")
    from raft_tpu_torch.evaluation.evaluate import _to_device_pair

    (fwd_a, model_a), (fwd_m, model_m) = (models["alternate"],
                                          models["materialized"])
    device = next(model_m.parameters()).device.type
    for k, key in enumerate(sorted(flows_a)):
        j = k % pairs                     # the pair's index in its scene
        a, m = flows_a[key], flows_m[key]
        d = float(np.abs(a - m).max())
        if a.shape != frames[0].shape[:2] + (2,) or not np.isfinite(a).all():
            raise RuntimeError(f"{key}: bad flow")
        if j == 0:
            log(f"[11] {key} (cold): max |flow diff| alternate vs "
                f"materialized {d:.3e} px (tol {SMALL_TOL:g})")
            if not d <= SMALL_TOL:
                raise RuntimeError(f"{key}: alternate disagrees")
            continue
        (low_a, init_a), (low_m, init_m) = warps_a[k - 1], warps_m[k - 1]
        d_low = float(np.abs(low_a - low_m).max())
        d_init = float(np.abs(init_a - init_m).max())
        i1, i2, padder, _ = _to_device_pair(frames[j], frames[j + 1],
                                            "sintel", device=device)

        def run(fwd, model, init):
            flow = fwd(model, i1, i2, init[None])[1]
            return padder.unpad(flow)[0].cpu().numpy()

        m_from_a = run(fwd_m, model_m, init_a)
        a_from_m = run(fwd_a, model_a, init_m)
        gate_a = float(np.abs(a - m_from_a).max())
        gate_m = float(np.abs(a_from_m - m).max())
        d_resp = float(np.abs(m_from_a - m).max())
        # griddata's nearest neighbour copies flow values, so without a
        # flipped neighbour the inits differ by at most the low-res flows
        flipped = d_init > d_low
        log(f"[11] {key} (warm, link {j}): from one init, alternate vs "
            f"materialized {gate_a:.3e} px (the alternate's init) and "
            f"{gate_m:.3e} px (the materialized's) (tol {SMALL_TOL:g}); "
            f"chained {d:.3e} px, bound {d_resp + SMALL_TOL:.3e}: the "
            f"materialized path's response to the inits' gap {d_resp:.3e} px "
            f"+ {SMALL_TOL:g} (low-res flows in {d_low:.3e}, their "
            f"forward-interpolated inits {d_init:.3e}, gain "
            f"{d_resp / max(d_init, 1e-30):.1f}"
            f"{', a nearest neighbour flipped' if flipped else ''})")
        if not (gate_a <= SMALL_TOL and gate_m <= SMALL_TOL
                and d <= d_resp + SMALL_TOL):
            raise RuntimeError(f"{key}: alternate disagrees")


def train_cli_phase(tmp: str, smi: str) -> dict:
    """Phase 12 (see the module's notes): the training CLI on the mixed
    chairs recipe, resume, bf16 against fp32, the kernels against plain in
    bf16, and remat. ``tmp`` holds phase 10's KITTI split. Returns the
    CLI run's launches and dtypes and the phase's numbers."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.cli.train import main as train_main
    from raft_tpu_torch.cli.train import synthetic_loader
    from raft_tpu_torch.config import RAFTConfig, stage_config
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.tools.convert import load_pth
    from raft_tpu_torch.training import checkpoint as ckpt_lib
    from raft_tpu_torch.training.optim import make_optimizer
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    cfg_mk = RAFTConfig(mixed_precision=True, corr_impl="pallas",
                        gru_impl="fused")
    cfg_mp = RAFTConfig(mixed_precision=True, corr_impl="gather",
                        gru_impl="xla")
    cfg_fk = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    out_dir = os.path.join(tmp, "train-cli")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    log_dir = os.path.join(out_dir, "runs")
    argv = ["--name", "chip-cli", "--stage", "chairs", "--mixed_schedule",
            "--mixed_precision", "--synthetic", str(CLI_PAIRS),
            "--synthetic_dir", os.path.join(tmp, "synthetic_chairs"),
            "--val_freq", str(CLI_VAL_FREQ), "--validation", "kitti",
            "--num_workers", "4", "--corr_impl", "pallas", "--gru_impl",
            "fused", "--data_root", tmp, "--checkpoint_dir", ckpt_dir,
            "--log_dir", log_dir]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state = train_main(argv + ["--num_steps", str(CLI_STEPS)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, dtypes = kernels.launch_counts(), kernels.launch_dtypes()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    with open(os.path.join(log_dir, "chip-cli", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    vals = [r for r in records if "kitti-epe" in r]
    loop = [r for r in records if "train_loop_s" in r][-1]
    steps_s = loop["train_loop_s"] - loop["validation_s"]
    wait_share = loop["loader_wait_s"] / steps_s
    n_val = sum(1 for i in range(1, CLI_STEPS + 1)
                if i % CLI_VAL_FREQ == CLI_VAL_FREQ - 1)
    val_steps = n_val * KITTI_PAIRS * KITTI_ITERS
    train_steps = CLI_STEPS * TRAIN_ITERS
    want = expected_launches(
        corr_lookup=train_steps + val_steps, corr_scatter=train_steps,
        gru_gates=2 * (train_steps + val_steps),
        gru_blend=2 * (train_steps + val_steps),
        gru_gates_bwd=2 * train_steps, gru_blend_bwd=2 * train_steps)
    val_launches = expected_launches(corr_lookup=val_steps,
                                     gru_gates=2 * val_steps,
                                     gru_blend=2 * val_steps)
    per_step = {k: (launches[k] - val_launches[k]) / CLI_STEPS
                for k in launches}
    log(f"[12] cli/train.main {' '.join(argv[:20])} ... --num_steps "
        f"{CLI_STEPS}: {run_s:.2f} s in all (the {CLI_PAIRS} samples' "
        f"writing, {n_val} KITTI validations and the saves included); the "
        f"loop's steps {1e3 * steps_s / CLI_STEPS:.2f} ms each with the "
        f"loader, which the host waited {loop['loader_wait_s']:.3f} s of "
        f"{steps_s:.3f} s for (share {wait_share:.3f}); checkpoints and "
        f"validation {loop['validation_s']:.3f} s; peak {peak:.0f} MiB; "
        f"launches {launches}, by dtype {dtypes}: per training step "
        f"{per_step}, and {val_launches} in the {n_val} validations of "
        f"{KITTI_PAIRS} pairs x {KITTI_ITERS} steps; {smi}")
    bf16_only = all(set(dtypes.get(k, {})) == {"bfloat16"} for k in
                    ("gru_gates", "gru_blend", "gru_gates_bwd",
                     "gru_blend_bwd"))
    fp32_volume = all(set(dtypes.get(k, {})) == {"float32"} for k in
                      ("corr_lookup", "corr_scatter"))
    if launches != want or not (bf16_only and fp32_volume):
        raise RuntimeError(f"training CLI launches {launches} {dtypes}, "
                           f"want {want}, K2/K4 in bf16, K1/K3 on fp32")
    log(f"[12] the KITTI validation in the log: {vals}")
    if len(vals) != n_val or not all(np.isfinite(r["kitti-epe"])
                                     for r in vals):
        raise RuntimeError("the validation metrics are not in the log")
    final = load_pth(os.path.join(ckpt_dir, "chip-cli.pth"), cfg_mk)
    bad = same_tree(final.state_dict(),
                    {k: v.cpu() for k, v in state.model.state_dict().items()})
    if bad:
        raise RuntimeError(f"the final .pth differs from the model at {bad}")
    log("[12] the final .pth loads with strict=True and equals the model")

    # full state: saved, restored bitwise, resumed
    stage_dir = os.path.join(ckpt_dir, "chip-cli", "chairs")
    tc = stage_config("chairs", mixed=True, num_steps=CLI_STEPS,
                      validation=())
    ckpt_lib.save_train_state(stage_dir, state)
    saved = full_state(state)
    fresh = create_train_state(RAFT(cfg_mk).cuda(), tc)
    ckpt_lib.restore_train_state(stage_dir, fresh)
    bad = same_tree(full_state(fresh), saved)
    log(f"[12] full state saved at step {state.step} and restored: "
        f"{'bitwise equal' if not bad else 'differs at ' + bad} (parameters,"
        f" batch-norm buffers, AdamW moments, schedule, step)")
    if bad:
        raise RuntimeError(f"the restored state differs at {bad}")
    del fresh
    kernels.reset_launch_counts()
    resumed = train_main(argv + ["--num_steps", str(CLI_RESUME_STEPS),
                                 "--resume"])
    torch.cuda.synchronize()
    resume_launches = kernels.launch_counts()
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = make_optimizer([p], tc.lr, CLI_STEPS)
    for _ in range(CLI_RESUME_STEPS):
        opt.step()
        sched.step()
    lr = resumed.scheduler.get_last_lr()[0]
    log(f"[12] --resume --num_steps {CLI_RESUME_STEPS}: step "
        f"{resumed.step}, schedule epoch {resumed.scheduler.last_epoch}, lr "
        f"{lr:.6e} (the first run's schedule at step {CLI_RESUME_STEPS}: "
        f"{sched.get_last_lr()[0]:.6e}); launches {resume_launches}")
    if not (resumed.step == CLI_RESUME_STEPS
            and resumed.scheduler.last_epoch == CLI_RESUME_STEPS
            and lr == sched.get_last_lr()[0]
            and resume_launches["corr_scatter"]
            == (CLI_RESUME_STEPS - CLI_STEPS) * TRAIN_ITERS):
        raise RuntimeError("the resumed run does not continue the state")
    del state, resumed

    # bf16 against fp32 at batch 8, in turns, from the same weights
    tc = stage_config("chairs", mixed=True, iters=TRAIN_ITERS, validation=())
    loader = synthetic_loader(CLI_PAIRS, tc,
                              os.path.join(tmp, "synthetic_chairs"))
    host = [b for _, b in zip(range(4), loader)]
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in host]
    weights = RAFT(cfg_mk, torch.Generator().manual_seed(1)).state_dict()
    runs = {}
    for name, c in (("bf16", cfg_mk), ("fp32", cfg_fk)):
        model = RAFT(c)
        model.load_state_dict(weights)
        st = create_train_state(model.cuda(), tc)
        runs[name] = [st, make_train_step(c, tc), [], 0.0]
        runs[name][1](st, batches[0])                       # warm-up
    for name in ("bf16", "fp32", "fp32", "bf16"):
        st, fn, ms, _ = runs[name]
        torch.cuda.reset_peak_memory_stats()
        ms += timed_steps(st, fn, batches[1:])
        runs[name][3] = max(runs[name][3],
                            torch.cuda.max_memory_allocated() / 2 ** 20)
    prof = {}
    for name, (st, fn, ms, pk) in runs.items():
        wall, busy, evs = prof[name] = profile_step(fn, st, batches[1])
        med = float(np.median(ms))
        log(f"[12] train step, basic model, batch {MIXED_B}, "
            f"{tc.image_size[0]}x{tc.image_size[1]}, iters={TRAIN_ITERS}, "
            f"pallas+fused, {name}: {med:.2f} ms per step (median of "
            f"{len(ms)}: {', '.join(f'{x:.2f}' for x in ms)}), "
            f"{MIXED_B / med * 1e3:.2f} pairs/s, peak {pk:.0f} MiB; one "
            f"step profiled: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
            f"idle share {1 - busy / wall:.3f}, FFT convolutions "
            f"{fft_conv_ms(evs):.2f} ms; {smi}; top device time:")
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:15]:
            log(f"[12]   {e.self_device_time_total / 1e3:9.3f} ms  "
                f"x{e.count:<5d} {e.key[:100]}")
    numbers = {name: {"ms_per_step": float(np.median(ms)),
                      "pairs_per_s": MIXED_B / float(np.median(ms)) * 1e3,
                      "peak_mib": pk, "idle_share": 1 - prof[name][1]
                      / prof[name][0], "fft_conv_ms": fft_conv_ms(
                          prof[name][2])}
               for name, (_, _, ms, pk) in runs.items()}
    del runs, batches, prof

    # one bf16 step, kernels against plain; remat against none
    torch.backends.cudnn.deterministic = True
    batch = {k: v.astype(np.float32) for k, v in host[0].items()}
    ulp = bf16_ulp_batch(batch)
    plain1 = step_grads(cfg_mp, weights, batch, 1)
    check_step("mixed precision, basic model, iters=1, kernels vs plain "
               "(both bf16)", plain1, step_grads(cfg_mk, weights, batch, 1),
               step_grads(cfg_mp, weights, ulp, 1), tag="12", bf16=True)
    # the witness phase 8 gates on, one fp32 ulp of input: logged only (in
    # bf16 it may flip no rounding at all)
    fp32_ulp = dict(batch, **{k: np.nextafter(batch[k], np.float32(np.inf))
                              for k in ("image1", "image2")})
    dl_f, worst_f, med_f, _, _ = step_gap(
        step_grads(cfg_mp, weights, fp32_ulp, 1), plain1)
    log(f"[12] plain bf16 path vs itself on frames moved by one fp32 ulp, "
        f"iters=1: loss gap {dl_f:.3e}, gradient gap largest {worst_f:.3e} "
        f"median {med_f:.3e} (not a gate)")
    plain12 = step_grads(cfg_mp, weights, batch, TRAIN_ITERS)
    _, ulp12, ulp12_med, _, _ = step_gap(
        step_grads(cfg_mp, weights, ulp, TRAIN_ITERS), plain12)
    base, base_peak, base_ms = grads_with_peak(cfg_mk, weights, batch,
                                               TRAIN_ITERS)
    cfg_remat = RAFTConfig(mixed_precision=True, corr_impl="pallas",
                           gru_impl="fused", remat=True)
    remat, remat_peak, remat_ms = grads_with_peak(cfg_remat, weights, batch,
                                                  TRAIN_ITERS)
    dl, worst, med, _, _ = step_gap(remat, base)
    log(f"[12] remat=True vs remat=False, bf16, pallas+fused, iters="
        f"{TRAIN_ITERS}: loss gap {dl:.3e}, gradient gap largest {worst:.3e} "
        f"median {med:.3e} (bound: one bf16 ulp of input in the plain path, "
        f"{ulp12:.3e} and {ulp12_med:.3e}); peak {remat_peak:.0f} MiB "
        f"against {base_peak:.0f}, step {remat_ms:.2f} ms against "
        f"{base_ms:.2f} (one step each, the model's set-up included); {smi}")
    torch.backends.cudnn.deterministic = False
    if not (worst <= ulp12 and med <= ulp12_med):
        raise RuntimeError("remat changes the gradients")
    numbers.update(remat={"peak_mib": remat_peak, "ms": remat_ms},
                   no_remat={"peak_mib": base_peak, "ms": base_ms},
                   loader_wait_share=wait_share, cli_peak_mib=peak)
    return {"launches": launches, "dtypes": dtypes, "numbers": numbers}


# ---------------------------------------------------------------------------
# phase 15: the supervised drill; phase 16: the measuring CLIs
# ---------------------------------------------------------------------------

# the drill's children: cuDNN deterministic and TF32 off, as in phases 8 and
# 12, set before the CLI runs (the CLI has no flag for them)
DRILL_SITE = """import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
"""
DRILL_HANG_S = 15
DRILL_TIMEOUT_S = 420
DRILL_PLAN = [{"site": "ckpt.orbax_save", "at": 2, "kind": "corrupt",
               "attempt": 0},
              {"site": "trainer.step", "at": 4, "kind": "hang",
               "attempt": 0}]
TRAIN_KERNELS = ("corr_lookup", "corr_scatter", "gru_gates", "gru_blend",
                 "gru_gates_bwd", "gru_blend_bwd")


def run_logged(cmd, env, cwd, tag: str):
    """``cmd`` in its own session, each output line logged with its arrival
    time: (exit code, [(seconds since the start, line)], wall seconds).
    Killed with every process it started after DRILL_TIMEOUT_S."""
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip()))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=DRILL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        rc = None
    reader.join(30)
    wall = time.perf_counter() - t0
    for t, line in lines:
        if any(k in line for k in ("[supervisor]", "[watchdog]", "[faults]",
                                   "resumed", "quarantined", "Error",
                                   "saved final", "loader:")):
            log(f"[{tag}]   +{t:6.2f} s  {line[:300]}")
    if rc != 0:
        for _, line in lines[-40:]:
            log(f"[{tag}]   | {line[:300]}")
        raise RuntimeError(f"{' '.join(cmd[3:8])} ... exited {rc}")
    return rc, lines, wall


def final_weights(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def weight_gap(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def supervised_drill_phase(tmp: str, smi: str) -> dict:
    """Phase 15: ``python -m raft_tpu_torch.cli.train --supervise`` on the
    card, the basic model at full width through K1-K4, with a plan that
    corrupts the second full-state save (step 3) and hangs the fourth step
    of attempt 0: the watchdog exits 3, the supervisor restarts with
    ``--resume``, the restore sandbox fails on step 3 (exit 4) and it is
    quarantined, the run resumes from step 1 and finishes; its final weights
    against an uninterrupted control run's."""
    site = os.path.join(tmp, "drill-site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(DRILL_SITE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (site, REPO, os.environ.get("PYTHONPATH")) if p))
    env.pop("RAFT_FAULT_PLAN", None)
    env.pop("RAFT_FAULT_PLAN_FILE", None)
    runs = os.path.join(tmp, "drill-runs")
    base = [sys.executable, "-m", "raft_tpu_torch.cli.train", "--stage",
            "chairs", "--corr_impl", "pallas", "--gru_impl", "fused",
            "--synthetic", "2", "--synthetic_dir",
            os.path.join(tmp, "drill-syn"), "--batch_size", "2",
            "--image_size", "368", "496", "--iters", str(TRAIN_ITERS),
            "--num_steps", "6", "--val_freq", "2", "--num_workers", "1",
            "--data_root", os.path.join(tmp, "drill-data"),
            "--log_dir", runs]

    def ctl(name):
        _, _, wall = run_logged(base + ["--name", name, "--checkpoint_dir",
                                        os.path.join(tmp, name)],
                                env, tmp, "15")
        return wall, final_weights(os.path.join(tmp, name, f"{name}.pth"))

    ctl_s, ctl_w = ctl("drill-ctl")
    log(f"[15] control: cli/train, basic model, batch 2, 368x496, iters "
        f"{TRAIN_ITERS}, fp32, pallas+fused, 6 steps, one loader worker, "
        f"cuDNN deterministic: {ctl_s:.2f} s")
    sup_env = dict(env, RAFT_FAULT_PLAN=json.dumps(DRILL_PLAN))
    sup_dir = os.path.join(tmp, "drill-sup")
    _, lines, sup_s = run_logged(
        base + ["--name", "drill-sup", "--checkpoint_dir", sup_dir,
                "--supervise", "--max_restarts", "3",
                "--hang_s", str(DRILL_HANG_S)], sup_env, tmp, "15")
    text = "\n".join(line for _, line in lines)
    stage = os.path.join(sup_dir, "drill-sup", "chairs")
    left = sorted(os.listdir(stage))
    events = [json.loads(line) for line in open(
        os.path.join(runs, "drill-sup", "metrics.jsonl"))]
    restarts = [e for e in events if e.get("event") == "supervisor_restart"]
    ends = [e for e in events if "train_loop_s" in e]

    def first(pattern, after=0.0):
        return next((t for t, line in lines
                     if pattern in line and t >= after), None)

    t_fire = first("[watchdog] train loop")
    t_wedge = first("child wedged (exit 3")
    t_restored = first("resumed from step", after=t_wedge or 0.0)
    resumed_at = [int(line.split()[-1]) for t, line in lines
                  if line.startswith("resumed from step")
                  and t >= (t_wedge or 0.0)]
    ok = (restarts and restarts[0]["exit_class"] == "wedge"
          and t_fire is not None and t_wedge is not None
          and t_restored is not None and resumed_at and "(exit 4)" in text
          and "3.corrupt" in left
          and "resumed from fallback step 1 (skipped corrupt step(s) [3])"
          in text and ends)
    if not ok:
        raise RuntimeError(f"the supervised drill did not recover as "
                           f"planned: {left} {restarts}")
    launches = {k: int(ends[-1][f"launches_{k}"]) for k in TRAIN_KERNELS}
    if not all(launches.values()):
        raise RuntimeError(f"the recovered run launched {launches}")
    sup_w = final_weights(os.path.join(sup_dir, "drill-sup.pth"))
    bitwise = all(torch.equal(ctl_w[k], sup_w[k]) for k in ctl_w)
    out = {"restarts": len(restarts), "hang_s": DRILL_HANG_S,
           "control_s": ctl_s, "supervised_s": sup_s,
           "lost_s": sup_s - ctl_s, "fire_s": t_fire,
           "recover_s": t_restored - t_wedge,
           "resume_gap_steps": restarts[0]["restored_step"] - resumed_at[0],
           "bitwise": bitwise, "launches_recovered_run": launches,
           "stage_dir": left}
    if not bitwise:
        # is the gap the resume's, or the card's from one run to the next?
        _, ctl2_w = ctl("drill-ctl2")
        out["weight_gap"] = weight_gap(sup_w, ctl_w)
        out["control_gap"] = weight_gap(ctl2_w, ctl_w)
        log(f"[15] final weights: supervised vs control max |gap| "
            f"{out['weight_gap']:.3e}; control vs a second control "
            f"{out['control_gap']:.3e}")
        if out["control_gap"] == 0 or out["weight_gap"] > 10 * out[
                "control_gap"]:
            raise RuntimeError("the supervised run's weights differ from "
                               "the uninterrupted run's")
    log(f"[15] cli/train --supervise --hang_s {DRILL_HANG_S}: exit 0 after "
        f"{len(restarts)} restart(s) ({restarts[0]['exit_class']}, resume "
        f"point step {restarts[0]['restored_step']}); the watchdog fired at "
        f"+{t_fire:.2f} s, the supervisor saw exit 3 at +{t_wedge:.2f} s and "
        f"the restarted child had restored its state {out['recover_s']:.2f} s "
        f"later (backoff, start, the sandbox's two reads); step 3 "
        f"quarantined by the sandbox (exit 4), resumed from step "
        f"{resumed_at[0]}: "
        f"{out['resume_gap_steps']} steps redone; {sup_s:.2f} s against the "
        f"control's {ctl_s:.2f} s; the stage dir {left}; the recovered run's "
        f"launches {launches}; final weights "
        f"{'bitwise equal to the control run' if bitwise else 'within the run-to-run gap'}; "
        f"{smi}")
    return out


def measuring_clis_phase(tmp: str, smi: str) -> dict:
    """Phase 16: each measuring CLI once on the card, in this process, the
    launch counts set to 0 before each and read after: ``envelope``,
    ``infer_bench`` at 440x1024 (materialized and alternate),
    ``corr_bench`` over the four routes and the yardstick with ``--grad``,
    ``profile_step --trace-dir`` and ``trace_summary`` on its trace, and
    ``loader_bench`` against the profiled step's pairs/s."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.cli import (corr_bench, envelope, infer_bench,
                                    loader_bench, profile_step,
                                    trace_summary)

    launches = {}

    def run(name, fn, argv, want=(), key=None):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        launches[key or name] = counts
        log(f"[16] {name} {' '.join(argv)}: {time.perf_counter() - t0:.2f} "
            f"s, launches {counts}")
        if not all(counts.get(k) for k in want):
            raise RuntimeError(f"{name} launched {counts}, want {want}")
        return out, counts

    env, _ = run("envelope", envelope.main,
                 ["--n", "8192", "--copy-mib", "2048", "--reps", "10"])
    log(f"[16] envelope: matmul {env['matmul_tflops']} TFLOP/s, copy "
        f"{env['copy_gbps']:.1f} GB/s, launch {env['launch_us']:.2f} us back "
        f"to back, {env['launch_sync_us']:.2f} us with a synchronise; {smi}")
    infer = {}
    for name, extra, want in (
            ("materialized", [], ("corr_lookup", "gru_gates", "gru_blend")),
            ("alternate", ["--alternate_corr"], ("corr_alt", "gru_gates"))):
        infer[name], _ = run(
            "infer_bench", infer_bench.main,
            ["--hw", "440", "1024", "--reps", "5", "--corr_impl", "pallas",
             "--gru_impl", "fused", *extra], want, f"infer_bench_{name}")
        lpf = infer[name]["launches_per_forward"]
        if lpf.get("corr_alt" if extra else "corr_lookup") != ITERS:
            raise RuntimeError(f"infer_bench {name}: {lpf}")
    (rows, failed), _ = run(
        "corr_bench", corr_bench.main,
        ["--grad", "--iters", "10", "--impls", "gather", "pallas", "alt",
         "alt_pallas", "grid_sample"],
        ("corr_lookup", "corr_scatter", "corr_alt"))
    bad = {n: r["max_abs_diff"] for n, r in rows.items()
           if not (r["max_abs_diff"] <= CORR_BENCH_TOL
                   and r.get("primal_rel_diff", 0.0) <= CORR_BENCH_TOL)}
    if failed or bad or len(rows) != 5:
        raise RuntimeError(f"corr_bench: failed {failed}, beyond "
                           f"{CORR_BENCH_TOL:g}: {bad}")
    trace_dir = os.path.join(tmp, "profile-step")
    prof, _ = run("profile_step", profile_step.main,
                  ["--batch", str(MIXED_B), "--steps", "3", "--warmup", "2",
                   "--corr_impl", "pallas", "--gru_impl", "fused",
                   "--trace-dir", trace_dir], TRAIN_KERNELS)
    summary, _ = run("trace_summary", trace_summary.main, [trace_dir])
    cats = summary["categories"]
    if not all(k in cats for k in ("K1 corr_lookup", "K3 corr_scatter",
                                   "K2 gru_gates", "K4 gru_blend_bwd")):
        raise RuntimeError(f"trace_summary found no port kernels: {cats}")
    loader, _ = run("loader_bench", loader_bench.main,
                    ["--samples", "16", "--batch", str(MIXED_B), "--epochs",
                     "1", "--step-pairs-per-sec",
                     f"{prof['pairs_per_s']:.2f}"])
    log(f"[16] infer_bench 440x1024 basic iters={ITERS}: "
        f"{infer['materialized']['ms_per_pair']:.2f} ms/pair materialized, "
        f"{infer['alternate']['ms_per_pair']:.2f} alternate; corr_bench "
        f"--grad ms: { {n: round(r['ms'], 4) for n, r in rows.items()} }; "
        f"profile_step bf16 batch {MIXED_B}: {prof['ms_per_step']:.2f} ms, "
        f"idle {prof['idle_share']:.3f}, peak {prof['peak_mib']:.0f} MiB; "
        f"trace_summary: {summary['events']} device events, "
        f"{ {c: round(v['share'], 3) for c, v in cats.items()} }; "
        f"loader_bench {loader['pairs_per_s']:.2f} pairs/s, "
        f"{loader['ratio']:.2f}x the step; {smi}")
    return {"launches": launches, "envelope": env, "infer_bench": infer,
            "corr_bench": rows,
            "profile_step": prof, "trace_summary": {
                c: v["share"] for c, v in cats.items()},
            "loader_bench": loader}


# ---------------------------------------------------------------------------
# phase 17: the serving engine
# ---------------------------------------------------------------------------

SERVE_ENVELOPE = [(1, 440, 1024), (4, 440, 1024)]
SERVE_CLASS = (4, 440, 1024)
SERVE_TOL = 1e-5                # px, a replay against eager on its inputs
RAGGED_SHAPES = [(436, 1024), (368, 496), (256, 256), (320, 640)]
SWAP_DISPATCHES = 20
SERVE_KERNELS = {"corr_lookup": "corr_lookup_kernel",
                 "gru_gates": "gru_gates_kernel",
                 "gru_blend": "gru_blend_kernel"}
EXPORT_CHILD = """import json, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False      # fp32, as the parent's eager
torch.backends.cuda.matmul.allow_tf32 = False
import raft_tpu_torch.kernels
from raft_tpu_torch.serving.export import load_program
from torch.profiler import ProfilerActivity, profile
program = load_program(sys.argv[1])
x = np.load(sys.argv[2])
out, ms = {}, {}
for b in (1, 2):
    i1 = torch.from_numpy(x["i1"][:b]).cuda()
    i2 = torch.from_numpy(x["i2"][:b]).cuda()
    program(i1, i2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out[f"b{b}"] = program(i1, i2).cpu().numpy()
    ms[b] = (time.perf_counter() - t0) * 1e3
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    program(torch.from_numpy(x["i1"][:1]).cuda(),
            torch.from_numpy(x["i2"][:1]).cuda())
    torch.cuda.synchronize()
names = [e.name for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA]
np.savez(sys.argv[3], **out)
print(json.dumps({"ms": ms, "k1_events": sum("corr_lookup_kernel" in n
                                             for n in names),
                  "k1_names": sorted({n for n in names
                                      if "corr_lookup" in n})}))
"""


def bucket_u8(frames1, frames2, bucket):
    """The uint8 bucket inputs a u8-wire engine builds from (b, h, w, 3)
    frames: cast, edge-padded to ÷8, zero-filled to ``bucket``."""
    from raft_tpu_torch.ops.padding import pad_amounts

    out = []
    for f in (frames1, frames2):
        f = np.asarray(f).astype(np.uint8)
        b, h, w, _ = f.shape
        left, right, top, bottom = pad_amounts(h, w)
        bb, bh, bw = bucket
        f = np.pad(f, ((0, 0), (top, bottom), (left, right), (0, 0)),
                   mode="edge")
        f = np.pad(f, ((0, bb - b), (0, bh - f.shape[1]),
                       (0, bw - f.shape[2]), (0, 0)))
        out.append(torch.from_numpy(f).cuda())
    return out


def ragged_box(pairs, bucket):
    """The uint8 capacity box and extents a u8-wire ragged engine builds."""
    from raft_tpu_torch.ops.padding import pad_amounts

    bb, bh, bw = bucket
    boxes = [np.zeros((bb, bh, bw, 3), np.uint8) for _ in range(2)]
    vh = np.zeros(bb, np.int32)
    vw = np.zeros(bb, np.int32)
    crops = []
    for i, pair in enumerate(pairs):
        h, w = pair[0].shape[:2]
        left, right, top, bottom = pad_amounts(h, w)
        for box, f in zip(boxes, pair):
            box[i, :h + top + bottom, :w + left + right] = np.pad(
                f.astype(np.uint8), ((top, bottom), (left, right), (0, 0)),
                mode="edge")
        vh[i], vw[i] = (h + top + bottom) // 8, (w + left + right) // 8
        crops.append((top, left, h, w))
    return ([torch.from_numpy(b).cuda() for b in boxes]
            + [torch.from_numpy(v).cuda() for v in (vh, vw)], crops)


def events_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events around ``reps``
    calls after one warm-up (host gaps between launches included)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` (which ends in a host read)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profiled_replay(fn, per_call: dict, tag: str):
    """One call of ``fn`` under the profiler: (wall ms, busy ms, each
    serving kernel's device launches). A session can lose device events
    (``kernel_ms``), so up to four sessions are taken, until one holds
    exactly ``per_call`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {k: sum(sub in n for n in names)
                  for k, sub in SERVE_KERNELS.items()}
        if counts == per_call:
            return wall, device_busy_ms(prof), counts, prof
        log(f"[17] {tag}: profiler session {attempt + 1} of 4 recorded "
            f"{counts}, want {per_call}")
    raise RuntimeError(f"{tag}: the profiler never recorded {per_call}")


def serving_phase(smi: str) -> dict:
    """Phase 17: the serving engine on the card (``serving.engine``,
    ``serving.export``, ``cli/parity``); see the module docstring."""
    import contextlib
    import io
    import threading

    from raft_tpu_torch import kernels
    from raft_tpu_torch.cli.parity import main as parity_main
    from raft_tpu_torch.config import ITERS_EXPORT, RAFTConfig
    from raft_tpu_torch.data.png import read_png
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine
    from raft_tpu_torch.serving.export import (export_program,
                                               make_serving_fn)
    from raft_tpu_torch.tools.convert import load_pth

    iters = ITERS_EXPORT
    per_replay = {"corr_lookup": iters, "gru_gates": 2 * iters,
                  "gru_blend": 2 * iters}
    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    weights_a = RAFT(cfg, torch.Generator().manual_seed(0)).state_dict()
    weights_b = RAFT(cfg, torch.Generator().manual_seed(1)).state_dict()
    out = {}

    # -- engine A: two buckets and one ragged class captured, timed ----------
    # Convolutions in TF32 (PyTorch's default), cuDNN deterministic: in fp32
    # cuDNN takes FFT convolutions at the encoders' batch of 8 (see the fp32
    # forward at batch 4 below); the matmuls, the correlation among them,
    # stay fp32. Engine A0 below serves batch 1 in fp32, as section 5 ran.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    eng = RAFTEngine(weights_a, cfg, iters=iters, envelope=SERVE_ENVELOPE,
                     precompile=False, wire="u8", warm_start=True,
                     ragged=True, capacity_classes=[SERVE_CLASS])
    weights_mib = sum(t.numel() * t.element_size()
                      for t in eng.model.state_dict().values()) / 2 ** 20
    capture_s = {}
    for b, h, w in SERVE_ENVELOPE:
        t0 = time.perf_counter()
        eng.ensure_bucket(b, h, w)
        capture_s[f"{b}x{h}x{w}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.ensure_ragged(*SERVE_CLASS)
    capture_s["ragged_" + "x".join(map(str, SERVE_CLASS))] = (
        time.perf_counter() - t0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    captures = eng.capture_count
    split = {f"{k[0]} {'x'.join(map(str, k[1]))}": {
        n: round(v, 3) for n, v in d.items()}
        for k, d in eng.capture_seconds.items()}
    log(f"[17] engine A (basic, seeded weights, pallas+fused, iters={iters}, "
        f"u8 wire, warm start; TF32 convolutions, cuDNN deterministic): "
        f"captured {captures} graphs, seconds each "
        f"{ {k: round(v, 3) for k, v in capture_s.items()} } (the eager "
        f"warm-up and the capture: {split}); peak max_memory_allocated "
        f"{peak:.0f} MiB with 2 buckets and 1 ragged class in one pool "
        f"(weights {weights_mib:.0f} MiB); launch counts during the captures "
        f"{kernels.launch_counts()} (warm-up and capture, one forward each); "
        f"{smi}")
    out.update(capture_s=capture_s, capture_split=split, peak_mib=peak,
               weights_mib=weights_mib)

    # -- replays against eager, bitwise --------------------------------------
    frames = synthetic_frames(0, PAIRS + 1)
    zero_init = {b: torch.zeros((b, 55, 128, 2), device="cuda")
                 for b in (1, 4)}

    def eager(b, f1, f2):
        i1, i2 = bucket_u8(f1, f2, (b, 440, 1024))
        with torch.no_grad():
            return eng.model(i1, i2, iters=iters, flow_init=zero_init[b])[1]

    gap = 0.0
    kernels.reset_launch_counts()
    eng_replays = dict(eng.replayed_launches())
    for i in range(PAIRS):
        got = eng.infer_batch(frames[i][None], frames[i + 1][None])
        want = eager(1, frames[i][None], frames[i + 1][None])
        gap = max(gap, float(np.abs(got - want[:, 2:438].cpu().numpy()).max()))
    f1, f2 = np.stack(frames[:PAIRS]), np.stack(frames[1:])
    got4 = eng.infer_batch(f1, f2)
    gap4 = float(np.abs(got4 - eager(4, f1, f2)[:, 2:438].cpu().numpy()).max())
    log(f"[17] the {PAIRS} 436x1024 pairs of phase 5 served singly (bucket "
        f"1x440x1024) and {PAIRS} at a time (4x440x1024): each replay "
        f"against the eager RAFT.forward of the same padded u8 bucket inputs: "
        f"largest gap {gap:.3e} px singly, {gap4:.3e} px at batch 4 (fail "
        f"above {SERVE_TOL:g})")
    if not (gap <= SERVE_TOL and gap4 <= SERVE_TOL):
        raise RuntimeError("a bucket replay disagrees with eager")
    out.update(replay_gap_px=gap, replay_gap_b4_px=gap4)

    # -- time: host clock request to flow, CUDA events replay against eager --
    single = functools.partial(eng.infer_batch, frames[0][None],
                               frames[1][None])
    b1_eager = functools.partial(eager, 1, frames[0][None], frames[1][None])

    def eager_host(b, f1, f2):
        return eager(b, f1, f2)[:, 2:438].cpu().numpy()

    prog1 = eng._programs[(1, 440, 1024)]
    prog4 = eng._programs[(4, 440, 1024)]
    t = {"replay_host_b1": host_ms(single, 5),
         "eager_host_b1": host_ms(functools.partial(
             eager_host, 1, frames[0][None], frames[1][None]), 5),
         "replay_host_b4": host_ms(functools.partial(eng.infer_batch, f1, f2),
                                   3) / PAIRS,
         "eager_host_b4": host_ms(functools.partial(eager_host, 4, f1, f2),
                                  3) / PAIRS,
         "replay_events_b1": events_ms(prog1.graph.replay, 5),
         "eager_events_b1": events_ms(b1_eager, 5),
         "replay_events_b4": events_ms(prog4.graph.replay, 3) / PAIRS,
         "eager_events_b4": events_ms(functools.partial(eager, 4, f1, f2),
                                      3) / PAIRS}
    log(f"[17] ms a pair, basic model 440x1024 iters={iters}: batch 1 replay "
        f"{t['replay_host_b1']:.2f} (host clock, request to fetched flow) / "
        f"{t['replay_events_b1']:.2f} (CUDA events, graph replay alone), eager "
        f"{t['eager_host_b1']:.2f} / {t['eager_events_b1']:.2f}; batch 4 "
        f"replay {t['replay_host_b4']:.2f} / {t['replay_events_b4']:.2f}, "
        f"eager {t['eager_host_b4']:.2f} / {t['eager_events_b4']:.2f}; {smi}")
    wall, busy, counts, prof = profiled_replay(single, per_replay,
                                               "batch-1 replay")
    evs = device_events(prof)
    log(f"[17] one batch-1 dispatch under the profiler: wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f} (eager, "
        f"PERF.md section 5: busy 53.06 of 100.07 ms, idle 0.470); device "
        f"launches by kernel name {counts} (per replay, want {per_replay}); "
        f"top device time:")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[17]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")
    _, _, counts4, _ = profiled_replay(
        functools.partial(eng.infer_batch, f1, f2), per_replay,
        "batch-4 replay")
    t.update(profiled_wall_ms=wall, profiled_busy_ms=busy,
             idle_share=1 - busy / wall)
    out.update(times=t, launches_per_replay=counts)

    # -- ragged: one replay of the class carries four shapes ----------------
    caps = eng.capture_count
    ragged_frames = [(frames[i][:h, :w], frames[i + 1][:h, :w])
                     for i, (h, w) in enumerate(RAGGED_SHAPES)]
    rows = eng.infer_ragged(ragged_frames)
    box, crops = ragged_box(ragged_frames, SERVE_CLASS)
    with torch.no_grad():
        _, up = eng.model.forward_ragged(
            *box, torch.zeros((4, 55, 128, 2), device="cuda"), iters=iters)
    up = up.cpu().numpy()
    rgap = max(float(np.abs(r - up[i, top:top + h, left:left + w]).max())
               for i, (r, (top, left, h, w)) in enumerate(zip(rows, crops)))
    shapes_ok = [r.shape[:2] for r in rows] == RAGGED_SHAPES
    log(f"[17] ragged class {SERVE_CLASS}: one replay carried "
        f"{RAGGED_SHAPES}; flows {[r.shape for r in rows]}; captures "
        f"{caps} -> {eng.capture_count}, ragged table {eng.ragged_classes()}; "
        f"against the eager forward_ragged on the same box: {rgap:.3e} px "
        f"(fail above {SERVE_TOL:g})")
    if not (shapes_ok and eng.capture_count == caps and rgap <= SERVE_TOL):
        raise RuntimeError("the ragged class disagrees or captured again")
    t_ragged = events_ms(eng._programs_ragged[SERVE_CLASS].graph.replay, 3)
    log(f"[17] ragged class replay {t_ragged:.2f} ms (CUDA events) against "
        f"the batch-4 bucket's {t['replay_events_b4'] * PAIRS:.2f} ms")
    out.update(ragged_gap_px=rgap, ragged_replay_ms=t_ragged)

    # -- hot swap: dispatches against weight swaps, two threads --------------
    want = {"a": single()}
    eng.update_weights(weights_b)
    want["b"] = single()
    eng.update_weights(weights_a)
    if np.array_equal(want["a"], want["b"]):
        raise RuntimeError("the two weight sets give one flow")
    caps = eng.capture_count
    outs, errors, done = [], [], threading.Event()

    def dispatch():
        try:
            for _ in range(SWAP_DISPATCHES):
                outs.append(single())
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            done.set()

    swaps = 0

    def swap():
        nonlocal swaps
        while not done.is_set():
            eng.update_weights(weights_b if swaps % 2 == 0 else weights_a)
            swaps += 1

    threads = [threading.Thread(target=dispatch),
               threading.Thread(target=swap)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    swap_s = time.perf_counter() - t0
    which = [next((k for k, w in want.items() if np.array_equal(o, w)), None)
             for o in outs]
    log(f"[17] hot swap: {len(outs)} dispatches against {swaps} weight swaps "
        f"in {swap_s:.2f} s; outputs of set a {which.count('a')}, set b "
        f"{which.count('b')}, neither {which.count(None)}; captures {caps} -> "
        f"{eng.capture_count}")
    if (errors or any(th.is_alive() for th in threads)
            or len(outs) != SWAP_DISPATCHES or None in which
            or eng.capture_count != caps):
        raise RuntimeError(f"hot swap mixed weights or failed: {errors}")
    out.update(swap={"dispatches": len(outs), "swaps": swaps,
                     "a": which.count("a"), "b": which.count("b")})
    eng_replays = {k: v - eng_replays.get(k, 0)
                   for k, v in eng.replayed_launches().items()}
    out["launches_serving"] = eng_replays
    del eng
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = False

    # -- engine A0: batch 1 in fp32, beside section 5's eager pair ----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = RAFTEngine(weights_a, cfg, iters=iters, envelope=[(1, 440, 1024)],
                     wire="u8", warm_start=True)
    peak0 = torch.cuda.max_memory_allocated() / 2 ** 20
    cap0 = eng.capture_seconds[("plain", (1, 440, 1024))]
    single = functools.partial(eng.infer_batch, frames[0][None],
                               frames[1][None])
    gap0 = float(np.abs(single() - eager(1, frames[0][None], frames[1][None])
                        [:, 2:438].cpu().numpy()).max())
    a0 = {"replay_host_b1": host_ms(single, 5),
          "eager_host_b1": host_ms(functools.partial(
              eager_host, 1, frames[0][None], frames[1][None]), 5),
          "replay_events_b1": events_ms(
              eng._programs[(1, 440, 1024)].graph.replay, 5),
          "eager_events_b1": events_ms(functools.partial(
              eager, 1, frames[0][None], frames[1][None]), 5)}
    wall0, busy0, _, _ = profiled_replay(single, per_replay,
                                         "fp32 batch-1 replay")
    a0.update(profiled_wall_ms=wall0, profiled_busy_ms=busy0,
              idle_share=1 - busy0 / wall0)
    log(f"[17] engine A0, fp32 (TF32 off), bucket 1x440x1024: capture "
        f"{cap0['warmup']:.3f} s warm-up + {cap0['capture']:.3f} s capture, "
        f"peak {peak0:.0f} MiB; replay against eager {gap0:.3e} px (fail "
        f"above {SERVE_TOL:g}); ms a pair replay {a0['replay_host_b1']:.2f} "
        f"(host clock) / {a0['replay_events_b1']:.2f} (CUDA events), eager "
        f"{a0['eager_host_b1']:.2f} / {a0['eager_events_b1']:.2f}; one "
        f"profiled dispatch: wall {wall0:.2f} ms, busy {busy0:.2f} ms, idle "
        f"share {1 - busy0 / wall0:.3f} (eager, section 5: 53.06 of 100.07 "
        f"ms, 0.470); {smi}")
    if not gap0 <= SERVE_TOL:
        raise RuntimeError("the fp32 replay disagrees with eager")
    del eng
    # one eager forward at batch 4 in fp32: what engine A's TF32 avoids
    i1, i2 = bucket_u8(f1, f2, (4, 440, 1024))
    model_a = RAFT(cfg)
    model_a.load_state_dict(weights_a)
    model_a = model_a.cuda().eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    with torch.no_grad():
        model_a(i1, i2, iters=iters, flow_init=zero_init[4])
    torch.cuda.synchronize()
    fp32_b4 = time.perf_counter() - tb
    peak4 = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[17] one eager forward at batch 4 in fp32 (TF32 off; cuDNN takes "
        f"FFT convolutions at the encoders' batch of 8): {fp32_b4:.2f} s, "
        f"peak {peak4:.0f} MiB, against engine A's "
        f"{t['replay_events_b4'] * PAIRS:.2f} ms replay in TF32; {smi}")
    a0.update(fp32_b4_eager_s=fp32_b4, fp32_b4_peak_mib=peak4,
              capture=cap0, peak_mib=peak0, gap_px=gap0)
    out["fp32_b1"] = a0
    del model_a, i1, i2

    # -- cached: engine B (small fixture, feature cache) against its twin ---
    fixture = os.path.join(REPO, "tests", "fixtures",
                           "raft-small-cputrained.pth")
    cfg_s = RAFTConfig(small=True, corr_impl="pallas")
    small = load_pth(fixture, cfg_s)
    demo = [read_png(f) for f in
            sorted(glob.glob(os.path.join(REPO, "demo-frames", "*.png")))]
    cached = RAFTEngine(small, cfg_s, iters=iters, envelope=[(1, 440, 1024)],
                        wire="u8", warm_start=True, feature_cache=True)
    twin = RAFTEngine(small, cfg_s, iters=iters, envelope=[(1, 440, 1024)],
                      wire="u8", warm_start=True)
    _, _, fmap, cnet = cached.infer_cached(demo[0][None], [None])
    init = None
    cgap, h2d_c, h2d_p, ms_c, ms_p = 0.0, [], [], [], []
    for prev, frame in zip(demo[:-1], demo[1:]):
        slot = (fmap[0], cnet[0], None if init is None else init[0])
        t0 = time.perf_counter()
        pending = cached.infer_cached_async(frame[None], [slot])
        flow_c, low_c, fmap, cnet = pending.fetch()
        ms_c.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        plain = twin.infer_batch_async(prev[None], frame[None],
                                       flow_init=init)
        flow_p = plain.fetch()
        ms_p.append((time.perf_counter() - t0) * 1e3)
        h2d_c.append(pending.h2d_bytes)
        h2d_p.append(plain.h2d_bytes)
        cgap = max(cgap, float(np.abs(flow_c - flow_p).max()))
        init = low_c
    ev_c = events_ms(cached._programs_cached[(1, 440, 1024)].graph.replay, 5)
    ev_p = events_ms(twin._programs[(1, 440, 1024)].graph.replay, 5)
    log(f"[17] cached: engine B (small fixture, feature cache) over "
        f"demo-frames, prime then {len(ms_c)} warm pairs, each against the "
        f"plain twin engine with the same flow_init: largest gap {cgap:.3e} "
        f"px (tol {SMALL_TOL:g}); H2D a warm pair {h2d_c[-1]} B against "
        f"{h2d_p[-1]} B; ms a pair (host clock) cached {np.median(ms_c):.2f} "
        f"against {np.median(ms_p):.2f}; replay alone (CUDA events) {ev_c:.2f} "
        f"against {ev_p:.2f} ms: the encoder saving {1 - ev_c / ev_p:.1%}; "
        f"{smi}")
    if not cgap <= SMALL_TOL:
        raise RuntimeError("the cached pair disagrees with the plain pair")
    out.update(cached={"gap_px": cgap, "h2d_bytes": h2d_c[-1],
                       "h2d_bytes_plain": h2d_p[-1],
                       "ms": float(np.median(ms_c)),
                       "ms_plain": float(np.median(ms_p)),
                       "replay_ms": ev_c, "replay_ms_plain": ev_p})
    del cached, twin

    # -- export: the small fixture's .pt2, loaded in a fresh process --------
    small = small.cuda().eval()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        program = export_program(small, cfg_s, iters, (440, 1024))
        path = os.path.join(tmp, "small.pt2")
        torch.export.save(program, path)
        export_s = time.perf_counter() - t0
        pad = ((0, 0), (2, 2), (0, 0), (0, 0))
        i1 = np.pad(np.stack(demo[0:2]), pad, mode="edge").astype(np.float32)
        i2 = np.pad(np.stack(demo[1:3]), pad, mode="edge").astype(np.float32)
        np.savez(os.path.join(tmp, "in.npz"), i1=i1, i2=i2)
        r = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, path,
             os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise RuntimeError(f"the export's child failed:\n{r.stdout}\n"
                               f"{r.stderr[-4000:]}")
        child = json.loads(r.stdout.strip().splitlines()[-1])
        got = np.load(os.path.join(tmp, "out.npz"))
        serve = make_serving_fn(small, cfg_s, iters)
        egap = {}
        for b in (1, 2):
            with torch.no_grad():
                want_b = serve(torch.from_numpy(i1[:b]).cuda(),
                               torch.from_numpy(i2[:b]).cuda()).cpu().numpy()
            egap[b] = float(np.abs(got[f"b{b}"] - want_b).max())
        eager_ms = host_ms(lambda: serve(torch.from_numpy(i1[:1]).cuda(),
                                         torch.from_numpy(i2[:1]).cuda())
                           .cpu(), 3)
    log(f"[17] export: export_program of the small fixture at 440x1024, "
        f"dynamic batch, saved, in {export_s:.2f} s; loaded in a fresh "
        f"process: batch 1 gap {egap[1]:.3e} px, batch 2 {egap[2]:.3e} px "
        f"against eager (fail above {SERVE_TOL:g}); ms batch 1 {child['ms']}, "
        f"eager {eager_ms:.2f}; K1 device events in its profiled run "
        f"{child['k1_events']} ({child['k1_names']})")
    if not (max(egap.values()) <= SERVE_TOL and child["k1_events"] > 0):
        raise RuntimeError("the loaded program disagrees or launched no K1")
    out.update(export={"seconds": export_s, "gap_px": egap,
                       "ms": child["ms"], "eager_ms": eager_ms,
                       "k1_events": child["k1_events"]})

    # -- the parity CLI over demo-frames -------------------------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        parity_main(["--model", fixture, "--small", "--path",
                     os.path.join(REPO, "demo-frames"), "--corr_impl",
                     "pallas"])
    par = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[17] python -m raft_tpu_torch.cli.parity --small --path "
        f"demo-frames: {par['pairs']} pairs, largest difference "
        f"{par['max_diff_px']:.3e} px (tol {SMALL_TOL:g}); ms a pair "
        f"(median of pairs 2-{par['pairs']}) plain {par['ms_plain_median']:.2f}, "
        f"engine {par['ms_engine_median']:.2f}; captures {par['captures']}; "
        f"{smi}")
    if not par["max_diff_px"] <= SMALL_TOL:
        raise RuntimeError("cli/parity: the engine disagrees with plain")
    out["parity"] = {k: par[k] for k in ("pairs", "max_diff_px",
                                         "ms_plain_median",
                                         "ms_engine_median")}
    return out


def envelope_bound_ms(t: dict, env: dict, tf32: bool = False) -> tuple:
    """A kernel's bound at the measured envelope: the larger of its bytes at
    the measured copy rate and its operations at the measured matmul peak
    (fp32 with TF32 off; TF32 for K5's split products)."""
    t_bytes = t["nbytes"] / (env["copy_gbps"] * 1e9) * 1e3
    rate = env["matmul_tflops"]["tf32" if tf32 else "fp32"] * 1e12
    t_ops = t["ops"] / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")



# ---------------------------------------------------------------------------
# phase 18: the serving front end
# ---------------------------------------------------------------------------

FRONT_SHAPES = [(440, 1024), (368, 496)]   # the drill's cvt2trt-ish pair
FRONT_BUCKET_B = 4
FRONT_REQUESTS = 48
FRONT_SUBMITTERS = 2
FRONT_SESSIONS = 2
FRONT_SESSION_FRAMES = 8
FRONT_PROFILED_REQUESTS = 16
MIXED_CROPS = [(436, 1024), (368, 496), (256, 320)]   # of demo-frames
CHAOS_SHAPES = [(256, 320), (192, 256)]


def demo_frames():
    """``demo-frames/``: ten 436x1024 frames of one Sintel scene."""
    from raft_tpu_torch.data.png import read_png

    return [read_png(f) for f in
            sorted(glob.glob(os.path.join(REPO, "demo-frames", "*.png")))]


def front_drill(engine, weights, cfg, depth: int, **kw):
    """``cli/serve_bench.run_drill`` at full width on ``engine``: the
    drill's seeded traffic (FRONT_REQUESTS pairs from FRONT_SUBMITTERS
    threads and FRONT_SESSIONS warm-start video sessions), u8 wire, one
    pipeline depth. Returns the summary and each kernel's replayed
    launches during the drill."""
    from raft_tpu_torch.cli import serve_bench

    kw.setdefault("requests", FRONT_REQUESTS)
    kw.setdefault("sessions", FRONT_SESSIONS)
    before = dict(engine.replayed_launches())
    summary = serve_bench.run_drill(
        weights, cfg, shapes=FRONT_SHAPES, submitters=FRONT_SUBMITTERS,
        bucket_batch=FRONT_BUCKET_B, iters=ITERS,
        session_frames=FRONT_SESSION_FRAMES, wire="u8",
        pipeline_depth=depth, seed=18, engine=engine, **kw)
    after = engine.replayed_launches()
    return summary, {k: after[k] - before.get(k, 0) for k in after}


def serving_frontend_phase(smi: str) -> dict:
    """Phase 18: the serving front end on the card (``serving.scheduler``,
    ``serving.session``, the feature-cache pool, the resilience layer,
    tracing, ``cli/serve_bench`` and ``cli/serve_trace``); see the module
    docstring."""
    import contextlib
    import io
    import threading

    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.cli import serve_bench, serve_trace
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.ops.interp import forward_interpolate_device
    from raft_tpu_torch.serving import (MicroBatchScheduler, RAFTEngine,
                                        VideoSession)
    from raft_tpu_torch.serving.schema import validate_lines
    from raft_tpu_torch.tools.convert import load_pth

    per_replay = {"corr_lookup": ITERS, "gru_gates": 2 * ITERS,
                  "gru_blend": 2 * ITERS}
    out = {}
    # as engine A of phase 17: TF32 convolutions, cuDNN deterministic
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True

    # -- 1. full width, timed, depth 1 against depth 2 -----------------------
    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    weights = RAFT(cfg, torch.Generator().manual_seed(0)).state_dict()
    t0 = time.perf_counter()
    eng = RAFTEngine(weights, cfg, iters=ITERS, envelope=sorted(
        {(FRONT_BUCKET_B, -(-h // 8) * 8, -(-w // 8) * 8)
         for h, w in FRONT_SHAPES}), warm_start=True, wire="u8")
    capture_s = time.perf_counter() - t0
    captures = eng.capture_count
    launches = {k: 0 for k in per_replay}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        spans = os.path.join(tmp, "spans.jsonl")
        for depth in (1, 2):
            s, l = front_drill(eng, weights, cfg, depth,
                               trace_path=spans if depth == 1 else None)
            n = s["dispatches"]
            if l != {k: v * n for k, v in per_replay.items()}:
                raise RuntimeError(f"depth {depth}: {n} dispatches replayed "
                                   f"{l}, want {per_replay} each")
            for k in launches:
                launches[k] += l[k]
            bad = (s["served"] != s["accepted"] or s["stranded"]
                   or not s["accounting_ok"] or s["errors"]
                   or s["session_pairs"] != FRONT_SESSIONS
                   * FRONT_SESSION_FRAMES or s["executables"] != captures)
            if bad:
                raise RuntimeError(f"depth {depth} drill: {s}")
            # the idle share of one profiled window: the same drill's
            # traffic, cut to FRONT_PROFILED_REQUESTS one-shot pairs
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                ps, pl = front_drill(eng, weights, cfg, depth,
                                     requests=FRONT_PROFILED_REQUESTS,
                                     sessions=0)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
            for k in launches:
                launches[k] += pl[k]
            busy = device_busy_ms(prof)
            runs[depth] = {k: s[k] for k in (
                "pairs_per_s", "p50_ms", "p99_ms", "mean_occupancy",
                "dispatch_gap_p50_ms", "dispatch_gap_p99_ms",
                "dispatch_gap_mean_ms", "overlap_ratio",
                "h2d_bytes_per_req", "dispatches", "served",
                "session_pairs", "warm_submits", "wall_s")}
            runs[depth].update(
                captures=eng.capture_count, profiled_wall_ms=wall,
                profiled_busy_ms=busy, idle_share=1 - busy / wall,
                profiled_pairs_per_s=ps["pairs_per_s"])
            log(f"[18] serve_bench.run_drill, basic model at full width "
                f"(seeded weights, pallas+fused, iters={ITERS}, u8 wire, warm "
                f"start, TF32 convolutions), shapes {FRONT_SHAPES} in buckets "
                f"of {FRONT_BUCKET_B}, {FRONT_REQUESTS} requests from "
                f"{FRONT_SUBMITTERS} submitters + {FRONT_SESSIONS} sessions "
                f"of {FRONT_SESSION_FRAMES} pairs, pipeline_depth={depth}: "
                f"{runs[depth]}; {n} dispatches replayed {l} (per replay "
                f"{per_replay}); {smi}")
            if eng.capture_count != captures:
                raise RuntimeError("the drill captured a new graph")
        # -- 7. the spans of run 1, read back with cli/serve_trace ------------
        recs = serve_trace.load_spans(spans)
        requests = [r for r in recs if r["span"] == "request"]
        problems = validate_lines(recs)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_trace.main([spans, "--top", "3"])
        attribution = serve_trace.phase_attribution(recs)
        log(f"[18] --trace-path on run 1: {len(requests)} request spans "
            f"({len([r for r in recs if r['span'] == 'dispatch'])} dispatch "
            f"spans), schema problems {problems[:3]}; serve_trace's report:\n"
            + buf.getvalue().rstrip())
        if problems or len(requests) != runs[1]["served"] + FRONT_SESSIONS \
                * FRONT_SESSION_FRAMES or not buf.getvalue().strip():
            raise RuntimeError("the spans file does not hold every request")
        out["trace"] = {"request_spans": len(requests),
                        "phase_attribution": attribution}
    # one profiled dispatch: the bucket graph's K1/K2 by kernel name
    f = synthetic_frames(0, FRONT_BUCKET_B + 1)
    f1, f2 = np.stack(f[:-1]), np.stack(f[1:])
    _, _, counts, _ = profiled_replay(lambda: eng.infer_batch(f1, f2),
                                      per_replay, "front end dispatch")
    out.update(full_width=runs, capture_s=capture_s, captures=captures,
               profiled_dispatch_launches=counts)
    del eng

    # -- 2. correctness: the small fixture, mixed shapes of demo-frames ------
    fixture = os.path.join(REPO, "tests", "fixtures",
                           "raft-small-cputrained.pth")
    cfg_s = RAFTConfig(small=True, corr_impl="pallas")
    small = load_pth(fixture, cfg_s)
    frames, crops = demo_frames(), MIXED_CROPS
    pairs = [(frames[i][:h, :w], frames[i + 1][:h, :w])
             for i in range(len(frames) - 1) for h, w in crops]
    mixed = RAFTEngine(small, cfg_s, iters=ITERS, envelope=sorted(
        {(FRONT_BUCKET_B, -(-h // 8) * 8, -(-w // 8) * 8) for h, w in crops}),
        wire="u8")
    direct = [mixed.infer_batch(a[None], b[None])[0] for a, b in pairs]
    with MicroBatchScheduler(mixed, max_batch=FRONT_BUCKET_B,
                             gather_window_s=0.005) as sched:
        futs = [sched.submit(a, b) for a, b in pairs]
        done = [f.result(timeout=300).flow for f in futs]
    snap = sched.metrics.snapshot()
    gap = max(float(np.abs(g - d).max()) for g, d in zip(done, direct))
    stranded = sum(not f.done() for f in futs)
    identity = snap["submitted"] == (snap["completed"] + snap["failed"]
                                     + snap["deadline_missed"]
                                     + snap["cancelled"])
    log(f"[18] the small fixture through the scheduler: {len(pairs)} pairs of "
        f"demo-frames at {crops} in {snap['dispatches']} dispatches "
        f"(occupancy {snap['occupancy']['mean']}), each against the engine's "
        f"direct infer_batch of the pair: largest gap {gap:.3e} px (tol "
        f"{SMALL_TOL:g}); stranded {stranded}, accounting identity {identity}")
    if not (gap <= SMALL_TOL and stranded == 0 and identity
            and snap["completed"] == len(pairs)):
        raise RuntimeError("the scheduler's flows disagree or strand")
    out["correctness"] = {"pairs": len(pairs), "gap_px": gap,
                          "dispatches": snap["dispatches"]}

    # -- 5. ragged: the same mixed traffic through one capacity class --------
    box = (FRONT_BUCKET_B, max(-(-h // 8) * 8 for h, _ in crops),
           max(-(-w // 8) * 8 for _, w in crops))
    ragged = RAFTEngine(small, cfg_s, iters=ITERS, wire="u8", ragged=True,
                        capacity_classes=[box])
    shapes = MIXED_CROPS
    rs = serve_bench.run_drill(small, cfg_s, shapes=shapes, requests=24,
                               bucket_batch=FRONT_BUCKET_B, iters=ITERS,
                               wire="u8", ragged=True, engine=ragged, seed=5)
    bs = serve_bench.run_drill(small, cfg_s, shapes=shapes, requests=24,
                               bucket_batch=FRONT_BUCKET_B, iters=ITERS,
                               wire="u8", engine=mixed, seed=5)
    log(f"[18] --ragged on {shapes} x 24 requests: {ragged.capture_count} "
        f"graph (class {box}), {rs['dispatches']} dispatches, capacity fill "
        f"{rs['capacity_fill']}, cross-shape rate "
        f"{rs['cross_shape_coalesce_rate']}, padding waste "
        f"{rs['padding_waste_ratio']}, {rs['pairs_per_s']} pairs/s; bucketed: "
        f"{mixed.capture_count} graphs, {bs['dispatches']} dispatches, "
        f"padding waste {bs['padding_waste_ratio']}, {bs['pairs_per_s']} "
        f"pairs/s")
    for s in (rs, bs):
        if s["served"] != s["accepted"] or not s["accounting_ok"]:
            raise RuntimeError(f"ragged/bucketed drill: {s}")
    if ragged.capture_count != 1:
        raise RuntimeError("the ragged drill captured more than its class")
    out["ragged"] = {"graphs": ragged.capture_count,
                     "graphs_bucketed": mixed.capture_count,
                     **{k: rs[k] for k in (
                         "dispatches", "capacity_fill",
                         "cross_shape_coalesce_rate", "padding_waste_ratio",
                         "pairs_per_s")},
                     "bucketed": {k: bs[k] for k in (
                         "dispatches", "padding_waste_ratio",
                         "pairs_per_s")}}
    del ragged, mixed

    # -- 3. feature-cache sessions over demo-frames (small fixture) ----------
    # Items 3, 4 and 6 run fp32 convolutions (TF32 off, as phase 1 set
    # it): with TF32 the cached program (fnet at batch 1 on the new frame)
    # and the plain twin (fnet at batch 2 on both frames) round
    # differently, and the small fixture's 20 steps carry that to a few
    # hundredths of a px. Items 1, 2 and 5 compare a program with itself
    # and keep TF32: fp32 at a batch-4 bucket runs cuDNN's FFT convolutions
    torch.backends.cudnn.allow_tf32 = False
    full = (1,) + tuple(-(-x // 8) * 8 for x in frames[0].shape[:2])
    frame_bytes = full[1] * full[2] * 3          # one u8 frame at the bucket
    cached = RAFTEngine(small, cfg_s, iters=ITERS, envelope=[full],
                        wire="u8", warm_start=True, feature_cache=True)
    twin = RAFTEngine(small, cfg_s, iters=ITERS, envelope=[full], wire="u8",
                      warm_start=True)
    streams = [frames, frames[::-1]]

    def sessions_run(engine, record=None, **kw):
        """Each stream in a VideoSession on its own thread; returns the
        sessions' warm pairs, the wall seconds and the metrics."""
        with MicroBatchScheduler(engine, max_batch=1, gather_window_s=0.0,
                                 feature_cache=kw.get("feature_cache",
                                                      False)) as sched:
            sessions = [VideoSession(sched, **kw) for _ in streams]

            def run(k):
                sess = sessions[k]
                for i, frame in enumerate(streams[k]):
                    fut = sess.submit_frame(frame)
                    if fut is None or record is None:
                        continue
                    res = fut.result(timeout=300)
                    low = (sched._fcache._slots[sess._stream].flow_low
                           if sess.feature_cache else res.flow_low)
                    # the flow_low the stream's NEXT pair starts from
                    record[k].append((i, res.flow, low.clone()
                                      if isinstance(low, torch.Tensor)
                                      else low))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(k,))
                       for k in range(len(streams))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            for sess in sessions:
                sess.drain()
            wall = time.perf_counter() - t0
            return (sum(x.warm_submits for x in sessions), wall,
                    sched.metrics.snapshot())

    warm_c, wall_c, snap_c = sessions_run(cached, feature_cache=True)
    warm_p, wall_p, snap_p = sessions_run(twin)
    record = [[] for _ in streams]
    sessions_run(cached, record, feature_cache=True)
    # each cached pair against the plain twin fed the same flow_init (the
    # first pair of a stream is cold: its slot came from the prime)
    cgap = 0.0
    for k, stream in enumerate(streams):
        prev_low = None
        for i, flow, low in record[k]:
            init = (None if prev_low is None
                    else forward_interpolate_device(prev_low)[None])
            want = twin.infer_batch(stream[i - 1][None], stream[i][None],
                                    flow_init=init)
            cgap = max(cgap, float(np.abs(want[0] - flow).max()))
            prev_low = low
    fc = snap_c["feature_cache"]
    h2d = snap_c["hot_path"]["h2d_bytes_per_req"]
    pairs_total = sum(len(s) - 1 for s in streams)
    front_cache = {
        "warm_pairs_per_s": warm_c / wall_c, "cache_hit_rate": fc["hit_rate"],
        "h2d_bytes_per_warm_pair": h2d, "frame_bytes": frame_bytes,
        "gap_px": cgap, "pairs_per_s": pairs_total / wall_c,
        "plain_sessions_pairs_per_s": pairs_total / wall_p,
        "plain_h2d_bytes_per_pair": snap_p["hot_path"]["h2d_bytes_per_req"],
        "warm_pairs": warm_c, "plain_warm_pairs": warm_p}
    log(f"[18] feature-cache sessions (small fixture, {len(streams)} streams "
        f"of demo-frames, one thread each, bucket {full}): {front_cache}; "
        f"each warm pair against the plain twin with the same flow_init: "
        f"largest gap {cgap:.3e} px (tol {SMALL_TOL:g})")
    if not (cgap <= SMALL_TOL and h2d == frame_bytes
            and warm_c == pairs_total and fc["hit_rate"] == 1.0):
        raise RuntimeError("the feature-cache sessions disagree, miss, or "
                           "ship more than one frame a pair")
    out["feature_cache"] = front_cache

    # -- 4. a device_state session: flow_low stays on the card ---------------
    record = [[] for _ in streams]
    sessions_run(twin, record, device_state=True)
    on_card = all(isinstance(low, torch.Tensor) and low.device == twin.device
                  for rec in record for _, _, low in rec)
    warps = [forward_interpolate_device(low) for rec in record
             for _, _, low in rec]
    again = [forward_interpolate_device(low) for rec in record
             for _, _, low in rec]
    bitwise = all(torch.equal(a, b) for a, b in zip(warps, again))
    log(f"[18] device_state sessions on the twin engine: "
        f"{sum(len(r) for r in record)} pairs, every flow_low a tensor on "
        f"{twin.device} {on_card}, forward_interpolate_device bitwise across two runs "
        f"{bitwise}")
    if not (on_card and bitwise):
        raise RuntimeError("device_state left the card or the warp varies")
    out["device_state"] = {"pairs": sum(len(r) for r in record),
                           "on_card": on_card, "warp_bitwise": bitwise}
    del cached, twin

    # -- 6. one --chaos 2 drill at the small fixture -------------------------
    t0 = time.perf_counter()
    chaos = serve_bench.run_chaos_drill(small, cfg_s, shapes=CHAOS_SHAPES,
                                        rounds=2, seed=18)
    clean = chaos["per_round"][-1]
    log(f"[18] serve_bench --chaos 2 (small fixture, {CHAOS_SHAPES}, raise "
        f"and hang at serve.request, serve.dispatch_exec, engine.compile): "
        f"violations {chaos['violations']}, totals {chaos['totals']}, "
        f"breaker transitions {chaos['breaker_transitions']}, graphs "
        f"{chaos['executables']} of {chaos['documented_buckets']} documented, "
        f"clean round {clean['health_state']}, "
        f"{time.perf_counter() - t0:.1f} s")
    if chaos["violations"] or clean["health_state"] != "healthy":
        raise RuntimeError("the chaos drill broke an invariant")
    out["chaos"] = {k: chaos[k] for k in (
        "violations", "totals", "breaker_transitions", "executables",
        "documented_buckets")}
    out["launches_serving_frontend"] = launches
    out["launches_per_replay"] = per_replay
    return out


REG_CANARY = 0.25               # drill (a)'s canary fraction
REG_BUDGET = 24                 # drill (a)'s admission budget (tokens)
REG_RESERVE = 6                 # of which interactive-only
GUARD_HW = FRONT_SHAPES[1]      # drill (b)'s request shape
SWAP_PAIRS = 8                  # drill (c)'s pairs under the swaps
FLEET_REPEATS = 3               # drill (c)'s runs of each configuration


def registry_fleet_phase(smi: str) -> dict:
    """Phase 19: multi-model serving and the replica fleet on the card
    (``serving.registry``, ``serving.guardian``, the scheduler's fleet,
    ``RAFTEngine.spawn_replica``, ``cli/serve_bench``'s registry drills);
    see the module docstring."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.cli import serve_bench, serve_trace
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.parallel.placement import Placement
    from raft_tpu_torch.serving import (GuardianPolicy, MicroBatchScheduler,
                                        ModelRegistry, RAFTEngine,
                                        SLOGuardian)
    from raft_tpu_torch.serving.schema import validate_lines
    from raft_tpu_torch.testing import faults
    from raft_tpu_torch.tools.convert import load_pth

    per_replay = {"corr_lookup": ITERS, "gru_gates": 2 * ITERS,
                  "gru_blend": 2 * ITERS}
    # every engine of the phase is built under one setting, phase 18's:
    # TF32 convolutions (a graph fixes its kernels at capture), cuDNN
    # deterministic
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    out = {"tf32_convolutions": True}
    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    v1 = RAFT(cfg, torch.Generator().manual_seed(0)).state_dict()
    v2 = RAFT(cfg, torch.Generator().manual_seed(1)).state_dict()
    cfg_s = RAFTConfig(small=True, corr_impl="pallas")
    small = load_pth(os.path.join(REPO, "tests", "fixtures",
                                  "raft-small-cputrained.pth"),
                     cfg_s).state_dict()
    env = sorted({(FRONT_BUCKET_B, -(-h // 8) * 8, -(-w // 8) * 8)
                  for h, w in FRONT_SHAPES})

    def engine(w, c):
        return RAFTEngine(w, c, iters=ITERS, envelope=env,
                          warm_start=True, wire="u8")

    def replayed(engines):
        return [dict(e.replayed_launches()) for e in engines]

    def delta(engines, before):
        tot = {k: 0 for k in per_replay}
        for e, b in zip(engines, before):
            for k, n in e.replayed_launches().items():
                tot[k] += n - b.get(k, 0)
        return tot

    def gap(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    launches_registry = {k: 0 for k in per_replay}

    # -- (a) two models on one card, a same-arch canary promoted ------------
    t0 = time.perf_counter()
    live, canary, small_eng = engine(v1, cfg), engine(v2, cfg), \
        engine(small, cfg_s)
    build_s = time.perf_counter() - t0
    engines = (live, canary, small_eng)
    captures = [e.capture_count for e in engines]
    for e in (live, canary):
        for prog in e._programs.values():
            if prog.launches != per_replay:
                raise RuntimeError(f"a basic bucket graph holds "
                                   f"{prog.launches}, want {per_replay}")
    accepted = []
    lock = threading.Lock()

    def on_accept(name, prio, i1, i2, fut):
        with lock:
            accepted.append((name, prio, i1, i2, fut))

    before = replayed(engines)
    with tempfile.TemporaryDirectory() as tmp:
        spans = os.path.join(tmp, "spans.jsonl")
        metrics = os.path.join(tmp, "metrics.jsonl")
        s = serve_bench.run_registry_drill(
            [("basic", v1, cfg), ("small", small, cfg_s)],
            shapes=FRONT_SHAPES, requests=FRONT_REQUESTS,
            submitters=FRONT_SUBMITTERS, bucket_batch=FRONT_BUCKET_B,
            iters=ITERS, priority_mix=(1, 1), canary_fraction=REG_CANARY,
            canary_variables=v2, promote=True, wire="u8",
            admission_budget=REG_BUDGET, admission_reserve=REG_RESERVE,
            metrics_path=metrics, trace_path=spans, seed=19,
            engines={"basic": live, "small": small_eng},
            canary_engine=canary, on_accept=on_accept)
        recs = serve_trace.load_spans(spans)
        with open(metrics) as fh:
            mrecs = [json.loads(line) for line in fh]
    drill_launches = delta(engines, before)
    basic_launches = delta(engines[:2], before[:2])
    small_launches = delta(engines[2:], before[2:])
    for k in per_replay:
        launches_registry[k] += drill_launches[k]
    problems = validate_lines(recs) + validate_lines(mrecs)
    variant = {r["trace_id"]: r.get("variant") for r in recs
               if r["span"] == "request"}
    if s["canary"]["resolution"] != "weights_swap":
        raise RuntimeError(f"the canary did not promote: {s['canary']}")
    promote_captures = [e.capture_count for e in engines]
    # each future against its own variant's direct infer_batch of the same
    # micro-batch (its rows in their order, read from the dispatch span):
    # the live engine serves the canary's weights since the promote, so
    # its own weights go back first (a swap: nothing is captured). Not
    # against its pair alone in the bucket: with TF32 convolutions the
    # basic model's last row of a full batch-4 bucket at 440x1024 rounds
    # differently from row 0, and 20 steps at random weights carry that
    # to hundreds of px (`profile_serving_rows.py`)
    live.update_weights(v1)
    direct = {("basic", "v1"): live, ("basic", "v2"): canary,
              ("small", "v1"): small_eng}
    by_id = {getattr(fut, "trace_id", None): (name, i1, i2, fut)
             for name, _, i1, i2, fut in accepted}
    before_direct = replayed(engines)
    counts, gaps = {}, {}
    for d in (r for r in recs if r["span"] == "dispatch"):
        members = [by_id[t] for t in d["requests"]]
        name, _, ver = d["model"].partition("@")
        eng = direct[(name, ver)]
        want = eng.infer_batch(np.stack([m[1] for m in members]),
                               np.stack([m[2] for m in members]))
        for k, (mname, i1, i2, fut) in enumerate(members):
            if mname != name or variant.get(fut.trace_id) != ver:
                raise RuntimeError(f"dispatch {d['trace_id']} mixes "
                                   "variants")
            key = (name, ver)
            counts[key] = counts.get(key, 0) + 1
            flow = fut.result(timeout=0).flow
            gaps[key] = max(gaps.get(key, 0.0), gap(flow, want[k]))
    worst = max(gaps.values())
    direct_launches = delta(engines, before_direct)
    per_model = {}
    for name, blk in s["models"].items():
        per_model[name] = {k: blk[k] for k in (
            "submitted", "completed", "p50_ms", "p99_ms",
            "admission_rejected", "occupancy", "accounting_ok")}
        per_model[name]["pairs_per_s"] = blk["completed"] / s["wall_s"]
    drill_a = {
        "build_s": build_s, "captures": captures,
        "captures_after_promote": promote_captures,
        "served": s["served"], "accepted": s["accepted"],
        "shed": s["shed"], "stranded": s["stranded"],
        "pairs_per_s": s["pairs_per_s"], "wall_s": s["wall_s"],
        "models": per_model, "priorities": s["priorities"],
        "admission": s["admission"], "canary": s["canary"],
        "futures_by_variant": {f"{n}@{v}": c for (n, v), c in
                               sorted(counts.items())},
        "max_gap_px_by_variant": {f"{n}@{v}": g for (n, v), g in
                                  sorted(gaps.items())},
        "max_gap_px": worst, "launches": drill_launches,
        "schema_problems": problems[:3]}
    log(f"[19] (a) two models on one card through "
        f"serve_bench.run_registry_drill: basic at full width (seeded "
        f"weights, pallas+fused, iters={ITERS}, u8 wire, warm start, TF32 "
        f"convolutions) and the small fixture, buckets {env}, "
        f"{FRONT_REQUESTS} requests from {FRONT_SUBMITTERS} submitters at "
        f"priority mix 1:1, a same-arch basic canary (second seed) at "
        f"{REG_CANARY}, admission budget {REG_BUDGET} (reserve "
        f"{REG_RESERVE}), promoted after traffic: {drill_a}; each future "
        f"against its own variant's direct infer_batch of the same "
        f"micro-batch: largest gap {worst:.3e} px (tol {SERVE_TOL:g}); "
        f"{smi}")
    n_basic = sum(c for (n, _), c in counts.items() if n == "basic")
    n_small = len(accepted) - n_basic
    n_dispatch = sum(1 for r in recs if r["span"] == "dispatch")
    n_basic_dispatch = sum(1 for r in recs if r["span"] == "dispatch"
                           and r["model"].startswith("basic@"))
    # every dispatch a replay: 20 K1 each; 40 gates and blends each of
    # the basic model's (the small model's GRU is not the fused one)
    bad = (worst > SERVE_TOL or s["stranded"] or not s["accounting_ok"]
           or s["served"] != s["accepted"] or problems
           or len(accepted) != s["accepted"] or not n_small
           or promote_captures != captures
           or [e.capture_count for e in engines] != captures
           or ("basic", "v2") not in counts
           or not basic_launches["corr_lookup"]
           or not small_launches["corr_lookup"]
           or basic_launches["corr_lookup"] % ITERS
           or small_launches["corr_lookup"] % ITERS
           or basic_launches["gru_gates"] != 2 * basic_launches[
               "corr_lookup"]
           or basic_launches["gru_blend"] != basic_launches["gru_gates"]
           or small_launches["gru_gates"] or small_launches["gru_blend"]
           or sum(counts.values()) != len(accepted)
           or direct_launches != {
               "corr_lookup": ITERS * n_dispatch,
               "gru_gates": 2 * ITERS * n_basic_dispatch,
               "gru_blend": 2 * ITERS * n_basic_dispatch})
    if bad:
        raise RuntimeError(f"the two-model drill failed: {drill_a}; "
                           f"direct launches {direct_launches}")
    out["two_models"] = drill_a

    # -- (b) the guardian: a degraded canary rolled back, a clean one
    # promoted (as tests/test_guardian.py's acceptance drills) -----------
    before = replayed((live, canary))
    rng = np.random.RandomState(19)
    xa, xb = (rng.rand(*GUARD_HW, 3).astype(np.float32) * 255
              for _ in range(2))
    ref_live = live.infer_batch(xa[None], xb[None])[0]
    ref_canary = canary.infer_batch(xa[None], xb[None])[0]
    reg = ModelRegistry(max_batch=FRONT_BUCKET_B, gather_window_s=0.0)
    reg.add_model("basic", v1, cfg, iters=ITERS, engine=live)
    version = reg.deploy("basic", v2, canary_fraction=0.5, engine=canary)
    live_keys = [k for k in range(100)
                 if not reg.routes_to_canary("basic", k)][:8]
    canary_keys = [k for k in range(100)
                   if reg.routes_to_canary("basic", k)][:6]
    clock = [0.0]
    policy = GuardianPolicy(bake_window_s=100.0, min_requests=4,
                            err_rate_margin=0.1)
    g = SLOGuardian(reg, policy, clock=lambda: clock[0])
    g.tick()
    futs, live_bitwise, injected = [], True, 0
    for k in live_keys:
        futs.append(reg.submit(xa, xb, model="basic", route_key=k))
        live_bitwise &= np.array_equal(futs[-1].result(300).flow, ref_live)
    faults.arm([{"site": "serve.request", "kind": "raise",
                 "count": len(canary_keys)}])
    try:
        for k in canary_keys:
            futs.append(reg.submit(xa, xb, model="basic", route_key=k))
            injected += futs[-1].exception(300) is not None
    finally:
        faults.disarm()
    clock[0] = 5.0
    verdict = g.tick()
    futs.append(reg.submit(xa, xb, model="basic", route_key=live_keys[0]))
    live_bitwise &= np.array_equal(futs[-1].result(300).flow, ref_live)
    stranded = sum(not f.done() for f in futs)
    canary_left = reg.health()["basic"]["canary"]
    # the clean canary, baked to its window's end under a policy whose
    # margins only a fault can breach (as the JAX acceptance drill's)
    reg.deploy("basic", v2, canary_fraction=0.5, engine=canary)
    clean_policy = GuardianPolicy(bake_window_s=10.0, min_requests=4,
                                  p99_ratio=50.0, p99_slack_ms=1e5,
                                  err_rate_margin=0.5)
    g2 = SLOGuardian(reg, clean_policy, clock=lambda: clock[0])
    g2.tick()
    clean = [reg.submit(xa, xb, model="basic", route_key=k)
             for k in range(16)]
    for f in clean:
        f.result(300)
    clock[0] = 15.5
    promote = g2.tick()
    after = reg.submit(xa, xb, model="basic").result(300).flow
    reg.close()
    snap = reg.snapshot()["basic"]
    guard_launches = delta((live, canary), before)
    for k in per_replay:
        launches_registry[k] += guard_launches[k]
    drill_b = {"rollback": [{k: d[k] for k in ("action", "version",
                                                "reason")}
                            for d in verdict],
               "rollback_window_s": (verdict[0]["evidence"]["window_s"]
                                     if verdict else None),
               "injected_failures": injected,
               "live_bitwise": bool(live_bitwise),
               "promote": [{k: d.get(k) for k in ("action", "mode",
                                                   "reason")}
                           for d in promote],
               "promoted_bitwise": bool(np.array_equal(after, ref_canary)),
               "stranded": stranded, "accounting_ok": snap["accounting_ok"],
               "captures": [live.capture_count, canary.capture_count],
               "launches": guard_launches}
    log(f"[19] (b) the guardian on the basic model at {GUARD_HW}: a canary "
        f"whose dispatches fault at serve.request, then a clean one: "
        f"{drill_b}; {smi}")
    if not (len(verdict) == 1 and verdict[0]["action"] == "rollback"
            and verdict[0]["version"] == version
            and "err_rate" in verdict[0]["reason"]
            and verdict[0]["evidence"]["window_s"] < policy.bake_window_s
            and canary_left is None and live_bitwise
            and injected == len(canary_keys) and not stranded
            and len(promote) == 1 and promote[0]["action"] == "promote"
            and promote[0].get("mode") == "weights_swap"
            and drill_b["promoted_bitwise"] and snap["accounting_ok"]
            and [live.capture_count, canary.capture_count]
            == captures[:2]):
        raise RuntimeError(f"the guardian drill failed: {drill_b}")
    out["guardian"] = drill_b
    live.update_weights(v1)
    del canary, small_eng, reg

    # -- (c) the replica fleet on one card -----------------------------------
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    res0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    placement = Placement(live, replicas=2)
    torch.cuda.synchronize()
    spawn_s = time.perf_counter() - t0
    rep = placement.engines[1]
    replica = {
        "spawn_s": spawn_s,
        "capture_s": sum(v["warmup"] + v["capture"]
                         for v in rep.capture_seconds.values()),
        "captures": rep.capture_count,
        "primary_programs": live.capture_count,
        "memory_added_mib": (torch.cuda.memory_allocated() - mem0) / 2**20,
        "reserved_added_mib": (torch.cuda.memory_reserved() - res0) / 2**20,
        "peak_added_mib": (torch.cuda.max_memory_allocated() - mem0) / 2**20,
        "assignments": placement.snapshot()["assignments"]}
    fleet_engines = placement.engines
    launches_fleet = {k: 0 for k in per_replay}
    configs = (("r1_depth1", 1, 1), ("r1_depth2", 1, 2), ("r2_depth1", 2, 1))
    draws = {tag: [] for tag, _, _ in configs}
    # FLEET_REPEATS unprofiled runs of each configuration, interleaved so
    # a drift of the host behind the call spreads over all of them
    for _ in range(FLEET_REPEATS):
        for tag, replicas, depth in configs:
            kw = dict(placement=placement) if replicas > 1 else {}
            before = replayed(fleet_engines)
            torch.cuda.reset_peak_memory_stats()
            fs, _ = front_drill(live, v1, cfg, depth, **kw)
            d = delta(fleet_engines, before)
            for k in per_replay:
                launches_fleet[k] += d[k]
            if (fs["served"] != fs["accepted"] or fs["stranded"]
                    or not fs["accounting_ok"] or fs["errors"]
                    or d != {k: v * fs["dispatches"]
                             for k, v in per_replay.items()}):
                raise RuntimeError(f"fleet drill {tag}: {fs}; launches {d}")
            draws[tag].append(
                (fs, torch.cuda.max_memory_allocated() / 2**20,
                 torch.cuda.memory_reserved() / 2**20))
    runs = {}
    for tag, replicas, depth in configs:
        kw = dict(placement=placement) if replicas > 1 else {}
        rates = [fs["pairs_per_s"] for fs, _, _ in draws[tag]]
        fs, peak, reserved = sorted(
            draws[tag], key=lambda x: x[0]["pairs_per_s"])[len(rates) // 2]
        before = replayed(fleet_engines)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            ps, _ = front_drill(live, v1, cfg, depth, sessions=0,
                                requests=FRONT_PROFILED_REQUESTS, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        busy = device_busy_ms(prof)
        d = delta(fleet_engines, before)
        for k in per_replay:
            launches_fleet[k] += d[k]
        if d != {k: v * ps["dispatches"] for k, v in per_replay.items()}:
            raise RuntimeError(f"fleet drill {tag}, profiled: {ps}; "
                               f"launches {d}")
        # the median run's numbers, and every run's pairs/s and occupancy
        runs[tag] = {k: fs[k] for k in (
            "pairs_per_s", "p50_ms", "p99_ms", "mean_occupancy",
            "dispatches", "served", "session_pairs", "wall_s")}
        runs[tag].update(
            pairs_per_s_runs=rates,
            occupancy_runs=[f["mean_occupancy"] for f, _, _ in draws[tag]],
            peak_mib=peak, reserved_mib=reserved,
            idle_share=1 - busy / wall,
            profiled_pairs_per_s=ps["pairs_per_s"])
        if "fleet" in fs:
            runs[tag]["lane_dispatches"] = {
                k: v["dispatches"] for k, v in fs["fleet"]["lanes"].items()}
            runs[tag]["concurrency_max"] = fs["fleet"]["concurrency_max"]
        log(f"[19] (c) phase 18's traffic, replicas={replicas}, "
            f"pipeline_depth={depth}, {FLEET_REPEATS} runs (the median's "
            f"numbers): {runs[tag]}; {smi}")
    if runs["r2_depth1"]["lane_dispatches"]["r1"] < 1:
        raise RuntimeError("the second lane never dispatched")
    # the fleet-atomic swap, clean then failed, under traffic
    frames = synthetic_frames(19, SWAP_PAIRS + 1, GUARD_HW)
    pairs = [(frames[k], frames[k + 1]) for k in range(SWAP_PAIRS)]
    solo = engine(v2, cfg)
    refs = {"v1": [live.infer_batch(a[None], b[None])[0] for a, b in pairs],
            "v2": [solo.infer_batch(a[None], b[None])[0] for a, b in pairs]}
    del solo
    before = replayed(fleet_engines)
    outputs = []
    with MicroBatchScheduler(live, placement=placement,
                             max_batch=FRONT_BUCKET_B,
                             gather_window_s=0.0) as sched:
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                fs_ = [sched.submit(a, b) for a, b in pairs]
                outputs.extend((k, f.result(300).flow)
                               for k, f in enumerate(fs_))

        t = threading.Thread(target=traffic)
        t.start()
        time.sleep(0.5)
        sched.swap_weights(v2)
        time.sleep(0.5)
        faults.arm([{"site": "scheduler.swap", "at": 2, "kind": "raise"}])
        failed = False
        try:
            sched.swap_weights(v1)
        except faults.FaultInjected:
            failed = True
        finally:
            faults.disarm()
        torch.cuda.synchronize()    # the copies ran on the lanes' streams
        lanes_old = all(all(torch.equal(x, v2[k].to(x.device))
                            for k, x in lane.engine.variables.items())
                        for lane in sched._lanes)
        time.sleep(0.5)
        stop.set()
        t.join(300)
        tail = [sched.submit(a, b) for a, b in pairs]
        tail_v2 = all(np.array_equal(f.result(300).flow, refs["v2"][k])
                      for k, f in enumerate(tail))
        lane_dispatches = {f"r{lane.index}": lane.dispatches
                           for lane in sched._lanes}
    d = delta(fleet_engines, before)
    for k in per_replay:
        launches_fleet[k] += d[k]
    which = [("v1" if np.array_equal(o, refs["v1"][k]) else
              "v2" if np.array_equal(o, refs["v2"][k]) else "mixed")
             for k, o in outputs]
    swap = {"outputs": len(outputs),
            "by_weights": {w: which.count(w) for w in ("v1", "v2",
                                                        "mixed")},
            "failed_swap_raised": failed, "lanes_on_old_after_failure":
            lanes_old, "after_failure_bitwise_v2": tail_v2,
            "lane_dispatches": lane_dispatches,
            "captures": [e.capture_count for e in fleet_engines]}
    log(f"[19] (c) the fleet-atomic swap under traffic ({SWAP_PAIRS} pairs "
        f"at {GUARD_HW} a round, 2 lanes): v1->v2 clean, then v2->v1 with "
        f"scheduler.swap armed at the second lane: {swap}; {smi}")
    if not (failed and lanes_old and tail_v2 and not which.count("mixed")
            and which.count("v1") and which.count("v2")
            and swap["captures"] == [captures[0]] * 2):
        raise RuntimeError(f"the fleet-atomic swap failed: {swap}")
    out["fleet"] = {"replica": replica, "runs": runs, "swap": swap}
    del placement, rep, fleet_engines, live

    # -- (d) registry chaos with the guardian --------------------------------
    t0 = time.perf_counter()
    chaos = serve_bench.run_registry_chaos(
        [("small", small, cfg_s), ("basic", v1, cfg)], shapes=CHAOS_SHAPES,
        rounds=2, canary_variables=RAFT(
            cfg_s, torch.Generator().manual_seed(2)).state_dict(),
        guardian=True, seed=19)
    clean = chaos["per_round"][-1]
    drill_d = {k: chaos[k] for k in ("violations", "deploys", "guardian",
                                      "totals", "executables",
                                      "documented_buckets")}
    drill_d.update(clean_resolution=clean["canary"]["resolution"],
                   plans=[[f"{f['site']}:{f['kind']}"
                           for f in p["plan"]["faults"]]
                          for p in chaos["per_round"] if "plan" in p],
                   seconds=time.perf_counter() - t0)
    log(f"[19] (d) serve_bench registry chaos, 2 rounds with the guardian "
        f"(the small fixture and the basic model at {CHAOS_SHAPES}, iters "
        f"1; plans over registry.load, guardian.decide, serve.request, "
        f"serve.dispatch_exec, engine.compile): {drill_d}")
    if chaos["violations"] or clean["canary"]["resolution"] != \
            "guardian_promote":
        raise RuntimeError(f"the registry chaos broke an invariant: "
                           f"{drill_d}")
    out["chaos"] = drill_d
    out["launches_registry"] = launches_registry
    out["launches_fleet"] = launches_fleet
    out["launches_per_replay"] = per_replay
    return out


STORE_ENVELOPE = [(4, 440, 1024), (4, 368, 496)]   # phase 20 (a)'s buckets
KILL_BUCKET = (4, 368, 496)     # (c)'s hosts' bucket (a store entry of (a))
KILL_HW = (368, 496)            # (c)'s pair, 16 times, max_batch 1 as JAX's
KILL_REQUESTS = 16
KILL_AFTER = 6                  # h0 is SIGKILLed after this many submits
REJOIN_REQUESTS = 6
WORKER_WAIT_S = 600             # bound on a worker's start, prewarm, calls


def worker_argv(weights: str, root, envelope, iters=None):
    """``serving.host_worker``'s argv for phase 20's engine recipe: the
    basic model at full width (``pallas`` + ``fused``), u8 wire, warm
    start, TF32 convolutions (torch's defaults, which phase 20 sets in
    this process too: the flags are part of every program-store key);
    ``root`` None: no store."""
    return ["--weights", weights,
            *(["--aot-root", root] if root else []), "--envelope",
            ",".join("x".join(map(str, b)) for b in envelope),
            "--iters", str(iters or ITERS), "--wire", "u8", "--warm-start",
            "--tf32", "cudnn", "--corr_impl", "pallas", "--gru_impl",
            "fused"]


def spawn_workers(argvs: dict, procs: dict) -> dict:
    """Start one ``python -m raft_tpu_torch.serving.host_worker`` per name,
    all at once, into ``procs`` (the caller kills them); returns ``{name:
    (port, seconds from the spawn to its PORT line)}``."""
    import threading

    t0 = time.perf_counter()
    for name, argv in argvs.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.serving.host_worker",
             *argv], cwd=REPO, stdout=subprocess.PIPE, text=True)
    out = {}
    for name in argvs:
        got = []
        th = threading.Thread(target=lambda p=procs[name]: got.append(
            (p.stdout.readline(), time.perf_counter() - t0)), daemon=True)
        th.start()
        th.join(WORKER_WAIT_S)
        if not got or not got[0][0].startswith("PORT "):
            raise RuntimeError(f"worker {name} reported no port: {got}")
        out[name] = (int(got[0][0].split()[1]), got[0][1])
    return out


def store_entries(root: str) -> list:
    """The manifests of a program store's entries."""
    out = []
    for m in sorted(glob.glob(os.path.join(root, "objects", "*",
                                           "manifest.json"))):
        with open(m) as fh:
            out.append(json.load(fh))
    return out


def store_hosts_phase(smi: str) -> dict:
    """Phase 20: the program store, the transport and the host fleet on
    the card (``serving.aot``, ``serving.transport``, ``serving.hosts``,
    ``serving.host_worker``, the scheduler's host lanes); see the module
    docstring."""
    import gc
    import random
    import threading

    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.cli import serve_bench, serve_trace
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import MicroBatchScheduler, RAFTEngine
    from raft_tpu_torch.serving.aot import AOTCache
    from raft_tpu_torch.serving.hosts import HOST_DEAD, HostFleet, HostWorker
    from raft_tpu_torch.serving.transport import (LoopbackTransport,
                                                  SocketTransport, decode,
                                                  encode)
    from raft_tpu_torch.testing import faults
    from raft_tpu_torch.tools.convert import load_pth, save_pth

    per_replay = {"corr_lookup": ITERS, "gru_gates": 2 * ITERS,
                  "gru_blend": 2 * ITERS}
    # a fresh worker process runs torch's defaults (TF32 convolutions, no
    # TF32 matmuls, cuDNN free to pick any algorithm); every engine of the
    # phase is built under the same, so keys match and outputs can be
    # bitwise across processes
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    out = {"tf32_convolutions": True}
    cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    model = RAFT(cfg, torch.Generator().manual_seed(0))
    v1 = model.state_dict()
    launches = {k: 0 for k in per_replay}

    def engine(env, **kw):
        return RAFTEngine(v1, cfg, iters=ITERS, envelope=env,
                          warm_start=True, wire="u8", **kw)

    def count(engines, fn):
        before = [dict(e.replayed_launches()) for e in engines]
        r = fn()
        for e, b in zip(engines, before):
            for k, n in e.replayed_launches().items():
                launches[k] += n - b.get(k, 0)
        return r

    def gap(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    def batch(seed, bucket):
        b, hw = bucket[0], bucket[1:]
        f = synthetic_frames(seed, b + 1, hw)
        return (np.stack(f[:b]).astype(np.uint8),
                np.stack(f[1:]).astype(np.uint8))

    procs = {}
    # earlier phases' engines go before anything is profiled: a workaround
    # for a profiler interaction, not a fix (two full runs crashed in a
    # profiled CUDAGraph.replay after engines became garbage;
    # tests/test_torch_kernels_gpu.py::test_graph_churn_cell pins it)
    gc.collect()
    tmp = tempfile.mkdtemp(prefix="raft_phase20_")
    try:
        # -- (a) the store: cold, live, warm in this process -----------------
        store = os.path.join(tmp, "store")
        wpath = os.path.join(tmp, "v1.pth")
        save_pth(model, wpath)
        t0 = time.perf_counter()
        cold = engine(STORE_ENVELOPE, aot_cache=store)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        live = engine(STORE_ENVELOPE)
        torch.cuda.synchronize()
        live_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = engine(STORE_ENVELOPE, aot_cache=store)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        entries = store_entries(store)
        sc, sw = cold.aot_stats(), warm.aot_stats()
        n = len(STORE_ENVELOPE)
        if not (sc["aot_misses"] == sc["compiles"] == n and not sc["aot_hits"]
                and sw["aot_hits"] == n and not sw["compiles"]
                and not sw["aot_misses"] and len(entries) == n):
            raise RuntimeError(f"the store: cold {sc}, warm {sw}, "
                               f"{len(entries)} entries")
        for e in (cold, live, warm):
            for prog in e._programs.values():
                if prog.launches != per_replay:
                    raise RuntimeError(f"a bucket program holds "
                                       f"{prog.launches}, want {per_replay}")
        inputs = {b: batch(20 + k, b) for k, b in
                  enumerate(STORE_ENVELOPE)}
        agree = {}
        for b, (i1, i2) in inputs.items():
            flows = count((cold, live, warm), lambda: {
                name: e.infer_batch(i1, i2) for name, e in
                (("cold", cold), ("live", live), ("warm", warm))})
            agree["x".join(map(str, b))] = {
                "loaded_vs_live_px": gap(flows["warm"], flows["live"]),
                "exported_vs_live_px": gap(flows["cold"], flows["live"]),
                "loaded_vs_live_bitwise": bool(np.array_equal(
                    flows["warm"], flows["live"])),
                "loaded_vs_exported_bitwise": bool(np.array_equal(
                    flows["warm"], flows["cold"]))}
        worst = max(max(v["loaded_vs_live_px"], v["exported_vs_live_px"])
                    for v in agree.values())
        i1, i2 = inputs[STORE_ENVELOPE[0]]
        _, busy, counts, _ = count((warm,), lambda: profiled_replay(
            lambda: warm.infer_batch(i1, i2), per_replay, "a loaded program"))
        replay_ms = {name: count((e,), lambda e=e: events_ms(
            lambda: e.infer_batch(i1, i2), 3))
            for name, e in (("loaded", warm), ("live", live))}
        # one entry corrupted on disk: a miss, and the bucket is traced
        # from the live module again and re-stored (the largest bucket:
        # no other fits its requests, so ensure_bucket rebuilds it)
        shape = STORE_ENVELOPE[0]
        key = warm._aot_key(shape)
        warm.drop_bucket(shape)
        faults.arm([{"site": "aot.load", "kind": "corrupt", "at": 1,
                     "count": 1}])
        try:
            t0 = time.perf_counter()
            warm.ensure_bucket(*shape)
            torch.cuda.synchronize()
            rebuild_s = time.perf_counter() - t0
        finally:
            faults.disarm()
        sr = warm.aot_stats()
        j1, j2 = inputs[shape]
        rgap = count((warm, live), lambda: gap(warm.infer_batch(j1, j2),
                                               live.infer_batch(j1, j2)))
        restored = AOTCache(store)._entry_valid(AOTCache(store).entry_dir(key),
                                                key)
        corrupt = {"stats": sr, "rebuild_s": rebuild_s, "gap_px": rgap,
                   "entry_valid_after": restored,
                   "last_miss": warm._aot.last_miss}
        out["store"] = {
            "build_s": {"cold": cold_s, "live": live_s, "warm": warm_s},
            "cold": sc, "warm": sw, "entries": len(entries),
            "blob_bytes": [m["blob_bytes"] for m in entries],
            "aot_seconds_cold": {f"{k[0]}:{'x'.join(map(str, k[1]))}": v
                                 for k, v in cold.aot_seconds.items()},
            "aot_seconds_warm": {f"{k[0]}:{'x'.join(map(str, k[1]))}": v
                                 for k, v in warm.aot_seconds.items()},
            "capture_seconds_warm": {
                f"{k[0]}:{'x'.join(map(str, k[1]))}": v
                for k, v in warm.capture_seconds.items()},
            "agree": agree, "profiled_launches": counts,
            "profiled_busy_ms": busy, "replay_ms": replay_ms,
            "corrupt": corrupt}
        log(f"[20] (a) the program store, basic model at full width, "
            f"buckets {STORE_ENVELOPE}, iters {ITERS}, u8 wire, warm start: "
            f"{out['store']}; {smi}")
        if not (worst <= SERVE_TOL and counts == per_replay
                and sr["aot_misses"] == 1 and sr["compiles"] == 1
                and rgap <= SERVE_TOL and restored):
            raise RuntimeError(f"the store failed: {out['store']}")

        # -- (a) join times: fresh worker processes, cold and warm ----------
        # four workers started at once: the two join workers (their
        # start times are the join's first term) and (c)'s two hosts
        def argv_k(name):
            return worker_argv(wpath, os.path.join(tmp, f"kill_{name}"),
                               [KILL_BUCKET])

        ports = spawn_workers(
            {"cold": worker_argv(wpath, os.path.join(tmp, "join_cold"),
                                 STORE_ENVELOPE),
             "warm": worker_argv(wpath, os.path.join(tmp, "join_warm"),
                                 STORE_ENVELOPE),
             "none": worker_argv(wpath, None, STORE_ENVELOPE),
             "h0": argv_k("h0"), "h1": argv_k("h1")}, procs)

        def join(tag, push):
            port, start_s = ports[tag]
            t = SocketTransport("127.0.0.1", port,
                                call_timeout_s=WORKER_WAIT_S, name=tag)
            rec = {"start_s": start_s}
            if push:
                t0 = time.perf_counter()
                rec["push"] = AOTCache(store).push(t)
                rec["push_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec["prewarm"] = t.call("prewarm")
            rec["prewarm_s"] = time.perf_counter() - t0
            rec["ready_s"] = (start_s + rec.get("push_s", 0.0)
                              + rec["prewarm_s"])
            return t, rec

        # one at a time (each builds on the card alone): without a store
        # (the live module captured), from an empty store, from a pushed
        # one; the last two stay up as (b)'s socket lanes
        tn, jnone = join("none", push=False)
        tn.close()
        p = procs.pop("none")
        p.kill()
        p.wait(30)
        tc, jcold = join("cold", push=False)
        tw, jwarm = join("warm", push=True)
        pw = jwarm["prewarm"]
        if not (jcold["prewarm"]["compiles"] == n and pw["compiles"] == 0
                and pw["aot_hits"] == n):
            raise RuntimeError(f"join: cold {jcold}, warm {jwarm}")
        # the warm worker's replay against this process's on the same
        # inputs, through the socket: u8 frames out, fp32 flow back
        remote = tw.call("infer", {"image1": i1, "image2": i2})
        local = count((cold,), lambda: cold.infer_batch(i1, i2))
        rgap_w = gap(remote, local)
        rpc_ms = host_ms(lambda: tw.call("infer", {"image1": i1,
                                                   "image2": i2}), 3)
        local_ms = count((cold,), lambda: host_ms(
            lambda: cold.infer_batch(i1, i2), 3))
        payload = {"image1": i1, "image2": i2}
        t0 = time.perf_counter()
        for _ in range(3):
            decode(encode(("infer", payload)))
            decode(encode(("ok", remote)))
        pickle_ms = (time.perf_counter() - t0) * 1e3 / 3
        out["join"] = {
            "none": jnone, "cold": jcold, "warm": jwarm,
            "remote_gap_px": rgap_w,
            "remote_bitwise": bool(np.array_equal(remote, local)),
            "wire": {"bytes_out": int(i1.nbytes + i2.nbytes),
                     "bytes_back": int(remote.nbytes), "rpc_ms": rpc_ms,
                     "local_ms": local_ms, "pickle_ms": pickle_ms,
                     "share": 1.0 - local_ms / rpc_ms}}
        log(f"[20] (a) join a fresh worker process (buckets "
            f"{STORE_ENVELOPE}): {out['join']}; {smi}")
        if rgap_w > SERVE_TOL:
            raise RuntimeError("the warm worker's replay disagrees")

        # -- (b) run_drill with two loopback host lanes ---------------------
        del warm
        accepted = {}

        def on_accept(a, b, fut):
            accepted[fut.trace_id] = (a, b, fut)

        spans = os.path.join(tmp, "spans_b.jsonl")
        sb = count((cold,), lambda: serve_bench.run_drill(
            v1, cfg, shapes=FRONT_SHAPES, requests=FRONT_REQUESTS,
            submitters=FRONT_SUBMITTERS, bucket_batch=FRONT_BUCKET_B,
            iters=ITERS, wire="u8", engine=cold, hosts=2, aot_cache=store,
            trace_path=spans, seed=20, on_accept=on_accept))
        recs = serve_trace.load_spans(spans)
        by_lane, worst_b, bitwise_b = {}, 0.0, True
        for d in (r for r in recs if r["span"] == "dispatch"):
            members = [accepted[t] for t in d["requests"]]
            want = count((cold,), lambda: cold.infer_batch(
                np.stack([m[0] for m in members]),
                np.stack([m[1] for m in members])))
            lane = d.get("replica", 0)
            by_lane[lane] = by_lane.get(lane, 0) + len(members)
            for k, (_, _, fut) in enumerate(members):
                g = gap(fut.result(0).flow, want[k])
                worst_b = max(worst_b, g)
                bitwise_b &= g == 0.0
        out["loopback"] = {
            **{k: sb[k] for k in ("pairs_per_s", "p50_ms", "p99_ms",
                                  "mean_occupancy", "dispatches",
                                  "served", "wall_s")},
            "futures_by_lane": by_lane, "worst_gap_px": worst_b,
            "bitwise": bitwise_b, "hosts": sb["hosts"],
            "fleet_lanes": {k: v["dispatches"]
                            for k, v in sb["fleet"]["lanes"].items()}}
        log(f"[20] (b) serve_bench.run_drill, phase 18's one-shot traffic "
            f"({FRONT_REQUESTS} requests at {FRONT_SHAPES}), the primary and "
            f"2 loopback host lanes spawned from it: {out['loopback']}; "
            f"{smi}")
        if not (sb["served"] == sb["accepted"] == len(accepted)
                and sb["accounting_ok"] and not sb["stranded"]
                and worst_b <= SERVE_TOL and len(by_lane) == 3):
            raise RuntimeError(f"the loopback host drill failed: {sb}")

        # (b) one seeded batch of one-shot requests, all submitted at once,
        # through the primary alone, with two loopback host lanes (over
        # replicas of the store-less engine: their own captures, ~0.3 s a
        # program where a store load takes seconds; the same numbers), and
        # with the two join workers as socket lanes: pairs/s and, profiled,
        # the idle share (the lanes are built before the profiler starts:
        # no graph is captured under it)
        def one_shot(sched):
            rng = np.random.RandomState(20)
            pairs = [tuple(rng.rand(h, w, 3).astype(np.float32) * 255
                           for _ in range(2))
                     for h, w in (FRONT_SHAPES[k % len(FRONT_SHAPES)]
                                  for k in range(FRONT_REQUESTS))]
            t0 = time.perf_counter()
            futs = [sched.submit(a, b) for a, b in pairs]
            for fu in futs:
                fu.result(WORKER_WAIT_S)
            wall = time.perf_counter() - t0
            h = sched.health()
            return {"pairs_per_s": len(pairs) / wall, "wall_s": wall,
                    "lane_dispatches": {
                        k: v["dispatches"] for k, v in
                        h.get("fleet", {}).get("lanes", {}).items()},
                    "dispatches": sched.metrics.snapshot()["dispatches"]}

        fleet_s = HostFleet({"h0": tc, "h1": tw}, heartbeat_s=0.5,
                            heartbeat_timeout_s=60.0,
                            reconnect_backoff_s=600.0,
                            rng=random.Random(21))
        fleet_s.admit_all()
        fleet_l = HostFleet(
            {f"h{k}": LoopbackTransport(HostWorker(live.spawn_replica()),
                                        name=f"h{k}") for k in range(2)},
            heartbeat_s=0.5, heartbeat_timeout_s=60.0,
            reconnect_backoff_s=600.0, rng=random.Random(22))
        fleet_l.admit_all()
        sock = {}
        for tag, fleet_kw in (("alone", None), ("loopback", fleet_l),
                              ("socket", fleet_s)):
            with MicroBatchScheduler(cold, max_batch=FRONT_BUCKET_B,
                                     gather_window_s=0.005,
                                     breaker_failures=1,
                                     dispatch_timeout_s=WORKER_WAIT_S,
                                     host_fleet=fleet_kw) as sched:
                one_shot(sched)     # warm: each lane's first dispatches
                # earlier drills' engines (and their graphs) are
                # collected here, not while the profiler traces replays:
                # the workaround above, for the profiler interaction
                # tests/test_torch_kernels_gpu.py::test_graph_churn_cell
                # pins
                gc.collect()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    sock[tag] = count((cold,), lambda: one_shot(sched))
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t1) * 1e3
                sock[tag]["idle_share"] = 1 - device_busy_ms(prof) / wall
        del fleet_l, live
        out["one_shot_lanes"] = sock
        log(f"[20] (b) {FRONT_REQUESTS} one-shot requests submitted at once, "
            f"through the primary alone, with two loopback host lanes, with "
            f"the two join workers as socket lanes (each run after a warm-up "
            f"run, profiled): {sock}; {smi}")
        for name in ("cold", "warm"):
            p = procs.pop(name)
            p.kill()
            p.wait(30)

        # -- (c) the socket kill drill ---------------------------------------
        # the primary is (a)'s cold engine; the hosts serve its KILL_BUCKET
        # program, pushed from the store
        kill_eng = cold
        p1, p2 = synthetic_frames(22, 2, KILL_HW)
        oracle = count((kill_eng,), lambda: kill_eng.infer_batch(
            p1[None], p2[None])[0])
        mpath = os.path.join(tmp, "metrics_c.jsonl")
        fleet = HostFleet(
            {name: SocketTransport("127.0.0.1", ports[name][0],
                                   call_timeout_s=WORKER_WAIT_S, name=name)
             for name in ("h0", "h1")},
            aot_cache=AOTCache(store), heartbeat_s=0.1,
            heartbeat_timeout_s=10.0, suspect_after=1, dead_after=2,
            reconnect_backoff_s=600.0, rng=random.Random(20))
        # both hosts admitted at once (push, then prewarm: a load each)
        t0 = time.perf_counter()
        admitted = {}
        threads = [threading.Thread(
            target=lambda name=name: admitted.__setitem__(
                name, fleet.admit(name))) for name in ("h0", "h1")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WORKER_WAIT_S)
        admit_s = time.perf_counter() - t0
        if len(admitted) != 2:
            raise RuntimeError(f"a host was not admitted: {admitted}")
        if any(a["compiles"] or a["aot_hits"] < 1 for a in admitted.values()):
            raise RuntimeError(f"a host traced at prewarm: {admitted}")
        settled = []
        lock = threading.Lock()

        def on_done(fut):
            with lock:
                settled.append((id(fut), time.time()))

        sched = MicroBatchScheduler(
            kill_eng, max_batch=1, gather_window_s=0.0,
            dispatch_timeout_s=WORKER_WAIT_S, breaker_failures=1,
            metrics_path=mpath, host_fleet=fleet)
        try:
            futs = []
            for i in range(KILL_REQUESTS):
                futs.append(sched.submit(p1, p2))
                futs[-1].add_done_callback(on_done)
                if i == KILL_AFTER - 1:
                    procs["h0"].kill()          # SIGKILL mid-traffic
                    t_kill = time.time()
            # its replacement starts while the drill drains
            spawned = {}
            th = threading.Thread(target=lambda: spawned.update(
                spawn_workers({"h0b": argv_k("h0b")}, procs)))
            th.start()
            flows = count((kill_eng,), lambda: [fu.result(WORKER_WAIT_S).flow
                                                for fu in futs])
            end = time.monotonic() + 120
            while time.monotonic() < end and not (
                    fleet.hosts["h0"].failovers
                    and fleet.hosts["h0"].state == HOST_DEAD):
                time.sleep(0.01)
            with open(mpath) as fh:
                ev = [json.loads(line) for line in fh]
            ev = [e for e in ev if e.get("kind") == "serving_event"]
            dead_t = [e["time"] for e in ev if e["event"] == "host_dead"]
            fo_t = [e["time"] for e in ev if e["event"] == "failover"]
            snap1 = sched.metrics.snapshot()
            lanes = {k: v["dispatches"] for k, v in
                     sched.health()["fleet"]["lanes"].items()}
            # restart h0 on a fresh port: the full rejoin protocol
            th.join(WORKER_WAIT_S)
            ports2 = spawned
            t0 = time.perf_counter()
            rstats = fleet.rejoin("h0", SocketTransport(
                "127.0.0.1", ports2["h0b"][0], call_timeout_s=WORKER_WAIT_S,
                name="h0"))
            rejoin_s = time.perf_counter() - t0
            end = time.monotonic() + 120
            while time.monotonic() < end and not any(
                    b.get("host") == "h0" and b["active"] for b in
                    sched.health()["fleet"]["lanes"].values()):
                time.sleep(0.01)
            futs2 = [sched.submit(p1, p2) for _ in range(REJOIN_REQUESTS)]
            for fu in futs2:
                fu.add_done_callback(on_done)
            flows2 = count((kill_eng,), lambda: [
                fu.result(WORKER_WAIT_S).flow for fu in futs2])
            end = time.monotonic() + 120
            while time.monotonic() < end and \
                    sched.health()["state"] != "healthy":
                time.sleep(0.01)
            state = sched.health()["state"]
            lanes2 = {k: v["dispatches"] for k, v in
                      sched.health()["fleet"]["lanes"].items()}
        finally:
            sched.close()
        snap = sched.metrics.snapshot()
        gaps = [gap(fl, oracle) for fl in flows + flows2]
        ids = [i for i, _ in settled]
        last = max(t for i, t in settled if i in {id(fu) for fu in futs})
        out["kill"] = {
            "admit_s": admit_s,
            "admitted": admitted, "worker_start_s": {
                k: v[1] for k, v in {**ports, **ports2}.items()},
            "settled": len(settled),
            "settled_once": len(set(ids)) == len(ids) == len(futs) + len(futs2),
            "completed": snap["completed"], "failed": snap["failed"],
            "abandoned_inflight": snap["abandoned_inflight"],
            "accounting_ok": snap["submitted"] == (
                snap["completed"] + snap["failed"] + snap["deadline_missed"]
                + snap["cancelled"]),
            "hosts_metrics": snap.get("hosts"),
            "worst_gap_px": max(gaps), "bitwise": max(gaps) == 0.0,
            "kill_to_dead_s": (dead_t[0] - t_kill) if dead_t else None,
            "kill_to_failover_s": [t - t_kill for t in fo_t],
            "kill_to_last_settled_s": last - t_kill,
            "lane_dispatches_at_kill_drain": lanes,
            "lane_dispatches_after_rejoin": lanes2,
            "rejoin": rstats, "rejoin_s": rejoin_s, "state_after": state,
            "first_snapshot_completed": snap1["completed"]}
        log(f"[20] (c) the socket kill drill: the primary and 2 host_worker "
            f"processes on the card, bucket {KILL_BUCKET}, max_batch 1, h0 "
            f"SIGKILLed after {KILL_AFTER} of {KILL_REQUESTS} requests, then "
            f"rejoined on a fresh port for {REJOIN_REQUESTS} more: "
            f"{out['kill']}; {smi}")
        if not (out["kill"]["settled_once"]
                and snap["completed"] == KILL_REQUESTS + REJOIN_REQUESTS
                and not snap["failed"] and not snap["abandoned_inflight"]
                and out["kill"]["accounting_ok"]
                and max(gaps) <= SERVE_TOL and dead_t and fo_t
                and rstats["compiles"] == 0 and rstats["aot_hits"] >= 1
                and state == "healthy"):
            raise RuntimeError(f"the kill drill failed: {out['kill']}")
        for p in procs.values():
            p.kill()
        del kill_eng, cold

        # -- (d) serve_bench --chaos 2 --hosts 2 --aot-cache ----------------
        t0 = time.perf_counter()
        cfg_s = RAFTConfig(small=True, corr_impl="pallas")
        small = load_pth(os.path.join(REPO, "tests", "fixtures",
                                      "raft-small-cputrained.pth"), cfg_s)
        chaos = serve_bench.run_chaos_drill(
            small, cfg_s, shapes=CHAOS_SHAPES, rounds=2, seed=20, hosts=2,
            aot_cache=os.path.join(tmp, "chaos_store"))
        clean = chaos["per_round"][-1]
        out["chaos"] = {k: chaos[k] for k in (
            "violations", "totals", "breaker_transitions", "executables",
            "documented_buckets", "aot")}
        out["chaos"].update(
            plans=[[f"{f['site']}:{f['kind']}" for f in p["plan"]["faults"]]
                   for p in chaos["per_round"] if "plan" in p],
            hosts=[p.get("hosts", {}).get("state")
                   for p in chaos["per_round"]],
            seconds=time.perf_counter() - t0)
        log(f"[20] (d) serve_bench --chaos 2 --hosts 2 --aot-cache (the small "
            f"fixture, {CHAOS_SHAPES}): {out['chaos']}; {smi}")
        if chaos["violations"] or clean["health_state"] != "healthy":
            raise RuntimeError(f"the host chaos broke an invariant: "
                               f"{out['chaos']}")
    finally:
        for p in procs.values():
            p.kill()
            p.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches_store_hosts"] = launches
    out["launches_per_replay"] = per_replay
    return out


# ---------------------------------------------------------------------------
# phase 21: .msgpack weights and data-parallel training
# ---------------------------------------------------------------------------

DP_B = 4                        # drill (c)'s global batch, two rows a rank
DP_TIMEOUT_S = 300              # bound on a drill rank's whole run
DP_TIMED_STEPS = 3              # steps timed after the compared one
# iters 1, as phase 8 holds the basic model, then the recipe's
# TRAIN_ITERS, timed and counted, whose loss random weights make sensitive
# to rounding past STEP_LOSS_TOL
DP_ITERS = (1, TRAIN_ITERS)
NCCL_B = 8                      # drill (b): train_mixed.sh's chairs batch
NCCL_STEPS = 6
DP_CHILD = """import json, sys, time
import numpy as np, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from raft_tpu_torch import kernels
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.parallel import distributed
from raft_tpu_torch.parallel.mesh import make_mesh
from raft_tpu_torch.parallel.partitioner import mesh_model_config
from raft_tpu_torch.training.train_step import (all_reduce_mean_,
                                                create_train_state,
                                                make_train_step)
import chip_smoke as c
d, r = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda:0")
torch.cuda.set_device(dev)
# gloo: NCCL refuses two ranks on one device; gloo carries CUDA tensors
distributed.initialize(f"file://{d}/store", 2, r, backend="gloo")
mesh = make_mesh()
cfg = mesh_model_config(RAFTConfig(corr_impl="pallas", gru_impl="fused"),
                        mesh)
weights = torch.load(d + "/weights.pt")
batch = dict(np.load(d + "/batch.npz"))
rows = distributed.process_batch_slice(c.DP_B)
mine = {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}
for iters in c.DP_ITERS:
    model = c.RAFT_for(cfg, weights).to(dev)
    tc = c.dp_train_config(iters=iters)
    state = create_train_state(model, tc)
    step = make_train_step(cfg, tc, mesh)
    kernels.reset_launch_counts()
    m = step(state, mine)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    torch.save({"metrics": {k: float(v) for k, v in m.items()},
                "state": {k: v.cpu() for k, v in model.state_dict().items()},
                "grads": {k: p.grad.cpu() for k, p in
                          model.named_parameters()}},
               f"{d}/rank{r}_iters{iters}.pt")
step_ms, reduce_ms = [], []
params = list(model.parameters())
for _ in range(c.DP_TIMED_STEPS):
    distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, mine)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
    distributed.barrier()
    t0 = time.perf_counter()
    all_reduce_mean_([p.grad for p in params], mesh.group, 2)
    torch.cuda.synchronize()
    reduce_ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"rank": r, "launches": launches, "step_ms": step_ms,
                  "all_reduce_ms": reduce_ms,
                  "grad_mbytes": sum(p.numel() for p in params) * 4 / 1e6}),
      flush=True)
"""


def RAFT_for(cfg, weights):
    """A ``RAFT`` for ``cfg`` holding ``weights``."""
    from raft_tpu_torch.models import RAFT

    model = RAFT(cfg)
    model.load_state_dict(weights)
    return model


def dp_train_config(**kw):
    """Drill (c)'s step: the chairs recipe (batch norms trained) at batch
    DP_B, no noise, the clip out of reach so the gradients compared are
    the backward's own (as phase 8's)."""
    return train_config(batch_size=DP_B, add_noise=False,
                        clip=float("inf"), **kw)


def dp_batch(seed: int):
    """DP_B consecutive synthetic chairs-geometry pairs, ground truth their
    shift; rank 0's rows all valid, rank 1's a seeded 30%."""
    H, W = TRAIN_HW
    frames = [np.round(f).astype(np.uint8)
              for f in synthetic_frames(seed, DP_B + 1, TRAIN_HW)]
    valid = np.ones((DP_B, H, W), np.uint8)
    valid[DP_B // 2:] = np.random.RandomState(seed).rand(
        DP_B - DP_B // 2, H, W) < 0.3
    return {"image1": np.stack(frames[:-1]), "image2": np.stack(frames[1:]),
            "flow": np.broadcast_to(np.float32(TRAIN_FLOW),
                                    (DP_B, H, W, 2)).copy(),
            "valid": valid}


def dp_one_rank(cfg, weights, batch, iters: int):
    """The one-rank step on the whole batch: metrics, parameters and
    buffers after it, and the gradients (on the host)."""
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    model = RAFT_for(cfg, weights).cuda()
    tc = dp_train_config(iters=iters)
    m = make_train_step(cfg, tc)(create_train_state(model, tc), batch)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {k: v.cpu() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()}}


#: one-rank steps on DP_B rows, by (model, iters, the frame moved by one
#: ulp or "one"): phase 21's, to which phase 22's basic spatial step on the
#: same weights and rows is held too
DP_REFERENCES = {}


def dp_references(cfg, weights, batch, iters: int, frames=("image1",),
                  name: str = "basic"):
    """The one-rank step of model ``name`` on the whole of ``batch``
    (numpy), and the same step with each of ``frames`` in turn moved by
    one ulp: what rounding alone does. Kept in :data:`DP_REFERENCES` for a
    later phase on the same inputs. Returns ``(one, [witness a
    frame])``."""
    def step(key, moved=None):
        key = (name, iters, key)
        if key not in DP_REFERENCES:
            b = dict(batch)
            if moved:
                b[moved] = np.nextafter(batch[moved].astype(np.float32),
                                        np.float32(np.inf))
            DP_REFERENCES[key] = dp_one_rank(
                cfg, weights, {k: torch.from_numpy(v).cuda()
                               for k, v in b.items()}, iters)
        return DP_REFERENCES[key]

    return step("one"), [step(f, f) for f in frames]


def hold_to_one_rank(name: str, tag: str, ranks, one, one_ulps,
                     ranks_ulps=()) -> dict:
    """Phase 21's rules for ranks' step (each rank's ``metrics``, ``state``
    and ``grads``) against one rank's on the whole batch: the ranks'
    weights bitwise equal; the gradients and the loss by phase 8's one-ulp
    rule (``check_step``, ``across_ranks``); the loss and epe within
    STEP_LOSS_TOL or their one-ulp gap, the grad norm within the gradient
    rule's bound; batch-norm statistics and the new parameters within the
    gap one ulp of input opens (or 1e-5, 2 lr). ``one_ulps``: the one-rank
    step's witnesses (inputs moved by one ulp), each bound the largest of
    theirs; ``ranks_ulps``: rank 0's own witnesses, whose largest gaps to
    the ranks' step are added to every bound (``check_step``'s
    ``ulp2``). Returns each (gap, bound); raises on a gap over its
    bound."""
    if any(same_tree(ranks[0]["state"], r["state"]) for r in ranks[1:]):
        raise RuntimeError(f"{name}: the ranks' weights differ")
    lr0 = dp_train_config().lr / 25

    def grads(r):
        return r["metrics"]["loss"], r["grads"]

    # phase 8's rule (check_step, across_ranks): each gradient within the
    # largest relative gap one ulp of input opens in the one-rank step plus
    # 1e-6 of the model's largest, the median within the one-ulp median;
    # the loss within STEP_LOSS_TOL, or its one-ulp gap where that is
    # larger
    mine = ranks[0]
    check_step(name, grads(one), grads(mine), [grads(u) for u in one_ulps],
               tag=tag, across_ranks=True,
               ulp2=[grads(u) for u in ranks_ulps])
    sides = [(one_ulps, one)] + ([(ranks_ulps, mine)] if ranks_ulps else [])

    def bound(gap):
        """The sum over the sides of the largest witness gap."""
        return sum(max(gap(u, base) for u in us) for us, base in sides)

    # the loss and epe within STEP_LOSS_TOL or their one-ulp gap; the grad
    # norm, a function of the gradients, within the gradient rule's bound:
    # the largest relative gap one ulp of input opens in a parameter's
    # gradient
    grad_tol = bound(lambda u, w: step_gap(grads(u), grads(w))[1])
    g = {}
    for k in ("loss", "grad_norm", "epe"):
        got, want = mine["metrics"][k], one["metrics"][k]
        tol = max(STEP_LOSS_TOL, grad_tol if k == "grad_norm" else bound(
            lambda u, w: abs(u["metrics"][k] - w["metrics"][k])
            / abs(w["metrics"][k])))
        g[k] = (abs(got - want) / abs(want), tol)
    # batch-norm statistics and the new parameters: within the gap one ulp
    # of input opens in the one-rank step, or 1e-5 (statistics) and 2 lr
    # (Adam's first update is ±lr an element, so one whose gradient is at
    # noise level may move the other way)
    for part, floor in (("running", 1e-5), ("params", 2 * lr0 + 1e-6)):
        keys = [k for k in one["state"]
                if ("running_" in k) == (part == "running")
                and not k.endswith("num_batches_tracked")]
        if not keys:        # a model without batch norms
            continue
        got = max(float((mine["state"][k] - one["state"][k])
                        .abs().max()) for k in keys)
        tol = max(floor, bound(lambda u, w: max(
            float((u["state"][k] - w["state"][k]).abs().max())
            for k in keys)))
        g[part] = (got, tol)
    bad = {k: v for k, v in g.items() if not v[0] <= v[1]}
    if bad:
        raise RuntimeError(f"{name}: ranks disagree with one: {bad}")
    return g


def parallel_phase(smi: str) -> dict:
    """Phase 21: JAX-trained ``.msgpack`` weights on the card, and
    data-parallel training (``raft_tpu_torch.parallel``); see the module
    docstring."""
    import socket
    import tempfile

    import torch.distributed as tdist

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.parallel import distributed
    from raft_tpu_torch.parallel.mesh import make_mesh
    from raft_tpu_torch.tools.convert import (flax_from_state_dict,
                                              load_weights, save_converted)
    from raft_tpu_torch.training.trainer import train

    out = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="raft_phase21_")
    try:
        # -- (a) the JAX trainer's weights format ----------------------------
        cfg_s = RAFTConfig(small=True)
        fixture = os.path.join(REPO, "tests", "fixtures",
                               "raft-small-cputrained")
        load_s = {}
        for ext in (".pth", ".msgpack", ".pth", ".msgpack"):
            t0 = time.perf_counter()
            load_weights(fixture + ext, cfg_s)
            load_s.setdefault(ext, []).append(time.perf_counter() - t0)
        frames = demo_frames()[:PAIRS + 1]
        flows = {}
        for ext in (".pth", ".msgpack"):
            model = load_weights(fixture + ext, cfg_s).cuda().eval()
            flows[ext] = run_pairs(model, cfg_s, frames, ITERS)[0]
        path = os.path.join(tmp, "written.msgpack")
        save_converted(flax_from_state_dict(model.state_dict()), path)
        back = load_weights(path, cfg_s).cuda().eval()
        flows["written"] = run_pairs(back, cfg_s, frames, ITERS)[0]
        same = {k: all(np.array_equal(a, b)
                       for a, b in zip(flows[k], flows[".pth"]))
                for k in (".msgpack", "written")}
        out["msgpack"] = {"load_s": load_s, "bitwise": same,
                          "pairs": len(frames) - 1,
                          "flow_max_px": float(max(np.abs(f).max()
                                                   for f in flows[".pth"]))}
        log(f"[21] (a) the small fixture's .msgpack through load_weights: "
            f"{PAIRS} demo pairs at iters {ITERS} bitwise the .pth's: "
            f"{same['.msgpack']}; written by save_converted and read back: "
            f"{same['written']}; load s .pth {load_s['.pth']} .msgpack "
            f"{load_s['.msgpack']}; {smi}")
        if not all(same.values()):
            raise RuntimeError(f".msgpack flow is not the .pth's: {same}")

        # -- (b) NCCL at world size 1 -----------------------------------------
        cfg_b = RAFTConfig(corr_impl="pallas", gru_impl="fused",
                           mixed_precision=True)
        base = train_batch(5)
        batch_b = {k: v[:NCCL_B] for k, v in base.items()}
        finals, step_ms = {}, {}
        for tag in ("mesh-less", "nccl"):
            if tag == "nccl":
                with socket.socket() as sk:
                    sk.bind(("localhost", 0))
                    port = sk.getsockname()[1]
                distributed.initialize(f"localhost:{port}", 1, 0,
                                       backend="nccl")
                mesh = make_mesh()
                out["nccl_mesh"] = repr(mesh)
                if tdist.get_backend() != "nccl" or mesh.group is not None:
                    raise RuntimeError(f"world size 1 over NCCL: {mesh}")
            tc = train_config(batch_size=NCCL_B, num_steps=NCCL_STEPS,
                              val_freq=10 ** 6, lr=2.5e-4, name=tag,
                              checkpoint_dir=os.path.join(tmp, tag),
                              log_dir=os.path.join(tmp, tag, "log"))
            loader = TimedLoader([batch_b] * NCCL_STEPS)
            train(cfg_b, tc, loader=loader, device="cuda")
            marks = np.diff(loader.marks)
            step_ms[tag] = float(np.median(marks)) * 1e3 if len(marks) else 0
            finals[tag] = final_weights(os.path.join(tmp, tag, f"{tag}.pth"))
        tdist.destroy_process_group()
        diff = same_tree(finals["mesh-less"], finals["nccl"])
        out["nccl_world_1"] = {"bitwise": not diff, "steps": NCCL_STEPS,
                               "batch": NCCL_B, "ms_per_step": step_ms}
        log(f"[21] (b) {NCCL_STEPS} bf16 basic steps at batch {NCCL_B}, "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, through initialize (NCCL, world "
            f"size 1) and make_mesh ({out['nccl_mesh']}): final weights "
            f"bitwise the mesh-less trainer's: {not diff}; ms a step "
            f"{step_ms}; {smi}")
        if diff:
            raise RuntimeError(f"NCCL world size 1 moved the weights: {diff}")

        # -- (c) two ranks on one card ----------------------------------------
        from raft_tpu_torch.models import RAFT

        cfg_c = RAFTConfig(corr_impl="pallas", gru_impl="fused",
                           split_encode=True)
        weights = RAFT(cfg_c, torch.Generator().manual_seed(0)).state_dict()
        torch.save(weights, os.path.join(tmp, "weights.pt"))
        batch = dp_batch(21)
        np.savez(os.path.join(tmp, "batch.npz"), **batch)
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, "-c", DP_CHILD, tmp, str(r)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
        finally:
            for p in procs:     # a rank that failed leaves the other hung
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, text in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"a drill rank failed ({p.returncode}):\n"
                                   f"{text[-6000:]}")
        res = [json.loads([ln for ln in text.splitlines()
                           if ln.startswith("{")][-1]) for text in logs]
        gaps = {}
        for iters in DP_ITERS:
            ranks = [torch.load(os.path.join(tmp, f"rank{r}_iters{iters}.pt"))
                     for r in range(2)]
            one, one_ulps = dp_references(cfg_c, weights, batch, iters)
            gaps[f"iters_{iters}"] = hold_to_one_rank(
                f"two ranks against one, iters {iters}", "21", ranks, one,
                one_ulps)
        step_ms = [float(np.median(r["step_ms"])) for r in res]
        reduce_ms = [float(np.median(r["all_reduce_ms"])) for r in res]
        out["two_ranks"] = {
            "gaps": gaps, "step_ms": step_ms, "all_reduce_ms": reduce_ms,
            "all_reduce_share": [a / b for a, b in zip(reduce_ms, step_ms)],
            "grad_mbytes": res[0]["grad_mbytes"],
            "launches": [r["launches"] for r in res],
            "metrics": ranks[0]["metrics"], "one_rank": one["metrics"]}
        log(f"[21] (c) two gloo ranks on cuda:0, the basic chairs step at "
            f"batch {DP_B} ({DP_B // 2} a rank, rank 1's rows 30% valid), "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, iters {DP_ITERS}: ranks' "
            f"weights bitwise equal; against one rank on the whole batch "
            f"(gap, bound): {gaps}; loss {ranks[0]['metrics']['loss']:.6f} "
            f"vs {one['metrics']['loss']:.6f}; a step {step_ms} ms, the "
            f"gradient all-reduce ({res[0]['grad_mbytes']:.1f} MB, gloo "
            f"through the host) {reduce_ms} ms, "
            f"{out['two_ranks']['all_reduce_share']} of the step; launches "
            f"{out['two_ranks']['launches']}; {smi}")
        want = expected_launches(corr_lookup=TRAIN_ITERS,
                                 corr_scatter=TRAIN_ITERS,
                                 gru_gates=2 * TRAIN_ITERS,
                                 gru_blend=2 * TRAIN_ITERS,
                                 gru_gates_bwd=2 * TRAIN_ITERS,
                                 gru_blend_bwd=2 * TRAIN_ITERS)
        if any(r["launches"] != want for r in res):
            raise RuntimeError(f"drill launches {out['two_ranks']['launches']}"
                               f", want {want} a rank")
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 22: the spatial axis
# ---------------------------------------------------------------------------

SP_TIMEOUT_S = 300              # bound on a rank's whole run
SP_SMALL_ITERS = 20             # the trained fixture's iterations in (a)
SP_TIMED = 2                    # (a)'s timed basic pairs after the counted
# (b)'s rounding witnesses on each side: the step with one frame moved by
# one ulp, each frame in turn (at iters 12 random weights amplify
# rounding chaotically, so one sample of it is a loose yardstick)
SP_WITNESSES = ("image1", "image2")
# (b)'s steps, (model, iters): the basic model at iters 1, where its
# random weights are not yet chaotic, and the small trained fixture over
# TRAIN_ITERS (a contracting recurrence: at iters 12 the random-init basic
# model's loss moves with any rounding, PERF.md §6, PR 12)
SP_STEPS = (("basic", 1), ("small", TRAIN_ITERS))
SPATIAL_CHILD = """import json, sys, time
import numpy as np, torch
import torch.distributed as tdist
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from raft_tpu_torch import kernels
from raft_tpu_torch.models import raft as raft_module
from raft_tpu_torch.parallel import distributed
from raft_tpu_torch.parallel.mesh import make_mesh, shard_batch
from raft_tpu_torch.serving import RAFTEngine
from raft_tpu_torch.training.train_step import (create_train_state,
                                                make_train_step)
import chip_smoke as c
d, r = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda:0")
torch.cuda.set_device(dev)
# gloo: NCCL refuses two ranks on one device; gloo carries CUDA tensors
distributed.initialize(f"file://{d}/store", 2, r, backend="gloo")
mesh = make_mesh(spatial=2)
pair = dict(np.load(d + "/pair.npz"))
built = c.record_pyramids(raft_module)
out = {"rank": r, "mesh": repr(mesh), "engine": {}, "train": {}}
flows = {}
# (a) the sharded engine at 1080x1920
for name, cfg, weights, iters in c.sp_models(d):
    eng = RAFTEngine(weights, cfg, iters=iters, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    flows[name] = eng.infer_batch(pair["image1"], pair["image2"])
    torch.cuda.synchronize()
    e = {"first_ms": (time.perf_counter() - t0) * 1e3,
         "launches": kernels.launch_counts(),
         "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
         "pyramid_bytes": built[-1], "stats": eng.aot_stats()}
    if name == "basic":
        ms = []
        for _ in range(c.SP_TIMED):
            distributed.barrier()
            t0 = time.perf_counter()
            eng.infer_batch(pair["image1"], pair["image2"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        e["ms"] = ms
        # every all-reduce timed alone (the card synchronised first): the
        # halos, the norms' sums, the fmap2 gather and the output gather
        spent = []
        real = tdist.all_reduce
        def timed(t, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real(t, *a, **k)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0,
                          t.numel() * t.element_size()))
            return res
        tdist.all_reduce = timed
        distributed.barrier()
        t0 = time.perf_counter()
        eng.infer_batch(pair["image1"], pair["image2"])
        torch.cuda.synchronize()
        e["instrumented_ms"] = (time.perf_counter() - t0) * 1e3
        tdist.all_reduce = real
        e["all_reduce_ms"] = sum(t for t, _ in spent) * 1e3
        e["all_reduces"] = len(spent)
        e["all_reduce_mbytes"] = sum(b for _, b in spent) / 1e6
    out["engine"][name] = e
    del eng
# (b) the spatial train step on phase 21's rows
whole = dict(np.load(d + "/batch.npz"))
# the step, and its witnesses: each frame moved by one ulp
runs = [("", shard_batch(whole, mesh))] + [
    ("_" + f, shard_batch(dict(whole, **{f: np.nextafter(
        whole[f].astype(np.float32), np.float32(np.inf))}), mesh))
    for f in c.SP_WITNESSES]
for name, iters in c.SP_STEPS:
    cfg, weights = c.sp_step_model(d, name)
    for tag, rows in runs:
        model = c.RAFT_for(cfg, weights).to(dev)
        tc = c.dp_train_config(iters=iters)
        state = create_train_state(model, tc)
        step = make_train_step(cfg, tc, mesh)
        distributed.barrier()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(state, rows)
        torch.cuda.synchronize()
        if not tag:
            out["train"][name] = {"ms": (time.perf_counter() - t0) * 1e3,
                                  "launches": kernels.launch_counts()}
        torch.save({"metrics": {k: float(v) for k, v in m.items()},
                    "state": {k: v.cpu()
                              for k, v in model.state_dict().items()},
                    "grads": {k: p.grad.cpu() for k, p in
                              model.named_parameters()}},
                   f"{d}/rank{r}_{name}{tag}.pt")
torch.save(flows, f"{d}/flows{r}.pt")
print(json.dumps(out), flush=True)
"""


def record_pyramids(raft_module) -> list:
    """From now on, the bytes of every correlation pyramid the model
    module builds, appended to the list returned."""
    built = []
    real = raft_module.build_corr_pyramid

    def build(*a, **k):
        levels = real(*a, **k)
        built.append(sum(v.nbytes for v in levels))
        return levels

    raft_module.build_corr_pyramid = build
    return built


def sp_models(d: str):
    """(a)'s two models: ``(name, config, weights, iters)``, the basic one
    (``pallas`` + ``fused``) from ``d/weights.pt`` at iters 1, the small
    trained fixture at SP_SMALL_ITERS."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.tools.convert import load_pth

    basic = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    small = RAFTConfig(small=True, corr_impl="pallas")
    fixture = os.path.join(REPO, "tests", "fixtures",
                           "raft-small-cputrained.pth")
    return [("basic", basic, torch.load(os.path.join(d, "weights.pt")), 1),
            ("small", small, load_pth(fixture, small).state_dict(),
             SP_SMALL_ITERS)]


def sp_train_cfg():
    """(b)'s basic step: phase 21 (c)'s config, so its one-rank steps
    serve."""
    from raft_tpu_torch.config import RAFTConfig

    return RAFTConfig(corr_impl="pallas", gru_impl="fused",
                      split_encode=True)


def sp_step_model(d: str, name: str):
    """(b)'s ``(config, weights)`` of ``name`` (SP_STEPS): the basic
    model's from ``d/weights.pt``, the small trained fixture's."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.tools.convert import load_pth

    if name == "basic":
        return sp_train_cfg(), torch.load(os.path.join(d, "weights.pt"))
    cfg = RAFTConfig(small=True, corr_impl="pallas", split_encode=True)
    fixture = os.path.join(REPO, "tests", "fixtures",
                           "raft-small-cputrained.pth")
    return cfg, load_pth(fixture, cfg).state_dict()


def spatial_phase(smi: str) -> dict:
    """Phase 22: the ``spatial`` mesh axis (``parallel.halo``,
    ``RAFTEngine(mesh=)``, the train step over bands); see the module
    docstring."""
    import tempfile

    from raft_tpu_torch import kernels
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.models import raft as raft_module
    from raft_tpu_torch.serving import RAFTEngine

    out = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="raft_phase22_")
    t_phase = time.perf_counter()
    real_build = None
    try:
        frames = synthetic_frames(22, 2, HD_HW)
        pair = {"image1": frames[0][None], "image2": frames[1][None]}
        np.savez(os.path.join(tmp, "pair.npz"), **pair)
        cfg_t = sp_train_cfg()
        weights = RAFT(cfg_t, torch.Generator().manual_seed(0)).state_dict()
        torch.save(weights, os.path.join(tmp, "weights.pt"))
        batch = dp_batch(21)
        np.savez(os.path.join(tmp, "batch.npz"), **batch)
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, "-c", SPATIAL_CHILD, tmp, str(r)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SP_TIMEOUT_S)[0])
        finally:
            for p in procs:     # a rank that failed leaves the other hung
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, text in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"a spatial rank failed ({p.returncode})"
                                   f":\n{text[-6000:]}")
        res = [json.loads([ln for ln in text.splitlines()
                           if ln.startswith("{")][-1]) for text in logs]
        t_ranks = time.perf_counter() - t_phase

        # -- (a) against the one-device engine on the same card ------------
        flows = [torch.load(os.path.join(tmp, f"flows{r}.pt"),
                            weights_only=False) for r in range(2)]
        real_build = raft_module.build_corr_pyramid
        built = record_pyramids(raft_module)
        engine = {}
        # the sharded engine's bucket: its height rounded to 8·spatial
        bucket = (1, -(-HD_HW[0] // 16) * 16, HD_HW[1])
        for name, cfg, w, iters in sp_models(tmp):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # built (and captured) here, under the peak's window
            eng = RAFTEngine(w, cfg, iters=iters, envelope=[bucket])
            want = eng.infer_batch(pair["image1"], pair["image2"])
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            t0 = time.perf_counter()
            eng.infer_batch(pair["image1"], pair["image2"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            tol = BASIC_STEP_TOL if name == "basic" else SMALL_TOL
            err = float(np.abs(flows[0][name] - want).max())
            ranks = [r["engine"][name] for r in res]
            engine[name] = {
                "max_abs_err_px": err, "tol_px": tol, "iters": iters,
                "flow_max_px": float(np.abs(want).max()),
                "ranks_bitwise": bool(np.array_equal(flows[0][name],
                                                     flows[1][name])),
                "peak_mib_rank": [e["peak_mib"] for e in ranks],
                "peak_mib_one_device": peak,
                "pyramid_bytes_rank": [e["pyramid_bytes"] for e in ranks],
                "pyramid_bytes_one_device": built[0],
                "one_device_ms": ms, "first_ms_rank": [e["first_ms"]
                                                       for e in ranks],
                "launches": [e["launches"] for e in ranks],
                "captures_rank": [e["stats"]["captures"] for e in ranks]}
            if name == "basic":
                ms_rank = [float(np.median(e["ms"])) for e in ranks]
                engine[name].update(
                    ms_rank=ms_rank,
                    instrumented_ms_rank=[e["instrumented_ms"]
                                          for e in ranks],
                    all_reduce_ms_rank=[e["all_reduce_ms"] for e in ranks],
                    all_reduces=ranks[0]["all_reduces"],
                    all_reduce_mbytes=ranks[0]["all_reduce_mbytes"],
                    all_reduce_share=[e["all_reduce_ms"]
                                      / e["instrumented_ms"]
                                      for e in ranks])
            built.clear()
            del eng
            g = engine[name]
            log(f"[22] (a) {name}, {HD_HW[0]}x{HD_HW[1]} (bucket {bucket}, "
                f"{bucket[1] // 16} feature rows a band), iters {iters}, "
                f"two gloo ranks through RAFTEngine(mesh=(1, 2)): "
                f"{err:.3e} px from the one-device engine (tol {tol}, "
                f"largest |flow| {g['flow_max_px']:.2f}), ranks bitwise "
                f"{g['ranks_bitwise']}; pyramid bytes a rank "
                f"{g['pyramid_bytes_rank']} vs "
                f"{g['pyramid_bytes_one_device']} one device; peak MiB a rank {g['peak_mib_rank']} vs "
                f"{peak:.0f}; "
                + (f"ms a pair a rank {g['ms_rank']} (one device, a "
                   f"replay, {ms:.2f}), all-reduces {g['all_reduces']} a "
                   f"pair ({g['all_reduce_mbytes']:.1f} MB) taking "
                   f"{g['all_reduce_ms_rank']} ms, "
                   f"{g['all_reduce_share']} of the instrumented pair; "
                   if name == "basic" else "")
                + f"launches {g['launches']}; {smi}")
            if not (err <= tol and g["ranks_bitwise"]):
                raise RuntimeError(f"spatial engine {name}: {err} px "
                                   f"(tol {tol}), ranks bitwise "
                                   f"{g['ranks_bitwise']}")
            if any(2 * b != g["pyramid_bytes_one_device"]
                   for b in g["pyramid_bytes_rank"]):
                raise RuntimeError(f"spatial engine {name}: a rank's pyramid"
                                   f" {g['pyramid_bytes_rank']} is not half "
                                   f"of {g['pyramid_bytes_one_device']}")
            want_launches = (
                expected_launches(corr_lookup=1, gru_gates=2, gru_blend=2)
                if name == "basic"
                else expected_launches(corr_lookup=SP_SMALL_ITERS))
            if any(n != want_launches for n in g["launches"]) or any(
                    g["captures_rank"]):
                raise RuntimeError(f"spatial engine {name} launches "
                                   f"{g['launches']}, want {want_launches} "
                                   f"a rank; captures {g['captures_rank']}")
        out["engine"] = engine

        # -- (b) the spatial train step against one rank --------------------
        gaps, losses, want = {}, {}, {
            "basic": expected_launches(corr_lookup=1, corr_scatter=1,
                                       gru_gates=2, gru_blend=2,
                                       gru_gates_bwd=2, gru_blend_bwd=2),
            "small": expected_launches(corr_lookup=TRAIN_ITERS,
                                       corr_scatter=TRAIN_ITERS)}
        for name, iters in SP_STEPS:
            ranks = [torch.load(os.path.join(tmp, f"rank{r}_{name}.pt"))
                     for r in range(2)]
            cfg, w = sp_step_model(tmp, name)
            one, one_ulps = dp_references(cfg, w, batch, iters,
                                          SP_WITNESSES, name)
            # the bands round every conv and norm another way than one
            # rank does: their own one-ulp steps witness their side
            ranks_ulps = [torch.load(os.path.join(
                tmp, f"rank0_{name}_{f}.pt")) for f in SP_WITNESSES]
            gaps[name] = hold_to_one_rank(
                f"two spatial ranks against one, {name}, iters {iters}",
                "22", ranks, one, one_ulps, ranks_ulps)
            losses[name] = (ranks[0]["metrics"]["loss"],
                            one["metrics"]["loss"])
        train = {"gaps": gaps, "loss_ranks_one": losses,
                 "ms_rank": {n: [r["train"][n]["ms"] for r in res]
                             for n, _ in SP_STEPS},
                 "launches": {n: [r["train"][n]["launches"] for r in res]
                              for n, _ in SP_STEPS}}
        out["train"] = train
        log(f"[22] (b) two spatial gloo ranks on cuda:0, the chairs step "
            f"at batch {DP_B}, {TRAIN_HW[0]}x{TRAIN_HW[1]} "
            f"({TRAIN_HW[0] // 16} feature rows a band), {SP_STEPS}: "
            f"ranks' weights bitwise equal; against one rank on the whole "
            f"batch (gap, bound): {gaps}; a step (one run each) "
            f"{train['ms_rank']} ms; launches {train['launches']}; {smi}")
        for name, runs in train["launches"].items():
            if any(n != want[name] for n in runs):
                raise RuntimeError(f"spatial {name} step launches {runs}, "
                                   f"want {want[name]} a rank")
        # (c) every counted run's launches, both ranks
        out["launches_spatial"] = {
            k: sum(e[k] for g in engine.values() for e in g["launches"])
            + sum(n[k] for runs in train["launches"].values() for n in runs)
            for k in want["basic"]}
        out["seconds"] = {"ranks": t_ranks,
                          "phase": time.perf_counter() - t_phase}
        out["meshes"] = [r["mesh"] for r in res]
        log(f"[22] (c) launches, both ranks' counted runs: "
            f"{out['launches_spatial']}; the ranks took {t_ranks:.1f} s, "
            f"the phase {out['seconds']['phase']:.1f} s")
    finally:
        if real_build is not None:
            raft_module.build_corr_pyramid = real_build
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 23: follower ranks
# ---------------------------------------------------------------------------

FW_TIMEOUT_S = 300              # bound on a rank's whole run
FW_SHARD_PAIRS = 4              # 1080x1920 pairs, the "shard" route
FW_REPL_PAIRS = 16              # 368x496 pairs, the "replicate" route
FW_BATCH = 4                    # max_batch: the replicate bucket's batch
FW_REPL_HW = TRAIN_HW
FW_SHARD_BUCKET = (1, -(-HD_HW[0] // 16) * 16, HD_HW[1])
FW_REPL_BUCKET = (FW_BATCH,) + FW_REPL_HW
FW_GATHER_S = 0.05
FW_KILL_TIMEOUT_S = 30.0        # the kill drill's watchdog deadline
FW_KILL_PAIRS = 6               # the kill drill's requests (2 shard)
FOLLOW_CHILD = """import json, os, sys, time
import numpy as np, torch
import torch.distributed as tdist
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from raft_tpu_torch import kernels
from raft_tpu_torch.parallel import distributed, follow
from raft_tpu_torch.parallel.mesh import make_mesh
from raft_tpu_torch.serving import RAFTEngine
import chip_smoke as c
d, r = sys.argv[1], int(sys.argv[2])
torch.cuda.set_device(torch.device("cuda:0"))
distributed.initialize(f"file://{d}/store", 2, r, backend="gloo")
pids = [None, None]
tdist.all_gather_object(pids, os.getpid())
mesh = make_mesh(spatial=2)
x = dict(np.load(d + "/pairs.npz"))
out = {"rank": r, "mesh": repr(mesh), "sessions": {}}
flows = {}
for name, cfg, weights, iters in c.sp_models(d):
    eng = RAFTEngine(weights, cfg, iters=iters, mesh=mesh, wire="u8",
                     envelope=[c.FW_SHARD_BUCKET, c.FW_REPL_BUCKET])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if r == 0:
        s, flows[name] = c.fw_primary(name, eng, x, d)
    else:
        got = []
        ends = follow.follow(eng, on_output=lambda e, f: got.append(f))
        flows[name] = [row for f in got for row in f]
        s = {"engines": {str(k): v["weights_version"]
                         for k, v in ends.items()},
             "dispatches": sum(v["dispatches"] for v in ends.values())}
    torch.cuda.synchronize()
    s["seconds"] = time.perf_counter() - t0
    s["launches"] = kernels.launch_counts()
    out["sessions"][name] = s
    del eng
torch.save(flows, f"{d}/flows{r}.pt")
print(json.dumps(out), flush=True)
# (c) the kill drill: rank 1 SIGKILLed with futures in flight
name, cfg, weights, iters = c.sp_models(d)[0]
eng = RAFTEngine(weights, cfg, iters=iters, mesh=mesh, wire="u8",
                 envelope=[c.FW_SHARD_BUCKET, c.FW_REPL_BUCKET])
if r == 0:
    print(json.dumps({"kill": c.fw_kill(eng, x, pids[1])}), flush=True)
else:
    follow.follow(eng)
sys.stdout.flush()
os._exit(0)     # a process group a dead peer left cannot be torn down
"""


def fw_pairs():
    """The seeded u8 frames: FW_SHARD_PAIRS 1080x1920 pairs and
    FW_REPL_PAIRS 368x496 pairs."""
    hd = [np.round(f).astype(np.uint8)
          for f in synthetic_frames(23, FW_SHARD_PAIRS + 1, HD_HW)]
    sm = [np.round(f).astype(np.uint8)
          for f in synthetic_frames(24, FW_REPL_PAIRS + 1, FW_REPL_HW)]
    return {"hd1": np.stack(hd[:-1]), "hd2": np.stack(hd[1:]),
            "sm1": np.stack(sm[:-1]), "sm2": np.stack(sm[1:])}


def fw_waves(name: str):
    """A session's waves: ``(wave, swap to, shard pair indices, replicate
    pair indices)``; (a) swaps between its two halves."""
    if name != "basic":
        return [("a", None, list(range(FW_SHARD_PAIRS)), [])]
    hs, hr = FW_SHARD_PAIRS // 2, FW_REPL_PAIRS // 2
    return [("a", None, list(range(hs)), list(range(hr))),
            ("b", "weights_b.pt", list(range(hs, 2 * hs)),
             list(range(hr, 2 * hr)))]


def _pct(v, q):
    return float(np.percentile(v, q)) if v else None


def fw_primary(name: str, eng, x, d: str):
    """Rank 0's session: the leading engine under a scheduler with one
    replica lane; every future's flow, latency and route. Returns the
    numbers and the flows (by route, in submission order)."""
    from raft_tpu_torch.parallel import follow
    from raft_tpu_torch.parallel.placement import Placement
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    channel = follow.lead(eng)
    # each dispatch of the primary engine, from its call until the card
    # is done with it
    real = eng.infer_batch_async
    spans = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        pending = real(*a, **k)
        torch.cuda.synchronize()
        spans.append((pending.bucket, time.perf_counter() - t0))
        return pending
    eng.infer_batch_async = timed
    t_spawn = time.perf_counter()
    sched = MicroBatchScheduler(
        eng, max_batch=FW_BATCH, gather_window_s=FW_GATHER_S,
        placement=Placement(eng, replicas=2,
                            shard_px_threshold=HD_HW[0] * HD_HW[1]))
    spawn_s = time.perf_counter() - t_spawn
    routes = {"shard": sched.placement.decide(HD_HW),
              "replicate": sched.placement.decide(FW_REPL_HW)}
    lat = {"shard": [], "replicate": []}
    flows = {"shard": [], "replicate": []}
    span = {"shard": [None, None], "replicate": [None, None]}
    swap_s = None
    for wave, swap, hd, sm in fw_waves(name):
        if swap is not None:
            t0 = time.perf_counter()
            sched.update_weights(torch.load(os.path.join(d, swap)))
            swap_s = time.perf_counter() - t0
        futs = []
        for route, idx, a, b in (("shard", hd, "hd1", "hd2"),
                                 ("replicate", sm, "sm1", "sm2")):
            for i in idx:
                futs.append((route, time.perf_counter(),
                             sched.submit(x[a][i], x[b][i])))
        for route, t0, f in futs:
            flows[route].append(f.result(timeout=FW_TIMEOUT_S).flow)
            t1 = time.perf_counter()
            lat[route].append((t1 - t0) * 1e3)
            first, last = span[route]
            span[route] = [t0 if first is None else min(first, t0),
                           t1 if last is None else max(last, t1)]
    lanes = [lane.dispatches for lane in sched._lanes]
    sched.close()
    stats = dict(channel.stats)
    shard_ms = [t * 1e3 for b, t in spans if tuple(b) == FW_SHARD_BUCKET]
    out = {"routes": routes, "spawn_s": spawn_s, "swap_s": swap_s,
           "lane_dispatches": lanes, "channel": stats,
           "closed": channel.closed,
           "engines": {str(e._eid): e.weights_version
                       for e in sched.placement.engines}}
    for route, ms in lat.items():
        if not ms:
            continue
        first, last = span[route]
        out[route] = {"pairs": len(ms), "pairs_per_s": len(ms) / (last - first),
                      "p50_ms": _pct(ms, 50), "p99_ms": _pct(ms, 99)}
    key = "infer {}x{}x{}".format(*FW_SHARD_BUCKET)
    if key in stats:
        n, nbytes, sec = stats[key]
        out["shard_channel"] = {
            "dispatches": n, "mbytes_per_dispatch": nbytes / n / 1e6,
            "ms_per_dispatch": sec / n * 1e3,
            "pair_ms": shard_ms, "pair_ms_median": _pct(shard_ms, 50),
            "share_of_pair": sec / n * 1e3 / _pct(shard_ms, 50)}
    key = "infer {}x{}x{}".format(*FW_REPL_BUCKET)
    repl_ms = [t * 1e3 for b, t in spans if tuple(b) == FW_REPL_BUCKET]
    if key in stats:
        n, nbytes, sec = stats[key]
        out["replicate_channel"] = {
            "dispatches": n, "mbytes_per_dispatch": nbytes / n / 1e6,
            "ms_per_dispatch": sec / n * 1e3,
            # the primary lane's replicate dispatches (the replica's are
            # not timed)
            "dispatch_ms_primary": repl_ms}
    return out, flows


def fw_kill(eng, x, pid: int) -> dict:
    """(c): the scheduler over the leading engine and a replica lane,
    FW_KILL_PAIRS requests (two 1080x1920, the rest 368x496), rank 1
    SIGKILLed once the first dispatch is announced: each future's settle
    (seconds after the SIGKILL, its error) and the close's seconds."""
    import signal

    from raft_tpu_torch.parallel import follow
    from raft_tpu_torch.parallel.placement import Placement
    from raft_tpu_torch.serving.scheduler import MicroBatchScheduler

    channel = follow.lead(eng)
    sched = MicroBatchScheduler(
        eng, max_batch=FW_BATCH, gather_window_s=FW_GATHER_S,
        dispatch_timeout_s=FW_KILL_TIMEOUT_S,
        placement=Placement(eng, replicas=2,
                            shard_px_threshold=HD_HW[0] * HD_HW[1]))
    settled = []
    futs = []
    for i in range(FW_KILL_PAIRS):
        a, b = (("hd1", "hd2") if i < 2 else ("sm1", "sm2"))
        f = sched.submit(x[a][i % 2], x[b][i % 2])
        f.add_done_callback(lambda f: settled.append((
            time.perf_counter(), None if f.exception() is None
            else type(f.exception()).__name__)))
        futs.append(f)
    t_wait = time.perf_counter()
    while channel.stats.get("infer", [0])[0] < 1:
        if time.perf_counter() - t_wait > FW_TIMEOUT_S / 2:
            raise RuntimeError("no dispatch announced for the kill drill")
        time.sleep(0.01)
    pending = sum(not f.done() for f in futs)
    t_kill = time.perf_counter()
    os.kill(pid, signal.SIGKILL)
    for f in futs:
        try:
            f.result(timeout=FW_KILL_TIMEOUT_S + 30)
        except Exception:  # noqa: BLE001 — the drill's errors
            pass
    t0 = time.perf_counter()
    sched.close(timeout=60)
    return {"futures": len(futs), "pending_at_kill": pending,
            "settled": [(t - t_kill, e) for t, e in settled],
            "settled_once": len(settled) == len(futs),
            "close_s": time.perf_counter() - t0,
            "channel_failed": repr(channel.failed)[:200]}


def follow_phase(smi: str) -> dict:
    """Phase 23: follower ranks (``parallel.follow``); see the module
    docstring."""
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving import RAFTEngine

    out = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="raft_phase23_")
    t_phase = time.perf_counter()
    try:
        x = fw_pairs()
        np.savez(os.path.join(tmp, "pairs.npz"), **x)
        from raft_tpu_torch.config import RAFTConfig

        basic = RAFTConfig(corr_impl="pallas", gru_impl="fused")
        torch.save(RAFT(basic, torch.Generator().manual_seed(0)).state_dict(),
                   os.path.join(tmp, "weights.pt"))
        torch.save(RAFT(basic, torch.Generator().manual_seed(1)).state_dict(),
                   os.path.join(tmp, "weights_b.pt"))
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, "-c", FOLLOW_CHILD, tmp, str(r)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=FW_TIMEOUT_S)[0])
        finally:
            for p in procs:     # a rank that failed leaves the other hung
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if procs[0].returncode != 0 or procs[1].returncode != -9:
            raise RuntimeError(
                f"follower ranks ended {[p.returncode for p in procs]} "
                f"(want 0, and -9 from the kill drill):\n"
                f"{logs[0][-6000:]}\n{logs[1][-3000:]}")
        lines = [[json.loads(ln) for ln in text.splitlines()
                  if ln.startswith("{")] for text in logs]
        res = [ln[0] for ln in lines]
        kill = lines[0][1]["kill"]
        t_ranks = time.perf_counter() - t_phase

        # -- (a), (b) against one-device engines on the same card ----------
        flows = [torch.load(os.path.join(tmp, f"flows{r}.pt"),
                            weights_only=False) for r in range(2)]
        sessions = {}
        for name, cfg, w, iters in sp_models(tmp):
            prim = res[0]["sessions"][name]
            got = flows[0][name]
            eng = RAFTEngine(w, cfg, iters=iters, wire="u8",
                             envelope=[FW_SHARD_BUCKET, FW_REPL_BUCKET],
                             precompile=False)
            errs = {route: 0.0 for route in ("shard", "replicate")
                    if got[route]}
            k = {"shard": 0, "replicate": 0}
            for wave, swap, hd, sm in fw_waves(name):
                if swap is not None:
                    eng.update_weights(torch.load(os.path.join(tmp, swap)))
                for i in hd:
                    want = eng.infer_batch(x["hd1"][i:i + 1],
                                           x["hd2"][i:i + 1])[0]
                    errs["shard"] = max(errs["shard"], float(np.abs(
                        got["shard"][k["shard"]] - want).max()))
                    k["shard"] += 1
                for j in range(0, len(sm), FW_BATCH):
                    rows = sm[j:j + FW_BATCH]
                    want = eng.infer_batch(x["sm1"][rows], x["sm2"][rows])
                    for row in want:
                        errs["replicate"] = max(errs["replicate"], float(
                            np.abs(got["replicate"][k["replicate"]]
                                   - row).max()))
                        k["replicate"] += 1
            del eng
            tol = BASIC_STEP_TOL if name == "basic" else SMALL_TOL
            mine = sorted(np.ascontiguousarray(f).tobytes()
                          for f in got["shard"] + got["replicate"])
            theirs = sorted(np.ascontiguousarray(f).tobytes()
                            for f in flows[1][name])
            g = dict(prim, max_abs_err_px=errs, tol_px=tol, iters=iters,
                     ranks_bitwise=mine == theirs,
                     follower=res[1]["sessions"][name],
                     launches=[r["sessions"][name]["launches"]
                               for r in res])
            g.pop("channel")
            g["channel_ops"] = {n: v[0] for n, v in prim["channel"].items()}
            sessions[name] = g
            log(f"[23] ({'a' if name == 'basic' else 'b'}) {name}, iters "
                f"{iters}, two gloo ranks, rank 1 following: routes "
                f"{g['routes']}; against one-device engines (tol {tol}) "
                f"{errs} px; ranks bitwise {g['ranks_bitwise']}; "
                + "; ".join(f"{route} {g[route]['pairs']} pairs "
                            f"{g[route]['pairs_per_s']:.3f} pairs/s, p50 "
                            f"{g[route]['p50_ms']:.1f} ms, p99 "
                            f"{g[route]['p99_ms']:.1f} ms"
                            for route in ("shard", "replicate")
                            if route in g)
                + f"; channel a shard dispatch {g.get('shard_channel')}; "
                f"a replicate dispatch {g.get('replicate_channel')}; "
                f"spawn {g['spawn_s']:.3f} s, swap {g['swap_s']}; lane "
                f"dispatches {g['lane_dispatches']}; launches "
                f"{g['launches']}; {smi}")
            if not (max(errs.values()) <= tol and g["ranks_bitwise"]
                    and g["closed"]
                    and g["routes"] == {"shard": "shard",
                                        "replicate": "replicate"}):
                raise RuntimeError(f"follower session {name}: {errs} px "
                                   f"(tol {tol}), ranks bitwise "
                                   f"{g['ranks_bitwise']}, closed "
                                   f"{g['closed']}, routes {g['routes']}")
            if g["follower"]["engines"] != g["engines"]:
                raise RuntimeError(f"follower session {name}: engines "
                                   f"{g['follower']['engines']} against "
                                   f"{g['engines']}")
            need = (("corr_lookup", "gru_gates", "gru_blend")
                    if name == "basic" else ("corr_lookup",))
            if any(n[k] == 0 for n in g["launches"] for k in need):
                raise RuntimeError(f"follower session {name}: a rank "
                                   f"launched no {need}: {g['launches']}")
        out["sessions"] = sessions
        out["launches_follow"] = [
            {k: sum(s["launches"][r][k] for s in sessions.values())
             for k in sessions["basic"]["launches"][r]} for r in range(2)]

        # -- (c) the kill drill ---------------------------------------------
        late = [t for t, _ in kill["settled"]]
        kill["last_settle_s"] = max(late) if late else None
        out["kill"] = kill
        errors = [e for t, e in kill["settled"] if t >= 0]
        log(f"[23] (c) rank 1 SIGKILLed with {kill['pending_at_kill']} of "
            f"{kill['futures']} futures pending: settled once "
            f"{kill['settled_once']}, errors {errors}, the last "
            f"{kill['last_settle_s']:.3f} s after the SIGKILL; close "
            f"{kill['close_s']:.3f} s; channel {kill['channel_failed']}")
        if not (kill["settled_once"] and kill["pending_at_kill"]
                and all(e is not None for e in errors)
                and len(errors) >= kill["pending_at_kill"]
                and kill["last_settle_s"] <= FW_KILL_TIMEOUT_S + 10):
            raise RuntimeError(f"the kill drill: {kill}")
        out["seconds"] = {"ranks": t_ranks,
                          "phase": time.perf_counter() - t_phase}
        out["meshes"] = [r["mesh"] for r in res]
        log(f"[23] launches a rank {out['launches_follow']}; the ranks took "
            f"{t_ranks:.1f} s, the phase {out['seconds']['phase']:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    return out


VIDEO_PSNR_MIN = 33.93          # dB: cv2's MJPG writer on frame_0016, 4:2:0
VIDEO_ITERS = 20                # the parity and demo CLIs' default iters
LOADER_NUMPY_PAIRS_S = 18.39    # phase 16's loader_bench on the numpy .flo
                                # reader (PERF.md §5)
NATIVE_FLO_HW = (436, 1024)
NATIVE_PFM_SHAPE = (540, 960, 3)


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse)) if mse else float("inf")


def video_phase(smi: str, loader: dict) -> dict:
    """Phase 24: JPEG frames in, the MJPG flow video out, and the native
    flow codec; see the module docstring. ``loader`` is phase 16's
    ``loader_bench`` result."""
    import contextlib
    import io

    from raft_tpu_torch import kernels, native
    from raft_tpu_torch.cli.demo import flow_pairs
    from raft_tpu_torch.cli.demo import main as demo_main
    from raft_tpu_torch.cli.parity import main as parity_main
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.data import frame_utils as fu
    from raft_tpu_torch.data.jpeg import (DEFAULT_QUALITY, decode_jpeg,
                                          write_jpeg)
    from raft_tpu_torch.data.png import read_png
    from raft_tpu_torch.evaluation.evaluate import make_forward
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.testing.avi import read_mjpg_avi
    from raft_tpu_torch.tools.convert import load_weights, save_pth
    from raft_tpu_torch.utils.flow_viz import flow_to_image

    out = {}
    names = sorted(glob.glob(os.path.join(REPO, "demo-frames", "*.png")))
    pngs = [read_png(f) for f in names]
    pairs = len(pngs) - 1
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="raft_phase24_")
    try:
        # -- (a) the codec on demo-frames ------------------------------------
        settings = {"default": (DEFAULT_QUALITY, "4:2:0"),
                    "q95_444": (95, "4:4:4")}
        codec = {}
        for tag, (q, sub) in settings.items():
            d = os.path.join(tmp, tag)
            os.makedirs(d)
            enc, dec, worst = [], [], float("inf")
            for name, img in zip(names, pngs):
                path = os.path.join(d, os.path.basename(name)[:-4] + ".jpg")
                t0 = time.perf_counter()
                write_jpeg(path, img, q, sub)
                enc.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                back = fu.read_gen(path)
                dec.append((time.perf_counter() - t0) * 1e3)
                worst = min(worst, psnr(back, img))
            codec[tag] = {"quality": q, "subsampling": sub,
                          "worst_psnr_db": worst,
                          "encode_ms": float(np.median(enc)),
                          "decode_ms": float(np.median(dec)),
                          "bytes": sum(os.path.getsize(p) for p in
                                       glob.glob(os.path.join(d, "*.jpg")))}
            log(f"[24] (a) write_jpeg q{q} {sub} over demo-frames: worst "
                f"PSNR {worst:.2f} dB against the PNG (bound "
                f"{VIDEO_PSNR_MIN}), encode {codec[tag]['encode_ms']:.1f} ms, "
                f"read_gen decode {codec[tag]['decode_ms']:.1f} ms a 436x1024 "
                f"frame (medians, host clock), {codec[tag]['bytes']} bytes "
                f"for 10; {smi}")
            if not worst >= VIDEO_PSNR_MIN:
                raise RuntimeError(f"write_jpeg {tag}: PSNR {worst:.2f} dB")
        out["codec"] = codec
        jpeg_dir = os.path.join(tmp, "default")
        jpegs = [fu.read_gen(p) for p in
                 sorted(glob.glob(os.path.join(jpeg_dir, "*.jpg")))]

        # -- (b) cli/parity over the JPEG frames, with the video -------------
        fixture = os.path.join(REPO, "tests", "fixtures",
                               "raft-small-cputrained.pth")
        avi = os.path.join(tmp, "flow.avi")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            par, flows = parity_main(["--model", fixture, "--small",
                                      "--path", jpeg_dir, "--video", avi,
                                      "--corr_impl", "pallas"])
        par_s = time.perf_counter() - t0
        par_launches = kernels.launch_counts()
        video = read_mjpg_avi(avi)
        frames = [decode_jpeg(f) for f in video.frames]
        want_hw = (2 * FRAME_HW[0], FRAME_HW[1])
        psnrs = [psnr(f, np.concatenate([j, flow_to_image(fl)], axis=0))
                 for f, j, fl in zip(frames, jpegs, flows)]
        out["parity"] = {
            "pairs": par["pairs"], "max_diff_px": par["max_diff_px"],
            "ms_plain_median": par["ms_plain_median"],
            "ms_engine_median": par["ms_engine_median"],
            "captures": par["captures"], "seconds": par_s,
            "launches": {k: v for k, v in par_launches.items() if v},
            "replayed_launches": par["replayed_launches"],
            "video": {"frames": len(frames), "fps": video.fps,
                      "size": list(video.size),
                      "bytes": os.path.getsize(avi),
                      "psnr_db_min": min(psnrs), "psnr_db": psnrs}}
        log(f"[24] (b) python -m raft_tpu_torch.cli.parity --small --path "
            f"<{pairs + 1} JPEG frames> --video: largest difference "
            f"{par['max_diff_px']:.3e} px (tol {SMALL_TOL:g}); ms a pair "
            f"plain {par['ms_plain_median']:.2f}, engine "
            f"{par['ms_engine_median']:.2f}; captures {par['captures']}; "
            f"launches {out['parity']['launches']} (wrapper calls: plain "
            f"path, the capture's warm-up and the capture) and replayed "
            f"{par['replayed_launches']}; the AVI: {len(frames)} frames of "
            f"{video.size[0]}x{video.size[1]} at {video.fps:g} fps, "
            f"{out['parity']['video']['bytes']} bytes, PSNR against "
            f"flow_to_image under the frame {min(psnrs):.2f}-{max(psnrs):.2f}"
            f" dB (bound {VIDEO_PSNR_MIN}); {par_s:.1f} s; {smi}")
        if not par["max_diff_px"] <= SMALL_TOL:
            raise RuntimeError("cli/parity on JPEG frames: the engine "
                               "disagrees with plain")
        if not (len(frames) == pairs and video.fps == 30.0
                and tuple(video.size) == (want_hw[1], want_hw[0])
                and all(f.shape == want_hw + (3,) for f in frames)
                and min(psnrs) >= VIDEO_PSNR_MIN):
            raise RuntimeError(f"the parity video: {out['parity']['video']}")
        if not par_launches["corr_lookup"] > 0:
            raise RuntimeError("cli/parity launched no K1")

        # -- (c) cli/demo over the JPEG frames, basic model ------------------
        torch.backends.cudnn.deterministic = True
        cfg = RAFTConfig(corr_impl="pallas", gru_impl="fused")
        weights = os.path.join(tmp, "basic-seed0.pth")
        save_pth(RAFT(cfg, torch.Generator().manual_seed(0)), weights)
        demo_out = os.path.join(tmp, "demo_out")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            demo_main(["--model", weights, "--path", jpeg_dir, "--out",
                       demo_out, "--iters", str(VIDEO_ITERS), "--corr_impl",
                       "pallas", "--gru_impl", "fused"])
        demo_s = time.perf_counter() - t0
        demo_launches = kernels.launch_counts()
        fwd, _ = make_forward(cfg, VIDEO_ITERS, "cuda")
        again = flow_pairs(functools.partial(fwd, load_weights(weights, cfg)),
                           jpegs)
        written = sorted(glob.glob(os.path.join(demo_out, "*.png")))
        same = [np.array_equal(read_png(p), np.concatenate(
            [j, flow_to_image(f)], axis=0))
            for p, j, f in zip(written, jpegs, again)]
        out["demo"] = {"pngs": len(written), "bitwise": all(same),
                       "seconds": demo_s,
                       "launches": {k: v for k, v in demo_launches.items()
                                    if v}}
        log(f"[24] (c) python -m raft_tpu_torch.cli.demo --path <JPEG "
            f"frames>, basic model, seeded weights, iters {VIDEO_ITERS}: "
            f"{len(written)} PNGs in {demo_s:.1f} s, each bitwise "
            f"flow_to_image of flow_pairs on the decoded frames: {all(same)};"
            f" launches {out['demo']['launches']} (predicted corr_lookup "
            f"{pairs * VIDEO_ITERS}, gru_gates and gru_blend "
            f"{2 * pairs * VIDEO_ITERS})")
        want = {"corr_lookup": pairs * VIDEO_ITERS,
                "gru_gates": 2 * pairs * VIDEO_ITERS,
                "gru_blend": 2 * pairs * VIDEO_ITERS}
        if not (len(written) == pairs and all(same)
                and all(demo_launches[k] == n for k, n in want.items())):
            raise RuntimeError(f"cli/demo on JPEG frames: {out['demo']}")

        # -- (d) the native flow codec ---------------------------------------
        avail = native.available()
        rng = np.random.RandomState(24)
        uv = (rng.randn(*NATIVE_FLO_HW, 2) * 10).astype(np.float32)
        pfm = rng.randn(*NATIVE_PFM_SHAPE).astype(np.float32)

        def timed(fn, *a):
            t0 = time.perf_counter()
            r = fn(*a)
            return r, (time.perf_counter() - t0) * 1e3

        f_nat, f_np = (os.path.join(tmp, f"{t}.flo") for t in ("nat", "np"))
        ok_w, w_nat = timed(native.write_flo, f_nat, uv)
        _, w_np = timed(fu.write_flow_numpy, f_np, uv)
        reads = {}
        for src in (f_nat, f_np):
            for tag, fn in (("native", native.read_flo),
                            ("numpy", fu.read_flow_numpy)):
                reads[(src, tag)] = timed(fn, src)
        p_file = os.path.join(tmp, "x.pfm")
        fu.write_pfm(p_file, pfm)
        p_nat, r_pfm_nat = timed(native.read_pfm, p_file)
        p_np, r_pfm_np = timed(fu.read_pfm_numpy, p_file)
        flo_ok = (ok_w and open(f_nat, "rb").read() == open(f_np, "rb").read()
                  and all(np.array_equal(r, uv) for r, _ in reads.values()))
        pfm_ok = (np.array_equal(p_nat, pfm) and np.array_equal(p_np, pfm))
        out["native"] = {
            "available": avail, "build_seconds": native.build_seconds,
            "flo_bitwise": flo_ok, "pfm_bitwise": pfm_ok,
            "flo_write_ms": {"native": w_nat, "numpy": w_np},
            "flo_read_ms": {"native": reads[(f_nat, "native")][1],
                            "numpy": reads[(f_nat, "numpy")][1]},
            "pfm_read_ms": {"native": r_pfm_nat, "numpy": r_pfm_np},
            "loader_bench_pairs_per_s": loader["pairs_per_s"],
            "loader_bench_pairs_per_s_numpy": LOADER_NUMPY_PAIRS_S}
        log(f"[24] (d) native flow codec: available {avail} (first build "
            f"{native.build_seconds:.2f} s); a {NATIVE_FLO_HW[0]}x"
            f"{NATIVE_FLO_HW[1]} .flo written native {w_nat:.2f} ms / numpy "
            f"{w_np:.2f} ms, read native "
            f"{out['native']['flo_read_ms']['native']:.2f} ms / numpy "
            f"{out['native']['flo_read_ms']['numpy']:.2f} ms, bitwise both "
            f"ways {flo_ok}; a {NATIVE_PFM_SHAPE} .pfm read native "
            f"{r_pfm_nat:.2f} ms / numpy {r_pfm_np:.2f} ms, bitwise "
            f"{pfm_ok}; phase 16's loader_bench on the native reader "
            f"{loader['pairs_per_s']:.2f} pairs/s (on the numpy reader: "
            f"{LOADER_NUMPY_PAIRS_S}); {smi}")
        if not (avail and flo_ok and pfm_ok):
            raise RuntimeError(f"the native codec: {out['native']}")
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 25: GMA's kernels (K6, K7) and a GMA bucket of the serving engine
# ---------------------------------------------------------------------------

GMA_HW = (1080, 1920)           # gma-1080p-serve-c8's frames: grid 135x240
GMA_DIM = 128                   # dim_head, the context width
# K6/K7 hold float32 accuracy: each against float64 on sampled rows within
# twice the plain version's own error there (cuBLAS in float32, TF32 off),
# or GMA_REL_FLOOR of the largest value where that is less
GMA_REL_FLOOR = 1e-5
GMA_ROWS = 256                  # rows sampled for the float64 witness
GMA_FLOW_TOL = 1e-3             # px, mean: a replay against eager


def gma_operands(B: int, H: int, W: int, seed: int):
    """q and k as the halves of one (B, N, 256) tensor (the W_qk conv's
    channels-last output), logits of about 4 in spread, v and m."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qk = torch.randn(B, H * W, 2 * GMA_DIM, generator=g, device="cuda") * 2.0
    q, k = qk.split(GMA_DIM, -1)
    v = torch.randn(B, H * W, GMA_DIM, generator=g, device="cuda")
    m = torch.randn(B, H * W, GMA_DIM, generator=g, device="cuda")
    return q, k, v, m


def gma_costs(B: int, n: int):
    """(bytes, operations) of one K6 and one K7 launch over a batch of B
    at a grid of n (``flowbench/counts_gma.py``'s counts)."""
    d = GMA_DIM
    return ((B * (2 * n * d * 4 + n * n * 4), B * 2 * n * n * d),
            (B * (n * n * 4 + 3 * n * d * 4), B * 2 * n * n * d))


def gma_phase(smi: str) -> dict:
    """Phase 25: K6 and K7 at the GMA cell's grid, batch 1 and 2, held
    against float64 beside their plain versions and timed against them;
    then a GMA bucket of ``RAFTEngine`` at 1080x1920, its replay's launches
    read from the counts and from the device trace."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch import kernels
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.kernels.gma import (gma_aggregate, gma_aggregate_plain,
                                            gma_attention, gma_attention_plain)
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.serving.engine import RAFTEngine

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    H, W = GMA_HW[0] // 8, GMA_HW[1] // 8
    n = H * W
    scale = GMA_DIM ** -0.5
    out = {"grid": [H, W], "batches": {}}

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    try:
        for B in (1, 2):
            q, k, v, m = gma_operands(B, H, W, 25 + B)
            gamma = torch.tensor([0.7], device="cuda")
            rows = torch.randperm(n, device="cuda")[:GMA_ROWS]
            attn = gma_attention(q, k, scale)
            plain_a = gma_attention_plain(q, k, scale)
            want_a = torch.softmax((q[:, rows].double() * scale)
                                   @ k.double().transpose(1, 2), -1)
            e6, e6_plain = rel(attn[:, rows], want_a), rel(plain_a[:, rows],
                                                          want_a)
            gap6 = max_err(attn, plain_a)
            del plain_a, want_a
            g = gma_aggregate(attn, v, m, gamma)
            plain_g = gma_aggregate_plain(attn, v, m, gamma)
            want_g = m[:, rows].double() + 0.7 * (attn[:, rows].double()
                                                  @ v.double())
            e7, e7_plain = rel(g[:, rows], want_g), rel(plain_g[:, rows],
                                                       want_g)
            gap7 = max_err(g, plain_g)
            del plain_g, want_g
            torch.cuda.synchronize()
            (b6, o6), (b7, o7) = gma_costs(B, n)
            t = {"attention": dict(
                     ms=kernel_ms(lambda: gma_attention(q, k, scale), 5),
                     plain_ms=kernel_ms(
                         lambda: gma_attention_plain(q, k, scale), 3),
                     rel_err=e6, plain_rel_err=e6_plain, max_abs_gap=gap6,
                     bound=bound_ms(b6, o6, TF32_FLOPS_PER_S),
                     bound_fp32_ms=bound_ms(b6, o6)[0], mbytes=b6 / 1e6),
                 "aggregate": dict(
                     ms=kernel_ms(lambda: gma_aggregate(attn, v, m, gamma),
                                  20),
                     plain_ms=kernel_ms(
                         lambda: gma_aggregate_plain(attn, v, m, gamma), 10),
                     rel_err=e7, plain_rel_err=e7_plain, max_abs_gap=gap7,
                     bound=bound_ms(b7, o7, TF32_FLOPS_PER_S),
                     bound_fp32_ms=bound_ms(b7, o7)[0], mbytes=b7 / 1e6)}
            for name, r in t.items():
                tol = max(2 * r["plain_rel_err"], GMA_REL_FLOOR)
                log(f"[25] gma_{name} B={B} {H}x{W} (N = {n}): kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound'][0]:.4f} ms by {r['bound'][1]} at TF32's "
                    f"495 TFLOP/s ({r['bound_fp32_ms']:.4f} at fp32's 67); "
                    f"error against float64 on {GMA_ROWS} rows "
                    f"{r['rel_err']:.3e} of the largest value (plain "
                    f"{r['plain_rel_err']:.3e}; fail above {tol:.3e}), "
                    f"largest gap to plain {r['max_abs_gap']:.3e}; {smi}")
                if not r["rel_err"] <= tol:
                    raise RuntimeError(f"gma_{name} misses float32 accuracy")
            if not t["aggregate"]["ms"] < t["aggregate"]["plain_ms"]:
                raise RuntimeError("K7 is slower than its plain version "
                                   "(cuBLAS float32 and the add)")
            out["batches"][B] = t
            del q, k, v, m, attn, g
            torch.cuda.empty_cache()

        # -- a GMA bucket of the serving engine at the cell's frames -------
        with open(os.path.join(REPO, "flowbench", "configs", "gma.json")) as f:
            program = json.load(f)["program"]
        config = RAFTConfig(gma_heads=1, **program)
        torch.manual_seed(25)
        model = RAFT(config)
        with torch.no_grad():
            model.update_block.aggregator.gamma.fill_(1.0)
            model.att.to_qk.weight.mul_(12.0)   # peaked rows, as the cell's
        # TF32 convolutions as the cell runs them, cuDNN deterministic so that
        # the replay and the eager forward take the same algorithms (in fp32
        # cuDNN takes FFT convolutions at the encoders' batch of 4, seconds
        # a replay and tens of GB)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = True
        bucket = (2, GMA_HW[0], GMA_HW[1])
        rng = np.random.default_rng(25)
        im1, im2 = (rng.integers(0, 256, (2, *GMA_HW, 3), dtype=np.uint8)
                    for _ in range(2))
        # the eager forward first, freed before the engine captures (the
        # two together outgrow the card at this size)
        eager_model = RAFT(config).cuda().eval()
        eager_model.load_state_dict(model.state_dict())
        with torch.no_grad():
            up = eager_model(torch.from_numpy(im1).cuda().float(),
                             torch.from_numpy(im2).cuda().float(),
                             iters=ITERS)[1].cpu().numpy()
        del eager_model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = RAFTEngine(model.state_dict(), config=config, iters=ITERS,
                         envelope=[bucket], wire="u8", device="cuda")
        capture_s = time.perf_counter() - t0
        captured = dict(eng._programs[bucket].launches)
        eng.infer_batch(im1, im2)   # warm
        kernels.reset_launch_counts()
        before = dict(eng.replayed_launches())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flows = eng.infer_batch(im1, im2)
            torch.cuda.synchronize()
        after = eng.replayed_launches()
        replayed = {k: after[k] - before.get(k, 0) for k in after}
        wrapper_calls = kernels.launch_counts()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        names = ("gma_attention_kernel", "gma_aggregate_kernel")
        traced = {name: sum(1 for e in evs if name in e.name)
                  for name in names}
        busy = device_busy_ms(prof)
        gma_ms = sum(e.device_time_total for e in evs
                     if any(name in e.name for name in names)) / 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        gap = np.sqrt(((np.asarray(flows) - up) ** 2).sum(-1))
        expect = {"gma_attention": 1, "gma_aggregate": ITERS}
        log(f"[25] RAFTEngine GMA bucket {bucket}, iters {ITERS}: captured in "
            f"{capture_s:.1f} s with launches {captured}; one replay (counts "
            f"set to 0 before it): replayed {replayed}, wrapper calls "
            f"{wrapper_calls} (a replay calls none), device trace "
            f"{traced}; busy {busy:.2f} ms, K6+K7 {gma_ms:.2f} ms "
            f"({gma_ms / busy:.1%}); peak {peak_gb:.2f} GB; flow against "
            f"eager mean {float(gap.mean()):.3e} px (fail above "
            f"{GMA_FLOW_TOL:g}); {smi}")
        if not (all(replayed.get(k) == v and captured.get(k) == v
                    for k, v in expect.items())
                and traced == {"gma_attention_kernel": 1,
                               "gma_aggregate_kernel": ITERS}
                and wrapper_calls["gma_attention"] == 0
                and wrapper_calls["gma_aggregate"] == 0
                and float(gap.mean()) < GMA_FLOW_TOL):
            raise RuntimeError("the GMA bucket's launches or flow are wrong")
        out["engine"] = {"bucket": list(bucket), "capture_s": capture_s,
                         "launches_per_replay": replayed,
                         "traced_per_replay": traced, "busy_ms": busy,
                         "gma_ms": gma_ms, "peak_gb": peak_gb,
                         "flow_gap_px_mean": float(gap.mean())}
        del eng, model
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    return out


def main() -> int:
    import faulthandler

    faulthandler.enable()   # a native crash prints every thread's stack
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from raft_tpu_torch import kernels
    from raft_tpu_torch.cli._measure import elapsed_ms
    from raft_tpu_torch.cli.corr_bench import \
        grid_sample_lookup as lookup_grid_sample
    from raft_tpu_torch.cli.demo import main as demo_main
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.data.png import read_png
    from raft_tpu_torch.evaluation.evaluate import make_forward
    from raft_tpu_torch.kernels import _build
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda
    from raft_tpu_torch.kernels.corr_lookup import (corr_lookup_bwd_plain,
                                                    corr_lookup_cuda,
                                                    corr_scatter_cuda)
    from raft_tpu_torch.kernels.gru import (gru_blend, gru_blend_bwd,
                                            gru_blend_bwd_plain,
                                            gru_blend_plain, gru_gates,
                                            gru_gates_bwd,
                                            gru_gates_bwd_plain,
                                            gru_gates_plain)
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.models.corr import (alt_corr_lookup,
                                            build_corr_pyramid,
                                            corr_lookup_gather)
    from raft_tpu_torch.tools.convert import load_pth, save_pth
    from raft_tpu_torch.training.train_step import make_train_step
    from raft_tpu_torch.training.trainer import train

    # -- 1. device -----------------------------------------------------------
    cuda = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[1] device: {kind} (count {count}); nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    log("[1] TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")

    # -- 2. build ------------------------------------------------------------
    build = _build.library()
    log(f"[2] built {build.path} in {build.seconds:.1f} s")
    for line in build.log.splitlines():
        if "ptxas info" in line:
            log(f"[2]   {line.strip()}")
    # ptxas reports static shared memory only; the lookups' is dynamic
    alt_smem = {r: build.lib.corr_alt_smem_bytes(r) for r in (4, 3)}
    log(f"[2] dynamic shared memory per block: corr_alt (512 threads, one "
        f"block per SM) {alt_smem[4]} B at r=4, {alt_smem[3]} B at r=3 (a "
        "2-stage cp.async ring of 320-row x 32-channel fp32 slabs in "
        "core-matrix layout, the queries' big and small planes of one slab, "
        f"64 (2r+2)^2 fp32 windows); corr_lookup {8 * 4 * 100 * 4} B per 8 warps at r=4 "
        f"and 4 levels (each warp L x (2r+2)^2 fp32 windows); corr_scatter "
        f"{8 * 81 * 4} B at r=4 (8 warps x (2r+1)^2 fp32 cotangents); the "
        "GRU kernels none")
    for name, n_mma in sass_mma_counts(build.path).items():
        log(f"[2] SASS of {name}: {n_mma} tensor-core MMA instructions "
            "(HMMA/HGMMA, by cuobjdump -sass)")
        if "corr_alt" in name and not n_mma:
            raise RuntimeError("corr_alt's products do not run on the "
                               "tensor cores")

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"corr_lookup": 0.0, "gru_gates": 0.0, "gru_blend": 0.0}
    err_bf16 = {"gru_gates": 0.0, "gru_blend": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        pyramid, coords = lookup_inputs(gen, dtype)
        for radius in (4, 3):
            e = max_err(corr_lookup_cuda(pyramid, coords, radius),
                        corr_lookup_gather(pyramid, coords, radius))
            log(f"[3] corr_lookup r={radius} {str(dtype)[6:]} volume: max abs "
                f"err {e:.3e} (tol {LOOKUP_TOL:g})")
            if not e <= LOOKUP_TOL:
                raise RuntimeError("corr_lookup disagrees with its plain version")
            err["corr_lookup"] = max(err["corr_lookup"], e)
        del pyramid
    shape = (1, GRID[0] * GRID[1], 128)
    for dtype in (torch.float32, torch.bfloat16):
        zl, rl, h, ql = (3 * torch.randn(shape, generator=gen, device="cuda")
                         .to(dtype) for _ in range(4))
        z = torch.sigmoid(zl.float()).to(dtype)
        hold_gru("3", {"gru_gates": (gru_gates(zl, rl, h),
                                     gru_gates_plain(zl, rl, h)),
                       "gru_blend": ((gru_blend(z, h, ql),),
                                     (gru_blend_plain(z, h, ql),))},
                 dtype, "(1,7040,128)", err, err_bf16)
    # and all four on operands as the model hands them, in both layouts
    hold_gru_layouts("3", gen, err, err_bf16)

    # -- 4. times ------------------------------------------------------------
    pyramid, coords = lookup_inputs(gen, torch.float32)
    e = max_err(lookup_grid_sample(pyramid, coords, 4),
                corr_lookup_gather(pyramid, coords, 4))
    log(f"[4] grid_sample yardstick vs plain lookup: max abs err {e:.3e}")
    nbytes = lookup_bytes(pyramid, coords, 4)
    zl, rl, h, ql = (3 * torch.randn(shape, generator=gen, device="cuda")
                     for _ in range(4))
    z = torch.sigmoid(zl)
    n = zl.numel()
    work = {"corr_lookup": (lambda: corr_lookup_cuda(pyramid, coords, 4),
                            lambda: corr_lookup_gather(pyramid, coords, 4),
                            lambda: lookup_grid_sample(pyramid, coords, 4),
                            nbytes, coords[..., 0].numel() * 4 * 81 * 9),
            "gru_gates": (lambda: gru_gates(zl, rl, h),
                          lambda: gru_gates_plain(zl, rl, h), None,
                          5 * n * 4, 9 * n),
            "gru_blend": (lambda: gru_blend(z, h, ql),
                          lambda: gru_blend_plain(z, h, ql), None,
                          4 * n * 4, 6 * n)}
    times = time_kernels("4", work, smi, 50, 50)
    # the GRU tails' single readings spread from call to call: the median
    # and range of five sessions, L2 cold and warm
    flush = l2_flusher()
    for name in ("gru_gates", "gru_blend"):
        t = times[name]
        cold = median_kernel_ms(work[name][0], 50, 5, flush=flush)
        warm = median_kernel_ms(work[name][0], 50, 5)
        t.update(ms=cold[0], ms_range=list(cold[1:]), ms_l2_warm=warm[0],
                 ms_l2_warm_range=list(warm[1:]))
        log(f"[4] {name}: the median of 5 sessions of 50 calls: L2 cold "
            f"{cold[0]:.4f} ms ({cold[1]:.4f}-{cold[2]:.4f}), L2 warm "
            f"{warm[0]:.4f} ms ({warm[1]:.4f}-{warm[2]:.4f}); bound "
            f"{t['bound'][0]:.4f} ms: {t['bound'][0] / cold[0]:.1%} of it "
            f"cold, {t['bound'][0] / warm[0]:.1%} warm; {smi}")
    note_sectors("4", times["corr_lookup"], pyramid, coords, smi)
    gru_layout_times = time_gru_layouts("4", gen, smi)
    for name, (kern, *_) in work.items():
        times[name]["call_ms"] = elapsed_ms(kern, 200, cuda, warmup=10)
        log(f"[4] {name}: one wrapper call back-to-back "
            f"{times[name]['call_ms']:.4f} ms (events, host included)")
    del pyramid

    # -- 5. end to end -------------------------------------------------------
    frames = synthetic_frames(0, PAIRS + 1)
    cfg_k = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    cfg_p = RAFTConfig(corr_impl="gather", gru_impl="xla")
    model_k = RAFT(cfg_k, torch.Generator().manual_seed(0)).cuda()
    model_p = RAFT(cfg_p).cuda()
    model_p.load_state_dict(model_k.state_dict())
    run_pairs(model_k, cfg_k, frames[:2], ITERS)        # warm-up
    kernels.reset_launch_counts()
    flows_k, ms_k, peak_k = run_pairs(model_k, cfg_k, frames, ITERS)
    launches = kernels.launch_counts()
    gru_layouts_all("5", launches, kernels.launch_layouts())
    per_pair = {k: v / PAIRS for k, v in launches.items()}
    log(f"[5] basic model, pallas+fused, iters={ITERS}: {ms_k:.2f} ms/pair, "
        f"peak {peak_k:.0f} MiB, launches {launches} over {PAIRS} pairs, "
        f"{per_pair} per pair; {smi}")
    want = expected_launches(corr_lookup=ITERS * PAIRS, gru_gates=2 * ITERS * PAIRS,
                       gru_blend=2 * ITERS * PAIRS)
    if launches != want:
        raise RuntimeError(f"main path launches {launches}, want {want}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pairs(model_k, cfg_k, frames[:2], ITERS)
        wall = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    busy = device_busy_ms(prof)
    log(f"[5] basic model, one pair under the profiler: wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}; top "
        "device time:")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[5]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")
    run_pairs(model_p, cfg_p, frames[:2], ITERS)        # warm-up
    flows_p, ms_p, peak_p = run_pairs(model_p, cfg_p, frames, ITERS)
    d_kp = flow_diff(flows_k, flows_p)
    log(f"[5] basic model, gather+xla (plain), iters={ITERS}: {ms_p:.2f} "
        f"ms/pair, peak {peak_p:.0f} MiB; max |flow diff| vs kernels "
        f"{d_kp:.3e} px")
    # The second witness: random weights make the 20-step recurrence
    # chaotic, so the plain path against itself, on frames moved by one
    # ulp, must open a gap of the same order as kernels against plain.
    ulp = [np.nextafter(f, np.float32(np.inf)) for f in frames]
    flows_u, _, _ = run_pairs(model_p, cfg_p, ulp, ITERS)
    d_pp = flow_diff(flows_p, flows_u)
    log(f"[5] basic model, plain vs plain on frames moved by 1 ulp, iters="
        f"{ITERS}: max |flow diff| {d_pp:.3e} px; kernels vs plain "
        f"{d_kp:.3e} px (held to at most 10x the plain-vs-plain gap)")
    if not d_kp <= 10 * d_pp:
        raise RuntimeError("basic model: kernels vs plain at iters="
                           f"{ITERS} exceeds what 1 ulp of input gives")
    step_k, _, _ = run_pairs(model_k, cfg_k, frames, 1)
    step_p, _, _ = run_pairs(model_p, cfg_p, frames, 1)
    d = flow_diff(step_k, step_p)
    log(f"[5] basic model, iters=1: max |flow diff| kernels vs plain {d:.3e} "
        f"px (tol {BASIC_STEP_TOL:g})")
    if not d <= BASIC_STEP_TOL:
        raise RuntimeError("basic model: kernels disagree with plain")
    del model_k, model_p

    fixture = os.path.join(REPO, "tests", "fixtures",
                           "raft-small-cputrained.pth")
    cfg_sk = RAFTConfig(small=True, corr_impl="pallas")
    cfg_sp = RAFTConfig(small=True, corr_impl="gather")
    small_k = load_pth(fixture, cfg_sk).cuda()
    small_p = load_pth(fixture, cfg_sp).cuda()
    run_pairs(small_k, cfg_sk, frames[:2], ITERS)       # warm-up
    kernels.reset_launch_counts()
    sflows_k, sms_k, speak_k = run_pairs(small_k, cfg_sk, frames, ITERS)
    slaunch = kernels.launch_counts()
    sflows_p, sms_p, _ = run_pairs(small_p, cfg_sp, frames, ITERS)
    d = flow_diff(sflows_k, sflows_p)
    log(f"[5] small model (trained fixture), iters={ITERS}: kernel lookup "
        f"{sms_k:.2f} ms/pair (peak {speak_k:.0f} MiB, launches {slaunch}), "
        f"plain {sms_p:.2f} ms/pair; max |flow diff| {d:.3e} px (tol "
        f"{SMALL_TOL:g}); {smi}")
    if not d <= SMALL_TOL or slaunch["corr_lookup"] != ITERS * PAIRS:
        raise RuntimeError("small model: kernel lookup disagrees with plain")

    del small_k, small_p

    # -- 6. backward kernels at the training geometry ------------------------
    B, (Hg, Wg) = TRAIN_B, TRAIN_GRID
    for dtype in (torch.float32, torch.bfloat16):
        pyramid, coords = lookup_inputs(gen, dtype, B, TRAIN_GRID)
        e = max_err(corr_lookup_cuda(pyramid, coords, 4),
                    corr_lookup_gather(pyramid, coords, 4))
        log(f"[6] corr_lookup r=4 {str(dtype)[6:]} volume, B={B}, grid "
            f"{Hg}x{Wg}: max abs err {e:.3e} (tol {LOOKUP_TOL:g})")
        if not e <= LOOKUP_TOL:
            raise RuntimeError("corr_lookup disagrees with its plain version")
        err["corr_lookup"] = max(err["corr_lookup"], e)
        g = torch.randn((B, Hg, Wg, 4 * 81), generator=gen, device="cuda")
        got = corr_scatter_cuda(g, pyramid, coords, 4)
        again = corr_scatter_cuda(g, pyramid, coords, 4)
        want = corr_lookup_bwd_plain(g, [v.float() for v in pyramid], coords, 4)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        e = max(max_err(a, w) for a, w in zip(got, want))
        if dtype == torch.float32:
            ok = e <= SCATTER_TOL
            err["corr_scatter"] = e
            bound = f"tol {SCATTER_TOL:g}"
        else:
            # one rounding of the fp32 gradient: half a bf16 ulp
            ok = all(bool(((a.float() - w).abs()
                           <= 2 ** -8 * w.abs() + SCATTER_TOL).all())
                     for a, w in zip(got, want))
            err_bf16["corr_scatter"] = e
            bound = "bound half a bf16 ulp of the fp32 plain VJP + 1e-5"
        log(f"[6] corr_scatter r=4 {str(dtype)[6:]} volume, B={B}, grid "
            f"{Hg}x{Wg}: max abs err {e:.3e} vs the plain VJP ({bound}); two "
            f"calls bitwise equal: {bitwise}")
        if not (ok and bitwise):
            raise RuntimeError("corr_scatter disagrees with its plain version")
        del pyramid, got, again, want
    for dtype in (torch.float32, torch.bfloat16):
        zl, rl, h, ql, dz, drh, g, z = gru_bwd_inputs(gen, dtype)
        hold_gru("6", {"gru_gates": (gru_gates(zl, rl, h),
                                     gru_gates_plain(zl, rl, h)),
                       "gru_blend": ((gru_blend(z, h, ql),),
                                     (gru_blend_plain(z, h, ql),)),
                       "gru_gates_bwd": (gru_gates_bwd(zl, rl, h, dz, drh),
                                         gru_gates_bwd_plain(zl, rl, h, dz,
                                                             drh)),
                       "gru_blend_bwd": (gru_blend_bwd(z, h, ql, g),
                                         gru_blend_bwd_plain(z, h, ql, g))},
                 dtype, str(tuple(h.shape)), err, err_bf16)

    pyramid, coords = lookup_inputs(gen, torch.float32, B, TRAIN_GRID)
    g = torch.randn((B, Hg, Wg, 4 * 81), generator=gen, device="cuda")
    leaves = [v.clone().requires_grad_() for v in pyramid]
    ref = lookup_grid_sample(leaves, coords, 4)
    e = max(max_err(a, w) for a, w in zip(
        torch.autograd.grad(ref, leaves, g, retain_graph=True),
        corr_lookup_bwd_plain(g, pyramid, coords, 4)))
    log(f"[6] grid_sample backward yardstick vs plain VJP: max abs err {e:.3e}")
    zl, rl, h, ql, dz, drh, gz, z = gru_bwd_inputs(gen, torch.float32)
    n = h.numel()
    train_work = {
        "corr_lookup": (lambda: corr_lookup_cuda(pyramid, coords, 4),
                        lambda: corr_lookup_gather(pyramid, coords, 4),
                        lambda: lookup_grid_sample(pyramid, coords, 4),
                        lookup_bytes(pyramid, coords, 4),
                        coords[..., 0].numel() * 4 * 81 * 9),
        "corr_scatter": (lambda: corr_scatter_cuda(g, pyramid, coords, 4),
                         lambda: corr_lookup_bwd_plain(g, pyramid, coords, 4),
                         lambda: torch.autograd.grad(ref, leaves, g,
                                                     retain_graph=True),
                         scatter_bytes(pyramid, coords, 4),
                         coords[..., 0].numel() * 4 * 100 * 8),
        "gru_gates": (lambda: gru_gates(zl, rl, h),
                      lambda: gru_gates_plain(zl, rl, h), None,
                      5 * n * 4, 9 * n),
        "gru_blend": (lambda: gru_blend(z, h, ql),
                      lambda: gru_blend_plain(z, h, ql), None,
                      4 * n * 4, 6 * n),
        "gru_gates_bwd": (lambda: gru_gates_bwd(zl, rl, h, dz, drh),
                          lambda: gru_gates_bwd_plain(zl, rl, h, dz, drh),
                          None, 8 * n * 4, 16 * n),
        "gru_blend_bwd": (lambda: gru_blend_bwd(z, h, ql, gz),
                          lambda: gru_blend_bwd_plain(z, h, ql, gz), None,
                          7 * n * 4, 12 * n)}
    train_times = time_kernels("6", train_work, smi, 20, 10,
                               " at the training geometry")
    note_sectors("6", train_times["corr_lookup"], pyramid, coords, smi)
    del pyramid, leaves, ref, zl, rl, h, ql, dz, drh, gz, z

    # -- 7. training through trainer.train -----------------------------------
    cfg_k = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    cfg_p = RAFTConfig(corr_impl="gather", gru_impl="xla")
    batches = [train_batch(seed) for seed in range(TRAIN_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        tc = train_config(name="chip-smoke", num_steps=TRAIN_STEPS,
                          checkpoint_dir=os.path.join(tmp, "ckpt"),
                          log_dir=os.path.join(tmp, "runs"))
        loader = TimedLoader(batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state = train(cfg_k, tc, loader=loader, device="cuda")
        train_launches = kernels.launch_counts()
        gru_layouts_all("7", train_launches, kernels.launch_layouts())
        peak_train = torch.cuda.max_memory_allocated() / 2 ** 20
        step_ms = [1e3 * (b - a) for a, b in zip(loader.marks, loader.marks[1:])]
        ms_step = float(np.median(step_ms[1:]))
        per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
        log(f"[7] train(): basic model, chairs recipe (B={TRAIN_B}, "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, iters={TRAIN_ITERS}, fp32, batch "
            f"norms trained), pallas+fused, {TRAIN_STEPS} steps: "
            f"{ms_step:.2f} ms per step (median of steps 2-{len(step_ms)}; "
            f"all {', '.join(f'{x:.2f}' for x in step_ms)} ms), "
            f"{TRAIN_B / ms_step * 1e3:.2f} pairs/s, peak {peak_train:.0f} "
            f"MiB; launches {train_launches}, {per_step} per step; {smi}")
        want = expected_launches(corr_lookup=TRAIN_ITERS, corr_scatter=TRAIN_ITERS,
                           gru_gates=2 * TRAIN_ITERS, gru_blend=2 * TRAIN_ITERS,
                           gru_gates_bwd=2 * TRAIN_ITERS,
                           gru_blend_bwd=2 * TRAIN_ITERS)
        if per_step != want:
            raise RuntimeError(f"training launches {per_step} per step, "
                               f"want {want}")
        reloaded = load_pth(os.path.join(tmp, "ckpt", "chip-smoke.pth"), cfg_k)
        for k, v in state.model.state_dict().items():
            if not torch.equal(reloaded.state_dict()[k], v.cpu()):
                raise RuntimeError(f"the written .pth differs at {k}")
        log("[7] the .pth that train() wrote loads back with strict=True "
            "and equals the trained weights")

    from torch.profiler import ProfilerActivity, profile

    step_fn = make_train_step(cfg_k, tc)
    step_fn(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step_fn(state, batches[1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    busy = device_busy_ms(prof)
    train_idle = 1 - busy / wall
    log(f"[7] one train step under the profiler: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms (union of kernel intervals; their summed time "
        f"{sum(e.self_device_time_total for e in evs) / 1e3:.2f} ms), idle "
        f"share {train_idle:.3f}; loss "
        f"{float(metrics['loss']):.4f}; top device time:")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[7]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")
    del state, step_fn, prof

    # -- 8. one step, kernels against plain ----------------------------------
    torch.backends.cudnn.deterministic = True
    weights = RAFT(cfg_k, torch.Generator().manual_seed(1)).state_dict()
    batch = {k: v.astype(np.float32) for k, v in batches[0].items()}
    ulp = dict(batch, image1=np.nextafter(batch["image1"], np.float32(np.inf)),
               image2=np.nextafter(batch["image2"], np.float32(np.inf)))
    check_step("basic model, iters=1, kernels vs plain",
               step_grads(cfg_p, weights, batch, 1),
               step_grads(cfg_k, weights, batch, 1),
               step_grads(cfg_p, weights, ulp, 1))
    small_w = load_pth(fixture, cfg_sp).state_dict()
    check_step(f"small model (trained fixture), iters={TRAIN_ITERS}, "
               "kernel lookup vs plain",
               step_grads(cfg_sp, small_w, batch, TRAIN_ITERS),
               step_grads(cfg_sk, small_w, batch, TRAIN_ITERS),
               step_grads(cfg_sp, small_w, ulp, TRAIN_ITERS))
    # At random init the 12-step recurrence is chaotic: one ulp of input
    # moves the gradients by the size of the largest, so this witness
    # cannot fail; the two checks above are the gates.
    plain = step_grads(cfg_p, weights, batch, TRAIN_ITERS)
    gap_kp = step_gap(step_grads(cfg_k, weights, batch, TRAIN_ITERS), plain)
    gap_pp = step_gap(step_grads(cfg_p, weights, ulp, TRAIN_ITERS), plain)
    log(f"[8] basic model, iters={TRAIN_ITERS}: kernels vs plain loss gap "
        f"{gap_kp[0]:.3e}, gradient gap largest {gap_kp[1]:.3e} median "
        f"{gap_kp[2]:.3e}; plain vs plain on frames moved by one ulp: loss "
        f"{gap_pp[0]:.3e}, largest {gap_pp[1]:.3e} median {gap_pp[2]:.3e} "
        "(kernels vs plain held to 10x each)")
    if not all(a <= 10 * b for a, b in zip(gap_kp[:3], gap_pp[:3])):
        raise RuntimeError(f"basic model: kernels vs plain at iters="
                           f"{TRAIN_ITERS} exceeds 10x what 1 ulp of input "
                           "gives")

    torch.backends.cudnn.deterministic = False
    del plain, weights, batch, ulp, small_w

    # -- 9. K5, the on-the-fly lookup, at the KITTI geometries ---------------
    eval_grid = kitti_eval_grid()
    err["corr_alt"] = 0.0
    branches = {}
    for field in FIELDS:
        for grid, where in ((eval_grid, "validate_kitti's, bucketed"),
                            (KITTI_GRID, "the submission writer's")):
            for C, radius in ((256, 4), (128, 3)):
                e, e_k1, br = check_alt(gen, grid, C, radius, where, field)
                err["corr_alt"] = max(err["corr_alt"], e)
                err["corr_lookup"] = max(err["corr_lookup"], e_k1)
                if grid == eval_grid and (C, radius) == (256, 4):
                    branches[field] = br
    # fmaps at three times unit variance, twice the rms the model's encoders
    # give K5 (1.4-1.5, profile_corr_alt.py): the tolerance's absolute part
    # does not grow with them, the dots' rounding does
    err_3x = 0.0
    for field in FIELDS:
        e, e_k1, _ = check_alt(gen, eval_grid, 256, 4,
                               "validate_kitti's, bucketed", field, scale=3.0)
        err_3x = max(err_3x, e)
        err["corr_lookup"] = max(err["corr_lookup"], e_k1)
    tiled, per_query = branches["smooth"]
    if not tiled >= SMOOTH_TILED_MIN * (tiled + per_query):
        raise RuntimeError(f"corr_alt tiled {branch_note(branches['smooth'])}"
                           f" of the smooth field, under {SMOOTH_TILED_MIN:.0%}")
    zl, rl, h, ql, _, _, _, z = gru_bwd_inputs(gen, torch.float32, 1, eval_grid)
    hold_gru("9", {"gru_gates": (gru_gates(zl, rl, h),
                                 gru_gates_plain(zl, rl, h)),
                   "gru_blend": ((gru_blend(z, h, ql),),
                                 (gru_blend_plain(z, h, ql),))},
             torch.float32, f"{tuple(h.shape)} (validate_kitti's)", err,
             err_bf16)
    del zl, rl, h, ql, z
    f1, pyr, coords = alt_inputs(gen, 256, 4, eval_grid)
    g = torch.randn((1, *eval_grid, 4 * 81), generator=gen, device="cuda")
    grads = {}
    for name, fn in (("kernel", alt_corr_lookup_cuda),
                     ("plain", alt_corr_lookup)):
        leaves = [t.clone().requires_grad_() for t in [f1, coords, *pyr]]
        grads[name] = torch.autograd.grad(fn(leaves[0], leaves[2:], leaves[1],
                                             4), leaves, g)
    e = max(max_err(a, b) / float(b.abs().max())
            for a, b in zip(grads["kernel"], grads["plain"]))
    log(f"[9] AltCorrLookup gradients (fmap1, 4 levels, coords), grid "
        f"{eval_grid[0]}x{eval_grid[1]}, vs plain autograd: largest gap "
        f"{e:.3e} of each one's largest (tol 1e-5)")
    if not e <= 1e-5:
        raise RuntimeError("AltCorrLookup's gradients disagree with autograd")
    del grads, leaves
    del f1, pyr, coords
    alt_times = {}
    for field in FIELDS:
        f1, pyr, coords = alt_inputs(gen, 256, 4, eval_grid, field=field)
        nbytes, ops = alt_cost(f1, pyr, coords, 4)
        t = alt_times[field] = time_kernels(
            "9", {"corr_alt": (lambda: alt_corr_lookup_cuda(f1, pyr, coords, 4),
                               lambda: alt_corr_lookup(f1, pyr, coords, 4),
                               None, nbytes, ops)},
            smi, 50, 10, f" at validate_kitti's geometry (grid {eval_grid[0]}x"
            f"{eval_grid[1]}, N = {eval_grid[0] * eval_grid[1]}), {field} "
            "field")["corr_alt"]
        t["bound"], t["bound_fp32"] = alt_bound(nbytes, ops)
        t["ops"] = 3 * ops          # the split's three TF32 products
        t["branches"] = branches[field]
        log(f"[9] corr_alt, {field} field: bound restated for tensor cores "
            f"{t['bound'][0]:.4f} ms by {t['bound'][1]} ({nbytes / 1e6:.2f} MB "
            f"at 3.35 TB/s; {3 * ops / 1e9:.3f} GFLOP of TF32 products at 495 "
            f"TFLOP/s), fp32 figure {t['bound_fp32'][0]:.4f} ms ({ops / 1e9:.3f}"
            f" GFLOP at 67 TFLOP/s); kernel {t['ms']:.4f} ms L2 cold, "
            f"{t['bound'][0] / t['ms']:.1%} of the bound; "
            f"{branch_note(t['branches'])}; {smi}")
        del f1, pyr, coords
    f1, pyr, coords = alt_inputs(gen, 256, 4, eval_grid)
    flush = l2_flusher()
    mat_pyr = build_corr_pyramid(f1, pyr[0])
    mat_build_ms = kernel_ms(lambda: build_corr_pyramid(f1, pyr[0]), 10,
                             flush=flush)
    # the same by CUDA events around back-to-back calls, each after a flush,
    # less the flushes alone: a reading that owes nothing to the profiler
    mat_build_ev = (elapsed_ms(lambda: (flush(), build_corr_pyramid(
        f1, pyr[0])), 20, cuda, warmup=3) - elapsed_ms(flush, 20, cuda,
                                                       warmup=3))
    mat_k1_ms = kernel_ms(lambda: corr_lookup_cuda(mat_pyr, coords, 4), 50,
                          flush=flush)
    log(f"[9] the materialized path K5 replaces, same fmaps (iid field): "
        f"all-pairs volume and pooling {mat_build_ms:.4f} ms once per pair "
        f"({mat_build_ev:.4f} ms by CUDA events less the flushes), "
        f"corr_lookup {mat_k1_ms:.4f} ms per step (profiler, L2 cold); per "
        f"KITTI pair at iters={KITTI_ITERS}: K5 {KITTI_ITERS} x "
        f"{alt_times['smooth']['ms']:.4f} = "
        f"{KITTI_ITERS * alt_times['smooth']['ms']:.3f} ms (smooth field), "
        f"{KITTI_ITERS * alt_times['iid']['ms']:.3f} ms (iid), materialized "
        f"{mat_build_ms + KITTI_ITERS * mat_k1_ms:.3f} ms; {smi}")
    del f1, pyr, coords, mat_pyr

    with tempfile.TemporaryDirectory() as tmp:
        # -- 10. evaluation through cli/evaluate.main, KITTI layout ----------
        write_kitti(os.path.join(tmp, "KITTI"))
        weights_path = os.path.join(tmp, "basic-seed0.pth")
        save_pth(RAFT(RAFTConfig(), torch.Generator().manual_seed(0)),
                 weights_path)
        argv = ["--model", weights_path, "--dataset", "kitti", "--data_root",
                tmp, "--corr_impl", "pallas", "--gru_impl", "fused"]
        n_steps = KITTI_ITERS * KITTI_PAIRS
        evals = {}
        for name, extra, want in (
                ("alternate", ["--alternate_corr"],
                 expected_launches(corr_alt=n_steps, gru_gates=2 * n_steps,
                             gru_blend=2 * n_steps)),
                ("materialized", [],
                 expected_launches(corr_lookup=n_steps, gru_gates=2 * n_steps,
                             gru_blend=2 * n_steps))):
            run_evaluate(argv + extra, KITTI_PAIRS)           # warm-up
            evals[name], branches[name] = k5_branches(
                lambda: run_evaluate(argv + extra, KITTI_PAIRS), "cuda")
            metrics, ms, peak, counts = evals[name]
            log(f"[10] cli/evaluate.main --dataset kitti {' '.join(extra)} "
                f"--corr_impl pallas --gru_impl fused, basic model (seeded "
                f"random weights), {KITTI_PAIRS} pairs 375x1242 (bucketed to "
                f"{8 * eval_grid[0]}x{8 * eval_grid[1]}), iters={KITTI_ITERS}: "
                f"{ms:.2f} ms/pair (PNG "
                f"decoding and weight loading included), peak {peak:.0f} "
                f"MiB, launches {counts}; metrics {metrics}; corr_alt "
                f"{branch_note(branches[name])}; {smi}")
            if counts != want:
                raise RuntimeError(f"{name} path launches {counts}, want {want}")
            if not all(np.isfinite(v) for v in metrics.values()):
                raise RuntimeError(f"{name} path: metrics not finite")
        cfg_ka = RAFTConfig(alternate_corr=True, corr_impl="pallas",
                            gru_impl="fused")
        cfg_km = RAFTConfig(corr_impl="pallas", gru_impl="fused")
        basic = {c: load_pth(weights_path, c).cuda() for c in (cfg_ka, cfg_km)}
        fwd_ms = {}
        for name, c in (("alternate", cfg_ka), ("materialized", cfg_km)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kitti_flows(basic[c], c, tmp, KITTI_ITERS)
            torch.cuda.synchronize()
            fwd_ms[name] = (time.perf_counter() - t0) * 1e3 / KITTI_PAIRS
        d = flow_diff(*(kitti_flows(basic[c], c, tmp, 1)
                        for c in (cfg_ka, cfg_km)))
        log(f"[10] validator flows, forward and copy only: alternate "
            f"{fwd_ms['alternate']:.2f} ms/pair, materialized "
            f"{fwd_ms['materialized']:.2f} ms/pair (iters={KITTI_ITERS}); "
            f"basic model after one step, alternate vs materialized: max "
            f"|flow diff| {d:.3e} px (tol {BASIC_STEP_TOL:g})")
        if not d <= BASIC_STEP_TOL:
            raise RuntimeError("alternate path disagrees with materialized")
        del basic
        cfg_sa = RAFTConfig(small=True, alternate_corr=True,
                            corr_impl="pallas")
        cfg_sm = RAFTConfig(small=True, corr_impl="pallas")
        d = flow_diff(*(kitti_flows(load_pth(fixture, c).cuda(), c, tmp,
                                    KITTI_ITERS) for c in (cfg_sa, cfg_sm)))
        log(f"[10] small model (trained fixture), iters={KITTI_ITERS}, "
            f"alternate (K5) vs materialized (K1): max |flow diff| {d:.3e} px "
            f"(tol {SMALL_TOL:g})")
        if not d <= SMALL_TOL:
            raise RuntimeError("small model: alternate disagrees with "
                               "materialized")

        # -- 11. Sintel submission with warm start over demo-frames ----------
        demo = sorted(glob.glob(os.path.join(REPO, "demo-frames", "*.png")))
        for dstype in ("clean", "final"):
            scene = os.path.join(tmp, "Sintel", "test", dstype, "demo")
            os.makedirs(scene)
            for f in demo:
                shutil.copy(f, scene)
        subs = {}
        for name, c in (("alternate", cfg_sa), ("materialized", cfg_sm)):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            subs[name], branches["sintel_" + name] = k5_branches(
                lambda: sintel_submission(load_pth(fixture, c).cuda(), c, tmp,
                                          os.path.join(tmp, "sub-" + name)),
                "cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (2 * (len(demo) - 1))
            counts = kernels.launch_counts()
            log(f"[11] create_sintel_submission(warm_start=True), small "
                f"fixture, {name}: {ms:.2f} ms/pair with PNG decoding, "
                f"{len(subs[name][0])} .flo files, launches {counts}; "
                f"corr_alt {branch_note(branches['sintel_' + name])} (the "
                "trained model's flow on real Sintel frames)")
            n_steps = 32 * 2 * (len(demo) - 1)
            want = (expected_launches(corr_alt=n_steps) if name == "alternate"
                    else expected_launches(corr_lookup=n_steps))
            if counts != want:
                raise RuntimeError(f"{name} submission launches {counts}")
        frames = [read_png(f).astype(np.float32) for f in demo]
        check_sintel_chain(subs, frames, {
            name: (make_forward(c, 32, device="cuda")[1],
                   load_pth(fixture, c).cuda())
            for name, c in (("alternate", cfg_sa), ("materialized", cfg_sm))})

        # -- 12. training from the command line, mixed precision ----------
        cli = train_cli_phase(tmp, smi)
        cli_launches = cli["launches"]

    # -- 13. memory at 1080x1920 ---------------------------------------------
    hd_frames = synthetic_frames(3, 2, HD_HW)
    cfg_ha = RAFTConfig(alternate_corr=True, corr_impl="pallas",
                        gru_impl="fused")
    cfg_hm = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    hd = {}
    for name, c in (("alternate", cfg_ha), ("materialized", cfg_hm)):
        model = RAFT(c, torch.Generator().manual_seed(0)).cuda()
        run_pairs(model, c, hd_frames, HD_ITERS)              # warm-up
        kernels.reset_launch_counts()
        _, ms, peak = hd[name] = run_pairs(model, c, hd_frames, HD_ITERS)
        counts = kernels.launch_counts()
        log(f"[13] basic model, 1080x1920, iters={HD_ITERS}, {name}: "
            f"{ms:.2f} ms/pair, peak max_memory_allocated {peak:.0f} MiB, "
            f"launches {counts}; {smi}")
        key = "corr_alt" if name == "alternate" else "corr_lookup"
        if counts[key] != HD_ITERS or counts["corr_alt" if key == "corr_lookup"
                                             else "corr_lookup"]:
            raise RuntimeError(f"1080p {name} launches {counts}")
        del model
    grid_hd = (HD_HW[0] // 8, HD_HW[1] // 8)
    f1, pyr, coords = alt_inputs(gen, 256, 4, grid_hd)
    mat_pyr = build_corr_pyramid(f1, pyr[0])
    k1 = corr_lookup_cuda(mat_pyr, coords, 4)
    e_k1 = max_err(k1, corr_lookup_gather(mat_pyr, coords, 4))
    k5 = alt_corr_lookup_cuda(f1, pyr, coords, 4)
    e_k5 = max_err(k5, k1) / float(k1.abs().max())
    hd_bound, hd_bound_fp32 = alt_bound(*alt_cost(f1, pyr, coords, 4))
    hd_k5_ms = median_kernel_ms(
        lambda: alt_corr_lookup_cuda(f1, pyr, coords, 4), 20, 5, flush=flush)
    hd_k1_ms = median_kernel_ms(
        lambda: corr_lookup_cuda(mat_pyr, coords, 4), 20, 5, flush=flush)
    log(f"[13] 1080x1920 grid {grid_hd[0]}x{grid_hd[1]} (N = "
        f"{grid_hd[0] * grid_hd[1]}, N^2 = {(grid_hd[0] * grid_hd[1]) ** 2:.3e}, "
        f"iid field;"
        f" volume pyramid {sum(v.numel() for v in mat_pyr) * 4 / 2 ** 30:.2f} "
        f"GiB, fmap2 pyramid {sum(v.numel() for v in pyr) * 4 / 2 ** 20:.1f} "
        f"MiB): corr_lookup vs plain {e_k1:.3e} (tol {LOOKUP_TOL:g}); "
        f"corr_alt vs corr_lookup {e_k5:.3e} of the largest (tol "
        f"{ALT_MAT_TOL:g}); corr_alt {hd_k5_ms[0]:.4f} ms ({hd_k5_ms[1]:.4f}"
        f"-{hd_k5_ms[2]:.4f}; bound {hd_bound[0]:.4f} ms by {hd_bound[1]}, "
        f"fp32 figure {hd_bound_fp32[0]:.4f}), corr_lookup {hd_k1_ms[0]:.4f} ms "
        f"({hd_k1_ms[1]:.4f}-{hd_k1_ms[2]:.4f}) (profiler, L2 cold, the "
        f"median of 5 sessions of 20 calls and their range); {smi}")
    if not (e_k1 <= LOOKUP_TOL and e_k5 <= ALT_MAT_TOL):
        raise RuntimeError("the lookups disagree at 1080x1920")
    del f1, pyr, coords, mat_pyr, k1, k5

    # -- 14. the demo CLI on demo-frames, with the port's PNG codec ----------
    t0 = time.perf_counter()
    frame0 = read_png(demo[0])
    decode_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        demo_main(["--model", fixture, "--small", "--path",
                   os.path.join(REPO, "demo-frames"), "--out", tmp,
                   "--corr_impl", "pallas"])
        demo_s = time.perf_counter() - t0
        outs = sorted(glob.glob(os.path.join(tmp, "*.png")))
        back = read_png(outs[0])
        log(f"[14] python -m raft_tpu_torch.cli.demo --path demo-frames "
            f"--small: {len(outs)} flow PNGs in {demo_s:.2f} s, each "
            f"{back.shape} {back.dtype}; one 436x1024 frame decodes in "
            f"{decode_ms:.1f} ms on the host (Paeth rows)")
        if len(outs) != len(demo) - 1 or back.shape != (2 * FRAME_HW[0],
                                                        FRAME_HW[1], 3):
            raise RuntimeError("the demo wrote the wrong images")
        if not np.array_equal(back[:FRAME_HW[0]], frame0):
            raise RuntimeError("the demo's PNG does not hold its frame")

    # -- 15. the supervised drill; 16. the measuring CLIs --------------------
    with tempfile.TemporaryDirectory() as tmp:
        drill = supervised_drill_phase(tmp, smi)
        clis = measuring_clis_phase(tmp, smi)
    env = clis["envelope"]
    for name, t in (("gru_gates", times["gru_gates"]),
                    ("gru_blend", times["gru_blend"])):
        b = envelope_bound_ms(t, env)
        log(f"[16] {name} at the inference geometry (1,7040,128): bound at "
            f"the measured envelope {b[0]:.4f} ms by {b[1]} ({t['nbytes'] / 1e6:.2f}"
            f" MB at {env['copy_gbps']:.1f} GB/s), the median of 5 sessions "
            f"{t['ms']:.4f} ms L2 cold: {b[0] / t['ms']:.1%} of it "
            f"({t['bound'][0] / t['ms']:.1%} of the data sheet's); {smi}")

    # -- 17. the serving engine ----------------------------------------------
    serving = serving_phase(smi)

    # -- 18. the serving front end -------------------------------------------
    frontend = serving_frontend_phase(smi)

    # -- 19. multi-model serving and the replica fleet -----------------------
    t19 = time.perf_counter()
    registry = registry_fleet_phase(smi)
    registry["seconds"] = time.perf_counter() - t19

    # -- 20. the program store, the transport and the host fleet -----------
    t20 = time.perf_counter()
    hosts = store_hosts_phase(smi)
    hosts["seconds"] = time.perf_counter() - t20

    # -- 21. .msgpack weights and data-parallel training ---------------------
    t21 = time.perf_counter()
    parallel = parallel_phase(smi)
    parallel["seconds"] = time.perf_counter() - t21

    # -- 22. the spatial axis ------------------------------------------------
    spatial = spatial_phase(smi)

    # -- 23. follower ranks --------------------------------------------------
    followers = follow_phase(smi)

    # -- 24. JPEG frames, the flow video and the native flow codec ----------
    t24 = time.perf_counter()
    video = video_phase(smi, clis["loader_bench"])
    video["seconds"] = time.perf_counter() - t24
    log(f"[24] the phase took {video['seconds']:.1f} s")

    # -- 25. GMA's kernels and a GMA bucket ----------------------------------
    t25 = time.perf_counter()
    gma = gma_phase(smi)
    gma["seconds"] = time.perf_counter() - t25

    # -- 26. result ----------------------------------------------------------
    sources = {"corr_lookup": ("raft_tpu_torch/csrc/corr_lookup.cu",
                               "raft_tpu/kernels/corr_pallas.py:177"),
               "gru_gates": ("raft_tpu_torch/csrc/gru.cu",
                             "raft_tpu/kernels/gru_pallas.py:93"),
               "gru_blend": ("raft_tpu_torch/csrc/gru.cu",
                             "raft_tpu/kernels/gru_pallas.py:112"),
               "corr_scatter": ("raft_tpu_torch/csrc/corr_lookup.cu",
                                "raft_tpu/kernels/corr_pallas.py:219"),
               "gru_gates_bwd": ("raft_tpu_torch/csrc/gru.cu",
                                 "raft_tpu/kernels/gru_pallas.py:101"),
               "gru_blend_bwd": ("raft_tpu_torch/csrc/gru.cu",
                                 "raft_tpu/kernels/gru_pallas.py:117")}
    rows = []
    for name, (source, replaces) in sources.items():
        # the inference kernels keep phase 4's times at the inference
        # geometry; every kernel has its training-geometry times (phase 6)
        t = times.get(name, train_times[name])
        tt = train_times[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": train_launches[name],
               "max_abs_err": err[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["library_ms"],
               "ms_l2_warm": t["ms_l2_warm"],
               "train_geometry": {"ms": tt["ms"], "ms_l2_warm": tt["ms_l2_warm"],
                                  "plain_ms": tt["plain_ms"],
                                  "library_ms": tt["library_ms"],
                                  "bound_ms": tt["bound"][0],
                                  "bound_by": tt["bound"][1],
                                  "mbytes": tt["mbytes"]}}
        if name in GRU_NAMES:
            row["layouts_ms"] = {k.replace(f".{name}", ""): v
                                 for k, v in gru_layout_times.items()
                                 if k.endswith(f".{name}")}
        if name in times:
            row["launches_inference"] = launches[name]
            row["call_ms"] = t["call_ms"]
        if "ms_range" in t:
            row.update(ms_range=t["ms_range"],
                       ms_l2_warm_range=t["ms_l2_warm_range"])
        row["bound_envelope_ms"] = envelope_bound_ms(t, env)[0]
        row["train_geometry"]["bound_envelope_ms"] = envelope_bound_ms(
            tt, env)[0]
        # phase 12's mixed-precision training through cli/train
        row["launches_train_cli"] = cli_launches[name]
        row["launches_supervised_drill"] = drill["launches_recovered_run"][
            name]
        row["launches_clis"] = {k: v[name] for k, v in
                                clis["launches"].items() if name in v}
        if name in SERVE_KERNELS:
            # phase 17's dispatches: each replay's launches as its capture
            # recorded them (held to the profiler's count of one replay)
            row["launches_serving"] = serving["launches_serving"][name]
            row["launches_serving_per_replay"] = serving[
                "launches_per_replay"][name]
            # phase 18's scheduler dispatches, each a replay of a bucket
            # graph (the drills' runs, timed and profiled)
            row["launches_serving_frontend"] = frontend[
                "launches_serving_frontend"][name]
            # phase 19's dispatches: the registry drills (two models, the
            # guardian, the chaos rounds' traffic is the small fixture's
            # and the basic model's at iters 1, not counted) and the
            # replica fleet, each a replay of a bucket graph
            row["launches_registry"] = registry["launches_registry"][name]
            row["launches_fleet"] = registry["launches_fleet"][name]
            # phase 20's dispatches in this process: the store's engines
            # (loaded, exported, live), the loopback drill's primary lane
            # and the kill drill's (each a replay of a bucket graph; the
            # host lanes' and the worker processes' replays are theirs)
            row["launches_store_hosts"] = hosts["launches_store_hosts"][name]
        # phase 21 (c): both ranks' launches in the two-rank step
        row["launches_parallel"] = sum(
            r[name] for r in parallel["two_ranks"]["launches"])
        # phase 22: both spatial ranks' counted runs (the sharded engine's
        # two pairs, the two steps)
        row["launches_spatial"] = spatial["launches_spatial"][name]
        # phase 23: each rank's sessions (the scheduler's shard and
        # replicate dispatches on rank 0, their repeats on rank 1)
        row["launches_follow"] = [n[name]
                                  for n in followers["launches_follow"]]
        if name in SERVE_KERNELS:
            # phase 24: cli/parity over JPEG frames (wrapper calls: the
            # plain path, the capture's warm-up and the capture; then the
            # replays) and cli/demo, the basic model
            row["launches_video"] = {
                "parity": video["parity"]["launches"].get(name, 0),
                "parity_replayed": video["parity"]["replayed_launches"].get(
                    name, 0),
                "demo": video["demo"]["launches"].get(name, 0)}
        row["dtypes_train_cli"] = cli["dtypes"].get(name, {})
        if name in err_bf16:
            row["max_abs_err_bf16"] = err_bf16[name]
        if name == "corr_lookup":
            row.update(sector_mbytes=t["sector_mbytes"],
                       sector_ms=t["sector_ms"])
            row["train_geometry"].update(
                sector_mbytes=tt["sector_mbytes"], sector_ms=tt["sector_ms"])
        rows.append(row)
    # K5: launches from the evaluation path's run (phase 10), times at that
    # path's geometry (phase 9) on the smooth field, the iid field's beside
    # them, with the materialized path and the branch shares
    t, ti = alt_times["smooth"], alt_times["iid"]

    def share(br):
        return br[0] / max(br[0] + br[1], 1)

    rows.append({"name": "corr_alt", "route": "cuda",
                 "source": "raft_tpu_torch/csrc/corr_alt.cu",
                 "replaces": "raft_tpu/kernels/corr_alt_pallas.py:95",
                 "launches": evals["alternate"][3]["corr_alt"],
                 "max_abs_err": err["corr_alt"],
                 "max_abs_err_3x_fmaps": err_3x, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                 "bound_by": t["bound"][1], "library_ms": None,
                 "ms_l2_warm": t["ms_l2_warm"], "mbytes": t["mbytes"],
                 "field": "smooth", "grid": list(eval_grid),
                 "bound_fp32_ms": t["bound_fp32"][0],
                 "tiled_share": share(t["branches"]),
                 "iid_field": {"ms": ti["ms"], "ms_l2_warm": ti["ms_l2_warm"],
                               "plain_ms": ti["plain_ms"],
                               "bound_ms": ti["bound"][0],
                               "bound_by": ti["bound"][1],
                               "bound_fp32_ms": ti["bound_fp32"][0],
                               "tiled_share": share(ti["branches"])},
                 "bound_envelope_ms": envelope_bound_ms(t, env, tf32=True)[0],
                 "launches_clis": {k: v["corr_alt"] for k, v in
                                   clis["launches"].items() if "corr_alt" in v},
                 "launches_follow": [n["corr_alt"] for n in
                                     followers["launches_follow"]],
                 "tiled_share_kitti_eval": share(branches["alternate"]),
                 "tiled_share_sintel": share(branches["sintel_alternate"]),
                 "materialized_build_ms": mat_build_ms,
                 "materialized_build_ms_events": mat_build_ev,
                 "materialized_k1_ms": mat_k1_ms,
                 "hd_1080x1920": {"ms_median_range": list(hd_k5_ms),
                                  "bound_ms": hd_bound[0],
                                  "bound_fp32_ms": hd_bound_fp32[0],
                                  "k1_ms_median_range": list(hd_k1_ms),
                                  "ms_per_pair": {k: v[1] for k, v in hd.items()},
                                  "peak_mib": {k: v[2] for k, v in hd.items()}}})
    # K6, K7: times and errors at the GMA cell's grid (phase 25), batch 1,
    # batch 2 beside them; launches a replay of the GMA bucket
    for name in ("attention", "aggregate"):
        t, t2 = gma["batches"][1][name], gma["batches"][2][name]
        key = f"gma_{name}"
        rows.append({"name": key, "route": "cuda",
                     "source": "raft_tpu_torch/csrc/gma.cu", "replaces": None,
                     "launches": gma["engine"]["launches_per_replay"][key],
                     "launches_traced": gma["engine"]["traced_per_replay"][
                         f"{key}_kernel"],
                     "rel_err": t["rel_err"],
                     "plain_rel_err": t["plain_rel_err"],
                     "max_abs_gap": t["max_abs_gap"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1],
                     "bound_fp32_ms": t["bound_fp32_ms"],
                     "mbytes": t["mbytes"], "grid": gma["grid"],
                     "batch_2": {k: t2[k] for k in ("ms", "plain_ms",
                                                    "rel_err",
                                                    "plain_rel_err")}})
    print(json.dumps({"gma": gma}), flush=True)
    print(json.dumps({"supervised_drill": drill, "envelope": env,
                      "serving": serving}), flush=True)
    print(json.dumps({"serving_frontend": frontend}), flush=True)
    print(json.dumps({"serving_registry": registry}), flush=True)
    print(json.dumps({"serving_store_hosts": hosts}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"spatial": spatial}), flush=True)
    print(json.dumps({"follow": followers}), flush=True)
    print(json.dumps({"video": video}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
