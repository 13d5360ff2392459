"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught):

1. Build every CUDA kernel of the serving and training paths from the
   sources in this checkout (``nvcc``, one process per source, all
   started together, beside the native C++ data path's ``g++`` build),
   and print each kernel's registers and shared
   memory as ``ptxas`` reports them; the float32 flash forward, paged
   decode, BatchNorm's two reductions and LRN's vector kernels must spill
   nothing.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and time the kernel, the plain version and a
   library yardstick (which the port never calls: ``gather_pages`` +
   ``scaled_dot_product_attention`` for paged decode, SDPA forward and
   backward for flash attention (bfloat16, float16 and float32 cases),
   ``F.layer_norm`` for the prologue (bfloat16, float32, float16),
   ``F.batch_norm`` for BatchNorm),
   beside the least time the card could take (the bytes the call must
   move at 3.35 TB/s, or its operations at the peak rate for their type,
   whichever is larger).  Each flash case prints the kernels its calls
   take (``fa.kernel_path``); a bfloat16 or float16 case at D = 64 or 128
   must take wgmma for the forward, dQ and dK/dV, a float32 one tf32x3
   for all three (bounded at a third of the TF32 rate, with the CUDA
   cores' bound printed beside it), and the delta its dQ hands to dK/dV
   must match the torch reduction ``_row_delta``.  Paged decode runs at
   the engine's shapes and at contexts up to 4096 keys, where its split
   over the key range has the most blocks to merge, and at a prefix
   hit's suffix prefill (16 queries over 528 keys).
3. Serve the transformer char-LM at full width (vocab 128, d_model 1024,
   8 heads, 8 layers, bfloat16, seeded random weights) through the port's
   ``GenerationEngine`` (16 slots, pages of 16, context 512): 16
   concurrent greedy requests of 64 new tokens from 4 client threads,
   then the same 16 sampled (temperature 0.8, top_k 20, a fixed seed
   each).  Twice: through the captured CUDA graphs the engine runs by
   default (one for decode, one per prefill bucket, captured at start and
   never again: the capture count is checked after the warm-up and after
   serving), and through the engine's programs run eagerly (its internal
   switch ``_capture = False``).  Greedy and sampled tokens must be identical
   between the two.  The captured engine serves the greedy requests once
   more, the counts at 0, under ``torch.profiler``, whose
   ``paged_decode_kernel`` launches must be layers x calls (the wrapper's
   count ticks where a launch is recorded into a graph, not on replay):
   that count is the kernels line's.  Each mode prints its
   decode-step median, TTFT p50/p99, tokens/s, and a profiled window of
   full-batch decode steps: host wall, device busy, idle share and
   device operations a step.  The first prefill's logits are then checked
   against the gather oracle.
   Then ``generate`` at the same width (batch 16, prompt 64, 448 steps:
   64 + 448 - 1 = 511 positions of the linear cache's 512): greedy ids of
   the captured loop must equal ``sample_sequence``'s (the host loop over
   ``rnn_time_step``), a second call must capture nothing, and the first
   replayed step's log-probabilities are held against the loop's; then
   the rolling cache (2 kv heads, window 128, wrapped three times) the
   same way.  Sampled ``generate`` (float32, where the top logits do not
   tie) gives the same ids for the same seed, others for another, the
   greedy ids at top_k=1, and ``sample_sequence``'s ids with the same
   seed (step i of both reads noise slice i) in at least 15 of 16 rows:
   a row may part where two perturbed scores lie within the rounding of
   log-probabilities against logits; a wrong noise slice parts every
   row.
   Then bench.py's prefix-cache arm at its TPU-tier widths
   (``bench.py:840-911``): the same model at context 640, prefill buckets
   (16, 576), ``prefix_cache=True``; a 512-token system prefix, pinned,
   then 40 requests of 24 new tokens, 9 in 10 of them hits (the prefix
   plus a tail of 4-12 tokens; a miss is a random 512 plus a tail), one
   at a time: hit and miss TTFT p50/p99; the four-turn pinned chat (each
   turn's prefill only the new tokens), profiled (its paged launches
   layers x calls, added to the kernels line's); nothing captured after
   start; a cached page copied through the host tier into another page
   and read back bit for bit; each hit's greedy ids against an engine
   without the cache (equal, or parting where the cold path's top two
   logits lie within ``LOGITS_TOL``: the suffix prefill's matmuls have
   other shapes than the cold prefill's); the tree's stats; then the
   spill drill (d 32, 2 layers, pages of 4, 13 pages, 2 slots): six
   prompts twice, pages spilled to the host tier and restored, the
   revisits' ids equal the first pass's.
   Then the hot swap: 16 client threads keep greedy streams of 64 tokens
   in flight while a second seed is deployed (retained), rolled back,
   deployed again and committed: no stream dropped or short, each new
   version captures one decode graph and one per prefill bucket at its
   deploy and nothing after, the rollback serves the retained programs
   without capturing; the longest gap between two tokens of any stream
   during each deploy is printed; after the commit 16 requests give the
   ids of a fresh engine on the new weights.
4. Train the same model at full width (batch 8, T = 2048, Adam at 1e-3,
   ``bench.py``'s batch: random ids from ``RandomState(0)``, labels the
   one-hot of the ids rolled by one).  The first step's loss and
   per-layer gradients are held against the built-in path
   (``enable_helpers(False)``).  Then 2 warm-up and 5 timed ``fit`` steps
   in each mode from one state (``fit_modes``): eagerly (the nets'
   internal switch ``_capture`` off), eagerly again, and through the
   captured CUDA graph that ``fit`` replays by default.  Eager, the
   wrappers count 8 forward, 8 dQ, 8 dK/dV and 16 prologue launches a
   step; captured, one step's worth at the warm-up and one at the
   capture (the counts tick where a launch is recorded, not on replay),
   the graph holds one step's, and there is one capture from the first
   step on.  If the two eager runs agree bit for bit, the captured run
   must equal them bit for bit (losses, params, updater state, running
   stats); else the leaves that differ are named and the three runs are
   repeated with ``cudnn.deterministic``, and if the eager runs still
   differ the captured one is held to twice their largest difference.
   Each mode prints its step median, tokens/s, analytic-FLOP
   utilisation and the spread of its timed steps, then two steps under
   ``torch.profiler`` (host wall, busy, idle share; the flash kernels
   must be the routes' own, ``flash_dq_wgmma`` and the like, 8 a step
   each and 16 prologue: those profiled launches of the captured mode
   are the kernels line's) and one with the host traced (no
   ``_row_delta`` reduction: delta comes from the dQ kernel).  Then the
   same in float32, the zoo default (no ``compute_dtype``), whose
   profiled steps must run ``flash_fwd_tf32``, ``flash_dq_tf32`` and
   ``flash_dkv_tf32``.
5. Hold the three BatchNorm kernels (training forward, training
   backward, inference) against their plain versions at ResNet-50's
   shapes (bfloat16; a float32 and a float16 case, ragged C, and gamma
   and beta in bfloat16 as the layer passes them), and time them beside
   ``F.batch_norm`` (cuDNN, on channels_last views) and their bound.
6. ResNet-50 as a ComputationGraph at full width (224x224x3, 1000
   classes, batch 128, bfloat16, Nesterov at 0.1, ``bench.py``'s batch:
   ``RandomState(0)`` images in [0, 1) and one-hot labels; seeded random
   weights).  ``output`` eagerly (the inference kernel once per
   BatchNorm layer, 53) and captured (two calls: a warm-up and capture,
   then a replay, both equal to the eager probabilities bit for bit),
   each mode profiled over two calls (53 inference kernels a call); the
   logits are held against the built-in path (``enable_helpers(False)``:
   the logits and their argmax); the first step's loss (bfloat16) and
   per-node gradients (float32 compute, where they are not rounding) are
   held against the built-in path; then ``fit_modes`` as in 4 (53
   training-forward and 53 training-backward wrapper launches a step,
   finite losses, running stats that moved) and each mode's two profiled
   steps, which must launch two BatchNorm kernels for each of those calls
   (212 a step: the reduction and the elementwise pass), split by pass
   (moments, grad sums, apply, dx).
   Then the batch ``ServingEngine`` over a second ResNet-50 (the same
   config) with bench_serving's policy and traffic
   (``bench.py:1050-1158``): ``BucketPolicy(max_batch=64)`` (7 buckets,
   one captured ``output`` graph each at warm-up, counted by the
   version's detector), 8 client threads of 40 requests of 1-16 seeded
   rows each: rows/s and latency p50/p99; a profiled 64-row dispatch
   launches the BatchNorm inference kernel 53 times; nothing captured
   after warm-up; a deploy of another seed (retained, its 7 graphs
   captured while the first version serves) and a rollback under load
   from 8 threads, no request failing; then every timed result against
   the net's eager ``output`` on the same rows (logits as centred
   log-probabilities, ``RESNET_LOGITS_TOL`` over the largest; argmax
   differences allowed only on near-ties: a bucket's batch mixes rows of
   several requests).
7. Hold the two LRN kernels (forward, backward) against their plain
   versions at AlexNet's shapes (``[373248, 96]`` and ``[86528, 256]``
   in bfloat16; a float32, a float16, a ragged C = 130, a C = 3 < n and
   an n = 7 case), each on the route it must take (``lrn.route``: the
   vector kernels for AlexNet's shapes, the staged ones for C = 130 and
   C = 3), and time them beside ``F.local_response_norm`` (odd n only,
   its alpha times n: cuDNN's convention divides alpha by the window)
   and their bound.
8. AlexNet as a MultiLayerNetwork at full width (zoo ``alexnet``:
   224x224x3, 1000 classes, batch 128, bfloat16, Nesterov at 0.01 with
   l2 5e-4; ``RandomState(0)`` images in [0, 1) and one-hot labels;
   seeded random weights).  ``output`` eagerly (two LRN forward
   launches) and captured, equal bit for bit; the logits are held
   against the built-in path (logits and argmax); the first step's loss
   (bfloat16) and per-layer gradients (float32 compute) are held against
   the built-in path with the same dropout key; the two dropout masks of
   a step are drawn in a captured graph from the device keys of the
   net's next two steps and held against the eager draws from host keys
   of the same seeds (equal; the two steps' differ), and the draw is
   timed; then ``fit_modes`` (2 forward and 2 backward LRN launches a
   step) and each mode's profiled steps, which must run the vector
   route's kernels 4 times a step (``lrn_fwd_vec``, ``lrn_bwd_vec``),
   with their time by layer.
9. LeNet (zoo ``lenet``, MNIST-shaped: 784 inputs, 10 classes, float32,
   batch 128, ``RandomState(0)`` host batches): ``fit_modes`` over 7
   batches; then three passes over 24 batches by eager ``fit``, captured
   ``fit`` and ``fit_scanned(scan_steps=8)`` from one state, the third
   pass timed (ms a step each); ``fit_scanned`` must equal captured
   ``fit`` bit for bit (under ``cudnn.deterministic`` if ``fit_modes``
   found the eager runs apart) with one capture.
10. The GravesLSTM char-LM (zoo ``graves_lstm_char_lm``,
   ``BASELINE.md:31``: 2x200, vocab 77, RMSProp at 0.1, TBPTT 50,
   float32; batch 128, T 50, ``bench.py``'s batch: ``RandomState(0)``
   characters, one-hot, the next character as label).  It reaches no
   kernel of the port: its matmuls are cuBLAS's, the rest elementwise.
   The first step's loss and per-layer gradients against the CPU's on
   the same weights (full float32 matmuls on both); ``fit_modes`` (no
   wrapper launches; captured equal to eager bit for bit); both modes
   profiled over two steps and host-traced (``cudaLaunchKernel`` a step
   eager against one ``cudaGraphLaunch``).  Two batches of T 210 (TBPTT
   windows 50, 50, 50, 50, 10) captured and eager from one state: five
   iterations a batch, two programs captured, bit for bit.  ``generate``
   over 16 streams (prompt 16, 112 steps), greedy and sampled: the
   captured loop (the LSTMs' (h, c) its graph state) equal to the eager
   decode function, and to ``sample_sequence`` in at least 15 of 16
   rows; ms a token each; ``rnn_time_step`` fed in chunks (16, 1, 47,
   64 steps) against one ``output`` over the 128, on the zoo's fresh
   weights (the trained ones' differences printed by timestep: the
   recurrence carries a rounding difference of cuBLAS's shapes from
   step to step).  Then the same
   layers as a ``ComputationGraph`` whose head reads the last step
   (``LastTimeStepVertex``): two ``fit`` steps captured and eager, bit
   for bit.
11. The HTTP server: the port's ``InferenceServer`` on localhost over a
   ``ServingEngine`` (ResNet-50 bf16 ``output``, ``BucketPolicy(max_batch
   =64)``, the model named ``resnet50``) and a ``GenerationEngine`` (the
   char-LM of 3, its 16 slots and pages of 16, ``prefix_cache=True``).
   16 client threads send 4 ``POST /generate`` each (16-token seeded
   prompts, 64 new tokens, greedy, three in four with ``stream: true``,
   read event by event), while 4 threads send 20 ``POST /predict`` each
   (1-16 seeded rows in the NDArray envelope), one thread posts a zip of
   ResNet-50 at a second seed to ``/models/resnet50`` (retained) and then
   ``/models/resnet50/rollback``, and another scrapes ``/metrics``,
   ``/health``, ``/healthz``, ``/models`` and ``/generation/cache``
   throughout.  No request may fail; nothing is captured after warm-up
   but the swap's seven buckets, and the rollback captures none; a
   profiled window (one streamed request, one 16-row ``/predict``) must
   launch paged decode, the prologue and 53 BatchNorm inference
   kernels (added to the kernels line's).  Prints the HTTP TTFT
   (send to first SSE event) beside the engine's ``ttft_s``, the SSE
   inter-event p50/p99, the longest gap during the swap, ``/predict``
   rows/s and latency.  Then every ``/generate`` result must equal
   ``engine.generate``'s ids for its prompt (an engine without the
   prefix cache: the same cold prefill), and every ``/predict`` argmax
   the eager forward's of the version that served it, differences only
   on near-ties.
12. The in-step guard.  (a) ResNet-50 bf16 at batch 128 under
   ``training_stability(loss_scaling="dynamic", check_every=2)``, 8
   captured steps from host batches, ``FaultInjector.poison_gradients``
   poisoning step 3 with NaN and step 5 with infinity before staging:
   each poisoned step leaves every param, Nesterov and running-stat
   tensor as it was bit for bit, the scale halves at each, the sentinel's
   check after step 5 harvests a non-finite count of 2, the net holds
   one train graph, and a profiled guarded step launches BatchNorm's
   reductions 53 times each (added to the kernels line's).  Then 7 steps
   each, from one state: unguarded twice, guarded without scaling, and
   guarded with dynamic scaling; the guarded run without scaling must
   equal the unguarded one bit for bit (all four again under
   ``cudnn.deterministic`` if the two unguarded runs differ); the medians
   of 5 steps after 2 warm-up are the guard's cost.  (b) The char-LM of 4
   in float16 under dynamic scaling from 2^32 (``loss_scale_max`` 2^32,
   factor 16, growth after 2 finite steps): over 10 steps the scale must
   follow the rule (divided at each non-finite step, multiplied after
   two finite ones), fall at least once and grow at least once, and no
   step may leave a non-finite param; the guarded and unguarded medians;
   a profiled guarded step's flash and prologue launches (added to the
   kernels line's).
13. Resume: ResNet-50 bf16 at batch 128 with a ``CheckpointManager`` in
   a temporary directory (a save every 2 steps, the async writer) over 6
   device batches.  A runs uninterrupted; B takes a fatal fault at step 3
   and raises, then a fresh net's ``fit`` resumes from step 2 and
   finishes, and apart the crashed net (its captured graph kept) is
   restored in place and finishes; C takes a transient fault at step 4
   under a ``RetryPolicy``; D is preempted (``PreemptionHandler.
   trigger()``) before its fourth step and must commit a priority
   checkpoint and return.  B's and C's params, updater state and running
   stats must equal A's bit for bit.  Prints the snapshot ms on the
   training thread, the commit ms off it, the bytes a save and the
   restore ms.
14. Online learning: a ResNet-50 trainer (bf16, Nesterov 0.1, captured
   ``fit``, ``conf.introspection`` set) fed by a ``MessageBroker`` topic
   of ``dataset_to_json`` records of 16 images, windows of 4, beside a
   second ResNet-50 ``ServingEngine`` (max batch 64) that 4 client
   threads query throughout; ``default_gate_rules(max_loss_regression=
   0.05)`` over 64 held-out images, a canary of a quarter of the traffic,
   a retaining swap and a 1 s watch.  Four windows: the held-out images
   with their labels twice, the same images with every label moved by
   one class, and the held-out images again with a trainer crash at the
   window's second step (``FaultInjector.fail_at_step``).  The outcomes
   must be promoted, promoted, rejected (the registry untouched, the
   trainer reverted into its own tensors), promoted after a replay whose
   params equal an uncrashed twin's bit for bit (under the guard phase's
   ``cudnn.deterministic`` choice); every evaluation has its accuracy; no
   client request fails; the trainer captures nothing after window 1;
   ``torch.cuda.memory_allocated()`` after window 4 within 5 % of window
   2's.  Prints each window's freshness, its split in ms (fit, save, zip
   write, candidate load, evaluate, canary, swap, watch), both held-out
   losses and the memory.
15. Introspection: the training char-LM (batch 8 x 2048, bf16, Adam)
   captured four ways — no policy, introspection, the numerics ledger,
   both — 12 steps each with a ``StatsListener`` reporting every 10:
   params bit for bit the no-policy run's, no capture after the 2
   warm-up steps (two programs under the ledger's interval: collecting
   and skipping), and the last step's harvested gradient, update and
   parameter norms within 1e-3 of a float64 recomputation from that
   step's gradients (computed eagerly beforehand) and parameters.
   Prints each run's step median and each policy's overhead.
16. Kernel trust: ``observability.kerneldiff`` on the card, every forward
   kernel against the float64 numpy references at the reference sweep's
   full grid and at the path's shapes (the char-LM's flash forward in
   bf16 and float32, the engine's decode, the prologue, AlexNet's first
   LRN, ResNet-50's stem BatchNorm); a kernel's error propagates.
   Prints max-abs, max-rel, the ULP spread and the class for each kernel
   and dtype; each forward kernel's path max-rel joins its entry on the
   kernels line as ``f64_max_rel``.
17. The fleet (``fleet/``): a broker, a ``FleetAggregator`` over its
   URL, and a ``ReplicaSupervisor`` spawning two replicas of the serving
   char-LM (``python -m deeplearning4j_tpu_torch.fleet.replica_main``:
   the same seed, so the same weights; each its own process, CUDA
   context, pools and graphs on the one card) behind a ``FleetRouter``
   and its HTTP ``FleetFrontend``; four clients send ``/generate``,
   streamed and unary, 4 in 10 on one shared 16-token page (the
   router's affinity unit).  A session pinned on one replica keeps its
   requests there; drill A SIGKILLs that replica while a burst of the
   session's streams is on it (queued ones fail over to the survivor,
   those in flight end in a terminal SSE error event, the session is
   pinned again on the survivor); drill B SIGKILLs a replica in the
   middle of a 256-token stream.  The supervisor restarts each, which
   rejoins under a fresh publisher epoch; the aggregator's ``/fleet``
   names both live.  Every completed request's ids equal a single
   in-process engine's for its prompt; every failed one is a killed
   stream whose tokens are a prefix of those ids.  Then a
   ``FleetRollout`` over two in-process engines under load: a candidate
   promoted (canary, wave, commit), a forced watch regression rolled
   back on both (the rolled-back version's graphs released), each
   engine then serving the promoted weights' ids.  Prints spawn and
   warm-up seconds, failover latency (kill to a retried request's first
   token), the restart's time and the survivor's longest token gap
   meanwhile, TTFT p50/p99 through the frontend against the single
   engine's, fleet tokens/s (two replicas time-sharing one card: not a
   scaling number) and ``nvidia-smi``'s per-process memory.
18. The step profiler: ``StepProfiler(capture_step=3)`` over the bf16
   char-LM's captured ``fit`` (batch 8 x 2048) and ResNet-50's (batch
   128), each beside an unprofiled twin: one capture named in the
   flight recorder with a ``torch.profiler`` Chrome trace naming the
   flash (BatchNorm) kernels and the ``fit_step`` host span, flops > 0
   and an unclamped MFU in (0, 1] over the CUDA-event span of the step,
   one compile of the train step, parameters bit for bit the twin's; the
   char-LM's counted flops within 15 % of the hand count (6 x matmul
   parameters x tokens + causal attention).  A fatal fault injected
   into the captured ``fit`` leaves a flight report whose memory
   attribution adds up to the parameters plus the updater state within
   1 %, with the card's peak allocation.  kerneldiff's sweep written
   with ``--out`` and compared with ``--baseline``: exit 0, and 1
   against a baseline doctored to tighten one kernel's max-rel.  Prints
   each model's MFU beside the hand count's, the step median with the
   profiler installed and idle against without, the capture step's
   time and the traces' size.
19. The rest of the conv zoo, pretraining, the solvers and the MoE layer
   (no port kernel on these paths: the kernels line is unchanged).
   VGG-16 (a MultiLayerNetwork, 138,357,544 parameters) and GoogLeNet (a
   ComputationGraph of nine inception modules) at 224x224x3, 1000
   classes, batch 128, bfloat16: ``output`` eager against captured bit
   for bit, float32 logits of two images on the card against a CPU twin,
   ``fit_modes`` (images/s, analytic-FLOP utilisation) and two profiled
   captured steps.  Zoo ``dbn`` (784 -> 500 -> 250 -> 100 -> 10, float32,
   24 host batches of 128): layerwise CD-1 pretraining for two epochs,
   captured (one program a RBM) against eager bit for bit, each RBM's
   held-out reconstruction error lower; an ``EarlyStoppingTrainer``
   fine-tune whose best model's recomputed score equals the result's;
   an L-BFGS ``fit`` (10 iterations) whose loss does not rise, its
   captured value/grad program against eager bit for bit, ms an
   evaluation.  The reference's MoE test net at the char-LM's width
   (Dense 1024, 8 experts of hidden 4096, capacity factor 1.25, 128
   classes, bfloat16, Adam) over 16384 rows: the routing against a
   numpy recount (loads within C = 2560, exact int32 positions, the
   dropped count), ``output`` eager against captured bit for bit, 2048
   rows in float32 against a CPU twin, ``fit_modes`` with the peak
   memory.
20. The data path into LeNet (etl_lenet): a full-size MNIST (60000
   train, 10000 t10k synthetic glyphs) written as IDX files, read by
   ``MnistDataSetIterator`` through the native IDX parser (seconds, and
   the images' parse against the plain decode, bit for bit), batched by
   ``NativeBatchDataSetIterator`` (128, shuffled: 468 full batches and a
   padded one of 96 under a labels mask) into captured ``fit`` for two
   epochs, four nets from one seed: with a ``StatsListener`` into a
   ``FileStatsStorage`` while a ``UIServer`` serves one SSE client and
   one ``/train/overview`` poller; without them; fed by the plain
   batcher; and fed the epoch's batches already on the card.  Epoch
   walls and ms a step of each (fit call to last loss), the listener's
   host ms a report; the four nets equal bit for bit after each epoch
   (under ``cudnn.deterministic`` where the lenet phase needed it), two
   captures each (full and masked) and none in the second epoch, SSE
   events equal to the stored reports, every overview poll answered 200
   and one after the fit seeing every report, t10k accuracy above 0.85.
21. ResNet-50 fed from files (etl_resnet): 8 batches of 128x224x224x3
   float32 written by ``export_datasets`` (``D4JT``), read back alone
   (GB/s), then through ``FileDataSetIterator`` behind an
   ``AsyncDataSetIterator`` into captured bf16 ``fit`` for two passes,
   against twins fed the same batches from host memory and from the
   card's memory: losses and state bit for bit; ms a step of the three
   feeds, each pass timed from its fit call to its last loss, and a
   profiled pass each (idle share); the BatchNorm training kernels'
   launches (warm-up and capture) join the kernels line's.
22. Native CSV into a two-input, two-output graph (multidataset): a
   100000-row CSV parsed natively (rows/s) and equal to the plain parse,
   then ``RecordReaderMultiDataSetIterator`` feeds a ``ComputationGraph``
   8 captured steps of 12500 rows, equal to an eager twin bit for bit.
23. Print the kernels line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero without printing a result when no CUDA device is
available or the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import helpers, native
from deeplearning4j_tpu_torch.backend.device import pin_fp32_precision
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.helpers import batch_norm as bn
from deeplearning4j_tpu_torch.helpers import flash_attention as fa
from deeplearning4j_tpu_torch.helpers import fused_epilogue as fe
from deeplearning4j_tpu_torch.helpers import lrn
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.models.common import seed_stream_caches
from deeplearning4j_tpu_torch.models.decode import (
    build_decode_fn, generate, named_layers_of,
)
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.common import cast_tree
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.models.sequential import (
    MultiLayerNetwork, tree_leaves,
)
from deeplearning4j_tpu_torch.models.vertices import LastTimeStepVertex
from deeplearning4j_tpu_torch.models.zoo import (
    alexnet, dbn, googlenet, graves_lstm_char_lm, lenet, resnet50,
    transformer_char_lm, vgg16,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.attention import gather_pages
from deeplearning4j_tpu_torch.nn.layers.convolution import ConvolutionLayer
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.dense import (
    DenseLayer, EmbeddingLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.autoencoder import RBM
from deeplearning4j_tpu_torch.nn.layers.moe import MoELayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
from deeplearning4j_tpu_torch.utils.sampling import (
    sample_sequence, step_noise,
)

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
# float32 products on the tensor cores in 3xTF32: three TF32 products (495
# TFLOP/s dense) per float32 one; the rate of the tf32x3 flash route only
TF32X3_OPS = 495e12 / 3
TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
LOGITS_TOL = 0.1    # bf16 logits, kernel vs gather oracle, 8 layers
MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
             max_cache=512, compute_dtype="bfloat16", seed=12345)
ENGINE = dict(slots=16, page_size=16, max_context=512, prefill_buckets=(16,))
PS, MAXP, PAGES = 16, 32, 16 * 32 + 1
# the long-context decode case's own table: 256 pages of 16, 4096 keys
LONG_PS, LONG_MAXP = 16, 256
LONG_PAGES = 16 * LONG_MAXP + 1
CLIENTS, PER_CLIENT, NEW_TOKENS = 4, 4, 64
SAMPLED = dict(temperature=0.8, top_k=20)    # the sampled requests
# generate: batch, prompt, steps (64 + 448 - 1 = 511 <= max_cache 512);
# the rolling cache's window wraps three times over the 448 steps
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 16, 64, 448
GEN_ROLLING = dict(n_kv_heads=2, window=128)
SPIN_CYCLES = 2_000_000     # about 1 ms of GPU clock: outlasts any enqueue
PROFILED_STEPS = 10
TRAIN_MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
                   compute_dtype="bfloat16", seed=12345)
# the zoo default: no compute_dtype, float32 throughout
TRAIN_MODEL_F32 = {k: v for k, v in TRAIN_MODEL.items()
                   if k != "compute_dtype"}
TRAIN_BATCH, TRAIN_T = 8, 2048
WARM_STEPS, TIMED_STEPS = 2, 5
LOSS_RTOL, GRAD_RTOL = 2e-2, 5e-2   # kernel path vs built-in path, bf16
KERNEL_ITERS = 10
RESNET = dict(compute_dtype="bfloat16", seed=12345)   # 224x224x3, 1000
RESNET_BATCH, RESNET_BN_LAYERS = 128, 53
# bf16 logits, kernels vs built-in path: error over max |logit| (7.4e-3
# measured on the H100) and images whose argmax may differ
RESNET_LOGITS_TOL, RESNET_ARGMAX_MISSES = 2e-2, 2
BN_CASES = [  # name, NHWC shape, dtype, gamma/beta dtype
    ("stem_bf16", (128, 112, 112, 64), torch.bfloat16, torch.float32),
    ("last_stage_bf16", (128, 7, 7, 2048), torch.bfloat16, torch.float32),
    ("stage3_bf16", (128, 14, 14, 1024), torch.bfloat16, torch.float32),
    ("stage1_f32", (128, 56, 56, 256), torch.float32, torch.float32),
    ("ragged_bf16", (13, 77, 101, 130), torch.bfloat16, torch.float32),
    ("ragged_f16", (13, 77, 101, 130), torch.float16, torch.float32),
    # gamma and beta as the layer passes them under a bf16 compute dtype
    ("last_stage_bf16_affine", (128, 7, 7, 2048), torch.bfloat16,
     torch.bfloat16),
]
DELTA_TOL = 1e-5    # dQ's delta vs _row_delta, over max(1, max |delta|)
LRN = dict(k=2.0, n=5, alpha=1e-4, beta=0.75)     # AlexNet's LRN layers
LRN_CASES = [  # name, NHWC shape, dtype, n, the route it takes
    ("lrn1_bf16", (128, 54, 54, 96), torch.bfloat16, 5, "vector"),
    ("lrn2_bf16", (128, 26, 26, 256), torch.bfloat16, 5, "vector"),
    ("lrn1_f32", (128, 54, 54, 96), torch.float32, 5, "vector"),
    ("lrn2_f16", (128, 26, 26, 256), torch.float16, 5, "vector"),
    ("ragged130_bf16", (13, 77, 101, 130), torch.bfloat16, 5, "staged"),
    ("c3_bf16", (64, 55, 55, 3), torch.bfloat16, 5, "staged"),
    ("n7_bf16", (128, 26, 26, 256), torch.bfloat16, 7, "vector"),
]
# the LRN kernels of AlexNet's step (the vector route's), by name
LRN_STEP_KERNEL_RE = r"\blrn_(fwd|bwd)_vec\b"
ALEXNET = dict(compute_dtype="bfloat16", seed=12345)  # 224x224x3, 1000
ALEXNET_BATCH, ALEXNET_LRN_LAYERS = 128, 2
# logits, kernels vs built-in path: bf16 error over max |logit|, and
# images whose argmax may differ (bf16 near-ties counted apart)
ALEXNET_LOGITS_TOL, ALEXNET_ARGMAX_MISSES = 2e-2, 2
# LeNet-MNIST (BASELINE.md:29): batch, host batches, fit_scanned's window
LENET_BATCH, LENET_BATCHES, LENET_SCAN = 128, 24, 8
# bench.py's prefix-cache arm at its TPU-tier widths (bench.py:840-911):
# context 640, buckets (16, 576), a pinned 512-token system prefix, 40
# requests of 24 new tokens (9 in 10 hits), a four-turn chat of 8 new
# tokens a turn; the spill drill's tiny model and 13-page pool
PREFIX_CONTEXT, PREFIX_LEN, PREFIX_REQUESTS, PREFIX_NEW = 640, 512, 40, 24
PREFIX_ENGINE = dict(slots=16, page_size=16, max_context=PREFIX_CONTEXT,
                     prefill_buckets=(16, 576), max_queue=4096,
                     deadline_s=600.0)
CHAT_TURNS, CHAT_NEW = 4, 8
SPILL_MODEL = dict(vocab_size=128, d_model=32, n_heads=4, layers=2,
                   max_cache=32)
SPILL_ENGINE = dict(slots=2, page_size=4, max_context=32, num_pages=13)
# hot swap: client threads keeping greedy streams in flight, their new
# tokens, and the second version's seed
SWAP_STREAMS, SWAP_NEW, SWAP_SEED = 16, 64, 777
# bench_serving's policy and traffic (bench.py:1050-1158) over ResNet-50
SERVE_MAX_BATCH, SERVE_THREADS, SERVE_PER_THREAD = 64, 8, 40
SERVE_ROW, SERVE_CLASSES = (224, 224, 3), 1000
# the GravesLSTM char-LM (BASELINE.md:31): 2x200, vocab 77, float32,
# TBPTT windows of 50; batch 128 at T 50, and one batch of T 210 (four
# windows of 50 and one of 10)
LSTM_MODEL = dict(vocab_size=77, hidden=200, tbptt=50)
LSTM_BATCH, LSTM_T, LSTM_T_LONG = 128, 50, 210
# streaming and generate: streams, prompt, steps
LSTM_STREAMS, LSTM_PROMPT, LSTM_STEPS = 16, 16, 112
# the card's first step against the CPU's on the same weights, float32
# with full float32 matmuls on both: loss and per-layer gradients
LSTM_LOSS_RTOL, LSTM_GRAD_RTOL = 1e-5, 1e-4
# chunked rnn_time_step against one output, probabilities (float32)
LSTM_STREAM_TOL = 1e-5


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ------------------------------------------------------------------ phase 1
def build_kernels():
    modules = [pa, fa, fe, bn, lrn]
    with ThreadPoolExecutor(len(modules) + 1) as ex:
        host = ex.submit(native.build)      # the C++ data path, with g++
        built = list(ex.map(lambda m: m.build(), modules))
        host = host.result()
    print(f"build {native.loader.SOURCE.name} (g++): {host.build_s:.1f} s "
          f"-> {host.path.name}")
    usage = {}      # kernel -> [registers, spill bytes], from ptxas
    for m, b in zip(modules, built):
        print(f"build {m.SOURCE.name}: {b.build_s:.1f} s -> {b.path.name}")
        entry = "?"
        for ln in b.log.splitlines():
            if "Compiling entry function" in ln:
                # the kernel's name and template arguments, from the
                # mangled symbol
                found = re.search(r"((?:flash_[a-z]+|drn|paged_decode|"
                                  r"lrn_[a-z]+)_(?:kernel|mma|wgmma|tf32|"
                                  r"vec))"
                                  r"(I\w*?E)?E"
                                  r"|(bn_[a-z_]+)(I\w*?E)?", ln)
                entry = "".join(x for x in found.groups() if x) \
                    if found else ln
            elif "Used" in ln or "spill" in ln:
                print(f"  ptxas {entry}: {ln.split(':', 1)[-1].strip()}")
                use = usage.setdefault(entry, [0, 0])
                regs = re.search(r"Used (\d+) registers", ln)
                if regs:
                    use[0] = int(regs.group(1))
                use[1] += sum(int(n) for n in
                              re.findall(r"(\d+) bytes spill", ln))
            elif "warning" in ln.lower() or "Performance Loss" in ln:
                print(f"  {ln.strip()[:200]}")
    # the float32 flash forward, paged decode, BatchNorm's two reductions
    # and LRN's vector route: registers, and no spills (a library found
    # already built has no ptxas report)
    watched = (("flash_attention.cu", "flash_fwd_tf32"),
               ("paged_attention.cu", "paged_decode_kernel"),
               ("batch_norm.cu", "bn_moments_kernel"),
               ("batch_norm.cu", "bn_grad_sums_kernel"),
               ("lrn.cu", "lrn_fwd_vec"),
               ("lrn.cu", "lrn_bwd_vec"))
    new = {k: v for k, v in usage.items()
           if k.startswith(tuple(kernel for _, kernel in watched))}
    print("build, float32 flash forward, paged decode, BatchNorm "
          "reduction and LRN vector kernels (registers, spill bytes): "
          + "; ".join(
              f"{k} {r}, {sp}" for k, (r, sp) in sorted(new.items())))
    compiled = {m.SOURCE.name for m, b in zip(modules, built) if b.log}
    for source, kernel in watched:
        check(source not in compiled
              or any(k.startswith(kernel) for k in new),
              f"ptxas reported {kernel}: {sorted(new)}")
    check(all(sp == 0 for _, sp in new.values()),
          f"those kernels spill nothing: {new}")


# ------------------------------------------------------------------ phase 2
def paged_case(seed, b, t, hq, hkv, d, dtype, start=None, ps=PS,
               maxp=MAXP, pages=PAGES):
    """Engine-shaped inputs: trash page 0; row 0 an idle slot (all-trash
    block row at position 0); the other rows at mixed positions ending in
    partly filled pages (or, with ``start``, one prompt written from
    there)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    pk = torch.randn(pages * ps, hkv, d, generator=g)
    pv = torch.randn(pages * ps, hkv, d, generator=g)
    q = torch.randn(b, t, hq, d, generator=g)
    block = rng.permutation(np.arange(1, pages))[:b * maxp].reshape(b, maxp)
    if start is None:
        last = rng.integers(t - 1, maxp * ps, size=(b,))
        last[0] = t - 1
        block[0] = 0
    else:
        last = np.full((b,), start + t - 1)
    for i in range(b):
        block[i, int(last[i]) // ps + 1:] = 0
    qpos = (last - (t - 1))[:, None] + np.arange(t)
    return ([x.to("cuda", dtype) for x in (q, pk, pv)]
            + [torch.as_tensor(block, dtype=torch.int32, device="cuda"),
               torch.as_tensor(qpos, dtype=torch.int32, device="cuda")])


def bound_ms(q, pk, block, qpos, ps=PS):
    """Least time: the live K/V the call must read (keys up to each row's
    highest position), q, positions and block table read once, the output
    written once — or the 4*D flops per (query, key) pair at the peak rate
    of the input type — whichever is larger (the wrapper's own count,
    ``pa.work``)."""
    ops, nbytes = pa.work(q, pk, block, qpos, ps)
    return _bound(nbytes, ops, q.dtype)


def time_ms(fn, flush, iters=30, warm=3):
    """Mean device ms per call from CUDA events, the L2 cache flushed
    before each call (the decode loop finds it full of other layers'
    weights).  A spin kernel queued ahead of the start event keeps the
    card busy while the host enqueues the call, so the host's launch
    cost stays outside the measured interval."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def host_ms(fn, calls=100):
    """Host ms to enqueue one call, the card kept busy by a spin kernel
    meanwhile so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40 * SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / calls


def library_call(q, pk, pv, block, qpos, ps=PS):
    """Yardstick: gather the paged view, then one SDPA with a boolean
    causal-by-position mask."""
    gk = gather_pages(pk, block, ps).transpose(1, 2)
    gv = gather_pages(pv, block, ps).transpose(1, 2)
    kpos = torch.arange(gk.shape[2], device=q.device)
    mask = (qpos[:, None, :, None] >= kpos)               # [B, 1, T, L]
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), gk, gv, attn_mask=mask,
        enable_gqa=q.shape[2] != pk.shape[1])
    return o.transpose(1, 2)


def kernel_phase(flush, name_card):
    long_table = dict(ps=LONG_PS, maxp=LONG_MAXP, pages=LONG_PAGES)
    cases = [
        ("decode", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.bfloat16, None),
        ("prefill", dict(b=1, t=16, hq=8, hkv=8, d=128), torch.bfloat16, 0),
        ("decode_f32", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.float32,
         None),
        ("decode_gqa", dict(b=16, t=1, hq=8, hkv=2, d=128), torch.bfloat16,
         None),
        ("decode_long", dict(b=16, t=1, hq=8, hkv=8, d=128, **long_table),
         torch.bfloat16, None),
        # a prefix-cache hit's suffix prefill: 16 queries at positions
        # 512..527 over 528 keys (the prefix phase's context of 640)
        ("prefix_hit", dict(b=1, t=16, hq=8, hkv=8, d=128,
                            maxp=PREFIX_CONTEXT // PS,
                            pages=PREFIX_CONTEXT + 1), torch.bfloat16,
         PREFIX_LEN),
    ]
    rows = {}
    for i, (name, shape, dtype, start) in enumerate(cases):
        args = paged_case(100 + i, dtype=dtype, start=start, **shape)
        ps = shape.get("ps", PS)
        out = pa.paged_decode_attention(*args, page_size=ps)
        again = pa.paged_decode_attention(*args, page_size=ps)
        ref = pa.paged_attention_plain(*args, ps)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.equal(out, again), f"{name}: two calls give the same "
                                       "bits")
        call = lambda: pa.paged_decode_attention(*args, page_size=ps)
        ms = time_ms(call, flush)
        enqueue_ms = host_ms(call)
        plain_ms = time_ms(lambda: pa.paged_attention_plain(*args, ps), flush)
        lib = library_call(*args, ps)
        lib_err = (lib.float() - ref.float()).abs().max().item()
        lib_ms = time_ms(lambda: library_call(*args, ps), flush)
        bms, by = bound_ms(args[0], args[1], args[3], args[4], ps)
        keys = int(args[4].max()) + 1
        rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                          bound_ms=bms, bound_by=by)
        print(f"paged_decode_attention[{name}] q{list(args[0].shape)} "
              f"{str(dtype)[6:]}, longest context {keys} keys: max_abs_err "
              f"{err:.3e} (tol {TOL[dtype]:g}), repeat bitwise equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (err {lib_err:.2e}), bound {bms:.5f} ms "
              f"({by}); host enqueue {enqueue_ms:.4f} ms [{name_card}]")
        check(err <= TOL[dtype], f"{name}: kernel vs plain {err} > "
                                 f"{TOL[dtype]}")
        del args, out, again, ref, lib
    return rows


# ------------------------------------------------------------------ phase 3
def serve(eng, prompts, sampled=False):
    """The requests from ``CLIENTS`` threads, ``PER_CLIENT`` each (greedy,
    or ``SAMPLED`` with a fixed seed a request); (token lists, handles,
    wall seconds from the first submit to the last result)."""
    results = [None] * len(prompts)
    handles = [None] * len(prompts)
    errors = []
    kw = SAMPLED if sampled else {}

    def client(c):
        try:
            mine = range(c * PER_CLIENT, (c + 1) * PER_CLIENT)
            for i in mine:
                handles[i] = eng.submit(prompts[i], NEW_TOKENS,
                                        seed=100 + i, **kw)
            for i in mine:
                results[i] = handles[i].result(timeout=300)
        except Exception as e:          # reported below, fails the run
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads),
          f"client errors {errors!r}")
    check(all(r is not None and len(r) == NEW_TOKENS for r in results),
          "every request returns 64 tokens")
    return results, handles, wall


def profiled_launches(fn, pattern=r"paged_decode_kernel", also=None):
    """``fn()`` under ``torch.profiler``; (its result, the launches on the
    device of the kernels whose names match ``pattern``: by default the
    paged kernel).  With ``also`` (a pattern), a third item: its
    launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()

    def count(pat):
        return sum(e.count for e in ev if re.search(pat, e.key))

    return (out, count(pattern)) if also is None else (
        out, count(pattern), count(also))


def engine_mode(net, capture, prompts, name_card):
    """Serve the requests greedy (timed), then sampled, through captured
    programs (the engine's default) or ``capture=False``; with capture
    also once more greedy, the counts at 0, under the profiler, whose
    paged-kernel launches must be layers x calls.  The mode's launches
    are that profiled count (captured) or the wrapper's over warm-up and
    the timed serve (eager).  Returns the mode's tokens and numbers."""
    label = "captured" if capture else "eager"
    layers = MODEL["layers"]
    pa.counts.reset()
    eng = GenerationEngine(net, **ENGINE)
    eng._capture = None if capture else False   # internal: eager programs
    t_build = time.perf_counter()
    eng.start()
    progs = eng.programs
    print(f"engine [{label}] start (warm-up and captures included): "
          f"{time.perf_counter() - t_build:.2f} s; captures "
          f"{progs.captures}, paged launches a graph "
          f"{progs.graph_launches()}")
    programs = len(progs.prefill_buckets) + 1
    check(progs.captures == (programs if capture else 0),
          f"{label}: captures after warm-up {progs.captures}")
    check(all(n == layers for n in progs.graph_launches().values()),
          f"every graph holds {layers} paged launches")
    calls0 = progs.prefill_calls + progs.decode_calls
    greedy, handles, wall = serve(eng, prompts)
    calls = progs.prefill_calls + progs.decode_calls - calls0
    plain = pa.counts.plain_calls
    steps = sorted(eng.decode_step_s)
    ttft = np.asarray([h.ttft_s for h in handles]) * 1e3
    row = dict(tokens=greedy, tok_s=sum(len(r) for r in greedy) / wall,
               step_ms=float(np.median(steps)) * 1e3,
               ttft50=float(np.percentile(ttft, 50)),
               ttft99=float(np.percentile(ttft, 99)))
    check(plain == 0, f"plain-version calls {plain} == 0")
    print(f"engine [{label}]: {len(greedy)} requests x {NEW_TOKENS} tokens "
          f"in {wall:.3f} s; {calls} calls ({progs.decode_calls} decode "
          f"steps in all); plain calls {plain}; {row['tok_s']:.1f} "
          f"tokens/s; TTFT p50 {row['ttft50']:.2f} ms, p99 "
          f"{row['ttft99']:.2f} ms; decode step median {row['step_ms']:.3f} "
          f"ms over {len(steps)} steps [{name_card}]")
    if capture:
        # the wrapper counts a launch where it is recorded into a graph,
        # not where a replay runs it: the served requests once more, with
        # the counts at 0, and the launches counted by the profiler
        pa.counts.reset()
        calls0 = progs.prefill_calls + progs.decode_calls
        (again, _, _), launches = profiled_launches(
            lambda: serve(eng, prompts))
        calls = progs.prefill_calls + progs.decode_calls - calls0
        print(f"engine [{label}], profiled serve: {calls} replays, "
              f"paged_decode_kernel launches {launches} (layers x calls "
              f"{layers * calls}), wrapper launches {pa.counts.launches}")
        check(pa.counts.launches == 0 and pa.counts.plain_calls == 0,
              "the profiled serve runs replays only")
        check(launches == layers * calls, f"profiled launches {launches} "
                                          f"== {layers} x {calls}")
        check(again == greedy, "the profiled serve's tokens")
    else:
        # warm-up and the timed serve, by the wrapper's count
        launches = pa.counts.launches
        print(f"engine [{label}]: paged launches {launches} (layers x "
              f"calls {layers * (calls0 + calls)})")
        check(launches == layers * (calls0 + calls),
              f"eager launches {launches} == layers x calls")
    check(launches > 0, f"{label}: the paged kernel ran")
    row["launches"] = launches
    row["sampled"], _, _ = serve(eng, prompts, sampled=True)
    eng.stop()
    check(progs.captures == (programs if capture else 0),
          f"{label}: no capture while serving ({progs.captures})")
    print(f"engine [{label}]: captures {progs.captures}, replays "
          f"{progs.replays}, stats {eng.stats()['captures']}/"
          f"{eng.stats()['replays']}")
    row.update(decode_profile(progs, label, name_card))
    return row, progs


def engine_phase(name_card):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"],
                            int(rng.integers(4, 13))).tolist()
               for _ in range(CLIENTS * PER_CLIENT)]
    net = transformer_char_lm(device="cuda", **MODEL)
    captured, progs = engine_mode(net, True, prompts, name_card)
    eager, _ = engine_mode(net, False, prompts, name_card)
    check(captured["tokens"] == eager["tokens"],
          "greedy tokens, captured == eager programs")
    check(captured["sampled"] == eager["sampled"],
          "sampled tokens (temperature 0.8, top_k 20), captured == eager")
    differ = sum(a != b for a, b in zip(captured["sampled"],
                                        captured["tokens"]))
    print(f"engine: greedy and sampled tokens identical between captured "
          f"and eager programs ({differ} of {len(prompts)} sampled "
          f"requests differ from greedy)")
    for what, key in (("decode step median ms", "step_ms"),
                      ("tokens/s", "tok_s"), ("TTFT p50 ms", "ttft50"),
                      ("TTFT p99 ms", "ttft99"),
                      ("profiled step wall ms", "wall_ms"),
                      ("profiled step busy ms", "busy_ms"),
                      ("profiled idle share", "idle"),
                      ("device operations a step", "ops"),
                      ("unprofiled step wall ms", "plain_wall"),
                      ("unprofiled step device span ms", "span_ms")):
        print(f"engine {what}: captured {captured[key]:.4f}, eager "
              f"{eager[key]:.4f} [{name_card}]")

    # the first prefill through the kernel vs the gather oracle
    p0 = prompts[0]
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :len(p0)] = p0
    block = np.zeros((1, progs.pages_per_slot), np.int32)
    block[0, 0] = 1
    start = np.zeros((1,), np.int32)
    fused = progs.forward(progs.fresh_pools(), block, start, tokens)
    pa.set_paged_attention_mode("gather")
    try:
        gathered = progs.forward(progs.fresh_pools(), block, start, tokens)
    finally:
        pa.set_paged_attention_mode("fused")
    a = fused[0, len(p0) - 1].float()
    b = gathered[0, len(p0) - 1].float()
    d = (a - b).abs().max().item()
    print(f"first prefill logits, kernel vs gather oracle: max_abs_err "
          f"{d:.3e} (tol {LOGITS_TOL}; max |logit| {b.abs().max().item():.3f};"
          f" argmax {int(a.argmax())} vs {int(b.argmax())})")
    check(bool(torch.isfinite(a).all()) and d <= LOGITS_TOL,
          f"prefill logits kernel vs gather {d} > {LOGITS_TOL}")
    return captured["launches"]


def decode_profile(progs, label, name_card):
    """Where a decode step's time goes: ``PROFILED_STEPS`` full-batch
    calls (every slot live, at the positions the served requests reach)
    under ``torch.profiler``, the device's busy time per step against
    the host wall per step.  A captured step must launch the paged
    kernel once per layer."""
    from torch.profiler import ProfilerActivity, profile

    s, maxp = progs.slots, progs.pages_per_slot
    block = (1 + np.arange(s * maxp, dtype=np.int32)).reshape(s, maxp)
    pos = np.random.default_rng(1).integers(8, 72, s).astype(np.int32)
    zi, zf = np.zeros(s, np.int32), np.zeros(s, np.float32)
    keys = np.zeros((s, 2), np.uint32)

    def step():
        progs.decode(block, pos, zi, keys, zi, zf, zi,
                     np.ones(s, np.float32))

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    ev = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / PROFILED_STEPS
    attn = [e for e in ev if "paged_decode_kernel" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 \
        / PROFILED_STEPS
    attn_n = sum(e.count for e in attn)
    # the feed-forward blocks' LayerNorm opens with the fused prologue
    drn_n = sum(e.count for e in ev if "drn_kernel" in e.key)
    ops = sum(e.count for e in ev
              if e.self_device_time_total > 0) / PROFILED_STEPS
    check(attn_ms > 0, "the profiled decode steps ran the kernel")
    check(attn_n == MODEL["layers"] * PROFILED_STEPS,
          f"{label}: paged launches {attn_n} over {PROFILED_STEPS} steps")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"decode step [{label}] top device time a step: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3 / PROFILED_STEPS:.4f}"
        f" ms x{e.count // PROFILED_STEPS}" for e in top))
    # unprofiled: the host wall of a call, and its device span (CUDA
    # events around the staging copies, the program and the read-back)
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS):
        step()
    plain_wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    spans = []
    for _ in range(PROFILED_STEPS):
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        step()
        e_ev.record()
        e_ev.synchronize()
        spans.append(s_ev.elapsed_time(e_ev))
    span_ms = float(np.median(spans))
    print(f"decode step [{label}] unprofiled: host wall {plain_wall:.3f} ms "
          f"a call, device span {span_ms:.3f} ms (events; busy "
          f"{busy_ms:.3f} of it in kernels) [{name_card}]")
    idle = 1 - busy_ms / wall_ms
    print(f"decode step [{label}] (profiled, {PROFILED_STEPS} steps, {s} "
          f"live slots): host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (idle share {idle:.3f}) in {ops:.0f} device "
          f"operations, paged attention kernel {attn_ms:.4f} ms in "
          f"{attn_n / PROFILED_STEPS:.0f} launches, fused prologue "
          f"{drn_n / PROFILED_STEPS:.0f} launches [{name_card}]")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=idle, ops=ops,
                plain_wall=plain_wall, span_ms=span_ms)


# ---------------------------------------------------------------- phase 3b
def generate_phase(name_card, what, **model_kw):
    """``generate`` (the captured loop) against ``sample_sequence`` (the
    host loop over ``rnn_time_step``) at full width: greedy ids equal,
    ms a generated token, the first replayed step's log-probabilities
    against the loop's; a second call captures nothing."""
    b, t, steps = GEN_BATCH, GEN_PROMPT, GEN_STEPS
    net = transformer_char_lm(device="cuda", **{**MODEL, **model_kw})
    prompt = np.random.default_rng(5).integers(0, MODEL["vocab_size"],
                                                (b, t))
    t0 = time.perf_counter()
    got = generate(net, prompt, steps, temperature=0.0)
    first_s = time.perf_counter() - t0
    (gen,) = net._graph_cache.values()
    t0 = time.perf_counter()
    again = generate(net, prompt, steps, temperature=0.0)
    gen_s = time.perf_counter() - t0
    check(gen.captures == 1 and np.array_equal(again, got),
          f"{what}: a second call replays the same graph "
          f"(captures {gen.captures})")
    t0 = time.perf_counter()
    ref = sample_sequence(net, prompt, steps, temperature=0.0)
    loop_s = time.perf_counter() - t0
    same = int((got == ref).all(axis=1).sum())
    print(f"generate [{what}] batch {b}, prompt {t}, {steps} steps: "
          f"captured {gen_s * 1e3 / steps:.4f} ms a token (first call, "
          f"capture included, {first_s:.2f} s), eager loop "
          f"{loop_s * 1e3 / steps:.4f} ms a token; {same} of {b} rows "
          f"identical; replays {gen.replays} [{name_card}]")
    check(np.array_equal(got, ref), f"{what}: greedy generate == "
                                    "sample_sequence")
    # the first replayed step's log-probabilities against the loop's
    generate(net, prompt, 2, temperature=0.0)
    two = [g for k, g in net._graph_cache.items() if k[1] == 2][0]
    lp = torch.log_softmax(two.step_logits, dim=-1)
    net.rnn_clear_previous_state()
    net.rnn_time_step(prompt)
    probs = net.rnn_time_step(got[:, 0])
    diff = (lp - torch.log(probs.clamp_min(1e-30))).abs().max().item()
    print(f"generate [{what}]: first replayed step, log-probabilities vs "
          f"the loop's: max_abs_diff {diff:.3e}")
    check(np.isfinite(diff) and diff <= LOGITS_TOL,
          f"{what}: first-step log-probabilities {diff}")


def generate_phases(name_card):
    generate_phase(name_card, "linear")
    torch.cuda.empty_cache()
    generate_phase(name_card, "rolling", **GEN_ROLLING)
    torch.cuda.empty_cache()
    # sampled: in float32 (the zoo default), where the top two logits of
    # a step do not tie; in bfloat16 they do, and top_k=1 then keeps both
    # (the reference's kept set), so it need not be the argmax
    f32 = {k: v for k, v in MODEL.items() if k != "compute_dtype"}
    net = transformer_char_lm(device="cuda", **f32)
    prompt = np.random.default_rng(5).integers(
        0, MODEL["vocab_size"], (GEN_BATCH, GEN_PROMPT))
    greedy = generate(net, prompt, GEN_STEPS, temperature=0.0)
    kw = dict(temperature=0.8, top_k=20, rng=11)
    t0 = time.perf_counter()
    a = generate(net, prompt, GEN_STEPS, **kw)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = generate(net, prompt, GEN_STEPS, **kw)
    ms = (time.perf_counter() - t0) * 1e3 / GEN_STEPS
    c = generate(net, prompt, GEN_STEPS, **{**kw, "rng": 12})
    top1 = generate(net, prompt, GEN_STEPS, **{**kw, "top_k": 1})
    loop = sample_sequence(net, prompt, GEN_STEPS, **kw)
    rows = int((loop == a).all(axis=1).sum())
    parted = [int(np.argmax(r)) for r in (loop != a) if r.any()]
    print(f"generate [sampled, float32] vs sample_sequence, same seed: "
          f"{rows} of {GEN_BATCH} rows identical, rows parting at steps "
          f"{parted}, {int((loop == a).sum())} of {a.size} ids equal")
    check(rows >= GEN_BATCH - 1, f"sampled generate == sample_sequence in "
                                 f"{rows} of {GEN_BATCH} rows")
    print(f"generate [sampled, float32] temperature 0.8, top_k 20: "
          f"{ms:.4f} ms a token (first call {first_s:.2f} s); same seed "
          f"same ids {np.array_equal(a, b)}, another seed differs in "
          f"{int((a != c).sum())} of {a.size} ids, top_k=1 == greedy "
          f"{np.array_equal(top1, greedy)}; {len(net._graph_cache)} "
          f"captured loops [{name_card}]")
    check(a.shape == greedy.shape and np.array_equal(a, b),
          "sampled generate: the same seed gives the same ids")
    check(not np.array_equal(a, c), "another seed gives other ids")
    check(np.array_equal(top1, greedy), "top_k=1 == greedy")


# ------------------------------------------------------- phase 3c, prefix
def _last_logits(progs, seq):
    """The net's float32 logits after ``seq``, by one eager forward over
    fresh pools (the near-tie check of a hit against a cold prefill)."""
    maxp = progs.pages_per_slot
    block = np.zeros((1, maxp), np.int32)
    block[0, :-(-len(seq) // progs.page_size)] = 1 + np.arange(
        -(-len(seq) // progs.page_size))
    with torch.no_grad():
        pre = progs.forward(progs.fresh_pools(), block,
                            np.zeros((1,), np.int32),
                            np.asarray([seq], np.int32))
    return pre[0, -1].float()


def _hit_parity(progs, prompts, hits, cold):
    """Each hit's greedy ids against the cold engine's for the same
    prompt: equal, or parting first where the cold path's top two
    logits lie within ``LOGITS_TOL`` (the suffix prefill's matmuls are
    [16, d] where the cold prefill's are [576, d]).  Returns (equal,
    near-tie partings)."""
    equal, ties = 0, []
    for prompt, a, b in zip(prompts, hits, cold):
        if a == b:
            equal += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        top = torch.topk(_last_logits(progs, prompt + b[:j]), 2).values
        gap = float(top[0] - top[1])
        check(gap <= LOGITS_TOL, f"a hit parts from the cold ids at step "
                                 f"{j} where the top two logits lie "
                                 f"{gap:.4f} apart (> {LOGITS_TOL})")
        ties.append((j, round(gap, 5)))
    return equal, ties


def prefix_phase(name_card):
    """bench.py's prefix-cache arm at its TPU-tier widths
    (``bench.py:840-911``), then the tight-pool spill drill.  Returns the
    paged kernel's profiled launches."""
    net = transformer_char_lm(device="cuda",
                              **{**MODEL, "max_cache": PREFIX_CONTEXT})
    layers = MODEL["layers"]
    eng = GenerationEngine(net, prefix_cache=True, **PREFIX_ENGINE)
    t0 = time.perf_counter()
    eng.start()
    progs = eng.programs
    mv = eng.models.active("default")
    captures = progs.captures
    programs = len(PREFIX_ENGINE["prefill_buckets"]) + 1
    print(f"prefix: engine start {time.perf_counter() - t0:.2f} s, "
          f"captures {captures}, detector {mv.detector.compile_count}; "
          f"one page's host bytes {progs.page_nbytes()}")
    check(captures == programs and mv.detector.compile_count == programs,
          f"prefix: one capture a program at start ({captures})")
    vocab = MODEL["vocab_size"]
    rs = np.random.RandomState(4242)
    sys_prefix = rs.randint(0, vocab, PREFIX_LEN).tolist()

    def prefix_prompt(hit):
        tail = rs.randint(0, vocab, 4 + rs.randint(9)).tolist()
        return (sys_prefix + tail if hit
                else rs.randint(0, vocab, PREFIX_LEN).tolist() + tail)

    eng.submit(prefix_prompt(True), PREFIX_NEW).result(timeout=600)
    pin_id = eng.pin_prefix(sys_prefix)
    prompts, ids, hit_t, miss_t, hit_of = [], [], [], [], []
    t0 = time.perf_counter()
    for i in range(PREFIX_REQUESTS):
        prompts.append(prefix_prompt(i % 10 != 9))
        h = eng.submit(prompts[-1], PREFIX_NEW)
        ids.append(list(map(int, h.result(timeout=600))))
        hit_of.append(h.shared_len > 0)
        (hit_t if h.shared_len > 0 else miss_t).append(h.ttft_s * 1e3)
    wall = time.perf_counter() - t0
    check(sum(hit_of) == PREFIX_REQUESTS - PREFIX_REQUESTS // 10,
          f"prefix: 9 in 10 requests hit ({sum(hit_of)})")
    check(all(len(r) == PREFIX_NEW for r in ids), "prefix: every request "
                                                  "returns its tokens")
    print(f"prefix: {PREFIX_REQUESTS} requests of {PREFIX_NEW} tokens in "
          f"{wall:.3f} s; TTFT hit p50 {np.percentile(hit_t, 50):.3f} ms "
          f"p99 {np.percentile(hit_t, 99):.3f} ms ({len(hit_t)}), miss p50 "
          f"{np.percentile(miss_t, 50):.3f} ms p99 "
          f"{np.percentile(miss_t, 99):.3f} ms ({len(miss_t)}) [{name_card}]")

    # the four-turn pinned chat, under the profiler: each turn's prefill
    # covers only the new tokens over the pinned history
    def chat():
        turns, history = [], list(sys_prefix)
        pin = eng.pin_prefix(history)
        for turn in range(CHAT_TURNS):
            h = eng.submit(history, CHAT_NEW)
            toks = list(map(int, h.result(timeout=600)))
            turns.append((len(history), h.shared_len,
                          round(h.ttft_s * 1e3, 3)))
            history = history + toks + rs.randint(0, vocab, 2).tolist()
            fresh = eng.pin_prefix(history)
            eng.unpin_prefix(pin)
            pin = fresh
        eng.unpin_prefix(pin)
        return turns

    calls0 = progs.prefill_calls + progs.decode_calls
    turns, launches, drn = profiled_launches(chat, also=r"\bdrn_kernel")
    calls = progs.prefill_calls + progs.decode_calls - calls0
    print(f"prefix: chat turns (prompt tokens, shared tokens, TTFT ms) "
          f"{turns}; {calls} replays, paged_decode_kernel launches "
          f"{launches} (layers x calls {layers * calls}), fused prologue "
          f"launches {drn}")
    # a turn's history is cached up to the last full page of the turn
    # before's prompt (decode pages are never cached), so the shared
    # prefix grows every turn or two
    check(all(b[1] >= a[1] for a, b in zip(turns, turns[1:]))
          and 0 < turns[0][1] < turns[-1][1],
          "prefix: the chat turns share the pinned history")
    check(launches == layers * calls and drn == layers * calls,
          f"prefix: profiled launches {launches} (paged), {drn} "
          f"(prologue) == {layers} x {calls}")
    eng.unpin_prefix(pin_id)
    stats = eng.prefix_cache.stats()
    print(f"prefix: tree stats hits {stats['hits']}, misses "
          f"{stats['misses']}, resident pages {stats['resident_pages']}, "
          f"host pages {stats['host_pages']}, spills "
          f"{stats['offload_total']}, restores {stats['restore_total']}, "
          f"evictions {stats['evictions_total']}")
    eng.stop()
    check(progs.captures == captures
          and mv.detector.compile_count == programs,
          f"prefix: nothing captured after start ({progs.captures})")

    # a cached page through the host tier and back, bit for bit, into
    # the live pools (the decode thread has stopped)
    node = next(n for n in eng.prefix_cache._all if n.page is not None)
    spare = eng.cache.alloc(1)[0]
    payload = progs.read_page(node.page)
    progs.write_page(spare, payload)
    check(all(torch.equal(a[node.page], a[spare])
              for a in tree_leaves(progs.pools))
          and all(torch.equal(a, b) for a, b in
                  zip(tree_leaves(payload),
                      tree_leaves(progs.read_page(spare)))),
          "prefix: a page round-trips the host tier bit for bit")
    eng.cache.free([spare])

    # each hit's greedy ids against an engine without the cache
    hits = [(p, r) for p, r, h in zip(prompts, ids, hit_of) if h]
    cold = GenerationEngine(net, **PREFIX_ENGINE).start()
    try:
        handles = [cold.submit(p, PREFIX_NEW) for p, _ in hits]
        cold_ids = [list(map(int, h.result(timeout=600))) for h in handles]
    finally:
        cold.stop()
    equal, ties = _hit_parity(cold.programs, [p for p, _ in hits],
                              [r for _, r in hits], cold_ids)
    print(f"prefix: hit ids equal a cold engine's in {equal} of "
          f"{len(hits)} requests; near-tie partings (step, top-2 gap) "
          f"{ties}")
    del eng, cold, progs
    torch.cuda.empty_cache()

    # the spill drill: a 2-slot engine whose tree cannot stay resident
    tiny = transformer_char_lm(device="cuda", seed=12345, **SPILL_MODEL)
    teng = GenerationEngine(tiny, prefix_cache=True, **SPILL_ENGINE).start()
    try:
        rs2 = np.random.RandomState(77)
        spill = [rs2.randint(0, vocab, 9).tolist() for _ in range(6)]
        first = [teng.generate(p, 8).tolist() for p in spill]
        again = [teng.generate(p, 8).tolist() for p in spill]
        st = teng.prefix_cache.stats()
    finally:
        teng.stop()
    print(f"prefix spill drill (d32, 2 layers, 13 pages): spills "
          f"{st['offload_total']}, restores {st['restore_total']}, hits "
          f"{st['hits']}, host pages {st['host_pages']}; revisits equal "
          f"{again == first}")
    check(st["offload_total"] > 0 and st["restore_total"] > 0,
          "spill drill: pages went to the host tier and came back")
    check(again == first, "spill drill: restored pages give the same ids")
    return launches


# --------------------------------------------------------- phase 3d, swap
def _gaps_in(handles, t0, t1):
    """The longest gap between two delivered tokens of any request
    whose gap overlaps [t0, t1], from its submit time, TTFT and
    inter-token latencies (one clock, ``perf_counter``)."""
    worst = 0.0
    for h in handles:
        if h.ttft_s is None:
            continue
        t = h.submitted + h.ttft_s
        for gap in h.itl_s:
            if t < t1 and t + gap > t0:
                worst = max(worst, gap)
            t += gap
    return worst


def swap_phase(name_card):
    """Hot-swap under load: ``SWAP_STREAMS`` client threads keep greedy
    streams in flight while a second seed is deployed (retained),
    rolled back, deployed again and committed."""
    net1 = transformer_char_lm(device="cuda", **MODEL)
    net2 = transformer_char_lm(device="cuda",
                               **{**MODEL, "seed": SWAP_SEED})
    eng = GenerationEngine(net1, **ENGINE, max_queue=256).start()
    mv1, progs1 = eng.models.active("default"), eng.programs
    want = len(ENGINE["prefill_buckets"]) + 1
    vocab = MODEL["vocab_size"]
    stop = threading.Event()
    handles, errors = [], []
    lock = threading.Lock()

    def client(c):
        r = np.random.RandomState(c)
        while not stop.is_set():
            try:
                h = eng.submit(r.randint(0, vocab, int(r.randint(4, 13)))
                               .tolist(), SWAP_NEW)
                with lock:
                    handles.append(h)
                check(len(h.result(timeout=600)) == SWAP_NEW,
                      "a stream got all its tokens")
            except Exception as e:          # reported below
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(SWAP_STREAMS)]
    for th in threads:
        th.start()
    time.sleep(0.5)
    t_dep = time.perf_counter()
    mv2 = eng.deploy("default", net2, retain_old=True)
    t_dep1 = time.perf_counter()
    progs2 = eng.programs
    time.sleep(0.3)
    calls1 = progs1.decode_calls
    eng.rollback()
    time.sleep(0.3)
    check(eng.programs is progs1 and progs1.decode_calls > calls1,
          "rollback serves the retained version's programs")
    check(progs1.captures == want, f"rollback captures nothing "
                                   f"({progs1.captures})")
    t_dep2 = time.perf_counter()
    mv3 = eng.deploy("default", net2, retain_old=True)
    t_dep3 = time.perf_counter()
    progs3 = eng.programs
    time.sleep(0.3)
    eng.commit_swap()
    time.sleep(0.3)
    stop.set()
    for th in threads:
        th.join(600)
    check(not errors and not any(th.is_alive() for th in threads),
          f"swap: client errors {errors!r}")
    done = [h for h in handles if h.done.is_set()]
    check(len(done) == len(handles)
          and all(h.finish_reason == "length" for h in handles),
          "swap: no stream dropped")
    for name, mv, progs in (("v2", mv2, progs2), ("v3", mv3, progs3)):
        check(progs.captures == want and mv.detector.compile_count == want,
              f"swap: {name} captured one graph a program at deploy and "
              f"nothing after ({progs.captures}, detector "
              f"{mv.detector.compile_count})")
    check(mv1.state == "retired" and mv2.state == "retired"
          and eng.models.active("default") is mv3, "swap: v3 serves")
    gap = _gaps_in(handles, t_dep, t_dep1)
    gap2 = _gaps_in(handles, t_dep2, t_dep3)
    itl = [g for h in handles for g in h.itl_s]
    print(f"swap: {len(handles)} streams of {SWAP_NEW} tokens from "
          f"{SWAP_STREAMS} clients, none dropped; deploys "
          f"{(t_dep1 - t_dep) * 1e3:.1f} and {(t_dep3 - t_dep2) * 1e3:.1f} "
          f"ms (captures {progs2.captures}, {progs3.captures}); longest "
          f"decode-step gap during them {gap * 1e3:.3f} and "
          f"{gap2 * 1e3:.3f} ms (inter-token p50 "
          f"{np.median(itl) * 1e3:.3f} ms, p99 "
          f"{np.percentile(itl, 99) * 1e3:.3f} ms) [{name_card}]")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, vocab, int(rng.integers(4, 13))).tolist()
               for _ in range(ENGINE["slots"])]
    got = [h.result(timeout=600) for h in
           [eng.submit(p, SWAP_NEW) for p in prompts]]
    eng.stop()
    fresh = GenerationEngine(net2, **ENGINE).start()
    try:
        ref = [h.result(timeout=600) for h in
               [fresh.submit(p, SWAP_NEW) for p in prompts]]
    finally:
        fresh.stop()
    same = sum(a == b for a, b in zip(got, ref))
    print(f"swap: after the commit {same} of {len(prompts)} requests give "
          f"a fresh engine's ids on the new weights")
    check(same == len(prompts), "swap: committed version == fresh engine")


# ------------------------------------------------- phase 2, training kernels
def _randn(seed, shape, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _scaled_err(a, ref):
    """Largest difference over the reference's largest magnitude."""
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _abs_err(a, ref):
    return (a.float() - ref.float()).abs().max().item()


def _bound(nbytes, ops, dtype, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (peak or PEAK_OPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sdpa_mask(t, causal, window):
    if not causal or window is None:
        return None
    pos = torch.arange(t, device="cuda")
    return ((pos[:, None] >= pos[None, :])
            & (pos[None, :] > pos[:, None] - window))


def flash_case(name, seed, shape, dtype, causal, window, flush, name_card):
    b, t, h, d = shape
    paths = {k: fa.kernel_path(k, dtype, d) for k in ("fwd", "dq", "dkv")}
    print(f"flash[{name}] paths: forward {paths['fwd']}, dQ {paths['dq']}, "
          f"dK/dV {paths['dkv']}")
    if dtype != torch.float32 and d in (64, 128):
        check(paths == {"fwd": "wgmma", "dq": "wgmma", "dkv": "wgmma"},
              f"flash[{name}] takes wgmma for the forward, dQ and dK/dV: "
              f"{paths}")
    if dtype == torch.float32 and d in (64, 128):
        check(paths == {"fwd": "tf32x3", "dq": "tf32x3", "dkv": "tf32x3"},
              f"flash[{name}] takes tf32x3 for the forward, dQ and dK/dV: "
              f"{paths}")
    q, k, v, do = (_randn(seed + i, shape, dtype) for i in range(4))
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    ro, rlse = fa.flash_attention_plain_fwd(q, k, v, causal, window)
    rdq, rdk, rdv = fa.flash_attention_plain_bwd(q, k, v, ro, rlse, do,
                                                 causal, window)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    errs = {"o": _abs_err(o, ro), "lse": _abs_err(lse, rlse),
            "dq": _scaled_err(dq, rdq), "dk": _scaled_err(dk, rdk),
            "dv": _scaled_err(dv, rdv)}
    abs_errs = {"dq": _abs_err(dq, rdq), "dk": _abs_err(dk, rdk),
                "dv": _abs_err(dv, rdv)}
    for what, err in errs.items():
        check(err <= tol, f"flash[{name}] {what}: kernel vs plain {err} > "
                          f"{tol}")
    del ro, rlse, rdq, rdk, rdv

    # the delta dQ hands to dK/dV (the kernel's own on the wgmma and
    # tf32x3 routes)
    _, delta = fa._launch_dq(q, k, v, do, o, lse, causal, window)
    rdelta = fa._row_delta(o, do)
    torch.cuda.synchronize()
    delta_err = _abs_err(delta, rdelta) / max(
        1.0, rdelta.abs().max().item())
    check(delta_err <= DELTA_TOL, f"flash[{name}] delta: dQ's vs "
                                  f"_row_delta {delta_err} > {DELTA_TOL}")
    del rdelta
    fwd_ms = time_ms(lambda: fa.flash_fwd(q, k, v, causal=causal,
                                          window=window), flush,
                     iters=KERNEL_ITERS)
    # dQ with its delta: the kernel's own, or _row_delta on other routes
    dq_ms = time_ms(lambda: fa._launch_dq(q, k, v, do, o, lse, causal,
                                          window), flush, iters=KERNEL_ITERS)
    dkv_ms = time_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta, causal,
                                            window), flush,
                     iters=KERNEL_ITERS)
    pfwd_ms = time_ms(lambda: fa.flash_attention_plain_fwd(q, k, v, causal,
                                                           window), flush,
                      iters=3, warm=1)
    pbwd_ms = time_ms(lambda: fa.flash_attention_plain_bwd(
        q, k, v, o, lse, do, causal, window), flush, iters=3, warm=1)

    # yardstick: one SDPA call forward, its autograd backward
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = _sdpa_mask(t, causal, window)
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None)
    lib_fwd_ms = time_ms(sdpa, flush, iters=KERNEL_ITERS)
    out = sdpa()
    gdo = do.transpose(1, 2)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), gdo, retain_graph=True), flush,
        iters=KERNEL_ITERS)
    lib_err = _abs_err(out.transpose(1, 2), o)
    if dtype == torch.float32:
        # which kernels SDPA's float32 backward runs (the yardstick's
        # route, read off the profiler)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, (qs, ks, vs), gdo, retain_graph=True)
            torch.cuda.synchronize()
        names = sorted({e.key[:120] for e in prof.key_averages()
                        if e.self_device_time_total > 0})
        print(f"flash[{name}] SDPA bwd kernels: {names}")
    del out, qs, ks, vs

    # (bytes, operations) of each kernel: the wrapper's own count (q, k,
    # v, dO and O read, dq written; lse read, delta written)
    work = {kn: (nbytes, ops)
            for kn, (ops, nbytes) in fa.work(q, causal, window).items()}
    # at the rate of the route's products: 3xTF32 on tf32x3
    bounds = {kn: _bound(*work[kn], dtype,
                         TF32X3_OPS if paths[kn] == "tf32x3" else None)
              for kn in work}
    print(f"flash[{name}] q{list(shape)} {str(dtype)[6:]} causal={causal} "
          f"window={window}: err o {errs['o']:.3e}, lse {errs['lse']:.3e}, "
          f"dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} "
          f"(grads scaled by max abs; tol {tol:g}); delta vs _row_delta "
          f"{delta_err:.3e} (tol {DELTA_TOL:g}); library o err "
          f"{lib_err:.3e} [{name_card}]")
    print(f"flash[{name}] fwd {fwd_ms:.4f} ms (bound {bounds['fwd'][0]:.5f}"
          f" ms, {bounds['fwd'][1]}), dQ with delta {dq_ms:.4f} ms (bound "
          f"{bounds['dq'][0]:.5f}), dK/dV {dkv_ms:.4f} ms (bound "
          f"{bounds['dkv'][0]:.5f}); plain fwd {pfwd_ms:.4f} ms, plain bwd "
          f"{pbwd_ms:.4f} ms; SDPA fwd {lib_fwd_ms:.4f} ms, SDPA bwd "
          f"{lib_bwd_ms:.4f} ms [{name_card}]")
    if "tf32x3" in paths.values():
        cores = {kn: _bound(*work[kn], dtype)[0] for kn in work}
        print(f"flash[{name}] tf32x3 bounds at {TF32X3_OPS / 1e12:.0f} "
              f"TFLOP/s: fwd {bounds['fwd'][0]:.5f} ms, dQ "
              f"{bounds['dq'][0]:.5f} ms, dK/dV {bounds['dkv'][0]:.5f} ms; "
              f"at the CUDA cores' {PEAK_OPS[torch.float32] / 1e12:.0f} "
              f"TFLOP/s: fwd {cores['fwd']:.5f} ms, dQ {cores['dq']:.5f} "
              f"ms, dK/dV {cores['dkv']:.5f} ms; fwd {fwd_ms:.4f} ms, "
              f"{fwd_ms / lib_fwd_ms:.3f} x SDPA fwd; dQ + dK/dV "
              f"{dq_ms + dkv_ms:.4f} ms, "
              f"{(dq_ms + dkv_ms) / lib_bwd_ms:.3f} x SDPA bwd [{name_card}]")
    return {
        "fwd": dict(err=errs["o"], ms=fwd_ms, plain_ms=pfwd_ms,
                    lib_ms=lib_fwd_ms, bound=bounds["fwd"],
                    path=paths["fwd"]),
        "dq": dict(err=abs_errs["dq"], ms=dq_ms, plain_ms=pbwd_ms,
                   lib_ms=lib_bwd_ms, bound=bounds["dq"], path=paths["dq"]),
        "dkv": dict(err=max(abs_errs["dk"], abs_errs["dv"]), ms=dkv_ms,
                    plain_ms=pbwd_ms, lib_ms=lib_bwd_ms,
                    bound=bounds["dkv"], path=paths["dkv"]),
    }


def prologue_case(name, seed, rows, c, dtype, has_res, has_mask, flush,
                  name_card):
    h = _randn(seed, (rows, c), dtype) * 3 + 1
    res = _randn(seed + 1, (rows, c), dtype) if has_res else None
    gamma = _randn(seed + 2, (c,), dtype) + 1
    beta = _randn(seed + 3, (c,), dtype)
    keep = 0.9 if has_mask else 1.0
    mask = (torch.rand((rows, c), device="cuda") < keep) if has_mask \
        else None
    args = (h, res, gamma, beta, mask, 1e-5, keep)
    out = fe.dropout_residual_norm_2d(*args)
    ref = fe.dropout_residual_norm_plain(*args)
    torch.cuda.synchronize()
    # bf16, f16: one rounding of values up to ~10, held relative to the
    # largest magnitude; f32 absolute
    err = (_abs_err(out, ref) if dtype == torch.float32
           else _scaled_err(out, ref))
    check(err <= TOL[dtype], f"prologue[{name}]: kernel vs plain {err} > "
                             f"{TOL[dtype]}")
    ms = time_ms(lambda: fe.dropout_residual_norm_2d(*args), flush)
    plain_ms = time_ms(lambda: fe.dropout_residual_norm_plain(*args), flush,
                       iters=KERNEL_ITERS)
    lib_ms = time_ms(lambda: F.layer_norm(h, (c,), gamma, beta, 1e-5),
                     flush)
    bms, by = _bound(fe.work(h, res, gamma, mask), 0, dtype)
    print(f"prologue[{name}] [{rows}, {c}] {str(dtype)[6:]} res={has_res} "
          f"mask={has_mask}: err {err:.3e} (tol {TOL[dtype]:g}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} "
          f"ms, bound {bms:.5f} ms ({by}) [{name_card}]")
    return dict(err=_abs_err(out, ref), ms=ms, plain_ms=plain_ms,
                lib_ms=lib_ms, bound=(bms, by))


def train_kernel_phase(flush, name_card):
    full = (TRAIN_BATCH, TRAIN_T, 8, 128)
    flash = {}
    for i, (name, shape, dtype, causal, window) in enumerate([
            ("causal_bf16", full, torch.bfloat16, True, None),
            ("causal_f32", full, torch.float32, True, None),
            ("full_bf16", full, torch.bfloat16, False, None),
            ("window256_bf16", full, torch.bfloat16, True, 256),
            ("ragged1000_bf16", (TRAIN_BATCH, 1000, 8, 128), torch.bfloat16,
             True, None),
            ("causal_f16", full, torch.float16, True, None),
            ("causal_f16_d64", (TRAIN_BATCH, TRAIN_T, 8, 64), torch.float16,
             True, None),
            ("full_f32", full, torch.float32, False, None),
            ("window256_f32", full, torch.float32, True, 256),
            ("ragged1000_f32", (TRAIN_BATCH, 1000, 8, 128), torch.float32,
             True, None),
            ("causal_f32_d64", (TRAIN_BATCH, TRAIN_T, 8, 64), torch.float32,
             True, None)]):
        flash[name] = flash_case(name, 200 + 10 * i, shape, dtype, causal,
                                 window, flush, name_card)
    rows = TRAIN_BATCH * TRAIN_T
    prologue = {}
    for i, (name, dtype, has_res, has_mask) in enumerate([
            ("prologue_bf16", torch.bfloat16, False, False),
            ("prologue_mask_bf16", torch.bfloat16, False, True),
            ("residual_bf16", torch.bfloat16, True, False),
            ("residual_mask_bf16", torch.bfloat16, True, True),
            ("prologue_mask_f32", torch.float32, False, True),
            ("prologue_mask_f16", torch.float16, False, True),
            ("residual_f16", torch.float16, True, False)]):
        prologue[name] = prologue_case(name, 300 + 10 * i, rows, 1024, dtype,
                                       has_res, has_mask, flush, name_card)
    return flash["causal_bf16"], flash["causal_f32"], prologue["prologue_bf16"]


# ------------------------------------------------------------ phase 4, train
def _matmul_params(net) -> int:
    """Weights of rank >= 2 outside the embedding: the N of the 6·N·tokens
    count (``bench.py`` ``_matmul_params``)."""
    return sum(p.numel() for layer in net.layers
               if not isinstance(layer, EmbeddingLayer)
               for p in tree_leaves(net.params[layer.name]) if p.ndim >= 2)


def _loss_and_grads(net, loss_of):
    """Loss and per-layer flat gradients of one forward/backward, no
    update; ``loss_of(params) -> (loss, new state)``."""
    trainable = net._trainable(net.params)
    names = [n for n in sorted(trainable)]
    leaves = {n: tree_leaves(trainable[n]) for n in names}
    flat = [p for n in names for p in leaves[n]]
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, _ = loss_of(net.params)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    out, i = {}, 0
    for n in names:
        k = len(leaves[n])
        out[n] = torch.cat([g.reshape(-1) for g in grads[i:i + k]])
        i += k
    return float(loss.detach()), out


def _rel_l2(grads, ref):
    return {n: ((grads[n] - ref[n]).norm()
                / ref[n].norm().clamp_min(1e-30)).item() for n in ref}


def first_step_check(what, net, loss_of, floor=False):
    """The first step's loss and per-layer gradients through the kernels
    against the built-in path (``enable_helpers(False)``).  ``floor``:
    also print how far two runs of the built-in path lie apart (the
    libraries' own run-to-run spread)."""
    k_loss, k_grads = _loss_and_grads(net, loss_of)
    helpers.enable_helpers(False)
    try:
        b_loss, b_grads = _loss_and_grads(net, loss_of)
        again = _loss_and_grads(net, loss_of)[1] if floor else None
    finally:
        helpers.enable_helpers(True)
    loss_rel = abs(k_loss - b_loss) / abs(b_loss)
    grad_rel = _rel_l2(k_grads, b_grads)
    worst = max(grad_rel, key=grad_rel.get)
    print(f"{what}: first-step loss kernels {k_loss:.6f} vs built-in "
          f"{b_loss:.6f} (rel {loss_rel:.3e}, tol {LOSS_RTOL}); per-layer "
          f"gradient rel L2 max {grad_rel[worst]:.3e} at {worst} (tol "
          f"{GRAD_RTOL})")
    if again is not None:
        spread = _rel_l2(again, b_grads)
        top = max(spread, key=spread.get)
        print(f"{what}: built-in path against itself, per-layer gradient "
              f"rel L2 max {spread[top]:.3e} at {top}, {spread[worst]:.3e} "
              f"at {worst}")
    check(loss_rel <= LOSS_RTOL, f"{what} first-step loss rel {loss_rel}")
    check(all(r <= GRAD_RTOL for r in grad_rel.values()),
          f"{what} per-layer gradient rel L2 {grad_rel}")
    del k_grads, b_grads, again
    torch.cuda.empty_cache()


# ------------------------------------- captured against eager training
def twin(net, capture):
    """A copy of ``net`` (params, updater and layer state, iteration, and
    its key stream's position, which ``clone`` starts afresh) whose
    ``fit`` replays captured graphs (``capture``) or runs eagerly."""
    t = net.clone()
    t._keys._gen.set_state(net._keys._gen.get_state())
    t._capture = capture
    return t


def named_state(net):
    """(name, tensor) of every param, updater-state and layer-state
    leaf."""
    out = []

    def walk(tree, name):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{name}/{k}")
        else:
            out.append((name, tree))

    for part in ("params", "updater_state", "net_state"):
        walk(getattr(net, part), part)
    return out


def state_gaps(a, b):
    """{leaf: max |a - b|} over the leaves where two nets differ."""
    return {n: (x.float() - y.float()).abs().max().item()
            for (n, x), (_, y) in zip(named_state(a), named_state(b))
            if not torch.equal(x, y)}


def fit_steps(net, batches, steps):
    """``steps`` ``fit`` calls over ``batches`` in turn, each timed on the
    host to the loss read: (losses, seconds, captures after each)."""
    losses, secs, caps = [], [], []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        losses.append(net.score_value)      # reads the loss: waits for it
        secs.append(time.perf_counter() - t0)
        graphs = net._step_graphs
        caps.append(graphs.captures if graphs is not None else 0)
    return losses, secs, caps


def _loss_gap(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


def modes_agree(what, runs, rerun):
    """Captured against eager training: ``runs`` is [(net, losses)] of two
    eager runs and a captured one over the same steps from one state.  If
    the eager runs agree bit for bit, the captured run must equal them
    bit for bit.  If not, the leaves that differ are named and all three
    run again with ``cudnn.deterministic`` (``rerun()`` gives the new
    triple): bit for bit if the eager runs then agree, else the captured
    run held to twice their largest difference.  Returns the verdict."""
    (e1, l1), (e2, l2), (c, lc) = runs
    gaps = state_gaps(e1, e2)
    if not gaps and l1 == l2:
        got = state_gaps(c, e1)
        print(f"{what}: two eager runs agree bit for bit; captured against "
              f"eager: {len(got)} of {len(named_state(c))} leaves differ, "
              f"losses {'equal' if lc == l1 else 'differ'}")
        check(not got and lc == l1, f"{what}: captured == eager bit for "
                                    f"bit ({sorted(got)[:4]})")
        return "bit for bit"
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    print(f"{what}: two eager runs differ in {len(gaps)} of "
          f"{len(named_state(e1))} leaves (largest {top}), losses by "
          f"{_loss_gap(l1, l2):.3e}; again with cudnn.deterministic")
    torch.backends.cudnn.deterministic = True
    try:
        (e1, l1), (e2, l2), (c, lc) = rerun()
    finally:
        torch.backends.cudnn.deterministic = False
    gaps, got = state_gaps(e1, e2), state_gaps(c, e1)
    if not gaps and l1 == l2:
        print(f"{what}: under cudnn.deterministic two eager runs agree bit "
              f"for bit; captured against eager: {len(got)} leaves differ")
        check(not got and lc == l1, f"{what}: captured == eager bit for "
                                    f"bit, deterministic ({sorted(got)[:4]})")
        return "bit for bit under cudnn.deterministic"
    bound = 2 * max(gaps.values(), default=0.0)
    worst = max(got.values(), default=0.0)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    print(f"{what}: under cudnn.deterministic two eager runs still differ "
          f"in {len(gaps)} leaves (largest {top}); captured against eager "
          f"{worst:.3e} (bound {bound:.3e}), losses "
          f"{_loss_gap(lc, l1):.3e} (bound {2 * _loss_gap(l1, l2):.3e})")
    check(worst <= bound and _loss_gap(lc, l1) <= 2 * _loss_gap(l1, l2),
          f"{what}: captured within twice the eager spread")
    return f"within twice the eager spread ({worst:.3e} <= {bound:.3e})"


def _launch_counts():
    return {n: (c.launches, c.plain_calls)
            for n, c in helpers.kernel_counts().items()}


def fit_modes(what, net, batches, per_step, name_card, items=None,
              flops=None, peak=None, unit="images"):
    """The phase's 2 warm-up and 5 timed ``fit`` steps twice from one
    state: eagerly (``_capture`` off; run twice, for the comparison) and
    through the captured graph (``net`` itself, the default).  Eager, the
    wrappers count ``per_step`` launches a step; captured, they count
    one step's worth at the warm-up and one at the capture, the graph
    holds ``per_step``, and there is one capture from the first step on.
    The modes agree as ``modes_agree`` says.  Prints each mode's median,
    ``items``/s, analytic-FLOP utilisation and the spread of its timed
    steps.  Returns (eager net, {mode: numbers})."""
    steps = WARM_STEPS + TIMED_STEPS
    init = twin(net, False)
    eager, eager2 = twin(net, False), twin(net, False)
    net._capture = True
    # an output graph the phase captured before counts apart
    caps0 = net._step_graphs.captures if net._step_graphs else 0
    runs, out = [], {}
    for label, n in (("eager", eager), ("eager again", eager2),
                     ("captured", net)):
        for c in helpers.kernel_counts().values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, caps = fit_steps(n, batches, steps)
        counts = _launch_counts()
        runs.append((n, losses))
        check(all(np.isfinite(losses)), f"{what} [{label}] losses finite")
        check(all(p == 0 for _, p in counts.values()),
              f"{what} [{label}]: plain-version calls {counts}")
        if label == "eager again":
            continue
        factor = steps if label == "eager" else 2
        got = {k: l for k, (l, _) in counts.items() if l}
        want = {k: factor * v for k, v in per_step.items()}
        print(f"{what} [{label}]: wrapper launches over {steps} steps "
              f"{got}, expected {want}; captures after each step {caps}")
        check(got == want, f"{what} [{label}] launches {got} == {want}")
        if label == "captured":
            held = [v for k, v in net._step_graphs.graph_launches().items()
                    if k[0] == "train"]
            print(f"{what} [captured]: the graph holds {held}; "
                  f"{net._step_graphs.replays} replays")
            check(caps == [caps0 + 1] * steps,
                  f"{what}: one capture, at the first step ({caps})")
            check(held == [per_step], f"{what}: graph launches {held}")
        timed = secs[WARM_STEPS:]
        med = float(np.median(timed))
        row = dict(ms=med * 1e3, spread=(min(timed) * 1e3,
                                         max(timed) * 1e3),
                   losses=losses,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        line = (f"{what} [{label}]: step median {med * 1e3:.3f} ms over "
                f"{TIMED_STEPS} steps (after {WARM_STEPS} warm-up), timed "
                f"steps {row['spread'][0]:.3f}-{row['spread'][1]:.3f} ms")
        if items is not None:
            line += f"; {items / med:.1f} {unit}/s"
        if flops is not None:
            row["util"] = flops / med / peak
            line += (f"; analytic-FLOP utilisation {row['util']:.4f} of "
                     f"{peak / 1e12:.0f} TFLOP/s ({flops / 1e12:.3f} TFLOP "
                     f"a step)")
        print(line + f"; peak memory {row['peak_gb']:.2f} GB [{name_card}]")
        print(f"{what} [{label}]: losses {[round(v, 6) for v in losses]}")
        out[label] = row

    def rerun():
        nets = [twin(init, False), twin(init, False), twin(init, True)]
        return [(n, fit_steps(n, batches, steps)[0]) for n in nets]

    out["agree"] = modes_agree(what, runs, rerun)
    print(f"{what}: captured against eager: {out['agree']}; median "
          f"{out['captured']['ms']:.3f} vs {out['eager']['ms']:.3f} ms "
          f"[{name_card}]")
    del init, eager2, runs
    torch.cuda.empty_cache()
    return eager, out


def train_phase(name_card, model=TRAIN_MODEL, what="train"):
    """``fit`` on the char-LM at full width, captured and eager; ``model``
    without a compute_dtype trains in float32, whose flash kernels must
    run on tf32x3."""
    net = transformer_char_lm(device="cuda", **model)
    vocab = model["vocab_size"]
    ids = np.random.RandomState(0).randint(0, vocab, (TRAIN_BATCH, TRAIN_T))
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)],
                        device="cuda")

    # the first step through the kernels against the built-in path
    first_step_check(what, net,
                     lambda params: net._loss_fn(params, x, y, None))

    layers = model["layers"]
    tokens = TRAIN_BATCH * TRAIN_T
    heads, d_model = model["n_heads"], model["d_model"]
    flops = (6.0 * _matmul_params(net) * tokens
             + 12.0 * layers * heads * TRAIN_T * TRAIN_T
             * (d_model // heads) * TRAIN_BATCH * 0.5)
    dtype = getattr(torch, model.get("compute_dtype") or "float32")
    per_step = {"flash_fwd": layers, "flash_dq": layers,
                "flash_dkv": layers, "prologue": 2 * layers}
    eager, rows = fit_modes(what, net, [(x, y)], per_step, name_card,
                            items=tokens, flops=flops,
                            peak=PEAK_OPS[dtype], unit="tokens")
    check(rows["captured"]["losses"][-1] < rows["captured"]["losses"][0],
          f"loss falls: {rows['captured']['losses']}")
    paths = {kn: fa.kernel_path(kn, dtype, d_model // heads)
             for kn in ("fwd", "dq", "dkv")}
    train_profile(eager, x, y, name_card, f"{what} [eager]", paths, layers)
    launches = train_profile(net, x, y, name_card, f"{what} [captured]",
                             paths, layers)
    return launches


PROFILED_FIT_STEPS = 2      # fit steps under the profiler, each mode


def _profile_fit(net, *feed, steps=PROFILED_FIT_STEPS, warmup=True):
    """``steps`` calls of ``net.fit(*feed)`` (after one unprofiled call
    under ``warmup``) under the CUDA profiler: (events with device time,
    host wall ms a call, device busy ms a call, the profile)."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        net.fit(*feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            net.fit(*feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    check(busy_ms > 0, "the profiler saw device time")
    return ev, wall_ms, busy_ms, prof


def _host_trace(what, net, x, y, name_card):
    """One more step with the host's operations traced (the tracing adds
    its own cost to the host time it reports); the events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(x, y)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    host_ms = sum(e.self_cpu_time_total for e in ev) / 1e3
    launch = [e for e in ev if e.key == "cudaLaunchKernel"]
    graphs = sum(e.count for e in ev if e.key == "cudaGraphLaunch")
    print(f"{what} step host side (traced): self host time {host_ms:.3f} "
          f"ms; cudaLaunchKernel {sum(e.count for e in launch)} calls, "
          f"{sum(e.self_cpu_time_total for e in launch) / 1e3:.3f} ms; "
          f"cudaGraphLaunch {graphs} [{name_card}]")
    return ev


def train_profile(net, x, y, name_card, what, paths, layers):
    """Where a train step's time goes, over ``PROFILED_FIT_STEPS`` steps:
    the device's busy time by kernel against the step's host wall.  Each
    flash kernel must run on its route in ``paths`` (``flash_dq_tf32``
    and the like), ``layers`` times a step, and the prologue twice that.
    Returns the profiled launches (fwd, dQ, dK/dV, prologue)."""
    n = PROFILED_FIT_STEPS
    ev, wall_ms, busy_ms, _ = _profile_fit(net, x, y, steps=n)
    ours = {"flash fwd": "flash_fwd_", "flash dQ": "flash_dq_",
            "flash dK/dV": "flash_dkv_", "prologue": "drn_kernel"}
    share = {k: sum(e.self_device_time_total for e in ev if pat in e.key)
             / 1e3 / n for k, pat in ours.items()}
    counts = {k: sum(e.count for e in ev if pat in e.key)
              for k, pat in ours.items()}
    # each flash kernel's time is all on its route's kernel
    suffix = {"wgmma": "wgmma", "tf32x3": "tf32", "mma_sync": "mma",
              "cuda_cores": "kernel"}
    for kn, label in (("fwd", "flash fwd"), ("dq", "flash dQ"),
                      ("dkv", "flash dK/dV")):
        name = f"flash_{kn}_{suffix[paths[kn]]}"
        on_route = sum(e.self_device_time_total for e in ev
                       if name in e.key) / 1e3 / n
        check(on_route > 0 and on_route == share[label],
              f"{what}: the step's {label} ran {name} only ({on_route} of "
              f"{share[label]} ms)")
    want = {"flash fwd": layers * n, "flash dQ": layers * n,
            "flash dK/dV": layers * n, "prologue": 2 * layers * n}
    check(counts == want, f"{what}: profiled launches {counts} == {want}")
    print(f"{what} step (profiled, {n} steps): host wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / n:.0f} device operations a step; "
          f"launches {counts} [{name_card}]")
    print(f"{what} step kernels ({paths['fwd']} fwd, {paths['dq']} dQ, "
          f"{paths['dkv']} dK/dV): " + ", ".join(
              f"{k} {v:.3f} ms ({v / busy_ms:.3f})" for k, v in share.items())
          + f"; the four together {sum(share.values()) / busy_ms:.3f} of "
          f"busy; flash {sum(share.values()) - share['prologue']:.3f} ms "
          f"({(sum(share.values()) - share['prologue']) / busy_ms:.3f})")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  top: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:90]}")

    # the host's side: its launches, and no delta reduction
    # (``_row_delta`` labels itself flash_row_delta)
    hev = _host_trace(what, net, x, y, name_card)
    row_delta = sum(e.count for e in hev if e.key == "flash_row_delta")
    print(f"{what} step: _row_delta reductions {row_delta}")
    check(row_delta == 0, f"the {what} step ran {row_delta} _row_delta "
                          "reductions")
    return [counts[k] for k in ours]


# ------------------------------------------------- phase 5, batch norm
BN_EPS = 1e-5


def bn_case(name, seed, shape, dtype, adt, flush, name_card):
    """The three BatchNorm kernels on one NHWC shape, as [N·H·W, C], with
    gamma and beta in ``adt``."""
    n, h, w, c = shape
    m = n * h * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, c, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
    gamma = (torch.randn(c, generator=g, device="cuda") + 1).to(adt)
    beta = torch.randn(c, generator=g, device="cuda").to(adt)
    y, mean, var, inv = bn.bn_train_fwd_2d(x, gamma, beta, BN_EPS)
    dx, dgamma, dbeta = bn.bn_train_bwd_2d(x, gy, gamma, mean, inv)
    rvar = var + 0.25       # running stats of the inference case
    yi = bn.bn_inference_2d(x, mean, rvar, gamma, beta, BN_EPS)
    ry, rmean, rv, rinv = bn.bn_train_fwd_plain(x, gamma, beta, BN_EPS)
    rdx, rdg, rdb = bn.bn_train_bwd_plain(x, gy, gamma, rmean, rinv)
    ryi = bn.bn_inference_plain(x, mean, rvar, gamma, beta, BN_EPS)
    torch.cuda.synchronize()
    pairs = {"fwd": ((y, ry), (mean, rmean), (var, rv)),
             "bwd": ((dx, rdx), (dgamma, rdg), (dbeta, rdb)),
             "inf": ((yi, ryi),)}
    errs = {k: max(_scaled_err(a, r) for a, r in v) for k, v in pairs.items()}
    abs_errs = {k: max(_abs_err(a, r) for a, r in v)
                for k, v in pairs.items()}
    for k, err in errs.items():
        check(err <= TOL[dtype], f"batch_norm[{name}] {k}: kernel vs plain "
                                 f"{err} > {TOL[dtype]}")
    del ry, rmean, rv, rinv, rdx, rdg, rdb, ryi, y, dx, yi
    torch.cuda.empty_cache()

    calls = {
        "fwd": (lambda: bn.bn_train_fwd_2d(x, gamma, beta, BN_EPS),
                lambda: bn.bn_train_fwd_plain(x, gamma, beta, BN_EPS)),
        "bwd": (lambda: bn.bn_train_bwd_2d(x, gy, gamma, mean, inv),
                lambda: bn.bn_train_bwd_plain(x, gy, gamma, mean, inv)),
        "inf": (lambda: bn.bn_inference_2d(x, mean, rvar, gamma, beta,
                                           BN_EPS),
                lambda: bn.bn_inference_plain(x, mean, rvar, gamma, beta,
                                              BN_EPS)),
    }
    ms = {k: time_ms(kern, flush) for k, (kern, _) in calls.items()}
    plain_ms = {k: time_ms(plain, flush, iters=KERNEL_ITERS)
                for k, (_, plain) in calls.items()}

    # yardsticks the port never calls: F.batch_norm on the channels_last
    # NCHW view of the NHWC tensor, gamma and beta in float32 (as cuDNN
    # takes them beside the float32 running stats)
    x4 = x.view(n, h, w, c).permute(0, 3, 1, 2)
    gy4 = gy.view(n, h, w, c).permute(0, 3, 1, 2)
    xl, gl, bl = (t.detach().clone().requires_grad_()
                  for t in (x4, gamma.float(), beta.float()))
    lib_fwd = lambda: F.batch_norm(xl, None, None, gl, bl, True, 0.1, BN_EPS)
    out = lib_fwd()
    lib_err = _abs_err(out.permute(0, 2, 3, 1).reshape(m, c),
                       bn.bn_train_fwd_plain(x, gamma, beta, BN_EPS)[0])
    lib_ms = {
        "fwd": time_ms(lib_fwd, flush),
        "bwd": time_ms(lambda: torch.autograd.grad(
            out, (xl, gl, bl), gy4, retain_graph=True), flush),
        "inf": time_ms(lambda: F.batch_norm(x4, mean, rvar, gl.detach(),
                                            bl.detach(), False, 0.1, BN_EPS),
                       flush),
    }
    del out, xl, gl, bl

    bounds = {k: _bound(bn.work(x, gamma, k), 0, dtype)
              for k in ("fwd", "bwd", "inf")}
    print(f"batch_norm[{name}] [{m}, {c}] {str(dtype)[6:]} (gamma, beta "
          f"{str(adt)[6:]}): err train fwd "
          f"{errs['fwd']:.3e}, train bwd {errs['bwd']:.3e}, inference "
          f"{errs['inf']:.3e} (scaled by max abs; tol {TOL[dtype]:g}); "
          f"F.batch_norm fwd abs err {lib_err:.3e} [{name_card}]")
    print(f"batch_norm[{name}] " + "; ".join(
        f"{label} {ms[k]:.4f} ms (bound {bounds[k][0]:.5f} ms, "
        f"{bounds[k][1]}; plain {plain_ms[k]:.4f} ms, F.batch_norm "
        f"{lib_ms[k]:.4f} ms)" for k, label in (
            ("fwd", "train fwd"), ("bwd", "train bwd"),
            ("inf", "inference"))) + f" [{name_card}]")
    return {k: dict(err=abs_errs[k], ms=ms[k], plain_ms=plain_ms[k],
                    lib_ms=lib_ms[k], bound=bounds[k]) for k in ms}


def bn_kernel_phase(flush, name_card):
    return {name: bn_case(name, 400 + 10 * i, shape, dtype, adt, flush,
                          name_card)
            for i, (name, shape, dtype, adt) in enumerate(BN_CASES)}


# -------------------------------------------------- phase 6, ResNet-50
def _forward_flops(net, acts) -> int:
    """Multiply-adds x 2 of every convolution and of the head, from the
    activations' shapes."""
    total = 0
    for node in net.conf.nodes:
        layer = node.layer
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            total += 2 * acts[node.name].numel() * kh * kw * layer.n_in
        elif node.name in net.conf.outputs:
            total += 2 * acts[node.inputs[0]].numel() * layer.n_out
    return total


def _bn_counts():
    return (bn.inference_counts, bn.train_fwd_counts, bn.train_bwd_counts)


# BatchNorm's CUDA kernels a training call launches: the reduction (moments
# or grad sums, the merge folded in) and the elementwise pass
BN_KERNELS_PER_TRAIN_CALL = 2
BN_KERNEL_RE = r"\bbn_[a-z_]+(kernel|finalize)"
# the elementwise pass's mode (its last template argument) by name
BN_MODES = {"0": "apply", "1": "dx", "2": "inference"}


def bn_pass(key: str) -> str:
    """The BatchNorm pass of a profiled kernel name."""
    if "finalize" in key:
        return "finalize"
    if "bn_moments" in key:
        return "moments"
    if "bn_grad_sums" in key:
        return "grad sums"
    mode = re.search(r"bn_elementwise_kernel<[^<>]*?(\d+)>", key)
    return BN_MODES.get(mode.group(1), "elementwise") if mode else key


def bn_passes(events):
    """{pass: (device ms, launches)} of the profiled BatchNorm kernels among
    ``events`` (``torch.profiler`` key averages)."""
    split = {}
    for e in events:
        if e.self_device_time_total > 0 and re.search(BN_KERNEL_RE, e.key):
            ms, n = split.get(bn_pass(e.key), (0.0, 0))
            split[bn_pass(e.key)] = (ms + e.self_device_time_total / 1e3,
                                     n + e.count)
    return split


def bn_pass_split(events, label="BatchNorm", prof=None):
    """Print profiled BatchNorm kernels' device ms and launches by pass, a
    step (``PROFILED_FIT_STEPS`` profiled); returns the totals."""
    split = bn_passes(events)
    n = PROFILED_FIT_STEPS
    print(f"  {label} by pass, a step: " + "; ".join(
        f"{k} {ms / n:.3f} ms in {c // n} launches"
        for k, (ms, c) in sorted(split.items(), key=lambda kv: -kv[1][0])))
    return split


def resnet_phase(name_card):
    net = resnet50(device="cuda", **RESNET)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(RESNET_BATCH, 224, 224, 3).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rs.randint(0, 1000, RESNET_BATCH)], device="cuda")
    print(f"resnet50: {net.num_params()} params, "
          f"{sum(1 for l in net.layers if type(l).__name__ == 'BatchNormalization')}"
          f" BatchNorm layers, batch {RESNET_BATCH}x224x224x3 bf16")

    # output() through the inference kernel: eagerly, then captured (the
    # default): the first call warms and captures, later ones replay
    eager = twin(net, False)
    for c in _bn_counts():
        c.reset()
    probs = eager.output(x)
    torch.cuda.synchronize()
    seen = [c.launches for c in _bn_counts()]
    plain = [c.plain_calls for c in _bn_counts()]
    print(f"resnet50 output [eager]: BatchNorm launches (inference, train "
          f"fwd, train bwd) {seen}, plain-version calls {plain}")
    check(seen == [RESNET_BN_LAYERS, 0, 0], f"output launches {seen}")
    check(plain == [0, 0, 0], f"output plain-version calls {plain}")
    check(tuple(probs.shape) == (RESNET_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and (probs.sum(-1) - 1).abs().max().item() < 1e-3,
          "output: finite probabilities of shape [128, 1000]")
    for c in _bn_counts():
        c.reset()
    cap_probs = [net.output(x), net.output(x)]
    graphs = net._step_graphs
    seen = [c.launches for c in _bn_counts()]
    print(f"resnet50 output [captured]: wrapper launches {seen} (warm-up "
          f"and capture), captures {graphs.captures}, replays "
          f"{graphs.replays}, the graph holds "
          f"{list(graphs.graph_launches().values())}")
    check(seen == [2 * RESNET_BN_LAYERS, 0, 0] and graphs.captures == 1
          and graphs.replays == 1, "captured output: one capture")
    check(all(torch.equal(p, probs) for p in cap_probs),
          "resnet50 output: captured == eager bit for bit")
    output_profile("resnet50 [eager]", lambda: eager.output(x),
                   BN_KERNEL_RE, "BatchNorm", name_card, RESNET_BN_LAYERS)
    inf_launches = output_profile(
        "resnet50 [captured]", lambda: net.output(x), BN_KERNEL_RE,
        "BatchNorm", name_card, RESNET_BN_LAYERS)
    del eager, cap_probs

    def logits():
        with torch.no_grad():
            acts, _, _ = net._forward(net.params, net.net_state,
                                      {"input": x})
        return acts

    acts = logits()
    fwd_flops = _forward_flops(net, acts)
    # each BatchNorm keeps one [M, C] tensor for its backward (x here, x̂
    # in the reference); a step must read x and write y forward, read x
    # and g and write dx backward
    bn_elems = sum(acts[n.inputs[0]].numel() for n in net.conf.nodes
                   if isinstance(n.layer, BatchNormalization))
    bn_bytes = 5 * bn_elems * 2
    print(f"resnet50 BatchNorm: {bn_elems} input elements over the "
          f"{RESNET_BN_LAYERS} layers, {bn_elems * 2 / 1e9:.3f} GB saved "
          f"for the backward in bfloat16; least bytes a train step "
          f"{bn_bytes / 1e9:.3f} GB = {bn_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
          f"ms at 3.35 TB/s")
    k_logits = acts["fc"].float()
    del acts
    helpers.enable_helpers(False)
    try:
        b_logits = logits()["fc"].float()
    finally:
        helpers.enable_helpers(True)
    err = _scaled_err(k_logits, b_logits)
    agree = (k_logits.argmax(-1) == b_logits.argmax(-1)).sum().item()
    print(f"resnet50 logits, kernels vs built-in path: max abs err "
          f"{_abs_err(k_logits, b_logits):.3e} over max |logit| "
          f"{b_logits.abs().max().item():.3f} = {err:.3e} (tol "
          f"{RESNET_LOGITS_TOL}); argmax agrees on {agree}/{RESNET_BATCH} "
          f"(at least {RESNET_BATCH - RESNET_ARGMAX_MISSES})")
    check(err <= RESNET_LOGITS_TOL, f"resnet50 logits {err}")
    check(agree >= RESNET_BATCH - RESNET_ARGMAX_MISSES,
          f"resnet50 argmax agrees on {agree}/{RESNET_BATCH}")
    del k_logits, b_logits, probs
    torch.cuda.empty_cache()

    def loss_of(params):
        return net._loss_fn(params, net.net_state, x, y, None)

    with torch.no_grad():
        k_loss = float(loss_of(net.params)[0])
        helpers.enable_helpers(False)
        try:
            b_loss = float(loss_of(net.params)[0])
        finally:
            helpers.enable_helpers(True)
    loss_rel = abs(k_loss - b_loss) / abs(b_loss)
    print(f"resnet50: first-step loss in bfloat16, kernels {k_loss:.6f} vs "
          f"built-in {b_loss:.6f} (rel {loss_rel:.3e}, tol {LOSS_RTOL})")
    check(loss_rel <= LOSS_RTOL, f"resnet50 bf16 first-step loss {loss_rel}")
    # gradients in float32: in bfloat16 the lower layers' gradients at
    # initialisation are mostly rounding, on the built-in path as on the
    # kernels' (the BatchNorm backward cancels), so only a float32 run
    # can hold the two paths to each other
    bf16_conf = net.conf
    net.conf = dataclasses.replace(bf16_conf, compute_dtype=None)
    try:
        first_step_check("resnet50 (float32)", net, loss_of)
    finally:
        net.conf = bf16_conf

    start = {k: {s: v.clone() for s, v in st.items()}
             for k, st in net.net_state.items()}
    per_step = {"bn_train_fwd": RESNET_BN_LAYERS,
                "bn_train_bwd": RESNET_BN_LAYERS}
    eager, rows = fit_modes("resnet50 train", net, [(x, y)], per_step,
                            name_card, items=RESNET_BATCH,
                            flops=3.0 * fwd_flops,
                            peak=PEAK_OPS[torch.bfloat16])
    stats = [(k, s, v) for k, st in net.net_state.items()
             for s, v in st.items()]
    check(all(bool(torch.isfinite(v).all()) for _, _, v in stats),
          "running stats finite")
    check(all(not torch.equal(v, start[k][s]) for k, s, v in stats),
          "every running stat moved")
    kernels = 2 * BN_KERNELS_PER_TRAIN_CALL * RESNET_BN_LAYERS
    step_profile("resnet50 [eager]", eager, x, y, BN_KERNEL_RE,
                 "BatchNorm", name_card, split=bn_pass_split,
                 launches=kernels)
    split = step_profile("resnet50 [captured]", net, x, y, BN_KERNEL_RE,
                         "BatchNorm", name_card, split=bn_pass_split,
                         launches=kernels)
    # a training call launches one reduction (moments, grad sums) each
    return inf_launches, split["moments"][1], split["grad sums"][1]


def _drive_serving(eng, threads, per_thread):
    """bench.py's ``_drive_serving`` at ResNet-50's rows: ``threads``
    clients of ``per_thread`` requests of 1-16 seeded rows each (made
    before the clock starts).  Returns [(rows, result, trace id)], the
    latencies in seconds and the wall seconds."""
    feats = []
    for tid in range(threads):
        rs = np.random.RandomState(1000 + tid)
        sizes = 1 + rs.randint(16, size=per_thread)
        feats.append([rs.rand(int(s), *SERVE_ROW).astype(np.float32)
                      for s in sizes])
    results, lat, errors = [], [], []
    lock = threading.Lock()

    def client(tid):
        try:
            for i, x in enumerate(feats[tid]):
                t0 = time.perf_counter()
                out = eng.predict(x, trace_id=f"t{tid}r{i}")
                dt = time.perf_counter() - t0
                with lock:
                    results.append((x, out, f"t{tid}r{i}"))
                    lat.append(dt)
        except Exception as e:              # reported below
            errors.append(e)

    ths = [threading.Thread(target=client, args=(t,), daemon=True)
           for t in range(threads)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(900)
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in ths),
          f"serving: client errors {errors!r}")
    return results, lat, wall


def serving_phase(name_card):
    """The batch ``ServingEngine`` over ResNet-50 bf16 ``output`` with
    bench_serving's policy and traffic (``bench.py:1050-1158``): every
    result against the net's eager ``output`` on the same rows, nothing
    captured after warm-up, a profiled dispatch's BatchNorm launches,
    and a deploy and a rollback under load."""
    from deeplearning4j_tpu_torch.serving import BucketPolicy, ServingEngine

    net = resnet50(device="cuda", **RESNET)
    example = np.zeros(SERVE_ROW, np.float32)
    eng = ServingEngine(net, policy=BucketPolicy(max_batch=SERVE_MAX_BATCH),
                        max_wait_ms=1.0, max_queue=4096, example=example)
    t0 = time.perf_counter()
    eng.start()
    mv = eng.models.active("default")
    buckets = len(eng.policy.batch_buckets)
    graphs = net._step_graphs
    caps = graphs.captures
    print(f"serving: warm-up of {buckets} buckets "
          f"{list(eng.policy.batch_buckets)} {time.perf_counter() - t0:.2f}"
          f" s; captures {caps}, detector {mv.detector.compile_count}")
    check(mv.detector.compile_count == buckets and caps == buckets,
          "serving: one capture a bucket at warm-up")
    results, lat, wall = _drive_serving(eng, SERVE_THREADS,
                                        SERVE_PER_THREAD)
    rows = sum(len(x) for x, _, _ in results)
    print(f"serving: {len(results)} requests, {rows} rows in {wall:.3f} s:"
          f" {rows / wall:.1f} rows/s, p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms [{name_card}]")
    # where a request's time went: queue wait and its batch's execute
    # (bucket padding, the output replay, the copies either side)
    parts = [eng.request_breakdown(tid) for _, _, tid in results]
    qw = [b["queue_wait_ms"] for b in parts]
    ex = {(b["execute_ms"], b["batch_rows"]) for b in parts}
    ex_ms = [e for e, _ in ex]
    print(f"serving: queue wait p50 {np.percentile(qw, 50):.3f} ms, p99 "
          f"{np.percentile(qw, 99):.3f} ms; {len(ex)} dispatches of "
          f"{np.mean([r for _, r in ex]):.1f} rows on average, execute p50 "
          f"{np.percentile(ex_ms, 50):.3f} ms, p99 "
          f"{np.percentile(ex_ms, 99):.3f} ms")
    # one full bucket: the output call alone (host wall, the staging
    # copies and the read-back included), then one dispatch profiled
    x64 = results[0][0][:1].repeat(SERVE_MAX_BATCH, axis=0)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(x64).cpu()
        walls.append(time.perf_counter() - t0)
    print(f"serving: net.output on {SERVE_MAX_BATCH} rows (the bucket's "
          f"replay) host wall median {np.median(walls) * 1e3:.3f} ms")
    _, bn_n = profiled_launches(lambda: eng.predict(x64), BN_KERNEL_RE)
    print(f"serving: a profiled {SERVE_MAX_BATCH}-row dispatch launches "
          f"{bn_n} BatchNorm inference kernels")
    check(bn_n == RESNET_BN_LAYERS, f"serving: {bn_n} BatchNorm launches "
                                    f"a replay")
    check(mv.detector.compile_count == buckets
          and graphs.captures == caps,
          "serving: nothing captured after warm-up")

    # a deploy (another seed, retained) and a rollback under load
    net2 = resnet50(device="cuda", **{**RESNET, "seed": SWAP_SEED})
    stop, served, errors = threading.Event(), [0], []

    def load(tid):
        rs = np.random.RandomState(2000 + tid)
        while not stop.is_set():
            try:
                x = rs.rand(1 + rs.randint(16), *SERVE_ROW).astype(
                    np.float32)
                out = eng.predict(x)
                check(out.shape == (len(x), SERVE_CLASSES)
                      and bool(np.isfinite(out).all()), "a finite result")
                served[0] += 1
            except Exception as e:          # reported below
                errors.append(e)
                return

    ths = [threading.Thread(target=load, args=(t,), daemon=True)
           for t in range(SERVE_THREADS)]
    for th in ths:
        th.start()
    t0 = time.perf_counter()
    mv2 = eng.deploy("default", net2, retain_old=True, example=example)
    t_deploy = time.perf_counter() - t0
    time.sleep(0.5)
    eng.rollback("default")
    time.sleep(0.5)
    stop.set()
    for th in ths:
        th.join(600)
    check(not errors and not any(th.is_alive() for th in ths),
          f"serving: a request failed across deploy and rollback "
          f"{errors!r}")
    print(f"serving: deploy (warm-up included) {t_deploy:.2f} s, "
          f"detector {mv2.detector.compile_count}; {served[0]} requests "
          f"served across deploy and rollback, none failed; "
          f"status counts {eng.status_counts('default')}")
    check(eng.models.active("default") is mv
          and mv.detector.compile_count == buckets
          and graphs.captures == caps,
          "serving: the rollback replays the retained graphs")
    eng.stop()
    del net2, mv2

    # every result against the eager forward on its own rows: the
    # logits (the output node's pre-activation, float32), whose softmax
    # the served probabilities must match; a random-weight ResNet-50's
    # logits span hundreds, so its softmax is one-hot in float32 and
    # the argmax carries the comparison (differences allowed only where
    # the top two logits lie within the tolerance)
    worst, top, misses, ties, exact = 0.0, 0.0, 0, 0, 0
    for x, out, _ in results:
        with torch.no_grad():
            acts, _, _ = net._forward(net.params, net.net_state, {
                "input": torch.as_tensor(x, device="cuda")})
        logit = acts["fc"].float()
        ref = torch.softmax(logit, dim=-1).cpu().numpy()
        logit = logit.cpu().numpy()
        exact += int((out == ref).all(axis=1).sum())
        top = max(top, float(np.abs(logit).max()))
        two = -np.sort(-logit, axis=1)[:, :2]
        near = (two[:, 0] - two[:, 1]) <= RESNET_LOGITS_TOL * np.abs(
            logit).max()
        differ = out.argmax(-1) != logit.argmax(-1)
        misses += int((differ & ~near).sum())
        ties += int((differ & near).sum())
        if (~differ).any():
            worst = max(worst, float(np.abs(out - ref)[~differ].max()))
    print(f"serving: results vs the eager forward on the same rows: "
          f"{exact} of {rows} rows bit for bit; probabilities max abs err "
          f"{worst:.3e} where the argmax agrees (tol {RESNET_LOGITS_TOL}; "
          f"max |logit| {top:.3f}); argmax differs on {ties} near-tied and "
          f"{misses} other rows")
    check(worst <= RESNET_LOGITS_TOL, f"serving probabilities {worst}")
    check(misses == 0, f"serving: {misses} argmax differences off a "
                       f"near-tie")


def output_profile(what, call, kernel_re, label, name_card, per_call):
    """Where ``output``'s time goes, over ``PROFILED_FIT_STEPS`` calls:
    device busy against host wall, and the share of the kernels whose
    names match ``kernel_re``, which must launch ``per_call`` times a
    call.  Returns their launches."""
    from torch.profiler import ProfilerActivity, profile

    n = PROFILED_FIT_STEPS
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    ours = [e for e in ev if re.search(kernel_re, e.key)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3 / n
    launches = sum(e.count for e in ours)
    check(ours_ms > 0, f"the profiled {what} output ran the {label} kernels")
    check(launches == per_call * n, f"{what} output: {launches} {label} "
                                    f"launches == {per_call} x {n}")
    print(f"{what} output (profiled, {n} calls): host wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / n:.0f} device operations a call; "
          f"{label} kernels {ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of "
          f"busy) in {launches} launches [{name_card}]")
    return launches


def step_profile(what, net, x, y, kernel_re, label, name_card, split=None,
                 launches=None):
    """Where a train step's time goes, over ``PROFILED_FIT_STEPS`` steps:
    device busy against host wall, the share of the kernels whose names
    match ``kernel_re`` (``launches`` of them a step where given; split by
    ``split(events, label, prof)`` where given, whose result is
    returned), copy kernels, then the host's operations in a traced
    step."""
    n = PROFILED_FIT_STEPS
    ev, wall_ms, busy_ms, prof = _profile_fit(net, x, y, steps=n)
    ours = [e for e in ev if re.search(kernel_re, e.key)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3 / n
    copies = [e for e in ev if "copy" in e.key.lower()]
    print(f"{what} step (profiled, {n} steps): host wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / n:.0f} device operations a step; "
          f"{label} kernels {ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of "
          f"busy) in {sum(e.count for e in ours) / n:.0f} launches a step; "
          f"copy kernels "
          f"{sum(e.self_device_time_total for e in copies) / 1e3 / n:.3f} "
          f"ms in {sum(e.count for e in copies) / n:.0f} launches "
          f"[{name_card}]")
    check(ours_ms > 0, f"the profiled {what} step ran the {label} kernels")
    n_ours = sum(e.count for e in ours)
    check(launches is None or n_ours == launches * n,
          f"the profiled {what} steps launched {n_ours} {label} kernels, "
          f"expected {launches} x {n}")
    for e in sorted(ours, key=lambda e: -e.self_device_time_total):
        print(f"  {label}: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:100]}")
    out = split(ours, label, prof) if split is not None else None
    for e in sorted(copies, key=lambda e: -e.self_device_time_total)[:4]:
        print(f"  copy: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:100]}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  top: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:100]}")
    hev = _host_trace(what, net, x, y, name_card)
    for e in sorted(hev, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  host: {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    return out


# ------------------------------------------------------------ phase 7, LRN
def lrn_bounds(m, c, esz, n):
    """Least ms of the LRN forward and backward on [m, C] with elements of
    ``esz`` bytes: each tensor read or written once, or the kernels'
    float32 operations (the window's 2n+1 products and sums, the power
    and the scaling: 2(2h+1) + 6 forward, 3(2h+1) + 14 backward) at the
    float32 rate whatever x's type, whichever is larger."""
    out = {}
    for kind in ("fwd", "bwd"):
        ops, nbytes = lrn.work(m * c, esz, n, kind)
        out[kind] = _bound(nbytes, ops, torch.float32)
    return out


def lrn_library(x, gy, shape, prm, ry, flush, iters=30):
    """The yardstick the port never calls: ({"fwd", "bwd"} ms, error of
    its forward against ``ry``) of ``F.local_response_norm`` on the NCHW
    tensor (its own layout), alpha times n (it divides by the window);
    its window is asymmetric for an even n, so (None, None) there."""
    n, (b, h, w, c) = prm["n"], shape
    if n % 2 == 0:
        return {"fwd": None, "bwd": None}, None
    x4 = x.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
    g4 = gy.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
    xl = x4.requires_grad_()
    lib = lambda: F.local_response_norm(
        xl, n, alpha=prm["alpha"] * n, beta=prm["beta"], k=prm["k"])
    out = lib()
    err = _scaled_err(out.permute(0, 2, 3, 1).reshape(-1, c), ry)
    return {"fwd": time_ms(lib, flush, iters=iters),
            "bwd": time_ms(lambda: torch.autograd.grad(
                out, xl, g4, retain_graph=True), flush, iters=iters)}, err


def lrn_case(name, seed, shape, dtype, n, want_route, flush, name_card):
    """The two LRN kernels on one NHWC shape, as [N·H·W, C], on the route
    the case names.  x is wide enough (std 30) that the window term moves
    s by a fifth at alpha 1e-4."""
    b, h, w, c = shape
    m = b * h * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, c, generator=g, device="cuda") * 30).to(dtype)
    gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
    prm = dict(LRN, n=n)
    route = lrn.route(x, n, gy)
    check(route == want_route, f"lrn[{name}] takes the {route} route, "
                               f"expected {want_route}")
    y = lrn.lrn_fwd_2d(x, **prm)
    dx = lrn.lrn_bwd_2d(x, gy, **prm)
    ry = lrn.lrn_fwd_plain(x, **prm)
    rdx = lrn.lrn_bwd_plain(x, gy, **prm)
    torch.cuda.synchronize()
    errs = {"fwd": _scaled_err(y, ry), "bwd": _scaled_err(dx, rdx)}
    abs_errs = {"fwd": _abs_err(y, ry), "bwd": _abs_err(dx, rdx)}
    for k, err in errs.items():
        check(err <= TOL[dtype], f"lrn[{name}] {k}: kernel vs plain {err} > "
                                 f"{TOL[dtype]}")
    del y, dx, rdx
    calls = {
        "fwd": (lambda: lrn.lrn_fwd_2d(x, **prm),
                lambda: lrn.lrn_fwd_plain(x, **prm)),
        "bwd": (lambda: lrn.lrn_bwd_2d(x, gy, **prm),
                lambda: lrn.lrn_bwd_plain(x, gy, **prm)),
    }
    ms = {k: time_ms(kern, flush) for k, (kern, _) in calls.items()}
    plain_ms = {k: time_ms(plain, flush, iters=KERNEL_ITERS)
                for k, (_, plain) in calls.items()}

    lib_ms, lib_err = lrn_library(x, gy, shape, prm, ry, flush)
    del ry
    torch.cuda.empty_cache()

    bounds = lrn_bounds(m, c, x.element_size(), n)
    lib_txt = ("n/a (even n)" if lib_err is None else f"{lib_err:.3e}")
    print(f"lrn[{name}] [{m}, {c}] {str(dtype)[6:]} n={n}, {route} route: "
          f"err fwd "
          f"{errs['fwd']:.3e}, bwd {errs['bwd']:.3e} (scaled by max abs; "
          f"tol {TOL[dtype]:g}); F.local_response_norm fwd err {lib_txt} "
          f"[{name_card}]")
    print(f"lrn[{name}] " + "; ".join(
        f"{k} {ms[k]:.4f} ms (bound {bounds[k][0]:.5f} ms, {bounds[k][1]}; "
        f"plain {plain_ms[k]:.4f} ms, F.local_response_norm "
        + ("n/a" if lib_ms[k] is None else f"{lib_ms[k]:.4f} ms") + ")"
        for k in ("fwd", "bwd")) + f" [{name_card}]")
    return {k: dict(err=abs_errs[k], ms=ms[k], plain_ms=plain_ms[k],
                    lib_ms=lib_ms[k], bound=bounds[k]) for k in ms}


def lrn_kernel_phase(flush, name_card):
    return {name: lrn_case(name, 500 + 10 * i, shape, dtype, n, route,
                           flush, name_card)
            for i, (name, shape, dtype, n, route) in enumerate(LRN_CASES)}


# -------------------------------------------------- phase 8, AlexNet
def _sequential_flops(net, batch) -> int:
    """Multiply-adds x 2 of every convolution and dense layer of the
    forward, from the shapes the config infers."""
    t, total = net.conf.input_type, 0
    for i, layer in enumerate(net.layers):
        if i in net.conf.preprocessors:
            t = net.conf.preprocessors[i].output_type(t)
        out = layer.output_type(t)
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            total += (2 * out.height * out.width * out.channels * kh * kw
                      * layer.n_in)
        elif isinstance(layer, DenseLayer):
            total += 2 * layer.n_in * layer.n_out
        t = out
    return total * batch


def lrn_layer_split(events, label, prof):
    """Print the first profiled AlexNet step's LRN kernels by layer, from
    the trace's launch order: the forward runs lrn1 then lrn2, the
    backward lrn2 then lrn1.  Returns the launches (forward, backward)
    over the profiled steps."""
    runs = sorted((e for e in prof.events() if e.self_device_time_total > 0
                   and re.search(LRN_STEP_KERNEL_RE, e.name)),
                  key=lambda e: e.time_range.start)
    fwd = [e.self_device_time_total / 1e3 for e in runs if "fwd" in e.name]
    bwd = [e.self_device_time_total / 1e3 for e in runs if "bwd" in e.name]
    want = ALEXNET_LRN_LAYERS * PROFILED_FIT_STEPS
    check(len(fwd) == len(bwd) == want,
          f"{label} launches by direction {len(fwd)}, {len(bwd)} == {want}")
    print(f"  {label} by layer: " + "; ".join(
        f"lrn{i + 1} fwd {fwd[i]:.4f} ms, bwd "
        f"{bwd[ALEXNET_LRN_LAYERS - 1 - i]:.4f} ms"
        for i in range(ALEXNET_LRN_LAYERS)))
    return len(fwd), len(bwd)


def _lrn_counts():
    return (lrn.fwd_counts, lrn.bwd_counts)


def alexnet_phase(name_card):
    net = alexnet(device="cuda", **ALEXNET)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(ALEXNET_BATCH, 224, 224, 3).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rs.randint(0, 1000, ALEXNET_BATCH)], device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(net.params))
    print(f"alexnet: {n_params} params, {ALEXNET_LRN_LAYERS} LRN layers, "
          f"batch {ALEXNET_BATCH}x224x224x3 bf16")
    check(n_params == 50844008, f"alexnet params {n_params}")

    # output() through the forward kernel: eagerly, then captured
    eager = twin(net, False)
    for c in _lrn_counts():
        c.reset()
    probs = eager.output(x)
    torch.cuda.synchronize()
    out_launches = [c.launches for c in _lrn_counts()]
    plain = [c.plain_calls for c in _lrn_counts()]
    print(f"alexnet output [eager]: LRN launches (forward, backward) "
          f"{out_launches}, plain-version calls {plain}")
    check(out_launches == [ALEXNET_LRN_LAYERS, 0],
          f"output launches {out_launches}")
    check(plain == [0, 0], f"output plain-version calls {plain}")
    check(tuple(probs.shape) == (ALEXNET_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and (probs.sum(-1) - 1).abs().max().item() < 1e-3,
          "output: finite probabilities of shape [128, 1000]")
    cap_probs = [net.output(x), net.output(x)]
    check(all(torch.equal(p, probs) for p in cap_probs)
          and net._step_graphs.captures == 1,
          "alexnet output: captured == eager bit for bit, one capture")
    output_profile("alexnet [eager]", lambda: eager.output(x),
                   r"\blrn_fwd_vec\b", "LRN", name_card, ALEXNET_LRN_LAYERS)
    output_profile("alexnet [captured]", lambda: net.output(x),
                   r"\blrn_fwd_vec\b", "LRN", name_card, ALEXNET_LRN_LAYERS)
    del eager, cap_probs

    def logits(helpers_on):
        helpers.enable_helpers(helpers_on)
        try:
            with torch.no_grad():
                pre, _, _ = net._forward(net.params, x)
        finally:
            helpers.enable_helpers(True)
        return pre.float()

    # bfloat16: at initialisation the logits are small (max about 0.2)
    # and close together, and the built-in path rounds every LRN step to
    # bfloat16 (2 + alpha * sum loses the window term), so an image whose
    # top two logits lie within the paths' difference may flip: such a
    # near-tie is counted apart.  float32 compute holds the argmax itself.
    k_logits, b_logits = logits(True), logits(False)
    err = _scaled_err(k_logits, b_logits)
    diff = (k_logits - b_logits).abs().max().item()
    kcls, bcls = k_logits.argmax(-1), b_logits.argmax(-1)
    agree = (kcls == bcls).sum().item()
    gap = b_logits.max(-1).values - b_logits.gather(1, kcls[:, None])[:, 0]
    ties = ((kcls != bcls) & (gap <= diff)).sum().item()
    bf16_conf = net.conf
    net.conf = dataclasses.replace(bf16_conf, compute_dtype=None)
    try:
        k32, b32 = logits(True), logits(False)
    finally:
        net.conf = bf16_conf
    err32 = _scaled_err(k32, b32)
    agree32 = (k32.argmax(-1) == b32.argmax(-1)).sum().item()
    print(f"alexnet logits, kernels vs built-in path: bfloat16 max abs err "
          f"{diff:.3e} over max |logit| {b_logits.abs().max().item():.3f} = "
          f"{err:.3e} (tol {ALEXNET_LOGITS_TOL}), argmax agrees on "
          f"{agree}/{ALEXNET_BATCH} and {ties} more are near-ties (top-two "
          f"gap <= {diff:.3e}); float32 {err32:.3e} (tol "
          f"{TOL[torch.float32]:g}), argmax agrees on {agree32}/"
          f"{ALEXNET_BATCH} (at least "
          f"{ALEXNET_BATCH - ALEXNET_ARGMAX_MISSES} each); bfloat16 against "
          f"float32: kernels {_scaled_err(k_logits, k32):.3e}, built-in "
          f"{_scaled_err(b_logits, b32):.3e}")
    check(err <= ALEXNET_LOGITS_TOL, f"alexnet logits {err}")
    check(agree + ties >= ALEXNET_BATCH - ALEXNET_ARGMAX_MISSES,
          f"alexnet bf16 argmax agrees on {agree}/{ALEXNET_BATCH}, {ties} "
          "near-ties")
    check(err32 <= TOL[torch.float32], f"alexnet float32 logits {err32}")
    check(agree32 >= ALEXNET_BATCH - ALEXNET_ARGMAX_MISSES,
          f"alexnet float32 argmax agrees on {agree32}/{ALEXNET_BATCH}")
    del k_logits, b_logits, k32, b32, probs

    # one dropout key for both paths: its masks are drawn from the key's
    # seed on the card, and LRN draws nothing, so the paths drop the same
    # units
    key = torch.Generator().manual_seed(2024)

    def loss_of(params):
        return net._loss_fn(params, x, y, key)

    with torch.no_grad():
        k_loss = float(loss_of(net.params)[0])
        helpers.enable_helpers(False)
        try:
            b_loss = float(loss_of(net.params)[0])
        finally:
            helpers.enable_helpers(True)
    loss_rel = abs(k_loss - b_loss) / abs(b_loss)
    print(f"alexnet: first-step loss in bfloat16, kernels {k_loss:.6f} vs "
          f"built-in {b_loss:.6f} (rel {loss_rel:.3e}, tol {LOSS_RTOL})")
    check(loss_rel <= LOSS_RTOL, f"alexnet bf16 first-step loss {loss_rel}")
    net.conf = dataclasses.replace(bf16_conf, compute_dtype=None)
    try:
        first_step_check("alexnet (float32)", net, loss_of, floor=True)
    finally:
        net.conf = bf16_conf

    fwd_flops = _sequential_flops(net, ALEXNET_BATCH)
    lrn_elems = [ALEXNET_BATCH * 54 * 54 * 96, ALEXNET_BATCH * 26 * 26 * 256]
    lrn_bytes = 5 * sum(lrn_elems) * 2
    print(f"alexnet LRN: {sum(lrn_elems)} input elements over the 2 layers; "
          f"least bytes a train step {lrn_bytes / 1e9:.3f} GB = "
          f"{lrn_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")

    dropout_masks(net, name_card)
    per_step = {"lrn_fwd": ALEXNET_LRN_LAYERS, "lrn_bwd": ALEXNET_LRN_LAYERS}
    eager, rows = fit_modes("alexnet train", net, [(x, y)], per_step,
                            name_card, items=ALEXNET_BATCH,
                            flops=3.0 * fwd_flops,
                            peak=PEAK_OPS[torch.bfloat16])
    step_profile("alexnet [eager]", eager, x, y, LRN_STEP_KERNEL_RE, "LRN",
                 name_card, split=lrn_layer_split,
                 launches=2 * ALEXNET_LRN_LAYERS)
    return step_profile("alexnet [captured]", net, x, y, LRN_STEP_KERNEL_RE,
                        "LRN", name_card, split=lrn_layer_split,
                        launches=2 * ALEXNET_LRN_LAYERS)


def dropout_masks(net, name_card):
    """AlexNet's two dropout masks as a train step draws them: the layer
    keys split from the step's device key, each mask counter-based on
    the card.  Drawn in a captured graph that reads a static key, as the
    train graph does: for two steps' keys from the net's key stream, the
    replayed masks equal the eager draws from host keys of the same
    seeds, and the two steps' masks differ.  Prints what the draw costs
    a step on the card (CUDA events)."""
    from deeplearning4j_tpu_torch.backend import rng as rng_mod
    from deeplearning4j_tpu_torch.backend.device import (
        capture_graph, warm_on_side_stream,
    )

    drops = [(i, l) for i, l in enumerate(net.layers) if l.dropout > 0.0]
    n = len(net.layers)
    key = torch.zeros((), dtype=torch.int64, device="cuda")

    def draw():
        keys = rng_mod.split(key, n)
        return [rng_mod.bernoulli(keys[i], 1.0 - l.dropout,
                                  (ALEXNET_BATCH, l.n_in), "cuda")
                for i, l in drops]

    warm_on_side_stream(draw, torch.device("cuda"))
    graph, masks = capture_graph(draw)
    stream = twin(net, False)._keys      # the net's next step keys
    seeds = [rng_mod.seed_of(stream.next()) for _ in range(2)]
    drawn = []
    for seed in seeds:
        key.fill_(seed)
        graph.replay()
        host = rng_mod.split(torch.Generator().manual_seed(seed), n)
        want = [rng_mod.bernoulli(host[i], 1.0 - l.dropout,
                                  (ALEXNET_BATCH, l.n_in), "cuda")
                for i, l in drops]
        check(all(torch.equal(m, w) for m, w in zip(masks, want)),
              "alexnet: the captured masks equal the eager ones")
        drawn.append([m.clone() for m in masks])
    check(all(not torch.equal(a, b) for a, b in zip(*drawn)),
          "alexnet: two steps' masks differ")
    keep = [m.float().mean().item() for m in drawn[0]]
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    graph.replay()
    s.record()
    for _ in range(KERNEL_ITERS):
        graph.replay()
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / KERNEL_ITERS
    print(f"alexnet dropout: masks {[(ALEXNET_BATCH, l.n_in) for _, l in drops]}"
          f" of step keys {seeds}: captured == eager, the two steps differ; "
          f"keep rates {[round(k, 4) for k in keep]}; the counter-based "
          f"draw of both masks (key split included) {ms:.4f} ms a step "
          f"[{name_card}]")
    del graph, masks, drawn


def lenet_phase(name_card):
    """LeNet (zoo ``lenet``: MNIST-shaped 784 inputs, 10 classes, float32,
    Nesterov at 0.01, l2 5e-4) at batch 128 on ``RandomState(0)`` host
    batches, the dispatch-bound configuration the reference's
    ``fit_scanned`` was written for: 7 ``fit`` steps captured and eager
    (``fit_modes``); then three passes over 24 batches by eager ``fit``,
    captured ``fit`` and ``fit_scanned(scan_steps=8)`` from one state,
    the third pass timed: ms a step for each, and ``fit_scanned``'s
    params, updater state and loss equal captured ``fit``'s bit for
    bit."""
    net = lenet(device="cuda")
    rs = np.random.RandomState(0)
    batches = [(rs.rand(LENET_BATCH, 784).astype(np.float32),
                np.eye(10, dtype=np.float32)[rs.randint(0, 10, LENET_BATCH)])
               for _ in range(LENET_BATCHES)]
    flops = 3.0 * _sequential_flops(net, LENET_BATCH)
    print(f"lenet: {net.num_params()} params, batch {LENET_BATCH}x784 "
          f"float32, {LENET_BATCHES} host batches")
    base = twin(net, True)
    _, rows = fit_modes("lenet train", net, batches, {}, name_card,
                        items=LENET_BATCH, flops=flops,
                        peak=PEAK_OPS[torch.float32])
    # where cuDNN's choices differ run to run, the comparison of
    # fit_scanned with fit runs deterministic, as fit_modes' did
    exact = rows["agree"] == "bit for bit"
    torch.backends.cudnn.deterministic = not exact
    eager, fitted, scanned = (twin(base, False), twin(base, True),
                              twin(base, True))
    del base

    def per_batch(n):
        for x, y in batches:
            n.fit(x, y)

    runs = {"eager fit": (eager, lambda: per_batch(eager)),
            "captured fit": (fitted, lambda: per_batch(fitted)),
            "fit_scanned": (scanned, lambda: scanned.fit_scanned(
                batches, scan_steps=LENET_SCAN))}
    ms, passes = {}, 3
    try:
        for label, (n, run) in runs.items():
            # two passes first: the capture, and every slot of the pinned
            # ring allocated
            for _ in range(passes - 1):
                run()
            float(n.score_value)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            float(n.score_value)
            ms[label] = (time.perf_counter() - t0) * 1e3 / LENET_BATCHES
    finally:
        torch.backends.cudnn.deterministic = False
    gaps = state_gaps(scanned, fitted)
    print(f"lenet: ms a step over {LENET_BATCHES} batches (third pass"
          f"{'' if exact else ', cudnn.deterministic'}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; fit_scanned against captured fit: {len(gaps)} leaves "
          f"differ, losses {scanned.score_value} vs {fitted.score_value}; "
          f"captures {scanned._step_graphs.captures}, replays "
          f"{scanned._step_graphs.replays} [{name_card}]")
    check(scanned.iteration == fitted.iteration == passes * LENET_BATCHES,
          "lenet: iterations")
    check(not gaps and scanned.score_value == fitted.score_value,
          f"lenet: fit_scanned == fit bit for bit ({sorted(gaps)[:4]})")
    check(scanned._step_graphs.captures == 1, "lenet: one capture")
    return ms, exact


def _lstm_batch(rs, t):
    """``bench.py:379-382``'s batch: random characters, one-hot, labels
    the next character (the sequence rolled by one), on the card."""
    vocab = LSTM_MODEL["vocab_size"]
    ids = rs.randint(0, vocab, (LSTM_BATCH, t))
    eye = np.eye(vocab, dtype=np.float32)
    return (torch.as_tensor(eye[ids], device="cuda"),
            torch.as_tensor(eye[np.roll(ids, -1, 1)], device="cuda"))


def _cpu_twin(net):
    """``net``'s weights in a CPU network of the same configuration."""
    tree = {k: {n: p.cpu().numpy() for n, p in v.items()}
            for k, v in net.params.items()}
    if isinstance(net, ComputationGraph):
        return graph_params_from_numpy(net.conf, tree, device="cpu")
    return params_from_numpy(net.conf, tree, device="cpu")


def lstm_first_step(net, x, y):
    """The first step's loss and per-layer gradients on the card against
    the CPU's plain path on the same weights and batch (float32, full
    float32 matmuls on both)."""
    cpu = _cpu_twin(net)
    c_loss, c_grads = _loss_and_grads(
        net, lambda params: net._loss_fn(params, x, y, None))
    h_loss, h_grads = _loss_and_grads(
        cpu, lambda params: cpu._loss_fn(params, x.cpu(), y.cpu(), None))
    loss_rel = abs(c_loss - h_loss) / abs(h_loss)
    grad_rel = _rel_l2({k: g.cpu() for k, g in c_grads.items()}, h_grads)
    print(f"lstm: first-step loss card {c_loss:.7f} vs CPU {h_loss:.7f} "
          f"(rel {loss_rel:.3e}, tol {LSTM_LOSS_RTOL}); per-layer gradient "
          f"rel L2 {', '.join(f'{k} {v:.3e}' for k, v in grad_rel.items())}"
          f" (tol {LSTM_GRAD_RTOL})")
    check(loss_rel <= LSTM_LOSS_RTOL, f"lstm first-step loss rel {loss_rel}")
    check(all(r <= LSTM_GRAD_RTOL for r in grad_rel.values()),
          f"lstm per-layer gradient rel L2 {grad_rel}")


def lstm_profile(what, net, x, y, name_card):
    """Two profiled steps (host wall, device busy, idle share) and a
    host-traced one (``cudaLaunchKernel`` and ``cudaGraphLaunch``)."""
    ev, wall_ms, busy_ms, _ = _profile_fit(net, x, y)
    print(f"{what} step (profiled, {PROFILED_FIT_STEPS} steps): host wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / PROFILED_FIT_STEPS:.0f} device "
          f"operations a step [{name_card}]")
    n = PROFILED_FIT_STEPS
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  top: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:90]}")
    hev = _host_trace(what, net, x, y, name_card)
    return dict(launches=sum(e.count for e in hev
                             if e.key == "cudaLaunchKernel"),
                graphs=sum(e.count for e in hev
                           if e.key == "cudaGraphLaunch"))


def lstm_tbptt(net, name_card):
    """Two batches of T 210 (windows 50, 50, 50, 50, 10) captured and
    eager from one state: five iterations a batch, two programs (one a
    window length) captured once, equal bit for bit; ms a batch."""
    rs = np.random.RandomState(1)
    batches = [_lstm_batch(rs, LSTM_T_LONG) for _ in range(2)]
    cap, eag = twin(net, True), twin(net, False)
    it0 = cap.iteration
    ms = {}
    for label, n in (("captured", cap), ("eager", eag)):
        for i, (x, y) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n.fit(x, y)
            float(n.score_value)
            ms[(label, i)] = (time.perf_counter() - t0) * 1e3
            check(n.iteration == it0 + 5 * (i + 1),
                  f"lstm tbptt [{label}]: iteration {n.iteration} after "
                  f"batch {i}")
    graphs = cap._step_graphs
    gaps = state_gaps(cap, eag)
    print(f"lstm tbptt: 2 batches of {LSTM_BATCH}x{LSTM_T_LONG}, windows "
          f"of {LSTM_MODEL['tbptt']}: iteration {it0} -> {cap.iteration}; "
          f"captures {graphs.captures}, replays {graphs.replays}; "
          f"captured against eager: {len(gaps)} leaves differ, losses "
          f"{cap.score_value} vs {eag.score_value}; second batch captured "
          f"{ms[('captured', 1)]:.3f} ms, eager {ms[('eager', 1)]:.3f} ms "
          f"(first, with the captures, {ms[('captured', 0)]:.3f}) "
          f"[{name_card}]")
    check(graphs.captures == 2, f"lstm tbptt: two programs captured "
                                f"({graphs.captures})")
    check(not gaps and cap.score_value == eag.score_value,
          f"lstm tbptt: captured == eager bit for bit ({sorted(gaps)[:4]})")


def lstm_stream(net, name_card):
    """``generate`` (the captured loop, (h, c) as graph state) against the
    eager decode function on the card, greedy and sampled, and against
    ``sample_sequence`` (the host loop over ``rnn_time_step``); ms a
    token.  Returns the prompt followed by the greedy ids."""
    b, t, steps = LSTM_STREAMS, LSTM_PROMPT, LSTM_STEPS
    vocab = LSTM_MODEL["vocab_size"]
    prompt = np.random.default_rng(7).integers(0, vocab, (b, t))
    for policy, kw in (("greedy", dict(temperature=0.0)),
                       ("sampled", dict(temperature=0.8, top_k=20,
                                        rng=11))):
        got = generate(net, prompt, steps, **kw)       # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = generate(net, prompt, steps, **kw)
        cap_ms = (time.perf_counter() - t0) * 1e3 / steps
        fn = build_decode_fn(net, steps, one_hot=True, vocab_size=vocab,
                             **{k: v for k, v in kw.items() if k != "rng"})
        noise = (step_noise(kw["rng"], steps, b, vocab, "cuda")
                 if "rng" in kw else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            carries = seed_stream_caches(named_layers_of(net), {}, b, None,
                                         "cuda")
            ids, _ = fn(net.compute_params(), carries,
                        torch.as_tensor(prompt, device="cuda"), noise)
            eager = ids.cpu().numpy()
        eager_ms = (time.perf_counter() - t0) * 1e3 / steps
        loop = sample_sequence(net, prompt, steps, **kw)
        rows = int((loop == got).all(axis=1).sum())
        gen = net._graph_cache[("decode", steps, kw["temperature"],
                                kw.get("top_k"), None, True, vocab, b, t)]
        print(f"lstm generate [{policy}] {b} streams, prompt {t}, {steps} "
              f"steps: captured {cap_ms:.4f} ms a token, eager "
              f"{eager_ms:.4f} ms a token; captured == eager "
              f"{np.array_equal(got, eager)}, == again "
              f"{np.array_equal(got, again)}; sample_sequence: {rows} of "
              f"{b} rows identical; captures {gen.captures}, replays "
              f"{gen.replays} [{name_card}]")
        check(np.array_equal(got, eager) and np.array_equal(got, again),
              f"lstm generate [{policy}]: captured == eager")
        check(gen.captures == 1, f"lstm generate [{policy}]: one capture")
        check(rows >= b - 1, f"lstm generate [{policy}] == sample_sequence "
                             f"in {rows} of {b} rows")
        if policy == "greedy":
            seq = np.concatenate([prompt, got], axis=1)
    return seq


def chunked_against_output(net, ids):
    """``rnn_time_step`` fed ``ids`` (one-hot) in chunks of 16, 1, 47 and
    the rest, against one ``output`` over all of them: the largest
    difference of the probabilities at each timestep."""
    x = np.eye(LSTM_MODEL["vocab_size"], dtype=np.float32)[ids]
    full = net.output(x)
    net.rnn_clear_previous_state()
    parts, at = [], 0
    for n in (16, 1, 47, ids.shape[1] - 64):
        chunk = x[:, at] if n == 1 else x[:, at:at + n]
        o = net.rnn_time_step(chunk)
        parts.append(o[:, None] if o.ndim == 2 else o)
        at += n
    return (torch.cat(parts, 1) - full).abs().amax(dim=(0, 2)).cpu().numpy()


def lstm_graph(name_card):
    """The same model as a ``ComputationGraph`` whose head reads the last
    step (``LastTimeStepVertex``): two ``fit`` steps captured (a capture
    and a replay) and eager, equal bit for bit."""
    vocab, hid = LSTM_MODEL["vocab_size"], LSTM_MODEL["hidden"]
    conf = (NeuralNetConfiguration.builder().seed(12345)
            .updater("rmsprop", learning_rate=0.1).graph().add_inputs("in")
            .add_layer("l0", GravesLSTM(n_in=vocab, n_out=hid), "in")
            .add_layer("l1", GravesLSTM(n_in=hid, n_out=hid), "l0")
            .add_vertex("last", LastTimeStepVertex(), "l1")
            .add_layer("out", OutputLayer(n_in=hid, n_out=vocab), "last")
            .set_outputs("out").build())
    net = ComputationGraph(conf).init(device="cuda")
    x, y = _lstm_batch(np.random.RandomState(2), LSTM_T)
    y = y[:, -1]
    cap, eag = twin(net, True), twin(net, False)
    for _ in range(2):
        cap.fit(x, y)
        eag.fit(x, y)
    gaps = state_gaps(cap, eag)
    print(f"lstm graph (LastTimeStepVertex head): 2 fit steps, captures "
          f"{cap._step_graphs.captures}, replays {cap._step_graphs.replays}"
          f"; captured against eager: {len(gaps)} leaves differ, losses "
          f"{cap.score_value} vs {eag.score_value} [{name_card}]")
    check(cap._step_graphs.captures == 1 and not gaps
          and cap.score_value == eag.score_value,
          f"lstm graph: captured == eager bit for bit ({sorted(gaps)[:4]})")


def lstm_phase(name_card):
    """The GravesLSTM char-LM (``BASELINE.md:31``; zoo
    ``graves_lstm_char_lm``: 2x200, vocab 77, RMSProp at 0.1, TBPTT 50,
    float32) at batch 128, T 50, on ``bench.py``'s batch: the first step
    against the CPU, ``fit_modes``, profiles, TBPTT over T 210,
    streaming and ``generate``, and the graph facade."""
    t0 = time.perf_counter()
    net = graves_lstm_char_lm(device="cuda", **LSTM_MODEL)
    x, y = _lstm_batch(np.random.RandomState(0), LSTM_T)
    chars = LSTM_BATCH * LSTM_T
    print(f"lstm: {net.num_params()} params, batch {LSTM_BATCH}x{LSTM_T} "
          f"one-hot of {LSTM_MODEL['vocab_size']}, float32, TBPTT "
          f"{LSTM_MODEL['tbptt']}")
    lstm_first_step(net, x, y)
    eager, _ = fit_modes("lstm train", net, [(x, y)], {}, name_card,
                         items=chars, unit="chars",
                         flops=6.0 * _matmul_params(net) * chars,
                         peak=PEAK_OPS[torch.float32])
    prof = {label: lstm_profile(f"lstm train [{label}]", n, x, y, name_card)
            for label, n in (("eager", eager), ("captured", net))}
    print(f"lstm train: cudaLaunchKernel a step, eager "
          f"{prof['eager']['launches']} against captured "
          f"{prof['captured']['launches']} and "
          f"{prof['captured']['graphs']} cudaGraphLaunch [{name_card}]")
    check(prof["captured"]["graphs"] == 1, "lstm: one graph launch a step")
    del eager
    lstm_tbptt(net, name_card)
    ids = lstm_stream(net, name_card)
    # chunked streaming against one output: on the zoo's fresh weights
    # (the same seed) within the tolerance; on the weights trained above
    # (RMSProp at 0.1 drove the loss from 217 to over 1000) printed by
    # timestep, to show how far the recurrence carries a difference
    fresh = graves_lstm_char_lm(device="cuda", **LSTM_MODEL)
    diff = chunked_against_output(fresh, ids)
    trained = chunked_against_output(net, ids)
    steps = [0, 15, 16, 17, 63, 64, 127]
    print(f"lstm rnn_time_step in chunks of 16, 1, 47, {ids.shape[1] - 64} "
          f"against one output over {ids.shape[1]} steps: fresh weights "
          f"max_abs_diff {diff.max():.3e} (tol {LSTM_STREAM_TOL}); trained "
          f"weights by step " + ", ".join(f"{i}: {trained[i]:.3e}"
                                          for i in steps))
    check(diff.max() <= LSTM_STREAM_TOL,
          f"lstm chunked rnn_time_step {diff.max()}")
    del net, fresh
    torch.cuda.empty_cache()
    lstm_graph(name_card)
    print(f"lstm phase: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------ the HTTP server, guard, resume
# the server phase's traffic: generate clients, requests each, prompt
# and new tokens (three in four streamed), predict clients and requests
SERVER_GEN_CLIENTS, SERVER_GEN_PER = 16, 4
SERVER_PROMPT, SERVER_NEW = 16, 64
SERVER_PRED_CLIENTS, SERVER_PRED_PER = 4, 20
# guard: ResNet-50 steps under dynamic scaling, the poisoned ones, and
# the float16 char-LM's scale walk (from 2^32, beyond float16's range)
GUARD_STEPS, GUARD_POISON, GUARD_CHECK = 8, {3: "nan", 5: "inf"}, 2
WALK_STEPS = 10
WALK = dict(loss_scaling="dynamic", loss_scale=2.0 ** 32,
            loss_scale_max=2.0 ** 32, loss_scale_factor=16.0,
            loss_scale_growth_interval=2, check_every=WALK_STEPS)
# resume: ResNet-50 steps, a save every 2 (async), the fatal fault, the
# transient one, and the preemption (before the fourth step)
RESUME_STEPS, RESUME_EVERY = 6, 2
RESUME_FATAL, RESUME_TRANSIENT, RESUME_PREEMPT = 3, 4, 3


def profiled_counts(fn, patterns):
    """``fn()`` under ``torch.profiler``: (its result, {name: launches of
    the kernels matching ``patterns[name]``}, the events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    return out, {k: sum(e.count for e in ev if re.search(p, e.key))
                 for k, p in patterns.items()}, ev


def _pcts(vals):
    return (float(np.percentile(vals, 50)) * 1e3,
            float(np.percentile(vals, 99)) * 1e3)


def _http_json(port, method, path, body=None, timeout=600):
    """(status, parsed JSON or None, raw bytes) of one request."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            obj = json.loads(raw)
        except ValueError:
            obj = None
        return resp.status, obj, raw
    finally:
        conn.close()


def _http_stream(port, body, timeout=600, on_event=None):
    """POST /generate with ``stream: true``: (status, [(arrival time,
    event)], send time), reading the SSE events as they come;
    ``on_event(event)`` sees each one as it arrives."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        events = []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                events.append((time.perf_counter(), json.loads(line[6:])))
                if on_event is not None:
                    on_event(events[-1][1])
                if events[-1][1].get("done"):
                    break
        return resp.status, events, t0
    finally:
        conn.close()


def server_phase(name_card):
    """The port's ``InferenceServer`` on localhost over a ``ServingEngine``
    (ResNet-50 bf16 ``output``, bench_serving's policy) and a
    ``GenerationEngine`` (the char-LM, the engine phase's geometry, the
    prefix cache on): concurrent ``/generate`` (greedy, three in four
    streamed as SSE) and ``/predict`` clients, a hot swap of the ResNet
    over HTTP and its rollback, and scrapes of every GET endpoint
    throughout.  Returns the profiled window's launches (paged decode,
    prologue, BatchNorm inference)."""
    import tempfile

    from deeplearning4j_tpu_torch.models import serialization
    from deeplearning4j_tpu_torch.serving import BucketPolicy, ServingEngine
    from deeplearning4j_tpu_torch.streaming import (
        InferenceServer, array_to_base64, base64_to_array,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    zip_path = f"{tmp.name}/resnet50_v2.zip"
    net2 = resnet50(device="cuda", **{**RESNET, "seed": SWAP_SEED})
    net2.save(zip_path, save_updater=False)
    net = resnet50(device="cuda", **RESNET)
    lm = transformer_char_lm(device="cuda", **MODEL)
    example = np.zeros(SERVE_ROW, np.float32)
    eng = ServingEngine(net, policy=BucketPolicy(max_batch=SERVE_MAX_BATCH),
                        max_wait_ms=1.0, max_queue=4096, example=example,
                        default_model="resnet50")
    gen = GenerationEngine(lm, **ENGINE, max_queue=256, prefix_cache=True)
    server = InferenceServer(engine=eng, generation=gen, device="cuda")
    try:
        eng.start()
        gen.start()
        port = server.start()
        mv1 = eng.models.active("resnet50")
        buckets = len(eng.policy.batch_buckets)
        caps = net._step_graphs.captures
        gen_caps = gen.programs.captures
        want = len(ENGINE["prefill_buckets"]) + 1
        print(f"server: warm-up {time.perf_counter() - t_phase:.2f} s (the "
              f"v2 zip included); ResNet-50 captures {caps}, generation "
              f"captures {gen_caps}")
        check(caps == buckets and gen_caps == want,
              "server: one capture a bucket and a program at warm-up")

        # the clients' requests, made before the clock starts
        rs = np.random.RandomState(15)
        prompts = [[rs.randint(0, MODEL["vocab_size"], SERVER_PROMPT)
                    .tolist() for _ in range(SERVER_GEN_PER)]
                   for _ in range(SERVER_GEN_CLIENTS)]
        feats = []
        for c in range(SERVER_PRED_CLIENTS):
            r = np.random.RandomState(3000 + c)
            feats.append([r.rand(1 + r.randint(16), *SERVE_ROW).astype(
                np.float32) for _ in range(SERVER_PRED_PER)])
        gens, preds, scrapes, errors = [], [], [], []
        swap = {}
        lock = threading.Lock()
        stop = threading.Event()

        def gen_client(c):
            try:
                for i, p in enumerate(prompts[c]):
                    body = {"prompt": p, "max_tokens": SERVER_NEW}
                    if i % 4 != 3:
                        status, events, t0 = _http_stream(
                            port, {**body, "stream": True})
                        check(status == 200, f"SSE status {status}")
                        done = events[-1][1]
                        check(done.get("done") and "error" not in done,
                              f"SSE stream ended {done}")
                        toks = [e["token"] for _, e in events[:-1]]
                        with lock:
                            gens.append(dict(
                                prompt=p, tokens=toks, t0=t0,
                                times=[t for t, _ in events[:-1]],
                                ttft_ms=done["ttft_ms"]))
                    else:
                        status, obj, raw = _http_json(
                            port, "POST", "/generate", body)
                        check(status == 200, f"generate {status} {raw!r}")
                        with lock:
                            gens.append(dict(prompt=p, tokens=obj["tokens"],
                                             ttft_ms=obj["ttft_ms"]))
            except Exception as e:          # reported below
                errors.append(("generate", e))

        def pred_client(c):
            try:
                for i, x in enumerate(feats[c]):
                    t0 = time.perf_counter()
                    status, obj, raw = _http_json(
                        port, "POST", "/predict", array_to_base64(x))
                    dt = time.perf_counter() - t0
                    check(status == 200, f"predict {status} {raw[:200]!r}")
                    with lock:
                        preds.append(dict(x=x, out=base64_to_array(obj),
                                          t0=t0, dt=dt))
            except Exception as e:          # reported below
                errors.append(("predict", e))

        def scraper():
            paths = ["/metrics", "/health", "/healthz", "/models",
                     "/generation/cache"]
            try:
                while not stop.is_set():
                    for path in paths:
                        status, obj, raw = _http_json(port, "GET", path)
                        with lock:
                            scrapes.append((path, status, obj))
                    time.sleep(0.05)
            except Exception as e:          # reported below
                errors.append(("scrape", e))

        def swapper():
            try:
                time.sleep(0.3)
                swap["t0"] = time.perf_counter()
                status, obj, raw = _http_json(
                    port, "POST", "/models/resnet50",
                    {"path": zip_path, "retain_old": True})
                swap["t1"] = time.perf_counter()
                check(status == 200, f"swap {status} {raw!r}")
                swap["mv2"] = eng.models.active("resnet50")
                swap["swap"] = obj
                time.sleep(0.5)
                status, obj, raw = _http_json(
                    port, "POST", "/models/resnet50/rollback", {})
                swap["t2"] = time.perf_counter()
                check(status == 200, f"rollback {status} {raw!r}")
                swap["rollback"] = obj
            except Exception as e:          # reported below
                errors.append(("swap", e))

        threads = ([threading.Thread(target=gen_client, args=(c,))
                    for c in range(SERVER_GEN_CLIENTS)]
                   + [threading.Thread(target=pred_client, args=(c,))
                      for c in range(SERVER_PRED_CLIENTS)]
                   + [threading.Thread(target=swapper)])
        scrape_th = threading.Thread(target=scraper)
        t0 = time.perf_counter()
        scrape_th.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        stop.set()
        scrape_th.join(60)
        wall = time.perf_counter() - t0
        check(not errors and not any(th.is_alive() for th in threads),
              f"server: failed requests {errors!r}")
        n_gen = SERVER_GEN_CLIENTS * SERVER_GEN_PER
        check(len(gens) == n_gen and len(preds) == SERVER_PRED_CLIENTS
              * SERVER_PRED_PER, "server: every request answered")
        check(all(len(g["tokens"]) == SERVER_NEW for g in gens),
              f"server: every /generate returns {SERVER_NEW} tokens")
        bad = [(p, s) for p, s, o in scrapes
               if s != 200 and not (p == "/health" and s == 503
                                    and o is not None
                                    and o.get("healthy") is False)]
        unhealthy = sum(1 for p, s, _ in scrapes
                        if p == "/health" and s != 200)
        check(not bad, f"server: scrapes failed {bad[:4]}")
        print(f"server: {n_gen} /generate ({sum('times' in g for g in gens)}"
              f" streamed) and {len(preds)} /predict requests in "
              f"{wall:.2f} s, none failed; {len(scrapes)} scrapes of the "
              f"GET endpoints ({unhealthy} /health answers unhealthy)")

        # captures: only the swap's own buckets; the rollback none
        mv2 = swap["mv2"]
        print(f"server: swap {swap['swap']} in "
              f"{(swap['t1'] - swap['t0']) * 1e3:.1f} ms (v2 captures "
              f"{mv2.detector.compile_count}); rollback "
              f"{swap['rollback']} in "
              f"{(swap['t2'] - swap['t1']) * 1e3 - 500:.1f} ms after the "
              f"0.5 s hold")
        check(mv2.detector.compile_count == buckets,
              f"server: the swap captured one graph a bucket "
              f"({mv2.detector.compile_count})")
        check(eng.models.active("resnet50") is mv1
              and net._step_graphs.captures == caps
              and mv1.detector.compile_count == buckets,
              "server: nothing captured after warm-up but the swap's; the "
              "rollback serves the retained graphs")
        check(gen.programs.captures == gen_caps,
              f"server: generation captured nothing after warm-up "
              f"({gen.programs.captures})")

        # latency: HTTP TTFT (send to first SSE event) beside the
        # engine's own, the SSE inter-event gaps, the longest gap during
        # the swap, /predict rows/s
        streamed = [g for g in gens if "times" in g]
        http_ttft = [g["times"][0] - g["t0"] for g in streamed]
        eng_ttft = [g["ttft_ms"] / 1e3 for g in gens]
        gaps, swap_gap = [], 0.0
        for g in streamed:
            ts = g["times"]
            for a, b in zip(ts, ts[1:]):
                gaps.append(b - a)
                if a < swap["t1"] and b > swap["t0"]:
                    swap_gap = max(swap_gap, b - a)
        rows = sum(len(p["x"]) for p in preds)
        p_wall = (max(p["t0"] + p["dt"] for p in preds)
                  - min(p["t0"] for p in preds))
        lat = [p["dt"] for p in preds]
        print(f"server: HTTP TTFT p50 {_pcts(http_ttft)[0]:.3f} ms, p99 "
              f"{_pcts(http_ttft)[1]:.3f} ms (streamed, send to first "
              f"event) vs the engine's ttft_s p50 {_pcts(eng_ttft)[0]:.3f}"
              f" ms, p99 {_pcts(eng_ttft)[1]:.3f} ms; SSE inter-event p50 "
              f"{_pcts(gaps)[0]:.3f} ms, p99 {_pcts(gaps)[1]:.3f} ms; "
              f"longest gap during the swap {swap_gap * 1e3:.3f} ms "
              f"[{name_card}]")
        print(f"server: /predict {rows} rows in {p_wall:.3f} s: "
              f"{rows / p_wall:.1f} rows/s, latency p50 "
              f"{_pcts(lat)[0]:.3f} ms, p99 {_pcts(lat)[1]:.3f} ms "
              f"[{name_card}]")

        # a profiled window: one streamed /generate and one /predict
        x16 = feats[0][0][:1].repeat(16, axis=0)

        def window():
            status, events, _ = _http_stream(
                port, {"prompt": prompts[0][0], "max_tokens": 8,
                       "stream": True})
            check(status == 200 and events[-1][1].get("done"),
                  "profiled SSE request")
            status, _, _ = _http_json(port, "POST", "/predict",
                                      array_to_base64(x16))
            check(status == 200, "profiled /predict")

        _, counts, ev = profiled_counts(window, {
            "paged": r"paged_decode_kernel", "prologue": r"\bdrn_kernel"})
        counts["bn_inference"] = bn_passes(ev).get("inference", (0, 0))[1]
        print(f"server: a profiled window (one streamed /generate of 8 "
              f"tokens, one 16-row /predict) launches {counts}")
        check(counts["paged"] > 0 and counts["prologue"] > 0
              and counts["bn_inference"] == RESNET_BN_LAYERS,
              f"server: rows 4, 5 and 8 launch ({counts})")
    finally:
        server.stop()
        gen.stop()
        eng.stop()

    # every /generate against engine.generate without HTTP (an engine
    # without the prefix cache: the same cold prefill of each prompt)
    ref_eng = GenerationEngine(lm, **ENGINE, max_queue=256).start()
    try:
        handles = [ref_eng.submit(g["prompt"], SERVER_NEW) for g in gens]
        ref = [h.result(timeout=600) for h in handles]
    finally:
        ref_eng.stop()
    same = sum(g["tokens"] == r for g, r in zip(gens, ref))
    print(f"server: {same} of {len(gens)} /generate results equal "
          f"engine.generate's ids")
    check(same == len(gens), "server: /generate ids == engine.generate")

    # every /predict against the eager forward of the version that
    # served it: argmax, differences only on near-ties
    net2 = serialization.load_model(zip_path, device="cuda")
    misses, ties, by_v2 = 0, 0, 0
    for p in preds:
        x, out = p["x"], p["out"]
        fits = []
        for n in (net, net2):
            with torch.no_grad():
                acts, _, _ = n._forward(n.params, n.net_state, {
                    "input": torch.as_tensor(x, device="cuda")})
            logit = acts["fc"].float().cpu().numpy()
            two = -np.sort(-logit, axis=1)[:, :2]
            near = (two[:, 0] - two[:, 1]) <= RESNET_LOGITS_TOL * np.abs(
                logit).max()
            differ = out.argmax(-1) != logit.argmax(-1)
            fits.append((int((differ & ~near).sum()),
                         int((differ & near).sum())))
        m, t = min(fits)
        by_v2 += int(fits[1] < fits[0])
        misses += m
        ties += t
    print(f"server: /predict argmax vs the eager forward: {misses} "
          f"differences off a near-tie, {ties} on near-ties ({by_v2} "
          f"requests matched the swapped-in version)")
    check(misses == 0, f"server: {misses} argmax differences")
    tmp.cleanup()
    del net, net2, lm
    print(f"server: phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def _stab_of(net, name):
    return float(net.updater_state["__stability__"][name])


def _with_policy(net, capture=True, **policy):
    """A twin of ``net`` under ``training_stability(**policy)`` (none when
    no policy is given)."""
    from deeplearning4j_tpu_torch.nn.conf import TrainingStability

    t = twin(net, capture)
    if policy:
        t.conf = dataclasses.replace(
            net.conf, stability=TrainingStability(**policy).to_dict())
    return t


def _gaps_by_name(a, b):
    """``state_gaps`` of two nets whose trees differ by the guard's state:
    the leaves of ``a`` that ``b`` holds under the same name, and every
    other leaf of either as a gap."""
    nb = dict(named_state(b))
    na = dict(named_state(a))
    gaps = {n: float("inf") for n in set(na) ^ set(nb)
            if "__stability__" not in n}
    gaps.update({n: (x.float() - nb[n].float()).abs().max().item()
                 for n, x in na.items()
                 if n in nb and not torch.equal(x, nb[n])})
    return gaps


def _timed(net, batches, steps):
    _, secs, _ = fit_steps(net, batches, steps)
    return float(np.median(secs[WARM_STEPS:])) * 1e3


def guard_phase(name_card):
    """The in-step guard on the card: (a) poisoned steps on ResNet-50
    under dynamic scaling, bit-exact no-ops in the one train graph; a
    guarded healthy run against an unguarded one; (b) the float16
    char-LM's scale walk from 2^32; the guard's cost on both.  Returns
    the profiled launches of a guarded step of each (flash forward, dQ,
    dK/dV, prologue; BatchNorm's two reductions) and whether ResNet-50's
    runs needed ``cudnn.deterministic`` to agree."""
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, inject_faults,
    )

    t_phase = time.perf_counter()
    base = resnet50(device="cuda", **RESNET)
    rs = np.random.RandomState(0)
    xh = rs.rand(RESNET_BATCH, *SERVE_ROW).astype(np.float32)
    yh = np.eye(SERVE_CLASSES, dtype=np.float32)[
        rs.randint(0, SERVE_CLASSES, RESNET_BATCH)]
    x, y = torch.as_tensor(xh, device="cuda"), torch.as_tensor(
        yh, device="cuda")

    # (a) poisoned steps; host batches, poisoned before staging
    net = _with_policy(base, loss_scaling="dynamic",
                       check_every=GUARD_CHECK)
    inj = FaultInjector()
    for step, mode in GUARD_POISON.items():
        inj.poison_gradients("0", at_step=step, until_step=step + 1,
                             mode=mode)
    scales = []
    # the first sentinel check at or after the last poisoned step (one
    # check each GUARD_CHECK fit calls)
    first_check = next(s for s in range(max(GUARD_POISON), GUARD_STEPS)
                       if (s + 1) % GUARD_CHECK == 0)
    with inject_faults(inj):
        for step in range(GUARD_STEPS):
            poisoned = step in GUARD_POISON
            if poisoned:
                before = [t.clone() for n, t in named_state(net)
                          if "__stability__" not in n]
                s0 = _stab_of(net, "loss_scale")
            net.fit(xh, yh)
            scales.append(_stab_of(net, "loss_scale"))
            if poisoned:
                after = [t for n, t in named_state(net)
                         if "__stability__" not in n]
                same = all(torch.equal(a, b) for a, b in zip(before, after))
                check(same, f"guard: poisoned step {step} wrote state")
                check(scales[-1] == s0 / 2,
                      f"guard: the scale halved at step {step}")
                del before
            if step == first_check:
                got = net._stab_rt._harvested_nonfinite
                print(f"guard: the check after step {step} harvests "
                      f"nonfinite_total {got}")
                check(got == 2.0, f"guard: nonfinite_total reads {got} at "
                                  f"the check after the last poison")
    trains = [k for k in net._step_graphs.programs if k[0] == "train"]
    print(f"guard: ResNet-50 {GUARD_STEPS} steps, poisoned "
          f"{GUARD_POISON}: each a bit-exact no-op; scale {scales}; "
          f"nonfinite_total {_stab_of(net, 'nonfinite_total')}; train "
          f"graphs {len(trains)}, captures {net._step_graphs.captures}")
    check(len(trains) == 1 and net._step_graphs.captures == 1,
          "guard: one train graph")
    check(bool(np.isfinite(net.params_to_vector()).all()),
          "guard: params finite")
    _, counts, ev = profiled_counts(lambda: net.fit(x, y), {})
    split = bn_passes(ev)
    launches = {"bn_train_fwd": split.get("moments", (0, 0))[1],
                "bn_train_bwd": split.get("grad sums", (0, 0))[1]}
    print(f"guard: a profiled guarded ResNet-50 step launches {launches}")
    check(launches["bn_train_fwd"] == RESNET_BN_LAYERS
          and launches["bn_train_bwd"] == RESNET_BN_LAYERS,
          "guard: BatchNorm's reductions in the guarded step")
    del net
    torch.cuda.empty_cache()

    # a guarded healthy run (no scaling) against an unguarded one; the
    # guard's cost: medians of 5 steps after 2 warm-up
    steps = WARM_STEPS + TIMED_STEPS

    def healthy():
        runs = {}
        for label, pol in (("unguarded", {}), ("unguarded again", {}),
                           ("guarded, no scaling",
                            {"loss_scaling": "none", "check_every": 100}),
                           ("guarded, dynamic",
                            {"loss_scaling": "dynamic",
                             "check_every": 100})):
            n = _with_policy(base, **pol)
            ms = _timed(n, [(x, y)], steps)
            runs[label] = (n, ms)
        return runs

    runs = healthy()
    det = "off"
    if state_gaps(runs["unguarded"][0], runs["unguarded again"][0]):
        print("guard: two unguarded ResNet-50 runs differ; again with "
              "cudnn.deterministic")
        det = "on"
        del runs
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = True
        try:
            runs = healthy()
        finally:
            torch.backends.cudnn.deterministic = False
    u, g = runs["unguarded"][0], runs["guarded, no scaling"][0]
    again = not state_gaps(u, runs["unguarded again"][0])
    gaps = _gaps_by_name(u, g)
    print(f"guard: two unguarded ResNet-50 runs agree bit for bit: "
          f"{again} (cudnn.deterministic {det}); the guarded run without "
          f"scaling against the unguarded: {len(gaps)} leaves differ")
    check(again and not gaps, "guard: guarded healthy == unguarded bit "
                              "for bit")
    print("guard: ResNet-50 step median (5 after 2 warm-up): " + ", ".join(
        f"{k} {ms:.3f} ms" for k, (_, ms) in runs.items())
        + f" [{name_card}]")
    del runs, u, g, base
    torch.cuda.empty_cache()

    # (b) the float16 char-LM's scale walk from 2^32
    model = {**TRAIN_MODEL, "compute_dtype": "float16"}
    lm = transformer_char_lm(device="cuda", **model)
    ids = np.random.RandomState(0).randint(0, model["vocab_size"],
                                           (TRAIN_BATCH, TRAIN_T))
    lx = torch.as_tensor(ids, device="cuda")
    ly = torch.as_tensor(np.eye(model["vocab_size"], dtype=np.float32)[
        np.roll(ids, -1, 1)], device="cuda")
    plain = twin(lm, True)
    walk = _with_policy(lm, **WALK)
    scale, streak, nf = WALK["loss_scale"], 0, 0.0
    seq, grew, halved = [], 0, 0   # the scale after each step
    for step in range(WALK_STEPS):
        walk.fit(lx, ly)
        got, nf2 = _stab_of(walk, "loss_scale"), _stab_of(
            walk, "nonfinite_total")
        if nf2 > nf:            # the rule: divide on a non-finite step
            scale, streak = max(scale / WALK["loss_scale_factor"], 1.0), 0
            halved += 1
        else:                   # grow after the interval's finite steps
            streak += 1
            if streak >= WALK["loss_scale_growth_interval"]:
                scale = min(scale * WALK["loss_scale_factor"],
                            WALK["loss_scale_max"])
                streak, grew = 0, grew + 1
        nf = nf2
        seq.append(got)
        check(got == scale, f"walk: step {step} scale {got} != {scale}")
        check(all(bool(torch.isfinite(p).all())
                  for p in tree_leaves(walk.params)),
              f"walk: step {step} wrote a non-finite param")
    print(f"guard: float16 char-LM scale over {WALK_STEPS} steps from "
          f"2^32: {seq}; {halved} non-finite steps "
          f"(scale / {WALK['loss_scale_factor']:.0f}), {grew} growths "
          f"(x{WALK['loss_scale_factor']:.0f} after "
          f"{WALK['loss_scale_growth_interval']} finite steps); params "
          f"finite after every step")
    check(halved >= 1 and grew >= 1,
          "walk: the scale fell until finite and then grew")
    g_ms = _timed(walk, [(lx, ly)], steps)
    p_ms = _timed(plain, [(lx, ly)], steps)
    print(f"guard: float16 char-LM step median (5 after 2 warm-up): "
          f"guarded (dynamic) {g_ms:.3f} ms, unguarded {p_ms:.3f} ms "
          f"[{name_card}]")
    _, lm_counts, _ = profiled_counts(lambda: walk.fit(lx, ly), {
        "flash_fwd": r"flash_fwd_", "flash_dq": r"flash_dq_",
        "flash_dkv": r"flash_dkv_", "prologue": r"\bdrn_kernel"})
    layers = model["layers"]
    print(f"guard: a profiled guarded float16 char-LM step launches "
          f"{lm_counts}")
    check(lm_counts == {"flash_fwd": layers, "flash_dq": layers,
                        "flash_dkv": layers, "prologue": 2 * layers},
          "guard: flash and prologue launches in the guarded step")
    del walk, plain, lm
    torch.cuda.empty_cache()
    print(f"guard: phase {time.perf_counter() - t_phase:.1f} s")
    return {**lm_counts, **launches}, det == "on"


def resume_phase(name_card, deterministic=False):
    """ResNet-50 under a ``CheckpointManager`` (a save every 2 steps,
    async): an uninterrupted run (A); a fatal fault at step 3, resumed
    by a fresh net and, apart, restored into the crashed net's captured
    tensors (B); a transient fault retried (C); a preemption (D); under
    ``cudnn.deterministic`` when the guard phase found two unguarded runs
    apart."""
    import tempfile

    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import snapshot_trees
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, FaultInjector, InjectedFault, PreemptionHandler,
        RetryPolicy, inject_faults,
    )

    t_phase = time.perf_counter()
    base = resnet50(device="cuda", **RESNET)
    g = torch.Generator(device="cuda").manual_seed(6)
    batches = [(torch.rand(RESNET_BATCH, *SERVE_ROW, generator=g,
                           device="cuda"),
                F.one_hot(torch.randint(
                    0, SERVE_CLASSES, (RESNET_BATCH,), generator=g,
                    device="cuda"), SERVE_CLASSES).float())
               for _ in range(RESUME_STEPS)]
    tmp = tempfile.TemporaryDirectory()
    reg = MetricsRegistry()
    torch.backends.cudnn.deterministic = deterministic

    def manager(name):
        return CheckpointManager(f"{tmp.name}/{name}", keep=3,
                                 save_every_steps=RESUME_EVERY,
                                 registry=reg)

    def same(a, b, what):
        gaps = state_gaps(a, b)
        check(not gaps, f"resume: {what} == A bit for bit "
                        f"({sorted(gaps)[:4]})")
        return "bit for bit"

    try:
        cm_a = manager("a")
        a = twin(base, True)
        a.fit(batches, checkpoint_manager=cm_a)
        cm_a.wait_idle()
        check(a.iteration == RESUME_STEPS
              and cm_a.latest_step() == RESUME_STEPS, "resume: A ran")
        t0 = time.perf_counter()
        for _ in range(3):
            snap = snapshot_trees(a)
        snap_ms = (time.perf_counter() - t0) / 3 * 1e3
        nbytes = sum(v.nbytes for v in snap["arrays"].values())
        del snap

        # B: a fatal fault; a fresh net resumes; the crashed net restores
        cm_b = manager("b")
        b = twin(base, True)
        with inject_faults(FaultInjector().fail_at_step(
                RESUME_FATAL, component="ComputationGraph",
                transient=False)):
            try:
                b.fit(batches, checkpoint_manager=cm_b)
                check(False, "resume: B raised")
            except InjectedFault:
                pass
        cm_b.wait_idle()
        latest = cm_b.latest_step()
        check(b.iteration == RESUME_FATAL and latest == RESUME_EVERY,
              f"resume: B stopped at {b.iteration}, latest {latest}")
        fresh = twin(base, True)
        fresh.fit(batches, checkpoint_manager=cm_b)
        check(fresh.iteration == RESUME_STEPS, "resume: B finished")
        b_fresh = same(fresh, a, "B (a fresh net resumed)")
        del fresh
        leaves = [t for _, t in named_state(b)]
        caps = b._step_graphs.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm_b.restore(b, step=RESUME_EVERY)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        in_place = all(x is y for x, (_, y) in zip(leaves, named_state(b)))
        b.fit(batches[RESUME_EVERY:])
        check(b._step_graphs.captures == caps and in_place,
              "resume: the restore wrote into the captured tensors")
        b_live = same(b, a, "B (restored into the crashed net)")
        del b, leaves

        # C: a transient fault, retried with the key stream set back
        c = twin(base, True)
        rp = RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=0.0,
                         registry=reg)
        with inject_faults(FaultInjector().fail_at_step(
                RESUME_TRANSIENT, component="ComputationGraph",
                transient=True)):
            c.fit(batches, retry_policy=rp)
        check(rp.retries == 1 and c.iteration == RESUME_STEPS,
              "resume: C retried once")
        c_same = same(c, a, "C (retried)")
        del c

        # D: a preemption before the fourth step
        cm_d = manager("d")
        d = twin(base, True)
        with PreemptionHandler(cm_d, registry=reg) as handler:
            def stream():
                for i, bt in enumerate(batches):
                    if i == RESUME_PREEMPT:
                        handler.trigger()
                    yield bt

            d.fit(stream(), checkpoint_manager=cm_d)
            check(handler.stop_requested, "resume: D was preempted")
        cm_d.wait_idle()
        commit = cm_d.read_commit(cm_d.latest())
        check(d.iteration == RESUME_PREEMPT
              and cm_d.latest_step() == RESUME_PREEMPT
              and commit["trigger"] in ("priority", "preempt"),
              f"resume: D committed a priority checkpoint at "
              f"{cm_d.latest_step()} ({commit['trigger']})")
        del d
        save = reg.get("dl4j_checkpoint_save_seconds").get()
        print(f"resume: A {RESUME_STEPS} steps; B resumed from step "
              f"{latest}: a fresh net {b_fresh}, the crashed net restored "
              f"in place (its graph kept, no capture) {b_live}; C retried "
              f"step {RESUME_TRANSIENT} once, {c_same}; D stopped at "
              f"{RESUME_PREEMPT} with a {commit['trigger']} commit")
        print(f"resume: snapshot {snap_ms:.3f} ms on the training thread; "
              f"commit {save.sum / save.count * 1e3:.3f} ms mean off it "
              f"({save.count} commits); {nbytes} bytes a save "
              f"({reg.get_value('dl4j_checkpoint_last_bytes'):.0f} on "
              f"disk); restore {restore_ms:.3f} ms [{name_card}]")
        for cm in (cm_a, cm_b, cm_d):
            cm.close()
    finally:
        tmp.cleanup()
        torch.backends.cudnn.deterministic = False
    del a, base
    torch.cuda.empty_cache()
    print(f"resume: phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------ phase 15, online learning
ONLINE_ROWS, ONLINE_WINDOW, ONLINE_HOLDOUT = 16, 4, 64
ONLINE_CLIENTS, ONLINE_MAX_BATCH, ONLINE_GATE = 4, 64, 0.05
ONLINE_CRASH_AT = 1         # the crashed window's step (0-based) that fails
# steps on the held-out images before the loop starts: at Nesterov 0.1 and
# batch 16 the first steps of a random ResNet are unstable and its
# BatchNorm running statistics lag its batch statistics, so a window's
# inference-mode held-out loss only tracks its training after these
ONLINE_PRIME_STEPS = 48
ONLINE_OUTCOMES = ["promoted", "promoted", "rejected", "promoted"]
ONLINE_MEMORY_RTOL = 0.05


def _records(images, labels, ts):
    """One window of ``dataset_to_json`` records of ONLINE_ROWS images."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.streaming import dataset_to_json

    return [dataset_to_json(DataSet(images[i:i + ONLINE_ROWS],
                                    labels[i:i + ONLINE_ROWS]),
                            meta={"ts": ts})
            for i in range(0, len(images), ONLINE_ROWS)]


def online_phase(name_card, deterministic=False):
    """Online learning on the card: a ResNet-50 trainer (full width, bf16,
    Nesterov 0.1, captured ``fit``, ``conf.introspection`` set) trains
    from a ``MessageBroker`` topic in windows of 4 records of 16 images,
    beside a second ResNet-50 ``ServingEngine`` (max batch 64) that 4
    client threads query throughout; each window's candidate walks the
    promotion state machine (``default_gate_rules`` at 5 % over the 64
    held-out images, canary, retaining swap, watch).  Windows: healthy,
    healthy, poisoned (labels moved by one class), and one whose trainer
    crashes at its second step (``resilience.faults``).  Returns the
    kernels' wrapper launches of the phase."""
    import gc
    import tempfile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import TrainingIntrospection
    from deeplearning4j_tpu_torch.observability import (
        MetricsRegistry, introspection,
    )
    from deeplearning4j_tpu_torch.online import (
        OnlineLearningPipeline, PromotionManager, default_gate_rules,
    )
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, FaultInjector, inject_faults,
    )
    from deeplearning4j_tpu_torch.serving import BucketPolicy, ServingEngine
    from deeplearning4j_tpu_torch.streaming import MessageBroker

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = deterministic
    for c in helpers.kernel_counts().values():
        c.reset()
    rs = np.random.RandomState(42)
    images = rs.rand(ONLINE_HOLDOUT, *SERVE_ROW).astype(np.float32)
    classes = rs.randint(0, SERVE_CLASSES, ONLINE_HOLDOUT)
    eye = np.eye(SERVE_CLASSES, dtype=np.float32)
    labels, shifted = eye[classes], eye[(classes + 1) % SERVE_CLASSES]
    holdout = DataSet(images, labels)

    trainer = resnet50(device="cuda", **RESNET)
    trainer.conf = dataclasses.replace(
        trainer.conf, introspection=TrainingIntrospection().to_dict())
    prime = [(images[i:i + ONLINE_ROWS], labels[i:i + ONLINE_ROWS])
             for i in range(0, ONLINE_HOLDOUT, ONLINE_ROWS)]
    trainer.fit(prime * (ONLINE_PRIME_STEPS // len(prime)))
    served = trainer.clone()          # the second ResNet-50, same weights
    print(f"online: trainer primed {trainer.iteration} steps, held-out "
          f"loss {served.score(images, labels):.6f}")
    reg = MetricsRegistry()
    eng = ServingEngine(served, policy=BucketPolicy(
        max_batch=ONLINE_MAX_BATCH), max_wait_ms=1.0, max_queue=4096,
        example=np.zeros(SERVE_ROW, np.float32), registry=reg).start()
    broker = MessageBroker(registry=reg)
    tmp = tempfile.TemporaryDirectory()
    cm = CheckpointManager(f"{tmp.name}/ckpt", keep=3, async_save=False,
                           registry=reg)
    pm = PromotionManager(
        eng, eval_set=holdout, registry=reg,
        gate_rules=default_gate_rules(max_loss_regression=ONLINE_GATE),
        canary_fraction=0.25, canary_min_requests=8, canary_timeout_s=60.0,
        watch_window_s=1.0, watch_poll_s=0.05, probe_deadline_s=60.0)
    pipe = OnlineLearningPipeline(
        trainer, eng, topic="train", broker=broker, checkpoint_manager=cm,
        promotion=pm, window_size=ONLINE_WINDOW, poll_timeout_s=5.0,
        registry=reg)

    stop, failures, served_n = threading.Event(), [], [0]

    def client(tid):
        crs = np.random.RandomState(3000 + tid)
        while not stop.is_set():
            x = crs.rand(1 + crs.randint(16), *SERVE_ROW).astype(np.float32)
            try:
                out = eng.predict(x, deadline_s=120.0)
                if out.shape != (len(x), SERVE_CLASSES) \
                        or not np.isfinite(out).all():
                    failures.append(f"bad output {out.shape}")
                served_n[0] += 1
            except Exception as e:          # reported below
                failures.append(repr(e))

    clients = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(ONLINE_CLIENTS)]
    for th in clients:
        th.start()
    memory, captures, rows = [], [], []
    try:
        for w, window_labels in enumerate([labels, labels, shifted,
                                           labels]):
            for rec in _records(images, window_labels, time.time()):
                broker.publish("train", rec)
            twin_net = inj = None
            if w == 3:
                # the uncrashed twin from the window boundary
                twin_net = twin(trainer, True)
                inj = FaultInjector(seed=3).fail_at_step(
                    trainer.iteration + ONLINE_CRASH_AT,
                    component="ComputationGraph", transient=False)
                with inject_faults(inj):
                    pipe.run(max_windows=1)
                check([e for e in inj.injected
                       if e["kind"] == "step_fault"], "online: the crash "
                      "fired in window 4")
                twin_net.fit([(images[i:i + ONLINE_ROWS],
                               labels[i:i + ONLINE_ROWS])
                              for i in range(0, ONLINE_HOLDOUT,
                                             ONLINE_ROWS)])
                gaps = [g for g in state_gaps(trainer, twin_net)
                        if g.startswith("params")]
                check(not gaps, f"online: the replayed window's params "
                      f"equal the uncrashed twin's bit for bit ({len(gaps)}"
                      f" leaves differ: {gaps[:3]})")
                del twin_net
            else:
                pipe.run(max_windows=1)
            rec = pipe.results[-1]
            rows.append(rec)
            gc.collect()
            torch.cuda.synchronize()
            memory.append(torch.cuda.memory_allocated())
            captures.append(trainer._step_graphs.captures)
            rep = rec["promotion"]["report"]
            split = rec["split_ms"]
            print(f"online window {w + 1}: {rec['outcome']}, freshness "
                  f"{rec['freshness_s']} s, held-out loss "
                  f"{rep.get('loss'):.6f} (active "
                  f"{rep.get('active_loss'):.6f}), accuracy "
                  f"{rep.get('accuracy')}; split ms "
                  + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                  + f"; memory_allocated {memory[-1]} B; trainer "
                  f"captures {captures[-1]} [{name_card}]")
    finally:
        stop.set()
        for th in clients:
            th.join(300)
        eng.stop()
        cm.close()
    outcomes = [r["outcome"] for r in rows]
    check(outcomes == ONLINE_OUTCOMES, f"online: outcomes {outcomes}")
    check(reg.get_value("dl4j_online_windows_total", status="retried") == 1,
          "online: the crashed window was replayed")
    check(all("accuracy" in r["promotion"]["report"] for r in rows),
          "online: every evaluation report has its accuracy")
    check(not failures and served_n[0] > 0,
          f"online: {len(failures)} client requests failed "
          f"({failures[:3]}) of {served_n[0]}")
    check(captures[1:] == captures[:1] * 3,
          f"online: the trainer captured after window 1 ({captures})")
    check(abs(memory[3] - memory[1]) <= ONLINE_MEMORY_RTOL * memory[1],
          f"online: memory after window 4 {memory[3]} vs window 2 "
          f"{memory[1]}")
    h = introspection.harvest_model(trainer)
    check(h is not None and all(np.isfinite(e["norm"])
                                for e in h["gradient_stats"].values()),
          "online: the trainer's introspection ran on the card")
    launches = {n: c.launches for n, c in helpers.kernel_counts().items()}
    print(f"online: {served_n[0]} client requests, none failed; "
          f"outcomes {outcomes}; wrapper launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    for k in ("bn_train_fwd", "bn_train_bwd", "bn_inference"):
        check(launches[k] > 0, f"online: {k} launched")
    torch.backends.cudnn.deterministic = False
    tmp.cleanup()
    return launches


# ------------------------------------------ phase 16, in-step introspection
INTRO_STEPS, INTRO_WARM, INTRO_REPORT = 12, 2, 10
INTRO_NORM_RTOL = 1e-3
INTRO_POLICIES = [("off", {}),
                  ("introspection", {"introspection": {}}),
                  ("numerics", {"numerics": {}}),
                  ("both", {"introspection": {}, "numerics": {}})]


def _float64_norms(trees):
    """{layer: sqrt(sum x^2)} in float64 on the host over each layer's
    leaves."""
    return {name: float(np.sqrt(sum(
        float((t.detach().double().cpu() ** 2).sum())
        for t in tree_leaves(tuple(tree) if isinstance(tree, list)
                             else tree))))
        for name, tree in trees.items()}


def introspection_phase(name_card):
    """The full-width char-LM (batch 8 x 2048, bf16, Adam) captured four
    ways — policy off, introspection, numerics, both — each with a
    ``StatsListener`` reporting every 10 steps: parameters bit for bit
    the off run's, nothing captured after the warm-up, and the last
    step's harvested norms against a float64 recomputation from that
    step's gradients and parameters.  Returns the wrapper launches."""
    from deeplearning4j_tpu_torch.models.common import tree_clone, trainable
    from deeplearning4j_tpu_torch.observability import (
        introspection, numerics,
    )
    from deeplearning4j_tpu_torch.ui import (
        InMemoryStatsStorage, StatsListener, StatsUpdateConfiguration,
    )

    t_phase = time.perf_counter()
    for c in helpers.kernel_counts().values():
        c.reset()
    vocab = TRAIN_MODEL["vocab_size"]
    ids = np.random.RandomState(0).randint(0, vocab, (TRAIN_BATCH, TRAIN_T))
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)],
                        device="cuda")
    base, medians = None, {}
    for what, pol in INTRO_POLICIES:
        net = transformer_char_lm(device="cuda", **TRAIN_MODEL, **pol)
        storage = InMemoryStatsStorage()
        net.set_listeners(StatsListener(
            storage, session_id=what, config=StatsUpdateConfiguration(
                reporting_frequency=INTRO_REPORT)))
        _, secs, caps = fit_steps(net, [(x, y)], INTRO_STEPS - 1)
        # the last step: its gradients recomputed eagerly beforehand
        before = tree_clone(trainable(net.params))
        grads = None
        if "introspection" in pol:
            leaves = tree_leaves(before)
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = net._loss_fn({**net.params, **before}, x, y, None,
                                   train=True)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            for p in leaves:
                p.requires_grad_(False)
            it = iter(g)
            grads = {k: [next(it) for _ in tree_leaves(v)]
                     for k, v in sorted(before.items())}
        _, last, caps2 = fit_steps(net, [(x, y)], 1)
        secs, caps = secs + last, caps + caps2
        medians[what] = float(np.median(secs[INTRO_WARM:])) * 1e3
        check(caps[-1] == caps[INTRO_WARM - 1],
              f"introspection [{what}]: captured after warm-up {caps}")
        ups = storage.get_updates(what)
        check(len(ups) == INTRO_STEPS // INTRO_REPORT,
              f"introspection [{what}]: {len(ups)} reports")
        if base is None:
            base = [t.clone() for t in tree_leaves(net.params)]
        else:
            same = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(net.params), base))
            check(same, f"introspection [{what}]: params equal the off "
                        f"run's bit for bit")
        line = (f"introspection [{what}]: step median {medians[what]:.3f}"
                f" ms, captures {caps[-1]}")
        if grads is not None:
            h = introspection.harvest_model(net)
            check(h["iteration"] == INTRO_STEPS - 1,
                  f"introspection [{what}]: harvested iteration "
                  f"{h['iteration']}")
            want_g = _float64_norms({k: v for k, v in grads.items()})
            want_p = _float64_norms(before)
            want_u = _float64_norms({
                k: [a.double() - b.double() for a, b in zip(
                    tree_leaves(before[k]), tree_leaves(net.params[k]))]
                for k in before})
            worst = 0.0
            for name in h["gradient_stats"]:
                for got, want in (
                        (h["gradient_stats"][name]["norm"], want_g[name]),
                        (h["update_stats"][name]["param_norm"],
                         want_p[name]),
                        (h["update_stats"][name]["norm"], want_u[name])):
                    worst = max(worst, abs(got - want) / max(want, 1e-30))
            check(worst <= INTRO_NORM_RTOL,
                  f"introspection [{what}]: norms within {INTRO_NORM_RTOL}"
                  f" of float64 (worst {worst:.3g})")
            line += f"; norms vs float64 worst rel {worst:.3g}"
        if "numerics" in pol:
            nh = numerics.harvest_model(net)
            check(nh is not None and nh["iteration"] == INTRO_REPORT,
                  f"introspection [{what}]: the ledger's snapshot")
            risky = sum(not e["verdicts"]["bfloat16"]
                        for comp in ("gradients", "moments", "activations")
                        for e in nh[comp].values())
            line += (f"; the collecting step (iteration {INTRO_REPORT}) "
                     f"{secs[INTRO_REPORT] * 1e3:.3f} ms; ledger "
                     f"bf16-risky blocks {risky}")
        print(line + f" [{name_card}]")
        del net, storage
        torch.cuda.empty_cache()
    off = medians["off"]
    print("introspection: overhead against off " + ", ".join(
        f"{k} {(v / off - 1) * 100:+.2f}%" for k, v in medians.items()
        if k != "off") + " (the reference's target is under 5 %)")
    launches = {n: c.launches for n, c in helpers.kernel_counts().items()}
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "prologue"):
        check(launches[k] > 0, f"introspection: {k} launched")
    print(f"introspection: wrapper launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------ phase 17, kernel trust
def _kerneldiff_path_configs():
    """The path's shapes, by registry kernel: the char-LM's flash forward
    (its float64 reference over the first batch row), the engine's
    decode, the prologue, AlexNet's first LRN and ResNet-50's stem
    BatchNorm."""
    rows, c = TRAIN_BATCH * TRAIN_T, 1024
    flash = [{"shape": [TRAIN_BATCH, TRAIN_T, 8, 128], "dtype": dt,
              "causal": True, "window": None, "ref_rows": 1, "path": True}
             for dt in ("bfloat16", "float32")]
    paged = [{"pages": PAGES, "page_size": PS, "maxp": MAXP, "hq": 8,
              "hkv": 8, "d": 128, "b": ENGINE["slots"], "t": 1,
              "dtype": "bfloat16", "path": True}]
    prologue = [{"shape": [rows, c], "dtype": "bfloat16",
                 "variant": "norm_only", "path": True}]
    n, h, w, ch = LRN_CASES[0][1]
    lrn_cfg = [{"shape": [n * h * w, ch], "dtype": "bfloat16",
                "path": True}]
    n, h, w, ch = BN_CASES[0][1]
    bn_cfg = [{"shape": [n * h * w, ch], "dtype": "bfloat16", "path": True}]
    return {"flash_attention_fwd": flash, "paged_decode_attention": paged,
            "dropout_residual_norm": prologue, "lrn_fwd": lrn_cfg,
            "batch_norm_inference": bn_cfg, "batch_norm_train_fwd": bn_cfg}


def kerneldiff_phase(name_card):
    """Every kernel of ``kerneldiff.KERNELS`` on the card against the
    float64 numpy references, at the reference sweep's full grid and at
    the path's shapes; a kernel's error propagates.  Returns the report
    and the worst max-rel by (kernel, dtype) over the path's configs."""
    from deeplearning4j_tpu_torch.observability import kerneldiff

    t_phase = time.perf_counter()
    report = kerneldiff.run_sweep(full=True, device="cuda",
                                  extra=_kerneldiff_path_configs())
    print(kerneldiff.format_report(report) + f" [{name_card}]")
    path_rel = {}
    for name, k in report["kernels"].items():
        for cfg in k["configs"]:
            if cfg.get("path"):
                key = (name, cfg["dtype"])
                path_rel[key] = max(path_rel.get(key, 0.0),
                                    cfg["max_rel_error"])
                print(f"kerneldiff path {name} {cfg['dtype']} "
                      f"{cfg.get('shape') or [cfg['b'], cfg['t']]}: "
                      f"max_abs {cfg['max_abs_error']:.3g}, max_rel "
                      f"{cfg['max_rel_error']:.3g}, ulp p99 "
                      f"{cfg['ulp_p99']:g}, {cfg['status']}")
    check(report["summary"]["untrusted"] == [],
          f"kerneldiff: untrusted {report['summary']['untrusted']}")
    print(f"kerneldiff: {sum(len(k['configs']) for k in report['kernels'].values())}"
          f" configs in {time.perf_counter() - t_phase:.1f} s")
    return report, path_rel


# ---------------------------------------------------- phase 17, the fleet
FLEET_IDS = ("f0", "f1")
FLEET_CLIENTS = 4
FLEET_NEW = 32              # new tokens a client request
FLEET_BURST = 24            # session requests at the first kill: 16 slots
FLEET_LONG = 256            # the stream killed in its middle
# one page (16 tokens): the unit of the router's affinity; a prompt of
# at most one page never hits a replica's prefix cache (a hit leaves a
# token to prefill), so every request's ids are a cold engine's
FLEET_SHARED = [(7 * i + 3) % MODEL["vocab_size"] for i in range(16)]
FLEET_STEADY_S = 5.0        # mixed traffic before the drills
FLEET_REJOIN_S = 600.0
FLEET_SINGLE_REQUESTS = 32  # the single engine's TTFT yardstick


def _fleet_prompt(rng):
    """The shared page 4 times in 10, else 4-16 random tokens."""
    if rng.random() < 0.4:
        return list(FLEET_SHARED)
    return rng.integers(0, MODEL["vocab_size"],
                        int(rng.integers(4, 17))).tolist()


def _fleet_request(port, prompt, n, stream, session=None, on_event=None):
    """One ``/generate`` through the frontend: a record of its prompt,
    tokens, error, replica, failovers and (streamed) token times."""
    body = {"prompt": prompt, "max_tokens": n, "stream": stream}
    if session is not None:
        body["session_id"] = session
    rec = {"kind": "stream" if stream else "unary", "prompt": prompt,
           "n": n, "session": session}
    if stream:
        status, events, t0 = _http_stream(port, body, on_event=on_event)
        toks = [(t, e) for t, e in events if "token" in e]
        last = events[-1][1] if events else {}
        rec.update(status=status, t_send=t0, tokens=[e["token"]
                                                     for _, e in toks],
                   times=[t for t, _ in toks],
                   terminal=last if last.get("done") else None,
                   error=(last.get("error") if last.get("done")
                          else "stream ended without a terminal event"),
                   replica=last.get("replica"),
                   failovers=last.get("failovers"))
    else:
        t0 = time.perf_counter()
        status, obj, _raw = _http_json(port, "POST", "/generate", body)
        obj = obj or {}
        rec.update(status=status, t_send=t0, times=[],
                   tokens=obj.get("tokens", []) if status == 200 else [],
                   error=None if status == 200 else obj,
                   replica=obj.get("replica"),
                   failovers=obj.get("failovers"))
    rec["t_done"] = time.perf_counter()
    return rec


class _FleetClients:
    """``FLEET_CLIENTS`` threads sending ``/generate`` through the
    frontend until stopped, streamed and unary in turn — streamed only
    while ``streams_only`` is set, across the kills: a unary request
    cut by a kill cannot tell its client whether tokens had flowed."""

    def __init__(self, port):
        self.port = port
        self.records = []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.streams_only = threading.Event()
        self.unary_in_flight = 0
        self.threads = [threading.Thread(target=self._run, args=(c,),
                                         daemon=True)
                        for c in range(FLEET_CLIENTS)]

    def _run(self, c):
        rng = np.random.default_rng(100 + c)
        i = 0
        while not self.stop.is_set():
            with self.lock:
                stream = self.streams_only.is_set() or i % 2 == 0
                self.unary_in_flight += not stream
            rec = _fleet_request(self.port, _fleet_prompt(rng), FLEET_NEW,
                                 stream)
            with self.lock:
                self.records.append(rec)
                self.unary_in_flight -= not stream
            i += 1

    def streams_from_now(self):
        """Streamed requests only, once the unary ones in flight are
        done."""
        with self.lock:
            self.streams_only.set()
        _wait_until(lambda: self.unary_in_flight == 0,
                    "the unary requests in flight finish", timeout=600)

    def start(self):
        for th in self.threads:
            th.start()
        return self

    def join(self):
        self.stop.set()
        for th in self.threads:
            th.join(600)
        check(not any(th.is_alive() for th in self.threads),
              "fleet: the client threads finished")


def _longest_gap(records, t0, t1, replica):
    """The longest gap between two tokens that reached a client of
    ``replica`` overlapping [t0, t1]."""
    worst = 0.0
    for r in records:
        if r["replica"] != replica:
            continue
        for a, b in zip(r["times"], r["times"][1:]):
            if a < t1 and b > t0:
                worst = max(worst, b - a)
    return worst


def _replica_args():
    return {"vocab": MODEL["vocab_size"], "d_model": MODEL["d_model"],
            "n_heads": MODEL["n_heads"], "layers": MODEL["layers"],
            "model_seed": MODEL["seed"],
            "compute_dtype": MODEL["compute_dtype"],
            "slots": ENGINE["slots"], "page_size": ENGINE["page_size"],
            "max_context": ENGINE["max_context"],
            "prefill_buckets": ",".join(
                str(b) for b in ENGINE["prefill_buckets"]),
            "max_queue": 256, "interval_s": 0.25}


def _wait_until(cond, what, timeout=FLEET_REJOIN_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return time.perf_counter()
        time.sleep(0.05)
    check(False, f"fleet: {what} within {timeout:.0f} s")


def _kill_after_first_token(sup, victim, done, on_kill):
    """An SSE callback: SIGKILL ``victim`` once, at the first token any
    stream it is given to sees."""
    import signal

    def on_event(ev):
        if "token" in ev and not done.is_set():
            done.set()
            on_kill(time.perf_counter())
            sup.kill(victim(), sig=signal.SIGKILL, restart=True)
    return on_event


def fleet_phase(name_card):
    """Two subprocess replicas of the full-width char-LM behind the
    router and its HTTP frontend, under four clients, through two
    SIGKILL drills and their restarts; then an in-process rollout over
    two engines.  Returns the paged-decode and prologue launches: the
    replicas' replays (their published counts) and the in-process
    engines' (counted where a launch is made or recorded)."""
    from deeplearning4j_tpu_torch.fleet import (
        FleetFrontend, FleetRouter, ReplicaSupervisor,
    )
    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    from deeplearning4j_tpu_torch.observability.fleet import FleetAggregator
    from deeplearning4j_tpu_torch.streaming import MessageBroker

    # the single engine: the ids every completed request must give, and
    # the TTFT yardstick under the same four clients
    single = GenerationEngine(transformer_char_lm(device="cuda", **MODEL),
                              **ENGINE, max_queue=256,
                              prefix_cache=True).start()
    ttft_single, lock = [], threading.Lock()

    def single_client(c):
        rng = np.random.default_rng(200 + c)
        for _ in range(FLEET_SINGLE_REQUESTS // FLEET_CLIENTS):
            h = single.submit(_fleet_prompt(rng), FLEET_NEW)
            h.result(timeout=600)
            with lock:
                ttft_single.append(h.ttft_s)

    threads = [threading.Thread(target=single_client, args=(c,))
               for c in range(FLEET_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)

    broker = MessageBroker()
    burl = f"http://127.0.0.1:{broker.serve(port=0)}"
    agg = FleetAggregator(url=burl, expire_after_s=3.0,
                          registry=MetricsRegistry()).start()
    agg_port = agg.serve(port=0)
    sup = ReplicaSupervisor(broker_url=burl, warmup_timeout_s=FLEET_REJOIN_S,
                            registry=MetricsRegistry(),
                            replica_args=_replica_args()).start()
    front = clients = None
    try:
        spawn = {}

        def start(wid):
            t0 = time.perf_counter()
            sup.start_replica(wid)
            spawn[wid] = time.perf_counter() - t0

        threads = [threading.Thread(target=start, args=(w,))
                   for w in FLEET_IDS]
        for th in threads:
            th.start()
        for th in threads:
            th.join(FLEET_REJOIN_S)
        check(sorted(spawn) == sorted(FLEET_IDS), "fleet: both replicas "
              "spawned and warmed")
        print(f"fleet: replicas spawned and warm (model built, kernels "
              f"loaded, graphs captured, /healthz 200) in "
              + ", ".join(f"{w} {spawn[w]:.1f} s" for w in FLEET_IDS)
              + f" [{name_card}]")
        router = FleetRouter(aggregator=agg, page_size=ENGINE["page_size"],
                             seed=7, refresh_interval_s=0.1,
                             registry=MetricsRegistry())
        for h in sup.handles(timeout=600).values():
            router.attach(h)

        def live(wid=None):
            rows = {r["replica"]: r["live"] for r in router.replicas()}
            return rows.get(wid, False) if wid else sum(rows.values())

        _wait_until(lambda: live() == 2, "both replicas live")

        def rejoined(wid, epoch):
            """The restarted ``wid`` publishes under a new epoch, is
            fresh, and the router places on it again."""
            return live(wid) and any(
                r["worker"] == wid and r["epoch"] != epoch[wid]
                and not r["stale"] for r in agg.workers())
        front = FleetFrontend(router)
        port = front.start()
        launches = {}

        def bank(wid):
            """The replica's last published replay launches, before it
            is killed (its counts die with it)."""
            for row in agg.workers():
                if row["worker"] == wid:
                    for k, n in ((row.get("state") or {}).get(
                            "replayed_launches") or {}).items():
                        launches[k] = launches.get(k, 0) + n

        # the session: pinned on one replica, its requests stick there
        pinned = router.pin_session("chat", FLEET_SHARED)
        survivor = next(w for w in FLEET_IDS if w != pinned)
        stuck = [_fleet_request(port, FLEET_SHARED, FLEET_NEW, False,
                                session="chat") for _ in range(4)]
        check(all(r["replica"] == pinned and r["error"] is None
                  for r in stuck), f"fleet: the session's requests stay on "
              f"{pinned}: {[r['replica'] for r in stuck]}")

        clients = _FleetClients(port).start()
        time.sleep(FLEET_STEADY_S)
        t_steady = time.perf_counter()
        with clients.lock:
            steady = [r for r in clients.records
                      if r["error"] is None and r["t_done"] <= t_steady]
        first_send = min(r["t_send"] for r in steady)
        steady_tokens = sum(len(r["tokens"]) for r in steady)
        tps = steady_tokens / (t_steady - first_send)

        # drill A: the session's replica killed while its requests queue
        clients.streams_from_now()
        epoch = {r["worker"]: r["epoch"] for r in agg.workers()}
        bank(pinned)
        killed_a, t_kill = threading.Event(), []
        on_event = _kill_after_first_token(sup, lambda: pinned, killed_a,
                                           t_kill.append)
        burst = [None] * FLEET_BURST

        def burst_one(i):
            burst[i] = _fleet_request(port, FLEET_SHARED, FLEET_NEW, True,
                                      session="chat", on_event=on_event)

        threads = [threading.Thread(target=burst_one, args=(i,))
                   for i in range(FLEET_BURST)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        check(killed_a.is_set(), "fleet: drill A killed the replica")
        t_kill = t_kill[0]
        after = [_fleet_request(port, FLEET_SHARED, FLEET_NEW, True,
                                session="chat") for _ in range(4)]
        check(all(r["replica"] == survivor and r["error"] is None
                  for r in after) and router.session_replica("chat")
              == survivor, "fleet: the session is pinned again on the "
              f"survivor: {[r['replica'] for r in after]}")
        t_rejoin = _wait_until(lambda: rejoined(pinned, epoch),
                               f"{pinned} rejoins under a fresh epoch")
        restart_s = t_rejoin - t_kill
        with clients.lock:
            during = list(clients.records) + burst + after
        gap = _longest_gap(during, t_kill, t_rejoin, survivor)
        failed_over = [r for r in burst if r["error"] is None
                       and (r["failovers"] or 0) >= 1]
        check(failed_over, "fleet: queued requests failed over")
        fo_ms = sorted((r["times"][0] - t_kill) * 1e3 for r in failed_over)
        print(f"fleet drill A: {pinned} SIGKILLed with {FLEET_BURST} "
              f"session streams on it; {len(failed_over)} queued ones "
              f"failed over to {survivor} (first token after the kill "
              f"{fo_ms[0]:.1f} / {fo_ms[len(fo_ms) // 2]:.1f} / "
              f"{fo_ms[-1]:.1f} ms min/median/max), "
              f"{sum(r['error'] is not None for r in burst)} in flight ended "
              f"with an error event; {pinned} restarted and live again "
              f"{restart_s:.1f} s after the kill (restarts "
              f"{sup.processes()[pinned].restarts}); the survivor's longest "
              f"token gap meanwhile {gap * 1e3:.1f} ms [{name_card}]")

        # drill B: a replica killed in the middle of a long stream
        victim = router.pin_session("long", FLEET_SHARED[:8])
        bank(victim)
        epoch = {r["worker"]: r["epoch"] for r in agg.workers()}
        killed_b, t_kill_b = threading.Event(), []
        long_rec = _fleet_request(
            port, FLEET_SHARED[:8], FLEET_LONG, True, session="long",
            on_event=_kill_after_first_token(sup, lambda: victim, killed_b,
                                             t_kill_b.append))
        check(killed_b.is_set() and long_rec["terminal"] is not None
              and long_rec["error"] and 0 < len(long_rec["tokens"])
              < FLEET_LONG, f"fleet drill B: the killed stream ended in a "
              f"terminal error event after {len(long_rec['tokens'])} tokens")
        other = next(w for w in FLEET_IDS if w != victim)
        t_rejoin_b = _wait_until(lambda: rejoined(victim, epoch),
                                 f"{victim} rejoins under a fresh epoch")
        with clients.lock:
            during = list(clients.records)
        gap_b = _longest_gap(during, t_kill_b[0], t_rejoin_b, other)
        print(f"fleet drill B: {victim} SIGKILLed mid-stream after "
              f"{len(long_rec['tokens'])} of {FLEET_LONG} tokens: terminal "
              f"event {long_rec['terminal']['type']}; restarted and live "
              f"{t_rejoin_b - t_kill_b[0]:.1f} s later; {other}'s longest "
              f"token gap meanwhile {gap_b * 1e3:.1f} ms [{name_card}]")

        clients.streams_only.clear()
        time.sleep(2.0)
        clients.join()
        table = _http_json(agg_port, "GET", "/fleet")[1]
        rows = {w["worker"]: w for w in table["workers"]}
        check(sorted(rows) == sorted(FLEET_IDS)
              and not any(w["stale"] for w in rows.values()),
              f"fleet: /fleet names both replicas live: {table}")
        for wid in FLEET_IDS:
            for k, n in ((rows[wid].get("state") or {}).get(
                    "replayed_launches") or {}).items():
                launches[k] = launches.get(k, 0) + n
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
    finally:
        if clients is not None:
            clients.stop.set()
        if front is not None:
            front.stop()
        sup.stop_all()
        agg.stop()
        broker.stop()

    # every request: the single engine's ids, or a killed stream's clean
    # terminal error after the tokens it had
    records = clients.records + stuck + burst + after + [long_rec]
    prompts = {(tuple(r["prompt"]), r["n"]) for r in records}
    ref = {}
    keys = sorted(prompts)
    for i in range(0, len(keys), ENGINE["slots"]):
        chunk = keys[i:i + ENGINE["slots"]]
        hs = [single.submit(list(p), n) for p, n in chunk]
        for key, h in zip(chunk, hs):
            ref[key] = h.result(timeout=600)
    single.stop()
    bad = [r for r in records if r["error"] is None
           and r["tokens"] != ref[(tuple(r["prompt"]), r["n"])]]
    check(not bad, f"fleet: {len(bad)} completed requests part from the "
          f"single engine's ids")
    failed = [r for r in records if r["error"] is not None]
    unclean = [r for r in failed
               if r["kind"] != "stream" or r["terminal"] is None
               or not r["tokens"] or r["tokens"] != ref[
                   (tuple(r["prompt"]), r["n"])][:len(r["tokens"])]]
    check(not unclean, f"fleet: {len(unclean)} failed requests were not "
          f"killed streams ending in a clean terminal event: "
          f"{[(r['kind'], len(r['tokens']), r['error']) for r in unclean]}")
    streamed = [r for r in records if r["error"] is None and r["times"]
                and not r["failovers"]]
    ttft = [r["times"][0] - r["t_send"] for r in streamed]
    print(f"fleet: {len(records)} requests ({sum(r['kind'] == 'stream' for r in records)} "
          f"streamed), {len(failed)} killed streams ended with a terminal "
          f"event, none queued failed, every completed one the single "
          f"engine's ids; TTFT through the frontend p50/p99 "
          f"{_pcts(ttft)[0]:.3f}/{_pcts(ttft)[1]:.3f} ms against the "
          f"single engine's {_pcts(ttft_single)[0]:.3f}/"
          f"{_pcts(ttft_single)[1]:.3f} ms; fleet {tps:.1f} tokens/s over "
          f"{t_steady - first_send:.1f} s of mixed traffic (two replicas "
          f"time-share one card: not a scaling number); per-process "
          f"memory (pid, MiB): {smi} [{name_card}]")
    rollout = fleet_rollout(name_card)
    return {k: launches.get(k, 0) + rollout.get(k, 0)
            for k in ("paged_decode", "prologue")}


def fleet_rollout(name_card):
    """``FleetRollout`` over two in-process full-width engines under
    load: a candidate promoted (canary, wave, commit) and then a forced
    watch regression rolled back on both; each engine's ids are the
    promoted weights' after each.  Returns the wrapper launches (the
    deploys' captures)."""
    from deeplearning4j_tpu_torch.fleet import (
        FleetRollout, FleetRouter, InProcessReplica,
    )
    from deeplearning4j_tpu_torch.observability import MetricsRegistry

    counts = helpers.kernel_counts()
    for c in counts.values():
        c.reset()
    engines = {rid: GenerationEngine(
        transformer_char_lm(device="cuda", **MODEL), **ENGINE,
        max_queue=256).start() for rid in ("r0", "r1")}
    router = FleetRouter(page_size=ENGINE["page_size"], seed=3,
                         refresh_interval_s=0.0, registry=MetricsRegistry())
    handles = {rid: InProcessReplica(rid, e) for rid, e in engines.items()}
    for h in handles.values():
        router.attach(h)
    rng = np.random.default_rng(11)
    probes = [rng.integers(0, MODEL["vocab_size"], int(rng.integers(4, 17)))
              .tolist() for _ in range(ENGINE["slots"])]

    def ids(eng):
        hs = [eng.submit(p, FLEET_NEW) for p in probes]
        return [h.result(timeout=600) for h in hs]

    stop, errors = threading.Event(), []

    def load():
        r = np.random.default_rng(12)
        while not stop.is_set():
            try:
                router.submit(_fleet_prompt(r), FLEET_NEW).result(timeout=600)
            except Exception as e:      # reported below
                errors.append(e)
                return

    cand_net = transformer_char_lm(device="cuda",
                                   **{**MODEL, "seed": SWAP_SEED})
    fresh = GenerationEngine(cand_net, **ENGINE).start()
    want = ids(fresh)
    fresh.stop()
    del fresh
    th = threading.Thread(target=load, daemon=True)
    th.start()
    try:
        t0 = time.perf_counter()
        ro = FleetRollout(router, handles, canary_fraction=0.5,
                          canary_min_requests=4, canary_timeout_s=300,
                          watch_window_s=1.0, watch_poll_s=0.05,
                          registry=router.registry)
        res = ro.consider(cand_net, "candidate")
        t1 = time.perf_counter()
        bad_net = transformer_char_lm(device="cuda",
                                      **{**MODEL, "seed": SWAP_SEED + 1})
        ro2 = FleetRollout(router, handles, canary_fraction=0.5,
                           canary_min_requests=4, canary_timeout_s=300,
                           watch_window_s=1.0, watch_poll_s=0.05,
                           registry=router.registry,
                           watch_extra_fn=lambda rid: {
                               "probe_ok": False,
                               "probe_detail": "forced regression"})
        versions = {rid: e.models.active("default").version
                    for rid, e in engines.items()}
        res2 = ro2.consider(bad_net, "regression")
        t2 = time.perf_counter()
    finally:
        stop.set()
        th.join(600)
    check(not errors, f"fleet rollout: load errors {errors!r}")
    check(res.outcome == "promoted" and sorted(res.committed) == ["r0", "r1"],
          f"fleet rollout: the candidate is promoted ({res.as_dict()})")
    check(res2.outcome == "rolled_back"
          and sorted(res2.rolled_back) == ["r0", "r1"]
          and {rid: e.models.active("default").version
               for rid, e in engines.items()} == versions,
          f"fleet rollout: the regression rolled back both "
          f"({res2.as_dict()})")
    for rid, e in engines.items():
        check(len(e._programs) == 1, f"fleet rollout: {rid} released the "
              f"rolled-back version's graphs ({list(e._programs)})")
        check(ids(e) == want, f"fleet rollout: {rid} serves the promoted "
              f"weights' ids")
    launches = {n: c.launches for n, c in counts.items()}
    for e in engines.values():
        e.stop()
    print(f"fleet rollout: promoted in {t1 - t0:.2f} s (canary "
          f"{res.canary['requests']} requests on {res.canary['replica']}, "
          f"waves {[w['replica'] for w in res.waves]}), the forced "
          f"regression rolled back {res2.rolled_back} in {t2 - t1:.2f} s; "
          f"both engines give the promoted weights' ids [{name_card}]")
    return launches


# ------------------------------------------------- phase 18, the profiler
PROFILE_STEPS = 7           # fit steps a run: 2 warm-up, then 5
PROFILE_CAPTURE = 3         # the iteration StepProfiler captures
PROFILE_IDLE = (2, 4, 5, 6)  # the steps timed with the profiler idle
HAND_RTOL = 0.15            # the char-LM's counted flops against its hand count
MEM_RTOL = 0.01             # memory attribution against the nets' own bytes


def _synced_steps(net, x, y, steps):
    """Host seconds of ``steps`` ``fit`` calls, each ending in the loss
    read (which waits for it)."""
    secs = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        net.score_value
        secs.append(time.perf_counter() - t0)
    return secs


def _profile_run(what, net, x, y, hand_flops, kernel_re, name_card):
    """``StepProfiler(capture_step=3)`` over ``PROFILE_STEPS`` captured
    ``fit`` steps of ``net`` on a fresh registry, beside a twin from the
    same state without it: one capture named in the flight recorder,
    its Chrome traces (the kernels matching ``kernel_re`` by name, the
    ``fit_step`` host span), its flops and unclamped MFU, one compile of
    the train step, and the twin's parameters bit for bit.  Returns the
    counted flops and the kernel launches of the profiled run."""
    import os
    import tempfile

    from deeplearning4j_tpu_torch.observability import (
        MetricsRegistry, StepProfiler, get_flight_recorder, get_registry,
        set_registry,
    )

    kind = type(net).__name__
    other = twin(net, True)
    old = get_registry()
    counts = helpers.kernel_counts()
    for c in counts.values():
        c.reset()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            reg = set_registry(MetricsRegistry())
            prof = StepProfiler(tmp, capture_step=PROFILE_CAPTURE).install()
            secs = _synced_steps(net, x, y, PROFILE_STEPS)
            prof.uninstall()
            launches = {n: c.launches for n, c in counts.items()}
            set_registry(MetricsRegistry())
            plain = _synced_steps(other, x, y, PROFILE_STEPS)
        finally:
            set_registry(old)
        caps = [e.to_dict() for e in get_flight_recorder().events()
                if e.kind == "profile_capture"
                and e.to_dict()["path"].startswith(tmp)]
        check(len(caps) == 1 and caps[0]["reason"] == f"step:"
              f"{PROFILE_CAPTURE}" and caps[0]["step"] == "fit_step",
              f"{what} profile: one capture named in the flight recorder "
              f"({caps})")
        with open(os.path.join(caps[0]["path"], "capture.json")) as f:
            meta = json.load(f)
        with open(meta["torch_trace"]) as f:
            trace = json.load(f)
        kernels = {e.get("name", "") for e in trace["traceEvents"]
                   if re.search(kernel_re, e.get("name", ""))}
        with open(os.path.join(caps[0]["path"],
                               "host_spans.trace.json")) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]
                     if e["ph"] == "X"}
        sizes = (os.path.getsize(meta["torch_trace"]),
                 os.path.getsize(os.path.join(caps[0]["path"],
                                              "host_spans.trace.json")))
    check(bool(kernels) and "fit_step" in spans,
          f"{what} profile: the Chrome trace names the kernels "
          f"({sorted(kernels)[:4]}) and the fit_step span")
    mfu = meta["mfu_unclamped"]
    check(meta["flops"] > 0 and meta["timed_on"] == "cuda_events"
          and mfu is not None and 0.0 < mfu <= 1.0,
          f"{what} profile: flops {meta['flops']:.4e}, unclamped MFU "
          f"{mfu} in (0, 1], timed on the card")
    compiles = reg.get_value("dl4j_compiles_total", fn=f"{kind}.train_step")
    check(compiles == 1, f"{what} profile: dl4j_compiles_total"
          f"{{fn={kind}.train_step}} {compiles} after warm-up")
    gaps = state_gaps(net, other)
    check(not gaps, f"{what} profile: parameters bit for bit the "
          f"unprofiled twin's ({sorted(gaps)[:4]})")
    idle = float(np.median([secs[i] for i in PROFILE_IDLE])) * 1e3
    base = float(np.median([plain[i] for i in PROFILE_IDLE])) * 1e3
    last = reg.get_value("dl4j_model_flops_utilization_unclamped",
                         component=kind)
    peak = meta["peak_flops"]
    cost = net._instrumented["train_step"].detector.last_cost
    print(f"{what} profile: counted flops a step {meta['flops']:.6e} "
          f"(the kernels' {cost['kernel_flops']:.4e} of them) "
          f"against the hand count {hand_flops:.6e} "
          f"({meta['flops'] / hand_flops - 1:+.2%}); MFU (counted flops "
          f"over the device span, {peak / 1e12:.0f} TFLOP/s): captured "
          f"step {mfu:.4f} ({meta['seconds'] * 1e3:.3f} ms under "
          f"torch.profiler), last step {last:.4f}; the hand count's MFU "
          f"over the synced step median {hand_flops / (idle / 1e3) / peak:.4f}"
          f"; step median with the profiler installed and idle "
          f"{idle:.3f} ms against {base:.3f} ms without; the capture step "
          f"{secs[PROFILE_CAPTURE] * 1e3:.3f} ms; traces {sizes[0]} bytes "
          f"(torch) + {sizes[1]} bytes (host spans); kernels seen "
          f"{sorted(kernels)[:6]} [{name_card}]")
    return meta, launches


def _crash_drill(net, x, y, name_card):
    """A fatal fault injected into the captured ``fit``
    (``resilience.faults``): its flight report's memory attribution
    names the net, its params plus updater bytes within ``MEM_RTOL`` of
    the tensors' own, with the card's peak allocation."""
    import tempfile

    from deeplearning4j_tpu_torch.observability import (
        StepProfiler, StepWatchdog, read_flight_report,
    )
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, InjectedFault, RetryPolicy, inject_faults,
    )

    kind = type(net).__name__
    with tempfile.TemporaryDirectory() as tmp:
        prof = StepProfiler(tmp, use_torch_profiler=False).install()
        wd = StepWatchdog(deadline_s=600.0, report_dir=tmp).install()
        try:
            with inject_faults(FaultInjector().fail_at_step(
                    net.iteration + 1, component=kind, transient=False)):
                try:
                    net.fit([(x, y)] * 3,
                            retry_policy=RetryPolicy(max_retries=0))
                    check(False, f"{kind} crash drill: the fault fired")
                except InjectedFault:
                    pass
            recs = read_flight_report(wd.dumps[-1])
        finally:
            wd.uninstall()
            prof.uninstall()
    mem = [r for r in recs if r["record"] == "memory_attribution"]
    check(len(mem) == 1 and kind in mem[0].get("models", {}),
          f"{kind} crash drill: the report attributes memory to the net")
    br = mem[0]["models"][kind]
    own = (sum(t.nbytes for t in tree_leaves(net.params))
           + sum(t.nbytes for t in tree_leaves(net.updater_state)))
    got = br["params_bytes"] + br["updater_state_bytes"]
    peak = mem[0]["peak"]
    check(abs(got - own) <= MEM_RTOL * own and peak["source"] == "torch.cuda"
          and peak["peak_bytes"] > 0,
          f"{kind} crash drill: attributed {got} bytes against {own}, "
          f"peak {peak}")
    print(f"{kind} crash drill: the flight report's memory attribution "
          f"{got} bytes (params {br['params_bytes']}, updater "
          f"{br['updater_state_bytes']}) against the tensors' {own}; live "
          f"CUDA tensors {mem[0]['live_buffers']['total_bytes']} bytes in "
          f"{mem[0]['live_buffers']['count']}; torch.cuda peak "
          f"{peak['peak_bytes']} bytes [{name_card}]")


def regression_check(name_card):
    """kerneldiff's CLI on the card: the sweep written with ``--out`` to
    a temporary path, then compared with ``--baseline`` against it (exit
    0), and against a copy doctored to tighten one kernel's max-rel ten
    times (exit 1)."""
    import contextlib
    import io
    import os
    import tempfile

    from deeplearning4j_tpu_torch.observability import kerneldiff

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "trust.json")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_out = kerneldiff.main(["--out", base])
            rc_same = kerneldiff.main(["--baseline", base])
        with open(base) as f:
            doc = json.load(f)
        entry = next(e for e in doc["all"] if e["metric"]
                     == "Kernel max rel error (flash_attention_fwd)")
        entry["value"] /= 10.0
        tight = os.path.join(tmp, "tight.json")
        with open(tight, "w") as f:
            json.dump(doc, f)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_tight = kerneldiff.main(["--baseline", tight])
    check(rc_out == 0 and rc_same == 0 and rc_tight == 1
          and "REGRESSED" in out.getvalue(),
          f"kerneldiff --out/--baseline: exit {rc_out}, {rc_same}, and "
          f"{rc_tight} against the doctored baseline")
    print(f"kerneldiff --out then --baseline on the card: exit {rc_out}, "
          f"{rc_same}; a baseline with flash_attention_fwd's max-rel "
          f"tightened ten times: exit {rc_tight} (REGRESSED) [{name_card}]")


def profiling_phase(name_card, deterministic=False):
    """The step profiler over the bf16 char-LM's captured ``fit`` at
    ``TRAIN_MODEL`` width and batch and ResNet-50's (``deterministic``:
    cuDNN as the guard phase found ResNet-50 needs for bit-equal twins),
    then the crash drill.  Returns the wrapper launches of the two
    profiled runs."""
    net = transformer_char_lm(device="cuda", **TRAIN_MODEL)
    vocab = TRAIN_MODEL["vocab_size"]
    ids = np.random.RandomState(0).randint(0, vocab, (TRAIN_BATCH, TRAIN_T))
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)],
                        device="cuda")
    layers, heads = TRAIN_MODEL["layers"], TRAIN_MODEL["n_heads"]
    d_model = TRAIN_MODEL["d_model"]
    hand = (6.0 * _matmul_params(net) * TRAIN_BATCH * TRAIN_T
            + 12.0 * layers * heads * TRAIN_T * TRAIN_T
            * (d_model // heads) * TRAIN_BATCH * 0.5)
    meta, lm_launches = _profile_run("char-LM", net, x, y, hand,
                                     r"\bflash_(fwd|dq|dkv)", name_card)
    check(abs(meta["flops"] - hand) <= HAND_RTOL * hand,
          f"char-LM profile: counted flops {meta['flops']:.4e} within "
          f"{HAND_RTOL:.0%} of the hand count {hand:.4e}")
    _crash_drill(net, x, y, name_card)
    del net, x, y
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = deterministic
    try:
        net = resnet50(device="cuda", **RESNET)
        rs = np.random.RandomState(0)
        x = torch.as_tensor(rs.rand(RESNET_BATCH, 224, 224, 3).astype(
            np.float32), device="cuda")
        y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
            rs.randint(0, 1000, RESNET_BATCH)], device="cuda")
        with torch.no_grad():
            acts, _, _ = net._forward(net.params, net.net_state,
                                      {"input": x})
        hand = 3.0 * _forward_flops(net, acts)
        del acts
        _meta, rn_launches = _profile_run("resnet50", net, x, y, hand,
                                          BN_KERNEL_RE, name_card)
    finally:
        torch.backends.cudnn.deterministic = False
    regression_check(name_card)
    return {k: lm_launches.get(k, 0) + rn_launches.get(k, 0)
            for k in lm_launches}


# --------------------------- the conv zoo, pretraining, solvers and MoE
CONV_ZOO = dict(compute_dtype="bfloat16", seed=12345)   # 224x224x3, 1000
CONV_BATCH, CONV_HW = 128, 224
VGG16_PARAMS = 138357544
GOOGLENET_PARAMS = 6998552   # tests/test_torch_zoo_conv.py pins it (JAX's)
CPU_ROWS = 2                 # images (rows) held against a CPU twin
CPU_TOL = 1e-4               # float32 card against CPU, over max |ref|
DBN_BATCH, DBN_BATCHES, DBN_HELD = 128, 24, 4
DBN_EPOCHS = 2
DBN_LBFGS = 10               # the solver fit's iterations
MOE = dict(d=1024, experts=8, hidden=4096, cf=1.25, classes=128)
MOE_ROWS = 8 * 2048          # the char-LM's tokens a batch
MOE_CPU_ROWS = 2048


def _top_kernels(ev, steps, n=4) -> str:
    """The ``n`` device operations that took the most time, ms a step."""
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:n]
    return "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / steps:.3f}"
                     for e in top)


def profiled_step(what, net, x, y, name_card):
    """Two profiled captured steps: host wall, device busy, idle share
    and the top device operations."""
    ev, wall_ms, busy_ms, _ = _profile_fit(net, x, y)
    print(f"{what} [captured] step (profiled, {PROFILED_FIT_STEPS} steps): "
          f"host wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle "
          f"share {1 - busy_ms / wall_ms:.3f}); top device ms a step: "
          f"{_top_kernels(ev, PROFILED_FIT_STEPS)} [{name_card}]")


def _logits(net, inputs):
    """The head's pre-activation of ``inputs`` (no gradient), float32."""
    with torch.no_grad():
        if isinstance(net, ComputationGraph):
            acts, _, _ = net._forward(net.params, net.net_state, inputs)
            return acts[net.conf.outputs[0]].float()
        return net._forward(net.params, inputs)[0].float()


def card_against_cpu(what, net, inputs, rows=CPU_ROWS):
    """The first ``rows`` of ``inputs`` in float32 compute on the card and
    on a CPU twin with the same weights: the logits within ``CPU_TOL`` of
    the largest, and the argmax equal except on a near-tie (top two
    within the paths' difference)."""
    def head(t):
        return {k: v[:rows] for k, v in t.items()} if isinstance(t, dict) \
            else t[:rows]

    conf = net.conf
    net.conf = dataclasses.replace(conf, compute_dtype=None)
    try:
        cpu = _cpu_twin(net)
        got = _logits(net, head(inputs)).cpu()
    finally:
        net.conf = conf
    want = _logits(cpu, _on_cpu(head(inputs)))
    err = _scaled_err(got, want)
    diff = (got - want).abs().max().item()
    gcls, wcls = got.argmax(-1), want.argmax(-1)
    gap = want.max(-1).values - want.gather(1, gcls[:, None])[:, 0]
    ties = ((gcls != wcls) & (gap <= diff)).sum().item()
    agree = (gcls == wcls).sum().item()
    print(f"{what}: float32 logits of {rows} rows, card against CPU: max abs "
          f"err {diff:.3e} over max |logit| {want.abs().max().item():.3f} = "
          f"{err:.3e} (tol {CPU_TOL:g}); argmax agrees on {agree}/{rows}, "
          f"{ties} near-ties")
    check(err <= CPU_TOL, f"{what} card against CPU {err}")
    check(agree + ties == rows, f"{what} argmax card against CPU")
    del cpu


def _on_cpu(t):
    return ({k: v.cpu() for k, v in t.items()} if isinstance(t, dict)
            else t.cpu())


def conv_zoo_phase(what, make, n_params, name_card):
    """VGG-16 or GoogLeNet from the zoo at full width (224x224x3, 1000
    classes, batch 128, bfloat16, Nesterov, ``RandomState(0)`` images in
    [0, 1) and one-hot labels): the parameter count; ``output`` eager
    against captured, bit for bit, one capture; float32 logits on the
    card against a CPU twin; ``fit_modes``' 7 steps a mode (no port
    kernel on the path: the wrappers count nothing), images/s and the
    analytic-FLOP utilisation (3 x the forward's convolutions and dense
    layers); two profiled captured steps."""
    net = make(device="cuda", **CONV_ZOO)
    graph = isinstance(net, ComputationGraph)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(CONV_BATCH, CONV_HW, CONV_HW, 3).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rs.randint(0, 1000, CONV_BATCH)], device="cuda")
    inputs, labels = ({"input": x}, {"fc": y}) if graph else (x, y)
    got = net.num_params()
    print(f"{what}: {got} params ({'ComputationGraph' if graph else 'MultiLayerNetwork'}), "
          f"batch {CONV_BATCH}x{CONV_HW}x{CONV_HW}x3 bf16")
    check(got == n_params, f"{what} params {got} == {n_params}")

    eager = twin(net, False)
    probs = eager.output(inputs)
    check(tuple(probs.shape) == (CONV_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and (probs.sum(-1) - 1).abs().max().item() < 1e-3,
          f"{what} output: finite probabilities of shape "
          f"[{CONV_BATCH}, 1000]")
    cap_probs = [net.output(inputs), net.output(inputs)]
    check(all(torch.equal(p, probs) for p in cap_probs)
          and net._step_graphs.captures == 1,
          f"{what} output: captured == eager bit for bit, one capture")
    print(f"{what} output: captured == eager bit for bit; captures "
          f"{net._step_graphs.captures}, replays {net._step_graphs.replays}")
    del eager, cap_probs, probs
    card_against_cpu(what, net, inputs)

    if graph:
        with torch.no_grad():
            acts, _, _ = net._forward(net.params, net.net_state, inputs)
        fwd = _forward_flops(net, acts)
        del acts
    else:
        fwd = _sequential_flops(net, CONV_BATCH)
    _, rows = fit_modes(f"{what} train", net, [(inputs, labels)], {},
                        name_card, items=CONV_BATCH, flops=3.0 * fwd,
                        peak=PEAK_OPS[torch.bfloat16])
    profiled_step(what, net, inputs, labels, name_card)
    return rows


def vgg16_phase(name_card):
    return conv_zoo_phase("vgg16", vgg16, VGG16_PARAMS, name_card)


def googlenet_phase(name_card):
    return conv_zoo_phase("googlenet", googlenet, GOOGLENET_PARAMS,
                          name_card)


def _rbm_errors(net, params, v):
    """Each RBM's reconstruction error of its input from ``v`` (the
    trained earlier layers feeding it), with the weights of ``params``."""
    out = {}
    for i, layer in enumerate(net.layers):
        if isinstance(layer, RBM):
            h = net._pretrain_feed(i)(v)
            out[layer.name] = float(layer.reconstruction_error(
                params[layer.name], h))
    return out


def dbn_phase(name_card):
    """Zoo ``dbn`` at full width (784 -> 500 -> 250 -> 100 -> 10, float32,
    batch 128, 24 host batches of ``RandomState`` rows in [0, 1)):
    pretraining for two epochs eagerly and through the captured programs
    (one a RBM) from one state, bit for bit; every RBM's weights moved
    and its reconstruction error on a held-out batch fell.  Then an
    ``EarlyStoppingTrainer`` fine-tune (at most 6 epochs, patience 2, the
    loss over 4 held-out batches, the best model in memory, whose
    recomputed score must equal the result's), and one ``fit`` under
    L-BFGS (10 iterations) whose loss must not rise, captured against
    eager bit for bit, with the ms an evaluation of each."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.common import tree_clone

    net = dbn(device="cuda")
    rs = np.random.RandomState(0)
    rows = rs.rand(DBN_BATCHES * DBN_BATCH, 784).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[
        rs.randint(0, 10, DBN_BATCHES * DBN_BATCH)]
    held = rs.rand(DBN_HELD * DBN_BATCH, 784).astype(np.float32)
    held_y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, len(held))]
    batches = [rows[i * DBN_BATCH:(i + 1) * DBN_BATCH]
               for i in range(DBN_BATCHES)]
    print(f"dbn: {net.num_params()} params, {DBN_BATCHES} host batches of "
          f"{DBN_BATCH}x784 float32")
    init = tree_clone(net.params)
    eager = twin(net, False)
    secs = {}
    for label, n in (("eager", eager), ("captured", net)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n.pretrain(batches, epochs=DBN_EPOCHS)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    gaps = state_gaps(net, eager)
    graphs = net._step_graphs
    steps = len([l for l in net.layers if isinstance(l, RBM)]) \
        * DBN_EPOCHS * DBN_BATCHES
    print(f"dbn pretrain: {steps} CD-1 steps, eager {secs['eager'] * 1e3:.1f}"
          f" ms, captured {secs['captured'] * 1e3:.1f} ms (captures "
          f"included); captured against eager: {len(gaps)} leaves differ; "
          f"captures {graphs.captures}, replays {graphs.replays} "
          f"[{name_card}]")
    check(not gaps, f"dbn pretrain: captured == eager bit for bit "
                    f"({sorted(gaps)[:4]})")
    check(graphs.captures == 3 and graphs.replays == steps - 3,
          "dbn pretrain: one capture a RBM")
    v = torch.as_tensor(held[:DBN_BATCH], device="cuda")
    before, after = _rbm_errors(net, init, v), _rbm_errors(net, net.params, v)
    moved = {k: (net.params[k]["W"] - init[k]["W"]).abs().max().item()
             for k in before}
    print(f"dbn pretrain: held-out reconstruction error before -> after "
          + ", ".join(f"{k} {before[k]:.4f} -> {after[k]:.4f}"
                      for k in before)
          + f"; max |dW| {moved}")
    check(all(m > 0 for m in moved.values()), "dbn: every RBM moved")
    check(all(after[k] < before[k] for k in before),
          "dbn: every RBM's reconstruction error fell")
    del eager, init

    # supervised fine-tuning under early stopping, through captured fit
    train = ListDataSetIterator(DataSet(rows, labels), DBN_BATCH)
    val = ListDataSetIterator(DataSet(held, held_y), DBN_BATCH)
    cfg = (es.EarlyStoppingConfiguration.Builder()
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(6),
               es.ScoreImprovementEpochTerminationCondition(2))
           .score_calculator(es.DataSetLossCalculator(val))
           .model_saver(es.InMemoryModelSaver()).build())
    t0 = time.perf_counter()
    result = es.EarlyStoppingTrainer(cfg, net, train).fit()
    t_es = time.perf_counter() - t0
    best = result.best_model
    again = es.DataSetLossCalculator(val).calculate_score(best)
    print(f"dbn early stopping: {result.termination_reason.value} "
          f"({result.termination_details}) after {result.total_epochs} "
          f"epochs in {t_es:.2f} s; scores "
          f"{[round(v, 6) for v in result.score_vs_epoch.values()]}; best "
          f"epoch {result.best_model_epoch}, score "
          f"{result.best_model_score:.6f}, recomputed {again:.6f}; "
          f"captures {net._step_graphs.captures} [{name_card}]")
    check(result.termination_reason
          == es.TerminationReason.EPOCH_TERMINATION_CONDITION,
          "dbn early stopping: an epoch condition ended it")
    check(best is not None and abs(again - result.best_model_score)
          <= 1e-6 * abs(result.best_model_score),
          "dbn early stopping: the best model's score reproduces")

    # one full-batch L-BFGS fit of the fine-tuned net, captured and eager
    net.conf = dataclasses.replace(net.conf, optimization_algo="lbfgs",
                                   num_iterations=DBN_LBFGS)
    eager = twin(net, False)
    xb, yb = batches[0], labels[:DBN_BATCH]
    x2, y2 = batches[1], labels[DBN_BATCH:2 * DBN_BATCH]
    s0 = net.score(xb, yb)
    ms = {}
    for label, n in (("eager", eager), ("captured", net)):
        n.fit(xb, yb)
        first = n.score_value
        graphs = cap_counts(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n.fit(x2, y2)
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3
        if label == "captured":
            evals = cap_counts(n)[1] - graphs[1]
        if label == "eager":
            e_first, e_second = first, n.score_value
    gaps = state_gaps(net, eager)
    print(f"dbn lbfgs: loss {s0:.6f} -> {first:.6f} ({DBN_LBFGS} "
          f"iterations), then {net.score_value:.6f} on the next batch; "
          f"{evals} evaluations: {ms['captured'] / evals:.4f} ms each "
          f"captured, {ms['eager'] / evals:.4f} eager; captured against "
          f"eager {len(gaps)} leaves differ, losses "
          f"{'equal' if (first, net.score_value) == (e_first, e_second) else 'differ'}"
          f"; solver captures {cap_counts(net)[0]} [{name_card}]")
    check(first <= s0, "dbn lbfgs: the loss did not rise")
    check(not gaps and (first, net.score_value) == (e_first, e_second),
          "dbn lbfgs: captured value/grad == eager bit for bit")
    check(cap_counts(net)[0] == 1, "dbn lbfgs: one solver capture")
    solver_split(net, ms["captured"] / evals, name_card)
    return ms


def solver_split(net, per_eval_ms, name_card, reps=20):
    """Where an L-BFGS evaluation's time goes: the captured value/grad
    program's replay on the card (CUDA events), the loss and float64
    gradient's copy to the host after it, and the rest (the host's
    float64 line search and two-loop recursion, the vector's staging)."""
    prog = next(p for k, p in net._graph_cache.items() if k[0] == "solver")
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    prog.graph.replay()
    s.record()
    for _ in range(reps):
        prog.graph.replay()
    e.record()
    e.synchronize()
    replay_ms = s.elapsed_time(e) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        float(prog.out[0])
        prog.out[1].to("cpu", torch.float64)
    copy_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"dbn lbfgs evaluation: {per_eval_ms:.4f} ms, of which the "
          f"replay {replay_ms:.4f} ms on the card, the loss and "
          f"{prog.out[1].numel()}-float gradient to the host {copy_ms:.4f} "
          f"ms, the host's solver math and staging the remaining "
          f"{per_eval_ms - replay_ms - copy_ms:.4f} ms [{name_card}]")


def cap_counts(net):
    """(captures, replays) of the net's solver programs."""
    g = net._step_graphs
    if g is None:
        return 0, 0
    n = sum(1 for k, p in g.programs.items()
            if k[0] == "solver" and p.graph is not None)
    return n, g.replays


def moe_phase(name_card):
    """The reference's MoE test net (``tests/test_model_parallel.py:112``)
    at the char-LM's width: Dense(1024 -> 1024, relu), MoELayer(1024, 8
    experts, hidden 4096, capacity factor 1.25), Output(1024 -> 128), in
    bfloat16 under Adam, over the char-LM's 8 x 2048 = 16384 rows
    (``RandomState(0)`` normal features, random one-hot labels).  The
    routing on the card: every expert's kept load at most C = 2560, the
    int32 positions equal numpy's count of the router's choices, the
    dropped tokens equal numpy's recount.  ``output`` eager against
    captured, bit for bit; the first 2048 rows (routed on their own) in
    float32 on the card against a CPU twin; ``fit_modes``, with the peak
    memory."""
    m = MOE
    b = (NeuralNetConfiguration.builder().seed(12345)
         .updater("adam", learning_rate=1e-3).list())
    b.compute_dtype("bfloat16")
    conf = (b.layer(DenseLayer(n_in=m["d"], n_out=m["d"], activation="relu"))
            .layer(MoELayer(n_in=m["d"], n_out=m["d"],
                            num_experts=m["experts"], hidden=m["hidden"],
                            capacity_factor=m["cf"]))
            .layer(OutputLayer(n_in=m["d"], n_out=m["classes"],
                               loss="mcxent", activation="softmax"))
            .build())
    net = MultiLayerNetwork(conf).init("cuda")
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(MOE_ROWS, m["d"]).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(np.eye(m["classes"], dtype=np.float32)[
        rs.randint(0, m["classes"], MOE_ROWS)], device="cuda")
    layer = net.layers[1]
    C = layer.capacity(MOE_ROWS)
    print(f"moe: {net.num_params()} params, {m['experts']} experts of "
          f"{m['d']} -> {m['hidden']}, {MOE_ROWS} rows bf16, capacity {C}")

    # the routing, on the MoE layer's own bfloat16 input
    h = net.feed_forward(x)[0].to(torch.bfloat16)
    p = cast_tree(net.params[layer.name], torch.bfloat16)
    r = layer.route(p, h)
    e = r.expert.cpu().numpy()
    exact = (np.cumsum(np.eye(m["experts"], dtype=np.int64)[e], 0) - 1)[
        np.arange(MOE_ROWS), e]
    load = np.bincount(e, minlength=m["experts"])
    kept = np.bincount(e[r.kept.cpu().numpy()], minlength=m["experts"])
    dropped = int(np.maximum(load - C, 0).sum())
    print(f"moe routing: loads {load.tolist()}, kept {kept.tolist()} (C "
          f"{C}), dropped {int((~r.kept).sum())} (numpy {dropped}), "
          f"positions int32 {r.pos.dtype == torch.int32}")
    check(r.capacity == C == 2560 and int(kept.max()) <= C,
          "moe: every expert's load within its capacity")
    check(np.array_equal(r.pos.cpu().numpy(), exact),
          "moe: positions equal numpy's exact count")
    check(int((~r.kept).sum()) == dropped
          and np.array_equal(r.kept.cpu().numpy(), exact < C),
          "moe: the dropped tokens equal numpy's recount")
    del h, p, r

    eager = twin(net, False)
    probs = eager.output(x)
    cap_probs = [net.output(x), net.output(x)]
    check(bool(torch.isfinite(probs).all())
          and all(torch.equal(q, probs) for q in cap_probs)
          and net._step_graphs.captures == 1,
          "moe output: captured == eager bit for bit, one capture")
    print("moe output: captured == eager bit for bit, one capture")
    del eager, cap_probs, probs
    card_against_cpu("moe", net, x, rows=MOE_CPU_ROWS)

    dense = 2 * m["d"] * (m["d"] + m["classes"] + m["experts"])
    experts = 2 * 2 * m["d"] * m["hidden"] * m["experts"] * C
    fwd = dense * MOE_ROWS + experts
    _, rows = fit_modes("moe train", net, [(x, y)], {}, name_card,
                        items=MOE_ROWS, flops=3.0 * fwd,
                        peak=PEAK_OPS[torch.bfloat16], unit="rows")
    profiled_step("moe", net, x, y, name_card)
    print(f"moe: peak memory captured {rows['captured']['peak_gb']:.2f} GB, "
          f"eager {rows['eager']['peak_gb']:.2f} GB [{name_card}]")
    return rows


# --------------------------------------------- phases 20-22, the data path
ETL_TRAIN, ETL_TEST = 60000, 10000      # MNIST's split (LeCun's files)
ETL_SEED = 7                            # the batchers' shuffle seed
ETL_EPOCHS = 2
ETL_ACCURACY = 0.85
ETL_RESNET_BATCHES, ETL_RESNET_PASSES = 8, 2
CSV_ROWS, CSV_BATCH = 100_000, 12_500   # 8 batches of the whole file
CSV_WIDTH = 256


def _sse_client(port, sid, stop, connected, seen):
    """Count the ``data:`` events of ``/train/stream?sid=`` until
    ``stop``; ``connected`` is set once the server has registered the
    stream (its headers come after ``add_listener``)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", f"/train/stream?sid={sid}")
        resp = conn.getresponse()
        connected.set()
        while not stop.is_set():
            line = resp.fp.readline()     # heartbeats come every second
            if not line:
                break
            if line.startswith(b"data: "):
                seen["events"] += 1
    finally:
        conn.close()


class _Timed:
    """A callable's calls, counted and timed on the host."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1

    def ms(self):
        return self.seconds * 1e3 / max(self.calls, 1)


def _poller(port, sid, stop, seen, every_s=0.25):
    """Poll ``/train/overview?sid=`` until ``stop``, keeping each answer's
    status (and the iterations a 200 saw) and any exception in ``seen``;
    it never raises, so the phase checks them after the join."""
    while not stop.wait(every_s):
        try:
            status, obj, _ = _http_json(
                port, "GET", f"/train/overview?sid={sid}", timeout=30)
            seen["statuses"].append(status)
            if status == 200:
                seen["latest"] = len(obj["iterations"])
        except Exception as e:
            seen["errors"].append(repr(e))
            return


def etl_lenet_phase(name_card, exact):
    """LeNet-MNIST through the data path: a full-size MNIST (60000 train,
    10000 t10k synthetic glyphs) written as IDX files with ``write_idx``,
    read by ``MnistDataSetIterator`` (the native IDX parser), batched by
    ``NativeBatchDataSetIterator`` (128, shuffled: 468 full batches and
    one of 96 padded under a labels mask) into captured ``fit`` for two
    epochs, four nets from one seed: with a ``StatsListener`` into a
    ``FileStatsStorage`` while a ``UIServer`` on it serves one SSE client
    on ``/train/stream`` and one poller on ``/train/overview``; without
    them; fed by the batcher's plain version; and fed the same epoch's
    batches already on the card (``resident``).  Each epoch of each net
    is timed the same way, from its ``fit`` call to its last loss.  The
    four end each epoch bit for bit equal (``cudnn.deterministic`` where
    the lenet phase needed it), each captures the full and the masked
    signature in its first epoch and nothing in its second, the SSE
    events equal the stored reports, every overview poll answers 200 and
    a last one sees every report, and ``evaluate`` on t10k exceeds
    0.85."""
    import shutil
    import tempfile
    from pathlib import Path

    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import (
        MnistDataSetIterator, NativeBatchDataSetIterator, mnist,
    )
    from deeplearning4j_tpu_torch.ui import (
        FileStatsStorage, StatsListener, UIServer,
    )

    root = Path(tempfile.mkdtemp(prefix="etl_lenet_"))
    stop = threading.Event()
    ui, threads = None, []
    try:
        t0 = time.perf_counter()
        for split, n, seed in (("train", ETL_TRAIN, 123),
                               ("t10k", ETL_TEST, 124)):
            imgs, labels = mnist._synthetic_mnist(n, seed)
            mnist.write_idx(root / f"{split}-images-idx3-ubyte",
                            np.round(imgs * 255.0).astype(np.uint8))
            mnist.write_idx(root / f"{split}-labels-idx1-ubyte",
                            labels.astype(np.uint8))
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = MnistDataSetIterator(LENET_BATCH, data_dir=str(root))
        parse_s = time.perf_counter() - t0
        test = MnistDataSetIterator(LENET_BATCH, train=False,
                                    data_dir=str(root))
        data = train.dataset()
        check(not train.is_synthetic and not test.is_synthetic,
              "etl_lenet: the IDX files were read, not synthesized")
        check(data.features.shape == (ETL_TRAIN, 784)
              and test.dataset().features.shape == (ETL_TEST, 784),
              "etl_lenet: MNIST's shapes")
        raw = (root / "train-images-idx3-ubyte").read_bytes()
        t0 = time.perf_counter()
        native.parse_idx_images(raw)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = native.parse_idx_images(raw, force_python=True)
        plain_s = time.perf_counter() - t0
        check(np.array_equal(plain, data.features),
              "etl_lenet: native IDX parse == plain bit for bit")
        del plain, raw
        print(f"etl_lenet: glyphs and IDX files {gen_s:.2f} s; "
              f"MnistDataSetIterator (read and native parse of "
              f"{ETL_TRAIN} images and labels) {parse_s:.3f} s; the images "
              f"alone "
              f"native {nat_s * 1e3:.1f} ms ({ETL_TRAIN / nat_s:.0f} "
              f"images/s, {data.features.nbytes / nat_s / 1e9:.2f} GB/s "
              f"of float32) against plain {plain_s * 1e3:.1f} ms "
              f"[{name_card}]")

        storage = FileStatsStorage(str(root / "stats.jsonl"))
        sid = "etl_lenet"
        nets = {k: lenet(device="cuda")
                for k in ("dashboard", "native", "plain", "resident")}
        check(not state_gaps(nets["dashboard"], nets["plain"]),
              "etl_lenet: the three nets start equal")
        # the dashboard's host time: the listener's report, and of it the
        # storage's JSON line, write and fan-out to the SSE stream
        listener = StatsListener(storage, session_id=sid)
        listener.iteration_done = report = _Timed(listener.iteration_done)
        storage.put_update = stored_ms = _Timed(storage.put_update)
        nets["dashboard"].set_listeners(listener)
        feeds = {k: NativeBatchDataSetIterator(
            data, LENET_BATCH, seed=ETL_SEED, force_python=(k == "plain"))
            for k in nets}
        ui = UIServer(storage)
        port = ui.start()
        connected = threading.Event()
        seen = {"events": 0, "statuses": [], "errors": [], "latest": 0}
        threads = [threading.Thread(target=_sse_client, daemon=True,
                                    args=(port, sid, stop, connected, seen)),
                   threading.Thread(target=_poller, daemon=True,
                                    args=(port, sid, stop, seen))]
        for t in threads:
            t.start()
        check(connected.wait(30), "etl_lenet: the SSE client connected")
        steps = -(-ETL_TRAIN // LENET_BATCH)
        walls = {k: [] for k in nets}
        caps = {k: [] for k in nets}
        torch.backends.cudnn.deterministic = not exact
        try:
            for epoch in range(ETL_EPOCHS):
                for k, net in nets.items():
                    feed = feeds[k]
                    if k == "resident":     # this epoch's batches, on the card
                        feed = [tuple(None if a is None else
                                      torch.as_tensor(a, device="cuda")
                                      for a in (b.features, b.labels,
                                                b.features_mask,
                                                b.labels_mask))
                                for b in feed]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    net.fit(feed)
                    float(net.score_value)      # waits for the last step
                    walls[k].append(time.perf_counter() - t0)
                    caps[k].append(net._step_graphs.captures)
                for k in ("native", "plain", "resident"):
                    gaps = state_gaps(nets["dashboard"], nets[k])
                    check(not gaps and nets[k].score_value
                          == nets["dashboard"].score_value,
                          f"etl_lenet epoch {epoch}: {k} == dashboard bit "
                          f"for bit ({sorted(gaps)[:4]})")
        finally:
            torch.backends.cudnn.deterministic = False
        stored = len(storage.get_updates(sid))
        deadline = time.perf_counter() + 30
        while seen["events"] < stored and time.perf_counter() < deadline:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=40)
        check(not any(t.is_alive() for t in threads),
              "etl_lenet: the SSE client and the poller ended")
        status, obj, _ = _http_json(port, "GET",
                                    f"/train/overview?sid={sid}", timeout=30)
        last = len(obj["iterations"]) if status == 200 else None
        ui.stop()
        ev = nets["dashboard"].evaluate(test)
        acc = ev.accuracy()
        ms = {k: [w * 1e3 / steps for w in v] for k, v in walls.items()}
        print(f"etl_lenet: {ETL_EPOCHS} epochs of {steps} steps (batch "
              f"{LENET_BATCH}, the last {ETL_TRAIN % LENET_BATCH} rows "
              f"padded) each net; epoch walls (s) "
              + "; ".join(f"{k} " + ", ".join(f"{w:.3f}" for w in v)
                          for k, v in walls.items())
              + f" [{name_card}]")
        print(f"etl_lenet: ms a step, second epoch: with the listener and "
              f"dashboard {ms['dashboard'][-1]:.4f}, without "
              f"{ms['native'][-1]:.4f} (the dashboard's cost "
              f"{ms['dashboard'][-1] - ms['native'][-1]:+.4f}), the plain "
              f"batcher {ms['plain'][-1]:.4f}, the epoch's batches on the "
              f"card before the epoch {ms['resident'][-1]:.4f}; the "
              f"listener's report {report.ms():.4f} ms on the host "
              f"({report.calls} reports), of it the storage's "
              f"put_update {stored_ms.ms():.4f} [{name_card}]")
        print(f"etl_lenet: captures after each epoch {caps}; reports "
              f"stored {stored}, SSE events received {seen['events']}; "
              f"overview polls {len(seen['statuses'])} answered "
              f"{sorted(set(seen['statuses']))}, errors {seen['errors']}, "
              f"the last during the fit saw {seen['latest']} iterations, "
              f"the one after it {last}; t10k accuracy {acc:.4f} over "
              f"{ETL_TEST} images")
        for k, c in caps.items():
            check(c == [2] * ETL_EPOCHS, f"etl_lenet {k}: the full and the "
                                         f"masked signature only ({c})")
        check(stored == ETL_EPOCHS * steps, f"etl_lenet: {stored} reports")
        check(seen["events"] == stored,
              f"etl_lenet: SSE events {seen['events']} == reports {stored}")
        check(seen["statuses"] and not seen["errors"]
              and all(c == 200 for c in seen["statuses"]),
              f"etl_lenet: every overview poll answered 200 "
              f"({sorted(set(seen['statuses']))}, {seen['errors']})")
        check(last == stored, f"etl_lenet: the overview after the fit "
                              f"saw {last} of {stored} reports")
        check(acc > ETL_ACCURACY, f"etl_lenet: t10k accuracy {acc}")
        for f in feeds.values():
            f.close()
        return dict(ms=ms, parse_s=parse_s, accuracy=acc)
    finally:
        stop.set()
        if ui is not None:
            ui.stop()
        shutil.rmtree(root, ignore_errors=True)


class _Losses:
    """A listener keeping each step's loss on the device (no sync)."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration):
        self.losses.append(model._score)


def etl_resnet_phase(name_card, deterministic):
    """ResNet-50 (bf16, batch 128) fed from files: 8 batches of
    128x224x224x3 float32 written by ``export_datasets`` as ``D4JT``
    files, read back by ``FileDataSetIterator`` (as NHWC images) behind
    an ``AsyncDataSetIterator`` into captured ``fit`` for two passes;
    twins from the same state fed the same batches from host memory and
    from the card's memory end with the same per-step losses and state
    bit for bit.  Each feed's pass is timed the same way (fit call to
    last loss) and profiled once more (idle share).  Returns the
    BatchNorm training kernels' wrapper launches of the file-fed run."""
    import shutil
    import tempfile
    from pathlib import Path

    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, DataSet, FileDataSetIterator,
        ListDataSetIterator, export_datasets,
    )

    class ImageFiles(FileDataSetIterator):
        """The exported batches as NHWC images (the container keeps each
        row flat; the reshape is a view)."""

        def next(self):
            ds = super().next()
            return DataSet(ds.features.reshape(-1, 224, 224, 3), ds.labels,
                           ds.features_mask, ds.labels_mask)

    n = ETL_RESNET_BATCHES * RESNET_BATCH
    root = Path(tempfile.mkdtemp(prefix="etl_resnet_"))
    try:
        gen = np.random.default_rng(1)
        x = gen.random((n, 224, 224, 3), dtype=np.float32)
        y = np.eye(1000, dtype=np.float32)[gen.integers(0, 1000, n)]
        t0 = time.perf_counter()
        paths = export_datasets(ListDataSetIterator(DataSet(x, y),
                                                    RESNET_BATCH), root)
        write_s = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in paths)
        check(len(paths) == ETL_RESNET_BATCHES, "etl_resnet: 8 files")
        t0 = time.perf_counter()
        for p in paths:
            native.read_dataset(p)
        read_s = time.perf_counter() - t0
        print(f"etl_resnet: export_datasets wrote {len(paths)} D4JT files, "
              f"{size / 1e6:.1f} MB, in {write_s:.3f} s "
              f"({size / write_s / 1e9:.2f} GB/s); read_dataset alone "
              f"{read_s * 1e3 / len(paths):.1f} ms a file "
              f"({size / read_s / 1e9:.2f} GB/s, warm page cache) "
              f"[{name_card}]")
        net = resnet50(device="cuda", **RESNET)
        nets = {"files": net, "memory": twin(net, True),
                "device": twin(net, True)}
        batches = [(x[i * RESNET_BATCH:(i + 1) * RESNET_BATCH],
                    y[i * RESNET_BATCH:(i + 1) * RESNET_BATCH])
                   for i in range(ETL_RESNET_BATCHES)]
        logs = {k: _Losses() for k in nets}
        for k, m in nets.items():
            m.set_listeners(logs[k])
        feeds = {"files": AsyncDataSetIterator(ImageFiles(root), 2),
                 "memory": batches,
                 "device": [tuple(torch.as_tensor(a, device="cuda")
                                  for a in b) for b in batches]}
        walls = {k: [] for k in feeds}
        torch.backends.cudnn.deterministic = deterministic
        try:
            for k, m in nets.items():
                if k == "files":
                    for c in helpers.kernel_counts().values():
                        c.reset()
                for _ in range(ETL_RESNET_PASSES):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m.fit(feeds[k])
                    float(m.score_value)
                    walls[k].append(time.perf_counter() - t0)
                if k == "files":
                    counts = _launch_counts()
            losses = {k: torch.stack(v.losses).float().cpu()
                      for k, v in logs.items()}
            gaps = {k: state_gaps(net, nets[k]) for k in ("memory", "device")}
            prof = {k: _profile_fit(m, feeds[k], steps=1, warmup=False)[1:3]
                    for k, m in nets.items()}
        finally:
            torch.backends.cudnn.deterministic = False
        steps = ETL_RESNET_BATCHES
        print(f"etl_resnet: {ETL_RESNET_PASSES} passes of {steps} steps a "
              f"feed, each pass timed from its fit call to its last loss; "
              f"pass walls (s) "
              + "; ".join(f"{k} " + ", ".join(f"{w:.3f}" for w in v)
                          for k, v in walls.items())
              + "; ms a step (second pass) "
              + ", ".join(f"{k} {walls[k][-1] * 1e3 / steps:.3f}"
                          for k in walls)
              + f" (device: the batches on the card before the pass) "
              f"[{name_card}]")
        print("etl_resnet: profiled pass, host wall / device busy ms a step "
              "(idle share): " + "; ".join(
                  f"{k} {w / steps:.3f} / {b / steps:.3f} ({1 - b / w:.3f})"
                  for k, (w, b) in prof.items()) + f" [{name_card}]")
        print(f"etl_resnet: losses files {losses['files'].tolist()}; "
              f"leaves differing from the file-fed net: "
              f"{ {k: len(g) for k, g in gaps.items()} }; captures "
              f"{ {k: m._step_graphs.captures for k, m in nets.items()} }; "
              f"wrapper launches {dict((k, v[0]) for k, v in counts.items() if v[0])}")
        check(losses["files"].shape[0] == steps * ETL_RESNET_PASSES,
              "etl_resnet: a loss a step")
        for k in ("memory", "device"):
            check(torch.equal(losses["files"], losses[k]) and not gaps[k],
                  f"etl_resnet: files == {k} bit for bit "
                  f"({sorted(gaps[k])[:4]})")
        check(all(m._step_graphs.captures == 1 for m in nets.values()),
              "etl_resnet: one capture a net")
        check(all(p == 0 for _, p in counts.values()),
              f"etl_resnet: plain-version calls {counts}")
        want = {"bn_train_fwd": 2 * RESNET_BN_LAYERS,
                "bn_train_bwd": 2 * RESNET_BN_LAYERS}
        got = {k: l for k, (l, _) in counts.items() if l}
        check(got == want, f"etl_resnet: launches {got} == {want}")
        return got
    finally:
        shutil.rmtree(root, ignore_errors=True)


def multidataset_phase(name_card):
    """Native CSV parsing into a two-input, two-output graph: a CSV of
    100000 rows (4 + 3 features, a class of 3, 2 targets) parsed by the
    native parser (rows/s) and equal to the plain parse; then
    ``RecordReaderMultiDataSetIterator`` over a ``CSVRecordReader`` of
    it feeds a ``ComputationGraph`` (two dense branches of 256, merged;
    softmax and mse heads) 8 captured steps of 12500 rows, equal to an
    eager twin fed the same batches bit for bit."""
    import io

    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import (
        RecordReaderMultiDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.datavec import CSVRecordReader
    from deeplearning4j_tpu_torch.models.vertices import MergeVertex

    rs = np.random.RandomState(5)
    table = np.concatenate([rs.randn(CSV_ROWS, 7), rs.randint(
        0, 3, (CSV_ROWS, 1)), rs.randn(CSV_ROWS, 2)], 1)
    buf = io.BytesIO()
    np.savetxt(buf, table, fmt="%.6g", delimiter=",")
    data = b"a0,a1,a2,a3,b0,b1,b2,cls,r0,r1\n" + buf.getvalue()
    t0 = time.perf_counter()
    m = native.csv_to_matrix(data, skip_lines=1)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = native.csv_to_matrix(data, skip_lines=1, force_python=True)
    plain_s = time.perf_counter() - t0
    check(m.shape == (CSV_ROWS, 10) and np.array_equal(m, plain),
          "multidataset: native CSV == plain bit for bit")
    print(f"multidataset: CSV of {CSV_ROWS} rows, {len(data) / 1e6:.2f} MB: "
          f"native {nat_s * 1e3:.1f} ms ({CSV_ROWS / nat_s:.0f} rows/s), "
          f"plain {plain_s * 1e3:.1f} ms ({CSV_ROWS / plain_s:.0f} rows/s) "
          f"[{name_card}]")

    def records():
        reader = CSVRecordReader(skip_lines=1).initialize(data)
        return (RecordReaderMultiDataSetIterator.builder(CSV_BATCH)
                .add_reader("csv", reader)
                .add_input("csv", 0, 3).add_input("csv", 4, 6)
                .add_output_one_hot("csv", 7, 3).add_output("csv", 8, 9)
                .build())

    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater("adam", learning_rate=1e-3).graph()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_in=4, n_out=CSV_WIDTH,
                                        activation="relu"), "a")
            .add_layer("db", DenseLayer(n_in=3, n_out=CSV_WIDTH,
                                        activation="relu"), "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("cls", OutputLayer(n_in=2 * CSV_WIDTH, n_out=3,
                                          loss="mcxent",
                                          activation="softmax"), "m")
            .add_layer("reg", OutputLayer(n_in=2 * CSV_WIDTH, n_out=2,
                                          loss="mse", activation="identity"),
                       "m")
            .set_outputs("cls", "reg").build())
    net = ComputationGraph(conf).init(device="cuda")
    eager = twin(net, False)
    t0 = time.perf_counter()
    net.fit(records())
    loss = net.score_value
    fed_s = time.perf_counter() - t0
    steps = CSV_ROWS // CSV_BATCH
    batches = list(records())
    eager.fit(batches)
    gaps = state_gaps(net, eager)
    graphs = net._step_graphs
    print(f"multidataset: {steps} captured steps of {CSV_BATCH} rows "
          f"through RecordReaderMultiDataSetIterator in {fed_s:.3f} s "
          f"({CSV_ROWS / fed_s:.0f} rows/s, iterator and steps), last loss "
          f"{loss:.6f}; captures {graphs.captures}, replays "
          f"{graphs.replays}; against the eager twin {len(gaps)} leaves "
          f"differ [{name_card}]")
    check(len(batches) == steps and net.iteration == steps,
          "multidataset: 8 batches, 8 steps")
    check(graphs.captures == 1 and graphs.replays == steps - 1,
          "multidataset: one capture")
    check(np.isfinite(loss) and not gaps
          and loss == eager.score_value,
          f"multidataset: captured == eager bit for bit ({sorted(gaps)[:4]})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    name_card = card()
    print(name_card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    pin_fp32_precision()
    t0 = time.perf_counter()
    build_kernels()
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = kernel_phase(flush, name_card)
    flash, flash_f32, prologue = train_kernel_phase(flush, name_card)
    bn_rows = bn_kernel_phase(flush, name_card)
    lrn_rows = lrn_kernel_phase(flush, name_card)
    del flush
    torch.cuda.empty_cache()
    launches = engine_phase(name_card)
    torch.cuda.empty_cache()
    generate_phases(name_card)
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    launches += prefix_phase(name_card)
    torch.cuda.empty_cache()
    swap_phase(name_card)
    torch.cuda.empty_cache()
    t_new = time.perf_counter() - t_new
    train_launches = train_phase(name_card)
    torch.cuda.empty_cache()
    f32_launches = train_phase(name_card, TRAIN_MODEL_F32, "train_f32")
    torch.cuda.empty_cache()
    bn_launches = resnet_phase(name_card)
    torch.cuda.empty_cache()
    t_serve = time.perf_counter()
    serving_phase(name_card)
    torch.cuda.empty_cache()
    t_new += time.perf_counter() - t_serve
    lrn_launches = alexnet_phase(name_card)
    torch.cuda.empty_cache()
    _, lenet_exact = lenet_phase(name_card)
    torch.cuda.empty_cache()
    lstm_phase(name_card)
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    served = server_phase(name_card)
    torch.cuda.empty_cache()
    guarded, deterministic = guard_phase(name_card)
    resume_phase(name_card, deterministic)
    t_slice = time.perf_counter() - t_slice
    torch.cuda.empty_cache()
    t_online = time.perf_counter()
    online = online_phase(name_card, deterministic)
    torch.cuda.empty_cache()
    intro = introspection_phase(name_card)
    torch.cuda.empty_cache()
    _, f64_rel = kerneldiff_phase(name_card)
    t_online = time.perf_counter() - t_online
    torch.cuda.empty_cache()
    t_fleet = time.perf_counter()
    fleet = fleet_phase(name_card)
    torch.cuda.empty_cache()
    profiled = profiling_phase(name_card, deterministic)
    torch.cuda.empty_cache()
    t_fleet = time.perf_counter() - t_fleet
    t_zoo = time.perf_counter()
    for phase in (vgg16_phase, googlenet_phase, dbn_phase, moe_phase):
        phase(name_card)
        torch.cuda.empty_cache()
    t_zoo = time.perf_counter() - t_zoo
    t_etl = time.perf_counter()
    etl_lenet_phase(name_card, lenet_exact)
    torch.cuda.empty_cache()
    etl_bn = etl_resnet_phase(name_card, deterministic)
    torch.cuda.empty_cache()
    multidataset_phase(name_card)
    torch.cuda.empty_cache()
    t_etl = time.perf_counter() - t_etl
    # the new phases' profiled launches join the kernels line's
    launches += served["paged"]
    train_launches = [n + guarded[k] for n, k in zip(
        train_launches, ("flash_fwd", "flash_dq", "flash_dkv", "prologue"))]
    train_launches[3] += served["prologue"]
    bn_launches = (bn_launches[0] + served["bn_inference"],
                   bn_launches[1] + guarded["bn_train_fwd"],
                   bn_launches[2] + guarded["bn_train_bwd"])
    # the online and introspection phases' wrapper launches (counted
    # where a launch is made or recorded into a graph)
    train_launches = [n + intro[k] for n, k in zip(
        train_launches, ("flash_fwd", "flash_dq", "flash_dkv", "prologue"))]
    bn_launches = tuple(n + online[k] for n, k in zip(
        bn_launches, ("bn_inference", "bn_train_fwd", "bn_train_bwd")))
    # the fleet's replicas' replays and its in-process engines' captures
    # (paged decode, prologue); the profiled runs' wrapper launches
    launches += fleet["paged_decode"]
    train_launches[3] += fleet["prologue"]
    train_launches = [n + profiled[k] for n, k in zip(
        train_launches, ("flash_fwd", "flash_dq", "flash_dkv", "prologue"))]
    bn_launches = tuple(n + profiled[k] for n, k in zip(
        bn_launches, ("bn_inference", "bn_train_fwd", "bn_train_bwd")))
    # the file-fed ResNet-50's wrapper launches (its warm-up and capture)
    bn_launches = (bn_launches[0], bn_launches[1] + etl_bn["bn_train_fwd"],
                   bn_launches[2] + etl_bn["bn_train_bwd"])
    d = rows["decode"]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/helpers/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/helpers/paged_attention.py:191",
        "launches": launches, "max_abs_err": d["err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["lib_ms"]}]
    flash_src = "deeplearning4j_tpu_torch/helpers/csrc/flash_attention.cu"
    # the bfloat16 char-LM's kernels, then the float32 char-LM's (the
    # launches of the float32 fit phase, all three on tf32x3)
    for (name, row, replaces), n in zip([
            ("flash_attention_fwd", flash["fwd"], "flash_attention.py:125"),
            ("flash_attention_dq", flash["dq"], "flash_attention.py:244"),
            ("flash_attention_dkv", flash["dkv"], "flash_attention.py:271"),
            ("dropout_residual_norm", prologue, "fused_epilogue.py:62"),
            ("flash_attention_fwd_f32", flash_f32["fwd"],
             "flash_attention.py:125"),
            ("flash_attention_dq_f32", flash_f32["dq"],
             "flash_attention.py:244"),
            ("flash_attention_dkv_f32", flash_f32["dkv"],
             "flash_attention.py:271")],
            list(train_launches) + list(f32_launches[:3])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": (flash_src if name.startswith("flash") else
                       "deeplearning4j_tpu_torch/helpers/csrc/"
                       "fused_epilogue.cu"),
            "replaces": f"deeplearning4j_tpu/helpers/{replaces}",
            "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["lib_ms"],
            **({"path": row["path"]} if "path" in row else {})})
    stem = bn_rows["stem_bf16"]
    for (name, key, line), n in zip([
            ("batch_norm_inference", "inf", 131),
            ("batch_norm_train_fwd", "fwd", 188),
            ("batch_norm_train_bwd", "bwd", 204)], bn_launches):
        row = stem[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/helpers/csrc/batch_norm.cu",
            "replaces": f"deeplearning4j_tpu/helpers/pallas_ops.py:{line}",
            "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["lib_ms"]})
    lrn1 = lrn_rows["lrn1_bf16"]
    for (name, key, line), n in zip([("lrn_fwd", "fwd", 65),
                                     ("lrn_bwd", "bwd", 72)], lrn_launches):
        row = lrn1[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/helpers/csrc/lrn.cu",
            "replaces": f"deeplearning4j_tpu/helpers/pallas_ops.py:{line}",
            "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["lib_ms"]})
    # each forward kernel's max-rel against the float64 references at
    # its path's shapes (the backward kernels: held against their plain
    # versions only, as in the reference's sweep)
    f64 = {"paged_decode_attention": ("paged_decode_attention", "bfloat16"),
           "flash_attention_fwd": ("flash_attention_fwd", "bfloat16"),
           "flash_attention_fwd_f32": ("flash_attention_fwd", "float32"),
           "dropout_residual_norm": ("dropout_residual_norm", "bfloat16"),
           "batch_norm_inference": ("batch_norm_inference", "bfloat16"),
           "batch_norm_train_fwd": ("batch_norm_train_fwd", "bfloat16"),
           "lrn_fwd": ("lrn_fwd", "bfloat16")}
    for k in kernels:
        k["f64_max_rel"] = (f64_rel.get(f64[k["name"]])
                            if k["name"] in f64 else None)
    print(f"total {time.perf_counter() - t0:.1f} s (the prefix, swap and "
          f"serving phases {t_new:.1f} s; the server, guard and resume "
          f"phases {t_slice:.1f} s; the online, introspection and "
          f"kerneldiff phases {t_online:.1f} s; the fleet and profiling "
          f"phases {t_fleet:.1f} s; the vgg16, googlenet, dbn and moe "
          f"phases {t_zoo:.1f} s; the etl_lenet, etl_resnet and "
          f"multidataset phases {t_etl:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
