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
23. Data parallelism over slots of the card (``backend/mesh.py``:
   ``default_mesh(data=4, devices=["cuda"] * 4)``), parallel_wrapper:
   the flash trio and the prologue first held against their plain
   versions at a replica's shapes (``[2, 2048, 8, 128]``, ``[4096,
   1024]``); then ``ParallelWrapper(net, workers=4)`` on the full-width
   bf16 char-LM, Adam, a replica a 2 x 2048 batch (a window step covers
   the bench's 8 x 2048), ``averaging_frequency`` 1 and 3, two windows
   each, captured (one window graph holding F x 4 replicas' launches:
   8 of each flash kernel and 16 prologue a replica and minibatch) and
   eager, equal bit for bit; held against four single nets' ``fit`` on
   the same batches, averaged each window (the reference's
   ``test_parallel.py`` oracle), on the float32 master weights within
   ``rtol=1e-5, atol=1e-6``; ms a window, tokens/s, and the window
   capture's growth of its graph pool against one single-net step's
   peak (the pool reuses one replica's activations for the next).
24. zero: the wrapper with ``update_sharding="zero"`` over the same two
   windows, within the reference's ``test_zero.py`` tolerance of the
   replicated run; the sharding ledger's updater replication 4 -> 1; the
   peak allocated bytes against replicated's; the window's collective
   census (on one card a census of what four cards would move, not link
   traffic).
25. checkpoint_sharded: the ZeRO wrapper (two windows in) saved with
   ``mesh=`` (every slot's block, its spec), restored onto a two-slot
   mesh and into a single net (bit for bit); a fresh ZeRO wrapper on the
   restored net takes the third window, equal bit for bit to the
   uninterrupted run's.
26. elastic: replica 1 dies at step 2 and comes back at step 4
   (``FaultInjector.kill_worker``), slow by 1 ms: evicted and
   readmitted, the windows without it equal to the single-net oracle
   with its weight 0; lockstep pays its barrier stall every window,
   degraded mode only while it is active (counted stalls); then a
   poisoned replica under a stability policy is weighted out and named
   by a ``replica_poisoned`` flight event.
27. sync_master: ``SyncTrainingMaster`` over four slots on the global 8 x
   2048 batch, float32 (tf32x3 flash), SGD at 1e-4: two steps within the
   reference's ``rtol=2e-5, atol=1e-6`` of the single net's ``fit``, and
   each params leaf's change within 1e-2 of the single net's, relative
   in norm (``CHANGE_LIMIT``).
28. sequence_parallel: ``SequenceParallelTrainingMaster`` over (data 2,
   seq 4) slots, the char-LM with ``seq_axis="seq"`` at T 2048, float32,
   SGD at 1e-5: two steps within the reference's ``rtol=1e-4,
   atol=1e-5`` and ``CHANGE_LIMIT`` of the single net with its
   attention in float32 on the built-in path (the ring's arithmetic; the gap to the single net on
   the tf32x3 flash kernels printed beside); ring and Ulysses attention at
   ``[8, 2048, 8, 128]`` bf16, causal and windowed (512), against the
   flash kernel on the whole sequence (Ulysses' forward launches join
   the kernels line's).
29. tensor_parallel: ``TensorParallelTrainingMaster`` over (data 2, model
   2) slots, the char-LM: float32, SGD at 1e-5, two steps of the global
   8 x 2048 batch within the reference's ``atol=2e-5`` and
   ``CHANGE_LIMIT`` of the single net's ``fit``, the flash and prologue
   kernels a layer a step (the model slots' head groups side by side,
   at the train phase's ``[8, 2048, 8, 128]``); bf16 under Adam,
   captured against eager bit for bit, ms a step and tokens/s over a
   fit of batches on the card; the step's collective census.
30. expert_parallel: the MoE net of phase 19 over four model slots (two
   experts a slot, the router row-parallel, the head vocab-parallel):
   float32 SGD at 1e-4 within the same bounds of the single net on the
   whole 16384 rows (routing over the global batch); bf16 Adam,
   captured against eager bit for bit, ms a step.
31. pipeline: the char-LM over four pipe slots, eight microbatches of 1 x
   2048 (``find_periodic_run`` gives (1, 2, 8): the embedding as prefix,
   two attention/FFN block pairs a stage, LayerNorm and the head as
   suffix): float32 SGD two steps against the single net; bf16 Adam
   captured against eager bit for bit; ``measure_bubble_fraction`` at M 4
   and 8 beside the analytic 3/7 and 3/11; ``remat=True``'s graph pool
   against the pool without it.
32. pipeline_hetero: zoo LeNet (nesterovs) over two pipe slots, four
   microbatches of the global 128: the compiled hetero path with its
   float32 rows, then orchestrated GPipe and 1F1B, each against the
   single net.
33. sync_resnet: ResNet-50 at 224 x 224 under ``SyncTrainingMaster`` over
   four slots of 32 images: a first float32 step against the single net
   on the same 128 images (BatchNorm over the global batch, the training
   kernels launched once a layer on the gathered rows); the bf16 step
   timed, images/s.
34. nlp: the NLP embedding stack (no port kernel on its path; its steps
   are captured CUDA graphs, one a padded batch shape).  A corpus from
   ``--seed`` (default 12345) with numpy: 200,000 tokens in sentences
   of 10-30 words, Zipf (s = 1) over 71,290 word types (text8's
   vocabulary at min count 5).  Each fit one epoch: (a) Word2Vec
   skip-gram HS at the ``VectorsConfiguration`` defaults, run twice
   from one seed (the max-abs between the two syn0 is printed:
   ``index_add_`` on CUDA is not ordered); (b) CBOW with 25 negatives at
   ``demo-word.sh``'s text8 settings; (c) ParagraphVectors DBOW over
   2,000 sentences as labelled documents, then ``infer_vector`` and
   ``predict`` on 50; (d) GloVe at its defaults on a 60,000-token cut,
   in RAM and spilled; (e) ``DistributedWord2Vec`` at (a)'s settings
   over four slots of ``cuda:0`` on the cut, within 1e-4 of the serial
   fit of the cut; (f) 1,000 ``words_nearest`` queries on (a).  Each fit
   prints words/s (fit call to the last loss read), ms a batch on the
   host (pair building; staging and launch) and on the device (CUDA
   events), the idle share, captures and replays.  Then each of the
   five steps at its path's shapes against the same step on CPU
   tensors, short fits captured against eager (``rtol=1e-5,
   atol=1e-6``), the reference's two-topic quality protocol (purity
   above 0.8, beside ``BASELINE.md``'s 0.97 / 1.00), and (a)'s
   full-model zip read back on the CPU with equal vectors.
35. graphs: DeepWalk on a planted-partition graph the size of
   BlogCatalog (10,312 vertices, 333,983 undirected edges, 39 groups,
   0.7 of the edges inside a group; from ``--seed``), at the DeepWalk
   paper's settings (d 128, window 10, walks of 40, skip-gram HS, batch
   512, lr 0.025, one epoch) with 2 walks a vertex (the paper's 80 cut:
   845,584 tokens).  Prints the walks' host seconds, one pass of the
   ``VocabWord`` objects the fit builds, the fit's words/s, set-up, host,
   call and device ms a batch, idle share, captures and replays, and
   ``vertices_nearest`` ms a query.  Oracles: the card's fit on the
   first 500 walks against the CPU's (``rtol=1e-5, atol=1e-6``); mean
   cosine within a group above across (``tests/test_graphs.py``'s
   oracle), on that fit and on a second over the same walks at lr 1.0
   (at lr 0.025 the vectors stay near their start: k-means on them is
   at chance); k-means (K 39) on the second fit's unit vectors against
   the planted groups, purity above ``GRAPH_PURITY``.
36. clustering: (a) k-means on 70,000 x 784 float32 points of ten seeded
   classes (MNIST's size), K 10, ``max_iterations`` 100, ``tol`` 1e-8:
   ms an iteration, the iterations, the inertia against a float64
   recomputation from its assignments (``rtol=1e-5``), and one Lloyd
   iteration on the card against the CPU's from the same centres
   (assignments equal apart from near-ties, counted; centres
   ``rtol=1e-5, atol=1e-6``).  (b) Exact t-SNE at van der Maaten's
   example size (2,500 points in 50 dims, ten seeded classes,
   perplexity 30, 500 iterations, lr 200): P's host seconds, ms a
   step, one capture and 499 replays, the KL, separation above 2.0, and
   10 steps on the card against the CPU within 1e-5.  (c) Barnes-Hut on
   the host (300 points, 10 iterations, theta 0.5), timed; its theta = 0
   gradient against the card's exact one within 1e-5 relative in norm.
   (d) Viterbi: the facade on 100,000 binary labels with 10 % flicker,
   and ``viterbi_decode`` at T 10,000, S 64: ms, and the path and score
   equal to the CPU's bit for bit.  (e) A CUDA tensor's round trip
   through the interop.
37. distributed: the sync master across processes, each a child of this
   script (``--distributed-child``, spawned with ``subprocess`` after
   the kernels are built; every child printing one JSON line and waited
   for within a deadline).  (a) NCCL, a world of one: the bf16 char-LM
   at full width on 2 slots of 2 x 2048, 2 steps, through
   ``provision.bootstrap_distributed``'s explicit triple; its params
   equal bit for bit the same master's eager steps here without a
   group.  (b) gloo, two processes on the card (NCCL refuses two ranks on
   one card), 2 x 2 slots of 2 x 2048: float32 SGD 2 steps against the
   single net's fit on the whole batch (``SYNC_TOL``, ``CHANGE_LIMIT``);
   bf16 Adam replicated and ZeRO, 3 steps each: the ranks' and layouts'
   params bit for bit, a flash kernel a layer a step, ms a step, tokens/s,
   the exchange's ms and bytes, peak memory.  (c) ResNet-50 float32 over
   2 x 2 slots of 8 images, 2 steps: the change against a float64
   single net's on the 32 images no more than twice as far as the
   float32 single net's (float32's own rounding reaches 9e-2 of the
   two-step change there; a rank's gradient left out reads 0.98, and
   BatchNorm on each process's own rows 1.21, against 0.18); the first
   step against the float32 single net printed; BatchNorm's training
   kernels 53 a step in each child, the ranks' running statistics bit
   for bit.  (d) (b)'s ZeRO run's
   two-process save restored here onto 4 slots and onto one, bit for bit.
   ``ParallelWrapper`` across processes, in the same children: (a) after
   the NCCL child's steps one wrapper window on its 2 slots, equal bit
   for bit to the same window here without a group; (e) the bf16 char-LM
   at full width, 4 replicas of 2 x 2048, two a process, Adam, F 1 and
   F 3 replicated and F 1 ZeRO, one warm-up and one timed window each:
   the ranks' params bit for bit after every window, the launches and
   the local window graph (captured once, replayed; ZeRO eager), ms a
   window, tokens/s, the exchange's ms and bytes a window, the peak; a
   float32 SGD oracle at F 3, 2 windows, against the one-process
   four-slot wrapper here (``SYNC_TOL``, ``CHANGE_LIMIT``); (f) the
   elastic wrapper (the char-LM cut to 2 layers) with replica 3, rank
   1's, delayed: evicted on both ranks at the same window, equal masks
   and stall counts, readmitted after the delay clears, then one epoch
   of ``ParameterAveragingTrainingMaster(elastic=True)``, the ranks bit
   for bit; (g) ResNet-50 bf16 under the wrapper, one replica of 16
   images a process, one window: the ranks bit for bit, the local
   graph holding 53 BatchNorm training launches of each kind.  In the
   same children: (h) the introspection policy and the numerics ledger
   (collecting every second step) on (b)'s bf16 sync master, replicated
   3 steps and ZeRO 2, and on (e)'s wrapper at F 1 for one window: the
   ranks' vectors (the wrapper's gathered ``[K, N]`` stacks) bit for
   bit; (b)'s float32 run carries both policies, its vectors within
   ``DIST_STATS_TOL`` and ``DIST_FRACTION_TOL`` of the one-process
   four-slot master's here; (i) resilient fits of the sync master and
   the wrapper on (f)'s 2-layer char-LM through a ``CheckpointManager``
   and a ``RetryPolicy``: a fatal fault on every rank, the resume from
   the last commit, a retryable fault and a preemption notice on rank 1
   alone (every rank retries, and commits at the same step), a resumed
   run bit for bit the unfaulted one, a fatal fault on rank 1 alone
   raised on every rank at once; the NCCL child commits and resumes
   once; (j) ``DistributedWord2Vec`` (skip-gram HS, the NLP phase's
   corpus and vocabulary) and ``DistributedGlove`` (its cut), 16 batches
   each, eager: the ranks bit for bit, within ``NLP_DIST_ATOL`` of the
   one-process four-slot fit here, the exchange a batch.  The NCCL
   child and the gloo children start together, and this process makes
   the oracles' references meanwhile (to keep the run inside its time
   limit): (a)'s, (b)'s and (c)'s times share the card with them.
38. Print the kernels line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero without printing a result when no CUDA device is
available or the port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import helpers, native, nlp
from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend.device import pin_fp32_precision
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.helpers import batch_norm as bn
from deeplearning4j_tpu_torch.helpers import flash_attention as fa
from deeplearning4j_tpu_torch.helpers import fused_epilogue as fe
from deeplearning4j_tpu_torch.helpers import lrn
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.models import capture as capture_mod
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
from deeplearning4j_tpu_torch.nlp import distributed as nlp_dist
from deeplearning4j_tpu_torch.nlp import learning as nlp_learning
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


TRACE_MARGIN_S = 0.02     # host seconds at each end of a profiled window


@contextlib.contextmanager
def traced(host=False):
    """``torch.profiler`` over the device (with ``host`` also over the
    host's operations), padded at each end.  The profiler keeps only the
    records that fall inside its window by its own clock, and a kernel
    that ran just after the window opened or just before it closed has
    lost its record on the H100: a graph replayed at once after the
    start counted 7 of a guarded step's 8 flash forwards and 15 of its
    16 prologues once in two runs, and the prefix chat counted 254 of
    its 256 paged and prologue launches once.  So the window opens with
    one small kernel waited for (it matches no counted name; not with
    ``host``, whose trace counts the host's launches) and
    ``TRACE_MARGIN_S`` of host time, and closes with a synchronize and
    the same margin.  Yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if not host:
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


def profiled_launches(fn, pattern=r"paged_decode_kernel", also=None):
    """``fn()`` under ``torch.profiler``; (its result, the launches on the
    device of the kernels whose names match ``pattern``: by default the
    paged kernel).  With ``also`` (a pattern), a third item: its
    launches."""
    with traced() as prof:
        out = fn()
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
    s, maxp = progs.slots, progs.pages_per_slot
    block = (1 + np.arange(s * maxp, dtype=np.int32)).reshape(s, maxp)
    pos = np.random.default_rng(1).integers(8, 72, s).astype(np.int32)
    zi, zf = np.zeros(s, np.int32), np.zeros(s, np.float32)
    keys = np.zeros((s, 2), np.uint32)

    def step():
        progs.decode(block, pos, zi, keys, zi, zf, zi,
                     np.ones(s, np.float32))

    step()
    with traced() as prof:
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
    if warmup:
        net.fit(*feed)
    with traced() as prof:
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
    with traced(host=True) as prof:
        net.fit(x, y)
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
    n = PROFILED_FIT_STEPS
    call()
    with traced() as prof:
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
    with traced() as prof:
        out = fn()
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
FLEET_STEADY_S = 2.5        # mixed traffic before the drills (cut from 5.0)
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


# ------------------------------------------------------------ the A10 slice
# Data and sequence parallelism over slots of the one card
# (backend/mesh.py): the wrapper's replicas each take a 2 x 2048 batch,
# so a window step covers the bench's 8 x 2048.
PW_WORKERS, PW_BATCH, PW_WINDOWS = 4, 2, 2
# float32 master weights against the single-net oracle
PW_TOL = dict(rtol=1e-5, atol=1e-6)
SYNC_TOL = dict(rtol=2e-5, atol=1e-6)      # tests/test_parallel.py
ZERO_TOL = dict(rtol=1e-5, atol=1e-7)      # tests/test_zero.py
SP_TOL = dict(rtol=1e-4, atol=1e-5)        # tests/test_sequence_parallel.py
SP_MESH = dict(data=2, seq=4)
SP_WINDOW = 512                            # the windowed attention case
# the float32 sync and sequence-parallel phases train with SGD (rounding
# stays linear in the gradient, as the reference's equivalence tests keep
# it) at 1e-4: their loss sums a sequence's 2048 timesteps, so at the
# zoo's 1e-3 one step moves some weights by about their own size, and the
# float32 reassociation of the weight-gradient GEMMs (four slots of 4096
# rows against one of 16384) then reaches the weights at that size
PARALLEL_SGD_LR = 1e-4
# sequence parallel: the ring's online softmax and the built-in softmax
# round apart by about 1e-6 of a term, and the embedding bias's gradient
# sums 16384 positions' terms of hundreds with much cancellation, so its
# step carries about 3e-5 of its size: at 1e-5 that stays below the
# reference's atol (at 1e-4, 1.854e-05 against 1e-05 on the H100)
SP_SGD_LR = 1e-5
# the float32 oracles also hold each leaf's change against the single
# net's, ||d_master - d_single|| / ||d_single||: the absolute tolerance
# above shrinks with the step, this ratio does not.  On the H100 the
# right code gives at most 4.7e-05 (sync) and 6.4e-04 (SP) at the rates
# above; one slot's gradient left out of the sync sum gives 0.44, the
# ring's RoPE offset at 0 1.1, the last seq slot's labels dropped 0.45
# (PERF.md §6, the oracles' planted faults)
CHANGE_LIMIT = 1e-2
# the slot phases' depth, cut to keep the whole run near 900 s: five
# elastic windows (replica 1 out at 2, back at 4), two timed steps a
# slot phase, one timed window for the eager wrappers
ELASTIC_WINDOWS = 5
ELASTIC_DELAY = 0.001                      # replica 1's injected delay, s
PARALLEL_TIMED = 2                         # windows or steps timed


def _slots(**axes):
    from deeplearning4j_tpu_torch.backend.mesh import default_mesh

    n = int(np.prod(list(axes.values())))
    return default_mesh(devices=["cuda"] * n, **axes)


def _lm_batches(n, b, seed, vocab=128, t=TRAIN_T):
    """``n`` host (x, y) batches of ``b`` rows: random ids and the
    one-hot of the ids rolled by one (the bench's form)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (b, t))
        out.append(DataSet(ids, np.eye(vocab, dtype=np.float32)[
            np.roll(ids, -1, 1)]))
    return out


def _events_since(t_ns, kind_prefix):
    from deeplearning4j_tpu_torch.observability import get_flight_recorder

    return [e for e in get_flight_recorder().events()
            if e.mono_ns >= t_ns and e.kind.startswith(kind_prefix)]


def _counts_zero():
    for c in helpers.kernel_counts().values():
        c.reset()


def _state_of(net):
    return [t for _, t in named_state(net)]


def _mean_into(dst, snaps, weights):
    """The wrapper's average (``ParallelWrapper._average_``): per leaf
    ``sum(stack * w) / sum(w)``, written into ``dst``."""
    w = torch.tensor(weights, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        for i, t in enumerate(dst):
            stack = torch.stack([s[i] for s in snaps])
            wk = w.reshape((-1,) + (1,) * (stack.ndim - 1)).to(stack.dtype)
            t.copy_(((stack * wk).sum(0, keepdim=True) / w.sum())[0]
                    .to(t.dtype))


def replica_oracle(base, batches, K, F, weights_of=lambda w: None):
    """The wrapper's windows replayed by one single net (``fit``): each
    window every replica starts from the window's averaged state and
    fits its F batches (replica r takes batch ``f*K + r`` of the
    window), and the weighted mean of params, updater and layer state
    (``weights_of(window)``, default all ones) becomes the next window's
    state.  Returns the net holding the final average."""
    single = twin(base, True)
    leaves = _state_of(single)
    state = [t.clone() for t in leaves]
    it = base.iteration
    n_win = len(batches) // (K * F)
    for w in range(n_win):
        frame = batches[w * K * F:(w + 1) * K * F]
        snaps = []
        for r in range(K):
            with torch.no_grad():
                for t, s in zip(leaves, state):
                    t.copy_(s)
            single.iteration = it
            for f in range(F):
                ds = frame[f * K + r]
                single.fit(ds.features, ds.labels)
            snaps.append([t.clone() for t in leaves])
        _mean_into(state, snaps, weights_of(w) or [1.0] * K)
        it += F
        del snaps
    with torch.no_grad():
        for t, s in zip(leaves, state):
            t.copy_(s)
    single.iteration = it
    return single


def _close(what, a, b, tol, hold=True):
    """``a``'s float32 params against ``b``'s within ``tol`` (held unless
    ``hold`` is false); returns the largest absolute difference."""
    va, vb = a.params_to_vector(), b.params_to_vector()
    err = float(np.abs(va - vb).max())
    ok = np.allclose(va, vb, **tol)
    # each leaf's worst excess over the tolerance, and its scale
    worst = sorted(((float(((x - y).abs() - tol["rtol"] * y.abs()).max()),
                     n, float((x - y).abs().max()), float(y.abs().max()))
                    for (n, x), (_, y) in zip(named_state(a), named_state(b))
                    if n.startswith("params")), reverse=True)[:3]
    print(f"{what}: params max abs err {err:.3e} "
          f"(rtol {tol['rtol']:g}, atol {tol['atol']:g}): "
          f"{'holds' if ok else 'FAILS'}; leaves nearest the bound "
          + "; ".join(f"{n} err {e:.3e} of max |{m:.3e}|"
                      for _, n, e, m in worst))
    if hold:
        check(ok, f"{what} within {tol}")
    return err


def _param_snapshot(net):
    """Every params leaf, in float64 on the host, by name."""
    return {n: t.detach().double().cpu() for n, t in named_state(net)
            if n.startswith("params")}


def _change_close(what, a, b, p0, limit, hold=True, noise=0.0):
    """Each params leaf's change from ``p0`` in ``a`` against its change
    in ``b``: the largest ``||da - db|| / ||db||`` over the leaves, held
    within ``limit`` unless ``hold`` is false.  Unlike a tolerance on the
    weights, it scales with the step: no learning rate is small enough
    to pass it with a wrong gradient.  A leaf whose change in ``b`` is
    below ``noise`` times the largest leaf's is rounding by construction
    (a conv bias before a training-mode BatchNorm has an exact gradient
    of 0): it is counted and left out of the ratio, its absolute error
    held by ``_close``.  Returns the largest ratio."""
    rows = []
    for (n, x), (_, y) in zip(named_state(a), named_state(b)):
        if not n.startswith("params"):
            continue
        da = x.detach().double().cpu() - p0[n]
        db = y.detach().double().cpu() - p0[n]
        num, den = float((da - db).norm()), float(db.norm())
        rows.append((num / den if den else (0.0 if num == 0 else math.inf),
                     n, den))
    big = max(d for _, _, d in rows)
    quiet = [r for r in rows if r[2] < noise * big]
    rows = [r for r in rows if r[2] >= noise * big]
    rows.sort(reverse=True)
    top = rows[0][0]
    print(f"{what}: the change's largest relative error {top:.3e} over "
          f"{len(rows)} leaves (limit {limit:g}"
          + (f"; {len(quiet)} leaves whose change is below {noise:g} of "
             f"the largest left out" if noise else "") + "): "
          f"{'holds' if top <= limit else 'FAILS'}; "
          + "; ".join(f"{n} {r:.3e} of |change| {d:.3e}"
                      for r, n, d in rows[:3]))
    if hold:
        check(top <= limit, f"{what}: change within {limit}")
    return top


def _bitwise(what, a, b):
    gaps = state_gaps(a, b)
    print(f"{what}: {len(gaps)} of {len(named_state(a))} leaves differ "
          f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:3]}")
    check(not gaps, f"{what} bit for bit")


def _release(pw):
    from deeplearning4j_tpu_torch.models import capture as cap

    if pw._staged is not None:
        cap.release(pw._staged)
    pw._staged = None
    gc.collect()
    torch.cuda.empty_cache()


def _drop(net):
    """Free a net's captured graphs and their pool now."""
    from deeplearning4j_tpu_torch.models import capture as cap

    cap.release(net)
    gc.collect()
    torch.cuda.empty_cache()


def _wrapper_fit(net, batches, mesh, F, **kw):
    """A ParallelWrapper over ``mesh`` fit on ``batches``: (wrapper, the
    wrapper counts of that fit, its seconds, the peak allocated bytes
    above what was allocated when the fit began: the wrapper's staged
    state and its window's working set)."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(net, workers=PW_WORKERS, mesh=mesh,
                         averaging_frequency=F, **kw)
    _counts_zero()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pw.fit(iter(batches))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _launch_counts()
    check(all(p == 0 for _, p in counts.values()),
          f"plain-version calls {counts}")
    return pw, {k: l for k, (l, _) in counts.items() if l}, secs, \
        torch.cuda.max_memory_allocated() - base


def _timed_windows(pw, batches, n_windows):
    """ms a window over ``n_windows`` more windows (replays when
    captured), to the last loss."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw.fit(iter(batches[:n_windows * len(batches) // PW_WINDOWS]))
    float(pw.net.score_value)
    return (time.perf_counter() - t0) * 1e3 / n_windows


def parallel_wrapper_phase(name_card):
    """``ParallelWrapper(net, workers=4)`` over four slots of the card,
    the full-width bf16 char-LM, Adam, each replica a 2 x 2048 batch;
    averaging_frequency 1 and 3, captured and eager; two windows each,
    against the single-net oracle.  Returns (the wrapper counts of the
    captured and eager runs, the F=1 replicated run's peak bytes, its
    params, its ledger)."""
    from deeplearning4j_tpu_torch.observability import shardstats

    t_phase = time.perf_counter()
    # the kernels at the replica's shapes, against their plain versions
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    flash_case("replica_bf16", 700, (PW_BATCH, TRAIN_T, 8, 128),
               torch.bfloat16, True, None, flush, name_card)
    prologue_case("replica_prologue_bf16", 710, PW_BATCH * TRAIN_T, 1024,
                  torch.bfloat16, False, False, flush, name_card)
    del flush
    mesh = _slots(data=PW_WORKERS)
    base = transformer_char_lm(device="cuda", **TRAIN_MODEL)
    layers = TRAIN_MODEL["layers"]
    per_mb = {"flash_fwd": PW_WORKERS * layers,
              "flash_dq": PW_WORKERS * layers,
              "flash_dkv": PW_WORKERS * layers,
              "prologue": PW_WORKERS * 2 * layers}
    total = {k: 0 for k in per_mb}
    out = {}
    for F in (1, 3):
        batches = _lm_batches(PW_WINDOWS * PW_WORKERS * F, PW_BATCH,
                              seed=100 + F)
        nets = {}
        for mode in ("captured", "eager"):
            net = twin(base, mode == "captured")
            pw, got, secs, peak = _wrapper_fit(net, batches, mesh, F)
            want = {k: (2 if mode == "captured" else PW_WINDOWS) * F * v
                    for k, v in per_mb.items()}
            print(f"parallel_wrapper [F={F}, {mode}]: {PW_WINDOWS} windows "
                  f"in {secs:.3f} s (the first's warm-up and capture "
                  f"included); wrapper launches {got}, expected {want}")
            check(got == want, f"wrapper launches {got} == {want}")
            for k in total:
                total[k] += got.get(k, 0)
            if mode == "captured":
                from deeplearning4j_tpu_torch.models import capture as cap

                graphs = cap.step_graphs(pw._staged)
                held = list(graphs.graph_launches().values())
                print(f"parallel_wrapper [F={F}]: captures "
                      f"{graphs.captures}, replays {graphs.replays}; the "
                      f"window graph holds {held}")
                check(graphs.captures == 1 and held == [
                    {k: F * v for k, v in per_mb.items()}],
                    "one window graph holding F x 4 replicas' launches")
                if F == 1:
                    out["peak_bytes"] = peak
                    out["capture_bytes"] = pw.capture_pool_bytes()
                    out["ledger"] = shardstats.latest_ledgers()[
                        "parallel_wrapper"]
                    out["params"] = net.params_to_vector()
            nets[mode] = (net, pw)
        _bitwise(f"parallel_wrapper [F={F}] captured against eager",
                 nets["captured"][0], nets["eager"][0])
        t_or = time.perf_counter()
        oracle = replica_oracle(base, batches, PW_WORKERS, F)
        _close(f"parallel_wrapper [F={F}] against four single nets' fit, "
               f"averaged each window", nets["captured"][0], oracle, PW_TOL)
        print(f"parallel_wrapper [F={F}]: oracle "
              f"{time.perf_counter() - t_or:.1f} s")
        tokens = PW_WORKERS * F * PW_BATCH * TRAIN_T
        for mode, (net, pw) in nets.items():
            ms = _timed_windows(pw, batches,
                                PW_WINDOWS if mode == "captured" else 1)
            print(f"parallel_wrapper [F={F}, {mode}]: {ms:.3f} ms a window "
                  f"({PW_WORKERS} replicas x {F} minibatches of "
                  f"{PW_BATCH} x {TRAIN_T}), {tokens / ms * 1e3:.1f} "
                  f"tokens/s [{name_card}]")
            _release(pw)
        if F == 1:
            single = twin(base, True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            b0 = torch.cuda.memory_allocated()
            single.fit(batches[0].features, batches[0].labels)
            torch.cuda.synchronize()
            one = torch.cuda.max_memory_allocated() - b0
            cap_b = out["capture_bytes"]
            check(cap_b is not None, "the window's capture was measured")
            cap_b = cap_b or 0
            print(f"parallel_wrapper: the window's capture added "
                  f"{cap_b / 1e9:.3f} GB to its graph pool, one "
                  f"single-net step at {PW_BATCH} x {TRAIN_T} "
                  f"{one / 1e9:.3f} GB above its state; the fit's peak "
                  f"{out['peak_bytes'] / 1e9:.3f} GB above what was "
                  f"allocated before it [{name_card}]")
            check(cap_b < 2 * one, "the window's pool reuses one replica's "
                  "activations for the next (not K times them)")
            _drop(single)
        _drop(oracle)
        del nets, oracle
        torch.cuda.empty_cache()
    print(f"parallel_wrapper: phase {time.perf_counter() - t_phase:.1f} s")
    return base, total, out


def zero_phase(name_card, base, rep):
    """The wrapper with ``update_sharding="zero"`` against the replicated
    F=1 run of ``parallel_wrapper_phase``: the same two windows from
    the same state; params within the reference's ZeRO tolerance, the
    ledger's updater replication 4 -> 1, and the peak allocated bytes.
    Returns (the ZeRO wrapper, still live, its net, the batches, its
    wrapper counts)."""
    from deeplearning4j_tpu_torch.observability import shardstats

    t_phase = time.perf_counter()
    mesh = _slots(data=PW_WORKERS)
    batches = _lm_batches(3 * PW_WORKERS, PW_BATCH, seed=101)
    net = twin(base, True)
    pw, got, secs, peak = _wrapper_fit(net, batches[:2 * PW_WORKERS], mesh,
                                       1, update_sharding="zero")
    layers = TRAIN_MODEL["layers"]
    want = {"flash_fwd": 2 * PW_WORKERS * layers,
            "flash_dq": 2 * PW_WORKERS * layers,
            "flash_dkv": 2 * PW_WORKERS * layers}
    print(f"zero: two windows in {secs:.3f} s; wrapper launches {got}")
    check({k: got.get(k) for k in want} == want and got.get("prologue"),
          f"zero launches {got}")
    vec = net.params_to_vector()
    err = float(np.abs(vec - rep["params"]).max())
    ok = np.allclose(vec, rep["params"], **ZERO_TOL)
    print(f"zero: params against the replicated wrapper's, max abs err "
          f"{err:.3e} (rtol {ZERO_TOL['rtol']:g}, atol "
          f"{ZERO_TOL['atol']:g}): {'holds' if ok else 'FAILS'}")
    check(ok, "zero against replicated")
    led = shardstats.latest_ledgers()["parallel_wrapper"]
    rows = {m: {t: (l["trees"][t]["replication_factor"],
                    l["trees"][t]["per_device_bytes"])
                for t in ("params", "updater_state")}
            for m, l in (("replicated", rep["ledger"]), ("zero", led))}
    print(f"zero: ledger (replication factor, bytes a slot) {rows}")
    check(rows["replicated"]["updater_state"][0] == 4.0
          and rows["zero"]["updater_state"][0] <= 1.1,
          "the updater's replication falls from 4 to 1")
    print(f"zero: the fit's peak {peak / 1e9:.3f} GB above what was "
          f"allocated before it (staged state and window), against the "
          f"replicated wrapper's {rep['peak_bytes'] / 1e9:.3f} GB: "
          f"{(rep['peak_bytes'] - peak) / 1e9:.3f} GB less; the window's "
          f"capture added {(pw.capture_pool_bytes() or 0) / 1e9:.3f} GB to "
          f"its graph pool against {(rep['capture_bytes'] or 0) / 1e9:.3f} "
          f"[{name_card}]")
    check(peak < rep["peak_bytes"], "ZeRO's peak below replicated's")
    prog = shardstats.program_analysis("ParallelWrapper.fit_window_zero")
    print("zero: window census (on one card the collectives' bytes are a "
          "census of what four cards would move, not traffic over a "
          "link): " + "; ".join(
              f"{op} x{e['count']} {e['bytes'] / 1e9:.3f} GB"
              for op, e in prog["collectives"].items())
          + f"; projected over NVLink 900 GB/s "
            f"{prog['comm_seconds_estimate'] * 1e3:.3f} ms a window")
    ms = _timed_windows(pw, batches[:2 * PW_WORKERS], PW_WINDOWS)
    print(f"zero: {ms:.3f} ms a window (captured) [{name_card}]")
    print(f"zero: phase {time.perf_counter() - t_phase:.1f} s")
    # the checkpoint phase continues this run from two windows
    _release(pw)
    net2 = twin(base, True)
    pw2, got2, _, _ = _wrapper_fit(net2, batches[:2 * PW_WORKERS], mesh, 1,
                                   update_sharding="zero")
    for k, v in got2.items():
        got[k] = got.get(k, 0) + v
    return pw2, net2, batches, got


def checkpoint_sharded_phase(name_card, pw, net, batches):
    """Save the ZeRO wrapper (two windows in) with ``mesh=``: one
    ``shards-0.npz`` with every slot's block; restore it onto a two-slot
    mesh and into a single net; a fresh ZeRO wrapper on the restored net
    takes the third window, equal bit for bit to the uninterrupted
    run's."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, restore_checkpoint, save_checkpoint,
    )

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="dl4j_ckpt_")
    try:
        t0 = time.perf_counter()
        save_checkpoint(d, net, trees=pw.state_trees(), mesh=pw.mesh)
        t_save = time.perf_counter() - t0
        with open(f"{d}/manifest-0.json") as f:
            man = json.load(f)
        w = max((e for p, e in man["leaves"].items()
                 if p.startswith("params")),
                key=lambda e: int(np.prod(e["shape"])))
        print(f"checkpoint_sharded: saved in {t_save:.2f} s, "
              f"{sum(len(e['shards']) for e in man['leaves'].values())} "
              f"pieces of {len(man['leaves'])} leaves; e.g. spec "
              f"{w['spec']}, {len(w['shards'])} pieces")
        check(man["mesh"]["shape"][0] == PW_WORKERS, "the saving mesh")
        two = _slots(data=2)
        t0 = time.perf_counter()
        params, _, _, it = restore_checkpoint(d, mesh=two)
        t_two = time.perf_counter() - t0
        gaps = [p for p, t in named_state(net) if p.startswith("params")
                and not torch.equal(
                    _leaf(params, p[len("params/"):]).full(), t)]
        print(f"checkpoint_sharded: onto two slots in {t_two:.2f} s: "
              f"{len(gaps)} params differ")
        check(not gaps and it == net.iteration, "two-slot restore")
        fresh = transformer_char_lm(device="cuda",
                                    **{**TRAIN_MODEL, "seed": 999})
        t0 = time.perf_counter()
        restore_checkpoint(d, fresh, mesh=pw.mesh)
        print(f"checkpoint_sharded: into a single net in "
              f"{time.perf_counter() - t0:.2f} s")
        _bitwise("checkpoint_sharded: restored net against the saver",
                 fresh, net)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    third = batches[2 * PW_WORKERS:]
    _counts_zero()
    pw.fit(iter(third))
    resumed = ParallelWrapper(fresh, workers=PW_WORKERS, mesh=pw.mesh,
                              update_sharding="zero")
    resumed.fit(iter(third))
    counts = {k: l for k, (l, _) in _launch_counts().items() if l}
    _bitwise("checkpoint_sharded: the next window, resumed against "
             "uninterrupted", fresh, net)
    _release(resumed)
    _release(pw)
    print(f"checkpoint_sharded: phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def sync_master_oracle(lr=PARALLEL_SGD_LR, hold=True):
    """``SyncTrainingMaster`` over four slots on the global 8 x 2048
    batch, float32 compute, SGD at ``lr``, two steps against the single
    net's ``fit`` on the whole batch: the params within ``SYNC_TOL`` and
    their change within ``CHANGE_LIMIT`` (held unless ``hold`` is
    false).  Returns (the master's net, its DistributedNetwork, the two
    batches, its wrapper counts, the two readings)."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster,
    )

    net = transformer_char_lm(device="cuda", updater="sgd", lr=lr,
                              **TRAIN_MODEL_F32)
    single = twin(net, True)
    p0 = _param_snapshot(net)
    both = _lm_batches(2, TRAIN_BATCH, seed=7)
    data = DataSet(np.concatenate([b.features for b in both]),
                   np.concatenate([b.labels for b in both]))
    master = SyncTrainingMaster(mesh=_slots(data=PW_WORKERS))
    dist = DistributedNetwork(net, master)
    _counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.fit(ListDataSetIterator(data, TRAIN_BATCH))
    float(net.score_value)
    secs = time.perf_counter() - t0
    counts = {k: l for k, (l, _) in _launch_counts().items() if l}
    layers = TRAIN_MODEL["layers"]
    # one forward over the global batch (the four slots' rows side by
    # side): a launch a layer, in the warm-up and in the capture
    want = {"flash_fwd": 2 * layers, "flash_dq": 2 * layers,
            "flash_dkv": 2 * layers, "prologue": 2 * 2 * layers}
    print(f"sync_master: two steps in {secs:.3f} s (warm-up and capture "
          f"included); wrapper launches {counts}, expected {want}")
    check(counts == want, "sync launches")
    for b in both:
        single.fit(b.features, b.labels)
    what = f"sync_master (SGD {lr:g}) against the single net's fit on " \
           f"the whole batch"
    err = _close(what, net, single, SYNC_TOL, hold=False)
    rel = _change_close(what, net, single, p0, CHANGE_LIMIT, hold=False)
    if hold:
        check(np.allclose(net.params_to_vector(),
                          single.params_to_vector(), **SYNC_TOL),
              f"{what} within {SYNC_TOL}")
        check(rel <= CHANGE_LIMIT, f"{what}: change within {CHANGE_LIMIT}")
    _drop(single)
    return net, dist, both, counts, (err, rel)


def sync_master_phase(name_card):
    """The sync master's oracle at ``PARALLEL_SGD_LR``, then its step
    timed.  Returns its wrapper counts."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    t_phase = time.perf_counter()
    net, dist, both, counts, _ = sync_master_oracle()
    ms = []
    for _ in range(PARALLEL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.fit(ListDataSetIterator(DataSet(both[0].features,
                                             both[0].labels), TRAIN_BATCH))
        float(net.score_value)
        ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms))
    print(f"sync_master: step median {med:.3f} ms over {PARALLEL_TIMED} "
          f"(4 slots of 2 x 2048, float32), "
          f"{TRAIN_BATCH * TRAIN_T / med * 1e3:.1f} tokens/s [{name_card}]")
    _drop(net)
    del net, dist
    print(f"sync_master: phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def elastic_phase(name_card, base):
    """Replica 1 of the four dies at step 2 and comes back at step 4
    (``FaultInjector.kill_worker``), slow by 1 ms while active: the
    windows without it average the three healthy replicas (the
    single-net oracle with its weight 0), it is readmitted holding the
    average, and the barrier stalls of degraded mode are counted against
    lockstep.  Then a NaN-poisoned replica under a stability policy:
    weighted out, named by a ``replica_poisoned`` flight event.  Returns
    the wrapper counts."""
    from deeplearning4j_tpu_torch.parallel import ElasticConfig
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, inject_faults,
    )

    t_phase = time.perf_counter()
    mesh = _slots(data=PW_WORKERS)
    batches = _lm_batches(ELASTIC_WINDOWS * PW_WORKERS, PW_BATCH, seed=31)
    total = {}

    def faults():
        return (FaultInjector(seed=0)
                .kill_worker("1", at_step=2, until_step=4)
                .delay_worker("1", ELASTIC_DELAY))

    stalls = {}
    for label, cfg in (("degraded", ElasticConfig(evict_after_flags=None,
                                                  hang_stall_s=0.0)),
                       ("lockstep", ElasticConfig(degraded_mode=False,
                                                  hang_stall_s=0.0))):
        net = twin(base, True)
        t_ns = time.monotonic_ns()
        with inject_faults(faults()):
            pw, got, secs, _ = _wrapper_fit(net, batches, mesh, 1,
                                            elastic=cfg)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        stalls[label] = (pw.elastic.barrier_stalls,
                         pw.elastic.barrier_stall_seconds)
        events = [(e.kind, e.attrs.get("worker"), e.attrs.get("step"),
                   e.attrs.get("reason"))
                  for e in _events_since(t_ns, "elastic_")]
        print(f"elastic [{label}]: {ELASTIC_WINDOWS} windows in "
              f"{secs:.3f} s; events {events}; barrier stalls "
              f"{stalls[label][0]} ({stalls[label][1] * 1e3:.1f} ms)")
        if label == "degraded":
            check(("elastic_eviction", "1", 2, "dead") in events
                  and any(k == "elastic_readmission" and w == "1"
                          for k, w, _, _ in events)
                  and pw.elastic.evicted_workers == [],
                  "replica 1 evicted at step 2 and readmitted")
            st = pw._staged
            same = all(torch.equal(a[1], a[0])
                       for a in tree_leaves(st.params))
            check(same, "every slot holds the average")
            oracle = replica_oracle(
                base, batches, PW_WORKERS, 1,
                weights_of=lambda w: [1.0, 0.0 if w in (2, 3) else 1.0,
                                      1.0, 1.0])
            _close("elastic: the windows without replica 1 average the "
                   "healthy three (single-net oracle)", net, oracle, PW_TOL)
            _drop(oracle)
            del oracle
        _release(pw)
        del net
    print(f"elastic: counted barrier stalls, lockstep {stalls['lockstep'][0]}"
          f" against degraded {stalls['degraded'][0]}")
    check(stalls["lockstep"][0] == ELASTIC_WINDOWS
          and stalls["degraded"][0] == ELASTIC_WINDOWS - 2,
          "degraded mode stops paying replica 1's stall while it is out")
    # a poisoned replica under a stability policy
    stab = transformer_char_lm(device="cuda", stability=dict(check_every=1),
                               **TRAIN_MODEL)
    one = batches[:PW_WORKERS]
    net = twin(stab, True)
    t_ns = time.monotonic_ns()
    inj = FaultInjector(seed=1).poison_gradients("2", at_step=0,
                                                 until_step=1)
    with inject_faults(inj):
        pw, got, _, _ = _wrapper_fit(net, one, mesh, 1)
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    named = [e.attrs for e in _events_since(t_ns, "replica_poisoned")]
    print(f"elastic [poisoned]: flight events {named}")
    check(any(a.get("worker") == "2" for a in named),
          "a replica_poisoned event names replica 2")
    oracle = replica_oracle(stab, one, PW_WORKERS, 1,
                            weights_of=lambda w: [1.0, 1.0, 0.0, 1.0])
    _close("elastic [poisoned]: replica 2 weighted out (the healthy "
           "three's mean)", net, oracle, PW_TOL)
    _release(pw)
    _drop(oracle)
    _drop(net)
    del net, oracle, stab
    torch.cuda.empty_cache()
    print(f"elastic: phase {time.perf_counter() - t_phase:.1f} s")
    return total


def sequence_parallel_oracle(name_card, lr=SP_SGD_LR, hold=True):
    """``SequenceParallelTrainingMaster`` over (data=2, seq=4) slots: the
    char-LM built with ``seq_axis="seq"`` at T = 2048, float32, SGD at
    ``lr``, two steps (then ``PARALLEL_TIMED`` more, timed) against the
    single net's ``fit`` with its attention on the built-in float32 path
    (the ring's arithmetic): the params within ``SP_TOL`` and their
    change within ``CHANGE_LIMIT`` (held unless ``hold`` is false).
    Returns (the wrapper counts, the two readings)."""
    from deeplearning4j_tpu_torch.parallel import (
        SequenceParallelTrainingMaster,
    )

    mesh = _slots(**SP_MESH)
    net = transformer_char_lm(device="cuda", updater="sgd", seq_axis="seq",
                              lr=lr, **TRAIN_MODEL_F32)
    single = transformer_char_lm(device="cuda", updater="sgd", lr=lr,
                                 **TRAIN_MODEL_F32)
    p0 = _param_snapshot(single)
    _bitwise("sequence_parallel: the seq_axis net's initial state against "
             "the single net's", net, single)
    both = _lm_batches(2, TRAIN_BATCH, seed=9)
    master = SequenceParallelTrainingMaster(mesh)
    _counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    master.execute_training(net, both)
    float(net.score_value)
    secs = time.perf_counter() - t0
    counts = {k: l for k, (l, _) in _launch_counts().items() if l}
    layers = TRAIN_MODEL["layers"]
    print(f"sequence_parallel: two steps in {secs:.3f} s (warm-up and "
          f"capture included), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; wrapper "
          f"launches {counts} (ring attention is plain torch)")
    check(counts == {"prologue": 2 * 2 * layers}, "SP launches")
    snap = twin(net, False)          # the two steps' state, held below
    ms = []
    for _ in range(PARALLEL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        master.execute_training(net, both[:1])
        float(net.score_value)
        ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms))
    print(f"sequence_parallel: step median {med:.3f} ms (data=2 x seq=4 "
          f"slots of 4 x 512), {TRAIN_BATCH * TRAIN_T / med * 1e3:.1f} "
          f"tokens/s [{name_card}]")
    _drop(net)
    # the oracle computes attention as the ring does, exactly in float32
    # (the built-in path, as the reference's single-device net in its
    # test; eager: its [8, 8, 2048, 2048] scores are not kept in a
    # graph's pool); the single net on the tf32x3 flash kernels is
    # printed beside
    flash_single = twin(single, True)
    single._capture = False
    with helpers.helpers_disabled():
        for b in both:
            single.fit(b.features, b.labels)
    what = (f"sequence_parallel (SGD {lr:g}) against the single net's fit "
            f"(attention in float32, the built-in path)")
    err = _close(what, snap, single, SP_TOL, hold=False)
    rel = _change_close(what, snap, single, p0, CHANGE_LIMIT, hold=False)
    if hold:
        check(np.allclose(snap.params_to_vector(),
                          single.params_to_vector(), **SP_TOL),
              f"{what} within {SP_TOL}")
        check(rel <= CHANGE_LIMIT, f"{what}: change within {CHANGE_LIMIT}")
    _drop(single)
    for b in both:
        flash_single.fit(b.features, b.labels)
    va, vb = snap.params_to_vector(), flash_single.params_to_vector()
    print(f"sequence_parallel against the single net on the tf32x3 flash "
          f"kernels: params max abs err {float(np.abs(va - vb).max()):.3e}"
          f" (printed, not held)")
    _drop(flash_single)
    del snap
    return counts, (err, rel)


def sequence_parallel_phase(name_card):
    """The sequence-parallel master's oracle at ``SP_SGD_LR``; then ring
    and Ulysses attention at [8, 2048, 8, 128] bf16, causal and windowed,
    against the flash kernel on the whole sequence.  Returns the wrapper
    counts (the SP steps' prologue; Ulysses' flash forward)."""
    from deeplearning4j_tpu_torch.parallel import ring_self_attention

    t_phase = time.perf_counter()
    counts, _ = sequence_parallel_oracle(name_card)
    seq = _slots(seq=SP_MESH["seq"])
    shape = (TRAIN_BATCH, TRAIN_T, 8, 128)
    q, k, v = (_randn(50 + i, shape, torch.bfloat16) for i in range(3))
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    ulysses = 0
    for causal, window in ((True, None), (True, SP_WINDOW)):
        ref = fa.flash_attention(q, k, v, causal=causal, window=window)
        line = []
        for impl in ("ring", "ulysses"):
            before = helpers.kernel_counts()["flash_fwd"].launches
            got = ring_self_attention(q, k, v, seq, causal=causal,
                                      window=window, impl=impl)
            n = helpers.kernel_counts()["flash_fwd"].launches - before
            check(n == (1 if impl == "ulysses" else 0),
                  f"{impl}: {n} flash forward launches")
            ulysses += n
            # one bf16 rounding of outputs up to ~5, over the largest
            err = _scaled_err(got, ref)
            check(err < TOL[torch.bfloat16],
                  f"{impl} window={window}: {err}")
            t = time_ms(lambda: ring_self_attention(
                q, k, v, seq, causal=causal, window=window, impl=impl),
                flush, iters=5, warm=1)
            line.append(f"{impl} {t:.3f} ms, err {err:.3e} of the largest "
                        f"output")
        tf = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                window=window), flush)
        print(f"sequence_parallel attention {list(shape)} bf16 causal "
              f"window={window}: " + "; ".join(line)
              + f"; the flash kernel on the whole sequence {tf:.3f} ms "
                f"[{name_card}]")
    del flush
    torch.cuda.empty_cache()
    print(f"sequence_parallel: phase {time.perf_counter() - t_phase:.1f} s")
    return counts, ulysses


# --------------------------- phases 29-33, tensor, expert and pipeline slots
# the tensor- and pipeline-parallel float32 oracles hold the reference's
# own tolerance for these masters (tests/test_model_parallel.py and
# test_pipeline_compiled.py: atol=2e-5, numpy's rtol) and the change
# ratio.  Their row products' psums (TP) and microbatch sums (PP)
# reassociate the float32 arithmetic of every activation gradient, and
# the embedding bias's gradient sums 16384 positions' terms with much
# cancellation: at SGD 1e-4 the TP step carried 1.958e-05 of it on the
# H100 (98 % of the bound), so TP trains at 1e-5 as SP does; PP read
# 1.234e-05 at 1e-4 (PERF.md section 6).  The change ratio does not
# shrink with the rate.
TP_TOL = dict(rtol=1e-7, atol=2e-5)
TP_SGD_LR, PP_SGD_LR = SP_SGD_LR, PARALLEL_SGD_LR
# ResNet-50's conv biases feed training-mode BatchNorms: their exact
# gradient is 0 and their change rounding (2.9e-10 for the stem's at SGD
# 1e-4 on the H100), so the change ratio leaves out leaves below 1e-6 of
# the largest change
RESNET_NOISE = 1e-6
TP_MESH = dict(data=2, model=2)
EP_MESH = dict(data=1, model=4)
PP_STAGES, PP_MICRO = 4, 8
LENET_BATCH, LENET_MICRO = 128, 4
RESNET_SLOTS = 4


def _census(prog_name):
    from deeplearning4j_tpu_torch.observability import shardstats

    col = shardstats.program_analysis(prog_name).get("collectives", {})
    return {op: (e["count"], int(e["bytes"]), e["group_sizes"])
            for op, e in col.items()}


def _held_launches(what, want=None, note=""):
    """The wrapper launches since the last ``_counts_zero()``: no call of
    a plain version, and held to ``want`` where given."""
    counts = _launch_counts()
    check(all(p == 0 for _, p in counts.values()),
          f"{what}: plain-version calls {counts}")
    counts = {k: l for k, (l, _) in counts.items() if l}
    print(f"{what}: {note}wrapper launches {counts}"
          + (f", expected {want}" if want is not None else ""))
    if want is not None:
        check(counts == want, f"{what} launches")
    return counts


def _twin_want(per_step):
    """The launches of ``_captured_against_eager`` over 2 steps: the
    captured net's warm-up and capture, and the eager net's 2 steps."""
    return {k: 4 * n for k, n in per_step.items()}


def _oracle_fit(what, net, single, fit, single_fit, p0, want=None,
                tol=SYNC_TOL, noise=0.0):
    """``fit()`` under the master and ``single_fit()`` on the single
    net: the wrapper launches of the master's fit (held to ``want`` where
    given) and the params within ``tol`` and ``CHANGE_LIMIT`` of the
    single net's (both read before either is held)."""
    _counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    float(net.score_value)
    secs = time.perf_counter() - t0
    counts = _held_launches(
        what, want, f"fit in {secs:.3f} s (warm-up and capture included); ")
    single_fit()
    err = _close(what, net, single, tol, hold=False)
    rel = _change_close(what, net, single, p0, CHANGE_LIMIT, hold=False,
                        noise=noise)
    check(np.allclose(net.params_to_vector(), single.params_to_vector(),
                      **tol), f"{what} within {tol}")
    check(rel <= CHANGE_LIMIT, f"{what}: change within {CHANGE_LIMIT}")
    return counts, (err, rel)


def _on_card(ds):
    """``ds`` with its features and labels on the card, as the facades'
    timed steps read theirs (PERF.md section 5): a step then times the
    master, not the host's copy of the batch."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    return DataSet(torch.as_tensor(ds.features, device="cuda"),
                   torch.as_tensor(ds.labels, device="cuda"))


def _timed_epoch(master, net, ds, n=PARALLEL_TIMED):
    """ms a step of one ``execute_training`` over ``n`` copies of the
    batch ``ds`` (on the card), to the last loss: the per-call work (the
    sharding ledger, the pipeline's stacked copy and its fold back) is
    paid once an epoch, as a fit pays it."""
    dev = _on_card(ds)
    master.execute_training(net, [dev])            # the card's batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    master.execute_training(net, [dev] * n)
    float(net.score_value)
    return (time.perf_counter() - t0) * 1e3 / n


def _captured_against_eager(what, make, fit_of, steps):
    """Two nets from one initial state, the master's step captured and
    eager over ``steps`` batches: equal bit for bit.  Returns the
    captured net and its master's fit (for timing)."""
    base = make()
    nets = {"captured": twin(base, True), "eager": twin(base, False)}
    _drop(base)
    fits = {}
    for mode, net in nets.items():
        fits[mode] = fit_of(net)
        for b in steps:
            fits[mode](b)
    _bitwise(f"{what}: captured against eager", nets["captured"],
             nets["eager"])
    _drop(nets["eager"])
    return nets["captured"], fits["captured"]


def tensor_parallel_phase(name_card):
    """Phase 29 (module docstring).  Returns the wrapper launches of its
    float32 oracle and of its bf16 runs."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.observability import shardstats
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, TensorParallelTrainingMaster,
    )

    t_phase = time.perf_counter()
    # the model slots' head groups side by side: the flash kernels at
    # the train phase's [8, 2048, 8, 128]
    layers = TRAIN_MODEL["layers"]
    both = _lm_batches(2, TRAIN_BATCH, seed=41)
    net = transformer_char_lm(device="cuda", updater="sgd", lr=TP_SGD_LR,
                              **TRAIN_MODEL_F32)
    single = twin(net, True)
    p0 = _param_snapshot(net)
    master = TensorParallelTrainingMaster(mesh=_slots(**TP_MESH))

    def fit():
        for b in both:
            DistributedNetwork(net, master).fit(
                ListDataSetIterator(b, TRAIN_BATCH))

    def single_fit():
        for b in both:
            single.fit(b.features, b.labels)

    step = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers,
            "prologue": 2 * layers}
    want = {k: 2 * n for k, n in step.items()}
    f32, _ = _oracle_fit(
        f"tensor_parallel (float32, SGD {TP_SGD_LR:g}, data 2 x model 2) "
        f"against the single net's fit on the whole batch", net, single,
        fit, single_fit, p0, want, tol=TP_TOL)
    census = _census("TensorParallelTrainingMaster.step")
    print(f"tensor_parallel: the step's collectives (op: count, payload "
          f"bytes, slot groups) {census}")
    led = shardstats.latest_ledgers()["sync_master"]
    print(f"tensor_parallel: params per slot "
          f"{led['trees']['params']['per_device_bytes'] / 1e6:.1f} MB of "
          f"{led['trees']['params']['logical_bytes'] / 1e6:.1f} MB")
    _drop(net)
    _drop(single)
    del net, single, master
    _counts_zero()

    def fit_of(n):
        m = TensorParallelTrainingMaster(mesh=_slots(**TP_MESH))
        f = lambda b: DistributedNetwork(n, m).fit(  # noqa: E731
            ListDataSetIterator(b, TRAIN_BATCH))
        f.master = m
        return f

    steps = _lm_batches(2, TRAIN_BATCH, seed=43)
    net, fit1 = _captured_against_eager(
        "tensor_parallel bf16 Adam",
        lambda: transformer_char_lm(device="cuda", **TRAIN_MODEL), fit_of,
        steps)
    bf16 = _held_launches("tensor_parallel bf16 Adam, the captured and "
                          "eager twins", _twin_want(step))
    med = _timed_epoch(fit1.master, net, steps[0])
    print(f"tensor_parallel: bf16 Adam {med:.3f} ms a step over a fit of "
          f"{PARALLEL_TIMED} (data 2 x model 2 slots, 8 x 2048 on the card), "
          f"{TRAIN_BATCH * TRAIN_T / med * 1e3:.1f} tokens/s [{name_card}]")
    _drop(net)
    del net
    print(f"tensor_parallel: phase {time.perf_counter() - t_phase:.1f} s")
    return f32, bf16


def _moe_net(dtype=None, updater="sgd", lr=PARALLEL_SGD_LR):
    m = MOE
    b = (NeuralNetConfiguration.builder().seed(12345)
         .updater(updater, learning_rate=lr).list())
    if dtype:
        b.compute_dtype(dtype)
    return MultiLayerNetwork(
        b.layer(DenseLayer(n_in=m["d"], n_out=m["d"], activation="relu"))
        .layer(MoELayer(n_in=m["d"], n_out=m["d"], num_experts=m["experts"],
                        hidden=m["hidden"], capacity_factor=m["cf"]))
        .layer(OutputLayer(n_in=m["d"], n_out=m["classes"], loss="mcxent",
                           activation="softmax")).build()).init("cuda")


def expert_parallel_phase(name_card):
    """Phase 30 (module docstring)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, TensorParallelTrainingMaster,
        tensor_parallel_spec,
    )

    t_phase = time.perf_counter()
    m = MOE
    rs = np.random.RandomState(5)
    ds = DataSet(rs.randn(MOE_ROWS, m["d"]).astype(np.float32),
                 np.eye(m["classes"], dtype=np.float32)[
                     rs.randint(0, m["classes"], MOE_ROWS)])
    net = _moe_net()
    spec = tensor_parallel_spec(net.params, EP_MESH["model"])
    print(f"expert_parallel: specs {spec['layer_1']}, router "
          f"{spec['layer_1']['W_router']}, head {spec['layer_2']['W']}")
    single = twin(net, True)
    p0 = _param_snapshot(net)
    master = TensorParallelTrainingMaster(mesh=_slots(**EP_MESH))
    _oracle_fit(
        f"expert_parallel (float32, SGD {PARALLEL_SGD_LR:g}, 4 model "
        f"slots of 2 experts) against the single net on {MOE_ROWS} rows",
        net, single,
        lambda: DistributedNetwork(net, master).fit(
            ListDataSetIterator(ds, MOE_ROWS)),
        lambda: single.fit(ds.features, ds.labels), p0, tol=TP_TOL)
    print(f"expert_parallel: the step's collectives "
          f"{_census('TensorParallelTrainingMaster.step')}")
    _drop(net)
    _drop(single)
    del net, single, master

    def fit_of(n):
        mm = TensorParallelTrainingMaster(mesh=_slots(**EP_MESH))
        f = lambda b: DistributedNetwork(n, mm).fit(  # noqa: E731
            ListDataSetIterator(b, MOE_ROWS))
        f.master = mm
        return f

    net, fit1 = _captured_against_eager(
        "expert_parallel bf16 Adam",
        lambda: _moe_net("bfloat16", "adam", 1e-3), fit_of, [ds, ds])
    med = _timed_epoch(fit1.master, net, ds)
    print(f"expert_parallel: bf16 Adam {med:.3f} ms a step over a fit of "
          f"{PARALLEL_TIMED} (4 model slots, {MOE_ROWS} rows on the card), "
          f"{MOE_ROWS / med * 1e3:.1f} rows/s [{name_card}]")
    _drop(net)
    del net
    print(f"expert_parallel: phase {time.perf_counter() - t_phase:.1f} s")


def _pool_mb(master):
    from deeplearning4j_tpu_torch.models import capture as cap

    progs = cap.step_graphs(master._h).programs.values()
    return sum((p.pool_bytes or 0) for p in progs) / 1e6


def pipeline_phase(name_card):
    """Phase 31 (module docstring).  Returns the wrapper launches of its
    float32 oracle and of its bf16 runs."""
    from deeplearning4j_tpu_torch.models import capture as cap
    from deeplearning4j_tpu_torch.parallel import (
        PipelineParallelTrainingMaster, find_periodic_run,
        measure_bubble_fraction,
    )
    from deeplearning4j_tpu_torch.parallel.pipeline import _layer_sig

    t_phase = time.perf_counter()
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    # a microbatch's attention, bf16 and the float32 oracle's tf32x3
    for dtype in (torch.bfloat16, torch.float32):
        flash_case(f"pipeline {str(dtype)[6:]}", 70,
                   (TRAIN_BATCH // PP_MICRO, TRAIN_T, TRAIN_MODEL["n_heads"],
                    128), dtype, True, None, flush, name_card)
    prologue_case("pipeline bf16", 71, TRAIN_T, TRAIN_MODEL["d_model"],
                  torch.bfloat16, False, False, flush, name_card)
    del flush
    layers = TRAIN_MODEL["layers"]
    both = _lm_batches(2, TRAIN_BATCH, seed=51)
    net = transformer_char_lm(device="cuda", updater="sgd", lr=PP_SGD_LR,
                              **TRAIN_MODEL_F32)
    run = find_periodic_run([_layer_sig(l) for l in net.layers], PP_STAGES)
    print(f"pipeline: find_periodic_run -> {run}")
    check(run == (1, 2, 8), f"pipeline: the periodic run {run}")
    single = twin(net, True)
    p0 = _param_snapshot(net)
    slots = ["cuda"] * PP_STAGES
    master = PipelineParallelTrainingMaster(
        n_stages=PP_STAGES, n_microbatches=PP_MICRO, devices=slots)

    def single_fit():
        for b in both:
            single.fit(b.features, b.labels)

    def step_of(m):
        # a step of m microbatches: each attention layer once a microbatch
        # forward and backward, two prologues a layer pair
        return {"flash_fwd": m * layers, "flash_dq": m * layers,
                "flash_dkv": m * layers, "prologue": 2 * m * layers}

    step = step_of(PP_MICRO)
    want = {k: 2 * n for k, n in step.items()}
    f32, _ = _oracle_fit(
        f"pipeline (float32, SGD {PP_SGD_LR:g}, {PP_STAGES} stages x "
        f"{PP_MICRO} microbatches) against the single net's fit", net,
        single, lambda: master.execute_training(net, both), single_fit, p0,
        want, tol=TP_TOL)
    check(master._compiled_kind == "periodic", "pipeline: the periodic path")
    census = _census("PipelineParallelTrainingMaster.step")
    print(f"pipeline: {cap.step_graphs(master._h).captures} capture(s); "
          f"the step's collectives {census} (a ppermute a tick, "
          f"{PP_MICRO + PP_STAGES - 1} ticks)")
    check(census.get("collective-permute", (0,))[0]
          == PP_MICRO + PP_STAGES - 1, "pipeline: a ppermute a tick")
    _drop(net)
    _drop(single)
    del net, single, master

    steps = _lm_batches(2, TRAIN_BATCH, seed=53)

    def fit_of(n, remat=False):
        mm = PipelineParallelTrainingMaster(
            n_stages=PP_STAGES, n_microbatches=PP_MICRO, devices=slots,
            remat=remat)
        fit_of.masters.append(mm)
        f = lambda b: mm.execute_training(n, [b])  # noqa: E731
        f.master = mm
        return f

    fit_of.masters = []
    _counts_zero()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net, fit1 = _captured_against_eager(
        "pipeline bf16 Adam",
        lambda: transformer_char_lm(device="cuda", **TRAIN_MODEL), fit_of,
        steps)
    bf16 = _held_launches("pipeline bf16 Adam, the captured and eager "
                          "twins", _twin_want(step))
    plain_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    med = _timed_epoch(fit1.master, net, steps[0])
    plain_pool = _pool_mb(fit_of.masters[0])
    print(f"pipeline: bf16 Adam {med:.3f} ms a step over a fit of "
          f"{PARALLEL_TIMED} ({PP_STAGES} stages, {PP_MICRO} microbatches "
          f"of 1 x 2048), {TRAIN_BATCH * TRAIN_T / med * 1e3:.1f} tokens/s;"
          f" graph pool {plain_pool:.1f} MB [{name_card}]")
    _drop(net)
    del net
    fit_of.masters.clear()
    rnet = transformer_char_lm(device="cuda", **TRAIN_MODEL)
    _counts_zero()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rfit = fit_of(rnet, remat=True)
    for b in steps:
        rfit(b)
    float(rnet.score_value)
    remat_pool = _pool_mb(fit_of.masters[0])
    remat_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    # the warm-up and the capture, each tick's forward run again in the
    # backward
    got = _held_launches("pipeline remat=True bf16 Adam", {
        k: 2 * n * (1 if k in ("flash_dq", "flash_dkv") else 2)
        for k, n in step.items()})
    bf16 = {k: bf16.get(k, 0) + got.get(k, 0) for k in bf16}
    print(f"pipeline: remat=True graph pool {remat_pool:.1f} MB against "
          f"{plain_pool:.1f} MB without; the first fits' peak above the "
          f"net (warm-up and capture) {remat_peak:.3f} GB against "
          f"{plain_peak:.3f} GB (the captured and eager twins) "
          f"[{name_card}]")
    _drop(rnet)
    del rnet

    def make_batch(n):
        return _lm_batches(1, n, seed=55)[0]

    _counts_zero()
    bub = measure_bubble_fraction(
        lambda: transformer_char_lm(device="cuda", **TRAIN_MODEL),
        make_batch, n_stages=PP_STAGES, mb_size=1, m_small=4, m_large=8,
        iters=PARALLEL_TIMED, devices=slots)
    # each net's warm-up and capture
    got = _held_launches("pipeline measure_bubble_fraction (M 4 and 8)", {
        k: 2 * (a + b) for (k, a), b in zip(step_of(4).items(),
                                            step_of(8).values())})
    bf16 = {k: bf16.get(k, 0) + got.get(k, 0) for k in bf16}
    print(f"pipeline: measure_bubble_fraction M 4 and 8: {bub}; analytic "
          f"3/7 = {3 / 7:.4f}, 3/11 = {3 / 11:.4f} [{name_card}]")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"pipeline: phase {time.perf_counter() - t_phase:.1f} s")
    return f32, bf16


def pipeline_hetero_phase(name_card):
    """Phase 32 (module docstring)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        PipelineParallelTrainingMaster,
    )

    t_phase = time.perf_counter()
    rs = np.random.RandomState(61)
    ds = DataSet(rs.rand(LENET_BATCH, 784).astype(np.float32),
                 np.eye(10, dtype=np.float32)[rs.randint(0, 10, LENET_BATCH)])
    base = lenet(device="cuda")
    for label, kw in (("compiled hetero", {}),
                      ("orchestrated gpipe", dict(mode="orchestrated")),
                      ("orchestrated 1f1b", dict(mode="orchestrated",
                                                 schedule="1f1b"))):
        net, single = twin(base, True), twin(base, True)
        p0 = _param_snapshot(net)
        master = PipelineParallelTrainingMaster(
            n_stages=2, n_microbatches=LENET_MICRO, devices=["cuda"] * 2,
            **kw)
        _oracle_fit(f"pipeline_hetero [{label}] (LeNet, 2 stages x "
                    f"{LENET_MICRO} microbatches of {LENET_BATCH})", net,
                    single, lambda: master.execute_training(net, [ds, ds]),
                    lambda: [single.fit(ds.features, ds.labels)
                             for _ in range(2)], p0, tol=TP_TOL)
        if label == "compiled hetero":
            check(master._compiled_kind == "hetero"
                  and master._hetero_sharded,
                  "pipeline_hetero: the sharded float32 rows")
            print(f"pipeline_hetero: rows [2, {master._flat_pmax}] of "
                  f"{base.num_params()} params")
        med = _timed_epoch(master, net, ds)
        print(f"pipeline_hetero [{label}]: {med:.3f} ms a step over a fit "
              f"of {PARALLEL_TIMED} [{name_card}]")
        _drop(net)
        _drop(single)
    _drop(base)
    print(f"pipeline_hetero: phase {time.perf_counter() - t_phase:.1f} s")


def sync_resnet_phase(name_card):
    """Phase 33 (module docstring).  Returns the BatchNorm training
    kernels' wrapper launches."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster,
    )

    t_phase = time.perf_counter()
    rs = np.random.RandomState(71)
    ds = DataSet(rs.rand(RESNET_BATCH, 224, 224, 3).astype(np.float32),
                 np.eye(1000, dtype=np.float32)[
                     rs.randint(0, 1000, RESNET_BATCH)])
    # eager: two float32 graph pools at batch 128 would not fit together
    net = resnet50(device="cuda", updater="sgd", lr=PARALLEL_SGD_LR,
                   seed=12345)
    net._capture = False
    single = twin(net, False)
    p0 = _param_snapshot(net)
    master = SyncTrainingMaster(mesh=_slots(data=RESNET_SLOTS))
    # one launch a layer: the kernels run once on the gathered rows
    want = {"bn_train_fwd": RESNET_BN_LAYERS,
            "bn_train_bwd": RESNET_BN_LAYERS}
    f32, _ = _oracle_fit(
        f"sync_resnet (float32, SGD {PARALLEL_SGD_LR:g}, {RESNET_SLOTS} "
        f"slots of {RESNET_BATCH // RESNET_SLOTS}) against the single net "
        f"on the {RESNET_BATCH} images", net, single,
        lambda: DistributedNetwork(net, master).fit(
            ListDataSetIterator(ds, RESNET_BATCH)),
        lambda: single.fit(ds.features, ds.labels), p0, want,
        noise=RESNET_NOISE)
    print(f"sync_resnet: the step's collectives "
          f"{_census('SyncTrainingMaster.step')} (an all-gather a "
          f"BatchNorm: its rows gathered)")
    _drop(net)
    _drop(single)
    del net, single, master
    _counts_zero()

    def fit_of(n):
        m = SyncTrainingMaster(mesh=_slots(data=RESNET_SLOTS))
        f = lambda b: DistributedNetwork(n, m).fit(  # noqa: E731
            ListDataSetIterator(b, RESNET_BATCH))
        f.master = m
        return f

    net, fit1 = _captured_against_eager(
        "sync_resnet bf16", lambda: resnet50(device="cuda", **RESNET),
        fit_of, [ds, ds])
    bf16 = _held_launches("sync_resnet bf16, the captured and eager twins",
                          _twin_want(want))
    med = _timed_epoch(fit1.master, net, ds)
    print(f"sync_resnet: bf16 {med:.3f} ms a step over a fit of "
          f"{PARALLEL_TIMED} (images on the card; {RESNET_SLOTS} slots of "
          f"{RESNET_BATCH // RESNET_SLOTS}), "
          f"{RESNET_BATCH / med * 1e3:.1f} images/s [{name_card}]")
    _drop(net)
    del net
    print(f"sync_resnet: phase {time.perf_counter() - t_phase:.1f} s")
    return {k: f32.get(k, 0) + bf16.get(k, 0)
            for k in ("bn_train_fwd", "bn_train_bwd")}


# ------------------------------------------------------------ the nlp phase
NLP_SEED = 12345            # the corpus's seed and every fit's (--seed)
# text8 has 17 M; cut to 200,000 so that the whole run stays inside its
# time limit on a slow host (PERF.md section 4 lists every cut)
NLP_TOKENS = 200_000
NLP_TYPES = 71290           # text8's vocabulary at min count 5
NLP_SENTENCE = (10, 30)     # words a sentence, uniform
NLP_CUT = 60_000            # GloVe's and the distributed fit's (cut from 200,000)
NLP_DOCS = 2_000            # ParagraphVectors' documents (cut from 10,000)
NLP_INFER = 50              # documents inferred and predicted (cut from 100)
NLP_QUERIES = 1000          # words_nearest queries on (a)'s model
NLP_SLOTS = 4               # DistributedWord2Vec's slots of cuda:0
NLP_SPILL_PAIRS = 250_000   # the spilled GloVe's pairs in RAM
NLP_CHECK_SENTENCES = 2000  # the captured-against-eager fits' corpus
NLP_TOL = dict(rtol=1e-5, atol=1e-6)
NLP_DIST_ATOL = 1e-4        # tests/test_nlp_distributed.py:74
NLP_PURITY = 0.8            # tests/test_glove_streaming.py:137-138
NLP_BASELINE = (0.97, 1.00)     # BASELINE.md:35, Word2Vec / GloVe
NLP_WEATHER = ["rain", "snow", "storm", "cloud", "wind", "sun"]
NLP_FINANCE = ["bank", "money", "stock", "market", "trade", "price"]


def nlp_corpus(seed, tokens=NLP_TOKENS, types=NLP_TYPES):
    """``tokens`` words drawn by a Zipf law (s = 1) over ``types`` word
    types, in sentences of 10-30 words (the last one what is left)."""
    rs = np.random.RandomState(seed)
    cdf = np.cumsum(1.0 / np.arange(1, types + 1))
    ids = np.minimum(np.searchsorted(cdf / cdf[-1], rs.rand(tokens)),
                     types - 1)
    words = np.array([f"w{i}" for i in range(types)], dtype=object)[ids]
    lens = rs.randint(NLP_SENTENCE[0], NLP_SENTENCE[1] + 1,
                      tokens // NLP_SENTENCE[0] + 1)
    ends = np.cumsum(lens)
    ends = np.append(ends[ends < tokens], tokens)
    starts = np.concatenate([[0], ends[:-1]])
    return [" ".join(words[a:b]) for a, b in zip(starts, ends)]


def _tokens_in(sentences):
    return sum(s.count(" ") + 1 for s in sentences)


def _cut(sentences, tokens):
    """The first sentences holding ``tokens`` words."""
    n = np.searchsorted(np.cumsum([s.count(" ") + 1 for s in sentences]),
                        tokens) + 1
    return sentences[:n]


def two_topic_corpus(n=400, seed=7):
    """The reference's quality corpus (``tests/test_glove_streaming.py``
    ``synthetic_corpus``)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        topic = NLP_WEATHER if i % 2 == 0 else NLP_FINANCE
        out.append(" ".join(rs.choice(topic, size=10)))
    return out


def cluster_purity(model, clusters, top_n=3):
    """wordsNearest top-n neighbours that stay in the query's cluster
    (``tests/test_glove_streaming.py::_cluster_purity``)."""
    hits = total = 0
    for cluster in clusters:
        for w in cluster:
            for n in model.words_nearest([w], top_n=top_n):
                total += 1
                hits += n in cluster
    return hits / max(1, total)


class _FitClock:
    """One fit's split: host time inside the step calls (staging and the
    replay's launch) and outside them (pair building, batch assembly),
    and CUDA events around each program's run (the graph's replay on
    the device, after its inputs were staged).  Installed over
    ``StepPrograms.call`` and ``StepGraphs.run`` for the block."""

    def __init__(self):
        self.events, self.in_call = [], 0.0
        self.first = self.last = None

    def __enter__(self):
        call, run = self._orig = (nlp_learning.StepPrograms.call,
                                  capture_mod.StepGraphs.run)
        clock = self

        def timed_call(programs, *args, **kwargs):
            t0 = time.perf_counter()
            if clock.first is None:
                clock.first = t0
            out = call(programs, *args, **kwargs)
            clock.last = time.perf_counter()
            clock.in_call += clock.last - t0
            return out

        def timed_run(graphs, *args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = run(graphs, *args, **kwargs)
            e1.record()
            clock.events.append((e0, e1))
            return out

        nlp_learning.StepPrograms.call = timed_call
        capture_mod.StepGraphs.run = timed_run
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        (nlp_learning.StepPrograms.call,
         capture_mod.StepGraphs.run) = self._orig
        return False

    def report(self, what, model, words, name_card):
        """Reads the loss (the fit's end: one sync), then prints words/s,
        ms a batch on the host outside and inside the calls and on the
        device, the idle share over the batches' span, and the program's
        captures and replays.  Returns the numbers."""
        loss = model.cum_loss
        t_end = time.perf_counter()
        n = len(self.events)
        device_ms = sum(a.elapsed_time(b) for a, b in self.events)
        span = t_end - self.first
        wall = t_end - self.t0
        caps = model.programs.counts()
        out = dict(wall_s=wall, setup_s=self.first - self.t0, batches=n,
                   words_per_s=words / wall,
                   host_ms=((self.last - self.first) - self.in_call)
                   * 1e3 / max(n - 1, 1),
                   call_ms=self.in_call * 1e3 / n, device_ms=device_ms / n,
                   idle=1.0 - device_ms / (span * 1e3), loss=loss, **caps)
        print(f"nlp {what}: {words} words in {wall:.3f} s "
              f"({out['words_per_s']:.1f} words/s, fit call to the last "
              f"loss read; set-up {out['setup_s']:.3f} s); {n} batches: "
              f"host {out['host_ms']:.4f} ms a batch building pairs, "
              f"{out['call_ms']:.4f} ms staging and launching, device "
              f"{out['device_ms']:.4f} ms (CUDA events around the "
              f"replay), idle share "
              f"{out['idle']:.4f}; {caps['captures']} captures, "
              f"{caps['replays']} replays; cum_loss {loss:.6g} "
              f"({name_card})")
        check(math.isfinite(loss), f"nlp {what}: a finite loss")
        check(caps["captures"] >= 1 and caps["replays"] + caps["captures"]
              == n, f"nlp {what}: every batch a captured program: {caps}")
        return out


def _timed_fit(what, model, words, name_card):
    with _FitClock() as clock:
        model.fit()
    return clock.report(what, model, words, name_card)


def _w2v(sentences, device="cuda", **kw):
    """Word2Vec at the ``VectorsConfiguration`` defaults (layer 100,
    window 5, batch 512, lr 0.025, HS skip-gram, one epoch), ``kw``
    applied to the Builder."""
    b = nlp.Word2Vec.Builder().iterate(sentences).seed(NLP_SEED)
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.device(device).build()


def _demo_word(sentences, device="cuda"):
    """word2vec's ``demo-word.sh`` on text8: CBOW, 200 wide, window 8, 25
    negatives, no hierarchical softmax, sampling 1e-4, alpha 0.05 (its
    CBOW default), one epoch."""
    return _w2v(sentences, device, layer_size=200, window_size=8,
                negative_sample=25, use_hierarchic_softmax=False,
                sampling=1e-4, learning_rate=0.05,
                elements_learning_algorithm="cbow")


def _glove(sentences, spill=None, device="cuda"):
    """GloVe at its defaults (layer 100, window 15, batch 1024, lr 0.05,
    x_max 100, alpha 0.75), one epoch."""
    b = (nlp.Glove.Builder().iterate(sentences).epochs(1).seed(NLP_SEED)
         .device(device))
    if spill:
        b.max_memory_pairs(spill)
    return b.build()


def _max_abs(a, b):
    return float((a.detach().cpu().double() - b.detach().cpu().double())
                 .abs().max())


def _nlp_step_case(what, fn, mats, args, scalars, name_card, **kw):
    """``fn`` on the card and on CPU copies of the same inputs: every
    matrix and the loss within ``NLP_TOL``."""
    card = [m.clone() for m in mats]
    host = [m.cpu().clone() for m in mats]
    lc = fn(*card, *args, *scalars, **kw)
    lh = fn(*host, *[a.cpu() for a in args], *[s.cpu() for s in scalars],
            **kw)
    err = max(_max_abs(a, b) for a, b in zip(card, host))
    ok = all(torch.allclose(a.cpu(), b, **NLP_TOL)
             for a, b in zip(card, host))
    print(f"nlp step {what}: card against CPU, max-abs {err:.3e}, loss "
          f"{float(lc):.6g} against {float(lh):.6g} ({name_card})")
    check(ok and math.isclose(float(lc), float(lh), rel_tol=NLP_TOL["rtol"],
                              abs_tol=NLP_TOL["atol"]),
          f"nlp step {what}: the card within {NLP_TOL} of the CPU")
    return err


def _first_batch(model):
    """The first batch ``model``'s pair stream gives, padded as its step
    pads it, on the card."""
    batch = next(model._batches())
    n = len(batch["targets"])
    B = model._padded(n)
    key = "inputs" if batch["kind"] == "sg" else "contexts"
    cols = {"targets": model._pad(batch["targets"], B),
            "mask": model._pad(np.ones(n, np.float32), B),
            key: model._pad(batch[key], B, fill=-1 if key == "contexts"
                            else 0)}
    return {k: torch.as_tensor(v).cuda() for k, v in cols.items()}


def nlp_step_checks(sg, cbow, glove_cut, name_card):
    """Each of the five steps at its path's shapes: skip-gram on (a)'s
    matrices and first batch (hierarchical softmax, and negative
    sampling with demo-word's 25 negatives over (a)'s syn1 as the output
    weights), CBOW on (b)'s matrices and batch (negative sampling) and on
    (a)'s Huffman tree with (b)'s contexts (the two fits share a
    vocabulary), GloVe on a fitted model's state and 1024 pairs counted
    from the cut's first sentences."""
    lr = torch.tensor(0.025, device="cuda")
    a, b = sg.lookup, cbow.lookup
    bs = _first_batch(sg)
    pts, cds, cm = sg._path(bs["targets"])
    _nlp_step_case("sg_hs", nlp_learning.sg_hs_step, [a.syn0, a.syn1],
                   [bs["inputs"], pts, cds, cm, bs["mask"]], [lr], name_card)
    negs = a.sample_negatives(rng_mod.device_key(NLP_SEED, "cuda"),
                              (bs["targets"].shape[0], 25))
    _nlp_step_case("sg_ns", nlp_learning.sg_ns_step, [a.syn0, a.syn1],
                   [bs["inputs"], bs["targets"], negs, bs["mask"]], [lr],
                   name_card)
    bc = _first_batch(cbow)
    ctx_mask = (bc["contexts"] >= 0).float()
    negs = b.sample_negatives(rng_mod.device_key(NLP_SEED, "cuda"),
                              (bc["targets"].shape[0], 25))
    _nlp_step_case("cbow_ns", nlp_learning.cbow_ns_step,
                   [b.syn0, b.syn1neg],
                   [bc["contexts"], ctx_mask, bc["targets"], negs,
                    bc["mask"]], [lr], name_card)
    pts, cds, cm = sg._path(bc["targets"])
    _nlp_step_case("cbow_hs", nlp_learning.cbow_hs_step, [a.syn0, a.syn1],
                   [bc["contexts"], ctx_mask, pts, cds, cm, bc["mask"]],
                   [lr], name_card)
    g = _glove(glove_cut[:NLP_CHECK_SENTENCES])
    g.fit()
    cooc = nlp.CoOccurrences(g.vocab, g.window).fit_sentences(
        s.split() for s in glove_cut[:200])
    rows, cols, vals = cooc.as_arrays()
    pick = np.random.RandomState(NLP_SEED).permutation(len(rows))[:1024]
    batch = [torch.as_tensor(x[pick]).cuda() for x in (rows, cols, vals)]
    batch.append(torch.ones(len(pick), device="cuda"))
    _nlp_step_case("glove", nlp_learning.glove_step, list(g._state), batch,
                   [torch.tensor(v, device="cuda")
                    for v in (g.learning_rate, g.x_max, g.alpha)], name_card)


def nlp_capture_checks(sentences, name_card):
    """Short fits captured and eager (the models' internal ``_capture``
    off) from one seed, within ``NLP_TOL``: (a)'s and (b)'s settings,
    GloVe's and the distributed engine's."""
    part = sentences[:NLP_CHECK_SENTENCES]

    def slots():
        return mesh_mod.default_mesh(data=NLP_SLOTS,
                                     devices=["cuda"] * NLP_SLOTS)

    def dist():
        return (nlp_dist.DistributedWord2Vec.Builder().iterate(part)
                .seed(NLP_SEED).mesh(slots()).build())

    for what, make, names in (
            ("sg_hs", lambda: _w2v(part), ("syn0", "syn1")),
            ("cbow_ns", lambda: _demo_word(part), ("syn0", "syn1neg")),
            ("glove", lambda: _glove(part), ("syn0",)),
            ("distributed", dist, ("syn0", "syn1"))):
        cap, eager = make(), make()
        eager._capture = False
        cap.fit()
        eager.fit()
        errs = [_max_abs(getattr(cap.lookup, n), getattr(eager.lookup, n))
                for n in names]
        ok = all(torch.allclose(getattr(cap.lookup, n),
                                getattr(eager.lookup, n), **NLP_TOL)
                 for n in names)
        counts = cap.programs.counts()
        print(f"nlp captured against eager, {what}: max-abs "
              f"{max(errs):.3e}, cum_loss {cap.cum_loss:.9g} against "
              f"{eager.cum_loss:.9g}; captured {counts}, eager "
              f"{eager.programs.counts()} ({name_card})")
        check(ok and counts["captures"] >= 1
              and eager.programs.counts()["captures"] == 0,
              f"nlp {what}: captured within {NLP_TOL} of eager")


def nlp_quality(name_card):
    """The reference's quality protocol on the card: wordsNearest top-3
    purity on the two-topic corpus, HS skip-gram Word2Vec and spilled
    GloVe at the reference test's settings."""
    corpus = two_topic_corpus(400)
    clusters = [NLP_WEATHER, NLP_FINANCE]
    w = (nlp.Word2Vec.Builder().iterate(corpus).layer_size(24)
         .window_size(4).epochs(8).min_word_frequency(2).seed(5)
         .device("cuda").build().fit())
    g = (nlp.Glove.Builder().iterate(corpus).layer_size(24).window_size(4)
         .epochs(12).learning_rate(0.1).min_word_frequency(2).seed(3)
         .max_memory_pairs(64).device("cuda").build().fit())
    pw, pg = cluster_purity(w, clusters), cluster_purity(g, clusters)
    print(f"nlp quality: wordsNearest top-3 purity Word2Vec {pw:.3f}, "
          f"GloVe {pg:.3f} (BASELINE.md: {NLP_BASELINE[0]:.2f} / "
          f"{NLP_BASELINE[1]:.2f}) ({name_card})")
    check(pw > NLP_PURITY and pg > NLP_PURITY,
          f"nlp quality: purity above {NLP_PURITY}")


def nlp_phase(name_card, seed=NLP_SEED):
    """The NLP embedding stack on the card (see the module docstring)."""
    global NLP_SEED
    NLP_SEED = seed
    t0 = time.perf_counter()
    sentences = nlp_corpus(seed)
    cut = _cut(sentences, NLP_CUT)
    n_words, n_cut = _tokens_in(sentences), _tokens_in(cut)
    print(f"nlp corpus: {n_words} tokens in {len(sentences)} sentences, "
          f"Zipf (s = 1) over {NLP_TYPES} types, seed {seed}; the cut "
          f"{n_cut} tokens in {len(cut)} sentences; made in "
          f"{time.perf_counter() - t0:.3f} s")
    # (a), twice from one seed
    sg = _w2v(sentences)
    fits = {"a": _timed_fit("(a) Word2Vec skip-gram HS", sg, n_words,
                            name_card)}
    V = len(sg.vocab)
    print(f"nlp (a): V {V}, syn0 {sg.lookup.syn0.nbytes} bytes, syn1 "
          f"{sg.lookup.syn1.nbytes} bytes")
    # twice from one seed, on the cut (cut from the whole corpus)
    once = _w2v(cut).fit()
    again = _w2v(cut).fit()
    gap = _max_abs(once.syn0, again.syn0)
    del once
    print(f"nlp (a) run twice from seed {seed} on the cut: syn0 max-abs "
          f"{gap:.3e} "
          f"(index_add_ on CUDA is not ordered; the reference's docstrings "
          f"promise determinism given the seed) ({name_card})")
    del again
    # (b)
    cbow = _demo_word(sentences)
    fits["b"] = _timed_fit("(b) Word2Vec CBOW NS (demo-word)", cbow,
                           n_words, name_card)
    print(f"nlp (b): V {len(cbow.vocab)}, syn0 {cbow.lookup.syn0.nbytes} "
          f"bytes, syn1neg {cbow.lookup.syn1neg.nbytes} bytes")
    check(cbow.vocab.words() == sg.vocab.words(),
          "nlp: (a) and (b) share one vocabulary")
    # (c)
    docs = [nlp.LabelledDocument(content=s, labels=[f"DOC_{i}"])
            for i, s in enumerate(sentences[:NLP_DOCS])]
    pv = (nlp.ParagraphVectors.Builder().iterate(docs).seed(seed)
          .device("cuda").build())
    fits["c"] = _timed_fit("(c) ParagraphVectors DBOW", pv,
                           _tokens_in(sentences[:NLP_DOCS]), name_card)
    t1 = time.perf_counter()
    inferred = [pv.infer_vector(d.content) for d in docs[:NLP_INFER]]
    t_infer = (time.perf_counter() - t1) * 1e3 / NLP_INFER
    t1 = time.perf_counter()
    predicted = [pv.predict(d.content) for d in docs[:NLP_INFER]]
    t_predict = (time.perf_counter() - t1) * 1e3 / NLP_INFER
    hits = sum(p == d.label for p, d in zip(predicted, docs))
    print(f"nlp (c): infer_vector {t_infer:.3f} ms a document, predict "
          f"{t_predict:.3f} ms; {hits} of {NLP_INFER} predicted as their "
          f"own label ({name_card})")
    check(all(v.shape == (pv.config.layer_size,) and np.isfinite(v).all()
              for v in inferred) and all(p is not None for p in predicted),
          "nlp (c): finite inferred vectors and a label for each")
    # (d)
    for what, spill in (("in RAM", None), ("spilled", NLP_SPILL_PAIRS)):
        g = _glove(cut, spill)
        fits["d " + what] = _timed_fit(f"(d) GloVe {what}", g, n_cut,
                                       name_card)
        check(bool(torch.isfinite(g.lookup.syn0).all()),
              f"nlp (d) {what}: finite vectors")
    # (e)
    serial = _w2v(cut).fit()
    mesh = mesh_mod.default_mesh(data=NLP_SLOTS, devices=["cuda"] * NLP_SLOTS)
    dist = (nlp_dist.DistributedWord2Vec.Builder().iterate(cut).seed(seed)
            .mesh(mesh).build())
    with mesh_mod.census() as census:
        fits["e"] = _timed_fit(f"(e) DistributedWord2Vec, {NLP_SLOTS} slots",
                               dist, n_cut, name_card)
    err = _max_abs(dist.syn0, serial.syn0)
    red = census.counts.get("all-reduce", {})
    print(f"nlp (e): syn0 max-abs {err:.3e} against the serial fit of the "
          f"cut (atol {NLP_DIST_ATOL}); census {red.get('count')} "
          f"all-reduces, {red.get('bytes', 0.0):.0f} bytes (counted at "
          f"the warm-up and the capture) ({name_card})")
    check(err <= NLP_DIST_ATOL, "nlp (e): the slots equal the serial fit")
    # (f)
    rs = np.random.RandomState(seed)
    words = sg.vocab.words()
    queries = [words[i] for i in rs.randint(0, V, NLP_QUERIES)]
    times = []
    for w in queries:
        t1 = time.perf_counter()
        near = sg.words_nearest(w, top_n=10)
        times.append(time.perf_counter() - t1)
        check(len(near) == 10 and w not in near,
              f"nlp (f): ten neighbours of {w}")
    print(f"nlp (f): {NLP_QUERIES} words_nearest queries, "
          f"{np.mean(times) * 1e3:.4f} ms a query (median "
          f"{np.median(times) * 1e3:.4f}) over V {V} ({name_card})")
    # checks
    nlp_step_checks(sg, cbow, cut, name_card)
    nlp_capture_checks(sentences, name_card)
    nlp_quality(name_card)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/a.zip"
        nlp.WordVectorSerializer.write_full_model(sg, path)
        back = nlp.WordVectorSerializer.read_full_model(path, device="cpu")
    check(torch.equal(back.lookup.syn0, sg.syn0.cpu())
          and torch.equal(back.lookup.syn1, sg.lookup.syn1.cpu())
          and back.vocab.words() == sg.vocab.words(),
          "nlp: the card's zip read back on the CPU, equal vectors")
    print(f"nlp zip: (a)'s full model written from the card and read on "
          f"the CPU, vectors equal; phase {time.perf_counter() - t0:.1f} s")
    return fits


# ------------------------------------------- the graphs and clustering phases
# BlogCatalog (Tang and Liu, KDD 2009; the DeepWalk paper's first set):
# vertices, undirected edges, groups; the planted partition's share of
# edges inside a group
GRAPH_V, GRAPH_E, GRAPH_GROUPS, GRAPH_INSIDE = 10312, 333983, 39, 0.7
# DeepWalk (Perozzi et al., KDD 2014): d 128, window 10, walks of 40;
# gamma (walks a vertex) cut from 80 to 2 (PERF.md section 4)
DEEPWALK = dict(vector_size=128, window_size=10, walk_length=40,
                walks_per_vertex=2, learning_rate=0.025, batch_size=512,
                epochs=1)
GRAPH_CPU_WALKS = 500       # the card's fit against the CPU's (cut from 2000)
GRAPH_QUERIES = 1000        # vertices_nearest queries
# At lr 0.025 one epoch over 2 walks a vertex leaves the vectors near
# their start (the reference's step gives a row hit k times in a batch
# the mean of its k updates, and every HS path crosses the tree's top):
# k-means on them is at chance.  The quality fit trains on the same
# walks at lr 1.0; its purity's bar comes from a CPU rehearsal at full
# size (0.9232; PERF.md section 6)
GRAPH_QUALITY_LR = 1.0
GRAPH_PURITY = 0.8
# MNIST's size (70000 x 784, ten classes), the JAX defaults
KMEANS_N, KMEANS_D, KMEANS_K = 70000, 784, 10
KMEANS_TOL = dict(rtol=1e-5, atol=1e-6)
KMEANS_NEAR_TIE = 1e-5      # relative gap of a point's two nearest centres
# van der Maaten's tsne.py example: 2500 MNIST digits reduced to 50 dims;
# the JAX defaults (perplexity 30, 500 iterations, lr 200)
TSNE_N, TSNE_D, TSNE_STEPS_CHECKED = 2500, 50, 10
TSNE_ATOL = 1e-5
TSNE_SEPARATION = 2.0       # tests/test_clustering.py:128-134
BH_N, BH_ITERS, BH_THETA = 300, 10, 0.5   # iterations cut from 50
BH_GRAD_RTOL = 1e-5
VITERBI_LABELS, VITERBI_T, VITERBI_S = 100_000, 10_000, 64


def planted_partition(seed, V=GRAPH_V, E=GRAPH_E, groups=GRAPH_GROUPS,
                      inside=GRAPH_INSIDE):
    """A planted-partition graph: ``V`` vertices in ``groups`` groups of
    near-equal size, ``E`` distinct undirected edges (no self-loops),
    ``inside`` of them between two vertices of one group.  Returns the
    group of each vertex and the ``[E, 2]`` edges in insertion order."""
    rs = np.random.RandomState(seed)
    group = rs.permutation(np.arange(V) % groups)
    members = np.argsort(group, kind="stable")
    counts = np.bincount(group, minlength=groups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    def draw(n, same):
        got = np.empty((0, 2), np.int64)
        while len(got) < n:
            m = int((n - len(got)) * 1.3) + 64
            a = rs.randint(0, V, m)
            if same:
                g = group[a]
                b = members[starts[g] + (rs.rand(m) * counts[g]).astype(
                    np.int64)]
            else:
                b = rs.randint(0, V, m)
            keep = (a != b) & ((group[a] == group[b]) == same)
            pairs = np.stack([np.minimum(a, b), np.maximum(a, b)], 1)[keep]
            got = np.unique(np.concatenate([got, pairs]), axis=0)
        return got[rs.permutation(len(got))[:n]]

    n_in = int(round(E * inside))
    edges = np.concatenate([draw(n_in, True), draw(E - n_in, False)])
    return group, edges[rs.permutation(E)]


def _vertex_vectors(dw, V):
    """DeepWalk's ``syn0`` rows in vertex order, unit length, on the
    card."""
    idx = torch.as_tensor([dw.vocab.index_of(str(v)) for v in range(V)],
                          device=dw.lookup.syn0.device)
    vecs = dw.lookup.syn0[idx]
    return vecs / torch.linalg.norm(vecs, dim=1, keepdim=True).clamp_min(
        1e-12)


def group_cosines(vecs, group):
    """Mean cosine over pairs of distinct vertices of one group and over
    pairs of two groups, from the group sums of the unit vectors."""
    V = vecs.shape[0]
    onehot = F.one_hot(torch.as_tensor(group, device=vecs.device)).to(
        torch.float64)
    sums = onehot.T @ vecs.double()                    # [G, d]
    total = vecs.double().sum(0)
    n = np.bincount(group).astype(np.float64)
    within = float((sums * sums).sum()) - V            # unit self-pairs
    every = float(total @ total) - V
    pairs_in = float((n * n).sum()) - V
    pairs_all = float(V) * V - V
    return within / pairs_in, (every - within) / (pairs_all - pairs_in)


def cluster_purity_of(assign, group):
    """Points in their cluster's most common group, over all points."""
    hits = 0
    for c in np.unique(assign):
        hits += np.bincount(group[assign == c]).max()
    return hits / len(assign)


def graphs_phase(name_card, seed=NLP_SEED):
    """DeepWalk on a BlogCatalog-sized planted-partition graph (see the
    module docstring)."""
    from deeplearning4j_tpu_torch import clustering, graphs
    from deeplearning4j_tpu_torch.nlp.vocab import Sequence, VocabWord

    t0 = time.perf_counter()
    group, edges = planted_partition(seed)
    t_edges = time.perf_counter() - t0
    t1 = time.perf_counter()
    g = graphs.Graph(GRAPH_V)
    for a, b in edges.tolist():
        g.add_edge(a, b)
    t_graph = time.perf_counter() - t1
    inside = float(np.mean(group[edges[:, 0]] == group[edges[:, 1]]))
    print(f"graphs: planted partition, {GRAPH_V} vertices, "
          f"{g.num_edges() // 2} undirected edges ({inside:.4f} inside "
          f"a group), {GRAPH_GROUPS} groups, seed {seed}; edges drawn in "
          f"{t_edges:.3f} s, Graph built in {t_graph:.3f} s (host)")
    check(g.num_edges() == 2 * GRAPH_E, "graphs: every edge in the graph")
    t1 = time.perf_counter()
    walks = graphs.generate_walks(g, DEEPWALK["walk_length"],
                                  DEEPWALK["walks_per_vertex"], seed=seed)
    t_walks = time.perf_counter() - t1
    tokens = walks.size
    t1 = time.perf_counter()
    objects = 0
    for row in walks:
        seq = Sequence()
        for v in row:
            seq.add_element(VocabWord(label=str(int(v))))
        objects += len(seq.elements)
    t_objects = time.perf_counter() - t1
    print(f"graphs: {len(walks)} walks of {walks.shape[1]} vertices "
          f"({tokens} tokens) in {t_walks:.3f} s of host numpy; one pass "
          f"turning them into {objects} VocabWord objects {t_objects:.3f} s "
          f"(the fit makes two such passes: the vocabulary, then the "
          f"pairs; both inside its set-up and host ms)")
    dw = graphs.DeepWalk(seed=seed, device="cuda", **DEEPWALK)
    with _FitClock() as clock:
        dw.fit(g, walks=walks)
    fit = clock.report("graphs DeepWalk (skip-gram HS)", dw, tokens,
                       name_card)
    # the card against the CPU on the first walks
    part = walks[:GRAPH_CPU_WALKS]
    card_dw = graphs.DeepWalk(seed=seed, device="cuda", **DEEPWALK).fit(
        g, walks=part)
    t1 = time.perf_counter()
    host_dw = graphs.DeepWalk(seed=seed, device="cpu", **DEEPWALK).fit(
        g, walks=part)
    t_host = time.perf_counter() - t1
    errs = [_max_abs(getattr(card_dw.lookup, n), getattr(host_dw.lookup, n))
            for n in ("syn0", "syn1")]
    ok = all(torch.allclose(getattr(card_dw.lookup, n).cpu(),
                            getattr(host_dw.lookup, n), **NLP_TOL)
             for n in ("syn0", "syn1"))
    print(f"graphs: the card's fit on the first {GRAPH_CPU_WALKS} walks "
          f"against the CPU's (same walks, tree, weights, pairs): syn0 "
          f"max-abs {errs[0]:.3e}, syn1 {errs[1]:.3e}, cum_loss "
          f"{card_dw.cum_loss:.9g} against {host_dw.cum_loss:.9g} (the CPU "
          f"fit {t_host:.3f} s) ({name_card})")
    check(ok, f"graphs: the card's DeepWalk within {NLP_TOL} of the CPU's")
    del card_dw, host_dw
    # the reference test's oracle and the planted groups, on the fit at
    # the paper's lr and on the quality fit
    chance = np.random.RandomState(seed).permutation(group)
    quality = None
    for what, model in (("lr 0.025", dw), ("lr 1.0", None)):
        if model is None:
            model = quality = graphs.DeepWalk(
                seed=seed, device="cuda",
                **dict(DEEPWALK, learning_rate=GRAPH_QUALITY_LR)).fit(
                    g, walks=walks)
        vecs = _vertex_vectors(model, GRAPH_V)
        within, across = group_cosines(vecs, group)
        t1 = time.perf_counter()
        km = clustering.KMeansClustering(GRAPH_GROUPS, seed=seed,
                                         device="cuda")
        cs = km.apply_to(vecs)
        t_km = time.perf_counter() - t1
        purity = cluster_purity_of(cs.assignments, group)
        print(f"graphs ({what}): mean cosine within a group {within:.4f}, "
              f"across {across:.4f}; k-means (K {GRAPH_GROUPS}) on the unit "
              f"vectors {km.iterations_} iterations, {t_km:.3f} s, purity "
              f"against the planted groups {purity:.4f} (against shuffled "
              f"groups {cluster_purity_of(cs.assignments, chance):.4f}) "
              f"({name_card})")
        check(within > across, f"graphs ({what}): within-group cosine "
              "above across")
    check(purity > GRAPH_PURITY, f"graphs: the quality fit's purity above "
          f"{GRAPH_PURITY}")
    rs = np.random.RandomState(seed)
    queries = rs.randint(0, GRAPH_V, GRAPH_QUERIES)
    times, same = [], 0
    for v in queries.tolist():
        t1 = time.perf_counter()
        near = dw.vertices_nearest(v, top_n=10)
        times.append(time.perf_counter() - t1)
        check(len(near) == 10 and v not in near,
              f"graphs: ten neighbours of {v}")
        same += sum(group[u] == group[v]
                    for u in quality.vertices_nearest(v, top_n=10))
    print(f"graphs: {GRAPH_QUERIES} vertices_nearest queries, "
          f"{np.mean(times) * 1e3:.4f} ms a query (median "
          f"{np.median(times) * 1e3:.4f}); the quality fit's neighbours "
          f"in the query's group {same / (10 * GRAPH_QUERIES):.4f}; "
          f"similarity(0, 1) {dw.similarity(0, 1):.4f}; phase "
          f"{time.perf_counter() - t0:.1f} s ({name_card})")
    return fit


def _mnist_like(seed, n, d, classes=10):
    """``n`` points in [0, 1]^d from ``classes`` seeded prototypes (a
    stroke mask shared by all, 0.8, and one of the class's own, 0.2),
    scaled and noised, float32: k-means on them takes tens of
    iterations to a purity near 0.6, as on MNIST."""
    rs = np.random.RandomState(seed)
    base = (rs.rand(d) < 0.2) * rs.uniform(0.5, 1.0, d)
    own = (rs.rand(classes, d) < 0.2) * rs.uniform(0.5, 1.0, (classes, d))
    proto = 0.8 * base + 0.2 * own
    labels = rs.randint(0, classes, n)
    x = proto[labels] * rs.uniform(0.6, 1.0, (n, 1)) \
        + 0.3 * rs.randn(n, d)
    return np.clip(x, 0.0, 1.0).astype(np.float32), labels


def _inertia64(x, centers, assign, rows=8192):
    total = 0.0
    c = centers.astype(np.float64)
    for i in range(0, len(x), rows):
        diff = x[i:i + rows].astype(np.float64) - c[assign[i:i + rows]]
        total += float((diff * diff).sum())
    return total


def kmeans_case(name_card, seed):
    from deeplearning4j_tpu_torch.clustering import KMeansClustering, kmeans

    t0 = time.perf_counter()
    x, labels = _mnist_like(seed, KMEANS_N, KMEANS_D)
    t_data = time.perf_counter() - t0
    km = KMeansClustering(KMEANS_K, seed=seed, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cs = km.apply_to(x)
    total = time.perf_counter() - t1
    # the iterations alone, again from the same centres (CUDA events)
    pts = torch.as_tensor(x).cuda()
    c0 = pts[torch.as_tensor(kmeans._init_centers(x, KMEANS_K, seed),
                             device="cuda")]
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    centers, _, inertia, its = kmeans._lloyd(pts, c0, km.max_iterations,
                                             km.tol)
    e1.record()
    torch.cuda.synchronize()
    loop_ms = e0.elapsed_time(e1)
    check(its == km.iterations_ and torch.equal(centers.cpu(), torch.as_tensor(
        cs.centers)), "clustering (a): the loop again gives the same centres")
    purity = cluster_purity_of(cs.assignments, labels)
    ref = _inertia64(x, cs.centers, cs.assignments)
    rel = abs(cs.inertia - ref) / ref
    print(f"clustering (a) k-means: {KMEANS_N} x {KMEANS_D} float32, K "
          f"{KMEANS_K}, ten seeded classes (made in {t_data:.3f} s); "
          f"{km.iterations_} iterations, {loop_ms / km.iterations_:.4f} ms "
          f"an iteration (CUDA events around the loop and the final "
          f"assignment, over the iterations), apply_to {total:.3f} s with "
          f"the host's k-means++; inertia {cs.inertia:.8g} against "
          f"{ref:.8g} in float64 numpy from its own assignments (rel "
          f"{rel:.3e}); purity {purity:.4f} ({name_card})")
    check(rel <= KMEANS_TOL["rtol"], "clustering (a): the inertia within "
          f"rtol {KMEANS_TOL['rtol']} of the float64 sum")
    # one iteration on the card against the CPU from the same centres
    new_c, a_c, _ = kmeans._lloyd_step(pts, c0)
    new_h, a_h, _ = kmeans._lloyd_step(torch.as_tensor(x), c0.cpu())
    a_c = a_c.cpu()
    differ = torch.nonzero(a_c != a_h).squeeze(1).numpy()
    d = ((x[differ, None, :].astype(np.float64)
          - c0.cpu().numpy()[None].astype(np.float64)) ** 2).sum(-1)
    d.sort(1)
    ties = int((d[:, 1] - d[:, 0] <= KMEANS_NEAR_TIE * d[:, 0]).sum())
    if len(differ):     # the CPU's update from the card's assignments
        onehot = F.one_hot(a_c, KMEANS_K).float()
        cnt = onehot.sum(0)[:, None]
        new_h = torch.where(cnt > 0, (onehot.T @ torch.as_tensor(x))
                            / cnt.clamp(min=1.0), c0.cpu())
    err = _max_abs(new_c, new_h)
    print(f"clustering (a): one Lloyd iteration on the card against the "
          f"CPU from the same centres: {len(differ)} assignments differ, "
          f"{ties} of them near-ties (nearest two within "
          f"{KMEANS_NEAR_TIE} relative); centres max-abs {err:.3e} "
          f"({name_card})")
    check(ties == len(differ), "clustering (a): assignments equal apart "
          "from near-ties")
    check(torch.allclose(new_c.cpu(), new_h, **KMEANS_TOL),
          f"clustering (a): centres within {KMEANS_TOL} of the CPU's")
    return dict(iterations=km.iterations_, ms=loop_ms / km.iterations_)


def separation_score(emb, labels):
    """Mean inter-class distance over mean intra-class distance, every
    7th point (``tests/test_clustering.py::separation_score``)."""
    intra, inter = [], []
    for i in range(0, len(emb), 7):
        for j in range(i + 1, len(emb), 7):
            d = np.linalg.norm(emb[i] - emb[j])
            (intra if labels[i] == labels[j] else inter).append(d)
    return np.mean(inter) / np.mean(intra)


def _classes(seed, n, d, classes=10):
    """Ten seeded Gaussian classes in ``d`` dimensions (float64)."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, classes, n)
    return (rs.randn(classes, d) * 3)[labels] + rs.randn(n, d), labels


def tsne_case(name_card, seed):
    from deeplearning4j_tpu_torch.clustering import BarnesHutTsne, Tsne, tsne

    x, labels = _classes(seed, TSNE_N, TSNE_D)
    ts = Tsne(seed=seed, device="cuda")
    t0 = time.perf_counter()
    P = tsne._joint_p(x, min(ts.perplexity, (TSNE_N - 1) / 3.0))
    t_p = time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t1 = time.perf_counter()
    e0.record()
    emb = ts.embed(P)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    step_ms = e0.elapsed_time(e1) / ts.n_iter
    sep = separation_score(emb, labels)
    print(f"clustering (b) exact t-SNE: {TSNE_N} x {TSNE_D}, ten seeded "
          f"classes, perplexity {ts.perplexity}, {ts.n_iter} iterations, "
          f"lr {ts.learning_rate}; P on the host {t_p:.3f} s; "
          f"{step_ms:.4f} ms a step (CUDA events around embed: P's upload, "
          f"the steps, y's read; over the steps), embed {wall:.3f} s; "
          f"{ts.captures} capture, {ts.replays} replays; KL "
          f"{ts.kl_divergence_:.6g}; separation {sep:.4f} (bar "
          f"{TSNE_SEPARATION}) ({name_card})")
    check(ts.captures == 1 and ts.replays == ts.n_iter - 1,
          "clustering (b): one capture, a replay a later step")
    check(np.isfinite(emb).all() and emb.shape == (TSNE_N, 2)
          and math.isfinite(ts.kl_divergence_), "clustering (b): a finite "
          "embedding and KL")
    check(sep > TSNE_SEPARATION, f"clustering (b): separation above "
          f"{TSNE_SEPARATION}")
    # ten steps on the card against the CPU from the same P and state
    rs = np.random.RandomState(seed)
    y0 = torch.as_tensor((rs.randn(TSNE_N, 2) * 1e-2).astype(np.float32))
    out = []
    for dev in ("cuda", "cpu"):
        Pd = torch.as_tensor(np.asarray(P * ts.early_exaggeration,
                                        np.float32)).to(dev)
        y = y0.clone().to(dev)
        vel, gains = torch.zeros_like(y), torch.ones_like(y)
        lr = torch.tensor(ts.learning_rate, device=dev)
        mom = torch.tensor(ts.momentum, device=dev)
        for _ in range(TSNE_STEPS_CHECKED):
            kl = tsne.tsne_step_(Pd, y, vel, gains, lr, mom)
        out.append([t.cpu() for t in (y, vel, gains)] + [float(kl)])
    errs = [_max_abs(a, b) for a, b in zip(out[0][:3], out[1][:3])]
    print(f"clustering (b): {TSNE_STEPS_CHECKED} steps on the card against "
          f"the CPU from the same P and state: y max-abs {errs[0]:.3e}, vel "
          f"{errs[1]:.3e}, gains {errs[2]:.3e}; KL {out[0][3]:.9g} against "
          f"{out[1][3]:.9g} ({name_card})")
    check(max(errs) <= TSNE_ATOL, f"clustering (b): the card within "
          f"{TSNE_ATOL} of the CPU")
    # (c) Barnes-Hut on the host, and its theta = 0 gradient
    xb = x[:BH_N]
    bh = BarnesHutTsne(theta=BH_THETA, n_iter=BH_ITERS, seed=seed)
    t1 = time.perf_counter()
    yb = bh.fit_transform(xb)
    t_bh = time.perf_counter() - t1
    Pb = tsne._joint_p(xb, min(bh.perplexity, (BH_N - 1) / 3.0))
    t1 = time.perf_counter()
    g_bh = BarnesHutTsne(theta=0.0)._gradient(Pb, yb)
    t_g = time.perf_counter() - t1
    g_card, _ = tsne._tsne_grad(
        torch.as_tensor(np.asarray(Pb, np.float32)).cuda(),
        torch.as_tensor(yb.astype(np.float32)).cuda())
    rel = float(np.linalg.norm(g_card.cpu().double().numpy() - g_bh)
                / np.linalg.norm(g_bh))
    print(f"clustering (c) Barnes-Hut t-SNE: {BH_N} points, {BH_ITERS} "
          f"iterations, theta {BH_THETA}: {t_bh:.3f} s on the host "
          f"({t_bh / BH_ITERS * 1e3:.1f} ms an iteration), KL "
          f"{bh.kl_divergence_:.6g}; its theta = 0 gradient at the final y "
          f"({t_g:.3f} s) against the card's exact step's: {rel:.3e} "
          f"relative in norm ({name_card})")
    check(rel <= BH_GRAD_RTOL, f"clustering (c): within {BH_GRAD_RTOL}")
    return dict(step_ms=step_ms, p_s=t_p)


def viterbi_case(name_card, seed):
    from deeplearning4j_tpu_torch.utils import Viterbi, viterbi, viterbi_decode

    rs = np.random.RandomState(seed)
    runs = rs.randint(20, 500, VITERBI_LABELS // 20)
    truth = np.repeat(np.arange(len(runs)) % 2, runs)[:VITERBI_LABELS]
    flick = rs.rand(VITERBI_LABELS) < 0.1
    obs = np.where(flick, 1 - truth, truth)
    cases = [("facade", VITERBI_LABELS,
              lambda dev: Viterbi([0, 1], meta_stability=0.95, p_correct=0.9,
                                  device=dev).decode(obs))]
    em = np.log(rs.dirichlet(np.ones(VITERBI_S), VITERBI_T)).astype(
        np.float32)
    tr = np.log(rs.dirichlet(np.ones(VITERBI_S), VITERBI_S)).astype(
        np.float32)
    cases.append((f"viterbi_decode S {VITERBI_S}", VITERBI_T,
                  lambda dev: viterbi_decode(em, tr, device=dev)))
    for what, T, run in cases:
        before = dict(viterbi.counts)
        run("cuda")             # the first call's capture
        mid = dict(viterbi.counts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path, score = run("cuda")
        ms = (time.perf_counter() - t1) * 1e3
        caps = {k: viterbi.counts[k] - mid[k] for k in mid}
        t1 = time.perf_counter()
        path_h, score_h = run("cpu")
        ms_h = (time.perf_counter() - t1) * 1e3
        print(f"clustering (d) Viterbi {what}, T {T}: {ms:.3f} ms on the "
              f"card ({ms / T * 1e3:.3f} us a step, the host's backtrace "
              f"included; {caps['captures']} capture of {viterbi.CHUNK} "
              f"steps, {caps['replays']} replays), the CPU {ms_h:.3f} ms; "
              f"score {score:.9g}" + (f"; {np.mean(path != truth):.4f} of "
                                      f"the labels differ from the truth "
                                      f"(observed {flick.mean():.4f})"
                                      if what == "facade" else "")
              + f" ({name_card})")
        check(mid["captures"] - before["captures"] == 1
              and caps["captures"] == 1, f"clustering (d) {what}: a "
              "capture a call")
        check(np.array_equal(np.asarray(path), np.asarray(path_h))
              and score == score_h, f"clustering (d) {what}: the path and "
              "the score equal the CPU's bit for bit")


def interop_case(name_card):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.utils import interop

    x = torch.randn(1000, 64, device="cuda")
    arr = interop.from_torch(x)
    back = interop.to_torch(arr)
    labels = np.eye(10, dtype=np.float32)[np.arange(1000) % 10]
    ds = interop.dataset_from_torch(interop.dataset_to_torch(
        DataSet(arr, labels)))
    ok = (torch.equal(back, x.cpu()) and back.data_ptr() == arr.ctypes.data
          and np.array_equal(ds.features, arr)
          and np.array_equal(ds.labels, labels))
    print(f"clustering (e) interop: a [1000, 64] CUDA tensor to numpy, back "
          f"to a CPU tensor sharing its memory, and through a "
          f"TensorDataset and a DataSet: equal ({name_card})")
    check(ok, "clustering (e): the round trip from a CUDA tensor")


def clustering_phase(name_card, seed=NLP_SEED):
    """k-means, exact and Barnes-Hut t-SNE, Viterbi and the interop (see
    the module docstring)."""
    t0 = time.perf_counter()
    km = kmeans_case(name_card, seed)
    torch.cuda.empty_cache()
    ts = tsne_case(name_card, seed)
    torch.cuda.empty_cache()
    viterbi_case(name_card, seed)
    interop_case(name_card)
    print(f"clustering: phase {time.perf_counter() - t0:.1f} s")
    return dict(kmeans=km, tsne=ts)


# --------------------------------------------------- the distributed phase
DIST_SLOTS = 2              # data slots a process
DIST_ROWS = 2               # the char-LM's rows a data slot
DIST_RESNET_ROWS = 8        # ResNet-50's images a data slot
DIST_STEPS = 3              # the bf16 runs' steps, each layout
DIST_DEADLINE_S = 480       # each group of children, spawn to exit
DIST_SEED = 7
# ParallelWrapper across processes: (e) one warm-up and one timed window
# a run (cut from two timed windows to make room for (h)-(j)); its
# float32 oracle two windows at F 3; (f) the elastic run's
# char-LM cut to 2 layers (every window's state crosses the host twice
# through gloo), replica 3 delayed 0.2 s for five windows, then cleared
# for four, readmitted three windows after its eviction; (g) ResNet-50,
# one replica of 16 images a process
DIST_WINDOWS = 2
DIST_F32_WINDOWS = 2
DIST_ELASTIC_LAYERS = 2
DIST_ELASTIC_DELAY = 0.2
DIST_ELASTIC_WINDOWS = (5, 4)
DIST_ELASTIC_READMIT = 3
DIST_RESNET_WRAP_ROWS = 16
# (h) the introspection policy and the numerics ledger, the ledger every
# second step (both programs run); (i) the resilient fits on (f)'s 2-layer
# char-LM: 4 sync steps or 4 wrapper windows, a fatal fault on every rank
# at step 3, then a resume, a retryable fault on rank 1 at step 2 and its
# preemption notice at step 3; (j) Word2Vec and GloVe, 16 batches each
# (the NLP phase's corpus; GloVe on its cut, as the NLP phase's)
DIST_STATS_INTERVAL = 2
DIST_RES_STEPS = 4
DIST_RES_FATAL, DIST_RES_RETRY, DIST_RES_PREEMPT = 3, 2, 3
DIST_NLP_BATCHES = 16
# (h) the float32 oracle's statistics against the one-process four-slot
# master's: the introspection harvest's values to tests/test_introspection
# .py's rtol 1e-4 (atol 1e-6 for the fractions near 0), the ledger's
# max-abs to 1e-4 and each sampled fraction within 2 samples of 1024
DIST_STATS_TOL = dict(rtol=1e-4, atol=1e-6)
DIST_FRACTION_TOL = 2.0 / 1024


def _digest(tensors) -> str:
    """sha256 over the bytes of ``tensors``, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def _part_digest(net, part):
    return _digest(t for n, t in named_state(net) if n.startswith(part))


def _lm_global(world, steps):
    """The char-LM's global batches of a group of ``world`` processes:
    ``world x DIST_SLOTS x DIST_ROWS`` rows of T 2048 each."""
    return _lm_batches(steps, world * DIST_SLOTS * DIST_ROWS, DIST_SEED)


def _resnet_global(world):
    rs = np.random.RandomState(71)
    n = world * DIST_SLOTS * DIST_RESNET_ROWS
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    return DataSet(rs.rand(n, 224, 224, 3).astype(np.float32),
                   np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, n)])


def _dist_fit(net, mesh, batches, mode="replicated", first=None):
    """The sync master's fit over ``batches``, one step each, timed to
    the loss read: (master, ms a step, wrapper launches).  ``first()``
    runs after the first step, untimed."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster,
    )

    master = SyncTrainingMaster(mesh=mesh, update_sharding=mode)
    dist = DistributedNetwork(net, master)
    _counts_zero()
    ms = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.fit(ListDataSetIterator(b, len(b)))
        float(net.score_value)
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is not None and len(ms) == 1:
            first()
    counts = {k: l for k, (l, _) in _launch_counts().items() if l}
    return master, ms, counts


def _lm_wrapper_net(dtype, **over):
    """The char-LM at full width: bf16 with Adam (the zoo's), or the
    float32 SGD oracle's."""
    kw = TRAIN_MODEL if dtype == "bf16" else dict(
        TRAIN_MODEL_F32, updater="sgd", lr=PARALLEL_SGD_LR)
    return transformer_char_lm(device="cuda", **dict(kw, **over))


def _wrapper_windows(pw, net, frames):
    """One ``fit`` a window over ``frames`` (each a window's minibatches),
    timed to the loss read: ms, the cross-process exchange's seconds and
    bytes, and the params digest after each window."""
    out = {"ms": [], "exchange_s": [], "exchange_bytes": [],
           "stats_s": [], "stats_bytes": [], "digests": []}
    for frame in frames:
        torch.cuda.synchronize()
        ex0 = mesh_mod.process_totals()
        st0 = mesh_mod.process_totals("statistics")
        t0 = time.perf_counter()
        pw.fit(iter(frame))
        float(net.score_value)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        ex1 = mesh_mod.process_totals()
        st1 = mesh_mod.process_totals("statistics")
        out["exchange_s"].append(ex1["seconds"] - ex0["seconds"])
        out["exchange_bytes"].append(ex1["bytes"] - ex0["bytes"])
        out["stats_s"].append(st1["seconds"] - st0["seconds"])
        out["stats_bytes"].append(st1["bytes"] - st0["bytes"])
        out["digests"].append(_part_digest(net, "params"))
    return out


def _wrapper_graphs(pw):
    g = getattr(pw._staged, "_step_graphs", None)
    if g is None:
        return None
    return {"captures": g.captures, "replays": g.replays,
            "held": list(g.graph_launches().values())}


def _observe(net, interval=DIST_STATS_INTERVAL):
    """(h): the introspection policy and the numerics ledger (collecting
    every ``interval`` steps) on ``net``."""
    from deeplearning4j_tpu_torch.nn.conf import (
        TrainingIntrospection, TrainingNumerics,
    )

    net.conf = dataclasses.replace(
        net.conf, introspection=TrainingIntrospection().to_dict(),
        numerics=TrainingNumerics(interval=interval).to_dict())
    return net


def _observed(tree):
    """The ``__introspect__`` and ``__numerics__`` vectors of an updater
    state (or of a wrapper's gathered live stacks), as host arrays."""
    return {k: tree[k]["packed"].detach().float().cpu().numpy()
            for k in ("__introspect__", "__numerics__")
            if tree.get(k) is not None}


def _wrapper_child(run, world):
    """(a), (e): ``ParallelWrapper`` over ``world x DIST_SLOTS`` slots, the
    char-LM at full width, ``run["windows"]`` windows of F minibatches of
    ``DIST_ROWS`` x 2048 a replica: ``_wrapper_windows``' numbers, the
    wrapper launches, the window graph's captures, replays and launches,
    and the peak.  (h): with ``observe`` the statistics' digests (the
    gathered ``[K, N]`` stacks and the facade's global slot 0 vectors)."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    K = world * DIST_SLOTS
    F = run["freq"]
    net = _lm_wrapper_net(run["dtype"])
    if run.get("observe"):
        _observe(net)
    pw = ParallelWrapper(net, workers=K, mesh=_slots(data=K),
                         averaging_frequency=F, update_sharding=run["mode"])
    batches = _lm_batches(run["windows"] * K * F, DIST_ROWS, DIST_SEED + F)
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    out = _wrapper_windows(pw, net, [batches[w * K * F:(w + 1) * K * F]
                                     for w in range(run["windows"])])
    out["launches"] = {k: l for k, (l, _) in _launch_counts().items() if l}
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    out["graphs"] = _wrapper_graphs(pw)
    if run.get("observe"):
        live = _observed({"__introspect__": net._introspect_live,
                          "__numerics__": net._numerics_live})
        out["live"] = {k: (list(v.shape), _digest([torch.from_numpy(v)]))
                       for k, v in live.items()}
        out["facade"] = {k: _digest([torch.from_numpy(v)]) for k, v in
                         _observed(net.updater_state).items()}
    if run.get("vec"):
        np.save(run["vec"].format(rank=mesh_mod.process_index()),
                net.params_to_vector())
    _release(pw)
    _drop(net)
    return out


def _elastic_child(run, world):
    """(f): the elastic wrapper with replica 3 (rank 1's) delayed, one fit
    a window (each window's mask read after it), then one epoch of
    ``ParameterAveragingTrainingMaster(elastic=True)``."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, ElasticConfig, ParallelWrapper,
        ParameterAveragingTrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience import (
        FaultInjector, inject_faults,
    )

    K = world * DIST_SLOTS
    mesh = _slots(data=K)
    net = transformer_char_lm(device="cuda", **dict(
        TRAIN_MODEL, layers=DIST_ELASTIC_LAYERS, updater="sgd",
        lr=PARALLEL_SGD_LR))
    pw = ParallelWrapper(net, workers=K, mesh=mesh, elastic=ElasticConfig(
        evict_after_flags=2, readmit_after_windows=DIST_ELASTIC_READMIT,
        straggler_window=2, hang_stall_s=0.0))
    on, off = DIST_ELASTIC_WINDOWS
    batches = _lm_batches((on + off) * K, DIST_ROWS, DIST_SEED + 11)
    inj = FaultInjector(seed=0).delay_worker(str(K - 1), DIST_ELASTIC_DELAY)
    _counts_zero()
    masks, ms = [], []
    t0 = time.perf_counter()
    with inject_faults(inj):
        for w in range(on + off):
            if w == on:
                inj.clear_worker_delay(str(K - 1))
            t1 = time.perf_counter()
            pw.fit(iter(batches[w * K:(w + 1) * K]))
            ms.append((time.perf_counter() - t1) * 1e3)
            masks.append([float(v) for v in pw.elastic.active_mask()])
    out = {"masks": masks, "ms": ms, "secs": time.perf_counter() - t0,
           "stalls": pw.elastic.barrier_stalls,
           "stall_s": pw.elastic.barrier_stall_seconds,
           "params": _part_digest(net, "params"),
           "graphs": _wrapper_graphs(pw)}
    _release(pw)
    pam = ParameterAveragingTrainingMaster(workers=K, averaging_frequency=1,
                                           mesh=mesh, elastic=True)
    epoch = batches[:2 * K]
    ds = DataSet(np.concatenate([b.features for b in epoch]),
                 np.concatenate([b.labels for b in epoch]))
    t0 = time.perf_counter()
    DistributedNetwork(net, pam).fit(ListDataSetIterator(ds, DIST_ROWS))
    float(net.score_value)
    out["pam_s"] = time.perf_counter() - t0
    out["pam_params"] = _part_digest(net, "params")
    out["pam_active"] = pam.training_stats()["elastic"]["active"]
    out["launches"] = {k: l for k, (l, _) in _launch_counts().items() if l}
    _drop(net)
    return out


def _resnet_wrapper_child(run, world):
    """(g): ResNet-50 bf16 under ``ParallelWrapper``, one replica of
    ``DIST_RESNET_WRAP_ROWS`` images a process, F 1, one window."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = resnet50(device="cuda", updater="sgd", lr=PARALLEL_SGD_LR,
                   **RESNET)
    rs = np.random.RandomState(73)
    b = DIST_RESNET_WRAP_ROWS
    frame = [DataSet(rs.rand(b, 224, 224, 3).astype(np.float32),
                     np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, b)])
             for _ in range(world)]
    pw = ParallelWrapper(net, workers=world, mesh=_slots(data=world))
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    out = _wrapper_windows(pw, net, [frame])
    out["net_state"] = _part_digest(net, "net_state")
    out["launches"] = {k: l for k, (l, _) in _launch_counts().items() if l}
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    out["graphs"] = _wrapper_graphs(pw)
    _release(pw)
    _drop(net)
    return out


class _PreemptAt:
    """A listener that raises this rank's preemption notice once the net
    reaches iteration ``at`` (on the training thread: a known step)."""

    def __init__(self, handler, at):
        self.handler, self.at = handler, at

    def iteration_done(self, model, iteration):
        if iteration == self.at and not self.handler.stop_requested:
            self.handler.trigger()


def _small_lm():
    """(f)'s and (i)'s char-LM: full width, 2 layers, SGD."""
    return transformer_char_lm(device="cuda", **dict(
        TRAIN_MODEL, layers=DIST_ELASTIC_LAYERS, updater="sgd",
        lr=PARALLEL_SGD_LR))


def _resilient_child(run, world):
    """(i): a resilient fit across the processes on the 2-layer char-LM
    (the sync master on ``world x DIST_SLOTS`` slots of ``DIST_ROWS`` x
    2048, or the wrapper with a replica a slot, F 1), through a
    ``CheckpointManager`` in the phase's directory and a ``RetryPolicy``:
    (1) ``DIST_RES_STEPS`` unfaulted steps or windows; (2) a fatal fault
    on every rank at ``DIST_RES_FATAL`` (commits every second step);
    (3) a fresh net resumed from the last commit, a retryable fault on
    rank 1 alone at ``DIST_RES_RETRY``, rank 1's preemption notice at
    ``DIST_RES_PREEMPT`` (rank 0 has no handler); (4) a fresh net resumed
    to the end, committing every step; (5) a fatal fault on rank 1 alone
    at step 1.  Digests, the manager's steps and triggers, the faults'
    types, each part's seconds and the wrapper launches."""
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, ParallelWrapper, SyncTrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointManager, FaultInjector, PreemptionHandler, RetryPolicy,
        inject_faults,
    )

    K = world * DIST_SLOTS
    mesh = _slots(data=K)
    sync = run["master"] == "sync"
    batches = (_lm_global(world, DIST_RES_STEPS) if sync else _lm_batches(
        DIST_RES_STEPS * K, DIST_ROWS, DIST_SEED + 21))
    rank = mesh_mod.process_index()

    def fit(cm=None, rp=None, inj=None, preempt=None):
        net = _small_lm()
        handler = None
        if preempt is not None:
            handler = PreemptionHandler(cm).install()
            net.listeners = [_PreemptAt(handler, preempt)]
        runner = (SyncTrainingMaster(mesh=mesh, checkpoint_manager=cm,
                                     retry_policy=rp) if sync else
                  ParallelWrapper(net, workers=K, mesh=mesh,
                                  checkpoint_manager=cm, retry_policy=rp))
        t0 = time.perf_counter()
        err = None
        # the training thread's collectives (a commit's barriers run on
        # the writer's)
        seen = mesh_mod.census()
        try:
            with seen, (inject_faults(inj) if inj is not None
                        else contextlib.nullcontext()):
                if sync:
                    DistributedNetwork(net, runner).fit(iter(batches))
                else:
                    runner.fit(iter(batches))
            float(net.score_value)
        except Exception as e:      # the run's planted fault, reported
            err = type(e).__name__
        finally:
            if handler is not None:
                handler.uninstall()
        secs = time.perf_counter() - t0
        agreed = seen.counts.get("agreement", {})
        out["agree"].append((agreed.get("process_count", 0),
                             agreed.get("process_seconds", 0.0)))
        if cm is not None:
            cm.wait_idle()
        digest = _part_digest(net, "params")
        if not sync:
            _release(runner)
        _drop(net)
        return digest, err, secs

    def manager(every):
        return CheckpointManager(run["dir"], keep=10,
                                 save_every_steps=every)

    def policy():
        return RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=0.0)

    _counts_zero()
    out = {"secs": {}, "agree": []}
    out["unfaulted"], _, out["secs"]["unfaulted"] = fit()
    cm = manager(2)
    _, out["fatal"], out["secs"]["fatal"] = fit(
        cm, policy(), FaultInjector().fail_at_step(DIST_RES_FATAL,
                                                   transient=False))
    out["after_fatal"] = cm.all_steps()
    cm.close()
    cm, rp, inj = manager(2), policy(), FaultInjector()
    if rank == 1:
        inj.fail_at_step(DIST_RES_RETRY, transient=True)
    _, out["preempt_err"], out["secs"]["preempted"] = fit(
        cm, rp, inj, DIST_RES_PREEMPT if rank == 1 else None)
    out["retries"] = rp.retries
    out["latest"] = cm.latest_step()
    out["trigger"] = cm.read_commit(cm.latest())["trigger"]
    cm.close()
    cm = manager(1)
    out["resumed"], out["resumed_err"], out["secs"]["resumed"] = fit(
        cm, policy())
    out["steps"] = cm.all_steps()
    cm.close()
    inj = FaultInjector()
    if rank == 1:
        inj.fail_at_step(1, transient=False)
    _, out["lone"], out["secs"]["lone"] = fit(rp=policy(), inj=inj)
    out["launches"] = {k: l for k, (l, _) in _launch_counts().items() if l}
    return out


def _commit_child(run, world):
    """(i) over NCCL, a world of one: the sync master on the 2-layer
    char-LM, 3 unfaulted steps; then 2 steps committing every step and a
    fresh net resumed from that commit (its 2 batches skipped) for the
    third: the params of both bit for bit."""
    from deeplearning4j_tpu_torch.parallel import (
        DistributedNetwork, SyncTrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    mesh = _slots(data=world * DIST_SLOTS)
    batches = _lm_global(world, 3)
    _counts_zero()

    def fit(part, cm=None):
        net = _small_lm()
        t0 = time.perf_counter()
        DistributedNetwork(net, SyncTrainingMaster(
            mesh=mesh, checkpoint_manager=cm)).fit(iter(part))
        float(net.score_value)
        if cm is not None:
            cm.wait_idle()
        secs = time.perf_counter() - t0
        d = _part_digest(net, "params")
        it = net.iteration
        _drop(net)
        return d, it, secs

    want, _, t_plain = fit(batches)
    cm = CheckpointManager(run["dir"], keep=10, save_every_steps=1)
    _, _, t_saved = fit(batches[:2], cm)
    steps = cm.all_steps()
    cm.close()
    cm = CheckpointManager(run["dir"], keep=10, save_every_steps=1)
    got, it, t_resumed = fit(batches, cm)
    out = {"want": want, "got": got, "iteration": it,
           "steps_saved": steps, "steps": cm.all_steps(),
           "secs": [t_plain, t_saved, t_resumed],
           "launches": {k: l for k, (l, _) in _launch_counts().items()
                        if l}}
    cm.close()
    return out


def _nlp_model(kind, mesh, cap_batches=DIST_NLP_BATCHES):
    """(j)'s model over ``mesh``: ``DistributedWord2Vec`` (skip-gram HS at
    the ``VectorsConfiguration`` defaults) on the NLP phase's corpus, or
    ``DistributedGlove`` at its defaults on the corpus's cut, one epoch;
    its fit trains only the first ``cap_batches`` batches (the
    vocabulary and the co-occurrences are the whole corpus's)."""
    import itertools

    corpus = nlp_corpus(NLP_SEED)
    if kind == "w2v":
        m = (nlp_dist.DistributedWord2Vec.Builder().iterate(corpus)
             .seed(NLP_SEED).mesh(mesh).build())
        whole = m._batches
        m._batches = lambda: itertools.islice(whole(), cap_batches)
        return m
    m = nlp_dist.DistributedGlove(
        sentence_iterator=nlp.CollectionSentenceIterator(
            _cut(corpus, NLP_CUT)), epochs=1, seed=NLP_SEED, mesh=mesh)
    whole = m._train_pairs
    n = cap_batches * m.batch_size
    m._train_pairs = lambda r, c, v, rs: whole(r[:n], c[:n], v[:n], rs)
    return m


def _nlp_tables(m, kind):
    lk = m.lookup
    return ([lk.syn0, lk.syn1] if kind == "w2v" else list(m._state))


def _nlp_child(run, world):
    """(j): ``_nlp_model`` over ``world x DIST_SLOTS`` slots across the
    processes: the tables' digest, the fit's seconds, the batches, the
    exchange's ms and bytes a batch, the vocabulary's size; rank 0 saves
    ``syn0`` for the parent's one-process fit."""
    K = world * DIST_SLOTS
    m = _nlp_model(run["model"], _slots(data=K))
    calls = []
    run_step = m._step if run["model"] == "w2v" else m._glove_step

    def counted(*a, **kw):
        calls.append(1)
        return run_step(*a, **kw)

    if run["model"] == "w2v":
        m._step = counted
    else:
        m._glove_step = counted
    ex0 = mesh_mod.process_totals()
    t0 = time.perf_counter()
    m.fit()
    loss = m.cum_loss
    secs = time.perf_counter() - t0
    ex1 = mesh_mod.process_totals()
    n = max(len(calls), 1)
    if mesh_mod.process_index() == 0:
        np.save(run["vec"], m.lookup.syn0.detach().cpu().numpy())
    return {"digest": _digest(_nlp_tables(m, run["model"])),
            "secs": secs, "batches": len(calls), "loss": loss,
            "vocab": len(m.vocab), "captures": m.programs.counts()["captures"],
            "exchange_ms": (ex1["seconds"] - ex0["seconds"]) * 1e3 / n,
            "exchange_mib": (ex1["bytes"] - ex0["bytes"]) / n / 2 ** 20}


def _child_run(run, world):
    """One run of a distributed child (``distributed_phase``)."""
    from deeplearning4j_tpu_torch.parallel import save_checkpoint

    wrapped = {"wrapper": _wrapper_child, "elastic": _elastic_child,
               "resnet_wrapper": _resnet_wrapper_child,
               "resilient": _resilient_child, "commit": _commit_child,
               "nlp": _nlp_child}.get(run["kind"])
    if wrapped is not None:
        return wrapped(run, world)

    mesh = _slots(data=world * DIST_SLOTS)
    torch.cuda.reset_peak_memory_stats()
    if run["kind"] == "resnet":
        net = resnet50(device="cuda", updater="sgd", lr=PARALLEL_SGD_LR,
                       seed=12345)
        ds = _resnet_global(world)
        first = run.get("vec1") and (lambda: np.save(
            run["vec1"].format(rank=mesh_mod.process_index()),
            net.params_to_vector()))
        master, ms, counts = _dist_fit(net, mesh, [ds] * run["steps"],
                                       first=first or None)
    else:
        kw = TRAIN_MODEL if run["dtype"] == "bf16" else dict(
            TRAIN_MODEL_F32, updater="sgd", lr=PARALLEL_SGD_LR)
        net = transformer_char_lm(device="cuda", **kw)
        if run.get("observe"):
            _observe(net)
        st0 = mesh_mod.process_totals("statistics")
        master, ms, counts = _dist_fit(
            net, mesh, _lm_global(world, run["steps"]), run["mode"])
        st1 = mesh_mod.process_totals("statistics")
    st = master.training_stats()
    out = {"ms": ms, "launches": counts,
           "params": _part_digest(net, "params"),
           "net_state": _part_digest(net, "net_state"),
           "exchange_s": st["exchange_seconds"],
           "exchange_bytes": st["exchange_bytes"],
           "exchange_count": st["exchange_count"],
           "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
           "census": {op: {k: e[k] for k in ("process_count",
                                             "process_bytes")
                           if k in e}
                      for op, e in mesh_mod.collective_totals().items()
                      if e.get("process_count")}}
    if run["kind"] != "resnet":
        out.update(stats_s=st1["seconds"] - st0["seconds"],
                   stats_bytes=st1["bytes"] - st0["bytes"],
                   stats_count=st1["count"] - st0["count"])
    if run.get("vec"):
        np.save(run["vec"].format(rank=mesh_mod.process_index()),
                net.params_to_vector())
    if run.get("observe"):
        seen = _observed(net.updater_state)
        out["observed"] = {k: _digest([torch.from_numpy(v)])
                           for k, v in seen.items()}
        if run.get("stats"):
            np.savez(run["stats"].format(rank=mesh_mod.process_index()),
                     **seen)
    if run.get("save"):
        t0 = time.perf_counter()
        save_checkpoint(run["save"], net, trees=master.state_trees(net),
                        mesh=mesh)
        out["save_s"] = time.perf_counter() - t0
    del master, net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def distributed_child(spec_path) -> int:
    """A child of ``distributed_phase``: joins the group its spec names
    through ``provision.bootstrap_distributed`` (the explicit triple; the
    parent serves the rendezvous), runs its runs, prints one JSON line."""
    import os

    from deeplearning4j_tpu_torch.parallel import shutdown_distributed
    from deeplearning4j_tpu_torch.provision import bootstrap_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    pin_fp32_precision()
    world = spec["world"]
    summary = bootstrap_distributed(f"127.0.0.1:{spec['port']}", world,
                                    spec["rank"], backend=spec["backend"])
    try:
        out = {"summary": summary, "backend": mesh_mod.process_backend(),
               "device": str(torch.cuda.current_device()),
               "jax": "jax" in sys.modules,
               "runs": {r["name"]: _child_run(r, world)
                        for r in spec["runs"]}}
    finally:
        shutdown_distributed()
    print(json.dumps(out))
    return 0


class _Children:
    """``world`` children of this script (or of the command ``child``,
    given the spec's path last) in one group over ``backend``, each
    running ``runs``, started at once; ``wait()`` waits for every child
    within ``DIST_DEADLINE_S`` of the start (all killed past it, or when
    one fails) and returns each rank's JSON and the seconds the group
    took; ``kill()`` ends any child still running."""

    def __init__(self, world, backend, runs, tmp, child=None):
        import os
        import torch.distributed as dist

        self.world, self.backend = world, backend
        self.store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                   wait_for_workers=False)
        self.procs, self.logs = [], []
        self.t0 = time.perf_counter()
        self.end = time.monotonic() + DIST_DEADLINE_S
        for rank in range(world):
            name = f"{backend}-{world}-{rank}"
            path = os.path.join(tmp, f"spec-{name}.json")
            with open(path, "w") as f:
                json.dump({"world": world, "rank": rank,
                           "port": self.store.port, "backend": backend,
                           "runs": runs}, f)
            out = open(os.path.join(tmp, f"out-{name}.txt"), "w+")
            err = open(os.path.join(tmp, f"err-{name}.txt"), "w+")
            self.logs.append((out, err))
            self.procs.append(subprocess.Popen(
                (child or [sys.executable, __file__, "--distributed-child"])
                + [path], stdout=out, stderr=err))

    def wait(self):
        procs, logs, backend = self.procs, self.logs, self.backend
        try:
            while any(p.poll() is None for p in procs):
                check(time.monotonic() < self.end,
                      f"distributed: {self.world} {backend} children "
                      f"within {DIST_DEADLINE_S} s")
                check(all(p.poll() in (None, 0) for p in procs),
                      f"distributed: the {backend} children exited "
                      f"{[p.poll() for p in procs]}: "
                      + " | ".join(_tail(e) for _, e in logs))
                time.sleep(0.5)
            check(all(p.returncode == 0 for p in procs),
                  f"distributed: the {backend} children exited "
                  f"{[p.returncode for p in procs]}: "
                  + " | ".join(_tail(e) for _, e in logs))
        finally:
            self.kill()
        res = []
        for out, err in logs:
            out.seek(0)
            res.append(json.loads(out.read().strip().splitlines()[-1]))
            out.close()
            err.close()
        return res, time.perf_counter() - self.t0

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.store = None


def _run_children(world, backend, runs, tmp, child=None):
    """``_Children(...).wait()``."""
    return _Children(world, backend, runs, tmp, child).wait()


def _gloo_runs(tmp):
    """The gloo children's runs: (b), (c) and the save of (d), then
    (e)-(g) (``ParallelWrapper``, elastic and ``ParameterAveraging``),
    then (h)-(j) (statistics, resilient fits, Word2Vec and GloVe; (b)'s
    float32 run carries (h)'s policies too); with the files their params
    and save go to."""
    vec = [f"{tmp}/lm-f32-{{rank}}.npy", f"{tmp}/resnet-{{rank}}.npy",
           f"{tmp}/resnet1-{{rank}}.npy", f"{tmp}/wrap-f32-{{rank}}.npy"]
    ck = f"{tmp}/zero-ckpt"
    runs = [{"name": "f32", "kind": "lm", "dtype": "f32", "steps": 2,
             "mode": "replicated", "vec": vec[0], "observe": True,
             "stats": f"{tmp}/stats-f32-{{rank}}.npz"},
            {"name": "replicated", "kind": "lm", "dtype": "bf16",
             "steps": DIST_STEPS, "mode": "replicated"},
            {"name": "zero", "kind": "lm", "dtype": "bf16",
             "steps": DIST_STEPS, "mode": "zero", "save": ck},
            {"name": "resnet", "kind": "resnet", "steps": 2,
             "vec": vec[1], "vec1": vec[2]}]
    runs += [{"name": f"wrap_{m}_f{F}", "kind": "wrapper", "dtype": "bf16",
              "freq": F, "mode": m, "windows": DIST_WINDOWS}
             for m, F in (("replicated", 1), ("replicated", 3), ("zero", 1))]
    runs += [{"name": "wrap_f32", "kind": "wrapper", "dtype": "f32",
              "freq": 3, "mode": "replicated", "windows": DIST_F32_WINDOWS,
              "vec": vec[3]},
             {"name": "elastic", "kind": "elastic"},
             {"name": "resnet_wrap", "kind": "resnet_wrapper"}]
    runs += [{"name": "stats", "kind": "lm", "dtype": "bf16",
              "steps": DIST_STEPS, "mode": "replicated", "observe": True},
             {"name": "stats_zero", "kind": "lm", "dtype": "bf16",
              "steps": 2, "mode": "zero", "observe": True},
             {"name": "wrap_stats", "kind": "wrapper", "dtype": "bf16",
              "freq": 1, "mode": "replicated", "windows": 1,
              "observe": True}]
    runs += [{"name": f"res_{m}", "kind": "resilient", "master": m,
              "dir": f"{tmp}/res-{m}"} for m in ("sync", "wrapper")]
    runs += [{"name": m, "kind": "nlp", "model": m,
              "vec": f"{tmp}/{m}-syn0.npy"} for m in ("w2v", "glove")]
    return vec, ck, runs


def _tail(f, n=1500):
    f.flush()
    f.seek(0)
    return f.read()[-n:]


def _want_lm(steps):
    """The char-LM's wrapper launches of ``steps`` eager steps in one
    process: a flash kernel a layer a step, the prologue two."""
    n = TRAIN_MODEL["layers"] * steps
    return {"flash_fwd": n, "flash_dq": n, "flash_dkv": n,
            "prologue": 2 * n}


def _parent_digest(make, mesh_slots, batches):
    """The same master's eager steps in this process (no process group):
    its params digest."""
    net = make()
    net._capture = False
    _dist_fit(net, _slots(data=mesh_slots), batches)
    d = _part_digest(net, "params")
    _drop(net)
    return d


def distributed_phase(name_card):
    """Phase 37 (module docstring).  Returns the children's wrapper
    launches by kernel: the bf16 char-LM's (flash_fwd, flash_dq,
    flash_dkv, prologue; the sync master's and the wrappers'), the
    float32 char-LM's (on the tf32x3 rows and the prologue's),
    ResNet-50's BatchNorm training kernels."""
    import collections
    import os
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.parallel import restore_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dl4j-distributed-")
    launches = {k: collections.Counter() for k in ("bf16", "f32", "bn")}
    groups = []
    try:
        # (a) NCCL, a world of one, and (b)-(g) gloo, two processes on
        # the card, started together; the oracles' references are made
        # here meanwhile, so (a)'s, (b)'s and (c)'s times share the card
        # with them (the phase's time; (e)-(g) run after them)
        groups.append(_Children(1, "nccl", [
            {"name": "lm", "kind": "lm", "dtype": "bf16", "steps": 2,
             "mode": "replicated"},
            {"name": "wrap", "kind": "wrapper", "dtype": "bf16", "freq": 1,
             "mode": "replicated", "windows": 1},
            {"name": "commit", "kind": "commit",
             "dir": f"{tmp}/nccl-commit"}], tmp))
        vec, ck, runs = _gloo_runs(tmp)
        groups.append(_Children(2, "gloo", runs, tmp))
        t_ref = time.perf_counter()
        want = _parent_digest(lambda: transformer_char_lm(
            device="cuda", **TRAIN_MODEL), DIST_SLOTS, _lm_global(1, 2))
        want_wrap = _nccl_wrapper_reference()
        refs = {"f32": _sync_f32_reference(), "resnet": _resnet_reference(),
                "wrap_f32": _f32_wrapper_reference(),
                "stats": _stats_f32_reference(), "nlp": _nlp_reference()}
        t_ref = time.perf_counter() - t_ref
        (a,), secs = groups[0].wait()
        r = a["runs"]["lm"]
        print(f"distributed (a): a world of one over {a['backend']} "
              f"({a['summary']}), the bf16 char-LM at full width on "
              f"{DIST_SLOTS} slots of {DIST_ROWS} x {TRAIN_T}, 2 steps "
              f"{[round(m, 3) for m in r['ms']]} ms; cross-process "
              f"collectives {r['exchange_count']}, "
              f"{r['exchange_bytes'] / 2 ** 20:.1f} MiB, "
              f"{r['exchange_s'] * 1e3:.3f} ms; census {r['census']}; "
              f"params {r['params']} against the eager steps without a "
              f"group {want}; child group {secs:.1f} s [{name_card}]")
        check(a["backend"] == "nccl" and not a["jax"],
              "distributed (a): NCCL, no JAX in the child")
        check(r["params"] == want, "distributed (a): a world of one equal "
              "to the master without a group, bit for bit")
        check(r["launches"] == _want_lm(2), f"distributed (a) launches "
              f"{r['launches']} against {_want_lm(2)}")
        launches["bf16"].update(r["launches"])
        _dist_nccl_wrapper(a["runs"]["wrap"], want_wrap, name_card,
                           launches)
        _dist_nccl_commit(a["runs"]["commit"], name_card, launches)
        torch.cuda.empty_cache()
        kids, secs = groups[1].wait()
        print(f"distributed: the references here took {t_ref:.1f} s of "
              f"the children's {secs:.1f}")
        print(f"distributed (b-d): two processes on {name_card.split(',')[0]}"
              f" over gloo ({[k['summary'] for k in kids]}), in {secs:.1f} s")
        for k in kids:
            check(k["backend"] == "gloo" and not k["jax"],
                  "distributed (b): gloo, no JAX in the children")
        _dist_f32(kids, vec[0], refs.pop("f32"), launches)
        _dist_bf16(kids, name_card, launches)
        _dist_resnet(kids, vec[1:3], refs.pop("resnet"), name_card,
                     launches)
        _dist_wrappers(kids, name_card, launches)
        _dist_f32_wrapper(kids, vec[3], refs.pop("wrap_f32"), name_card,
                          launches)
        _dist_elastic(kids, name_card, launches)
        _dist_resnet_wrapper(kids, name_card, launches)
        _dist_stats(kids, tmp, refs.pop("stats"), name_card, launches)
        _dist_resilient(kids, name_card, launches)
        _dist_nlp(kids, tmp, refs.pop("nlp"), name_card)
        # (d) the ZeRO run's save restored here
        z = kids[0]["runs"]["zero"]
        with open(f"{ck}/checkpoint.json") as f:
            meta = json.load(f)
        names = sorted(os.listdir(ck))
        check(meta["processes"] == 2 and names == [
            "checkpoint.json", "manifest-0.json", "manifest-1.json",
            "shards-0.npz", "shards-1.npz"],
            f"distributed (d): the save's files {names}, meta {meta}")
        net = transformer_char_lm(device="cuda", **TRAIN_MODEL)
        for slots in (4, 1):
            with torch.no_grad():           # nothing left of the last
                for n, t in named_state(net):
                    t.zero_()
            t0 = time.perf_counter()
            restore_checkpoint(ck, net, mesh=_slots(data=slots))
            rs = time.perf_counter() - t0
            got = _part_digest(net, "params")
            print(f"distributed (d): the two-process ZeRO save "
                  f"(saved in {max(k['runs']['zero']['save_s'] for k in kids):.3f} s"
                  f") restored onto {slots} slot(s) in {rs:.3f} s: params "
                  f"{got} against the children's {z['params']}")
            check(got == z["params"], f"distributed (d): restored onto "
                  f"{slots} slot(s) bit for bit")
        _drop(net)
        del net
    finally:
        for g in groups:
            g.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"distributed: phase {time.perf_counter() - t_phase:.1f} s")
    return {k: dict(v) for k, v in launches.items()}


def _stats_f32_reference():
    """(h)'s float32 oracle: the one-process four-slot sync master with
    (h)'s policies, SGD, on (b)'s two global batches: the plans and the
    ``__introspect__`` and ``__numerics__`` vectors."""
    from deeplearning4j_tpu_torch.observability import (
        introspection, numerics,
    )

    net = _observe(transformer_char_lm(device="cuda", updater="sgd",
                                       lr=PARALLEL_SGD_LR,
                                       **TRAIN_MODEL_F32))
    _dist_fit(net, _slots(data=2 * DIST_SLOTS), _lm_global(2, 2))
    out = {"intro_plan": introspection.plan_for(net),
           "num_plan": numerics.plan_for(net),
           "vecs": _observed(net.updater_state)}
    _drop(net)
    return out


def _dist_stats(kids, tmp, ref, name_card, launches):
    """(h): the statistics across processes.  The ranks' vectors bit for
    bit (the sync master replicated and ZeRO, bf16; the wrapper's
    gathered stacks and the facade's vectors); (b)'s float32 run's
    vectors against the one-process four-slot master's (``ref``) within
    ``DIST_STATS_TOL`` and ``DIST_FRACTION_TOL``; the launches."""
    from deeplearning4j_tpu_torch.observability import (
        introspection, numerics,
    )

    for name in ("stats", "stats_zero", "f32"):
        a, b = (k["runs"][name]["observed"] for k in kids)
        check(a == b, f"distributed (h) {name}: the ranks' statistics bit "
              f"for bit {a} {b}")
    for name, steps in (("stats", DIST_STEPS), ("stats_zero", 2)):
        for rank, k in enumerate(kids):
            r = k["runs"][name]
            check(r["launches"] == _want_lm(steps), f"distributed (h) "
                  f"{name} launches {r['launches']} against "
                  f"{_want_lm(steps)}")
            launches["bf16"].update(r["launches"])
            print(f"distributed (h) bf16 Adam sync master {name}, rank "
                  f"{rank}, the introspection policy and the numerics "
                  f"ledger every {DIST_STATS_INTERVAL} steps: steps "
                  f"{[round(x, 3) for x in r['ms']]} ms, the exchange "
                  f"{r['exchange_s'] * 1e3 / steps:.3f} ms a step "
                  f"({r['exchange_count']} collectives, "
                  f"{r['exchange_bytes'] / steps / 2 ** 20:.1f} MiB sent a "
                  f"step), the statistics' reductions "
                  f"{r['stats_s'] * 1e3 / steps:.3f} ms a step "
                  f"({r['stats_count']} collectives, "
                  f"{r['stats_bytes'] / steps / 2 ** 10:.1f} KiB a step); "
                  f"vectors {r['observed']} [{name_card}]")
    a, b = (k["runs"]["wrap_stats"] for k in kids)
    check(a["live"] == b["live"] and a["facade"] == b["facade"]
          and a["digests"] == b["digests"], "distributed (h) wrapper: the "
          "ranks' gathered stacks, the facade's vectors and the params bit "
          "for bit")
    check(all(shape[0] == 2 * DIST_SLOTS for shape, _ in a["live"].values()),
          f"distributed (h) wrapper: the stacks hold every replica's row "
          f"{a['live']}")
    want = _want_wrapper(1, 1, DIST_SLOTS, True)
    for rank, r in enumerate((a, b)):
        check(r["launches"] == want, f"distributed (h) wrapper launches "
              f"{r['launches']} against {want}")
        launches["bf16"].update(r["launches"])
        print(f"distributed (h) wrapper F 1 with both policies, rank {rank}: "
              f"the window {r['ms'][0]:.3f} ms (its capture included), the "
              f"exchange {r['exchange_s'][0] * 1e3:.3f} ms, "
              f"{r['exchange_bytes'][0] / 2 ** 20:.1f} MiB, the statistics' "
              f"gathers {r['stats_s'][0] * 1e3:.3f} ms, "
              f"{r['stats_bytes'][0] / 2 ** 10:.1f} KiB; stacks "
              f"{r['live']} [{name_card}]")
    got = dict(np.load(f"{tmp}/stats-f32-0.npz"))
    hi = introspection.harvest({"packed": got["__introspect__"]},
                               ref["intro_plan"])
    hr = introspection.harvest({"packed": ref["vecs"]["__introspect__"]},
                               ref["intro_plan"])
    worst = 0.0
    for sect in ("gradient_stats", "update_stats", "activation_stats"):
        for layer, stats in hr[sect].items():
            for key, v in stats.items():
                if not isinstance(v, float):
                    continue
                g = hi[sect][layer][key]
                ok = math.isclose(g, v, rel_tol=DIST_STATS_TOL["rtol"],
                                  abs_tol=DIST_STATS_TOL["atol"])
                # the share of its tolerance the difference takes
                worst = max(worst, abs(g - v) / (
                    DIST_STATS_TOL["atol"] + DIST_STATS_TOL["rtol"] * abs(v)))
                check(ok, f"distributed (h) float32 {sect}/{layer}/{key} "
                      f"{g} against {v} within {DIST_STATS_TOL}")
    ni = numerics.harvest({"packed": got["__numerics__"]}, ref["num_plan"])
    nr = numerics.harvest({"packed": ref["vecs"]["__numerics__"]},
                          ref["num_plan"])
    frac = 0.0
    for comp in ("gradients", "moments", "activations"):
        for layer, e in nr[comp].items():
            g = ni[comp][layer]
            check(math.isclose(g["max_abs"], e["max_abs"], rel_tol=1e-4,
                               abs_tol=0.0), f"distributed (h) float32 "
                  f"ledger {comp}/{layer} max-abs {g['max_abs']} against "
                  f"{e['max_abs']}")
            for kind in ("underflow", "overflow"):
                for fmt, v in e[kind].items():
                    frac = max(frac, abs(g[kind][fmt] - v))
    check(frac <= DIST_FRACTION_TOL, f"distributed (h) float32 ledger: "
          f"every sampled fraction within {DIST_FRACTION_TOL:g} ({frac:g})")
    print(f"distributed (h) float32 oracle (SGD, 2 processes x "
          f"{DIST_SLOTS} slots, 2 steps, the ledger collecting at step 0): "
          f"the introspection harvest's largest difference from the "
          f"one-process four-slot master's {worst:.3e} of its tolerance "
          f"(atol + rtol x |value|), the ledger's "
          f"largest fraction difference {frac:.3e}, every max-abs within "
          f"1e-4 [{name_card}]")


def _dist_resilient(kids, name_card, launches):
    """(i): both masters' resilient fits, both ranks: the planted faults
    raised where planned, the resume from the last commit, the retry on
    both ranks, the preemption's commit at the same step on both, and the
    resumed runs' params equal the unfaulted runs' bit for bit."""
    for m in ("sync", "wrapper"):
        a, b = (k["runs"][f"res_{m}"] for k in kids)
        for r in (a, b):
            check(r["fatal"] == "InjectedFault" and r["preempt_err"] is None
                  and r["resumed_err"] is None, f"distributed (i) {m}: the "
                  f"fatal fault raised, the other runs clean {r['fatal']} "
                  f"{r['preempt_err']} {r['resumed_err']}")
            check(r["after_fatal"] == [2] and r["latest"] == DIST_RES_PREEMPT
                  and r["trigger"] in ("preempt", "priority"),
                  f"distributed (i) {m}: commits {r['after_fatal']} before "
                  f"the fault, the preemption's at {r['latest']} "
                  f"({r['trigger']})")
            check(r["steps"] == [2, 3] + list(range(4, DIST_RES_STEPS + 1)),
                  f"distributed (i) {m}: the commits {r['steps']}")
            check(r["retries"] == 1, f"distributed (i) {m}: rank 1's fault "
                  f"retried on every rank ({r['retries']})")
            check(r["resumed"] == r["unfaulted"], f"distributed (i) {m}: the "
                  f"resumed run equal to the unfaulted one bit for bit")
            check(sum(r["launches"].values()) > 0, f"distributed (i) {m}: "
                  f"the kernels launched {r['launches']}")
            launches["bf16"].update(r["launches"])
        check(a["unfaulted"] == b["unfaulted"] and a["launches"]
              == b["launches"], f"distributed (i) {m}: the ranks bit for "
              "bit, the same launches")
        check(a["lone"] == "PeerStepFault" and b["lone"] == "InjectedFault"
              and max(a["secs"]["lone"], b["secs"]["lone"]) < 60,
              f"distributed (i) {m}: rank 1's lone fatal fault raised on "
              f"every rank at once ({a['lone']}, {b['lone']})")
        n_res, t_res = a["agree"][3]
        per = t_res * 1e3 / max(n_res, 1)
        print(f"distributed (i) resilient {m} (the char-LM cut to "
              f"{DIST_ELASTIC_LAYERS} layers, SGD, {DIST_RES_STEPS} "
              f"{'steps' if m == 'sync' else 'windows'}): seconds "
              f"{ {k: round(v, 3) for k, v in a['secs'].items()} }; a fatal "
              f"fault on every rank at {DIST_RES_FATAL}, resumed from "
              f"{a['after_fatal'][-1]}; rank 1's retryable fault retried on "
              f"both; rank 1's preemption committed at {a['latest']} on "
              f"both ({a['trigger']}); commits {a['steps']}; params "
              f"{a['resumed']} against the unfaulted {a['unfaulted']}; "
              f"rank 1's lone fatal fault: {a['lone']} on rank 0 in "
              f"{a['secs']['lone']:.3f} s, {b['lone']} on rank 1; the "
              f"training thread's agreements (count, ms) by fit "
              f"{[(n, round(t * 1e3, 3)) for n, t in a['agree']]}, the "
              f"resumed fit's {per:.3f} ms each over its "
              f"{DIST_RES_STEPS - DIST_RES_PREEMPT} "
              f"{'steps' if m == 'sync' else 'windows'} [{name_card}]")


def _dist_nccl_commit(r, name_card, launches):
    """(i) over NCCL, a world of one: one run committing and one resumed
    from its commit, bit for bit the unfaulted run."""
    print(f"distributed (i): a commit and a resume over NCCL, a world of "
          f"one: commits {r['steps_saved']}, resumed to iteration "
          f"{r['iteration']} (commits {r['steps']}), params {r['got']} "
          f"against {r['want']}; seconds "
          f"{[round(x, 3) for x in r['secs']]} [{name_card}]")
    check(r["steps_saved"] == [1, 2] and r["steps"] == [1, 2, 3]
          and r["iteration"] == 3, "distributed (i) NCCL: the commits and "
          "the resume at step 2")
    check(r["got"] == r["want"], "distributed (i) NCCL: the resumed run "
          "equal to the unfaulted one bit for bit")
    check(sum(r["launches"].values()) > 0, "distributed (i) NCCL: the "
          "kernels launched")
    launches["bf16"].update(r["launches"])


def _nlp_reference():
    """(j)'s one-process four-slot fits here on the card: each model's
    ``syn0`` and seconds."""
    out = {}
    for kind in ("w2v", "glove"):
        m = _nlp_model(kind, _slots(data=2 * DIST_SLOTS))
        t0 = time.perf_counter()
        m.fit()
        float(m.cum_loss)
        out[kind] = (m.lookup.syn0.detach().cpu().numpy(),
                     time.perf_counter() - t0)
        capture_mod.release(m.programs)
        del m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dist_nlp(kids, tmp, ref, name_card):
    """(j): ``DistributedWord2Vec`` and ``DistributedGlove`` across
    processes: the ranks' tables bit for bit, eager (nothing captured),
    ``DIST_NLP_BATCHES`` batches each, rank 0's ``syn0`` within
    ``NLP_DIST_ATOL`` of the one-process four-slot fit's (``index_add_``
    is unordered on the card), and the exchange a batch."""
    names = {"w2v": "DistributedWord2Vec (skip-gram HS)",
             "glove": "DistributedGlove"}
    for m, what in names.items():
        a, b = (k["runs"][m] for k in kids)
        check(a["digest"] == b["digest"] and a["loss"] == b["loss"],
              f"distributed (j) {m}: the ranks' tables bit for bit")
        check(a["batches"] == b["batches"] == DIST_NLP_BATCHES
              and a["captures"] == 0, f"distributed (j) {m}: "
              f"{a['batches']} eager batches ({a['captures']} captured)")
        want, t_one = ref[m]
        err = _max_abs(torch.from_numpy(np.load(f"{tmp}/{m}-syn0.npy")),
                       torch.from_numpy(want))
        print(f"distributed (j) {what}, 2 processes x {DIST_SLOTS} slots, "
              f"V {a['vocab']}, {a['batches']} batches: {a['secs']:.3f} s "
              f"(the one-process four-slot fit {t_one:.3f} s); the "
              f"exchange {a['exchange_ms']:.3f} ms and "
              f"{a['exchange_mib']:.1f} MiB sent a batch (rank 1 "
              f"{b['exchange_ms']:.3f} ms); syn0 max abs {err:.3e} from the "
              f"one-process fit [{name_card}]")
        check(err <= NLP_DIST_ATOL, f"distributed (j) {m}: within "
              f"{NLP_DIST_ATOL} of the one-process four-slot fit")


def _want_wrapper(windows, F, k_local, captured, layers=None):
    """A wrapper fit's launches: ``F x k_local`` replica steps a window,
    eagerly every window, captured one window's worth at the warm-up and
    one at the capture (replays count none)."""
    step = _want_lm(1) if layers is None else {
        k: v * layers // TRAIN_MODEL["layers"] for k, v in _want_lm(1).items()}
    n = (2 if captured else windows) * F * k_local
    return {k: n * v for k, v in step.items()}


def _nccl_wrapper_reference():
    """(a)'s wrapper window here without a group (its whole window one
    graph): ``_wrapper_windows``' numbers."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = transformer_char_lm(device="cuda", **TRAIN_MODEL)
    pw = ParallelWrapper(net, workers=DIST_SLOTS,
                         mesh=_slots(data=DIST_SLOTS))
    want = _wrapper_windows(pw, net, [_lm_batches(DIST_SLOTS, DIST_ROWS,
                                                  DIST_SEED + 1)])
    _release(pw)
    _drop(net)
    return want


def _dist_nccl_wrapper(r, want, name_card, launches):
    """(a)'s wrapper window over NCCL, a world of one, against the same
    wrapper's window without a group (``want``), bit for bit."""
    print(f"distributed (a): ParallelWrapper over NCCL, a world of one, "
          f"{DIST_SLOTS} slots of {DIST_ROWS} x {TRAIN_T}, F 1: the window "
          f"{r['ms'][0]:.3f} ms (its capture included), the exchange "
          f"{r['exchange_s'][0] * 1e3:.3f} ms, "
          f"{r['exchange_bytes'][0] / 2 ** 20:.1f} MiB; params "
          f"{r['digests'][0]} against the window without a group "
          f"{want['digests'][0]} [{name_card}]")
    check(r["digests"] == want["digests"], "distributed (a): the wrapper "
          "over NCCL equal to the wrapper without a group, bit for bit")
    exp = _want_wrapper(1, 1, DIST_SLOTS, True)
    check(r["launches"] == exp, f"distributed (a) wrapper launches "
          f"{r['launches']} against {exp}")
    launches["bf16"].update(r["launches"])


def _dist_wrappers(kids, name_card, launches):
    """(e): the bf16 wrapper runs: the ranks' params bit for bit after
    every window, the launches and the window graph as designed, and
    the times."""
    k_local = DIST_SLOTS
    for m, F in (("replicated", 1), ("replicated", 3), ("zero", 1)):
        name = f"wrap_{m}_f{F}"
        a, b = (k["runs"][name] for k in kids)
        check(a["digests"] == b["digests"], f"distributed (e) {name}: the "
              f"ranks' params bit for bit after every window "
              f"{a['digests']} {b['digests']}")
        captured = m == "replicated"
        want = _want_wrapper(DIST_WINDOWS, F, k_local, captured)
        tokens = 2 * k_local * F * DIST_ROWS * TRAIN_T
        for rank, r in enumerate((a, b)):
            check(r["launches"] == want, f"distributed (e) {name} launches "
                  f"{r['launches']} against {want}")
            launches["bf16"].update(r["launches"])
            held = _want_wrapper(1, F, k_local, True)
            held = {k: v // 2 for k, v in held.items()}
            if captured:
                check(r["graphs"] == {"captures": 1,
                                      "replays": DIST_WINDOWS - 1,
                                      "held": [held]},
                      f"distributed (e) {name}: one local graph of F x "
                      f"{k_local} replica steps, replayed {r['graphs']}")
            else:
                check((r["graphs"] or {}).get("captures", 0) == 0,
                      f"distributed (e) {name}: the ZeRO window eager "
                      f"across processes {r['graphs']}")
            ms = float(np.median(r["ms"][1:]))
            ex = float(np.mean(r["exchange_s"][1:])) * 1e3
            mib = float(np.mean(r["exchange_bytes"][1:])) / 2 ** 20
            print(f"distributed (e) bf16 Adam wrapper {m} F {F}, rank "
                  f"{rank}: windows {[round(x, 3) for x in r['ms']]} ms "
                  f"(the first captures), {ms:.3f} ms a window after it, "
                  f"{tokens / ms * 1e3:.1f} tokens/s for the group "
                  f"({2 * k_local} replicas x {F} x {DIST_ROWS} x "
                  f"{TRAIN_T}); the exchange {ex:.3f} ms and {mib:.1f} MiB "
                  f"sent a window, the rest {ms - ex:.3f} ms; peak "
                  f"{r['peak_mb']:.0f} MiB; graphs {r['graphs']} "
                  f"[{name_card}]")


def _f32_wrapper_reference():
    """(e)'s float32 oracle: the one-process four-slot SGD wrapper at F 3
    on the children's windows: (the net, its params before)."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    K, F = 2 * DIST_SLOTS, 3
    one = _lm_wrapper_net("f32")
    p0 = _param_snapshot(one)
    pw = ParallelWrapper(one, workers=K, mesh=_slots(data=K),
                         averaging_frequency=F)
    pw.fit(iter(_lm_batches(DIST_F32_WINDOWS * K * F, DIST_ROWS,
                            DIST_SEED + F)))
    _release(pw)
    return one, p0


def _dist_f32_wrapper(kids, pattern, ref, name_card, launches):
    """(e)'s float32 oracle: two processes' SGD wrapper at F 3 against the
    one-process four-slot wrapper on the same windows (``ref``), within
    ``SYNC_TOL`` and ``CHANGE_LIMIT``."""
    vecs = [np.load(pattern.format(rank=r)) for r in range(2)]
    check(np.array_equal(vecs[0], vecs[1]),
          "distributed (e) float32 wrapper: the ranks' params bit for bit")
    F = 3
    one, p0 = ref
    child = one.clone()
    child.set_params_vector(vecs[0])
    what = (f"distributed (e) float32 wrapper (SGD {PARALLEL_SGD_LR:g}, 2 "
            f"processes x {DIST_SLOTS} slots of {DIST_ROWS} x {TRAIN_T}, F "
            f"{F}, {DIST_F32_WINDOWS} windows) against the one-process "
            f"four-slot wrapper")
    _close(what, child, one, SYNC_TOL, hold=True)
    _change_close(what, child, one, p0, CHANGE_LIMIT, hold=True)
    want = _want_wrapper(DIST_F32_WINDOWS, F, DIST_SLOTS, True)
    for k in kids:
        r = k["runs"]["wrap_f32"]
        check(r["launches"] == want, f"distributed (e) float32 wrapper "
              f"launches {r['launches']} against {want}")
        launches["f32"].update(r["launches"])
        print(f"distributed (e) float32 wrapper: windows "
              f"{[round(x, 3) for x in r['ms']]} ms, the exchange "
              f"{[round(x * 1e3, 3) for x in r['exchange_s']]} ms "
              f"[{name_card}]")
    _drop(one)
    _drop(child)


def _dist_elastic(kids, name_card, launches):
    """(f): replica 3 (rank 1's) delayed: evicted on both ranks at the
    same window with equal masks, the stalls counted equal on both,
    readmitted after the delay clears; then one epoch of the elastic
    ``ParameterAveragingTrainingMaster``, the ranks bit for bit."""
    a, b = (k["runs"]["elastic"] for k in kids)
    on = DIST_ELASTIC_WINDOWS[0]
    out = [w for w, m in enumerate(a["masks"]) if m[-1] == 0.0]
    print(f"distributed (f) elastic wrapper (the char-LM cut to "
          f"{DIST_ELASTIC_LAYERS} layers, SGD), replica 3 delayed "
          f"{DIST_ELASTIC_DELAY:g} s for {on} windows then cleared: masks "
          f"rank 0 {a['masks']}, rank 1 {b['masks']}; replica 3 out in "
          f"windows {out}; barrier stalls {a['stalls']} and {b['stalls']} "
          f"({a['stall_s']:.3f} and {b['stall_s']:.3f} s); windows "
          f"{[round(x, 1) for x in a['ms']]} ms, {a['secs']:.1f} s in all; "
          f"then ParameterAveragingTrainingMaster(elastic=True), one epoch "
          f"of 2 windows in {a['pam_s']:.1f} s, {a['pam_active']} active; "
          f"params {a['pam_params']} and {b['pam_params']} [{name_card}]")
    check(a["masks"] == b["masks"], "distributed (f): the ranks' masks "
          "equal at every window")
    check(bool(out) and out[0] < on and all(m[:-1] == [1.0] * (len(m) - 1)
                                            for m in a["masks"]),
          "distributed (f): replica 3 alone evicted, while delayed")
    check(a["masks"][-1] == [1.0] * len(a["masks"][-1]) and out[-1] >= on,
          "distributed (f): replica 3 readmitted after the delay cleared")
    check(a["stalls"] == b["stalls"] > 0
          and a["stall_s"] == b["stall_s"], "distributed (f): the barrier "
          "stalls counted equal on both ranks")
    check(a["params"] == b["params"] and a["pam_params"] == b["pam_params"],
          "distributed (f): the ranks' params bit for bit")
    for r in (a, b):
        launches["bf16"].update(r["launches"])


def _dist_resnet_wrapper(kids, name_card, launches):
    """(g): ResNet-50 bf16 under the wrapper, one replica of 16 images a
    process: the ranks bit for bit, BatchNorm's training kernels 53 a
    replica step (the local graph's), and the time."""
    a, b = (k["runs"]["resnet_wrap"] for k in kids)
    check(a["digests"] == b["digests"] and a["net_state"] == b["net_state"],
          "distributed (g): the ranks' params and BatchNorm statistics bit "
          "for bit")
    want = {"bn_train_fwd": RESNET_BN_LAYERS, "bn_train_bwd": RESNET_BN_LAYERS}
    for rank, r in enumerate((a, b)):
        held = (r["graphs"] or {}).get("held", [])
        got = {k: held[0].get(k, 0) for k in want} if len(held) == 1 else {}
        check(got == want, f"distributed (g) the local graph's BatchNorm "
              f"launches {got} against {want} (one replica step)")
        counted = {k: r["launches"].get(k, 0) for k in want}
        check(counted == {k: 2 * v for k, v in want.items()},
              f"distributed (g) BatchNorm launches {counted}: the warm-up "
              f"and the capture")
        launches["bn"].update(counted)
        print(f"distributed (g) ResNet-50 bf16 wrapper, rank {rank}: the "
              f"window {r['ms'][0]:.3f} ms (its capture included), the "
              f"exchange {r['exchange_s'][0] * 1e3:.3f} ms, "
              f"{r['exchange_bytes'][0] / 2 ** 20:.1f} MiB; peak "
              f"{r['peak_mb']:.0f} MiB [{name_card}]")


def _sync_f32_reference():
    """(b) float32's single net, fit on the whole batch: (the net, its
    params before)."""
    single = transformer_char_lm(device="cuda", updater="sgd",
                                 lr=PARALLEL_SGD_LR, **TRAIN_MODEL_F32)
    p0 = _param_snapshot(single)
    for b in _lm_global(2, 2):
        single.fit(b.features, b.labels)
    return single, p0


def _dist_f32(kids, pattern, ref, launches):
    """(b) float32: the children's params against the single net's fit
    on the whole batch (``ref``), within ``SYNC_TOL`` and
    ``CHANGE_LIMIT``."""
    vecs = [np.load(pattern.format(rank=r)) for r in range(2)]
    check(np.array_equal(vecs[0], vecs[1]),
          "distributed (b) float32: the ranks' params bit for bit")
    single, p0 = ref
    child = single.clone()
    child.set_params_vector(vecs[0])
    what = (f"distributed (b) float32 (SGD {PARALLEL_SGD_LR:g}, 2 processes "
            f"x {DIST_SLOTS} slots of {DIST_ROWS} x {TRAIN_T}) against the "
            f"single net's fit on the whole batch")
    _close(what, child, single, SYNC_TOL, hold=True)
    _change_close(what, child, single, p0, CHANGE_LIMIT, hold=True)
    for k in kids:
        r = k["runs"]["f32"]
        check(r["launches"] == _want_lm(2), f"distributed (b) float32 "
              f"launches {r['launches']} against {_want_lm(2)}")
        launches["f32"].update(r["launches"])
    _drop(single)
    _drop(child)


def _dist_bf16(kids, name_card, launches):
    """(b) bf16 with Adam, replicated and ZeRO: the ranks' and the
    layouts' digests equal, the launches a layer a step, and the times."""
    digests = {(k_i, m): k["runs"][m]["params"]
               for k_i, k in enumerate(kids) for m in ("replicated", "zero")}
    check(len(set(digests.values())) == 1, f"distributed (b) bf16: the "
          f"ranks and the layouts bit for bit {digests}")
    tokens = 2 * DIST_SLOTS * DIST_ROWS * TRAIN_T
    for m in ("replicated", "zero"):
        for rank, k in enumerate(kids):
            r = k["runs"][m]
            check(r["launches"] == _want_lm(DIST_STEPS),
                  f"distributed (b) bf16 {m} launches {r['launches']} "
                  f"against {_want_lm(DIST_STEPS)}")
            launches["bf16"].update(r["launches"])
            med = float(np.median(r["ms"][1:]))
            mean = float(np.mean(r["ms"]))
            ex = r["exchange_s"] * 1e3 / DIST_STEPS
            print(f"distributed (b) bf16 Adam {m}, rank {rank}: steps "
                  f"{[round(x, 3) for x in r['ms']]} ms (the first pays "
                  f"the warm-up), median after it {med:.3f} ms, "
                  f"{tokens / med * 1e3:.1f} tokens/s for the group; over "
                  f"the {DIST_STEPS} steps the exchange {ex:.3f} ms a step "
                  f"({r['exchange_count']} collectives, "
                  f"{r['exchange_bytes'] / DIST_STEPS / 2 ** 20:.1f} MiB "
                  f"sent a step) of {mean:.3f}, the rest {mean - ex:.3f} "
                  f"ms; peak "
                  f"{r['peak_mb']:.0f} MiB; census {r['census']} "
                  f"(two processes time-slice one card: the exchange's cost "
                  f"and the card's sharing, not scale-out) [{name_card}]")


def _change_vs(run, ref, p0):
    """``||run - p0 - (ref - p0)|| / ||ref - p0||`` over every params
    leaf together (float64 on the host)."""
    num = den = 0.0
    for n in ref:
        d64 = ref[n] - p0[n]
        num += float(((run[n] - p0[n]) - d64).pow(2).sum())
        den += float(d64.pow(2).sum())
    return math.sqrt(num / den)


def _resnet_reference():
    """``resnet_oracle``'s nets: the single float32 ResNet-50 (SGD at
    ``PARALLEL_SGD_LR`` from seed 12345) after step 1 and after step 2
    on ``_resnet_global(2)``'s images, a float64 copy after two steps
    (the helpers off: the kernels take no float64), and the params
    before."""
    single = resnet50(device="cuda", updater="sgd", lr=PARALLEL_SGD_LR,
                      seed=12345)
    single._capture = False
    p0 = _param_snapshot(single)
    f64 = single.clone()
    f64._capture = False
    for part in ("params", "updater_state", "net_state"):
        setattr(f64, part, cast_tree(getattr(f64, part), torch.float64))
    ds = _resnet_global(2)
    t0 = time.perf_counter()
    single.fit(ds.features, ds.labels)
    step1 = single.clone()
    single.fit(ds.features, ds.labels)
    t32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    with helpers.helpers_disabled():
        for _ in range(2):
            f64.fit(ds.features.astype(np.float64),
                    ds.labels.astype(np.float64))
    t64 = time.perf_counter() - t0
    ref = _param_snapshot(f64)
    _drop(f64)
    return {"single": single, "step1": step1, "p0": p0, "f64": ref,
            "n": len(ds), "t32": t32, "t64": t64}


def resnet_oracle(vec1, vec2, ref=None):
    """(c)'s readings for two processes' ResNet-50 float32 params after
    its first step (``vec1``) and its second (``vec2``), SGD at
    ``PARALLEL_SGD_LR`` on ``_resnet_global(2)``'s 32 images from seed
    12345, against ``_resnet_reference()``'s nets (``ref``, made here
    without one).  The oracle is the second step's change over every
    parameter against a float64 single net's: the two processes'
    (``e2``) no more than twice the single float32 net's (``e1``).  The
    first step against the single float32 net (the params' max abs
    error ``err1``, within ``SYNC_TOL``: ``ok1``; the change's largest
    relative error over the leaves, ``rel1``) is printed, not held: each
    process convolves its own 16 images, another float32 sum than one
    convolution over 32, and the BatchNorms' gammas, whose gradient sums
    cancel to about 1e-5 of a weight's change, then move by about 8e-2
    of their change on the card (PERF.md §6)."""
    ref = ref or _resnet_reference()
    single, step1, p0 = ref["single"], ref["step1"], ref["p0"]
    child = single.clone()
    what = (f"distributed (c) ResNet-50 float32 (SGD {PARALLEL_SGD_LR:g}, "
            f"2 processes x {DIST_SLOTS} slots of {DIST_RESNET_ROWS}), "
            f"step 1, against the single net on the {ref['n']} images "
            f"(printed, not held)")
    child.set_params_vector(vec1)
    err1 = _close(what, child, step1, SYNC_TOL, hold=False)
    ok1 = bool(np.allclose(vec1, step1.params_to_vector(), **SYNC_TOL))
    rel1 = _change_close(what, child, step1, p0, CHANGE_LIMIT, hold=False,
                         noise=RESNET_NOISE)
    child.set_params_vector(vec2)
    e1 = _change_vs(_param_snapshot(single), ref["f64"], p0)
    e2 = _change_vs(_param_snapshot(child), ref["f64"], p0)
    print(f"distributed (c) step 2: the change against the float64 single "
          f"net's, over every parameter: two processes {e2:.3e}, the "
          f"single float32 net {e1:.3e} (limit twice the single net's); "
          f"the float32 fit {ref['t32']:.1f} s, the float64 fit "
          f"{ref['t64']:.1f} s")
    for net in (single, step1, child):
        _drop(net)
    return {"err1": err1, "ok1": ok1, "rel1": rel1, "e1": e1, "e2": e2}


def _dist_resnet(kids, patterns, ref, name_card, launches):
    """(c) ResNet-50 float32 over 2 x 2 slots of 8 images, BatchNorm on
    the gathered rows: the ranks bit for bit, ``resnet_oracle``'s
    oracle held, BatchNorm's kernels one a layer a step, and the
    times."""
    vecs = [np.load(patterns[0].format(rank=r)) for r in range(2)]
    check(np.array_equal(vecs[0], vecs[1]),
          "distributed (c): the ranks' params bit for bit")
    check(kids[0]["runs"]["resnet"]["net_state"]
          == kids[1]["runs"]["resnet"]["net_state"],
          "distributed (c): the ranks' BatchNorm running statistics bit "
          "for bit")
    got = resnet_oracle(np.load(patterns[1].format(rank=0)), vecs[0], ref)
    check(got["e2"] <= 2 * got["e1"], "distributed (c) step 2: no farther "
          "from float64 than twice the single float32 net")
    n = 2 * DIST_SLOTS * DIST_RESNET_ROWS
    want = {"bn_train_fwd": 2 * RESNET_BN_LAYERS,
            "bn_train_bwd": 2 * RESNET_BN_LAYERS}
    for rank, k in enumerate(kids):
        r = k["runs"]["resnet"]
        got = {x: r["launches"].get(x, 0) for x in want}
        check(got == want, f"distributed (c) BatchNorm launches {got} "
              f"against {want} (one a layer a step, on the gathered rows)")
        launches["bn"].update(got)
        med = float(np.median(r["ms"][1:]))
        print(f"distributed (c) rank {rank}: steps "
              f"{[round(x, 3) for x in r['ms']]} ms, {n / med * 1e3:.1f} "
              f"images/s for the group; the exchange "
              f"{r['exchange_s'] * 1e3 / 2:.3f} ms a step "
              f"({r['exchange_bytes'] / 2 / 2 ** 20:.1f} MiB sent a step: the "
              f"BatchNorm rows and the gradients); peak {r['peak_mb']:.0f} "
              f"MiB [{name_card}]")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="smoke run on one GPU")
    parser.add_argument("--seed", type=int, default=NLP_SEED,
                        help="the nlp, graphs and clustering phases' data "
                        "and fits")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--distributed-child"]:
        return distributed_child(argv[1])
    args = parser.parse_args(argv)
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
    t_a10 = time.perf_counter()
    gc.collect()            # the earlier phases' nets and their graphs
    torch.cuda.empty_cache()
    base, pw_launches, rep = parallel_wrapper_phase(name_card)
    torch.cuda.empty_cache()
    pw_z, net_z, z_batches, zero_launches = zero_phase(name_card, base, rep)
    ck_launches = checkpoint_sharded_phase(name_card, pw_z, net_z, z_batches)
    del pw_z, net_z, rep
    torch.cuda.empty_cache()
    el_launches = elastic_phase(name_card, base)
    del base
    torch.cuda.empty_cache()
    sync_launches = sync_master_phase(name_card)
    torch.cuda.empty_cache()
    sp_launches, ulysses = sequence_parallel_phase(name_card)
    torch.cuda.empty_cache()
    t_a10 = time.perf_counter() - t_a10
    t_mp = time.perf_counter()
    gc.collect()
    tp_f32, tp_bf16 = tensor_parallel_phase(name_card)
    torch.cuda.empty_cache()
    expert_parallel_phase(name_card)
    torch.cuda.empty_cache()
    pp_f32, pp_bf16 = pipeline_phase(name_card)
    torch.cuda.empty_cache()
    pipeline_hetero_phase(name_card)
    torch.cuda.empty_cache()
    resnet_bn = sync_resnet_phase(name_card)
    torch.cuda.empty_cache()
    t_mp = time.perf_counter() - t_mp
    t_nlp = time.perf_counter()
    gc.collect()
    nlp_phase(name_card, args.seed)
    torch.cuda.empty_cache()
    t_nlp = time.perf_counter() - t_nlp
    t_graphs = time.perf_counter()
    gc.collect()
    graphs_phase(name_card, args.seed)
    torch.cuda.empty_cache()
    clustering_phase(name_card, args.seed)
    torch.cuda.empty_cache()
    t_graphs = time.perf_counter() - t_graphs
    t_dist = time.perf_counter()
    gc.collect()
    dist_launches = distributed_phase(name_card)
    torch.cuda.empty_cache()
    t_dist = time.perf_counter() - t_dist
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
    # the slot masters' wrapper launches (counted where a launch runs or
    # is recorded into a window's graph): the bf16 replicas' rows 1-3 and
    # 5, Ulysses' forward, the float32 sync master's tf32x3 rows, and the
    # prologue of the float32 sync and sequence-parallel steps
    names = ("flash_fwd", "flash_dq", "flash_dkv", "prologue")
    for counts in (pw_launches, zero_launches, ck_launches, el_launches):
        train_launches = [n + counts.get(k, 0)
                          for n, k in zip(train_launches, names)]
    train_launches[0] += ulysses
    train_launches[3] += (sync_launches.get("prologue", 0)
                          + sp_launches.get("prologue", 0))
    f32_launches = [n + sync_launches.get(k, 0)
                    for n, k in zip(f32_launches, names[:3])]
    # the tensor- and pipeline-parallel steps: their bf16 runs on rows
    # 1-3 and 5, their float32 oracles on the tf32x3 rows (and the
    # prologue's row); the sync ResNet-50's BatchNorm training kernels
    for counts in (tp_bf16, pp_bf16):
        train_launches = [n + counts.get(k, 0)
                          for n, k in zip(train_launches, names)]
    for counts in (tp_f32, pp_f32):
        f32_launches = [n + counts.get(k, 0)
                        for n, k in zip(f32_launches, names[:3])]
        train_launches[3] += counts.get("prologue", 0)
    bn_launches = (bn_launches[0],
                   bn_launches[1] + resnet_bn["bn_train_fwd"],
                   bn_launches[2] + resnet_bn["bn_train_bwd"])
    # the distributed phase's children (counted in each child): the bf16
    # char-LM's rows 1-3 and 5, the float32 one's tf32x3 rows and its
    # prologue, ResNet-50's BatchNorm training kernels
    train_launches = [n + dist_launches["bf16"].get(k, 0)
                      for n, k in zip(train_launches, names)]
    f32_launches = [n + dist_launches["f32"].get(k, 0)
                    for n, k in zip(f32_launches, names[:3])]
    train_launches[3] += dist_launches["f32"].get("prologue", 0)
    bn_launches = (bn_launches[0],
                   bn_launches[1] + dist_launches["bn"]["bn_train_fwd"],
                   bn_launches[2] + dist_launches["bn"]["bn_train_bwd"])
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
          f"multidataset phases {t_etl:.1f} s; the parallel_wrapper, zero, "
          f"checkpoint_sharded, elastic, sync_master and sequence_parallel "
          f"phases {t_a10:.1f} s; the tensor_parallel, expert_parallel, "
          f"pipeline, pipeline_hetero and sync_resnet phases {t_mp:.1f} "
          f"s; the nlp phase {t_nlp:.1f} s; the graphs and clustering "
          f"phases {t_graphs:.1f} s; the distributed phase {t_dist:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
