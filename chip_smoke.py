"""GPU smoke of the PyTorch/CUDA port (cxxnet_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase, on cuda:0

Phases (any failure raises and exits non-zero):

1. environment: the card's name and power limit, torch / CUDA versions,
   and the build of the hand-written kernels from ops/csrc (timed);
2. kernel parity: each CUDA kernel against its plain PyTorch version on
   the card at its main paths' shapes (the served forward; every kernel
   of the two LM train paths and of the two CNN paths at theirs), with
   its device time (``ms``: the profiler's kernel durations over 50
   back-to-back calls; CUDA events around 50 calls queued behind a sleep
   kernel where three traces lost events) and its wrapper's per-call time (``call_ms``:
   CUDA events around one call, the host's work included), the plain
   version's per-call time, one PyTorch library call's device and
   per-call times (a yardstick only: the port never calls it) and the
   least time the card could take (bound); each backward runs twice and
   must be bitwise equal; then each kernel route at the edge of its
   domain (layernorm warp / block, conv wgrad wgmma / mma.sync, the
   attention layer's routes at head widths 264 (dense), 256 (the wide
   wgmma kernels), 128 and 12 (widened), the LRN backward at windows
   of 33 and 64 channels; the forward and backward at head widths 256
   and 192, dense and segmented, timed beside sdpa's); and every other
   shape the two serving paths of phases 14 and 15 launch (the draft's
   flash prefill and layernorm rows, the verify's and chunk tick's
   layernorm rows, the max-pool forward at each bucket), checked only;
3. serve path: the port's ``task = serve`` / ``serve_gen = 1`` CLI serves
   the d2048 / 12-layer / s4096 / bf16 transformer LM (random weights
   from a seed, written as a ``.model``) to concurrent clients, twice
   over the same 8 prompts of seeded lengths in 64..1024 (one document
   each, ``serve_gen_prompt_doc = 1``); the kernels' launch counters
   must show that every prefill and every step went through them;
4. on-card consistency: the decode engine's prefill and incremental step
   logits against a cache-free full forward, through the kernels and
   through the plain torch path (``flash_attn = 0``, ``pallas_ln = 0``);
5. train path: ``task = train`` of the packed d2048 / 12-layer / 16-head
   / s4096 / vocab 8192 / bf16 / adam / batch 4 LM (random weights from
   a seed) on a seeded, learnable corpus of repeated phrases, through
   ``iter = text`` + ``iter = packseq``, for TRAIN_STEPS steps: finite,
   falling loss, and every attention / layernorm forward and backward
   through the segmented flash and layernorm kernels;
6. unpacked train path: the same net without segment ids (the JAX
   package's ``bench_transformer`` net) at depth 2, where the plain
   flash forward and backward kernels run;
7. AlexNet path: ``task = train`` of example/ImageNet/ImageNet.conf
   (batch 256, 3x227x227, bf16, sgd with momentum, xavier init) on
   ``synth_device_data = 1`` with ``multi_step = 10`` for 3 rounds,
   under ``pool_layout = hwcn pool_relu_fuse = 1 pallas_lrn = 1
   fast_wgrad = hwcn``: finite losses, and per step 2 LRN forward and
   backward, 3 max-pool forward and backward (one relu-masked) and one
   conv1 wgrad launch;
8. MNIST_CONV path: example/MNIST/MNIST_CONV.conf over
   tools/make_synth_mnist.py data for 4 rounds under ``pool_layout =
   hwcn fast_wgrad = hwcn``: the test error falls below half of its
   first round's; the last round's snapshot is kept;
9. fused train path: the packed LM of phase 5 under ``fused_update =
   1`` over the same corpus: the first loss bitwise equal to phase 5's,
   the later ones within 1e-2, one fused adam launch per admitted tensor
   per step, and the update's time fused and unfused;
10. AlexNet (H, W, C, N) path: ImageNet.conf as in phase 7 but under
   ``pallas_lrn = hwcn fast_wgrad = pallas``, 3 rounds of 10 steps: per
   step 2 (H, W, C, N) LRN forward and backward and one space-to-depth
   conv1 wgrad launch, and none of the NCHW LRN or the strided wgrad;
11. CNN inference path: ``task = pred``, ``pred_raw``, ``extract`` (text
   and binary) from phase 8's snapshot through example/MNIST/MNIST_pred.conf
   (its predictions' error equals the last round's test error, the raw
   rows sum to 1, the feature rows have the ``.meta`` width), with their
   per-batch latencies, and one round of ``task = finetune`` from it;
12. head-width-256 train path (``train_hd256``): the packed LM of phase
   5 with 8 heads of 256 columns at depth 2, WIDE_STEPS steps: finite,
   falling loss, and every step through the wide wgmma segmented flash
   forward and backward;
13. kill-and-continue path (``resume``): the packed LM of phase 9
   (``fused_update = 1``) at depth RESUME_LAYERS, RESUME_ROUNDS rounds of
   two batches, an atomic ``.ckpt`` snapshot written off the training
   thread after each round (``ckpt_async = 1 ckpt_keep = 1``).  Run A
   trains uninterrupted in this process; run B is the same CLI in a
   subprocess, SIGKILLed once its metrics show the round-RESUME_KILL_AFTER
   snapshot committed and a step of the next round taken, then continued
   here with ``continue = 1``.  B's last committed snapshot must validate
   after the kill, the continued run must start at the next round, and
   A's and B's last
   snapshots must be equal bitwise: every array of every shard, the
   train state (the CUDA generator's state too) and the iterator state.
   The train chain reads through ``iter = threadbuffer``; run A stages
   its batches inline (``prefetch_device = 0``), run B ahead (2).
   Prints each snapshot's bytes, write and blocked seconds and write
   rate, and the step p50 of each part;
14. speculative serve path (``serve_spec``, after ``serve``): on the
   served flagship, a width-4 ``block`` against 4 sequential steps, a
   chunked prefill (C 256) of a 1000-token prompt against the whole
   prefill and an f32 KV cache against the bf16 one, each within
   SERVE_TOL_BF16, and one step, verify and chunk tick timed; then the
   serve CLI over the same 8 prompts with ``spec_k = 3``, (a) drafting
   with a seeded d1024 / 8-head / 2-layer bf16 net under
   ``decode_prefill_chunk = 256`` and (b) drafting with the flagship's
   own snapshot.  Every generation equals a plain greedy decode token
   for token, or first differs where the plain top-2 margin is a
   near-tie (at most twice the logit noise just measured for the rows
   the run emits from); fed back through plain steps, every emitted id
   lies within that bound of its row's largest logit; (b) accepts at
   least 0.9 of the proposals; every prefill
   ran the flash forward and every forward of both nets the layernorm
   kernel.  Prints tokens/s, prefill / chunk / round p50, accept rate,
   verify calls, draft steps and prefill chunks;
15. micro-batched serve path (``serve_batch``, after ``mnist_conv``):
   ``task = serve`` of example/MNIST/serve.conf from phase 8's snapshot
   under ``pool_layout = hwcn``, buckets 1 / 8 / 32 and 4 clients, once
   for each ``serve_dtype`` (f32; bf16 and int8 pairtested on 2
   calibration batches): f32 agrees with ``task = pred`` on 99.9% of the
   rows with an error within 0.001 of the last round's test error, bf16
   and int8 within their SERVE_TOL and within 0.01 of f32's error, no
   retraces, and every dispatch through the max-pool kernel.  Prints
   qps, latency p50 / p99, mean batch, the bucket histogram and pad
   rows;
16. GoogLeNet path (``googlenet``): ``task = train`` of
   example/ImageNet/GoogLeNet.conf with its own keys (batch 256, bf16,
   ``input_s2d``, ``conv_sibling_fuse``, ``pallas_lrn = bandconv``,
   ``concat_virtual``, ``batch_split = 2``) on ``synth_device_data = 1``
   for 2 rounds of 10 steps: finite losses, and no hand-written kernel
   launched (its keys choose the plain lowerings);
17. GoogLeNet through the kernels (``googlenet_hwcn``): first one float32
   step of a narrow two-module inception net (the zoo's pieces) under
   the keys below, on the card and on the CPU from the same weights,
   every gradient within 5e-3; then the conf as in phase 16 under
   ``pool_layout = hwcn pool_relu_fuse = 1 pallas_lrn = 1 fast_wgrad =
   hwcn input_s2d = 0``: finite losses, and every step launches rows 1,
   3, 4 and 5 as often as the graph says (``googlenet_per_step``: per
   chain, the two LRNs, each max pool once a segment of its input,
   pool1's backward relu-masked, conv1's wgrad);
18. ResNet path (``resnet``): the zoo's resnet(depth = 56) at batch 128,
   bf16, on synthetic batches for 2 rounds of 10 steps: finite losses,
   and the last snapshot's moving statistics of every batch_norm layer
   finite and moved from their initial values;
19. AlexNet from a packed dataset (``alexnet_data``): ImageNet.conf with
   its own data sections (``iter = imgbin`` with the mean image built on
   first use, random crops and mirrors, ``iter = threadbuffer``; the train
   pack shuffled) over seeded JPEG packs of DATA_IMAGES train and
   DATA_EVAL_IMAGES test images of 3 x DATA_SIDE x DATA_SIDE made here
   with cv2 (labels in [0, 1000)), under the kernel keys of phase 7 and
   ``prefetch_device = 2``, DATA_ROUNDS rounds: finite losses, per step
   the launches of phase 7 and per eval batch 2 LRN and 3 max-pool
   forwards; prints the step p50 and images/s beside phase 7's and each
   round record's input fields, then one ``test_io = 1`` round (the host
   pipeline alone, no kernel launched) and its images/s.  The machine's
   JPEG libraries are printed first (phase 1): the native loader
   (``iter = imbin_native``) needs libjpeg's headers to build;
20. staging race check (``staging``): a ``DevicePrefetcher`` of depth 2
   stages STAGING_BATCHES batches of three chains on its copy stream,
   each normalised and copied out on the compute stream and then
   dropped, once while bf16 matmuls keep that stream busy (the
   ``record_stream`` hazard) and once read the moment it is handed over
   on an idle stream (the hazard of a read that does not wait on the
   batch's event); every result must equal bitwise what
   ``prefetch_device = 0`` stages for the same batch: phase 19's train
   chain, MNIST_CONV's train chain and seeded u8 batches at AlexNet's
   shape (normalised with ImageNet's mean);
21. training observatory and span tracing (``observe``, after
   ``serve`` and ``mnist_conv``): (a) the packed LM of phase 9 at full
   width and depth with ``monitor = 1 monitor_interval = 2``, a profile
   window over dispatches 2-4, ``sentinel = 1``, ``trace_sample = 1``,
   ``ckpt_async = 1`` and ``prefetch_device = 2``: the ``trace``
   record's device time within 5% of the window profiler's own device
   events, the segmented flash and layernorm kernels (rows 9-12) under
   their attention and layernorm connections (the backward ones through
   the autograd join) and the fused adam kernel (row 13) unattributed,
   a finite ``monitor`` record a parameter leaf a tick, the ledger's
   categories tiling its wall within 1%, the prefetcher's and the
   checkpoint writer's spans, the ``layer_profile`` rows' cost columns
   (``mfu_pct`` / ``roofline_x`` against the card's peaks) and a
   well-formed ``mem_profile`` record of the window's first step read
   from the caching allocator (coverage above 0), printed beside the
   memory model's estimate and ``max_memory_allocated``; (b) the step p50 of phase 9's LM at depth
   2 with the plane off and on (``trace_sample = 1 sentinel = 1``), off,
   on, on, off; (c) MNIST_CONV.conf with ``monitor_nan = fatal rollback
   = 2``, one batch of round 3 NaN-poisoned: one rollback to round 2, a
   completed run, a valid last snapshot, finite losses; (d)
   ``serve_batch`` (f32) and ``serve`` with ``trace_sample = 1``: the
   per-stage breakdown, and the ``request`` spans' p99 equal to the
   ``latency`` record's within 1%;
22. serving observability plane (``serve_admin``, after ``serve`` and
   ``serve_batch``): (a) example/MNIST/serve.conf as in phase 15 (f32)
   with ``serve_admin_port``, ``serve_sentinel = 1``,
   ``serve_sentinel_window = 0.25``, ``serve_flight_requests = 16`` and
   ``serve_slo_p99_ms`` at half phase 15's f32 p50, and a scraper
   process polling ``/readyz`` every millisecond and ``/metrics`` and
   ``/statusz`` at 10 Hz: ``/readyz`` 503 before 200 and the socket
   closed after the run, every scrape parsed with the port's promtext and no counter
   falling, ``last_window`` in ``/statusz``, ``serve_window`` records at
   about the run's length over the window, totalling the served rows, a
   fast ``slo`` record, exactly one ``serve_flight`` record whose
   trace-id range has its ``request`` spans in the sink, one max-pool
   launch a dispatch (and a bucket at warmup) and no retrace; then the
   same conf over ADMIN_SCRAPE_ROWS seeded test rows with the endpoint
   on, without (A) and with (B) a scraper process at 10 Hz, A B B A, each
   run's qps and latency p50 / p99 printed; (c) a stall of the card
   caught by the serve sentinels; (b) the LM serve of phase 3 over
   ADMIN_GEN_PROMPTS prompts with ``serve_admin_port``, without and with
   a scraper at 10 Hz, A B B A,
   each run's tok/s printed; in each scraped run ``/statusz``
   says ``kind = generate`` with tokens, steps and the occupancy
   histogram, ``/metrics`` has ``decode_occupancy_hist`` buckets, every
   prefill through row 7 and every forward through row 11;
23. config analysis (``check``): the port's ``task = check``, which does
   no device work: (a) ``mem_check = 1 mem_chip = h100`` on phase 9's LM
   conf at full width exits 0 with an ``info`` pre-flight finding (its %
   full), timed; (b) the same conf at the least batch whose modelled
   peak passes the card's 80 GB (found on meta tensors, never run)
   exits 1 with an error carrying remediations; (c) every
   example/**/*.conf, each exit code and error count printed.  In (a)
   the graph lint (analysis/graph_lint.py) traces the full-width fused
   step on meta tensors and gives one ``info`` finding and no error; it
   runs once more alone, its node count and seconds printed.  The
   allocator's live and reserved bytes and its count of allocations
   must not move and no kernel may launch.  The phase runs in a child
   process started before the serve phase, beside the card's phases
   (it takes one host core), and is collected in its turn;
24. pair test (``pairtest``): ImageNet.conf with conv1 rewritten as
   ``pairtest-conv-torch`` (batch 256, bf16, ``synth_device_data = 1``,
   the kernel keys of phase 7) for PAIR_STEPS steps: the master's
   backward is row 5, the slave's cuDNN under autograd, rows 1, 3 and 4
   run around them; each step's fwd / in_grad / wgrad / weight relative
   errors printed and held to their stated bounds, the last step's
   weight and bias gradients of both sides held normwise, the same
   normwise at conv1's shape in a separate call (row 5 launched once,
   not counted with the path), then one float32 step with TF32 off (the
   reference's 1e-5 the yardstick);
25. Python and C frontends (``wrapper``): ``wrapper.api.train`` of
   MNIST_CONV.conf's net (rows 3-5) over synthetic MNIST on the card,
   predict / extract / get and set weight / save / reload, a
   ``ServingHost`` answering from 4 threads, the C ABI in process
   through ctypes, and the C demo from a fresh interpreter (train,
   save, reload) on the card;
26. data parallelism (``dp``): DP_RANKS ranks share cuda:0 in a gloo
   group spawned by the port's mesh module (gloo stages CUDA tensors'
   collectives through the host), each running the port's CLI on its
   rows of every batch: (a) ImageNet.conf at batch 256 (128 a rank),
   bf16, the AlexNet kernel keys (rows 1, 3, 4, 5), DP_ALEX_STEPS steps
   under ``dp_overlap`` 0 and 1 with ``test_on_server = 1`` (the
   replicas bitwise equal after every step), the bucket count printed;
   (b) train_fused's packed LM (rows 9-12) cut to DP_LM_LAYERS blocks
   under ``shard_opt_state = 1``, the fused adam (row 13) on each
   rank's slices, whose shapes are printed and held to row 13's plain
   version; (c) ResNet-56 at batch
   128 with the global batch's batch_norm statistics, in bf16 and in
   float32 (no TF32, deterministic cuDNN), the moving buffers bitwise
   equal across the ranks.  Each part's losses against the same CLI run
   on one device here (DP_LOSS_TOL; ResNet's bf16 run its first loss),
   every row of a part launched on each rank, each rank's peak memory
   and the step p50s printed beside the card's name and power limit;
   (d) every collective of the plane through the mesh module over NCCL
   at world size 1, f32 and bf16, each output its input; (e) the CLI
   with ``dev = gpu:0-1`` on a one-card machine exits non-zero with
   both device counts;
27. sequence and expert parallelism (``seq_expert``): SE_RANKS gloo
   ranks share cuda:0, each running the port's CLI: (a)
   example/LM/longctx.conf as shipped at data:2,seq:2 (ring attention
   over seq; rows 11, 12 a rank), (b) example/LM/moe_lm.conf as shipped
   at data:2,expert:2 and its net at data:2,model:2 (rows 9-12 a rank),
   SE_STEPS steps each over a seeded corpus with ``test_on_server = 1``,
   against the same CLI run on one device (rows 9-12): the first loss
   within SE_FIRST_TOL, every loss within DP_LOSS_TOL, the replicas
   bitwise equal, each rank holding half of the per-expert bytes
   (weights and adam state); (c) moe_lm.conf on one device under
   ``moe_dispatch`` sorted and dense; (d) ring attention at the served
   LM's attention width (b4, 16 heads, s4096, hd128, bf16, causal,
   packed segments) on 2 seq ranks against the one-device segmented
   flash forward and backward (rows 9, 10), normwise within
   SE_RING_TOL, its time and peak memory a rank.  Each rank's step p50
   and peak memory printed beside the card's name and power limit;
28. pipeline parallelism (``pipe``): gloo ranks share cuda:0, each
   running the port's CLI (stage handoffs staged through the host): (a)
   example/LM/pipeline_lm.conf as shipped (data:2, pipe:2, model:2,
   1F1B, dp_overlap's (pipe, data) buckets, fullc_gather, f32) on
   PIPE_RANKS ranks for SE_STEPS steps with ``test_on_server = 1``, then
   under GPipe, against one device (rows 9-12 on every rank); (b) the
   flagship packed LM at full width cut to PIPE_LAYERS blocks on
   ``mesh = pipe:2`` under GPipe and 1F1B at PIPE_MICRO microbatches of
   a row, against one device (rows 9-13 on both ranks), then at
   PIPE_MICRO_WIDE: the peak memory a rank flat under 1F1B, growing
   under GPipe.  Step p50, peak memory and handoffs a step a rank and
   ``pipe_bubble_frac`` printed beside the card's name and power limit.
   The check phase (23) runs the SPMD deep lint over every example conf
   and the full-width LM's trace, timed;
29. inference on a mesh (``infer_mesh``): INFER_RANKS gloo ranks share
   cuda:0 in one spawn, each running the port's CLI in the group (its
   rows of each batch, the rows all-gathered, rank 0 writing): (a)
   MNIST_pred.conf from the mnist_conv phase's snapshot under
   ``pool_layout = hwcn`` (``pred``, ``pred_raw``, ``extract`` in binary
   rows; f32, TF32 off), (b) micro-batched serve.conf in f32 over
   INFER_SERVE_ROWS seeded images (rank 0 serves, rank 1 follows each
   dispatch), (c) ImageNet.conf ``pred_raw`` at batch 256 (128 a rank),
   bf16, the AlexNet kernel keys (rows 1 and 3), over the alexnet_data
   phase's eval pack from a seeded init's snapshot, also against one
   device at a rank's batch.  Each against the same CLI run on one
   device here; rows/s of (a) and (c) and the qps of (b) on both printed
   beside the card's name and power limit.

The kernel phase also holds rows 1, 3, 4 and 5 to their plain versions
at the shapes phase 17 launches them (a batch_split chain of 128 images:
the LRNs at 56x56 with 64 and 192 channels, pool1 and the inception
pools, conv1's 7x7 stride-2 wgrad), timed in bf16.

Each path runs with every launch counter set to 0 just before it and
read just after.  The last two lines are a ``{"kernels": [...]}`` JSON
record and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
run outside a checkout of the repo, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

#: the JAX package's serving envelope (cxxnet_tpu/serve/engine.py SERVE_TOL),
#: for the logits of the whole bf16 net
SERVE_TOL_BF16 = 2e-2
#: float32 kernel outputs (and the float32 lse / mean / rstd of bf16 runs):
#: max |got - ref| / max |ref|
F32_TOL = 1e-4
#: bf16 kernel outputs: max |got - ref| per row within two bf16 ulps of
#: the row's largest element (one ulp of a value is at most 2^-7 of it)
BF16_ROW_TOL = 2.0 ** -6
#: bf16 attention gradients, per row: p and ds are rounded to bf16 before
#: their products on both sides, from float32 values that differ in the
#: last bits, so a few roundings flip; four bf16 ulps of the row's
#: largest element.  The row's denominator is floored at GRAD_ROW_FLOOR
#: of the tensor's largest element: a query that attends only to itself
#: (row 0, a document's first token, padding) has an exactly-zero
#: gradient, so both sides hold only float32 rounding noise there
BF16_GRAD_ROW_TOL = 2.0 ** -5
GRAD_ROW_FLOOR = 2.0 ** -10
#: bf16 dgamma / dbeta (stored in bf16 like gamma): one rounding apart
BF16_VEC_TOL = 2.0 ** -7

#: back-to-back calls whose device time device_ms averages
DEVICE_REPS = 50

# the served and trained model: bench.py's LM flagship width
VOCAB, SEQ, DIM, NLAYER, NHEAD = 8192, 4096, 2048, 12, 16
N_PROMPTS, GEN_TOKENS, SLOTS, CLIENTS = 8, 32, 4, 4
PROMPT_LENS = (64, 1024)    # prompt lengths drawn uniformly from this range
MAIN_REPS = 2               # CLI runs over the same prompts
DEV = "gpu"
# training: bench_transformer's batch and updater; adam at eta 1e-3
TRAIN_BATCH, TRAIN_STEPS, TRAIN_ETA = 4, 6, 1e-3
UNPACKED_LAYERS, UNPACKED_STEPS = 2, 3
# the head-width-256 LM (d 2048 / 8 heads), cut to depth 2
WIDE_NHEAD, WIDE_LAYERS, WIDE_STEPS = 8, 2, 4
# kill and continue: the packed LM cut to depth 1 (a snapshot holds each
# parameter as float32 with its adam moments and master: 16 bytes a
# parameter, ~1.5 GB at depth 1), RESUME_ROUNDS rounds of two batches;
# run B is killed after snapshot RESUME_KILL_AFTER
RESUME_LAYERS, RESUME_ROUNDS, RESUME_KILL_AFTER = 1, 2, 1
#: seconds run B may take to reach its kill point
RESUME_KILL_TIMEOUT = 300
DOC_LENS = (64, 4096)       # training document lengths
# serve_spec: speculation of SPEC_K proposals a round; the chunk width of
# run (a); the seeded small draft of run (a): d, heads, depth
SPEC_K, SPEC_CHUNK = 3, 256
DRAFT_DIM, DRAFT_NHEAD, DRAFT_LAYERS = 1024, 8, 2
#: run (b) drafts with the flagship itself: its accept rate must reach this
SELF_DRAFT_ACCEPT = 0.9
#: serve_batch: the f32 predictions against task = pred's, and the
#: error against the last mnist_conv round's test error (f32) and
#: against f32's (bf16 / int8)
BATCH_AGREE, BATCH_ERR_F32, BATCH_ERR_QUANT = 0.999, 1e-3, 1e-2
#: serve_batch: the shape buckets (serve_shapes)
BATCH_SHAPES = (1, 8, 32)
LN_EPS = 1e-5
# observe: the profile window's first dispatch and its dispatches; the
# monitor's tick interval; device_sec against the profiler's own events,
# the ledger's categories against its wall, the request spans' p99
# against the latency record's (relative); the overhead runs' depth and
# steps; the rollback run's poisoned round and batch
OBSERVE_PROF = (2, 3)
OBSERVE_MONITOR_INTERVAL = 2
OBSERVE_DEVICE_TOL, OBSERVE_LEDGER_TOL, OBSERVE_LATENCY_TOL = 0.05, 0.01, 0.01
OBSERVE_LAYERS, OBSERVE_STEPS = 2, 10
ROLLBACK_ROUND, ROLLBACK_AT = 3, 2
# serve_admin: the reporter's window (s), the flight's boosted requests,
# the SLO target as a share of serve_batch's f32 p50 (below it, so the
# fast burn tier must fire), the scrapers' rate (Hz) and sentinel_rel:
# a threshold no healthy window crosses, since an anomaly after the
# SLO's flight would arm a second one
ADMIN_WINDOW, ADMIN_FLIGHT, ADMIN_SLO_SHARE = 0.25, 16, 0.5
ADMIN_SCRAPE_HZ, ADMIN_SENTINEL_REL = 10, 100.0
#: serve_admin's A B B A of the scrape's cost: seeded test rows a run
#: (micro-batched), seeded prompts a run (the LM serve, PROMPT_LENS and
#: GEN_TOKENS as the serve phase's); the anomaly run's test rows (a
#: baseline before the stall and the windows after it)
ADMIN_SCRAPE_ROWS, ADMIN_GEN_PROMPTS, ADMIN_STALL_ROWS = 2000, 24, 10000
#: serve_admin's anomaly run: sentinel_rel (a window's p99 more than 11x
#: its EWMA; the healthy windows' p99 jitter stays far below it, while
#: the queue-depth sentinel, whose baseline sits near 0 under 4 clients,
#: fires at any threshold on a window with a standing queue), and a stall
#: of the card (s of matmuls queued on the default stream) injected that
#: many seconds after /readyz turns 200
ADMIN_STALL_REL, ADMIN_STALL_SEC, ADMIN_STALL_AFTER = 10.0, 1.0, 3.0

ALL_PHASES = {"env", "kernels", "serve", "consistency", "train",
              "train_unpacked", "alexnet", "mnist_conv", "train_fused",
              "alexnet_hwcn", "cnn_infer", "train_hd256", "resume",
              "serve_spec", "serve_batch", "googlenet", "googlenet_hwcn",
              "resnet", "alexnet_data", "staging", "observe",
              "serve_admin", "check", "pairtest", "wrapper", "dp",
              "seq_expert", "pipe", "infer_mesh"}
#: --profile: the kernels listed by device time
PROFILE_TOP = 25

#: every ported kernel: its wrapper (module of cxxnet_tpu_torch.ops and
#: function), CUDA source and the pallas_call of the TPU kernel it
#: replaces (cxxnet_tpu/ops/pallas_kernels.py)
KERNELS = {
    "flash_attention_fwd": ("flash_attention", "flash_attention_fwd",
                            "flash_attn_fwd.cu", 1259),
    "flash_attention_bwd": ("flash_attention", "flash_attention_bwd",
                            "flash_attn_bwd.cu", 1294),
    "flash_attention_seg_fwd": ("flash_attention", "flash_attention_seg_fwd",
                                "flash_attn_fwd.cu", 1477),
    "flash_attention_seg_bwd": ("flash_attention", "flash_attention_seg_bwd",
                                "flash_attn_bwd.cu", 1498),
    "layernorm_fwd": ("layernorm", "layernorm_fwd", "layernorm_fwd.cu", 1736),
    "layernorm_bwd": ("layernorm", "layernorm_bwd", "layernorm_bwd.cu", 1770),
    "lrn_fwd": ("lrn", "lrn_fwd", "lrn.cu", 125),
    "lrn_bwd": ("lrn", "lrn_bwd", "lrn.cu", 125),
    "max_pool_fwd": ("pool", "max_pool_fwd", "max_pool.cu", 609),
    "max_pool_bwd": ("pool", "max_pool_bwd", "max_pool.cu", 648),
    "conv_wgrad": ("conv_wgrad", "conv_wgrad_hwcn_pallas", "conv_wgrad.cu",
                   830),
    "lrn_hwcn_fwd": ("lrn", "lrn_hwcn_fwd", "lrn.cu", 352),
    "lrn_hwcn_bwd": ("lrn", "lrn_hwcn_bwd", "lrn.cu", 352),
    "conv_wgrad_s2d": ("conv_wgrad", "conv_wgrad_s2d_pallas", "conv_wgrad.cu",
                       927),
    "fused_adam": ("fused_adam", "fused_adam_pallas", "fused_adam.cu", 1860),
}

# the CNN paths: ImageNet.conf as the slice runs it, per-step launches
ALEXNET_ARGS = ("dev=gpu", "synth_device_data=1", "multi_step=10",
                "num_round=3", "pool_layout=hwcn", "pool_relu_fuse=1",
                "pallas_lrn=1", "fast_wgrad=hwcn", "save_model=3")
ALEXNET_STEPS = 30
ALEXNET_PER_STEP = {"lrn_fwd": 2, "lrn_bwd": 2, "max_pool_fwd": 3,
                    "max_pool_bwd": 3, "conv_wgrad": 1}
# the same net through the (H, W, C, N) LRN and the space-to-depth wgrad
ALEXNET_HWCN_ARGS = ("dev=gpu", "synth_device_data=1", "multi_step=10",
                     "num_round=3", "pool_layout=hwcn", "pool_relu_fuse=1",
                     "pallas_lrn=hwcn", "fast_wgrad=pallas", "save_model=0")
ALEXNET_HWCN_STEPS = 30
# AlexNet from packed data: ImageNet.conf's own data sections over seeded
# JPEG packs (DATA_SIDE square, the reference's ImageNet resize), through
# the kernels of ALEXNET_ARGS and the device prefetcher
DATA_IMAGES, DATA_EVAL_IMAGES, DATA_SIDE, DATA_ROUNDS = 2560, 512, 256, 2
ALEXNET_DATA_ARGS = ("dev=gpu", f"num_round={DATA_ROUNDS}",
                     "pool_layout=hwcn", "pool_relu_fuse=1", "pallas_lrn=1",
                     "fast_wgrad=hwcn", "save_model=0", "print_step=5",
                     "prefetch_device=2")
#: ``prefetch_device=N`` appended to the CLI runs of the train, mnist_conv,
#: cnn_infer and alexnet_data phases (``--prefetch-device``; none: each
#: conf's own value)
PREFETCH_ARGS: list = []
#: AlexNet's eval forward, a batch: the two LRNs and the three pools
ALEXNET_EVAL_PER_BATCH = {"lrn_fwd": 2, "max_pool_fwd": 3}
#: the staging race check: batches a chain stages each way, and the bf16
#: matmuls (8192 square) queued on the compute stream before each is read
STAGING_BATCHES, STAGING_MATMULS = 4, 8
#: ImageNet's RGB channel means: the u8 batches of the staging check are
#: normalised with them
IMAGENET_MEAN = "123.68,116.78,103.94"
ALEXNET_HWCN_PER_STEP = {"lrn_hwcn_fwd": 2, "lrn_hwcn_bwd": 2,
                         "max_pool_fwd": 3, "max_pool_bwd": 3,
                         "conv_wgrad_s2d": 1}
# GoogLeNet: example/ImageNet/GoogLeNet.conf as shipped (batch 256, bf16,
# input_s2d / conv_sibling_fuse / pallas_lrn = bandconv / concat_virtual
# / batch_split = 2), 2 rounds of 10 steps on synthetic batches: no
# hand-written kernel on its path
GOOGLENET_ARGS = ("dev=gpu", "synth_device_data=1", "multi_step=10",
                  "num_round=2", "save_model=0")
GOOGLENET_STEPS = 20
# the same conf through rows 1, 3, 4 and 5; the launches a step are read
# from the graph (googlenet_per_step)
GOOGLENET_HWCN_ARGS = GOOGLENET_ARGS + (
    "pool_layout=hwcn", "pool_relu_fuse=1", "pallas_lrn=1",
    "fast_wgrad=hwcn", "input_s2d=0")
#: relu-masked pool backwards a step, under GOOGLENET_HWCN_ARGS, of
#: GoogLeNet.conf and of the narrow inception net (narrow_inception) at
#: INCEPTION_BATCH: pool1 (k3 s2, unpadded) is the one pool whose relu is
#: deferred to it with no bias, and the JAX package's pool gate
#: (cxxnet_tpu/ops/nn.py _hwcn_pool_ok, read with a TPU backend) holds
#: for it at each chain of 128 images, so one a chain, two a step.  A
#: literal, so that a wrong gate on the card cannot move the expected
#: count with the measured one.
GOOGLENET_RELU_PER_STEP = INCEPTION_RELU_PER_STEP = 2
#: the card-vs-CPU step of the narrow inception net: batch (two chains
#: of 128, so pool1's relu fuses into the pool on the card) and the f32
#: gradient envelope
INCEPTION_BATCH, INCEPTION_GRAD_TOL = 256, 5e-3
# ResNet: the zoo's resnet(depth = 56) (widths 16 / 32 / 64, 3x32x32),
# batch 128, bf16, sgd with momentum, 2 rounds of 10 steps on synthetic
# batches, its last snapshot read back
RESNET_DEPTH, RESNET_BATCH, RESNET_STEPS = 56, 128, 20
MNIST_ROUNDS = 4
#: the MNIST_CONV node whose values task = extract writes (se1's output)
EXTRACT_NODE, EXTRACT_WIDTH = "5", 100
#: fused adam (m1, m2, the master): rtol 1e-5, atol 1e-7, as the JAX
#: package holds its two lowerings (nvcc contracts multiply-adds into FMAs)
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-7
#: train_fused against train: the first loss bitwise, the later ones
#: within this relative difference
FUSED_LOSS_TOL = 1e-2
#: conv wgrad (float32 dW, db from either dtype): max |diff| / max |ref|;
#: both sides sum float32 products (exact for bf16 inputs) over up to
#: 774,400 positions, in different orders
WGRAD_TOL = 1e-3

# pairtest: ImageNet.conf with conv1 as pairtest-conv-torch (row 5 in the
# master's backward, cuDNN / autograd in the slave's), PAIR_STEPS steps
# at batch 256 in bf16 under ALEXNET_ARGS' kernel keys, then PAIR_F32_STEPS
# at float32 with TF32 off
PAIR_STEPS, PAIR_F32_STEPS = 4, 1
PAIR_ARGS = ("dev=gpu", "synth_device_data=1", "num_round=1",
             "pool_layout=hwcn", "pool_relu_fuse=1", "pallas_lrn=1",
             "fast_wgrad=hwcn", "save_model=0", "silent=1")
#: the pairtest layer's diagnostics are the reference's elementwise max
#: of |m - s| / max(|m|, |s|) (pairtest_layer-inl.hpp:194, its yardstick
#: 1e-5).  In bf16 an output or gradient element that cancels to ~0 reads
#: the two sides' float32 summation orders as an error of order 1, and
#: one whose sides round to neighbouring bf16 values as 2^-8 .. 2^-7: the
#: bound is the metric's range for finite values, 2 (a sign flip), so
#: the diagnostics must be finite, and the values below are held
#: normwise.  The slave's float32 conv runs with cuDNN's default
#: allow_tf32 = True; bf16 values are exact in TF32, so it changes
#: nothing but the summation order
PAIR_BF16_DIAG_BOUND = 2.0
#: normwise (max |m - s| / max |s|): the weight and bias gradients of
#: both sides in the trainer's own last step, and a separate call at
#: conv1's shape.  The bf16 output and input gradient within two bf16
#: ulps of the largest element (BF16_ROW_TOL), the float32 weight and
#: bias gradients of row 5 against cuDNN's within WGRAD_TOL before their
#: one rounding to bf16, so within one bf16 ulp after it
PAIR_WGRAD_BF16_TOL = 2.0 ** -7
#: the float32 step with TF32 off: the reference's yardstick (printed;
#: the elementwise metric may exceed it where a value cancels to ~0, and
#: the normwise errors are held to F32_TOL and WGRAD_TOL)
PAIRTEST_RTOL = 1e-5

# wrapper: example/MNIST/MNIST_CONV.conf's net through wrapper.api.train
# over the synthetic MNIST of mnist_conv_conf (rows 3-5), WRAPPER_ROUNDS
# rounds, then a ServingHost answering from WRAPPER_CLIENTS threads, the
# C ABI in process and the C demo
WRAPPER_ROUNDS, WRAPPER_CLIENTS = 2, 4

# dp: DP_RANKS ranks on cuda:0 over gloo.  (a) ImageNet.conf at batch 256
# (128 a rank) under ALEXNET_ARGS' kernel keys, a round a step for
# DP_ALEX_STEPS steps (the replicas checked after each); (b) the packed
# LM of train_fused under ZeRO for DP_LM_STEPS steps; (c) ResNet-56 at
# batch 128 as phase 18, DP_RESNET_STEPS steps in bf16 and in float32
# (no TF32, cuDNN deterministic).  Each part's losses within DP_LOSS_TOL
# (relative) of the one-device run's: the bf16 training envelope of
# train_fused against train (FUSED_LOSS_TOL); ResNet-56's bf16 run its
# first loss within a bf16 rounding (2^-8), the rest printed
DP_RANKS, DP_ALEX_STEPS, DP_LM_STEPS, DP_RESNET_STEPS = 2, 2, 3, 2
#: (b)'s depth: train_fused's width and layer shapes, fewer blocks
DP_LM_LAYERS = 4
DP_ALEXNET_ARGS = ("dev=gpu", "synth_device_data=1", "multi_step=1",
                   f"num_round={DP_ALEX_STEPS}", "pool_layout=hwcn",
                   "pool_relu_fuse=1", "pallas_lrn=1", "fast_wgrad=hwcn",
                   "save_model=0", "test_on_server=1")
DP_RESNET_ARGS = ("dev=gpu", "synth_device_data=1", "multi_step=1",
                  f"num_round={DP_RESNET_STEPS}", "save_model=0",
                  "test_on_server=1", "silent=1")
DP_LOSS_TOL = FUSED_LOSS_TOL
#: seconds a spawn of gloo ranks may take (each takes 15-70 s): a hang
#: fails its phase, with every rank's Python stack dumped to stderr
#: (:func:`arm_stack_dump`), well inside the smoke's time limit
DP_TIMEOUT_SEC = 300

# seq_expert: SE_RANKS gloo ranks on cuda:0.  (a) example/LM/longctx.conf
# at data:2,seq:2 and (b) example/LM/moe_lm.conf at data:2,expert:2 and
# at data:2,model:2, each as shipped for SE_STEPS steps of a seeded
# corpus, against the same CLI run on one device: the first loss within
# SE_FIRST_TOL (relative), the last within DP_LOSS_TOL; (c) moe_lm.conf
# on one device under moe_dispatch sorted and dense, within
# SE_DISPATCH_TOL; (d) ring attention at the served LM's attention
# width (SE_RING_SHAPE (b, h, s, hd), bf16, causal, packed segments) on
# 2 seq ranks against the one-device segmented flash (rows 9, 10),
# normwise within SE_RING_TOL
SE_RANKS, SE_STEPS = 4, 6
SE_FIRST_TOL = 1e-5
SE_DISPATCH_TOL = 1e-5
SE_RING_SHAPE = (4, 16, 4096, 128)
SE_RING_TOL = 2e-2
SE_RING_REPS = 3

# pipe: (a) example/LM/pipeline_lm.conf as shipped (data:2, pipe:2,
# model:2, 1F1B, dp_overlap = 1, fullc_gather = 1, f32) on PIPE_RANKS
# gloo ranks on cuda:0 for SE_STEPS steps of a seeded corpus with
# test_on_server = 1, then under pipe_schedule = gpipe, each against the
# same CLI on one device (first loss within SE_FIRST_TOL, every loss
# within DP_LOSS_TOL, replicas bitwise); (b) the packed LM of train_fused
# at full width cut to PIPE_LAYERS blocks, mesh = pipe:2 on 2 ranks,
# pipe_microbatch PIPE_MICRO (a row a microbatch), PIPE_STEPS steps under
# GPipe and 1F1B against one device (DP_LOSS_TOL), then PIPE_MICRO_WIDE
# microbatches of a row (batch 8) for PIPE_WIDE_STEPS steps under each,
# for the peak memory a rank: flat under 1F1B (within PIPE_FLAT_TOL),
# growing under GPipe
PIPE_RANKS, PIPE_LAYERS, PIPE_STEPS = 8, 4, 4
PIPE_MICRO, PIPE_MICRO_WIDE, PIPE_WIDE_STEPS = 4, 8, 1
PIPE_FLAT_TOL = 0.10

# infer_mesh: INFER_RANKS gloo ranks on cuda:0 in one spawn, each running
# the port's CLI inside the group.  (a) MNIST_pred.conf from mnist_conv's
# snapshot (pred, pred_raw, extract in binary rows; f32, TF32 off): the
# class ids equal one device's where its top two scores are more than
# INFER_MARGIN apart, the rows within INFER_F32_TOL normwise; (b)
# serve.conf (f32, buckets INFER_SHAPES) over INFER_SERVE_ROWS seeded
# images, its answers task = pred's on the same ranks (BATCH_AGREE); (c)
# ImageNet.conf at batch INFER_ALEX_BATCH (128 a rank), bf16, the AlexNet
# kernel keys, pred_raw over alexnet_data's eval pack from a seeded
# init's snapshot: the rows within INFER_F32_TOL normwise of one device
# at a rank's batch and its argmax on every row; against one device at
# the full batch within INFER_BF16_TOL normwise and the argmax equal on
# INFER_AGREE of the rows, or as close as one device's own rows at the
# two batches are (bf16 rows move with the batch on one device: 2.93e-2
# normwise, 0.9902 of the argmaxes, PERF.md PR 22); rows 1 and 3
# launched ALEXNET_EVAL_PER_BATCH times a batch on each rank
INFER_RANKS = 2
INFER_MARGIN, INFER_F32_TOL = 1e-5, 1e-5
INFER_BF16_TOL, INFER_AGREE = 2e-2, 0.99
INFER_SHAPES = (2, 8, 32)
INFER_SERVE_ROWS = 2000
INFER_ALEX_BATCH = 256
INFER_ALEX_ARGS = ("dev=gpu", "pool_layout=hwcn", "pool_relu_fuse=1",
                   "pallas_lrn=1", "silent=1")

REPO = os.path.dirname(os.path.abspath(__file__))
#: numbers one phase prints beside another's (alexnet's step p50)
MEASURED = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = DEVICE_REPS) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels, copies and fills that ``reps`` back-to-back calls put on the
    card (torch.profiler), over ``reps``.  The host's time between
    launches (the wrapper, ctypes, allocations) is not in it.

    Every call puts the same device events on the card, so a trace in
    which some event's count is not a multiple of ``reps`` lost events
    (one such trace timed a pool forward at 0.0040 ms, another held 44
    events of a two-event call in 50 calls): it is taken again, and after
    three such traces the time is taken by ``queued_ms`` instead, with a
    line that says so."""
    import torch
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        counts = Counter(e.name for e in events)
        us = sum(e.time_range.elapsed_us() for e in events)
        if us > 0 and counts and all(n % reps == 0
                                     for n in counts.values()):
            return us / reps / 1e3
    log(f"device_ms: three profiler traces lost device events (the last "
        f"held {len(events)} in {reps} calls: "
        f"{sorted(counts.values())}); timed by queued_ms")
    return queued_ms(fn, reps)


def queued_ms(fn, reps: int = DEVICE_REPS) -> float:
    """Device time of one call of ``fn`` without the profiler: ``reps``
    calls queued behind a sleep kernel that outlasts the host's launches,
    timed by CUDA events from the sleep's end to the last call's end, over
    ``reps``.  The device's own gaps between kernels are in it, the host's
    are not as long as the sleep outlasted the launches; where it did not
    (three tries, the sleep doubled each time), a line says so."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    # the sleep kernel's cycles per ms on this card
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(1 << 22)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = (1 << 22) / a.elapsed_time(b)
    sleep_ms = 1.0
    for _ in range(3):
        s0, s1, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(int(cycles_per_ms * sleep_ms))
        s1.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        e.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < s0.elapsed_time(s1):
            return s1.elapsed_time(e) / reps
        sleep_ms = 2 * max(sleep_ms, host_ms)
    log(f"queued_ms: the host's launches ({host_ms:.3f} ms) outlasted a "
        f"{s0.elapsed_time(s1):.3f} ms sleep; host gaps may be in the time")
    return s1.elapsed_time(e) / reps


def timings(run, plain=None, lib=None, reps: int = 20,
            plain_reps: int = 5) -> dict:
    """A row's times: the kernel's device ms (``ms``) and its wrapper's
    per-call ms (``call_ms``, CUDA events around one call, host work
    included), the plain version's per-call ms, and the library call's
    device and per-call ms (None without one)."""
    return dict(ms=device_ms(run), call_ms=time_ms(run, reps),
                plain_ms=None if plain is None else time_ms(plain,
                                                            plain_reps),
                library_ms=None if lib is None else device_ms(lib),
                library_call_ms=None if lib is None else time_ms(lib, reps))


def times_note(t: dict) -> str:
    lib = ("none" if t["library_ms"] is None else
           f"{t['library_ms']:.4f} ms device ({t['library_call_ms']:.4f} "
           "a call)")
    plain = "" if t["plain_ms"] is None else f"plain {t['plain_ms']:.4f} ms, "
    return (f"kernel {t['ms']:.4f} ms device ({t['call_ms']:.4f} a call), "
            f"{plain}library {lib}")


def time_ms(fn, reps: int = 10) -> float:
    """Median time of one call of ``fn`` over ``reps`` calls: CUDA events
    recorded around each call, so the host's work inside the call counts
    whenever it outlasts the device's (the per-call "call ms")."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| (the SERVE_TOL metric)."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-6))


def row_rel_err(got, ref, floor: float = 0.0) -> float:
    """max over rows of max |got - ref| / max |ref| within the row (the
    denominator at least ``floor`` times max |ref| of the tensor)."""
    got = got.float().reshape(-1, got.shape[-1])
    ref = ref.float().reshape(-1, ref.shape[-1])
    den = ref.abs().amax(1).clamp_min(
        max(1e-6, floor * float(ref.abs().max())))
    return float(((got - ref).abs().amax(1) / den).max())


def kernel_fn(name):
    import importlib
    module, fn = KERNELS[name][:2]
    return getattr(importlib.import_module(f"cxxnet_tpu_torch.ops.{module}"),
                   fn)


def reset_launches() -> None:
    from cxxnet_tpu_torch import ops
    ops.reset_launches()


def read_launches() -> dict:
    """``{row name: launches}`` from the port's one registry of wrappers
    (``ops.WRAPPERS``), which KERNELS must name exactly."""
    from cxxnet_tpu_torch import ops
    counts = ops.launch_counts()
    rows = {KERNELS[name][1]: name for name in KERNELS}
    if set(rows) != set(counts):
        raise AssertionError(f"KERNELS names wrappers {sorted(rows)}, "
                             f"ops.WRAPPERS {sorted(counts)}")
    return {rows[fn]: n for fn, n in counts.items()}


def rate(flops: float, ms: float, bound_ms: float) -> str:
    """Achieved TFLOP/s of ``flops`` operations in ``ms``, and the share of
    the bound (bound_ms / ms)."""
    return (f"{flops / ms * 1e-9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
            "bound")


def peaks() -> tuple:
    """The H100 SXM's published peaks (NVIDIA data sheet, dense), from the
    port's cost model (cxxnet_tpu_torch/analysis/costmodel.py): bytes/s
    of HBM3, and FLOP/s by dtype of the tensor cores (bf16) and of the
    CUDA cores (float32)."""
    from cxxnet_tpu_torch.analysis import costmodel as cm
    return cm.PEAK_BW[cm.H100], {"bfloat16": cm.PEAK_FLOPS[cm.H100],
                                 "float32": cm.PEAK_FLOPS_F32[cm.H100]}


def bound(flops: float, nbytes: float, dtype: str) -> dict:
    """The least time for ``flops`` operations and ``nbytes`` of traffic
    on this card's published peaks, and which of the two bounds it."""
    bw, peak = peaks()
    t_ops = flops / peak[dtype] * 1e3
    t_bytes = nbytes / bw * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ phases
def wgmma_ptxas(build_log: str):
    """(kernel, "registers; spills") of each wgmma kernel (flash and
    conv wgrad), the LRN window routes and the max-pool forward's cells
    route in the nvcc -Xptxas -v output (an entry's lines follow its
    name)."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '.*(flash_(?:fwd|bwd_dq|"
                      r"bwd_dkv)_(?:wgmma|wide)_kernel)ILi(\d+)ELb([01])E",
                      line)
        c = re.search(r"Compiling entry function '.*(conv_wgrad_wgmma_"
                      r"kernel)E", line)
        w = re.search(r"Compiling entry function '.*(lrn_(?:fwd|bwd)_window_"
                      r"kernel|max_pool_fwd_cells_kernel)I(13__nv_bfloat16|f)"
                      r"Li(\d+)ELi(\d+)E", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}, SEG={m.group(3)}>"
        elif c:
            name = c.group(1)
        elif w:
            dtype = "float" if w.group(2) == "f" else "bf16"
            name = f"{w.group(1)}<{dtype}, {w.group(3)}, {w.group(4)}>"
        elif "Compiling entry function" in line:
            name = None
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "Used" in line:
            out.append((name, f"{line.split(':', 1)[-1].strip()}; {spill}"))
            name, spill = None, ""
    return out


def phase_env():
    import torch
    from cxxnet_tpu_torch.ops import build
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    # float32 products in full float32 (the reference precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("matmul.allow_tf32 = False, cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    build.LIBRARY.get()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.LIBRARY.build_sec:.2f} s)")
    for line in build.LIBRARY.build_log.splitlines():
        if ("registers" in line or line.startswith("==")
                or "arning" in line or "Performance Loss" in line):
            log(f"  ptxas: {line.strip()}")
    for name, props in wgmma_ptxas(build.LIBRARY.build_log):
        log(f"  ptxas {name}: {props} (shared memory: dynamic, at launch)")
    log(f"JPEG: {jpeg_libraries()}")


def jpeg_libraries() -> str:
    """What of the machine can decode JPEG: libjpeg's header and shared
    library (the native loader, native/imbin_iter.cc, builds against
    them) and cv2 (the Python chain's decoder)."""
    import ctypes.util
    import glob
    header = [p for p in ("/usr/include/jpeglib.h",
                          "/usr/local/include/jpeglib.h") if os.path.exists(p)]
    libs = sorted(glob.glob("/usr/lib/x86_64-linux-gnu/libjpeg.so*")
                  + glob.glob("/usr/local/lib/libjpeg.so*"))
    try:
        import cv2
        cv = f"cv2 {cv2.__version__}"
    except ImportError as e:
        cv = f"no cv2 ({e})"
    return (f"jpeglib.h {header or 'absent'}; libjpeg.so "
            f"{libs or ctypes.util.find_library('jpeg') or 'absent'}; {cv}")


def phase_kernels():
    """Kernel vs plain version at the served shapes; returns the
    per-kernel numbers of the served (bf16) shape."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import flash_attention as fa
    from cxxnet_tpu_torch.ops import layernorm as ln
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    bh, s, d = NHEAD, SEQ, DIM // NHEAD
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        err = row_rel_err(o, o_ref) if bf16 else rel_err(o, o_ref)
        lerr = rel_err(lse, lse_ref)
        abs_err = float((o.float() - o_ref.float()).abs().max())
        tol = BF16_ROW_TOL if bf16 else F32_TOL
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        t = timings(lambda: fa.flash_attention_fwd(q, k, v, True),
                    lambda: fa.flash_attention_fwd_plain(q, k, v, True),
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True), reps=10, plain_reps=3)
        flops = 4.0 * d * bh * s * (s + 1) / 2
        bnd = bound(flops, 4 * bh * s * d * q.element_size() + bh * s * 4,
                    name)
        log(f"flash_attention_fwd ({bh},{s},{d}) causal {name}: "
            f"{'per-row ' if bf16 else ''}rel err o {err:.3e} (tol {tol:g}),"
            f" lse {lerr:.3e} (tol {F32_TOL:g}); abs err {abs_err:.3e}; "
            f"{times_note(t)} (sdpa), bound {bnd['bound_ms']:.4f} ms; "
            f"{rate(flops, t['ms'], bnd['bound_ms'])}")
        if not (err <= tol and lerr <= F32_TOL):
            raise AssertionError(f"flash_attention_fwd {name} disagrees "
                                 f"with its plain version: {err}, {lerr}")
        if dtype == torch.bfloat16:
            out["flash_attention_fwd"] = dict(max_abs_err=abs_err, **t,
                                              **bnd)
    for rows in (SEQ, SLOTS):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            x = (torch.randn((rows, DIM), generator=gen, device=dev) * 2 + 3
                 ).to(dtype)
            g = (torch.rand((DIM,), generator=gen, device=dev) + 0.5).to(dtype)
            b = (torch.randn((DIM,), generator=gen, device=dev) * .5).to(dtype)
            y, mean, rstd = ln.layernorm_fwd(x, g, b, 1e-5)
            y_ref, m_ref, r_ref = ln.layernorm_fwd_plain(x, g, b, 1e-5)
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            err = row_rel_err(y, y_ref) if bf16 else rel_err(y, y_ref)
            serr = max(rel_err(mean, m_ref), rel_err(rstd, r_ref))
            abs_err = float((y.float() - y_ref.float()).abs().max())
            tol = BF16_ROW_TOL if bf16 else F32_TOL
            t = timings(lambda: ln.layernorm_fwd(x, g, b, 1e-5),
                        lambda: ln.layernorm_fwd_plain(x, g, b, 1e-5),
                        lambda: F.layer_norm(x, (DIM,), g, b, 1e-5),
                        plain_reps=20)
            bnd = bound(8.0 * rows * DIM,
                        2 * rows * DIM * x.element_size()
                        + 2 * DIM * g.element_size() + 2 * rows * 4,
                        "float32")
            log(f"layernorm_fwd ({rows},{DIM}) {name}: "
                f"{'per-row ' if bf16 else ''}rel err y {err:.3e} (tol "
                f"{tol:g}), mean/rstd {serr:.3e} (tol {F32_TOL:g}); abs err "
                f"{abs_err:.3e}; {times_note(t)} (F.layer_norm), bound "
                f"{bnd['bound_ms']:.5f} ms")
            if not (err <= tol and serr <= F32_TOL):
                raise AssertionError(f"layernorm_fwd {name} ({rows} rows) "
                                     f"disagrees with its plain version: "
                                     f"{err}, {serr}")
            if dtype == torch.bfloat16 and rows == SEQ:
                out["layernorm_fwd"] = dict(max_abs_err=abs_err, **t, **bnd)
    serve_spec_shapes(gen)
    return out


def serve_spec_shapes(gen) -> None:
    """The shapes serve_spec launches beyond the served ones, each kernel
    against its plain version in bf16 and float32 at the served
    tolerances: the draft's flash prefill (DRAFT_NHEAD heads) and
    layernorm rows (a step of SLOTS, a prefill of SEQ at DRAFT_DIM), and
    the flagship's block dispatches (a verify of SLOTS x (SPEC_K + 1)
    rows, a chunk tick of SLOTS x SPEC_CHUNK)."""
    import torch
    from cxxnet_tpu_torch.ops import flash_attention as fa
    from cxxnet_tpu_torch.ops import layernorm as ln
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        tol = BF16_ROW_TOL if bf16 else F32_TOL
        bh, d = DRAFT_NHEAD, DRAFT_DIM // DRAFT_NHEAD
        q, k, v = (torch.randn((bh, SEQ, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True)
        err = row_rel_err(o, o_ref) if bf16 else rel_err(o, o_ref)
        lerr = rel_err(lse, lse_ref)
        log(f"flash_attention_fwd ({bh},{SEQ},{d}) causal {name} (draft "
            f"prefill): {'per-row ' if bf16 else ''}rel err o {err:.3e} "
            f"(tol {tol:g}), lse {lerr:.3e} (tol {F32_TOL:g})")
        if not (err <= tol and lerr <= F32_TOL):
            raise AssertionError(f"flash_attention_fwd {name} (draft "
                                 f"prefill) disagrees with its plain "
                                 f"version: {err}, {lerr}")
        del q, k, v, o, lse, o_ref, lse_ref
        for rows, dim, what in ((SLOTS, DRAFT_DIM, "draft step"),
                                (SEQ, DRAFT_DIM, "draft prefill"),
                                (SLOTS * (SPEC_K + 1), DIM, "verify"),
                                (SLOTS * SPEC_CHUNK, DIM, "chunk tick")):
            x = (torch.randn((rows, dim), generator=gen, device=dev) * 2 + 3
                 ).to(dtype)
            g = (torch.rand((dim,), generator=gen, device=dev) + 0.5
                 ).to(dtype)
            b = (torch.randn((dim,), generator=gen, device=dev) * .5
                 ).to(dtype)
            y, mean, rstd = ln.layernorm_fwd(x, g, b, LN_EPS)
            y_ref, m_ref, r_ref = ln.layernorm_fwd_plain(x, g, b, LN_EPS)
            err = row_rel_err(y, y_ref) if bf16 else rel_err(y, y_ref)
            serr = max(rel_err(mean, m_ref), rel_err(rstd, r_ref))
            log(f"layernorm_fwd ({rows},{dim}) {name} ({what}): "
                f"{'per-row ' if bf16 else ''}rel err y {err:.3e} (tol "
                f"{tol:g}), mean/rstd {serr:.3e} (tol {F32_TOL:g})")
            if not (err <= tol and serr <= F32_TOL):
                raise AssertionError(f"layernorm_fwd {name} ({rows}, {dim})"
                                     f" disagrees with its plain version: "
                                     f"{err}, {serr}")


def seeded_segments(rng, b: int, s: int, pad_max: int) -> np.ndarray:
    """(b, s) segment ids: documents of seeded lengths in DOC_LENS
    (numbered 1.. per row, the last one cut to fit) and a seeded zero
    (padding) tail of up to ``pad_max`` positions."""
    seg = np.zeros((b, s), np.int64)
    for r in range(b):
        end = s - rng.randint(0, pad_max + 1)
        pos, k = 0, 1
        while pos < end:
            n = min(rng.randint(DOC_LENS[0], DOC_LENS[1] + 1), end - pos)
            seg[r, pos:pos + n] = k
            pos, k = pos + n, k + 1
    return seg


def live_pairs(seg: np.ndarray, h: int) -> int:
    """(query, key) scores the segmented causal mask keeps: each
    document's triangle, plus the diagonal of every padding position."""
    total = 0
    for row in seg:
        _, n = np.unique(row[row != 0], return_counts=True)
        total += int((n * (n + 1) // 2).sum()) + int((row == 0).sum())
    return total * h


def _run_twice(label, run):
    """The kernel's outputs, after checking that a second run is bitwise
    equal (no atomics: the reductions are deterministic)."""
    import torch
    a, b = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: two runs are not bitwise equal")
    return a


def _errors(got, ref, bf16: bool, row_tol: float, floor: float = 0.0):
    """(per-output errors, tolerance, max abs error): per row for bf16,
    against the whole tensor for float32."""
    errs = [row_rel_err(x, r, floor) if bf16 else rel_err(x, r)
            for x, r in zip(got, ref)]
    abs_err = max(float((x.float() - r.float()).abs().max())
                  for x, r in zip(got, ref))
    return errs, (row_tol if bf16 else F32_TOL), abs_err


def phase_train_kernels():
    """The training path's kernels against their plain versions at the
    training shapes: flash forward and backward (causal), segmented flash
    forward and backward ((64, 4096, 128) = batch 4 x 16 heads, seeded
    documents and padding tails), the layernorm forward and backward
    ((16384, 2048), both residual contracts of the backward, one gamma
    column exactly 0); bf16 and float32.  Returns the numbers of the bf16
    runs (the forward kernels' under a "(training shape)" name: the
    served shape's numbers stand for them in the kernels line)."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import flash_attention as fa
    from cxxnet_tpu_torch.ops import layernorm as ln
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b, h, s, d = TRAIN_BATCH, NHEAD, SEQ, DIM // NHEAD
    bh = b * h
    seg_np = seeded_segments(np.random.RandomState(3), b, s, 512)
    seg = torch.from_numpy(seg_np).to(dev)
    pos = torch.arange(s, device=dev)
    mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
            | (pos[:, None] == pos[None, :])) & (pos[:, None] >= pos[None, :])
    mask = mask[:, None]                       # (b, 1, s, s) for sdpa
    pairs = {"causal": bh * s * (s + 1) // 2, "seg": live_pairs(seg_np, h)}
    log(f"training segments: documents per row "
        f"{[int(r.max()) for r in seg_np]}, padding tails "
        f"{[int((r == 0).sum()) for r in seg_np]}; live scores "
        f"{pairs['seg'] / pairs['causal']:.3f} of the causal triangle")
    out = {}

    def record(name, dtype, errs, tol, abs_err, t, bnd, what,
               shape=(bh, s, d), flops=None):
        log(f"{name} {shape} {dtype}: errors "
            f"{', '.join(f'{w} {e:.3e}' for w, e in zip(what, errs))} "
            f"(tol {tol:g}); abs err {abs_err:.3e}; {times_note(t)}, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})"
            f"{'; bitwise repeatable' if '_bwd' in name else ''}"
            f"{'; ' + rate(flops, t['ms'], bnd['bound_ms']) if flops else ''}")
        if not max(errs) <= tol:
            raise AssertionError(f"{name} {dtype} disagrees with its plain "
                                 f"version: {errs}")
        if dtype == "bfloat16":
            out[name] = dict(max_abs_err=abs_err, **t, **bnd)

    def sdpa_bwd(q, k, v, do, attn_mask):
        q4, k4, v4 = (t.detach().view(b, h, s, d).requires_grad_()
                      for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=attn_mask, is_causal=attn_mask is None)
        g4 = do.view(b, h, s, d)
        return lambda: torch.autograd.grad(o4, (q4, k4, v4), g4,
                                           retain_graph=True)

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        isz = 2 if bf16 else 4
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        grads = ("dq", "dk", "dv")
        # row 7 at the unpacked training shape
        run = lambda: fa.flash_attention_fwd(q, k, v, True)
        plain = lambda: fa.flash_attention_fwd_plain(q, k, v, True)
        (o, lse), ref = run(), plain()
        torch.cuda.synchronize()
        errs = [row_rel_err(o, ref[0]) if bf16 else rel_err(o, ref[0]),
                rel_err(lse, ref[1])]
        abs_err = float((o.float() - ref[0].float()).abs().max())
        del ref
        q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
        record("flash_attention_fwd (training shape)", name, errs,
               BF16_ROW_TOL if bf16 else F32_TOL, abs_err,
               timings(run, plain, lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=True), 10, 3),
               bound(4.0 * d * pairs["causal"],
                     4 * bh * s * d * isz + 4 * bh * s, name), ("o", "lse"),
               flops=4.0 * d * pairs["causal"])
        if not errs[1] <= F32_TOL:
            raise AssertionError("flash_attention_fwd lse disagrees")
        # row 8: the flash backward, causal, from the forward's o and lse
        run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True)
        plain = lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     True)
        got = _run_twice("flash_attention_bwd", run)
        errs, tol, abs_err = _errors(got, plain(), bf16, BF16_GRAD_ROW_TOL,
                                     GRAD_ROW_FLOOR)
        record("flash_attention_bwd", name, errs, tol, abs_err,
               timings(run, plain, sdpa_bwd(q, k, v, do, None), 10, 3),
               bound(10.0 * d * pairs["causal"],
                     8 * bh * s * d * isz + 4 * bh * s, name), grads,
               flops=10.0 * d * pairs["causal"])
        # row 9: the segmented forward
        run = lambda: fa.flash_attention_seg_fwd(q, k, v, seg)
        plain = lambda: fa.flash_attention_seg_fwd_plain(q, k, v, seg)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        errs = [row_rel_err(got[0], ref[0]) if bf16
                else rel_err(got[0], ref[0]), rel_err(got[1], ref[1])]
        abs_err = float((got[0].float() - ref[0].float()).abs().max())
        record("flash_attention_seg_fwd", name, errs,
               BF16_ROW_TOL if bf16 else F32_TOL, abs_err,
               timings(run, plain, lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=mask), 10, 3),
               bound(4.0 * d * pairs["seg"],
                     4 * bh * s * d * isz + 4 * bh * s + 4 * b * s, name),
               ("o", "lse"), flops=4.0 * d * pairs["seg"])
        if not errs[1] <= F32_TOL:
            raise AssertionError("flash_attention_seg_fwd lse disagrees")
        # row 10: the segmented backward
        o, lse = got
        run = lambda: fa.flash_attention_seg_bwd(q, k, v, seg, o, lse, do)
        plain = lambda: fa.flash_attention_seg_bwd_plain(q, k, v, seg, o,
                                                         lse, do)
        got = _run_twice("flash_attention_seg_bwd", run)
        errs, tol, abs_err = _errors(got, plain(), bf16, BF16_GRAD_ROW_TOL,
                                     GRAD_ROW_FLOOR)
        record("flash_attention_seg_bwd", name, errs, tol, abs_err,
               timings(run, plain, sdpa_bwd(q, k, v, do, mask), 10, 3),
               bound(10.0 * d * pairs["seg"],
                     8 * bh * s * d * isz + 4 * bh * s + 4 * b * s, name),
               grads, flops=10.0 * d * pairs["seg"])
        del q, k, v, do, o, lse, got
        # row 12: the layernorm backward, both residual contracts
        rows = b * s
        x = (torch.randn((rows, DIM), generator=gen, device=dev) * 2 + 3
             ).to(dtype)
        g = (torch.rand((DIM,), generator=gen, device=dev) + 0.5).to(dtype)
        g[5] = 0.0
        bt = (torch.randn((DIM,), generator=gen, device=dev) * .5).to(dtype)
        dy = torch.randn((rows, DIM), generator=gen, device=dev).to(dtype)
        # row 11 at the training shape, then row 12 from its residuals
        run = lambda: ln.layernorm_fwd(x, g, bt, LN_EPS)
        plain = lambda: ln.layernorm_fwd_plain(x, g, bt, LN_EPS)
        (y, mean, rstd), ref = run(), plain()
        torch.cuda.synchronize()
        errs = [row_rel_err(y, ref[0]) if bf16 else rel_err(y, ref[0])]
        serr = max(rel_err(mean, ref[1]), rel_err(rstd, ref[2]))
        abs_err = float((y.float() - ref[0].float()).abs().max())
        del ref
        log(f"layernorm_fwd (training shape) {name}: mean / rstd err "
            f"{serr:.3e} (tol {F32_TOL:g})")
        if not serr <= F32_TOL:
            raise AssertionError(f"layernorm_fwd {name} mean / rstd "
                                 f"disagree: {serr}")
        record("layernorm_fwd (training shape)", name, errs,
               BF16_ROW_TOL if bf16 else F32_TOL, abs_err,
               timings(run, plain,
                       lambda: F.layer_norm(x, (DIM,), g, bt, LN_EPS)),
               bound(8.0 * rows * DIM, 2 * rows * DIM * isz + 2 * DIM * isz
                     + 2 * rows * 4, "float32"), ("y",), (rows, DIM))
        for save_x in (False, True):
            a = x if save_x else y
            run = lambda: ln.layernorm_bwd(dy, a, g, bt, mean, rstd, save_x)
            plain = lambda: ln.layernorm_bwd_plain(dy, a, g, bt, mean, rstd,
                                                   save_x)
            got = _run_twice("layernorm_bwd", run)
            ref = plain()
            errs, tol, abs_err = _errors(got[:1], ref[:1], bf16,
                                         BF16_ROW_TOL)
            verr = max(rel_err(got[1], ref[1]), rel_err(got[2], ref[2]))
            vtol = BF16_VEC_TOL if bf16 else F32_TOL
            if not verr <= vtol:
                raise AssertionError(f"layernorm_bwd {name} dgamma / dbeta "
                                     f"disagree: {verr} (tol {vtol})")
            xx, gg, bb = (t.detach().requires_grad_() for t in (x, g, bt))
            yy = F.layer_norm(xx, (DIM,), gg, bb, LN_EPS)
            lib = lambda: torch.autograd.grad(yy, (xx, gg, bb), dy,
                                              retain_graph=True)
            nbytes = (3 * rows * DIM * isz + (2 if save_x else 1) * rows * 4
                      + 4 * DIM * isz)
            tag = f"layernorm_bwd{' save_x' if save_x else ''}"
            route = ln.bwd_route(DIM)
            log(f"{tag}: route {route}; dgamma / dbeta err {verr:.3e} (tol "
                f"{vtol:g})")
            if route != "register":
                raise AssertionError(f"layernorm_bwd d {DIM}: route {route}")
            numbers = (errs, tol, abs_err, timings(run, plain, lib),
                       bound(14.0 * rows * DIM, nbytes, "float32"), ("dx",),
                       (rows, DIM))
            if save_x:
                record(tag, name, *numbers)
            else:
                record("layernorm_bwd", name, *numbers)
        del x, dy, y
        torch.cuda.empty_cache()
    return out


def phase_cnn_kernels():
    """Rows 1, 3, 4 and 5 against their plain versions at the shapes of
    the two CNN paths, bf16 and float32: the LRN forward and backward at
    AlexNet's lrn1 (256, 96, 27, 27) and lrn2 (256, 256, 13, 13), each
    twice, bitwise equal, and timed at both; the
    max pool forward and the all-ties backward, plain and relu-masked, at
    pool1 (256, 96, 55, 55), pool2 (256, 256, 27, 27), pool5 (256, 256,
    13, 13) and MNIST_CONV's (100, 32, 14, 14), on inputs with many tied
    maxima, bitwise; the conv wgrad at conv1 (x (256, 3, 227, 227), 11x11
    stride 4 to 96 channels) and MNIST_CONV's (x (100, 1, 28, 28), 3x3
    stride 2 pad 1 to 32).  Every backward runs twice, bitwise equal.
    The kernels line takes the bf16 numbers at lrn1, pool1 and conv1;
    returns those and the others, under names of their own."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight
    from cxxnet_tpu_torch.ops import conv_wgrad as cw
    from cxxnet_tpu_torch.ops import lrn, pool
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    out = {}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def report(name, dtype, shape, err, tol, abs_err, times=None, bnd=None,
               note=""):
        timing = ""
        if times is not None:
            timing = (f"; {times_note(times)}, bound "
                      f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        log(f"{name} {shape} {dtype}: error {err:.3e} (tol {tol:g}); abs "
            f"err {abs_err:.3e}{timing}{note}")
        if not err <= tol:
            raise AssertionError(f"{name} {dtype} {shape} disagrees with "
                                 f"its plain version: {err}")
        if times is not None and dtype == "bfloat16":
            out[name] = dict(max_abs_err=abs_err, **times, **bnd)

    def compare(got, ref, bf16):
        err = row_rel_err(got, ref) if bf16 else rel_err(got, ref)
        return err, float((got.float() - ref.float()).abs().max())

    lrn_args = (5, 0.001, 0.75, 1.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        isz = 2 if bf16 else 4
        tol = BF16_ROW_TOL if bf16 else F32_TOL
        # row 1: LRN forward and backward (the backward timed at lrn1
        # and lrn2, lrn1 in the kernels line)
        for shape, tag in (((256, 96, 27, 27), ""),
                           ((256, 256, 13, 13), " lrn2")):
            x, g = randn(shape, dtype, 8.0), randn(shape, dtype)
            fwd = lambda: lrn.lrn_fwd(x, *lrn_args)
            plain = lambda: lrn.lrn_fwd_plain(x, *lrn_args)
            (y,) = _run_twice("lrn_fwd", lambda: (fwd(),))
            err, abs_err = compare(y, plain(), bf16)
            numel = x.numel()
            times = timings(fwd, plain, lambda: F.local_response_norm(
                x, 5, 0.001, 0.75, 1.0))
            bnd = bound(14.0 * numel, 2 * numel * isz, "float32")
            plan = lrn.fwd_plan(shape[0], shape[1], shape[2] * shape[3], 5,
                                isz, y.data_ptr() % 16 == 0)
            report(f"lrn_fwd{tag}", name, shape, err, tol, abs_err, times,
                   bnd, f"; route {plan.route} ({plan.vec} column(s) a "
                   f"thread, chunks of {plan.chunk} channels); bitwise "
                   "repeatable")
            if plan.route != "window":
                raise AssertionError(f"lrn_fwd {shape}: route {plan.route}")
            bwd = lambda: lrn.lrn_bwd(x, g, *lrn_args)
            plain = lambda: lrn.lrn_bwd_plain(x, g, *lrn_args)
            (dx,) = _run_twice("lrn_bwd", lambda: (bwd(),))
            err, abs_err = compare(dx, plain(), bf16)
            xx = x.detach().requires_grad_()
            yy = F.local_response_norm(xx, 5, 0.001, 0.75, 1.0)
            times = timings(bwd, plain, lambda: torch.autograd.grad(
                yy, xx, g, retain_graph=True))
            bnd = bound(30.0 * numel, 3 * numel * isz, "float32")
            plan = lrn.bwd_plan(shape[0], shape[1], shape[2] * shape[3], 5,
                                isz, dx.data_ptr() % 16 == 0)
            report(f"lrn_bwd{tag}", name, shape, err, tol, abs_err, times,
                   bnd, f"; route {plan.route} ({plan.vec} column(s) a "
                   f"thread, chunks of {plan.chunk} channels); bitwise "
                   "repeatable")
            if plan.route != "window":
                raise AssertionError(f"lrn_bwd {shape}: route {plan.route}")
            del x, g, xx, yy
        # rows 3 and 4: max pool forward and all-ties backward (the
        # backward timed at AlexNet's three pools, pool1 in the kernels
        # line)
        for shape, tag in (((256, 96, 55, 55), ""),
                           ((256, 256, 27, 27), " pool2"),
                           ((256, 256, 13, 13), " pool3"),
                           ((100, 32, 14, 14), None)):
            geom = (3, 3, 2, 0, 0)
            # a grid of 1/4 and a shift: many tied maxima, negative ones
            x = (torch.round(randn(shape, torch.float32, 6.0)) / 4 - 0.5
                 ).to(dtype)
            fwd = lambda: pool.max_pool_fwd(x, geom)
            y = fwd()
            if not torch.equal(y, pool.max_pool_fwd_plain(x, geom)):
                raise AssertionError(f"max_pool_fwd {name} {shape} is not "
                                     "bitwise equal to its plain version")
            nx, ny = x.numel(), y.numel()
            # the forward timed at all four shapes, pool1 in the kernels
            # line
            times = timings(fwd, lambda: pool.max_pool_fwd_plain(x, geom),
                            lambda: F.max_pool2d(x, 3, 2, ceil_mode=True),
                            plain_reps=3)
            bnd = bound(9.0 * ny, (nx + ny) * isz, "float32")
            route = pool.fwd_route(x, geom)
            report(f"max_pool_fwd{tag if tag is not None else ' mnist'}",
                   name, shape, 0.0, 0.0, 0.0, times, bnd,
                   f"; route {route}; bitwise; queued "
                   f"{queued_ms(fwd):.4f} ms device")
            if route != "cells":
                raise AssertionError(f"max_pool_fwd {shape}: route {route}")
            dy = (torch.round(randn(y.shape, torch.float32, 8.0)) / 8
                  ).to(dtype)
            for relu in (False, True):
                bwd = lambda: pool.max_pool_bwd(x, y, dy, geom, relu)
                plain = lambda: pool.max_pool_bwd_plain(x, y, dy, geom, relu)
                (dx,) = _run_twice("max_pool_bwd", lambda: (bwd(),))
                if not torch.equal(dx, plain()):
                    raise AssertionError(
                        f"max_pool_bwd {name} {shape} relu {relu} is not "
                        "bitwise equal to its plain version")
                times = bnd = None
                queued = ""
                if tag is not None:
                    xx = x.detach().requires_grad_()
                    yy = F.max_pool2d(xx, 3, 2, ceil_mode=True)
                    lib = lambda: torch.autograd.grad(yy, xx, dy,
                                                      retain_graph=True)
                    times = timings(bwd, plain, lib, plain_reps=3)
                    bnd = bound(9.0 * ny, (2 * nx + 2 * ny) * isz, "float32")
                    queued = (f"; queued {queued_ms(bwd):.4f} ms device, "
                              f"library {queued_ms(lib):.4f}")
                route = pool.bwd_route(x, geom)
                report(f"max_pool_bwd{' relu' if relu else ''}"
                       f"{tag or ''}", name, shape, 0.0, 0.0, 0.0, times,
                       bnd, f"; route {route}; bitwise, bitwise repeatable"
                       f"{queued}")
                if route != "cells":
                    raise AssertionError(f"max_pool_bwd {shape}: route "
                                         f"{route}")
            del x, y, dy
        # the forward at serve_batch's buckets, bitwise
        for n in BATCH_SHAPES:
            shape, geom = (n, 32, 14, 14), (3, 3, 2, 0, 0)
            x = (torch.round(randn(shape, torch.float32, 6.0)) / 4 - 0.5
                 ).to(dtype)
            y = pool.max_pool_fwd(x, geom)
            if not torch.equal(y, pool.max_pool_fwd_plain(x, geom)):
                raise AssertionError(f"max_pool_fwd {name} {shape} is not "
                                     "bitwise equal to its plain version")
            plan = pool.fwd_plan(n * 32, 14, 14, geom, isz)
            report("max_pool_fwd serve_batch", name, shape, 0.0, 0.0, 0.0,
                   note=f"; route {plan.route}, {plan.group} plane(s) a "
                   "block; bitwise")
        torch.cuda.empty_cache()
        # row 5: conv weight and bias gradient
        for xshape, co, k, st, pad in (((256, 3, 227, 227), 96, 11, 4, 0),
                                       ((100, 1, 28, 28), 32, 3, 2, 1)):
            x = torch.rand(xshape, generator=gen, device=dev).to(dtype)
            oh = (xshape[2] + 2 * pad - k) // st + 1
            dy = randn((xshape[0], co, oh, oh), dtype)
            args = (k, k, st, pad, pad)
            run = lambda: cw.conv_wgrad_hwcn_pallas(x, dy, *args)
            plain = lambda: cw.conv_wgrad_plain(x, dy, *args)
            got = _run_twice("conv_wgrad", run)
            ref = plain()
            err = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
            abs_err = max(float((a - b).abs().max())
                          for a, b in zip(got, ref))
            times = bnd = None
            if xshape[1] == 3:
                wshape = (co, xshape[1], k, k)
                times = timings(run, plain, lambda: (
                    conv2d_weight(x, wshape, dy, stride=st),
                    dy.sum((0, 2, 3))), reps=10)
                positions = xshape[0] * oh * oh
                bnd = bound(2.0 * positions * co * xshape[1] * k * k
                            + positions * co,
                            (x.numel() + dy.numel()) * isz
                            + (co * xshape[1] * k * k + co) * 4, name)
            route = cw.kernel_route(xshape[1], co, oh, k, k, st, dtype)
            report("conv_wgrad", name, (xshape, co, k, st, pad), err,
                   WGRAD_TOL, abs_err, times, bnd,
                   f"; route {route}; bitwise repeatable")
            if route != ("wgmma" if bf16 else "mma.sync"):
                raise AssertionError(f"conv_wgrad {name}: route {route}")
            del x, dy, got, ref
        torch.cuda.empty_cache()
        googlenet_cnn_kernels(dtype, randn, report, compare, out)
    return out


def googlenet_cnn_kernels(dtype, randn, report, compare, out) -> None:
    """Rows 1, 3, 4 and 5 at the shapes googlenet_hwcn launches them (a
    batch_split chain of 128 images): the LRN forward and backward at n1
    (128, 64, 56, 56) and n2 (128, 192, 56, 56), local_size 5; the pool
    forward and all-ties backward, plain and relu-masked, at pool1
    (128, 64, 112, 112) k3 s2 (its backward relu-masked on the path),
    pool2 (128, 192, 56, 56), the inception pool of i3a (128, 192, 28,
    28) k3 s1 p1 and segments of the virtual concats that later pools
    read, on relu'd inputs on a grid, bitwise; conv1's wgrad (x (128, 3,
    224, 224), 7x7 stride 2 pad 3 to 64).  Every backward twice, bitwise
    equal.  bf16 timed at n1, n2, pool1, i3a's pool and conv1: their
    numbers go into ``out`` under names of their own."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight
    from cxxnet_tpu_torch.ops import conv_wgrad as cw
    from cxxnet_tpu_torch.ops import lrn, pool
    name = str(dtype).split(".")[1]
    bf16 = dtype == torch.bfloat16
    isz = 2 if bf16 else 4
    tol = BF16_ROW_TOL if bf16 else F32_TOL
    args = (5, 1e-4, 0.75, 1.0)
    for shape, tag in (((128, 64, 56, 56), "n1"), ((128, 192, 56, 56), "n2")):
        x, g = randn(shape, dtype, 8.0), randn(shape, dtype)
        numel = x.numel()
        for what, run, plain, lib, flops, nbytes in (
                ("lrn_fwd", lambda: (lrn.lrn_fwd(x, *args),),
                 lambda: lrn.lrn_fwd_plain(x, *args),
                 lambda: F.local_response_norm(x, 5, 1e-4, 0.75, 1.0),
                 14.0, 2),
                ("lrn_bwd", lambda: (lrn.lrn_bwd(x, g, *args),),
                 lambda: lrn.lrn_bwd_plain(x, g, *args), None, 30.0, 3)):
            (got,) = _run_twice(what, run)
            err, abs_err = compare(got, plain(), bf16)
            if what == "lrn_bwd":
                xx = x.detach().requires_grad_()
                yy = F.local_response_norm(xx, 5, 1e-4, 0.75, 1.0)
                lib = lambda: torch.autograd.grad(yy, xx, g,
                                                  retain_graph=True)
            times = timings(lambda: run()[0], plain, lib) if bf16 else None
            report(f"{what} googlenet {tag}", name, shape, err, tol,
                   abs_err, times, bound(flops * numel, nbytes * numel * isz,
                                         "float32"), "; bitwise repeatable")
        del x, g
    for shape, geom, tag in (
            ((128, 64, 112, 112), (3, 3, 2, 0, 0), "pool1"),
            ((128, 192, 56, 56), (3, 3, 2, 0, 0), "pool2"),
            ((128, 192, 28, 28), (3, 3, 1, 1, 1), "i3a"),
            ((128, 64, 28, 28), (3, 3, 1, 1, 1), None),
            ((128, 96, 28, 28), (3, 3, 2, 0, 0), None),
            ((128, 320, 14, 14), (3, 3, 1, 1, 1), None),
            ((128, 128, 14, 14), (3, 3, 2, 0, 0), None),
            ((128, 384, 7, 7), (3, 3, 1, 1, 1), None)):
        # relu'd values on a grid: whole windows tie, at zero and above
        x = torch.relu(torch.round(randn(shape, torch.float32, 4.0)) / 2
                       ).to(dtype)
        fwd = lambda: pool.max_pool_fwd(x, geom)
        y = fwd()
        if not torch.equal(y, pool.max_pool_fwd_plain(x, geom)):
            raise AssertionError(f"max_pool_fwd {name} {shape} {geom} is "
                                 "not bitwise equal to its plain version")
        nx, ny = x.numel(), y.numel()
        k, _, st, pd, _ = geom
        lib_fwd = lambda: F.max_pool2d(x, k, st, padding=pd, ceil_mode=True)
        timed = bf16 and tag is not None
        times = (timings(fwd, lambda: pool.max_pool_fwd_plain(x, geom),
                         lib_fwd, plain_reps=3) if timed else None)
        report(f"max_pool_fwd googlenet {tag or 'segment'}", name,
               (shape, geom), 0.0, 0.0, 0.0, times,
               bound(9.0 * ny, (nx + ny) * isz, "float32"),
               f"; route {pool.fwd_route(x, geom)}; bitwise")
        dy = (torch.round(randn(y.shape, torch.float32, 8.0)) / 8).to(dtype)
        for relu in (False, True):
            bwd = lambda: pool.max_pool_bwd(x, y, dy, geom, relu)
            plain = lambda: pool.max_pool_bwd_plain(x, y, dy, geom, relu)
            (dx,) = _run_twice("max_pool_bwd", lambda: (bwd(),))
            if not torch.equal(dx, plain()):
                raise AssertionError(
                    f"max_pool_bwd {name} {shape} {geom} relu {relu} is not "
                    "bitwise equal to its plain version")
            times = None
            if timed and relu == (tag == "pool1"):
                xx = x.detach().requires_grad_()
                yy = F.max_pool2d(xx, k, st, padding=pd, ceil_mode=True)
                times = timings(bwd, plain, lambda: torch.autograd.grad(
                    yy, xx, dy, retain_graph=True), plain_reps=3)
            report(f"max_pool_bwd{' relu' if relu else ''} googlenet "
                   f"{tag or 'segment'}", name, (shape, geom), 0.0, 0.0, 0.0,
                   times, bound(9.0 * ny, (2 * nx + 2 * ny) * isz,
                                "float32"),
                   f"; route {pool.bwd_route(x, geom)}; bitwise, bitwise "
                   "repeatable")
        del x, y, dy
    torch.cuda.empty_cache()
    x = torch.rand((128, 3, 224, 224), device="cuda").to(dtype)
    dy = randn((128, 64, 112, 112), dtype)
    wargs = (7, 7, 2, 3, 3)
    run = lambda: cw.conv_wgrad_hwcn_pallas(x, dy, *wargs)
    plain = lambda: cw.conv_wgrad_plain(x, dy, *wargs)
    got, ref = _run_twice("conv_wgrad", run), plain()
    err = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    times = (timings(run, plain, lambda: (
        conv2d_weight(x, (64, 3, 7, 7), dy, stride=2, padding=3),
        dy.sum((0, 2, 3))), reps=10) if bf16 else None)
    positions = 128 * 112 * 112
    report("conv_wgrad googlenet conv1", name, ((128, 3, 224, 224), 64, 7,
                                               2, 3),
           err, WGRAD_TOL, abs_err, times,
           bound(2.0 * positions * 64 * 3 * 49 + positions * 64,
                 (x.numel() + dy.numel()) * isz + (64 * 3 * 49 + 64) * 4,
                 name),
           f"; route {cw.kernel_route(3, 64, 112, 7, 7, 2, dtype)}; "
           "bitwise repeatable")
    del x, dy, got, ref
    torch.cuda.empty_cache()


def phase_route_kernels():
    """Each kernel route at the edge of its domain, on the card, against
    the plain version: the layernorm forward's warp route ((4096, 2048),
    (3, 100), x off 16-byte alignment) and block route ((64, 20000)),
    bf16 and float32; the attention layer under ``flash_attn = 1`` with a
    gradient and segment ids at head width 264 (the dense route, as the
    JAX package takes it: no flash launch, one dense route), 256 (the
    wide wgmma segmented flash forward and backward), 128 (wgmma) and
    12 (the kernels on q, k, v widened to 16), output and input gradient
    against ``flash_attn = 0``; the flash kernels at head widths 256 and
    192 (:func:`wide_head_kernels`); and the LRN backward in both
    layouts at windows of 33 and 64 channels (AlexNet's lrn1, C = 96),
    launches counted."""
    import torch
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers import sequence as tseq
    from cxxnet_tpu_torch.layers.base import ForwardContext, LabelInfo
    from cxxnet_tpu_torch.ops import flash_attention as fa
    from cxxnet_tpu_torch.ops import layernorm as ln
    from cxxnet_tpu_torch.ops import lrn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for rows, d, offset in ((4096, 2048, 0), (3, 100, 0), (33, 2048, 1),
                            (64, 20000, 0)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty((rows * d + offset,), dtype=dtype, device=dev)[
                offset:].view(rows, d)
            x.copy_(torch.randn((rows, d), generator=gen, device=dev) * 2
                    + 3)
            g = (torch.rand((d,), generator=gen, device=dev) + 0.5).to(dtype)
            b = torch.randn((d,), generator=gen, device=dev).to(dtype)
            got = ln.layernorm_fwd(x, g, b, LN_EPS)
            ref = ln.layernorm_fwd_plain(x, g, b, LN_EPS)
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            err = row_rel_err(got[0], ref[0]) if bf16 else rel_err(got[0],
                                                                   ref[0])
            serr = max(rel_err(got[1], ref[1]), rel_err(got[2], ref[2]))
            tol = BF16_ROW_TOL if bf16 else F32_TOL
            route = ln.kernel_route(d)
            if route != ("warp" if d <= ln.WARP_MAX_D else "block"):
                raise AssertionError(f"layernorm_fwd d {d}: route {route}")
            log(f"layernorm_fwd route {route} ({rows}, {d})"
                f"{' x off 16-byte alignment' if offset else ''} "
                f"{str(dtype).split('.')[1]}: error y {err:.3e} (tol "
                f"{tol:g}), mean / rstd {serr:.3e}")
            if not (err <= tol and serr <= F32_TOL):
                raise AssertionError(f"layernorm_fwd ({rows}, {d}) disagrees "
                                     f"with its plain version")
    for hd, want in ((264, "dense"), (256, "flash_seg"), (128, "flash_seg"),
                     (12, "flash_seg")):
        layer = tseq.AttentionLayer()
        for k, v in (("nhead", "2"), ("causal", "1"), ("segment_key", "seg")):
            layer.set_param(k, v)
        s_len, dim = 1024, 2 * hd
        params = layer.init_params(gen, [(2, 1, s_len, dim)],
                                   torch.bfloat16)
        x = (torch.randn((2, 1, s_len, dim), generator=gen, device=dev)
             ).to(torch.bfloat16).requires_grad_()
        seg = torch.zeros((2, s_len), device=dev)
        seg[0, :300], seg[0, 300:] = 1, 2
        seg[1, :1000] = 1
        opts = EngineOptions()
        ctx = ForwardContext(train=True, opts=opts,
                             labels=LabelInfo(fields={"seg": seg}))
        reset_launches()
        tseq.single_device_attention.dense_routes = 0
        [out] = layer.forward(params, [x], ctx)
        (gx,) = torch.autograd.grad(out.float().square().sum(), [x])
        torch.cuda.synchronize()
        counts = (tseq.single_device_attention.dense_routes,
                  fa.flash_attention_seg_fwd.launches,
                  fa.flash_attention_seg_bwd.launches)
        opts.set("flash_attn", "0")
        [ref] = layer.forward(params, [x], ctx)
        (gref,) = torch.autograd.grad(ref.float().square().sum(), [x])
        torch.cuda.synchronize()
        errs = (row_rel_err(out, ref), row_rel_err(gx, gref, GRAD_ROW_FLOOR))
        kernel = "none" if want == "dense" else fa.kernel_route(
            max(8, hd + (-hd) % 8), torch.bfloat16, backward=True)
        log(f"attention layer hd {hd} bf16 with a gradient: route {want} "
            f"(backward kernel {kernel}); "
            f"dense routes, segmented flash forward / backward launches "
            f"{counts}; errors against flash_attn = 0: out {errs[0]:.3e} "
            f"(tol {BF16_ROW_TOL:g}), dx {errs[1]:.3e} (tol "
            f"{BF16_GRAD_ROW_TOL:g})")
        expect = (1, 0, 0) if want == "dense" else (0, 1, 1)
        if counts != expect or not (errs[0] <= BF16_ROW_TOL
                                    and errs[1] <= BF16_GRAD_ROW_TOL):
            raise AssertionError(f"attention at hd {hd}: launches {counts} "
                                 f"(want {expect}), errors {errs}")
    wide_head_kernels(gen)
    shape = (256, 96, 27, 27)
    for nsize in (33, 64):
        x = (torch.randn(shape, generator=gen, device=dev) * 8).to(
            torch.bfloat16)
        gr = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        args = (nsize, 0.001, 0.75, 1.0)
        xt = x.permute(lrn.TO_HWCN).contiguous()
        gt = gr.permute(lrn.TO_HWCN).contiguous()
        reset_launches()
        (dx,) = _run_twice("lrn_bwd", lambda: (lrn.lrn_bwd(x, gr, *args),))
        (dxt,) = _run_twice("lrn_hwcn_bwd",
                            lambda: (lrn.lrn_hwcn_bwd(xt, gt, *args),))
        launched = (lrn.lrn_bwd.launches, lrn.lrn_hwcn_bwd.launches)
        errs = (row_rel_err(dx, lrn.lrn_bwd_plain(x, gr, *args)),
                row_rel_err(dxt, lrn.lrn_hwcn_bwd_plain(xt, gt, *args)))
        log(f"lrn_bwd / lrn_hwcn_bwd {shape} bf16 window {nsize}: launches "
            f"{launched}, errors {errs[0]:.3e} / {errs[1]:.3e} (tol "
            f"{BF16_ROW_TOL:g}); bitwise repeatable")
        if launched != (2, 2) or max(errs) > BF16_ROW_TOL:
            raise AssertionError(f"LRN backward at window {nsize}: "
                                 f"launches {launched}, errors {errs}")
    del x, gr, xt, gt, dx, dxt
    # the layernorm backward at each route: registers to BWD_REG_MAX_D,
    # the stream route past it (14520: just past the widest row whose
    # four float32 copies fit one block's shared memory)
    from cxxnet_tpu_torch.ops import pool
    rows = 37
    for d in (2048, ln.BWD_REG_MAX_D, 14520, 16384, 43648, ln.MAX_D):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            x = (torch.randn((rows, d), generator=gen, device=dev) * 2 + 3
                 ).to(dtype)
            g = (torch.rand((d,), generator=gen, device=dev) + 0.5).to(dtype)
            g[d // 3] = 0.0
            b = torch.randn((d,), generator=gen, device=dev).to(dtype)
            dy = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
            y, mean, rstd = ln.layernorm_fwd(x, g, b, LN_EPS)
            route = ln.bwd_route(d)
            if route != ("register" if d <= ln.BWD_REG_MAX_D else "stream"):
                raise AssertionError(f"layernorm_bwd d {d}: route {route}")
            for save_x in (False, True):
                a = x if save_x else y
                got = _run_twice("layernorm_bwd", lambda: ln.layernorm_bwd(
                    dy, a, g, b, mean, rstd, save_x))
                ref = ln.layernorm_bwd_plain(dy, a, g, b, mean, rstd, save_x)
                err = (row_rel_err(got[0], ref[0]) if bf16
                       else rel_err(got[0], ref[0]))
                verr = max(rel_err(got[1], ref[1]), rel_err(got[2], ref[2]))
                tol = BF16_ROW_TOL if bf16 else F32_TOL
                vtol = BF16_VEC_TOL if bf16 else F32_TOL
                log(f"layernorm_bwd route {route} ({rows}, {d}) "
                    f"{str(dtype).split('.')[1]}"
                    f"{' save_x' if save_x else ''}: error dx {err:.3e} (tol "
                    f"{tol:g}), dgamma / dbeta {verr:.3e} (tol {vtol:g}); "
                    "bitwise repeatable")
                if not (err <= tol and verr <= vtol):
                    raise AssertionError(f"layernorm_bwd ({rows}, {d}) "
                                         "disagrees with its plain version")
            del x, dy, y
    # the pool forward's and backward's routes at pool1's input: cells
    # (AlexNet's 3x3 stride 2 window, aligned tensors) and per-output /
    # gather (the same one element off 16-byte alignment; a 5x5 window at
    # stride 3, padded)
    for geom, offset, want in (((3, 3, 2, 0, 0), 0, "cells"),
                               ((3, 3, 2, 0, 0), 1, "gather"),
                               ((5, 5, 3, 1, 1), 0, "gather")):
        def at_offset(t):
            out = torch.empty((t.numel() + offset,), dtype=t.dtype,
                              device=dev)[offset:].view(t.shape)
            return out.copy_(t)
        x = at_offset((torch.round(torch.randn((256, 96, 55, 55),
                                               generator=gen, device=dev)
                                   * 6.0) / 4 - 0.5).to(torch.bfloat16))
        y = pool.max_pool_fwd(x, geom)
        fwd_route = pool.fwd_route(x, geom, offset == 0)
        if fwd_route != ("cells" if want == "cells" else "per-output"):
            raise AssertionError(f"max_pool_fwd {geom}: route {fwd_route}")
        if not torch.equal(y, pool.max_pool_fwd_plain(x, geom)):
            raise AssertionError(f"max_pool_fwd route {fwd_route} is not "
                                 "bitwise equal to its plain version")
        y = at_offset(y)
        dy = at_offset((torch.round(torch.randn(y.shape, generator=gen,
                                                device=dev) * 8) / 8
                        ).to(torch.bfloat16))
        route = pool.bwd_route(x, geom, offset == 0)
        if route != want:
            raise AssertionError(f"max_pool_bwd {geom}: route {route}")
        for relu in (False, True):
            (dx,) = _run_twice("max_pool_bwd", lambda: (
                pool.max_pool_bwd(x, y, dy, geom, relu),))
            if not torch.equal(dx, pool.max_pool_bwd_plain(x, y, dy, geom,
                                                           relu)):
                raise AssertionError(f"max_pool_bwd route {route} relu "
                                     f"{relu} is not bitwise equal to its "
                                     "plain version")
        log(f"max_pool_fwd route {fwd_route} / max_pool_bwd route {route} "
            f"(256, 96, 55, 55) window {geom} bf16"
            f"{', one element off 16-byte alignment' if offset else ''}: "
            "bitwise equal to the plain versions (the backward relu and "
            "not, bitwise repeatable)")
        del x, y, dy, dx
    torch.cuda.empty_cache()


def wide_head_kernels(gen) -> None:
    """Rows 7-10 at head widths 256 (the 256-column instances) and 192
    (the 192-column ones), bf16: the wide wgmma forward and backward,
    dense causal at (16, 4096, d) and segmented at the train_hd256 path's
    (32, 4096, d) on seeded documents, against their plain versions (the
    backward twice, bitwise equal), each timed beside sdpa's forward or
    backward on the same inputs."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda", 0)
    for d, tag, b, h in ((DIM // WIDE_NHEAD, "dense", 1, 16),
                         (DIM // WIDE_NHEAD, "seg", TRAIN_BATCH, WIDE_NHEAD),
                         (192, "dense", 1, 16),
                         (192, "seg", TRAIN_BATCH, WIDE_NHEAD)):
        routes = (fa.kernel_route(d, torch.bfloat16),
                  fa.kernel_route(d, torch.bfloat16, backward=True))
        if routes != ("wgmma", "wgmma"):
            raise AssertionError(f"flash at head width {d}: routes {routes}")
        s_len, bh = SEQ, b * h
        q, k, v, do = (torch.randn((bh, s_len, d), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        q4, k4, v4 = (t.view(b, h, s_len, d) for t in (q, k, v))
        if tag == "seg":
            seg_np = seeded_segments(np.random.RandomState(3), b, s_len, 512)
            seg = torch.from_numpy(seg_np).to(dev)
            pos = torch.arange(s_len, device=dev)
            mask = (((seg[:, :, None] == seg[:, None, :])
                     & (seg[:, :, None] != 0)
                     | (pos[:, None] == pos[None, :]))
                    & (pos[:, None] >= pos[None, :]))[:, None]
            pairs = live_pairs(seg_np, h)
            fwd = lambda: fa.flash_attention_seg_fwd(q, k, v, seg)
            fwd_plain = lambda: fa.flash_attention_seg_fwd_plain(q, k, v,
                                                                 seg)
            bwd = lambda: fa.flash_attention_seg_bwd(q, k, v, seg, o, lse,
                                                     do)
            bwd_plain = lambda: fa.flash_attention_seg_bwd_plain(
                q, k, v, seg, o, lse, do)
            extra = 4 * b * s_len
        else:
            mask = None
            pairs = bh * s_len * (s_len + 1) // 2
            fwd = lambda: fa.flash_attention_fwd(q, k, v, True)
            fwd_plain = lambda: fa.flash_attention_fwd_plain(q, k, v, True)
            bwd = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True)
            bwd_plain = lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse,
                                                             do, True)
            extra = 0
        (o, lse), ref = fwd(), fwd_plain()
        torch.cuda.synchronize()
        ferr = (row_rel_err(o, ref[0]), rel_err(lse, ref[1]))
        del ref
        got = _run_twice(f"flash {tag} backward hd {d}", bwd)
        errs, tol, abs_err = _errors(got, bwd_plain(), True,
                                     BF16_GRAD_ROW_TOL, GRAD_ROW_FLOOR)
        del got
        sdpa_fwd = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, is_causal=mask is None)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                            is_causal=mask is None)
        sdpa_bwd = lambda: torch.autograd.grad(
            og, (qg, kg, vg), do.view(b, h, s_len, d), retain_graph=True)
        t_fwd = timings(fwd, None, sdpa_fwd, 10)
        t_bwd = timings(bwd, None, sdpa_bwd, 5)
        fbnd = bound(4.0 * d * pairs, 4 * bh * s_len * d * 2 + 4 * bh * s_len
                     + extra, "bfloat16")
        bbnd = bound(10.0 * d * pairs, 8 * bh * s_len * d * 2
                     + 4 * bh * s_len + extra, "bfloat16")
        log(f"flash {tag} ({bh}, {s_len}, {d}) causal bf16: forward "
            f"({routes[0]}) {times_note(t_fwd)} (sdpa), bound "
            f"{fbnd['bound_ms']:.4f} ms "
            f"({rate(4.0 * d * pairs, t_fwd['ms'], fbnd['bound_ms'])}), "
            f"errors o {ferr[0]:.3e} (tol {BF16_ROW_TOL:g}) lse "
            f"{ferr[1]:.3e} (tol {F32_TOL:g}); backward ({routes[1]}) "
            f"{times_note(t_bwd)} (sdpa "
            f"backward), bound {bbnd['bound_ms']:.4f} ms ("
            f"{rate(10.0 * d * pairs, t_bwd['ms'], bbnd['bound_ms'])}), "
            f"errors {', '.join(f'{e:.3e}' for e in errs)} (tol {tol:g}); "
            f"abs err {abs_err:.3e}; bitwise repeatable")
        if not (ferr[0] <= BF16_ROW_TOL and ferr[1] <= F32_TOL
                and max(errs) <= tol):
            raise AssertionError(f"flash {tag} at head width {d} disagrees "
                                 f"with its plain version: {ferr}, {errs}")
        del q, k, v, do, o, lse, q4, k4, v4, qg, kg, vg, og, mask
        torch.cuda.empty_cache()


def bf16_within_step(p, p_ref, w, w_ref) -> bool:
    """Each bf16 param within one bf16 step (2^-7 of its magnitude) of the
    plain one, plus the masters' difference (both are roundings of
    masters a few float32 ulps apart, which decides a param near 0)."""
    import torch
    p, p_ref = p.float(), p_ref.float()
    tol = torch.maximum(p.abs(), p_ref.abs()) * 2.0 ** -7 + (w - w_ref).abs()
    return bool((((p - p_ref).abs() <= tol) | (p.isnan() & p_ref.isnan()))
                .all())


def phase_last_kernels():
    """Rows 13, 2 and 6 against their plain versions at their main paths'
    shapes.  The fused adam at the LM's largest tensor (2048 x 8192, bf16
    param, float32 state), three chained steps with wd = 0, clip = 0 (the
    train_fused path's hyper-parameters) and with wd, clip > 0 and planted
    NaNs: m1, m2 and the master within ADAM_RTOL / ADAM_ATOL, the param
    the rounding of the kernel's own master and within one bf16 step of
    the plain one.  The (H, W, C, N) LRN forward and backward at AlexNet's
    lrn1 (27, 27, 96, 256) and lrn2 (13, 13, 256, 256), and the
    space-to-depth wgrad at conv1 and MNIST_CONV's conv1, bf16 and
    float32 (the wgrad also against row 5's kernel).  Every backward and
    the LRN forward run twice, bitwise equal.  Times at the LM tensor,
    lrn1, lrn2 and conv1, with the (H, W, C, N) permutes and the s2d
    rearrangement timed apart; returns the numbers of the timed runs
    (bf16)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight
    from cxxnet_tpu_torch.ops import conv_wgrad as cw
    from cxxnet_tpu_torch.ops import fused_adam as fu
    from cxxnet_tpu_torch.ops import lrn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    out = {}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    # row 13: fused adam
    shape = (DIM, VOCAB)
    n = DIM * VOCAB
    for wd, clip in ((0.0, 0.0), (5e-4, 1.0)):
        w = randn(shape, torch.float32, 0.02)
        state = [w.to(torch.bfloat16), torch.zeros_like(w),
                 torch.zeros_like(w), w.clone()]
        ref = [t.clone() for t in state]
        err = 0.0
        for step in range(3):
            g = randn(shape, torch.bfloat16, 1e-3)
            if clip:
                g.view(-1)[:4] = torch.tensor(
                    [float("nan"), 5.0, -5.0, float("nan")], device=dev,
                    dtype=torch.bfloat16)
            args = (1e-3 * (step + 1), 0.1, 0.001, wd, clip)
            fu.fused_adam_pallas(g, *state[1:], args[0], d1=args[1],
                                 d2=args[2], wd=wd, clip=clip, out=state[0])
            ref = list(fu.fused_adam_plain(g, *ref[1:], *args))
            torch.cuda.synchronize()
            for name, got, want in zip(("m1", "m2", "w32"), state[1:],
                                       ref[1:]):
                bad = ~torch.isclose(got, want, rtol=ADAM_RTOL,
                                     atol=ADAM_ATOL)
                if bad.any() or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"fused_adam wd {wd} clip {clip} step {step}: {name}"
                        f" off its plain version at {int(bad.sum())} places")
            if not torch.equal(state[0], state[3].to(torch.bfloat16)):
                raise AssertionError("fused_adam: the bf16 param is not the "
                                     "rounding of its master")
            if not bf16_within_step(state[0], ref[0], state[3], ref[3]):
                raise AssertionError(f"fused_adam wd {wd} clip {clip}: the "
                                     "param is off by more than a bf16 step")
            err = max(err, float((state[3] - ref[3]).abs().max()))
            differ = sum(int(((a != b) & ~(a.isnan() & b.isnan())).sum())
                         for a, b in zip(state, ref))
        note = ""
        times = None
        if not wd:
            g = randn(shape, torch.bfloat16, 1e-3)
            run = lambda: fu.fused_adam_pallas(g, *state[1:], 1e-3, d1=0.1,
                                               d2=0.001, out=state[0])
            plain = lambda: fu.fused_adam_plain(g, *state[1:], 1e-3, 0.1,
                                                0.001)
            times = timings(run, plain)
            bnd = bound(15.0 * n, 28.0 * n, "float32")
            out["fused_adam"] = dict(max_abs_err=err, **times, **bnd)
            note = (f"; {times_note(times)}, bound {bnd['bound_ms']:.4f} ms "
                    f"({bnd['bound_by']})")
        log(f"fused_adam {shape} wd {wd} clip {clip}, 3 steps: m1 / m2 / "
            f"master within rtol {ADAM_RTOL:g} atol {ADAM_ATOL:g}, param "
            f"within a bf16 step; master abs err {err:.3e}; {differ} of "
            f"{4 * n} outputs of the last step not bitwise equal to the "
            f"plain version's{note}")
        del w, state, ref, g
    torch.cuda.empty_cache()
    lrn_args = (5, 0.001, 0.75, 1.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        isz = 2 if bf16 else 4
        tol = BF16_ROW_TOL if bf16 else F32_TOL
        # row 2: the (H, W, C, N) LRN, rows along N
        for nchw in ((256, 96, 27, 27), (256, 256, 13, 13)):
            x = randn(nchw, dtype, 8.0)
            xt = x.permute(lrn.TO_HWCN).contiguous()
            gt = randn(xt.shape, dtype)
            timed = bf16 and nchw[1] == 96
            fwd = lambda: lrn.lrn_hwcn_fwd(xt, *lrn_args)
            plain = lambda: lrn.lrn_hwcn_fwd_plain(xt, *lrn_args)
            (got,) = _run_twice("lrn_hwcn_fwd", lambda: (fwd(),))
            ref = plain()
            (dx,) = _run_twice("lrn_hwcn_bwd",
                               lambda: (lrn.lrn_hwcn_bwd(xt, gt, *lrn_args),))
            dref = lrn.lrn_hwcn_bwd_plain(xt, gt, *lrn_args)
            torch.cuda.synchronize()
            view = (xt.shape[0] * xt.shape[1], xt.shape[2], xt.shape[3], 5,
                    isz)
            plan, fplan = lrn.bwd_plan(*view), lrn.fwd_plan(*view)
            for p in (plan, fplan):
                if p.route != "window" or p.vec != 16 // isz:
                    raise AssertionError(f"lrn_hwcn {tuple(xt.shape)}: plan "
                                         f"{p}")
            errs = [row_rel_err(a, b) if bf16 else rel_err(a, b)
                    for a, b in ((got, ref), (dx, dref))]
            abs_errs = [float((a.float() - b.float()).abs().max())
                        for a, b in ((got, ref), (dx, dref))]
            note = (f"; fwd / bwd route {fplan.route} / {plan.route} "
                    f"({plan.vec} images a thread, chunks of {fplan.chunk} / "
                    f"{plan.chunk} channels); fwd and bwd bitwise repeatable")
            if bf16 and not timed:
                # lrn2, its own names
                g = gt.permute(lrn.FROM_HWCN)
                xx = x.detach().requires_grad_()
                yy = F.local_response_norm(xx, 5, 0.001, 0.75, 1.0)
                t_fwd = timings(fwd, plain, lambda: F.local_response_norm(
                    x, 5, 0.001, 0.75, 1.0))
                t_bwd = timings(lambda: lrn.lrn_hwcn_bwd(xt, gt, *lrn_args),
                                lambda: lrn.lrn_hwcn_bwd_plain(
                                    xt, gt, *lrn_args),
                                lambda: torch.autograd.grad(
                                    yy, xx, g, retain_graph=True))
                for kname, t, flops, nbytes, e in (
                        ("lrn_hwcn_fwd lrn2", t_fwd, 14.0, 2, abs_errs[0]),
                        ("lrn_hwcn_bwd lrn2", t_bwd, 30.0, 3, abs_errs[1])):
                    out[kname] = dict(max_abs_err=e, **t,
                                      **bound(flops * x.numel(),
                                              nbytes * x.numel() * isz,
                                              "float32"))
                note += (f"; fwd {times_note(t_fwd)}, bound "
                         f"{out['lrn_hwcn_fwd lrn2']['bound_ms']:.4f} ms; bwd "
                         f"{times_note(t_bwd)}, bound "
                         f"{out['lrn_hwcn_bwd lrn2']['bound_ms']:.4f} ms")
                del xx, yy
            if timed:
                numel = x.numel()
                g = gt.permute(lrn.FROM_HWCN)
                xx = x.detach().requires_grad_()
                yy = F.local_response_norm(xx, 5, 0.001, 0.75, 1.0)
                bwd = lambda: lrn.lrn_hwcn_bwd(xt, gt, *lrn_args)
                t_fwd = timings(fwd, plain, lambda: F.local_response_norm(
                    x, 5, 0.001, 0.75, 1.0))
                t_bwd = timings(bwd, lambda: lrn.lrn_hwcn_bwd_plain(
                    xt, gt, *lrn_args), lambda: torch.autograd.grad(
                        yy, xx, g, retain_graph=True))
                t_perm = time_ms(lambda: x.permute(lrn.TO_HWCN).contiguous(),
                                 reps=20)
                for kname, t, flops, nbytes, e in (
                        ("lrn_hwcn_fwd", t_fwd, 14.0, 2, abs_errs[0]),
                        ("lrn_hwcn_bwd", t_bwd, 30.0, 3, abs_errs[1])):
                    out[kname] = dict(max_abs_err=e, **t,
                                      **bound(flops * numel,
                                              nbytes * numel * isz,
                                              "float32"))
                note += (f"; fwd {times_note(t_fwd)}, bound "
                        f"{out['lrn_hwcn_fwd']['bound_ms']:.4f} ms; "
                        f"bwd {times_note(t_bwd)}, bound "
                        f"{out['lrn_hwcn_bwd']['bound_ms']:.4f} ms; one "
                        f"NCHW <-> (H, W, C, N) permute {t_perm:.4f} ms "
                        "(the path makes 2 a forward, 3 a backward)")
            log(f"lrn_hwcn {tuple(xt.shape)} {name}: errors fwd {errs[0]:.3e}"
                f", bwd {errs[1]:.3e} (tol {tol:g}); abs err "
                f"{max(abs_errs):.3e}{note}")
            if not max(errs) <= tol:
                raise AssertionError(f"lrn_hwcn {name} {tuple(xt.shape)} "
                                     f"disagrees with its plain version: "
                                     f"{errs}")
            del x, xt, gt, got, ref, dx, dref
        torch.cuda.empty_cache()
        # row 6: the space-to-depth wgrad, also against row 5's kernel
        for xshape, co, k, st, pad in (((256, 3, 227, 227), 96, 11, 4, 0),
                                       ((100, 1, 28, 28), 32, 3, 2, 1)):
            x = torch.rand(xshape, generator=gen, device=dev).to(dtype)
            oh = (xshape[2] + 2 * pad - k) // st + 1
            dy = randn((xshape[0], co, oh, oh), dtype)
            args = (k, k, st, pad, pad)
            run = lambda: cw.conv_wgrad_s2d_pallas(x, dy, *args)
            got = _run_twice("conv_wgrad_s2d", run)
            refs = (cw.conv_wgrad_s2d_plain(x, dy, *args),
                    cw.conv_wgrad_hwcn_pallas(x, dy, *args))
            errs = [max(rel_err(got[0], r[0]), rel_err(got[1], r[1]))
                    for r in refs]
            abs_err = max(float((a - b).abs().max())
                          for a, b in zip(got, refs[0]))
            note = ""
            same = all(torch.equal(a, b) for a, b in zip(got, refs[1]))
            if bf16 and xshape[1] == 3:
                wshape = (co, xshape[1], k, k)
                times = timings(
                    run, lambda: cw.conv_wgrad_s2d_plain(x, dy, *args),
                    lambda: (conv2d_weight(x, wshape, dy, stride=st),
                             dy.sum((0, 2, 3))), reps=10)
                positions = xshape[0] * oh * oh
                taps = xshape[1] * k * k
                bnd = bound(2.0 * positions * co * taps + positions * co,
                            (x.numel() + dy.numel()) * isz
                            + (co * taps + co) * 4, name)
                out["conv_wgrad_s2d"] = dict(max_abs_err=abs_err, **times,
                                             **bnd)
                note = (f"; {times_note(times)}, bound "
                        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            log(f"conv_wgrad_s2d {(xshape, co, k, st, pad)} {name} (route "
                f"{cw.kernel_route(xshape[1], co, oh, k, k, st, dtype)}): "
                f"error {errs[0]:.3e} vs its plain version; "
                f"{'bitwise equal to' if same else 'DIFFERS from'} row 5's "
                f"kernel on the same x (tol {WGRAD_TOL:g}); abs err "
                f"{abs_err:.3e}; bitwise repeatable{note}")
            if not (max(errs) <= WGRAD_TOL and same):
                raise AssertionError(f"conv_wgrad_s2d {name} {xshape} "
                                     f"disagrees: {errs}, same as row 5: "
                                     f"{same}")
            del x, dy, got, refs
        torch.cuda.empty_cache()
    return out


def write_inputs(tmp: str) -> str:
    """A seeded flagship ``.model``, a shard of N_PROMPTS prompt
    documents of seeded lengths (and the same prompts in
    ``prompts.npz``) and the serve conf (one request per document);
    returns the conf path."""
    import torch
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    net = transformer(vocab=VOCAB, seq=SEQ, dim=DIM, nlayer=NLAYER,
                      nhead=NHEAD)
    t0 = time.perf_counter()
    tr = NetTrainer()
    for k, v in parse_config_string(net):
        tr.set_param(k, v)
    for k, v in (("batch_size", str(SLOTS)), ("dtype", "bfloat16"),
                 ("dev", DEV), ("seed", "7"), ("silent", "1")):
        tr.set_param(k, v)
    tr.init_model()
    nparam = sum(t.numel() for g in tr.params.values() for t in g.values())
    model = os.path.join(tmp, "lm.model")
    tr.save_model(model)
    del tr
    torch.cuda.empty_cache()
    log(f"model: {nparam / 1e9:.3f} B parameters (bf16), seeded init + save "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(11)
    lens = rng.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_PROMPTS)
    log(f"prompt lengths: {lens.tolist()}")
    prompts = [rng.randint(0, VOCAB, n) for n in lens]
    np.savez(os.path.join(tmp, "prompts.npz"), *prompts)
    write_token_shard(os.path.join(tmp, "prompts.tok"), prompts, itemsize=2)
    conf = os.path.join(tmp, "serve.conf")
    with open(conf, "w") as f:
        f.write(f"""dev = {DEV}
task = serve
model_in = {model}
pred = {tmp}/gen_out.txt
iter = text
  path_tok = {tmp}/prompts.tok
iter = packseq
  seqlen = {PROMPT_LENS[1]}
  pack_split = 0
iter = end
{net}
batch_size = 1
dtype = bfloat16
serve_gen = 1
decode_slots = {SLOTS}
decode_max_seqlen = {SEQ}
serve_gen_tokens = {GEN_TOKENS}
serve_gen_prompt = {PROMPT_LENS[1]}
serve_gen_prompt_doc = 1
serve_gen_sample = greedy
serve_gen_batching = continuous
serve_clients = {CLIENTS}
metrics_sink = jsonl:{tmp}/serve_metrics.jsonl
""")
    return conf


def phase_serve(tmp: str):
    """MAIN_REPS runs of the serve CLI over the same conf; the launch
    counters are zeroed before the first and read after the last."""
    from cxxnet_tpu_torch.main import LearnTask
    conf = write_inputs(tmp)
    prefills = steps = 0
    reset_launches()
    for rep in range(MAIN_REPS):
        task = LearnTask()
        t0 = time.perf_counter()
        rc = task.run([conf])
        wall = time.perf_counter() - t0
        st = task.last_serve
        if rc != 0 or st is None:
            raise AssertionError(f"serve CLI returned {rc}")
        prefills += st["prefill_calls"]
        steps += st["step_calls"]
        log(f"main path run {rep + 1}/{MAIN_REPS}: {st['requests']} "
            f"requests, {st['tokens']} tokens in {st['duration_sec']:.3f} s"
            f" = {st['tokens_per_sec']:.1f} tok/s; prefill p50 "
            f"{st['prefill_p50_ms']:.2f} ms, step p50 {st['tok_p50_ms']:.2f}"
            f" ms, mean occupancy {st['mean_occupancy']}; CLI wall "
            f"{wall:.1f} s")
        if st["requests"] != N_PROMPTS:
            raise AssertionError(f"{st['requests']} requests for "
                                 f"{N_PROMPTS} prompts")
        lines = open(os.path.join(tmp, "gen_out.txt")).read().splitlines()
        if len(lines) != N_PROMPTS:
            raise AssertionError(f"{len(lines)} generations for "
                                 f"{N_PROMPTS} prompts")
        for ln_ in lines:
            toks = [int(t) for t in ln_.split()]
            if len(toks) != GEN_TOKENS or not all(0 <= t < VOCAB
                                                  for t in toks):
                raise AssertionError(f"bad generation row: {ln_[:80]}")
    launches = read_launches()
    log(f"serve path launches: {launches} for {prefills} prefills and "
        f"{steps} steps (plus one warmup prefill and step per run)")
    if launches["flash_attention_fwd"] < NLAYER * prefills or prefills < 1:
        raise AssertionError("prefills did not all run the flash kernel")
    if launches["layernorm_fwd"] < (2 * NLAYER + 1) * (prefills + steps):
        raise AssertionError("forwards did not all run the layernorm kernel")
    return task, launches, conf


def phase_consistency(task):
    """Prefill + 8 greedy step logits vs the cache-free full forward,
    kernel path and plain path."""
    import torch
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    tr = task.net
    eng = DecodeEngine(tr, slots=SLOTS)
    prompt = np.random.RandomState(5).randint(0, VOCAB, 200).astype(np.int32)
    seq = list(prompt)
    rows = [eng.prefill(2, prompt)]
    for _ in range(8):
        seq.append(int(np.argmax(rows[-1])))
        tokens = np.zeros((SLOTS,), np.int32)
        positions = np.zeros((SLOTS,), np.int32)
        tokens[2], positions[2] = seq[-1], len(seq) - 1
        rows.append(eng.step(tokens, positions)[2])
    got = torch.from_numpy(np.stack(rows))
    idx = np.arange(len(prompt) - 1, len(seq))
    full = torch.from_numpy(eng.full_logits(np.asarray(seq))[idx])
    tr.opts.set("flash_attn", "0")
    tr.opts.set("pallas_ln", "0")
    plain = torch.from_numpy(eng.full_logits(np.asarray(seq))[idx])
    tr.opts.set("flash_attn", "1")
    tr.opts.set("pallas_ln", "1")
    e1, e2 = rel_err(got, full), rel_err(got, plain)
    e3 = rel_err(full, plain)
    log(f"consistency (bf16, tol {SERVE_TOL_BF16}): engine vs full forward "
        f"{e1:.3e}, engine vs plain path {e2:.3e}, kernel vs plain full "
        f"forward {e3:.3e}")
    if max(e1, e2, e3) > SERVE_TOL_BF16 or not torch.isfinite(got).all():
        raise AssertionError("decode logits leave the bf16 envelope")


def phrase_docs(rng, n_tokens: int, lens) -> list:
    """Seeded documents of lengths in ``lens`` totalling at least
    ``n_tokens``, each a run of phrases drawn from 16 fixed phrases of
    8..32 token ids: within a phrase every next token is determined, so a
    model can learn the corpus in a few steps."""
    phrases = [rng.randint(0, VOCAB, rng.randint(8, 33)) for _ in range(16)]
    docs, total = [], 0
    while total < n_tokens:
        n = rng.randint(lens[0], lens[1] + 1)
        parts, have = [], 0
        while have < n:
            parts.append(phrases[rng.randint(len(phrases))])
            have += parts[-1].size
        docs.append(np.concatenate(parts)[:n])
        total += n
    return docs


def lm_train_conf(tmp: str, label: str, packed: bool, nlayer: int,
                  nhead: int, steps: int, fused: bool) -> str:
    """The port's ``task = train`` conf of the LM at width DIM, depth
    ``nlayer`` (packed: documents of seeded lengths, segment ids,
    per-document positions; else one long document) over a seeded,
    learnable corpus of ``steps`` batches, adam (fused under ``fused``),
    one round, a ``step`` record a step; returns its path."""
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.models import transformer
    n_tok = steps * TRAIN_BATCH * SEQ + 1
    rng = np.random.RandomState(17 if packed else 19)
    docs = phrase_docs(rng, n_tok, DOC_LENS if packed else (n_tok, n_tok))
    shard = os.path.join(tmp, f"{label}.tok")
    write_token_shard(shard, docs, itemsize=2)
    net = transformer(vocab=VOCAB, seq=SEQ, dim=DIM, nlayer=nlayer,
                      nhead=nhead, packed=packed)
    conf = os.path.join(tmp, f"{label}.conf")
    with open(conf, "w") as f:
        f.write(f"""dev = {DEV}
task = train
model_dir = {tmp}/models
save_model = 0
data = train
iter = text
  path_tok = {shard}
iter = packseq
  seqlen = {SEQ}
iter = end
{net}
batch_size = {TRAIN_BATCH}
dtype = bfloat16
updater = adam
eta = {TRAIN_ETA}
flash_attn = 1
pallas_ln = 1
fused_update = {int(fused)}
num_round = 1
print_step = 1
eval_train = 0
seed = 7
silent = 1
metrics_sink = jsonl:{tmp}/{label}_metrics.jsonl
""")
    log(f"{label}: {len(docs)} documents, {sum(d.size for d in docs)} "
        f"tokens; d{DIM} / {nlayer} layers / {nhead} heads of "
        f"{DIM // nhead} / s{SEQ} / "
        f"vocab {VOCAB} / bf16 / adam eta {TRAIN_ETA} / batch "
        f"{TRAIN_BATCH}{' / packed' if packed else ''}")
    return conf


def phase_train(tmp: str, packed: bool, profile: bool = False,
                fused_vs: list = None, wide: bool = False) -> tuple:
    """``task = train`` through the port's CLI: the packed flagship at
    full depth (documents of seeded lengths, segment ids, per-document
    positions, masked boundary targets), or the unpacked one at depth
    UNPACKED_LAYERS (one long document, no segment ids); ``wide``: the
    packed one with WIDE_NHEAD heads of 256 columns at depth WIDE_LAYERS
    for WIDE_STEPS steps (the head-width-256 LM).  ``fused_vs``
    (the packed path's losses) runs the packed path again under
    ``fused_update = 1`` and holds its losses to those; it then times the
    update of every parameter fused and unfused on the trained state.
    Returns the path's launch counts and losses.  ``profile`` traces the
    whole run with ``torch.profiler`` and prints where its device time
    goes."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.ops.fused_adam import fused_adam_supported
    fused = fused_vs is not None
    label = ("train_fused" if fused else "train") if packed \
        else "train_unpacked"
    nlayer = NLAYER if packed else UNPACKED_LAYERS
    steps = TRAIN_STEPS if packed else UNPACKED_STEPS
    nhead = NHEAD
    if wide:
        label, nlayer, steps, nhead = ("train_hd256", WIDE_LAYERS,
                                       WIDE_STEPS, WIDE_NHEAD)
    conf = lm_train_conf(tmp, label, packed, nlayer, nhead, steps, fused)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    task = LearnTask()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    try:
        rc = task.run([conf] + PREFETCH_ARGS)
    finally:
        if prof is not None:
            prof.stop()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = task.last_train
    if prof is not None and st is not None:
        report_profile(prof.events(), st["step_ms"])
    if rc != 0 or st is None or st["steps"] != steps:
        raise AssertionError(f"{label}: CLI returned {rc} after "
                             f"{None if st is None else st['steps']} steps")
    losses = st["losses"]
    log(f"{label}: {steps} steps, losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in st['step_ms']]}, p50 "
        f"{st['step_p50_ms']:.1f} ms (steps after the first) = "
        f"{st['tokens_per_sec']:.0f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; CLI wall "
        f"{wall:.1f} s")
    log(f"{label} path launches: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    per_step = {k: v / steps for k, v in launches.items()}
    if packed:
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: loss did not fall: {losses}")
        want = {"flash_attention_seg_fwd": nlayer,
                "flash_attention_seg_bwd": nlayer,
                "layernorm_fwd": 2 * nlayer + 1,
                "layernorm_bwd": 2 * nlayer + 1}
        tr = task.net
        admitted = sum(fused_adam_supported(p) for g in tr.params.values()
                       for p in g.values())
        ntensor = sum(len(g) for g in tr.params.values())
        if launches["fused_adam"] != (admitted * steps if fused else 0):
            raise AssertionError(
                f"{label}: {launches['fused_adam']} fused adam launches for "
                f"{admitted} admitted tensors (of {ntensor}) x {steps} steps")
        if fused:
            diffs = [abs(a - b) / abs(b) for a, b in zip(losses, fused_vs)]
            log(f"{label}: {admitted} of {ntensor} tensors "
                f"({sum(p.numel() for g in tr.params.values() for p in g.values() if fused_adam_supported(p)) / 1e9:.3f} B "
                f"parameters) fused; losses against train's: first "
                f"{'bitwise equal' if losses[0] == fused_vs[0] else 'DIFFER'}"
                f", relative differences {[f'{d:.2e}' for d in diffs]}")
            if losses[0] != fused_vs[0] or max(diffs) > FUSED_LOSS_TOL:
                raise AssertionError(f"{label}: losses {losses} leave train's"
                                     f" {fused_vs} (tol {FUSED_LOSS_TOL})")
            time_update(tr)
    else:
        want = {"flash_attention_fwd": nlayer, "flash_attention_bwd": nlayer,
                "layernorm_fwd": 2 * nlayer + 1,
                "layernorm_bwd": 2 * nlayer + 1}
    short = {k: per_step[k] for k, n in want.items() if per_step[k] < n}
    if wide:
        from cxxnet_tpu_torch.ops import flash_attention as fa
        hd = DIM // nhead
        routes = (fa.kernel_route(hd, torch.bfloat16),
                  fa.kernel_route(hd, torch.bfloat16, backward=True))
        log(f"{label}: flash forward / backward route at head width {hd} "
            f"bf16: {routes}")
        if routes != ("wgmma", "wgmma"):
            raise AssertionError(f"{label}: flash routes {routes} at head "
                                 f"width {hd}")
    if short:
        raise AssertionError(f"{label}: launches per step {short} below "
                             f"{want}: a layer did not run its kernel")
    del task
    torch.cuda.empty_cache()
    return launches, losses


def time_update(tr) -> None:
    """The ``train_update`` work of one step (the updater on every
    parameter) on a trained LM's state, with seeded bf16 gradients, under
    ``fused_update = 1`` and ``0`` alike: CUDA-event medians, in one
    process, one after the other."""
    import torch
    gen = torch.Generator(device=tr.device)
    gen.manual_seed(9)
    grads = {k: {t: (torch.randn(p.shape, generator=gen, device=tr.device)
                     * 1e-3).to(p.dtype) for t, p in g.items()}
             for k, g in tr.params.items()}
    times = {}
    for mode in ("1", "0", "1"):
        tr.opts.set("fused_update", mode)
        times.setdefault(mode, []).append(time_ms(
            lambda: tr.apply_update(grads, tr.epoch_counter), reps=5))
    log(f"train_update (every parameter, one step): fused "
        f"{' / '.join(f'{t:.2f}' for t in times['1'])} ms, unfused "
        f"{times['0'][0]:.2f} ms")
    del grads
    torch.cuda.empty_cache()


def phase_alexnet(tmp: str, profile: bool = False, hwcn: bool = False
                  ) -> dict:
    """``task = train`` of example/ImageNet/ImageNet.conf through the
    port's CLI with ALEXNET_ARGS: AlexNet at batch 256 in bf16 on
    seeded synthetic batches held on the card, 3 rounds of 10 steps
    (``hwcn``: ALEXNET_HWCN_ARGS).  Every loss must be finite
    and every step must launch the CNN kernels ALEXNET_PER_STEP
    (ALEXNET_HWCN_PER_STEP) times and no other (one of the three pool
    backwards relu-masked: pool1's, whose conv keeps its bias for the
    fused wgrad).  Prints the step p50 and images/s; returns the path's
    launch counts."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    label = "alexnet_hwcn" if hwcn else "alexnet"
    nsteps = ALEXNET_HWCN_STEPS if hwcn else ALEXNET_STEPS
    per_step = ALEXNET_HWCN_PER_STEP if hwcn else ALEXNET_PER_STEP
    conf = os.path.join(REPO, "example", "ImageNet", "ImageNet.conf")
    args = list(ALEXNET_HWCN_ARGS if hwcn else ALEXNET_ARGS) + [
        f"model_dir={tmp}/{label}", "silent=1"]
    log(f"{label}: ImageNet.conf {' '.join(args)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    task = LearnTask()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    try:
        rc = task.run([conf] + args)
    finally:
        if prof is not None:
            prof.stop()
    wall = time.perf_counter() - t0
    launches = read_launches()
    relu = kernel_fn("max_pool_bwd").relu_launches
    st = task.last_train
    if prof is not None and st is not None:
        report_profile(prof.events(), st["step_ms"])
    if rc != 0 or st is None or st["steps"] != nsteps:
        raise AssertionError(f"{label}: CLI returned {rc} after "
                             f"{None if st is None else st['steps']} steps")
    losses = st["losses"]
    log(f"{label}: {nsteps} steps, losses {losses[0]:.4f} .. "
        f"{losses[-1]:.4f} (min {min(losses):.4f}, max {max(losses):.4f});"
        f" step p50 {st['step_p50_ms']:.2f} ms (steps after the first) = "
        f"{st['examples_per_sec']:.1f} images/s; first step "
        f"{st['step_ms'][0]:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; CLI wall "
        f"{wall:.1f} s")
    log(f"{label} path launches: {launches}, relu-masked pool backward "
        f"{relu}")
    MEASURED[label] = st
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    want = {n: per_step.get(n, 0) * nsteps for n in KERNELS}
    if launches != want or relu != nsteps:
        raise AssertionError(f"{label}: launches {launches} (relu-masked "
                             f"{relu}), expected {want} ({nsteps} "
                             "relu-masked)")
    if not hwcn:
        snap = os.path.join(tmp, "alexnet", "0003.model")
        log(f"alexnet: snapshot {os.path.getsize(snap) / 2 ** 20:.1f} MiB")
    del task
    torch.cuda.empty_cache()
    return launches


def write_jpeg_pack(tmp: str, name: str, n: int, seed: int):
    """A seeded pack of ``n`` JPEGs of 3 x DATA_SIDE x DATA_SIDE (smooth
    random images with a little noise, cv2 at quality 90) written by the
    port's BinaryPageWriter, and its list (labels in [0, 1000)); returns
    (pack, list, JPEG bytes)."""
    import cv2
    from cxxnet_tpu_torch.io.imbin import BinaryPageWriter
    rng = np.random.RandomState(seed)
    pack, lst = (os.path.join(tmp, f"{name}.{ext}") for ext in ("bin", "lst"))
    w = BinaryPageWriter(pack)
    nbytes = 0
    with open(lst, "w") as f:
        for i in range(n):
            small = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
            img = cv2.resize(small, (DATA_SIDE, DATA_SIDE),
                             interpolation=cv2.INTER_LINEAR)
            img = cv2.add(img, rng.randint(0, 16, img.shape).astype(np.uint8))
            ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
            assert ok, "cv2.imencode failed"
            w.push(enc.tobytes())
            nbytes += enc.size
            f.write(f"{i}\t{rng.randint(0, 1000)}\timg{i}.jpg\n")
    w.close()
    return pack, lst, nbytes


def alexnet_data_conf(tmp: str) -> str:
    """example/ImageNet/ImageNet.conf with its data sections pointed at
    seeded JPEG packs (made once) and its mean image in ``tmp``, the train
    pack shuffled; returns the conf's path."""
    conf = os.path.join(tmp, "alexnet_data.conf")
    if os.path.exists(conf):
        return conf
    t0 = time.perf_counter()
    train_bin, train_lst, nb = write_jpeg_pack(tmp, "train", DATA_IMAGES, 21)
    test_bin, test_lst, nb_test = write_jpeg_pack(tmp, "test",
                                                  DATA_EVAL_IMAGES, 22)
    log(f"alexnet_data: {DATA_IMAGES} + {DATA_EVAL_IMAGES} JPEGs of 3 x "
        f"{DATA_SIDE} x {DATA_SIDE}, {nb / 1e6:.1f} + {nb_test / 1e6:.1f} MB,"
        f" packed in {time.perf_counter() - t0:.1f} s")
    text = open(os.path.join(REPO, "example", "ImageNet",
                             "ImageNet.conf")).read()
    for a, b in (('"./NameList.train"', train_lst),
                 ('"./TRAIN.BIN"', train_bin),
                 ('"./NameList.test"', test_lst), ('"./TEST.BIN"', test_bin),
                 ('"models/image_net_mean.npz"',
                  os.path.join(tmp, "image_net_mean.npz")),
                 ("  rand_mirror = 1\n", "  rand_mirror = 1\n  shuffle = 1\n")):
        assert a in text, f"ImageNet.conf lacks {a!r}"
        text = text.replace(a, b)
    with open(conf, "w") as f:
        f.write(text)
    return conf


def phase_alexnet_data(tmp: str) -> dict:
    """Phase 19: ImageNet.conf over the seeded JPEG packs through the
    port's CLI with ALEXNET_DATA_ARGS.  Every loss finite; the kernels
    launched ALEXNET_PER_STEP times a step and ALEXNET_EVAL_PER_BATCH
    times an eval batch (one pool backward a step relu-masked).  Prints
    the step p50 and images/s beside the alexnet phase's, each round's
    input fields, then runs one ``test_io = 1`` round.  Returns the
    path's launch counts."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    conf = alexnet_data_conf(tmp)
    sink = os.path.join(tmp, "alexnet_data.jsonl")
    args = list(ALEXNET_DATA_ARGS) + [f"metrics_sink=jsonl:{sink}",
                                      "silent=1"] + PREFETCH_ARGS
    log(f"alexnet_data: ImageNet.conf (imgbin + threadbuffer over the "
        f"packs) {' '.join(args)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    task = LearnTask()
    t0 = time.perf_counter()
    rc = task.run([conf] + args)
    wall = time.perf_counter() - t0
    launches = read_launches()
    relu = kernel_fn("max_pool_bwd").relu_launches
    st = task.last_train
    steps = DATA_IMAGES // 256 * DATA_ROUNDS
    evals = DATA_EVAL_IMAGES // 256 * DATA_ROUNDS
    if rc != 0 or st is None or st["steps"] != steps:
        raise AssertionError(f"alexnet_data: CLI returned {rc} after "
                             f"{None if st is None else st['steps']} steps")
    losses = st["losses"]
    card = card_line()
    ref = MEASURED.get("alexnet")
    beside = ("" if ref is None else
              f"; alexnet (synthetic batches on the card) "
              f"{ref['step_p50_ms']:.2f} ms = {ref['examples_per_sec']:.1f}"
              " images/s")
    log(f"alexnet_data: {steps} steps, losses {losses[0]:.4f} .. "
        f"{losses[-1]:.4f}; step p50 {st['step_p50_ms']:.2f} ms (steps "
        f"after the first) = {st['examples_per_sec']:.1f} images/s{beside}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB;"
        f" CLI wall {wall:.1f} s ({card})")
    for r in st["rounds"]:
        log(f"alexnet_data: round {r['round']}: {r['examples']} images in "
            f"{r['wall_sec']} s = {r['examples_per_sec']} images/s, "
            f"iter_wait {r['iter_wait_sec']} s, h2d {r['h2d_sec']} s, eval "
            f"{r['eval_sec']} s, {', '.join(f'{k} {v:.4f}' for k, v in r.items() if '-' in k)}")
    recs = [r for r in read_records(sink) if r["kind"] == "step"]
    log("alexnet_data: step records (every 5 steps): " + "; ".join(
        f"step {r['step']} dispatch {r['dispatch_sec']} s, "
        f"{r['examples_per_sec']} "
        f"images/s, iter_wait {r['iter_wait_sec']} s, h2d {r['h2d_sec']} s,"
        f" depth {r['staging_depth']}" for r in recs))
    log(f"alexnet_data path launches: {launches}, relu-masked pool backward "
        f"{relu}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"alexnet_data: non-finite loss {losses}")
    want = {n: ALEXNET_PER_STEP.get(n, 0) * steps
            + ALEXNET_EVAL_PER_BATCH.get(n, 0) * evals for n in KERNELS}
    if launches != want or relu != steps:
        raise AssertionError(f"alexnet_data: launches {launches} (relu-"
                             f"masked {relu}), expected {want} ({steps} "
                             "relu-masked)")
    del task
    torch.cuda.empty_cache()
    task = LearnTask()
    rc = task.run([conf, "dev=gpu", "test_io=1", "num_round=1",
                   "save_model=0", "silent=1"])
    [r] = task.last_train["rounds"]
    io_launches = {n: c for n, c in read_launches().items()
                   if c != launches[n]}
    log(f"alexnet_data: test_io = 1 round (the host pipeline alone): "
        f"{r['examples']} images in {r['wall_sec']} s = "
        f"{r['examples_per_sec']} images/s ({card})")
    if rc != 0 or r["examples"] != DATA_IMAGES or io_launches:
        raise AssertionError(f"alexnet_data: test_io returned {rc}, "
                             f"{r['examples']} images, launches "
                             f"{io_launches}")
    del task
    return launches


class _Batches:
    """An iterator over a list of host batches."""

    def __init__(self, batches):
        self.batches = batches

    def before_first(self):
        self.i = 0

    def next(self):
        if self.i >= len(self.batches):
            return None
        self.i += 1
        return self.batches[self.i - 1]

    def close(self):
        pass


def _train_chain(conf: str, extra=()):
    """The train iterator of ``conf`` as the CLI builds it (a fresh,
    initialised chain)."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.utils.config import parse_config_file
    task = LearnTask()
    for k, v in list(parse_config_file(conf)) + list(extra):
        task.set_param(k, v)
    task._create_iterators()
    for it in task.itr_evals:
        it.close()
    return task.itr_train


def staged_values(make_chain, tr, depth: int, busy: bool) -> list:
    """STAGING_BATCHES batches of a fresh chain staged by a
    DevicePrefetcher of ``depth``, each read on the compute stream the
    moment it is handed over (``_normalize_input`` and a copy, nothing
    that waits on the host, so the consumer outruns the producer), then
    dropped; ``busy``: STAGING_MATMULS bf16 matmuls queued before each
    read.  Returns the host copies."""
    import torch
    from cxxnet_tpu_torch.io.device_prefetch import DevicePrefetcher
    chain = make_chain()
    pf = DevicePrefetcher(chain, tr, depth=depth)
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    outs = []
    try:
        pf.before_first()
        while len(outs) < STAGING_BATCHES:
            item = pf.next()
            if item is None:
                break
            [sb] = item
            if busy:
                for _ in range(STAGING_MATMULS):
                    a = (a @ a) * (8192 ** -0.5)
            sb.handover()
            outs.append((tr._normalize_input(sb.data).clone(),
                         sb.label.clone()))
            del sb, item
    finally:
        pf.close()
        chain.close()
    torch.cuda.synchronize()
    return [(x.cpu(), lab.cpu()) for x, lab in outs]


def phase_staging(tmp: str) -> None:
    """Phase 20: each chain staged at depth 2 and read behind a busy
    compute stream (a staged tensor recycled under its reader would
    differ) or at once on an idle one (a read that did not wait for its
    copy would differ), and at depth 0; the batches must agree
    bitwise."""
    import torch
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_file

    def trainer(conf, extra=()):
        tr = NetTrainer()
        for k, v in list(parse_config_file(conf)) + list(extra):
            tr.set_param(k, v)
        tr.init_model()
        return tr

    alex_conf = alexnet_data_conf(tmp)
    mnist_conf = mnist_conv_conf(tmp)
    # the mean image made before the chains compared: the chain that made
    # it would read its pack an epoch later than one that loads it
    _train_chain(alex_conf, [("dev", "gpu")]).close()
    alex = trainer(alex_conf, [("dev", "gpu"), ("silent", "1"),
                               ("mean_value", IMAGENET_MEAN)])
    mnist = trainer(mnist_conf, [("dev", "gpu"), ("silent", "1")])
    rng = np.random.RandomState(31)
    u8 = [DataBatch(rng.randint(0, 256, (256, 3, 227, 227)).astype(np.uint8),
                    rng.randint(0, 1000, (256, 1)).astype(np.float32),
                    np.arange(256, dtype=np.uint32))
          for _ in range(STAGING_BATCHES)]
    # the u8 batches first: no earlier phase staged them, so no block the
    # allocator hands out holds a stale copy that could pass for them
    chains = (
        ("u8 batches at AlexNet's shape", alex, lambda: _Batches(u8)),
        ("alexnet_data's train chain (imgbin + threadbuffer, f32)", alex,
         lambda: _train_chain(alex_conf, [("dev", "gpu")])),
        ("MNIST_CONV's train chain (mnist, f32)", mnist,
         lambda: _train_chain(mnist_conf, [("dev", "gpu")])))
    card = card_line()
    for label, tr, make in chains:
        t0 = time.perf_counter()
        # the idle-stream read before depth 0 stages the same batches
        raced = {busy: staged_values(make, tr, 2, busy=busy)
                 for busy in (False, True)}
        inline = staged_values(make, tr, 0, busy=False)
        same = {busy: len(r) == len(inline) == STAGING_BATCHES
                and all(torch.equal(x, y) and torch.equal(lx, ly)
                        for (x, lx), (y, ly) in zip(r, inline))
                for busy, r in raced.items()}
        log(f"staging: {label}: {len(inline)} batches of "
            f"{tuple(inline[0][0].shape)} {inline[0][0].dtype} staged at "
            f"depth 2, read behind {STAGING_MATMULS} bf16 matmuls each / "
            f"at once on an idle stream, against depth 0: "
            + " / ".join("bitwise equal" if same[k] else "DIFFERENT"
                         for k in (True, False))
            + f" ({time.perf_counter() - t0:.1f} s; {card})")
        if not all(same.values()):
            raise AssertionError(f"staging: {label}: the prefetched batches "
                                 "differ from the inline ones")
    del alex, mnist
    torch.cuda.empty_cache()


def googlenet_per_step(tr) -> dict:
    """``{kernel: launches}`` that one step of trainer ``tr`` makes, read
    from its graph after the peepholes: each chain of ``batch_split``
    runs every LRN (``pallas_lrn = 1``: row 1's forward and backward),
    every max pool once a segment of its input (a virtual concat's
    segments, ``concat_virtual = 1``; rows 3 and 4), and the wgrad of
    every fast-wgrad conv that keeps its bias (row 5).  Under
    ``pool_layout = hwcn``, where every max pool goes through the
    kernels.  The relu-masked pool backwards are a literal
    (GOOGLENET_RELU_PER_STEP)."""
    from cxxnet_tpu_torch.layers.conv import (AvgPoolingLayer,
                                              ConvolutionLayer, LRNLayer,
                                              MaxPoolingLayer,
                                              SumPoolingLayer)
    from cxxnet_tpu_torch.layers.shape_ops import ChConcatLayer, SplitLayer
    from cxxnet_tpu_torch.ops import nn as N
    net, opts = tr.net, tr.opts
    assert opts.pool_layout == "hwcn", opts.pool_layout
    chains = tr.batch_split
    virtual = opts.concat_virtual == "1"
    segs = {}
    n = dict.fromkeys(("lrn_fwd", "lrn_bwd", "max_pool_fwd",
                       "max_pool_bwd", "conv_wgrad"), 0)
    for i, c in enumerate(net.connections):
        if i in net.fuse_skip:
            continue
        layer, p = c.layer, c.layer.param
        k = segs.get(c.nindex_in[0], 1)
        out = 1
        if virtual and type(layer) is ChConcatLayer:
            out = sum(segs.get(m, 1) for m in c.nindex_in)
        elif virtual and type(layer) is SplitLayer:
            out = k
        elif type(layer) is MaxPoolingLayer:
            if layer.deferred_bias_key is not None:
                k = 1
            n["max_pool_fwd"] += k
            n["max_pool_bwd"] += k
            out = k if virtual else 1
        elif virtual and type(layer) in (AvgPoolingLayer, SumPoolingLayer):
            out = k
        elif type(layer) is LRNLayer and opts.pallas_lrn == "1":
            n["lrn_fwd"] += 1
            n["lrn_bwd"] += 1
        elif (type(layer) is ConvolutionLayer and not p.no_bias
              and not layer.defer_bias and not layer.s2d_input
              and not layer.space_to_depth
              and N.use_fast_wgrad(net.node_shapes[c.nindex_in[0]][1],
                                   p.stride, p.num_group, opts)):
            n["conv_wgrad"] += 1
        for m in c.nindex_out:
            segs[m] = out
    return {k: v * chains for k, v in n.items()}


def narrow_inception() -> str:
    """The zoo's GoogLeNet pieces (``_conv_relu``, ``_inception``) cut to
    two modules at channels 4-32 and input 3x64x64: conv1 k7 s2 p3,
    pool1, LRN, conv2r / conv2, LRN, pool2, inception 3a and 3b, pool3,
    average pool, fullc 10, softmax."""
    from cxxnet_tpu_torch.models.zoo import _conv_relu, _inception
    lines = ["netconfig=start"]
    _conv_relu(lines, "0", "c1", "conv1", 16, 7, pad=3, stride=2)
    lrn = ["  local_size = 5", "  alpha = 0.0001", "  beta = 0.75",
           "  knorm = 1"]
    lines += ["layer[c1->p1] = max_pooling", "  kernel_size = 3",
              "  stride = 2", "layer[p1->n1] = lrn"] + lrn
    _conv_relu(lines, "n1", "c2r", "conv2r", 16, 1)
    _conv_relu(lines, "c2r", "c2", "conv2", 32, 3, pad=1)
    lines += ["layer[c2->n2] = lrn"] + lrn + [
        "layer[n2->p2] = max_pooling", "  kernel_size = 3", "  stride = 2"]
    top = _inception(lines, "i3a", "p2", 8, 8, 16, 4, 8, 8)
    top = _inception(lines, "i3b", top, 16, 8, 16, 4, 8, 8)
    lines += [f"layer[{top}->p3] = max_pooling", "  kernel_size = 3",
              "  stride = 2", "layer[p3->gp] = avg_pooling",
              "  kernel_size = 4", "  stride = 1", "layer[gp->fl] = flatten",
              "layer[fl->fc] = fullc:fc", "  nhidden = 10",
              "layer[fc->fc] = softmax", "netconfig=end",
              "input_shape = 3,64,64"]
    return "\n".join(lines) + "\n"


def inception_step_card_vs_cpu(conf: str) -> None:
    """One float32 step of the narrow inception net (narrow_inception)
    under GoogLeNet.conf's keys with googlenet_hwcn's overrides, batch
    INCEPTION_BATCH: on the card (rows 1, 3, 4 and 5 launched, pool1's
    backward relu-masked) and on the port's CPU path (the plain versions)
    from the same weights and batch; every gradient within
    INCEPTION_GRAD_TOL (max |diff| / max |ref|) of the CPU's, the loss
    within 1e-4."""
    import torch
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import (parse_config_file,
                                               parse_config_string)
    keys = [(k, v) for k, v in parse_config_file(conf)
            if k in ("input_s2d", "conv_sibling_fuse", "pallas_lrn",
                     "concat_virtual", "batch_split", "momentum",
                     "wmat:lr", "wmat:wd", "bias:wd")]
    keys += [tuple(a.split("=")) for a in GOOGLENET_HWCN_ARGS[-5:]]
    keys += [("batch_size", str(INCEPTION_BATCH)), ("dtype", "float32"),
             ("random_type", "xavier"), ("eval_train", "0"),
             ("silent", "1"), ("seed", "5")]
    rnd = np.random.RandomState(6)
    batch = DataBatch(
        data=rnd.rand(INCEPTION_BATCH, 3, 64, 64).astype(np.float32),
        label=rnd.randint(0, 10, (INCEPTION_BATCH, 1)).astype(np.float32),
        index=np.arange(INCEPTION_BATCH, dtype=np.uint32))
    out = {}
    for dev in ("gpu", "cpu"):
        tr = NetTrainer()
        for k, v in parse_config_string(narrow_inception()) + keys + [
                ("dev", dev)]:
            tr.set_param(k, v)
        tr.init_model()
        if dev == "cpu":
            tr.set_state(*[{k: {t: v.cpu() for t, v in g.items()}
                            for k, g in tree.items()}
                           for tree in (card.params, card.buffers)])
        else:
            card = tr
        reset_launches()
        loss, grads = tr.loss_and_grads(batch)
        out[dev] = (float(loss), {k: {t: v.float().cpu() for t, v in
                                      g.items()} for k, g in grads.items()})
        if dev == "gpu":
            launches = read_launches()
            relu = kernel_fn("max_pool_bwd").relu_launches
            per = googlenet_per_step(tr)
            want_relu = INCEPTION_RELU_PER_STEP
            want = {n: per.get(n, 0) for n in KERNELS}
            if launches != want or relu != want_relu:
                raise AssertionError(
                    f"inception step: launches {launches} (relu-masked "
                    f"{relu}), expected {want} ({want_relu})")
    (lc, gc), (lg, gg) = out["cpu"], out["gpu"]
    worst = max((rel_err(gg[k][t], g), f"{k}/{t}")
                for k, grp in gc.items() for t, g in grp.items())
    log(f"inception step (f32, batch {INCEPTION_BATCH}, googlenet_hwcn "
        f"keys): loss card {lg:.6f} cpu {lc:.6f}; worst gradient "
        f"{worst[0]:.3e} ({worst[1]}; tol {INCEPTION_GRAD_TOL:g}); launches "
        f"{launches}, relu-masked {relu}")
    if abs(lg - lc) > 1e-4 * abs(lc) or worst[0] > INCEPTION_GRAD_TOL:
        raise AssertionError(f"inception step: the card's loss {lg} / "
                             f"gradients ({worst}) disagree with the CPU's")


def phase_googlenet(tmp: str, hwcn: bool = False,
                    profile: bool = False) -> dict:
    """``task = train`` of example/ImageNet/GoogLeNet.conf through the
    port's CLI with GOOGLENET_ARGS (its own keys: the plain lowerings,
    no hand-written kernel may launch) or GOOGLENET_HWCN_ARGS (rows 1,
    3, 4 and 5: the launches of every step must equal
    googlenet_per_step's, the relu-masked pool backwards apart; before
    it, inception_step_card_vs_cpu).  Every loss must be finite.  Prints
    the step p50 and images/s, the peak memory and the first and last
    losses; returns the path's launch counts."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    label = "googlenet_hwcn" if hwcn else "googlenet"
    conf = os.path.join(REPO, "example", "ImageNet", "GoogLeNet.conf")
    if hwcn:
        inception_step_card_vs_cpu(conf)
    args = list(GOOGLENET_HWCN_ARGS if hwcn else GOOGLENET_ARGS) + [
        f"model_dir={tmp}/{label}", "silent=1"]
    log(f"{label}: GoogLeNet.conf {' '.join(args)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    task = LearnTask()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    try:
        rc = task.run([conf] + args)
    finally:
        if prof is not None:
            prof.stop()
    wall = time.perf_counter() - t0
    launches = read_launches()
    relu = kernel_fn("max_pool_bwd").relu_launches
    st = task.last_train
    if prof is not None and st is not None:
        report_profile(prof.events(), st["step_ms"])
    if rc != 0 or st is None or st["steps"] != GOOGLENET_STEPS:
        raise AssertionError(f"{label}: CLI returned {rc} after "
                             f"{None if st is None else st['steps']} steps")
    losses = st["losses"]
    tr = task.net
    log(f"{label}: {GOOGLENET_STEPS} steps, losses {losses[0]:.4f} .. "
        f"{losses[-1]:.4f} (min {min(losses):.4f}, max {max(losses):.4f});"
        f" step p50 {st['step_p50_ms']:.2f} ms (steps after the first) = "
        f"{st['examples_per_sec']:.1f} images/s; first step "
        f"{st['step_ms'][0]:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; CLI wall "
        f"{wall:.1f} s; {len(tr.net.fuse_groups)} fused conv groups, "
        f"batch_split {tr.batch_split}, input_s2d {tr.input_s2d}")
    log(f"{label} path launches: {launches}, relu-masked pool backward "
        f"{relu}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    per, per_relu = ((googlenet_per_step(tr), GOOGLENET_RELU_PER_STEP)
                     if hwcn else ({}, 0))
    want = {n: per.get(n, 0) * GOOGLENET_STEPS for n in KERNELS}
    if launches != want or relu != per_relu * GOOGLENET_STEPS:
        raise AssertionError(f"{label}: launches {launches} (relu-masked "
                             f"{relu}), expected {want} "
                             f"({per_relu * GOOGLENET_STEPS} relu-masked)")
    if hwcn:
        log(f"googlenet_hwcn per step: {per}, relu-masked {per_relu}")
    del task, tr
    torch.cuda.empty_cache()
    return launches


def phase_resnet(tmp: str, profile: bool = False) -> dict:
    """``task = train`` of the zoo's resnet(depth = RESNET_DEPTH) through
    the port's CLI: batch RESNET_BATCH, bf16, sgd with momentum, 2
    rounds of 10 steps on synthetic batches held on the card, the last
    round's snapshot saved.  Every loss must be finite, and the
    snapshot's moving_mean / moving_var of every batch_norm layer finite
    and moved from their initial 0 / 1.  No hand-written kernel is on
    this path.  Prints the step p50 and images/s, the peak memory and the
    first and last losses; ``profile`` traces the run as phase_alexnet
    does."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.models import resnet
    from cxxnet_tpu_torch.utils import serializer
    conf = os.path.join(tmp, "resnet.conf")
    with open(conf, "w") as f:
        f.write(resnet(num_class=10, depth=RESNET_DEPTH) + f"""
batch_size = {RESNET_BATCH}
dtype = bfloat16
updater = sgd
momentum = 0.9
eta = 0.05
wd = 0.0001
random_type = kaiming
""")
    args = ["dev=gpu", "synth_device_data=1", "multi_step=10",
            "num_round=2", "save_model=2", f"model_dir={tmp}/resnet",
            "silent=1"]
    log(f"resnet: zoo resnet(depth={RESNET_DEPTH}) {' '.join(args)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    task = LearnTask()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    try:
        rc = task.run([conf] + args)
    finally:
        if prof is not None:
            prof.stop()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = task.last_train
    if prof is not None and st is not None:
        report_profile(prof.events(), st["step_ms"])
    if rc != 0 or st is None or st["steps"] != RESNET_STEPS:
        raise AssertionError(f"resnet: CLI returned {rc}")
    losses = st["losses"]
    log(f"resnet: {RESNET_STEPS} steps, losses {losses[0]:.4f} .. "
        f"{losses[-1]:.4f} (min {min(losses):.4f}, max {max(losses):.4f});"
        f" step p50 {st['step_p50_ms']:.2f} ms (steps after the first) = "
        f"{st['examples_per_sec']:.1f} images/s; first step "
        f"{st['step_ms'][0]:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; CLI wall "
        f"{wall:.1f} s")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet: non-finite loss {losses}")
    _, _, buffers, _ = serializer.load_model(
        os.path.join(tmp, "resnet", "0002.model"))
    nbn = sum(1 for c in task.net.net.connections
              if c.layer.type_names[0] == "batch_norm")
    moved = [(k, float(np.abs(g["moving_mean"]).max()),
              float(np.abs(g["moving_var"] - 1).max()))
             for k, g in buffers.items()]
    log(f"resnet snapshot: {len(buffers)} of {nbn} batch_norm layers' "
        f"buffers; least change from init: mean "
        f"{min(m for _, m, _ in moved):.3e}, var "
        f"{min(v for _, _, v in moved):.3e}")
    if len(buffers) != nbn or not all(
            np.isfinite(g[t]).all() and m > 0 and v > 0
            for (_, m, v), g in zip(moved, buffers.values())
            for t in ("moving_mean", "moving_var")):
        raise AssertionError(f"resnet: snapshot buffers {moved}")
    if any(launches.values()):
        raise AssertionError(f"resnet: launched kernels {launches}")
    del task
    torch.cuda.empty_cache()
    return launches


def mnist_conv_conf(tmp: str) -> str:
    """example/MNIST/MNIST_CONV.conf over tools/make_synth_mnist.py data
    in ``tmp`` (made once); returns the conf's path."""
    conf = os.path.join(tmp, "mnist_conv.conf")
    if os.path.exists(conf):
        return conf
    data = os.path.join(tmp, "mnist")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools", "make_synth_mnist.py"),
                    "--out", data], check=True, capture_output=True)
    text = open(os.path.join(REPO, "example", "MNIST",
                             "MNIST_CONV.conf")).read()
    with open(conf, "w") as f:
        f.write(text.replace("./data/", data + "/"))
    return conf


def phase_mnist_conv(tmp: str) -> dict:
    """``task = train`` of example/MNIST/MNIST_CONV.conf through the
    port's CLI (``iter = mnist``, ``eval = test``, ``metric = error``,
    ``eval_train = 1``) over tools/make_synth_mnist.py data, for
    MNIST_ROUNDS rounds under ``pool_layout = hwcn fast_wgrad = hwcn``:
    the test error must fall and end below half of its first round's.
    Every step launches the conv1 wgrad and the pool forward and
    backward; every eval batch the pool forward."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    conf = mnist_conv_conf(tmp)
    args = ["dev=gpu", f"num_round={MNIST_ROUNDS}",
            f"max_round={MNIST_ROUNDS}", "pool_layout=hwcn",
            "fast_wgrad=hwcn", f"model_dir={tmp}/mnist_models",
            f"save_model={MNIST_ROUNDS}", "silent=1"] + PREFETCH_ARGS
    log(f"mnist_conv: MNIST_CONV.conf {' '.join(args)}")
    reset_launches()
    task = LearnTask()
    t0 = time.perf_counter()
    rc = task.run([conf] + args)
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = task.last_train
    if rc != 0 or st is None or len(st["evals"]) != MNIST_ROUNDS:
        raise AssertionError(f"mnist_conv: CLI returned {rc}")
    test = [r["test-error"] for r in st["evals"]]
    train = [r["train-error"] for r in st["evals"]]
    steps = st["steps"]
    rounds = st.get("rounds") or []
    log(f"mnist_conv: {steps} steps, test-error by round {test}, "
        f"train-error {train}; step p50 {st['step_p50_ms']:.2f} ms; CLI "
        f"wall {wall:.2f} s; train wall a round (staging and steps) "
        f"{[r['wall_sec'] for r in rounds]} s")
    log(f"mnist_conv path launches: {launches}")
    if not (test[-1] < test[0] and test[-1] < 0.5 * test[0]):
        raise AssertionError(f"mnist_conv: test error did not fall below "
                             f"half its first round's: {test}")
    if not (launches["conv_wgrad"] == launches["max_pool_bwd"] == steps
            and launches["max_pool_fwd"] > steps):
        raise AssertionError(f"mnist_conv: launches {launches} for "
                             f"{steps} steps")
    del task
    torch.cuda.empty_cache()
    return launches, test[-1]


def read_records(path: str) -> list:
    """The JSON records of a metrics file that a live process may be
    writing (a torn last line is left out)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                break
    return out


def first_difference(a: dict, b: dict):
    """The first (shard, key) whose arrays differ in shape, dtype or
    bytes, or None."""
    if a.keys() != b.keys():
        return f"shards {sorted(a)} against {sorted(b)}"
    for shard in sorted(a):
        if a[shard].keys() != b[shard].keys():
            return f"{shard}: keys differ"
        for k in sorted(a[shard]):
            x, y = a[shard][k], b[shard][k]
            if x.dtype != y.dtype or x.shape != y.shape \
                    or x.tobytes() != y.tobytes():
                return f"{shard}:{k}"
    return None


def phase_resume(tmp: str) -> dict:
    """The kill-and-continue path (phase 13): run A uninterrupted in this
    process, run B as ``python -m cxxnet_tpu_torch`` in a subprocess,
    SIGKILLed once its metrics show the round-RESUME_KILL_AFTER snapshot
    committed and a step of the next round taken, then continued in this
    process with ``continue = 1``.  The launch counters count A and the
    continued part of B.  Returns the path's launch counts."""
    import shutil
    import torch
    from cxxnet_tpu_torch import ckpt
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.ops.fused_adam import fused_adam_supported
    card = card_line()
    log(f"resume: {shutil.disk_usage(tmp).free / 1e9:.1f} GB free in the "
        f"temp directory before the phase ({card})")
    rows = 2 * TRAIN_BATCH  # two batches a round; the rest carries over
    docs = phrase_docs(np.random.RandomState(23), rows * SEQ + SEQ // 4,
                       DOC_LENS)
    shard = os.path.join(tmp, "resume.tok")
    write_token_shard(shard, docs, itemsize=2)
    net = transformer(vocab=VOCAB, seq=SEQ, dim=DIM, nlayer=RESUME_LAYERS,
                      nhead=NHEAD, packed=True)

    def conf(name: str) -> str:
        path = os.path.join(tmp, f"resume_{name}.conf")
        with open(path, "w") as f:
            f.write(f"""dev = {DEV}
task = train
model_dir = {tmp}/resume_{name}
save_model = 1
ckpt_async = 1
ckpt_keep = 1
data = train
iter = text
  path_tok = {shard}
iter = packseq
  seqlen = {SEQ}
iter = threadbuffer
iter = end
{net}
batch_size = {TRAIN_BATCH}
dtype = bfloat16
updater = adam
eta = {TRAIN_ETA}
flash_attn = 1
pallas_ln = 1
fused_update = 1
num_round = {RESUME_ROUNDS}
print_step = 1
eval_train = 0
seed = 7
silent = 1
metrics_sink = jsonl:{tmp}/resume_{name}_metrics.jsonl
""")
        return path

    conf_a, conf_b = conf("A"), conf("B")
    metrics_b = os.path.join(tmp, "resume_B_metrics.jsonl")
    log(f"resume: {len(docs)} documents, {sum(d.size for d in docs)} tokens "
        f"a round; d{DIM} / {RESUME_LAYERS} layers / {NHEAD} heads / s{SEQ}"
        f" / vocab {VOCAB} / bf16 / fused adam / batch {TRAIN_BATCH}, "
        f"{RESUME_ROUNDS} rounds, ckpt_async = 1, ckpt_keep = 1")
    torch.cuda.empty_cache()
    reset_launches()
    task = LearnTask()
    t0 = time.perf_counter()
    rc = task.run([conf_a, "prefetch_device=0"])
    wall_a = time.perf_counter() - t0
    st_a = task.last_train
    want_steps = 2 * RESUME_ROUNDS
    if rc != 0 or st_a is None or st_a["steps"] != want_steps:
        raise AssertionError(f"resume: run A returned {rc} after "
                             f"{None if st_a is None else st_a['steps']} "
                             f"steps, not {want_steps}")
    admitted = sum(fused_adam_supported(p) for g in task.net.params.values()
                   for p in g.values())
    del task
    torch.cuda.empty_cache()
    log(f"resume: run A (prefetch_device = 0) {want_steps} steps, losses "
        f"{[round(x, 4) for x in st_a['losses']]}, step p50 "
        f"{st_a['step_p50_ms']:.1f} ms; CLI wall {wall_a:.1f} s")

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    out_b = os.path.join(tmp, "resume_B_part1.log")
    t0 = time.perf_counter()
    with open(out_b, "w") as fo:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch", conf_b], cwd=REPO,
            env=env, stdout=fo, stderr=subprocess.STDOUT)
        try:
            while True:
                recs = read_records(metrics_b)
                saved = any(r["kind"] == "ckpt"
                            and r["round"] == RESUME_KILL_AFTER for r in recs)
                # a step record's round counts from 0: the step of the
                # round after snapshot N says N
                stepped = any(r["kind"] == "step"
                              and r["round"] == RESUME_KILL_AFTER
                              for r in recs)
                if saved and stepped:
                    proc.kill()
                    break
                if proc.poll() is not None:
                    raise AssertionError(
                        f"resume: run B ended (rc {proc.returncode}) before "
                        f"its kill point:\n{open(out_b).read()[-3000:]}")
                if time.perf_counter() - t0 > RESUME_KILL_TIMEOUT:
                    raise AssertionError("resume: run B did not reach its "
                                         "kill point in time")
                time.sleep(0.02)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    wall_b1 = time.perf_counter() - t0
    dir_b = os.path.join(tmp, "resume_B")
    left = {n: ckpt.validate_snapshot(os.path.join(dir_b, n)) is not None
            for n in sorted(os.listdir(dir_b))}
    log(f"resume: run B SIGKILLed (rc {proc.returncode}) {wall_b1:.1f} s "
        f"after its start; its snapshots (complete?): {left}")
    if not left.get(f"{RESUME_KILL_AFTER:04d}.ckpt"):
        raise AssertionError("resume: run B's last committed snapshot does "
                             "not validate after the kill")
    part1 = [r for r in read_records(metrics_b) if r["kind"] == "step"]
    n_before = len(read_records(metrics_b))

    task = LearnTask()
    t0 = time.perf_counter()
    rc = task.run([conf_b, "continue=1"])
    wall_b2 = time.perf_counter() - t0
    launches = read_launches()
    st_b = task.last_train
    del task
    torch.cuda.empty_cache()
    recs_b = read_records(metrics_b)
    part2 = [r for r in recs_b[n_before:] if r["kind"] == "step"]
    rounds2 = sorted({r["round"] for r in part2})
    if rc != 0 or st_b is None or st_b["steps"] != 2 \
            or rounds2 != [RESUME_KILL_AFTER]:
        raise AssertionError(f"resume: the continued run returned {rc}, "
                             f"rounds {rounds2}, steps "
                             f"{None if st_b is None else st_b['steps']}")
    log(f"resume: run B (prefetch_device = 2) continued from round "
        f"{RESUME_KILL_AFTER + 1}: "
        f"{st_b['steps']} steps, losses "
        f"{[round(x, 4) for x in st_b['losses']]}; CLI wall {wall_b2:.1f} s")

    last = f"{RESUME_ROUNDS:04d}.ckpt"
    ma, sa = ckpt.load_snapshot(os.path.join(tmp, "resume_A", last))
    mb, sb = ckpt.load_snapshot(os.path.join(dir_b, last))
    diff = first_difference(sa, sb)
    narrays = sum(len(a) for a in sa.values())
    for key in ("train_state", "iter_state"):
        if diff is None and ma["extra"][key] != mb["extra"][key]:
            diff = f"manifest extra.{key}"
    log(f"resume: A's and B's {last}: {narrays} arrays in shards "
        f"{sorted(sa)}, train_state, iter_state "
        f"({len(ma['extra']['iter_state']['base']['tok'])} tokens "
        "carried): "
        f"{'bitwise equal' if diff is None else 'FIRST DIFFERENCE ' + diff}")
    if diff is not None:
        raise AssertionError(f"resume: run B's {last} differs from run A's "
                             f"at {diff}")
    del sa, sb

    for name, recs in (("A", read_records(
            os.path.join(tmp, "resume_A_metrics.jsonl"))), ("B", recs_b)):
        for r in recs:
            if r["kind"] == "ckpt":
                log(f"resume: run {name} snapshot {r['round']:04d}: "
                    f"{r['bytes']} bytes, {r['shards']} shards, write "
                    f"{r['write_sec']} s off-thread = "
                    f"{r['bytes'] / max(r['write_sec'], 1e-9) / 1e9:.3f} GB/s, train "
                    f"thread blocked {r['blocked_sec']} s, pruned "
                    f"{r['pruned']} ({card})")
    # print_step = 1: a record's dispatch wall is its step's (0 for the
    # first dispatch, the compile record's)
    b1_ms = [r["dispatch_sec"] * 1e3 for r in part1]
    p50_b1 = float(np.median(b1_ms[1:] or b1_ms))
    log(f"resume: step p50 (steps after the first of each part): run A "
        f"{st_a['step_p50_ms']:.2f} ms, run B before the kill {p50_b1:.2f} "
        f"ms ({len(b1_ms)} steps), after the resume {st_b['step_p50_ms']:.2f}"
        f" ms ({card})")
    log(f"resume path launches: {launches}")
    steps = want_steps + st_b["steps"]
    want = {"flash_attention_seg_fwd": RESUME_LAYERS,
            "flash_attention_seg_bwd": RESUME_LAYERS,
            "layernorm_fwd": 2 * RESUME_LAYERS + 1,
            "layernorm_bwd": 2 * RESUME_LAYERS + 1, "fused_adam": admitted}
    short = {k: launches[k] / steps for k, n in want.items()
             if launches[k] < n * steps}
    if short:
        raise AssertionError(f"resume: launches per step {short} below "
                             f"{want}: a step did not run its kernel")
    for name in ("A", "B"):
        shutil.rmtree(os.path.join(tmp, f"resume_{name}"),
                      ignore_errors=True)
    return launches


def read_mnist_labels(path: str) -> np.ndarray:
    import gzip
    with gzip.open(path, "rb") as f:
        return np.frombuffer(f.read()[8:], np.uint8)


def phase_cnn_infer(tmp: str, test_error: float) -> dict:
    """``task = pred``, ``pred_raw`` and ``extract`` (text, then binary)
    through the port's CLI and example/MNIST/MNIST_pred.conf from the
    mnist_conv phase's last snapshot, under ``pool_layout = hwcn``, then
    one round of ``task = finetune`` from it with MNIST_CONV.conf.  The
    predictions' error against the test labels must equal that round's
    ``test_error``; every raw row sums to 1 within 1e-5; the features
    have the ``.meta`` width, and the binary rows equal the text rows to
    their printed digits; finetune copies every layer and trains a finite
    round.  Prints each task's per-batch latency; returns the path's
    launch counts."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    data = os.path.join(tmp, "mnist")
    snap = os.path.join(tmp, "mnist_models", f"{MNIST_ROUNDS:04d}.model")
    text = open(os.path.join(REPO, "example", "MNIST",
                             "MNIST_pred.conf")).read()
    conf = os.path.join(tmp, "mnist_pred.conf")
    with open(conf, "w") as f:
        f.write(text.replace("./data/", data + "/")
                .replace("dev = cpu", "dev = gpu")
                .replace("pred = out.txt", f"pred = {tmp}/pred_out"))
    out = os.path.join(tmp, "pred_out")
    base = [conf, f"model_in={snap}", "input_flat=0", "pool_layout=hwcn",
            "silent=1"]
    labels = read_mnist_labels(os.path.join(data,
                                            "t10k-labels-idx1-ubyte.gz"))
    reset_launches()
    results = {}
    for task_name, extra in (
            ("pred", []), ("pred_raw", []),
            ("extract", [f"extract_node_name={EXTRACT_NODE}",
                         "output_format=txt"]),
            ("extract_bin", [f"extract_node_name={EXTRACT_NODE}",
                             "output_format=bin"])):
        task = LearnTask()
        t0 = time.perf_counter()
        rc = task.run(base + [f"task={task_name.split('_bin')[0]}"] + extra
                      + PREFETCH_ARGS)
        wall = time.perf_counter() - t0
        op = "extract" if task_name.startswith("extract") else "pred"
        lat = task.net.metrics.histograms[f"{op}_latency_sec"].summary()
        if rc != 0:
            raise AssertionError(f"cnn_infer: task = {task_name} returned "
                                 f"{rc}")
        log(f"cnn_infer {task_name}: {int(lat['count'])} batches, latency "
            f"p50 {lat['p50'] * 1e3:.3f} ms, p99 {lat['p99'] * 1e3:.3f} ms,"
            f" mean {lat['mean'] * 1e3:.3f} ms; CLI wall {wall:.3f} s")
        if task_name == "extract_bin":
            meta = int(open(out + ".meta").read())
            results[task_name] = np.fromfile(out, "<f4").reshape(-1, meta)
        else:
            results[task_name] = np.loadtxt(out, np.float32, ndmin=2)
        del task
    pred = results["pred"][:, 0]
    err = float(np.mean(pred != labels[:pred.size]))
    raw = results["pred_raw"]
    sums = np.abs(raw.sum(1) - 1.0).max()
    ext, ext_bin = results["extract"], results["extract_bin"]
    log(f"cnn_infer: {pred.size} predictions, error {err:.6f} (the last "
        f"round's test-error {test_error:.6f}); pred_raw {raw.shape}, max "
        f"|row sum - 1| {sums:.2e}; extract node {EXTRACT_NODE}: text "
        f"{ext.shape}, binary {ext_bin.shape}")
    if pred.size != labels.size or abs(err - test_error) > 1e-9:
        raise AssertionError(f"cnn_infer: pred error {err} != test-error "
                             f"{test_error}")
    if raw.shape != (labels.size, 10) or sums > 1e-5:
        raise AssertionError(f"cnn_infer: pred_raw rows {raw.shape}, sums "
                             f"off by {sums}")
    if (meta != EXTRACT_WIDTH or ext.shape != (labels.size, EXTRACT_WIDTH)
            or ext_bin.shape != ext.shape
            or not np.allclose(ext, ext_bin, rtol=1e-5, atol=1e-6)):
        raise AssertionError(f"cnn_infer: extract rows {ext.shape} / "
                             f"{ext_bin.shape}, width {EXTRACT_WIDTH}")
    task = LearnTask()
    rc = task.run([os.path.join(tmp, "mnist_conv.conf"), "dev=gpu",
                   "task=finetune", f"model_in={snap}", "num_round=1",
                   "max_round=1", "pool_layout=hwcn", "fast_wgrad=hwcn",
                   f"model_dir={tmp}/finetune", "save_model=0", "silent=1"])
    st = task.last_train
    copied = task.net.copied_layers
    log(f"cnn_infer finetune: copied layers {copied}; {st['steps']} steps, "
        f"losses {st['losses'][0]:.4f} .. {st['losses'][-1]:.4f}, evals "
        f"{st['evals']}")
    if rc != 0 or copied != ["cv1", "fc1", "fc2"] or not st["steps"] \
            or not all(np.isfinite(st["losses"])):
        raise AssertionError(f"cnn_infer: finetune returned {rc}, copied "
                             f"{copied}")
    launches = read_launches()
    log(f"cnn_infer path launches: {launches}")
    if launches["max_pool_fwd"] < 1 or launches["conv_wgrad"] != st["steps"]:
        raise AssertionError(f"cnn_infer: launches {launches}")
    del task
    torch.cuda.empty_cache()
    return launches


def top2_margin(row: np.ndarray) -> float:
    """The largest logit less the second largest."""
    a, b = np.partition(row, -2)[-2:]
    return float(b - a)


def spec_consistency(tr) -> tuple:
    """serve_spec step 1 on the phase's trainer: a width-4 block against
    4 sequential steps (a 200-token prompt in slot 2), a chunked prefill
    (C SPEC_CHUNK) of a 1000-token prompt against the whole prefill, and
    an f32 KV cache against the bf16 one over 8 steps, each within
    SERVE_TOL_BF16.  Returns the noise levels the speculative runs are
    read against: the largest absolute logit difference between a
    verify row and its step's row, and between a chunk's last row and
    the whole prefill's."""
    import torch
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    eng = DecodeEngine(tr, slots=SLOTS, block_widths=(SPEC_K + 1,
                                                      SPEC_CHUNK))
    eng.warmup()
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, VOCAB, 200).astype(np.int32)
    toks = [int(np.argmax(eng.prefill(2, prompt)))]
    rows = []
    for i in range(SPEC_K + 1):
        tokens = np.zeros((SLOTS,), np.int32)
        positions = np.zeros((SLOTS,), np.int32)
        tokens[2], positions[2] = toks[-1], len(prompt) + i
        rows.append(eng.step(tokens, positions)[2])
        toks.append(int(np.argmax(rows[-1])))
    tokens = np.zeros((SLOTS, SPEC_K + 1), np.int32)
    positions = np.zeros((SLOTS,), np.int32)
    tokens[2], positions[2] = toks[:SPEC_K + 1], len(prompt)
    blk = eng.block(tokens, positions)[2]
    steps = np.stack(rows)
    e_blk = rel_err(torch.from_numpy(blk), torch.from_numpy(steps))
    d_blk = float(np.abs(blk - steps).max())
    long = rng.randint(0, VOCAB, 1000).astype(np.int32)
    whole = eng.prefill(0, long)
    for off in range(0, len(long), SPEC_CHUNK):
        tokens = np.zeros((SLOTS, SPEC_CHUNK), np.int32)
        piece = long[off:off + SPEC_CHUNK]
        tokens[1, :len(piece)] = piece
        positions = np.zeros((SLOTS,), np.int32)
        positions[1] = off
        out = eng.block(tokens, positions)
    last = out[1, len(long) - 1 - off]
    e_chunk = rel_err(torch.from_numpy(last), torch.from_numpy(whole))
    d_chunk = float(np.abs(last - whole).max())
    eng32 = DecodeEngine(tr, slots=SLOTS, kv_dtype="f32")
    seq = [int(np.argmax(eng.prefill(3, prompt)))]
    eng32.prefill(3, prompt)
    r16, r32 = [], []
    for i in range(8):
        tokens = np.zeros((SLOTS,), np.int32)
        positions = np.zeros((SLOTS,), np.int32)
        tokens[3], positions[3] = seq[-1], len(prompt) + i
        r16.append(eng.step(tokens, positions)[3])
        r32.append(eng32.step(tokens, positions)[3])
        seq.append(int(np.argmax(r16[-1])))
    e_kv = rel_err(torch.from_numpy(np.stack(r32)),
                   torch.from_numpy(np.stack(r16)))
    log(f"serve_spec consistency (bf16 net, tol {SERVE_TOL_BF16}): width-"
        f"{SPEC_K + 1} block vs {SPEC_K + 1} steps {e_blk:.3e} (max |diff| "
        f"{d_blk:.4f}); chunked prefill (C {SPEC_CHUNK}) of 1000 tokens vs "
        f"whole {e_chunk:.3e} (max |diff| {d_chunk:.4f}); f32 KV cache vs "
        f"bf16 over 8 steps {e_kv:.3e}; KV bytes {eng32.kv_cache_bytes()} "
        f"vs {eng.kv_cache_bytes()}")
    if max(e_blk, e_chunk, e_kv) > SERVE_TOL_BF16 \
            or eng32.kv_cache_bytes() != 2 * eng.kv_cache_bytes():
        raise AssertionError("serve_spec: block / chunk / KV dtype rows "
                             "leave the bf16 envelope")
    # one dispatch of each kind, logits back on the host (slot 2 writes
    # past its prompt, which nothing reads again)
    positions = np.full((SLOTS,), len(prompt), np.int32)
    step_ms = time_ms(lambda: eng.step(np.zeros((SLOTS,), np.int32),
                                       positions))
    verify_ms = time_ms(lambda: eng.block(
        np.zeros((SLOTS, SPEC_K + 1), np.int32), positions))
    chunk_ms = time_ms(lambda: eng.block(
        np.zeros((SLOTS, SPEC_CHUNK), np.int32), positions), reps=5)
    log(f"serve_spec dispatch (median, CUDA events, logits on the host): "
        f"step {step_ms:.3f} ms, verify (width {SPEC_K + 1}) "
        f"{verify_ms:.3f} ms = {verify_ms / step_ms:.2f}x a step, chunk "
        f"tick (width {SPEC_CHUNK}) {chunk_ms:.3f} ms")
    del eng, eng32
    torch.cuda.empty_cache()
    return d_blk, d_chunk


def plain_greedy(tr, prompts, n: int):
    """Greedy ids of each prompt through DecodeEngine's prefill and
    steps (SLOTS prompts at a time), and the top-2 logit margin at each
    position."""
    import torch
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    eng = DecodeEngine(tr, slots=SLOTS)
    ids, margins = [], []
    for at in range(0, len(prompts), SLOTS):
        group = prompts[at:at + SLOTS]
        rows = [eng.prefill(i, p) for i, p in enumerate(group)]
        seqs = [[int(np.argmax(r))] for r in rows]
        mar = [[top2_margin(r)] for r in rows]
        for j in range(1, n):
            tokens = np.zeros((SLOTS,), np.int32)
            positions = np.zeros((SLOTS,), np.int32)
            for i, p in enumerate(group):
                tokens[i], positions[i] = seqs[i][-1], len(p) + j - 1
            out = eng.step(tokens, positions)
            for i in range(len(group)):
                seqs[i].append(int(np.argmax(out[i])))
                mar[i].append(top2_margin(out[i]))
        ids += seqs
        margins += mar
    del eng
    torch.cuda.empty_cache()
    return ids, margins


def teacher_forced(tr, prompts, gens, noise: float) -> tuple:
    """Each generation fed back through DecodeEngine's prefill and
    plain steps (SLOTS prompts at a time): at every position the emitted
    id's logit must lie within 2 x ``noise`` of that row's largest.
    Returns the largest shortfall and the count of positions whose
    emitted id is not the row's argmax."""
    import torch
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    eng = DecodeEngine(tr, slots=SLOTS)
    worst, off_argmax = 0.0, 0
    for at in range(0, len(prompts), SLOTS):
        group = list(zip(prompts[at:at + SLOTS], gens[at:at + SLOTS]))
        rows = [[eng.prefill(i, p)] for i, (p, _) in enumerate(group)]
        for j in range(1, max(len(g) for _, g in group)):
            tokens = np.zeros((SLOTS,), np.int32)
            positions = np.zeros((SLOTS,), np.int32)
            for i, (p, g) in enumerate(group):
                if j < len(g):
                    tokens[i], positions[i] = g[j - 1], len(p) + j - 1
            out = eng.step(tokens, positions)
            for i, (_, g) in enumerate(group):
                if j < len(g):
                    rows[i].append(out[i])
        for (_, g), rr in zip(group, rows):
            for j, (tok, row) in enumerate(zip(g, rr)):
                short = float(row.max() - row[tok])
                worst = max(worst, short)
                off_argmax += int(short > 0)
                if short > 2 * noise:
                    raise AssertionError(
                        f"serve_spec: emitted id {tok} at position {j} is "
                        f"{short:.4f} below the plain step's largest logit "
                        f"(2 x noise {2 * noise:.4f})")
    del eng
    torch.cuda.empty_cache()
    return worst, off_argmax


def write_draft(tmp: str) -> str:
    """The seeded small draft of run (a), saved as a ``.model``."""
    import torch
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    tr = NetTrainer()
    for k, v in parse_config_string(transformer(
            vocab=VOCAB, seq=SEQ, dim=DRAFT_DIM, nlayer=DRAFT_LAYERS,
            nhead=DRAFT_NHEAD)):
        tr.set_param(k, v)
    for k, v in (("batch_size", str(SLOTS)), ("dtype", "bfloat16"),
                 ("dev", DEV), ("seed", "9"), ("silent", "1")):
        tr.set_param(k, v)
    tr.init_model()
    path = os.path.join(tmp, "draft.model")
    tr.save_model(path)
    del tr
    torch.cuda.empty_cache()
    return path


def phase_serve_spec(tmp: str, task, conf: str) -> dict:
    """Speculative decoding and chunked prefill on the served flagship:
    the consistency of block, chunk and KV-dtype rows at the served
    shape (:func:`spec_consistency`), then two serve CLI runs over the
    serve phase's 8 prompts: (a) the seeded small draft with spec_k =
    SPEC_K and decode_prefill_chunk = SPEC_CHUNK, (b) the flagship's own
    snapshot as the draft, spec_k = SPEC_K, whole-prompt prefill.  The
    noise of a run is what step 1 measured for the rows it emits from:
    the verify rows (block against step), and in (a), whose first token
    comes off a chunk's last row and whose cache the chunks wrote, the
    chunked prefill's too.  Each generation must equal the plain greedy
    decode's, token for token, or first differ at a near-tie: a position
    whose plain top-2 margin is at most twice the noise.  Every emitted
    id, past a first difference too, is then held to the plain step's
    row by :func:`teacher_forced`.  (b) must accept at least
    SELF_DRAFT_ACCEPT of the proposals.  The launch counters are zeroed
    before each run and read after it."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    with np.load(os.path.join(tmp, "prompts.npz")) as z:
        prompts = [z[f"arr_{i}"].astype(np.int32) for i in range(len(z))]
    d_blk, d_chunk = spec_consistency(task.net)
    plain, margins = plain_greedy(task.net, prompts, GEN_TOKENS)
    model = re.search(r"^model_in = (.*)$", open(conf).read(), re.M)[1]
    runs = (("a", write_draft(tmp), [f"decode_prefill_chunk={SPEC_CHUNK}"],
             DRAFT_LAYERS, max(d_blk, d_chunk)),
            ("b", model, [], NLAYER, d_blk))
    total = {n: 0 for n in KERNELS}
    for name, draft, extra, dlayers, noise in runs:
        reset_launches()
        t = LearnTask()
        t0 = time.perf_counter()
        rc = t.run([conf, f"serve_draft_model={draft}", f"spec_k={SPEC_K}"]
                   + extra)
        wall = time.perf_counter() - t0
        launches = read_launches()
        st = t.last_serve
        if rc != 0 or st is None or st["requests"] != N_PROMPTS:
            raise AssertionError(f"serve_spec ({name}): CLI returned {rc}")
        lines = open(os.path.join(tmp, "gen_out.txt")).read().splitlines()
        got = [[int(x) for x in ln_.split()] for ln_ in lines]
        ties = []
        for g, want, mar in zip(got, plain, margins):
            if g == want:
                continue
            j = next(i for i, (a, b) in enumerate(zip(g, want)) if a != b)
            if len(g) != len(want) or mar[j] > 2 * noise:
                raise AssertionError(
                    f"serve_spec ({name}): a generation differs from plain "
                    f"greedy at position {j} (plain margin {mar[j]:.4f}, "
                    f"noise {noise:.4f})")
            ties.append((j, round(mar[j], 4)))
        worst, off_argmax = teacher_forced(task.net, prompts, got, noise)
        flag_fwd = st["prefill_calls"] + st["step_calls"] + st["block_calls"]
        draft_fwd = st["draft_prefill_calls"] + st["draft_step_calls"]
        what = ("the flagship's own snapshot" if name == "b" else
                f"d{DRAFT_DIM} x {DRAFT_LAYERS} layers")
        log(f"serve_spec ({name}): draft {what}, {st['requests']} "
            f"requests, {st['tokens']} tokens in {st['duration_sec']:.3f} s"
            f" = {st['tokens_per_sec']:.1f} tok/s; prefill p50 "
            f"{st.get('prefill_p50_ms', float('nan')):.2f} ms, "
            f"chunk p50 {st.get('chunk_p50_ms', float('nan')):.2f} ms, "
            f"round p50 {st['tok_p50_ms']:.2f} ms; accept rate "
            f"{st['acceptance_rate']:.4f}, {st['verify_calls']} verify "
            f"calls, {st['draft_steps']} draft steps, "
            f"{st.get('prefill_chunks', 0)} prefill chunks; draft "
            f"{st['draft_ms']:.1f} ms, verify {st['verify_ms']:.1f} ms; "
            f"{len(ties)} request(s) first differ from plain greedy at a "
            f"near-tie (position, plain margin: {ties}; noise "
            f"{noise:.4f}); teacher-forced through plain steps: "
            f"{off_argmax} of {sum(map(len, got))} emitted ids not the "
            f"row's argmax, largest shortfall {worst:.4f} (limit "
            f"{2 * noise:.4f}); retraces {st['retraces']}; CLI wall "
            f"{wall:.1f} s")
        log(f"serve_spec ({name}) launches: {launches} for {flag_fwd} "
            f"flagship and {draft_fwd} draft forwards")
        if st["retraces"] != 0:
            raise AssertionError(f"serve_spec ({name}): retraces")
        if name == "b" and st["acceptance_rate"] < SELF_DRAFT_ACCEPT:
            raise AssertionError(f"serve_spec (b): accept rate "
                                 f"{st['acceptance_rate']}")
        flash_min = dlayers * st["draft_prefill_calls"] \
            + NLAYER * st["prefill_calls"]
        if name == "a" and st["prefill_chunks"] < N_PROMPTS:
            raise AssertionError("serve_spec (a): no chunked prefill")
        if launches["flash_attention_fwd"] < flash_min \
                or st["draft_prefill_calls"] != N_PROMPTS:
            raise AssertionError(f"serve_spec ({name}): prefills did not all"
                                 " run the flash kernel")
        if launches["layernorm_fwd"] < (2 * NLAYER + 1) * flag_fwd \
                + (2 * dlayers + 1) * draft_fwd:
            raise AssertionError(f"serve_spec ({name}): forwards did not "
                                 "all run the layernorm kernel")
        total = {n: total[n] + launches[n] for n in KERNELS}
        del t
        torch.cuda.empty_cache()
    return total


def mnist_serve_args(tmp: str) -> list:
    """The CLI arguments of example/MNIST/serve.conf on the card from the
    mnist_conv phase's last snapshot (``input_flat = 0``, ``pool_layout =
    hwcn``, buckets BATCH_SHAPES, CLIENTS clients), the conf written
    into ``tmp`` with its data, output and metrics paths there."""
    data = os.path.join(tmp, "mnist")
    snap = os.path.join(tmp, "mnist_models", f"{MNIST_ROUNDS:04d}.model")
    text = open(os.path.join(REPO, "example", "MNIST", "serve.conf")).read()
    conf = os.path.join(tmp, "mnist_serve.conf")
    with open(conf, "w") as f:
        f.write(text.replace("./data/", data + "/")
                .replace("dev = cpu", f"dev = {DEV}")
                .replace("pred = serve_out.txt",
                         f"pred = {tmp}/serve_batch_out.txt")
                .replace("jsonl:serve_metrics.jsonl",
                         f"jsonl:{tmp}/serve_batch.jsonl"))
    return [conf, f"model_in={snap}", "input_flat=0", "pool_layout=hwcn",
            "serve_shapes=" + ",".join(map(str, BATCH_SHAPES)),
            f"serve_clients={CLIENTS}", "silent=1"]


def phase_serve_batch(tmp: str, test_error: float) -> dict:
    """``task = serve`` without ``serve_gen``: example/MNIST/serve.conf
    on the card from the mnist_conv phase's last snapshot (``input_flat =
    0``, ``pool_layout = hwcn``, buckets BATCH_SHAPES, CLIENTS clients),
    once for each ``serve_dtype``: f32, then bf16 and int8 with
    ``serve_calib = 2``.  f32 must agree with ``task = pred`` on
    BATCH_AGREE of the rows with an error within BATCH_ERR_F32 of the
    last round's test error; bf16 and int8 must pairtest within SERVE_TOL
    with an error within BATCH_ERR_QUANT of f32's; no run retraces, and
    every dispatch runs the max-pool kernel."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.serve.engine import SERVE_TOL
    labels = read_mnist_labels(os.path.join(tmp, "mnist",
                                            "t10k-labels-idx1-ubyte.gz"))
    base = mnist_serve_args(tmp)
    if LearnTask().run(base + ["task=pred"]) != 0:
        raise AssertionError("serve_batch: task = pred failed")
    pred = np.loadtxt(os.path.join(tmp, "serve_batch_out.txt"))
    reset_launches()
    dispatches, errs = 0, {}
    for dt in ("f32", "bf16", "int8"):
        extra = [f"serve_dtype={dt}"] + (["serve_calib=2"] if dt != "f32"
                                         else [])
        t = LearnTask()
        t0 = time.perf_counter()
        rc = t.run(base + extra)
        wall = time.perf_counter() - t0
        st = t.last_serve
        if rc != 0 or st is None:
            raise AssertionError(f"serve_batch ({dt}): CLI returned {rc}")
        out = np.loadtxt(os.path.join(tmp, "serve_batch_out.txt"))
        errs[dt] = float(np.mean(out != labels[:out.size]))
        agree = float(np.mean(out == pred))
        lat = t.net.metrics.histograms["serve_latency_sec"].summary()
        if dt == "f32":
            MEASURED["serve_batch_f32_p50_ms"] = lat["p50"] * 1e3
        eng = st["engine"]
        dispatches += eng["dispatches"]
        q = st["quant_rel_err"]
        log(f"serve_batch ({dt}): {st['requests']} requests in "
            f"{st['duration_sec']:.3f} s = {st['qps']:.1f} req/s; latency "
            f"p50 {lat['p50'] * 1e3:.3f} ms, p99 {lat['p99'] * 1e3:.3f} ms;"
            f" mean batch {st['mean_batch']}, buckets {eng['bucket_hist']},"
            f" pad rows {eng['pad_rows']}, {eng['dispatches']} dispatches;"
            f" error {errs[dt]:.6f}, agreement with task = pred {agree:.6f}"
            + (f", pairtest {q:.3e} (tol {SERVE_TOL[dt]})" if q is not None
               else "") + f"; retraces {st['retraces']}; CLI wall "
            f"{wall:.1f} s")
        if out.size != labels.size or st["retraces"] != 0:
            raise AssertionError(f"serve_batch ({dt}): {out.size} rows, "
                                 f"{st['retraces']} retraces")
        if dt == "f32" and (agree < BATCH_AGREE
                            or abs(errs[dt] - test_error) > BATCH_ERR_F32):
            raise AssertionError(f"serve_batch (f32): agreement {agree}, "
                                 f"error {errs[dt]} vs {test_error}")
        if dt != "f32" and (q is None or q > SERVE_TOL[dt] or abs(
                errs[dt] - errs["f32"]) > BATCH_ERR_QUANT):
            raise AssertionError(f"serve_batch ({dt}): pairtest {q}, error "
                                 f"{errs[dt]} vs f32's {errs['f32']}")
        del t
    launches = read_launches()
    log(f"serve_batch path launches: {launches} for {dispatches} "
        "dispatches (plus the buckets' warmup)")
    if launches["max_pool_fwd"] < dispatches:
        raise AssertionError("serve_batch: dispatches did not all run the "
                             "max-pool kernel")
    torch.cuda.empty_cache()
    return launches


def fresh(path: str) -> str:
    """``path``, with no file there (a metrics sink appends)."""
    if os.path.exists(path):
        os.remove(path)
    return path


def free_port() -> int:
    """A TCP port of this host that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: the scraper, a process of its own as a load balancer's health check
#: and a Prometheus server are: argv port, scrape period (s), 1 to poll
#: /readyz every millisecond, output path.  It writes a JSON line for each
#: change of /readyz's status and for each /metrics + /statusz scrape
#: until SIGTERM; nothing bound yet (or any more) is skipped
SCRAPER = r"""
import json, signal, sys, time, urllib.error, urllib.request
port, every, watch, out = (int(sys.argv[1]), float(sys.argv[2]),
                           sys.argv[3] == "1", sys.argv[4])
base = "http://127.0.0.1:%d" % port
stop = []
signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
print("started", flush=True)

def get(path, timeout=2.0):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()

with open(out, "w") as fo:
    t0 = time.perf_counter()
    nxt, last = t0, None
    while not stop:
        if watch:
            try:
                code = get("/readyz", 0.5)[0]
            except OSError:
                code = None
            if code is not None and code != last:
                fo.write(json.dumps({"readyz": code}) + "\n")
                fo.flush()          # ReadyGate reads it while we run
                last = code
        now = time.perf_counter()
        if now >= nxt:
            nxt = now + every
            try:
                mc, metrics = get("/metrics")
                sc, status = get("/statusz")
                fo.write(json.dumps({"t": now - t0, "codes": [mc, sc],
                                     "metrics": metrics,
                                     "statusz": status}) + "\n")
            except OSError:
                pass
        time.sleep(0.001 if watch else max(nxt - time.perf_counter(), 0.0))
"""


class Scraper:
    """SCRAPER in a subprocess over ``port`` for the ``with`` block: its
    /readyz statuses (``ready_seen``) and its scrapes (``scrapes``: time,
    /metrics text, /statusz dict) once it has stopped."""

    def __init__(self, tmp: str, port: int, every: float, watch: bool):
        self.args = [sys.executable, "-c", SCRAPER, str(port), str(every),
                     "1" if watch else "0",
                     os.path.join(tmp, f"scrapes_{port}.jsonl")]
        self.proc = None
        self.ready_seen: list = []
        self.scrapes: list = []

    def __enter__(self):
        # the run starts once the scraper polls, so that it sees warmup
        self.proc = subprocess.Popen(self.args, stdout=subprocess.PIPE,
                                     text=True)
        if self.proc.stdout.readline().strip() != "started":
            raise AssertionError("serve_admin: the scraper did not start")
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()
        for line in open(self.args[-1]):
            rec = json.loads(line)
            if "readyz" in rec:
                self.ready_seen.append(rec["readyz"])
            elif rec["codes"] != [200, 200]:
                raise AssertionError(f"serve_admin: scrape answered "
                                     f"{rec['codes']}")
            else:
                self.scrapes.append((rec["t"], rec["metrics"],
                                     json.loads(rec["statusz"])))
        return False


class ReadyGate:
    """``ModelHost.mark_ready`` held, inside the ``with`` block, until the
    /readyz watcher on ``port`` has written its first status (at most
    ``timeout`` s): a warmup shorter than one of the watcher's polls
    (a /metrics scrape in between, or a handler thread that gets the GIL
    only after warmup) would else show it no 503.  What the endpoint
    answers is untouched: a 200 before ready is still seen as such."""

    def __init__(self, tmp: str, port: int, timeout: float = 30.0):
        self.path = os.path.join(tmp, f"scrapes_{port}.jsonl")
        self.timeout = timeout

    def watched(self) -> bool:
        try:
            with open(self.path) as f:
                return '"readyz"' in f.read()
        except OSError:
            return False

    def __enter__(self):
        from cxxnet_tpu_torch.serve.host import ModelHost
        self._orig = orig = ModelHost.mark_ready
        gate = self

        def mark_ready(host):
            end = time.monotonic() + gate.timeout
            while not gate.watched() and time.monotonic() < end:
                time.sleep(0.001)
            return orig(host)
        ModelHost.mark_ready = mark_ready
        return self

    def __exit__(self, *exc):
        from cxxnet_tpu_torch.serve.host import ModelHost
        ModelHost.mark_ready = self._orig
        return False


def admin_run(tmp: str, args: list, every: float = 0.0,
              watch: bool = False, port: int = 0):
    """One port CLI run of ``args`` plus ``serve_admin_port`` (``port``,
    else a free one); with ``every`` (s) or ``watch`` under a Scraper.
    Returns (task, scraper or None, port); the endpoint must be closed
    after the run."""
    from cxxnet_tpu_torch.main import LearnTask
    port = port or free_port()
    task = LearnTask()
    args = args + [f"serve_admin_port={port}"]
    if every or watch:
        with Scraper(tmp, port, every or 3600.0, watch) as scraper:
            rc = task.run(args)
    else:
        scraper = None
        rc = task.run(args)
    if rc != 0 or task.last_serve is None:
        raise AssertionError(f"serve_admin: CLI returned {rc}")
    import urllib.request
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=0.5).close()
    except OSError:
        return task, scraper, port
    raise AssertionError("serve_admin: the endpoint outlived the host")


def check_counters_monotone(scrapes: list, label: str) -> None:
    """Every /metrics scrape parses (the port's promtext) and no counter
    falls between two scrapes."""
    from cxxnet_tpu_torch.monitor import promtext
    prev: dict = {}
    for _, text, _ in scrapes:
        vals = promtext.counter_values(promtext.parse(text))
        fell = {k: (prev[k], v) for k, v in vals.items()
                if k in prev and v < prev[k]}
        if fell:
            raise AssertionError(f"serve_admin {label}: counters fell "
                                 f"between scrapes: {fell}")
        prev.update(vals)


def check_flights(recs: list, label: str, reason: str,
                  one: bool = True) -> list:
    """The ``serve_flight`` records in ``recs`` (exactly one if ``one``,
    else at least one), each with a reason starting with ``reason`` and
    at least ADMIN_FLIGHT boosted requests.  A flight counts the requests
    served after it armed, those admitted before it too (untraced: at
    most CLIENTS, one a closed-loop client), and a request still in
    flight when it restored the rate emits no more spans (again at most
    CLIENTS): so its trace-id range holds at least ``requests_boosted -
    CLIENTS`` ids, all but at most CLIENTS with a ``request`` span.
    trace_sample is 0 outside the boosts, so every span id lies in a
    flight's range.  Returns them."""
    flights = [r for r in recs if r["kind"] == "serve_flight"]
    if not flights or (one and len(flights) != 1) \
            or not all(f["reason"].startswith(reason) for f in flights):
        raise AssertionError(f"serve_admin {label}: serve_flight records "
                             f"{[f['reason'] for f in flights]}, not "
                             f"{'one' if one else 'all'} '{reason} ...'")
    span_ids = {r.get("trace_id") for r in recs if r["kind"] == "span"}
    requests = {r["trace_id"] for r in recs
                if r["kind"] == "span" and r["span"] == "request"}
    every: set = set()
    for f in flights:
        ids = set(range(f["trace_first"], f["trace_last"] + 1))
        every |= ids
        log(f"serve_admin {label}: flight ({f['reason']}) ids "
            f"{f['trace_first']}..{f['trace_last']}, "
            f"{len(requests & ids)} with a request span, "
            f"{len(ids - requests)} cut by the restore")
        if not f["trace_first"] or f["requests_boosted"] < ADMIN_FLIGHT \
                or len(ids) < f["requests_boosted"] - CLIENTS \
                or len(ids - requests) > CLIENTS:
            raise AssertionError(f"serve_admin {label}: flight {f}: "
                                 f"{len(requests & ids)} request spans in "
                                 "it")
    if not span_ids - {None} <= every:
        raise AssertionError(f"serve_admin {label}: span ids "
                             f"{sorted(span_ids - {None} - every)[:5]} "
                             "outside every flight's range")
    return flights


def check_windows(wins: list, srv: dict, label: str) -> None:
    """The ``serve_window`` records hold every served row, one a window
    (the run's duration over ADMIN_WINDOW, give or take two)."""
    expect = srv["duration_sec"] / ADMIN_WINDOW + 1
    if sum(w["requests"] for w in wins) != srv["rows"] \
            or not expect - 2 <= len(wins) <= expect + 2:
        raise AssertionError(
            f"serve_admin {label}: {len(wins)} windows (about {expect:.1f} "
            f"expected) holding {sum(w['requests'] for w in wins)} "
            f"requests for {srv['rows']} rows")


def check_pool_launches(launches: dict, st: dict, label: str) -> None:
    """One max-pool forward a dispatch, one a bucket at warmup."""
    if launches["max_pool_fwd"] != st["engine"]["dispatches"] \
            + len(BATCH_SHAPES):
        raise AssertionError(f"serve_admin {label}: "
                             f"{launches['max_pool_fwd']} max-pool launches "
                             f"for {st['engine']['dispatches']} dispatches")


def admin_batch(tmp: str) -> dict:
    """(a): serve.conf on the card with the admin endpoint, the sentinels,
    an SLO below serve_batch's f32 p50 and the flight capture, under a
    scraper that polls /readyz every millisecond; returns the launches
    of the run."""
    import torch
    sink = fresh(os.path.join(tmp, "serve_admin.jsonl"))
    slo = ADMIN_SLO_SHARE * MEASURED["serve_batch_f32_p50_ms"]
    args = mnist_serve_args(tmp) + [
        "serve_dtype=f32", f"metrics_sink=jsonl:{sink}", "serve_sentinel=1",
        f"serve_sentinel_window={ADMIN_WINDOW}",
        f"sentinel_rel={ADMIN_SENTINEL_REL}",
        f"serve_flight_requests={ADMIN_FLIGHT}", f"serve_slo_p99_ms={slo}"]
    reset_launches()
    port = free_port()
    with ReadyGate(tmp, port):
        task, scraper, port = admin_run(tmp, args, 1.0 / ADMIN_SCRAPE_HZ,
                                        watch=True, port=port)
    launches = read_launches()
    st = task.last_serve
    recs = read_records(sink)
    kinds = [r["kind"] for r in recs]
    wins = [r for r in recs if r["kind"] == "serve_window"]
    slos = [r for r in recs if r["kind"] == "slo"]
    flights = [r for r in recs if r["kind"] == "serve_flight"]
    (srv,) = [r for r in recs if r["kind"] == "serve"]
    ready = [sc for sc in scraper.scrapes if sc[2]["ready"]]
    log(f"serve_admin (a): port {port}; /readyz {scraper.ready_seen}; "
        f"{len(scraper.scrapes)} scrapes ({len(ready)} while ready); "
        f"{st['requests']} requests in {st['duration_sec']:.3f} s = "
        f"{st['qps']:.1f} req/s, {st['engine']['dispatches']} dispatches, "
        f"retraces {st['retraces']}; SLO p99 {slo:.3f} ms; "
        f"{len(wins)} serve_window records (requests "
        f"{[w['requests'] for w in wins]}, viol "
        f"{[w.get('viol') for w in wins]}); slo records "
        f"{[(r['tier'], r['burn']) for r in slos]}; anomalies "
        f"{kinds.count('anomaly')}; serve_flight "
        f"{[(f['reason'], f['requests_boosted']) for f in flights]}")
    seen = scraper.ready_seen
    # after the run admin_run found the socket closed
    if 503 not in seen or 200 not in seen \
            or seen.index(503) > seen.index(200):
        raise AssertionError(f"serve_admin (a): /readyz answered {seen}: "
                             "not 503 before 200")
    if not ready:
        raise AssertionError("serve_admin (a): no scrape while ready")
    check_counters_monotone(scraper.scrapes, "(a)")
    last = ready[-1][2]["models"].get("default", {})
    if "last_window" not in last or last.get("kind") != "predict":
        raise AssertionError(f"serve_admin (a): /statusz {ready[-1][2]}")
    check_windows(wins, srv, "(a)")
    if not any(r["tier"] == "fast" for r in slos):
        raise AssertionError("serve_admin (a): no fast slo record")
    check_flights(recs, "(a)", "slo:")
    if st["retraces"] != 0 or srv["retraces"] != 0:
        raise AssertionError("serve_admin (a): retraces")
    check_pool_launches(launches, st, "(a)")
    torch.cuda.empty_cache()
    return launches


def admin_cost_args(tmp: str, sink: str, rows: int) -> list:
    """mnist_serve_args at f32 over ``rows`` seeded test rows (made on the
    first call for that count), writing to the sink ``sink``."""
    data = os.path.join(tmp, f"mnist_cost{rows}")
    if not os.path.exists(data):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "make_synth_mnist.py"),
                        "--out", data, "--train", "1",
                        "--test", str(rows)],
                       check=True, capture_output=True)
    args = mnist_serve_args(tmp) + ["serve_dtype=f32",
                                    f"metrics_sink=jsonl:{sink}"]
    text = open(args[0]).read().replace(os.path.join(tmp, "mnist") + "/",
                                        data + "/")
    args[0] = os.path.join(tmp, f"mnist_serve_cost{rows}.conf")
    with open(args[0], "w") as f:
        f.write(text)
    return args


class LatencyLog:
    """Every ``serve_latency_sec`` observation made inside the ``with``
    block (``values``): the histogram keeps a 2048-value reservoir, so
    its percentiles over a longer run are estimates."""

    def __enter__(self):
        from cxxnet_tpu_torch.monitor.metrics import Metrics
        self.values: list = []
        self._orig = orig = Metrics.observe
        values = self.values

        def observe(metrics, name, value):
            if name == "serve_latency_sec":
                values.append(value)
            orig(metrics, name, value)
        Metrics.observe = observe
        return self

    def __exit__(self, *exc):
        from cxxnet_tpu_torch.monitor.metrics import Metrics
        Metrics.observe = self._orig
        return False


def spread(vals: list) -> float:
    """(max - min) / mean, in %."""
    return 100.0 * (max(vals) - min(vals)) / (sum(vals) / len(vals))


def admin_scrape_cost(tmp: str) -> dict:
    """serve.conf over ADMIN_SCRAPE_ROWS seeded test rows with the admin
    endpoint on, without a scraper (A) and with a scraper of /metrics and
    /statusz at ADMIN_SCRAPE_HZ (B), A B B A; prints each run's qps and
    its exact latency p50 / p99 over every request (the reservoir's
    estimates beside them); returns the runs' launches."""
    from cxxnet_tpu_torch.monitor.metrics import nearest_rank
    sink = os.path.join(tmp, "serve_admin_cost.jsonl")
    args = admin_cost_args(tmp, sink, ADMIN_SCRAPE_ROWS)
    reset_launches()
    rows = []
    for label in "ABBA":
        fresh(sink)
        with LatencyLog() as lat:
            task, scraper, _ = admin_run(
                tmp, args, 1.0 / ADMIN_SCRAPE_HZ if label == "B" else 0.0)
        st = task.last_serve
        est = task.net.metrics.histograms["serve_latency_sec"].summary()
        exact = sorted(lat.values)
        rows.append((label, st["qps"], nearest_rank(exact, 50) * 1e3,
                     nearest_rank(exact, 99) * 1e3, est["p50"] * 1e3,
                     est["p99"] * 1e3,
                     len(scraper.scrapes) if scraper else 0))
        if scraper is not None:
            check_counters_monotone(scraper.scrapes, "scrape cost")
        if st["retraces"] != 0 or st["requests"] != ADMIN_SCRAPE_ROWS \
                or len(exact) != ADMIN_SCRAPE_ROWS:
            raise AssertionError(f"serve_admin: {st['requests']} requests "
                                 f"({len(exact)} latencies), "
                                 f"{st['retraces']} retraces")
        del task
    log(f"serve_admin scrape cost ({ADMIN_SCRAPE_ROWS} requests a run; A: no "
        f"scraper, B: /metrics + /statusz at {ADMIN_SCRAPE_HZ} Hz from "
        "another process; p50 / p99 exact over every request, the "
        "2048-value reservoir's in brackets), A B B A: " + "; ".join(
            f"{lb} {q:.1f} req/s p50 {p50:.3f} ms p99 {p99:.3f} ms "
            f"[{e50:.3f} / {e99:.3f}] ({n} scrapes)"
            for lb, q, p50, p99, e50, e99, n in rows)
        + f"; A's qps spread {spread([r[1] for r in rows[::3]]):.2f}%, "
        f"B's {spread([r[1] for r in rows[1:3]]):.2f}%")
    return read_launches()


def admin_anomaly(tmp: str) -> dict:
    """(c): ADMIN_STALL_ROWS test rows with the sentinels at ADMIN_STALL_REL,
    no SLO, and the card stalled for ~ADMIN_STALL_SEC (matmuls queued on
    the default stream from another thread) ADMIN_STALL_AFTER s after
    /readyz turns 200: no p99 or qps anomaly before the stall, a
    ``serve_p99_ms`` anomaly after it and a ``serve_flight`` armed by it;
    every flight armed by an anomaly (the queue-depth sentinel may arm
    more), with its spans in its range.  Returns the run's launches."""
    import threading
    import urllib.request
    import torch
    sink = fresh(os.path.join(tmp, "serve_admin_stall.jsonl"))
    args = admin_cost_args(tmp, sink, ADMIN_STALL_ROWS) + [
        "serve_sentinel=1", f"serve_sentinel_window={ADMIN_WINDOW}",
        f"sentinel_rel={ADMIN_STALL_REL}",
        f"serve_flight_requests={ADMIN_FLIGHT}"]
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(a)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.mm(a, a, out=out)
    ev[0].record()
    for _ in range(10):
        torch.mm(a, a, out=out)
    ev[1].record()
    ev[1].synchronize()
    n_mm = max(1, round(ADMIN_STALL_SEC * 1e3 / (ev[0].elapsed_time(ev[1])
                                                 / 10)))
    port, done, stall = free_port(), threading.Event(), {}

    def inject():
        while not done.is_set():
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                       timeout=0.5).close()
                break
            except OSError:          # nothing bound yet, or 503
                done.wait(0.005)
        if done.wait(ADMIN_STALL_AFTER):
            return
        stall["t0"] = time.time()
        ev[2].record()
        for _ in range(n_mm):
            torch.mm(a, a, out=out)
        ev[3].record()
        stall["queued"] = True

    injector = threading.Thread(target=inject, name="cxxnet-smoke-stall")
    injector.start()
    reset_launches()
    try:
        task, _, _ = admin_run(tmp, args, port=port)
    finally:
        done.set()
        injector.join()
    launches = read_launches()
    if not stall.get("queued"):
        raise AssertionError("serve_admin (c): the run ended before the "
                             "stall")
    ev[3].synchronize()
    st = task.last_serve
    recs = read_records(sink)
    wins = [r for r in recs if r["kind"] == "serve_window"]
    hits = [r for r in recs if r["kind"] == "anomaly"]
    (srv,) = [r for r in recs if r["kind"] == "serve"]
    log(f"serve_admin (c): {st['requests']} requests in "
        f"{st['duration_sec']:.3f} s = {st['qps']:.1f} req/s; a stall of "
        f"{n_mm} matmuls ({ev[2].elapsed_time(ev[3]):.1f} ms on the card) "
        f"{ADMIN_STALL_AFTER} s after ready; {len(wins)} serve_window "
        f"records, p99 ms {[w.get('p99_ms') for w in wins]}; anomalies "
        f"{[(h['metric'], h['value'], h['ewma'], h['rel_dev']) for h in hits]}"
        f" at {[round(h['ts'] - stall['t0'], 3) for h in hits]} s from the "
        "stall")
    check_windows(wins, srv, "(c)")
    t0 = round(stall["t0"], 3) - 0.001
    p99 = [h["ts"] for h in hits if h["metric"] == "serve_p99_ms"]
    if any(h["ts"] < t0 for h in hits if h["metric"] != "serve_queue_depth") \
            or not p99 or p99[0] < t0:
        raise AssertionError("serve_admin (c): a p99 or qps anomaly before "
                             "the stall, or no serve_p99_ms anomaly after it")
    flights = check_flights(recs, "(c)", "anomaly:", one=False)
    # one flight a storm, armed by its first anomaly: the stall's storm
    # may open with the queue it stands up, before the p99 of the
    # requests it held
    first = min((h for h in hits if h["ts"] >= t0), key=lambda h: h["ts"])
    reason = (f"anomaly: {first['metric']} {first['direction']} "
              f"{first['rel_dev']:+.0%}")
    if not any(f["ts"] >= first["ts"] and f["reason"] == reason
               for f in flights):
        raise AssertionError(f"serve_admin (c): the stall's first anomaly "
                             f"({reason}) armed no flight")
    if st["retraces"] != 0 or srv["retraces"] != 0:
        raise AssertionError("serve_admin (c): retraces")
    check_pool_launches(launches, st, "(c)")
    del a, out, task
    torch.cuda.empty_cache()
    return launches


def admin_gen_conf(tmp: str, serve_conf: str) -> str:
    """The serve phase's LM conf over ADMIN_GEN_PROMPTS seeded prompts
    (its length range), with its own output and sink; returns the path."""
    from cxxnet_tpu_torch.io.text import write_token_shard
    rng = np.random.RandomState(13)
    lens = rng.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1, ADMIN_GEN_PROMPTS)
    write_token_shard(os.path.join(tmp, "prompts_admin.tok"),
                      [rng.randint(0, VOCAB, n) for n in lens], itemsize=2)
    text = open(serve_conf).read()
    for old, new in (("prompts.tok", "prompts_admin.tok"),
                     ("gen_out.txt", "gen_admin_out.txt"),
                     ("serve_metrics.jsonl", "serve_admin_gen.jsonl")):
        if os.path.join(tmp, old) not in text:
            raise AssertionError(f"serve_admin (b): {old} not in the conf")
        text = text.replace(os.path.join(tmp, old), os.path.join(tmp, new))
    conf = os.path.join(tmp, "serve_admin_gen.conf")
    with open(conf, "w") as f:
        f.write(text)
    return conf


def admin_generate(tmp: str, serve_conf: str) -> dict:
    """(b): the LM serve of the serve phase over ADMIN_GEN_PROMPTS prompts
    with the admin endpoint, without (A) and with (B) a scraper at
    ADMIN_SCRAPE_HZ, A B B A: in each B run /statusz says kind = generate
    with tokens, steps and the occupancy histogram, and /metrics carries
    decode_occupancy_hist buckets; every prefill runs row 7 and every
    forward row 11.  Prints each run's tok/s; returns the runs'
    launches."""
    import torch
    from cxxnet_tpu_torch.monitor import promtext
    conf = admin_gen_conf(tmp, serve_conf)
    reset_launches()
    prefills = steps = 0
    rows = []
    for label in "ABBA":
        fresh(os.path.join(tmp, "serve_admin_gen.jsonl"))
        task, scraper, port = admin_run(
            tmp, [conf], 1.0 / ADMIN_SCRAPE_HZ if label == "B" else 0)
        st = task.last_serve
        prefills += st["prefill_calls"]
        steps += st["step_calls"]
        rows.append((label, st["tokens_per_sec"], st["tokens"],
                     st["duration_sec"], st["tok_p50_ms"],
                     len(scraper.scrapes) if scraper else 0))
        if st["retraces"] != 0 or st["requests"] != ADMIN_GEN_PROMPTS:
            raise AssertionError(f"serve_admin (b): {st['requests']} "
                                 f"requests, {st['retraces']} retraces")
        del task
        if scraper is None:
            continue
        ready = [sc for sc in scraper.scrapes if sc[2]["ready"]
                 and sc[2]["models"].get("default", {}).get("steps")]
        if not ready:
            raise AssertionError(f"serve_admin (b): no scrape while "
                                 f"generating ({len(scraper.scrapes)} "
                                 "scrapes)")
        check_counters_monotone(scraper.scrapes, "(b)")
        _, text, status = ready[-1]
        m = status["models"]["default"]
        occ = promtext.parse(text).get("cxxnet_decode_occupancy_hist", {})
        buckets = [sm for sm in occ.get("samples", ())
                   if sm[0].endswith("_bucket")]
        log(f"serve_admin (b): port {port}; {len(ready)} scrapes while "
            f"generating; last /statusz: kind {m.get('kind')}, requests "
            f"{m.get('requests')}, tokens {m.get('tokens')}, steps "
            f"{m.get('steps')}, prefills {m.get('prefills')}, occupancy "
            f"{m.get('occupancy_hist')}")
        if m.get("kind") != "generate" or not m.get("tokens") \
                or not m.get("occupancy_hist") \
                or occ.get("type") != "histogram" or not buckets \
                or buckets[-1][1].get("le") != "+Inf":
            raise AssertionError(f"serve_admin (b): /statusz {m}, "
                                 f"occupancy family {occ}")
    launches = read_launches()
    a_mean = (rows[0][1] + rows[3][1]) / 2
    log(f"serve_admin (b) scrape cost ({ADMIN_GEN_PROMPTS} requests a run; "
        f"A: no scraper, B: /metrics + /statusz at {ADMIN_SCRAPE_HZ} Hz "
        "from another process), A B B A: " + "; ".join(
            f"{lb} {tps:.1f} tok/s ({tok} tokens in {dur:.3f} s, step p50 "
            f"{p50:.2f} ms; {n} scrapes)"
            for lb, tps, tok, dur, p50, n in rows)
        + f"; A's spread {spread([rows[0][1], rows[3][1]]):.2f}%, B "
        f"{100 * (rows[1][1] / a_mean - 1):+.2f}% / "
        f"{100 * (rows[2][1] / a_mean - 1):+.2f}% against A's mean")
    if launches["flash_attention_fwd"] < NLAYER * prefills \
            or launches["layernorm_fwd"] \
            < (2 * NLAYER + 1) * (prefills + steps):
        raise AssertionError("serve_admin (b): prefills / forwards not "
                             "through rows 7 / 11")
    torch.cuda.empty_cache()
    return launches


def phase_serve_admin(tmp: str, serve_conf: str) -> dict:
    """Phase 22 (``serve_admin``): (a) the micro-batched path with the
    admin endpoint, the sentinels, an SLO and the flight capture, and
    the scrape's cost A B B A; (c) a stall of the card caught by the
    serve sentinels; (b) the LM serve with the endpoint, and the
    scrape's cost A B B A there.  Returns the path's launches (each
    part's counted from 0)."""
    parts = [admin_batch(tmp), admin_scrape_cost(tmp), admin_anomaly(tmp),
             admin_generate(tmp, serve_conf)]
    launches = {n: sum(p[n] for p in parts) for n in KERNELS}
    log(f"serve_admin path launches: {launches}")
    return launches


def device_busy_sec(prof, steps: int) -> float:
    """The union of the device events (kernels, copies, fills) of a
    finished ``torch.profiler`` run, over ``steps``: the busy time
    ``report_profile`` reads, from the profiler's own events."""
    from torch.autograd import DeviceType
    ivs = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    return union_us(ivs) / 1e6 / max(steps, 1)


def orphan_launches(events) -> str:
    """The kernel launches of a trace whose device event is not in it
    (the launch's ``correlation`` names no kernel), each with its time
    from the trace's first launch and the thread that made it, and the
    least time from a launch to its kernel's start (below 0: the card's
    clock, as the trace reads it, lags the host's)."""
    from cxxnet_tpu_torch.monitor.trace import LAUNCH_CATS
    kern = {(e.get("args") or {}).get("correlation") for e in events
            if e.get("cat") == "kernel"}
    launch = sorted((e for e in events if e.get("cat") in LAUNCH_CATS
                     and "LaunchKernel" in e.get("name", "")),
                    key=lambda e: e["ts"])
    lost = [e for e in launch
            if (e.get("args") or {}).get("correlation") not in kern]
    t0 = launch[0]["ts"] if launch else 0.0
    at = {(e.get("args") or {}).get("correlation"): e["ts"] for e in launch}
    lead = [e["ts"] - at[c] for e in events if e.get("cat") == "kernel"
            for c in [(e.get("args") or {}).get("correlation")] if c in at]
    return (f"{len(launch)} kernel launches in the trace, {len(kern)} "
            f"kernels (start minus launch from "
            f"{min(lead, default=0.0) / 1e3:.3f} ms), {len(lost)} launches "
            f"without their kernel"
            + "".join(f"; {e['name']} at {(e['ts'] - t0) / 1e3:.3f} ms "
                      f"(thread {e.get('tid')})" for e in lost[:10]))


def check_attribution(events, scopes) -> dict:
    """Where layer attribution put the hand-written kernels of a train
    window: the segmented flash forward and backward (rows 9, 10) under
    the attention connections, the layernorm forward and backward (rows
    11, 12) under the layernorm connections, the backward ones through
    the autograd join, and the fused adam kernel (row 13) in
    (unattributed).  Returns ``{row: {scope kind: count}}``."""
    from cxxnet_tpu_torch.monitor import attribution
    from cxxnet_tpu_torch.monitor.trace import kernel_base
    rows = {9: ("flash_fwd", "_att", False), 10: ("flash_bwd", "_att", True),
            11: ("layernorm_fwd", "_ln", False), 12: ("lnb_", "_ln", True),
            13: ("fused_adam_kernel", None, False)}
    seen = {r: {} for r in rows}
    bases = set()
    for p in attribution.attribute_events(events, scopes):
        base = kernel_base(p["name"])
        bases.add(base)
        for r, (prefix, part, bwd) in rows.items():
            if not base.startswith(prefix):
                continue
            where = p["scope"] if p["scope"] is None else \
                ("bwd " if p["backward"] else "fwd ") + p["scope"][3:]
            seen[r][where] = seen[r].get(where, 0) + 1
            ok = (p["scope"] is None) if part is None else (
                p["scope"] is not None and part in p["scope"]
                and p["backward"] == bwd)
            if not ok:
                raise AssertionError(
                    f"observe: row {r} kernel {base} placed in "
                    f"{p['scope']} (backward {p['backward']})")
    missing = [r for r, s in seen.items() if not s]
    if missing:
        raise AssertionError(f"observe: no kernel of rows {missing} in the "
                             f"window's trace, which holds {sorted(bases)}")
    return seen


class PoisonRound:
    """The train iterator with one batch of round ``rnd`` NaN-poisoned,
    once (the divergence injection of tests/test_ckpt.py); its state is
    its base's."""

    def __init__(self, base, rnd: int, at: int):
        self.base, self.rnd, self.at = base, rnd, at
        self.passes = self.count = 0
        self.fired = False

    def before_first(self):
        self.passes += 1
        self.count = 0
        self.base.before_first()

    def next(self):
        import dataclasses
        b = self.base.next()
        if b is None:
            return None
        self.count += 1
        if (not self.fired and self.passes == self.rnd
                and self.count == self.at):
            self.fired = True
            b = dataclasses.replace(b, data=np.full_like(b.data, np.nan))
        return b

    def state(self):
        return self.base.state()

    def set_state(self, st):
        self.base.set_state(st)

    def close(self):
        self.base.close()


def observe_window(tmp: str, attempt: int = 1) -> None:
    """(a) The packed LM of ``train_fused`` at full width and depth with
    the plane on: ``monitor = 1 monitor_interval = 2``, a profile window
    over dispatches OBSERVE_PROF, ``sentinel = 1``, ``trace_sample = 1``,
    ``ckpt_async = 1`` (parameters only), ``prefetch_device = 2`` and a
    sink.  The ``trace`` record's device_sec within OBSERVE_DEVICE_TOL of
    the window's own profiler events, with no event of a hand-written
    kernel lost; rows 9-13 where attribution must put them; a finite
    ``monitor`` record a parameter leaf a tick; the ledger's categories
    tiling its wall within OBSERVE_LEDGER_TOL; the prefetcher's and the
    writer's spans present; no ``anomaly`` or ``flight`` record from the
    healthy run.  A window whose trace lost events of a hand-written
    kernel (the trace record then has no device_sec, rightly) is run
    once more, as ``device_ms`` retakes such traces."""
    import shutil
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.monitor import trace
    conf = lm_train_conf(tmp, "observe", True, NLAYER, NHEAD, TRAIN_STEPS,
                         True)
    sink = fresh(os.path.join(tmp, f"observe_metrics_{attempt}.jsonl"))
    start, num = OBSERVE_PROF
    args = ["monitor=1", f"monitor_interval={OBSERVE_MONITOR_INTERVAL}",
            f"prof={tmp}/observe_prof_{attempt}",
            f"prof_start_step={start}",
            f"prof_num_steps={num}", "sentinel=1", "trace_sample=1",
            "ckpt_async=1", "save_model=1", "save_opt=0",
            f"model_dir={tmp}/observe_models_{attempt}", "prefetch_device=2",
            f"metrics_sink=jsonl:{sink}"]
    log(f"observe (a): {' '.join(args)}")
    torch.cuda.empty_cache()
    task = LearnTask()
    t0 = time.perf_counter()
    rc = task.run([conf] + args)
    wall = time.perf_counter() - t0
    st = task.last_train
    if rc != 0 or st is None or st["steps"] != TRAIN_STEPS:
        raise AssertionError(f"observe (a): CLI returned {rc}")
    recs = read_records(sink)
    kinds = {}
    for r in recs:
        kinds.setdefault(r["kind"], []).append(r)
    log(f"observe (a): {TRAIN_STEPS} steps, losses "
        f"{[round(x, 4) for x in st['losses']]}, step ms "
        f"{[round(x, 1) for x in st['step_ms']]} (window over steps "
        f"{start + 1}-{start + num}, ticks every {OBSERVE_MONITOR_INTERVAL}"
        f"), p50 {st['step_p50_ms']:.1f} ms, compile "
        f"{st['compile_sec']:.2f} s, "
        f"CLI wall {wall:.1f} s; records "
        f"{ {k: len(v) for k, v in sorted(kinds.items())} }")
    (tr,) = kinds.get("trace", [None])
    rep = task.last_trace_report
    win = task.prof_window
    own = device_busy_sec(win.last_profiler, win.last_window_steps)
    events = trace.load_trace(win.last_trace)
    log("observe (a): " + orphan_launches(events))
    log(f"observe (a): trace record {json.dumps(tr, sort_keys=True)}; "
        f"window launches {rep['launches']} "
        f"({ {k: n for k, n in win.last_launches.items() if n} }), lost "
        f"events {rep['lost_events']} (short: {rep['short']}); the "
        f"profiler's own device busy {own * 1e3:.3f} ms a step")
    if rep["lost_events"] and attempt == 1 and tr is not None \
            and "device_sec" not in tr:
        log("observe (a): the profiler lost events of the window; run "
            "again")
        del task
        torch.cuda.empty_cache()
        shutil.rmtree(f"{tmp}/observe_models_1", ignore_errors=True)
        return observe_window(tmp, attempt=2)
    if tr is None or "device_sec" not in tr or tr["steps"] != num \
            or rep["lost_events"]:
        raise AssertionError(f"observe (a): trace record {tr}")
    if abs(tr["device_sec"] - own) > OBSERVE_DEVICE_TOL * own:
        raise AssertionError(f"observe (a): device_sec {tr['device_sec']} "
                             f"vs the profiler's {own}")
    (lp,) = kinds.get("layer_profile", [None])
    log(f"observe (a): layer_profile {lp['device_total_ms']} ms a step, "
        f"{lp['attributed_ms']} attributed (coverage {lp['coverage']}); "
        "top rows: " + "; ".join(
            f"{r['layer']} {r['device_ms']} ms (bwd {r['bwd_ms']})"
            for r in lp["rows"][:8]))
    observe_costs(lp, task.net)
    observe_memory(kinds.get("mem_profile", []), task.net)
    seen = check_attribution(trace.window_events(events),
                             task.net.layer_scopes())
    log("observe (a): kernels by connection: " + "; ".join(
        f"row {r}: {len(s)} places, {sum(s.values())} events"
        + (" (unattributed)" if None in s else "")
        for r, s in seen.items()))
    leaves = sorted(f"{k}/{t}" for k, g in task.net.params.items() for t in g)
    ticks = {}
    for r in kinds.get("monitor", []):
        ticks.setdefault(r["step"], []).append(r)
        if not all(np.isfinite(r[f]) for f in ("w_norm", "g_norm", "u_norm",
                                                "u_ratio")):
            raise AssertionError(f"observe (a): non-finite monitor {r}")
    want = list(range(OBSERVE_MONITOR_INTERVAL, TRAIN_STEPS + 1,
                      OBSERVE_MONITOR_INTERVAL))
    if sorted(ticks) != want or any(
            sorted(r["layer"] for r in rs) != leaves
            for rs in ticks.values()):
        raise AssertionError(f"observe (a): monitor ticks {sorted(ticks)} "
                             f"(want {want}, {len(leaves)} leaves each)")
    last = ticks[want[-1]]
    log(f"observe (a): {len(leaves)} leaves a tick at steps {want}; at step "
        f"{want[-1]} u/w from {min(r['u_ratio'] for r in last):.3e} to "
        f"{max(r['u_ratio'] for r in last):.3e}")
    led = recs[-1]
    tiled = sum(led.get("categories", {}).values())
    log(f"observe (a): ledger {json.dumps(led, sort_keys=True)}")
    if led["kind"] != "ledger" or abs(tiled - led["wall_sec"]) \
            > OBSERVE_LEDGER_TOL * led["wall_sec"]:
        raise AssertionError(f"observe (a): ledger categories {tiled} s vs "
                             f"wall {led.get('wall_sec')} s")
    spans = {}
    for r in kinds.get("span", []):
        spans.setdefault(r["span"], []).append(r["dur_us"] / 1e3)
    log("observe (a): spans " + "; ".join(
        f"{k} x{len(v)} p50 {np.median(v):.3f} ms max {max(v):.3f} ms"
        for k, v in sorted(spans.items())))
    need = {"prefetch_stage", "prefetch_wait", "ckpt_blocked", "ckpt_shard",
            "ckpt_manifest", "ckpt_prune"}
    if not need <= set(spans):
        raise AssertionError(f"observe (a): spans {sorted(spans)} lack "
                             f"{sorted(need - set(spans))}")
    anomalies = kinds.get("anomaly", [])
    log(f"observe (a): step records' examples/s "
        f"{[r['examples_per_sec'] for r in kinds['step']]}; sentinel "
        f"anomalies {len(anomalies)} {anomalies}, flight records "
        f"{len(kinds.get('flight', []))}, the run's peak memory "
        f"{task.net.memory_gauges()['hbm_peak_bytes'] / 2 ** 30:.2f} GiB "
        "(the allocator's high-water across the mem probe's reset)")
    if anomalies or kinds.get("flight"):
        raise AssertionError("observe (a): a healthy run set off the "
                             "sentinel")
    del task
    torch.cuda.empty_cache()


def observe_costs(lp: dict, tr) -> None:
    """(a) The ``layer_profile`` record's cost columns: every connection
    row carries the cost model's ``flops`` / ``bytes`` and, against the
    card's peaks, ``mfu_pct``, ``roofline_ms`` and ``roofline_x``
    (finite; positive but ``mfu_pct``); prints the rows with the most
    device time."""
    scopes = set(tr.layer_scopes())
    rows = [r for r in lp["rows"] if r["layer"] in scopes]
    cols = ("flops", "bytes", "mfu_pct", "roofline_ms", "roofline_x")
    # mfu_pct is rounded to 0.01%: a light row may read 0
    bad = [r for r in rows if not all(
        k in r and np.isfinite(r[k]) and (r[k] > 0 or k == "mfu_pct")
        for k in cols)]
    if not rows or bad:
        raise AssertionError(f"observe (a): layer_profile rows without "
                             f"the cost columns: {bad[:3] or lp['rows']}")
    log("observe (a): layer_profile cost columns, top rows: " + "; ".join(
        f"{r['layer']} {r['device_ms']} ms, {r['flops'] / 1e9:.1f} GFLOP, "
        f"mfu {r['mfu_pct']}%, roofline {r['roofline_ms']} ms "
        f"(x{r['roofline_x']})" for r in rows[:8]))
    log("observe (a): layer_profile by kind: " + "; ".join(
        f"{kind} x{len(rs)} {sum(r['device_ms'] for r in rs):.3f} ms, mfu "
        f"{min(r['mfu_pct'] for r in rs)}-{max(r['mfu_pct'] for r in rs)}%"
        f", roofline_x {min(r['roofline_x'] for r in rs)}-"
        f"{max(r['roofline_x'] for r in rs)}"
        for kind, rs in by_kind(rows).items()))


def by_kind(rows: list) -> dict:
    """Rows grouped by connection name without its index and digits
    (``03-l0_att`` -> ``l_att``), heaviest group first."""
    out = {}
    for r in rows:
        out.setdefault(re.sub(r"\d+", "", r["layer"].split("-", 1)[1]),
                       []).append(r)
    return dict(sorted(out.items(), key=lambda kv: -sum(
        r.get("device_ms", r.get("total_bytes", 0)) for r in kv[1])))


def observe_memory(recs: list, tr) -> None:
    """(a) The ``mem_profile`` record of the window's first step, read from
    the caching allocator: the JAX package's keys, a coverage above 0,
    rows of connections, the model's totals and the card's capacity.
    Prints the top rows, ``peak_live_bytes`` and the step's high-water
    (``args_bytes`` + ``temp_bytes``) beside the model's
    ``est_peak_bytes``, ``torch.cuda.max_memory_allocated()`` since the
    probe's reset, and the ratios.  The model counts each connection's
    output alone, so nothing asserts that it bounds the measurement."""
    import torch
    if len(recs) != 1:
        raise AssertionError(f"observe (a): {len(recs)} mem_profile "
                             "records")
    (mp,) = recs
    need = {"peak_live_bytes", "peak_frac", "timeline", "coverage", "rows",
            "exec", "model", "hbm_capacity_bytes", "hbm_peak_bytes"}
    row_keys = {"layer", "param_bytes", "opt_bytes", "act_bytes",
                "total_bytes", "model_bytes", "model_x", "share"}
    scopes = set(tr.layer_scopes())
    if not need <= set(mp) or not mp["coverage"] > 0 \
            or not mp["peak_live_bytes"] > 0 or not mp["rows"] \
            or any(not row_keys <= set(r) or r["layer"] not in scopes
                   for r in mp["rows"]):
        raise AssertionError(f"observe (a): mem_profile {mp}")
    est = mp["model"]["est_peak_bytes"]
    step_peak = mp["exec"]["args_bytes"] + mp["exec"]["temp_bytes"]
    run_peak = torch.cuda.max_memory_allocated()
    gb = 1e9
    log("observe (a): mem_profile top rows: " + "; ".join(
        f"{r['layer']} param {r['param_bytes'] / gb:.3f} + opt "
        f"{r['opt_bytes'] / gb:.3f} + act {r['act_bytes'] / gb:.3f} GB "
        f"(model x{r['model_x']})" for r in mp["rows"][:6]))
    log(f"observe (a): mem_profile peak live {mp['peak_live_bytes'] / gb:.3f}"
        f" GB over the step's start ({mp['exec']['args_bytes'] / gb:.3f} "
        f"GB: params, optimizer state, batch) at {mp['peak_frac']:.0%} of "
        f"the step, coverage {mp['coverage']}; the step's high-water "
        f"{step_peak / gb:.3f} GB, the model's est_peak_bytes "
        f"{est / gb:.3f} GB (model / measured {est / step_peak:.3f}; "
        f"acts {mp['model']['act_bytes'] / gb:.3f} GB modelled), "
        f"max_memory_allocated since the probe's reset "
        f"{run_peak / gb:.3f} GB (model / it "
        f"{est / run_peak:.3f}), the run's hbm_peak_bytes "
        f"{mp['hbm_peak_bytes'] / gb:.3f} GB, capacity "
        f"{mp['hbm_capacity_bytes'] / gb:.3f} GB; timeline (GB) "
        f"{[round(v / gb, 2) for v in mp['timeline']]}")
    log("observe (a): mem_profile by kind (measured act / modelled bytes): "
        + "; ".join(
            f"{kind} x{len(rs)} act {sum(r['act_bytes'] for r in rs) / gb:.3f}"
            f" GB, model_x {min(r['model_x'] for r in rs)}-"
            f"{max(r['model_x'] for r in rs)}"
            for kind, rs in by_kind(mp["rows"]).items()))


def observe_overhead(tmp: str) -> None:
    """(b) The step p50 of ``train_fused`` at depth OBSERVE_LAYERS, the
    plane off (no sink) and on (``trace_sample = 1 sentinel = 1`` with a
    sink), in the order off, on, on, off."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    conf = lm_train_conf(tmp, "observe_overhead", True, OBSERVE_LAYERS,
                         NHEAD, OBSERVE_STEPS, True)
    out = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        extra = (["metrics_sink=none"] if mode == "off" else
                 ["trace_sample=1", "sentinel=1",
                  f"metrics_sink=jsonl:{tmp}/observe_overhead_{i}.jsonl"])
        task = LearnTask()
        if task.run([conf] + extra) != 0:
            raise AssertionError(f"observe (b): run {i} ({mode}) failed")
        out[mode].append(task.last_train["step_p50_ms"])
        del task
        torch.cuda.empty_cache()
    log(f"observe (b): train_fused at depth {OBSERVE_LAYERS}, "
        f"{OBSERVE_STEPS} steps a run, step p50 (ms, steps after the first)"
        f": off {out['off'][0]:.3f}, on {out['on'][0]:.3f}, on "
        f"{out['on'][1]:.3f}, off {out['off'][1]:.3f} ({card_line()})")


def observe_rollback(tmp: str) -> None:
    """(c) MNIST_CONV.conf under ``monitor = 1 monitor_interval = 1
    monitor_nan = fatal rollback = 2 ckpt_async = 1``, batch
    ROLLBACK_AT of round ROLLBACK_ROUND NaN-poisoned: one ``rollback``
    record restoring round ROLLBACK_ROUND - 1, a run that completes, a
    last ``.ckpt`` that validates and finite losses."""
    import torch
    from cxxnet_tpu_torch import ckpt
    from cxxnet_tpu_torch.main import LearnTask

    class PoisonTask(LearnTask):
        def _create_iterators(self):
            super()._create_iterators()
            if self.itr_train is not None:
                self.itr_train = PoisonRound(self.itr_train, ROLLBACK_ROUND,
                                             ROLLBACK_AT)

    sink = fresh(os.path.join(tmp, "observe_rollback.jsonl"))
    mdir = os.path.join(tmp, "rollback_models")
    args = [f"dev={DEV}", f"num_round={MNIST_ROUNDS}",
            f"max_round={MNIST_ROUNDS}", "pool_layout=hwcn",
            "fast_wgrad=hwcn", f"model_dir={mdir}", "save_model=1",
            "ckpt_async=1", "monitor=1", "monitor_interval=1",
            "monitor_nan=fatal", "rollback=2", f"metrics_sink=jsonl:{sink}",
            "silent=1"]
    task = PoisonTask()
    rc = task.run([mnist_conv_conf(tmp)] + args)
    st = task.last_train
    recs = read_records(sink)
    rbs = [r for r in recs if r["kind"] == "rollback"]
    nans = [r for r in recs if r["kind"] == "nan"]
    last = os.path.join(mdir, f"{MNIST_ROUNDS:04d}.ckpt")
    valid = ckpt.validate_snapshot(last) is not None
    losses = st["losses"] if st else []
    log(f"observe (c): rc {rc}; nan records "
        f"{[(r['round'], r['step']) for r in nans]}; rollback records "
        f"{[{k: r[k] for k in ('retry', 'from_round', 'restored_round')} for r in rbs]}"
        f"; {len(losses)} losses, last {losses[-1] if losses else None}; "
        f"test-error by round {[e.get('test-error') for e in st['evals']]}"
        f"; {last} valid {valid}; ledger rollback_lost "
        f"{recs[-1].get('categories', {}).get('rollback_lost')} s")
    if rc != 0 or len(rbs) != 1 or rbs[0]["restored_round"] \
            != ROLLBACK_ROUND - 1 or not valid \
            or not np.isfinite(losses).all() or not nans:
        raise AssertionError("observe (c): the rollback run failed its "
                             "checks")
    del task
    torch.cuda.empty_cache()


def request_p99_check(label: str, recs: list, op: str) -> None:
    """The p99 of the ``request`` spans against the ``latency`` record's
    (``op``) within OBSERVE_LATENCY_TOL, and the per-stage breakdown."""
    from cxxnet_tpu_torch.monitor.metrics import nearest_rank
    from cxxnet_tpu_torch.monitor.spans import stage_decomposition
    spans = [r for r in recs if r["kind"] == "span"]
    req = sorted(r["dur_us"] / 1e3 for r in spans if r["span"] == "request")
    (lat,) = [r for r in recs if r["kind"] == "latency" and r["op"] == op]
    p99 = nearest_rank(req, 99)
    dec = stage_decomposition(recs)
    by = {}
    for r in spans:
        by.setdefault(r["span"], []).append(r["dur_us"] / 1e3)
    log(f"observe (d) {label}: {len(req)} request spans, p99 {p99:.3f} ms "
        f"vs the latency record's {lat['p99']:.3f} ms ({lat['count']} "
        "samples); stages: " + "; ".join(
            f"{s['stage']} p50 {s['p50_ms']} p99 {s['p99_ms']} ms share "
            f"{s['share']}" for s in dec["stages"]))
    log(f"observe (d) {label}: spans by name: " + "; ".join(
        f"{k} x{len(v)} p50 {nearest_rank(sorted(v), 50):.3f} p99 "
        f"{nearest_rank(sorted(v), 99):.3f} ms" for k, v in sorted(by.items())))
    if len(req) != lat["count"] or abs(p99 - lat["p99"]) \
            > OBSERVE_LATENCY_TOL * lat["p99"]:
        raise AssertionError(f"observe (d) {label}: request p99 {p99} vs "
                             f"latency p99 {lat['p99']}")


def observe_serving(tmp: str, serve_conf: str) -> None:
    """(d) ``serve_batch`` (f32) and ``serve`` again with ``trace_sample =
    1``: each stage's p99, and the ``request`` spans' p99 equal to the
    ``latency`` record's."""
    from cxxnet_tpu_torch.main import LearnTask
    sink = fresh(os.path.join(tmp, "observe_serve_batch.jsonl"))
    if LearnTask().run(mnist_serve_args(tmp) + [
            "serve_dtype=f32", "trace_sample=1",
            f"metrics_sink=jsonl:{sink}"]) != 0:
        raise AssertionError("observe (d): serve_batch failed")
    request_p99_check("serve_batch", read_records(sink), "serve")
    sink = fresh(os.path.join(tmp, "observe_serve.jsonl"))
    if LearnTask().run([serve_conf, "trace_sample=1",
                        f"metrics_sink=jsonl:{sink}"]) != 0:
        raise AssertionError("observe (d): serve failed")
    request_p99_check("serve", read_records(sink), "gen")


def phase_observe(tmp: str, serve_conf: str) -> dict:
    """Phase 21 (``observe``): the training observatory and the span
    tracer on the card, (a)-(d) above; returns the path's launches."""
    reset_launches()
    observe_window(tmp)
    observe_overhead(tmp)
    observe_rollback(tmp)
    observe_serving(tmp, serve_conf)
    launches = read_launches()
    log(f"observe path launches: {launches}")
    return launches


def check_run(conf: str, args=()) -> tuple:
    """``task = check`` of ``conf`` through the port's CLI: (exit code,
    the ``check`` record of the conf's sink, seconds)."""
    from cxxnet_tpu_torch.main import LearnTask
    sink = re.search(r"^metrics_sink = jsonl:(.*)$", open(conf).read(),
                     re.M).group(1)
    fresh(sink)
    t0 = time.perf_counter()
    rc = LearnTask().run([conf, "task=check"] + list(args))
    sec = time.perf_counter() - t0
    (rec,) = [r for r in read_records(sink) if r["kind"] == "check"]
    return rc, rec, sec


def check_estimate(conf: str, batch: int) -> int:
    """The memory model's est_peak_bytes of ``conf`` at ``batch`` (the
    trainer built on meta tensors, as task = check builds it)."""
    import torch
    from cxxnet_tpu_torch.analysis import memmodel
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_file
    tr = NetTrainer()
    for k, v in parse_config_file(conf):
        if k != "metrics_sink":
            tr.set_param(k, v)
    tr.set_param("batch_size", str(batch))
    tr.init_model(torch.device("meta"))
    return memmodel.totals(tr)["est_peak_bytes"]


def check_graph_lint(conf: str) -> tuple:
    """The graph lint (analysis/graph_lint.py) and the SPMD deep lint
    (analysis/spmdlint.py) of ``conf``'s train step on the meta-built
    trainer, as task = check runs them (one trace for both): (graph
    lint findings, seconds with the trace, SPMD findings, seconds of the
    SPMD pass over the trace)."""
    import torch
    from cxxnet_tpu_torch.analysis import graph_lint, spmdlint
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_file
    tr = NetTrainer()
    cfg = [(k, v) for k, v in parse_config_file(conf) if k != "metrics_sink"]
    for k, v in cfg:
        tr.set_param(k, v)
    tr.set_param("silent", "1")
    tr.init_model(torch.device("meta"))
    t0 = time.perf_counter()
    audit = {}
    traced = graph_lint.trace_step(tr, audit)
    findings = graph_lint.lint_trainer(tr, traced)
    t1 = time.perf_counter()
    spmd = spmdlint.lint_trainer(tr, traced, audit, cfg)
    return findings, t1 - t0, spmd, time.perf_counter() - t1


def alloc_state() -> tuple:
    """The caching allocator's live bytes, reserved bytes and count of
    allocations ever made, after the card is idle."""
    import torch
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
            torch.cuda.memory_stats().get("allocation.all.allocated", 0))


def check_body(tmp: str) -> dict:
    """The ``check`` phase's work, in the child :func:`start_check`
    starts: the port's ``task = check`` on the card's
    machine, which does no device work: (a) ``mem_check = 1 mem_chip =
    h100`` on phase 9's LM conf at full width (d 2048, 12 layers, s 4096,
    batch 4, fused adam): exit 0, an ``info`` pre-flight finding with its
    % full and the graph lint's one ``info`` finding (its node count),
    timed, and the lint alone on the same trainer, its node count and
    seconds printed; (b) the same conf at the least batch whose modelled
    peak passes the card's 80 GB (found from the model on meta tensors,
    never run): exit 1 with an error carrying remediations; (c) every
    example/**/*.conf: each exit code, error count and graph node count
    printed, every conf with a net the port builds linted (one info
    line of the graph lint) and no SPMD finding an error; (a) also runs
    the SPMD pass alone over the LM's trace, in under 20 s.  The
    allocator's live and reserved bytes
    and its count of allocations must not move, and no kernel may
    launch (in this process: a fresh one, so the allocator's readings
    are its own).  Returns the path's launches."""
    import glob
    import torch
    from cxxnet_tpu_torch.analysis import costmodel
    reset_launches()
    conf = lm_train_conf(tmp, "check", True, NLAYER, NHEAD, TRAIN_STEPS,
                         True)
    # an earlier phase's frees that are still pending (tensors held in
    # reference cycles until the collector runs; blocks used on a side
    # stream, released by the allocator's next event sweep) are settled
    # before the first reading: one landed inside the phase once
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = alloc_state()
    log(f"check: {live - mem0[0]} bytes of earlier phases' frees settled "
        "before the phase")
    rc, rec, sec = check_run(conf, ["mem_check=1", "mem_chip=h100"])
    mem = [f for f in rec["findings"] if f.get("scope") == "mem"]
    log(f"check (a): exit {rc} in {sec:.2f} s; {rec['n_error']} errors, "
        f"{rec['n_warn']} warnings, {rec['n_info']} info; pre-flight: "
        + "; ".join(f"{f['severity']} {f['message']}" for f in mem))
    if rc != 0 or len(mem) != 1 or mem[0]["severity"] != "info" \
            or "full;" not in mem[0]["message"]:
        raise AssertionError(f"check (a): exit {rc}, {rec}")
    jx = [f for f in rec["findings"] if f.get("scope") == "jaxpr"]
    sp = [f for f in rec["findings"] if f.get("scope") == "spmd"]
    lint, lsec, spmd, ssec = check_graph_lint(conf)
    log(f"check (a): graph lint of the fused LM's step: "
        + "; ".join(f"{f.severity} {f.message}" for f in lint)
        + f" ({lsec:.1f} s with the trace); in the check record: "
        + "; ".join(f"{f['severity']} {f['message']}" for f in jx))
    log(f"check (a): SPMD pass over the same trace ({ssec:.2f} s): "
        + "; ".join(f"{f.severity} {f.key}: {f.message}" for f in spmd)
        + "; in the check record: "
        + "; ".join(f"{f['severity']} {f['key']}" for f in sp))
    if [f.severity for f in lint] != ["info"] or [f["severity"] for f in jx] \
            != ["info"] or not jx[0]["message"].startswith(
                "traced train step: "):
        raise AssertionError(f"check (a): graph lint {lint}, {jx}")
    if not sp or [f.key for f in spmd if f.severity == "error"] \
            or not ssec < 20.0:
        raise AssertionError(f"check (a): SPMD pass {spmd} in {ssec:.1f} s")
    cap = costmodel.HBM_BYTES[costmodel.H100]
    e0 = check_estimate(conf, TRAIN_BATCH)
    e1 = check_estimate(conf, TRAIN_BATCH + 1)
    over = TRAIN_BATCH + max(int(np.ceil((cap - e0) / (e1 - e0))), 1)
    while check_estimate(conf, over) <= cap:
        over += 1
    while over - 1 > TRAIN_BATCH and check_estimate(conf, over - 1) > cap:
        over -= 1
    rc, rec, sec = check_run(conf, ["mem_check=1", "mem_chip=h100",
                                    f"batch_size={over}"])
    err = [f for f in rec["findings"] if f.get("scope") == "mem"
           and f["severity"] == "error"]
    log(f"check (b): batch {over} (the model: {e0 / 1e9:.2f} GB at batch "
        f"{TRAIN_BATCH}, +{(e1 - e0) / 1e9:.2f} GB a row): exit {rc} in "
        f"{sec:.2f} s; " + "; ".join(f["message"] for f in err))
    if rc != 1 or len(err) != 1 or "did you mean: remat" not in \
            err[0]["message"]:
        raise AssertionError(f"check (b): exit {rc}, {rec}")
    confs = sorted(glob.glob(os.path.join(REPO, "example", "**", "*.conf"),
                             recursive=True))
    from cxxnet_tpu_torch.main import LearnTask
    cwd = os.getcwd()
    os.chdir(tmp)  # relative sinks of the example confs land here
    try:
        out, unlinted = [], []
        for c in confs:
            t0 = time.perf_counter()
            task = LearnTask()
            code = task.run([c, "task=check"])
            n_err = sum(f.severity == "error" for f in task.last_check)
            spmd_err = [f.key for f in task.last_check
                        if f.scope == "spmd" and f.severity == "error"]
            if spmd_err:
                raise AssertionError(f"check (c): {c}: SPMD errors "
                                     f"{spmd_err}")
            jx = [f for f in task.last_check if f.scope == "jaxpr"]
            nodes = [f.message.split()[3] for f in jx
                     if f.message.startswith("traced train step: ")]
            n_spmd = sum(f.scope == "spmd" for f in task.last_check)
            out.append(f"{os.path.relpath(c, REPO)} exit {code}, {n_err} "
                       f"errors, {nodes[0] if nodes else 'no'} graph "
                       f"nodes, {n_spmd} SPMD findings "
                       f"({time.perf_counter() - t0:.2f} s)")
            # a conf with a net the port builds gets the graph lint's
            # one info line, nothing else of that scope
            has_net = re.search(r"(?m)^netconfig\s*=\s*start",
                                open(c).read())
            if code == 0 and has_net and (not nodes or len(jx) != 1):
                unlinted.append((c, [f.format() for f in jx]))
    finally:
        os.chdir(cwd)
    log("check (c): " + "; ".join(out))
    if unlinted:
        raise AssertionError(f"check (c): graph lint: {unlinted}")
    gc.collect()
    mem1 = alloc_state()
    launches = read_launches()
    log(f"check: allocator live / reserved bytes and allocations made "
        f"{mem0} before, {mem1} after; launches {sum(launches.values())}")
    if mem1 != mem0 or any(launches.values()):
        raise AssertionError("check: task = check touched the card")
    return launches


#: seconds the check child may still need when its phase comes (it
#: starts before the serve phase and takes 1-2 minutes of one core)
CHECK_JOIN_SEC = 300


def start_check(tmp: str):
    """Start the ``check`` phase in a child process (``python3
    chip_smoke.py --check-child TMP``) whose files, its output too, go
    to a directory of their own under ``tmp``: ``task = check`` does no
    device work and takes one host core for a minute or two, so it runs
    beside the card's phases and :func:`phase_check` collects it.
    Returns the child's Popen."""
    own = os.path.join(tmp, "check")
    os.makedirs(own)
    with open(os.path.join(own, "check_child.log"), "w") as fo:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--check-child",
             own], stdout=fo, stderr=subprocess.STDOUT, cwd=REPO)


def check_child(tmp: str) -> int:
    """``--check-child``: :func:`check_body` in this process; its
    launches and the wall time to ``tmp/check_child.json``."""
    t0 = time.perf_counter()
    launches = check_body(tmp)
    with open(os.path.join(tmp, "check_child.json"), "w") as f:
        json.dump(dict(launches=launches, wall=time.perf_counter() - t0), f)
    return 0


def phase_check(proc, tmp: str) -> dict:
    """Phase 23 (``check``): waits for the child :func:`start_check`
    started (at most CHECK_JOIN_SEC), prints its output and fails when
    it failed.  Returns the path's launches (none)."""
    tmp = os.path.join(tmp, "check")
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=CHECK_JOIN_SEC)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    with open(os.path.join(tmp, "check_child.log")) as f:
        for line in f.read().splitlines():
            log(line)
    if rc != 0:
        raise AssertionError(f"check: the child exited {rc}"
                             + (" (killed after its wait)" if rc is None
                                else ""))
    with open(os.path.join(tmp, "check_child.json")) as f:
        res = json.load(f)
    log(f"check: ran beside the earlier phases in {res['wall']:.1f} s; "
        f"waited {time.perf_counter() - t0:.1f} s for it here")
    return res["launches"]


def pairtest_conf(tmp: str) -> str:
    """example/ImageNet/ImageNet.conf with conv1 rewritten as
    ``pairtest-conv-torch`` (named conv1, its slave ``op = conv``)."""
    text = open(os.path.join(REPO, "example", "ImageNet",
                             "ImageNet.conf")).read()
    old = "layer[0->1] = conv\n"
    if text.count(old) != 1:
        raise AssertionError("pairtest: ImageNet.conf's conv1 line moved")
    conf = os.path.join(tmp, "pairtest.conf")
    with open(conf, "w") as f:
        f.write(text.replace(old, "layer[0->1] = pairtest-conv-torch:conv1\n"
                                  "  slave:op = conv\n"))
    return conf


def pairtest_normwise(dtype) -> tuple:
    """One pairtest-conv-torch layer at conv1's shape (batch 256, 3 x 227
    x 227 -> 96 x 55 x 55, k 11 s 4) on the card: its master (the conv
    layer under fast_wgrad = hwcn: cuDNN's forward, row 5's wgrad) and
    its slave (plain torch autograd) on one seeded input, the same
    weights and one output gradient.  Returns max |m - s| / max |s| of
    the output, the input gradient and the weight and bias gradients,
    and the launches of the call (row 5 once, in the master's
    backward)."""
    import torch
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers.base import ForwardContext
    from cxxnet_tpu_torch.layers.registry import create_layer
    layer = create_layer("pairtest-conv-torch")
    for k, v in (("slave:op", "conv"), ("kernel_size", "11"),
                 ("stride", "4"), ("nchannel", "96")):
        layer.set_param(k, v)
    shape = (256, 3, 227, 227)
    (oshape,) = layer.infer_shapes([shape])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = {t: v for t, v in layer.init_params(gen, [shape], dtype).items()
              if t.startswith("master/")}
    x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(oshape, generator=gen, device="cuda").to(dtype)
    opts = EngineOptions()
    for k, v in (("pool_layout", "hwcn"), ("fast_wgrad", "hwcn")):
        opts.set(k, v)
    res = []
    reset_launches()
    for side in (layer.master, layer.slave):
        p = {t[len("master/"):]: v.detach().clone().requires_grad_()
             for t, v in params.items()}
        xi = x.detach().clone().requires_grad_()
        (out,) = side.forward(p, [xi], ForwardContext(train=True,
                                                      opts=opts))
        dx, dw, db = torch.autograd.grad(out, [xi, p["wmat"], p["bias"]], g)
        res.append((out.detach(), dx, dw, db))
    torch.cuda.synchronize()
    launches = read_launches()
    return {name: rel_err(m, s) for name, m, s in
            zip(("fwd", "in_grad", "wgrad", "bgrad"), *res)}, launches


def pairtest_run(tmp: str, label: str, steps: int, extra=()) -> tuple:
    """``task = train`` of pairtest_conf through the CLI for ``steps``
    steps (``synth_device_data = 1``): (the run's per-step diagnostics,
    its losses, the path's launches, and the last step's conv1 weight
    and bias gradients of both sides as ``{"wgrad": (master, slave),
    "bgrad": (master, slave)}``, taken where the trainer hands them to
    the updater)."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    conf = pairtest_conf(tmp)
    grads_seen = {}
    apply_update = NetTrainer.apply_update

    def keep_grads(self, grads, epoch):
        (g,) = [g for g in grads.values() if "master/wmat" in g]
        for name, tag in (("wgrad", "wmat"), ("bgrad", "bias")):
            grads_seen[name] = tuple(g[f"{side}/{tag}"].detach().clone()
                                     for side in ("master", "slave"))
        return apply_update(self, grads, epoch)

    NetTrainer.apply_update = keep_grads
    try:
        reset_launches()
        task = LearnTask()
        rc = task.run([conf] + list(PAIR_ARGS) + [
            f"multi_step={steps}", f"model_dir={tmp}/{label}"]
            + list(extra))
        launches = read_launches()
    finally:
        NetTrainer.apply_update = apply_update
    st = task.last_train
    if rc != 0 or st is None or st["steps"] != steps or not grads_seen:
        raise AssertionError(f"pairtest {label}: CLI returned {rc}")
    del task
    return st["diags"], st["losses"], launches, grads_seen


def phase_pairtest(tmp: str) -> dict:
    """Phase 24 (``pairtest``): ImageNet.conf at batch 256 with conv1
    rewritten as ``pairtest-conv-torch`` under ALEXNET_ARGS' kernel keys,
    PAIR_STEPS steps in bf16: the master's backward is row 5's wgrad,
    the slave's cuDNN under autograd; rows 1, 3 and 4 run around them.
    Each step's diagnostics are printed (fwd / in_grad / wgrad / weight
    relative errors, the reference's elementwise metric) and must be
    finite and within PAIR_BF16_DIAG_BOUND; each step launches row 5
    twice (the step's backward and the probe's) and rows 1, 3 and 4 as
    the alexnet path does.  The last step's weight and bias gradients
    of master and slave, as the trainer hands them to the updater, are
    held normwise within PAIR_WGRAD_BF16_TOL.  Then the same at conv1's
    shape in a separate call, which must launch row 5 once: the output
    and input gradient within BF16_ROW_TOL, the weight and bias
    gradients within PAIR_WGRAD_BF16_TOL.  Then PAIR_F32_STEPS step(s)
    at float32 with TF32 off in cuDNN and cuBLAS, the reference's 1e-5
    the yardstick of the printed diagnostics, the last step's gradients
    within WGRAD_TOL, and the separate call's errors within F32_TOL
    (output, input gradient) and WGRAD_TOL (weight and bias gradients).
    Returns the path's launches (both runs; the separate calls' are not
    counted)."""
    import torch
    out = {}
    for label, dtype, steps, extra, tf32 in (
            ("bf16", torch.bfloat16, PAIR_STEPS, (), True),
            ("f32", torch.float32, PAIR_F32_STEPS, ("dtype=float32",),
             False)):
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            t0 = time.perf_counter()
            diags, losses, launches, grads = pairtest_run(
                tmp, f"pairtest_{label}", steps, extra)
            wall = time.perf_counter() - t0
            norm, norm_launches = pairtest_normwise(dtype)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        for i, d in enumerate(diags):
            log(f"pairtest {label} step {i + 1}: " + " ".join(
                f"{k.split(':')[1]} {v:.3e}" for k, v in sorted(d.items()))
                + f"; loss {losses[i]:.4f}")
        step = {k: rel_err(m, s) for k, (m, s) in grads.items()}
        log(f"pairtest {label}: {steps} steps in {wall:.1f} s (cuDNN "
            f"allow_tf32 = {tf32}); normwise, the last step's "
            + " ".join(f"{k} {v:.3e}" for k, v in step.items())
            + "; normwise at conv1's shape: "
            + " ".join(f"{k} {v:.3e}" for k, v in norm.items())
            + f"; launches {launches}; the comparison's row 5 launches "
            f"{norm_launches['conv_wgrad']}")
        grad_tol = PAIR_WGRAD_BF16_TOL if label == "bf16" else WGRAD_TOL
        if max(step.values()) > grad_tol \
                or norm_launches["conv_wgrad"] != 1:
            raise AssertionError(f"pairtest {label}: the last step's "
                                 f"gradients {step} (tol {grad_tol}), the "
                                 f"comparison's launches {norm_launches}")
        vals = [v for d in diags for v in d.values()]
        if len(diags) != steps or not all(len(d) == 4 for d in diags) \
                or not np.all(np.isfinite(vals + losses)):
            raise AssertionError(f"pairtest {label}: diagnostics {diags}, "
                                 f"losses {losses}")
        want = {n: ALEXNET_PER_STEP.get(n, 0) * steps for n in KERNELS}
        want["conv_wgrad"] = 2 * steps
        if label == "bf16":
            if max(vals) > PAIR_BF16_DIAG_BOUND \
                    or norm["fwd"] > BF16_ROW_TOL \
                    or norm["in_grad"] > BF16_ROW_TOL \
                    or norm["wgrad"] > PAIR_WGRAD_BF16_TOL \
                    or norm["bgrad"] > PAIR_WGRAD_BF16_TOL:
                raise AssertionError(f"pairtest bf16: {diags}, {norm}")
            if launches != want:
                raise AssertionError(f"pairtest bf16: launches {launches}, "
                                     f"expected {want}")
        else:
            over = {k: v for d in diags for k, v in d.items()
                    if v > PAIRTEST_RTOL}
            log(f"pairtest f32: over the reference's {PAIRTEST_RTOL:g}: "
                f"{over or 'none'}")
            if norm["fwd"] > F32_TOL or norm["in_grad"] > F32_TOL \
                    or norm["wgrad"] > WGRAD_TOL or norm["bgrad"] > WGRAD_TOL \
                    or launches["conv_wgrad"] != want["conv_wgrad"]:
                raise AssertionError(f"pairtest f32: {norm}, {launches}")
        for n, c in launches.items():
            out[n] = out.get(n, 0) + c
        MEASURED[f"pairtest_{label}"] = dict(diags=diags, step=step,
                                             normwise=norm)
    torch.cuda.empty_cache()
    return out


def wrapper_cfg() -> str:
    """example/MNIST/MNIST_CONV.conf's net and keys as a wrapper config
    string (its data sections and ``dev`` dropped), under the keys that
    take rows 3-5 (``pool_layout = hwcn fast_wgrad = hwcn``)."""
    text = open(os.path.join(REPO, "example", "MNIST",
                             "MNIST_CONV.conf")).read()
    body = text[text.index("netconfig=start"):]
    body = re.sub(r"(?m)^(dev|save_model|model_dir|max_round|num_round)"
                  r"\s*=.*$", "", body)
    return body + "\npool_layout = hwcn\nfast_wgrad = hwcn\nsilent = 1\n"


def capi_lib(path: str):
    """The port's C ABI library, loaded in this process by ctypes, with
    the signatures this phase calls."""
    import ctypes
    lib = ctypes.CDLL(path)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.CXNGetLastError.restype = ctypes.c_char_p
    lib.CXNNetCreate.restype = ctypes.c_void_p
    lib.CXNNetCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.CXNNetFree.argtypes = [ctypes.c_void_p]
    lib.CXNNetLoadModel.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.CXNNetUpdateBatch.argtypes = [ctypes.c_void_p, f32p, u64p,
                                      ctypes.c_int, f32p, u64p, ctypes.c_int]
    lib.CXNNetPredictBatch.restype = f32p
    lib.CXNNetPredictBatch.argtypes = [ctypes.c_void_p, f32p, u64p,
                                       ctypes.c_int, u64p, ip]
    lib.CXNNetGetWeight.restype = f32p
    lib.CXNNetGetWeight.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, u64p, ip]
    return lib


# ------------------------------------------------------------ data parallel
def dp_parts(tmp: str) -> list:
    """The dp path's runs, ``(name, CLI argv)``: AlexNet under
    dp_overlap 0 and 1, the packed LM under ZeRO and the fused update,
    ResNet-56.  The same argv runs on one device in this process and on
    DP_RANKS gloo ranks sharing the card (each rank's LearnTask joins the
    spawned group and takes its rows of every batch)."""
    from cxxnet_tpu_torch.models import resnet
    alex = [os.path.join(REPO, "example", "ImageNet", "ImageNet.conf")] \
        + list(DP_ALEXNET_ARGS) + [f"model_dir={tmp}/dp", "silent=1"]
    lm = lm_train_conf(tmp, "dp_lm", True, DP_LM_LAYERS, NHEAD, DP_LM_STEPS,
                       True)
    rconf = os.path.join(tmp, "dp_resnet.conf")
    with open(rconf, "w") as f:
        f.write(resnet(num_class=10, depth=RESNET_DEPTH) + f"""
batch_size = {RESNET_BATCH}
dtype = bfloat16
updater = sgd
momentum = 0.9
eta = 0.05
wd = 0.0001
random_type = kaiming
""")
    return [("alexnet", alex + ["dp_overlap=0"]),
            ("alexnet_overlap", alex + ["dp_overlap=1"]),
            ("lm_zero", [lm, "shard_opt_state=1"] + PREFETCH_ARGS),
            ("resnet", [rconf] + list(DP_RESNET_ARGS)
             + [f"model_dir={tmp}/dp"]),
            ("resnet_f32", [rconf] + list(DP_RESNET_ARGS)
             + [f"model_dir={tmp}/dp", "dtype=float32"])]


def state_digest(net) -> list:
    """Every parameter, optimizer-state and buffer leaf's bits folded on
    the card into two int64 sums, plain and position-weighted, in tree
    order: ranks holding bitwise the same state give the same list."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for tree in (net.params, net.opt_state or {}, net.buffers):
        for _, leaf in sorted(flat_leaves(tree)):
            v = leaf.detach().contiguous().view(-1)
            v = v.view(ints[v.element_size()]).to(torch.int64)
            w = torch.arange(v.numel(), device=v.device) % 65521 + 1
            out.append((int(v.sum()), int((v * w).sum())))
    return out


def flat_leaves(tree, path: str = "") -> list:
    """``[(path, tensor)]`` of a nested dict of tensors."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flat_leaves(v, f"{path}/{k}")
        else:
            out.append((f"{path}/{k}", v))
    return out


def dp_run(name: str, argv: list, drift="weights") -> dict:
    """One LearnTask run of the dp path in this process (one device, or
    a rank of the spawned group): its losses, step times, launches (the
    counters set to 0 just before), peak memory, and on a mesh the
    replicas' drift (``drift``: ``weights``, the trainer's
    ``check_weight_consistency``; ``digest``, this rank's
    :func:`state_digest` for the caller to compare; None: neither), the
    bucket count, the ZeRO shards the fused adam took and the batch_norm
    buffers; on a pipe axis the last step's schedule statistics and the
    bubble share."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.ops.fused_adam import fused_adam_supported
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    task = LearnTask()
    strict = name.endswith("_f32")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    if strict:
        # float32 without TF32, cuDNN's deterministic algorithms: the one-
        # device and the dp runs then differ by summation order alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        rc = task.run(argv)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    wall = time.perf_counter() - t0
    launches = read_launches()
    st, net = task.last_train, task.net
    if rc != 0 or st is None:
        raise AssertionError(f"dp {name}: CLI returned {rc}")
    res = dict(losses=st["losses"], step_ms=st["step_ms"],
               p50=st["step_p50_ms"], launches=launches,
               relu=kernel_fn("max_pool_bwd").relu_launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               wall=wall, mesh=None if net.mesh is None
               else dict(net.mesh.axes))
    if net.mesh is not None:
        t0 = time.perf_counter()
        res["drift"] = net.check_weight_consistency() \
            if drift == "weights" else None
        res["digest"] = state_digest(net) if drift == "digest" else None
        res["drift_sec"] = time.perf_counter() - t0
        res["pipe"] = dict(net.pipe_stats, bubble=net.pipe_bubble_frac)
        plan = net._dp_plan_state
        res["buckets"] = None if plan is None or plan[0] is None \
            else len(plan[0].stages)
        fused = net.opts.fused_update == "1"
        res["zero_shards"] = sorted({
            tuple(net._opt_view(k, t, net.params[k][t]).shape)
            for k, t in net.zero_leaves
            if fused and fused_adam_supported(
                net._opt_view(k, t, net.params[k][t]))})
        res["zero_leaves"] = len(net.zero_leaves)
        # the per-expert tensors (and their optimizer state) this rank
        # holds, against their logical bytes
        held = logical = 0
        for (k, t), (_, rows) in net.expert_sharded.items():
            leaves = [net.params[k][t]] + list(net.opt_state[k][t].values())
            for a in leaves:
                held += a.numel() * a.element_size()
                logical += rows * (a.numel() // a.shape[0]) \
                    * a.element_size()
        res["expert_bytes"] = (held, logical)
    res["buffers"] = {k: {t: v.detach().cpu().clone() for t, v in g.items()}
                      for k, g in net.buffers.items()}
    del task, net
    gc.collect()
    torch.cuda.empty_cache()
    return res


def arm_stack_dump() -> None:
    """In a spawned rank: every thread's Python stack to stderr shortly
    before the spawn's DP_TIMEOUT_SEC runs out, so that a hang says
    where each rank waits."""
    import faulthandler
    faulthandler.dump_traceback_later(DP_TIMEOUT_SEC - 30, exit=False)


def _dp_rank(rank: int, tmp: str, parts: list) -> None:
    """A rank of the dp path: every part in turn, its results saved."""
    import torch
    arm_stack_dump()
    torch.cuda.set_device(0)
    out = {name: dp_run(name, argv) for name, argv in parts}
    torch.save(out, os.path.join(tmp, f"dp_rank{rank}.pt"))


def _dp_nccl(rank: int, out: str) -> None:
    """Part (d): every collective the plane calls, through the mesh
    module over NCCL at world size 1 (the axis group set to the world,
    so each call reaches NCCL), f32 and bf16, each output held to its
    input (a sum over one rank is its input; a gather or a scatter of
    one shard is the whole)."""
    import torch
    import torch.distributed as dist
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    m = meshlib.Mesh({"data": 1}, 0, dev, "nccl", dist.group.WORLD,
                     {"data": dist.group.WORLD})
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    before = dict(meshlib.counts)
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((4096, 1024), generator=gen, device=dev).to(dtype)
        outs = {"all_reduce": meshlib.all_reduce(x.clone(), m),
                "all_reduce_async": meshlib.all_reduce(
                    x.clone(), m, async_op=True).wait(),
                "all_reduce_bf16_wire": meshlib.all_reduce(
                    x.clone(), m, dtype=torch.bfloat16),
                "reduce_scatter": meshlib.reduce_scatter(x.clone(), m),
                "reduce_scatter_async": meshlib.reduce_scatter(
                    x.clone(), m, async_op=True).wait(),
                "all_gather": meshlib.all_gather(x.clone(), m)}
        torch.cuda.synchronize()
        for k, y in outs.items():
            want = x.to(torch.bfloat16).to(dtype) if "bf16" in k else x
            if y.dtype != dtype or not torch.equal(y, want):
                raise AssertionError(f"nccl {k} {dtype}: output differs "
                                     "from its input")
            checked.append(f"{k}/{str(dtype).split('.')[1]}")
    calls = {k: meshlib.counts[k] - before[k] for k in before}
    with open(out, "w") as f:
        v = torch.cuda.nccl.version()
        json.dump(dict(checked=checked, calls=calls,
                       nccl=".".join(map(str, v)) if isinstance(v, tuple)
                       else str(v)), f)


def adam_shard_check(shapes) -> dict:
    """Row 13 against its plain version at the ZeRO shard shapes of the
    dp path: 3 chained steps a shape, m1 / m2 / master within ADAM_RTOL /
    ADAM_ATOL, the param the rounding of its master and within a bf16
    step of the plain one; the largest shape timed.  Launches here are
    not the path's."""
    import torch
    from cxxnet_tpu_torch.ops import fused_adam as fu
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    err = 0.0
    for shape in shapes:
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02)
        state = [w.to(torch.bfloat16), torch.zeros_like(w),
                 torch.zeros_like(w), w.clone()]
        ref = [t.clone() for t in state]
        for step in range(3):
            g = (torch.randn(shape, generator=gen, device=dev)
                 * 1e-3).to(torch.bfloat16)
            lr = 1e-3 * (step + 1)
            fu.fused_adam_pallas(g, *state[1:], lr, d1=0.1, d2=0.001,
                                 out=state[0])
            ref = list(fu.fused_adam_plain(g, *ref[1:], lr, 0.1, 0.001))
        torch.cuda.synchronize()
        for nm, got, want in zip(("m1", "m2", "w32"), state[1:], ref[1:]):
            if not torch.isclose(got, want, rtol=ADAM_RTOL,
                                 atol=ADAM_ATOL).all():
                raise AssertionError(f"fused_adam at shard {shape}: {nm} "
                                     "off its plain version")
        if not torch.equal(state[0], state[3].to(torch.bfloat16)) or \
                not bf16_within_step(state[0], ref[0], state[3], ref[3]):
            raise AssertionError(f"fused_adam at shard {shape}: the param")
        err = max(err, float((state[3] - ref[3]).abs().max()))
    shape = max(shapes, key=lambda s: int(np.prod(s)))
    n = int(np.prod(shape))
    log(f"dp: row 13 at the ZeRO shard shapes {shapes}: m1 / m2 / master "
        f"within rtol {ADAM_RTOL:g} atol {ADAM_ATOL:g} of the plain "
        f"version over 3 steps, master abs err {err:.3e}")
    return dict(shapes=[list(s) for s in shapes], max_abs_err=err,
                timed_shape=list(shape), elements=n)


def phase_dp(tmp: str) -> dict:
    """The data-parallel path (``dp``): DP_RANKS ranks on cuda:0 over
    gloo (gloo's collectives of CUDA tensors staged through the host),
    spawned by the port's mesh module, each running the port's CLI on its
    rows of every batch: (a) ImageNet.conf at batch 256 (128 a rank) in
    bf16 under the AlexNet kernel keys, DP_ALEX_STEPS steps with
    ``test_on_server = 1`` (the replicas checked bitwise after every
    step), under dp_overlap 0 and 1; (b) the packed LM of train_fused
    (d2048 / 12 layers / s4096, batch 4, 2 a rank) under
    ``shard_opt_state = 1`` with the fused adam on each rank's slices;
    (c) the zoo's ResNet-56 at batch 128 with the batch_norm statistics
    of the global batch, in bf16 and in float32 (no TF32, cuDNN
    deterministic), its moving buffers equal across the ranks.  Each
    part's losses against the same CLI run on one device in this
    process (DP_LOSS_TOL; ResNet's bf16 run its first loss, within
    2^-8); every kernel row of a part launched on each rank.  Then
    (d) the mesh module's collectives over NCCL at world size 1 and (e)
    the CLI with ``dev = gpu:0-1`` on a one-card machine, refused with
    both counts.  Returns the path's launches, summed over the ranks."""
    import torch
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    parts = dp_parts(tmp)
    card = card_line()
    ref = {}
    for name, argv in parts:
        if name == "alexnet_overlap":
            continue  # dp_overlap has nothing to reduce on one device
        ref[name] = dp_run(name, argv)
        log(f"dp reference {name} (one device): losses "
            f"{[round(x, 4) for x in ref[name]['losses']]}, step p50 "
            f"{ref[name]['p50']:.2f} ms, peak {ref[name]['peak_gib']:.2f} "
            f"GiB")
    ref["alexnet_overlap"] = ref["alexnet"]
    t0 = time.perf_counter()
    meshlib.spawn(_dp_rank, DP_RANKS, (tmp, parts), backend="gloo",
                  timeout_sec=DP_TIMEOUT_SEC)
    log(f"dp: {DP_RANKS} gloo ranks on cuda:0, {len(parts)} runs each, "
        f"{time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt"))
             for r in range(DP_RANKS)]
    want_rows = {"alexnet": ("lrn_fwd", "lrn_bwd", "max_pool_fwd",
                             "max_pool_bwd", "conv_wgrad"),
                 "lm_zero": ("flash_attention_seg_fwd",
                             "flash_attention_seg_bwd", "layernorm_fwd",
                             "layernorm_bwd", "fused_adam")}
    want_rows["alexnet_overlap"] = want_rows["alexnet"]
    want_rows["resnet"] = want_rows["resnet_f32"] = ()
    # ResNet-56 at eta 0.05 amplifies a rounding ~270-fold in 3 steps
    # (PERF.md, PR 19): its trajectory is held in float32 without TF32,
    # deterministic (resnet_f32), and its bf16 run's first loss (the
    # forward of the same weights on the same rows) within a bf16
    # rounding, the later ones printed
    tols = {name: [DP_LOSS_TOL] * len(ref[name]["losses"])
            for name, _ in parts}
    tols["resnet"] = [2.0 ** -8] + [float("inf")] * (DP_RESNET_STEPS - 1)
    launches = {n: 0 for n in KERNELS}
    failed = []
    for name, _ in parts:
        r0 = ranks[0][name]
        losses, base = r0["losses"], ref[name]["losses"]
        diffs = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
        log(f"dp {name} on {card}: mesh {r0['mesh']}, step p50 "
            f"{r0['p50']:.2f} ms (one device {ref[name]['p50']:.2f} ms), "
            f"losses {[round(x, 4) for x in losses]} vs one device's: "
            f"relative {[f'{d:.2e}' for d in diffs]} (tol "
            f"{[f'{t:.2e}' for t in tols[name]]}); "
            f"drift {[r[name]['drift'] for r in ranks]}; buckets "
            f"{r0['buckets']}; peak memory a rank "
            f"{[round(r[name]['peak_gib'], 2) for r in ranks]} GiB")
        for r, rk in enumerate(ranks):
            log(f"dp {name} rank {r} launches: {rk[name]['launches']}")
            short = [k for k in want_rows[name]
                     if rk[name]["launches"][k] < 1]
            if short:
                raise AssertionError(f"dp {name}: rank {r} never launched "
                                     f"{short}")
            for k in KERNELS:
                launches[k] += rk[name]["launches"][k]
        if r0["mesh"] != {"data": DP_RANKS} or len(losses) != len(base):
            raise AssertionError(f"dp {name}: mesh {r0['mesh']}, "
                                 f"{len(losses)} steps")
        if not all(np.isfinite(losses)) or any(
                d > t for d, t in zip(diffs, tols[name])):
            failed.append(f"dp {name}: losses {losses} leave the "
                          f"one-device run's {base}")
        if any(rk[name]["drift"] != 0.0 for rk in ranks):
            raise AssertionError(f"dp {name}: replicas drifted")
        MEASURED[f"dp_{name}"] = r0["p50"]
    if failed:
        raise AssertionError("; ".join(failed))
    if not ranks[0]["alexnet_overlap"]["buckets"]:
        raise AssertionError("dp alexnet_overlap: no bucket plan (the "
                             "implicit step ran)")
    shards = ranks[0]["lm_zero"]["zero_shards"]
    log(f"dp lm_zero: {ranks[0]['lm_zero']['zero_leaves']} ZeRO leaves; "
        f"row 13 took the shards {shards}")
    if not shards:
        raise AssertionError("dp lm_zero: no ZeRO shard through row 13")
    bufs = [rk[n]["buffers"] for rk in ranks for n in ("resnet",
                                                         "resnet_f32")]
    same = all(torch.equal(a[k][t], b[k][t])
               for a, b in ((bufs[0], bufs[2]), (bufs[1], bufs[3]))
               for k in a for t in a[k])
    moved = min(float((g["moving_var"] - 1).abs().max())
                for g in bufs[0].values())
    log(f"dp resnet: {len(bufs[0])} batch_norm layers' moving buffers "
        f"bitwise equal across the ranks: {same}; least moving_var "
        f"change {moved:.3e}")
    if not same or not bufs[0] or moved <= 0:
        raise AssertionError("dp resnet: moving buffers differ across the "
                             "ranks or did not move")
    nccl_out = os.path.join(tmp, "dp_nccl.json")
    meshlib.spawn(_dp_nccl, 1, (nccl_out,), backend="nccl",
                  timeout_sec=DP_TIMEOUT_SEC)
    with open(nccl_out) as f:
        nccl = json.load(f)
    log(f"dp (d): NCCL {nccl['nccl']} at world size 1, outputs equal to "
        f"their inputs: {nccl['checked']}; collective calls {nccl['calls']}")
    n_card = torch.cuda.device_count()
    if n_card == 1:
        r = subprocess.run(
            [sys.executable, "-m", "cxxnet_tpu_torch", parts[0][1][0],
             "dev=gpu:0-1", "synth_device_data=1", "num_round=1",
             "save_model=0"], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        msg = [ln for ln in r.stderr.splitlines() if "CUDA device" in ln]
        log(f"dp (e): dev = gpu:0-1 on one card: exit {r.returncode}, "
            f"{msg[-1] if msg else r.stderr[-300:]}")
        if r.returncode == 0 or not msg or "2 CUDA device" not in msg[-1] \
                or "but 1 are visible" not in msg[-1]:
            raise AssertionError("dp (e): the CLI did not refuse two ids "
                                 "on one card with both counts")
    else:
        log(f"dp (e): {n_card} cards visible; the one-card refusal is not "
            "exercised")
    MEASURED["dp_shards"] = adam_shard_check([tuple(s) for s in shards])
    return launches


# ------------------------------------------------ sequence and experts
def seq_expert_corpus(tmp: str, label: str, batch: int, seqlen: int
                      ) -> str:
    """Four seeded token shards (the confs' ``tok_count = 4``) of vocab-
    512 phrase documents holding exactly SE_STEPS packed batches of
    ``batch`` x ``seqlen`` (and the lookahead token); returns the
    ``path_tok`` pattern."""
    from cxxnet_tpu_torch.io.text import write_token_shard
    rng = np.random.RandomState(23)
    phrases = [rng.randint(0, 512, rng.randint(8, 33)) for _ in range(16)]
    want = SE_STEPS * batch * seqlen + 1
    docs, total = [], 0
    while total < want:
        n = min(rng.randint(DOC_LENS[0], DOC_LENS[1] + 1), want - total)
        doc = np.concatenate([phrases[rng.randint(16)]
                              for _ in range(n // 8 + 1)])[:n]
        docs.append(doc)
        total += n
    pattern = os.path.join(tmp, f"{label}_%d.tok")
    for i in range(4):
        write_token_shard(pattern % i, docs[i::4], itemsize=2)
    return pattern


def seq_expert_parts(tmp: str) -> list:
    """The seq_expert path's CLI runs ``(name, argv)``, each a conf as
    shipped over its seeded corpus for one round of SE_STEPS steps on
    the card, the replicas checked after the round."""
    lm = os.path.join(REPO, "example", "LM")
    long_tok = seq_expert_corpus(tmp, "se_long", 8, 256)
    moe_tok = seq_expert_corpus(tmp, "se_moe", 8, 128)
    common = ["dev=gpu", "max_round=1", "save_model=0", "print_step=1",
              "test_on_server=1", "silent=1"]
    return [("longctx", [os.path.join(lm, "longctx.conf"),
                         f"path_tok={long_tok}"] + common),
            ("moe_expert", [os.path.join(lm, "moe_lm.conf"),
                            f"path_tok={moe_tok}"] + common),
            ("moe_model", [os.path.join(lm, "moe_lm.conf"),
                           f"path_tok={moe_tok}", "mesh=data:2,model:2"]
             + common)]


def _seq_expert_rank(rank: int, tmp: str, parts: list) -> None:
    """A rank of the seq_expert path: every part in turn, its results
    saved."""
    import torch
    arm_stack_dump()
    torch.cuda.set_device(0)
    out = {name: dp_run(name, argv) for name, argv in parts}
    torch.save(out, os.path.join(tmp, f"se_rank{rank}.pt"))


def ring_inputs(dev):
    """Part (d)'s seeded bf16 q, k, v, cotangent and packed segment ids
    at SE_RING_SHAPE, the same in every process."""
    import torch
    b, h, s, hd = SE_RING_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    q, k, v, g = (torch.randn((b, h, s, hd), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    seg = torch.from_numpy(seeded_segments(np.random.RandomState(31), b, s,
                                           64)).to(dev)
    return q, k, v, g, seg


def _ring_rank(rank: int, tmp: str) -> None:
    """Part (d) on one of 2 seq ranks sharing cuda:0: the ring's forward
    and backward on the rank's block, its outputs saved, then
    SE_RING_REPS timed forward + backward calls and the peak memory."""
    import torch
    from cxxnet_tpu_torch.parallel import mesh as meshlib, ring
    arm_stack_dump()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    m = meshlib.build_mesh(meshlib.MeshSpec({"seq": 2}), dev)
    q, k, v, g, seg = ring_inputs(dev)
    s_local = q.shape[2] // 2
    blk = slice(rank * s_local, (rank + 1) * s_local)
    q, k, v, g = (t[:, :, blk].contiguous() for t in (q, k, v, g))
    seg = seg[:, blk].contiguous()

    def run():
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = ring.ring_attention(qs, ks, vs, m, "seq", causal=True,
                                  seg=seg)
        out.backward(g)
        return out.detach(), qs.grad, ks.grad, vs.grad

    torch.cuda.reset_peak_memory_stats()
    got = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = []
    for _ in range(SE_RING_REPS):
        meshlib.barrier(m)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    torch.save(dict(got=[t.cpu() for t in got], ms=ms, peak=peak,
                    shifts=meshlib.counts["ring_shift"]),
               os.path.join(tmp, f"se_ring{rank}.pt"))


def seq_expert_ring(tmp: str, card: str) -> None:
    """Part (d): the ring on 2 gloo seq ranks on cuda:0 against the
    one-device segmented flash forward and backward (rows 9 and 10,
    launched here only to compare: not counted with the path)."""
    import torch
    from cxxnet_tpu_torch.ops.flash_attention import \
        flash_attention_segmented
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    t0 = time.perf_counter()
    meshlib.spawn(_ring_rank, 2, (tmp,), backend="gloo",
                  timeout_sec=DP_TIMEOUT_SEC)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"se_ring{r}.pt"))
             for r in range(2)]
    dev = torch.device("cuda", 0)
    q, k, v, g, seg = ring_inputs(dev)
    b, h, s, hd = SE_RING_SHAPE
    q3, k3, v3 = (t.reshape(b * h, s, hd).clone().requires_grad_()
                  for t in (q, k, v))
    out = flash_attention_segmented(q3, k3, v3, seg)
    out.backward(g.reshape(b * h, s, hd))
    ref = [t.reshape(b, h, s, hd).float() for t in
           (out.detach(), q3.grad, k3.grad, v3.grad)]
    got = [torch.cat([r["got"][i] for r in ranks], 2).to(dev).float()
           for i in range(4)]
    errs = {n: float((a - r).norm() / r.norm())
            for n, a, r in zip(("out", "dq", "dk", "dv"), got, ref)}
    log(f"seq_expert (d) on {card}: ring attention b{b} h{h} s{s} hd{hd} "
        f"bf16 causal + packed segments on 2 seq ranks of cuda:0 (gloo) "
        f"against the one-device segmented flash (rows 9, 10): normwise "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol {SE_RING_TOL:g}); forward + backward a rank "
        f"{[round(float(np.median(r['ms'])), 2) for r in ranks]} ms "
        f"(median of {SE_RING_REPS}), peak memory a rank "
        f"{[round(r['peak'] / 2 ** 30, 2) for r in ranks]} GiB, "
        f"{ranks[0]['shifts']} ring shifts a rank; {wall:.1f} s")
    MEASURED["se_ring_ms"] = [float(np.median(r["ms"])) for r in ranks]
    bad = {n: e for n, e in errs.items() if not e <= SE_RING_TOL}
    if bad:
        raise AssertionError(f"seq_expert (d): the ring leaves the flash "
                             f"kernels' result: {bad}")


def phase_seq_expert(tmp: str) -> dict:
    """Sequence and expert parallelism (``seq_expert``): SE_RANKS gloo
    ranks share cuda:0 (spawned by the port's mesh module; gloo stages
    CUDA tensors' collectives and ring shifts through the host), each
    running the port's CLI: (a) longctx.conf at data:2,seq:2 (ring
    attention over seq), (b) moe_lm.conf at data:2,expert:2 and its net
    at data:2,model:2, SE_STEPS steps each with ``test_on_server = 1``,
    against the same CLI run on one device (``mesh = data:1``): the
    first loss within SE_FIRST_TOL, every loss within DP_LOSS_TOL, the
    replicas bitwise equal, each rank holding half of the per-expert
    bytes; (c) moe_lm.conf on one device under moe_dispatch sorted and
    dense; (d) the ring at the served LM's width against rows 9 and 10.
    Returns the path's launches: the mesh ranks' (rows 11 and 12 a rank;
    9 and 10 where attention is not a ring) and the one-device runs'."""
    import torch
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    parts = seq_expert_parts(tmp)
    card = card_line()
    launches = {n: 0 for n in KERNELS}
    ref = {}
    for name, argv in parts[:2] + [("moe_dense", parts[1][1]
                                    + ["moe_dispatch=dense"])]:
        ref[name] = dp_run(name, argv + ["mesh=data:1"])
        for n in KERNELS:
            launches[n] += ref[name]["launches"][n]
        log(f"seq_expert reference {name} (one device): losses "
            f"{[round(x, 5) for x in ref[name]['losses']]}, step p50 "
            f"{ref[name]['p50']:.2f} ms, peak {ref[name]['peak_gib']:.2f} "
            f"GiB, launches {ref[name]['launches']}")
    ref["moe_model"] = ref["moe_expert"]
    srt, dense = ref["moe_expert"]["losses"], ref["moe_dense"]["losses"]
    ddiff = max(abs(a - b) / abs(b) for a, b in zip(srt, dense))
    log(f"seq_expert (c): moe_lm.conf on one device, moe_dispatch sorted "
        f"against dense: largest relative loss difference {ddiff:.2e} "
        f"(tol {SE_DISPATCH_TOL:g})")
    if len(srt) != SE_STEPS or not ddiff <= SE_DISPATCH_TOL:
        raise AssertionError(f"seq_expert (c): sorted {srt} dense {dense}")
    t0 = time.perf_counter()
    meshlib.spawn(_seq_expert_rank, SE_RANKS, (tmp, parts), backend="gloo",
                  timeout_sec=DP_TIMEOUT_SEC)
    log(f"seq_expert: {SE_RANKS} gloo ranks on cuda:0, {len(parts)} runs "
        f"each, {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(tmp, f"se_rank{r}.pt"))
             for r in range(SE_RANKS)]
    want_mesh = {"longctx": {"data": 2, "seq": 2},
                 "moe_expert": {"data": 2, "expert": 2},
                 "moe_model": {"data": 2, "model": 2}}
    for name, _ in parts:
        r0 = ranks[0][name]
        losses, base = r0["losses"], ref[name]["losses"]
        diffs = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
        tols = [SE_FIRST_TOL] + [DP_LOSS_TOL] * (SE_STEPS - 1)
        held = [rk[name].get("expert_bytes") for rk in ranks]
        log(f"seq_expert {name} on {card}: mesh {r0['mesh']}, step p50 "
            f"a rank {[round(rk[name]['p50'], 2) for rk in ranks]} ms (one "
            f"device {ref[name]['p50']:.2f} ms), losses "
            f"{[round(x, 5) for x in losses]} vs one device's: relative "
            f"{[f'{d:.2e}' for d in diffs]}; drift "
            f"{[rk[name]['drift'] for rk in ranks]}; peak memory a rank "
            f"{[round(rk[name]['peak_gib'], 3) for rk in ranks]} GiB; "
            f"per-expert bytes held / logical a rank {held}")
        for r, rk in enumerate(ranks):
            log(f"seq_expert {name} rank {r} launches: "
                f"{rk[name]['launches']}")
            want = ("layernorm_fwd", "layernorm_bwd") if name == "longctx" \
                else ("layernorm_fwd", "layernorm_bwd",
                      "flash_attention_seg_fwd", "flash_attention_seg_bwd")
            short = [k for k in want if rk[name]["launches"][k] < SE_STEPS]
            if short:
                raise AssertionError(f"seq_expert {name}: rank {r} "
                                     f"launched {short} less than once a "
                                     "step")
            for k in KERNELS:
                launches[k] += rk[name]["launches"][k]
        if r0["mesh"] != want_mesh[name] or len(losses) != SE_STEPS:
            raise AssertionError(f"seq_expert {name}: mesh {r0['mesh']}, "
                                 f"{len(losses)} steps")
        if not all(np.isfinite(losses)) or any(
                not d <= t for d, t in zip(diffs, tols)):
            raise AssertionError(f"seq_expert {name}: losses {losses} "
                                 f"leave the one-device run's {base}")
        if any(rk[name]["drift"] != 0.0 for rk in ranks):
            raise AssertionError(f"seq_expert {name}: replicas drifted")
        if name != "longctx" and any(
                h is None or h[1] == 0 or 2 * h[0] != h[1] for h in held):
            raise AssertionError(f"seq_expert {name}: per-expert bytes "
                                 f"held / logical {held}: not half")
        MEASURED[f"se_{name}"] = [rk[name]["p50"] for rk in ranks]
    seq_expert_ring(tmp, card)
    return launches


# ------------------------------------------------------------- pipeline
def pipe_parts(tmp: str) -> tuple:
    """The pipe path's CLI runs: (a)'s on PIPE_RANKS ranks, (b)'s on 2,
    each ``(name, argv, how the replicas are checked)`` (``dp_run``'s
    ``drift``)."""
    lm = os.path.join(REPO, "example", "LM", "pipeline_lm.conf")
    tok = seq_expert_corpus(tmp, "pipe_lm", 16, 128)
    common = [f"path_tok={tok}", "dev=gpu", "max_round=1", "save_model=0",
              "print_step=1", "test_on_server=1", "silent=1"]
    a = [("lm_1f1b", [lm] + common, "weights"),
         ("lm_gpipe", [lm] + common + ["pipe_schedule=gpipe"], "weights")]
    flag = lm_train_conf(tmp, "pipe_flag", True, PIPE_LAYERS, NHEAD,
                         PIPE_STEPS, True)
    # the wide runs: PIPE_WIDE_STEPS batches of PIPE_MICRO_WIDE rows
    flag_wide = lm_train_conf(
        tmp, "pipe_flag_wide", True, PIPE_LAYERS, NHEAD,
        PIPE_WIDE_STEPS * PIPE_MICRO_WIDE // TRAIN_BATCH, True)
    pp = [flag, "mesh=pipe:2"] + PREFETCH_ARGS
    wide = [flag_wide, "mesh=pipe:2", f"batch_size={PIPE_MICRO_WIDE}",
            f"pipe_microbatch={PIPE_MICRO_WIDE}"] + PREFETCH_ARGS
    # (b)'s replicas: 3.8 GB of state a rank, compared by digest (the
    # weight check all-gathers it through the host: ~11 s a run)
    b = [("flag_1f1b", pp + ["pipe_schedule=1f1b",
                             f"pipe_microbatch={PIPE_MICRO}"], "digest"),
         ("flag_gpipe", pp + ["pipe_schedule=gpipe",
                              f"pipe_microbatch={PIPE_MICRO}"], "digest"),
         ("flag_1f1b_wide", wide + ["pipe_schedule=1f1b"], None),
         ("flag_gpipe_wide", wide + ["pipe_schedule=gpipe"], None)]
    return a, b


def _pipe_rank(rank: int, tmp: str, label: str, parts: list) -> None:
    """A rank of the pipe path: every part in turn, its results saved."""
    import torch
    arm_stack_dump()
    torch.cuda.set_device(0)
    out = {name: dp_run(name, argv, drift) for name, argv, drift in parts}
    torch.save(out, os.path.join(tmp, f"pipe_{label}{rank}.pt"))


def phase_pipe(tmp: str) -> dict:
    """Pipeline parallelism (``pipe``): gloo ranks share cuda:0 (spawned
    by the port's mesh module; stage handoffs and collectives of CUDA
    tensors staged through the host), each running the port's CLI.  (a)
    pipeline_lm.conf as shipped on PIPE_RANKS ranks (data:2, pipe:2,
    model:2; 1F1B with dp_overlap's (pipe, data) buckets), then under
    GPipe, SE_STEPS steps, against one device: the first loss within
    SE_FIRST_TOL, every loss within DP_LOSS_TOL, the replicas bitwise,
    rows 9-12 on every rank (f32: row 9 on the CUDA cores).  (b) the
    flagship packed LM (d 2048, 16 heads, s 4096, vocab 8192, bf16,
    fused adam) cut to PIPE_LAYERS blocks, two a stage, on 2 ranks under
    1F1B and GPipe at PIPE_MICRO microbatches, against one device within
    DP_LOSS_TOL, replicas bitwise (:func:`state_digest` of every leaf),
    rows 9-13 on both ranks; then at
    PIPE_MICRO_WIDE microbatches of the same row each (batch 8): the
    peak memory a rank flat under 1F1B (within PIPE_FLAT_TOL), printed
    under GPipe.  Prints the step p50, peak GiB and handoffs a step a
    rank and the bubble share.  Returns the path's launches, summed over
    the ranks and the one-device runs."""
    import torch
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    card = card_line()
    a, b = pipe_parts(tmp)
    launches = {n: 0 for n in KERNELS}
    ref = {}
    for name, argv in (("lm", a[0][1] + ["mesh=data:1"]),
                       ("flag", b[0][1][:1] + ["dev=gpu"] + PREFETCH_ARGS)):
        ref[name] = dp_run(name, argv)
        for n in KERNELS:
            launches[n] += ref[name]["launches"][n]
        log(f"pipe reference {name} (one device): losses "
            f"{[round(x, 5) for x in ref[name]['losses']]}, step p50 "
            f"{ref[name]['p50']:.2f} ms, peak {ref[name]['peak_gib']:.2f} "
            f"GiB")
    ranks = {}
    for label, parts, n in (("a", a, PIPE_RANKS), ("b", b, 2)):
        t0 = time.perf_counter()
        meshlib.spawn(_pipe_rank, n, (tmp, label, parts), backend="gloo",
                      timeout_sec=DP_TIMEOUT_SEC)
        log(f"pipe ({label}): {n} gloo ranks on cuda:0, {len(parts)} runs "
            f"each, {time.perf_counter() - t0:.1f} s")
        ranks[label] = [torch.load(os.path.join(tmp, f"pipe_{label}{r}.pt"))
                        for r in range(n)]
    want = {"lm": {"data": 2, "pipe": 2, "model": 2}, "flag": {"pipe": 2}}
    rows = {"lm": ("flash_attention_seg_fwd", "flash_attention_seg_bwd",
                   "layernorm_fwd", "layernorm_bwd"),
            "flag": ("flash_attention_seg_fwd", "flash_attention_seg_bwd",
                     "layernorm_fwd", "layernorm_bwd", "fused_adam")}
    for label, parts in (("a", a), ("b", b)):
        for name, _, checked in parts:
            base = ref[name.split("_")[0]]
            rk = [r[name] for r in ranks[label]]
            r0 = rk[0]
            if checked == "digest":
                # every leaf's bits alike on both ranks: no drift
                for r in rk:
                    r["drift"] = 0.0 if r["digest"] == r0["digest"] \
                        else float("inf")
            losses = r0["losses"]
            diffs = [abs(x - y) / abs(y) for x, y in
                     zip(losses, base["losses"])]
            st = r0["pipe"]
            log(f"pipe {name} on {card}: mesh {r0['mesh']}, step p50 a rank "
                f"{[round(r['p50'], 2) for r in rk]} ms (one device "
                f"{base['p50']:.2f} ms), peak memory a rank "
                f"{[round(r['peak_gib'], 3) for r in rk]} GiB, handoffs a "
                f"step a rank {[r['pipe']['handoffs'] for r in rk]}, most "
                f"microbatches in flight a rank "
                f"{[r['pipe']['live_max'] for r in rk]}, pipe_bubble_frac "
                f"{st['bubble']:.4f}; losses "
                f"{[round(x, 5) for x in losses]} vs one device's: relative "
                f"{[f'{d:.2e}' for d in diffs]}; drift "
                f"{[r['drift'] for r in rk]} "
                f"({[round(r['drift_sec'], 1) for r in rk]} s); run wall a "
                f"rank {[round(r['wall'], 1) for r in rk]} s")
            for r, x in enumerate(rk):
                log(f"pipe {name} rank {r} launches: {x['launches']}")
                short = [k for k in rows[name.split("_")[0]]
                         if x["launches"][k] < len(x["losses"])]
                if short:
                    raise AssertionError(f"pipe {name}: rank {r} launched "
                                         f"{short} less than once a step")
                for k in KERNELS:
                    launches[k] += x["launches"][k]
            if r0["mesh"] != want[name.split("_")[0]] \
                    or not all(np.isfinite(losses)):
                raise AssertionError(f"pipe {name}: mesh {r0['mesh']}, "
                                     f"losses {losses}")
            if checked:
                tols = [SE_FIRST_TOL if label == "a" else DP_LOSS_TOL] \
                    + [DP_LOSS_TOL] * (len(base["losses"]) - 1)
                if len(losses) != len(base["losses"]) or any(
                        not d <= t for d, t in zip(diffs, tols)):
                    raise AssertionError(f"pipe {name}: losses {losses} "
                                         f"leave the one device's "
                                         f"{base['losses']}")
                if any(r["drift"] != 0.0 for r in rk):
                    raise AssertionError(f"pipe {name}: replicas drifted")
            MEASURED[f"pipe_{name}"] = dict(
                p50=[r["p50"] for r in rk], peak=[r["peak_gib"] for r in rk],
                handoffs=[r["pipe"]["handoffs"] for r in rk])
    for sched in ("1f1b", "gpipe"):
        narrow = [r[f"flag_{sched}"]["peak_gib"] for r in ranks["b"]]
        wide = [r[f"flag_{sched}_wide"]["peak_gib"] for r in ranks["b"]]
        growth = [w / n - 1 for n, w in zip(narrow, wide)]
        log(f"pipe (b) {sched}: peak memory a rank at pipe_microbatch "
            f"{PIPE_MICRO} {[round(x, 3) for x in narrow]} GiB, at "
            f"{PIPE_MICRO_WIDE} {[round(x, 3) for x in wide]} GiB (a row a "
            f"microbatch): growth {[f'{g:+.1%}' for g in growth]}")
        if sched == "1f1b" and any(abs(g) > PIPE_FLAT_TOL for g in growth):
            raise AssertionError(f"pipe (b): 1F1B peak memory not flat in "
                                 f"pipe_microbatch: {narrow} -> {wide}")
    return launches


# ------------------------------------------------------ inference on a mesh
def infer_mesh_conf(tmp: str, src: str, data: str, out: str) -> str:
    """example/MNIST/``src`` on the card with its data in ``data`` and its
    pred section (and metrics sink) writing next to ``out``; returns the
    conf's path."""
    text = open(os.path.join(REPO, "example", "MNIST", src)).read()
    conf = out + ".conf"
    with open(conf, "w") as f:
        f.write(text.replace("./data/", data + "/")
                .replace("dev = cpu", "dev = gpu")
                .replace("pred = out.txt", f"pred = {out}")
                .replace("pred = serve_out.txt", f"pred = {out}")
                .replace("jsonl:serve_metrics.jsonl", f"jsonl:{out}.jsonl"))
    return conf


def infer_mesh_parts(tmp: str, who: str) -> list:
    """The infer_mesh runs of ``who`` (``mesh``: a rank of the group;
    ``one``: one device), ``(name, CLI argv, strict float32)``, each
    writing ``tmp/infer_mesh_<who>_<name>``."""
    snap = os.path.join(tmp, "mnist_models", f"{MNIST_ROUNDS:04d}.model")
    mnist = [f"model_in={snap}", "input_flat=0", "pool_layout=hwcn",
             "silent=1"]
    out = {n: os.path.join(tmp, f"infer_mesh_{who}_{n}")
           for n in ("pred", "pred_raw", "extract", "serve_pred", "serve",
                     "alexnet", "alexnet_rank_batch")}
    data, data_2k = (os.path.join(tmp, d) for d in ("mnist", "mnist_2k"))
    parts = [(n, [infer_mesh_conf(tmp, "MNIST_pred.conf", data, out[n])]
              + mnist + extra, True)
             for n, extra in (("pred", ["task=pred"]),
                              ("pred_raw", ["task=pred_raw"]),
                              ("extract", ["task=extract",
                                           f"extract_node_name={EXTRACT_NODE}",
                                           "output_format=bin"]))]
    parts.append(("serve_pred", [infer_mesh_conf(
        tmp, "MNIST_pred.conf", data_2k, out["serve_pred"])] + mnist
        + ["task=pred"], True))
    parts.append(("serve", [infer_mesh_conf(
        tmp, "serve.conf", data_2k, out["serve"])] + mnist
        + ["serve_dtype=f32", f"serve_clients={CLIENTS}",
           "serve_shapes=" + ",".join(map(str, INFER_SHAPES))], True))
    # one device also at a rank's batch: a rank's forward is that one
    alex = [("alexnet", [])] + ([("alexnet_rank_batch", [
        f"batch_size={INFER_ALEX_BATCH // INFER_RANKS}"])] if who == "one"
        else [])
    for name, extra in alex:
        parts.append((name, [
            alexnet_data_conf(tmp), "task=pred_raw",
            f"model_in={tmp}/infer_mesh_alexnet/0000.model"]
            + list(INFER_ALEX_ARGS) + PREFETCH_ARGS + extra
            + [f"pred={out[name]}", "iter=imgbin",
               f"image_list={tmp}/test.lst", f"image_bin={tmp}/test.bin",
               f"image_mean={tmp}/image_net_mean.npz", "iter=end"], False))
    return parts


def infer_run(name: str, argv: list, strict: bool) -> dict:
    """One CLI run of infer_mesh in this process (one device, or a rank
    of the group; float32 without TF32 under ``strict``): its exit code,
    wall, launches (the counters set to 0 just before), the summed
    per-batch latency and, on the rank that serves, the serve stats."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if strict:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    reset_launches()
    task = LearnTask()
    t0 = time.perf_counter()
    try:
        rc = task.run(argv)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    wall = time.perf_counter() - t0
    hist = task.net.metrics.histograms
    lat = hist.get("extract_latency_sec" if name == "extract"
                   else "pred_latency_sec")
    lat = lat.summary() if lat is not None else {"count": 0, "sum": 0.0}
    res = dict(rc=rc, wall=wall, launches=read_launches(),
               batches=int(lat["count"]), latency_sec=float(lat["sum"]),
               p50_sec=float(lat.get("p50", 0.0)),
               serve=task.last_serve,
               mesh=None if task.net.mesh is None
               else dict(task.net.mesh.axes))
    del task
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _infer_mesh_rank(rank: int, tmp: str, parts: list) -> None:
    """A rank of infer_mesh: every part in turn, its results saved."""
    import torch
    arm_stack_dump()
    torch.cuda.set_device(0)
    out = {name: infer_run(name, argv, strict)
           for name, argv, strict in parts}
    with open(os.path.join(tmp, f"infer_mesh_rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)


def normwise(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| / max |ref| of two host arrays of one shape (inf
    where the shapes differ)."""
    if got.shape != ref.shape:
        return float("inf")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def infer_rows(tmp: str, who: str, name: str) -> np.ndarray:
    """The rows ``who``'s run ``name`` wrote (text, or binary rows of
    the ``.meta`` width)."""
    path = os.path.join(tmp, f"infer_mesh_{who}_{name}")
    if name == "extract":
        meta = int(open(path + ".meta").read())
        return np.fromfile(path, "<f4").reshape(-1, meta)
    return np.loadtxt(path, np.float32, ndmin=2)


def phase_infer_mesh(tmp: str) -> dict:
    """Phase 29 (``infer_mesh``): ``pred`` / ``pred_raw`` / ``extract``
    and micro-batched ``serve`` on INFER_RANKS gloo ranks sharing cuda:0
    (one spawn, the port's CLI in the group), each held to the same CLI
    run on one device here: (a) MNIST_pred.conf from the mnist_conv
    phase's snapshot in f32 without TF32, (b) serve.conf over
    INFER_SERVE_ROWS seeded images, (c) ImageNet.conf's ``pred_raw`` at
    batch 256 in bf16 over the alexnet_data phase's eval pack (and on
    one device at a rank's batch too), rows 1 and 3 on each rank.
    Returns the group's launches, summed over the ranks."""
    import torch
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    card = card_line()
    data_2k = os.path.join(tmp, "mnist_2k")
    if not os.path.exists(data_2k):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "make_synth_mnist.py"),
                        "--out", data_2k, "--train", "10", "--test",
                        str(INFER_SERVE_ROWS)], check=True,
                       capture_output=True)
    # AlexNet's seeded initial weights, the snapshot both sides load
    if LearnTask().run([alexnet_data_conf(tmp), "num_round=0",
                        "save_model=1", f"model_dir={tmp}/infer_mesh_alexnet"]
                       + list(INFER_ALEX_ARGS)) != 0:
        raise AssertionError("infer_mesh: the AlexNet snapshot")
    one = {name: infer_run(name, argv, strict)
           for name, argv, strict in infer_mesh_parts(tmp, "one")}
    t0 = time.perf_counter()
    meshlib.spawn(_infer_mesh_rank, INFER_RANKS,
                  (tmp, infer_mesh_parts(tmp, "mesh")), backend="gloo",
                  timeout_sec=DP_TIMEOUT_SEC)
    spawn_sec = time.perf_counter() - t0
    ranks = []
    for r in range(INFER_RANKS):
        with open(os.path.join(tmp, f"infer_mesh_rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"infer_mesh: {INFER_RANKS} gloo ranks on cuda:0, "
        f"{len(ranks[0])} CLI runs each, {spawn_sec:.1f} s ({card})")
    return infer_mesh_report(tmp, one, ranks, card)


def infer_mesh_report(tmp: str, one: dict, ranks: list, card: str) -> dict:
    """infer_mesh's checks and numbers from the one-device runs ``one``
    and each rank's runs ``ranks`` (and the files they wrote); returns
    the group's launches, summed over the ranks."""
    mesh = ranks[0]
    for name in mesh:
        if any(rk[name]["rc"] != 0 for rk in ranks) or one[name]["rc"]:
            raise AssertionError(f"infer_mesh {name}: a CLI run failed")
        if any(rk[name]["mesh"] != {"data": INFER_RANKS} for rk in ranks):
            raise AssertionError(f"infer_mesh {name}: meshes "
                                 f"{[rk[name]['mesh'] for rk in ranks]}")

    def rate_line(name: str, what: str) -> None:
        rows = {who: infer_rows(tmp, who, name).shape[0]
                for who in ("mesh", "one")}
        a, b = mesh[name], one[name]
        per = rows["mesh"] / a["batches"]
        log(f"infer_mesh {what}: {rows['mesh']} rows in {a['batches']} "
            f"batches; rows/s over the summed batch latency "
            f"{rows['mesh'] / a['latency_sec']:.1f} on {INFER_RANKS} ranks "
            f"vs {rows['one'] / b['latency_sec']:.1f} on one device; over "
            f"the batch p50 {per / a['p50_sec']:.1f} vs "
            f"{per / b['p50_sec']:.1f} (CLI wall {a['wall']:.2f} / "
            f"{b['wall']:.2f} s; {card})")

    # (a) MNIST: ids where one device's top two are apart, rows normwise
    labels = read_mnist_labels(os.path.join(tmp, "mnist",
                                            "t10k-labels-idx1-ubyte.gz"))
    raw_one = infer_rows(tmp, "one", "pred_raw")
    margin = np.array([top2_margin(r) for r in raw_one])
    ids = {who: infer_rows(tmp, who, "pred")[:, 0]
           for who in ("mesh", "one")}
    clear = margin > INFER_MARGIN
    differ = int(np.sum(ids["mesh"][clear] != ids["one"][clear]))
    errs = {n: normwise(infer_rows(tmp, "mesh", n),
                        infer_rows(tmp, "one", n))
            for n in ("pred_raw", "extract")}
    log(f"infer_mesh (a): MNIST_pred.conf, {ids['mesh'].size} rows: "
        f"class ids differ on {differ} of the {int(clear.sum())} rows "
        f"whose top two are more than {INFER_MARGIN:g} apart; pred_raw "
        f"{errs['pred_raw']:.3e}, extract {errs['extract']:.3e} normwise "
        f"(tol {INFER_F32_TOL:g})")
    for name in ("pred", "pred_raw", "extract"):
        rate_line(name, f"(a) {name}")
    if ids["mesh"].size != labels.size or differ \
            or max(errs.values()) > INFER_F32_TOL:
        raise AssertionError(f"infer_mesh (a): ids differ on {differ} "
                             f"rows, errors {errs}")
    # (b) serve on the group against pred on the group
    served = infer_rows(tmp, "mesh", "serve")[:, 0]
    pred_2k = infer_rows(tmp, "mesh", "serve_pred")[:, 0]
    st, st_one = mesh["serve"]["serve"], one["serve"]["serve"]
    agree = float(np.mean(served == pred_2k)) if served.size \
        == pred_2k.size else 0.0
    log(f"infer_mesh (b): serve.conf f32 on {INFER_RANKS} ranks: "
        f"{st['requests']} requests, {st['qps']:.1f} req/s vs "
        f"{st_one['qps']:.1f} req/s on one device; mean batch "
        f"{st['mean_batch']}, buckets {st['engine']['bucket_hist']}, "
        f"retraces {st['retraces']}; agreement with task = pred on the "
        f"ranks {agree:.6f} ({card})")
    if served.size != INFER_SERVE_ROWS or st["retraces"] \
            or agree < BATCH_AGREE or ranks[1]["serve"]["serve"] is not None:
        raise AssertionError(f"infer_mesh (b): {served.size} answers, "
                             f"agreement {agree}, retraces "
                             f"{st['retraces']}")
    # (c) AlexNet at full width
    raw = {who: infer_rows(tmp, who, "alexnet") for who in ("mesh", "one")}
    half = infer_rows(tmp, "one", "alexnet_rank_batch")

    def agreement(a, b) -> float:
        return float(np.mean(a.argmax(1) == b.argmax(1))) \
            if a.shape == b.shape else 0.0
    # a rank's forward is one device's at the rank's batch; one device's
    # bf16 rows move with the batch alone (cuDNN's algorithms, the
    # kernels' routes), which sets what the full batch is held to
    err_half, agree_half = normwise(raw["mesh"], half), \
        agreement(raw["mesh"], half)
    err, agree = normwise(raw["mesh"], raw["one"]), \
        agreement(raw["mesh"], raw["one"])
    spread, agree_own = normwise(half, raw["one"]), \
        agreement(half, raw["one"])
    batches = DATA_EVAL_IMAGES // INFER_ALEX_BATCH
    per = {n: [rk["alexnet"]["launches"][n] for rk in ranks]
           for n in ALEXNET_EVAL_PER_BATCH}
    log(f"infer_mesh (c): ImageNet.conf pred_raw, bf16, {raw['mesh'].shape}"
        f" rows: against one device at a rank's batch "
        f"({INFER_ALEX_BATCH // INFER_RANKS}) {err_half:.3e} normwise (tol "
        f"{INFER_F32_TOL:g}), argmax agreement {agree_half:.4f} (min 1); "
        f"against one device at {INFER_ALEX_BATCH} {err:.3e} normwise, "
        f"argmax agreement {agree:.4f}, where one device alone moves "
        f"{spread:.3e} / {agree_own:.4f} from batch "
        f"{INFER_ALEX_BATCH // INFER_RANKS} to {INFER_ALEX_BATCH} (tol "
        f"max({INFER_BF16_TOL:g}, that) / min({INFER_AGREE}, that)); "
        f"launches a rank {per} for {batches} batches; one device "
        f"{ {n: one['alexnet']['launches'][n] for n in per} }")
    rate_line("alexnet", "(c) alexnet pred_raw")
    if raw["mesh"].shape != (DATA_EVAL_IMAGES, 1000) \
            or err_half > INFER_F32_TOL or agree_half < 1.0 \
            or err > max(INFER_BF16_TOL, spread) \
            or agree < min(INFER_AGREE, agree_own) or any(
                c != ALEXNET_EVAL_PER_BATCH[n] * batches
                for n, cs in per.items() for c in cs):
        raise AssertionError(f"infer_mesh (c): rows {raw['mesh'].shape}, "
                             f"errors {err_half} / {err}, agreement "
                             f"{agree_half} / {agree}, launches {per}")
    launches = {n: 0 for n in KERNELS}
    for rk in ranks:
        for run in rk.values():
            for n in KERNELS:
                launches[n] += run["launches"][n]
    log(f"infer_mesh path launches (both ranks): {launches}")
    if launches["max_pool_fwd"] < 1 or launches["lrn_fwd"] < 1:
        raise AssertionError("infer_mesh: rows 1 and 3 never launched")
    return launches



def phase_wrapper(tmp: str) -> dict:
    """Phase 25 (``wrapper``): the port's Python and C frontends on the
    card.  (a) ``wrapper.api.train`` of MNIST_CONV.conf's net (rows 3-5
    under ``pool_layout = hwcn fast_wgrad = hwcn``) over
    tools/make_synth_mnist.py data through ``DataIter``, WRAPPER_ROUNDS
    rounds of 60 batches of 100, an eval line a round; then
    ``predict`` / ``extract`` / ``get_weight`` / ``set_weight`` (a
    weight written and read back) / ``save_model`` / ``load_model``:
    a reloaded net predicts as the trained one, row for row.  (b) a
    ``ServingHost`` over the snapshot answering the test rows from
    WRAPPER_CLIENTS threads: its rows within F32_TOL of the net's raw
    forward, the argmax equal to ``Net.predict``'s on BATCH_AGREE of
    them, no retrace.  (c) the C ABI (cxxnet_tpu_torch/native/capi.cc,
    built here) in this process through ctypes: the snapshot loaded on
    the card predicts as the wrapper's net, a batch updates it, and a
    weight reads back; then the C demo from a fresh interpreter on the
    card (train, save, reload, accuracy).  Returns the path's launches
    (rows 3-5 every training step)."""
    import ctypes
    import threading
    import torch
    from cxxnet_tpu_torch.native import build
    from cxxnet_tpu_torch.wrapper import api
    mnist_conv_conf(tmp)  # makes the data in tmp/mnist once
    data = os.path.join(tmp, "mnist")
    it_cfg = (f"iter = mnist\npath_img = {data}/train-images-idx3-ubyte.gz\n"
              f"path_label = {data}/train-labels-idx1-ubyte.gz\n"
              "input_flat = 0\nbatch_size = 100\nshuffle = 1\n")
    test_cfg = (f"iter = mnist\npath_img = {data}/t10k-images-idx3-ubyte.gz\n"
                f"path_label = {data}/t10k-labels-idx1-ubyte.gz\n"
                "input_flat = 0\nbatch_size = 100\n")
    cfg = wrapper_cfg()
    reset_launches()
    t0 = time.perf_counter()
    net = api.train(cfg, api.DataIter(it_cfg), WRAPPER_ROUNDS, {},
                    eval_data=api.DataIter(test_cfg))
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = net._trainer.sample_counter
    line = net.evaluate(api.DataIter(test_cfg), "test")
    log(f"wrapper (a): train {WRAPPER_ROUNDS} rounds, {steps} steps on "
        f"{net._trainer.device} in {wall:.1f} s; {line.strip()}; launches "
        f"{launches}")
    if net._trainer.device.type != "cuda" or any(
            launches[n] < steps for n in ("max_pool_fwd", "max_pool_bwd",
                                          "conv_wgrad")):
        raise AssertionError(f"wrapper (a): {launches} over {steps} steps")
    it = api.DataIter(test_cfg)
    it.before_first()
    assert it.next()
    x = it.get_data().copy()
    pred = net.predict(x)
    feat = net.extract(x, EXTRACT_NODE)
    w = net.get_weight("fc2", "bias")
    net.set_weight(w + 0.5, "fc2", "bias")
    back = net.get_weight("fc2", "bias")
    net.set_weight(w, "fc2", "bias")
    model = os.path.join(tmp, "wrapper.model")
    net.save_model(model)
    net2 = api.Net(cfg="batch_size = 100\nsilent = 1\n")
    net2.load_model(model)
    same = bool((net2.predict(x) == pred).all())
    log(f"wrapper (a): predict {pred.shape}, extract node {EXTRACT_NODE} "
        f"{feat.shape}, "
        f"set/get weight {np.abs(back - w - 0.5).max():.1e}, reloaded "
        f"predictions equal: {same}")
    if not same or feat.shape != (100, EXTRACT_WIDTH) or \
            np.abs(back - w - 0.5).max() > 1e-6:
        raise AssertionError("wrapper (a): predict / extract / weights")
    raw = net._trainer.predict_raw(api._as_batch(x, None))
    host = api.ServingHost()
    try:
        host.add_model("mnist", f"model_in = {model}\nbatch_size = 100\n"
                                "serve_shapes = 1,8,32\nsilent = 1\n"
                                "pool_layout = hwcn\n")
        rows = [None] * len(x)

        def client(j):
            for i in range(j, len(x), WRAPPER_CLIENTS):
                rows[i] = host.predict("mnist", x[i:i + 1])

        ths = [threading.Thread(target=client, args=(j,),
                                name=f"cxxnet-smoke-client-{j}")
               for j in range(WRAPPER_CLIENTS)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        got = np.concatenate(rows)
        retraces = host.retraces()
    finally:
        host.close()
    err = rel_err(torch.from_numpy(got), torch.from_numpy(raw))
    agree = float((got.argmax(1) == pred).mean())
    log(f"wrapper (b): ServingHost {len(x)} rows from {WRAPPER_CLIENTS} "
        f"threads: max err {err:.2e} against the raw forward, argmax "
        f"agreement {agree:.4f}, retraces {retraces}")
    if err > F32_TOL or agree < BATCH_AGREE or retraces:
        raise AssertionError("wrapper (b): serving rows differ")
    t0 = time.perf_counter()
    built = build.build()
    log(f"wrapper (c): C ABI built in {time.perf_counter() - t0:.1f} s: "
        f"{os.path.basename(built['lib'])}")
    lib = capi_lib(str(built["lib"]))
    h = lib.CXNNetCreate(b"gpu", b"batch_size = 100\nsilent = 1\n")
    if not h or lib.CXNNetLoadModel(h, model.encode()) != 0:
        raise AssertionError(f"wrapper (c): {lib.CXNGetLastError()}")
    f32p = ctypes.POINTER(ctypes.c_float)
    dshape = (ctypes.c_uint64 * 4)(*x.shape)
    oshape, ondim = (ctypes.c_uint64 * 4)(), ctypes.c_int(0)
    p = lib.CXNNetPredictBatch(h, x.ctypes.data_as(f32p), dshape, 4, oshape,
                               ctypes.byref(ondim))
    cpred = np.ctypeslib.as_array(p, shape=(len(x),)).copy() if p else None
    y = np.asarray(it.get_label(), np.float32).copy()
    upd = lib.CXNNetUpdateBatch(h, x.ctypes.data_as(f32p), dshape, 4,
                                y.ctypes.data_as(f32p),
                                (ctypes.c_uint64 * 2)(*y.shape), 2)
    wp = lib.CXNNetGetWeight(h, b"fc2", b"wmat", oshape, ctypes.byref(ondim))
    wshape = tuple(oshape[:ondim.value])
    lib.CXNNetFree(h)
    log(f"wrapper (c): ctypes predict equal to the wrapper's: "
        f"{cpred is not None and bool((cpred == pred).all())}; update "
        f"{upd}; fc2 wmat {wshape}")
    if cpred is None or not (cpred == pred).all() or upd != 0 \
            or wshape != (10, 100):
        raise AssertionError(f"wrapper (c): {lib.CXNGetLastError()}")
    t0 = time.perf_counter()
    r = subprocess.run([str(built["demo"]), "gpu",
                        os.path.join(tmp, "capi_demo.model")],
                       capture_output=True, text=True, cwd=tmp,
                       env=build.embed_env(), timeout=600)
    log(f"wrapper (c): C demo rc {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: "
        + (r.stdout.strip().splitlines() or [""])[-1])
    if r.returncode != 0 or "capi_demo: gpu accuracy" not in r.stdout:
        raise AssertionError(f"wrapper (c): C demo failed: "
                             f"{r.stderr[-2000:]}")
    del net, net2
    torch.cuda.empty_cache()
    return launches


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    return total


def report_profile(events, step_ms) -> None:
    """Where the device time of a traced train run goes, per step, over
    the steps after the first (warm-up) one.  ``events``: the profiler's
    events; ``step_ms``: each step's wall time, which ends in a device
    synchronise.  On the device timeline the profiler records the spans
    of the trainer's ``train_forward`` / ``train_update`` ranges: the
    window runs from the second step's forward to the last update, and
    the backward, which autograd runs from its own thread, is the window
    less those spans.  A range may show on the device more than once a
    step (once per stream its kernels ran on), so each range's time and
    the busy time are the union of their intervals; busy covers the
    kernels and copies in the window.  Lists the kernels with the most
    time (summed per kernel)."""
    from torch.autograd import DeviceType
    dev = [e for e in events if e.device_type != DeviceType.CPU]
    starts = sorted(e.time_range.start for e in dev
                    if e.name == "train_forward")
    ends = [e.time_range.end for e in dev if e.name == "train_update"]
    n = len(step_ms) - 1
    log(f"profile: {len(starts)} forward and {len(ends)} update spans on "
        f"the device for {n + 1} steps")
    if not ends or starts[-1] < min(ends):
        raise AssertionError("profile: no step after the first on the "
                             "device timeline")
    t0 = min(t for t in starts if t > min(ends))
    t1 = max(ends)
    spans, kernels, busy_iv = {}, {}, []
    for e in dev:
        if e.time_range.start < t0 or e.time_range.end > t1:
            continue
        iv = (e.time_range.start, e.time_range.end)
        if e.name.startswith("train_"):
            spans.setdefault(e.name, []).append(iv)
        else:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
            busy_iv.append(iv)
    busy = union_us(busy_iv)
    spans = {name: union_us(ivs) for name, ivs in spans.items()}
    per = lambda us: us / 1e3 / n
    span = per(t1 - t0)
    fwd = per(spans.get("train_forward", 0.0))
    upd = per(spans.get("train_update", 0.0))
    log(f"profile over steps 2-{n + 1}: wall {np.mean(step_ms[1:]):.1f} ms "
        f"a step, device window {span:.1f} ms, kernels busy {per(busy):.1f}"
        f" ms = {per(busy) / span:.3f} of the window; forward {fwd:.1f} ms,"
        f" backward {span - fwd - upd:.1f} ms, update {upd:.1f} ms")
    for name, (us, count) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:PROFILE_TOP]:
        log(f"  {per(us):9.2f} ms/step {us / busy:6.1%} "
            f"{count / n:7.1f} calls/step  {name[:100]}")


def run_paths(phases: set, args, tmp: str, checker, paths: dict,
              numbers: dict) -> None:
    """The phases after the kernels', in order, each path's launches into
    ``paths``; ``checker`` the check child (:func:`start_check`)."""
    serve_conf = None
    if "serve" in phases:
        task, paths["serve"], serve_conf = phase_serve(tmp)
        if "consistency" in phases:
            phase_consistency(task)
        if "serve_spec" in phases:
            paths["serve_spec"] = phase_serve_spec(tmp, task, serve_conf)
        del task
    elif "serve_spec" in phases:
        raise SystemExit("serve_spec needs the serve phase")
    train_losses = None
    for name, packed in (("train", True), ("train_unpacked", False)):
        if name in phases:
            paths[name], losses = phase_train(tmp, packed,
                                              args.profile and packed)
            if packed:
                train_losses = losses
    if "train_fused" in phases:
        if train_losses is None:
            raise SystemExit("train_fused needs the train phase")
        paths["train_fused"], _ = phase_train(
            tmp, True, args.profile, fused_vs=train_losses)
    if "train_hd256" in phases:
        paths["train_hd256"], _ = phase_train(tmp, True, wide=True)
    if "resume" in phases:
        paths["resume"] = phase_resume(tmp)
    if "alexnet" in phases:
        paths["alexnet"] = phase_alexnet(tmp, args.profile)
    if "alexnet_data" in phases:
        paths["alexnet_data"] = phase_alexnet_data(tmp)
    if "alexnet_hwcn" in phases:
        paths["alexnet_hwcn"] = phase_alexnet(tmp, args.profile,
                                              hwcn=True)
    if "googlenet" in phases:
        paths["googlenet"] = phase_googlenet(tmp, profile=args.profile)
    if "googlenet_hwcn" in phases:
        paths["googlenet_hwcn"] = phase_googlenet(tmp, hwcn=True,
                                                  profile=args.profile)
    if "resnet" in phases:
        paths["resnet"] = phase_resnet(tmp, args.profile)
    if "mnist_conv" in phases:
        paths["mnist_conv"], test_error = phase_mnist_conv(tmp)
        if "cnn_infer" in phases:
            paths["cnn_infer"] = phase_cnn_infer(tmp, test_error)
        if "serve_batch" in phases:
            paths["serve_batch"] = phase_serve_batch(tmp, test_error)
    elif "serve_batch" in phases:
        raise SystemExit("serve_batch needs the mnist_conv phase")
    if "staging" in phases:
        phase_staging(tmp)
    if "observe" in phases:
        if serve_conf is None or "mnist_conv" not in phases:
            raise SystemExit("observe needs the serve and mnist_conv "
                             "phases")
        paths["observe"] = phase_observe(tmp, serve_conf)
    if "serve_admin" in phases:
        if serve_conf is None or "serve_batch" not in phases:
            raise SystemExit("serve_admin needs the serve and "
                             "serve_batch phases")
        paths["serve_admin"] = phase_serve_admin(tmp, serve_conf)
    if "check" in phases:
        paths["check"] = phase_check(checker, tmp)
    if "pairtest" in phases:
        paths["pairtest"] = phase_pairtest(tmp)
    if "wrapper" in phases:
        paths["wrapper"] = phase_wrapper(tmp)
    if "dp" in phases:
        paths["dp"] = phase_dp(tmp)
        numbers.setdefault("fused_adam", {})["dp_shards"] = \
            MEASURED["dp_shards"]
    if "seq_expert" in phases:
        paths["seq_expert"] = phase_seq_expert(tmp)
    if "pipe" in phases:
        paths["pipe"] = phase_pipe(tmp)
    if "infer_mesh" in phases:
        if not {"mnist_conv", "alexnet_data"} <= phases:
            raise SystemExit("infer_mesh needs the mnist_conv and "
                             "alexnet_data phases")
        paths["infer_mesh"] = phase_infer_mesh(tmp)


def main() -> int:
    global TRAIN_STEPS
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(sorted(ALL_PHASES)),
                    help="comma-separated subset of the phases")
    ap.add_argument("--profile", action="store_true",
                    help="trace the packed train, train_fused, alexnet, "
                         "alexnet_hwcn, googlenet, googlenet_hwcn and "
                         "resnet phases with torch.profiler and print "
                         "where the time goes")
    ap.add_argument("--prefetch-device", type=int, default=None,
                    help="prefetch_device of the train, mnist_conv, "
                         "cnn_infer and alexnet_data CLI runs (default: "
                         "each conf's own; to compare staging modes)")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                    help="steps of the packed train and train_fused "
                         "phases (30 for a step p50 to compare trees by)")
    ap.add_argument("--check-child", metavar="TMP", help=argparse.SUPPRESS)
    args = ap.parse_args()
    TRAIN_STEPS = args.train_steps
    if args.prefetch_device is not None:
        PREFETCH_ARGS.append(f"prefetch_device={args.prefetch_device}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.check_child:
        return check_child(args.check_child)
    phases = set(args.phases.split(","))
    unknown = phases - ALL_PHASES
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    torch.cuda.set_device(0)
    phase_env()
    numbers = {}
    if "kernels" in phases:
        numbers.update(phase_kernels())
        numbers.update(phase_train_kernels())
        numbers.update(phase_cnn_kernels())
        numbers.update(phase_last_kernels())
        phase_route_kernels()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="cxn_smoke_") as tmp:
        checker = start_check(tmp) if "check" in phases else None
        try:
            run_paths(phases, args, tmp, checker, paths, numbers)
        finally:
            if checker is not None and checker.poll() is None:
                checker.kill()
                checker.wait()
    launches = {n: sum(p[n] for p in paths.values()) for n in KERNELS}
    kernels = [dict(name=n, route="cuda",
                    source=f"cxxnet_tpu_torch/ops/csrc/{src}",
                    replaces=f"cxxnet_tpu/ops/pallas_kernels.py:{line}",
                    launches=launches[n],
                    launches_by_path={p: c[n] for p, c in paths.items()},
                    **numbers.get(n, {}))
               for n, (_, _, src, line) in KERNELS.items()]
    log("phase wall seconds: " + ", ".join(
        f"{n[len('phase_'):]} {s:.1f}" for n, s in PHASE_SEC.items()))
    if phases != ALL_PHASES:
        log(f"ran phases {sorted(phases)} only: no result")
        log(json.dumps({"kernels": kernels}))
        return 1
    idle = [n for n, c in launches.items() if c < 1]
    if idle:
        raise AssertionError(f"kernels never launched on a path: {idle}")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: wall seconds of each phase function, in the order they ran
PHASE_SEC: dict = {}
#: the script's start, for the phases' start times on stderr
T0 = time.perf_counter()


def _timed(fn):
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        print(f"chip_smoke: {fn.__name__[len('phase_'):]} starts at "
              f"{t0 - T0:.1f} s", file=sys.stderr, flush=True)
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_SEC[fn.__name__] = PHASE_SEC.get(fn.__name__, 0.0) \
                + time.perf_counter() - t0
    return run


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed(globals()[_name])


if __name__ == "__main__":
    sys.exit(main())
