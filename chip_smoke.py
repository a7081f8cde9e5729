#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tensorframes_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --profile  # also device time by kernel per path
                                     # (and per GraphDef leg)

Phases, each printing its own lines and then its command time (``phase:``):

1. env: torch/CUDA versions, the card, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: the CUDA kernels from ``tensorframes_tpu_torch/csrc`` (one nvcc
   per source, started together), with ptxas' register/spill report; every
   kernel's instantiations are asserted in the built code against
   ``built_instantiations``: the 16-bit TMA + wgmma kernels (bf16 and f16;
   the forward, dQ, dK/dV and the ring step at Dh 64, 128, 256 and 512)
   with ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in every
   instantiation's SASS (``cuobjdump``), no ignored ``setmaxnreg``, and the
   instantiations whose wgmma ptxas serialized (C7518) named, none allowed
   in dQ, dK/dV and the ring step; the f32 SIMT kernels of the forward,
   dQ, dK/dV and the ring step (Dh 64, 128, 256 and 512) with none of them
   and no ``HMMA``; no FMA kernel; 0 bytes of ptxas spills in all, and
   every instantiation's registers a thread printed;
3. kernels: each kernel (the flash forward, the backward's dQ and dK/dV,
   the ring step) against its plain PyTorch version on the card, at the
   main paths' shapes and the edge cases (ragged, cross, GQA, a length that
   wraps the kernels' stage rings many times, q/k/v as strided views, head
   dims 8, 12, 32 and 96 zero-padded by the wrappers, f16 at Dh 64 and
   128, Dh 160, 200 and 256 in bf16, f16 and f32 (the Dh-256 TMA forward,
   dQ and dK/dV also at the wide-head path's shape, at cross lengths both
   ways and on strided views), Dh 320 and 512 on the 512-wide build, and
   Dh 640, 1024 and 1536 split into chunks of 512 in bf16, f16 and f32,
   a Dh-512 length that wraps the wide forward's and backward's slots
   many times, f32 on strided views),
   with stated tolerances, each launch held to the instantiation the
   dispatch must pick (``route_of``); the ring step also keeps a dominant
   carry (m above every score of the chunk by > 30) to f32 rounding, in
   bf16, f16 and f32, at a padded Dh, at Dh 256, 512 and split, and folds
   a Dh-256 chunk at a cross offset over many tiles;
   gradients through the autograd Function on the card against the same
   Function on CPU copies; and an explicit ``ring_flash`` at a chunk the
   TPU cannot tile, which must launch the ring step on every hop;
4. timing: each kernel, its plain version and the one-call library
   equivalent at the main paths' shape, beside the least time the card
   could take (its bound) and the counted TFLOP/s; the ring step at both flagship hops (diagonal
   and off-diagonal), with SDPA's forward on the same chunk pair as the
   nearest yardstick (no library call folds a carry); every kernel also at
   Dh = 32 (padded), in f16, at Dh = 256 (also 4 heads over 2 kv heads) and
   in f32 at Dh 64, 128, 256 and 512, in bf16 at 512 and split at 640 and
   1024, beside SDPA at the same shapes and the backend SDPA picked (each
   kernel record's ``variants``); at the flagship and every variant the
   backward's pair (dQ then dK/dV, timed as one call) against SDPA's whole
   backward (a ``timing`` line with ``pair``);
5. slice (scoring): the flagship transformer (series widths, random seeded
   weights) scores a 64-row frame of 2048-token cells through
   ``map_blocks`` with ``attn_impl="flash"``; the kernels' launches are
   counted over that run alone; results are checked for shape and
   finiteness, against the same frame scored with ``attn_impl="full"``,
   and, on a small input, against the port's CPU path; then the wide-head
   path: the same widths at 4 heads over 2 kv heads (Dh 256) score 16 rows
   of 2048 tokens in 2 blocks and train one epoch of 4 steps at B=8
   (remat "none") through ``FrameLoader`` and ``fit``: launches by
   instantiation (the TMA forward, dQ and dK/dV), ms per
   block and step, tokens/s, counted TFLOP/s, peak memory, nll against
   ``"full"`` and a B=2 step against ``"full"``; then the forward legs,
   scored the same way: the same widths at 2 heads over 1 kv head (Dh 512,
   only ``flash_fwd_tma<bf16,512>``) and the flagship's widths in f32
   (only ``flash_fwd_simt<f32,64>``), nll against ``"full"``; the Dh-512
   leg also trains one epoch of 4 steps at B=8 (remat "none") as the
   wide-head path does, on ``flash_fwd_tma<bf16,512>``,
   ``flash_bwd_dq_tma<bf16,512>`` and ``flash_bwd_dkv_tma<bf16,512>``
   alone, with a B=2 step against ``"full"``, and (after the ring slices,
   so that its params stay out of their peak memory) the f32 leg trains
   the same way on ``flash_fwd_simt<f32,64>``, ``flash_bwd_dq_simt<f32,64>``
   and ``flash_bwd_dkv_simt<f32,64>`` alone, its B=2 step against
   ``"full"`` at f32 tolerances (loss 1e-4, gradient norm 1e-3 relative);
   then the
   small-head slice: a Dh = 32 model (d_model 128, 4 heads) scores a frame
   with ``attn_impl="flash"`` (forward launches ``n_layers x blocks``; nll
   against the CPU path, f32 at 1e-4 and bf16 at the slice's 3e-2);
   then the verbs at BASELINE configs 2, 3 and 5's sizes and the
   reference's k-means demo: ``reduce_blocks`` sum/min and ``reduce_rows``
   (tree) over 500,000 x 64 f32 in 4 blocks, ``reduce_rows`` sequential at
   4,096 rows, ``map_rows`` of a 784-256-128-10 MLP over 65,536 rows (also
   against ``block_scoring_program`` through ``map_blocks``), 20
   logistic-regression gradient steps over 500,000 x 64 (the loss must
   fall), 10 k-means steps over 100,000 x 100 with k = 10 by both
   strategies, and ``aggregate`` over keys of more than 8 group sizes (the
   combine tree); each against the port's CPU path and numpy at stated
   tolerances, each with its Mrows/s; then ``frame.cache()`` on that phase:
   the ``reduce_blocks`` sum and the k-means demo (preagg) over cached
   frames, bit-identical to the uncached runs with no host bytes staged
   while cached (``observability`` counter ``h2d_bytes_staged``), Mrows/s
   both ways;
   decode (bench config 8: vocab 8192, d_model 1024, 8 layers, 16 heads,
   d_ff 4096, bf16, seeded weights): (a) greedy ``generate`` of 256 tokens
   from 32-token prompts at B = 1 and 8 (one timed run after a warm-up;
   tokens/s, ms a token, peak memory), the B = 1 run against one full
   forward over its final sequence: the cached logits at every position in
   f32 (1e-4), the generated tokens' mean NLL in bf16 (3e-2, the slice's),
   and the tokens against that forward's argmax where the top-2 gap
   exceeds 6e-2; (b) B = 8 with
   1792-token prompts and 256 new (prefill ms, decode ms a token); (c) the
   same prompts through ``PagePool``, ``paged_prefill`` and
   ``paged_decode_step``, whose tokens must equal (b)'s bit for bit, and a
   pool under a small ``TFS_HBM_BUDGET`` that must raise
   ``PagesExhausted`` and be restored by ``free``; (d) (a) at B = 8 on
   ``quantize_params`` (bytes, tokens/s, prefill logits within 0.5 of
   bf16's); (e) ``speculative_generate`` in f32 at B = 1, gamma 4, 64
   tokens, with the target as its own draft (acceptance 1.0) and with its
   first 2 layers as the draft, both equal to greedy ``generate``; and a
   small f32 model's tokens on the card against the CPU; no flash kernel
   launches on this path (``--profile``: one decode step at B = 8 of (a)
   and (b) by kernel);
6. crossover: flash against full attention at the scoring slice's widths
   (ms per block of 16,384 tokens at L = 256 .. 4096, one B=2 train step
   at each L), and ``ring_flash`` against the xla ring at sp = 4 (L = 2048,
   8192); the table behind ``flash_min_len``;
   train: the flagship train step (bench config 6's widths and its own
   remat policy, "selective") runs one epoch of a 64-row frame of
   2049-token rows through a ``FrameLoader`` and ``train.fit``, after one
   warm-up step; the kernels' launches are counted over that run alone
   (the forward twice a step: the policy recomputes it); the losses must
   be finite and fall.  Then two steps each of "none", "full" and "dots"
   (first loss held to "none"'s), one step at B=2 against
   ``attn_impl="full"`` (loss and gradient norm), and a small f32 model
   trained three steps on the card and on the CPU; then a short
   ``train.frontier_sweep`` (6 points);
   graphdef: Inception-v3 at full width (8192 seeded 299 x 299 x 3 uint8
   rows, bf16 params) scored through ``map_blocks`` natively and through
   its exported and re-imported frozen GraphDef, VGG-16 (224 x 224)
   likewise, and config 3's MLP frozen into a GraphDef through
   ``map_rows``; each against its native model, the CPU path on a few rows
   (f32), with rows/s, ms per block and peak memory;
7. ring slice (scoring): the same widths score a 32-row frame of
   8192-token cells in 4 blocks through ``map_blocks`` under
   ``set_mesh(training_mesh(sp=4))`` with ``attn_impl="auto"``, which
   resolves to ``"ring_flash"``; the ring step must launch exactly
   ``n_layers x sp(sp+1)/2`` times per block; ``nll`` is checked against
   the same frame scored with no mesh (flash, sp = 1) and one block
   against the xla ring step;
8. ring slice (training): one epoch of a 16-row frame of 8193-token rows
   at B=2 through ``FrameLoader`` and ``fit`` under the sp = 4 mesh with
   ``attn_impl="ring_flash"``, after one warm-up step (launches, falling
   losses, ms/step, tokens/s, counted TFLOP/s, peak memory); one step
   against flash at sp = 1 (loss and gradient norm); a small f32 model
   trained three steps under the mesh on the card and on the CPU; then
   the wide ring path (``phase_ring_wide``): the same setup (L = 8192,
   sp = 4, ``attn_impl="ring_flash"``) scores 8 rows in 2 blocks of the
   wide-head model (Dh 256, 2:1 GQA: ``ring_step_tma<bf16,256>``), 4 rows
   in 1 block of the Dh-512 model (``ring_step_tma<bf16,512>``) and 2
   rows in 1 block of the flagship in f32 (``ring_step_simt<f32,64>``),
   each ring step launch counted by instantiation and ``nll`` held to
   ``"flash"`` at sp = 1, and trains the wide-head model 2 steps at B = 2
   after a warm-up step, its loss and gradient norm held to ``"flash"``
   at sp = 1;
   with ``--profile``, device time by kernel over one block and one train
   step of each slice (and one block of each forward leg, one step of the
   Dh-512 and f32 legs);
   the verbs phase of 5 also runs the block dispatch stack: configs 2, 3, 5
   with ``TFS_PREFETCH_BLOCKS`` 2 against 0 (bit-identical; host bytes a
   second, staging and wait seconds and the overlap ratio over every verb
   of the leg that staged), a ``map_blocks`` over config 2's frame under an
   injected transient fault (one retry) and an injected OOM (one split),
   each bit-identical to the clean run, and a deadline at 0.3 of a clean
   run that stops a ``map_blocks`` of 8 synced blocks with
   ``DeadlineExceeded``;
9. MoE (the README's sparse flagship: the widths above, 8 experts, top-2,
   capacity 1.25, bf16, seeded weights): (a) 64 rows of 2048 tokens scored
   in 8 blocks through ``map_blocks`` with flash, ``nll`` within 3e-2 of
   ``"full"``, with the share of (token, rank) dispatch decisions that
   differ between the two on one block, and the device ms of one MoE
   layer's parts at that block's shapes (weight casts, router, gate,
   dispatch product, expert GEMMs, combine product); (e)
   ``layer_routing_stats`` of that block at every layer; (f) 4 rows of
   8192 tokens in 2 blocks at ``"ring_flash"`` under the ring slice's sp = 4
   mesh (each 2048-token chunk its own routing group), only the ring step
   launched, ``nll`` within 3e-2 of ``"flash"`` under the same mesh (the
   same groups) with the dispatch decisions that differ; (b) 4 train steps
   at B=8 x 2048 at "selective" through ``FrameLoader`` and ``fit``
   (launches as ``route_of`` names them, finite and falling losses, aux);
   (c) greedy ``generate`` at B = 8 (32-token prompts, 64 new), contiguous
   and paged, equal bit for bit, no flash launch; (d) a small f32 MoE model
   card vs CPU at 1e-4 with drops present (and the dispatch decisions that
   differ), cached decode vs the full forward at ample capacity at 1e-4;
10. pipeline (after the cached verbs): the program analysis and the fast
   paths it gates, the device pool and verb chains: (a) the flagship
   scores 64 rows of 2048 tokens in 8 blocks as one chain,
   ``tft.pipeline(frame).map_blocks(score).reduce_blocks(mean_nll)``,
   bit-identical to the eager ``map_blocks`` then ``reduce_blocks``, with
   exactly 64 ``flash_fwd_tma<bf16,64>`` launches and the tokens' bytes
   staged once; (b) ``logistic_regression.fit_fused`` (500,000 x 64, 20
   steps) and ``kmeans.fit_fused`` (100,000 x 100, k = 10, 10 steps)
   against their eager ``fit`` (1e-4; ``KMEANS_TOL`` and equal
   assignments), one readback each; (c) the device segment aggregate over
   2,000,000 rows, 1,000 int keys and a 16-wide f32 value (sum, min, max,
   mean, sum of squares) and a two-key case with float keys holding -0.0
   and NaN, against the general path and numpy (keys, min and max
   exactly, the rest at ``SUM_RTOL``), bit-identical from run to run;
   (d) bucket padding: a ragged ``map_rows`` over 200,000 rows of lengths
   1..1024 and an uneven-block ``map_blocks``, padded against
   ``TFS_BLOCK_BUCKETS=off``, outputs identical, vmapped calls and
   Mrows/s; (e) the classification of every program the phase and the
   scoring slice run, the pool resolving no pool on one card, and
   ``cache(sharded=True)`` staging 0 host bytes under ``reduce_blocks``;
11. observability (after the pipeline phase): (a) the flagship scores the
   scoring cell (64 rows of 2048 tokens in 8 blocks, ``map_blocks``,
   flash) ``OBS_RUNS`` times each with spans and the flight recorder off
   and on, in turns; every run is bit-identical to the first, with 64
   ``flash_fwd_tma<bf16,64>`` launches; each "on" run runs under
   ``enable()``, ``enable_trace()`` and ``request_ledger(tenant="smoke")``,
   its ledger must equal ``counters_delta`` over it, the ``cuda:0`` track
   must hold its 8 block events (with the ledger's cid) and its span the
   ``map_blocks`` phases; ``metrics_text`` must carry the ``map_blocks``
   latency family and the tenant's; ms a block both ways; (b)
   ``dump_trace`` written and read back as JSON (8 events on the card's
   track, no drops), and one small ``map_blocks`` under
   ``enable(profile_dir)`` must write a Chrome trace; (c) the roofline of
   one scoring block on the card's peaks, with ``measured_s`` from (a)'s
   "off" median: one attention op a layer, each with exactly the flash
   forward's own count (``kernel_bound``); ``total_flops``,
   ``ceiling_mfu``, ``mfu``, ``ceiling_fraction``; (d) one ``generate`` at
   B = 8 (decode config 8's prompts) under a span: its phases, and its wall
   time to the readback; (e) ``doctor()`` over the process's state,
   rendered;
12. planner (after the observability phase): (a) the flagship scores 64
   rows of 2048 tokens in 8 blocks through a plan,
   ``frame.lazy()`` -> ``map_blocks(score)`` -> ``map_blocks(ppl =
   exp(nll))`` -> ``reduce_blocks(mean)``, bit-identical to the eager
   verbs, with 64 ``flash_fwd_tma<bf16,64>`` launches, the tokens' bytes
   staged once, one fused dispatch and one fused reduce, the decision
   ``serial``/``pool_unavailable``; ms a block of that first (cold) plan
   and of eager, then of warm plans and eager runs in turns; (b)
   ``explain`` of a chain launches nothing, ``explain(analyze=True)`` runs
   it (64 launches) and reports ``wall=``, ``h2d_bytes=`` and ``request:
   cid=``; (c) the identical chain built while (a)'s result is held is a
   sharing hit (0 launches, 0 bytes), and two chains off one root
   auto-cache its tokens on the card (``budget_bytes_resident`` up by
   their bytes, the second chain's decision ``affinity``), and after
   ``del`` and ``gc.collect()`` the budget and
   ``torch.cuda.memory_allocated()`` are back where they were; (d) config
   5's logistic regression (500,000 x 64 in 4 blocks) as ``PLAN_EPOCHS``
   gradient epochs through ``iterate_epochs`` against the same eager loop,
   weights bit-identical, epochs 2+ staging 0 host bytes; (e) the scoring
   program cut to ``COLD_START_LAYERS`` layers (the export's seconds grow
   with the depth) through ``serialize`` and ``deserialize_program`` run
   by ``map_blocks`` (8 launches, nll against the live program: equal,
   or within 1e-5), with the artifact's bytes and the export and load
   seconds; (f) two processes each warm the scoring program, cut to
   ``COLD_START_LAYERS`` layers at the same widths, on one block
   against one fresh ``TFS_COMPILE_CACHE``: the first builds
   ``flash_fwd`` (``backend_compiles`` >= 1), the second builds nothing
   and loads it (``persistent_cache_hits`` >= 1), with the same
   fingerprints; both wall times;
13. streaming (after the planner phase): the host-side data layers, on
   the planner phase's frame with a ``row`` id and 16 ``doc`` keys: (a)
   ``relational.shuffle(frame, "doc", partitions=4)``, then each
   partition's stream scored by streamed ``map_blocks`` into a
   ``CollectSink``: every row once, each window's ``nll`` bit-identical to
   eager ``map_blocks`` on that window, 8 ``flash_fwd_tma<bf16,64>``
   launches a block, ``peak_host_bytes`` within two windows plus the
   frame; ms a window, the spill bytes; (b) under ``TFS_PLAN=1`` the
   streamed chain ``map_blocks(score)`` -> ``map_blocks(ppl)``,
   bit-identical to the eager streamed chain, one fused dispatch a window;
   (c) a child process runs the journaled ``reduce_blocks`` (the mean of
   ``nll``) under ``proc_kill:window=2:phase=mid`` and dies by SIGKILL; a
   second child resumes it to the parent's uninterrupted bytes, with
   ``journal_resumes`` 1, ``journal_windows_skipped`` 2 and no ``nvcc`` in
   either; both wall times; (d) the scored windows joined with a 16-row
   ``doc -> weight`` table, broadcast and sort-merge, then a streamed
   ``aggregate`` of weight x nll by doc, each equal to ``join_frames`` +
   the eager ``aggregate`` byte for byte; the doctor's ``shuffles``
   section reads the live stats; (e) one 1,048,576 x 64 f32 block (256 MiB)
   through ``sigmoid((x * w).sum(-1))`` in 64 MiB chunks and whole: the results
   (bit-identical, else within 1e-6), the chunk count, ms both ways, the
   H2D bytes and the overlap ratio; (f) ``TensorFrame.from_rows`` over a
   million rows of 16-float lists through the native packer and the numpy
   path, identical arrays and schemas; both seconds and the ``g++`` build's;
14. bridge (after the streaming phase): serving over the bridge, every
   server on the card in a thread of this process bound to 127.0.0.1:0 and
   every client over the socket: (a) config 3's frame (65,536 x 784 f32,
   205.5 MB) up through ``create_frame``, the 784-256-128-10 MLP frozen
   into a GraphDef through ``map_rows`` and ``map_blocks``, the outputs and
   the frame down through ``collect``, each bit-identical to the same verb
   in process on the card (MB/s up and down, rows/s against in process);
   (b) 8 sessions each send a 4,096-row slice through ``map_rows`` at
   once to a server built with ``coalesce_us=2000``: at least one
   coalesced batch, each result against the same request served alone
   (bit-identical, else the differing elements printed and held to
   ``MLP_TOL``), the members' ledgers summing to the wave's counters
   delta; then ``warm`` of a new GraphDef, after which its first request
   makes no ``program_traces`` and no ``backend_compiles``; (c) decode
   config 8 (bf16) behind the ``decode`` RPC, ``max_slots`` 8: 16 client
   threads with seeded prompts of 32-1792 tokens and 32-256 new, every
   stream whole, one joining a running batch, ``decode_tokens`` the sum of
   the requests, no page left used; each stream equal to its solo
   ``generate`` at the scheduler's capacity up to that run's first top-2
   gap under ``DECODE_GAP``; a span past the free pages refused as
   ``ServerBusy`` (reason ``pages``, ``retry_after_ms`` > 0); the doctor's
   ``decode`` section reading the live scheduler; aggregate tokens/s and
   p50/p99 ms a stream; a small f32 model's scheduled streams on the card
   equal to the CPU's; (d) a ``map_blocks`` of 8 blocks, each paced by an
   injected 40 ms dispatch delay, under a deadline at 0.3 of a clean run
   raises ``DeadlineExceeded`` and the frame then gives the clean result;
   ``bridge_drop`` on the first ``map_rows`` is retried under its
   idempotency token (executed once, one cache hit, bit-identical); a
   drain with decode streams in flight completes them; (e) the
   ``pipeline`` RPC over a registered 1,048,576 x 16 frame (``map_blocks``,
   a sort-merge join, ``aggregate``, GraphDef stages, windows of 131,072
   rows) equal byte for byte to in-process ``run_stream_pipeline``, its
   window ledgers summing to the request's, ``metrics`` carrying the
   bridge's latency family; no flash kernel launches in the phase;
15. fleet (after the bridge phase): the bridge fleet on the card, every
   client a ``FleetClient``: (a) ``FLEET_SIZE`` (2) replica processes
   (``python -m tensorframes_tpu_torch.bridge.replica --device cuda``)
   sharing one journal, compile cache, fleet registry and pipeline root;
   8 clients with distinct keys each upload config 3's frame and run the
   MLP GraphDef through ``map_blocks`` and ``map_rows``, each output
   bit-identical to the verb in process, each key answered by the replica
   the router names; each replica's seconds from spawn to healthy, the
   sessions per replica and the doctor's ``fleet`` section; (b) the owner
   of a durable pipeline over a 1,048,576 x 16 parquet file (8 windows of
   131,072 rows: ``map_blocks``, ``aggregate``) SIGKILLed mid-job by the
   ``replica_kill`` fault under 4 threads of small ``map_blocks`` traffic:
   no failed request, the client failed over, the job resumed on a peer
   (``fleet_jobs_migrated`` 1, the peer skipping every journaled window and
   running the rest), byte-equal to in-process ``run_stream_pipeline``,
   ``job_status`` complete; the seconds from the kill to the resumed
   result; (c) the victim restarted, then a rolling restart of every
   replica under 2 traffic threads: no failed request, every restart counted,
   every replica healthy, each serving the pipeline with no
   ``backend_compiles`` and no ``persistent_cache_misses``; each replica's
   SIGTERM-to-healthy seconds; (d) decode config 8 (bf16) behind a
   two-replica thread fleet: 8 streams of 32-token prompts and 64 new
   tokens, one replica drained mid-run, sessions opened after the drain on
   the survivor, every stream whole and equal to its solo ``generate`` up
   to the first top-2 gap under ``DECODE_GAP``; tokens/s and p50/p99
   seconds a stream; no flash kernel launches in the phase;
16. mesh (after the streaming phase): the mesh executor and the
   multi-process runtime on the card: (a) the flagship's 64 rows of 2048
   tokens scored by ``map_blocks(prog, frame,
   engine=MeshExecutor(data_mesh()))`` in ``"global"`` and ``"per_block"``
   mode, each bit-identical to the serial executor over the rows as one
   block, with its ``flash_fwd_tma<bf16,64>`` launches and ms against the
   serial run; (a2) ``per_block`` over a mesh of ``MESH_POSITIONS``
   positions held on the one card (the shard and gather code on the card)
   against the slice's blocks, nll within 3e-2 and its bit-identity
   printed; (b) ``reduce_blocks``, ``reduce_rows`` (tree; sequential over
   4,096 rows), ``map_rows`` and the segment ``aggregate`` over config 2's
   and config 5's frames and the k-means frame (keyed by cluster) in both
   modes, each bit-identical to the serial verb over one block, Mrows/s
   both ways; (b2) the split paths over the positions against the serial
   executor over as many equal blocks (keys and integers exact, floats at
   ``SUM_RTOL``); (c) ``logistic_regression.fit_fused`` and
   ``kmeans.fit_fused`` through ``pipeline(engine=MeshExecutor(...))``
   against the eager fits over the same engine (1e-5 and 1e-6, the CPU
   twins'; equal assignments), and a ``per_block`` engine refused; (d)
   ``multihost.initialize`` with NCCL at world size 1 in this process, then
   two child processes sharing the card: over NCCL (what it prints is
   recorded) and over gloo, whose ``frame_from_process_local`` halves of
   config 2's rows run a cross-process ``reduce_blocks`` held to the serial
   executor over the same two blocks; the seconds to form each group and
   of the reduce, and the collectives whose CUDA partials crossed through
   the host (gloo takes no CUDA tensor);
17. train_axes (after the train phase): the training axes on the card,
   every mesh position held on the one card as a rank of its axis: (a)
   GPipe over ``training_mesh(pp=2)`` at 4 microbatches and ``pp=4`` at 8,
   the flagship train config at B = 8 x 2048, loss and gradient norm held
   to the single-stage ``loss_fn``'s, ms a train step and flash launches
   by kernel a step; (b) 1F1B on the same meshes, the same checks, then
   peak device memory of loss and gradients at one row a microbatch, 2
   against 8 microbatches, both schedules (GPipe's grows with M, 1F1B's
   less); (c) ``pp=2 x sp=2`` with ``ring_flash`` (the ring slice's widths,
   L = 4096, B = 2, 2 microbatches) against the single-stage ring at
   ``sp=2``, with its ``ring_step_tma`` launches; (d) the MoE flagship at
   ``pp=2`` (2 microbatches) against the unpipelined loss, and
   ``training_mesh(ep=2)`` against ``ep=1`` (bit-identity printed); (e)
   ``train.fit`` fed by ``FrameLoader(mesh=training_mesh(pp=2), spec=("dp",
   None))`` for 4 steps, the losses falling; (f) two processes sharing the
   card under ``gloo`` (``train_axes_child``), a 2-layer cut of the
   flagship, ``dp=2``: each rank trains on its half of every batch (a
   mesh-sharded ``FrameLoader``), two steps, each loss held to the
   one-process step's; (g) ``pp`` and ``tp`` across ``gloo`` processes
   sharing the card (``rank_axes_child``), each rank holding only its
   shard of the train phase's weights: (g1) ``pp=2`` GPipe and (g2) 1F1B
   at 4 microbatches and (g3) ``tp=2`` over two ranks, the flagship train
   config at B = 8 x 2048, (g4) ``pp=2 x tp=2`` over four at a 2-layer cut
   and B = 2; each a warm-up step and two timed steps, the loss and global
   gradient norm held to the one-process step's (``AXES_RANK_TOL``), every
   flash launch the instantiation ``route_of`` names, each rank's param
   and Adam bytes exactly its shard's; ms a step, the enqueue share, bytes
   a rank by kind, host detours and peak device memory a rank against one
   process;
18. the card's line again, the kernels' JSON record (each kernel at the
   flagship shape with its built instantiations, then every instantiation
   timed at a variant shape, with its launches over the main paths' runs),
   then the last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA card the script
exits 1 before printing any result.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

# the port itself: without it (the script alone) this fails before any
# output.  Its roofline holds the card's published peaks (H100 SXM data
# sheet, dense) and the kernels' counts that the bounds use
from tensorframes_tpu_torch import roofline  # noqa: E402

PEAK_16BIT_FLOPS = roofline.PEAK_FLOPS[roofline.H100]  # bf16 and f16 alike
PEAK_F32_FLOPS = 67e12  # the FMA pipe, outside the tensor cores
PEAK_BYTES = roofline.PEAK_BYTES_PER_S[roofline.H100]

FLAGSHIP = dict(B=8, Lq=2048, Lk=2048, H=16, KVH=16, D=64, dtype=torch.bfloat16, causal=True)
# the small-head slice: a JAX test width (d_model 128, 4 heads: Dh = 32),
# which the kernels run zero-padded to 64
SMALL_HEAD = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
                  d_ff=512, max_seq=512, attn_impl="flash")
SMALL_HEAD_ROWS, SMALL_HEAD_L, SMALL_HEAD_BLOCKS = 16, 512, 4
SMALL_HEAD_TOL = 1e-4  # f32, card vs CPU: summation order
# the attention that slice launches: one block's rows at the model's heads
SMALL_HEAD_ATTN = dict(B=SMALL_HEAD_ROWS // SMALL_HEAD_BLOCKS, Lq=SMALL_HEAD_L,
                       Lk=SMALL_HEAD_L, H=SMALL_HEAD["n_heads"],
                       KVH=SMALL_HEAD["n_kv_heads"],
                       D=SMALL_HEAD["d_model"] // SMALL_HEAD["n_heads"], causal=True)
# (name, shape, tolerance): bf16 outputs round to bf16 (~2^-8 relative) and
# p is rounded to bf16 before PV in both versions, so a 1-ulp difference in
# p or out is expected; f32 differs only by summation order and expf
KERNEL_CASES = [
    ("flagship", FLAGSHIP),
    ("dh128", dict(B=2, Lq=2048, Lk=2048, H=8, KVH=8, D=128, dtype=torch.bfloat16, causal=True)),
    ("ragged130", dict(B=2, Lq=130, Lk=130, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=True)),
    ("ragged257", dict(B=2, Lq=257, Lk=257, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=False)),
    ("cross24x40", dict(B=2, Lq=24, Lk=40, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=False)),
    ("gqa16x4", dict(B=2, Lq=2048, Lk=2048, H=16, KVH=4, D=64, dtype=torch.bfloat16, causal=True)),
    ("f32", dict(B=2, Lq=257, Lk=257, H=4, KVH=2, D=128, dtype=torch.float32, causal=True)),
    # GQA, ragged and causal over many TMA boxes: the forward's 4-slot ring
    # wraps twice per CTA, dK/dV's 4-slot ring 16 times (4 heads x 16 tiles)
    ("gqa_ragged1000", dict(B=2, Lq=1000, Lk=1000, H=8, KVH=2, D=64, dtype=torch.bfloat16, causal=True)),
    # q, k, v as views into one fused [B, L, H + 2 KVH, D] projection: the
    # descriptors' strides are not a contiguous tensor's
    ("strided_fused", dict(B=2, Lq=300, Lk=300, H=8, KVH=2, D=64, dtype=torch.bfloat16,
                           causal=True, layout="fused")),
    # head dims other than 64 and 128 (JAX configs' and tests' widths), zero-
    # padded to the kernels' 64 or 128 by the wrappers
    ("dh8", dict(B=2, Lq=300, Lk=300, H=4, KVH=2, D=8, dtype=torch.bfloat16, causal=True)),
    ("dh12", dict(B=2, Lq=257, Lk=257, H=4, KVH=4, D=12, dtype=torch.bfloat16, causal=False)),
    ("dh32", dict(B=4, Lq=1024, Lk=1024, H=4, KVH=4, D=32, dtype=torch.bfloat16, causal=True)),
    ("dh96", dict(B=2, Lq=1000, Lk=1000, H=8, KVH=2, D=96, dtype=torch.bfloat16, causal=True)),
    # the small-head slice's own shape, in both of its dtypes
    ("small_head", dict(SMALL_HEAD_ATTN, dtype=torch.bfloat16)),
    ("small_head_f32", dict(SMALL_HEAD_ATTN, dtype=torch.float32)),
    # f16: the same kernels instantiated for __half
    ("f16_dh64", dict(B=2, Lq=2048, Lk=2048, H=16, KVH=4, D=64, dtype=torch.float16, causal=True)),
    ("f16_dh128", dict(B=2, Lq=1000, Lk=1000, H=8, KVH=8, D=128, dtype=torch.float16, causal=True)),
    ("f16_dh12_cross", dict(B=2, Lq=24, Lk=40, H=4, KVH=2, D=12, dtype=torch.float16, causal=False)),
    # Dh 256: the TMA forward, dQ and dK/dV in bf16 and
    # f16, Dh 160 padded to 256, causal and not, GQA, ragged, cross lengths
    # both ways, strided views, and the wide-head slice's own shape (the
    # flagship's B and L at 4 heads over 2 kv heads); f32 on the SIMT forward
    # and the FMA backward
    ("bf16_dh160", dict(B=2, Lq=700, Lk=700, H=8, KVH=2, D=160, dtype=torch.bfloat16, causal=True)),
    ("bf16_dh256", dict(B=2, Lq=1000, Lk=1000, H=8, KVH=4, D=256, dtype=torch.bfloat16, causal=False)),
    ("f16_dh160_cross", dict(B=2, Lq=300, Lk=500, H=4, KVH=2, D=160, dtype=torch.float16, causal=False)),
    ("f16_dh256", dict(B=2, Lq=1000, Lk=1000, H=8, KVH=2, D=256, dtype=torch.float16, causal=True)),
    ("f32_dh160", dict(B=2, Lq=300, Lk=300, H=4, KVH=2, D=160, dtype=torch.float32, causal=True)),
    ("f32_dh256", dict(B=2, Lq=257, Lk=257, H=4, KVH=2, D=256, dtype=torch.float32, causal=False)),
    ("bf16_dh256_wide_head", dict(B=8, Lq=2048, Lk=2048, H=4, KVH=2, D=256, dtype=torch.bfloat16,
                                  causal=True)),
    ("bf16_dh256_cross_causal", dict(B=2, Lq=300, Lk=700, H=4, KVH=2, D=256, dtype=torch.bfloat16,
                                     causal=True)),
    ("f16_dh256_cross", dict(B=2, Lq=700, Lk=130, H=4, KVH=1, D=256, dtype=torch.float16,
                             causal=False)),
    ("bf16_dh256_strided_fused", dict(B=2, Lq=300, Lk=300, H=4, KVH=2, D=256, dtype=torch.bfloat16,
                                      causal=True, layout="fused")),
    ("f16_dh200_ragged130", dict(B=2, Lq=130, Lk=130, H=4, KVH=4, D=200, dtype=torch.float16,
                                 causal=True)),
    # head dims 257..512: the forward's 512-wide TMA and SIMT builds, the
    # backward's 512-wide TMA builds (16-bit) and FMA builds (f32), Dh 320
    # padded
    ("bf16_dh320", dict(B=2, Lq=300, Lk=300, H=4, KVH=2, D=320, dtype=torch.bfloat16, causal=True)),
    ("f16_dh320_cross", dict(B=2, Lq=200, Lk=260, H=4, KVH=2, D=320, dtype=torch.float16,
                             causal=False)),
    ("f32_dh320", dict(B=2, Lq=257, Lk=257, H=4, KVH=2, D=320, dtype=torch.float32, causal=True)),
    ("bf16_dh512", dict(B=2, Lq=200, Lk=200, H=2, KVH=1, D=512, dtype=torch.bfloat16, causal=True)),
    # head dims above 512: the 512-wide builds split into chunks of 512
    # columns (640 padded to 1024: two; 1024 itself), each dtype, causal and
    # not, GQA, ragged and cross lengths
    ("bf16_dh640", dict(B=2, Lq=300, Lk=300, H=4, KVH=2, D=640, dtype=torch.bfloat16, causal=True)),
    ("f16_dh640_cross", dict(B=2, Lq=200, Lk=260, H=4, KVH=2, D=640, dtype=torch.float16,
                             causal=False)),
    ("f32_dh640", dict(B=2, Lq=257, Lk=257, H=4, KVH=2, D=640, dtype=torch.float32, causal=False)),
    ("bf16_dh1024", dict(B=1, Lq=257, Lk=257, H=2, KVH=1, D=1024, dtype=torch.bfloat16,
                         causal=False)),
    ("f16_dh1024", dict(B=1, Lq=130, Lk=130, H=2, KVH=2, D=1024, dtype=torch.float16, causal=True)),
    ("f32_dh1024_cross", dict(B=1, Lq=200, Lk=140, H=2, KVH=1, D=1024, dtype=torch.float32,
                              causal=True)),
    # the 16-bit forward's and backward's wide TMA bodies at Dh 512 and
    # above: three chunks of 512 (six 256-column output chunks, Q streamed),
    # ragged and GQA; causal cross lengths both ways (key tiles past every
    # query: dK/dV of no pair; a split dQ over fewer keys than queries); a
    # length whose key tiles wrap the forward's two half slots 32 times a
    # CTA, and that streams up to 128 (dQ) and 384 (dK/dV) items a CTA
    # through the backward's two slots, causal, 2:1 GQA
    ("bf16_dh1536", dict(B=1, Lq=300, Lk=300, H=4, KVH=2, D=1536, dtype=torch.bfloat16,
                         causal=True)),
    ("f16_dh1024_cross_causal", dict(B=1, Lq=300, Lk=140, H=2, KVH=1, D=1024,
                                     dtype=torch.float16, causal=True)),
    ("bf16_dh512_cross_causal", dict(B=2, Lq=200, Lk=330, H=2, KVH=2, D=512,
                                     dtype=torch.bfloat16, causal=True)),
    ("bf16_dh512_long", dict(B=1, Lq=2048, Lk=2048, H=2, KVH=1, D=512, dtype=torch.bfloat16,
                             causal=True)),
    # the f32 SIMT forward on strided views of one fused projection, and at
    # Dh 64 with a causal cross length (the top-left mask)
    ("f32_dh128_strided_fused", dict(B=2, Lq=300, Lk=300, H=8, KVH=2, D=128,
                                     dtype=torch.float32, causal=True, layout="fused")),
    ("f32_dh64_cross_causal", dict(B=2, Lq=130, Lk=300, H=4, KVH=2, D=64, dtype=torch.float32,
                                   causal=True)),
    # the f32 SIMT backward: a 4:1 GQA group over a flagship length (dK/dV
    # steps 4 heads x 32 query tiles a CTA), key tiles past every query row
    # (causal cross: dK/dV of no step, zeros), and the unsplit Dh-512 build
    # under GQA, ragged and causal
    ("f32_dh64_gqa_long", dict(B=2, Lq=2048, Lk=2048, H=16, KVH=4, D=64, dtype=torch.float32,
                               causal=True)),
    ("f32_dh128_cross_causal", dict(B=2, Lq=200, Lk=330, H=4, KVH=2, D=128,
                                    dtype=torch.float32, causal=True)),
    ("f32_dh512_gqa_ragged", dict(B=2, Lq=300, Lk=300, H=4, KVH=2, D=512, dtype=torch.float32,
                                  causal=True)),
]
# f16 rounds finer than bf16 (2^-11 against 2^-8), so it has limits of its
# own, between what the sound kernels need on an H100 (least_tol: out
# <= 4.8e-4, dQ/dK/dV <= 6.5e-4, ring o/l <= 1.5e-4) and what the same
# kernels need with P and dS rounded through bf16 before f16 (out >= 1.7e-3,
# gradients >= 1.6e-3, ring o/l >= 4.2e-4): the fault an f16 instantiation
# is likeliest to bring
TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-3, torch.float32: 2e-5}  # atol = rtol
LSE_TOL = {torch.bfloat16: 1e-4, torch.float16: 1e-4, torch.float32: 2e-5}
# backward kernels against flash_attention_bwd_plain on the same out/lse:
# both cast P and dS to bf16 at the same points, so a 1-ulp flip of a cast
# and the bf16 rounding of the result (~2^-8 relative) are expected; f32
# differs by summation order and exp, at the JAX suite's own gradient
# tolerance (tests/test_flash.py)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-3, torch.float32: 2e-4}
NLL_TOL = 3e-2  # flash vs full, bf16 model, on a mean NLL of ~9

# the ring step at the ring slice's chunk (L=8192 over sp=4): rank 2's own
# chunk (hop 0, the diagonal) and rank 3 folding chunk 1 (hop 2, every pair
# visible), each with a non-empty random carry.  (name, shape, q_off, k_off,
# carry): "random" o/m/l, "empty" (m = -inf, l = 0, o = 0), "dead" (random,
# with every third row's m at -inf), "dominant" (random o and l, m above
# every scaled score of the chunk by more than 30: alpha = 1 and every
# p < e^-30, so the new o must be the carried o to f32 rounding, compared
# raw at DOMINANT_O_TOL).  "masked_rows" and "dead_f32" hide the chunk from
# their first 100 rows, which must carry m = -inf, l = 0, o = 0.
RING_FLAGSHIP = dict(B=8, C=2048, H=16, KVH=16, D=64, dtype=torch.bfloat16, causal=True)
RING_CASES = [
    ("flagship_diag", RING_FLAGSHIP, 4096, 4096, "random"),
    ("flagship_offdiag", RING_FLAGSHIP, 6144, 2048, "random"),
    ("dh128", dict(B=2, C=2048, H=8, KVH=8, D=128, dtype=torch.bfloat16, causal=True), 2048, 2048, "random"),
    ("ragged130", dict(B=2, C=130, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=True), 130, 130, "random"),
    ("ragged257_cross", dict(B=2, C=257, H=4, KVH=2, D=64, dtype=torch.bfloat16, causal=True),
     300, 0, "random"),
    ("tiny5", dict(B=2, C=5, H=4, KVH=2, D=64, dtype=torch.bfloat16, causal=True), 5, 5, "random"),
    ("gqa16x4", dict(B=2, C=2048, H=16, KVH=4, D=64, dtype=torch.bfloat16, causal=True), 2048, 2048, "random"),
    ("f32", dict(B=2, C=257, H=4, KVH=2, D=128, dtype=torch.float32, causal=True), 257, 257, "random"),
    ("noncausal", dict(B=2, C=512, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=False), 0, 512, "random"),
    ("empty_carry", dict(B=2, C=256, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=True), 256, 256, "empty"),
    ("masked_rows", dict(B=2, C=256, H=4, KVH=2, D=64, dtype=torch.bfloat16, causal=True), 156, 256, "random"),
    ("dead_f32", dict(B=2, C=200, H=4, KVH=4, D=64, dtype=torch.float32, causal=True), 100, 200, "dead"),
    ("f32_diag", dict(B=2, C=2048, H=4, KVH=4, D=64, dtype=torch.float32, causal=True), 4096, 4096, "random"),
    ("f32_offdiag", dict(B=2, C=2048, H=4, KVH=2, D=64, dtype=torch.float32, causal=True), 6144, 2048, "random"),
    # q, k, v as views into one fused [B, C, H + 2 KVH, D] projection
    ("strided_fused", dict(B=2, C=300, H=8, KVH=2, D=64, dtype=torch.bfloat16, causal=True,
                           layout="fused"), 300, 300, "random"),
    # GQA, ragged and causal over many TMA boxes: the 4-slot ring of K/V
    # tiles wraps twice per CTA; on the diagonal and at a cross offset
    ("gqa_ragged1000", dict(B=2, C=1000, H=8, KVH=2, D=64, dtype=torch.bfloat16, causal=True),
     1000, 1000, "random"),
    ("gqa_ragged1000_cross", dict(B=2, C=1000, H=8, KVH=2, D=64, dtype=torch.bfloat16,
                                  causal=True), 1037, 0, "random"),
    # the carry precision: a carry rounded through bf16 (~2e-3) fails here;
    # at Dh = 64 (three consumers, early tile release) and Dh = 128 (two)
    ("dominant_carry", dict(B=2, C=1000, H=8, KVH=2, D=64, dtype=torch.bfloat16, causal=True),
     1000, 1000, "dominant"),
    ("dominant_carry_dh128", dict(B=2, C=1000, H=8, KVH=2, D=128, dtype=torch.bfloat16,
                                  causal=True), 1000, 1000, "dominant"),
    # padded head dims (the carry's o padded with them) and f16
    ("dh8", dict(B=2, C=300, H=4, KVH=2, D=8, dtype=torch.bfloat16, causal=True), 300, 0, "random"),
    ("dh12", dict(B=2, C=257, H=4, KVH=4, D=12, dtype=torch.bfloat16, causal=True), 257, 257, "random"),
    ("dh32", dict(B=4, C=1024, H=4, KVH=4, D=32, dtype=torch.bfloat16, causal=True), 2048, 1024, "random"),
    ("dh96", dict(B=2, C=1000, H=8, KVH=2, D=96, dtype=torch.bfloat16, causal=True), 1000, 1000, "random"),
    ("f16_dh64", dict(B=2, C=2048, H=16, KVH=4, D=64, dtype=torch.float16, causal=True), 2048, 2048, "random"),
    ("f16_dh128", dict(B=2, C=1000, H=8, KVH=8, D=128, dtype=torch.float16, causal=True), 1037, 0, "random"),
    ("dominant_carry_f16", dict(B=2, C=1000, H=8, KVH=2, D=64, dtype=torch.float16,
                                causal=True), 1000, 1000, "dominant"),
    ("dominant_carry_dh32", dict(B=2, C=1000, H=8, KVH=2, D=32, dtype=torch.bfloat16,
                                 causal=True), 1000, 1000, "dominant"),
    # the wide build: Dh 160 (padded, o with it) and 256, each dtype, causal
    # and not, GQA, and the dominant carry at 256
    ("bf16_dh160", dict(B=2, C=700, H=8, KVH=2, D=160, dtype=torch.bfloat16, causal=False),
     0, 700, "random"),
    ("bf16_dh256", dict(B=2, C=1000, H=8, KVH=2, D=256, dtype=torch.bfloat16, causal=True),
     1000, 1000, "random"),
    ("f16_dh160_cross", dict(B=2, C=500, H=4, KVH=2, D=160, dtype=torch.float16, causal=True),
     1037, 0, "random"),
    ("f16_dh256", dict(B=2, C=1000, H=8, KVH=4, D=256, dtype=torch.float16, causal=True),
     1000, 1000, "random"),
    ("f32_dh160", dict(B=2, C=300, H=4, KVH=4, D=160, dtype=torch.float32, causal=True),
     300, 0, "random"),
    ("f32_dh256", dict(B=2, C=257, H=4, KVH=2, D=256, dtype=torch.float32, causal=False),
     0, 257, "random"),
    ("dominant_carry_dh256", dict(B=2, C=1000, H=8, KVH=2, D=256, dtype=torch.bfloat16,
                                  causal=True), 1000, 1000, "dominant"),
    # head dims 257..512 (the FMA build at 512, Dh 320 padded, o with it)
    ("bf16_dh320", dict(B=2, C=300, H=4, KVH=2, D=320, dtype=torch.bfloat16, causal=True),
     300, 0, "random"),
    ("f16_dh320", dict(B=2, C=257, H=4, KVH=4, D=320, dtype=torch.float16, causal=True),
     257, 257, "random"),
    ("f32_dh320", dict(B=2, C=200, H=4, KVH=2, D=320, dtype=torch.float32, causal=False),
     0, 200, "random"),
    # above 512: the split (Dh 640 padded to 1024, and 1024), the carry's o
    # split with it: each dtype, the diagonal and a cross offset, causal and
    # not, GQA, hidden rows, and the dominant carry
    ("bf16_dh640", dict(B=2, C=300, H=4, KVH=2, D=640, dtype=torch.bfloat16, causal=True),
     300, 300, "random"),
    ("f16_dh1024", dict(B=1, C=257, H=2, KVH=1, D=1024, dtype=torch.float16, causal=True),
     300, 0, "random"),
    ("f32_dh640", dict(B=2, C=200, H=4, KVH=2, D=640, dtype=torch.float32, causal=False),
     0, 200, "random"),
    ("f32_dh1024_dead", dict(B=1, C=200, H=2, KVH=2, D=1024, dtype=torch.float32, causal=True),
     100, 200, "dead"),
    ("dominant_carry_dh640", dict(B=1, C=300, H=4, KVH=2, D=640, dtype=torch.bfloat16,
                                  causal=True), 300, 300, "dominant"),
    # the wide TMA body's own width and the SIMT kernel with a dominant
    # carry, and the narrow Dh-256 body (inline producer, 64-key tiles, two
    # O parts) at a cross offset over many tiles with ragged GQA chunks
    ("dominant_carry_dh512", dict(B=2, C=1000, H=4, KVH=2, D=512, dtype=torch.bfloat16,
                                  causal=True), 1000, 1000, "dominant"),
    ("dominant_carry_f32", dict(B=2, C=1000, H=8, KVH=2, D=64, dtype=torch.float32,
                                causal=True), 1000, 1000, "dominant"),
    ("dominant_carry_f32_dh512", dict(B=1, C=300, H=4, KVH=2, D=512, dtype=torch.float32,
                                      causal=True), 300, 300, "dominant"),
    ("gqa_ragged1000_cross_dh256", dict(B=2, C=1000, H=8, KVH=2, D=256, dtype=torch.bfloat16,
                                        causal=True), 1037, 0, "random"),
]
# o is compared as o / l: the un-normalised o carries the row's denominator
# (up to ~2000 here), so one bf16 rounding of p that differs between exp2f
# and exp moves o by l times what it moves the output.  bf16: the sound
# kernel's largest o / l error over these cases is ~1.5e-3 on an H100, so
# the limit sits at a few times that, not at the forward's 2e-2 (a typical
# |o / l| at the flagship chunk is ~0.03).  m and l: as the forward's lse,
# f32 sums in another order
RING_O_TOL = {torch.bfloat16: 5e-3, torch.float16: 2.5e-4, torch.float32: 2e-5}
RING_ML_TOL = 1e-4
# the dominant carry's raw o against the carried o (atol = rtol): what the
# step adds is below e^-30 of it, so only f32 rounding of o * alpha remains
DOMINANT_O_TOL = 1e-5
DOMINANT_GAP = 30.0  # m above every scaled score of the chunk, at least

# the wide-head path: the flagship's widths at 4 heads over 2 kv heads (Dh
# 256 with 2:1 GQA, the head geometry of Gemma-style decoders), scoring 16
# rows of 2048 tokens in 2 blocks and training one epoch of 4 steps at B=8;
# remat "none", so that the kernels, not torch's selective-checkpoint
# dispatch, show in ms per step
WIDE_MODEL = dict(
    vocab_size=8192, d_model=1024, n_layers=8, n_heads=4, n_kv_heads=2,
    d_ff=4096, max_seq=2048, dtype=torch.bfloat16, attn_impl="flash",
    remat_policy="none",
)
WIDE_ROWS, WIDE_BLOCKS, WIDE_L = 16, 2, 2048
WIDE_TRAIN_ROWS, WIDE_TRAIN_B = 32, 8

# the train slice: bench.py config 6's widths and its own remat policy
# ("selective", bench.py:642) and TrainConfig(3e-4)
TRAIN_MODEL = dict(
    vocab_size=8192, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
    d_ff=4096, max_seq=2048, dtype=torch.bfloat16, attn_impl="flash",
    remat_policy="selective",
)
TRAIN_ROWS, TRAIN_B, TRAIN_L = 64, 8, 2048
# remat "full" recomputes the same forward from the same params and batch:
# only a different cuBLAS choice could move the first loss
REMAT_LOSS_TOL = 1e-3
# flash vs full attention, one B=2 step of the bf16 model: attention rounds
# to bf16 at different points (the scoring slice's bound on the loss), and
# the gradient norm agrees in relative terms
FULL_LOSS_TOL, FULL_GRAD_NORM_RTOL = 3e-2, 5e-2
SMALL_TRAIN_TOL = 1e-4  # f32, three steps, card vs CPU: summation order

# the forward legs, scored as the wide-head path is (16 rows of 2048 tokens
# in 2 blocks): the wide-head widths at 2 heads over 1 kv head (Dh 512, 2:1
# GQA), and the flagship's widths in f32 (params 0.47 GB; "full" holds one
# layer's [8, 16, 2048, 2048] f32 scores, 2.1 GB); both also train as the
# wide-head path does (the f32 leg on the SIMT forward, dQ and dK/dV alone:
# ~1.3 GB of f32 activations a layer at B=8, ~15 GB a step)
DH512_MODEL = dict(WIDE_MODEL, n_heads=2, n_kv_heads=1)
F32_MODEL = dict(TRAIN_MODEL, dtype=torch.float32, remat_policy="none")
# flash vs full in f32 end to end (TF32 off): the two differ by summation
# order and exp's rounding (~1e-6 relative a layer), while a wrong tile,
# mask or scale moves a mean nll of ~9 by 1e-2 or more
F32_NLL_TOL = 1e-4
# flash vs full, one B=2 train step, (loss, gradient norm relative) by the
# model's dtype: bf16 as above; f32, where summation order is the only
# difference, the loss at F32_NLL_TOL and the norm of ~1.5e8 gradients,
# each a sum over 4096 tokens in another order, at 1e-3
FULL_TOL = {torch.bfloat16: (FULL_LOSS_TOL, FULL_GRAD_NORM_RTOL),
            torch.float32: (F32_NLL_TOL, 1e-3)}

# the ring slices: the flagship widths at 8192 tokens, split over sp = 4
# ranks on the one card (chunks of 2048); "auto" resolves to "ring_flash"
# there (L >= flash_min_len 8192, chunk 2048 passes the dispatch rule)
RING_MODEL = dict(
    vocab_size=8192, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
    d_ff=4096, max_seq=8192, dtype=torch.bfloat16, remat_policy="none",
)
RING_SP, RING_L = 4, 8192
RING_ROWS, RING_BLOCKS = 32, 4  # scoring: 4 blocks of 8 rows
RING_TRAIN_ROWS, RING_TRAIN_B = 16, 2  # training: one epoch of 8 steps
# the flagship hops that chip_smoke times: rank 2's own chunk (the
# diagonal, half the pairs) and rank 3 folding chunk 1 (every pair visible)
RING_HOPS = {"diagonal": (4096, 4096), "off_diagonal": (6144, 2048)}

# the flash/full crossover (attn_impl="auto"'s flash_min_len): the scoring
# slice's widths, a block of the flagship's 16,384 tokens at each length;
# one B=2 train step at each length; the ring legs at sp = 4
CROSSOVER_LS = (256, 512, 1024, 2048, 4096)
CROSSOVER_TOKENS = 8 * 2048
CROSSOVER_RING_LS = (2048, 8192)
CROSSOVER_RING_ROWS = 2  # rows per ring block

# the frontier sweep: cheapest first, at most 6 points
FRONTIER = [dict(batches=(4, 8), seqs=(1024, 2048), remat_policies=("selective",)),
            dict(batches=(8,), seqs=(1024, 2048), remat_policies=("full",))]

# the GraphDef legs: Inception-v3 at full width, 8192 rows in 4 blocks of
# 2048 (bench.py:3113-3118); VGG-16 at 224 x 224, 8192 rows in blocks of
# 512 (cut from 2048: at 2048 one f32 conv1 activation is 26 GB); config
# 3's MLP as a frozen GraphDef over the verbs phase's 65,536 rows
INCEPTION_ROWS, INCEPTION_BLOCKS = 8192, 4
VGG_ROWS, VGG_BLOCKS = 8192, 16
GRAPHDEF_CPU_ROWS = 4
# card against the CPU, f32 (TF32 off): the same convolutions summed in
# another order through 94 (Inception) or 16 (VGG) layers
GRAPHDEF_CPU_TOL = 1e-3
# imported graph against the native model on the card: the same f32
# arithmetic (bf16 weights widen exactly), so only the kernels' choice of
# summation order may differ
GRAPHDEF_NATIVE_TOL = 1e-4


def say(tag: str, **kw) -> None:
    print(f"{tag}: " + json.dumps(kw, default=str), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, ref, tol) -> float:
    got, ref = got.float(), ref.float()
    if torch.isnan(got).any():
        raise AssertionError(f"{name}: NaN values")
    # infinities (a ring carry's m = -inf) must sit where the reference's do
    finite = torch.isfinite(ref)
    if not (torch.equal(finite, torch.isfinite(got))
            and torch.equal(got[~finite], ref[~finite])):
        raise AssertionError(f"{name}: non-finite values differ")
    diff = (got - ref).abs()[finite]
    err = float(diff.max()) if diff.numel() else 0.0
    bad = diff > tol + tol * ref.abs()[finite]
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: max |diff| {err:.3e} beyond atol=rtol={tol:g}"
        )
    return err


def least_tol(got, ref) -> float:
    """The least atol = rtol at which :func:`check_close` passes ``got``
    against ``ref``: the check's margin, printed beside its limit."""
    got, ref = got.float(), ref.float()
    finite = torch.isfinite(ref)
    ratio = (got - ref).abs()[finite] / (1 + ref.abs()[finite])
    return float(ratio.max()) if ratio.numel() else 0.0


def qkv(c, seed=0):
    """Seeded q, k, v on the card: contiguous, or with ``layout="fused"``
    views into one [B, L, H + 2 KVH, D] tensor (Lq == Lk)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(L, heads):
        x = torch.randn(c["B"], L, heads, c["D"], generator=g, device="cuda")
        return x.to(c["dtype"])

    if c.get("layout") == "fused":
        H, KVH = c["H"], c["KVH"]
        x = r(c["Lq"], H + 2 * KVH)
        return x[:, :, :H], x[:, :, H:H + KVH], x[:, :, H + KVH:]
    return r(c["Lq"], c["H"]), r(c["Lk"], c["KVH"]), r(c["Lk"], c["KVH"])


def kernel_bound(c, kernel):
    """Least time for one kernel's work (``roofline.flash_cost``, the count
    the roofline gives the attention op): every input read once, every
    output written once; FLOPs counted for the (query, key) pairs this data
    needs (causal: the top-left triangle, exactly)."""
    B, Lq, Lk, H, KVH, D = (c[k] for k in ("B", "Lq", "Lk", "H", "KVH", "D"))
    es = torch.tensor([], dtype=c["dtype"]).element_size()
    flops, nbytes = roofline.flash_cost(kernel, B, Lq, Lk, H, KVH, D, es, c["causal"])
    peak = PEAK_F32_FLOPS if c["dtype"] == torch.float32 else PEAK_16BIT_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def ring_bound(c, q_off, k_off):
    """Least time for one ring hop at shape ``c`` (``roofline.ring_step_cost``):
    q, k, v read once, the f32 carry o read and written once, m and l read
    and written once; FLOPs (S and PV, 4 per pair and head dim) for the
    (query, key) pairs these offsets leave visible, exactly."""
    B, C, H, KVH, D = (c[k] for k in ("B", "C", "H", "KVH", "D"))
    es = torch.tensor([], dtype=c["dtype"]).element_size()
    flops, nbytes = roofline.ring_step_cost(B, C, H, KVH, D, es, q_off, k_off, c["causal"])
    peak = PEAK_F32_FLOPS if c["dtype"] == torch.float32 else PEAK_16BIT_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    say(
        "env",
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
    )
    # the card's name and power limit, exactly as nvidia-smi prints them
    card = smi[0] if smi else "nvidia-smi: no output"
    print(card, flush=True)
    return card


def phase_build():
    from tensorframes_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        ptxas = [
            ln.strip() for ln in _build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln
        ]
        say("build", source=name, ptxas=ptxas)
    say("build", seconds=round(time.perf_counter() - t0, 3))
    return check_hopper_design(_build)


# The instantiations each kernel is built at, (element type, Dh), and the
# route each (dtype, width) must take, as csrc/ dispatches them: every
# kernel (the forward, dQ, dK/dV and the ring step) takes its TMA + wgmma
# kernel for bf16 and f16 at every width and its SIMT kernel (register
# tiles, exact f32 FMAs) for f32; a width above 512 runs the 512-wide build
# split into chunks of 512.  "fma" names the route that the ring step's
# FMA kernel took until its SIMT and wide TMA bodies replaced it: no kernel
# may be built under it
T16 = ("bf16", "f16")
WIDTHS = (64, 128, 256, 512)
ROUTES = ("tma", "fma", "simt")
SOURCE_OF = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
             "flash_bwd_dkv": "flash_bwd", "ring_step": "flash_ring"}
# the mangled template arguments <T, D> of a kernel's symbol
MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}


def built_instantiations(kernel, route):
    """{(type, Dh)} that csrc/ must build of ``<kernel>_<route>``, alike for
    every kernel: bf16 and f16 at every width under "tma", f32 at every
    width under "simt", nothing under "fma"."""
    if route == "tma":
        return {(t, d) for t in T16 for d in WIDTHS}
    if route == "simt":
        return {("f32", d) for d in WIDTHS}
    return set()


def route_of(kernel, dtype, width):
    """The instantiation ``kernel`` must launch for (dtype, width), named as
    ``flash.kernel_launches`` names it (a split width with its chunks)."""
    from tensorframes_tpu_torch.parallel import flash

    route = {"flash_fwd": flash.fwd_route, "ring_step": flash.ring_route}.get(
        kernel, flash.bwd_route)(dtype)
    return flash.launch_name(kernel, route, dtype, width)


# wgmma, a TMA load, and mma.sync (HMMA: tensor cores without wgmma)
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")
# kernels whose wgmma ptxas must not serialize (C7518): the backward's and
# the ring step's, whose wide bodies are built to avoid it
# (csrc/flash_bwd.cu, csrc/flash_ring.cu)
NO_SERIAL_WGMMA = ("flash_bwd_dq", "flash_bwd_dkv", "ring_step")


def ptxas_spills(log):
    """{kernel: (spill store bytes, spill load bytes)} from ptxas -v."""
    spills, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spills[name] = (int(m.group(1)), int(m.group(2)))
    return spills


def ptxas_registers(log):
    """{kernel: registers a thread} from ptxas -v."""
    regs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def check_hopper_design(_build):
    """Every kernel as built: exactly the instantiations of
    ``built_instantiations``, 0 spill bytes in all; HGMMA and UTMALDG in
    every TMA kernel instantiation's SASS, and none of HGMMA, UTMALDG and
    HMMA in any SIMT kernel's (exact f32 on the FMA pipe); no FMA kernel;
    no setmaxnreg that ptxas ignored (C7508); each instantiation whose
    wgmma ptxas serialized (C7518) is reported, and in the backward's and
    the ring step's TMA kernels (``NO_SERIAL_WGMMA``) fails; each
    instantiation's registers a
    thread are printed.  Returns {source: [built instantiation names]}."""
    sass_of = {src: subprocess.run(
        [_build.cuda_bin("cuobjdump"), "--dump-sass", str(_build.library_path(src))],
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout for src in _build.SOURCES}
    built = {}
    for kernel, src in SOURCE_OF.items():
        log = _build.build_log(src)
        if "C7508" in log:
            raise AssertionError(f"{src}: ptxas ignored setmaxnreg (C7508)")
        serial_fns = re.findall(r"\(C7518\)[^']*'(\S+)'", log)
        spills_all, regs_all = ptxas_spills(log), ptxas_registers(log)
        for route in ROUTES:
            name = f"{kernel}_{route}"
            pat = re.compile(rf"\d+{name}I({'|'.join(MANGLED_TYPES)})Li(\d+)E")
            counts = {}
            for body in re.split(r"\n\s*Function : ", sass_of[src])[1:]:
                fn = body.split("\n", 1)[0].strip()
                m = pat.search(fn)
                if m:
                    inst = (MANGLED_TYPES[m.group(1)], int(m.group(2)))
                    counts[inst] = {op: body.count(op) for op in SASS_OPS}
            want = built_instantiations(kernel, route)
            if set(counts) != want:
                raise AssertionError(f"{name}: built {sorted(counts)}, expected {sorted(want)}")
            tensor_core = route == "tma"
            if any((0 in (c["HGMMA"], c["UTMALDG"])) if tensor_core else sum(c.values())
                   for c in counts.values()):
                raise AssertionError(f"{name}: SASS counts of {SASS_OPS}: {counts}")
            spills = {fn: v for fn, v in spills_all.items() if pat.search(fn)}
            if len(spills) != len(counts) or any(v != (0, 0) for v in spills.values()):
                raise AssertionError(f"{name}: ptxas spills {spills}")
            serial = sorted({f"<{MANGLED_TYPES[m.group(1)]},{m.group(2)}>"
                             for m in map(pat.search, serial_fns) if m})
            if serial and kernel in NO_SERIAL_WGMMA:
                raise AssertionError(f"{name}{serial}: ptxas serialized the wgmma (C7518)")
            built[name] = sorted(f"{name}<{t},{d}>" for t, d in counts)
            registers = {f"<{MANGLED_TYPES[m.group(1)]},{m.group(2)}>": n
                         for fn, n in regs_all.items() for m in [pat.search(fn)] if m}
            say("build", kernel=name, instantiations=built[name],
                sass_counts={f"<{t},{d}>": c for (t, d), c in sorted(counts.items())},
                spill_bytes=sorted(set(spills.values())), serialized_wgmma=serial,
                registers=dict(sorted(registers.items())))
    return built


def phase_kernels():
    from tensorframes_tpu_torch.parallel import flash

    errs = {}
    for name, c in KERNEL_CASES:
        q, k, v = qkv(c)
        flash.reset_launches()
        out, lse = flash.flash_attention_fwd(q, k, v, c["causal"])
        torch.cuda.synchronize()
        width = flash.kernel_head_dim(c["D"])
        launched = dict(flash.kernel_launches)
        if launched != {route_of("flash_fwd", c["dtype"], width): 1}:
            raise AssertionError(f"{name}: forward launched {launched}")
        ref_out, ref_lse = flash.flash_attention_plain(q, k, v, c["causal"])
        torch.cuda.synchronize()
        e_out = check_close(f"{name} out", out, ref_out, TOL[c["dtype"]])
        e_lse = check_close(f"{name} lse", lse, ref_lse, LSE_TOL[c["dtype"]])
        # the backward kernels on the kernel's own out/lse
        do = torch.randn(out.shape, generator=torch.Generator(device="cuda")
                         .manual_seed(7), device="cuda").to(c["dtype"])
        flash.reset_launches()
        grads = flash.flash_attention_bwd(q, k, v, out, lse, do, c["causal"])
        torch.cuda.synchronize()
        # the backward's launches went through the instantiations csrc/
        # must dispatch this dtype and width to
        want = {route_of(kn, c["dtype"], width): 1 for kn in ("flash_bwd_dq", "flash_bwd_dkv")}
        if flash.kernel_launches != want:
            raise AssertionError(f"{name}: launched {flash.kernel_launches}, expected {want}")
        refs = flash.flash_attention_bwd_plain(q, k, v, out, lse, do, c["causal"])
        torch.cuda.synchronize()
        e_bwd = {
            g: check_close(f"{name} {g}", got, ref, BWD_TOL[c["dtype"]])
            for g, got, ref in zip(("dq", "dk", "dv"), grads, refs)
        }
        errs[name] = dict(flash_fwd=e_out, flash_bwd_dq=e_bwd["dq"],
                          flash_bwd_dkv=max(e_bwd["dk"], e_bwd["dv"]))
        need = {"out": least_tol(out, ref_out), **{
            g: least_tol(got, ref) for g, got, ref in zip(("dq", "dk", "dv"), grads, refs)}}
        say("kernel", case=name, max_abs_err_out=e_out, max_abs_err_lse=e_lse,
            max_abs_err_bwd=e_bwd, tol=TOL[c["dtype"]], launched={**launched, **want},
            bwd_tol=BWD_TOL[c["dtype"]], least_tol=need,
            shape={k_: str(v_) for k_, v_ in c.items()})
    errs["autograd"] = phase_autograd()
    errs["ring"] = phase_ring_kernel()
    return errs


def ring_inputs(c, carry, seed=0):
    """q/k/v as ``qkv`` (one chunk each) and an f32 carry of the given kind."""
    q, k, v = qkv(dict(c, Lq=c["C"], Lk=c["C"]), seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    B, C, H, D = c["B"], c["C"], c["H"], c["D"]
    if carry == "empty":
        o = torch.zeros(B, C, H, D, device="cuda")
        m = torch.full((B, H, C), float("-inf"), device="cuda")
        l = torch.zeros(B, H, C, device="cuda")
        return q, k, v, o, m, l
    o = 3 * torch.randn(B, C, H, D, generator=g, device="cuda")
    m = torch.randn(B, H, C, generator=g, device="cuda")
    l = 1 + 49 * torch.rand(B, H, C, generator=g, device="cuda")
    if carry == "dead":
        m[:, :, ::3] = float("-inf")
    if carry == "dominant":
        # scaled scores of these inputs stay below ~7, m's randn above -5
        m += 20 + DOMINANT_GAP
    return q, k, v, o, m, l


def score_max(q, k):
    """The largest scaled score of each query row against the whole chunk
    [B, H, C] (every key, so an upper bound of the visible ones)."""
    g = q.shape[2] // k.shape[2]
    kh = k.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) / q.shape[3] ** 0.5
    return s.amax(-1)


def per_l(o, l):
    """A ring carry's o divided by its row's l (rows with l = 0 carry
    o = 0): the output the forward's tolerance is stated for."""
    return o / torch.where(l == 0, 1.0, l).transpose(1, 2)[..., None]


def phase_ring_kernel():
    """The ring step against flash_ring_step_plain on the card."""
    from tensorframes_tpu_torch.parallel import flash

    errs = {}
    for name, c, q_off, k_off, carry in RING_CASES:
        args = ring_inputs(c, carry)
        flash.reset_launches()
        got = flash.flash_ring_step(*args, q_off, k_off, c["causal"])
        torch.cuda.synchronize()
        launched = dict(flash.kernel_launches)
        if launched != {route_of("ring_step", c["dtype"], flash.kernel_head_dim(c["D"])): 1}:
            raise AssertionError(f"ring {name}: launched {launched}")
        ref = flash.flash_ring_step_plain(*args, q_off, k_off, c["causal"])
        torch.cuda.synchronize()
        e = {
            part: check_close(f"ring {name} {part}", a, b, tol)
            for part, a, b, tol in zip(
                ("o/l", "m", "l"), (per_l(got[0], ref[2]), *got[1:]),
                (per_l(ref[0], ref[2]), *ref[1:]),
                (RING_O_TOL[c["dtype"]], RING_ML_TOL, RING_ML_TOL),
            )
        }
        e["o_raw"] = float((got[0] - ref[0]).abs().max())
        # rows the chunk is hidden from keep their carry exactly, or carry
        # m = -inf, l = 0, o = 0 where the carried max was -inf
        n = max(0, min(k_off - q_off, c["C"])) if c["causal"] else 0
        o, m, l = args[3][:, :n], args[4][:, :, :n], args[5][:, :, :n]
        dead = torch.isneginf(m)
        want = (torch.where(dead.transpose(1, 2)[..., None], 0.0, o), m,
                torch.where(dead, 0.0, l))
        cut = (got[0][:, :n], got[1][:, :, :n], got[2][:, :, :n])
        if not all(torch.equal(a, b) for a, b in zip(cut, want)):
            raise AssertionError(f"ring {name}: rows that see no key must keep their carry")
        if carry == "dominant":
            gap = float((args[4] - score_max(*args[:2])).min())
            if not gap >= DOMINANT_GAP:
                raise AssertionError(f"ring {name}: carried m only {gap} above the scores")
            e["o_raw_vs_carry"] = check_close(
                f"ring {name} raw o vs the carried o", got[0], args[3], DOMINANT_O_TOL)
        errs[name] = e["o/l"]
        say("kernel", ring_case=name, q_off=q_off, k_off=k_off, carry=carry, launched=launched,
            max_abs_err=e, o_tol=RING_O_TOL[c["dtype"]], ml_tol=RING_ML_TOL,
            least_tol_o_l=least_tol(per_l(got[0], ref[2]), per_l(ref[0], ref[2])),
            shape={k_: str(v_) for k_, v_ in c.items()})

    # an explicit ring_flash folds every hop with the kernel, also at a chunk
    # the TPU cannot tile (C = 130), and agrees with the xla step
    from tensorframes_tpu_torch.parallel import mesh, ring

    # (and at Dh = 32, where ring.py pads q, k, v once for every hop and
    # carries o padded)
    sp, C = 4, 130
    for D in (64, 32):
        q, k, v = qkv(dict(B=2, Lq=sp * C, Lk=sp * C, H=4, KVH=2, D=D,
                           dtype=torch.bfloat16), seed=1)
        with mesh.set_mesh(mesh.training_mesh(sp=sp)):
            flash.reset_launches()
            got = ring.ring_attention(q, k, v, True, impl="flash")
            torch.cuda.synchronize()
            n = flash.launches_ring
            ref = ring.ring_attention(q, k, v, True, impl="xla")
        if n != hops_per_layer(sp) or got.shape != q.shape:
            raise AssertionError(f"ring_flash at C={C}, Dh={D}: {n} ring steps, "
                                 f"expected {hops_per_layer(sp)}; out {tuple(got.shape)}")
        e = check_close(f"ring_flash C={C} Dh={D} vs xla step", got, ref,
                        TOL[torch.bfloat16])
        say("kernel", check=f"ring_flash at C={C}, Dh={D}, sp={sp}, vs the xla step",
            ring_step_launches=n, max_abs_err=e, tol=TOL[torch.bfloat16])
    return errs


def phase_autograd():
    """Gradients through flash_attention (the autograd Function) on the
    card against the same Function on CPU copies (its plain versions), one
    small f32 GQA case; atol = rtol = 2e-4 (summation order)."""
    from tensorframes_tpu_torch.parallel import flash

    rng = np.random.RandomState(3)
    arrays = [rng.randn(2, 100, heads, 64).astype(np.float32) for heads in (4, 2, 2)]
    w = rng.randn(2, 100, 4, 64).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True) for a in arrays)
        (flash.flash_attention(q, k, v, True) * torch.tensor(w, device=dev)).sum().backward()
        grads[dev] = (q.grad, k.grad, v.grad)
    err = max(
        check_close(f"autograd {n}", g.cpu(), r, 2e-4)
        for n, g, r in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"])
    )
    say("kernel", check="autograd Function, cuda vs cpu (f32, atol=rtol=2e-4)",
        max_abs_err=err)
    return err


def phase_timing():
    from tensorframes_tpu_torch.parallel import flash

    c = FLAGSHIP
    q, k, v = qkv(c, seed=1)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(2), device="cuda").to(c["dtype"])
    out, lse = flash.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    # one library call computing the same function, timed only: SDPA on
    # [B, H, L, D] views (Lq == Lk, so its causal mask is the same one);
    # its backward computes dq, dk and dv in one call, so it is the
    # yardstick of both backward kernels
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o_lib = sdpa(qt, kt, vt, is_causal=True)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 20)
    runs = {
        "flash_fwd": (
            lambda: flash.flash_attention_fwd(q, k, v, True),
            lambda: flash.flash_attention_plain(q, k, v, True),
            lambda: sdpa(qt, kt, vt, is_causal=True),
        ),
        "flash_bwd_dq": (
            lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: flash.flash_bwd_dq_plain(q, k, v, out, lse, do, True),
            None,
        ),
        "flash_bwd_dkv": (
            lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: flash.flash_bwd_dkv_plain(q, k, v, out, lse, do, True),
            None,
        ),
    }
    timing = {}
    with torch.no_grad():
        for name, (kernel, plain, library) in runs.items():
            bound_ms, bound_by, flops = kernel_bound(c, name)
            row = dict(
                ms=cuda_ms(kernel, 20),
                plain_ms=cuda_ms(plain, 3, 1),
                library_ms=cuda_ms(library, 20) if library else sdpa_bwd_ms,
                bound_ms=bound_ms, bound_by=bound_by,
            )
            timing[name] = row
            say("timing", kernel=name, **row,
                share_of_bound=bound_ms / row["ms"],
                tflops_per_s=flops / row["ms"] / 1e9)
        time_pair(c, "flagship", runs["flash_bwd_dq"][0], runs["flash_bwd_dkv"][0], 20,
                  sdpa_bwd_ms, timing["flash_bwd_dq"]["ms"], timing["flash_bwd_dkv"]["ms"])
    timing["flash_ring_step"] = phase_ring_timing()
    timing["variants"] = phase_variant_timing()
    return timing


# each kernel at a padded head dim, in f16, at Dh = 256 (the wide-head
# path's GQA too), in f32 at every built width (the SIMT forward and
# backward), in bf16 at 512 and split above 512 (Dh 640 padded to 1024
# and 1024 itself, each two chunks of 512), at the flagship's batch, length
# and d_model (H = 1024 / Dh; 2 heads at 640); records only, the bound is
# each variant's true work, f32's at the FMA pipe's rate
VARIANTS = {
    "dh32_bf16": dict(FLAGSHIP, D=32),
    "dh64_f16": dict(FLAGSHIP, dtype=torch.float16),
    "dh256_bf16": dict(FLAGSHIP, D=256, H=4, KVH=4),
    "dh256_gqa_bf16": dict(FLAGSHIP, D=256, H=4, KVH=2),
    "dh64_f32": dict(FLAGSHIP, dtype=torch.float32),
    "dh128_f32": dict(FLAGSHIP, D=128, H=8, KVH=8, dtype=torch.float32),
    "dh256_f32": dict(FLAGSHIP, D=256, H=4, KVH=4, dtype=torch.float32),
    "dh512_f32": dict(FLAGSHIP, D=512, H=2, KVH=2, dtype=torch.float32),
    "dh512_bf16": dict(FLAGSHIP, D=512, H=2, KVH=2),
    "dh640_bf16": dict(FLAGSHIP, D=640, H=2, KVH=2),
    "dh1024_bf16": dict(FLAGSHIP, D=1024, H=1, KVH=1),
}
# the f32 SIMT kernels take a few ms a call at these shapes: fewer timed
# calls than the 16-bit kernels' 20
SIMT_ITERS = 10


def variant_iters(c):
    """Timed calls of a variant's kernels: SIMT_ITERS in f32, 20 for the
    16-bit ones."""
    return SIMT_ITERS if c["dtype"] == torch.float32 else 20


def time_pair(c, variant, dq, dkv, iters, sdpa_bwd_ms, dq_ms, dkv_ms):
    """The backward's pair at shape ``c``, dQ then dK/dV timed as one call,
    against SDPA's whole backward on the same inputs (it computes dq, dk
    and dv in one call: the fair yardstick of the pair, not of either
    kernel alone), beside the sum of the kernels' own times and of their
    bounds."""
    ms = cuda_ms(lambda: (dq(), dkv()), iters)
    bound_ms = kernel_bound(c, "flash_bwd_dq")[0] + kernel_bound(c, "flash_bwd_dkv")[0]
    say("timing", pair="flash_bwd_dq+flash_bwd_dkv", variant=variant, ms=ms,
        sum_ms=dq_ms + dkv_ms, library_ms=sdpa_bwd_ms, factor_vs_library=ms / sdpa_bwd_ms,
        bound_ms=bound_ms)
    return ms


def sdpa(q, k, v, is_causal=False):
    """PyTorch's one-call attention on [B, H, L, D] views (timed only, never
    called by the port), with its own GQA where the heads differ."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=is_causal, enable_gqa=q.shape[1] != k.shape[1])


def sdpa_backend(q, k, v, is_causal=False):
    """The backend :func:`sdpa`'s dispatch picks for these inputs
    (``torch._fused_sdp_choice``, the choice SDPA itself makes), by name:
    above a head dim of 256 the flash backend refuses and another runs."""
    from torch.nn.attention import SDPBackend

    idx = torch._fused_sdp_choice(q, k, v, attn_mask=None, dropout_p=0.0,
                                  is_causal=is_causal, scale=None,
                                  enable_gqa=q.shape[1] != k.shape[1])
    return {int(b.value): n for n, b in SDPBackend.__members__.items()}.get(int(idx), str(idx))


def phase_variant_timing():
    """Each kernel at every VARIANTS shape (the wrappers' pad and slice
    included): the forward, dQ and dK/dV beside SDPA's forward / backward
    at the same shape, and the ring step's off-diagonal flagship hop beside
    SDPA's forward on the chunk pair, each with its bound; each timed
    call's output is held against the plain version's on the same
    inputs."""
    from tensorframes_tpu_torch.parallel import flash

    rows = {name: {} for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                  "flash_ring_step")}

    def record(kernel, variant, c, row, flops):
        rows[kernel][variant] = row
        say("timing", kernel=kernel, variant=variant, **row,
            share_of_bound=row["bound_ms"] / row["ms"],
            tflops_per_s=flops / row["ms"] / 1e9,
            shape={k_: str(v_) for k_, v_ in c.items()})

    for name, c in VARIANTS.items():
        n = variant_iters(c)
        q, k, v = qkv(c, seed=3)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                         .manual_seed(4), device="cuda").to(c["dtype"])
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        backend = sdpa_backend(qt, kt, vt, is_causal=True)
        o_lib = sdpa(qt, kt, vt, is_causal=True)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 20)
        del o_lib
        with torch.no_grad():
            out, lse = flash.flash_attention_fwd(q, k, v, True)
            ref_out, ref_lse = flash.flash_attention_plain(q, k, v, True)
            err = check_close(f"{name} out", out, ref_out, TOL[c["dtype"]])
            check_close(f"{name} lse", lse, ref_lse, LSE_TOL[c["dtype"]])
            grads = flash.flash_attention_bwd(q, k, v, out, lse, do, True)
            refs = flash.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
            g_err = [check_close(f"{name} {g}", a, b_, BWD_TOL[c["dtype"]])
                     for g, a, b_ in zip(("dq", "dk", "dv"), grads, refs)]
            del ref_out, ref_lse, grads, refs
            bound_ms, bound_by, flops = kernel_bound(c, "flash_fwd")
            record("flash_fwd", name, c, dict(
                ms=cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, True), n),
                plain_ms=cuda_ms(lambda: flash.flash_attention_plain(q, k, v, True), 3, 1),
                library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                sdpa_backend=backend), flops)
            # each backward kernel alone on the inputs the wrapper prepares
            # (padded to the kernel's width, D = rowsum(dO o O) computed), as
            # the flagship rows time them; beside it the whole padded
            # backward (the pad, D, both kernels, the slice)
            w = flash.kernel_head_dim(c["D"])
            pq, pk, pv, pout, pdo = (flash.pad_head_dim(x, w) for x in (q, k, v, out, do))
            delta = (pdo.float() * pout.float()).sum(-1).transpose(1, 2).contiguous()
            scale = flash._scale(c["D"])
            bwd_path_ms = cuda_ms(
                lambda: flash.flash_attention_bwd(q, k, v, out, lse, do, True), n)
            launch = {
                "flash_bwd_dq": lambda: flash.flash_bwd_dq(pq, pk, pv, pdo, lse, delta, True,
                                                           scale),
                "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(pq, pk, pv, pdo, lse, delta, True,
                                                             scale),
            }
            for kernel, e in (("flash_bwd_dq", g_err[0]), ("flash_bwd_dkv", max(g_err[1:]))):
                bound_ms, bound_by, flops = kernel_bound(c, kernel)
                plain = (flash.flash_bwd_dq_plain if kernel == "flash_bwd_dq"
                         else flash.flash_bwd_dkv_plain)
                record(kernel, name, c, dict(
                    ms=cuda_ms(launch[kernel], n),
                    plain_ms=cuda_ms(lambda: plain(q, k, v, out, lse, do, True), 3, 1),
                    library_ms=sdpa_bwd_ms, bound_ms=bound_ms, bound_by=bound_by,
                    max_abs_err=e, padded_backward_path_ms=bwd_path_ms,
                    sdpa_backend=backend), flops)
            time_pair(c, name, launch["flash_bwd_dq"], launch["flash_bwd_dkv"], n, sdpa_bwd_ms,
                      rows["flash_bwd_dq"][name]["ms"], rows["flash_bwd_dkv"][name]["ms"])
            del pq, pk, pv, pout, pdo, delta, launch
        del q, k, v, do, qt, kt, vt, out, lse
        # the ring step at the off-diagonal flagship hop, at this variant
        rc = dict(RING_FLAGSHIP, D=c["D"], H=c["H"], KVH=c["KVH"], dtype=c["dtype"])
        q_off, k_off = RING_HOPS["off_diagonal"]
        args = ring_inputs(rc, "random", seed=5)
        rq, rk, rv = (x.transpose(1, 2) for x in args[:3])
        n = variant_iters(rc)
        with torch.no_grad():
            got = flash.flash_ring_step(*args, q_off, k_off, True)
            ref = flash.flash_ring_step_plain(*args, q_off, k_off, True)
            err = check_close(f"ring {name} o/l", per_l(got[0], ref[2]),
                              per_l(ref[0], ref[2]), RING_O_TOL[rc["dtype"]])
            del got, ref
            bound_ms, bound_by, flops = ring_bound(rc, q_off, k_off)
            record("flash_ring_step", name, rc, dict(
                ms=cuda_ms(lambda: flash.flash_ring_step(*args, q_off, k_off, True), n),
                plain_ms=cuda_ms(lambda: flash.flash_ring_step_plain(
                    *args, q_off, k_off, True), 3, 1),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                sdpa_yardstick_ms=cuda_ms(lambda: sdpa(rq, rk, rv), 20),
                max_abs_err=err), flops)
        del args, rq, rk, rv
    return rows


def phase_ring_timing():
    """The ring step at both flagship hops, its plain version, and SDPA's
    forward on the same chunk pair: the nearest yardstick, not the same
    function (no PyTorch call folds a carry)."""
    from tensorframes_tpu_torch.parallel import flash

    c = RING_FLAGSHIP
    args = ring_inputs(c, "random", seed=1)
    qt, kt, vt = (x.transpose(1, 2) for x in args[:3])
    hops = {}
    with torch.no_grad():
        for hop, (q_off, k_off) in RING_HOPS.items():
            bound_ms, bound_by, flops = ring_bound(c, q_off, k_off)
            row = dict(
                ms=cuda_ms(lambda: flash.flash_ring_step(*args, q_off, k_off, True), 20),
                plain_ms=cuda_ms(lambda: flash.flash_ring_step_plain(
                    *args, q_off, k_off, True), 3, 1),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                sdpa_yardstick_ms=cuda_ms(
                    lambda: sdpa(qt, kt, vt, is_causal=q_off == k_off), 20),
            )
            hops[hop] = row
            say("timing", kernel="flash_ring_step", hop=hop, q_off=q_off,
                k_off=k_off, **row, share_of_bound=bound_ms / row["ms"],
                tflops_per_s=flops / row["ms"] / 1e9)
    return hops


def phase_slice():
    from tensorframes_tpu_torch import TensorFrame, map_blocks
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    cfg = tfm.TransformerConfig(
        vocab_size=8192, d_model=1024, n_layers=8, n_heads=16,
        n_kv_heads=16, d_ff=4096, max_seq=2048, dtype=torch.bfloat16,
        attn_impl="flash",
    )
    rows, L, blocks = 64, 2048, 8
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (rows, L))
    frame = TensorFrame.from_arrays(
        {"tokens": tokens.astype(np.int32)}, num_blocks=blocks
    )
    warm = TensorFrame.from_arrays({"tokens": tokens[: rows // blocks].astype(np.int32)})

    def score(program):
        map_blocks(program, warm).to_arrays()  # warm-up: one block
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()  # count the main path's run alone
        t0 = time.perf_counter()
        out = map_blocks(program, frame).to_arrays()  # ends in a D2H sync
        elapsed = time.perf_counter() - t0
        return out, elapsed, flash.launches, torch.cuda.max_memory_allocated()

    prog = scoring.scoring_program(params, cfg, fetches=scoring.FETCHES)
    out, sec, launches, peak = score(prog)
    by_instantiation = dict(flash.kernel_launches)
    if launches != cfg.n_layers * blocks:
        raise AssertionError(
            f"flash kernel launched {launches} times on the main path, "
            f"expected n_layers x blocks = {cfg.n_layers * blocks}"
        )
    for key, shape in (("nll", (rows,)), ("perplexity", (rows,)),
                       ("embedding", (rows, cfg.d_model))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{key}: shape {out[key].shape} or non-finite")
    say("slice", attn_impl="flash", rows=rows, tokens_per_row=L, blocks=blocks,
        seconds=sec, rows_per_s=rows / sec, tokens_per_s=rows * L / sec,
        ms_per_block=sec / blocks * 1e3, peak_bytes=peak,
        flash_launches=launches, nll_mean=float(out["nll"].mean()))

    full_cfg = dataclasses.replace(cfg, attn_impl="full")
    full_prog = scoring.scoring_program(params, full_cfg, fetches=("nll",))
    full, full_sec, _, full_peak = score(full_prog)
    diff = float(np.abs(full["nll"] - out["nll"]).max())
    if not diff <= NLL_TOL:
        raise AssertionError(f"nll flash vs full: max |diff| {diff} > {NLL_TOL}")
    say("slice", attn_impl="full", seconds=full_sec,
        ms_per_block=full_sec / blocks * 1e3, peak_bytes=full_peak,
        nll_max_abs_diff_vs_flash=diff, nll_tol=NLL_TOL,
        full_over_flash_ms_per_block=full_sec / sec)

    # small input: the card's path against the port's CPU path (plain
    # attention version), f32 so the comparison is tight
    small = tfm.TransformerConfig(
        vocab_size=64, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
        d_ff=256, max_seq=64, dtype=torch.float32, attn_impl="flash",
    )
    sp = tfm.init(torch.Generator().manual_seed(1), small, device="cpu")
    toks = np.random.RandomState(1).randint(0, 64, (6, 40)).astype(np.int32)
    sf = TensorFrame.from_arrays({"tokens": toks}, num_blocks=2)
    gpu = map_blocks(scoring.scoring_program(
        {k: v for k, v in sp.items()}, small, fetches=scoring.FETCHES,
        device="cuda"), sf).to_arrays()
    cpu = map_blocks(scoring.scoring_program(
        sp, small, fetches=scoring.FETCHES, device="cpu"), sf).to_arrays()
    errs = {}
    for key in scoring.FETCHES:
        errs[key] = check_close(
            f"small {key}", torch.from_numpy(gpu[key]),
            torch.from_numpy(cpu[key]), 1e-4,
        )
    say("slice", check="small input, cuda vs cpu (f32, atol=rtol=1e-4)",
        max_abs_err=errs)
    return prog, frame, by_instantiation




def score_leg(tag, cfg, params, seed, nll_tol, route):
    """One scoring leg: WIDE_ROWS seeded rows of WIDE_L tokens in
    WIDE_BLOCKS blocks, scored by ``cfg`` through Program -> map_blocks
    after a warm-up block; the forward's launches, counted over that run
    alone, must be n_layers x blocks of the ``route`` instantiation at the
    model's head dim and nothing else; nll, perplexity and embedding of the
    expected shapes and finite, and nll within ``nll_tol`` of the same
    frame scored with attn_impl="full".  Returns (launches by
    instantiation, program, one block)."""
    from tensorframes_tpu_torch import TensorFrame, map_blocks
    from tensorframes_tpu_torch.models import scoring
    from tensorframes_tpu_torch.parallel import flash

    width = flash.kernel_head_dim(cfg.d_model // cfg.n_heads)
    tokens = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (WIDE_ROWS, WIDE_L)).astype(np.int32)
    frame = TensorFrame.from_arrays({"tokens": tokens}, num_blocks=WIDE_BLOCKS)
    block = TensorFrame.from_arrays({"tokens": tokens[: WIDE_ROWS // WIDE_BLOCKS]})

    def score(program):
        map_blocks(program, block).to_arrays()  # warm-up: one block
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()  # count the main path's run alone
        t0 = time.perf_counter()
        out = map_blocks(program, frame).to_arrays()  # ends in a D2H sync
        sec = time.perf_counter() - t0
        return out, sec, dict(flash.kernel_launches), torch.cuda.max_memory_allocated()

    prog = scoring.scoring_program(params, cfg, fetches=scoring.FETCHES)
    out, sec, scored, peak = score(prog)
    want = {route_of("flash_fwd", cfg.dtype, width): cfg.n_layers * WIDE_BLOCKS}
    if scored != want or not all(f"_{route}<" in k for k in want):
        raise AssertionError(f"{tag} scoring: launched {scored}, expected {want}")
    for key, shape in (("nll", (WIDE_ROWS,)), ("perplexity", (WIDE_ROWS,)),
                       ("embedding", (WIDE_ROWS, cfg.d_model))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{tag} {key}: shape {out[key].shape} or non-finite")
    full, full_sec, _, full_peak = score(scoring.scoring_program(
        params, dataclasses.replace(cfg, attn_impl="full"), fetches=("nll",)))
    diff = float(np.abs(full["nll"] - out["nll"]).max())
    if not diff <= nll_tol:
        raise AssertionError(f"{tag} nll flash vs full: max |diff| {diff} > {nll_tol}")
    say(tag, leg="score", attn_impl="flash", dtype=str(cfg.dtype), head_dim=width,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, rows=WIDE_ROWS,
        tokens_per_row=WIDE_L, blocks=WIDE_BLOCKS, seconds=sec,
        ms_per_block=sec / WIDE_BLOCKS * 1e3, tokens_per_s=WIDE_ROWS * WIDE_L / sec,
        peak_bytes=peak, launched=scored, nll_mean=float(out["nll"].mean()),
        full_ms_per_block=full_sec / WIDE_BLOCKS * 1e3, full_peak_bytes=full_peak,
        nll_max_abs_diff_vs_full=diff, nll_tol=nll_tol)
    return scored, prog, block


def train_leg(tag, cfg, params, seed):
    """One epoch of ``cfg`` (remat as it says) from a FrameLoader through
    train.fit, WIDE_TRAIN_ROWS seeded rows of WIDE_L + 1 tokens at
    B=WIDE_TRAIN_B, after a warm-up step: the kernels' launches, counted
    over that run alone, must be n_layers x steps of each of the forward,
    dQ and dK/dV at the instantiation ``route_of`` names for the model's
    dtype and head dim and nothing else; the losses finite; ms per step,
    tokens/s, counted TFLOP/s, peak memory and the memory held at its start;
    then a B=2 step against attn_impl="full".  Returns the launches by
    instantiation and (config, train config, params, loader) for
    profiling."""
    from tensorframes_tpu_torch import TensorFrame, data, train
    from tensorframes_tpu_torch.parallel import flash

    width = flash.kernel_head_dim(cfg.d_model // cfg.n_heads)
    tc = train.TrainConfig(learning_rate=3e-4)
    steps = WIDE_TRAIN_ROWS // WIDE_TRAIN_B
    start = np.random.RandomState(seed).randint(0, cfg.vocab_size, (WIDE_TRAIN_ROWS, 1))
    toks = ((start + np.arange(WIDE_L + 1)) % cfg.vocab_size).astype(np.int32)
    tframe = TensorFrame.from_arrays({"tokens": toks}, num_blocks=4)

    def loader():
        return data.FrameLoader(tframe, batch_size=WIDE_TRAIN_B, shuffle=True, seed=0)

    train.fit(loader(), cfg, tc, steps=1, params=params)  # warm-up step
    start_params = clone_params(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the peak counts it too (earlier legs' tensors)
    flash.reset_launches()
    t0 = time.perf_counter()
    _, _, losses = train.fit(loader(), cfg, tc, steps=steps, params=params)
    sec = time.perf_counter() - t0  # fit's losses are read: synced
    trained, peak = dict(flash.kernel_launches), train.hbm_high_water()
    want = {route_of(k, cfg.dtype, width): cfg.n_layers * steps
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if trained != want:
        raise AssertionError(f"{tag} train: launched {trained}, expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag} train losses not finite: {losses}")
    n_params = train.n_params(params)
    tokens_run = steps * WIDE_TRAIN_B * WIDE_L
    flops_per_token = train.counted_flops_per_token(n_params, cfg, WIDE_L)
    say(tag, leg="train", attn_impl="flash", remat=cfg.remat_policy, head_dim=width,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, steps=steps,
        batch=WIDE_TRAIN_B, seq=WIDE_L, n_params=n_params, seconds=sec,
        ms_per_step=sec / steps * 1e3, tokens_per_s=tokens_run / sec,
        counted_tflops_per_s=flops_per_token * tokens_run / sec / 1e12,
        peak_bytes=peak, resident_bytes_at_start=resident, launched=trained, losses=losses)
    flash_vs_full_step(tag, cfg, tc, start_params, toks[:2])
    return trained, (cfg, tc, params, loader)


def phase_wide_head():
    """The wide-head path: the flagship's widths at 4 heads over 2 kv heads
    (Dh 256, 2:1 GQA), scored through Program -> map_blocks and trained
    through FrameLoader -> train.fit with remat "none", on the Dh-256
    forward, dQ and dK/dV TMA kernels.  Launch counts by
    instantiation, nll against "full", a B=2 step against "full".  Returns
    the two runs' launches by instantiation, and (program, one block,
    config, train config, params, loader) for profiling."""
    from tensorframes_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**WIDE_MODEL)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    scored, prog, block = score_leg("wide_head", cfg, params, 7, NLL_TOL, "tma")
    trained, train_run = train_leg("wide_head", cfg, params, 8)
    return scored, trained, (prog, block, *train_run)


def phase_dh512_train():
    """The Dh-512 leg's training: DH512_MODEL (the wide-head widths at 2
    heads over 1 kv head) trains one epoch through FrameLoader -> train.fit
    (``train_leg``) on ``flash_fwd_tma<bf16,512>``,
    ``flash_bwd_dq_tma<bf16,512>`` and ``flash_bwd_dkv_tma<bf16,512>``
    alone.  Returns the launches by instantiation and (config, train
    config, params, loader) for profiling."""
    from tensorframes_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**DH512_MODEL)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    return train_leg("dh512_leg", cfg, params, 11)


def phase_f32_train():
    """The f32 leg's training: F32_MODEL (the flagship's widths in f32,
    TF32 off, remat "none") trains one epoch through FrameLoader ->
    train.fit (``train_leg``) on ``flash_fwd_simt<f32,64>``,
    ``flash_bwd_dq_simt<f32,64>`` and ``flash_bwd_dkv_simt<f32,64>``
    alone, with a B=2 step against "full" at FULL_TOL[f32].  Returns the
    launches by instantiation and (config, train config, params, loader)
    for profiling."""
    from tensorframes_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**F32_MODEL)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    return train_leg("f32_leg", cfg, params, 12)


def phase_forward_legs():
    """The forward's two redesigned kernels, each on a scoring path of its
    own (``score_leg``): the wide-head widths at 2 heads over 1 kv head
    (Dh 512, 2:1 GQA) on ``flash_fwd_tma<bf16,512>``, and the flagship's
    widths in f32 (TF32 off) on ``flash_fwd_simt<f32,64>``.  Returns the
    two runs' launches by instantiation, and {leg: (program, one block)}
    for profiling."""
    from tensorframes_tpu_torch.models import transformer as tfm

    runs, legs = [], {}
    for tag, model, seed, tol, route in (("dh512_leg", DH512_MODEL, 9, NLL_TOL, "tma"),
                                         ("f32_leg", F32_MODEL, 10, F32_NLL_TOL, "simt")):
        cfg = tfm.TransformerConfig(**model)
        params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
        scored, *legs[tag] = score_leg(tag, cfg, params, seed, tol, route)
        runs.append(scored)
    return runs, legs


def phase_small_head_slice():
    """A model at Dh = 32 scores a frame through map_blocks with
    attn_impl="flash" on the card: the forward kernel must launch
    n_layers x blocks times (padded launches count), and nll must agree
    with the port's CPU path: f32 at 1e-4; bf16 (the TMA kernel) at the
    scoring slice's NLL_TOL."""
    from tensorframes_tpu_torch import TensorFrame, map_blocks
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    toks = np.random.RandomState(5).randint(
        0, SMALL_HEAD["vocab_size"], (SMALL_HEAD_ROWS, SMALL_HEAD_L)).astype(np.int32)
    frame = TensorFrame.from_arrays({"tokens": toks}, num_blocks=SMALL_HEAD_BLOCKS)
    f32 = tfm.TransformerConfig(**SMALL_HEAD, dtype=torch.float32)
    cpu_params = tfm.init(torch.Generator().manual_seed(2), f32, device="cpu")
    cpu = map_blocks(scoring.scoring_program(cpu_params, f32, fetches=("nll",),
                                             device="cpu"), frame).to_arrays()["nll"]
    for dtype, tol in ((torch.float32, SMALL_HEAD_TOL), (torch.bfloat16, NLL_TOL)):
        cfg = dataclasses.replace(f32, dtype=dtype)
        prog = scoring.scoring_program(cpu_params, cfg, fetches=("nll",), device="cuda")
        # warm-up: the bucket plan classifies the program on its first call
        map_blocks(prog, frame).to_arrays()
        torch.cuda.synchronize()
        flash.reset_launches()
        t0 = time.perf_counter()
        nll = map_blocks(prog, frame).to_arrays()["nll"]
        sec = time.perf_counter() - t0
        want = cfg.n_layers * SMALL_HEAD_BLOCKS
        if flash.launches != want:
            raise AssertionError(f"small-head slice ({dtype}): {flash.launches} forward "
                                 f"launches, expected n_layers x blocks = {want}")
        err = check_close(f"small-head nll {dtype}", torch.from_numpy(nll),
                          torch.from_numpy(cpu), tol)
        say("small_head_slice", dtype=str(dtype), head_dim=cfg.d_model // cfg.n_heads,
            kernel_head_dim=flash.kernel_head_dim(cfg.d_model // cfg.n_heads),
            rows=SMALL_HEAD_ROWS, tokens_per_row=SMALL_HEAD_L, blocks=SMALL_HEAD_BLOCKS,
            flash_launches=flash.launches, seconds=sec,
            nll_max_abs_err_vs_cpu=err, tol=tol)


# the verbs phase: BASELINE configs 2, 3 and 5 at their data sizes
# (bench.py:208-230, 320-330, 418-432), and the reference's k-means demo
# (kmeans_demo.py:208-255)
VERB_ROWS, VERB_D, VERB_BLOCKS = 500_000, 64, 4
SEQ_ROWS = 4_096  # the sequential fold: one dependent call per row
MLP_ROWS, MLP_SIZES = 65_536, [784, 256, 128, 10]
LOGREG_STEPS = 20
KMEANS_N, KMEANS_D, KMEANS_K, KMEANS_STEPS = 100_000, 100, 10, 10
AGG_ROWS, AGG_KEYS = 200_000, 1_000
# the pipeline phase (phase_pipeline)
SEG_ROWS, SEG_KEYS, SEG_D = 2_000_000, 1_000, 16
RAGGED_ROWS, RAGGED_MAX = 200_000, 1024
UNEVEN_ROWS, UNEVEN_BLOCKS = 1_000_003, 7
# f32 sums over 125k rows a block in another order than the CPU's (and
# than numpy's f64): relative 1e-4; min, max and integer results exactly
SUM_RTOL = 1e-4
# the MLP's logits: f32 GEMMs (TF32 off) on the card and the CPU
MLP_TOL = 1e-4
# k-means centers (|x| ~ 10): an argmin near-tie between the card's GEMM
# and the CPU's moves a point to another cluster, so centers are compared
# at 1e-3 and assignments only between strategies on one device
KMEANS_TOL = 1e-3


def timed(fn):
    """(result, seconds) of fn() after one warm-up call; fn ends in a host
    readback, so the clock stops after the device's work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_results(name, got, ref, rtol, atol=0.0, keys=None):
    """The largest |got - ref| over ``keys`` (default: every key of ref);
    raises beyond rtol/atol."""
    err = 0.0
    for k in keys or ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        if g.shape != r.shape or not np.allclose(g, r, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{name} {k}: shapes {g.shape}/{r.shape}, max |diff| "
                f"{np.abs(g - r).max() if g.shape == r.shape else None} beyond "
                f"rtol={rtol}, atol={atol}")
        err = max(err, float(np.abs(g - r).max()) if g.size else 0.0)
    return err


def phase_verbs():
    """The four verbs at the BASELINE configs' sizes on the card, each
    against the port's CPU path and numpy, each with Mrows/s."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.models import kmeans, logistic_regression as lr, mlp

    cpu = dict(device="cpu")
    rng = np.random.RandomState(0)
    vals = rng.rand(VERB_ROWS, VERB_D).astype(np.float32)
    frame = tft.TensorFrame.from_arrays({"v": vals}, num_blocks=VERB_BLOCKS)
    exact = {"v": vals.astype(np.float64).sum(0)}
    rows = {}

    def leg(name, n_rows, card, host, ref, rtol, atol=0.0, keys=None, **extra):
        """Run ``card`` (timed) and ``host`` (the port's CPU path), compare
        ``keys`` of both, and of ``card`` against numpy's ``ref``."""
        got, sec = timed(card)
        e_cpu = check_results(f"{name} vs cpu", got, host(), rtol, atol, keys)
        e_np = check_results(f"{name} vs numpy", got, ref, rtol, atol) if ref else None
        rows[name] = dict(rows=n_rows, seconds=sec, mrows_per_s=n_rows / sec / 1e6)
        say("verbs", leg=name, rows=n_rows, seconds=sec, mrows_per_s=n_rows / sec / 1e6,
            max_abs_err_vs_cpu=e_cpu, max_abs_err_vs_numpy=e_np, rtol=rtol, atol=atol,
            **extra)
        return got

    # config 2: reduce_blocks sum and min over a 500k x 64 f32 frame
    for op, ref in (("sum", exact), ("min", {"v": vals.min(0)})):
        fn = (lambda v_input: {"v": v_input.sum(0)}) if op == "sum" else (
            lambda v_input: {"v": v_input.amin(0)})
        leg(f"reduce_blocks_{op}", VERB_ROWS,
            lambda: tft.reduce_blocks(fn, frame),
            lambda: tft.reduce_blocks(fn, frame, **cpu), ref,
            SUM_RTOL if op == "sum" else 0.0)
    pair = lambda v_1, v_2: {"v": v_1 + v_2}  # noqa: E731
    leg("reduce_rows_tree", VERB_ROWS, lambda: tft.reduce_rows(pair, frame),
        lambda: tft.reduce_rows(pair, frame, **cpu), exact, SUM_RTOL)
    small = tft.TensorFrame.from_arrays({"v": vals[:SEQ_ROWS]}, num_blocks=VERB_BLOCKS)
    leg("reduce_rows_sequential", SEQ_ROWS,
        lambda: tft.reduce_rows(pair, small, mode="sequential"),
        lambda: tft.reduce_rows(pair, small, mode="sequential", **cpu),
        {"v": vals[:SEQ_ROWS].astype(np.float64).sum(0)}, SUM_RTOL)

    # config 3's widths: map_rows of a 784-256-128-10 MLP over 65,536 rows
    params = mlp.init(torch.Generator().manual_seed(0), MLP_SIZES, device="cpu")
    feats = rng.rand(MLP_ROWS, MLP_SIZES[0]).astype(np.float32)
    pix = tft.TensorFrame.from_arrays({"pixels": feats}, num_blocks=VERB_BLOCKS)
    h = feats.astype(np.float64)
    for layer in params[:-1]:
        h = np.maximum(h @ layer["w"].double().numpy() + layer["b"].double().numpy(), 0)
    want = h @ params[-1]["w"].double().numpy() + params[-1]["b"].double().numpy()
    row_prog = mlp.scoring_program(params, device="cuda")
    got = leg("map_rows_mlp", MLP_ROWS,
              lambda: tft.map_rows(row_prog, pix, feed_dict={"image": "pixels"}).to_arrays(),
              lambda: tft.map_rows(mlp.scoring_program(params, **cpu), pix,
                                   feed_dict={"image": "pixels"}).to_arrays(),
              {"logits": want}, MLP_TOL, MLP_TOL, keys=("logits",))
    blocks = tft.map_blocks(mlp.block_scoring_program(params, device="cuda"), pix,
                            feed_dict={"image": "pixels"}).to_arrays()
    e_blk = check_results("map_rows_mlp vs map_blocks", got, blocks, MLP_TOL, MLP_TOL,
                          ("logits",))
    if not np.array_equal(got["prediction"], got["logits"].argmax(1)):
        raise AssertionError("map_rows_mlp: prediction is not the argmax of its logits")
    say("verbs", leg="map_rows_mlp", check="vs block_scoring_program through map_blocks",
        max_abs_err=e_blk, tol=MLP_TOL)

    # config 5, eager: logistic-regression gradient steps over 500k x 64
    w_true = rng.randn(VERB_D).astype(np.float32)
    labels = (vals @ w_true > 0).astype(np.float32)
    lframe = tft.TensorFrame.from_arrays({"features": vals, "label": labels},
                                         num_blocks=VERB_BLOCKS)

    def fit(device):
        p, losses = lr.init(VERB_D, device=device), []
        progs = {}
        for i in range(LOGREG_STEPS):
            p, loss = lr.gradient_step(p, lframe, 0.5, device=device, _programs=progs)
            losses.append(loss)
            if i == 0:
                w1 = p["w"].cpu().numpy()
        return {"w": p["w"].cpu().numpy(), "w1": w1, "loss": np.array(losses)}

    # numpy: the first step from w = b = 0, where every logit is exactly 0
    # and the mean loss is log 2.  There the derivatives JAX takes (and the
    # port with it) of max(l, 0) and |l| are 1/2 and 1, so the loss's
    # gradient in l is -y (not sigmoid(0) - y): w1 = lr * X^T y / n
    w1 = 0.5 * (vals.astype(np.float64).T @ labels.astype(np.float64)) / VERB_ROWS
    got, sec = timed(lambda: fit("cuda"))
    host = fit("cpu")
    e_cpu = check_results("logreg vs cpu", got, host, SUM_RTOL, SUM_RTOL)
    e_np = check_results("logreg vs numpy", {"w1": got["w1"], "loss0": got["loss"][:1]},
                         {"w1": w1, "loss0": np.log([2.0])}, SUM_RTOL, SUM_RTOL)
    if not (np.isfinite(got["loss"]).all() and got["loss"][-1] < got["loss"][0]):
        raise AssertionError(f"logreg losses not finite and falling: {got['loss']}")
    n_rows = VERB_ROWS * LOGREG_STEPS
    rows["logreg_gradient_step"] = dict(rows=n_rows, seconds=sec,
                                        mrows_per_s=n_rows / sec / 1e6)
    say("verbs", leg="logreg_gradient_step", rows=n_rows, steps=LOGREG_STEPS,
        seconds=sec, mrows_per_s=n_rows / sec / 1e6, ms_per_step=sec / LOGREG_STEPS * 1e3,
        max_abs_err_vs_cpu=e_cpu, max_abs_err_vs_numpy=e_np, rtol=SUM_RTOL,
        atol=SUM_RTOL, losses=got["loss"].tolist())

    # the reference's k-means demo: 100k x 100, k = 10, 10 Lloyd steps
    kr = np.random.RandomState(1)
    true = kr.randn(KMEANS_K, KMEANS_D) * 10
    pts = (true[kr.randint(0, KMEANS_K, KMEANS_N)]
           + kr.randn(KMEANS_N, KMEANS_D)).astype(np.float32)
    kframe = tft.TensorFrame.from_arrays({"points": pts}, num_blocks=VERB_BLOCKS)
    init = pts[:KMEANS_K].astype(np.float64)
    # numpy's Lloyd steps in f64: argmin of ||c||^2 - 2 x.c, then the means
    # (an empty cluster keeps its center)
    ref = init.copy()
    x64 = pts.astype(np.float64)
    for _ in range(KMEANS_STEPS):
        idx = ((ref * ref).sum(1)[None, :] - 2.0 * x64 @ ref.T).argmin(1)
        onehot = (idx[:, None] == np.arange(KMEANS_K)[None, :]).astype(np.float64)
        counts, sums = onehot.sum(0), onehot.T @ x64
        ref = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1)[:, None], ref)
    centers = {}
    for strategy in ("preagg", "aggregate"):
        def run(device, strategy=strategy):
            c, a = kmeans.fit(kframe, KMEANS_K, KMEANS_STEPS, strategy, device=device,
                              init_centers=init)
            return {"centers": c, "assign": a}

        # rows: points x Lloyd steps
        got = leg(f"kmeans_{strategy}", KMEANS_N * KMEANS_STEPS, lambda: run("cuda"),
                  lambda: run("cpu"), {"centers": ref}, 0.0, KMEANS_TOL,
                  keys=("centers",), steps=KMEANS_STEPS)
        centers[strategy] = got
    e = check_results("kmeans preagg vs aggregate", centers["preagg"],
                      centers["aggregate"], 0.0, KMEANS_TOL, ("centers",))
    if not np.array_equal(centers["preagg"]["assign"], centers["aggregate"]["assign"]):
        raise AssertionError("kmeans: the two strategies assign points differently")
    say("verbs", leg="kmeans", check="preagg vs aggregate on the card", max_abs_err=e,
        tol=KMEANS_TOL)

    # aggregate over keys of more than 8 distinct group sizes: the tree path
    ar = np.random.RandomState(2)
    # skewed group sizes (a Pareto tail) scaled to about AGG_ROWS rows
    sizes = 1 + ar.pareto(1.0, AGG_KEYS)
    sizes = np.maximum(1, np.round(sizes / sizes.sum() * AGG_ROWS)).astype(np.int64)
    keys = np.repeat(np.arange(AGG_KEYS), sizes)
    keys = keys[ar.permutation(len(keys))]
    avals = ar.rand(len(keys), VERB_D).astype(np.float32)
    aframe = tft.TensorFrame.from_arrays({"k": keys, "v": avals}, num_blocks=VERB_BLOCKS)
    distinct_sizes = len(np.unique(np.bincount(keys)))
    if distinct_sizes <= 8:
        raise AssertionError(f"aggregate leg: only {distinct_sizes} distinct group sizes")
    order = np.argsort(keys, kind="stable")
    starts = np.r_[0, np.nonzero(np.diff(keys[order]))[0] + 1]
    present = keys[order][starts]
    ref = np.add.reduceat(avals[order].astype(np.float64), starts)
    agg = lambda v_input: {"v": v_input.sum(0)}  # noqa: E731
    # the general path (a sum is a segment plan, which would run instead)
    leg("aggregate_tree", len(keys),
        lambda: general_aggregate(agg, aframe.group_by("k")).to_arrays(),
        lambda: general_aggregate(agg, aframe.group_by("k"), "cpu").to_arrays(),
        {"k": present, "v": ref}, SUM_RTOL, SUM_RTOL,
        groups=len(present), distinct_sizes=distinct_sizes)
    verbs_dispatch_stack(frame, pix, row_prog, fit)
    return rows


# --- decode: bench config 8 (bench.py:3285-3330) -------------------------------
DECODE_MODEL = dict(vocab_size=8192, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
                    d_ff=4096, max_seq=2048)
DECODE_PROMPT, DECODE_NEW, DECODE_BATCHES = 32, 256, (1, 8)
# timed runs after one warm-up; the best is reported (3 until the
# train-axes phase came: cut to 1 to keep the script's run time)
DECODE_RUNS = 1
# the cached path against one full forward (tfm.apply, no cache) over the
# final sequence.  In f32 (the same weights, TF32 off) the logits at every
# position agree to summation order: atol = rtol = 1e-4.  In bf16 each
# projection's output is rounded to bf16 after products of another shape
# (one row a step, where cuBLAS runs gemv kernels, against 288 rows at
# once), which moves single logits by up to 5.27e-2 on an H100 (median
# 7.1e-3), beyond a 3e-2 per-logit bound; the bf16 check is the slice's:
# the mean next-token NLL of the generated tokens within NLL_TOL (3e-2)
# of the full forward's
DECODE_F32_TOL = 1e-4
# a generated token must be the full forward's argmax wherever that
# forward's top-2 gap exceeds this
DECODE_GAP = 6e-2
FULL_CONTEXT = dict(B=8, prompt=1792, new=256)  # the cache holds max_seq 2048
PAGE_TOKENS = 16
# tests/test_quant.py's bound on the largest logit difference of the int8
# model from the float one
INT8_LOGIT_BOUND = 0.5
SPEC = dict(gamma=4, new=64, draft_layers=2)
DECODE_SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                    d_ff=128, max_seq=64)


def best_of(fn, runs=DECODE_RUNS):
    """(result, best seconds, peak bytes) of ``fn`` over ``runs`` calls after
    one warm-up call; each call is synchronized before its clock stops."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best, out = float("inf"), None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return out, best, torch.cuda.max_memory_allocated()


def cached_logits(params, cfg, seq):
    """The cached path's logits at every position of ``seq`` [B, L]: the
    prompt's prefill, then one token a step, as ``generate`` runs them."""
    from tensorframes_tpu_torch.models import decode

    p = decode.cast_params(params, cfg.dtype)
    cache = decode.init_cache(cfg, seq.shape[0], seq.shape[1])
    logits, cache = decode.apply_cached(p, seq[:, :DECODE_PROMPT], cache, cfg)
    out = [logits]
    for t in range(DECODE_PROMPT, seq.shape[1]):
        logits, cache = decode.apply_cached(p, seq[:, t : t + 1], cache, cfg)
        out.append(logits)
    return torch.cat(out, dim=1)


def decode_vs_full(params, cfg, out):
    """Leg (a)'s check at B = 1 against one full forward (``tfm.apply``, no
    cache) over the final sequence: the cached path's logits at every
    position in f32 (DECODE_F32_TOL), the generated tokens' mean NLL in
    bf16 (NLL_TOL), and each generated token against the bf16 forward's
    argmax where its top-2 gap exceeds DECODE_GAP (the positions under it
    are counted).  Everything is printed before any check raises."""
    from tensorframes_tpu_torch.models import transformer as tfm

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        full = tfm.apply(params, out, cfg)
        full32 = tfm.apply(params, out, cfg32)
    cached, cached32 = cached_logits(params, cfg, out), cached_logits(params, cfg32, out)
    diff = (cached - full).abs()
    # next-token NLL of the generated tokens, from positions P-1 .. L-2
    tgt = out[0, DECODE_PROMPT:].long()

    def nll(logits):
        lp = torch.log_softmax(logits[0, DECODE_PROMPT - 1 : -1].float(), -1)
        return -lp.gather(-1, tgt[:, None])[:, 0]

    nll_c, nll_f = nll(cached), nll(full)
    ref = full[0, DECODE_PROMPT - 1 : -1]
    top2 = torch.topk(ref, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    want = ref.argmax(-1)
    clear = gap > DECODE_GAP
    wrong = int((tgt != want)[clear].sum())
    rec = dict(
        bf16_logit_max_abs_diff=float(diff.max()),
        bf16_logit_diff_quantiles={q: float(diff.flatten().quantile(q))
                                   for q in (0.5, 0.99, 0.9999)},
        nll_mean_cached=float(nll_c.mean()), nll_mean_full=float(nll_f.mean()),
        nll_mean_abs_diff=float((nll_c.mean() - nll_f.mean()).abs()), nll_tol=NLL_TOL,
        nll_position_max_abs_diff=float((nll_c - nll_f).abs().max()),
        f32_logit_max_abs_diff=float((cached32 - full32).abs().max()),
        f32_least_tol=least_tol(cached32, full32), f32_tol=DECODE_F32_TOL,
        gap=DECODE_GAP, positions=int(gap.numel()), positions_under_gap=int((~clear).sum()),
        tokens_differing_over_gap=wrong,
        tokens_differing_under_gap=int((tgt != want)[~clear].sum()))
    say("decode", check="cached vs full forward, B=1", **rec)
    check_close("decode f32 cached vs full logits", cached32, full32, DECODE_F32_TOL)
    if not rec["nll_mean_abs_diff"] <= NLL_TOL:
        raise AssertionError(f"decode: mean NLL cached vs full differs by "
                             f"{rec['nll_mean_abs_diff']} > {NLL_TOL}")
    if wrong:
        raise AssertionError(f"decode: {wrong} tokens differ from the full forward's argmax "
                             f"where its top-2 gap exceeds {DECODE_GAP}")
    return rec


def phase_decode(profile=False):
    """Bench config 8 on the card: greedy ``generate`` (a), the full-context
    leg (b), paged against contiguous (c), int8 (d), speculative in f32 (e),
    and a small f32 model's tokens against the CPU path.  The decode path
    launches no hand-written kernel (the JAX package's runs no Pallas
    kernel: ``_cache_attention`` is einsums); the flash counters must read
    0 after it."""
    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch.models import decode, kv_pager, quant
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.ops import frame_cache
    from tensorframes_tpu_torch.parallel import flash

    cfg = tfm.TransformerConfig(**DECODE_MODEL, dtype=torch.bfloat16)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.RandomState(8)

    def tokens(B, L):
        return torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L)).astype(np.int32)).cuda()

    flash.reset_launches()
    records = {}

    # (a) config 8 as JAX runs it: 32-token prompts, 256 new tokens
    for B in DECODE_BATCHES:
        prompt = tokens(B, DECODE_PROMPT)
        out, sec, peak = best_of(lambda: decode.generate(params, prompt, cfg, DECODE_NEW))
        if out.shape != (B, DECODE_PROMPT + DECODE_NEW) or not torch.equal(
                out[:, :DECODE_PROMPT], prompt):
            raise AssertionError(f"decode B={B}: output {tuple(out.shape)}")
        rec = dict(B=B, prompt=DECODE_PROMPT, new=DECODE_NEW, seconds=sec,
                   tokens_per_s=B * DECODE_NEW / sec, ms_per_token=sec / DECODE_NEW * 1e3,
                   peak_bytes=peak)
        if B == 1:
            rec["check"] = decode_vs_full(params, cfg, out)
        records[f"a_B{B}"] = rec
        say("decode", leg="a", **rec)
    prompt8 = prompt

    # (b) full context: 1792-token prompts and 256 new, the cache at max_seq
    fc = FULL_CONTEXT
    cap = fc["prompt"] + fc["new"]
    long_prompt = tokens(fc["B"], fc["prompt"])
    cast = decode.cast_params(params, cfg.dtype)

    def prefill():
        cache = decode.init_cache(cfg, fc["B"], cap)
        return decode.apply_cached(cast, long_prompt, cache, cfg)[0][:, -1].argmax(-1)

    _, pre_sec, _ = best_of(prefill)
    contiguous, sec, peak = best_of(
        lambda: decode.generate(params, long_prompt, cfg, fc["new"], cache_len=cap))
    rec = dict(B=fc["B"], prompt=fc["prompt"], new=fc["new"], cache=cap, seconds=sec,
               prefill_ms=pre_sec * 1e3,
               decode_ms_per_token=(sec - pre_sec) / (fc["new"] - 1) * 1e3,
               tokens_per_s=fc["B"] * fc["new"] / sec, peak_bytes=peak)
    records["b"] = rec
    say("decode", leg="b", **rec)

    # (c) the same prompts through the page pool: the contiguous tokens bit
    # for bit at the same B and capacity
    max_pages = cap // PAGE_TOKENS
    torch.cuda.reset_peak_memory_stats()
    c0, base = obs.counters(), frame_cache.budget_bytes_resident()
    pool = kv_pager.PagePool(cfg, n_pages=fc["B"] * max_pages + 1, tokens_per_page=PAGE_TOKENS)
    tables = kv_pager.init_tables(fc["B"], max_pages)
    charges = []
    for b in range(fc["B"]):
        charge, pages = pool.allocate(kv_pager.pages_for(cap, PAGE_TOKENS), tenant=f"row{b}")
        charges.append(charge)
        tables[b] = torch.tensor(pages, dtype=torch.int32)
    resident = frame_cache.budget_bytes_resident() - base
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kp, vp = pool.k_pages, pool.v_pages
    last = torch.full((fc["B"],), fc["prompt"] - 1, dtype=torch.int32, device="cuda")
    tok, kp, vp = kv_pager.paged_prefill(cast, long_prompt, tables, last, kp, vp, cfg)
    toks = [tok]
    idx = torch.full((fc["B"],), fc["prompt"], dtype=torch.int32, device="cuda")
    for _ in range(fc["new"] - 1):
        tok, kp, vp = kv_pager.paged_decode_step(cast, tok, tables, idx, kp, vp, cfg)
        idx = idx + 1
        toks.append(tok)
    paged = torch.stack(toks, dim=1)
    torch.cuda.synchronize()
    paged_sec = time.perf_counter() - t0
    if not torch.equal(paged, contiguous[:, fc["prompt"]:]):
        n = int((paged != contiguous[:, fc["prompt"]:]).sum())
        raise AssertionError(f"paged decode differs from contiguous in {n} tokens")
    used = pool.stats()["pages_used"]
    for c in charges:
        pool.free(c)
    # a small budget refuses the pool's pages as PagesExhausted; free restores
    budget = 100 * pool.page_bytes
    prev = os.environ.get("TFS_HBM_BUDGET")
    os.environ["TFS_HBM_BUDGET"] = str(budget)
    try:
        held, _ = pool.allocate(64, tenant="small")
        try:
            pool.allocate(64, tenant="small")
            raise AssertionError("a pool past TFS_HBM_BUDGET did not raise PagesExhausted")
        except kv_pager.PagesExhausted as e:
            refusal = dict(reason=e.reason, needed=e.needed, free=e.free,
                           retry_after_ms=e.retry_after_ms)
            if e.reason != "budget":
                raise AssertionError(f"PagesExhausted reason {e.reason}, expected budget")
        pool.free(held)
    finally:
        if prev is None:
            os.environ.pop("TFS_HBM_BUDGET")
        else:
            os.environ["TFS_HBM_BUDGET"] = prev
    d = obs.counters_delta(c0)
    if pool.used_count() or frame_cache.budget_bytes_resident() != base or (
            d["kv_pages_allocated"] != d["kv_pages_freed"]):
        raise AssertionError(f"free did not restore the pool: {pool.stats()}, {d}")
    rec = dict(B=fc["B"], cache=cap, page_tokens=PAGE_TOKENS, pages_used=used,
               budget_bytes_resident=resident, page_bytes=pool.page_bytes,
               seconds=paged_sec, tokens_per_s=fc["B"] * fc["new"] / paged_sec,
               peak_bytes=torch.cuda.max_memory_allocated(), bit_identical=True,
               small_budget_bytes=budget, refusal=refusal,
               kv_pages_allocated=d["kv_pages_allocated"], kv_pages_freed=d["kv_pages_freed"])
    records["c"] = rec
    say("decode", leg="c", **rec)
    del pool, kp, vp

    # (d) int8 weights at B = 8, leg (a)'s shape
    qp = quant.quantize_params(params)
    out, sec, peak = best_of(lambda: decode.generate(qp, prompt8, cfg, DECODE_NEW))
    with torch.no_grad():
        lq = decode.apply_cached(decode.cast_params(qp, cfg.dtype), prompt8,
                                 decode.init_cache(cfg, 8, DECODE_PROMPT), cfg)[0]
        lf = decode.apply_cached(cast, prompt8, decode.init_cache(cfg, 8, DECODE_PROMPT),
                                 cfg)[0]
    diff = float((lq - lf).abs().max())
    if not (out.shape == (8, DECODE_PROMPT + DECODE_NEW) and diff < INT8_LOGIT_BOUND):
        raise AssertionError(f"int8: output {tuple(out.shape)}, prefill logits differ "
                             f"from bf16 by {diff} (bound {INT8_LOGIT_BOUND})")
    rec = dict(B=8, new=DECODE_NEW, param_bytes=quant.param_bytes(qp),
               bf16_param_bytes=quant.param_bytes(cast), seconds=sec,
               tokens_per_s=8 * DECODE_NEW / sec, ms_per_token=sec / DECODE_NEW * 1e3,
               bf16_tokens_per_s=records["a_B8"]["tokens_per_s"], peak_bytes=peak,
               prefill_logit_max_abs_diff_vs_bf16=diff, bound=INT8_LOGIT_BOUND)
    records["d"] = rec
    say("decode", leg="d", **rec)
    del qp

    # (e) speculative, in f32 with TF32 off (device.resolve_device sets it)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    prompt1 = prompt8[:1]
    ref, ref_sec, _ = best_of(lambda: decode.generate(params, prompt1, cfg32, SPEC["new"]))
    draft_cfg = dataclasses.replace(cfg32, n_layers=SPEC["draft_layers"])
    # the draft: the target's first layers, its embedding and head
    draft = dict(params, blocks={k: v[: SPEC["draft_layers"]]
                                 for k, v in params["blocks"].items()})
    for name, dp, dcfg in (("self_draft", params, cfg32),
                           ("two_layer_draft", draft, draft_cfg)):
        (out, stats), sec, peak = best_of(lambda: decode.speculative_generate(
            dp, dcfg, params, cfg32, prompt1, SPEC["new"], gamma=SPEC["gamma"],
            return_stats=True))
        if not torch.equal(out, ref.to(out.dtype)):
            raise AssertionError(f"speculative ({name}) differs from target-greedy generate")
        rate = stats["accepted"] / max(1, stats["drafted"])
        if name == "self_draft" and rate != 1.0:
            raise AssertionError(f"self-draft accepted {stats}")
        rec = dict(draft=name, gamma=SPEC["gamma"], new=SPEC["new"], acceptance=rate,
                   **stats, seconds=sec, tokens_per_s=SPEC["new"] / sec,
                   greedy_tokens_per_s=SPEC["new"] / ref_sec, peak_bytes=peak,
                   equals_greedy=True)
        records[f"e_{name}"] = rec
        say("decode", leg="e", **rec)

    # a small f32 model's greedy tokens on the card against the CPU path
    small = tfm.TransformerConfig(**DECODE_SMALL, dtype=torch.float32)
    sp = tfm.init(torch.Generator().manual_seed(3), small, device="cpu")
    sprompt = np.random.RandomState(3).randint(0, small.vocab_size, (2, 7)).astype(np.int32)
    cpu_out = decode.generate(sp, sprompt, small, 12)
    on_card = dict(sp, blocks={k: v.cuda() for k, v in sp["blocks"].items()},
                   **{k: sp[k].cuda() for k in ("embed", "ln_f", "lm_head")})
    gpu_out = decode.generate(on_card, sprompt, small, 12)
    if not torch.equal(gpu_out.cpu(), cpu_out):
        raise AssertionError("small decode: the card's tokens differ from the CPU's")
    say("decode", check="small f32 model, greedy tokens card vs cpu", equal=True)

    if flash.launches:
        raise AssertionError(f"the decode path launched {flash.launches} flash kernels")
    if profile:
        for label, seq in (("a", prompt8), ("b", long_prompt)):
            cache = decode.init_cache(cfg, 8, seq.shape[1] + 1)
            _, cache = decode.apply_cached(cast, seq, cache, cfg)

            def step(cache=cache, tok=seq[:, -1:]):
                decode.apply_cached(cast, tok, dict(cache), cfg)[0].argmax(-1).cpu()

            step()
            profile_kernels(f"decode leg ({label}) one step at B=8", step)
    return records


def phase_cached_verbs():
    """``frame.cache()`` on the verbs phase (f): config 2's reduce_blocks sum
    over 500,000 x 64 and the k-means demo (preagg, 100,000 x 100, 10 steps;
    the reference's demo caches its DataFrame before iterating), cached
    against uncached: bit-identical results, no host bytes staged while
    cached, Mrows/s both ways."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch.models import kmeans

    vals = np.random.RandomState(0).rand(VERB_ROWS, VERB_D).astype(np.float32)
    kr = np.random.RandomState(1)
    true = kr.randn(KMEANS_K, KMEANS_D) * 10
    pts = (true[kr.randint(0, KMEANS_K, KMEANS_N)]
           + kr.randn(KMEANS_N, KMEANS_D)).astype(np.float32)
    init = pts[:KMEANS_K].astype(np.float64)
    legs = {
        "reduce_blocks_sum": (
            tft.TensorFrame.from_arrays({"v": vals}, num_blocks=VERB_BLOCKS), VERB_ROWS,
            lambda f: tft.reduce_blocks(lambda v_input: {"v": v_input.sum(0)}, f)),
        "kmeans_preagg": (
            tft.TensorFrame.from_arrays({"points": pts}, num_blocks=VERB_BLOCKS),
            KMEANS_N * KMEANS_STEPS,
            lambda f: {"centers": kmeans.fit(f, KMEANS_K, KMEANS_STEPS, "preagg",
                                             init_centers=init)[0]}),
    }
    rows = {}
    for name, (fr, n_rows, run) in legs.items():
        before = obs.counters()
        cached = fr.cache()
        cache_bytes = obs.counters_delta(before)["h2d_bytes_staged"]
        plain, sec = timed(lambda: run(fr))
        before = obs.counters()
        got, csec = timed(lambda: run(cached))
        staged = obs.counters_delta(before)["h2d_bytes_staged"]
        for k in plain:
            if not np.array_equal(np.asarray(got[k]), np.asarray(plain[k])):
                raise AssertionError(f"cached {name} {k} differs from uncached")
        if staged:
            raise AssertionError(f"cached {name} staged {staged} host bytes")
        rows[name] = dict(uncached=n_rows / sec / 1e6, cached=n_rows / csec / 1e6)
        say("cached_verbs", leg=name, rows=n_rows, uncached_mrows_per_s=n_rows / sec / 1e6,
            cached_mrows_per_s=n_rows / csec / 1e6, speedup=sec / csec,
            cache_build_bytes=cache_bytes, h2d_bytes_while_cached=staged,
            bit_identical=True)
    return rows


def clone_params(tree):
    return {
        k: clone_params(v) if isinstance(v, dict) else v.detach().clone()
        for k, v in tree.items()
    }


def flash_vs_full_step(tag, cfg, tc, start_params, toks):
    """One step of ``cfg`` on the batch ``toks`` from ``start_params``, with
    attn_impl "flash" against "full": the loss and the gradient norm must
    agree (``FULL_TOL`` of the model's dtype), the flash step's gradient
    having launched the forward, dQ and dK/dV instantiations ``route_of``
    names and the full one none; ms per step of each over three steps, and
    their peak memory."""
    from tensorframes_tpu_torch import train
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    width = flash.kernel_head_dim(cfg.d_model // cfg.n_heads)

    batch = torch.from_numpy(toks).cuda()
    inp, tgt = batch[:, :-1], batch[:, 1:]
    ref = {}
    for impl in ("flash", "full"):
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        p = clone_params(start_params)
        leaves = [t.requires_grad_() for _, t in train.param_leaves(p)]
        flash.reset_launches()
        loss = tfm.loss_fn(p, inp, tgt, icfg)
        grads = torch.autograd.grad(loss, leaves)
        norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        launched = sorted(flash.kernel_launches)
        want = sorted(route_of(k, cfg.dtype, width) for k in
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) if impl == "flash" else []
        if launched != want:
            raise AssertionError(f"{tag}: B={len(toks)} {impl} step launched {launched}, "
                                 f"expected {want}")
        del grads
        step, tx = train.make_train_step(icfg, tc)
        state = tx.init(p)
        step(p, state, inp, tgt)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            _, _, last = step(p, state, inp, tgt)
        float(last)
        ms = (time.perf_counter() - t0) / 3 * 1e3
        ref[impl] = dict(loss=float(loss.detach()), grad_norm=norm, ms_per_step=ms,
                         peak_bytes=train.hbm_high_water(), launched=launched)
        del p, state, leaves
    d_loss = abs(ref["flash"]["loss"] - ref["full"]["loss"])
    d_norm = abs(ref["flash"]["grad_norm"] / ref["full"]["grad_norm"] - 1)
    loss_tol, norm_rtol = FULL_TOL[cfg.dtype]
    if not (d_loss <= loss_tol and d_norm <= norm_rtol):
        raise AssertionError(f"{tag}: B={len(toks)} flash vs full: loss diff {d_loss}, "
                             f"grad norm rel {d_norm}")
    say(tag, check=f"B={len(toks)} step, flash vs full", batch=len(toks), **{
        f"{impl}_{k}": v for impl, r in ref.items() for k, v in r.items()
    }, loss_abs_diff=d_loss, loss_tol=loss_tol, grad_norm_rel_diff=d_norm,
        grad_norm_rtol=norm_rtol)


def phase_train():
    """The flagship train step fed from a FrameLoader through train.fit."""
    from tensorframes_tpu_torch import TensorFrame, data, train
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    cfg = tfm.TransformerConfig(**TRAIN_MODEL)
    tc = train.TrainConfig(learning_rate=3e-4)
    steps = TRAIN_ROWS // TRAIN_B  # one epoch
    rng = np.random.RandomState(0)
    start = rng.randint(0, cfg.vocab_size, (TRAIN_ROWS, 1))
    toks = ((start + np.arange(TRAIN_L + 1)) % cfg.vocab_size).astype(np.int32)
    frame = TensorFrame.from_arrays({"tokens": toks}, num_blocks=8)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = train.n_params(params)

    def loader():
        return data.FrameLoader(frame, batch_size=TRAIN_B, shuffle=True, seed=0)

    def run(model_cfg, n, p):
        """fit over n steps, counted alone: (losses, seconds, launches, peak)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()
        t0 = time.perf_counter()
        _, _, losses = train.fit(loader(), model_cfg, tc, steps=n, params=p)
        sec = time.perf_counter() - t0  # fit's losses are read: synced
        launches = {"flash_fwd": flash.launches, "flash_bwd_dq": flash.launches_dq,
                    "flash_bwd_dkv": flash.launches_dkv}
        return losses, sec, launches, train.hbm_high_water()

    def expect(launches, fwd, bwd, what):
        want = {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd}
        if launches != want:
            raise AssertionError(f"{what}: kernel launches {launches}, expected {want}")

    run(cfg, 1, params)  # warm-up step
    start_params = clone_params(params)
    losses, sec, launches, peak = run(cfg, steps, params)
    by_instantiation = dict(flash.kernel_launches)
    # "selective" recomputes each block's forward in the backward (saving
    # only JAX's tagged tensors), so the forward kernel runs twice a step
    expect(launches, 2 * cfg.n_layers * steps, cfg.n_layers * steps, "train")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train losses not finite and falling: {losses}")
    tokens = steps * TRAIN_B * TRAIN_L
    flops_per_token = train.counted_flops_per_token(n_params, cfg, TRAIN_L)
    say("train", attn_impl="flash", remat=cfg.remat_policy, steps=steps, batch=TRAIN_B,
        seq=TRAIN_L, n_params=n_params, seconds=sec,
        ms_per_step=sec / steps * 1e3, tokens_per_s=tokens / sec,
        counted_tflops_per_s=flops_per_token * tokens / sec / 1e12,
        peak_bytes=peak, launches=launches, losses=losses)

    # the other policies: two steps each from the same params and batches,
    # first loss held to "none"'s
    legs = {}
    for policy, fwd_per_step in (("none", 1), ("full", 2), ("dots", 2)):
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        p_losses, p_sec, p_launches, p_peak = run(pcfg, 2, clone_params(start_params))
        expect(p_launches, 2 * fwd_per_step * cfg.n_layers, 2 * cfg.n_layers, f"remat {policy}")
        legs[policy] = dict(first_loss=p_losses[0], ms_per_step=p_sec / 2 * 1e3,
                            peak_bytes=p_peak, launches=p_launches, losses=p_losses)
    for policy, first in (("selective", losses[0]), ("full", legs["full"]["first_loss"]),
                          ("dots", legs["dots"]["first_loss"])):
        diff = abs(first - legs["none"]["first_loss"])
        if not diff <= REMAT_LOSS_TOL:
            raise AssertionError(f"remat {policy} first loss off by {diff} from none's")
    for policy, leg in legs.items():
        say("train", remat=policy, steps=2, **leg, selective_ms_per_step=sec / steps * 1e3,
            selective_peak_bytes=peak,
            first_loss_abs_diff_vs_none=abs(leg["first_loss"] - legs["none"]["first_loss"]),
            tol=REMAT_LOSS_TOL)

    # one step at B=2: flash against full attention
    flash_vs_full_step("train", cfg, tc, start_params, toks[:2])

    # a small f32 model trained three steps on the card and on the CPU
    small = tfm.TransformerConfig(
        vocab_size=64, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
        d_ff=256, max_seq=64, dtype=torch.float32, attn_impl="flash",
    )
    stc = train.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                            schedule="cosine", total_steps=10, grad_clip=0.5)
    cpu_p = tfm.init(torch.Generator().manual_seed(1), small, device="cpu")
    trained = {}
    for dev in ("cuda", "cpu"):
        p = clone_params(cpu_p)
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in p.items()}
        step, tx = train.make_train_step(small, stc)
        state = tx.init(p)
        for i in range(3):
            b = np.random.RandomState(10 + i).randint(0, 64, (4, 41)).astype(np.int32)
            b = torch.from_numpy(b).to(dev)
            step(p, state, b[:, :-1], b[:, 1:])
        trained[dev] = dict(train.param_leaves(p))
    err = max(
        check_close(f"small train {k}", v.detach().cpu(), trained["cpu"][k].detach(),
                    SMALL_TRAIN_TOL)
        for k, v in trained["cuda"].items()
    )
    say("train", check="small f32 model, 3 steps, cuda vs cpu params "
        f"(atol=rtol={SMALL_TRAIN_TOL:g})", max_abs_err=err)
    return launches, cfg, tc, start_params, loader, by_instantiation


# the training axes (phase_train_axes): the train phase's config and rows
AXES_B = 8  # one flagship batch of 8 rows of 2048 tokens
AXES_PIPES = ((2, 4), (4, 8))  # (pp stages, microbatches) of (a) and (b)
AXES_TIMED_STEPS = 2  # timed train steps a schedule and mesh, after a warm-up
AXES_MEM_M = (2, 8)  # microbatch counts of the memory runs, one row each
AXES_RING_L, AXES_RING_B, AXES_RING_SP = 4096, 2, 2  # (c), 2 microbatches
AXES_FIT_STEPS = 4
AXES_CHILD_LAYERS, AXES_CHILD_STEPS = 2, 2  # (f): a 2-layer cut, two steps
AXES_CHILD_TIMEOUT_S = 240
AXES_CHILD_CODE = "import sys, chip_smoke; chip_smoke.train_axes_child(*sys.argv[1:])"
# a pipeline cuts the batch into microbatches: the same products at fewer
# rows.  Allowed at first REMAT_LOSS_TOL on the loss and FULL_GRAD_NORM_RTOL
# on the gradient norm (cuBLAS may pick other kernels for fewer rows); the
# card gave 0-9.5e-7 and 1.1e-5-4.3e-5 relative over GPipe and 1F1B at
# both meshes, the ring pipeline 0 (an H100 at 700 W), so the
# limits are 1e-4 and 1e-3.  The MoE pipeline's aux is JAX's per-microbatch
# estimator, so its loss is held to the unpipelined loss_fn averaged over
# the same microbatches (equal valid counts: the CE is the batch's), at
# AXES_LOSS_TOL too (the card gave 0); its gap to the full-batch loss is
# printed.  Two processes (f) update the weights from gradients summed in
# another order: their second loss is held at bf16's first-loss limit
AXES_LOSS_TOL, AXES_GRAD_RTOL = 1e-4, 1e-3
# (g): pp and tp across gloo processes sharing card 0 (NCCL refuses two ranks
# on one card), each rank holding its shard; (name, axes, schedule,
# microbatches, layers, rows) by launch size: (g1)-(g3) the flagship train
# config at B = 8, (g4) a 2-layer cut at B = 2, for time only
AXES_RANK_CASES = {
    2: (("g1", {"pp": 2}, "gpipe", 4, TRAIN_MODEL["n_layers"], AXES_B),
        ("g2", {"pp": 2}, "1f1b", 4, TRAIN_MODEL["n_layers"], AXES_B),
        ("g3", {"tp": 2}, "gpipe", 1, TRAIN_MODEL["n_layers"], AXES_B)),
    4: (("g4", {"pp": 2, "tp": 2}, "gpipe", 2, 2, 2),),
}
# a pipeline across ranks computes the one-process step's products on the
# same rows (pp hands whole activations on): held as (a)/(b) are, loss
# 1e-4 absolute and gradient norm 1e-3 relative.  Under tp the row-split
# products are partial sums added in f32 and rounded to bf16 once, where
# one process rounds one product: another bf16 rounding of every attention
# and MLP output, so loss 5e-3 and gradient norm 2e-2 relative (the flash
# against "full" limits of one bf16 step)
AXES_RANK_TOL = {"g1": (AXES_LOSS_TOL, AXES_GRAD_RTOL, "abs"),
                 "g2": (AXES_LOSS_TOL, AXES_GRAD_RTOL, "abs"),
                 "g3": (5e-3, 2e-2, "rel"), "g4": (5e-3, 2e-2, "rel")}
AXES_RANK_TIMEOUT_S = 600
AXES_RANK_CODE = "import sys, chip_smoke; chip_smoke.rank_axes_child(*sys.argv[1:])"
# the same across four cards, one NCCL rank a card (``tools/mesh_multicard.py``
# part 4): the flagship train config at B = 8, no cut
AXES_CARD_CASES = (("pp4_gpipe", {"pp": 4}, "gpipe", 8, TRAIN_MODEL["n_layers"], AXES_B),
                   ("pp4_1f1b", {"pp": 4}, "1f1b", 8, TRAIN_MODEL["n_layers"], AXES_B),
                   ("tp4", {"tp": 4}, "gpipe", 1, TRAIN_MODEL["n_layers"], AXES_B),
                   ("pp2_tp2", {"pp": 2, "tp": 2}, "gpipe", 4, TRAIN_MODEL["n_layers"], AXES_B))


def axes_rows(n_rows):
    """The train phase's token rows (its first draw), ``n_rows`` of them."""
    rng = np.random.RandomState(0)
    start = rng.randint(0, TRAIN_MODEL["vocab_size"], (TRAIN_ROWS, 1))
    toks = (start + np.arange(TRAIN_L + 1)) % TRAIN_MODEL["vocab_size"]
    return toks.astype(np.int32)[:n_rows]


def train_axes_child(rank, world, port) -> None:
    """Leg (f)'s child: rank ``rank`` of a ``world``-process ``gloo`` group
    on card 0 (``gloo`` moves the CUDA gradients through the host), a
    ``dp=world`` training mesh, the 2-layer cut of the flagship from the
    train phase's seed; a mesh-sharded ``FrameLoader`` hands it its rows
    of each batch, and it trains ``AXES_CHILD_STEPS`` steps.  Prints one
    JSON line: the global losses, its rows, the seconds, the host detours,
    or the error it met."""
    import datetime

    from tensorframes_tpu_torch import TensorFrame, data, train
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash, multihost
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh

    rank, world = int(rank), int(world)
    res = {"rank": rank}
    t0 = time.perf_counter()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                             timeout=datetime.timedelta(seconds=120))
        res["init_s"] = time.perf_counter() - t0
        cfg = tfm.TransformerConfig(**dict(TRAIN_MODEL, n_layers=AXES_CHILD_LAYERS))
        params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
        mesh = training_mesh(dp=world)
        frame = TensorFrame.from_arrays({"tokens": axes_rows(AXES_B * AXES_CHILD_STEPS)})
        loader = data.FrameLoader(frame, batch_size=AXES_B, mesh=mesh, spec=("dp", None))
        losses, rows = [], []
        with set_mesh(mesh):
            step, tx = train.make_train_step(cfg, train.TrainConfig(learning_rate=3e-4))
            state = tx.init(params)
            flash.reset_launches()
            t1 = time.perf_counter()
            for batch in loader:
                rows.append(int(batch["tokens"].shape[0]))
                losses.append(float(step(params, state, *data.lm_split(batch))[2]))
        res.update(losses=losses, rows=rows, steps_s=time.perf_counter() - t1,
                   crosses=[a for a in mesh.axis_names if mesh.crosses(a)],
                   launches=dict(flash.kernel_launches), host_detours=multihost.host_detours)
    except Exception as e:  # noqa: BLE001 - printed for the parent
        res.update(error=f"{type(e).__name__}: {e}"[:600], wall_s=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)
        os._exit(3)
    res["wall_s"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    multihost.shutdown()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rank_mesh(axes, world, rank):
    """The training mesh ``axes`` as rank ``rank`` of ``world`` holds it,
    built without a process group (for the shard a rank should hold)."""
    from tensorframes_tpu_torch.parallel import mesh as tmesh

    sizes = {a: axes.get(a, 1) for a in tmesh.AXES}
    n = int(np.prod(list(sizes.values())))
    holders = tmesh._layout(sizes, 1, "dp") // (n // world)
    return tmesh.Mesh(tmesh.AXES, tuple(sizes.values()), torch.device("cuda"), world=world,
                      rank=rank, holders=tuple(int(h) for h in holders.ravel()))


def rank_axes_child(rank, world, port, table="ranks") -> None:
    """Leg (g)'s child: rank ``rank`` of a ``world``-process ``gloo`` group
    on card 0 (``table`` "cards": of an NCCL group, one rank a card, for
    ``AXES_CARD_CASES``).  For each of ``AXES_RANK_CASES[world]`` it builds the
    training mesh (``pp``/``tp`` crossing the ranks), cuts its shard of the
    train phase's seeded weights (``shard_params``), runs a warm-up step
    (its loss and global gradient norm are those of the starting weights)
    and ``AXES_TIMED_STEPS`` timed steps.  Prints one JSON line a case: ms a
    step, the host's enqueue share, payload bytes a step by kind, host
    detours, peak device memory, its param and Adam bytes, flash launches
    by instantiation; or the error it met."""
    import datetime

    from tensorframes_tpu_torch import train
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import collectives, flash, multihost
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh

    rank, world = int(rank), int(world)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cards = table == "cards"
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="nccl" if cards else "gloo",
                         timeout=datetime.timedelta(seconds=300))
    # whether this torch's gloo sums bf16 (the tp sums travel in f32 anyway)
    try:
        probe = torch.ones(4, dtype=torch.bfloat16, device="cuda" if cards else "cpu")
        torch.distributed.all_reduce(probe)
        gloo_bf16 = bool((probe == world).all())
    except RuntimeError as e:
        gloo_bf16 = f"{type(e).__name__}: {e}"[:200]
    # whether this torch runs a bf16 product with an f32 result, forward and
    # backward (the row-split partials take exact products in f32 without it)
    try:
        a = torch.ones(16, 16, dtype=torch.bfloat16, device="cuda", requires_grad=True)
        torch.mm(a, a.detach(), out_dtype=torch.float32).sum().backward()
        mm_out_dtype = True
    except (RuntimeError, TypeError, NotImplementedError) as e:
        mm_out_dtype = f"{type(e).__name__}: {e}"[:200]
    for name, axes, sched, M, layers, B in (AXES_CARD_CASES if cards else AXES_RANK_CASES[world]):
        res = {"rank": rank, "case": name, "init_s": time.perf_counter() - t0,
               "gloo_bf16_all_reduce": gloo_bf16, "mm_out_dtype": mm_out_dtype}
        try:
            cfg = tfm.TransformerConfig(**dict(TRAIN_MODEL, n_layers=layers))
            tc = train.TrainConfig(learning_rate=3e-4, pp_stages=axes.get("pp", 1),
                                   microbatches=M, pipeline_schedule=sched)
            mesh = training_mesh(**axes)
            with set_mesh(mesh):
                params = tfm.shard_params(
                    tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = _nbytes(t for _, t in train.param_leaves(params))
            base = torch.cuda.memory_allocated() - held
            batch = torch.from_numpy(axes_rows(B)).cuda()
            inp, tgt = batch[:, :-1], batch[:, 1:]
            with set_mesh(mesh):
                step, tx = train.make_train_step(cfg, tc)
                state = tx.init(params)
                loss = float(step(params, state, inp, tgt)[2])  # warm-up
                norm = float(state.grad_norm)
                torch.cuda.synchronize()
                flash.reset_launches()
                collectives.reset_traffic()
                detours = multihost.host_detours
                t1 = time.perf_counter()
                for _ in range(AXES_TIMED_STEPS):
                    last = step(params, state, inp, tgt)[2]
                enqueued = time.perf_counter() - t1
                float(last)
                wall = time.perf_counter() - t1
            adam = _nbytes(v for st in state.optimizer.state.values()
                           for k, v in st.items() if k.startswith("exp_avg"))
            res.update(
                loss=loss, grad_norm=norm, ms_per_step=wall / AXES_TIMED_STEPS * 1e3,
                host_enqueue_share=enqueued / wall,
                bytes_per_step={k: v // AXES_TIMED_STEPS for k, v in collectives.traffic.items()},
                host_detours_per_step=(multihost.host_detours - detours) / AXES_TIMED_STEPS,
                peak_bytes=torch.cuda.max_memory_allocated() - base, param_bytes=held,
                adam_bytes=adam, launches=dict(flash.kernel_launches),
                crosses=[a for a in mesh.axis_names if mesh.crosses(a)],
                device=str(torch.device("cuda", torch.cuda.current_device())),
                wall_s=time.perf_counter() - t0)
            del params, state, step, tx
            gc.collect()
            torch.cuda.empty_cache()
        except Exception as e:  # noqa: BLE001 - printed for the parent
            res.update(error=f"{type(e).__name__}: {e}"[:600], wall_s=time.perf_counter() - t0)
            print(json.dumps(res), flush=True)
            os._exit(3)
        print(json.dumps(res), flush=True)
    multihost.shutdown()


def run_ranks(code, world, timeout_s, *args):
    """``world`` children of ``code`` (rank, world, port, ``args``) from
    the checkout, on one port; their JSON lines and return codes."""
    port = _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(port), *args],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    kids = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            so, se = p.communicate()
            se += f"\n(killed after {timeout_s} s)"
        lines = [json.loads(x) for x in so.splitlines() if x.startswith("{")]
        kids.append(dict(lines=lines, rc=p.returncode, stderr=se[-1500:]))
    return kids


def phase_train_axes():
    """Legs (a)-(f) of the training axes on one card (the module
    docstring's phase 17).  Returns the flash launches of the phase's main
    runs (the timed pipelined train steps, the ring steps, ``fit``) by
    instantiation."""
    from tensorframes_tpu_torch import TensorFrame, data, train
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh

    total = {}

    def counted():
        for name, n in flash.kernel_launches.items():
            total[name] = total.get(name, 0) + n

    def grad_of(params, fn):
        """(loss, gradient norm) of ``fn(params)``: a loss to differentiate,
        or ``(loss, grads)`` as the 1F1B schedule returns them."""
        leaves = [t.requires_grad_() for _, t in train.param_leaves(params)]
        out = fn(params)
        if isinstance(out, tuple):
            loss, grads = out[0], [g for _, g in train.param_leaves(out[1])]
        else:
            loss, grads = out, torch.autograd.grad(out, leaves)
        norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        for t in leaves:
            t.requires_grad_(False)
        return float(loss.detach()), norm

    def timed_steps(cfg, tc, params, inp, tgt, profiled=False):
        """ms a train step (``AXES_TIMED_STEPS`` after a warm-up), the
        share of the wall time the host spent enqueueing them, and the
        flash launches a step by kernel, of the timed steps alone;
        ``profiled``: one more step under the profiler, the device's busy
        time in it."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() - _nbytes(t for _, t in train.param_leaves(params))
        step, tx = train.make_train_step(cfg, tc)
        state = tx.init(params)
        float(step(params, state, inp, tgt)[2])  # warm-up
        torch.cuda.synchronize()
        flash.reset_launches()
        t0 = time.perf_counter()
        for _ in range(AXES_TIMED_STEPS):
            last = step(params, state, inp, tgt)[2]
        enqueued = time.perf_counter() - t0
        float(last)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counted()
        per_step = {k: v // AXES_TIMED_STEPS for k, v in
                    (("flash_fwd", flash.launches), ("flash_bwd_dq", flash.launches_dq),
                     ("flash_bwd_dkv", flash.launches_dkv), ("ring_step", flash.launches_ring))}
        host = dict(host_enqueue_share=enqueued / wall, peak_bytes=peak)
        if profiled:
            wall_ms, rows = device_rows(lambda: float(step(params, state, inp, tgt)[2]))
            busy = sum(us for _, us in rows) / 1e3
            host.update(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                        idle_share=max(0.0, 1.0 - busy / wall_ms))
        del state
        return wall / AXES_TIMED_STEPS * 1e3, per_step, host

    # (a), (b): the flagship train config, GPipe and 1F1B against one stage
    cfg = tfm.TransformerConfig(**TRAIN_MODEL)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = torch.from_numpy(axes_rows(AXES_B)).cuda()
    inp, tgt = batch[:, :-1], batch[:, 1:]
    ref_loss, ref_norm = grad_of(clone_params(params), lambda p: tfm.loss_fn(p, inp, tgt, cfg))
    ref_ms, ref_launches, ref_busy = timed_steps(cfg, train.TrainConfig(learning_rate=3e-4),
                                                 clone_params(params), inp, tgt, profiled=True)
    total.clear()  # the single-stage step is the comparison, not this phase's path
    say("train_axes", leg="a/b single stage", batch=AXES_B, seq=TRAIN_L, loss=ref_loss,
        grad_norm=ref_norm, ms_per_step=ref_ms, launches_per_step=ref_launches, **ref_busy)
    L = cfg.n_layers
    fwd_per_layer = {"gpipe": 2, "1f1b": 3}  # "selective" recomputes; 1F1B once more
    for sched in ("gpipe", "1f1b"):
        for S, M in AXES_PIPES:
            tc = train.TrainConfig(learning_rate=3e-4, pp_stages=S, microbatches=M,
                                   pipeline_schedule=sched)
            with set_mesh(training_mesh(pp=S)):
                if sched == "gpipe":
                    loss, norm = grad_of(clone_params(params), lambda p: train.loss_pipelined(
                        p, inp, tgt, cfg, tc))
                else:
                    loss, norm = grad_of(clone_params(params), lambda p: train.loss_and_grad_1f1b(
                        p, inp, tgt, cfg, tc))
                ms, per_step, busy = timed_steps(cfg, tc, clone_params(params), inp, tgt,
                                                 profiled=(sched, S) == ("gpipe", 2))
            d_loss, d_norm = abs(loss - ref_loss), abs(norm / ref_norm - 1)
            want = {"flash_fwd": fwd_per_layer[sched] * L * M, "flash_bwd_dq": L * M,
                    "flash_bwd_dkv": L * M, "ring_step": 0}
            say("train_axes", leg="a" if sched == "gpipe" else "b", schedule=sched, pp=S,
                microbatches=M, loss=loss, loss_abs_diff=d_loss, loss_tol=AXES_LOSS_TOL,
                grad_norm=norm, grad_norm_rel_diff=d_norm, grad_norm_rtol=AXES_GRAD_RTOL,
                ms_per_step=ms, ms_vs_single_stage=ms / ref_ms, launches_per_step=per_step,
                bubble_share=(S - 1) / (M + S - 1), **busy)
            if not (d_loss <= AXES_LOSS_TOL and d_norm <= AXES_GRAD_RTOL):
                raise AssertionError(f"train_axes {sched} pp={S} M={M}: loss diff {d_loss}, "
                                     f"grad norm rel {d_norm}")
            if per_step != want:
                raise AssertionError(f"train_axes {sched} pp={S} M={M}: launches {per_step}, "
                                     f"expected {want}")

    # (b) peak memory of loss and gradients at one row a microbatch
    mem = {}
    for sched in ("gpipe", "1f1b"):
        for M in AXES_MEM_M:
            tc = train.TrainConfig(pp_stages=2, microbatches=M, pipeline_schedule=sched)
            rows = torch.from_numpy(axes_rows(M)).cuda()
            p = clone_params(params)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with set_mesh(training_mesh(pp=2)):
                fn = train.loss_pipelined if sched == "gpipe" else train.loss_and_grad_1f1b
                grad_of(p, lambda q: fn(q, rows[:, :-1], rows[:, 1:], cfg, tc))
            mem[(sched, M)] = torch.cuda.max_memory_allocated() - base
            del p
    grow = {sched: mem[(sched, AXES_MEM_M[1])] - mem[(sched, AXES_MEM_M[0])]
            for sched in ("gpipe", "1f1b")}
    say("train_axes", leg="b memory", microbatch_rows=1, pp=2, microbatches=list(AXES_MEM_M),
        peak_bytes_over_params={f"{s}_M{m}": v for (s, m), v in mem.items()},
        growth_bytes=grow)
    if not (grow["gpipe"] > 0 and grow["1f1b"] < grow["gpipe"]):
        raise AssertionError(f"train_axes memory: GPipe grows {grow['gpipe']}, "
                             f"1F1B {grow['1f1b']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) pp=2 x sp=2 with ring_flash against the single-stage ring at sp=2
    rcfg = tfm.TransformerConfig(**RING_MODEL, attn_impl="ring_flash")
    rparams = tfm.init(torch.Generator(device="cuda").manual_seed(0), rcfg)
    rng = np.random.RandomState(22)
    rb = torch.from_numpy(rng.randint(0, rcfg.vocab_size, (AXES_RING_B, AXES_RING_L + 1))
                          .astype(np.int32)).cuda()
    rin, rtg = rb[:, :-1], rb[:, 1:]
    rtc = train.TrainConfig(learning_rate=3e-4, pp_stages=2, microbatches=2)
    with torch.no_grad():
        with set_mesh(training_mesh(sp=AXES_RING_SP)):
            r_ref = float(tfm.loss_fn(rparams, rin, rtg, rcfg))
        with set_mesh(training_mesh(pp=2, sp=AXES_RING_SP)):
            r_pp = float(train.loss_pipelined(rparams, rin, rtg, rcfg, rtc))
    with set_mesh(training_mesh(pp=2, sp=AXES_RING_SP)):
        r_ms, r_launches, r_busy = timed_steps(rcfg, rtc, clone_params(rparams), rin, rtg)
    r_want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "ring_step": rcfg.n_layers * 2 * hops_per_layer(AXES_RING_SP)}
    say("train_axes", leg="c", pp=2, sp=AXES_RING_SP, seq=AXES_RING_L, batch=AXES_RING_B,
        microbatches=2, loss=r_pp, single_stage_loss=r_ref, loss_abs_diff=abs(r_pp - r_ref),
        loss_tol=AXES_LOSS_TOL, ms_per_step=r_ms, launches_per_step=r_launches,
        instantiations=sorted(total), **r_busy)
    if not abs(r_pp - r_ref) <= AXES_LOSS_TOL or r_launches != r_want:
        raise AssertionError(f"train_axes ring: loss diff {abs(r_pp - r_ref)}, launches "
                             f"{r_launches}, expected {r_want}")
    del rparams
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the MoE flagship pipelined, and ep=2 against ep=1
    mcfg = tfm.TransformerConfig(**MOE_MODEL, attn_impl="flash")
    mparams = tfm.init(torch.Generator(device="cuda").manual_seed(14), mcfg)
    mb = torch.from_numpy(np.random.RandomState(14).randint(
        0, mcfg.vocab_size, (MOE_TRAIN_B, MOE_L + 1)).astype(np.int32)).cuda()
    min_, mtg = mb[:, :-1], mb[:, 1:]
    mtc = train.TrainConfig(pp_stages=2, microbatches=2)
    with torch.no_grad():
        m_ref = float(tfm.loss_fn(mparams, min_, mtg, mcfg))
        m_mb = float(sum(tfm.loss_fn(mparams, a, b, mcfg) for a, b in
                         zip(min_.chunk(2), mtg.chunk(2)))) / 2
        with set_mesh(training_mesh(pp=2)):
            m_pp = float(train.loss_pipelined(mparams, min_, mtg, mcfg, mtc))
        ep_loss = {}
        for ep in (1, 2):
            with set_mesh(training_mesh(dp=2, ep=ep)):
                ep_loss[ep] = tfm.loss_fn(mparams, min_, mtg, mcfg)
    ep_diff = float((ep_loss[2] - ep_loss[1]).abs())
    say("train_axes", leg="d", pp=2, microbatches=2, batch=MOE_TRAIN_B, loss=m_pp,
        unpipelined_microbatch_mean=m_mb, loss_abs_diff=abs(m_pp - m_mb),
        loss_tol=AXES_LOSS_TOL, full_batch_loss=m_ref, full_batch_rel_gap=abs(m_pp / m_ref - 1),
        ep2_loss=float(ep_loss[2]), ep1_loss=float(ep_loss[1]), ep_abs_diff=ep_diff,
        ep_bit_identical=bool(torch.equal(ep_loss[1], ep_loss[2])), ep_tol=NLL_TOL)
    if not (abs(m_pp - m_mb) <= AXES_LOSS_TOL and ep_diff <= NLL_TOL):
        raise AssertionError(f"train_axes moe: pipelined diff {abs(m_pp - m_mb)}, "
                             f"ep diff {ep_diff}")
    del mparams, ep_loss
    gc.collect()
    torch.cuda.empty_cache()

    # (e) fit fed by a mesh-sharded loader under the pp=2 mesh
    mesh = training_mesh(pp=2)
    frame = TensorFrame.from_arrays({"tokens": axes_rows(AXES_B * AXES_FIT_STEPS)})
    loader = data.FrameLoader(frame, batch_size=AXES_B, shuffle=True, seed=0, mesh=mesh,
                              spec=("dp", None))
    fparams = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    with set_mesh(mesh):
        flash.reset_launches()
        t0 = time.perf_counter()
        _, _, losses = train.fit(loader, cfg, train.TrainConfig(
            learning_rate=3e-4, pp_stages=2, microbatches=2), steps=AXES_FIT_STEPS,
            params=fparams)
        fit_s = time.perf_counter() - t0
        counted()
    say("train_axes", leg="e", pp=2, microbatches=2, steps=AXES_FIT_STEPS, losses=losses,
        seconds=fit_s, launches=dict(flash.kernel_launches))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train_axes fit losses not finite and falling: {losses}")
    del fparams
    gc.collect()
    torch.cuda.empty_cache()

    # (f) two gloo processes sharing the card, dp=2, against one process
    ccfg = tfm.TransformerConfig(**dict(TRAIN_MODEL, n_layers=AXES_CHILD_LAYERS))
    cparams = tfm.init(torch.Generator(device="cuda").manual_seed(0), ccfg)
    step, tx = train.make_train_step(ccfg, train.TrainConfig(learning_rate=3e-4))
    state = tx.init(cparams)
    one = []
    for b in data.FrameLoader(TensorFrame.from_arrays(
            {"tokens": axes_rows(AXES_B * AXES_CHILD_STEPS)}), batch_size=AXES_B):
        one.append(float(step(cparams, state, *data.lm_split(b))[2]))
    del cparams, state
    gc.collect()
    torch.cuda.empty_cache()
    port = _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", AXES_CHILD_CODE, str(r), "2", str(port)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    kids = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=AXES_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            se += f"\n(killed after {AXES_CHILD_TIMEOUT_S} s)"
        lines = [json.loads(x) for x in so.splitlines() if x.startswith("{")]
        kids.append(dict(lines[-1] if lines else {}, rc=p.returncode, stderr=se[-1500:]))
    bad = [k for k in kids if k["rc"] != 0 or "losses" not in k]
    if bad:
        raise AssertionError(f"train_axes two processes failed: {bad}")
    diffs = [max(abs(a - b) for a, b in zip(k["losses"], one)) for k in kids]
    say("train_axes", leg="f", processes=2, backend="gloo", layers=AXES_CHILD_LAYERS,
        one_process_losses=one, ranks=[{k: v for k, v in kid.items() if k != "stderr"}
                                       for kid in kids],
        loss_abs_diff=max(diffs), loss_tol=REMAT_LOSS_TOL)
    if not (max(diffs) <= REMAT_LOSS_TOL and all(k["rows"] == [AXES_B // 2] * AXES_CHILD_STEPS
                                                 and k["crosses"] == ["dp"] for k in kids)):
        raise AssertionError(f"train_axes two processes: losses {kids} against {one}")
    # (g) pp and tp across gloo processes sharing the card, each rank
    # holding its shard, against one process on the same weights and rows
    main_total = dict(total)
    ref = {AXES_B: dict(loss=ref_loss, grad_norm=ref_norm, ms=ref_ms,
                        peak=ref_busy["peak_bytes"])}
    gcfg = tfm.TransformerConfig(**dict(TRAIN_MODEL, n_layers=AXES_RANK_CASES[4][0][4]))
    gparams = tfm.init(torch.Generator(device="cuda").manual_seed(0), gcfg)
    gb = torch.from_numpy(axes_rows(AXES_RANK_CASES[4][0][5])).cuda()
    g_loss, g_norm = grad_of(clone_params(gparams), lambda p: tfm.loss_fn(
        p, gb[:, :-1], gb[:, 1:], gcfg))
    g_ms, _, g_host = timed_steps(gcfg, train.TrainConfig(learning_rate=3e-4),
                                  clone_params(gparams), gb[:, :-1], gb[:, 1:])
    ref[AXES_RANK_CASES[4][0][5]] = dict(loss=g_loss, grad_norm=g_norm, ms=g_ms,
                                        peak=g_host["peak_bytes"])
    total.clear()  # leg (a)'s total stands; these one-process steps are comparisons
    total.update(main_total)
    del gparams
    gc.collect()
    torch.cuda.empty_cache()
    for world, cases in AXES_RANK_CASES.items():
        t0 = time.perf_counter()
        kids = run_ranks(AXES_RANK_CODE, world, AXES_RANK_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        bad = [k for k in kids if k["rc"] != 0 or len(k["lines"]) != len(cases)
               or any("error" in x for x in k["lines"])]
        if bad:
            raise AssertionError(f"train_axes (g) {world} ranks failed: {bad}")
        for i, case in enumerate(cases):
            ranks = [k["lines"][i] for k in kids]
            for x in ranks:
                for k, n in x["launches"].items():
                    total[k] = total.get(k, 0) + n
            held_rank_case("train_axes", case, ranks, ref[case[5]], world, cfg,
                           AXES_RANK_TOL[case[0]], launch_seconds=seconds)
    say("train_axes", launches_main_runs=total)
    return total


def held_rank_case(tag, case, ranks, ref, world, cfg, tol, **extra):
    """Print one case of ranks (``rank_axes_child``'s lines) against the
    one-process step ``ref`` (loss, grad_norm, ms, peak), and raise unless
    the loss and gradient norm hold ``tol``, every rank launched the flash
    instantiations ``route_of`` names as often as its layers and
    microbatches say, and held exactly its shard's param and Adam bytes."""
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    name, axes, sched, M, layers, B = case
    loss_tol, norm_rtol, how = tol
    d_loss = max(abs(x["loss"] - ref["loss"]) for x in ranks)
    if how == "rel":
        d_loss /= abs(ref["loss"])
    d_norm = max(abs(x["grad_norm"] / ref["grad_norm"] - 1) for x in ranks)
    lcfg = dataclasses.replace(cfg, n_layers=layers)
    local = layers // axes.get("pp", 1)
    width = flash.kernel_head_dim(cfg.head_dim)
    n_bwd = local * M * AXES_TIMED_STEPS
    want = {route_of("flash_fwd", cfg.dtype, width): {"gpipe": 2, "1f1b": 3}[sched] * n_bwd,
            route_of("flash_bwd_dq", cfg.dtype, width): n_bwd,
            route_of("flash_bwd_dkv", cfg.dtype, width): n_bwd}
    shard = [sum(int(np.prod(cut_shape(shape, tfm.param_cuts(lcfg, rank_mesh(
        axes, world, x["rank"])).get(path, ())))) * 4
        for path, shape in flat_shapes(tfm.param_shapes(lcfg))) for x in ranks]
    say(tag, leg=name, processes=world, schedule=sched, mesh=axes, microbatches=M,
        layers=layers, batch=B, seq=TRAIN_L, loss=[x["loss"] for x in ranks],
        one_process_loss=ref["loss"], loss_diff=d_loss, loss_tol=loss_tol, loss_tol_kind=how,
        grad_norm=[x["grad_norm"] for x in ranks], one_process_grad_norm=ref["grad_norm"],
        grad_norm_rel_diff=d_norm, grad_norm_rtol=norm_rtol,
        ms_per_step=[x["ms_per_step"] for x in ranks], one_process_ms=ref["ms"],
        host_enqueue_share=[x["host_enqueue_share"] for x in ranks],
        bytes_per_step_per_rank=[x["bytes_per_step"] for x in ranks],
        host_detours_per_step=[x["host_detours_per_step"] for x in ranks],
        peak_bytes=[x["peak_bytes"] for x in ranks], one_process_peak_bytes=ref["peak"],
        peak_vs_one_process=[x["peak_bytes"] / ref["peak"] for x in ranks],
        param_bytes=[x["param_bytes"] for x in ranks], shard_bytes=shard,
        adam_bytes=[x["adam_bytes"] for x in ranks],
        launches_per_rank=[x["launches"] for x in ranks], crosses=ranks[0]["crosses"],
        devices=[x["device"] for x in ranks],
        gloo_bf16_all_reduce=ranks[0]["gloo_bf16_all_reduce"],
        mm_out_dtype=ranks[0]["mm_out_dtype"], **extra)
    if not (d_loss <= loss_tol and d_norm <= norm_rtol):
        raise AssertionError(f"{tag} {name}: loss diff {d_loss}, grad norm rel {d_norm}")
    if any(x["launches"] != want for x in ranks):
        raise AssertionError(f"{tag} {name}: launches {[x['launches'] for x in ranks]}, "
                             f"expected {want}")
    if any(x["param_bytes"] != b or x["adam_bytes"] != 2 * b for x, b in zip(ranks, shard)):
        raise AssertionError(f"{tag} {name}: a rank holds more than its shard: "
                             f"{[x['param_bytes'] for x in ranks]} against {shard}")


def flat_shapes(tree, prefix=""):
    """``(path, shape)`` of every leaf of a shape tree (``param_leaves``
    paths)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += flat_shapes(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def cut_shape(shape, cuts):
    """A leaf's shape cut as ``transformer.param_cuts`` says."""
    shape = list(shape)
    for dim, _axis, start, stop, _full in cuts:
        shape[dim] = stop - start
    return shape


def ring_launches(flash):
    return {"flash_ring_step": flash.launches_ring, "flash_fwd": flash.launches,
            "flash_bwd_dq": flash.launches_dq, "flash_bwd_dkv": flash.launches_dkv}


def hops_per_layer(sp):
    """Ring steps a causal ring runs per layer: the sp(sp+1)/2 (rank, chunk)
    pairs with the chunk not after the rank."""
    return sp * (sp + 1) // 2


def phase_ring_slice():
    """Long-context scoring: the flagship at 8192 tokens a row, through
    map_blocks under set_mesh(training_mesh(sp=4)) with attn_impl="auto"."""
    from tensorframes_tpu_torch import TensorFrame, map_blocks
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.parallel import flash, mesh

    cfg = tfm.TransformerConfig(**RING_MODEL, attn_impl="auto")
    ring_mesh = mesh.training_mesh(sp=RING_SP)
    with mesh.set_mesh(ring_mesh):
        resolved = tfm.resolve_attn_impl(cfg, RING_L)
    if resolved != "ring_flash" or tfm.resolve_attn_impl(cfg, RING_L) != "flash":
        raise AssertionError(f"auto resolved to {resolved!r} under sp={RING_SP}")
    rows, L, blocks = RING_ROWS, RING_L, RING_BLOCKS
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (rows, L)).astype(np.int32)
    frame = TensorFrame.from_arrays({"tokens": tokens}, num_blocks=blocks)
    block = TensorFrame.from_arrays({"tokens": tokens[: rows // blocks]})

    def score(program, ring_mesh, data):
        """(outputs, seconds, launches, peak) of one map_blocks run, after a
        one-block warm-up, under ``ring_mesh`` (None: no mesh, sp = 1)."""
        with mesh.set_mesh(ring_mesh):
            map_blocks(program, block).to_arrays()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash.reset_launches()  # count the main path's run alone
            t0 = time.perf_counter()
            out = map_blocks(program, data).to_arrays()  # ends in a D2H sync
            elapsed = time.perf_counter() - t0
        return out, elapsed, ring_launches(flash), torch.cuda.max_memory_allocated()

    prog = scoring.scoring_program(params, cfg, fetches=scoring.FETCHES)
    out, sec, launches, peak = score(prog, ring_mesh, frame)
    by_instantiation = dict(flash.kernel_launches)
    want = dict.fromkeys(launches, 0)
    want["flash_ring_step"] = cfg.n_layers * hops_per_layer(RING_SP) * blocks
    if launches != want:
        raise AssertionError(f"ring scoring: kernel launches {launches}, expected {want}")
    for key, shape in (("nll", (rows,)), ("perplexity", (rows,)),
                       ("embedding", (rows, cfg.d_model))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"ring {key}: shape {out[key].shape} or non-finite")
    say("ring_slice", attn_impl="auto", resolved=resolved, sp=RING_SP, rows=rows,
        tokens_per_row=L, blocks=blocks, seconds=sec, rows_per_s=rows / sec,
        tokens_per_s=rows * L / sec, ms_per_block=sec / blocks * 1e3,
        peak_bytes=peak, launches=launches, nll_mean=float(out["nll"].mean()))

    # the same program with no mesh: "auto" takes flash at sp = 1
    flat, flat_sec, flat_launches, flat_peak = score(prog, None, frame)
    if flat_launches["flash_fwd"] != cfg.n_layers * blocks or flat_launches["flash_ring_step"]:
        raise AssertionError(f"sp = 1 scoring: kernel launches {flat_launches}")
    diff = float(np.abs(flat["nll"] - out["nll"]).max())
    if not diff <= NLL_TOL:
        raise AssertionError(f"nll ring_flash vs flash: max |diff| {diff} > {NLL_TOL}")
    say("ring_slice", attn_impl="flash", sp=1, seconds=flat_sec,
        ms_per_block=flat_sec / blocks * 1e3, peak_bytes=flat_peak,
        launches=flat_launches, nll_max_abs_diff_vs_ring_flash=diff,
        nll_tol=NLL_TOL, ring_over_flash_ms_per_block=sec / flat_sec)

    # one block through the xla ring step (plain PyTorch folds)
    xla = scoring.scoring_program(params, dataclasses.replace(cfg, attn_impl="ring"),
                                  fetches=("nll",))
    x_out, x_sec, x_launches, x_peak = score(xla, ring_mesh, block)
    if x_launches["flash_ring_step"]:
        raise AssertionError(f"xla ring launched the ring kernel: {x_launches}")
    diff = float(np.abs(x_out["nll"] - out["nll"][: rows // blocks]).max())
    if not diff <= NLL_TOL:
        raise AssertionError(f"nll ring_flash vs ring (xla step): max |diff| {diff}")
    say("ring_slice", attn_impl="ring", sp=RING_SP, blocks=1, ms_per_block=x_sec * 1e3,
        peak_bytes=x_peak, nll_max_abs_diff_vs_ring_flash=diff, nll_tol=NLL_TOL)
    return launches["flash_ring_step"], prog, block, ring_mesh, by_instantiation


def phase_ring_train(ring_mesh):
    """Long-context training: the flagship at B=2 x 8192 tokens under
    set_mesh(training_mesh(sp=4)) with attn_impl="ring_flash", one epoch
    through FrameLoader and fit."""
    from tensorframes_tpu_torch import TensorFrame, data, train
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash, mesh

    cfg = tfm.TransformerConfig(**RING_MODEL, attn_impl="ring_flash")
    tc = train.TrainConfig(learning_rate=3e-4)
    rows, B, L = RING_TRAIN_ROWS, RING_TRAIN_B, RING_L
    steps = rows // B  # one epoch
    rng = np.random.RandomState(0)
    start = rng.randint(0, cfg.vocab_size, (rows, 1))
    toks = ((start + np.arange(L + 1)) % cfg.vocab_size).astype(np.int32)
    frame = TensorFrame.from_arrays({"tokens": toks}, num_blocks=4)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)

    def loader():
        return data.FrameLoader(frame, batch_size=B, shuffle=True, seed=0)

    with mesh.set_mesh(ring_mesh):
        train.fit(loader(), cfg, tc, steps=1, params=params)  # warm-up step
        start_params = clone_params(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()
        t0 = time.perf_counter()
        _, _, losses = train.fit(loader(), cfg, tc, steps=steps, params=params)
        sec = time.perf_counter() - t0  # fit's losses are read: synced
        launches, peak = ring_launches(flash), train.hbm_high_water()
    want = dict.fromkeys(launches, 0)
    want["flash_ring_step"] = cfg.n_layers * hops_per_layer(RING_SP) * steps
    if launches != want:
        raise AssertionError(f"ring train: kernel launches {launches}, expected {want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"ring train losses not finite and falling: {losses}")
    n_params = train.n_params(params)
    tokens = steps * B * L
    flops_per_token = train.counted_flops_per_token(n_params, cfg, L)
    say("ring_train", attn_impl="ring_flash", sp=RING_SP, steps=steps, batch=B,
        seq=L, n_params=n_params, seconds=sec, ms_per_step=sec / steps * 1e3,
        tokens_per_s=tokens / sec,
        counted_tflops_per_s=flops_per_token * tokens / sec / 1e12,
        peak_bytes=peak, launches=launches, losses=losses)

    # one step on the same batch: ring_flash at sp = 4 against flash at sp = 1
    batch = torch.from_numpy(toks[:B]).cuda()
    inp, tgt = batch[:, :-1], batch[:, 1:]
    ref = {}
    for impl, m in (("ring_flash", ring_mesh), ("flash", None)):
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        with mesh.set_mesh(m):
            p = clone_params(start_params)
            leaves = [t.requires_grad_() for _, t in train.param_leaves(p)]
            loss = tfm.loss_fn(p, inp, tgt, icfg)
            grads = torch.autograd.grad(loss, leaves)
            norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
            del grads
            step, tx = train.make_train_step(icfg, tc)
            state = tx.init(p)
            step(p, state, inp, tgt)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(3):
                _, _, last = step(p, state, inp, tgt)
            float(last)
            ms = (time.perf_counter() - t0) / 3 * 1e3
        ref[impl] = dict(loss=float(loss.detach()), grad_norm=norm, ms_per_step=ms,
                         peak_bytes=train.hbm_high_water())
        del p, state, leaves
    d_loss = abs(ref["ring_flash"]["loss"] - ref["flash"]["loss"])
    d_norm = abs(ref["ring_flash"]["grad_norm"] / ref["flash"]["grad_norm"] - 1)
    if not (d_loss <= FULL_LOSS_TOL and d_norm <= FULL_GRAD_NORM_RTOL):
        raise AssertionError(
            f"ring_flash sp=4 vs flash sp=1: loss diff {d_loss}, grad norm rel {d_norm}")
    say("ring_train", check=f"B={B} step, ring_flash sp={RING_SP} vs flash sp=1", **{
        f"{impl}_{k}": v for impl, r in ref.items() for k, v in r.items()
    }, loss_abs_diff=d_loss, loss_tol=FULL_LOSS_TOL, grad_norm_rel_diff=d_norm,
        grad_norm_rtol=FULL_GRAD_NORM_RTOL)

    # a small f32 model trained three steps under the sp = 4 mesh, on the
    # card (the ring-step kernel: chunks of 16) and on the CPU (plain step)
    small = tfm.TransformerConfig(
        vocab_size=64, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
        d_ff=256, max_seq=64, dtype=torch.float32, attn_impl="ring_flash",
    )
    stc = train.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                            schedule="cosine", total_steps=10, grad_clip=0.5)
    cpu_p = tfm.init(torch.Generator().manual_seed(1), small, device="cpu")
    trained = {}
    flash.reset_launches()
    for dev in ("cuda", "cpu"):
        p = clone_params(cpu_p)
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in p.items()}
        step, tx = train.make_train_step(small, stc)
        state = tx.init(p)
        with mesh.set_mesh(mesh.training_mesh(sp=RING_SP, device=dev)):
            for i in range(3):
                b = np.random.RandomState(10 + i).randint(0, 64, (4, 65)).astype(np.int32)
                b = torch.from_numpy(b).to(dev)
                step(p, state, b[:, :-1], b[:, 1:])
        trained[dev] = dict(train.param_leaves(p))
    if flash.launches_ring != 3 * small.n_layers * hops_per_layer(RING_SP):
        raise AssertionError(f"small ring model: {flash.launches_ring} ring launches")
    err = max(
        check_close(f"small ring train {k}", v.detach().cpu(), trained["cpu"][k].detach(),
                    SMALL_TRAIN_TOL)
        for k, v in trained["cuda"].items()
    )
    say("ring_train", check="small f32 model, sp=4, 3 steps, cuda vs cpu params "
        f"(atol=rtol={SMALL_TRAIN_TOL:g})", max_abs_err=err)
    return cfg, tc, start_params, loader


# the wide ring path: the ring slices' setup (L = 8192 over sp = 4 on the
# one card, attn_impl="ring_flash", full width) for the models whose ring
# step runs the wide and f32 kernels: (leg, model, rows, blocks, seed, nll
# limit against "flash" at sp = 1); then the wide-head model trains
# RING_WIDE_STEPS steps at B = RING_WIDE_B after a warm-up step
RING_WIDE_LEGS = (("a_dh256", WIDE_MODEL, 8, 2, 13, NLL_TOL),
                  ("b_dh512", DH512_MODEL, 4, 1, 14, NLL_TOL),
                  ("c_f32", F32_MODEL, 2, 1, 15, F32_NLL_TOL))
RING_WIDE_STEPS, RING_WIDE_B = 2, 2


def phase_ring_wide():
    """The ring step's wide and f32 kernels on a path of their own: each
    ``RING_WIDE_LEGS`` model scores its rows through Program ->
    map_blocks under set_mesh(training_mesh(sp=4)) with
    ``attn_impl="ring_flash"``, after a one-block warm-up; the launches,
    counted over that run alone, must be n_layers x sp(sp+1)/2 x blocks of
    the ring step's instantiation at the model's dtype and head dim and
    nothing else; nll, perplexity and embedding of the expected shapes and
    finite, and nll within the leg's limit of the same rows scored with
    ``attn_impl="flash"`` and no mesh.  (d) The wide-head model trains
    through FrameLoader -> fit under the mesh (the backward ring is the
    plain one, as in JAX), launches counted as above, and one step's loss
    and gradient norm from the same params are held to "flash" at sp = 1
    (``FULL_LOSS_TOL``, ``FULL_GRAD_NORM_RTOL``).  Returns each run's
    launches by instantiation."""
    from tensorframes_tpu_torch import TensorFrame, data, map_blocks, train
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.parallel import flash, mesh

    ring_mesh = mesh.training_mesh(sp=RING_SP)
    hops = hops_per_layer(RING_SP)
    runs = []

    def run(program, on_mesh, data_frame, warm):
        """(outputs, seconds, launches by instantiation, peak bytes) of one
        map_blocks run after a warm-up block, under the ring mesh or none"""
        with mesh.set_mesh(ring_mesh if on_mesh else None):
            map_blocks(program, warm).to_arrays()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash.reset_launches()  # count the main path's run alone
            t0 = time.perf_counter()
            out = map_blocks(program, data_frame).to_arrays()  # ends in a D2H sync
            sec = time.perf_counter() - t0
        return out, sec, dict(flash.kernel_launches), torch.cuda.max_memory_allocated()

    for leg, model, rows, blocks, seed, tol in RING_WIDE_LEGS:
        cfg = tfm.TransformerConfig(**dict(model, max_seq=RING_L, attn_impl="ring_flash"))
        width = flash.kernel_head_dim(cfg.d_model // cfg.n_heads)
        params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
        tokens = np.random.RandomState(seed).randint(
            0, cfg.vocab_size, (rows, RING_L)).astype(np.int32)
        frame = TensorFrame.from_arrays({"tokens": tokens}, num_blocks=blocks)
        warm = TensorFrame.from_arrays({"tokens": tokens[: rows // blocks]})
        out, sec, launched, peak = run(
            scoring.scoring_program(params, cfg, fetches=scoring.FETCHES), True, frame, warm)
        want = {route_of("ring_step", cfg.dtype, width): cfg.n_layers * hops * blocks}
        if launched != want:
            raise AssertionError(f"ring_wide {leg}: launched {launched}, expected {want}")
        for key, shape in (("nll", (rows,)), ("perplexity", (rows,)),
                           ("embedding", (rows, cfg.d_model))):
            if out[key].shape != shape or not np.isfinite(out[key]).all():
                raise AssertionError(f"ring_wide {leg} {key}: shape {out[key].shape} "
                                     "or non-finite")
        flat_cfg = dataclasses.replace(cfg, attn_impl="flash")
        flat, flat_sec, flat_launched, _ = run(
            scoring.scoring_program(params, flat_cfg, fetches=("nll",)), False, frame, warm)
        flat_want = {route_of("flash_fwd", cfg.dtype, width): cfg.n_layers * blocks}
        if flat_launched != flat_want:
            raise AssertionError(f"ring_wide {leg} at sp = 1: launched {flat_launched}")
        diff = float(np.abs(flat["nll"] - out["nll"]).max())
        if not diff <= tol:
            raise AssertionError(f"ring_wide {leg} nll ring_flash vs flash: max |diff| "
                                 f"{diff} > {tol}")
        say("ring_wide", leg=leg, attn_impl="ring_flash", sp=RING_SP, dtype=str(cfg.dtype),
            head_dim=width, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, rows=rows,
            tokens_per_row=RING_L, blocks=blocks, seconds=sec,
            ms_per_block=sec / blocks * 1e3, tokens_per_s=rows * RING_L / sec,
            peak_bytes=peak, launched=launched, nll_mean=float(out["nll"].mean()),
            flash_sp1_ms_per_block=flat_sec / blocks * 1e3,
            nll_max_abs_diff_vs_flash_sp1=diff, nll_tol=tol)
        runs.append(launched)
        del params, out, flat

    # (d) the wide-head model trains under the mesh
    cfg = tfm.TransformerConfig(**dict(WIDE_MODEL, max_seq=RING_L, attn_impl="ring_flash"))
    width = flash.kernel_head_dim(cfg.d_model // cfg.n_heads)
    tc = train.TrainConfig(learning_rate=3e-4)
    rows = RING_WIDE_STEPS * RING_WIDE_B
    start = np.random.RandomState(16).randint(0, cfg.vocab_size, (rows, 1))
    toks = ((start + np.arange(RING_L + 1)) % cfg.vocab_size).astype(np.int32)
    tframe = TensorFrame.from_arrays({"tokens": toks}, num_blocks=2)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)

    def loader():
        return data.FrameLoader(tframe, batch_size=RING_WIDE_B, shuffle=True, seed=0)

    with mesh.set_mesh(ring_mesh):
        train.fit(loader(), cfg, tc, steps=1, params=params)  # warm-up step
        start_params = clone_params(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()
        t0 = time.perf_counter()
        _, _, losses = train.fit(loader(), cfg, tc, steps=RING_WIDE_STEPS, params=params)
        sec = time.perf_counter() - t0  # fit's losses are read: synced
        trained, peak = dict(flash.kernel_launches), train.hbm_high_water()
    want = {route_of("ring_step", cfg.dtype, width): cfg.n_layers * hops * RING_WIDE_STEPS}
    if trained != want:
        raise AssertionError(f"ring_wide train: launched {trained}, expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"ring_wide train losses not finite: {losses}")
    runs.append(trained)
    batch = torch.from_numpy(toks[:RING_WIDE_B]).cuda()
    inp, tgt = batch[:, :-1], batch[:, 1:]
    ref = {}
    for impl, m in (("ring_flash", ring_mesh), ("flash", None)):
        icfg = dataclasses.replace(cfg, attn_impl=impl)
        with mesh.set_mesh(m):
            p = clone_params(start_params)
            leaves = [t.requires_grad_() for _, t in train.param_leaves(p)]
            loss = tfm.loss_fn(p, inp, tgt, icfg)
            grads = torch.autograd.grad(loss, leaves)
            norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        ref[impl] = dict(loss=float(loss.detach()), grad_norm=norm)
        del p, leaves, grads, loss
    d_loss = abs(ref["ring_flash"]["loss"] - ref["flash"]["loss"])
    d_norm = abs(ref["ring_flash"]["grad_norm"] / ref["flash"]["grad_norm"] - 1)
    if not (d_loss <= FULL_LOSS_TOL and d_norm <= FULL_GRAD_NORM_RTOL):
        raise AssertionError(f"ring_wide train, ring_flash sp={RING_SP} vs flash sp=1: "
                             f"loss diff {d_loss}, grad norm rel {d_norm}")
    tokens_run = RING_WIDE_STEPS * RING_WIDE_B * RING_L
    say("ring_wide", leg="d_train", attn_impl="ring_flash", sp=RING_SP, head_dim=width,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, steps=RING_WIDE_STEPS,
        batch=RING_WIDE_B, seq=RING_L, seconds=sec, ms_per_step=sec / RING_WIDE_STEPS * 1e3,
        tokens_per_s=tokens_run / sec, peak_bytes=peak, launched=trained, losses=losses,
        **{f"{impl}_{k}": v for impl, r in ref.items() for k, v in r.items()},
        loss_abs_diff=d_loss, loss_tol=FULL_LOSS_TOL, grad_norm_rel_diff=d_norm,
        grad_norm_rtol=FULL_GRAD_NORM_RTOL)
    return runs


def phase_crossover():
    """attn_impl="auto"'s threshold on this card: flash against full at the
    scoring slice's widths, scoring ms per block of CROSSOVER_TOKENS tokens
    and one B=2 train step (best of three) at each length of CROSSOVER_LS,
    and the ring legs (ring_flash against the xla ring step) at sp = 4.
    Returns the smallest length at which flash is no slower than full in
    both (None: at none of them)."""
    from tensorframes_tpu_torch import TensorFrame, map_blocks, train
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.parallel import mesh

    base = tfm.TransformerConfig(
        vocab_size=8192, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
        d_ff=4096, max_seq=8192, dtype=torch.bfloat16,
    )
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), base)
    tc = train.TrainConfig(learning_rate=3e-4)

    def score_ms(cfg, L, rows, blocks=2, ring_mesh=None):
        toks = np.random.RandomState(L).randint(
            0, base.vocab_size, (rows * blocks, L)).astype(np.int32)
        frame = TensorFrame.from_arrays({"tokens": toks}, num_blocks=blocks)
        prog = scoring.scoring_program(params, cfg, fetches=("nll",))
        with mesh.set_mesh(ring_mesh):
            map_blocks(prog, TensorFrame.from_arrays({"tokens": toks[:rows]})).to_arrays()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = map_blocks(prog, frame).to_arrays()["nll"]
            return (time.perf_counter() - t0) / blocks * 1e3, out

    def step_ms(cfg, L):
        p = clone_params(params)
        step, tx = train.make_train_step(cfg, tc)
        state = tx.init(p)
        b = np.random.RandomState(L + 1).randint(0, base.vocab_size, (2, L + 1))
        b = torch.from_numpy(b.astype(np.int32)).cuda()
        inp, tgt = b[:, :-1], b[:, 1:]
        float(step(p, state, inp, tgt)[2])  # warm-up
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(p, state, inp, tgt)[2])
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    table = []
    for L in CROSSOVER_LS:
        rows = CROSSOVER_TOKENS // L
        row = dict(L=L, rows_per_block=rows)
        nll = {}
        for impl in ("flash", "full"):
            cfg = dataclasses.replace(base, attn_impl=impl)
            row[f"{impl}_score_ms_per_block"], nll[impl] = score_ms(cfg, L, rows)
        diff = float(np.abs(nll["flash"] - nll["full"]).max())
        if not diff <= NLL_TOL:
            raise AssertionError(f"crossover L={L}: nll flash vs full {diff} > {NLL_TOL}")
        row["flash_train_ms_per_step"] = step_ms(dataclasses.replace(base, attn_impl="flash"), L)
        try:  # full attention holds [B, H, L, L] f32 per layer: it may not fit
            row["full_train_ms_per_step"] = step_ms(dataclasses.replace(base, attn_impl="full"), L)
        except torch.cuda.OutOfMemoryError:
            row["full_train_ms_per_step"] = "out of memory"
        torch.cuda.empty_cache()
        full_train = row["full_train_ms_per_step"]
        row["flash_no_slower"] = (
            row["flash_score_ms_per_block"] <= row["full_score_ms_per_block"]
            and (isinstance(full_train, str) or row["flash_train_ms_per_step"] <= full_train))
        row["nll_max_abs_diff"] = diff
        table.append(row)
        say("crossover", **row)
    crossover = next((r["L"] for r in table if r["flash_no_slower"]), None)

    ring_mesh = mesh.training_mesh(sp=4)
    ring_flash_wins = []
    for L in CROSSOVER_RING_LS:
        row = dict(L=L, sp=4, rows_per_block=CROSSOVER_RING_ROWS)
        nll = {}
        for impl in ("ring_flash", "ring"):
            cfg = dataclasses.replace(base, attn_impl=impl)
            row[f"{impl}_score_ms_per_block"], nll[impl] = score_ms(
                cfg, L, CROSSOVER_RING_ROWS, ring_mesh=ring_mesh)
        row["nll_max_abs_diff"] = float(np.abs(nll["ring_flash"] - nll["ring"]).max())
        if not row["nll_max_abs_diff"] <= NLL_TOL:
            raise AssertionError(f"ring crossover L={L}: nll {row['nll_max_abs_diff']}")
        row["ring_flash_no_slower"] = (row["ring_flash_score_ms_per_block"]
                                       <= row["ring_score_ms_per_block"])
        if row["ring_flash_no_slower"]:
            ring_flash_wins.append(L)
        say("crossover", **row)
    say("crossover", measured_flash_min_len=crossover,
        port_default=tfm.TransformerConfig().flash_min_len,
        ring_flash_no_slower_at=ring_flash_wins)
    del params
    torch.cuda.empty_cache()
    return crossover


def phase_frontier(cfg, tc):
    """A short train.frontier_sweep (FRONTIER: at most 6 points, cheapest
    first); every point must run."""
    from tensorframes_tpu_torch import train

    points = []
    for grid in FRONTIER:
        points += train.frontier_sweep(cfg, tc, steps=2, log=lambda r: say("frontier", **r),
                                       **grid)
    bad = [p.record() for p in points if p.error is not None]
    if bad or len(points) > 6:
        raise AssertionError(f"frontier sweep: {len(points)} points, failed {bad}")
    best = train.best_frontier_point(points)
    say("frontier", best=best.record(), points=len(points))
    torch.cuda.empty_cache()


def _graphdef_leg(name, native_fn, graph_bytes, images, blocks, fetches, profile):
    """Score ``images`` (host uint8 rows) through ``native_fn`` and through
    the imported ``graph_bytes`` with map_blocks on the card (``profile``:
    also device time by kernel over one block of each); returns (imported
    outputs, native outputs, record)."""
    from tensorframes_tpu_torch import TensorFrame, map_blocks
    from tensorframes_tpu_torch.graphdef import import_graphdef

    frame = TensorFrame.from_arrays({"image": images}, num_blocks=blocks)
    first = TensorFrame.from_arrays({"image": images[: len(images) // blocks]})
    imported = import_graphdef(graph_bytes, fetches=fetches)
    rec, outs = {}, {}
    for path, prog in (("native", native_fn), ("imported", imported)):
        map_blocks(prog, first).to_arrays()  # warm-up: one block
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[path] = map_blocks(prog, frame, trim=True).to_arrays()  # ends in a D2H sync
        sec = time.perf_counter() - t0
        rec[path] = dict(seconds=sec, rows_per_s=len(images) / sec,
                         ms_per_block=sec / blocks * 1e3,
                         peak_bytes=torch.cuda.max_memory_allocated())
        if profile:
            profile_kernels(f"{name} {path} one block",
                            lambda: map_blocks(prog, first, trim=True).to_arrays())
        torch.cuda.empty_cache()
    return outs["imported"], outs["native"], rec


def _check_leg(name, imported, native, cpu, rows, score_key, class_key):
    """The imported graph against the native model on the card, and both
    against the port's CPU path on the first ``rows`` rows (f32)."""
    err = check_results(f"{name} imported vs native", imported, native,
                        GRAPHDEF_NATIVE_TOL, GRAPHDEF_NATIVE_TOL, keys=(score_key,))

    def ranked(got, ref, tol):
        """The entries whose rank is no near-tie: a top-k list may swap two
        values within tol, so a class is compared only where the values
        beside it in the list differ by more (a 1-D prediction: all)."""
        v = np.asarray(ref[score_key], np.float64)
        if v.ndim == 1:
            return np.ones(len(v), bool)
        gap = np.diff(-v, axis=-1) > tol * (1 + np.abs(v[:, :-1]))
        edge = np.ones((len(v), 1), bool)
        return np.concatenate([gap, edge], 1) & np.concatenate([edge, gap], 1)

    keep = ranked(imported, native, GRAPHDEF_NATIVE_TOL)
    if not np.array_equal(imported[class_key][keep], native[class_key][keep]):
        n = int((imported[class_key][keep] != native[class_key][keep]).sum())
        raise AssertionError(f"{name}: {n} predictions differ, imported vs native")
    head = {k: v[:rows] for k, v in imported.items()}
    cpu_err = check_results(f"{name} card vs cpu", head, cpu, GRAPHDEF_CPU_TOL,
                            GRAPHDEF_CPU_TOL, keys=(score_key,))
    keep_cpu = ranked(head, cpu, GRAPHDEF_CPU_TOL)
    if not np.array_equal(head[class_key][keep_cpu], cpu[class_key][keep_cpu]):
        raise AssertionError(f"{name}: card and CPU predictions differ")
    for k, v in imported.items():
        if not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"{name} {k}: non-finite values")
    return err, cpu_err, int(keep.sum())


def phase_graphdef(profile=False):
    """Frozen-GraphDef scoring: Inception-v3 (full width, bf16 params,
    299 x 299 x 3 uint8 rows) natively and through the imported frozen
    graph, VGG-16 (224 x 224) likewise, and config 3's MLP as a frozen
    GraphDef through map_rows, each against its native model, the CPU path
    on a few rows, and finiteness; ``profile``: device time by kernel over
    one block of each image leg."""
    from tensorframes_tpu_torch import TensorFrame, map_rows
    from tensorframes_tpu_torch.graphdef import import_graphdef
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder
    from tensorframes_tpu_torch.models import convert, inception, mlp, vgg
    from tensorframes_tpu_torch.models.inception_export import export_graphdef as inc_export
    from tensorframes_tpu_torch.models.vgg_export import export_graphdef as vgg_export

    gen = np.random.default_rng(0)
    rows = GRAPHDEF_CPU_ROWS

    # Inception-v3: bf16 params from init(0), scored as JAX's program does
    # (a bf16 image over an f32 scalar promotes to f32)
    params = inception.init(0)
    images = gen.integers(0, 256, (INCEPTION_ROWS, 299, 299, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    graph = inc_export(params)
    export_s = time.perf_counter() - t0
    imp, nat, rec = _graphdef_leg(
        "inception", inception.scoring_program(params), graph, images,
        INCEPTION_BLOCKS, ["prediction", "score"], profile)
    cpu_params = convert.inception_params_from_numpy(_np_tree(params), device="cpu")
    cpu = import_graphdef(graph, fetches=["prediction", "score"], device="cpu").call(
        {"image": torch.from_numpy(images[:rows])})
    cpu = {k: v.numpy() for k, v in cpu.items()}
    cpu_native = inception.scoring_program(cpu_params, dtype=torch.float32)(
        torch.from_numpy(images[:rows]))
    check_results("inception cpu imported vs native", cpu,
                  {k: v.numpy() for k, v in cpu_native.items()}, GRAPHDEF_NATIVE_TOL,
                  GRAPHDEF_NATIVE_TOL, keys=("score",))
    err, cpu_err, _ = _check_leg("inception", imp, nat, cpu, rows, "score", "prediction")
    say("graphdef", model="inception_v3", rows=INCEPTION_ROWS, blocks=INCEPTION_BLOCKS,
        graph_bytes=len(graph), export_seconds=export_s, **rec,
        score_max_abs_diff_imported_vs_native=err, native_tol=GRAPHDEF_NATIVE_TOL,
        score_max_abs_diff_card_vs_cpu=cpu_err, cpu_tol=GRAPHDEF_CPU_TOL,
        distinct_predictions=int(len(np.unique(imp["prediction"]))))
    del params, images, imp, nat
    torch.cuda.empty_cache()

    # VGG-16, 224 x 224, f32 (JAX's default)
    vparams = vgg.init(0)
    vimages = gen.integers(0, 256, (VGG_ROWS, 224, 224, 3), dtype=np.uint8)
    graph = vgg_export(vparams)
    imp, nat, rec = _graphdef_leg(
        "vgg16", vgg.scoring_program(vparams), graph, vimages, VGG_BLOCKS,
        ["value", "index", "probability"], profile)
    cpu = import_graphdef(graph, fetches=["value", "index", "probability"],
                          device="cpu").call({"image": torch.from_numpy(vimages[:rows])})
    cpu = {k: v.numpy() for k, v in cpu.items()}
    err, cpu_err, ranked = _check_leg("vgg16", imp, nat, cpu, rows, "value", "index")
    say("graphdef", model="vgg16", rows=VGG_ROWS, blocks=VGG_BLOCKS, graph_bytes=len(graph),
        **rec, classes_compared=ranked, value_max_abs_diff_imported_vs_native=err, native_tol=GRAPHDEF_NATIVE_TOL,
        value_max_abs_diff_card_vs_cpu=cpu_err, cpu_tol=GRAPHDEF_CPU_TOL)
    del vparams, vimages, imp, nat
    torch.cuda.empty_cache()

    # config 3's MLP (784-256-128-10) frozen into a GraphDef, through map_rows
    rng = np.random.RandomState(0)
    sizes = MLP_SIZES
    g = GraphBuilder()
    g.placeholder("image", "float32", [sizes[0]])
    x, layers = "image", []
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = (rng.randn(fi, fo) * np.sqrt(2.0 / fi)).astype(np.float32)
        b = np.zeros((fo,), np.float32)
        layers.append({"w": w, "b": b})
        g.const(f"w{i}", w)
        g.const(f"b{i}", b)
        x = g.op("MatMul", f"mm{i}", [x, f"w{i}"])
        x = g.op("BiasAdd", f"bias{i}", [x, f"b{i}"])
        if i < len(sizes) - 2:
            x = g.op("Relu", f"relu{i}", [x])
    g.op("ArgMax", "prediction", [x, g.const("axis", np.int32(-1))])
    feats = rng.rand(MLP_ROWS, sizes[0]).astype(np.float32)
    frame = TensorFrame.from_arrays({"pixels": feats}, num_blocks=4)
    prog = import_graphdef(g.to_bytes(), fetches=["prediction", x],
                           inputs={"image": "pixels"}, outputs={x: "logits"})
    got, sec = timed(lambda: map_rows(prog, frame).to_arrays())
    native = map_rows(mlp.scoring_program(convert.mlp_params_from_numpy(layers)), frame,
                      feed_dict={"image": "pixels"}).to_arrays()
    err = check_results("mlp graphdef vs native", got, native, MLP_TOL, MLP_TOL,
                        keys=("logits",))
    top2 = np.sort(native["logits"], axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 10 * MLP_TOL  # argmax is not a near-tie
    if not np.array_equal(got["prediction"][clear], native["logits"].argmax(-1)[clear]):
        raise AssertionError("mlp graphdef: predictions differ from the native MLP")
    say("graphdef", model="mlp_784_256_128_10", verb="map_rows", rows=MLP_ROWS,
        seconds=sec, mrows_per_s=MLP_ROWS / sec / 1e6, logits_max_abs_diff=err,
        tol=MLP_TOL, predictions_compared=int(clear.sum()))


# --- the mixture-of-experts flagship (README: moe_experts=8, moe_top_k=2) -----
MOE_MODEL = dict(vocab_size=8192, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
                 d_ff=4096, max_seq=2048, dtype=torch.bfloat16, moe_experts=8, moe_top_k=2,
                 moe_capacity_factor=1.25)
MOE_ROWS, MOE_BLOCKS, MOE_L = 64, 8, 2048
MOE_TRAIN_ROWS, MOE_TRAIN_B = 32, 8  # 4 steps at B=8
MOE_DECODE = dict(B=8, prompt=32, new=64)
# the f32 leg: card vs the CPU path (summation order) and cached decode vs
# the full forward, at the default and at ample capacity (JAX's own factor)
MOE_SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128,
                 max_seq=64, dtype=torch.float32, moe_experts=4, moe_top_k=2)
MOE_SMALL_TOL = 1e-4
MOE_AMPLE = 8.0
# the ring leg: 8192-token rows under the ring slice's sp = 4 mesh, two
# blocks of 2 rows (each row's 2048-token chunks route as their own groups)
MOE_RING_ROWS, MOE_RING_BLOCKS = 4, 2


def moe_dispatch(params, cfg, tokens):
    """The experts each (token, rank) pick is kept by, layer by layer:
    [n_layers, G, S, E] int8 (1 where a token's pick of expert e got a
    slot), replayed through the model's own ``_attn_residual``, ``_route``
    and ``_mlp_residual`` under ``cfg``'s attention."""
    from tensorframes_tpu_torch.models import moe, transformer as tfm

    B, L = tokens.shape
    pos = torch.arange(L, dtype=torch.int32, device=tokens.device).expand(B, L)
    kept = []
    with torch.no_grad():
        x = tfm.embed_lookup(params["embed"], tokens, cfg.dtype)
        for bp in tfm.layer_params(params["blocks"]):
            x, _ = tfm._attn_residual(bp, x, pos, cfg)
            dispatch = moe._route(bp, tfm._rms_norm(x, bp["ln2"]), cfg)[2]
            kept.append(dispatch.sum(-1).to(torch.int8))
            del dispatch
            x, _ = tfm._mlp_residual(bp, x, cfg)
    return torch.stack(kept)


MOE_BREAKDOWN_ITERS = 5


def moe_breakdown(params, cfg, tokens):
    """Device ms of the parts of one MoE layer (layer 0) at a scoring
    block's shapes, each timed by CUDA events over MOE_BREAKDOWN_ITERS runs
    after a warm-up, on that layer's real input: the expert weights' cast
    to the activation dtype (``transformer.weight``, every use), the router
    (f32 product and softmax), the gate, the dispatch product, the three
    expert GEMMs with the SwiGLU, and the combine product."""
    import torch.nn.functional as F

    from tensorframes_tpu_torch.models import moe, transformer as tfm

    B, L = tokens.shape
    dt, k, E = cfg.dtype, cfg.moe_top_k, cfg.moe_experts
    bp = tfm.layer_params(params["blocks"])[0]
    pos = torch.arange(L, dtype=torch.int32, device=tokens.device).expand(B, L)
    with torch.no_grad():
        x, _ = tfm._attn_residual(bp, tfm.embed_lookup(params["embed"], tokens, dt), pos, cfg)
        yg = tfm._rms_norm(x, bp["ln2"]).reshape(B, L, -1)
        cap = moe.capacity(L, k, E, cfg.moe_capacity_factor)
        names = ("we_gate", "we_up", "we_down")
        w = {n: tfm.weight(bp[n], dt) for n in names}
        probs = torch.softmax(yg.float() @ bp["router"].float(), dim=-1)
        dispatch, combine, _ = moe.gate(probs, k, cap)
        ex_in = moe._expert_in(dispatch, yg, dt)

        def experts():
            h = F.silu(moe._expert_ffn(ex_in, w["we_gate"])) * moe._expert_ffn(ex_in, w["we_up"])
            return moe._expert_ffn(h, w["we_down"])

        ex_out = experts()
        parts = {
            "weight_casts": lambda: [tfm.weight(bp[n], dt) for n in names],
            "router": lambda: torch.softmax(yg.float() @ bp["router"].float(), dim=-1),
            "gate": lambda: moe.gate(probs, k, cap),
            "dispatch_product": lambda: moe._expert_in(dispatch, yg, dt),
            "expert_gemms": experts,
            "combine_product": lambda: moe._expert_out(combine, ex_out, dt),
        }
        ms = {}
        for name, fn in parts.items():
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(MOE_BREAKDOWN_ITERS):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end) / MOE_BREAKDOWN_ITERS
    expert_flop = 3 * 2 * E * B * cap * cfg.d_model * cfg.d_ff
    onehot_flop = 2 * B * E * cap * L * cfg.d_model
    return dict(layer_ms=ms, moe_ms_per_block=sum(ms.values()) * cfg.n_layers,
                expert_gemm_tflops_per_s=expert_flop / ms["expert_gemms"] / 1e9,
                dispatch_tflops_per_s=onehot_flop / ms["dispatch_product"] / 1e9,
                combine_tflops_per_s=onehot_flop / ms["combine_product"] / 1e9)


def active_params(params, cfg):
    """Parameters a token runs through: all but the experts, plus top_k of
    the E experts' weights (the 6N of the counted FLOPs)."""
    from tensorframes_tpu_torch import train

    total = train.n_params(params)
    experts = sum(params["blocks"][k].numel() for k in ("we_gate", "we_up", "we_down"))
    return total - experts + experts * cfg.moe_top_k // cfg.moe_experts


def phase_moe():
    """The MoE flagship at the README's config on the card: (a) scoring
    through map_blocks, flash against full with the share of dispatch
    decisions that differ; (b) 4 train steps at "selective" through
    FrameLoader and fit; (c) greedy generate, contiguous and paged; (d) a
    small f32 MoE model card vs CPU at the default capacity, and cached
    decode vs the full forward at ample capacity; (e) layer_routing_stats of
    one block; (f) 8192-token rows at "ring_flash" under an sp = 4 mesh,
    against "flash" under the same mesh.  Returns the launches by
    instantiation of (a), (b) and (f)."""
    from tensorframes_tpu_torch import TensorFrame, data, map_blocks, train
    from tensorframes_tpu_torch.models import decode, kv_pager, moe, scoring
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash, mesh

    cfg = tfm.TransformerConfig(**MOE_MODEL, attn_impl="flash")
    params = tfm.init(torch.Generator(device="cuda").manual_seed(14), cfg)
    n_params, n_active = train.n_params(params), active_params(params, cfg)
    E, k = cfg.moe_experts, cfg.moe_top_k
    S = MOE_L
    cap = moe.capacity(S, k, E, cfg.moe_capacity_factor)
    B = MOE_ROWS // MOE_BLOCKS
    expert_tflop = 3 * 2 * E * B * cap * cfg.d_model * cfg.d_ff * cfg.n_layers / 1e12
    onehot_tflop = 2 * 2 * B * E * cap * S * cfg.d_model * cfg.n_layers / 1e12
    say("moe", config=dict(MOE_MODEL, dtype=str(cfg.dtype)), n_params=n_params,
        active_params_per_token=n_active, capacity=cap,
        expert_tflop_per_block=expert_tflop, dispatch_combine_tflop_per_block=onehot_tflop)

    # (a) scoring, flash then full, one warm-up block each
    tokens = np.random.RandomState(14).randint(0, cfg.vocab_size, (MOE_ROWS, MOE_L))
    frame = TensorFrame.from_arrays({"tokens": tokens.astype(np.int32)}, num_blocks=MOE_BLOCKS)
    block = TensorFrame.from_arrays({"tokens": tokens[:B].astype(np.int32)})

    def score(c, fetches, data_frame=frame, warm=block):
        prog = scoring.scoring_program(params, c, fetches=fetches)
        map_blocks(prog, warm).to_arrays()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()
        t0 = time.perf_counter()
        out = map_blocks(prog, data_frame).to_arrays()
        sec = time.perf_counter() - t0
        return out, sec, dict(flash.kernel_launches), torch.cuda.max_memory_allocated()

    out, sec, scored, peak = score(cfg, scoring.FETCHES)
    want = {route_of("flash_fwd", cfg.dtype, 64): cfg.n_layers * MOE_BLOCKS}
    if scored != want:
        raise AssertionError(f"moe scoring: launched {scored}, expected {want}")
    for key, shape in (("nll", (MOE_ROWS,)), ("perplexity", (MOE_ROWS,)),
                       ("embedding", (MOE_ROWS, cfg.d_model))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"moe {key}: shape {out[key].shape} or non-finite")
    full_cfg = dataclasses.replace(cfg, attn_impl="full")
    full, full_sec, full_launched, full_peak = score(full_cfg, ("nll",))
    if full_launched:
        raise AssertionError(f"moe full scoring launched {full_launched}")
    diff = float(np.abs(full["nll"] - out["nll"]).max())
    first = torch.from_numpy(tokens[:B].astype(np.int64)).cuda()
    kept_flash = moe_dispatch(params, cfg, first)
    kept_full = moe_dispatch(params, full_cfg, first)
    decisions = cfg.n_layers * B * S * k
    differ = int((kept_flash != kept_full).sum()) / (2 * decisions)
    dropped = 1.0 - float(kept_flash.float().sum()) / decisions
    if not diff <= NLL_TOL:
        raise AssertionError(f"moe nll flash vs full: max |diff| {diff} > {NLL_TOL} "
                             f"(dispatch decisions differing: {differ})")
    say("moe", leg="a_score", attn_impl="flash", rows=MOE_ROWS, tokens_per_row=MOE_L,
        blocks=MOE_BLOCKS, seconds=sec, rows_per_s=MOE_ROWS / sec,
        tokens_per_s=MOE_ROWS * MOE_L / sec, ms_per_block=sec / MOE_BLOCKS * 1e3,
        peak_bytes=peak, launched=scored, nll_mean=float(out["nll"].mean()),
        full_ms_per_block=full_sec / MOE_BLOCKS * 1e3, full_peak_bytes=full_peak,
        nll_max_abs_diff_vs_full=diff, nll_tol=NLL_TOL,
        dispatch_decisions_differ_share=differ, dispatch_decisions=decisions,
        dropped_share_block0=dropped)
    del out, full, kept_flash, kept_full
    parts = moe_breakdown(params, cfg, first)
    say("moe", leg="a_breakdown", rows=B, tokens_per_row=MOE_L, **parts,
        moe_share_of_block=parts["moe_ms_per_block"] / (sec / MOE_BLOCKS * 1e3))

    # (e) routing statistics of one block at every layer
    stats = [moe.layer_routing_stats(params, first, cfg, layer=i) for i in range(cfg.n_layers)]
    for i, s in enumerate(stats):
        if not (abs(s["load"].sum() - 1.0) < 1e-4 and 0.0 <= s["drop_fraction"] < 1.0
                and np.isfinite(s["aux"])):
            raise AssertionError(f"moe routing stats of layer {i}: {s}")
    say("moe", leg="e_routing_stats", rows=B, capacity=stats[0]["capacity"],
        load=[s["load"].round(5).tolist() for s in stats],
        drop_fraction=[s["drop_fraction"] for s in stats], aux=[s["aux"] for s in stats])

    # (f) the ring: 8192-token rows at "ring_flash" under the sp = 4 mesh,
    # so each row routes as 4 groups of 2048 tokens; "flash" under the same
    # mesh routes the same groups (same capacity, same drops), and the ring
    # step must be all the attention that runs
    ring_mesh = mesh.training_mesh(sp=RING_SP)
    rcfg = dataclasses.replace(cfg, attn_impl="ring_flash", max_seq=RING_L)
    rb = MOE_RING_ROWS // MOE_RING_BLOCKS
    rtoks = np.random.RandomState(18).randint(
        0, cfg.vocab_size, (MOE_RING_ROWS, RING_L)).astype(np.int32)
    rframe = TensorFrame.from_arrays({"tokens": rtoks}, num_blocks=MOE_RING_BLOCKS)
    rblock = TensorFrame.from_arrays({"tokens": rtoks[:rb]})
    fcfg = dataclasses.replace(rcfg, attn_impl="flash")
    with mesh.set_mesh(ring_mesh):
        if moe._sp_groups(RING_L) != RING_SP:
            raise AssertionError(f"moe ring: {moe._sp_groups(RING_L)} groups a row under sp=4")
        rout, rsec, ring_launched, rpeak = score(rcfg, ("nll",), rframe, rblock)
        fout, fsec, flat_launched, _ = score(fcfg, ("nll",), rframe, rblock)
        rfirst = torch.from_numpy(rtoks[:rb].astype(np.int64)).cuda()
        kept_ring = moe_dispatch(params, rcfg, rfirst)
        kept_flat = moe_dispatch(params, fcfg, rfirst)
    want_r = {route_of("ring_step", cfg.dtype, 64):
              cfg.n_layers * hops_per_layer(RING_SP) * MOE_RING_BLOCKS}
    if ring_launched != want_r:
        raise AssertionError(f"moe ring scoring: launched {ring_launched}, expected {want_r}")
    want_f = {route_of("flash_fwd", cfg.dtype, 64): cfg.n_layers * MOE_RING_BLOCKS}
    if flat_launched != want_f:
        raise AssertionError(f"moe flash under sp=4: launched {flat_launched}, expected {want_f}")
    if rout["nll"].shape != (MOE_RING_ROWS,) or not np.isfinite(rout["nll"]).all():
        raise AssertionError(f"moe ring nll: shape {rout['nll'].shape} or non-finite")
    rdiff = float(np.abs(rout["nll"] - fout["nll"]).max())
    rdecisions = cfg.n_layers * rb * RING_L * k
    rdiffer = int((kept_ring != kept_flat).sum()) / (2 * rdecisions)
    rdropped = 1.0 - float(kept_ring.float().sum()) / rdecisions
    if not rdiff <= NLL_TOL:
        raise AssertionError(f"moe nll ring_flash vs flash under sp=4: max |diff| {rdiff} > "
                             f"{NLL_TOL} (dispatch decisions differing: {rdiffer})")
    say("moe", leg="f_ring", attn_impl="ring_flash", sp=RING_SP, rows=MOE_RING_ROWS,
        tokens_per_row=RING_L, blocks=MOE_RING_BLOCKS, groups_per_row=RING_SP,
        capacity=moe.capacity(RING_L // RING_SP, k, E, cfg.moe_capacity_factor),
        seconds=rsec, tokens_per_s=MOE_RING_ROWS * RING_L / rsec,
        ms_per_block=rsec / MOE_RING_BLOCKS * 1e3, peak_bytes=rpeak, launched=ring_launched,
        flash_ms_per_block=fsec / MOE_RING_BLOCKS * 1e3, flash_launched=flat_launched,
        nll_mean=float(rout["nll"].mean()), nll_max_abs_diff_vs_flash=rdiff, nll_tol=NLL_TOL,
        dispatch_decisions_differ_share=rdiffer, dispatch_decisions=rdecisions,
        dropped_share_block0=rdropped)
    del rout, fout, kept_ring, kept_flat

    # (b) 4 train steps at B=8 x 2048, remat "selective", FrameLoader -> fit
    tcfg = dataclasses.replace(cfg, remat_policy="selective")
    tc = train.TrainConfig(learning_rate=3e-4)
    steps = MOE_TRAIN_ROWS // MOE_TRAIN_B
    start = np.random.RandomState(15).randint(0, cfg.vocab_size, (MOE_TRAIN_ROWS, 1))
    toks = ((start + np.arange(MOE_L + 1)) % cfg.vocab_size).astype(np.int32)
    tframe = TensorFrame.from_arrays({"tokens": toks}, num_blocks=4)

    def loader():
        return data.FrameLoader(tframe, batch_size=MOE_TRAIN_B, shuffle=True, seed=0)

    train.fit(loader(), tcfg, tc, steps=1, params=params)  # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    flash.reset_launches()
    t0 = time.perf_counter()
    _, opt_state, losses = train.fit(loader(), tcfg, tc, steps=steps, params=params)
    tsec = time.perf_counter() - t0
    trained, tpeak = dict(flash.kernel_launches), train.hbm_high_water()
    want_t = {route_of("flash_fwd", cfg.dtype, 64): 2 * cfg.n_layers * steps,
              route_of("flash_bwd_dq", cfg.dtype, 64): cfg.n_layers * steps,
              route_of("flash_bwd_dkv", cfg.dtype, 64): cfg.n_layers * steps}
    if trained != want_t:
        raise AssertionError(f"moe train: launched {trained}, expected {want_t}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"moe train losses not finite and falling: {losses}")
    del opt_state
    with torch.no_grad():
        batch = torch.from_numpy(toks[:2]).cuda()
        _, aux = tfm.apply(params, batch[:, :-1], cfg, return_aux=True)
    tokens_run = steps * MOE_TRAIN_B * MOE_L
    flops_per_token = train.counted_flops_per_token(n_active, cfg, MOE_L)
    say("moe", leg="b_train", attn_impl="flash", remat="selective", steps=steps,
        batch=MOE_TRAIN_B, seq=MOE_L, n_params=n_params, active_params=n_active,
        seconds=tsec, ms_per_step=tsec / steps * 1e3, tokens_per_s=tokens_run / tsec,
        counted_tflops_per_s_active=flops_per_token * tokens_run / tsec / 1e12,
        peak_bytes=tpeak, resident_bytes_at_start=resident, launched=trained,
        losses=losses, aux_after=float(aux), aux_coef=cfg.moe_aux_coef)

    # (c) greedy decode, contiguous then paged: bit for bit, no flash launch
    dc = MOE_DECODE
    prompts = torch.from_numpy(np.random.RandomState(16).randint(
        0, cfg.vocab_size, (dc["B"], dc["prompt"])).astype(np.int32)).cuda()
    capacity_len = dc["prompt"] + dc["new"]
    capacity_len += (-capacity_len) % PAGE_TOKENS
    flash.reset_launches()
    contiguous, csec, cpeak = best_of(lambda: decode.generate(
        params, prompts, cfg, dc["new"], cache_len=capacity_len))
    cast = decode.cast_params(params, cfg.dtype)
    max_pages = capacity_len // PAGE_TOKENS
    pool = kv_pager.PagePool(cfg, n_pages=dc["B"] * max_pages + 1, tokens_per_page=PAGE_TOKENS)
    tables = kv_pager.init_tables(dc["B"], max_pages)
    charges = []
    for b in range(dc["B"]):
        charge, pages = pool.allocate(max_pages, tenant=f"row{b}")
        charges.append(charge)
        tables[b] = torch.tensor(pages, dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kp, vp = pool.k_pages, pool.v_pages
    last = torch.full((dc["B"],), dc["prompt"] - 1, dtype=torch.int32, device="cuda")
    tok, kp, vp = kv_pager.paged_prefill(cast, prompts, tables, last, kp, vp, cfg)
    out_toks = [tok]
    idx = torch.full((dc["B"],), dc["prompt"], dtype=torch.int32, device="cuda")
    for _ in range(dc["new"] - 1):
        tok, kp, vp = kv_pager.paged_decode_step(cast, tok, tables, idx, kp, vp, cfg)
        idx = idx + 1
        out_toks.append(tok)
    paged = torch.stack(out_toks, dim=1)
    torch.cuda.synchronize()
    psec = time.perf_counter() - t0
    for c in charges:
        pool.free(c)
    if not torch.equal(paged, contiguous[:, dc["prompt"]:]):
        n = int((paged != contiguous[:, dc["prompt"]:]).sum())
        raise AssertionError(f"moe paged decode differs from contiguous in {n} tokens")
    if flash.launches:
        raise AssertionError(f"moe decode launched flash kernels: {dict(flash.kernel_launches)}")
    say("moe", leg="c_decode", B=dc["B"], prompt=dc["prompt"], new=dc["new"],
        cache=capacity_len, contiguous_seconds=csec,
        contiguous_tokens_per_s=dc["B"] * dc["new"] / csec,
        contiguous_ms_per_token=csec / dc["new"] * 1e3, peak_bytes=cpeak,
        paged_seconds=psec, paged_tokens_per_s=dc["B"] * dc["new"] / psec,
        paged_equal_contiguous=True, flash_launches=0)
    del params, cast, pool, kp, vp
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a small f32 MoE model: card vs the CPU path at the default
    # capacity (drops present), cached decode vs full forward at ample
    small = tfm.TransformerConfig(**MOE_SMALL, attn_impl="flash")
    sp_cpu = tfm.init(torch.Generator().manual_seed(17), small, device="cpu")
    sp_gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
              for k, v in sp_cpu.items()}
    stoks = np.random.RandomState(17).randint(0, small.vocab_size, (4, 48)).astype(np.int64)
    drop = moe.layer_routing_stats(sp_cpu, torch.from_numpy(stoks),
                                   dataclasses.replace(small, attn_impl="full"))["drop_fraction"]
    flash.reset_launches()
    g_logits, g_aux = tfm.apply(sp_gpu, torch.from_numpy(stoks).cuda(), small, return_aux=True)
    small_launched = dict(flash.kernel_launches)
    c_logits, c_aux = tfm.apply(sp_cpu, torch.from_numpy(stoks), small, return_aux=True)
    kept_card = moe_dispatch(sp_gpu, small, torch.from_numpy(stoks).cuda()).cpu()
    kept_cpu = moe_dispatch(sp_cpu, small, torch.from_numpy(stoks))
    small_differ = int((kept_card != kept_cpu).sum()) / (2 * kept_cpu.numel() // small.moe_experts
                                                        * small.moe_top_k)
    e_card = check_close("moe small logits, cuda vs cpu", g_logits.cpu(), c_logits,
                         MOE_SMALL_TOL)
    if abs(float(g_aux) - float(c_aux)) > MOE_SMALL_TOL:
        raise AssertionError(f"moe small aux: cuda {float(g_aux)} vs cpu {float(c_aux)}")
    ample = dataclasses.replace(small, moe_capacity_factor=MOE_AMPLE)
    ref = tfm.apply(sp_gpu, torch.from_numpy(stoks).cuda(), ample)
    cache = decode.init_cache(ample, 4, 48)
    logits, cache = decode.apply_cached(sp_gpu, torch.from_numpy(stoks[:, :40]).cuda(), cache,
                                        ample)
    outs = [logits]
    for i in range(40, 48):
        logits, cache = decode.apply_cached(sp_gpu, torch.from_numpy(stoks[:, i:i + 1]).cuda(),
                                            cache, ample)
        outs.append(logits)
    e_cached = check_close("moe small cached decode vs full forward", torch.cat(outs, 1).cpu(),
                           ref.cpu(), MOE_SMALL_TOL)
    say("moe", leg="d_small_f32", check="card vs cpu at the default capacity, cached decode "
        "vs full forward at ample capacity (f32, TF32 off)", drop_fraction_layer0=drop,
        max_abs_err_card_vs_cpu=e_card, dispatch_decisions_differ_share=small_differ,
        aux_card=float(g_aux), aux_cpu=float(c_aux),
        max_abs_err_cached_vs_full=e_cached, tol=MOE_SMALL_TOL, launched=small_launched)
    return scored, trained, ring_launched


class env_set:
    """Set environment knobs for a ``with`` block, then restore them."""

    def __init__(self, **knobs):
        self.knobs, self.prev = knobs, {}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.prev[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def same_arrays(a, b) -> bool:
    return set(a) == set(b) and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


DEADLINE_BLOCKS, DEADLINE_ITERS, DEADLINE_SHARE = 8, 100, 0.3


class verb_records:
    """Collect the block-loop record of every verb run inside the ``with``
    block (``engine.last_verb_stats`` keeps only the last one)."""

    def __enter__(self):
        from tensorframes_tpu_torch.ops import engine

        self.engine, self.records = engine, []
        self.orig = engine._record_stats

        def record(*args):
            self.orig(*args)
            self.records.append(engine.last_verb_stats())

        engine._record_stats = record
        return self.records

    def __exit__(self, *exc):
        self.engine._record_stats = self.orig


def verbs_dispatch_stack(frame, pix, row_prog, logreg_fit):
    """The block dispatch stack under the verbs on the card: configs 2, 3
    and 5 with ``TFS_PREFETCH_BLOCKS`` 2 against 0 (bit-identical results,
    host bytes over the verb's seconds, the overlap ratio); an injected
    transient fault retried and an injected OOM split on a ``map_blocks``
    (bit-identical to the clean run); a deadline that stops a verb at a
    block boundary with ``DeadlineExceeded``."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import cancellation, observability as obs
    from tensorframes_tpu_torch.ops import engine, prefetch

    legs = {
        "config2_reduce_blocks_sum": (VERB_ROWS, lambda: tft.reduce_blocks(
            lambda v_input: {"v": v_input.sum(0)}, frame)),
        "config3_map_rows_mlp": (MLP_ROWS, lambda: tft.map_rows(
            row_prog, pix, feed_dict={"image": "pixels"}).to_arrays()),
        "config5_logreg": (VERB_ROWS * LOGREG_STEPS, lambda: logreg_fit("cuda")),
    }
    for name, (n_rows, fn) in legs.items():
        runs = {}
        for depth in ("0", "2"):
            with env_set(TFS_PREFETCH_BLOCKS=depth):
                fn()  # warm-up
                torch.cuda.synchronize()
                c0 = obs.counters()
                t0 = time.perf_counter()
                with verb_records() as recs:
                    out = fn()
                    torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                h2d = obs.counters_delta(c0)["h2d_bytes_staged"]
            # the prefetch stats of every verb of the leg that staged blocks
            staged = [r["prefetch"] for r in recs if r["prefetch"]["items"]]
            stage_s = sum(p["stage_s"] for p in staged)
            wait_s = sum(p["wait_s"] for p in staged)
            runs[depth] = dict(out=out, seconds=sec, h2d=h2d, stage_s=stage_s, wait_s=wait_s,
                               overlap=prefetch.overlap_ratio(stage_s, wait_s),
                               items=sum(p["items"] for p in staged), verbs=len(recs))
        if not same_arrays(runs["0"]["out"], runs["2"]["out"]):
            raise AssertionError(f"{name}: prefetched results differ from depth 0")
        say("verbs", leg=f"prefetch_{name}", rows=n_rows, bit_identical=True,
            h2d_bytes=runs["2"]["h2d"], verbs=runs["2"]["verbs"], **{
                f"depth{d}_{k}": v for d, r in runs.items() for k, v in (
                    ("seconds", r["seconds"]), ("mrows_per_s", n_rows / r["seconds"] / 1e6),
                    ("h2d_gb_per_s_over_leg", r["h2d"] / r["seconds"] / 1e9),
                    ("stage_s", r["stage_s"]), ("wait_s", r["wait_s"]),
                    ("overlap_ratio", r["overlap"]), ("staged_items", r["items"]))},
            depth0_over_depth2=runs["0"]["seconds"] / runs["2"]["seconds"])

    prog = lambda v: {"y": v * 2.0 + 1.0}  # noqa: E731
    clean = tft.map_blocks(prog, frame).to_arrays()
    faults_run = {}
    for kind, knobs, counter in (
        ("transient", dict(TFS_FAULT_INJECT="transient:block=1:attempt=0"), "block_retries"),
        ("oom", dict(TFS_FAULT_INJECT="oom:block=2:minrows=100000", TFS_MIN_SPLIT_ROWS="16"),
         "block_oom_splits"),
    ):
        with env_set(TFS_BLOCK_RETRIES="2", TFS_BLOCK_BACKOFF_S="0.001", **knobs):
            c0 = obs.counters()
            t0 = time.perf_counter()
            got = tft.map_blocks(prog, frame).to_arrays()
            sec = time.perf_counter() - t0
            d = obs.counters_delta(c0)
            ft = engine.last_verb_stats()["fault_tolerance"]
        if not same_arrays(got, clean):
            raise AssertionError(f"map_blocks under an injected {kind} differs from the clean run")
        if d[counter] != 1 or d["faults_injected"] < 1:
            raise AssertionError(f"injected {kind}: counters {d}")
        faults_run[kind] = dict(seconds=sec, counters={k: d[k] for k in (
            "faults_injected", "block_retries", "block_oom_splits")}, record=ft)
    say("verbs", leg="faults_map_blocks", rows=VERB_ROWS, blocks=VERB_BLOCKS,
        bit_identical=True, **faults_run)

    # a deadline: each block syncs (the host loop follows the card), and the
    # scope's deadline falls DEADLINE_SHARE of the way through a clean run
    w = torch.randn(VERB_D, VERB_D, generator=torch.Generator().manual_seed(3)).cuda() / 8
    done = []

    def heavy(v):
        y = v
        for _ in range(DEADLINE_ITERS):
            y = torch.tanh(y @ w)
        if y.device.type == "cuda":  # not the verbs' shape analysis on meta
            float(y[0, 0])  # a sync: the block's work is done on return
            done.append(1)
        return {"y": y}

    dframe = frame.repartition(DEADLINE_BLOCKS)
    prog_h = tft.Program.wrap(heavy, device="cuda")
    clean_sec = min(timed(lambda: tft.map_blocks(prog_h, dframe).to_arrays())[1]
                    for _ in range(2))
    deadline = DEADLINE_SHARE * clean_sec
    done.clear()
    scope = cancellation.CancelScope(deadline_s=deadline, label="map_blocks")
    t0 = time.perf_counter()
    try:
        with cancellation.activate(scope):
            tft.map_blocks(prog_h, dframe).to_arrays()
        raise AssertionError(f"a {deadline:.4f}s deadline did not stop a "
                             f"{clean_sec:.4f}s map_blocks")
    except cancellation.DeadlineExceeded:
        stopped = time.perf_counter() - t0
    if not 0 < len(done) < DEADLINE_BLOCKS:
        raise AssertionError(f"deadline: {len(done)} of {DEADLINE_BLOCKS} blocks ran")
    say("verbs", leg="deadline_map_blocks", blocks=DEADLINE_BLOCKS, clean_seconds=clean_sec,
        deadline_s=deadline, stopped_after_s=stopped, blocks_done=len(done),
        raised="DeadlineExceeded")


def _np_tree(tree):
    """A param tree of tensors as host f32 numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.detach().float().cpu().numpy()


def device_rows(fn):
    """One call of ``fn`` under torch.profiler: its wall ms and the device
    kernels' rows with their self device time (us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0
        )

    # device kernels only: a CPU op's row repeats its kernels' time
    kernels = [
        (e, dev_us(e)) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
    ]
    return wall_ms, sorted(kernels, key=lambda r: r[1], reverse=True)


def profile_kernels(label, fn) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of its wall time."""
    wall_ms, rows = device_rows(fn)
    busy_ms = sum(us for _, us in rows) / 1e3
    say("profile", path=label, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=max(0.0, 1.0 - busy_ms / wall_ms))
    for e, us in rows[:16]:
        say("profile", path=label, kernel=e.key[:90], device_ms=us / 1e3,
            calls=e.count, share=us / 1e3 / busy_ms)


def profile_step(label, cfg, tc, params, loader) -> None:
    """Device time by kernel over one train step, after a warm-up step."""
    from tensorframes_tpu_torch import data, train

    step, tx = train.make_train_step(cfg, tc)
    state = tx.init(params)
    inp, tgt = data.lm_split(next(iter(loader())))
    step(params, state, inp, tgt)  # warm-up

    def one_step():
        float(step(params, state, inp, tgt)[2])

    profile_kernels(label, one_step)


def phase_profile(prog, frame, train_run, wide_run, legs, dh512_train, f32_train, ring_run,
                  ring_train_run) -> None:
    """One block and one train step of each slice: flash at 2048 tokens
    (the flagship and the wide-head model), one block of each forward leg
    and one train step of the Dh-512 and f32 legs, and the ring at 8192
    tokens over sp = 4."""
    from tensorframes_tpu_torch import TensorFrame, map_blocks
    from tensorframes_tpu_torch.parallel import mesh

    block = TensorFrame.from_arrays({"tokens": frame.block(0)["tokens"]})
    profile_kernels("score one block", lambda: map_blocks(prog, block).to_arrays())
    profile_step("train one step", *train_run[1:5])
    wide_prog, wide_block, *wide_train = wide_run
    profile_kernels("wide-head score one block",
                    lambda: map_blocks(wide_prog, wide_block).to_arrays())
    profile_step("wide-head train one step", *wide_train)
    for tag, (leg_prog, leg_block) in legs.items():
        profile_kernels(f"{tag} score one block",
                        lambda: map_blocks(leg_prog, leg_block).to_arrays())
    profile_step("dh512_leg train one step", *dh512_train)
    profile_step("f32_leg train one step", *f32_train)
    ring_prog, ring_block, ring_mesh = ring_run[1:4]
    with mesh.set_mesh(ring_mesh):
        profile_kernels("ring score one block",
                        lambda: map_blocks(ring_prog, ring_block).to_arrays())
        profile_step("ring train one step", *ring_train_run)


# (kernel family, its flagship record's name, source, the Pallas kernel's
# line in tensorframes_tpu/parallel/flash.py)
KERNELS = [("flash_fwd", "flash_fwd", "flash_fwd", 42),
           ("flash_bwd_dq", "flash_bwd_dq", "flash_bwd", 416),
           ("flash_bwd_dkv", "flash_bwd_dkv", "flash_bwd", 452),
           ("ring_step", "flash_ring_step", "flash_ring", 217)]


def kernel_record(built, errs, timing, train_launches, ring_launches_n, main_runs):
    """The kernels' JSON record: each kernel at the flagship shape (the
    train epoch's launches; the ring step's, the ring scoring run's), then
    every instantiation timed at a VARIANTS shape, named by what it runs,
    with its launches over the main paths' runs (``main_runs``: launches by
    instantiation of the flagship scoring, the wide-head scoring and train,
    the forward legs' scoring, the Dh-512 and f32 legs' train epochs, the
    pipeline phase's scoring chain, the observability phase's scoring runs,
    the planner phase's scoring runs, the streaming and mesh phases' scoring
    runs, the flagship train epoch, the train-axes phase's pipelined
    steps, the ring scoring runs, the wide ring path's scoring and train
    runs and the MoE legs' scoring, train and ring runs)."""
    from tensorframes_tpu_torch.parallel import flash

    by_inst = {}
    for run in main_runs:
        for name, n in run.items():
            by_inst[name] = by_inst.get(name, 0) + n
    entries = []
    for family, name, src, line in KERNELS:
        common = dict(route="cuda", source=f"tensorframes_tpu_torch/csrc/{src}.cu",
                      replaces=f"tensorframes_tpu/parallel/flash.py:{line}")
        if family == "ring_step":
            # the off-diagonal hop (6 of the 10 hops a layer runs), with the
            # diagonal hop beside it
            head = dict(launches=ring_launches_n, max_abs_err=errs["ring"]["flagship_offdiag"],
                        **timing["flash_ring_step"]["off_diagonal"],
                        diagonal=dict(timing["flash_ring_step"]["diagonal"],
                                      max_abs_err=errs["ring"]["flagship_diag"]))
        else:
            head = dict(launches=train_launches[name], max_abs_err=errs["flagship"][name],
                        **timing[name])
        inst = route_of(family, FLAGSHIP["dtype"], 64)
        entries.append(dict(name=name, **common, **head, instantiation=inst,
                            launches_all_main_runs=by_inst.get(inst, 0),
                            built=[n for r in ROUTES for n in built[f"{family}_{r}"]]))
        for variant, row in timing["variants"][name].items():
            c = VARIANTS[variant]
            inst = route_of(family, c["dtype"], flash.kernel_head_dim(c["D"]))
            entries.append(dict(name=f"{inst} ({variant})", **common,
                                launches=by_inst.get(inst, 0), **row))
    return {"kernels": entries}


def general_aggregate(fn, grouped, device="cuda"):
    """``aggregate`` on the general paths (bucketed or the combine tree),
    as an executor without the device segment path runs it."""
    import tensorframes_tpu_torch as tft

    ex = tft.Executor()
    ex.supports_segment_aggregate = False
    return ex.aggregate(tft.Program.wrap(fn, device=device), grouped)


def no_host_sync(fn):
    """``fn()`` with every host sync on the card an error
    (``torch.cuda.set_sync_debug_mode``): a ``.item()``, a blocking copy
    or a branch on a device value inside ``fn`` fails the run."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_pipeline(slice_prog):
    """Legs (a)-(e) of the program analysis, its fast paths, the pool and
    verb chains (the module docstring's phase 10).  Returns the flash
    launches of leg (a) by instantiation."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import analysis, observability as obs
    from tensorframes_tpu_torch.models import kmeans, logistic_regression as lr
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.ops import bucketing, device_pool, engine
    from tensorframes_tpu_torch.parallel import flash

    classified = {}

    def classify(name, program, specs):
        c = analysis.classify(program, specs)
        classified[name] = dict(verdict=c.verdict, outputs=c.outputs, reason=c.reason)

    c_pool = obs.counters()

    # (a) the flagship's scoring as one chain, against the eager verbs
    cfg = tfm.TransformerConfig(
        vocab_size=8192, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
        d_ff=4096, max_seq=2048, dtype=torch.bfloat16, attn_impl="flash",
    )
    rows, L, blocks = 64, 2048, 8
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (rows, L)).astype(np.int32)
    frame = tft.TensorFrame.from_arrays({"tokens": tokens}, num_blocks=blocks)
    score = scoring.scoring_program(params, cfg, fetches=("nll",))
    mean_nll = tft.Program.wrap(lambda nll_input: {"nll": nll_input.mean(0)}, device="cuda")

    def eager():
        return tft.reduce_blocks(mean_nll, tft.map_blocks(score, frame))

    # built once (the stages' shape inference runs here, on meta tensors)
    t0 = time.perf_counter()
    pipe = tft.pipeline(frame).map_blocks(score).reduce_blocks(mean_nll)
    build_s = time.perf_counter() - t0
    pipe.collect()  # warm-up
    torch.cuda.synchronize()
    flash.reset_launches()  # count the chain's run alone
    c0 = obs.counters()
    t0 = time.perf_counter()
    got = pipe.collect()
    chain_s = time.perf_counter() - t0
    staged = obs.counters_delta(c0)["h2d_bytes_staged"]
    launches = dict(flash.kernel_launches)
    want, eager_s = timed(eager)
    inst = route_of("flash_fwd", torch.bfloat16, 64)
    if launches != {inst: cfg.n_layers * blocks}:
        raise AssertionError(f"pipeline scoring launched {launches}, expected "
                             f"{{{inst!r}: {cfg.n_layers * blocks}}}")
    if not same_arrays(got, want):
        raise AssertionError(f"pipeline scoring {got} differs from the eager verbs {want}")
    if staged != tokens.nbytes:
        raise AssertionError(f"pipeline scoring staged {staged} host bytes, expected "
                             f"the tokens' {tokens.nbytes} once")
    if not np.isfinite(got["nll"]).all():
        raise AssertionError(f"pipeline scoring nll not finite: {got}")
    say("pipeline", leg="a_scoring_chain", rows=rows, tokens_per_row=L, blocks=blocks,
        bit_identical=True, flash_launches=launches, h2d_bytes_staged=staged,
        nll=float(got["nll"]), build_seconds=build_s, chain_ms_per_block=chain_s / blocks * 1e3,
        eager_ms_per_block=eager_s / blocks * 1e3, chain_tokens_per_s=rows * L / chain_s,
        eager_tokens_per_s=rows * L / eager_s)
    # the gate a verb asks (one run on meta tensors, stopped at the
    # embedding gather), then the full classification (every probe)
    specs = {"tokens": (torch.int32, (L,))}
    t0 = time.perf_counter()
    if analysis.rows_independent(slice_prog, specs, (4, 8)):
        raise AssertionError("the scoring program passed the row-independence gate")
    gate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    classify("scoring_program", slice_prog, specs)
    classified["scoring_program"].update(seconds=time.perf_counter() - t0, gate_seconds=gate_s)
    classify("mean_nll", mean_nll, {"nll_input": (torch.float32, ())})
    del params, score

    # (b) the fused drivers against their eager fits
    rng = np.random.RandomState(0)
    vals = rng.rand(VERB_ROWS, VERB_D).astype(np.float32)
    labels = (vals @ rng.randn(VERB_D).astype(np.float32) > 0).astype(np.float32)
    lframe = tft.TensorFrame.from_arrays({"features": vals, "label": labels},
                                         num_blocks=VERB_BLOCKS)
    (pe, le), eager_s = timed(lambda: lr.fit(lframe, num_iters=LOGREG_STEPS, lr=0.5))
    (pf, lf), fused_s = timed(lambda: lr.fit_fused(lframe, num_iters=LOGREG_STEPS, lr=0.5))
    e_w = check_results("logreg fit_fused vs fit", {"w": pf["w"].numpy()},
                        {"w": pe["w"].cpu().numpy()}, 1e-4, 1e-4)
    e_l = check_results("logreg fit_fused losses", {"l": np.array(lf)}, {"l": np.array(le)},
                        1e-4, 1e-4)
    # fit_fused's loop driven directly: iterate with host syncs as errors,
    # then the one readback (the mode is live: a .item() under it raises)
    try:
        no_host_sync(lambda: torch.ones((), device="cuda").item())
    except RuntimeError:
        pass
    else:
        raise AssertionError("set_sync_debug_mode('error') let a .item() through")
    pipe, _ = lr.make_pipeline(lframe, 0.5)
    finals, hist = no_host_sync(lambda: pipe.iterate(
        LOGREG_STEPS, carry={"w": "w", "b": "b"}, collect=("loss",)))
    w, losses = pipe.readback((finals["w"], hist["loss"]))
    if pipe.readbacks != 1 or not (np.array_equal(w, pf["w"].numpy())
                                   and np.array_equal(losses, np.float32(lf))):
        raise AssertionError(f"logreg iterate: {pipe.readbacks} readbacks, or results "
                             f"unlike fit_fused's")
    say("pipeline", leg="b_logreg_fit_fused", rows=VERB_ROWS, steps=LOGREG_STEPS,
        readbacks=pipe.readbacks, host_syncs_in_iterate=0,
        max_abs_err_w=e_w, max_abs_err_loss=e_l, tol=1e-4,
        fused_ms_per_step=fused_s / LOGREG_STEPS * 1e3,
        eager_ms_per_step=eager_s / LOGREG_STEPS * 1e3)
    gprog = lr.grad_program(lr.init(VERB_D))
    classify("logreg_grad", gprog, {"features": (torch.float32, (VERB_D,)),
                                    "label": (torch.float32, ())})
    kr = np.random.RandomState(1)
    true = kr.randn(KMEANS_K, KMEANS_D) * 10
    pts = (true[kr.randint(0, KMEANS_K, KMEANS_N)]
           + kr.randn(KMEANS_N, KMEANS_D)).astype(np.float32)
    kframe = tft.TensorFrame.from_arrays({"points": pts}, num_blocks=VERB_BLOCKS)
    init = pts[:KMEANS_K].astype(np.float64)
    (ce, ae), eager_s = timed(lambda: kmeans.fit(kframe, KMEANS_K, KMEANS_STEPS, "preagg",
                                                  init_centers=init))
    (cf, af), fused_s = timed(lambda: kmeans.fit_fused(kframe, KMEANS_K, KMEANS_STEPS,
                                                        init_centers=init))
    e_c = check_results("kmeans fit_fused vs fit", {"c": cf}, {"c": ce}, 0.0, KMEANS_TOL)
    if not np.array_equal(af, ae):
        raise AssertionError("kmeans fit_fused assigns points unlike fit")
    pipe, _ = kmeans.make_pipeline(kframe, kmeans._init_centers(kframe, KMEANS_K, 0, init))
    finals, _ = no_host_sync(lambda: pipe.iterate(KMEANS_STEPS, carry={"centers": "centers"}))
    centers = np.asarray(pipe.readback(finals)["centers"], np.float64)
    if pipe.readbacks != 1 or not np.array_equal(centers, cf):
        raise AssertionError(f"kmeans iterate: {pipe.readbacks} readbacks, or centers "
                             f"unlike fit_fused's")
    say("pipeline", leg="b_kmeans_fit_fused", rows=KMEANS_N, k=KMEANS_K, steps=KMEANS_STEPS,
        readbacks=pipe.readbacks, host_syncs_in_iterate=0,
        max_abs_err_centers=e_c, tol=KMEANS_TOL,
        assignments_equal=True, fused_ms_per_step=fused_s / KMEANS_STEPS * 1e3,
        eager_ms_per_step=eager_s / KMEANS_STEPS * 1e3)
    classify("kmeans_preagg", kmeans.preagg_program(init),
             {"points": (torch.float32, (KMEANS_D,))})
    del vals, labels, lframe, pts, kframe

    # (c) the device segment aggregate against the general path and numpy
    sr = np.random.RandomState(3)
    keys = np.repeat(np.arange(SEG_KEYS), SEG_ROWS // SEG_KEYS)
    sr.shuffle(keys)
    svals = sr.rand(SEG_ROWS, SEG_D).astype(np.float32)
    sframe = tft.TensorFrame.from_arrays({"k": keys, "v": svals}, num_blocks=VERB_BLOCKS)
    order = np.argsort(keys, kind="stable")
    starts = np.r_[0, np.nonzero(np.diff(keys[order]))[0] + 1]
    x64 = svals[order].astype(np.float64)
    refs = {
        "sum": (lambda v_input: {"v": v_input.sum(0)}, np.add.reduceat(x64, starts), SUM_RTOL),
        "min": (lambda v_input: {"v": v_input.amin(0)},
                np.minimum.reduceat(svals[order], starts), 0.0),
        "max": (lambda v_input: {"v": v_input.amax(0)},
                np.maximum.reduceat(svals[order], starts), 0.0),
        "mean": (lambda v_input: {"v": v_input.mean(0)},
                 np.add.reduceat(x64, starts) / (SEG_ROWS // SEG_KEYS), SUM_RTOL),
        "sum_sq": (lambda v_input: {"v": (v_input * v_input).sum(0)},
                   np.add.reduceat(x64 * x64, starts), SUM_RTOL),
    }
    uniq = np.unique(keys)
    for name, (fn, ref, rtol) in refs.items():
        prog = tft.Program.wrap(fn, device="cuda")
        got, seg_s = timed(lambda: tft.aggregate(prog, sframe.group_by("k")).to_arrays())
        again = tft.aggregate(prog, sframe.group_by("k")).to_arrays()
        gen, gen_s = timed(lambda: general_aggregate(fn, sframe.group_by("k")).to_arrays())
        if not same_arrays(got, again):
            raise AssertionError(f"segment {name}: two runs differ")
        if not np.array_equal(np.asarray(got["k"]), uniq):
            raise AssertionError(f"segment {name}: keys differ from np.unique")
        e_gen = check_results(f"segment {name} vs general", got, gen, rtol, 0.0, ("v",))
        e_np = check_results(f"segment {name} vs numpy", {"v": got["v"]}, {"v": ref}, rtol)
        say("pipeline", leg=f"c_segment_{name}", rows=SEG_ROWS, keys=SEG_KEYS, width=SEG_D,
            bit_identical_runs=True, max_abs_err_vs_general=e_gen, max_abs_err_vs_numpy=e_np,
            rtol=rtol, segment_mrows_per_s=SEG_ROWS / seg_s / 1e6,
            general_mrows_per_s=SEG_ROWS / gen_s / 1e6, general_over_segment=gen_s / seg_s)
        classify(f"aggregate_{name}", prog, {"v_input": (torch.float32, (SEG_D,))})
    # two keys, the float one holding -0.0 and NaN
    k1 = sr.randint(0, 10, SEG_ROWS)
    k2 = np.array([-0.0, 0.0, 1.5, np.nan], np.float32)[sr.randint(0, 4, SEG_ROWS)]
    fk = tft.TensorFrame.from_arrays({"a": k1, "b": k2, "v": svals}, num_blocks=VERB_BLOCKS)
    prog = tft.Program.wrap(lambda v_input: {"v": v_input.sum(0)}, device="cuda")
    got = tft.aggregate(prog, fk.group_by("a", "b")).to_arrays()
    again = tft.aggregate(prog, fk.group_by("a", "b")).to_arrays()
    if not all(np.array_equal(np.asarray(got[c]), np.asarray(again[c]), equal_nan=True)
               for c in ("a", "b", "v")):
        raise AssertionError("segment two-key float: two runs differ")
    canon = np.where(np.isnan(k2), np.inf, k2 + np.float32(0.0))  # NaN last, -0.0 -> 0.0
    rec = np.rec.fromarrays([k1, canon])
    ukeys, inv = np.unique(rec, return_inverse=True)
    ref = np.zeros((len(ukeys), SEG_D))
    np.add.at(ref, inv.reshape(-1), svals.astype(np.float64))
    want_b = np.where(np.isinf(ukeys["f1"]), np.nan, ukeys["f1"])
    gb = np.asarray(got["b"])
    if not (np.array_equal(np.asarray(got["a"]), ukeys["f0"])
            and np.array_equal(gb, want_b, equal_nan=True) and not np.signbit(gb).any()):
        raise AssertionError("segment two-key float: keys differ from the canonical order")
    e_np = check_results("segment two-key float vs numpy", {"v": got["v"]}, {"v": ref}, SUM_RTOL)
    say("pipeline", leg="c_segment_two_key_float", rows=SEG_ROWS, groups=len(ukeys),
        bit_identical_runs=True, max_abs_err_vs_numpy=e_np, rtol=SUM_RTOL,
        nan_groups=int(np.isnan(gb).sum()), negative_zero_keys=int(np.signbit(gb).sum()))
    del svals, sframe, fk, x64

    # (d) bucket padding: ragged map_rows, uneven map_blocks; on against off
    rr = np.random.RandomState(4)
    lengths = rr.randint(1, RAGGED_MAX + 1, RAGGED_ROWS)
    flat = rr.rand(int(lengths.sum())).astype(np.float32)
    cells = np.split(flat, np.cumsum(lengths)[:-1])
    rframe = tft.TensorFrame.from_arrays({"v": cells}, num_blocks=VERB_BLOCKS)
    ragged = tft.Program.wrap(lambda v: {"z": v * 2.0 + 1.0}, device="cuda")
    runs = {}
    for knob in ("", "off"):
        # one run each: the host's bucketing and reassembly dominate
        with env_set(TFS_BLOCK_BUCKETS=knob):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tft.map_rows(ragged, rframe).column("z").cells()
            sec = time.perf_counter() - t0
            runs[knob or "on"] = dict(out=out, seconds=sec,
                                      calls=engine.last_verb_stats()["ragged_buckets"],
                                      padded=engine.last_verb_stats()["padded"])
    if not all(np.array_equal(a, b) for a, b in zip(runs["on"]["out"], runs["off"]["out"])):
        raise AssertionError("ragged map_rows: padded buckets differ from exact ones")
    if not runs["on"]["padded"] or runs["off"]["padded"]:
        raise AssertionError(f"ragged map_rows: padding {runs['on']['padded']} on, "
                             f"{runs['off']['padded']} off")
    say("pipeline", leg="d_ragged_map_rows", rows=RAGGED_ROWS, max_len=RAGGED_MAX,
        identical=True, **{f"{k}_{f}": r[f] for k, r in runs.items()
                           for f in ("calls", "seconds")},
        **{f"{k}_mrows_per_s": RAGGED_ROWS / r["seconds"] / 1e6 for k, r in runs.items()})
    classify("ragged_cell", ragged, {"v": (torch.float32, ())})
    del cells, flat, rframe, runs
    uvals = rr.rand(UNEVEN_ROWS, VERB_D).astype(np.float32)
    uframe = tft.TensorFrame.from_arrays({"x": uvals}, num_blocks=UNEVEN_BLOCKS)
    uprog = tft.Program.wrap(lambda x: {"y": x * 2.0 + 1.0}, device="cuda")
    runs = {}
    for knob in ("", "off"):
        with env_set(TFS_BLOCK_BUCKETS=knob):
            runs[knob or "on"] = timed(lambda: tft.map_blocks(uprog, uframe).to_arrays()["y"])
    if not np.array_equal(runs["on"][0], runs["off"][0]):
        raise AssertionError("uneven map_blocks: padded blocks differ from exact ones")
    say("pipeline", leg="d_uneven_map_blocks", rows=UNEVEN_ROWS, blocks=UNEVEN_BLOCKS,
        block_sizes=sorted(set(uframe.block_sizes)),
        padded_to=bucketing.bucket_for(max(uframe.block_sizes)), identical=True,
        on_seconds=runs["on"][1], off_seconds=runs["off"][1],
        on_mrows_per_s=UNEVEN_ROWS / runs["on"][1] / 1e6,
        off_mrows_per_s=UNEVEN_ROWS / runs["off"][1] / 1e6,
        on_over_off=runs["on"][1] / runs["off"][1])
    classify("uneven_map", uprog, {"x": (torch.float32, (VERB_D,))})
    del uvals, uframe, runs

    # (e) the analysis, the pool on one card, the sharded cache
    for name, c in classified.items():
        say("pipeline", leg="e_classification", program=name, **c)
    local = device_pool._local_devices()
    pooled = obs.counters_delta(c_pool)["pool_blocks"]
    if device_pool.pool_devices() != [] or len(local) != 1 or pooled:
        raise AssertionError(f"pool on one card: pool {device_pool.pool_devices()}, "
                             f"local {local}, {pooled} pooled blocks")
    cvals = np.random.RandomState(6).rand(VERB_ROWS, VERB_D).astype(np.float32)
    cframe = tft.TensorFrame.from_arrays({"v": cvals}, num_blocks=VERB_BLOCKS)
    sharded, plain = cframe.cache(sharded=True), cframe.cache()
    red = tft.Program.wrap(lambda v_input: {"v": v_input.sum(0)}, device="cuda")
    c0 = obs.counters()
    got = tft.reduce_blocks(red, sharded)
    staged = obs.counters_delta(c0)["h2d_bytes_staged"]
    want = tft.reduce_blocks(red, plain)
    if staged or not same_arrays(got, want):
        raise AssertionError(f"cache(sharded=True): {staged} host bytes staged, "
                             f"identical {same_arrays(got, want)}")
    say("pipeline", leg="e_pool_and_sharded_cache", local_devices=[str(d) for d in local],
        pool_devices=[], pooled_blocks=pooled, sharded_cache_h2d_bytes=staged,
        sharded_equals_unsharded=True)
    return launches


# the observability phase: the scoring cell run with spans and the flight
# recorder off and on, in turns (off, on, off, on, ...), this many runs each
OBS_RUNS = 3


def phase_observability(slice_prog):
    """Legs (a)-(e) of the observability layer, the roofline and the
    doctor (the module docstring's phase 11).  Returns the flash launches
    of leg (a)'s runs by instantiation."""
    import tempfile

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch.doctor import render
    from tensorframes_tpu_torch.models import decode, transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    cfg = tfm.TransformerConfig(**DECODE_MODEL, dtype=torch.bfloat16, attn_impl="flash")
    rows, L, blocks = 64, 2048, 8
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (rows, L)).astype(np.int32)
    frame = tft.TensorFrame.from_arrays({"tokens": tokens}, num_blocks=blocks)
    block_rows = rows // blocks
    inst = route_of("flash_fwd", torch.bfloat16, 64)
    card = str(torch.device("cuda", torch.cuda.current_device()))

    def run():
        flash.reset_launches()  # count this run alone
        t0 = time.perf_counter()
        out = tft.map_blocks(slice_prog, frame).to_arrays()  # ends in a D2H sync
        return out, time.perf_counter() - t0, dict(flash.kernel_launches)

    # (a) the scoring cell, spans and recorder off and on in turns
    tft.map_blocks(slice_prog, tft.TensorFrame.from_arrays(
        {"tokens": tokens[:block_rows]})).to_arrays()  # warm-up
    obs.disable()
    obs.disable_trace()
    obs.reset_latency()
    ref = None
    ms = {"off": [], "on": []}
    total = {}
    for i in range(2 * OBS_RUNS):
        mode = "off" if i % 2 == 0 else "on"
        if mode == "off":
            out, sec, launches = run()
        else:
            obs.clear_trace()
            obs.enable()
            obs.enable_trace()
            c0 = obs.counters()
            try:
                with obs.request_ledger(tenant="smoke") as led:
                    out, sec, launches = run()
            finally:
                obs.disable()
                obs.disable_trace()
            delta = obs.counters_delta(c0)
            ledger = {k: led.counters.get(k, 0) for k in delta}
            if ledger != delta:
                raise AssertionError(f"ledger {led.counters} differs from the delta "
                                     f"{ {k: v for k, v in delta.items() if v} }")
            blk = [e for e in obs.trace_events() if e["track"] == card]
            if sorted(e["name"] for e in blk) != sorted(f"map_blocks b{b}" for b in range(blocks)) \
                    or any(e["args"].get("cid") != led.correlation_id for e in blk):
                raise AssertionError(f"{card} track: {[e['name'] for e in blk]}")
            span = obs.last_spans(1)[0]
            if span["verb"] != "map_blocks" or span.get("cid") != led.correlation_id \
                    or not {"validate", "dispatch"} <= set(span["phases_s"]) \
                    or (span["rows"], span["blocks"]) != (rows, blocks):
                raise AssertionError(f"map_blocks span: {span}")
        if launches != {inst: cfg.n_layers * blocks}:
            raise AssertionError(f"observability {mode} run launched {launches}, expected "
                                 f"{{{inst!r}: {cfg.n_layers * blocks}}}")
        if ref is None:
            ref = out
        elif not same_arrays(out, ref):
            raise AssertionError(f"observability {mode} run: outputs differ from the first run")
        ms[mode].append(sec / blocks * 1e3)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    text = obs.metrics_text()
    if f'tfs_verb_latency_seconds_count{{verb="map_blocks"}} {2 * OBS_RUNS}' not in text \
            or 'tfs_request_requests_total{tenant="smoke"}' not in text:
        raise AssertionError("metrics_text lacks the map_blocks latency family or the tenant's")
    say("observability", leg="a_scoring_off_on", rows=rows, tokens_per_row=L, blocks=blocks,
        ms_per_block_off=ms["off"], ms_per_block_on=ms["on"],
        median_off=float(np.median(ms["off"])), median_on=float(np.median(ms["on"])),
        on_over_off=float(np.median(ms["on"]) / np.median(ms["off"])),
        flash_launches_a_run=cfg.n_layers * blocks, nll_bit_identical=True,
        ledger=led.snapshot(), span_phases_s=span["phases_s"], span_total_s=span["total_s"],
        block_events=len(blk), latency=obs.latency_snapshot()["verb:map_blocks"])

    # (b) the Chrome-trace dump of the last "on" run, and one small verb profiled
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.dump_trace(os.path.join(tmp, "trace.json"))
        with open(path) as f:
            dumped = json.load(f)
        tids = {e["args"]["name"]: e["tid"] for e in dumped["traceEvents"]
                if e["ph"] == "M" and e["name"] == "thread_name"}
        on_card = [e for e in dumped["traceEvents"]
                   if e["ph"] == "X" and e["tid"] == tids.get(card)]
        if len(on_card) != blocks or dumped["otherData"]["dropped_events"]:
            raise AssertionError(f"dump_trace: {len(on_card)} events on {card}, tracks "
                                 f"{sorted(tids)}, {dumped['otherData']}")
        prof_dir = os.path.join(tmp, "profile")
        small = tft.TensorFrame.from_arrays({"x": np.arange(4096.0, dtype=np.float32)},
                                            num_blocks=4)
        obs.enable(profile_dir=prof_dir)
        try:
            tft.map_blocks(lambda x: {"z": x * 2}, small).to_arrays()
        finally:
            obs.disable()
        files = [n for n in os.listdir(prof_dir) if n.endswith(".json")]
        if not files:
            raise AssertionError(f"enable(profile_dir) wrote no trace into {prof_dir}")
        say("observability", leg="b_trace_files", tracks=sorted(tids),
            events=len(dumped["traceEvents"]), card_events=len(on_card),
            profile_files=len(files),
            profile_bytes=os.path.getsize(os.path.join(prof_dir, files[0])))

    # (c) the roofline of one scoring block on the card's peaks
    block = torch.from_numpy(tokens[:block_rows]).cuda()
    t0 = time.perf_counter()
    rep = roofline.roofline(slice_prog, {"tokens": block},
                            measured_s=float(np.median(ms["off"])) / 1e3)
    trace_s = time.perf_counter() - t0
    attn = [o for o in rep.ops if o.kind == "attention"]
    want = kernel_bound(dict(B=block_rows, Lq=L, Lk=L, H=cfg.n_heads, KVH=cfg.n_kv_heads,
                             D=cfg.d_model // cfg.n_heads, dtype=torch.bfloat16, causal=True),
                        "flash_fwd")[2]
    if rep.device_kind != torch.cuda.get_device_name(0) or len(attn) != cfg.n_layers \
            or any(o.flops != want for o in attn):
        raise AssertionError(f"roofline on {rep.device_kind}: attention ops "
                             f"{[o.flops for o in attn]}, expected {cfg.n_layers} x {want}")
    say("observability", leg="c_roofline", device=rep.device_kind, source=rep.source,
        seconds=trace_s, ops=len(rep.ops), total_flops=rep.total_flops,
        total_bytes=rep.total_bytes, aggregate_flops=rep.xla_flops,
        attention_flops_each=want, ceiling_mfu=rep.ceiling_mfu, mfu=rep.mfu,
        ceiling_fraction=rep.ceiling_fraction, measured_s=rep.measured_s,
        summary=rep.summary(top=5))

    # (d) one generate at B = 8 under a span (decode config 8's prompts)
    model = slice_prog.params["model"]
    prompt = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (8, DECODE_PROMPT)).astype(np.int32)).cuda()
    decode.generate(model, prompt, cfg, 2)  # warm-up
    torch.cuda.synchronize()
    obs.enable()
    try:
        t0 = time.perf_counter()
        gen = decode.generate(model, prompt, cfg, DECODE_NEW)
        span = obs.last_spans(1)[0]
        gen = gen.cpu()  # the readback: the first wait on the card
        wall = time.perf_counter() - t0
    finally:
        obs.disable()
    if span["verb"] != "generate" or (span["rows"], span["blocks"]) != (8, 1) \
            or set(span["phases_s"]) != {"prefill", "dispatch"} \
            or tuple(gen.shape) != (8, DECODE_PROMPT + DECODE_NEW):
        raise AssertionError(f"generate span {span}, output {tuple(gen.shape)}")
    say("observability", leg="d_generate_span", B=8, prompt=DECODE_PROMPT, new=DECODE_NEW,
        span_phases_s=span["phases_s"], span_total_s=span["total_s"], wall_s=wall,
        readback_s=wall - span["total_s"], host_share=span["total_s"] / wall,
        tokens_per_s=8 * DECODE_NEW / wall)

    # (e) the advisor over this process's state
    diags = tft.doctor()
    say("observability", leg="e_doctor", codes=[d["code"] for d in diags])
    print(render(diags), flush=True)
    return total


# the planner phase: the scoring cell's shape (phase_pipeline's), and config
# 5's logistic regression as a planned epochs loop
PLAN_ROWS, PLAN_L, PLAN_BLOCKS = 64, 2048, 8
PLAN_EPOCHS, PLAN_LR = 4, 0.5
# leg (f): one process warms the scoring program against the compile cache,
# at the flagship's widths cut to this depth (the leg measures the cache and
# the process's warm-up, which more layers only lengthen; its launches are
# the processes', counted nowhere in this one)
COLD_START_LAYERS = 1
COLD_START_CODE = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.models import scoring, transformer as tfm
cfg = tfm.TransformerConfig(**json.loads(sys.argv[1]), dtype=torch.bfloat16, attn_impl="flash")
params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
prog = scoring.scoring_program(params, cfg, fetches=("nll",))
tokens = np.zeros((int(sys.argv[2]), int(sys.argv[3])), np.int32)
c0 = obs.counters()
t1 = time.perf_counter()
fps = tft.warmup(prog, tft.TensorFrame.from_arrays({"tokens": tokens}))
torch.cuda.synchronize()
d = obs.counters_delta(c0)
print(json.dumps(dict(fingerprints=fps, warmup_s=time.perf_counter() - t1,
                      wall_s=time.perf_counter() - t0, **{k: d[k] for k in (
                          "backend_compiles", "persistent_cache_hits",
                          "persistent_cache_misses", "program_traces")})))
"""


def phase_planner(slice_prog):
    """Legs (a)-(f) of the verb-graph planner, the engine's warmup, the
    program artifacts and the compile cache (the module docstring's phase
    12).  Returns the flash launches of the phase's scoring runs by
    instantiation."""
    import tempfile

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.ops import frame_cache
    from tensorframes_tpu_torch.parallel import flash
    from tensorframes_tpu_torch.program import deserialize_program

    eager = tft.Executor()  # engine=: the comparison legs stay eager
    cfg_kw = dict(DECODE_MODEL)
    n_layers = cfg_kw["n_layers"]
    rows, L, blocks = PLAN_ROWS, PLAN_L, PLAN_BLOCKS
    block_rows = rows // blocks
    inst = route_of("flash_fwd", torch.bfloat16, 64)
    want_launches = {inst: n_layers * blocks}
    tokens = np.random.RandomState(12).randint(0, cfg_kw["vocab_size"], (rows, L)).astype(np.int32)
    frame = tft.TensorFrame.from_arrays({"tokens": tokens}, num_blocks=blocks)
    ppl = tft.Program.wrap(lambda nll: {"ppl": torch.exp(nll)}, device="cuda")
    mean = tft.Program.wrap(lambda ppl_input: {"ppl": ppl_input.mean(0)}, device="cuda")
    worst = tft.Program.wrap(lambda ppl_input: {"ppl": ppl_input.amax(0)}, device="cuda")
    total = {}

    def counted(fn):
        """fn() with the flash launches counted over it alone."""
        torch.cuda.synchronize()
        flash.reset_launches()
        c0 = obs.counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(flash.kernel_launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        return out, sec, launches, obs.counters_delta(c0)

    def planned(fr, reduce_prog=mean):
        lz = tft.map_blocks(ppl, tft.map_blocks(slice_prog, fr.lazy()))
        return tft.reduce_blocks(reduce_prog, lz), lz

    def eager_chain(fr, reduce_prog=mean):
        return tft.reduce_blocks(reduce_prog, tft.map_blocks(
            ppl, tft.map_blocks(slice_prog, fr, engine=eager), engine=eager), engine=eager)

    # (a) the flagship scored through a plan, against the eager verbs; then
    # warm plans (the fusion metadata cached) and eager runs in turns, each
    # plan over a new frame object so that no run is a sharing hit
    tft.map_blocks(slice_prog, tft.TensorFrame.from_arrays(
        {"tokens": tokens[:block_rows]})).to_arrays()  # warm-up
    (got, lz), plan_s, launches, d = counted(lambda: planned(frame))
    want, eager_s, e_launches, d_eager = counted(lambda: eager_chain(frame))
    turns = {"eager": [], "planned": []}
    for kind in ("eager", "planned", "planned", "eager"):
        fr = tft.TensorFrame.from_arrays({"tokens": tokens}, num_blocks=blocks)
        run = (lambda: planned(fr)[0]) if kind == "planned" else (lambda: eager_chain(fr))
        out, sec, n, _ = counted(run)
        if n != want_launches or not same_arrays(out, want):
            raise AssertionError(f"{kind} turn: launches {n}, or results unlike the first")
        turns[kind].append(sec / blocks * 1e3)
    rec = lz._last_records[0]
    if launches != want_launches or e_launches != want_launches:
        raise AssertionError(f"planned scoring launched {launches} (eager {e_launches}), "
                             f"expected {want_launches}")
    if not same_arrays(got, want):
        raise AssertionError(f"planned scoring {dict(got)} differs from the eager verbs {want}")
    if d["h2d_bytes_staged"] != tokens.nbytes:
        raise AssertionError(f"planned scoring staged {d['h2d_bytes_staged']} host bytes, "
                             f"expected the tokens' {tokens.nbytes} once")
    if d["plan_fused_dispatches"] != 1 or d["plan_fused_reduces"] != 1:
        raise AssertionError(f"planned scoring counters {d}")
    if (rec["dispatch"], rec["reason"], rec["terminal"]) != (
            "serial", "pool_unavailable", "reduce_blocks"):
        raise AssertionError(f"planned scoring decision {rec}")
    if not np.isfinite(np.asarray(got["ppl"])).all():
        raise AssertionError(f"planned scoring ppl not finite: {dict(got)}")
    say("planner", leg="a_planned_scoring", rows=rows, tokens_per_row=L, blocks=blocks,
        bit_identical=True, flash_launches=launches, h2d_bytes_staged=d["h2d_bytes_staged"],
        eager_h2d_bytes_staged=d_eager["h2d_bytes_staged"],
        plan_fused_dispatches=d["plan_fused_dispatches"],
        plan_fused_reduces=d["plan_fused_reduces"], decision=rec["dispatch"],
        reason=rec["reason"], ppl=float(np.asarray(got["ppl"])),
        first_planned_ms_per_block=plan_s / blocks * 1e3,
        first_eager_ms_per_block=eager_s / blocks * 1e3,
        turns_ms_per_block=turns,
        warm_planned_over_eager=float(np.mean(turns["planned"]) / np.mean(turns["eager"])))

    # (b) explain before execution launches nothing; analyze runs the plan
    # (its own frame: a second chain off (a)'s root would auto-cache it)
    chain = tft.map_blocks(ppl, tft.map_blocks(slice_prog, tft.TensorFrame.from_arrays(
        {"tokens": tokens}, num_blocks=blocks).lazy()))
    text, _, launches, _ = counted(lambda: tft.explain(chain))
    if launches or chain.is_materialized or "fused group 0" not in text:
        raise AssertionError(f"explain launched {launches}:\n{text}")
    report, analyze_s, launches, _ = counted(lambda: tft.explain(chain, analyze=True))
    if launches != want_launches or not all(
            k in report for k in ("wall=", "h2d_bytes=", "request: cid=")):
        raise AssertionError(f"explain(analyze=True) launched {launches}:\n{report}")
    print(report, flush=True)
    say("planner", leg="b_explain", explain_launches=0, analyze_launches=launches,
        analyze_s=analyze_s, lines=len(report.splitlines()))
    del chain

    # (c) sharing: the identical chain while (a)'s result is held runs nothing
    (again, _), _, launches, d = counted(lambda: planned(frame))
    if again is not got or launches or d["plan_cse_hits"] != 1 or d["h2d_bytes_staged"]:
        raise AssertionError(f"shared chain: launches {launches}, counters {d}")
    # ... and two chains off one root auto-cache it, refunded at collection
    gc.collect()
    torch.cuda.synchronize()
    base_budget = frame_cache.budget_bytes_resident()
    base_mem = torch.cuda.memory_allocated()
    fr2 = tft.TensorFrame.from_arrays({"tokens": tokens.copy()}, num_blocks=blocks)
    (first, _), _, _, _ = counted(lambda: planned(fr2))
    (second, lz2), _, launches, d = counted(lambda: planned(fr2, worst))
    cached_bytes = frame_cache.budget_bytes_resident() - base_budget
    held_mem = torch.cuda.memory_allocated() - base_mem
    if launches != want_launches or d["plan_cache_inserts"] != 1 \
            or cached_bytes != tokens.nbytes or lz2._last_records[0]["dispatch"] != "affinity":
        raise AssertionError(f"auto-cache: launches {launches}, counters {d}, "
                             f"{cached_bytes} budget bytes, records {lz2._last_records}")
    want2 = counted(lambda: eager_chain(fr2, worst))[0]
    if not (same_arrays(first, got) and same_arrays(second, want2)):
        raise AssertionError("auto-cached chains differ from the eager verbs")
    del fr2, lz2, first, second
    gc.collect()
    torch.cuda.synchronize()
    left_budget = frame_cache.budget_bytes_resident() - base_budget
    left_mem = torch.cuda.memory_allocated() - base_mem
    if left_budget or left_mem > 0:
        raise AssertionError(f"auto-cache refund: {left_budget} budget bytes and {left_mem} "
                             f"device bytes left after collection")
    say("planner", leg="c_sharing_and_auto_cache", cse_hit_launches=0, cse_hits=1,
        auto_cache_bytes=cached_bytes, device_bytes_held=held_mem,
        budget_bytes_after_gc=left_budget, device_bytes_after_gc=left_mem,
        second_chain_decision="affinity")

    # (d) config 5's logistic regression, PLAN_EPOCHS planned epochs
    rng = np.random.RandomState(0)
    vals = rng.rand(VERB_ROWS, VERB_D).astype(np.float32)
    labels = (vals @ rng.randn(VERB_D).astype(np.float32) > 0).astype(np.float32)

    def row_grads():
        def fn(features, label, w, b):
            err = torch.sigmoid(features @ w + b) - label
            return {"gw": err[:, None] * features, "gb": err}

        return tft.Program.wrap(fn, params={"w": np.zeros(VERB_D, np.float32),
                                            "b": np.zeros((), np.float32)}, device="cuda")

    sums = tft.Program.wrap(lambda gw_input, gb_input: {"gw": gw_input.sum(0),
                                                        "gb": gb_input.sum(0)}, device="cuda")

    def loop(run, prog):
        w, b, out = np.zeros(VERB_D, np.float32), np.float32(0.0), []

        def step(root, e):
            nonlocal w, b
            prog.update_params(w=w, b=b)
            c0 = obs.counters()
            t0 = time.perf_counter()
            g = tft.reduce_blocks(sums, tft.map_blocks(prog, root)) if run == "plan" else \
                tft.reduce_blocks(sums, tft.map_blocks(prog, root, engine=eager), engine=eager)
            sec = time.perf_counter() - t0
            w = (w - np.float32(PLAN_LR) * g["gw"] / np.float32(VERB_ROWS)).astype(np.float32)
            b = np.float32(b - np.float32(PLAN_LR) * g["gb"] / np.float32(VERB_ROWS))
            out.append(dict(w=w.copy(), h2d=obs.counters_delta(c0)["h2d_bytes_staged"], s=sec))
            return out[-1]

        lframe = tft.TensorFrame.from_arrays({"features": vals, "label": labels},
                                             num_blocks=VERB_BLOCKS)
        if run == "plan":
            tft.iterate_epochs(lframe, step, PLAN_EPOCHS)
        else:
            for e in range(PLAN_EPOCHS):
                step(lframe, e)
        return out

    ref = loop("eager", row_grads())
    got_epochs = loop("plan", row_grads())
    if not all(np.array_equal(a["w"], r["w"]) for a, r in zip(got_epochs, ref)):
        raise AssertionError("planned epochs differ from the eager loop")
    if any(e["h2d"] for e in got_epochs[1:]) or not np.isfinite(got_epochs[-1]["w"]).all():
        raise AssertionError(f"planned epochs staged {[e['h2d'] for e in got_epochs]} bytes")
    say("planner", leg="d_iterate_epochs", rows=VERB_ROWS, width=VERB_D, blocks=VERB_BLOCKS,
        epochs=PLAN_EPOCHS, bit_identical=True,
        planned_h2d_bytes=[e["h2d"] for e in got_epochs], eager_h2d_bytes=[e["h2d"] for e in ref],
        planned_ms_per_epoch=[e["s"] * 1e3 for e in got_epochs],
        eager_ms_per_epoch=[e["s"] * 1e3 for e in ref])
    del vals, labels, ref, got_epochs

    # (e) the scoring program, cut to COLD_START_LAYERS layers (the export's
    # seconds grow with the depth), serialized and deserialized, run through
    # map_blocks against itself live
    cut_cfg = tfm.TransformerConfig(**dict(cfg_kw, n_layers=COLD_START_LAYERS),
                                    dtype=torch.bfloat16, attn_impl="flash")
    cut_prog = scoring.scoring_program(
        tfm.init(torch.Generator(device="cuda").manual_seed(0), cut_cfg), cut_cfg,
        fetches=("nll",))
    t0 = time.perf_counter()
    data = cut_prog.serialize({"tokens": (tft.scalar_type("int32"), (-1, L))})
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = deserialize_program(data)
    load_s = time.perf_counter() - t0
    live = counted(lambda: tft.map_blocks(cut_prog, frame).to_arrays())[0]
    out, back_s, launches, _ = counted(lambda: tft.map_blocks(back, frame).to_arrays())
    if launches != {inst: COLD_START_LAYERS * blocks}:
        raise AssertionError(f"deserialized program launched {launches}, expected "
                             f"{ {inst: COLD_START_LAYERS * blocks} }")
    nll_err = float(np.abs(np.asarray(out["nll"], np.float64)
                           - np.asarray(live["nll"], np.float64)).max())
    if nll_err > 1e-5 or not np.isfinite(np.asarray(out["nll"])).all():
        raise AssertionError(f"deserialized program nll differs by {nll_err}")
    say("planner", leg="e_serialize", layers=COLD_START_LAYERS, artifact_bytes=len(data),
        export_s=export_s,
        load_s=load_s, flash_launches=launches, nll_bit_identical=nll_err == 0.0,
        nll_max_abs_err=nll_err, ms_per_block=back_s / blocks * 1e3)
    del data, back, cut_prog

    # (f) cold start: two processes warm the scoring program on one block
    # against one fresh compile cache; the second runs no nvcc
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, TFS_COMPILE_CACHE=os.path.join(tmp, "cc"))
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", COLD_START_CODE,
                 json.dumps(dict(cfg_kw, n_layers=COLD_START_LAYERS)), str(block_rows),
                 str(L)], cwd=root, env=env, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"cold-start process failed:\n{proc.stderr[-4000:]}")
            runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                             process_s=time.perf_counter() - t0))
        kernels = sorted(os.listdir(os.path.join(tmp, "cc", "kernels")))
    cold, warm = runs
    if cold["backend_compiles"] < 1 or warm["backend_compiles"] != 0 \
            or warm["persistent_cache_hits"] < 1 or cold["fingerprints"] != warm["fingerprints"]:
        raise AssertionError(f"cold start: {runs}")
    say("planner", leg="f_cold_start", layers=COLD_START_LAYERS, first=cold, second=warm,
        kernel_files=kernels,
        first_over_second=cold["process_s"] / warm["process_s"])
    return total


STREAM_DOCS, STREAM_PARTITIONS = 16, 4
STREAM_JOB, STREAM_KILL = "smoke-stream-reduce", "proc_kill:window=2:phase=mid"
CHUNK_ROWS, CHUNK_D = 1_048_576, 64  # leg (e): one 256 MiB f32 block
PACK_ROWS, PACK_CELL = 1_000_000, 16  # leg (f)
# leg (c)'s children: each runs ``durable_child`` of this script
DURABLE_CHILD_CODE = "import sys, chip_smoke; chip_smoke.durable_child(sys.argv[1])"


def stream_source():
    """The streaming phase's frame: the planner phase's tokens, a row id
    (0..63) and 16 doc keys, in the planner phase's 8 blocks."""
    import tensorframes_tpu_torch as tft

    tokens = np.random.RandomState(12).randint(
        0, DECODE_MODEL["vocab_size"], (PLAN_ROWS, PLAN_L)).astype(np.int32)
    row = np.arange(PLAN_ROWS, dtype=np.int64)
    return tft.TensorFrame.from_arrays({"tokens": tokens, "row": row, "doc": row % STREAM_DOCS},
                                       num_blocks=PLAN_BLOCKS)


def stream_mean():
    """Leg (c)'s reduce: the mean of ``nll`` a block, re-applied to the
    stacked block means (the one fold shape)."""
    import tensorframes_tpu_torch as tft

    return tft.Program.wrap(lambda nll_input: {"nll": nll_input.mean(0)}, device="cuda")


def durable_child(job_id: str) -> None:
    """Leg (c)'s child process: the flagship (phase 5's widths and seed)
    scores the shuffled stream into the journaled ``reduce_blocks`` of
    ``job_id`` (``TFS_JOURNAL_DIR``, ``TFS_SPILL_DIR`` and
    ``TFS_FAULT_INJECT`` come from its environment).  It prints the
    counters after its warm-up block (all its kernel loads), then, unless
    the journal's fault kills it, the result's bytes and its counters."""
    t0 = time.perf_counter()
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import observability as obs, relational, streaming
    from tensorframes_tpu_torch.models import scoring, transformer as tfm

    keys = ("backend_compiles", "persistent_cache_hits", "journal_resumes",
            "journal_windows_skipped", "journal_appends", "stream_windows")
    c0 = obs.counters()
    cfg = tfm.TransformerConfig(**DECODE_MODEL, dtype=torch.bfloat16, attn_impl="flash")
    prog = scoring.scoring_program(tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg),
                                   cfg, fetches=scoring.FETCHES)
    frame = stream_source()
    tft.map_blocks(prog, tft.TensorFrame.from_arrays(
        {"tokens": frame.column("tokens").data[:8]})).to_arrays()  # warm-up
    d = obs.counters_delta(c0)
    print(json.dumps({"stage": "warm", **{k: d[k] for k in keys}}), flush=True)
    sh = relational.shuffle(frame, "doc", partitions=STREAM_PARTITIONS)
    out = streaming.reduce_blocks(stream_mean(), sh.stream().map_blocks(prog), job_id=job_id)
    torch.cuda.synchronize()
    d = obs.counters_delta(c0)
    print(json.dumps({"stage": "done", "nll": np.asarray(out["nll"]).tobytes().hex(),
                      "wall_s": time.perf_counter() - t0, **{k: d[k] for k in keys}}), flush=True)


def phase_streaming(slice_prog):
    """Legs (a)-(f) of the host-side data layers (the module docstring's
    phase 13).  Returns the flash launches of the phase's scoring runs by
    instantiation."""
    import tempfile

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import _build, native, observability as obs
    from tensorframes_tpu_torch import relational, streaming
    from tensorframes_tpu_torch.ops import engine
    from tensorframes_tpu_torch.parallel import flash
    from tensorframes_tpu_torch.streaming import CollectSink
    from tensorframes_tpu_torch.streaming.reader import frame_host_bytes

    doctor_mod = sys.modules["tensorframes_tpu_torch.doctor"]
    eager = tft.Executor()
    n_layers = DECODE_MODEL["n_layers"]
    inst = route_of("flash_fwd", torch.bfloat16, 64)
    ppl = tft.Program.wrap(lambda nll: {"ppl": torch.exp(nll)}, device="cuda")
    total = {}

    def counted(fn):
        torch.cuda.synchronize()
        flash.reset_launches()
        c0 = obs.counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(flash.kernel_launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        return out, sec, launches, obs.counters_delta(c0)

    frame = stream_source()
    saved = {k: os.environ.get(k) for k in ("TFS_SPILL_DIR", "TFS_PLAN")}
    tmp = tempfile.TemporaryDirectory()
    os.environ["TFS_SPILL_DIR"] = os.path.join(tmp.name, "spill")
    try:
        # (a) the flagship scored over a shuffle: each partition's stream
        # through streamed map_blocks into a CollectSink
        obs.reset_peak_host_bytes()
        c_sh = obs.counters()
        sh = relational.shuffle(frame, "doc", partitions=STREAM_PARTITIONS)
        d_sh = obs.counters_delta(c_sh)
        windows, per_window_ms, spill_read = [], [], 0
        for p in range(STREAM_PARTITIONS):
            out, sec, launches, d = counted(lambda: streaming.map_blocks(
                slice_prog, sh.partition(p), sink=CollectSink()))
            if out is None:
                continue
            windows.append((p, out, launches))
            per_window_ms.append(sec * 1e3)
            spill_read += d["spill_bytes_read"]
        peak = obs.counters()["peak_host_bytes"]
        rows = np.concatenate([np.asarray(o.column("row").data) for _, o, _ in windows])
        if sorted(rows.tolist()) != list(range(PLAN_ROWS)):
            raise AssertionError(f"streamed scoring rows {sorted(rows.tolist())}")
        window_bytes = []
        for p, out, launches in windows:
            (wf,) = list(sh.partition(p).windows())  # one run: one window
            window_bytes.append(frame_host_bytes(wf))
            ref = tft.map_blocks(slice_prog, wf, engine=eager).to_arrays()["nll"]
            if not np.array_equal(np.asarray(out.column("nll").data), ref):
                raise AssertionError(f"partition {p}: streamed nll differs from eager map_blocks")
            if launches != {inst: n_layers * wf.num_blocks}:
                raise AssertionError(f"partition {p}: launches {launches}, expected "
                                     f"{n_layers * wf.num_blocks} of {inst}")
            if not np.isfinite(np.asarray(out.column("nll").data)).all():
                raise AssertionError(f"partition {p}: nll not finite")
        bound = 2 * max(window_bytes) + frame_host_bytes(frame)
        if not 0 < peak <= bound:
            raise AssertionError(f"peak_host_bytes {peak} beyond two windows + the frame {bound}")
        say("streaming", leg="a_streamed_scoring_over_shuffle", windows=len(windows),
            window_rows=[o.num_rows for _, o, _ in windows], ms_per_window=per_window_ms,
            ms_per_8_rows=[ms * 8 / o.num_rows for ms, (_, o, _) in zip(per_window_ms, windows)],
            flash_launches=sum(sum(n.values()) for _, _, n in windows), bit_identical=True,
            rows_once=True, peak_host_bytes=peak, peak_bound=bound,
            spill_bytes_written=d_sh["spill_bytes_written"], spill_bytes_read=spill_read,
            shuffle_partitions_written=d_sh["shuffle_partitions_written"])

        # (b) the planned streamed chain, against the eager streamed chain
        def chain():
            return [wf.to_arrays()["ppl"]
                    for wf in sh.stream().map_blocks(slice_prog).map_blocks(ppl).windows()]

        os.environ["TFS_PLAN"] = "0"
        eager_ppl, eager_s, _, _ = counted(chain)
        os.environ["TFS_PLAN"] = "1"
        planned_ppl, plan_s, launches, d = counted(chain)
        os.environ["TFS_PLAN"] = "0"
        n_win = len(windows)
        if len(planned_ppl) != n_win or not all(
                np.array_equal(a, b) for a, b in zip(planned_ppl, eager_ppl)):
            raise AssertionError("planned streamed chain differs from the eager streamed chain")
        if d["plan_stream_windows"] != n_win or d["plan_fused_dispatches"] != n_win:
            raise AssertionError(f"planned streamed chain counters {d}")
        if launches != {inst: n_layers * n_win}:
            raise AssertionError(f"planned streamed chain launched {launches}")
        say("streaming", leg="b_planned_streamed_chain", windows=n_win, bit_identical=True,
            plan_stream_windows=d["plan_stream_windows"],
            plan_fused_dispatches=d["plan_fused_dispatches"], planned_s=plan_s,
            eager_s=eager_s, flash_launches=launches)

        # (c) the journaled streamed reduce across a process death: two
        # children against one journal, the first killed at a boundary
        (ref, ref_s, _, _) = counted(lambda: streaming.reduce_blocks(
            stream_mean(), sh.stream().map_blocks(slice_prog)))
        ref_hex = np.asarray(ref["nll"]).tobytes().hex()
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, TFS_JOURNAL_DIR=os.path.join(tmp.name, "journal"),
                   TFS_SPILL_DIR=os.path.join(tmp.name, "child-spill"))
        env.pop("TFS_COMPILE_CACHE", None)  # the kernels load from the checkout's build
        runs = []
        for fault in (STREAM_KILL, ""):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", DURABLE_CHILD_CODE, STREAM_JOB], cwd=root,
                env=dict(env, TFS_FAULT_INJECT=fault), capture_output=True, text=True,
                timeout=600)
            lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
            runs.append(dict(rc=proc.returncode, wall_s=time.perf_counter() - t0, lines=lines,
                             stderr=proc.stderr[-3000:]))
        killed, resumed = runs
        if killed["rc"] != -signal.SIGKILL or [x["stage"] for x in killed["lines"]] != ["warm"]:
            raise AssertionError(f"the first child did not die by SIGKILL after its warm-up: "
                                 f"{killed}")
        if resumed["rc"] != 0 or resumed["lines"][-1]["stage"] != "done":
            raise AssertionError(f"the resuming child failed: {resumed}")
        done = resumed["lines"][-1]
        if done["nll"] != ref_hex:
            raise AssertionError(f"resumed result {done['nll']} differs from the parent's "
                                 f"uninterrupted {ref_hex}")
        if (done["journal_resumes"], done["journal_windows_skipped"]) != (1, 2) \
                or killed["lines"][0]["backend_compiles"] or done["backend_compiles"]:
            raise AssertionError(f"children counters: {killed['lines']} / {done}")
        say("streaming", leg="c_durable_reduce_across_sigkill", fault=STREAM_KILL,
            killed_rc=killed["rc"], killed_wall_s=killed["wall_s"],
            resumed_wall_s=resumed["wall_s"], resumed_in_child_s=done["wall_s"],
            parent_uninterrupted_s=ref_s, bytes_equal=True,
            nll_mean=float(np.frombuffer(bytes.fromhex(ref_hex), np.float32)[0]),
            journal_resumes=done["journal_resumes"],
            journal_windows_skipped=done["journal_windows_skipped"],
            backend_compiles=[killed["lines"][0]["backend_compiles"], done["backend_compiles"]],
            persistent_cache_hits=[killed["lines"][0]["persistent_cache_hits"],
                                   done["persistent_cache_hits"]])

        # (d) the scored windows joined with a doc -> weight table, both ways,
        # then a streamed aggregate of weight * nll by doc.  The products
        # (f32 nll ~ 9, integer weights <= 16) and their sums over 64 rows
        # fit f64's mantissa, so every association gives the same bytes
        weights = tft.TensorFrame.from_arrays({
            "doc": np.arange(STREAM_DOCS, dtype=np.int64),
            "weight": np.arange(1, STREAM_DOCS + 1, dtype=np.float64)})
        wmul = tft.Program.wrap(lambda nll, weight: {"wnll": nll.double() * weight},
                                device="cuda")
        wsum = tft.Program.wrap(lambda wnll_input: {"wnll": wnll_input.sum(0)}, device="cuda")
        scored = tft.TensorFrame.from_blocks(
            [{n: v for n, v in o.block(bi).items()} for _, o, _ in windows
             for bi in range(o.num_blocks)])
        joined = relational.join_frames(scored, weights, "doc")
        want = tft.aggregate(wsum, tft.group_by(
            tft.map_blocks(wmul, joined, engine=eager), "doc"), engine=eager).to_arrays()
        got = {}
        for strategy in ("broadcast", "sort_merge"):
            js = relational.join(sh.stream().map_blocks(slice_prog), weights, on="doc",
                                 strategy=strategy, partitions=STREAM_PARTITIONS)
            out, sec, launches, _ = counted(lambda: streaming.aggregate(
                wsum, js.map_blocks(wmul).group_by("doc")).to_arrays())
            if not same_arrays(out, want):
                raise AssertionError(f"{strategy} join + streamed aggregate differs from "
                                     f"join_frames + eager aggregate")
            got[strategy] = dict(seconds=sec, flash_launches=launches)
        stats = relational.recent_shuffle_stats()
        if not stats or doctor_mod._read_section("shuffles", []) != stats \
                or stats[-1]["key"] != "doc":
            raise AssertionError(f"doctor's shuffles section {stats}")
        say("streaming", leg="d_joins_and_streamed_aggregate", bit_identical=True, groups=len(
            want["doc"]), strategies=got, doctor_shuffles=stats[-1],
            wnll_total=float(want["wnll"].sum()))
        sh.release()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()

    # (e) one 256 MiB block through a row-independent map_blocks: config 5's
    # logistic prediction, in 64 MiB chunks and whole.  It is spelled as a
    # product and a sum over the features: a matrix product is outside the
    # row-independence whitelist in both packages, so ``x @ w`` would run
    # whole
    rng = np.random.RandomState(5)
    x = rng.rand(CHUNK_ROWS, CHUNK_D).astype(np.float32)
    pred = tft.Program.wrap(lambda features, w: {"p": torch.sigmoid((features * w).sum(-1))},
                            params={"w": rng.randn(CHUNK_D).astype(np.float32)}, device="cuda")
    block = tft.TensorFrame.from_arrays({"features": x})
    chunked, whole = tft.Executor(), tft.Executor()
    whole.stream_chunk_bytes = 0
    legs = {}
    for name, ex in (("chunked", chunked), ("whole", whole), ("whole", whole),
                     ("chunked", chunked), ("chunked", chunked), ("whole", whole)):
        out, sec, _, d = counted(lambda: ex.map_blocks(pred, block).column("p").data)
        rec = engine.last_verb_stats()["prefetch"]
        leg = legs.setdefault(name, dict(ms=[], out=out, h2d_bytes=d["h2d_bytes_staged"],
                                         chunks=rec["items"], overlap=[]))
        leg["ms"].append(sec * 1e3)
        leg["overlap"].append(rec["overlap_ratio"])
    want_chunks = -(-x.nbytes // chunked.stream_chunk_bytes)
    if legs["chunked"]["chunks"] != want_chunks:
        raise AssertionError(f"chunked block ran {legs['chunked']['chunks']} chunks, expected "
                             f"{want_chunks}")
    err = float((legs["chunked"]["out"] - legs["whole"]["out"]).abs().max())
    if err > 1e-6:
        raise AssertionError(f"chunked against whole: max |diff| {err} > 1e-6")
    say("streaming", leg="e_chunked_block_streaming", rows=CHUNK_ROWS, width=CHUNK_D,
        block_bytes=x.nbytes, chunk_bytes=chunked.stream_chunk_bytes,
        chunks=legs["chunked"]["chunks"], bit_identical=err == 0.0, max_abs_err=err,
        chunked_ms=legs["chunked"]["ms"], whole_ms=legs["whole"]["ms"],
        chunked_h2d_bytes=legs["chunked"]["h2d_bytes"], whole_h2d_bytes=legs["whole"]["h2d_bytes"],
        chunked_overlap_ratio=legs["chunked"]["overlap"],
        whole_overlap_ratio=legs["whole"]["overlap"])
    del x, block, legs

    # (f) the native packer: from_rows over a million rows of 16-float lists
    first = time.perf_counter()
    tft.TensorFrame.from_rows([{"v": [0.5] * PACK_CELL}])  # the first use builds
    first_s = time.perf_counter() - first
    rows = [{"v": r} for r in np.random.RandomState(6).rand(PACK_ROWS, PACK_CELL).tolist()]
    t0 = time.perf_counter()
    packed = tft.TensorFrame.from_rows(rows)
    packed_s = time.perf_counter() - t0
    saved_native, native._native = native._native, None  # the numpy path
    try:
        t0 = time.perf_counter()
        plain = tft.TensorFrame.from_rows(rows)
        plain_s = time.perf_counter() - t0
    finally:
        native._native = saved_native
    a, b = packed.column("v").data, plain.column("v").data
    if not (a.dtype == b.dtype and np.array_equal(a, b)
            and repr(packed.schema.explain()) == repr(plain.schema.explain())):
        raise AssertionError("packed from_rows differs from the numpy path")
    say("streaming", leg="f_native_packer", rows=PACK_ROWS, cell=PACK_CELL, identical=True,
        packer_s=packed_s, numpy_s=plain_s, numpy_over_packer=plain_s / packed_s,
        gxx_build_s=_build.host_build_seconds.get("packer"), first_use_s=first_s)
    return total


# --- the mesh executor and multi-host (phase 16) -------------------------------
MESH_POSITIONS = 8  # legs (a2) and (b2): data-axis positions held on the one card
MESH_CHILD_CODE = "import sys, chip_smoke; chip_smoke.mesh_child(*sys.argv[1:])"
MESH_CHILD_TIMEOUT_S = 150
# the fused drivers against the eager ones over the mesh: the CPU twins'
# tolerances (tests/test_torch_mesh_twins.py::test_fused_models_on_mesh)
MESH_FIT_RTOL, MESH_CENTERS_RTOL = 1e-5, 1e-6


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_rows():
    """Config 2's rows (phase_verbs' first draw)."""
    return np.random.RandomState(0).rand(VERB_ROWS, VERB_D).astype(np.float32)


def mesh_child(rank, world, port, backend, device="cuda", card="") -> None:
    """Leg (d)'s child (and ``tools/mesh_multicard.py``'s ranks): rank
    ``rank`` of a ``world``-process group over ``backend`` on ``device``.
    Its data mesh is the default one, the rank's share of the host's cards
    (``card`` names one card to hold instead, which every rank may name).
    It builds a process-local frame of its share of config 2's rows and
    runs the cross-process ``reduce_blocks`` sum over the data mesh, then
    prints one JSON line: the seconds to form the group and of the reduce,
    the result's bytes, the host detours, or the error it met."""
    import datetime

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.ops import device_pool
    from tensorframes_tpu_torch.parallel import MeshExecutor, data_mesh, multihost

    rank, world = int(rank), int(world)
    dev = torch.device(device)
    if dev.type == "cpu":
        device_pool._local_devices = lambda: [dev]
    res = {"rank": rank, "backend": backend}
    t0 = time.perf_counter()
    try:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, backend=backend,
                             timeout=datetime.timedelta(seconds=60))
        res["init_s"] = time.perf_counter() - t0
        # the first collective: every rank's device count
        mesh = data_mesh(devices=[torch.device(device, int(card))] if card else None)
        res["group_s"] = time.perf_counter() - t0
        res["devices"] = [str(d) for d in mesh.devices]
        share = VERB_ROWS // world
        frame = multihost.frame_from_process_local(
            {"v": mesh_rows()[rank * share:(rank + 1) * share]}, mesh)
        prog = tft.Program.wrap(lambda v_input: {"v": v_input.sum(0)}, device=mesh.device)
        eng = MeshExecutor(mesh)
        eng.reduce_blocks(prog, frame)  # warm-up
        t1 = time.perf_counter()
        out = eng.reduce_blocks(prog, frame)
        res.update(reduce_s=time.perf_counter() - t1, v=np.asarray(out["v"]).tobytes().hex(),
                   process_count=multihost.process_count(), mesh_size=mesh.shape["dp"],
                   process_rows=list(frame.process_rows), host_detours=multihost.host_detours)
    except Exception as e:  # noqa: BLE001 - the refusal is the finding
        res.update(error=f"{type(e).__name__}: {e}"[:600], wall_s=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)
        os._exit(3)  # a failed group may not tear down cleanly
    res["wall_s"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    multihost.shutdown()


def _start_group(world, backend, device, root, card=""):
    """``world`` children forming one group (started, not awaited)."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("TFS_COMPILE_CACHE", None)  # nothing to build: the verbs launch no kernel
    return [subprocess.Popen(
        [sys.executable, "-c", MESH_CHILD_CODE, str(r), str(world), str(port), backend, device,
         card],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _collect_group(procs):
    """The children's JSON lines in rank order, each with its return code
    and stderr tail; a child past ``MESH_CHILD_TIMEOUT_S`` is killed."""
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=MESH_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            se += f"\n(killed after {MESH_CHILD_TIMEOUT_S} s)"
        lines = [json.loads(x) for x in so.splitlines() if x.startswith("{")]
        out.append(dict(lines[-1] if lines else {}, rc=p.returncode, stderr=se[-1500:]))
    return out


def phase_mesh(slice_prog, slice_frame, device="cuda"):
    """Legs (a)-(d) of the mesh executor and the multi-process runtime on
    one card (the module docstring's phase 16).  Returns the flash launches
    of the phase's scoring runs by instantiation."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.models import kmeans, logistic_regression as lr
    from tensorframes_tpu_torch.ops.validation import ValidationError
    from tensorframes_tpu_torch.parallel import MeshExecutor, data_mesh, flash, multihost
    from tensorframes_tpu_torch.parallel.mesh import Mesh

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = data_mesh()
    if mesh.shape["dp"] != 1 or multihost.process_count() != 1:
        raise AssertionError(f"mesh: one card, one process expected; got {mesh}")
    engines = {"global": MeshExecutor(mesh), "per_block": MeshExecutor(mesh, mode="per_block")}
    serial = tft.Executor()
    n_layers = DECODE_MODEL["n_layers"]
    inst = route_of("flash_fwd", torch.bfloat16, 64)
    total = {}

    def one_block(frame):
        return tft.TensorFrame(list(frame.columns), (0, frame.num_rows))

    def scored(fn):
        sync()
        flash.reset_launches()
        t0 = time.perf_counter()
        out = fn().to_arrays()  # ends in a D2H sync
        sec = time.perf_counter() - t0
        return out, sec, dict(flash.kernel_launches)

    def count(launches, want):
        if on_card and launches != want:
            raise AssertionError(f"mesh: flash launches {launches}, expected {want}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # (a) the flagship's scoring block through the mesh executor, both
    # modes, against the serial executor over the same rows as one block
    rows = slice_frame.num_rows
    tokens = slice_frame.column("tokens").data.shape[1]
    one = one_block(slice_frame)
    scored(lambda: serial.map_blocks(slice_prog, one))  # warm-up at this shape
    ref, ref_s, _ = scored(lambda: serial.map_blocks(slice_prog, one))
    for mode, eng in engines.items():
        out, sec, launches = scored(lambda: tft.map_blocks(slice_prog, slice_frame, engine=eng))
        if not all(np.array_equal(out[k], ref[k]) for k in ref):
            raise AssertionError(f"mesh scoring ({mode}) differs from the serial executor")
        count(launches, {inst: n_layers})
        say("mesh", leg=f"a_score_{mode}", rows=rows, tokens_per_row=tokens, mesh_size=1,
            bit_identical=True, flash_launches=launches, ms_per_block=sec * 1e3,
            serial_ms_per_block=ref_s * 1e3, mesh_over_serial=sec / ref_s)
    # (a2) per_block over MESH_POSITIONS positions held on the one card: the
    # shard and gather code on the card, one 8-row shard a position, as the
    # slice's 8 blocks
    pos = Mesh(("dp",), (MESH_POSITIONS,), dev, (dev,))
    eng8 = MeshExecutor(pos, mode="per_block")
    ref8, ref8_s, _ = scored(lambda: serial.map_blocks(slice_prog, slice_frame))
    out8, s8, launches = scored(lambda: tft.map_blocks(slice_prog, slice_frame, engine=eng8))
    count(launches, {inst: n_layers * MESH_POSITIONS})
    err8 = max(float(np.abs(out8[k].astype(np.float64) - ref8[k]).max()) for k in ref8)
    if not err8 <= NLL_TOL:
        raise AssertionError(f"mesh scoring over {MESH_POSITIONS} positions: {err8} > {NLL_TOL}")
    say("mesh", leg="a2_score_per_block_positions", positions=MESH_POSITIONS,
        bit_identical_to_serial_blocks=all(np.array_equal(out8[k], ref8[k]) for k in ref8),
        max_abs_err=err8, tol=NLL_TOL, flash_launches=launches, ms_per_block=s8 / 8 * 1e3,
        serial_ms_per_block=ref8_s / 8 * 1e3)

    # (b) the other verbs over config 2's, config 5's and the k-means frames
    vals = mesh_rows()
    frame = tft.TensorFrame.from_arrays({"v": vals}, num_blocks=VERB_BLOCKS)
    lr_rng = np.random.RandomState(5)
    labels = (vals @ lr_rng.randn(VERB_D).astype(np.float32) > 0).astype(np.float32)
    lframe = tft.TensorFrame.from_arrays({"features": vals, "label": labels},
                                         num_blocks=VERB_BLOCKS)
    kr = np.random.RandomState(1)
    true = kr.randn(KMEANS_K, KMEANS_D) * 10
    cluster = kr.randint(0, KMEANS_K, KMEANS_N)
    pts = (true[cluster] + kr.randn(KMEANS_N, KMEANS_D)).astype(np.float32)
    kframe = tft.TensorFrame.from_arrays({"points": pts, "cluster": cluster.astype(np.int32)},
                                         num_blocks=VERB_BLOCKS)
    seq = tft.TensorFrame.from_arrays({"v": vals[:SEQ_ROWS]}, num_blocks=VERB_BLOCKS)
    pair = lambda v_1, v_2: {"v": v_1 + v_2}  # noqa: E731
    on = dict(device=dev)
    verbs = {
        "reduce_blocks_sum": (VERB_ROWS, lambda e, f=frame: tft.reduce_blocks(
            lambda v_input: {"v": v_input.sum(0)}, f, engine=e, **on)),
        "reduce_rows_tree": (VERB_ROWS, lambda e, f=frame: tft.reduce_rows(
            pair, f, engine=e, **on)),
        "reduce_rows_sequential": (SEQ_ROWS, lambda e, f=seq: tft.reduce_rows(
            pair, f, mode="sequential", engine=e, **on)),
        "map_rows_sumsq": (VERB_ROWS, lambda e, f=frame: tft.map_rows(
            lambda v: {"n": (v * v).sum()}, f, engine=e, **on).to_arrays()),
        "aggregate_segment_config5": (VERB_ROWS, lambda e, f=lframe: tft.aggregate(
            lambda features_input: {"features": features_input.sum(0)},
            f.group_by("label"), engine=e, **on).to_arrays()),
        "aggregate_segment_kmeans": (KMEANS_N, lambda e, f=kframe: tft.aggregate(
            lambda points_input: {"points": points_input.amax(0)},
            f.group_by("cluster"), engine=e, **on).to_arrays()),
    }
    for name, (n_rows, run) in verbs.items():
        # the serial reference: the same verb over the rows as one block
        ref, ref_s = timed(lambda: run(_Reblocked(serial)))
        for mode, eng in engines.items():
            got, sec = timed(lambda: run(eng))
            if not same_arrays(got, ref):
                raise AssertionError(f"mesh {name} ({mode}) differs from the serial executor")
            say("mesh", leg=f"b_{name}", mode=mode, rows=n_rows, bit_identical=True,
                mrows_per_s=n_rows / sec / 1e6, serial_mrows_per_s=n_rows / ref_s / 1e6)
    # (b2) the split paths over MESH_POSITIONS positions on the card, global
    # mode: against the serial executor over the same rows in that many
    # equal blocks (the same fold of the same partials where the verb folds)
    glob8 = MeshExecutor(pos)
    for name in ("reduce_blocks_sum", "reduce_rows_tree", "map_rows_sumsq",
                 "aggregate_segment_config5", "aggregate_segment_kmeans"):
        n_rows, run = verbs[name]
        ref = run(_Reblocked(serial, MESH_POSITIONS))
        got, sec = timed(lambda: run(glob8))
        floats = [k for k in ref if np.asarray(ref[k]).dtype.kind == "f"]
        err = check_results(f"mesh {name} over {MESH_POSITIONS} positions", got, ref, SUM_RTOL,
                            keys=floats)
        exact = {k: ref[k] for k in ref if k not in floats}  # keys and integers
        if not same_arrays({k: got[k] for k in exact}, exact):
            raise AssertionError(f"mesh {name} over positions: {sorted(exact)} differ")
        say("mesh", leg=f"b2_{name}_positions", positions=MESH_POSITIONS, rows=n_rows,
            bit_identical=same_arrays(got, ref), max_abs_err=err, rtol=SUM_RTOL,
            mrows_per_s=n_rows / sec / 1e6)

    # (c) the fused chains over the mesh against the eager mesh fits
    eng = engines["global"]
    (pf, lf), fused_s = timed(lambda: lr.fit_fused(lframe, num_iters=LOGREG_STEPS, lr=0.5,
                                                   engine=eng))
    (pe, le), eager_s = timed(lambda: lr.fit(lframe, LOGREG_STEPS, 0.5, engine=eng))
    e_w = check_results("mesh logreg fit_fused vs fit", {"w": pf["w"].numpy()},
                        {"w": pe["w"].cpu().numpy()}, MESH_FIT_RTOL, MESH_FIT_RTOL)
    e_l = check_results("mesh logreg losses", {"l": np.array(lf)}, {"l": np.array(le)},
                        MESH_FIT_RTOL)
    init = pts[:KMEANS_K].astype(np.float64)
    (cf, af), kf_s = timed(lambda: kmeans.fit_fused(kframe, KMEANS_K, KMEANS_STEPS,
                                                    init_centers=init, engine=eng))
    (ce, ae), ke_s = timed(lambda: kmeans.fit(kframe, KMEANS_K, KMEANS_STEPS, "preagg",
                                              init_centers=init, engine=eng))
    e_c = check_results("mesh kmeans fit_fused vs fit", {"c": cf}, {"c": ce}, MESH_CENTERS_RTOL)
    if not np.array_equal(af, ae):
        raise AssertionError("mesh kmeans: fit_fused assigns points unlike fit")
    try:
        lr.fit_fused(lframe, num_iters=1, lr=0.5, engine=engines["per_block"])
        raise AssertionError("mesh: a per_block engine composed with a fused chain")
    except ValidationError as e:
        refusal = str(e)
    say("mesh", leg="c_fused_chains", logreg_rows=VERB_ROWS, logreg_steps=LOGREG_STEPS,
        logreg_fused_s=fused_s, logreg_eager_s=eager_s, w_max_abs_err=e_w, loss_max_abs_err=e_l,
        kmeans_rows=KMEANS_N, kmeans_steps=KMEANS_STEPS, kmeans_fused_s=kf_s,
        kmeans_eager_s=ke_s, centers_max_abs_err=e_c, assignments_equal=True,
        rtol=[MESH_FIT_RTOL, MESH_CENTERS_RTOL], per_block_refused=refusal[:80])

    # (d) the process group on the card: NCCL at world size 1 in this
    # process, then two children sharing the card, over NCCL (both name
    # card 0, as the default mesh refuses it: NCCL is expected to refuse
    # two ranks on one GPU) and over gloo (the cross-process reduce)
    if on_card:
        t0 = time.perf_counter()
        multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
        try:
            backend = torch.distributed.get_backend()
            init_s = time.perf_counter() - t0
            if multihost.process_count() != 1 or backend != "nccl":
                raise AssertionError(f"world 1: {multihost.process_count()} ranks, {backend}")
            probe = torch.arange(4.0, device=dev)
            gathered = multihost.all_gather_tensor(probe)
            if len(gathered) != 1 or not torch.equal(gathered[0], probe):
                raise AssertionError("nccl world 1: all_gather returned another tensor")
        finally:
            multihost.shutdown()
        say("mesh", leg="d_nccl_world_1", backend=backend, process_count=1, init_s=init_s)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    nccl_procs = _start_group(2, "nccl", device, root, card="0") if on_card else []
    gloo = _collect_group(_start_group(2, "gloo", device, root))
    groups_s = time.perf_counter() - t0
    nccl = _collect_group(nccl_procs)
    say("mesh", leg="d_nccl_two_ranks_one_card",
        refused=bool(nccl) and all("error" in r or r["rc"] != 0 for r in nccl),
        printed=[r.get("error") or r["stderr"][-300:] for r in nccl])
    bad = [r for r in gloo if r["rc"] != 0 or "error" in r]
    if bad:
        raise AssertionError(f"gloo children failed: {bad}")
    ref = tft.reduce_blocks(lambda v_input: {"v": v_input.sum(0)},
                            tft.TensorFrame.from_arrays({"v": vals}, num_blocks=2),
                            engine=serial, **on)
    got = np.frombuffer(bytes.fromhex(gloo[0]["v"]), np.float32)
    if gloo[0]["v"] != gloo[1]["v"]:
        raise AssertionError("gloo: the two ranks hold different results")
    err = check_results("gloo cross-process reduce_blocks", {"v": got}, ref, SUM_RTOL)
    if any(r["process_count"] != 2 or r["mesh_size"] != 2 for r in gloo):
        raise AssertionError(f"gloo: group {gloo}")
    say("mesh", leg="d_gloo_two_ranks", process_count=2, mesh_size=2,
        process_rows=[r["process_rows"] for r in gloo],
        group_s=[r["group_s"] for r in gloo], reduce_s=[r["reduce_s"] for r in gloo],
        child_wall_s=[r["wall_s"] for r in gloo], both_groups_s=groups_s,
        host_detours=[r["host_detours"] for r in gloo],
        detour=("gloo takes no CUDA tensor: each partial crossed through the host"
                if any(r["host_detours"] for r in gloo) else None),
        bit_identical_to_two_blocks=bool(np.array_equal(got, np.asarray(ref["v"]))),
        max_abs_err=err, rtol=SUM_RTOL)
    return total


class _Reblocked:
    """An engine that runs ``serial``'s verbs over the frame re-cut into
    one block (``n`` None) or ``n`` equal blocks."""

    def __init__(self, serial, n=None):
        self.serial, self.n = serial, n

    def _cut(self, frame):
        import tensorframes_tpu_torch as tft

        rows = frame.num_rows
        if self.n is None:
            return tft.TensorFrame(list(frame.columns), (0, rows))
        return tft.TensorFrame(list(frame.columns), [rows * i // self.n for i in range(self.n + 1)])

    def __getattr__(self, verb):
        method = getattr(self.serial, verb)
        if verb == "aggregate":
            from tensorframes_tpu_torch.ops.engine import GroupedFrame

            return lambda program, grouped, **kw: method(
                program, GroupedFrame(self._cut(grouped.frame), grouped.keys), **kw)
        return lambda program, frame, **kw: method(program, self._cut(frame), **kw)


# --- serving over the bridge (phase 14) ----------------------------------------
BRIDGE_COALESCE_US, BRIDGE_CLIENTS, BRIDGE_SLICE = 2000, 8, 4_096  # leg (b)
BRIDGE_COALESCE_TRIES = 3  # leg (b) repeats its wave when nothing coalesced
BRIDGE_STREAMS, BRIDGE_SLOTS = 16, 8  # leg (c)
BRIDGE_PROMPTS, BRIDGE_NEW = (32, 1792), (32, 256)  # leg (c): ranges, both ends in
BRIDGE_SMALL_STREAMS = 4  # leg (c): the small f32 model, card vs CPU
BRIDGE_DELAY_MS = 40  # leg (d): the injected dispatch delay that paces each block
BRIDGE_PIPE_ROWS, BRIDGE_PIPE_D, BRIDGE_PIPE_WINDOW = 1_048_576, 16, 131_072  # leg (e)
BRIDGE_TIMEOUT_S = 600.0  # every client call; a hang fails the phase


def mlp_graph(seed, rows_level):
    """Config 3's 784-256-128-10 MLP frozen into a GraphDef with seeded
    weights: a row program (``image`` [784]) or a block program (``image``
    [-1, 784]).  Returns (bytes, fetches)."""
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

    rng = np.random.RandomState(seed)
    g = GraphBuilder()
    g.placeholder("image", "float32", [MLP_SIZES[0]] if rows_level else [-1, MLP_SIZES[0]])
    x = "image"
    for i, (fi, fo) in enumerate(zip(MLP_SIZES[:-1], MLP_SIZES[1:])):
        g.const(f"w{i}", (rng.randn(fi, fo) * np.sqrt(2.0 / fi)).astype(np.float32))
        g.const(f"b{i}", np.zeros((fo,), np.float32))
        x = g.op("MatMul", f"mm{i}", [x, f"w{i}"])
        x = g.op("BiasAdd", f"bias{i}", [x, f"b{i}"])
        if i < len(MLP_SIZES) - 2:
            x = g.op("Relu", f"relu{i}", [x])
    g.op("ArgMax", "prediction", [x, g.const("axis", np.int32(-1))])
    return g.to_bytes(), ["prediction", x]


def same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def differing(a, b):
    """(count of differing elements, max |a - b|) of two equal-shape arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return int((d > 0).sum()), float(d.max()) if d.size else 0.0


def run_threads(n, fn, timeout_s=BRIDGE_TIMEOUT_S):
    """``fn(k)`` on ``n`` threads, each joined with a timeout; the first
    error raises here."""
    import threading

    errs = []

    def wrap(k):
        try:
            fn(k)
        except BaseException as e:  # noqa: BLE001 — raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(k,), daemon=True) for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout_s)
        if t.is_alive():
            raise AssertionError(f"a bridge client thread did not finish in {timeout_s}s")
    if errs:
        raise errs[0]


def held_to_solo(params, cfg, prompts, news, streamed, cap):
    """Each scheduled stream ``streamed[k]`` against its solo ``generate``
    of ``news[k]`` tokens from ``prompts[k]`` at the scheduler's capacity
    ``cap``, up to the solo run's first near-tie (top-2 gap under
    ``DECODE_GAP``: the rule of ``phase_decode`` (a)).  Raises when a
    stream differs before that point; returns (tokens held, streams equal
    to solo throughout)."""
    from tensorframes_tpu_torch.models import decode

    gaps = []
    real_apply = decode.apply_cached

    def recording(*a, **kw):
        logits, cache = real_apply(*a, **kw)
        top2 = torch.topk(logits[0, -1].float(), 2).values
        gaps.append(top2[0] - top2[1])  # read after the run: no sync a step
        return logits, cache

    held, exact, diverged = 0, 0, []
    decode.apply_cached = recording
    try:
        for k in range(len(prompts)):
            gaps.clear()
            solo = decode.generate(params, torch.from_numpy(prompts[k][None]).cuda(), cfg,
                                   int(news[k]), cache_len=cap)
            solo = solo[0, len(prompts[k]):].tolist()
            gap = torch.stack(gaps).tolist()
            first_tie = next((i for i, g in enumerate(gap) if g < DECODE_GAP), len(gap))
            if streamed[k][:first_tie] != solo[:first_tie]:
                i = next(i for i in range(first_tie) if streamed[k][i] != solo[i])
                diverged.append(dict(stream=k, position=i, gap=gap[i]))
            held += first_tie
            exact += int(streamed[k] == solo)
    finally:
        decode.apply_cached = real_apply
    if diverged:
        raise AssertionError(f"decode: streams differ from solo generate before a near-tie: "
                             f"{diverged}")
    return held, exact


def phase_bridge():
    """Legs (a)-(e) of serving over the bridge (the module docstring's
    phase 14).  Every server runs on the card in a thread of this process,
    bound to 127.0.0.1:0, and every client talks to it over the socket.
    Returns the flash launches of the phase (none may happen)."""
    import tempfile
    import threading

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import cancellation, observability as obs
    from tensorframes_tpu_torch import relational
    from tensorframes_tpu_torch.bridge import BridgeClient, DeadlineExceeded, ServerBusy, serve
    from tensorframes_tpu_torch.bridge import coalescer
    from tensorframes_tpu_torch.graphdef import import_graphdef
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    doctor_mod = sys.modules["tensorframes_tpu_torch.doctor"]
    flash.reset_launches()

    def client(srv, **kw):
        return BridgeClient(*srv.address, timeout_s=BRIDGE_TIMEOUT_S, **kw)

    # (a) the verbs over the socket: config 3's frame up, the MLP GraphDef
    # through map_rows and map_blocks, the outputs down; each bit-identical
    # to the same verb in process on the card
    rng = np.random.RandomState(0)
    feats = rng.rand(MLP_ROWS, MLP_SIZES[0]).astype(np.float32)
    row_graph, row_fetch = mlp_graph(0, rows_level=True)
    block_graph, block_fetch = mlp_graph(0, rows_level=False)
    srv = serve(device="cuda", max_inflight=0)
    try:
        with client(srv) as c:
            t0 = time.perf_counter()
            rf = c.create_frame({"pixels": feats}, num_blocks=VERB_BLOCKS)
            up_s = time.perf_counter() - t0
            verbs = {}
            frame = tft.TensorFrame.from_arrays({"pixels": feats}, num_blocks=VERB_BLOCKS)
            for verb, graph, fetches in (("map_rows", row_graph, row_fetch),
                                         ("map_blocks", block_graph, block_fetch)):
                inputs = {"image": "pixels"}
                prog = import_graphdef(graph, fetches=fetches, inputs=inputs, device="cuda")
                # one untimed run each first: both sides then run warm
                getattr(rf, verb)(graph, fetches, inputs=inputs).release()
                getattr(tft, verb)(prog, frame).to_arrays()
                t0 = time.perf_counter()
                out = getattr(rf, verb)(graph, fetches, inputs=inputs)
                got = out.collect(columns=fetches)
                bridge_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                ref = getattr(tft, verb)(prog, frame).to_arrays()
                local_s = time.perf_counter() - t0
                for k in fetches:
                    if not same_bytes(got[k], ref[k]):
                        raise AssertionError(f"bridge {verb} {k}: not bit-identical to the "
                                             f"in-process verb ({differing(got[k], ref[k])})")
                out.release()
                verbs[verb] = dict(bridge_rows_per_s=MLP_ROWS / bridge_s,
                                   in_process_rows_per_s=MLP_ROWS / local_s,
                                   bridge_over_in_process=local_s / bridge_s)
            t0 = time.perf_counter()
            back = rf.collect(columns=["pixels"])["pixels"]
            down_s = time.perf_counter() - t0
            if not same_bytes(back, feats):
                raise AssertionError("bridge collect: the frame came back changed")
        say("bridge", leg="a_verbs", rows=MLP_ROWS, frame_bytes=feats.nbytes,
            up_mb_per_s=feats.nbytes / up_s / 1e6, down_mb_per_s=feats.nbytes / down_s / 1e6,
            bit_identical=True, **{f"{v}_{k}": x for v, r in verbs.items() for k, x in r.items()})
    finally:
        srv.close(drain_s=5.0)

    # (b) coalescing: BRIDGE_CLIENTS sessions each send a BRIDGE_SLICE-row
    # slice through map_rows of the MLP at once; each result against the
    # same request served alone, the members' ledgers against the global
    # counters delta of the wave
    srv = serve(device="cuda", max_inflight=0, coalesce_us=BRIDGE_COALESCE_US,
                coalesce_rows=BRIDGE_CLIENTS * BRIDGE_SLICE, warm_spec="8")
    try:
        slices = [feats[k * BRIDGE_SLICE:(k + 1) * BRIDGE_SLICE] for k in range(BRIDGE_CLIENTS)]
        conns = [client(srv, tenant=f"t{k}") for k in range(BRIDGE_CLIENTS)]
        try:
            frames = [c.create_frame({"pixels": s}) for c, s in zip(conns, slices)]
            alone = {}
            for k, f in enumerate(frames):  # one at a time: each served alone
                out = f.map_rows(row_graph, row_fetch, inputs={"image": "pixels"})
                alone[k] = out.collect(columns=row_fetch)
                out.release()
            for attempt in range(1, BRIDGE_COALESCE_TRIES + 1):
                together, cids, ledgers = {}, {}, {}
                # go: the wave starts; fired: every map returned; read: the
                # delta is taken, so no member's collect lands inside it
                go, fired, read = (threading.Barrier(BRIDGE_CLIENTS + 1) for _ in range(3))
                wave = {}

                def member(k):
                    go.wait(BRIDGE_TIMEOUT_S)
                    out = frames[k].map_rows(row_graph, row_fetch, inputs={"image": "pixels"})
                    cids[k] = conns[k].last_correlation_id
                    fired.wait(BRIDGE_TIMEOUT_S)
                    read.wait(BRIDGE_TIMEOUT_S)
                    together[k] = out.collect(columns=row_fetch)
                    ledgers[k] = conns[k].attribution(cids[k])["ledger"]
                    out.release()

                def main_side():
                    c0 = obs.counters()
                    go.wait(BRIDGE_TIMEOUT_S)
                    fired.wait(BRIDGE_TIMEOUT_S)
                    wave["delta"] = obs.counters_delta(c0)
                    read.wait(BRIDGE_TIMEOUT_S)

                side = threading.Thread(target=main_side, daemon=True)
                side.start()
                run_threads(BRIDGE_CLIENTS, member)
                side.join(BRIDGE_TIMEOUT_S)
                delta = wave["delta"]
                if delta["coalesced_batches"] >= 1:
                    break
            if delta["coalesced_batches"] < 1:
                raise AssertionError(f"coalescing: no batch coalesced in "
                                     f"{BRIDGE_COALESCE_TRIES} waves")
            summed = {}
            for k in range(BRIDGE_CLIENTS):
                for key, n in ledgers[k]["counters"].items():
                    summed[key] = summed.get(key, 0) + n
            bad = {k: (summed.get(k, 0), n) for k, n in delta.items() if summed.get(k, 0) != n}
            if bad:
                raise AssertionError(f"coalescing: ledger shares differ from the delta: {bad}")
            diffs = {k: differing(together[k][f], alone[k][f])
                     for k in range(BRIDGE_CLIENTS) for f in row_fetch}
            n_diff = sum(d[0] for d in diffs.values())
            worst = max(d[1] for d in diffs.values())
            # a coalesced batch runs the MLP's products at another row count
            # than a lone request; cuBLAS picks its kernel by shape, so the
            # leg prints the differing elements and holds them to the verbs
            # phase's MLP_TOL should any appear
            if worst > MLP_TOL:
                raise AssertionError(f"coalescing: results differ from solo by {worst}")
            # warm a new program, then its first request
            warm_graph, warm_fetch = mlp_graph(1, rows_level=True)
            w = conns[0].warm(warm_graph, warm_fetch, columns={"pixels": feats[:1]},
                              rows=[BRIDGE_SLICE], verb="map_rows", inputs={"image": "pixels"})
            c0 = obs.counters()
            out = frames[0].map_rows(warm_graph, warm_fetch, inputs={"image": "pixels"})
            d_warm = obs.counters_delta(c0)
            out.release()
            if d_warm["program_traces"] or d_warm["backend_compiles"] or not d_warm[
                    "warm_program_hits"]:
                raise AssertionError(f"warm: the first request traced or built: {d_warm}")
        finally:
            for c in conns:
                c.close()
        say("bridge", leg="b_coalescing", clients=BRIDGE_CLIENTS, rows_each=BRIDGE_SLICE,
            coalesce_us=BRIDGE_COALESCE_US, waves=attempt,
            coalesced_batches=delta["coalesced_batches"],
            coalesced_requests=delta["coalesced_requests"],
            solo_requests=delta["coalesce_solo_requests"],
            ledger_shares_sum_to_delta=True, bit_identical=n_diff == 0,
            differing_elements=n_diff, max_abs_diff=worst, tol=MLP_TOL,
            warm_primed_rows=w["primed_rows"], first_request_program_traces=d_warm[
                "program_traces"], first_request_backend_compiles=d_warm["backend_compiles"])
    finally:
        srv.close(drain_s=5.0)

    # (c) paged continuous decode behind the decode RPC, at decode config 8
    cfg = tfm.TransformerConfig(**DECODE_MODEL, dtype=torch.bfloat16)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    drng = np.random.RandomState(19)
    lens = drng.randint(BRIDGE_PROMPTS[0], BRIDGE_PROMPTS[1] + 1, BRIDGE_STREAMS)
    news = drng.randint(BRIDGE_NEW[0], BRIDGE_NEW[1] + 1, BRIDGE_STREAMS)
    lens[:2], news[:2] = BRIDGE_PROMPTS, BRIDGE_NEW  # both ends of each range
    prompts = [drng.randint(0, cfg.vocab_size, L).astype(np.int32) for L in lens]
    # the scheduler reserves a request's whole span at submit, pending ones
    # too, and takes up to 2 x max_slots requests: a pool for that backlog
    # at full capacity never refuses one of the 16 streams
    pages_full = -(-cfg.max_seq // PAGE_TOKENS)
    srv = serve(device="cuda", max_inflight=4 * BRIDGE_STREAMS,
                decode_model=dict(params=params, cfg=cfg, max_slots=BRIDGE_SLOTS,
                                  tokens_per_page=PAGE_TOKENS,
                                  pool_pages=2 * BRIDGE_SLOTS * pages_full + 1))
    sched = srv.decode_scheduler
    drained = False
    try:
        streamed, walls = {}, {}
        c0 = obs.counters()
        t_all = time.perf_counter()

        def stream(k):
            with client(srv, tenant=f"d{k % 4}", busy_retries=0) as c:
                t0 = time.perf_counter()
                streamed[k] = c.decode(prompts[k].tolist(), max_new=int(news[k]))["tokens"]
                walls[k] = time.perf_counter() - t0

        run_threads(BRIDGE_STREAMS, stream)
        total_s = time.perf_counter() - t_all
        d_dec = obs.counters_delta(c0)
        snap = sched.snapshot()
        if snap["pages_used"] != 0:
            raise AssertionError(f"decode: {snap['pages_used']} pages still used")
        if snap["joined_mid_run"] < 1:
            raise AssertionError("decode: no stream joined a running batch")
        if d_dec["decode_tokens"] != int(news.sum()):
            raise AssertionError(f"decode: {d_dec['decode_tokens']} tokens, want {news.sum()}")
        if any(len(streamed[k]) != news[k] for k in range(BRIDGE_STREAMS)):
            raise AssertionError("decode: a stream ended short")
        # each stream against its solo generate at the scheduler's capacity,
        # up to the solo run's first near-tie (top-2 gap under DECODE_GAP)
        held, exact = held_to_solo(params, cfg, prompts, news, streamed, sched.cap)
        # a span the free pages cannot hold: refused as server_busy, reason pages
        need = -(-int(lens[0] + news[0]) // sched.pool.tokens_per_page)
        hold, _ = sched.pool.allocate(sched.pool.free_count() - (need - 1))
        try:
            with client(srv, busy_retries=0) as c:
                try:
                    c.decode(prompts[0].tolist(), max_new=int(news[0]))
                    raise AssertionError("decode: a span past the free pages was admitted")
                except ServerBusy as e:
                    refusal = dict(reason=e.payload.get("reason"), retry_after_ms=e.retry_after_ms)
            if refusal["reason"] != "pages" or not refusal["retry_after_ms"] > 0:
                raise AssertionError(f"decode refusal: {refusal}")
        finally:
            sched.pool.free(hold)
        # the doctor's decode section reads this live scheduler
        section = doctor_mod._read_section("decode", {})
        if section.get("max_slots") != BRIDGE_SLOTS or section.get("retired") != snap["retired"]:
            raise AssertionError(f"doctor: the decode section reads {section}")
        tft.doctor()
        ms = sorted(1e3 * walls[k] for k in range(BRIDGE_STREAMS))
        say("bridge", leg="c_decode", streams=BRIDGE_STREAMS, slots=BRIDGE_SLOTS,
            prompt_range=list(BRIDGE_PROMPTS), new_range=list(BRIDGE_NEW),
            tokens=int(news.sum()), seconds=total_s, tokens_per_s=int(news.sum()) / total_s,
            p50_ms_a_stream=float(np.percentile(ms, 50)),
            p99_ms_a_stream=float(np.percentile(ms, 99)),
            yardstick_in_process_generate_B8_tokens_per_s=626.6,
            joined_mid_run=snap["joined_mid_run"], prefill_batches=snap["prefill_batches"],
            steps=snap["steps"], pages_used_after=snap["pages_used"], cap=sched.cap,
            tokens_held_before_first_tie=held, streams_exactly_solo=exact, gap=DECODE_GAP,
            refusal=refusal, doctor_decode_section_live=True)

        # the small f32 model's scheduled streams, card against CPU
        scfg = tfm.TransformerConfig(**DECODE_SMALL, dtype=torch.float32)
        sp_cpu = tfm.init(torch.Generator().manual_seed(3), scfg, device="cpu")
        sp_card = torch.utils._pytree.tree_map(lambda a: a.cuda(), sp_cpu)
        small = [(np.random.RandomState(20 + k).randint(0, scfg.vocab_size, 5 + 3 * k)
                  .astype(np.int32), 6 + 2 * k) for k in range(BRIDGE_SMALL_STREAMS)]
        outs = {}
        for name, p in (("card", sp_card), ("cpu", sp_cpu)):
            s = coalescer.DecodeScheduler(p, scfg, max_slots=2, tokens_per_page=8)
            res = {}
            try:
                run_threads(BRIDGE_SMALL_STREAMS,
                            lambda k: res.__setitem__(k, s.submit(*small[k], timeout_s=120)))
            finally:
                s.close()
            outs[name] = res
        if outs["card"] != outs["cpu"]:
            raise AssertionError(f"small f32 scheduled streams: card {outs['card']} != cpu "
                                 f"{outs['cpu']}")
        say("bridge", leg="c_small_f32_card_vs_cpu", streams=BRIDGE_SMALL_STREAMS,
            tokens_equal=True)

        # (d) resilience: a deadline mid-frame, a dropped reply, a drain
        dframe_cols = {"pixels": feats[: 8 * 1024]}
        with client(srv) as c:
            rf = c.create_frame(dframe_cols, num_blocks=8)
            os.environ["TFS_FAULT_INJECT"] = f"delay:ms={BRIDGE_DELAY_MS}"
            try:
                t0 = time.perf_counter()
                clean = rf.map_blocks(block_graph, block_fetch, inputs={"image": "pixels"})
                clean_s = time.perf_counter() - t0
                clean_out = clean.collect(columns=block_fetch)
                c0 = obs.counters()
                t0 = time.perf_counter()
                try:
                    rf.map_blocks(block_graph, block_fetch, inputs={"image": "pixels"},
                                  deadline_ms=0.3 * clean_s * 1e3)
                    raise AssertionError("bridge: a deadline at 0.3 of a clean run did not stop "
                                         "the map_blocks")
                except DeadlineExceeded:
                    stopped_s = time.perf_counter() - t0
                d_dl = obs.counters_delta(c0)
            finally:
                os.environ["TFS_FAULT_INJECT"] = ""
            again = rf.map_blocks(block_graph, block_fetch, inputs={"image": "pixels"})
            again_out = again.collect(columns=block_fetch)
            if not all(same_bytes(again_out[k], clean_out[k]) for k in block_fetch):
                raise AssertionError("bridge: the frame's clean result changed after a deadline")
        os.environ["TFS_FAULT_INJECT"] = "bridge_drop:method=map_rows:call=0"
        try:
            with client(srv, reconnect_retries=3) as c:
                rf = c.create_frame(dframe_cols, num_blocks=2)
                c0 = obs.counters()
                out = rf.map_rows(row_graph, row_fetch, inputs={"image": "pixels"})
                d_drop = obs.counters_delta(c0)
                dropped = out.collect(columns=row_fetch)
        finally:
            os.environ["TFS_FAULT_INJECT"] = ""
        if not (d_drop["bridge_verbs_executed"] == 1 and d_drop["bridge_idem_hits"] == 1
                and d_drop["faults_injected"] == 1):
            raise AssertionError(f"bridge_drop: not exactly once: {d_drop}")
        frame = tft.TensorFrame.from_arrays(dframe_cols, num_blocks=2)
        ref = tft.map_rows(import_graphdef(row_graph, fetches=row_fetch,
                                           inputs={"image": "pixels"}, device="cuda"),
                           frame).to_arrays()
        if not all(same_bytes(dropped[k], ref[k]) for k in row_fetch):
            raise AssertionError("bridge_drop: the retried result is not bit-identical")
        # drain with streams in flight: every admitted stream completes.  The
        # close waits until all four executed (a monotonic counter, so a
        # short stream retiring early cannot hide the others)
        finished = {}
        longest = [int(k) for k in np.argsort(-news, kind="stable")[:4]]

        def late(i):
            k = longest[i]
            with client(srv) as c:
                finished[k] = c.decode(prompts[k].tolist(), max_new=int(news[k]))["tokens"]

        executed0 = obs.counters()["bridge_verbs_executed"]
        ts = [threading.Thread(target=late, args=(i,), daemon=True) for i in range(4)]
        for t in ts:
            t.start()
        t0 = time.monotonic()
        while obs.counters()["bridge_verbs_executed"] - executed0 < 4:
            if time.monotonic() - t0 > BRIDGE_TIMEOUT_S:
                raise AssertionError("drain: the streams never reached the scheduler")
            time.sleep(0.01)
        in_flight = sched.snapshot()["active"]
        srv.close(drain_s=BRIDGE_TIMEOUT_S)
        drained = True
        for t in ts:
            t.join(BRIDGE_TIMEOUT_S)
        if sorted(finished) != sorted(longest) or any(
                len(finished[k]) != news[k] for k in longest):
            raise AssertionError("drain: a stream in flight did not complete")
        say("bridge", leg="d_resilience", deadline_blocks=8, delay_ms=BRIDGE_DELAY_MS,
            clean_s=clean_s, deadline_s=0.3 * clean_s, stopped_s=stopped_s,
            deadline_exceeded=d_dl["bridge_deadline_exceeded"], rerun_bit_identical=True,
            drop_verbs_executed=d_drop["bridge_verbs_executed"],
            drop_idem_hits=d_drop["bridge_idem_hits"], drop_bit_identical=True,
            drain_streams=4, drain_active_at_close=in_flight, drain_completed=len(finished))
    finally:
        if not drained:
            srv.close(drain_s=5.0)
    del params
    torch.cuda.empty_cache()

    # (e) the pipeline RPC over a registered frame: map_blocks, a sort-merge
    # join (a shuffle into partitions) and an aggregate, all GraphDef stages
    prng = np.random.RandomState(21)
    pcols = {"k": prng.randint(0, STREAM_DOCS, BRIDGE_PIPE_ROWS).astype(np.int64),
             "x": prng.rand(BRIDGE_PIPE_ROWS, BRIDGE_PIPE_D).astype(np.float32)}
    bcols = {"k": np.arange(STREAM_DOCS, dtype=np.int64),
             "w": prng.rand(STREAM_DOCS).astype(np.float32)}
    g = GraphBuilder()
    g.placeholder("x", "float32", [-1, BRIDGE_PIPE_D])
    g.const("two", np.float32(2.0))
    g.op("Mul", "y", ["x", "two"])
    map_g = g.to_bytes()
    g = GraphBuilder()
    g.placeholder("y_input", "float32", [-1, BRIDGE_PIPE_D])
    g.placeholder("w_input", "float32", [-1])
    g.const("axis", np.int32(0))
    g.op("Sum", "y", ["y_input", "axis"])
    g.op("Sum", "w", ["w_input", "axis"])
    agg_g = g.to_bytes()

    def stages(build):
        return [{"op": "map_blocks", "graph": map_g, "fetches": ["y"]},
                {"op": "join", "on": "k", "strategy": "sort_merge", "partitions": 4, **build},
                {"op": "aggregate", "keys": ["k"], "graph": agg_g, "fetches": ["y", "w"]}]

    saved = os.environ.get("TFS_SPILL_DIR")
    tmp = tempfile.TemporaryDirectory()
    os.environ["TFS_SPILL_DIR"] = tmp.name
    srv = serve(device="cuda", max_inflight=0)
    try:
        with client(srv, tenant="pipe") as c:
            src = c.create_frame(pcols)
            build = c.create_frame(bcols)
            t0 = time.perf_counter()
            r = c.run_pipeline({"frame_id": src.frame_id, "window_rows": BRIDGE_PIPE_WINDOW},
                               stages({"build_frame_id": build.frame_id}))
            pipe_s = time.perf_counter() - t0
            led = c.attribution(c.last_correlation_id)["ledger"]
            got = r["frame"].collect()
            metrics = c.metrics()
        local = relational.run_stream_pipeline(
            {"frame_id": 1, "window_rows": BRIDGE_PIPE_WINDOW},
            stages({"build_frame": tft.TensorFrame.from_arrays(bcols)}),
            frames={1: tft.TensorFrame.from_arrays(pcols)}, device="cuda")
        want = local["frame"].to_arrays()
        if sorted(got) != sorted(want) or not all(same_bytes(got[k], want[k]) for k in want):
            raise AssertionError("pipeline RPC: the result differs from in-process "
                                 "run_stream_pipeline")
        summed = {}
        for wsnap in r["windows"]:
            for key, n in wsnap["counters"].items():
                summed[key] = summed.get(key, 0) + n
        bad = {k: (n, led["counters"].get(k, 0)) for k, n in summed.items()
               if led["counters"].get(k, 0) != n}
        if bad:
            raise AssertionError(f"pipeline RPC: window attributions differ from the ledger: {bad}")
        families = [f for f in ("tfs_bridge_latency_seconds", 'method="pipeline"')
                    if f not in metrics]
        if families:
            raise AssertionError(f"metrics: missing {families}")
        say("bridge", leg="e_pipeline", rows=BRIDGE_PIPE_ROWS, window_rows=BRIDGE_PIPE_WINDOW,
            windows=r["window_count"], seconds=pipe_s, rows_per_s=BRIDGE_PIPE_ROWS / pipe_s,
            byte_equal_in_process=True, window_ledgers_sum_to_request=True,
            metrics_bridge_families=True)
    finally:
        srv.close(drain_s=5.0)
        if saved is None:
            os.environ.pop("TFS_SPILL_DIR", None)
        else:
            os.environ["TFS_SPILL_DIR"] = saved
        tmp.cleanup()
    launches = dict(flash.kernel_launches)
    if any(launches.values()):
        raise AssertionError(f"the bridge legs launched flash kernels: {launches}")
    say("bridge", leg="flash_launches", launches=launches)
    return launches


# --- the bridge fleet (phase 15) ---------------------------------------------
FLEET_SIZE, FLEET_CLIENTS = 2, 8  # legs (a)-(c): process replicas; (a) FleetClients
FLEET_TRAFFIC_ROWS = 64  # legs (b), (c): the rows of each traffic map_blocks
# leg (b): the victim's durable pipeline is SIGKILLed FLEET_KILL_MS after it
# starts, and every engine dispatch on the victim first sleeps
# FLEET_DELAY_MS, so each of the 8 windows takes at least that long (its
# map_blocks and its aggregate each dispatch): the first boundary is
# journaled within ~2 x 200 ms plus the window's own work, well before
# 1000 ms, and the job cannot end before 8 x 200 = 1600 ms, after the kill
FLEET_KILL_MS, FLEET_DELAY_MS = 1000, 200
# (b)-(c): a restart can count three flaps in the router (the poll's down
# transition, the new epoch, and a client's connection to the old process
# failing after the new one answers on the same port), so the victim's kill
# and two restarts make up to seven inside the router's 60 s window; planned
# restarts must not quarantine it
FLEET_QUARANTINE_AFTER = 8
FLEET_TRAFFIC_PAUSE_S = 0.02  # between one traffic thread's requests
FLEET_STREAMS, FLEET_PROMPT, FLEET_NEW, FLEET_SLOTS = 8, 32, 64, 8  # leg (d)
FLEET_READY_S = 180.0  # a replica's spawn-to-healthy limit


def fleet_keys(names, n):
    """``n`` routing keys for each of ``names``, each owned (rendezvous,
    all eligible) by its name."""
    from tensorframes_tpu_torch.bridge import fleet

    keys = {name: [] for name in names}
    i = 0
    while min(len(v) for v in keys.values()) < n:
        k = f"smoke-{i}"
        owner = max(names, key=lambda name: fleet._rendezvous_score(name, k))
        if len(keys[owner]) < n:
            keys[owner].append(k)
        i += 1
    return keys


class FleetTraffic:
    """``n`` threads of small ``map_blocks`` requests through FleetClients
    (keys ``<prefix>-<i>``) until :meth:`stop`; each result must equal
    ``want`` byte for byte.  A frame does not follow a failover (the new
    replica opens a fresh session), so after one a thread uploads its frame
    again: counted in ``reuploads``, not failed."""

    def __init__(self, router, n, graph, fetches, cols, want, prefix):
        import threading

        self.args = (router, graph, fetches, cols, want, prefix)
        self.halt = threading.Event()
        self.errors = []
        self.counts = {"requests": 0, "reuploads": 0, "failovers": 0}
        self.lock = threading.Lock()
        self.threads = [threading.Thread(target=self.unit, args=(i,), daemon=True)
                        for i in range(n)]
        for t in self.threads:
            t.start()

    def unit(self, i):
        from tensorframes_tpu_torch.bridge import BridgeError, FleetClient

        router, graph, fetches, cols, want, prefix = self.args
        try:
            with FleetClient(router, key=f"{prefix}-{i}", timeout_s=BRIDGE_TIMEOUT_S) as tc:
                rf, seen = None, -1
                while not self.halt.is_set():
                    if tc.client.failovers != seen:
                        seen = tc.client.failovers
                        rf = tc.create_frame(cols)
                    try:
                        out = rf.map_blocks(graph, fetches, inputs={"image": "pixels"})
                        got = out.collect(columns=fetches)
                        out.release()
                    except BridgeError as e:
                        if tc.client.failovers != seen and "unknown frame id" in str(e):
                            with self.lock:
                                self.counts["reuploads"] += 1
                            continue
                        raise
                    if not all(same_bytes(got[k], want[k]) for k in fetches):
                        raise AssertionError(f"traffic {prefix}-{i}: a result differs")
                    with self.lock:
                        self.counts["requests"] += 1
                    time.sleep(FLEET_TRAFFIC_PAUSE_S)
                with self.lock:
                    self.counts["failovers"] += tc.client.failovers
        except Exception as exc:  # noqa: BLE001 — stop() raises it
            self.errors.append(exc)

    def stop(self):
        """Stop and join every thread; raises on any failed request.
        Returns the counts."""
        self.halt.set()
        for t in self.threads:
            t.join(BRIDGE_TIMEOUT_S)
            if t.is_alive():
                raise AssertionError("a traffic thread did not finish")
        if self.errors:
            raise AssertionError(f"traffic requests failed: {self.errors!r}")
        return dict(self.counts)


def phase_fleet():
    """Legs (a)-(d) of the bridge fleet (the module docstring's phase 15):
    replicas on the card, in processes of their own for (a)-(c) and in
    threads of this process for (d), every client a ``FleetClient``.
    Returns the flash launches of the phase (none may happen)."""
    import tempfile
    import threading

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch import relational
    from tensorframes_tpu_torch.bridge import BridgeFleet, FleetClient
    from tensorframes_tpu_torch.bridge import fleet as fleet_mod
    from tensorframes_tpu_torch.graphdef import import_graphdef
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    doctor_mod = sys.modules["tensorframes_tpu_torch.doctor"]
    flash.reset_launches()
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    base_env = {
        "TFS_JOURNAL_DIR": os.path.join(root, "journal"),
        "TFS_COMPILE_CACHE": os.path.join(root, "cache"),
        "TFS_FLEET_REGISTRY": os.path.join(root, "registry"),
        "TFS_BRIDGE_PIPELINE_PATHS": os.path.join(root, "data"),
        "TFS_FAULT_INJECT": "",
        # the replicas share a Python bytecode cache as they share the
        # compile cache: an interpreter that writes none compiles torch's
        # modules from source at every start, a replica's import and its
        # tracer warm-up (``replica.warm_interpreter``) included
        "PYTHONDONTWRITEBYTECODE": "",
        "PYTHONPYCACHEPREFIX": os.path.join(root, "pycache"),
    }
    os.makedirs(base_env["TFS_BRIDGE_PIPELINE_PATHS"])
    fleets, routers = [], []

    def start(**kw):
        """A process fleet on the card, started on a thread of its own so
        this one works meanwhile; ``join`` waits for it (and raises its
        error)."""
        fl = BridgeFleet(FLEET_SIZE, base_env=base_env, log_dir=os.path.join(root, "logs"),
                         ready_timeout_s=FLEET_READY_S, device="cuda", **kw)
        fleets.append(fl)
        errs = []

        def run():
            try:
                fl.start()
            except BaseException as e:  # noqa: BLE001 — raised by join
                errs.append(e)

        starter = threading.Thread(target=run, daemon=True)
        starter.start()

        def join():
            starter.join(FLEET_SIZE * FLEET_READY_S)
            if errs or starter.is_alive():
                raise AssertionError(f"fleet start: {errs!r}")
            return fl

        return join

    def router_of(fl, **kw):
        r = fl.router(health_s=0.2, **kw)
        routers.append(r)
        return r

    try:
        # (a) routing at full width: 8 FleetClients with distinct keys each
        # upload config 3's frame and run the MLP GraphDef through map_blocks
        # and map_rows, each output bit-identical to the verb in process
        feats = np.random.RandomState(0).rand(MLP_ROWS, MLP_SIZES[0]).astype(np.float32)
        frame = tft.TensorFrame.from_arrays({"pixels": feats}, num_blocks=VERB_BLOCKS)
        inputs = {"image": "pixels"}
        graphs = {"map_rows": mlp_graph(0, rows_level=True),
                  "map_blocks": mlp_graph(0, rows_level=False)}
        joining = start()
        want = {verb: getattr(tft, verb)(import_graphdef(g, fetches=f, inputs=inputs,
                                                         device="cuda"), frame).to_arrays()
                for verb, (g, f) in graphs.items()}
        fl = joining()
        started = fl.timings()
        router = router_of(fl)
        names = [n for n, _, _ in fl.replicas()]
        answered, walls = {}, {}
        hold = threading.Barrier(FLEET_CLIENTS + 1)

        def session(k):
            key = f"route-{k}"
            try:
                with FleetClient(router, key=key, timeout_s=BRIDGE_TIMEOUT_S) as fc:
                    t0 = time.perf_counter()
                    rf = fc.create_frame({"pixels": feats}, num_blocks=VERB_BLOCKS)
                    for verb, (g, f) in graphs.items():
                        out = getattr(rf, verb)(g, f, inputs=inputs)
                        got = out.collect(columns=f)
                        out.release()
                        for c in f:
                            if not same_bytes(got[c], want[verb][c]):
                                raise AssertionError(f"fleet {verb} {c} (key {key}): not "
                                                     f"bit-identical to the in-process verb")
                    walls[k] = time.perf_counter() - t0
                    answered[key] = fc.health()["replica"]["name"]
                    hold.wait(BRIDGE_TIMEOUT_S)  # every session open at the poll
                    hold.wait(BRIDGE_TIMEOUT_S)
            except BaseException:
                hold.abort()  # the others stop waiting for this one
                raise

        def poll_while_held():
            try:
                hold.wait(BRIDGE_TIMEOUT_S)
                router.poll_once()
                hold.wait(BRIDGE_TIMEOUT_S)
            except threading.BrokenBarrierError:
                pass  # a session failed: run_threads raises its error

        poller = threading.Thread(target=poll_while_held, daemon=True)
        poller.start()
        t0 = time.perf_counter()
        run_threads(FLEET_CLIENTS, session)
        total_s = time.perf_counter() - t0
        poller.join(BRIDGE_TIMEOUT_S)
        key = "smoke-durable"
        victim = max(names, key=lambda n: fleet_mod._rendezvous_score(n, key))
        # leg (b)'s fleet starts now: its spawn overlaps the checks below,
        # this fleet's stop and the parquet source's making
        joining = start(fault_env={victim: f"replica_kill:method=pipeline:call=1:"
                                           f"ms={FLEET_KILL_MS};delay:ms={FLEET_DELAY_MS}"})
        routed = {key: router.route(key).name for key in answered}
        if routed != answered:
            raise AssertionError(f"fleet routing: router {routed} != answering {answered}")
        snap = router.snapshot()["replicas"]
        sessions = {n: snap[n]["sessions"] for n in names}
        section = doctor_mod._read_section("fleet", {})
        if sorted(section.get("replicas", {})) != names:
            raise AssertionError(f"doctor: the fleet section reads {section}")
        say("fleet", leg="a_routing", replicas=FLEET_SIZE, clients=FLEET_CLIENTS,
            rows=MLP_ROWS, frame_bytes=feats.nbytes, bit_identical=True,
            routes_match_answering_replica=True,
            start_s={n: started[n]["ready_s"] for n in names}, sessions=sessions,
            seconds=total_s, mb_per_s_up=FLEET_CLIENTS * feats.nbytes / total_s / 1e6,
            p50_s_a_client=float(np.percentile(list(walls.values()), 50)),
            doctor_fleet=section)
        fl.stop()
        router.close()

        # (b) chaos: SIGKILL the owner of a durable pipeline mid-job under 4
        # traffic threads; the job migrates through the shared journal
        try:
            import pyarrow  # noqa: F401
        except ImportError as e:
            raise AssertionError(f"fleet leg (b) needs pyarrow for its parquet source: {e}")
        prng = np.random.RandomState(21)
        src = os.path.join(base_env["TFS_BRIDGE_PIPELINE_PATHS"], "pipe.parquet")
        tft.TensorFrame.from_arrays({
            "k": prng.randint(0, STREAM_DOCS, BRIDGE_PIPE_ROWS).astype(np.int64),
            "x": prng.rand(BRIDGE_PIPE_ROWS, BRIDGE_PIPE_D).astype(np.float32),
        }).to_parquet(src, row_group_size=BRIDGE_PIPE_WINDOW)
        g = GraphBuilder()
        g.placeholder("x", "float32", [-1, BRIDGE_PIPE_D])
        g.const("two", np.float32(2.0))
        g.op("Mul", "y", ["x", "two"])
        map_g = g.to_bytes()
        g = GraphBuilder()
        g.placeholder("y_input", "float32", [-1, BRIDGE_PIPE_D])
        g.const("axis", np.int32(0))
        g.op("Sum", "y", ["y_input", "axis"])
        agg_g = g.to_bytes()
        # phase_bridge (e)'s chain without its join: a durable pipeline
        # refuses a sort-merge join, and a registered build frame does not
        # follow a failover
        source = {"parquet": src, "window_rows": BRIDGE_PIPE_WINDOW}
        stages = [{"op": "map_blocks", "graph": map_g, "fetches": ["y"]},
                  {"op": "aggregate", "keys": ["k"], "graph": agg_g, "fetches": ["y"]}]
        n_windows = -(-BRIDGE_PIPE_ROWS // BRIDGE_PIPE_WINDOW)
        t0 = time.perf_counter()
        ref = relational.run_stream_pipeline(source, stages=stages,
                                             device="cuda")["frame"].to_arrays()
        in_process_s = time.perf_counter() - t0
        fl = joining()
        router = router_of(fl, quarantine_after=FLEET_QUARANTINE_AFTER)
        if router.route(key).name != victim:
            raise AssertionError(f"fleet: {key} does not route to {victim}")
        tcols = {"pixels": feats[:FLEET_TRAFFIC_ROWS]}
        block_g, block_f = graphs["map_blocks"]
        twant = tft.map_blocks(import_graphdef(block_g, fetches=block_f, inputs=inputs,
                                               device="cuda"),
                               tft.TensorFrame.from_arrays(tcols)).to_arrays()
        traffic = FleetTraffic(router, 4, block_g, block_f, tcols, twant, "chaos")
        c0 = obs.counters()
        died = {}
        proc = fl._replicas[victim].proc

        def watch():
            proc.wait()
            died["t"] = time.perf_counter()

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        with FleetClient(router, key=key, timeout_s=BRIDGE_TIMEOUT_S) as fc:
            t0 = time.perf_counter()
            warm = fc.run_pipeline(source, stages)  # pipeline call 0 on the victim
            warm_s = time.perf_counter() - t0
            if warm["rows"] != BRIDGE_PIPE_ROWS:
                raise AssertionError(f"fleet warm pipeline: {warm['rows']} rows")
            r = fc.run_pipeline(source, stages, job_id="smoke-chaos")
            done = time.perf_counter()
            chaos_traffic = traffic.stop()
            got = r["frame"].collect()
            h = fc.health()
            status = fc.job_status("smoke-chaos")["status"]
            failovers = fc.client.failovers
        watcher.join(10)  # the victim is dead by now, unless the kill never came
        delta = obs.counters_delta(c0)
        hc = h["counters"]
        checks = {
            "failovers >= 1": failovers >= 1,
            "resumed": r.get("resumed") is True,
            "fleet_jobs_migrated == 1": delta["fleet_jobs_migrated"] == 1,
            "victim died by SIGKILL": proc.returncode == -signal.SIGKILL,
            "journal_windows_skipped >= 1": hc["journal_windows_skipped"] >= 1,
            "skipped + executed windows == all": (
                hc["journal_windows_skipped"] + hc["stream_windows"] == n_windows),
            "byte-equal to in process": sorted(got) == sorted(ref) and all(
                same_bytes(got[c], ref[c]) for c in ref),
            "job complete": status == "complete",
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"fleet chaos: {bad}: {dict(delta=delta, health=hc)}")
        say("fleet", leg="b_chaos", rows=BRIDGE_PIPE_ROWS, window_rows=BRIDGE_PIPE_WINDOW,
            windows=n_windows, victim=victim, adopter=h["replica"]["name"],
            kill_ms=FLEET_KILL_MS, delay_ms=FLEET_DELAY_MS, failovers=failovers,
            fleet_failovers=delta["fleet_failovers"],
            fleet_jobs_migrated=delta["fleet_jobs_migrated"], resumed=True,
            victim_returncode=proc.returncode,
            adopter_windows_skipped=hc["journal_windows_skipped"],
            adopter_windows_executed=hc["stream_windows"],
            adopter_journal_resumes=hc["journal_resumes"], byte_equal_in_process=True,
            job_status=status, kill_to_resumed_s=done - died["t"],
            victim_warm_pipeline_s=warm_s, in_process_pipeline_s=in_process_s,
            adopter_window_wall_s=[w["wall_s"] for w in r["windows"]],
            traffic_failed_requests=0, **{f"traffic_{k}": v for k, v in chaos_traffic.items()})

        # (c) the victim restarted, then a rolling restart of every replica
        # under 2 traffic threads; each replica then serves the primed pipeline
        # (run on the victim and the adopter in (b)) building nothing
        c0 = obs.counters()
        fl.fault_env.pop(victim)
        fl.restart(victim)
        router.poll_once()
        victim_restart_s = fl.timings()[victim]["ready_s"]
        traffic = FleetTraffic(router, 2, block_g, block_f, tcols, twant, "rolling")
        t0 = time.perf_counter()
        fl.rolling_restart(router)
        rolling_s = time.perf_counter() - t0
        rolling_traffic = traffic.stop()
        restarts = obs.counters_delta(c0)["fleet_replica_restarts"]
        router.poll_once()
        snap = router.snapshot()["replicas"]
        if restarts != 1 + FLEET_SIZE or not all(
                s["healthy"] and not s["draining"] and not s["quarantined"]
                for s in snap.values()):
            raise AssertionError(f"rolling restart: {restarts} restarts, replicas {snap}")
        rejoin = {}
        for name, (k,) in fleet_keys(names, 1).items():
            with FleetClient(router, key=k, timeout_s=BRIDGE_TIMEOUT_S) as fc:
                if router.route(k).name != name:
                    raise AssertionError(f"rolling restart: {k} does not route to {name}")
                t0 = time.perf_counter()
                rows = fc.run_pipeline(source, stages)["rows"]
                first_s = time.perf_counter() - t0
                h = fc.health()
            cnt = h["counters"]
            if (h["replica"]["name"] != name or rows != BRIDGE_PIPE_ROWS
                    or cnt["backend_compiles"] or cnt["persistent_cache_misses"]):
                raise AssertionError(f"rolling restart: {name} rebuilt or answered wrong: {h}")
            rejoin[name] = dict(first_pipeline_s=first_s, **{
                c: cnt[c] for c in ("backend_compiles", "persistent_cache_hits",
                                    "persistent_cache_misses")})
        timings = fl.timings()
        say("fleet", leg="c_rolling_restart", victim_restart_s=victim_restart_s,
            rolling_s=rolling_s, fleet_replica_restarts=restarts,
            sigterm_to_healthy_s={n: timings[n]["term_to_ready_s"] for n in names},
            traffic_failed_requests=0, **{f"traffic_{k}": v for k, v in rolling_traffic.items()},
            rejoined=rejoin, flaps={n: s["flaps_recent"] for n, s in snap.items()})
        fl.stop()
        router.close()
        del feats, frame, want
    except BaseException:
        logs = os.path.join(root, "logs")
        for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
            with open(os.path.join(logs, name), errors="replace") as f:
                print(f"--- {name} (last lines)\n" + "".join(f.readlines()[-20:]),
                      file=sys.stderr, flush=True)
        raise
    finally:
        for r in routers:
            r.close()
        for fl in fleets:
            fl.stop()
        tmp.cleanup()

    # (d) decode behind a two-replica thread fleet at decode config 8: 8
    # streams through FleetClients whose keys split over both replicas, one
    # replica drained mid-run
    cfg = tfm.TransformerConfig(**DECODE_MODEL, dtype=torch.bfloat16)
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    drng = np.random.RandomState(23)
    prompts = [drng.randint(0, cfg.vocab_size, FLEET_PROMPT).astype(np.int32)
               for _ in range(FLEET_STREAMS)]
    news = [FLEET_NEW] * FLEET_STREAMS
    # every stream could land on one replica: pools for that backlog at full
    # capacity (the scheduler reserves pending requests' spans too)
    pages_full = -(-cfg.max_seq // PAGE_TOKENS)
    fl = BridgeFleet(2, mode="thread", device="cuda", max_inflight=0,
                     decode_model=dict(params=params, cfg=cfg, max_slots=FLEET_SLOTS,
                                       tokens_per_page=PAGE_TOKENS,
                                       pool_pages=2 * FLEET_SLOTS * pages_full + 1))
    router = None
    try:
        fl.start()
        router = fl.router(health_s=0.2)
        names = [n for n, _, _ in fl.replicas()]
        drained_name, survivor = names
        servers = {n: fl._replicas[n].server for n in names}
        keys = fleet_keys(names, FLEET_STREAMS // 2)
        half = FLEET_STREAMS // 2
        # wave 1: half the streams, split over both replicas; wave 2 opens its
        # sessions after the drain began, so every one routes to the survivor
        wave_keys = ([keys[n][i] for i in range(half // 2) for n in names]
                     + [keys[n][i] for i in range(half // 2, half) for n in names])
        streamed, walls, addrs, errs = {}, {}, {}, []

        def stream(k):
            try:
                with FleetClient(router, key=wave_keys[k], timeout_s=BRIDGE_TIMEOUT_S) as fc:
                    addrs[k] = (fc.client._host, fc.client._port)
                    t0 = time.perf_counter()
                    streamed[k] = fc.client.decode(prompts[k].tolist(),
                                                   max_new=news[k])["tokens"]
                    walls[k] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 — raised below
                errs.append(e)

        def drain():
            try:
                fl.drain(drained_name, timeout_s=BRIDGE_TIMEOUT_S)
            except BaseException as e:  # noqa: BLE001 — raised below
                errs.append(e)

        c0 = obs.counters()
        t_all = time.perf_counter()
        first = [threading.Thread(target=stream, args=(k,), daemon=True) for k in range(half)]
        for t in first:
            t.start()
        t0 = time.monotonic()
        while servers[drained_name].decode_scheduler.snapshot()["active"] < half // 2:
            if errs or time.monotonic() - t0 > BRIDGE_TIMEOUT_S:
                raise AssertionError(f"fleet decode: wave 1 never reached the scheduler "
                                     f"({errs!r})")
            time.sleep(0.005)
        router.mark_draining(drained_name)
        drainer = threading.Thread(target=drain, daemon=True)
        drainer.start()
        while not servers[drained_name].gate.snapshot()["draining"]:
            time.sleep(0.001)
        in_flight_at_drain = servers[drained_name].decode_scheduler.snapshot()["active"]
        run_threads(FLEET_STREAMS - half, lambda j: stream(half + j))
        for t in first + [drainer]:
            t.join(BRIDGE_TIMEOUT_S)
        total_s = time.perf_counter() - t_all
        if errs:
            raise errs[0]
        d_dec = obs.counters_delta(c0)
        survivor_addr = dict((n, (h, p)) for n, h, p in fl.replicas())[survivor]
        late = [addrs[k] for k in range(half, FLEET_STREAMS)]
        if any(a != survivor_addr for a in late):
            raise AssertionError(f"fleet decode: sessions opened after the drain reached "
                                 f"{late}, not the survivor {survivor_addr}")
        if sorted(streamed) != list(range(FLEET_STREAMS)) or any(
                len(streamed[k]) != news[k] for k in range(FLEET_STREAMS)) or d_dec[
                    "decode_tokens"] != sum(news):
            raise AssertionError(f"fleet decode: a stream did not complete ("
                                 f"{d_dec['decode_tokens']} tokens of {sum(news)})")
        held, exact = held_to_solo(params, cfg, prompts, news, streamed,
                                   servers[survivor].decode_scheduler.cap)
        ms = [walls[k] for k in range(FLEET_STREAMS)]
        say("fleet", leg="d_decode", streams=FLEET_STREAMS, prompt=FLEET_PROMPT,
            new=FLEET_NEW, slots=FLEET_SLOTS, replicas=2, drained=drained_name,
            in_flight_at_drain=in_flight_at_drain, late_sessions_on_survivor=len(late),
            tokens=sum(news), seconds=total_s, tokens_per_s=sum(news) / total_s,
            p50_s_a_stream=float(np.percentile(ms, 50)),
            p99_s_a_stream=float(np.percentile(ms, 99)),
            decode_tokens=d_dec["decode_tokens"], failed_requests=0,
            tokens_held_before_first_tie=held, streams_exactly_solo=exact, gap=DECODE_GAP)
    finally:
        if router is not None:
            router.close()
        fl.stop()
    del params
    torch.cuda.empty_cache()
    launches = dict(flash.kernel_launches)
    if any(launches.values()):
        raise AssertionError(f"the fleet legs launched flash kernels: {launches}")
    say("fleet", leg="flash_launches", launches=launches)
    return launches


def run_phase(phase, *args):
    """``phase(*args)``, printing its command time: the script's run time
    by phase."""
    t0 = time.perf_counter()
    out = phase(*args)
    say("phase", name=phase.__name__, seconds=round(time.perf_counter() - t0, 3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one scoring block and one train step "
                    "by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity with JAX
    torch.backends.cudnn.allow_tf32 = False
    card = phase_env()
    built = run_phase(phase_build)
    errs = run_phase(phase_kernels)
    if args.quick:
        return 0
    timing = run_phase(phase_timing)
    prog, frame, slice_launches = run_phase(phase_slice)
    *wide_launches, wide_run = run_phase(phase_wide_head)
    leg_launches, legs = run_phase(phase_forward_legs)
    dh512_launches, dh512_train = run_phase(phase_dh512_train)
    run_phase(phase_small_head_slice)
    run_phase(phase_verbs)
    run_phase(phase_cached_verbs)
    pipeline_launches = run_phase(phase_pipeline, prog)
    observability_launches = run_phase(phase_observability, prog)
    planner_launches = run_phase(phase_planner, prog)
    streaming_launches = run_phase(phase_streaming, prog)
    mesh_launches = run_phase(phase_mesh, prog, frame)
    run_phase(phase_bridge)
    run_phase(phase_fleet)
    run_phase(phase_decode, args.profile)
    run_phase(phase_crossover)
    train_run = run_phase(phase_train)
    axes_launches = run_phase(phase_train_axes)
    run_phase(phase_frontier, *train_run[1:3])
    run_phase(phase_graphdef, args.profile)
    ring_run = run_phase(phase_ring_slice)
    ring_train_run = run_phase(phase_ring_train, ring_run[3])
    ring_wide_launches = run_phase(phase_ring_wide)
    moe_launches = run_phase(phase_moe)
    # last, so that its f32 params stay out of the other phases' peak memory
    f32_launches, f32_train = run_phase(phase_f32_train)
    if args.profile:
        run_phase(phase_profile, prog, frame, train_run, wide_run, legs, dh512_train, f32_train,
                  ring_run, ring_train_run)
    record = kernel_record(built, errs, timing, train_run[0], ring_run[0], [
        slice_launches, *wide_launches, *leg_launches, dh512_launches, f32_launches,
        pipeline_launches, observability_launches, planner_launches, streaming_launches,
        mesh_launches, train_run[5], axes_launches,
        ring_run[4], *ring_wide_launches, *moe_launches])
    # the card line again, so that it stands among the last lines too
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
