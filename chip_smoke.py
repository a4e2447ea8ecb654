"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, ``nvcc`` and the
checkout's ``src/`` (it imports nothing of JAX). Phases, in order; any
failure exits non-zero and prints no result:

1. environment: a CUDA card, its name and power limit from nvidia-smi;
2. build: the kernels from ``src/repro_torch/kernels/csrc`` (nvcc); no
   spilled register in a kernel that issues wgmma from inline assembly;
3. each kernel against its plain PyTorch version on the card: K1 and K2 on
   a random ELL (V = 2e6, D = 8, PAD rows, ±inf; K2 at frontier densities
   of 1 % and 50 %), K3 over every superstep of CC and SSSP on a road grid
   and on a powerlaw graph with hub feeds, with one partition, with 40
   partitions (more than the clusters the card holds), with each of its two
   walks forced and switching mid-fixpoint, with unroll 3 and with SSSP
   rows no path reaches, K4 on the same graphs and on its own cases (one
   partition, 40 partitions, each of its two walks forced and switching
   mid-run, hub feed rows, unreachable SSSP rows), from the init state and
   after K3 supersteps, at every exit (max_steps 0, 1, 2, 7, one round
   short of quiescence, at it, 4096), K5 and K6 on random masks
   (R ∈ {144, 4096}, cap ∈ {969, 4096}; cap 1 over 4096 rows, one tile
   and one slot more, cap 1023, cap 20011 over 3 rows; densities 0 / 0.05
   / 0.5 / 1, budgets below, above and mixed about the counts, ±inf
   values); K7 at llama3-8b's prefill
   shape (B 4, S 2048, H 32, KV 8, dh 128, causal, bf16), at gemma3-4b's
   local layers (dh 256, H 8, KV 4, window 1024), at h2o-danube-1.8b's
   prefill (dh 80, window 4096), with float32 inputs, and with q_offset
   1024 and Sq < Sk in float32 and bf16, each shape's instantiation
   checked by the kernel names the profiler records (bf16 at dh 64-256:
   ``flash_kernel_sm90``; float32: the SIMT ``flash_kernel``); K8 at
   falcon-mamba-7b's scan width
   (B 2, L 2048, D 8192, N 16) in float32 and bfloat16, and in the ssm
   path's call form (bf16 inputs, a nonzero initial state, float32 y and
   the final state, both bit-equal to the plain version);
4. the paths at full size, on road_grid(1400, 1400) — 1.96M vertices, the
   vertex count of the paper's RN graph — in 12 partitions; one JSON line
   per run, each run after a warm-up call with the launch counts set to 0
   just before it:
   a. the fused route (``exchange='auto'``): CC, SSSP, BFS and 30-iteration
      PageRank through the public functions, checked against scipy/numpy;
   b. the staged route: ``exchange='dense'`` CC, SSSP and BFS bit-equal to
      (a) with equal supersteps and local_iters; ``exchange='compact'`` CC
      and SSSP bit-equal to dense, with (a)'s count_hist and a smaller
      wire; vertex-centric CC and SSSP (``mode='vertex'``) against scipy,
      with fewer supersteps in sub-graph mode (paper Fig 4c); PageRank on
      ``exchange='dense'`` against the float64 power iteration; PageRank
      with a ``tol`` that halts it at superstep 40 of 200, against the
      power iteration's own halt and ranks; BlockRank against the port's
      own run of it on the CPU (the plain versions of every kernel);
   c. tier plans (``core.tiers``) on the same graph: CC and SSSP on
      ``exchange='megastep'`` with ``PhasedTierPlan.from_graph`` — resident
      from superstep 0, ONE K4 launch each, bit-equal to (a) and scipy,
      with the supersteps and sweeps of the plain resident loop on the
      card; the same with the resident gate lowered under a two-phase plan,
      so three K3 supersteps hand off to K4; ``exchange='tiered'`` with
      ``TierPlan.from_graph`` bit-equal to dense, no spill, the schedule's
      slots every round; a too-narrow plan (every pair cold) that spills,
      reruns dense, escalates and stays bit-equal; ``exchange='phased'``
      CC and SSSP with a plan taught by (b)'s compact CC run, bit-equal to
      dense with compact's count_hist; 30-iteration PageRank on 'phased'
      allclose to (b)'s dense PageRank;
   and where each run's time goes (CUDA events around every kernel call);
   d. LM serving: llama3-8b at full width and depth (8.03 B parameters in
      bf16, random weights from a seed) through ``make_prefill_step`` on
      4 × 2048 random prompt tokens, then 32 greedy ``make_decode_step``s,
      timed after a warm-up: (i) K7 launched once a layer in the prefill
      and never in decode; (ii) the decode steps' logits within a relative
      L2 error of 5e-2 of a teacher-forced forward over the prompt and the
      generated tokens; (iii) the same architecture at full width with its
      depth cut to 2 layers, in float32, on the card (K7) and on the CPU
      (the plain versions) with the same weights: prefill logits and
      caches, then 8 decode steps' logits, allclose at rtol = atol = 1e-3
      and the greedy tokens equal. One JSON line with the
      serving times, peak memory and K7's event-timed share of a prefill,
      and the profiler's device breakdown of a prefill and a decode step;
   e. LM serving of the ssm family, after 4d's model is freed:
      falcon-mamba-7b at full width and depth (64 Mamba1 layers, d 4096,
      d_inner 8192, N 16, 7.27 B parameters in bf16, random weights from
      seed 0) through the same serve steps on the same 4 × 2048 prompts
      (seed 1) and 32 decode steps: (i) K8 launched once a layer in the
      timed prefill and never in decode (the one-step recurrence as plain
      ops); (ii) the cache's len; (iii) the decode logits within a
      relative L2 error of 5e-2 of a teacher-forced forward, and finite;
      (iv) the 2-layer float32 cut of 4d (iii) with K8. The same JSON
      lines as 4d, K8 in place of K7;
   f. the GoFS store and incremental analytics on 4a's graphs and results:
      (1) the graph written through ``TemporalStore`` into a temporary
      directory and loaded back, every field equal and CC on it equal to
      4a's labels with K3 launched (write and load seconds, bytes on
      disk); (2) 1 % of the edges as reopened road segments (the absent
      grid segments drawn as the JAX package's
      benchmarks/bench_incremental.py draws them, seed 7; weights U(5, 10)
      from seed 8, unit weights for the unweighted build) applied with
      ``apply_delta(block=host_graph_block(pg))``: ``verify_host_block``
      clean, the event log replayed by ``patch_host_block`` equal to the
      patched block (host seconds of each, and of a cold block of the new
      version); (3) ``incremental_connected_components``,
      ``incremental_sssp`` and ``incremental_bfs`` on the patched device
      block, each bit-equal to a cold run on the new version and held to
      scipy as 4a holds its runs, with K3 launched and BFS taking fewer
      local iterations than its cold run; (4) the resumed SSSP on
      ``exchange='dense'`` (K2) and ``'compact'`` (K2, K5) bit-equal to
      (3)'s, then 0.01 % of the segments present closed (seed 9, none of
      them reopened in (2)): resumed SSSP and CC bit-equal to cold runs;
      (5) the resumed SSSP on ``exchange='megastep'`` with
      ``PhasedTierPlan.from_graph``: one K4 launch, bit-equal to (3)'s;
      (6) the delta appended to the store and ``materialize(version=1)``
      equal to ``apply_delta`` field for field. One JSON line per run as in
      4a, the cold runs' beside the resumes';
   g. Gopher Serve on 4a's graphs (sources drawn by numpy, seed 11; only
      the first run has a warm-up call): (1) a
      BFS batch of 8 queries through ``run_queries`` on the fused route
      (``megastep_semiring_batched``, plain torch ops: no kernel), each
      lane bit-equal to the fused scalar ``bfs()`` from its source, no
      query converging after the batch; (2) the same batch on 'dense' and
      'compact' (K5's query-batched pack) bit-equal to (1) with equal
      supersteps, local_iters and query_supersteps, and on road_grid(300,
      300) in 12 partitions 'tiered' with a too-narrow plan (it reruns
      dense) and 'phased' bit-equal to 'dense'; (3) an SSSP batch of 4
      bit-equal to the fused scalar ``sssp()``; (4) personalized PageRank,
      4 queries, 30 iterations ('dense', what 'auto' gives it) within
      rtol 1e-5, atol 0 of a float64 power iteration with the one-hot
      teleport; (5) ``GraphQueryService`` over both graphs, its engines
      built by its first drain: 16 bfs/reach queries on the unit graph,
      4 sssp and 4 ppr on the weighted one and an out-of-range source in
      one drain, every answer equal to (1)-(4)'s lanes or a scalar run,
      the source rejected, 3 batches, then 2 repeats that are cache hits;
      (6) ``enable_landmarks`` (8): ``approx_sssp`` at or above (3)'s exact
      distances and equal to a landmark's own vector from it, both within
      1e-4 relative (float32 path sums of up to some 2,800 edges, added
      from either end), then ``apply_delta`` with 4f's delta and
      ``rebuild_landmarks``: the refreshed vectors bit-equal to a cold
      ``LandmarkCache.build`` on version 1. One JSON line per run as in 4a,
      the service's summary and per-batch latency, the landmark times, and
      one batched sweep's device time at Q = 4, 8, 16;
   h. checkpointing and resilience on 4a's weighted graph, after 4g (each
      run once, with the launch counts set to 0 just before it): (1)
      ``exchange='compact'`` CC with a ``Checkpointer`` in a temporary
      directory and ``checkpoint_every=2``, its labels bit-equal to 4a's
      and its supersteps, local_iters, messages_sent, changed_hist and
      count_hist equal to 4b's compact run, K2 and K5 launched; an
      uncheckpointed compact CC timed beside it; the snapshots' steps and
      bytes on disk, one ``restore`` of the last snapshot onto the card,
      and one ``save`` of it sync and ``async_save`` (device-to-host, CRC
      and write seconds); (2) compact SSSP with ``checkpoint_every=8``
      crashed by a ``FaultPlan`` at ``engine.superstep`` visit 20 and
      recovered through ``run_with_recovery``: one restart, resumed from
      step 16, the distances and supersteps 4a's; (3) that run's latest
      snapshot bit-flipped: ``verify_step`` fails it, ``latest_good_step``
      falls back one snapshot, and the resumed run is bit-equal again; (4)
      30-iteration PageRank on 'compact' (K1, K5) crashed at visit 12,
      recovered from step 10, within rtol 1e-5, atol 0 of 4b's dense
      PageRank; (5) a straggler on partition 0 (0.1 s a superstep, spread
      over its live vertices) in a checkpointed CC: ``part_seconds[0] −
      part_seconds[p]`` equals the stalls ``plan.record()`` reports for
      every other p, to its rounding, and the labels are 4a's; an
      ``rn_migration`` line: for each partition its live vertices, free
      slots, sub-graph count and smallest sub-graph, the destination
      ``plan_migration`` picks (the lightest partition with a free slot)
      with its free slots, and the plan at the default budget (no move is
      forced); (6) ``repro_torch.launch.chaos``
      ``--quick --device cuda`` (report in ``chiprun_out/chaos_torch.json``):
      every scenario but ``device_loss`` passes, ``skew_heal`` migrates at
      least once and cuts the imbalance 2x or more. One JSON line per run
      as in 4a, a ``checkpoint``, ``straggler``, ``rn_migration`` and
      ``chaos`` line and the phase's seconds;
   i. observability (Gopher Scope) on 4a's weighted graph, after 4h: (1)
      fused CC and SSSP, each once untraced with a ``MetricsRegistry`` and
      once with ``Tracer(boundary_sync=True)``: the traced labels and
      distances and every Telemetry field but ``part_seconds`` equal to
      4a's and to the untraced run's, K3 launched once a superstep (no
      K4), a ``superstep`` span a superstep, ``validate_chrome_trace``
      clean; (2) the same for compact CC against 4b's, with K2 and K5
      launched; one ``scope`` line with each run's total ms per span name,
      its counters and launches, and its ``warm_s`` traced beside
      untraced; (3) the fused CC under ``Tracer(profiler_dir=)``: the
      written trace holds ``megastep_kernel`` once a superstep (up to three
      traces, as the profiler has lost a window's first launches); (4)
      the registry's ``engine_supersteps_total`` equal to 4a's CC and SSSP
      supersteps, and 4g's service registry's ``serving_requests_total``
      (hits and served) and ``serving_batches_total`` equal to its stats,
      both snapshots through ``validate_metrics``; (5) ``python -m
      repro_torch.launch.scope --device cuda --boundary-sync`` on its
      40 x 40 grid writes its three files, each valid. One
      ``observability`` line with the phase's seconds;
   j. the multi-device backend on 4a's weighted graph, after 4i: a world
      of ONE NCCL rank (``init_process_group("nccl", device_id=)`` over a
      ``file://`` rendezvous, ``launch.mesh.make_mesh``; the card's
      machine has one card, so no collective crosses cards: the
      multi-rank path is checked on the CPU over gloo), each run once on
      'local' and once on ``backend='shard_map'``, timed in turns: CC and
      SSSP on 'dense', 'compact', 'tiered' (``TierPlan.from_graph``),
      'phased' (4c's taught plan) and 'auto' (which resolves to 'dense' on
      one rank), 30-iteration PageRank on 'dense' and a checkpointed
      compact CC (``checkpoint_every=2``), each twice on both in turns
      (local, mesh, mesh, local). The first mesh run is bit-equal to the
      first 'local' run and to 4b's or 4c's (PageRank within rtol 1e-5,
      atol 0), with equal supersteps, local_iters and wire; every run
      launches K2, K5 and K1 as often as the first 'local' run (and as
      4c's tiered and phased runs). One ``mesh`` line a run, the two
      ``warm_s`` beside the two local runs' ``local_warm_s``, and a
      ``mesh_phase`` line (NCCL's init, the phase's seconds); the first
      mesh runs' launches are ``mesh_launches``. A failed NCCL init or
      collective fails the phase;
   k. the multi-device backend's service and device-loss half, after 4j,
      on a world of one NCCL rank of its own: (1)
      ``MeshPlan((1,), ('parts',)).make`` builds the mesh over an NCCL
      subgroup (``launch.mesh.sub_mesh``, not the world's group), and
      compact CC on it is bit-equal to 4j's with K2 and K5 launched; (2)
      ``GraphQueryService(backend='shard_map', mesh=)`` over 4a's graphs
      serves 4g's 25-query stream in one drain (its pooled engines on
      'dense', what 'auto' is on one rank): every answer, error, cached
      flag and query superstep 4g's (PPR within rtol 1e-5, atol 0), one
      ``service_mesh`` line with the drain's seconds, p50/p99 and
      queries a second beside 4g's drain; then ``enable_landmarks`` (the
      same 8 landmarks as 4g) and ``apply_delta`` with 4f's delta and
      ``rebuild_landmarks``: the refreshed vectors within 1e-4 relative of
      4g's (``service_mesh_landmarks``, with whether they are bit-equal);
      (3) ``run_with_failover`` on the mesh with a crash at superstep 2
      (``checkpoint_every=2``): phased CC and SSSP (4c's taught plan; K2,
      K5) and dense 30-iteration PageRank (K1), each restarted once from
      step 2, bit-equal to its 4j run (PageRank rtol 1e-5, atol 0) with
      equal supersteps; one ``failover`` line a run; (4) a device loss of
      the one rank raises ``ValueError`` (every device lost). Every run's
      launches are ``failover_launches``; a failed NCCL init, subgroup or
      collective fails the phase. One ``failover_phase`` line with the
      phase's seconds;
   l. the LM half of the multi-device backend, inside 4d and 4e, after
      their checks, on each one's own world of one NCCL rank: the model's
      weights cut in place to a (1, 1) ('data', 'model') mesh
      (``training.shardspec.shard_module``: each block is the whole
      tensor and shares its storage, so no memory is allocated, which is
      checked) and served through ``make_prefill_step``/``make_decode_step``
      with ``mesh=`` on the same 4 × 2048 prompts, a warm-up, then a timed
      prefill and ``LM_MESH_GEN`` (8) decode steps: (i) the tokens equal
      4d's or 4e's first ones; (ii) K7 launched 32 times (K8 64) in the
      prefill and never in decode; one ``lm_mesh`` line with the prefill
      and per-token decode times beside 4d's or 4e's, and the collectives
      a step by kind (every weight's FSDP all_gather, the row-parallel
      all_reduces, the argmax's and the tokens' gathers: on one rank each
      is a copy or a sum of one over NCCL). Then K7 (bf16, causal; H 4,
      KV 1, dh 128, B 4, S 2048) and K8 (the ssm path's call form;
      d_inner 1024, B 4, L 2048, N 16), at a TP-8 rank's shapes of
      llama3-8b and falcon-mamba-7b, against their plain versions (K7 on
      ``flash_kernel_sm90`` at 1e-2, K8 bit-equal): one ``tp8_shapes``
      line. The launches of the mesh runs are ``lm_mesh_launches``. The
      multi-rank path is checked on the CPU over gloo
      (``tests/test_torch_lm_mesh.py``);
   m. Gopher Sentinel (``repro_torch.analysis``), after 4k (before the LM
      phases in run order): (1) Pass 2 (every registered semiring's laws
      and identities) and Pass 3 (the CUDA-source linter over
      ``kernels/csrc`` and the wrappers) report no error and no warning;
      (2) 4a's fused CC and SSSP at RN with ``validate=True``, each timed
      in turns with an unvalidated run (plain, validated, validated,
      plain; every run a new engine, so each validated run is its
      configuration's first and is recorded): zero collectives recorded,
      labels and distances bit-equal to the plain runs' and to 4a's, the
      same K3 launches; (3) on a world of ONE NCCL rank of its own, 4j's
      staged compact CC, phased CC (4c's taught plan) and 30-iteration
      dense PageRank the same way: bit-equal to the unvalidated runs
      (PageRank too: the same rank, the same order), equal Telemetry and
      K2/K5/K1 launches, no violation; (4) ``python -m
      repro_torch.launch.sentinel --matrix quick --devices 1 --device
      cuda`` exits 0 with no error in its report. One ``sentinel`` line a
      run with its recorded collectives per superstep, the validated
      ``warm_s`` beside the unvalidated, and the fingerprint gathers; one
      ``sentinel_cli`` line; one ``sentinel_phase`` line. The launches of
      the validated runs are ``sentinel_launches``;
   n. training on one card, after 4d/4e/4l (each model freed before the
      next): (i) h2o-danube-1.8b at full width and depth and (ii)
      falcon-mamba-7b at full width cut to 16 of its 64 layers (its whole
      train state, ~116 GB, does not fit the card) through
      ``make_train_step``: mixed-precision AdamW (bf16 model, float32
      master, m and v), remat, ``SyntheticLM`` batches of 4 × 2048 from
      seed 0, 2 warm-up and 10 timed steps; the loss finite on every step
      and lower at the last timed step than at the first; K7 launched
      twice a layer a step (the forward and remat's recompute) and K7b
      once (48 and 24), K8 and K8b likewise (32 and 16). One ``train``
      line each: step ms, tokens a second, peak memory, the losses, the
      backward kernel's CUDA-event ms a step and its share, and the
      profiler's device ms of a step by kind (the forward and backward
      kernels, gemm, other) with the idle share; h2o-danube-1.8b's K7b
      launches only the tensor-core ``flash_bwd_kernel_sm90`` kernels.
      (iii) Each family at full width cut to 2 layers, on 1 × 256-token
      ``SyntheticLM`` batches with 4n's schedule (lr 3e-4, 2 warm-up
      steps), the same weights and batches on the card (K7/K7b, K8/K8b)
      and on the CPU (the plain versions): in float32 (Adam eps 1e-5) the
      first step's loss at rtol 1e-4, its gradients and updated
      parameters within a relative L2 error of 1e-3; h2o-danube-1.8b then
      12 steps, every step's loss at rtol 1e-3, and 12 steps in bf16
      mixed precision, the first step's gradients within 5e-2 (the
      tensor-core K7b's model check), both sides' 12 losses logged;
      falcon-mamba-7b its first step alone (one ``train_cut`` line each
      run). (iv) K7b against ``flash_attention_bwd_ref`` at
      h2o-danube-1.8b's (B 4, S 2048, H 32, KV 8, dh 80), llama3-8b's (dh
      128, causal) and gemma3-4b's local layer (dh 256, window 1024): float32 on
      the SIMT kernel (rtol 1e-4, atol 1e-5), bf16 on the tensor-core
      route with o and lse from K7 (K7's lse at rtol 1e-5, +inf rows
      equal; the gradients at a relative L2 error of 1e-2 against the
      plain version given the same lse; dk and dv bit-equal over a second
      call, dq allclose; only ``flash_bwd_kernel_sm90`` launched), and (v)
      K8b against ``mamba1_scan_bwd_ref`` at falcon-mamba-7b's layer (B 4,
      L 2048, D 8192, N 16), in float32 (rtol 1e-4, atol 1e-5 of dB's, dC's
      and dA's scale) and bf16 (relative L2 1e-2), and two calls bit-equal
      in every output (K8b sums without atomics). The timed steps'
      launches are ``train_launches``;
5. kernel times at the paths' shapes: one ``{"kernels": [...]}`` line.
   ``launches`` counts phase 4's timed runs but 4f's, 4g's, 4h's, 4i's,
   4j's, 4k's, 4l's and 4m's, which stand beside it as
   ``incremental_launches``,
   ``serving_launches``, ``checkpoint_launches`` (4h's every run, its
   uncheckpointed CC and the chaos scenarios included),
   ``observability_launches`` (4i's every run in this process),
   ``mesh_launches`` (4j's mesh runs), ``failover_launches`` (4k's
   every run), ``lm_mesh_launches`` (4l's timed mesh runs),
   ``sentinel_launches`` (4m's validated runs) and ``train_launches``
   (4n's timed steps). The backward kernels K7b and K8b run on 4n's path
   only: their rows' ``launches`` are 4n's. K7b's row is at h2o-danube-
   1.8b's training layer (bf16, o and lse from K7), with llama3-8b's and
   gemma3-4b's local layer beside it and the SIMT kernel's time on the
   same inputs as its earlier time; ``ms`` is a call's three launches
   (pre, main, post); its bound is the visible pairs' 5 products of 2·dh
   FLOP at the bf16 tensor-core peak or its bytes, its library call
   ``torch.autograd.grad`` through SDPA (the backward alone). K8b's row is at falcon-mamba-7b's training layer
   (bf16 in, float32 dy); ``ms`` is a call's two launches (the scan and
   the partials' sums), ``kernel_ms`` the scan alone; its bound is the
   largest of its exps (one a (b, l, d, n)) over the SFU, its FLOP and its
   bytes (``k8b_bound``); ``layout`` what was built
   (``mamba_scan.k8b_layout``), ``decay`` how exp(δ·A) is taken.
   K3 is also held at the main path's CC superstep 0 with each walk
   forced. Its ``bound_ms`` counts only the rows with an active
   in-neighbour, summed over the plain version's sweeps, over the lanes
   some row uses; its row adds ``bound_dense_ms`` (every row every sweep,
   all D lanes: the TPU kernel's work) and ``bound_frontier_ms`` (the
   active rows over all D lanes). A ``k3`` line gives the counts and the
   cluster shape. K4 runs from CC's and SSSP's init states; its
   ``bound_ms`` counts the state in and out once, the rows delivered to
   over their feed bytes and the rows with an active in-neighbour over the
   lanes some row uses, summed over the plain loop's rounds
   (``k4_work``); ``bound_dense_ms`` is every row every round over all D
   lanes. The run fails if K3 or K4 is faster than its bound. A ``k4``
   line gives both runs' counts, shares and bytes. A ``barriers`` line
   times one grid.sync() over K4's cooperative grid and one cluster
   barrier at K3's cluster shape (``csrc/barrier_probe.cu``).
   ``ms`` is a kernel's device time by torch.profiler; ``call_ms`` the
   CUDA-event time of one wrapper call, which for a small kernel is
   mostly the host's time to enqueue it. K5's and K6's rows (at the
   compact CC run's first pack) add ``floor_ms``, an empty kernel launched
   the same way on their grid, beside the bytes bound, and the build's
   layout. K7's row adds ``batch_ms`` and ``library_batch_ms``: 20 back-to-back calls of K7 and of its library
   call timed by CUDA events, in turns, without the profiler. K8's row is
   at phase 4e's shape (B 4, L 2048, bf16 in, float32 y and the final
   state), bit-equal to the plain version; its bound is the largest of its
   exps over the SFU's rate (16 a clock an SM), its FLOP and its bytes
   (``k8_bound``; the run fails if K8 beats it), and a ``k8`` line gives
   the three, the share, the exps a second and the kernel's layout. The
   float32 row at B 2 with no state stands beside it, comparable with
   earlier runs.

Min/max results are held bit-equal; plus_times allclose (rtol=1e-6,
atol=1e-7 on the random ELL, whose values are O(1); rtol=1e-5, atol=0 at
PageRank's pull, whose values are O(1/n), and for phased PageRank against
dense); K4/K5/K6 outputs bit-equal; BlockRank rtol=1e-4, atol=0 against
its CPU run; K7 and K8 allclose at rtol = atol = 1e-5 in float32 and
1e-2 in bfloat16 (K8 computes in float32 and rounds once; K7's bf16
instantiation also rounds p to bf16 before p·V), and K8 in the ssm path's
call form bit-equal (``torch.equal``: every product and sum rounded on its
own, Σ_n in torch's order). K7's bound is
the visible pairs' FLOP at the bf16 tensor peak or its bytes at the HBM
rate, whichever is larger; its library call is
``F.scaled_dot_product_attention``. The last line is ``{"ok": true,
"device": {...}}``.
"""
import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
                                # (132 SMs · 128 lanes · 2 · 1.98 GHz)
SM_COUNT = 132                  # H100 SXM, NVIDIA's data sheet
SM_CLOCK_HZ = 1.98e9            # H100 SXM boost clock, NVIDIA's data sheet
SFU_EXPS_PER_CLOCK = 16         # exp2 (MUFU.EX2) results a clock an SM on
                                # compute capability 9.0, CUDA C++
                                # Programming Guide, arithmetic throughput
SEMIRINGS = ("min_plus", "max_first", "plus_times")
TOL_STEPS = 40                  # where phase 4b's tol PageRank must halt
HANDOFF = 3                     # K3 supersteps before K4 in phase 4c (ii)


def no_wgmma_spills(report: str) -> None:
    """Fail if ptxas spilled registers in a kernel that issues wgmma from
    inline assembly (K7's ``flash_kernel_sm90``, K7b's
    ``flash_bwd_kernel_sm90``): ptxas does not know the asynchronous
    products write their accumulators after the issue, so a spill of one
    between the issue and the wait corrupts it."""
    kernel = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif kernel and "_sm90I" in kernel and "bytes spill stores" in line:
            stores = int(line.split("bytes spill stores")[0].split(",")[-1])
            if stores:
                fail(f"ptxas spilled {stores} bytes in {kernel}")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn`` on the card, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batch_ms(fn, reps: int = 20) -> float:
    """Mean wall time of ``reps`` back-to-back calls of ``fn`` on the card,
    by CUDA events around the batch, after one warm-up call: for a call
    that keeps the card busy longer than the host takes to enqueue it, its
    device time without the profiler."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel=None, reps: int = 20, traces: int = 5) -> float:
    """Device time of one call of ``fn`` by torch.profiler (the card traced
    only) over ``reps`` calls after a warm-up call: per launch of the
    kernels whose names hold ``kernel``, or, with ``kernel=None``, of all
    the call's kernels. It leaves out the host's time to enqueue the call,
    which sets a small kernel's event-timed call (:func:`cuda_ms`). Each
    trace records a second window of ``reps`` calls after a warm-up window
    the profiler runs but discards (the profiler on the H100 lost launches
    at the start of a window). A trace that holds none of the kernels is
    taken again, up to ``traces`` times. With ``kernel=None`` a call's time
    is, over the kernel names, each name's mean time a launch times its
    launches a call (its count over ``reps``, rounded), taken only where
    every name's count is within a tenth of ``reps`` (at least 2) below
    that whole multiple; else the trace is taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for trace in range(traces):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for window in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                if window == 0:
                    prof.step()         # the warm-up window ends here
        hits = [(evt.count, evt.device_time_total / 1e3)
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA
                and (kernel is None or kernel in evt.key)]
        launches, ms = sum(c for c, _ in hits), sum(t for _, t in hits)
        if kernel is not None and launches:
            return ms / launches
        per_call = [max(1, round(c / reps)) for c, _ in hits]
        if kernel is None and launches and all(
                0 <= m * reps - c <= max(2, reps // 10)
                for m, (c, _) in zip(per_call, hits)):
            return sum(m * t / c for m, (c, t) in zip(per_call, hits))
        log(f"device_ms: trace {trace + 1} of {traces} saw "
            f"{[c for c, _ in hits]} launches of {kernel or 'any kernel'} "
            f"by name in {reps} calls")
    fail(f"the profiler saw no whole window of {kernel or 'any kernel'} in "
         f"{traces} traces")


def compare(semiring: str, got, want, what: str, rtol: float = 1e-6,
            atol: float = 1e-7) -> float:
    """Hold a kernel's output against its plain version (plus_times to
    ``rtol``/``atol``); returns the max absolute error over entries finite
    in both."""
    import torch
    g, w = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    if semiring in ("min_plus", "max_first", "bool"):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"{what}: {bad} entries differ from the plain version")
    else:
        if not np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True):
            fail(f"{what}: not allclose to the plain version")
    fin = np.isfinite(g) & np.isfinite(w)
    if not np.array_equal(np.isfinite(g), np.isfinite(w)):
        fail(f"{what}: non-finite entries differ")
    if g.dtype == bool or not fin.any():
        return 0.0
    return float(np.abs(g[fin].astype(np.float64) - w[fin]).max())


def gather(pg, per_part):
    """(P, v_max) -> (n,) global order."""
    out = np.zeros(pg.n_global, per_part.dtype)
    m = pg.vmask
    out[pg.global_id[m]] = per_part[m]
    return out


# ---------------- phase 1: environment ----------------

def environment():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0)


# ---------------- phase 3: kernels against their plain versions ----------

def check_k1(dev) -> None:
    import torch
    from repro_torch.kernels.ref import semiring_spmv_ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_cuda
    rng = np.random.default_rng(0)
    v, d = 2_000_000, 8
    x, nbr, wgt = (torch.from_numpy(a).to(dev)
                   for a in random_ell(rng, v, d))
    for sr in SEMIRINGS:
        got = semiring_spmv_cuda(x, nbr, wgt, sr)
        want = semiring_spmv_ref(x, nbr, wgt, sr)
        torch.cuda.synchronize()
        err = compare(sr, got, want, f"K1 {sr}")
        log(f"K1 semiring_spmv {sr}: V={v} D={d} agrees "
            f"(max_abs_err {err})")


def random_ell(rng, v: int, d: int):
    """A random ELL with PAD lanes, all-PAD rows and ±inf in x."""
    from repro_torch.gofs.formats import PAD
    nbr = rng.integers(0, v, (v, d), dtype=np.int32)
    nbr[rng.random((v, d)) < 0.3] = PAD
    nbr[rng.random(v) < 0.02] = PAD                  # all-PAD rows
    wgt = rng.uniform(0.1, 2.0, (v, d)).astype(np.float32)
    x = rng.uniform(0.0, 5.0, v).astype(np.float32)
    x[rng.random(v) < 0.01] = np.inf
    x[rng.random(v) < 0.01] = -np.inf
    return x, nbr, wgt


def check_k2(dev) -> None:
    import torch
    from repro_torch.kernels.ref import semiring_spmv_frontier_ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_frontier_cuda
    rng = np.random.default_rng(1)
    v, d = 2_000_000, 8
    x, nbr, wgt = (torch.from_numpy(a).to(dev)
                   for a in random_ell(rng, v, d))
    for density in (0.01, 0.5):
        f = torch.from_numpy(rng.random(v) < density).to(dev)
        for sr in ("min_plus", "max_first"):
            y, act = semiring_spmv_frontier_cuda(x, f, nbr, wgt, sr)
            wy, wact = semiring_spmv_frontier_ref(x, f, nbr, wgt, sr)
            torch.cuda.synchronize()
            compare(sr, y, wy, f"K2 {sr} density {density} y")
            compare("bool", act, wact, f"K2 {sr} density {density} "
                    f"row_active")
            log(f"K2 semiring_spmv_frontier {sr}: V={v} D={d} frontier "
                f"density {density}: y and row_active bit-equal "
                f"({int(act.sum())} active rows)")


def k5_k6_shapes() -> list:
    """(rows, cap) for K5's and K6's card checks: the main path's pair rows
    and larger ones, rows of one slot, one whole tile and one slot more (a
    carry into a second tile), a cap that is not a multiple of 4, and a
    row of many tiles."""
    from repro_torch.kernels.outbox_compact import k5_layout
    lay = k5_layout()
    tile = lay["threads"] * lay["slots"]
    return [(144, 969), (144, 4096), (4096, 969), (4096, 4096), (4096, 1),
            (64, tile), (64, tile + 1), (300, 1023), (3, 20011)]


def check_k5_k6(dev) -> None:
    import torch
    from repro_torch.kernels.outbox_compact import (outbox_compact_plan_cuda,
                                                    outbox_pack_cuda)
    from repro_torch.kernels.ref import (outbox_compact_plan_ref,
                                         outbox_pack_ref)
    rng = np.random.default_rng(2)
    cases = k6_cases = 0
    for rows, cap in k5_k6_shapes():
        vals = rng.uniform(-5.0, 5.0, (rows, cap)).astype(np.float32)
        vals[rng.random((rows, cap)) < 0.05] = np.inf
        vals[rng.random((rows, cap)) < 0.05] = -np.inf
        vals = torch.from_numpy(vals).to(dev)
        for density in (0.0, 0.05, 0.5, 1.0):
            act_np = rng.random((rows, cap)) < density
            cnt = act_np.sum(1)
            active = torch.from_numpy(act_np).to(dev)
            for budget in ("below", "above", "mixed"):
                lim = {"below": lambda: rng.integers(0, np.maximum(cnt, 1)),
                       "above": lambda: cnt + 1,
                       "mixed": lambda: np.choose(
                           np.arange(rows) % 3, [cnt // 2, cnt, cnt + 1]),
                       }[budget]()
                lim = torch.from_numpy(lim.astype(np.int32)).to(dev)
                for ident in (float("inf"), float("-inf")):
                    got = outbox_pack_cuda(vals, active, lim, ident)
                    want = outbox_pack_ref(vals, active, lim, ident)
                    torch.cuda.synchronize()
                    for name, a, b in zip(
                            ("pvals", "sids", "pinv", "counts", "over"),
                            got, want):
                        if not torch.equal(a, b):
                            fail(f"K5 R={rows} cap={cap} density {density} "
                                 f"budget {budget}: {name} differs from the "
                                 f"plain version")
                    cases += 1
            got = outbox_compact_plan_cuda(active)
            want = outbox_compact_plan_ref(active)
            torch.cuda.synchronize()
            for name, a, b in zip(("pfwd", "pinv", "counts"), got, want):
                if not torch.equal(a, b):
                    fail(f"K6 R={rows} cap={cap} density {density}: "
                         f"{name} differs from the plain version")
            k6_cases += 1
    log(f"K5 outbox_pack: {cases} cases, K6 outbox_compact_plan: {k6_cases} "
        f"cases, shapes (R, cap) {k5_k6_shapes()}, every output bit-equal")


def k3_run(what, cm, pg, semiring, unroll=1, check_inf=False) -> int:
    """Hold K3 bit for bit against its plain version over every superstep
    of a run from the program's init state; returns the supersteps."""
    import torch
    from repro_torch.core import (SemiringProgram, graph_block,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.kernels import megastep as mega
    gb = graph_block(pg, cm["vmask"].device)
    init = (init_max_vertex if semiring == "max_first"
            else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    st = SemiringProgram(semiring=semiring, init_fn=init).init(gb)
    x, ch, fr = (st[k].reshape(-1).contiguous()
                 for k in ("x", "changed_v", "frontier"))
    steps = 0
    while bool(ch.any()) and steps < 4096:
        got = mega.megastep_semiring_cuda(x, ch, fr, cm, semiring, unroll)
        want = mega.megastep_semiring_ref(x, ch, fr, cm, semiring, unroll)
        torch.cuda.synchronize()
        for name, kind, a, b in zip(
                ("x2", "changed2", "frontier_left", "liters"),
                (semiring, "bool", "bool", "max_first"), got, want):
            compare(kind, a, b, f"K3 {what} {semiring} superstep {steps} "
                    f"{name}")
        x, ch, fr = got[:3]
        steps += 1
    if bool(ch.any()):
        fail(f"K3 {what} {semiring}: no quiescence in {steps} supersteps")
    if check_inf and not bool(torch.isinf(x[cm["vmask"]]).any()):
        fail(f"K3 {what}: no row stayed unreachable")
    return steps


def check_k3(dev) -> None:
    """K3 against its plain version over every superstep of CC and SSSP
    runs: P = 12 on a road grid and P = 8 on a powerlaw graph with hub
    feed rows; one partition; 40 partitions, more than the clusters the
    card holds, so clusters take turns; each of K3's two walks forced
    through the wrapper's constant, and a constant at which they switch
    inside a fixpoint; unroll 3; SSSP with rows no path reaches."""
    from repro_torch.core import graph_block
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  powerlaw_social, road_grid)
    from repro_torch.kernels import megastep as mega

    def mailbox(g, P):
        pg = partition_graph(g, bfs_grow_partition(g, P, seed=0), P)
        return pg, mega.compose_mailbox(graph_block(pg, dev))

    both = ("max_first", "min_plus")
    for gname, g, P in (
            ("road_grid(300,300)", road_grid(300, 300, weighted=True,
                                             seed=1), 12),
            ("powerlaw_social(20000,m=5)",
             powerlaw_social(20000, m=5, seed=2), 8),
            ("road_grid(80,80)", road_grid(80, 80, weighted=True, seed=1), 1),
            ("road_grid(300,300)", road_grid(300, 300, weighted=True,
                                             seed=1), 40)):
        pg, cm = mailbox(g, P)
        shape = mega.k3_cluster_shape(P, "max_first", dev)
        if P == 40 and shape["clusters"] >= P:
            fail(f"K3 P=40: {shape['clusters']} clusters, expected fewer "
                 f"than the partitions")
        for sr in both:
            steps = k3_run(f"{gname} P={P}", cm, pg, sr)
            log(f"K3 megastep_semiring {gname} P={P} {sr}: {steps} "
                f"supersteps bit-equal (hub feed rows "
                f"{int(cm['hub_row_ok'].sum())}; {shape['clusters']} "
                f"clusters of {shape['blocks_per_cluster']} blocks)")
    pg, cm = mailbox(road_grid(120, 120, weighted=True, seed=4), 6)
    saved = mega.K3_DENSE_FRONTIER
    try:
        for frac, walk in ((0.0, "every sweep dense"),
                           (2.0, "every sweep by work list"),
                           (0.05, "walks switch mid-fixpoint")):
            mega.K3_DENSE_FRONTIER = frac
            for sr in both:
                k3_run(f"road_grid(120,120) P=6 {walk}", cm, pg, sr)
    finally:
        mega.K3_DENSE_FRONTIER = saved
    for sr in both:
        k3_run("road_grid(120,120) P=6 unroll 3", cm, pg, sr, unroll=3)
    pg, cm = mailbox(road_grid(120, 120, drop_frac=0.35, weighted=True,
                               seed=4), 6)
    k3_run("road_grid(120,120,drop_frac=0.35) P=6", cm, pg, "min_plus",
           check_inf=True)
    log("K3 megastep_semiring: both walks forced, a switch mid-fixpoint, "
        "unroll 3 and unreachable SSSP rows all bit-equal")


# (name, graph from repro_torch.gofs, P, semirings, K4_DENSE_FRONTIER or
# None): K4's cases, as
# tests/test_torch_cuda.py's test_k4_cases_match_plain holds them
K4_CASES = [
    ("one partition",
     lambda gofs: gofs.road_grid(80, 80, seed=1, weighted=True), 1,
     ("max_first", "min_plus"), None),
    ("40 partitions",
     lambda gofs: gofs.road_grid(300, 300, seed=1, weighted=True), 40,
     ("max_first", "min_plus"), None),
    ("every sweep dense",
     lambda gofs: gofs.road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), 0.0),
    ("every sweep by work list",
     lambda gofs: gofs.road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), 2.0),
    ("the walks switch mid-run",
     lambda gofs: gofs.road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), None),
    ("hub feed rows",
     lambda gofs: gofs.powerlaw_social(3000, m=5, seed=2), 4,
     ("max_first", "min_plus"), None),
    ("hub feed rows by work list",
     lambda gofs: gofs.powerlaw_social(3000, m=5, seed=2), 4,
     ("max_first", "min_plus"), 2.0),
    ("unreachable rows stay +inf",
     lambda gofs: gofs.road_grid(120, 120, drop_frac=0.35, seed=4,
                                 weighted=True), 6,
     ("min_plus",), None),
]
K4_EXITS = (0, 1, 2, 7)          # with rounds - 1, rounds and 4096


def k4_exits(what, cm, start, semiring, check_inf=False) -> int:
    """Hold K4 bit for bit against the plain loop from ``start`` at every
    exit: max_steps 0, 1, 2, 7, one round short of quiescence, at it, and
    4096 (a cut before quiescence hands the BSP state on). Returns the
    rounds to quiescence."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import megastep as mega
    rounds = int(mega.resident_megastep_ref(*start, cm, semiring, 4096)[3])
    for max_steps in sorted({*K4_EXITS, max(rounds - 1, 0), rounds, 4096}):
        before = _build.launches["resident_megastep"]
        got = mega.resident_megastep_cuda(*start, cm, semiring, max_steps)
        want = mega.resident_megastep_ref(*start, cm, semiring, max_steps)
        torch.cuda.synchronize()
        if _build.launches["resident_megastep"] != before + 1:
            fail(f"K4 {what}: not one launch a call")
        for name, kind, a, b in zip(
                ("x2", "changed2", "frontier2", "iters", "liters"),
                (semiring, "bool", "bool", "max_first", "max_first"),
                got, want):
            compare(kind, a, b, f"K4 {what} {semiring} max_steps "
                    f"{max_steps} {name}")
        if int(got[3]) != min(max_steps, rounds):
            fail(f"K4 {what} {semiring}: {int(got[3])} rounds at max_steps "
                 f"{max_steps}, the plain loop quiesces after {rounds}")
    if check_inf and not bool(torch.isinf(got[0][cm["vmask"]]).any()):
        fail(f"K4 {what}: no row stayed unreachable")
    return rounds


def check_k4(dev) -> None:
    """K4 against the plain resident loop at every exit (:func:`k4_exits`)
    from the init state and after K3 supersteps: P = 12 on a road grid and
    P = 8 on a powerlaw graph, then :data:`K4_CASES`: one partition, 40
    partitions, each of K4's two walks forced through the wrapper's
    constant and the constant at which they switch mid-run, hub feed rows
    (also by work list), SSSP rows no path reaches, and a feed row outside
    vmask that its neighbours list."""
    import torch
    from repro_torch import gofs
    from repro_torch.core import (SemiringProgram, graph_block,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.kernels import megastep as mega

    def starts(pg, gb, cm, sr, k3_steps):
        init = (init_max_vertex if sr == "max_first"
                else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
        st = SemiringProgram(semiring=sr, init_fn=init).init(gb)
        state = tuple(st[k].reshape(-1).contiguous()
                      for k in ("x", "changed_v", "frontier"))
        after = state
        for _ in range(k3_steps):
            after = mega.megastep_semiring_cuda(*after, cm, sr)[:3]
        return {"init": state, f"after {k3_steps} K3": after}

    saved = mega.K4_DENSE_FRONTIER
    cases = [("road_grid(300,300)",
              lambda gofs: gofs.road_grid(300, 300, weighted=True, seed=1),
              12, ("max_first", "min_plus"), None),
             ("powerlaw_social(20000,m=5)",
              lambda gofs: gofs.powerlaw_social(20000, m=5, seed=2), 8,
              ("max_first", "min_plus"), None)] + K4_CASES
    try:
        for gname, make, P, semirings, frac in cases:
            g = make(gofs)
            pg = gofs.partition_graph(g, gofs.bfs_grow_partition(g, P,
                                                                 seed=0), P)
            gb = graph_block(pg, dev)
            cm = mega.compose_mailbox(gb)
            mega.K4_DENSE_FRONTIER = saved if frac is None else frac
            hubs = int(cm["hub_row_ok"][mega.feed_rows(cm).long()].sum())
            if gname.startswith("hub") and not hubs:
                fail(f"K4 {gname}: no hub feed row")
            for sr in semirings:
                for sname, start in starts(pg, gb, cm, sr,
                                           1 if P < 12 else 2).items():
                    if gname == "the walks switch mid-run" and \
                            sname == "init":
                        sizes = k4_work(cm, *start, sr)[0]["frontier"]
                        rows = mega.k4_dense_rows(cm["n"])
                        if not ((sizes >= rows).any()
                                and ((sizes > 0) & (sizes < rows)).any()):
                            fail("K4: the walks do not switch mid-run")
                    rounds = k4_exits(
                        f"{gname} P={P} from {sname}", cm, start, sr,
                        check_inf=gname.startswith("unreachable"))
                    log(f"K4 resident_megastep {gname} P={P} {sr} from "
                        f"{sname}: {rounds} rounds, every exit bit-equal "
                        f"(feed rows {mega.feed_rows(cm).numel()}, hub "
                        f"feed rows {hubs})")
    finally:
        mega.K4_DENSE_FRONTIER = saved
    # a feed row outside vmask that its neighbours list: a delivery that
    # changes it reaches no frontier, and K4 writes it into both arrays
    g = gofs.road_grid(120, 120, seed=4, weighted=True)
    pg = gofs.partition_graph(g, gofs.bfs_grow_partition(g, 6, seed=0), 6)
    gb = graph_block(pg, dev)
    cm = mega.compose_mailbox(gb)
    feed = mega.feed_rows(dict(cm))
    v = int(feed[torch.isin(feed, cm["nbr"])][0])
    cm["nbr"], cm["vmask"] = cm["nbr"].clone(), cm["vmask"].clone()
    cm["nbr"][v], cm["vmask"][v] = -1, False
    for sr in ("max_first", "min_plus"):
        start = starts(pg, gb, cm, sr, 0)["init"]
        rounds = k4_exits("a feed row outside vmask", cm, start, sr)
        log(f"K4 resident_megastep a feed row outside vmask {sr}: {rounds} "
            f"rounds, every exit bit-equal")


# (what, B, Sq, Sk, H, KV, dh, window, q_offset, dtype): llama3-8b's
# prefill, gemma3-4b's local layers, float32 inputs, a continuation with
# Sq < Sk (ragged: 333 queries, 1,357 keys) in float32 and bf16, and
# h2o-danube-1.8b's prefill (dh 2560 / 32 = 80)
K7_CHECKS = [
    ("llama3-8b prefill", 4, 2048, 2048, 32, 8, 128, None, 0, "bfloat16"),
    ("gemma3-4b local", 2, 4096, 4096, 8, 4, 256, 1024, 0, "bfloat16"),
    ("float32", 1, 2048, 2048, 32, 8, 128, None, 0, "float32"),
    ("q_offset 1024, Sq < Sk", 2, 333, 1357, 32, 8, 128, None, 1024,
     "float32"),
    ("h2o-danube-1.8b prefill", 4, 2048, 2048, 32, 8, 80, 4096, 0,
     "bfloat16"),
    ("bf16 q_offset 1024, Sq < Sk", 2, 333, 1357, 32, 8, 128, None, 1024,
     "bfloat16"),
]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}    # rtol = atol


def attention_inputs(dev, seed, B, Sq, Sk, H, KV, dh, dtype):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=dev).to(
        getattr(torch, dtype)) for s in ((B, Sq, H, dh), (B, Sk, KV, dh),
                                         (B, Sk, KV, dh)))


def held(got, want, tol: float, what: str) -> float:
    """Hold a kernel's output to its plain version at rtol = atol = tol;
    returns the max absolute error."""
    import torch
    g, w = got.float(), want.float()
    if tuple(g.shape) != tuple(w.shape) or not bool(torch.isfinite(g).all()):
        fail(f"{what}: shape {tuple(g.shape)} or non-finite entries")
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        fail(f"{what}: not allclose to the plain version at {tol} (max abs "
             f"err {float((g - w).abs().max())})")
    return float((g - w).abs().max())


def kernel_names(fn, kernel: str, traces: int = 5) -> list:
    """The names of the kernels holding ``kernel`` that one call of ``fn``
    launched, by torch.profiler, recorded in a second window after a
    warm-up window the profiler runs but discards (it lost launches at the
    start of a window, :func:`device_ms`); a trace that lost them all is
    taken again, up to ``traces`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for window in range(2):
                fn()
                torch.cuda.synchronize()
                if window == 0:
                    prof.step()         # the warm-up window ends here
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and kernel in e.key})
        if names:
            return names
    fail(f"the profiler saw no launch of {kernel} in {traces} traces")


def k7_instantiation(dt: str, dh: int) -> str:
    """The name K7's wrapper must launch for ``dt`` at head width ``dh``
    (``kernels/flash_attention.py``)."""
    from repro_torch.kernels.flash_attention import SM90_HEAD_DIMS
    if dt == "bfloat16" and dh in SM90_HEAD_DIMS:
        return f"flash_kernel_sm90<{dh}>"
    elem = "float" if dt == "float32" else "__nv_bfloat16"
    return f"flash_kernel<{elem}, {dh}>"


def check_k7(dev) -> None:
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    for i, (what, B, Sq, Sk, H, KV, dh, win, off, dt) in enumerate(K7_CHECKS):
        q, k, v = attention_inputs(dev, i, B, Sq, Sk, H, KV, dh, dt)
        got = flash_attention_cuda(q, k, v, causal=True, window=win,
                                   q_offset=off)
        want = flash_attention_ref(q, k, v, causal=True, window=win,
                                   q_offset=off)
        torch.cuda.synchronize()
        err = held(got, want, TOL[dt], f"K7 {what}")
        del got, want
        names = kernel_names(lambda: flash_attention_cuda(
            q, k, v, causal=True, window=win, q_offset=off), "flash_kernel")
        expect = k7_instantiation(dt, dh)
        if len(names) != 1 or expect not in names[0]:
            fail(f"K7 {what}: ran {names}, expected {expect}")
        log(f"K7 flash_attention {what}: B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} "
            f"dh={dh} window={win} q_offset={off} {dt} agrees "
            f"(max_abs_err {err}) on {expect}")
        del q, k, v
        torch.cuda.empty_cache()


def mamba_inputs(dev, dtype, B=2, L=2048, D=8192, N=16):
    """falcon-mamba-7b's scan width (D = 2·4096, N = 16)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((B, L, D), generator=gen, device=dev) * 0.5
    dt = torch.rand((B, L, D), generator=gen, device=dev) * 0.49 + 0.01
    bv = torch.randn((B, L, N), generator=gen, device=dev)
    cv = torch.randn((B, L, N), generator=gen, device=dev)
    a = -(torch.rand((D, N), generator=gen, device=dev) * 1.5 + 0.5)
    dtype = getattr(torch, dtype)
    return tuple(t.to(dtype) for t in (x, dt, bv, cv)) + (a,)


def check_k8(dev) -> float:
    """K8 against its plain version at falcon-mamba-7b's scan width in the
    Pallas kernel's contract (float32 and bf16, h from 0, y in the inputs'
    dtype; allclose at ``TOL``), then in the ssm path's call form: bf16
    inputs, a nonzero h0, float32 y and the final state, both bit-equal to
    the plain version (the same float32 ops in the same order). Returns
    the float32 error."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba1_scan_cuda, mamba1_scan_ref
    errs = []
    for dt in ("float32", "bfloat16"):
        args = mamba_inputs(dev, dt)
        got = mamba1_scan_cuda(*args)
        want = mamba1_scan_ref(*args)
        torch.cuda.synchronize()
        errs.append(held(got, want, TOL[dt], f"K8 {dt}"))
        log(f"K8 mamba1_scan {tuple(args[0].shape)} N={args[4].shape[1]} "
            f"{dt} agrees (max_abs_err {errs[-1]})")
    args = mamba_inputs(dev, "bfloat16")
    B, _, D = args[0].shape
    h0 = torch.randn((B, D, args[4].shape[1]), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(8))
    got = mamba1_scan_cuda(*args, h0, return_state=True,
                           y_dtype=torch.float32)
    want = mamba1_scan_ref(*args, h0, return_state=True,
                           y_dtype=torch.float32)
    torch.cuda.synchronize()
    if got[0].dtype != torch.float32:
        fail(f"K8 path form: y is {got[0].dtype}, not float32")
    err_y = bitwise(got[0], want[0], "K8 path form y")
    err_h = bitwise(got[1], want[1], "K8 path form h_last")
    log(f"K8 mamba1_scan {tuple(args[0].shape)} bf16 in, h0, float32 y and "
        f"h_last bit-equal to the plain version (max_abs_err y {err_y}, "
        f"h_last {err_h})")
    return errs[0]


def bitwise(got, want, what: str) -> float:
    """Hold a kernel's output bit-equal (``torch.equal``) to its plain
    version; returns the max absolute error (0.0)."""
    import torch
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        fail(f"{what}: {got.dtype} {tuple(got.shape)}, expected "
             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"{what}: {bad} entries differ from the plain version (max abs "
             f"err {float((got.float() - want.float()).abs().max())})")
    return float((got.float() - want.float()).abs().max())

# ---------------- phase 4: the main path ----------------

def main_path(dev):
    import torch
    import scipy.sparse.csgraph as csgraph
    from repro_torch import algorithms
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    t1 = time.perf_counter()
    assign = bfs_grow_partition(g, 12, seed=0)
    t2 = time.perf_counter()
    pg = partition_graph(g, assign, 12)
    t3 = time.perf_counter()
    # BFS runs on the unweighted build of the same grid (same edges, same
    # partition: road_grid draws the deletions before the weights)
    ug = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=False)
    upg = partition_graph(ug, assign, 12)
    log(json.dumps({
        "graph": "road_grid(1400,1400,drop_frac=0.03,seed=1)", "n": g.n,
        "nnz": g.nnz, "parts": 12, "v_max": pg.v_max, "d_max": pg.d_max,
        "mailbox_cap": pg.mailbox_cap, "cut_edges": pg.edge_cut(),
        "host_s": {"generate": t1 - t0, "bfs_grow_partition": t2 - t1,
                   "partition_graph": t3 - t2,
                   "unweighted_build": time.perf_counter() - t3}}))
    src = 0
    runs = {
        "cc": (lambda: algorithms.connected_components(pg),
               ["megastep_semiring"]),
        "sssp": (lambda: algorithms.sssp(pg, src), ["megastep_semiring"]),
        "bfs": (lambda: algorithms.bfs(upg, src), ["megastep_semiring"]),
        "pagerank": (lambda: algorithms.pagerank(pg, num_iters=30),
                     ["semiring_spmv"]),
    }
    path_launches = dict.fromkeys(_build.launches, 0)
    results = drive(dev, runs, path_launches, g.n)

    # against scipy / numpy
    labels, ncc, _ = results["cc"]
    ncc_true, lab_true = csgraph.connected_components(g.undirected_csr(),
                                                      directed=False)
    ours = gather(pg, labels)
    if ncc != ncc_true:
        fail(f"cc: {ncc} components, scipy finds {ncc_true}")
    # same partition: each scipy component maps to one label and back
    pairs = np.unique(np.stack([lab_true, ours]), axis=1)
    if pairs.shape[1] != ncc_true:
        fail("cc: the components differ from scipy's")
    dist = gather(pg, results["sssp"][0])
    d_true = csgraph.dijkstra(g.csr().T, indices=[src])[0]
    fin = np.isfinite(d_true)
    if not np.array_equal(np.isfinite(dist), fin) or not np.allclose(
            dist[fin], d_true[fin], rtol=1e-5):
        fail("sssp: distances differ from scipy's dijkstra")
    lvl = gather(upg, results["bfs"][0])
    hops = csgraph.shortest_path(ug.undirected_csr(), unweighted=True,
                                 indices=[src])[0]
    if not np.array_equal(lvl, hops.astype(np.float32)):
        fail("bfs: hop counts differ from scipy's")
    r = gather(pg, results["pagerank"][0])
    a = g.csr().copy()            # its data would alias g.weights
    a.data[:] = 1.0
    outdeg = g.out_degree.astype(np.float64)
    rr = np.full(g.n, 1.0 / g.n)
    for _ in range(30):
        contrib = np.where(outdeg > 0, rr / np.maximum(outdeg, 1), 0)
        rr = 0.15 / g.n + 0.85 * (a @ contrib + rr[outdeg == 0].sum() / g.n)
    if not np.allclose(r, rr, rtol=1e-4, atol=1e-9):
        fail(f"pagerank: max abs diff {np.abs(r - rr).max()} from the "
             f"float64 power iteration")
    log(f"main path checks: cc {ncc} components, sssp {int(fin.sum())} "
        f"reached, bfs max {int(hops[np.isfinite(hops)].max())} hops, "
        f"pagerank max abs diff {np.abs(r - rr).max():.3e} — all agree")
    truth = {"cc": (lab_true, ncc_true), "sssp": d_true, "bfs": hops,
             "pagerank": rr}
    staged = staged_path(dev, g, ug, pg, upg, src, results, path_launches,
                         truth)
    plain_k4, tiers_4c, counts_4c, taught = tier_path(
        dev, pg, src, results, staged, path_launches, truth)
    breakdown(pg, upg, src)
    incremental_launches = dict.fromkeys(_build.launches, 0)
    delta = incremental_path(dev, g, ug, pg, upg, src, results,
                             incremental_launches)
    serving_launches = dict.fromkeys(_build.launches, 0)
    svc, served = serving_path(dev, g, ug, pg, upg, delta,
                               serving_launches)
    checkpoint_launches = dict.fromkeys(_build.launches, 0)
    checkpoint_path(dev, pg, src, results, staged, checkpoint_launches)
    observability_launches = dict.fromkeys(_build.launches, 0)
    observability_path(dev, pg, src, results, staged, svc,
                       observability_launches)
    mesh_launches = dict.fromkeys(_build.launches, 0)
    mesh_runs = mesh_path(dev, pg, src, {**staged, **tiers_4c}, counts_4c,
                          taught, mesh_launches)
    failover_launches = dict.fromkeys(_build.launches, 0)
    failover_path(dev, pg, upg, src, delta, served, mesh_runs, taught,
                  failover_launches)
    sentinel_launches = dict.fromkeys(_build.launches, 0)
    sentinel_path(dev, pg, src, results, {**staged, **tiers_4c}, taught,
                  sentinel_launches)
    return (pg, path_launches, incremental_launches, serving_launches,
            checkpoint_launches, observability_launches, mesh_launches,
            failover_launches, sentinel_launches, plain_k4)


def drive(dev, runs: dict, path_launches: dict, n: int,
          record=None, warm: bool = True) -> dict:
    """Run each ``name: (fn, kernels)`` once to warm up, then once more
    with the launch counts set to 0 just before it and read just after; fail
    if a kernel of its path was never launched. One JSON line per run;
    returns the timed runs' outputs, and puts each timed run's launch
    counts into ``record`` where one is given. ``warm=False`` skips the
    warm-up call, where an earlier run of the same kind in this process
    already built the kernels and primed the allocator (each run builds
    its own engine either way): ``first_s`` is then the timed call's."""
    import torch
    from repro_torch.kernels import _build
    first = {}
    for name, (fn, _) in runs.items() if warm else ():   # not counted
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first[name] = time.perf_counter() - t
    results = {}
    for name, (fn, kernels) in runs.items():
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(_build.launches)
        for k in kernels:
            if launches[k] == 0:
                fail(f"{name}: kernel {k} was never launched")
        for k, c in launches.items():
            path_launches[k] += c
        if record is not None:
            record[name] = launches
        tele = out[-1] if name != "blockrank" else out[1]
        results[name] = out
        log(json.dumps({
            "algorithm": name, "n": n, "parts": 12,
            "exchange": tele.exchange, "supersteps": tele.supersteps,
            "local_iters_sum": int(tele.local_iters.sum()),
            "first_s": first.get(name, secs), "warm_s": secs,
            "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}))
    return results


def _masked(pg, x, fill):
    x = np.array(x)
    x[~pg.vmask] = fill
    return x


def _as_result(pg, algo, x):
    """An engine run's (P, v_max) state as the public function returns it:
    CC labels as int64 with -1 padding, distances with inf padding."""
    if algo == "cc":
        return np.where(pg.vmask, x, -1).astype(np.int64)
    return _masked(pg, x, np.inf)


def staged_path(dev, g, ug, pg, upg, src, fused, path_launches, truth):
    """Phase 4b: the staged route at RN scale, each run checked (see the
    module docstring). ``fused`` holds phase 4a's results, ``truth`` scipy's
    CC labels, Dijkstra distances and BFS hops and the 30-iteration float64
    power iteration. Returns the timed runs' outputs."""
    from repro_torch import algorithms
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, init_max_vertex,
                                  make_bfs_init, make_sssp_init)
    # the float64 power iteration to TOL_STEPS, with each iteration's L1
    # delta; a tol between the last two deltas (about 8 % from each, far
    # above float32's noise in the card's delta) halts PageRank there
    a = g.csr().copy()            # its data would alias g.weights
    a.data[:] = 1.0
    outdeg = g.out_degree.astype(np.float64)
    rr = np.full(g.n, 1.0 / g.n)
    deltas = []
    for _ in range(TOL_STEPS):
        contrib = np.where(outdeg > 0, rr / np.maximum(outdeg, 1), 0)
        r_next = 0.15 / g.n + 0.85 * (a @ contrib
                                      + rr[outdeg == 0].sum() / g.n)
        deltas.append(np.abs(r_next - rr).sum())
        rr = r_next
    tol = float(np.sqrt(deltas[-2] * deltas[-1]))
    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    progs = {"cc": SemiringProgram("max_first", init_max_vertex),
             "sssp": SemiringProgram("min_plus", make_sssp_init(*loc)),
             "bfs": SemiringProgram("min_plus", make_bfs_init(*loc))}
    graph = {"cc": pg, "sssp": pg, "bfs": upg}

    def engine(algo, exchange):
        return lambda: GopherEngine(graph[algo], progs[algo],
                                    exchange=exchange).run()

    k2, k5, k1 = "semiring_spmv_frontier", "outbox_pack", "semiring_spmv"
    runs = {f"{a}_dense": (engine(a, "dense"), [k2])
            for a in ("cc", "sssp", "bfs")}
    runs.update({f"{a}_compact": (engine(a, "compact"), [k2, k5])
                 for a in ("cc", "sssp")})
    runs["cc_vertex"] = (lambda: algorithms.connected_components(
        pg, mode="vertex"), [k1])
    runs["sssp_vertex"] = (lambda: algorithms.sssp(pg, src, mode="vertex"),
                           [k1])
    runs["pagerank_dense"] = (lambda: GopherEngine(
        pg, PageRankProgram(n_global=pg.n_global, num_iters=30),
        exchange="dense", max_supersteps=64).run(), [k1])
    runs["pagerank_tol"] = (lambda: algorithms.pagerank(
        pg, num_iters=200, tol=tol), [k1])
    runs["blockrank"] = (lambda: algorithms.blockrank(pg), [k1])
    res = drive(dev, runs, path_launches, g.n)

    # dense against the fused route: same bits, supersteps and sweeps
    fx = {"cc": fused["cc"][0], "sssp": fused["sssp"][0],
          "bfs": fused["bfs"][0]}
    ft = {a: fused[a][-1] for a in fx}

    for a in ("cc", "sssp", "bfs"):
        state, t = res[f"{a}_dense"]
        if not np.array_equal(_as_result(graph[a], a, state["x"]), fx[a]):
            fail(f"{a}_dense: results differ from the fused route's")
        if t.supersteps != ft[a].supersteps or not np.array_equal(
                t.local_iters, ft[a].local_iters):
            fail(f"{a}_dense: supersteps/local_iters differ from the fused "
                 f"route's ({t.supersteps} vs {ft[a].supersteps})")
    for a in ("cc", "sssp"):
        state, t = res[f"{a}_compact"]
        dstate, dt = res[f"{a}_dense"]
        if not np.array_equal(state["x"], dstate["x"]):
            fail(f"{a}_compact: results differ from dense")
        if not np.array_equal(t.count_hist, ft[a].count_hist):
            fail(f"{a}_compact: count_hist differs from the fused route's")
        if not t.wire_slots < dt.wire_slots:
            fail(f"{a}_compact: wire {t.wire_slots} not below dense's "
                 f"{dt.wire_slots}")
        log(f"{a}: compact wire {t.wire_slots} slots vs dense "
            f"{dt.wire_slots} ({t.bytes_on_wire} vs {dt.bytes_on_wire} B)")

    # vertex-centric runs against scipy and against the fused route
    labels, ncc, tv_cc = res["cc_vertex"]
    lab_true, ncc_true = truth["cc"]
    pairs = np.unique(np.stack([lab_true, gather(pg, labels)]), axis=1)
    if ncc != ncc_true or pairs.shape[1] != ncc_true:
        fail("cc_vertex: the components differ from scipy's")
    if not np.array_equal(labels, fx["cc"]):
        fail("cc_vertex: labels differ from the sub-graph centric run's")
    dist, tv_sssp = res["sssp_vertex"]
    d_true = truth["sssp"]
    fin = np.isfinite(d_true)
    got = gather(pg, dist)
    if not np.array_equal(np.isfinite(got), fin) or not np.allclose(
            got[fin], d_true[fin], rtol=1e-5):
        fail("sssp_vertex: distances differ from scipy's dijkstra")
    for a, tv in (("cc", tv_cc), ("sssp", tv_sssp)):
        sub = ft[a].supersteps
        log(json.dumps({"fig4c": a, "subgraph_supersteps": sub,
                        "vertex_supersteps": tv.supersteps}))
        if not sub < tv.supersteps:
            fail(f"{a}: sub-graph mode took {sub} supersteps, vertex mode "
                 f"{tv.supersteps}: no superstep reduction")

    # PageRank on the staged route against the float64 power iteration: 30
    # iterations, and a tol that halts it after TOL_STEPS
    state, t = res["pagerank_dense"]
    r = gather(pg, _masked(pg, state["r"], 0.0))
    if t.supersteps != 30 or not np.allclose(r, truth["pagerank"], rtol=1e-4,
                                             atol=1e-9):
        fail(f"pagerank_dense: max abs diff "
             f"{np.abs(r - truth['pagerank']).max()} from the float64 power "
             f"iteration")
    rt, tt = res["pagerank_tol"]
    if tt.supersteps != TOL_STEPS:
        fail(f"pagerank_tol: halted after {tt.supersteps} supersteps, the "
             f"float64 power iteration's delta crosses tol {tol} after "
             f"{TOL_STEPS}")
    rt = gather(pg, rt)
    if not np.allclose(rt, rr, rtol=1e-4, atol=1e-9):
        fail(f"pagerank_tol: max abs diff {np.abs(rt - rr).max()} from the "
             f"float64 power iteration")
    # BlockRank against the port's run of it on the CPU, where every kernel
    # is its plain version: same blocks, supersteps and ranks
    rb, tb, info = res["blockrank"]
    t0 = time.perf_counter()
    rc, tc, info_c = algorithms.blockrank(pg, device="cpu")
    cpu_s = time.perf_counter() - t0
    if info["num_meta"] != info_c["num_meta"] or not np.allclose(
            info["blockrank"], info_c["blockrank"], rtol=1e-12, atol=0.0):
        fail("blockrank: the block ranks differ from the CPU run's")
    if tb.supersteps != tc.supersteps:
        fail(f"blockrank: {tb.supersteps} supersteps, {tc.supersteps} on "
             f"the CPU")
    rel = np.abs(rb - rc)[pg.vmask] / rc[pg.vmask]
    if not np.allclose(rb, rc, rtol=1e-4, atol=0.0):
        fail(f"blockrank: max relative diff {rel.max()} from the CPU run")
    log(f"staged path checks: dense = fused for cc/sssp/bfs, compact = "
        f"dense, vertex mode = scipy; pagerank_dense max abs diff "
        f"{np.abs(r - truth['pagerank']).max():.3e}; pagerank_tol (tol "
        f"{tol:.6e}) halted after {tt.supersteps} supersteps as the power "
        f"iteration does, max abs diff {np.abs(rt - rr).max():.3e}; "
        f"blockrank ({info['num_meta']} blocks, {tb.supersteps} supersteps) "
        f"max rel diff {rel.max():.3e} from its CPU run ({cpu_s:.1f} s) — "
        f"all agree")
    return res


def tier_path(dev, pg, src, fused, staged, path_launches, truth):
    """Phase 4c: tier plans at RN scale, each run checked (see the module
    docstring). ``fused`` and ``staged`` hold phases 4a's and 4b's results,
    ``truth`` scipy's. Returns the plain resident loop's runs from CC's and
    SSSP's init states (outputs and CUDA-event ms), which phase 5 holds K4
    to."""
    import torch
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  PhasedTierPlan, SemiringProgram, TierPlan,
                                  graph_block, host_graph_block,
                                  init_max_vertex, make_sssp_init,
                                  update_changed_profile, update_profile)
    from repro_torch.core import tiers
    from repro_torch.kernels import megastep as mega

    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    progs = {"cc": SemiringProgram("max_first", init_max_vertex),
             "sssp": SemiringProgram("min_plus", make_sssp_init(*loc))}
    structural = PhasedTierPlan.from_graph(pg)
    rb = [p.schedule(1).round_bytes(None) for p in structural.phase_plans()]
    if mega.resident_enter_round(rb, structural.boundaries) != 0:
        fail(f"the structural plan's round ({rb} B) does not fit the "
             f"resident gate ({mega.RESIDENT_ROUND_BYTES_BUDGET} B)")
    # (ii): the structural table to round HANDOFF, then an all-cold tail,
    # under a gate lowered to the tail's round: HANDOFF K3 supersteps, K4
    base = TierPlan.from_graph(pg)
    cold = np.where(base.tiers == tiers.EXCLUDED, tiers.EXCLUDED,
                    tiers.COLD).astype(np.int8).tobytes()
    handoff = PhasedTierPlan(num_parts=base.num_parts, cap=base.cap,
                             warm_cap=base.warm_cap,
                             phase_tier_bytes=(base.tier_bytes, cold),
                             boundaries=(HANDOFF, tiers._NO_BOUNDARY))
    tail_bytes = handoff.phase_plans()[1].schedule(1).round_bytes(None)
    narrow = dataclasses.replace(base, tier_bytes=cold)       # (iv)
    # (v): the plan taught by phase 4b's compact CC run
    hb = host_graph_block(pg)
    tc = staged["cc_compact"][1]
    update_profile(hb, tc.pair_slots, tc.pair_rounds)
    update_changed_profile(hb, tc.count_hist)
    taught = PhasedTierPlan.from_block(hb)
    log(json.dumps({"plans": {
        "structural_round_bytes": rb,
        "resident_budget": mega.RESIDENT_ROUND_BYTES_BUDGET,
        "handoff_tail_round_bytes": tail_bytes,
        "tiered_round_slots": base.schedule(1).round_slots(),
        "tiered_counts": base.counts(),
        "taught_boundaries": [b for b in taught.boundaries],
        "taught_round_slots": [p.schedule(1).round_slots()
                               for p in taught.phase_plans()]}}))

    def engine(algo, exchange, plan):
        return lambda: GopherEngine(pg, progs[algo], exchange=exchange,
                                    tier_plan=plan).run()

    def lowered(fn):
        def run():
            saved = mega.RESIDENT_ROUND_BYTES_BUDGET
            mega.RESIDENT_ROUND_BYTES_BUDGET = tail_bytes
            try:
                return fn()
            finally:
                mega.RESIDENT_ROUND_BYTES_BUDGET = saved
        return run

    k1, k2, k3, k4, k5 = ("semiring_spmv", "semiring_spmv_frontier",
                          "megastep_semiring", "resident_megastep",
                          "outbox_pack")
    runs = {}
    for a in ("cc", "sssp"):
        runs[f"{a}_resident"] = (engine(a, "megastep", structural), [k4])
        runs[f"{a}_handoff"] = (lowered(engine(a, "megastep", handoff)),
                                [k3, k4])
        runs[f"{a}_tiered"] = (engine(a, "tiered", base), [k2, k5])
    runs["cc_tiered_spill"] = (engine("cc", "tiered", narrow), [k2, k5])
    for a in ("cc", "sssp"):
        runs[f"{a}_phased"] = (engine(a, "phased", taught), [k2, k5])
    runs["pagerank_phased"] = (lambda: GopherEngine(
        pg, PageRankProgram(n_global=pg.n_global, num_iters=30),
        exchange="phased", tier_plan=taught, max_supersteps=64).run(),
        [k1, k5])
    counts = {}
    res = drive(dev, runs, path_launches, pg.n_global, record=counts)

    # (i) and (ii): resident runs against the fused route, scipy and the
    # plain resident loop on the card
    gb = graph_block(pg, dev)
    cm = mega.compose_mailbox(gb)
    lab_true, ncc_true = truth["cc"]
    plain = {}
    for a in ("cc", "sssp"):
        state, t = res[f"{a}_resident"]
        got = _as_result(pg, a, state["x"])
        if not np.array_equal(got, fused[a][0]):
            fail(f"{a}_resident: results differ from the fused route's")
        if counts[f"{a}_resident"][k4] != 1 or counts[f"{a}_resident"][k3]:
            fail(f"{a}_resident: {counts[f'{a}_resident']} launches, not "
                 f"one K4 launch")
        st = progs[a].init(gb)
        start = tuple(st[k].reshape(-1).contiguous()
                      for k in ("x", "changed_v", "frontier"))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        ref = mega.resident_megastep_ref(*start, cm, progs[a].semiring,
                                         4096)
        t1.record()
        torch.cuda.synchronize()
        if int(ref[3]) != t.supersteps or not np.array_equal(
                ref[4].cpu().numpy(), t.local_iters):
            fail(f"{a}_resident: {t.supersteps} supersteps, the plain "
                 f"resident loop {int(ref[3])} rounds (or sweeps differ)")
        if not np.array_equal(ref[0].cpu().numpy(),
                              state["x"].reshape(-1)):
            fail(f"{a}_resident: results differ from the plain loop's")
        plain[a] = (ref, t0.elapsed_time(t1))
        if a == "cc":
            pairs = np.unique(np.stack([lab_true, gather(pg, got)]), axis=1)
            if pairs.shape[1] != ncc_true:
                fail("cc_resident: the components differ from scipy's")
        else:
            d = gather(pg, got)
            fin = np.isfinite(truth["sssp"])
            if not np.array_equal(np.isfinite(d), fin) or not np.allclose(
                    d[fin], truth["sssp"][fin], rtol=1e-5):
                fail("sssp_resident: distances differ from scipy's dijkstra")
        hs, ht = res[f"{a}_handoff"]
        if not np.array_equal(_as_result(pg, a, hs["x"]), fused[a][0]):
            fail(f"{a}_handoff: results differ from the fused route's")
        c = counts[f"{a}_handoff"]
        if c[k3] != HANDOFF or c[k4] != 1 or ht.supersteps <= HANDOFF:
            fail(f"{a}_handoff: launches {c}, {ht.supersteps} supersteps: "
                 f"no hand-off from K3 to K4 after {HANDOFF}")
        log(json.dumps({"resident": a, "supersteps": t.supersteps,
                        "plain_rounds": int(ref[3]),
                        "fused_supersteps": fused[a][-1].supersteps,
                        "handoff_supersteps": ht.supersteps}))

    # (iii)-(vi): the tiered and phased routes against dense and compact
    slots = base.schedule(1).round_slots()
    for a in ("cc", "sssp"):
        dstate, dt = staged[f"{a}_dense"]
        names = [f"{a}_tiered", f"{a}_phased"] + (
            ["cc_tiered_spill"] if a == "cc" else [])
        for name in names:
            state, t = res[name]
            if not np.array_equal(state["x"], dstate["x"]):
                fail(f"{name}: results differ from dense")
            if name == "cc_tiered_spill":
                if not (t.spills > 0 and t.retried and t.escalations > 0):
                    fail(f"{name}: spills {t.spills}, retried {t.retried}, "
                         f"escalations {t.escalations}")
                continue
            if t.supersteps != dt.supersteps or not np.array_equal(
                    t.local_iters, dt.local_iters):
                fail(f"{name}: supersteps/local_iters differ from dense")
        state, t = res[f"{a}_tiered"]
        if t.spills or t.retried or not np.all(t.wire_hist == slots):
            fail(f"{a}_tiered: spills {t.spills}, wire_hist is not the "
                 f"schedule's {slots} slots a round")
        state, t = res[f"{a}_phased"]
        if not np.array_equal(t.count_hist,
                              staged[f"{a}_compact"][1].count_hist):
            fail(f"{a}_phased: count_hist differs from compact's")
        log(json.dumps({
            "phased": a, "phase_switch_steps": t.phase_switch_steps.tolist(),
            "phase_wire": t.phase_wire.tolist(),
            "dense_retry_steps": t.dense_retry_steps, "spills": t.spills,
            "wire_slots": t.wire_slots, "dense_wire_slots": dt.wire_slots,
            "tiered_wire_slots": res[f"{a}_tiered"][1].wire_slots}))
    t = res["cc_tiered_spill"][1]
    log(json.dumps({"tiered_spill": "cc", "spills": t.spills,
                    "escalations": t.escalations, "retried": t.retried,
                    "wire_slots": t.wire_slots}))
    state, t = res["pagerank_phased"]
    dstate, dt = staged["pagerank_dense"]
    if t.supersteps != dt.supersteps or not np.allclose(
            state["r"], dstate["r"], rtol=1e-5, atol=0.0):
        fail(f"pagerank_phased: max abs diff "
             f"{np.abs(state['r'] - dstate['r']).max()} from dense, "
             f"{t.supersteps} vs {dt.supersteps} supersteps")
    log(f"tier path checks: resident = fused = scipy for cc/sssp in one K4 "
        f"launch each; hand-off after {HANDOFF} K3 supersteps bit-equal; "
        f"tiered and phased = dense; forced spill repaired; phased "
        f"pagerank max abs diff {np.abs(state['r'] - dstate['r']).max():.3e}"
        f" — all agree")
    return plain, res, counts, taught


def breakdown(pg, upg, src):
    """Where one warm run's time goes, per run: the engine's set-up (graph
    block upload, then the mailbox compose on the fused route — with K3's
    out-adjacency, which its first launch would otherwise build, timed
    apart as ``out_adjacency_s`` — or the flat adjacency on the staged
    one), then the BSP loop, and inside it the
    kernels' time by CUDA events around every call of the superstep (K3),
    the pull (K1), the masked sweep (K2) and the pack (K5). Where the host
    is the bottleneck, as on the staged route, an event pair also holds the
    host's time to enqueue the call, so the kernel share is an upper
    bound (phase 5 gives each kernel's device time). The rest of the loop
    is the plain PyTorch ops around the kernels and the host reads of the
    halt vote (and, on the staged route, of each sweep's "frontier left"
    flag). The profiler is not used here: around a whole run on the H100
    it slowed the loop by an order of magnitude and lost launches."""
    import torch
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, init_max_vertex,
                                  make_bfs_init, make_sssp_init)
    from repro_torch.kernels import megastep as mega
    from repro_torch.kernels import ops

    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    cc = SemiringProgram("max_first", init_max_vertex)
    sssp = SemiringProgram("min_plus", make_sssp_init(*loc))
    k3, k1 = [(mega, "megastep_semiring")], [(ops, "semiring_spmv")]
    k2 = [(ops, "semiring_spmv_frontier")]
    cases = {
        "cc": (pg, cc, "auto", k3),
        "sssp": (pg, sssp, "auto", k3),
        "bfs": (upg, SemiringProgram("min_plus", make_bfs_init(*loc)),
                "auto", k3),
        "pagerank": (pg, PageRankProgram(n_global=pg.n_global,
                                         num_iters=30), "auto", k1),
        "cc_dense": (pg, cc, "dense", k2),
        "sssp_dense": (pg, sssp, "dense", k2),
        "cc_compact": (pg, cc, "compact", k2 + [(ops, "outbox_pack")]),
        "cc_vertex": (pg, SemiringProgram("max_first", init_max_vertex,
                                          max_local_iters=1), "dense", k1),
        "sssp_vertex": (pg, SemiringProgram("min_plus", make_sssp_init(*loc),
                                            max_local_iters=1), "dense", k1),
    }
    for name, (graph, prog, exchange, hooks) in cases.items():
        events = {attr: [] for _, attr in hooks}

        def timed(kernel, calls):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = kernel(*args, **kw)
                end.record()
                calls.append((start, end))
                return out
            return call

        eng = GopherEngine(graph, prog, max_supersteps=4096,
                           exchange=exchange)
        fused = eng.exchange == "megastep"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the engine keeps what these build, so the loop below reuses it
        blocks = eng._gb_for_run() if fused else (eng._gb_for_staged(),)
        torch.cuda.synchronize()
        t_adj = time.perf_counter()
        if fused and exchange == "auto" and hooks is k3:
            mega.out_adjacency(blocks[1])   # K3's, else built at its first
            torch.cuda.synchronize()        # launch
        t1 = time.perf_counter()
        saved = [(m, a, getattr(m, a)) for m, a in hooks]
        for m, a, kernel in saved:
            setattr(m, a, timed(kernel, events[a]))
        try:
            run = eng._run_megastep if fused else eng._run_batched
            _, steps, _ = run(None)
            torch.cuda.synchronize()
        finally:
            for m, a, kernel in saved:
                setattr(m, a, kernel)
        t2 = time.perf_counter()
        calls = {a: len(ev) for a, ev in events.items()}
        if fused and calls[hooks[0][1]] != steps:
            fail(f"breakdown {name}: {calls} timed kernel calls in {steps} "
                 f"supersteps: the timing hook missed the kernel")
        if not all(calls.values()):
            fail(f"breakdown {name}: no timed call of {calls}")
        kernel_ms = {a: sum(x.elapsed_time(y) for x, y in ev)
                     for a, ev in events.items()}
        total = sum(kernel_ms.values())
        log(json.dumps({
            "breakdown": name, "exchange": eng.exchange,
            "setup_s": t1 - t0, "out_adjacency_s": t1 - t_adj,
            "loop_s": t2 - t1, "supersteps": steps,
            "kernel_calls": calls, "kernel_ms": kernel_ms,
            "kernel_share_of_loop": total / 1e3 / (t2 - t1)}))


# ---------------- phase 4f: the GoFS store and incremental analytics -----

K3, K4, K2, K5 = ("megastep_semiring", "resident_megastep",
                  "semiring_spmv_frontier", "outbox_pack")


def grid_segments(g, rows: int, cols: int):
    """The road grid's segments (right and down neighbours), (m, 2), and
    whether each is in ``g``."""
    v = np.arange(rows * cols).reshape(rows, cols)
    grid = np.concatenate([
        np.stack([v[:, :-1].ravel(), v[:, 1:].ravel()], 1),
        np.stack([v[:-1, :].ravel(), v[1:, :].ravel()], 1)])
    present = np.asarray(g.csr()[grid[:, 1], grid[:, 0]]).ravel() > 0
    return grid, present


def reopened_edges(g, rows: int, cols: int, count: int, seed: int):
    """``count`` grid segments the build dropped, drawn with the arithmetic
    of the JAX package's benchmarks/bench_incremental.py
    (``_reopened_edges``): the reopened road segments of phase 4f."""
    rng = np.random.default_rng(seed)
    grid, present = grid_segments(g, rows, cols)
    absent = grid[~present]
    sel = rng.choice(absent.shape[0], size=min(count, absent.shape[0]),
                     replace=False)
    return absent[sel, 0], absent[sel, 1]


def fields_equal(a, b, what: str) -> None:
    """Fail unless two PartitionedGraphs agree field for field."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, dict):
            same = va.keys() == vb.keys() and all(
                np.array_equal(va[k], vb[k]) for k in va)
        elif isinstance(va, np.ndarray):
            same = va.dtype == vb.dtype and np.array_equal(va, vb)
        else:
            same = va == vb
        if not same:
            fail(f"{what}: field {f.name} differs")


def incremental_path(dev, g, ug, pg, upg, src, fused, launches_4f):
    """Phase 4f: the GoFS store and incremental analytics at RN scale, each
    step checked (see the module docstring). ``fused`` holds phase 4a's
    results, the fixpoints the resumes start from; its timed runs' launch
    counts go into ``launches_4f``."""
    import tempfile

    import torch
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph
    from repro_torch import algorithms
    from repro_torch.core import (PhasedTierPlan, device_block,
                                  host_graph_block, patch_host_block,
                                  verify_host_block)
    from repro_torch.gofs import EdgeDelta, TemporalStore, apply_delta

    side = int(round(np.sqrt(g.n)))          # the road grid is square
    with tempfile.TemporaryDirectory() as root:
        # (1) the store: write, load, every field, CC on the loaded graph
        st = TemporalStore(root)
        t0 = time.perf_counter()
        st.write("rn", pg)
        t1 = time.perf_counter()
        loaded = st.load_partitioned("rn")
        t2 = time.perf_counter()
        fields_equal(pg, loaded, "store round trip")
        on_disk = sum(f.stat().st_size for f in Path(root).rglob("*")
                      if f.is_file())
        res = drive(dev, {"cc_loaded": (
            lambda: algorithms.connected_components(loaded), [K3])},
            launches_4f, g.n)
        if not np.array_equal(res["cc_loaded"][0], fused["cc"][0]):
            fail("cc on the loaded graph: labels differ from phase 4a's")
        log(json.dumps({"store": {"write_s": t1 - t0, "load_s": t2 - t1,
                                  "bytes_on_disk": on_disk,
                                  "partitions": pg.num_parts}}))

        # (2) the delta: 1 % of the edges, reopened road segments
        n_ins = (g.nnz // 2) // 100
        iu, iv = reopened_edges(g, side, side, n_ins, seed=7)
        iw = np.random.default_rng(8).uniform(5.0, 10.0, iu.size) \
            .astype(np.float32)
        delta = EdgeDelta.inserts(iu, iv, iw)
        t0 = time.perf_counter()
        hb = host_graph_block(pg)
        t1 = time.perf_counter()
        r1 = apply_delta(pg, delta, directed=False, block=hb)
        t2 = time.perf_counter()
        replay = patch_host_block(hb, r1.pg, *r1.events)
        t3 = time.perf_counter()
        cold_hb = host_graph_block(r1.pg)
        t4 = time.perf_counter()
        problems = verify_host_block(r1.block)
        if problems:
            fail(f"verify_host_block on the patched block: {problems}")
        for k in set(replay) - {"wire_ewma", "announce_ewma"}:
            if not np.array_equal(replay[k], r1.block[k]):
                fail(f"the event replay's {k} differs from apply_delta's")
        if set(cold_hb) != set(r1.block):
            fail("the patched block's keys differ from a cold build's")
        ur1 = apply_delta(upg, EdgeDelta.inserts(iu, iv), directed=False,
                          block=host_graph_block(upg))
        if verify_host_block(ur1.block):
            fail(f"verify_host_block on the unweighted patched block: "
                 f"{verify_host_block(ur1.block)}")
        log(json.dumps({"delta": {
            "reopened_segments": int(iu.size), "stats": r1.stats,
            "mailbox_cap": [pg.mailbox_cap, r1.pg.mailbox_cap],
            "d_max": [pg.d_max, r1.pg.d_max],
            "touched_rows": int(len(r1.events[0])),
            "remote_added": len(r1.events[2]),
            "host_s": {"host_graph_block_v0": t1 - t0,
                       "apply_delta_with_block": t2 - t1,
                       "patch_host_block_replay": t3 - t2,
                       "host_graph_block_v1_cold": t4 - t3}}}))

        # (3) fused resumes against cold runs, scipy and each other
        pg1, upg1 = r1.pg, ur1.pg
        prev_cc, prev_d, prev_l = (fused["cc"][0], fused["sssp"][0],
                                   fused["bfs"][0])
        plan1 = PhasedTierPlan.from_graph(pg1)

        def resumed(algo, res, prev, **kw):
            def run():
                gb = device_block(res.block, dev)
                if algo == "cc":
                    return algorithms.incremental_connected_components(
                        res.pg, prev, res, gb=gb, **kw)
                return getattr(algorithms, f"incremental_{algo}")(
                    res.pg, src, prev, res, gb=gb, **kw)
            return run

        runs = {
            "cc_resumed": (resumed("cc", r1, prev_cc), [K3]),
            "cc_cold_v1": (lambda: algorithms.connected_components(pg1),
                           [K3]),
            "sssp_resumed": (resumed("sssp", r1, prev_d), [K3]),
            "sssp_cold_v1": (lambda: algorithms.sssp(pg1, src), [K3]),
            "bfs_resumed": (resumed("bfs", ur1, prev_l), [K3]),
            "bfs_cold_v1": (lambda: algorithms.bfs(upg1, src), [K3]),
            # (4) the staged routes, (5) the resident mode
            "sssp_resumed_dense": (resumed("sssp", r1, prev_d,
                                           exchange="dense"), [K2]),
            "sssp_resumed_compact": (resumed("sssp", r1, prev_d,
                                             exchange="compact"), [K2, K5]),
            "sssp_resumed_resident": (resumed(
                "sssp", r1, prev_d, exchange="megastep", tier_plan=plan1),
                [K4]),
        }
        counts = {}
        out = drive(dev, runs, launches_4f, g.n, record=counts)
        if not (np.array_equal(out["cc_resumed"][0], out["cc_cold_v1"][0])
                and out["cc_resumed"][1] == out["cc_cold_v1"][1]):
            fail("cc_resumed: labels differ from the cold run's")
        for a in ("sssp", "bfs"):
            if not np.array_equal(out[f"{a}_resumed"][0],
                                  out[f"{a}_cold_v1"][0]):
                fail(f"{a}_resumed: results differ from the cold run's")
        d1 = out["sssp_resumed"][0]
        for name in ("sssp_resumed_dense", "sssp_resumed_compact",
                     "sssp_resumed_resident"):
            if not np.array_equal(out[name][0], d1):
                fail(f"{name}: distances differ from the fused resume's")
        k4_launches = counts["sssp_resumed_resident"][K4]
        if k4_launches != 1:
            fail(f"sssp_resumed_resident: {k4_launches} K4 launches, not 1")
        # scipy on the new graph: the delta's segments added both ways
        both = (np.r_[iv, iu], np.r_[iu, iv])
        a1 = g.csr() + sp.csr_matrix((np.r_[iw, iw], both), shape=(g.n,
                                                                   g.n))
        ncc1, lab1 = csgraph.connected_components(a1, directed=False)
        labels, ncc = out["cc_resumed"][:2]
        pairs = np.unique(np.stack([lab1, gather(pg1, labels)]), axis=1)
        if ncc != ncc1 or pairs.shape[1] != ncc1:
            fail("cc_resumed: the components differ from scipy's")
        d_true = csgraph.dijkstra(a1.T, indices=[src])[0]
        fin = np.isfinite(d_true)
        got = gather(pg1, d1)
        if not np.array_equal(np.isfinite(got), fin) or not np.allclose(
                got[fin], d_true[fin], rtol=1e-5):
            fail("sssp_resumed: distances differ from scipy's dijkstra")
        ua1 = ug.undirected_csr() + sp.csr_matrix(
            (np.ones(2 * iu.size), both), shape=(g.n, g.n))
        hops = csgraph.shortest_path(ua1, unweighted=True, indices=[src])[0]
        if not np.array_equal(gather(upg1, out["bfs_resumed"][0]),
                              hops.astype(np.float32)):
            fail("bfs_resumed: hop counts differ from scipy's")
        iters = {a: [int(out[f"{a}_resumed"][-1].local_iters.sum()),
                     int(out[f"{a}_cold_v1"][-1].local_iters.sum())]
                 for a in ("cc", "sssp", "bfs")}
        if not iters["bfs"][0] < iters["bfs"][1]:
            fail(f"bfs_resumed: {iters['bfs'][0]} local iterations, the "
                 f"cold run {iters['bfs'][1]}: no fewer")
        rel = np.abs(got[fin] - d_true[fin]) / np.maximum(d_true[fin], 1e-30)
        log(json.dumps({"sssp_resumed_vs_scipy_max_rel": float(rel.max()),
                        "resumed_vs_cold_local_iters": iters,
                        "resumed_vs_cold_supersteps": {
                            a: [out[f"{a}_resumed"][-1].supersteps,
                                out[f"{a}_cold_v1"][-1].supersteps]
                            for a in ("cc", "sssp", "bfs")}}))

        # where a resume's set-up goes: the patched block's upload, then
        # the mailbox compose with K3's walk inputs (built on first launch)
        from repro_torch.kernels import megastep as mega
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gb1 = device_block(r1.block, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cm1 = mega.compose_mailbox(gb1)
        mega.out_adjacency(cm1)
        mega.k3_lanes(cm1, "min_plus")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(json.dumps({"resume_setup_s": {"device_block": t1 - t0,
                                           "compose_mailbox": t2 - t1}}))
        del gb1, cm1

        # (4, continued) a removal delta: 0.01 % of the segments present
        # after (2), none of them reopened there
        grid, present = grid_segments(g, side, side)
        live = grid[present]
        pick = np.random.default_rng(9).choice(
            live.shape[0], (g.nnz // 2) // 10000, replace=False)
        t0 = time.perf_counter()
        r2 = apply_delta(pg1, EdgeDelta.removes(live[pick, 0],
                                                live[pick, 1]),
                         directed=False, block=r1.block)
        t1 = time.perf_counter()
        if verify_host_block(r2.block):
            fail(f"verify_host_block after the removals: "
                 f"{verify_host_block(r2.block)}")
        if r2.stats["removed"] != 2 * pick.size:
            fail(f"removal delta: {r2.stats['removed']} arcs removed, "
                 f"{2 * pick.size} asked")
        log(json.dumps({"removal_delta": {
            "closed_segments": int(pick.size), "stats": r2.stats,
            "apply_delta_with_block_s": t1 - t0}}))
        pg2 = r2.pg
        runs = {
            "sssp_resumed_removal": (resumed("sssp", r2, d1), [K3]),
            "sssp_cold_v2": (lambda: algorithms.sssp(pg2, src), [K3]),
            "cc_resumed_removal": (resumed("cc", r2, labels), [K3]),
            "cc_cold_v2": (lambda: algorithms.connected_components(pg2),
                           [K3]),
        }
        out2 = drive(dev, runs, launches_4f, g.n)
        for a in ("sssp", "cc"):
            if not np.array_equal(out2[f"{a}_resumed_removal"][0],
                                  out2[f"{a}_cold_v2"][0]):
                fail(f"{a}_resumed_removal: results differ from the cold "
                     f"run's")

        # (6) the temporal store: version 1 replayed from the delta slice
        v = st.append_delta("rn", delta)
        t0 = time.perf_counter()
        mat = st.materialize("rn", version=1)
        t1 = time.perf_counter()
        if v != 1 or mat.version != 1:
            fail(f"temporal store: version {v}, materialized {mat.version}")
        fields_equal(apply_delta(pg, delta, directed=False).pg, mat,
                     "materialize(version=1)")
        log(json.dumps({"temporal_store": {"materialize_v1_s": t1 - t0}}))
    log("incremental path checks: store round trip, verify_host_block "
        "clean, fused/staged/resident resumes = cold runs = scipy, the "
        "removal delta = cold runs, materialize(1) = apply_delta — all agree")
    return delta


# ---------------- phase 4g: Gopher Serve, query batches at RN -------------

SERVE_SEED = 11                 # the sources of phase 4g's batches
BFS_Q, SSSP_Q, PPR_Q = 8, 4, 4  # 4g's batch widths (1), (3), (4)
LANDMARKS = 8                   # 4g (6)
SWEEP_QS = (4, 8, 16)           # the widths 4g times one batched sweep at
BREAKDOWN_STEPS = 2             # the supersteps of 4g's profiled batch
LANDMARK_RTOL = 1e-4            # float32 path sums of some 2,800 edges


def ppr_reference(g, sources, iters: int = 30) -> np.ndarray:
    """Personalized PageRank in float64 from each source: the one-hot
    teleport, unit-weight pulls, the dangling mass sent back through the
    teleport — BatchedPersonalizedPageRank's arithmetic. (Q, n)."""
    a = g.csr().copy()            # its data would alias g.weights
    a.data[:] = 1.0
    outdeg = g.out_degree.astype(np.float64)
    out = np.zeros((len(sources), g.n))
    for q, s in enumerate(sources):
        e = np.zeros(g.n)
        e[s] = 1.0
        r = e.copy()
        for _ in range(iters):
            contrib = np.where(outdeg > 0, r / np.maximum(outdeg, 1), 0)
            r = 0.15 * e + 0.85 * (a @ contrib + r[outdeg == 0].sum() * e)
        out[q] = r
    return out


def held_ppr(got, want, what: str) -> float:
    """PPR held to the float64 reference: allclose at rtol 1e-5, atol 0
    (the walk's unreached vertices are exact zeros on both sides); returns
    the max relative error."""
    if not np.allclose(got, want, rtol=1e-5, atol=0):
        fail(f"{what}: not within rtol 1e-5 of the float64 reference")
    nz = want != 0
    return float((np.abs(got[nz] - want[nz]) / want[nz]).max())


def scalar_lanes(fn, pg, sources, dev) -> np.ndarray:
    """(Q, n): the fused scalar run (K3) from each source, global order."""
    return np.stack([gather(pg, fn(pg, int(s), device=dev)[0])
                     for s in sources])


def counting_sweeps(fn, sweeps: dict, name: str):
    """``fn`` with its two-bin frontier sweeps counted: ``sweeps[name]`` is
    (sweeps, wall seconds) of its last call (the fused route reads
    ``megastep``'s name of the sweep, the staged route ``flat``'s)."""
    import torch
    from repro_torch.kernels import flat
    from repro_torch.kernels import megastep as mega

    def run():
        n = [0]
        inner = flat.binned_sweep_frontier

        def counted(*args):
            n[0] += 1
            return inner(*args)
        mega.binned_sweep_frontier = flat.binned_sweep_frontier = counted
        t = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
            return out
        finally:
            mega.binned_sweep_frontier = flat.binned_sweep_frontier = inner
            sweeps[name] = (n[0], time.perf_counter() - t)
    return run


def sweep_times(dev, upg, gb) -> dict:
    """ms of one batched two-bin sweep (``megastep.sweep_flat_batched``)
    over the RN graph at each width in SWEEP_QS, by CUDA events over 20
    sweeps after 3, with 5 % of the (row, lane) frontier set."""
    import torch
    from repro_torch.kernels import megastep as mega
    cm = mega.compose_mailbox(gb, adjacency="binned")
    out = {}
    for q in SWEEP_QS:
        gen = torch.Generator(device=dev).manual_seed(q)
        x = torch.rand((cm["n"], q), device=dev, generator=gen)
        f = torch.rand((cm["n"], q), device=dev, generator=gen) < 0.05
        out[q] = cuda_ms(lambda: mega.sweep_flat_batched(x, f, cm,
                                                         "min_plus"), reps=20)
    return out


def service_stream(g):
    """Phase 4g's sources (numpy, seed 11) and its 25-query stream over
    the graphs ``rn`` (weighted) and ``rn_unit``: returns (the generator,
    left where 4g goes on drawing, the stream, (bfs, sssp, ppr, more bfs)
    sources)."""
    rng = np.random.default_rng(SERVE_SEED)
    srcs = rng.choice(g.n, 32, replace=False)
    bfs_src, sssp_src = srcs[:BFS_Q], srcs[8:8 + SSSP_Q]
    ppr_src, more_src = srcs[12:12 + PPR_Q], srcs[16:22]
    stream = ([("bfs", "rn_unit", int(s)) for s in bfs_src]
              + [("bfs", "rn_unit", int(s)) for s in more_src]
              + [("reach", "rn_unit", (int(bfs_src[0]), int(bfs_src[1]))),
                 ("reach", "rn_unit", (int(bfs_src[2]), int(bfs_src[3])))]
              + [("sssp", "rn", int(s)) for s in sssp_src]
              + [("ppr", "rn", int(s)) for s in ppr_src]
              + [("sssp", "rn", g.n + 5)])
    return rng, stream, (bfs_src, sssp_src, ppr_src, more_src)


def serving_path(dev, g, ug, pg, upg, delta, launches_4g):
    """Phase 4g: Gopher Serve at RN scale, each run checked (see the module
    docstring). ``delta`` is phase 4f's 1 % reopened-segment delta; the
    timed runs' launch counts go into ``launches_4g``. Returns the service,
    whose metrics registry phase 4i reads, and what phase 4k holds its
    service on a mesh to: the stream, its responses, the drain's seconds
    and the refreshed landmark vectors."""
    import torch
    from repro_torch import algorithms
    from repro_torch.core import (GopherEngine, TierPlan, device_block,
                                  host_graph_block)
    from repro_torch.gofs import bfs_grow_partition, partition_graph, road_grid
    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import (BatchedPersonalizedPageRank,
                                     BatchedSemiringProgram,
                                     GraphQueryService, LandmarkCache,
                                     gather_query_results, ppr_query_seed,
                                     sssp_query_init)
    t_phase = t0 = time.perf_counter()
    rng, stream, (bfs_src, sssp_src, ppr_src, more_src) = service_stream(g)
    ugb = device_block(host_graph_block(upg), dev, binned=True)
    wgb = device_block(host_graph_block(pg), dev, binned=True)
    log(json.dumps({"serving_setup_s": time.perf_counter() - t0,
                    "sources": {"bfs": bfs_src.tolist(),
                                "sssp": sssp_src.tolist(),
                                "ppr": ppr_src.tolist()}}))

    def batch(pgx, gbx, q, init, exchange="auto", plan=None, ppr=False,
              max_s=4096):
        if ppr:
            prog = BatchedPersonalizedPageRank(pgx.n_global, q, num_iters=30)
            key = "qseed"
        else:
            prog = BatchedSemiringProgram("min_plus", q)
            key = "qinit"

        def run():
            eng = GopherEngine(pgx, prog, gb=gbx, exchange=exchange,
                               tier_plan=plan, device=dev,
                               max_supersteps=64 if ppr else max_s)
            return eng.run_queries(extra={key: init})
        return run

    # (1)-(4): the batches on the RN graphs; the first after a warm-up
    bfs_init = sssp_query_init(upg, bfs_src)
    sweeps = {}
    out = drive(dev, {"bfs_batch": (counting_sweeps(
        batch(upg, ugb, BFS_Q, bfs_init), sweeps, "bfs_batch"), [])},
        launches_4g, g.n)
    runs = {
        "bfs_batch_dense": (batch(upg, ugb, BFS_Q, bfs_init, "dense"), []),
        "bfs_batch_compact": (batch(upg, ugb, BFS_Q, bfs_init, "compact"),
                              ["outbox_pack"]),
        "sssp_batch": (batch(pg, wgb, SSSP_Q,
                             sssp_query_init(pg, sssp_src)), []),
        "ppr_batch": (batch(pg, wgb, PPR_Q, ppr_query_seed(pg, ppr_src),
                            ppr=True), []),
    }
    runs = {k: (counting_sweeps(fn, sweeps, k), kern)
            for k, (fn, kern) in runs.items()}
    out.update(drive(dev, runs, launches_4g, g.n, warm=False))
    for name, (_, t) in out.items():
        log(json.dumps({"serving_run": name, "queries": t.query_supersteps
                        .size, "query_supersteps": t.query_supersteps
                        .tolist(), "exchange": t.exchange,
                        "sweeps": sweeps[name][0],
                        "ms_per_sweep": sweeps[name][1] * 1e3
                        / sweeps[name][0] if sweeps[name][0] else None}))
    # where a batch's time goes: the BFS batch's first BREAKDOWN_STEPS
    # supersteps, timed, then again under the profiler
    head = counting_sweeps(batch(upg, ugb, BFS_Q, bfs_init,
                                 max_s=BREAKDOWN_STEPS), sweeps, "head")
    head()
    bd = device_breakdown(head, sweeps["head"][1] * 1e3,
                          [("outbox_pack", "pack_kernel")])
    log(json.dumps({"serving_breakdown": {
        "run": f"bfs_batch, supersteps 0-{BREAKDOWN_STEPS - 1}",
        "sweeps": sweeps["head"][0], **bd}}))
    bfs = gather_query_results(upg, out["bfs_batch"][0]["x"])
    t = out["bfs_batch"][1]
    want = scalar_lanes(algorithms.bfs, upg, bfs_src, dev)
    if not np.array_equal(bfs, want):
        fail("bfs_batch: lanes differ from the scalar bfs() runs")
    if not (t.query_supersteps <= t.supersteps).all():
        fail("bfs_batch: a query converged after the batch")
    for ex in ("dense", "compact"):
        st, te = out[f"bfs_batch_{ex}"]
        if not np.array_equal(st["x"], out["bfs_batch"][0]["x"]):
            fail(f"bfs_batch_{ex}: lanes differ from the megastep batch")
        if (te.supersteps != t.supersteps
                or not np.array_equal(te.local_iters, t.local_iters)
                or not np.array_equal(te.query_supersteps,
                                      t.query_supersteps)):
            fail(f"bfs_batch_{ex}: supersteps or local_iters differ")
    sssp = gather_query_results(pg, out["sssp_batch"][0]["x"])
    if not np.array_equal(sssp, scalar_lanes(algorithms.sssp, pg, sssp_src,
                                             dev)):
        fail("sssp_batch: lanes differ from the scalar sssp() runs")
    ppr_want = ppr_reference(g, ppr_src)
    ppr = gather_query_results(pg, out["ppr_batch"][0]["r"])
    ppr_err = held_ppr(ppr, ppr_want, "ppr_batch")

    # (2): tiered with a too-narrow plan (it reruns dense) and phased, on a
    # 300 x 300 grid, held to dense there
    sg = road_grid(300, 300, drop_frac=0.03, seed=1)
    spg = partition_graph(sg, bfs_grow_partition(sg, 12, seed=0), 12)
    shb = host_graph_block(spg)
    sgb = device_block(shb, dev, binned=True)
    occ = shb["wire_ewma"]
    narrow = TierPlan.build(np.zeros_like(occ), occ, spg.mailbox_cap)
    s_init = sssp_query_init(spg, rng.choice(sg.n, BFS_Q, replace=False))
    small = {
        "small_bfs_batch_dense": (batch(spg, sgb, BFS_Q, s_init, "dense"),
                                  []),
        "small_bfs_batch_tiered": (batch(spg, sgb, BFS_Q, s_init, "tiered",
                                         narrow), ["outbox_pack"]),
        "small_bfs_batch_phased": (batch(spg, sgb, BFS_Q, s_init, "phased"),
                                   ["outbox_pack"]),
    }
    sout = drive(dev, small, launches_4g, sg.n, warm=False)
    ref = sout["small_bfs_batch_dense"]
    for name in ("small_bfs_batch_tiered", "small_bfs_batch_phased"):
        st, te = sout[name]
        if (not np.array_equal(st["x"], ref[0]["x"])
                or te.supersteps != ref[1].supersteps
                or not np.array_equal(te.query_supersteps,
                                      ref[1].query_supersteps)):
            fail(f"{name}: differs from the dense batch")
    if not sout["small_bfs_batch_tiered"][1].retried:
        fail("small_bfs_batch_tiered: the too-narrow plan did not rerun")

    # one batched sweep's device time at each width
    sweep_ms = sweep_times(dev, upg, ugb)

    # (5): the service over both graphs, one mixed stream
    svc = GraphQueryService({"rn": pg, "rn_unit": upg},
                            metrics=MetricsRegistry(), device=dev)
    for kind, gname, s in stream:
        svc.submit(kind, gname, s)
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    resp = svc.drain()
    drain_s = time.perf_counter() - t0
    repeats = [svc.query("bfs", "rn_unit", int(bfs_src[0])),
               svc.query("sssp", "rn", int(sssp_src[1]))]
    for k, c in _build.launches.items():
        launches_4g[k] += c
    more = scalar_lanes(algorithms.bfs, upg, more_src, dev)
    lane = {("bfs", int(s)): bfs[i] for i, s in enumerate(bfs_src)}
    lane.update({("bfs", int(s)): more[i] for i, s in enumerate(more_src)})
    lane.update({("sssp", int(s)): sssp[i] for i, s in enumerate(sssp_src)})
    for i, (kind, gname, s) in enumerate(stream):
        r = resp[i]
        if kind == "sssp" and s == g.n + 5:
            if r.error is None or "out of range" not in r.error:
                fail(f"service: source {s} was not rejected")
            continue
        if r.error is not None or r.cached:
            fail(f"service: {kind} {s}: error {r.error}, cached {r.cached}")
        if kind == "ppr":
            held_ppr(r.result, ppr_want[list(ppr_src).index(s)],
                     f"service ppr {s}")
        elif kind == "reach":
            if not np.array_equal(r.result, np.minimum(lane["bfs", s[0]],
                                                       lane["bfs", s[1]])):
                fail(f"service: reach {s} differs from its seeds' BFS")
        elif not np.array_equal(r.result, lane[kind, s]):
            fail(f"service: {kind} {s} differs from the batch's lane")
    if not all(r.cached and r.error is None for r in repeats):
        fail("service: a repeated query was not a cache hit")
    if not (np.array_equal(repeats[0].result, lane["bfs", int(bfs_src[0])])
            and np.array_equal(repeats[1].result,
                               lane["sssp", int(sssp_src[1])])):
        fail("service: a cache hit differs from its first answer")
    summary = svc.stats.summary()
    if (summary["batches"], summary["rejected"], summary["cache_hits"]) != (
            3, 1, 2):
        fail(f"service: {summary}")
    log(json.dumps({"service": {
        "queries": len(stream), "drain_s": drain_s, "summary": summary,
        "batch_latency_ms": {
            f"{q.graph}/{q.family}": max(
                r.latency_s for r in resp.values()
                if r.error is None and r.query.graph == q.graph
                and r.query.family == q.family) * 1e3
            for q in {r.query for r in resp.values() if r.error is None}},
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}}))

    # (6): landmarks, then phase 4f's delta applied through the service
    t0 = time.perf_counter()
    lc = svc.enable_landmarks("rn", LANDMARKS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the bounds hold in exact arithmetic; in float32 a path's sum rounds
    # otherwise when it is added up from the landmark than from the source
    deficit = 0.0
    for i, s in enumerate(sssp_src):
        d, up = sssp[i], lc.approx_sssp(int(s))
        fin = np.isfinite(d)
        if not np.array_equal(np.isfinite(up), fin):
            fail(f"approx_sssp({s}) is finite where the distance is not")
        rel = (d[fin] - up[fin]) / np.maximum(d[fin], 1e-30)
        deficit = max(deficit, float(rel.max()))
    if deficit > LANDMARK_RTOL:
        fail(f"approx_sssp is {deficit:.3e} below the exact distance")
    for i, lm in enumerate(lc.landmarks):
        if not np.allclose(lc.approx_sssp(int(lm)), lc.dist[i],
                           rtol=LANDMARK_RTOL, atol=0):
            fail(f"approx_sssp from landmark {lm} is not its distance")
    t0 = time.perf_counter()
    svc.apply_delta("rn", delta, rebuild_landmarks=True)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    lc1 = svc.landmark_caches["rn"]
    t0 = time.perf_counter()
    cold = LandmarkCache.build(svc.graphs["rn"], landmarks=lc.landmarks,
                               device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    if not np.array_equal(lc1.dist, cold.dist):
        fail("the refreshed landmarks differ from a cold build on version 1")
    if svc.graphs["rn"].version != 1 or lc1.graph_version != 1:
        fail("apply_delta: the graph or the landmarks are not on version 1")
    log(json.dumps({"landmarks": {
        "num": LANDMARKS, "build_s": build_s, "apply_delta_s": apply_s,
        "delta_apply_s": list(svc.stats.delta_apply_s),
        "cold_build_v1_s": cold_s, "telemetry": svc.landmark_telemetry("rn"),
        "approx_below_exact_max_rel": deficit},
        "sweep_ms": sweep_ms, "ppr_max_rel_err": ppr_err,
        "phase_4g_s": time.perf_counter() - t_phase}))
    log("serving path checks: bfs/sssp batches = scalar runs, dense = "
        "compact = megastep, tiered (rerun) = phased = dense, ppr = float64 "
        "reference, the service's answers, hits and rejection, landmark "
        "bounds and the refresh = a cold build — all agree")
    return svc, {"stream": stream, "resp": resp, "drain_s": drain_s,
                 "landmarks": lc1.landmarks, "landmark_dist": lc1.dist}


# ---------------- phase 4h: checkpointing and resilience ----------------

CK_CRASH_AT, CK_SSSP_EVERY = 20, 8   # 4h (2): the crash's visit, snapshots
PR_CRASH_AT, PR_EVERY = 12, 5        # 4h (4)
STALL_S = 0.1                        # 4h (5): a straggler's stall a superstep


def _disk_bytes(directory: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(directory) for f in files)


def checkpoint_path(dev, pg, src, fused, staged, launches_4h):
    """Phase 4h: checkpointed runs, crash recovery, a snapshot fallback, a
    targeted straggler and the chaos scenarios at RN scale, each checked
    (see the module docstring). ``fused`` and ``staged`` hold phases 4a's
    and 4b's results; every run's launch counts go into ``launches_4h``."""
    import os
    import tempfile
    import torch
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, init_max_vertex,
                                  make_sssp_init)
    from repro_torch.kernels import _build
    from repro_torch.launch import chaos
    from repro_torch.resilience import faults, run_with_recovery
    from repro_torch.resilience.balance import BalancePolicy, plan_migration
    from repro_torch.training.checkpoint import Checkpointer
    t_phase = time.perf_counter()
    k1, k2, k5 = "semiring_spmv", "semiring_spmv_frontier", "outbox_pack"
    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    cc = SemiringProgram("max_first", init_max_vertex)
    sssp = SemiringProgram("min_plus", make_sssp_init(*loc))
    pr = PageRankProgram(n_global=pg.n_global, num_iters=30)

    def timed(name, fn, kernels, **extra):
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(_build.launches)
        for k in kernels:
            if launches[k] == 0:
                fail(f"{name}: kernel {k} was never launched")
        for k, c in launches.items():
            launches_4h[k] += c
        tele = out[1]
        log(json.dumps({"algorithm": name, "n": pg.n_global, "parts": 12,
                        "exchange": tele.exchange,
                        "supersteps": tele.supersteps,
                        "local_iters_sum": int(tele.local_iters.sum()),
                        "warm_s": secs, "launches": launches, **extra}))
        return out, secs

    def same_run(t, want, what):
        for f in ("supersteps", "local_iters", "messages_sent",
                  "changed_hist", "count_hist"):
            if not np.array_equal(np.asarray(getattr(t, f)),
                                  np.asarray(getattr(want, f))):
                fail(f"{what}: {f} differs from phase 4b's compact run")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_4h_") as tmp:
        # (1) checkpointed CC against 4a's labels and 4b's compact run, and
        # an uncheckpointed compact CC timed beside it
        (_, t_plain), plain_s = timed(
            "cc_compact_uncheckpointed",
            lambda: GopherEngine(pg, cc, exchange="compact").run(), [k2, k5])
        d = os.path.join(tmp, "cc")
        (state, t), ck_s = timed(
            "cc_checkpointed", lambda: GopherEngine(
                pg, cc, exchange="compact").run(
                checkpointer=Checkpointer(d), checkpoint_every=2), [k2, k5])
        if not np.array_equal(_as_result(pg, "cc", state["x"]),
                              fused["cc"][0]):
            fail("cc_checkpointed: labels differ from the fused route's")
        same_run(t, staged["cc_compact"][1], "cc_checkpointed")
        same_run(t_plain, staged["cc_compact"][1], "cc_compact_uncheckpointed")
        ck = Checkpointer(d)
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d))
        like = {"state": {"x": 0, "changed_v": 0, "frontier": 0},
                "inbox": 0}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap, _ = ck.restore(like, step=steps[-1], device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not np.array_equal(snap["state"]["x"].cpu().numpy(), state["x"]):
            fail("cc_checkpointed: the last snapshot is not the run's state")
        sync = Checkpointer(os.path.join(tmp, "sync"))
        t0 = time.perf_counter()
        sync.save(snap, 0)
        sync_s = time.perf_counter() - t0
        asyn = Checkpointer(os.path.join(tmp, "async"), async_save=True)
        t0 = time.perf_counter()
        asyn.save(snap, 0)
        async_return_s = time.perf_counter() - t0
        asyn.wait()
        async_s = time.perf_counter() - t0
        if not (sync.verify_step(0) and asyn.verify_step(0)):
            fail("the timed saves do not verify")
        log(json.dumps({"checkpoint": {
            "snapshots": steps, "bytes_on_disk": _disk_bytes(d),
            "snapshot_bytes": _disk_bytes(os.path.join(tmp, "sync")),
            "warm_s": ck_s, "uncheckpointed_warm_s": plain_s,
            "save_sync_s": sync_s, "save_sync_split_s": sync.last_save_s,
            "save_async_return_s": async_return_s,
            "save_async_total_s": async_s,
            "save_async_split_s": asyn.last_save_s,
            "restore_s": restore_s}}))
        del snap

        # (2) a crash at superstep 20 of a checkpointed SSSP, recovered
        d = os.path.join(tmp, "sssp")
        plan = faults.FaultPlan([faults.FaultSpec(
            "engine.superstep", "crash", at=CK_CRASH_AT)])
        eng = GopherEngine(pg, sssp, exchange="compact")
        with faults.inject(plan):
            (state, t, rep), _ = timed(
                "sssp_crash_recovered", lambda: run_with_recovery(
                    eng, Checkpointer(d), every=CK_SSSP_EVERY), [k2, k5])
        want_step = CK_CRASH_AT // CK_SSSP_EVERY * CK_SSSP_EVERY
        if (rep.restarts, rep.attempts, rep.resumed_steps) != \
                (1, 2, [want_step]) or rep.faults != [dict(
                    site="engine.superstep", kind="crash",
                    visit=CK_CRASH_AT)]:
            fail(f"sssp_crash_recovered: report {rep.as_dict()}")
        dist = _as_result(pg, "sssp", state["x"])
        if not np.array_equal(dist, fused["sssp"][0]) or \
                t.supersteps != fused["sssp"][-1].supersteps or \
                rep.final_step != t.supersteps:
            fail("sssp_crash_recovered: differs from the fused route's run")
        if t.changed_hist[:want_step].any():
            fail("sssp_crash_recovered: hist slots before the resume")

        # (3) the latest snapshot bit-flipped: fall back one, resume
        ck = Checkpointer(d)
        latest = ck.latest_step()
        with open(os.path.join(d, f"step_{latest}", "host_0.npz"),
                  "r+b") as f:
            f.seek(200)
            f.write(b"\xde\xad\xbe\xef")
        good = ck.latest_good_step()
        snaps = sorted(int(x.split("_")[1]) for x in os.listdir(d))
        if ck.verify_step(latest) or good != snaps[-2]:
            fail(f"fallback: verify/latest_good_step gave {good} of {snaps}")
        (state, t), _ = timed(
            "sssp_fallback_resumed", lambda: GopherEngine(
                pg, sssp, exchange="compact").run(
                checkpointer=ck, checkpoint_every=CK_SSSP_EVERY,
                resume=True), [k2, k5],
            latest_step=latest, fallback_step=good)
        if not np.array_equal(_as_result(pg, "sssp", state["x"]),
                              fused["sssp"][0]):
            fail("sssp_fallback_resumed: differs from the fused route's run")

        # (4) 30-iteration PageRank, crashed at superstep 12, recovered
        plan = faults.FaultPlan([faults.FaultSpec(
            "engine.superstep", "crash", at=PR_CRASH_AT)])
        eng = GopherEngine(pg, pr, exchange="compact")
        with faults.inject(plan):
            (state, t, rep), _ = timed(
                "pagerank_crash_recovered", lambda: run_with_recovery(
                    eng, Checkpointer(os.path.join(tmp, "pr")),
                    every=PR_EVERY), [k1, k5])
        want = staged["pagerank_dense"][0]["r"]
        r = _masked(pg, state["r"], 0.0)
        if rep.restarts != 1 or t.supersteps != 30 or not np.allclose(
                r, _masked(pg, want, 0.0), rtol=1e-5, atol=0):
            fail(f"pagerank_crash_recovered: max abs diff "
                 f"{np.abs(r - _masked(pg, want, 0.0)).max()} from 4b's "
                 f"dense PageRank (restarts {rep.restarts})")

        # (5) a straggler on partition 0: its stalls land in part_seconds
        verts0 = int(np.asarray(pg.vmask)[0].sum())
        plan = faults.FaultPlan([faults.FaultSpec(
            "engine.superstep", "straggler", prob=1.0, times=9999,
            delay_s=STALL_S / verts0, payload={"part": 0})])
        with faults.inject(plan):
            (state, t), _ = timed(
                "cc_straggler", lambda: GopherEngine(
                    pg, cc, exchange="compact").run(
                    checkpointer=Checkpointer(os.path.join(tmp, "slow")),
                    checkpoint_every=2), [k2, k5])
        fired = plan.record()
        stalls = sum(x["stall_s"] for x in fired)
        gap = t.part_seconds[0] - np.delete(t.part_seconds, 0)
        if len(fired) != t.supersteps or not np.allclose(
                gap, stalls, rtol=0, atol=1e-6 * len(fired)):
            fail(f"cc_straggler: part_seconds[0] - others {gap} against "
                 f"the recorded stalls {stalls}")
        if not np.array_equal(_as_result(pg, "cc", state["x"]),
                              fused["cc"][0]):
            fail("cc_straggler: labels differ from the fused route's")
        log(json.dumps({"straggler": {
            "stall_s": stalls, "part_seconds": t.part_seconds.tolist(),
            "skew": t.skew()}}))

    # plan_migration at RN, partition by partition: the destination it
    # picks (the lightest partition with a free slot), that destination's
    # free slots beside the source's smallest sub-graph, and the plan
    budget = BalancePolicy().max_verts_per_step
    vm = np.asarray(pg.vmask, bool)
    live = vm.sum(1)
    free = pg.v_max - live
    parts = []
    for p in range(pg.num_parts):
        sizes = np.unique(pg.sg_id[p][vm[p]], return_counts=True)[1]
        dsts = [int(q) for q in np.argsort(live, kind="stable")
                if q != p and free[q] > 0]
        plan = plan_migration(pg, src=p, budget=budget)
        parts.append({
            "part": p, "live": int(live[p]), "free_slots": int(free[p]),
            "num_subgraphs": int(pg.num_subgraphs[p]),
            "smallest_subgraph": int(sizes.min()),
            "dst": dsts[0] if dsts else None,
            "dst_free_slots": int(free[dsts[0]]) if dsts else 0,
            "plan": None if plan is None else dataclasses.asdict(plan)})
    log(json.dumps({"rn_migration": {"budget": budget, "v_max": pg.v_max,
                                     "parts": parts}}))

    # (6) the chaos scenarios on their own small graphs, on the card
    out = str(Path(__file__).resolve().parent / "chiprun_out"
              / "chaos_torch.json")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = chaos.main(["--quick", "--device", "cuda", "--out", out])
    chaos_s = time.perf_counter() - t0
    for k, c in _build.launches.items():
        launches_4h[k] += c
    with open(out) as f:
        report = json.load(f)
    if rc != 0:
        fail(f"chaos: rc {rc}, {report['summary']}, failed: " + str({
            k: v.get("error", v) for k, v in report["scenarios"].items()
            if not v["ok"]}))
    heal = report["scenarios"]["skew_heal"]["algos"]["cc"]
    if not heal["migrations"] or heal["imbalance_drop"] < 2.0:
        fail(f"chaos: skew_heal {heal}")
    log(json.dumps({"chaos": {
        "seconds": chaos_s, "summary": report["summary"],
        "scenario_s": {k: v["seconds"]
                       for k, v in report["scenarios"].items()},
        "skew_heal": {k: heal[k] for k in ("migrations", "imbalance_before",
                                          "imbalance_after",
                                          "imbalance_drop")}},
        "phase_4h_s": time.perf_counter() - t_phase}))
    log("checkpoint path checks: checkpointed CC = 4a = 4b compact, the "
        "crashed SSSP recovered from its snapshot and after a bit-flipped "
        "one = 4a, recovered PageRank = 4b dense, the straggler's stalls "
        "in part_seconds exactly, the chaos scenarios — all agree")


# ---------------- phase 4i: observability ----------------

def span_ms(tracer) -> dict:
    """The total ms of each span name of a traced run."""
    out = {}
    for s in tracer.spans:
        out[s.name] = out.get(s.name, 0.0) + s.dur_ns / 1e6
    return out


def same_telemetry(t, want, what: str) -> None:
    """Every Telemetry field of ``t`` equal to ``want``'s but
    ``part_seconds`` (a traced run's host clock)."""
    import dataclasses
    for f in dataclasses.fields(want):
        if f.name == "part_seconds":
            continue
        a, b = getattr(t, f.name), getattr(want, f.name)
        if (a is None) != (b is None) or (a is not None and not np.array_equal(
                np.asarray(a), np.asarray(b))):
            fail(f"{what}: {f.name} differs from the untraced run's")


def observability_path(dev, pg, src, fused, staged, svc, launches_4i):
    """Phase 4i: the tracer, the traced stepped driver and the metrics
    registry at RN scale, each run checked (see the module docstring).
    ``fused`` and ``staged`` hold phases 4a's and 4b's results, ``svc`` is
    phase 4g's service; every run's launch counts go into
    ``launches_4i``."""
    import os
    import tempfile
    import torch
    from repro_torch.core import (GopherEngine, SemiringProgram,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.kernels import _build
    from repro_torch.obs import (MetricsRegistry, Tracer,
                                 validate_chrome_trace, validate_metrics)
    t_phase = time.perf_counter()
    k2, k3, k5 = "semiring_spmv_frontier", "megastep_semiring", "outbox_pack"
    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    progs = {"cc": SemiringProgram("max_first", init_max_vertex),
             "sssp": SemiringProgram("min_plus", make_sssp_init(*loc))}
    reg = MetricsRegistry()

    def timed(eng):
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(_build.launches)
        for k, c in launches.items():
            launches_4i[k] += c
        return out, secs, launches

    # (1) and (4): fused CC and SSSP untraced with the registry, then
    # traced with boundary_sync, against 4a; (2) compact CC against 4b
    lines = {}
    for name, algo, exchange, want, kernels in (
            ("cc_fused", "cc", "auto", fused["cc"], [k3]),
            ("sssp_fused", "sssp", "auto", fused["sssp"], [k3]),
            ("cc_compact", "cc", "compact", staged["cc_compact"], [k2, k5])):
        (_, t_plain), plain_s, _ = timed(GopherEngine(
            pg, progs[algo], exchange=exchange, metrics=reg, device=dev))
        tr = Tracer(boundary_sync=True)
        (state, t), secs, launches = timed(GopherEngine(
            pg, progs[algo], exchange=exchange, tracer=tr, device=dev))
        x = _as_result(pg, algo, state["x"])
        ref = want[0] if exchange == "auto" else _as_result(pg, algo,
                                                           want[0]["x"])
        if not np.array_equal(x, ref):
            fail(f"{name}: traced results differ from the untraced run's")
        same_telemetry(t, want[-1], name)
        same_telemetry(t, t_plain, name)
        for k in kernels:
            if launches[k] == 0:
                fail(f"{name}: kernel {k} was never launched")
        if exchange == "auto" and (launches[k3] != t.supersteps
                                   or launches["resident_megastep"]):
            fail(f"{name}: K3 launched {launches[k3]} times in "
                 f"{t.supersteps} supersteps")
        names = [s.name for s in tr.spans]
        if names.count("superstep") != t.supersteps or not tr.balanced:
            fail(f"{name}: {names.count('superstep')} superstep spans in "
                 f"{t.supersteps} supersteps")
        validate_chrome_trace(tr.chrome_trace())
        lines[name] = {"supersteps": t.supersteps, "warm_s": secs,
                       "untraced_warm_s": plain_s, "counts": tr.counts,
                       "launches": {k: c for k, c in launches.items() if c},
                       "span_ms": span_ms(tr)}
    log(json.dumps({"scope": lines}))

    # (3): the fused CC under profiler_dir: K3's kernel once a superstep
    # (the profiler has lost a window's first launches on this card, so
    # the run is traced up to three times)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_4i_") as tmp:
        tr = Tracer(profiler_dir=os.path.join(tmp, "profile"))
        seen = []
        for _ in range(3):
            (state, t), prof_s, _ = timed(GopherEngine(
                pg, progs["cc"], tracer=tr, device=dev))
            with open(tr.profiles[-1]) as f:
                events = json.load(f)["traceEvents"]
            k3_events = [e for e in events if e.get("cat") == "kernel"
                         and "megastep_kernel" in e.get("name", "")]
            seen.append(len(k3_events))
            if seen[-1] == t.supersteps:
                break
        if seen[-1] != t.supersteps:
            fail(f"profiler_dir: megastep_kernel {seen} times in traces of "
                 f"{t.supersteps} supersteps")
        if not np.array_equal(_as_result(pg, "cc", state["x"]),
                              fused["cc"][0]):
            fail("cc_profiled: labels differ from phase 4a's")
        k3_ms = sum(e["dur"] for e in k3_events) / 1e3
        trace_bytes = os.path.getsize(tr.profiles[-1])

        # (5): the scope CLI on the card
        out = os.path.join(tmp, "scope")
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.scope", "--device",
             "cuda", "--boundary-sync", "--out", out],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(
                Path(__file__).resolve().parent / "src")})
        cli_s = time.perf_counter() - t0
        if cli.returncode != 0:
            fail(f"scope CLI: rc {cli.returncode}: {cli.stderr[-2000:]}")
        with open(os.path.join(out, "scope_trace.json")) as f:
            validate_chrome_trace(json.load(f))
        with open(os.path.join(out, "scope_metrics.json")) as f:
            validate_metrics(json.load(f))
        with open(os.path.join(out, "scope_trace.jsonl")) as f:
            cli_spans = sum(1 for _ in f)

    # (4): the registries of the untraced engines and of 4g's service
    snap = reg.snapshot()
    validate_metrics(snap)
    steps = (fused["cc"][-1].supersteps + fused["sssp"][-1].supersteps)
    got = snap["counters"].get(
        "engine_supersteps_total{backend=local,exchange=megastep}")
    if got != steps:
        fail(f"metrics: engine_supersteps_total {got}, the runs' {steps}")
    ssnap = svc.metrics.snapshot()
    validate_metrics(ssnap)
    c = ssnap["counters"]
    served = (c.get("serving_requests_total{result=hit}", 0)
              + c.get("serving_requests_total{result=served}", 0))
    batches = sum(v for k, v in c.items()
                  if k.startswith("serving_batches_total"))
    if served != svc.stats.served or batches != svc.stats.batches:
        fail(f"metrics: serving_requests_total {served}, batches {batches}; "
             f"the service's {svc.stats.served}, {svc.stats.batches}")
    log(json.dumps({"observability": {
        "profiled_cc": {"megastep_kernel_events": seen, "k3_ms": k3_ms,
                        "warm_s": prof_s, "trace_bytes": trace_bytes},
        "scope_cli": {"seconds": cli_s, "spans": cli_spans},
        "engine_counters": {k: v for k, v in snap["counters"].items()
                            if k.startswith("engine_supersteps")},
        "serving_counters": {k: v for k, v in c.items()
                             if k.startswith("serving_requests")},
        "phase_4i_s": time.perf_counter() - t_phase}}))
    log("observability checks: traced fused CC/SSSP = 4a with K3 once a "
        "superstep, traced compact CC = 4b with K2 and K5, the profiler's "
        "K3 events, the engine and service registries, the scope CLI — all "
        "agree")


# ---------------- phase 4j: the multi-device backend, one NCCL rank --------

def mesh_path(dev, pg, src, earlier, counts_4c, taught, launches_4j):
    """Phase 4j: ``backend='shard_map'`` on a world of one NCCL rank, each
    run checked (see the module docstring). ``earlier`` holds phase 4b's
    and 4c's results by run name, ``counts_4c`` 4c's launch counts by run
    name, ``taught`` 4c's phased plan; the mesh runs' launch counts go
    into ``launches_4j``. The process group is this phase's own: made
    here (a ``file://`` rendezvous in a temporary directory) and
    destroyed at its end; a failed NCCL init or collective fails the
    phase. Returns each case's first mesh run, (state, Telemetry), by
    name."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, TierPlan, init_max_vertex,
                                  make_sssp_init)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.checkpoint import Checkpointer
    t_phase = time.perf_counter()
    k1, k2, k5 = "semiring_spmv", "semiring_spmv_frontier", "outbox_pack"
    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    progs = {"cc": SemiringProgram("max_first", init_max_vertex),
             "sssp": SemiringProgram("min_plus", make_sssp_init(*loc)),
             "pagerank": PageRankProgram(n_global=pg.n_global, num_iters=30)}
    base = TierPlan.from_graph(pg)
    # (name, program, exchange on the mesh, on 'local', its plan, the
    # earlier run it is held to, the kernels it must launch)
    cases = []
    for a in ("cc", "sssp"):
        cases += [(f"{a}_dense", a, "dense", "dense", None, f"{a}_dense",
                   [k2]),
                  (f"{a}_compact", a, "compact", "compact", None,
                   f"{a}_compact", [k2, k5]),
                  (f"{a}_tiered", a, "tiered", "tiered", base, f"{a}_tiered",
                   [k2, k5]),
                  (f"{a}_phased", a, "phased", "phased", taught,
                   f"{a}_phased", [k2, k5]),
                  (f"{a}_auto", a, "auto", "dense", None, f"{a}_dense",
                   [k2])]
    cases += [("pagerank_dense", "pagerank", "dense", "dense", None,
               "pagerank_dense", [k1]),
              ("cc_checkpointed", "cc", "compact", "compact", None,
               "cc_compact", [k2, k5])]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_4j_") as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh((1,), ("parts",), device="cuda")
            probe = torch.ones(1, device=dev)
            dist.all_reduce(probe)      # NCCL's communicator, built once
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            if float(probe) != 1.0:
                fail(f"mesh: a one-rank all_reduce gave {float(probe)}")
            lines, first = {}, {}
            for name, algo, ex, lex, plan, ref, kernels in cases:
                runs = {"local": [], "shard_map": []}
                # in turns (local, mesh, mesh, local): the host's drift
                # falls on both alike
                for i, backend in enumerate(("local", "shard_map",
                                             "shard_map", "local")):
                    eng = GopherEngine(
                        pg, progs[algo], backend=backend,
                        mesh=mesh if backend == "shard_map" else None,
                        exchange=ex if backend == "shard_map" else lex,
                        tier_plan=plan, device=dev,
                        **({"max_supersteps": 64} if algo == "pagerank"
                           else {}))
                    kw = ({"checkpointer": Checkpointer(os.path.join(
                        tmp, f"{name}_{i}")), "checkpoint_every": 2}
                        if name == "cc_checkpointed" else {})
                    torch.cuda.synchronize()
                    _build.reset_launches()
                    t = time.perf_counter()
                    state, tele = eng.run(**kw)
                    torch.cuda.synchronize()
                    runs[backend].append((state, tele,
                                          time.perf_counter() - t,
                                          dict(_build.launches)))
                # the checks hold each backend's first run; the launches
                # of the first mesh run count as the phase's
                (sl, tl, _, ll), (sm, tm, _, lm) = (
                    runs["local"][0], runs["shard_map"][0])
                first[name] = (sm, tm)
                for k, c in lm.items():
                    launches_4j[k] += c
                for k in kernels:
                    if lm[k] == 0:
                        fail(f"mesh {name}: kernel {k} was never launched")
                if any(r[3] != ll for r in runs["local"] + runs["shard_map"]):
                    fail(f"mesh {name}: launches {lm}, 'local' {ll}")
                want = earlier[ref][0]
                key = "r" if algo == "pagerank" else "x"
                if algo == "pagerank":
                    diff = float(np.abs(sm[key] - want[key]).max())
                    if not np.allclose(sm[key], want[key], rtol=1e-5,
                                       atol=0.0) or not np.allclose(
                            sm[key], sl[key], rtol=1e-5, atol=0.0):
                        fail(f"mesh {name}: max abs diff {diff} from 4b")
                elif not (np.array_equal(sm[key], want[key])
                          and np.array_equal(sm[key], sl[key])):
                    fail(f"mesh {name}: results differ from 'local' and "
                         f"from phase 4b/4c's {ref}")
                wt = earlier[ref][1]
                for f in ("supersteps", "local_iters", "wire_slots",
                          "wire_hist"):
                    a, b, c = (getattr(x, f) for x in (tm, tl, wt))
                    if not (np.array_equal(a, b) and (
                            name == "cc_checkpointed"
                            or np.array_equal(a, c))):
                        fail(f"mesh {name}: {f} differs from 'local' or "
                             f"from phase 4b/4c's {ref}")
                if ref in counts_4c and name != "cc_checkpointed" and any(
                        lm[k] != counts_4c[ref][k] for k in (k1, k2, k5)):
                    fail(f"mesh {name}: launches {lm}, 4c's {ref} "
                         f"{counts_4c[ref]}")
                if name.endswith("_auto") and tm.exchange != "dense":
                    fail(f"mesh {name}: 'auto' resolved to {tm.exchange}")
                lines[name] = {
                    "exchange": tm.exchange, "supersteps": tm.supersteps,
                    "local_iters_sum": int(tm.local_iters.sum()),
                    "wire_slots": tm.wire_slots,
                    "warm_s": [r[2] for r in runs["shard_map"]],
                    "local_warm_s": [r[2] for r in runs["local"]],
                    "launches": {k: c for k, c in lm.items() if c}}
                log(json.dumps({"mesh": name, "devices": 1,
                                "backend": "shard_map/nccl", **lines[name]}))
        finally:
            dist.destroy_process_group()
    log(json.dumps({"mesh_phase": {"nccl_init_s": init_s,
                                   "phase_4j_s": time.perf_counter()
                                   - t_phase}}))
    log("mesh path checks: one NCCL rank = 'local' = 4b/4c on dense, "
        "compact, tiered, phased and auto (dense) CC/SSSP, 30-iteration "
        "PageRank and a checkpointed compact CC, with equal supersteps, "
        "local_iters, wire and launches — all agree")
    return first


# ---------------- phase 4k: the service and device loss on a mesh --------

def _percentiles(resp) -> dict:
    """p50/p99 latency (ms) of one drain's answered responses, and how
    many there were."""
    lat = [r.latency_s for r in resp.values() if r.error is None]
    return {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "answered": len(lat)}


def failover_path(dev, pg, upg, src, delta, served, mesh_runs, taught,
                  launches_4k):
    """Phase 4k: the multi-device backend's service and device-loss half
    on a world of one NCCL rank, each step checked (see the module
    docstring). ``served`` holds phase 4g's stream, answers, drain time
    and refreshed landmarks, ``mesh_runs`` phase 4j's first mesh runs by
    name, ``taught`` 4c's phased plan; every run's launch counts go into
    ``launches_4k``. The process group is this phase's own; a failed NCCL
    init, subgroup or collective fails the phase."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, init_max_vertex,
                                  make_sssp_init)
    from repro_torch.kernels import _build
    from repro_torch.launch.elastic import MeshPlan
    from repro_torch.launch.mesh import mesh_ranks
    from repro_torch.obs import MetricsRegistry
    from repro_torch.resilience import faults, run_with_failover
    from repro_torch.serving import GraphQueryService
    from repro_torch.training.checkpoint import Checkpointer
    t_phase = time.perf_counter()
    k1, k2, k5 = "semiring_spmv", "semiring_spmv_frontier", "outbox_pack"
    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    cc = SemiringProgram("max_first", init_max_vertex)

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before it and
        added to ``launches_4k`` just after; returns (its output, its
        seconds, its launches)."""
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(_build.launches)
        for k, c in launches.items():
            launches_4k[k] += c
        return out, secs, launches

    with tempfile.TemporaryDirectory(prefix="chip_smoke_4k_") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            rank=0, world_size=1, device_id=dev)
        try:
            # (1) the plan's mesh over an NCCL subgroup; compact CC on it
            mesh = MeshPlan((1,), ("parts",)).make(device="cuda")
            group = mesh.get_group()
            if (group is dist.group.WORLD or mesh_ranks(mesh) != [0]
                    or dist.get_backend(group) != "nccl"):
                fail(f"4k: MeshPlan.make gave {mesh} over "
                     f"{dist.get_backend(group)}")
            (st, te), cc_s, lc = counted(lambda: GopherEngine(
                pg, cc, backend="shard_map", mesh=mesh, exchange="compact",
                device=dev).run())
            want = mesh_runs["cc_compact"]
            if not np.array_equal(st["x"], want[0]["x"]) or (
                    te.supersteps != want[1].supersteps):
                fail("4k: compact CC on the plan's mesh differs from 4j's")
            if lc[k2] == 0 or lc[k5] == 0:
                fail(f"4k: compact CC launched {lc}")
            log(json.dumps({"failover_mesh_cc": {
                "warm_s": cc_s, "supersteps": te.supersteps,
                "launches": {k: c for k, c in lc.items() if c}}}))

            # (2) 4g's stream through the service on the mesh
            svc = GraphQueryService({"rn": pg, "rn_unit": upg},
                                    backend="shard_map", mesh=mesh,
                                    metrics=MetricsRegistry(), device=dev)
            for kind, gname, s in served["stream"]:
                svc.submit(kind, gname, s)
            resp, drain_s, ls = counted(svc.drain)
            worst_ppr = 0.0
            if set(resp) != set(served["resp"]):
                fail("4k service: other tickets than 4g's")
            for t, w in served["resp"].items():
                r = resp[t]
                if (r.error, r.cached, r.supersteps) != (
                        w.error, w.cached, w.supersteps):
                    fail(f"4k service {t}: error {r.error}, cached "
                         f"{r.cached}, supersteps {r.supersteps}; 4g's "
                         f"{w.error}, {w.cached}, {w.supersteps}")
                if w.error is not None:
                    continue
                if w.query.kind == "ppr":
                    worst_ppr = max(worst_ppr, held_ppr(
                        r.result, w.result, f"4k service ppr {t}"))
                elif not np.array_equal(r.result, w.result):
                    fail(f"4k service: {w.query.kind} {t} differs from "
                         f"4g's answer")
            engines = sorted({e.exchange for e in svc._engines.values()})
            if engines != ["dense"]:
                fail(f"4k service: pooled engines on {engines}")
            mine, theirs = (_percentiles(resp),
                            _percentiles(served["resp"]))
            log(json.dumps({"service_mesh": {
                "queries": len(served["stream"]), "drain_s": drain_s,
                **mine, "qps": mine["answered"] / drain_s,
                "exchanges": engines, "ppr_max_rel_err": worst_ppr,
                "launches": {k: c for k, c in ls.items() if c},
                "local_4g": {"drain_s": served["drain_s"], **theirs,
                             "qps": theirs["answered"]
                             / served["drain_s"]}}}))

            # landmarks, then 4f's delta with the refresh
            lm = served["landmarks"]
            _, build_s, lb = counted(lambda: svc.enable_landmarks(
                "rn", len(lm)))
            if not np.array_equal(svc.landmark_caches["rn"].landmarks, lm):
                fail("4k: the mesh service chose other landmarks than 4g")
            _, apply_s, la = counted(lambda: svc.apply_delta(
                "rn", delta, rebuild_landmarks=True))
            got, want = (svc.landmark_caches["rn"].dist,
                         served["landmark_dist"])
            fin = np.isfinite(want)
            if not np.array_equal(np.isfinite(got), fin) or not np.allclose(
                    got[fin], want[fin], rtol=LANDMARK_RTOL, atol=0):
                fail("4k: the refreshed landmarks differ from 4g's beyond "
                     f"{LANDMARK_RTOL}")
            log(json.dumps({"service_mesh_landmarks": {
                "build_s": build_s, "apply_delta_s": apply_s,
                "bit_equal_to_4g": bool(np.array_equal(got, want)),
                "telemetry": svc.landmark_telemetry("rn"),
                "launches": {k: lb[k] + la[k] for k in lb
                             if lb[k] + la[k]}}}))

            # (3) a crash at superstep 2, recovered on the mesh
            progs = {"cc_phased": (cc, "phased", taught, [k2, k5]),
                     "sssp_phased": (SemiringProgram(
                         "min_plus", make_sssp_init(*loc)), "phased",
                         taught, [k2, k5]),
                     "pagerank_dense": (PageRankProgram(
                         n_global=pg.n_global, num_iters=30), "dense",
                         None, [k1])}
            for name, (prog, ex, plan, kernels) in progs.items():
                eng = GopherEngine(
                    pg, prog, backend="shard_map", mesh=mesh, exchange=ex,
                    tier_plan=plan, device=dev,
                    **({"max_supersteps": 64} if ex == "dense" else {}))
                crash = faults.FaultPlan([faults.FaultSpec(
                    "engine.superstep", "crash", at=2)])

                def recover(eng=eng, crash=crash, name=name):
                    with faults.inject(crash):
                        return run_with_failover(eng, Checkpointer(
                            os.path.join(tmp, name)), every=2)
                (eng2, state, tele, rep), secs, lf = counted(recover)
                ws, wt = mesh_runs[name]
                key = "r" if name == "pagerank_dense" else "x"
                if eng2 is not eng or rep.restarts != 1 or (
                        rep.resumed_steps != [2]):
                    fail(f"4k failover {name}: {rep}")
                if key == "r":
                    if not np.allclose(state[key], ws[key], rtol=1e-5,
                                       atol=0.0):
                        fail(f"4k failover {name}: max abs diff "
                             f"{np.abs(state[key] - ws[key]).max()} "
                             f"from 4j's")
                elif not np.array_equal(state[key], ws[key]):
                    fail(f"4k failover {name}: differs from 4j's")
                if tele.supersteps != wt.supersteps:
                    fail(f"4k failover {name}: {tele.supersteps} "
                         f"supersteps, 4j's {wt.supersteps}")
                for k in kernels:
                    if lf[k] == 0:
                        fail(f"4k failover {name}: kernel {k} was never "
                             f"launched")
                log(json.dumps({"failover": name, "devices": 1,
                                "backend": "shard_map/nccl",
                                "supersteps": tele.supersteps,
                                "restarts": rep.restarts,
                                "resumed_steps": rep.resumed_steps,
                                "warm_s": secs,
                                "launches": {k: c for k, c in lf.items()
                                             if c}}))

            # (4) device loss of the one rank raises
            loss = faults.FaultPlan([faults.FaultSpec(
                "engine.superstep", "device_loss", at=1,
                payload={"lost": [0]})])
            try:
                with faults.inject(loss):
                    run_with_failover(GopherEngine(
                        pg, cc, backend="shard_map", mesh=mesh,
                        exchange="compact", device=dev), Checkpointer(
                            os.path.join(tmp, "lost")), every=2)
            except ValueError as e:
                if "every device" not in str(e):
                    raise
            else:
                fail("4k: losing the only device did not raise")
        finally:
            dist.destroy_process_group()
    log(json.dumps({"failover_phase": {"phase_4k_s": time.perf_counter()
                                       - t_phase}}))
    log("failover path checks: the plan's NCCL sub-mesh, compact CC = 4j, "
        "the service on it = 4g's answers (PPR rtol 1e-5), landmarks "
        "refreshed after 4f's delta within 1e-4 of 4g's, crash failovers "
        "of phased CC/SSSP and dense PageRank = 4j, device loss of the one "
        "rank refused — all agree")


# ---------------- phase 4m: Gopher Sentinel ----------------

def _compressed(per_step: list) -> list:
    """A run's collectives per superstep as [[count of supersteps, {kind:
    n}], ...], runs of equal supersteps merged."""
    out = []
    for step in per_step:
        if out and out[-1][1] == step:
            out[-1][0] += 1
        else:
            out.append([1, step])
    return out


def sentinel_path(dev, pg, src, fused, earlier, taught, launches_4m):
    """Phase 4m: Gopher Sentinel on the card, each run checked (see the
    module docstring). ``fused`` holds phase 4a's results (None: only the
    plain runs here are the reference), ``earlier`` 4b's and 4c's runs by
    name (or None), ``taught`` 4c's phased plan; the validated runs'
    launch counts go into ``launches_4m``. The NCCL process group is this
    phase's own, made and destroyed here."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import (check_semiring, errors, lint_kernels,
                                      REGISTRY)
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, Telemetry,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    t_phase = time.perf_counter()
    found = [v for v in lint_kernels() if v.severity != "info"]
    for name in REGISTRY:
        found += check_semiring(name)
    if found:
        fail("sentinel: passes 2-3 found " + "; ".join(map(str, found)))
    log(json.dumps({"sentinel_passes": {"semirings": sorted(REGISTRY),
                                        "lint_findings": 0}}))
    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    progs = {"cc": SemiringProgram("max_first", init_max_vertex),
             "sssp": SemiringProgram("min_plus", make_sssp_init(*loc)),
             "pagerank": PageRankProgram(n_global=pg.n_global, num_iters=30)}
    k1, k2, k3, k5 = ("semiring_spmv", "semiring_spmv_frontier",
                      "megastep_semiring", "outbox_pack")

    def turns(name, algo, make, kernels, want=None, mesh=False):
        """plain, validated, validated, plain runs of ``make(validate)``;
        the checks and launches hold each kind's first run."""
        runs = {False: [], True: []}
        for check in (False, True, True, False):
            eng = make(check)
            torch.cuda.synchronize()
            _build.reset_launches()
            t = time.perf_counter()
            state, tele = eng.run()
            torch.cuda.synchronize()
            runs[check].append((state, tele, time.perf_counter() - t,
                                dict(_build.launches), eng.sentinel))
        (s0, t0, _, l0, _), (s1, t1, _, l1, rec) = runs[False][0], \
            runs[True][0]
        summary, vs = rec
        for k, c in l1.items():
            launches_4m[k] += c
        key = "r" if algo == "pagerank" else "x"
        if not np.array_equal(s0[key], s1[key]):
            fail(f"sentinel {name}: the validated run's state differs")
        if want is not None and not np.array_equal(s1[key], want):
            fail(f"sentinel {name}: differs from the earlier phase's run")
        for f in Telemetry.__dataclass_fields__:
            a, b = getattr(t0, f), getattr(t1, f)
            if not ((a is None and b is None) or np.array_equal(
                    np.asarray(a), np.asarray(b))):
                fail(f"sentinel {name}: Telemetry.{f} differs")
        if any(r[3] != l0 for r in runs[False] + runs[True]):
            fail(f"sentinel {name}: launches {l1}, unvalidated {l0}")
        for k in kernels:
            if l1[k] == 0:
                fail(f"sentinel {name}: kernel {k} was never launched")
        if errors(vs) or (not mesh and summary.ops):
            fail(f"sentinel {name}: {[str(v) for v in vs]}, "
                 f"{len(summary.ops)} collectives recorded")
        if any(r[4] is None for r in runs[True]):
            fail(f"sentinel {name}: a validated run was not recorded")
        log(json.dumps({
            "sentinel": name, "exchange": t1.exchange,
            "backend": "shard_map/nccl" if mesh else "local",
            "supersteps": t1.supersteps,
            "collectives": len(summary.ops),
            "fingerprint_gathers": summary.fingerprints,
            "init": summary.init_counts,
            "per_superstep": _compressed(summary.per_superstep()),
            "end": summary.end_counts,
            "warm_s": [r[2] for r in runs[True]],
            "unvalidated_warm_s": [r[2] for r in runs[False]],
            "launches": {k: c for k, c in l1.items() if c},
            "violations": [v.code for v in vs]}))
        return s1

    for algo in ("cc", "sssp"):
        s1 = turns(f"{algo}_fused", algo, lambda check, a=algo: GopherEngine(
            pg, progs[a], validate=check, device=dev), [k3])
        if fused is not None and not np.array_equal(
                _as_result(pg, algo, s1["x"]), fused[algo][0]):
            fail(f"sentinel {algo}_fused: differs from phase 4a's")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_4m_") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh((1,), ("parts",), device="cuda")
            for name, algo, ex, plan, kernels in (
                    ("cc_compact", "cc", "compact", None, [k2, k5]),
                    ("cc_phased", "cc", "phased", taught, [k2, k5]),
                    ("pagerank_dense", "pagerank", "dense", None, [k1])):
                kw = {"max_supersteps": 64} if algo == "pagerank" else {}
                want = (None if earlier is None or algo == "pagerank"
                        else earlier[name][0]["x"])
                turns(f"{name}_mesh", algo, lambda check, a=algo, e=ex,
                      p=plan, k=kw: GopherEngine(
                          pg, progs[a], backend="shard_map", mesh=mesh,
                          exchange=e, tier_plan=p, validate=check,
                          device=dev, **k), kernels, want=want, mesh=True)
        finally:
            dist.destroy_process_group()

    t = time.perf_counter()
    out = os.path.join(tempfile.gettempdir(), "sentinel_report_4m.json")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sentinel", "--matrix",
         "quick", "--devices", "1", "--device", "cuda", "--out", out],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(Path(__file__).resolve().parent / "src"),
                        os.environ.get("PYTHONPATH")) if p)})
    if res.returncode != 0:
        fail(f"sentinel CLI exited {res.returncode}: "
             f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    with open(out) as f:
        rep = json.load(f)
    os.remove(out)
    if rep["summary"]["errors"]:
        fail(f"sentinel CLI: {rep['summary']}")
    log(json.dumps({"sentinel_cli": {
        "seconds": time.perf_counter() - t, **rep["summary"],
        "configs_by_backend": {b: sum(c["backend"] == b
                                      for c in rep["configs"])
                               for b in ("local", "shard_map")}}}))
    log(json.dumps({"sentinel_phase": {"phase_4m_s": time.perf_counter()
                                       - t_phase}}))
    log("sentinel checks: passes 2-3 clean; validated fused CC/SSSP record "
        "no collective and equal the plain runs and 4a; validated one-rank "
        "compact CC, phased CC and PageRank equal the plain runs with equal "
        "Telemetry and launches; the quick matrix on the card is clean — "
        "all agree")


# ---------------- phases 4d and 4e: LM serving at full width --------------

LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
# (config, the kernel in each of its prefill layers: its launch count's key,
# its key in the JSON lines, a piece of its name for the profiler): phase
# 4d the dense family, phase 4e the ssm family
LM_PATHS = [("llama3-8b", "flash_attention", "k7", "flash_kernel"),
            ("falcon-mamba-7b", "mamba1_scan", "k8", "scan_kernel")]


def op_event_ms(run, op: str) -> tuple:
    """(calls, ms): CUDA events around every call that ``run`` makes
    through ``ops.<op>`` (K7's ``flash_attention``, K8's ``mamba1_scan``)."""
    import torch
    from repro_torch.kernels import ops
    calls, orig = [], getattr(ops, op)

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kw)
        end.record()
        calls.append((start, end))
        return out
    setattr(ops, op, timed)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        setattr(ops, op, orig)
    return len(calls), sum(s.elapsed_time(e) for s, e in calls)


def device_breakdown(run, wall_ms: float, kernels: list) -> dict:
    """Device time of one ``run`` by torch.profiler, by kind of kernel:
    the hand-written ones (``kernels``: pairs of a key and a piece of the
    kernel's name, as in ``LM_PATHS``), matrix products (cuBLAS)
    and the rest, with the count of launches and the card's idle share
    against ``wall_ms``, the same run's time measured without the profiler
    (one stream: kernels do not overlap). The profiler slows the host, so
    its own wall time is reported but not used."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    profiled = (time.perf_counter() - t) * 1e3
    kinds = {**{key: 0.0 for key, _ in kernels}, "gemm": 0.0, "other": 0.0}
    names = {key: [] for key, _ in kernels}
    top = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or not evt.device_time_total:
            continue
        ms = evt.device_time_total / 1e3
        name = evt.key.lower()
        kind = next((key for key, piece in kernels if piece in name), None)
        if kind:
            names[kind].append(evt.key)
        kind = kind or ("gemm" if any(s in name for s in (
            "gemm", "nvjet", "xmma", "cutlass", "cublas")) else "other")
        kinds[kind] += ms
        top.append((ms, evt.count, evt.key[:60]))
    busy = sum(kinds.values())
    top.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_ms": busy, "by_kind_ms": kinds,
            "kernel_launches": sum(c for _, c, _ in top),
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "profiled_wall_ms": profiled,
            "kernel_names": {k: sorted(n[:60] for n in v)
                             for k, v in names.items()},
            "top": [{"ms": m, "count": c, "kernel": n} for m, c, n in top[:6]]}


def lm_path(dev, path_launches: dict, arch: str, op: str, key: str,
            piece: str, mesh_launches: dict) -> None:
    """Phases 4d and 4e (module docstring): ``arch`` served at full width
    and depth through ``make_prefill_step``/``make_decode_step``, its
    kernel ``op`` once a prefill layer and never in decode, then the
    decode logits held to a teacher-forced forward, then phase 4l's mesh
    run of the same weights (its launches into ``mesh_launches``), then a
    2-layer float32 cut held to the same model on the CPU. The model is
    freed before the cut."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)
    cfg = get_config(arch)
    B, S, G = LM_BATCH, LM_PROMPT, LM_GEN
    max_seq = S + G
    t = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = M.param_count(model)
    prompts = torch.randint(0, cfg.vocab, (B, S), device=dev,
                            dtype=torch.int32,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    prefill = make_prefill_step(cfg, max_seq=max_seq)
    decode = make_decode_step(cfg)

    tok, cache = prefill(model, {"inputs": prompts})    # warm-up, not counted
    for _ in range(2):
        tok, cache = decode(model, tok, cache)
    torch.cuda.synchronize()
    del cache
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t = time.perf_counter()
    tok, cache = prefill(model, {"inputs": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    pre = dict(_build.launches)
    _build.reset_launches()
    toks = [tok]
    t = time.perf_counter()
    for _ in range(G):
        tok, cache = decode(model, tok, cache)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / G
    dec = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    if pre[op] != cfg.n_layers:                           # (i)
        fail(f"{arch} prefill: {op} launched {pre[op]} times, not once a "
             f"layer ({cfg.n_layers})")
    if dec[op] != 0:
        fail(f"{arch} decode: {op} launched {dec[op]} times")
    for k, c in pre.items():
        path_launches[k] += c
    if cache["len"] != max_seq:
        fail(f"{arch} decode: cache len {cache['len']}, expected {max_seq}")
    del cache

    # the decode steps' logits against a teacher-forced forward over the
    # prompt and the generated tokens, at the same positions
    gen = torch.stack(toks, dim=1)                         # (B, G + 1)
    logits, cache, _ = M.prefill(model, prompts, cfg, max_seq=max_seq)
    del logits
    dec_logits = []
    for j in range(G):
        lg, cache = M.decode_step(model, gen[:, j], cache, cfg)
        dec_logits.append(lg.float())
    del cache
    dec_logits = torch.stack(dec_logits, dim=1)            # (B, G, V)
    full, _ = M.forward(model, torch.cat([prompts, gen[:, :G]], dim=1), cfg)
    tf = full[:, S:].float()
    del full
    rel = float(torch.linalg.vector_norm(dec_logits - tf)
                / torch.linalg.vector_norm(tf))
    agree = float((tf.argmax(-1) == gen[:, 1:]).float().mean())
    if not (rel <= 5e-2) or not bool(torch.isfinite(dec_logits).all()):
        fail(f"{arch} decode: logits' relative L2 error {rel} against the "
             f"teacher-forced forward (limit 5e-2)")
    del dec_logits, tf

    calls, op_ms = op_event_ms(
        lambda: prefill(model, {"inputs": prompts}), op)
    bd_prefill = device_breakdown(lambda: prefill(model, {"inputs": prompts}),
                                  prefill_ms, [(key, piece)])
    _, c1 = prefill(model, {"inputs": prompts})
    bd_decode = device_breakdown(lambda: decode(model, gen[:, 0], c1),
                                 decode_ms, [(key, piece)])
    del c1
    log(json.dumps({
        "lm": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
        "dtype": cfg.dtype, "batch": B, "prompt": S, "decode_steps": G,
        "init_s": init_s, "prefill_ms": prefill_ms,
        "decode_ms_per_token": decode_ms,
        "decode_tokens_per_s": B * 1e3 / decode_ms,
        "prefill_tokens_per_s": B * S * 1e3 / prefill_ms,
        "max_memory_allocated": peak,
        "k7_launches_prefill": pre["flash_attention"],
        "k7_launches_decode": dec["flash_attention"],
        "k8_launches_prefill": pre["mamba1_scan"],
        "k8_launches_decode": dec["mamba1_scan"],
        f"{key}_event_ms_in_prefill": op_ms, f"{key}_event_calls": calls,
        "decode_vs_teacher_forced_rel_l2": rel,
        "teacher_forced_token_agreement": agree,
        "first_sequence": gen[0].tolist()}))
    log(json.dumps({"lm_breakdown": "prefill", "lm": cfg.name,
                    **bd_prefill}))
    log(json.dumps({"lm_breakdown": "decode step", "lm": cfg.name,
                    **bd_decode}))
    lm_mesh_path(dev, model, cfg, prompts, gen, op,
                 {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms},
                 mesh_launches)
    del model
    torch.cuda.empty_cache()
    lm_cut_against_cpu(dev, cfg, op)


def _cache_tensors(cache: dict) -> dict:
    """A serving cache's tensors by name: the ssm family's conv and ssm
    state, the dense family's keys and values of each segment."""
    out = {k: v for k, v in cache.items() if hasattr(v, "shape")}
    for i, seg in enumerate(cache.get("segs", [])):
        out.update({f"segs[{i}].{k}": v for k, v in seg.items()})
    return out


def lm_cut_against_cpu(dev, cfg, op: str) -> None:
    """``cfg`` at full width cut to 2 layers, in float32, with the same
    weights on the card (kernel ``op`` in each prefill layer) and on the
    CPU (the plain versions): prefill logits and cache, then 8 greedy
    decode steps, held at rtol = atol = 1e-3 with the tokens equal."""
    import copy
    import dataclasses

    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    card = M.init_params(cut, seed=2, device=dev)
    host = copy.deepcopy(card).to("cpu")
    prompt = torch.randint(0, cut.vocab, (1, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    _build.reset_launches()
    gl, gc, _ = M.prefill(card, prompt.to(dev), cut, max_seq=72)
    torch.cuda.synchronize()
    if _build.launches[op] != 2:
        fail(f"{cfg.name} cut: {op} launched {_build.launches[op]} times in "
             f"a 2-layer prefill")
    hl, hc, _ = M.prefill(host, prompt, cut, max_seq=72)
    errs = [held(gl.cpu(), hl, 1e-3, f"{cfg.name} cut prefill logits")]
    host_cache = _cache_tensors(hc)
    errs += [held(t.cpu(), host_cache[k], 1e-3, f"{cfg.name} cut cache {k}")
             for k, t in _cache_tensors(gc).items()]
    gt, ht = gl[:, -1].argmax(-1), hl[:, -1].argmax(-1)
    steps = []
    for j in range(8):
        if int(gt) != int(ht):
            fail(f"{cfg.name} cut: greedy token {j} differs: card {int(gt)}, "
                 f"CPU {int(ht)}")
        steps.append(int(ht))
        gl, gc = M.decode_step(card, gt.to(torch.int32), gc, cut)
        hl, hc = M.decode_step(host, ht.to(torch.int32), hc, cut)
        errs.append(held(gl.cpu(), hl, 1e-3,
                         f"{cfg.name} cut decode step {j}"))
        gt, ht = gl.argmax(-1), hl.argmax(-1)
    if _build.launches[op] != 2:
        fail(f"{cfg.name} cut: a decode step launched {op}")
    log(json.dumps({"lm_cut": f"{cfg.name} at full width, depth cut to 2 "
                    "layers, float32, card against CPU", "batch": 1,
                    "prompt": 64, "decode_steps": 8, "tokens": steps,
                    "max_abs_err": max(errs), "tolerance": 1e-3}))
    del card, host
    torch.cuda.empty_cache()

# ---------------- phase 4l: the LM on a mesh, one NCCL rank ---------------

LM_MESH_GEN = 8                 # phase 4l's decode steps (4d's first 8)

def lm_mesh_path(dev, model, cfg, prompts, gen, op: str, unsharded: dict,
                 launches_4l: dict) -> None:
    """Phase 4l for one architecture (module docstring): 4d's or 4e's
    weights cut in place to a (1, 1) ('data', 'model') mesh of one NCCL
    rank (a block that is the whole tensor shares its storage: nothing is
    copied), served through the serve steps with ``mesh=`` on the same
    prompts for ``LM_MESH_GEN`` decode steps; the tokens must equal the
    unsharded run's ``gen`` (its first steps), ``op`` launched once a
    prefill layer and never in decode. The process group is this phase's
    own, destroyed at its end."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.training.shardspec import shard_module
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)
    B, S = prompts.shape
    G = LM_MESH_GEN
    with tempfile.TemporaryDirectory(prefix="chip_smoke_4l_") as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            before = torch.cuda.memory_allocated(dev)
            shard_module(model, mesh)
            grew = torch.cuda.memory_allocated(dev) - before
            init_s = time.perf_counter() - t0
            prefill = make_prefill_step(cfg, max_seq=S + gen.shape[1] - 1,
                                        mesh=mesh)
            decode = make_decode_step(cfg, mesh=mesh)
            tok, cache = prefill(model, {"inputs": prompts})    # warm-up
            for _ in range(2):
                tok, cache = decode(model, tok, cache)
            torch.cuda.synchronize()
            del cache
            _build.reset_launches()
            sh.reset_collectives()
            t = time.perf_counter()
            tok, cache = prefill(model, {"inputs": prompts})
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t) * 1e3
            pre, coll_pre = dict(_build.launches), sh.collectives()
            _build.reset_launches()
            sh.reset_collectives()
            toks = [tok]
            t = time.perf_counter()
            for _ in range(G):
                tok, cache = decode(model, tok, cache)
                toks.append(tok)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t) * 1e3 / G
            dec, coll_dec = dict(_build.launches), sh.collectives()
            del cache
        finally:
            dist.destroy_process_group()
    for k in pre:
        launches_4l[k] += pre[k] + dec[k]
    if pre[op] != cfg.n_layers or dec[op] != 0:
        fail(f"{cfg.name} on the mesh: {op} launched {pre[op]} times in "
             f"the prefill and {dec[op]} in decode, expected "
             f"{cfg.n_layers} and 0")
    got, want = torch.stack(toks, dim=1), gen[:, :G + 1]
    if not torch.equal(got, want):
        fail(f"{cfg.name} on the mesh: tokens differ from the unsharded "
             f"run's at {int((got != want).sum())} of {want.numel()}")
    if grew != 0:
        fail(f"{cfg.name} on the mesh: cutting to a one-rank mesh "
             f"allocated {grew} bytes")
    log(json.dumps({
        "lm_mesh": cfg.name, "mesh": [1, 1], "axes": ["data", "model"],
        "backend": "nccl", "batch": B, "prompt": S, "decode_steps": G,
        "init_s": init_s, "prefill_ms": prefill_ms,
        "decode_ms_per_token": decode_ms,
        "unsharded_prefill_ms": unsharded["prefill_ms"],
        "unsharded_decode_ms_per_token": unsharded["decode_ms_per_token"],
        "collectives_prefill": coll_pre,
        "collectives_per_decode_step": {k: v / G
                                        for k, v in coll_dec.items()},
        f"{op}_launches_prefill": pre[op], f"{op}_launches_decode": dec[op],
        "tokens_equal_unsharded": True}))


# the per-rank shapes of an 8-way TP mesh, which no earlier phase
# launches: llama3-8b's 32 heads and 8 kv heads over 8 ranks, and
# falcon-mamba-7b's d_inner 8192 over 8 ranks
TP8_K7 = ("llama3-8b prefill, TP 8", 4, 2048, 2048, 4, 1, 128, None, 0,
          "bfloat16")
TP8_K8 = dict(B=4, L=2048, D=1024, N=16)


def check_tp8_shapes(dev) -> None:
    """Phase 4l's kernel checks: K7 (bf16, causal; the instantiation its
    wrapper picks for bf16 at dh 128, ``flash_kernel_sm90<128>``, as phase
    3 checks it by name) against its plain version at rtol = atol = 1e-2,
    and K8 in the ssm path's call form (bf16 in, a nonzero h0, float32 y
    and final state) bit-equal to its plain version, at a TP-8 rank's
    shapes, each wrapper call counted as one launch; one ``tp8_shapes``
    line with their errors and CUDA-event times."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    from repro_torch.kernels.mamba_scan import (mamba1_scan_cuda,
                                                mamba1_scan_ref)

    def launched(op, fn):
        before = _build.launches[op]
        out = fn()
        if _build.launches[op] != before + 1:
            fail(f"{op} at a TP-8 shape: not launched once")
        return out

    what, B, Sq, Sk, H, KV, dh, win, off, dt = TP8_K7
    q, k, v = attention_inputs(dev, 41, B, Sq, Sk, H, KV, dh, dt)
    got = launched("flash_attention",
                   lambda: flash_attention_cuda(q, k, v, causal=True))
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    k7_err = held(got, want, TOL[dt], f"K7 at {what}")
    del got, want
    k7 = {"shape": what, "instantiation": k7_instantiation(dt, dh),
          "max_abs_err": k7_err,
          "call_ms": cuda_ms(lambda: flash_attention_cuda(q, k, v,
                                                          causal=True)),
          "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                          causal=True),
                              reps=3)}
    del q, k, v
    args = mamba_inputs(dev, "bfloat16", **TP8_K8)
    h0 = torch.randn((TP8_K8["B"], TP8_K8["D"], TP8_K8["N"]), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    run = lambda f: f(*args, h0, return_state=True,  # noqa: E731
                      y_dtype=torch.float32)
    got = launched("mamba1_scan", lambda: run(mamba1_scan_cuda))
    want = run(mamba1_scan_ref)
    torch.cuda.synchronize()
    k8 = {"shape": "falcon-mamba-7b prefill, TP 8: " + ", ".join(
        f"{n} {v}" for n, v in TP8_K8.items()),
        "max_abs_err": max(bitwise(got[0], want[0], "K8 y at TP 8"),
                           bitwise(got[1], want[1], "K8 h_last at TP 8")),
        "call_ms": cuda_ms(lambda: run(mamba1_scan_cuda)),
        "plain_ms": cuda_ms(lambda: run(mamba1_scan_ref), reps=3)}
    del got, want, args, h0
    torch.cuda.empty_cache()
    log(json.dumps({"tp8_shapes": {"k7": k7, "k8": k8}}))

# ---------------- phase 4n: training on one card ----------------

TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# (config, its depth on the card (None: whole), the forward and backward
# kernels' launch keys, JSON keys and pieces of their names): h2o-danube-
# 1.8b whole (K7, K7b), falcon-mamba-7b at full width cut to 16 of its 64
# layers (K8, K8b; its whole train state, ~116 GB, does not fit 80 GB)
TRAIN_PATHS = [
    ("h2o-danube-1.8b", None, ("flash_attention", "k7", "flash_kernel"),
     ("flash_attention_bwd", "k7b", "flash_bwd_kernel")),
    ("falcon-mamba-7b", 16, ("mamba1_scan", "k8", "scan_kernel"),
     ("mamba1_scan_bwd", "k8b", "scan_bwd_kernel")),
]


def train_path(dev, arch: str, depth, fwd: tuple, bwd: tuple,
               train_launches: dict) -> None:
    """Phase 4n (i)/(ii) (module docstring): ``arch`` (``depth`` layers)
    at full width, mixed-precision AdamW with remat, through
    ``make_train_step`` on ``SyntheticLM`` batches; the timed steps'
    launches go into ``train_launches``. The model and its state are
    freed at the end."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training.data import DataCfg, SyntheticLM
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    opt = O.OptCfg(lr=3e-4, warmup_steps=min(100, steps // 10 + 1),
                   total_steps=steps, mixed_precision=True)
    t = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    n_params = M.param_count(model)
    state = O.init_state(model, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    data = SyntheticLM(DataCfg(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                               vocab=cfg.vocab, seed=0))
    step_fn = make_train_step(cfg, opt)

    def batch():
        return {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}

    losses, step_ms = [], []
    for i in range(steps):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launches()
        b = batch()
        t = time.perf_counter()
        state, met = step_fn(state, b)
        loss = float(met["loss"])           # waits for the step
        if i >= TRAIN_WARMUP:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        if not math.isfinite(loss):
            fail(f"{arch} train step {i + 1}: loss {loss}")
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {k: c / TRAIN_STEPS for k, c in launches.items()}
    (fkey, fname, fpiece), (bkey, bname, bpiece) = fwd, bwd
    if per_step[fkey] != 2 * cfg.n_layers or per_step[bkey] != cfg.n_layers:
        fail(f"{arch} train: {fkey} {per_step[fkey]} and {bkey} "
             f"{per_step[bkey]} launches a step, expected "
             f"{2 * cfg.n_layers} (forward and remat) and {cfg.n_layers}")
    for k, c in launches.items():
        train_launches[k] += c
    timed = losses[TRAIN_WARMUP:]
    if not (timed[-1] < timed[0] and losses[-1] < losses[0]):
        fail(f"{arch} train: the loss did not fall: {losses}")
    wall = statistics.median(step_ms)
    op = f"{bkey}_cuda"
    calls, bwd_ms = op_event_ms(lambda: step_fn(state, batch()), op)
    bd = device_breakdown(lambda: step_fn(state, batch()), wall,
                          [(fname, fpiece), (bname, bpiece)])
    if bname == "k7b" and (not bd["kernel_names"]["k7b"] or any(
            "flash_bwd_kernel_sm90" not in n
            for n in bd["kernel_names"]["k7b"])):
        fail(f"{arch} train: K7b ran {bd['kernel_names']['k7b']}, expected "
             f"only the tensor-core flash_bwd_kernel_sm90 (pre, main, post)")
    log(json.dumps({
        "train": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
        "dtype": "bf16 model, float32 master, m and v (mixed precision)",
        "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
        "init_s": init_s, "step_ms": step_ms, "step_ms_median": wall,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / wall,
        "max_memory_allocated": peak, "losses": losses,
        f"{fname}_launches_per_step": per_step[fkey],
        f"{bname}_launches_per_step": per_step[bkey],
        f"{bname}_event_ms_per_step": bwd_ms, f"{bname}_event_calls": calls,
        f"{bname}_share_of_step": bwd_ms / wall, "breakdown": bd}))
    del model, state, step_fn
    torch.cuda.empty_cache()


CUT_STEPS = 12                  # phase 4n (iii)'s steps: 4n's schedule


def train_cut_against_cpu(dev, arch: str, fwd: str, bwd: str,
                          mixed: bool, steps: int = CUT_STEPS) -> None:
    """Phase 4n (iii): ``arch`` at full width cut to 2 layers, the same
    weights and ``SyntheticLM`` batches (1 × 256) on the card (``fwd``/
    ``bwd`` kernels) and on the CPU (the plain versions), ``steps`` steps
    of 4n's schedule (lr 3e-4, 2 warm-up steps). ``mixed=False``: float32
    (Adam eps 1e-5, as ``tests/test_torch_train.py``: a gradient that
    cancels to ≈0 would turn float32 rounding into a ±lr step); the first
    step's loss at rtol 1e-4, its gradients and updated parameters within
    a relative L2 error of 1e-3, and every step's loss at rtol 1e-3.
    ``mixed=True``: bf16 mixed precision, 4n's optimizer as it is; the
    first step's gradients within a relative L2 error of 5e-2 (the tensor-
    core K7b's only model-level check) and each side's losses logged.
    ``steps=1`` holds the first step alone."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training.data import DataCfg, SyntheticLM
    from repro_torch.training.train_step import (_grads, make_loss_fn,
                                                 make_train_step)
    cut = dataclasses.replace(get_config(arch), n_layers=2)
    if not mixed:
        cut = dataclasses.replace(cut, dtype="float32")
    opt = O.OptCfg(lr=3e-4, warmup_steps=TRAIN_WARMUP, total_steps=CUT_STEPS,
                   mixed_precision=mixed, **({} if mixed else {"eps": 1e-5}))
    card = M.init_params(cut, seed=2, device=dev)
    host = copy.deepcopy(card).to("cpu")
    card_state, host_state = O.init_state(card, opt), O.init_state(host, opt)
    data = SyntheticLM(DataCfg(batch=1, seq=256, vocab=cut.vocab, seed=3))
    batches = [{k: torch.from_numpy(v) for k, v in next(data).items()}
               for _ in range(steps)]
    what = f"{arch} train cut ({'bf16 mixed' if mixed else 'float32'})"
    loss_fn = make_loss_fn(cut)
    _build.reset_launches()
    loss = loss_fn(card, {k: v.to(dev) for k, v in batches[0].items()})[0]
    grads = _grads(loss, card)
    loss = float(loss.detach())
    torch.cuda.synchronize()
    if _build.launches[fwd] != 4 or _build.launches[bwd] != 2:
        fail(f"{what}: {fwd} {_build.launches[fwd]} and {bwd} "
             f"{_build.launches[bwd]} launches, expected 4 and 2")
    t = time.perf_counter()
    want_loss = loss_fn(host, batches[0])[0]
    want = _grads(want_loss, host)
    want_loss = float(want_loss.detach())
    cpu_s = time.perf_counter() - t
    if not mixed and not math.isclose(loss, want_loss, rel_tol=1e-4):
        fail(f"{what}: loss {loss} on the card, {want_loss} on the CPU")
    limit = 5e-2 if mixed else 1e-3
    worst = ("", 0.0)

    def hold(got, want, kind):
        nonlocal worst
        for n, g in got.items():
            w = want[n].float()
            rel = float(torch.linalg.vector_norm(g.cpu().float() - w)
                        / torch.linalg.vector_norm(w).clamp(min=1e-30))
            if not rel <= limit:
                fail(f"{what}: {kind} {n} relative L2 error {rel}")
            worst = max(worst, (n, rel), key=lambda p: p[1])
    hold(grads, want, "gradient")
    if not mixed:
        O.apply_updates(card_state, grads, opt)
        O.apply_updates(host_state, want, opt)
        hold({n: p.detach() for n, p in card.named_parameters()},
             {n: p.detach() for n, p in host.named_parameters()},
             "updated parameter")
    del grads, want
    card_losses, host_losses = [loss], [want_loss]
    card_s = cpu_steps_s = 0.0
    if steps > 1:
        if not mixed:   # the steps start again from the drawn weights
            card = M.init_params(cut, seed=2, device=dev)
            host = copy.deepcopy(card).to("cpu")
            card_state, host_state = (O.init_state(card, opt),
                                      O.init_state(host, opt))
        step_fn = make_train_step(cut, opt)
        card_losses, host_losses = [], []
        t = time.perf_counter()
        for b in batches:
            card_state, met = step_fn(card_state, {k: v.to(dev)
                                                   for k, v in b.items()})
            card_losses.append(float(met["loss"]))
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        for b in batches:
            host_state, met = step_fn(host_state, b)
            host_losses.append(float(met["loss"]))
        cpu_steps_s = time.perf_counter() - t
    if not all(map(math.isfinite, card_losses + host_losses)):
        fail(f"{what}: losses {card_losses} (card), {host_losses} (CPU)")
    if not mixed:
        for i, (a, b) in enumerate(zip(card_losses, host_losses)):
            if not math.isclose(a, b, rel_tol=1e-3):
                fail(f"{what}: step {i + 1} loss {a} on the card, {b} on "
                     f"the CPU (rtol 1e-3)")
    log(json.dumps({"train_cut": f"{arch} at full width, depth cut to 2 "
                    f"layers, {'bf16 mixed precision' if mixed else 'float32'}"
                    ", card against CPU", "batch": 1, "seq": 256,
                    "steps": steps, "lr": opt.lr,
                    "warmup_steps": opt.warmup_steps, "eps": opt.eps,
                    "loss_card": loss, "loss_cpu": want_loss,
                    "worst_rel_l2": worst[1], "worst": worst[0],
                    "rel_l2_limit": limit, "losses_card": card_losses,
                    "losses_cpu": host_losses,
                    "rises_first": max(card_losses[:4]) > card_losses[0],
                    "falls": card_losses[-1] < card_losses[0],
                    "card_steps_s": card_s, "cpu_s": cpu_s,
                    "cpu_steps_s": cpu_steps_s}))
    del card, host, card_state, host_state
    torch.cuda.empty_cache()


# (what, B, S, H, KV, dh, window): phase 4n (iv)'s K7b shapes, causal
K7B_CHECKS = [("h2o-danube-1.8b train", 4, 2048, 32, 8, 80, 4096),
              ("llama3-8b", 4, 2048, 32, 8, 128, None),
              ("gemma3-4b local", 2, 2048, 8, 4, 256, 1024)]


def grads_held(got, want, dt: str, what: str, scaled: tuple = ()) -> float:
    """A backward kernel's outputs against its plain version: float32 at
    rtol 1e-4 and atol 1e-5, bf16 at a relative L2 error of 1e-2. The
    outputs at the indices ``scaled`` take atol 1e-5 of their scale
    (max(1, their largest magnitude)): K8b's dB, dC and dA sum 8,192
    channels (and dA B·L steps) of O(1) terms, whose float32 rounding in
    another order reaches 1e-5 at entries that cancel to near 0. Logs each
    output's errors; returns the max absolute error."""
    import torch
    err, seen = 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        g, w = g.float(), w.float()
        if tuple(g.shape) != tuple(w.shape) or not bool(
                torch.isfinite(g).all()):
            fail(f"{what}[{i}]: shape {tuple(g.shape)} or non-finite entries")
        abs_err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max())) if i in scaled else 1.0
        rel = float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w).clamp(min=1e-30))
        seen.append({"max_abs_err": abs_err, "scale": scale, "rel_l2": rel})
        err = max(err, abs_err)
        if dt == "float32":
            if not torch.allclose(g, w, rtol=1e-4, atol=1e-5 * scale):
                fail(f"{what}[{i}]: not allclose at rtol 1e-4, atol 1e-5 × "
                     f"{scale} (max abs err {abs_err})")
        elif not rel <= 1e-2:
            fail(f"{what}[{i}]: relative L2 error {rel} (limit 1e-2)")
    log(json.dumps({"grads_held": what, "outputs": seen}))
    return err


def backward_inputs(dev, seed, B, S, H, KV, dh, dtype):
    """q, k, v and do for K7b: :func:`attention_inputs` and do from the
    next seed."""
    import torch
    q, k, v = attention_inputs(dev, seed, B, S, S, H, KV, dh, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    do = torch.randn((B, S, H, dh), generator=gen, device=dev).to(q.dtype)
    return q, k, v, do


def lse_held(got, want, what: str) -> float:
    """K7's log-sum-exp against the plain version's: +inf on the same
    rows, the rest at rtol 1e-5 (atol 1e-5 for rows whose lse is near 0).
    Returns the max absolute error of the finite rows."""
    import torch
    empty = torch.isinf(want)
    if not torch.equal(torch.isinf(got), empty) or not bool(
            (got[empty] > 0).all()):
        fail(f"{what}: +inf rows differ from the plain version's")
    g, w = got[~empty], want[~empty]
    if not torch.allclose(g, w, rtol=1e-5, atol=1e-5):
        fail(f"{what}: lse not allclose at rtol 1e-5 (max abs err "
             f"{float((g - w).abs().max())})")
    return float((g - w).abs().max()) if g.numel() else 0.0


def check_k7b(dev) -> float:
    """Phase 4n (iv): K7b against ``flash_attention_bwd_ref`` at
    ``K7B_CHECKS``. float32 on the SIMT kernel (o from the plain version);
    bf16 on the tensor-core route with o and lse from K7: K7's lse held
    to the plain version's, the gradients to the plain version given the
    same lse, dk and dv bit-equal over a second call and dq allclose, and
    only ``flash_bwd_kernel_sm90`` kernels launched. Returns the float32
    error at the first shape."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda,
                                                     flash_attention_ref)
    errs = []
    for i, (what, B, S, H, KV, dh, win) in enumerate(K7B_CHECKS):
        for dt in ("float32", "bfloat16"):
            q, k, v, do = backward_inputs(dev, 40 + i, B, S, H, KV, dh, dt)
            lse, extra = None, {}
            if dt == "float32":
                o = flash_attention_ref(q, k, v, window=win).contiguous()
            else:
                o, lse = flash_attention_cuda(q, k, v, window=win,
                                              return_lse=True)
                _, want_lse = flash_attention_ref(q, k, v, window=win,
                                                  return_lse=True)
                extra["lse_max_abs_err"] = lse_held(lse, want_lse,
                                                    f"K7 lse {what}")
                del want_lse
            got = flash_attention_bwd_cuda(q, k, v, o, do, lse, window=win)
            want = flash_attention_bwd_ref(q, k, v, o, do, lse, window=win)
            torch.cuda.synchronize()
            err = grads_held(got, want, dt, f"K7b {what} {dt}")
            errs.append(err)
            del want
            if lse is not None:
                again = flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                 window=win)
                torch.cuda.synchronize()
                if not (torch.equal(got[1], again[1])
                        and torch.equal(got[2], again[2])):
                    fail(f"K7b {what}: dk or dv differ between two calls")
                held(again[0], got[0], TOL[dt], f"K7b {what} dq, 2nd call")
                del again
                names = kernel_names(lambda: flash_attention_bwd_cuda(
                    q, k, v, o, do, lse, window=win), "flash_bwd_kernel")
                if len(names) != 3 or any("flash_bwd_kernel_sm90" not in n
                                          for n in names):
                    fail(f"K7b {what}: ran {names}, expected the three "
                         f"flash_bwd_kernel_sm90 kernels")
                extra["kernels"] = [n[:60] for n in names]
            log(f"K7b flash_attention_bwd {what}: B={B} S={S} H={H} KV={KV} "
                f"dh={dh} window={win} {dt} agrees (max_abs_err {err}) "
                f"{json.dumps(extra)}")
            del q, k, v, do, o, got, lse
            torch.cuda.empty_cache()
    return errs[0]


def scan_backward_inputs(dev, dtype):
    """K8b's inputs at falcon-mamba-7b's training layer (B 4, L 2048, D
    8192, N 16): :func:`mamba_inputs` and a float32 dy, the mixer's form."""
    import torch
    args = mamba_inputs(dev, dtype, B=TRAIN_BATCH, L=TRAIN_SEQ)
    gen = torch.Generator(device=dev).manual_seed(9)
    dy = torch.randn(args[0].shape, generator=gen, device=dev)
    return args + (None, dy)


def check_k8b(dev) -> float:
    """Phase 4n (v): K8b against ``mamba1_scan_bwd_ref`` at falcon-mamba-
    7b's layer, float32 and bf16 inputs, and a second call bit-equal to
    the first in every output. Returns the float32 error."""
    import torch
    from repro_torch.kernels.mamba_scan import (mamba1_scan_bwd_cuda,
                                                mamba1_scan_bwd_ref)
    errs = []
    for dt in ("float32", "bfloat16"):
        args = scan_backward_inputs(dev, dt)
        got = mamba1_scan_bwd_cuda(*args)
        want = mamba1_scan_bwd_ref(*args)
        again = mamba1_scan_bwd_cuda(*args)
        torch.cuda.synchronize()
        errs.append(grads_held(got, want, dt, f"K8b {dt}", scaled=(2, 3, 4)))
        for i, (g, a) in enumerate(zip(got, again)):
            if (g is None) != (a is None) or (
                    g is not None and not torch.equal(g, a)):
                fail(f"K8b {dt}: output {i} differs between two calls")
        log(f"K8b mamba1_scan_bwd {tuple(args[0].shape)} N="
            f"{args[4].shape[1]} {dt} agrees (max_abs_err {errs[-1]}), "
            f"two calls bit-equal")
        del args, got, want, again
        torch.cuda.empty_cache()
    return errs[0]


def training_phase(dev) -> tuple:
    """Phase 4n: (i) and (ii) through :func:`train_path`, (iii) each
    family's 2-layer cut against the CPU (h2o-danube-1.8b's 12 steps in
    float32 and in bf16, falcon-mamba-7b's first step in float32), (iv)
    K7b's and (v) K8b's checks. Returns (the timed steps' launches, K7b's and K8b's
    float32 errors)."""
    from repro_torch.kernels import _build
    t = time.perf_counter()
    train_launches = dict.fromkeys(_build.launches, 0)
    for arch, depth, fwd, bwd in TRAIN_PATHS:
        train_path(dev, arch, depth, fwd, bwd, train_launches)
    dense, ssm = TRAIN_PATHS
    train_cut_against_cpu(dev, dense[0], dense[2][0], dense[3][0], mixed=False)
    # the tensor-core K7b's model check
    train_cut_against_cpu(dev, dense[0], dense[2][0], dense[3][0], mixed=True)
    # K8/K8b's cut: its first step (12 steps cost 2.7 CPU minutes)
    train_cut_against_cpu(dev, ssm[0], ssm[2][0], ssm[3][0], mixed=False,
                          steps=1)
    k7b_err, k8b_err = check_k7b(dev), check_k8b(dev)
    log(json.dumps({"train_phase": {"phase_4n_s": time.perf_counter() - t}}))
    return train_launches, k7b_err, k8b_err


# ---------------- phase 5: kernel times at the main path's shapes --------

def kernel_times(dev, pg, path_launches, plain_k4):
    import torch
    from repro_torch.core import (SemiringProgram, graph_block,
                                  init_max_vertex)
    from repro_torch.kernels import flat
    from repro_torch.kernels import megastep as mega
    from repro_torch.kernels.ref import semiring_spmv_ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_cuda

    gb = graph_block(pg, dev)
    cm = mega.compose_mailbox(gb)
    n, d = cm["nbr"].shape

    # K1 at PageRank's pull: plus_times over the flat PAD-filled adjacency;
    # the outputs are O(1/n), so the check is relative only
    deg = gb["out_degree"].reshape(-1).float()
    r0 = torch.where(cm["vmask"], 1.0 / pg.n_global, 0.0)
    x = torch.where(deg > 0, r0 / deg.clamp(min=1.0), 0.0).contiguous()
    nbr, ones = cm["nbr"], flat.unit_weights(cm)
    got = semiring_spmv_cuda(x, nbr, ones, "plus_times")
    want = semiring_spmv_ref(x, nbr, ones, "plus_times")
    k1_err = compare("plus_times", got, want, "K1 at the main path",
                     rtol=1e-5, atol=0.0)
    k1_ms = cuda_ms(lambda: semiring_spmv_cuda(x, nbr, ones, "plus_times"))
    k1_dev = device_ms(lambda: semiring_spmv_cuda(x, nbr, ones, "plus_times"),
                       "spmv_kernel")
    k1_plain = cuda_ms(lambda: semiring_spmv_ref(x, nbr, ones, "plus_times"))
    ok = nbr >= 0
    rows = torch.arange(n, device=dev).repeat_interleave(ok.sum(1))
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, nbr[ok].long()]), ones[ok],
        (n, n)).coalesce().to_sparse_csr()
    xcol = x.reshape(-1, 1)
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, xcol))
    lib_dev = device_ms(lambda: torch.sparse.mm(csr, xcol))
    k1_bytes = n * d * 8 + n * 8
    k1_ops = 2 * n * d
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_OPS_PER_S) * 1e3

    # K3 at CC's first superstep (the widest: every vertex is in the
    # frontier and the fixpoint runs its longest). max_first reads no edge
    # weights, so the bounds count none
    st = SemiringProgram(semiring="max_first",
                         init_fn=init_max_vertex).init(gb)
    xs, ch, fr = (st[k].reshape(-1).contiguous()
                  for k in ("x", "changed_v", "frontier"))
    want = mega.megastep_semiring_ref(xs, ch, fr, cm, "max_first")
    k3_err = 0.0
    saved = mega.K3_DENSE_FRONTIER
    try:  # each walk forced, then the wrapper's own switch
        for frac in (0.0, 2.0, saved):
            mega.K3_DENSE_FRONTIER = frac
            got = mega.megastep_semiring_cuda(xs, ch, fr, cm, "max_first")
            torch.cuda.synchronize()
            k3_err = max(k3_err, compare(
                "max_first", got[0], want[0],
                f"K3 at the main path x2 (K3_DENSE_FRONTIER {frac})"))
            for a, b, what in zip(got[1:], want[1:],
                                  ("changed2", "frontier_left", "liters")):
                compare("bool" if what != "liters" else "max_first", a, b,
                        f"K3 at the main path {what} (K3_DENSE_FRONTIER "
                        f"{frac})")
    finally:
        mega.K3_DENSE_FRONTIER = saved
    liters = got[3].cpu().numpy()
    sweeps = int(liters.max())
    k3_ms = cuda_ms(lambda: mega.megastep_semiring_cuda(
        xs, ch, fr, cm, "max_first"), reps=3)
    k3_plain = cuda_ms(lambda: mega.megastep_semiring_ref(
        xs, ch, fr, cm, "max_first"), reps=3)
    k3_dev = device_ms(lambda: mega.megastep_semiring_cuda(
        xs, ch, fr, cm, "max_first"), "megastep_kernel", reps=3)
    m_lo = cm["lo_src"].shape[1]
    m_hi = cm["hub_src"].shape[1]
    hub_rows = int(cm["hub_row_ok"].sum())
    # a sweep of a row reads its lanes' indices (D·4) and its x (4), writes
    # x and f (4 + 1) and reads vmask (1); gathered x and f sit in L2. The
    # dense bound takes every row every sweep over all D lanes (the TPU
    # kernel's work), the frontier bound only the rows with an active
    # in-neighbour, counted from the plain version's sweeps at this input
    per_row = d * 4 + 10
    per_sweep = n * per_row
    act_rows, sizes = k3_work(cm, xs, ch, fr, "max_first")
    once = (n * m_lo * 5 + hub_rows * (4 + m_hi * 5)  # lo maps, hub rows
                                                     # (src 4 + ok 1 a lane)
            + n * (4 + 1 + 1 + 1 + 1)            # x, changed, frontier,
                                                 # vmask, hub_row_ok
            + n * (4 + 1 + 1) + 4 * pg.num_parts)  # outputs
    k3_bytes = once + sweeps * per_sweep
    k3_ops = sweeps * n * d * 2
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k3_ops / FP32_OPS_PER_S) * 1e3
    k3_frontier_bound = max(
        (once + act_rows * per_row) / HBM_BYTES_PER_S,
        act_rows * d * 2 / FP32_OPS_PER_S) * 1e3
    # K3's bound: the frontier bound over the lanes some row uses (the
    # ELL's width cut by mega.k3_lanes), the least the card must move
    width = mega.k3_lanes(cm, "max_first")[0].shape[1]
    k3_lanes_bound = max(
        (once + act_rows * (width * 4 + 10)) / HBM_BYTES_PER_S,
        act_rows * width * 2 / FP32_OPS_PER_S) * 1e3
    if k3_dev < k3_lanes_bound:
        fail(f"K3 at CC superstep 0: {k3_dev} ms is below its bound over "
             f"the frontier rows and the lanes it reads, {k3_lanes_bound} "
             f"ms: the count or the kernel is wrong")
    shape = mega.k3_cluster_shape(pg.num_parts, "max_first", dev)
    dense_rows = mega.k3_dense_rows(cm["v_max"])
    # what K3 keeps in the mailbox (the out-adjacency and the cut lanes,
    # min_plus adding its weights) and allocates a launch (fgen, stamp,
    # x_alt, the two lists)
    kept = {key: cm[key].numel() * cm[key].element_size()
            for key in ("out_off", "out_src", "k3_nbr")}
    kept["k3_wgt (min_plus)"] = kept["k3_nbr"]
    log(json.dumps({"k3": "cc superstep 0", "n": n, "D": d, "sweeps": sweeps,
                    "kept_bytes": kept, "scratch_bytes": n * 4 * 6,
                    "liters": liters.tolist(),
                    "partition_sweeps_sum": int(liters.sum()),
                    "active_row_sweeps": act_rows,
                    "active_rows_per_sweep": act_rows / max(sweeps, 1),
                    "work_list_sweeps": int(((sizes > 0)
                                             & (sizes < dense_rows)).sum()),
                    "dense_sweeps": int((sizes >= dense_rows).sum()),
                    "bytes_per_sweep_dense": per_sweep, "lanes_read": width,
                    "ms": k3_dev, "bound_ms": k3_lanes_bound,
                    "share_of_bound": k3_lanes_bound / k3_dev,
                    "bound_frontier_ms": k3_frontier_bound,
                    "bound_dense_ms": k3_bound,
                    "cluster_shape": shape,
                    "K3_DENSE_FRONTIER": saved, "dense_rows": dense_rows}))
    barrier_times(dev, n, pg.num_parts, shape)

    k2 = k2_times(dev, pg, path_launches)
    k4 = k4_times(dev, pg, cm, path_launches, plain_k4)
    k5, k6 = k5_k6_times(dev, pg, path_launches)
    return {"kernels": [
        {"name": "semiring_spmv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/semiring_spmv.cu",
         "replaces": "src/repro/kernels/semiring_spmv.py:125",
         "launches": path_launches["semiring_spmv"],
         "max_abs_err": k1_err, "ms": k1_dev, "call_ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": "bytes",
         "library_ms": lib_dev, "library_call_ms": lib_ms},
        {"name": "megastep_semiring", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/megastep.cu",
         "replaces": "src/repro/kernels/megastep.py:622",
         "launches": path_launches["megastep_semiring"],
         "max_abs_err": k3_err, "ms": k3_dev, "call_ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_lanes_bound,
         "bound_by": "bytes", "bound_frontier_ms": k3_frontier_bound,
         "bound_dense_ms": k3_bound, "library_ms": None},
        k2, k4, k5, k6,
    ]}


def k3_work(cm, x, ch, fr, semiring):
    """The work of one superstep's masked fixpoint as the plain version
    runs it from (x, ch, fr): the rows with an active in-neighbour summed
    over the sweeps, and the frontier's size per partition at each sweep
    (sweeps × P). The data decides both, not the implementation."""
    import torch
    from repro_torch.kernels import flat
    from repro_torch.kernels import megastep as mega
    from repro_torch.kernels.ref import semiring_spmv_frontier_ref
    act_rows, sizes = [], []

    def sweep(xc, f, nbr, wgt, sr):
        y, act = semiring_spmv_frontier_ref(xc, f, nbr, wgt, sr)
        act_rows.append(act.sum())
        sizes.append(f.reshape(cm["num_parts"], -1).sum(dim=1))
        return y, act

    combine = flat.idempotent_combine(semiring)
    vm = cm["vmask"]
    inbox = mega.deliver_flat(x, ch, cm, combine, semiring == "min_plus")
    x1 = flat.combine_ew(combine, x, inbox)
    flat.local_fixpoint(x1, fr | ((x1 != x) & vm), cm, vm, cm["num_parts"],
                        semiring, sweep=sweep)
    return (int(torch.stack(act_rows).sum()),
            torch.stack(sizes).cpu().numpy())


def k4_work(cm, x, ch, fr, semiring, max_steps=4096):
    """The work of the resident loop as the plain version runs it from
    (x, ch, fr), round by round: the send set's size (``send``), the rows
    with a feed lane whose source is in it (``delivered``) and the bytes of
    their feed maps (``feed_bytes``: each lane's ok byte and source index,
    min_plus adding its weight; hub_row_ok, and the hub row where there is
    one), the frontier after delivery (``frontier``) and the rows with an
    active in-neighbour (``active``). The data decides these, not the
    implementation. Returns (a dict of per-round int64 arrays, the plain
    loop's outputs (x2, changed2, frontier2, iters, liters)), each round the
    arithmetic of ``megastep.resident_step_semiring``."""
    import torch
    from repro_torch.kernels import flat
    from repro_torch.kernels import megastep as mega
    from repro_torch.kernels.ref import semiring_spmv_frontier_ref
    combine = flat.idempotent_combine(semiring)
    minp = semiring == "min_plus"
    vm, P = cm["vmask"], cm["num_parts"]
    m_lo, m_hi = cm["lo_src"].shape[1], cm["hub_src"].shape[1]
    lane = 5 + 4 * minp
    row_feed = m_lo * lane + 1 + torch.where(
        cm["hub_row_ok"], 4 + m_hi * lane, 0).long()
    lo_src, hub_src = cm["lo_src"].long(), cm["hub_src"].long()
    hub_row = cm["hub_row"].long()
    cols = {k: [] for k in ("send", "delivered", "feed_bytes", "frontier",
                            "active")}
    li = torch.zeros(P, dtype=torch.int32, device=x.device)
    it = 0
    while it < max_steps and bool(ch.any()):
        live = (cm["lo_ok"] & ch[lo_src]).any(dim=1)
        hub_live = (cm["hub_ok"] & ch[hub_src]).any(dim=1)
        live |= cm["hub_row_ok"] & hub_live[hub_row]
        inbox = mega.deliver_flat(x, ch, cm, combine, minp)
        x1 = flat.combine_ew(combine, x, inbox)
        f = fr | ((x1 != x) & vm)
        y, act = semiring_spmv_frontier_ref(x1, f, cm["nbr"], cm["wgt"],
                                            semiring)
        x2 = flat.combine_ew(combine, x1, y)
        for key, val in (("send", ch.sum()), ("delivered", live.sum()),
                         ("feed_bytes", row_feed[live].sum()),
                         ("frontier", f.sum()), ("active", act.sum())):
            cols[key].append(val)
        li += f.reshape(P, -1).any(dim=1).int()
        x, ch, fr = x2, (x2 != x) & vm, (x2 != x1) & vm
        it += 1
    counts = {k: (torch.stack(v).cpu().numpy().astype(np.int64) if v
                  else np.zeros(0, np.int64)) for k, v in cols.items()}
    return counts, (x, ch, fr, torch.tensor(it, dtype=torch.int32,
                                            device=x.device), li)


def k4_bound(cm, counts, semiring, width):
    """K4's tight bound in ms from :func:`k4_work`'s counts: the state in
    and out once a launch (x, changed, frontier read, written: 12 B a
    row), the rows delivered to over their feed bytes, and the rows with an
    active in-neighbour over ``width`` lanes (4 B of index each, as much
    again of weight for min_plus) plus their x read and written, frontier
    and changed (10 B); all over the HBM rate. Also the dense figure: every
    row every round over all D lanes, every feed map and the state (the
    TPU kernel's work)."""
    n, d = cm["nbr"].shape
    lane_b = 4 * (2 if semiring == "min_plus" else 1)
    rounds = len(counts["active"])
    tight = (n * 12 + int(counts["feed_bytes"].sum())
             + int(counts["active"].sum()) * (width * lane_b + 10))
    m_lo = cm["lo_src"].shape[1]
    h, m_hi = cm["hub_src"].shape
    per_round = (n * d * lane_b + n * m_lo + int(cm["lo_ok"].sum()) * 4
                 + h * m_hi + int(cm["hub_ok"].sum()) * 4 + n * 2 + n * 12)
    return (tight / HBM_BYTES_PER_S * 1e3,
            rounds * per_round / HBM_BYTES_PER_S * 1e3)


def barrier_times(dev, n: int, num_parts: int, k3_shape: dict) -> None:
    """The two barriers alone (csrc/barrier_probe.cu): one grid.sync()
    over K4's cooperative grid at the main path's n and P, and one cluster
    barrier at K3's cluster shape there, each the mean over 10,000 back to
    back, timed on the card's global timer; with the card's name and power
    limit."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    lib = _build.library()
    iters = 10000
    grid = (ctypes.c_int * 2)()
    _build.check(lib.resident_grid_shape(n, num_parts, 0, dev.index or 0,
                                         grid), "K4 grid shape")
    ns = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    size, clusters = k3_shape["blocks_per_cluster"], k3_shape["clusters"]
    out = {}
    for what, args in (("grid_sync_us", (0, grid[0], grid[1])),
                       ("cluster_sync_us", (size, clusters * size, 1024))):
        runs = []
        for _ in range(3):
            _build.check(lib.barrier_probe_launch(
                *args, iters, ns.data_ptr(), dev.index or 0, stream),
                f"barrier probe {what}")
            torch.cuda.synchronize()
            runs.append(int(ns) / iters / 1e3)
        out[what] = statistics.mean(runs)
        out[what + "_runs"] = runs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(json.dumps({"barriers": {
        **out, "iters": iters, "grid_blocks": grid[0],
        "grid_threads": grid[1], "cluster_blocks": size,
        "clusters": clusters, "cluster_threads": 1024, "card": smi}}))


def k4_times(dev, pg, cm, path_launches, plain):
    """K4 at phase 4c (i)'s shapes: one launch from CC's and from SSSP's
    init state runs the whole resident loop. ``plain`` holds the plain
    resident loop's runs from those states in phase 4c (outputs and
    CUDA-event ms). K4's bound counts the work of this run's rounds
    (:func:`k4_work`, :func:`k4_bound`); the ``k4`` line gives both runs,
    the kernels entry CC's."""
    import torch
    from repro_torch.core import (SemiringProgram, graph_block,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.kernels import megastep as mega

    gb = graph_block(pg, dev)
    loc = (int(pg.part_of[0]), int(pg.local_of[0]))
    n = cm["n"]
    out, entry = {}, None
    for algo, sr, init in (("cc", "max_first", init_max_vertex),
                           ("sssp", "min_plus", make_sssp_init(*loc))):
        st = SemiringProgram(sr, init).init(gb)
        start = tuple(st[k].reshape(-1).contiguous()
                      for k in ("x", "changed_v", "frontier"))
        counts, work_out = k4_work(cm, *start, sr)
        got = mega.resident_megastep_cuda(*start, cm, sr, 4096)
        torch.cuda.synchronize()
        ref, plain_ms = plain[algo]
        err = 0.0
        for want, what in ((ref, "the timed plain loop"),
                           (work_out, "k4_work's plain loop")):
            err = max(err, compare(sr, got[0], want[0],
                                   f"K4 {algo} x2 against {what}"))
            for a, b, name in zip(got[1:], want[1:], ("changed2",
                                                      "frontier2", "iters",
                                                      "liters")):
                compare("bool" if name.endswith("2") else "max_first", a, b,
                        f"K4 {algo} {name} against {what}")
        rounds = int(got[3])
        call_ms = cuda_ms(lambda: mega.resident_megastep_cuda(
            *start, cm, sr, 4096), reps=2)
        dev_ms = device_ms(lambda: mega.resident_megastep_cuda(
            *start, cm, sr, 4096), "resident_kernel", reps=2)
        width = mega.k3_lanes(cm, sr)[0].shape[1]
        bound, dense = k4_bound(cm, counts, sr, width)
        if dev_ms < bound:
            fail(f"K4 {algo}: {dev_ms} ms is below its bound over the "
                 f"rows it must touch, {bound} ms: the count or the kernel "
                 f"is wrong")
        cap = max(1, min(mega.k4_dense_rows(n), n))
        kept = {key: cm[key].numel() * cm[key].element_size()
                for key in ("out_off", "out_src", "k3_nbr", "feed_rows")}
        if sr == "min_plus":
            kept["k3_wgt"] = cm["k3_wgt"].numel() * 4
        out[algo] = {
            "rounds": rounds, "ms": dev_ms, "call_ms": call_ms,
            "ms_per_round": dev_ms / rounds, "plain_ms": plain_ms,
            "bound_ms": bound, "share_of_bound": bound / dev_ms,
            "bound_dense_ms": dense, "share_of_dense": dense / dev_ms,
            "frontier_rows": int(counts["frontier"].sum()),
            "active_rows": int(counts["active"].sum()),
            "delivered_rows": int(counts["delivered"].sum()),
            "feed_bytes": int(counts["feed_bytes"].sum()),
            "send_rows": int(counts["send"].sum()),
            "rounds_dense": int((counts["frontier"]
                                 >= mega.k4_dense_rows(n)).sum()),
            "lanes": width, "kept_bytes": kept,
            "launch_bytes": n * (16 + 16 + 4 + 6) + 8 * cap}
        if algo == "cc":
            entry = {
                "name": "resident_megastep", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/megastep.cu",
                "replaces": "src/repro/kernels/megastep.py:650",
                "launches": path_launches["resident_megastep"],
                "max_abs_err": err, "ms": dev_ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "bound_dense_ms": dense, "library_ms": None,
                "library_note": "no PyTorch call computes a multi-round "
                                "gated relaxation", "rounds": rounds,
                "sssp_ms": None}
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["sssp_ms"] = dev_ms
    log(json.dumps({"k4": "cc and sssp from the init state", "n": n,
                    "feed_rows": mega.feed_rows(cm).numel(),
                    "K4_DENSE_FRONTIER": mega.K4_DENSE_FRONTIER,
                    "dense_rows": mega.k4_dense_rows(n), **out}))
    return entry


def k2_times(dev, pg, path_launches) -> dict:
    """K2 at the dense CC run's first sweep (every vertex in the frontier)
    and at a later sweep of the same fixpoint whose frontier is small."""
    import torch
    from repro_torch.core import (GopherEngine, SemiringProgram,
                                  init_max_vertex)
    from repro_torch.kernels.ref import semiring_spmv_frontier_ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_frontier_cuda

    eng = GopherEngine(pg, SemiringProgram("max_first", init_max_vertex),
                       exchange="dense")
    gb = eng._gb_for_staged()
    st = eng.program.init(gb)
    inbox = eng.make_exchange(gb)(st)[0]               # the primed inbox
    x = torch.maximum(st["x"], inbox).reshape(-1).contiguous()
    vm = gb["vmask"].reshape(-1)
    f = (st["frontier"].reshape(-1) | ((x != st["x"].reshape(-1)) & vm))
    nbr, wgt = gb["adj"]["nbr"], gb["adj"]["wgt"]
    n, d = nbr.shape

    def measure(x, f, what):
        y, act = semiring_spmv_frontier_cuda(x, f, nbr, wgt, "max_first")
        wy, wact = semiring_spmv_frontier_ref(x, f, nbr, wgt, "max_first")
        torch.cuda.synchronize()
        err = compare("max_first", y, wy, f"K2 at {what} y")
        compare("bool", act, wact, f"K2 at {what} row_active")
        ms = cuda_ms(lambda: semiring_spmv_frontier_cuda(x, f, nbr, wgt,
                                                         "max_first"))
        plain = cuda_ms(lambda: semiring_spmv_frontier_ref(x, f, nbr, wgt,
                                                           "max_first"))
        dev_ms = device_ms(lambda: semiring_spmv_frontier_cuda(
            x, f, nbr, wgt, "max_first"), "spmv_frontier_kernel")
        # bytes the sweep must move: every index and frontier byte, y and
        # row_active once, and x at the distinct neighbours of active rows
        # (max_first reads no weights)
        ok = nbr[act] >= 0
        x_read = int(torch.unique(nbr[act][ok]).numel())
        nbytes = n * d * 4 + n + n * 5 + x_read * 4
        ops_ = int(ok.sum())                  # one max per gathered lane
        bound = max(nbytes / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S) * 1e3
        return {"ms": dev_ms, "call_ms": ms, "plain_ms": plain,
                "bound_ms": bound,
                "max_abs_err": err, "frontier": int(f.sum()),
                "active_rows": int(act.sum()), "bytes": nbytes}

    first = measure(x, f, "the dense CC run's first sweep")
    sweeps = 0
    while int(f.sum()) > n // 100:     # walk the fixpoint to a 1 % frontier
        y, _ = semiring_spmv_frontier_cuda(x, f, nbr, wgt, "max_first")
        x2 = torch.maximum(x, y)
        f = (x2 != x) & vm
        x = x2
        sweeps += 1
        if not bool(f.any()):
            fail("K2: the fixpoint ended before its frontier fell to 1 %")
    small = measure(x, f, f"sweep {sweeps} (small frontier)")
    small["sweep"] = sweeps
    log(f"K2 first sweep {first}; sweep {sweeps} {small}")
    return {"name": "semiring_spmv_frontier", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/semiring_spmv.cu",
            "replaces": "src/repro/kernels/semiring_spmv.py:85",
            "launches": path_launches["semiring_spmv_frontier"],
            "max_abs_err": max(first["max_abs_err"], small["max_abs_err"]),
            "ms": first["ms"], "call_ms": first["call_ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "small_frontier": small}


def k5_k6_bytes(rows: int, cap: int, n_act: int) -> tuple:
    """The bytes K5 and K6 must move at (rows, cap) with ``n_act`` active
    slots. K5 reads the mask (1 B) a slot, the value (4 B) of each active
    slot only and the budget (4 B) a row, writes pvals, sids and pinv
    (12 B) a slot and counts and over (8 B) a row; K6 reads the mask and
    writes pfwd and pinv a slot and the counts a row."""
    return (rows * cap * 13 + 4 * n_act + rows * 12,
            rows * cap * 9 + rows * 4)


def k5_k6_times(dev, pg, path_launches):
    """K5 and K6 at the compact CC run's first pack (the inbox prime: every
    vertex sends), R = P·P rows of cap slots."""
    import torch
    from repro_torch.core import (GopherEngine, SemiringProgram,
                                  init_max_vertex)
    from repro_torch.core import messages as msg
    from repro_torch.kernels.outbox_compact import (k5_layout,
                                                    launch_floor_cuda,
                                                    outbox_compact_plan_cuda,
                                                    outbox_pack_cuda)
    from repro_torch.kernels.ref import (outbox_compact_plan_ref,
                                         outbox_pack_ref)

    eng = GopherEngine(pg, SemiringProgram("max_first", init_max_vertex),
                       exchange="compact")
    gb = eng._gb_for_staged()
    vals, send = eng.program.messages(eng.program.init(gb), gb)
    P, cap = pg.num_parts, pg.mailbox_cap
    R = P * P
    sv = msg.build_outbox_gather(vals, send, gb["ob_inv"], P, cap,
                                 "max").reshape(R, cap).contiguous()
    act = msg.active_slots(send, gb["ob_inv"], P, cap).reshape(R, cap) \
        .contiguous()
    lim = torch.full((R,), cap, dtype=torch.int32, device=dev)
    ident = float("-inf")
    for a, b in zip(outbox_pack_cuda(sv, act, lim, ident),
                    outbox_pack_ref(sv, act, lim, ident)):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail("K5 at the compact CC run's first pack differs")
    for a, b in zip(outbox_compact_plan_cuda(act),
                    outbox_compact_plan_ref(act)):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail("K6 at the compact CC run's first pack differs")
    k5_ms = cuda_ms(lambda: outbox_pack_cuda(sv, act, lim, ident))
    k5_plain = cuda_ms(lambda: outbox_pack_ref(sv, act, lim, ident))
    k6_ms = cuda_ms(lambda: outbox_compact_plan_cuda(act))
    k6_plain = cuda_ms(lambda: outbox_compact_plan_ref(act))
    k5_dev = device_ms(lambda: outbox_pack_cuda(sv, act, lim, ident),
                       "pack_kernel")
    k6_dev = device_ms(lambda: outbox_compact_plan_cuda(act), "pack_kernel")
    # the launch floor: an empty kernel on the same grid, launched the same
    # way; a time no redesign of the body can go below
    floor = device_ms(lambda: launch_floor_cuda(R, dev), "empty_kernel")
    n_act = int(act.sum())
    k5_bytes, k6_bytes = k5_k6_bytes(R, cap, n_act)
    log(f"K5/K6 at R={R} cap={cap}: {n_act} active slots; K5 "
        f"{k5_ms:.4f} ms a call, {k5_dev:.4f} ms on the device ({k5_bytes} "
        f"B); K6 {k6_ms:.4f} ms a call, {k6_dev:.4f} ms on the device "
        f"({k6_bytes} B); an empty kernel on their grid {floor:.6f} ms; "
        f"layout {k5_layout()}")
    reason = ("no single PyTorch call computes the pack; torch.cumsum "
              "gives only pinv")
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/outbox_compact.cu",
              "max_abs_err": 0.0, "bound_by": "bytes", "library_ms": None,
              "library_note": reason, "floor_ms": floor,
              "layout": k5_layout()}
    return ({"name": "outbox_pack",
             "replaces": "src/repro/kernels/outbox_compact.py:100",
             "launches": path_launches["outbox_pack"], "ms": k5_dev,
             "call_ms": k5_ms, "plain_ms": k5_plain,
             "bound_ms": k5_bytes / HBM_BYTES_PER_S * 1e3, **common},
            {"name": "outbox_compact_plan",
             "replaces": "src/repro/kernels/outbox_compact.py:135",
             "launches": path_launches["outbox_compact_plan"], "ms": k6_dev,
             "call_ms": k6_ms, "plain_ms": k6_plain,
             "bound_ms": k6_bytes / HBM_BYTES_PER_S * 1e3, **common})


BF16_TENSOR_OPS_PER_S = 989.4e12  # H100 SXM dense bf16 tensor cores, data sheet


def k7_times(dev, path_launches) -> dict:
    """K7 at llama3-8b's prefill shape (every prefill layer), with the
    gemma3-4b local and h2o-danube-1.8b prefill shapes beside it. The
    bound counts the FLOP of the visible (query, key) pairs only (4·dh a
    pair: q·k and p·v) at the bf16 tensor-core peak, and q, k, v and o
    moved once. The library call is SDPA with ``is_causal`` where the
    window hides no key at the shape, else with the bool mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_mask,
                                                     flash_attention_cuda,
                                                     flash_attention_ref)

    def measure(i):
        what, B, Sq, Sk, H, KV, dh, win, off, dt = K7_CHECKS[i]
        q, k, v = attention_inputs(dev, i, B, Sq, Sk, H, KV, dh, dt)
        got = flash_attention_cuda(q, k, v, window=win, q_offset=off)
        want = flash_attention_ref(q, k, v, window=win, q_offset=off)
        torch.cuda.synchronize()
        err = held(got, want, TOL[dt], f"K7 at {what}")
        del got, want
        kernel = lambda: flash_attention_cuda(q, k, v, window=win,  # noqa
                                              q_offset=off)
        dev_ms = device_ms(kernel, "flash_kernel", reps=10)
        call_ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: flash_attention_ref(
            q, k, v, window=win, q_offset=off), reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if win is None or win > off + Sq - 1:      # the window hides nothing
            lib = lambda: F.scaled_dot_product_attention(  # noqa
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            m = _mask(Sq, Sk, True, win, off, dev)
            lib = lambda: F.scaled_dot_product_attention(  # noqa
                qt, kt, vt, attn_mask=m, enable_gqa=True)
        lib_ms = device_ms(lib, reps=10)
        lib_call = cuda_ms(lib)
        # the two without the profiler, in turns: lib, K7, K7, lib
        turns = [batch_ms(f) for f in (lib, kernel, kernel, lib)]
        pairs = int(_mask(Sq, Sk, True, win, off, dev).sum())
        flop = 4 * dh * H * B * pairs
        nbytes = (2 * B * Sq * H + 2 * B * Sk * KV) * dh * q.element_size()
        bound = max(flop / BF16_TENSOR_OPS_PER_S,
                    nbytes / HBM_BYTES_PER_S) * 1e3
        by = ("operations" if flop / BF16_TENSOR_OPS_PER_S
              >= nbytes / HBM_BYTES_PER_S else "bytes")
        row = {"shape": what, "instantiation": k7_instantiation(dt, dh),
               "ms": dev_ms, "call_ms": call_ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms, "library_call_ms": lib_call,
               "batch_ms": (turns[1] + turns[2]) / 2,
               "library_batch_ms": (turns[0] + turns[3]) / 2,
               "max_abs_err": err, "flop": flop, "bytes": nbytes,
               "tflop_per_s": flop / dev_ms / 1e9}
        log(json.dumps({"k7": row}))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        return row

    llama, gemma, danube = measure(0), measure(1), measure(4)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "launches": path_launches["flash_attention"],
            **{k: llama[k] for k in ("instantiation", "max_abs_err", "ms",
                                     "call_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "library_call_ms", "batch_ms",
                                     "library_batch_ms")},
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True); an explicit bool mask where the "
                       "window hides keys",
            "simt_source": "src/repro_torch/kernels/csrc/flash_attention.cu "
                           "(float32; bf16 at dh 16 and 32)",
            "shape": llama["shape"], "gemma3_local": gemma,
            "h2o_danube_prefill": danube}


def k8_bytes(B: int, L: int, D: int, N: int, in_size: int, y_size: int,
             states: int) -> int:
    """The bytes K8 must move: x and δ read and y written once a channel a
    step, B and C once a row a step, A once, and ``states`` (B, D, N)
    float32 tensors (h0, h_last) once."""
    return (2 * B * L * D * in_size + B * L * D * y_size
            + 2 * B * L * N * in_size + D * N * 4 + states * B * D * N * 4)


def sm_clock_hz() -> float:
    """The SM clock the bounds use: the data sheet's ``SM_CLOCK_HZ``, or
    the card's maximum SM clock by nvidia-smi where that is lower."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    try:
        return min(SM_CLOCK_HZ,
                   float(smi.stdout.strip().splitlines()[0]) * 1e6)
    except (IndexError, ValueError):
        return SM_CLOCK_HZ


def k8_ops(B: int, L: int, D: int, N: int) -> tuple:
    """K8's operations: (exps, FLOP). One exp(δ·A[d, n]) a (b, l, d, n);
    6 FLOP a (b, l, d, n) (δ·a, da·h, dx·B, their sum, h·C and its add
    into y) and 1 a (b, l, d) (δ·x)."""
    return B * L * D * N, 6 * B * L * D * N + B * L * D


def k8_bound(B: int, L: int, D: int, N: int, nbytes: int,
             clock_hz: float) -> dict:
    """K8's bound: the largest of its exps over the SFU's rate, its FLOP
    over ``FP32_OPS_PER_S`` and its bytes over ``HBM_BYTES_PER_S``, in ms,
    with the three beside it and what sets it."""
    exps, flop = k8_ops(B, L, D, N)
    ms = {"exps": exps / (SFU_EXPS_PER_CLOCK * SM_COUNT * clock_hz) * 1e3,
          "operations": flop / FP32_OPS_PER_S * 1e3,
          "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_set_by": by, "bound_exps_ms": ms["exps"],
            "bound_flop_ms": ms["operations"], "bound_bytes_ms": ms["bytes"],
            "exps": exps, "flop": flop, "bytes": nbytes,
            "sm_clock_hz": clock_hz}


def k8_times(dev, path_launches, f32_err: float) -> dict:
    """K8 at phase 4e's shape, every prefill layer of falcon-mamba-7b at
    B 4 × 2048: bf16 x, δ, B and C, float32 y and h_last (D 8192, N 16),
    bit-equal to its plain version. Beside it the earlier row: float32 in
    and out, B 2, no state, held at 1e-5. The bound is the largest of its
    exps, FLOP and bytes (:func:`k8_bound`)."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba1_scan_cuda, mamba1_scan_ref
    args = mamba_inputs(dev, "bfloat16", B=LM_BATCH, L=LM_PROMPT)
    B, L, D = args[0].shape
    N = args[4].shape[1]

    def kernel():
        return mamba1_scan_cuda(*args, return_state=True,
                                y_dtype=torch.float32)

    def plain():
        return mamba1_scan_ref(*args, return_state=True,
                               y_dtype=torch.float32)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max(bitwise(got[0], want[0], "K8 at phase 4e's shape"),
              bitwise(got[1], want[1], "K8 h_last at phase 4e's shape"))
    del got, want
    dev_ms = device_ms(kernel, "scan_kernel", reps=10)
    call_ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, reps=2)
    clock = sm_clock_hz()
    bound = k8_bound(B, L, D, N, k8_bytes(B, L, D, N, 2, 4, 1), clock)
    if dev_ms < bound["bound_ms"]:
        fail(f"K8 took {dev_ms} ms, under its bound of {bound['bound_ms']} "
             f"ms ({bound['bound_set_by']})")
    del args
    f32 = mamba_inputs(dev, "float32")
    fB, fL, _ = f32[0].shape
    f32_ms = device_ms(lambda: mamba1_scan_cuda(*f32), "scan_kernel",
                       reps=10)
    f32_call = cuda_ms(lambda: mamba1_scan_cuda(*f32))
    f32_plain = cuda_ms(lambda: mamba1_scan_ref(*f32), reps=2)
    f32_bound = k8_bound(fB, fL, D, N, k8_bytes(fB, fL, D, N, 4, 4, 0), clock)
    if f32_ms < f32_bound["bound_ms"]:
        fail(f"K8 float32 B 2 took {f32_ms} ms, under its bound of "
             f"{f32_bound['bound_ms']} ms")
    del f32
    torch.cuda.empty_cache()
    from repro_torch.kernels.mamba_scan import k8_layout
    log(json.dumps({"k8": {"B": B, "L": L, "D": D, "N": N, "ms": dev_ms,
                           "max_abs_err": err, "layout": k8_layout(),
                           **bound,
                           "share_of_bound": bound["bound_ms"] / dev_ms,
                           "exps_per_s": bound["exps"] / dev_ms * 1e3,
                           "gb_per_s": bound["bytes"] / dev_ms / 1e6,
                           "float32_b2_ms": f32_ms,
                           "float32_b2_share": f32_bound["bound_ms"] / f32_ms,
                           "float32_b2_bytes": f32_bound["bytes"]}}))
    return {"name": "mamba1_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:48",
            "launches": path_launches["mamba1_scan"], "max_abs_err": err,
            "ms": dev_ms, "call_ms": call_ms, "plain_ms": plain_ms,
            **{k: bound[k] for k in ("bound_ms", "bound_by", "bound_set_by",
                                     "bound_exps_ms", "bound_flop_ms",
                                     "bound_bytes_ms")},
            "library_ms": None,
            "library_note": "no PyTorch call computes a selective scan",
            "shape": "falcon-mamba-7b prefill layer: B 4, L 2048, D 8192, "
                     "N 16, bf16 in, float32 y and h_last",
            "float32_b2": {"shape": "B 2, L 2048, D 8192, N 16, float32, "
                                    "no state",
                           "ms": f32_ms, "call_ms": f32_call,
                           "plain_ms": f32_plain, "max_abs_err": f32_err,
                           **{k: f32_bound[k] for k in (
                               "bound_ms", "bound_by", "bound_set_by",
                               "bound_exps_ms", "bound_flop_ms",
                               "bound_bytes_ms")}}}


def simt_k7b(q, k, v, o, do, window):
    """The SIMT K7b (``csrc/flash_attention_bwd.cu``) on bf16 inputs at an
    SM90 width, launched through the library directly (the wrapper sends
    those to the tensor-core kernel): phase 5's earlier time of K7b."""
    import torch
    from repro_torch.kernels import _build
    B, S, H, dh = q.shape
    KV = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((B, S, H, 3), dtype=torch.float32, device=q.device)
    err = _build.library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), B, S, S, H, KV, dh, 1,
        0 if window is None else window, 0, 1, 1.0 / math.sqrt(dh),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd (SIMT)")
    return dq, dk, dv


def k7b_times(dev, train_launches, f32_err: float) -> dict:
    """K7b at h2o-danube-1.8b's training layer (B 4, S 2048, H 32, KV 8,
    dh 80, causal; its window of 4096 hides nothing at S 2048), bf16, o
    and lse from K7, with llama3-8b's and gemma3-4b's local layer
    (``K7B_CHECKS``) beside it. ``ms`` is the device time of a call's
    three launches (pre, main, post). The bound is the visible pairs' 5
    products of 2·dh FLOP at the bf16 tensor-core peak, or q, o, do, k, v
    and lse read and dq, dk and dv written once at the HBM rate. The
    library call is ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention`` (``is_causal`` where the window
    hides nothing, else the bool mask), its backward alone. At danube's
    shape the SIMT kernel's time on the same inputs is the row's earlier
    time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_mask,
                                                     flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda)

    def measure(i):
        what, B, S, H, KV, dh, win = K7B_CHECKS[i]
        q, k, v, do = backward_inputs(dev, 40 + i, B, S, H, KV, dh,
                                      "bfloat16")
        o, lse = flash_attention_cuda(q, k, v, window=win, return_lse=True)
        kernel = lambda: flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, o, do, lse, window=win)
        got = kernel()
        want = flash_attention_bwd_ref(q, k, v, o, do, lse, window=win)
        torch.cuda.synchronize()
        err = grads_held(got, want, "bfloat16", f"K7b at {what}")
        del got, want
        dev_ms = device_ms(kernel, reps=10)
        call_ms = cuda_ms(kernel, reps=5)
        row = {"shape": what, "max_abs_err": err, "ms": dev_ms,
               "call_ms": call_ms}
        if i == 0:
            row["plain_ms"] = cuda_ms(lambda: flash_attention_bwd_ref(
                q, k, v, o, do, lse, window=win), reps=2)
            simt = lambda: simt_k7b(q, k, v, o, do, win)  # noqa: E731
            row["simt_ms"] = device_ms(simt, "flash_bwd_kernel<", reps=3)
            row["simt_call_ms"] = cuda_ms(simt, reps=2)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        if win is None or win > S - 1:         # the window hides nothing
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        else:
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=_mask(S, S, True, win, 0, dev),
                enable_gqa=True)
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dot, retain_graph=True)
        row["library_ms"] = device_ms(lib, reps=10)
        row["library_call_ms"] = cuda_ms(lib, reps=5)
        # the two without the profiler, in turns: lib, K7b, K7b, lib
        turns = [batch_ms(f, reps=10) for f in (lib, kernel, kernel, lib)]
        row["batch_ms"] = (turns[1] + turns[2]) / 2
        row["library_batch_ms"] = (turns[0] + turns[3]) / 2
        pairs = int(_mask(S, S, True, win, 0, dev).sum())
        flop = 2 * dh * 5 * H * B * pairs
        nbytes = ((4 * B * S * H + 4 * B * S * KV) * dh * q.element_size()
                  + B * H * S * 4)
        f_ms = flop / BF16_TENSOR_OPS_PER_S * 1e3
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row.update({"bound_ms": max(f_ms, b_ms),
                    "bound_by": "operations" if f_ms >= b_ms else "bytes",
                    "flop": flop, "bytes": nbytes,
                    "tflop_per_s": flop / dev_ms / 1e9,
                    "share_of_bound": max(f_ms, b_ms) / dev_ms,
                    "faster_than_library": dev_ms < row["library_ms"]})
        log(json.dumps({"k7b": row}))
        del q, k, v, do, o, lse, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
        return row

    danube, llama, gemma = measure(0), measure(1), measure(2)
    if not danube["faster_than_library"]:
        log(f"K7b at danube's layer: {danube['ms']} ms, SDPA's backward "
            f"{danube['library_ms']} ms: not faster")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "replaces_note": "no TPU kernel: the JAX package differentiates "
                             "through flash_attention_pallas or its jnp loop "
                             "(models/layers.py:95-157); K7b is K7's gradient",
            "launches": train_launches["flash_attention_bwd"],
            **{k: danube[k] for k in ("max_abs_err", "ms", "call_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "library_call_ms",
                                      "batch_ms", "library_batch_ms",
                                      "simt_ms", "simt_call_ms", "flop",
                                      "bytes", "tflop_per_s",
                                      "share_of_bound")},
            "float32_max_abs_err": f32_err,
            "library": "torch.autograd.grad through F.scaled_dot_product_"
                       "attention(enable_gqa=True; is_causal, or the bool "
                       "mask where the window hides keys), the backward "
                       "alone",
            "simt_source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu "
                           "(float32; bf16 at dh 16 and 32); simt_ms: it on "
                           "this row's bf16 inputs",
            "shape": "h2o-danube-1.8b training layer: B 4, S 2048, H 32, "
                     "KV 8, dh 80, causal, bf16, lse from K7",
            "llama3_8b": llama, "gemma3_local": gemma}


def k8b_ops(B: int, L: int, D: int, N: int) -> tuple:
    """The operations K8's gradient needs, not those K8b's code does (it
    takes exp(δ·A) twice and the forward recurrence twice, to keep its
    stored states few): (exps, FLOP). One exp(δ·A[d, n]) a (b, l,
    d, n), as :func:`k8_ops` counts for K8; 19 FLOP a (b, l, d, n) (the
    forward recurrence's 4 once, the reverse step's 13, 2 in the sums of
    dB and dC over D) and 6 a (b, l, d) (δ·x twice, e·δ, e·x + Σ)."""
    return B * L * D * N, 19 * B * L * D * N + 6 * B * L * D


def k8b_bound(B: int, L: int, D: int, N: int, clock_hz: float) -> dict:
    """K8b's bound at bf16 in and float32 dy: the largest of its exps over
    the SFU's rate, its FLOP (:func:`k8b_ops`) and its bytes (x, δ, B, C,
    A and dy read, dx, dδ, dB, dC and dA written once), in ms, with the
    three beside it and what sets it."""
    exps, flop = k8b_ops(B, L, D, N)
    nbytes = (4 * B * L * D * 2 + B * L * D * 4 + 4 * B * L * N * 2
              + 2 * D * N * 4)
    ms = {"exps": exps / (SFU_EXPS_PER_CLOCK * SM_COUNT * clock_hz) * 1e3,
          "operations": flop / FP32_OPS_PER_S * 1e3,
          "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_set_by": by, "bound_exps_ms": ms["exps"],
            "bound_flop_ms": ms["operations"], "bound_bytes_ms": ms["bytes"],
            "exps": exps, "flop": flop, "bytes": nbytes,
            "sm_clock_hz": clock_hz}


def k8b_times(dev, train_launches, f32_err: float, clock_hz: float) -> dict:
    """K8b at falcon-mamba-7b's training layer (B 4, L 2048, D 8192, N
    16): bf16 x, δ, B and C, float32 dy, no initial state (the mixer's
    form). ``ms`` covers a call's two launches, ``kernel_ms`` the scan
    alone; its bound is :func:`k8b_bound`."""
    import torch
    from repro_torch.kernels.mamba_scan import (k8b_layout,
                                                mamba1_scan_bwd_cuda,
                                                mamba1_scan_bwd_ref)
    args = scan_backward_inputs(dev, "bfloat16")
    B, L, D = args[0].shape
    N = args[4].shape[1]
    kernel = lambda: mamba1_scan_bwd_cuda(*args)  # noqa: E731
    got, want = kernel(), mamba1_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    err = grads_held(got, want, "bfloat16", "K8b at falcon-mamba-7b's layer")
    del got, want
    dev_ms = device_ms(kernel, None, reps=5)
    kernel_ms = device_ms(kernel, "scan_bwd_kernel<", reps=5)
    call_ms = cuda_ms(kernel, reps=3)
    plain_ms = cuda_ms(lambda: mamba1_scan_bwd_ref(*args), reps=1)
    bound = k8b_bound(B, L, D, N, clock_hz)
    if dev_ms < bound["bound_ms"]:
        fail(f"K8b took {dev_ms} ms, under its bound of {bound['bound_ms']} "
             f"ms ({bound['bound_set_by']})")
    row = {"name": "mamba1_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
           "replaces": "src/repro/kernels/mamba_scan.py:48",
           "replaces_note": "no TPU kernel: mamba1_scan_pallas is "
                            "forward-only; K8b is K8's gradient",
           "launches": train_launches["mamba1_scan_bwd"],
           "max_abs_err": err, "float32_max_abs_err": f32_err,
           "ms": dev_ms, "kernel_ms": kernel_ms, "call_ms": call_ms,
           "plain_ms": plain_ms, **bound,
           "share_of_bound": bound["bound_ms"] / dev_ms,
           "layout": k8b_layout(), "decay": "ex2.approx.ftz of δ·(A·log2 e)",
           "library_ms": None,
           "library_note": "no PyTorch call computes a selective scan's "
                           "gradient",
           "shape": "falcon-mamba-7b training layer: B 4, L 2048, D 8192, "
                    "N 16, bf16 in, float32 dy, no h0"}
    log(json.dumps({"k8b": row}))
    del args
    torch.cuda.empty_cache()
    return row


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    dev = environment()
    from repro_torch.kernels import _build
    t = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        _build.build(verbose=True)   # ptxas' registers and spills
    print(report.getvalue(), end="", flush=True)
    no_wgmma_spills(report.getvalue())
    _build.library()
    log(f"build: {time.perf_counter() - t:.1f}s")
    check_k1(dev)
    check_k2(dev)
    check_k3(dev)
    check_k4(dev)
    check_k5_k6(dev)
    check_k7(dev)
    k8_err = check_k8(dev)
    (pg, path_launches, incremental_launches, serving_launches,
     checkpoint_launches, observability_launches, mesh_launches,
     failover_launches, sentinel_launches, plain_k4) = main_path(dev)
    lm_mesh_launches = dict.fromkeys(_build.launches, 0)
    for arch, op, key, piece in LM_PATHS:
        lm_path(dev, path_launches, arch, op, key, piece, lm_mesh_launches)
    check_tp8_shapes(dev)
    train_launches, k7b_err, k8b_err = training_phase(dev)
    kernels = kernel_times(dev, pg, path_launches, plain_k4)
    kernels["kernels"] += [k7_times(dev, path_launches),
                           k8_times(dev, path_launches, k8_err),
                           k7b_times(dev, train_launches, k7b_err),
                           k8b_times(dev, train_launches, k8b_err,
                                     sm_clock_hz())]
    for row in kernels["kernels"]:
        row["incremental_launches"] = incremental_launches[row["name"]]
        row["serving_launches"] = serving_launches[row["name"]]
        row["checkpoint_launches"] = checkpoint_launches[row["name"]]
        row["observability_launches"] = observability_launches[row["name"]]
        row["mesh_launches"] = mesh_launches[row["name"]]
        row["failover_launches"] = failover_launches[row["name"]]
        row["lm_mesh_launches"] = lm_mesh_launches[row["name"]]
        row["sentinel_launches"] = sentinel_launches[row["name"]]
        row["train_launches"] = train_launches[row["name"]]
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
