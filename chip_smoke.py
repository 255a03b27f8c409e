#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``svoc_torch``) on one NVIDIA GPU and check it.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

or with ``--parent DIR``, a checkout of another commit, to time its B6,
its wrappers' host cost, its B3 and its threefry in the same run (phases
1b, 3b and 3c).

Phases:

1. Environment: the card's name and power limit, the torch and CUDA
   versions, the build of every CUDA kernel from ``svoc_torch/csrc``
   (one ``nvcc`` per source, all at once, into ``svoc_torch/_build``)
   and of the native host runtime (``svoc_torch/runtime``, ``g++``),
   each with its time.
1b. The gridded block-copy kernel against its plain version and its
   input, bit for bit: the probe's shape ([4, 256, 128] float32, blocks
   (1, 128, 128), grid (4, 2, 1)), [64, 8192, 128] float32 (256 MiB each
   way, NaNs and -0.0 among its words), a (1, 64, 128) block (grid (4,
   4, 1)), bf16, a tile whose unrolled rounds end part full, a narrow
   block on the scalar path, two refusals; times by CUDA events beside
   ``x.clone()`` and the bound ``2 * bytes / 3.35 TB/s`` at both shapes,
   and the host µs per call of every kernel wrapper and of ``x.clone()``
   (the median of 20 rounds of 50 calls, no synchronise), with B6's
   split into checks, allocation, launch helper and ctypes call; with
   ``--parent DIR``, the same for the tree in DIR, between two readings
   of this tree's.
2. The flash-attention kernel against its plain PyTorch version: the
   flagship shape [256, 128, 12, 64] in bf16 with segment ids from a real
   packed batch (3e-2), the per-key mask mode, float32 at every head width
   (2e-5, the CUDA-core body), bf16 at every head width with T = 1, 77 and
   1000 in both mask modes (the tensor-core body: 3e-2, lse 1e-3, two
   launches bit for bit equal), dead rows (exactly 0 and lse -inf), the
   lse, and T = 1000 as one segment and in runs of 50 tokens; the share
   of 64 x 64 tile pairs that a tag-range skip would save at the flagship
   (the kernels visit every tile). Times by CUDA events at the flagship
   shape and at flash_probe's four shapes beside SDPA and the bound (B1
   twice at each, before and after SDPA).
2b. The flash backward kernels (dq, and dk with dv) against the plain
   backward's fp32 result on the same inputs: the flagship shape in
   bf16 with segment ids from a real packed batch (3e-2, plus one bf16
   rounding of the kernel's output), the per-key mask mode with a fully
   masked row, float32 at every head width with T = 77 (1e-4), bf16 at
   every head width with T = 1, 77 and 1000 in both mask modes (dq, dk
   and dv of two launches bit for bit equal), T = 1000 as one segment
   and in runs of 50 tokens, and exact zeros for padding queries and
   dead keys; then their times beside the plain backward's and SDPA's
   backward under the same boolean mask, and at flash_probe's four
   shapes beside SDPA's backward and the bounds (``backward_times``;
   dq's CUDA-core times from before its tensor-core body beside).
2c. Flash against dense attention, in-process through
   ``svoc_torch.tools.flash_probe``: the numerics adjudication
   (``parity_only``: both bf16 results against a float32-truth dense
   attention; the verdict must be ``rounding-equivalent``) and the timed
   runs (``main``) at (B, T) = (256, 128), (8, 512), (8, 2048), (2, 8192)
   with 12 heads of 64 in bf16, forward and backward, with each side's
   peak device memory; SDPA under the same all-ones key mask is timed
   beside them by the same protocol (yardstick only).
3. The fused-consensus kernel against its plain version: N = 1024, M = 6,
   n_failing = 128, constrained and unconstrained, three tie-heavy fleets
   (quantised to 1e-2, every row equal, -0.0 and +0.0 mixed), N = 7 and
   N = 1000. The reliable mask exact; essence, risk and reliabilities
   within 1e-5; skewness within 1e-4; kurtosis within 1e-3. Its time at
   N = 1024 by CUDA events over 200 launches and by the profiler's
   device time of one launch (informational).
3b. The gated claim-cube kernel against its plain version: the
   ``bench.py --claims 64 --claims-oracles 1024`` cube ([64, 1024, 6],
   n_failing 256, every eighth claim's last oracle quarantined), the
   degenerate spectrum (a clean claim, a partly quarantined claim with a
   NaN row, an all-quarantined claim, a single survivor, padding claims
   from 3 -> 4) at N = 1024 and N = 7, a cube quantised to 1e-2 (ties) and
   an unconstrained cube. The reliable mask and interval_valid exact;
   essences, reliabilities and finite risks within 1e-5, infinite risks
   equal; skewness within 1e-4; kurtosis within 1e-3. Two refusals (a
   smooth_mode "true" config, a fleet beyond shared memory), and the
   largest fleet the kernel's layout takes at M = 6 (at least the 4635
   of its first version). Times at [64, 1024, 6]: the kernel by CUDA
   events over 50 launches and by the profiler's device time of one
   launch (with ``--parent DIR``, the tree in DIR's between two readings
   of this tree's), the plain version, the bound, and 64 sequential
   one-claim launches against one batched launch (claims/s).
3c. The threefry kernel against its plain version, bit for bit: one key
   over 2**20 counters (bits and pairs), 1024 and 57344 keys (phase 6's
   largest launch before the fleet-draws kernel), counters that cross
   into the high word, a base per key; the draws (``PRNGKey``, ``split``,
   ``fold_in``, ``uniform``, ``permutation`` in one and two rounds,
   ``choice``) against known answers of ``jax.random`` under jax 0.9.0
   kept as literals. The fleet-draws kernel against its plain version
   (the composed draws, on the card and on the CPU), bit for bit: the
   flagship's fleet, phase 6's 64 claims, N = 2048 (two shuffle rounds),
   no failing oracle, subsets as large as the window; ``draw_fleet`` on
   the card is one fleet-draws launch and no threefry launch. Times by
   CUDA events and by the profiler's device time of one launch, beside
   the plain versions and the bounds: threefry at [57344 keys, 64
   counters] (with ``--parent DIR``, the tree in DIR's between two
   readings of this tree's), the fleet draws at the flagship's fleet
   and at 64 claims (the plain version there is the composed path it
   replaces); threefry also at the shapes the paths launch it with (a
   ``fold_in``, a split of 64 claim keys, 2**20 bits of a generator's
   draw), each with the parent's when ``--parent`` is given; the built
   threefry kernel's SHFs and LOP3s held to ``THREEFRY_INT_OPS``.
4. The serving step: first a small float32 step on the card against the
   same step on the CPU (the plain versions the CPU tests hold against the
   JAX package), for each of the three flagship variants; then the main
   path at full width, ROBERTA_GO_EMOTIONS
   with bf16 weights, 256 packed rows of 128 tokens with up to 8 comments,
   a 50-comment window, 1024 oracles, subsets of 10, the fleet keyed by
   the reference's chain (``PRNGKey(0)``, ``key = fold_in(key, step)``).
   It runs twice on the same comments, the two runs taking turns step
   by step: with the serial native feed (tokenize, pack and copy on the
   caller's thread, each timed) and with the feed overlapped in its
   worker process (``FlagshipStep.comments``, each batch copied as it is
   taken), one warm-up and 24 timed steps each;
   each prints comments/s on the wall clock beside the step alone. The
   two runs give the same essences step for step, the overlapped
   batches equal the serial Python feed's bit for bit, and the
   forward's mean CUDA-event time with the feed running stays within
   the serial readings' mean plus their spread (the gap between their
   halves, at least 5 % of their mean).
   Every kernel's launch count is set to 0 just before the main path
   and read just after it (1 threefry launch, the step's ``fold_in``, and
   1 fleet-draws launch a step); the backward
   kernels must launch 0 times there. One more step then runs under
   ``torch.profiler`` for a breakdown of device time
   (informational: it cannot fail the run). Then (4c) the other two
   flagship variants at the same full width, ``packed`` (packed rows,
   dense attention) and ``dense`` (256 unpacked comments, dense
   attention): one warm-up and five timed steps each on distinct batches,
   0 flash launches and 1 fused-consensus launch a step, and the same
   for ``packed_int8`` (``bench.py --config 10``: ``packed`` with the
   W8A8 forward, folded from the seed-0 float32 weights, on the batches
   that follow ``packed``'s from the same feed); on one shared
   set of 256 comments the per-comment vectors of the three float
   variants agree (5e-3 in bf16), and the int8 variant's logits and
   vectors meet the reference's bars against ``packed``'s (0.15
   max(1, |ref|) and 0.05).
   Then (4d) the pipelined twin of 4b (``FlagshipStep.pipelined``, the
   reference's default loop): 4b's step, comments, key chain and
   overlapped feed; a priming forward of batch 0, 24 steps each
   running the forward of batch k on the caller's stream beside the
   fleet and consensus of batch k-1 on the step's second stream, then
   the drain. Its essences and second-pass reliabilities equal 4b's
   overlapped run, step for step, one step later, bit for bit; 12 flash,
   1 B2, 1 threefry and 1 fleet-draws launch a step, 1 B2 and 1 fleet
   draws for the drain; the side stream's path makes no host sync
   (``torch.cuda.set_sync_debug_mode``). It prints the step and
   comments/s on the wall clock beside 4b's, the forward's CUDA-event
   time with the side stream busy, and one profiled step's idle share
   beside 4b's (informational).
5. The fine-tune step: first a small float32 step on the card against
   the same step on the CPU (one SGD(0.1) and one AdamW step, TINY_TEST,
   the same packed batch); then the training path at full width,
   ROBERTA_GO_EMOTIONS with float32 master parameters and bf16
   compute, AdamW(1e-4), 256 packed rows of 128 tokens with up to 8
   comments and seeded multi-hot labels: one warm-up step, five timed
   steps on distinct batches, ten steps on one fixed batch, with the
   launch counts set to 0 before and read after; every parameter must
   move, including the 36 query, key and value projections, the loss on
   the fixed batch must fall, and a saved and restored state must equal
   the original. One profiled step follows (informational). Then (5c)
   the twin of ``tools/finetune_demo.py`` (``svoc_torch.tools.finetune_demo``)
   on a ``data(4) x model(2)`` mesh of slots of cuda:0: TINY_TEST with
   flash, the reference's CLI defaults (240 steps of 32, AdamW(3e-3),
   target macro-F1 0.9), a checkpoint at step 120, a same-mesh replay of
   the rest and a restore onto ``data(2) x model(4)`` with 5 more steps:
   macro-F1 >= 0.9, replay and restore deltas of exactly 0.0, and 2 x 8
   B1, B4 and B5 launches a train step (2 B1 an unsharded evaluation);
   then at ROBERTA_GO_EMOTIONS width (bf16 matmuls, flash, batch 32, the
   same task; cut: 10 steps) the loss must fall and stay finite, both
   deltas 0.0, and the F1, the step's ms and trained comments/s are printed.
6. The multi-claim serving step at full width: 64 claims of 1024
   oracles (128 failing, constrained), ROBERTA_GO_EMOTIONS with bf16
   weights; each step takes 8 new comments per claim (512), assembled
   round-robin into one packed forward of 256 rows of 128 tokens with up
   to 8 comments, then per-claim windows (8 -> 50 rows) and fleets, the
   in-graph quarantine gate and one gated claim-cube launch. The last
   claim's oracle 1023 is tampered in rotation by the fabric scenario's
   hook in its numpy form, which gets the block on the host as float64
   (a NaN component, an inf row, a 7.5 row; the first step clean).
   Eight steps, the last five timed, with every kernel's launch count
   set to 0 before and read after: 12 flash and 1 claim-cube launch a
   step, 1 threefry launch (the fed claims' keys split at once) and 1
   fleet-draws launch (one batched fleet build), no other. The offender's slot is
   quarantined (the host gate agrees, with its
   reason) and it still reports a finite consensus over 1023 oracles;
   a second run without the tamper gives the 63 other claims' outputs
   bit for bit; one step's cube through the plain path meets the 3b
   bars; essences differ across claims and steps. The device operations
   of one ``fleets()`` call are counted by the profiler, and one more
   step runs under it (informational). Last, one batched fleet build of
   64 claims equals 64 one-claim builds bit for bit, and both are timed.
7. The probe path: ``svoc_torch.tools.probe.main`` through its normal
   entry, each probe in its own interpreter under a timeout: six records
   (``backend``, ``grid_copy``, ``consensus1024`` without the tool's
   bisect below it, ``flash512``, ``encoder512_dense``,
   ``encoder512_flash``; three interpreters at a time after ``backend``,
   so a probe's times are read beside others'), every one
   ok, with ``correct``, ``essence_match`` and ``match_dense`` true and
   ``GPU_PROBE.json`` readable. Each record carries the launch counts of
   its own interpreter (set to 0 by its start, read at its end): the
   grid-copy kernel must have launched in ``grid_copy``, the flash kernel
   12 times a forward in ``encoder512_flash`` and never in
   ``encoder512_dense``. A probe that fails or times out fails the run.
8. The commit path (``ops/fixedpoint.py``, ``consensus/wsad_engine.py``,
   ``consensus/state.py``, ``io/chain.py``). (a) Two flagship steps at
   full width (phase 4b's weights and key chain, the serial native feed):
   each step's 1024-oracle fleet (128 failing) from ``window``, ``draws``
   and ``assemble_fleet``, B2 for the float consensus, one fetch, then
   ``ChainAdapter(LocalChainBackend(OracleConsensusContract(3 admins,
   1024 oracles, n_failing 128, constrained, M = 6, device="cuda")))
   .update_all_the_predictions``: the activation cycle, then a full
   cycle. Each cycle prints the smallest reliable-subset variance of the
   committed ints (wsad units), then its route (certified, or the
   ``BatchNotCertified`` reason and the per-tx fall-through), seconds,
   golden recomputes, the sweep's K, its CUDA-event time and how many
   prefixes fall inside each guard band. The on-chain state must equal
   ``two_pass_consensus`` on the committed ints (or both raise the same
   panic at the failed tx), the essence be within 2e-6 of B2's and the
   reliable flags equal B2's mask; flash 12, B2 1, threefry 1 and
   fleet draws 1 a step, counted from 0 over the two steps. (b) The 64-oracle
   twins of ``tests/test_batch_commit.py`` (seed 5, two cycles), batched
   with the sweep on the card against the per-tx loop: identical state,
   the certified path taken (one sweep of K = 64 on CUDA, no fallback);
   the sweep at K = N = 1024 on two seeded uniform fleets, timed by CUDA
   events, against the same sweep on the CPU (``certify``'s booleans
   identical, the margins within 1e-5 and 1e-6), with the prefixes it
   rejects. (c) ``bench.py``'s config 5: 7 oracles (2 failing,
   ``strict_interval=False``), one signed tx per oracle after each
   full-width forward, ten timed steps after a warm-up: comments/s with
   the submit, submit ms a step, reverted txs and the consensus read
   back.
9. The claim fabric (``apps/session.py``, ``fabric/*``, ``resilience/*``,
   ``utils/{events,slo}.py``), through its entry points. (a) B3 against
   its plain version at the fabric's shapes, [4, 7, 6] with the
   offender's quarantined inf row and [64, 7, 6] (37 claims and 27
   padding claims, quarantined nan, inf and 7.5 rows), to the 3b bars,
   and its reliable mask and interval_valid equal to the CPU route's;
   then ``run_fabric_scenario(0, cycles=12)`` (4 claims x 7 oracles, the
   last claim tampered) on the card twice and pipelined once: per-claim
   and journal fingerprints equal to the JAX package's (the constants
   of ``svoc_torch.tools.fabric_smoke``) and across the two runs, the
   offender voted out, the siblings clean, 7 injections, 4 claims served
   every cycle, B3 launched once a cycle, threefry and the fleet draws
   once a fetch,
   counted from 0 for each run. (b) One ``MultiSession`` of 64 claims x
   7 oracles (2 failing), each with its own store of 120 synthetic
   comments, sharing the ``Session``'s default vectorizer
   (ROBERTA_GO_EMOTIONS, packed, dense, seeded weights) with its output
   layer calibrated (``calibrate_head``), the last claim tampered on the
   scenario's schedule, 6 cycles of one group, twice with fresh journals
   and registries: per-claim fingerprints equal across the runs, the
   offender's injections refused and charged and 0x16 voted out, no
   refusing verdict or quarantine charge on any sibling, B3 once a cycle
   at [64, 7, 6], threefry and the fleet draws once a fetch; a cycle's
   time split
   (fetch: vectorize, fleet, host sync; the fabric consensus; the commit
   plane), comments vectorized a second, the commit routes and peak
   device memory, and the group's consensus by CUDA events. (c) One
   ``Session`` with its own default vectorizer: 8 fetches at the init's
   scale report each block's smallest honest variance and whether the
   golden recompute panics; then, calibrated, 10 cycles of ``fetch``,
   ``commit_resilient`` and ``supervisor_step``, the chain state equal
   to the golden engine's after each, threefry and the fleet draws once
   a fetch.
   (d) 9b's fabric three more times: with resident staging
   (``device_resident=True``) serial, unstaged pipelined and staged
   pipelined: the staged runs' per-claim fingerprints equal the unstaged
   runs' of their mode, one staging record in pinned memory, every
   dispatch keyed ``donate``; the fabric consensus (stage, h2d, dispatch,
   sync) and the caching allocator's allocations a cycle, staging off and
   on. (e) The twin of ``tools/hotpath_smoke.py`` on CUDA: its six checks
   and the JAX package's seed-0 fingerprints.
10. The serving tier (``serving/*``, ``obsplane/*``). (a)
   ``run_serving_scenario(0)`` (3 claims x 7 oracles, warm, overload and
   recovery phases, the deterministic vectorizer) on the card, twice with
   the cost plane on and twice with it off: the smoke's gates pass, and
   the journal and per-claim fingerprints equal the same run's on the
   CPU in this process and the JAX package's (the constants of
   ``svoc_torch.tools.serving_smoke``); B3 once a serving step that
   served a claim, threefry and the fleet draws once a claim served.
   (b) One
   ``ServingTier`` over 64 claims x 7 oracles (2 failing), sanitised
   dispatch and batched commits, the vectorizer one shared packed
   ROBERTA_GO_EMOTIONS ``SentimentPipeline`` with flash attention and
   bf16 weights (256 rows of 128 tokens, up to 8 comments a row), its
   output layer calibrated (``calibrate_head``), the last claim tampered
   on 9b's schedule. Each step submits 8 arrivals a claim (512), 35 %
   from a hot pool of 10 texts, with ``max_requests_per_step`` 512 and
   a queue that admits them all; one warm-up and ten timed steps on the
   real clock. Checks: 12 flash launches for each 256-row chunk of the
   cross-claim forward, exactly 1 claim-cube launch and 0 B2 a step;
   every served claim's essence finite; cache hits; nothing shed or
   dropped; the offender's injections refused and charged, no sibling
   charged. It prints a step's split (assemble, vectorize with the
   forward's CUDA-event time, the claims' fetch, the fabric consensus,
   the commit plane), requests/s, the request latency's p50 and p99,
   the cache hit rate, the ``packing_fill_ratio`` gauges and peak device
   memory, and the comments vectorized a second beside 9b's.
11. The durability plane (``durability/*``, ``resilience/{faults,chaos}.py``,
   ``utils/{checkpoint,postmortem}.py``). (a) ``run_chaos_scenario(4)``
   twice: the chaos smoke's checks and the JAX package's fingerprint
   (host work). (b) ``svoc_torch.tools.crash_smoke`` with every child on
   CUDA: five kill legs (a torn WAL intent, a kill between a tx and its
   landed record, a kill before a snapshot, a kill mid-way through a
   batched commit's log, and a second kill during recovery), two matrix
   runs side by side in waves of child processes, each forked from a
   fork server that imported torch and never initialised CUDA; zero
   duplicate txs, zero unknown
   and unaccounted WAL slots and requests, zero open cycles, each leg's
   point in its fired log, identical recovered fingerprints across the
   runs, and every leg's recovered per-claim fingerprints equal to the
   JAX package's (the constants of the tool); then one uninterrupted
   ``run_durable_scenario(0)`` in this process on the card, against the
   same run on the CPU, with B3 once a step that served a claim,
   threefry and the fleet draws once a claim served. (c) 10b's tier made durable, at the
   fleet phases' 30 s latency target: a
   ``CommitIntentWAL``, a ``DurableLocalBackend`` chain log for each of
   the 64 claims, ``RecoveryManager`` snapshots every 2 steps and the
   journal's trace fsynced on every event; a first child process
   (``chip_smoke.py --durable-child DIR crash``) is SIGKILLed at the
   228th ``chain.batch.mid_fleet`` firing of step 4 (mid-way through
   the 33rd claim's batch) or, where claims commit per tx, at the 116th
   ``chainlog.tx.post_fsync`` firing, whichever comes first; a second
   (``... recover``) recovers and runs
   to step 6 (cut: steps only). Checks: the kill where it was scheduled;
   the invariants of (b) over all 64 chain logs; one open cycle whose
   durable prefix is landed and whose suffix alone is resent; 12 flash
   launches a forward, B3 once a step, threefry and the fleet draws
   once a claim served, in both children. It prints the step with durability on beside 10b's,
   the fsyncs a step and their time, the WAL records a step, each
   snapshot's ms and bytes, and the recovery's seconds split into the
   chain-log replay, the snapshot restore, the journal roll-forward and
   the WAL reconcile.

12. Cold start (``compile/*``, ``obsplane/profiler.py``, the runtime end
   of ``utils/metrics.py``). (a) ``svoc_torch.tools.coldstart_smoke`` with
   every child on CUDA and its kernel cache under a fresh temporary
   directory: ``control`` beside ``warm_first`` (the persistent cache, a
   synchronous prewarm, then SIGKILLed), then ``warm_restart``; the
   fingerprints of the three legs equal the JAX package's (the tool's
   constants), the first warm leg builds, the restart builds nothing and
   loads from the cache, and this process builds nothing into it. (b)
   10b's tier (every arrival a fresh text) with
   ``RecoveryManager(compilation_cache="persistent")`` on one fresh
   durable directory, in two children (``chip_smoke.py --coldstart-child
   DIR ROLE T``): ``cold`` (an empty cache, no prewarm, 3 steps, a
   snapshot, a SIGKILL) and ``warm`` (``recover(prewarm=True)`` before its
   first forward, steps 4-6). It prints each child's seconds from its start to its first
   served step, the first step's ms beside the steady step's, the builds
   and their seconds, the cache hits, the prewarm walk and
   ``consensus_dispatch{warmth=}``; checks: the restart builds nothing,
   and after its recovery loads nothing either (its prewarm loaded every
   library its forward, fetch and consensus launch), its walk's outcomes are ``compiled`` or ``primed``, its first dispatch
   counts ``prewarmed``, no ``compile_cache_errors``, 12 B1 launches a
   forward and B3 once a step, and its per-claim consensus equals an
   uninterrupted 6-step run's in this process. (c) ``ProfileCapture``
   around one more step of that run: the Chrome trace exists and its
   device operations name the flash, B3, threefry and fleet-draws
   kernels (the top
   five by device time printed); ``sample_runtime_gauges`` reads a
   nonzero ``device_live_bytes`` for ``cuda:0``; ``set_mfu_gauge`` on
   4b's forward (``bench.py``'s FLOP model against 989 TFLOP/s).
13. The multi-replica fleet (``cluster/*``, ``obsplane/{fleet,hopchain,
   anomaly}.py``, ``utils/slo.py::fleet_slos``). (a)
   ``svoc_torch.tools.cluster_smoke`` on CUDA at seed 0 (3 replicas, 6
   claims, 10 steps, r1 killed at step 4 and failed over at 6, one
   injected forwarding fault): the reference's 13 checks, the per-claim
   and fleet fingerprints equal the JAX package's (the tool's
   constants), no ``forward_error`` shed, and B3 once a replica step
   that served, threefry and the fleet draws once a claim served. (b)
   ``svoc_torch.tools.fleet_obs_smoke`` on CUDA at seed 0: the
   reference's 10 checks and its fingerprint, and the sustained
   anomaly's ``torch.profiler`` trace holds the card's kernels. (c) A
   fleet at full width: 3 replicas over one shared chain directory, 64
   claims x 7 oracles placed by rendezvous (one tampered offender), each
   replica 10b's tier (queues of 64, a 30 s latency target, 512 requests and 64 claims a step,
   batched commits, snapshots every 2 steps, the fsynced trace, its
   WAL), all sharing one packed calibrated flash bf16 pipeline through a
   ``Replica`` subclass defined here; 512 arrivals a cluster step (35 %
   from a hot pool of 10) for 10 steps; at step 3 r1's claims are
   filled to their queues' capacity, so that the snapshot after r1's
   step holds a backlog; r1 is killed at step 4, after the step's
   submits and before its ``step_all``, through ``replica.kill``, and
   failed over at 6; one operator migration at 8; the fleet plane on
   (cut: steps only). It prints each step's ms split by replica into
   forward, fetches, fabric consensus and commit plane, requests/s over
   the whole window (submits, steps, failover and migration; over the
   steps alone beside it), latency p50/p99 before the kill, in the outage and after
   the failover, the outage's sheds by reason, fsyncs a step,
   ``fail_over``'s seconds by part (the recovery: stack build, chain-log
   replay, snapshot restore, roll-forward, WAL reconcile; each claim's
   drain, ship and adopt), the migration's ms and peak memory; checks:
   zero duplicate txs, zero unaccounted admitted requests, a recovered
   backlog whose every request the failover's drains answer or defer,
   every failed-over claim adopted with continuity and its chain growing, no
   claim on r1, the epoch advanced, every shed typed, counted and
   journaled, no ``forward_error`` shed, hop chains fully classified,
   the merged exposition equal to the scrapes' sum (before the kill),
   12 flash launches a forward, B3 once a dispatched group, threefry and
   the fleet draws once a claim served. (d) The same 64 claims and 512 arrivals for 2 steps (cut from 4)
   with no kill, on 1 and on 3 replicas: requests/s over the whole
   window (submits and steps; over the steps alone beside it) and step
   ms of each (the ratio is read, not demanded), with (c)'s invariants.
14. Live reconfiguration and the fault-space fuzzer (``cluster/reconfig.py``,
   ``cluster/reconfig_scenario.py``, ``durability/fuzz.py``). (a)
   ``svoc_torch.tools.reconfig_smoke`` on CUDA at seed 0 (a committed
   rolling re-pin twice, 3 replicas x 6 claims, ``commit_mode="batched"``
   and ``c0`` re-specced to 9 oracles at step 4; one abort run per
   ``reconfig.*`` point against its baseline): the reference's 18 checks,
   the committed run's and the abort baselines' fingerprints equal the JAX
   package's (the tool's constants), no probe shed, all five points fired,
   B3 once a dispatched group plus one a group PREPARE primed, threefry
   and the fleet draws once a claim served; the seconds of each run. (b)
   ``svoc_torch.tools.chaos_fuzz`` at its default 32 seeds, each rerun,
   ``FUZZ_JOBS`` jobs, its children on CUDA forked from the fork server, and
   the felt soak, and beside them every tier-1 corpus entry twice with
   spawned children: every one of the tool's checks
   (``seeds_explored_at_least_32`` included), every recovered fingerprint
   the JAX package's (the tool's constants); a surviving child's start
   split into the interpreter, torch's import, the port's imports (or the
   fork), CUDA's initialisation and the workload, spawned beside forked.
   (c) 13c's fleet with no kill for 9 steps (cut from 10): after step 3 the smoke's
   plan aborted by an ``error`` at ``reconfig.pre_resume`` (every replica
   has built its new stack) with no traffic; after step 4 the same abort
   with one arrival a claim at every stage boundary; after step 6 the
   same plan committed, rolling, with the arrivals; then a second fleet
   through step 5, the never-attempted baseline, that attempts nothing at
   3 and replays the second abort's holds, arrivals, flushes and release
   at 4. It prints each apply's seconds by phase and replica (prepare
   with its keys, builds, hits and primed groups; drain, ship, re-pin;
   resume), the stack builds, the commit's, the rollback's and the
   release's seconds, the deferred requests and how long each was held,
   requests/s over the whole window and over ``step_all``, latency
   before, during and after the commit, and the dispatch warmth; checks:
   the abort with no traffic leaves the fleet fingerprint, the journals,
   the accounting and the epoch as they were and no epoch file; the abort
   under traffic drops nothing, releases its deferred requests into the
   old stacks in arrival order, and equals the baseline in every
   per-claim fingerprint and the router's snapshot after steps 3, 4 and
   5; the commit re-pins every replica under epoch 1, every claim with
   continuity, the re-specced one carried; every deferred request
   released in arrival order; zero shed, duplicate txs and unaccounted
   requests; every re-pinned stack's first dispatches ``prewarmed``;
   13c's launch counts with the three primes.
15. The flight-recorder and cost-plane gates, the certificate and the
   estimator sweeps (``tools/{obs_smoke,obs_cost_smoke,robustness_cert}.py``,
   ``sim/{montecarlo,multimodal}.py``, ``robustness/certify.py``). (a)
   both obs twins on CUDA at seed 0: every check, the JAX package's
   journal fingerprints, a journal emit's and a span's µs. (b)
   ``robustness_cert`` in full mode on CUDA: its 10 checks and the
   reference's certificates. (c) ``fleet_breakdown_curve`` at its
   defaults (1024 oracles, one [100, 1024, 6] B3 launch a fraction, the
   cliff at N/2), an 80-cell constrained ``breakdown_sweep`` of [64,
   1024, 6] cubes and ``benchmark_multimodal`` at its defaults, each on
   the card, under the profiler and as its plain version on the host's
   CPU; B3 against its plain version on the sweep's cube at the
   consensus bars; B3's, threefry's and the fleet draws' launches
   counted.
16. The operator console (``apps/{commands,cli,web}.py``). (a) A
   ``CommandConsole`` over a CUDA ``Session`` at its defaults with 9b's
   fabric, a 10b-shaped tier (flash) and the profiler attached: a script
   through every command family, no ``error:`` line, each command's wall
   ms; threefry, the fleet draws, B1 and B3 counted. (b) ``python -m svoc_torch.apps.cli
   --int8`` in a child, a script on its standard input: exit 0, no
   ``error:`` line, its start split (torch's import, the port's imports,
   the session and resume, the first fetch, the fold's span). (c)
   ``serve(console)`` on port 0 of the loopback: query, state, one SSE
   frame, metrics and submit, each with its code.

17. The mesh (``parallel/{mesh,sharded,claim_shard,serving}.py``), every mesh
   slots of cuda:0: (a) the twin of ``tools/shard_smoke.py`` (4 claims x 8
   oracles, 10 cycles, twice at ``"2x4"`` and once unmeshed): its checks,
   the JAX package's seed-0 fingerprints, B3 once a claim shard (2 a
   meshed dispatch, the oracle-axis slots sharing its result, 1
   unmeshed); (b) the claim-sharded dispatch of the [64, 1024, 6] cube on
   ``"2x1"``, ``"4x2"`` and ``"8x1"``: every output ``array_equal``
   (NaN-aware) to the unsharded B3 dispatch, B3 once a claim shard, each
   dispatch's time by CUDA events beside the unsharded one's (in turns);
   (c) ``sharded_fleet_claims_fn`` at [64, 1024, 6] on ``"1x1"``,
   ``"2x4"`` and ``"8x1"``: every output bitwise the unsharded fleet's
   consensus, B3 once a slot; (d) the data-parallel packed serving step
   at full width (flash, bf16, 256 x 128 rows, 1024 oracles, 128
   failing) on a ``data`` mesh of 2 slots against 1: window vectors
   within 3e-2, the masks equal, one window's consensus (the drain
   step's) on 2 slots within ``tests/test_parallel.py``'s bars of 1
   slot's, B1 12 x slots a forward, comments/s of both (read, not
   demanded). It prints its seconds.
18. The training and sequence paths on the mesh
   (``parallel/{ring_attention,sp_encoder,pipeline}.py``, the mesh
   factories of ``train/trainer.py``), every mesh slots of cuda:0: (a)
   ring attention on q, k, v [2, 8192, 12, 64] bf16 over 8 ``seq`` slots
   (1024 keys a hop; row 1's 3000 real keys leave shards 3-7 all
   padding), the flash inner (B1 with ``return_lse`` once a hop, 64 a
   call) and the dense inner against each other and against B1 over the
   whole sequence (3e-2); B1 at the hop against its plain version with
   the all-padding hop (output 0, lse -inf); B1's time at the hop beside
   its plain version, SDPA and the bound. (b) The sequence-parallel
   forward of ROBERTA_GO_EMOTIONS (bf16) on ids [8, 512] of mixed
   lengths, dense and flash inner (768 B1 a flash forward), against the
   unsharded forward. (c) ``make_sp_train_step`` at full width in
   float32 (dense), 3 SGD steps on (b)'s batch against the unsharded
   step at ``tests/test_train.py``'s SP bars. (d) ``pipeline_forward_fn``
   on stage(4) x data(2), 4 microbatches, flash, ids [32, 128] (96 B1, the
   bubbles skipped) against the unsharded forward. (e)
   ``make_sharded_packed_train_step`` on data(4) x model(2), flash and
   AdamW, on phase 5b's packed batches of 256 x 128 rows: 3 steps, then 3
   under ZeRO-1, each against the unsharded packed step, B1, B4 and B5 96
   a step (8 slots x 12 layers, 6 heads a shard), every moment at most 1/4
   on a slot under ZeRO-1; B4 and B5 on a 6-head shard against their
   plain backward. (f) The fine-tune twin at its reference defaults
   (TINY, dense) on 4x2 slots, with and without ``--zero1``. Bars that
   the reference does not give: ``MESH_LOGIT_BAR`` and ``TP_*`` below.
19. The lint gate on the card's host (``svoc_torch/analysis``): ``python
   -m svoc_torch.tools.svoclint --format json`` in a child, its cache in
   a temporary directory, must exit 0 with no new finding and no stale
   baseline entry; then the port's analyzer over the reference's
   ``svoc_tpu tools``, with the reference's ``tools/svoclint_baseline.json``
   read in place, must give the reference analyzer's files, findings by
   rule, suppressions and baselined findings (``REFERENCE_LINT``,
   computed with the JAX package's analyzer).  No JAX and no torch is
   needed to lint; the phase prints its seconds beside the card's name
   and power limit.
20. BASELINE configs 1-4 (``bench.py``'s ``bench_config1``-``bench_config4``)
   through ``svoc_torch.tools.baseline_configs`` at full width: (a)
   config 1, DistilBERT-SST2 over 100 cached comments of 128 tokens, the
   bf16 forward against the same seeded weights in float32 on the card
   (3e-2), every value finite, each row's two scores summing to 1 and
   the prediction their mean, and a narrow float32 DistilBERT-shaped
   step on the card against the CPU (1e-4); no kernel launches. (b)
   Config 2, 8 Beta(10, 10) oracles (2 failing) in 6 dimensions, a chunk
   of 256 updates through one B3 launch against ``consensus_step_batched``
   on the same fleets on the card (the consensus bars), the card's fleets
   against the host's draws (keys and honest masks exact, values 1e-6),
   the mean failing detected. (c) Config 3 on phase 4b's seed-0 weights
   (the dense unpacked forward of 128 x 128 tokens, the window [50, 2],
   64 oracles, 8 failing, subsets of 10), B2 once a step against
   ``fused_consensus_plain`` on the last fleet, distinct essences across
   keys. (d) Config 4, 1024 oracles (256 failing) over ``uniform(PRNGKey(1),
   (50, 6)) / 6``, a chunk of 64 through one B3 launch against the plain
   cube, the mean failing detected. Launch counts are read around each
   config (threefry as drawn, the fleet draws once a config-3 step and
   once a config-4 chunk, B2 once a config-3 step, B3 once a chunk,
   B1, B4, B5 and B6 never); each prints its rate on the wall clock
   (comments/s or consensus-updates/s, every result fetched), its
   forward's and consensus's CUDA-event times, and config 4 the latency
   of one update at 1024 oracles, beside the card's name and power limit.
21. The JAX package's last entry points (``svoc_torch/tools/baseline_configs.py``
   and ``svoc_torch/examples/``). (a) Config 7 (``bench.py:1580``): the
   dense data-parallel step on ``serving_mesh()`` (one slot a card),
   ROBERTA_GO_EMOTIONS with bf16-resident seeded weights, 256 rows of 128
   tokens a slot, 1024 oracles (128 failing), subsets of 10; one step's
   launches (threefry only), the slot's vectors against the unmeshed dense
   forward within ``VARIANT_BAR`` and the step's consensus against the
   fleet and consensus of that forward's window; then
   ``baseline_configs.run(7)`` with a 1 s window. (b) Config 11
   (``bench.py:2159``): the int8 packed step (the float32 weights folded),
   256 rows of 128 tokens with up to 8 comments; the loop primed as
   ``bench.py:2275-2297`` primes it, the pipelined output of batch k equal
   to the plain step's on batch k exactly, the drain closing the last;
   the int8 forward against the bf16 packed one at the reference's bars;
   ``baseline_configs.run(11)``. (c) Each example's ``main`` in this
   process at the reference's documented command (``examples/README.md``),
   its output captured: every number it prints held to the JAX package's
   output (:data:`REFERENCE_EXAMPLES`) by
   ``svoc_torch.examples.compare_printed``, within its printed unit plus
   the demo's ``printed_bars`` and the bars of :data:`EXAMPLE_RUNS`, its
   launches to :data:`EXAMPLE_LAUNCHES`, the fleet demo's commit to the
   batched certified route, the serving ladder on 8 slots of the card
   and at full width on one; and one stage of each demo that reaches B1
   or B3 on the card and on the CPU.
   (d) The phase's seconds.

It then prints one JSON line of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. It exits non-zero, and prints no
result, if any check fails, if there is no CUDA device, or if the
``svoc_torch`` package is not beside it. Bounds use the H100 SXM data
sheet: 3.35 TB/s, 989 TFLOP/s bf16 and 67 TFLOP/s fp32; integer work at
64 INT32 lanes an SM on 132 SMs at the SM clock nvidia-smi reads.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
#: Hopper's INT32 lanes: 64 an SM (16 in each of its four partitions), 132
#: SMs; the integer rate is that times the SM clock (``int32_rate``). FP32_FLOPS
#: counts 128 lanes an SM and a fused multiply-add as two operations.
INT32_LANES = 64 * 132
#: threefry2x32's work on the INT32 pipe a hash, from the function itself:
#: 20 rotates (one SHF each) and 20 xors (one LOP3 each); bits add one LOP3
#: a word (y1 ^ y2). Only that pipe takes SHF and LOP3. The hash's adds (20
#: rounds, 10 key injections) are not counted: the compiler issues them to
#: the FMA pipe as IMAD, where they take fewer slots than these take here,
#: so the count is a lower bound whichever pipe takes them. Phase 3c checks
#: that the built kernel issues at least these SHFs and LOP3s a counter.
THREEFRY_INT_OPS = 40
KERNELS = ("flash_attention", "flash_attention_bwd", "fused_consensus",
           "gated_claims_consensus", "grid_copy", "threefry", "fleet_draws")  # sources
MAIN_STEPS = 5  # timed steps after one warm-up step
#: Timed steps of the serving path with the overlapped feed (8 before): the
#: forward is launch-bound, so its CUDA-event time is the host's launch time,
#: and the host stalls a step now and then (2-12 ms on an NVIDIA H100 80GB
#: HBM3 host, in serial steps as in overlapped ones); one stall moves the
#: mean of 24 steps a third as far as the mean of 8.
OVERLAP_STEPS = 24
CONFIG5_STEPS = 10  # timed steps of phase 8's per-tx submit (bench.py's config 5)
#: The least spread of the serving forward's CUDA-event time: its mean
#: over five steps ranged 18.6-20.1 ms (±4 %) between runs on an NVIDIA
#: H100 80GB HBM3 at 700 W.
FORWARD_SPREAD = 0.05
CLAIMS, ORACLES, REQUESTS_PER_CLAIM = 64, 1024, 8  # the multi-claim path
CLAIM_STEPS, CLAIM_TIMED = 8, 5  # its steps, of which the last are timed
FABRIC_CLAIMS, FABRIC_CYCLES = 64, 6  # phase 9b: bench.py --claims 64, 7 oracles each
#: Phase 10b: claims, arrivals a claim a step, timed steps after one warm-up.
SERVING_CLAIMS, SERVING_ARRIVALS, SERVING_STEPS = 64, 8, 10
#: Phase 10b's request-latency target: a step serves every claim and
#: commits its chain (9b's cycle took 0.98-1.32 s on an NVIDIA H100 80GB
#: HBM3 at 700 W), so the reference's 0.25 s would shed the load it is
#: there to measure.
SERVING_LATENCY_TARGET_S = 5.0
SESSION_CYCLES = 10  # phase 9c: the single-claim loop
FIXED_STEPS = 10  # training steps on one fixed batch
#: The fixed batch's last loss must be below this × its first (0.963
#: measured on an NVIDIA H100 80GB HBM3).
FIXED_LOSS_RATIO = 0.98
#: Largest difference between the three flagship variants' per-comment
#: bf16 vectors on shared comments (1.8e-3 measured on an NVIDIA H100
#: 80GB HBM3).
VARIANT_BAR = 5e-3
#: The kernels of the JSON line: name → (source, the TPU kernel it replaces).
KERNEL_ROWS = {
    "flash_attention": ("svoc_torch/csrc/flash_attention.cu", "svoc_tpu/ops/pallas_attention.py:71"),
    "flash_dq": ("svoc_torch/csrc/flash_attention_bwd.cu", "svoc_tpu/ops/pallas_attention.py:157"),
    "flash_dkv": ("svoc_torch/csrc/flash_attention_bwd.cu", "svoc_tpu/ops/pallas_attention.py:201"),
    "fused_consensus": ("svoc_torch/csrc/fused_consensus.cu", "svoc_tpu/ops/pallas_consensus.py:209"),
    "gated_claims_consensus": ("svoc_torch/csrc/gated_claims_consensus.cu",
                               "svoc_tpu/ops/pallas_consensus.py:411"),
    "grid_copy": ("svoc_torch/csrc/grid_copy.cu", "tools/tpu_probe.py:99"),
    "threefry": ("svoc_torch/csrc/threefry.cu", "jax/_src/prng.py threefry2x32 (XLA, no Pallas)"),
    "fleet_draws": ("svoc_torch/csrc/fleet_draws.cu",
                    "svoc_tpu/sim/oracle.py:23 gen_oracle_predictions' draws (XLA, no Pallas)"),
}
#: jax.random under jax 0.9.0 (partitionable threefry), generated with
#: it and kept as literals: the card's machine has no JAX.
#: (what, the port's call, JAX's answer)
KNOWN_ANSWERS = (
    ("PRNGKey(3_000_000_000)", lambda p, k: p.PRNGKey(3_000_000_000, "cuda"), [0, 3000000000]),
    ("split(PRNGKey(0), 3)", lambda p, k: p.split(k(0), 3),
     [[1797259609, 2579123966], [928981903, 3453687069], [4146024105, 2718843009]]),
    ("split(PRNGKey(3_000_000_000), 2)", lambda p, k: p.split(k(3_000_000_000), 2),
     [[3521736166, 882574885], [2043274875, 1597276722]]),
    ("fold_in(PRNGKey(0), 0)", lambda p, k: p.fold_in(k(0), 0), [1797259609, 2579123966]),
    ("fold_in chain of steps 0, 1, 2", lambda p, k: p.fold_in(p.fold_in(p.fold_in(k(0), 0), 1), 2),
     [276444683, 838309524]),
    ("fold_in(PRNGKey(7), 2**31 + 5)", lambda p, k: p.fold_in(k(7), 2**31 + 5), [3129736998, 445282630]),
    ("uniform(PRNGKey(42), (4,)), float32 bits", lambda p, k: p.uniform(k(42), (4,)),
     [1056585764, 1059981104, 1058915320, 1057988288]),
    ("permutation(PRNGKey(0), 10)", lambda p, k: p.permutation(k(0), 10), [0, 1, 8, 5, 6, 4, 3, 2, 7, 9]),
    ("permutation(PRNGKey(2), 1024)[:8]", lambda p, k: p.permutation(k(2), 1024)[:8],
     [135, 543, 783, 164, 965, 319, 792, 83]),
    ("permutation(PRNGKey(1), 1626)[:8] (two rounds)", lambda p, k: p.permutation(k(1), 1626)[:8],
     [1043, 964, 1303, 1265, 149, 25, 367, 1023]),
    ("choice(PRNGKey(5), 50, (10,), replace=False)", lambda p, k: p.choice(k(5), 50, 10),
     [45, 10, 17, 43, 31, 20, 9, 14, 0, 2]),
)
#: B4's bf16 times (ms) at flash_probe's four shapes with its CUDA-core
#: body, before the tensor-core body: backward_times() run on that
#: body's tree (an NVIDIA H100 80GB HBM3 at 700.00 W).
OLD_DQ_MS = {(256, 128): 1.5497, (8, 512): 0.7043, (8, 2048): 10.8642, (2, 8192): 42.4093}
PROBE_TIMEOUT_S = 120  # each probe of phase 7 (about 10 s each on an H100)
#: Phase 7 runs the consensus probe at 1024 oracles only: the tool's bisect
#: below it (128, 256, 512) repeated the same probe in three more
#: interpreters, about 39 s (cut to fit the time limit).
PROBE_CONSENSUS_SIZES = (1024,)
#: Probe interpreters at a time after the backend canary (one at a time
#: took 76.9 s against 42.9 s at two on NVIDIA H100 80GB HBM3 hosts, and
#: the phase 37.6 s at two on a faster one; each spends most of its life
#: importing torch): every record but the canary's carries ``jobs``, its
#: times read beside other probes'.
PROBE_JOBS = 3
PROBE_RECORDS = ("backend", "grid_copy", *(f"consensus{n}" for n in PROBE_CONSENSUS_SIZES), "flash512",
                 "encoder512_dense", "encoder512_flash")

failures: list = []
#: A checkout of the parent commit (``--parent DIR``): phases 1b and 3b
#: then time its B6 and B3 in the same run. None: not timed.
PARENT = None


def check(ok: bool, what: str) -> bool:
    print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
    if not ok:
        failures.append(what)
    return ok


def phase(title: str):
    """A phase of the script: its title, its seconds, and the commit routes
    it took in this process (chain RPCs by mode, batched-commit fallbacks
    by reason) where it took any."""
    def wrap(fn):
        def run(*args, **kwargs):
            print(f"== {title}", flush=True)
            t0 = time.perf_counter()
            routes = commit_routes() if "svoc_torch.utils.metrics" in sys.modules else {}
            try:
                return fn(*args, **kwargs)
            except Exception:  # a phase that raises is a failed phase; the next may still run
                traceback.print_exc()
                failures.append(f"{title}: raised")
                return None
            finally:
                number = title.split('.')[0]
                moved = diff(commit_routes(), routes) if "svoc_torch.utils.metrics" in sys.modules else {}
                if moved:
                    print(f"  (phase {number}'s commit routes: {moved})", flush=True)
                print(f"  (phase {number}: {time.perf_counter() - t0:.1f} s)", flush=True)
        return run
    return wrap


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "nvidia-smi unavailable"


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event) -> float:
    """An event's own device time in µs, under either of torch's names."""
    return getattr(event, "self_device_time_total", 0) or getattr(event, "self_cuda_time_total", 0)


def profiled_ms(torch, fn, kernel: str, iters: int = 20):
    """Device time of one launch of the kernel whose name holds
    ``kernel``: ``torch.profiler`` over ``iters`` calls of ``fn``, that
    kernel's own device time over ``iters``. Informational: None when the
    profiler shows no such kernel."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(2):  # a profile has come back without device events: one more
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            hits = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
            if hits:
                return sum(device_us(e) for e in hits) / iters / 1e3
        return None
    except Exception:  # the profiler is an observation, not a check
        traceback.print_exc()
        return None


def device_ops(torch, fn) -> int:
    """Kernels and copies ``fn`` puts on the card, by ``torch.profiler``
    (informational: -1 when the profiler shows none)."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA) or -1
    except Exception:  # the profiler is an observation, not a check
        traceback.print_exc()
        return -1


def bound(bytes_moved: float, ops: float, peak_ops: float, int_ops: float = 0):
    """The least time in ms and what sets it: the bytes at the memory rate,
    or the operations, ``ops`` at ``peak_ops`` and ``int_ops`` (integer
    work) at ``int32_rate()``, the larger of the two pipes' times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops / peak_ops, int_ops / int32_rate() if int_ops else 0.0)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@functools.cache
def int32_rate() -> float:
    """Integer operations a second: ``INT32_LANES`` at the card's maximum
    SM clock (``nvidia-smi --query-gpu=clocks.max.sm``), read once."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(res.stdout.split()[0])
    print(f"  INT32 rate: {INT32_LANES} lanes x {mhz:.0f} MHz = {INT32_LANES * mhz / 1e6:.3f} T/s", flush=True)
    return INT32_LANES * mhz * 1e6


def sass_counts(name: str, function: str) -> dict:
    """Opcodes of the kernel whose mangled name holds ``function`` in the
    built ``csrc/<name>.cu`` (``cuobjdump -sass``), by count."""
    import collections

    from svoc_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                         timeout=120, check=True)
    counts, inside = collections.Counter(), False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts)


@phase("1. environment and build")
def environment(torch):
    from svoc_torch.ops import _build

    print(f"  card: {nvidia_smi()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    from svoc_torch.runtime import native

    t0 = time.perf_counter()
    reports = _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    print(f"  kernel build: {time.perf_counter() - t0:.3f} s ({', '.join(KERNELS)})")
    t0 = time.perf_counter()
    native.load_native_library()
    print(f"  native runtime build (g++, {' '.join(native.CXX_FLAGS)}): {time.perf_counter() - t0:.3f} s "
          f"({native.library_path().name})")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")
    return True


def host_us(torch, fn, calls: int = 1000, rounds: int = 20) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls in ``rounds``
    rounds with no synchronise inside a round (the card drains between
    rounds, off the clock, so that no call waits on a full queue); the
    median round, so that a round in which the shared host took the core
    away does not count."""
    fn()
    torch.cuda.synchronize()
    per_round = calls // rounds
    spent = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(per_round):
            fn()
        spent.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return sorted(spent)[rounds // 2] / per_round * 1e6


def host_costs(torch) -> None:
    """Host µs per call of every kernel wrapper (B1 to B6 at their
    main-path shapes, ``x.clone()`` beside them), and of B6 split into
    its checks and argument preparation (the rest), its output's
    allocation, the launch helper (with a C entry that does nothing) and
    the ctypes call of the kernel itself. Informational.
    Imports ``svoc_torch`` from ``sys.path``, so it measures whichever
    tree comes first there."""
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.ops import _build
    from svoc_torch.ops.flash_attention import (
        attention_delta, attention_tags, flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda,
    )
    from svoc_torch.ops.fused_consensus import (
        fused_consensus_cuda, fused_consensus_gated_claims_cuda,
    )
    from svoc_torch.ops.grid_copy import grid_copy_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, dout = (torch.randn(256, 128, 12, 64, generator=gen, device=dev).bfloat16() for _ in range(4))
    qtag, ktag = attention_tags(q, segment_ids=run_segments(torch, 256, 128, 16, dev))
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    delta = attention_delta(out, dout)
    fleet = torch.rand(1024, 6, generator=gen, device=dev)
    cube = torch.rand(CLAIMS, ORACLES, 6, generator=gen, device=dev)
    ok = torch.ones(CLAIMS, ORACLES, dtype=torch.bool, device=dev)
    claim_mask = torch.ones(CLAIMS, dtype=torch.bool, device=dev)
    flagship, claims = ConsensusConfig(n_failing=128), ConsensusConfig(n_failing=256)
    x, block = torch.zeros(4, 256, 128, device=dev), (1, 128, 128)
    costs = {
        "B1": lambda: flash_attention_cuda(q, k, v, qtag, ktag),
        "B4": lambda: flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta),
        "B5": lambda: flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta),
        "B2": lambda: fused_consensus_cuda(fleet, flagship),
        "B3": lambda: fused_consensus_gated_claims_cuda(cube, ok, claim_mask, claims),
        "B6": lambda: grid_copy_cuda(x, block),
        "x.clone()": lambda: x.clone(),
    }
    us = {name: host_us(torch, fn) for name, fn in costs.items()}

    # B6's C entry and arguments, caught on their way through the helper.
    launch, seen = _build.launch, {}

    def spy(kernel, fn, device, *args):
        seen.update(fn=fn, device=device, args=args)
        return launch(kernel, fn, device, *args)

    _build.launch = spy
    try:
        held = grid_copy_cuda(x, block)  # keeps the output the caught pointers name
    finally:
        _build.launch = launch
    stream = torch.cuda.current_stream().cuda_stream
    split = {
        "allocation": host_us(torch, lambda: torch.empty_like(x)),
        "launch helper": host_us(torch, lambda: launch("probe", lambda *a: 0, seen["device"], *seen["args"])),
        "ctypes call": host_us(torch, lambda: seen["fn"](*seen["args"], stream)),
    }
    split = {"checks and arguments": us["B6"] - sum(split.values()), **split}
    del held
    print(f"  [{nvidia_smi()}] host us per call (median of 20 rounds of 50 calls, no synchronise): "
          + ", ".join(f"{name} {t:.2f}" for name, t in us.items())
          + "; B6 split: " + ", ".join(f"{name} {t:.2f}" for name, t in split.items()), flush=True)


def copy_times(torch) -> dict:
    """B6 and ``x.clone()`` by CUDA events, over 500 launches at the
    probe's shape and 50 at [64, 8192, 128] float32, with the bound.
    Imports ``svoc_torch`` from ``sys.path``."""
    from svoc_torch.ops.grid_copy import grid_copy_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    card, block, times = nvidia_smi(), (1, 128, 128), {}
    for shape, iters in (((4, 256, 128), 500), ((64, 8192, 128), 50)):
        x = torch.randn(*shape, generator=gen, device=dev)
        ms = cuda_ms(torch, lambda: grid_copy_cuda(x, block), iters=iters)
        library_ms = cuda_ms(torch, lambda: x.clone(), iters=iters)
        bytes_moved = 2 * x.numel() * x.element_size()
        bound_ms, bound_by = bound(bytes_moved, 0, FP32_FLOPS)
        print(f"  [{card}] {list(shape)} f32: B6 {ms:.4f} ms ({bytes_moved / ms / 1e9:.3f} TB/s), "
              f"x.clone() {library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}; "
              f"{bytes_moved} bytes)", flush=True)
        times[shape] = dict(ms=ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        del x
    return times


def on_parent(*names: str) -> None:
    """Run this script's functions ``names`` (each taking ``torch``) in a
    new interpreter against the tree given by ``--parent``, so that a
    change is timed beside its parent in one run; informational, and
    skipped without ``--parent``."""
    if PARENT is None:
        print(f"  parent tree: not given (--parent DIR); {', '.join(names)} not run there")
        return
    code = ("import runpy, sys, torch; sys.path.insert(0, '.'); "
            "from svoc_torch.ops import _build; "
            f"ns = runpy.run_path({str(Path(__file__).resolve())!r}); "
            "_build.build([n for n in ns['KERNELS'] if (_build.CSRC / (n + '.cu')).exists()]); "
            + "; ".join(f"ns[{name!r}](torch)" for name in names))
    res = subprocess.run([sys.executable, "-c", code], cwd=PARENT, capture_output=True, text=True,
                         timeout=900)
    for line in res.stdout.splitlines():
        print(f"  parent {PARENT}: {line.strip()}")
    if res.returncode != 0:
        print(f"  parent run failed (informational): {res.stderr[-2000:]}")


@phase("1b. grid copy: kernel vs plain")
def grid_copy_phase(torch, results):
    from svoc_torch.ops.grid_copy import grid_copy_cuda, grid_copy_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0.0

    def compare(name, x, block):
        nonlocal worst
        out = grid_copy_cuda(x, block)
        ref = grid_copy_plain(x, block)
        torch.cuda.synchronize()
        bits = {4: torch.int32, 2: torch.int16}[x.element_size()]
        worst = max(worst, (out.float() - x.float()).abs().max().item())
        grid = (x.shape[0], x.shape[1] // block[1], x.shape[2] // block[2])
        check(out.data_ptr() != x.data_ptr() and torch.equal(out.view(bits), x.view(bits))
              and torch.equal(out.view(bits), ref.view(bits)),
              f"{name}: {list(x.shape)} {str(x.dtype)[6:]}, block {block}, grid {grid}: "
              f"kernel == input == plain, bit for bit")

    probe_x = torch.arange(4 * 256 * 128, dtype=torch.float32, device=dev).reshape(4, 256, 128)
    block = (1, 128, 128)
    big = torch.randn(64, 8192, 128, generator=gen, device=dev)
    big.view(-1)[:4] = torch.tensor([float("nan"), -float("nan"), -0.0, float("inf")], device=dev)
    compare("the probe's shape", probe_x, block)
    compare("256 MiB, NaNs and -0.0 among its words", big, block)
    compare("an odd block", probe_x, (1, 64, 128))
    compare("bf16", torch.randn(8, 512, 256, generator=gen, device=dev).bfloat16(), (1, 128, 64))
    compare("a tile whose unrolled rounds end part full",
            torch.randn(2, 96, 160, generator=gen, device=dev), (1, 48, 160))
    compare("a narrow block (scalar path)", torch.randn(3, 10, 6, generator=gen, device=dev), (1, 5, 3))

    for name, x, blk in (
        ("a block that does not divide the shape", probe_x, (1, 100, 128)),
        ("a non-contiguous tensor", torch.zeros(4, 128, 256, device=dev).transpose(1, 2), block),
    ):
        before = grid_copy_cuda.launches
        try:
            grid_copy_cuda(x, blk)
            refused = False
        except ValueError:
            refused = True
        check(refused and grid_copy_cuda.launches == before,
              f"refuses {name} with ValueError before any launch")

    card = nvidia_smi()
    for name, x, plain_iters in (("[4, 256, 128]", probe_x, 10), ("[64, 8192, 128]", big, 2)):
        plain_ms = cuda_ms(torch, lambda: grid_copy_plain(x, block), iters=plain_iters, warmup=1)
        print(f"  [{card}] {name} f32: plain {plain_ms:.4f} ms")
        if x is probe_x:
            probe_plain_ms = plain_ms
    del big
    # This tree, the parent's (with --parent), this tree again.
    times = copy_times(torch)
    host_costs(torch)
    on_parent("copy_times", "host_costs")
    copy_times(torch)
    host_costs(torch)
    results["grid_copy"] = dict(max_abs_err=worst, plain_ms=probe_plain_ms, **times[(4, 256, 128)])


def packed_batch(seed: int):
    from svoc_torch.flagship import pack_stream, token_lists
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS as cfg
    from svoc_torch.models.tokenizer import HashingTokenizer

    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=128)
    lists = token_lists(tok, SyntheticSource(batch=256, seed=seed), 128)
    batch, _ = next(pack_stream(lists, 256, 128, 8, tok.pad_id))
    return batch


def small_tags(torch, q, mode, gen):
    """Tags for [B, T] in one of the two mask modes, row 0 dead: sorted
    segment ids 0..3 (0 is padding), or a random key mask."""
    from svoc_torch.ops.flash_attention import attention_tags

    b, t = q.shape[:2]
    if mode == "segments":
        seg = torch.randint(0, 4, (b, t), generator=gen, device=q.device, dtype=torch.int32)
        seg = seg.sort(dim=1).values
        seg[0] = 0
        return attention_tags(q, segment_ids=seg.contiguous())
    kmask = torch.rand(b, t, generator=gen, device=q.device) > 0.3
    kmask[0] = False
    return attention_tags(q, kmask=kmask)


def run_segments(torch, b, t, length, device):
    """Segment ids 1, 2, ... in runs of ``length`` tokens, the last 7
    tokens padding."""
    seg = (torch.arange(t, device=device) // length + 1).expand(b, t).clone()
    seg[:, -7:] = 0
    return seg.to(torch.int32).contiguous()


def range_rule_share(torch, qtag, ktag, tile=64):
    """The share of (query tile, key tile) pairs, ``tile`` rows each, in
    which no key tag lies within the live (> 0) tag range of the query
    tile's rows: what a tile skip by tag range would save."""
    import torch.nn.functional as F

    b, t = qtag.shape
    o = F.pad(qtag, (0, (-t) % tile)).view(b, -1, tile)
    lo = torch.where(o > 0, o, torch.iinfo(torch.int32).max).amin(-1)[:, :, None, None]
    hi = torch.where(o > 0, o, 0).amax(-1)[:, :, None, None]
    st = F.pad(ktag, (0, (-t) % tile)).view(b, 1, -1, tile)
    return 1.0 - ((st >= lo) & (st <= hi)).any(-1).float().mean().item()


@phase("2. flash attention: kernel vs plain")
def flash_phase(torch, results):
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import (
        attention_tags, flash_attention_cuda, flash_attention_plain, tag_mask,
    )
    from svoc_torch.tools import flash_probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, t, h, d, dtype):
        return [torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype) for _ in range(3)]

    # Flagship shape, segment ids of a real packed batch.
    b, t, h, d = 256, 128, 12, 64
    seg = torch.from_numpy(packed_batch(seed=1).seg).to(dev)
    q, k, v = qkv(b, t, h, d, torch.bfloat16)
    qtag, ktag = attention_tags(q, segment_ids=seg)
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, qtag, ktag, return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= 3e-2, f"flagship bf16 segments: max |kernel - plain| = {err:.3e} <= 3e-2")
    dead = seg == 0
    check(bool(torch.all(out[dead] == 0)) and bool(torch.all(torch.isneginf(lse[dead]))),
          f"flagship: {int(dead.sum())} padding queries give exactly 0 and lse -inf")
    lse_err = (lse[~dead] - ref_lse[~dead]).abs().max().item()
    check(lse_err <= 1e-4, f"flagship lse: max err {lse_err:.3e} <= 1e-4")

    kmask = seg > 0
    kmask[3] = False  # a row whose every key is masked
    kq, kk = attention_tags(q, kmask=kmask)
    kout = flash_attention_cuda(q, k, v, kq, kk)
    kref = flash_attention_plain(q, k, v, kq, kk)
    torch.cuda.synchronize()
    kerr = (kout.float() - kref.float()).abs().max().item()
    check(kerr <= 3e-2 and bool(torch.all(kout[3] == 0)),
          f"flagship bf16 kmask: max err {kerr:.3e} <= 3e-2, fully masked row exactly 0")

    for hd in (16, 32, 64, 128):
        sq, sk, sv = qkv(2, 77, 3, hd, torch.float32)
        sseg = torch.randint(0, 4, (2, 77), generator=gen, device=dev, dtype=torch.int32).sort(dim=1).values
        a, b_ = attention_tags(sq, segment_ids=sseg)
        so, sl = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
        ro, rl = flash_attention_plain(sq, sk, sv, a, b_, return_lse=True)
        torch.cuda.synchronize()
        live = torch.isfinite(rl)
        e_out = (so - ro).abs().max().item()
        e_lse = (sl[live] - rl[live]).abs().max().item()
        check(e_out <= 2e-5 and e_lse <= 2e-5 and torch.equal(live, torch.isfinite(sl)),
              f"f32 [2, 77, 3, {hd}] segments: out err {e_out:.3e}, lse err {e_lse:.3e} <= 2e-5")

    # bf16 (the tensor-core body) at every head width, T from one token to
    # 16 key tiles, both mask modes: 3e-2, lse 1e-3, dead rows exactly 0
    # with lse -inf, two launches bit for bit the same.
    for hd in (16, 32, 64, 128):
        for t_ in (1, 77, 1000):
            errs, ok = [], True
            for mode in ("segments", "kmask"):
                sq, sk, sv = qkv(3, t_, 2, hd, torch.bfloat16)
                a, b_ = small_tags(torch, sq, mode, gen)
                so, sl = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
                so2, sl2 = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
                ro, rl = flash_attention_plain(sq, sk, sv, a, b_, return_lse=True)
                torch.cuda.synchronize()
                live = torch.isfinite(rl)
                errs += [(so.float() - ro.float()).abs().max().item(),
                         (sl[live] - rl[live]).abs().max().item() if bool(live.any()) else 0.0]
                ok &= (errs[-2] <= 3e-2 and errs[-1] <= 1e-3 and torch.equal(live, torch.isfinite(sl))
                       and bool(torch.all(so[~live] == 0)) and bool(torch.all(so[0] == 0))
                       and torch.equal(so, so2) and torch.equal(sl, sl2))
            check(ok, "bf16 [3, {}, 2, {}]: segments out err {:.3e}, lse err {:.3e}; kmask out err "
                      "{:.3e}, lse err {:.3e}; dead rows 0 and -inf; two launches equal".format(t_, hd, *errs))

    # T = 1000 as one segment (every pair live) and in runs of 50 tokens
    # (most pairs masked).
    for kind in ("one segment", "runs of 50"):
        sq, sk, sv = qkv(2, 1000, 3, 64, torch.bfloat16)
        seg_ = run_segments(torch, 2, 1000, 1000 if kind == "one segment" else 50, dev)
        a, b_ = attention_tags(sq, segment_ids=seg_)
        so, sl = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
        ro, rl = flash_attention_plain(sq, sk, sv, a, b_, return_lse=True)
        torch.cuda.synchronize()
        live = torch.isfinite(rl)
        e_out = (so.float() - ro.float()).abs().max().item()
        e_lse = (sl[live] - rl[live]).abs().max().item()
        check(e_out <= 3e-2 and e_lse <= 1e-3 and torch.equal(live, torch.isfinite(sl)),
              f"bf16 [2, 1000, 3, 64], {kind}: out err {e_out:.3e}, lse err {e_lse:.3e}")
    print(f"  flagship: a tag-range skip would save {100 * range_rule_share(torch, qtag, ktag):.1f} % "
          f"of the 64 x 64 (query tile, key tile) pairs; the kernels visit every tile")

    # Times at the flagship shape, main-path call (no lse).
    ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, qtag, ktag))
    plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, qtag, ktag), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    live = tag_mask(qtag, ktag)
    mask = live[:, None]
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    live_pairs = int(live.sum())
    bytes_moved = 4 * q.numel() * q.element_size() + 2 * qtag.numel() * 4
    bound_ms, bound_by = bound(bytes_moved, 4 * d * h * live_pairs, BF16_FLOPS)
    print(f"  flagship times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{bytes_moved} bytes, {live_pairs} live pairs)")
    results["flash_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )

    # Times at flash_probe's four shapes, every key live, by CUDA events;
    # SDPA without a mask (the same function here) and under an all-ones
    # boolean mask (as at the flagship shape). B1 is timed twice, before
    # and after SDPA, over at least 2 ms of launches each.
    card = nvidia_smi()
    for b, t in flash_probe.SHAPES:
        q, k, v = qkv(b, t, h, d, torch.bfloat16)
        ones = torch.ones(b, t, dtype=torch.int32, device=dev)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=dev)
        iters = 100 if t <= 2048 else 20
        first_ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, ones, ones), iters=iters)
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=iters)
        masked_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                            iters=iters)
        ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, ones, ones), iters=iters)
        bytes_moved = 4 * q.numel() * q.element_size() + 2 * ones.numel() * 4
        bound_ms, bound_by = bound(bytes_moved, 4 * d * h * b * t * t, BF16_FLOPS)
        print(f"  [{card}] B1 [{b}, {t}, 12, 64] bf16, all live: kernel {first_ms:.4f} ms before SDPA, "
              f"{ms:.4f} ms after ({iters} launches each), SDPA {sdpa_ms:.4f} ms (all-ones mask "
              f"{masked_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})")
        del qt, kt, vt


@phase("2b. flash backward: kernels vs plain")
def flash_bwd_phase(torch, results):
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import (
        attention_delta, attention_tags, flash_attention_bwd_plain, flash_attention_cuda,
        flash_dkv_cuda, flash_dq_cuda, tag_mask,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def normal(b, t, h, d, dtype):
        return torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)

    def run(q, k, v, qtag, ktag, dout, atol, rtol):
        """Both kernels and the plain backward's fp32 result (the plain
        arithmetic before its cast to q's dtype) on one input: the
        kernels' outputs, each one's max |kernel - plain|, whether every
        element is within atol + rtol * |plain|, and the largest |plain|."""
        out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
        delta = attention_delta(out, dout)
        got = (flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta),
               *flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta))
        ref = flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), qtag, ktag, out.float(), lse, dout.float())
        torch.cuda.synchronize()
        errs, ok = [], True
        for g, r in zip(got, ref):
            diff = (g.float() - r).abs()
            errs.append(diff.max().item())
            ok &= bool(torch.all(diff <= atol + rtol * r.abs()))
        return got, errs, ok, max(r.abs().max().item() for r in ref)

    # Flagship shape, segment ids of a real packed batch.
    b, t, h, d = 256, 128, 12, 64
    seg = torch.from_numpy(packed_batch(seed=1).seg).to(dev)
    q, k, v, dout = (normal(b, t, h, d, torch.bfloat16) for _ in range(4))
    qtag, ktag = attention_tags(q, segment_ids=seg)
    bf16_rtol = 2.0 ** -8  # one bf16 rounding of the kernel's output
    (dq, dk, dv), errs, ok, peak = run(q, k, v, qtag, ktag, dout, 3e-2, bf16_rtol)
    check(ok, "flagship bf16 segments: max |kernel - plain| dq {:.3e}, dk {:.3e}, dv {:.3e} "
              "<= 3e-2 + 2^-8 |plain| (max |plain| {:.3f})".format(*errs, peak))
    pad = seg == 0
    check(bool(torch.all(dq[pad] == 0) and torch.all(dk[pad] == 0) and torch.all(dv[pad] == 0)),
          f"flagship: dq, dk and dv of all {int(pad.sum())} padding tokens exactly 0")
    out_, lse_ = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    again = flash_dq_cuda(q, k, v, qtag, ktag, dout, lse_, attention_delta(out_, dout))
    check(torch.equal(again, dq), "flagship: dq of two launches bit for bit equal")

    kmask = seg > 0
    kmask[3] = False  # a row whose every key is masked
    kq, kk = attention_tags(q, kmask=kmask)
    (kdq, kdk, kdv), kerrs, kok, kpeak = run(q, k, v, kq, kk, dout, 3e-2, bf16_rtol)
    check(kok and bool(torch.all(kdq[3] == 0))
          and bool(torch.all(kdk[~kmask] == 0) and torch.all(kdv[~kmask] == 0)),
          "flagship bf16 kmask: max err dq {:.3e}, dk {:.3e}, dv {:.3e} (max |plain| {:.3f}); "
          "fully masked row's dq and masked keys' dk, dv exactly 0".format(*kerrs, kpeak))

    for hd in (16, 32, 64, 128):
        sq, sk, sv, sdo = (normal(2, 77, 3, hd, torch.float32) for _ in range(4))
        sseg = torch.randint(0, 4, (2, 77), generator=gen, device=dev, dtype=torch.int32).sort(dim=1).values
        a, b_ = attention_tags(sq, segment_ids=sseg)
        (gq, gk, gv), ferrs, fok, _ = run(sq, sk, sv, a, b_, sdo, 1e-4, 0.0)
        dead = sseg == 0
        check(fok and bool(torch.all(gq[dead] == 0) and torch.all(gk[dead] == 0)
                           and torch.all(gv[dead] == 0)),
              "f32 [2, 77, 3, {}] segments: dq {:.3e}, dk {:.3e}, dv {:.3e} <= 1e-4; "
              "padding exactly 0".format(hd, *ferrs))

    # bf16 (dq and dk/dv through the tensor-core bodies) at every head
    # width, T from one token to 16 tiles, both mask modes; dead keys and
    # rows exactly 0, two launches bit for bit the same; then T = 1000 as
    # one segment and in runs of 50 tokens.
    for hd in (16, 32, 64, 128):
        for t_ in (1, 77, 1000):
            case_errs, ok = [], True
            for mode in ("segments", "kmask"):
                sq, sk, sv, sdo = (normal(3, t_, 2, hd, torch.bfloat16) for _ in range(4))
                a, b_ = small_tags(torch, sq, mode, gen)
                (gq, gk, gv), berrs, bok, _ = run(sq, sk, sv, a, b_, sdo, 3e-2, bf16_rtol)
                out_, lse_ = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
                delta_ = attention_delta(out_, sdo)
                again = (flash_dq_cuda(sq, sk, sv, a, b_, sdo, lse_, delta_),
                         *flash_dkv_cuda(sq, sk, sv, a, b_, sdo, lse_, delta_))
                torch.cuda.synchronize()
                dead_k, dead_q = b_ == 0, ~torch.isfinite(lse_).all(dim=-1)
                case_errs += berrs
                ok &= (bok and all(torch.equal(x, y) for x, y in zip(again, (gq, gk, gv)))
                       and bool(torch.all(gk[dead_k] == 0) and torch.all(gv[dead_k] == 0)
                                and torch.all(gq[dead_q] == 0)))
            check(ok, "bf16 [3, {}, 2, {}]: segments dq {:.3e}, dk {:.3e}, dv {:.3e}; kmask dq {:.3e}, "
                      "dk {:.3e}, dv {:.3e} <= 3e-2 + 2^-8 |plain|; dead keys' dk, dv and dead rows' dq "
                      "exactly 0; dq, dk, dv of two launches equal".format(t_, hd, *case_errs))
    for kind in ("one segment", "runs of 50"):
        sq, sk, sv, sdo = (normal(2, 1000, 3, 64, torch.bfloat16) for _ in range(4))
        seg_ = run_segments(torch, 2, 1000, 1000 if kind == "one segment" else 50, dev)
        a, b_ = attention_tags(sq, segment_ids=seg_)
        _, berrs, bok, _ = run(sq, sk, sv, a, b_, sdo, 3e-2, bf16_rtol)
        check(bok, "bf16 [2, 1000, 3, 64], {}: dq {:.3e}, dk {:.3e}, dv {:.3e}".format(kind, *berrs))

    # Times at the flagship shape, main-path calls.
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    delta = attention_delta(out, dout)
    dq_ms = cuda_ms(torch, lambda: flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta))
    dkv_ms = cuda_ms(torch, lambda: flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta))
    plain_ms = cuda_ms(
        torch, lambda: flash_attention_bwd_plain(q, k, v, qtag, ktag, out, lse, dout), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    live = tag_mask(qtag, ktag)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=live[:, None])
    dout_t = dout.transpose(1, 2).contiguous()
    library_ms = cuda_ms(
        torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t, retain_graph=True))
    live_pairs = int(live.sum())
    tensor_bytes = q.numel() * q.element_size()
    reads = 4 * tensor_bytes + 2 * lse.numel() * 4 + 2 * qtag.numel() * 4  # q, k, v, dO, lse, delta, tags
    for name, ms, writes, flops in (
        ("flash_dq", dq_ms, 1, 6), ("flash_dkv", dkv_ms, 2, 8),
    ):
        bytes_moved = reads + writes * tensor_bytes
        bound_ms, bound_by = bound(bytes_moved, flops * d * h * live_pairs, BF16_FLOPS)
        print(f"  flagship {name}: kernel {ms:.4f} ms, plain backward {plain_ms:.4f} ms, "
              f"SDPA backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{bytes_moved} bytes, {live_pairs} live pairs)")
        results[name] = dict(
            max_abs_err=errs[0] if name == "flash_dq" else max(errs[1:]), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        )

    backward_times(torch)


def backward_times(torch):
    """B4 (dq) and B5 (dk/dv) at flash_probe's four shapes (bf16, 12 heads
    of 64, every key live) by CUDA events, beside SDPA's whole backward
    (no mask: the same function here) and each kernel's bound; B4's
    CUDA-core times from before its tensor-core body in brackets. Imports
    ``svoc_torch`` from ``sys.path``, so it times whichever tree comes
    first there."""
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import (
        attention_delta, flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda,
    )
    from svoc_torch.tools import flash_probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h, d = 12, 64
    card = nvidia_smi()
    for b, t in flash_probe.SHAPES:
        q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16() for _ in range(4))
        ones = torch.ones(b, t, dtype=torch.int32, device=dev)
        out, lse = flash_attention_cuda(q, k, v, ones, ones, return_lse=True)
        delta = attention_delta(out, dout)
        iters = 20 if t <= 2048 else 5
        dq_ms = cuda_ms(torch, lambda: flash_dq_cuda(q, k, v, ones, ones, dout, lse, delta), iters=iters)
        ms = cuda_ms(torch, lambda: flash_dkv_cuda(q, k, v, ones, ones, dout, lse, delta), iters=iters)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        dout_t = dout.transpose(1, 2).contiguous()
        library_ms = cuda_ms(
            torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t, retain_graph=True),
            iters=iters)
        tensor_bytes = q.numel() * q.element_size()
        reads = 4 * tensor_bytes + 2 * lse.numel() * 4 + 2 * ones.numel() * 4
        dq_bound, dq_by = bound(reads + tensor_bytes, 6 * d * h * b * t * t, BF16_FLOPS)
        bound_ms, bound_by = bound(reads + 2 * tensor_bytes, 8 * d * h * b * t * t, BF16_FLOPS)
        print(f"  [{card}] [{b}, {t}, 12, 64] bf16, all live: B4 {dq_ms:.4f} ms "
              f"[CUDA cores before: {OLD_DQ_MS.get((b, t), 'not measured')}], bound {dq_bound:.4f} ms "
              f"({dq_by}); B5 {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); SDPA backward "
              f"{library_ms:.4f} ms")
        del out, qt, kt, vt, sdpa_out


@phase("2c. flash against dense attention (flash_probe)")
def flash_dense_phase(torch):
    import torch.nn.functional as F

    from svoc_torch.tools import flash_probe

    dev = torch.device("cuda")
    verdict = flash_probe.parity_only()
    check(verdict["verdict"] == "rounding-equivalent" and len(verdict["entries"]) == 2,
          "parity_only: " + "; ".join(
              f"[{e['b']}, {e['t']}] flash err {e['err_flash_vs_f32_truth']:.4f}, dense err "
              f"{e['err_dense_vs_f32_truth']:.4f}, bound {e['bound']:.4f}" for e in verdict["entries"])
          + f": verdict {verdict['verdict']}")
    entries = flash_probe.main()
    check([(e["b"], e["t"]) for e in entries] == list(flash_probe.SHAPES),
          f"flash_probe.main: {len(entries)} shapes, forward and backward")
    on_disk = [json.loads(Path(name).read_text()) for name in
               ("FLASH_PROBE_GPU.json", "FLASH_PARITY_GPU.json")]
    check(on_disk[0] == entries and on_disk[1]["verdict"] == verdict["verdict"],
          "FLASH_PROBE_GPU.json and FLASH_PARITY_GPU.json readable and current")
    card = nvidia_smi()
    for e in entries:
        b, t = e["b"], e["t"]
        # Two bf16 results of magnitude up to 8 (ulp 2^-5) may differ by
        # two ulps forward (one measured); the backward sums three such
        # gradients (0.094 measured at T = 8192 on an NVIDIA H100 80GB HBM3).
        check(e["max_abs_diff"] <= 2 * 2.0 ** -5 and e["bwd_max_abs_diff"] <= 0.125
              and all(math.isfinite(e[k]) and e[k] > 0 for k in
                      ("dense_ms", "flash_ms", "dense_bwd_ms", "flash_bwd_ms")),
              f"[{b}, {t}, 12, 64] bf16: flash vs dense max diff forward {e['max_abs_diff']:.5f} "
              f"<= 0.0625, backward {e['bwd_max_abs_diff']:.5f} <= 0.125")
        # The library yardstick by the same protocol, on inputs of the
        # same shape, under the same all-ones key mask.
        qs = [torch.randn(b, flash_probe.HEADS, t, flash_probe.HEAD_DIM, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(i)).bfloat16()
              for i in range(4)]
        mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=dev)

        def sdpa(q):
            return F.scaled_dot_product_attention(q, q, q, attn_mask=mask)

        def sdpa_grad(q):
            q = q.detach().requires_grad_()
            return torch.autograd.grad(sdpa(q).float().sum(), q)[0]

        with torch.inference_mode():
            sdpa_ms = flash_probe.amortized_ms(lambda i: sdpa(qs[i % 4]), n=12)
        sdpa_bwd_ms = flash_probe.amortized_ms(lambda i: sdpa_grad(qs[i % 4]), n=12)
        print(f"  [{card}] [{b}, {t}, 12, 64] bf16 forward: flash {e['flash_ms']:.3f} ms "
              f"(peak {e['flash_peak_gib']} GiB), dense {e['dense_ms']:.3f} ms (peak "
              f"{e['dense_peak_gib']} GiB), SDPA {sdpa_ms:.3f} ms; forward + backward: flash "
              f"{e['flash_bwd_ms']:.3f} ms (peak {e['flash_bwd_peak_gib']} GiB), dense "
              f"{e['dense_bwd_ms']:.3f} ms (peak {e['dense_bwd_peak_gib']} GiB), SDPA "
              f"{sdpa_bwd_ms:.3f} ms; first calls {e['flash_first_call_s']} s, "
              f"{e['flash_bwd_first_call_s']} s")
        del qs, mask
        torch.cuda.empty_cache()


def fused_errors(torch, out, ref):
    """Whether a B2 output meets the reference's bars against ``ref``
    (the reliable mask exact; essences, risks and reliabilities within
    1e-5; skewness within 1e-4; kurtosis within 1e-3), and its errors."""
    errs = {f: (getattr(out, f) - getattr(ref, f)).abs().max().item() for f in (
        "essence", "essence_first_pass", "quadratic_risk", "reliability_first_pass",
        "reliability_second_pass", "skewness", "kurtosis")}
    ok = (torch.equal(out.reliable, ref.reliable) and all(errs[f] <= 1e-5 for f in list(errs)[:5])
          and errs["skewness"] <= 1e-4 and errs["kurtosis"] <= 1e-3)
    return ok, errs


@phase("3. fused consensus: kernel vs plain")
def consensus_phase(torch, results):
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0

    def compare(name, values, cfg):
        nonlocal worst
        ok, errs = fused_errors(torch, fused_consensus_cuda(values, cfg), fused_consensus_plain(values, cfg))
        worst = max(worst, *(errs[f] for f in ("essence", "essence_first_pass", "quadratic_risk")))
        check(ok, f"{name}: mask exact, " + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))

    flagship = ConsensusConfig(n_failing=128, constrained=True)
    uniform = 0.01 + 0.98 * torch.rand(1024, 6, generator=gen, device=dev)
    compare("N=1024 constrained", uniform, flagship)
    compare("N=1024 unconstrained",
            20.0 + 3.0 * torch.randn(1024, 6, generator=gen, device=dev),
            ConsensusConfig(n_failing=128, constrained=False))
    ties = torch.round(torch.rand(1024, 6, generator=gen, device=dev) * 100) / 100
    compare("N=1024 quantised to 1e-2 (ties)", ties.contiguous(), flagship)
    # Every row equal (3/8: every sum exact, so the moments of a constant
    # column are exact too), and values from {-0.0, +0.0, 0.25, 0.5}.
    compare("N=1024 all rows equal", torch.full((1024, 6), 0.375, device=dev), flagship)
    zeros = torch.tensor([-0.0, 0.0, 0.25, 0.5], device=dev)
    signed = zeros[torch.randint(0, 4, (1024, 6), generator=gen, device=dev)].contiguous()
    compare("N=1024 -0.0 and +0.0 mixed", signed, flagship)
    compare("N=7", torch.rand(7, 6, generator=gen, device=dev), ConsensusConfig(n_failing=2))
    compare("N=1000", torch.rand(1000, 6, generator=gen, device=dev), ConsensusConfig(n_failing=125))

    ms = cuda_ms(torch, lambda: fused_consensus_cuda(uniform, flagship), iters=200)
    plain_ms = cuda_ms(torch, lambda: fused_consensus_plain(uniform, flagship), iters=10)
    dev_ms = profiled_ms(torch, lambda: fused_consensus_cuda(uniform, flagship), "fused_consensus_kernel")
    n, m = uniform.shape
    bytes_moved = 4 * (n * m + 2 * m + 2 + n + n + 2 * m)
    # Each of the 4M + 1 ranks reads every key once (the radix select's integer
    # work, at the INT32 rate); the moments are float32 work.
    ranks, ops = (4 * m + 1) * n, 12 * n * m
    bound_ms, bound_by = bound(bytes_moved, ops, FP32_FLOPS, ranks)
    print(f"  [{nvidia_smi()}] N=1024 times: kernel {ms:.4f} ms (CUDA events, 200 launches), "
          f"{dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms (profiler device time, informational), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    results["fused_consensus"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    )


GATED_FLOATS = ("essence", "essence_first_pass", "reliability_first_pass",
                "reliability_second_pass")


def gated_errors(torch, out, ref):
    """Whether a claim-cube output meets the reference's bars against
    ``ref``, and its errors: reliable and interval_valid exact; the
    floats and the finite risks within 1e-5, infinite risks equal;
    skewness within 1e-4; kurtosis within 1e-3."""
    errs = {f: (getattr(out, f) - getattr(ref, f)).abs().max().item() for f in GATED_FLOATS}
    inf = torch.isinf(ref.quadratic_risk)
    errs["finite risk"] = ((out.quadratic_risk[~inf] - ref.quadratic_risk[~inf]).abs().max().item()
                           if bool((~inf).any()) else 0.0)
    errs["skewness"] = (out.skewness - ref.skewness).abs().max().item()
    errs["kurtosis"] = (out.kurtosis - ref.kurtosis).abs().max().item()
    ok = (torch.equal(out.reliable, ref.reliable)
          and torch.equal(out.interval_valid, ref.interval_valid)
          and torch.equal(torch.isinf(out.quadratic_risk), inf)
          and torch.equal(out.quadratic_risk[inf], ref.quadratic_risk[inf])
          and all(errs[f] <= 1e-5 for f in (*GATED_FLOATS, "finite risk"))
          and errs["skewness"] <= 1e-4 and errs["kurtosis"] <= 1e-3)
    return ok, errs, int(inf.sum())


def host_s(torch, fn, iters: int = 20) -> float:
    """Mean host time of ``fn`` (which ends in a fetch to the host) over
    ``iters`` calls after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def bench_cube():
    """The cube of ``bench.py --claims 64 --claims-oracles 1024``
    (``bench.py:2587-2629``) as numpy: values, admission masks, config."""
    import numpy as np

    from svoc_torch.consensus.kernel import ConsensusConfig

    rng = np.random.default_rng(0)
    values = rng.uniform(0.0, 1.0, size=(CLAIMS, ORACLES, 6)).astype(np.float32)
    ok = np.ones((CLAIMS, ORACLES), dtype=bool)
    ok[:: max(1, CLAIMS // 8), -1] = False
    return values, ok, ConsensusConfig(n_failing=256, constrained=True)


def gated_times(torch):
    """B3 at the bench_claims cube: CUDA events over 50 back-to-back
    launches, and the profiler's device time of one launch (over 20).
    Imports ``svoc_torch`` from ``sys.path``."""
    from svoc_torch.consensus.batch import pad_claim_cube
    from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda

    bench, bench_ok, cfg = bench_cube()
    values, ok, mask = (t.cuda() for t in pad_claim_cube(bench, bench_ok))
    ms = cuda_ms(torch, lambda: fused_consensus_gated_claims_cuda(values, ok, mask, cfg), iters=50)
    dev_ms = profiled_ms(torch, lambda: fused_consensus_gated_claims_cuda(values, ok, mask, cfg),
                         "gated_claims_kernel")
    print(f"  [{nvidia_smi()}] [64, 1024, 6] B3: {ms:.4f} ms (CUDA events, 50 launches), "
          f"{dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms (profiler device time, informational)",
          flush=True)
    return ms, dev_ms


@phase("3b. gated claim-cube consensus: kernel vs plain")
def gated_claims_phase(torch, results):
    from svoc_torch.consensus.batch import pad_claim_cube
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.ops.fused_consensus import (
        MAX_SMEM_BYTES, _gated_smem_bytes, fused_consensus_gated_claims_cuda,
        fused_consensus_gated_claims_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0

    def compare(name, values, ok, cfg):
        nonlocal worst
        values, ok, mask = (t.to(dev) for t in pad_claim_cube(values, ok))
        out = fused_consensus_gated_claims_cuda(values, ok, mask, cfg)
        ref = fused_consensus_gated_claims_plain(values, ok, mask, cfg)
        torch.cuda.synchronize()
        good, errs, n_inf = gated_errors(torch, out, ref)
        worst = max(worst, *(errs[f] for f in ("essence", "essence_first_pass", "finite risk")))
        check(good, f"{name}: reliable and interval_valid exact, {n_inf} infinite risks equal, "
                    + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
        return out, mask

    bench, bench_ok, bench_cfg = bench_cube()
    compare("bench_claims cube [64, 1024, 6], n_failing 256", bench, bench_ok, bench_cfg)

    for n in (1024, 7):
        values = torch.rand(4, n, 6, generator=gen, device=dev)
        ok = torch.ones(4, n, dtype=torch.bool, device=dev)
        ok[1, : max(1, n // 4)] = False
        values[1, 0] = float("nan")
        ok[2] = False
        ok[3, : n - 1] = False
        cfg = ConsensusConfig(n_failing=max(2, n // 8))
        out, _ = compare(f"degenerate spectrum N={n}", values, ok, cfg)
        check(not bool(out.interval_valid[2:].any()) and bool(torch.isinf(out.quadratic_risk[2]).all())
              and bool((out.essence[2:] == 0).all()) and bool((out.essence_first_pass[2] == 0).all()),
              f"N={n}: all-quarantined and single-survivor claims invalid, "
              f"risks +inf with n_ok = 0, essences zeroed")
        out, mask = compare(f"degenerate spectrum N={n}, 3 claims padded to 4", values[:3], ok[:3], cfg)
        check(not bool(mask[3]) and not bool(out.interval_valid[3]) and not bool(out.reliable[3].any())
              and bool((out.essence[3] == 0).all()) and bool((out.quadratic_risk[3] == 0).all()),
              f"N={n}: the padding claim comes back inactive")

    ties = torch.round(torch.rand(CLAIMS, ORACLES, 6, generator=gen, device=dev) * 100) / 100
    tie_ok = torch.rand(CLAIMS, ORACLES, generator=gen, device=dev) > 0.02
    compare("[64, 1024, 6] quantised to 1e-2 (ties)", ties, tie_ok, ConsensusConfig(n_failing=128))
    unc = 20.0 + 3.0 * torch.randn(16, ORACLES, 6, generator=gen, device=dev)
    compare("[16, 1024, 6] unconstrained", unc, tie_ok[:16],
            ConsensusConfig(n_failing=128, constrained=False))

    values, ok, mask = (t.to(dev) for t in pad_claim_cube(bench, bench_ok))
    for name, args in (
        ("smooth_mode 'true'", (values, ok, mask, ConsensusConfig(smooth_mode="true"))),
        ("a [2, 8192, 6] cube beyond shared memory",
         (torch.zeros(2, 8192, 6, device=dev), torch.ones(2, 8192, dtype=torch.bool, device=dev),
          mask[:2], bench_cfg)),
    ):
        before = fused_consensus_gated_claims_cuda.launches
        try:
            fused_consensus_gated_claims_cuda(*args)
            refused = False
        except ValueError:
            refused = True
        check(refused and fused_consensus_gated_claims_cuda.launches == before,
              f"refuses {name} with ValueError before any launch")

    lo, hi = 1, 65535  # the largest N whose [N, 6] claim fits one block
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _gated_smem_bytes(mid, 6) <= MAX_SMEM_BYTES else (lo, mid - 1)
    largest = lo
    check(largest >= 4635, f"the layout takes N up to {largest} at M = 6 (the bitonic one: 4635)")
    big = torch.rand(2, largest, 6, generator=gen, device=dev)
    big_ok = torch.rand(2, largest, generator=gen, device=dev) > 0.05
    compare(f"[2, {largest}, 6], the largest fleet at M = 6", big, big_ok,
            ConsensusConfig(n_failing=largest // 8))
    del big, big_ok

    # This tree, the parent's (with --parent), this tree again.
    ms, dev_ms = gated_times(torch)
    on_parent("gated_times")
    gated_times(torch)
    plain_ms = cuda_ms(
        torch, lambda: fused_consensus_gated_claims_plain(values, ok, mask, bench_cfg), iters=10)
    c, n, m = values.shape
    out = fused_consensus_gated_claims_cuda(values, ok, mask, bench_cfg)
    bytes_moved = sum(t.numel() * t.element_size() for t in (values, ok, mask, *out))
    sorts = 2 * m + 1  # constrained: the first pass, the ranking, the second pass
    # The ranks are integer work (the radix select), the moments float32 work.
    ranks, ops = c * sorts * n * math.ceil(math.log2(n)), c * 12 * n * m
    bound_ms, bound_by = bound(bytes_moved, ops, FP32_FLOPS, ranks)

    # bench_claims's batched-against-sequential comparison (bench.py:2666-2700):
    # one launch over the cube, or one launch per claim, each ending in
    # a fetch of the essences' sum to the host.
    per_claim = [(values[i: i + 1], ok[i: i + 1], mask[i: i + 1]) for i in range(c)]
    batched_s = host_s(
        torch, lambda: fused_consensus_gated_claims_cuda(values, ok, mask, bench_cfg).essence.sum().item())
    sequential_s = host_s(torch, lambda: sum(
        fused_consensus_gated_claims_cuda(*a, bench_cfg).essence.sum() for a in per_claim).item())
    seq_ms = cuda_ms(torch, lambda: [fused_consensus_gated_claims_cuda(*a, bench_cfg) for a in per_claim],
                     iters=10)
    print(f"  [{nvidia_smi()}] [64, 1024, 6] times: kernel {ms:.4f} ms (CUDA events), "
          f"{dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms (profiler device time), "
          f"plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}; {bytes_moved} bytes, {ranks} integer and {ops} float32 "
          f"operations); "
          f"64 one-claim launches {seq_ms:.4f} ms (CUDA events)")
    print(f"  claims/s with a host fetch: batched {c / batched_s:.1f} ({batched_s * 1e3:.4f} ms), "
          f"sequential {c / sequential_s:.1f} ({sequential_s * 1e3:.4f} ms), "
          f"ratio {sequential_s / batched_s:.2f}")
    results["gated_claims_consensus"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    )


#: threefry's timed shapes (what, keys, counters, bits, base): the three
#: the paths launch it with since the fleet draws took the fleets, then
#: the kernels table's [57344 keys, 64 counters] (phase 6's choice words
#: before the fleet draws), whose times go on the kernels line.
THREEFRY_TIMED = (
    ("a fold_in (1 key, 1 counter from a base, a pair)", 1, 1, False, 7),
    ("a split of 64 claim keys (1 key, 64 pairs)", 1, 64, False, 0),
    ("a generator's 2**20 bits (1 key)", 1, 2**20, True, 0),
    ("[57344 keys, 64 counters], bits", 57344, 64, True, 0),
)


def threefry_times(torch):
    """threefry at each of ``THREEFRY_TIMED``: CUDA events over 100
    launches (back to back, so at least the wrapper's host cost) and the
    profiler's device time of one launch; returns the last shape's.
    Imports ``svoc_torch`` from ``sys.path``, so it measures whichever
    tree comes first there."""
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.sim import prng

    card = nvidia_smi()
    for what, b, n, xor, base in THREEFRY_TIMED:
        keys = prng.split(prng.PRNGKey(1, "cuda"), b)
        launch = functools.partial(threefry_cuda, keys, n, base, xor)
        ms = cuda_ms(torch, launch, iters=100)
        dev_ms = profiled_ms(torch, launch, "threefry_kernel")
        print(f"  [{card}] threefry, {what}: {ms:.4f} ms (CUDA events, 100 launches), "
              f"{dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms (profiler device time)", flush=True)
    return ms, dev_ms


#: Phase 3c's fleets: (what, claims, window W, values M, oracles N, failing, subset S).
FLEET_CASES = (
    ("the flagship's fleet", 1, 50, 6, 1024, 128, 10),
    ("phase 6's 64 claims (window bucket 64)", 64, 64, 6, 1024, 128, 10),
    ("N = 2048, two shuffle rounds", 3, 50, 6, 2048, 128, 10),
    ("no failing oracle", 4, 50, 6, 1024, 0, 10),
    ("the fabric's 7 oracles, subsets as large as the window", 64, 10, 6, 7, 2, 10),
)


def fleet_bound(c: int, w: int, m: int, n: int, n_failing: int, s: int):
    """The fleet draws' least time: every hash of the key schedule, the
    words and the failing values at ``THREEFRY_INT_OPS`` a hash on the
    INT32 pipe and one more a word taken as bits (the sorts' compare-exchanges not counted), against the keys
    read once and the outputs written once."""
    from svoc_torch.sim.prng import shuffle_rounds

    h, rounds, w_rounds = n - n_failing, shuffle_rounds(n), shuffle_rounds(w)
    hashes = c * (3 + n_failing * m + h * (1 + w_rounds * (1 + w)) + rounds * (n + 1) + max(rounds - 1, 0))
    bits = c * (n_failing * m + h * w_rounds * w + rounds * n)  # the hashes taken as y1 ^ y2
    bytes_moved = c * (16 + 4 * n_failing * m + 8 * h * s + 8 * n)
    return bound(bytes_moved, 0, FP32_FLOPS, hashes * THREEFRY_INT_OPS + bits)


@phase("3c. threefry and the fleet draws: kernels vs plain")
def threefry_phase(torch, results):
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda, fleet_draws_plain
    from svoc_torch.ops.threefry import PER_THREAD, threefry_cuda, threefry_plain
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import draw_fleet

    dev = torch.device("cuda")
    card = nvidia_smi()
    gen = torch.Generator().manual_seed(0)
    worst = 0
    for what, b, n, xor, base in (
        ("one key, 2**20 counters, bits", 1, 1 << 20, True, 0),
        ("one key, 2**20 counters, pairs", 1, 1 << 20, False, 0),
        ("1024 keys x 50 counters, bits", 1024, 50, True, 0),
        ("57344 keys x 64 counters, bits (the kernels table's shape)", 57344, 64, True, 0),
        ("4096 keys x 3 counters from 2**32 - 2 (the high word)", 4096, 3, False, 2**32 - 2),
        ("64 keys x 9 counters, a base per key", 64, 9, False, None),
    ):
        keys = torch.randint(0, 2**32, (b, 2), generator=gen, dtype=torch.int64)
        base_cpu = torch.randint(0, 2**32, (b,), generator=gen, dtype=torch.int64) if base is None else base
        base_dev = base_cpu.to(dev) if base is None else base
        want = threefry_plain(keys, n, base_cpu, xor)
        got = threefry_cuda(keys.to(dev), n, base_dev, xor).cpu()
        worst = max(worst, (got - want).abs().max().item())
        check(torch.equal(got, want), f"{what}: kernel == plain, bit for bit")
    key_of = lambda seed: prng.PRNGKey(seed, dev)  # noqa: E731
    for what, fn, want in KNOWN_ANSWERS:
        got = fn(prng, key_of)
        if got.is_floating_point():
            got = got.view(torch.int32)
        check(got.tolist() == want, f"{what} == jax.random's {want}")

    # The fleet draws: the kernel against the composed draws on the card and on the CPU.
    worst_fleet = 0
    for what, c, w, m, n, f, s in FLEET_CASES:
        keys = torch.randint(0, 2**32, (c, 2), generator=gen, dtype=torch.int64)
        got = fleet_draws_cuda(keys.to(dev), w, m, n, f, s)
        on_card = fleet_draws_plain(keys.to(dev), w, m, n, f, s)
        on_cpu = fleet_draws_plain(keys, w, m, n, f, s)
        worst_fleet = max([worst_fleet] + [(g.cpu().double() - x.double()).abs().max().item()
                                           for g, x in zip(got, on_cpu) if x.numel()])
        check(all(g.dtype == x.dtype and torch.equal(g, y) and torch.equal(g.cpu(), x)
                  for g, y, x in zip(got, on_card, on_cpu)),
              f"fleet draws, {what} ([{c}] keys, W {w}, M {m}, N {n}, {f} failing, subsets of {s}): kernel == "
              f"plain on the card == plain on the CPU, bit for bit")
    key = prng.fold_in(key_of(0), 0)
    torch.cuda.synchronize()
    before = (fleet_draws_cuda.launches, threefry_cuda.launches)
    card_draws = draw_fleet(key, 50, 6, 1024, 128, 10)
    torch.cuda.synchronize()
    per_call = (fleet_draws_cuda.launches - before[0], threefry_cuda.launches - before[1])
    plain = draw_fleet(key.cpu(), 50, 6, 1024, 128, 10)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(card_draws, plain)) and per_call == (1, 0),
          f"the flagship's draw_fleet (N = 1024, W = 50, subsets of 10): card == CPU, bit for bit, "
          f"(fleet draws, threefry) launches {per_call} == (1, 0)")

    # Times, each beside its plain version and its bound; threefry's with the
    # parent's (--parent) between two readings of this tree's.
    ms, _ = threefry_times(torch)
    on_parent("threefry_times")
    threefry_times(torch)
    keys = prng.split(key_of(1), 57344)
    plain_ms = cuda_ms(torch, lambda: threefry_plain(keys, 64, xor=True), iters=5)
    counters = 57344 * 64
    bytes_moved = 16 * 57344 + 8 * counters  # keys read once, 32-bit words written as int64
    int_ops = counters * (THREEFRY_INT_OPS + 1)  # bits: each counter's two words xored
    bound_ms, bound_by = bound(bytes_moved, 0, FP32_FLOPS, int_ops)
    built = sass_counts("threefry", "threefry_kernel")
    print(f"  [{card}] threefry at [57344 keys, 64 counters]: plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}; {bytes_moved} bytes, {int_ops} INT32 operations); the built kernel's SASS ({PER_THREAD} "
          f"counters a thread): {dict(sorted(built.items(), key=lambda kv: -kv[1]))}", flush=True)
    rotates, xors = ((built.get("SHF", 0) + built.get("PRMT", 0)) / PER_THREAD, built.get("LOP3", 0) / PER_THREAD)
    check(rotates >= THREEFRY_INT_OPS // 2 and xors >= THREEFRY_INT_OPS // 2 + 1,
          f"the built threefry kernel issues at least the hash's {THREEFRY_INT_OPS // 2} rotates and "
          f"{THREEFRY_INT_OPS // 2} + 1 xors a counter that the bound counts: SHF and PRMT {rotates}, LOP3 {xors}")
    results["threefry"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=None)
    for what, c, w, m, n, f, s in FLEET_CASES[:2]:
        keys = prng.split(key_of(2), c)
        k_ms = cuda_ms(torch, lambda: fleet_draws_cuda(keys, w, m, n, f, s), iters=200)
        k_dev = profiled_ms(torch, lambda: fleet_draws_cuda(keys, w, m, n, f, s), "fleet_draws_kernel")
        p_ms = cuda_ms(torch, lambda: fleet_draws_plain(keys, w, m, n, f, s), iters=50)
        p_ops = device_ops(torch, lambda: fleet_draws_plain(keys, w, m, n, f, s))
        b_ms, b_by = fleet_bound(c, w, m, n, f, s)
        print(f"  [{card}] fleet draws, {what}: kernel {k_ms:.4f} ms (CUDA events, 200 launches), "
              f"{k_dev if k_dev is None else f'{k_dev:.4f}'} ms (profiler device time); the composed path it "
              f"replaces {p_ms:.4f} ms ({p_ops} device operations a call); bound {b_ms:.6f} ms ({b_by})",
              flush=True)
        if c == 1:
            results["fleet_draws"] = dict(max_abs_err=worst_fleet, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                          bound_by=b_by, library_ms=None)


@phase("4a. small serving step: card vs CPU")
def small_step_phase(torch):
    import contextlib

    from svoc_torch.flagship import FlagshipStep, comment_stream, packed_comment_stream
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.encoder import init_params
    from svoc_torch.sim.prng import PRNGKey

    params = init_params(TINY_TEST, seed=3, device="cpu")
    kw = dict(rows=16, seq=32, max_seg=4, n_oracles=64, params_dtype=None, params=params)
    for variant in ("packed_flash", "packed", "dense"):
        card = FlagshipStep(TINY_TEST, variant=variant, device="cuda", **kw)
        cpu = FlagshipStep(TINY_TEST, variant=variant, device="cpu", **kw)
        # The feed's own generator on this thread (4b drives it in its
        # worker process): a spawned worker a variant would pay a fresh
        # interpreter's import of torch, for a single TINY batch.
        source = SyntheticSource(batch=16, seed=5)
        feed = (packed_comment_stream(card.pipe.tokenizer, source, 16, 32, 4) if card.packed
                else comment_stream(card.pipe.tokenizer, source, 16, 32))
        with contextlib.closing(feed):
            batch, _ = next(feed)
        w_card, w_cpu = card.window(batch), cpu.window(batch)
        out_card, _ = card(batch, PRNGKey(1, "cuda"))
        out_cpu, _ = cpu(batch, PRNGKey(1, "cpu"))
        w_err = (w_card.cpu() - w_cpu).abs().max().item()
        e_err = (out_card.essence.cpu() - out_cpu.essence).abs().max().item()
        check(w_err <= 1e-4,
              f"TINY_TEST f32 {variant} window: card vs CPU max err {w_err:.3e} <= 1e-4")
        check(torch.equal(out_card.reliable.cpu(), out_cpu.reliable) and e_err <= 1e-5,
              f"TINY_TEST {variant} consensus: mask exact, essence err {e_err:.3e} <= 1e-5")


@phase("4b. main path: full-width packed-flash serving step")
def main_path_phase(torch, launches):
    import numpy as np

    from svoc_torch.flagship import FlagshipStep, pack_stream, token_lists
    from svoc_torch.io.pipeline import DevicePut
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.packing import pack_tokens, pack_tokens_auto
    from svoc_torch.models.tokenizer import HashingTokenizer
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_plain
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import assemble_fleet

    step = FlagshipStep(device="cuda")  # ROBERTA_GO_EMOTIONS, bf16 weights
    n_layers = step.pipe.cfg.n_layers
    rows, seq, max_seg, pad = step.rows, step.seq, step.max_seg, step.pipe.tokenizer.pad_id
    split = dict(source=0.0, tokenize=0.0, pack=0.0)

    def timed(stage, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            split[stage] += time.perf_counter() - t0
            return out
        return run

    def serial_native_feed():
        """Tokenize, pack and copy on this thread, each stage timed."""
        put = DevicePut("cuda", slots=2)
        batches = pack_stream(
            token_lists(timed("tokenize", step.pipe.tokenizer),
                        timed("source", SyntheticSource(batch=rows, seed=0)), seq),
            rows, seq, max_seg, pad, pack=timed("pack", pack_tokens_auto))
        for item in batches:
            staged, n = put(item)
            yield staged.wait(), n

    def drive(feeds, n_steps):
        """One warm-up step and ``n_steps`` timed steps on each of
        ``feeds``, the feeds taking turns step by step, so that a host
        whose speed drifts over the phase moves every feed's readings
        alike.  Each feed is keyed by the reference's chain: PRNGKey(0),
        then key = fold_in(key, s)."""
        keys = [prng.PRNGKey(0, "cuda") for _ in feeds]
        runs = [dict(essences=[], rows=[], rel2=[], batches=[]) for _ in feeds]
        for i in range(1 + n_steps):
            for f, (feed, run) in enumerate(zip(feeds, runs)):
                for stage in split:
                    split[stage] = 0.0
                t0 = time.perf_counter()
                batch, n_comments = next(feed)
                t1 = time.perf_counter()
                run["batches"].append(batch)
                keys[f] = prng.fold_in(keys[f], i)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                window = step.window(batch)
                ev[1].record()
                out, honest = step.consensus(window, step.draws(keys[f]))
                ev[2].record()
                essence = out.essence.cpu()  # fetched to the host: the step is done
                t2 = time.perf_counter()
                run["essences"].append(tuple(essence.tolist()))
                run["rel2"].append(out.reliability_second_pass.item())
                run["rows"].append(dict(feed_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                                        source_ms=split["source"] * 1e3, tokenize_ms=split["tokenize"] * 1e3,
                                        pack_ms=split["pack"] * 1e3,
                                        forward_ms=ev[0].elapsed_time(ev[1]),
                                        consensus_ms=ev[1].elapsed_time(ev[2]), comments=n_comments))
        return runs, (window, out, honest)

    counted = (flash_attention_cuda, fused_consensus_cuda, threefry_cuda, fleet_draws_cuda, flash_dq_cuda,
               flash_dkv_cuda)
    torch.cuda.synchronize()
    for wrapper in counted:
        wrapper.launches = 0
    # The serial feed and the overlapped one (its worker process running
    # beside the step), step by step on the same comments.  The overlapped
    # feed copies each batch as it is taken and freezes the heap it starts
    # on (io/pipeline.py::staged_stream), for any caller of
    # FlagshipStep.comments.
    feed = step.comments(SyntheticSource(batch=rows, seed=0))
    (serial, fed_run), (window, out, honest) = drive([serial_native_feed(), feed], OVERLAP_STEPS)
    serial_essences, serial_rows = serial["essences"], serial["rows"]
    essences, rows_run, rel2_run, staged = fed_run["essences"], fed_run["rows"], fed_run["rel2"], fed_run["batches"]
    launches["flash_attention"] = flash_attention_cuda.launches
    launches["fused_consensus"] = fused_consensus_cuda.launches
    launches["threefry"] = threefry_cuda.launches
    launches["fleet_draws"] = fleet_draws_cuda.launches
    backward = (flash_dq_cuda.launches, flash_dkv_cuda.launches)

    steps = 2 * (1 + OVERLAP_STEPS)
    check(launches["flash_attention"] == n_layers * steps,
          f"flash kernel launches {launches['flash_attention']} == {n_layers} x {steps} steps")
    check(launches["fused_consensus"] == steps,
          f"consensus kernel launches {launches['fused_consensus']} == {steps} steps")
    check(launches["threefry"] == steps and launches["fleet_draws"] == steps,
          f"threefry launches {launches['threefry']} == {steps} steps (the fold_in), fleet-draws launches "
          f"{launches['fleet_draws']} == {steps} (the fleet)")
    check(backward == (0, 0), f"backward kernel launches while serving (dq, dk/dv) {backward} == (0, 0)")
    check(len(set(essences)) == 1 + OVERLAP_STEPS, f"{1 + OVERLAP_STEPS} distinct essences on distinct batches")
    check(essences == serial_essences,
          "the overlapped feed's steps give the serial native feed's essences, step for step")
    e = torch.tensor(essences)
    check(bool(torch.isfinite(e).all()) and e.shape == (1 + OVERLAP_STEPS, 6),
          f"essences finite, shape {tuple(e.shape)}")
    check(int(out.reliable.sum()) == 1024 - step.ccfg.n_failing and honest.shape == (1024,),
          f"last step: {int(out.reliable.sum())} reliable of 1024")
    values, _ = assemble_fleet(window, *step.draws(prng.PRNGKey(99, "cuda")))
    ref = fused_consensus_plain(values, step.ccfg)
    got = fused_consensus_cuda(values.contiguous(), step.ccfg)
    check(torch.equal(ref.reliable, got.reliable)
          and (ref.essence - got.essence).abs().max().item() <= 1e-5,
          "a full-width fleet of the last window: kernel consensus == plain")
    python_tok = HashingTokenizer(step.pipe.cfg.vocab_size, pad_id=pad, max_len=seq)
    python_feed = pack_stream(token_lists(python_tok, SyntheticSource(batch=rows, seed=0), seq),
                              rows, seq, max_seg, pad, pack=pack_tokens)
    same = all(np.array_equal(a.cpu().numpy(), b)
               for batch in staged for a, b in zip(batch, next(python_feed)[0]))
    check(same, f"the overlapped feed's {len(staged)} batches == the serial Python feed's, bit for bit")

    card = nvidia_smi()
    mean = lambda rs, key: sum(r[key] for r in rs) / len(rs)  # noqa: E731
    for name, rs in (("serial native feed", serial_rows[1:]), ("overlapped feed", rows_run[1:])):
        n_comments = sum(r["comments"] for r in rs)
        wall_s = sum(r["feed_ms"] + r["step_ms"] for r in rs) / 1e3
        device_s = sum(r["step_ms"] for r in rs) / 1e3
        print(f"  [{card}] {name}, {len(rs)} timed steps (taking turns with the other feed): step "
              f"{mean(rs, 'step_ms'):.3f} ms (forward {mean(rs, 'forward_ms'):.3f} ms, consensus "
              f"{mean(rs, 'consensus_ms'):.3f} ms), feed wait {mean(rs, 'feed_ms'):.3f} ms; "
              f"{n_comments / len(rs):.1f} comments/step: {n_comments / wall_s:.1f} comments/s on the wall clock, "
              f"{n_comments / device_s:.1f} over the step alone")
    rs = serial_rows[1:]
    rest_ms = mean(rs, "feed_ms") - sum(mean(rs, f"{stage}_ms") for stage in split)
    print(f"  [{card}] the serial feed's split, host ms a step: source (SyntheticSource) "
          f"{mean(rs, 'source_ms'):.3f}, tokenize {mean(rs, 'tokenize_ms'):.3f}, pack "
          f"{mean(rs, 'pack_ms'):.3f}, copy and the rest (strip, buffer, pinned copy) {rest_ms:.3f}")
    # Paired: the mean of the fed forwards against the mean of the serial
    # ones, read in turns.  The spread: the gap between the serial
    # readings' first and second halves (what drift is left after the
    # pairing), but at least FORWARD_SPREAD of their mean, the forward's
    # spread between runs.
    alone = [r["forward_ms"] for r in serial_rows[1:]]
    fed = [r["forward_ms"] for r in rows_run[1:]]
    avg = lambda xs: sum(xs) / len(xs)  # noqa: E731
    half = len(alone) // 2
    first, second = avg(alone[:half]), avg(alone[half:])
    spread = max(abs(first - second), FORWARD_SPREAD * avg(alone))
    check(avg(fed) <= avg(alone) + spread,
          f"forward with the feed running {avg(fed):.3f} ms (mean of {len(fed)}) <= without it {avg(alone):.3f} "
          f"ms (mean of {len(alone)}, in turns with it; halves {first:.3f} and {second:.3f}) + the spread "
          f"{spread:.3f}")
    print("  serial per step: " + json.dumps(serial_rows))
    print("  overlapped per step: " + json.dumps(rows_run))
    batch, _ = next(feed)
    key = prng.PRNGKey(0, "cuda")
    profiled = profile_one_step(torch, lambda: step(batch, key)[0].essence.cpu())
    feed.close()
    return dict(step=step, essences=essences, rel2=rel2_run, rows=rows_run[1:], profiled=profiled)


@phase("4c. the packed, packed_int8 and dense flagship variants at full width")
def variants_phase(torch, launches):
    import numpy as np

    from svoc_torch.flagship import FlagshipStep, TokenBatch
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.packing import pack_tokens, strip_padding
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda
    from svoc_torch.sim import prng

    # One set of weights (seed 0, as phase 4b draws them): bf16 under the
    # three float variants; the int8 variant (bench.py --config 10, the
    # packed variant's W8A8 forward) folds the float32 ones.
    weights = init_params(ROBERTA_GO_EMOTIONS, seed=0, device="cuda")
    params = {k: v.bfloat16() for k, v in weights.items()}
    steps = {v: FlagshipStep(variant=v, params=params, device="cuda")
             for v in ("packed_flash", "packed", "dense")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps["packed_int8"] = FlagshipStep(variant="packed", quant="int8", params=weights, device="cuda")
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    del weights
    counted = (flash_attention_cuda, fused_consensus_cuda, flash_dq_cuda, flash_dkv_cuda)
    card = nvidia_smi()
    from svoc_torch.models.quant import QuantizedPackedSentimentEncoder, quantized_size_bytes

    qmodel = steps["packed_int8"].pipe.packed_model
    check(isinstance(qmodel, QuantizedPackedSentimentEncoder),
          f"packed_int8 runs the W8A8 forward ({type(qmodel).__name__})")
    print(f"  [{card}] packed_int8: folded from float32 in {fold_s:.3f} s (the step's build, the fold inside), "
          f"quantized weights {quantized_size_bytes(qmodel.qparams) / 2**20:.1f} MiB")
    # packed and packed_int8 share one packed feed (its worker's start is a
    # fresh interpreter's import of torch): packed_int8 takes the batches
    # that follow packed's.
    packed_feed = steps["packed"].comments(SyntheticSource(batch=256, seed=0))
    for variant in ("packed", "packed_int8", "dense"):
        step = steps[variant]
        feed = packed_feed if step.packed else step.comments(SyntheticSource(batch=256, seed=0))
        key = prng.PRNGKey(0, "cuda")
        torch.cuda.synchronize()
        for wrapper in counted:
            wrapper.launches = 0
        essences, rows = [], []
        for i in range(1 + MAIN_STEPS):
            t0 = time.perf_counter()
            batch, n_comments = next(feed)
            t1 = time.perf_counter()
            key = prng.fold_in(key, i)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            window = step.window(batch)
            ev[1].record()
            out, _ = step.consensus(window, step.draws(key))
            ev[2].record()
            essences.append(tuple(out.essence.cpu().tolist()))  # on the host: the step is done
            t2 = time.perf_counter()
            rows.append(dict(feed_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                             forward_ms=ev[0].elapsed_time(ev[1]),
                             consensus_ms=ev[1].elapsed_time(ev[2]), comments=n_comments))
        if variant != "packed":
            feed.close()
        counts = [w.launches for w in counted]
        launches["fused_consensus"] = launches.get("fused_consensus", 0) + counts[1]
        steps_run = 1 + MAIN_STEPS
        check(counts == [0, steps_run, 0, 0],
              f"{variant}: launches (flash, consensus, dq, dk/dv) {counts} == [0, {steps_run}, 0, 0]")
        e = torch.tensor(essences)
        check(len(set(essences)) == steps_run and bool(torch.isfinite(e).all())
              and int(out.reliable.sum()) == 1024 - step.ccfg.n_failing,
              f"{variant}: {steps_run} distinct finite essences on distinct batches, "
              f"{int(out.reliable.sum())} reliable of 1024")
        timed = rows[1:]
        mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
        n_comments = sum(r["comments"] for r in timed)
        print(f"  [{card}] {variant}: {len(timed)} timed steps: step {mean('step_ms'):.3f} ms "
              f"(forward {mean('forward_ms'):.3f} ms, consensus {mean('consensus_ms'):.3f} ms), "
              f"feed wait {mean('feed_ms'):.3f} ms; {n_comments / len(timed):.1f} comments/step, "
              f"{n_comments / (sum(r['step_ms'] for r in timed) / 1e3):.1f} comments/s over the step")
        print(f"  {variant} per step: " + json.dumps(rows))

    # One shared set of comments through all three forwards.
    pipe = steps["dense"].pipe
    texts = SyntheticSource(batch=256, seed=42)()
    ids, mask = pipe.tokenizer(texts, 128)
    batch, n = pack_tokens(strip_padding(ids, mask), 128, 8, pipe.tokenizer.pad_id, rows=256)
    valid = batch.seg_valid > 0
    owner = torch.from_numpy(batch.owner[valid].astype(np.int64)).to("cuda")
    arrays = [torch.from_numpy(a).to("cuda") for a in (batch.ids, batch.pos, batch.seg, batch.cls_pos)]
    vectors = {"dense": pipe.forward(*(torch.from_numpy(a).to("cuda") for a in TokenBatch(ids, mask)))}
    vecs_packed = steps["packed"].pipe.packed_forward(*arrays)
    for variant in ("packed", "packed_flash"):
        vecs = steps[variant].pipe.packed_forward(*arrays)
        by_comment = torch.empty_like(vectors["dense"])
        by_comment[owner] = vecs[torch.from_numpy(valid).to("cuda")]
        vectors[variant] = by_comment
    diffs = {f"{a} vs {b}": (vectors[a].float() - vectors[b].float()).abs().max().item()
             for a, b in (("packed", "dense"), ("packed_flash", "dense"), ("packed_flash", "packed"))}
    check(n == 256 and all(bool(torch.isfinite(v).all()) for v in vectors.values())
          and max(diffs.values()) <= VARIANT_BAR,
          f"256 shared comments, per-comment vectors in bf16: max differences {diffs} <= {VARIANT_BAR}")
    # The int8 variant against the packed bf16 forward on the same rows, at
    # the reference's bars (tests/test_quant.py): logits within
    # 0.15 max(1, |ref|), vectors within 0.05.
    seg_valid = torch.from_numpy(valid).to("cuda")
    with torch.inference_mode():
        ref_logits = steps["packed"].pipe.packed_model(*arrays)[seg_valid].float()
        int8_logits = steps["packed_int8"].pipe.packed_model(*arrays)[seg_valid].float()
    int8_vecs = steps["packed_int8"].pipe.packed_forward(*arrays)[seg_valid]
    logit_gap = (int8_logits - ref_logits).abs().max().item()
    logit_bar = 0.15 * max(1.0, ref_logits.abs().max().item())
    vec_gap = (int8_vecs.float() - vecs_packed[seg_valid].float()).abs().max().item()
    check(bool(torch.isfinite(int8_logits).all()) and logit_gap < logit_bar and vec_gap < 0.05,
          f"packed_int8 against packed bf16 on {int(seg_valid.sum())} segments: logits within {logit_gap:.4f} "
          f"(bar {logit_bar:.4f}), vectors within {vec_gap:.5f} (bar 0.05)")
    # Where the int8 forward's time goes, beside the bf16 one (informational).
    for variant in ("packed", "packed_int8"):
        print(f"  {variant}, one forward of the shared rows:")
        profile_one_step(torch, lambda: steps[variant].pipe.packed_forward(*arrays).cpu())


@phase("4d. the pipelined flagship step at full width")
def pipelined_phase(torch, launches, serving):
    """4b's step, comments and key chain, and the overlapped feed, run
    pipelined (``FlagshipStep.pipelined``): one priming forward, then
    OVERLAP_STEPS steps, each the forward of batch k beside the fleet and
    consensus of batch k-1 on the step's second stream, then the drain."""
    import warnings

    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.sim import prng

    if not check(serving is not None, "phase 4b ran (its essences are this phase's reference)"):
        return
    step = serving["step"]
    n_layers = step.pipe.cfg.n_layers
    counted = (flash_attention_cuda, fused_consensus_cuda, threefry_cuda, fleet_draws_cuda)
    # CUDA events around the forward inside the pipelined step, on the
    # caller's stream while the side stream runs the fleet and consensus.
    forward_ev = []
    window_of = step.window

    def timed_window(batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = window_of(batch)
        ev[1].record()
        forward_ev.append(ev)
        return out

    step.window = timed_window
    feed = step.comments(SyntheticSource(batch=step.rows, seed=0))
    try:
        torch.cuda.synchronize()
        for wrapper in counted:
            wrapper.launches = 0
        key = prng.fold_in(prng.PRNGKey(0, "cuda"), 0)
        batch, _ = next(feed)
        window, prev_key = step.window(batch), key  # the priming forward of batch 0
        essences, rel2s, rows, per_step = [], [], [], []
        for i in range(1, 1 + OVERLAP_STEPS):
            before = [w.launches for w in counted]
            t0 = time.perf_counter()
            batch, n_comments = next(feed)
            t1 = time.perf_counter()
            key = prng.fold_in(key, i)
            window_next, out, _ = step.pipelined(batch, prev_key, window)
            essence = out.essence.cpu()  # batch i-1's, on the host: the step is done
            t2 = time.perf_counter()
            essences.append(tuple(essence.tolist()))
            rel2s.append(out.reliability_second_pass.item())
            per_step.append([w.launches - b for w, b in zip(counted, before)])
            rows.append(dict(feed_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                             forward_ms=forward_ev[-1][0].elapsed_time(forward_ev[-1][1]),
                             comments=n_comments))
            window, prev_key = window_next, key
        before = [w.launches for w in counted]
        out, _ = step.drain(prev_key, window)
        essences.append(tuple(out.essence.cpu().tolist()))
        rel2s.append(out.reliability_second_pass.item())
        drained = [w.launches - b for w, b in zip(counted, before)]
        counts = [w.launches for w in counted]
        for name, n in zip(("flash_attention", "fused_consensus", "threefry", "fleet_draws"), counts):
            launches[name] = launches.get(name, 0) + n

        check(all(c == [n_layers, 1, 1, 1] for c in per_step) and drained == [0, 1, 0, 1],
              f"launches a pipelined step (flash, B2, threefry, fleet draws) {per_step[0]} == [{n_layers}, 1, 1, 1] "
              f"in all {OVERLAP_STEPS} steps, the drain {drained} == [0, 1, 0, 1]; in all {counts}")
        check(essences == serving["essences"] and rel2s == serving["rel2"],
              f"{len(essences)} essences and second-pass reliabilities == 4b's overlapped run, "
              f"step for step, one step later, bit for bit")

        # The side stream's path makes no host sync: any sync would put
        # the two streams back in one line.
        def syncs(fn):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            # Setting the mode also warns that it is a prototype: not a sync.
            return [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]

        def side():
            with torch.cuda.stream(step._side):
                step.drain(prev_key, window)

        side_syncs = syncs(side)
        check(not side_syncs, f"the fleet and consensus on the side stream make {len(side_syncs)} host "
                              f"syncs == 0 {[m[:80] for m in side_syncs]}")
        whole = syncs(lambda: step.pipelined(batch, prev_key, window))
        print(f"  host syncs in one whole pipelined step (informational): {len(whole)}")
        try:  # where the caller's stream syncs (informational)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            step.pipelined(batch, prev_key, window)
        except RuntimeError:
            frames = [f for f in traceback.extract_tb(sys.exc_info()[2]) if "svoc_torch" in f.filename]
            print("  the first sync: " + " <- ".join(f"{Path(f.filename).name}:{f.lineno} {f.line}"
                                                      for f in reversed(frames[-3:])))
        finally:
            torch.cuda.set_sync_debug_mode("default")

        card = nvidia_smi()
        mean = lambda rs, k: sum(r[k] for r in rs) / len(rs)  # noqa: E731
        for name, rs in (("4b overlapped, unpipelined", serving["rows"]), ("4d pipelined", rows)):
            n_comments = sum(r["comments"] for r in rs)
            wall_s = sum(r["feed_ms"] + r["step_ms"] for r in rs) / 1e3
            print(f"  [{card}] {name}, {len(rs)} timed steps: step {mean(rs, 'step_ms'):.3f} ms "
                  f"(forward {mean(rs, 'forward_ms'):.3f} ms by CUDA events), feed wait "
                  f"{mean(rs, 'feed_ms'):.3f} ms; {n_comments / wall_s:.1f} comments/s on the wall "
                  f"clock, {n_comments / (sum(r['step_ms'] for r in rs) / 1e3):.1f} over the step")
        print("  pipelined per step: " + json.dumps(rows))
        profiled = profile_one_step(torch, lambda: step.pipelined(batch, prev_key, window)[1].essence.cpu())
        idle = lambda p: f"{p['idle']:.3f} of {p['wall_ms']:.3f} ms" if p else "not measured"  # noqa: E731
        print(f"  [{card}] profiled step's idle share (informational): pipelined {idle(profiled)}, "
              f"4b's unpipelined {idle(serving['profiled'])}")
    finally:
        feed.close()
        del step.window  # back to the method


def profile_one_step(torch, run):
    """One more step, ``run()`` (which ends by fetching its result to the
    host), under ``torch.profiler``: device busy time, idle share within
    the step, and the kernels by device time. Informational: it runs
    after the launch counts are read and never fails the run."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # A user annotation (the optimizer's "Optimizer.step#..." range)
        # also shows on the device timeline; it spans kernels counted
        # on their own.
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]

        busy_ms = sum(device_us(e) for e in kernels) / 1e3
        print(f"  profiled step (informational): wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for e in sorted(kernels, key=device_us, reverse=True)[:12]:
            print(f"    {device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
        return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms)
    except Exception:  # the profiler is an observation, not a check
        traceback.print_exc()
        print("  profile unavailable (informational, not a check)")
        return None


def train_batch(torch, batch, n_comments, rng, n_labels, device):
    """A packed batch with multi-hot labels (density 0.05, about one
    label in 28 per comment, as go_emotions has) on ``device``."""
    from svoc_torch.models.packing import pack_labels
    from svoc_torch.train.trainer import PackedTrainBatch

    labels = (rng.random((n_comments, n_labels)) < 0.05).astype("float32")
    arrays = (batch.ids, batch.pos, batch.seg, batch.cls_pos, batch.seg_valid,
              pack_labels(batch, labels))
    return PackedTrainBatch(*(torch.from_numpy(a).to(device) for a in arrays))


def packed_state(torch, cfg, params, tx, device):
    """A fresh train state of the packed encoder holding float32 copies
    of ``params``."""
    from svoc_torch.models.packing import PackedSentimentEncoder
    from svoc_torch.train.trainer import init_state

    with torch.device("meta"):
        model = PackedSentimentEncoder(cfg)
    return init_state(model, params, tx, device=device)


@phase("5a. small train step: card vs CPU")
def small_train_phase(torch):
    import numpy as np

    from svoc_torch.flagship import pack_stream, token_lists
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.tokenizer import HashingTokenizer
    from svoc_torch.train.trainer import adamw, make_packed_train_step, sgd

    cfg = dataclasses.replace(TINY_TEST, attention="flash")
    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=32)
    batch, n = next(pack_stream(token_lists(tok, SyntheticSource(batch=16, seed=5), 32), 16, 32, 4,
                                tok.pad_id))
    params = init_params(cfg, seed=3, device="cpu")
    step = make_packed_train_step()
    # Bars from the card's own runs (NVIDIA H100 80GB HBM3): SGD's
    # parameters agree within 1.2e-7. AdamW's first step moves a weight
    # by about ±lr whatever the gradient's size, so a near-zero gradient
    # whose sign differs between card and CPU puts it up to 2 lr apart
    # (1.0e-5 measured at lr 1e-5).
    for name, tx, bar in (("SGD(0.1)", sgd(0.1), 1e-6), ("AdamW(1e-5)", adamw(1e-5), 2.5e-5)):
        ends = []
        for dev in ("cuda", "cpu"):
            state = packed_state(torch, cfg, params, tx, dev)
            tb = train_batch(torch, batch, n, np.random.default_rng(0), cfg.n_labels, dev)
            state, metrics = step(state, tb)
            ends.append((metrics["loss"].item(),
                         {k: p.detach().cpu() for k, p in state.model.named_parameters()}))
        (loss_card, p_card), (loss_cpu, p_cpu) = ends
        p_err = max((p_card[k] - p_cpu[k]).abs().max().item() for k in p_cpu)
        loss_err = abs(loss_card - loss_cpu)
        check(loss_err <= 1e-6 and p_err <= bar,
              f"TINY_TEST f32 {name} step: loss {loss_card:.7f} vs {loss_cpu:.7f} "
              f"(err {loss_err:.3e} <= 1e-6), max parameter err {p_err:.3e} <= {bar:g}")


@phase("5b. main path: full-width packed fine-tune steps")
def train_path_phase(torch, launches):
    import tempfile

    import numpy as np

    from svoc_torch.flagship import pack_stream, token_lists
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.tokenizer import HashingTokenizer
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.train.trainer import adamw, make_packed_train_step
    from svoc_torch.utils.checkpoint import restore_train_state, save_train_state

    cfg = dataclasses.replace(ROBERTA_GO_EMOTIONS, attention="flash")
    dev = torch.device("cuda")
    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=128)
    # A serial feed, between the timed steps: a feed thread would take the
    # GIL from the step's launches (phase 4b).
    feed = pack_stream(token_lists(tok, SyntheticSource(batch=256, seed=7), 128), 256, 128, 8,
                       tok.pad_id)
    rng = np.random.default_rng(0)

    def next_batch():
        batch, n = next(feed)
        return train_batch(torch, batch, n, rng, cfg.n_labels, dev), n, int((batch.seg > 0).sum())

    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)  # float32 master parameters
    state = packed_state(torch, cfg, params, adamw(1e-4), dev)
    step = make_packed_train_step()

    # CUDA events at the model's forward and the optimizer's step split a
    # step into forward, backward (loss, backward, grad norm) and update.
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    state.model.register_forward_pre_hook(lambda *_: mark("forward"))
    state.model.register_forward_hook(lambda *_: mark("backward"))
    state.optimizer.register_step_pre_hook(lambda *_: mark("update"))
    state.optimizer.register_step_post_hook(lambda *_: mark("end"))

    counted = (flash_attention_cuda, flash_dq_cuda, flash_dkv_cuda)
    qkv = [f"block_{i}.attention.{w}.weight" for i in range(cfg.n_layers)
           for w in ("query", "key", "value")]
    fixed, _, _ = next_batch()
    torch.cuda.synchronize()
    for wrapper in counted:
        wrapper.launches = 0
    rows, per_step = [], []
    for i in range(1 + MAIN_STEPS + FIXED_STEPS):
        tb, n_comments, n_tokens = next_batch() if i <= MAIN_STEPS else (fixed, 0, 0)
        before = [w.launches for w in counted]
        if i == 0:
            start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        t0 = time.perf_counter()
        state, metrics = step(state, tb)
        loss, grad_norm = metrics["loss"].item(), metrics["grad_norm"].item()  # on the host: done
        t1 = time.perf_counter()
        per_step.append(tuple(w.launches - b for w, b in zip(counted, before)))
        rows.append(dict(step_ms=(t1 - t0) * 1e3, loss=loss, grad_norm=grad_norm,
                         forward_ms=events["forward"].elapsed_time(events["backward"]),
                         backward_ms=events["backward"].elapsed_time(events["update"]),
                         update_ms=events["update"].elapsed_time(events["end"]),
                         comments=n_comments, tokens=n_tokens))
        if i == 0:
            moved = [k for k, p in state.model.named_parameters() if not torch.equal(p, start[k])]
            params_of = dict(state.model.named_parameters())
            check(len(moved) == len(start),
                  f"first step moved {len(moved)} of {len(start)} parameter tensors")
            check(all(bool(params_of[k].grad.abs().sum() > 0) and k in moved for k in qkv),
                  f"all {len(qkv)} query/key/value projections got a gradient and moved")
            del start
    steps = len(rows)
    for wrapper, name in zip(counted, ("flash_attention", "flash_dq", "flash_dkv")):
        launches[name] = launches.get(name, 0) + wrapper.launches
    check(all(c == (cfg.n_layers,) * 3 for c in per_step),
          f"every step launched flash forward, dq and dk/dv {cfg.n_layers} times each "
          f"({steps} steps; totals {[w.launches for w in counted]})")

    distinct = rows[: 1 + MAIN_STEPS]
    losses = [r["loss"] for r in rows]
    check(all(math.isfinite(x) for x in losses)
          and len({r["loss"] for r in distinct}) == len(distinct),
          f"finite losses, distinct on {len(distinct)} distinct batches")
    check(all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in rows),
          "finite, positive grad norms")
    on_fixed = losses[1 + MAIN_STEPS:]
    check(on_fixed[-1] < FIXED_LOSS_RATIO * on_fixed[0],
          f"loss on one fixed batch over {FIXED_STEPS} steps: {on_fixed[0]:.5f} -> "
          f"{on_fixed[-1]:.5f} (< {FIXED_LOSS_RATIO} x the first)")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.pt")
        save_train_state(path, state)
        restored = restore_train_state(path, packed_state(torch, cfg, params, adamw(1e-4), dev))
    saved_opt, restored_opt = state.optimizer.state_dict(), restored.optimizer.state_dict()
    same = (restored.step == state.step
            and all(torch.equal(p, q) for p, q in zip(state.model.parameters(), restored.model.parameters()))
            and all(torch.equal(saved_opt["state"][i][key], restored_opt["state"][i][key])
                    for i in saved_opt["state"] for key in saved_opt["state"][i]))
    check(same, f"save -> restore at step {state.step}: parameters and optimizer state exact")
    del restored, saved_opt, restored_opt

    timed = rows[1: 1 + MAIN_STEPS]
    mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
    step_s = sum(r["step_ms"] for r in timed) / 1e3
    card = nvidia_smi()
    print(f"  [{card}] {len(timed)} timed steps: step {mean('step_ms'):.3f} ms (forward "
          f"{mean('forward_ms'):.3f} ms, backward {mean('backward_ms'):.3f} ms, AdamW update "
          f"{mean('update_ms'):.3f} ms)")
    print(f"  [{card}] trained {sum(r['comments'] for r in timed) / step_s:.1f} comments/s, "
          f"{sum(r['tokens'] for r in timed) / step_s:.1f} live tokens/s over the step; "
          f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print("  per step: " + json.dumps(rows))
    tb, _, _ = next_batch()
    profile_one_step(torch, lambda: step(state, tb)[1]["loss"].item())


def claim_names(n: int):
    """The fabric scenario's claim ids (``svoc_tpu/fabric/scenario.py``)."""
    first = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")
    return list(first[:n]) + [f"claim{i}" for i in range(len(first), n)]


@phase("6. main path: full-width multi-claim serving step")
def claims_path_phase(torch, launches):
    import numpy as np

    from svoc_torch.consensus.batch import pad_claim_cube
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.ops.fused_consensus import (
        fused_consensus_cuda, fused_consensus_gated_claims_cuda, fused_consensus_gated_claims_plain,
    )
    from svoc_torch.apps.session import fleet_block
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.robustness.sanitize import QuarantineGate, SanitizeConfig, quarantine_mask_claims
    from svoc_torch.serving.batcher import ClaimQueues
    from svoc_torch.serving.tier import ClaimServingStep
    from svoc_torch.sim import prng
    from svoc_torch.sim.generators import claim_seed

    names = claim_names(CLAIMS)
    offender, slot = names[-1], ORACLES - 1
    rotation = ("nan", "inf", "range")

    def kind_of(cycle):  # the first step clean, then the rotation
        return None if cycle == 0 else rotation[(cycle - 1) % len(rotation)]

    def tamper(cycle, block):  # fabric/scenario.py:140-152, on slot N-1: a host float64 block
        kind = kind_of(cycle)
        if kind is None:
            return block
        block = np.array(block, copy=True)
        if kind == "nan":
            block[slot, 0] = np.nan
        elif kind == "inf":
            block[slot, :] = np.inf
        else:
            block[slot, :] = 7.5  # out of the constrained [0, 1] domain
        return block

    def specs(tampered):
        return [ClaimSpec(cid, seed=claim_seed(0, cid), n_oracles=ORACLES, n_failing=ORACLES // 8,
                          tamper=tamper if tampered and cid == offender else None)
                for cid in names]

    counted = {"flash_attention": flash_attention_cuda, "gated_claims_consensus":
               fused_consensus_gated_claims_cuda, "fused_consensus": fused_consensus_cuda,
               "flash_dq": flash_dq_cuda, "flash_dkv": flash_dkv_cuda, "threefry": threefry_cuda,
               "fleet_draws": fleet_draws_cuda}

    def run(step, timed):
        """CLAIM_STEPS steps on fresh per-claim comment sources; the
        results of each, and (when timed) one row of times per step."""
        sources = {cid: SyntheticSource(batch=REQUESTS_PER_CLAIM, seed=claim_seed(0, cid))
                   for cid in names}
        queues = ClaimQueues(names)
        results, rows, per_step = [], [], []
        for _ in range(CLAIM_STEPS):
            for cid in names:
                for text in sources[cid]():
                    queues.submit(cid, text)
            requests = queues.assemble(CLAIMS * REQUESTS_PER_CLAIM)
            before = {k: w.launches for k, w in counted.items()}
            t0 = time.perf_counter()
            batch = step.pack(requests)
            t1 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            vectors = step.forward(batch)
            ev[1].record()
            groups = step.fleets(requests, vectors)
            ev[2].record()
            (res,) = step.consensus(groups)
            ev[3].record()
            essence = res.out.essence.cpu()  # fetched to the host: the step is done
            t2 = time.perf_counter()
            per_step.append({k: w.launches - before[k] for k, w in counted.items()})
            results.append((res, essence))
            if timed:
                rows.append(dict(feed_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                                 forward_ms=ev[0].elapsed_time(ev[1]),
                                 fleets_ms=ev[1].elapsed_time(ev[2]),
                                 consensus_ms=ev[2].elapsed_time(ev[3]),
                                 requests=len(requests), claims=len(res.claims)))
        return results, rows, per_step

    step = ClaimServingStep(specs(True), device="cuda")  # ROBERTA_GO_EMOTIONS, bf16 weights
    n_layers = step.pipe.cfg.n_layers
    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = 0
    results, rows, per_step = run(step, timed=True)
    for name in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
        launches[name] = launches.get(name, 0) + counted[name].launches
    # threefry: one split of the fed claims' keys; the fleet draws once for the
    # one batch of fleets (every claim is fed 8 requests a step, so all share
    # a window bucket).
    want = dict(flash_attention=n_layers, gated_claims_consensus=1, fused_consensus=0,
                flash_dq=0, flash_dkv=0, threefry=1, fleet_draws=1)
    check(all(c == want for c in per_step),
          f"every step launched {want} ({CLAIM_STEPS} steps; totals "
          f"{ {k: w.launches for k, w in counted.items()} })")

    gate = QuarantineGate(SanitizeConfig.for_consensus(True))
    cfg = specs(False)[0].consensus_config()
    for i, (res, essence) in enumerate(results):
        kind = kind_of(i)
        report = gate.inspect(res.blocks[-1])
        check(res.claims == tuple(names) and bool(res.ok[:-1].all()),
              f"step {i + 1}: {len(res.claims)} claims in registration order, "
              f"every sibling oracle admitted")
        if kind is None:
            check(bool(res.ok[-1].all()) and report.clean, f"step {i + 1} (clean): offender all admitted")
            continue
        admitted = int(res.ok[-1].sum())
        check(not bool(res.ok[-1, slot]) and not bool(res.out.reliable[-1, slot])
              and admitted == ORACLES - 1 and report.reasons == {slot: kind}
              and bool(torch.isfinite(res.out.essence[-1]).all())
              and bool(torch.isfinite(res.out.essence_first_pass[-1]).all())
              and bool(res.out.interval_valid[-1]),
              f"step {i + 1} ({kind}): slot {slot} quarantined and unreliable, host gate "
              f"{report.reasons}, {admitted} admitted, finite essences, valid")

    res = results[-1][0]
    values, ok, mask = pad_claim_cube(torch.stack(res.blocks))
    plain_ok = quarantine_mask_claims(values, 0.0, 1.0)
    plain = fused_consensus_gated_claims_plain(values, plain_ok, mask, cfg)
    good, errs, _ = gated_errors(torch, res.out, type(plain)(*(f[:CLAIMS] for f in plain)))
    check(good and torch.equal(plain_ok[:CLAIMS], res.ok),
          "last step's cube through the plain gate and consensus: "
          + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
    essences = torch.stack([e for _, e in results])  # [steps, claims, 6]
    distinct = len({tuple(r) for r in essences.reshape(-1, 6).tolist()})
    check(distinct == CLAIM_STEPS * CLAIMS and bool(torch.isfinite(essences).all()),
          f"{distinct} distinct finite essences over {CLAIM_STEPS} steps x {CLAIMS} claims")

    clean = ClaimServingStep(specs(False), pipe=step.pipe)
    clean_results, _, _ = run(clean, timed=False)
    same = all(torch.equal(getattr(a[0].out, f)[:-1], getattr(b[0].out, f)[:-1])
               for a, b in zip(results, clean_results) for f in a[0].out._fields)
    check(same, f"{CLAIMS - 1} sibling claims bit for bit the same with and without the tamper, "
                f"{CLAIM_STEPS} steps, every output field")

    timed = rows[-CLAIM_TIMED:]
    mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
    step_s = sum(r["step_ms"] for r in timed) / 1e3
    b3_ms = cuda_ms(torch, lambda: fused_consensus_gated_claims_cuda(values, plain_ok, mask, cfg),
                    iters=50)
    card = nvidia_smi()
    print(f"  [{card}] steps {CLAIM_STEPS - CLAIM_TIMED + 1}-{CLAIM_STEPS}: step {mean('step_ms'):.3f} ms "
          f"(forward {mean('forward_ms'):.3f} ms, fleets {mean('fleets_ms'):.3f} ms, gate + "
          f"consensus {mean('consensus_ms'):.3f} ms), host feed {mean('feed_ms'):.3f} ms")
    print(f"  [{card}] {sum(r['requests'] for r in timed) / step_s:.1f} requests/s, "
          f"{sum(r['claims'] for r in timed) / step_s:.1f} claims/s over the step; the claim-cube "
          f"kernel {b3_ms:.4f} ms on the last cube, {100 * b3_ms / mean('step_ms'):.2f} % of the step")
    print("  per step: " + json.dumps(rows))
    sources = {cid: SyntheticSource(batch=REQUESTS_PER_CLAIM, seed=1) for cid in names}
    queues = ClaimQueues(names)
    for cid in names:
        for text in sources[cid]():
            queues.submit(cid, text)
    requests = queues.assemble(CLAIMS * REQUESTS_PER_CLAIM)
    vectors = clean.forward(clean.pack(requests))
    counts = device_ops(torch, lambda: clean.fleets(requests, vectors))
    print(f"  [{card}] one fleets() call of {CLAIMS} claims: {counts} device operations (profiler)")
    profile_one_step(torch, lambda: clean(requests)[0].out.essence.cpu())

    spec = specs(False)[0]
    keys = prng.split(prng.PRNGKey(5, "cuda"), CLAIMS)
    windows = torch.rand(CLAIMS, 64, 6, device="cuda", generator=torch.Generator(device="cuda").manual_seed(5))
    batched, _ = fleet_block(keys, windows, spec, 10)
    one_by_one = [fleet_block(keys[c], windows[c], spec, 10)[0] for c in range(CLAIMS)]
    check(all(torch.equal(batched[c], one) for c, one in enumerate(one_by_one)),
          f"one batched fleet build of {CLAIMS} claims == {CLAIMS} one-claim builds, bit for bit")
    batched_ms = cuda_ms(torch, lambda: fleet_block(keys, windows, spec, 10), iters=10)
    loop_ms = cuda_ms(torch, lambda: [fleet_block(keys[c], windows[c], spec, 10) for c in range(CLAIMS)],
                      iters=3)
    print(f"  [{card}] {CLAIMS} claims' fleets (N = {ORACLES}, W = 64): one batched build "
          f"{batched_ms:.3f} ms, {CLAIMS} one-claim builds {loop_ms:.3f} ms (CUDA events)")


@phase("7. the probe path (svoc_torch.tools.probe)")
def probe_phase(torch, launches):
    from svoc_torch.ops.grid_copy import grid_copy_cuda
    from svoc_torch.tools import probe

    before = grid_copy_cuda.launches
    t0 = time.perf_counter()
    rc = probe.main(["--timeout", str(PROBE_TIMEOUT_S), "--consensus-sizes",
                     ",".join(map(str, PROBE_CONSENSUS_SIZES)), "--jobs", str(PROBE_JOBS)])  # prints each record
    elapsed = time.perf_counter() - t0
    records = json.loads((Path(probe.REPO) / "GPU_PROBE.json").read_text())
    by_name = {r["probe"]: r for r in records}
    jobs = [r.get("jobs") for r in records]
    check(rc == 0 and tuple(r["probe"] for r in records) == PROBE_RECORDS
          and jobs == [None] + [PROBE_JOBS] * (len(records) - 1),
          f"probe.main returned {rc}; GPU_PROBE.json holds {[r['probe'] for r in records]} in record order, "
          f"each after the canary marked run {PROBE_JOBS} at a time ({jobs}; {elapsed:.1f} s)")
    for r in records:
        check(r.get("ok") is True and not r.get("timeout"),
              f"{r['probe']}: ok ({r.get('elapsed_s')} s)"
              + ("" if r.get("ok") else f" {r.get('stderr_tail') or r.get('stdout_tail')}"))
    if len(by_name) != len(PROBE_RECORDS) or not all(r.get("ok") for r in records):
        return
    counts = {name: r["launches"] for name, r in by_name.items()}
    check(by_name["backend"]["platform"] == "gpu"
          and by_name["backend"]["device_kind"] == torch.cuda.get_device_name(0),
          f"backend: {by_name['backend']['device_kind']}, {by_name['backend']['nvidia_smi']}")
    check(by_name["grid_copy"]["correct"] is True and counts["grid_copy"]["grid_copy"] >= 1,
          f"grid_copy: correct, {counts['grid_copy']['grid_copy']} launches in its interpreter, "
          f"build {by_name['grid_copy']['build_s']} s, copy {by_name['grid_copy']['copy_ms']} ms")
    for n in PROBE_CONSENSUS_SIZES:
        r = by_name[f"consensus{n}"]
        check(r["essence_match"] is True and r["n_oracles"] == n
              and counts[f"consensus{n}"]["fused_consensus"] >= 1,
              f"consensus{n}: essence_match, kernel {r['kernel_ms']} ms, plain {r['plain_ms']} ms")
    r = by_name["flash512"]
    check(r["match_dense"] is True and counts["flash512"]["flash_attention"] >= 1,
          f"flash512: match_dense (max diff {r['max_abs_diff']:.3e}, dtype bound {r['dtype_bound']}, "
          f"within the 2e-5 float32 bar: {r['within_f32_bar']}), flash {r['flash_ms']} ms, "
          f"dense {r['dense_ms']} ms")
    forwards = 18  # the first call, one warm call and 16 timed calls
    check(counts["encoder512_dense"]["flash_attention"] == 0
          and counts["encoder512_flash"]["flash_attention"] == 12 * forwards,
          f"encoder512: flash launches dense {counts['encoder512_dense']['flash_attention']} == 0, "
          f"flash {counts['encoder512_flash']['flash_attention']} == 12 x {forwards}; forward "
          f"dense {by_name['encoder512_dense']['forward_ms']} ms, "
          f"flash {by_name['encoder512_flash']['forward_ms']} ms")
    check(grid_copy_cuda.launches == before,
          "the probes ran in their own interpreters (no launch counted in this one)")
    inside = {k: sum(c.get(k, 0) for c in counts.values()) for k in KERNEL_ROWS}  # no probe draws
    for kernel in KERNEL_ROWS:
        launches[kernel] = launches.get(kernel, 0) + inside[kernel]
    print(f"  [{nvidia_smi()}] launches inside the probes: "
          + json.dumps({k: v for k, v in inside.items() if v}))


def band_rejects(margins) -> dict:
    """How many prefixes of a sweep fall inside each of ``certify``'s
    guard bands (``svoc_torch.consensus.batch.CertifyMargins``)."""
    from svoc_torch.consensus.batch import CertifyMargins
    from svoc_torch.ops.fixedpoint import WSAD

    bands = CertifyMargins()
    host = {name: value.double().cpu().numpy() for name, value in margins._asdict().items()}

    def in_sqrt_band(a):
        return int(((a * WSAD >= bands.sqrt_band_lo) & (a * WSAD <= bands.sqrt_band_hi)).sum())

    return dict(rel=int(((host["rel1"] <= bands.rel) | (host["rel2"] <= bands.rel)).sum()),
                sqrt1=in_sqrt_band(host["sqrt_arg1"]), sqrt2=in_sqrt_band(host["sqrt_arg2"]),
                variance=int((host["min_variance"] * WSAD <= bands.variance).sum()),
                boundary_gap=int((host["boundary_gap"] <= bands.boundary_gap).sum()))


def contract_state(contract) -> dict:
    """Every field of a contract simulator, as plain Python values."""
    return dict(active=contract.consensus_active, value=list(contract.consensus_value),
                rel1=contract.reliability_first_pass, rel2=contract.reliability_second_pass,
                skew=list(contract.skewness), kurt=list(contract.kurtosis),
                oracles=[(o.address, o.enabled, o.reliable, list(o.value)) for o in contract.oracles])


@phase("8. the commit path: the flagship's fleet on chain")
def commit_path_phase(torch, launches):
    import numpy as np

    from svoc_torch.consensus import batch as sweep_module
    from svoc_torch.consensus import wsad_engine
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.consensus.state import OracleConsensusContract
    from svoc_torch.flagship import FlagshipStep, pack_stream, token_lists
    from svoc_torch.io.chain import ChainAdapter, ChainCommitError, LocalChainBackend
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.fixedpoint import WSAD, to_wsad_rows
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus, fused_consensus_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import assemble_fleet, draw_fleet

    card = nvidia_smi()
    step = FlagshipStep(device="cuda")  # ROBERTA_GO_EMOTIONS, phase 4b's seeded bf16 weights, packed_flash
    n_layers, n, n_failing = step.pipe.cfg.n_layers, step.n_oracles, step.ccfg.n_failing
    tok = step.pipe.tokenizer
    feed = pack_stream(token_lists(tok, SyntheticSource(batch=step.rows, seed=0), step.seq),
                       step.rows, step.seq, step.max_seg, tok.pad_id)

    # Every sweep the contracts run, with its K, device and CUDA-event time.
    sweeps = []
    real_sweep = sweep_module.prefix_margins_sweep

    def timed_sweep(old, new, pos, cfg, ks):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_sweep(old, new, pos, cfg, ks)
        ev[1].record()
        ev[1].synchronize()
        sweeps.append(dict(k=int(ks.numel()), device=old.device.type, ms=ev[0].elapsed_time(ev[1]),
                           rejects=band_rejects(out)))
        return out

    sweep_module.prefix_margins_sweep = timed_sweep
    try:
        # (a) One step's 1024-oracle fleet a cycle, committed through the adapter.
        contract = OracleConsensusContract([0xA0, 0xA1, 0xA2], [0x1000 + i for i in range(n)],
                                           n_failing_oracles=n_failing, constrained=True, dimension=6,
                                           device="cuda")
        adapter = ChainAdapter(LocalChainBackend(contract))
        golden = [0]
        real_golden = contract._golden_recompute

        def counted_golden(values):
            golden[0] += 1
            return real_golden(values)

        contract._golden_recompute = counted_golden
        refusals = []
        backend = adapter.backend
        real_batch = backend.invoke_update_predictions_batch

        def recorded_batch(*args, **kwargs):
            try:
                return real_batch(*args, **kwargs)
            except Exception as e:
                refusals.append(f"{type(e).__name__}: {e}")
                raise

        backend.invoke_update_predictions_batch = recorded_batch
        counted = (flash_attention_cuda, fused_consensus_cuda, threefry_cuda, fleet_draws_cuda)
        torch.cuda.synchronize()
        for wrapper in counted:
            wrapper.launches = 0
        key = prng.PRNGKey(0, "cuda")
        for cycle in range(2):
            batch, _ = next(feed)
            key = prng.fold_in(key, cycle)
            values, _ = assemble_fleet(step.window(batch), *step.draws(key))
            out = fused_consensus(values.contiguous(), step.ccfg)  # B2
            host = torch.cat([values.reshape(-1), out.essence, out.reliable.float()]).cpu()  # one fetch
            fleet = host[: n * 6].reshape(n, 6).double().numpy()
            b2_essence, b2_reliable = host[n * 6: n * 6 + 6].tolist(), (host[n * 6 + 6:] > 0).tolist()
            ints = to_wsad_rows(fleet)
            rel_rows = [row for row, ok in zip(ints, b2_reliable) if ok]
            means = wsad_engine.nd_average(rel_rows)
            min_var = min(wsad_engine.nd_component_wise_variance(rel_rows, means))
            print(f"  [{card}] cycle {cycle}: the smallest reliable-subset variance (B2's mask, the "
                  f"committed ints) {min_var} wsad units", flush=True)
            golden[0], refusals[:], first_sweep = 0, [], len(sweeps)
            t0 = time.perf_counter()
            try:
                sent, err = adapter.update_all_the_predictions(fleet), None
            except ChainCommitError as e:
                sent, err = e.committed, e
            secs = time.perf_counter() - t0
            swept = sweeps[first_sweep:]
            if refusals:
                route = f"not certified ({refusals[0]}), the per-tx loop"
            elif swept:
                route = "certified"
            else:
                route = "batched, the gate opening on the last tx (no intermediate recompute)"
            sweep_text = (f"sweep K = {swept[0]['k']} on {swept[0]['device']}, {swept[0]['ms']:.3f} ms "
                          f"(CUDA events), prefixes inside each band {swept[0]['rejects']}"
                          if swept else "no sweep")
            print(f"  [{card}] cycle {cycle}: route {route}; {secs:.3f} s, {golden[0]} golden "
                  f"recomputes, {sweep_text}; {sent} txs"
                  + (f", failed at tx {err.committed}: {type(err.cause).__name__}: {err.cause}" if err else ""),
                  flush=True)
            block = [list(o.value) for o in contract.oracles]
            if err is None:
                ref = wsad_engine.two_pass_consensus(block, constrained=True, n_failing=n_failing, max_spread=0)
                got = contract_state(contract)
                check(got["value"] == ref["essence"] and got["rel1"] == ref["reliability_first_pass"]
                      and got["rel2"] == ref["reliability_second_pass"] and got["skew"] == ref["skewness"]
                      and got["kurt"] == ref["kurtosis"]
                      and [o[2] for o in got["oracles"]] == ref["reliable"],
                      f"cycle {cycle}: the on-chain state == two_pass_consensus on the committed ints")
                e_err = max(abs(a - b) for a, b in zip(contract.get_consensus_value(as_floats=True), b2_essence))
                check(e_err <= 2e-6, f"cycle {cycle}: on-chain essence vs B2's: max err {e_err:.3e} <= 2e-6")
                same = sum(a == b for a, b in zip(ref["reliable"], b2_reliable))
                check(same == n, f"cycle {cycle}: the reliable flags == B2's mask ({same} of {n} agree)")
            else:
                block[err.committed] = ints[err.committed]
                try:
                    wsad_engine.two_pass_consensus(block, constrained=True, n_failing=n_failing, max_spread=0)
                    raised = None
                except Exception as e:  # the panic the failed tx met, recomputed
                    raised = e
                check(type(raised) is type(err.cause),
                      f"cycle {cycle}: two_pass_consensus raises the chain's panic at tx {err.committed} "
                      f"({type(raised).__name__})")
        counts = dict(zip(("flash_attention", "fused_consensus", "threefry", "fleet_draws"),
                          (w.launches for w in counted)))
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
        check(tuple(counts.values()) == (n_layers * 2, 2, 2, 2),
              f"(a) launches {counts} == flash {n_layers}, B2 1, threefry 1, fleet draws 1 a step, 2 steps "
              f"(as in phase 4b)")

        # (b) The certified route on the card: tests/test_batch_commit.py's 64-oracle twins.
        callers = [f"o{i}" for i in range(64)]
        twins = [OracleConsensusContract(["a0", "a1", "a2"], callers, n_failing_oracles=16, dimension=6,
                                         device="cuda") for _ in range(2)]
        seq, bat = twins

        def refuse(*args, **kwargs):
            raise AssertionError("fell back to the sequential path")

        bat._sequential_batch = refuse
        rng = np.random.default_rng(5)
        first_sweep = len(sweeps)
        for _ in range(2):
            preds = rng.uniform(0.05, 0.95, size=(64, 6))
            for caller, p in zip(callers, preds):
                seq.update_prediction(caller, p)
            bat.update_predictions_batch(callers, preds)
        swept = sweeps[first_sweep:]
        check(contract_state(seq) == contract_state(bat) and bat.consensus_active,
              "(b) 64-oracle twins, two cycles: batched == sequential, exactly")
        check(len(swept) == 1 and swept[0]["device"] == "cuda" and swept[0]["k"] == 64,
              f"(b) the certified fast path taken, one sweep on the card: {swept}")
    finally:
        sweep_module.prefix_margins_sweep = real_sweep

    # The sweep at K = N = 1024: two seeded uniform fleets, committed in
    # oracle order (the JAX package's own fleet-1024 cycle).
    rng = np.random.default_rng(0)
    old, new = (rng.uniform(0.05, 0.95, size=(1024, 6)).astype(np.float32) for _ in range(2))
    pos = np.arange(1024, dtype=np.int32)
    ks = np.concatenate([np.arange(1, 1024), [1023]]).astype(np.int32)
    cfg = ConsensusConfig(n_failing=128)
    on_card = [torch.from_numpy(a).cuda() for a in (old, new, pos)]
    ks_card = torch.from_numpy(ks).cuda()
    ms = cuda_ms(torch, lambda: real_sweep(*on_card, cfg, ks_card), iters=10, warmup=2)
    card_margins = real_sweep(*on_card, cfg, ks_card)
    t0 = time.perf_counter()
    safe = sweep_module.certify(card_margins, cfg, True)
    certify_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_margins = real_sweep(*(torch.from_numpy(a) for a in (old, new, pos)), cfg, torch.from_numpy(ks))
    cpu_s = time.perf_counter() - t0
    errs = {name: (getattr(card_margins, name).cpu() - getattr(cpu_margins, name)).abs().max().item()
            for name in card_margins._fields}
    check(np.array_equal(safe, sweep_module.certify(cpu_margins, cfg, True))
          and max(errs[f] for f in ("rel1", "rel2", "sqrt_arg1", "sqrt_arg2")) <= 1e-5
          and max(errs["min_variance"], errs["boundary_gap"]) <= 1e-6,
          f"(b) the sweep at K = N = 1024 on the card == on the CPU (certify's booleans; max errs "
          f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} })")
    print(f"  [{card}] (b) the sweep at K = N = 1024, M = 6, n_failing 128: {ms:.4f} ms (CUDA events, 10 "
          f"calls), certify's fetch and bands {certify_ms:.3f} ms (host clock), the same sweep on the "
          f"host's CPU {cpu_s:.3f} s; certify rejects {int((~safe).sum())} of 1024 prefixes; inside each "
          f"band {band_rejects(card_margins)}", flush=True)

    # (c) The reference's on-chain submit shape (bench.py:1240-1380, config 5).
    c5 = OracleConsensusContract(list(range(1, 4)), list(range(10, 17)), n_failing_oracles=2,
                                 constrained=True, dimension=6, strict_interval=False, device="cuda")
    a5 = ChainAdapter(LocalChainBackend(c5))
    oracles = a5.call_oracle_list()
    key = prng.PRNGKey(0, "cuda")
    txs = reverted = n_comments = 0
    submit_s, causes = 0.0, {}
    flash_before = flash_attention_cuda.launches
    t_start = None
    for s in range(1 + CONFIG5_STEPS):  # one warm-up step
        if s == 1:
            txs = reverted = n_comments = 0
            submit_s, causes = 0.0, {}
            t_start = time.perf_counter()
        batch, comments = next(feed)
        key = prng.fold_in(key, s)
        values, _ = assemble_fleet(step.window(batch), *draw_fleet(key, step.window_size, 6, 7, 2,
                                                                   step.subset_size))
        preds = values.cpu().double().numpy()
        t_sub = time.perf_counter()
        for oracle, prediction in zip(oracles, preds):
            try:
                a5.invoke_update_prediction(oracle, prediction)
                txs += 1
            except (ArithmeticError, AssertionError) as e:  # a Cairo panic reverts that tx
                reverted += 1
                causes[type(e).__name__] = causes.get(type(e).__name__, 0) + 1
        consensus = a5.call_consensus()
        rel2 = a5.call_second_pass_consensus_reliability()
        submit_s += time.perf_counter() - t_sub
        n_comments += comments
    wall_s = time.perf_counter() - t_start
    launches["flash_attention"] = launches.get("flash_attention", 0) + flash_attention_cuda.launches - flash_before
    check(a5.call_consensus_active() and all(math.isfinite(x) for x in consensus) and len(consensus) == 6
          and txs + reverted == 7 * CONFIG5_STEPS
          and flash_attention_cuda.launches - flash_before == n_layers * (1 + CONFIG5_STEPS),
          f"(c) config 5, {CONFIG5_STEPS} steps: {txs} txs landed, {reverted} reverted; consensus read back "
          f"{[round(x, 6) for x in consensus]}, rel2 {rel2:.6f}")
    print(f"  [{card}] (c) config 5 (7 oracles, 2 failing, per-tx submit after each full-width forward, the "
          f"serial native feed): {n_comments / wall_s:.1f} comments/s including the submit, submit "
          f"{1e3 * submit_s / CONFIG5_STEPS:.3f} ms a step, {reverted} reverted txs {causes}", flush=True)


FABRIC_STAGES = ("fetch", "vectorize", "fleet", "consensus", "fabric_consensus", "fabric_stage",
                 "fabric_h2d", "fabric_dispatch", "fabric_sync")


def stage_seconds() -> dict:
    """The process registry's per-stage span sums (s) and the commit
    timer's, keyed by stage; a phase reads the difference of two."""
    from svoc_torch.utils.metrics import registry

    out = {s: registry.histogram("stage_seconds", labels={"stage": s}).sum for s in FABRIC_STAGES}
    out["commit"] = registry.timer("commit_latency").total_s
    return out


def commit_routes() -> dict:
    """The process registry's commit-plane counts: chain RPCs by mode and
    batched-commit fallbacks by reason."""
    from svoc_torch.utils.metrics import registry

    return {f"{name}{{{k}={v}}}": value for name in ("chain_commit_rpcs", "commit_batch_fallback")
            for labels, value in registry.family_series(name) for k, v in labels.items()}


def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


def fabric_tamper(kinds, slot):
    """The fabric scenario's offender hook (``fabric/scenario.py``) on
    ``slot``, over the per-cycle kinds."""
    import numpy as np

    def tamper(cycle, block):
        kind = kinds[cycle] if cycle < len(kinds) else None
        if kind is None:
            return block
        block = np.array(block, copy=True)
        if kind == "nan":
            block[slot, 0] = np.nan
        elif kind == "inf":
            block[slot, :] = np.inf
        else:
            block[slot, :] = 7.5
        return block
    return tamper


def golden_check(session, what: str) -> None:
    """The session's chain state against ``two_pass_consensus`` on the
    ints its oracles hold (the golden engine)."""
    from svoc_torch.consensus import wsad_engine

    contract = session.adapter.backend.contract
    if not contract.consensus_active:
        check(False, f"{what}: the consensus is active")
        return
    cfg = session.config
    ref = wsad_engine.two_pass_consensus([list(o.value) for o in contract.oracles],
                                         constrained=cfg.constrained, n_failing=cfg.n_failing,
                                         max_spread=0)
    got = contract_state(contract)
    check(got["value"] == ref["essence"] and got["rel1"] == ref["reliability_first_pass"]
          and got["rel2"] == ref["reliability_second_pass"] and got["skew"] == ref["skewness"]
          and got["kurt"] == ref["kurtosis"] and [o[2] for o in got["oracles"]] == ref["reliable"],
          f"{what}: the chain state == two_pass_consensus on the committed ints")


def calibrate_head(torch, pipe, comments: int = 256, seed: int = 12345) -> float:
    """Re-centre and scale a seeded pipeline's output layer in place so
    that its logits have zero mean and unit spread over ``comments``
    seeded synthetic comments; returns the scale.

    A stand-in for trained weights: at the init's scale the logits vary
    by only 0.1-0.3 across comments, so the 5 honest oracles of a
    7-oracle fleet agree to within a few wsad units per label and the
    contract's recompute panics (``wsad_sqrt`` of a variance <= 1, the
    reference's ``math.cairo`` semantics) in most cycles: phase 9c
    prints how often, before it calibrates."""
    from svoc_torch.io.scraper import SyntheticSource

    ids, mask = pipe.tokenizer(SyntheticSource(batch=comments, seed=seed)(), pipe.seq_len)
    with torch.inference_mode():
        logits = torch.cat([
            pipe.model(torch.from_numpy(ids[i:i + 32]).to(pipe.device),
                       torch.from_numpy(mask[i:i + 32]).to(pipe.device)).float()
            for i in range(0, comments, 32)
        ])
        scale = float(1.0 / logits.std(dim=0).mean())
        for head in {id(m.head_out): m.head_out for m in (pipe.model, pipe.packed_model)}.values():
            head.bias.copy_(scale * (head.bias - logits.mean(dim=0)))
            head.weight.mul_(scale)
    return scale


def fleet_diversity(session, fetches: int) -> list:
    """``fetches`` fetches of ``session`` (no commit): each block's
    smallest per-label variance over its honest oracles in wsad units,
    and whether the golden engine's recompute of the block panics."""
    from svoc_torch.consensus import wsad_engine
    from svoc_torch.ops.fixedpoint import to_wsad_rows

    out = []
    for _ in range(fetches):
        preview = session.fetch()
        rows = to_wsad_rows(preview["values"])
        honest = [r for r, h in zip(rows, preview["honest"]) if h]
        var = min(wsad_engine.nd_component_wise_variance(honest, wsad_engine.nd_average(honest)))
        try:
            wsad_engine.two_pass_consensus(rows, constrained=True, n_failing=session.config.n_failing,
                                           max_spread=0)
            out.append((var, "ok"))
        except ZeroDivisionError:
            out.append((var, "panic"))
    return out


@phase("9a. the claim fabric: the seeded scenario on the card")
def fabric_scenario_phase(torch, launches):
    import numpy as np

    from svoc_torch.consensus.batch import pad_claim_cube
    from svoc_torch.consensus.kernel import consensus_step_gated_claims
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.fabric.scenario import run_fabric_scenario
    from svoc_torch.ops.fused_consensus import (
        fused_consensus_gated_claims_cuda, fused_consensus_gated_claims_plain,
    )
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.tools.fabric_smoke import REFERENCE_FINGERPRINTS, reference_mismatches

    card = nvidia_smi()
    cfg = ClaimSpec("x").consensus_config()  # every fabric claim's: 7 oracles, 2 failing
    rng = np.random.default_rng(9)
    for claims, name in ((4, "[4, 7, 6], the offender's quarantined inf row"),
                         (37, "[64, 7, 6], 37 claims + 27 padding, quarantined nan/inf/7.5 rows")):
        vals = rng.uniform(0.05, 0.95, size=(claims, 7, 6)).astype(np.float32)
        ok = np.ones((claims, 7), dtype=bool)
        vals[-1, 6, :], ok[-1, 6] = np.inf, False
        if claims > 4:
            vals[5, 2, 0], vals[11, 0, :], ok[5, 2], ok[11, 0] = np.nan, 7.5, False, False
        values, ok_t, mask = (t.cuda() for t in pad_claim_cube(vals, ok))
        kernel = fused_consensus_gated_claims_cuda(values, ok_t, mask, cfg)
        plain = fused_consensus_gated_claims_plain(values, ok_t, mask, cfg)
        good, errs, _ = gated_errors(torch, kernel, plain)
        check(good, f"B3 at {name} vs plain: " + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
        cpu = consensus_step_gated_claims(values.cpu(), ok_t.cpu(), mask.cpu(), cfg)
        check(torch.equal(kernel.reliable.cpu(), cpu.reliable)
              and torch.equal(kernel.interval_valid.cpu(), cpu.interval_valid),
              f"B3 at {name}: reliable and interval_valid == the CPU route's (the fingerprinted fields)")
        ms = cuda_ms(torch, lambda: fused_consensus_gated_claims_cuda(values, ok_t, mask, cfg), iters=50)
        plain_ms = cuda_ms(torch, lambda: fused_consensus_gated_claims_plain(values, ok_t, mask, cfg), iters=20)
        c, n, m = values.shape  # counted as phase 3b counts them
        bytes_moved = sum(x.numel() * x.element_size() for x in (values, ok_t, mask, *kernel))
        ranks, ops = c * (2 * m + 1) * n * math.ceil(math.log2(n)), c * 12 * n * m
        bound_ms, bound_by = bound(bytes_moved, ops, FP32_FLOPS, ranks)
        print(f"  [{card}] B3 at [{c}, {n}, {m}]: {ms:.4f} ms (CUDA events, 50 launches), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.7f} ms ({bound_by})")

    runs = []
    for pipelined in (False, False, True):
        torch.cuda.synchronize()
        fused_consensus_gated_claims_cuda.launches = threefry_cuda.launches = fleet_draws_cuda.launches = 0
        t0 = time.perf_counter()
        result = run_fabric_scenario(0, cycles=12, pipelined=pipelined)  # device=None: CUDA
        secs = time.perf_counter() - t0
        counts = dict(gated_claims_consensus=fused_consensus_gated_claims_cuda.launches,
                      threefry=threefry_cuda.launches, fleet_draws=fleet_draws_cuda.launches)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        runs.append(result)
        label = "pipelined" if pipelined else "unpipelined"
        print(f"  [{card}] scenario ({label}): {secs:.3f} s, launches {counts}, "
              f"{result['journal_events']} events", flush=True)
        fetches = sum(result["served_per_step"])
        check(counts == dict(gated_claims_consensus=12, threefry=fetches, fleet_draws=fetches),
              f"{label}: B3 launched once a cycle (12), threefry and the fleet draws once a fetch ({fetches} "
              f"fetches): {counts}")
        check(result["offender_replaced"] and result["siblings_clean"]
              and result["injection_count"] == 7 and result["served_per_step"] == [4] * 12,
              f"{label}: offender replaced, siblings clean, 7 injections, 4 claims served every step")
        mismatch = reference_mismatches(result, pipelined)
        check(not mismatch, f"{label}: per-claim and journal fingerprints == the JAX package's "
                            f"({sorted(REFERENCE_FINGERPRINTS[pipelined]['claims'])}; mismatches {mismatch})")
    check(all(runs[0]["claims"][c]["fingerprint"] == runs[1]["claims"][c]["fingerprint"]
              for c in runs[0]["claims"]), "two unpipelined card runs: per-claim fingerprints equal")


@phase("9b. the claim fabric at full width: 64 claims x 7 oracles, one shared encoder")
def fabric_width_phase(torch, launches):
    import numpy as np

    from svoc_torch.apps.session import Session
    from svoc_torch.consensus.batch import pad_claim_cube
    from svoc_torch.fabric import ClaimSpec, MultiSession
    from svoc_torch.fabric.router import dispatch_group
    from svoc_torch.fabric.scenario import _claim_names, _injection_schedule
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.sim.generators import claim_seed
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry

    card = nvidia_smi()
    names = _claim_names(FABRIC_CLAIMS)
    offender = names[-1]
    kinds = _injection_schedule(0, offender, FABRIC_CYCLES)
    # The reference Session's default vectorizer, built once through the
    # entry point (ROBERTA_GO_EMOTIONS, packed, dense, seeded weights),
    # its output layer calibrated (calibrate_head) and shared by all claims.
    vectorizer = Session(device="cuda").vectorizer
    scale = calibrate_head(torch, vectorizer)
    print(f"  vectorizer: {vectorizer.cfg.n_layers} layers, hidden {vectorizer.cfg.hidden}, "
          f"attention {vectorizer.cfg.attention}, packed {vectorizer.packed}, head calibrated "
          f"(scale {scale:.3f}); injections {kinds}")
    counted = {"gated_claims_consensus": fused_consensus_gated_claims_cuda, "threefry": threefry_cuda,
               "fleet_draws": fleet_draws_cuda, "flash_attention": flash_attention_cuda,
               "fused_consensus": fused_consensus_cuda}

    def store_factory(claim_id):
        store = CommentStore()
        store.save(SyntheticSource(batch=120, seed=claim_seed(0, claim_id))())
        return store

    def run(device_resident=False, pipelined=False):
        """One 9b run; 9d runs it staged and pipelined too."""
        journal = EventJournal()
        multi = MultiSession(base_seed=0, vectorizer=vectorizer, store_factory=store_factory,
                             journal=journal, metrics=MetricsRegistry(), lineage_scope="fab",
                             max_claims_per_batch=FABRIC_CLAIMS, device_resident=device_resident,
                             pipelined=pipelined)  # device=None: CUDA
        tamper = fabric_tamper(kinds, 6)
        for cid in names:
            multi.add_claim(ClaimSpec(claim_id=cid, tamper=tamper if cid == offender else None))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for wrapper in counted.values():
            wrapper.launches = 0
        stages, routes = stage_seconds(), commit_routes()
        allocations = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        cycle_s, per_cycle = [], []
        for _ in range(FABRIC_CYCLES):
            before = {k: w.launches for k, w in counted.items()}
            t0 = time.perf_counter()
            report = multi.step()
            cycle_s.append(time.perf_counter() - t0)
            per_cycle.append(({k: w.launches - before[k] for k, w in counted.items()},
                              len(report["served"])))
        multi.flush()
        torch.cuda.synchronize()
        allocations = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - allocations
        counts = {k: w.launches for k, w in counted.items()}
        return dict(multi=multi, journal=journal, cycle_s=cycle_s, per_cycle=per_cycle, counts=counts,
                    stages=diff(stage_seconds(), stages), routes=diff(commit_routes(), routes),
                    peak=torch.cuda.max_memory_allocated(), allocations=allocations,
                    fingerprints={c: multi.claim_fingerprint(c) for c in names})

    first, second = run(), run()
    for name in ("gated_claims_consensus", "threefry", "fleet_draws"):
        launches[name] = launches.get(name, 0) + first["counts"][name] + second["counts"][name]
    fps = [{c: r["multi"].claim_fingerprint(c) for c in names} for r in (first, second)]
    check(fps[0] == fps[1] and first["journal"].fingerprint() == second["journal"].fingerprint(),
          f"two runs: {FABRIC_CLAIMS} per-claim fingerprints and the journal's equal")
    want = {"gated_claims_consensus": 1, "threefry": FABRIC_CLAIMS, "fleet_draws": FABRIC_CLAIMS,
            "flash_attention": 0, "fused_consensus": 0}
    check(all(c == (want, FABRIC_CLAIMS) for r in (first, second) for c in r["per_cycle"]),
          f"every cycle served {FABRIC_CLAIMS} claims and launched {want}: {first['per_cycle'][0]}")
    session = first["multi"].get(offender).session
    snap = session.resilience_snapshot()
    roster = [hex(a) for a in session.adapter.call_oracle_list()]
    check(snap["replacements"] >= 1 and "0x16" not in roster,
          f"offender {offender}: 0x16 voted out ({snap['replacements']} replacement(s), roster {roster})")
    journal = first["journal"]

    def family(s, etype):
        return journal.recent(type=etype, lineage_prefix=s.lineage_prefix + "-")

    injected = sum(k is not None for k in kinds)
    check(len([e for e in family(session, "quarantine.verdict") if e.data.get("reasons")]) == injected
          and len(family(session, "supervisor.charge")) == injected,
          f"offender {offender}: {injected} refusing verdicts and {injected} quarantine charges")
    siblings = [first["multi"].get(c).session for c in names[:-1]]
    poisoned = [s.config.claim for s in siblings
                if any(e.data.get("reasons") for e in family(s, "quarantine.verdict"))
                or family(s, "supervisor.charge")]
    check(not poisoned, f"{FABRIC_CLAIMS - 1} siblings: no refusing verdict, no quarantine charge: {poisoned}")
    replaced = {s.config.claim: s.resilience_snapshot()["replacements"] for s in siblings
                if s.resilience_snapshot()["replacements"]}
    stranded = sum(len(family(s, "commit.skipped")) for s in siblings)
    print(f"  siblings: replacements {replaced or 'none'}, {stranded} stranded txs (their own chains' "
          f"recomputes; informational)")

    # The group's consensus (dispatch_group on the last cycle's cube) by CUDA events.
    states = first["multi"].registry.states()
    cube = torch.from_numpy(np.stack([s.session.predictions for s in states]).astype(np.float32)).cuda()
    oks = torch.from_numpy(np.stack([s.session.last_quarantine.ok for s in states])).cuda()
    cfg = states[0].spec.consensus_config()
    group_ms = cuda_ms(torch, lambda: dispatch_group(cube, oks, cfg), iters=50)
    values, ok, mask = pad_claim_cube(cube, oks)
    b3_ms = cuda_ms(torch, lambda: fused_consensus_gated_claims_cuda(values, ok, mask, cfg), iters=50)
    for label, r in (("run 1", first), ("run 2", second)):
        secs = sum(r["cycle_s"])
        comments = FABRIC_CYCLES * FABRIC_CLAIMS * 30  # fetch_limit comments a fetch
        st = r["stages"]
        print(f"  [{card}] {label}: {FABRIC_CYCLES} cycles {secs:.3f} s "
              f"({', '.join(f'{s * 1e3:.1f}' for s in r['cycle_s'])} ms); per cycle: fetch "
              f"{st.get('fetch', 0) / FABRIC_CYCLES * 1e3:.1f} ms (vectorize "
              f"{st.get('vectorize', 0) / FABRIC_CYCLES * 1e3:.1f}, fleet "
              f"{st.get('fleet', 0) / FABRIC_CYCLES * 1e3:.1f}, host sync + gate + preview "
              f"{st.get('consensus', 0) / FABRIC_CYCLES * 1e3:.1f}), fabric consensus "
              f"{st.get('fabric_consensus', 0) / FABRIC_CYCLES * 1e3:.2f} ms (dispatch "
              f"{st.get('fabric_dispatch', 0) / FABRIC_CYCLES * 1e3:.2f}, sync "
              f"{st.get('fabric_sync', 0) / FABRIC_CYCLES * 1e3:.2f}), commit plane "
              f"{st.get('commit', 0) / FABRIC_CYCLES * 1e3:.1f} ms; "
              f"{comments / st['vectorize']:.1f} comments/s vectorized ({comments / secs:.1f} over "
              f"the cycles); commit routes {r['routes']}; peak memory "
              f"{r['peak'] / 2**20:.1f} MiB", flush=True)
    print(f"  [{card}] the group's consensus at [64, 7, 6]: dispatch_group {group_ms:.4f} ms, "
          f"B3 alone {b3_ms:.4f} ms (CUDA events, 50 calls)")
    return dict(comments_per_s=[FABRIC_CYCLES * FABRIC_CLAIMS * 30 / r["stages"]["vectorize"]
                                for r in (first, second)],
                run=run, first=first, second=second, names=names, multi=first["multi"])


@phase("9d. resident claim-cube staging off and on: 9b's fabric, pipelined off and on")
def staging_phase(torch, launches, fabric):
    if not fabric:
        check(False, "9d: 9b's fabric did not run")
        return
    card = nvidia_smi()
    run, names = fabric["run"], fabric["names"]
    runs = {("off", "serial"): fabric["second"]}  # warm: 9b's first run pays B3's first launch
    for staged, pipelined in ((True, False), (False, True), (True, True)):
        runs[("on" if staged else "off", "pipelined" if pipelined else "serial")] = run(
            device_resident=staged, pipelined=pipelined)
    for key in (("on", "serial"), ("off", "pipelined"), ("on", "pipelined")):
        for name in ("gated_claims_consensus", "threefry", "fleet_draws"):
            launches[name] = launches.get(name, 0) + runs[key]["counts"][name]
    check(runs[("on", "serial")]["fingerprints"] == runs[("off", "serial")]["fingerprints"],
          f"staged, serial: all {FABRIC_CLAIMS} per-claim fingerprints equal 9b's unstaged run")
    check(runs[("on", "pipelined")]["fingerprints"] == runs[("off", "pipelined")]["fingerprints"],
          f"staged, pipelined: all {FABRIC_CLAIMS} per-claim fingerprints equal the unstaged pipelined run's")
    want = {"gated_claims_consensus": 1, "threefry": FABRIC_CLAIMS, "fleet_draws": FABRIC_CLAIMS,
            "flash_attention": 0, "fused_consensus": 0}
    for key, r in runs.items():
        check(all(c == (want, FABRIC_CLAIMS) for c in r["per_cycle"]),
              f"staging {key[0]}, {key[1]}: every cycle served {FABRIC_CLAIMS} claims and launched {want}")
    for staged in (("on", "serial"), ("on", "pipelined")):
        router = runs[staged]["multi"].router
        records = list(router._staging.values())
        check(router.device_resident and len(records) == 1 and records[0].dev[0].is_cuda
              and records[0].host[0].is_pinned() and all(k.donate for k in router._warmth_seen),
              f"staging on, {staged[1]}: one staging record ({records[0].bucket if records else None} claims, "
              f"pinned host buffers, persistent tensors on the card), every dispatch keyed donate")
    # The dispatch alone (stage, copy, B3; no write-back), staging off and
    # on, in turns, on the last cycle's 64 blocks.
    dispatch = {}
    for label in ("off", "on", "on", "off"):
        multi = runs[(label, "serial")]["multi"]
        members = multi.registry.states()
        cfg = members[0].spec.consensus_config()
        fn = lambda: multi.router._dispatch_group(members, cfg)  # noqa: E731
        before = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        ms = cuda_ms(torch, fn, iters=50)
        allocs = (torch.cuda.memory_stats().get("allocation.all.allocated", 0) - before) / 53
        dispatch.setdefault(label, []).append((round(ms, 4), round(allocs, 2)))
    print(f"  [{card}] the dispatch alone at [64, 7, 6] (CUDA events, 50 calls; allocations a call), in turns off, "
          f"on, on, off: off {dispatch['off']}, on {dispatch['on']}")
    for (staging, mode), r in runs.items():
        st = r["stages"]
        print(f"  [{card}] staging {staging}, {mode}: fabric consensus "
              f"{st.get('fabric_consensus', 0) / FABRIC_CYCLES * 1e3:.3f} ms a cycle (stage "
              f"{st.get('fabric_stage', 0) / FABRIC_CYCLES * 1e3:.3f}, h2d "
              f"{st.get('fabric_h2d', 0) / FABRIC_CYCLES * 1e3:.3f}, dispatch "
              f"{st.get('fabric_dispatch', 0) / FABRIC_CYCLES * 1e3:.3f}, sync "
              f"{st.get('fabric_sync', 0) / FABRIC_CYCLES * 1e3:.3f}); caching-allocator allocations "
              f"{r['allocations'] / FABRIC_CYCLES:.1f} a cycle; cycle {sum(r['cycle_s']) / FABRIC_CYCLES * 1e3:.1f} "
              f"ms; launches B3 {r['counts']['gated_claims_consensus']}, B1 {r['counts']['flash_attention']}, "
              f"threefry {r['counts']['threefry']}, fleet draws {r['counts']['fleet_draws']}", flush=True)


@phase("9e. the hot-path gate on the card: the hotpath_smoke twin")
def hotpath_phase(torch, launches):
    from svoc_torch.tools import hotpath_smoke

    card = nvidia_smi()
    wrappers = zero_counts()
    t0 = time.perf_counter()
    art = hotpath_smoke.run(0, device=None)  # device None: CUDA
    seconds = time.perf_counter() - t0
    counts = read_counts(wrappers)
    for name, passed in art["checks"].items():
        check(passed, f"hotpath smoke on {art['device']}: {name}")
    check(len(art["checks"]) == 6 and art["reference_mismatches"] == {},
          f"hotpath smoke: the journal fingerprint {art['journal_fingerprint'][:16]} and the "
          f"{len(art['per_claim_fingerprints'])} per-claim fingerprints equal the JAX package's at seed 0 "
          f"({art['reference_mismatches']})")
    check(counts["gated_claims_consensus"] > 0 and counts["fleet_draws"] > 0
          and counts["threefry"] == counts["fleet_draws"] and counts["flash_attention"] == 0,
          f"hotpath smoke: every dispatch a B3 launch from the staging tensor, every fetch a threefry split and "
          f"one fleet-draws launch ({counts})")
    add_launches(launches, counts)
    print(f"  [{card}] hotpath smoke (3 scenario runs x {art['cycles']} cycles and the clean leg) {seconds:.3f} s, "
          f"launches {counts}; clean leg {art['clean_leg']['rpcs']}, skip-slot fallbacks "
          f"{art['skip_slot_fallbacks']}")


@phase("9c. the single-claim loop: fetch, commit_resilient, supervisor_step")
def session_loop_phase(torch, launches):
    import numpy as np

    from svoc_torch.apps.session import Session, SessionConfig
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda

    card = nvidia_smi()

    def store(seed):
        s = CommentStore()
        s.save(SyntheticSource(batch=120, seed=seed)())
        return s

    session = Session(SessionConfig(), store=store(0))  # device=None: CUDA, its own default vectorizer
    raw = fleet_diversity(Session(SessionConfig(), store=store(1), vectorizer=session.vectorizer), 8)
    print(f"  [{card}] the default vectorizer at the init's scale, 8 fetches (no commit): smallest "
          f"honest per-label variance (wsad) and the golden recompute {raw}")
    scale = calibrate_head(torch, session.vectorizer)
    print(f"  head calibrated (scale {scale:.3f})")
    torch.cuda.synchronize()
    threefry_cuda.launches = fleet_draws_cuda.launches = fused_consensus_gated_claims_cuda.launches = 0
    stages = stage_seconds()
    outcomes, cycle_s = [], []
    for cycle in range(SESSION_CYCLES):
        t0 = time.perf_counter()
        preview = session.fetch()
        outcome = session.commit_resilient()
        report = session.supervisor_step() or {}
        cycle_s.append(time.perf_counter() - t0)
        outcomes.append((outcome.sent, len(outcome.stranded), len(report.get("replaced", ()))))
        check(preview["values"].shape == (7, 6) and bool(np.isfinite(preview["values"]).all())
              and outcome.complete and "scores" in report,
              f"cycle {cycle}: a finite [7, 6] block, {outcome.sent} txs landed, a supervisor fold")
        golden_check(session, f"cycle {cycle}")
    counts = dict(threefry=threefry_cuda.launches, fleet_draws=fleet_draws_cuda.launches,
                  gated_claims_consensus=fused_consensus_gated_claims_cuda.launches)
    for name in ("threefry", "fleet_draws"):
        launches[name] = launches.get(name, 0) + counts[name]
    check(counts == dict(threefry=SESSION_CYCLES, fleet_draws=SESSION_CYCLES, gated_claims_consensus=0),
          f"launches {counts}: threefry and the fleet draws once a fetch, no claim cube")
    st = diff(stage_seconds(), stages)
    n = SESSION_CYCLES
    print(f"  [{card}] {n} cycles: {sum(cycle_s):.3f} s ({', '.join(f'{s * 1e3:.1f}' for s in cycle_s)} ms); "
          f"per cycle fetch {st.get('fetch', 0) / n * 1e3:.1f} ms (vectorize "
          f"{st.get('vectorize', 0) / n * 1e3:.1f}, fleet {st.get('fleet', 0) / n * 1e3:.1f}, host sync + "
          f"gate + preview {st.get('consensus', 0) / n * 1e3:.1f}), commit plane "
          f"{st.get('commit', 0) / n * 1e3:.1f} ms; {30 * n / st['vectorize']:.1f} comments/s vectorized; "
          f"outcomes {outcomes}; journal {session.journal.last_seq()} events")


@phase("10a. the serving tier: the seeded scenario on the card")
def serving_scenario_phase(torch, launches):
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.serving.scenario import run_serving_scenario
    from svoc_torch.tools.serving_smoke import checks, reference_mismatches
    from svoc_torch.utils.events import EventJournal

    card = nvidia_smi()
    counted = {"gated_claims_consensus": fused_consensus_gated_claims_cuda, "threefry": threefry_cuda,
               "fleet_draws": fleet_draws_cuda, "flash_attention": flash_attention_cuda,
               "fused_consensus": fused_consensus_cuda}
    keys = ("journal_fingerprint", "journal_events", "per_claim_fingerprints")
    for plane in ("on", "off"):
        cpu = run_serving_scenario(0, cost_plane=plane, device="cpu")
        runs = []
        for _ in range(2):
            journal = EventJournal()
            torch.cuda.synchronize()
            for wrapper in counted.values():
                wrapper.launches = 0
            t0 = time.perf_counter()
            result = run_serving_scenario(0, cost_plane=plane, journal=journal)  # device=None: CUDA
            secs = time.perf_counter() - t0
            counts = {k: w.launches for k, w in counted.items()}
            for k in ("gated_claims_consensus", "threefry", "fleet_draws"):
                launches[k] = launches.get(k, 0) + counts[k]
            served = [e.data["served"] for e in journal.recent(100_000) if e.type == "serving.step"]
            want = dict(gated_claims_consensus=sum(n > 0 for n in served), flash_attention=0,
                        fused_consensus=0, threefry=sum(served), fleet_draws=sum(served))
            print(f"  [{card}] scenario (plane {plane}): {secs:.3f} s, {result['steps']} steps, "
                  f"launches {counts}, {result['journal_events']} events, shed "
                  f"{result['shed_by_reason']}, cache {result['cache']['hit_rate']:.3f}", flush=True)
            # A claim's fetch: its key split (threefry) and its fleet (the fleet draws).
            check({k: counts[k] for k in want} == want,
                  f"plane {plane}: B3 once a step that served a claim, threefry and the fleet draws once a "
                  f"claim served ({sum(served)}): {counts}")
            runs.append(result)
        gates = checks(*runs)
        check(all(gates.values()), f"plane {plane}: the serving smoke's gates {gates}")
        mismatch = reference_mismatches(runs[0])
        check(all(r[k] == cpu[k] for r in runs for k in keys) and not mismatch,
              f"plane {plane}: two card runs' journal and per-claim fingerprints == the CPU run's "
              f"in this process and the JAX package's (mismatches {mismatch})")
        check(runs[0]["cost_plane"].enabled == (plane == "on"), f"the cost plane is {plane}")


def width_pipeline(torch, cfg=None, device="cuda"):
    """10b's vectorizer: one shared packed pipeline (ROBERTA_GO_EMOTIONS
    unless ``cfg``), flash attention and bf16 weights, 256 rows of 128
    tokens with up to 8 comments a row; its head is not calibrated yet."""
    import dataclasses

    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.sentiment import SentimentPipeline

    return SentimentPipeline(dataclasses.replace(cfg or ROBERTA_GO_EMOTIONS, attention="flash"), seq_len=128,
                             batch_size=256, params_dtype=torch.bfloat16, packed=True, max_segments=8,
                             device=device)


def width_tier(multi, pipe, metrics, claims: int = SERVING_CLAIMS, arrivals: int = SERVING_ARRIVALS,
               latency_target_s: float = SERVING_LATENCY_TARGET_S):
    """10b's ``ServingTier`` over ``multi``: queues of 64, a step drains
    every arrival, 10b's latency target unless another is given."""
    from svoc_torch.serving.frontend import AdmissionConfig
    from svoc_torch.serving.tier import ServingTier
    from svoc_torch.utils.slo import serving_slos

    return ServingTier(multi, vectorizer=pipe, admission=AdmissionConfig(queue_capacity=64),
                       max_requests_per_step=claims * arrivals,
                       slos=serving_slos(metrics, latency_target_s=latency_target_s))


@phase("10b. the serving tier at full width: 64 claims x 7 oracles, one packed flash forward a step")
def serving_width_phase(torch, launches, fabric):
    import collections

    import numpy as np

    from svoc_torch.fabric import ClaimSpec, MultiSession
    from svoc_torch.fabric.scenario import _claim_names, _injection_schedule
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry
    from svoc_torch.utils.metrics import registry as process_registry

    card = nvidia_smi()
    names = _claim_names(SERVING_CLAIMS)
    offender = names[-1]
    kinds = _injection_schedule(0, offender, 1 + SERVING_STEPS)
    pipe = width_pipeline(torch)
    scale = calibrate_head(torch, pipe)
    print(f"  vectorizer: {pipe.cfg.n_layers} layers, hidden {pipe.cfg.hidden}, attention "
          f"{pipe.cfg.attention}, bf16, 256 rows x 128 tokens, head calibrated (scale {scale:.3f}); "
          f"injections {kinds}")
    # The forward's CUDA events and the host's assemble and vectorize times.
    forward_ev, host = [], collections.defaultdict(float)
    packed_forward = pipe.packed_forward

    def timed_forward(*arrays):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = packed_forward(*arrays)
        ev[1].record()
        forward_ev.append(ev)
        return out

    pipe.packed_forward = timed_forward
    journal, metrics = EventJournal(capacity=1 << 17), MetricsRegistry()  # every event of the run
    multi = MultiSession(base_seed=0, vectorizer=pipe, journal=journal, metrics=metrics,
                         lineage_scope="srv", sanitized_dispatch=True,
                         max_claims_per_batch=SERVING_CLAIMS)  # device=None: CUDA
    tamper = fabric_tamper(kinds, 6)
    for cid in names:
        multi.add_claim(ClaimSpec(claim_id=cid, tamper=tamper if cid == offender else None))
    tier = width_tier(multi, pipe, metrics)

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            host[name] += time.perf_counter() - t0
            if name == "vectorize":
                host["unique"] += len({r.digest for r in args[0]})
            return out
        return run

    tier.batcher.assemble = timed("assemble", tier.batcher.assemble)
    tier.batcher.vectorize_requests = timed("vectorize", tier.batcher.vectorize_requests)

    rng = np.random.default_rng(11)
    pool = SyntheticSource(batch=10, seed=777)()
    fresh = iter(SyntheticSource(batch=SERVING_CLAIMS * SERVING_ARRIVALS * (1 + SERVING_STEPS), seed=778)())
    counted = {"flash_attention": flash_attention_cuda, "gated_claims_consensus": fused_consensus_gated_claims_cuda,
               "fused_consensus": fused_consensus_cuda, "threefry": threefry_cuda, "fleet_draws": fleet_draws_cuda}
    stages = ("fetch", "fleet", "consensus", "fabric_consensus")
    rows, latencies, finite, statuses = [], [], True, collections.Counter()
    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = 0
    for i in range(1 + SERVING_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for cid in names:
            for _ in range(SERVING_ARRIVALS):
                text = pool[int(rng.integers(0, len(pool)))] if rng.random() < 0.35 else next(fresh)
                statuses[tier.submit(cid, text)["status"]] += 1
        t1 = time.perf_counter()
        before = {k: w.launches for k, w in counted.items()}
        st0, forward_ev[:], host_before = stage_seconds(), [], dict(host)
        span0 = {s: process_registry.histogram("stage_seconds", labels={"stage": s}).sum for s in stages}
        report = tier.step()
        t2 = time.perf_counter()
        counts = {k: w.launches - before[k] for k, w in counted.items()}
        spans = {s: process_registry.histogram("stage_seconds", labels={"stage": s}).sum - span0[s]
                 for s in stages}
        st = diff(stage_seconds(), st0)
        for cid in report["served"]:
            finite &= bool(np.isfinite(multi.get(cid).last_consensus["essence"]).all())
        lat = np.asarray(report["latencies_s"])
        if i:
            latencies.extend(report["latencies_s"])
        rows.append(dict(
            submit_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
            assemble_ms=(host["assemble"] - host_before.get("assemble", 0.0)) * 1e3,
            vectorize_ms=(host["vectorize"] - host_before.get("vectorize", 0.0)) * 1e3,
            forward_ms=sum(a.elapsed_time(b) for a, b in forward_ev), forwards=len(forward_ev),
            unique=host["unique"] - host_before.get("unique", 0.0),
            fetch_ms=spans["fetch"] * 1e3, fleet_ms=spans["fleet"] * 1e3,
            fabric_consensus_ms=spans["fabric_consensus"] * 1e3, commit_ms=st.get("commit", 0.0) * 1e3,
            requests=report["requests"], served=len(report["served"]), dropped=report["dropped"],
            p50_ms=float(np.percentile(lat, 50)) * 1e3 if lat.size else None,
            p99_ms=float(np.percentile(lat, 99)) * 1e3 if lat.size else None,
            fill={k: process_registry.gauge("packing_fill_ratio", labels={"kind": k}).get()
                  for k in ("segments", "tokens")},
            launches=counts,
        ))
    peak = torch.cuda.max_memory_allocated()
    pipe.packed_forward = packed_forward
    total = {k: w.launches for k, w in counted.items()}
    for k in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + total[k]
    n_layers = pipe.cfg.n_layers
    timed_rows = rows[1:]
    check(all(r["forwards"] >= 1 and r["launches"] == dict(
        flash_attention=n_layers * r["forwards"], gated_claims_consensus=1, fused_consensus=0,
        threefry=r["served"], fleet_draws=r["served"]) for r in rows),
        f"every step: {n_layers} flash launches a 256-row chunk, 1 claim-cube, 0 B2, threefry and the fleet "
        f"draws once a claim served (step 1: {rows[1]['forwards']} chunk(s), {rows[1]['launches']})")
    check(all(r["served"] == SERVING_CLAIMS for r in rows) and finite,
          f"every step served {SERVING_CLAIMS} claims, every served claim's essence finite")
    shed, dropped = metrics.family_total("serving_shed"), metrics.family_total("serving_dropped")
    cache = tier.cache.stats()
    check(cache["hits"] > 0 and shed == 0 and dropped == 0,
          f"cache hits {cache['hits']:g} > 0, nothing shed ({shed:g}) or dropped ({dropped:g}); "
          f"submissions {dict(statuses)}")
    state = multi.get(offender)
    session = state.session

    def family(s, etype):
        return journal.recent(type=etype, lineage_prefix=s.lineage_prefix + "-")

    injected = sum(k is not None for k in kinds[:state.cycles])
    refused = [e for e in family(session, "quarantine.verdict") if e.data.get("reasons")]
    check(injected > 0 and len(refused) == injected and len(family(session, "supervisor.charge")) == injected,
          f"offender {offender}: {injected} injections over its {state.cycles} cycles, {len(refused)} "
          f"refusing verdicts and {len(family(session, 'supervisor.charge'))} charges")
    poisoned = [c for c in names[:-1] if any(e.data.get("reasons") for e in family(multi.get(c).session,
                                                                                  "quarantine.verdict"))
                or family(multi.get(c).session, "supervisor.charge")]
    check(not poisoned, f"{SERVING_CLAIMS - 1} siblings: no refusing verdict, no quarantine charge: {poisoned}")

    mean = lambda k: sum(r[k] for r in timed_rows) / len(timed_rows)  # noqa: E731
    step_s = sum(r["step_ms"] for r in timed_rows) / 1e3
    wall_s = step_s + sum(r["submit_ms"] for r in timed_rows) / 1e3
    requests = sum(r["requests"] for r in timed_rows)
    vec_s = sum(r["vectorize_ms"] for r in timed_rows) / 1e3
    unique = sum(r["unique"] for r in timed_rows)
    print(f"  [{card}] {len(timed_rows)} timed steps: step {mean('step_ms'):.3f} ms (assemble "
          f"{mean('assemble_ms'):.3f}, vectorize {mean('vectorize_ms'):.3f} of which the forward "
          f"{mean('forward_ms'):.3f} by CUDA events in {mean('forwards'):.1f} chunk(s), the claims' "
          f"fetch {mean('fetch_ms'):.3f} (fleet {mean('fleet_ms'):.3f}), fabric consensus "
          f"{mean('fabric_consensus_ms'):.3f}, commit plane {mean('commit_ms'):.3f}), submit "
          f"{mean('submit_ms'):.3f} ms; {requests / step_s:.1f} requests/s over the step, "
          f"{requests / wall_s:.1f} with the submits; request latency over the timed steps p50 "
          f"{np.percentile(latencies, 50) * 1e3:.3f} ms, p99 {np.percentile(latencies, 99) * 1e3:.3f} "
          f"ms; cache hit rate "
          f"{cache['hit_rate']:.3f}; fill ratios {timed_rows[-1]['fill']}; peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    nine_b = fabric["comments_per_s"] if fabric else "not measured"
    print(f"  [{card}] comments vectorized a second: {unique / vec_s:.1f} unique texts "
          f"({requests / vec_s:.1f} requests) through one cross-claim forward a step, beside 9b's "
          f"per-claim forwards {nine_b}")
    print("  serving per step: " + json.dumps(rows))
    return {"step_ms": mean("step_ms")}


@phase("11a. chaos: the seeded fault-injection scenario, twice, against the reference's fingerprint")
def chaos_phase(torch):
    from svoc_torch.resilience.chaos import run_chaos_scenario
    from svoc_torch.tools import chaos_smoke

    t0 = time.perf_counter()
    first, second = run_chaos_scenario(4), run_chaos_scenario(4)
    secs = time.perf_counter() - t0
    gates = chaos_smoke.checks(first, second)
    check(all(gates.values()), f"the chaos smoke's checks {gates}")
    check(first["fingerprint"] == chaos_smoke.REFERENCE_FINGERPRINT,
          f"fingerprint {first['fingerprint'][:16]} == the JAX package's "
          f"{chaos_smoke.REFERENCE_FINGERPRINT[:16]} ({first['faults_fired']} faults fired, "
          f"{first['replacements']} replacement, host work, {secs:.3f} s for two runs)")


def served_steps(trace_path: str) -> list:
    """Each ``serving.step`` event's count of served claims in a journal trace."""
    from svoc_torch.utils.events import read_trace_events

    return [e["data"]["served"] for e in read_trace_events(trace_path) if e["event"] == "serving.step"]


@phase("11b. the crash matrix on the card: five kill legs, two matrix runs, children on CUDA")
def crash_matrix_phase(torch, launches):
    import tempfile

    from svoc_torch.durability.scenario import run_durable_scenario
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.tools import crash_smoke

    card = nvidia_smi()
    t0 = time.perf_counter()
    artifact = crash_smoke.run(0)  # device None: every child on CUDA
    secs = time.perf_counter() - t0
    failed = sorted(k for k, v in artifact["all_checks"].items() if not v)
    notes = {leg: c["notes"] for leg, c in artifact["checks"].items() if c["notes"]}
    check(not failed, f"the crash smoke's {len(artifact['all_checks'])} checks over 5 legs x 2 matrix runs "
          f"(zero duplicate txs, zero unknown and unaccounted WAL slots and requests, zero open cycles, each "
          f"leg's point fired, identical recovered fingerprints): failed {failed}, notes {notes}")
    check(not artifact["reference_mismatches"],
          f"every leg's recovered per-claim fingerprints == the JAX package's "
          f"(mismatches {artifact['reference_mismatches']})")
    for leg, entry in artifact["matrix"].items():
        rec = (entry["result"] or {}).get("recovery") or {}
        counts = crash_smoke.reconcile_counts(rec.get("reconcile") or {})
        print(f"  {leg}: killed {entry['killed']}, reconcile {counts}, "
              f"resent {(rec.get('reconcile') or {}).get('resent')}, lost requests {rec.get('lost_requests')}")
    print(f"  [{card}] crash matrix: {secs:.3f} s for 2 x 11 child processes, the two runs side by side in "
          f"waves of 10, 10, 2, each child forked from a fork server that imported torch and never "
          f"initialised CUDA")

    # One uninterrupted run in this process, counted from 0.
    counted = {"gated_claims_consensus": fused_consensus_gated_claims_cuda, "threefry": threefry_cuda,
               "fleet_draws": fleet_draws_cuda, "flash_attention": flash_attention_cuda,
               "fused_consensus": fused_consensus_cuda}
    cpu = run_durable_scenario(tempfile.mkdtemp(prefix="durable-cpu-"), 0, device="cpu")
    workdir = tempfile.mkdtemp(prefix="durable-cuda-")
    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    result = run_durable_scenario(workdir, 0)  # device None: CUDA
    secs = time.perf_counter() - t0
    counts = {k: w.launches for k, w in counted.items()}
    for k in ("gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + counts[k]
    served = served_steps(f"{workdir}/trace.jsonl")
    check(counts["gated_claims_consensus"] == sum(n > 0 for n in served)
          and counts["flash_attention"] == counts["fused_consensus"] == 0
          and counts["threefry"] == counts["fleet_draws"] == sum(served),
          f"uninterrupted run_durable_scenario(0) on the card: B3 once a step that served a claim "
          f"({sum(n > 0 for n in served)} of {len(served)} steps), threefry and the fleet draws once a claim "
          f"served ({sum(served)}): {counts}")
    same = {c: result["claims"][c]["fingerprint"] == cpu["claims"][c]["fingerprint"] for c in result["claims"]}
    check(all(same.values()) and result["journal_events"] == cpu["journal_events"]
          and result["duplicate_txs"] == 0 and not result["wal_open_cycles"]
          and result["requests"]["unaccounted"] == 0,
          f"its per-claim fingerprints == the CPU run's in this process {same}, "
          f"{result['journal_events']} events, 0 duplicate txs, 0 open cycles, every request accounted")
    print(f"  [{card}] uninterrupted durable scenario: {secs:.3f} s, {result['steps']} steps, "
          f"chain {result['chain']}")


#: Phase 11c: steps of the durable serving tier (cut from the open-ended
#: serving loop: steps only), the step in which the first child dies, and
#: the mid_fleet firing it dies at within that step (7 records a claim's
#: batch: mid-way through the 33rd claim's).
DURABLE_STEPS, DURABLE_KILL_STEP, DURABLE_KILL_NTH = 6, 4, 7 * 32 + 4
#: A claim whose block has a quarantined slot commits through the per-tx
#: loop, which never passes mid_fleet; the first child is also armed at
#: this firing of that route's ``chainlog.tx.post_fsync`` (mid-way through
#: the 17th claim's txs).  A step commits about 64 x 7 txs over the two
#: routes, more than the two counts together, so one of them is reached
#: in the kill step whatever route each claim takes.
DURABLE_KILL_NTH_PER_TX = 7 * 16 + 4
#: The fault point of each commit route and its firing the first child dies at.
DURABLE_KILLS = {"chain.batch.mid_fleet": DURABLE_KILL_NTH, "chainlog.tx.post_fsync": DURABLE_KILL_NTH_PER_TX}
#: The durable tier's request-latency target: the fleet phases' 30 s. At
#: 10b's 5 s a slow host's durable steps (2.1-3.6 s, fsyncs included, on
#: an NVIDIA H100 80GB HBM3 host) burned the SLO and the tier shed every
#: request from step 3 on, so the first child committed nothing to die in.
DURABLE_LATENCY_TARGET_S = 30.0
DURABLE_SNAPSHOT_EVERY = 2


def durable_width_run(torch, workdir: str, role: str, device=None, cfg=None, claims: int = SERVING_CLAIMS,
                      arrivals: int = SERVING_ARRIVALS, steps: int = DURABLE_STEPS,
                      kill_step: int = DURABLE_KILL_STEP, kill_nth: int = DURABLE_KILL_NTH,
                      kill_nth_per_tx: int = DURABLE_KILL_NTH_PER_TX, per_tx_claims: int = 0,
                      comments: int = 256) -> None:
    """One child of phase 11c: 10b's serving tier made durable in
    ``workdir`` (a WAL, a chain log a claim, snapshots every two steps,
    the journal's trace fsynced). ``role`` "crash" arms the fault
    controller at the start of step ``kill_step`` and is SIGKILLed at
    its ``kill_nth`` ``chain.batch.mid_fleet`` firing (the batched
    commit route) or its ``kill_nth_per_tx`` ``chainlog.tx.post_fsync``
    firing (the per-tx route), whichever comes first; "recover" recovers
    from the directory, runs to ``steps`` and writes ``result.json``; any
    other role runs uninterrupted to ``steps`` and writes it too.  The
    first ``per_tx_claims`` claims commit per tx.  Each step appends its
    row to ``rows-<role>.jsonl`` as it ends."""
    import collections
    import os

    import numpy as np

    from svoc_torch.durability import faultspace
    from svoc_torch.durability import recovery as recovery_mod
    from svoc_torch.durability.chainlog import (DurableLocalBackend, duplicate_predictions, read_chain_log,
                                                replay_chain_log)
    from svoc_torch.durability.reconcile import wal_cycles
    from svoc_torch.durability.recovery import GracefulDrain, RecoveryManager
    from svoc_torch.durability.scenario import _spec_contract
    from svoc_torch.durability.wal import CommitIntentWAL
    from svoc_torch.fabric import ClaimSpec, MultiSession
    from svoc_torch.fabric.scenario import _claim_names, _injection_schedule
    from svoc_torch.io.chain import ChainAdapter
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.sim.generators import claim_seed
    from svoc_torch.utils import events
    from svoc_torch.utils.metrics import MetricsRegistry

    t_start = time.perf_counter()
    # Every fsync of the process (WAL, chain logs, journal trace, snapshot), counted and timed.
    fsyncs = collections.Counter()
    real_fsync = os.fsync

    def timed_fsync(fd):
        t0 = time.perf_counter()
        real_fsync(fd)
        fsyncs["s"] += time.perf_counter() - t0
        fsyncs["n"] += 1

    os.fsync = timed_fsync
    names = _claim_names(claims)
    offender = names[-1]
    kinds = _injection_schedule(0, offender, 1 + steps)
    pipe = width_pipeline(torch, cfg, device or "cuda")
    calibrate_head(torch, pipe, comments=comments)
    forwards = []
    packed_forward = pipe.packed_forward

    def counted_forward(*arrays):
        forwards.append(1)
        return packed_forward(*arrays)

    pipe.packed_forward = counted_forward
    timer = collections.Counter()

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                timer[name] += time.perf_counter() - t0
        return run

    def adapter_factory(spec):
        contract = _spec_contract(spec, device=device)
        path = os.path.join(workdir, f"chain-{spec.claim_id}.jsonl")
        timed("chain_log_replay", replay_chain_log)(path, contract)
        return ChainAdapter(DurableLocalBackend(contract, path))

    trace_path = os.path.join(workdir, "trace.jsonl")
    metrics = MetricsRegistry()
    journal = events.EventJournal(registry=metrics)
    events.shared_writer(trace_path).fsync = True  # as the durable scenario forces it
    journal.set_trace_file(trace_path)
    wal = CommitIntentWAL(os.path.join(workdir, "wal.jsonl"))
    appended = collections.Counter()
    wal_append = wal._append

    def counted_append(record):
        appended[record["kind"]] += 1
        wal_append(record)

    wal._append = counted_append
    multi = MultiSession(base_seed=0, vectorizer=pipe, journal=journal, metrics=metrics, lineage_scope="dur",
                         sanitized_dispatch=True, max_claims_per_batch=claims, adapter_factory=adapter_factory,
                         commit_mode="batched", device=device)
    tamper = fabric_tamper(kinds, 6)
    for cid in names:
        multi.add_claim(ClaimSpec(claim_id=cid, tamper=tamper if cid == offender else None))
    for cid in names[:per_tx_claims]:
        multi.get(cid).session.commit_mode = "per_tx"
    multi.attach_wal(wal)
    tier = width_tier(multi, pipe, metrics, claims, arrivals, DURABLE_LATENCY_TARGET_S)
    manager = RecoveryManager(multi, out_dir=workdir, wal=wal, tier=tier, compilation_cache="off")
    snapshots = []
    snapshot = manager.snapshot

    def timed_snapshot():
        t0 = time.perf_counter()
        path = snapshot()
        snapshots.append(((time.perf_counter() - t0) * 1e3, os.path.getsize(path), tier.steps))
        return path

    manager.snapshot = timed_snapshot
    for name in ("load_snapshot", "restore_multi_session", "roll_forward_journal", "reconcile_wal"):
        setattr(recovery_mod, name, timed(name, getattr(recovery_mod, name)))
    built_s = time.perf_counter() - t_start

    report, recover_s = None, 0.0
    if role == "recover":
        t0 = time.perf_counter()
        report = manager.recover(adapters={cid: multi.get(cid).session.adapter for cid in names},
                                 trace_path=trace_path)
        recover_s = time.perf_counter() - t0
    manager.install_cadence(DURABLE_SNAPSHOT_EVERY)

    counted = {"flash_attention": flash_attention_cuda, "gated_claims_consensus": fused_consensus_gated_claims_cuda,
               "fused_consensus": fused_consensus_cuda, "threefry": threefry_cuda, "fleet_draws": fleet_draws_cuda}
    pool = SyntheticSource(batch=10, seed=777)()
    rows_path = os.path.join(workdir, f"rows-{role}.jsonl")
    while tier.steps < steps:
        step_no = tier.steps  # continues across the restart (restored)
        if role == "crash" and step_no + 1 == kill_step:
            faultspace.arm(faultspace.FaultController(
                [faultspace.FaultEvent("chain.batch.mid_fleet", nth=kill_nth),
                 faultspace.FaultEvent("chainlog.tx.post_fsync", nth=kill_nth_per_tx)],
                log_path=os.path.join(workdir, "fired.jsonl")))
        rng = np.random.default_rng(claim_seed(0, f"arrivals{step_no}"))
        fresh = iter(SyntheticSource(batch=claims * arrivals, seed=1000 + step_no)())
        for cid in names:
            for _ in range(arrivals):
                tier.submit(cid, pool[int(rng.integers(0, len(pool)))] if rng.random() < 0.35 else next(fresh))
        if device is None:
            torch.cuda.synchronize()
        for wrapper in counted.values():
            wrapper.launches = 0
        forwards.clear()
        fs0, ap0, n_snap, routes = dict(fsyncs), dict(appended), len(snapshots), commit_routes()
        t0 = time.perf_counter()
        out = tier.step()
        step_ms = (time.perf_counter() - t0) * 1e3
        snap = snapshots[n_snap:]
        row = dict(step=tier.steps, step_ms=step_ms - sum(s[0] for s in snap), snapshot_ms=[s[0] for s in snap],
                   snapshot_bytes=[s[1] for s in snap], served=len(out["served"]), forwards=len(forwards),
                   launches={k: w.launches for k, w in counted.items()},
                   fsyncs=fsyncs["n"] - fs0.get("n", 0), fsync_ms=(fsyncs["s"] - fs0.get("s", 0.0)) * 1e3,
                   wal_records={k: appended[k] - ap0.get(k, 0) for k in appended if appended[k] - ap0.get(k, 0)},
                   routes=diff(commit_routes(), routes))
        with open(rows_path, "a") as f:
            f.write(json.dumps(row) + "\n")
    if role == "crash":
        raise RuntimeError(f"the crash child reached step {tier.steps} without its kill")
    drain = GracefulDrain(manager=manager, journal=journal).drain(reason="durable_width_end")
    dups = {cid: len(duplicate_predictions(os.path.join(workdir, f"chain-{cid}.jsonl"))) for cid in names}
    txs = {cid: len(read_chain_log(os.path.join(workdir, f"chain-{cid}.jsonl"))) for cid in names}
    admitted, completed, dropped = (metrics.family_total(f"serving_{k}") for k in ("admitted", "completed",
                                                                                    "dropped"))
    with open(os.path.join(workdir, "result.json"), "w") as f:
        json.dump(dict(
            steps=tier.steps, built_s=built_s, recover_s=recover_s, timer=dict(timer), recovery=report,
            snapshots=snapshots, drain_deferred=drain.get("flush", {}).get("deferred"),
            duplicate_txs=sum(dups.values()), txs=sum(txs.values()),
            wal_open_cycles=[lin for lin, c in wal_cycles(wal.records()).items() if not c["done"]],
            requests=dict(admitted=admitted, completed=completed, dropped=dropped,
                          unaccounted=max(0.0, admitted - completed - dropped)),
            fingerprints={cid: multi.claim_fingerprint(cid) for cid in names[:2]},
        ), f)


@phase("11c. the serving tier made durable at full width: killed mid-batch, recovered in a second process")
def durable_width_phase(torch, launches, serving):
    import collections
    import os
    import tempfile

    from svoc_torch.durability.faultspace import read_fired_log
    from svoc_torch.tools.crash_smoke import reconcile_counts

    card = nvidia_smi()
    workdir = tempfile.mkdtemp(prefix="durable-width-")
    me = str(Path(__file__).resolve())
    children = {}
    for role in ("crash", "recover"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, me, "--durable-child", workdir, role], capture_output=True,
                              text=True, timeout=600, cwd=str(Path(me).parent))
        children[role] = (proc, time.perf_counter() - t0)
        if proc.returncode not in (0, -9):
            print(proc.stderr[-3000:])

    def rows(role):
        path = os.path.join(workdir, f"rows-{role}.jsonl")
        return [json.loads(line) for line in open(path)] if os.path.exists(path) else []

    crash_rows, rec_rows = rows("crash"), rows("recover")
    fired = read_fired_log(os.path.join(workdir, "fired.jsonl"))
    action = fired["actions"][-1] if fired["actions"] else {}
    check(children["crash"][0].returncode == -9 and action.get("action") == "kill"
          and action.get("point") in DURABLE_KILLS and action.get("n") == DURABLE_KILLS[action["point"]]
          and [r["step"] for r in crash_rows] == list(range(1, DURABLE_KILL_STEP)),
          f"the first child died by SIGKILL (exit {children['crash'][0].returncode}) at the "
          f"{action.get('n')}th {action.get('point')} firing of step {DURABLE_KILL_STEP} (armed: {DURABLE_KILLS}; "
          f"fired {fired['fired']}), after steps {[r['step'] for r in crash_rows]}")
    if children["recover"][0].returncode != 0 or not os.path.exists(os.path.join(workdir, "result.json")):
        check(False, f"the recovery child exited {children['recover'][0].returncode}")
        return
    result = json.load(open(os.path.join(workdir, "result.json")))
    rep = result["recovery"] or {}
    rec = rep.get("reconcile") or {}
    counts = reconcile_counts(rec)
    landed = counts.get("landed_chain", 0) + counts.get("landed_batch", 0) + counts.get("landed_durable", 0)
    check(result["steps"] == DURABLE_STEPS and result["duplicate_txs"] == 0 and not result["wal_open_cycles"]
          and rec.get("unknown") == 0 and rec.get("unaccounted") == 0
          and result["requests"]["unaccounted"] == 0,
          f"recovered and ran to step {result['steps']}: {result['duplicate_txs']} duplicate txs over "
          f"{SERVING_CLAIMS} chain logs ({result['txs']} txs), open cycles {result['wal_open_cycles']}, "
          f"unknown {rec.get('unknown')} and unaccounted {rec.get('unaccounted')} WAL slots, requests "
          f"{result['requests']}")
    check(rec.get("open_cycles") == 1 and landed >= 1 and rec.get("resent", 0) >= 1
          and rec.get("resent") == counts.get("stranded", 0) and landed + counts.get("stranded", 0)
          + counts.get("skipped", 0) + counts.get("superseded", 0) == 7,
          f"the WAL's resent suffix and nothing more: one open cycle, {landed} slots landed, "
          f"{rec.get('resent')} resent of {counts.get('stranded', 0)} stranded ({counts})")
    n_layers = 12
    bad = [r for r in crash_rows + rec_rows
           if not (r["forwards"] >= 1 and r["launches"]["flash_attention"] == n_layers * r["forwards"]
                   and r["launches"]["gated_claims_consensus"] == 1 and r["launches"]["fused_consensus"] == 0
                   and r["launches"]["threefry"] == r["launches"]["fleet_draws"] == r["served"])]
    check(not bad and crash_rows and rec_rows,
          f"every step of both children: {n_layers} flash launches a forward, 1 claim-cube, 0 B2, threefry "
          f"and the fleet draws once a claim served ({len(crash_rows)} + {len(rec_rows)} steps; failing {bad[:2]})")
    for r in crash_rows + rec_rows:
        for k in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
            launches[k] = launches.get(k, 0) + r["launches"][k]

    timed_rows = crash_rows[1:] + rec_rows[1:]  # each child's first step warms its process
    mean = lambda k: sum(r[k] for r in timed_rows) / len(timed_rows)  # noqa: E731
    ten_b = f"{serving['step_ms']:.3f} ms" if serving else "not measured"
    wal_per_step = sum((collections.Counter(r["wal_records"]) for r in timed_rows), collections.Counter())
    print(f"  [{card}] step with durability on: {mean('step_ms'):.3f} ms over {len(timed_rows)} steps "
          f"(snapshots excluded), beside 10b's {ten_b} in this run; fsyncs {mean('fsyncs'):.1f} a step taking "
          f"{mean('fsync_ms'):.3f} ms; WAL records a step "
          f"{ {k: v / len(timed_rows) for k, v in wal_per_step.items()} }")
    snaps = result["snapshots"]
    crash_snaps = [(ms, b) for r in crash_rows for ms, b in zip(r["snapshot_ms"], r["snapshot_bytes"])]
    print(f"  [{card}] snapshots (ms, bytes): first child {crash_snaps}, second child "
          f"{[(round(s[0], 3), s[1]) for s in snaps]}")
    timer = result["timer"]
    print(f"  [{card}] recovery {result['recover_s']:.3f} s: chain-log replay {timer.get('chain_log_replay', 0):.3f} s "
          f"({SERVING_CLAIMS} logs, at construction), snapshot restore "
          f"{timer.get('load_snapshot', 0) + timer.get('restore_multi_session', 0):.3f} s (load "
          f"{timer.get('load_snapshot', 0):.3f}), journal roll-forward {timer.get('roll_forward_journal', 0):.3f} s "
          f"({rep.get('journal_events')} ring + {rep.get('tail_events')} tail events), WAL reconcile "
          f"{timer.get('reconcile_wal', 0):.3f} s; requeued {rep.get('requeued')}, lost requests "
          f"{rep.get('lost_requests')}; children {children['crash'][1]:.1f} s and {children['recover'][1]:.1f} s "
          f"(build {result['built_s']:.1f} s in the second)")
    print("  durable per step: " + json.dumps({"crash": crash_rows, "recover": rec_rows}))


#: Phase 5c's full-width fine-tune (cut from the reference's 240: steps only; 40 before the fine-tune moved onto the
#: mesh, whose 8 slots run serially on one card, 20 before the script's time was brought under 900 s).
FINETUNE_ROBERTA_STEPS = 10
#: 5c's unsharded step, flash against dense: SGD steps a configuration and their lr; the bf16 losses' rtol, where the
#: reference gives no bar (18e's; PERF.md §6).
UNSHARDED_STEPS, UNSHARDED_LR, BF16_LOSS_RTOL = 3, 1e-3, 5e-3


def unsharded_steps(torch, cfg, batch, dev):
    """``make_train_step`` on a fresh ``SentimentEncoder(cfg)`` for
    UNSHARDED_STEPS SGD steps of ``batch``: (losses, the first step's
    gradients by name, B1/B4/B5 launches of each step)."""
    from svoc_torch.models.encoder import SentimentEncoder, init_params
    from svoc_torch.train.trainer import init_state, make_train_step, sgd

    with torch.device("meta"):
        model = SentimentEncoder(cfg)
    state = init_state(model, init_params(cfg, seed=0, device=dev), sgd(UNSHARDED_LR), device=dev)
    step = make_train_step()
    losses, per_step, grads = [], [], None
    for _ in range(UNSHARDED_STEPS):
        wrappers = zero_counts(mesh_wrappers())
        state, metrics = step(state, batch)
        per_step.append(read_counts(wrappers))
        losses.append(metrics["loss"].item())
        if grads is None:  # the step leaves each parameter's gradient in place
            grads = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
    return losses, grads, per_step


def unsharded_phase_part(torch, launches, card):
    """5c's unsharded flash step against the dense step: TINY_TEST and
    full width in float32 at the reference's bars, and full width in
    bf16, the configuration's own type, held by its losses."""
    import numpy as np

    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, TINY_TEST
    from svoc_torch.train.trainer import Batch

    dev = torch.device("cuda")
    roberta_f32 = dataclasses.replace(ROBERTA_GO_EMOTIONS, dtype=torch.float32)
    for name, base, (b, t), density in (("TINY_TEST f32", TINY_TEST, (32, 48), 0.3),
                                        ("ROBERTA_GO_EMOTIONS f32", roberta_f32, (32, 128), 0.05),
                                        ("ROBERTA_GO_EMOTIONS bf16", ROBERTA_GO_EMOTIONS, (32, 128), 0.05)):
        rng = np.random.default_rng(5)
        ids = rng.integers(4, base.vocab_size, (b, t)).astype("int32")
        mask = (np.arange(t)[None, :] < rng.integers(6, t + 1, (b, 1))).astype("int32")
        labels = (rng.random((b, base.n_labels)) < density).astype("float32")
        batch = Batch(*(torch.from_numpy(a).to(dev) for a in (ids, mask, labels)))
        t0 = time.perf_counter()
        flash_losses, flash_grads, flash_counts = unsharded_steps(
            torch, dataclasses.replace(base, attention="flash"), batch, dev)
        dense_losses, dense_grads, dense_counts = unsharded_steps(torch, base, batch, dev)
        secs = time.perf_counter() - t0
        for counts in flash_counts:
            add_launches(launches, counts)
        want = dict.fromkeys(("flash_attention", "flash_dq", "flash_dkv"), base.n_layers)
        check(all(launches_are(c, want) for c in flash_counts) and all(launches_are(c, {}) for c in dense_counts),
              f"{name} unsharded flash step: B1, B4 and B5 {base.n_layers} launches each a step, the dense step "
              f"none ({flash_counts[0]}, {dense_counts[0]})")
        loss_err = max(abs(f - d) / abs(d) for f, d in zip(flash_losses, dense_losses))
        if base.dtype == torch.float32:  # tests/test_train.py::test_flash_train_step_matches_dense
            excess = max(float(((flash_grads[k] - g).abs() - 2e-3 * g.abs()).max()) for k, g in dense_grads.items())
            check(loss_err <= 1e-5 and excess <= 2e-5,
                  f"{name}: {UNSHARDED_STEPS} SGD({UNSHARDED_LR}) steps of make_train_step, flash against dense: "
                  f"losses rtol {loss_err:.3e} <= 1e-5, the first step's gradients within 2e-5 + 2e-3 |dense| "
                  f"(worst excess over 2e-3 |dense| {excess:.3e})")
        else:
            check(loss_err <= BF16_LOSS_RTOL,
                  f"{name}: {UNSHARDED_STEPS} SGD({UNSHARDED_LR}) steps of make_train_step, flash against dense: "
                  f"losses rtol {loss_err:.3e} <= {BF16_LOSS_RTOL}")
        print(f"  [{card}] {name} unsharded step [{b}, {t}]: losses flash {flash_losses}, dense {dense_losses}; "
              f"{secs:.1f} s for both", flush=True)


@phase("5c. the fine-tune twin (tools/finetune_demo.py) at full width on data(4) x model(2) slots, flash; the "
       "unsharded flash step against the dense one")
def finetune_phase(torch, launches):
    import numpy as np

    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.tools import finetune_demo

    card = nvidia_smi()
    counted = {"flash_attention": flash_attention_cuda, "flash_dq": flash_dq_cuda, "flash_dkv": flash_dkv_cuda}
    seen = []

    def on_step(_i):
        seen.append({k: w.launches for k, w in counted.items()})

    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    full = finetune_demo.run(config="roberta", attention="flash", device="cuda", steps=FINETUNE_ROBERTA_STEPS,
                             on_step=on_step)
    secs = time.perf_counter() - t0
    totals = {k: w.launches for k, w in counted.items()}
    add_launches(launches, totals)
    n_layers, steps = 12, full["steps"]
    slots = math.prod(finetune_demo.TRAIN_MESH)  # every slot runs its model shard's heads
    replayed, continued = steps - steps // 2, len(full["changed_mesh_continued_losses"])
    trained = steps + replayed + continued
    per_step = [{k: b[k] - a[k] for k in b} for a, b in zip(seen, seen[1:])]
    want = {"flash_attention": n_layers * (slots * trained + 2), "flash_dq": n_layers * slots * trained,
            "flash_dkv": n_layers * slots * trained}
    check(all(d == dict.fromkeys(counted, n_layers * slots) for d in per_step) and totals == want,
          f"flash fine-tune on data(4) x model(2) slots: {n_layers} x {slots} B1, B4 and B5 launches a train step "
          f"({len(per_step)} steps read), in all {totals} == {want} (2 unsharded evaluations, {steps} steps, "
          f"{replayed} replayed, {continued} on the changed mesh)")
    losses = full["loss_curve"]
    check(full["losses_finite"] and losses[-1] < losses[0] and np.isfinite(losses).all()
          and full["same_mesh_replay_max_abs_param_delta"] == 0.0
          and full["changed_mesh_restore_max_abs_param_delta"] == 0.0,
          f"ROBERTA_GO_EMOTIONS width on data(4) x model(2) slots (bf16 matmuls, flash, batch 32, "
          f"{FINETUNE_ROBERTA_STEPS} steps: cut from 240, steps only): the loss falls and stays finite "
          f"({losses[0]} -> {losses[-1]}), same-mesh replay and changed-mesh restore max|dparams| "
          f"{full['same_mesh_replay_max_abs_param_delta']} and {full['changed_mesh_restore_max_abs_param_delta']}")
    print(f"  [{card}] full width: loss {losses[:3]} ... {losses[-3:]}, macro-F1 {full['macro_f1_before']} -> "
          f"{full['macro_f1_after']} (target {full['target_f1']}, read, not demanded), train step "
          f"{full['step_ms']:.3f} ms, {full['comments_per_s']:.1f} trained comments/s, continued losses on 2x4 "
          f"{full['changed_mesh_continued_losses']}, {secs:.1f} s in all")
    unsharded_phase_part(torch, launches, card)


@phase("12a. the cold-start smoke on the card: prewarm, SIGKILL, warm restart, children on CUDA")
def coldstart_smoke_phase(torch):
    import tempfile

    from svoc_torch.ops import _build
    from svoc_torch.tools import coldstart_smoke

    card = nvidia_smi()
    parent_dir = _build.build_dir()
    with tempfile.TemporaryDirectory(prefix="coldstart-") as base:
        t0 = time.perf_counter()
        artifact = coldstart_smoke.run(0, base=base)  # device None: every child on CUDA
        secs = time.perf_counter() - t0
    legs = artifact["legs"]
    failed = sorted(k for k, v in artifact["checks"].items() if not v)
    check(not failed and not artifact["not_run"],
          f"the cold-start smoke's {len(artifact['checks'])} checks (fingerprints of the three legs equal, "
          f"warm_first SIGKILLed and built, warm_restart built nothing and hit): failed {failed}")
    check(artifact["reference_mismatches"] == {},
          f"every leg's per-claim and journal fingerprints == the JAX package's "
          f"(mismatches {artifact['reference_mismatches']})")
    restart = legs["warm_restart"]["prewarm_outcomes"]
    check(restart["compiled"] > 0 and restart["error"] == restart["budget_exhausted"] == 0
          and _build.build_dir() == parent_dir,
          f"warm_restart's walk finished its universe on the card ({restart}); this process built nothing "
          f"into the cache (its build directory stays {parent_dir.name})")
    for leg, r in legs.items():
        print(f"  [{card}] {leg}: {r['process_s']:.3f} s in its process, scenario {r['scenario_s']:.3f} s, "
              f"builds {r['cache_misses']:g} ({r['build_seconds']:.3f} s), cache hits {r['cache_hits']:g}, "
              f"prewarm {r['prewarm_outcomes']}")
    print(f"  [{card}] cold-start smoke: {secs:.3f} s for three children")


#: Phase 12b: steps each child serves (cut from the open-ended serving
#: loop: steps only).
COLDSTART_STEPS = 3
WARMTHS = ("cold", "prewarmed", "warm")


def coldstart_width_run(torch, workdir: str, role: str, t_launch=None, device=None, cfg=None,
                        claims: int = SERVING_CLAIMS, arrivals: int = SERVING_ARRIVALS, comments: int = 256):
    """One run of phase 12b: 10b's tier with a ``RecoveryManager`` on
    ``workdir``.  ``role`` "cold": the persistent kernel cache (empty),
    no prewarm, 3 steps, a snapshot, then a SIGKILL of this process;
    "warm": the same cache, ``recover(prewarm=True)``, steps 4-6;
    "uninterrupted": in this process with the cache off, steps 1-6,
    returning the tier and its per-claim consensus.  Every arrival is a
    fresh text (no cache hit), so that both sides vectorize the same
    batches.  A child writes ``result-<role>.json``.  ``t_launch`` is the
    ``time.time()`` at which the parent started the process; ``device``
    ``cfg``, ``claims``, ``arrivals`` and ``comments`` shrink the run
    for a CPU rehearsal (``device="cpu"``: nothing is built there)."""
    import os
    import signal

    from svoc_torch.utils.metrics import compile_snapshot, install_compile_listener
    from svoc_torch.utils.metrics import registry as process_registry

    t_start = time.time()
    t_launch = t_start if t_launch is None else float(t_launch)
    install_compile_listener()
    from svoc_torch.durability.recovery import RecoveryManager
    from svoc_torch.fabric import ClaimSpec, MultiSession
    from svoc_torch.fabric.scenario import _claim_names, _injection_schedule
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry

    def sync():
        if device is None:
            torch.cuda.synchronize()

    from svoc_torch.models import sentiment

    if device is None:
        torch.cuda.init()
    t_imported = time.time()
    names = _claim_names(claims)
    offender = names[-1]
    kinds = _injection_schedule(0, offender, 1 + 2 * COLDSTART_STEPS)
    # The pipeline's construction, split: the seeded draws, the two
    # modules taking the weights, the native tokenizer's load.
    parts = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                parts[name] = parts.get(name, 0.0) + time.time() - t0
        return run

    if role != "uninterrupted":  # a child: nothing else in its process builds a pipeline
        for name in ("init_params", "load_encoder", "load_tokenizer"):
            setattr(sentiment, name, timed(name, getattr(sentiment, name)))
    pipe = width_pipeline(torch, cfg, device or "cuda")
    sync()
    t_pipeline = time.time()
    forwards = []
    packed_forward = pipe.packed_forward

    def counted_forward(*arrays):
        forwards.append(1)
        return packed_forward(*arrays)

    pipe.packed_forward = counted_forward
    metrics = MetricsRegistry()
    journal = EventJournal(capacity=1 << 17)
    multi = MultiSession(base_seed=0, vectorizer=pipe, journal=journal, metrics=metrics, lineage_scope="cst",
                         sanitized_dispatch=True, max_claims_per_batch=claims, warmup_mode="prewarm",
                         device=device)
    tamper = fabric_tamper(kinds, 6)
    for cid in names:
        multi.add_claim(ClaimSpec(claim_id=cid, tamper=tamper if cid == offender else None))
    tier = width_tier(multi, pipe, metrics, claims, arrivals)
    manager = RecoveryManager(multi, out_dir=workdir, tier=tier,
                              compilation_cache="off" if role == "uninterrupted" else "persistent")
    t_built = time.time()
    # The restart recovers before its first forward, so that a library
    # its prewarm left out would load or build inline, where 12b sees it.
    report = manager.recover(prewarm=True) if role == "warm" else None
    t_recovered = time.time()
    compile_recovered = compile_snapshot(process_registry)
    calibrate_head(torch, pipe, comments=comments)  # the first forward: B1's build or load when cold
    t_calibrated = time.time()
    counted = {"flash_attention": flash_attention_cuda, "gated_claims_consensus": fused_consensus_gated_claims_cuda,
               "threefry": threefry_cuda, "fleet_draws": fleet_draws_cuda}

    def serve(step_no: int) -> dict:
        texts = iter(SyntheticSource(batch=claims * arrivals, seed=2000 + step_no)())
        for cid in names:
            for j in range(arrivals):
                tier.submit(cid, f"{next(texts)} #{step_no}-{cid}-{j}")
        sync()
        for wrapper in counted.values():
            wrapper.launches = 0
        forwards.clear()
        warmth0 = {w: metrics.counter("consensus_dispatch", labels={"warmth": w}).count for w in WARMTHS}
        t0 = time.perf_counter()
        out = tier.step()
        return dict(step=tier.steps, step_ms=(time.perf_counter() - t0) * 1e3, served=len(out["served"]),
                    forwards=len(forwards), launches={k: w.launches for k, w in counted.items()},
                    warmth={w: metrics.counter("consensus_dispatch", labels={"warmth": w}).count - warmth0[w]
                            for w in WARMTHS},
                    at_s=time.time() - t_launch)

    rows = []
    end = COLDSTART_STEPS if role == "cold" else 2 * COLDSTART_STEPS
    while tier.steps < end:
        rows.append(serve(tier.steps))
    consensus = {cid: multi.get(cid).last_consensus for cid in names}
    result = dict(
        role=role, rows=rows, first_served_s=next((r["at_s"] for r in rows if r["served"]), None),
        imported_s=t_imported - t_launch, pipeline_s=t_pipeline - t_launch, pipeline_parts=parts,
        built_s=t_built - t_launch,
        calibrated_s=t_calibrated - t_launch, recovered_s=t_recovered - t_launch,
        compile=compile_snapshot(process_registry), compile_recovered=compile_recovered,
        prewarm=(report or {}).get("prewarm"),
        cache_errors=metrics.family_total("compile_cache_errors"), cache_dir=manager.compile_cache_dir,
        cache=manager.status()["compile_cache"], consensus=consensus,
    )
    if role == "uninterrupted":
        return dict(result, tier=tier, serve=serve)
    if role == "cold":
        manager.snapshot()
        result["cache"] = manager.status()["compile_cache"]
    with open(os.path.join(workdir, f"result-{role}.json"), "w") as f:
        json.dump(result, f)
    if role == "cold":
        os.kill(os.getpid(), signal.SIGKILL)  # the crash: after the snapshot, before anything else
    return None


@phase("12b. cold start at full width: 10b's tier, a cold child killed, a warm restart from the kernel cache")
def coldstart_width_phase(torch, launches, serving_main):
    import os
    import tempfile

    card = nvidia_smi()
    workdir = tempfile.mkdtemp(prefix="coldstart-width-")
    me = str(Path(__file__).resolve())
    children = {}
    for role in ("cold", "warm"):
        t_launch = time.time()
        proc = subprocess.run([sys.executable, me, "--coldstart-child", workdir, role, repr(t_launch)],
                              capture_output=True, text=True, timeout=600, cwd=str(Path(me).parent))
        children[role] = proc
        if proc.returncode not in (0, -9):
            print(proc.stderr[-3000:])
    results = {}
    for role in ("cold", "warm"):
        path = os.path.join(workdir, f"result-{role}.json")
        results[role] = json.load(open(path)) if os.path.exists(path) else None
    cold, warm = results["cold"], results["warm"]
    check(children["cold"].returncode == -9 and children["warm"].returncode == 0 and cold and warm,
          f"the cold child died by SIGKILL after its snapshot (exit {children['cold'].returncode}), the warm "
          f"child ran to its end (exit {children['warm'].returncode})")
    if not (cold and warm):
        return None
    t0 = time.perf_counter()
    ref = coldstart_width_run(torch, tempfile.mkdtemp(prefix="coldstart-uninterrupted-"), "uninterrupted")
    uninterrupted_s = time.perf_counter() - t0
    n_layers = 12
    rows = cold["rows"] + warm["rows"]
    bad = [r for r in rows if not (r["forwards"] >= 1 and r["served"] == SERVING_CLAIMS
                                   and r["launches"]["flash_attention"] == n_layers * r["forwards"]
                                   and r["launches"]["gated_claims_consensus"] == 1)]
    check(not bad and [r["step"] for r in rows] == list(range(1, 2 * COLDSTART_STEPS + 1)),
          f"steps 1-{COLDSTART_STEPS} cold and {COLDSTART_STEPS + 1}-{2 * COLDSTART_STEPS} after the restart: "
          f"{SERVING_CLAIMS} claims served, {n_layers} B1 launches a forward, B3 once a step (failing {bad[:2]})")
    for r in rows:
        for k in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
            launches[k] = launches.get(k, 0) + r["launches"][k]
    prewarm = warm["prewarm"] or {}
    outcomes = (prewarm.get("report") or {}).get("outcomes", {})
    check(cold["compile"]["cache_misses"] > 0 and warm["compile"]["cache_misses"] == 0
          and warm["compile"]["cache_hits"] > 0 and warm["compile"]["kernel_builds_total"] == 0,
          f"the cold child built into the empty cache ({cold['compile']['cache_misses']:g} builds); the restart "
          f"built nothing ({warm['compile']['cache_misses']:g} builds, {warm['compile']['cache_hits']:g} hits)")
    inline = {k: warm["compile"][k] - warm["compile_recovered"][k] for k in ("cache_misses", "cache_hits")}
    check(inline == {"cache_misses": 0, "cache_hits": 0},
          f"the restart's prewarm built or loaded every library its forward, fetch and consensus launch: "
          f"none built or loaded after the recovery ({inline})")
    check(bool(outcomes) and set(outcomes) <= {"compiled", "primed"} and cold["cache_errors"] == 0
          and warm["cache_errors"] == 0,
          f"the restart's prewarm walk: every outcome compiled or primed ({outcomes}), compile_cache_errors "
          f"{cold['cache_errors']:g} and {warm['cache_errors']:g}")
    first = warm["rows"][0]["warmth"]
    check(first["prewarmed"] == 1 and first["cold"] == 0,
          f"the restart's first dispatch counts prewarmed ({first}); the cold child's first "
          f"{cold['rows'][0]['warmth']}")
    ref_consensus = json.loads(json.dumps(ref["consensus"]))  # as the child's went through its file
    same = {cid: warm["consensus"][cid] == ref_consensus[cid] for cid in ref_consensus}
    check(all(same.values()),
          f"per-claim consensus after the recovery == an uninterrupted run's in this process "
          f"({sum(same.values())} of {len(same)} claims equal)")

    def steady(result):
        ms = [r["step_ms"] for r in result["rows"][1:]]
        return sum(ms) / len(ms)

    for result in (cold, warm):
        c = result["compile"]
        walk = (result["prewarm"] or {}).get("report") or {}
        print(f"  [{card}] {result['role']}: first step served {result['first_served_s']:.3f} s after the "
              f"process started (torch, CUDA and the package imported {result['imported_s']:.3f} s, the "
              f"encoder's weights on the card {result['pipeline_s']:.3f} s "
              f"{ {k: round(v, 3) for k, v in result['pipeline_parts'].items()} }, the {SERVING_CLAIMS} claims' "
              f"tier and its recovery manager {result['built_s']:.3f} s, recovered "
              f"{result['recovered_s']:.3f} s, first forward done {result['calibrated_s']:.3f} s); first step "
              f"{result['rows'][0]['step_ms']:.3f} ms beside the steady {steady(result):.3f} ms; builds "
              f"{c['kernel_builds_total']:g} taking {c['kernel_build_seconds_sum']:.3f} s, cache hits "
              f"{c['cache_hits']:g}; prewarm walk {walk.get('universe', {}).get('keys')} keys in "
              f"{walk.get('elapsed_s')} s, outcomes {walk.get('outcomes')}; consensus_dispatch "
              f"{ {w: sum(r['warmth'][w] for r in result['rows']) for w in WARMTHS} }; cache {result['cache']}")
    print(f"  [{card}] uninterrupted run in this process: {uninterrupted_s:.3f} s, steady step "
          f"{steady(ref):.3f} ms")
    print("  cold start per step: " + json.dumps({"cold": cold["rows"], "warm": warm["rows"]}))
    return ref


@phase("12c. the profiler and the runtime gauges")
def profiler_phase(torch, launches, uninterrupted, serving_main):
    import os
    import tempfile

    from torch.autograd import DeviceType

    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.obsplane import ProfileCapture
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import (MetricsRegistry, encoder_matmul_flops_per_token, sample_runtime_gauges,
                                          set_mfu_gauge)

    card = nvidia_smi()
    if uninterrupted is None:
        check(False, "12b's tier is missing: nothing to capture")
        return
    journal = EventJournal()
    capture = ProfileCapture(tempfile.mkdtemp(prefix="profiles-"), journal=journal, metrics=MetricsRegistry())
    started = capture.start(trigger="manual")
    row = uninterrupted["serve"](uninterrupted["tier"].steps)
    torch.cuda.synchronize()
    stopped = capture.stop()
    for k in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + row["launches"][k]
    trace = os.path.join(stopped.get("path", ""), "trace.json")
    device = [e for e in capture.last.key_averages() if e.device_type == DeviceType.CUDA] if capture.last else []
    names = {"flash": "flash_fwd", "B3": "gated_claims_kernel", "threefry": "threefry_kernel",
             "fleet draws": "fleet_draws_kernel"}
    named = {k: any(v in e.key for e in device) for k, v in names.items()}
    check(started["status"] == "started" and stopped["status"] == "captured" and os.path.exists(trace)
          and all(named.values()) and len(journal.recent(type="profile.captured")) == 1,
          f"ProfileCapture of one 10b step: {stopped['status']}, trace {os.path.getsize(trace) if os.path.exists(trace) else 0} "
          f"bytes, its device operations name {named}")
    top = sorted(device, key=device_us, reverse=True)[:5]
    print(f"  [{card}] the captured step's top five by device time: "
          + "; ".join(f"{e.key[:60]} {device_us(e) / 1e3:.3f} ms x{e.count}" for e in top))
    gauges = sample_runtime_gauges(MetricsRegistry())
    live = gauges.get('device_live_bytes{device="cuda:0"}', 0.0)
    check(live > 0, f"sample_runtime_gauges: device_live_bytes for cuda:0 {live:g} bytes, "
                    f"device_live_arrays {gauges.get('device_live_arrays')}")
    if serving_main is None:
        check(False, "4b's device step is missing: no MFU")
        return
    forward_ms = [r["forward_ms"] for r in serving_main["rows"]]
    step_s = sum(forward_ms) / len(forward_ms) / 1e3
    tokens = 256 * 128
    flops = encoder_matmul_flops_per_token(ROBERTA_GO_EMOTIONS, 128) * tokens
    mfu = set_mfu_gauge(step_s, flops, reg=MetricsRegistry())
    check(mfu is not None and 0 < mfu < 1, f"set_mfu_gauge on 4b's forward: {mfu}")
    print(f"  [{card}] MFU of 4b's forward ({step_s * 1e3:.3f} ms by CUDA events for {tokens} token positions, "
          f"{flops / 1e12:.3f} TFLOP by bench.py's model) against the H100's dense bf16 989 TFLOP/s: {mfu:.4f}")


#: Phase 13c/13d: the fleet's replicas, steps, kill, failover and migration steps.
FLEET_REPLICAS, FLEET_STEPS, FLEET_KILL_STEP, FLEET_FAILOVER_STEP, FLEET_MIGRATE_STEP = 3, 10, 4, 6, 8
FLEET_BENCH_STEPS = 2  # phase 13d, on 1 and on 3 replicas (cut from 4 for phase 18, from 3 for the 900 s)
#: A replica's queue capacity, per claim (10b's).
FLEET_QUEUE_CAPACITY = 64
#: A replica's request-latency target (``2.5 * step_period_s`` in ``Replica``).  A request
#: waits for a whole cluster step (one host thread steps the replicas in turn: 1.2-4.7 s on
#: the card's hosts) and a failed-over backlog for three (6.7-9.6 s).  At 10b's 5 s the
#: survivors' tiers shed by ``slo_burn`` on most hosts, and on a slow disk r1's own tier shed
#: its burst before the kill, leaving its failover nothing to drain; the fleet's target is
#: well above both, so that its tiers shed only under real overload.
FLEET_LATENCY_TARGET_S = 30.0
FLEET_STEP_PERIOD_S = FLEET_LATENCY_TARGET_S / 2.5


class TierSteps:
    """Every ``ServingTier.step`` of a run (replica steps, migration and
    graceful drains alike): the claims it served and the claim-cube
    groups they make (``batch`` claims a fabric cycle, one group per
    (oracles, dimension, config) shape among them), from which the run's
    B3, threefry and fleet-draws launches are predicted."""

    def __init__(self, batch: int):
        self.batch, self.steps, self.served, self.groups = batch, 0, 0, 0

    def __enter__(self):
        from svoc_torch.serving.tier import ServingTier

        self._tier, self._step = ServingTier, ServingTier.step
        counter = self

        def step(tier, *args, **kwargs):
            report = counter._step(tier, *args, **kwargs)
            counter.steps += 1
            counter.served += len(report["served"])
            served = report["served"]
            for i in range(0, len(served), counter.batch):
                counter.groups += len({(spec.n_oracles, spec.dimension, spec.consensus_config())
                                       for spec in (tier.multi.get(c).spec for c in served[i:i + counter.batch])})
            return report

        ServingTier.step = step
        return self

    def __exit__(self, *exc):
        self._tier.step = self._step

    def predicted(self) -> dict:
        """B3 once a dispatched group; threefry (the fetch's key split) and
        the fleet draws (``draw_fleet``'s one launch) once a claim served."""
        return {"gated_claims_consensus": self.groups, "threefry": self.served, "fleet_draws": self.served}


def counted_wrappers():
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_gated_claims_cuda
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda

    return {"flash_attention": flash_attention_cuda, "gated_claims_consensus": fused_consensus_gated_claims_cuda,
            "fused_consensus": fused_consensus_cuda, "threefry": threefry_cuda, "fleet_draws": fleet_draws_cuda}


def shed_reasons(trace_path: str) -> dict:
    """``cluster.unavailable`` events of a cluster journal's trace, by reason."""
    import collections

    from svoc_torch.utils.events import read_trace_events

    return dict(collections.Counter(e["data"].get("reason") for e in read_trace_events(trace_path)
                                    if e["event"] == "cluster.unavailable"))


@phase("13a. the cluster smoke on the card: 3 replicas, a kill and a failover, against the reference")
def cluster_smoke_phase(torch, launches):
    import os
    import tempfile

    from svoc_torch.tools import cluster_smoke

    base = tempfile.mkdtemp(prefix="cluster-smoke-")
    wrappers = counted_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with TierSteps(cluster_smoke.N_CLAIMS) as steps:
        artifact = cluster_smoke.run(0, None, base)  # device None: CUDA
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    for c in artifact["checks"]:
        check(c["ok"], f"cluster smoke: {c['check']}" + (f" ({c['detail']})" if c["detail"] else ""))
    check(artifact["reference_mismatches"] == {},
          f"the per-claim and fleet fingerprints equal the JAX package's: fleet "
          f"{artifact['fleet_fingerprint'][:16]}, mismatches {artifact['reference_mismatches']}")
    reasons = [shed_reasons(os.path.join(r["workdir"], "cluster-trace.jsonl")) for r in artifact["runs"]]
    check(all(set(r) == {"replica_down"} for r in reasons),
          f"every shed of both runs is the outage's replica_down, no forward_error: {reasons}")
    predicted = steps.predicted()
    check(counts["gated_claims_consensus"] > 0 and counts["threefry"] > 0
          and {k: counts[k] for k in predicted} == predicted and counts["flash_attention"] == 0
          and counts["fused_consensus"] == 0,
          f"launches {counts} == predicted {predicted} ({steps.steps} tier steps served "
          f"{steps.served} claims in {steps.groups} groups; no encoder, no B2)")
    for k in ("gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + counts[k]
    print(f"  [{nvidia_smi()}] two runs {seconds:.3f} s; requests {artifact['requests']}; "
          f"cluster counters {artifact['cluster_counters']}; epoch {artifact['epoch']}")


@phase("13b. the fleet-obs smoke on the card: replay invisibility, merge identity, anomaly -> profile")
def fleet_obs_smoke_phase(torch, launches):
    import glob
    import os
    import tempfile

    from svoc_torch.tools import fleet_obs_smoke

    base = tempfile.mkdtemp(prefix="fleet-obs-smoke-")
    wrappers = counted_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with TierSteps(max(fleet_obs_smoke.KILL_PLAN["n_claims"], fleet_obs_smoke.DEGRADATION_PLAN["n_claims"])) \
            as steps:
        artifact = fleet_obs_smoke.run(0, None, base)
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    for name, ok in artifact["checks"].items():
        check(ok, f"fleet-obs smoke: {name}")
    check(artifact["fleet_fingerprint"] == fleet_obs_smoke.REFERENCE_FLEET_FINGERPRINTS[0],
          f"the fleet fingerprint equals the JAX package's in all four runs: {artifact['fingerprints']}")
    reasons = {leg: shed_reasons(os.path.join(base, leg, "cluster-trace.jsonl"))
               for leg in ("on_a", "on_b", "off_a", "off_b", "quiet", "degraded")}
    check(all(set(r) <= {"replica_down"} for r in reasons.values()),
          f"no forward_error shed in any leg: {reasons}")
    traces = sorted(glob.glob(os.path.join(base, "degraded", "profiles", "profile-*", "trace.json")))
    kernels = set()
    for path in traces:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        kernels |= {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    named = {k: any(k in n for n in kernels) for k in ("gated_claims_kernel", "threefry_kernel",
                                                       "fleet_draws_kernel")}
    check(len(traces) == 1 and (artifact["profiler"] or {}).get("active") is None and all(named.values()),
          f"the sustained anomaly's capture stopped and wrote {len(traces)} trace(s) whose CUDA kernels "
          f"name {named} ({len(kernels)} distinct kernels)")
    predicted = steps.predicted()
    check({k: counts[k] for k in predicted} == predicted and counts["flash_attention"] == 0,
          f"launches {counts} == predicted {predicted}")
    for k in ("gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + counts[k]
    stats = artifact["hop_coverage"]["stats"]
    print(f"  [{nvidia_smi()}] six runs {seconds:.3f} s; {stats['chains']} hop chains "
          f"{stats['by_classification']}; anomalies {len(artifact['anomalies'])}, bundles "
          f"{len(artifact['bundles'])}")


def fleet_width_run(torch, pipe, n_replicas: int, steps: int, *, kill_step=None, failover_step=None,
                    migrate_step=None, device=None, claims: int = SERVING_CLAIMS,
                    arrivals: int = SERVING_ARRIVALS, base_dir=None,
                    step_period_s: float = FLEET_STEP_PERIOD_S, reconfig=None, faults=(),
                    read_steps=()) -> dict:
    """One fleet of 10b's tiers over ``pipe`` in a fresh directory (under
    ``base_dir``, else the temporary directory): every replica a
    ``Replica`` whose tier and fabric vectorize through ``pipe``, placed
    by rendezvous, the fleet plane on, the latency target
    ``2.5 * step_period_s``.  With ``kill_step``, r1's claims
    are filled to their queues' capacity in the step before it (the
    backlog its post-step snapshot keeps), and r1 dies after the kill
    step's submits, before its ``step_all``.  ``reconfig`` maps a step to
    ``dict(plan=ReconfigPlan, traffic=bool)``: after that step's
    ``step_all`` a ``ReconfigController`` applies the plan (rolling), with
    one arrival for every claim at each stage boundary when ``traffic``;
    with ``plan=None`` and ``script=`` (an apply's ``script``: its holds,
    probes, drains and release, in order) the same router-level work runs
    with no apply, the never-attempted baseline of an abort.  ``faults``
    are armed with the run (``FaultEvent``s); the per-claim fingerprints
    and the router's snapshot with its epoch chain are read after each
    step of ``read_steps``.  Returns the
    per-step rows, the failover's, the migration's and the transitions'
    reports with their times, and what the checks read."""
    import collections
    import os
    import tempfile

    import numpy as np

    from svoc_torch.cluster import ClusterRouter, PlacementDirectory, ReconfigController, Replica
    from svoc_torch.cluster.replica import lineage_cursor
    from svoc_torch.compile import prewarm as prewarm_mod
    from svoc_torch.cluster.scenario import LINEAGE_SCOPE
    from svoc_torch.durability import faultspace
    from svoc_torch.durability import recovery as recovery_mod
    from svoc_torch.durability.chainlog import duplicate_predictions, read_chain_log
    from svoc_torch.fabric import ClaimSpec
    from svoc_torch.fabric.scenario import _claim_names, _injection_schedule
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.obsplane.fleet import FleetPlane
    from svoc_torch.resilience.retry import RetryPolicy
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry
    from svoc_torch.utils.metrics import registry as process_registry

    cuda = (device or "cuda") != "cpu"
    workdir = tempfile.mkdtemp(prefix=f"fleet-width-{n_replicas}-", dir=base_dir)
    chain_dir = os.path.join(workdir, "chain")
    names = _claim_names(claims)
    offender = names[-1]
    kinds = _injection_schedule(0, offender, 1 + steps)
    timer = collections.defaultdict(float)
    per_claim = collections.defaultdict(dict)
    forward_ev, current = [], {}
    packed_forward = pipe.packed_forward

    def timed_forward(*arrays):
        if not cuda:
            forward_ev.append(None)
            return packed_forward(*arrays)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = packed_forward(*arrays)
        ev[1].record()
        forward_ev.append(ev)
        return out

    stages = ("fetch", "fabric_consensus")

    class WidthReplica(Replica):
        """A replica whose fabric and tier vectorize through ``pipe``;
        its steps, recovery and migration boundaries are timed."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.multi._vectorizer = pipe
            self.tier._vectorizer = pipe
            self.tier.batcher.vectorizer = pipe

        def step(self):
            n_fwd = len(forward_ev)
            span0 = {s: process_registry.histogram("stage_seconds", labels={"stage": s}).sum for s in stages}
            commit0 = process_registry.timer("commit_latency").total_s
            t0 = time.perf_counter()
            report = super().step()
            row = current.setdefault(self.replica_id, collections.defaultdict(float))
            row["ms"] += (time.perf_counter() - t0) * 1e3
            row["forward_events"] = row.get("forward_events", []) + forward_ev[n_fwd:]
            for s in stages:
                row[f"{s}_ms"] += (process_registry.histogram("stage_seconds", labels={"stage": s}).sum
                                   - span0[s]) * 1e3
            row["commit_ms"] += (process_registry.timer("commit_latency").total_s - commit0) * 1e3
            row["served"] += len(report["served"])
            row["requests"] += report["requests"]
            row["completed"] += len(report["latencies_s"])
            row["dropped"] += report["dropped"]
            row["latencies"] = row.get("latencies", []) + list(report["latencies_s"])
            return report

        def add_claim(self, spec):
            t0 = time.perf_counter()
            try:
                return super().add_claim(spec)
            finally:
                timer["add_claim"] += time.perf_counter() - t0

        def recover(self):
            t0 = time.perf_counter()
            try:
                return super().recover()
            finally:
                timer["recover"] += time.perf_counter() - t0

        def drain_claim(self, claim_id, max_steps=8):
            row = current.get(self.replica_id, {})
            before = {k: row.get(k, 0.0) for k in ("completed", "dropped")}
            t0 = time.perf_counter()
            report = super().drain_claim(claim_id, max_steps)
            row = current.get(self.replica_id, {})
            per_claim[claim_id].update(
                drain_s=time.perf_counter() - t0, flush_steps=report["flush_steps"],
                deferred=report["deferred"], **{f"drain_{k}": row.get(k, 0.0) - v for k, v in before.items()})
            return report

        def ship_claim(self, claim_id):
            t0 = time.perf_counter()
            cursor = lineage_cursor(self.multi.get(claim_id).session)
            entry = super().ship_claim(claim_id)
            per_claim[claim_id]["ship_s"] = time.perf_counter() - t0
            # Landed cycles the shipped cursor skips, each one PRNG split burned.
            per_claim[claim_id]["burned"] = entry["session"]["fetch_claim"] - cursor
            return entry

        def adopt_claim(self, claim_id, entry, spec=None):
            t0 = time.perf_counter()
            try:
                return super().adopt_claim(claim_id, entry, spec=spec)
            finally:
                per_claim[claim_id]["adopt_s"] = time.perf_counter() - t0

    def make_replica(rid, *, fingerprint_epoch=0, consensus_impl=None, mesh=None, commit_mode="batched"):
        return WidthReplica(rid, os.path.join(workdir, f"replica-{rid}"), chain_dir=chain_dir, seed=0,
                            clock=WallClock(), lineage_scope=LINEAGE_SCOPE, commit_mode=commit_mode,
                            consensus_impl=consensus_impl, mesh=mesh, fingerprint_epoch=fingerprint_epoch,
                            step_period_s=step_period_s, queue_capacity=FLEET_QUEUE_CAPACITY,
                            max_requests_per_step=claims * arrivals, max_claims_per_batch=claims,
                            device=device)

    def replica_factory(rid):
        t0 = time.perf_counter()
        replica = make_replica(rid)
        timer["build"] += time.perf_counter() - t0
        return replica

    # The transition in flight: phase marks, the stack builds, prepare,
    # rollback and commit seconds.
    transition = {}

    def builder(rid, **knobs):
        """The reconfiguration plane's builder: a re-pinned stack snapshots
        on the fleet's cadence."""
        t0 = time.perf_counter()
        replica = make_replica(rid, **knobs)
        replica.install_cadence(DURABLE_SNAPSHOT_EVERY)
        transition["stack_build"][rid] = time.perf_counter() - t0
        return replica

    class TimedController(ReconfigController):
        """Marks each phase's start (by replica), and times PREPARE, the
        rollback and the commit."""

        def _enter(self, phase):
            label = phase if phase in ("prepare", "resume") else f"{phase} {self._rid}"
            transition["marks"].append((label, time.perf_counter()))
            super()._enter(phase)

        def _transition_one(self, rid, *args):
            self._rid = rid
            return super()._transition_one(rid, *args)

        def _timed(self, name, fn, *args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                transition[f"{name}_s"] = time.perf_counter() - t0

        def _prepare(self, plan):
            transition["prepare"] = self._timed("prepare", super()._prepare, plan)
            return transition["prepare"]

        def _rollback(self, staged):
            return self._timed("rollback", super()._rollback, staged)

        def _drain(self, replica):
            transition["script"].append(("drain", replica.replica_id))
            return super()._drain(replica)

        def _commit(self, *args):
            return self._timed("commit", super()._commit, *args)

    primes = [0]
    real_prime = prewarm_mod.prime_key

    def counted_prime(key, dev):
        primes[0] += 1
        return real_prime(key, dev)

    # Every fsync of the run (the replicas' WALs, chain logs, traces and
    # snapshots, the cluster journal and placement), counted and timed,
    # and counted by the kind of file.
    fsyncs = collections.Counter()
    real_fsync = os.fsync
    kinds_of = (("trace", "trace"), ("wal", "wal"), ("chain-", "chain"), ("snapshot", "snapshot"),
                ("placement", "placement"), ("fired", "fired"))

    def timed_fsync(fd):
        t0 = time.perf_counter()
        real_fsync(fd)
        fsyncs["s"] += time.perf_counter() - t0
        fsyncs["n"] += 1
        try:
            name = os.path.basename(os.readlink(f"/proc/self/fd/{fd}"))
        except OSError:
            name = ""
        fsyncs[next((kind for key, kind in kinds_of if key in name), "other")] += 1

    recovery_parts = ("load_snapshot", "restore_multi_session", "roll_forward_journal", "reconcile_wal")
    real_parts = {name: getattr(recovery_mod, name) for name in recovery_parts}

    def timed_part(name):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real_parts[name](*args, **kwargs)
            finally:
                timer[name] += time.perf_counter() - t0
        return run

    metrics, journal = MetricsRegistry(), EventJournal(capacity=1 << 17)
    trace_path = os.path.join(workdir, "cluster-trace.jsonl")
    journal.set_trace_file(trace_path)
    plane = FleetPlane(enabled=True, clock=time.monotonic, journal=journal,
                       trace_path=os.path.join(workdir, "fleet-obs.jsonl"),
                       profile_dir=os.path.join(workdir, "profiles"), bundle_dir=workdir,
                       slo_latency_target_s=2.5 * step_period_s,
                       slo_fast_window_s=10 * step_period_s, slo_slow_window_s=50 * step_period_s)
    placement = PlacementDirectory([], path=os.path.join(workdir, "placement.json"))
    router = ClusterRouter(placement, journal=journal, metrics=metrics, clock=time.monotonic,
                           retry=RetryPolicy(max_attempts=2, base_s=0.0, cap_s=0.0, jitter_seed=0),
                           replica_factory=replica_factory, lineage_scope=LINEAGE_SCOPE,
                           unclaimed_path=os.path.join(workdir, "unclaimed.json"), fleet_plane=plane)
    controller = TimedController(router, builder=builder, journal=journal, metrics=metrics, clock=time.monotonic,
                                 prewarm_budget_s=60.0)
    obs_paths = [os.path.join(workdir, "fleet-obs.jsonl")]
    for i in range(n_replicas):
        replica = replica_factory(f"r{i}")
        replica.install_cadence(DURABLE_SNAPSHOT_EVERY)
        router.add_replica(replica)
        obs_paths.append(replica.obs_path)
    tamper = fabric_tamper(kinds, 6)
    for cid in names:
        router.add_claim(ClaimSpec(claim_id=cid, tamper=tamper if cid == offender else None))
    setup = dict(timer)
    timer.clear()

    pipe.packed_forward = timed_forward
    os.fsync = timed_fsync
    for name in recovery_parts:
        setattr(recovery_mod, name, timed_part(name))
    wrappers = counted_wrappers()
    prewarm_mod.prime_key = counted_prime
    fault_controller = faultspace.arm(faultspace.FaultController(list(faults),
                                                                 log_path=os.path.join(workdir, "fired.jsonl")))
    rows, events = [], {}
    rng = np.random.default_rng(11)
    pool = SyntheticSource(batch=10, seed=777)()
    fresh = iter(SyntheticSource(batch=claims * FLEET_QUEUE_CAPACITY * steps, seed=778)())

    def arrival():
        return pool[int(rng.integers(0, len(pool)))] if rng.random() < 0.35 else next(fresh)

    def state():
        return dict(fleet=router.fleet_fingerprint(), epoch=router.reconfig_epoch, journal=journal.last_seq(),
                    replicas={r: router.replica(r).journal.last_seq() for r in router.replica_ids()},
                    accounting={k: v for k, v in router.fleet_accounting().items() if k != "observations"},
                    epoch_files=sorted(
                        os.path.relpath(os.path.join(d, f), workdir) for d, _, fs in os.walk(workdir) for f in fs
                        if re.search(r"-e[0-9]+\.jsonl$", f)))

    def flush(replica):
        """What the controller's DRAIN does to a replica: its queues served
        to empty."""
        while sum(replica.tier.frontend.depths().values()) > 0:
            replica.step()

    def reconfigure(plan, traffic, script=None):
        """One ``apply`` under the submit log: returns its report, its
        seconds by phase, the deferred requests, their release (timed) and
        the apply's ``script`` of router-level work.  With ``plan=None``,
        ``script`` is replayed instead of an apply."""
        transition.clear()
        transition.update(marks=[], stack_build={}, script=[])
        before, primed = state(), primes[0]
        log = []
        real_submit, real_hold = router.submit, router.hold_replica

        def logged_submit(cid, text, **kwargs):
            response = real_submit(cid, text, **kwargs)
            log.append((cid, text, response["status"], time.perf_counter()))
            return response

        def logged_hold(rid, *args, **kwargs):
            transition["script"].append(("hold", rid))
            return real_hold(rid, *args, **kwargs)

        def probe(stage, rid):
            transition["script"].append(("probe",))
            for cid in names:
                router.submit(cid, arrival())

        released = []
        real_release = router.release_holds

        def logged_release():
            transition["script"].append(("release",))
            start = len(log)
            t = time.perf_counter()
            out = real_release()
            if cuda:
                torch.cuda.synchronize()
            transition["release_s"] = time.perf_counter() - t
            released.extend(log[start:])
            return out

        router.submit, router.release_holds, router.hold_replica = logged_submit, logged_release, logged_hold
        t0 = time.perf_counter()
        try:
            if plan is None:  # the never-attempted baseline: the apply's router-level work, no apply
                for op in script:
                    if op[0] == "hold":
                        router.hold_replica(op[1])
                    elif op[0] == "probe":
                        probe(None, None)
                    elif op[0] == "drain":
                        transition["script"].append(op)
                        flush(router.replica(op[1]))
                    else:
                        router.release_holds()
                report = {"status": "not attempted"}
            else:
                report = controller.apply(plan, rolling=True, traffic=probe if traffic else None)
            if cuda:
                torch.cuda.synchronize()
        finally:
            end = time.perf_counter()
            del router.submit, router.release_holds, router.hold_replica
        marks = transition["marks"] + [("end", end)]
        deferred = [(c, t, at) for c, t, status, at in log if status == "deferred"]
        return dict(report=report, seconds=end - t0, phases=[(label, b - a) for (label, a), (_, b)
                                                             in zip(marks, marks[1:])],
                    prepare=transition.get("prepare"), stack_build=dict(transition["stack_build"]),
                    **{k: transition.get(k) for k in ("prepare_s", "rollback_s", "commit_s", "release_s")},
                    script=list(transition["script"]),
                    before=before, after=state(), primed=primes[0] - primed, submits=len(log),
                    deferred=len(deferred),
                    released_in_order=[(c, t) for c, t, _, _ in released] == [(c, t) for c, t, _ in deferred],
                    released_statuses=sorted({status for _, _, status, _ in released}),
                    hold_s=[r[3] - d[2] for d, r in zip(deferred, released)])

    try:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        with TierSteps(claims) as tier_steps:
            for step_no in range(steps):
                current.clear()
                statuses = collections.Counter()
                f0 = dict(fsyncs)
                t0 = time.perf_counter()
                for cid in names:
                    # The step before the kill fills r1's queues: the load
                    # the replica dies under, kept by its post-step snapshot.
                    burst = kill_step is not None and step_no == kill_step - 1 and placement.owner(cid) == "r1"
                    for _ in range(FLEET_QUEUE_CAPACITY if burst else arrivals):
                        statuses[router.submit(cid, arrival())["status"]] += 1
                t1 = time.perf_counter()
                f1 = dict(fsyncs)
                if step_no == kill_step:
                    faultspace.fault_point(faultspace.REPLICA_KILL, payload={"replica": "r1", "step": step_no})
                    router.replica("r1").kill()
                    events["epoch_at_kill"] = placement.epoch
                router.step_all()
                if cuda:
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                if step_no == failover_step:
                    timer.clear()
                    per_claim.clear()
                    t_f = time.perf_counter()
                    report = router.fail_over("r1")
                    if cuda:
                        torch.cuda.synchronize()
                    events["failover"] = report
                    events["failover_s"] = time.perf_counter() - t_f
                    events["failover_parts"] = dict(timer)
                    events["failover_claims"] = {c: dict(per_claim[c]) for c in report["claims"]}
                    events["predictions_at_failover"] = {
                        c: sum(t["fn"] == "update_prediction"
                               for t in read_chain_log(os.path.join(chain_dir, f"chain-{c}.jsonl")))
                        for c in report["claims"]}
                if step_no == migrate_step:
                    cid = names[0]
                    owner = placement.owner(cid)
                    target = next(r for r in router.replica_ids() if r != owner)
                    t_m = time.perf_counter()
                    events["migration"] = router.migrate(cid, target, reason="operator")
                    if cuda:
                        torch.cuda.synchronize()
                    events["migration_ms"] = (time.perf_counter() - t_m) * 1e3
                    events["migration_parts"] = dict(per_claim[cid])
                if reconfig is not None and step_no in reconfig:
                    events.setdefault("reconfig", {})[step_no] = reconfigure(**reconfig[step_no])
                t3 = time.perf_counter()
                if step_no in read_steps:  # read outside the timed window
                    events.setdefault("claim_fingerprints", {})[step_no] = {
                        cid: router.claim_fingerprint(cid) for cid in names}
                    events.setdefault("snapshots", {})[step_no] = dict(router.snapshot(),
                                                                       epoch_chain=router.epoch_chain())
                if kill_step is not None and step_no == kill_step - 1:  # read outside the timed window
                    events["exposition_before_kill"] = plane.render_prometheus_fleet()
                    events["scrapes_before_kill"] = [router.replica(r).metrics.counters_snapshot()
                                                     for r in router.replica_ids()] + [
                        metrics.counters_snapshot(), plane.registry.counters_snapshot()]
                per_replica = {}
                for rid, r in sorted(current.items()):
                    fwd = r.pop("forward_events", [])
                    lat = r.pop("latencies", [])
                    per_replica[rid] = dict(r, forwards=len(fwd),
                                            forward_ms=sum(a.elapsed_time(b) for a, b in fwd) if cuda else 0.0,
                                            p50_ms=float(np.percentile(lat, 50)) * 1e3 if lat else None)
                    r["latencies"] = lat
                rows.append(dict(step=step_no, submit_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                                 events_ms=(t3 - t2) * 1e3, wall_ms=(t3 - t0) * 1e3,
                                 requests=sum(r["requests"] for r in current.values()),
                                 latencies=[x for r in current.values() for x in r["latencies"]],
                                 statuses=dict(statuses), fsyncs=fsyncs["n"] - f0.get("n", 0),
                                 fsync_ms=(fsyncs["s"] - f0.get("s", 0.0)) * 1e3,
                                 submit_fsyncs=f1.get("n", 0) - f0.get("n", 0),
                                 fsync_kinds={k: v - f0.get(k, 0) for k, v in fsyncs.items()
                                              if k not in ("n", "s") and v - f0.get(k, 0)},
                                 replicas=per_replica, epoch=placement.epoch))
            for rid in router.replica_ids():  # the graceful end: every admitted request answered
                if router.replica(rid).alive:
                    router.replica(rid).tier.drain()
            if cuda:
                torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        faultspace.disarm()
        prewarm_mod.prime_key = real_prime
        pipe.packed_forward = packed_forward
        os.fsync = real_fsync
        for name, fn in real_parts.items():
            setattr(recovery_mod, name, fn)
    chain = {cid: {"predictions": sum(t["fn"] == "update_prediction"
                                      for t in read_chain_log(os.path.join(chain_dir, f"chain-{cid}.jsonl"))),
                   "duplicates": len(duplicate_predictions(os.path.join(chain_dir, f"chain-{cid}.jsonl")))}
             for cid in names}
    predicted = tier_steps.predicted()
    predicted["gated_claims_consensus"] += primes[0]  # one B3 launch a group PREPARE primed
    warmth = {rid: {w: router.replica(rid).metrics.counter("consensus_dispatch", labels={"warmth": w}).count
                    for w in WARMTHS} for rid in router.replica_ids()}
    return dict(rows=rows, events=events, setup=setup, counts=counts, predicted=predicted, primed=primes[0],
                forwards=len(forward_ev), peak=peak, chain=chain,
                accounting=router.fleet_accounting(), placement=placement, router=router, plane=plane,
                journal=journal, metrics=metrics, trace_path=trace_path,
                obs_paths=obs_paths + [router.replica(r).obs_path for r in router.replica_ids()
                                       if router.replica(r).obs_path not in obs_paths],
                fired=fault_controller.counts(), names=names, n_layers=pipe.cfg.n_layers, warmth=warmth)


class WallClock:
    """A replica's clock on the host's monotonic time.  ``Replica.recover``
    sets ``now`` to a snapshot's virtual time, which a real clock ignores."""

    now = None

    def __call__(self) -> float:
        return time.monotonic()


def fleet_invariants(run: dict, what: str) -> None:
    """The invariants (c) and (d) hold their fleets to."""
    from svoc_torch.obsplane.hopchain import chain_stats, join_hop_chains
    from svoc_torch.obsplane.timeline import read_observations
    from svoc_torch.tools.fleet_obs_smoke import monotonic

    dups = {c: v["duplicates"] for c, v in run["chain"].items() if v["duplicates"]}
    check(not dups, f"{what}: zero duplicate txs across the {len(run['chain'])} shared chain logs ({dups})")
    acct = run["accounting"]
    check(acct["unaccounted"] == 0 and acct["admitted"] > 0,
          f"{what}: zero unaccounted admitted requests fleet-wide (admitted {acct['admitted']:g}, completed "
          f"{acct['completed']:g}, dropped {acct['dropped']:g})")
    journaled = run["journal"].recent(type="cluster.unavailable")
    reasons = {}
    for e in journaled:
        reasons[e.data.get("reason")] = reasons.get(e.data.get("reason"), 0) + 1
    counted = run["metrics"].family_total("cluster_unavailable")
    killed = "failover" in run["events"]
    check(len(journaled) == counted and set(reasons) <= ({"replica_down"} if killed else set()),
          f"{what}: every shed typed, counted ({counted:g}) and journaled ({len(journaled)}), "
          f"none a forward_error: {reasons}")
    records = [r for path in run["obs_paths"] for r in read_observations(path)]
    chains = join_hop_chains(records)
    stats = chain_stats(chains)
    forwarded = run["metrics"].family_total("cluster_forwarded")
    complete = sum(1 for c in chains.values() if c["reason"] == "forward" and c["classification"] == "complete")
    check(bool(chains) and sum(stats["by_classification"].values()) == stats["chains"]
          and "died_mid_hop" not in stats["by_classification"] and complete == forwarded,
          f"{what}: {stats['chains']} hop chains fully classified {stats['by_classification']}, "
          f"{complete} complete forwards == cluster_forwarded {forwarded:g}")
    history = {"fleet_obs": {"accounting_history": run["plane"].accounting_history()}}
    check(not monotonic(history)["regressions"], f"{what}: the fleet's accounting totals never step backward")


def fleet_launches(run: dict, what: str) -> None:
    """(c)'s and (d)'s kernel launches against what the run's forwards and
    dispatches predict."""
    counts, predicted = run["counts"], run["predicted"]
    check(counts["flash_attention"] == run["n_layers"] * run["forwards"] and run["forwards"] > 0
          and {k: counts[k] for k in predicted} == predicted and counts["fused_consensus"] == 0,
          f"{what}: launches {counts}: {run['n_layers']} flash a forward ({run['forwards']} forwards), B3 once a "
          f"dispatched group, threefry and the fleet draws once a claim served ({predicted}), no B2")


def failover_checks(run: dict, what: str) -> None:
    """What (c) holds its kill, failover and migration to: the recovered
    backlog answered or deferred by the failover's drains, every moved
    claim adopted with continuity and growing, r1 gone from placement,
    the migration's continuity, the kill fired once, and the merged
    exposition equal to the scrapes' sum before the kill."""
    from svoc_torch.tools.fleet_obs_smoke import exposition_totals

    ev, placement = run["events"], run["placement"]
    claims_t = ev["failover_claims"]
    requeued = ev["failover"]["recovery"]["requeued"]
    answered = sum(c["drain_completed"] for c in claims_t.values())
    deferred = sum(c["deferred"] for c in claims_t.values())
    dropped = sum(c["drain_dropped"] for c in claims_t.values())
    check(requeued > 0 and answered + deferred == requeued and dropped == 0,
          f"{what}: the failover recovered a backlog of {requeued} queued requests, and its drains answered "
          f"{answered} and deferred {deferred} of them ({dropped} dropped) in "
          f"{sum(c['flush_steps'] for c in claims_t.values())} flush steps")
    moved = ev["failover"]["claims"]
    growing = {c: (ev["predictions_at_failover"][c], run["chain"][c]["predictions"]) for c in moved}
    check(bool(moved) and all(m["status"] == "migrated" and m["continuity"] for m in moved.values())
          and all(after > before for before, after in growing.values()),
          f"{what}: {len(moved)} failed-over claims adopted with lineage continuity, each chain growing after "
          f"(predictions at the failover -> at the end, first 4: {dict(list(growing.items())[:4])})")
    owners = {c: placement.owner(c) for c in run["names"]}
    check("r1" not in owners.values() and placement.epoch > ev["epoch_at_kill"],
          f"{what}: no claim placed on r1 ({sorted(set(owners.values()))}); epoch {ev['epoch_at_kill']} at the "
          f"kill -> {placement.epoch}")
    check(ev["migration"]["status"] == "migrated" and ev["migration"]["continuity"],
          f"{what}: the operator migration of {ev['migration']['claim']} {ev['migration']['source']} -> "
          f"{ev['migration']['target']} kept continuity")
    check(run["fired"].get("replica.kill") == 1, f"{what}: replica.kill fired once ({run['fired']})")
    merged = exposition_totals(ev["exposition_before_kill"])
    scraped = {}
    for scrape in ev["scrapes_before_kill"]:
        for e in scrape:
            scraped[f"svoc_{e['name']}_total"] = scraped.get(f"svoc_{e['name']}_total", 0.0) + e["count"]
    off = {k for k in set(merged) | set(scraped) if abs(merged.get(k, 0.0) - scraped.get(k, 0.0)) > 1e-9}
    check(bool(merged) and not off,
          f"{what}: before the kill, the merged exposition's {len(merged)} counter families equal the sum of the "
          f"scrapes (differing: {sorted(off)})")


@phase("13c. a fleet at full width: 3 replicas x 64 claims, r1 killed and failed over, one migration")
def fleet_width_phase(torch, launches):
    import numpy as np

    card = nvidia_smi()
    pipe = width_pipeline(torch)
    scale = calibrate_head(torch, pipe)
    run = fleet_width_run(torch, pipe, FLEET_REPLICAS, FLEET_STEPS, kill_step=FLEET_KILL_STEP,
                          failover_step=FLEET_FAILOVER_STEP, migrate_step=FLEET_MIGRATE_STEP)
    for k in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + run["counts"][k]
    fleet_invariants(run, "13c")
    fleet_launches(run, "13c")
    failover_checks(run, "13c")
    ev = run["events"]
    rows = run["rows"]
    timed = rows[1:]  # the first step warms the stacks
    step_s, wall_s = (sum(r[k] for r in timed) / 1e3 for k in ("step_ms", "wall_ms"))
    requests = sum(r["requests"] for r in timed)

    def pct(rs):
        lat = [x for r in rs for x in r["latencies"]]
        return (f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p99 {np.percentile(lat, 99) * 1e3:.3f} ms "
                f"({len(lat)} requests)") if lat else "no requests"

    before = rows[1:FLEET_KILL_STEP]
    outage = rows[FLEET_KILL_STEP:FLEET_FAILOVER_STEP + 1]
    after = rows[FLEET_FAILOVER_STEP + 1:]
    by_reason = {}
    for e in run["journal"].recent(type="cluster.unavailable"):
        by_reason[e.data.get("reason")] = by_reason.get(e.data.get("reason"), 0) + 1
    serving_shed = {rid: run["router"].replica(rid).metrics.family_series("serving_shed")
                    for rid in run["router"].replica_ids()}
    print(f"  [{card}] vectorizer: {pipe.cfg.n_layers} layers, hidden {pipe.cfg.hidden}, flash bf16, head "
          f"calibrated (scale {scale:.3f}); setup {run['setup']}")
    for r in rows:
        split = "; ".join(
            f"{rid} {x['ms']:.1f} ms (forward {x['forward_ms']:.3f} in {x['forwards']}, fetch {x['fetch_ms']:.1f}, "
            f"fabric consensus {x['fabric_consensus_ms']:.2f}, commit {x['commit_ms']:.1f}; {x['served']:g} claims)"
            for rid, x in r["replicas"].items())
        print(f"  step {r['step']}: {r['wall_ms']:.3f} ms (submit {r['submit_ms']:.3f}, step_all {r['step_ms']:.3f}, "
              f"kill, failover and migration {r['events_ms']:.3f}), {r['requests']} requests, "
              f"{r['fsyncs']} fsyncs ({r['submit_fsyncs']} in the submits) {r['fsync_ms']:.1f} ms "
              f"{r['fsync_kinds']}, epoch {r['epoch']}, {r['statuses']}: {split}")
    print(f"  [{card}] {len(timed)} timed cluster steps: {requests} requests in {wall_s:.3f} s, "
          f"{requests / wall_s:.1f} requests/s over the whole window (submits, step_all, failover, migration); "
          f"step_all alone {step_s * 1e3 / len(timed):.3f} ms a step, {requests / step_s:.1f} requests/s; "
          f"fsyncs {sum(r['fsyncs'] for r in timed) / len(timed):.1f} a step ("
          f"{sum(r['submit_fsyncs'] for r in timed) / len(timed):.1f} of them in the submits) taking "
          f"{sum(r['fsync_ms'] for r in timed) / len(timed):.3f} ms; peak memory {run['peak'] / 2**20:.1f} MiB")
    snap = run["plane"].snapshot()
    print(f"  [{card}] the fleet plane: anomalies {[(a['source'], a['family'], a['step'], a['sustained']) for a in snap['recent_anomalies']]}, "
          f"bundles {len(snap['bundles'])}, profiler {snap.get('profiler')} (a capture runs from the plane step "
          f"of its sustained anomaly to the next, whose cluster step holds its trace's export)")
    print(f"  [{card}] request latency: before the kill (steps 1-{FLEET_KILL_STEP - 1}) {pct(before)}; outage "
          f"(steps {FLEET_KILL_STEP}-{FLEET_FAILOVER_STEP}) {pct(outage)}; after the failover "
          f"(steps {FLEET_FAILOVER_STEP + 1}-{FLEET_STEPS - 1}) {pct(after)}")
    print(f"  [{card}] the outage's sheds by reason: router {by_reason}; the tiers' serving_shed {serving_shed}")
    parts = ev["failover_parts"]
    claims_t = ev["failover_claims"]
    total = lambda k: sum(c.get(k, 0.0) for c in claims_t.values())  # noqa: E731
    print(f"  [{card}] fail_over {ev['failover_s']:.3f} s for {len(claims_t)} claims: the recovery stack's build "
          f"{parts.get('build', 0):.3f} s and its claims' chain-log replay {parts.get('add_claim', 0):.3f} s; "
          f"recover {parts.get('recover', 0):.3f} s (snapshot restore "
          f"{parts.get('load_snapshot', 0) + parts.get('restore_multi_session', 0):.3f}, roll-forward "
          f"{parts.get('roll_forward_journal', 0):.3f}, WAL reconcile {parts.get('reconcile_wal', 0):.3f}); "
          f"drains {total('drain_s'):.3f} s ({ev['failover']['recovery']['requeued']} requests recovered queued, "
          f"{total('drain_completed'):g} answered and {total('deferred'):g} deferred in {total('flush_steps'):g} "
          f"flush steps), ships {total('ship_s'):.3f} s, adopts {total('adopt_s'):.3f} s; "
          f"{sum(c.get('burned', 0) > 0 for c in claims_t.values())} claims shipped past "
          f"{total('burned'):g} landed cycles (one split burned each)")
    print("  failover per claim (s): " + json.dumps(claims_t))
    print(f"  [{card}] operator migration of {ev['migration']['claim']}: {ev['migration_ms']:.3f} ms "
          f"(s: {ev['migration_parts']})")
    return {"pipe": pipe}


@phase("13d. replicas on one card: 64 claims, 512 arrivals a step, 2 steps, on 1 and on 3 replicas")
def replicas_phase(torch, launches, fleet):
    card = nvidia_smi()
    pipe = fleet["pipe"] if fleet else None
    if pipe is None:
        pipe = width_pipeline(torch)
        calibrate_head(torch, pipe)
    figures = {}
    for n in (1, 3):
        run = fleet_width_run(torch, pipe, n, FLEET_BENCH_STEPS)
        for k in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
            launches[k] = launches.get(k, 0) + run["counts"][k]
        fleet_invariants(run, f"13d, {n} replica(s)")
        fleet_launches(run, f"13d, {n} replica(s)")
        timed = run["rows"][1:]
        step_s, wall_s = (sum(r[k] for r in timed) / 1e3 for k in ("step_ms", "wall_ms"))
        requests = sum(r["requests"] for r in timed)
        figures[n] = (wall_s * 1e3 / len(timed), requests / wall_s, step_s * 1e3 / len(timed), requests / step_s)
        print(f"  [{card}] {n} replica(s): {figures[n][1]:.1f} requests/s over the whole window (submits and "
              f"step_all), {figures[n][0]:.3f} ms a cluster step; step_all alone {figures[n][2]:.3f} ms, "
              f"{figures[n][3]:.1f} requests/s; over {len(timed)} timed steps; per step " + json.dumps(
                  [{"wall_ms": round(r["wall_ms"], 3), "submit_ms": round(r["submit_ms"], 3),
                    "step_ms": round(r["step_ms"], 3), "forwards": sum(x["forwards"] for x in r["replicas"].values()),
                    "fsyncs": r["fsyncs"]} for r in run["rows"]]))
    print(f"  [{card}] 3 replicas against 1, over the whole window: requests/s x{figures[3][1] / figures[1][1]:.3f}, "
          f"cluster step x{figures[3][0] / figures[1][0]:.3f}; step_all alone: requests/s "
          f"x{figures[3][3] / figures[1][3]:.3f} (read, not demanded)")


def shed_free_probes(probes) -> bool:
    """Every probe of a committed smoke run deferred when its owner was
    held (rolling: the replicas transitioned so far), admitted otherwise."""
    held = set()
    for p in probes:
        if p["replica"] is not None:
            held.add(p["replica"])
        status, owner = p["response"].get("status"), p["response"].get("replica")
        if status != ("deferred" if owner in held else "admitted"):
            return False
    return True


@phase("14a. the reconfig smoke on the card: a committed re-pin twice, an abort at every point, against the reference")
def reconfig_smoke_phase(torch, launches):
    import tempfile

    from svoc_torch.compile import prewarm as prewarm_mod
    from svoc_torch.tools import reconfig_smoke

    base = tempfile.mkdtemp(prefix="reconfig-smoke-")
    wrappers = counted_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    primes, real_prime = [0], prewarm_mod.prime_key

    def counted_prime(key, dev):
        primes[0] += 1
        return real_prime(key, dev)

    prewarm_mod.prime_key = counted_prime
    t0 = time.perf_counter()
    try:
        with TierSteps(reconfig_smoke.N_CLAIMS) as steps:
            artifact = reconfig_smoke.run(0, None, base)  # device None: CUDA
        torch.cuda.synchronize()
    finally:
        prewarm_mod.prime_key = real_prime
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    for c in artifact["checks"]:
        check(c["ok"], f"reconfig smoke: {c['check']}" + (f" ({c['detail']})" if c["detail"] else ""))
    check(artifact["reference_mismatches"] == {},
          f"the committed run's fleet and per-claim fingerprints and epoch chain, and the five abort baselines, "
          f"equal the JAX package's: fleet {artifact['fleet_fingerprint'][:16]}, mismatches "
          f"{artifact['reference_mismatches']}")
    committed = artifact["runs"][:2]
    check(all(shed_free_probes(r["probes"]) and r["cluster_counters"]["cluster_unavailable"] == 0 for r in committed),
          "zero shed in both committed runs: every probe to a held replica deferred, every other admitted, "
          f"cluster_unavailable 0 ({[[p['response']['status'] for p in r['probes']] for r in committed]})")
    runs = artifact["runs"]
    check(all(r["duplicate_txs"] == 0 and r["requests"]["unaccounted"] == 0 for r in runs),
          f"zero duplicate txs and zero unaccounted requests in all {len(runs)} runs")
    fired = set()
    for r in runs:
        fired |= set(r["fired_log"]["fired"])
    check(set(reconfig_smoke.RECONFIG_POINTS) <= fired, f"all five reconfig points fired ({sorted(fired)})")
    predicted = steps.predicted()
    predicted["gated_claims_consensus"] += primes[0]
    check(counts["gated_claims_consensus"] > 0 and counts["threefry"] > 0
          and {k: counts[k] for k in predicted} == predicted and counts["flash_attention"] == 0
          and counts["fused_consensus"] == 0,
          f"launches {counts} == predicted {predicted} ({steps.steps} tier steps served {steps.served} claims in "
          f"{steps.groups} groups, {primes[0]} groups primed in PREPARE; no encoder, no B2)")
    for k in ("gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + counts[k]
    print(f"  [{nvidia_smi()}] {len(runs)} runs {seconds:.3f} s: committed "
          f"{[round(x, 3) for x in artifact['seconds']['committed']]} s, abort pairs (baseline, aborted) "
          f"{ {p: [round(x, 3) for x in v] for p, v in artifact['seconds']['aborts'].items()} } s; "
          f"prewarm {artifact['reconfig']['prewarm']}; deferred released {artifact['reconfig']['deferred_released']}")


#: Jobs of phase 14b's pass, its children forked from the fork server (its
#: corpus replays spawn beside it): ``chaos_fuzz --seeds 8`` forked took least
#: wall time at 3 jobs of 3, 4 and 6 on the card's 8-core host (``PERF.md`` §6).
FUZZ_JOBS = 3


@phase("14b. the fault-space fuzzer on the card: 32 seeds forked, each rerun, the felt soak; the corpus spawned")
def chaos_fuzz_phase(torch):
    import concurrent.futures
    import os
    import statistics
    import tempfile

    from svoc_torch.durability import fuzz
    from svoc_torch.tools import chaos_fuzz

    base = tempfile.mkdtemp(prefix="chaos-fuzz-")
    out = os.path.join(base, "CHAOS_FUZZ.json")
    seeds = chaos_fuzz.DEFAULT_SEEDS
    corpus = [e for e in fuzz.load_corpus(str(Path(__file__).resolve().parent / "tests" / "fixtures" / "chaos_corpus"))
              if e.get("tier1", True)]

    def replay(entry):
        t = time.perf_counter()
        checked = fuzz.run_and_check(fuzz.FuzzPlan.from_dict(entry["plan"]), os.path.join(base, "corpus", entry["name"]),
                                     launcher=fuzz.spawn_child)
        return checked, time.perf_counter() - t

    # The corpus replays spawn a fresh interpreter a child (the old start,
    # measured beside the cut) while the pass forks its children from the
    # fork server; every child is its own process either way.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(corpus)) as pool:
        futures = {e["name"]: pool.submit(replay, e) for e in corpus}
        chaos_fuzz.main(["--seeds", str(seeds), "--jobs", str(FUZZ_JOBS),
                         "--base-dir", os.path.join(base, "fuzz"), "--out", out])
        fuzz_s = time.perf_counter() - t0
        replays = {name: f.result() for name, f in futures.items()}
    corpus_s = max(s for _, s in replays.values())
    replays = {name: checked for name, (checked, _) in replays.items()}
    with open(out) as f:
        artifact = json.load(f)
    for name, passed in artifact["checks"].items():
        check(passed, f"chaos fuzz, {seeds} seeds on CUDA, each rerun: {name}"
              + ("" if passed else f" (violations {artifact['violations']}, never fired "
                                   f"{artifact['coverage_never_fired']}, mismatches {artifact['reference_mismatches']})"))
    devices = {r["device"] for r in artifact["runs"]}
    forked = {r["child_seconds"]["forked"] for r in artifact["runs"]}
    check(devices == {"cuda"} and forked == {True} and len(artifact["runs"]) == seeds,
          f"every seed's surviving child ran on {devices}, forked {forked}, {len(artifact['runs'])} seeds")
    for name, checked in replays.items():
        result = checked["run"]["result"] or {}
        ref = chaos_fuzz.REFERENCE_FINGERPRINTS["corpus"][name]
        check(checked["violations"] == [] and checked["replay_identical"] is True
              and result.get("fingerprint") == ref and result.get("device") == "cuda",
              f"corpus entry {name} replays green on {result.get('device')}, rerun identical, fingerprint "
              f"{str(result.get('fingerprint'))[:16]} == the JAX package's {ref[:16]} ({checked['violations']})")
    forks = [r["child_seconds"] for r in artifact["runs"]]
    spawns = [c["run"]["result"]["child_seconds"] for c in replays.values() if c["run"]["result"]]
    children = sum(len(r["phases"]) for r in artifact["runs"])

    def med(rows, key):
        return statistics.median(c[key] for c in rows) if rows else float("nan")

    card = nvidia_smi()
    print(f"  [{card}] {seeds} seeds, each run twice, --jobs {FUZZ_JOBS} forked, and the felt soak: {fuzz_s:.3f} s, "
          f"{children} children in the first runs, {sum(len(s['actions']) for s in artifact['runs'])} fault actions; "
          f"beside it the corpus ({len(corpus)} entries, twice each, spawned) {corpus_s:.3f} s")
    print(f"  [{card}] a surviving child's start, median (s): spawned ({len(spawns)}): interpreter "
          f"{med(spawns, 'interpreter_s'):.3f}, torch's import {med(spawns, 'torch_import_s'):.3f}, the port's imports "
          f"{med(spawns, 'port_import_s'):.3f}, CUDA's initialisation {med(spawns, 'cuda_init_s'):.3f}, workload "
          f"{med(spawns, 'workload_s'):.3f}; forked ({len(forks)}): the fork {med(forks, 'start_s'):.3f}, CUDA's "
          f"initialisation {med(forks, 'cuda_init_s'):.3f}, workload {med(forks, 'workload_s'):.3f}")
    return artifact


#: Phase 14c: its steps (cut from 10 to bring the script under 900 s: step 8 is the one after the commit's
#: two), the quiet abort's, the abort under traffic's and the commit's.
RECONFIG_STEPS, RECONFIG_QUIET_ABORT_STEP, RECONFIG_ABORT_STEP, RECONFIG_COMMIT_STEP = 9, 3, 4, 6


def reconfig_width_run(torch, pipe, *, device=None, claims: int = SERVING_CLAIMS,
                       arrivals: int = SERVING_ARRIVALS, base_dir=None,
                       step_period_s: float = FLEET_STEP_PERIOD_S) -> dict:
    """13c's fleet with no kill: at ``RECONFIG_QUIET_ABORT_STEP`` the
    smoke's plan (batched commits, the first claim re-specced to 9
    oracles) aborted by an ``error`` at ``reconfig.pre_resume`` (every
    replica has built its new stack by then) with no traffic; at
    ``RECONFIG_ABORT_STEP`` the same abort with one arrival a claim at
    every stage boundary; at ``RECONFIG_COMMIT_STEP`` the same plan
    committed, rolling, with the arrivals.  Then the never-attempted
    baseline: a second fleet through step ``RECONFIG_ABORT_STEP + 1``
    that attempts nothing at the quiet abort's step and does the abort
    under traffic's router-level work (its holds, the same arrivals, the
    flushes its drains did, the release) with no apply.  The per-claim
    fingerprints and the router's snapshot are read after the two aborts'
    steps and the next in both fleets; the baseline's are
    ``run["baseline"]``."""
    from svoc_torch.cluster import ReconfigPlan
    from svoc_torch.durability.faultspace import FaultEvent
    from svoc_torch.fabric import ClaimSpec
    from svoc_torch.fabric.scenario import _claim_names

    plan = ReconfigPlan(commit_mode="batched",
                        claims={_claim_names(claims)[0]: ClaimSpec(claim_id=_claim_names(claims)[0], n_oracles=9,
                                                                   dimension=6)})
    faults = [FaultEvent(point="reconfig.pre_resume", nth=n, action="error") for n in (1, 2)]
    read_at = (RECONFIG_QUIET_ABORT_STEP, RECONFIG_ABORT_STEP, RECONFIG_ABORT_STEP + 1)
    run = fleet_width_run(torch, pipe, FLEET_REPLICAS, RECONFIG_STEPS, device=device, claims=claims,
                          arrivals=arrivals, base_dir=base_dir, step_period_s=step_period_s,
                          reconfig={RECONFIG_QUIET_ABORT_STEP: dict(plan=plan, traffic=False),
                                    RECONFIG_ABORT_STEP: dict(plan=plan, traffic=True),
                                    RECONFIG_COMMIT_STEP: dict(plan=plan, traffic=True)},
                          faults=faults, read_steps=read_at)
    script = run["events"]["reconfig"][RECONFIG_ABORT_STEP]["script"]
    baseline = fleet_width_run(torch, pipe, FLEET_REPLICAS, RECONFIG_ABORT_STEP + 2, device=device, claims=claims,
                               arrivals=arrivals, base_dir=base_dir, step_period_s=step_period_s,
                               reconfig={RECONFIG_ABORT_STEP: dict(plan=None, traffic=True, script=script)},
                               faults=faults, read_steps=read_at)
    run["baseline"] = dict(claim_fingerprints=baseline["events"]["claim_fingerprints"],
                           snapshots=baseline["events"]["snapshots"],
                           reconfig=baseline["events"]["reconfig"][RECONFIG_ABORT_STEP],
                           counts=baseline["counts"], rows=baseline["rows"])
    return run


def reconfig_checks(run: dict, what: str, cuda: bool = True) -> None:
    """What 14c holds its two aborts and its commit to."""
    ev = run["events"]["reconfig"]
    abort, quiet, commit = ev[RECONFIG_ABORT_STEP], ev[RECONFIG_QUIET_ABORT_STEP], ev[RECONFIG_COMMIT_STEP]
    for label, ab in (("with no traffic", quiet), ("under traffic", abort)):
        rep = ab["report"]
        check(rep["status"] == "aborted" and rep["phase"] == "resume" and rep["cause"] == "InjectedFault"
              and sorted(ab["stack_build"]) == sorted(run["router"].replica_ids()),
              f"{what}: the abort {label} at reconfig.pre_resume rolled back after every replica built its new "
              f"stack ({rep}, stacks built {sorted(ab['stack_build'])})")
    before, after = quiet["before"], quiet["after"]
    check(after["fleet"] == before["fleet"] and after["epoch"] == 0 and not after["epoch_files"]
          and after["journal"] == before["journal"] and after["replicas"] == before["replicas"],
          f"{what}: the abort with no traffic left the fleet fingerprint ({after['fleet'][:16]}), the epoch "
          f"({after['epoch']}), the cluster and replica journals ({after['journal']} events) as before, and no "
          f"epoch file ({after['epoch_files']})")
    check(after["accounting"] == before["accounting"] and after["accounting"]["dropped"] == 0,
          f"{what}: the abort with no traffic left the accounting as before ({after['accounting']})")
    before, after = abort["before"], abort["after"]
    check(after["epoch"] == 0 and not after["epoch_files"],
          f"{what}: the abort under traffic left the epoch at {after['epoch']} and no epoch file "
          f"({after['epoch_files']})")
    check(after["accounting"]["dropped"] == before["accounting"]["dropped"] == 0,
          f"{what}: the abort under traffic dropped no request ({after['accounting']})")
    check(abort["deferred"] > 0 and abort["released_in_order"]
          and set(abort["released_statuses"]) <= {"admitted", "cached"},
          f"{what}: under traffic the abort deferred {abort['deferred']} requests and its rollback released them "
          f"into the old stacks in arrival order, each admitted or answered from the cache "
          f"({abort['released_statuses']}, release {abort['release_s'] or 0:.4f} s)")
    base = run["baseline"]
    mine, theirs = run["events"]["claim_fingerprints"], base["claim_fingerprints"]
    differ = {step: sorted(c for c in mine[step] if mine[step][c] != theirs[step].get(c)) for step in sorted(mine)}
    check(base["reconfig"]["report"]["status"] == "not attempted" and sorted(mine) == sorted(theirs)
          and not any(differ.values()),
          f"{what}: every per-claim fingerprint after the two aborts' steps and after the next equals the "
          f"never-attempted baseline's (the same holds, arrivals, flushes and release, no apply; "
          f"{len(run['names'])} claims, differing {differ})")
    mine, theirs = run["events"]["snapshots"], base["snapshots"]
    differ = {step: sorted(k for k in mine[step] if mine[step][k] != theirs[step].get(k)) for step in sorted(mine)}
    check(sorted(mine) == sorted(theirs) and not any(differ.values()),
          f"{what}: after the two aborts' steps and after the next the placement, the claims' owners, every replica's "
          f"snapshot and breaker, and the epoch chain equal the never-attempted baseline's (differing {differ})")
    rep = commit["report"]
    claims = [c for r in rep.get("replicas", {}).values() for c in r["claims"].values()]
    respecced = run["names"][0]
    check(rep["status"] == "committed" and rep["epoch"] == 1 and run["router"].reconfig_epoch == 1
          and len(rep["replicas"]) == FLEET_REPLICAS and len(claims) == len(run["names"])
          and all(c["continuity"] for c in claims)
          and any(r["claims"].get(respecced, {}).get("carried") for r in rep["replicas"].values()),
          f"{what}: the commit re-pinned {len(rep.get('replicas', {}))} replicas under epoch {rep.get('epoch')}, "
          f"{len(claims)} claims with continuity, {respecced} carried at 9 oracles")
    check(commit["deferred"] > 0 and rep["deferred_released"] == commit["deferred"] and commit["released_in_order"]
          and set(commit["released_statuses"]) <= {"admitted", "cached"},
          f"{what}: {commit['deferred']} requests deferred during the transition, all released at the commit in "
          f"arrival order, each admitted or answered from the cache ({commit['released_statuses']})")
    check(run["metrics"].family_total("cluster_unavailable") == 0,
          f"{what}: zero shed ({run['metrics'].family_total('cluster_unavailable'):g} cluster.unavailable)")
    epochs = {r: run["router"].replica(r).fingerprint_epoch for r in run["router"].replica_ids()}
    check(set(epochs.values()) == {1}, f"{what}: every replica serves epoch 1 ({epochs})")
    if cuda:
        warmth = run["warmth"]
        check(all(w["cold"] == 0 and w["prewarmed"] > 0 for w in warmth.values())
              and all(e["prepare"]["primed"] == 1 for e in (abort, quiet, commit)),
              f"{what}: every re-pinned stack's first dispatches count prewarmed, none cold ({warmth}); PREPARE "
              f"primed the new group once an apply")


@phase("14c. a live re-pin at full width: 3 replicas x 64 claims, an abort with no traffic at step 3, one under "
       "traffic at 4, a commit at 6")
def reconfig_width_phase(torch, launches, fleet):
    import numpy as np

    card = nvidia_smi()
    pipe = fleet["pipe"] if fleet else None
    if pipe is None:
        pipe = width_pipeline(torch)
        calibrate_head(torch, pipe)
    run = reconfig_width_run(torch, pipe)
    for k in ("flash_attention", "gated_claims_consensus", "threefry", "fleet_draws"):
        launches[k] = launches.get(k, 0) + run["counts"][k]
    fleet_invariants(run, "14c")
    fleet_launches(run, "14c")
    reconfig_checks(run, "14c")
    rows = run["rows"]
    timed = rows[1:]
    step_s, wall_s = (sum(r[k] for r in timed) / 1e3 for k in ("step_ms", "wall_ms"))
    requests = sum(r["requests"] for r in timed)

    def pct(rs):
        lat = [x for r in rs for x in r["latencies"]]
        return (f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p99 {np.percentile(lat, 99) * 1e3:.3f} ms "
                f"({len(lat)} requests)") if lat else "no requests"

    for r in rows:
        print(f"  step {r['step']}: {r['wall_ms']:.3f} ms (submit {r['submit_ms']:.3f}, step_all {r['step_ms']:.3f}, "
              f"transition {r['events_ms']:.3f}), {r['requests']} requests, {r['statuses']}")
    for step, ev in sorted(run["events"]["reconfig"].items()):
        hold = ev["hold_s"]
        print(f"  [{card}] apply at step {step}: {ev['report']['status']} in {ev['seconds']:.3f} s; phases (s) "
              + json.dumps([(label, round(s, 4)) for label, s in ev["phases"]])
              + f"; prepare {ev['prepare_s']:.3f} s {ev['prepare']}; stack builds (s) "
              + json.dumps({k: round(v, 4) for k, v in ev["stack_build"].items()})
              + f"; commit {ev['commit_s'] or 0:.3f} s; rollback {ev['rollback_s'] or 0:.3f} s; "
              f"{ev['deferred']} deferred, held "
              + (f"{min(hold):.3f}-{max(hold):.3f} s (median {float(np.median(hold)):.3f})" if hold else "-"))
    print(f"  [{card}] {len(timed)} timed cluster steps: {requests} requests in {wall_s:.3f} s, "
          f"{requests / wall_s:.1f} requests/s over the whole window (submits, step_all, the three applies); "
          f"step_all alone {step_s * 1e3 / len(timed):.3f} ms a step, {requests / step_s:.1f} requests/s; "
          f"peak memory {run['peak'] / 2**20:.1f} MiB")
    print(f"  [{card}] request latency: before the commit (steps 1-{RECONFIG_COMMIT_STEP - 1}, the aborts at "
          f"{RECONFIG_QUIET_ABORT_STEP} and {RECONFIG_ABORT_STEP}) {pct(rows[1:RECONFIG_COMMIT_STEP])}; "
          f"during (steps {RECONFIG_COMMIT_STEP}-"
          f"{RECONFIG_COMMIT_STEP + 1}) {pct(rows[RECONFIG_COMMIT_STEP:RECONFIG_COMMIT_STEP + 2])}; after "
          f"(steps {RECONFIG_COMMIT_STEP + 2}-{RECONFIG_STEPS - 1}) {pct(rows[RECONFIG_COMMIT_STEP + 2:])}")
    print(f"  [{card}] launches {run['counts']} (predicted {run['predicted']}, {run['forwards']} forwards of "
          f"{run['n_layers']} flash launches); dispatch warmth by replica {run['warmth']}")


def zero_counts(wrappers=None):
    """Every counted wrapper's count (``counted_wrappers()`` by default) set
    to 0 (after a sync); returns them."""
    import torch

    wrappers = wrappers or counted_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_counts(wrappers) -> dict:
    import torch

    torch.cuda.synchronize()
    return {k: w.launches for k, w in wrappers.items()}


def add_launches(launches: dict, counts: dict) -> None:
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n


@phase("15a. the flight-recorder and cost-plane gates on the card: obs_smoke and obs_cost_smoke twins")
def obs_gates_phase(torch, launches):
    from svoc_torch.tools import obs_cost_smoke, obs_smoke

    card = nvidia_smi()
    wrappers = zero_counts()
    t0 = time.perf_counter()
    obs = obs_smoke.run(0, None)  # device None: CUDA
    obs_s = time.perf_counter() - t0
    counts = read_counts(wrappers)
    for name, passed in obs["checks"].items():
        check(passed, f"obs smoke on {obs['device']}: {name}")
    check(obs["journal_fingerprint"] == obs_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0],
          f"obs smoke: the journal fingerprint {obs['journal_fingerprint'][:16]} equals the JAX package's "
          f"{obs_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0][:16]} at seed 0")
    check(obs["session"]["device"].startswith("cuda") and counts["fleet_draws"] > 0,
          f"obs smoke: the session leg drew its fleet on {obs['session']['device']} ({counts})")
    add_launches(launches, counts)
    over = obs["overhead"]
    print(f"  [{card}] obs smoke {obs_s:.3f} s, launches {counts}; overhead: journal emit {over['emit_us_mean']} us, "
          f"span {over['span_us_mean']} us, span with lineage {over['span_lineage_us_mean']} us (means of 5000)")

    wrappers = zero_counts()
    t0 = time.perf_counter()
    cost = obs_cost_smoke.run(0, None)
    cost_s = time.perf_counter() - t0
    counts = read_counts(wrappers)
    for name, passed in cost["checks"].items():
        check(passed, f"obs cost smoke on {cost['device']}: {name}")
    check(cost["journal_fingerprint"] == obs_cost_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0],
          f"obs cost smoke: all four journal fingerprints {cost['journal_fingerprint'][:16]} equal the JAX "
          f"package's {obs_cost_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0][:16]} at seed 0")
    check(counts["gated_claims_consensus"] > 0 and counts["fleet_draws"] > 0
          and counts["threefry"] == counts["fleet_draws"] and counts["flash_attention"] == 0,
          f"obs cost smoke: every dispatch a B3 launch, every fetch a threefry split and one fleet-draws launch "
          f"({counts})")
    add_launches(launches, counts)
    print(f"  [{card}] obs cost smoke (4 serving scenarios and the JSONL rebuild in its own interpreter) "
          f"{cost_s:.3f} s, launches {counts}; {cost['timelines_checked']} timelines, {cost['ledger']['samples']} "
          f"ledger samples over {cost['ledger']['keys']} keys, {cost['coverage']['estimated']}/"
          f"{cost['coverage']['universe']['keys']} universe keys priced")


@phase("15b. the breakdown certificate on the card: robustness_cert in full mode")
def robustness_cert_phase(torch, launches):
    from svoc_torch.tools import robustness_cert

    card = nvidia_smi()
    wrappers = zero_counts()
    t0 = time.perf_counter()
    art = robustness_cert.run(0, smoke=False, device=None)
    seconds = time.perf_counter() - t0
    counts = read_counts(wrappers)
    for name, passed in art["checks"].items():
        check(passed, f"robustness cert (full) on {art['device']}: {name}")
    check(art["reference_mismatches"] == {} and art["certificate_summary"] == robustness_cert.REFERENCE["full"],
          f"robustness cert: the Byzantine fingerprint and each certificate's certified and tolerated colluders "
          f"equal the JAX package's ({art['certificate_summary']}, mismatches {art['reference_mismatches']})")
    cells = sum(len(sw["cells"]) + len(sw["benign_deviation"]) for sw in art["sweeps"].values())
    check(counts["gated_claims_consensus"] == cells + len(art["sweeps"]),
          f"robustness cert: one B3 launch a cell and one for each sweep's reference consensus "
          f"({counts['gated_claims_consensus']} == {cells} + {len(art['sweeps'])}), the plain loop never on the card")
    add_launches(launches, counts)
    print(f"  [{card}] robustness cert (8 oracles, 64 trials, 0-4 colluders at 3 magnitudes a config) "
          f"{seconds:.3f} s; launches {counts}")


#: Phase 15c's constrained sweep at the flagship's fleet (bench.py:682).
SWEEP_ORACLES, SWEEP_FAILING = 1024, 128
SWEEP_COUNTS, SWEEP_MAGNITUDES, SWEEP_TRIALS = (0, 64, 128, 256, 512), (0.2, 0.45, 0.9), 64
MULTIMODAL_POLES, MULTIMODAL_SIGMA = [[0.2, 0.2], [0.8, 0.7]], 0.03  # tests/test_multimodal.py:19, :123


def device_busy_ms(torch, fn):
    """``fn()``'s result and the device time of everything it ran, by
    ``torch.profiler`` (None when the profiler shows none: informational)."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        busy = sum(device_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
        return out, (busy or None)
    except Exception:  # the profiler is an observation, not a check
        traceback.print_exc()
        return None, None


@phase("15c. the estimator sweeps at full width on the card: the breakdown curve, an 80-cell sweep, multimodal")
def sweeps_phase(torch, launches):
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda, fused_consensus_gated_claims_plain
    from svoc_torch.robustness.certify import breakdown_sweep
    from svoc_torch.sim import montecarlo, multimodal, prng
    from svoc_torch.sim.generators import generate_beta_oracles

    card = nvidia_smi()
    cfg = ConsensusConfig(n_failing=SWEEP_FAILING, constrained=True)
    runs = {
        "fleet_breakdown_curve": lambda dev: montecarlo.fleet_breakdown_curve(prng.PRNGKey(0, dev),
                                                                               print_fn=lambda _: None),
        "breakdown_sweep": lambda dev: breakdown_sweep(prng.PRNGKey(1, dev), cfg, n_oracles=SWEEP_ORACLES,
                                                       colluder_counts=SWEEP_COUNTS, magnitudes=SWEEP_MAGNITUDES,
                                                       n_trials=SWEEP_TRIALS),
        "benchmark_multimodal": lambda dev: multimodal.benchmark_multimodal(prng.PRNGKey(2, dev), MULTIMODAL_POLES,
                                                                             MULTIMODAL_SIGMA, weights=[0.5, 0.5]),
    }
    out, times, counts = {}, {}, {}
    for name, fn in runs.items():
        wrappers = zero_counts()
        t0 = time.perf_counter()
        out[name] = fn("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = read_counts(wrappers)
        add_launches(launches, counts[name])
        _, busy = device_busy_ms(torch, lambda: fn("cuda"))  # a second, profiled run: device time only
        t0 = time.perf_counter()
        cpu = fn("cpu")
        times[name] = dict(wall_s=wall, device_ms=busy, cpu_s=time.perf_counter() - t0)
        out[name + " (cpu)"] = cpu

    curve = out["fleet_breakdown_curve"]
    fractions = sorted(curve)
    below = [f for f in fractions if f <= 0.45]
    above = [f for f in fractions if f > 0.5]
    check(all(curve[f]["misclassified_rate_pct"] <= 0.5 and curve[f]["reliability_pct"] >= 99.0 for f in below)
          and curve[0.49]["misclassified_rate_pct"] < 50.0
          and all(curve[f]["misclassified_rate_pct"] >= 60.0 and curve[f]["reliability_pct"] <= 0.0 for f in above),
          "the breakdown cliff at N/2 on 1024 oracles: detection holds below N/2 (misflags <= 0.5 %, reliability "
          ">= 99 % to 45 %; 49 % not inverted) and inverts above it (misflags >= 60 %, reliability <= 0): "
          + json.dumps({f: [round(curve[f]["misclassified_rate_pct"], 3), round(curve[f]["reliability_pct"], 3)]
                        for f in fractions}))
    cpu_curve = out["fleet_breakdown_curve (cpu)"]
    check(all(abs(curve[f]["misclassified_rate_pct"] - cpu_curve[f]["misclassified_rate_pct"]) <= 0.1
              for f in fractions),
          "the curve on the card (B3) and on the host (consensus_step a trial) flag within 0.1 % of each other: "
          + json.dumps({f: round(cpu_curve[f]["misclassified_rate_pct"], 3) for f in fractions}))
    check(counts["fleet_breakdown_curve"]["gated_claims_consensus"] == len(fractions),
          f"the curve: one [100, 1024, 6] B3 launch a fraction ({counts['fleet_breakdown_curve']})")
    sweep = out["breakdown_sweep"]
    n_cells = len(sweep["cells"]) + len(sweep["benign_deviation"])
    check(n_cells == 80 and counts["breakdown_sweep"]["gated_claims_consensus"] == n_cells + 1,
          f"the sweep: {n_cells} cells of [64, 1024, 6], one B3 launch each and one for the reference consensus "
          f"({counts['breakdown_sweep']})")
    dev = max(abs(a.mean_deviation - b.mean_deviation) for a, b in zip(sweep["cells"],
                                                                         out["breakdown_sweep (cpu)"]["cells"]))
    check(dev <= 1e-4, f"the sweep's mean deviations on the card and on the host agree within 1e-4 ({dev:.3g})")
    mm = out["benchmark_multimodal"]
    check(mm["mixture_nearest_pole_error"] < 0.02 and mm["unimodal_nearest_pole_error"]
          > 3.0 * mm["mixture_nearest_pole_error"] and mm["pole_recovery_error"] < 0.05
          and counts["benchmark_multimodal"]["gated_claims_consensus"] == 1,
          f"multimodal at 64 oracles, 300 trials: the mixture stays on a pole, the unimodal estimator between them "
          f"(tests/test_multimodal.py's bars), its 300 unimodal fleets one B3 launch: {mm}, "
          f"{counts['benchmark_multimodal']}")

    # B3 against its plain version on one of the sweep's cubes: the honest fleets.
    keys = prng.split(prng.split(prng.PRNGKey(1, "cuda"), 4)[0], SWEEP_TRIALS)
    honest = generate_beta_oracles(keys, SWEEP_ORACLES, 0, 20.0, 20.0, dim=6)[0].contiguous()
    ok = torch.ones(honest.shape[:2], dtype=torch.bool, device="cuda")
    mask = ok[:, 0].contiguous()
    got = fused_consensus_gated_claims_cuda(honest, ok, mask, cfg)
    want = fused_consensus_gated_claims_plain(honest, ok, mask, cfg)
    good, errs, _ = gated_errors(torch, got, want)
    check(good, f"B3 equals its plain version on the sweep's [64, 1024, 6] honest cube at the consensus bars {errs}")
    cube_times = {}
    curve_cube = generate_beta_oracles(prng.split(prng.PRNGKey(0, "cuda"), 100), SWEEP_ORACLES, 0, 20.0, 20.0,
                                       dim=6)[0].contiguous()  # a curve trial's shape, [100, 1024, 6]
    for cube in (honest, curve_cube):
        okc = torch.ones(cube.shape[:2], dtype=torch.bool, device="cuda")
        maskc = okc[:, 0].contiguous()
        c, n, m = cube.shape
        out = fused_consensus_gated_claims_cuda(cube, okc, maskc, cfg)
        bytes_moved = sum(t.numel() * t.element_size() for t in (cube, okc, maskc, *out))
        ranks, ops = c * (2 * m + 1) * n * math.ceil(math.log2(n)), c * 12 * n * m  # as phase 3b counts them
        cube_times[c] = dict(
            ms=cuda_ms(torch, lambda: fused_consensus_gated_claims_cuda(cube, okc, maskc, cfg), iters=20),
            plain_ms=cuda_ms(torch, lambda: fused_consensus_gated_claims_plain(cube, okc, maskc, cfg), iters=5),
            bound=bound(bytes_moved, ops, FP32_FLOPS, ranks))
    for name, t in times.items():
        print(f"  [{card}] {name}: {t['wall_s']:.3f} s wall on the card, device time "
              f"{t['device_ms'] if t['device_ms'] is None else round(t['device_ms'], 3)} ms (profiler, a second "
              f"run), its plain version on the host's CPU {t['cpu_s']:.3f} s; launches {counts[name]}")
    for c, t in cube_times.items():
        print(f"  [{card}] B3 at [{c}, 1024, 6] (a sweep's Beta cube): {t['ms']:.4f} ms (CUDA events, 20 launches), "
              f"its plain version {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms ({t['bound'][1]})")
    print("  the curve: " + json.dumps({f: {k: round(v, 3) for k, v in curve[f].items()} for f in fractions}))
    print(f"  multimodal: {json.dumps({k: round(v, 4) for k, v in mm.items()})}")


#: Phase 16a's command script: every command family of the console.
CONSOLE_SCRIPT = (
    "resume", "fetch", "consensus", "reliability", "commit", "resume", "reliability",
    "get_oracle_value_list", "claims", "serving submit alpha the rollout went great, everyone is thrilled",
    "serving step", "serving", "durability", "costs", "profile", "slo", "multimodal", "multimodal auto",
    "events 5", "audit", "metrics prom", "live_mode on", "live_mode off",
)
#: Phase 16b's script on the CLI's standard input (after its startup
#: resume and fetch).
CLI_SCRIPT = ("dimension", "commit", "resume", "reliability", "multimodal", "metrics trace", "exit")


def cli_child(torch, card):
    """16b: ``python -m svoc_torch.apps.cli --int8`` in a child with
    ``CLI_SCRIPT`` on its standard input; its start split from the
    arrival times of its ``-X importtime`` lines (torch, the port) and
    of its output (the startup resume, the startup fetch), and the
    startup fetch from the spans its ``metrics trace`` prints: the
    vectorizer's build (the fetch less its ``vectorize``, ``fleet`` and
    ``consensus`` spans: CUDA's initialisation, the encoder's seeded
    init, the fold).  A second child times, in a fresh interpreter,
    CUDA's initialisation after torch's import and then the CLI's fold
    alone (``quantize_params`` of the seed-0 ROBERTA_GO_EMOTIONS float32
    weights the CLI's session draws)."""
    import threading

    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-X", "importtime", "-m", "svoc_torch.apps.cli", "--int8",
         "--seed-comments", "200"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(Path(__file__).resolve().parent))
    marks, out, err = {}, [], []

    def read(stream, sink, rules):
        for line in stream:
            now = time.perf_counter() - t0
            sink.append(line.rstrip("\n"))
            for name, test in rules:
                if name not in marks and test(line):
                    marks[name] = now

    readers = [
        threading.Thread(target=read, args=(proc.stderr, err, [
            ("torch", lambda l: re.search(r"\|\s+torch$", l.rstrip()) is not None),
            # run as __main__, the CLI module itself is not an import
            ("port", lambda l: re.search(r"\|\s+svoc_torch\.apps\.commands$", l.rstrip()) is not None)])),
        threading.Thread(target=read, args=(proc.stdout, out, [
            ("resumed", lambda l: "consensus_active:" in l),
            ("fetched", lambda l: "suspected failing oracles" in l)])),
    ]
    for r in readers:
        r.start()
    proc.stdin.write("\n".join(CLI_SCRIPT) + "\n")
    proc.stdin.close()
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    for r in readers:
        r.join(timeout=30)
    total = time.perf_counter() - t0
    errors = [line for line in out if "error:" in line]
    # Random weights may leave the fleet degenerate: a commit may then stop
    # at the contract ("Commit FAILED ..."), as the reference's does.
    check(rc == 0 and not errors and any("Dimension: 6" in line for line in out)
          and any("Commit predictions..." in line for line in out),
          f"16b: the CLI --int8 exited {rc}, {len(out)} lines, no error line ({errors[:3]})")
    # The startup fetch's spans: the first of each name that metrics
    # trace printed (the trace lists the newest 20, oldest first).
    spans = {}
    for line in out:
        m = re.search(r"\b(quantize|vectorize|fleet|consensus|fetch): ([0-9.]+)ms", line)
        if m and m.group(1) not in spans:
            spans[m.group(1)] = float(m.group(2)) / 1e3
    check({"torch", "port", "resumed", "fetched"} <= set(marks) and "fetch" in spans,
          f"16b: the start's marks { {k: round(v, 3) for k, v in marks.items()} } and spans {spans}")
    probe = subprocess.run(
        [sys.executable, "-c", "import time, torch\n"
         "t = time.perf_counter(); torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
         "cuda_s = time.perf_counter() - t\n"
         "from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS as cfg\n"
         "from svoc_torch.models.encoder import init_params\n"
         "from svoc_torch.models.quant import quantize_params\n"
         "params = init_params(cfg, 0, 'cuda'); torch.cuda.synchronize()\n"
         "t = time.perf_counter(); quantize_params(params, cfg); torch.cuda.synchronize()\n"
         "print(cuda_s, time.perf_counter() - t)"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(Path(__file__).resolve().parent))
    check(probe.returncode == 0, f"16b: the CUDA-and-fold probe exited {probe.returncode} ({probe.stderr[-300:]})")
    cuda_s, fold_s = (float(x) for x in (probe.stdout.split() + ["nan", "nan"])[:2])
    if {"torch", "port", "resumed", "fetched"} <= set(marks) and "fetch" in spans:
        build = spans["fetch"] - sum(spans.get(k, 0.0) for k in ("vectorize", "fleet", "consensus"))
        print(f"  [{card}] 16b CLI --int8 start: torch's import {marks['torch']:.3f} s, the port's imports "
              f"{marks['port'] - marks['torch']:.3f} s, the session and its resume "
              f"{marks['resumed'] - marks['port']:.3f} s (no device touched), the startup fetch "
              f"{marks['fetched'] - marks['resumed']:.3f} s: the vectorizer's build {build:.3f} s (CUDA's "
              f"initialisation, the encoder's seeded init on the card, the fold), "
              f"vectorize {spans.get('vectorize', 0):.3f} s, fleet {spans.get('fleet', 0):.3f} s; the child "
              f"{total:.3f} s in all. Alone in a fresh interpreter: CUDA's initialisation {cuda_s:.3f} s, "
              f"the fold {fold_s:.3f} s")
    print("  16b output: " + json.dumps(out[-12:]))


@phase("16. the operator console at full width: commands, the CLI --int8, the web UI")
def console_phase(torch, launches, fabric):
    import urllib.error
    import urllib.request

    from svoc_torch.apps import web
    from svoc_torch.apps.commands import CommandConsole
    from svoc_torch.apps.session import Session, SessionConfig
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.obsplane.profiler import ProfileCapture
    from svoc_torch.utils.metrics import MetricsRegistry

    card = nvidia_smi()
    if not fabric:
        check(False, "16: 9b's fabric did not run")
        return
    # (a) A console over a CUDA Session at its defaults (ROBERTA_GO_EMOTIONS,
    # packed, dense, 7 oracles; refresh 0.5 s so that live mode turns in
    # the phase), with 9b's fabric, a 10b-shaped tier (one packed flash
    # bf16 pipeline, queues of 64) and the profiler attached.
    store = CommentStore()
    store.save(SyntheticSource(batch=200)())
    written = []  # every line the console writes, the background loops' too
    console = CommandConsole(Session(SessionConfig(refresh_rate_s=0.5), store=store),  # device None: CUDA
                             write=written.append)
    # An auto cycle (fetch, commit, resume, supervisor, SLO fold) ends with
    # the session's slo_step: count those to know that live mode turned.
    cycles = []
    slo_step = console.session.slo_step

    def counted_slo_step():
        result = slo_step()
        cycles.append(time.perf_counter())
        return result

    console.session.slo_step = counted_slo_step
    from svoc_torch.utils.metrics import registry as metrics_registry

    auto_errors0 = metrics_registry.counter("auto_fetch_errors").count
    scrape_faults0 = metrics_registry.family_total("scrape_faults")
    multi = fabric["multi"]
    multi.attach(console)
    pipe = width_pipeline(torch)
    tier = width_tier(multi, pipe, MetricsRegistry())
    tier.attach(console)
    profiles = Path(__file__).resolve().parent / "chiprun_out" / "console_profiles"
    ProfileCapture(str(profiles)).attach(console)
    wrappers = zero_counts()
    walls, errors = [], []
    for command in CONSOLE_SCRIPT:
        t0 = time.perf_counter()
        lines = console.query(command)
        walls.append((" ".join(command.split()[:2]), round((time.perf_counter() - t0) * 1e3, 3)))
        errors += [f"{command}: {line}" for line in lines if line.startswith("error:")]
        if command == "live_mode on":
            # Hold live mode until the background loop has finished one
            # whole cycle; 'live_mode off' then lets the cycle under way end.
            live_on = time.perf_counter()
            deadline = time.monotonic() + 60
            while not cycles and time.monotonic() < deadline:
                time.sleep(0.05)
            live_wait = (cycles[0] if cycles else time.perf_counter()) - live_on
    thread = console._auto_fetch_thread
    console.stop()
    if thread is not None:
        thread.join(timeout=60)
    if console._scraper_thread is not None:
        console._scraper_thread.join(timeout=30)
    console.session.slo_step = slo_step
    counts_a = read_counts(wrappers)
    check(not errors, f"16a: {len(CONSOLE_SCRIPT)} commands, no error line ({errors[:3]})")
    auto_errors = metrics_registry.counter("auto_fetch_errors").count - auto_errors0
    scrape_faults = metrics_registry.family_total("scrape_faults") - scrape_faults0
    written_errors = [line for line in written if "error:" in line]
    check(len(cycles) >= 1 and (thread is None or not thread.is_alive()) and auto_errors == 0
          and scrape_faults == 0 and not written_errors
          and getattr(console, "_last_auto_fetch_error", None) is None,
          f"16a: live mode ran {len(cycles)} whole auto cycle(s) in {live_wait:.3f} s with no auto_fetch "
          f"error ({auto_errors:g} counted, {written_errors[:3]}) and no scrape fault ({scrape_faults:g})")
    claims = console.query("claims")
    check(claims[0].startswith(f"fabric: {FABRIC_CLAIMS} claims") and "impl=cuda" in claims[0],
          f"16a: claims reads 9b's fabric on the card ({claims[0]})")
    check(counts_a["threefry"] > 0 and counts_a["fleet_draws"] > 0 and counts_a["gated_claims_consensus"] > 0
          and counts_a["flash_attention"] > 0,
          f"16a: the session's fetches drew on threefry and the fleet draws, the tier's step launched B1 and B3 "
          f"({counts_a})")
    add_launches(launches, counts_a)
    print(f"  [{card}] 16a command wall ms: " + json.dumps(walls))
    print(f"  [{card}] 16a live mode: {len(cycles)} whole auto cycle(s), the first ended "
          f"{live_wait:.3f} s after 'live_mode on'; launches {counts_a}")

    # (b) The CLI with --int8 in a child (its launches are the child's own).
    cli_child(torch, card)

    # (c) serve(console) on port 0 of the loopback.
    wrappers = zero_counts()
    server, _thread = web.serve(console, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    codes = {}

    def fetch(path, body=None):
        req = urllib.request.Request(base + path, data=None if body is None else body.encode(),
                                     method="GET" if body is None else "POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                data = r.readline() if path.startswith("/api/events") else r.read()
                while path.startswith("/api/events") and not data.startswith(b"data: "):
                    data = r.readline()
                codes[path] = (r.status, round((time.perf_counter() - t0) * 1e3, 3))
                return data
        except urllib.error.HTTPError as e:
            codes[path] = (e.code, round((time.perf_counter() - t0) * 1e3, 3))
            return b""

    try:
        query = json.loads(fetch("/api/query", "fetch") or b"[]")
        state = json.loads(fetch("/api/state") or b"{}")
        frame = fetch("/api/events")
        metrics_text = fetch("/metrics").decode()
        submit = fetch("/api/submit", json.dumps({"claim": "alpha", "text": "one more comment from the web"}))
    finally:
        server.shutdown()
    counts_c = read_counts(wrappers)
    add_launches(launches, counts_c)
    check(codes.get("/api/query", (0,))[0] == 200 and any("fetched" in line for line in query)
          and codes.get("/api/state", (0,))[0] == 200 and len(state.get("claims", {})) == FABRIC_CLAIMS
          and state.get("fabric", {}).get("consensus_impl") == "cuda" and "serving" in state
          and codes.get("/api/events", (0,))[0] == 200 and frame.startswith(b"data: ")
          and codes.get("/metrics", (0,))[0] == 200 and "# TYPE" in metrics_text
          and codes.get("/api/submit", (0,))[0] in (200, 429) and bool(submit),
          f"16c: every route answered with its code: {codes}")
    print(f"  [{card}] 16c routes (code, wall ms): {codes}; launches {counts_c}")


#: Phase 17: the claim-sharded dispatch's meshes (b), the sharded fleet's (c), the data mesh's slots (d) and
#: its timed steps after one warm-up. Every mesh is slots of cuda:0 (svoc_torch/parallel/mesh.py).
MESH_DISPATCH_SPECS = ("2x1", "4x2", "8x1")
MESH_FLEET_SPECS = ("1x1", "2x4", "8x1")
DP_SLOTS = 2
DP_STEPS = 3


def nan_equal(torch, a, b) -> bool:
    """``array_equal`` with NaN equal to NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def outputs_equal(torch, a, b) -> bool:
    return len(a) == len(b) and all(nan_equal(torch, x, y) for x, y in zip(a, b))


@phase("17a. the mesh: the shard-smoke twin on the card (2x4, eight slots of cuda:0), against the reference")
def shard_smoke_phase(torch, launches):
    from svoc_torch.tools import shard_smoke

    wrappers = zero_counts()
    t0 = time.perf_counter()
    report = shard_smoke.run_shard_smoke(0, 10)
    seconds = time.perf_counter() - t0
    counts = read_counts(wrappers)
    add_launches(launches, counts)
    for name, passed in report["checks"].items():
        check(passed, f"17a shard-smoke {name}")
    b3, dispatches = report["b3_launches"], int(report["shard_dispatches"])
    check(b3["meshed"] == shard_smoke.MESH_CLAIMS * dispatches and b3["unmeshed"] == dispatches,
          f"17a B3 once a claim shard: {b3['meshed']} launches for {dispatches} meshed dispatches on {shard_smoke.MESH}"
          f" (2 claim shards; the 4 oracle-axis slots of a shard share its one result), {b3['unmeshed']} unmeshed")
    print(f"  [{nvidia_smi()}] shard smoke: 3 runs in {seconds:.3f} s, fingerprints {report['fingerprints']}, "
          f"launches {counts}", flush=True)


@phase("17b. the claim-sharded dispatch at [64, 1024, 6] on 2x1, 4x2 and 8x1 against the unsharded B3 dispatch")
def mesh_dispatch_phase(torch, launches):
    from svoc_torch.consensus.batch import claims_consensus_gated, pad_claim_cube
    from svoc_torch.parallel.claim_shard import sharded_claims_consensus_fn
    from svoc_torch.parallel.mesh import claim_mesh

    bench, bench_ok, cfg = bench_cube()
    values, ok, mask = (t.cuda() for t in pad_claim_cube(bench, bench_ok))
    ref = claims_consensus_gated(values, ok, mask, cfg)
    unsharded = lambda: claims_consensus_gated(values, ok, mask, cfg)  # noqa: E731
    times = {"unsharded": [cuda_ms(torch, unsharded, iters=50)]}
    for spec in MESH_DISPATCH_SPECS:
        mesh = claim_mesh(spec)
        fn = sharded_claims_consensus_fn(mesh, cfg)
        wrappers = zero_counts()
        out = fn(values, ok, mask)
        counts = read_counts(wrappers)
        add_launches(launches, counts)
        shards = mesh.shape["claim"]
        check(outputs_equal(torch, out, ref),
              f"17b {spec}: every output array_equal (NaN-aware) to the unsharded B3 dispatch")
        check(counts["gated_claims_consensus"] == shards and sum(counts.values()) == shards,
              f"17b {spec}: B3 once a claim shard of {64 // shards} claims ({counts})")
        times[spec] = [cuda_ms(torch, lambda: fn(values, ok, mask), iters=50)]
    times["unsharded"].append(cuda_ms(torch, unsharded, iters=50))  # in turns: unsharded, meshes, unsharded
    print(f"  [{nvidia_smi()}] a dispatch of [64, 1024, 6] (CUDA events over 50 back-to-back dispatches): "
          + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()), flush=True)


@phase("17c. the sharded fleet at [64, 1024, 6] on 1x1, 2x4 and 8x1: bitwise invariant")
def mesh_fleet_phase(torch, launches):
    import numpy as np

    from svoc_torch.consensus.batch import claims_consensus_gated
    from svoc_torch.parallel.claim_shard import fleet_claims_reference, sharded_fleet_claims_fn
    from svoc_torch.parallel.mesh import claim_mesh
    from svoc_torch.sim import claim_fleet_keys, prng

    _, _, cfg = bench_cube()
    keys = claim_fleet_keys(prng.PRNGKey(0, "cuda"), CLAIMS)
    windows = torch.from_numpy(np.random.default_rng(5).uniform(size=(CLAIMS, 50, 6)).astype(np.float32)).cuda()
    values, honest = fleet_claims_reference(keys, windows, ORACLES, cfg.n_failing)
    ones = torch.ones(values.shape[:2], dtype=torch.bool, device="cuda")
    reference = (*claims_consensus_gated(values, ones, ones[:, 0].contiguous(), cfg), honest)
    times = {}
    for spec in MESH_FLEET_SPECS:
        mesh = claim_mesh(spec)
        fn = sharded_fleet_claims_fn(mesh, cfg, ORACLES)
        wrappers = zero_counts()
        out, got_honest = fn(keys, windows)
        counts = read_counts(wrappers)
        add_launches(launches, counts)
        check(outputs_equal(torch, (*out, got_honest), reference),
              f"17c {spec}: every output bitwise the unsharded fleet's consensus (and so every mesh's)")
        check(counts["gated_claims_consensus"] == mesh.size,
              f"17c {spec}: B3 once a slot on its claims' gathered blocks ({counts})")
        t0 = time.perf_counter()
        for _ in range(3):
            fn(keys, windows)[0].essence.cpu()
        times[spec] = (time.perf_counter() - t0) / 3 * 1e3
    check(int((~honest).sum()) == CLAIMS * cfg.n_failing, "17c: 256 failing oracles a claim")
    print(f"  [{nvidia_smi()}] a sharded fleet step of [64, 1024, 6] (host clock, to the essence on the host, 3 "
          f"runs): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)


@phase("17d. data-parallel packed serving at full ROBERTA_GO_EMOTIONS width: a data mesh of 2 slots against 1")
def mesh_serving_phase(torch, launches):
    from svoc_torch.flagship import FlagshipStep
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.parallel.serving import (
        fleet_step_fn,
        packed_serving_pipelined_step_fn,
        packed_serving_step_fn,
        serving_mesh,
    )
    from svoc_torch.sim import prng

    step = FlagshipStep(device="cuda")  # ROBERTA_GO_EMOTIONS, flash, bf16 weights, 1024 oracles (128 failing)
    params = step.pipe.packed_model.state_dict()
    feed = step.comments(SyntheticSource(batch=step.rows, seed=0))
    batches = []
    for _ in range(1 + DP_STEPS):
        batch, n = next(feed)
        batches.append((tuple(t.clone() for t in (batch.ids, batch.pos, batch.seg, batch.cls_pos))
                        + ((batch.seg_valid > 0).clone(),), n))
    feed.close()
    kw = dict(window_size=step.window_size, subset_size=step.subset_size)
    key = prng.PRNGKey(0, "cuda")
    runs = {}
    for slots in (1, DP_SLOTS):
        mesh = serving_mesh(["cuda:0"] * slots)
        serve = packed_serving_step_fn(mesh, step.pipe.cfg, step.ccfg, step.n_oracles, **kw)
        pserve = packed_serving_pipelined_step_fn(mesh, step.pipe.cfg, step.ccfg, step.n_oracles, **kw)
        with torch.inference_mode():
            serve(params, key, *batches[0][0])  # builds the slots' modules
            wrappers = zero_counts()
            out, honest = serve(params, key, *batches[0][0])
            counts = read_counts(wrappers)
            add_launches(launches, counts)
            window, _, _ = pserve(params, key, *batches[0][0], torch.zeros(step.window_size, 6, device="cuda"))
            t0 = time.perf_counter()
            comments = 0
            for i, (args, n) in enumerate(batches[1:], 1):
                serve(params, prng.fold_in(key, i), *args)[0].essence.cpu()
                comments += n
            seconds = time.perf_counter() - t0
        check(counts["flash_attention"] == step.pipe.cfg.n_layers * slots and counts["fused_consensus"] == 0,
              f"17d {slots} slot(s): B1 {step.pipe.cfg.n_layers} × {slots} a forward, B2 never (the psum body): "
              f"{counts}")
        runs[slots] = dict(out=out, honest=honest, window=window, rate=comments / seconds,
                           step_ms=seconds / DP_STEPS * 1e3, mesh=mesh)
    one, two = runs[1], runs[DP_SLOTS]
    gap = float((one["window"] - two["window"]).abs().max())
    check(gap <= 3e-2, f"17d window vectors of 2 slots within the attention bf16 bar of 1 slot's: {gap:.3g}")
    check(torch.equal(one["honest"], two["honest"]) and torch.equal(one["out"].reliable, two["out"].reliable),
          "17d the steps' honest and reliable masks equal")
    # The consensus of one window on 2 slots against 1: the mesh's own math, apart from the forward's rows.
    drained = [fleet_step_fn(run["mesh"], step.ccfg, step.n_oracles, subset_size=step.subset_size)(key, one["window"])
               for run in (one, two)]
    check(torch.equal(drained[0][1], drained[1][1]) and torch.equal(drained[0][0].reliable, drained[1][0].reliable),
          "17d one window's honest and reliable masks equal on 2 slots and 1")
    errs, step_gaps = {}, {}
    for field in ("essence", "essence_first_pass", "reliability_first_pass", "reliability_second_pass",
                  "quadratic_risk", "skewness", "kurtosis"):
        a, b = getattr(drained[1][0], field), getattr(drained[0][0], field)
        rtol, atol = (1e-4, 1e-5) if field in ("skewness", "kurtosis") else (1e-5, 0.0)
        errs[field] = float(((a - b).abs() - rtol * b.abs()).max())
        step_gaps[field] = float((getattr(two["out"], field) - getattr(one["out"], field)).abs().max())
        check(bool(((a - b).abs() <= atol + rtol * b.abs()).all()),
              f"17d {field} of one window on 2 slots within tests/test_parallel.py's bar of 1 slot's "
              f"(rtol {rtol}, atol {atol})")
    print(f"  [{nvidia_smi()}] DP packed serving, 256 x 128 rows, {DP_STEPS} steps after a warm-up: 1 slot "
          f"{one['rate']:.1f} comments/s ({one['step_ms']:.3f} ms a step), {DP_SLOTS} slots {two['rate']:.1f} "
          f"comments/s ({two['step_ms']:.3f} ms a step; two slots of one card cannot gain); window gap {gap:.3g}; "
          f"one window's consensus, excess over the bars {errs}; the steps' consensus gaps {step_gaps}", flush=True)


#: Phase 18: the training and sequence paths on the mesh, every mesh slots of cuda:0.
#: (a) ring attention: q, k, v [B, T, H, D] bf16 on 8 seq slots (1024 keys a hop), each row's real keys.
RING_SHAPE, RING_SLOTS, RING_KEYS = (2, 8192, 12, 64), 8, (8192, 3000)
#: (b, c) the sequence-parallel batch: ROBERTA_GO_EMOTIONS ids [8, 512], each row's real tokens.
SP_LENGTHS, SP_T = (512, 480, 333, 256, 130, 64, 9, 2), 512
SP_TRAIN_STEPS, SP_SGD_LR = 3, 1e-3
#: (d) the pipeline: ids [32, 128] on stage(4) x data(2), 4 microbatches.
PIPE_ROWS, PIPE_T, PIPE_MESH, PIPE_MICRO = 32, 128, (4, 2), 4
#: (e) the tensor-parallel packed step on data(4) x model(2): steps with and without ZeRO-1, AdamW's lr.
TP_MESH, TP_STEPS, TP_LR = (4, 2), 3, 1e-4
#: Bars of phase 18 where the reference gives none (PERF.md §6 gives their reasons):
#: bf16 logits of a sharded forward against the unsharded one (4x the 2.5e-2 that the same comparisons
#: gave at full width on the CPU); the TP step's loss and grad norm (rtol) against the unsharded step's;
#: 18a's bf16 attention outputs against each other (typical |output| about 0.02 over 8192 random keys, so
#: the reference's 3e-2 of short rows would pass anything; 3.4x the 2.9e-3 that sound runs read).
MESH_LOGIT_BAR, TP_LOSS_RTOL, TP_NORM_RTOL, RING_OUT_BAR = 1e-1, 5e-3, 2e-2, 1e-2


def mesh_wrappers():
    """The counted wrappers of phase 18: B1, B4 and B5 (the others must stay at 0)."""
    from svoc_torch.ops.flash_attention import flash_dkv_cuda, flash_dq_cuda

    return dict(counted_wrappers(), flash_dq=flash_dq_cuda, flash_dkv=flash_dkv_cuda)


def event_ms(torch, fn):
    """One call of ``fn`` between two CUDA events: (ms, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def launches_are(counts: dict, want: dict) -> bool:
    """Every counted kernel launched as ``want`` says, and the others not at all."""
    return all(counts.get(k, 0) == want.get(k, 0) for k in set(counts) | set(want))


@phase("18a. ring attention at [2, 8192, 12, 64] bf16 on 8 seq slots: flash and dense inner, B1 at the hop")
def ring_phase(torch, launches):
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import attention_tags, flash_attention_cuda, flash_attention_plain
    from svoc_torch.parallel.mesh import MeshSpec, make_mesh
    from svoc_torch.parallel.ring_attention import ring_attention_fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    b, t, h, d = RING_SHAPE
    hop = t // RING_SLOTS
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    kmask = (torch.arange(t, device=dev)[None, :] < torch.tensor(RING_KEYS, device=dev)[:, None]).to(torch.int32)
    mesh = make_mesh(MeshSpec(("seq",), (RING_SLOTS,)))
    flash_ring, dense_ring = ring_attention_fn(mesh, block_impl="flash"), ring_attention_fn(mesh)
    card = nvidia_smi()
    with torch.inference_mode():
        flash_ring(q, k, v, kmask)  # warm-up
        wrappers = zero_counts(mesh_wrappers())
        flash_ms, out_flash = event_ms(torch, lambda: flash_ring(q, k, v, kmask))
        counts = read_counts(wrappers)
        add_launches(launches, counts)
        want = {"flash_attention": RING_SLOTS * RING_SLOTS}
        check(launches_are(counts, want),
              f"18a flash ring: B1 {RING_SLOTS} slots x {RING_SLOTS} hops = {want['flash_attention']} launches "
              f"a call ({counts})")
        wrappers = zero_counts(mesh_wrappers())
        dense_ms, out_dense = event_ms(torch, lambda: dense_ring(q, k, v, kmask))
        counts_dense = read_counts(wrappers)
        check(launches_are(counts_dense, {}), f"18a dense ring: no kernel launches ({counts_dense})")
        qtag, ktag = attention_tags(q, kmask=kmask > 0)
        whole = flash_attention_cuda(q, k, v, qtag, ktag)  # B1 over the whole sequence: the comparison
        errs = {"flash ring - dense ring": max_err(out_flash, out_dense),
                "flash ring - B1 whole": max_err(out_flash, whole),
                "dense ring - B1 whole": max_err(out_dense, whole)}
        check(all(e <= RING_OUT_BAR for e in errs.values()) and bool(torch.isfinite(out_flash.float()).all()),
              f"18a the rings agree with each other and with B1 over the whole sequence within {RING_OUT_BAR} "
              f"(max |B1 whole| {float(whole.float().abs().max()):.3e}): {errs}")
        print(f"  [{card}] ring call of [2, 8192, 12, 64] bf16 on 8 slots (CUDA events, one call after a "
              f"warm-up): flash inner {flash_ms:.3f} ms, dense inner {dense_ms:.3f} ms", flush=True)

        # B1 at the hop's shape: shard 0's queries against shard 3's keys, all padding for row 1.
        dead_shard = 3
        qb = q[:, :hop].contiguous()
        kb, vb = (x[:, dead_shard * hop:(dead_shard + 1) * hop].contiguous() for x in (k, v))
        mb = kmask[:, dead_shard * hop:(dead_shard + 1) * hop].contiguous()
        bq, bk = attention_tags(qb, kmask=mb > 0)
        out_b, lse_b = flash_attention_cuda(qb, kb, vb, bq, bk, return_lse=True)
        ref_b, ref_lse = flash_attention_plain(qb, kb, vb, bq, bk, return_lse=True)
        live = torch.isfinite(ref_lse)
        check(max_err(out_b, ref_b) <= RING_OUT_BAR and float((lse_b[live] - ref_lse[live]).abs().max()) <= 1e-3
              and torch.equal(live, torch.isfinite(lse_b)),
              f"18a B1 at the hop [2, {hop}, 12, 64] with kmask and return_lse: out err "
              f"{max_err(out_b, ref_b):.3e} <= {RING_OUT_BAR} (max |plain| {float(ref_b.float().abs().max()):.3e}), "
              f"lse err {float((lse_b[live] - ref_lse[live]).abs().max()):.3e} <= 1e-3")
        check(bool(torch.all(out_b[1] == 0)) and bool(torch.all(torch.isneginf(lse_b[1]))),
              "18a the all-padding hop (row 1, keys of shard 3): output exactly 0 and lse -inf")

        # Times at the hop's shape, every key real (shard 0 against shard 0).
        k0, v0 = (x[:, :hop].contiguous() for x in (k, v))
        m0 = kmask[:, :hop].contiguous()
        t0q, t0k = attention_tags(qb, kmask=m0 > 0)
        kernel_ms = cuda_ms(torch, lambda: flash_attention_cuda(qb, k0, v0, t0q, t0k, return_lse=True))
        plain_ms = cuda_ms(torch, lambda: flash_attention_plain(qb, k0, v0, t0q, t0k, return_lse=True), iters=5)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (qb, k0, v0))
        bool_mask = (m0 > 0)[:, None, None, :]
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bool_mask))
        kernel_again = cuda_ms(torch, lambda: flash_attention_cuda(qb, k0, v0, t0q, t0k, return_lse=True))
        elems = b * hop * h * d
        bytes_moved = 4 * elems * 2 + 2 * b * hop * 4 + b * hop * h * 4  # q, k, v read, out written; tags; lse
        bound_ms, bound_by = bound(bytes_moved, 4.0 * b * h * hop * hop * d, BF16_FLOPS)
        print(f"  [{card}] B1 at the ring hop [2, {hop}, 12, 64] bf16, kmask, return_lse (CUDA events, 20 "
              f"launches): kernel {kernel_ms:.4f} / {kernel_again:.4f} ms (before / after SDPA), plain "
              f"{plain_ms:.4f} ms, SDPA (boolean key mask) {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)


def sp_batch(torch, cfg, dev):
    """18b's ids and mask [8, 512]: mixed lengths, padding spanning shards."""
    import numpy as np

    rng = np.random.default_rng(18)
    ids = torch.from_numpy(rng.integers(4, cfg.vocab_size, (len(SP_LENGTHS), SP_T)).astype("int32"))
    mask = torch.zeros_like(ids)
    for i, n in enumerate(SP_LENGTHS):
        mask[i, :n] = 1
        ids[i, n:] = cfg.pad_id
    labels = torch.from_numpy((rng.random((len(SP_LENGTHS), cfg.n_labels)) < 0.05).astype("float32"))
    return ids.to(dev), mask.to(dev), labels.to(dev)


@phase("18b. the sequence-parallel forward at full ROBERTA_GO_EMOTIONS width: ids [8, 512] on 8 seq slots")
def sp_forward_phase(torch, launches):
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import SentimentEncoder, init_params, load_encoder
    from svoc_torch.parallel.mesh import MeshSpec, make_mesh
    from svoc_torch.parallel.sp_encoder import sequence_parallel_forward_fn

    dev = torch.device("cuda")
    params = init_params(ROBERTA_GO_EMOTIONS, seed=0, device=dev)
    ids, mask, _ = sp_batch(torch, ROBERTA_GO_EMOTIONS, dev)
    mesh = make_mesh(MeshSpec(("seq",), (8,)))
    card = nvidia_smi()
    outs = {}
    with torch.inference_mode():
        for attention in ("dense", "flash"):
            cfg = dataclasses.replace(ROBERTA_GO_EMOTIONS, attention=attention)
            fwd = sequence_parallel_forward_fn(mesh, cfg)
            fwd(params, ids, mask)  # warm-up
            wrappers = zero_counts(mesh_wrappers())
            ms, logits = event_ms(torch, lambda: fwd(params, ids, mask))
            counts = read_counts(wrappers)
            add_launches(launches, counts)
            want = {"flash_attention": cfg.n_layers * 8 * 8} if attention == "flash" else {}
            check(launches_are(counts, want),
                  f"18b {attention} inner: B1 {want.get('flash_attention', 0)} launches a forward (12 layers x 8 "
                  f"slots x 8 hops under flash) ({counts})")
            plain_ms, plain = event_ms(torch, lambda: load_encoder(SentimentEncoder, cfg, params)(ids, mask))
            err = max_err(logits, plain)
            check(err <= MESH_LOGIT_BAR and bool(torch.isfinite(logits).all()) and logits.shape == (8, 28),
                  f"18b {attention} inner: logits [8, 28] within {MESH_LOGIT_BAR} of the unsharded {attention} "
                  f"forward's: {err:.3e} (max |logit| {float(plain.abs().max()):.3f})")
            outs[attention] = logits
            print(f"  [{card}] SP forward, {attention} inner: {ms:.3f} ms on 8 slots (CUDA events, after a "
                  f"warm-up), the unsharded forward {plain_ms:.3f} ms", flush=True)
    gap = max_err(outs["flash"], outs["dense"])
    check(gap <= MESH_LOGIT_BAR, f"18b flash inner within {MESH_LOGIT_BAR} of the dense inner: {gap:.3e}")


@phase("18c. the sequence-parallel train step at full width, float32, dense: 3 SGD steps against the unsharded")
def sp_train_phase(torch, launches):
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import SentimentEncoder, init_params
    from svoc_torch.parallel.mesh import MeshSpec, make_mesh
    from svoc_torch.train.trainer import Batch, init_state, make_sp_train_step, make_train_step, sgd

    dev = torch.device("cuda")
    cfg = dataclasses.replace(ROBERTA_GO_EMOTIONS, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    batch = Batch(*sp_batch(torch, cfg, dev))
    mesh = make_mesh(MeshSpec(("seq",), (8,)))
    card = nvidia_smi()
    runs = {}
    for name, step in (("unsharded", make_train_step()), ("sp", make_sp_train_step(cfg, mesh))):
        with torch.device("meta"):
            model = SentimentEncoder(cfg)
        state = init_state(model, params, sgd(SP_SGD_LR), device=dev)
        wrappers = zero_counts(mesh_wrappers())
        rows = []
        for _ in range(SP_TRAIN_STEPS):
            ms, (state, metrics) = event_ms(torch, lambda: step(state, batch))
            rows.append((metrics["loss"].item(), metrics["grad_norm"].item(), ms))
        counts = read_counts(wrappers)
        add_launches(launches, counts)
        check(launches_are(counts, {}), f"18c {name}: no kernel launches (dense attention) ({counts})")
        runs[name] = (rows, {k: p.detach() for k, p in state.model.named_parameters()})
        del state, model
        torch.cuda.empty_cache()
    (plain_rows, plain_p), (sp_rows, sp_p) = runs["unsharded"], runs["sp"]
    loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(sp_rows, plain_rows))
    p_err = max(max_err(sp_p[k], plain_p[k]) for k in plain_p)
    check(loss_err <= 1e-4 and p_err <= 5e-5,
          f"18c {SP_TRAIN_STEPS} SGD({SP_SGD_LR}) steps: losses within rtol 1e-4 ({loss_err:.3e}), parameters "
          f"within 5e-5 ({p_err:.3e}) of the unsharded dense step's (tests/test_train.py's SP bars)")
    print(f"  [{card}] SP train step [8, 512] f32 on 8 slots: (loss, grad norm, ms by CUDA events) {sp_rows}; "
          f"unsharded {plain_rows}", flush=True)


@phase("18d. the pipeline forward at full width: stage(4) x data(2), 4 microbatches, flash, ids [32, 128]")
def pipeline_phase(torch, launches):
    import numpy as np

    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import SentimentEncoder, init_params, load_encoder
    from svoc_torch.parallel import pipeline_forward_fn
    from svoc_torch.parallel.mesh import MeshSpec, make_mesh

    dev = torch.device("cuda")
    cfg = dataclasses.replace(ROBERTA_GO_EMOTIONS, attention="flash")
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(19)
    ids = torch.from_numpy(rng.integers(4, cfg.vocab_size, (PIPE_ROWS, PIPE_T)).astype("int32"))
    mask = torch.ones_like(ids)
    for i, n in enumerate(rng.integers(2, PIPE_T + 1, PIPE_ROWS)):
        mask[i, n:] = 0
        ids[i, n:] = cfg.pad_id
    ids, mask = ids.to(dev), mask.to(dev)
    mesh = make_mesh(MeshSpec(("stage", "data"), PIPE_MESH))
    fwd = pipeline_forward_fn(mesh, cfg, n_microbatches=PIPE_MICRO, data_axis="data")
    card = nvidia_smi()
    with torch.inference_mode():
        fwd(params, ids, mask)  # warm-up
        wrappers = zero_counts(mesh_wrappers())
        ms, logits = event_ms(torch, lambda: fwd(params, ids, mask))
        counts = read_counts(wrappers)
        add_launches(launches, counts)
        want = {"flash_attention": PIPE_MICRO * cfg.n_layers * PIPE_MESH[1]}
        check(launches_are(counts, want),
              f"18d B1 {want['flash_attention']} launches a forward: {PIPE_MICRO} microbatches x {cfg.n_layers} "
              f"layers x {PIPE_MESH[1]} data slots, the bubbles skipped ({counts})")
        plain_ms, plain = event_ms(torch, lambda: load_encoder(SentimentEncoder, cfg, params)(ids, mask))
    err = max_err(logits, plain)
    check(err <= MESH_LOGIT_BAR and logits.shape == (PIPE_ROWS, cfg.n_labels),
          f"18d logits within {MESH_LOGIT_BAR} of the unsharded flash forward's: {err:.3e}")
    print(f"  [{card}] pipeline forward of [32, 128] on stage(4) x data(2): {ms:.3f} ms (CUDA events, after a "
          f"warm-up; {PIPE_MESH[0] + PIPE_MICRO - 1} schedule steps), the unsharded forward {plain_ms:.3f} ms",
          flush=True)


@phase("18e. the tensor-parallel packed train step at full width on data(4) x model(2): flash, AdamW, ZeRO-1")
def tp_train_phase(torch, launches):
    import numpy as np

    from svoc_torch.flagship import pack_stream, token_lists
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.tokenizer import HashingTokenizer
    from svoc_torch.ops.flash_attention import (
        attention_delta, attention_tags, flash_attention_bwd_plain, flash_attention_cuda, flash_dkv_cuda,
        flash_dq_cuda,
    )
    from svoc_torch.parallel.mesh import MeshSpec, make_mesh
    from svoc_torch.train.trainer import adamw, make_packed_train_step, make_sharded_packed_train_step
    from svoc_torch.train.trainer import max_shard_fraction, sgd

    dev = torch.device("cuda")
    cfg = dataclasses.replace(ROBERTA_GO_EMOTIONS, attention="flash")
    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=128)
    feed = pack_stream(token_lists(tok, SyntheticSource(batch=256, seed=7), 128), 256, 128, 8, tok.pad_id)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(TP_STEPS):
        batch, n = next(feed)
        batches.append(train_batch(torch, batch, n, rng, cfg.n_labels, dev))
    params = init_params(cfg, seed=0, device=dev)
    mesh = make_mesh(MeshSpec(("data", "model"), TP_MESH))
    slots = TP_MESH[0] * TP_MESH[1]
    card = nvidia_smi()
    # The reference's parity step (tests/test_train.py::test_sharded_packed_train_step_matches_unsharded): float32,
    # one SGD(0.1) step, here on 64 of the 256 rows (16 a data slot).
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    batch32 = type(batches[0])(*(x[:64] for x in batches[0]))
    runs = {}
    # (name, configuration, optimizer, zero1 or None for the unsharded step, batches)
    for name, run_cfg, tx, zero1, run_batches in (
            ("unsharded", cfg, adamw(TP_LR), None, batches), ("sharded", cfg, adamw(TP_LR), False, batches),
            ("zero1", cfg, adamw(TP_LR), True, batches), ("f32 sgd unsharded", cfg32, sgd(0.1), None, [batch32]),
            ("f32 sgd sharded", cfg32, sgd(0.1), False, [batch32])):
        state = packed_state(torch, run_cfg, params, tx, dev)
        if zero1 is None:
            step = make_packed_train_step()
        else:
            step, shard_state, _ = make_sharded_packed_train_step(run_cfg, mesh, params_template=params, zero1=zero1)
            state = shard_state(state)
        rows, per_step = [], []
        torch.cuda.reset_peak_memory_stats()
        for tb in run_batches:
            wrappers = zero_counts(mesh_wrappers())
            t0 = time.perf_counter()
            ms, (state, metrics) = event_ms(torch, lambda: step(state, tb))
            rows.append(dict(loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(), event_ms=ms,
                             host_ms=(time.perf_counter() - t0) * 1e3))
            counts = read_counts(wrappers)
            add_launches(launches, counts)
            per_step.append(counts)
        heads = cfg.n_heads // (TP_MESH[1] if zero1 is not None else 1)
        want = cfg.n_layers * (slots if zero1 is not None else 1)
        check(all(launches_are(c, dict(flash_attention=want, flash_dq=want, flash_dkv=want)) for c in per_step),
              f"18e {name}: B1, B4 and B5 {want} launches each a step, on {heads} of the {cfg.n_heads} heads "
              f"({per_step[0]})")
        if zero1 is None:
            whole = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        else:
            whole = {k: arr.gather() for k, arr in state.params.items()}
        extra = {}
        if name == "zero1":
            fractions = {k: max_shard_fraction(arr) for m in state.opt_state.values() for k, arr in m.items()}
            worst = max(max_shard_fraction(arr) for m in state.opt_state.values() for arr in m.values())
            extra = dict(moments=len(fractions), max_shard_fraction=worst)
            check(len(state.opt_state) == len(whole) and worst <= 0.25 + 1e-9,
                  f"18e ZeRO-1: every AdamW moment of all {len(whole)} parameters at most 1/4 of its whole on a "
                  f"slot (largest piece {worst:.4f} of its whole)")
        extra["rows"] = run_batches[0].ids.shape[0]
        runs[name] = (rows, whole, torch.cuda.max_memory_allocated() / 2**30, extra)
        del state
        torch.cuda.empty_cache()
    plain_rows = runs["unsharded"][0]
    for name in ("sharded", "zero1"):
        rows = runs[name][0]
        loss_err = max(abs(r["loss"] - p["loss"]) / abs(p["loss"]) for r, p in zip(rows, plain_rows))
        norm_err = max(abs(r["grad_norm"] - p["grad_norm"]) / p["grad_norm"] for r, p in zip(rows, plain_rows))
        check(loss_err <= TP_LOSS_RTOL and norm_err <= TP_NORM_RTOL,
              f"18e {name}: against the unsharded packed step over {TP_STEPS} AdamW({TP_LR}) steps, losses rtol "
              f"{loss_err:.3e} <= {TP_LOSS_RTOL}, grad norms rtol {norm_err:.3e} <= {TP_NORM_RTOL}")
    (rows, whole, _, _), (z_rows, z_whole, _, _) = runs["sharded"], runs["zero1"]
    same = [(r["loss"], r["grad_norm"]) for r in rows] == [(r["loss"], r["grad_norm"]) for r in z_rows]
    differ = [k for k in whole if not torch.equal(whole[k], z_whole[k])]
    check(same and not differ,
          f"18e ZeRO-1 bitwise the sharded step after {TP_STEPS} AdamW steps: losses and grad norms equal ({same}), "
          f"parameters equal but for {len(differ)} of {len(whole)} ({differ[:3]})")
    (plain_rows, plain_p, _, _), (rows, whole, _, _) = runs["f32 sgd unsharded"], runs["f32 sgd sharded"]
    loss_err = abs(rows[0]["loss"] - plain_rows[0]["loss"]) / abs(plain_rows[0]["loss"])
    p_errs = {k: max_err(whole[k], plain_p[k]) for k in plain_p}
    worst = max(p_errs, key=p_errs.get)
    check(loss_err <= 2e-4 and p_errs[worst] <= 2e-5,
          f"18e float32, one SGD(0.1) step of 64 rows, sharded against unsharded (tests/test_train.py's sharded "
          f"packed bars): loss rtol {loss_err:.3e} <= 2e-4, parameters {p_errs[worst]:.3e} <= 2e-5 (worst {worst}; "
          f"largest update {max(max_err(plain_p[k], params[k]) for k in params):.3e})")
    for name, (rows, _, peak, extra) in runs.items():
        print(f"  [{card}] {name} packed step of {extra.pop('rows')} x 128 rows: " + json.dumps(rows)
              + f"; max memory allocated {peak:.3f} GiB {extra or ''}", flush=True)

    # B4 and B5 on a model shard's 6 heads: one data slot's 64 rows.
    seg = batches[0].seg[:64].to(torch.int32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, dout = (torch.randn(64, 128, cfg.n_heads // TP_MESH[1], cfg.head_dim, generator=gen,
                                 device=dev).to(torch.bfloat16) for _ in range(4))
    qtag, ktag = attention_tags(q, segment_ids=seg)
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    delta = attention_delta(out, dout)
    got = (flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta), *flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta))
    ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(), qtag, ktag, out.float(), lse, dout.float())
    errs = [max_err(g, r) for g, r in zip(got, ref)]
    ok = all(bool(((g.float() - r).abs() <= 3e-2 + 2.0 ** -8 * r.abs()).all()) for g, r in zip(got, ref))
    check(ok, "18e B4 and B5 on a 6-head shard [64, 128, 6, 64] bf16 with a data slot's segments: max |kernel - "
              "plain| dq {:.3e}, dk {:.3e}, dv {:.3e} <= 3e-2 + 2^-8 |plain|".format(*errs))


@phase("18f. the fine-tune twin's reference defaults on TINY on 4x2 slots with --zero1 (5c runs flash without)")
def finetune_mesh_phase(torch, launches):
    from svoc_torch.tools import finetune_demo

    card = nvidia_smi()
    wrappers = zero_counts(mesh_wrappers())
    t0 = time.perf_counter()
    report = finetune_demo.run(device="cuda", zero1=True)
    secs = time.perf_counter() - t0
    counts = read_counts(wrappers)
    add_launches(launches, counts)
    check(report["ok"] and report["same_mesh_replay_max_abs_param_delta"] == 0.0
          and report["changed_mesh_restore_max_abs_param_delta"] == 0.0 and launches_are(counts, {}),
          f"18f --zero1: macro-F1 {report['macro_f1_before']} -> {report['macro_f1_after']} (target "
          f"{report['target_f1']}), same-mesh replay {report['same_mesh_replay_max_abs_param_delta']}, "
          f"changed-mesh restore {report['changed_mesh_restore_max_abs_param_delta']}, continued losses "
          f"{report['changed_mesh_continued_losses']} (last < 1.5 x the checkpoint's), no kernel launches "
          f"(dense) ({counts})")
    print(f"  [{card}] --zero1: loss {report['loss_curve'][0]} -> {report['loss_curve'][-1]}, train step "
          f"{report['step_ms']:.3f} ms, {secs:.1f} s with the evaluations, the replay and the changed mesh",
          flush=True)


#: The reference analyzer (``svoc_tpu.analysis.analyze_paths``) over
#: ``svoc_tpu tools``, against ``tools/svoclint_baseline.json``: files
#: analyzed, findings by rule, suppressed findings, and those the baseline
#: covers (none new, none stale).
REFERENCE_LINT = {"files": 153, "by_rule": {"SVOC003": 6}, "suppressed": 36, "baselined": 6}


@phase("19. the lint gate: svoclint over svoc_torch in a child, and over the reference's tree in process")
def lint_phase(torch):
    import collections
    import tempfile

    from svoc_torch.analysis import Baseline, analyze_paths

    card = nvidia_smi()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "svoc_torch.tools.svoclint", "--format", "json",
             "--cache", os.path.join(tmp, ".svoclint_torch_cache.json")],
            cwd=root, capture_output=True, text=True, timeout=300,
        )
        child_s = time.perf_counter() - t0
    try:
        counts = json.loads(proc.stdout)["counts"]
    except (ValueError, KeyError):
        counts = {}
    check(proc.returncode == 0 and counts.get("new") == 0 and counts.get("stale_baseline_entries") == 0,
          f"19a svoclint over svoc_torch: exit {proc.returncode}, {counts} ({proc.stderr.strip()[-300:]})")
    print(f"  [{card}] 19a: {child_s:.2f} s in a child ({counts.get('files')} files, "
          f"{counts.get('baselined')} baselined, {counts.get('suppressed')} suppressed)", flush=True)
    t0 = time.perf_counter()
    report = analyze_paths([str(root / "svoc_tpu"), str(root / "tools")], root=str(root))
    new, baselined, stale = Baseline.load(str(root / "tools" / "svoclint_baseline.json")).split(
        report.all_findings)
    ref_s = time.perf_counter() - t0
    got = {"files": report.files, "by_rule": dict(collections.Counter(f.rule for f in report.all_findings)),
           "suppressed": report.suppressed, "baselined": len(baselined)}
    check(got == REFERENCE_LINT and not new and not stale,
          f"19b the port's analyzer over svoc_tpu tools: {got}, {len(new)} new, {len(stale)} stale "
          f"(reference analyzer: {REFERENCE_LINT})")
    print(f"  [{card}] 19b: {ref_s:.2f} s in process", flush=True)


#: Phase 20: config 3's steps on distinct keys, the calls timed alone by
#: CUDA events, and the seconds of each config's timed window in
#: ``baseline_configs.run`` (the rates and the 1024-oracle latency).
BASELINE_STEPS, BASELINE_EVENTS, BASELINE_SECONDS = 10, 5, 1.0
#: Config 1's bf16 forward against the same weights in float32 on the
#: card (the reference's bf16 bar, ``tests/test_pallas_attention.py``).
CONFIG1_BF16_BAR = 3e-2
#: Config 1's narrow float32 step on the card against the CPU: DistilBERT's
#: pad 0, ln_eps 1e-12 and softmax head at a width the host runs quickly.
CONFIG1_NARROW = dict(n_layers=1, hidden=64, n_heads=4, intermediate=64, vocab_size=512)


def baseline_wrappers():
    """Every counted wrapper of phase 20: B1-B6, threefry and the fleet draws."""
    from svoc_torch.ops.grid_copy import grid_copy_cuda

    return dict(mesh_wrappers(), grid_copy=grid_copy_cuda)


def baseline_run(bc, config: int, **kwargs) -> dict:
    """``baseline_configs.run`` at full width on the card (what ``python -m
    svoc_torch.tools.baseline_configs --config N`` prints), its detail
    checked; the report."""
    report = bc.run(config, seconds=BASELINE_SECONDS, **kwargs)  # device None: CUDA
    detail = report["detail"]
    metric, unit = bc.METRICS[config]
    if config == 4:
        metric = metric.format(n=bc.CONFIG4_ORACLES, f=bc.CONFIG4_ORACLES // 4)
    shape = {1: dict(batch=bc.CONFIG1_COMMENTS, seq_len=bc.CONFIG1_SEQ),
             2: dict(n_oracles=bc.CONFIG2_ORACLES, n_failing=bc.CONFIG2_FAILING, chunk=bc.CONFIG2_CHUNK),
             3: dict(batch=bc.CONFIG3_BATCH, seq_len=bc.CONFIG3_SEQ),
             4: dict(n_oracles=bc.CONFIG4_ORACLES, n_failing=bc.CONFIG4_ORACLES // 4, chunk=bc.CONFIG4_CHUNK)}[config]
    detected = detail.get("mean_failing_detected", 1.0)
    check(report["metric"] == metric and report["unit"] == unit and report["value"] > 0
          and detail["device"].startswith("cuda") and all(detail[k] == v for k, v in shape.items())
          and 0 < detected <= detail.get("n_failing", 1) and "vs_baseline" not in report,
          f"baseline_configs.run({config}) on the card: {report['value']:.1f} {unit}, {shape}, "
          f"{detail['calls']} calls in {detail['elapsed_s']:.3f} s")
    return report


@phase("20a. BASELINE config 1: DistilBERT-SST2, 100 cached comments x 128 tokens, the window's mean")
def config1_phase(torch, launches):
    from svoc_torch.models.configs import DISTILBERT_SST2
    from svoc_torch.models.encoder import init_params
    from svoc_torch.tools import baseline_configs as bc

    card = nvidia_smi()
    wrappers = zero_counts(baseline_wrappers())
    params = init_params(DISTILBERT_SST2, 0, "cuda")
    pipe = bc.config1_pipeline(params=params)  # device None: CUDA
    f32 = bc.config1_pipeline(params=params, cfg=dataclasses.replace(DISTILBERT_SST2, dtype=torch.float32))
    ids, mask = bc.comment_batch(pipe, bc.CONFIG1_COMMENTS)
    vecs, pred = bc.config1_step(pipe, ids, mask)
    ref, _ = bc.config1_step(f32, ids, mask)
    err = max_err(vecs, ref)
    check(bool(torch.isfinite(vecs).all()) and vecs.shape == (100, 2) and err <= CONFIG1_BF16_BAR,
          f"the bf16 forward of 100 comments: finite {tuple(vecs.shape)}, against the same weights in float32 "
          f"on the card max err {err:.3e} <= {CONFIG1_BF16_BAR}")
    row_err = (vecs.sum(1) - 1).abs().max().item()
    mean_err = max_err(pred, vecs.mean(0))
    check(row_err <= 1e-6 and mean_err == 0.0,
          f"every row's two scores sum to 1 (max err {row_err:.2e}); the prediction "
          f"{[round(p, 6) for p in pred.tolist()]} is their mean (err {mean_err:.1e})")

    narrow = dataclasses.replace(DISTILBERT_SST2, dtype=torch.float32, **CONFIG1_NARROW)
    host_params = init_params(narrow, 1, "cpu")
    card_pipe = bc.config1_pipeline(params=host_params, cfg=narrow)
    host_pipe = bc.config1_pipeline(device="cpu", params=host_params, cfg=narrow)
    got = bc.config1_step(card_pipe, *bc.comment_batch(card_pipe, bc.CONFIG1_COMMENTS))[0]
    want = bc.config1_step(host_pipe, *bc.comment_batch(host_pipe, bc.CONFIG1_COMMENTS))[0]
    err = max_err(got.cpu(), want)
    check(err <= 1e-4, f"a narrow float32 DistilBERT-shaped step (pad 0, ln_eps 1e-12, softmax head): card vs "
                       f"CPU max err {err:.3e} <= 1e-4")

    forward_ms = cuda_ms(torch, lambda: pipe.forward(ids, mask), iters=BASELINE_EVENTS, warmup=0)
    report = baseline_run(bc, 1, params=params)
    counts = read_counts(wrappers)
    check(launches_are(counts, {}), f"config 1 launches no kernel (dense attention, no fleet): {counts}")
    add_launches(launches, counts)
    d = report["detail"]
    print(f"  [{card}] config 1: {report['value']:.1f} comments/s on the wall clock ({d['steps']} steps of 100 "
          f"in {d['elapsed_s']:.3f} s, the prediction fetched; a step's latency {d['step_latency_ms']:.3f} ms); "
          f"forward {forward_ms:.3f} ms (CUDA events)")


@phase("20b. BASELINE config 2: 8 Beta(10, 10) oracles (2 failing) in 6 dims, 256 updates a chunk, B3 a chunk")
def config2_phase(torch, launches):
    from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step_batched
    from svoc_torch.ops.fused_consensus import consensus_blocks
    from svoc_torch.sim import prng
    from svoc_torch.sim.generators import generate_beta_oracles
    from svoc_torch.tools import baseline_configs as bc

    card = nvidia_smi()
    ccfg = ConsensusConfig(n_failing=bc.CONFIG2_FAILING, constrained=True)
    key = prng.PRNGKey(0, "cuda")
    draw = lambda keys: generate_beta_oracles(  # noqa: E731
        keys, bc.CONFIG2_ORACLES, bc.CONFIG2_FAILING, bc.CONFIG2_A, bc.CONFIG2_B, dim=bc.CONFIG2_DIM)
    wrappers = zero_counts(baseline_wrappers())
    chunk = bc.config2_chunk(key)
    counts = read_counts(wrappers)
    check(counts["threefry"] > 0 and launches_are(counts, {"gated_claims_consensus": 1,
                                                           "threefry": counts["threefry"]}),
          f"one chunk of 256: B3 once, threefry as drawn, nothing else: {counts}")
    add_launches(launches, counts)
    ok, errs, _ = gated_errors(torch, chunk.out, consensus_step_batched(chunk.values, ccfg))
    check(ok and chunk.values.shape == (256, 8, 6),
          "B3 on the chunk's [256, 8, 6] fleets against consensus_step_batched on the card: "
          + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
    host_keys = prng.fold_in_range(prng.PRNGKey(0, "cpu"), 0, bc.CONFIG2_CHUNK)
    values, honest = draw(host_keys)
    err = max_err(chunk.values.cpu(), values)
    check(torch.equal(prng.fold_in_range(key, 0, bc.CONFIG2_CHUNK).cpu(), host_keys)
          and torch.equal(chunk.honest.cpu(), honest) and err <= 1e-6,
          f"the card's fleets against the host's draws: keys and honest masks exact, Beta values max err "
          f"{err:.2e} <= 1e-6")
    detected = chunk.detected.float().mean().item()
    check(0 < detected <= bc.CONFIG2_FAILING, f"mean failing detected {detected:.3f} of {bc.CONFIG2_FAILING}")

    wrappers = zero_counts(baseline_wrappers())
    keys = prng.fold_in_range(key, 0, bc.CONFIG2_CHUNK)
    draw_ms = cuda_ms(torch, lambda: draw(keys), iters=BASELINE_EVENTS, warmup=0)
    consensus_ms = cuda_ms(torch, lambda: consensus_blocks(chunk.values, ccfg), iters=BASELINE_EVENTS, warmup=0)
    report = baseline_run(bc, 2)
    d = report["detail"]
    counts = read_counts(wrappers)
    b3 = BASELINE_EVENTS + d["calls"]
    check(launches_are(counts, {"gated_claims_consensus": b3, "threefry": counts["threefry"]}),
          f"the timed chunks: B3 once a chunk ({d['calls']} in baseline_configs.run, {BASELINE_EVENTS} timed "
          f"alone), threefry as drawn: {counts}")
    add_launches(launches, counts)
    print(f"  [{card}] config 2: {report['value']:.1f} consensus-updates/s on the wall clock ({d['steps']} updates "
          f"in chunks of 256 in {d['elapsed_s']:.3f} s, each chunk's result fetched; one update's latency "
          f"{d['consensus_update_latency_ms']:.3f} ms); a chunk's fleets {draw_ms:.3f} ms, its consensus (B3) "
          f"{consensus_ms:.3f} ms (CUDA events)")


@phase("20c. BASELINE config 3: RoBERTa go_emotions on 128 x 128, window [50, 2], 64 oracles (8 failing), B2 a step")
def config3_phase(torch, launches, serving_main):
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.ops.fused_consensus import fused_consensus, fused_consensus_plain
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import gen_oracle_predictions
    from svoc_torch.tools import baseline_configs as bc

    card = nvidia_smi()
    if not serving_main:
        check(False, "config 3 reuses phase 4b's weights, and phase 4b returned none")
        return
    ccfg = ConsensusConfig(n_failing=bc.CONFIG3_FAILING, constrained=True)
    # Phase 4b's seed-0 weights (bf16-resident), through the dense unpacked forward.
    weights = serving_main["step"].pipe.model.state_dict()
    pipe = bc.config3_pipeline(params=weights)
    ids, mask = bc.comment_batch(pipe, bc.CONFIG3_BATCH)
    key = prng.PRNGKey(0, "cuda")
    wrappers = zero_counts(baseline_wrappers())
    key = prng.fold_in(key, 0)
    out, honest, window = bc.config3_step(pipe, key, ids, mask)
    one = read_counts(wrappers)
    essences = {tuple(out.essence.tolist())}
    for s in range(1, BASELINE_STEPS):
        key = prng.fold_in(key, s)
        out, honest, window = bc.config3_step(pipe, key, ids, mask)
        essences.add(tuple(out.essence.tolist()))
    counts = read_counts(wrappers)
    per_step = {"fused_consensus": 1, "threefry": one["threefry"], "fleet_draws": 1}
    check(one["threefry"] > 0 and launches_are(one, per_step)
          and launches_are(counts, {k: v * BASELINE_STEPS for k, v in per_step.items()}),
          f"B2 and the fleet draws once a step, threefry {one['threefry']} a step (the key's fold_in), nothing "
          f"else, over {BASELINE_STEPS} steps: {counts}")
    add_launches(launches, counts)
    values, honest_again = gen_oracle_predictions(key, window, bc.CONFIG3_ORACLES, bc.CONFIG3_FAILING,
                                                  subset_size=bc.CONFIG3_SUBSET)
    ok, errs = fused_errors(torch, out, fused_consensus_plain(values, ccfg))
    check(ok and torch.equal(honest, honest_again) and window.shape == (50, 2) and values.shape == (64, 2),
          "B2 at [64, 2] against fused_consensus_plain on the last fleet: mask exact, "
          + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
    check(len(essences) == BASELINE_STEPS and all(map(math.isfinite, sum(essences, ()))),
          f"{len(essences)} distinct finite essences over {BASELINE_STEPS} keys")

    def fleet_and_consensus():
        fleet, _ = gen_oracle_predictions(key, window, bc.CONFIG3_ORACLES, bc.CONFIG3_FAILING,
                                          subset_size=bc.CONFIG3_SUBSET)
        return fused_consensus(fleet.contiguous(), ccfg)

    wrappers = zero_counts(baseline_wrappers())
    forward_ms = cuda_ms(torch, lambda: pipe.forward(ids, mask), iters=BASELINE_EVENTS, warmup=0)
    consensus_ms = cuda_ms(torch, fleet_and_consensus, iters=BASELINE_EVENTS, warmup=0)
    report = baseline_run(bc, 3, params=weights)
    d = report["detail"]
    counts = read_counts(wrappers)
    b2 = BASELINE_EVENTS + d["calls"]
    check(launches_are(counts, {"fused_consensus": b2, "fleet_draws": b2, "threefry": counts["threefry"]}),
          f"the timed steps: B2 and the fleet draws once a step ({d['calls']} in baseline_configs.run, "
          f"{BASELINE_EVENTS} timed alone): {counts}")
    add_launches(launches, counts)
    print(f"  [{card}] config 3: {report['value']:.1f} comments/s on the wall clock ({d['steps']} steps of 128 in "
          f"{d['elapsed_s']:.3f} s, the essence fetched; a step's latency {d['step_latency_ms']:.3f} ms); forward "
          f"{forward_ms:.3f} ms, fleet and consensus (B2) {consensus_ms:.3f} ms (CUDA events)")


@phase("20d. BASELINE config 4: 1024 oracles (256 failing), subsets of 10, 64 updates a chunk, B3 a chunk")
def config4_phase(torch, launches):
    from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step_batched
    from svoc_torch.ops.fused_consensus import consensus_blocks
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import gen_oracle_predictions
    from svoc_torch.tools import baseline_configs as bc

    card = nvidia_smi()
    n, n_failing = bc.CONFIG4_ORACLES, bc.CONFIG4_ORACLES // 4
    ccfg = ConsensusConfig(n_failing=n_failing, constrained=True)
    window = bc.config4_window()  # device None: CUDA
    key = prng.PRNGKey(0, "cuda")
    wrappers = zero_counts(baseline_wrappers())
    chunk = bc.config4_chunk(key, window)
    one = read_counts(wrappers)
    check(one["threefry"] > 0 and launches_are(one, {"gated_claims_consensus": 1, "fleet_draws": 1,
                                                     "threefry": one["threefry"]}),
          f"one chunk of 64: B3 once, the fleet draws once, threefry {one['threefry']} (the chunk's keys), nothing "
          f"else: {one}")
    add_launches(launches, one)
    ok, errs, _ = gated_errors(torch, chunk.out, consensus_step_batched(chunk.values, ccfg))
    check(ok and chunk.values.shape == (64, n, 6),
          f"B3 on the chunk's [64, {n}, 6] fleets against the plain cube (consensus_step_batched) on the card: "
          + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
    detected = chunk.detected.float().mean().item()
    check(0 < detected <= n_failing, f"mean failing detected {detected:.3f} of {n_failing}")

    wrappers = zero_counts(baseline_wrappers())
    keys = prng.fold_in_range(key, 0, bc.CONFIG4_CHUNK)
    draw_ms = cuda_ms(torch, lambda: gen_oracle_predictions(
        keys, window.expand(bc.CONFIG4_CHUNK, *window.shape), n, n_failing, subset_size=bc.CONFIG4_SUBSET),
        iters=BASELINE_EVENTS, warmup=0)
    consensus_ms = cuda_ms(torch, lambda: consensus_blocks(chunk.values, ccfg), iters=BASELINE_EVENTS, warmup=0)
    report = baseline_run(bc, 4)
    d = report["detail"]
    counts = read_counts(wrappers)
    b3 = BASELINE_EVENTS + d["calls"]
    check(launches_are(counts, {"gated_claims_consensus": b3, "fleet_draws": b3, "threefry": counts["threefry"]}),
          f"the timed chunks: B3 and the fleet draws once a chunk ({d['calls']} in baseline_configs.run, the single "
          f"updates of the latency included; {BASELINE_EVENTS} timed alone), threefry as drawn: {counts}")
    add_launches(launches, counts)
    print(f"  [{card}] config 4: {report['value']:.1f} consensus-updates/s on the wall clock ({d['steps']} updates "
          f"in chunks of 64 in {d['elapsed_s']:.3f} s, each chunk's result fetched); a chunk's fleets "
          f"{draw_ms:.3f} ms, its consensus (B3) {consensus_ms:.3f} ms (CUDA events)")
    print(f"  [{card}] config 4: consensus-update latency @1024 oracles {d['consensus_update_latency_ms']:.3f} ms "
          f"(baseline_configs.run: the median of 30 single updates, fleet and B3, each fetched)")


#: Phase 21: each example's output from the JAX package at the reference's documented command
#: (``examples/README.md``: ``beta_kumaraswamy_demo --trials 3000``, ``gaussian_demo --trials 3000``,
#: ``multimodal_demo --trials 300``, ``fleet_demo`` at its defaults, ``serving_demo --steps 20`` on 8
#: virtual CPU devices; seed 0), run with jax 0.9.0 on a CPU and kept as text: the card's machine has no
#: JAX. The fleet demo's clocks read ``#``; the serving demo's rates (clocks) are cut from its lines.
REFERENCE_EXAMPLES = {
    "beta_kumaraswamy_demo": (
        '== 1. single-fleet walkthrough ==\n'
        'fleet (7 oracles, 2 failing, Beta a=b=10):\n'
        '  oracle 0: [0.1043 0.344 ]  FAILING\n'
        '  oracle 1: [0.1311 0.8101]  FAILING\n'
        '  oracle 2: [0.5665 0.5946]  honest \n'
        '  oracle 3: [0.4625 0.2784]  honest \n'
        '  oracle 4: [0.5473 0.4682]  honest \n'
        '  oracle 5: [0.4042 0.4427]  honest \n'
        '  oracle 6: [0.2567 0.367 ]  honest \n'
        '  mode of Beta(10,10) (true essence): 0.5000\n'
        '  restricted median (detected set):  [0.4625 0.4427]\n'
        '  restricted median (honest truth):  [0.4625 0.4427]\n'
        '  on-chain two-pass kernel: essence=[0.3304 0.3555] rel1=0.6419 rel2=0.7526\n'
        '\n'
        '== 2. Beta vs Kumaraswamy honest model ==\n'
        'Beta(10,10):        mode=0.5000  sample mean=0.4995  std=0.1096\n'
        'Kumaraswamy(10,10): mode=0.7868  sample mean=0.7515  std=0.0875\n'
        '\n'
        '== 3. benchmark grid (notebook rule, K=3000, N=7/2 failing) ==\n'
        '---\n'
        'a=10 | b=15.0     | identification success: 42.60 % | reliability : 96.47 %\n'
        'a=10 | b=10.0     | identification success: 39.93 % | reliability : 95.68 %\n'
        '---\n'
        'a=20 | b=15.0     | identification success: 48.27 % | reliability : 97.29 %\n'
        'a=20 | b=20.0     | identification success: 50.73 % | reliability : 97.39 %\n'
        '---\n'
        'a=30 | b=15.0     | identification success: 55.23 % | reliability : 97.77 %\n'
        'a=30 | b=30.0     | identification success: 58.77 % | reliability : 98.10 %\n'
        '---\n'
        'a=100 | b=15.0     | identification success: 78.57 % | reliability : 99.55 %\n'
        'a=100 | b=100.0    | identification success: 75.50 % | reliability : 99.41 %\n'
        '\n'
        '== 3b. same grid through the on-chain two-pass kernel ==\n'
        '---\n'
        'a=10 | b=15.0     | identification success: 43.00 % | reliability : 96.39 %\n'
        'a=10 | b=10.0     | identification success: 38.83 % | reliability : 95.34 %\n'
        '---\n'
        'a=20 | b=15.0     | identification success: 46.90 % | reliability : 97.02 %\n'
        'a=20 | b=20.0     | identification success: 50.57 % | reliability : 97.24 %\n'
        '---\n'
        'a=30 | b=15.0     | identification success: 53.83 % | reliability : 97.53 %\n'
        'a=30 | b=30.0     | identification success: 58.20 % | reliability : 98.09 %\n'
        '---\n'
        'a=100 | b=15.0     | identification success: 77.00 % | reliability : 99.48 %\n'
        'a=100 | b=100.0    | identification success: 74.90 % | reliability : 99.40 %\n'
        '\n'
        '== 4. Cairo test-fixture source for the stage-1 fleet ==\n'
        'array![104290, 343987].span(),\n'
        'array![131067, 810130].span(),\n'
        'array![566489, 594568].span(),\n'
        'array![462485, 278376].span(),\n'
        'array![547262, 468196].span(),\n'
        'array![404182, 442713].span(),\n'
        'array![256661, 367000].span(),\n'
    ),
    "gaussian_demo": (
        '== 1. single-fleet walkthrough (on-chain unconstrained rule) ==\n'
        'fleet (7 oracles, 2 failing, honest ~ N((20.0, 12.0), (3.0, 2.0)^2)):\n'
        '  oracle 0: [12.086  8.88 ]  FAILING\n'
        '  oracle 1: [12.621 18.203]  FAILING\n'
        '  oracle 2: [17.931 10.404]  honest \n'
        '  oracle 3: [19.221 14.86 ]  honest \n'
        '  oracle 4: [17.395 12.42 ]  honest \n'
        '  oracle 5: [18.276 13.6  ]  honest \n'
        '  oracle 6: [18.429  8.51 ]  honest \n'
        '  consensus (mean of detected-honest): [18.2502 11.9586]\n'
        '  reliability first/second pass: 0.5533 / 0.7524   (the Cairo fixture run records 0.533 / 0.647 for its vectors)\n'
        '\n'
        '== 2. Monte-Carlo estimator quality (K=3000) ==\n'
        '  sigma=(1.5, 1.0): identification 83.90 % | reliability 98.55 % | on-chain rel2 82.80 % | estimator error 0.1450\n'
        '  sigma=(3.0, 2.0): identification 50.03 % | reliability 91.66 % | on-chain rel2 68.90 % | estimator error 0.8342\n'
        '  sigma=(6.0, 4.0): identification 9.13 % | reliability 73.72 % | on-chain rel2 49.40 % | estimator error 2.6285\n'
        '\n'
        '== 3. Cairo fixture source for the stage-1 fleet ==\n'
        'array![12085807, 8879751].span(),\n'
        'array![12621345, 18202611].span(),\n'
        'array![17930528, 10403746].span(),\n'
        'array![19221179, 14859745].span(),\n'
        'array![17394960, 12419903].span(),\n'
        'array![18275659, 13599673].span(),\n'
        'array![18428592, 8509973].span(),\n'
    ),
    "multimodal_demo": (
        '== one bimodal fleet (N=64, 4 failing, weights 0.6/0.4) ==\n'
        'true poles:        [[0.20000000298023224, 0.20000000298023224], [0.800000011920929, 0.699999988079071]]\n'
        'EM pole means:     [[0.18800000846385956, 0.20100000500679016], [0.7880000472068787, 0.6980000138282776]]\n'
        'EM pole weights:   [0.6170000433921814, 0.3830000162124634]\n'
        'essence (dominant): [0.18800000846385956, 0.20100000500679016]\n'
        'essence (average):  [0.4180000126361847, 0.3920000195503235]  <- between poles: held by no oracle\n'
        'adversaries caught in mask: 4/4\n'
        '\n'
        '== Monte-Carlo (300 trials/cell): mixture vs unimodal two-pass ==\n'
        '     weights  mix near-pole  uni near-pole  mix dom%  uni dom%  pole recov\n'
        '  0.50/0.50          0.0071         0.0606      53.3      53.7      0.0076\n'
        '  0.60/0.40          0.0069         0.0452      90.7      91.3      0.0090\n'
        '  0.70/0.30          0.0062         0.0224     100.0     100.0      0.0114\n'
        '  0.85/0.15          0.0053         0.0104     100.0     100.0      0.0274\n'
        '\n'
        'Reading: the mixture essence stays ~sigma from a true pole in every regime and\n'
        "recovers BOTH pole centers; the unimodal median's nearest-pole error includes the\n"
        'balanced-tie trials where it lands in the empty gap between the poles.\n'
    ),
    "fleet_demo": (
        '== fleet demo: 1024 oracles, 256 adversarial ==\n'
        'fetch: 30 comments -> 1024 oracle predictions in #s (packed x flash forward + bootstrap fleet + preview ranks)\n'
        'preview flags 205 oracles as suspect (red in the UI)\n'
        'commit: 1024 txs in #s (device-certified batch — sequential-loop semantics, O(1) golden recomputes)\n'
        'on-chain: active=True rel1=0.555 rel2=0.993\n'
        'uniform adversaries (256/1024): per-oracle misflag rate 0.45 %, restricted-median reliability 99.87 %\n'
        'coordinated capture (563/1024, biased): misflag rate 90.04 % — the estimator inverts past N/2 (docs/ALGORITHM.md §5 breakdown curve)\n'
    ),
    "serving_demo": (
        '[serving demo] 8 device(s), tiny shapes, 128-oracle fleet, window 32\n'
        '  dense DP serving\n'
        '  packed serving\n'
        '  packed + pipelined\n'
        '  packed + pipelined + int8\n'
        '[serving demo] pipelined output verified equal to the plain step\n'
    ),
}
#: Phase 21c's runs: (demo, argv, the arguments of its ``printed_bars``, the bars beyond them).
#: :func:`svoc_torch.examples.compare_printed` holds each number a demo prints (none comes from a clock)
#: to the texts above within one unit of its last printed place (the generators agree with JAX's to 3
#: ulp for normals and 1e-6 for Beta fleets, so a printed digit may round the other way on the card),
#: plus the demo's own ``printed_bars``: a number that counts trials may move by one trial's share (an
#: identification success or a dominant-pole share over K trials 100/K percentage points, a misflag
#: rate over K trials of N oracles 100/(K*N)); a reliability, an error or another mean only by its
#: printed unit. The bars beyond them, from the port's plain run on a CPU at the same arguments
#: (``python -m svoc_torch.examples.<name> --device cpu``), which printed the reference's text exactly
#: but for the fleet demo's ``rel2=0.991`` (0.993), its sentiment weights the port's seeded ones: that
#: gap on the fleet demo's on-chain reliabilities; a fixture's felts the wsad units that agreement
#: reaches (Beta: 1e-6 is 1 wsad, +1 for the encoding's rounding; Gaussian: 3 ulp of a float32 below
#: 32 is 5.7e-6, 6 wsad, +2).
EXAMPLE_FELTS = r"array!\[(.*)\]"
EXAMPLE_RUNS = (
    ("beta_kumaraswamy_demo", ["--trials", "3000"], {"trials": 3000}, ((EXAMPLE_FELTS, 2),)),
    ("gaussian_demo", ["--trials", "3000"], {"trials": 3000}, ((EXAMPLE_FELTS, 8),)),
    ("multimodal_demo", ["--trials", "300"], {"trials": 300}, ()),
    ("fleet_demo", [], {"trials": 50, "oracles": 1024}, ((r"rel1=(\S+) rel2=(\S+)", 0.002),)),
)
#: Phase 21c's cells on the card against their plain versions on the CPU: the shares of trials may move
#: by one trial's share, every mean by this (on an H100 the card and the CPU agreed to 6e-7).
TRIAL_COUNTS = {"identification_success_pct", "mixture_dominant_pole_pct", "unimodal_dominant_pole_pct"}
CELL_BAR = 1e-4
#: Phase 21b: the int8 forward against the bf16 packed one at the reference's bars
#: (``tests/test_quant.py``): logits within this × max(1, |ref|), vectors within the second.
INT8_LOGIT_BAR, INT8_VECTOR_BAR = 0.15, 0.05
#: Phase 21c: the kernels each demo's main is expected to launch, the others 0; None: at least once,
#: as drawn. B3 once a grid cell of 3b (8), a noise scale (3), a table row (4) and a fleet_benchmark
#: (2); B1 once a layer of a packed forward (TINY_TEST: 2 layers), threefry as drawn, and the
#: fleet draws once a fetch of the fleet demo's ``Session``.
EXAMPLE_LAUNCHES = {
    "beta_kumaraswamy_demo": {"gated_claims_consensus": 8, "threefry": None},
    "gaussian_demo": {"gated_claims_consensus": 3, "threefry": None},
    "multimodal_demo": {"gated_claims_consensus": 4, "threefry": None},
    "fleet_demo": {"gated_claims_consensus": 2, "flash_attention": None, "threefry": None, "fleet_draws": None},
    "serving_demo": {"threefry": None},
}


def run_main(module, argv) -> str:
    """``module.main(argv)`` on the card with its standard output captured (and returned)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    if rc != 0:
        raise RuntimeError(f"{module.__name__}.main({argv}) returned {rc}")
    return buf.getvalue()


@phase("21a. BASELINE config 7: dense data-parallel serving, 256 x 128 rows a slot, 1024 oracles, on one slot")
def dp_config7_phase(torch, launches):
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.sentiment import SentimentPipeline
    from svoc_torch.parallel.serving import fleet_step_fn
    from svoc_torch.sim import prng
    from svoc_torch.tools import baseline_configs as bc

    card = nvidia_smi()
    s = bc.dp_serving(7)  # device None: CUDA; one slot a card
    (batch, _), = bc.dp_batches(s, SyntheticSource(batch=s.rows, seed=0), 1)
    key = prng.PRNGKey(0, "cuda")
    wrappers = zero_counts(baseline_wrappers())
    out, honest = bc.dp_step(s, key, batch)
    one = read_counts(wrappers)
    check(s.mesh.size == torch.cuda.device_count() and one["threefry"] > 0
          and launches_are(one, {"threefry": one["threefry"]}),
          f"21a one step on {s.mesh.size} slot(s): threefry {one['threefry']} (the fleet's draws), no other kernel "
          f"(dense forward, the psum consensus): {one}")
    add_launches(launches, one)
    # The slot's forward against the unmeshed dense variant's (4c) on the same batch and weights.
    meshed = SentimentPipeline(s.cfg, seq_len=s.seq, batch_size=s.rows, params=s.params, data_mesh=s.mesh)
    dense = SentimentPipeline(s.cfg, seq_len=s.seq, batch_size=s.rows, params=s.params)
    vecs, ref = meshed.forward(*batch), dense.forward(*batch)
    gap = max_err(vecs, ref)
    check(bool(torch.isfinite(vecs).all()) and vecs.shape == (256, 6) and gap <= VARIANT_BAR,
          f"21a the slot's sentiment vectors [256, 6] against the unmeshed dense forward: max gap {gap:.3e} "
          f"<= {VARIANT_BAR}")
    ref_out, ref_honest = fleet_step_fn(s.mesh, s.ccfg, s.n_oracles, subset_size=bc.DP_SUBSET)(
        key, ref[: s.window].float())
    egap = max_err(out.essence, ref_out.essence)
    check(torch.equal(honest, ref_honest) and torch.equal(out.reliable, ref_out.reliable) and egap <= VARIANT_BAR
          and int((~honest).sum()) == s.ccfg.n_failing,
          f"21a the step's consensus against the fleet and consensus of the dense forward's window: honest and "
          f"reliable masks equal, essence gap {egap:.3e} <= {VARIANT_BAR}, {s.ccfg.n_failing} failing of "
          f"{s.n_oracles}")
    step_ms = cuda_ms(torch, lambda: bc.dp_step(s, key, batch), iters=BASELINE_EVENTS, warmup=0)
    wrappers = zero_counts(baseline_wrappers())
    report = bc.run(7, seconds=BASELINE_SECONDS)
    counts = read_counts(wrappers)
    d = report["detail"]
    check(report["metric"] == bc.METRICS[7][0].format(n_dev=s.mesh.size, n=1024, s=1)
          and report["unit"] == "comments/sec" and report["value"] > 0 and d["rows"] == 256 * s.mesh.size
          and d["seq_len"] == 128 and counts["threefry"] > 0 and launches_are(counts, {"threefry": counts["threefry"]}),
          f"21a baseline_configs.run(7) on the card: {report['value']:.1f} comments/s, {d['steps']} steps, "
          f"{d['distinct_essences']} distinct essences, launches {counts}")
    add_launches(launches, counts)
    print(f"  [{card}] config 7: {report['value']:.1f} comments/s on the wall clock ({d['steps']} steps of "
          f"{d['rows']} in {d['elapsed_s']:.3f} s, each essence fetched; a step's latency "
          f"{d['step_latency_ms']:.3f} ms); step {step_ms:.3f} ms (CUDA events); launches {counts}", flush=True)


@phase("21b. BASELINE config 11: INT8 packed data-parallel serving, 8-segment rows, pipelined, on one slot")
def dp_config11_phase(torch, launches):
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.sentiment import SentimentPipeline
    from svoc_torch.sim import prng
    from svoc_torch.tools import baseline_configs as bc

    card = nvidia_smi()
    weights = init_params(bc.ROBERTA_GO_EMOTIONS, 0, "cuda")
    s = bc.dp_serving(11, params=weights)  # device None: CUDA; the fold timed inside
    warm, = bc.dp_batches(s, SyntheticSource(batch=s.rows, seed=1), 1)
    batches = bc.dp_batches(s, SyntheticSource(batch=s.rows, seed=0), 2)
    key = prng.PRNGKey(0, "cuda")
    wrappers = zero_counts(baseline_wrappers())
    prev_window, _, _ = bc.dp_pipelined(s, key, warm[0], bc.zero_window(s))
    prev_key, got, plain = key, [], []
    for step, (batch, _) in enumerate(batches):
        k = prng.fold_in(key, step)
        prev_window, out, honest = bc.dp_pipelined(s, prev_key, batch, prev_window)
        got.append((out, honest))
        plain.append(bc.dp_step(s, k, batch))
        prev_key = k
    got.append(bc.dp_drain(s, prev_key, prev_window))
    counts = read_counts(wrappers)
    check(counts["threefry"] > 0 and launches_are(counts, {"threefry": counts["threefry"]}),
          f"21b the primed loop (3 pipelined steps, 2 plain, the drain): threefry as drawn, no other kernel "
          f"(the int8 forward's products are torch._int_mm, the consensus the psum body): {counts}")
    add_launches(launches, counts)
    same = [all(nan_equal(torch, a, b) for a, b in zip(g[0], p[0])) and torch.equal(g[1], p[1])
            for g, p in zip(got[1:], plain)]
    check(all(same) and len(same) == 2,
          f"21b the pipelined output of batch k equals the plain int8 step's on batch k, exactly, the drain "
          f"closing the last: {same}")
    # The int8 forward against the bf16 packed forward of the same float weights, on one config-11 batch.
    arrays, _ = batches[0]
    valid = arrays[4]
    bf16 = SentimentPipeline(s.cfg, seq_len=s.seq, batch_size=s.rows, packed=True,
                             params={k: v.bfloat16() for k, v in weights.items()})
    q = SentimentPipeline(s.cfg, seq_len=s.seq, batch_size=s.rows, packed=True, quant="int8", params=s.params)
    with torch.inference_mode():
        ref_logits = bf16.packed_model(*arrays[:4])[valid].float()
        int8_logits = q.packed_model(*arrays[:4])[valid].float()
    logit_gap = max_err(int8_logits, ref_logits)
    logit_bar = INT8_LOGIT_BAR * max(1.0, ref_logits.abs().max().item())
    vec_gap = max_err(q.packed_forward(*arrays[:4])[valid], bf16.packed_forward(*arrays[:4])[valid])
    check(bool(torch.isfinite(int8_logits).all()) and logit_gap < logit_bar and vec_gap < INT8_VECTOR_BAR,
          f"21b the int8 forward against the bf16 packed one on {int(valid.sum())} segments: logits within "
          f"{logit_gap:.4f} (bar {logit_bar:.4f}), vectors within {vec_gap:.5f} (bar {INT8_VECTOR_BAR})")
    del bf16, q
    step_ms = cuda_ms(torch, lambda: bc.dp_step(s, key, batches[0][0]), iters=BASELINE_EVENTS, warmup=0)
    wrappers = zero_counts(baseline_wrappers())
    report = bc.run(11, seconds=BASELINE_SECONDS, params=weights)
    counts = read_counts(wrappers)
    d = report["detail"]
    check(report["metric"] == bc.METRICS[11][0].format(n_dev=s.mesh.size, n=1024, s=8)
          and report["unit"] == "comments/sec" and report["value"] > 0 and d["rows"] == 256 * s.mesh.size
          and d["max_segments"] == 8 and counts["threefry"] > 0
          and launches_are(counts, {"threefry": counts["threefry"]}),
          f"21b baseline_configs.run(11) on the card: {report['value']:.1f} comments/s, {d['steps']} steps, "
          f"packing factor {d['packing_factor']:.3f}, launches {counts}")
    add_launches(launches, counts)
    print(f"  [{card}] config 11: {report['value']:.1f} comments/s on the wall clock ({d['steps']} pipelined steps "
          f"of {d['rows']} rows, {d['packing_factor']:.3f} comments a row, in {d['elapsed_s']:.3f} s, each essence "
          f"fetched; the plain step's latency {d['step_latency_ms']:.3f} ms); plain step {step_ms:.3f} ms (CUDA "
          f"events); the fold {s.fold_s:.3f} s here, {d['fold_s']:.3f} s in run(); launches {counts}", flush=True)


@phase("21c. the examples at the reference's documented commands: beta, gaussian, multimodal, fleet, serving")
def examples_phase(torch, launches):
    import contextlib
    import importlib
    import io

    import numpy as np

    from svoc_torch.examples import compare_printed, without_clocks
    from svoc_torch.sim import montecarlo, multimodal, prng

    card = nvidia_smi()
    counted = baseline_wrappers()
    demos = {name: importlib.import_module(f"svoc_torch.examples.{name}") for name in EXAMPLE_LAUNCHES}
    for name, argv, bar_args, extra_bars in EXAMPLE_RUNS:
        wrappers = zero_counts(counted)
        before = commit_routes()
        t0 = time.perf_counter()
        text = run_main(demos[name], argv)
        secs = time.perf_counter() - t0
        counts = read_counts(wrappers)
        add_launches(launches, counts)
        bars = extra_bars + demos[name].printed_bars(**bar_args)
        ok, gaps = compare_printed(without_clocks(text), REFERENCE_EXAMPLES[name], bars)
        command = " ".join([name] + argv) if argv else f"{name} at its defaults"
        check(ok, f"21c {command}: every printed number within its printed unit and its bar of the JAX "
                  f"package's (bars {bars}; non-zero gaps by line: {gaps})")
        expected = EXAMPLE_LAUNCHES[name]
        check(all(counts[k] > 0 if expected.get(k, 0) is None else counts[k] == expected.get(k, 0) for k in counts),
              f"21c {name}: launches {counts}, expected {expected} (None: as drawn), the others 0")
        if name == "fleet_demo":
            routes = diff(commit_routes(), before)
            check(routes == {"chain_commit_rpcs{mode=batch}": 1} and "1024 txs" in text and "active=True" in text,
                  f"21c fleet_demo: its commit took the batched certified route, one RPC for 1024 txs ({routes})")
        print(f"  [{card}] 21c {command}: {secs:.2f} s; launches {counts}", flush=True)
        print("    " + "\n    ".join(text.strip("\n").splitlines()[-4:]), flush=True)

    # The serving ladder: 8 slots of the card at the tiny shapes (the reference's 8 devices), then the
    # full width on one slot. Its numbers are clocks; its lines and its lossless check are held.
    for argv, header in ((["--steps", "20", "--slots", "8"], REFERENCE_EXAMPLES["serving_demo"].splitlines()[0]),
                         (["--steps", "20", "--full"],
                          "[serving demo] 1 device(s), flagship shapes, 1024-oracle fleet, window 50")):
        wrappers = zero_counts(counted)
        t0 = time.perf_counter()
        text = run_main(demos["serving_demo"], argv)
        secs = time.perf_counter() - t0
        counts = read_counts(wrappers)
        add_launches(launches, counts)
        lines = text.strip("\n").splitlines()
        want = "\n".join([header] + REFERENCE_EXAMPLES["serving_demo"].splitlines()[1:])
        check(without_clocks(text).strip("\n") == want,
              f"21c serving_demo {' '.join(argv)}: the header {lines[0]!r}, the four rungs, and the pipelined "
              f"output verified equal to the plain step")
        check(counts["threefry"] > 0 and launches_are(counts, {"threefry": counts["threefry"]}),
              f"21c serving_demo {' '.join(argv)}: threefry as drawn, no other kernel (dense attention, the psum "
              f"consensus, torch._int_mm): {counts}")
        print(f"  [{card}] 21c serving_demo {' '.join(argv)}: {secs:.2f} s; launches {counts}", flush=True)
        print("    " + "\n    ".join(lines), flush=True)

    # One stage of each demo that reaches B1 or B3, on the card and as its plain version on the CPU.
    def both(fn):
        return [fn(prng.PRNGKey(0, dev)) for dev in ("cuda", "cpu")]

    def bar_ok(a: dict, b: dict, trials: int) -> bool:
        return all(abs(a[k] - b[k]) <= (100.0 / trials if k in TRIAL_COUNTS else CELL_BAR) for k in a)

    cells = {
        "beta 3b, a=10 b=10": (both(lambda k: montecarlo.benchmark(
            prng.fold_in(prng.split(k, 3)[2], 2), 10.0, 10.0, 7, 2, k_trials=3000, use_kernel=True)), 3000),
        "gaussian 2, sigma (3, 2)": (both(lambda k: montecarlo.benchmark_unconstrained(
            prng.fold_in(prng.split(k, 2)[1], 10), (20.0, 12.0), (3.0, 2.0), 7, 2, k_trials=3000, max_spread=10.0,
            use_kernel=True)), 3000),
        "multimodal 0.50/0.50": (both(lambda k: multimodal.benchmark_multimodal(
            prng.fold_in(k, 50), np.array([[0.2, 0.2], [0.8, 0.7]], np.float32), 0.03, weights=[0.5, 0.5],
            n_oracles=64, n_failing=4, k_trials=300)), 300),
    }
    for what, ((card_cell, cpu_cell), trials) in cells.items():
        check(bar_ok(card_cell, cpu_cell, trials),
              f"21c {what}: the card's cell (B3) against its plain version on the CPU, the shares of trials "
              f"({sorted(TRIAL_COUNTS & set(card_cell))}) within one trial's share (100/{trials}), the means within "
              f"{CELL_BAR}: card {card_cell}, CPU {cpu_cell}")
    fleet = demos["fleet_demo"]
    with contextlib.redirect_stdout(io.StringIO()):
        runs = [fleet.run(1024, 256, 1, device=dev) for dev in ("cuda", "cpu")]
    (card_run, cpu_run) = runs
    gap = float(np.abs(card_run["preview"]["values"] - cpu_run["preview"]["values"]).max())
    check(np.array_equal(card_run["preview"]["honest"], cpu_run["preview"]["honest"]) and gap <= 1e-4
          and card_run["n_tx"] == cpu_run["n_tx"] == 1024,
          f"21c fleet_demo's fetch (B1, the packed flash forward) against its plain version on the CPU: the fleet's "
          f"honest mask equal, values within {gap:.2e} (bar 1e-4), 1024 txs each")
    # Its fleet_benchmark (B3) at one trial: a misflag count of 1024 oracle-trials, a reliability a mean.
    for stage in ("uniform", "capture"):
        a, b = card_run[stage], cpu_run[stage]
        check(abs(a["mean_misclassified"] - b["mean_misclassified"]) <= 1
              and all(abs(a[k] - b[k]) <= CELL_BAR for k in ("reliability_pct", "mean_onchain_reliability2_pct")),
              f"21c fleet_demo's {stage} fleet_benchmark (B3) against its plain version on the CPU, one trial: "
              f"misflagged oracles within one, reliabilities within {CELL_BAR}: card {a}, CPU {b}")


def main() -> int:
    t_script = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    global PARENT
    child = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        PARENT = str(Path(sys.argv[2]).resolve())
    elif sys.argv[1:2] == ["--durable-child"] and len(sys.argv) == 4:
        child = sys.argv[2:4]
    elif sys.argv[1:2] == ["--coldstart-child"] and len(sys.argv) == 5:
        child = sys.argv[2:5]
    elif len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import svoc_torch  # noqa: F401
    except ImportError:
        print("FAIL: the svoc_torch package is not beside chip_smoke.py", file=sys.stderr)
        return 2
    if child is not None:  # one process of phase 11c or 12b, started by the phase itself
        if len(child) == 3:
            coldstart_width_run(torch, *child)
        else:
            durable_width_run(torch, *child)
        return 0

    results, launches = {}, {}
    if environment(torch):
        grid_copy_phase(torch, results)
        flash_phase(torch, results)
        flash_bwd_phase(torch, results)
        flash_dense_phase(torch)
        consensus_phase(torch, results)
        gated_claims_phase(torch, results)
        threefry_phase(torch, results)
        small_step_phase(torch)
        serving_main = main_path_phase(torch, launches)
        variants_phase(torch, launches)
        pipelined_phase(torch, launches, serving_main)
        serving = dict(launches)
        small_train_phase(torch)
        train_path_phase(torch, launches)
        finetune_phase(torch, launches)
        trained = dict(launches)
        claims_path_phase(torch, launches)
        claimed = dict(launches)
        probe_phase(torch, launches)
        probed = dict(launches)
        commit_path_phase(torch, launches)
        committed = dict(launches)
        fabric_scenario_phase(torch, launches)
        fabric = fabric_width_phase(torch, launches)
        session_loop_phase(torch, launches)
        staging_phase(torch, launches, fabric)
        hotpath_phase(torch, launches)
        fabricked = dict(launches)
        serving_scenario_phase(torch, launches)
        tier = serving_width_phase(torch, launches, fabric)
        tiered = dict(launches)
        chaos_phase(torch)
        crash_matrix_phase(torch, launches)
        durable_width_phase(torch, launches, tier)
        durable = dict(launches)
        coldstart_smoke_phase(torch)
        uninterrupted = coldstart_width_phase(torch, launches, serving_main)
        profiler_phase(torch, launches, uninterrupted, serving_main)
        started = dict(launches)
        cluster_smoke_phase(torch, launches)
        fleet_obs_smoke_phase(torch, launches)
        fleet = fleet_width_phase(torch, launches)
        replicas_phase(torch, launches, fleet)
        clustered = dict(launches)
        reconfig_smoke_phase(torch, launches)
        chaos_fuzz_phase(torch)
        reconfig_width_phase(torch, launches, fleet)
        reconfigured = dict(launches)
        obs_gates_phase(torch, launches)
        robustness_cert_phase(torch, launches)
        sweeps_phase(torch, launches)
        swept = dict(launches)
        console_phase(torch, launches, fabric)
        consoled = dict(launches)
        t_mesh = time.perf_counter()
        shard_smoke_phase(torch, launches)
        mesh_dispatch_phase(torch, launches)
        mesh_fleet_phase(torch, launches)
        mesh_serving_phase(torch, launches)
        print(f"  (phase 17 in all: {time.perf_counter() - t_mesh:.1f} s)", flush=True)
        meshed = dict(launches)
        t_paths = time.perf_counter()
        ring_phase(torch, launches)
        sp_forward_phase(torch, launches)
        sp_train_phase(torch, launches)
        pipeline_phase(torch, launches)
        tp_train_phase(torch, launches)
        finetune_mesh_phase(torch, launches)
        print(f"  (phase 18 in all: {time.perf_counter() - t_paths:.1f} s)", flush=True)
        lint_phase(torch)
        linted = dict(launches)
        t_configs = time.perf_counter()
        config1_phase(torch, launches)
        config2_phase(torch, launches)
        config3_phase(torch, launches, serving_main)
        config4_phase(torch, launches)
        print(f"  (phase 20 in all: {time.perf_counter() - t_configs:.1f} s)", flush=True)
        configured = dict(launches)
        t_examples = time.perf_counter()
        dp_config7_phase(torch, launches)
        dp_config11_phase(torch, launches)
        examples_phase(torch, launches)
        print(f"  [{nvidia_smi()}] 21d: phase 21 in all: {time.perf_counter() - t_examples:.1f} s", flush=True)
        print(f"  launches: serving paths {serving}; with the train paths {trained}; "
              f"with the multi-claim path {claimed}; with the probe path {probed}; "
              f"with the commit path {committed}; with the fabric paths {fabricked}; "
              f"with the serving tier {tiered}; with the durable paths {durable}; "
              f"with the cold-start paths {started}; with the cluster paths {clustered}; "
              f"with the reconfiguration paths {reconfigured}; with the obs gates, the certificate and the "
              f"sweeps {swept}; with the console {consoled}; with the mesh {meshed}; with the training and "
              f"sequence paths on the mesh {linted}; with BASELINE configs 1-4 {configured}; with configs 7 and 11 "
              f"and the examples {launches}")
    from svoc_torch.durability import forked

    forked.stop()  # 11b's and 14b's children came from it; it would outlive this process for a moment
    check(all(launches.get(name, 0) > 0 for name in KERNEL_ROWS),
          f"every kernel launched on its path: { {k: launches.get(k, 0) for k in KERNEL_ROWS} }")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "svoc_tpu"))
    check(not leaked, f"no JAX or svoc_tpu module loaded ({leaked})")

    if len(results) == len(KERNEL_ROWS):
        print(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches.get(name, 0), **results[name])
            for name, (source, replaces) in KERNEL_ROWS.items()
        ]}))
    if failures:
        print(f"FAILED: {len(failures)} check(s): {failures}", file=sys.stderr)
        return 1
    print(f"  (the whole script: {time.perf_counter() - t_script:.1f} s)", flush=True)
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
