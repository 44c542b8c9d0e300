#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: serving, speculative
decode, prefix reuse, the host KV tier, training, checkpoint and resume,
training that serves over HTTP with weight hot swap, the command line,
the outer plane on the card (overlapped and streaming rounds, error
feedback), sharding, a galaxy of two workers over TCP, NoLoCo gossip
rounds, the serving fleet, routed experts, ring attention, tensor and
pipeline parallelism, the obs plane armed on serving, training, the TCP
galaxy, gossip and the fleet, the remat policies, the normative DiLoCo
driver, the input prefetcher and the decode-kernel choice, and
``precision="fp16-mixed"`` through every kernel.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one NVIDIA H100
(``sm_90a``), the CUDA toolkit under ``/usr/local/cuda`` and PyTorch built
for CUDA. It needs no network and no JAX. Where ``torch.cuda.is_available()``
is false, or the ``opendiloco_torch`` package is not beside it, it exits
non-zero and prints no result. Every phase runs unguarded: any failure
exits non-zero.

1. Card line: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, and the seconds the nvcc build of the ten kernel sources
   took (one nvcc per source, started together). TF32 is off for matmuls
   and cuDNN, so every f32 product is full f32.
2. B6, paged decode attention, against its plain version at the
   config_1b decode shape (S 8, T 1024, Kh 4, rep 8, D 64) with ragged
   ``lens`` that include an empty slot and a wrapped ring, in f32 and
   bf16, on B7's split kernel at the splits the wrapper picks (8) and at
   one split, each repeated bit for bit; its merge kernel against the
   plain merge on the split kernel's partials; its first design, which
   takes head dims above 128, at D 256. Device times of the kernel at its
   splits and at one split in turns (the splits must take at most half of
   one split's time), the merge alone, the plain version, one
   ``scaled_dot_product_attention`` call over the masked dense ring, and
   the bounds; the host's microseconds per wrapper call at both grids.
3. B8, the W4 dequant-matmul, against its plain version at every distinct
   config_1b weight shape, M 8 (decode), 40 (the spec verify) and 1024
   (prefill): bf16 on the sm90 kernel (tensor cores, K split across
   blocks; the route bf16 takes, repeated for its bits) and on the first
   design (through route=), f32 on the first design, plus the identity
   probe (f32) bit for bit; device times in bf16 of both routes in turns
   (sm90, first, first, sm90), the plain version, and the bounds; at M 8
   and 40 the sm90 kernel's C entry also at 1-128 splits (the sweep that
   set ``W4_MAX_SPLITS``).
4. Serving with fp32 weights: ``build_serving`` at config_1b width, random
   weights from ``torch.Generator("cuda").manual_seed(0)``, 16 requests
   over the three prefill buckets, 48 new tokens each. The launch counters
   are zeroed just before and read just after: B6 must have run 22 times
   per decode step, and its merge 22 times (PAGED_MERGES_PER_STEP).
   Then one ``decode_forward`` step's logits, kernel path
   against plain path, in f32 and bf16.
5. The same with ``weight_format="w4"``: the sm90 B8 must have run 7 x 22
   times per prefill and per decode step, the first design never.
6. A small-input reference: config_2m through ``ServeEngine`` on the card
   (kernels) against the same engine on the CPU (plain versions).
7. B1, B2a and B2b (flash attention forward, dq, dk/dv) and the
   backward's delta kernel against their plain versions at the shapes
   phases 8 and 10 launch (mb 8, T 1024: 16 x 64 heads at 150m, 32 over
   4 heads x 64 at config_1b), an odd T (1000), full attention, D 32 and
   128 at T 200, T 64 with rep 8, and D 40, in f32 and bf16. Forward and
   backward take the sm90 kernels (wgmma, TMA) for bf16 at D 32/64/128
   and the first design's otherwise; the first design is also checked in
   bf16 at the 150m shape. Device times in bf16 at the 1b head geometry
   and the 150m shape of both routes of B1 and of the backward, the delta
   kernel, the plain versions, SDPA forward (B1's library yardstick),
   SDPA's backward through autograd (B2a's and B2b's: one call computes
   dq, dk and dv, its preprocess included; forward + backward less
   forward; GQA through ``enable_gqa``), against which B2a + B2b + delta
   stand like for like; the first design's f32 backward at 150m; the
   bounds; the host's microseconds per wrapper call.
8. Training: two DiLoCo workers, one thread each, run ``train()`` at
   config_150m full width and depth (mb 8, accum 2, seq 1024, bf16,
   remat, fake "ramp" data, 8 steps, local_steps 4: 2 outer rounds). The
   launch counters are zeroed just before and read just after: the sm90
   B1 must have run 2 x 12 x accum times per inner step and worker, the
   sm90 B2a and B2b and the delta kernel 12 x accum, the first design
   and the fused cross-entropy kernels never (150m resolves
   ``fused_loss=False``). Every loss finite, the last below the first,
   both masters bit-identical after each round. Then one inner step,
   kernel path against plain path, and one worker's inner-step time alone
   on each path, the two paths in turns (a b b a, 3 steps a turn). Then
   one inner step in f32 (``precision="fp32"``) with the fused loss
   on, which takes the first design's B1 (2 x 12 x accum), B2a and B2b
   (12 x accum each), the delta kernel (12 x accum), B3 (accum) and the
   first design's dlog, B4a and B4b (accum x 4 each), the sm90 kernels
   never, against the same step through plain attention and the
   materialized loss. The run checkpoints every 4 steps (``ckpt.interval``
   4, a temporary ``ckpt.path``).
8b. Resume: two fresh workers on a fresh loopback world run ``train()``
   with ``ckpt.resume`` at phase 8's ``model_step_4``: steps 5-8 through
   the same kernels. Each step's loss and LR must equal phase 8's bit for
   bit, each worker's final master hash phase 8's, and the launch counts
   (zeroed just before, read just after) half of phase 8's. Each worker's
   seconds to save and to load and its bytes on disk; then the
   checkpoints are removed.
9. B3, the dlog kernel, B4a and B4b (fused lm-head + cross-entropy)
   against their plain versions at the 1b training shape (N 8184, D 2048,
   V 32000; dlog, dh and dw at its first 2048-row chunk), its ragged last
   chunk (N 2040), the 150m width (D 1024) and an odd N and V (1000),
   about a seventh of the labels -100, in f32 and bf16; in bf16 the sm90
   B3, dlog, dh and dw (wgmma, TMA; the route bf16 takes, each repeated
   for its bits; dw also added to a prior dw) and the first design's all
   four. Device times of kernel, plain version and the library pair
   (cuBLAS ``h @ w`` then ``F.cross_entropy``, and its backward through
   autograd), cuBLAS ``dlog @ w.T`` beside dh and ``h.T @ dlog`` plus the
   f32 add beside dw; B3, dlog, dh and dw on both routes in turns; the
   bounds.
10. Training at config_1b's full width and 17 of its 22 layers (the
   smoke's time limit; more than 16, so the stack stays looped), as phase
   8 (4 steps,
   local_steps 2: 2 outer rounds), with ``fused_loss`` left at its
   default, which resolves on. Per inner step and worker the sm90 B1 must
   have run 2 x L x accum times, the sm90 B2a and B2b and the delta
   kernel L x accum (L = 17), the sm90 B3 accum, and the sm90 dlog, B4a and B4b
   accum x 4 (a backward walks 8184 rows in chunks of 2048), the first
   design's B3, dlog, B4a and B4b never. Then one inner step with the
   fused loss against one with ``fused_loss=False`` on the same params
   and batch, and the inner-step times of the two, in turns as in phase
   8. Then the two-worker training once more with
   ``outer_placement="device"`` (the master and momentum on the card):
   launch counts, each step's loss and LR, and the master hashes at each
   round and at the end equal the host run's bit for bit; the outer
   step's split (wait, D2H, pseudo-gradient, all-reduce, Nesterov, H2D)
   for both placements side by side, and the peak device memory of the
   two workers under each.
11. B7, the speculative tail attention, against its plain version in f32
   and bf16 at the shapes of its three passes at config_1b: verify (S 8,
   Kq = Kt = 5), draft (Kq 1, Kt 4, q_start 0..3) and the continued
   prefill of prefix reuse (S 1, Kq = Kt = 64, 256 and 1000 behind a
   192-row prefix), with lens that include 0, 5, T - 2, T and 2T + 1, at
   the ring splits the wrapper picks (8 at verify, draft and suffix 64, 1
   at suffix 256 and 1000), then split edges: splits left empty (lens
   0, 5), evicted (lens >= T at q_start 3) or cut inside the live ring
   (T - 2; 3 and 16 splits), each output repeated bit for bit; the merge kernel against
   its plain version on the split kernel's partials (verify, draft and
   suffix 64). Device times of kernel at its splits and at one split in
   turns (at verify and draft the splits must take at most half of one
   split's time), the merge alone, plain version and one SDPA call over
   concat(ring, tail) with the same boolean mask, and the bounds.
   (Phases 11-13 run after phase 5, on its weights; phase 14 after
   phase 6.)
12. Speculative serving, fp32 and w4 weights: ``build_serving`` with
   ``spec_decode_k`` 4 (draft 11 of 22 layers) drives phase 4's 16
   requests. Per round B7 must have run 4 x 11 + 22 = 66 times, its merge
   kernel as often (SPEC_MERGES_PER_ROUND: 8 slots give 8 ring splits at
   both shapes), and B6
   never; under w4 the sm90 B8 7 x 66 times a round and 7 x 22 a prefill. Tokens/s,
   TTFT, ms per round, acceptance, tokens per round and the draft, verify
   and insert seconds beside phases 4/5's, the token agreement with them
   (reported, not asserted: the bf16 verify pass multiplies at another M),
   and ``ServeEngine.kernel_probe``. Under fp32 weights, verify_forward's
   logits for a 5-token tail against the plain path and against
   decode_forward stepped one token at a time, f32 (1e-3) and bf16 (0.25).
13. Prefix serving: ``spec_decode_k`` 4 with ``prefix_cache`` on, then
   off, on 16 prompts of one 192-token system prompt and 8-200 distinct
   tokens, all submitted at once: at least 7 prefix hits, B7 22 times per
   hit and 66 per round, its merge 66 per round and 22 per hit whose
   suffix pads to the 64 bucket (SUFFIX_MERGES: its 8 query tiles leave
   the card short, 8 splits; the 256 and 1024 buckets take one split, no
   merge), the hits' suffix lengths recorded as the batcher admits them;
   TTFT p50 on against off. A prefix-reused admit's logits against a cold
   admit's at config_1b in f32 (1e-3).
14. config_2m in f32 through ``ServeEngine`` with ``spec_k`` 3, past its
   32-row ring: the token stream on the card equals the plain decode
   loop's on the card and the spec engine's on the CPU.
15. Phase 12's plain and spec loops at config_1b in f32 compute on 4 of
   its 16 requests (after phase 13): the spec streams must equal the
   plain loop's token for token. The launch counters are zeroed before
   each loop: the plain loop's B6 (f32, the split kernel) and its merge
   22 times per decode step, the spec loop's B7 66 and its merge 66 per
   round.
16. A weights directory at config_150m: ``save_params`` of params drawn
   on the card, then ``get_model(dir)``: every leaf equal bit for bit.
17. The 25-step drive (ROADMAP.md A9 gate 3): config_2m,
   ``DiLoCoOptimizer`` with ``local_steps`` 10 over ``LoopbackWorld(1)``,
   ramp data, batch 32 x 256, accum 2: the loss from about ln(1024) to
   below 6.2, an outer step after steps 10 and 20.
18. The command line: ``python -m opendiloco_torch.train`` at config_2m in
   a subprocess on the default device, 20 steps with a checkpoint at 10,
   then again resuming from ``model_step_10``: steps 11-20 equal bit for
   bit.
19. Training that serves (after phase 8b): phase 8's run with
   ``serve.enabled`` on worker 0 (w4 weights, ``max_stale_rounds`` 0,
   a swap check every 4 decode steps, ``ODTP_STATE_CODEC=blockwise4bit``
   so that each swap re-slices the snapshot into B8's packed layout), no
   checkpoints, three client threads posting /generate over HTTP (64 and
   256 buckets, 32 new tokens) and a poller on /healthz and /stats until
   ``train()`` returns. Every response succeeds or fails with "server
   stopped"; they carry at least two weight epochs; the engine swapped;
   the launch counters (zeroed just before, read just after) hold phase
   8's training kernels, B6 12 a decode step (its merge by the split
   rule: none at 150m, whose 8 slots x 16 kv heads fill the card) and B8
   84 a prefill and a decode step; both workers' losses, LRs and master
   hashes equal phase 8's bit for bit. Each swap's ms by part (encode,
   decode, H2D, pack), TTFT p50 and max, tokens/s while training, and the
   inner-step and outer-step times beside phase 8's.
20. ``install_wire`` at config_1b (after phase 15, on phase 4's
   params): (a) a w4 engine given a blockwise4bit snapshot (the fast
   path) keeps its own packing bit for bit, and phase 5's 16 requests
   give the streams the same engine gives after ``install_params`` of
   what the snapshot carries (the codec's decode of every dense leaf);
   (b) the w4 engine given an fp16 snapshot (packed on the card) and (c)
   an fp32 engine given it give the streams and weights of
   ``install_params`` of the fp16-rounded params. Host encode s, install
   s by part and the card's peak memory across each swap; launches as in
   phases 4 and 5.
21. The outer plane on the card, host against device placement: phase
   8's config_150m at 2 of its 12 layers (the smoke's time limit) (two
   workers, mb 8, accum 2, seq 1024, 4 steps,
   ``local_steps`` 2: two rounds, the second with the momentum armed)
   through ``InnerTrainer`` and ``DiLoCoOptimizer``, in four cases:
   blocking; ``overlap_comm`` "eager"; "delayed" (each round drained
   before the next step, so both placements land it at the same step);
   ``streaming_fragments`` 3 x eager with ``error_feedback`` over the
   ``uniform8bit`` loopback codec (rounds landed after each step). In
   each case the device run equals the host run bit for bit: every
   loss and LR, each worker's final master, momentum and residual hashes,
   its serving snapshot (``master_snapshot_wire``, fp16: cast on the card
   against numpy's cast) byte for byte, and the launch counts (zeroed
   just before, read just after); the residuals are non-zero.
22. The host KV tier at config_1b (after phase 20, on phase 4's params):
   bf16, w4 weights, 4 decode slots, 12 of phase 4's prompts at once, 48
   tokens each, (a) tier off, (b) ``kv_tier`` on with codec none and 16
   host slots: evictions, as many resumes, nothing paused at the end,
   every stream equal to (a)'s; (c) codec blockwise4bit: every request
   completes (agreement with (a) recorded); launches as phase 5's per
   decode step and prefill in all three. A page's page-out and page-in
   ms at 256 and 1024 rows (a restore equal to its source bit for bit),
   each codec's encode and decode s and stored bytes for a full page;
   TTFT and tokens/s of (b) against (a). (d) The host prefix store: one
   of phase 13's prompts, then after it retired another that shares its
   128-row prefix: one host hit, B7 22 times for its suffix pass (its
   merge by SUFFIX_MERGES), the installed rows bit for bit a cold
   prefill's, and in f32 the host-prefix admit's logits against a cold
   admit's (1e-3).
23. Sharded 150m (after phase 21): a one-worker loopback galaxy runs
   ``train()`` at config_150m's widths and 2 of its 12 layers (the
   smoke's time limit) (mb 8, accum 2, seq
   1024, bf16, remat, ``attn_implementation="pallas"``,
   ``fused_loss=True``, 8 steps, ``local_steps`` 4, ``outer_placement``
   "device") without a process group, then in a world-1 NCCL group (a ``file://`` store in a
   temporary folder, destroyed at the end) under each of NO_SHARD,
   SHARD_GRAD_OP, FULL_SHARD, HYBRID_SHARD and HYBRID_SHARD_ZERO2: the
   per-layer gathers, the reduce-scatters of their backward and the
   once-a-step gradient collectives run (each an identity at one rank),
   and each strategy's losses, LRs and master hashes (at each round and
   at the end) equal the run without a group bit for bit. Launches per
   kernel (zeroed before each run, read after): the sm90 B1 2 x 12 x
   accum a step, B2a, B2b and the delta kernel 12 x accum, the sm90 B3
   accum, its dlog, B4a and B4b accum x 4. Per strategy the median step
   ms after the first step and the peak device memory. Then phase 18's
   command line (2m, no DiLoCo) under ``python -m torch.distributed.run
   --standalone --nproc-per-node 1 -m opendiloco_torch.train
   --sharding-strategy FULL_SHARD``, bf16, attention through the kernels, 8 steps
   with a checkpoint at step 4, then resuming from it: steps 5-8 equal
   bit for bit.
24. The TCP galaxy (after phase 10): phase 10's two config_1b workers
   (4 steps, ``local_steps`` 2, codec none) with ``diloco.backend="tcp"``,
   no backend handed in and the outer plane on the card (host RAM: two
   host-placed TCP workers of one process need about 2 x 30 GB): each
   ``train()`` makes a ``TcpBackend`` that
   meets the other at the port's ``RendezvousServer`` on localhost
   (``ODTP_EXPECT_PEERS`` 2) and averages over real sockets, the bulk
   plane carrying the 2.2 GB parts. Launches, each step's loss and LR and
   the master hashes at each round and at the end equal phase 10's bit
   for bit (two workers: a + b then x 0.5 is exact in any order); on a
   miss the largest difference of the final master is printed. Then one
   150m round (4 steps, ``local_steps`` 4) on the ``uniform8bit`` codec
   through the port's host library (``csrc/odtp_host.cpp``, built with
   g++ here): both masters equal. Each round's stage times from the round
   ledger (matchmaking, flatten, scatter-reduce, gather, encode,
   accumulate, wire send and receive), the outer step's split and the
   phase's peak host RSS.
25. Gossip (after phase 23): three loopback workers at config_150m's
   widths and 2 of its 12 layers (phase 8's run: mb 8, accum 2, seq 1024;
   4 steps, ``local_steps`` 2) with
   ``outer_mode="gossip"``, blockwise4bit and error feedback, host then
   device placement: launches phase 8's kernels' for 12 inner steps, one
   self-round a round (an odd galaxy), and the device run's losses, LRs
   and final master hashes the host run's bit for bit. Then one pair
   round on fragment 0 (of 4) of two workers' final master, momentum
   and a pseudo-gradient, lockstep on loopback, async at distance 0, and over
   two ``TcpBackend``s at the port's rendezvous: the three equal bit for
   bit. Each round's exchange seconds and wire bytes, the self-round
   share, the inner step beside phase 8's.
26. The serving fleet: one training worker at the same cut of
   config_150m (4 steps, ``local_steps`` 2) with ``fleet.enabled`` (two replicas, keyframe
   every 2 epochs, prefix cache on), first with the replicas in process,
   then as ``python -m opendiloco_torch.fleet.replica`` processes on the
   card. At the fleet's teardown (the training done, both replicas on
   the last epoch's keyframe) each replica's two shared-prefix streams
   (the second a prefix hit) equal a ``ServeEngine``'s on the keyframed
   masters; in process B6 runs once a layer a decode step and B7 once a
   layer a hit.
   16 requests through the router's HTTP from 4 clients; with processes
   one replica is SIGKILLed under them and every request answers. Time
   to the first ready replica, keyframe and delta push bytes, TTFT and
   tokens/s through the router, redispatches.
27. Routed experts: two loopback workers run ``train()`` at
   config_150m_8e's full width and 6 of its 12 layers (``MOE_LAYERS``:
   the smoke's time limit; 8 experts of ffn 2688; mb 8,
   accum 2, seq 1024, bf16, remat, 3 steps, one outer round on the device
   plane) with attention and loss left to resolve, which on the card is
   the kernels and the fused loss: per inner step and worker the sm90 B1
   2 x 6 x accum, B2a, B2b and the delta kernel 6 x accum, the sm90 B3 accum and its dlog, B4a and B4b accum x
   4. Then the same run through plain attention and the materialized
   loss (no launch): each step's loss and grad norm within phase 8's bf16
   tolerance, the masters within the displacement bound of one round
   (``phase_moe``). Launches per inner step, ms a step, peak memory, and
   the tokens each layer's capacity drops on the first micro-batch.
28. Ring attention (B5): the flash-chunk ring in one process over a
   loopback ring of 4 ranks (threads) at T 4096 (chunks of 1024), bf16,
   B 2, at config_150m's heads (16 x 64) and config_1b's (32 over 4 x 64):
   out, lse, dq, dk and dv against B1, delta, B2a and B2b over the whole
   causal sequence and against the plain (einsum) ring; B2a and B2b's f32
   outputs from bf16 operands without the causal mask against their plain
   versions; launches 10 of B1, B2a and B2b each and 4 deltas (rank r: 1
   causal + r full chunks, each way); the ring's forward and backward ms
   (all ranks on one card) against one flash call over T 4096. Then
   ``train()`` at config_150m's widths and 2 of its layers with
   ``attn_implementation="ring"`` at sp 1 and with ``"pallas"``: losses,
   grad norms, launches and master hashes bit for bit.
29. Tensor and pipeline parallelism at config_1b's full width and 4 of
   its 22 layers (``TPPP_LAYERS``: the smoke's time limit;
   phase 10's run settings: seq 1024, mb 8, accum 2; bf16, remat, the
   kernels and the fused loss; three inner steps, warmup 1):
   ``InnerTrainer`` without a group, then at pp 2 (two stage threads of
   2 layers over the loopback P2P exchange, 2 micro-batches), then at tp
   2 (two rank threads over the loopback group: 16 q and 2 kv heads, ffn
   2816 and vocab 16000 a rank, the head gathered for the loss), then at
   sp 2 (two rank threads of 512 positions a sequence, the loss's sum and
   count and the gradients summed over their sp comm) gathered
   (``attn_impl="pallas"``: q, k and v gathered, the kernels over the
   whole 1024 on each rank) and as the flash-chunk ring (``"ring"``, B5
   through autograd), on the same numpy params and batches; each rank
   thread runs its CUDA backward on its own thread
   (``set_multithreading_enabled(False)``), so a rank that waits inside a
   backward node does not hold up the others. Every rank's loss and grad
   norm within 1e-3 and 0.5% of the unsplit run's at each step, the whole
   params after step 3 within phase 27's master bound, update directions
   on at least 90% of the elements (``TPPP_TOL``; the ring's sp run also
   against the gathered one), the leaves tp and pp do not cut bit for bit
   across the ranks after every step, and the sp ranks' losses bit for
   bit. Each thread's launches (zeroed before each run) against the
   counts written down before it: per stage 2 x (L/pp) x M x accum of the
   sm90 B1 a step and half that of B2a, B2b and delta, the loss kernels on
   the last stage only (B3 accum, dlog, B4a and B4b accum x 4); per tp
   rank and gathered sp rank phase 10's attention counts at 4 layers;
   ring rank r 2 (1 + r) B1, 1 + r B2a and B2b a layer and micro-batch;
   the sp ranks' dlog, B4a and B4b accum x 2 (4096 rows a micro-batch).
   Step ms and peak device memory of each run.
30. The obs plane armed (``ODTP_OBS``, sinks in a temporary folder, the
   Prometheus port ephemeral), after phase 22 and after phase 29:
   (a) config_1b, w4, 8 requests over HTTP through ``ServeServer``, 40
   tokens each, every request with a ``"trace"`` field, one plane in
   turns off, on, on, off (the hooks read the env at each call): every
   turn's streams and its launches of B6, its merge and B8 equal the
   first turn's (the armed batcher's one kernel probe, measurement, is
   counted apart); armed, ``GET /metrics`` parses and holds the
   ``serve_*`` families, the reqtrace dump holds a complete stage chain
   (queue, prefill, decode, retire) for each request, and the Chrome
   trace built from the JSONL loads; decode-step ms of each turn with the
   card line. (b) two loopback workers at config_150m's widths and 2 of
   its layers, the kernels and the fused loss, 4 steps, ``local_steps``
   2, unarmed then armed: losses and launches bit for bit; every armed
   row's ``mfu`` is 6N FLOPs a token (``analytic_6n``) over the card's
   peak; the JSONL holds ``inner_steps``, ``outer_rounds`` and the
   ``outer/*`` spans; the black box is dumped at exit.
31. The obs plane across the galaxy, gossip and the fleet, at
   config_150m's widths and 2 of its layers (``CUT_LAYERS``): (a) two
   ``train()`` workers over TcpBackends on localhost (the kernels and the
   fused loss, 4 steps, ``local_steps`` 2, uniform8bit), unarmed then
   armed: the master hashes after each round, the losses and the launches
   equal bit for bit; armed, the JSONL holds ``rdv_rpcs``, ``rdv_frames``,
   ``rdv_rounds_closed`` and ``peer_frames``, ``outer_raw_bytes`` by codec
   is 4 bytes an element of the master a round of the round ledger and
   ``outer_wire_bytes`` one byte (uniform8bit), and before each backend
   closes a plain client's ``metrics`` RPC answers Prometheus text that
   parses and its ``health`` RPC a matrix with both workers' rows
   (unarmed: an empty body and an empty matrix). (b) One loopback gossip
   pair round, armed: ``record_wire("gossip")`` counts both sides' wire
   bytes and the overseer's ``note_round`` gives both rows. (c) A
   publisher of random masters feeds one in-process replica (bf16, prefix
   cache on) through a keyframe and a delta, armed; then 8 requests, one
   at a time, through the router, armed then unarmed: the streams and the
   launches of B6 and its merge equal (the armed batcher's one kernel
   probe counted apart), each armed request's trace is one chain (the
   router's admit, the replica's queue, prefill, decode and retire, the
   router's forward), ``fleet_router_dispatch`` is 8 and
   ``fleet_push_frames`` counts one keyframe and one delta.
32. The input prefetcher, selective remat, the normative driver and
   ``decode_kernel``: (a) config_1b's widths at 4 of its 22 layers
   (``REMAT_LAYERS``: the smoke's time limit), mb 8 x accum 2 x seq 1024,
   bf16, the flash kernels and the fused loss, numpy params: one step's
   loss and gradients under ``remat`` True, "dots", "dots_all" and
   False, every one bit for bit True's, the sm90 B1 4 L launches under
   True and 2 L under the others (the selective policies keep B1's out
   and lse through the custom op ``odtp::flash_fwd``), delta, B2a, B2b
   and the loss kernels alike; each policy's step ms (3 steps after a
   warm-up, the collector frozen) and peak device memory. (b)
   ``train_diloco.run`` at config_150m's widths and 2 of its layers, two
   simulated workers, 4 steps, ``--local-steps`` 2, ``--eval-interval``
   2, ramp data, on host then device placement: B1, delta, B2a and B2b
   launch, the losses fall, the placements' losses, eval losses and
   masters bit for bit. (c) phase 8's two workers at that cut, 4 steps,
   at ``prefetch_depth`` 0 and 2: losses, LRs, grad norms, master hashes
   and launches bit for bit, ``data_wait_s`` by step (phase 8b's resume
   runs through the prefetcher since PR 23). (d) (after phase 30 (a), on
   phase 4's params) a config_1b w4 engine in f32 compute under
   ``decode_kernel`` "auto" and "xla", 4 of phase 4's prompts x 16
   tokens: the streams equal; under "auto" B6 and its merge 22 a decode
   step and B8 (the first design, f32) 7 x 22 a prefill and a decode
   step; under "xla" no launch.
33. fp16 (``precision="fp16-mixed"``): (a) (after phase 32 (d)) every
   kernel's f16 instance against its plain version in f16 (F16_TOL:
   2**-10 of each value plus the bf16 phases' floors over 8) at phases 2,
   3, 7, 9 and 11's main shapes, on both routes where both exist (the
   ring's f32 gradients of B2a and B2b too); device times in f16 of the
   sm90 routes and of B6 and B7 beside bf16's in turns (bf16, f16, f16,
   bf16) at the 1b shapes, and of the first designs in f16; each f16 row's
   bound is its bf16 row's (the same bytes, the same dense tensor-core
   peak). (b) (after phase 32 (c)) config_1b's widths at 4 of its 22
   layers, mb 8 x accum 2 x seq 1024, fp16-mixed from scale 2**15, numpy
   params: the flash kernels with the fused loss against attn "xla" with
   the unfused loss, 1 warm-up and 3 timed steps each; loss, found_inf,
   loss_scale, grad norm and ms by step; B1 16, delta/B2a/B2b 8, B3 2,
   dlog/B4a/B4b 8 a step on the kernels path, no launch on the other;
   the first step's loss within 1e-3 and grad norm within 0.5% across the
   paths; one step of each path with cuBLAS's
   ``allow_fp16_reduced_precision_reduction`` flipped (its value
   recorded); an overflow step at scale 2**40 on each path: found_inf 1,
   params and both moments bit for bit, the scale halved; the scaler's
   decisions equal on both paths. (c) ``train()`` at fp16-mixed, two
   loopback workers at config_150m's widths and 2 layers, 6 steps, 3
   rounds, each serving w4 in f16 over HTTP with 2 slots (worker 0 spec
   k 4, worker 1 plain decode), a client a plane until training ends (the
   first round waits for an answer from each plane, the last for one of a
   later epoch): every request answers or fails with "server stopped",
   both engines swap, launches (zeroed just before, read just after) the
   training kernels' plus B6 and its merge L a decode step, B7 and its
   merge k Ld + L a round, the sm90 B8 7 L a prefill and step and 7 (k Ld
   + L) a round.
34. The kernels line (launches of B6, B7, their merges and B8 by serving
   phase, of the training kernels by training phase, phase 33's among
   them; each kernel's f16 checks, times and bound under "f16"), each
   phase's seconds and the smoke's, the card line, and last the result
   line.

Device times come from CUDA-graph replays of many launches that cycle
through enough copies of the inputs to exceed the 50 MB L2 cache, as the
main paths find their weights, KV pages and activations cold; host launch
cost is left out. Bounds take each input read once and each output
written once over 3.35 TB/s, or the operations over 989 TFLOP/s (bf16),
whichever is larger (the H100 SXM data sheet; fp16's dense peak is
bf16's).
"""
from __future__ import annotations

import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import threading
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2**20
NEW_TOKENS = 48
N_REQUESTS = 16
SPEC_K = 4  # the JAX package's scripts/serve_bench.py --spec-k default


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, arg_sets, launches: int = 64, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls cycling
    through ``arg_sets`` are captured into one CUDA graph, which is
    replayed ``replays`` times between two events."""
    # warm up (builds, loads, allocator pools) on a side stream, as graph
    # capture of an autograd backward requires
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the warmed stream (the sm90 B8 keeps its scratch a stream)
        for i in range(launches):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def host_us(torch, fn, arg_sets, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls cycling through
    ``arg_sets``, on the host clock with no sync between them (the card's
    queue stays far from full), after a warm-up call of each set."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


class CardSampler:
    """``nvidia-smi``'s SM clock, power draw, temperature and active clock
    throttle reasons every 100 ms in a background process, each sample
    stamped with the host's clock on arrival, until :meth:`stop`. The
    throttle reasons are left out where the tool refuses them; a query it
    refuses altogether leaves no samples. It never fails the run."""

    def __init__(self):
        self.samples = []
        fields = "clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active"
        probe = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60)
        if probe.returncode != 0:
            fields = fields.rsplit(",", 1)[0]
        self.proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits",
                                      "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.samples.append((time.perf_counter(), line.strip()))

    def window(self, t0: float, t1: float) -> dict:
        """The samples that arrived between host times ``t0`` and ``t1``."""
        rows = [line.split(", ") for t, line in self.samples if t0 <= t <= t1]
        rows = [r for r in rows if len(r) >= 3 and r[0].isdigit()]
        if not rows:
            return {"samples": 0}
        sm = sorted(int(r[0]) for r in rows)
        return {"samples": len(rows), "sm_mhz_min": sm[0], "sm_mhz_median": sm[len(sm) // 2],
                "power_w_max": max(float(r[1]) for r in rows), "temp_c_max": max(float(r[2]) for r in rows),
                "throttle_reasons": sorted({r[3] for r in rows if len(r) > 3})}

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
        self.reader.join(10)


class GcTimer:
    """Host milliseconds of each Python garbage collection from
    construction to :meth:`stop` (through ``gc.callbacks``): a collection
    of the oldest generation walks every object the process holds, and
    while it runs no kernel is queued."""

    def __init__(self):
        self.events, self._start = [], None
        gc.callbacks.append(self)

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.events.append((self._start, info["generation"], (time.perf_counter() - self._start) * 1e3))
            self._start = None

    def window(self, t0: float, t1: float) -> dict:
        """The collections that started between host times ``t0`` and ``t1``."""
        ev = [e for e in self.events if t0 <= e[0] <= t1]
        return {"collections": len(ev), "oldest_generation": sum(e[1] == 2 for e in ev),
                "ms": sum(e[2] for e in ev), "longest_ms": max((e[2] for e in ev), default=0.0)}

    def stop(self) -> None:
        gc.callbacks.remove(self)


def copies_for(nbytes: int) -> int:
    """Distinct input copies whose sum is at least twice the L2 cache."""
    return max(1, math.ceil(2 * L2_BYTES / max(1, nbytes)))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 2: B6 paged decode attention
# ---------------------------------------------------------------------------


def phase_b6(torch, tdk, cfg, serve_cfg, dev) -> list:
    """B6 against its plain version in f32 and bf16 at the config_1b decode
    shape, at the splits the wrapper picks (8) and at one split, each
    repeated for its bits; B6's merge against its plain version on the
    split kernel's own partials; the first design (head dims above 128)
    at D 256. Then device times in bf16 of the kernel at its splits and at
    one split in turns (the splits must take at most half of one split's
    time), the merge alone, the plain version and one SDPA call, with the
    bounds, and the host's microseconds per wrapper call at both grids.
    Returns the kernel's and its merge's rows of the kernels line."""
    import torch.nn.functional as F

    S, T = serve_cfg.max_batch, serve_cfg.max_context
    Kh, H, D = cfg.kv_heads, cfg.num_attention_heads, cfg.head_dim
    rep = H // Kh
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = tdk.spec_tail_split_chunk(T, tdk.spec_tail_splits(S, T, Kh, rep, sms))[0]
    if splits < 2:
        raise AssertionError(f"B6: the wrapper picks {splits} split at the decode shape")
    # empty slot, one row, a tile edge, mid ring, the last row, a wrapped
    # ring, and one more mid-ring slot
    lens_list = [0, 1, 255, 256, 700, 1023, 1500, 511][:S]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    checks, merge_checks, first_checks = [], [], []
    # the split kernel at the decode shape, then the first design at D 256
    for dtype, d in ((torch.float32, D), (torch.bfloat16, D), (torch.float32, 256), (torch.bfloat16, 256)):
        q = torch.randn(S, H, d, generator=g, device=dev).to(dtype)
        k = torch.randn(S, T, Kh, d, generator=g, device=dev).to(dtype)
        v = torch.randn(S, T, Kh, d, generator=g, device=dev).to(dtype)
        ref = tdk.paged_decode_attention_plain(q, k, v, lens)
        grids = (((f"{splits} splits", {}), ("1 split", {"splits": 1})) if d == D else
                 (("first design D 256", {}),))
        for label, kw in grids:
            out = tdk.paged_decode_attention(q, k, v, lens, **kw)
            again = tdk.paged_decode_attention(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().amax(dim=(1, 2))
            if dtype == torch.float32:
                # only the order of f32 sums differs (outputs are averages of
                # N(0,1) values, at most about 1)
                tol = torch.full_like(err, 1e-5)
            else:
                # p is rounded to bf16 at each tile's running max where the
                # plain version rounds at the global max, and both outputs
                # round to bf16: 2**-6 of each slot's largest output, two to
                # four bf16 ulps there. Per slot, because a long ring
                # averages its rows to outputs of about 0.1 while a one-row
                # slot returns v itself
                tol = 2.0**-6 * ref.float().abs().amax(dim=(1, 2))
            worst = int((err / tol).argmax())
            check = {"dtype": str(dtype).removeprefix("torch."), "grid": label, "max_abs_err": float(err.max()),
                     "worst_slot": {"lens": lens_list[worst], "max_abs_err": float(err[worst]),
                                    "tol": float(tol[worst])},
                     "per_slot_err": err.tolist(), "per_slot_tol": tol.tolist()}
            (checks if d == D else first_checks).append(check)
            log(f"B6 {dtype} {label}: max |kernel - plain| = {check['max_abs_err']:.3e}; nearest its tolerance: "
                f"slot with lens {lens_list[worst]}, {float(err[worst]):.3e} (tol {float(tol[worst]):.3e})")
            if not bool((err <= tol).all()):
                raise AssertionError(f"B6 {dtype} {label} disagrees with its plain version: {check}")
            if not torch.equal(out, again):
                raise AssertionError(f"B6 {dtype} {label}: a second launch gave other bits")
        if d != D:
            del q, k, v, ref, out, again
            continue
        # the merge on the split kernel's own partials against the plain
        # merge: the same f32 sums in the same order, exp correctly rounded
        # on both sides to an ulp or two
        P, chunk = tdk.spec_tail_split_chunk(T, splits)
        ml, acc = tdk._paged_decode_partials(q, k, v, lens, splits=P, chunk=chunk)
        out = tdk.paged_decode_merge(ml, acc, dtype)
        torch.cuda.synchronize()
        mref = tdk.spec_tail_merge_plain(ml, acc, 1, dtype).reshape(S, H, D).float()
        err = float((out.float() - mref).abs().max())
        tol = (1e-6 if dtype == torch.float32 else 2.0**-8) * max(1.0, float(mref.abs().max()))
        merge_checks.append({"dtype": str(dtype).removeprefix("torch."), "splits": P, "max_abs_err": err,
                             "tol": tol, "dead_splits": int((ml[..., 0] == float("-inf")).sum())})
        if not err <= tol:
            raise AssertionError(f"B6 merge {dtype}: {err} > {tol}")
        del q, k, v, ref, out, again, ml, acc, mref
    log(f"B6 merge kernel vs plain merge: {json.dumps(merge_checks)}")

    # timing in the serving dtype, KV pages cycled to stay out of L2
    dtype, elt = torch.bfloat16, 2
    live = [min(n, T - 1) + 1 for n in lens_list]
    page_bytes = S * T * Kh * D * elt * 2
    sets = []
    q = torch.randn(S, H, D, generator=g, device=dev).to(dtype)
    for _ in range(copies_for(page_bytes)):
        k = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
        v = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
        sets.append((q, k, v, lens))
    one = lambda *a: tdk.paged_decode_attention(*a, splits=1)
    # the two grids in turns (chosen, one split, one split, chosen)
    runs = [device_ms(torch, f, sets) for f in (tdk.paged_decode_attention, one, one, tdk.paged_decode_attention)]
    kernel_ms, one_ms = min(runs[0], runs[3]), min(runs[1], runs[2])
    # the host's cost of the two grids: two launches, the partials'
    # allocations and the split rule against one launch
    host = [host_us(torch, f, sets) for f in (tdk.paged_decode_attention, one, one, tdk.paged_decode_attention)]
    P, chunk = tdk.spec_tail_split_chunk(T, splits)
    parts = [tdk._paged_decode_partials(*a, splits=P, chunk=chunk) for a in sets]
    merge_ms = device_ms(torch, lambda ml, acc: tdk.paged_decode_merge(ml, acc, dtype), parts)
    merge_plain_ms = device_ms(torch, lambda ml, acc: tdk.spec_tail_merge_plain(ml, acc, 1, dtype), parts[:1],
                               launches=16)
    del parts
    plain_ms = device_ms(torch, tdk.paged_decode_attention_plain, sets, launches=16)

    # library yardstick, timed here only: one SDPA call over the dense ring
    # with the live-row mask, GQA by enable_gqa
    idx = torch.arange(T, device=dev)[None, :]
    ln = lens.long()[:, None]
    mask = ((idx <= ln) | (ln >= T))[:, None, None, :]

    def sdpa(q, k, v, lens):
        return F.scaled_dot_product_attention(
            q.unsqueeze(2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True,
        )

    library_ms = device_ms(torch, sdpa, sets, launches=16)
    nbytes = sum(live) * Kh * D * elt * 2 + 2 * S * H * D * elt + S * 4
    flops = sum(live) * H * D * 4
    b_ms, b_by = bound_ms(nbytes, flops)
    R = S * Kh * rep
    merge_b_ms, merge_b_by = bound_ms(R * P * (D + 2) * 4 + R * D * elt, 0.0)
    log(
        f"B6 bf16 S{S} T{T} Kh{Kh} rep{rep} D{D} live rows {sum(live)}: kernel {kernel_ms:.4f} ms at {splits} "
        f"splits (of it merge {merge_ms:.4f}), one split {one_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); host {host[0]:.1f}/{host[3]:.1f} us a call "
        f"at {splits} splits, {host[1]:.1f}/{host[2]:.1f} at one split"
    )
    if not kernel_ms <= 0.5 * one_ms:
        raise AssertionError(f"B6: {kernel_ms:.4f} ms at {splits} splits is more than half of one split's "
                             f"{one_ms:.4f} ms")
    source = "opendiloco_torch/csrc/spec_tail_attention.cu"
    replaces = "opendiloco_tpu/ops/decode_kernels.py:241 (paged_decode_attention, _decode_attn_kernel :112)"
    shape = {"S": S, "T": T, "Kh": Kh, "rep": rep, "D": D, "lens": lens_list, "splits": splits, "dtype": "bfloat16"}
    b6 = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "shape": shape,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "tol": "f32 1e-5; bf16 2**-6 of each slot's largest output",
        "checks": checks,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "kernel_ms_runs": runs,
        "note": "ms is the wrapper's whole call at the splits it picks, the merge launch included",
        "one_split_ms": one_ms,
        "host_us_runs": host[::3],
        "one_split_host_us_runs": host[1:3],
        "first_design_checks": first_checks,
        "first_design_source": "opendiloco_torch/csrc/paged_decode_attention.cu",
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True) over the masked dense ring",
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    merge = {
        "name": "paged_decode_attention_merge",
        "route": "cuda",
        "source": source,
        "replaces": f"{replaces}: the (m, l, acc) carry across the TPU kernel's sequential ring grid axis",
        "shape": {**shape, "rows": rep},
        "max_abs_err": max(c["max_abs_err"] for c in merge_checks),
        "tol": "f32 1e-6, bf16 2**-8 of the largest output (at least 1)",
        "checks": merge_checks,
        "ms": merge_ms,
        "kernel_ms": merge_ms,
        "note": "also counted inside paged_decode_attention's ms",
        "plain_ms": merge_plain_ms,
        "library_ms": None,
        "library": "none: no one call merges softmax partials",
        "bound_ms": merge_b_ms,
        "bound_by": merge_b_by,
    }
    return [b6, merge]


# ---------------------------------------------------------------------------
# phase 3: B8 W4 dequant-matmul
# ---------------------------------------------------------------------------


def layer_weight_shapes(cfg) -> dict:
    """The decoder's matmul weight shapes [in, out] and their count per layer."""
    D, F_, Hd, KVd = (
        cfg.hidden_size, cfg.intermediate_size,
        cfg.num_attention_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim,
    )
    shapes: dict = {}
    for shape in ((D, Hd), (D, KVd), (D, KVd), (Hd, D), (D, F_), (D, F_), (F_, D)):
        shapes[shape] = shapes.get(shape, 0) + 1
    return shapes


B8_REPLACES = "opendiloco_tpu/ops/decode_kernels.py:561 (w4_matmul, _w4_kernel :468)"
B8_M = (8, 40, 1024)  # decode, the spec verify (8 slots x 5), a prefill bucket
B8_TOL = ("f32: 1e-5 of the largest output (K-long f32 sums in another order); bf16: 2**-7 of the largest output "
          "(both sum in f32 and round once to bf16: one bf16 ulp apart at most)")


B8_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)  # split counts timed at M 8 and 40


def w4_sm90_at(torch, tdk, M: int, K: int, N: int, splits: int, dev):
    """``w4_matmul``'s call signature on the sm90 B8's C entry at a forced
    split count, with scratch of its own (made here, outside any capture)."""
    mi = tdk.w4_slices(M)
    part = torch.empty(max(1, splits * M * N), dtype=torch.float32, device=dev)
    tickets = torch.zeros(-(-M // (16 * mi)) * (N // tdk.W4_TILE_N), dtype=torch.int32, device=dev)

    def fn(x, q, s, shape, dtype):
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        tdk._launch("w4_matmul_sm90", torch.bfloat16, dev, x.data_ptr(), q.data_ptr(), s.data_ptr(),
                    out.data_ptr(), part.data_ptr(), tickets.data_ptr(), M, K, N, mi, splits)
        return out

    return fn


def phase_b8(torch, tdk, quant, cfg, dev) -> list:
    """B8 at every config_1b weight shape: the identity probe bit for bit
    (f32, the first design); at M 8, 40 and 1024 the sm90 kernel (bf16)
    and the first design (f32, and bf16 through route=) against the plain
    version, the sm90 kernel repeated for its bits; device times in bf16
    of both routes in turns (sm90, first, first, sm90) and of the plain
    version, and the bounds."""
    from opendiloco_torch.quant import W4_BLOCK

    first, sm90 = tdk.W4_FIRST_SOURCE, tdk.W4_SM90_SOURCE
    g = torch.Generator(device=dev).manual_seed(2)
    checks = {"w4_matmul": [], "w4_matmul_sm90": []}
    timings = []
    for (K, N), count in layer_weight_shapes(cfg).items():
        qs, ss = quant.pack_blockwise4_stacked(torch.randn(1, K, N, generator=g, device=dev))
        q, s = qs[0], ss[0]
        # the identity probe: x = I in f32 gives dequant_w4 bit for bit
        eye = tdk.w4_matmul(torch.eye(K, device=dev), q, s, (K, N), torch.float32)
        if not torch.equal(eye, quant.dequant_w4(q, s, (K, N), torch.float32)):
            raise AssertionError(f"B8 identity probe at {(K, N)} is not bitwise dequant_w4")
        for M in B8_M:
            x = torch.randn(M, K, generator=g, device=dev)
            for dtype, route, name in ((torch.float32, first, "w4_matmul"), (torch.bfloat16, first, "w4_matmul"),
                                       (torch.bfloat16, sm90, "w4_matmul_sm90")):
                out = tdk.w4_matmul(x, q, s, (K, N), dtype, route=route)
                ref = tdk.w4_matmul_plain(x, q, s, (K, N), dtype)
                if name == "w4_matmul_sm90" and not torch.equal(out, tdk.w4_matmul(x, q, s, (K, N), dtype)):
                    raise AssertionError(f"B8 sm90 {(M, K, N)}: a second launch gave other bits")
                scale = float(ref.float().abs().max())
                err = float((out.float() - ref.float()).abs().max())
                tol = 1e-5 * scale if dtype == torch.float32 else 2**-7 * scale
                checks[name].append({"K": K, "N": N, "M": M, "dtype": str(dtype).removeprefix("torch."),
                                     "max_abs_err": err, "tol": tol, "share_of_tol": err / tol})
                if not err <= tol:
                    raise AssertionError(f"B8 {name} {(M, K, N)} {dtype}: {err} > {tol}")
        log(f"B8 {(K, N)}: identity probe bitwise; first design f32/bf16 and sm90 bf16 within tolerance at M "
            f"{'/'.join(map(str, B8_M))}, sm90 bit for bit on repeat (splits at M 8: "
            f"{tdk.w4_splits(8, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)})")

        packed_bytes = K * N // 2 + math.ceil(K * N / W4_BLOCK) * 2
        copies = copies_for(packed_bytes)
        w = []
        for _ in range(copies):  # distinct weights, so every call reads cold
            qc, sc = quant.pack_blockwise4_stacked(torch.randn(1, K, N, generator=g, device=dev))
            w.append((qc[0], sc[0]))
        for M in B8_M:
            x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            sets = [(x, qc, sc, (K, N), torch.bfloat16) for qc, sc in w]
            launches = max(64, min(len(sets), 256)) if M < 1024 else 16

            def on(route):
                return lambda *a: tdk.w4_matmul(*a, route=route)

            ms = {r: [] for r in (sm90, first)}
            for r in (sm90, first, first, sm90):
                ms[r].append(device_ms(torch, on(r), sets, launches=launches))
            plain_ms = device_ms(torch, tdk.w4_matmul_plain, sets, launches=16)
            nbytes = packed_bytes + M * K * 2 + M * N * 2
            b_ms, b_by = bound_ms(nbytes, 2.0 * M * K * N)
            timings.append({"M": M, "K": K, "N": N, "per_layer": count, "sm90_ms": min(ms[sm90]),
                            "first_ms": min(ms[first]), "same_call": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by})
            if M < 64:  # the sm90 kernel's C entry at split counts around its rule's
                rule = tdk.w4_splits(M, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
                counts = sorted({S for S in (*B8_SWEEP, rule) if S <= -(-K // 16)})
                timings[-1]["sm90_ms_by_splits"] = {
                    S: device_ms(torch, w4_sm90_at(torch, tdk, M, K, N, S, dev), sets, launches=launches)
                    for S in counts}
                log(f"B8 sm90 bf16 M{M} K{K} N{N} by splits (rule {rule}): "
                    f"{json.dumps({S: round(v, 5) for S, v in timings[-1]['sm90_ms_by_splits'].items()})}")
            log(f"B8 bf16 M{M} K{K} N{N}: sm90 {ms[sm90][0]:.4f}/{ms[sm90][1]:.4f} ms, first design "
                f"{ms[first][0]:.4f}/{ms[first][1]:.4f} ms (sm90, first, first, sm90), plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.5f} ms ({b_by})")
        del w

    def per_layer(M, key):
        return sum(t[key] * t["per_layer"] for t in timings if t["M"] == M)

    rows = []
    for name, source, key in (("w4_matmul_sm90", "opendiloco_torch/csrc/w4_matmul_sm90.cu", "sm90_ms"),
                              ("w4_matmul", "opendiloco_torch/csrc/w4_matmul.cu", "first_ms")):
        worst = max(checks[name], key=lambda c: c["share_of_tol"])
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": B8_REPLACES,
            "shape": "one decoder layer's 7 weight matmuls at M 8 (decode), bfloat16; per-M layer times in "
                     "'layer_ms_by_M', per-shape times in 'shapes'",
            "max_abs_err": worst["max_abs_err"],
            "tol": B8_TOL,
            "worst_check": worst,
            "checks": checks[name],
            "ms": per_layer(8, key),
            "kernel_ms": per_layer(8, key),
            "plain_ms": per_layer(8, "plain_ms"),
            "library_ms": None,
            "library": "none: no single PyTorch call dequantizes blockwise-4-bit and multiplies",
            "bound_ms": per_layer(8, "bound_ms"),
            "bound_by": "bytes" if all(t["bound_by"] == "bytes" for t in timings if t["M"] == 8) else "operations",
            "layer_ms_by_M": {M: {"kernel_ms": per_layer(M, key), "plain_ms": per_layer(M, "plain_ms"),
                                  "bound_ms": per_layer(M, "bound_ms")} for M in B8_M},
            "shapes": [{k: t[k] for k in ("M", "K", "N", "per_layer", key, "plain_ms", "bound_ms", "bound_by")}
                       for t in timings],
        })
    rows[0]["same_call"] = [{k: t[k] for k in ("M", "K", "N", "same_call")} for t in timings]
    rows[0]["ms_by_splits"] = [{k: t[k] for k in ("M", "K", "N", "sm90_ms_by_splits")}
                               for t in timings if "sm90_ms_by_splits" in t]
    for M in B8_M:
        log(f"B8 bf16 per 1b layer at M {M}: sm90 {per_layer(M, 'sm90_ms'):.4f} ms, first design "
            f"{per_layer(M, 'first_ms'):.4f} ms, plain {per_layer(M, 'plain_ms'):.4f} ms, bound "
            f"{per_layer(M, 'bound_ms'):.5f} ms")
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving main path
# ---------------------------------------------------------------------------


def prompts_over_buckets(serve_cfg, vocab: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    edges = [0, *serve_cfg.prefill_buckets]
    lengths = []
    for i in range(N_REQUESTS):
        b = i % len(serve_cfg.prefill_buckets)
        lengths.append(int(rng.integers(edges[b] + 1, edges[b + 1] + 1)))
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def drive(tdk, plane, prompts, warm, vocab: int) -> dict:
    """Warm-up requests of 2 tokens each (first cuBLAS and allocator use),
    then the main path: the launch counters zeroed just before the
    requests are submitted, all at once, and read just after the last one
    finished. Every request must complete with NEW_TOKENS tokens in the
    vocabulary. Returns the run's requests, launches, and its deltas of
    the batcher's and engine's counters."""
    engine, batcher = plane.engine, plane.batcher
    for r in [batcher.submit(p, max_new_tokens=2) for p in warm]:
        if not r.wait(600) or r.error is not None:
            raise AssertionError(f"warm-up request failed: {r.error}")
    base, stages0 = batcher.stats(), dict(engine.stage_seconds)
    tdk.LAUNCHES.reset()
    t0 = time.perf_counter()
    reqs = [batcher.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    for r in reqs:
        if not r.wait(1200):
            raise AssertionError("request timed out")
    wall = time.perf_counter() - t0
    launches = tdk.LAUNCHES.snapshot()
    st = batcher.stats()
    failed = [r.error for r in reqs if r.error is not None]
    if failed:
        raise AssertionError(f"{len(failed)} requests failed: {failed[:3]}")
    for r in reqs:
        if len(r.tokens) != NEW_TOKENS or not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.id}: bad tokens {r.tokens[:8]}...")
    ttft = sorted(r.ttft_s for r in reqs)
    return {
        "reqs": reqs,
        "launches": launches,
        "steps": st["decode_steps"] - base["decode_steps"],
        "prefills": st["completed"] - base["completed"],
        "new_tokens": st["new_tokens"] - base["new_tokens"],
        "spec_proposed": st["spec"]["proposed"] - base["spec"]["proposed"],
        "spec_accepted": st["spec"]["accepted"] - base["spec"]["accepted"],
        "prefix_hits": st["prefix"]["hits"] - base["prefix"]["hits"],
        "stages": {k: engine.stage_seconds[k] - stages0[k] for k in engine.stage_seconds},
        "summary": {
            "requests": len(reqs),
            "prompt_lengths": [len(p) for p in prompts],
            "new_tokens": sum(len(r.tokens) for r in reqs),
            "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_max_ms": ttft[-1] * 1e3,
        },
    }


def check_launches(launches: dict, want: dict, what: str) -> None:
    full = {name: 0 for name in launches}
    full.update(want)
    if launches != full:
        raise AssertionError(f"{what}: launch counts {launches} != {full}")


# B6 merge launches per decode step at config_1b, as test_paged_decode_split_rule
# pins the split rule: each of the 22 layers' B6 calls cuts the ring into 8
# splits (8 slots x 4 kv heads leave 132 SMs short), so each merges once
PAGED_MERGES_PER_STEP = 22


def phase_serve(torch, tdk, cfg, serve_cfg, params, dev) -> dict:
    from opendiloco_torch.models.llama import decode_forward
    from opendiloco_torch.serve import build_serving

    L = cfg.num_hidden_layers
    w4 = serve_cfg.weight_format == "w4"
    prompts = prompts_over_buckets(serve_cfg, cfg.vocab_size)
    plane = build_serving(serve_cfg, cfg, params, device=dev, start_server=False)
    try:
        engine = plane.engine
        run = drive(tdk, plane, prompts, [p[:b] for p, b in zip(prompts, serve_cfg.prefill_buckets)],
                    cfg.vocab_size)
        steps, prefills, launches = run["steps"], run["prefills"], run["launches"]
        check_launches(launches, {"paged_decode_attention": L * steps,
                                  "paged_decode_attention_merge": PAGED_MERGES_PER_STEP * steps,
                                  "w4_matmul_sm90": 7 * L * (prefills + steps) if w4 else 0},
                       f"serve {serve_cfg.weight_format} ({steps} decode steps, {prefills} prefills)")
        res = {
            "weight_format": serve_cfg.weight_format,
            **run["summary"],
            "decode_steps": steps,
            "prefills": prefills,
            "launches": launches,
            "decode_step_ms": run["stages"]["decode"] / steps * 1e3,
            "prefill_ms_mean": run["stages"]["prefill"] / prefills * 1e3,
        }
        log(f"serve {serve_cfg.weight_format}: {json.dumps(res)}")
        res["tokens"] = [r.tokens for r in run["reqs"]]

        # one decode step, kernel path against plain path, on the live
        # cache and weights (comparison launches, not counted above)
        S, T = serve_cfg.max_batch, serve_cfg.max_context
        g = torch.Generator(device=dev).manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (S,), generator=g, device=dev)
        lens = torch.tensor([0, 5, 63, 300, 700, 1023, 1100, 2000][:S], dtype=torch.int32, device=dev)
        res["decode_compare"] = []
        # f32: kernel and plain differ only in the order of f32 sums, over
        # 22 layers; bf16: the two paths round attention probabilities and
        # products to bf16 at different points in every layer
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 0.25)):
            outs = []
            for kernels in (True, False):
                ck, cv = engine.cache_k.to(dtype, copy=True), engine.cache_v.to(dtype, copy=True)
                logits, _, _ = decode_forward(engine.params, tokens, lens, ck, cv, cfg,
                                              compute_dtype=dtype, kernels=kernels)
                outs.append(logits)
                del ck, cv
            if not all(bool(torch.isfinite(o).all()) for o in outs):
                raise AssertionError("non-finite decode logits")
            err = float((outs[0] - outs[1]).abs().max())
            agree = int((outs[0].argmax(-1) == outs[1].argmax(-1)).sum())
            res["decode_compare"].append({"dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
                                          "tol": tol, "argmax_agree": f"{agree}/{S}",
                                          "logit_absmax": float(outs[1].abs().max())})
            log(f"decode_forward {dtype} kernel vs plain: max |d logits| = {err:.3e} (tol {tol}), "
                f"argmax agree {agree}/{S}")
            if not err <= tol:
                raise AssertionError(f"decode logits {dtype}: kernel vs plain {err} > {tol}")
        return res
    finally:
        plane.stop()


# ---------------------------------------------------------------------------
# phase 11: B7 speculative tail attention
# ---------------------------------------------------------------------------


def b7_work(S, T, Kh, rep, D, Kq, Kt, q_start, lens_list, elt) -> tuple[float, float]:
    """(bytes, operations) B7 must move and do on these inputs: every ring
    row live before the tail and every tail row read once per slot and kv
    head, q and out once, lens; 4 D operations (q.k and p.v) per query
    head and (query, key) pair the mask leaves live."""
    import torch

    from opendiloco_torch.ops.attention import spec_tail_valid

    lens = torch.tensor(lens_list, dtype=torch.int32)
    ring, tail = spec_tail_valid(lens, T, Kq, Kt, q_start, "cpu")
    pairs = int(ring.sum()) + S * int(tail.sum())
    live = sum(T if n >= T else n for n in lens_list)
    nbytes = (live + S * Kt) * Kh * D * elt * 2 + 2 * S * Kq * Kh * rep * D * elt + 4 * S
    return nbytes, 4.0 * D * Kh * rep * pairs


def phase_b7(torch, tdk, cfg, serve_cfg, dev) -> list:
    """B7 against its plain version in f32 and bf16 at the shapes of its
    three passes at config_1b: verify (S 8, Kq = Kt = 5), draft (Kq 1, Kt
    4, q_start 0..3) and continued prefill (S 1, Kq = Kt = 64, 256 and
    1000 behind a 192-row prefix: the prefill buckets), over lens with an
    empty slot, T - 2, T and a wrapped ring 2T + 1, with the ring splits
    the wrapper picks; then the split edges: whole splits empty (lens 0,
    short rings), evicted (lens >= T at q_start 3) or cut inside the live
    ring (T - 2, 3 splits of 342 rows), and the merge kernel against its plain version on the split
    kernel's own partials at the three shapes that merge on the main path
    (verify, draft, suffix 64). Then device times in bf16 of the kernel
    (split and merge) at its chosen splits and at one split (the grid of
    one block walk per query tile), its plain version, one SDPA call and
    the merge alone, with the bounds; at verify and draft the splits must
    take at most half of one split's time."""
    import torch.nn.functional as F

    S, T = serve_cfg.max_batch, serve_cfg.max_context
    Kh, H, D = cfg.kv_heads, cfg.num_attention_heads, cfg.head_dim
    rep = H // Kh
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ragged = [0, 5, 255, 700, T - 2, T, 2 * T + 1, 511][:S]
    edges = [0, 0, 5, 127, 128, T - 2, T, T + 3][:S]
    # (label, S, Kq, Kt, q_start, lens, splits or None for the wrapper's)
    shapes = [("verify", S, 5, 5, 0, ragged, None)]
    shapes += [(f"draft q_start {i}", S, 1, 4, i, ragged, None) for i in range(4)]
    shapes += [(f"suffix {n}", 1, n, n, 0, [192], None) for n in (64, 256, 1000)]
    shapes += [("verify split edges", S, 5, 5, 0, edges, None),
               ("draft split edges q_start 3", S, 1, 4, 3, edges, None),
               ("verify 3 splits", S, 5, 5, 3, edges, 3), ("draft 16 splits", S, 1, 4, 3, edges, 16),
               ("suffix 256, 2 splits", 1, 256, 256, 0, [192], 2)]
    g = torch.Generator(device=dev).manual_seed(5)

    def inputs(n, kq, kt, dtype, lens_list):
        q = torch.randn(n, kq, H, D, generator=g, device=dev).to(dtype)
        ring = [torch.randn(n, T, Kh, D, generator=g, device=dev).to(dtype) for _ in range(2)]
        tail = [torch.randn(n, kt, Kh, D, generator=g, device=dev).to(dtype) for _ in range(2)]
        return (q, *ring, *tail, torch.tensor(lens_list, dtype=torch.int32, device=dev))

    def splits_of(n, kq, splits):
        return tdk.spec_tail_split_chunk(T, splits or tdk.spec_tail_splits(n, T, Kh, kq * rep, sms))[0]

    checks = []
    for label, n, kq, kt, q_start, lens_list, splits in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(n, kq, kt, dtype, lens_list)
            out = tdk.spec_tail_attention_fused(*args, q_start=q_start, splits=splits)
            again = tdk.spec_tail_attention_fused(*args, q_start=q_start, splits=splits)
            torch.cuda.synchronize()
            ref = tdk.spec_tail_attention_plain(*args, q_start=q_start).float()
            err = (out.float() - ref).abs().amax(dim=(2, 3))  # per (slot, query token)
            top = ref.abs().amax(dim=(2, 3))
            # f32: only the order of f32 sums differs; bf16: as B6, p rounds
            # to bf16 at each tile's running max in the kernel and at the
            # global max in the plain version, and both outputs round to bf16
            tol = 1e-5 * top.clamp(min=1.0) if dtype == torch.float32 else 2.0**-6 * top
            share = float((err / tol).max())
            used = splits_of(n, kq, splits)
            checks.append({"shape": label, "S": n, "Kq": kq, "Kt": kt, "q_start": q_start, "lens": lens_list,
                           "splits": used, "dtype": str(dtype).removeprefix("torch."),
                           "max_abs_err": float(err.max()), "worst_err_over_tol": share})
            if not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"B7 {label} {dtype}: non-finite output")
            if not torch.equal(out, again):
                raise AssertionError(f"B7 {label} {dtype}: a second launch gave other bits")
            if not bool((err <= tol).all()):
                raise AssertionError(f"B7 {label} {dtype} disagrees with its plain version: err/tol {share}")
            del args, out, again, ref
        log(f"B7 {label} (S{n} Kq{kq} Kt{kt} q_start {q_start} lens {lens_list}, {used} splits): f32 and bf16 "
            "within tolerance, bit for bit on a second launch")

    # the merge kernel against its plain version on the split kernel's own
    # partials: the same f32 sums in the same order, exp correctly rounded
    # on both sides to an ulp or two
    merge_checks = []
    for label, n, kq, kt, q_start, lens_list in (("verify", S, 5, 5, 0, edges), ("draft", S, 1, 4, 3, edges),
                                                 ("suffix 64", 1, 64, 64, 0, [192])):
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(n, kq, kt, dtype, lens_list)
            P, chunk = tdk.spec_tail_split_chunk(T, splits_of(n, kq, None))
            if P < 2:
                raise AssertionError(f"B7 merge {label}: the wrapper picks {P} split")
            ml, acc = tdk._spec_tail_partials(*args, q_start=q_start, splits=P, chunk=chunk)
            out = tdk.spec_tail_merge(ml, acc, kq, dtype)
            torch.cuda.synchronize()
            ref = tdk.spec_tail_merge_plain(ml, acc, kq, dtype).float()
            err = float((out.float() - ref).abs().max())
            tol = (1e-6 if dtype == torch.float32 else 2.0**-8) * max(1.0, float(ref.abs().max()))
            merge_checks.append({"shape": label, "splits": P, "dtype": str(dtype).removeprefix("torch."),
                                 "max_abs_err": err, "tol": tol,
                                 "dead_splits": int((ml[..., 0] == float("-inf")).sum())})
            if not err <= tol:
                raise AssertionError(f"B7 merge {label} {dtype}: {err} > {tol}")
            del args, ml, acc, out, ref
    log(f"B7 merge kernel vs plain merge: {json.dumps(merge_checks)}")
    torch.cuda.empty_cache()

    def sdpa_call(q, ck, cv, tk, tv, lens, q_start):
        """One SDPA call over concat(ring, tail) with B7's boolean mask;
        the concatenation and the mask are built outside the timing."""
        from opendiloco_torch.ops.attention import spec_tail_valid

        ring, tail = spec_tail_valid(lens, T, q.shape[1], tk.shape[1], q_start, dev)
        mask = torch.cat([ring, tail.expand(q.shape[0], -1, -1)], dim=-1)[:, None]
        keys = torch.cat([ck, tk], dim=1).transpose(1, 2).contiguous()
        values = torch.cat([cv, tv], dim=1).transpose(1, 2).contiguous()
        return (q.transpose(1, 2).contiguous(), keys, values, mask)

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    timed = {}
    dtype, elt = torch.bfloat16, 2
    lens_timed = [0, 1, 255, 256, 700, 1023, 1500, 511][:S]
    full = [T + 3 * i for i in range(S)]  # every ring row live
    for label, n, kq, kt, q_start, lens_list in [("verify", S, 5, 5, 0, lens_timed),
                                                  ("verify full ring", S, 5, 5, 0, full),
                                                  ("draft", S, 1, 4, 3, lens_timed),
                                                  ("suffix 64", 1, 64, 64, 0, [192]),
                                                  ("suffix 256", 1, 256, 256, 0, [192])]:
        page_bytes = n * T * Kh * D * elt * 2
        sets = [inputs(n, kq, kt, dtype, lens_list) for _ in range(copies_for(page_bytes))]
        used = splits_of(n, kq, None)
        kern = lambda *a, qs=q_start: tdk.spec_tail_attention_fused(*a, q_start=qs)
        one = lambda *a, qs=q_start: tdk.spec_tail_attention_fused(*a, q_start=qs, splits=1)
        plain = lambda *a, qs=q_start: tdk.spec_tail_attention_plain(*a, q_start=qs)
        # the two grids in turns (chosen, one split, one split, chosen)
        runs = [device_ms(torch, f, sets) for f in (kern, one, one, kern)]
        kernel_ms, one_ms = min(runs[0], runs[3]), min(runs[1], runs[2])
        merge_ms = None
        if used > 1:
            P, chunk = tdk.spec_tail_split_chunk(T, used)
            parts = [tdk._spec_tail_partials(*a, q_start=q_start, splits=P, chunk=chunk) for a in sets]
            merge_ms = device_ms(torch, lambda ml, acc, kq=kq: tdk.spec_tail_merge(ml, acc, kq, dtype), parts)
            del parts
        plain_ms = device_ms(torch, plain, sets, launches=16)
        lib_sets = [sdpa_call(*a, q_start) for a in sets]
        library_ms = device_ms(torch, sdpa, lib_sets, launches=16)
        b_ms, b_by = bound_ms(*b7_work(n, T, Kh, rep, D, kq, kt, q_start, lens_list, elt))
        R = n * Kh * kq * rep
        merge_b_ms, _ = bound_ms(R * used * (D + 2) * 4 + R * D * elt, 0.0)
        timed[label] = {"S": n, "Kq": kq, "Kt": kt, "q_start": q_start, "lens": lens_list, "splits": used,
                        "kernel_ms": kernel_ms, "kernel_ms_runs": runs, "one_split_ms": one_ms,
                        "merge_ms": merge_ms, "merge_bound_ms": merge_b_ms if used > 1 else None,
                        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"B7 bf16 {label} S{n} T{T} Kh{Kh} rep{rep} D{D} Kq{kq} Kt{kt}: kernel {kernel_ms:.4f} ms at {used} "
            f"splits (of it merge {merge_ms if merge_ms is None else f'{merge_ms:.4f}'}), one split {one_ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        del sets, lib_sets
        torch.cuda.empty_cache()
    v, dr = timed["verify"], timed["draft"]
    for label in ("verify", "draft"):
        t = timed[label]
        if not t["kernel_ms"] <= 0.5 * t["one_split_ms"]:
            raise AssertionError(f"B7 {label}: {t['kernel_ms']:.4f} ms at {t['splits']} splits is more than half "
                                 f"of one split's {t['one_split_ms']:.4f} ms")
    source = "opendiloco_torch/csrc/spec_tail_attention.cu"
    replaces = "opendiloco_tpu/ops/decode_kernels.py:438 (spec_tail_attention_fused, _spec_tail_kernel :265)"
    b7 = {
        "name": "spec_tail_attention",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "shape": {"pass": "verify", "S": S, "T": T, "Kh": Kh, "rep": rep, "D": D, "Kq": 5, "Kt": 5,
                  "lens": v["lens"], "splits": v["splits"], "dtype": "bfloat16"},
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "tol": "per (slot, query token): f32 1e-5 of the largest output (at least 1e-5); bf16 2**-6 of the largest",
        "checks": checks,
        "ms": v["kernel_ms"],
        "kernel_ms": v["kernel_ms"],
        "note": "ms is the wrapper's whole call, the merge launch included where there is more than one split",
        "plain_ms": v["plain_ms"],
        "library_ms": v["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True) over concat(ring, tail) "
                   "with B7's boolean mask (concatenation and mask built outside the timing)",
        "bound_ms": v["bound_ms"],
        "bound_by": v["bound_by"],
        "timed": timed,
    }
    merge = {
        "name": "spec_tail_attention_merge",
        "route": "cuda",
        "source": source,
        "replaces": f"{replaces}: the (m, l, acc) carry across the TPU kernel's sequential ring grid axis",
        "shape": {"pass": "draft", "S": S, "Kh": Kh, "rows": rep, "D": D, "splits": dr["splits"],
                  "dtype": "bfloat16"},
        "max_abs_err": max(c["max_abs_err"] for c in merge_checks),
        "tol": "f32 1e-6, bf16 2**-8 of the largest output (at least 1)",
        "checks": merge_checks,
        "ms": dr["merge_ms"],
        "kernel_ms": dr["merge_ms"],
        "note": "also counted inside spec_tail_attention's ms; verify: "
                f"{v['merge_ms']} ms at {v['splits']} splits",
        "plain_ms": None,
        "library_ms": None,
        "library": "none: no one call merges softmax partials",
        "bound_ms": dr["merge_bound_ms"],
        "bound_by": "bytes",
    }
    # the plain merge repeats the kernel's sums on the same partials
    P, chunk = tdk.spec_tail_split_chunk(T, dr["splits"])
    parts = [tdk._spec_tail_partials(*inputs(S, 1, 4, dtype, lens_timed), q_start=3, splits=P, chunk=chunk)]
    merge["plain_ms"] = device_ms(torch, lambda ml, acc: tdk.spec_tail_merge_plain(ml, acc, 1, dtype), parts,
                                  launches=16)
    del parts
    return [b7, merge]


# ---------------------------------------------------------------------------
# phases 12 and 13: speculative decode and prefix reuse through build_serving
# ---------------------------------------------------------------------------


def agreement(a: list, b: list) -> dict:
    """How far two runs' token lists agree: requests equal throughout, and
    the mean share of each request's tokens before the first difference."""
    lead = []
    for x, y in zip(a, b):
        n = next((i for i, (s, t) in enumerate(zip(x, y)) if s != t), min(len(x), len(y)))
        lead.append(n / max(1, len(x)))
    return {"equal_requests": sum(x == y for x, y in zip(a, b)), "of": len(a),
            "mean_share_before_first_difference": float(np.mean(lead))}


# B7 merge launches at config_1b, as test_spec_tail_split_rule pins the
# split rule: a spec round's k * Ld = 44 draft passes and L = 22 verify
# passes each cut the ring into 8 splits (8 slots x 4 kv heads leave 132
# SMs short), so each merges once
SPEC_MERGES_PER_ROUND = 66
# merge launches per layer of a prefix hit's suffix pass (S 1), by the
# prefill bucket its suffix pads to: 64 rows give 8 query tiles x 4 kv
# heads, 8 splits; 256 and 1024 rows fill the card with one split
SUFFIX_MERGES = {64: 1, 256: 0, 1024: 0}


def phase_spec(torch, tdk, cfg, serve_cfg, params, dev, plain: dict) -> dict:
    """``build_serving`` with ``spec_decode_k`` 4 (11 of 22 draft layers)
    drives phase 4's 16 requests. Per round B7 runs k * Ld + L = 66 times
    and B6 never; under w4 B8 runs 7 * 66 times a round and 7 * 22 a
    prefill. Under fp32 weights, verify_forward's logits for a 5-token
    tail are held against the plain path and against decode_forward
    stepped one token at a time, in f32 and bf16."""
    from opendiloco_torch.models.llama import decode_forward, verify_forward
    from opendiloco_torch.serve import build_serving

    L = cfg.num_hidden_layers
    w4 = serve_cfg.weight_format == "w4"
    prompts = prompts_over_buckets(serve_cfg, cfg.vocab_size)
    plane = build_serving(serve_cfg, cfg, params, device=dev, start_server=False)
    try:
        engine = plane.engine
        k, Ld = engine.spec_k, engine.draft_layers
        per_round = k * Ld + L
        run = drive(tdk, plane, prompts, [p[:b] for p, b in zip(prompts, serve_cfg.prefill_buckets)],
                    cfg.vocab_size)
        rounds, prefills, launches = run["steps"], run["prefills"], run["launches"]
        check_launches(launches, {"spec_tail_attention": per_round * rounds,
                                  "spec_tail_attention_merge": SPEC_MERGES_PER_ROUND * rounds,
                                  "w4_matmul_sm90": 7 * (L * prefills + per_round * rounds) if w4 else 0},
                       f"spec serve {serve_cfg.weight_format} ({rounds} rounds, {prefills} prefills)")
        stages = run["stages"]
        spec_s = stages["draft"] + stages["verify"] + stages["insert"]
        slot_rounds = run["spec_proposed"] / k
        res = {
            "weight_format": serve_cfg.weight_format,
            "spec_k": k,
            "draft_layers": Ld,
            **run["summary"],
            "rounds": rounds,
            "prefills": prefills,
            "launches": launches,
            "launches_per_round": {n: c / rounds for n, c in launches.items()},
            "ms_per_round": spec_s / rounds * 1e3,
            "acceptance_rate": run["spec_accepted"] / run["spec_proposed"],
            "tokens_per_round_per_slot": run["new_tokens"] / slot_rounds,
            "tokens_per_round": run["new_tokens"] / rounds,
            "stage_s": {s: stages[s] for s in ("prefill", "draft", "verify", "insert")},
            "prefill_ms_mean": stages["prefill"] / prefills * 1e3,
            "plain_same_call": {key: plain[key] for key in ("tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
                                                             "decode_step_ms", "prefill_ms_mean")},
            # bf16: verify's K/V come from M = S (k + 1) matmuls where the
            # plain loop's come from M = S, which may round otherwise
            "agreement_with_plain": agreement([r.tokens for r in run["reqs"]], plain["tokens"]),
            "kernel_probe_us": engine.kernel_probe(),
        }
        log(f"spec serve {serve_cfg.weight_format}: {json.dumps(res)}")
        if w4:
            return res

        # teacher-forced: a 5-token tail through verify_forward, kernels
        # against plain, and each of its rows against decode_forward stepped
        # one token at a time (comparison launches, not counted above)
        S, T = serve_cfg.max_batch, serve_cfg.max_context
        g = torch.Generator(device=dev).manual_seed(6)
        tail = torch.randint(0, cfg.vocab_size, (S, k + 1), generator=g, device=dev)
        lens = torch.tensor([0, 5, 63, 300, 700, T - 5, 1100, 2000][:S], dtype=torch.int32, device=dev)
        res["verify_compare"] = []
        # tolerances of phase 4: f32 sums in another order over 22 layers;
        # bf16 roundings at other points (and matmuls at another M)
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 0.25)):
            ck, cv = engine.cache_k.to(dtype, copy=True), engine.cache_v.to(dtype, copy=True)
            got, _, _ = verify_forward(engine.params, tail, lens, ck, cv, cfg, compute_dtype=dtype)
            ref, _, _ = verify_forward(engine.params, tail, lens, ck, cv, cfg, compute_dtype=dtype, kernels=False)
            steps = []
            for i in range(k + 1):
                step, _, _ = decode_forward(engine.params, tail[:, i], lens + i, ck, cv, cfg, compute_dtype=dtype)
                steps.append(step)
            stepped = torch.stack(steps, dim=1)
            del ck, cv
            if not all(bool(torch.isfinite(o).all()) for o in (got, ref, stepped)):
                raise AssertionError("non-finite verify logits")
            e_plain = float((got - ref).abs().max())
            e_step = float((got - stepped).abs().max())
            agree = int((got.argmax(-1) == stepped.argmax(-1)).sum())
            res["verify_compare"].append({"dtype": str(dtype).removeprefix("torch."), "tol": tol,
                                          "kernels_vs_plain": e_plain, "verify_vs_stepped_decode": e_step,
                                          "argmax_agree_with_stepped": f"{agree}/{S * (k + 1)}"})
            log(f"verify_forward {dtype}: kernels vs plain max |d logits| = {e_plain:.3e}, vs stepped "
                f"decode_forward {e_step:.3e} (tol {tol}), argmax agree {agree}/{S * (k + 1)}")
            if not (e_plain <= tol and e_step <= tol):
                raise AssertionError(f"verify logits {dtype}: {e_plain}, {e_step} > {tol}")
        return res
    finally:
        plane.stop()


def prefix_prompts(vocab: int, seed: int = 5) -> list:
    """16 prompts: one 192-token system prompt, then 8-200 tokens each."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, 192).tolist()
    return [system + rng.integers(1, vocab, int(n)).tolist() for n in rng.integers(8, 201, N_REQUESTS)]


def phase_prefix(torch, tdk, cfg, params, dev) -> dict:
    """``build_serving`` with ``spec_decode_k`` 4 and ``prefix_cache`` on,
    then off, on the same 16 prompts sharing a 192-token system prompt,
    all submitted at once. With it on, at least 7 admits reuse a live
    slot's prefix, and B7 runs 22 times per hit (the suffix pass) and 66
    per round, its merge 66 per round and 22 per hit whose suffix pads to
    a bucket in SUFFIX_MERGES with a merge (the suffix lengths recorded as
    the batcher admits each hit). Then a prefix-reused admit's logits
    against a cold admit's at config_1b in f32."""
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.serve import ServeEngine, build_serving
    from opendiloco_torch.serve.kvcache import pick_bucket

    L = cfg.num_hidden_layers
    prompts = prefix_prompts(cfg.vocab_size)
    runs = {}
    for on in (True, False):
        serve_cfg = ServeConfig(spec_decode_k=4, prefix_cache=on)
        plane = build_serving(serve_cfg, cfg, params, device=dev, start_server=False)
        suffixes = []  # the suffix length of each prefix hit, in admission order
        admit = plane.engine.admit

        def recording_admit(slot, prompt, *, prefix_src=None, prefix_len=0, **kw):
            if prefix_src is not None and 0 < prefix_len < len(prompt):
                suffixes.append(len(prompt) - prefix_len)
            return admit(slot, prompt, prefix_src=prefix_src, prefix_len=prefix_len, **kw)

        plane.engine.admit = recording_admit
        try:
            per_round = plane.engine.spec_k * plane.engine.draft_layers + L
            # warm-up: two prompts that share the system prompt (a suffix pass when on)
            run = drive(tdk, plane, prompts, [prompts[0][:200], prompts[1][:196]], cfg.vocab_size)
            hits, rounds = run["prefix_hits"], run["steps"]
            # the main run's hits are the last ones recorded (the warm-up's came first)
            buckets = [pick_bucket(n, serve_cfg.prefill_buckets) for n in suffixes[len(suffixes) - hits:]]
            if len(buckets) != hits:
                raise AssertionError(f"prefix_cache={on}: {len(suffixes)} suffix passes recorded for {hits} hits")
            check_launches(run["launches"], {"spec_tail_attention": L * hits + per_round * rounds,
                                             "spec_tail_attention_merge": SPEC_MERGES_PER_ROUND * rounds +
                                             L * sum(SUFFIX_MERGES[b] for b in buckets)},
                           f"prefix_cache={on} ({hits} hits, suffix buckets {buckets}, {rounds} rounds)")
            if on and hits < 7:
                raise AssertionError(f"prefix_cache on: {hits} prefix hits, want at least 7")
            if not on and hits:
                raise AssertionError(f"prefix_cache off: {hits} prefix hits")
            runs[on] = {"prefix_cache": on, **run["summary"], "prefix_hits": hits, "hit_suffix_buckets": buckets,
                        "rounds": rounds,
                        "launches": run["launches"], "prefill_ms_mean": run["stages"]["prefill"] / 16 * 1e3,
                        "tokens": [r.tokens for r in run["reqs"]]}
        finally:
            plane.stop()
        del plane
        torch.cuda.empty_cache()
    res = {
        "on": runs[True],
        "off": runs[False],
        "ttft_p50_on_over_off": runs[True]["ttft_p50_ms"] / runs[False]["ttft_p50_ms"],
        "agreement_on_vs_off": agreement(runs[True].pop("tokens"), runs[False].pop("tokens")),
    }

    # a prefix-reused admit against a cold admit of the same prompt, f32
    eng = ServeEngine(cfg, params, num_slots=2, max_context=1024, prefill_buckets=(64, 256, 1024),
                      compute_dtype=torch.float32, device=dev)
    _, cold = eng.admit(1, prompts[1])
    eng.admit(0, prompts[0])
    _, warm = eng.admit(1, prompts[1], prefix_src=0, prefix_len=192)
    err = float(np.abs(warm - cold).max())
    res["prefix_admit_vs_cold_f32"] = {"max_abs_err": err, "tol": 1e-3, "argmax_equal": int(warm.argmax()) ==
                                       int(cold.argmax())}
    del eng
    torch.cuda.empty_cache()
    log(f"prefix serve: {json.dumps(res)}")
    # f32 sums in another order over 22 layers, as phase 4
    if not err <= 1e-3:
        raise AssertionError(f"prefix-reused admit logits differ from a cold admit's by {err}")
    return res


def phase_spec_f32(torch, cfg, params, dev) -> dict:
    """Phase 12's plain and spec loops at config_1b with f32 compute, on 4
    of its 16 requests (one in four, over all three buckets): the spec
    streams must equal the plain loop's token for token. In bf16 they
    agree on few requests; in f32 the verify pass at M = S (k + 1) and the
    decode step at M = S differ only by f32 rounding."""
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.ops import decode_kernels as tdk
    from opendiloco_torch.serve import build_serving

    L = cfg.num_hidden_layers
    prompts = prompts_over_buckets(ServeConfig(), cfg.vocab_size)[::4]
    streams, launches = {}, {}
    for k in (0, SPEC_K):
        plane = build_serving(ServeConfig(spec_decode_k=k), cfg, params, compute_dtype=torch.float32, device=dev,
                              start_server=False)
        try:
            base = plane.batcher.stats()["decode_steps"]
            tdk.LAUNCHES.reset()
            reqs = [plane.batcher.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
            for r in reqs:
                if not r.wait(1200) or r.error is not None:
                    raise AssertionError(f"f32 serving request failed: {r.error}")
            launches[k] = tdk.LAUNCHES.snapshot()
            steps = plane.batcher.stats()["decode_steps"] - base
            streams[k] = [r.tokens for r in reqs]
            if k == 0:
                # f32 B6 takes the split kernel: 22 a decode step, each merging once
                want = {"paged_decode_attention": L * steps,
                        "paged_decode_attention_merge": PAGED_MERGES_PER_STEP * steps}
            else:
                per_round = k * plane.engine.draft_layers + L
                want = {"spec_tail_attention": per_round * steps,
                        "spec_tail_attention_merge": SPEC_MERGES_PER_ROUND * steps}
            check_launches(launches[k], want, f"f32 serve spec_k {k} ({steps} decode steps or rounds)")
        finally:
            plane.stop()
        del plane
        torch.cuda.empty_cache()
    res = {"requests": len(prompts), "new_tokens": NEW_TOKENS, "spec_k": SPEC_K,
           "agreement": agreement(streams[SPEC_K], streams[0]),
           "launches": {"plain": launches[0], "spec": launches[SPEC_K]}}
    log(f"spec vs plain, f32 compute, config_1b: {json.dumps(res)}")
    if streams[SPEC_K] != streams[0]:
        raise AssertionError(f"f32 spec streams differ from the plain loop's: {res['agreement']}")
    return res


def phase_spec_reference(torch, cfg, dev) -> list:
    """config_2m in f32 through ServeEngine with spec_k 3: the token
    streams on the card (kernels) equal the plain decode loop's on the
    card and the spec engine's on the CPU (plain versions)."""
    from opendiloco_torch.models.llama import shapes
    from opendiloco_torch.serve import ServeEngine

    rng = np.random.default_rng(7)
    params = np_params(shapes(cfg), rng)
    prompt = rng.integers(1, cfg.vocab_size, 11).tolist()
    n = 40  # past the 32-row ring: the draft and verify masks slide

    def stream(d, spec_k):
        eng = ServeEngine(cfg, params, num_slots=2, max_context=32, prefill_buckets=(16,),
                          compute_dtype=torch.float32, device=d, spec_k=spec_k)
        tok, _ = eng.admit(0, prompt)
        toks = [tok]
        while len(toks) < n:
            lens, cur = np.asarray([len(prompt) + len(toks) - 1, 0], np.int32), np.asarray([toks[-1], 0], np.int32)
            if spec_k:
                g, m = eng.spec_step(cur, lens)
                toks.extend(int(t) for t in g[0, : int(m[0]) + 1])
            else:
                toks.append(int(eng.decode_step(cur, lens)[0][0]))
        return toks[:n]

    streams = {"card spec": stream(dev, 3), "card plain": stream(dev, 0), "cpu spec": stream(torch.device("cpu"), 3)}
    log(f"reference config_2m spec_k 3, f32: {n} tokens; card spec == card plain == CPU spec: "
        f"{streams['card spec'] == streams['card plain'] == streams['cpu spec']}")
    if not streams["card spec"] == streams["card plain"] == streams["cpu spec"]:
        raise AssertionError(f"config_2m spec streams differ: {streams}")
    return [{"config": "2m", "spec_k": 3, "tokens": n, "streams_equal": True}]


# ---------------------------------------------------------------------------
# phase 22: the host KV tier
# ---------------------------------------------------------------------------

TIER_SLOTS = 4  # decode slots of the tier runs: 12 requests share them
TIER_REQUESTS = 12
TIER_HOST_SLOTS = 16


def tier_page_cost(torch, engine, rows_list=(256, 1024), reps: int = 5) -> dict:
    """A page's cost on the engine of a finished run: page-out (gather,
    D2H into pinned memory, wait) and page-in (H2D from pinned memory,
    cast, write) ms at the median of ``reps``, each ending in a sync; a
    restore into another slot must give the source rows bit for bit
    (bf16 -> f32 -> bf16). Then the host tier's encode and decode s and
    stored bytes of a full page under each codec."""
    from opendiloco_torch.serve import HostKVTier

    out = {"ms": {}, "codecs": {}}
    page = None
    for rows in rows_list:
        t_out, t_in = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pk, pv = engine.fetch_slot_pages(0, rows)
            k, v = np.asarray(pk), np.asarray(pv)
            t1 = time.perf_counter()
            engine.install_slot_pages(1, k, v)
            torch.cuda.synchronize()
            t_in.append(time.perf_counter() - t1)
            t_out.append(t1 - t0)
        for cache in (engine.cache_k, engine.cache_v):
            if not torch.equal(cache[:, 1, :rows], cache[:, 0, :rows]):
                raise AssertionError(f"tier page of {rows} rows: restored rows differ from the source rows")
        out["ms"][rows] = {"page_out_ms": float(np.median(t_out)) * 1e3, "page_in_ms": float(np.median(t_in)) * 1e3,
                           "f32_bytes": int(k.nbytes + v.nbytes)}
        page = (k, v)
    for codec in ("none", "blockwise4bit"):
        tier = HostKVTier(host_slots=2, codec=codec)
        t0 = time.perf_counter()
        tier.put_paused(0, *page)
        t1 = time.perf_counter()
        stored = tier.stored_bytes()
        rk, rv = tier.pop_paused(0)
        t2 = time.perf_counter()
        err = float(max(np.abs(rk - page[0]).max(), np.abs(rv - page[1]).max()))
        if codec == "none" and err != 0.0:
            raise AssertionError(f"tier codec none: restore error {err}")
        out["codecs"][codec] = {"encode_s": t1 - t0, "decode_s": t2 - t1, "stored_bytes": stored,
                                "max_abs_restore_err": err}
    return out


def phase_tier(torch, tdk, cfg, params, dev) -> dict:
    """Phase 22: the host KV tier at config_1b, bf16, w4 weights, 4 decode
    slots, 12 of phase 4's prompts at once, 48 tokens each:
    (a) tier off; (b) ``kv_tier`` on, codec none, 16 host slots: evictions
        > 0, resumes equal to evictions, nothing paused at the end, every
        stream equal to (a)'s, launches as phase 5's per decode step and
        prefill; (c) codec blockwise4bit: every request completes, its
        agreement with (a) recorded;
    then the page cost (``tier_page_cost``), and
    (d) the host prefix store (``prefix_cache`` and the tier on): one of
        phase 13's shared-prefix prompts, then, after it retired, another:
        one host hit, B7 22 times for its suffix pass, the installed rows
        bit for bit what a cold prefill of the first prompt writes, and in
        f32 the host-prefix admit's logits against a cold admit's."""
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.serve import ServeEngine, build_serving
    from opendiloco_torch.serve.kvcache import pick_bucket, prefix_grid_lengths

    L = cfg.num_hidden_layers
    base_cfg = ServeConfig(weight_format="w4", max_batch=TIER_SLOTS)
    prompts = prompts_over_buckets(base_cfg, cfg.vocab_size)[:TIER_REQUESTS]
    warm = [p[:b] for p, b in zip(prompts, base_cfg.prefill_buckets)]
    rep = cfg.num_attention_heads // cfg.kv_heads
    merges = int(tdk.spec_tail_splits(TIER_SLOTS, base_cfg.max_context, cfg.kv_heads, rep,
                                      torch.cuda.get_device_properties(dev).multi_processor_count) > 1)
    runs, res = {}, {}
    for name, tier in (("a", {}), ("b", dict(kv_tier=True, kv_tier_codec="none")),
                       ("c", dict(kv_tier=True, kv_tier_codec="blockwise4bit"))):
        scfg = ServeConfig(weight_format="w4", max_batch=TIER_SLOTS, kv_host_slots=TIER_HOST_SLOTS, **tier)
        plane = build_serving(scfg, cfg, params, device=dev, start_server=False)
        try:
            run = drive(tdk, plane, prompts, warm, cfg.vocab_size)
            st = plane.batcher.stats()
        finally:
            plane.stop()
        steps, prefills = run["steps"], run["prefills"]
        check_launches(run["launches"], {"paged_decode_attention": L * steps,
                                         "paged_decode_attention_merge": L * steps * merges,
                                         "w4_matmul_sm90": 7 * L * (prefills + steps)},
                       f"tier ({name}) ({steps} decode steps, {prefills} prefills)")
        runs[name] = run
        res[name] = {**run["summary"], "decode_steps": steps, "launches": run["launches"], "tier": st["tier"],
                     "stages_s": {k: run["stages"][k] for k in ("prefill", "decode", "page_out", "page_in")}}
        if name == "b":
            tier_st = st["tier"]
            if not (tier_st["evictions"] > 0 and tier_st["resumes"] == tier_st["evictions"]
                    and tier_st["paused"] == 0):
                raise AssertionError(f"tier (b): {tier_st}")
            got, want = [r.tokens for r in run["reqs"]], [r.tokens for r in runs["a"]["reqs"]]
            if got != want:
                raise AssertionError(f"tier (b): streams differ from (a)'s: {agreement(got, want)}")
            res["page_cost"] = tier_page_cost(torch, plane.engine)
        if name == "c":
            res["c"]["agreement_with_a"] = agreement([r.tokens for r in run["reqs"]],
                                                     [r.tokens for r in runs["a"]["reqs"]])
        del plane
        torch.cuda.empty_cache()
    res["b_over_a"] = {k: res["b"][k] / res["a"][k] for k in ("tokens_per_s", "ttft_p50_ms", "ttft_max_ms")}

    # (d) the host prefix store: the first prompt's 128-row prefix is stored
    # after its cold prefill; the second looks it up once the first retired
    shared = prefix_prompts(cfg.vocab_size)
    first, second = shared[0][:200], shared[1]
    glen = prefix_grid_lengths(len(first))[0]
    scfg = ServeConfig(weight_format="w4", max_batch=TIER_SLOTS, kv_tier=True, kv_host_slots=TIER_HOST_SLOTS,
                       prefix_cache=True)
    plane = build_serving(scfg, cfg, params, device=dev, start_server=False)
    engine, batcher = plane.engine, plane.batcher
    hosted = []  # (slot, plen) of each host-prefix admit
    admit = engine.admit

    def recording_admit(slot, prompt, *, host_prefix=None, **kw):
        if host_prefix is not None:
            hosted.append((slot, int(host_prefix[2])))
        return admit(slot, prompt, host_prefix=host_prefix, **kw)

    engine.admit = recording_admit
    try:
        for r in [batcher.submit([3, 4, 5], max_new_tokens=2)]:
            if not r.wait(600) or r.error is not None:
                raise AssertionError(f"tier (d) warm-up failed: {r.error}")
        base = batcher.stats()
        tdk.LAUNCHES.reset()
        ra = batcher.submit(first, max_new_tokens=NEW_TOKENS)
        if not ra.wait(600) or ra.error is not None:
            raise AssertionError(f"tier (d): first prompt failed: {ra.error}")
        deadline = time.monotonic() + 60
        while batcher.kv_tier.prefix_count == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        rb = batcher.submit(second, max_new_tokens=NEW_TOKENS)
        if not rb.wait(600) or rb.error is not None:
            raise AssertionError(f"tier (d): second prompt failed: {rb.error}")
        launches = tdk.LAUNCHES.snapshot()
        st = batcher.stats()
    finally:
        plane.stop()
    hits = st["prefix"]["host_hits"] - base["prefix"]["host_hits"]
    steps = st["decode_steps"] - base["decode_steps"]
    if hits != 1 or len(hosted) != 1 or hosted[0][1] != glen:
        raise AssertionError(f"tier (d): {hits} host hits, admits {hosted}, want one at {glen} rows")
    suffix_bucket = pick_bucket(len(second) - glen, scfg.prefill_buckets)
    check_launches(launches, {"spec_tail_attention": L, "spec_tail_attention_merge": L * SUFFIX_MERGES[suffix_bucket],
                              "paged_decode_attention": L * steps,
                              "paged_decode_attention_merge": L * steps * merges,
                              "w4_matmul_sm90": 7 * L * (2 + steps)},
                   f"tier (d) ({hits} host hit, suffix bucket {suffix_bucket}, {steps} decode steps)")
    # the installed rows against a cold prefill of the first prompt, which
    # pads to the same bucket: the same kernels give the same bits
    slot = hosted[0][0]
    installed = [c[:, slot, :glen].clone() for c in (engine.cache_k, engine.cache_v)]
    admit(slot ^ 1, first)
    for got, cache in zip(installed, (engine.cache_k, engine.cache_v)):
        if not torch.equal(got, cache[:, slot ^ 1, :glen]):
            raise AssertionError("tier (d): installed prefix rows differ from a cold prefill's")
    res["d"] = {"host_hits": hits, "prefix_rows": glen, "prompt_lengths": [len(first), len(second)],
                "suffix_bucket": suffix_bucket, "decode_steps": steps, "launches": launches,
                "ttft_ms": [ra.ttft_s * 1e3, rb.ttft_s * 1e3], "tier": st["tier"]}
    del plane, engine, installed
    torch.cuda.empty_cache()

    # f32: the host-prefix admit's first-token logits against a cold admit's
    eng = ServeEngine(cfg, params, num_slots=2, max_context=1024, prefill_buckets=(64, 256, 1024),
                      compute_dtype=torch.float32, device=dev)
    _, cold = eng.admit(1, second)
    eng.admit(0, first)
    hk, hv = (np.asarray(p) for p in eng.fetch_slot_pages(0, glen))
    _, warm_row = eng.admit(1, second, host_prefix=(hk, hv, glen))
    err = float(np.abs(warm_row - cold).max())
    res["d"]["host_prefix_admit_vs_cold_f32"] = {"max_abs_err": err, "tol": 1e-3,
                                                 "argmax_equal": int(warm_row.argmax()) == int(cold.argmax())}
    del eng
    torch.cuda.empty_cache()
    log(f"kv tier: {json.dumps(res)}")
    # f32 sums in another order over 22 layers, as phase 13
    if not err <= 1e-3:
        raise AssertionError(f"tier (d): host-prefix admit logits differ from a cold admit's by {err}")
    return res


# ---------------------------------------------------------------------------
# phase 6: small-input reference, card against CPU
# ---------------------------------------------------------------------------


def np_params(tree, rng, name: str = ""):
    """Weights in the JAX layout drawn with numpy: N(0, 0.02), norms near 1."""
    if isinstance(tree, dict):
        return {k: np_params(v, rng, k) for k, v in tree.items()}
    base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
    return (base + scale * rng.standard_normal(tree)).astype(np.float32)


def phase_reference(torch, cfg, dev) -> list:
    """config_2m through ServeEngine on the card (kernels) and on the CPU
    (plain versions): the prefill logits and 4 teacher-forced decode steps'
    logits in f32, both weight formats (atol 1e-4: sums reassociate). The
    w4 packer must give the same bits on both devices."""
    from opendiloco_torch.models.llama import PackedW4, shapes
    from opendiloco_torch.serve import ServeEngine

    rng = np.random.default_rng(4)
    params = np_params(shapes(cfg), rng)
    prompt = rng.integers(1, cfg.vocab_size, 11).tolist()
    follow = rng.integers(1, cfg.vocab_size, 4).tolist()
    errs = []
    for fmt in ("fp32", "w4"):
        runs = []  # (logits, layer weights) on the card, then on the CPU
        for d in (dev, torch.device("cpu")):
            eng = ServeEngine(cfg, params, num_slots=2, max_context=32, prefill_buckets=(16,),
                              compute_dtype=torch.float32, weight_format=fmt, device=d)
            _, row = eng.admit(0, prompt)
            rows = [torch.as_tensor(row)]
            for i, tok in enumerate(follow):
                _, logits = eng.decode_step(np.asarray([tok, 0], np.int32),
                                            np.asarray([len(prompt) + i, 0], np.int32))
                rows.append(logits[0].cpu())
            runs.append((torch.stack(rows), eng.params["layers"]))
        (card_logits, card_layers), (cpu_logits, cpu_layers) = runs
        for name, w in cpu_layers.items():
            if isinstance(w, PackedW4) and not (
                torch.equal(w.q, card_layers[name].q.cpu()) and torch.equal(w.s, card_layers[name].s.cpu())
            ):
                raise AssertionError(f"w4 packing of {name} differs between card and CPU")
        err = float((card_logits - cpu_logits).abs().max())
        errs.append({"config": "2m", "weight_format": fmt, "max_abs_err": err, "tol": 1e-4})
        log(f"reference config_2m {fmt}: card vs CPU max |d logits| = {err:.3e} (tol 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"config_2m {fmt}: card vs CPU logits differ by {err}")
    return errs


# ---------------------------------------------------------------------------
# phase 7: B1, B2a, B2b flash attention
# ---------------------------------------------------------------------------

FLASH_NAMES = ("flash_attention_fwd_sm90", "flash_attention_delta", "flash_attention_dq_sm90",
               "flash_attention_dkv_sm90", "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
FLASH_SOURCES = {
    "flash_attention_fwd_sm90": "opendiloco_torch/csrc/flash_attention_fwd_sm90.cu",
    "flash_attention_delta": "opendiloco_torch/csrc/flash_attention_delta.cu",
    "flash_attention_fwd": "opendiloco_torch/csrc/flash_attention.cu",
    "flash_attention_dq_sm90": "opendiloco_torch/csrc/flash_attention_bwd_sm90.cu",
    "flash_attention_dkv_sm90": "opendiloco_torch/csrc/flash_attention_bwd_sm90.cu",
    "flash_attention_dq": "opendiloco_torch/csrc/flash_attention.cu",
    "flash_attention_dkv": "opendiloco_torch/csrc/flash_attention.cu",
}
FLASH_REPLACES = {
    "flash_attention_fwd": "opendiloco_tpu/ops/flash_attention.py:136 (_fwd, _fwd_kernel :53)",
    "flash_attention_dq": "opendiloco_tpu/ops/flash_attention.py:320 (_bwd_impl, _dq_kernel :175)",
    "flash_attention_dkv": "opendiloco_tpu/ops/flash_attention.py:363 (_bwd_impl, _dkv_kernel :223)",
    "flash_attention_delta": "XLA `_delta`, opendiloco_tpu/ops/flash_attention.py:280, no pallas_call",
}
FLASH_REPLACES["flash_attention_fwd_sm90"] = FLASH_REPLACES["flash_attention_fwd"]
FLASH_REPLACES["flash_attention_dq_sm90"] = FLASH_REPLACES["flash_attention_dq"]
FLASH_REPLACES["flash_attention_dkv_sm90"] = FLASH_REPLACES["flash_attention_dkv"]
# (label, B, T, H, Hkv, D, causal) of the checks, each in f32 and bf16;
# bf16 at D 32, 64 and 128 takes the sm90 kernels, the rest the first design.
# 150m and 1b heads are the shapes phases 8 and 10 launch (at B 8 the
# persistent sm90 B1 runs about 16 q tiles a CTA on its ring)
FLASH_GEOMS = [
    ("150m", 8, 1024, 16, 16, 64, True),
    ("1b heads", 8, 1024, 32, 4, 64, True),
    ("odd T", 2, 1000, 16, 16, 64, True),
    ("150m full", 2, 1024, 16, 16, 64, False),
    ("D 32, T 200", 2, 200, 8, 8, 32, True),
    ("D 128, T 200, full", 2, 200, 8, 2, 128, False),
    ("T 64, rep 8", 2, 64, 8, 1, 64, True),
    ("D 40", 2, 300, 8, 2, 40, True),
]
# timed in bf16: the 1b head geometry (what phase 10's main path gives the
# kernels) and the 150m training shape
FLASH_TIMED = {"1b heads": (8, 1024, 32, 4, 64), "150m": (8, 1024, 16, 16, 64)}
FLASH_TOL = ("f32 1e-5 of the largest output; bf16 2**-6 of each (batch, head)'s largest output; "
             "lse 1e-4 of the largest |lse|; delta 1e-6 of the largest |delta|")
F32_FLOP_PER_S = 67e12  # the first design's f32 kernels use the FMA units


def flash_inputs(torch, dev, B, T, H, Hkv, D, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, H, D))
    return [torch.randn(*s, generator=g, device=dev).to(dtype) for s in shapes]


def flash_work(B, T, H, Hkv, D, elt, causal) -> dict:
    """(bytes, flops) each kernel must move and do on these inputs: every
    input read once and every output written once; score pairs counted as
    the mask leaves them (T (T + 1) / 2 per head when causal)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    qb, kvb, stat = B * T * H * D * elt, B * T * Hkv * D * elt, B * H * T * 4
    mm = 2.0 * B * H * D * pairs  # one [T x T] x [T x D] product over the pairs
    fwd = (qb + 2 * kvb + qb + stat, 2 * mm)
    dq = (2 * qb + 2 * kvb + 2 * stat + qb, 3 * mm)
    dkv = (2 * qb + 2 * kvb + 2 * stat + 2 * kvb, 4 * mm)
    return {"flash_attention_fwd": fwd, "flash_attention_fwd_sm90": fwd,
            "flash_attention_delta": (2 * qb + stat, 2.0 * B * T * H * D),
            "flash_attention_dq": dq, "flash_attention_dq_sm90": dq,
            "flash_attention_dkv": dkv, "flash_attention_dkv_sm90": dkv}


def flash_check(torch, checks, label, geom, dtype, got, refs) -> None:
    """Hold each output against its plain version; record under the kernel
    that computed it."""
    B, T, H, Hkv, D, causal = geom
    for key, (kernel, out) in got.items():
        ref = refs[key].float()
        err = (out.float() - ref).abs().amax(dim=(1, 3))  # per (batch, head)
        if dtype == torch.float32:
            # only the order of f32 sums differs
            tol = torch.full_like(err, 1e-5 * max(1.0, float(ref.abs().max())))
        else:
            # p and ds round to bf16 at points that differ by f32 rounding
            # (p at each tile's running max in B1) and the outputs round to
            # bf16: 2**-6 of each head's largest
            tol = 2.0**-6 * ref.abs().amax(dim=(1, 3))
        worst = float((err / tol).max())
        checks[kernel].append({"shape": label, "B": B, "T": T, "H": H, "Hkv": Hkv, "D": D, "causal": causal,
                               "dtype": str(dtype).removeprefix("torch."), "output": key,
                               "max_abs_err": float(err.max()), "worst_err_over_tol": worst})
        if not bool((err <= tol).all()):
            raise AssertionError(f"{kernel} {key} {label} {dtype}: error/tol {worst}")


def phase_flash(torch, tfa, dev) -> list:
    """B1, B2a, B2b and the delta kernel against their plain versions (the
    same lse and delta feed both backward paths) on both routes, then
    device times in bf16 at the 1b head geometry and the 150m training
    shape, and of the first design's f32 backward at the 150m shape (its
    main path)."""
    import torch.nn.functional as F

    checks = {name: [] for name in FLASH_NAMES}
    for gi, (label, *geom) in enumerate(FLASH_GEOMS):
        B, T, H, Hkv, D, causal = geom
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(torch, dev, B, T, H, Hkv, D, dtype, 10 + gi)
            ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
            # the same delta feeds the kernels and the plain versions
            delta = tfa.attention_delta_plain(do, ref_out)
            got_delta = tfa.attention_delta(do, ref_out)
            torch.cuda.synchronize()
            delta_err, delta_tol = float((got_delta - delta).abs().max()), 1e-6 * float(delta.abs().max())
            checks["flash_attention_delta"].append(
                {"shape": label, "B": B, "T": T, "H": H, "D": D, "dtype": str(dtype).removeprefix("torch."),
                 "output": "delta", "max_abs_err": delta_err, "worst_err_over_tol": delta_err / delta_tol})
            if not delta_err <= delta_tol:
                raise AssertionError(f"delta {label} {dtype}: {delta_err} over {delta_tol}")
            routes = [(tfa._fwd_route(dtype, D), tfa._bwd_route(dtype, D))]
            if label == "150m" and tfa._on_sm90(dtype, D):
                routes.append((tfa.SOURCE, tfa.SOURCE))  # the first design in bf16: the same-call yardstick
            refs = {"out": ref_out, "dq": tfa.flash_attention_dq_plain(q, k, v, do, ref_lse, delta, causal)}
            refs["dk"], refs["dv"] = tfa.flash_attention_dkv_plain(q, k, v, do, ref_lse, delta, causal)
            lse_tol = 1e-4 * max(1.0, float(ref_lse.abs().max()))
            for fwd_route, route in routes:
                sfx = "" if route == tfa.SOURCE else "_sm90"
                out, lse = tfa._fwd_kernel(q, k, v, causal, route=fwd_route)
                got = {"out": ("flash_attention_fwd" + sfx, out)}
                got["dq"] = ("flash_attention_dq" + sfx, tfa._dq_kernel(q, k, v, do, ref_lse, delta, causal, None,
                                                                        route=route))
                dk, dv = tfa._dkv_kernel(q, k, v, do, ref_lse, delta, causal, None, route=route)
                got["dk"], got["dv"] = ("flash_attention_dkv" + sfx, dk), ("flash_attention_dkv" + sfx, dv)
                torch.cuda.synchronize()
                flash_check(torch, checks, label, geom, dtype, got, refs)
                lse_err = float((lse - ref_lse).abs().max())
                checks["flash_attention_fwd" + sfx].append(
                    {"shape": label, "B": B, "T": T, "H": H, "Hkv": Hkv, "D": D, "causal": causal,
                     "dtype": str(dtype).removeprefix("torch."), "output": "lse", "max_abs_err": lse_err,
                     "worst_err_over_tol": lse_err / lse_tol})
                if not lse_err <= lse_tol:
                    raise AssertionError(f"B1{sfx} lse {label} {dtype}: {lse_err}")
            del q, k, v, do, out, lse, dk, dv, refs, got, ref_out, ref_lse, delta, got_delta
        log(f"B1/B2a/B2b/delta {label} (B{B} T{T} H{H}/{Hkv} D{D} causal={causal}): f32 and bf16 within "
            "tolerance")
    torch.cuda.empty_cache()

    def sdpa(q, k, v):
        # GQA through enable_gqa: k and v keep their Hkv heads
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                              is_causal=True, enable_gqa=q.shape[2] != k.shape[2])

    def sdpa_fwd_bwd(q, k, v, do):
        return torch.autograd.grad(sdpa(q, k, v), (q, k, v), do.transpose(1, 2))

    def calls(route):
        dq = lambda q, k, v, do, lse, dl: tfa._dq_kernel(q, k, v, do, lse, dl, True, None, route=route)
        dkv = lambda q, k, v, do, lse, dl: tfa._dkv_kernel(q, k, v, do, lse, dl, True, None, route=route)
        return dq, dkv

    plain = {
        "flash_attention_fwd": lambda q, k, v, do, lse, dl: tfa.flash_attention_fwd_plain(q, k, v, True),
        "dq": lambda q, k, v, do, lse, dl: tfa.flash_attention_dq_plain(q, k, v, do, lse, dl, True),
        "dkv": lambda q, k, v, do, lse, dl: tfa.flash_attention_dkv_plain(q, k, v, do, lse, dl, True),
    }

    def input_sets(B, T, H, Hkv, D, dtype, work):
        sets, outs = [], []
        for i in range(copies_for(int(work["flash_attention_fwd"][0]))):
            q, k, v, do = flash_inputs(torch, dev, B, T, H, Hkv, D, dtype, 100 + i)
            out, lse = tfa.flash_attention_fwd(q, k, v, True)
            sets.append((q, k, v, do, lse, tfa.attention_delta(do, out)))
            outs.append((do, out))
        return sets, outs

    timed = {}  # geometry -> kernel -> numbers
    for geo, (B, T, H, Hkv, D) in FLASH_TIMED.items():
        work = flash_work(B, T, H, Hkv, D, 2, True)
        sets, outs = input_sets(B, T, H, Hkv, D, torch.bfloat16, work)
        new_dq, new_dkv = calls(tfa.SM90_SOURCE)
        old_dq, old_dkv = calls(tfa.SOURCE)
        # both routes of each direction, the first design through route=
        fns = {"flash_attention_fwd_sm90": (lambda q, k, v, do, lse, dl: tfa._fwd_kernel(
                   q, k, v, True, route=tfa.SM90_FWD_SOURCE), None),
               "flash_attention_fwd": (lambda q, k, v, do, lse, dl: tfa._fwd_kernel(q, k, v, True, route=tfa.SOURCE),
                                       plain["flash_attention_fwd"]),
               "flash_attention_dq_sm90": (new_dq, None), "flash_attention_dkv_sm90": (new_dkv, None),
               "flash_attention_dq": (old_dq, plain["dq"]), "flash_attention_dkv": (old_dkv, plain["dkv"])}
        rows = {}
        for name, (kern, pl) in fns.items():
            b_ms, b_by = bound_ms(*work[name])
            rows[name] = {"ms": device_ms(torch, kern, sets, launches=32), "host_us": host_us(torch, kern, sets),
                          "bound_ms": b_ms, "bound_by": b_by}
            # the plain versions repeat the kernels' arithmetic; both routes
            # share one plain version, timed once
            if pl is not None:
                rows[name]["plain_ms"] = device_ms(torch, pl, sets, launches=2, replays=3)
            torch.cuda.empty_cache()
        for name in ("flash_attention_fwd_sm90", "flash_attention_dq_sm90", "flash_attention_dkv_sm90"):
            rows[name]["plain_ms"] = rows[name.removesuffix("_sm90")]["plain_ms"]
        b_ms, b_by = bound_ms(*work["flash_attention_delta"])
        rows["flash_attention_delta"] = {"ms": device_ms(torch, tfa.attention_delta, outs, launches=32),
                                         "plain_ms": device_ms(torch, tfa.attention_delta_plain, outs, launches=32),
                                         "host_us": host_us(torch, tfa.attention_delta, outs),
                                         "plain_host_us": host_us(torch, tfa.attention_delta_plain, outs),
                                         "bound_ms": b_ms, "bound_by": b_by}
        # library yardstick, timed here only: SDPA forward, and its backward
        # through autograd (dq, dk and dv in one call, its own preprocess
        # included), taken as (forward + backward) - forward. No one call
        # computes delta in f32 from bf16 operands.
        sdpa_fwd_ms = device_ms(torch, lambda q, k, v, do, lse, dl: sdpa(q, k, v), sets, launches=32)
        leaves = [[t.detach().clone().requires_grad_(True) for t in st[:3]] + [st[3]] for st in sets]
        sdpa_bwd_ms = device_ms(torch, sdpa_fwd_bwd, leaves, launches=16) - sdpa_fwd_ms
        for name, row in rows.items():
            row["library_ms"] = (None if name == "flash_attention_delta" else
                                 sdpa_fwd_ms if "_fwd" in name else sdpa_bwd_ms)
        delta = rows["flash_attention_delta"]
        b2_new = rows["flash_attention_dq_sm90"]["ms"] + rows["flash_attention_dkv_sm90"]["ms"]
        timed[geo] = {"shape": {"B": B, "T": T, "H": H, "Hkv": Hkv, "D": D, "causal": True, "dtype": "bfloat16"},
                      "kernels": rows, "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
                      "attention_delta_ms": delta["ms"], "attention_delta_plain_ms": delta["plain_ms"],
                      "b2_new_plus_delta_ms": b2_new + delta["ms"],
                      "b2_new_plus_plain_delta_ms": b2_new + delta["plain_ms"],
                      "b2_old_plus_delta_ms": rows["flash_attention_dq"]["ms"] + rows["flash_attention_dkv"]["ms"]
                      + delta["ms"]}
        log(f"flash {geo} bf16 B{B} T{T} H{H}/{Hkv} D{D} causal: " + ", ".join(
            f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f}, host {r['host_us']:.1f} us a call)"
            for n, r in rows.items())
            + f"; sdpa fwd {sdpa_fwd_ms:.4f}, bwd {sdpa_bwd_ms:.4f}; attention_delta plain {delta['plain_ms']:.4f} ms;"
            f" sm90 B2a + B2b + delta kernel {b2_new + delta['ms']:.4f} ms against sdpa bwd {sdpa_bwd_ms:.4f}")
        del sets, outs, leaves
        torch.cuda.empty_cache()

    # the first design's f32 backward at the 150m shape: its main path
    # (phase 8's f32 inner step) runs it in f32, on the FMA units
    B, T, H, Hkv, D = FLASH_TIMED["150m"]
    work = flash_work(B, T, H, Hkv, D, 4, True)
    sets, outs = input_sets(B, T, H, Hkv, D, torch.float32, work)
    old_dq, old_dkv = calls(tfa.SOURCE)
    f32 = {}
    for name, kern in (("flash_attention_dq", old_dq), ("flash_attention_dkv", old_dkv)):
        nbytes, flops = work[name]
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        f32[name] = {"ms": device_ms(torch, kern, sets, launches=8),
                     "bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf else "operations"}
    del sets, outs
    torch.cuda.empty_cache()

    rows = []
    main = timed["1b heads"]
    for name in FLASH_NAMES:
        worst = max(checks[name], key=lambda c: c["worst_err_over_tol"])
        k = main["kernels"][name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": FLASH_SOURCES[name],
            "replaces": FLASH_REPLACES[name],
            "shape": main["shape"],
            "max_abs_err": worst["max_abs_err"],
            "tol": FLASH_TOL,
            "worst_check": worst,
            "checks": checks[name],
            "ms": k["ms"],
            "kernel_ms": k["ms"],
            "host_us": k["host_us"],
            **({"plain_host_us": k["plain_host_us"]} if "plain_host_us" in k else {}),
            "plain_ms": k["plain_ms"],
            "library_ms": k["library_ms"],
            "library": ("torch.nn.functional.scaled_dot_product_attention(is_causal=True, enable_gqa=True) forward"
                        if "_fwd" in name else
                        "none: no one call computes delta in f32 from bf16 operands"
                        if name == "flash_attention_delta" else
                        "its backward through autograd (dq, dk and dv in one call, with its own preprocess)"),
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "at_150m": {**timed["150m"]["kernels"][name], "shape": timed["150m"]["shape"]},
            **({"f32_at_150m": f32[name]} if name in f32 else {}),
        })
        if "_fwd" not in name:
            # B2a + B2b + the delta kernel against SDPA's backward, which
            # includes its own preprocess, like for like
            rows[-1]["same_call"] = {geo: {"sm90_b2a_b2b_plus_delta_ms": t["b2_new_plus_delta_ms"],
                                           "sm90_b2a_b2b_plus_plain_delta_ms": t["b2_new_plus_plain_delta_ms"],
                                           "first_design_b2a_b2b_plus_delta_ms": t["b2_old_plus_delta_ms"],
                                           "attention_delta_ms": t["attention_delta_ms"],
                                           "attention_delta_plain_ms": t["attention_delta_plain_ms"],
                                           "sdpa_bwd_ms": t["sdpa_bwd_ms"]} for geo, t in timed.items()}
    return rows


# ---------------------------------------------------------------------------
# phase 9: B3, B4a, B4b and the dlog kernel (fused lm-head + cross-entropy)
# ---------------------------------------------------------------------------

XENT_REPLACES = {
    "fused_xent_fwd": "opendiloco_tpu/ops/fused_xent.py:139 (_fwd, _fwd_kernel :85)",
    "fused_xent_dlog": "opendiloco_tpu/ops/fused_xent.py:174 (_recompute_dlog, inside _dh_kernel :195 and "
                       "_dw_kernel :219)",
    "fused_xent_dh": "opendiloco_tpu/ops/fused_xent.py:254 (_bwd_impl, _dh_kernel :195)",
    "fused_xent_dw": "opendiloco_tpu/ops/fused_xent.py:276 (_bwd_impl, _dw_kernel :219)",
}
XENT_REPLACES["fused_xent_fwd_sm90"] = XENT_REPLACES["fused_xent_fwd"]
XENT_REPLACES["fused_xent_dlog_sm90"] = XENT_REPLACES["fused_xent_dlog"]
XENT_REPLACES["fused_xent_dh_sm90"] = XENT_REPLACES["fused_xent_dh"]
XENT_REPLACES["fused_xent_dw_sm90"] = XENT_REPLACES["fused_xent_dw"]
# (label, N, D, V) of the checks, and the timed shape: the 1b training shape
# (its first 2048-row chunk for dlog, dh and dw), its ragged last chunk
# (8184 = 3 x 2048 + 2040), the 150m width, an odd N and V
XENT_GEOMS = [("1b", 8184, 2048, 32000), ("1b last chunk", 2040, 2048, 32000), ("150m width", 8184, 1024, 32000),
              ("odd N and V", 1000, 1024, 1000)]
XENT_TIMED = (8184, 2048, 32000)
XENT_TOL = ("element by element, |got - ref| <= rtol |ref| + atol: nll and lse atol 1e-4 of the largest lse "
            "(logits exact in f32 on both sides, sums in another order); dlog rtol 2**-7 in bf16 (one ulp where "
            "the f32 value sits at a rounding boundary) and 1e-5 in f32, atol rtol/2 * max(g) / V (half of rtol "
            "of an average softmax entry, so a wrong non-target entry fails); dh in bf16 rtol 2**-7 and atol 1e-5 "
            "of the largest |dh| (f32 sum-order noise where an element nearly cancels); dh in f32 atol 1e-4 of "
            "the largest |dh| (V-long sums in another order, about 2**-24 * sqrt(V)); dw atol 1e-5 of the "
            "largest |dw| (f32 sums)")
XENT_SOURCES = {name: "opendiloco_torch/csrc/fused_xent_sm90.cu"
                for name in ("fused_xent_fwd_sm90", "fused_xent_dlog_sm90", "fused_xent_dh_sm90", "fused_xent_dw_sm90")}


def xent_inputs(torch, dev, N, D, V, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(N, D, generator=g, device=dev).to(dtype)
    w = (0.02 * torch.randn(D, V, generator=g, device=dev)).to(dtype)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::7] = -100  # about a seventh of the labels ignored
    mask = labels != -100
    return h, w, labels, mask.float() / max(1, int(mask.sum()))


def xent_work(N, D, V, elt) -> dict:
    """(bytes, flops) of one launch of each kernel at N rows: every input
    read once, every output written once (dw read and written when it
    accumulates); one product is 2 N D V operations."""
    mm = 2.0 * N * D * V
    h, w, dl = N * D * elt, D * V * elt, N * V * elt
    work = {
        "fused_xent_fwd": (h + w + N * 8 + 2 * N * 4, mm),
        "fused_xent_dlog": (h + w + N * 8 + 2 * N * 4 + dl, mm),
        "fused_xent_dh": (dl + w + h, mm),
        "fused_xent_dw": (h + dl + 2 * D * V * 4, mm),
    }
    for name in ("fused_xent_fwd", "fused_xent_dlog", "fused_xent_dh", "fused_xent_dw"):
        work[f"{name}_sm90"] = work[name]
    return work


def phase_xent(torch, tfx, dev) -> list:
    """Each kernel against its plain version on the same inputs (dh and dw
    take the plain dlog); in bf16 the sm90 B3, dlog, dh and dw (the route
    bf16 takes), each repeated for its bits, and the first design's
    (through route=). Then device times in bf16 at the 1b training shape:
    B3 over all N rows, the backward kernels per launch at one chunk of
    CHUNK_ROWS rows (a backward at N 8184 makes 4 of each), each kernel on
    both routes in turns, beside cuBLAS and the bounds."""
    import torch.nn.functional as F

    sm90 = {name: f"{name}_sm90" for name in tfx.NAMES}
    checks = {name: [] for name in (*tfx.NAMES, *tfx.SM90_NAMES)}
    for gi, (label, N, D, V) in enumerate(XENT_GEOMS):
        for dtype in (torch.float32, torch.bfloat16):
            h, w, labels, gup = xent_inputs(torch, dev, N, D, V, dtype, 20 + gi)
            ref_nll, ref_lse = tfx.fused_xent_fwd_plain(h, w, labels)
            rows = slice(0, min(N, tfx.CHUNK_ROWS))
            args = (h[rows], w, labels[rows], ref_lse[rows], gup[rows])
            bf16 = dtype == torch.bfloat16
            routes = [tfx.SM90_SOURCE, tfx.SOURCE] if bf16 else [tfx.SOURCE]
            got = {}
            ref_dlog = tfx.fused_xent_dlog_plain(*args)
            ref_dw = tfx.fused_xent_dw_plain(h[rows], ref_dlog)
            for route in routes:
                sfx = "_sm90" if route == tfx.SM90_SOURCE else ""
                got["fused_xent_fwd" + sfx] = tfx.fused_xent_fwd(h, w, labels, route=route)
                got["fused_xent_dlog" + sfx] = tfx.fused_xent_dlog(*args, route=route)
                got["fused_xent_dh" + sfx] = tfx.fused_xent_dh(ref_dlog, w, route=route)
                got["fused_xent_dw" + sfx] = tfx.fused_xent_dw(h[rows], ref_dlog, route=route)
                if route == tfx.SM90_SOURCE:  # the route bf16 takes: its bits repeat
                    again = tfx.fused_xent_fwd(h, w, labels)
                    if not all(torch.equal(a, b) for a, b in zip(got["fused_xent_fwd_sm90"], again)):
                        raise AssertionError(f"sm90 B3 {label}: a second launch gave other bits")
                    if not (torch.equal(got["fused_xent_dlog_sm90"], tfx.fused_xent_dlog(*args, route=route))
                            and torch.equal(got["fused_xent_dh_sm90"], tfx.fused_xent_dh(ref_dlog, w, route=route))
                            and torch.equal(got["fused_xent_dw_sm90"], tfx.fused_xent_dw(h[rows], ref_dlog))):
                        raise AssertionError(f"sm90 dlog, dh or dw {label}: a second launch gave other bits")
                    # dw added to a prior dw (the later chunks of a backward):
                    # the same bits on a second add
                    added = [ref_dw.clone() for _ in range(2)]
                    for a in added:
                        tfx.fused_xent_dw(h[rows], ref_dlog, a)
                    if not torch.equal(added[0], added[1]):
                        raise AssertionError(f"sm90 dw {label}: a second add gave other bits")
                    got["fused_xent_dw_sm90 added"] = added[0]
            torch.cuda.synchronize()
            scale = max(1.0, float(ref_lse.abs().max()))
            ref_dh = tfx.fused_xent_dh_plain(ref_dlog, w)
            top = {"dh": float(ref_dh.float().abs().max()), "dw": float(ref_dw.abs().max())}
            r_dlog = 2.0**-7 if bf16 else 1e-5
            # (kernel, output, got, ref, rtol, atol): see XENT_TOL
            pairs = []
            for kernel, out in got.items():
                if "fwd" in kernel:
                    pairs += [(kernel, "lse", out[1], ref_lse, 0.0, 1e-4 * scale),
                              (kernel, "nll", out[0], ref_nll, 0.0, 1e-4 * scale)]
                    if bool(out[0][labels == -100].any()):
                        raise AssertionError(f"{kernel} {label} {dtype}: an ignored row has a loss")
                elif "dlog" in kernel:
                    pairs.append((kernel, "dlog", out, ref_dlog, r_dlog, r_dlog / 2 * float(gup.max()) / V))
                elif "dw" in kernel:
                    name, _, added = kernel.partition(" ")
                    pairs.append((name, "dw " + added if added else "dw", out, 2 * ref_dw if added else ref_dw,
                                  0.0, (2e-5 if added else 1e-5) * top["dw"]))
                else:
                    pairs.append((kernel, "dh", out, ref_dh, 2.0**-7 if bf16 else 0.0,
                                  (1e-5 if bf16 else 1e-4) * top["dh"]))
            for kernel, out, got_, ref, rtol, atol in pairs:
                diff = (got_.float() - ref.float()).abs()
                ratio = float((diff / (rtol * ref.float().abs() + atol)).max())
                checks[kernel].append({"shape": label, "N": N, "D": D, "V": V,
                                       "dtype": str(dtype).removeprefix("torch."), "output": out,
                                       "max_abs_err": float(diff.max()), "rtol": rtol, "atol": atol,
                                       "worst_share_of_limit": ratio})
                if not ratio <= 1.0:
                    raise AssertionError(f"{kernel} {out} {label} {dtype}: an element is {ratio:.3g} times its "
                                         f"limit (rtol {rtol}, atol {atol:.3g})")
            del h, w, labels, gup, ref_nll, ref_lse, got, ref_dlog, ref_dh, ref_dw, diff
            torch.cuda.empty_cache()
        worst = {f"{k} {c['dtype']}": round(c["worst_share_of_limit"], 4)
                 for k, cs in checks.items() for c in cs if c["shape"] == label}
        log(f"B3/B4 {label} (N{N} D{D} V{V}): f32 and bf16 within tolerance; worst element's share of its "
            f"limit: {worst}")
    log(f"B3/B4 tolerances: {XENT_TOL}")

    # times in bf16 at the 1b training shape
    (N, D, V), dtype = XENT_TIMED, torch.bfloat16
    C = min(N, tfx.CHUNK_ROWS)
    h, w, labels, gup = xent_inputs(torch, dev, N, D, V, dtype, 30)
    _, lse = tfx.fused_xent_fwd(h, w, labels)
    dlog = tfx.fused_xent_dlog(h[:C], w, labels[:C], lse[:C], gup[:C])
    acc = torch.zeros(D, V, device=dev)
    fwd_set, chunk_set = [(h, w, labels, lse, gup)], [(h[:C], w, labels[:C], lse[:C], gup[:C], dlog, acc)]

    def dlog_on(route):
        return lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dlog(h, w, lb, ls, g, route=route)

    def dh_on(route):
        return lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dh(dl, w, route=route)

    def dw_on(route):
        # added into the f32 dw, as every chunk after a backward's first
        return lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dw(h, dl, a, route=route)

    def fwd_on(route):
        return lambda h, w, lb, ls, g: tfx.fused_xent_fwd(h, w, lb, route=route)

    runs = {
        "fused_xent_fwd": (fwd_on(tfx.SOURCE), lambda h, w, lb, ls, g: tfx.fused_xent_fwd_plain(h, w, lb), fwd_set),
        "fused_xent_dlog": (dlog_on(tfx.SOURCE),
                            lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dlog_plain(h, w, lb, ls, g), chunk_set),
        "fused_xent_dh": (dh_on(tfx.SOURCE), lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dh_plain(dl, w),
                          chunk_set),
        "fused_xent_dw": (dw_on(tfx.SOURCE), lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dw_plain(h, dl, a),
                          chunk_set),
    }
    times = {}
    for name, (kern, plain, sets) in runs.items():
        times[name] = (device_ms(torch, kern, sets, launches=8, replays=3),
                       device_ms(torch, plain, sets, launches=2, replays=3))
        torch.cuda.empty_cache()
    # both routes of each kernel in turns (sm90, first, first, sm90)
    same_call = {}
    for name, on in (("fused_xent_fwd", fwd_on), ("fused_xent_dlog", dlog_on), ("fused_xent_dh", dh_on),
                     ("fused_xent_dw", dw_on)):
        order = [tfx.SM90_SOURCE, tfx.SOURCE, tfx.SOURCE, tfx.SM90_SOURCE]
        sets = fwd_set if name == "fused_xent_fwd" else chunk_set
        ms = [device_ms(torch, on(r), sets, launches=8, replays=3) for r in order]
        same_call[name] = {"sm90_ms": [ms[0], ms[3]], "first_design_ms": [ms[1], ms[2]]}
        times[sm90[name]] = (min(ms[0], ms[3]), times[name][1])
        times[name] = (min(ms[1], ms[2]), times[name][1])
    bwd_ms = device_ms(torch, lambda h, w, lb, ls, g: tfx.fused_xent_bwd(h, w, lb, ls, g), fwd_set,
                       launches=2, replays=3)

    # library yardstick, timed here only: cuBLAS h @ w then F.cross_entropy,
    # and its backward through autograd as (forward + backward) - forward
    def lib_fwd(h, w, lb):
        return F.cross_entropy((h @ w).float(), lb, ignore_index=-100)

    def lib_fwd_bwd(h, w, lb):
        return torch.autograd.grad(lib_fwd(h, w, lb), (h, w))

    lib_fwd_ms = device_ms(torch, lambda h, w, lb, ls, g: lib_fwd(h, w, lb), fwd_set, launches=4, replays=3)
    leaves = [(h.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True), labels)]
    lib_bwd_ms = device_ms(torch, lib_fwd_bwd, leaves, launches=2, replays=3) - lib_fwd_ms
    # and cuBLAS at each backward kernel's own function, on the same chunk inputs
    lib_chunk_ms = {
        "fused_xent_dh": device_ms(torch, lambda h, w, lb, ls, g, dl, a: dl @ w.T, chunk_set, launches=8, replays=3),
        "fused_xent_dw": device_ms(torch, lambda h, w, lb, ls, g, dl, a: a.add_(h.T @ dl), chunk_set,
                                   launches=8, replays=3),
    }
    lib_chunk_ms["fused_xent_dh_sm90"] = lib_chunk_ms["fused_xent_dh"]
    lib_chunk_ms["fused_xent_dw_sm90"] = lib_chunk_ms["fused_xent_dw"]
    del leaves, fwd_set, chunk_set, h, w, labels, gup, lse, dlog, acc
    torch.cuda.empty_cache()

    n_chunks = -(-N // C)
    rows = []
    for name in (*tfx.NAMES, *tfx.SM90_NAMES):
        n = N if name.startswith("fused_xent_fwd") else C
        nbytes, flops = xent_work(n, D, V, 2)[name]
        b_ms, b_by = bound_ms(nbytes, flops)
        kernel_ms, plain_ms = times[name]
        lib = lib_fwd_ms if name.startswith("fused_xent_fwd") else lib_chunk_ms.get(name)
        worst = max(checks[name], key=lambda c: c["worst_share_of_limit"])
        log(f"{name} bf16 N{n} D{D} V{V}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.5f} ms ({b_by})")
        base = name.removesuffix("_sm90")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": XENT_SOURCES.get(name, "opendiloco_torch/csrc/fused_xent.cu"),
            "replaces": XENT_REPLACES[name],
            "shape": {"N": n, "D": D, "V": V, "dtype": "bfloat16",
                      "per": "one launch over all rows" if n == N else f"one launch at one chunk of {C} rows "
                                                                      f"({n_chunks} per backward at N {N})"},
            "max_abs_err": worst["max_abs_err"],
            "tol": XENT_TOL,
            "worst_check": worst,
            "checks": checks[name],
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "plain_ms": plain_ms,
            "library_ms": lib,
            "library": ("cuBLAS h @ w, then F.cross_entropy over the f32 logits" if base == "fused_xent_fwd" else
                        "none: the logits' gradient has no call of its own" if base == "fused_xent_dlog" else
                        "cuBLAS dlog @ w.T on the same chunk" if base == "fused_xent_dh" else
                        "cuBLAS h.T @ dlog on the same chunk, added into the f32 dw"),
            "bound_ms": b_ms,
            "bound_by": b_by,
            **({"same_call": same_call[base]} if base in same_call else {}),
        })
    pair = {r: times[f"fused_xent_dlog{r}"][0] + times[f"fused_xent_dh{r}"][0] for r in ("_sm90", "")}
    log(f"fused cross-entropy dlog + dh per {C}-row chunk: sm90 {pair['_sm90']:.4f} ms, first design "
        f"{pair['']:.4f} ms (same call; {json.dumps(same_call)})")
    log(f"fused cross-entropy dw per {C}-row chunk, added into the f32 dw: sm90 {times['fused_xent_dw_sm90'][0]:.4f} "
        f"ms, first design {times['fused_xent_dw'][0]:.4f} ms, cuBLAS h.T @ dlog + add "
        f"{lib_chunk_ms['fused_xent_dw']:.4f} ms")
    log(f"fused cross-entropy backward (all {n_chunks} chunks, bf16 N{N} D{D} V{V}): {bwd_ms:.4f} ms; "
        f"library backward (autograd of the cuBLAS + F.cross_entropy pair, dh and dw over all rows) "
        f"{lib_bwd_ms:.4f} ms, library forward {lib_fwd_ms:.4f} ms")
    log(f"fused cross-entropy forward (B3, bf16 N{N} D{D} V{V}): sm90 {json.dumps(same_call['fused_xent_fwd'])} ms "
        f"in turns (sm90, first, first, sm90); library pair (cuBLAS h @ w + F.cross_entropy) {lib_fwd_ms:.4f} ms; "
        f"sm90 over library {times['fused_xent_fwd_sm90'][0] / lib_fwd_ms:.3f}")
    rows[0]["backward_ms_all_chunks"] = bwd_ms
    rows[0]["library_backward_ms_all_rows"] = lib_bwd_ms
    rows[0]["dlog_plus_dh_per_chunk_ms"] = {"sm90": pair["_sm90"], "first_design": pair[""]}
    return rows


# ---------------------------------------------------------------------------
# phases 8 and 10: training, two loopback workers
# ---------------------------------------------------------------------------

# phase 8, config_150m: lr 1e-3 rather than the config default 4e-4, so that
# 8 steps from a random init move the loss well clear of step-to-step noise;
# a checkpoint every 4 steps, which phase 8b resumes from
TRAIN_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                  total_steps=8, local_steps=4, lr=1e-3, ckpt_interval=4)


def master_hash(master) -> str:
    h = hashlib.sha256()
    for m in master:
        h.update(memoryview(m).cast("B"))
    return h.hexdigest()


def master_now(provider) -> list:
    """The master a worker's state provider serves: the optimizer's own
    host arrays under host placement (hashed in place: the provider's copy
    would hold the master twice, 4.4 GB more a 1b worker), else the
    provider's fetch."""
    opt = getattr(provider, "__self__", None)
    if getattr(opt, "placement", None) == "host":
        return opt.master
    return provider()["master"]


def save_master(master, path: str) -> None:
    with open(path, "wb") as f:
        for m in master:
            f.write(memoryview(np.ascontiguousarray(m)).cast("B"))


def load_master(path: str, like) -> list:
    out, off = [], 0
    for m in like:
        out.append(np.fromfile(path, np.float32, m.size, offset=off).reshape(m.shape))
        off += m.nbytes
    return out


def record_masters(backend):
    """Make ``backend`` hash its worker's master as each round begins (the
    master the previous round left) and keep the worker's state provider
    for the final check."""
    backend.hashes, backend.provider = {}, None
    serve, reduce = backend.serve_state, backend.all_reduce

    def serve_state(get_state):
        backend.provider = get_state
        serve(get_state)

    def all_reduce(arrays, *, epoch=None, **kw):
        if epoch:
            backend.hashes[epoch - 1] = master_hash(master_now(backend.provider))
        return reduce(arrays, epoch=epoch, **kw)

    backend.serve_state, backend.all_reduce = serve_state, all_reduce
    return backend


def recording_backends(world) -> list:
    """One loopback backend a worker of ``world``, recording
    (:func:`record_masters`)."""
    from opendiloco_torch.diloco import LoopbackBackend

    return [record_masters(LoopbackBackend(world, f"peer-{i}")) for i in range(world.n_peers)]


def train_config(model: str, run: dict, rank: int, project: str, ckpt: dict, serve: dict | None = None,
                 diloco: dict | None = None, fleet: dict | None = None, **extra):
    """The ``Config`` of worker ``rank`` of phases 8, 8b, 10, 19, 24-28 and
    33 (``diloco``: more DiLoCo options, phase 10's device placement, phase
    24's TCP backend, phase 25's gossip; ``fleet``: phase 26's; ``extra``:
    more ``Config`` fields, phases 27 and 28's attention and loss, phase
    33's precision; bf16-mixed unless it names another)."""
    from opendiloco_torch.config import Config

    extra.setdefault("precision", "bf16-mixed")
    return Config(
        path_model=model, fake_data=True, fake_data_mode="ramp", remat=True,
        seq_length=run["seq_length"], per_device_train_batch_size=run["per_device_train_batch_size"],
        total_batch_size=run["total_batch_size"], warmup_steps=run["warmup_steps"],
        total_steps=run["total_steps"], lr=run["lr"], metric_logger_type="dummy", project=project,
        ckpt=ckpt,
        diloco={**dict(local_steps=run["local_steps"], backend="loopback", world_rank=rank,
                       timeout_waiting_for_peers=600.0), **(diloco or {})},
        serve=serve,
        fleet=fleet,
        **extra,
    )


def inner_step_s(rows: list) -> list:
    """Each worker's wall seconds a step from its metric rows, the first
    step (warm-up) and the steps that took an outer step left out."""
    return [[r["time_taken"] for r in rr if r["step"] > 1 and "outer_step_s" not in r] for rr in rows]


def run_workers(fn, args_by_worker: list) -> list:
    """``fn(*args)`` for each worker, one thread each; returns their results
    and raises the first worker's error."""
    results, errors = [None] * len(args_by_worker), []

    def work(i):
        try:
            results[i] = fn(*args_by_worker[i])
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(args_by_worker))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
# phase 10, config_1b: 4 steps, 2 outer rounds (the host outer step moves
# 4.4 GB of f32 per worker); warmup 1 so that 3 of the 4 steps update
TRAIN_1B = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=1,
                total_steps=4, local_steps=2, lr=1e-3)
TRAIN_1B_LAYERS = 17  # of config_1b's 22 (phases 10 and 24: the smoke's time limit)


OUTER_KEYS = ("outer_step_s", "outer_wait_s", "outer_d2h_s", "outer_pseudo_grad_s", "outer_allreduce_s",
              "outer_nesterov_s", "outer_h2d_s")


def training_launches(torch, dev, cfg, run: dict, inner_steps: int, names, fused: bool | None = None) -> dict:
    """The launch counts a bf16 training run of ``inner_steps`` inner steps
    (all workers) must show: forward and backward take the sm90 kernels at
    D 64, the first design never; one delta a backward; with the fused
    loss (as ``TrainerConfig`` resolves it for ``cfg`` on the card) one
    forward launch a micro-batch and one launch of each backward kernel a
    backward chunk."""
    from opendiloco_torch.ops import fused_xent as tfx
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    L, accum = cfg.num_hidden_layers, run["total_batch_size"] // run["per_device_train_batch_size"]
    want = {name: 0 for name in names}
    want.update({"flash_attention_fwd_sm90": inner_steps * 2 * L * accum,
                 "flash_attention_delta": inner_steps * L * accum,
                 "flash_attention_dq_sm90": inner_steps * L * accum,
                 "flash_attention_dkv_sm90": inner_steps * L * accum})
    if fused if fused is not None else InnerTrainer(cfg, TrainerConfig(), device=dev).tc.fused_loss:
        chunks = -(-run["per_device_train_batch_size"] * (run["seq_length"] - 1) // tfx.CHUNK_ROWS)
        want["fused_xent_fwd_sm90"] = inner_steps * accum
        for name in ("fused_xent_dlog_sm90", "fused_xent_dh_sm90", "fused_xent_dw_sm90"):
            want[name] = inner_steps * accum * chunks
    return want


def train_workers(torch, tfa, dev, model: str, run: dict, diloco: dict | None = None, made: list | None = None,
                  keep_master: bool = False, extra: dict | None = None) -> dict:
    """Two DiLoCo workers, one thread each, run ``train()`` at ``model``'s
    full width and depth through the kernels. The launch counters are
    zeroed just before and read just after, and held to
    :func:`training_launches`. Masters are hashed as each round begins
    (the recording backends: inside the all-reduce's seconds) and at the
    end, and compared across workers. With ``made`` the workers get no
    backend: ``train()`` makes its own (phase 24), and ``made`` collects
    them, recording. ``keep_master`` writes worker 0's final master to a
    file (its path under "master"). ``extra``: more ``Config`` fields
    (phase 31's fused loss)."""
    import os
    import pickle
    import shutil
    import tempfile

    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.train import train

    cfg = load_config(model)
    handed = recording_backends(LoopbackWorld(2)) if made is None else [None, None]
    tmp = tempfile.mkdtemp()
    ckpt_path = os.path.join(tmp, "ckpts")
    if run.get("ckpt_interval"):
        free = shutil.disk_usage(tmp).free
        log(f"train {model}: checkpoints every {run['ckpt_interval']} steps under {ckpt_path} "
            f"({free / 2**30:.1f} GiB free there)")

    def config(rank):
        return train_config(model, run, rank, os.path.join(tmp, f"metrics-{rank}.pkl"),
                            dict(path=ckpt_path, interval=run.get("ckpt_interval")), diloco=diloco, **(extra or {}))

    torch.cuda.reset_peak_memory_stats()
    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    summaries = run_workers(train, [(config(r), handed[r], dev) for r in range(2)])
    wall = time.perf_counter() - t0
    backends = handed if made is None else sorted(made, key=lambda b: b.peer_id)
    launches = tfa.LAUNCHES.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steps = run["total_steps"]
    want = training_launches(torch, dev, cfg, run, 2 * steps, launches, fused=(extra or {}).get("fused_loss"))
    if launches != want:
        raise AssertionError(f"training launch counts {launches} != {want}")

    rows = []
    for rank in range(2):
        with open(os.path.join(tmp, f"metrics-{rank}.pkl"), "rb") as f:
            rows.append(pickle.load(f))
        losses = [r["Loss"] for r in rows[rank]]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"worker {rank}: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"worker {rank}: last loss {losses[-1]} not below first {losses[0]}")
    rounds = steps // run["local_steps"]
    for b in backends:
        b.hashes[rounds - 1] = master_hash(master_now(b.provider))
    for r in range(rounds):
        if backends[0].hashes.get(r) is None or backends[0].hashes[r] != backends[1].hashes.get(r):
            raise AssertionError(f"masters differ after round {r}: {[b.hashes for b in backends]}")
    outer = {k: [r[k] for rr in rows for r in rr if "outer_step_s" in r] for k in OUTER_KEYS}
    if len(outer["outer_step_s"]) != 2 * rounds:
        raise AssertionError(f"expected {2 * rounds} outer steps, got {outer['outer_step_s']}")
    out = {"rows": rows, "launches": launches, "hashes": [b.hashes for b in backends], "outer": outer,
           "peak_gb": peak_gb, "wall": wall, "ckpt_save_s": [sm["ckpt_save_s"] for sm in summaries],
           "ckpt_path": ckpt_path if run.get("ckpt_interval") else None, "rounds": rounds}
    if keep_master:  # on disk: a 1b master is 4.4 GB of host memory
        out["master"] = os.path.join(tmp, "master-0.f32")
        save_master(master_now(backends[0].provider), out["master"])
    del backends, summaries
    # the workers' host state (fp32 masters, outer momentum: GBs at 1b)
    # may sit in reference cycles: collect it now, not inside a timed turn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(torch, tfa, dev, card: str, model: str, run: dict, compare: dict, keep_master: bool = False) -> dict:
    """Two DiLoCo workers, one thread each, run ``train()`` at ``model``'s
    full width and depth through the kernels (TrainerConfig defaults, so
    fused_loss resolves as a user gets it): :func:`train_workers`. Then
    one inner step under each of the two TrainerConfig variants in
    ``compare`` (the first is the path's own), on the same params and
    batch, each with one worker's steady inner-step time and peak device
    memory alone. ``keep_master``: the result keeps the file of worker
    0's final master under "master" (phase 24 pops it)."""
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg = load_config(model)
    L, accum = cfg.num_hidden_layers, run["total_batch_size"] // run["per_device_train_batch_size"]
    tw = train_workers(torch, tfa, dev, model, run, keep_master=keep_master)
    rows, launches, hashes, outer, peak_gb, wall = (tw[k] for k in ("rows", "launches", "hashes", "outer",
                                                                     "peak_gb", "wall"))
    steps, rounds = run["total_steps"], tw["rounds"]
    inner_steps = 2 * steps  # two workers
    outer_s = outer["outer_step_s"]
    fused = InnerTrainer(cfg, TrainerConfig(), device=dev).tc.fused_loss
    ckpt_save_s, ckpt_path = tw["ckpt_save_s"], tw["ckpt_path"]

    # one inner step under each variant, same params and batch
    from opendiloco_torch.data.dataloader import FakeTokenizedDataset

    ds = iter(FakeTokenizedDataset(run["seq_length"], cfg.vocab_size, seed=7, mode="ramp"))
    ids = np.stack([next(ds)["input_ids"] for _ in range(run["total_batch_size"])])
    results, step_runs, peak_gib, turns = {}, {}, {}, []
    # the variants in turns (a b b a), each turn on a trainer of its own;
    # per turn, the card's time per step (events), its clocks and power,
    # and the host's garbage collections
    labels = list(compare)
    # the smoke's earlier phases hold many Python objects: a collection of
    # the oldest generation inside a timed turn walked them all and held
    # a 1b step up by over a quarter (PERF.md section 6), so they are frozen out
    # of the collector for the turns
    gc.freeze()
    sampler, collections = CardSampler(), GcTimer()
    try:
        for label in labels + labels[::-1]:
            torch.cuda.reset_peak_memory_stats()
            tr = InnerTrainer(cfg, TrainerConfig(precision="bf16-mixed", remat=True, warmup_steps=2,
                                                 total_steps=100, **compare[label]), device=dev)
            state = tr.init_state(3)
            batch = tr.shard_batch(ids, ids.copy(), accum=accum)
            state, m = tr.train_step(state, batch)
            results.setdefault(label, (float(m["loss"]), float(m["grad_norm"]), tr.tc.fused_loss))
            # steady inner-step time of one worker alone (the first step above
            # carried the warm-up), and its peak device memory
            torch.cuda.synchronize()
            n = 3
            events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
            t1 = time.perf_counter()
            events[0].record()
            for i in range(n):
                state, m = tr.train_step(state, batch)
                events[i + 1].record()
            float(m["loss"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step_runs.setdefault(label, []).append((t2 - t1) / n * 1e3)
            turns.append({"variant": label, "step_ms": (t2 - t1) / n * 1e3,
                          "card_ms_per_step": [events[i].elapsed_time(events[i + 1]) for i in range(n)],
                          "card": sampler.window(t1, t2), "gc": collections.window(t1, t2)})
            peak_gib[label] = max(peak_gib.get(label, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            del tr, state, batch, m
            torch.cuda.empty_cache()
    finally:
        sampler.stop()
        collections.stop()
        gc.unfreeze()
    step_ms = {label: float(np.mean(runs)) for label, runs in step_runs.items()}
    step_s = next(iter(step_ms.values())) / 1e3
    (a, (kl, kg, kf)), (b, (pl_, pg, pf)) = results.items()
    # bf16: the two paths round attention probabilities and outputs, or the
    # logits' gradient, at different points; the loss (~10.6 at init)
    # agrees to 1e-3 and the gradient norm to 0.5% of itself
    if not (abs(kl - pl_) <= 1e-3 and abs(kg - pg) <= 5e-3 * pg):
        raise AssertionError(f"{a} vs {b} step: loss {kl} vs {pl_}, grad norm {kg} vs {pg}")
    tokens = run["total_batch_size"] * run["seq_length"]
    res = {
        "config": model, "layers": L, "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
        **run, "accum": accum, "workers": 2, "outer_rounds": rounds, "fused_loss": fused,
        "losses": [[r["Loss"] for r in rr] for rr in rows],
        "lrs": [[r["lr"] for r in rr] for rr in rows],
        "grad_norms": [[r["grad_norm"] for r in rr] for rr in rows],
        "step_s": inner_step_s(rows),
        "launches": launches,
        "launches_per_inner_step": {k: v / inner_steps for k, v in launches.items()},
        "master_hashes": hashes,
        "ckpt_save_s": ckpt_save_s,
        "ckpt_path": ckpt_path,
        **outer,
        "train_wall_s": wall,
        "peak_memory_gib_two_workers": peak_gb,
        f"{a}_vs_{b}_step": {"loss": [kl, pl_], "grad_norm": [kg, pg], "fused_loss": [kf, pf],
                             "tol": "loss 1e-3 abs, grad norm 0.5% rel (bf16)"},
        "inner_step_ms_one_worker": step_s * 1e3,
        "tokens_per_s_one_worker": tokens / step_s,
        "inner_step_ms_one_worker_by_variant": step_ms,
        "inner_step_ms_one_worker_runs_in_turns": step_runs,
        "inner_step_turns": turns,
        "peak_memory_gib_one_worker_by_variant": peak_gib,
    }
    if keep_master:
        res["master"] = tw["master"]
    log(f"train {model}: inner step {step_s * 1e3:.1f} ms (one worker alone, mb "
        f"{run['per_device_train_batch_size']} x accum {accum} x seq {run['seq_length']}) | {card}")
    log(f"train {model}: {tokens / step_s:.0f} training tokens/s (one worker alone) | {card}")
    log(f"train {model}: outer step {np.mean(outer_s):.3f} s mean over {len(outer_s)} (two workers; of it "
        f"waiting for the peer {np.mean(outer['outer_wait_s']):.3f} s, the D2H beside the wait "
        f"{np.mean(outer['outer_d2h_s']):.3f} s, then pseudo-gradient {np.mean(outer['outer_pseudo_grad_s']):.3f} s, "
        f"all-reduce {np.mean(outer['outer_allreduce_s']):.3f} s, Nesterov {np.mean(outer['outer_nesterov_s']):.3f} "
        f"s, H2D {np.mean(outer['outer_h2d_s']):.3f} s) | {card}")
    log(f"train {model}: peak device memory {peak_gb:.2f} GiB (two workers on one card) | {card}")
    log(f"train {model}: one worker alone, {a} / {b}: inner step {step_ms[a]:.1f} / {step_ms[b]:.1f} ms (mean of "
        f"two turns, {a} {b} {b} {a}: {json.dumps(step_runs)}), peak device memory {peak_gib[a]:.2f} / "
        f"{peak_gib[b]:.2f} GiB | {card}")
    for t in turns:
        log(f"train {model}: turn {t['variant']}: {t['step_ms']:.1f} ms a step, card "
            f"{[round(x, 1) for x in t['card_ms_per_step']]} ms by step, {json.dumps(t['card'])}, python gc "
            f"{json.dumps({k: round(v, 2) if isinstance(v, float) else v for k, v in t['gc'].items()})}")
    log(f"train {model}: losses {res['losses']}; {a} vs {b} step loss {kl:.5f}/{pl_:.5f}, "
        f"grad norm {kg:.5f}/{pg:.5f}; launches {launches}")
    return res


def phase_resume(torch, tfa, dev, card: str, p8: dict) -> dict:
    """Phase 8b: two fresh workers on a fresh loopback world resume phase
    8's run through ``train()`` from its step-4 checkpoint and run steps
    5-8. Each step's loss and LR must equal phase 8's bit for bit, each
    worker's final master hash phase 8's final hash, and the launch counts
    (zeroed just before, read just after) those of 4 steps of phase 8.
    Prints each worker's seconds to save (in phase 8) and to load, and its
    checkpoint's bytes on disk; then removes the checkpoints."""
    import os
    import pickle
    import shutil
    import tempfile

    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.train import train

    run, ckpt_path = TRAIN_150M, p8["ckpt_path"]
    step = run["ckpt_interval"]
    resume_dir = os.path.join(ckpt_path, f"model_step_{step}")
    disk = {}
    for rank in range(2):
        d = os.path.join(resume_dir, f"diloco_rank_{rank}")
        disk[rank] = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
    tmp = tempfile.mkdtemp()
    backends = recording_backends(LoopbackWorld(2))
    configs = [train_config("150m", run, r, os.path.join(tmp, f"metrics-{r}.pkl"),
                            dict(path=ckpt_path, resume=resume_dir)) for r in range(2)]
    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    summaries = run_workers(train, [(configs[r], backends[r], dev) for r in range(2)])
    wall = time.perf_counter() - t0
    launches = tfa.LAUNCHES.snapshot()
    want = {k: v * (run["total_steps"] - step) // run["total_steps"] for k, v in p8["launches"].items()}
    if launches != want:
        raise AssertionError(f"resumed launch counts {launches} != {want} (4 steps of phase 8)")
    res = {"resumed_from_step": step, "launches": launches, "train_wall_s": wall, "workers": []}
    rounds = run["total_steps"] // run["local_steps"]
    for rank in range(2):
        with open(os.path.join(tmp, f"metrics-{rank}.pkl"), "rb") as f:
            rows = pickle.load(f)
        losses, lrs = [r["Loss"] for r in rows], [r["lr"] for r in rows]
        final_hash = master_hash(backends[rank].provider()["master"])
        worker = {
            "rank": rank, "steps": [r["step"] for r in rows], "losses": losses, "lrs": lrs,
            "losses_phase8": p8["losses"][rank][step:], "lrs_phase8": p8["lrs"][rank][step:],
            "final_master_hash": final_hash, "final_master_hash_phase8": p8["master_hashes"][rank][rounds - 1],
            "save_s": p8["ckpt_save_s"][rank][0], "load_s": summaries[rank]["ckpt_load_s"],
            "bytes_on_disk": sum(disk[rank].values()), "files": disk[rank],
        }
        res["workers"].append(worker)
        log(f"resume 150m worker {rank}: save {worker['save_s']:.3f} s (phase 8), load {worker['load_s']:.3f} s, "
            f"{worker['bytes_on_disk']} bytes on disk {json.dumps(disk[rank])} | {card}")
        log(f"resume 150m worker {rank}: steps {worker['steps']} losses {losses} vs phase 8 "
            f"{worker['losses_phase8']}; lrs {lrs} vs {worker['lrs_phase8']}; final master "
            f"{final_hash[:16]} vs phase 8 {worker['final_master_hash_phase8'][:16]}")
        if worker["steps"] != list(range(step + 1, run["total_steps"] + 1)):
            raise AssertionError(f"resumed worker {rank} logged steps {worker['steps']}")
        if losses != worker["losses_phase8"] or lrs != worker["lrs_phase8"]:
            raise AssertionError(f"resumed worker {rank}: losses/LRs differ from phase 8's: {worker}")
        if final_hash != worker["final_master_hash_phase8"]:
            raise AssertionError(f"resumed worker {rank}: final master differs from phase 8's")
    log(f"resume 150m: launches {launches} (4 steps of phase 8); losses, LRs and final masters bit for bit")
    shutil.rmtree(os.path.dirname(ckpt_path), ignore_errors=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 19: training that serves live traffic off its masters
# ---------------------------------------------------------------------------

# phase 19's serving plane on worker 0: w4 weights, a swap as soon as a round
# lands (checked every 4 decode steps), blockwise4bit snapshots (the fast path)
TRAIN_SERVE = dict(enabled=True, weight_format="w4", max_stale_rounds=0, swap_every_steps=4, port=0)
TRAIN_SERVE_CODEC = "blockwise4bit"
TRAIN_SERVE_CLIENTS = 3
TRAIN_SERVE_NEW_TOKENS = 32


def http_json(url: str, body: bytes | None = None, timeout: float = 600.0) -> dict:
    """One HTTP call to the front end; an HTTP error's JSON body is the answer."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def phase_train_serve(torch, tdk, dev, card: str, p8: dict) -> dict:
    """Phase 19: phase 8's two-worker run at config_150m (checkpoints off)
    with ``serve.enabled`` on worker 0 (TRAIN_SERVE) and
    ``ODTP_STATE_CODEC=blockwise4bit``, so that every swap takes
    ``install_wire``'s fast path into the packed layout B8 reads. Client
    threads post /generate over HTTP (prompts in the 64 and 256 buckets,
    32 new tokens) and a poller reads /healthz and /stats until ``train()``
    returns. Every response must succeed or fail with "server stopped"
    (in flight when the run ended), the responses must carry at least two
    weight epochs, the engine must have swapped, the launch counts must be
    phase 8's training kernels plus B6 L a decode step (its merge by the
    split rule) and B8 7 L a prefill and a decode step, and both workers'
    losses, LRs and per-round master hashes must equal phase 8's bit for
    bit. Prints each swap's seconds by part, TTFT and tokens/s of the
    requests served while training ran, and the inner-step and outer-step
    times beside phase 8's."""
    import os
    import pickle
    import shutil
    import tempfile

    from opendiloco_torch import serve as tserve
    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.train import train

    cfg = load_config("150m")
    L = cfg.num_hidden_layers
    run = {**TRAIN_150M, "ckpt_interval": None}
    backends = recording_backends(LoopbackWorld(2))
    tmp = tempfile.mkdtemp()
    planes, admits, real_build = [], [0], tserve.build_serving

    def capture(*args, **kwargs):
        plane = real_build(*args, **kwargs)
        admit = plane.engine.admit

        def counted(*a, **k):  # one prefill an admit
            admits[0] += 1
            return admit(*a, **k)

        plane.engine.admit = counted
        planes.append(plane)
        return plane

    def config(rank):
        return train_config("150m", run, rank, os.path.join(tmp, f"metrics-{rank}.pkl"),
                            dict(path=os.path.join(tmp, "ckpts"), interval=None),
                            serve=TRAIN_SERVE if rank == 0 else None)

    done, responses, polls, errors = threading.Event(), [], [], []

    def wait_port() -> int:
        deadline = time.monotonic() + 600
        while not planes:
            if done.is_set() or time.monotonic() > deadline:
                raise AssertionError("the serving plane never came up")
            time.sleep(0.01)
        return planes[0].port

    def ended(err) -> bool:
        # refused once the run has ended and stopped the front end; else a fault
        if done.is_set() or planes[0].server._stop.is_set():
            return True
        raise err

    def client(seed):
        try:
            port, rng = wait_port(), np.random.default_rng(seed)
            while not done.is_set():
                n = int(rng.integers(33, 65)) if rng.random() < 0.5 else int(rng.integers(65, 257))
                body = json.dumps({"prompt": rng.integers(1, cfg.vocab_size, n).tolist(),
                                   "max_new_tokens": TRAIN_SERVE_NEW_TOKENS}).encode()
                t0 = time.perf_counter()
                try:
                    out = http_json(f"http://127.0.0.1:{port}/generate", body)
                except OSError as e:  # refused or reset: the run has ended
                    if ended(e):
                        return
                responses.append({**out, "prompt_len": n, "t_sent": t0, "t_back": time.perf_counter()})
        except BaseException as e:
            errors.append(e)

    def poller():
        try:
            port = wait_port()
            while not done.wait(0.25):
                try:
                    polls.append({path: http_json(f"http://127.0.0.1:{port}{path}", timeout=60)
                                  for path in ("/healthz", "/stats")})
                except OSError as e:
                    if ended(e):
                        return
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(100 + i,)) for i in range(TRAIN_SERVE_CLIENTS)]
    threads.append(threading.Thread(target=poller))
    old_codec = os.environ.get("ODTP_STATE_CODEC")
    os.environ["ODTP_STATE_CODEC"] = TRAIN_SERVE_CODEC
    tserve.build_serving = capture
    tdk.LAUNCHES.reset()
    try:
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        run_workers(train, [(config(r), backends[r], dev) for r in range(2)])
        wall = time.perf_counter() - t0
    finally:
        done.set()
        tserve.build_serving = real_build
        if old_codec is None:
            os.environ.pop("ODTP_STATE_CODEC")
        else:
            os.environ["ODTP_STATE_CODEC"] = old_codec
        for t in threads:
            t.join(timeout=120)
    launches = tdk.LAUNCHES.snapshot()
    if errors:
        raise errors[0]
    (plane,) = planes
    engine, st = plane.engine, plane.batcher.stats()

    # every answer succeeded, or failed because the run ended under it
    failed = [r for r in responses if "error" in r]
    if any(r["error"] != "server stopped" for r in failed):
        raise AssertionError(f"train+serve: failed requests {[r['error'] for r in failed][:5]}")
    ok = [r for r in responses if "error" not in r]
    epochs = sorted({r["epoch"] for r in ok})
    if len(epochs) < 2:
        raise AssertionError(f"train+serve: {len(ok)} responses from epochs {epochs}; at least two wanted")
    if any(len(r["tokens"]) != TRAIN_SERVE_NEW_TOKENS for r in ok) or engine.swap_count < 1:
        raise AssertionError(f"train+serve: short responses or no swap ({engine.swap_count})")

    # launches: phase 8's training kernels, and the serving kernels by count
    from opendiloco_torch.config import ServeConfig

    steps, prefills = st["decode_steps"], admits[0]
    sc = ServeConfig(**TRAIN_SERVE)
    splits, _ = tdk._decode_grid(sc.max_batch, sc.max_context, cfg.kv_heads, cfg.num_attention_heads // cfg.kv_heads,
                                 dev.index or 0, None)
    want = {name: (count if name.startswith(("flash_attention", "fused_xent")) else 0)
            for name, count in p8["launches"].items()}
    want.update({"paged_decode_attention": L * steps,
                 "paged_decode_attention_merge": L * steps if splits > 1 else 0,
                 "w4_matmul_sm90": 7 * L * (prefills + steps)})
    check_launches(launches, want, f"train+serve ({steps} decode steps, {prefills} prefills)")

    # training is what it was without serving, bit for bit
    rows = []
    for rank in range(2):
        with open(os.path.join(tmp, f"metrics-{rank}.pkl"), "rb") as f:
            rows.append(pickle.load(f))
    rounds = run["total_steps"] // run["local_steps"]
    for b in backends:
        b.hashes[rounds - 1] = master_hash(b.provider()["master"])
    losses = [[r["Loss"] for r in rr] for rr in rows]
    lrs = [[r["lr"] for r in rr] for rr in rows]
    hashes = [b.hashes for b in backends]
    if losses != p8["losses"] or lrs != p8["lrs"] or hashes != p8["master_hashes"]:
        raise AssertionError(f"train+serve: training differs from phase 8's: losses {losses} vs {p8['losses']}, "
                             f"lrs {lrs} vs {p8['lrs']}, master hashes {hashes} vs {p8['master_hashes']}")

    ttft = sorted(plane.batcher._ttfts)
    served = sum(len(r["tokens"]) for r in ok)
    window = max(r["t_back"] for r in ok) - min(r["t_sent"] for r in ok)
    step_s = inner_step_s(rows)
    outer_s = [r["outer_step_s"] for rr in rows for r in rr if "outer_step_s" in r]
    p8_outer = p8["outer_step_s"]
    res = {
        "config": "150m", **run, "serve": TRAIN_SERVE, "codec": TRAIN_SERVE_CODEC, "clients": TRAIN_SERVE_CLIENTS,
        "new_tokens": TRAIN_SERVE_NEW_TOKENS, "responses": len(responses), "ok": len(ok),
        "server_stopped": len(failed), "epochs": epochs, "weight_swaps": engine.swap_count,
        "swaps": list(engine.swap_log), "decode_steps": steps, "prefills": prefills, "launches": launches,
        "ttft_ms": {"p50": float(np.percentile(ttft, 50)) * 1e3, "max": ttft[-1] * 1e3, "n": len(ttft)},
        "tokens_per_s": served / window, "served_tokens": served, "serving_window_s": window,
        "staleness_hist": st["staleness_hist"], "polls": len(polls),
        "inner_step_ms": {"serving": [[x * 1e3 for x in s] for s in step_s],
                          "phase 8": [[x * 1e3 for x in s] for s in p8["step_s"]]},
        "inner_step_ms_median": {"serving": float(np.median(step_s)) * 1e3,
                                 "phase 8": float(np.median(p8["step_s"])) * 1e3},
        "outer_step_s": {"serving": outer_s, "phase 8": p8_outer},
        "train_wall_s": wall, "losses": losses,
    }
    if not polls or not all(p["/healthz"].get("ok") for p in polls):
        raise AssertionError(f"train+serve: /healthz polls {polls[:3]}")
    for sw in engine.swap_log:
        log(f"train+serve 150m swap to epoch {sw['epoch']} ({sw['codec']}): {sw['total_s'] * 1e3:.1f} ms = encode "
            f"{sw['encode_s'] * 1e3:.1f} + decode {sw['decode_s'] * 1e3:.1f} + H2D {sw['h2d_s'] * 1e3:.1f} + pack "
            f"{sw['pack_s'] * 1e3:.1f} ms (and the rest) | {card}")
    log(f"train+serve 150m: {len(ok)} responses ({len(failed)} 'server stopped' at the end) from epochs {epochs}, "
        f"{engine.swap_count} swaps; TTFT p50 {res['ttft_ms']['p50']:.1f} ms, max {res['ttft_ms']['max']:.1f} ms; "
        f"{res['tokens_per_s']:.1f} tokens/s while training | {card}")
    med = res["inner_step_ms_median"]
    log(f"train+serve 150m: inner step median {med['serving']:.1f} ms against phase 8's {med['phase 8']:.1f} "
        f"(each worker's steps after the first, outer steps left out: {json.dumps(res['inner_step_ms'])}); outer "
        f"step {outer_s} s against phase 8's {p8_outer}; launches {launches} | {card}")
    log(f"train+serve 150m: losses, LRs and master hashes equal phase 8's bit for bit")
    shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 20: install_wire at config_1b
# ---------------------------------------------------------------------------


def packed_leaves(torch, engine) -> list:
    from opendiloco_torch.models.llama import PackedW4, flatten_params

    return [(w.q.clone(), w.s.clone()) for w in flatten_params(engine.params) if isinstance(w, PackedW4)]


def same_bits(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


def phase_install_wire(torch, tdk, cfg, params, dev, card: str, serve: list) -> dict:
    """Phase 20: ``install_wire`` at config_1b on phase 4's fp32 and phase
    5's w4 engine (``build_serving`` of the same params), with snapshots
    encoded on the host from those very params:
    (a) w4 engine, blockwise4bit snapshot (the fast path): every packed
        leaf must equal the engine's own packing bit for bit, and phase
        5's 16 requests' streams must equal those of the same engine given
        ``install_params`` of what the snapshot carries (the packable
        leaves as they were, the others through the codec);
    (b) w4 engine, fp16 snapshot (decoded on the host, packed on the
        card): the streams and packed leaves must equal those of
        ``install_params`` of the fp16-rounded params;
    (c) fp32 engine, fp16 snapshot: the same against ``install_params``.
    Prints each case's host encode s, the install s by part and the
    card's peak memory across the swap; launches are checked as phases 4
    and 5 check them."""
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.diloco.compression import get_codec
    from opendiloco_torch.models.llama import flatten_params, unflatten_params
    from opendiloco_torch.serve import build_serving

    L = cfg.num_hidden_layers
    host = [x.detach().float().cpu().numpy() for x in flatten_params(params)]
    snaps, encode_s = {}, {}
    for name in ("blockwise4bit", "fp16"):
        codec = get_codec(name)
        t0 = time.perf_counter()
        snaps[name] = [(*codec.encode(x.reshape(-1)), x.shape) for x in host]
        encode_s[name] = time.perf_counter() - t0
        log(f"install_wire 1b: host encode of the {sum(x.size for x in host)} master values to {name}: "
            f"{encode_s[name]:.2f} s, {sum(len(p) for p, _, _ in snaps[name])} bytes | {card}")

    def carried(name, keep=None):
        """The weights a snapshot carries, decoded on the host; leaves where
        ``keep`` is true stay as they were."""
        codec = get_codec(name)
        out = [x if keep is not None and keep[i] else
               np.asarray(codec.decode(p, (x.size,), m), np.float32).reshape(x.shape)
               for i, ((p, m, _), x) in enumerate(zip(snaps[name], host))]
        return unflatten_params(params, out)

    serve_cfg = ServeConfig()
    prompts = prompts_over_buckets(serve_cfg, cfg.vocab_size)
    warm = [p[:b] for p, b in zip(prompts, serve_cfg.prefill_buckets)]

    def streams(plane, what):
        run = drive(tdk, plane, prompts, warm, cfg.vocab_size)
        w4 = plane.engine.weight_format == "w4"
        steps, prefills = run["steps"], run["prefills"]
        check_launches(run["launches"], {"paged_decode_attention": L * steps,
                                         "paged_decode_attention_merge": PAGED_MERGES_PER_STEP * steps,
                                         "w4_matmul_sm90": 7 * L * (prefills + steps) if w4 else 0},
                       f"install_wire {what} ({steps} decode steps, {prefills} prefills)")
        return [r.tokens for r in run["reqs"]], run["launches"]

    def swap(engine, epoch, name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        times = engine.install_wire(epoch, snaps[name], name)
        total = time.perf_counter() - t0
        torch.cuda.synchronize()
        return {"codec": name, "encode_s": encode_s[name], "install_s": total, **times,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "before_gib": base / 2**30,
                "after_gib": torch.cuda.memory_allocated() / 2**30}

    cases, launches = {}, {}
    plane = build_serving(ServeConfig(weight_format="w4"), cfg, params, device=dev, start_server=False)
    try:
        engine = plane.engine
        own = packed_leaves(torch, engine)
        # (a) the fast path
        case = swap(engine, 1, "blockwise4bit")
        if not same_bits(torch, packed_leaves(torch, engine), own):
            raise AssertionError("install_wire (a): packed leaves differ from the engine's own packing")
        got, la = streams(plane, "(a) w4 blockwise4bit")
        engine.install_params(2, carried("blockwise4bit", keep=engine._packable))
        want, lr = streams(plane, "(a) reference")
        case.update(streams_equal=got == want, agreement_with_phase5=agreement(got, serve[1]["tokens"]))
        cases["a"], launches["a"] = case, {k: la[k] + lr[k] for k in la}
        if got != want:
            raise AssertionError(f"install_wire (a): streams differ: {agreement(got, want)}")
        # (b) the slow path: decode on the host, pack on the card
        case = swap(engine, 3, "fp16")
        packed = packed_leaves(torch, engine)
        got, lb = streams(plane, "(b) w4 fp16")
        engine.install_params(4, carried("fp16"))
        if not same_bits(torch, packed_leaves(torch, engine), packed):
            raise AssertionError("install_wire (b): packed leaves differ from install_params'")
        want, lr = streams(plane, "(b) reference")
        case.update(streams_equal=got == want)
        cases["b"], launches["b"] = case, {k: lb[k] + lr[k] for k in lb}
        if got != want:
            raise AssertionError(f"install_wire (b): streams differ: {agreement(got, want)}")
    finally:
        plane.stop()
    del plane, engine, own, packed
    torch.cuda.empty_cache()
    plane = build_serving(ServeConfig(), cfg, params, device=dev, start_server=False)
    try:
        engine = plane.engine
        # (c) fp32 weights, fp16 snapshot
        case = swap(engine, 1, "fp16")
        dense = [w.clone() for w in flatten_params(engine.params)]
        got, lc = streams(plane, "(c) fp32 fp16")
        engine.install_params(2, carried("fp16"))
        if not all(torch.equal(a, b) for a, b in zip(dense, flatten_params(engine.params))):
            raise AssertionError("install_wire (c): weights differ from install_params'")
        want, lr = streams(plane, "(c) reference")
        case.update(streams_equal=got == want, agreement_with_phase4=agreement(got, serve[0]["tokens"]))
        cases["c"], launches["c"] = case, {k: lc[k] + lr[k] for k in lc}
        if got != want:
            raise AssertionError(f"install_wire (c): streams differ: {agreement(got, want)}")
    finally:
        plane.stop()
    del plane, engine, dense
    torch.cuda.empty_cache()
    for key, case in cases.items():
        log(f"install_wire 1b ({key}) {case['codec']}: host encode {case['encode_s']:.2f} s; install "
            f"{case['install_s']:.3f} s = decode {case['decode_s']:.3f} + H2D {case['h2d_s']:.3f} + pack "
            f"{case['pack_s']:.3f} s (and the rest); card memory {case['before_gib']:.2f} GiB before, peak "
            f"{case['peak_gib']:.2f}, after {case['after_gib']:.2f}; streams equal the reference's | {card}")
    return {"cases": cases, "launches": launches}


# the SKILL's 25-step drive (ROADMAP.md A9, gate 3): 2m, local_steps 10,
# ramp data, batch 32 x 256, accum 2; ln(1024) = 6.93 at the start
GATE3 = dict(steps=25, local_steps=10, batch=32, seq=256, accum=2, loss_below=6.2)


def phase_gate3(torch, tfa, dev, card: str) -> dict:
    """``DiLoCoOptimizer`` over ``LoopbackWorld(1)`` at config_2m on the
    card, as a user drives it: the loss must fall from about ln(1024) to
    below 6.2 by step 25, with an outer step every 10 steps."""
    from opendiloco_torch.config import DilocoConfig
    from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
    from opendiloco_torch.models.hf_io import get_model
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg, _ = get_model("2m")
    trainer = InnerTrainer(cfg, TrainerConfig(warmup_steps=5, total_steps=1000), device=dev)
    state = trainer.init_state(0)
    (backend,) = LoopbackWorld(1).make_backends()
    g = GATE3
    opt = DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=g["local_steps"], backend="loopback"),
                          state, g["batch"])
    rng = np.random.default_rng(0)
    losses, outer_at = [], []
    tfa.LAUNCHES.reset()
    for step in range(g["steps"]):
        ids = ((rng.integers(0, cfg.vocab_size, (g["batch"], 1)) + np.arange(g["seq"])) % cfg.vocab_size)
        ids = ids.astype(np.int32)
        state, m = opt.step(state, trainer.shard_batch(ids, ids.copy(), accum=g["accum"]))
        losses.append(float(m["loss"]))
        if "outer_step_s" in m:
            outer_at.append(step + 1)
    launches = {k: v for k, v in tfa.LAUNCHES.snapshot().items() if v}
    log(f"gate 3 (2m, 25 steps): losses {[round(x, 4) for x in losses]}; outer steps after steps {outer_at}; "
        f"launches {launches} | {card}")
    if not (abs(losses[0] - math.log(cfg.vocab_size)) < 0.2 and losses[-1] < g["loss_below"]):
        raise AssertionError(f"gate 3: loss {losses[0]} -> {losses[-1]}, want ~6.93 -> < {g['loss_below']}")
    if outer_at != [10, 20]:
        raise AssertionError(f"gate 3: outer steps after steps {outer_at}, want [10, 20]")
    return {**g, "losses": losses, "outer_after_steps": outer_at, "launches": launches}


def phase_weights_dir(torch, dev, card: str) -> dict:
    """A weights-directory round trip at config_150m: ``save_params`` of
    params drawn on the card, then ``get_model(dir)``: every leaf equal bit
    for bit."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from opendiloco_torch.models.convert import params_to_numpy
    from opendiloco_torch.models.hf_io import get_model, load_config, save_params
    from opendiloco_torch.models.llama import flatten_params, init_params

    cfg = load_config("150m")
    params = init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    d = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        save_params(params, cfg, d)
        t1 = time.perf_counter()
        cfg2, loaded = get_model(d)
        t2 = time.perf_counter()
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    want = flatten_params(params_to_numpy(params))
    got = flatten_params(loaded)
    # config.json spells out the kv heads a bare config leaves to default
    equal = cfg2 == dataclasses.replace(cfg, num_key_value_heads=cfg.kv_heads) and len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b) for a, b in zip(got, want))
    log(f"weights dir 150m: save_params {t1 - t0:.3f} s, get_model {t2 - t1:.3f} s, {nbytes} bytes, "
        f"{len(got)} leaves bit for bit: {equal} | {card}")
    if not equal:
        raise AssertionError("weights directory round trip at 150m changed a leaf or the config")
    return {"save_s": t1 - t0, "load_s": t2 - t1, "bytes": nbytes, "leaves": len(got)}


# the CLI on the card: config_2m, 20 steps, a checkpoint every 10
CLI_ARGS = ["--path-model", "2m", "--fake-data", "--fake-data-mode", "ramp", "--seq-length", "256",
            "--per-device-train-batch-size", "16", "--total-batch-size", "32", "--lr", "1e-3",
            "--warmup-steps", "4", "--total-steps", "20", "--metric-logger-type", "dummy",
            "--ckpt.interval", "10"]


def phase_cli(card: str) -> dict:
    """``python -m opendiloco_torch.train`` at 2m in a subprocess on the
    default device (no ``OPENDILOCO_TORCH_DEVICE``): 20 steps with a
    checkpoint at step 10, then again resuming from ``model_step_10``. The
    rows of steps 11-20 must equal the first run's bit for bit."""
    import os
    import pickle
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp()
    env = {k: v for k, v in os.environ.items() if k != "OPENDILOCO_TORCH_DEVICE"}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    ckpts = os.path.join(tmp, "ckpts")
    rows, secs = {}, {}
    try:
        for label, extra in (("full", []), ("resumed", ["--ckpt.resume", os.path.join(ckpts, "model_step_10")])):
            project = os.path.join(tmp, f"{label}.pkl")
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "opendiloco_torch.train", *CLI_ARGS, "--project", project,
                                  "--ckpt.path", ckpts, *extra], cwd=root, env=env, capture_output=True,
                                 text=True, timeout=600)
            secs[label] = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"CLI {label} run exited {res.returncode}: {res.stderr[-3000:]}")
            with open(project, "rb") as f:
                rows[label] = pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    full = {r["step"]: r for r in rows["full"]}
    resumed = rows["resumed"]
    keys = ("Loss", "lr", "grad_norm")
    log(f"CLI 2m: {len(rows['full'])} rows, resumed {len(resumed)} from step {resumed[0]['step']}; "
        f"{secs['full']:.1f} s / {secs['resumed']:.1f} s a process; losses "
        f"{[round(r['Loss'], 4) for r in rows['full']]} | {card}")
    if len(full) != 20 or [r["step"] for r in resumed] != list(range(11, 21)):
        raise AssertionError(f"CLI rows: {sorted(full)} and resumed {[r['step'] for r in resumed]}")
    differ = [r["step"] for r in resumed if any(r[k] != full[r["step"]][k] for k in keys)]
    if differ:
        raise AssertionError(f"CLI resume: steps {differ} differ from the first run")
    return {"steps": len(full), "resumed_steps": len(resumed), "process_s": secs,
            "losses": [r["Loss"] for r in rows["full"]]}


def phase_train_f32(torch, tfa, dev, card: str) -> dict:
    """One inner step at config_150m in f32 (``precision="fp32"``) with the
    fused loss on, the path that takes the first design's kernels: the
    launch counters are zeroed just before and read just after (B1 2 x 12
    x accum, B2a and B2b 12 x accum of the first design, the delta kernel
    12 x accum, B3 accum, the first design's dlog and dh and B4b accum x 4,
    the sm90 kernels never). Then the same step through plain attention
    (``attn_impl="xla"``) and the materialized loss on the same params and
    batch: f32 throughout, sums in another order over 12 layers, so the
    loss (~10.4) agrees to 1e-4 and the gradient norm to 1e-3 of itself."""
    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.ops import fused_xent as tfx
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg, run = load_config("150m"), TRAIN_150M
    L, accum = cfg.num_hidden_layers, run["total_batch_size"] // run["per_device_train_batch_size"]
    ds = iter(FakeTokenizedDataset(run["seq_length"], cfg.vocab_size, seed=7, mode="ramp"))
    ids = np.stack([next(ds)["input_ids"] for _ in range(run["total_batch_size"])])
    res = {"config": "150m", "precision": "fp32", "accum": accum}
    chunks = -(-run["per_device_train_batch_size"] * (run["seq_length"] - 1) // tfx.CHUNK_ROWS)
    for label, impl, fused in (("kernels", "pallas", True), ("plain", "xla", False)):
        tr = InnerTrainer(cfg, TrainerConfig(precision="fp32", remat=True, warmup_steps=2, total_steps=100,
                                             attn_impl=impl, fused_loss=fused), device=dev)
        state = tr.init_state(3)
        batch = tr.shard_batch(ids, ids.copy(), accum=accum)
        torch.cuda.synchronize()
        tfa.LAUNCHES.reset()
        t0 = time.perf_counter()
        state, m = tr.train_step(state, batch)
        res[label] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "step_ms_first": (time.perf_counter() - t0) * 1e3}
        if label == "kernels":
            launches = tfa.LAUNCHES.snapshot()
            want = {name: 0 for name in launches}
            want.update({"flash_attention_fwd": 2 * L * accum, "flash_attention_dq": L * accum,
                         "flash_attention_dkv": L * accum, "flash_attention_delta": L * accum,
                         "fused_xent_fwd": accum, "fused_xent_dlog": accum * chunks,
                         "fused_xent_dh": accum * chunks, "fused_xent_dw": accum * chunks})
            if launches != want:
                raise AssertionError(f"f32 step launch counts {launches} != {want}")
            res["launches"] = launches
        del tr, state, batch, m
        torch.cuda.empty_cache()
    kl, kg, pl_, pg = res["kernels"]["loss"], res["kernels"]["grad_norm"], res["plain"]["loss"], res["plain"]["grad_norm"]
    log(f"train 150m fp32 step (fused loss / materialized): kernels / plain loss {kl:.6f} / {pl_:.6f}, "
        f"grad norm {kg:.6f} / {pg:.6f}; "
        f"launches {res['launches']} | {card}")
    if not (math.isfinite(kl) and abs(kl - pl_) <= 1e-4 and abs(kg - pg) <= 1e-3 * pg):
        raise AssertionError(f"fp32 step: kernels vs plain loss {kl} vs {pl_}, grad norm {kg} vs {pg}")
    return res


# ---------------------------------------------------------------------------
# phase 10, device placement; phase 21: the outer plane on the card
# ---------------------------------------------------------------------------


def outer_split(outer: dict) -> dict:
    """Each outer-step phase's seconds, the mean over workers and rounds."""
    return {k: float(np.mean(v)) for k, v in outer.items()}


def phase_train_device(torch, tfa, dev, card: str, model: str, run: dict, host: dict) -> dict:
    """Phase 10's two-worker training once more with
    ``outer_placement="device"``: the launch counts, each step's loss and
    LR, and the master hashes as each round begins and at the end must
    equal the host run's (``host``: phase 10's result) bit for bit. Prints
    the outer step's split for both placements side by side (the
    all-reduce includes the smoke's hash of the master, which a peer fetch
    copies first: from host RAM or, here, from the card) and the peak
    device memory of the two workers."""
    tw = train_workers(torch, tfa, dev, model, run, diloco=dict(outer_placement="device"))
    losses = [[r["Loss"] for r in rr] for rr in tw["rows"]]
    lrs = [[r["lr"] for r in rr] for rr in tw["rows"]]
    if tw["launches"] != host["launches"]:
        raise AssertionError(f"device placement launches {tw['launches']} != host's {host['launches']}")
    if losses != host["losses"] or lrs != host["lrs"] or tw["hashes"] != host["master_hashes"]:
        raise AssertionError(f"device placement differs from host: losses {losses} vs {host['losses']}, lrs {lrs} "
                             f"vs {host['lrs']}, master hashes {tw['hashes']} vs {host['master_hashes']}")
    split = {"host": outer_split({k: host[k] for k in OUTER_KEYS}), "device": outer_split(tw["outer"])}
    res = {"config": model, "outer_placement": "device", "losses": losses, "lrs": lrs, "launches": tw["launches"],
           "master_hashes": tw["hashes"], **tw["outer"], "outer_split_by_placement": split,
           "peak_memory_gib_two_workers": {"host": host["peak_memory_gib_two_workers"], "device": tw["peak_gb"]},
           "train_wall_s": {"host": host["train_wall_s"], "device": tw["wall"]}}
    for pl in ("host", "device"):
        sp = split[pl]
        log(f"train {model} outer step, {pl} placement: {sp['outer_step_s']:.3f} s mean over "
            f"{len(tw['outer']['outer_step_s'])} (wait {sp['outer_wait_s']:.3f}, D2H {sp['outer_d2h_s']:.3f} beside "
            f"it, pseudo-gradient {sp['outer_pseudo_grad_s']:.3f}, all-reduce {sp['outer_allreduce_s']:.3f}, "
            f"Nesterov {sp['outer_nesterov_s']:.3f}, H2D {sp['outer_h2d_s']:.3f}) | {card}")
    log(f"train {model}: peak device memory, two workers: host placement {host['peak_memory_gib_two_workers']:.2f} "
        f"GiB, device placement {tw['peak_gb']:.2f} GiB | {card}")
    log(f"train {model}: device placement's losses, LRs, launches and master hashes equal the host run's bit for bit")
    return res


# phase 21, config_150m as phase 8 (mb 8, accum 2, seq 1024), 4 steps and
# local_steps 2: two outer rounds, so the second finds the momentum armed
OUTER_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                  total_steps=4, local_steps=2, lr=1e-3)
OUTER_CASES = {
    "blocking": dict(diloco={}, compression="none", pin=None),
    "eager": dict(diloco=dict(overlap_comm="eager"), compression="none", pin="pending"),
    "delayed": dict(diloco=dict(overlap_comm="delayed"), compression="none", pin="pending"),
    "streaming x eager, error feedback, uniform8bit": dict(
        diloco=dict(streaming_fragments=3, overlap_comm="eager", error_feedback=True, compression="uniform8bit"),
        compression="uniform8bit", pin="flush"),
}


def outer_run(torch, tfa, dev, cfg, run: dict, placement: str, case: dict) -> dict:
    """Two workers, one thread each, through ``InnerTrainer`` and
    ``DiLoCoOptimizer`` (what ``train()`` drives) on phase 8's data and
    init. The landings are pinned as the CPU suites pin them, so both
    placements land every round at the same step: "pending" waits for
    the overlapped round before the next step, "flush" lands the streaming
    rounds after each step. Per worker: losses, LRs, hashes of the final
    master, momentum and error-feedback residuals, and of the serving
    snapshot ``master_snapshot_wire``; the launch counters are zeroed just
    before and read just after."""
    from opendiloco_torch.config import DilocoConfig
    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    accum = run["total_batch_size"] // run["per_device_train_batch_size"]
    backends = LoopbackWorld(2, compression=case["compression"]).make_backends()

    def worker(rank):
        t0 = time.perf_counter()
        trainer = InnerTrainer(cfg, TrainerConfig(lr=run["lr"], warmup_steps=run["warmup_steps"],
                                                  total_steps=run["total_steps"], precision="bf16-mixed", remat=True),
                               device=dev)
        state = trainer.init_state(42)
        dc = DilocoConfig(local_steps=run["local_steps"], backend="loopback", world_rank=rank,
                          timeout_waiting_for_peers=600.0, outer_placement=placement,
                          **{"compression": case["compression"], **case["diloco"]})
        opt = DiLoCoOptimizer(trainer, backends[rank], dc, state, batch_size=run["total_batch_size"])
        ds = iter(FakeTokenizedDataset(run["seq_length"], cfg.vocab_size, seed=42 + rank, mode="ramp"))
        losses, lrs, outer = [], [], []
        t1 = time.perf_counter()
        for step in range(run["total_steps"]):
            ids = np.stack([next(ds)["input_ids"] for _ in range(run["total_batch_size"])])
            state, m = opt.step(state, trainer.shard_batch(ids, ids.copy(), accum))
            losses.append(float(m["loss"]))
            lrs.append(trainer.current_lr(step + 1))
            if "outer_step_s" in m:
                outer.append(m["outer_step_s"])
            if case["pin"] == "pending" and opt._pending is not None:
                while not opt._pending["future"].done():
                    time.sleep(0.001)
            elif case["pin"] == "flush":
                state = opt.flush(state)
        state = opt.flush(state)
        t2 = time.perf_counter()
        sd = opt.state_dict()
        _, blobs, codec = opt.master_snapshot_wire()
        wire = hashlib.sha256()
        for payload, meta, shape in blobs:
            wire.update(bytes(payload))
            wire.update(json.dumps([meta, list(shape)], sort_keys=True).encode())
        ef = sd.get("ef_residual")
        return {"losses": losses, "lrs": lrs, "outer_step_s": outer, "epoch": sd["epoch"],
                "master": master_hash(sd["master"]), "bufs": master_hash(sd["outer_opt"]["bufs"]),
                "ef": None if ef is None else master_hash([np.ascontiguousarray(r, np.float32) for r in ef]),
                "ef_abs_max": None if ef is None else max(float(np.abs(r).max()) for r in ef if r is not None),
                "wire": wire.hexdigest(), "wire_codec": codec,
                "seconds": {"init": t1 - t0, "steps": t2 - t1, "checks": time.perf_counter() - t2}}

    torch.cuda.synchronize()
    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    workers = run_workers(worker, [(r,) for r in range(2)])
    res = {"workers": workers, "launches": tfa.LAUNCHES.snapshot(), "wall_s": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_outer_plane(torch, tfa, dev, card: str) -> dict:
    """Phase 21: each case of ``OUTER_CASES`` under host, then device
    placement (:func:`outer_run`); everything must be equal bit for bit:
    each worker's losses, LRs, final master, momentum and residual hashes
    and serving snapshot bytes, and the launch counts (those of
    :func:`training_launches`). Under error feedback the residuals are
    non-zero."""
    import dataclasses

    from opendiloco_torch.models.hf_io import load_config

    # 150m's widths at CUT_LAYERS of its 12 layers: the smoke's time limit
    # (at full depth the phase took 167.7 s of a 993.6 s smoke on an H100)
    cfg, run = dataclasses.replace(load_config("150m"), num_hidden_layers=CUT_LAYERS), OUTER_150M
    out = {}
    for name, case in OUTER_CASES.items():
        runs = {pl: outer_run(torch, tfa, dev, cfg, run, pl, case) for pl in ("host", "device")}
        want = training_launches(torch, dev, cfg, run, 2 * run["total_steps"], runs["host"]["launches"])
        for pl, r in runs.items():
            if r["launches"] != want:
                raise AssertionError(f"outer plane {name}, {pl}: launch counts {r['launches']} != {want}")
        keys = ("losses", "lrs", "epoch", "master", "bufs", "ef", "wire", "wire_codec")
        h, d = ([{k: w[k] for k in keys} for w in runs[pl]["workers"]] for pl in ("host", "device"))
        if h != d:
            raise AssertionError(f"outer plane {name}: device placement differs from host: {d} vs {h}")
        if h[0]["master"] != h[1]["master"] or h[0]["epoch"] != run["total_steps"] // run["local_steps"]:
            raise AssertionError(f"outer plane {name}: workers' masters differ or rounds missing: {h}")
        if case["diloco"].get("error_feedback") and not all(w["ef_abs_max"] > 0 for w in runs["device"]["workers"]):
            raise AssertionError(f"outer plane {name}: residuals are zero: {runs['device']['workers']}")
        out[name] = {pl: {"wall_s": r["wall_s"], "launches": r["launches"],
                          "outer_step_s": [w["outer_step_s"] for w in r["workers"]],
                          "worker_seconds": [w["seconds"] for w in r["workers"]],
                          "ef_abs_max": [w["ef_abs_max"] for w in r["workers"]]} for pl, r in runs.items()}
        out[name]["workers"] = h
        log(f"outer plane 150m, {name}: device placement equals host bit for bit (losses {h[0]['losses']}, "
            f"master {h[0]['master'][:12]}, momentum {h[0]['bufs'][:12]}, snapshot {h[0]['wire_codec']} "
            f"{h[0]['wire'][:12]}); wall host {runs['host']['wall_s']:.1f} s, device {runs['device']['wall_s']:.1f} s; "
            f"outer step s host {out[name]['host']['outer_step_s']}, device {out[name]['device']['outer_step_s']}; "
            f"worker s (init, steps, checks) host {out[name]['host']['worker_seconds']}, device "
            f"{out[name]['device']['worker_seconds']} | {card}")
    return out


SHARDED_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                    total_steps=8, local_steps=4, lr=1e-3)
SHARDED_STRATEGIES = ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD", "HYBRID_SHARD", "HYBRID_SHARD_ZERO2")
# phase 18's command line (2m, bf16, attention through the kernels) under
# torchrun, FULL_SHARD
SHARDED_CLI = ["--path-model", "2m", "--fake-data", "--fake-data-mode", "ramp", "--seq-length", "256",
               "--per-device-train-batch-size", "16", "--total-batch-size", "32", "--lr", "1e-3", "--warmup-steps", "2",
               "--total-steps", "8", "--metric-logger-type", "dummy", "--ckpt.interval", "4",
               "--sharding-strategy", "FULL_SHARD"]


def sharded_run(torch, tfa, dev, tmp: str, strategy: str | None, model: str) -> dict:
    """``train()`` of one loopback worker at SHARDED_150M on ``model``, under
    ``strategy`` in the caller's process group (None: NO_SHARD with no
    group); the launch counters zeroed just before and read just after."""
    import os
    import pickle

    from opendiloco_torch.config import Config
    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.train import train

    run = SHARDED_150M
    label = strategy or "no group"
    project = os.path.join(tmp, f"{label.replace(' ', '-')}.pkl")
    config = Config(
        path_model=model, fake_data=True, fake_data_mode="ramp", precision="bf16-mixed", remat=True,
        attn_implementation="pallas", fused_loss=True, seq_length=run["seq_length"],
        per_device_train_batch_size=run["per_device_train_batch_size"], total_batch_size=run["total_batch_size"],
        warmup_steps=run["warmup_steps"], total_steps=run["total_steps"], lr=run["lr"], metric_logger_type="dummy",
        project=project, sharding_strategy=strategy or "NO_SHARD",
        # the device plane: the host outer step (about 6 s a round at 150m)
        # would take most of the phase
        diloco=dict(local_steps=run["local_steps"], backend="loopback", world_rank=0, outer_placement="device"))
    (backend,) = recording_backends(LoopbackWorld(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    train(config, backend, dev)
    wall = time.perf_counter() - t0
    launches = tfa.LAUNCHES.snapshot()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(project, "rb") as f:
        rows = pickle.load(f)
    rounds = run["total_steps"] // run["local_steps"]
    backend.hashes[rounds] = master_hash(backend.provider()["master"])
    out = {"losses": [r["Loss"] for r in rows], "lrs": [r["lr"] for r in rows],
           "grad_norms": [r["grad_norm"] for r in rows], "hashes": dict(backend.hashes),
           "step_ms_median": float(np.median([r["time_taken"] for r in rows[1:]])) * 1e3,
           "step_ms": [r["time_taken"] * 1e3 for r in rows], "peak_gib": peak_gib, "launches": launches,
           "wall_s": wall}
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_cli(tmp: str) -> dict:
    """SHARDED_CLI under ``torch.distributed.run`` with one process, then
    resuming from its ``model_step_4``: steps 5-8 must equal bit for bit."""
    import os
    import pickle

    env = {k: v for k, v in os.environ.items() if k != "OPENDILOCO_TORCH_DEVICE"}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    ckpts = os.path.join(tmp, "cli-ckpts")
    rows, secs = {}, {}
    for label, extra in (("full", []), ("resumed", ["--ckpt.resume", os.path.join(ckpts, "model_step_4")])):
        project = os.path.join(tmp, f"cli-{label}.pkl")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
                              "-m", "opendiloco_torch.train", *SHARDED_CLI, "--project", project,
                              "--ckpt.path", ckpts if label == "full" else os.path.join(tmp, "cli-ckpts2"), *extra],
                             cwd=root, env=env, capture_output=True, text=True, timeout=400)
        secs[label] = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"torchrun CLI {label} run exited {res.returncode}: {res.stderr[-3000:]}")
        with open(project, "rb") as f:
            rows[label] = pickle.load(f)
    full = {r["step"]: r for r in rows["full"]}
    resumed = rows["resumed"]
    if sorted(full) != list(range(1, 9)) or [r["step"] for r in resumed] != [5, 6, 7, 8]:
        raise AssertionError(f"torchrun CLI rows: {sorted(full)} and resumed {[r['step'] for r in resumed]}")
    keys = ("Loss", "lr", "grad_norm")
    differ = [r["step"] for r in resumed if any(r[k] != full[r["step"]][k] for k in keys)]
    if differ:
        raise AssertionError(f"torchrun CLI resume: steps {differ} differ from the first run")
    if not os.path.exists(os.path.join(ckpts, "model_step_4", "dataloader_0.json")):
        raise AssertionError("torchrun CLI: no dataloader_0.json in the checkpoint")
    return {"process_s": secs, "losses": [full[s]["Loss"] for s in sorted(full)],
            "step_ms": [full[s]["time_taken"] * 1e3 for s in sorted(full)]}


def phase_sharded(torch, tfa, dev, card: str) -> dict:
    """Phase 23: the sharded trainer on the card at world 1 over NCCL (see
    the module docstring). Every strategy's losses, LRs and master hashes
    equal the run without a group bit for bit, and each run's launches
    are those of :func:`training_launches` with the fused loss on."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from opendiloco_torch.models.hf_io import load_config

    run = SHARDED_150M
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    model = cut_depth("150m", CUT_LAYERS, tmp)  # the smoke's time limit
    cfg = load_config(model)
    try:
        runs = {"no group": sharded_run(torch, tfa, dev, tmp, None, model)}
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            for strategy in SHARDED_STRATEGIES:
                runs[strategy] = sharded_run(torch, tfa, dev, tmp, strategy, model)
        finally:
            dist.destroy_process_group()
        cli = sharded_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = runs["no group"]
    want = training_launches(torch, dev, cfg, run, run["total_steps"], ref["launches"], fused=True)
    for label, r in runs.items():
        if r["launches"] != want:
            raise AssertionError(f"sharded 150m, {label}: launch counts {r['launches']} != {want}")
        if not all(math.isfinite(x) for x in r["losses"]) or len(r["losses"]) != run["total_steps"]:
            raise AssertionError(f"sharded 150m, {label}: losses {r['losses']}")
        if (r["losses"], r["lrs"], r["grad_norms"], r["hashes"]) != (ref["losses"], ref["lrs"], ref["grad_norms"],
                                                                     ref["hashes"]):
            raise AssertionError(f"sharded 150m, {label}: differs from the run without a group: losses "
                                 f"{r['losses']} vs {ref['losses']}, hashes {r['hashes']} vs {ref['hashes']}")
    secs = time.perf_counter() - t0
    for label, r in runs.items():
        log(f"sharded 150m, {label}: step {r['step_ms_median']:.1f} ms (median after the first), peak device "
            f"memory {r['peak_gib']:.2f} GiB, wall {r['wall_s']:.1f} s, launches "
            f"{json.dumps({k: v for k, v in r['launches'].items() if v})} | {card}")
    log(f"sharded 150m: every strategy at world 1 over NCCL equals the run without a group bit for bit (losses "
        f"{[round(x, 4) for x in ref['losses']]}, master {ref['hashes'][max(ref['hashes'])][:12]}); torchrun CLI "
        f"FULL_SHARD resumes bit for bit ({cli['process_s']['full']:.1f} s / {cli['process_s']['resumed']:.1f} s a "
        f"process); phase {secs:.1f} s | {card}")
    return {"runs": runs, "cli": cli, "seconds": secs, "launches": {
        name: sum(r["launches"].get(name, 0) for r in runs.values()) for name in ref["launches"]}}


# ---------------------------------------------------------------------------
# phase 24: the TCP galaxy
# ---------------------------------------------------------------------------

# phase 24's 150m round on the uniform8bit codec: 4 steps, one outer round
TCP_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                total_steps=4, local_steps=4, lr=1e-3)
# the stage times of a round's health row (diloco/tcp.py last_round_health):
# matchmaking, flatten, scatter-reduce, gather and the round's wall, then the
# per-stage work summed over the pipelined chunks
ROUND_KEYS = ("matchmake_s", "flatten_s", "scatter_reduce_s", "all_gather_s", "round_s", "encode_s",
              "accumulate_s", "wire_send_s", "wire_recv_s")


class RssSampler:
    """The process's resident set (``/proc/self/status`` VmRSS) every 50 ms
    on a daemon thread until :meth:`stop`, which returns the peak in GiB."""

    def __init__(self):
        self.peak, self._stop = 0.0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def now() -> float:
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) for line in f if line.startswith("VmRSS")) / 2**20

    def _run(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, self.now())
            time.sleep(0.05)

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return self.peak


def tcp_workers(torch, tfa, dev, address: str, model: str, run: dict, codec: str, placement: str = "host",
                before_close=None, extra: dict | None = None) -> dict:
    """:func:`train_workers` over TCP: each worker's ``train()`` gets no
    backend and makes its own (``train.make_backend``: a ``TcpBackend`` at
    the rendezvous ``address``), which records as the loopback ones do.
    Both start from the same seed and fetch no state from each other
    (``skip_load_from_peers``: a joiner's download is fp16, which would
    round its master). Adds each worker's round ledger (its
    ``last_round_health`` rows), and the backends themselves (their state
    providers read the workers' final masters). ``before_close(backend)``
    runs as ``train()`` closes each backend, just before it closes;
    ``extra`` goes to :func:`train_workers`."""
    import opendiloco_torch.train as ttrain

    made, make = [], ttrain.make_backend

    def make_backend(cfg):
        backend = record_masters(make(cfg))
        if before_close is not None:
            close = backend.close

            def closing():
                before_close(backend)
                close()

            backend.close = closing
        made.append(backend)
        return backend

    ttrain.make_backend = make_backend
    try:
        tw = train_workers(torch, tfa, dev, model, run, made=made, extra=extra,
                           diloco=dict(backend="tcp", initial_peers=[address], compression=codec,
                                       skip_load_from_peers=True, outer_placement=placement))
    finally:
        ttrain.make_backend = make
    tw["backends"] = sorted(made, key=lambda b: b.peer_id)
    tw["ledgers"] = [[{k: h[k] for k in ("round", "group_size", *ROUND_KEYS) if k in h} for h in b.round_ledger]
                     for b in tw["backends"]]
    return tw


def phase_tcp(torch, tfa, dev, card: str, loopback: dict) -> dict:
    """Phase 24: the TCP galaxy. Two config_1b workers, one thread each,
    run ``train()`` as phase 10 does (same seeds, data and steps: 4 steps,
    ``local_steps`` 2, two outer rounds, codec none), but with
    ``diloco.backend="tcp"`` and no backend handed in, and the master and
    momentum on the card (``outer_placement="device"``, which equals
    phase 10's host placement bit for bit: phase 10b; on the host two
    TCP workers of one process would hold 2 x 30 GB of host RAM against
    the machine's 96 GiB): each makes a
    ``TcpBackend`` (``train.make_backend``) that meets the other at the
    port's ``RendezvousServer`` on localhost (``ODTP_EXPECT_PEERS`` 2, so
    the round closes when both have joined) and averages over real
    sockets, the bulk plane carrying the 2.2 GB parts. With two workers a
    + b then x 0.5 is exact whatever the order, so the launch counts, each
    step's loss and LR and the master hashes as each round begins and at
    the end must equal phase 10's (``loopback``) bit for bit; otherwise
    the largest difference of worker 0's final master is printed and the
    phase fails. Then one 150m round on the ``uniform8bit`` codec through
    the port's host library (built here with g++): both workers' masters
    equal each other's bit for bit. Each round's stage times (the round
    ledger), the launches and the phase's peak host RSS are printed. The
    all-reduce is host work."""
    import os

    from opendiloco_torch import native
    from opendiloco_torch.diloco.rendezvous import RendezvousServer

    t0 = time.perf_counter()
    native.load()
    native_s = time.perf_counter() - t0
    ref_path = loopback.pop("master")
    rss = RssSampler()
    daemon = RendezvousServer("127.0.0.1", 0).start_in_thread()
    expect = os.environ.get("ODTP_EXPECT_PEERS")
    os.environ["ODTP_EXPECT_PEERS"] = "2"
    try:
        runs = {"1b": tcp_workers(torch, tfa, dev, daemon.address, loopback["config"], TRAIN_1B, "none",
                                  placement="device")}
        tw = runs["1b"]
        backends = tw.pop("backends")
        losses = [[r["Loss"] for r in rr] for rr in tw["rows"]]
        lrs = [[r["lr"] for r in rr] for rr in tw["rows"]]
        if (tw["launches"], losses, lrs, tw["hashes"]) != (loopback["launches"], loopback["losses"],
                                                            loopback["lrs"], loopback["master_hashes"]):
            master = master_now(backends[0].provider)
            diff = max(float(np.max(np.abs(a - b))) for a, b in zip(master, load_master(ref_path, master)))
            raise AssertionError(f"TCP 1b differs from the loopback run: final master max |diff| {diff}, losses "
                                 f"{losses} vs {loopback['losses']}, lrs {lrs} vs {loopback['lrs']}, hashes "
                                 f"{tw['hashes']} vs {loopback['master_hashes']}, launches {tw['launches']} vs "
                                 f"{loopback['launches']}")
        # the two workers' host state (masters, momentum) goes before the next run
        del backends
        os.remove(ref_path)
        gc.collect()
        torch.cuda.empty_cache()
        runs["150m uniform8bit"] = tcp_workers(torch, tfa, dev, daemon.address, "150m", TCP_150M, "uniform8bit")
        runs["150m uniform8bit"].pop("backends")
    finally:
        rss_gib = rss.stop()
        daemon.stop()
        if expect is None:
            os.environ.pop("ODTP_EXPECT_PEERS")
        else:
            os.environ["ODTP_EXPECT_PEERS"] = expect
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    res = {"host_library_load_s": native_s, "seconds": secs, "host_peak_rss_gib": rss_gib}
    for label, r in runs.items():
        for rank, ledger in enumerate(r["ledgers"]):
            for h in ledger:
                log(f"tcp {label} worker {rank} round {h['round']}: group {h['group_size']}, "
                    + ", ".join(f"{k[:-2]} {h[k]:.3f} s" for k in ROUND_KEYS if k in h) + f" | {card}")
        split = outer_split(r["outer"])
        log(f"tcp {label}: outer step {split['outer_step_s']:.3f} s mean (all-reduce {split['outer_allreduce_s']:.3f} s, "
            f"the smoke's master hash inside it; pseudo-gradient {split['outer_pseudo_grad_s']:.3f}, Nesterov "
            f"{split['outer_nesterov_s']:.3f}, D2H {split['outer_d2h_s']:.3f}, H2D {split['outer_h2d_s']:.3f}), "
            f"launches {json.dumps({k: v for k, v in r['launches'].items() if v})}, wall {r['wall']:.1f} s | {card}")
        res[label] = {"ledgers": r["ledgers"], "outer_split": split, "launches": r["launches"],
                      "master_hashes": r["hashes"], "losses": [[x["Loss"] for x in rr] for rr in r["rows"]],
                      "train_wall_s": r["wall"], "peak_memory_gib_two_workers": r["peak_gb"]}
    log(f"tcp: 1b over TcpBackends equals the loopback run bit for bit (losses, LRs, master hashes, launches); "
        f"150m uniform8bit masters equal across workers (host library loaded in {native_s:.2f} s, built at its first "
        f"use); the phase's peak host "
        f"RSS {rss_gib:.1f} GiB; phase {secs:.1f} s | {card}")
    return res


# ---------------------------------------------------------------------------
# phase 25: NoLoCo gossip rounds
# ---------------------------------------------------------------------------

def cut_depth(model: str, layers: int, folder: str) -> str:
    """A config file of ``model`` cut to ``layers`` decoder layers, its
    widths unchanged (phases 25 and 26: the smoke's time limit)."""
    import os

    from opendiloco_torch.models.hf_io import load_config

    path = os.path.join(folder, f"config_{model}_{layers}l.json")
    with open(path, "w") as f:
        json.dump({**load_config(model).to_dict(), "num_hidden_layers": layers}, f)
    return path


# phases 25 and 26 run config_150m's widths (d 1024, 16 heads x 64, ffn 2688,
# vocab 32000) at 2 of its 12 layers: at full depth, on an H100 machine with
# 8 host cores, the two took 222 s and the smoke 1157.6 s of its 1200 s (a
# 150m pair round is 13-24 s of host work)
CUT_LAYERS = 2
# phase 25, as phase 8's run (mb 8, accum 2, seq 1024, lr 1e-3): three
# loopback workers (an odd galaxy: one self-round a round), 4 steps,
# local_steps 2 (2 gossip rounds), blockwise4bit with error feedback
GOSSIP_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                   total_steps=4, local_steps=2, lr=1e-3)
GOSSIP_PAIR_FRAGMENTS = 4  # the three-way pair round runs on fragment 0 of 4
GOSSIP_DILOCO = dict(outer_mode="gossip", compression="blockwise4bit", error_feedback=True)
GOSSIP_WORKERS = 3


def gossip_workers(torch, tfa, dev, model: str, run: dict, placement: str, n: int) -> dict:
    """``n`` loopback workers, one thread each, run ``train()`` with
    ``outer_mode="gossip"`` on ``placement``; the launch counters are zeroed
    just before and read just after and held to :func:`training_launches`.
    Returns the metric rows, launches, each worker's final master hash,
    round ledger and state provider."""
    import os
    import pickle
    import shutil
    import tempfile

    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.train import train

    cfg = load_config(model)
    backends = recording_backends(LoopbackWorld(n))  # for their state providers (gossip runs no all-reduce)
    tmp = tempfile.mkdtemp()

    def config(rank):
        return train_config(model, run, rank, os.path.join(tmp, f"metrics-{rank}.pkl"),
                            dict(path=os.path.join(tmp, "ckpts"), interval=None),
                            diloco={**GOSSIP_DILOCO, "outer_placement": placement})

    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    run_workers(train, [(config(r), backends[r], dev) for r in range(n)])
    wall = time.perf_counter() - t0
    launches = tfa.LAUNCHES.snapshot()
    want = training_launches(torch, dev, cfg, run, n * run["total_steps"], launches)
    check_launches(launches, want, f"gossip {model} {placement}")
    rows = []
    for rank in range(n):
        with open(os.path.join(tmp, f"metrics-{rank}.pkl"), "rb") as f:
            rows.append(pickle.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    losses = [[r["Loss"] for r in rr] for rr in rows]
    for rank, ls in enumerate(losses):
        if len(ls) != run["total_steps"] or not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"gossip {placement} worker {rank}: losses {ls}")
    return {"rows": rows, "losses": losses, "lrs": [[r["lr"] for r in rr] for rr in rows], "launches": launches,
            "hashes": [master_hash(master_now(b.provider)) for b in backends],
            "ledgers": [[h for h in b.round_ledger if h.get("gossip")] for b in backends],
            "providers": [b.provider for b in backends], "wall": wall}


def pair_exchange_runs(inputs: list, n_leaves: int) -> dict:
    """One pair round on the 150m leaves of two workers (their master,
    momentum and a pseudo-gradient), three ways: two GossipPlanes on a
    loopback world (lockstep), the same at async distance 0, and two over
    the port's TcpBackends and rendezvous on localhost. Each way's mixed
    master, momentum and pseudo-gradient on both ends, and its ledger."""
    import os

    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.diloco.backend import PeerProgress
    from opendiloco_torch.diloco.gossip import GossipPlane
    from opendiloco_torch.diloco.rendezvous import RendezvousServer
    from opendiloco_torch.diloco.tcp import TcpBackend

    def exchange(backends):
        planes = [GossipPlane(b, n_leaves, compression=GOSSIP_DILOCO["compression"], error_feedback=True)
                  for b in backends]
        out = run_workers(lambda r: planes[r].exchange(epoch=7, frag_id=0, idxs=list(range(n_leaves)),
                                                       masters=inputs[r][0], bufs=inputs[r][1], pgs=inputs[r][2],
                                                       timeout=300.0), [(0,), (1,)])
        if any(o is None or o[4] != 2 for o in out):
            raise AssertionError(f"pair exchange: a side did not pair ({[None if o is None else o[3:] for o in out]})")
        return [o[:3] for o in out], [dict(b.last_round_health) for b in backends]

    runs = {"loopback": exchange(LoopbackWorld(2).make_backends())}
    env = {"ODTP_ASYNC_STALENESS": "1", "ODTP_ASYNC_PATIENCE_S": "60"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        runs["async"] = exchange(LoopbackWorld(2).make_backends())
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    daemon = RendezvousServer("127.0.0.1", 0).start_in_thread()
    # the loopback ids, so the sorted-pair operand order is the same
    backends = [TcpBackend([daemon.address], peer_id=f"peer-{r}", matchmaking_time=2.0) for r in (0, 1)]
    try:
        for _ in range(2):  # the second report sees both members
            for b in backends:
                b.report_progress(PeerProgress(b.peer_id, 7, 0, 1.0, time.time()))
        runs["tcp"] = exchange(backends)
    finally:
        for b in backends:
            b.close()
        daemon.stop()
    return runs


def phase_gossip(torch, tfa, dev, card: str, p8: dict) -> dict:
    """Phase 25: three workers at config_150m's widths and CUT_LAYERS of
    its layers (GOSSIP_150M),
    ``outer_mode="gossip"`` with blockwise4bit and error feedback, on host
    then device placement: launches those of phase 8's kernels for 12
    inner steps, losses falling, one self-round a round, and the device
    run's losses, LRs and final master hashes the host run's bit for bit.
    Then one pair round on fragment 0 (of 4) of two workers' final
    masters and momentum, lockstep on loopback, async at distance 0 and
    over TcpBackends: the three equal bit for bit. Prints each round's exchange seconds and wire
    bytes a pair, the self-round share and the inner step beside phase
    8's."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    n, run = GOSSIP_WORKERS, GOSSIP_150M
    folder = tempfile.mkdtemp()
    model = cut_depth("150m", CUT_LAYERS, folder)
    host = gossip_workers(torch, tfa, dev, model, run, "host", n)
    rounds = run["total_steps"] // run["local_steps"]
    for rank, led in enumerate(host["ledgers"]):
        if len(led) != rounds:
            raise AssertionError(f"gossip worker {rank}: {len(led)} rounds in its ledger, want {rounds}")
    for r in range(rounds):
        sizes = sorted(led[r]["group_size"] for led in host["ledgers"])
        if sizes != [1, 2, 2]:
            raise AssertionError(f"gossip round {r}: group sizes {sizes}, want one self-round and one pair")
    dev_run = gossip_workers(torch, tfa, dev, model, run, "device", n)
    shutil.rmtree(folder, ignore_errors=True)
    for key in ("losses", "lrs", "hashes"):
        if dev_run[key] != host[key]:
            raise AssertionError(f"gossip: device placement's {key} {dev_run[key]} != host's {host[key]}")
    if dev_run["launches"] != host["launches"]:
        raise AssertionError(f"gossip: launches {dev_run['launches']} != {host['launches']}")

    # one pair round three ways, on fragment 0 of two workers' final state
    from opendiloco_torch.diloco.planner import fragment_partition

    inputs = []
    for provide in host["providers"][:2]:
        st = provide()
        frag = fragment_partition([x.size for x in st["master"]], GOSSIP_PAIR_FRAGMENTS)[0]
        m = [np.asarray(st["master"][i], np.float32) for i in frag]
        inputs.append((m, [np.asarray(st["outer_opt"]["bufs"][i], np.float32) for i in frag],
                       [x * np.float32(1e-3) for x in m]))
        del st
    t0 = time.perf_counter()
    pairs = pair_exchange_runs(inputs, len(inputs[0][0]))
    pair_wall = time.perf_counter() - t0
    ref = pairs["loopback"][0]
    for way in ("async", "tcp"):
        for side in range(2):
            for k in range(3):
                a, b = pairs[way][0][side][k], ref[side][k]
                if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"pair round {way} side {side} part {k} differs from the loopback lockstep's")
    for k in range(3):  # both ends hold the same bits
        if not all(np.array_equal(x, y) for x, y in zip(ref[0][k], ref[1][k])):
            raise AssertionError(f"pair round: the two ends differ in part {k}")
    del inputs, pairs["loopback"], ref

    def per_round(ledgers):
        return [[{k: h.get(k) for k in ("group_size", "partner", "pair_s", "wire_bytes")} for h in led]
                for led in ledgers]

    steps = {"gossip": inner_step_s(host["rows"]), "phase 8": p8["step_s"]}
    outer = {p: [r["outer_step_s"] for rr in x["rows"] for r in rr if "outer_step_s" in r]
             for p, x in (("host", host), ("device", dev_run))}
    pair_s = [h["pair_s"] for led in host["ledgers"] for h in led if h["group_size"] == 2]
    wire = [h["wire_bytes"] for led in host["ledgers"] for h in led if h["group_size"] == 2]
    res = {
        "config": f"150m widths, {CUT_LAYERS} layers", **run, "workers": n, **GOSSIP_DILOCO,
        "launches": host["launches"],
        "losses": host["losses"], "rounds": per_round(host["ledgers"]),
        "rounds_device": per_round(dev_run["ledgers"]),
        "pair_s": {"min": min(pair_s), "median": float(np.median(pair_s)), "max": max(pair_s)},
        "wire_bytes_per_side": sorted(set(wire)),
        "self_round_share": sum(h["group_size"] == 1 for led in host["ledgers"] for h in led) / (n * rounds),
        "inner_step_ms_median": {k: float(np.median(v)) * 1e3 for k, v in steps.items()},
        "outer_step_s": outer,
        "pair_exchange": {way: {"health": [{k: h.get(k) for k in ("pair_s", "wire_bytes", "pair_lag", "round")}
                                           for h in pairs[way][1]]} for way in ("async", "tcp")},
        "pair_exchange_wall_s": pair_wall,
        "train_wall_s": {"host": host["wall"], "device": dev_run["wall"]},
        "seconds": time.perf_counter() - t_phase,
    }
    log(f"gossip 150m ({CUT_LAYERS} layers) x{n}: {rounds} rounds, one self-round a round ({res['self_round_share']:.3f} of worker-rounds); "
        f"pair rounds {res['pair_s']} s, {res['wire_bytes_per_side']} wire bytes a side; inner step median "
        f"{res['inner_step_ms_median']} ms; outer step {outer} s | {card}")
    ran = {k: v for k, v in host["launches"].items() if v}
    log(f"gossip 150m ({CUT_LAYERS} layers): device placement equals host (losses, LRs, master hashes, launches {ran}); a "
        f"150m pair round equals on loopback, async at distance 0 and over TcpBackends "
        f"({json.dumps(res['pair_exchange'])}); phase {res['seconds']:.1f} s | {card}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 26: the serving fleet
# ---------------------------------------------------------------------------

# phase 26: one config_150m training worker (mb 8, accum 2, seq 1024; 4
# steps, local_steps 2: the last of its 2 rounds a keyframe) feeding two
# replicas (the fleet's geometry: 4 slots, ring 256, buckets 32/128)
FLEET_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                  total_steps=4, local_steps=2, lr=1e-3)
FLEET = dict(enabled=True, replicas=2, keyframe_every=2, prefix_cache=True, push_interval_s=0.1)
FLEET_PREFIX, FLEET_SUFFIX, FLEET_NEW_TOKENS = 96, 16, 32
FLEET_CLIENTS, FLEET_REQUESTS = 4, 4  # router traffic: clients x requests each


def fleet_prompts(vocab: int, seed: int) -> tuple[list, list]:
    """A shared 96-token prefix and two 16-token suffixes: (A, B)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, FLEET_PREFIX).tolist()
    return shared + rng.integers(1, vocab, FLEET_SUFFIX).tolist(), shared + rng.integers(1, vocab, FLEET_SUFFIX).tolist()


def pair_streams(submit_a, started, submit_b) -> list:
    """A, then B once A holds a slot (so that B's admit copies A's prefix):
    both streams. ``submit_*`` return a callable that waits and gives the
    tokens; ``started`` tells whether A holds a slot."""
    wait_a = submit_a()
    deadline = time.monotonic() + 120
    while not started():
        if time.monotonic() > deadline:
            raise AssertionError("fleet: the first request never reached a slot")
        time.sleep(0.002)
    wait_b = submit_b()
    return [wait_a(), wait_b()]


def http_async(port: int, prompt: list, n: int):
    """Post /generate on a thread; the returned callable waits for its
    tokens."""
    out = {}

    def go():
        out.update(http_json(f"http://127.0.0.1:{port}/generate",
                             json.dumps({"prompt": prompt, "max_new_tokens": n}).encode()))

    t = threading.Thread(target=go)
    t.start()

    def wait():
        t.join(timeout=300)
        if "tokens" not in out or "error" in out:
            raise AssertionError(f"fleet: a request failed: {out}")
        return out["tokens"]

    return wait


def fleet_checks(torch, tdk, dev, plane, cfg, inprocess: bool, prompts: tuple) -> dict:
    """At the fleet's teardown, the training done: wait until both replicas
    serve the last epoch, hold each replica's shared-prefix pair to a
    ServeEngine on the keyframed masters, then send router traffic (and,
    with processes, SIGKILL one replica under it)."""
    import signal

    from opendiloco_torch.models.llama import flatten_params, init_params, unflatten_params
    from opendiloco_torch.serve import ContinuousBatcher, ServeEngine

    L = cfg.num_hidden_layers
    epoch, masters = plane.publisher.snapshot_fn()
    rids = sorted(plane.replicas)
    deadline = time.monotonic() + 180
    while True:
        replies = plane.manager.status()["replicas"]
        if all(replies.get(r, {}).get("weights_epoch") == epoch for r in rids):
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: replicas never served epoch {epoch}: {replies}")
        time.sleep(0.02)
    pub = plane.publisher.stats()
    if any(pub["replicas"][r]["last_keyframe"] != epoch for r in rids):
        raise AssertionError(f"fleet: the last push was not a keyframe at epoch {epoch}: {pub}")

    # the reference: a ServeEngine holding the keyframe's decode of the masters
    codec = plane.publisher.kf_codec
    leaves = []
    for m in masters:
        flat = np.ascontiguousarray(m, np.float32).reshape(-1)
        payload, meta = codec.encode(flat)
        leaves.append(torch.from_numpy(np.asarray(codec.decode(payload, (flat.size,), meta), np.float32)
                                       .reshape(m.shape)))
    compute = torch.bfloat16 if inprocess else torch.float32  # the trainer's dtype in process, else f32
    template = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    geom = dict(num_slots=4, max_context=256, prefill_buckets=(32, 128))
    engine = ServeEngine(cfg, unflatten_params(template, leaves), compute_dtype=compute, device=dev, **geom)
    del template, leaves
    batcher = ContinuousBatcher(engine, prefix_cache=True).start()

    def ref_submit(p):
        def go():
            req = batcher.submit(p, max_new_tokens=FLEET_NEW_TOKENS)
            return lambda: (req.wait(300), req.tokens)[1]
        return go

    try:
        want = pair_streams(ref_submit(prompts[0]), lambda: batcher.slots.num_active >= 1, ref_submit(prompts[1]))
        if batcher.prefix_hits != 1:
            raise AssertionError(f"fleet reference: {batcher.prefix_hits} prefix hits, want 1")
    finally:
        batcher.stop()
    del engine, batcher
    torch.cuda.empty_cache()

    # each replica, directly: its streams against the reference's
    ports = {r: plane.manager.addr(r)[1] for r in rids}

    def stats(r):
        return http_json(f"http://127.0.0.1:{ports[r]}/stats", timeout=60)

    before = {r: stats(r) for r in rids}
    tdk.LAUNCHES.reset()
    streams = {}
    for r in rids:
        streams[r] = pair_streams(lambda r=r: http_async(ports[r], prompts[0], FLEET_NEW_TOKENS),
                                  lambda r=r: stats(r)["active"] >= 1,
                                  lambda r=r: http_async(ports[r], prompts[1], FLEET_NEW_TOKENS))
    launches = tdk.LAUNCHES.snapshot()
    after = {r: stats(r) for r in rids}
    for r in rids:
        if streams[r] != want:
            raise AssertionError(f"fleet replica {r}: streams {streams[r]} != the reference's {want}")
    hits = sum(after[r]["prefix"]["hits"] - before[r]["prefix"]["hits"] for r in rids)
    steps = sum(after[r]["decode_steps"] - before[r]["decode_steps"] for r in rids)
    if hits != len(rids):
        raise AssertionError(f"fleet: {hits} prefix hits over {len(rids)} replicas, want one each")
    per_step = None
    if inprocess and dev.type == "cuda":  # the replicas' kernels launch in this process
        if launches.get("paged_decode_attention") != L * steps or launches.get("spec_tail_attention") != L * hits:
            raise AssertionError(f"fleet: launches {launches}, want B6 {L} x {steps} decode steps and B7 {L} x "
                                 f"{hits} prefix hits")
        per_step = {k: launches.get(k, 0) / steps for k in ("paged_decode_attention", "paged_decode_attention_merge")}

    # router traffic, shared-prefix prompts; with processes a SIGKILL under it
    shared = prompts[0][:FLEET_PREFIX]
    outs, errors = [], []
    router_url = f"http://127.0.0.1:{plane.router.port}/generate"

    def client(i):
        rng = np.random.default_rng(100 + i)
        try:
            for _ in range(FLEET_REQUESTS):
                p = shared + rng.integers(1, cfg.vocab_size, FLEET_SUFFIX).tolist()
                t0 = time.perf_counter()
                out = http_json(router_url, json.dumps({"prompt": p, "max_new_tokens": FLEET_NEW_TOKENS}).encode())
                outs.append({**out, "t_sent": t0, "t_back": time.perf_counter()})
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(FLEET_CLIENTS)]
    killed = None
    for t in threads:
        t.start()
    if not inprocess:
        while len(outs) < FLEET_CLIENTS and not errors and any(t.is_alive() for t in threads):
            time.sleep(0.01)
        killed = rids[-1]
        plane.replicas[killed].send_signal(signal.SIGKILL)
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    bad = [o for o in outs if "error" in o or len(o.get("tokens", [])) != FLEET_NEW_TOKENS]
    if len(outs) != FLEET_CLIENTS * FLEET_REQUESTS or bad:
        raise AssertionError(f"fleet router: {len(outs)} answers, dropped or failed {bad[:3]}")
    rstats = plane.router.stats()
    if killed is not None and not rstats["replicas"][killed]["dead"]:
        raise AssertionError(f"fleet: the killed replica {killed} was not marked dead: {rstats}")
    window = max(o["t_back"] for o in outs) - min(o["t_sent"] for o in outs)
    alive = [r for r in rids if r != killed]
    ttft = {r: stats(r)["ttft_ms"] for r in alive}
    return {"epoch": epoch, "publisher": pub, "streams_equal_reference": True, "prefix_hits": hits,
            "decode_steps": steps, "launches": launches, "launches_per_decode_step": per_step,
            "router": {k: rstats[k] for k in ("redispatches", "deaths", "shed")}, "killed": killed,
            "router_answers": len(outs), "router_tokens_per_s": sum(len(o["tokens"]) for o in outs) / window,
            "router_latency_ms": {"p50": float(np.percentile([(o["t_back"] - o["t_sent"]) * 1e3 for o in outs], 50)),
                                  "max": max((o["t_back"] - o["t_sent"]) * 1e3 for o in outs)},
            "replica_ttft_ms": ttft}


def fleet_run(torch, tdk, dev, inprocess: bool) -> dict:
    """One ``train()`` at config_150m with ``fleet.enabled`` (FLEET,
    ``inprocess`` as given), :func:`fleet_checks` at the fleet's teardown
    (``FleetPlane.stop``, which ``train()`` calls in its finally)."""
    import os
    import shutil
    import tempfile

    import opendiloco_torch.fleet as tfleet
    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.train import train

    tmp = tempfile.mkdtemp()
    model = cut_depth(RING_TRAIN_MODEL, CUT_LAYERS, tmp)
    cfg = load_config(model)
    prompts = fleet_prompts(cfg.vocab_size, seed=11)
    seen: dict = {}
    real_build, real_stop = tfleet.build_fleet, tfleet.FleetPlane.stop

    def watch(plane):
        while "t_ready" not in seen and not seen.get("stopped"):
            if any(r.get("ready") for r in plane.manager.status()["replicas"].values()):
                seen["t_ready"] = time.perf_counter()
            time.sleep(0.005)

    def build(*a, **k):
        seen["t_build"] = time.perf_counter()
        plane = real_build(*a, **k)
        seen["t_built"] = time.perf_counter()
        threading.Thread(target=watch, args=(plane,), daemon=True).start()
        return plane

    def stop(plane):
        seen["stopped"] = True
        seen["train_launches"] = tdk.LAUNCHES.snapshot()  # training done, no request served yet
        try:
            seen["checks"] = fleet_checks(torch, tdk, dev, plane, cfg, inprocess, prompts)
        except BaseException as e:
            seen["error"] = e
        finally:
            real_stop(plane)

    config = train_config(model, FLEET_150M, 0, os.path.join(tmp, "metrics-0.pkl"), dict(path=tmp, interval=None),
                          fleet={**FLEET, "inprocess": inprocess})
    tfleet.build_fleet, tfleet.FleetPlane.stop = build, stop
    tdk.LAUNCHES.reset()
    try:
        t0 = time.perf_counter()
        train(config, LoopbackWorld(1).make_backends()[0], dev)
        wall = time.perf_counter() - t0
    finally:
        tfleet.build_fleet, tfleet.FleetPlane.stop = real_build, real_stop
        shutil.rmtree(tmp, ignore_errors=True)
    if "error" in seen:
        raise seen["error"]
    if "checks" not in seen or "t_ready" not in seen:
        raise AssertionError(f"fleet (inprocess={inprocess}): the teardown checks did not run: {sorted(seen)}")
    train_launches = seen["train_launches"]
    check_launches(train_launches, training_launches(torch, dev, cfg, FLEET_150M, FLEET_150M["total_steps"],
                                                     train_launches), f"fleet training (inprocess={inprocess})")
    return {"inprocess": inprocess, "build_s": seen["t_built"] - seen["t_build"],
            "first_ready_s": seen["t_ready"] - seen["t_build"], "train_wall_s": wall,
            "train_launches": train_launches, **seen["checks"]}


def phase_fleet(torch, tdk, dev, card: str) -> dict:
    """Phase 26: the serving fleet at config_150m's widths and CUT_LAYERS
    of its layers. One training worker with
    ``fleet.enabled`` feeds two replicas (FLEET: keyframe every 2 epochs,
    prefix cache on), first in process (bf16 compute, the trainer's), then
    as ``python -m opendiloco_torch.fleet.replica`` processes on the card
    (f32, the replica's default). At the teardown, both replicas serving
    the last epoch's keyframe, each replica's two shared-prefix streams
    equal a ServeEngine's on the keyframed masters (the second a prefix
    hit); in process B6 runs once a layer a decode step and B7 once a
    layer a prefix hit. Then 16 requests through the router's HTTP from 4 clients; with
    processes one replica is SIGKILLed under them: every request answers.
    Prints time to the first ready replica, push bytes of keyframes and
    deltas, TTFT and tokens/s through the router and the redispatches."""
    t0 = time.perf_counter()
    runs = [fleet_run(torch, tdk, dev, inprocess) for inprocess in (True, False)]
    res = {"config": f"150m widths, {CUT_LAYERS} layers", **FLEET_150M, "fleet": FLEET, "runs": runs, "seconds": time.perf_counter() - t0}
    for r in runs:
        pub = {rid: {k: v for k, v in x.items() if k.endswith(("bytes", "frames"))}
               for rid, x in r["publisher"]["replicas"].items()}
        log(f"fleet 150m ({CUT_LAYERS} layers) inprocess={r['inprocess']}: first replica ready {r['first_ready_s']:.2f} s after the build "
            f"began (build {r['build_s']:.2f} s); streams equal the reference engine's; pushes {json.dumps(pub)} "
            f"(fp16 snapshot {r['publisher']['fp16_snapshot_bytes']} B); router {r['router']}, killed "
            f"{r['killed']}, {r['router_answers']} answers, {r['router_tokens_per_s']:.1f} tokens/s, latency "
            f"{r['router_latency_ms']} ms, replica TTFT {json.dumps(r['replica_ttft_ms'])}; B6 a decode step "
            f"{r['launches_per_decode_step']} | {card}")
    log(f"fleet 150m ({CUT_LAYERS} layers): phase {res['seconds']:.1f} s | {card}")
    return res


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 27: routed experts at config_150m_8e
# ---------------------------------------------------------------------------

# two loopback workers at config_150m_8e's full width (d 1024, 16 heads x 64,
# 8 experts of ffn 2688, vocab 32000) and MOE_LAYERS of its 12 layers:
# mb 8, accum 2, seq 1024, 3 steps and one outer round (local_steps 3), on
# the device plane as phase 23 (the host plane's numpy would move 3.6 GB a
# worker). warmup 2: the lrs are 0, 5e-4 and 1e-3
MOE_MODEL = "150m_8e"
# of its 12 layers (the smoke's time limit: at 12 the phase took 94.6 s of a
# 986.3 s smoke on an H100 80GB HBM3 at 700 W)
MOE_LAYERS = 6
MOE_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                total_steps=3, local_steps=3, lr=1e-3)
MOE_NAMES = ("flash_attention_fwd_sm90", "flash_attention_delta", "flash_attention_dq_sm90",
             "flash_attention_dkv_sm90", "fused_xent_fwd_sm90", "fused_xent_dlog_sm90", "fused_xent_dh_sm90",
             "fused_xent_dw_sm90")


def moe_workers(torch, tfa, dev, extra: dict, model: str) -> dict:
    """Two workers, one thread each, run ``train()`` on ``model`` at
    MOE_150M with the ``Config`` fields ``extra``; the launch counters zeroed just before and
    read just after. Returns the rows, launches, worker 0's final master
    (host arrays; worker 1's must equal it), peak device memory and wall
    seconds."""
    import os
    import pickle
    import tempfile

    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.train import train

    run = MOE_150M
    tmp = tempfile.mkdtemp()
    backends = recording_backends(LoopbackWorld(2))

    def config(rank):
        return train_config(model, run, rank, os.path.join(tmp, f"metrics-{rank}.pkl"),
                            dict(path=os.path.join(tmp, "ckpts")), diloco=dict(outer_placement="device"), **extra)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    run_workers(train, [(config(r), backends[r], dev) for r in range(2)])
    wall = time.perf_counter() - t0
    launches = tfa.LAUNCHES.snapshot()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = []
    for rank in range(2):
        with open(os.path.join(tmp, f"metrics-{rank}.pkl"), "rb") as f:
            rows.append(pickle.load(f))
    # compared in place: hashing two 3.6 GB masters took most of 10 s
    master, other = (master_now(b.provider) for b in backends)
    if not all(np.array_equal(a, b) for a, b in zip(master, other)):
        raise AssertionError(f"moe 150m_8e {extra}: the two workers' masters differ")
    del other
    out = {"rows": rows, "launches": launches, "master": master, "peak_gib": peak_gib, "wall_s": wall}
    del backends
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_dropped(torch, dev, model: str) -> dict:
    """The tokens each layer's capacity drops on phase 27's first
    micro-batch (mb 8 x seq 1024) through the initial params (drawn as
    ``train()`` draws them), in bf16 through the kernels: of N = 8192
    tokens, capacity ceil(N / 8 x 1.25) = 1280 a expert."""
    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.models import llama
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.train import INIT_SEED

    cfg = load_config(model)
    run = MOE_150M
    params = llama.init_params(torch.Generator(device=dev).manual_seed(INIT_SEED), cfg)
    ds = iter(FakeTokenizedDataset(run["seq_length"], cfg.vocab_size, seed=42, mode="ramp"))
    ids = torch.from_numpy(np.stack([next(ds)["input_ids"] for _ in range(run["per_device_train_batch_size"])]))
    stats: list = []
    with torch.no_grad():
        llama.forward(params, ids.to(dev).long(), cfg, compute_dtype=torch.bfloat16, attn_impl="pallas",
                      remat=False, moe_stats=stats)
    n = ids.numel()
    del params
    torch.cuda.empty_cache()
    return {"tokens": n, "capacity": math.ceil(n / cfg.num_experts * cfg.expert_capacity_factor),
            "dropped_by_layer": [int(x) for x in stats]}


def phase_moe(torch, tfa, dev, card: str) -> dict:
    """Phase 27: config_150m_8e's widths at MOE_LAYERS of its layers train
    through ``train()`` (two workers, one outer round) with attention and loss left to resolve (the kernels:
    B1, B2a, B2b, delta, and the fused loss's B3, dlog, B4a, B4b, which an
    MoE stack resolves on), then the same run through plain attention and
    the materialized loss. Per inner step and worker the flash kernels as
    phase 8's (remat), B3 accum, dlog, B4a and B4b accum x 4; the plain run
    launches nothing. bf16: each step's loss within 1e-3 and grad norm
    within 0.5% of the plain run's (phase 8's tolerance). The final masters
    within twice the largest displacement a round can give an element, and
    the directions of the round's update agreeing on at least 90% of the
    elements: the first two AdamW steps move an element by at most their
    lr each (times 1 + wd |p|), and the outer Nesterov step multiplies the
    round's displacement by outer lr x (1 + momentum); routing and rounding
    that differ in bf16 may flip an element's direction."""
    from opendiloco_torch.models import llama
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.train import INIT_SEED
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    import tempfile

    t0 = time.perf_counter()
    model = cut_depth(MOE_MODEL, MOE_LAYERS, tempfile.mkdtemp())
    cfg, run = load_config(model), MOE_150M
    tc = InnerTrainer(cfg, TrainerConfig(), device=dev).tc
    if not (tc.attn_impl == "pallas" and tc.fused_loss):
        raise AssertionError(f"150m_8e resolves attn {tc.attn_impl}, fused_loss {tc.fused_loss} on the card")
    accum = run["total_batch_size"] // run["per_device_train_batch_size"]
    steps = 2 * run["total_steps"]
    kern = moe_workers(torch, tfa, dev, {}, model)
    want = training_launches(torch, dev, cfg, run, steps, kern["launches"], fused=True)
    if kern["launches"] != want:
        raise AssertionError(f"moe 150m_8e launch counts {kern['launches']} != {want}")
    plain = moe_workers(torch, tfa, dev, dict(attn_implementation="xla", fused_loss=False), model)
    if any(plain["launches"].values()):
        raise AssertionError(f"moe 150m_8e plain run launched {plain['launches']}")
    losses = {k: [[r["Loss"] for r in rr] for rr in x["rows"]] for k, x in (("kernels", kern), ("plain", plain))}
    norms = {k: [[r["grad_norm"] for r in rr] for rr in x["rows"]] for k, x in (("kernels", kern), ("plain", plain))}
    for w in range(2):
        if len(losses["kernels"][w]) != run["total_steps"] or not all(math.isfinite(x) for x in losses["kernels"][w]):
            raise AssertionError(f"moe 150m_8e worker {w}: losses {losses['kernels'][w]}")
        for a, b, ga, gb in zip(losses["kernels"][w], losses["plain"][w], norms["kernels"][w], norms["plain"][w]):
            if not (abs(a - b) <= 1e-3 and abs(ga - gb) <= 5e-3 * gb):
                raise AssertionError(f"moe 150m_8e worker {w}: loss {a} vs plain {b}, grad norm {ga} vs {gb}")
    init = [x.cpu().numpy() for x in llama.flatten_params(
        llama.init_params(torch.Generator(device=dev).manual_seed(INIT_SEED), cfg))]
    worst, agree, total = 0.0, 0, 0
    for m0, mk, mp in zip(init, kern["master"], plain["master"]):
        worst = max(worst, float(np.abs(mk - mp).max()))
        dk, dp = np.sign(mk - m0), np.sign(mp - m0)
        agree += int(np.count_nonzero(dk == dp))
        total += m0.size
    del init
    from opendiloco_torch.config import DilocoConfig
    from opendiloco_torch.trainer import make_schedule

    dc, sched = DilocoConfig(), make_schedule(TrainerConfig(lr=run["lr"], warmup_steps=run["warmup_steps"],
                                                             total_steps=run["total_steps"]))
    reach = sum(sched(i) for i in range(run["total_steps"])) * (1 + TrainerConfig().weight_decay)
    master_tol = 2 * dc.outer_lr * (1 + dc.outer_momentum) * reach + 1e-6
    if not (worst <= master_tol and agree >= 0.9 * total):
        raise AssertionError(f"moe 150m_8e masters: largest difference {worst} (tol {master_tol}), "
                             f"update directions agree on {agree / total:.4f}")
    kern.pop("master")
    plain.pop("master")
    gc.collect()
    dropped = moe_dropped(torch, dev, model)
    inner = kern["launches"]
    per_step = {k: inner[k] / steps for k in MOE_NAMES}
    step_ms = {k: 1e3 * float(np.median([r["time_taken"] for rr in x["rows"] for r in rr
                                         if r["step"] > 1 and "outer_step_s" not in r]))
               for k, x in (("kernels", kern), ("plain", plain))}
    outer = {k: [r["outer_step_s"] for rr in x["rows"] for r in rr if "outer_step_s" in r]
             for k, x in (("kernels", kern), ("plain", plain))}
    secs = time.perf_counter() - t0
    res = {"config": MOE_MODEL, "layers": cfg.num_hidden_layers, "experts": cfg.num_experts, **run, "accum": accum,
           "workers": 2, "attn_impl": tc.attn_impl, "fused_loss": tc.fused_loss, "losses": losses,
           "grad_norms": norms, "launches": inner, "launches_per_inner_step": per_step,
           "step_ms_median_two_workers": step_ms, "outer_step_s": outer,
           "peak_memory_gib_two_workers": {"kernels": kern["peak_gib"], "plain": plain["peak_gib"]},
           "wall_s": {"kernels": kern["wall_s"], "plain": plain["wall_s"]},
           "master_largest_difference": worst,
           "master_update_direction_agreement": agree / total, "capacity": dropped, "seconds": secs,
           "tol": f"loss 1e-3 abs, grad norm 0.5% rel (bf16); master {master_tol:.3e} abs, 90% update directions"}
    log(f"moe 150m_8e: launches per inner step and worker {json.dumps(per_step)} | {card}")
    log(f"moe 150m_8e: step {step_ms['kernels']:.1f} ms kernels / {step_ms['plain']:.1f} ms plain (median, two "
        f"workers on one card, mb {run['per_device_train_batch_size']} x accum {accum} x seq {run['seq_length']}), "
        f"outer step {outer['kernels']} / {outer['plain']} s, peak device memory {kern['peak_gib']:.2f} / "
        f"{plain['peak_gib']:.2f} GiB | {card}")
    log(f"moe 150m_8e: losses {losses['kernels']} (plain {losses['plain']}); masters within {worst:.2e}, update "
        f"directions agree on {agree / total:.4f}; capacity {dropped['capacity']} a expert drops "
        f"{dropped['dropped_by_layer']} of {dropped['tokens']} tokens by layer; phase {secs:.1f} s | {card}")
    return res


# ---------------------------------------------------------------------------
# phase 28: the flash-chunk ring (B5) on a loopback ring of 4 ranks
# ---------------------------------------------------------------------------

# T 4096 over 4 ranks (chunks of 1024), bf16, B 2, at config_150m's heads
# (16 x 64) and config_1b's (32 over 4 kv heads x 64)
RING_N = 4
RING_GEOMS = {"150m heads": (2, 4096, 16, 16, 64), "1b heads": (2, 4096, 32, 4, 64)}
RING_TOL = ("bf16 outputs (out, dq, dk, dv) 2**-6 of each (batch, head)'s largest, lse 1e-4 of the largest |lse| "
            "(phase 7's); f32 gradient chunks against their plain version 2**-8 of each (batch, head)'s largest")


def ring_ranks(torch, ra, fn_fwd, fn_bwd, q, k, v, do, n: int) -> dict:
    """The ring's forward (``fn_fwd(q, k, v, ring) -> (out, lse)``) and
    backward (``fn_bwd(q, k, v, out, lse, do, ring) -> (dq, dk, dv)``) on a
    loopback ring of ``n`` ranks, one thread each, called directly (an
    autograd backward of CUDA tensors runs on one engine thread, where the
    ranks would wait on each other). Returns the joined outputs and the
    card's ms of the forward and of the backward (all ranks, events on the
    shared stream)."""
    from opendiloco_torch.parallel.comm import LoopbackGroup

    T = q.shape[1]
    tl = T // n
    chunk = lambda x, r: x[:, r * tl:(r + 1) * tl].contiguous()
    ins = [[chunk(x, r) for x in (q, k, v, do)] for r in range(n)]
    fwd, bwd = [None] * n, [None] * n
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def stage(work):
        ring, errors = LoopbackGroup(n), []

        def one(r):
            try:
                work(r, ring.rank(r))
            except BaseException as e:
                errors.append(e)
                ring._barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def f(r, ring):
        fwd[r] = fn_fwd(*ins[r][:3], ring)

    def b(r, ring):
        bwd[r] = fn_bwd(*ins[r][:3], fwd[r][0], fwd[r][1], ins[r][3], ring)

    torch.cuda.synchronize()
    events[0].record()
    stage(f)
    events[1].record()
    stage(b)
    events[2].record()
    torch.cuda.synchronize()
    lse_dim = 2 if fwd[0][1].dim() == 3 else 3
    return {"out": torch.cat([x[0] for x in fwd], 1), "lse": torch.cat([x[1] for x in fwd], lse_dim),
            "dq": torch.cat([x[0] for x in bwd], 1), "dk": torch.cat([x[1] for x in bwd], 1),
            "dv": torch.cat([x[2] for x in bwd], 1), "fwd_ms": events[0].elapsed_time(events[1]),
            "bwd_ms": events[1].elapsed_time(events[2])}


def per_head_err(torch, got, ref, dim_t: int = 1) -> tuple:
    """(largest error, the error over 2**-6 of each (batch, head)'s largest
    reference value) of [B, T, H, D] tensors."""
    err = (got.float() - ref.float()).abs().amax(dim=(dim_t, 3))
    tol = 2.0**-6 * ref.float().abs().amax(dim=(dim_t, 3))
    return float(err.max()), float((err / tol).max())


def phase_ring(torch, tfa, dev, card: str) -> dict:
    """Phase 28: B5, the flash-chunk ring, in one process over a loopback
    ring of 4 ranks at T 4096 (see the module docstring): against B1 and
    B2a/B2b over the whole causal sequence and against the plain (einsum)
    ring; B2a and B2b's f32 outputs from bf16 operands without the causal
    mask held to their plain versions; the launches (rank r: 1 causal and
    r full B1 chunks forward, one delta, and 1 + r of each of B2a and
    B2b); the ring's ms against one flash call over T 4096. Then
    ``train()`` with ``attn_implementation="ring"`` at sp 1 against
    ``"pallas"``: losses, grad norms and master hashes bit for bit."""
    from opendiloco_torch.ops import ring_attention as ra

    t0 = time.perf_counter()
    f32 = torch.float32
    out: dict = {"geoms": {}, "tol": RING_TOL}
    for label, (B, T, H, Hkv, D) in RING_GEOMS.items():
        q, k, v, do = flash_inputs(torch, dev, B, T, H, Hkv, D, torch.bfloat16, 31)
        # the whole sequence through B1, delta, B2a, B2b
        ref_out, ref_lse = tfa.flash_attention_fwd(q, k, v, True)
        delta = tfa.attention_delta(do, ref_out)
        ref = {"out": ref_out, "lse": ref_lse, "dq": tfa.flash_attention_dq(q, k, v, do, ref_lse, delta, True)}
        ref["dk"], ref["dv"] = tfa.flash_attention_dkv(q, k, v, do, ref_lse, delta, True)
        tfa.LAUNCHES.reset()
        got = ring_ranks(torch, ra, ra.ring_flash_fwd, ra.ring_flash_bwd, q, k, v, do, RING_N)
        launches = {kk: vv for kk, vv in tfa.LAUNCHES.snapshot().items() if vv}
        chunks = RING_N * (RING_N + 1) // 2  # sum over ranks of 1 + r
        want = {"flash_attention_fwd_sm90": chunks, "flash_attention_delta": RING_N,
                "flash_attention_dq_sm90": chunks, "flash_attention_dkv_sm90": chunks}
        if launches != want:
            raise AssertionError(f"ring {label}: launches {launches} != {want}")
        plain = ring_ranks(torch, ra, lambda q, k, v, ring: ra.ring_attention_fwd(q, k, v, ring),
                           lambda q, k, v, o, lse, do, ring: ra.ring_attention_bwd(q, k, v, o, lse, do, ring),
                           q, k, v, do, RING_N)
        plain["lse"] = plain["lse"][..., 0].reshape(B, H, T)  # [B, Hkv, G, T, 1] -> [B, H, T]
        checks = {}
        for name in ("out", "dq", "dk", "dv"):
            if got[name].dtype != q.dtype:
                raise AssertionError(f"ring {label} {name}: dtype {got[name].dtype}")
            for against, r in (("whole", ref), ("plain ring", plain)):
                err, over = per_head_err(torch, got[name], r[name])
                checks[f"{name} vs {against}"] = {"max_abs_err": err, "worst_err_over_tol": over}
                if not over <= 1.0:
                    raise AssertionError(f"ring {label} {name} vs {against}: error/tol {over}")
        for against, r in (("whole", ref), ("plain ring", plain)):
            err = float((got["lse"] - r["lse"]).abs().max())
            tol = 1e-4 * max(1.0, float(r["lse"].abs().max()))
            checks[f"lse vs {against}"] = {"max_abs_err": err, "worst_err_over_tol": err / tol}
            if not err <= tol:
                raise AssertionError(f"ring {label} lse vs {against}: {err} over {tol}")
        # B2a and B2b write f32 from bf16 operands without the causal mask
        # (the ring's earlier chunks): rank 1's queries against chunk 0
        tl = T // RING_N
        qc, doc = (x[:, tl:2 * tl].contiguous() for x in (q, do))
        kc, vc = (x[:, :tl].contiguous() for x in (k, v))
        lse_c = got["lse"][:, :, tl:2 * tl].contiguous()
        delta_c = tfa.attention_delta(doc, got["out"][:, tl:2 * tl].contiguous())
        f32_out = {"dq": tfa.flash_attention_dq(qc, kc, vc, doc, lse_c, delta_c, False, f32)}
        f32_out["dk"], f32_out["dv"] = tfa.flash_attention_dkv(qc, kc, vc, doc, lse_c, delta_c, False, f32)
        f32_ref = {"dq": tfa.flash_attention_dq_plain(qc, kc, vc, doc, lse_c, delta_c, False, f32)}
        f32_ref["dk"], f32_ref["dv"] = tfa.flash_attention_dkv_plain(qc, kc, vc, doc, lse_c, delta_c, False, f32)
        for name, x in f32_out.items():
            if x.dtype != f32 or torch.equal(x, x.to(torch.bfloat16).float()):
                raise AssertionError(f"ring {label}: {name} is not an f32 output ({x.dtype})")
            err = (x - f32_ref[name]).abs().amax(dim=(1, 3))
            over = float((err / (2.0**-8 * f32_ref[name].abs().amax(dim=(1, 3)))).max())
            checks[f"{name} f32 full chunk vs plain"] = {"max_abs_err": float(err.max()), "worst_err_over_tol": over}
            if not over <= 1.0:
                raise AssertionError(f"ring {label}: f32 {name} of a full chunk, error/tol {over}")
        # one flash call over the whole T, forward and backward, against the ring
        fwd_ms = device_ms(torch, lambda: tfa.flash_attention_fwd(q, k, v, True), [()], launches=8, replays=3)
        bwd_ms = device_ms(torch, lambda: (tfa.attention_delta(do, ref_out),
                                           tfa.flash_attention_dq(q, k, v, do, ref_lse, delta, True),
                                           tfa.flash_attention_dkv(q, k, v, do, ref_lse, delta, True)),
                           [()], launches=8, replays=3)
        # the library's one call for the same function: SDPA over the whole T
        import torch.nn.functional as F

        qT, kT, vT = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qT, kT, vT, is_causal=True,
                                                                          enable_gqa=H != Hkv),
                            [()], launches=8, replays=3)
        timed = {"ring_fwd_ms": [], "ring_bwd_ms": []}
        for _ in range(3):
            again = ring_ranks(torch, ra, ra.ring_flash_fwd, ra.ring_flash_bwd, q, k, v, do, RING_N)
            timed["ring_fwd_ms"].append(again["fwd_ms"])
            timed["ring_bwd_ms"].append(again["bwd_ms"])
        out["geoms"][label] = {"B": B, "T": T, "H": H, "Hkv": Hkv, "D": D, "ranks": RING_N, "launches": launches,
                               "launches_by_rank": {r: {"fwd causal": 1, "fwd full": r, "delta": 1,
                                                        "dq": 1 + r, "dkv": 1 + r} for r in range(RING_N)},
                               "checks": checks, "flash_fwd_ms_whole_T": fwd_ms, "flash_bwd_ms_whole_T": bwd_ms,
                               "ring_fwd_ms": min(timed["ring_fwd_ms"]), "ring_bwd_ms": min(timed["ring_bwd_ms"]),
                               "ring_ms_runs": timed, "plain_ring_fwd_ms": plain["fwd_ms"],
                               "plain_ring_bwd_ms": plain["bwd_ms"], "sdpa_fwd_ms_whole_T": sdpa_ms,
                               "bound_fwd_ms": bound_ms(*flash_work(B, T, H, Hkv, D, 2, True)["flash_attention_fwd"])[0]}
        log(f"ring {label}: B {B} T {T} over {RING_N} ranks: forward {min(timed['ring_fwd_ms']):.3f} ms, "
            f"backward {min(timed['ring_bwd_ms']):.3f} ms (all ranks on one card, loopback) against one flash "
            f"call over T {T}: forward {fwd_ms:.3f} ms, backward (delta, B2a, B2b) {bwd_ms:.3f} ms; SDPA forward "
            f"{sdpa_ms:.3f} ms; the plain ring {plain['fwd_ms']:.3f} / {plain['bwd_ms']:.3f} ms; launches "
            f"{json.dumps(launches)}; worst error/tol {max(c['worst_err_over_tol'] for c in checks.values()):.3f} "
            f"| {card}")
        del q, k, v, do, ref, got, plain
        torch.cuda.empty_cache()
    out["train_sp1"] = ring_train_sp1(torch, tfa, dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"ring: train() with attn ring at sp 1 equals pallas bit for bit (losses "
        f"{out['train_sp1']['losses']}); phase {out['seconds']:.1f} s | {card}")
    return out


# phase 28's train() pair: one loopback worker at config_150m's widths and
# CUT_LAYERS of its layers, mb 8, accum 2, seq 1024, 4 steps, one outer
# round on the device plane
RING_TRAIN_MODEL = "150m"
RING_TRAIN = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=1,
                  total_steps=4, local_steps=4, lr=1e-3)


def ring_train_sp1(torch, tfa, dev) -> dict:
    """``train()`` with ``attn_implementation="ring"`` at sp 1 and with
    ``"pallas"``: the same launches, and each step's loss and grad norm and
    the master hashes bit for bit."""
    import os
    import pickle
    import tempfile

    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.train import train

    tmp = tempfile.mkdtemp()
    model = cut_depth(RING_TRAIN_MODEL, CUT_LAYERS, tmp)
    runs = {}
    for impl in ("ring", "pallas"):
        (backend,) = recording_backends(LoopbackWorld(1))
        project = os.path.join(tmp, f"{impl}.pkl")
        config = train_config(model, RING_TRAIN, 0, project, dict(path=os.path.join(tmp, "ckpts")),
                              diloco=dict(outer_placement="device"), attn_implementation=impl, fused_loss=False)
        tfa.LAUNCHES.reset()
        train(config, backend, dev)
        with open(project, "rb") as f:
            rows = pickle.load(f)
        backend.hashes["end"] = master_hash(master_now(backend.provider))
        runs[impl] = {"losses": [r["Loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
                      "hashes": dict(backend.hashes), "launches": tfa.LAUNCHES.snapshot()}
        del backend
    a, b = runs["ring"], runs["pallas"]
    if a != b or not a["launches"]["flash_attention_fwd_sm90"]:
        raise AssertionError(f"train(): ring at sp 1 {a} != pallas {b}")
    gc.collect()
    torch.cuda.empty_cache()
    return a


# ---------------------------------------------------------------------------
# phase 29: tensor and pipeline parallelism at config_1b over loopback ranks
# ---------------------------------------------------------------------------

# config_1b at full width and TPPP_LAYERS of its 22 layers (the smoke's time
# limit: at 22 the phase took 85.4 s of a 986.3 s smoke on an H100 80GB HBM3
# at 700 W; at 12, with the two sp runs added, 113.7 s of a 1157.0 s smoke,
# so all five runs take 4; even, so pp 2 splits it), phase 10's run settings
# (seq 1024, mb 8, accum 2), three inner steps; warmup 1 so that two steps
# update
TPPP_LAYERS = 4
TPPP_1B = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=1, total_steps=3,
               lr=1e-3)
TPPP_NAMES = MOE_NAMES
TPPP_TOL = ("bf16: each step's loss within 1e-3 and grad norm within 0.5% of the unsplit run's (phase 8's); the whole "
            "params after step 3 within phase 27's master bound (2 x outer lr x (1 + momentum) x the steps' lrs x "
            "(1 + wd); three AdamW steps move an element by at most the lrs x (1 + wd) each way, so a split run "
            "whose rounding flips an element's direction at every step lands within 2 x that) and the update "
            "directions agreeing on at least 90% of the elements; the leaves tp and pp do not cut bit for bit "
            "across the ranks after every step")


def tppp_launches(accum: int, steps: int, mb: int, seq: int, *, layers: int, microbatches: int,
                  loss: bool, sp: int = 1, ring_rank: int | None = None) -> dict:
    """The launches one rank thread must show over ``steps`` inner steps:
    per micro-batch of the pipeline and layer, B1 twice (forward and its
    recompute under remat), delta, B2a and B2b once (under sp's gather
    too: every rank attends over the whole sequence); as rank
    ``ring_rank`` of the flash-chunk ring, B1 2 (1 + r), B2a and B2b 1 + r
    (the causal chunk and r earlier ones) and delta once; where the rank
    runs the loss, B3 once an accumulation step and dlog, B4a and B4b once
    a 2048-row chunk of its mb x (seq - 1) rows, or of its mb x seq / sp
    rows under sp (the next-token targets already paired)."""
    from opendiloco_torch.ops import fused_xent as tfx

    n = steps * accum * layers * microbatches
    chunks_seen = 1 if ring_rank is None else 1 + ring_rank
    want = {name: 0 for name in TPPP_NAMES}
    want.update({"flash_attention_fwd_sm90": 2 * n * chunks_seen, "flash_attention_delta": n,
                 "flash_attention_dq_sm90": n * chunks_seen, "flash_attention_dkv_sm90": n * chunks_seen})
    if loss:
        chunks = -(-mb * (seq - 1 if sp == 1 else seq // sp) // tfx.CHUNK_ROWS)
        want["fused_xent_fwd_sm90"] = steps * accum
        for name in ("fused_xent_dlog_sm90", "fused_xent_dh_sm90", "fused_xent_dw_sm90"):
            want[name] = steps * accum * chunks
    return want


def tppp_run(torch, tfa, dev, cfg, tc, params: dict, batches: list, plans: list) -> dict:
    """``InnerTrainer`` on each plan (one thread each, CUDA backward on the
    calling thread: ``set_multithreading_enabled(False)``; one plan: this
    thread) over ``batches``: each step's loss and grad norm (every rank's),
    the leaves tp and pp do not cut compared across the ranks after every
    step (bit for bit), the whole params after the last step (rank 0, host
    arrays), each thread's launches, ms a step after the first, and the
    peak device memory."""
    from opendiloco_torch.models import llama
    from opendiloco_torch.trainer import InnerTrainer

    n = len(plans)
    out = [None] * n
    states: list = [None] * n
    errors: list = []
    step_bar = threading.Barrier(n)
    idents = [None] * n
    mismatch: list = []

    def one(r):
        try:
            idents[r] = threading.get_ident()
            with torch.autograd.set_multithreading_enabled(False):
                tr = InnerTrainer(cfg, tc, device=dev, plan=plans[r])
                state = tr.init_state(params=params)
                accum = TPPP_1B["total_batch_size"] // TPPP_1B["per_device_train_batch_size"]
                uncut = [i for i, d in enumerate(zip(tr.mp_dims["tp"], tr.mp_dims["pp"])) if d == (None, None)]
                losses, norms, times = [], [], []
                for ids in batches:
                    batch = tr.shard_batch(ids, ids.copy(), accum=accum)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = tr.train_step(state, batch)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    if n > 1:  # the uncut leaves of every rank, bit for bit
                        states[r] = [llama.flatten_params(state["params"])[i] for i in uncut]
                        step_bar.wait()
                        if r == 0:
                            for other in states[1:]:
                                if not all(torch.equal(a, b) for a, b in zip(states[0], other)):
                                    mismatch.append(len(losses))
                        step_bar.wait()
                whole = tr.host_params(llama.flatten_params(state["params"]))  # a collective
                out[r] = {"losses": losses, "norms": norms, "step_ms": [t * 1e3 for t in times],
                          "uncut": len(uncut), "params": whole if r == 0 else None}
                del tr, state, whole
        except BaseException as e:
            errors.append(e)
            step_bar.abort()
            for plan in plans:
                for c in (plan.comms or {}).values():
                    c.g.abort()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    if n == 1:
        one(0)
    else:
        threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if mismatch:
        raise AssertionError(f"the leaves tp and pp do not cut differ across ranks after steps {mismatch}")
    by_thread = tfa.LAUNCHES.by_thread()
    launches = [{k: by_thread.get(idents[r], {}).get(k, 0) for k in TPPP_NAMES} for r in range(n)]
    return {"ranks": out, "launches": launches, "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_tp_pp(torch, tfa, dev, card: str) -> dict:
    """Phase 29: config_1b's widths at TPPP_LAYERS of its 22 layers train
    three inner steps through ``InnerTrainer`` unsplit, at pp 2 (two stage
    threads of TPPP_LAYERS / 2 layers over the loopback P2P exchange, 2
    micro-batches), at tp 2
    (two rank threads over the loopback group: 16 q and 2 kv heads, ffn
    2816 and vocab 16000 a rank, the head gathered for the loss) and at sp
    2 (two rank threads of 512 positions a sequence, the loss and the
    gradients summed over their sp comm): gathered ("pallas": each rank
    runs the kernels over the whole 1024) and as the flash-chunk ring
    ("ring", B5), on the same numpy params and batches, bf16, remat, the
    kernels and the fused loss. Held: TPPP_TOL against the unsplit run,
    the two sp runs against each other by the same bounds, the sp ranks'
    losses bit for bit, and each thread's launches against
    :func:`tppp_launches` written down before the run."""
    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.models import llama
    from opendiloco_torch.models.convert import params_to_numpy
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.parallel.mesh import loopback_plans, single_device_plan
    from opendiloco_torch.train import INIT_SEED
    from opendiloco_torch.trainer import TrainerConfig, make_schedule

    import dataclasses
    import tempfile

    t_phase = time.perf_counter()
    cfg, run = load_config(cut_depth("1b", TPPP_LAYERS, tempfile.mkdtemp())), TPPP_1B
    L = cfg.num_hidden_layers
    mb, seq = run["per_device_train_batch_size"], run["seq_length"]
    accum, steps = run["total_batch_size"] // mb, run["total_steps"]
    tc = TrainerConfig(lr=run["lr"], warmup_steps=run["warmup_steps"], total_steps=100, precision="bf16-mixed",
                       remat=True, attn_impl="pallas", fused_loss=True)
    params = params_to_numpy(llama.init_params(torch.Generator(device=dev).manual_seed(INIT_SEED), cfg))
    torch.cuda.empty_cache()
    ds = iter(FakeTokenizedDataset(seq, cfg.vocab_size, seed=42, mode="ramp"))
    batches = [np.stack([next(ds)["input_ids"] for _ in range(run["total_batch_size"])]) for _ in range(steps)]
    want = {"unsplit": [tppp_launches(accum, steps, mb, seq, layers=L, microbatches=1, loss=True)],
            "pp 2": [tppp_launches(accum, steps, mb, seq, layers=L // 2, microbatches=2, loss=r == 1)
                     for r in range(2)],
            "tp 2": [tppp_launches(accum, steps, mb, seq, layers=L, microbatches=1, loss=True) for _ in range(2)],
            "sp 2 gather": [tppp_launches(accum, steps, mb, seq, layers=L, microbatches=1, loss=True, sp=2)
                            for _ in range(2)],
            "sp 2 ring": [tppp_launches(accum, steps, mb, seq, layers=L, microbatches=1, loss=True, sp=2, ring_rank=r)
                          for r in range(2)]}
    plans = {"unsplit": [single_device_plan()], "pp 2": loopback_plans(pp_size=2), "tp 2": loopback_plans(tp_size=2),
             "sp 2 gather": loopback_plans(sp_size=2), "sp 2 ring": loopback_plans(sp_size=2)}
    tcs = {label: tc for label in plans}
    tcs["sp 2 ring"] = dataclasses.replace(tc, attn_impl="ring")
    runs = {}
    for label in plans:
        res = tppp_run(torch, tfa, dev, cfg, tcs[label], params, batches, plans[label])
        if res["launches"] != want[label]:
            raise AssertionError(f"tp/pp 1b {label}: launches by thread {res['launches']} != {want[label]}")
        if label.startswith("sp") and any(r["losses"] != res["ranks"][0]["losses"] for r in res["ranks"]):
            raise AssertionError(f"tp/pp 1b {label}: the ranks' losses differ: {[r['losses'] for r in res['ranks']]}")
        runs[label] = res
        gc.collect()
        torch.cuda.empty_cache()
    ref = runs["unsplit"]["ranks"][0]
    from opendiloco_torch.config import DilocoConfig

    dc, sched = DilocoConfig(), make_schedule(tc)
    reach = sum(sched(i) for i in range(steps)) * (1 + tc.weight_decay)
    param_tol = 2 * dc.outer_lr * (1 + dc.outer_momentum) * reach + 1e-6  # phase 27's
    checks = {}
    init = llama.flatten_params(params)
    # each split against the unsplit run, and the gathered sp run against the ring
    pairs = [(label, "unsplit") for label in plans if label != "unsplit"] + [("sp 2 ring", "sp 2 gather")]
    for label, base in pairs:
        want_run = runs[base]["ranks"][0]
        for r, got in enumerate(runs[label]["ranks"]):
            for step, (a, b, ga, gb) in enumerate(zip(got["losses"], want_run["losses"], got["norms"],
                                                      want_run["norms"])):
                if not (math.isfinite(a) and abs(a - b) <= 1e-3 and abs(ga - gb) <= 5e-3 * gb):
                    raise AssertionError(f"tp/pp 1b {label} rank {r} step {step + 1}: loss {a} vs {b}, grad norm "
                                         f"{ga} vs {gb} ({base})")
        worst, agree, total = 0.0, 0, 0
        for p0, pg, pr in zip(init, runs[label]["ranks"][0]["params"], want_run["params"]):
            worst = max(worst, float(np.abs(pg - pr).max()))
            agree += int(np.count_nonzero(np.sign(pg - p0) == np.sign(pr - p0)))
            total += p0.size
        if not (worst <= param_tol and agree >= 0.9 * total):
            raise AssertionError(f"tp/pp 1b {label}: params differ from {base}'s by up to {worst} (tol {param_tol}), "
                                 f"update directions agree on {agree / total:.4f}")
        checks[label if base == "unsplit" else f"{label} against {base}"] = {
            "params_largest_difference": worst, "update_direction_agreement": agree / total}
    for r in runs.values():
        r["ranks"][0]["params"] = None
    res = {"config": "1b", "layers": L, **run, "accum": accum,
           "attn_impl": {label: t.attn_impl for label, t in tcs.items()}, "fused_loss": tc.fused_loss,
           "remat": tc.remat, "pp_microbatches": 2, "tol": TPPP_TOL, "param_tol": param_tol, "checks": checks,
           "runs": {label: {"losses": [x["losses"] for x in r["ranks"]], "grad_norms": [x["norms"] for x in r["ranks"]],
                            "step_ms": [x["step_ms"] for x in r["ranks"]], "launches_by_thread": r["launches"],
                            "uncut_leaves": r["ranks"][0]["uncut"], "wall_s": r["wall_s"],
                            "peak_memory_gib": r["peak_gib"]} for label, r in runs.items()},
           "seconds": time.perf_counter() - t_phase}
    for label, r in res["runs"].items():
        ms = float(np.median([x for ranks in r["step_ms"] for x in ranks[1:]]))
        r["step_ms_median_after_first"] = ms
        log(f"tp/pp 1b {label}: step {ms:.1f} ms (median after the first; mb {mb} x accum {accum} x seq {seq}, "
            f"{L} layers, ranks as threads on one card), peak device memory {r['peak_memory_gib']:.2f} GiB, "
            f"losses {r['losses'][0]}, grad norms {r['grad_norms'][0]}, launches {r['launches_by_thread']} | {card}")
    log(f"tp/pp 1b: {json.dumps(checks)} (tol {param_tol:.3e}); phase {res['seconds']:.1f} s | {card}")
    return res


# ---------------------------------------------------------------------------
# phase 30: the obs plane armed on the serving and training planes
# ---------------------------------------------------------------------------

OBS_ENV_KNOBS = ("ODTP_OBS", "ODTP_OBS_DIR", "ODTP_OBS_PROM_PORT")
OBS_REQUESTS, OBS_NEW_TOKENS = 8, 40
OBS_GAUGE_EVERY = 8  # decode steps between gauge publications (the batcher's default: 32)
OBS_TURNS = ("off", "on", "on", "off")
# (b): phase 25's run at the same cut of config_150m, 4 steps, 2 outer rounds
OBS_TRAIN = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                 total_steps=4, local_steps=2, lr=1e-3)
# the families a served request leaves in the Prometheus text
OBS_SERVE_FAMILIES = ("odtp_serve_tokens_generated", "odtp_serve_requests_completed", "odtp_serve_p50_ms", "odtp_serve_p99_ms",
                      "odtp_serve_tokens_per_s", "odtp_serve_batch_occupancy", "odtp_serve_queue_depth",
                      "odtp_serve_snapshot_staleness")
# and the kernel probe's, in the turn it runs (once a batcher)
OBS_PROBE_FAMILIES = ("odtp_serve_decode_attn_us", "odtp_serve_verify_attn_us", "odtp_serve_w4_matmul_us")
OBS_STAGE_CHAIN = ("queue", "prefill", "decode", "retire")
# a sample line of the Prometheus text exposition: name{labels} value
PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="([^"\\]|\\.)*"'
                       r'(,[a-zA-Z0-9_]+="([^"\\]|\\.)*")*\})? -?[0-9.e+-]+(e[+-][0-9]+)?$')


def obs_arm(folder) -> None:
    """Arm the obs plane in this process (``folder``: its sinks; None
    disarms): the env knobs, then ``obs.reset()`` so every accessor reads
    them anew."""
    import os

    from opendiloco_torch import obs

    for k in OBS_ENV_KNOBS:
        os.environ.pop(k, None)
    if folder is not None:
        os.environ.update({"ODTP_OBS": "smoke", "ODTP_OBS_DIR": folder, "ODTP_OBS_PROM_PORT": "0"})
    obs.reset()


def prom_families(text: str) -> set:
    """The families of a Prometheus text exposition; raises on a line that
    is neither a comment nor ``name{labels} value``."""
    families = set()
    for line in text.rstrip("\n").splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif not line.startswith("#") and not PROM_LINE.match(line):
            raise AssertionError(f"obs: unparsable Prometheus line {line!r}")
    return families


def phase_obs_serve(torch, tdk, cfg, params, dev, card: str) -> dict:
    """Phase 30 (a): the serving plane at config_1b, w4, over HTTP through
    ``ServeServer``, in turns with the obs plane off, on, on, off (one
    plane; the hooks read the env at each call). Each turn posts the same
    8 prompts at once, 40 new tokens each, every request with a ``"trace"``
    field. Armed, ``/metrics`` on the ephemeral Prometheus port parses and
    holds the ``serve_*`` families, the reqtrace dump holds a complete stage
    chain for each request, and the Chrome trace built from the tracer's
    JSONL loads. Every turn's streams equal the first's, and its launches
    of B6, its merge and B8, zeroed before the turn, equal the first's (the
    armed batcher's one kernel probe, measurement, is counted apart).
    Decode-step ms of each turn."""
    import os
    import tempfile

    from opendiloco_torch import obs
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.obs import export, reqtrace
    from opendiloco_torch.serve import build_serving

    scfg = ServeConfig(weight_format="w4")
    prompts = prompts_over_buckets(scfg, cfg.vocab_size, seed=30)[:OBS_REQUESTS]
    folder = tempfile.mkdtemp()
    obs_arm(None)
    plane = build_serving(scfg, cfg, params, device=dev)
    batcher, engine = plane.batcher, plane.engine
    batcher.gauge_every_steps = OBS_GAUGE_EVERY
    turns = []
    try:
        for r in [batcher.submit(p[:8], max_new_tokens=2) for p in prompts]:
            if not r.wait(600) or r.error is not None:
                raise AssertionError(f"obs warm-up request failed: {r.error}")
        for t, mode in enumerate(OBS_TURNS):
            sinks = os.path.join(folder, f"turn{t}")
            obs_arm(sinks if mode == "on" else None)
            base, decode0, probed = batcher.stats(), engine.stage_seconds["decode"], batcher._kernel_probed
            tdk.LAUNCHES.reset()
            outs = [{} for _ in prompts]

            def post(i, out):
                body = {"prompt": prompts[i], "max_new_tokens": OBS_NEW_TOKENS, "id": i,
                        "trace": {"id": f"obs-{t}-{i}", "o": "smoke"}}
                out.update(http_json(f"http://127.0.0.1:{plane.port}/generate", json.dumps(body).encode()))

            clients = [threading.Thread(target=post, args=(i, outs[i])) for i in range(len(prompts))]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            launches = tdk.LAUNCHES.snapshot()
            st = batcher.stats()
            bad = [o for o in outs if "tokens" not in o or "error" in o]
            if bad:
                raise AssertionError(f"obs turn {t} ({mode}): requests failed: {bad[:2]}")
            probe = dict(batcher.probe_launches) if batcher._kernel_probed and not probed else {}
            path = {k: n - probe.get(k, 0) for k, n in launches.items()}
            steps = st["decode_steps"] - base["decode_steps"]
            turn = {"mode": mode, "decode_steps": steps, "launches": path, "probe_launches": probe,
                    "decode_step_ms": (engine.stage_seconds["decode"] - decode0) / steps * 1e3,
                    "tokens": [o["tokens"] for o in outs]}
            if mode == "on":
                tr, rt = obs.tracer(), reqtrace.ring()
                if tr is None or rt is None or tr.prom is None:
                    raise AssertionError("obs: armed turn without a tracer, a ring or a Prometheus port")
                text = urllib_get(f"http://127.0.0.1:{tr.prom.port}/metrics")
                families = prom_families(text)
                # the decode counter's label: "pallas" where the kernels run
                want = (*OBS_SERVE_FAMILIES, f"odtp_serve_decode_kernel_{engine.decode_kernel}",
                        *(OBS_PROBE_FAMILIES if probe else ()))
                missing = [f for f in want if f not in families]
                if missing:
                    raise AssertionError(f"obs turn {t}: /metrics lacks {missing}")
                with open(rt.dump(reason="smoke")) as f:
                    dumped = {x["id"]: x for x in json.load(f)["traces"]}
                for i in range(len(prompts)):
                    got = dumped.get(f"obs-{t}-{i}")
                    stages = [s["stage"] for s in got["spans"]] if got else []
                    if (got is None or got["status"] != "done" or stages[:2] != ["queue", "prefill"]
                            or stages[-1] != "retire" or set(stages) != set(OBS_STAGE_CHAIN)):
                        raise AssertionError(f"obs turn {t}: request {i}'s trace {stages} is not a complete chain")
                events, meta = export.load_jsonl(tr.flush())
                chrome = json.loads(json.dumps(export.chrome_trace([(0, events, meta)])))
                names = {e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"}
                if "serve_prefill" not in names or not any(e["ph"] == "C" for e in chrome["traceEvents"]):
                    raise AssertionError(f"obs turn {t}: the Chrome trace lacks the serving spans: {sorted(names)}")
                turn.update(families=len(families), chrome_events=len(chrome["traceEvents"]),
                            counters={k: v for k, v in meta["counters"].items() if k.startswith("serve_")})
            turns.append(turn)
            obs_arm(None)
    finally:
        obs_arm(None)
        plane.stop()
    first = turns[0]
    for t, turn in enumerate(turns[1:], 1):
        if turn["tokens"] != first["tokens"]:
            raise AssertionError(f"obs turn {t} ({turn['mode']}): streams differ from turn 0's: "
                                 f"{agreement(turn['tokens'], first['tokens'])}")
        if turn["launches"] != first["launches"] or turn["decode_steps"] != first["decode_steps"]:
            raise AssertionError(f"obs turn {t} ({turn['mode']}): {turn['decode_steps']} steps, launches "
                                 f"{turn['launches']} != turn 0's {first['decode_steps']}, {first['launches']}")
    if not any(turn["probe_launches"] for turn in turns):
        raise AssertionError("obs: the armed batcher's kernel probe never ran")
    for turn in turns:
        turn.pop("tokens")
    res = {"turns": turns, "requests": len(prompts), "new_tokens": OBS_NEW_TOKENS, "card": card,
           "decode_step_ms": {f"{t} {turn['mode']}": turn["decode_step_ms"] for t, turn in enumerate(turns)}}
    log(f"obs serve 1b w4 decode-step ms by turn (off, on, on, off): "
        f"{json.dumps({k: round(v, 4) for k, v in res['decode_step_ms'].items()})} | {card}")
    log(f"obs serve: {json.dumps(res)}")
    return res


def urllib_get(url: str, timeout: float = 60.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def obs_train_run(torch, tfa, dev, model: str, folder) -> dict:
    """Two loopback workers of ``train()`` with the kernels and the fused
    loss, the obs plane armed with its sinks in ``folder`` (None: off); the
    launch counters zeroed just before, read just after."""
    import os
    import pickle
    import tempfile

    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.train import train

    tmp = tempfile.mkdtemp()
    backends = LoopbackWorld(2).make_backends()
    configs = [train_config(model, OBS_TRAIN, r, os.path.join(tmp, f"metrics-{r}.pkl"),
                            dict(path=os.path.join(tmp, "ckpts"), interval=None), attn_implementation="pallas",
                            fused_loss=True) for r in range(2)]
    obs_arm(folder)
    try:
        tfa.LAUNCHES.reset()
        run_workers(train, [(configs[r], backends[r], dev) for r in range(2)])
        launches = tfa.LAUNCHES.snapshot()
        from opendiloco_torch import obs

        tr = obs.tracer()
        # both workers' events: the tracer is the process's
        identity, jsonl = (dict(tr.identity), tr.flush()) if tr is not None else (None, None)
    finally:
        obs_arm(None)
    rows = []
    for r in range(2):
        with open(os.path.join(tmp, f"metrics-{r}.pkl"), "rb") as f:
            rows.append(pickle.load(f))
    return {"rows": rows, "launches": launches, "identity": identity, "jsonl": jsonl}


def phase_obs_train(torch, tfa, dev, card: str) -> dict:
    """Phase 30 (b): two loopback workers at config_150m's widths and 2 of
    its layers (``CUT_LAYERS``) with the kernels and the fused loss, 4
    steps, ``local_steps`` 2, unarmed then armed: the armed losses equal
    the unarmed bit for bit and so do the launches; every armed row has
    ``mfu`` from ``analytic_6n`` and the card's peak; the JSONL holds
    ``inner_steps``, ``outer_rounds`` and the ``outer/*`` spans; the black
    box is dumped at exit."""
    import glob
    import os
    import tempfile

    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.models.llama import num_params
    from opendiloco_torch.obs import export, mfu

    model = cut_depth("150m", CUT_LAYERS, tempfile.mkdtemp())
    folder = tempfile.mkdtemp()
    off = obs_train_run(torch, tfa, dev, model, None)
    on = obs_train_run(torch, tfa, dev, model, folder)
    losses = [[r["Loss"] for r in rows] for rows in on["rows"]]
    if losses != [[r["Loss"] for r in rows] for rows in off["rows"]]:
        raise AssertionError(f"obs train: armed losses {losses} differ from the unarmed run's")
    if on["launches"] != off["launches"] or not any(on["launches"].values()):
        raise AssertionError(f"obs train: armed launches {on['launches']} != unarmed {off['launches']}")
    name = torch.cuda.get_device_name(dev)
    flops, peak, source = mfu.flops_per_token(model, num_params(load_config(model)), name)
    if source != "analytic_6n" or on["identity"].get("mfu_source") != "analytic_6n":
        raise AssertionError(f"obs train: mfu source {source} / {on['identity']} on {name}")
    mfus = [r.get("mfu") for rows in on["rows"] for r in rows]
    if not all(isinstance(u, float) and 0 < u < 1 for u in mfus):
        raise AssertionError(f"obs train: rows' mfu {mfus}")
    for rows in on["rows"]:
        for r in rows:
            want = mfu.mfu(r["tokens_per_second"], flops, 1, peak)
            if r["mfu"] != want:
                raise AssertionError(f"obs train: step {r['step']} mfu {r['mfu']} != {want} (6N at {peak:.3e})")
    events, meta = export.load_jsonl(on["jsonl"])
    spans = {e["name"] for e in events if e["ph"] in ("X", "i")}
    want_spans = {"inner/dispatch", "outer/barrier_wait", "outer/d2h", "outer/allreduce", "outer/apply",
                  "outer/step", "outer/round"}
    if meta["counters"].get("inner_steps") != 8 or meta["counters"].get("outer_rounds") != 4 or not (
            want_spans <= spans):
        raise AssertionError(f"obs train: JSONL counters {meta['counters']}, spans {sorted(spans)}")
    boxes = sorted(glob.glob(os.path.join(folder, "blackbox-*.json")))
    reasons = []
    for path in boxes:
        with open(path) as f:
            reasons.append(json.load(f)["reason"])
    if "train_exit" not in reasons:
        raise AssertionError(f"obs train: no black box dumped at exit in {folder}: {boxes} {reasons}")
    step_ms = lambda run: [[r["time_taken"] * 1e3 for r in rows if r["step"] > 1 and "outer_step_s" not in r]
                           for rows in run["rows"]]
    res = {"losses": losses, "launches": on["launches"], "mfu": mfus, "flops_per_token": flops, "peak": peak,
           "card": card, "counters": meta["counters"], "black_box": [os.path.basename(b) for b in boxes],
           "inner_step_ms": {"off": step_ms(off), "on": step_ms(on)}}
    log(f"obs train: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phase 31: the obs plane across the galaxy, gossip and the fleet
# ---------------------------------------------------------------------------

# (a) counters the armed JSONL must hold (the outer backend's per-layer metrics)
OBS_GALAXY_COUNTERS = ("rdv_rpcs", "rdv_frames", "rdv_rounds_closed", "peer_frames")
OBS_GALAXY_CODEC = "uniform8bit"
# (c) the fleet: one in-process replica at the fleet's geometry, 8 requests
# one at a time (their decode steps, and so the launches, do not hang on
# the timing of admissions), 32 new tokens each
OBS_FLEET = dict(enabled=True, replicas=1, inprocess=True, prefix_cache=True, push_interval_s=0.05)
OBS_FLEET_REQUESTS, OBS_FLEET_NEW_TOKENS = 8, 32


def control_rpc(backend, msg: str) -> tuple:
    """One control RPC to a worker from a plain client (the port's wire)."""
    import asyncio

    from opendiloco_torch.diloco import wire

    return asyncio.run(wire.request(backend.host, backend.port, msg, {}, timeout=60.0))


def obs_galaxy_run(torch, tfa, dev, model: str, folder) -> dict:
    """:func:`tcp_workers` (OBS_TRAIN, OBS_GALAXY_CODEC) with the obs plane
    armed, sinks in ``folder`` (None: off), at a fresh daemon; before each
    backend closes, its ``metrics`` and ``health`` RPCs from a plain client.
    Adds the flushed JSONL's meta and the master's element count."""
    import os

    from opendiloco_torch import obs
    from opendiloco_torch.diloco.rendezvous import RendezvousServer
    from opendiloco_torch.obs import export

    rpcs: dict = {}

    def ask(backend):
        rpcs[backend.peer_id] = {msg: control_rpc(backend, msg) for msg in ("metrics", "health")}

    expect = os.environ.get("ODTP_EXPECT_PEERS")
    os.environ["ODTP_EXPECT_PEERS"] = "2"
    daemon = RendezvousServer("127.0.0.1", 0).start_in_thread()
    obs_arm(folder)
    try:
        tw = tcp_workers(torch, tfa, dev, daemon.address, model, OBS_TRAIN, OBS_GALAXY_CODEC, before_close=ask,
                         extra=dict(attn_implementation="pallas", fused_loss=True))
        tr = obs.tracer()
        tw["meta"] = export.load_jsonl(tr.flush())[1] if tr is not None else None
    finally:
        obs_arm(None)
        daemon.stop()
        if expect is None:
            os.environ.pop("ODTP_EXPECT_PEERS")
        else:
            os.environ["ODTP_EXPECT_PEERS"] = expect
    backends = tw.pop("backends")
    tw["elements"] = sum(int(x.size) for x in master_now(backends[0].provider))
    tw["peers"] = [b.peer_id for b in backends]
    tw["rpcs"] = rpcs
    del backends
    gc.collect()
    torch.cuda.empty_cache()
    return tw


def obs_gossip_pair() -> dict:
    """(b): one lockstep pair round on a loopback world, armed: two
    GossipPlanes over 150m-width leaves (a 1024 x 1024 projection and a
    norm) in blockwise4bit with error feedback."""
    from opendiloco_torch import obs
    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.diloco.gossip import GossipPlane

    rng = np.random.default_rng(31)
    leaves = lambda: [rng.standard_normal(s).astype(np.float32) for s in ((1024, 1024), (1024,))]  # noqa: E731
    inputs = [(leaves(), leaves(), [x * np.float32(1e-3) for x in leaves()]) for _ in range(2)]
    backends = LoopbackWorld(2).make_backends()
    obs_arm("")  # armed, no sinks
    try:
        planes = [GossipPlane(b, 2, compression=GOSSIP_DILOCO["compression"], error_feedback=True) for b in backends]
        out = run_workers(lambda r: planes[r].exchange(epoch=3, frag_id=0, idxs=[0, 1], masters=inputs[r][0],
                                                       bufs=inputs[r][1], pgs=inputs[r][2], timeout=120.0),
                          [(0,), (1,)])
        counters = obs.tracer().counters()
        rows = sorted(obs.overseer.plane().matrix())
    finally:
        obs_arm(None)
    if any(o is None or o[4] != 2 for o in out):
        raise AssertionError(f"obs gossip: a side did not pair ({[None if o is None else o[3:] for o in out]})")
    wire = sum(b.last_round_health["wire_bytes"] for b in backends)
    raw = sum(x.nbytes for r in range(2) for part in inputs[r] for x in part)
    got = {k: counters.get((k, (("codec", "gossip"),))) for k in ("outer_raw_bytes", "outer_wire_bytes")}
    if got != {"outer_raw_bytes": raw, "outer_wire_bytes": wire} or counters.get(("gossip_pair_rounds", ())) != 2:
        raise AssertionError(f"obs gossip: record_wire {got}, pair rounds {counters.get(('gossip_pair_rounds', ()))}; "
                             f"want raw {raw}, wire {wire} (the ledger's), 2 rounds")
    if not {b.peer_id for b in backends} <= set(rows):
        raise AssertionError(f"obs gossip: the overseer's rows {rows} lack the pair")
    return {"raw_bytes": raw, "wire_bytes": wire, "overseer_rows": rows}


def obs_fleet(torch, tdk, dev, model: str) -> dict:
    """(c): a publisher of random masters (seed 31) feeds one in-process
    replica through a keyframe (epoch 0) and a delta (epoch 1), armed;
    then the same 8 requests, one at a time through the router, armed and
    unarmed, the launch counters zeroed before each turn."""
    from opendiloco_torch import obs
    from opendiloco_torch.config import FleetConfig
    from opendiloco_torch.fleet import build_fleet
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.models.llama import flatten_params, init_params
    from opendiloco_torch.obs import reqtrace

    cfg = load_config(model)
    params = init_params(torch.Generator(device=dev).manual_seed(31), cfg)
    masters = [x.detach().float().cpu().numpy().reshape(-1).copy() for x in flatten_params(params)]
    state = {"epoch": 0}
    # the publisher's view of a worker: its masters at its epoch
    trainer = types.SimpleNamespace(master_snapshot=lambda: (state["epoch"], masters))

    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in rng.integers(8, 120, OBS_FLEET_REQUESTS)]

    def wait(pred, what):
        deadline = time.monotonic() + 120
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"obs fleet: {what}")
            time.sleep(0.01)

    obs_arm("")
    plane = build_fleet(FleetConfig(**OBS_FLEET), cfg, params, trainer, compute_dtype=torch.bfloat16, device=dev)
    del params
    rep, turns = plane.replicas["r0"], {}
    try:
        wait(lambda: rep.engine.weights_epoch == 0, "the replica never took the keyframe")
        for m in masters:
            m += np.float32(1e-3)
        state["epoch"] = 1
        wait(lambda: rep.engine.weights_epoch == 1, "the replica never took the delta")
        for mode in ("on", "off"):  # the armed turn keeps the tracer that counted the pushes
            if mode == "off":
                obs_arm(None)
            probed = rep.batcher._kernel_probed
            tdk.LAUNCHES.reset()
            outs = [plane.router.dispatch({"prompt": p, "max_new_tokens": OBS_FLEET_NEW_TOKENS, "id": i})
                    for i, p in enumerate(prompts)]
            launches = tdk.LAUNCHES.snapshot()
            bad = [o for o in outs if "error" in o or len(o.get("tokens", [])) != OBS_FLEET_NEW_TOKENS]
            if bad:
                raise AssertionError(f"obs fleet turn {mode}: requests failed: {bad[:2]}")
            probe = dict(rep.batcher.probe_launches) if rep.batcher._kernel_probed and not probed else {}
            turn = {"tokens": [o["tokens"] for o in outs], "probe_launches": probe,
                    "launches": {k: n - probe.get(k, 0) for k, n in launches.items()}}
            if mode == "on":
                counters = obs.tracer().counters()
                traces = list(reqtrace.ring().completed)
                chains = [[s["stage"] for s in t["spans"]] for t in traces]
                for chain in chains:
                    body = [x for x in chain if x not in ("admit", "forward")]
                    if (chain[0] != "admit" or chain[-1] != "forward" or body[:2] != ["queue", "prefill"]
                            or body[-1] != "retire" or set(body) != set(OBS_STAGE_CHAIN)):
                        raise AssertionError(f"obs fleet: a trace is not one chain: {chain}")
                if len(chains) != len(prompts) or any(t["status"] != "done" for t in traces):
                    raise AssertionError(f"obs fleet: {len(chains)} traces for {len(prompts)} requests")
                fleet = {f"{k}{dict(lb)}": v for (k, lb), v in counters.items() if k.startswith("fleet_")}
                want = {"fleet_router_dispatch{'replica': 'r0'}": len(prompts),
                        "fleet_push_frames{'kind': 'keyframe', 'replica': 'r0'}": 1,
                        "fleet_push_frames{'kind': 'delta', 'replica': 'r0'}": 1}
                if any(fleet.get(k) != v for k, v in want.items()):
                    raise AssertionError(f"obs fleet: counters {fleet}, want {want}")
                turn.update(counters=fleet, traces=len(chains), stages=sorted({x for c in chains for x in c}))
            turns[mode] = turn
    finally:
        obs_arm(None)
        plane.stop()
    on, off = turns["on"], turns["off"]
    if on["tokens"] != off["tokens"]:
        raise AssertionError(f"obs fleet: armed streams differ from unarmed: {agreement(on['tokens'], off['tokens'])}")
    if on["launches"] != off["launches"] or not on["launches"].get("paged_decode_attention"):
        raise AssertionError(f"obs fleet: armed launches {on['launches']} != unarmed {off['launches']}")
    for turn in turns.values():
        turn.pop("tokens")
    return turns


def phase_obs_galaxy(torch, tfa, tdk, dev, card: str) -> dict:
    """Phase 31: the obs plane across the TCP galaxy, gossip and the fleet
    at config_150m's widths and CUT_LAYERS of its layers (see the module
    docstring)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    folder = tempfile.mkdtemp()
    model = cut_depth("150m", CUT_LAYERS, folder)
    off = obs_galaxy_run(torch, tfa, dev, model, None)
    on = obs_galaxy_run(torch, tfa, dev, model, folder)
    losses = lambda run: [[r["Loss"] for r in rows] for rows in run["rows"]]  # noqa: E731
    for key, a, b in (("master hashes", on["hashes"], off["hashes"]), ("losses", losses(on), losses(off)),
                      ("launches", on["launches"], off["launches"])):
        if a != b:
            raise AssertionError(f"obs galaxy: armed {key} {a} != unarmed {b}")
    counters = on["meta"]["counters"]
    missing = [c for c in OBS_GALAXY_COUNTERS if not any(k.split("{")[0] == c for k in counters)]
    if missing:
        raise AssertionError(f"obs galaxy: the JSONL lacks {missing}: {sorted(counters)}")
    rounds = [len(led) for led in on["ledgers"]]
    raw = 4 * on["elements"] * rounds[0]
    wire = {k: counters.get(f"{k}{{codec={OBS_GALAXY_CODEC}}}") for k in ("outer_raw_bytes", "outer_wire_bytes")}
    if rounds != [2, 2] or wire != {"outer_raw_bytes": raw, "outer_wire_bytes": raw // 4}:
        raise AssertionError(f"obs galaxy: {wire} over the ledger's {rounds} rounds of {on['elements']} elements")
    for label, run in (("armed", on), ("unarmed", off)):
        for peer, answers in run["rpcs"].items():
            (m_msg, m_meta, body), (h_msg, h_meta, _) = answers["metrics"], answers["health"]
            if m_msg != "ok" or h_msg != "ok" or m_meta.get("format") != "prometheus-0.0.4":
                raise AssertionError(f"obs galaxy {label}: {peer}'s RPCs answered {m_msg} {m_meta}, {h_msg}")
            if label == "unarmed":
                if body or h_meta["matrix"]:
                    raise AssertionError(f"obs galaxy: unarmed {peer} answered {body[:80]!r}, {h_meta}")
                continue
            families = prom_families(body.decode())
            if not {"odtp_rdv_rpcs", "odtp_peer_frames", "odtp_outer_rounds"} <= families:
                raise AssertionError(f"obs galaxy: {peer}'s metrics families {sorted(families)}")
            if not set(run["peers"]) <= set(h_meta["matrix"]):
                raise AssertionError(f"obs galaxy: {peer}'s health matrix {sorted(h_meta['matrix'])}")
    if len(on["rpcs"]) != 2:
        raise AssertionError(f"obs galaxy: RPCs answered by {sorted(on['rpcs'])}")
    gossip = obs_gossip_pair()
    fleet = obs_fleet(torch, tdk, dev, model)
    shutil.rmtree(folder, ignore_errors=True)
    res = {"config": f"150m widths, {CUT_LAYERS} layers", **OBS_TRAIN, "codec": OBS_GALAXY_CODEC,
           "launches": on["launches"], "master_hashes": on["hashes"], "losses": losses(on),
           "counters": {k: v for k, v in counters.items() if k.split("{")[0] in (
               *OBS_GALAXY_COUNTERS, "outer_raw_bytes", "outer_wire_bytes", "bulk_tx_bytes", "bulk_rx_bytes",
               "wire_tx_bytes", "wire_rx_bytes", "outer_rounds")},
           "train_wall_s": {"off": off["wall"], "on": on["wall"]},
           "inner_step_ms_median": {k: float(np.median(inner_step_s(r["rows"]))) * 1e3
                                    for k, r in (("off", off), ("on", on))},
           "outer_step_s": {k: [x for rows in r["rows"] for x in (row.get("outer_step_s") for row in rows) if x]
                            for k, r in (("off", off), ("on", on))},
           "gossip": gossip, "fleet": fleet, "seconds": time.perf_counter() - t0}
    log(f"obs galaxy 150m ({CUT_LAYERS} layers): TCP armed = unarmed (master hashes, losses, launches); "
        f"counters {json.dumps(res['counters'])}; gossip {json.dumps(gossip)}; fleet armed = unarmed (streams, "
        f"launches {json.dumps(fleet['off']['launches'])}), {json.dumps(fleet['on']['counters'])}; "
        f"phase {res['seconds']:.1f} s | {card}")
    return res


PHASE_SECONDS: dict = {}


# ---------------------------------------------------------------------------
# phase 32: selective remat, the normative driver, the input prefetcher and
# ServeConfig.decode_kernel
# ---------------------------------------------------------------------------

REMAT_LAYERS = 4  # of config_1b's 22 (phase 32 (a): the smoke's time limit)
REMAT_POLICIES = (True, "dots", "dots_all", False)
REMAT_RUN = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16)
REMAT_TIMED_STEPS = 3
# phase 32 (c): phase 8's run at CUT_LAYERS of config_150m's 12, 4 steps,
# local_steps 2, no checkpoints
PREFETCH_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                     total_steps=4, local_steps=2, lr=1e-3)
DECODE_KERNEL_REQUESTS = 4
DECODE_KERNEL_NEW_TOKENS = 16


def grads_checksum(torch, grads) -> int:
    """An integer over every bit of ``grads`` (f32 words weighted by their
    position), summed on the card: equal gradients give equal sums."""
    total = 0
    for g in grads:
        w = g.detach().contiguous().view(-1).view(torch.int32).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 1000003 + 1
        total += int((w * pos).sum())
    return total


def remat_loss_grads(torch, tr, state, batch):
    """Loss and whole gradients of one inner step (accum micro-batches,
    summed as the trainer sums them), without the update."""
    from opendiloco_torch.models.llama import flatten_params

    leaves = flatten_params(state["params"])
    loss_sum, grad_sum = None, None
    for i in range(batch["input_ids"].shape[0]):
        loss = tr._loss_fn(state["params"], batch["input_ids"][i], batch["labels"][i])
        grads = torch.autograd.grad(loss, leaves)
        if grad_sum is None:
            loss_sum, grad_sum = loss.detach(), list(grads)
        else:
            loss_sum = loss_sum + loss.detach()
            torch._foreach_add_(grad_sum, grads)
    return loss_sum, grad_sum


def phase_remat(torch, tfa, dev, card: str) -> dict:
    """Phase 32 (a): config_1b's widths at REMAT_LAYERS of its 22 layers,
    mb 8 x accum 2 x seq 1024, bf16, the flash kernels and the fused loss,
    one inner step's loss and gradients under each of True, "dots",
    "dots_all" and False from the same numpy params and batch: every one
    bit for bit True's; B1 4 L launches under True and 2 L under the
    others (the selective policies keep B1's out and lse), the backward
    and loss kernels alike under all four. Then each policy's step ms (full
    ``train_step``, after a warm-up step, the collector frozen) and peak
    device memory."""
    import tempfile

    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.models.llama import shapes
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg = load_config(cut_depth("1b", REMAT_LAYERS, tempfile.mkdtemp()))
    L, run = cfg.num_hidden_layers, REMAT_RUN
    accum = run["total_batch_size"] // run["per_device_train_batch_size"]
    params = np_params(shapes(cfg), np.random.default_rng(32))
    ds = iter(FakeTokenizedDataset(run["seq_length"], cfg.vocab_size, seed=32, mode="ramp"))
    ids = np.stack([next(ds)["input_ids"] for _ in range(run["total_batch_size"])])
    chunks = -(-run["per_device_train_batch_size"] * (run["seq_length"] - 1) // 2048)
    ref_grads, res = None, {"layers": L, "accum": accum, "policies": {}}
    for policy in REMAT_POLICIES:
        tr = InnerTrainer(cfg, TrainerConfig(precision="bf16-mixed", remat=policy, attn_impl="pallas",
                                             fused_loss=True, warmup_steps=2, total_steps=100), device=dev)
        state = tr.init_state(params=params)
        batch = tr.shard_batch(ids, ids.copy(), accum=accum)
        tfa.LAUNCHES.reset()
        loss, grads = remat_loss_grads(torch, tr, state, batch)
        torch.cuda.synchronize()
        launches = tfa.LAUNCHES.snapshot()
        want = {"flash_attention_fwd_sm90": (4 if policy is True else 2) * L,
                "flash_attention_delta": L * accum, "flash_attention_dq_sm90": L * accum,
                "flash_attention_dkv_sm90": L * accum, "fused_xent_fwd_sm90": accum,
                "fused_xent_dlog_sm90": accum * chunks, "fused_xent_dh_sm90": accum * chunks,
                "fused_xent_dw_sm90": accum * chunks}
        check_launches(launches, want, f"remat {policy!r} step")
        checksum = grads_checksum(torch, grads)
        if ref_grads is None:
            ref_loss, ref_grads = loss, grads
        else:
            if not torch.equal(loss, ref_loss):
                raise AssertionError(f"remat {policy!r}: loss {float(loss)} != True's {float(ref_loss)}")
            bad = [i for i, (a, b) in enumerate(zip(grads, ref_grads)) if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"remat {policy!r}: gradient leaves {bad} differ from True's")
        del grads
        state, m = tr.train_step(state, batch)  # the warm-up step
        float(m["loss"])
        gc.collect()
        gc.freeze()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(REMAT_TIMED_STEPS + 1)]
            t0 = time.perf_counter()
            events[0].record()
            for i in range(REMAT_TIMED_STEPS):
                state, m = tr.train_step(state, batch)
                events[i + 1].record()
            float(m["loss"])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / REMAT_TIMED_STEPS * 1e3
        finally:
            gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() / 2**30
        res["policies"][str(policy)] = {
            "loss": float(loss) / accum, "grads_checksum": checksum, "launches": launches, "step_ms": step_ms,
            "card_ms_by_step": [events[i].elapsed_time(events[i + 1]) for i in range(REMAT_TIMED_STEPS)],
            "peak_memory_gib": peak}
        log(f"remat 1b ({L} layers) {policy!r}: loss {float(loss) / accum:.6f}, gradients checksum {checksum}, B1 "
            f"{launches.get('flash_attention_fwd_sm90')} (delta/B2a/B2b {L * accum}, B3 {accum}, dlog/B4a/B4b "
            f"{accum * chunks}), step {step_ms:.1f} ms (card {res['policies'][str(policy)]['card_ms_by_step']}), "
            f"peak {peak:.2f} GiB | {card}")
        del tr, state, batch, m, loss
        torch.cuda.empty_cache()
    del ref_grads, ref_loss
    torch.cuda.empty_cache()
    log(f"remat 1b ({L} layers): every policy's loss and gradients bit for bit True's")
    return res


def phase_driver(torch, tfa, dev, card: str) -> dict:
    """Phase 32 (b): ``train_diloco.run`` at config_150m's widths and
    CUT_LAYERS of its layers, two simulated workers, 4 steps,
    ``--local-steps`` 2, ``--eval-interval`` 2, mb 8 x seq 1024, bf16, on
    the learnable ramp stream (on the JAX driver's uniform tokens nothing
    is learnable in 4 steps), on host then on device placement: B1 and
    the backward kernels launch, losses finite and falling, the two
    placements' masters, losses and eval losses bit for bit."""
    import tempfile

    from opendiloco_torch import train_diloco

    model = cut_depth("150m", CUT_LAYERS, tempfile.mkdtemp())
    res = {}
    for placement in ("host", "device"):
        args = train_diloco.build_parser().parse_args(
            ["--path-model", model, "--fake-data", "--fake-data-mode", "ramp", "--num-workers", "2", "--local-steps",
             "2", "--total-steps", "4",
             "--warmup-steps", "1", "--lr", "1e-3", "--batch-size", "8", "--seq-length", "1024",
             "--eval-interval", "2", "--eval-batches", "2", "--outer-placement", placement])
        tfa.LAUNCHES.reset()
        t0 = time.perf_counter()
        out = train_diloco.run(args, dev)
        wall = time.perf_counter() - t0
        launches = tfa.LAUNCHES.snapshot()
        for name in ("flash_attention_fwd_sm90", "flash_attention_delta", "flash_attention_dq_sm90",
                     "flash_attention_dkv_sm90"):
            if not launches.get(name):
                raise AssertionError(f"driver {placement}: {name} never launched ({launches})")
        losses = out["losses"]
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"driver {placement}: losses {losses}")
        res[placement] = {"losses": losses, "eval_losses": out["eval_losses"], "launches": launches,
                          "master_hash": master_hash(out["master"]), "wall_s": wall}
        log(f"train_diloco 150m ({CUT_LAYERS} layers) {placement}: losses {losses}, eval {out['eval_losses']}, "
            f"master {res[placement]['master_hash'][:16]}, launches {launches}, {wall:.1f} s | {card}")
    h, d = res["host"], res["device"]
    if (h["losses"], h["eval_losses"], h["master_hash"]) != (d["losses"], d["eval_losses"], d["master_hash"]):
        raise AssertionError(f"driver: host and device placement differ: {res}")
    log("train_diloco: host and device placement bit for bit (losses, eval losses, masters)")
    return res


def phase_prefetch(torch, tfa, dev, card: str) -> dict:
    """Phase 32 (c): phase 8's two workers at config_150m's widths and
    CUT_LAYERS of its layers, 4 steps, at ``prefetch_depth`` 0 and 2
    (:func:`train_workers`): losses, LRs, grad norms and the master hashes
    at each round bit for bit; each run's ``data_wait_s`` by step."""
    import tempfile

    model = cut_depth("150m", CUT_LAYERS, tempfile.mkdtemp())
    res = {}
    for depth in (0, 2):
        tw = train_workers(torch, tfa, dev, model, PREFETCH_150M, extra={"prefetch_depth": depth})
        res[depth] = {"losses": [[r["Loss"] for r in rr] for rr in tw["rows"]],
                      "lrs": [[r["lr"] for r in rr] for rr in tw["rows"]],
                      "grad_norms": [[r["grad_norm"] for r in rr] for rr in tw["rows"]],
                      "data_wait_s": [[r["data_wait_s"] for r in rr] for rr in tw["rows"]],
                      "step_s": inner_step_s(tw["rows"]), "hashes": tw["hashes"], "launches": tw["launches"],
                      "wall_s": tw["wall"]}
        log(f"prefetch 150m ({CUT_LAYERS} layers) depth {depth}: data_wait_s {res[depth]['data_wait_s']}, "
            f"inner step s {res[depth]['step_s']}, train wall {tw['wall']:.2f} s | {card}")
    a, b = res[0], res[2]
    for k in ("losses", "lrs", "grad_norms", "hashes", "launches"):
        if a[k] != b[k]:
            raise AssertionError(f"prefetch depth 0 vs 2: {k} differ: {a[k]} vs {b[k]}")
    log("prefetch: depth 0 and 2 bit for bit (losses, LRs, grad norms, master hashes, launches)")
    return res


def phase_decode_kernel(torch, tdk, cfg, params, dev, card: str) -> dict:
    """Phase 32 (d): a config_1b w4 engine in f32 compute (bf16 would let
    the two paths' roundings tell tokens apart) under ``decode_kernel``
    "auto" and "xla", DECODE_KERNEL_REQUESTS of phase 4's prompts at once,
    DECODE_KERNEL_NEW_TOKENS tokens each: the streams equal; under "auto"
    B6 and its merge phase 4's counts a decode step and B8 (the first
    design, f32) 7 x 22 a prefill and a decode step; under "xla" no kernel
    at all."""
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.serve import build_serving

    L = cfg.num_hidden_layers
    res, streams = {}, {}
    for kernel in ("auto", "xla"):
        sc = ServeConfig(weight_format="w4", decode_kernel=kernel)
        prompts = prompts_over_buckets(sc, cfg.vocab_size)[:DECODE_KERNEL_REQUESTS]
        plane = build_serving(sc, cfg, params, compute_dtype=torch.float32, device=dev, start_server=False)
        try:
            batcher = plane.batcher
            for r in [batcher.submit(p[:8], max_new_tokens=2) for p in prompts]:
                if not r.wait(600) or r.error is not None:
                    raise AssertionError(f"decode_kernel {kernel}: warm-up failed: {r.error}")
            base = batcher.stats()
            tdk.LAUNCHES.reset()
            t0 = time.perf_counter()
            reqs = [batcher.submit(p, max_new_tokens=DECODE_KERNEL_NEW_TOKENS) for p in prompts]
            for r in reqs:
                if not r.wait(1200) or r.error is not None:
                    raise AssertionError(f"decode_kernel {kernel}: request failed: {r.error}")
            wall = time.perf_counter() - t0
            launches = tdk.LAUNCHES.snapshot()
            st = batcher.stats()
            steps, prefills = st["decode_steps"] - base["decode_steps"], st["completed"] - base["completed"]
            engine_kernel = plane.engine.decode_kernel
        finally:
            plane.stop()
        want = ({"paged_decode_attention": L * steps, "paged_decode_attention_merge": PAGED_MERGES_PER_STEP * steps,
                 "w4_matmul": 7 * L * (prefills + steps)} if kernel == "auto" else {})
        check_launches(launches, want, f"decode_kernel {kernel} ({steps} decode steps, {prefills} prefills)")
        streams[kernel] = [r.tokens for r in reqs]
        res[kernel] = {"resolved": engine_kernel, "decode_steps": steps, "prefills": prefills, "launches": launches,
                       "wall_s": wall}
        log(f"decode_kernel {kernel} (resolved {engine_kernel}), 1b w4 f32: {steps} decode steps, {prefills} "
            f"prefills, launches {launches}, {wall:.2f} s | {card}")
    if streams["auto"] != streams["xla"]:
        raise AssertionError(f"decode_kernel: auto and xla streams differ: {streams}")
    log(f"decode_kernel: auto and xla streams equal ({DECODE_KERNEL_REQUESTS} x {DECODE_KERNEL_NEW_TOKENS} tokens)")
    return res


# ---------------------------------------------------------------------------
# phase 33: precision="fp16-mixed" through every kernel
# ---------------------------------------------------------------------------

# f16 keeps 10 mantissa bits to bf16's 7: a bf16 phase's floor that bounds a
# 16-bit rounding is divided by 8 here; floors that bound f32 arithmetic
# (lse, nll, delta, dw: exact products, sums in another order, ex2.approx)
# stay as they were
F16_SCALED = 2.0**-3
F16_REL = 2.0**-10  # one f16 ulp of the value: f32 sums re-associate before the one rounding
F16_TOL = ("element by element, |got - ref| <= 2**-10 |ref| + floor: attention outputs (out, dq, dk, dv, B6, B7) "
           "2**-9 of each (batch, head), slot or (slot, token)'s largest output; B8 2**-10 of the largest output; "
           "dlog 2**-11 max(g) / V; dh 1.25e-6 of the largest |dh|; the merges 2**-11 of the largest output (at "
           "least 1): the bf16 phases' floors over 8. lse and nll 1e-4 of the largest |lse|, delta 1e-6 of the "
           "largest |delta|, dw 1e-5 of the largest |dw| (f32 arithmetic, as in bf16)")
# the loss scale fp16-mixed starts at: the fused loss's checks scale their
# upstream gradient by it, as the trainer does (unscaled, dlog would sit in
# f16's subnormals)
FP16_SCALE = 2.0**15
FP16_OVERFLOW_SCALE = 2.0**40  # the overflow step of phase 33 (b): every f16 gradient past 65504
FP16_TIMED_STEPS = 3
# phase 33 (c): two workers at config_150m's widths and CUT_LAYERS of its
# layers, 6 steps, 3 rounds; worker 0 serves w4 with spec decode, worker 1
# w4 with plain decode; 2 slots, so that both kernels cut the ring into
# splits and their merges run (at 8 slots x 16 kv heads the card is full)
FP16_SERVE_RUN = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                      total_steps=6, local_steps=2, lr=1e-3)
FP16_SERVE = dict(enabled=True, weight_format="w4", max_batch=2, max_stale_rounds=0, swap_every_steps=4, port=0)
FP16_SERVE_NEW_TOKENS = 16


def f16_share(got, ref, floor) -> tuple[float, float]:
    """(the worst element's |got - ref| over 2**-10 |ref| + floor, the
    largest |got - ref|); ``floor`` a number or a tensor that broadcasts
    against ``ref``."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return float((err / (F16_REL * ref.abs() + floor)).max()), float(err.max())


def in_turns(torch, bf16: tuple, f16: tuple, launches: int) -> dict:
    """Device ms of the same work in bf16 and in f16, in turns (bf16, f16,
    f16, bf16); each of ``bf16`` and ``f16`` is (fn, arg sets)."""
    runs = [device_ms(torch, *x, launches=launches) for x in (bf16, f16, f16, bf16)]
    return {"bf16_ms": min(runs[0], runs[3]), "f16_ms": min(runs[1], runs[2]), "runs": runs,
            "f16_over_bf16": min(runs[1], runs[2]) / min(runs[0], runs[3])}


def fp16_kernels(torch, tdk, tfa, tfx, quant, cfg, serve_cfg, dev) -> dict:
    """Phase 33 (a): every kernel's f16 instance against its plain version
    at f16 (F16_TOL), on both routes where both exist, at phases 2, 3, 7,
    9 and 11's main shapes; then the device ms of the f16 instances at the
    1b shapes beside the bf16 ones in turns (CUDA-graph replays past L2, as
    the bf16 phases time them), and of the first designs in f16. Returns
    {kernel name: {"checks", "max_abs_err", "share_of_tol", "ms",
    "bf16_ms_same_call", "bound_ms", "bound_by", ...}}."""
    f16, bf16 = torch.float16, torch.bfloat16
    res: dict = {}

    def check(name, label, got, ref, floor):
        share, err = f16_share(got, ref, floor)
        row = res.setdefault(name, {"checks": []})
        row["checks"].append({"shape": label, "max_abs_err": err, "share_of_tol": share})
        if not share <= 1.0:
            raise AssertionError(f"f16 {name} {label}: the worst element is at {share:.3f} of its limit")

    def per(ref, dims):
        return 2.0**-6 * F16_SCALED * ref.float().abs().amax(dim=dims, keepdim=True)

    # B1, delta, B2a, B2b: both routes at 150m, the ring's f32 gradients at the 1b heads
    for gi, (label, B, T, H, Hkv, D, causal) in enumerate(FLASH_GEOMS):
        if label in ("150m full", "T 64, rep 8"):
            continue
        q, k, v, do = flash_inputs(torch, dev, B, T, H, Hkv, D, f16, 330 + gi)
        ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
        delta = tfa.attention_delta_plain(do, ref_out)
        check("flash_attention_delta", label, tfa.attention_delta(do, ref_out), delta, 1e-6 * float(delta.abs().max()))
        routes = [(tfa._fwd_route(f16, D), tfa._bwd_route(f16, D))]
        if label == "150m":
            routes.append((tfa.SOURCE, tfa.SOURCE))
        for fwd_route, route in routes:
            sfx = "" if route == tfa.SOURCE else "_sm90"
            out, lse = tfa._fwd_kernel(q, k, v, causal, route=fwd_route)
            check("flash_attention_fwd" + sfx, label, out, ref_out, per(ref_out, (1, 3)))
            check("flash_attention_fwd" + sfx, label + " lse", lse, ref_lse, 1e-4 * max(1.0, float(ref_lse.abs().max())))
            for gd in ([None, torch.float32] if label == "1b heads" and sfx else [None]):
                tag = label + (" f32 grads" if gd else "")
                dq = tfa._dq_kernel(q, k, v, do, ref_lse, delta, causal, gd, route=route)
                dk, dv = tfa._dkv_kernel(q, k, v, do, ref_lse, delta, causal, gd, route=route)
                ref_dq = tfa.flash_attention_dq_plain(q, k, v, do, ref_lse, delta, causal, grad_dtype=gd)
                ref_dk, ref_dv = tfa.flash_attention_dkv_plain(q, k, v, do, ref_lse, delta, causal, grad_dtype=gd)
                if dq.dtype != (gd or f16):
                    raise AssertionError(f"f16 B2a{sfx} {tag}: dq in {dq.dtype}")
                check("flash_attention_dq" + sfx, tag, dq, ref_dq, per(ref_dq, (1, 3)))
                check("flash_attention_dkv" + sfx, tag + " dk", dk, ref_dk, per(ref_dk, (1, 3)))
                check("flash_attention_dkv" + sfx, tag + " dv", dv, ref_dv, per(ref_dv, (1, 3)))
        del q, k, v, do, ref_out, ref_lse, delta, out, lse, dq, dk, dv, ref_dq, ref_dk, ref_dv
    torch.cuda.empty_cache()

    # B3, dlog, B4a, B4b: both routes, the upstream gradient times FP16_SCALE
    for gi, (label, N, D, V) in enumerate(XENT_GEOMS):
        if label not in ("1b", "odd N and V"):
            continue
        h, w, labels, gup = xent_inputs(torch, dev, N, D, V, f16, 340 + gi)
        gup = gup * FP16_SCALE
        ref_nll, ref_lse = tfx.fused_xent_fwd_plain(h, w, labels)
        rows = slice(0, min(N, tfx.CHUNK_ROWS))
        args = (h[rows], w, labels[rows], ref_lse[rows], gup[rows])
        ref_dlog = tfx.fused_xent_dlog_plain(*args)
        ref_dh, ref_dw = tfx.fused_xent_dh_plain(ref_dlog, w), tfx.fused_xent_dw_plain(h[rows], ref_dlog)
        scale = max(1.0, float(ref_lse.abs().max()))
        for route in (tfx.SM90_SOURCE, tfx.SOURCE):
            sfx = "_sm90" if route == tfx.SM90_SOURCE else ""
            nll, lse = tfx.fused_xent_fwd(h, w, labels, route=route)
            check("fused_xent_fwd" + sfx, label + " lse", lse, ref_lse, 1e-4 * scale)
            check("fused_xent_fwd" + sfx, label + " nll", nll, ref_nll, 1e-4 * scale)
            check("fused_xent_dlog" + sfx, label, tfx.fused_xent_dlog(*args, route=route), ref_dlog,
                  2.0**-7 * F16_SCALED / 2 * float(gup.max()) / V)
            check("fused_xent_dh" + sfx, label, tfx.fused_xent_dh(ref_dlog, w, route=route), ref_dh,
                  1e-5 * F16_SCALED * float(ref_dh.float().abs().max()))
            check("fused_xent_dw" + sfx, label, tfx.fused_xent_dw(h[rows], ref_dlog, route=route), ref_dw,
                  1e-5 * float(ref_dw.abs().max()))
        del h, w, labels, gup, ref_nll, ref_lse, ref_dlog, ref_dh, ref_dw, nll, lse
    torch.cuda.empty_cache()

    # B6 and its merge at the decode shape, B6's first design at D 256
    S, T = serve_cfg.max_batch, serve_cfg.max_context
    Kh, H, D = cfg.kv_heads, cfg.num_attention_heads, cfg.head_dim
    rep = H // Kh
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lens_list = [0, 1, 255, 256, 700, 1023, 1500, 511][:S]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(33)
    splits, chunk = tdk.spec_tail_split_chunk(T, tdk.spec_tail_splits(S, T, Kh, rep, sms))
    for d in (D, 256):
        q = torch.randn(S, H, d, generator=g, device=dev).to(f16)
        k, v = (torch.randn(S, T, Kh, d, generator=g, device=dev).to(f16) for _ in range(2))
        ref = tdk.paged_decode_attention_plain(q, k, v, lens)
        if d == 256:
            check("paged_decode_attention_first", "D 256", tdk.paged_decode_attention(q, k, v, lens), ref,
                  per(ref, (1, 2)))
            continue
        for lab, kw in ((f"{splits} splits", {}), ("1 split", {"splits": 1})):
            out = tdk.paged_decode_attention(q, k, v, lens, **kw)
            if not torch.equal(out, tdk.paged_decode_attention(q, k, v, lens, **kw)):
                raise AssertionError(f"f16 B6 {lab}: a second launch gave other bits")
            check("paged_decode_attention", lab, out, ref, per(ref, (1, 2)))
        ml, acc = tdk._paged_decode_partials(q, k, v, lens, splits=splits, chunk=chunk)
        mref = tdk.spec_tail_merge_plain(ml, acc, 1, f16).reshape(S, H, D)
        check("paged_decode_attention_merge", f"{splits} splits", tdk.paged_decode_merge(ml, acc, f16), mref,
              2.0**-8 * F16_SCALED * max(1.0, float(mref.float().abs().max())))
    del q, k, v, ref, out, ml, acc, mref

    # B7 and its merge at the verify, draft and suffix shapes
    ragged = [0, 5, 255, 700, T - 2, T, 2 * T + 1, 511][:S]

    def b7_inputs(n, kq, kt, dtype, lens_list, gen):
        q = torch.randn(n, kq, H, D, generator=gen, device=dev).to(dtype)
        ring = [torch.randn(n, T, Kh, D, generator=gen, device=dev).to(dtype) for _ in range(2)]
        tail = [torch.randn(n, kt, Kh, D, generator=gen, device=dev).to(dtype) for _ in range(2)]
        return (q, *ring, *tail, torch.tensor(lens_list, dtype=torch.int32, device=dev))

    b7_shapes = {"verify": (S, 5, 5, 0, ragged), "draft q_start 3": (S, 1, 4, 3, ragged),
                 "suffix 64": (1, 64, 64, 0, [192]), "suffix 256": (1, 256, 256, 0, [192])}
    for label, (n, kq, kt, q_start, ll) in b7_shapes.items():
        args = b7_inputs(n, kq, kt, f16, ll, g)
        out = tdk.spec_tail_attention_fused(*args, q_start=q_start)
        if not torch.equal(out, tdk.spec_tail_attention_fused(*args, q_start=q_start)):
            raise AssertionError(f"f16 B7 {label}: a second launch gave other bits")
        ref = tdk.spec_tail_attention_plain(*args, q_start=q_start)
        check("spec_tail_attention", label, out, ref, per(ref, (2, 3)))
        if label == "verify":
            P, ch = tdk.spec_tail_split_chunk(T, tdk.spec_tail_splits(n, T, Kh, kq * rep, sms))
            ml, acc = tdk._spec_tail_partials(*args, q_start=q_start, splits=P, chunk=ch)
            mref = tdk.spec_tail_merge_plain(ml, acc, kq, f16)
            check("spec_tail_attention_merge", f"verify {P} splits", tdk.spec_tail_merge(ml, acc, kq, f16), mref,
                  2.0**-8 * F16_SCALED * max(1.0, float(mref.float().abs().max())))
            del ml, acc, mref
    del args, out, ref

    # B8: every config_1b weight shape at M 8, 40 and 1024, both routes
    shapes = layer_weight_shapes(cfg)
    for (K, N) in shapes:
        qs, ss = quant.pack_blockwise4_stacked(torch.randn(1, K, N, generator=g, device=dev))
        for M in B8_M:
            x = torch.randn(M, K, generator=g, device=dev).to(f16)
            ref = tdk.w4_matmul_plain(x, qs[0], ss[0], (K, N), f16)
            for route, name in ((tdk.W4_SM90_SOURCE, "w4_matmul_sm90"), (tdk.W4_FIRST_SOURCE, "w4_matmul")):
                out = tdk.w4_matmul(x, qs[0], ss[0], (K, N), f16, route=route)
                check(name, f"M{M} K{K} N{N}", out, ref, 2.0**-7 * F16_SCALED * float(ref.float().abs().max()))
    torch.cuda.synchronize()
    log(f"fp16 (a): every f16 instance within tolerance ({F16_TOL}); worst share of its limit by kernel: "
        + json.dumps({n: round(max(c["share_of_tol"] for c in r["checks"]), 4) for n, r in res.items() if r["checks"]}))

    # device times: f16 beside bf16 in turns on the sm90 routes (and B6, B7:
    # their one design at D 64), f16 alone on the first designs
    timed = {}
    B, T_, H_, Hkv, D_ = FLASH_TIMED["1b heads"]
    work = flash_work(B, T_, H_, Hkv, D_, 2, True)

    def flash_sets(dtype):
        sets, outs = [], []
        for i in range(copies_for(int(work["flash_attention_fwd"][0]))):
            q, k, v, do = flash_inputs(torch, dev, B, T_, H_, Hkv, D_, dtype, 350 + i)
            out, lse = tfa.flash_attention_fwd(q, k, v, True)
            sets.append((q, k, v, do, lse, tfa.attention_delta(do, out)))
            outs.append((do, out))
        return sets, outs

    fsets = {dt: flash_sets(dt) for dt in (bf16, f16)}
    fwd = {r: (lambda q, k, v, do, lse, dl, r=r: tfa._fwd_kernel(q, k, v, True, route=r))
           for r in (tfa.SM90_FWD_SOURCE, tfa.SOURCE)}
    dq = {r: (lambda q, k, v, do, lse, dl, r=r: tfa._dq_kernel(q, k, v, do, lse, dl, True, None, route=r))
          for r in (tfa.SM90_SOURCE, tfa.SOURCE)}
    dkv = {r: (lambda q, k, v, do, lse, dl, r=r: tfa._dkv_kernel(q, k, v, do, lse, dl, True, None, route=r))
           for r in (tfa.SM90_SOURCE, tfa.SOURCE)}
    for name, fn in (("flash_attention_fwd_sm90", fwd[tfa.SM90_FWD_SOURCE]), ("flash_attention_dq_sm90",
                     dq[tfa.SM90_SOURCE]), ("flash_attention_dkv_sm90", dkv[tfa.SM90_SOURCE])):
        timed[name] = {**in_turns(torch, (fn, fsets[bf16][0]), (fn, fsets[f16][0]), 32),
                       "work": work[name], "shape": "1b heads"}
    timed["flash_attention_delta"] = {**in_turns(torch, (tfa.attention_delta, fsets[bf16][1]),
                                                 (tfa.attention_delta, fsets[f16][1]), 32),
                                      "work": work["flash_attention_delta"], "shape": "1b heads"}
    for name, fn in (("flash_attention_fwd", fwd[tfa.SOURCE]), ("flash_attention_dq", dq[tfa.SOURCE]),
                     ("flash_attention_dkv", dkv[tfa.SOURCE])):
        timed[name] = {"f16_ms": device_ms(torch, fn, fsets[f16][0], launches=8), "work": work[name],
                       "shape": "1b heads"}
    del fsets
    torch.cuda.empty_cache()

    (XN, XD, XV), C = XENT_TIMED, min(XENT_TIMED[0], tfx.CHUNK_ROWS)

    def xent_sets(dtype):
        h, w, labels, gup = xent_inputs(torch, dev, XN, XD, XV, dtype, 360)
        gup = gup * FP16_SCALE
        _, lse = tfx.fused_xent_fwd(h, w, labels)
        dlog = tfx.fused_xent_dlog(h[:C], w, labels[:C], lse[:C], gup[:C])
        acc = torch.zeros(XD, XV, device=dev)
        return [(h, w, labels, lse, gup)], [(h[:C], w, labels[:C], lse[:C], gup[:C], dlog, acc)]

    xsets = {dt: xent_sets(dt) for dt in (bf16, f16)}
    xfns = {
        "fused_xent_fwd": (0, lambda r: lambda h, w, lb, ls, gg: tfx.fused_xent_fwd(h, w, lb, route=r)),
        "fused_xent_dlog": (1, lambda r: lambda h, w, lb, ls, gg, dl, a: tfx.fused_xent_dlog(h, w, lb, ls, gg, route=r)),
        "fused_xent_dh": (1, lambda r: lambda h, w, lb, ls, gg, dl, a: tfx.fused_xent_dh(dl, w, route=r)),
        "fused_xent_dw": (1, lambda r: lambda h, w, lb, ls, gg, dl, a: tfx.fused_xent_dw(h, dl, a, route=r)),
    }
    xwork = {n: xent_work(XN if i == 0 else C, XD, XV, 2) for n, (i, _) in xfns.items()}
    for name, (i, make) in xfns.items():
        timed[name + "_sm90"] = {**in_turns(torch, (make(tfx.SM90_SOURCE), xsets[bf16][i]),
                                            (make(tfx.SM90_SOURCE), xsets[f16][i]), 8),
                                 "work": xwork[name][name + "_sm90"], "shape": f"N {XN if i == 0 else C}, D {XD}, V {XV}"}
        timed[name] = {"f16_ms": device_ms(torch, make(tfx.SOURCE), xsets[f16][i], launches=4, replays=3),
                       "work": xwork[name][name], "shape": f"N {XN if i == 0 else C}, D {XD}, V {XV}"}
    del xsets
    torch.cuda.empty_cache()

    # B6 (its merge inside) and the merge alone at the decode shape
    live = [min(n, T - 1) + 1 for n in lens_list]

    def b6_sets(dtype, d=D_):
        q = torch.randn(S, H, d, generator=g, device=dev).to(dtype)
        sets = []
        for _ in range(copies_for(S * T * Kh * d * 2 * 2)):
            k, v = (torch.randn(S, T, Kh, d, generator=g, device=dev).to(dtype) for _ in range(2))
            sets.append((q, k, v, lens))
        return sets

    def b6_work(d):
        return sum(live) * Kh * d * 2 * 2 + 2 * S * H * d * 2 + S * 4, sum(live) * H * d * 4

    b6s = {dt: b6_sets(dt) for dt in (bf16, f16)}
    timed["paged_decode_attention"] = {
        **in_turns(torch, (tdk.paged_decode_attention, b6s[bf16]), (tdk.paged_decode_attention, b6s[f16]), 64),
        "work": b6_work(D_), "shape": f"S {S}, T {T}, Kh {Kh}, rep {rep}, D {D_}, {splits} splits, the merge included"}
    parts = {dt: [tdk._paged_decode_partials(*a, splits=splits, chunk=chunk) for a in b6s[dt]] for dt in (bf16, f16)}
    R = S * Kh * rep
    timed["paged_decode_attention_merge"] = {
        **in_turns(torch, (lambda ml, acc: tdk.paged_decode_merge(ml, acc, bf16), parts[bf16]),
                   (lambda ml, acc: tdk.paged_decode_merge(ml, acc, f16), parts[f16]), 64),
        "work": (R * splits * (D_ + 2) * 4 + R * D_ * 2, 0.0), "shape": f"{splits} splits"}
    del b6s, parts
    timed["paged_decode_attention_first"] = {
        **in_turns(torch, (tdk.paged_decode_attention, b6_sets(bf16, 256)),
                   (tdk.paged_decode_attention, b6_sets(f16, 256)), 64),
        "work": b6_work(256), "shape": f"S {S}, T {T}, Kh {Kh}, rep {rep}, D 256 (the first design)"}

    # B7 (its merge inside) at verify and draft, the merge alone at verify
    for label in ("verify", "draft q_start 3"):
        n, kq, kt, q_start, ll = b7_shapes[label]
        sets = {dt: [b7_inputs(n, kq, kt, dt, ll, g) for _ in range(copies_for(n * T * Kh * D_ * 2 * 2))]
                for dt in (bf16, f16)}
        fn = lambda *a, q_start=q_start: tdk.spec_tail_attention_fused(*a, q_start=q_start)
        key = "spec_tail_attention" if label == "verify" else "spec_tail_attention " + label
        timed[key] = {**in_turns(torch, (fn, sets[bf16]), (fn, sets[f16]), 64),
                      "work": b7_work(n, T, Kh, rep, D_, kq, kt, q_start, ll, 2), "shape": label + ", the merge included"}
        if label == "verify":
            P, ch = tdk.spec_tail_split_chunk(T, tdk.spec_tail_splits(n, T, Kh, kq * rep, sms))
            parts = {dt: [tdk._spec_tail_partials(*a, q_start=q_start, splits=P, chunk=ch) for a in sets[dt]]
                     for dt in (bf16, f16)}
            Rv = n * Kh * kq * rep
            timed["spec_tail_attention_merge"] = {
                **in_turns(torch, (lambda ml, acc: tdk.spec_tail_merge(ml, acc, kq, bf16), parts[bf16]),
                           (lambda ml, acc: tdk.spec_tail_merge(ml, acc, kq, f16), parts[f16]), 64),
                "work": (Rv * P * (D_ + 2) * 4 + Rv * D_ * 2, 0.0), "shape": f"verify, {P} splits"}
            del parts
        del sets

    # B8: one 1b layer's seven matmuls at M 8 (decode), both routes
    per_layer = {"w4_matmul_sm90": {"bf16_ms": 0.0, "f16_ms": 0.0, "runs": []}, "w4_matmul": {"f16_ms": 0.0}}
    nbytes = 0.0
    for (K, N_), count in shapes.items():
        w = []
        for _ in range(copies_for(K * N_ // 2)):
            qs, ss = quant.pack_blockwise4_stacked(torch.randn(1, K, N_, generator=g, device=dev))
            w.append((qs[0], ss[0]))
        x = torch.randn(8, K, generator=g, device=dev)
        sets = {dt: [(x.to(dt), qc, sc, (K, N_), dt) for qc, sc in w] for dt in (bf16, f16)}
        on = lambda route: (lambda *a: tdk.w4_matmul(*a, route=route))
        t = in_turns(torch, (on(tdk.W4_SM90_SOURCE), sets[bf16]), (on(tdk.W4_SM90_SOURCE), sets[f16]),
                     max(64, min(len(w), 256)))
        per_layer["w4_matmul_sm90"]["bf16_ms"] += count * t["bf16_ms"]
        per_layer["w4_matmul_sm90"]["f16_ms"] += count * t["f16_ms"]
        per_layer["w4_matmul_sm90"]["runs"].append({"K": K, "N": N_, "per_layer": count, **t})
        per_layer["w4_matmul"]["f16_ms"] += count * device_ms(torch, on(tdk.W4_FIRST_SOURCE), sets[f16],
                                                              launches=max(64, min(len(w), 256)))
        nbytes += count * (K * N_ // 2 + math.ceil(K * N_ / quant.W4_BLOCK) * 2 + 8 * K * 2 + 8 * N_ * 2)
        del w, sets
    b8_flops = sum(2.0 * 8 * K * N_ * c for (K, N_), c in shapes.items())
    for name in ("w4_matmul_sm90", "w4_matmul"):
        pl = per_layer[name]
        if "bf16_ms" in pl:
            pl["f16_over_bf16"] = pl["f16_ms"] / pl["bf16_ms"]
        timed[name] = {**pl, "work": (nbytes, b8_flops), "shape": "one 1b layer's 7 matmuls at M 8"}
    torch.cuda.empty_cache()

    for name, t in timed.items():
        b_ms, b_by = bound_ms(*t.pop("work"))
        row = res.setdefault(name.split(" ")[0], {"checks": []})
        entry = {**t, "bound_ms": b_ms, "bound_by": b_by}
        if " " in name:
            row.setdefault("also", {})[name.split(" ", 1)[1]] = entry
        else:
            row.update(entry)
            row["ms"] = t["f16_ms"]
        log(f"fp16 (a) {name} ({t['shape']}): f16 {t['f16_ms']:.4f} ms"
            + (f", bf16 {t['bf16_ms']:.4f} ms in turns (f16/bf16 {t['f16_over_bf16']:.3f})" if "bf16_ms" in t else "")
            + f", bound {b_ms:.5f} ms ({b_by})")
    for name, row in res.items():
        if row["checks"]:
            worst = max(row["checks"], key=lambda c: c["share_of_tol"])
            row.update(max_abs_err=max(c["max_abs_err"] for c in row["checks"]), share_of_tol=worst["share_of_tol"],
                       worst_check=worst)
        row["tol"] = F16_TOL
    return res


def fp16_overflow_step(torch, tr, params, batch) -> dict:
    """One step from ``params`` at FP16_OVERFLOW_SCALE: it must find inf,
    leave params and both moments bit for bit, and halve the scale."""
    from opendiloco_torch.models.llama import flatten_params

    state = tr.init_state(params=params)
    before = [t.detach().clone() for t in (*flatten_params(state["params"]), *state["opt_state"]["mu"],
                                           *state["opt_state"]["nu"])]
    state, m = tr.train_step(state, batch)
    after = [*flatten_params(state["params"]), *state["opt_state"]["mu"], *state["opt_state"]["nu"]]
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    res = {"found_inf": float(m["found_inf"]), "loss_scale": float(m["loss_scale"]),
           "next_scale": state["scaler"]["scale"], "params_and_moments_bit_for_bit": same,
           "adam_count": int(state["opt_state"]["count"]), "grad_norm": float(m["grad_norm"])}
    if not (res["found_inf"] == 1.0 and same and res["next_scale"] == FP16_OVERFLOW_SCALE / 2
            and res["adam_count"] == 0):
        raise AssertionError(f"fp16 overflow step: {res}")
    return res


def phase_fp16_train(torch, tfa, dev, card: str) -> dict:
    """Phase 33 (b): config_1b's widths at REMAT_LAYERS of its layers, mb 8
    x accum 2 x seq 1024, ``precision="fp16-mixed"``, remat True, numpy
    params: the flash kernels with the fused loss against attn "xla" with
    the unfused loss, 1 warm-up and FP16_TIMED_STEPS timed steps each on
    the same batches: loss, ``found_inf``, ``loss_scale``, grad norm and
    ms by step; launches per step (B1 4 L, delta/B2a/B2b 2 L, B3 2,
    dlog/B4a/B4b 8) on the kernels path, none on the other; the first
    step's loss within 1e-3 and grad norm within 0.5% across the paths
    (phase 10's bf16 rule), the scaler's decisions equal. Then, on each
    path, one step with cuBLAS's ``allow_fp16_reduced_precision_reduction``
    flipped (its value is recorded; the port never sets it), and one
    overflow step on each path (:func:`fp16_overflow_step`). Last the
    kernels path at bf16-mixed on the same params and batches, for the
    step ms of the two precisions in one call."""
    import dataclasses
    import tempfile

    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.models.llama import shapes
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg = load_config(cut_depth("1b", REMAT_LAYERS, tempfile.mkdtemp()))
    L, run = cfg.num_hidden_layers, REMAT_RUN
    accum = run["total_batch_size"] // run["per_device_train_batch_size"]
    chunks = -(-run["per_device_train_batch_size"] * (run["seq_length"] - 1) // 2048)
    params = np_params(shapes(cfg), np.random.default_rng(33))
    ds = iter(FakeTokenizedDataset(run["seq_length"], cfg.vocab_size, seed=33, mode="ramp"))
    ids = [np.stack([next(ds)["input_ids"] for _ in range(run["total_batch_size"])])
           for _ in range(FP16_TIMED_STEPS + 1)]
    flag = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
    paths = {"kernels": dict(attn_impl="pallas", fused_loss=True), "xla": dict(attn_impl="xla", fused_loss=False),
             "kernels bf16": dict(attn_impl="pallas", fused_loss=True, precision="bf16-mixed")}
    per_step = {"flash_attention_fwd_sm90": 2 * L * accum, "flash_attention_delta": L * accum,
                "flash_attention_dq_sm90": L * accum, "flash_attention_dkv_sm90": L * accum,
                "fused_xent_fwd_sm90": accum, "fused_xent_dlog_sm90": accum * chunks,
                "fused_xent_dh_sm90": accum * chunks, "fused_xent_dw_sm90": accum * chunks}
    res = {"layers": L, "accum": accum, "init_loss_scale": FP16_SCALE,
           "allow_fp16_reduced_precision_reduction": flag, "paths": {}}
    for label, kw in paths.items():
        tc = TrainerConfig(**{"precision": "fp16-mixed", **kw}, remat=True, warmup_steps=1, total_steps=100, lr=1e-3)
        tr = InnerTrainer(cfg, tc, device=dev)
        state = tr.init_state(params=params)
        batches = [tr.shard_batch(x, x.copy(), accum=accum) for x in ids]
        steps = []
        tfa.LAUNCHES.reset()
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = tr.train_step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            # bf16-mixed has no scaler: its rows read as clean steps at FP16_SCALE
            steps.append({"loss": loss, "found_inf": float(m.get("found_inf", 0.0)),
                          "loss_scale": float(m.get("loss_scale", FP16_SCALE)), "grad_norm": float(m["grad_norm"]),
                          "ms": (time.perf_counter() - t0) * 1e3})
        launches = tfa.LAUNCHES.snapshot()
        # the xla path launches nothing (check_launches holds every other count at 0)
        want = {n: c * len(batches) for n, c in per_step.items()} if label != "xla" else {}
        check_launches(launches, want, f"fp16 1b ({L} layers) {label} ({len(batches)} steps)")
        losses = [s["loss"] for s in steps]
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                and all(s["found_inf"] == 0.0 and s["loss_scale"] == FP16_SCALE for s in steps)):
            raise AssertionError(f"fp16 1b {label}: {steps}")
        if label == "kernels bf16":
            res["paths"][label] = {"steps": steps, "launches": launches, "timed_step_ms": [s["ms"] for s in steps[1:]]}
            log(f"fp16 (b) 1b ({L} layers) the kernels path at bf16-mixed: step ms {[s['ms'] for s in steps]}, "
                f"losses {losses} | {card}")
            del tr, state, batches
            continue
        # the flag flipped for one step from the same params and first batch
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = not flag
        try:
            st, m = tr.train_step(tr.init_state(params=params), batches[0])
            flipped = {"loss": float(m["loss"]), "found_inf": float(m["found_inf"]),
                       "grad_norm": float(m["grad_norm"])}
        finally:
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = flag
        del st
        over = dataclasses.replace(tc, init_loss_scale=FP16_OVERFLOW_SCALE)
        overflow = fp16_overflow_step(torch, InnerTrainer(cfg, over, device=dev), params, batches[0])
        res["paths"][label] = {"steps": steps, "launches": launches,
                               "launches_per_step": {n: c / len(batches) for n, c in launches.items() if c},
                               "timed_step_ms": [s["ms"] for s in steps[1:]],
                               "flag_flipped_first_step": flipped, "overflow_step": overflow}
        log(f"fp16 (b) 1b ({L} layers) {label}: " + "; ".join(
            f"step {i}: loss {s['loss']:.6f}, found_inf {s['found_inf']:.0f}, scale {s['loss_scale']:.0f}, grad norm "
            f"{s['grad_norm']:.4f}, {s['ms']:.1f} ms" for i, s in enumerate(steps))
            + f" | launches {res['paths'][label]['launches_per_step']} a step | allow_fp16_reduced_precision_reduction"
            f" {flag}, flipped: {flipped} | overflow step {overflow} | {card}")
        del tr, state, batches
        torch.cuda.empty_cache()
    k, x = res["paths"]["kernels"]["steps"], res["paths"]["xla"]["steps"]
    if not (abs(k[0]["loss"] - x[0]["loss"]) <= 1e-3 and abs(k[0]["grad_norm"] - x[0]["grad_norm"])
            <= 5e-3 * x[0]["grad_norm"]):
        raise AssertionError(f"fp16 1b: the kernels path's first step {k[0]} against xla's {x[0]}")
    decisions = {lab: [s["found_inf"] for s in p["steps"]] + [p["flag_flipped_first_step"]["found_inf"],
                                                                 p["overflow_step"]["found_inf"]]
                 for lab, p in res["paths"].items() if lab != "kernels bf16"}
    if decisions["kernels"] != decisions["xla"]:
        raise AssertionError(f"fp16 1b: the scaler decided otherwise on the two paths: {decisions}")
    res["scaler_decisions"] = decisions
    log(f"fp16 (b): the scaler's decisions on both paths {decisions['kernels']} (timed steps, flag flipped, overflow)")
    return res


def phase_fp16_train_serve(torch, tdk, dev, card: str) -> dict:
    """Phase 33 (c): ``train()`` at ``precision="fp16-mixed"``, two loopback
    workers at config_150m's widths and CUT_LAYERS of its layers
    (FP16_SERVE_RUN), each serving w4 over HTTP on its own port (worker 0
    with ``spec_decode_k`` 4, worker 1 with plain decode; FP16_SERVE), a
    client thread a plane posting /generate until training ends. The first
    round waits for an answer from each plane and the last for an answer
    of a later weight epoch from each (so both swap while the run lasts).
    Every response succeeds or fails with "server stopped"; launches: the
    training kernels by :func:`training_launches`, B6 and its merge L a
    decode step of worker 1, B7 and its merge k Ld + L a spec round of
    worker 0, the sm90 B8 7 L a prefill and decode step and 7 (k Ld + L)
    a spec round, all in f16 (the engines' compute dtype is the
    trainer's)."""
    import os
    import shutil
    import tempfile

    from opendiloco_torch import serve as tserve
    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.ops.flash_attention import LAUNCHES
    from opendiloco_torch.train import train

    model = cut_depth("150m", CUT_LAYERS, tempfile.mkdtemp())
    cfg = load_config(model)
    L, run = cfg.num_hidden_layers, FP16_SERVE_RUN
    rounds = run["total_steps"] // run["local_steps"]
    serves = [{**FP16_SERVE, "spec_decode_k": SPEC_K}, FP16_SERVE]
    backends = recording_backends(LoopbackWorld(2))
    tmp = tempfile.mkdtemp()
    planes, admits, real_build = {}, {}, tserve.build_serving
    done, errors = threading.Event(), []
    responses = {0: [], 1: []}
    cond = threading.Condition()

    def capture(serve_cfg, *args, **kwargs):
        plane = real_build(serve_cfg, *args, **kwargs)
        rank = 0 if serve_cfg.spec_decode_k else 1
        admit, admits[rank] = plane.engine.admit, 0
        if plane.engine.compute_dtype != torch.float16:
            raise AssertionError(f"fp16 train+serve: the engine computes in {plane.engine.compute_dtype}")

        def counted(*a, **k):  # one prefill an admit
            admits[rank] += 1
            return admit(*a, **k)

        plane.engine.admit = counted
        with cond:
            planes[rank] = plane
            cond.notify_all()
        return plane

    def wait_for(pred, what: str) -> None:
        with cond:
            if not cond.wait_for(lambda: pred() or errors, timeout=300) or errors:
                raise AssertionError(f"fp16 train+serve: waited for {what}: {errors[:1]}")

    def gate(backend):
        """The backend's round ``epoch`` (0 the first) waits for the
        serving planes first: the first for an answer from each, the last
        for an answer of epoch 1 or later from each."""
        reduce = backend.all_reduce

        def all_reduce(arrays, *, epoch=None, **kw):
            if epoch == 0:
                wait_for(lambda: all(responses[r] for r in (0, 1)), "a first answer from each plane")
            elif epoch == rounds - 1:
                wait_for(lambda: all(any(x.get("epoch", 0) >= 1 for x in responses[r]) for r in (0, 1)),
                         "an answer of a later epoch from each plane")
            return reduce(arrays, epoch=epoch, **kw)

        backend.all_reduce = all_reduce

    for b in backends:
        gate(b)

    def client(rank):
        try:
            wait_for(lambda: rank in planes, f"plane {rank}")
            port, rng = planes[rank].port, np.random.default_rng(330 + rank)
            while not done.is_set():
                n = int(rng.integers(33, 65))
                body = json.dumps({"prompt": rng.integers(1, cfg.vocab_size, n).tolist(),
                                   "max_new_tokens": FP16_SERVE_NEW_TOKENS}).encode()
                try:
                    out = http_json(f"http://127.0.0.1:{port}/generate", body)
                except OSError:  # refused or reset: the run has ended
                    if done.is_set() or planes[rank].server._stop.is_set():
                        return
                    raise
                with cond:
                    responses[rank].append(out)
                    cond.notify_all()
        except BaseException as e:
            with cond:
                errors.append(e)
                cond.notify_all()

    def config(rank):
        return train_config(model, run, rank, os.path.join(tmp, f"metrics-{rank}.pkl"),
                            dict(path=os.path.join(tmp, "ckpts"), interval=None), serve=serves[rank],
                            precision="fp16-mixed")

    threads = [threading.Thread(target=client, args=(r,)) for r in (0, 1)]
    old_codec = os.environ.get("ODTP_STATE_CODEC")
    os.environ["ODTP_STATE_CODEC"] = TRAIN_SERVE_CODEC
    tserve.build_serving = capture
    tdk.LAUNCHES.reset()
    try:
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        run_workers(train, [(config(r), backends[r], dev) for r in range(2)])
        wall = time.perf_counter() - t0
    finally:
        done.set()
        tserve.build_serving = real_build
        if old_codec is None:
            os.environ.pop("ODTP_STATE_CODEC")
        else:
            os.environ["ODTP_STATE_CODEC"] = old_codec
        for t in threads:
            t.join(timeout=120)
    launches = LAUNCHES.snapshot()
    if errors:
        raise errors[0]
    res = {"config": "150m", "layers": L, **run, "serve": serves, "codec": TRAIN_SERVE_CODEC,
           "precision": "fp16-mixed", "train_wall_s": wall, "launches": launches, "planes": {}}
    want = training_launches(torch, dev, cfg, run, 2 * run["total_steps"],
                             [n for n in launches if n.startswith(("flash_attention", "fused_xent"))])
    want.update({"paged_decode_attention": 0, "paged_decode_attention_merge": 0, "spec_tail_attention": 0,
                 "spec_tail_attention_merge": 0, "w4_matmul_sm90": 0})
    from opendiloco_torch.config import ServeConfig

    sc = ServeConfig(**FP16_SERVE)
    S, T, Kh, rep = sc.max_batch, sc.max_context, cfg.kv_heads, cfg.num_attention_heads // cfg.kv_heads
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rank, plane in sorted(planes.items()):
        engine, st = plane.engine, plane.batcher.stats()
        ok = [r for r in responses[rank] if "error" not in r]
        failed = [r for r in responses[rank] if "error" in r]
        if any(r["error"] != "server stopped" for r in failed) or not ok or engine.swap_count < 1:
            raise AssertionError(f"fp16 train+serve plane {rank}: {len(ok)} answers, errors "
                                 f"{[r['error'] for r in failed][:3]}, {engine.swap_count} swaps")
        epochs = sorted({r["epoch"] for r in ok})
        steps, prefills = st["decode_steps"], admits[rank]
        if rank == 0:
            k, Ld = engine.spec_k, engine.draft_layers
            per_round = k * Ld + L
            # a round's k Ld draft passes (one query a slot) and L verify passes (k + 1), each merging
            # where its pass cuts the ring into splits
            splits = {kq: tdk.spec_tail_split_chunk(T, tdk.spec_tail_splits(S, T, Kh, kq * rep, sms))[0]
                      for kq in (1, k + 1)}
            want["spec_tail_attention"] += per_round * steps
            want["spec_tail_attention_merge"] += (k * Ld * (splits[1] > 1) + L * (splits[k + 1] > 1)) * steps
            want["w4_matmul_sm90"] += 7 * (L * prefills + per_round * steps)
        else:
            splits, _ = tdk._decode_grid(S, T, Kh, rep, dev.index or 0, None)
            want["paged_decode_attention"] += L * steps
            want["paged_decode_attention_merge"] += L * steps if splits > 1 else 0
            want["w4_matmul_sm90"] += 7 * L * (prefills + steps)
        res["planes"][rank] = {"spec_decode_k": engine.spec_k, "answers": len(ok), "server_stopped": len(failed),
                               "epochs": epochs, "weight_swaps": engine.swap_count, "decode_steps": steps,
                               "prefills": prefills, "splits": splits,
                               "served_tokens": sum(len(r["tokens"]) for r in ok),
                               "swaps": [{k_: sw[k_] for k_ in ("epoch", "codec", "total_s")} for sw in engine.swap_log]}
    check_launches(launches, want, "fp16 train+serve")
    log(f"fp16 (c) train+serve 150m ({L} layers): {json.dumps(res['planes'])}; launches {launches}; train "
        f"{wall:.1f} s | {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke runs on a CUDA card",
              file=sys.stderr)
        return 2
    from opendiloco_torch import quant
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.models.llama import init_params
    from opendiloco_torch.ops import build
    from opendiloco_torch.ops import decode_kernels as tdk
    from opendiloco_torch.ops import flash_attention as tfa
    from opendiloco_torch.ops import fused_xent as tfx

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    build_s = build.build(["paged_decode_attention", "spec_tail_attention", "w4_matmul", "w4_matmul_sm90",
                           "flash_attention",
                           "flash_attention_fwd_sm90", "flash_attention_bwd_sm90", "flash_attention_delta",
                           "fused_xent", "fused_xent_sm90"])
    log(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"kernel build {build_s:.2f} s | TF32 off for matmuls and cuDNN")

    cfg = load_config("1b")
    serve_cfg = ServeConfig()
    b6 = timed("2 b6", phase_b6, torch, tdk, cfg, serve_cfg, dev)  # B6 and its merge
    b8 = timed("3 b8", phase_b8, torch, tdk, quant, cfg, dev)

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    serve = [timed("4 serve fp32", phase_serve, torch, tdk, cfg, serve_cfg, params, dev)]
    serve.append(timed("5 serve w4", phase_serve, torch, tdk, cfg, ServeConfig(weight_format="w4"), params, dev))
    b7 = timed("11 b7", phase_b7, torch, tdk, cfg, serve_cfg, dev)  # B7 and its merge kernel
    spec = [timed(f"12 spec {s['weight_format']}", phase_spec, torch, tdk, cfg,
                  ServeConfig(spec_decode_k=SPEC_K, weight_format=s["weight_format"]), params, dev, s) for s in serve]
    prefix = timed("13 prefix", phase_prefix, torch, tdk, cfg, params, dev)
    spec_f32 = timed("15 spec f32", phase_spec_f32, torch, cfg, params, dev)
    wire = timed("20 install_wire", phase_install_wire, torch, tdk, cfg, params, dev, card, serve)
    tier = timed("22 kv tier", phase_tier, torch, tdk, cfg, params, dev)
    obs_serve = timed("30a obs serve", phase_obs_serve, torch, tdk, cfg, params, dev, card)
    decode_kernel = timed("32d decode_kernel", phase_decode_kernel, torch, tdk, cfg, params, dev, card)
    del params
    fp16 = {"kernels": timed("33a fp16 kernels", fp16_kernels, torch, tdk, tfa, tfx, quant, cfg, serve_cfg, dev)}
    torch.cuda.empty_cache()
    for s in serve:
        s.pop("tokens")
    reference = timed("6 reference", phase_reference, torch, load_config("2m"), dev)
    reference += timed("14 spec reference", phase_spec_reference, torch, load_config("2m"), dev)
    torch.cuda.empty_cache()

    flash = timed("7 flash", phase_flash, torch, tfa, dev)
    train_150m = timed("8 train 150m", phase_train, torch, tfa, dev, card, "150m", TRAIN_150M,
                       {"kernels": dict(attn_impl="pallas"), "plain": dict(attn_impl="xla")})
    resume_150m = timed("8b resume", phase_resume, torch, tfa, dev, card, train_150m)
    train_serve = timed("19 train+serve", phase_train_serve, torch, tdk, dev, card, train_150m)
    train_f32 = timed("8 f32 step", phase_train_f32, torch, tfa, dev, card)
    xent = timed("9 xent", phase_xent, torch, tfx, dev)
    import tempfile

    # config_1b's widths at TRAIN_1B_LAYERS of its 22 layers (the smoke's
    # time limit): more than 16 layers, so the stack stays looped
    # and the fused loss resolves on, as at full depth
    model_1b = cut_depth("1b", TRAIN_1B_LAYERS, tempfile.mkdtemp())
    train_1b = timed("10 train 1b", phase_train, torch, tfa, dev, card, model_1b, TRAIN_1B,
                     {"fused": {}, "unfused": dict(fused_loss=False)}, keep_master=True)
    tcp = timed("24 tcp", phase_tcp, torch, tfa, dev, card, train_1b)
    train_1b_device = timed("10 device placement", phase_train_device, torch, tfa, dev, card, model_1b, TRAIN_1B,
                            train_1b)
    weights_dir = timed("16 weights dir", phase_weights_dir, torch, dev, card)
    gate3 = timed("17 gate3", phase_gate3, torch, tfa, dev, card)
    cli = timed("18 cli", phase_cli, card)
    outer_plane = timed("21 outer plane", phase_outer_plane, torch, tfa, dev, card)
    sharded = timed("23 sharded", phase_sharded, torch, tfa, dev, card)
    gossip = timed("25 gossip", phase_gossip, torch, tfa, dev, card, train_150m)
    fleet = timed("26 fleet", phase_fleet, torch, tdk, dev, card)
    moe = timed("27 moe 150m_8e", phase_moe, torch, tfa, dev, card)
    ring = timed("28 ring", phase_ring, torch, tfa, dev, card)
    tp_pp = timed("29 tp pp 1b", phase_tp_pp, torch, tfa, dev, card)
    obs_train = timed("30b obs train", phase_obs_train, torch, tfa, dev, card)
    obs_galaxy = timed("31 obs galaxy", phase_obs_galaxy, torch, tfa, tdk, dev, card)
    remat = timed("32a remat 1b", phase_remat, torch, tfa, dev, card)
    driver = timed("32b train_diloco", phase_driver, torch, tfa, dev, card)
    prefetch = timed("32c prefetch", phase_prefetch, torch, tfa, dev, card)
    fp16["train"] = timed("33b fp16 train 1b", phase_fp16_train, torch, tfa, dev, card)
    fp16["train_serve"] = timed("33c fp16 train+serve", phase_fp16_train_serve, torch, tdk, dev, card)

    # launches: each serving phase's main path, by phase
    serving = {f"serve {s['weight_format']}": s["launches"] for s in serve}
    serving.update({f"spec serve {s['weight_format']}": s["launches"] for s in spec})
    serving.update({f"prefix serve, prefix_cache={on}": prefix[key]["launches"]
                    for key, on in (("on", True), ("off", False))})
    serving.update({f"f32 serve {key}": spec_f32["launches"][key] for key in ("plain", "spec")})
    serving["train+serve 150m"] = train_serve["launches"]
    serving.update({f"install_wire 1b ({key})": counts for key, counts in wire["launches"].items()})
    serving.update({f"kv tier 1b ({key})": tier[key]["launches"] for key in ("a", "b", "c", "d")})
    serving["fleet 150m (2 layers), replicas in process"] = fleet["runs"][0]["launches"]
    serving.update({f"obs 1b w4 turn {t} ({turn['mode']})": turn["launches"]
                    for t, turn in enumerate(obs_serve["turns"])})
    serving.update({f"obs fleet 150m (2 layers) turn {mode}": turn["launches"]
                    for mode, turn in obs_galaxy["fleet"].items()})
    serving.update({f"decode_kernel 1b w4 f32 {k}": r["launches"] for k, r in decode_kernel.items()})
    serving[f"phase 33 (c) train+serve 150m ({CUT_LAYERS} layers) fp16"] = fp16["train_serve"]["launches"]
    for k in (*b6, *b7, *b8):
        k["launches_by_phase"] = {phase: counts.get(k["name"], 0) for phase, counts in serving.items()}
        k["launches"] = sum(k["launches_by_phase"].values())
    # launches: the training paths, by phase (the first design runs on the
    # f32 step; bf16 training takes the sm90 kernels; delta runs on both)
    for k in (*flash, *xent):
        k["launches_by_phase"] = {"train 150m": train_150m["launches"][k["name"]],
                                  "resume 150m": resume_150m["launches"][k["name"]],
                                  "train+serve 150m": train_serve["launches"][k["name"]],
                                  "train 150m fp32 step": train_f32["launches"][k["name"]],
                                  "train 1b": train_1b["launches"][k["name"]],
                                  "train 1b device placement": train_1b_device["launches"][k["name"]],
                                  "tcp 1b": tcp["1b"]["launches"][k["name"]],
                                  "tcp 150m uniform8bit": tcp["150m uniform8bit"]["launches"][k["name"]],
                                  "outer plane 150m (2 layers)": sum(r[pl]["launches"][k["name"]]
                                                          for r in outer_plane.values() for pl in ("host", "device")),
                                  "sharded 150m (2 layers)": sharded["launches"].get(k["name"], 0),
                                  "gossip 150m (2 layers) host": gossip["launches"][k["name"]],
                                  "gossip 150m (2 layers) device": gossip["launches"][k["name"]],
                                  **{f"fleet 150m (2 layers) training (replicas {'in process' if r['inprocess'] else 'apart'})":
                                     r["train_launches"].get(k["name"], 0) for r in fleet["runs"]},
                                  "moe 150m_8e": moe["launches"].get(k["name"], 0),
                                  **{f"ring {label} (4 ranks, T 4096)": g["launches"].get(k["name"], 0)
                                     for label, g in ring["geoms"].items()},
                                  "ring train 150m (2 layers) sp 1": ring["train_sp1"]["launches"].get(k["name"], 0),
                                  **{f"tp/pp 1b {label}": sum(t.get(k["name"], 0) for t in r["launches_by_thread"])
                                     for label, r in tp_pp["runs"].items()},
                                  "obs 150m (2 layers) armed": obs_train["launches"].get(k["name"], 0),
                                  "obs tcp 150m (2 layers) armed": obs_galaxy["launches"].get(k["name"], 0),
                                  **{f"remat 1b ({REMAT_LAYERS} layers) {policy}": r["launches"].get(k["name"], 0)
                                     for policy, r in remat["policies"].items()},
                                  **{f"train_diloco 150m (2 layers) {pl}": r["launches"].get(k["name"], 0)
                                     for pl, r in driver.items()},
                                  **{f"prefetch 150m (2 layers) depth {d}": r["launches"].get(k["name"], 0)
                                     for d, r in prefetch.items()},
                                  **{f"phase 33 (b) 1b ({REMAT_LAYERS} layers) {p}{'' if 'bf16' in p else ' fp16'}":
                                     r["launches"].get(k["name"], 0) for p, r in fp16["train"]["paths"].items()},
                                  f"phase 33 (c) train+serve 150m ({CUT_LAYERS} layers) fp16":
                                      fp16["train_serve"]["launches"].get(k["name"], 0)}
        k["launches"] = sum(k["launches_by_phase"].values())
        k["launches_per_inner_step_1b"] = train_1b["launches_per_inner_step"][k["name"]]
        k["launches_per_inner_step_150m_8e"] = moe["launches_per_inner_step"].get(k["name"], 0)
    # each kernel's f16 instance: its checks, times beside bf16 and bound (phase 33 (a))
    for k in (*b6, *b7, *b8, *flash, *xent):
        k["f16"] = fp16["kernels"].get(k["name"], {"checks": [], "ms": None, "note": "not measured"})
    b6[0]["f16"]["first_design"] = fp16["kernels"]["paged_decode_attention_first"]
    log(json.dumps({"serve": serve, "spec": spec, "spec_f32": spec_f32, "prefix": prefix, "reference": reference,
                    "train": [train_150m, train_1b, train_f32], "train_1b_device": train_1b_device,
                    "outer_plane": outer_plane, "sharded": sharded, "tcp": tcp, "gossip": gossip, "fleet": fleet, "resume": resume_150m, "weights_dir": weights_dir,
                    "train_serve": train_serve, "install_wire": wire, "kv_tier": tier,
                    "gate3": gate3, "cli": cli, "moe": moe, "ring": ring, "tp_pp": tp_pp,
                    "obs": {"serve": obs_serve, "train": obs_train, "galaxy": obs_galaxy},
                    "slice21": {"remat": remat, "train_diloco": driver, "prefetch": prefetch,
                                "decode_kernel": decode_kernel},
                    "fp16": {"train": fp16["train"], "train_serve": fp16["train_serve"]},
                    "phase_seconds": PHASE_SECONDS,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": [*b6, *b7, *b8, *flash, *xent]}))
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})}; smoke "
        f"{time.perf_counter() - t_start:.1f} s | {card}")
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
