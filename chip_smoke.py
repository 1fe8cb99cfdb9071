#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. Build: compiles ``src/repro_torch/kernels/csrc/qinf.cu`` (kernels B1
   quantize, B2 dequantize) and ``qinf_wire.cu`` (B3 quantize+pack, B4
   unpack+dequantize+mix) with nvcc for sm_90a, one compiler per source,
   both started together, and prints each kernel's registers, spills and
   resident warps per SM from ``ptxas -v``; B3's row kernel and its seven
   vector instances (nibble packing K = 1, 2, 4 units a lane, byte packing
   K = 1, 2, 4, 8) must all be there, and none may spill.  Then one
   unmeasured ``torch.profiler`` window over a few launches
   (``warm_profiler``): a process's first window once saw no device
   operation, so every window whose events are required comes after it.
3. B1/B2 against their plain PyTorch versions on the card, same x and u:
   B1 through ``ops.qinf_quantize_lastdim``, which hands it the leaf
   unpadded (the kernel reads the ragged last block in place), against
   the plain version on the zero-padded rows, and B2 on its codes; bits
   {1,2,3,4,7,8} (at 8 the code +128 saturates to +127, as in the
   reference), x in f32, bf16 and f64, on the leaves of B1_CASES: the
   main path's (8 nodes x 7840 -> 8 x 31 blocks of 256), block 128, ragged
   last dims (129,) and (3, 7, 11), a block of zeros, a last block of
   zeros before the pad, rows cut from wider ones, rows off the 16-byte
   alignment (5, 129), a view one element into its buffer, a block of 2048
   (wider than the vector variant holds) and (8, 12_582_912) (8 nodes x one
   2048x6144 matrix, ~400 MB per f32 operand); each leaf must take the B1
   variant it names.  B2's vector and row variants at widths 256, 128, 100
   and 3 and on a view off the 16-byte alignment.  Codes, scales and
   dequantized values must be exactly equal.  Each kernel, its plain
   version and, where one exists, the single PyTorch call computing the
   same function are timed with CUDA events on (R, 256) rows at the main
   path's shape (MAIN_SHAPE_ITERS calls) and at the large shape; B1 also
   as the main path calls it, on the (8, 7840) leaf, and device time a
   call from ``torch.profiler`` (median of MAIN_SHAPE_ITERS calls) of
   that call, of B1 on (248, 256) rows and of ``zero_`` on 248 floats
   (the launch floor).
4. The dense main path: ``repro_torch.api.build(spec)`` on the card for the
   quickstart spec at MNIST scale (8 nodes x 7500 samples, 784 features,
   10 classes, f32).  First 20 steps, each started from the card's state
   and held against one step of the port's plain CPU path with the same
   draws from a seeded CPU generator: X must agree to 1e-4 x max|X| on all
   but 0.1 % of its elements (an element may differ where a stochastic-
   rounding code sits on an f32 rounding boundary; the products sum in
   another order on the card).  Then a run of STEPS steps with the launch
   counters zeroed just before and read just after (B1 and B2 must each
   launch once per step), an objective f + lam ||x||_1 that must fall, a
   consensus error that must shrink, finite values.  A ``torch.profiler``
   window of PROFILE_STEPS steps lists every device operation of a step
   by name; B1 must run once a step with no pad kernel (fill, copy) just
   before it.
4b. The netsim engine on the same spec and data (``engine='netsim'``).
   (a) Static schedule, no faults: NETSIM_STATIC_STEPS steps equal the
   dense engine's bit for bit (X, D, H, Hw) from the same draws.  (b) The
   scenario: ``markov_drop`` on the ring (drop 0.2, sticky 0.5, 32
   rounds) with the faults of SCENARIO_FAULTS, NETSIM_STEPS steps with the
   launch counters zeroed just before and read just after: B1 and B2 must
   each launch once a step; the objective must fall and the consensus
   shrink; the trajectory's bits must equal, as integers, a host recount
   from the masks the mixer recorded.  (c) Card against CPU:
   REPLAY_STEPS steps, each started from the card's state, the card's
   algorithm and fault draws recorded and replayed on the CPU, at phase
   4's tolerance.  (d) ms a step of the dense engine, the static netsim
   run and the scenario run (host clock fenced by synchronisation,
   NETSIM_TIMED_STEPS steps each, one process), and a ``torch.profiler``
   window of NETSIM_PROFILE_STEPS scenario steps (device busy share).
5. B3/B4 against their plain versions on the card: bits {1,2,3,4,7},
   blocks 128 and 256, S (senders) in {1, 3, 4}, T (rounds) in
   WIRE_ROUNDS (1, 3 and 9: past the widest round chunk), f32, bf16 and
   f64 out, 2 nodes, a ragged row count, a block of zeros; S = 5, 6, 9
   and 17 (past the widest sender chunk) and the MoE routers' blocks 8
   and 16 on B4's vector variant; and B4's row variant on payload rows no
   16-byte store serves (block 20 at 2 bits, nibble-packed block 4, block
   6 at 4 bits) and on payloads off the alignment.  Every B4 call must
   take the variant ``b4_vector_expected`` names for its output dtype
   (the vector one when each unit's G = 16 / (bytes an output) codes a
   half make one 16-byte store: a payload row of whole G-byte words at a
   G-byte aligned address; any S and T).  B3 alone on B3_CASES: blocks 4,
   8, 16, 20, 32, 64, 512, 1024 and 2048 at bits 1-7 and x or u off the
   16-byte alignment, each with a zero row; every B3 call must take the
   variant ``b3_vector_expected`` names (the vector variant for aligned
   rows of U = B/8 (nibble) or B/4 units, U a power of two up to 32 or a
   multiple of 32 up to block 1024).  Packed bytes, scales, qself and the
   mix must be exactly equal (kernel and plain version sum the senders in
   one order).  The same
   checks at the shapes the trainer below gives them: its block-256 group
   (8 nodes x 700,456 rows of 256) and its block-128 q_norm/k_norm group
   (8 nodes x 4 rows of 128), 2 bits, ring payloads (S = 3), T = 1; both
   kernels are timed at the block-256 group, B3 on both its variants (the
   row one on views of the same buffers one f32 off the alignment), in
   turns.  B4 also at the scheduled
   trainer's shape (6b): the block-256 group with T = 2 rounds and S = 6
   senders (self plus the five hops of the ring/exponential union, the
   plan's own weights), checked and timed the same way on both its
   variants (the vector one, and the row one on a view of the payload one
   byte off the alignment), in turns.
   Every B3/B4 bound here and in phase 12 (c) is over the bytes
   ``repro_torch.obs.roofline_gate.kernel_roofline`` prices the launch at
   (its per-node model x the nodes the launch covers); the launch's own
   tensors must hold the same bytes (B3) or those plus B4's weight table.
6. The trainer path: ``api.build(spec)`` on the card for
   qwen3-1.7b at its published widths (2 of 28 layers, the first eighth of
   the vocabulary), 8 nodes on a ring, the neighbor-gossip backend with
   the bucketed wire (2-bit QInf, block 256), f32, full f32 products
   (``torch.backends.cuda.matmul.allow_tf32 = False``).  SLICE_STEPS steps
   with the launch counters zeroed just before and read just after: B3 and
   B4 must launch once per bucket group per step; the loss must be finite,
   and lower at the end than at the start (mean of the last LOSS_WINDOW
   steps against the first: one step's loss moves with its batch), the
   consensus finite; the loss on two held-out batches is reported;
   ``bits_per_step`` must equal 2 hops x 739,683,712 bits.  Peak memory,
   step time and a short ``torch.profiler`` window (device busy share,
   time by kernel, and the wire's share: the device ops launched inside
   each of the program's ``wire/`` phases, the noise draws, the pack
   (B3), the hops' copies, the payload stacks and the mix (B4), each a
   ``record_function`` range while the profiler runs) are reported.
   Then ``[contracts]``: one more step audited by
   ``repro_torch.check.contracts`` (the second of two) under
   ``torch.cuda.set_sync_debug_mode("error")``: 2 x 2 u8 ``pp`` calls,
   each hop's pair 92,460,464 B a node, no f64 op, no host read; and
   ``[roofline]``: ``repro_torch.obs.roofline.analyze`` over two more
   steps (t_compute, t_memory, t_collective, the bottleneck, the median
   measured step, mfu = model FLOPs / (median step x PEAK_FLOPS), counted
   FlopCounterMode FLOPs over the analytic ones) beside the run report's
   wire roofline.
6b. The same trainer under ``schedule='alternating'`` (ring <->
   exponential, T = 2 Hw slots, 5 union hops): SLICE_STEPS steps with the
   counters zeroed just before and read just after, B3 and B4 once per
   bucket group per step, the loss falling, ``bits_per_step`` equal to 5
   hops x 739,683,712 bits; step time and peak memory; its
   ``[contracts]`` (2 x 5 u8 calls) and ``[roofline]`` lines.
7. Bucketed against per-leaf wire on the card, at the slice's widths, on
   the leaves ``blocks/w_gate`` (whole), ``embed`` and ``blocks/q_norm``:
   the same diffs and noise through both exchanges; codes, scales and
   qself equal, the mix within (S + 1) eps_f32 max|Q| max_n sum_s |w|.
8. Card against CPU for the trainer at a small size (qwen3 reduced to 1
   layer, d_model 256, 8 nodes): REPLAY_STEPS_SLICE steps, each started
   from the card's state, the CPU path drawing and the card replaying the
   same noise; X, D, H and Hw within 1e-4 x max of each array on all but
   0.1 % of elements.  Three variants: the ring, ``schedule='alternating'``
   (T = 2 Hw slots, B4's two-round mix read back on the card) and the
   dense backend under ``drop_rate`` DROP_RATE (the fault draws replayed
   too).  Then that dense ``drop_rate`` trainer run twice on one runner
   for DROP_RATE_STEPS steps, each run from a fresh state, the launch
   counters zeroed just before the first run and read just after it: B1
   and B2 once per leaf a step, the two runs' X at the tolerance above.
9. The paper's comparisons on the card (``repro_torch.paper``, the
   registered ``logreg`` problem at its defaults: 8 nodes on a ring,
   784x10 flattened, 150 samples and 15 batches a node, lambda2 = 0.005;
   f64).  (a) The Fig. 1 and Fig. 2 grids, 13 and 11 rows of PAPER_STEPS
   steps, each row through ``api.build(spec)``: the launch counters are
   zeroed just before each row and read just after it; a 2-bit row must
   launch B1 and B2 once a step, an uncompressed row neither; every claim
   of ``validate`` must pass, and each is printed with its value, as is
   each row's final suboptimality, bits and ms a step.  (b) The Table 3
   rows: each measured rate within its theorem envelope (rho_hat <= rho +
   1e-3); a ``torch.profiler`` window of PAPER_PROFILE_STEPS steps of the
   LEAD (2bit) row (device busy share, every device operation by name, B1
   once a step).  (c) DGD, PG-EXTRA, Choco (2 bit) and LessBit (2 bit) at the
   paper's rows: PAPER_REPLAY_STEPS steps, each started from the card's
   state and held against one step of the plain CPU path with the same
   draws, at phase 4's tolerance.  (d) ``empirical_C`` of 2-bit QInf on
   the (8, 7840) leaf with EMPIRICAL_C_TRIALS trials: one B1 and one B2
   launch, equal (to 1e-12 relative: the error sums reduce in another
   order) to the plain version's value from the same noise, at most the
   compressor's analytic C.
10. The sweep engine (``repro_torch.sweep``) on the card.  (a) The golden
   ``tests/golden_specs/sweep_lead_seed_x_bits.json`` (12 points: seeds
   0-3 x bits 2, 4, 8; LEAD on the ring, ``logreg2d``, block 5, 60 steps)
   through ``api.build(SweepSpec)`` in map mode, f64, the launch counters
   zeroed just before and read just after: B1 and B2 12 x 60 times each;
   every point's final state bit-equal to its serial run on the card.
   (b) The stacked grid (``batch='vmap'``) at the dense path's full width:
   phase 4's spec x seed 0-7 x bits 2, 4 (16 points, the data shared, f32):
   SWEEP_REPLAY_STEPS stacked steps held against map mode from the same
   stacked state, each point's draws recorded and replayed, at phase 4's
   tolerance per point, every B1 (at each point's level count) and B2
   launch of the first stacked step held bit for bit to its plain
   version; a free-running run of SWEEP_STEPS steps with the
   counters zeroed just before and read just after -- B1 and B2 once a
   step for the whole grid -- in which every point's objective falls; ms a
   step of the stacked grid against the summed ms a step of the 16 points
   run one by one (SWEEP_TIMED_STEPS steps each, one process), and a
   ``torch.profiler`` window of SWEEP_PROFILE_STEPS stacked steps (device
   ops a step, busy share).  (c) B1 with a level count per point
   (``levels``) bit-equal to B1 at each point's fixed bits and to the
   plain twin, on the stacked leaf (16, 8, 7840) in f32, bf16 and f64 and
   on 393,216 x 256 rows split into 4 points at bits 1, 2, 4, 8; timed
   (CUDA events) beside the fixed-bits B1 and the bytes bound.  (d) A dense
   runner and phase 8's small trainer save at step 2 and
   ``load_checkpoint(..., device="cuda")`` restores them; the next step
   from both, same draws, bit-equal.  (e) ``python -m
   repro_torch.launch.sweep --spec`` the golden sweep ``--out`` a file:
   exit 0, each point's final consensus equal to (a)'s.  (f)-(h) Stacked
   grids beyond the dense Prox-LEAD family, each on phase 4's data (f32),
   each held like (b): SWEEP_REPLAY_STEPS stacked steps teacher-forced
   against map mode (each point's algorithm draws and, on netsim, its
   fault draws recorded in the stacked step and replayed in the map
   step) at phase 4's tolerance per point with the first stacked step's
   B1 and B2 launches held as in (b), SWEEP_STEPS free-running steps
   with the counters zeroed just before and read just after, ms a step
   stacked against the summed ms a step of the points run one by one, and
   peak memory.  (f) The netsim grid: phase 4b's scenario x fault_seed
   0-7 x bits 2, 4 (16 points); every round's bits of a
   SWEEP_REPLAY_STEPS run equal to map mode's as integers; B1 and B2
   once a step for the whole grid; every point's objective falls; a
   profile.  (g) Fig. 1's "LessBit-LSVRG (2bit)" row (LessBit, L-SVRG,
   2-bit QInf, eta 1/(6L)) x seed 0-7 x ``algorithm.params.theta`` 0.2,
   0.1 (16 points): as (f), and peak memory.  (h) LEAD with RandK (frac
   0.1) x seed 0-7, and Choco with TopK (frac 0.1) x ``gamma_c`` 0.2, 0.1
   x eta 0.05, 0.1: as (g), with no B1/B2 (they compress nothing with
   QInf) and no profile.  (i) The stacked grid over a tree-valued
   iterate: phase 4's data and spec with an intercept (``logreg_bias``,
   registered here: W (8, 784, 10) and b (8, 10)), QInf in blocks of 10
   along the class axis, x seed 0-7 x bits 2, 4 (16 points, f32), held
   like (b), over TREE_STEPS free-running steps, with B1 and B2 once a
   leaf a step for the whole grid (2 each), no profile; then one point's
   serial dense run and its netsim run under phase 4b's scenario on the
   card (TREE_SERIAL_STEPS steps each: B1 and B2 once a leaf a step, the
   objective falls, netsim bits int64 and positive).
11. Serving (``repro_torch.launch.serve``) at published widths, one model
   at a time, f32, TF32 off, random weights from a seeded generator, batch
   4, prompt 16, 32 generated tokens: mixtral-8x7b (2 of 32 layers),
   deepseek-moe-16b (2 of 28, all 64 routed experts), rwkv6-7b (2 of 32),
   recurrentgemma-9b (3 of 38: one (rec, rec, attn) unit),
   llama-3.2-vision-90b (5 of 100: one super-block, 1,601 vision tokens)
   and whisper-large-v3 whole (32 + 32 layers, 1,500 encoder frames); MoE
   at capacity_factor = n_experts.  ``prefill`` timed after one warm-up,
   then ``generate`` timed; the logits each token was taken from must equal
   the teacher-forced forward over the generated sequence at the same
   positions within SERVE_TOL x max|logits|, every id in [0, padded vocab);
   ms of the prefill, ms a decode step, tokens a second, peak memory.
   Then mixtral at 2 layers with one 4,608-token prompt (its window is
   4,096: ROADMAP C11's case) and 8 decode steps, held the same way.
12. The trainer on the other families.  (a) Each of the six at the
   reference's ``.reduced()`` (2 layers, d_model 256), 8 nodes on a ring,
   the neighbor backend with the bucketed wire, 2-bit QInf: phase 8's
   card-against-CPU check for REPLAY_STEPS_SLICE steps (a leaf that is
   zero up to rounding compared at its state tree's largest entry, D at
   least at gamma / (2 eta) x max|X|; rwkv6-7b's elements within
   SSM_REPLAY_ELEM_TOL), and B3/B4 once per bucket group a step (counters
   zeroed before the first step, read after the last).  (b) whisper-large-v3 at its published widths, 1 encoder + 1
   decoder layer, full vocabulary, seq_len 448, and deepseek-moe-16b at its
   published widths, 1 of 28 layers, vocab/8 (12,800), 16 of its 64 routed
   experts, seq_len 512; 8 nodes on a ring, bucketed wire, 2-bit QInf in
   256-blocks, f32, SLICE_STEPS steps as phase 6: B3 and B4 once per bucket
   group a step, the loss falling and finite, ``bits_per_step`` equal to 2
   hops x a host recount from the parameter shapes, peak memory below
   FAMILY_PEAK_GB, step time and a ``torch.profiler`` window; each
   trainer's ``[contracts]`` and ``[roofline]`` lines, as phase 6's.  (c) B3/B4
   against their plain versions, bit-equal, at every block width below 256
   of the six families' published widths and depth (8, 20, 64, 128) and at
   each bucket group of (b)'s trainers (16 and 256), ring payloads (S =
   3), each timed beside its bound, B3 on the variant it must take (the
   row one at block 20 only).
14. (Run after phase 12, before the result lines.)  The contract audit
   over every golden spec on the card (``repro_torch.check.contracts.
   audit_spec_dir``): each spec's second step recorded under
   ``set_sync_debug_mode("error")``; every finding printed; any FAIL fails
   the run; each sharded spec is audited at (8, 1) and at (4, 2), a
   neighbor spec's (4, 2) variant also as a tensor-parallel node
   (``<name>/tp``, ``StackedTP(2)``), and none waits.
15. Model-sharded meshes: the node's leaves cut into M model shards on the
   bucketed wire, all M in one process.  (a) The golden
   ``trainer_neighbor_alternating_4x2`` spec: GOLDEN_4X2_STEPS steps card
   against CPU (phase 8's check, B3/B4 once per bucket group a step); the
   contract audit of a step, its ``pp`` bytes GOLDEN_4X2_SHARD_BYTES a
   model shard (the reference's figure on its 8-device mesh); every B3
   and B4 launch of a step bit-equal to its plain version on the same
   operands.  (b) Phase 6's slice on the mesh (8, 2), SLICE_STEPS steps:
   B3 and B4 once per bucket group a step, ``bits_per_step`` = 2 hops x
   SLICE_8X2_BITS_PER_HOP, the ``[contracts]`` (each hop's pair 92,736,352
   B a node) and ``[roofline]`` lines, peak memory, the median step beside
   phase 6's from the same call.  (c) B3/B4 at that layout's two groups (8
   nodes x 2 shards x 351,272 rows of 256, and of 4 rows of 128) against
   their plain versions, timed beside their bounds.  Several processes
   (``DistPP``) are not run: the machine has one card, and NCCL refuses
   two ranks on one device; the gloo path is tested on the CPU
   (``tests/test_torch_dist.py``).
16. (Run after phase 15, before the result lines.)  The dry run
   (``repro_torch.launch.dryrun``: one step on the ``meta`` device, kernels
   B1-B4 on the card's route dry, nothing allocated).  (a) Phase 6's slice
   (8 nodes, one process, the program phase 6 runs) and phase 15's at (8,
   2) dry-run: FLOPs, ATen bytes and ``pp`` bytes equal to the ``[roofline]``
   counts of the phase's real step; the dry peak (argument + temp bytes)
   within DRY_PEAK_TOL of ``max_memory_allocated`` over one real step from
   the state a warm-up step left (``reset_peak_memory_stats`` just
   before); the card's ``total_memory`` beside
   ``dryrun.H100_MEMORY_BYTES``.  (b) The production sweep by the CLI, one
   process a job, all started together: every arch x every shape on (16,
   16) and every arch x ``train_4k`` on (2, 16, 16), less DRY_LOOPED's
   ``train_4k`` and ``prefill_32k`` (their recurrences loop over the
   tokens in Python: minutes a combo; the CLI runs them), the neighbor
   ring, 2 bits, bf16, one node a rank; every combo ``ok`` or
   skipped as ``configs.shapes.applicable`` says; one line a combo
   (per-rank peak, fits, state bytes a model shard, the roofline terms,
   the bottleneck, counted over analytic FLOPs, bits a round) and the
   phase's seconds.  Records in ``chiprun_out/dryrun_torch/``.
17. (Run after phase 16, before the result lines.)  A tensor-parallel
   node: each node's products split over its M model ranks
   (``repro_torch.models.tp``), all N x M rank-rows in one process
   (``StackedTP``; ``DistTP`` across processes is not run here: one card,
   and NCCL refuses two ranks on one device; gloo on the CPU holds it,
   ``tests/test_torch_tp_dist.py``).  (a) Phase 6's slice at (8, 2):
   TP_TF_STEPS steps teacher-forced against phase 15's whole-node (8, 2)
   step from the same state and draws (C4's bar: TP_STEP_TOL of each
   array's max on all but TP_STEP_MAX_OFF of its elements), every B3 and
   B4 launch of the first bit-equal to its plain version on the same
   operands; then SLICE_STEPS free-running steps through
   ``trainer_path`` (the loss falls and stays finite, B3/B4 once per
   bucket group a step, ``bits_per_step`` = 2 x SLICE_8X2_BITS_PER_HOP),
   the ``[contracts]`` line under ``set_sync_debug_mode("error")``, the
   ``[roofline]`` line with the TP bytes a step, the median step and peak
   memory beside phase 15's.  (b) The same at (2, 16), whose 8 KV heads
   split in halves (k and v gathered to whole heads): teacher-forced
   against the whole-node (2, 16) step, ``bits_per_step`` =
   SLICE_2X16_HOPS x SLICE_2X16_BITS_PER_HOP.  (c) (a)'s step dry-run in
   one process (placement ``"tp one process"``): FLOPs, ATen bytes,
   ``pp`` bytes and TP bytes equal to (a)'s ``[roofline]`` counts, the
   peak within DRY_PEAK_TOL of ``max_memory_allocated``.  (d) The
   production sweep under ``--placement tp`` (rank (0, 0) of N x M: one
   model shard of one node a card), phase 16 (b)'s jobs: all ten
   architectures, every shape on (16, 16) and ``train_4k`` on (2, 16,
   16), less DRY_LOOPED's ``train_4k`` and ``prefill_32k`` (the CLI runs
   them); every combo ``ok`` or skipped as ``configs.shapes.applicable``
   says; one line a combo: per-rank peak and ``fits``, the rank's state
   bytes beside ``state_bytes_per_model_shard`` (a train step) or its
   cache bytes beside the whole node's and the whole node's / M (a
   decode step), the TP bytes, the roofline terms.  Records in
   ``chiprun_out/dryrun_torch_tp/``.
18. (Run after phase 17, before the result lines.)  RWKV-6 and the RG-LRU
   on a tensor-parallel node, and serving at M > 1, ``StackedTP`` in one
   process.  (a) rwkv6-7b (1 of 32 layers) on the mesh (4, 2) and
   recurrentgemma-9b (one (rec, rec, attn) unit, 3 of 38) on (2, 2)
   (TP_RECURRENT: N the largest of 8, 4, 2 whose whole-node step fits
   FAMILY_PEAK_GB by the dry run), published widths, the vocabulary's
   first eighth, TP_RECURRENT_SEQ tokens, the ring, the bucketed wire,
   2-bit QInf in 256-blocks, f32, TF32 off: TP_TF_STEPS steps
   teacher-forced against the whole-node step (C4's bar, RWKV-6's
   SSM_REPLAY_ELEM_TOL; every B3 and B4 launch of the first bit-equal to
   its plain version), then SLICE_STEPS free steps of the whole node and
   of the split node: the loss falls and stays finite, B3 and B4 once per
   bucket group a step, ``bits_per_step`` = the ring's hops x a host
   recount from the model-local shapes, the ``[contracts]`` line under
   ``set_sync_debug_mode("error")``, the ``[roofline]`` line with the TP
   bytes, the median step and peak of both.  (b) Phase 11's six
   architectures at its depths (batch 4, prompt 16, 32 tokens) under
   ``StackedTP(2)``, then recurrentgemma-9b (3 layers) at M = 16 (one
   query head a rank, its one KV head cut in 16) and whisper-large-v3 at
   M = 8 (2.5 query heads a rank), through ``serve.prefill(tp=)`` and
   ``serve.generate(tp=)``: the logits each token was taken from within
   SERVE_TOL x max |logits| of the whole node's teacher-forced forward;
   prefill ms, ms a decode step, tok/s and peak beside phase 11's;
   RWKV-6's token-shift caches bit-equal over the ranks after the last
   step.  The phase's seconds.
19. (Run after phase 18, before the result lines.)  The dense backend
   on ranks and whole-leaf mixing on a split node.  (a) Phase 6's slice
   on the dense backend (published widths, 2 layers, vocab/8, the ring,
   2-bit QInf, f32) over N nodes, N the largest of DENSE_NODES whose
   dense step on one rank the dry run fits under DENSE_PEAK_GB, on the
   rank of a one-rank NCCL group (``torch.distributed``, a
   ``ProcessMesh`` of world 1: the machine has one card, and NCCL
   refuses two ranks on one device), its mixer a ``RowsMixer`` gathering
   each leaf through ``DistAG`` (``all_gather_into_tensor``):
   DENSE_RANK_STEPS steps, each from one state and one gradient, the
   rank's update (X, D, H, Hw) bit for bit the one-process update's with
   the same draws, every B1 and B2 launch of its first update bit for bit
   its plain version on the same operands; then DENSE_TIMED_STEPS full
   steps: B1 and B2 once a
   leaf a step, the median step, the peak; the same again under
   ``drop_rate`` = DROP_RATE (every rank draws the whole fault mask).  A
   failed init or collective fails the run; nothing falls back to the
   CPU.  (b) (a)'s step dry at world 1 (``dryrun.dry_train(...,
   placement="ranks", world=1)``): FLOPs, ATen bytes and the all-gather
   bytes a rank receives (none on one rank) equal to the real step's
   (``dryrun.counted_step``), and at one node a rank (N - 1) x a node's
   leaf bytes; ``train_4k`` of every arch on (16, 16) with ``--backend
   dense`` (one node a rank, the default placement), started with phase
   16 (b)'s jobs, less DRY_LOOPED's (minutes a combo on ``meta``; the
   CLI runs them): one line a combo, peak, ``fits``, all-gather bytes.
   (c) Phase 17 (a)'s split node, ``StackedTP(2)`` at (8, 2), with
   ``wire_mode="per_leaf"`` and on the dense backend: TP_TF_STEPS steps
   teacher-forced against the whole-node (8, 2) step of the same mode
   (C4's bar; the states wait on the host in page-locked memory), every
   B1 and B2 launch of the first split step bit for bit its plain
   version, ``bits_per_step`` equal to the whole node's, then
   WHOLE_LEAF_STEPS timed steps of the split and of the whole node (B1
   once a leaf a step; B2 once a leaf, 1 + hops times on the per-leaf
   wire), the median step and the peak.  The phase's seconds.
20. (Run after phase 19, before the result lines.)  B5/B6, the neighbor
   trainer's Prox-LEAD update (``kernels/csrc/proxlead_update.cu``):
   (a) against the eager update on the card, the same operands (the diff
   rows, q and W Q views into bucket-group tables laid out as the cells'
   wire lays them), at the qwen3 cells' largest leaf and at (8, 1280,
   128, 3) (an odd last axis, its rows padded: the scalar variant):
   T = 1 and 2 at every slot, alpha 0.5 and 0.3, the cells' l1 prox, and
   at T = 1 every other elementwise prox; the diff rows, D, H, every Hw slot and X bit for bit, else counted and held
   to C4's bar (PROXLEAD_BAR).  (b) ms a call (CUDA events) of B5, B6 and
   the eager chain at the largest leaf and summed over every leaf of the
   state, T = 1 and 2, beside B5's and B6's bytes bounds.  Phase 6 (and
   6b) also require one B5 and one B6 launch a leaf a step.
13. Result lines: ``{"kernels": [...]}`` (B1-B4; B3's entry also names
   its variant at each shape and the row variant's ms at the trainer's
   shape; B3's and B4's the (8, 2) groups and launches, and their
   launches at phase 17's and phase 18 (a)'s tensor-parallel layouts;
   B1's and B2's their launches in phase 19 (a) and (c)),
   the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.  Everything is also written to
   ``chiprun_out/chip_smoke.json``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

STEPS = 300              # main-path steps with counters on
REPLAY_STEPS = 20        # steps held against the plain CPU path
REPLAY_ELEM_TOL = 1e-4   # an element of X agrees within this x max|X| ...
REPLAY_MAX_OFF = 1e-3    # ... except at most this fraction of X per step
LARGE = (8, 12_582_912)  # 8 nodes x 2048*6144 parameters
MAIN_SHAPE_ITERS = 200   # back-to-back calls timed at the main path's shape
B1_OPS_PER_ELEMENT = 10     # |x|, max, mul, div, add, floor, min, sign, mul, cvt
B2_OPS_PER_ELEMENT = 2      # cvt, mul
PROFILE_STEPS = 20          # main-path steps under torch.profiler
B3_OPS_PER_ELEMENT = 11     # B1's ten, the offset add (packing is bitwise)
SLICE_STEPS = 30            # trainer steps with counters on
LOSS_WINDOW = 5             # the loss falls: mean of the last 5 < first 5
SLICE_PROFILE_STEPS = 3     # trainer steps under torch.profiler
SLICE_GROUP_ROWS = 700_456  # block-256 rows per node at the slice's widths
SLICE_SMALL_GROUP_ROWS = 4  # block-128 rows per node (q_norm, k_norm x 2)
SLICE_BITS_PER_HOP = 739_683_712   # the per-edge payload of a hop
REPLAY_STEPS_SLICE = 5      # small trainer steps held against the CPU
DROP_RATE = 0.3             # the dense trainer's LinkDrop rate (phase 8)
DROP_RATE_STEPS = 5         # its steps a run, two runs
PAPER_STEPS = 800           # steps of a Fig. 1 / Fig. 2 row (the paper's)
PAPER_REPLAY_STEPS = 20     # baseline steps held against the CPU path
EMPIRICAL_C_TRIALS = 64
PAPER_PROFILE_STEPS = 50    # LEAD (2bit) steps under torch.profiler
PROFILE_GUARD_S = 0.05      # idle host time at each edge of a profiler window
NETSIM_STEPS = 300          # scenario steps with counters on
NETSIM_STATIC_STEPS = 20    # static netsim steps held bit-equal to dense
NETSIM_TIMED_STEPS = 100    # steps timed per engine
NETSIM_PROFILE_STEPS = 20   # scenario steps under torch.profiler
SCENARIO_FAULTS = (("straggler", {"rate": 0.05}), ("linkdrop", {"rate": 0.1}),
                   ("noise", {"sigma": 0.01}))
SCHEDULED_HOPS = 5          # ring + exponential on 8 nodes: the union's hops
SWEEP_SEEDS = 8             # the stacked grid: seeds 0-7 ...
SWEEP_BITS = (2, 4)         # ... x these bits, 16 points
SWEEP_STEPS = 300           # its free-running steps with counters on (as STEPS:
                            # at 100 the objective has not turned down yet)
SWEEP_REPLAY_STEPS = 20     # stacked steps held against map mode
SWEEP_TIMED_STEPS = 50      # steps timed a mode
SWEEP_PROFILE_STEPS = 20    # stacked steps under torch.profiler
TREE_STEPS = 600            # the tree grid's free-running steps (10 (i)):
                            # with an intercept each node's first step fits
                            # its own classes' bias, mixing undoes it, and
                            # the objective is back below the first step's
                            # after ~400 steps (~1.7e-2 lower at 600)
TREE_SERIAL_STEPS = 1000    # its serial runs' steps: under phase 4b's
                            # faults the first step gains less, and at 600
                            # steps the objective is only ~3e-3 lower
LARGE_ROWS = LARGE[0] * LARGE[1] // 256   # B1/B2's large shape in rows
B1, B2 = "qinf_quantize_blocks", "qinf_dequantize_blocks"
PROXLEAD_ITERS = 10         # B5/B6 calls timed back to back at the largest leaf
PROXLEAD_STATE_ITERS = 3    # ... and at each leaf of the whole state
PROXLEAD_BAR = (1e-5, 1e-3)  # C4's bar: within 1e-5 x max, all but 0.1 %


# kernel B1 in a profile, and the fill and copy kernels of a pad (F.pad's
# constant_pad_nd) or any device copy
B1_KERNEL = re.compile(r"qinf_quantize_(vec_|row_)?kernel")
PAD_KERNEL = re.compile(r"FillFunctor|copy", re.IGNORECASE)


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    require(r.returncode == 0 and r.stdout.strip(),
            f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: int, ops: int):
    """(least time in ms, "bytes" or "operations") on an H100 SXM: the
    rates of ``repro_torch.obs.roofline`` (HBM_BW, PEAK_FLOPS: f32 outside
    the tensor cores)."""
    from repro_torch.obs.roofline import HBM_BW, PEAK_FLOPS
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def wire_bound(torch, kernel: str, block: int, rows: int, n_nodes: int,
               counted: int, slack: int = 0, *, hops: int = 2,
               receivers: int = 1, ops: int = 0, shards: int = 1):
    """B3's or B4's bound (``bound_ms``) over the bytes
    ``repro_torch.obs.roofline_gate.kernel_roofline`` prices a launch at:
    its per-node model of one bucket group of ``rows`` rows of ``block``
    a model shard (2 bits, f32 scales; B4 with ``hops`` received payloads
    and ``receivers`` mix rows; ``shards`` model shards a node) times the
    ``n_nodes`` the launch covers.  The bytes of the launch's own tensors,
    ``counted``, must agree: exactly (B3), or within ``slack`` (B4: the
    weight table the model leaves out)."""
    from repro_torch.core import bucket
    from repro_torch.obs import kernel_roofline
    layout = bucket.compute_layout([(rows, block)], [torch.float32], bits=2,
                                   block_for=lambda shape: block)
    part = {"B3": "quantize_pack", "B4": "unpack_dequant_mix"}[kernel]
    model = int(kernel_roofline(layout, hops=hops, receivers=receivers,
                                shards=shards)[part]["hbm_bytes"]) * n_nodes
    require(0 <= counted - model <= slack,
            f"{kernel} at {n_nodes} x {rows} x {block}: roofline_gate "
            f"prices {model:,} bytes, its tensors hold {counted:,} (slack "
            f"{slack})")
    return bound_ms(model, ops)


# --- phase 2 -------------------------------------------------------------------

_PTX_TYPES = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}


def ptxas_report(text: str):
    """Registers, spill bytes and resident warps per SM (256-thread blocks,
    65,536 registers an SM allocated 256 at a time per warp, at most 64
    warps) of every kernel in one source's ``nvcc -Xptxas=-v`` output."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"((?:qinf|proxlead)_[a-z_]+_kernel)(I.*)?",
                             m[1])
            args = [_PTX_TYPES.get(a, a[2:-1]) for a in re.findall(
                r"13__nv_bfloat16|L[ib]\d+E|(?<=[IE_])[fd](?=[EL])",
                name[2] or "")]
            cur = {"kernel": name[1] + (f"<{','.join(args)}>" if args
                                        else ""), "spill_bytes": 0}
            rows.append(cur)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            regs = int(m[1])
            warp_regs = -(-regs * 32 // 256) * 256
            blocks = 65536 // (warp_regs * 8)
            cur.update(registers=regs, resident_warps=min(64, blocks * 8))
    return rows


# --- phase 3 -------------------------------------------------------------------

# B1's leaves (label, shape, block, storage offset in elements, row stride
# or None, first zeroed element of the last axis or None, B1 takes its
# vector variant): the main path's leaf, ragged leaves, a block of zeros, an
# 8 x 2048x6144 leaf, and the leaves that pick each variant -- the cases of
# tests/test_torch_kernels.py::test_cuda_lastdim_matches_plain.  Vector:
# every block starts 16-byte aligned and holds at most 1024 elements; row:
# rows that break the alignment, a view off it, a wider block.
B1_CASES = [("main", (8, 7840), 256, 0, None, None, True),
            ("block128", (8, 7840), 128, 0, None, None, True),
            ("ragged1d", (129,), 256, 0, None, None, True),
            ("zero_block", (8, 256), 256, 0, None, None, True),
            ("zero_tail", (4, 320), 256, 0, None, 256, True),
            ("row_stride", (8, 7840), 256, 0, 8000, None, True),
            ("large", LARGE, 256, 0, None, None, True),
            ("ragged3d", (3, 7, 11), 256, 0, None, None, False),
            ("unaligned_rows", (5, 129), 256, 0, None, None, False),
            ("offset_view", (8, 7840), 256, 1, None, None, False),
            ("wide_block", (8, 7840), 2048, 0, None, None, False)]


def b1_leaf(torch, shape, offset, row_stride, zero_from, dtype, g,
            device="cuda"):
    """A leaf of ``shape``: ``offset`` elements into its buffer, rows
    ``row_stride`` apart (a view of wider rows), its last axis zero from
    ``zero_from`` on."""
    lead, D = shape[:-1], shape[-1]
    width = row_stride or D
    buf = torch.randn(offset + math.prod(lead) * width, generator=g,
                      device=device) * 3
    x = buf.to(dtype)[offset:].view(*lead, width)[..., :D]
    if zero_from is not None:
        x[..., zero_from:] = 0
    return x


def check_kernels(torch, ops, qk, ref, errs, cases=B1_CASES, device="cuda"):
    """B1 through ``ops.qinf_quantize_lastdim`` (the leaf unpadded, its
    ragged tail read in place) and B2 on its codes, against the plain
    versions on the zero-padded rows, bits {1,2,3,4,7,8}, x f32/bf16/f64;
    each case must take the B1 variant it names.  Records the largest
    difference per kernel in ``errs`` and fails on any."""
    g = torch.Generator(device=device).manual_seed(0)
    n_checked = n_vector = 0
    for label, shape, block, offset, row_stride, zero_from, vector in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            x = b1_leaf(torch, shape, offset, row_stride, zero_from, dtype, g,
                        device)
            if label == "zero_block":
                x[3] = 0
            u = torch.rand(ops.blockwise_shape(shape, block), generator=g,
                           device=device)
            require(device != "cuda" or qk.uses_vector_variant(
                "qinf_quantize_blocks", x, u) is vector,
                f"B1 at {label} {dtype} must take the "
                f"{'vector' if vector else 'row'} variant")
            xb = ops.blockwise_lastdim(x, block=block).reshape(-1, block)
            for bits in (1, 2, 3, 4, 7, 8):
                ck, sk = ops.qinf_quantize_lastdim(x, u, bits=bits,
                                                   block=block)
                require(ck.shape == u.shape
                        and sk.shape == u.shape[:-1] + (1,),
                        f"B1 at {label}: codes {tuple(ck.shape)}, scales "
                        f"{tuple(sk.shape)} for noise {tuple(u.shape)}")
                cp, sp = ref.qinf_quantize_blocks_ref(
                    xb, u.reshape(-1, block), bits)
                ck, sk = ck.reshape(-1, block), sk.reshape(-1, 1)
                e1 = max(float((ck.int() - cp.int()).abs().max()),
                         float((sk - sp).abs().max()))
                errs["qinf_quantize_blocks"] = max(
                    errs["qinf_quantize_blocks"], e1)
                require(torch.equal(ck, cp) and torch.equal(sk, sp),
                        f"B1 != plain at {label} {dtype} bits={bits} "
                        f"(max diff {e1})")
                for out in {torch.float32, dtype}:
                    dk = qk.qinf_dequantize_blocks(ck, sk, out)
                    dp = ref.qinf_dequantize_blocks_ref(cp, sp, out)
                    e2 = float((dk.double() - dp.double()).abs().max())
                    errs["qinf_dequantize_blocks"] = max(
                        errs["qinf_dequantize_blocks"], e2)
                    require(torch.equal(dk, dp),
                            f"B2 != plain at {label} {dtype}->{out} "
                            f"bits={bits} (max diff {e2})")
                if label == "zero_block":        # node 3's one block
                    zc, zs = ck[3], sk[3]
                elif label == "zero_tail":       # each row's second block
                    zc, zs = ck.view(-1, 2, block)[:, 1], sk.view(-1, 2)[:, 1]
                if label in ("zero_block", "zero_tail"):
                    require(float(zs.abs().max()) == 0.0
                            and int(zc.abs().max()) == 0,
                            f"an all-zero block must give scale 0, codes 0 "
                            f"({label})")
                n_checked += 1
                n_vector += vector
            del x, u, xb, ck, sk, cp, sp
    n_checked += check_b2_variants(torch, qk, ref, errs, device)
    if device == "cuda":
        torch.cuda.synchronize()
    return n_checked, n_vector


def check_b2_variants(torch, qk, ref, errs, device="cuda"):
    """B2's vector and row variants against the plain version (the cases
    of tests/test_torch_kernels.py::test_cuda_dequantize_variants_match_
    plain): widths 256 and 128 (vector), 100 and 3 (row), and a contiguous
    view one row into its buffer (width 100: off the 16-byte alignment,
    row variant; width 256: still aligned, vector), f32/bf16/f64 out.
    Outputs must be exactly equal, and each case must take the variant
    named."""
    g = torch.Generator(device=device).manual_seed(5)
    R, n = 8 * 31 + 5, 0
    for block, offset_rows, vector in ((256, 0, True), (128, 0, True),
                                       (100, 0, False), (3, 0, False),
                                       (100, 1, False), (256, 1, True)):
        buf = torch.randint(-4, 5, (R + offset_rows, block), generator=g,
                            device=device, dtype=torch.int8)
        codes = buf[offset_rows:]
        scales = torch.rand((R, 1), generator=g, device=device) * 3
        scales[7] = 0
        for out in (torch.float32, torch.bfloat16, torch.float64):
            dk = qk.qinf_dequantize_blocks(codes, scales, out)
            require(device != "cuda" or qk.uses_vector_variant(
                "qinf_dequantize_blocks", codes.data_ptr(), dk.data_ptr(),
                block) is vector, f"B2 at width {block}, offset "
                f"{offset_rows} rows, must take the "
                f"{'vector' if vector else 'row'} variant")
            dp = ref.qinf_dequantize_blocks_ref(codes, scales, out)
            e2 = float((dk.double() - dp.double()).abs().max())
            errs["qinf_dequantize_blocks"] = max(
                errs["qinf_dequantize_blocks"], e2)
            require(torch.equal(dk, dp), f"B2 != plain at width {block}, "
                    f"offset {offset_rows} rows, {out} (max diff {e2})")
            n += 1
    return n


def time_kernels(torch, qk, ref, shape, iters: int = 20):
    """Times of B1/B2, their plain versions and the library call, f32 x,
    bits=2, at ``shape`` viewed as (R, 256) rows, each over ``iters``
    back-to-back calls."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=g, device="cuda").reshape(-1, 256)
    u = torch.rand(x.shape, generator=g, device="cuda")
    codes, scales = qk.qinf_quantize_blocks(x, u, 2)
    out = qk.qinf_dequantize_blocks(codes, scales)
    lib = torch.mul(codes, scales)
    require(lib.dtype == torch.float32 and torch.equal(lib, out),
            "torch.mul(codes, scales) must compute B2's function")
    n = x.numel()
    b1_bound = bound_ms(nbytes(x, u, codes, scales), B1_OPS_PER_ELEMENT * n)
    b2_bound = bound_ms(nbytes(codes, scales, out), B2_OPS_PER_ELEMENT * n)
    res = {
        "qinf_quantize_blocks": {
            "rows": list(x.shape),
            "ms": cuda_ms(torch, lambda: qk.qinf_quantize_blocks(x, u, 2),
                          iters),
            "plain_ms": cuda_ms(
                torch, lambda: ref.qinf_quantize_blocks_ref(x, u, 2), iters),
            "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
            "library_ms": None},
        "qinf_dequantize_blocks": {
            "rows": list(x.shape),
            "ms": cuda_ms(torch, lambda: qk.qinf_dequantize_blocks(codes,
                                                                   scales),
                          iters),
            "plain_ms": cuda_ms(
                torch, lambda: ref.qinf_dequantize_blocks_ref(codes, scales),
                iters),
            "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
            "library_ms": cuda_ms(torch, lambda: torch.mul(codes, scales),
                                  iters)},
    }
    del x, u, codes, scales, out, lib
    return res


def warm_profiler(torch, launches: int = 20) -> None:
    """One unmeasured ``torch.profiler`` window over a few device launches,
    run right after the build: a process's first window once came back
    with no device event at all (CUPTI sets up its activity buffers in
    it), so every window whose events are required comes after this one,
    which requires nothing."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(launches):
            x.add_(1.0)
        torch.cuda.synchronize()
    del x


@contextlib.contextmanager
def profiled(torch):
    """A ``torch.profiler`` window over host and device activities with an
    idle guard of ``PROFILE_GUARD_S`` at each edge, inside which the caller
    fences and times its own work.  The profiler keeps a device event only
    if its time, converted to the host's clock, falls inside the window,
    and on the card that conversion has read up to 4.6 ms behind the host:
    without the guard, 4 of 150 windows of 50 LEAD (2bit) steps lost their
    first 2-62 device events, with the guard none of 150."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)


def device_us(torch, fn, calls: int = MAIN_SHAPE_ITERS):
    """Device time of one call of ``fn`` under ``torch.profiler`` over
    ``calls`` back-to-back calls, each launching the same device
    operations: for every operation name, its median duration times its
    launches a call, summed (us); with the operations a call makes and
    their names.  (The profiler may drop an event at the window's edge,
    so calls are not cut from the event stream one by one.)"""
    import tempfile
    fn()
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            by_name.setdefault(e["name"], []).append(e["dur"])
    per = {k: round(len(v) / calls) for k, v in by_name.items()}
    require(bool(by_name) and all(per.values()),
            f"device operations in {calls} calls: "
            f"{ {k[:60]: len(v) for k, v in by_name.items()} }")
    us = sum(sorted(v)[len(v) // 2] * per[k] for k, v in by_name.items())
    return {"us": us, "ops_per_call": sum(per.values()),
            "names": [k[:90] for k in by_name]}


def b1_at_main_path(torch, ops, qk, ref, iters: int = MAIN_SHAPE_ITERS):
    """B1 as the dense main path calls it: ``ops.qinf_quantize_lastdim`` on
    the (8, 7840) f32 leaf, 2 bits, timed with CUDA events over ``iters``
    back-to-back calls beside its plain version (pad + plain B1) and its
    bytes bound; and device time per call from ``torch.profiler`` (median
    of ``iters`` calls) of that call, of B1 on (248, 256) rows, and of a
    one-kernel PyTorch op on 248 floats (``zero_``), the launch floor."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((8, 7840), generator=g, device="cuda")
    u = torch.rand(ops.blockwise_shape(x.shape, 256), generator=g,
                   device="cuda")
    codes, scales = ops.qinf_quantize_lastdim(x, u, bits=2)

    def plain():
        return ref.qinf_quantize_blocks_ref(
            ops.blockwise_lastdim(x, block=256).reshape(-1, 256),
            u.reshape(-1, 256), 2)

    cp, sp = plain()
    require(torch.equal(codes.reshape(-1, 256), cp)
            and torch.equal(scales.reshape(-1, 1), sp),
            "B1 on the main path's leaf != plain")
    rows = ops.blockwise_lastdim(x, block=256).reshape(-1, 256)
    urows = u.reshape(-1, 256)
    floor = torch.empty(248, device="cuda")
    res = {"leaf": list(x.shape),
           "ms": cuda_ms(torch, lambda: ops.qinf_quantize_lastdim(x, u,
                                                                  bits=2),
                         iters),
           "plain_ms": cuda_ms(torch, plain, iters)}
    res["bound_ms"], res["bound_by"] = bound_ms(
        nbytes(x, u, codes, scales), B1_OPS_PER_ELEMENT * x.numel())
    res["device_us"] = {
        "lastdim_leaf": device_us(
            torch, lambda: ops.qinf_quantize_lastdim(x, u, bits=2), iters),
        "b1_248x256": device_us(
            torch, lambda: qk.qinf_quantize_blocks(rows, urows, 2), iters),
        "launch_floor_zero_248": device_us(torch, floor.zero_, iters)}
    return res


# --- phase 4 -------------------------------------------------------------------

def mnist_spec(api, steps: int):
    """examples/quickstart.py's spec at MNIST scale: 8 x 7500 = 60,000
    samples, 784 features, 10 classes, 15 batches of 500 per node."""
    return api.ExperimentSpec(
        name="quickstart-mnist-scale", n_nodes=8, steps=steps,
        algorithm=api.AlgorithmSpec("prox_lead", eta=api.constant(0.05),
                                    alpha=api.constant(0.5),
                                    gamma=api.constant(1.0)),
        compressor=api.CompressorSpec("qinf", {"bits": 2, "block": 256}),
        topology=api.TopologySpec(graph="ring"),
        prox=api.ProxSpec("l1", {"lam": 0.005}),
        oracle=api.OracleSpec(
            name="saga", problem="logreg",
            problem_params={"n_features": 784, "n_classes": 10,
                            "n_per_node": 7500, "n_batches": 15,
                            "lam2": 0.005}))


def profile_steps(torch, runner, st, draws, steps: int = PROFILE_STEPS,
                  trace_name: str = "main_path_trace.json"):
    """Where a step's time goes: ``torch.profiler`` over ``steps`` steps;
    device time is the sum of the kernel, memcpy and memset spans of the
    exported trace, the busy share that sum over the fenced wall time;
    every device operation by name (time and count a step), B1's launches
    a step and the operations that ran just before them."""
    with profiled(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = runner.step(st, draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    trace = OUT_DIR / trace_name
    prof.export_chrome_trace(str(trace))
    device = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    require(bool(device), "the profiler saw no device work in the main path")
    device.sort(key=lambda e: e["ts"])
    by_name = {}
    for e in device:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    b1 = [i for i, e in enumerate(device) if B1_KERNEL.search(e["name"])]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "busy_share": busy_ms / wall_ms,
            "device_ops_per_step": len(device) / steps,
            "b1_per_step": len(b1) / steps,
            "before_b1": sorted({device[i - 1]["name"] for i in b1 if i}),
            "names": [{"name": k[:90], "us_per_step": ms * 1e3 / steps,
                       "per_step": n / steps}
                      for k, (ms, n) in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][0])]}


def main_path(torch, api, convert, draws_mod, metrics, qk):
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    spec = mnist_spec(api, STEPS)
    lam = spec.prox.params["lam"]

    # (a) the card against the plain CPU path, same draws.  Teacher-forced:
    # every step starts both from the card's state, so one step's rounding
    # (f32 products summed in another order) cannot compound; an element
    # may still differ where a stochastic-rounding code sits on an f32
    # rounding boundary.  The free-running CPU trajectory is reported too.
    t0 = time.perf_counter()
    cpu = api.build(spec, device="cpu")
    runner = api.build(spec)                       # the default: the card
    require(runner.device.type == "cuda", "build(spec) did not pick cuda")
    data_mb = sum(nbytes(t) for t in runner.problem.data.values()) / 2 ** 20
    gen = draws_mod.GeneratorDraws(spec.seed, "cpu")
    rec = draws_mod.RecordingDraws(gen)
    free = cpu.init_state(rec)
    st = runner.init_state(draws_mod.ReplayDraws(rec.record, "cuda"))
    worst_frac = worst_rel = 0.0
    for _ in range(REPLAY_STEPS):
        rec = draws_mod.RecordingDraws(gen)
        want = cpu.step(convert.state_from_arrays(
            convert.state_to_arrays(st), device="cpu", dtype=torch.float32),
            rec)
        free = cpu.step(free, draws_mod.ReplayDraws(rec.record, "cpu"))
        replay = draws_mod.ReplayDraws(rec.record, "cuda")
        st = runner.step(st, replay)
        require(not replay.pending, "the card drew less than the CPU path")
        got = st.X.cpu()
        off = (got - want.X).abs() > REPLAY_ELEM_TOL * want.X.abs().max()
        worst_frac = max(worst_frac, float(off.float().mean()))
        worst_rel = max(worst_rel, float((got - want.X).norm()
                                         / want.X.norm()))
        require(worst_frac <= REPLAY_MAX_OFF,
                f"card vs CPU step {st.k - 1}: {int(off.sum())} of "
                f"{off.numel()} elements of X differ by more than "
                f"{REPLAY_ELEM_TOL} x max|X|")
    drift = float((st.X.cpu() - free.X).norm() / free.X.norm())
    replay_s = time.perf_counter() - t0

    # (b) the main run, counters zeroed just before and read just after
    problem = runner.problem
    trace = []

    def record(state, t):
        f = float(problem.full_loss(state.X))
        r = float(lam * state.X.abs().sum(dim=1).mean())
        trace.append({"step": t + 1, "objective": f + r,
                      "consensus": float(metrics.consensus_error(state.X))})
        return trace[-1]

    torch.cuda.reset_peak_memory_stats()
    qk.reset_launch_counts()
    state, _ = runner.run(num_steps=STEPS, callback=record, log_every=50)
    launches = qk.launch_counts()
    report = runner.last_report
    record(state, STEPS - 1)
    require(all(launches[k] == STEPS for k in ("qinf_quantize_blocks",
                                                "qinf_dequantize_blocks")),
            f"launch counts {launches} != one B1 and one B2 per step for "
            f"{STEPS} steps")
    require(all(math.isfinite(p["objective"]) and math.isfinite(
        p["consensus"]) for p in trace), "non-finite objective/consensus")
    require(bool(torch.isfinite(state.X).all()), "non-finite X")
    require(trace[-1]["objective"] < trace[0]["objective"],
            f"objective did not fall: {trace[0]} -> {trace[-1]}")
    require(trace[-1]["consensus"] < trace[0]["consensus"],
            f"consensus did not shrink: {trace[0]} -> {trace[-1]}")

    # (c) steady-state step time, no callbacks
    d = draws_mod.GeneratorDraws(spec.seed + 1, "cuda")
    st = state
    for _ in range(5):
        st = runner.step(st, d)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(100):
        st = runner.step(st, d)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / 100 * 1e3
    profile = profile_steps(torch, runner, st, d)
    require(profile["b1_per_step"] == 1,
            f"the profile saw {profile['b1_per_step']} B1 launches a step")
    require(not any(PAD_KERNEL.search(n) for n in profile["before_b1"]),
            f"a pad kernel runs just before B1: {profile['before_b1']}")
    return {
        "spec": spec.name, "steps": STEPS, "dtype": "float32",
        "data_mb_on_device": data_mb, "launches": launches,
        "replay": {"steps": REPLAY_STEPS, "elem_tol": REPLAY_ELEM_TOL,
                   "max_off_fraction": REPLAY_MAX_OFF,
                   "worst_off_fraction": worst_frac,
                   "worst_step_rel_fro": worst_rel,
                   "free_running_rel_fro": drift, "seconds": replay_s},
        "trace": trace, "run_report": report.to_dict(),
        "step_ms": step_ms, "profile": profile,
        "bits_per_step": runner.bits_per_step(),
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
    }


# --- phase 4b ------------------------------------------------------------------

def netsim_spec(api, base, steps: int, scenario: bool):
    """``base`` (phase 4's spec) on the netsim engine: the static schedule
    without faults, or the scenario -- markov_drop on the ring (drop 0.2,
    sticky 0.5, 32 rounds) with SCENARIO_FAULTS."""
    topo = (api.TopologySpec(graph="ring", schedule="markov_drop", rounds=32,
                             schedule_params={"drop": 0.2, "sticky": 0.5})
            if scenario else api.TopologySpec(graph="ring"))
    faults = tuple(api.FaultSpec(n, dict(p)) for n, p in SCENARIO_FAULTS
                   ) if scenario else ()
    return dataclasses.replace(
        base, name=base.name + ("-markov-faults" if scenario else "-static"),
        steps=steps, topology=topo, faults=faults,
        execution=api.ExecutionSpec(engine="netsim"))


def recount_bits(mask_log, schedule, rounds, bits_per_edge: int):
    """The bits each round moved, recounted on the host from the masks the
    mixer recorded: the schedule's directed support, less the dropped
    links and the stragglers' sends, times the payload of an edge."""
    import numpy as np
    n = schedule.n
    supp = (np.abs(schedule.W_stack) > 1e-12) & ~np.eye(n, dtype=bool)
    drawn = {k: (e, s) for k, e, s in mask_log}
    out = []
    for k in rounds:
        alive = supp[k % schedule.T_cycle].copy()
        edge, send = drawn[k]
        if edge is not None:
            alive &= edge.cpu().numpy() > 0
        if send is not None:
            alive &= (send.cpu().numpy() > 0)[None, :]
        out.append(int(alive.sum()) * bits_per_edge)
    return out


def netsim_path(torch, api, convert, draws_mod, qk, base=None,
                steps: int = NETSIM_STEPS,
                static_steps: int = NETSIM_STATIC_STEPS,
                replay_steps: int = REPLAY_STEPS,
                timed_steps: int = NETSIM_TIMED_STEPS,
                profile: int = NETSIM_PROFILE_STEPS, device: str = "cuda"):
    """Phase 4b (see the module docstring) on ``base`` (default: phase
    4's spec)."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    base = base or mnist_spec(api, steps)
    lam = base.prox.params["lam"]

    def build(spec):
        return api.build(spec) if on_card else api.build(spec, device=device)

    # (a) static netsim == the dense engine, bit for bit
    static = build(netsim_spec(api, base, static_steps, False))
    dense = build(dataclasses.replace(base, steps=static_steps))
    require(static.device.type == device, f"build did not pick {device}")
    st_n, _ = static.run(draws=draws_mod.GeneratorDraws(base.seed, device))
    st_d, _ = dense.run(draws=draws_mod.GeneratorDraws(base.seed, device))
    for what, a, b in (("X", st_n.X, st_d.X), ("D", st_n.D, st_d.D),
                       ("H", st_n.comm.H, st_d.comm.H),
                       ("Hw", st_n.comm.Hw, st_d.comm.Hw)):
        require(torch.equal(a, b), f"static netsim != dense engine in "
                f"{what} after {static_steps} steps")

    # (b) the scenario, counters zeroed just before and read just after
    spec = netsim_spec(api, base, steps, True)
    runner = build(spec)
    problem = runner.problem

    def objective(X):
        return problem.full_loss(X) + lam * X.abs().sum(dim=1).mean()

    mask_log = []
    qk.reset_launch_counts()
    state, traj = runner.run(objective_fn=objective, mask_log=mask_log)
    launches = qk.launch_counts()
    report = runner.last_report
    require(not on_card or (launches[B1] == steps and launches[B2] == steps),
            f"launch counts {launches} != one B1 and one B2 per step for "
            f"{steps} steps")
    require(all(map(math.isfinite, list(traj.objective)
                    + list(traj.consensus))), "non-finite trajectory")
    require(traj.objective[-1] < traj.objective[0],
            f"objective did not fall: {traj.objective[0]} -> "
            f"{traj.objective[-1]}")
    require(traj.consensus[-1] < traj.consensus[0],
            f"consensus did not shrink: {traj.consensus[0]} -> "
            f"{traj.consensus[-1]}")
    per_edge = traj.meta["bits_per_edge_per_round"]
    recount = recount_bits(mask_log, runner.schedule,
                           range(1, steps + 1), per_edge)
    require(traj.bits.tolist() == recount,
            "trajectory bits != the host recount from the recorded masks")

    # (c) the card against the CPU, each step from the card's state, the
    # card's draws (algorithm and faults) recorded and replayed on the CPU
    cpu = api.build(spec, device="cpu")
    alg = draws_mod.RecordingDraws(draws_mod.GeneratorDraws(base.seed,
                                                            device))
    flt = draws_mod.RecordingDraws(draws_mod.GeneratorDraws(spec.fault_seed,
                                                            device))
    card = runner.with_fault_draws(flt)
    st = card.init(runner.X0, alg)
    worst_frac = worst_rel = 0.0
    for _ in range(replay_steps):
        before = convert.state_to_arrays(st)
        na, nf = len(alg.record), len(flt.record)
        st = card.step(st, alg)
        ad = draws_mod.ReplayDraws([t.cpu() for t in alg.record[na:]], "cpu")
        fd = draws_mod.ReplayDraws([t.cpu() for t in flt.record[nf:]], "cpu")
        want = cpu.with_fault_draws(fd).step(convert.state_from_arrays(
            before, device="cpu", dtype=torch.float32), ad)
        require(not ad.pending and not fd.pending,
                "the CPU path drew less than the card")
        got = st.X.cpu()
        scale = want.X.abs().max()
        off = (got - want.X).abs() > REPLAY_ELEM_TOL * scale
        worst_frac = max(worst_frac, float(off.float().mean()))
        worst_rel = max(worst_rel, float((got - want.X).abs().max() / scale))
        require(worst_frac <= REPLAY_MAX_OFF,
                f"netsim card vs CPU step {st.k - 1}: {int(off.sum())} of "
                f"{off.numel()} elements of X differ by more than "
                f"{REPLAY_ELEM_TOL} x max|X|")

    # (d) ms a step of the three runs, one process; the scenario profiled
    def ms_per_step(r):
        r.run(num_steps=3)                                  # warm-up
        r.run(num_steps=timed_steps)
        return r.last_report.total_s / timed_steps * 1e3

    times = {"dense": ms_per_step(dense), "netsim_static": ms_per_step(
        static), "netsim_scenario": ms_per_step(runner)}
    prof = None
    if profile and on_card:
        d = draws_mod.GeneratorDraws(base.seed + 1, device)
        prof = profile_steps(torch, runner, runner.init_state(d), d,
                             steps=profile, trace_name="netsim_trace.json")
        require(prof["b1_per_step"] == 1,
                f"the profile saw {prof['b1_per_step']} B1 launches a step")
    return {"spec": spec.name, "steps": steps, "launches": launches,
            "static_bit_equal_steps": static_steps,
            "objective": [float(traj.objective[0]),
                          float(traj.objective[-1])],
            "consensus": [float(traj.consensus[0]),
                          float(traj.consensus[-1])],
            "bits_total": traj.total_bits, "bits_first": traj.bits[:8].tolist(),
            "bits_per_edge": per_edge, "bits_recount_equal": True,
            "replay": {"steps": replay_steps, "elem_tol": REPLAY_ELEM_TOL,
                       "max_off_fraction": REPLAY_MAX_OFF,
                       "worst_off_fraction": worst_frac,
                       "worst_rel_max": worst_rel},
            "ms_per_step": times, "profile": prof,
            "run_report": report.to_dict(), "meta": traj.meta}


# --- phase 5 -------------------------------------------------------------------

def b4_ops_per_element(S: int, T: int) -> int:
    """Per output element: per sender decode (shift/mask, offset), cvt,
    scale mul, round-through (2), then a mul and an add per round."""
    return S * (6 + 2 * T)


def check_b3(torch, ref, x, u, bits, got, errs, what: str) -> None:
    """Kernel B3's (packed, scales) against its plain version on the same
    inputs: both equal; the largest difference goes into ``errs``."""
    pk, sk = got
    pr, sr = ref.qinf_quantize_pack_blocks_ref(x, u, bits)
    e3 = max(float((pk.int() - pr.int()).abs().max()),
             float((sk - sr).abs().max()))
    errs["qinf_quantize_pack_blocks"] = max(
        errs["qinf_quantize_pack_blocks"], e3)
    require(torch.equal(pk, pr) and torch.equal(sk, sr),
            f"B3 != plain {what} (max diff {e3})")


def check_b4(torch, ref, P, Sc, w, bits, out, got, errs, what: str) -> None:
    """Kernel B4's (mix, qself) against its plain version on the same
    inputs, node by node (so the plain version's temporaries are one
    node's size): both exactly equal (kernel and plain version sum the
    senders in one order, one rounding per operation); the largest mix
    difference goes into ``errs``."""
    mk, qk_ = got
    for n in range(P.shape[0]):
        nd = slice(n, n + 1)
        mr, qr = ref.qinf_unpack_dequant_mix_blocks_ref(P[nd], Sc[nd], w[nd],
                                                        bits, out)
        e4 = float((mk[nd].double() - mr.double()).abs().max())
        errs["qinf_unpack_dequant_mix_blocks"] = max(
            errs["qinf_unpack_dequant_mix_blocks"], e4)
        require(torch.equal(qk_[nd], qr),
                f"B4 qself != plain {what} (node {n})")
        require(torch.equal(mk[nd], mr),
                f"B4 mix != plain {what} (node {n}, max diff {e4})")
        del mr, qr


def b3_vector_expected(block: int, bits: int, aligned: bool = True) -> bool:
    """The variant B3's launcher must pick (csrc/qinf_wire.cu): the vector
    one for 16-byte aligned x and u whose rows hold U = block / 8 (nibble
    packing, bits <= 3) or block / 4 units, U a power of two up to 32 or
    a multiple of 32 up to block 1024; the row variant otherwise."""
    per_unit = 8 if bits <= 3 else 4
    if not aligned or block % per_unit:
        return False
    units = block // per_unit
    if units <= 32:
        return units & (units - 1) == 0
    return units % 32 == 0 and block <= 1024


def b4_vector_expected(width: int, out_dtype, offset: int = 0) -> bool:
    """The variant B4's launcher must pick (csrc/qinf_wire.cu): the vector
    one when every unit's G = 16 / (bytes of an ``out_dtype`` value) codes
    a half make one 16-byte store -- a payload row of ``width`` bytes, a
    multiple of G, at ``offset`` bytes (a multiple of G) from a 16-byte
    aligned buffer (mix and qself, allocated by the binding, are aligned)
    -- at any sender and round count; the row variant otherwise."""
    G = 16 // out_dtype.itemsize
    return width % G == 0 and offset % G == 0


# B3 alone, (bits, block, x and u storage offsets in f32): the narrow
# widths of the families and the reduced configs (4, 8, 16, 20, 32, 64),
# the vector variant's widest rows (512, 1024) and one past them (2048),
# at every bits the wire takes; then x or u off the 16-byte alignment at
# widths that are otherwise the vector variant's (the cases of
# tests/test_torch_wire_kernels.py's B3 cuda tests)
B3_CASES = ([(bits, block, 0, 0) for bits in range(1, 8)
             for block in (4, 8, 16, 20, 32, 64, 512, 1024, 2048)]
            + [(2, 256, 1, 0), (2, 8, 0, 1), (4, 64, 1, 1), (7, 1024, 1, 0)])


def check_b3_variants(torch, qk, ref, errs, rows=8 * 31 + 5,
                      device="cuda"):
    """B3 against its plain version on every case of :data:`B3_CASES`:
    ``rows`` rows (at blocks 8 to 64 the last warp is not full), row 5
    zero (scale 0, every byte the encoded offset); each case must take
    the variant :func:`b3_vector_expected` names.  Returns (cases, of
    which on the vector variant)."""
    g = torch.Generator(device=device).manual_seed(5)
    n_vector = 0
    for bits, block, x_off, u_off in B3_CASES:
        what = f"at bits={bits} block={block} offsets {x_off}/{u_off}"
        n = rows * block
        x = (torch.randn(n + x_off, generator=g, device=device)
             * 3)[x_off:].view(rows, block)
        x[5] = 0
        u = torch.rand(n + u_off, generator=g,
                       device=device)[u_off:].view(rows, block)
        vector = b3_vector_expected(block, bits,
                                    aligned=x_off % 4 == 0 and u_off % 4 == 0)
        require(device != "cuda" or qk.uses_vector_variant(
            "qinf_quantize_pack_blocks", x, u, bits) is vector,
            f"B3 {what} must take the {'vector' if vector else 'row'} "
            f"variant")
        pk, sk = qk.qinf_quantize_pack_blocks(x, u, bits)
        check_b3(torch, ref, x, u, bits, (pk, sk), errs, what)
        L = 2 ** (bits - 1)
        require(float(sk[5]) == 0.0 and bool(
            (pk[5] == (L | L << 4 if bits <= 3 else L)).all()),
            f"B3 {what}: an all-zero row needs scale 0 and offset codes")
        n_vector += vector
    return len(B3_CASES), n_vector


# (bits, block, S, payload offset in bytes), the B4 variant of each
# output dtype by b4_vector_expected: every bits x block at S = 1, 3, 4
# (4: exponential-8's self + 3 hops) and S = 5, 9 and 17 (past the widest
# sender chunk, 8), the alternating schedule's S = 6 and the MoE routers'
# blocks 8 and 16 (W = 4 and 8 at 2 bits: one and two units a row at f32),
# rows of 20 and 24 bytes and a payload 8 bytes into its buffer on the
# vector variant; then the row variant's shapes -- payload rows no 16-byte
# store serves (block 20 at 2 bits, W = 10; nibble-packed block 4, W = 2;
# W = 6 at 4 bits; the f64 output takes all three on the vector variant)
# and payloads off the alignment (1 and 3 bytes: every dtype; 2: f32 and
# bf16; 4: bf16) -- the cases of tests/test_torch_wire_kernels.py's cuda
# tests
WIRE_CASES = ([(bits, block, S, 0) for bits in (1, 2, 3, 4, 7)
               for block in (128, 256) for S in (1, 3, 4)]
              + [(2, 256, 5, 0), (2, 128, 9, 0), (2, 128, 17, 0),
                 (2, 256, 6, 0), (2, 8, 3, 0), (2, 16, 6, 0), (4, 8, 5, 0),
                 (2, 40, 3, 0), (4, 24, 3, 0), (2, 256, 3, 8)]
              + [(2, 20, 3, 0), (2, 4, 3, 0), (4, 6, 3, 0), (2, 256, 3, 1),
                 (4, 128, 4, 3), (2, 256, 6, 2), (4, 128, 4, 4)])
# rounds T of every WIRE_CASES case: 3 and 9 are past the widest round
# chunk (2 rounds)
WIRE_ROUNDS = (1, 3, 9)


def check_wire_kernels(torch, qk, ref, errs, n_nodes=2, rows=8 * 31 + 5,
                       device="cuda"):
    """B3/B4 vs their plain versions on every case of :data:`WIRE_CASES`,
    T (rounds) in :data:`WIRE_ROUNDS`, f32/bf16/f64 out, a ragged row
    count, a block of zeros; each B4 call on the variant
    :func:`b4_vector_expected` names; records the largest difference per
    kernel in ``errs``.  Returns (B4 cases, of which on the vector
    variant)."""
    g = torch.Generator(device=device).manual_seed(2)
    n_checked = n_vector = 0
    for bits, block, S, offset in WIRE_CASES:
        what = f"at bits={bits} block={block} S={S} offset={offset}"
        x = torch.randn((n_nodes * S * rows, block), generator=g,
                        device=device) * 3
        x[5] = 0
        u = torch.rand(x.shape, generator=g, device=device)
        b3_vector = b3_vector_expected(block, bits)
        require(device != "cuda" or qk.uses_vector_variant(
            "qinf_quantize_pack_blocks", x, u, bits) is b3_vector,
            f"B3 {what} must take the "
            f"{'vector' if b3_vector else 'row'} variant")
        pk, sk = qk.qinf_quantize_pack_blocks(x, u, bits)
        check_b3(torch, ref, x, u, bits, (pk, sk), errs, what)
        require(float(sk[5]) == 0.0, "an all-zero block needs scale 0")
        buf = torch.empty(pk.numel() + offset, dtype=torch.uint8,
                          device=device)
        P = buf[offset:].view(n_nodes, S, rows, -1)
        P.copy_(pk.view(n_nodes, S, rows, -1))
        Sc = sk.reshape(n_nodes, S, rows, 1)
        for T in WIRE_ROUNDS:
            w = torch.randn((n_nodes, T, S), generator=g, device=device)
            for out in (torch.float32, torch.bfloat16, torch.float64):
                got = qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, bits, out)
                vector = b4_vector_expected(P.shape[-1], out, offset)
                require(device != "cuda" or qk.uses_vector_variant(
                    "qinf_unpack_dequant_mix_blocks", P, *got) is vector,
                    f"B4 {what} {out} must take the "
                    f"{'vector' if vector else 'row'} variant")
                check_b4(torch, ref, P, Sc, w, bits, out, got, errs,
                         f"{what} T={T} {out}")
                n_checked += 1
                n_vector += vector
        del x, u, pk, sk, buf, P, Sc
    return n_checked, n_vector


def ring_payloads(torch, packed, scales, n_nodes: int, group_rows: int,
                  shift: int = 1):
    """What B4 gets on a ring: each node's own payload (sender 0) and
    those of its two neighbours, node-stacked (N, 3, rows, W) and
    (N, 3, rows, 1).  With M model shards a node the N rows are shard
    rows and a neighbour is ``shift`` = M rows away."""
    p = packed.reshape(n_nodes, group_rows, -1)
    s = scales.reshape(n_nodes, group_rows, 1)
    return (torch.stack([p, p.roll(shift, 0), p.roll(-shift, 0)],
                        1).contiguous(),
            torch.stack([s, s.roll(shift, 0), s.roll(-shift, 0)],
                        1).contiguous())


def wire_kernels_at_slice_shape(torch, qk, ref, errs,
                                group_rows=SLICE_GROUP_ROWS, n_nodes=8,
                                small_rows=SLICE_SMALL_GROUP_ROWS,
                                plain_iters=5, device="cuda"):
    """B3/B4 at the shapes the trainer path gives them, held against their
    plain versions on the same inputs and timed: the block-256 group
    (n_nodes x group_rows rows) and the block-128 q_norm/k_norm group
    (n_nodes x small_rows rows), bits 2, ring payloads (S = 3: self + 2
    hops), T = 1, weights 1/3, f32 out.  B3's bytes and scales and B4's
    qself and mix must be equal; the largest differences go into
    ``errs``.  Times are of the block-256 group, B3's on both variants:
    the vector one on x and u as allocated, the row one on views of the
    same buffers one f32 further on (off the 16-byte alignment), checked
    too, in turns (vector, row, row, vector; each variant's mean).  No
    single PyTorch call computes either function (library: none)."""
    g = torch.Generator(device=device).manual_seed(3)
    w = torch.full((n_nodes, 1, 3), 1.0 / 3.0, device=device)
    checked = []
    for block, rows_ in ((128, small_rows), (256, group_rows)):
        what = f"at the trainer's block-{block} group ({n_nodes} x {rows_})"
        R = n_nodes * rows_
        bx = torch.randn(R * block + 1, generator=g, device=device)
        bu = torch.rand(R * block + 1, generator=g, device=device)
        x, u = bx[:-1].view(R, block), bu[:-1].view(R, block)
        require(device != "cuda" or qk.uses_vector_variant(
            "qinf_quantize_pack_blocks", x, u, 2),
            f"B3 {what} must take the vector variant")
        packed, scales = qk.qinf_quantize_pack_blocks(x, u, 2)
        check_b3(torch, ref, x, u, 2, (packed, scales), errs, what)
        if block == 256:
            xo, uo = bx[1:].view(R, block), bu[1:].view(R, block)
            require(device != "cuda" or not qk.uses_vector_variant(
                "qinf_quantize_pack_blocks", xo, uo, 2),
                f"B3 {what}, one f32 off, must take the row variant")
            check_b3(torch, ref, xo, uo, 2,
                     qk.qinf_quantize_pack_blocks(xo, uo, 2), errs,
                     f"{what}, one f32 off (row variant)")
            runs = {"vector": (x, u), "row": (xo, uo)}
            ms = {"vector": [], "row": []}
            for v in ("vector", "row", "row", "vector"):
                ms[v].append(cuda_ms(
                    torch, lambda: qk.qinf_quantize_pack_blocks(*runs[v], 2)))
            b3 = {"rows": [R, 256], "variant": "vector",
                  "ms": sum(ms["vector"]) / 2,
                  "row_variant_ms": sum(ms["row"]) / 2,
                  "plain_ms": cuda_ms(
                      torch, lambda: ref.qinf_quantize_pack_blocks_ref(
                          x, u, 2), iters=plain_iters, warmup=1)}
            b3["bound_ms"], b3["bound_by"] = wire_bound(
                torch, "B3", block, rows_, n_nodes,
                nbytes(x, u, packed, scales),
                ops=B3_OPS_PER_ELEMENT * x.numel())
            b3["library_ms"] = None
            del xo, uo, runs
        del x, u, bx, bu
        P, Sc = ring_payloads(torch, packed, scales, n_nodes, rows_)
        del packed, scales
        mix, qself = qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, 2)
        require(device != "cuda" or qk.uses_vector_variant(
            "qinf_unpack_dequant_mix_blocks", P, mix, qself),
            f"B4 {what} must take the vector variant")
        check_b4(torch, ref, P, Sc, w, 2, torch.float32, (mix, qself), errs,
                 what)
        checked.append({"block": block, "rows": [n_nodes, 3, rows_, block],
                        "mix_bit_equal": True})
        if block == 256:
            b4 = {"rows": [n_nodes, 3, rows_, 256], "variant": "vector",
                  "ms": cuda_ms(torch, lambda: qk.qinf_unpack_dequant_mix_blocks(
                      P, Sc, w, 2)),
                  "plain_ms": cuda_ms(
                      torch, lambda: ref.qinf_unpack_dequant_mix_blocks_ref(
                          P, Sc, w, 2), iters=plain_iters, warmup=1)}
            b4["bound_ms"], b4["bound_by"] = wire_bound(
                torch, "B4", block, rows_, n_nodes,
                nbytes(P, Sc, w, mix, qself), nbytes(w),
                ops=b4_ops_per_element(3, 1) * qself.numel())
            b4["library_ms"] = None
        del P, Sc, mix, qself
        if device == "cuda":
            torch.cuda.empty_cache()
    return {"qinf_quantize_pack_blocks": b3,
            "qinf_unpack_dequant_mix_blocks": b4}, checked


def alternating_payloads(torch, qk, group_rows=SLICE_GROUP_ROWS, n_nodes=8,
                         device="cuda"):
    """What B4 gets at the scheduled trainer's block-256 group, 2 bits:
    T = 2 rounds and S = 6 senders -- self and the five hops of the
    ring/exponential union, each hop's payload the circulant shift of
    every node's (B3's on random rows), the plan's receiver weights
    (``optim.wire.node_weights``).  Returns (P, Po, Sc, w): the payload P
    (n_nodes, S, group_rows, 128) and Po of the same shape one byte
    further into P's buffer (off the alignment), scales, weights."""
    import numpy as np
    from repro_torch.core import topology as topo_mod
    from repro_torch.netsim import make_schedule
    from repro_torch.optim.wire import node_weights
    sched = make_schedule("alternating", n_nodes)
    plan = topo_mod.compile_plan(sched.W_stack, name=sched.name)
    wmat = np.concatenate([plan.self_weights(np.float32)[None]]
                          + [h.weights[None] for h in plan.hops], 0)
    w = node_weights(wmat.astype(np.float32), device)
    require(tuple(w.shape[1:]) == (2, SCHEDULED_HOPS + 1),
            f"(T, S) = {tuple(w.shape[1:])}")
    g = torch.Generator(device=device).manual_seed(4)
    R = n_nodes * group_rows
    x = torch.randn((R, 256), generator=g, device=device)
    u = torch.rand((R, 256), generator=g, device=device)
    packed, scales = qk.qinf_quantize_pack_blocks(x, u, 2)
    del x, u
    p = packed.reshape(n_nodes, group_rows, -1)
    s = scales.reshape(n_nodes, group_rows, 1)
    shape = (n_nodes, len(plan.hops) + 1, group_rows, p.shape[-1])
    buf = torch.empty(math.prod(shape) + 1, dtype=torch.uint8, device=device)
    P, Po = buf[:-1].view(shape), buf[1:].view(shape)
    P.copy_(torch.stack([p] + [p.roll(h.shift, 0) for h in plan.hops], 1))
    Sc = torch.stack([s] + [s.roll(h.shift, 0) for h in plan.hops],
                     1).contiguous()
    return P, Po, Sc, w


def b4_at_alternating_schedule(torch, qk, ref, errs,
                               group_rows=SLICE_GROUP_ROWS, n_nodes=8,
                               plain_iters=3, device="cuda"):
    """B4 at the scheduled trainer's block-256 group
    (:func:`alternating_payloads`: T = 2, S = 6), 2 bits, f32 out, on both
    its variants: the vector one on the payload as allocated, the row one
    on the view one byte further on, each held to the plain version (mix
    and qself equal) and timed with CUDA events in turns (vector, row,
    row, vector; each variant's mean).  The bound: payload, scales,
    weights, mix and qself moved once."""
    P, Po, Sc, w = alternating_payloads(torch, qk, group_rows, n_nodes,
                                        device)
    T, S = w.shape[1], w.shape[2]
    what = f"at T={T} S={S} ({n_nodes} x {group_rows} rows of 256)"
    runs = {"vector": P, "row": Po}
    for v, Pv in runs.items():
        mix, qself = qk.qinf_unpack_dequant_mix_blocks(Pv, Sc, w, 2)
        require(device != "cuda" or qk.uses_vector_variant(
            "qinf_unpack_dequant_mix_blocks", Pv, mix, qself) is (
                v == "vector"), f"B4 {what}, payload offset "
            f"{Pv.data_ptr() - P.data_ptr()} B, must take the {v} variant")
        check_b4(torch, ref, Pv, Sc, w, 2, torch.float32, (mix, qself), errs,
                 f"{what} ({v} variant)")
    out = {"rows": [n_nodes, S, group_rows, 256], "T": T, "S": S,
           "variant": "vector"}
    out["bound_ms"], out["bound_by"] = wire_bound(
        torch, "B4", 256, group_rows, n_nodes, nbytes(P, Sc, w, mix, qself),
        nbytes(w), hops=S - 1, receivers=T,
        ops=b4_ops_per_element(S, T) * qself.numel())
    out["bound_gb"] = nbytes(P, Sc, w, mix, qself) / 1e9
    del mix, qself
    ms = {"vector": [], "row": []}
    for v in ("vector", "row", "row", "vector"):
        ms[v].append(cuda_ms(torch, lambda: qk.qinf_unpack_dequant_mix_blocks(
            runs[v], Sc, w, 2)))
    out["ms"], out["row_variant_ms"] = (sum(ms["vector"]) / 2,
                                        sum(ms["row"]) / 2)
    out["plain_ms"] = cuda_ms(
        torch, lambda: ref.qinf_unpack_dequant_mix_blocks_ref(P, Sc, w, 2),
        iters=plain_iters, warmup=1)
    out["library_ms"] = None
    del P, Po, Sc, runs
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# --- phase 6 -------------------------------------------------------------------

def slice_spec(api, steps: int, *, full: bool = True, n_layers: int = 2,
               d_model: int = 2048, seq_len: int = 512,
               schedule: str = "static", backend: str = "neighbor",
               params=None):
    """The slice's trainer configuration: qwen3-1.7b (hf:Qwen/Qwen3-8B
    family card) at its published widths, depth cut to 2 of 28 layers and
    the vocabulary to its first eighth (18,992, padded 19,200) so that 8
    replicas fit one card; 8 nodes on a ring (or ``schedule`` over it),
    2-bit QInf in 256-blocks on the bucketed neighbor wire, the train.py
    step sizes.  ``full=False`` is the reduced (smoke) model for the
    card-vs-CPU check; ``backend`` and ``params`` (TrainerConfig fields)
    as in ``ExecutionSpec``."""
    model = (api.ModelSpec(arch="qwen3-1.7b", full=True, local_batch=2,
                           seq_len=seq_len,
                           params={"n_layers": n_layers, "vocab": 18992})
             if full else
             api.ModelSpec(arch="qwen3-1.7b", full=False, n_layers=n_layers,
                           d_model=d_model, local_batch=2, seq_len=seq_len))
    return api.ExperimentSpec(
        name=("qwen3-1.7b-2L-vocab8-ring8-qinf2" if full else
              "qwen3-smoke-ring8-qinf2")
        + ("" if schedule == "static" else f"-{schedule}")
        + ("" if backend == "neighbor" else f"-{backend}")
        + "".join(f"-{k}{v}" for k, v in sorted((params or {}).items())),
        n_nodes=8, steps=steps,
        algorithm=api.AlgorithmSpec("prox_lead", eta=api.constant(0.05),
                                    alpha=api.constant(0.5),
                                    gamma=api.constant(1.0)),
        compressor=api.CompressorSpec("qinf", {"bits": 2, "block": 256}),
        topology=api.TopologySpec(graph="ring", schedule=schedule),
        model=model,
        execution=api.ExecutionSpec(engine="sharded", backend=backend,
                                    wire_mode="bucketed",
                                    params=params or {}))


def wire_breakdown(events, steps: int):
    """Device ms a step of each part of the exchange: a device op belongs
    to the innermost of the program's ``wire/`` phases around its launch
    on the host (the ``cuda_runtime`` event of the same correlation id;
    the phases are ``record_function`` ranges while a profiler runs,
    ``repro_torch.obs.trace.phase``).  Parts: noise, pack, hops, stack
    and mix, each with its ops by name (an op launched in the exchange
    outside them is its own part, exchange)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("wire/"))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    parts = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        inside = [sp for sp in spans if t is not None and sp[0] <= t <= sp[1]]
        if not inside:
            continue
        part = min(inside, key=lambda sp: sp[1] - sp[0])[2][len("wire/"):]
        by_name = parts.setdefault(part, {})
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return {part: {"ms_per_step": sum(ms for ms, _ in ops.values()) / steps,
                   "ops": [{"name": k[:90], "ms_per_step": ms / steps,
                            "per_step": n / steps} for k, (ms, n) in sorted(
                                ops.items(), key=lambda kv: -kv[1][0])]}
            for part, ops in parts.items()}


def profile_trainer(torch, runner, st, data, draws, steps: int,
                    trace_name: str = "slice_trace.json"):
    """torch.profiler over ``steps`` trainer steps: device busy share,
    device time by kernel and the wire's share (:func:`wire_breakdown`;
    the trace written to OUT_DIR / ``trace_name``)."""
    t_first = int(st.step)
    with profiled(torch) as prof:
        t0 = time.perf_counter()
        for t in range(t_first, t_first + steps):
            st, _ = runner.step(st, data.batch_at(t), draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    trace = OUT_DIR / trace_name
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    require(bool(device), "the profiler saw no device work in the trainer")
    by_name = {}
    for e in device:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    wire_parts = wire_breakdown(events, steps)
    require(bool(wire_parts), "the profile saw no device work of the wire")
    return st, {"steps": steps, "wall_ms_per_step": wall_ms / steps,
                "device_ms_per_step": busy_ms / steps,
                "busy_share": busy_ms / wall_ms,
                "device_ops_per_step": len(device) / steps,
                "top": [{"name": k[:90], "ms_per_step": ms / steps,
                         "per_step": n / steps} for k, (ms, n) in top],
                "wire": wire_parts,
                "wire_ms_per_step": sum(p["ms_per_step"]
                                        for p in wire_parts.values())}


def print_wire_share(tag: str, pf) -> None:
    """The wire's device ms a step and its parts, from a trainer profile."""
    print(f"{tag} wire: {pf['wire_ms_per_step']:.3f} ms/step of "
          f"{pf['device_ms_per_step']:.1f} on the device "
          f"({pf['wire_ms_per_step'] / pf['device_ms_per_step']:.1%})",
          flush=True)
    for part, v in pf["wire"].items():
        print(f"{tag}   {part}: {v['ms_per_step']:.3f} ms/step: " + "; ".join(
            f"{o['ms_per_step']:.3f} x{o['per_step']:.0f} {o['name'][:60]}"
            for o in v["ops"][:4]), flush=True)


def held_out_loss(torch, runner, X, data, n_batches: int = 2) -> float:
    """Mean node loss of parameters X (the state's rows: rank-rows on a
    tensor-parallel node) on batches the run never trains on (forward
    only)."""
    total = 0.0
    for i in range(n_batches):
        b = data.batch_at(1_000_000 + i)
        total += float(runner.trainer.node_losses(X, b).mean())
    return total / n_batches


def contracts_and_roofline(torch, runner, held, data, draws, hops: int,
                           bits_per_hop: int, step_s: float):
    """One trainer at its own width, from the state in ``held`` (a list;
    the state is popped and consumed): (1) the contract audit of one step
    (``repro_torch.check.contracts``: the second of two, under
    ``set_sync_debug_mode("error")`` on the card): 2 x ``hops`` u8 ``pp``
    calls, each hop's pair ``bits_per_hop`` / 8 bytes a node, no f64 op,
    no host read; (2) ``repro_torch.obs.roofline.analyze`` over two more
    steps: the analytic compute, memory and link terms beside the
    FlopCounterMode FLOPs and ATen bytes of the second, the median
    measured step ``step_s`` and ``mfu`` = model FLOPs / (``step_s`` x
    PEAK_FLOPS)."""
    from repro_torch import tree
    from repro_torch.check import contracts
    from repro_torch.obs import roofline
    tr, spec = runner.trainer, runner.spec
    state = held.pop()
    leaves = [torch.empty(x.shape, dtype=x.dtype, device="meta")
              for x in tree.leaves(state.plead.X)]
    holder = [state]
    del state
    facts, state = contracts.trainer_step_facts(
        runner, state=holder.pop(), data=data, draws=draws)
    findings = contracts.audit_trainer(runner, spec.name, facts, leaves)
    failed = [f for f in findings if f[1] is not True]
    require(not failed and state is not None,
            f"contracts of {spec.name}: {failed}")
    pairs = [facts.calls[i][1] + facts.calls[i + 1][1]
             for i in range(0, len(facts.calls), 2)]
    require(len(facts.calls) == 2 * hops
            and pairs == [bits_per_hop // 8] * hops,
            f"{spec.name}: pp calls {facts.calls}, want {hops} pairs of "
            f"{bits_per_hop // 8:,} B a node")
    holder = [state]
    del state
    rf = roofline.analyze(runner, tr.mcfg, roofline.train_shape(spec),
                          spec.n_nodes, state=holder.pop(), data=data,
                          draws=draws)
    out = dict(rf.as_dict(), measured_step_s=step_s,
               tp_bytes=rf.tp_bytes, tp_breakdown=rf.tp_breakdown,
               mfu=rf.model_flops_per_chip / (step_s * roofline.PEAK_FLOPS),
               counted_to_analytic_flops=rf.hlo_flops / rf.flops_per_chip,
               aten_bytes_ms=rf.hlo_bytes / roofline.HBM_BW * 1e3)
    return {"roofline": out,
            "contracts": {"findings": findings,
                          "pp_calls": [[str(d), b] for d, b in facts.calls],
                          "reads": [list(r) for r in facts.reads]}}


def print_contracts_and_roofline(tag: str, tp, smi: str) -> None:
    """The ``[contracts]`` and ``[roofline]`` lines of a trainer."""
    c, r, w = tp["contracts"], tp["roofline"], tp["run_report"]["roofline"]
    calls = c["pp_calls"]
    print(f"[contracts] {tag} {tp['spec']}: {len(calls)} pp calls a step, "
          f"{sorted({d for d, _ in calls})}, {sum(b for _, b in calls):,} B "
          f"a node ({calls[0][1]:,} + {calls[1][1]:,} a hop); "
          + "; ".join(f"{'PASS' if ok else 'FAIL'} {cl.split(': ', 1)[1]}"
                      for cl, ok, _ in c["findings"])
          + " (set_sync_debug_mode error)", flush=True)
    print(f"[roofline] {tag} {tp['spec']}: t_compute "
          f"{r['t_compute_s'] * 1e3:.2f} ms, t_memory "
          f"{r['t_memory_s'] * 1e3:.2f} ms, t_collective "
          f"{r['t_collective_s'] * 1e3:.3f} ms, bottleneck "
          f"{r['bottleneck']}; measured {r['measured_step_s'] * 1e3:.1f} ms "
          f"(median); mfu {r['mfu']:.4f}; counted/analytic FLOPs "
          f"{r['counted_to_analytic_flops']:.4f} ({r['hlo_flops_raw']:.4e} / "
          f"{r['flops_per_chip']:.4e}); ATen bytes {r['hlo_bytes_raw']:.4e} "
          f"({r['aten_bytes_ms']:.2f} ms at HBM_BW); wire (report) "
          f"predicted {w['predicted_step_s'] * 1e3:.3f} ms = kernels "
          f"{w['predicted_kernel_s'] * 1e3:.3f} + link "
          f"{w['predicted_wire_s'] * 1e3:.3f}, {w['utilization']:.4f} of "
          f"the run's mean step | {smi}", flush=True)


def trainer_path(torch, api, draws_mod, qk, steps: int = SLICE_STEPS,
                 profile_steps: int = SLICE_PROFILE_STEPS, spec=None,
                 device: str = "cuda", hops: int = 2,
                 bits_per_hop: int = SLICE_BITS_PER_HOP,
                 trace_name: str = "slice_trace.json", peak_limit_gb=None,
                 tp=None, audit: bool = True):
    """The slice's trainer on the card through api.build(spec) (with a
    ``tp`` seam: ``api.build_trainer_runner(spec, tp=tp)``, a
    tensor-parallel node); ``hops``: the exchange plan's (2 on the ring,
    5 under the alternating schedule); at full width ``bits_per_step``
    must be hops x ``bits_per_hop``; ``peak_limit_gb``: the peak
    allocation must stay below it; ``audit``: the contracts and roofline
    of two more steps (:func:`contracts_and_roofline`)."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    spec = spec or slice_spec(api, steps)
    t0 = time.perf_counter()
    if tp is not None:
        runner = api.build_trainer_runner(spec, device=device, tp=tp)
    else:
        runner = api.build(spec) if device == "cuda" else api.build(
            spec, device=device)
    require(runner.device.type == device, f"build(spec) did not pick "
            f"{device}")
    tr = runner.trainer
    cfg = tr.mcfg
    bits = runner.bits_per_step()
    require(len(tr.plan.hops) == hops, f"{len(tr.plan.hops)} hops, not "
            f"{hops}")
    if spec.model.full:
        require(bits == hops * bits_per_hop,
                f"bits_per_step {bits} != {hops} hops x {bits_per_hop:,}")
    layout_groups = len(tr.wire_layout().groups)
    data = runner.default_data()
    draws = draws_mod.GeneratorDraws(spec.seed, runner.device)
    trace = []
    stamps = [time.perf_counter()]

    def record(state, metrics, t):
        trace.append({"step": t + 1, "loss": float(metrics["loss"]),
                      "consensus": float(metrics["consensus"])})
        stamps.append(time.perf_counter())
        return trace[-1]

    init = [runner.init_state()]          # handed over: nothing else holds it
    held_out = [held_out_loss(torch, runner, init[0].plead.X, data)]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    qk.reset_launch_counts()
    state, _ = runner.run(num_steps=steps, data=data, draws=draws,
                          state=init.pop(), callback=record, log_every=1)
    launches = qk.launch_counts()
    report = runner.last_report
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)
    require(launches["qinf_quantize_pack_blocks"] == steps * layout_groups
            and launches["qinf_unpack_dequant_mix_blocks"]
            == steps * layout_groups or device != "cuda",
            f"launch counts {launches} != one B3 and one B4 per bucket group "
            f"({layout_groups}) per step for {steps} steps")
    # B5 and B6 once an f32 leaf a step where the update's views are the
    # leaves
    from repro_torch import tree as tree_mod
    tr = runner.trainer
    fused = steps * sum(x.dtype == torch.float32
                        for x in tree_mod.leaves(state.plead.X)) \
        if tr._fused_prox(tr.tcfg.eta) is not None else 0
    require(device != "cuda" or launches["proxlead_head"]
            == launches["proxlead_tail"] == fused,
            f"launch counts {launches}: want {fused} of B5 and of B6")
    require(all(math.isfinite(p["loss"]) and math.isfinite(p["consensus"])
                for p in trace), "non-finite loss/consensus")
    # one step's loss moves by a few 1e-2 with its batch, and the first
    # steps add the 2-bit compression error of the whole model (H = 0), so
    # "start" and "end" are means over LOSS_WINDOW steps
    first = sum(p["loss"] for p in trace[:LOSS_WINDOW]) / LOSS_WINDOW
    last = sum(p["loss"] for p in trace[-LOSS_WINDOW:]) / LOSS_WINDOW
    require(last < first, f"loss did not fall: mean of the first "
            f"{LOSS_WINDOW} steps {first} -> of the last {last}")
    held_out.append(held_out_loss(torch, runner, state.plead.X, data))
    step_s = sorted(b - a for a, b in zip(stamps[1:], stamps[2:]))
    require(peak_limit_gb is None or peak < peak_limit_gb,
            f"peak {peak:.2f} GiB allocated, not below {peak_limit_gb}")
    profile = None
    if profile_steps and device == "cuda":
        state, profile = profile_trainer(torch, runner, state, data, draws,
                                         profile_steps, trace_name)
    held = [state]
    del state
    audited = contracts_and_roofline(
        torch, runner, held, data, draws, hops, int(bits) // hops,
        step_s[len(step_s) // 2] if step_s else report.s_per_step) \
        if audit else {"roofline": None, "contracts": None}
    return {**audited, "spec": spec.name, "steps": steps,
            "dtype": str(cfg.dtype),
            "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                       "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                       "padded_vocab": cfg.padded_vocab,
                       "params_per_node": cfg.param_count(),
                       "n_nodes": spec.n_nodes,
                       "local_batch": spec.model.local_batch,
                       "seq_len": spec.model.seq_len},
            "bucket_groups": layout_groups, "launches": launches,
            "hops": hops, "hw_slots": tr.hw_slots or 1,
            "trace": trace, "run_report": report.to_dict(),
            "setup_s": setup_s,
            "step_ms_median": 1e3 * step_s[len(step_s) // 2] if step_s
            else None,
            "step_ms_min": 1e3 * step_s[0] if step_s else None,
            "profile": profile, "bits_per_step": bits,
            "loss_first_window": first, "loss_last_window": last,
            "held_out_loss": held_out, "peak_mem_gb": peak}


# --- phase 7 -------------------------------------------------------------------

class RecordingPP:
    """The one-card exchange seam, keeping what each hop-0 call sent."""

    def __init__(self, pp, hops: int):
        self.pp, self.hops, self.sent, self.calls = pp, hops, [], 0

    def __call__(self, x, pairs):
        if (self.calls // 2) % self.hops == 0:
            self.sent.append(x)
        self.calls += 1
        return self.pp(x, pairs)


def bucketed_vs_per_leaf(torch, api, draws_mod, wire, ref, device="cuda",
                         spec=None):
    """The same diffs and noise through the bucketed and the per-leaf wire
    at the slice's widths, on blocks/w_gate (whole), embed and
    blocks/q_norm: codes, scales and qself equal, mix within the bound."""
    spec = spec or slice_spec(api, 1)
    tr = (api.build(spec) if device == "cuda"
          else api.build(spec, device=device)).trainer
    from repro_torch import tree
    from repro_torch.core import bucket
    from repro_torch.models import transformer as TR
    shapes = dict(zip(*_named_leaves(tree, TR.abstract_params(tr.mcfg))))
    names = ["blocks/q_norm", "blocks/w_gate", "embed"]
    g = torch.Generator(device=device).manual_seed(4)
    N = spec.n_nodes
    diffs = [torch.randn((N,) + tuple(shapes[n].shape), generator=g,
                         device=device) * 0.01 for n in names]
    hop_pairs = [list(h.pairs) for h in tr.plan.hops]
    wx = wire.WireExchange(bits=tr.tcfg.bits, block=tr.tcfg.block,
                           block_for=tr._quant_block)
    layout = wx.layout(wx.local_shapes(diffs), [d.dtype for d in diffs])
    rec = draws_mod.RecordingDraws(draws_mod.GeneratorDraws(5, device))
    pp_b = RecordingPP(wire.stacked_pp, len(hop_pairs))
    wq_b, qs_b = wx.bucketed(bucket.RowTables.from_leaves(layout, diffs),
                             rec, tr._wmat, hop_pairs, pp_b)
    pp_p = RecordingPP(wire.stacked_pp, len(hop_pairs))
    wq_p, qs_p = wx.per_leaf(diffs, draws_mod.ReplayDraws(rec.record, device),
                             tr._wmat, hop_pairs, pp_p)
    del rec
    bits = tr.tcfg.bits
    cw, sw = pp_b.sent
    codes_b, scales_b = [], []
    for g_ in layout.groups:
        seg = cw[:, g_.codes_offset: g_.codes_offset
                 + g_.rows * g_.packed_width].reshape(N, g_.rows, -1)
        rows = ref.unpack_codes_halves_ref(seg, bits)
        sc = sw[:, g_.scales_offset: g_.scales_offset + g_.rows * 4
                ].reshape(N, g_.rows, 4).contiguous().view(torch.float32)
        for i in g_.leaf_indices:
            sl = layout.slots[i]
            codes_b.append((i, rows[:, sl.row_offset: sl.row_offset
                                    + sl.rows]))
            scales_b.append((i, sc[:, sl.row_offset: sl.row_offset
                                   + sl.rows]))
    codes_b, scales_b = dict(codes_b), dict(scales_b)
    out = {"leaves": {n: list(d.shape) for n, d in zip(names, diffs)},
           "mix_max_abs_diff": 0.0, "mix_exact": True}
    from repro_torch.kernels import ops
    for i, d in enumerate(diffs):
        packed, s_wire = pp_p.sent[2 * i], pp_p.sent[2 * i + 1]
        blk = layout.slots[i].block
        codes_p = ops.unpack_codes_lastdim(packed, bits=bits).reshape(
            N, -1, blk)
        require(torch.equal(codes_p, codes_b[i]),
                f"bucketed and per-leaf codes differ on {names[i]}")
        require(torch.equal(s_wire.contiguous().view(torch.float32).reshape(
            N, -1, 1), scales_b[i]),
            f"bucketed and per-leaf scales differ on {names[i]}")
        require(torch.equal(qs_b[i], qs_p[i]),
                f"bucketed and per-leaf qself differ on {names[i]}")
        diff = (wq_b[i] - wq_p[i]).abs()
        S = 1 + len(hop_pairs)
        q_abs = qs_p[i].abs().amax()
        bound = (S + 1) * torch.finfo(torch.float32).eps * float(q_abs) * \
            float(tr._wmat.abs().sum(0).max())
        out["mix_max_abs_diff"] = max(out["mix_max_abs_diff"],
                                      float(diff.max()))
        out["mix_exact"] &= bool(torch.equal(wq_b[i], wq_p[i]))
        require(float(diff.max()) <= bound,
                f"bucketed and per-leaf mixes differ on {names[i]} by "
                f"{float(diff.max())} > {bound}")
    out["bytes_per_hop_per_node"] = int(sum(int(x[0].numel())
                                            for x in pp_b.sent))
    require(out["bytes_per_hop_per_node"] == layout.wire_bits // 8,
            "the bucketed wire moved other bytes than its layout")
    return out


def _named_leaves(tree, params):
    """(['blocks/q_norm', ...], leaves) in leaf order."""
    names = []

    def walk(d, prefix):
        for k in sorted(d):
            if isinstance(d[k], dict):
                walk(d[k], prefix + k + "/")
            else:
                names.append(prefix + k)

    walk(params, "")
    return names, tree.leaves(params)


# --- phase 8 -------------------------------------------------------------------

def trainer_card_vs_cpu(torch, api, convert, draws_mod, tree,
                        steps: int = REPLAY_STEPS_SLICE, device="cuda",
                        spec=None, qk=None, rounding_floors: bool = False,
                        elem_tol: float = REPLAY_ELEM_TOL, **variant):
    """The small trainer, one step at a time from the card's state: the
    CPU path draws, the card replays; X, D, H, Hw compared.  ``variant``
    (``schedule``, ``backend``, ``params``) goes to ``slice_spec`` unless
    a ``spec`` is given; under fault injection the CPU path's fault draws
    are replayed too, each step's over a fresh fault stream on the card.
    With ``qk`` the launch counters are zeroed before the first step and
    read after the last: on the card B3 and B4 launch once per bucket
    group a step (the CPU path launches nothing).  ``rounding_floors``
    (the other families): a leaf that is zero up to rounding (at most 1e-6
    of its state tree's largest entry: whisper's key biases, whose
    gradient is 0) is compared at the tree's largest entry, and D at least
    at gamma / (2 eta) x max|X| of the leaf (D is that factor times a
    difference of two X-sized mixes, which cancels where a leaf's replicas
    are nearly equal, as RG-LRU's ones-initialised ``lam``).  An element
    agrees within ``elem_tol`` x the scale; the fraction off at 1e-4,
    3e-4 and 1e-3 is reported too."""
    spec = spec or slice_spec(api, steps, full=False, n_layers=1,
                              d_model=256, seq_len=64, **variant)
    cpu = api.build(spec, device="cpu")
    card = api.build(spec) if device == "cuda" else api.build(
        spec, device=device)
    data = cpu.default_data()
    gen = draws_mod.GeneratorDraws(spec.seed, "cpu")
    faulty = bool(getattr(cpu.trainer.mixer, "faults", ()))
    flt = draws_mod.RecordingDraws(draws_mod.GeneratorDraws(spec.fault_seed,
                                                            "cpu"))
    if faulty:
        cpu.trainer.start_fault_stream(flt)
    st = card.init_state()
    worst_frac = worst_rel = 0.0
    off_at = {t_: 0.0 for t_ in (1e-4, 3e-4, 1e-3)}
    if qk is not None:
        qk.reset_launch_counts()
    for t in range(steps):
        arrays = convert.trainstate_to_arrays(st)
        rec = draws_mod.RecordingDraws(gen)
        nf = len(flt.record)
        want, _ = cpu.step(convert.trainstate_from_arrays(arrays,
                                                          device="cpu"),
                           data.batch_at(t), rec)
        replay = draws_mod.ReplayDraws(rec.record, card.device)
        freplay = draws_mod.ReplayDraws(flt.record[nf:], card.device)
        if faulty:
            card.trainer.start_fault_stream(freplay)
        batch = {k: v.to(card.device) for k, v in data.batch_at(t).items()}
        st, _ = card.step(st, batch, replay)
        require(not replay.pending and not freplay.pending,
                "the card drew less than the CPU path")
        got_a, want_a = (convert.trainstate_to_arrays(s) for s in (st, want))
        tc = cpu.trainer.tcfg
        x_max = [float(abs(x).max()) for x in tree.leaves(want_a["X"])]
        for name in ("X", "D", "comm.H", "comm.Hw"):
            wl = tree.leaves(want_a[name])
            top = max(float(abs(b).max()) for b in wl)
            for j, (a, b) in enumerate(zip(tree.leaves(got_a[name]), wl)):
                scale = max(float(abs(b).max()), 1e-30)
                if rounding_floors:
                    if scale <= 1e-6 * top:
                        scale = top
                    if name == "D":
                        scale = max(scale, tc.gamma / (2 * tc.eta) * x_max[j])
                off = abs(a - b) > elem_tol * scale
                worst_frac = max(worst_frac, float(off.mean()))
                worst_rel = max(worst_rel, float(abs(a - b).max()) / scale)
                for t_ in off_at:
                    off_at[t_] = max(off_at[t_], float(
                        (abs(a - b) > t_ * scale).mean()))
        require(worst_frac <= REPLAY_MAX_OFF,
                f"trainer card vs CPU step {t} of {spec.name}: "
                f"{worst_frac:.2e} of a state array differs by more than "
                f"{elem_tol} x its max (off at 1e-4/3e-4/1e-3: "
                f"{list(off_at.values())}, worst {worst_rel:.2e})")
    out = {"spec": spec.name, "steps": steps, "elem_tol": elem_tol,
           "off_fraction_at": {str(k): v for k, v in off_at.items()},
           "max_off_fraction": REPLAY_MAX_OFF,
           "fault_draws_replayed": faulty,
           "worst_off_fraction": worst_frac, "worst_rel_max": worst_rel}
    if qk is not None:
        groups = len(card.trainer.wire_layout().groups)
        launches = qk.launch_counts()
        require(device != "cuda" or (
            launches["qinf_quantize_pack_blocks"] == steps * groups
            and launches["qinf_unpack_dequant_mix_blocks"] == steps * groups),
            f"{spec.name}: launch counts {launches} != one B3 and one B4 "
            f"per bucket group ({groups}) a step for {steps} steps")
        out.update(bucket_groups=groups, launches=launches)
    return out


def trainer_drop_rate(torch, api, tree, qk, steps: int = DROP_RATE_STEPS,
                      device="cuda"):
    """The small trainer on the dense backend under ``drop_rate``: two
    ``run()`` calls on one runner, each from a fresh state (so each starts
    the fault stream afresh), the launch counters zeroed just before the
    first and read just after it.  B1 and B2 launch once per leaf a step;
    the two runs agree at phase 4's tolerance (the card's gradient sums
    may reduce in another order); the loss is finite."""
    spec = slice_spec(api, steps, full=False, n_layers=1, d_model=256,
                      seq_len=64, backend="dense",
                      params={"drop_rate": DROP_RATE})
    runner = api.build(spec) if device == "cuda" else api.build(
        spec, device=device)
    losses = []

    def keep(state, metrics, t):
        losses.append(float(metrics["loss"]))

    qk.reset_launch_counts()
    first, _ = runner.run(num_steps=steps, callback=keep, log_every=1)
    launches = qk.launch_counts()
    second, _ = runner.run(num_steps=steps)
    n_leaves = len(tree.leaves(first.plead.X))
    on_card = device == "cuda"
    require(not on_card or (launches[B1] == steps * n_leaves
                            and launches[B2] == steps * n_leaves),
            f"launch counts {launches} != one B1 and one B2 per leaf a step "
            f"({n_leaves} leaves, {steps} steps)")
    require(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    worst_frac = 0.0
    for a, b in zip(tree.leaves(first.plead.X), tree.leaves(second.plead.X)):
        scale = max(float(b.abs().max()), 1e-30)
        off = (a - b).abs() > REPLAY_ELEM_TOL * scale
        worst_frac = max(worst_frac, float(off.float().mean()))
    require(worst_frac <= REPLAY_MAX_OFF,
            f"two drop_rate runs from fresh states differ: {worst_frac:.2e} "
            f"of X off by more than {REPLAY_ELEM_TOL} x its max")
    return {"spec": spec.name, "steps": steps, "drop_rate": DROP_RATE,
            "leaves": n_leaves, "launches": launches, "loss": losses,
            "two_runs_worst_off_fraction": worst_frac}


# --- phase 9 -------------------------------------------------------------------

def paper_grid(torch, qk, cm, fig, steps: int = PAPER_STEPS,
               device="cuda"):
    """One figure's grid on ``device``, row by row, the launch counters
    zeroed around each row; every claim must pass."""
    t0 = time.perf_counter()
    grid, xstar = fig.setup(steps, device=device)
    solve_s = time.perf_counter() - t0
    rows = []
    for label, spec in grid:
        qk.reset_launch_counts()
        [r] = cm.run_cells([(label, spec)], xstar, steps, device=device)
        n = qk.launch_counts()
        want = steps if spec.compressor.name == "qinf" else 0
        require(n[B1] == want and n[B2] == want and sum(n.values()) ==
                2 * want, f"{label}: launches {n}, want {want} of B1 and of "
                f"B2 ({steps} steps)")
        require(all(math.isfinite(v) for v in r.subopt),
                f"{label}: non-finite suboptimality")
        rows.append({**r.row(), "launches": {B1: n[B1], B2: n[B2]}})
    checks = [{"claim": c, "ok": bool(ok), "value": str(v)}
              for c, ok, v in fig.validate(rows)]
    failed = [c["claim"] for c in checks if not c["ok"]]
    require(not failed, f"claims failed: {failed}")
    return {"rows": rows, "checks": checks, "solve_reference_s": solve_s,
            "seconds": time.perf_counter() - t0}


def baseline_card_vs_cpu(torch, api, convert, draws_mod, label, spec,
                         steps: int = PAPER_REPLAY_STEPS, device="cuda"):
    """A baseline, one step at a time from the card's state: the plain CPU
    path draws, the card replays; X compared at phase 4's tolerance."""
    f64 = torch.float64
    cpu = api.build(spec, device="cpu", dtype=f64)
    card = api.build(spec, device=device, dtype=f64)
    gen = draws_mod.GeneratorDraws(spec.seed, "cpu")
    rec = draws_mod.RecordingDraws(gen)
    cpu.init_state(rec)
    st = card.init_state(draws_mod.ReplayDraws(rec.record, device))
    worst_frac = worst_rel = 0.0
    for _ in range(steps):
        rec = draws_mod.RecordingDraws(gen)
        want = cpu.step(convert.simple_state_from_arrays(
            convert.simple_state_to_arrays(st), device="cpu", dtype=f64),
            rec)
        replay = draws_mod.ReplayDraws(rec.record, device)
        st = card.step(st, replay)
        require(not replay.pending, "the card drew less than the CPU path")
        got = st.X.cpu()
        scale = float(want.X.abs().max())
        off = (got - want.X).abs() > REPLAY_ELEM_TOL * scale
        worst_frac = max(worst_frac, float(off.double().mean()))
        worst_rel = max(worst_rel, float((got - want.X).abs().max()) / scale)
        require(worst_frac <= REPLAY_MAX_OFF,
                f"{label} card vs CPU step {st.k}: {int(off.sum())} of "
                f"{off.numel()} elements of X differ by more than "
                f"{REPLAY_ELEM_TOL} x max|X|")
    return {"steps": steps, "worst_off_fraction": worst_frac,
            "worst_rel_max": worst_rel}, st.X


def empirical_C_on_card(torch, qk, compression, draws_mod, x,
                        trials: int = EMPIRICAL_C_TRIALS):
    """2-bit QInf's empirical C on ``x``: one B1 and one B2 launch on the
    card, the plain version's value from the same noise, the analytic C."""
    comp = compression.make_compressor("qinf", bits=2, block=256)
    rec = draws_mod.RecordingDraws(draws_mod.GeneratorDraws(0, x.device))
    qk.reset_launch_counts()
    got = compression.empirical_C(comp, x, rec, trials=trials)
    n = qk.launch_counts()
    require(n[B1] == 1 and n[B2] == 1 and sum(n.values()) == 2,
            f"empirical_C launched {n}, want one B1 and one B2")
    plain = compression.empirical_C(
        comp, x.cpu(), draws_mod.ReplayDraws([u.cpu() for u in rec.record],
                                             "cpu"), trials=trials)
    require(abs(got - plain) <= 1e-12 * abs(plain),
            f"empirical_C {got!r} on the card, {plain!r} plain")
    require(0.0 < got <= comp.C, f"empirical_C {got} outside (0, {comp.C}]")
    return {"trials": trials, "leaf": list(x.shape), "C_card": got,
            "C_plain": plain, "C_analytic": comp.C, "launches": n}


def paper_comparisons(torch, api, convert, draws_mod, qk, device="cuda",
                      steps: int = PAPER_STEPS,
                      replay_steps: int = PAPER_REPLAY_STEPS):
    from repro_torch.core import compression
    from repro_torch.paper import common as cm
    from repro_torch.paper import fig1_smooth, fig2_nonsmooth
    from repro_torch.paper import table3_complexity as table3
    out = {"grids": {}}
    for key, fig in (("fig1", fig1_smooth), ("fig2", fig2_nonsmooth)):
        out["grids"][key] = paper_grid(torch, qk, cm, fig, steps, device)
    L = cm.estimate_L(cm.flat_logreg(device="cpu"))
    eta = 1.0 / (2 * L)
    by = dict(fig1_smooth.cells(replay_steps, eta, eta / 3)
              + fig2_nonsmooth.cells(replay_steps, eta, eta / 3))
    # where a 2-bit row's step goes: LEAD (2bit) of Fig. 1 under the profiler
    spec = by["LEAD (2bit)"]
    runner = api.build(spec, device=device, dtype=torch.float64)
    d = draws_mod.GeneratorDraws(spec.seed, device)
    st = runner.init_state(d)
    for _ in range(5):
        st = runner.step(st, d)
    out["lead2_profile"] = profile_steps(torch, runner, st, d,
                                         PAPER_PROFILE_STEPS,
                                         "paper_lead2bit_trace.json")
    require(out["lead2_profile"]["b1_per_step"] == 1,
            "the LEAD (2bit) profile saw "
            f"{out['lead2_profile']['b1_per_step']} B1 launches a step")
    # (b) Table 3: measured rates within their theorem envelopes
    t0 = time.perf_counter()
    qk.reset_launch_counts()
    rows = table3.run(device=device)
    out["table3"] = {"rows": rows, "launches": qk.launch_counts(),
                     "seconds": time.perf_counter() - t0}
    bad = [r["name"] for r in rows if not r["ok"]]
    require(not bad, f"Table 3 rates outside their envelopes: {bad}")
    # (c) the baselines, card against CPU, at the paper's rows
    out["card_vs_cpu"] = {}
    for label in ("DGD", "PG-EXTRA/P2D2 (32bit)", "Choco (2bit)",
                  "LessBit (2bit)"):
        out["card_vs_cpu"][label], X = baseline_card_vs_cpu(
            torch, api, convert, draws_mod, label, by[label], replay_steps,
            device)
    # (d) empirical_C on the last LessBit iterate
    out["empirical_C"] = empirical_C_on_card(torch, qk, compression,
                                             draws_mod, X)
    return out


T_START = time.perf_counter()


# --- phase 10 ------------------------------------------------------------------

GOLDEN_SWEEP = ROOT / "tests" / "golden_specs" / "sweep_lead_seed_x_bits.json"


def _state_leaves(state):
    """Every tensor of a (stacked or point) state, in field order, and its
    ints."""
    out = []

    def walk(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif t is not None:
            out.append(t)
    walk(state)
    return out


def states_equal(torch, a, b) -> bool:
    la, lb = _state_leaves(a), _state_leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x, y) if torch.is_tensor(x) else x == y)
        for x, y in zip(la, lb))


def sweep_map_golden(torch, api, metrics, qk, device="cuda"):
    """(a) The golden sweep (12 points: seeds 0-3 x bits 2, 4, 8; LEAD on
    the ring, logreg2d, block 5, 60 steps) in map mode, f64 (as the sweep
    CLI runs it), the launch counters zeroed just before and read just
    after: B1 and B2 once a point-step; then every point's serial run
    (``api.build(point).run()``), each final state bit-equal."""
    spec = api.SweepSpec.load(GOLDEN_SWEEP)
    runner = api.build(spec, dtype=torch.float64) if device == "cuda" \
        else api.build(spec, device=device, dtype=torch.float64)
    require(runner.device.type == device and runner.batch == "map",
            f"build(SweepSpec) gave {runner.device} {runner.batch}")
    qk.reset_launch_counts()
    final, res = runner.run(metric_fn=lambda st: metrics.consensus_error(
        st.X))
    launches = qk.launch_counts()
    want = runner.n_points * spec.base.steps if device == "cuda" else 0
    require(launches[B1] == want and launches[B2] == want,
            f"golden sweep launches {launches}, want {want} of B1 and B2")
    equal = 0
    for i, p in enumerate(runner.points):
        serial, _ = api.build(p, device=runner.device,
                              dtype=torch.float64).run()
        require(states_equal(torch, runner.point_state(final, i), serial),
                f"sweep point {p.name} != its serial run on the card")
        equal += 1
    return {"spec": spec.name, "points": runner.n_points,
            "steps": spec.base.steps, "launches": launches,
            "bit_equal_points": equal, "wall_s": res.wall_s,
            "final_consensus": [float(v) for v in
                                res.metrics["metric"][:, -1]],
            "names": [p.name for p in runner.points]}


def sweep_grid_spec(api, steps: int, base=None):
    """Phase 4's MNIST-scale quickstart spec x seed 0-7 x bits 2, 4: the
    stacked grid of (b), 16 points."""
    base = base if base is not None else mnist_spec(api, steps)
    return api.SweepSpec("quickstart-mnist-seed8-x-bits2", base, (
        api.AxisSpec("seed", tuple(range(SWEEP_SEEDS))),
        api.AxisSpec("compressor.bits", SWEEP_BITS)))


def _objective(problem, X, lam):
    """Phase 4's objective f + lam ||x||_1 of one point's X (a tensor or a
    tree of them: the l1 term summed over the leaves), a 0-d tensor."""
    return problem.full_loss(X) + lam * sum(
        leaf.abs().flatten(1).sum(1).mean() for leaf in _state_leaves(X))


def stacked_grid(torch, sweep, draws_mod, ops, qk, ref, errs, spec,
                 objective, device="cuda", steps: int = SWEEP_STEPS,
                 replay_steps: int = SWEEP_REPLAY_STEPS,
                 timed_steps: int = SWEEP_TIMED_STEPS,
                 profile: int = SWEEP_PROFILE_STEPS,
                 b1_per_step: int = 1,
                 trace_name: str = "sweep_trace.json"):
    """A stacked grid (``batch='vmap'``) of ``spec`` held to map mode and
    run: (1) teacher-forced, both modes from the same stacked state for
    ``replay_steps`` steps, each point's algorithm draws and (netsim) its
    fault draws recorded in the stacked step and replayed in the map step,
    X per point (every leaf of a tree) at phase 4's tolerance, every B1
    and B2 launch of the first stacked step held bit for bit to its plain
    version (:func:`checked_qinf_kernels`; ``checked_launches``, empty
    where the grid compresses nothing with QInf); (2) netsim: the bits of every
    round of a ``replay_steps`` run, stacked and map, equal as integers;
    (3) a free-running run of ``steps`` steps, the counters zeroed just
    before and read just after -- B1 and B2 ``b1_per_step`` times a step
    for the whole grid -- every point's ``objective(problem, X)`` falling,
    and peak memory; (4) ms a step stacked against the summed ms a step of
    the points run one by one (one process); (5) a ``torch.profiler``
    window of ``profile`` stacked steps."""
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    vm = sweep.SweepRunner(spec.points(), name=spec.name, spec=spec,
                           batch="vmap", device=device)
    mp = vm.with_batch("map")
    problem, P = vm.problem, vm.n_points
    netsim = vm.engine == "netsim"
    on_card = device == "cuda"

    # (1) teacher-forced; the map mode's fault streams replay the stacked
    # grid's (its points' inits draw round 0 alike)
    frec = [draws_mod.RecordingDraws(draws_mod.GeneratorDraws(
        p.fault_seed, device)) for p in vm.points]
    st = vm.init_state(fault_draws=draws_mod.StackedDraws(frec))
    frep = [draws_mod.ReplayDraws([t.clone() for t in r.record], device)
            for r in frec]
    mp.init_state(fault_draws=draws_mod.StackedDraws(frep))
    worst_frac = worst_rel = 0.0
    checked = []
    for t in range(replay_steps):
        seen = [len(r.record) for r in frec]
        rec = [draws_mod.RecordingDraws(draws_mod.GeneratorDraws(
            1000 * t + i, device)) for i in range(P)]
        held = (checked_qinf_kernels(torch, ops, qk, ref, errs,
                                     f"{spec.name} stacked step")
                if t == 0 else contextlib.nullcontext([]))
        with held as calls:
            got = vm.step(st, draws_mod.StackedDraws(rec))
        checked += calls
        for r, rp, n in zip(frec, frep, seen):
            rp.pending.extend(r.record[n:])
        replay = [draws_mod.ReplayDraws(r.record, device) for r in rec]
        want = mp.step(st, draws_mod.StackedDraws(replay))
        require(not any(r.pending for r in replay + frep),
                f"the map step drew less than the stacked step at {t}")
        for i in range(P):
            for gl, wl in zip(_state_leaves(got.X), _state_leaves(want.X)):
                diff, scale = (gl[i] - wl[i]).abs(), wl[i].abs().max()
                off = diff > REPLAY_ELEM_TOL * scale
                worst_frac = max(worst_frac, float(off.float().mean()))
                # a leaf the l1 prox holds at zero (the tree's intercept)
                # has no scale: any difference there is off by infinity
                worst_rel = max(worst_rel, float(diff.max() / scale)
                                if float(scale) else
                                (float("inf") if float(diff.max()) else 0.0))
        require(worst_frac <= REPLAY_MAX_OFF,
                f"{spec.name}: stacked vs map step {t}: {worst_frac:.2e} of "
                f"a point's X off by more than {REPLAY_ELEM_TOL} x max|X|")
        st = got
    fault_draws = sum(len(r.record) for r in frec)
    require(not netsim or not vm.base.faults or fault_draws > 0,
            f"{spec.name}: the stacked netsim grid drew no faults")

    # (2) netsim: every round's bits, stacked against map, as integers
    bits_first = None
    if netsim:
        _, rv = vm.run(num_steps=replay_steps)
        _, rm = mp.run(num_steps=replay_steps)
        require(rv.metrics["bits"].dtype == np.int64 and np.array_equal(
            rv.metrics["bits"], rm.metrics["bits"]),
            f"{spec.name}: stacked bits != map-mode bits")
        bits_first = rv.metrics["bits"][:, :4].tolist()

    # (3) the free-running stacked run, counters zeroed just before
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    qk.reset_launch_counts()
    if netsim:
        final, res = vm.run(num_steps=steps, objective_fn=lambda X: objective(
            problem, X))
        obj0, obj1 = (list(map(float, c)) for c in
                      res.metrics["objective"][:, [0, -1]].T)
    else:
        final, res = vm.run(num_steps=steps, metric_every=steps,
                            metric_fn=lambda s: objective(problem, s.X))
        obj0, obj1 = (list(map(float, c)) for c in res.metrics["metric"].T)
    launches = qk.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card \
        else None
    want_b1 = steps * b1_per_step
    require(not on_card or (launches[B1] == want_b1
                            and launches[B2] == want_b1),
            f"{spec.name}: launches {launches}: want B1 and B2 {b1_per_step}"
            f" a step for the whole grid ({steps} steps)")
    require(all(bool(torch.isfinite(leaf).all())
                for leaf in _state_leaves(final.X)), "non-finite stacked X")
    require(all(b < a for a, b in zip(obj0, obj1)),
            f"{spec.name}: a point's objective did not fall: "
            f"{list(zip(obj0, obj1))}")

    # (4) ms a step, one process: the stacked grid, then each point alone
    def fenced(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    d = vm.point_draws()
    st = vm.init_state(d)
    for _ in range(3):
        st = vm.step(st, d)
    holder = [st]

    def stacked():
        for _ in range(timed_steps):
            holder[0] = vm.step(holder[0], d)

    stacked_ms = fenced(stacked) / timed_steps * 1e3
    map_ms = []
    dm = mp.point_draws()
    for algo, dp in zip(mp.point_algos(), dm.points):
        s = [algo.init(vm.X0, dp)]
        for _ in range(3):
            s[0] = algo.step(s[0], dp)

        def one(algo=algo, s=s, dp=dp):
            for _ in range(timed_steps):
                s[0] = algo.step(s[0], dp)

        map_ms.append(fenced(one) / timed_steps * 1e3)
    prof = (profile_steps(torch, vm, holder[0], d, steps=profile,
                          trace_name=trace_name) if profile else None)
    if prof is not None:
        require(prof["b1_per_step"] == b1_per_step,
                f"{spec.name}: the profile saw {prof['b1_per_step']} B1 "
                f"launches a step")
    return {"spec": spec.name, "points": P, "steps": steps,
            "engine": vm.engine, "algorithm": vm.base.algorithm.name,
            "launches": launches, "checked_launches": checked,
            "replay": {"steps": replay_steps, "elem_tol": REPLAY_ELEM_TOL,
                       "max_off_fraction": REPLAY_MAX_OFF,
                       "worst_off_fraction": worst_frac,
                       "worst_rel_max": worst_rel,
                       "fault_draws_replayed": fault_draws},
            "bits_equal_to_map": netsim, "bits_first": bits_first,
            "objective_first": obj0, "objective_last": obj1,
            "stacked_ms_per_step": stacked_ms,
            "map_ms_per_step_summed": sum(map_ms),
            "map_ms_per_step_points": map_ms,
            "points_per_s_stacked": P / stacked_ms * 1e3,
            "points_per_s_map": P / sum(map_ms) * 1e3,
            "peak_mem_mb": peak_mb, "wall_s": res.wall_s, "profile": prof}


def sweep_vmap_grid(torch, api, sweep, draws_mod, ops, qk, ref, errs,
                    device="cuda", base=None, steps: int = SWEEP_STEPS,
                    replay_steps: int = SWEEP_REPLAY_STEPS,
                    timed_steps: int = SWEEP_TIMED_STEPS,
                    profile: int = SWEEP_PROFILE_STEPS):
    """(b) The stacked grid at the dense path's full width (see the module
    docstring)."""
    spec = sweep_grid_spec(api, steps, base)
    lam = spec.base.prox.params["lam"]
    return stacked_grid(torch, sweep, draws_mod, ops, qk, ref, errs, spec,
                        lambda problem, X: _objective(problem, X, lam),
                        device=device, steps=steps,
                        replay_steps=replay_steps, timed_steps=timed_steps,
                        profile=profile)


def netsim_grid_spec(api, steps: int, base=None):
    """(f) Phase 4b's scenario (markov_drop on the ring with
    SCENARIO_FAULTS) x fault_seed 0-7 x bits 2, 4: 16 points."""
    base = base if base is not None else mnist_spec(api, steps)
    return api.SweepSpec("netsim-scenario-fault-seed8-x-bits2",
                         netsim_spec(api, base, steps, True), (
        api.AxisSpec("fault_seed", tuple(range(SWEEP_SEEDS))),
        api.AxisSpec("compressor.bits", SWEEP_BITS)))


def lessbit_lsvrg_spec(api, steps: int, base=None):
    """(g) Fig. 1's "LessBit-LSVRG (2bit)" row on phase 4's data: LessBit
    (alpha 0.5) with L-SVRG and 2-bit QInf in 256-blocks, eta = 1/(6L)
    with L = 1/2 + 2 lam2 (the softmax Hessian bound on unit-norm rows, as
    ``paper.common.estimate_L``), x seed 0-7 x theta 0.2, 0.1: 16
    points."""
    base = base if base is not None else mnist_spec(api, steps)
    lam2 = base.oracle.problem_params["lam2"]
    eta = 1.0 / (6 * (0.5 + 2 * lam2))
    cell = dataclasses.replace(
        base, name="lessbit-lsvrg-2bit", steps=steps,
        algorithm=api.AlgorithmSpec("lessbit", eta=api.constant(eta),
                                    alpha=api.constant(0.5),
                                    params={"theta": 0.2}),
        prox=api.ProxSpec("none"),
        oracle=dataclasses.replace(base.oracle, name="lsvrg"))
    return api.SweepSpec("lessbit-lsvrg-2bit-seed8-x-theta2", cell, (
        api.AxisSpec("seed", tuple(range(SWEEP_SEEDS))),
        api.AxisSpec("algorithm.params.theta", (0.2, 0.1))))


def sparsifier_specs(api, steps: int, base=None):
    """(h) LEAD with RandK (frac 0.1; alpha 1/(1 + C) = 0.1 for its C = 9,
    gamma 0.01: at gamma 0.02 and above it diverges on this problem) x
    seed 0-7, and Choco with TopK (frac 0.1) x gamma_c 0.2, 0.1 x eta
    0.05, 0.1, on phase 4's data and oracle."""
    base = base if base is not None else mnist_spec(api, steps)
    lead = dataclasses.replace(
        base, name="lead-randk", steps=steps, prox=api.ProxSpec("none"),
        algorithm=api.AlgorithmSpec("lead", eta=api.constant(0.05),
                                    alpha=api.constant(0.1),
                                    gamma=api.constant(0.01)),
        compressor=api.CompressorSpec("randk", {"frac": 0.1}))
    choco = dataclasses.replace(
        base, name="choco-topk", steps=steps, prox=api.ProxSpec("none"),
        algorithm=api.AlgorithmSpec("choco", eta=api.constant(0.05),
                                    params={"gamma_c": 0.2}),
        compressor=api.CompressorSpec("topk", {"frac": 0.1}))
    return (api.SweepSpec("lead-randk-seed8", lead, (
                api.AxisSpec("seed", tuple(range(SWEEP_SEEDS))),)),
            api.SweepSpec("choco-topk-gamma_c2-x-eta2", choco, (
                api.AxisSpec("algorithm.params.gamma_c", (0.2, 0.1)),
                api.AxisSpec("algorithm.eta", (0.05, 0.1)))))


def _smooth_objective(problem, X):
    return problem.full_loss(X)


def stacked_grids_beyond_dense(torch, api, sweep, draws_mod, ops, qk, ref,
                               errs, device="cuda", base=None,
                               steps: int = SWEEP_STEPS,
                               replay_steps: int = SWEEP_REPLAY_STEPS,
                               timed_steps: int = SWEEP_TIMED_STEPS,
                               profile: int = SWEEP_PROFILE_STEPS):
    """(f)-(h): the netsim grid, LessBit-LSVRG and the sparsifiers (see
    the module docstring)."""
    lam = (base or mnist_spec(api, steps)).prox.params["lam"]
    kw = dict(device=device, steps=steps, replay_steps=replay_steps,
              timed_steps=timed_steps)
    held = (ops, qk, ref, errs)
    out = {"netsim": stacked_grid(
        torch, sweep, draws_mod, *held, netsim_grid_spec(api, steps, base),
        lambda problem, X: _objective(problem, X, lam), profile=profile,
        trace_name="sweep_netsim_trace.json", **kw)}
    out["lessbit_lsvrg"] = stacked_grid(
        torch, sweep, draws_mod, *held, lessbit_lsvrg_spec(api, steps, base),
        _smooth_objective, profile=profile,
        trace_name="sweep_lessbit_trace.json", **kw)
    for key, spec in zip(("randk", "topk"),
                         sparsifier_specs(api, steps, base)):
        out[key] = stacked_grid(torch, sweep, draws_mod, *held, spec,
                                _smooth_objective, profile=0,
                                b1_per_step=0, **kw)
    return out


TREE_PROBLEM = "logreg_bias"


def register_logreg_bias(torch) -> None:
    """Registers ``logreg_bias`` in the port's problem registry: the
    paper's logistic regression with an intercept on ``make_logreg_data``,
    a tree-valued iterate ``{"W": (n, p, C), "b": (n, C)}``, its gradient
    written out (with R = (softmax(A W + b) - Y) / bs: A^T R + 2 lam2 W and
    the row sum of R + 2 lam2 b).  The port registers no such problem:
    ``tests/test_torch_sweep_tree.py`` registers this one beside its
    ``jax.grad`` twin in the JAX package and holds the two together."""
    from repro_torch import registry
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.synthetic import make_logreg_data

    def logreg_bias(n_nodes: int = 8, n_features: int = 784,
                    n_classes: int = 10, n_per_node: int = 150,
                    n_batches: int = 15, lam2: float = 0.005, seed: int = 0,
                    noniid: bool = True, *, device="cpu",
                    dtype=torch.float32):
        A, Y = make_logreg_data(n_nodes=n_nodes, n_per_node=n_per_node,
                                n_features=n_features, n_classes=n_classes,
                                n_batches=n_batches, seed=seed,
                                noniid=noniid)
        data = {"A": torch.as_tensor(A, dtype=dtype, device=device),
                "Y": torch.as_tensor(Y, dtype=dtype, device=device)}

        def logits(X, A):               # X (n, ...), A (n, k, bs, p)
            return A @ X["W"][:, None] + X["b"][:, None, None, :]

        def grad_batches(X, batch):
            A = batch["A"]
            R = (torch.softmax(logits(X, A), dim=-1) - batch["Y"]) \
                / A.shape[-2]
            return {"W": A.transpose(-1, -2) @ R + 2 * lam2 * X["W"][:, None],
                    "b": R.sum(-2) + 2 * lam2 * X["b"][:, None]}

        def loss_batches(X, batch):
            logp = torch.log_softmax(logits(X, batch["A"]), dim=-1)
            ce = -(batch["Y"] * logp).sum(-1).mean(-1)
            reg = (X["W"] ** 2).sum((-2, -1)) + (X["b"] ** 2).sum(-1)
            return ce + lam2 * reg[:, None]

        prob = FiniteSumProblem(grad_batches, data, A.shape[0], A.shape[1],
                                loss_batches)
        return prob, {
            "W": torch.zeros((n_nodes, n_features, n_classes), dtype=dtype,
                             device=device),
            "b": torch.zeros((n_nodes, n_classes), dtype=dtype,
                             device=device)}

    registry.register_problem(TREE_PROBLEM)(logreg_bias)


def tree_grid_spec(api, steps: int, base=None):
    """(i) Phase 4's spec with an intercept (``logreg_bias``: W (8, 784,
    10) and b (8, 10)) and QInf in blocks of 10, along the class axis as
    ``logreg2d`` quantizes, x seed 0-7 x bits 2, 4: 16 points."""
    base = base if base is not None else mnist_spec(api, steps)
    cell = dataclasses.replace(
        base, name="quickstart-mnist-bias", steps=steps,
        compressor=api.CompressorSpec("qinf", {"bits": 2, "block": 10}),
        oracle=dataclasses.replace(base.oracle, problem=TREE_PROBLEM))
    return api.SweepSpec("mnist-bias-tree-seed8-x-bits2", cell, (
        api.AxisSpec("seed", tuple(range(SWEEP_SEEDS))),
        api.AxisSpec("compressor.bits", SWEEP_BITS)))


def tree_serial_runs(torch, api, qk, point, lam, device="cuda",
                     steps: int = TREE_SERIAL_STEPS):
    """(i) One point of the tree grid run alone through ``api.build(spec)
    .run()``, on the dense engine and on the netsim engine under phase
    4b's scenario, the counters zeroed just before and read just after:
    B1 and B2 once a leaf a step, every leaf finite, the objective
    falling; netsim bits int64 and positive every round."""
    import numpy as np
    out = {}
    for engine, spec in (("dense", point),
                         ("netsim", netsim_spec(api, point, steps, True))):
        runner = api.build(spec, device=device)
        require(runner.device.type == device and isinstance(runner.X0, dict),
                f"tree {engine} runner on {runner.device}")

        def obj(X, problem=runner.problem):
            return _objective(problem, X, lam)

        qk.reset_launch_counts()
        t0 = time.perf_counter()
        if engine == "dense":
            st, logs = runner.run(num_steps=steps, log_every=steps - 1,
                                  callback=lambda s, t: obj(s.X))
            first, last = float(logs[0]), float(logs[-1])
            bits = None
        else:
            st, traj = runner.run(num_steps=steps, objective_fn=obj)
            first, last = float(traj.objective[0]), float(traj.objective[-1])
            bits = traj.bits
            require(bits.dtype == np.int64 and bool((bits > 0).all()),
                    f"tree netsim bits {bits}")
        seconds = time.perf_counter() - t0
        launches = qk.launch_counts()
        want = 2 * steps if device == "cuda" else 0
        require(launches[B1] == want and launches[B2] == want,
                f"tree {engine} serial run: launches {launches}, want B1 "
                f"and B2 {want} (one a leaf a step)")
        require(all(bool(torch.isfinite(leaf).all())
                    for leaf in _state_leaves(st.X)) and last < first,
                f"tree {engine} serial run: objective {first} -> {last}")
        out[engine] = {"spec": spec.name, "steps": steps,
                       "launches": launches, "objective": [first, last],
                       "seconds": seconds,
                       "bits_first": None if bits is None
                       else bits[:4].tolist()}
    return out


def tree_grid(torch, api, sweep, draws_mod, ops, qk, ref, errs,
              device="cuda", base=None, steps: int = TREE_STEPS,
              replay_steps: int = SWEEP_REPLAY_STEPS,
              timed_steps: int = SWEEP_TIMED_STEPS,
              serial_steps: int = TREE_SERIAL_STEPS):
    """(i) The stacked grid over a tree-valued iterate (see the module
    docstring): :func:`stacked_grid` at two B1 and two B2 launches a step
    (one a leaf), its first stacked step's launches held to the plain
    versions, then :func:`tree_serial_runs`."""
    register_logreg_bias(torch)
    spec = tree_grid_spec(api, steps, base)
    lam = spec.base.prox.params["lam"]
    out = stacked_grid(torch, sweep, draws_mod, ops, qk, ref, errs, spec,
                       lambda problem, X: _objective(problem, X, lam),
                       device=device, steps=steps,
                       replay_steps=replay_steps, timed_steps=timed_steps,
                       profile=0, b1_per_step=2)
    kinds = sorted(k for k, _ in out["checked_launches"])
    require(kinds == sorted([B1, B1, B2, B2]),
            f"the tree grid's first step launched {out['checked_launches']}"
            f": want one B1 and one B2 a leaf")
    out["serial"] = tree_serial_runs(torch, api, qk, spec.points()[0], lam,
                                     device=device, steps=serial_steps)
    return out


def b1_point_levels(torch, ops, qk, ref, errs, device="cuda",
                    iters: int = 20):
    """(c) B1 with a level count per point against B1 at each point's
    fixed bits and against the plain twin: the stacked grid's leaf (16, 8,
    7840) in f32, bf16 and f64 (bits 2, 4 alternating), and 393,216 x 256
    split into 4 points at bits 1, 2, 4 and 8; times (CUDA events) beside
    the fixed-bits B1 at the same shape and the bytes bound."""
    g = torch.Generator(device=device).manual_seed(17)
    cases = [("grid leaf", (SWEEP_SEEDS * len(SWEEP_BITS), 8, 7840), 256,
              tuple(SWEEP_BITS) * SWEEP_SEEDS),
             ("large", (4, LARGE_ROWS // 4, 256), 256, (1, 2, 4, 8))]
    rows = []
    for label, shape, block, bits in cases:
        lv = torch.tensor([float(2 ** (b - 1)) for b in bits],
                          device=device)
        for dtype in ((torch.float32, torch.bfloat16, torch.float64)
                      if label == "grid leaf" else (torch.float32,)):
            x = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
            x[1, 2] = 0
            u = torch.rand(ops.blockwise_shape(shape, block), generator=g,
                           device=device)
            codes, scales = ops.qinf_quantize_lastdim(x, u, block=block,
                                                      levels=lv)
            rows_b = ops.blockwise_lastdim(x, block=block).reshape(-1, block)
            pc, ps = ref.qinf_quantize_blocks_ref(
                rows_b, u.reshape(-1, block),
                levels=ref.levels_per_row(lv, rows_b.shape[0]))
            require(torch.equal(codes.reshape(-1, block), pc)
                    and torch.equal(scales.reshape(-1, 1), ps),
                    f"per-point B1 != plain at {label} {dtype}")
            for p, b in enumerate(bits):
                cp, sp = ops.qinf_quantize_lastdim(x[p], u[p], bits=b,
                                                   block=block)
                require(torch.equal(codes[p], cp) and torch.equal(
                    scales[p], sp), f"per-point B1 point {p} ({b} bits) != "
                    f"fixed-bits B1 at {label} {dtype}")
            errs[B1] = max(errs[B1], float(
                (codes.reshape(-1, block).float() - pc.float()).abs().max()))
            if dtype != torch.float32:
                continue
            bound = bound_ms(nbytes(x, u, codes, scales),
                             B1_OPS_PER_ELEMENT * x.numel())
            rows.append({
                "case": label, "shape": list(shape), "bits": list(bits),
                "ms": cuda_ms(torch, lambda: ops.qinf_quantize_lastdim(
                    x, u, block=block, levels=lv), iters),
                "fixed_bits_ms": cuda_ms(torch, lambda: ops.qinf_quantize_lastdim(
                    x, u, bits=2, block=block), iters),
                "plain_ms": cuda_ms(torch, lambda: ref.qinf_quantize_blocks_ref(
                    rows_b, u.reshape(-1, block),
                    levels=ref.levels_per_row(lv, rows_b.shape[0])), iters),
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None})
            del x, u, codes, scales, rows_b, pc, ps
    return rows


def checkpoint_resume(torch, api, draws_mod, device="cuda"):
    """(d) A dense runner (the golden Prox-LEAD spec) and phase 8's small
    trainer save at step 2; ``load_checkpoint(..., device)`` rebuilds
    each; the next step from the saved and the restored state, with the
    same draws (and batch), is bit-equal."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        spec = api.ExperimentSpec.load(ROOT / "tests" / "golden_specs"
                                       / "prox_lead_dense_ring_qinf2.json")
        runner = api.build(spec, device=device)
        state, _ = runner.run(num_steps=2)
        runner.save(pathlib.Path(tmp) / "dense", state, step=2)
        r2, s2, step = api.load_checkpoint(pathlib.Path(tmp) / "dense",
                                           device=device)
        require(step == 2 and r2.spec == spec and r2.device.type == device
                and states_equal(torch, state, s2),
                "dense checkpoint did not restore the state")
        a = runner.step(state, draws_mod.GeneratorDraws(7, device))
        b = r2.step(s2, draws_mod.GeneratorDraws(7, device))
        require(states_equal(torch, a, b), "dense resume != the saved run")
        out["dense"] = {"spec": spec.name, "step": step}

        tspec = slice_spec(api, 3, full=False, n_layers=1, d_model=256,
                           seq_len=64)
        tr = api.build(tspec, device=device)
        data = tr.default_data()
        st = tr.init_state()
        for t in range(2):
            st, _ = tr.step(st, {k: v.to(device) for k, v in
                                 data.batch_at(t).items()},
                            draws_mod.GeneratorDraws(t, device))
        tr.save(pathlib.Path(tmp) / "trainer", st, step=2)
        t2, st2, step = api.load_checkpoint(pathlib.Path(tmp) / "trainer",
                                            device=device)
        require(step == 2 and t2.spec == tspec
                and states_equal(torch, st, st2),
                "trainer checkpoint did not restore the state")
        batch = {k: v.to(device) for k, v in data.batch_at(2).items()}
        a, _ = tr.step(st, batch, draws_mod.GeneratorDraws(9, device))
        b, _ = t2.step(st2, batch, draws_mod.GeneratorDraws(9, device))
        require(states_equal(torch, a, b), "trainer resume != the saved run")
        out["trainer"] = {"spec": tspec.name, "step": step}
    return out


def sweep_cli(golden: dict, device="cuda"):
    """(e) ``python -m repro_torch.launch.sweep`` on the golden sweep, on
    the card: exit 0, and each point's final consensus equal to (a)'s."""
    OUT_DIR.mkdir(exist_ok=True)
    out = OUT_DIR / "sweep_cli.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--spec",
           str(GOLDEN_SWEEP), "--out", str(out)]
    if device != "cuda":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=600, cwd=str(ROOT))
    require(r.returncode == 0, f"sweep CLI exit {r.returncode}: "
            f"{r.stderr[-2000:]}")
    rows = json.loads(out.read_text())["points"]
    require([row["name"] for row in rows] == golden["names"]
            and [row["final_consensus"] for row in rows]
            == golden["final_consensus"],
            "the sweep CLI's per-point consensus != the map-mode run's")
    return {"points": len(rows), "seconds": time.perf_counter() - t0,
            "out": str(out.relative_to(ROOT))}


def sweep_phase(torch, api, sweep, metrics, draws_mod, ops, qk, ref, errs):
    """Phase 10 (see the module docstring)."""
    t0 = time.perf_counter()
    res = {"golden_map": sweep_map_golden(torch, api, metrics, qk)}
    res["vmap_grid"] = sweep_vmap_grid(torch, api, sweep, draws_mod, ops, qk,
                                       ref, errs)
    res["beyond_dense"] = stacked_grids_beyond_dense(
        torch, api, sweep, draws_mod, ops, qk, ref, errs)
    res["b1_point_levels"] = b1_point_levels(torch, ops, qk, ref, errs)
    res["checkpoints"] = checkpoint_resume(torch, api, draws_mod)
    res["cli"] = sweep_cli(res["golden_map"])
    res["tree_grid"] = tree_grid(torch, api, sweep, draws_mod, ops, qk, ref,
                                 errs)
    res["seconds"] = time.perf_counter() - t0
    return res


# --- phase 11 ------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32   # serve.py's defaults
SERVE_TOL = 1e-3            # decode logits vs teacher-forced, x max|logits|
SERVE_FRAMES = 1500         # whisper's encoder frames (max_source_positions)
#: (arch, overrides of its published configuration: the depth cut)
SERVE_CASES = (("mixtral-8x7b", {"n_layers": 2}),
               ("deepseek-moe-16b", {"n_layers": 2}),
               ("rwkv6-7b", {"n_layers": 2}),
               ("recurrentgemma-9b", {"n_layers": 3}),
               ("llama-3.2-vision-90b", {"n_layers": 5}),
               ("whisper-large-v3", {}))
WINDOW_PROMPT = 4608        # > mixtral's window 4096, not a multiple of it
WINDOW_STEPS = 8
SERVE_PROFILE_STEPS = 4     # decode steps under torch.profiler
#: parameters a decode step does not read whole: the embedding table (it
#: reads a row a token), the encoder, and the cross-attention key/value
#: projections (their outputs sit in the cache since prefill)
DECODE_UNREAD = re.compile(r"^/(embed|enc_[^/]*)(/|$)|^/xblocks/(wk|wv|k_norm)$"
                           r"|/x_w[kv](_b)?$")


def serve_config(configs, arch: str, overrides: dict):
    """The published configuration with ``overrides``; MoE at
    capacity_factor = n_experts, where a token routes alike in a pass of
    one token and of the whole sequence (so decode can equal the
    teacher-forced forward)."""
    cfg = dataclasses.replace(configs.get(arch), **overrides)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def decode_bytes(TR, cfg, cache, batch: int) -> int:
    """The least bytes a decode step moves: every parameter it reads whole
    (f32; not DECODE_UNREAD's), the embedding rows of its tokens, the
    caches read once, the logits written once."""
    import numpy as np
    from repro_torch import tree
    params = sum(int(np.prod(t.shape)) for path, t in
                 TR._iter_template(TR.param_template(cfg))
                 if not DECODE_UNREAD.search(path))
    return (4 * (params + batch * cfg.d_model + batch * cfg.padded_vocab)
            + nbytes(*tree.leaves(cache)))


def profile_decode(torch, TR, cfg, sp, cache, tokens, pos: int,
                   steps: int = SERVE_PROFILE_STEPS):
    """``torch.profiler`` over ``steps`` greedy decode steps from ``cache``
    at ``pos``: wall and device ms a step, busy share, device ops a step
    and the five costliest device operations."""
    with torch.no_grad(), profiled(torch) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = TR.decode_step(cfg, sp, cache,
                                           tokens[None, :, None], pos + i)
            tokens = logits[0].argmax(-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    trace = OUT_DIR / "serve_trace.json"
    prof.export_chrome_trace(str(trace))
    device = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    trace.unlink()
    require(bool(device), "the profiler saw no device work in decode")
    by_name = {}
    for e in device:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "busy_share": busy_ms / wall_ms,
            "device_ops_per_step": len(device) / steps,
            "top": [{"name": k[:90], "ms_per_step": ms / steps,
                     "per_step": n / steps} for k, (ms, n) in top]}


def shifts_bit_equal(torch, tree, cache, M: int) -> bool:
    """RWKV-6's token shifts (replicated cache leaves) bit-equal over a
    node's M rank-rows."""
    ok = True
    for path, x in tree.flatten_with_paths(cache):
        if path.endswith("_shift"):
            v = x.unflatten(0, (-1, M))
            ok &= all(torch.equal(v[:, 0], v[:, m]) for m in range(M))
    return ok


def serve_arch(torch, configs, TR, serve, arch: str, overrides: dict, *,
               batch: int = SERVE_BATCH, prompt: int = SERVE_PROMPT,
               gen: int = SERVE_GEN, frames: int = SERVE_FRAMES,
               device: str = "cuda", M: int = 1):
    """One architecture through ``repro_torch.launch.serve``: random f32
    weights from a seeded generator on the card, a random prompt batch
    (and vision tokens / encoder frames), ``prefill`` timed (after one
    untimed warm-up prefill), then ``generate`` (prefill + greedy decode)
    timed; its logits against the teacher-forced forward over the
    generated sequence at the same positions, within SERVE_TOL x
    max|logits|; every generated id in [0, padded vocab).  Then a
    ``torch.profiler`` window of SERVE_PROFILE_STEPS decode steps after a
    fresh prefill, and a decode step's bytes bound (``decode_bytes``).
    ``M`` > 1 (phase 18 (b)): the node split over M model ranks
    (``StackedTP(M)``), the same weights cut into rank-rows through
    ``serve.prefill(tp=)`` and ``serve.generate(tp=)``, each token taken
    from the logits gathered over the ranks and held to the whole node's
    teacher-forced forward; RWKV-6's token-shift caches bit-equal over the
    ranks after a prefill and ``gen`` - 1 decode steps; no profile."""
    from repro_torch import tree
    from repro_torch.models import sharding
    from repro_torch.models.tp import NO_TP, StackedTP
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serve_config(configs, arch, overrides)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(0)
    params = TR.init_params(cfg, g, device)
    toks = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                         device=device)
    extras = {}
    if cfg.family == "vlm":
        extras["vision"] = torch.randn(
            (batch, cfg.n_vision_tokens, cfg.d_model), generator=g,
            device=device)
    if cfg.family == "encdec":
        extras["frames"] = torch.randn((batch, frames, cfg.d_model),
                                       generator=g, device=device)
    sp = TR.stack_nodes(params)
    tp, run, run_params = NO_TP, sp, params   # what prefill, generate take
    if M > 1:
        tp = StackedTP(M)
        leaves, treedef = tree.flatten(sp)
        specs = tree.leaves(sharding.param_specs(TR.abstract_params(cfg)))
        run = run_params = tree.unflatten(treedef, tp.cut(leaves, specs))
        del leaves
    sync()
    setup_s = time.perf_counter() - t0
    serve.prefill(cfg, run, toks, prompt + gen, extras, tp)   # warm-up
    sync()
    t0 = time.perf_counter()
    serve.prefill(cfg, run, toks, prompt + gen, extras, tp)
    sync()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, logits = serve.generate(cfg, run_params, toks, gen, extras,
                                 return_logits=True, tp=tp)
    sync()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    shifts = None
    if M > 1 and cfg.family == "ssm":
        _, cache = serve.prefill(cfg, run, toks, prompt + gen, extras, tp)
        with torch.no_grad():
            for i in range(gen - 1):
                nxt = tp.node_rows(out[None, :, prompt + i:prompt + i + 1])
                _, cache = TR.decode_step(cfg, run, cache, nxt, prompt + i,
                                          tp=tp)
        shifts = shifts_bit_equal(torch, tree, cache, M)
        require(shifts, f"{arch} at M = {M}: the token-shift caches differ "
                f"over a node's ranks")
        del cache
    del run, run_params
    with torch.no_grad():
        full = TR.forward(cfg, sp, {"tokens": out[None], **{
            k: v[None] for k, v in extras.items()}})[0][0]
    want = full[:, prompt - 1:prompt + gen - 1].transpose(0, 1)
    del full
    scale = float(want.abs().max())
    err = float((logits - want).abs().max())
    require(math.isfinite(err) and err <= SERVE_TOL * scale,
            f"{arch} at M = {M}: decode logits vs the whole node's "
            f"teacher-forced forward: max |diff| {err} > {SERVE_TOL} x "
            f"{scale}")
    new = out[:, prompt:]
    require(out.shape == (batch, prompt + gen) and int(new.min()) >= 0
            and int(new.max()) < cfg.padded_vocab,
            f"{arch} at M = {M}: generated ids out of [0, "
            f"{cfg.padded_vocab})")
    decode_ms = 1e3 * (gen_s - prefill_s) / (gen - 1)
    profile = bound = None
    if on_card and M == 1:
        last, cache = serve.prefill(cfg, sp, toks, prompt + gen, extras)
        bound = bound_ms(decode_bytes(TR, cfg, cache, batch), 0)[0]
        profile = profile_decode(torch, TR, cfg, sp, cache, last.argmax(-1),
                                 prompt)
        del last, cache
    res = {"arch": arch, "overrides": overrides,
           "config": {"n_layers": cfg.n_layers, "n_enc_layers":
                      cfg.n_enc_layers, "d_model": cfg.d_model,
                      "vocab": cfg.vocab, "n_experts": cfg.n_experts,
                      "capacity_factor": cfg.capacity_factor},
           "params": cfg.param_count(), "dtype": "float32",
           "batch": batch, "prompt": prompt, "gen": gen,
           "frames": frames if cfg.family == "encdec" else None,
           "max_abs_diff": err, "max_abs_logit": scale,
           "ids_at_or_above_vocab": int((new >= cfg.vocab).sum()),
           "setup_s": setup_s, "prefill_ms": 1e3 * prefill_s,
           "generate_ms": 1e3 * gen_s, "decode_ms_per_step": decode_ms,
           "tokens_per_s": batch * gen / gen_s, "peak_mem_gb": peak,
           "decode_bound_ms": bound, "decode_profile": profile, "M": M,
           "kv_heads_per_rank": (None if cfg.family == "ssm"
                                 else TR.kv_heads_per_rank(cfg, M)),
           "shift_caches_bit_equal": shifts}
    del params, sp, logits, want, out, extras
    if on_card:
        torch.cuda.empty_cache()
    return res


def serve_phase(torch, configs, TR, serve, device: str = "cuda",
                cases=SERVE_CASES, window_prompt: int = WINDOW_PROMPT,
                window_steps: int = WINDOW_STEPS, **kw):
    """Phase 11: every case of SERVE_CASES, then mixtral at 2 layers with
    one prompt past its window (C11's case)."""
    rows = [serve_arch(torch, configs, TR, serve, arch, ov, device=device,
                       **kw) for arch, ov in cases]
    ov = {"n_layers": 2}
    cfg = serve_config(configs, "mixtral-8x7b", ov)
    window = cfg.sliding_window
    require(window_prompt > window and window_prompt % window,
            f"prompt {window_prompt} does not wrap the {window}-slot ring "
            f"off its multiples")
    win = serve_arch(torch, configs, TR, serve, "mixtral-8x7b", ov,
                     batch=1, prompt=window_prompt, gen=window_steps,
                     device=device)
    win["window"] = window
    return {"archs": rows, "window": win}


# --- phase 14 ------------------------------------------------------------------

def golden_contracts(torch, device: str = "cuda", spec_dir=None):
    """Phase 14: ``repro_torch.check.contracts.audit_spec_dir`` over every
    golden spec on ``device`` (the audited step under
    ``set_sync_debug_mode("error")`` on the card), every finding printed;
    any FAIL fails the run.  Each sharded spec's (4, 2) variant is audited
    too, and a neighbor spec's as a tensor-parallel node: none waits."""
    from repro_torch.check import contracts
    spec_dir = pathlib.Path(spec_dir or ROOT / "tests" / "golden_specs")
    findings = contracts.audit_spec_dir(spec_dir, device)
    for claim, ok, detail in findings:
        print(f"[contracts] (14) {'PASS' if ok else 'FAIL'} {claim}"
              + (f"   [{detail}]" if detail else ""), flush=True)
    failed = [f for f in findings if f[1] is not True]
    n = len(findings)
    require(findings and not failed,
            f"contract audit: {len(failed)} of {n} checks fail: {failed}")
    return {"findings": findings,
            "summary": f"OK: {n}/{n} checks hold over "
                       f"{len(list(spec_dir.glob('*.json')))} golden specs, "
                       f"none waits"}


# --- phase 15 ------------------------------------------------------------------

GOLDEN_4X2 = ROOT / "tests" / "golden_specs" / \
    "trainer_neighbor_alternating_4x2.json"
GOLDEN_4X2_SHARD_BYTES = 86_076  # a model shard a step (the reference's audit)
GOLDEN_4X2_STEPS = 3
MESH_8X2 = (8, 2)
SLICE_8X2_BITS_PER_HOP = 741_890_816   # a node's two shard payloads a hop


@contextlib.contextmanager
def captured_wire_kernels(qk):
    """Every B3 and B4 call in the block, with clones of its operands and
    results: ``calls`` [(kernel, args, results)].  Restored on exit."""
    calls = []
    saved = {k: getattr(qk, k) for k in ("qinf_quantize_pack_blocks",
                                         "qinf_unpack_dequant_mix_blocks")}

    def wrap(name, fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            out = fn(*a, **k)
            calls.append((name, [x.clone() if hasattr(x, "clone") else x
                                 for x in a], [o.clone() for o in out]))
            return out
        return inner

    for name, fn in saved.items():
        setattr(qk, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(qk, name, fn)


def golden_mesh_on_card(torch, api, convert, draws_mod, tree, qk, ref, errs,
                        device: str = "cuda", steps: int = GOLDEN_4X2_STEPS):
    """Phase 15 (a): the golden ``trainer_neighbor_alternating_4x2`` spec
    (4 nodes x 2 model shards, alternating schedule, 3 hops, T = 2) on the
    card.  (1) ``steps`` steps card against CPU (phase 8's check: the CPU
    path draws, the card replays; phase 4's tolerance), B3 and B4 once per
    bucket group a step; (2) the contract audit of a step: 2 x 3 u8 ``pp``
    calls, GOLDEN_4X2_SHARD_BYTES a model shard (2 x that a node), no f64,
    no host read; (3) every B3 and B4 launch of a step against its plain
    version on the same operands, bit-equal (its four groups, 8 shard rows
    a launch, B4 at S = 4 senders and T = 2 rounds)."""
    from repro_torch.check import contracts
    from repro_torch.obs.record import RecordingPP
    spec = api.ExperimentSpec.load(GOLDEN_4X2)
    out = {"spec": spec.name, "mesh": list(spec.execution.mesh)}
    out["card_vs_cpu"] = trainer_card_vs_cpu(
        torch, api, convert, draws_mod, tree, steps=steps, device=device,
        spec=spec, qk=qk)
    runner = api.build_trainer_runner(spec, device=device, pp=RecordingPP())
    tr = runner.trainer
    hops = len(tr.plan.hops)
    state = runner.init_state()
    leaves = [torch.empty(x.shape, dtype=x.dtype, device="meta")
              for x in tree.leaves(state.plead.X)]
    facts, state = contracts.trainer_step_facts(runner, state=state)
    findings = contracts.audit_trainer(runner, spec.name, facts, leaves)
    per_node = sum(b for _, b in facts.calls)
    require(all(ok for _, ok, _ in findings) and state is not None,
            f"contracts of {spec.name}: {findings}")
    require(len(facts.calls) == 2 * hops and per_node == 2 *
            GOLDEN_4X2_SHARD_BYTES, f"{spec.name}: pp calls {facts.calls}, "
            f"want {2 * hops} summing to 2 x {GOLDEN_4X2_SHARD_BYTES:,} B")
    out.update(findings=findings, pp_calls=[[str(d), b] for d, b in
                                            facts.calls],
               pp_bytes_a_shard=per_node // tr.wire_shards,
               bits_per_step=runner.bits_per_step())
    data = runner.default_data()
    draws = draws_mod.GeneratorDraws(spec.seed, runner.device)
    with captured_wire_kernels(qk) as calls:
        runner.step(state, data.batch_at(int(state.step)), draws)
    groups = tr.wire_layout().groups
    require(len(calls) == 2 * len(groups), f"{spec.name}: {len(calls)} "
            f"B3/B4 calls in a step, want 2 x {len(groups)} groups")
    checked = []
    for name, args, res in calls:
        what = f"at {spec.name}'s group of {tuple(args[0].shape)}"
        if name == "qinf_quantize_pack_blocks":
            check_b3(torch, ref, args[0], args[1], args[2], res, errs, what)
        else:
            check_b4(torch, ref, args[0], args[1], args[2], args[3],
                     args[4] if len(args) > 4 else torch.float32, res, errs,
                     what)
        checked.append([name, list(args[0].shape)])
    out["wire_kernels_checked"] = checked
    return out


def mesh_spec(spec):
    """``spec`` on the mesh MESH_8X2: each node's leaves cut into 2 model
    shards on the bucketed wire."""
    return dataclasses.replace(
        spec, name=spec.name + "-mesh8x2", execution=dataclasses.replace(
            spec.execution, mesh=MESH_8X2))


def mesh_slice_phase(torch, api, draws_mod, tree, qk, ref, errs,
                     device: str = "cuda", steps: int = SLICE_STEPS,
                     profile_steps: int = SLICE_PROFILE_STEPS, wire=True,
                     spec=None):
    """Phase 15 (b): the slice's trainer (phase 6's spec) on the mesh
    (8, 2): each node's leaves cut into 2 model shards on the bucketed
    wire, 8 x 2 shard rows a B3/B4 launch.  ``trainer_path``: the launch
    counters zeroed just before the run and read just after (B3 and B4
    once per bucket group a step), ``bits_per_step`` = 2 hops x
    SLICE_8X2_BITS_PER_HOP, the contract audit (each hop's pair 92,736,352
    B a node) and the roofline, peak memory, step times.  (c) B3/B4 at
    the two groups of this layout (8 x 2 x 351,272 rows of 256, 8 x 2 x 4
    of 128), against their plain versions and timed beside their bounds
    (``roofline_gate.kernel_roofline`` with 2 shards a node).  ``spec``:
    another base than phase 6's (a small one rehearses this on the
    CPU)."""
    spec = mesh_spec(spec or slice_spec(api, steps))
    if device == "cuda":
        torch.cuda.empty_cache()
    out = trainer_path(torch, api, draws_mod, qk, steps=steps, spec=spec,
                       device=device, profile_steps=profile_steps,
                       bits_per_hop=SLICE_8X2_BITS_PER_HOP,
                       trace_name="slice_8x2_trace.json")
    tr = api.build(spec, device="cpu").trainer
    require(tr.wire_shards == MESH_8X2[1], f"{spec.name}: the wire cuts "
            f"{tr.wire_shards} shards, not {MESH_8X2[1]}")
    out["wire"] = []
    if device == "cuda":
        torch.cuda.empty_cache()
    for g in (tr.wire_layout().groups if wire else ()):
        out["wire"].append(wire_case(torch, qk, ref, errs, g.block, g.rows,
                                     n_nodes=MESH_8X2[0],
                                     shards=MESH_8X2[1], device=device))
    return out


# --- phase 16 ------------------------------------------------------------------

DRY_PEAK_TOL = 0.10          # dry peak within this of max_memory_allocated
DRY_OUT = OUT_DIR / "dryrun_torch"
#: the architectures whose recurrences run as a Python loop over the
#: tokens (RWKV-6's WKV, the RG-LRU): ~10^6-10^7 meta ops at train_4k and
#: prefill_32k, 8-20 minutes a combo, so phase 16 (b) leaves those
#: combos to the CLI (``python -m repro_torch.launch.dryrun --arch all
#: --shape all --backend neighbor``) and runs their one-token decodes
DRY_LOOPED = ("rwkv6-7b", "recurrentgemma-9b")
DRY_LOOPED_SHAPES = ("decode_32k", "long_500k")
DRY_SWEEP_TIMEOUT_S = 600


def dry_sweep_jobs(archs):
    """(arch, shape or "all", multi_pod) of phase 16 (b): every arch x
    every shape on (16, 16) and every arch x train_4k on (2, 16, 16),
    less the looped architectures' train_4k and prefill_32k."""
    jobs = []
    for a in archs:
        if a in DRY_LOOPED:
            jobs += [(a, s, False) for s in DRY_LOOPED_SHAPES]
        else:
            jobs += [(a, "all", False), (a, "train_4k", True)]
    return jobs


def dense_dry_jobs(archs):
    """Phase 19 (b)'s jobs, started with phase 16 (b)'s: every arch's
    train_4k on (16, 16) on the dense backend, one node a rank, less
    DRY_LOOPED's (their recurrences loop over the tokens on ``meta``:
    minutes a combo; the CLI runs them)."""
    return [(a, "train_4k", False, "dense") for a in archs
            if a not in DRY_LOOPED]


def dense_dry_line(r) -> str:
    """One combo of phase 19 (b): per-rank peak, fits, the all-gather
    bytes a rank receives a step and their NVLink time."""
    head = f"[dense] (19b) {r['arch']} x {r['shape']} x {r['mesh']}: "
    if r["status"] != "ok":
        return head + f"{r['status']} ({r.get('reason') or r.get('error')})"
    m, rl = r["memory"], r["roofline"]
    return (head + f"ok, {r['placement']} ({r['cards']} cards), peak "
            f"{m['peak_bytes'] / 2 ** 30:.2f} GiB/card, fits {m['fits']}, "
            f"all-gather {r['all_gather_bytes']:,.0f} B a step, "
            f"t_collective {rl['t_collective_s']:.4g} s, t_compute "
            f"{rl['t_compute_s']:.4g} s, bottleneck {rl['bottleneck']}, "
            f"{r['t_dry_s']} s")


def dry_against_real(torch, api, draws_mod, spec, real_roofline=None,
                     device: str = "cuda", tp_ways: int = 1):
    """Phase 16 (a): ``spec`` (a trainer spec) dry-run in one process on
    the ``meta`` device (``repro_torch.launch.dryrun.dry_train``, the
    program phase 6 runs) against a real step on ``device``.  The dry
    step's FLOPs, ATen bytes and ``pp`` bytes must equal
    ``real_roofline``'s (phase 6's or 15's ``[roofline]`` counts; None:
    counted here by ``roofline.analyze``, a warm-up and a counted step);
    its peak (argument + temp bytes) must come within DRY_PEAK_TOL of the
    real step's ``max_memory_allocated`` (from the state a warm-up step
    left, ``reset_peak_memory_stats`` just before; the bytes held before
    the state was made are taken off).  ``tp_ways`` > 1: a tensor-parallel
    node of that many model ranks in one process (placement ``"tp one
    process"``, ``StackedTP``), whose TP bytes must be equal too."""
    import gc

    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.tp import StackedTP
    from repro_torch.obs import roofline
    cfg = spec.model.build()
    shape = roofline.train_shape(spec)
    mesh = api.spec_mesh(spec) or mesh_mod.Mesh((spec.n_nodes, 1))
    t0 = time.perf_counter()
    dry = dryrun.dry_train(cfg, shape, mesh, spec=spec,
                           placement="one process" if tp_ways == 1
                           else "tp one process")
    dry_s = time.perf_counter() - t0
    runner = api.build_trainer_runner(
        spec, device=device, tp=StackedTP(tp_ways) if tp_ways > 1 else None)
    if real_roofline is None:
        rf = roofline.analyze(runner, cfg, shape, spec.n_nodes)
        real_roofline = dict(rf.as_dict(), tp_bytes=rf.tp_bytes)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    data = runner.default_data()
    draws = draws_mod.GeneratorDraws(spec.seed, runner.device)
    state, _ = runner.step(runner.init_state(), data.batch_at(0), draws)
    batch = data.batch_at(1)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    held = [state]
    del state
    held, _ = runner.step(held.pop(), batch, draws)
    if device == "cuda":
        torch.cuda.synchronize()
    real_peak = (torch.cuda.max_memory_allocated() - base
                 if device == "cuda" else 0)
    del held, batch
    dr = dry["roofline"]
    counts = {k: (dr[k], real_roofline[k])
              for k in ("hlo_flops_raw", "hlo_bytes_raw")}
    counts["pp_bytes"] = (dr["coll_breakdown"]["collective-permute"],
                          real_roofline["coll_breakdown"][
                              "collective-permute"])
    if tp_ways > 1:
        counts["tp_bytes"] = (dry["tp_bytes"], real_roofline["tp_bytes"])
    mem = dry["memory"]
    rel = (mem["peak_bytes"] - real_peak) / real_peak if real_peak else None
    out = {"spec": spec.name, "mesh": list(mesh.shape), "counts": counts,
           "memory": mem, "real_peak_bytes": real_peak,
           "real_base_bytes": base, "peak_rel_diff": rel,
           "kernels": dry["kernels"], "dry_s": dry_s}
    require(all(d == r for d, r in counts.values()),
            f"{spec.name}: the dry run's counts differ from the real "
            f"step's (dry, real): {counts}")
    require(rel is None or abs(rel) <= DRY_PEAK_TOL,
            f"{spec.name}: dry peak {mem['peak_bytes']:,} B vs the card's "
            f"{real_peak:,} B ({rel}): {out}")
    return out


def dry_sweep(out_dir=DRY_OUT, archs=None, timeout=DRY_SWEEP_TIMEOUT_S,
              jobs=None, placement=None):
    """Phase 16 (b): the production dry run by its CLI (``python -m
    repro_torch.launch.dryrun``, neighbor backend unless a job names its
    backend fourth), one process a job of ``jobs`` (default
    :func:`dry_sweep_jobs`), all started together (the
    meta device is the host's: the card's machine has 8 cores), each
    required to exit 0; ``placement`` the CLI's ``--placement`` (phase 17
    (d): ``"tp"``).  -> (records, seconds)."""
    import shutil
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if archs is None:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch import configs
        archs = configs.ARCH_IDS
    t0 = time.perf_counter()
    procs = []
    for a, shape, multi_pod, *backend in (jobs or dry_sweep_jobs(archs)):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               a, "--shape", shape, "--backend",
               backend[0] if backend else "neighbor", "--out",
               str(out_dir)] + (["--multi-pod"] if multi_pod else []) + (
            ["--placement", placement] if placement else [])
        procs.append((cmd, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    try:
        for cmd, proc in procs:
            try:
                out, _ = proc.communicate(
                    timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                failed.append(f"{' '.join(cmd[3:])}: past {timeout} s")
                continue
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd[3:])}: exit "
                              f"{proc.returncode}: {out[-1500:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    require(not failed, f"dry-run sweep: {failed}")
    recs = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    return recs, seconds


def dry_line(r) -> str:
    """One combo of the sweep: status, per-rank peak, fits, state bytes a
    model shard, the three roofline terms (the H100 data-sheet model) and
    the bottleneck, counted over analytic FLOPs, bits a round."""
    head = f"[dryrun] (16b) {r['arch']} x {r['shape']} x {r['mesh']}: "
    if r["status"] != "ok":
        return head + f"{r['status']} ({r.get('reason') or r.get('error')})"
    m, rl = r["memory"], r["roofline"]
    g = r.get("gossip")
    state = r.get("state_bytes_per_model_shard")
    return (head + f"ok, {r['placement']} ({r['cards']} cards), peak "
            f"{m['peak_bytes'] / 2 ** 30:.2f} GiB/card, fits {m['fits']}, "
            + (f"state {state:,} B/model shard" if state is not None
               else "no trainer state")
            + f", t_compute {rl['t_compute_s']:.4g} s, t_memory "
            f"{rl['t_memory_s']:.4g} s, t_collective "
            f"{rl['t_collective_s']:.4g} s, bottleneck {rl['bottleneck']}, "
            f"counted/analytic FLOPs "
            f"{rl['hlo_flops_raw'] / rl['flops_per_chip']:.4f}, "
            + (f"{g['bits_per_round']:,} bits/round" if g else "no wire")
            + f", {r['t_dry_s']} s")


# --- phase 17 ------------------------------------------------------------------

MESH_2X16 = (2, 16)
SLICE_2X16_HOPS = 1                    # a ring of two: one neighbour
SLICE_2X16_BITS_PER_HOP = 824_563_712  # a node's 16 shard payloads a hop
TP_TF_STEPS = 2          # teacher-forced steps of (a) and (b)
TP_STEP_TOL = 1e-5       # C4's step bar: within this x max|X| ...
TP_STEP_MAX_OFF = 1e-3   # ... on all but this fraction of each array
TP_CHECK_ROWS = 1 << 20  # B3's plain version checked this many rows a time
QINF_CHECK_BLOCKS = 1 << 16  # B1's and B2's, this many blocks a time
TP_TF_CARD_SHARE = 0.8   # teacher-forced states stay on the card below this


def tp_spec(api, mesh, steps: int = SLICE_STEPS, spec=None):
    """Phase 6's slice (or ``spec``) on ``mesh``: ``mesh[0]`` nodes on the
    ring, each node's model over ``mesh[1]`` model ranks."""
    base = spec or slice_spec(api, steps)
    return dataclasses.replace(
        base, name=f"{base.name}-mesh{mesh[0]}x{mesh[1]}", n_nodes=mesh[0],
        execution=dataclasses.replace(base.execution, mesh=mesh))


@contextlib.contextmanager
def checked_wire_kernels(torch, qk, ref, errs, what: str):
    """Every B3 and B4 launch in the block held, as it returns, to its
    plain version on the same operands (B3 TP_CHECK_ROWS rows at a time,
    B4 node by node: the plain temporaries stay small): bit-equal.
    ``calls`` [(kernel, operand shape)].  Restored on exit."""
    calls = []
    saved = {k: getattr(qk, k) for k in ("qinf_quantize_pack_blocks",
                                         "qinf_unpack_dequant_mix_blocks")}

    def b3(fn):
        @functools.wraps(fn)
        def inner(x, u, bits, *a, **k):
            out = fn(x, u, bits, *a, **k)
            for lo in range(0, x.shape[0], TP_CHECK_ROWS):
                sl = slice(lo, lo + TP_CHECK_ROWS)
                check_b3(torch, ref, x[sl], u[sl], bits,
                         (out[0][sl], out[1][sl]), errs, what)
            calls.append(("qinf_quantize_pack_blocks", list(x.shape)))
            return out
        return inner

    def b4(fn):
        @functools.wraps(fn)
        def inner(P, Sc, w, bits, *a, **k):
            out = fn(P, Sc, w, bits, *a, **k)
            dtype = a[0] if a else k.get("out_dtype", torch.float32)
            check_b4(torch, ref, P, Sc, w, bits, dtype, out, errs, what)
            calls.append(("qinf_unpack_dequant_mix_blocks", list(P.shape)))
            return out
        return inner

    qk.qinf_quantize_pack_blocks = b3(saved["qinf_quantize_pack_blocks"])
    qk.qinf_unpack_dequant_mix_blocks = b4(
        saved["qinf_unpack_dequant_mix_blocks"])
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(qk, name, fn)


@contextlib.contextmanager
def checked_qinf_kernels(torch, ops, qk, ref, errs, what: str):
    """Every B1 and B2 launch in the block held, as it returns, to its
    plain version on the same operands, bit for bit: B1's leaf (..., D)
    blocked and padded as the plain path pads it, B2's (R, block) codes,
    QINF_CHECK_BLOCKS blocks a time (the plain temporaries stay small
    beside a full card); a B1 launch with a level count a point (a
    stacked grid's bits axis) at each row's level count.  ``calls``
    [(kernel, operand shape)].  Restored on exit."""
    calls = []
    saved = {k: getattr(qk, k) for k in (B1, B2)}

    def b1(fn):
        @functools.wraps(fn)
        def inner(x, u, bits, levels=None):
            out = fn(x, u, bits, levels)
            D, block = (x.shape[-1] if x.dim() else 1), u.shape[-1]
            xr, ur = x.reshape(-1, D), u.reshape(-1, block)
            codes, scales = out[0].reshape(-1, block), out[1].reshape(-1, 1)
            lv = (None if levels is None
                  else ref.levels_per_row(levels, ur.shape[0]))
            nb = ur.shape[0] // xr.shape[0]
            step = max(1, QINF_CHECK_BLOCKS // nb)
            for lo in range(0, xr.shape[0], step):
                rows = slice(lo, lo + step)
                blocks = slice(lo * nb, (lo + step) * nb)
                xb = ops.blockwise_lastdim(xr[rows], block=block)
                cp, sp = ref.qinf_quantize_blocks_ref(
                    xb.reshape(-1, block), ur[blocks], bits,
                    None if lv is None else lv[blocks])
                ck, sk = codes[blocks], scales[blocks]
                e = max(float((ck.int() - cp.int()).abs().max()),
                        float((sk - sp).abs().max()))
                errs[B1] = max(errs[B1], e)
                require(torch.equal(ck, cp) and torch.equal(sk, sp),
                        f"B1 != plain {what}: leaf {tuple(x.shape)} "
                        f"{x.dtype}, bits {bits}, rows from {lo} (max diff "
                        f"{e})")
            calls.append((B1, list(x.shape)))
            return out
        return inner

    def b2(fn):
        @functools.wraps(fn)
        def inner(codes, scales, out_dtype=torch.float32):
            out = fn(codes, scales, out_dtype)
            for lo in range(0, codes.shape[0], QINF_CHECK_BLOCKS):
                sl = slice(lo, lo + QINF_CHECK_BLOCKS)
                dp = ref.qinf_dequantize_blocks_ref(codes[sl], scales[sl],
                                                    out_dtype)
                e = float((out[sl].double() - dp.double()).abs().max())
                errs[B2] = max(errs[B2], e)
                require(torch.equal(out[sl], dp), f"B2 != plain {what}: "
                        f"codes {tuple(codes.shape)} -> {out_dtype}, rows "
                        f"from {lo} (max diff {e})")
            calls.append((B2, list(codes.shape)))
            return out
        return inner

    qk.qinf_quantize_blocks = b1(saved[B1])
    qk.qinf_dequantize_blocks = b2(saved[B2])
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(qk, name, fn)


def host_parking(torch, device: str, on_card: bool):
    """How a check parks a state it is not using: as it is where the
    states fit on the card (or the run is on the CPU), else in
    page-locked host memory, whose copies run at the link's rate
    (pageable memory took 2.5-7.6x as long, PERF.md).  The caching host
    allocator keeps the buffers for the next step;
    :func:`release_host_cache` returns them after the check."""
    if on_card or device != "cuda":
        return lambda x: x
    return lambda x: torch.empty(x.shape, dtype=x.dtype,
                                 pin_memory=True).copy_(x)


def release_host_cache(torch, device: str) -> None:
    """Free the page-locked buffers the caching host allocator keeps, so
    the next check's states of other sizes do not pile on them."""
    if device == "cuda":
        fn = getattr(torch._C, "_host_emptyCache", None) or getattr(
            torch._C, "_accelerator_emptyHostCache")
        fn()


def tp_teacher_forced(torch, api, draws_mod, tree, qk, ref, errs, spec,
                      M: int, steps: int = TP_TF_STEPS,
                      device: str = "cuda", elem_tol: float = TP_STEP_TOL):
    """Phase 17 (a)/(b), teacher-forced: ``steps`` steps of ``spec`` as a
    tensor-parallel node (``StackedTP(M)``), each from the whole-node
    run's state (cut into rank-rows) and with its draws (two generators
    seeded alike and called alike), against the whole-node step of phase
    15's program: X, D, H and Hw within ``elem_tol`` (TP_STEP_TOL) of each
    array's largest entry on all but TP_STEP_MAX_OFF of its elements (C4's
    bar; RWKV-6's is SSM_REPLAY_ELEM_TOL),
    the node loss within 1e-5 relative.  Every kernel launch of the first
    TP step is held to its plain version on the same operands: B3 and B4
    on the bucketed wire (:func:`checked_wire_kernels`, once per bucket
    group), B1 and B2 where the per-leaf wire or the dense backend
    quantize whole leaves (:func:`checked_qinf_kernels`, once a leaf, B2
    once more a hop on the per-leaf wire).  Where three states fit
    TP_TF_CARD_SHARE of the card (the whole node's, the split node's and
    a step's activations, about one state's) both states stay on the
    card; otherwise the state not in use waits on the host
    (:func:`host_parking`), so the card holds one state and one step at
    a time."""
    from repro_torch.core.comm import CommState
    from repro_torch.core.prox_lead import ProxLEADState
    from repro_torch.kernels import ops
    from repro_torch.models.tp import StackedTP
    from repro_torch.optim.decentralized import TrainState
    whole = api.build_trainer_runner(spec, device=device)
    run = api.build_trainer_runner(spec, device=device, tp=StackedTP(M))
    tr = run.trainer
    leads = (1, 1, 1, 1 if tr.hw_slots is None else 2)
    bucketed = tr.sharded and tr.tcfg.wire_mode == "bucketed"
    groups = len(tr.wire_layout().groups) if bucketed else 0
    n_leaves = len(tr.leaf_specs)
    b2_a_leaf = 1 + (len(tr.plan.hops) if tr.plan and not bucketed else 0)
    data = whole.default_data()
    dw = draws_mod.GeneratorDraws(spec.seed, device)
    dt = draws_mod.GeneratorDraws(spec.seed, device)

    def parts(st):
        p = st.plead
        return [p.X, p.D, p.comm.H, p.comm.Hw]

    def state_of(trees, meta):
        (oracle, k, step), (X, D, H, Hw) = meta, trees
        return TrainState(ProxLEADState(X, D, CommState(H, Hw), oracle, k),
                          step, None)

    sw = whole.init_state()
    treedef = tree.flatten(sw.plead.X)[1]
    state_bytes = sum(nbytes(*tree.leaves(t)) for t in parts(sw))
    on_card = device == "cuda" and 3 * state_bytes <= TP_TF_CARD_SHARE * \
        torch.cuda.get_device_properties(0).total_memory
    park = host_parking(torch, device, on_card)

    def held_to_whole(tp_parts, w_host, k):
        """The TP step's (X, D, H, Hw) joined and held to the whole node's
        (on the host) -> (the whole trees on the card, worst off
        fraction, worst |diff| / max); nothing else stays on the card."""
        back, worst_off, worst_rel = [], 0.0, 0.0
        for t_tp, t_w, lead, name in zip(tp_parts, w_host, leads,
                                         ("X", "D", "H", "Hw")):
            leaves = []
            for j, (g, wh) in enumerate(zip(tree.leaves(t_tp),
                                            tree.leaves(t_w))):
                w = wh.to(device)
                diff = (tr.tp.join([g], [tr.leaf_specs[j]], lead)[0]
                        - w).abs()
                scale = max(float(w.abs().max()), 1e-30)
                off = float((diff > elem_tol * scale).float().mean())
                worst_off = max(worst_off, off)
                worst_rel = max(worst_rel, float(diff.max()) / scale)
                require(off <= TP_STEP_MAX_OFF, f"{spec.name} step {k}: "
                        f"{name} leaf {j} off on {off:.2e} of its elements")
                leaves.append(w)
                del diff
            back.append(tree.unflatten(treedef, leaves))
        return back, worst_off, worst_rel

    worst_off = worst_rel = 0.0
    losses, checked, t0 = [], [], time.perf_counter()
    for k in range(steps):
        meta = (sw.plead.oracle, sw.plead.k, sw.step)
        tp_host = [tree.unflatten(treedef, [
            park(tr.tp.cut([x], [sp], lead)[0])
            for x, sp in zip(tree.leaves(t), tr.leaf_specs)])
            for t, lead in zip(parts(sw), leads)]
        batch = data.batch_at(k)
        sw, mw = whole.step(sw, batch, dw)
        w_meta = (sw.plead.oracle, sw.plead.k, sw.step)
        w_host = [tree.tree_map(park, t) for t in parts(sw)]
        del sw
        if device == "cuda":
            torch.cuda.empty_cache()
        st = state_of([tree.tree_map(lambda x: x.to(device), t)
                       for t in tp_host], meta)
        del tp_host
        if k == 0 and bucketed:
            with checked_wire_kernels(torch, qk, ref, errs,
                                      f"at {spec.name}'s TP layout") as cl:
                st, mt = run.step(st, batch, dt)
            require(len(cl) == 2 * groups, f"{spec.name} TP step: "
                    f"{len(cl)} B3/B4 launches, want 2 x {groups} groups")
            checked = cl
        elif k == 0:
            with checked_qinf_kernels(torch, ops, qk, ref, errs,
                                      f"at {spec.name}'s TP leaves") as cl:
                st, mt = run.step(st, batch, dt)
            n1 = sum(c[0] == B1 for c in cl)
            require(n1 == n_leaves and len(cl) - n1 == n_leaves * b2_a_leaf,
                    f"{spec.name} TP step: {n1} B1 and {len(cl) - n1} B2 "
                    f"launches, want {n_leaves} and {n_leaves * b2_a_leaf}")
            checked = cl
        else:
            st, mt = run.step(st, batch, dt)
        lw, lt = float(mw["loss"]), float(mt["loss"])
        require(abs(lt - lw) <= 1e-5 * abs(lw), f"{spec.name} step {k}: "
                f"TP loss {lt} vs whole-node {lw}")
        losses.append([lw, lt])
        back, off, rel = held_to_whole(parts(st), w_host, k)
        worst_off, worst_rel = max(worst_off, off), max(worst_rel, rel)
        del st, w_host
        sw = state_of(back, w_meta)   # the whole state returns to the card
        del back
    del sw
    release_host_cache(torch, device)
    return {"spec": spec.name, "M": M, "steps": steps, "losses": losses,
            "worst_off_fraction": worst_off, "worst_rel_max": worst_rel,
            "wire_checked": checked, "bucket_groups": groups,
            "states_on_card": on_card, "seconds": time.perf_counter() - t0}


def tp_phase(torch, api, draws_mod, tree, qk, ref, errs, spec, M: int, *,
             hops: int, bits_per_hop: int, device: str = "cuda",
             steps: int = SLICE_STEPS,
             profile_steps: int = SLICE_PROFILE_STEPS,
             tf_steps: int = TP_TF_STEPS, trace_name: str = "tp_trace.json"):
    """Phase 17 (a) or (b): ``spec`` (phase 6's slice on an (N, M) mesh)
    as a tensor-parallel node: the teacher-forced steps
    (:func:`tp_teacher_forced`), then ``trainer_path`` under
    ``StackedTP(M)``: ``steps`` free-running steps with the launch
    counters zeroed just before and read just after (B3 and B4 once per
    bucket group a step), the loss falling and finite, ``bits_per_step``
    = hops x ``bits_per_hop``, the ``[contracts]`` line under
    ``set_sync_debug_mode("error")`` and the ``[roofline]`` line with the
    TP bytes a step, peak memory and the median step."""
    from repro_torch.models.tp import StackedTP
    if device == "cuda":
        torch.cuda.empty_cache()
    tf = tp_teacher_forced(torch, api, draws_mod, tree, qk, ref, errs, spec,
                           M, steps=tf_steps, device=device)
    if device == "cuda":
        torch.cuda.empty_cache()
    out = trainer_path(torch, api, draws_mod, qk, steps=steps, spec=spec,
                       device=device, profile_steps=profile_steps, hops=hops,
                       bits_per_hop=bits_per_hop, trace_name=trace_name,
                       tp=StackedTP(M))
    out["teacher_forced"] = tf
    return out


def tp_dry_line(r) -> str:
    """One combo of the TP sweep: per-rank peak, fits, the rank's state
    bytes beside ``state_bytes_per_model_shard`` (a train step) or its
    cache bytes beside the whole node's / M (a decode step), the TP bytes
    a step, the roofline terms."""
    head = f"[tp] (17d) {r['arch']} x {r['shape']} x {r['mesh']}: "
    if r["status"] != "ok":
        return head + f"{r['status']} ({r.get('reason') or r.get('error')})"
    m, rl = r["memory"], r["roofline"]
    state = r.get("state_bytes_per_rank")
    cache = r.get("cache_bytes_per_rank")
    return (head + f"ok, rank (0, 0) of {r['cards']}, peak "
            f"{m['peak_bytes'] / 2 ** 30:.2f} GiB/card, fits {m['fits']}, "
            + (f"state {state:,} B/rank = {r['state_bytes_per_model_shard']:,}"
               f" B/model shard, " if state is not None else "")
            + (f"cache {cache:,} B/rank (whole node "
               f"{r['cache_bytes_whole_node']:,} B, / M "
               f"{r['cache_bytes_even_split']:,} B), " if cache is not None
               else "")
            + f"TP {r['tp_bytes']:,.0f} B/step "
            f"{ {k: int(v) for k, v in r['tp_breakdown'].items()} }, "
            f"t_compute {rl['t_compute_s']:.4g} s, t_memory "
            f"{rl['t_memory_s']:.4g} s, t_collective "
            f"{rl['t_collective_s']:.4g} s, bottleneck {rl['bottleneck']}, "
            f"{r['t_dry_s']} s")


def tp_node_phase(torch, api, configs, draws_mod, tree, qk, ref, errs, smi,
                  ms_=None):
    """Phase 17 (a)-(d) (see the module docstring); ``ms_``: phase 15
    (b)'s result, for the whole-node (8, 2) step time and peak beside
    (a)'s.  -> the phase's results."""
    t0 = time.perf_counter()
    p17 = {}
    torch.cuda.empty_cache()
    for key, mesh_, hops_, bph, prof in (
            ("a", MESH_8X2, 2, SLICE_8X2_BITS_PER_HOP,
             SLICE_PROFILE_STEPS),
            ("b", MESH_2X16, SLICE_2X16_HOPS, SLICE_2X16_BITS_PER_HOP,
             0)):
        tpx = tp_phase(torch, api, draws_mod, tree, qk, ref, errs,
                       tp_spec(api, mesh_), mesh_[1], hops=hops_,
                       bits_per_hop=bph, profile_steps=prof,
                       trace_name=f"tp_{mesh_[0]}x{mesh_[1]}_trace.json")
        p17[key] = tpx
        tf = tpx["teacher_forced"]
        require(tpx["bits_per_step"] == hops_ * bph,
                f"{tpx['spec']}: bits_per_step {tpx['bits_per_step']}")
        print(f"[tp] (17{key}) {tf['spec']} under StackedTP({tf['M']}): "
              f"{tf['steps']} steps teacher-forced against the "
              f"whole-node {mesh_} step: worst off fraction "
              f"{tf['worst_off_fraction']:.2e}, worst |diff|/max "
              f"{tf['worst_rel_max']:.2e}, losses (whole, TP) "
              f"{tf['losses']}; {len(tf['wire_checked'])} B3/B4 "
              f"launches bit-equal to the plain versions "
              f"{[s_ for _, s_ in tf['wire_checked']]}; "
              f"{tf['seconds']:.1f} s", flush=True)
        print(f"[tp] (17{key}) {tpx['spec']}: {tpx['steps']} steps, loss "
              f"(mean of {LOSS_WINDOW}) {tpx['loss_first_window']:.6f} "
              f"-> {tpx['loss_last_window']:.6f}, held out "
              f"{tpx['held_out_loss'][0]:.6f} -> "
              f"{tpx['held_out_loss'][1]:.6f}; launches "
              f"{tpx['launches']} ({tpx['bucket_groups']} bucket "
              f"groups); {tpx['bits_per_step']:.0f} bits/step/node",
              flush=True)
        rl = tpx["roofline"]
        versus = (f" vs phase 15's whole-node (8, 2) "
                  f"{ms_['step_ms_median']:.1f} ms, peak "
                  f"{ms_['peak_mem_gb']:.2f} GiB" if key == "a" and ms_
                  else "")
        print(f"[tp] (17{key}) step {tpx['step_ms_median']:.1f} ms "
              f"median ({tpx['step_ms_min']:.1f} min), peak "
              f"{tpx['peak_mem_gb']:.2f} GiB{versus}; TP "
              f"{rl['tp_bytes']:,.0f} B a rank-row a step "
              f"{ {k_: int(v) for k_, v in rl['tp_breakdown'].items()} }"
              f"; set-up {tpx['setup_s']:.1f} s | {smi}", flush=True)
        if tpx["profile"]:
            pf = tpx["profile"]
            print(f"[tp] (17{key}) profile: {pf['wall_ms_per_step']:.1f} "
                  f"ms/step wall, {pf['device_ms_per_step']:.1f} ms/step "
                  f"on the device (busy {pf['busy_share']:.1%}), "
                  f"{pf['device_ops_per_step']:.0f} device ops/step",
                  flush=True)
            print_wire_share("[tp]", pf)
        print_contracts_and_roofline(f"(17{key})", tpx, smi)
        torch.cuda.empty_cache()
    da = dry_against_real(torch, api, draws_mod, tp_spec(api, MESH_8X2),
                          p17["a"]["roofline"], tp_ways=MESH_8X2[1])
    p17["c"] = da
    c, m = da["counts"], da["memory"]
    print(f"[tp] (17c) {da['spec']} at {da['mesh']}, tp one process, "
          f"dry ({da['dry_s']:.1f} s) = real: FLOPs "
          f"{c['hlo_flops_raw'][0]:.6e} = {c['hlo_flops_raw'][1]:.6e}, "
          f"ATen bytes {c['hlo_bytes_raw'][0]:.6e} = "
          f"{c['hlo_bytes_raw'][1]:.6e}, pp bytes "
          f"{c['pp_bytes'][0]:,.0f} = {c['pp_bytes'][1]:,.0f}, TP bytes "
          f"{c['tp_bytes'][0]:,.0f} = {c['tp_bytes'][1]:,.0f}; peak "
          f"{m['peak_bytes']:,} B vs max_memory_allocated "
          f"{da['real_peak_bytes']:,} B ({da['peak_rel_diff']:+.2%}) | "
          f"{smi}", flush=True)
    torch.cuda.empty_cache()
    from repro_torch.configs import shapes as shp17
    jobs17 = dry_sweep_jobs(configs.ARCH_IDS)
    recs17, sweep17 = dry_sweep(out_dir=OUT_DIR / "dryrun_torch_tp",
                                jobs=jobs17, placement="tp")
    for r in recs17:
        print(tp_dry_line(r), flush=True)
    want17 = {}
    for a, shape_, mp_ in jobs17:
        for s_ in (shp17.SHAPES if shape_ == "all" else (shape_,)):
            cfg_, sh_ = configs.get(a), shp17.SHAPES[s_]
            want17[(a, s_, "2pod" if mp_ else "1pod")] = (
                "ok" if shp17.applicable(cfg_, sh_) is None else "skipped")
    got17 = {(r["arch"], r["shape"], r["mesh"]): r["status"]
             for r in recs17}
    require(got17 == want17, f"TP dry-run sweep: got {got17}, want "
            f"{want17}")
    require(all(r["state_bytes_per_rank"]
                == r["state_bytes_per_model_shard"]
                for r in recs17 if r["status"] == "ok"
                and r["shape"] == "train_4k"),
            "a TP rank's state is not one model shard's")
    st17 = [r["status"] for r in recs17]
    p17.update(sweep=recs17, sweep_s=sweep17,
               seconds=time.perf_counter() - t0)
    print(f"[tp] (17d) {len(recs17)} combos: {st17.count('ok')} ok, "
          f"{st17.count('skipped')} skipped (the reference's skips), 0 "
          f"errors, in {sweep17:.1f} s ({len(jobs17)} processes; "
          f"{', '.join(DRY_LOOPED)} x train_4k, prefill_32k by the CLI "
          f"only); phase {p17['seconds']:.1f} s; "
          f"DistTP across processes not run here: one card, and NCCL "
          f"refuses two ranks on one device | {smi}", flush=True)
    return p17


# --- phase 18 ------------------------------------------------------------------

#: (arch, overrides of the published configuration: the depth cut and the
#: vocabulary's first eighth, N): phase 18 (a)'s recurrent trainers on the
#: mesh (N, 2).  N is the largest of 8, 4, 2 whose whole-node (N, 2) step
#: peaks under FAMILY_PEAK_GB by ``repro_torch.launch.dryrun`` (placement
#: "one process", on the CPU): rwkv6-7b 75.9 GiB at 8, 38.0 at 4;
#: recurrentgemma-9b 112.1 at 4, 54.4 at 2
TP_RECURRENT = (("rwkv6-7b", {"n_layers": 1, "vocab": 8192}, 4),
                ("recurrentgemma-9b", {"n_layers": 3, "vocab": 32000}, 2))
TP_RECURRENT_SEQ = 512
TP_WHOLE_STEPS = 2 * LOSS_WINDOW   # the whole node's steps beside the split
TP_SERVE_M = 2               # phase 11's architectures at M = 2, then ...
#: ... (arch, overrides, M) whose ranks cut heads: recurrentgemma's one KV
#: head in 16 (one query head a rank), whisper's 20 heads in 8 (2.5 a rank)
TP_SERVE_CUT = (("recurrentgemma-9b", {"n_layers": 3}, 16),
                ("whisper-large-v3", {}, 8))


def recurrent_tp_trainer(torch, api, draws_mod, tree, TR, qk, ref, errs,
                         spec, *, device: str = "cuda",
                         steps: int = SLICE_STEPS,
                         whole_steps: int = TP_WHOLE_STEPS,
                         profile_steps: int = SLICE_PROFILE_STEPS,
                         tf_steps: int = TP_TF_STEPS):
    """Phase 18 (a), one family: ``tf_steps`` steps of ``spec`` under
    ``StackedTP(2)`` teacher-forced against the whole-node (N, 2) step
    (:func:`tp_teacher_forced`: C4's bar, RWKV-6's SSM_REPLAY_ELEM_TOL;
    every B3 and B4 launch of the first bit-equal to its plain version),
    then ``whole_steps`` free steps of the whole node (its median step and
    peak, under FAMILY_PEAK_GB) and ``steps`` of the split node
    (:func:`trainer_path`: the loss falls and stays finite, B3/B4 once per
    bucket group a step, ``bits_per_step`` = the ring's hops (one on a
    ring of two) x the host recount; the split node's ``[contracts]`` and
    ``[roofline]`` lines)."""
    from repro_torch.models.tp import StackedTP
    full = spec.model.full
    hops = 1 if spec.n_nodes == 2 else 2      # a ring of two: one neighbour
    tr = api.build(spec, device="cpu").trainer
    bph = host_bits_per_hop(tr, tree, TR)
    del tr
    tol = (SSM_REPLAY_ELEM_TOL if spec.model.arch == "rwkv6-7b"
           else TP_STEP_TOL)
    if device == "cuda":
        torch.cuda.empty_cache()
    tf = tp_teacher_forced(torch, api, draws_mod, tree, qk, ref, errs, spec,
                           2, steps=tf_steps, device=device, elem_tol=tol)
    out = {"spec": spec.name, "mesh": list(spec.execution.mesh),
           "hops": hops, "host_bits_per_hop": bph, "elem_tol": tol,
           "teacher_forced": tf}
    for key, tp, n, prof in (("whole", None, whole_steps, 0),
                             ("tp", StackedTP(2), steps, profile_steps)):
        if device == "cuda":
            torch.cuda.empty_cache()
        out[key] = trainer_path(
            torch, api, draws_mod, qk, steps=n, spec=spec, device=device,
            profile_steps=prof, hops=hops, bits_per_hop=bph, tp=tp,
            trace_name=f"tp_{spec.model.arch}_trace.json",
            peak_limit_gb=(FAMILY_PEAK_GB if device == "cuda" and tp is None
                           and full else None), audit=tp is not None)
    # RWKV-6's trace (~20,000 device ops a step) outgrows what a chip
    # call brings back; its numbers are in the result
    (OUT_DIR / f"tp_{spec.model.arch}_trace.json").unlink(missing_ok=True)
    return out


def tp_recurrent_phase(torch, api, configs, draws_mod, tree, TR, serve, qk,
                       ref, errs, smi, sv=None, device: str = "cuda",
                       trainers=TP_RECURRENT, serve_cases=None,
                       full: bool = True, seq_len: int = TP_RECURRENT_SEQ,
                       steps: int = SLICE_STEPS,
                       profile_steps: int = SLICE_PROFILE_STEPS,
                       tf_steps: int = TP_TF_STEPS,
                       frames: int = SERVE_FRAMES):
    """Phase 18 (a) and (b) (see the module docstring); ``sv``: phase 11's
    result, for the whole node's serving numbers beside (b)'s;
    ``serve_cases`` (arch, overrides, M), default phase 11's at
    TP_SERVE_M and TP_SERVE_CUT; ``full``, ``seq_len``, ``steps``,
    ``profile_steps``, ``tf_steps`` and ``frames`` cut a rehearsal on the
    CPU.  -> the phase's results."""
    t0 = time.perf_counter()
    p18 = {"trainers": [], "serve": []}
    for arch, ov, n in trainers:
        spec = tp_spec(api, (n, 2), spec=family_spec(
            api, arch, steps, full=full, params=ov, seq_len=seq_len,
            name=f"{arch}-{ov['n_layers']}L-vocab8-qinf2"))
        r = recurrent_tp_trainer(torch, api, draws_mod, tree, TR, qk, ref,
                                 errs, spec, device=device, steps=steps,
                                 profile_steps=profile_steps,
                                 tf_steps=tf_steps)
        p18["trainers"].append(r)
        tf, w, t = r["teacher_forced"], r["whole"], r["tp"]
        print(f"[tp18] (18a) {r['spec']} under StackedTP(2): {tf['steps']} "
              f"steps teacher-forced against the whole-node {r['mesh']} "
              f"step (element bar {r['elem_tol']:g} x max): worst off "
              f"fraction {tf['worst_off_fraction']:.2e}, worst |diff|/max "
              f"{tf['worst_rel_max']:.2e}, losses (whole, TP) "
              f"{tf['losses']}; {len(tf['wire_checked'])} B3/B4 launches "
              f"bit-equal to the plain versions "
              f"{[s_ for _, s_ in tf['wire_checked']]}; "
              f"{tf['seconds']:.1f} s", flush=True)
        for key, x in (("whole", w), ("TP", t)):
            rl = x["roofline"] or {"tp_bytes": 0, "tp_breakdown": {}}
            print(f"[tp18] (18a) {key}: {x['steps']} steps, loss (mean of "
                  f"{LOSS_WINDOW}) {x['loss_first_window']:.6f} -> "
                  f"{x['loss_last_window']:.6f}, held out "
                  f"{x['held_out_loss'][0]:.6f} -> "
                  f"{x['held_out_loss'][1]:.6f}; launches {x['launches']} "
                  f"({x['bucket_groups']} bucket groups); "
                  f"{x['bits_per_step']:.0f} bits/step/node = {r['hops']} "
                  f"hop(s) x {r['host_bits_per_hop']:,} (host count); step "
                  f"{x['step_ms_median']:.1f} ms median "
                  f"({x['step_ms_min']:.1f} min), peak "
                  f"{x['peak_mem_gb']:.2f} GiB; TP "
                  f"{rl['tp_bytes']:,.0f} B a rank-row a step "
                  f"{ {k_: int(v) for k_, v in rl['tp_breakdown'].items()} }"
                  f" | {smi}", flush=True)
            if x["profile"]:
                pf = x["profile"]
                print(f"[tp18] (18a) profile: {pf['wall_ms_per_step']:.1f} "
                      f"ms/step wall, {pf['device_ms_per_step']:.1f} ms/step "
                      f"on the device (busy {pf['busy_share']:.1%}), "
                      f"{pf['device_ops_per_step']:.0f} device ops/step",
                      flush=True)
                print_wire_share("[tp18]", pf)
            if x["contracts"] is not None:
                print_contracts_and_roofline(f"(18a {key})", x, smi)
    if serve_cases is None:
        serve_cases = [(a, ov, TP_SERVE_M) for a, ov in SERVE_CASES] + list(
            TP_SERVE_CUT)
    whole_by_arch = {r["arch"]: r for r in (sv or {}).get("archs", [])}
    for arch, ov, M in serve_cases:
        r = serve_arch(torch, configs, TR, serve, arch, ov, device=device,
                       frames=frames, M=M)
        p18["serve"].append(r)
        w = whole_by_arch.get(arch)
        versus = (f" (phase 11, whole node: prefill {w['prefill_ms']:.2f} "
                  f"ms, decode {w['decode_ms_per_step']:.2f} ms/step, "
                  f"{w['tokens_per_s']:.1f} tok/s, peak "
                  f"{w['peak_mem_gb']:.2f} GiB)" if w and w["overrides"] == ov
                  else "")
        kv = ("" if r["kv_heads_per_rank"] is None else
              f", {r['kv_heads_per_rank']} KV head(s) a rank")
        print(f"[tp18] (18b) {arch} {ov or 'published depth'} under "
              f"StackedTP({M}){kv}: "
              f"batch {r['batch']}, prompt {r['prompt']}, gen {r['gen']}: "
              f"prefill {r['prefill_ms']:.2f} ms, decode "
              f"{r['decode_ms_per_step']:.2f} ms/step, "
              f"{r['tokens_per_s']:.1f} tok/s, peak {r['peak_mem_gb']:.2f} "
              f"GiB{versus}; logits vs the whole node's teacher-forced "
              f"max |diff| {r['max_abs_diff']:.3e} of max |logit| "
              f"{r['max_abs_logit']:.3e}"
              + ("; token-shift caches bit-equal over the ranks"
                 if r["shift_caches_bit_equal"] else "") + f" | {smi}",
              flush=True)
    p18["seconds"] = time.perf_counter() - t0
    print(f"[tp18] phase 18 {p18['seconds']:.1f} s | {smi}", flush=True)
    return p18


# --- phase 12 ------------------------------------------------------------------

FAMILY_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b", "rwkv6-7b",
                "recurrentgemma-9b", "llama-3.2-vision-90b",
                "whisper-large-v3")
FAMILY_PEAK_GB = 70          # phase 6's bound on the trainer's peak
#: RWKV-6's card-vs-CPU element tolerance (x max): its per-head group norm
#: divides by sqrt(var + 6.4e-4) on heads whose outputs are small, so its
#: gradients agree across summation orders to ~1e-4 of their largest entry
#: (tests/test_torch_models.py: SSM_GRAD_TOL), and its zero-initialised
#: leaves are -eta G after a step; the bound of those CPU tests
SSM_REPLAY_ELEM_TOL = 3e-4
#: (arch, name, model overrides, seq_len): the two full-width trainers
FAMILY_TRAINERS = (
    ("whisper-large-v3", "whisper-large-v3-1+1L-ring8-qinf2",
     {"n_layers": 1, "n_enc_layers": 1}, 448),
    ("deepseek-moe-16b", "deepseek-moe-16b-1L-16x-vocab8-ring8-qinf2",
     {"n_layers": 1, "vocab": 12800, "n_experts": 16}, 512))


def family_spec(api, arch: str, steps: int, *, name: str, full: bool,
                params=None, seq_len: int = 64):
    """``arch`` on the sharded engine: 8 nodes on a ring, the neighbor
    backend with the bucketed wire, 2-bit QInf in 256-blocks, the slice's
    step sizes; ``full`` keeps the published widths with ``params``
    overriding fields (the cuts), else the reference's ``.reduced()``."""
    model = (api.ModelSpec(arch=arch, full=True, local_batch=2,
                           seq_len=seq_len, params=params or {})
             if full else api.ModelSpec(arch=arch, full=False, n_layers=2,
                                        d_model=256, local_batch=2,
                                        seq_len=seq_len))
    return dataclasses.replace(slice_spec(api, steps), name=name,
                               model=model)


def host_bits_per_hop(tr, tree, TR) -> int:
    """The bits a node sends a neighbour per hop, recounted on the host
    from the parameter shapes: per leaf, rows x packed bytes per row plus
    a 4-byte scale a row (block = the configured one, capped at an even
    narrower last dim); on a model-sharded wire of M shards, M x the bits
    of each leaf's model-local slice (every shard moves a replicated leaf
    whole)."""
    import numpy as np
    from repro_torch.models import sharding
    bits, block, M = tr.tcfg.bits, tr.tcfg.block, tr.wire_shards
    total = 0
    for p, sp in zip(tree.leaves(TR.abstract_params(tr.mcfg)),
                     tr.leaf_specs):
        shape = sharding.model_local_shape(tuple(p.shape), sp, M) or (1,)
        last = shape[-1]
        b = last if last % 2 == 0 and last < block else block
        rows = int(np.prod(shape[:-1], dtype=np.int64)) * -(-last // b)
        width = b // 2 if bits + 1 <= 4 else b
        total += M * rows * (width + 4)
    return 8 * total


def family_wire_cases(api, tree, TR, trainer_specs):
    """(where, block, rows a node) for B3/B4 at the families' block widths:
    every width below 256 in the published widths and depth of each
    family's 8-node neighbor trainer (from shapes alone), then each group
    of the full-width trainers of this phase (block 16 and 256 among
    them)."""
    cases, seen = [], set()
    for arch in FAMILY_ARCHS:
        spec = family_spec(api, arch, 1, name=arch, full=True)
        tr = api.build(spec, device="cpu").trainer
        for gr in tr.wire_layout().groups:
            if gr.block < 256 and gr.block not in seen:
                seen.add(gr.block)
                cases.append((f"{arch} (published)", gr.block,
                              gr.rows))
    for spec in trainer_specs:
        tr = api.build(spec, device="cpu").trainer
        for gr in tr.wire_layout().groups:
            cases.append((spec.name, gr.block, gr.rows))
    return sorted(cases, key=lambda c: (c[1], c[2]))


def wire_case(torch, qk, ref, errs, block: int, rows: int, n_nodes: int = 8,
              plain_iters: int = 3, device: str = "cuda", shards: int = 1):
    """B3 on (n_nodes x shards x rows, block) f32 rows and B4 on their
    ring payloads (S = 3, T = 1, weights 1/3, f32 out), each against its
    plain version (bit-equal) and timed (CUDA events) beside its
    bytes-or-operations bound; ``shards``: model shards a node, ``rows``
    a shard's."""
    g = torch.Generator(device=device).manual_seed(block)
    R = n_nodes * shards * rows
    x = torch.randn((R, block), generator=g, device=device)
    u = torch.rand((R, block), generator=g, device=device)
    what = (f"at block {block} ({n_nodes} x {shards} x {rows} rows)"
            if shards > 1 else f"at block {block} ({n_nodes} x {rows} rows)")
    b3_vector = b3_vector_expected(block, 2)
    require(device != "cuda" or qk.uses_vector_variant(
        "qinf_quantize_pack_blocks", x, u, 2) is b3_vector,
        f"B3 {what} must take the {'vector' if b3_vector else 'row'} "
        f"variant")
    packed, scales = qk.qinf_quantize_pack_blocks(x, u, 2)
    check_b3(torch, ref, x, u, 2, (packed, scales), errs, what)
    b3 = {"variant": "vector" if b3_vector else "row",
          "ms": cuda_ms(torch, lambda: qk.qinf_quantize_pack_blocks(x, u, 2)),
          "plain_ms": cuda_ms(
              torch, lambda: ref.qinf_quantize_pack_blocks_ref(x, u, 2),
              iters=plain_iters, warmup=1), "library_ms": None}
    b3["bound_ms"], b3["bound_by"] = wire_bound(
        torch, "B3", block, rows, n_nodes, nbytes(x, u, packed, scales),
        ops=B3_OPS_PER_ELEMENT * x.numel(), shards=shards)
    del x, u
    P, Sc = ring_payloads(torch, packed, scales, n_nodes * shards, rows,
                          shift=shards)
    del packed, scales
    w = torch.full((n_nodes * shards, 1, 3), 1.0 / 3.0, device=device)
    mix, qself = qk.qinf_unpack_dequant_mix_blocks(P, Sc, w, 2)
    vector = b4_vector_expected(P.shape[-1], torch.float32)
    require(device != "cuda" or qk.uses_vector_variant(
        "qinf_unpack_dequant_mix_blocks", P, mix, qself) is vector,
        f"B4 {what} must take the {'vector' if vector else 'row'} variant")
    check_b4(torch, ref, P, Sc, w, 2, torch.float32, (mix, qself), errs,
             what)
    b4 = {"variant": "vector" if vector else "row", "library_ms": None}
    b4["bound_ms"], b4["bound_by"] = wire_bound(
        torch, "B4", block, rows, n_nodes, nbytes(P, Sc, w, mix, qself),
        nbytes(w), ops=b4_ops_per_element(3, 1) * qself.numel(),
        shards=shards)
    del mix, qself
    b4["ms"] = cuda_ms(torch, lambda: qk.qinf_unpack_dequant_mix_blocks(
        P, Sc, w, 2))
    b4["plain_ms"] = cuda_ms(
        torch, lambda: ref.qinf_unpack_dequant_mix_blocks_ref(P, Sc, w, 2),
        iters=plain_iters, warmup=1)
    del P, Sc
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"block": block, "rows": ([n_nodes, shards, rows, block]
                                     if shards > 1 else
                                     [n_nodes, rows, block]),
            "qinf_quantize_pack_blocks": b3,
            "qinf_unpack_dequant_mix_blocks": b4}


def family_phase(torch, api, convert, draws_mod, tree, TR, qk, ref, errs,
                 device: str = "cuda", archs=FAMILY_ARCHS,
                 trainers=FAMILY_TRAINERS, steps: int = SLICE_STEPS,
                 replay_steps: int = REPLAY_STEPS_SLICE,
                 profile_steps: int = SLICE_PROFILE_STEPS, wire: bool = True):
    """Phase 12: (a) each family's reduced trainer, card against CPU, with
    B3/B4 counted; (b) the two full-width trainers; (c) B3/B4 at the
    families' block widths."""
    out = {"card_vs_cpu": [], "trainers": [], "wire": []}
    for arch in archs:
        spec = family_spec(api, arch, replay_steps,
                           name=f"{arch}-smoke-ring8-qinf2", full=False)
        out["card_vs_cpu"].append(trainer_card_vs_cpu(
            torch, api, convert, draws_mod, tree, steps=replay_steps,
            device=device, spec=spec, qk=qk, rounding_floors=True,
            elem_tol=(SSM_REPLAY_ELEM_TOL if arch == "rwkv6-7b"
                      else REPLAY_ELEM_TOL)))
    specs = [family_spec(api, arch, steps, name=name, full=True, params=ov,
                         seq_len=seq) for arch, name, ov, seq in trainers]
    for spec in specs:
        if device == "cuda":
            torch.cuda.empty_cache()
        tr = api.build(spec, device="cpu").trainer
        bph = host_bits_per_hop(tr, tree, TR)
        out["trainers"].append(trainer_path(
            torch, api, draws_mod, qk, steps=steps, spec=spec,
            device=device, profile_steps=profile_steps, bits_per_hop=bph,
            trace_name=f"{spec.model.arch}_trace.json",
            peak_limit_gb=FAMILY_PEAK_GB if device == "cuda" else None))
        out["trainers"][-1]["host_bits_per_hop"] = bph
    if device == "cuda":
        torch.cuda.empty_cache()
    if wire:
        for where, block, rows in family_wire_cases(api, tree, TR, specs):
            case = wire_case(torch, qk, ref, errs, block, rows,
                             device=device)
            case["where"] = where
            out["wire"].append(case)
    return out


# --- phase 19 ------------------------------------------------------------------

#: (a) the dense backend on ranks: N the largest of DENSE_NODES whose dense
#: step at one rank the dry run fits under DENSE_PEAK_GB (as phase 18 picks
#: its N; on the CPU the qwen3 slice's dense step at N = 8 peaks at 70.64
#: GiB, at 4 at 35.32)
DENSE_NODES = (8, 4, 2)
DENSE_PEAK_GB = FAMILY_PEAK_GB
DENSE_RANK_STEPS = 3         # steps held bit for bit to the one-process run
DENSE_TIMED_STEPS = 5        # then timed a run
WHOLE_LEAF_STEPS = 3         # (c) timed steps of each node, whole and split


def dense_spec(api, n_nodes: int, steps: int = DENSE_RANK_STEPS, params=None,
               **kw):
    """Phase 6's slice on the dense backend over ``n_nodes`` nodes
    (``params``: TrainerConfig fields, e.g. ``drop_rate``)."""
    base = slice_spec(api, steps, backend="dense", params=params, **kw)
    return dataclasses.replace(base, n_nodes=n_nodes,
                               name=base.name.replace("ring8",
                                                      f"ring{n_nodes}"))


def dense_dry(spec, world: int):
    """The dry record of ``spec``'s step on ranks of a ``world``-rank mesh
    (``repro_torch.launch.dryrun``, on ``meta``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.obs import roofline
    return dryrun.dry_train(spec.model.build(), roofline.train_shape(spec),
                            mesh_mod.Mesh((spec.n_nodes, 1)), spec=spec,
                            placement="ranks", world=world)


def dense_nodes(api, nodes=DENSE_NODES, peak_gb=DENSE_PEAK_GB, **kw):
    """(N, [(n, dry peak GiB) tried]): the largest n of ``nodes`` whose
    dense step on one rank the dry run fits under ``peak_gb``."""
    tried = []
    for n in nodes:
        peak = dense_dry(dense_spec(api, n, **kw), 1)["memory"][
            "peak_bytes"] / 2 ** 30
        tried.append((n, peak))
        if peak < peak_gb:
            return n, tried
    require(False, f"no dense step fits {peak_gb} GiB: {tried}")


def dense_rank_run(torch, api, draws_mod, tree, qk, errs, spec, pm, *,
                   device: str = "cuda", steps: int = DENSE_RANK_STEPS,
                   timed: int = DENSE_TIMED_STEPS):
    """Phase 19 (a), one run: ``spec`` (the dense backend) on the rank of
    ``pm`` (its ``ag`` a ``DistAG``, its mixer a ``RowsMixer``) against
    the one-process run.  ``steps`` steps from the same state: each step's
    gradient once (the rank's forward and backward, the one-process
    program's), then the one-process update and the rank's from the same
    state and gradient with two generators seeded alike, their X, D, H
    and Hw BIT FOR BIT equal (the one-process result waits on the host
    where three states do not fit TP_TF_CARD_SHARE of the card,
    :func:`host_parking`), every B1 and B2 launch of the rank's first
    update bit for bit its plain version (:func:`checked_qinf_kernels`);
    then ``timed`` full rank steps (``TrainerRunner.step``) with the launch
    counters zeroed just before and read just after: B1 and B2 once a
    leaf a step, the loss finite, the median step and the peak; then the
    counts of one more step (``dryrun.counted_step``: FLOPs, ATen bytes,
    every collective's bytes) beside its dry run at this world."""
    from repro_torch.core.comm import RowsMixer
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import dryrun
    from repro_torch.optim.decentralized import TrainState
    from repro_torch.optim.wire import DistAG
    one = api.build_trainer_runner(spec, device=device)
    rank = api.build_trainer_runner(spec, device=device, process_mesh=pm)
    tr = rank.trainer
    require(isinstance(tr.ag, DistAG) and isinstance(tr.alg.mixer,
                                                     RowsMixer),
            f"{spec.name}: the rank's seams are {tr.ag} and {tr.alg.mixer}")
    data = one.default_data()
    dw = draws_mod.GeneratorDraws(spec.seed, device)
    dr = draws_mod.GeneratorDraws(spec.seed, device)
    t0 = time.perf_counter()
    state = rank.init_state()          # the rank's fault stream afresh
    one.trainer.start_fault_stream()   # and the one-process run's
    n_leaves = len(tree.leaves(state.plead.X))
    p = state.plead
    state_bytes = sum(nbytes(*tree.leaves(t))
                      for t in (p.X, p.D, p.comm.H, p.comm.Hw))
    del p
    # the one-process result waits on the host unless three states fit
    on_card = device != "cuda" or 3 * state_bytes <= TP_TF_CARD_SHARE * \
        torch.cuda.get_device_properties(0).total_memory
    park = host_parking(torch, device, on_card)
    checked = []
    for k in range(steps):
        batch = data.batch_at(k)
        _, G = tr.loss_and_grad(state.plead.X, batch)
        ref_ = one.trainer.alg.update(state.plead,
                                      tree.tree_map(torch.clone, G), dw)
        want = [[park(x) for x in tree.leaves(t)]
                for t in (ref_.X, ref_.D, ref_.comm.H, ref_.comm.Hw)]
        del ref_
        if k == 0:
            with checked_qinf_kernels(torch, ops, qk, ref, errs,
                                      f"at {spec.name}'s rank") as checked:
                new = tr.alg.update(state.plead, G, dr)
            require(sorted(c[0] for c in checked) == sorted(
                [B1, B2] * n_leaves), f"{spec.name}: the rank's update "
                    f"launched {[c[0] for c in checked]}, want one B1 and "
                    f"one B2 a leaf ({n_leaves})")
        else:
            new = tr.alg.update(state.plead, G, dr)
        del G
        differ = [(name, j) for name, t, w in zip(
            ("X", "D", "H", "Hw"), (new.X, new.D, new.comm.H, new.comm.Hw),
            want) for j, (a, b) in enumerate(zip(tree.leaves(t), w))
            if not torch.equal(park(a), b)]
        require(not differ, f"{spec.name} step {k}: the rank's (tree, leaf) "
                f"{differ} differ from the one-process run's")
        del want
        state = TrainState(new, state.step + 1, None)
        del new
    release_host_cache(torch, device)
    checked_s = time.perf_counter() - t0
    del one
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    qk.reset_launch_counts()
    step_s, losses = [], []
    for k in range(steps, steps + timed):
        t1 = time.perf_counter()
        state, m = rank.step(state, data.batch_at(k), dr)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t1)
    launches = qk.launch_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)
    require(device != "cuda" or (launches[B1] == timed * n_leaves
                                 and launches[B2] == timed * n_leaves),
            f"{spec.name}: launches {launches} != one B1 and one B2 a leaf "
            f"({n_leaves}) a step for {timed} steps")
    require(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    real, _, _, _ = dryrun.counted_step(tr, [state],
                                        data.batch_at(steps + timed), dr)
    dry = dense_dry(spec, pm.world)
    dr_ = dry["roofline"]
    counts = {"flops": (dr_["hlo_flops_raw"], real.flops),
              "aten_bytes": (dr_["hlo_bytes_raw"], real.aten_bytes),
              "all_gather_bytes": (dry["all_gather_bytes"],
                                   real.coll["all-gather"])}
    # the CPU's plain kernels move other bytes than the card's
    require(all(d == r for k, (d, r) in counts.items()
                if device == "cuda" or k != "aten_bytes"),
            f"{spec.name}: the dry run's counts differ from the rank's "
            f"step's (dry, real): {counts}")
    step_s.sort()
    return {"spec": spec.name, "n_nodes": spec.n_nodes, "world": pm.world,
            "leaves": n_leaves, "bit_equal_steps": steps,
            "kernels_checked": checked,
            "checked_s": checked_s, "checked_on_card": on_card,
            "launches": launches,
            "launches_per_step": {k: v / timed for k, v in launches.items()},
            "losses": losses, "step_ms_median": 1e3 * step_s[len(step_s) // 2],
            "step_ms_min": 1e3 * step_s[0], "peak_mem_gb": peak,
            "counts": counts, "dry_peak_gb": dry["memory"]["peak_bytes"]
            / 2 ** 30}


def free_port() -> int:
    """A free TCP port on localhost, for the process group's rendezvous."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def dense_rank_phase(torch, api, draws_mod, tree, qk, errs,
                     device: str = "cuda",
                     peak_gb: float = DENSE_PEAK_GB, **kw):
    """Phase 19 (a): a one-rank process group (NCCL on the card: the
    machine has one card, and NCCL refuses two ranks on one device; gloo
    on the CPU), the node axis on a ``ProcessMesh`` of world 1, so every
    node is this rank's and its ``DistAG`` gathers through
    ``all_gather_into_tensor``; N from :func:`dense_nodes`; the plain run
    and one under ``drop_rate`` = DROP_RATE (:func:`dense_rank_run`).  A
    failed init or collective fails the run.  Besides: the bytes a rank
    would receive at one node a rank (the dry run at world N) against a
    host recount, (N - 1) x a node's leaf bytes a step."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    N, tried = dense_nodes(api, peak_gb=peak_gb, **kw)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    runs = []
    try:
        for params in (None, {"drop_rate": DROP_RATE}):
            spec = dense_spec(api, N, params=params, **kw)
            pm = mesh_mod.ProcessMesh(mesh_mod.Mesh((N, 1)), rank=0,
                                      world=1)
            if device == "cuda":
                torch.cuda.empty_cache()
            runs.append(dense_rank_run(torch, api, draws_mod, tree, qk, errs,
                                       spec, pm, device=device))
    finally:
        dist.destroy_process_group()
    spec = dense_spec(api, N, **kw)
    per_node = sum(p.numel() * p.element_size() for p in tree.leaves(
        api.build_trainer_runner(spec, device="meta").trainer
        .abstract_state().plead.X)) // N
    at_n = dense_dry(spec, N)["all_gather_bytes"]
    require(at_n == (N - 1) * per_node, f"{spec.name}: the dry all-gather "
            f"at one node a rank {at_n} != (N - 1) x {per_node}")
    return {"n_nodes": N, "tried": tried, "runs": runs,
            "all_gather_bytes_one_node_a_rank": at_n,
            "node_leaf_bytes": per_node}


def whole_leaf_spec(api, mode: str, mesh=None, **kw):
    """Phase 6's slice on ``mesh`` (default phase 17 (a)'s (8, 2)) with
    the per-leaf wire (``mode`` "per_leaf") or on the dense backend."""
    base = slice_spec(api, WHOLE_LEAF_STEPS,
                      backend="dense" if mode == "dense" else "neighbor",
                      **kw)
    if mode == "per_leaf":
        base = dataclasses.replace(
            base, name=base.name + "-per_leaf",
            execution=dataclasses.replace(base.execution,
                                          wire_mode="per_leaf"))
    return tp_spec(api, mesh or MESH_8X2, spec=base)


def timed_trainer(torch, runner, draws_mod, qk, steps: int,
                  device: str = "cuda"):
    """``steps`` steps of ``runner`` from a fresh state: the median step,
    the peak and the launches (counters zeroed just before the first)."""
    state = runner.init_state()
    data = runner.default_data()
    draws = draws_mod.GeneratorDraws(runner.spec.seed, runner.device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    qk.reset_launch_counts()
    step_s, losses = [], []
    for k in range(steps):
        t1 = time.perf_counter()
        state, m = runner.step(state, data.batch_at(k), draws)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t1)
    launches = qk.launch_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)
    require(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    del state
    step_s.sort()
    return {"step_ms_median": 1e3 * step_s[len(step_s) // 2],
            "launches": launches, "peak_mem_gb": peak, "losses": losses}


def whole_leaf_phase(torch, api, draws_mod, tree, qk, ref, errs,
                     device: str = "cuda", steps: int = WHOLE_LEAF_STEPS,
                     tf_steps: int = TP_TF_STEPS, mesh=None, **kw):
    """Phase 19 (c): phase 17 (a)'s split node (``StackedTP(2)`` at (8,
    2)) with the per-leaf wire and on the dense backend: ``tf_steps``
    steps teacher-forced against the whole-node step of the same mode
    (:func:`tp_teacher_forced`, C4's bar), ``bits_per_step`` equal to the
    whole node's, every B1 and B2 launch of the first split step bit for
    bit its plain version, then ``steps`` timed steps of the split node and of the whole node:
    B1 once a leaf a step, B2 once a leaf (dense) or 1 + hops times a leaf
    (the per-leaf wire: its own payload and each hop's), the median step
    and the peak."""
    from repro_torch.models.tp import StackedTP
    out = []
    for mode in ("per_leaf", "dense"):
        spec = whole_leaf_spec(api, mode, mesh, **kw)
        M = spec.execution.mesh[1]
        if device == "cuda":
            torch.cuda.empty_cache()
        tf = tp_teacher_forced(torch, api, draws_mod, tree, qk, ref, errs,
                               spec, M, steps=tf_steps, device=device)
        rec = {"mode": mode, "spec": spec.name, "M": M,
               "teacher_forced": tf}
        for key, tp in (("tp", StackedTP(M)), ("whole", None)):
            if device == "cuda":
                torch.cuda.empty_cache()
            runner = api.build_trainer_runner(spec, device=device, tp=tp)
            tr = runner.trainer
            rec[f"bits_{key}"] = runner.bits_per_step()
            x = timed_trainer(torch, runner, draws_mod, qk, steps, device)
            n_leaves = len(tr.leaf_specs)
            per_leaf_b2 = 1 + (len(tr.plan.hops) if tr.plan else 0)
            require(device != "cuda" or (
                x["launches"][B1] == steps * n_leaves
                and x["launches"][B2] == steps * n_leaves * per_leaf_b2),
                f"{spec.name} ({key}): launches {x['launches']} != "
                f"{n_leaves} B1 and {n_leaves * per_leaf_b2} B2 a step")
            rec[key] = x
            del runner, tr
        require(rec["bits_tp"] == rec["bits_whole"],
                f"{spec.name}: bits_per_step {rec['bits_tp']} split, "
                f"{rec['bits_whole']} whole")
        out.append(rec)
    return out


def dense_phase(torch, api, configs, draws_mod, tree, qk, ref, errs, smi,
                dense19=()):
    """Phase 19 (a)-(c) (see the module docstring); ``dense19``: (b)'s
    records, from phase 16 (b)'s sweep.  -> the phase's results."""
    t0 = time.perf_counter()
    p19 = {"a": dense_rank_phase(torch, api, draws_mod, tree, qk, errs)}
    a = p19["a"]
    print(f"[dense] (19a) N = {a['n_nodes']} (dry peaks on one rank, GiB: "
          f"{[(n, round(g, 2)) for n, g in a['tried']]}; the largest under "
          f"{DENSE_PEAK_GB}); a one-rank NCCL group, DistAG through "
          f"all_gather_into_tensor | {smi}", flush=True)
    for r in a["runs"]:
        c = r["counts"]
        print(f"[dense] (19a) {r['spec']}: {r['bit_equal_steps']} steps "
              f"bit for bit the one-process run (X, D, H, Hw; "
              f"{r['checked_s']:.1f} s), the first update's "
              f"{len(r['kernels_checked'])} B1/B2 launches bit-equal to "
              f"the plain versions; B1 {r['launches_per_step'][B1]:.0f}"
              f" and B2 {r['launches_per_step'][B2]:.0f} launches a step "
              f"({r['leaves']} leaves); step {r['step_ms_median']:.1f} ms "
              f"median ({r['step_ms_min']:.1f} min), peak "
              f"{r['peak_mem_gb']:.2f} GiB (dry {r['dry_peak_gb']:.2f}); "
              f"losses {[round(x_, 6) for x_ in r['losses']]} | {smi}",
              flush=True)
        print(f"[dense] (19b) {r['spec']} dry at world {r['world']} = real:"
              f" FLOPs {c['flops'][0]:.6e} = {c['flops'][1]:.6e}, ATen "
              f"bytes {c['aten_bytes'][0]:.6e} = {c['aten_bytes'][1]:.6e}, "
              f"all-gather bytes received {c['all_gather_bytes'][0]:,.0f} = "
              f"{c['all_gather_bytes'][1]:,.0f} (one rank holds every node)",
              flush=True)
    print(f"[dense] (19b) at one node a rank (world {a['n_nodes']}) a rank "
          f"receives {a['all_gather_bytes_one_node_a_rank']:,} B a step = "
          f"(N - 1) x {a['node_leaf_bytes']:,} B (a node's leaves, host "
          f"recount)", flush=True)
    want = {(r, "train_4k", "1pod"): "ok" for r, *_ in
            dense_dry_jobs(configs.ARCH_IDS)}
    got = {(r["arch"], r["shape"], r["mesh"]): r["status"] for r in dense19}
    require(got == want, f"dense dry runs: got {got}, want {want}")
    require(all(r["placement"] == "ranks" and r["all_gather_bytes"] > 0
                for r in dense19), "a dense dry run not on ranks")
    for r in dense19:
        print(dense_dry_line(r), flush=True)
    p19["b"] = dense19
    torch.cuda.empty_cache()
    p19["c"] = whole_leaf_phase(torch, api, draws_mod, tree, qk, ref, errs)
    for r in p19["c"]:
        tf = r["teacher_forced"]
        print(f"[dense] (19c) {r['spec']} ({r['mode']}) under "
              f"StackedTP({r['M']}): {tf['steps']} steps teacher-forced "
              f"against the whole-node step: worst off fraction "
              f"{tf['worst_off_fraction']:.2e}, worst |diff|/max "
              f"{tf['worst_rel_max']:.2e}, losses (whole, split) "
              f"{tf['losses']}, {tf['seconds']:.1f} s (states on the card: "
              f"{tf['states_on_card']}), the first split step's "
              f"{len(tf['wire_checked'])} B1/B2 launches bit-equal to the "
              f"plain versions; bits_per_step {r['bits_tp']:.0f} = the "
              f"whole node's {r['bits_whole']:.0f}; step "
              f"{r['tp']['step_ms_median']:.1f} ms median, peak "
              f"{r['tp']['peak_mem_gb']:.2f} GiB (whole node "
              f"{r['whole']['step_ms_median']:.1f} ms, "
              f"{r['whole']['peak_mem_gb']:.2f} GiB); B1, B2 launches a "
              f"step {r['tp']['launches'][B1] // WHOLE_LEAF_STEPS}, "
              f"{r['tp']['launches'][B2] // WHOLE_LEAF_STEPS} | {smi}",
              flush=True)
    p19["seconds"] = time.perf_counter() - t0
    print(f"[dense] phase {p19['seconds']:.1f} s (19b's dry runs ran with "
          f"phase 16's; {', '.join(DRY_LOOPED)} x train_4k by the CLI only)"
          f"; several cards not run here: one card, and NCCL refuses two "
          f"ranks on one device | {smi}", flush=True)
    return p19


# --- phase 20 ------------------------------------------------------------------

def proxlead_shapes(api, TR, tree):
    """The qwen3 cells' node-stacked leaf shapes (8, ...): ``slice_spec``'s
    model, 2 layers at published widths, the vocabulary's first eighth."""
    cfg = slice_spec(api, 1).model.build()
    return [(8,) + tuple(p.shape)
            for p in tree.leaves(TR.abstract_params(cfg))]


def proxlead_operands(torch, shape, slots: int, seed: int, device="cuda"):
    """x, g, d, h, hw (slots), q, w (slots) and the diff rows of one leaf:
    the state contiguous; the diff rows, q and w views into bucket-group
    tables as the cells' bucketed wire lays them out (``RowTables`` and
    B4's qself and mix outputs, 256-blocks): the leaf second in its group,
    after a leaf of 7 rows, so each node's rows lie a group apart and a
    row's block padding, where it has one, is skipped."""
    from repro_torch.core import bucket
    g = torch.Generator(device=device).manual_seed(seed)
    N, slotted = shape[0], (shape[0], slots) + tuple(shape[1:])

    def mk(s):
        return torch.randn(s, generator=g, device=device) * 1e-3

    layout = bucket.compute_layout(
        [(1, 7, shape[-1]), (1,) + tuple(shape[1:])], [torch.float32] * 2,
        bits=2)
    assert len(layout.groups) == 1
    grp, sl = layout.groups[0], layout.slots[1]
    r0, r1 = sl.row_offset, sl.row_offset + sl.rows
    qself = mk((N, grp.rows, grp.block))
    mix = mk((N, slots, grp.rows, grp.block))
    q = bucket.rows_to_leaf(sl, qself[:, r0:r1], lead=(N,)).squeeze(1)
    w = bucket.rows_to_leaf(sl, mix[:, :, r0:r1], lead=(N, slots)).squeeze(2)
    rows = bucket.RowTables(layout, N, device).leaf_view(1)
    assert q._base is not None and w._base is not None
    return [mk(shape), mk(shape), mk(shape), mk(shape), mk(slotted), q, w,
            rows]


def proxlead_eager(kupd, ops, t: int, *, prox, **k):
    """The eager update on a leaf: the twins, which are its ops, then the
    prox."""
    x, gr, d, h, hw, q, w, rows = ops
    z, diff = kupd.head_plain(x, gr, d, h, k["eta"])
    rows.copy_(diff)
    return prox(kupd.tail_plain(z, d, h, hw, q, w, t, **k))


def proxlead_fused(kupd, ops, t: int, **k):
    x, gr, d, h, hw, q, w, rows = ops
    z, _ = kupd.head(x, gr, d, h, k["eta"], out=rows)
    return kupd.tail(z, d, h, hw, q, w, t, **k)


def restrided(a):
    """A copy of view ``a`` with its strides and storage offset."""
    buf = a.new_empty(a.untyped_storage().nbytes() // a.element_size())
    return buf.as_strided(a.shape, a.stride(), a.storage_offset()).copy_(a)


def proxlead_compare(torch, got, want, what: str) -> dict:
    """Bits of ``got`` against ``want``: the elements that differ and, if
    any, the largest gap over want's largest entry (C4's bar)."""
    diff = got.view(torch.int32) != want.view(torch.int32)
    n = int(diff.sum())
    out = {"differ": n, "of": want.numel()}
    if n:
        gap = float((got - want).abs().max() / want.abs().max().clamp_min(
            1e-30))
        far = int(((got - want).abs() > PROXLEAD_BAR[0]
                   * want.abs().max()).sum())
        out.update(rel_gap=gap, beyond_bar=far)
        require(far <= PROXLEAD_BAR[1] * want.numel(),
                f"{what}: {far} of {want.numel()} elements beyond "
                f"{PROXLEAD_BAR[0]} x max (C4)")
    return out


def proxlead_check(torch, kupd, prox_mod, shape, device="cuda") -> list:
    """(a) B5/B6 against the eager update on the card, the same operands:
    T = 1 and 2 at every slot, alpha 0.5 (the cells') and 0.3 (whose
    products round), the cells' l1 prox; at T = 1 every elementwise prox.
    Each array bit for bit, else at C4's bar with the differing count."""
    cases = [(T, t, a, "l1") for T in (1, 2) for t in range(T)
             for a in (0.5, 0.3)]
    cases += [(1, 0, 0.3, p) for p in ("none", "l2sq", "elastic_net",
                                        "nonneg")]
    proxes = {"none": prox_mod.NoneProx(), "l1": prox_mod.L1(lam=1e-4),
              "l2sq": prox_mod.L2Sq(lam=1e-2),
              "elastic_net": prox_mod.ElasticNet(lam1=1e-4, lam2=1e-2),
              "nonneg": prox_mod.NonNeg()}
    rows = []
    for i, (T, t, alpha, name) in enumerate(cases):
        k = dict(eta=0.05, alpha=alpha, gamma=1.0,
                 prox=proxes[name].elementwise(0.05))
        ops = proxlead_operands(torch, shape, T, seed=100 + i, device=device)
        # a third of the entries at or under the l1 threshold (5e-6)
        ops[0].view(-1)[::3] *= 1e-3
        plain = [a.clone() for a in ops[:5]] + [restrided(a)
                                                for a in ops[5:]]
        X = proxlead_fused(kupd, ops, t, **k)
        PX = proxlead_eager(kupd, plain, t, **k)
        if device == "cuda":
            torch.cuda.synchronize()
        res = {"slots": T, "t": t, "alpha": alpha, "prox": name}
        for what, a, b in (("diff", ops[7], plain[7]), ("D", ops[2], plain[2]),
                           ("H", ops[3], plain[3]), ("Hw", ops[4], plain[4]),
                           ("X", X, PX)):
            res[what] = proxlead_compare(torch, a, b, f"{res} {what}")
        rows.append(res)
        del ops, plain, X, PX
    return rows


def proxlead_time(torch, kupd, prox_mod, shape, slots: int,
                  iters: int) -> dict:
    """B5, B6 and the eager chain on one leaf, the cells' l1 prox: ms a
    call (CUDA events), and B5's and B6's bounds (bytes over 3.35 TB/s)."""
    k = dict(eta=0.05, alpha=0.5, gamma=1.0,
             prox=prox_mod.L1(lam=1e-4).elementwise(0.05))
    ops = proxlead_operands(torch, shape, slots, seed=7)
    x, gr, d, h, hw, q, w, rows = ops
    z, _ = kupd.head(x, gr, d, h, k["eta"], out=rows)
    n = x.numel()
    head_ms = cuda_ms(torch, lambda: kupd.head(x, gr, d, h, k["eta"],
                                                out=rows), iters, warmup=2)
    tail_ms = cuda_ms(torch, lambda: kupd.tail(z, d, h, hw, q, w, 0, **k),
                      iters, warmup=2)
    eager_ms = cuda_ms(torch, lambda: proxlead_eager(kupd, ops, 0, **k),
                       iters, warmup=2)
    head_bound = bound_ms(kupd.head_bytes(x), 5 * n)[0]
    tail_bound = bound_ms(kupd.tail_bytes(z, slots), (16 + 2 * slots) * n)[0]
    return {"shape": list(shape), "slots": slots, "elements": n,
            "b5_ms": head_ms, "b5_bound_ms": head_bound,
            "b6_ms": tail_ms, "b6_bound_ms": tail_bound,
            "eager_ms": eager_ms}


def proxlead_phase(torch, api, TR, tree, qk, smi: str) -> dict:
    """20. B5/B6 at the qwen3 cells' shapes: (a) against the eager update
    on the card (``proxlead_check``) at the largest leaf, and on an odd
    last axis (the scalar variant); (b) times at the largest leaf and
    summed over every leaf of the state, T = 1 and T = 2, each beside its
    bound and the eager chain's time."""
    from repro_torch.core import prox as prox_mod
    from repro_torch.kernels import proxlead as kupd
    shapes = proxlead_shapes(api, TR, tree)
    big = max(shapes, key=lambda s: math.prod(s))
    t0 = time.perf_counter()
    checks = proxlead_check(torch, kupd, prox_mod, big)
    odd = proxlead_check(torch, kupd, prox_mod, (8, 1280, 128, 3))
    torch.cuda.empty_cache()
    differ = sum(r[a]["differ"] for r in checks + odd
                 for a in ("diff", "D", "H", "Hw", "X"))
    print(f"[proxlead] B5/B6 against the eager update at {big} and "
          f"(8, 1280, 128, 3), {len(checks) + len(odd)} cases: {differ} "
          f"elements differ in {time.perf_counter() - t0:.1f} s", flush=True)
    times = {}
    for slots in (1, 2):
        one = proxlead_time(torch, kupd, prox_mod, big, slots,
                            PROXLEAD_ITERS)
        torch.cuda.empty_cache()
        whole = {"b5_ms": 0.0, "b5_bound_ms": 0.0, "b6_ms": 0.0,
                 "b6_bound_ms": 0.0, "eager_ms": 0.0, "elements": 0}
        for shape in shapes:
            r = proxlead_time(torch, kupd, prox_mod, shape, slots,
                              PROXLEAD_STATE_ITERS)
            for key in whole:
                whole[key] += r[key]
            torch.cuda.empty_cache()
        times[f"T{slots}"] = {"largest_leaf": one, "whole_state": whole}
        for where, r in (("largest leaf", one), ("whole state", whole)):
            print(f"[proxlead] T = {slots} {where} ({r['elements']:,} "
                  f"elements): B5 {r['b5_ms']:.4f} ms, bound "
                  f"{r['b5_bound_ms']:.4f} "
                  f"({100 * r['b5_bound_ms'] / r['b5_ms']:.1f} %); B6 "
                  f"{r['b6_ms']:.4f} ms, bound {r['b6_bound_ms']:.4f} "
                  f"({100 * r['b6_bound_ms'] / r['b6_ms']:.1f} %); eager "
                  f"chain {r['eager_ms']:.4f} ms | {smi}", flush=True)
    return {"leaves": [list(s) for s in shapes], "largest": list(big),
            "checks": checks, "odd_axis_checks": odd, "times": times}


def main() -> int:
    # the trainer's state arrays are GB-sized and freed in another order
    # than they were allocated: let the allocator grow segments instead of
    # fragmenting fixed ones
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (this smoke test runs on the "
              "card only)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: FAIL: no src/repro_torch next to {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api, configs, convert, sweep, tree
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TR
    from repro_torch.core import draws as draws_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quantize as qk
    from repro_torch.netsim import metrics
    from repro_torch.optim import wire

    result = {"phases": {}}
    try:
        # 1. environment
        smi = smi_line()
        name = torch.cuda.get_device_name(0)
        print(f"[env] {smi} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {name} x {torch.cuda.device_count()}",
              flush=True)
        result["env"] = {"nvidia_smi": smi, "torch": torch.__version__,
                         "cuda": torch.version.cuda, "device": name}

        # 2. build
        t0 = time.perf_counter()
        libs = qk.build()
        qk._libs()
        build_s = time.perf_counter() - t0
        print(f"[build] {', '.join(v.name for v in libs.values())} in "
              f"{build_s:.1f} s", flush=True)
        result["phases"]["build_s"] = build_s
        ptxas = {name: ptxas_report(qk.build_log(name).read_text())
                 for name in libs}
        result["ptxas"] = ptxas
        for name, rows in ptxas.items():
            for r in rows:
                print(f"[build] {name}: {r['kernel']}: {r['registers']} "
                      f"registers, {r['spill_bytes']} B spilled, "
                      f"{r['resident_warps']} resident warps/SM", flush=True)
        b3_kernels = [r for r in ptxas["qinf_wire"]
                      if r["kernel"].startswith("qinf_quantize_pack_")]
        require(len(b3_kernels) == 8, f"B3 instances {b3_kernels}: want "
                f"the row kernel and 7 vector instances")
        require(all(r["spill_bytes"] == 0 for r in b3_kernels),
                f"a B3 instance spills: {b3_kernels}")
        warm_profiler(torch)

        # 3. kernels against their plain versions
        errs = {k: 0.0 for k in qk.LAUNCHES}
        t0 = time.perf_counter()
        n, n_vector = check_kernels(torch, ops, qk, ref, errs)
        times = {"main": time_kernels(torch, qk, ref, (8, 31 * 256),
                                      iters=MAIN_SHAPE_ITERS),
                 "large": time_kernels(torch, qk, ref, LARGE)}
        b1_main = b1_at_main_path(torch, ops, qk, ref)
        print(f"[kernels] {n} cases bit-equal to the plain versions (B1 "
              f"through the leaf route: {n_vector} on its vector variant, "
              f"the rest on its row variant) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for where, tt in times.items():
            for k, v in tt.items():
                print(f"[kernels] {k} @ {where} {v['rows']}: "
                      f"{v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, bound "
                      f"{v['bound_ms']:.5f}, library {v['library_ms']}) "
                      f"| {smi}", flush=True)
        print(f"[kernels] qinf_quantize_lastdim @ leaf {b1_main['leaf']}: "
              f"{b1_main['ms']:.5f} ms (plain: pad + plain B1 "
              f"{b1_main['plain_ms']:.5f}, bound {b1_main['bound_ms']:.5f}) "
              f"| {smi}", flush=True)
        for k, v in b1_main["device_us"].items():
            print(f"[kernels] device time a call, {k}: {v['us']:.3f} us "
                  f"(median of {MAIN_SHAPE_ITERS}), {v['ops_per_call']} "
                  f"device op(s): {v['names']} | {smi}", flush=True)

        # 4. the main path
        mp = main_path(torch, api, convert, draws_mod, metrics, qk)
        result["main_path"] = mp
        print(f"[main] {mp['spec']}: {mp['steps']} steps, objective "
              f"{mp['trace'][0]['objective']:.6f} -> "
              f"{mp['trace'][-1]['objective']:.6f}, consensus "
              f"{mp['trace'][0]['consensus']:.3e} -> "
              f"{mp['trace'][-1]['consensus']:.3e}", flush=True)
        print(f"[main] step {mp['step_ms']:.3f} ms, {mp['bits_per_step']:.0f}"
              f" bits/step/node, data {mp['data_mb_on_device']:.0f} MB, peak "
              f"{mp['peak_mem_mb']:.0f} MB, launches {mp['launches']}, "
              f"per-step card vs CPU: worst off fraction "
              f"{mp['replay']['worst_off_fraction']:.2e}, worst rel err "
              f"{mp['replay']['worst_step_rel_fro']:.2e}; free-running drift "
              f"{mp['replay']['free_running_rel_fro']:.2e}", flush=True)
        pf = mp["profile"]
        print(f"[main] profile: {pf['wall_ms_per_step']:.3f} ms/step wall, "
              f"{pf['device_ms_per_step']:.3f} ms/step on the device "
              f"(busy {pf['busy_share']:.1%}), "
              f"{pf['device_ops_per_step']:.0f} device ops/step", flush=True)
        for t in pf["names"]:
            print(f"[main]   {t['us_per_step']:8.2f} us/step "
                  f"x{t['per_step']:.0f}  {t['name']}", flush=True)
        print(f"[main] just before B1: {pf['before_b1']}", flush=True)

        # 4b. the netsim engine on the same spec
        t0 = time.perf_counter()
        ns = netsim_path(torch, api, convert, draws_mod, qk)
        ns["seconds"] = time.perf_counter() - t0
        result["netsim"] = ns
        print(f"[netsim] static schedule, no faults: "
              f"{ns['static_bit_equal_steps']} steps bit-equal to the dense "
              f"engine (X, D, H, Hw)", flush=True)
        print(f"[netsim] {ns['spec']}: {ns['steps']} steps, objective "
              f"{ns['objective'][0]:.6f} -> {ns['objective'][1]:.6f}, "
              f"consensus {ns['consensus'][0]:.3e} -> "
              f"{ns['consensus'][1]:.3e}, launches {ns['launches']}, bits "
              f"{ns['bits_total']} in all ({ns['bits_per_edge']} an edge; "
              f"first rounds {ns['bits_first']}) = the host recount from "
              f"the recorded masks", flush=True)
        print(f"[netsim] card vs CPU, {ns['replay']['steps']} steps, the "
              f"card's draws replayed: worst off fraction "
              f"{ns['replay']['worst_off_fraction']:.2e}, worst |diff|/max "
              f"{ns['replay']['worst_rel_max']:.2e}", flush=True)
        tm = ns["ms_per_step"]
        pf = ns["profile"]
        print(f"[netsim] ms a step ({NETSIM_TIMED_STEPS} steps each): dense "
              f"{tm['dense']:.4f}, netsim static {tm['netsim_static']:.4f}, "
              f"netsim scenario {tm['netsim_scenario']:.4f}; scenario "
              f"profile: {pf['wall_ms_per_step']:.4f} ms/step wall, "
              f"{pf['device_ms_per_step']:.4f} on the device (busy "
              f"{pf['busy_share']:.1%}), {pf['device_ops_per_step']:.0f} "
              f"device ops/step; phase {ns['seconds']:.1f} s | {smi}",
              flush=True)
        for t in pf["names"][:12]:
            print(f"[netsim]   {t['us_per_step']:8.2f} us/step "
                  f"x{t['per_step']:.0f}  {t['name']}", flush=True)

        # 5. B3/B4 against their plain versions, timed at the slice's shape
        t0 = time.perf_counter()
        n, n_vector = check_wire_kernels(torch, qk, ref, errs)
        n3, n3_vector = check_b3_variants(torch, qk, ref, errs)
        wtimes, at_slice = wire_kernels_at_slice_shape(torch, qk, ref, errs)
        print(f"[wire] {n} B4 cases ({n_vector} on the vector variant, "
              f"{n - n_vector} on the row variant) and their B3 inputs, "
              f"and {n3} B3 cases ({n3_vector} on its vector variant, "
              f"{n3 - n3_vector} on its row variant), against the plain "
              f"versions: B3 bytes/scales, B4 qself and mix bit-equal, "
              f"each case on the variant it must take; the same at the "
              f"trainer's groups {[c['rows'] for c in at_slice]}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for k, v in wtimes.items():
            row_ms = (f", row variant {v['row_variant_ms']:.4f} ms"
                      if "row_variant_ms" in v else "")
            print(f"[wire] {k} @ {v['rows']}: {v['ms']:.4f} ms "
                  f"({100 * v['bound_ms'] / v['ms']:.1f} % of the bound"
                  f"{row_ms}; plain {v['plain_ms']:.4f}, bound "
                  f"{v['bound_ms']:.4f} by {v['bound_by']}, library none) "
                  f"| {smi}", flush=True)
        b4t2 = b4_at_alternating_schedule(torch, qk, ref, errs)
        print(f"[wire] qinf_unpack_dequant_mix_blocks @ {b4t2['rows']} T="
              f"{b4t2['T']} ({b4t2['variant']} variant): mix and qself "
              f"bit-equal on both variants; {b4t2['ms']:.4f} ms "
              f"({100 * b4t2['bound_ms'] / b4t2['ms']:.1f} % of the bound, "
              f"row variant {b4t2['row_variant_ms']:.4f} ms; plain "
              f"{b4t2['plain_ms']:.4f}, bound {b4t2['bound_ms']:.4f} by "
              f"{b4t2['bound_by']}, {b4t2['bound_gb']:.2f} GB, library "
              f"none) | {smi}", flush=True)
        result["wire_kernels"] = {"cases": n, "vector_cases": n_vector,
                                  "b3_cases": n3,
                                  "b3_vector_cases": n3_vector,
                                  "at_slice_shape": at_slice,
                                  "times": wtimes, "b4_t2_s6": b4t2}

        # 6. the trainer path at the slice's configuration
        sp = trainer_path(torch, api, draws_mod, qk)
        result["trainer_path"] = sp
        print(f"[slice] {sp['spec']}: {sp['config']}", flush=True)
        print(f"[slice] {sp['steps']} steps, loss "
              f"{sp['trace'][0]['loss']:.6f} -> {sp['trace'][-1]['loss']:.6f}"
              f" (mean of {LOSS_WINDOW}: {sp['loss_first_window']:.6f} -> "
              f"{sp['loss_last_window']:.6f}; held out "
              f"{sp['held_out_loss'][0]:.6f} -> {sp['held_out_loss'][1]:.6f})"
              f", consensus {sp['trace'][0]['consensus']:.4e} -> "
              f"{sp['trace'][-1]['consensus']:.4e}; launches "
              f"{sp['launches']} ({sp['bucket_groups']} bucket groups)",
              flush=True)
        print(f"[slice] step {sp['step_ms_median']:.1f} ms median "
              f"({sp['step_ms_min']:.1f} min), peak "
              f"{sp['peak_mem_gb']:.2f} GiB allocated, "
              f"{sp['bits_per_step']:.0f} bits/step/node, set-up "
              f"{sp['setup_s']:.1f} s | {smi}", flush=True)
        pf = sp["profile"]
        print(f"[slice] profile: {pf['wall_ms_per_step']:.1f} ms/step wall, "
              f"{pf['device_ms_per_step']:.1f} ms/step on the device (busy "
              f"{pf['busy_share']:.1%}), {pf['device_ops_per_step']:.0f} "
              f"device ops/step", flush=True)
        for t_ in pf["top"]:
            print(f"[slice]   {t_['ms_per_step']:9.3f} ms/step "
                  f"x{t_['per_step']:.0f}  {t_['name']}", flush=True)
        print_wire_share("[slice]", pf)
        print_contracts_and_roofline("(6)", sp, smi)

        # 6b. the same trainer under the alternating schedule (T = 2)
        torch.cuda.empty_cache()
        ss = trainer_path(torch, api, draws_mod, qk, profile_steps=0,
                          spec=slice_spec(api, SLICE_STEPS,
                                          schedule="alternating"),
                          hops=SCHEDULED_HOPS)
        result["scheduled_trainer_path"] = ss
        print(f"[sched] {ss['spec']}: {ss['steps']} steps, {ss['hops']} "
              f"hops, {ss['hw_slots']} Hw slots, loss (mean of "
              f"{LOSS_WINDOW}) {ss['loss_first_window']:.6f} -> "
              f"{ss['loss_last_window']:.6f}, consensus "
              f"{ss['trace'][0]['consensus']:.4e} -> "
              f"{ss['trace'][-1]['consensus']:.4e}; launches "
              f"{ss['launches']} ({ss['bucket_groups']} bucket groups); "
              f"{ss['bits_per_step']:.0f} bits/step/node", flush=True)
        print(f"[sched] step {ss['step_ms_median']:.1f} ms median "
              f"({ss['step_ms_min']:.1f} min), peak "
              f"{ss['peak_mem_gb']:.2f} GiB allocated, set-up "
              f"{ss['setup_s']:.1f} s | {smi}", flush=True)
        print_contracts_and_roofline("(6b)", ss, smi)

        # 7. bucketed against per-leaf wire at the slice's widths
        bp = bucketed_vs_per_leaf(torch, api, draws_mod, wire, ref)
        result["bucketed_vs_per_leaf"] = bp
        print(f"[wire] bucketed vs per-leaf on {bp['leaves']}: codes, "
              f"scales, qself equal; mix max diff {bp['mix_max_abs_diff']:.3e}"
              f" (bit-equal: {bp['mix_exact']}); {bp['bytes_per_hop_per_node']}"
              f" bytes per hop per node", flush=True)

        # 8. the trainer, card against CPU at a small size
        result["trainer_card_vs_cpu"] = []
        for variant in ({}, {"schedule": "alternating"},
                        {"backend": "dense",
                         "params": {"drop_rate": DROP_RATE}}):
            cc = trainer_card_vs_cpu(torch, api, convert, draws_mod, tree,
                                     **variant)
            result["trainer_card_vs_cpu"].append(cc)
            print(f"[slice] card vs CPU, {cc['steps']} steps of "
                  f"{cc['spec']}: worst off fraction "
                  f"{cc['worst_off_fraction']:.2e}, worst |diff|/max "
                  f"{cc['worst_rel_max']:.2e}", flush=True)
        dr = trainer_drop_rate(torch, api, tree, qk)
        result["trainer_drop_rate"] = dr
        print(f"[drop] {dr['spec']}: 2 runs x {dr['steps']} steps from fresh "
              f"states, worst off fraction between them "
              f"{dr['two_runs_worst_off_fraction']:.2e}; launches "
              f"{dr['launches']} ({dr['leaves']} leaves); loss "
              f"{dr['loss'][0]:.6f} -> {dr['loss'][-1]:.6f}", flush=True)

        # 9. the paper's comparisons on the card
        t0 = time.perf_counter()
        pc = paper_comparisons(torch, api, convert, draws_mod, qk)
        pc["seconds"] = time.perf_counter() - t0
        result["paper"] = pc
        for key, g in pc["grids"].items():
            print(f"[paper] {key}: {len(g['rows'])} rows x {PAPER_STEPS} "
                  f"steps, f64, in {g['seconds']:.1f} s (X* by "
                  f"solve_reference {g['solve_reference_s']:.1f} s) | {smi}",
                  flush=True)
            for r in g["rows"]:
                print(f"[paper]   {r['name']:24s} final subopt "
                      f"{r['final_subopt']:.4e}  {r['bits_per_iter']:.0f} "
                      f"bits/step  {r['ms_per_step']:.4f} ms/step  B1/B2 "
                      f"launches {r['launches'][B1]}/{r['launches'][B2]}",
                      flush=True)
            for c in g["checks"]:
                print(f"[paper]   [{'PASS' if c['ok'] else 'FAIL'}] "
                      f"{c['claim']}   [{c['value']}]", flush=True)
        pf = pc["lead2_profile"]
        print(f"[paper] profile of LEAD (2bit), {pf['steps']} steps: "
              f"{pf['wall_ms_per_step']:.4f} ms/step wall, "
              f"{pf['device_ms_per_step']:.4f} ms/step on the device (busy "
              f"{pf['busy_share']:.1%}), {pf['device_ops_per_step']:.0f} "
              f"device ops/step | {smi}", flush=True)
        for t_ in pf["names"][:12]:
            print(f"[paper]   {t_['us_per_step']:8.2f} us/step "
                  f"x{t_['per_step']:.0f}  {t_['name']}", flush=True)
        for r in pc["table3"]["rows"]:
            print(f"[paper] table3 {r['name']:18s} rho measured "
                  f"{r['rho_measured']:.6f} <= theory {r['rho_theory']:.6f}"
                  f" + 1e-3: {r['ok']}", flush=True)
        for label, v in pc["card_vs_cpu"].items():
            print(f"[paper] card vs CPU, {v['steps']} steps of {label}: "
                  f"worst off fraction {v['worst_off_fraction']:.2e}, worst "
                  f"|diff|/max {v['worst_rel_max']:.2e}", flush=True)
        ec = pc["empirical_C"]
        print(f"[paper] empirical_C (2-bit QInf, {ec['leaf']}, "
              f"{ec['trials']} trials): {ec['C_card']!r} on the card, "
              f"{ec['C_plain']!r} plain, analytic C {ec['C_analytic']}; "
              f"launches {ec['launches']}; phase {pc['seconds']:.1f} s",
              flush=True)

        # 10. the sweep engine on the card
        sw = sweep_phase(torch, api, sweep, metrics, draws_mod, ops, qk,
                         ref, errs)
        result["sweep"] = sw
        gm, vg = sw["golden_map"], sw["vmap_grid"]
        print(f"[sweep] (a) {gm['spec']}: {gm['points']} points x "
              f"{gm['steps']} steps, map mode, f64: launches {gm['launches']}"
              f"; {gm['bit_equal_points']} points bit-equal to their serial "
              f"runs on the card; {gm['wall_s']:.2f} s", flush=True)
        print(f"[sweep] (b) {vg['spec']}: {vg['points']} points stacked, "
              f"{vg['steps']} steps: launches {vg['launches']}; first "
              f"stacked step's launches {vg['checked_launches']} bit-equal "
              f"to the plain versions; stacked vs "
              f"map, {vg['replay']['steps']} teacher-forced steps: worst off "
              f"fraction {vg['replay']['worst_off_fraction']:.2e}, worst "
              f"|diff|/max {vg['replay']['worst_rel_max']:.2e}; objective "
              f"fell at every point ({min(vg['objective_first']):.6f}.."
              f"{max(vg['objective_first']):.6f} -> "
              f"{min(vg['objective_last']):.6f}.."
              f"{max(vg['objective_last']):.6f})", flush=True)
        pf = vg["profile"]
        print(f"[sweep] (b) ms a step: stacked {vg['stacked_ms_per_step']:.4f}"
              f" for all {vg['points']} points, map {vg['map_ms_per_step_summed']:.4f}"
              f" summed over the points ({vg['points_per_s_stacked']:.0f} vs "
              f"{vg['points_per_s_map']:.0f} point-steps/s); profile "
              f"{pf['wall_ms_per_step']:.4f} ms/step wall, "
              f"{pf['device_ms_per_step']:.4f} on the device (busy "
              f"{pf['busy_share']:.1%}), {pf['device_ops_per_step']:.0f} "
              f"device ops/step | {smi}", flush=True)
        for t_ in pf["names"][:12]:
            print(f"[sweep]   {t_['us_per_step']:8.2f} us/step "
                  f"x{t_['per_step']:.0f}  {t_['name']}", flush=True)
        for part, g in zip("fghh", sw["beyond_dense"].values()):
            rp = g["replay"]
            print(f"[sweep] ({part}) {g['spec']} ({g['engine']}, "
                  f"{g['algorithm']}): {g['points']} points stacked; "
                  f"{rp['steps']} teacher-forced steps vs map "
                  f"({rp['fault_draws_replayed']} fault draws replayed): "
                  f"worst off fraction {rp['worst_off_fraction']:.2e}, "
                  f"worst |diff|/max {rp['worst_rel_max']:.2e}; first "
                  f"stacked step's launches {g['checked_launches']} "
                  f"bit-equal to the plain versions"
                  + (f"; bits of every round equal to map mode (first "
                     f"rounds of point 0: {g['bits_first'][0]})"
                     if g["bits_equal_to_map"] else ""), flush=True)
            print(f"[sweep] ({part}) {g['steps']} free-running steps: "
                  f"launches {g['launches']}; objective "
                  f"{min(g['objective_first']):.6f}.."
                  f"{max(g['objective_first']):.6f} -> "
                  f"{min(g['objective_last']):.6f}.."
                  f"{max(g['objective_last']):.6f}; peak "
                  f"{g['peak_mem_mb']:.0f} MiB; ms a step: stacked "
                  f"{g['stacked_ms_per_step']:.4f}, map "
                  f"{g['map_ms_per_step_summed']:.4f} summed over the "
                  f"points | {smi}", flush=True)
            pf = g["profile"]
            if pf is not None:
                print(f"[sweep] ({part}) profile {pf['wall_ms_per_step']:.4f}"
                      f" ms/step wall, {pf['device_ms_per_step']:.4f} on the "
                      f"device (busy {pf['busy_share']:.1%}), "
                      f"{pf['device_ops_per_step']:.0f} device ops/step",
                      flush=True)
                for t_ in pf["names"][:8]:
                    print(f"[sweep]   {t_['us_per_step']:8.2f} us/step "
                          f"x{t_['per_step']:.1f}  {t_['name']}", flush=True)
        for r in sw["b1_point_levels"]:
            print(f"[sweep] (c) B1 per-point L @ {r['case']} {r['shape']} "
                  f"bits {sorted(set(r['bits']))}: bit-equal to fixed-bits "
                  f"B1 and plain; {r['ms']:.5f} ms (fixed bits "
                  f"{r['fixed_bits_ms']:.5f}, plain {r['plain_ms']:.5f}, "
                  f"bound {r['bound_ms']:.5f} by {r['bound_by']}) | {smi}",
                  flush=True)
        print(f"[sweep] (d) checkpoints: dense {sw['checkpoints']['dense']}"
              f", trainer {sw['checkpoints']['trainer']}: restored states "
              f"equal, the next step bit-equal", flush=True)
        print(f"[sweep] (e) python -m repro_torch.launch.sweep: exit 0, "
              f"{sw['cli']['points']} points equal to (a), "
              f"{sw['cli']['seconds']:.1f} s", flush=True)
        tg = sw["tree_grid"]
        rp = tg["replay"]
        print(f"[sweep] (i) {tg['spec']} (tree iterate W, b): "
              f"{tg['points']} points stacked; first stacked step's "
              f"launches {tg['checked_launches']} bit-equal to the plain "
              f"versions; {rp['steps']} teacher-forced steps vs map: worst "
              f"off fraction {rp['worst_off_fraction']:.2e}, worst "
              f"|diff|/max {rp['worst_rel_max']:.2e}", flush=True)
        print(f"[sweep] (i) {tg['steps']} free-running steps: launches "
              f"{tg['launches']} (B1 and B2 {tg['launches'][B1] / tg['steps']:g}"
              f" a step); objective {min(tg['objective_first']):.6f}.."
              f"{max(tg['objective_first']):.6f} -> "
              f"{min(tg['objective_last']):.6f}.."
              f"{max(tg['objective_last']):.6f}; peak "
              f"{tg['peak_mem_mb']:.0f} MiB; ms a step: stacked "
              f"{tg['stacked_ms_per_step']:.4f} for all {tg['points']} "
              f"points, map {tg['map_ms_per_step_summed']:.4f} summed over "
              f"the points | {smi}", flush=True)
        for engine, r in tg["serial"].items():
            print(f"[sweep] (i) serial {engine} run of {r['spec']} on the "
                  f"card: {r['steps']} steps, launches {r['launches']}, "
                  f"objective {r['objective'][0]:.6f} -> "
                  f"{r['objective'][1]:.6f}"
                  + (f", bits of the first rounds {r['bits_first']}"
                     if r["bits_first"] else "")
                  + f"; {r['seconds']:.2f} s | {smi}", flush=True)
        print(f"[sweep] phase {sw['seconds']:.1f} s", flush=True)

        # 11. serving at published widths
        t0 = time.perf_counter()
        sv = serve_phase(torch, configs, TR, serve)
        sv["seconds"] = time.perf_counter() - t0
        result["serve"] = sv
        for r in sv["archs"] + [sv["window"]]:
            c = r["config"]
            depth = (f"{c['n_enc_layers']}+{c['n_layers']}" if
                     c["n_enc_layers"] else str(c["n_layers"]))
            print(f"[serve] {r['arch']} ({depth} layers, "
                  f"{r['params'] / 1e9:.2f} B params, f32): batch "
                  f"{r['batch']}, prompt {r['prompt']}, gen {r['gen']}: "
                  f"prefill {r['prefill_ms']:.2f} ms, decode "
                  f"{r['decode_ms_per_step']:.2f} ms/step, "
                  f"{r['tokens_per_s']:.1f} tok/s, peak "
                  f"{r['peak_mem_gb']:.2f} GiB; decode vs teacher-forced "
                  f"max |diff| {r['max_abs_diff']:.3e} of max |logit| "
                  f"{r['max_abs_logit']:.3e}; ids >= vocab "
                  f"{r['ids_at_or_above_vocab']} | {smi}", flush=True)
            pf = r["decode_profile"]
            print(f"[serve]   decode: bytes bound {r['decode_bound_ms']:.3f} "
                  f"ms; profile of {pf['steps']} steps "
                  f"{pf['wall_ms_per_step']:.2f} ms/step wall, "
                  f"{pf['device_ms_per_step']:.3f} on the device (busy "
                  f"{pf['busy_share']:.1%}), {pf['device_ops_per_step']:.0f} "
                  f"device ops/step; top: " + "; ".join(
                      f"{t_['ms_per_step']:.3f} ms x{t_['per_step']:.0f} "
                      f"{t_['name'][:48]}" for t_ in pf["top"][:3]),
                  flush=True)
        print(f"[serve] mixtral-8x7b past its {sv['window']['window']}-slot "
              f"window (C11): the {WINDOW_STEPS} decode steps after a "
              f"{WINDOW_PROMPT}-token prompt equal the teacher-forced "
              f"forward; phase {sv['seconds']:.1f} s", flush=True)

        # 12. the trainer on the other families
        t0 = time.perf_counter()
        fp = family_phase(torch, api, convert, draws_mod, tree, TR, qk, ref,
                          errs)
        fp["seconds"] = time.perf_counter() - t0
        result["families"] = fp
        for cc in fp["card_vs_cpu"]:
            print(f"[family] card vs CPU, {cc['steps']} steps of "
                  f"{cc['spec']}: worst off fraction "
                  f"{cc['worst_off_fraction']:.2e}, worst |diff|/max "
                  f"{cc['worst_rel_max']:.2e}; launches {cc['launches']} "
                  f"({cc['bucket_groups']} bucket groups)", flush=True)
        for ft in fp["trainers"]:
            print(f"[family] {ft['spec']}: {ft['config']}", flush=True)
            print(f"[family] {ft['steps']} steps, loss (mean of "
                  f"{LOSS_WINDOW}) {ft['loss_first_window']:.6f} -> "
                  f"{ft['loss_last_window']:.6f}, held out "
                  f"{ft['held_out_loss'][0]:.6f} -> "
                  f"{ft['held_out_loss'][1]:.6f}; launches "
                  f"{ft['launches']} ({ft['bucket_groups']} bucket groups); "
                  f"{ft['bits_per_step']:.0f} bits/step/node = 2 hops x "
                  f"{ft['host_bits_per_hop']} (host count)", flush=True)
            pf = ft["profile"]
            print(f"[family] step {ft['step_ms_median']:.1f} ms median "
                  f"({ft['step_ms_min']:.1f} min), peak "
                  f"{ft['peak_mem_gb']:.2f} GiB allocated; profile "
                  f"{pf['wall_ms_per_step']:.1f} ms/step wall, "
                  f"{pf['device_ms_per_step']:.1f} on the device (busy "
                  f"{pf['busy_share']:.1%}) | {smi}", flush=True)
            for t_ in pf["top"][:6]:
                print(f"[family]   {t_['ms_per_step']:9.3f} ms/step "
                      f"x{t_['per_step']:.0f}  {t_['name']}", flush=True)
            print_wire_share("[family]", pf)
            print_contracts_and_roofline("(12b)", ft, smi)
        for wc in fp["wire"]:
            for k in ("qinf_quantize_pack_blocks",
                      "qinf_unpack_dequant_mix_blocks"):
                v = wc[k]
                print(f"[family] {k} @ block {wc['block']} "
                      f"{wc['rows']} ({wc['where']}"
                      f"{', ' + v['variant'] + ' variant' if 'variant' in v else ''}"
                      f"): bit-equal; {v['ms']:.4f} ms (plain "
                      f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.4f} by "
                      f"{v['bound_by']}, library none) | {smi}", flush=True)
        print(f"[family] phase {fp['seconds']:.1f} s", flush=True)

        # 14. the contract audit over every golden spec on the card
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        ca = golden_contracts(torch)
        ca["seconds"] = time.perf_counter() - t0
        result["contracts"] = ca
        print(f"[contracts] (14) {ca['summary']}; {ca['seconds']:.1f} s | "
              f"{smi}", flush=True)

        # 15. model-sharded meshes
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        gm = golden_mesh_on_card(torch, api, convert, draws_mod, tree, qk,
                                 ref, errs)
        result["golden_mesh"] = gm
        cc = gm["card_vs_cpu"]
        print(f"[mesh] (15a) {gm['spec']} at {gm['mesh']}: card vs CPU, "
              f"{cc['steps']} steps: worst off fraction "
              f"{cc['worst_off_fraction']:.2e}, worst |diff|/max "
              f"{cc['worst_rel_max']:.2e}; launches {cc['launches']} "
              f"({cc['bucket_groups']} bucket groups); pp "
              f"{len(gm['pp_calls'])} u8 calls a step, "
              f"{gm['pp_bytes_a_shard']:,} B a model shard; "
              f"{len(gm['wire_kernels_checked'])} B3/B4 launches of a step "
              f"bit-equal to the plain versions "
              f"{[s_ for _, s_ in gm['wire_kernels_checked']]}; "
              + "; ".join(f"{'PASS' if ok else 'FAIL'} "
                          f"{cl.split(': ', 1)[1]}"
                          for cl, ok, _ in gm["findings"]), flush=True)
        torch.cuda.empty_cache()
        ms_ = mesh_slice_phase(torch, api, draws_mod, tree, qk, ref, errs)
        ms_["seconds"] = time.perf_counter() - t0
        result["mesh_slice"] = ms_
        print(f"[mesh] (15b) {ms_['spec']}: {ms_['steps']} steps, loss "
              f"(mean of {LOSS_WINDOW}) {ms_['loss_first_window']:.6f} -> "
              f"{ms_['loss_last_window']:.6f}, held out "
              f"{ms_['held_out_loss'][0]:.6f} -> "
              f"{ms_['held_out_loss'][1]:.6f}; launches {ms_['launches']} "
              f"({ms_['bucket_groups']} bucket groups); "
              f"{ms_['bits_per_step']:.0f} bits/step/node", flush=True)
        print(f"[mesh] (15b) step {ms_['step_ms_median']:.1f} ms median "
              f"({ms_['step_ms_min']:.1f} min) vs phase 6's (8, 1) "
              f"{sp['step_ms_median']:.1f} ms; peak {ms_['peak_mem_gb']:.2f} "
              f"GiB vs {sp['peak_mem_gb']:.2f}; set-up {ms_['setup_s']:.1f} s "
              f"| {smi}", flush=True)
        pf = ms_["profile"]
        print(f"[mesh] (15b) profile: {pf['wall_ms_per_step']:.1f} ms/step "
              f"wall, {pf['device_ms_per_step']:.1f} ms/step on the device "
              f"(busy {pf['busy_share']:.1%}), "
              f"{pf['device_ops_per_step']:.0f} device ops/step", flush=True)
        print_wire_share("[mesh]", pf)
        print_contracts_and_roofline("(15b)", ms_, smi)
        for wc in ms_["wire"]:
            for k in ("qinf_quantize_pack_blocks",
                      "qinf_unpack_dequant_mix_blocks"):
                v = wc[k]
                print(f"[mesh] (15c) {k} @ {wc['rows']} ({v['variant']} "
                      f"variant): bit-equal; {v['ms']:.4f} ms "
                      f"({100 * v['bound_ms'] / v['ms']:.1f} % of the bound; "
                      f"plain {v['plain_ms']:.4f}, bound {v['bound_ms']:.4f} "
                      f"by {v['bound_by']}, library none) | {smi}",
                      flush=True)
        print(f"[mesh] phase {ms_['seconds']:.1f} s; several processes "
              f"(DistPP) not run here: one card, and NCCL refuses two ranks "
              f"on one device", flush=True)

        # 16. the dry run: dry against real, then the production sweep
        t0 = time.perf_counter()
        from repro_torch.launch import dryrun
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"[dryrun] (16) this card's total_memory {total:,} B; "
              f"dryrun.H100_MEMORY_BYTES {dryrun.H100_MEMORY_BYTES:,} B | "
              f"{smi}", flush=True)
        dr16 = {"total_memory": total, "against_real": []}
        for spec_, real in ((slice_spec(api, SLICE_STEPS), sp["roofline"]),
                            (mesh_spec(slice_spec(api, SLICE_STEPS)),
                             ms_["roofline"])):
            torch.cuda.empty_cache()
            da = dry_against_real(torch, api, draws_mod, spec_, real)
            dr16["against_real"].append(da)
            c, m = da["counts"], da["memory"]
            print(f"[dryrun] (16a) {da['spec']} at {da['mesh']}, one "
                  f"process, dry ({da['dry_s']:.1f} s) = real: FLOPs "
                  f"{c['hlo_flops_raw'][0]:.6e} = {c['hlo_flops_raw'][1]:.6e}"
                  f", ATen bytes {c['hlo_bytes_raw'][0]:.6e} = "
                  f"{c['hlo_bytes_raw'][1]:.6e}, pp bytes "
                  f"{c['pp_bytes'][0]:,.0f} = {c['pp_bytes'][1]:,.0f}; peak "
                  f"{m['peak_bytes']:,} B (arguments "
                  f"{m['argument_bytes']:,} + temp {m['temp_bytes']:,}) vs "
                  f"max_memory_allocated {da['real_peak_bytes']:,} B "
                  f"({da['peak_rel_diff']:+.2%}; {da['real_base_bytes']:,} "
                  f"B held before the state taken off); dry kernel calls "
                  f"{ {k: v['calls'] for k, v in da['kernels'].items()} } "
                  f"| {smi}", flush=True)
        torch.cuda.empty_cache()
        recs, sweep_s = dry_sweep(jobs=dry_sweep_jobs(configs.ARCH_IDS)
                                  + dense_dry_jobs(configs.ARCH_IDS))
        dense19 = [r for r in recs if r["backend"] == "dense"]
        recs = [r for r in recs if r["backend"] != "dense"]
        for r in recs:
            print(dry_line(r), flush=True)
        status = [r["status"] for r in recs]
        from repro_torch.configs import shapes as shp_
        want = {}
        for a, shape_, mp_ in dry_sweep_jobs(configs.ARCH_IDS):
            for s_ in (shp_.SHAPES if shape_ == "all" else (shape_,)):
                want[(a, s_, "2pod" if mp_ else "1pod")] = (
                    "ok" if shp_.applicable(configs.get(a), shp_.SHAPES[s_])
                    is None else "skipped")
        got = {(r["arch"], r["shape"], r["mesh"]): r["status"] for r in recs}
        require(got == want, f"dry-run sweep: got {got}, want {want}")
        dr16.update(sweep=recs, sweep_s=sweep_s,
                    seconds=time.perf_counter() - t0)
        result["dryrun"] = dr16
        print(f"[dryrun] (16b) {len(recs)} combos: {status.count('ok')} ok, "
              f"{status.count('skipped')} skipped (the reference's skips), "
              f"0 errors, in {sweep_s:.1f} s "
              f"({len(dry_sweep_jobs(configs.ARCH_IDS))} processes, with "
              f"phase 19 (b)'s {len(dense19)} beside them; "
              f"{', '.join(DRY_LOOPED)} x train_4k, prefill_32k by the CLI "
              f"only); phase "
              f"{dr16['seconds']:.1f} s | {smi}", flush=True)

        # 17. a tensor-parallel node
        p17 = tp_node_phase(torch, api, configs, draws_mod, tree, qk, ref,
                            errs, smi, ms_)
        result["tp"] = p17

        # 18. RWKV-6 and the RG-LRU on a tensor-parallel node; serving at
        # M > 1
        torch.cuda.empty_cache()
        p18 = tp_recurrent_phase(torch, api, configs, draws_mod, tree, TR,
                                 serve, qk, ref, errs, smi, sv)
        result["tp_recurrent"] = p18

        # 19. the dense backend on ranks; whole-leaf mixing on a split node
        torch.cuda.empty_cache()
        p19 = dense_phase(torch, api, configs, draws_mod, tree, qk, ref,
                          errs, smi, dense19)
        result["dense"] = p19

        # 20. B5/B6 against the eager update, timed at the cells' shapes
        torch.cuda.empty_cache()
        result["proxlead"] = proxlead_phase(torch, api, TR, tree, qk, smi)

    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name_, src, replaces in (
            ("qinf_quantize_blocks", "qinf.cu",
             "src/repro/kernels/quantize.py:54"),
            ("qinf_dequantize_blocks", "qinf.cu",
             "src/repro/kernels/quantize.py:204"),
            ("qinf_quantize_pack_blocks", "qinf_wire.cu",
             "src/repro/kernels/quantize.py:137"),
            ("qinf_unpack_dequant_mix_blocks", "qinf_wire.cu",
             "src/repro/kernels/quantize.py:169")):
        if name_ in times["main"]:     # B1/B2: the dense main path
            m, launches = times["main"][name_], mp["launches"][name_]
            extra = {"large": times["large"][name_], "paper_launches": {
                r["name"]: r["launches"][name_]
                for g in pc["grids"].values() for r in g["rows"]
                if r["launches"][name_]},
                "netsim_launches": ns["launches"][name_],
                "drop_rate_trainer_launches": dr["launches"][name_]}
            extra["sweep_launches"] = {
                "golden_map": sw["golden_map"]["launches"][name_],
                "stacked_grid": sw["vmap_grid"]["launches"][name_],
                **{"stacked_" + k: g["launches"][name_]
                   for k, g in sw["beyond_dense"].items()}}
            if name_ == "qinf_quantize_blocks":
                extra["main_path_leaf"] = b1_main
                extra["per_point_levels"] = sw["b1_point_levels"]
            extra["dense_rank_launches"] = {
                r["spec"]: r["launches"][name_] for r in p19["a"]["runs"]}
            extra["whole_leaf_launches"] = {
                f"{r['spec']}/{key}": r[key]["launches"][name_]
                for r in p19["c"] for key in ("tp", "whole")}
        else:                          # B3/B4: the trainer path
            m, launches = wtimes[name_], sp["launches"][name_]
            extra = {"scheduled_launches": ss["launches"][name_]}
            if name_ == "qinf_unpack_dequant_mix_blocks":
                extra["t2_s6"] = b4t2
            extra["family_widths"] = [
                {"block": wc["block"], "rows": wc["rows"],
                 "where": wc["where"], **wc[name_]} for wc in fp["wire"]]
            extra["family_trainer_launches"] = {
                ft["spec"]: ft["launches"][name_] for ft in fp["trainers"]}
            extra["family_card_vs_cpu_launches"] = {
                cc["spec"]: cc["launches"][name_]
                for cc in fp["card_vs_cpu"]}
            extra["mesh_8x2_launches"] = ms_["launches"][name_]
            extra["mesh_8x2_widths"] = [
                {"block": wc["block"], "rows": wc["rows"], **wc[name_]}
                for wc in ms_["wire"]]
            extra["golden_4x2_launches"] = \
                gm["card_vs_cpu"]["launches"][name_]
            extra["tp_8x2_launches"] = p17["a"]["launches"][name_]
            extra["tp_2x16_launches"] = p17["b"]["launches"][name_]
            extra["tp_recurrent_launches"] = {
                r["tp"]["spec"]: r["tp"]["launches"][name_]
                for r in p18["trainers"]}
        kernels.append({
            "name": name_, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[name_], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "rows": m["rows"],
            **{k: m[k] for k in ("variant", "row_variant_ms") if k in m},
            **extra})
    result["kernels"] = kernels
    result["card"] = smi
    result["seconds"] = time.perf_counter() - T_START
    print(f"[done] chip_smoke.py ran {result['seconds']:.1f} s, the build "
          f"included | {smi}", flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
