#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DySTop on one card: the simulation plane,
the LM fleet over four model families (dense: smollm-135m; ssm:
mamba2-2.7b; hybrid: recurrentgemma-2b; moe: grok-1-314b's smoke
geometry), serving (grok-1-314b, the moe family, at full width, and
recurrentgemma-2b, paligemma-3b and seamless-m4t-medium at full size), the
model plane of the vlm and encoder-decoder families at full width, the
fleet mesh (``mesh_shards`` = 2 and 4 gloo ranks sharing the card) on the
simulation plane and the LM fleet, the Table-I arena (DySTop against four
baselines), Theorem 1's bound, snapshots with resume on both planes, the
legacy per-leaf paths of both planes, the trainer (``launch/train.py``) with
and without activation recomputation, the pods-as-workers plane
(``make_dystop_round_step`` with ``dystop_pod_mix``, stacked and on 4 gloo
ranks), a counted train step and prefill (``launch/steps.py``'s
artifacts against ``launch/loopcost.py``'s count), and the tools' twins
(the kill-and-resume check, the examples, the chunked prefix-LM).

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises, and the script exits nonzero with no result):

1. print the card's name and power limit; build the five CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (N = 100 workers, P = 6,922 parameters): the Eq. 4
   ``aggregate`` over every (k, u) bucket, column-sparse (with repeated,
   zero-weighted padding columns and u = N) and row-sparse, to f32 atol and
   rtol 1e-5; at k in {8, 100, 128, 200}, at P % 4 in {0, 1, 2, 3} and at a
   base 4 bytes off 16 (the load width follows the alignment), the plain
   version's values and the same bits as the 4-wide loads give on the same
   columns, and an out-of-range column id turning every output NaN; the Eq. 5
   ``fused_sgd`` at k in {8, 16, 100}, at batch 30, at widths 20-48-36-7
   and at 50 steps, with losses on and off, to atol 1e-4 (the sums run in
   another order than the plain version's batched products), inactive rows
   bit-identical, the same bits on a second launch and for a row alone as
   among k;
2b. ``aggregate`` past 2^31 columns: k = 2 rows of an (N = 2, P = 2^31 +
   4,096) buffer (X and Y 17.2 GB each), the column windows at the start,
   across 2^31 and at the end held against ``aggregate_plain`` on the same
   windows (f32 atol and rtol 1e-5), timed beside its bound, its plain
   version and ``matmul`` (cuBLAS refuses a dimension past 2^31: the
   refusal is then recorded in place of their times); freed after;
3. zero the launch counters, run ``run_simulation(DySTop(V=10, t_thre=20),
   SimConfig())`` at the defaults on the card, read the counters (both
   kernels must have launched) and check that accuracy rose;
4. time each kernel (CUDA events, median of 60 launches queued behind a
   device-side sleep, so the time is the card's and not the host's) beside
   its plain version, one PyTorch library call where one computes the same
   function, and its bound — the larger of the bytes it must move over
   3.35 TB/s and its flops over 67 TFLOP/s f32 — at every shape the main
   path launched (``aggregate`` also on a (1, 1) x (1, 128) call beside one
   PyTorch elementwise launch: the floor of this timing);
5. run a 60-round copy of the config on the card and on the CPU: the
   control plane must match exactly and the accuracy curve within 1e-3
   (both runs draw identical batches);
6. run the main path once more under ``torch.profiler`` and report the
   card's kernel time and its share of phase 3's wall time;
7. hold the flash-attention kernel against its plain version on the card,
   in bf16 and f32: the LM path's shape (4, 9, 256, 64) causal with 3 kv
   heads, a ragged S = 200, window 64, softcap 50, (1, 8, 1024, 128), and
   window 0 (every row fully masked, the first rows included) beside a
   non-causal window of -32 (the last 33 rows fully masked), and (8, 8,
   950, 256) with window 300 and softcap 30 (bf16: two warpgroups, the
   second past S in the last tile); in bf16 only (the f32 kernel must
   refuse them), the bf16 kernel's lifted limits: D = 112 (kimi-k2), D =
   32 and B = 70,000 — f32 to 1e-5 absolute, bf16
   to 2 bf16 ulps of the larger magnitude after 1e-6 of f32 sum-order
   noise; a bf16 input whose stride or base is not 16-byte aligned must
   raise without a launch;
8. zero the launch counters, run the LM fleet's main path at full width —
   ``run_lm_federation(DySTop(V=3.0, t_thre=10, max_neighbors=3),
   smollm_135m.get_config(), LMRunConfig(n_workers=8, n_rounds=30,
   batch=4, seq=256, optimizer="adam", lr=1e-3, eval_every=5))``, all 30
   layers, as ``examples/dfl_lm.py`` runs it except ``seq=256`` for its 64,
   so each row's attention spans four of the kernel's 64-row kv tiles — read
   the counters (flash_attention and aggregate must have launched) and
   check the evals are finite;
9. at the LM path's commonest shapes, hold each kernel against its plain
   version once more and time it: flash on the model's strided q/k/v views
   (2 bf16 ulps) beside its plain version,
   ``scaled_dot_product_attention(is_causal=True)`` and its bound (bytes
   over 3.35 TB/s against flops over the peak for the inputs' type, 989
   TFLOP/s bf16 or 67 TFLOP/s f32), and the same at grok-1-314b's
   attention widths (1, 48, 4096, 128) with 8 kv heads and no softcap (so
   the library call computes the same function) and gemma2-2b's (2, 8,
   4096, 256) with 4 kv heads, softcap 50 and window 4096 (the library
   call: compiled ``flex_attention`` with the softcap as its score_mod),
   each held to 2 bf16 ulps first; the library call's own distance from
   the plain version is reported; aggregate over the fleet's real (8, P)
   buffer (f32 atol and rtol 1e-5) beside its plain version, ``matmul``
   and its bound; then, the fleet freed, profile a 5-round copy of phase
   8 (cut from 10 rounds, for the time limit): the card's kernel time
   over that copy's own round-loop wall (its
   ``wall_s`` less its ``setup_wall_s``) is the busy share;
10. run the smoke geometry of smollm-135m for 9 rounds with 4 workers (two
   rounds train 3 and 4 rows) on the card and on the CPU: the control plane
   must match exactly and ``loss_global`` within 2e-2 (bf16 activations
   round in other kernels on the two devices, and Adam steps the rounded
   parameters);
11. hold the ``ssd_chunk`` kernel against its plain version on the card,
   with TF32 off, to atol and rtol 2e-4 (the JAX package's own kernel
   tolerance), outputs finite: the mamba2 path's shape (G, H, Q, N, P) =
   (8, 80, 256, 128, 64) on the model's head-major views, the smoke shape,
   a ragged Q = 200, a large ``dt`` whose masked exponents pass 88, and a
   ``cum_la`` that rises (a random walk; a spike that would overflow a
   decay split at a tile's first row), held on the rows the plain version
   gives finite;
12. zero the launch counters, run the LM fleet on mamba2-2.7b at full width
   and 8 of its 64 layers — ``run_lm_federation(DySTop(V=3.0, t_thre=10,
   max_neighbors=3), replace(mamba2_2_7b.get_config(), n_layers=8),
   LMRunConfig(n_workers=8, n_rounds=20, batch=4, seq=512,
   optimizer="adam", lr=1e-3, eval_every=5))`` (cut from 30 rounds, for
   the time limit), two 256-step chunks per
   row — read the counters (ssd_chunk and aggregate must have launched,
   flash_attention must not), check the evals, parameters and optimizer
   state are finite, record the largest masked exponent the path met, hold
   ``aggregate`` against its plain version on the fleet's (8, P) buffer,
   and profile a 5-round copy for the busy share as in phase 9;
13. time ``ssd_chunk`` at the path's commonest shape beside its plain
   version and its bound (no single PyTorch call computes it);
14. run the mamba2 smoke geometry for 9 rounds with 4 workers (seq 64 over
   chunk 32) on the card and on the CPU: control plane identical,
   ``loss_global`` within 2e-2;
15. hold the ``moe_router`` kernel against its plain version on the card:
   (T, E, k) = (8, 8, 2) (the serving path's decode shape), (4096, 8, 2),
   (4096, 384, 8) (kimi-k2's experts) and a ragged T = 300, each with rows
   of all-equal logits, of duplicated maxima and of +-1e4 — ids identical,
   gates within 1e-6 and finite;
16. zero the launch counters and serve grok-1-314b at full width and 4 of
   its 64 layers: ``replace(grok_1_314b.get_config(), n_layers=4)`` drawn
   on the card from a CUDA generator, ``ServeEngine(batch_slots=8,
   max_len=512, seed=0, device="cuda")`` under ``traffic.drive`` on the
   wall clock over ``ARRIVAL_PRESETS["steady"]`` (Poisson 6 req/s, 24
   requests, prompts 4-24, generations 8-32, greedy, seed 11).  Every
   request must finish with its ``max_new_tokens`` tokens, every tick's
   logits be finite, ``moe_router`` launch once per MoE layer per tick and
   flash_attention, ssd_chunk, aggregate and fused_sgd not at all.  Reports
   tokens/s, TTFT and per-token latency p50/p99, occupancy, ms per tick,
   peak memory, init wall, and the card's busy share over ticks 40-70 of a
   profiled second drive of the same requests (cut from the whole drive,
   for the time limit), which must serve the same tokens;
17. time ``moe_router`` at (8, 8, 2) and (4096, 384, 8) beside its plain
   version and its bound (T E 4 + T k 8 bytes over 3.35 TB/s; no single
   PyTorch call computes it);
18. serve the same 8 greedy requests from the same parameters through the
   engine on the card and on the CPU, on the smoke geometries of grok,
   smollm-135m and mamba2-2.7b: a stream may leave the CPU's only at a step
   where the CPU's top-2 logit gap is under ``SERVE_CARD_CPU_TOL`` (such
   steps are counted), and the card's logits, teacher-forced on the CPU's
   streams, must be within that tolerance of the CPU's; likewise on
   recurrentgemma-2b's smoke geometry with prompts of 40-56 and
   generations of 24-40 tokens (max_len 128), past its 64-token window, so
   the attention ring and the RG-LRU state both run on.

Phases 19-21 run the fleet mesh: for S in (2, 4) the script spawns S ranks
(``launch.mesh.spawn``; gloo, every rank on ``cuda:0``) that run phases 19
and 20, and at S = 2 phase 21; each check raises inside its rank, which
fails the whole call.

19. hold each mesh twin against its plain version on the whole buffer:
   ``aggregate_rows_sharded`` and ``aggregate_rows_cols_sharded`` over the
   sim path's buckets (N = 100, P = 6,922, padding columns included) and,
   at S = 2, ``aggregate_rows_sharded`` on the LM fleet's (8, P =
   134,515,008) buffer at k = 2, to f32 atol and rtol 1e-5;
   ``fused_sgd_sharded`` bit-identical to the unsharded kernel on the same
   rows and within 1e-4 of the plain version.  Time, on each rank, the
   per-shard ``aggregate`` launch (ranks in turn), the all-reduce and the
   whole twin (host wall, ranks together), beside the unsharded kernel, the
   plain version, ``matmul`` and the per-shard bound;
20. zero the counters on each rank, run ``run_simulation(DySTop(V=10,
   t_thre=20), SimConfig(mesh_shards=S))`` at the defaults, read them: every
   rank must have launched ``aggregate`` and ``fused_sgd``, the control
   plane must equal phase 3's exactly, ``acc_global`` be within 2e-2 of it
   and every rank's final block finite;
21. (S = 2) the LM fleet of phase 8 at 5 rounds (cut from 10, for the
   time limit) with ``mesh_shards=2``, against an unsharded 5-round run
   of the same config: control plane
   identical, ``loss_global`` within rtol 1e-3, ``flash_attention`` and
   ``aggregate`` launched on both ranks, the assembled fleet finite;
   reports the wall, the all-reduce time per round and each rank's peak
   memory.

Phases 22-25 run the Table-I arena, the convergence bound and snapshots:

22. the arena's headline cell (``benchmarks/arena.py::main``'s phi 0.4
   clean cell with ``benchmarks/common.py::run_mech``'s settings, copied
   into ``ARENA_CFG``: 24 workers, a 6,000-round cap, 4,000 simulated s,
   target 0.55, seed 0): each of DySTop, MATCHA, GossipFL, AsyDFL and
   SA-ADFL runs ``run_simulation`` on the card with the counters zeroed
   (``aggregate`` and ``fused_sgd`` must launch), on the CPU at one
   intra-op thread (control plane identical, ``acc_global`` within 1e-3 at
   every eval) and once more on the card under a profiler that records
   device activity alone (the busy share); reports t@0.55, comm GB@0.55, the final accuracy, wall and busy share per mechanism, and
   DySTop's savings against the best ADFL baseline beside the JAX
   package's CPU figures; then holds each kernel at the cell's new shapes
   against its plain version and times it beside the library call and its
   bound;
23. DySTop and AsyDFL on the same cell for 100 rounds with a bound log, on
   the card and on the CPU: Theorem 1's bound over the two logs must be
   equal to the last bit;
24. a child process (``chip_smoke.py --sim-child DIR``) runs
   ``SimConfig()`` with the churn20 scenario and a snapshot every 50
   rounds on the card and gets SIGKILL once its second snapshot exists;
   the run resumed on the card from the oldest snapshot left must equal an
   uninterrupted checkpointing run on the card (control plane exactly,
   curves within rtol 1e-6 / atol 1e-7; whether they are bit-equal is
   reported);
25. smollm-135m at full width with 2 workers (cut from phase 8's 8: a
   snapshot holds 12 bytes per parameter per worker, 3.2 GB here) for 6
   rounds with a snapshot every 3 (the free disk is checked first); the
   run resumed from round 3 must equal the uninterrupted one on the
   control plane and within rtol 1e-3 on ``loss_global``; 8 greedy requests
   served through ``serving.bridge`` from the round-6 snapshot, for worker 0
   and for the Eq. 11 global model, must all complete, the served
   parameters being the snapshot's row bit for bit; the snapshots are
   deleted afterwards.

Phases 26-29 run the hybrid family and train the moe family:

26. zero the launch counters, run the LM fleet on recurrentgemma-2b at full
   width and 3 of its 26 layers (one rglru, rglru, attn_local period) —
   ``run_lm_federation(DySTop(V=3.0, t_thre=10, max_neighbors=3),
   replace(recurrentgemma_2b.get_config(), n_layers=3),
   LMRunConfig(n_workers=4, n_rounds=20, batch=1, seq=4096,
   optimizer="adam", lr=1e-3, eval_every=5))`` (cut from 30 rounds, for
   the time limit), seq past the 2,048 window
   — read the counters (flash_attention and aggregate must have launched;
   ssd_chunk, moe_router and fused_sgd not), check the evals, parameters
   and Adam state finite and the model's q/k/v views 16-byte aligned as
   they reach the kernel; hold ``aggregate`` on the fleet's (4, P) buffer
   and flash at the path's (1, 10, 4096, 256) shape, 1 kv head, window
   2048, against their plain versions and time them beside ``matmul``,
   compiled ``flex_attention`` and their bounds; time the RG-LRU scan's
   forward and backward at the path's (1, 4096, 2560) for chunk lengths
   2 to 64, with their peak memory; profile a 5-round copy for the busy
   share;
27. run recurrentgemma-2b's smoke geometry for 9 rounds with 4 workers at
   seq 128, past its window of 64, on the card and on the CPU: control
   plane identical, ``loss_global`` within 2e-2;
28. serve recurrentgemma-2b at full size, 26 layers, nothing cut (drawn on
   the card), as phase 16 serves grok: every request finishes with its
   tokens, every tick's logits finite, and no kernel launches (decode reads
   its caches through plain attention and the RG-LRU step); reports as
   phase 16;
29. run grok-1-314b's smoke geometry in the LM fleet, 9 rounds, 4 workers,
   on the card and on the CPU (control plane identical, ``loss_global``
   within 2e-2), ``moe_router`` launching once per MoE layer per forward
   on the card; hold each kernel on the inputs the card's run gave it
   (the first call of each shape: ``aggregate`` within 1e-5, flash within
   2 bf16 ulps, ``moe_router_diff`` on the path's logits and on tie rows of
   the same shape) against its plain version; then ``moe_router_diff`` at
   (T, E, k) = (1024, 8, 2), (4096, 384, 8) and the smoke fleet's (128,
   4, 2), tie rows included, against ``moe_router_plain`` under autograd
   (ids identical, gates and the logits' gradient within 1e-6 and
   finite), its forward (the kernel) and backward (the plain version)
   timed beside their bounds.

Phases 30-35 run the vlm family (paligemma-3b, stub prefix embeddings) and
the encoder-decoder family (seamless-m4t-medium, stub audio frames), each
model freed before the next phase:

30. serve paligemma-3b at full size, 18 layers, nothing cut, text only, as
   phase 28 serves recurrentgemma (no kernel launches: decode is plain);
31. ``compute_loss`` forward and backward once on paligemma-3b at full
   width (drawn on the card): batch 2, 256 stub prefix embeddings in front
   of 256 text tokens; loss and every gradient finite, and no kernel
   launches (the prefix keeps attention on the plain prefix-LM mask, as
   the JAX package keeps it off its Pallas kernel);
32. paligemma's smoke geometry, card vs CPU from the same params and the
   same injected prefix: loss within 2e-2;
33. ``launch/serve.serve("seamless-m4t-medium")`` at full size (12 + 12
   layers, nothing cut): batch 8, prompt 32, gen 32, max_len 512 (128 stub
   frames drawn on the card), flash launching once per encoder layer
   (``causal=False``) and nothing else; its ms per token;
34. ``compute_loss`` forward and backward once on seamless-m4t-medium at
   full width: batch 4, seq 512, 128 frames; loss and every gradient
   finite, flash launching once per encoder and decoder layer; then flash
   held on the inputs of its first call at each of the path's shapes
   (the encoder's (8, 16, 128, 64) and (4, 16, 128, 64) non-causal, the
   decoder's (4, 16, 512, 64) causal) against its plain version within 2
   bf16 ulps, and timed beside its bound and
   ``scaled_dot_product_attention``;
35. seamless's smoke geometry, card vs CPU: loss within 2e-2, and
   ``fill_cross_cache`` + ``E_prefill``'s logits within 0.25.

Phases 36-39 run the legacy per-leaf paths on both planes and the trainer:

36. zero the launch counters and run ``SimConfig(fused_engine=False)`` at
   the defaults on the card (100 workers, 300 rounds, DySTop(V=10,
   t_thre=20), nothing cut): the control plane must equal phase 3's fused
   run, ``acc_global`` be within 0.1 of it (other batch streams) and rise,
   ``aggregate``'s dense entry launch once per leaf per round (6 x 300) and
   no other kernel launch; ``aggregate`` is held on each per-leaf shape's
   first-call inputs ((100, 100) x (100, P_leaf), P_leaf in {10, 64, 640,
   2048, 4096}) against ``aggregate_plain`` (f32 atol and rtol 1e-5) and
   timed as phase 4 times it;
37. a 60-round copy on the card and on the CPU (the same numpy batches:
   control plane identical, ``acc_global`` within 1e-3); then 20 rounds with
   a snapshot every 10 on the card, resumed from round 10: the control
   plane and ``acc_global`` bit-equal to the uninterrupted run's;
38. zero the counters and run phase 8's smollm-135m config for 5 rounds
   (cut: rounds, for the time limit) with ``resident_fleet=False``: flash
   launching once per layer in every forward (8 workers x 5 rounds plus
   the evals) and ``aggregate`` once a mixing round, nothing else; against
   a 5-round resident run: control plane identical, ``loss_global``
   within rtol 1e-3, the largest ``pbuf``/``obuf`` gaps and the peak
   memory reported; flash held on its first call's inputs (2 bf16 ulps)
   and timed beside ``scaled_dot_product_attention``;
39. zero the counters and run ``launch.train.train("smollm-135m",
   smoke=False, steps=20, batch=8, seq=128)`` on the card: flash launching
   30 x 20 times and nothing else, the loss falling (the last five steps'
   mean below the first five's), the checkpoint reading back bit-equal
   (then deleted), ms per step reported, five more steps profiled for the
   busy share, flash held on its first call's inputs and timed; then the
   smoke geometry for 5 steps on the card and on the CPU from the same
   params and batches, losses within 2e-2.

Phases 40-41 run activation recomputation and the pods plane:

40. smollm-135m at full width, ``launch/train.py``'s feed at batch 8 x seq
   2048, Adam lr 3e-4: 5 steps with ``make_train_step(remat=False)`` and 5
   with ``remat=True`` from one init drawn on the card, the counters zeroed
   before each: flash launching 30 times a step without remat and 60 with
   it (the recompute) and nothing else, the losses bit-equal; ms per step
   and the peak memory of each (the peak reset between them); flash held
   on its first call's inputs (8, 9, 2048, 64) and timed;
41. 4 smollm-135m replicas at full width as DFL workers
   (``make_dystop_round_step(remat=True, local_steps=2)``, per-pod batch 2
   x seq 512, 2 rounds, cut from 3 for the time limit; the W of
   ``examples/multipod_dystop.py``'s
   coordinator), (a) stacked in this process and (b) on 4 gloo ranks
   sharing the card (``launch.mesh.spawn``), from the same init and
   batches, the counters zeroed just before the rounds on each side:
   ``aggregate`` once a round and flash twice per layer per local step, no
   other kernel; every pod's row after every round bit-equal between (a)
   and (b) (two int64 digests of its bits), the metrics too; each identity
   row unchanged by its mix; losses finite; ``aggregate`` held on the
   path's own gathered (4, P = 134,515,008) buffer at k = 4 and on each
   rank's k = 1 call, and timed beside ``matmul`` and its bound; flash held
   on its first call's inputs (2, 9, 512, 64); the walls per round and the
   all-gather's host time per round reported.

Phase 42 counts a step against its time (``counted_phase``):

42. (a) ``build_train_artifacts`` for smollm-135m at full width (batch 8 x
   seq 2048, Adam lr 3e-4, remat) and (b) ``build_prefill_artifacts`` for
   mamba2-2.7b at 8 of 64 layers (batch 4 x seq 2048), both on
   ``make_host_mesh("cuda")``, params drawn on the card: each step counted
   once on ``meta`` (``launch.loopcost.step_costs``), then run 4 times on
   the card with the counters zeroed (the median ms of the last 3; each
   kernel launched exactly its counted calls a step times 4, flash 60 and
   ``ssd_chunk`` 8 a step, nothing else), then counted once on the card:
   the card's FLOPs, bytes, peak, argument bytes and kernel calls must
   equal ``meta``'s integer for integer.  Reports model FLOPs, ``mfu`` =
   model FLOPs / (step s x 989 TFLOP/s), the roofline share max(t_compute,
   t_memory) / step s (``launch.analysis.extract_roofline``), and the
   counted activation peak against ``max_memory_allocated`` above the
   arguments, which must agree within ``PEAK_FACTOR``; flash and
   ``ssd_chunk`` held on their first call's inputs against their plain
   versions and timed beside their bounds.

Phase 43 runs the tools' twins as a user runs them on the card:

43. (a) ``scripts/torch_chaos_check.py --plane both --device cuda`` as a
   subprocess: exit 0 and ``passed`` on both planes (each plane's
   ``killed_mid_run`` and ``resume_from`` printed); (b) each of
   ``examples/torch_quickstart.py``, ``torch_dfl_federation.py``,
   ``torch_dfl_lm.py``, ``torch_serve_lm.py`` and
   ``torch_serving_engine.py`` in this process (``runpy``) at its default
   arguments, the counters zeroed just before and read just after: its
   last printed line, its wall, exactly the kernels its path runs
   (``EXAMPLES``), flash held on each shape's first inputs (2 bf16 ulps);
   (c) paligemma-3b's loss at phase 31's full width with
   ``attn_impl="chunked"`` and naive: both finite, within
   ``CHUNKED_LOSS_TOL``, no kernel launched, ``chunked_attention`` called
   once per layer under "chunked" and never under "naive", time and peak
   of each.

Phase 44 runs the paths whose bf16 rounding follows the reference's
compiled backward and decode step, on the card against the CPU:

44. kimi-k2's and grok's smoke models (their MoE layers) and
   recurrentgemma's with ``remat=True``: ``compute_loss``'s loss and every
   gradient from one init and one seeded batch (2 x 64) within the tests'
   shared bf16 tolerance (``REPAIR_TOL``: loss 2e-3, gradients atol 5e-3
   and rtol 5e-2), flash (and on the moe family ``moe_router``) launched;
   then each decoder family's smoke config (``REPAIR_DECODE``) prefills a
   12-token prompt and decodes 8 greedy tokens: the tokens equal and every
   step's logits within 0.1, ``moe_router`` launched once per MoE layer a
   step, flash once per encoder layer (seamless's encoder, run once for
   the cross caches), nothing else.

Phase 45 runs one model sharded over a (data, model) mesh of ranks:

45. stablelm-1.6b at full width and 4 of 24 layers (``SHARD_RUN``; at 24
   the whole script passed 1,000 s):
   ``build_train_artifacts`` and ``build_prefill_artifacts`` on a 2 x 2
   mesh of 4 gloo ranks sharing the card (``launch.mesh.make_rank_mesh``;
   FSDP over data, head-parallel attention, column/row-parallel MLP and a
   vocab-parallel head over model), global batch 8 x seq 512, Adam lr
   3e-4, remat: one prefill and 2 train steps, from the same init (each
   rank draws its blocks from the unsharded init's generator stream) and
   batches as an unsharded run of the same steps on the card first (its
   memory freed before the ranks start; its new params, its logits and
   a control's, the logits of a prefill after its first step, kept on
   the host for the ranks to read).  Counters zeroed just before the
   ranks' run and read just after: flash launched twice a layer a step
   (remat) and once a layer in the prefill on every rank, nothing else.  Checks:
   each step's loss within 2e-3 and ``grad_norm`` within 2e-3 (the first
   step) and 5e-2 (the second) of itself of the unsharded run's; each
   rank's update of each param block against the unsharded run's (the
   norm of their difference over the norm of the unsharded update) and
   its block of the prefill logits against the unsharded run's slice,
   nearer than the control's (``SHARD_TOL``); the first step's gradient
   blocks (the step's own, kept by the optimizer's update) by per-block
   digests (the sum of squares and a seeded random projection,
   ``SHARD_TOL["digest"]``);
   flash held on a rank's own first call's inputs against its plain
   version, whole and as the second half of its query rows at
   ``q_offset`` (2 bf16 ulps), and timed beside its bound and SDPA.
   Prints the phase's wall, each rank's collective bytes by kind, its
   peak and its flash launches.

Prints ``{"aggregate_shapes"}``, ``{"fused_sgd_shapes"}``, ``{"lm": ...}``,
``{"mamba2": ...}``, ``{"serving": ...}``, ``{"mesh": ...}``, ``{"arena":
...}``, ``{"convergence": ...}``, ``{"sigkill_resume": ...}``,
``{"lm_snapshot": ...}``, ``{"hybrid": ...}``, ``{"moe_train": ...}``,
``{"vlm": ...}``, ``{"encdec": ...}``, ``{"legacy": ...}``, ``{"train":
...}``, ``{"remat": ...}``, ``{"pods": ...}``, ``{"counted": ...}``,
``{"tools": ...}``, ``{"repairs": ...}``, ``{"sharded": ...}``,
``{"kernels": [...]}`` (the three mesh twins as row 3, then phases 26,
29, 33, 34, 36, 41, 42, 38, 39, 40, 41 and 45's shapes),
``{"script": ...}`` and ``{"sim": {...}}`` lines, the card's name and power
limit and, as the last line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
from collections import Counter

N_WORKERS, REPS = 100, 60
MESH_SHARDS = (2, 4)               # gloo ranks sharing the one card
MESH_ACC_TOL = 2e-2                # acc_global, sim mesh vs unsharded
MESH_LOSS_RTOL = 1e-3              # loss_global, LM mesh vs unsharded
LM_CARD_CPU_TOL = 2e-2             # loss_global, card vs CPU, bf16 smoke run
SERVE_CARD_CPU_TOL = 0.25          # logits, card vs CPU, bf16 smoke serving


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def device_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn``'s launches: each rep is queued behind a
    ~1 ms device sleep, so its launches run back to back on the card and the
    host's launch overhead stays out of the number."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def past_int32_ms(fn) -> tuple:
    """(device ms of ``fn``, None), or (None, cuBLAS's message) where cuBLAS
    refuses a dimension of 2^31 or more, as its 32-bit gemm arguments do."""
    try:
        return device_ms(fn, reps=3), None
    except RuntimeError as e:
        if "2147483647" not in str(e):
            raise
        return None, str(e).splitlines()[0]


def call_ms(fn, reps: int = REPS) -> float:
    """Mean wall time per call of ``fn`` called back to back from the host
    (host launch overhead included), synchronised at the end."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_profile(fn, host: bool = True):
    """Device kernel time of ``fn`` from a ``torch.profiler`` trace: total
    seconds and the five kernels that took most, or (None, []) when the
    trace holds no device time; and the trace's device kernel count with
    the eight host ops that took most host time of their own (none when
    ``host`` is False: the trace then records device activity alone, the
    same kernel seconds at a fraction of the tracing cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return profile_rows(prof)


def profile_rows(prof):
    """``device_profile``'s reading of a finished profiler."""
    from torch.autograd import DeviceType
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us, e.key, e.count))
        elif e.device_type == DeviceType.CPU:
            host.append((e.self_cpu_time_total, e.key, e.count))
    total = sum(us for us, _, _ in rows)
    host.sort(reverse=True)
    extra = {"device_kernels": sum(c for _, _, c in rows),
             "host_top_ops": [{"op": k[:60], "self_s": us * 1e-6, "count": c}
                              for us, k, c in host[:8]]}
    if total <= 0:
        return None, [], extra
    rows.sort(reverse=True)
    return total * 1e-6, [{"kernel": k[:80], "s": us * 1e-6, "count": c}
                          for us, k, c in rows[:5]], extra


def all_finite(buf) -> bool:
    """Whether every value of an (N, P) buffer is finite, one row at a time:
    ``torch.isfinite`` makes a temporary as large as its input (an f32
    ``abs``), too much beside a 43 GB fleet."""
    import torch
    return all(bool(torch.isfinite(row).all()) for row in buf)


def agg_case(gen, k: int, u: int, n: int, col: bool, dev):
    """Inputs like the packer's: W rows (k, u) with the padding columns
    zeroed and their col_ids repeating 0 (u < N), or col_ids = arange(N)."""
    import torch
    if col and u < n:
        ut = max(1, (3 * u) // 4)
        cols = torch.sort(torch.randperm(n, generator=gen)[:ut]).values
        col_ids = torch.cat([cols, torch.zeros(u - ut, dtype=cols.dtype)])
        W = torch.rand((k, u), generator=gen)
        W[:, ut:] = 0.0
    elif col:
        col_ids = torch.arange(n)
        W = torch.rand((k, n), generator=gen)
    else:
        col_ids = None
        W = torch.rand((k, n), generator=gen)
    W = W / W.sum(1, keepdim=True)
    cid = None if col_ids is None else col_ids.to(torch.int32).to(dev)
    return W.to(dev), cid


def sgd_case(gen, k, steps, batch, dim, classes, dev, p):
    import torch
    buf = torch.randn((k, p), generator=gen) * 0.2
    xb = torch.randn((k, steps, batch, dim), generator=gen)
    yb = torch.randint(0, classes, (k, steps, batch), generator=gen,
                       dtype=torch.int32)
    active = (torch.arange(k) % 4 != 3).float()     # a quarter idle
    return buf.to(dev), xb.to(dev), yb.to(dev), active.to(dev)


def mlp_stacked(d: int, h: int, g: int, c: int):
    """A one-row stacked MLP of widths d-h-g-c (only its shapes are used)."""
    import torch
    return {"b1": torch.zeros((1, h)), "b2": torch.zeros((1, g)),
            "b3": torch.zeros((1, c)), "w1": torch.zeros((1, d, h)),
            "w2": torch.zeros((1, h, g)), "w3": torch.zeros((1, g, c))}


def flash_mask(s: int, causal: bool, window):
    import torch
    rows = torch.arange(s)[:, None]
    cols = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= (rows - cols) < window
    return mask


def bf16_ulps(got, want, f32_atol: float = 1e-6) -> float:
    """Largest distance in bf16 ulps of the larger magnitude, after
    ``f32_atol`` of f32 sum-order noise (which near 0 is itself several bf16
    ulps of the tiny value)."""
    import torch
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() - f32_atol).clamp_min(0).div(ulp).max())


def flash_long_row(gen, dev, label, b, h, hk, s, d, softcap, window):
    """Hold the bf16 flash kernel against its plain version at (b, h, s, d)
    causal on the model's (B, S, H, D) views and time it beside the plain
    version, its bound and one library call that computes the same function:
    ``scaled_dot_product_attention`` with the kv heads repeated where there
    is no softcap and no window, else ``flex_attention`` (compiled) with the
    softcap as its score_mod, causal and window as its block mask, and the
    kv heads grouped in place.  The library call's own distance from the
    plain version is reported."""
    from repro_torch.launch import loopcost as LC
    import torch
    from repro_torch.kernels import flash_attention as FA
    bf = torch.bfloat16
    q = torch.randn((b, s, h, d), generator=gen).to(dev, bf).transpose(1, 2)
    k = torch.randn((b, s, hk, d), generator=gen).to(dev, bf).transpose(1, 2)
    v = torch.randn((b, s, hk, d), generator=gen).to(dev, bf).transpose(1, 2)
    got = FA.flash_attention(q, k, v, True, window, softcap)
    want = FA.flash_attention_plain(q, k, v, True, window, softcap)
    torch.cuda.synchronize()
    ulps = bf16_ulps(got.float(), want.float())
    check(bool(torch.isfinite(got).all()) and ulps <= 2.0,
          f"flash {label}: {ulps} bf16 ulps")
    b_ms, b_by = LC.flash_cost(q, k, True, window).bound()
    row = {"label": label, "shape": [b, h, s, d], "kv_heads": hk,
           "dtype": str(bf), "causal": True, "window": window,
           "softcap": softcap, "max_bf16_ulps": ulps,
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "ms": device_ms(lambda: FA.flash_attention(q, k, v, True, window,
                                                      softcap), 20),
           "plain_ms": device_ms(lambda: FA.flash_attention_plain(
               q, k, v, True, window, softcap), 5),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if softcap is None and window is None:
        k_rep = k.repeat_interleave(h // hk, dim=1)
        v_rep = v.repeat_interleave(h // hk, dim=1)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True)
        row["library_ms"] = device_ms(sdpa, 20)
        row["library_bf16_ulps"] = bf16_ulps(sdpa().float(), want.float())
        row["library"] = "scaled_dot_product_attention"
        return row
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def keep(b_, h_, q_, k_):
        inside = k_ <= q_
        return inside if window is None else inside & (q_ - k_ < window)

    def cap(score, b_, h_, q_, k_):
        return score if softcap is None else torch.tanh(
            score / softcap) * softcap

    block = create_block_mask(keep, None, None, s, s, device=dev)
    flex_c = torch.compile(flex_attention, dynamic=False)
    flex = lambda: flex_c(q, k, v, score_mod=cap, block_mask=block,
                          enable_gqa=True)
    row["library_ms"] = device_ms(flex, 20)
    row["library_bf16_ulps"] = bf16_ulps(flex().float(), want.float())
    row["library"] = "flex_attention"
    return row


def ssd_case(gen, g, h, q, n, p, rate, dev):
    """Inputs as ``ssm_forward`` hands them over: Bc, Cc (G, Q, N); cum_la a
    cumulative sum of negative log decays, ``rate`` per step on average,
    and xbar, both as head-major views of (G, Q, H, .) tensors."""
    import torch
    Bc = torch.randn((g, q, n), generator=gen)
    Cc = torch.randn((g, q, n), generator=gen)
    step = torch.nn.functional.softplus(torch.randn((g, q, h), generator=gen))
    la = -torch.cumsum(step * rate, dim=1)
    xb = torch.randn((g, q, h, p), generator=gen)
    return (Bc.to(dev), Cc.to(dev), la.to(dev).transpose(1, 2),
            xb.to(dev).transpose(1, 2))


def recorder(counter, agg, fa=None):
    """Wrappers around the kernels' entry points that count each call's
    shape (the kernels' own launch counters stay the only proof of
    launches)."""
    def rec_agg(W, X, col_ids=None, **kw):
        counter[("aggregate", W.shape[0], W.shape[1],
                 col_ids is not None)] += 1
        return agg(W, X, col_ids, **kw)

    def rec_fa(q, k, v, causal=True, window=None, softcap=None,
               q_offset=0):
        counter[("flash_attention", tuple(q.shape), k.shape[1], q.dtype,
                 causal, window, softcap)] += 1
        return fa(q, k, v, causal, window, softcap, q_offset)

    return rec_agg, rec_fa


def ssd_recorder(counter, exponents, ssd):
    """A wrapper around ``ssd_chunk`` that counts each call's shape and
    keeps, on the card and without a sync, the largest masked exponent
    la_0 - la_{Q-1} of the call (la falls along the chunk, so it is the
    largest la_q - la_t over t > q: what an exp-before-mask form would
    evaluate)."""
    def rec_ssd(Bc, Cc, cum_la, xbar):
        g, h, q, p = xbar.shape
        counter[("ssd_chunk", g, h, q, Bc.shape[2], p)] += 1
        exponents.append((cum_la[..., 0] - cum_la[..., -1]).detach().max())
        return ssd(Bc, Cc, cum_la, xbar)

    return rec_ssd


def lm_aggregate_row(gen, shapes, launches: int, buf, label: str) -> dict:
    """Hold ``aggregate`` against its plain version on an LM fleet's real
    (N, P) buffer at the path's commonest mix shape (f32 atol and rtol
    1e-5), and time it beside its plain version, ``matmul`` and its bound
    (median of 10 launches: each moves GBs)."""
    from repro_torch.launch import loopcost as LC
    import torch
    from repro_torch.kernels import aggregate as AGG
    (_, k, u, col), count = max(((s, c) for s, c in shapes.items()
                                 if s[0] == "aggregate"), key=lambda sc: sc[1])
    n, p = buf.shape
    W, cid = agg_case(gen, k, u, n, col, buf.device)
    b_ms, b_by = LC.agg_cost(W.cpu(), None if cid is None else cid.cpu(),
                             p, n).bound()
    got = AGG.aggregate(W, buf, cid)
    want = AGG.aggregate_plain(W, buf, cid)
    torch.cuda.synchronize()
    # compared a column block at a time: whole-width temporaries (7.3 GB
    # each at the hybrid fleet's P) do not fit beside a large fleet
    err, ok, step = 0.0, True, 1 << 26
    for lo in range(0, p, step):
        a, b_ = got[:, lo:lo + step], want[:, lo:lo + step]
        gap = (a - b_).abs()
        err = max(err, float(gap.max()))
        ok = ok and bool((gap <= 1e-5 + 1e-5 * b_.abs()).all())
    check(ok, f"aggregate at the {label} shape: |err| {err} past f32 atol "
          f"and rtol 1e-5 (or not finite)")
    del got, want, a, b_, gap
    print(f"aggregate at the {label} shape (k={k}, u={u}, P={p}) on the "
          f"fleet's buffer: max |err| {err:.3e}", flush=True)
    lib_cid = None if cid is None else cid.long()
    return {
        "label": label, "k": k, "u": u, "col_sparse": col, "P": p,
        "rounds": count, "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: AGG.aggregate(W, buf, cid), reps=10),
        "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, buf, cid),
                              reps=10),
        "library_ms": device_ms(
            (lambda: torch.matmul(W, buf)) if cid is None else
            (lambda: torch.matmul(W, buf.index_select(0, lib_cid))), reps=10),
        "bound_ms": b_ms, "bound_by": b_by}


def lm_profile(mech, cfg, run) -> dict:
    """Profile a 5-round copy of an LM run: the card's kernel time over the
    copy's own round loop (its ``wall_s`` less its ``setup_wall_s``) is the
    busy share."""
    from repro_torch.dfl import lm_worker as LW
    short = dataclasses.replace(run, n_rounds=5)
    hist = []
    busy_s, top, extra = device_profile(
        lambda: hist.append(LW.run_lm_federation(mech, cfg, short)[1]))
    loop_wall = hist[0].wall_s - hist[0].setup_wall_s
    return {"profiled_rounds": short.n_rounds,
            "profiled_run_wall_s": hist[0].wall_s,
            "profiled_setup_wall_s": hist[0].setup_wall_s,
            "device_busy_s": busy_s,
            "device_busy_share": (None if busy_s is None
                                  else busy_s / loop_wall),
            "device_top_kernels": top, **extra}


def lm_card_vs_cpu(mech, cfg, label: str, seq: int = 64,
                   after_card=None) -> float:
    """Run ``cfg`` for 9 rounds with 4 workers on the card and on the CPU:
    the control plane must match exactly and ``loss_global`` within
    ``LM_CARD_CPU_TOL``.  ``after_card`` is called right after the card's
    run (to read the launch counters).  Returns the largest loss gap."""
    import numpy as np
    from repro_torch.dfl import lm_worker as LW
    run = LW.LMRunConfig(n_workers=4, n_rounds=9, batch=2, seq=seq,
                         eval_every=3, seed=1)
    _, card = LW.run_lm_federation(mech(), cfg, run)
    if after_card is not None:
        after_card()
    _, cpu = LW.run_lm_federation(mech(), cfg, run, device="cpu")
    for f in ("rounds", "sim_time", "comm_gb", "round_active",
              "round_durations", "staleness_avg", "staleness_max"):
        check(getattr(card, f) == getattr(cpu, f),
              f"{label} card and CPU runs differ in {f}")
    gap = float(np.max(np.abs(np.asarray(card.loss_global)
                              - np.asarray(cpu.loss_global))))
    check(gap <= LM_CARD_CPU_TOL,
          f"{label} card and CPU loss_global differ by {gap}")
    print(f"{label} card vs CPU, {run.n_rounds} rounds: control plane "
          f"identical, max |loss_global gap| {gap:.2e}", flush=True)
    return gap


def router_logits(gen, t: int, e: int, dev):
    """Random (T, E) logits with rows of all-equal logits, of duplicated
    maxima and of +-1e4 at the top."""
    import torch
    x = torch.randn((t, e), generator=gen) * 3
    x[0] = 1.0
    x[1] = -5.0
    x[1, [1, e - 1]] = 2.0
    x[2, : e // 2] = 1e4
    x[2, e // 2:] = -1e4
    x[3, -1] = float(x[3].max()) + 1.0
    x[3, :2] = x[3, -1]
    return x.to(dev)


def router_tie_logits(t: int, e: int, dev):
    """(T, E) logits in which every row ties: all equal, a maximum repeated
    at two indices, half at +1e4 and half at -1e4, and distinct logits that
    all underflow to probability 0 beside one leader (rising with the index,
    so a pick on logits would take the highest index first), in turn."""
    import torch
    rows = torch.empty((4, e))
    rows[0] = 1.0
    rows[1] = -5.0
    rows[1, [1, e - 1]] = 2.0
    rows[2, : e // 2] = 1e4
    rows[2, e // 2:] = -1e4
    rows[3] = -200.0 - 0.5 * (e - torch.arange(e, dtype=torch.float32))
    rows[3, e // 3] = 50.0
    return rows.repeat((t + 3) // 4, 1)[:t].contiguous().to(dev)


def serve_requests(cfg, n: int, seed: int, prompt_len=(4, 12),
                   gen_len=(8, 16)):
    from repro_torch.serving import TrafficConfig, generate_requests
    return generate_requests(TrafficConfig(n_requests=n, prompt_len=prompt_len,
                                           gen_len=gen_len, seed=seed),
                             cfg.vocab_size)


def teacher_forced(cfg, params, prompt, out, dev):
    """Logits (len(out), V) for each generated token of a request: the
    engine feeds the prompt, its last token again, then the stream."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    seq = np.concatenate([prompt, prompt[-1:], out[:-1]]).astype(np.int64)
    cache = R.init_decode_cache(cfg, ShapeSpec("tf", len(seq), 1, "decode"),
                                dev)
    with torch.no_grad():
        logits, _ = T.prefill_cache(cfg, params, cache,
                                    torch.from_numpy(seq)[None].to(dev))
    return logits[0, len(prompt):, :cfg.vocab_size].float().cpu()


def serve_card_vs_cpu(cfg, label: str, prompt_len=(4, 12), gen_len=(8, 16),
                      max_len: int = 64) -> dict:
    """The same params and 8 greedy requests through the engine on the card
    and on the CPU.  A stream may leave the CPU's only where the CPU's top-2
    gap is under ``SERVE_CARD_CPU_TOL``; the card's logits teacher-forced on
    the CPU's streams must be within it.  Returns the counts and gaps."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_map
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    card_params = tree_map(lambda t: t.to("cuda"), params)
    reqs = serve_requests(cfg, 8, 21, prompt_len, gen_len)
    outs = {}
    for dev, p in (("cuda", card_params), ("cpu", params)):
        eng = ServeEngine(cfg, p, batch_slots=4, max_len=max_len, device=dev)
        for r in reqs:
            eng.submit(r.prompt, r.gen)
        outs[dev] = eng.run()
    near_ties, max_gap, tf_err = 0, 0.0, 0.0
    for rid, r in enumerate(reqs):
        want = np.asarray(outs["cpu"][rid])
        got = np.asarray(outs["cuda"][rid])
        check(len(got) == len(want) == r.gen.max_new_tokens,
              f"{label}: request {rid} has {len(got)} tokens on the card, "
              f"{len(want)} on the CPU")
        cpu_l = teacher_forced(cfg, params, r.prompt, want, "cpu")
        card_l = teacher_forced(cfg, card_params, r.prompt, want, "cuda")
        tf_err = max(tf_err, float((card_l - cpu_l).abs().max()))
        diff = np.nonzero(got != want)[0]
        if len(diff):
            top2 = torch.sort(cpu_l[diff[0]]).values[-2:]
            gap = float(top2[1] - top2[0])
            check(gap < SERVE_CARD_CPU_TOL,
                  f"{label}: request {rid} leaves the CPU's stream at step "
                  f"{diff[0]}, where the CPU's top-2 gap is {gap}")
            near_ties += 1
            max_gap = max(max_gap, gap)
    check(tf_err <= SERVE_CARD_CPU_TOL,
          f"{label}: teacher-forced logits, card vs CPU, differ by {tf_err}")
    print(f"serving {label} card vs CPU: {len(reqs)} requests, "
          f"{near_ties} streams leave the CPU's at a near tie, "
          f"teacher-forced max |logit gap| {tf_err:.3e}", flush=True)
    return {"requests": len(reqs), "max_len": max_len,
            "longest_request": max(len(r.prompt) + r.gen.max_new_tokens
                                   for r in reqs),
            "near_tie_streams": near_ties,
            "largest_tie_gap": max_gap, "teacher_forced_max_abs_err": tf_err}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, dev, reps: int) -> float:
    """Median host wall of ``fn`` over ``reps`` calls, each synchronised
    before and after (a collective's time is the host's: gloo runs it)."""
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_serial(fn):
    """Run ``fn`` on each rank in turn (barriers between), so that ranks
    sharing one card time their kernels alone; returns this rank's result."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == r:
            out = fn()
    dist.barrier()
    return out


def zero_counters() -> None:
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_sgd as FSGD
    from repro_torch.kernels import moe_router as MR
    from repro_torch.kernels import ssd_chunk as SC
    AGG.launches = AGG.launches_rows_sharded = AGG.launches_cols_sharded = 0
    FSGD.launches = FSGD.launches_sharded = FA.launches = 0
    SC.launches = MR.launches = 0


def read_counters() -> dict:
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_sgd as FSGD
    from repro_torch.kernels import moe_router as MR
    from repro_torch.kernels import ssd_chunk as SC
    return {"aggregate": AGG.launches, "fused_sgd": FSGD.launches,
            "flash_attention": FA.launches, "ssd_chunk": SC.launches,
            "moe_router": MR.launches,
            "aggregate_rows_sharded": AGG.launches_rows_sharded,
            "aggregate_rows_cols_sharded": AGG.launches_cols_sharded,
            "fused_sgd_sharded": FSGD.launches_sharded}


def mesh_twin_rows(shd, W, X, block, seg, cid, reps: int, label: str) -> dict:
    """Phase 19 for one twin at one shape: hold this rank's rows against the
    plain version on the whole buffer (f32 atol and rtol 1e-5), then time
    the per-shard launch and ``matmul`` on the same shard inputs (ranks in
    turn), the all-reduce and the whole twin (ranks together), beside the
    unsharded kernel, its plain version and ``matmul`` (rank 0)."""
    from repro_torch.launch import loopcost as LC
    import torch
    from repro_torch.kernels import aggregate as AGG
    dev = shd.device
    lo, hi = seg
    k, p = W.shape[0], X.shape[1]
    if cid is None:
        twin = lambda: AGG.aggregate_rows_sharded(W, block, shd, seg)
        Wb = W[:, shd.home[0]:shd.home[1]].contiguous()
        shard_in = (Wb, block)
        part = torch.zeros((k, p), dtype=torch.float32, device=dev)
        b_ms, b_by = LC.agg_cost(Wb.cpu(), None, p, shd.block).bound()
        W_full = W[:, :shd.n_rows].contiguous()
    else:
        twin = lambda: AGG.aggregate_rows_cols_sharded(W, cid, block, shd,
                                                       seg)
        shard_in = None if hi == lo else (
            W[lo:hi], torch.randn((cid.shape[0], p), device=dev))
        part = torch.zeros((cid.shape[0], p), dtype=torch.float32,
                           device=dev)
        b_ms, b_by = ((None, None) if hi == lo else
                      LC.agg_cost(W[lo:hi].cpu(), None, p,
                                  cid.shape[0]).bound())
        W_full = W
    got = twin()
    want = AGG.aggregate_plain(W_full[lo:hi], X, cid)
    sync(dev)
    err = float((got - want).abs().max()) if hi > lo else 0.0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                               msg=lambda m: f"{label}: {m}")
    del got, want
    ms = rank_serial(lambda: None if shard_in is None else device_ms(
        lambda: AGG.aggregate(*shard_in), reps=reps))
    lib_ms = rank_serial(lambda: None if shard_in is None else device_ms(
        lambda: torch.matmul(*shard_in), reps=reps))
    row = {"shape": label, "rank": shd.rank, "seg": [lo, hi],
           "max_abs_err": err, "shard_ms": ms, "shard_library_ms": lib_ms,
           "allreduce_ms": wall_ms(lambda: shd.psum(part), dev, reps),
           "twin_ms": wall_ms(twin, dev, reps),
           "shard_bound_ms": b_ms, "shard_bound_by": b_by}

    def unsharded():
        lib_cid = None if cid is None else cid.long()
        return {"unsharded_ms": device_ms(
                    lambda: AGG.aggregate(W_full, X, cid), reps=reps),
                "plain_ms": device_ms(
                    lambda: AGG.aggregate_plain(W_full, X, cid), reps=reps),
                "library_ms": device_ms(
                    (lambda: torch.matmul(W_full, X)) if cid is None else
                    (lambda: torch.matmul(W_full, X.index_select(0, lib_cid))),
                    reps=reps)}

    row.update(rank_serial(lambda: unsharded() if shd.rank == 0 else {}))
    return row


def mesh_twins(plan: dict) -> dict:
    """Phase 19 on this rank: every twin against its plain version at the
    sim path's buckets (and at S = 2 on the LM fleet's buffer), timed at
    the main path's commonest shapes."""
    from repro_torch.launch import loopcost as LC
    import numpy as np
    import torch
    from repro_torch.dfl import flat_state as FS
    from repro_torch.dfl import worker as WK
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import fused_sgd as FSGD
    from repro_torch.sharding.rules import FleetSharding
    import torch.distributed as dist
    n, p, reps = plan["n"], plan["P"], plan["reps"]
    shd = FleetSharding.create(dist.get_world_size(), n, plan["device"])
    dev = shd.device
    gen = torch.Generator().manual_seed(4321)   # the same draws on each rank
    X = torch.randn((n, p), generator=gen).to(dev)
    block = shd.put_rows_padded(X)
    buckets = plan["buckets"]

    def ids(k):
        return np.sort(torch.randperm(n, generator=gen)[:k].numpy())

    errs = {"rows": 0.0, "cols": 0.0, "sgd_vs_kernel": 0.0, "sgd_vs_plain": 0.0}
    for k in buckets:
        rid = ids(k)
        seg = shd.for_rows(rid)
        W, _ = agg_case(gen, k, n, n, False, dev)
        W = torch.from_numpy(WK.pad_w_cols(W.cpu().numpy(), shd.n_pad)).to(dev)
        got = AGG.aggregate_rows_sharded(W, block, shd, seg)
        want = AGG.aggregate_plain(W[seg[0]:seg[1], :n], X)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        errs["rows"] = max(errs["rows"], float((got - want).abs().max())
                           if len(got) else 0.0)
        for u in buckets:
            W_sub, cid = agg_case(gen, k, u, n, True, dev)
            got = AGG.aggregate_rows_cols_sharded(W_sub, cid, block, shd, seg)
            want = AGG.aggregate_plain(W_sub[seg[0]:seg[1]], X, cid)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            errs["cols"] = max(errs["cols"], float((got - want).abs().max())
                               if len(got) else 0.0)
    spec = FS.spec_of(WK.init_stacked(torch.Generator(), 1, plan["dim"],
                                      plan["hidden"], 10))
    steps, batch, lr = plan["steps"], plan["batch"], plan["lr"]
    for k in plan["sgd_ks"]:
        for with_losses in (True, False):
            buf, xb, yb, active = sgd_case(gen, k, steps, batch, plan["dim"],
                                           10, dev, spec.n_params)
            a, b = shd.for_rows(ids(k))
            got, g_loss = FSGD.fused_sgd_sharded(
                buf[a:b], xb[a:b], yb[a:b], active[a:b], spec, lr,
                with_losses)
            ker, k_loss = FSGD.fused_sgd(buf, xb, yb, active, spec, lr,
                                         with_losses)
            pl, p_loss = FSGD.local_sgd_flat_fused(buf, xb, yb, active, spec,
                                                   lr, with_losses)
            sync(dev)
            check(torch.equal(got, ker[a:b]) and torch.equal(g_loss,
                                                             k_loss[a:b]),
                  f"fused_sgd_sharded (k={k}) differs from the unsharded "
                  f"kernel on rank {shd.rank}")
            torch.testing.assert_close(got, pl[a:b], atol=1e-4, rtol=0)
            torch.testing.assert_close(g_loss, p_loss[a:b], atol=1e-4, rtol=0)
            errs["sgd_vs_plain"] = max(
                errs["sgd_vs_plain"], float((got - pl[a:b]).abs().max())
                if b > a else 0.0)
    out = {"rank": shd.rank, "backend": shd.mesh.backend,
           "device": str(dev), "max_abs_err": errs, "times": []}

    # times at the sim path's commonest shapes
    for k, u, col in plan["agg_top"]:
        rid = ids(k)
        seg = shd.for_rows(rid)
        if col:
            W, cid = agg_case(gen, k, u, n, True, dev)
        else:
            W, cid = agg_case(gen, k, n, n, False, dev)
            W = torch.from_numpy(WK.pad_w_cols(W.cpu().numpy(),
                                               shd.n_pad)).to(dev)
        out["times"].append(mesh_twin_rows(
            shd, W, X, block, seg, cid, reps,
            f"sim k={k} u={u} {'cols' if col else 'rows'}"))
    k = plan["sgd_top"]
    buf, xb, yb, active = sgd_case(gen, k, steps, batch, plan["dim"], 10,
                                   dev, spec.n_params)
    a, b = shd.for_rows(ids(k))
    args = (buf[a:b], xb[a:b], yb[a:b], active[a:b], spec, lr, False)
    out["sgd_time"] = {
        "k": k, "seg": [a, b], "rank": shd.rank,
        "shard_ms": rank_serial(lambda: device_ms(
            lambda: FSGD.fused_sgd_sharded(*args), reps=reps)
            if b > a else None),
        "shard_bound": LC.sgd_cost(spec, active[a:b], b - a, steps,
                                   batch, False).bound() if b > a else None,
        **rank_serial(lambda: {
            "unsharded_ms": device_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, lr, False), reps=reps),
            "plain_ms": device_ms(lambda: FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, spec, lr, False), reps=reps)}
            if shd.rank == 0 else {})}

    lmt = plan.get("lm_twin")
    if lmt is not None:        # the LM fleet's (8, P) buffer, drawn on dev
        del X, block
        lshd = FleetSharding.create(shd.n_shards, lmt["n"], plan["device"])
        dgen = (torch.Generator(device=dev) if dev.type == "cuda"
                else torch.Generator()).manual_seed(99)
        Xl = torch.randn((lmt["n"], lmt["P"]), generator=dgen, device=dev)
        lblock = lshd.put_rows_padded(Xl)
        rid = np.asarray(lmt["row_ids"])
        Wl = torch.rand((len(rid), lmt["n"]), generator=gen)
        Wl = (Wl / Wl.sum(1, keepdim=True)).to(dev)
        out["lm_time"] = mesh_twin_rows(
            lshd, Wl, Xl, lblock, lshd.for_rows(rid), None, lmt["reps"],
            f"lm k={len(rid)} P={lmt['P']} rows")
        del Xl, lblock
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def mesh_sim(plan: dict) -> dict:
    """Phase 20 on this rank: its share of ``run_simulation`` with
    ``mesh_shards`` = the group's size, counters zeroed just before and
    read just after; the final block must be finite."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import worker as WK
    from repro_torch.dfl.simulator import run_simulation
    cfg = dataclasses.replace(plan["sim_cfg"],
                              mesh_shards=dist.get_world_size())
    dev = torch.device(plan["device"])
    last = []
    orig = WK.mega_round_step

    def rec_mega(buf, *a, **kw):
        last[:] = [buf]
        return orig(buf, *a, **kw)

    WK.mega_round_step = rec_mega
    zero_counters()
    sync(dev)
    t0 = time.perf_counter()
    try:
        hist = run_simulation(DySTop(V=10.0, t_thre=20), cfg,
                              device=plan["device"])
    finally:
        WK.mega_round_step = orig
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters()
    return {"rank": dist.get_rank(), "wall_s": wall, "launches": launches,
            "block_finite": bool(torch.isfinite(last[0]).all()),
            "block_rows": last[0].shape[0],
            "history": {**hist.to_dict(), "mesh_backend": hist.mesh_backend}}


def mesh_lm(plan: dict) -> dict:
    """Phase 21 on this rank: its share of the LM fleet run with
    ``mesh_shards=2``; counters zeroed just before and read just after,
    each all-reduce timed, rank 0's assembled fleet checked finite."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.sharding.rules import FleetSharding
    cfg, run = plan["lm"]
    run = dataclasses.replace(run, mesh_shards=dist.get_world_size())
    dev = torch.device(plan["device"])
    times, sizes = [], []
    orig = FleetSharding.psum

    def timed_psum(self, x):
        sync(self.device)
        t0 = time.perf_counter()
        out = orig(self, x)
        sync(self.device)
        times.append(time.perf_counter() - t0)
        sizes.append(x.numel() * x.element_size())
        return out

    FleetSharding.psum = timed_psum
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counters()
    sync(dev)
    t0 = time.perf_counter()
    try:
        fleet, hist = LW.run_lm_federation(
            DySTop(V=3.0, t_thre=10, max_neighbors=3), cfg, run,
            device=plan["device"])
    finally:
        FleetSharding.psum = orig
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters()
    out = {"rank": dist.get_rank(), "wall_s": wall, "launches": launches,
           "allreduce_s": sum(times), "allreduce_calls": len(times),
           "allreduce_bytes": sum(sizes),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None),
           "history": {**hist.to_dict(), "mesh_backend": hist.mesh_backend}}
    if fleet is not None:
        out["fleet_shape"] = [list(fleet.pbuf.shape), list(fleet.obuf.shape)]
        out["fleet_finite"] = all_finite(fleet.pbuf) and all_finite(
            fleet.obuf)
    del fleet
    return out


def mesh_rank(plan: dict) -> list:
    """One rank of phases 19-21; every rank's results, gathered."""
    import torch.distributed as dist
    out = {"twins": mesh_twins(plan), "sim": mesh_sim(plan)}
    if plan.get("lm") is not None:
        out["lm"] = mesh_lm(plan)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def mesh_checks(n_sh: int, ranks: list, spawn_wall: float, hist, lm5_hist,
                lm5_wall: float, lm_workers: int, lm_p: int) -> dict:
    """Phases 19-21's checks on the ranks' results (phase 19's ran inside
    the ranks): the sim mesh against phase 3's run ``hist``, the LM mesh
    against the unsharded 5-round run; returns the ``{"mesh"}`` entry."""
    import numpy as np
    sim_ctrl = ("rounds", "sim_time", "comm_gb", "round_active",
                "round_durations", "staleness_avg", "staleness_max")
    # 19: every twin held against its plain version inside each rank
    tw = [r["twins"] for r in ranks]
    check(all(t["backend"] == "gloo" for t in tw),
          f"mesh S={n_sh}: backends {[t['backend'] for t in tw]}")
    print(f"phase 19, S={n_sh}: twins match their plain versions on "
          f"every rank, max |err| "
          f"{[t['max_abs_err'] for t in tw]}", flush=True)
    # 20: the sim mesh against phase 3's unsharded run
    sims = [r["sim"] for r in ranks]
    for r in sims:
        check(r["launches"]["aggregate"] > 0
              and r["launches"]["fused_sgd"] > 0,
              f"sim mesh S={n_sh} rank {r['rank']}: a kernel never "
              f"launched: {r['launches']}")
        check(r["block_finite"], f"sim mesh S={n_sh} rank {r['rank']}: "
              f"the final block is not finite")
    mh = sims[0]["history"]
    check(mh["mesh_backend"] == "gloo",
          f"sim mesh S={n_sh}: backend {mh['mesh_backend']}")
    for f in sim_ctrl:
        check(mh[f] == getattr(hist, f),
              f"sim mesh S={n_sh}: {f} differs from phase 3's run")
    acc_gap_m = float(np.max(np.abs(np.asarray(mh["acc_global"])
                                    - np.asarray(hist.acc_global))))
    check(acc_gap_m <= MESH_ACC_TOL,
          f"sim mesh S={n_sh}: acc_global differs by {acc_gap_m}")
    print(f"phase 20, S={n_sh}: control plane identical to phase 3, "
          f"max |acc gap| {acc_gap_m:.2e}, launches "
          f"{[r['launches'] for r in sims]}, rank walls "
          f"{[round(r['wall_s'], 2) for r in sims]} s", flush=True)
    run_out = {"spawn_wall_s": spawn_wall, "twins": tw,
               "sim": {"acc_gap": acc_gap_m, "ranks": [
                   {k_: r[k_] for k_ in ("rank", "wall_s", "launches",
                                         "block_rows")} for r in sims],
                   "history": {k_: mh[k_] for k_ in (
                       "wall_s", "setup_wall_s", "plan_wall_s",
                       "pack_wall_s", "stage_wall_s", "drain_wall_s",
                       "eval_wall_s", "mesh_backend")},
                   "acc_final": mh["acc_global"][-1]}}
    if n_sh == 2:
        # 21: the LM mesh against the unsharded 5-round run
        lms = [r["lm"] for r in ranks]
        for r in lms:
            check(r["launches"]["flash_attention"] > 0
                  and r["launches"]["aggregate"] > 0,
                  f"LM mesh rank {r['rank']}: a kernel never launched: "
                  f"{r['launches']}")
        lh = lms[0]["history"]
        for f in sim_ctrl:
            check(lh[f] == getattr(lm5_hist, f),
                  f"LM mesh: {f} differs from the unsharded run")
        lg, lg1 = (np.asarray(lh["loss_global"]),
                   np.asarray(lm5_hist.loss_global))
        check(lg.shape == lg1.shape and np.isfinite(lg).all()
              and np.allclose(lg, lg1, rtol=MESH_LOSS_RTOL, atol=0),
              f"LM mesh loss_global {lg.tolist()} vs {lg1.tolist()}")
        check(lms[0]["fleet_finite"], "LM mesh: the fleet is not finite")
        check(lms[0]["fleet_shape"][0] == [lm_workers,
                                           lm_p],
              f"LM mesh fleet shape {lms[0]['fleet_shape']}")
        rounds_m = lh["rounds"][-1]
        print(f"phase 21: LM mesh {rounds_m} rounds, walls "
              f"{[round(r['wall_s'], 2) for r in lms]} s (unsharded "
              f"{lm5_wall:.2f} s), all-reduce "
              f"{lms[0]['allreduce_s'] / rounds_m:.3f} s per round, "
              f"peaks {[r['peak_bytes'] for r in lms]} B, loss "
              f"{lg.tolist()} vs {lg1.tolist()}", flush=True)
        run_out["lm"] = {
            "loss_global": lg.tolist(),
            "unsharded_loss_global": lg1.tolist(),
            "max_loss_rel_gap": float(np.max(np.abs(lg - lg1)
                                             / np.abs(lg1))),
            "unsharded_wall_s": lm5_wall,
            "unsharded_history": {k_: getattr(lm5_hist, k_) for k_ in (
                "wall_s", "setup_wall_s", "drain_wall_s",
                "eval_wall_s")},
            "ranks": [{k_: r[k_] for k_ in (
                "rank", "wall_s", "launches", "allreduce_s",
                "allreduce_calls", "allreduce_bytes", "peak_bytes")}
                for r in lms],
            "allreduce_s_per_round": lms[0]["allreduce_s"] / rounds_m,
            "history": {k_: lh[k_] for k_ in (
                "wall_s", "setup_wall_s", "plan_wall_s", "pack_wall_s",
                "stage_wall_s", "drain_wall_s", "eval_wall_s")}}
    return run_out


def mesh_kernel_rows(mesh_runs: dict, sgd_floor: dict) -> list:
    """Row 3 of the kernel table (the three twins) for the ``{"kernels"}``
    line, from phase 19's timings and phases 20-21's launch counts (and
    phase 4's floor of the fused_sgd timing)."""
    def twin_launches(name):
        return sum(r["launches"][name] for run_out in mesh_runs.values()
                   for part in ("sim", "lm") if part in run_out
                   for r in run_out[part]["ranks"])

    def twin_entry(name, replaces, src, rows, err, extra):
        """Row 3 of the kernel table from phase 19's S=2 timings: the
        per-shard launch of the first rank with rows (``ms``, beside that
        launch's bound), the whole-buffer plain version and library call
        (rank 0), every rank's all-reduce and twin times."""
        shard = next(r for r in rows if r.get("shard_ms") is not None)
        bnd = shard.get("shard_bound")
        b_ms, b_by = bnd if bnd is not None else (shard["shard_bound_ms"],
                                                  shard["shard_bound_by"])
        return {"name": name, "route": "cuda", "source": src,
                "wrapper": extra.pop("wrapper"), "replaces": replaces,
                "launches": twin_launches(name), "max_abs_err": err,
                "ms": shard["shard_ms"], "plain_ms": rows[0]["plain_ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": rows[0].get("library_ms"),
                "unsharded_ms": rows[0]["unsharded_ms"],
                "timed_rank": shard["rank"], "per_rank": rows, **extra}

    tw2 = mesh_runs[2]["twins"]
    errs_all = [t["max_abs_err"] for run_out in mesh_runs.values()
                for t in run_out["twins"]]
    lm_twin_rows = [t["lm_time"] for t in tw2]
    return [
        twin_entry("aggregate_rows_sharded",
                   "src/repro/kernels/aggregate.py:140",
                   "src/repro_torch/kernels/csrc/aggregate.cu",
                   [t["times"][1] for t in tw2],
                   max([e["rows"] for e in errs_all]
                       + [r["max_abs_err"] for r in lm_twin_rows]),
                   {"wrapper": "src/repro_torch/kernels/aggregate.py",
                    "shards": 2, "shape": tw2[0]["times"][1]["shape"],
                    "lm": lm_twin_rows,
                    "s4": [t["times"][1] for t in mesh_runs[4]["twins"]]}),
        twin_entry("aggregate_rows_cols_sharded",
                   "src/repro/kernels/aggregate.py:170",
                   "src/repro_torch/kernels/csrc/aggregate.cu",
                   [t["times"][0] for t in tw2],
                   max(e["cols"] for e in errs_all),
                   {"wrapper": "src/repro_torch/kernels/aggregate.py",
                    "shards": 2, "shape": tw2[0]["times"][0]["shape"],
                    "s4": [t["times"][0] for t in mesh_runs[4]["twins"]]}),
        twin_entry("fused_sgd_sharded",
                   "src/repro/kernels/fused_sgd.py:135",
                   "src/repro_torch/kernels/csrc/fused_sgd.cu",
                   [t["sgd_time"] for t in tw2],
                   max(e["sgd_vs_plain"] for e in errs_all),
                   {"wrapper": "src/repro_torch/kernels/fused_sgd.py",
                    "shards": 2, "shape": {"k": tw2[0]["sgd_time"]["k"],
                                           "with_losses": False},
                    "library_ms": None, "bit_identical_to_kernel": True,
                    "floor": sgd_floor,
                    "s4": [t["sgd_time"] for t in mesh_runs[4]["twins"]]}),
    ]


# ---- phases 22-25: the Table-I arena, the bound, snapshots and resume -----

# the arena's headline cell: benchmarks/arena.py::main's non-IID clean cell
# with benchmarks/common.py::run_mech's settings, copied here (benchmarks/
# imports the JAX package); nothing is cut
ARENA_CFG = dict(n_workers=24, n_rounds=6000, phi=0.4, tau_bound=5, V=10.0,
                 lr=0.1, eval_every=max(6000 // 8, 5), seed=0,
                 target_accuracy=0.55, max_sim_time=4000.0)
ARENA_MECHS = {"dystop": {"V": 10.0, "t_thre": 50, "max_neighbors": 7},
               "matcha": {}, "gossipfl": {}, "asydfl": {"n_neighbors": 7},
               "sa-adfl": {"V": 10.0}}
ARENA_ADFL = ("asydfl", "sa-adfl")     # the headline's ADFL state of the art
# the JAX package's CPU run of the same cell (BENCH_arena.json,
# arena/*/phi0.4/clean): simulated seconds and GB at 0.55, reference values
# printed beside the port's, never as the port's
ARENA_JAX_CPU = {"dystop": (669.4, 4.2), "matcha": (1686.1, 3.8),
                 "gossipfl": (1333.8, 0.9), "asydfl": (1666.8, 2.9),
                 "sa-adfl": (1338.6, 2.2), "time_saved_pct": 50.0,
                 "comm_saved_pct": -93.6}
ARENA_CARD_CPU_TOL = 1e-3          # acc_global, card vs CPU, every eval
SIM_CONTROL = ("rounds", "sim_time", "comm_gb", "round_active",
               "round_durations", "staleness_avg", "staleness_max")
SIM_CURVES = ("acc_global", "acc_local", "loss_global")
RESUME_RTOL, RESUME_ATOL = 1e-6, 1e-7   # tests/test_pipeline.py's resume gate
BOUND_KW = dict(f0_gap=2.0, eta=0.01, mu=0.5, L=1.0)   # Theorem 1 inputs
SIGKILL_CKPT = dict(checkpoint_every=50, scenario="churn20")
LM_CKPT_RTOL = 1e-3                # loss_global, LM resume vs uninterrupted


def sgd_recorder(counter, sgd):
    """A wrapper around ``fused_sgd`` that counts each call's shape."""
    def rec_sgd(buf, xb, yb, active, spec, lr, with_losses=True):
        counter[("fused_sgd", buf.shape[0], bool(with_losses))] += 1
        return sgd(buf, xb, yb, active, spec, lr, with_losses)

    return rec_sgd


def pct_saved(dystop_v, base_v):
    """DySTop's reduction against a baseline in % (``benchmarks/arena.py``'s
    rule); None if either never reached the target."""
    if dystop_v is None or base_v is None or base_v <= 0:
        return None
    return 100.0 * (1.0 - dystop_v / base_v)


def arena_phase() -> tuple:
    """Phase 22: the five Table-I mechanisms on the arena's headline cell,
    each on the card with the counters zeroed (``aggregate`` and
    ``fused_sgd`` must launch), on the CPU at one intra-op thread (control
    plane identical, ``acc_global`` within ``ARENA_CARD_CPU_TOL`` at every
    eval) and once more on the card under a device-only profiler (busy
    share over the first card run's wall).  Returns the report and each mechanism's kernel shapes."""
    import numpy as np
    import torch
    from repro_torch.core.baselines import get_mechanism
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import fused_sgd as FSGD
    cfg = SimConfig(**ARENA_CFG)
    orig_agg, orig_sgd = AGG.aggregate, FSGD.fused_sgd
    report, shapes_by_mech = {}, {}
    for name, kw in ARENA_MECHS.items():
        shapes: Counter = Counter()
        AGG.aggregate, _ = recorder(shapes, orig_agg)
        FSGD.fused_sgd = sgd_recorder(shapes, orig_sgd)
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            card = run_simulation(get_mechanism(name, **kw), cfg)
        finally:
            AGG.aggregate, FSGD.fused_sgd = orig_agg, orig_sgd
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"aggregate": AGG.launches, "fused_sgd": FSGD.launches}
        check(launches["aggregate"] > 0 and launches["fused_sgd"] > 0,
              f"arena {name}: a kernel never launched: {launches}")
        acc = np.asarray(card.acc_global)
        check(np.isfinite(acc).all() and np.isfinite(card.loss_global).all(),
              f"arena {name}: non-finite accuracy or loss")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)       # faster for the cell's small ops
        try:
            cpu = run_simulation(get_mechanism(name, **kw), cfg,
                                 device="cpu")
        finally:
            torch.set_num_threads(threads)
        for f in SIM_CONTROL:
            check(getattr(card, f) == getattr(cpu, f),
                  f"arena {name}: card and CPU differ in {f}")
        gap = float(np.max(np.abs(acc - np.asarray(cpu.acc_global))))
        check(gap <= ARENA_CARD_CPU_TOL,
              f"arena {name}: card and CPU accuracy differ by {gap}")
        busy_s, top, _ = device_profile(
            lambda: run_simulation(get_mechanism(name, **kw), cfg),
            host=False)
        report[name] = {
            "rounds": len(card.round_durations),
            "sim_time_s": card.sim_time[-1], "comm_gb": card.comm_gb[-1],
            "t_at_target_s": card.completion_time,
            "comm_gb_at_target": card.completion_comm_gb,
            "cpu_t_at_target_s": cpu.completion_time,
            "acc_final": float(acc[-1]), "card_vs_cpu_acc_gap": gap,
            "wall_s": wall, "setup_wall_s": card.setup_wall_s,
            "plan_wall_s": card.plan_wall_s, "eval_wall_s": card.eval_wall_s,
            "device_busy_s": busy_s,
            "device_busy_share": None if busy_s is None else busy_s / wall,
            "device_top_kernels": top, "launches": launches,
            "jax_cpu_reference": {"t_at_target_s": ARENA_JAX_CPU[name][0],
                                  "comm_gb_at_target":
                                      ARENA_JAX_CPU[name][1]}}
        shapes_by_mech[name] = shapes
        print(f"arena {name}: {report[name]['rounds']} rounds, t@0.55 "
              f"{card.completion_time} s, comm@0.55 {card.completion_comm_gb}"
              f" GB, acc {acc[-1]:.4f}, wall {wall:.2f} s, launches "
              f"{launches}, card vs CPU control identical, acc gap "
              f"{gap:.2e}", flush=True)
    dy = report["dystop"]
    best_t = min((report[b]["t_at_target_s"] for b in ARENA_ADFL
                  if report[b]["t_at_target_s"] is not None), default=None)
    best_c = min((report[b]["comm_gb_at_target"] for b in ARENA_ADFL
                  if report[b]["comm_gb_at_target"] is not None),
                 default=None)
    headline = {
        "cell": "phi0.4/clean", "target": ARENA_CFG["target_accuracy"],
        "versus": "best ADFL baseline (asydfl, sa-adfl)",
        "time_saved_pct": pct_saved(dy["t_at_target_s"], best_t),
        "comm_saved_pct": pct_saved(dy["comm_gb_at_target"], best_c),
        "jax_cpu_reference": {
            "time_saved_pct": ARENA_JAX_CPU["time_saved_pct"],
            "comm_saved_pct": ARENA_JAX_CPU["comm_saved_pct"],
            "source": "BENCH_arena.json (the JAX package on a CPU), not the "
                      "port's"},
        "paper": {"time_saved_pct": 51.8, "comm_saved_pct": 57.1}}
    print(f"arena headline: DySTop saves {headline['time_saved_pct']} % "
          f"time and {headline['comm_saved_pct']} % comm against the best "
          f"ADFL baseline (the JAX package's CPU run: 50.0 % / -93.6 %)",
          flush=True)
    return {"mechanisms": report, "headline": headline}, shapes_by_mech


def arena_kernel_rows(shapes_by_mech: dict, gen, spec, dev) -> tuple:
    """The kernels at the arena cell's shapes (each mechanism's two
    commonest ``aggregate`` shapes and its commonest ``fused_sgd`` shape,
    each shape once): held against the plain version, then timed beside it,
    the library call and the bound, as phase 4 times the sim cell's."""
    from repro_torch.launch import loopcost as LC
    import torch
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import fused_sgd as FSGD
    n, p = ARENA_CFG["n_workers"], spec.n_params
    steps, batch, lr = 2, 32, ARENA_CFG["lr"]
    X = torch.randn((n, p), generator=gen).to(dev)
    agg_rows, sgd_rows, seen = [], [], set()
    for name, shapes in shapes_by_mech.items():
        aggs = sorted(((s, c) for s, c in shapes.items()
                       if s[0] == "aggregate"), key=lambda sc: -sc[1])
        sgds = sorted(((s, c) for s, c in shapes.items()
                       if s[0] == "fused_sgd"), key=lambda sc: -sc[1])
        for (_, k, u, col), count in aggs[:2]:
            if ("aggregate", k, u, col) in seen:
                continue
            seen.add(("aggregate", k, u, col))
            W, cid = agg_case(gen, k, u, n, col, dev)
            got, want = AGG.aggregate(W, X, cid), AGG.aggregate_plain(W, X,
                                                                      cid)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            lib_cid = None if cid is None else cid.long()
            b_ms, b_by = LC.agg_cost(
                W.cpu(), None if cid is None else cid.cpu(), p, n).bound()
            agg_rows.append({
                "label": f"arena {name}", "N": n, "k": k, "u": u,
                "col_sparse": col, "launches": count, "max_abs_err": err,
                "ms": device_ms(lambda: AGG.aggregate(W, X, cid)),
                "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, X,
                                                                  cid)),
                "library_ms": device_ms(
                    (lambda: torch.matmul(W, X)) if cid is None else
                    (lambda: torch.matmul(W, X.index_select(0, lib_cid)))),
                "bound_ms": b_ms, "bound_by": b_by})
        for (_, k, with_losses), count in sgds[:1]:
            if ("fused_sgd", k, with_losses) in seen:
                continue
            seen.add(("fused_sgd", k, with_losses))
            buf, xb, yb, active = sgd_case(gen, k, steps, batch, 32, 10, dev,
                                           p)
            out, loss = FSGD.fused_sgd(buf, xb, yb, active, spec, lr,
                                       with_losses)
            ref, ref_loss = FSGD.local_sgd_flat_fused(buf, xb, yb, active,
                                                      spec, lr, with_losses)
            torch.cuda.synchronize()
            err = max(float((out - ref).abs().max()),
                      float((loss - ref_loss).abs().max()))
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
            b_ms, b_by = LC.sgd_cost(spec, active, k, steps, batch,
                                    with_losses).bound()
            sgd_rows.append({
                "label": f"arena {name}", "k": k, "with_losses": with_losses,
                "launches": count, "max_abs_err": err,
                "ms": device_ms(lambda: FSGD.fused_sgd(
                    buf, xb, yb, active, spec, lr, with_losses)),
                "plain_ms": device_ms(lambda: FSGD.local_sgd_flat_fused(
                    buf, xb, yb, active, spec, lr, with_losses)),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    for kernel, rows in (("aggregate", agg_rows), ("fused_sgd", sgd_rows)):
        for r in rows:
            print(f"{kernel} at the {r['label']} shape: {r}", flush=True)
    return agg_rows, sgd_rows


def bound_phase() -> dict:
    """Phase 23: DySTop and AsyDFL on the arena cell for 100 rounds with a
    bound log, on the card and on the CPU: Theorem 1's bound over the two
    logs must be equal to the last bit (the log is control plane only)."""
    import numpy as np
    from repro_torch.core import convergence as CV
    from repro_torch.core.baselines import get_mechanism
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    cfg = SimConfig(**dict(ARENA_CFG, n_rounds=100))
    n = cfg.n_workers
    args = dict(alpha=np.full(n, 1.0 / n), xi=np.full(n, 0.5),
                g_star=np.ones(n), **BOUND_KW)
    out = {}
    for name in ("dystop", "asydfl"):
        bounds = []
        for device in ("cuda", "cpu"):
            h = run_simulation(get_mechanism(name, **ARENA_MECHS[name]), cfg,
                               record_history_for_bound=True, device=device)
            log = h.bound_log
            check(len(log["active"]) == 100, f"bound log of {name} has "
                  f"{len(log['active'])} rounds")
            bounds.append(CV.convergence_bound(log["active"], log["W"],
                                               **args))
        check(bounds[0] == bounds[1] and np.isfinite(bounds[0])
              and bounds[0] > 0,
              f"convergence bound of {name}: card {bounds[0]!r}, CPU "
              f"{bounds[1]!r}")
        out[name] = {"rounds": 100, "bound": bounds[0]}
        print(f"bound over 100 rounds, {name}: {bounds[0]!r} on the card "
              f"and the CPU alike", flush=True)
    out["inputs"] = {"alpha": "uniform", "xi": 0.5, "g_star": 1.0,
                     **BOUND_KW}
    return out


def sim_child(ckdir: str) -> int:
    """The checkpointing run that phase 24 kills: ``SimConfig()`` defaults
    with the churn20 scenario, a snapshot every 50 rounds, on the card."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    run_simulation(DySTop(V=10.0, t_thre=20),
                   SimConfig(checkpoint_dir=ckdir, **SIGKILL_CKPT))
    return 0


def sigkill_phase(root: pathlib.Path) -> dict:
    """Phase 24: a child process runs ``sim_child``; once its second
    snapshot exists it gets SIGKILL.  The run resumed on the card from the
    oldest snapshot left must equal an uninterrupted checkpointing run on
    the card: control plane exactly, the curves within rtol 1e-6 / atol
    1e-7."""
    import shutil
    import signal
    import numpy as np
    import torch
    from repro_torch.checkpoint import io as CIO
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    shutil.rmtree(root, ignore_errors=True)
    killed, whole = root / "killed", root / "whole"
    second = CIO.checkpoint_path(killed, 2 * SIGKILL_CKPT["checkpoint_every"])
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable,
                              str(pathlib.Path(__file__).resolve()),
                              "--sim-child", str(killed)])
    try:
        deadline = time.monotonic() + 600
        while not second.exists():
            check(child.poll() is None, f"the checkpointing child exited "
                  f"({child.returncode}) before its second snapshot")
            check(time.monotonic() < deadline, "the checkpointing child "
                  "wrote no second snapshot in 600 s")
            time.sleep(0.001)
        child.send_signal(signal.SIGKILL)
        rc = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    kill_wall = time.perf_counter() - t0
    kept = CIO.list_checkpoints(killed)
    n_rounds = SimConfig().n_rounds
    check(rc == -signal.SIGKILL, f"the child was not killed (exit {rc})")
    check(bool(kept) and kept[-1] != CIO.checkpoint_path(killed, n_rounds),
          f"the killed run finished before the kill: {kept}")
    mech = lambda: DySTop(V=10.0, t_thre=20)        # noqa: E731
    zero_counters()
    t0 = time.perf_counter()
    res = run_simulation(mech(), SimConfig(checkpoint_dir=str(killed),
                                           **SIGKILL_CKPT),
                         resume_from=str(kept[0]))
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    launches = read_counters()
    check(launches["aggregate"] > 0 and launches["fused_sgd"] > 0,
          f"the resumed run launched no kernel: {launches}")
    ref = run_simulation(mech(), SimConfig(checkpoint_dir=str(whole),
                                           **SIGKILL_CKPT))
    for f in SIM_CONTROL:
        check(getattr(res, f) == getattr(ref, f),
              f"resume after SIGKILL: {f} differs from the uninterrupted run")
    gaps = {}
    for f in SIM_CURVES:
        a, b = np.asarray(getattr(res, f)), np.asarray(getattr(ref, f))
        check(np.allclose(a, b, rtol=RESUME_RTOL, atol=RESUME_ATOL),
              f"resume after SIGKILL: {f} off the uninterrupted run by "
              f"{np.abs(a - b).max()}")
        gaps[f] = float(np.abs(a - b).max())
    bit_equal = all(getattr(res, f) == getattr(ref, f) for f in SIM_CURVES)
    out = {"config": "SimConfig() defaults, scenario churn20, "
                     "checkpoint_every=50, DySTop(V=10.0, t_thre=20)",
           "child_exit": rc, "snapshots_left": [p.name for p in kept],
           "resumed_from": kept[0].name, "kill_wall_s": kill_wall,
           "resume_wall_s": resume_wall, "launches": launches,
           "max_curve_gaps": gaps, "curves_bit_equal": bit_equal}
    shutil.rmtree(root, ignore_errors=True)
    print(f"SIGKILL resume: child killed after {kept[-1].name}, resumed "
          f"from {kept[0].name}: control plane identical, curves "
          f"{'bit-equal' if bit_equal else gaps}", flush=True)
    return out


def lm_snapshot_phase(root: pathlib.Path) -> dict:
    """Phase 25: smollm-135m at full width, 2 workers, 6 rounds, a snapshot
    every 3 rounds; resume from round 3 (control plane exactly,
    ``loss_global`` within rtol ``LM_CKPT_RTOL``); serve 8 greedy requests
    from the round-6 snapshot through ``serving.bridge`` for worker 0 and
    for the Eq. 11 global model, the served parameters the snapshot's row
    bit for bit.  The snapshots are deleted afterwards."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import io as CIO
    from repro_torch.configs import smollm_135m
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import flat_state as FS
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.serving import bridge as BR
    from repro_torch.tree import tree_paths
    cfg = smollm_135m.get_config()
    spec = BR.fleet_spec_for(cfg)
    p = spec.n_params
    snap_bytes = 2 * 3 * p * 4          # pbuf and Adam's two moments, f32
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    need = 3 * snap_bytes + (1 << 30)   # two snapshots and one being written
    check(free >= need, f"phase 25 needs {need / 1e9:.1f} GB of free disk "
          f"under {root}, found {free / 1e9:.1f} GB")
    run = LW.LMRunConfig(n_workers=2, n_rounds=6, batch=4, seq=256,
                         optimizer="adam", lr=1e-3, eval_every=5,
                         checkpoint_every=3, checkpoint_dir=str(root))
    mech = lambda: DySTop(V=3.0, t_thre=10, max_neighbors=3)   # noqa: E731
    try:
        t0 = time.perf_counter()
        _, whole = LW.run_lm_federation(mech(), cfg, run)
        torch.cuda.synchronize()
        whole_wall = time.perf_counter() - t0
        snaps = CIO.list_checkpoints(root)
        check([s.name for s in snaps] == ["ckpt_round000003.npz",
                                          "ckpt_round000006.npz"],
              f"LM snapshots: {[s.name for s in snaps]}")
        sizes = [s.stat().st_size for s in snaps]
        torch.cuda.empty_cache()
        zero_counters()
        t0 = time.perf_counter()
        _, res = LW.run_lm_federation(mech(), cfg, run, str(snaps[0]))
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        launches = read_counters()
        check(launches["flash_attention"] > 0 and launches["aggregate"] > 0,
              f"the resumed LM run launched no kernel: {launches}")
        for f in ("rounds", "sim_time", "comm_gb", "round_active",
                  "round_durations", "staleness_avg", "staleness_max"):
            check(getattr(res, f) == getattr(whole, f),
                  f"LM resume: {f} differs from the uninterrupted run")
        lg_a, lg_b = np.asarray(res.loss_global), np.asarray(whole.loss_global)
        check(np.isfinite(lg_a).all()
              and np.allclose(lg_a, lg_b, rtol=LM_CKPT_RTOL, atol=0),
              f"LM resume: loss_global {lg_a.tolist()} vs {lg_b.tolist()}")
        torch.cuda.empty_cache()
        # serve from the round-6 snapshot (the resumed run's)
        ck = CIO.checkpoint_path(root, 6)
        blobs, _ = CIO.read_checkpoint(ck, ("params|pbuf",))
        row0 = torch.from_numpy(blobs.pop("params|pbuf")[0].copy()).cuda()
        served = BR.serving_params_from_checkpoint(ck, cfg, worker=0)
        want = FS.unravel_tree(row0, spec, copy=True)
        for (pa, a), (pb, b) in zip(tree_paths(served), tree_paths(want)):
            check(pa == pb and a.dtype == b.dtype and torch.equal(a, b),
                  f"served leaf {pa} differs from the snapshot's row")
        again = torch.empty_like(row0)
        FS.ravel_tree_into(served, spec, again)
        check(torch.equal(again.view(torch.int32), row0.view(torch.int32)),
              "the snapshot's f32 row does not hold its bf16 leaves exactly")
        del served, want, again, row0
        reqs = serve_requests(cfg, 8, 31)
        served_tokens = {}
        t0 = time.perf_counter()
        for label, worker in (("worker 0", 0), ("global", None)):
            eng = BR.engine_from_checkpoint(ck, cfg, worker=worker,
                                            batch_slots=8, max_len=512)
            rids = [eng.submit(r.prompt, r.gen) for r in reqs]
            out = eng.run()
            check(all(len(out[i]) == r.gen.max_new_tokens
                      for i, r in zip(rids, reqs)),
                  f"serving from the snapshot ({label}): a request did not "
                  f"complete")
            served_tokens[label] = sum(len(out[i]) for i in rids)
            del eng
            torch.cuda.empty_cache()
        serve_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"config": "smollm-135m get_config() (30 layers), LMRunConfig("
                     "n_workers=2, n_rounds=6, batch=4, seq=256, adam, "
                     "lr=1e-3, eval_every=5, checkpoint_every=3), "
                     "DySTop(V=3.0, t_thre=10, max_neighbors=3)",
           "P": p, "snapshot_bytes": sizes, "whole_wall_s": whole_wall,
           "resume_wall_s": resume_wall, "launches": launches,
           "loss_global": lg_a.tolist(),
           "loss_bit_equal": bool(np.array_equal(lg_a, lg_b)),
           "served_tokens": served_tokens, "serve_wall_s": serve_wall,
           "disk_free_bytes": free}
    print(f"LM snapshot: resumed from round 3 on the uninterrupted control "
          f"plane, loss_global {lg_a.tolist()}; served 8 requests from the "
          f"round-6 snapshot for worker 0 and the global model "
          f"({served_tokens}); snapshots {sizes} bytes, deleted", flush=True)
    return out


# ---- phases 26-29: the hybrid family and training the moe family ----------

# phase 26's cell: recurrentgemma-2b at full width, cut to one period of 3
# layers (of 26) and 4 workers (of the LM cells' 8): a 43.8 GB fleet
HYBRID_RUN = dict(n_workers=4, n_rounds=20, batch=1, seq=4096,
                  optimizer="adam", lr=1e-3, eval_every=5)
# grok's routing at batch 4 x seq 256, kimi's at 4096 tokens, and the moe
# smoke fleet's own (E = 4: the kernel's 8-lane segment half empty)
ROUTER_TRAIN_SHAPES = ((1024, 8, 2), (4096, 384, 8), (128, 4, 2))
SERVE_PROF_FROM, SERVE_PROF_TICKS = 40, 30   # phase 28's profiled ticks
SCAN_CHUNKS = (2, 4, 8, 16, 64)    # phase 26 times the RG-LRU scan at each


def hybrid_fleet_phase(gen, dev, mech) -> tuple:
    """Phase 26: the hybrid LM fleet at full width, 3 of 26 layers, through
    flash_attention (window 2048, MQA, D = 256) and aggregate; then each
    kernel at the path's shape against its plain version, timed beside it,
    the library call and the bound; a profiled 5-round copy for the busy
    share.  Returns (the phase's record, the flash row, the aggregate
    row)."""
    import numpy as np
    import torch
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    cfg = dataclasses.replace(recurrentgemma_2b.get_config(), n_layers=3)
    run = LW.LMRunConfig(**HYBRID_RUN)
    shapes: Counter = Counter()
    views = set()
    orig_agg, orig_fa = AGG.aggregate, FA.flash_attention
    rec_agg, rec_fa = recorder(shapes, orig_agg, orig_fa)

    def rec_views(q, k, v, causal=True, window=None, softcap=None,
                  q_offset=0):
        # the model's own q/k/v views reach the kernel (no aligning copy)
        views.add(tuple((tuple(t.stride()), t.data_ptr() % 16)
                        for t in (q, k, v)))
        return rec_fa(q, k, v, causal, window, softcap, q_offset)

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 4e9, f"phase 26 needs the card to itself, but earlier "
          f"phases still hold {held / 1e9:.1f} GB")
    AGG.aggregate, FA.flash_attention = rec_agg, rec_views
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fleet, hist = LW.run_lm_federation(mech(), cfg, run)
    finally:
        AGG.aggregate, FA.flash_attention = orig_agg, orig_fa
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    check(launches["flash_attention"] > 0 and launches["aggregate"] > 0,
          f"a kernel of the hybrid path never launched: {launches}")
    check(all(launches[k] == 0 for k in ("ssd_chunk", "moe_router",
                                         "fused_sgd")),
          f"a kernel off the hybrid path launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(hist.loss_global)
    check(loss.shape == (run.n_rounds // run.eval_every,)
          and np.isfinite(loss).all()
          and np.isfinite(hist.round_loss).all(),
          f"hybrid evals not finite: {loss.tolist()}")
    check(all_finite(fleet.pbuf) and all_finite(fleet.obuf),
          "hybrid params or optimizer state not finite")
    check(all(off == 0 for vw in views for _, off in vw),
          f"hybrid q/k/v bases not 16-byte aligned: {views}")
    p = fleet.pbuf.shape[1]
    print(f"hybrid path (recurrentgemma-2b, 3 layers, P={p}): "
          f"{hist.rounds[-1]} rounds in {wall:.2f} s, launches {launches}, "
          f"loss_global {loss[0]:.4f} -> {loss[-1]:.4f}, peak "
          f"{peak / 1e9:.2f} GB, q/k/v strides {sorted(views)}", flush=True)
    agg_row = lm_aggregate_row(gen, shapes, launches["aggregate"],
                               fleet.pbuf, "hybrid")
    del fleet
    torch.cuda.empty_cache()
    scan_rows = scan_chunk_rows(gen, dev, run.seq, cfg.d_model)
    busy = lm_profile(mech(), cfg, run)
    torch.cuda.empty_cache()
    fa_key, fa_count = max(((s_, c) for s_, c in shapes.items()
                            if s_[0] == "flash_attention"),
                           key=lambda sc: sc[1])
    _, (b, h, s, d), hk, _, _, window, softcap = fa_key
    flash_row = flash_long_row(gen, dev, "hybrid path (recurrentgemma-2b)",
                               b, h, hk, s, d, softcap, window)
    flash_row.update(calls=fa_count, launches=launches["flash_attention"])
    print(f"flash at the hybrid path's shape: {flash_row}", flush=True)
    torch.cuda.empty_cache()
    record = {
        "config": "recurrentgemma-2b get_config() at n_layers=3 (of 26: one "
                  "rglru, rglru, attn_local period), LMRunConfig("
                  + ", ".join(f"{k}={v}" for k, v in HYBRID_RUN.items())
                  + "), DySTop(V=3.0, t_thre=10, max_neighbors=3)",
        "P": p, "rounds": hist.rounds[-1],
        "rows_trained": int(sum(hist.round_active)),
        "memory_held_before_bytes": held,
        "wall_s": wall, "setup_wall_s": hist.setup_wall_s,
        "plan_wall_s": hist.plan_wall_s, "pack_wall_s": hist.pack_wall_s,
        "stage_wall_s": hist.stage_wall_s,
        "drain_wall_s": hist.drain_wall_s, "eval_wall_s": hist.eval_wall_s,
        "launches": launches,
        "flash_shapes": {str(s_[1:]): c for s_, c in shapes.items()
                         if s_[0] == "flash_attention"},
        "flash_view_strides": sorted(views),
        "aggregate_shapes": {str(s_[1:]): c for s_, c in shapes.items()
                             if s_[0] == "aggregate"},
        "loss_global": loss.tolist(),
        "max_memory_allocated_bytes": peak, **busy,
        "flash": flash_row, "aggregate": agg_row, "scan_chunks": scan_rows}
    return record, flash_row, agg_row


def scan_chunk_rows(gen, dev, s: int, d: int) -> list:
    """Time ``rglru.linear_scan``'s forward and its forward plus backward
    at the hybrid path's (1, S, width) f32, with the module's
    ``SCAN_CHUNK`` set to each of ``SCAN_CHUNKS`` in turn, and read the
    peak memory above what was held before: the numbers behind the
    constant's value.  Each chunk's states are held against the first
    chunk's (atol and rtol 1e-5)."""
    import torch
    from repro_torch.models import rglru as RG
    la = (-0.1 * torch.rand((1, s, d), generator=gen)).to(dev)
    b = torch.randn((1, s, d), generator=gen).to(dev)
    w = torch.randn((1, s, d), generator=gen).to(dev)
    la_g, b_g = la.clone().requires_grad_(), b.clone().requires_grad_()
    orig, rows, first = RG.SCAN_CHUNK, [], None

    def fwd_bwd():
        torch.autograd.grad((RG.linear_scan(la_g, b_g) * w).sum(),
                            (la_g, b_g))

    try:
        for q in SCAN_CHUNKS:
            RG.SCAN_CHUNK = q
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            h = RG.linear_scan(la, b)
            if first is None:
                first = h
            check(bool(torch.isfinite(h).all()) and torch.allclose(
                h, first, atol=1e-5, rtol=1e-5),
                f"linear_scan at chunk {q} left chunk {SCAN_CHUNKS[0]}'s "
                f"states")
            rows.append({"chunk": q, "shape": [1, s, d],
                         "fwd_ms": device_ms(lambda: RG.linear_scan(la, b),
                                             5),
                         "fwd_bwd_ms": device_ms(fwd_bwd, 5),
                         "fwd_bwd_peak_bytes": peak})
            print(f"RG-LRU scan at chunk {q}: {rows[-1]}", flush=True)
    finally:
        RG.SCAN_CHUNK = orig
    del first, h
    torch.cuda.empty_cache()
    return rows


def full_serve_phase(cfg, label: str) -> dict:
    """Phases 28 and 30: serve ``cfg`` at full size (nothing cut) as phase
    16 serves grok: every request finishes with its tokens, every tick's
    logits finite, and no kernel launches (decode reads its caches through
    plain attention and, for recurrentgemma, the RG-LRU step, as the JAX
    package does)."""
    import torch
    from repro_torch.models import registry as R
    from repro_torch.serving import (ARRIVAL_PRESETS, ServeEngine, drive,
                                     generate_requests)
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_wall = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    reqs = generate_requests(ARRIVAL_PRESETS["steady"], cfg.vocab_size)
    eng = ServeEngine(cfg, params, batch_slots=8, max_len=512, seed=0,
                      device="cuda")
    finite, step_s = [], []
    step = eng.step

    def timed_step():
        t1 = time.perf_counter()
        events = step()
        finite.append(torch.isfinite(eng.last_logits).all())
        step_s.append(time.perf_counter() - t1)
        return events

    eng.step = timed_step
    zero_counters()
    t0 = time.perf_counter()
    rep = drive(eng, reqs)
    torch.cuda.synchronize()
    drive_wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    check(rep.n_finished == len(reqs) == 24,
          f"{label} served {rep.n_finished} of {len(reqs)} requests")
    for rid, r in enumerate(reqs):
        check(len(rep.outputs[rid]) == r.gen.max_new_tokens,
              f"{label} request {rid}: {len(rep.outputs[rid])} "
              f"tokens of {r.gen.max_new_tokens}")
    check(bool(torch.stack(finite).all()), f"{label} logits not finite")
    check(not any(launches.values()),
          f"a kernel launched on the decode path: {launches}")
    tick_ms = sum(step_s) / eng.t * 1e3
    print(f"{label} serving ({cfg.n_layers} layers, {n_params} params): "
          f"{rep.n_finished} requests, {rep.total_tokens} tokens in "
          f"{rep.makespan_s:.2f} s ({rep.tokens_per_sec:.1f} tok/s), "
          f"{eng.t} ticks at {tick_ms:.2f} ms, init {init_wall:.2f} s, peak "
          f"{peak / 1e9:.2f} GB", flush=True)
    # the profile covers 30 ticks of a second drive, from tick 40 on (the
    # whole drive's ~600k trace events take minutes to read back)
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    e2 = ServeEngine(cfg, params, batch_slots=8, max_len=512, seed=0,
                     device="cuda")
    inner, window = e2.step, []
    edges = (SERVE_PROF_FROM, SERVE_PROF_FROM + SERVE_PROF_TICKS)

    def windowed_step():
        # an idle call does not advance the clock: each edge is taken once
        if len(window) < 2 and e2.t == edges[len(window)]:
            torch.cuda.synchronize()
            window.append(time.perf_counter())
            (prof.start if len(window) == 1 else prof.stop)()
        return inner()

    e2.step = windowed_step
    rep2 = drive(e2, reqs)
    check(len(window) == 2, f"the second drive ran {e2.t} ticks, fewer "
          f"than the profiled window's end")
    check(rep2.outputs == rep.outputs,
          "the profiled drive served other tokens")
    busy, top, extra = profile_rows(prof)
    prof_wall = window[1] - window[0]
    print(f"{label} serving: TTFT p50 {rep.ttft_s['p50']:.3f} s, p99 "
          f"{rep.ttft_s['p99']:.3f} s; profiled ticks {list(edges)}: "
          f"{prof_wall:.2f} s, device busy "
          f"{'not measured' if busy is None else f'{busy / prof_wall:.1%}'}, "
          f"{extra['device_kernels']} device kernels", flush=True)
    out = {"config": f"{cfg.arch_id} get_config() ({cfg.n_layers} layers, "
                     f"nothing cut), ServeEngine(batch_slots=8, max_len=512, "
                     f"seed=0), ARRIVAL_PRESETS['steady'] on the wall clock",
           "params": n_params, "init_wall_s": init_wall,
           "max_memory_allocated_bytes": peak, "drive_wall_s": drive_wall,
           "ticks": eng.t, "ms_per_tick": tick_ms,
           "step_wall_s": sum(step_s), "launches": launches,
           **{k: v for k, v in dataclasses.asdict(rep).items()
              if k not in ("outputs", "finish_order")},
           "profiled_ticks": list(edges),
           "profiled_wall_s": prof_wall, "device_busy_s": busy,
           "device_busy_share": None if busy is None else busy / prof_wall,
           "device_top_kernels": top, **extra}
    # the wrapped steps close over their engines: collect the cycles
    del eng, e2, params, step, inner, timed_step, windowed_step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def keep_inputs(kept, agg, fa, router):
    """Wrappers around the kernels' entry points that keep a copy of the
    inputs of the first call of each shape (the kernels' own launch counters
    stay the only proof of launches)."""
    def first(key, *ts):
        if key not in kept:
            kept[key] = tuple(None if t is None else t.detach().clone()
                              for t in ts)

    def rec_agg(W, X, col_ids=None, **kw):
        first(("aggregate", tuple(W.shape), tuple(X.shape),
               None if col_ids is None else tuple(col_ids.shape)),
              W, X, col_ids)
        return agg(W, X, col_ids, **kw)

    def rec_fa(q, k, v, causal=True, window=None, softcap=None,
               q_offset=0):
        first(("flash_attention", tuple(q.shape), k.shape[1], str(q.dtype),
               causal, window, softcap), q, k, v)
        return fa(q, k, v, causal, window, softcap, q_offset)

    def rec_router(logits, top_k):
        first(("moe_router", tuple(logits.shape), top_k), logits)
        return router(logits, top_k)

    return rec_agg, rec_fa, rec_router


def router_diff_check(gen, x, k: int, label: str) -> tuple:
    """``moe_router_diff`` on the (T, E) logits ``x`` against
    ``moe_router_plain`` under autograd: ids identical and without gradient,
    the gates and the logits' gradient (of random weights on the gates)
    within 1e-6 and finite.  Returns (gate error, gradient error)."""
    import torch
    from repro_torch.kernels import moe_router as MR
    from repro_torch.kernels import ops as K
    x = x.detach().requires_grad_()
    w = torch.randn((x.shape[0], k), generator=gen).to(x.device)
    gates, ids = K.moe_router_diff(x, k)
    (grad,) = torch.autograd.grad((gates * w).sum(), x)
    with torch.enable_grad():
        p_gates, p_ids = MR.moe_router_plain(x, k)
        (p_grad,) = torch.autograd.grad((p_gates * w).sum(), x)
    torch.cuda.synchronize()
    check(torch.equal(ids, p_ids) and not ids.requires_grad,
          f"moe_router_diff {label}: ids differ")
    e1 = float((gates - p_gates).detach().abs().max())
    e2 = float((grad - p_grad).abs().max())
    check(e1 <= 1e-6 and e2 <= 1e-6 and bool(torch.isfinite(grad).all()),
          f"moe_router_diff {label}: gates {e1}, grad {e2}")
    return e1, e2


def moe_path_checks(gen, kept) -> list:
    """Hold each kernel on the inputs the moe fleet's card run gave it (the
    first call of each shape, ``keep_inputs``) against its plain version:
    ``aggregate`` within f32 atol and rtol 1e-5; ``flash_attention`` within
    2 bf16 ulps (f32: 1e-5); ``moe_router_diff`` as ``router_diff_check``,
    on the path's logits and on tie rows of the same (T, E, k)."""
    import torch
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    names = {key[0] for key in kept}
    check(names == {"aggregate", "flash_attention", "moe_router"},
          f"the moe fleet's card run gave inputs to {sorted(names)} only")
    rows = []
    for key, ins in kept.items():
        row = {"kernel": key[0], "key": str(key[1:])}
        if key[0] == "aggregate":
            W, X, cid = ins
            got, want = AGG.aggregate(W, X, cid), AGG.aggregate_plain(W, X,
                                                                      cid)
            gap = (got - want).abs()
            row["max_abs_err"] = float(gap.max())
            check(bool((gap <= 1e-5 + 1e-5 * want.abs()).all()),
                  f"aggregate at the moe path's {key[1:]}: |err| "
                  f"{row['max_abs_err']} past f32 atol and rtol 1e-5")
        elif key[0] == "flash_attention":
            q, k, v = ins
            causal, window, softcap = key[4:]
            got = FA.flash_attention(q, k, v, causal, window, softcap)
            want = FA.flash_attention_plain(q, k, v, causal, window, softcap)
            torch.cuda.synchronize()
            row["max_abs_err"] = float((got.float() - want.float()).abs()
                                       .max())
            bf = q.dtype == torch.bfloat16
            row["max_bf16_ulps"] = (bf16_ulps(got.float(), want.float())
                                    if bf else None)
            check(bool(torch.isfinite(got).all())
                  and (row["max_bf16_ulps"] <= 2.0 if bf
                       else row["max_abs_err"] <= 1e-5),
                  f"flash at the moe path's {key[1:]}: {row}")
        else:
            (x,) = ins
            (t_, e_), k_ = key[1], key[2]
            e1, e2 = router_diff_check(gen, x, k_, f"on the path's {key[1:]}")
            t1, t2 = router_diff_check(gen, router_tie_logits(t_, e_,
                                                              x.device),
                                       k_, f"on tie rows at {key[1:]}")
            row.update(max_abs_err=max(e1, t1), grad_max_abs_err=max(e2, t2))
        rows.append(row)
        print(f"{key[0]} on the moe path's own inputs: {row}", flush=True)
    return rows


def moe_train_phase(gen, dev, mech) -> tuple:
    """Phase 29: grok-1-314b's smoke geometry in the LM fleet, card against
    CPU, ``moe_router`` launching once per MoE layer per forward on the
    card; each kernel held against its plain version on the inputs the
    card's run gave it (``moe_path_checks``); then ``moe_router_diff`` at
    training shapes (tie rows included)
    against ``moe_router_plain`` under autograd, and its forward (the
    kernel) and backward (the plain version) timed beside their bounds.
    Returns (the phase's record, the kernel-table row)."""
    from repro_torch.launch import loopcost as LC
    import torch
    from repro_torch.configs import grok_1_314b
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_router as MR
    from repro_torch.kernels import ops as K
    from repro_torch.models import registry as R
    cfg = grok_1_314b.get_smoke_config()
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    forwards = Counter()
    orig = R.compute_loss

    def counted(cfg_, params, batch):
        forwards[batch["tokens"].device.type] += 1
        return orig(cfg_, params, batch)

    reading, kept = {}, {}
    originals = (AGG.aggregate, FA.flash_attention, MR.moe_router)

    def restore():
        AGG.aggregate, FA.flash_attention, MR.moe_router = originals

    def after_card():
        reading.update(read_counters())
        restore()           # the CPU run goes through the plain versions

    R.compute_loss = counted
    AGG.aggregate, FA.flash_attention, MR.moe_router = keep_inputs(
        kept, *originals)
    zero_counters()
    try:
        gap = lm_card_vs_cpu(mech, cfg, "moe training",
                             after_card=after_card)
    finally:
        R.compute_loss = orig
        restore()
    check(reading["moe_router"] == n_moe * forwards["cuda"] > 0,
          f"moe_router launched {reading['moe_router']} times in "
          f"{forwards['cuda']} forwards of {n_moe} MoE layers")
    check(reading["flash_attention"] > 0 and reading["aggregate"] > 0,
          f"a kernel of the moe fleet never launched: {reading}")
    path_rows = moe_path_checks(gen, kept)
    rows, err, g_err = [], 0.0, 0.0
    for t_, e_, k_ in ROUTER_TRAIN_SHAPES:
        x = router_logits(gen, t_, e_, dev)
        e1, e2 = router_diff_check(gen, x, k_, f"({t_}, {e_}, {k_})")
        err, g_err = max(err, e1), max(g_err, e2)
        xd = x.detach()
        x.requires_grad_()
        w = torch.randn((t_, k_), generator=gen).to(dev)
        live = K.moe_router_diff(x, k_)[0]
        fb_ms, fb_by = LC.router_cost(t_, e_, k_).bound()
        # the backward reads the logits and the gates' gradient, writes the
        # logits' gradient
        bb_ms, bb_by = LC.Cost(8.0 * t_ * e_ + 4.0 * t_ * k_, 0.0).bound()
        rows.append({
            "shape": [t_, e_, k_], "max_abs_err": e1, "grad_max_abs_err": e2,
            "ms": device_ms(lambda: MR.moe_router(xd, k_)),
            "plain_ms": device_ms(lambda: MR.moe_router_plain(xd, k_)),
            "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None,
            "backward_ms": device_ms(lambda: torch.autograd.grad(
                live, x, w, retain_graph=True)),
            "backward_bound_ms": bb_ms, "backward_bound_by": bb_by})
        print(f"moe_router_diff ({t_}, {e_}, {k_}, tie rows): ids identical, "
              f"gates {e1:.2e}, grad {e2:.2e}; forward "
              f"{rows[-1]['ms']:.5f} ms, backward "
              f"{rows[-1]['backward_ms']:.4f} ms", flush=True)
    for r_ in path_rows:
        if r_["kernel"] == "moe_router":
            err = max(err, r_["max_abs_err"])
            g_err = max(g_err, r_["grad_max_abs_err"])
    record = {"config": "grok-1-314b get_smoke_config() in the LM fleet, "
                        "LMRunConfig(n_workers=4, n_rounds=9, batch=2, "
                        "seq=64, eval_every=3, seed=1), card vs CPU",
              "moe_layers": n_moe, "card_forwards": forwards["cuda"],
              "cpu_forwards": forwards["cpu"], "launches": reading,
              "card_vs_cpu_loss_gap": gap, "path_checks": path_rows,
              "router_diff": rows}
    row = {"name": "moe_router", "path": "moe training (phase 29)",
           "route": "cuda", "source": "src/repro_torch/kernels/csrc/"
                                     "moe_router.cu",
           "replaces": "src/repro/kernels/moe_router.py:49",
           "launches": reading["moe_router"], "max_abs_err": err,
           "grad_max_abs_err": g_err,
           **{k: rows[0][k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "backward_ms", "backward_bound_ms",
                                      "backward_bound_by")},
           "kimi": rows[1], "smoke_path": rows[2]}
    return record, row


# ---- phases 30-35: the vlm family and the encoder-decoder family ----------

# phase 31: paligemma-3b's loss at full width, 256 stub prefix embeddings
# (the config's n_prefix_tokens) in front of 256 text tokens
VLM_LOSS = dict(batch=2, text=256)
# phase 33: launch/serve.py on seamless-m4t-medium (max_len 512: 128 frames)
ENCDEC_SERVE = dict(batch=8, prompt_len=32, gen=32, max_len=512)
# phase 34: seamless-m4t-medium's loss at full width (frames_for(512) = 128)
ENCDEC_LOSS = dict(batch=4, seq=512)


def flash_keeper(kept: dict, calls: Counter, fa):
    """A wrapper around ``flash_attention`` that counts the calls of each
    (shape, kv heads, dtype, mask) key and keeps a copy of the inputs of
    each key's first call (the kernel's own counter stays the only proof
    of launches)."""
    def rec_fa(q, k, v, causal=True, window=None, softcap=None,
               q_offset=0):
        key = ("flash_attention", tuple(q.shape), k.shape[1], str(q.dtype),
               causal, window, softcap)
        calls[key] += 1
        if key not in kept:
            kept[key] = tuple(t.detach().clone() for t in (q, k, v))
        return fa(q, k, v, causal, window, softcap, q_offset)
    return rec_fa


def stub_batch(cfg, batch: int, seq: int, dev, seed: int = 0) -> dict:
    """Tokens, labels and the family's stub feed (prefix embeddings for
    the vlm family, ``frames_for(seq)`` frames for enc-dec), drawn on the
    CPU from ``seed`` in the activation dtype and moved to ``dev``."""
    import torch
    from repro_torch.models import registry as R
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=g),
           "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=g),
           "loss_mask": torch.ones((batch, seq))}
    dt = getattr(torch, cfg.dtype)
    if R.has_prefix(cfg):
        out["prefix_embeds"] = torch.randn(
            (batch, cfg.n_prefix_tokens, cfg.d_model), generator=g).to(dt)
    if R.is_encdec(cfg):
        out["frames"] = torch.randn(
            (batch, R.frames_for(cfg, seq), cfg.d_model), generator=g).to(dt)
    return {k: v.to(dev) for k, v in out.items()}


def full_loss_phase(cfg, label: str, batch: int, seq: int, dev,
                    kept: dict, calls: Counter) -> dict:
    """Phases 31 and 34: ``compute_loss`` forward and backward once on the
    card at full width (params drawn on the card), loss and every gradient
    finite; flash's inputs kept per shape (``flash_keeper``)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_leaves
    torch.cuda.empty_cache()
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    data = stub_batch(cfg, batch, seq, dev)
    orig = FA.flash_attention
    FA.flash_attention = flash_keeper(kept, calls, orig)
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        loss, _ = R.compute_loss(cfg, params, data)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    finally:
        FA.flash_attention = orig
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(loss)), f"{label} loss not finite: {loss}")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          f"{label}: a gradient is not finite")
    n_params = sum(t.numel() for t in leaves)
    feed = {k: list(v.shape) for k, v in data.items()}
    print(f"{label} compute_loss forward + backward at full width "
          f"({n_params} params, {feed}): loss {float(loss.detach()):.4f}, "
          f"{wall:.2f} s, launches {launches}, peak {peak / 1e9:.2f} GB",
          flush=True)
    out = {"config": f"{cfg.arch_id} get_config() (nothing cut), batch "
                     f"{batch}, seq {seq}", "params": n_params,
           "inputs": feed, "loss": float(loss.detach()), "wall_s": wall,
           "launches": launches, "max_memory_allocated_bytes": peak}
    del params, leaves, grads, loss, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_card_vs_cpu(cfg, label: str, seq: int) -> dict:
    """The smoke geometry's loss on the card and on the CPU from the same
    params and the same injected stub feed: within ``LM_CARD_CPU_TOL``;
    for enc-dec also ``fill_cross_cache`` + ``E_prefill``'s logits over a
    16-token prompt within ``SERVE_CARD_CPU_TOL``."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import serve as SERVE
    from repro_torch.models import encdec as E
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_map
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to("cuda"), params)
    data = stub_batch(cfg, 2, seq, "cpu", seed=3)
    with torch.no_grad():
        cpu_loss = float(R.compute_loss(cfg, params, data)[0])
        card_loss = float(R.compute_loss(cfg, card, {
            k: v.to("cuda") for k, v in data.items()})[0])
    gap = abs(card_loss - cpu_loss)
    check(gap <= LM_CARD_CPU_TOL, f"{label} card and CPU losses differ by "
          f"{gap} ({card_loss} against {cpu_loss})")
    out = {"config": f"{cfg.arch_id} (smoke), batch 2, seq {seq}",
           "card_loss": card_loss, "cpu_loss": cpu_loss, "loss_gap": gap}
    if R.is_encdec(cfg):
        prompt = data["tokens"][:, :16]
        logits = {}
        for dev, p in (("cuda", card), ("cpu", params)):
            cache = R.init_decode_cache(cfg, ShapeSpec("d", 64, 2, "decode"),
                                        dev)
            frames = stub_batch(cfg, 2, 64, dev, seed=4)["frames"]
            with torch.no_grad():
                cache = E.fill_cross_cache(cfg, p, cache, frames)
                logits[dev] = SERVE.E_prefill(cfg, p, cache,
                                              prompt.to(dev))[0].float().cpu()
        v = cfg.vocab_size
        err = float((logits["cuda"][..., :v] - logits["cpu"][..., :v]).abs()
                    .max())
        check(err <= SERVE_CARD_CPU_TOL, f"{label} E_prefill logits, card "
              f"vs CPU, differ by {err}")
        out["prefill_logits_max_abs_err"] = err
    print(f"{label} card vs CPU (smoke): {out}", flush=True)
    return out


def flash_path_row(key, ins, calls: int, label: str) -> dict:
    """Hold flash on the inputs of a path's first call at ``key`` against
    its plain version (2 bf16 ulps) and time it beside the plain version,
    its bound and ``scaled_dot_product_attention`` (kv heads repeated)."""
    from repro_torch.launch import loopcost as LC
    import torch
    from repro_torch.kernels import flash_attention as FA
    q, k, v = ins
    _, shape, hk, _, causal, window, softcap = key
    check(window is None and softcap is None, f"flash {label}: {key}")
    got = FA.flash_attention(q, k, v, causal)
    want = FA.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    ulps = bf16_ulps(got.float(), want.float())
    check(bool(torch.isfinite(got).all()) and ulps <= 2.0,
          f"flash {label} on the path's own inputs: {ulps} bf16 ulps")
    b_ms, b_by = LC.flash_cost(q, k, causal, window).bound()
    h = shape[1]
    k_rep = k.repeat_interleave(h // hk, dim=1)
    v_rep = v.repeat_interleave(h // hk, dim=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=causal)
    row = {"label": label, "shape": list(shape), "kv_heads": hk,
           "dtype": str(q.dtype), "causal": causal, "window": window,
           "softcap": softcap, "calls": calls, "max_bf16_ulps": ulps,
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "q_strides": list(q.stride()),
           "ms": device_ms(lambda: FA.flash_attention(q, k, v, causal), 20),
           "plain_ms": device_ms(lambda: FA.flash_attention_plain(
               q, k, v, causal), 5),
           "bound_ms": b_ms, "bound_by": b_by,
           "library": "scaled_dot_product_attention",
           "library_ms": device_ms(sdpa, 20),
           "library_bf16_ulps": bf16_ulps(sdpa().float(), want.float())}
    print(f"flash {label}: {row}", flush=True)
    return row


def encdec_serve_phase(kept: dict, calls: Counter) -> dict:
    """Phase 33: ``launch/serve.serve`` on seamless-m4t-medium at full size
    (nothing cut): stub frames drawn on the card, the encoder once (flash
    with ``causal=False``, once per encoder layer and nowhere else), the
    cross caches, ``E_prefill`` and greedy decoding (plain, as in the JAX
    package)."""
    import contextlib
    import io
    import re
    import torch
    from repro_torch.configs import seamless_m4t_medium
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve as SERVE
    cfg = seamless_m4t_medium.get_config()
    torch.cuda.empty_cache()
    orig = FA.flash_attention
    FA.flash_attention = flash_keeper(kept, calls, orig)
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            seqs = SERVE.serve(cfg.arch_id, False, ENCDEC_SERVE["batch"],
                               ENCDEC_SERVE["prompt_len"],
                               ENCDEC_SERVE["gen"],
                               max_len=ENCDEC_SERVE["max_len"],
                               device="cuda")
    finally:
        FA.flash_attention = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    text = buf.getvalue()
    print(text, end="", flush=True)
    check(launches["flash_attention"] == cfg.n_enc_layers
          and all(n == 0 for name, n in launches.items()
                  if name != "flash_attention"),
          f"seamless serving: launches {launches}, expected flash once per "
          f"encoder layer ({cfg.n_enc_layers}) and nothing else")
    check(tuple(seqs.shape) == (ENCDEC_SERVE["batch"],
                                ENCDEC_SERVE["gen"] + 1)
          and bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()),
          f"seamless serving returned {tuple(seqs.shape)} sequences")
    m = re.search(r"arch=seamless-m4t-medium batch=(\d+) device=cuda "
                  r"([0-9.]+) ms/token", text)
    check(m is not None, f"seamless serving printed no arch= line: {text!r}")
    out = {"config": "launch/serve.serve('seamless-m4t-medium', smoke=False, "
                     + ", ".join(f"{k}={v}" for k, v in ENCDEC_SERVE.items())
                     + ", device='cuda'), 12 + 12 layers, nothing cut",
           "ms_per_token": float(m.group(2)), "wall_s": wall,
           "launches": launches, "max_memory_allocated_bytes": peak}
    torch.cuda.empty_cache()
    return out


# phase 36: the legacy sim path's dense Eq. 4, one aggregate launch per leaf
# per round; the SimConfig() MLP's leaves have these widths (b1, b2, b3, w1,
# w2, w3)
LEGACY_WIDTHS = (64, 64, 10, 32 * 64, 64 * 64, 64 * 10)
LEGACY_LEAVES = len(LEGACY_WIDTHS)
LEGACY_ACC_TOL = 0.1               # acc_global, legacy vs fused (the JAX
                                   #   package's test_fused_history_matches_
                                   #   legacy gate: other batch streams)
LEGACY_LM_RTOL = 1e-3              # loss_global, legacy LM vs resident
LM_CONTROL = ("rounds", "sim_time", "comm_gb", "staleness_avg",
              "staleness_max", "round_durations", "round_active")
# phase 39: launch/train.py at smollm-135m's full width
TRAIN_RUN = dict(arch="smollm-135m", steps=20, batch=8, seq=128)
TRAIN_SMOKE_STEPS = 5


def legacy_sim_phase(fused_hist, dev) -> tuple:
    """Phase 36: ``SimConfig(fused_engine=False)`` at the defaults on the
    card, the counters zeroed just before: the control plane must equal
    phase 3's fused run, ``acc_global`` be within ``LEGACY_ACC_TOL`` of it
    and rise, ``aggregate`` launch once per leaf per round and nothing else
    launch; then ``aggregate`` is held on each per-leaf shape's first-call
    inputs against ``aggregate_plain`` (f32 atol and rtol 1e-5) and timed
    beside its bound, its plain version and ``matmul``."""
    from repro_torch.launch import loopcost as LC
    import numpy as np
    import torch
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    from repro_torch.kernels import aggregate as AGG
    cfg = SimConfig(fused_engine=False)
    kept, calls = {}, Counter()
    orig = AGG.aggregate

    def rec_agg(W, X, col_ids=None, **kw):
        key = (tuple(W.shape), tuple(X.shape), col_ids is not None)
        calls[key] += 1
        if key not in kept:
            kept[key] = (W.detach().clone(), X.detach().clone())
        return orig(W, X, col_ids, **kw)

    AGG.aggregate = rec_agg
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        h = run_simulation(DySTop(V=10.0, t_thre=20), cfg)
    finally:
        AGG.aggregate = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    check(launches["aggregate"] == LEGACY_LEAVES * cfg.n_rounds
          and sum(launches.values()) == launches["aggregate"],
          f"legacy sim launches {launches}, expected aggregate "
          f"{LEGACY_LEAVES} x {cfg.n_rounds} and nothing else")
    for f in SIM_CONTROL:
        check(getattr(h, f) == getattr(fused_hist, f),
              f"legacy sim: {f} differs from phase 3's fused run")
    acc = np.asarray(h.acc_global)
    gap = float(np.max(np.abs(acc - np.asarray(fused_hist.acc_global))))
    check(np.isfinite(acc).all() and np.isfinite(h.loss_global).all()
          and acc[-1] > acc[0] and gap <= LEGACY_ACC_TOL,
          f"legacy sim accuracy {acc.tolist()}, {gap} from phase 3's")
    # one shape per leaf width: b1 and b2 (64 columns each) share one
    check(sorted(k[1][1] for k in kept) == sorted(set(LEGACY_WIDTHS))
          and all(k[0] == (N_WORKERS, N_WORKERS) and not k[2]
                  for k in kept),
          f"legacy sim aggregate shapes {sorted(kept)}")
    rows = []
    for (w_shape, x_shape, _), (W, X) in sorted(kept.items(),
                                               key=lambda kv: kv[0][1][1]):
        got = orig(W, X)
        want = AGG.aggregate_plain(W, X)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all())
              and bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs())
                       .all()),
              f"aggregate at the legacy shape {w_shape} x {x_shape}: "
              f"|err| {err} past f32 atol and rtol 1e-5")
        k, n = w_shape
        b_ms, b_by = LC.agg_cost(W.cpu(), None, x_shape[1], n).bound()
        rows.append({
            "label": "legacy sim, per leaf", "k": k, "n_in": n,
            "P": x_shape[1], "col_sparse": False,
            "launches": calls[(w_shape, x_shape, False)],
            "max_abs_err": err,
            "ms": device_ms(lambda: orig(W, X)),
            "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, X)),
            "library_ms": device_ms(lambda: torch.matmul(W, X)),
            "call_ms": call_ms(lambda: orig(W, X)),
            "bound_ms": b_ms, "bound_by": b_by})
        print(f"aggregate, legacy leaf ({k}, {n}) x {x_shape}: {rows[-1]}",
              flush=True)
    out = {"config": "SimConfig(fused_engine=False) defaults (100 workers, "
                     "300 rounds, nothing cut), DySTop(V=10.0, t_thre=20)",
           "rounds": h.rounds[-1], "wall_s": wall,
           "setup_wall_s": h.setup_wall_s, "plan_wall_s": h.plan_wall_s,
           "eval_wall_s": h.eval_wall_s, "launches": launches,
           "acc_first": float(acc[0]), "acc_final": float(acc[-1]),
           "fused_acc_final": float(fused_hist.acc_global[-1]),
           "acc_gap_to_fused": gap, "control_plane": "identical to phase 3"}
    print(f"legacy sim path: {h.rounds[-1]} rounds in {wall:.2f} s, "
          f"launches {launches}, acc {acc[0]:.4f} -> {acc[-1]:.4f} (fused "
          f"{fused_hist.acc_global[-1]:.4f}, max gap {gap:.4f})", flush=True)
    return out, rows


def legacy_card_cpu_phase(root: pathlib.Path) -> dict:
    """Phase 37: a 60-round copy of phase 36's config on the card and on
    the CPU (the same numpy batches: control plane identical,
    ``acc_global`` within 1e-3), then 20 rounds with a snapshot every 10
    on the card, resumed from round 10: the history equals the
    uninterrupted run's bit for bit."""
    import shutil
    import numpy as np
    from repro_torch.checkpoint import io as CIO
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    mech = lambda: DySTop(V=10.0, t_thre=20)  # noqa: E731
    short = SimConfig(n_rounds=60, fused_engine=False)
    card = run_simulation(mech(), short)
    cpu = run_simulation(mech(), short, device="cpu")
    for f in SIM_CONTROL:
        check(getattr(card, f) == getattr(cpu, f),
              f"legacy sim card vs CPU: {f} differs")
    gap = float(np.max(np.abs(np.asarray(card.acc_global)
                              - np.asarray(cpu.acc_global))))
    check(gap <= 1e-3, f"legacy sim card vs CPU: acc_global differs by "
          f"{gap}")
    shutil.rmtree(root, ignore_errors=True)
    ck = SimConfig(n_rounds=20, fused_engine=False, checkpoint_every=10,
                   checkpoint_dir=str(root))
    full = run_simulation(mech(), ck)
    res = run_simulation(mech(), ck,
                         resume_from=str(CIO.checkpoint_path(root, 10)))
    for f in SIM_CONTROL + ("acc_global",):
        check(getattr(res, f) == getattr(full, f),
              f"legacy sim resume: {f} differs from the uninterrupted run")
    curves_equal = all(getattr(res, f) == getattr(full, f)
                       for f in SIM_CURVES)
    shutil.rmtree(root, ignore_errors=True)
    out = {"card_vs_cpu_rounds": short.n_rounds, "card_vs_cpu_acc_gap": gap,
           "resume": "20 rounds, snapshot every 10, resumed from round 10",
           "resume_control_and_acc_global_bit_equal": True,
           "resume_all_curves_bit_equal": curves_equal}
    print(f"legacy sim card vs CPU ({short.n_rounds} rounds): control plane "
          f"identical, max |acc gap| {gap:.2e}; resume from round 10 "
          f"bit-equal (all curves: {curves_equal})", flush=True)
    return out


def legacy_lm_phase(mech, cfg, run5) -> tuple:
    """Phase 38: ``run5`` (smollm-135m at full width, 5 rounds) with
    ``resident_fleet=False`` on the card, the counters zeroed just before:
    flash launches once per layer in each of the N forwards a round and in
    each eval, nothing but flash and ``aggregate`` launches; then the
    resident engine on the same config: control plane identical,
    ``loss_global`` within ``LEGACY_LM_RTOL``, the largest ``pbuf``/``obuf``
    gaps reported; flash held on its first call's inputs (2 bf16 ulps) and
    timed beside ``scaled_dot_product_attention``."""
    import numpy as np
    import torch
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.kernels import flash_attention as FA
    legacy = dataclasses.replace(run5, resident_fleet=False)
    kept, calls = {}, Counter()
    orig = FA.flash_attention
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention = flash_keeper(kept, calls, orig)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fleet, h = LW.run_lm_federation(mech(), cfg, legacy)
    finally:
        FA.flash_attention = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    n_forwards = legacy.n_workers * legacy.n_rounds + len(h.rounds)
    check(launches["flash_attention"] == cfg.n_layers * n_forwards
          and 0 < launches["aggregate"] <= legacy.n_rounds
          and sum(launches.values()) == launches["flash_attention"]
          + launches["aggregate"],
          f"legacy LM launches {launches}: expected flash {cfg.n_layers} x "
          f"{n_forwards} forwards, aggregate once a mixing round")
    check(np.isfinite(h.loss_global).all() and all_finite(fleet.pbuf)
          and all_finite(fleet.obuf), "legacy LM: not finite")
    torch.cuda.reset_peak_memory_stats()
    ref, rh = LW.run_lm_federation(mech(), cfg, run5)
    for f in LM_CONTROL:
        check(getattr(h, f) == getattr(rh, f),
              f"legacy LM: {f} differs from the resident run")
    lg, lg1 = np.asarray(h.loss_global), np.asarray(rh.loss_global)
    rel = float(np.max(np.abs(lg - lg1) / np.abs(lg1)))
    check(rel <= LEGACY_LM_RTOL, f"legacy LM loss_global {lg.tolist()} vs "
          f"resident {lg1.tolist()}")
    gaps = {name: max(float((a - b).abs().max()) for a, b in zip(x, y))
            for name, x, y in (("pbuf", fleet.pbuf, ref.pbuf),
                               ("obuf", fleet.obuf, ref.obuf))}
    del fleet, ref
    gc.collect()
    torch.cuda.empty_cache()
    check(len(kept) == 1, f"legacy LM flash shapes {sorted(kept)}")
    key, ins = next(iter(kept.items()))
    row = flash_path_row(key, ins, calls[key], "legacy LM (phase 38)")
    out = {"config": "phase 8's smollm-135m config (30 layers) at n_rounds="
                     "5 (cut: rounds, for the time limit), "
                     "resident_fleet=False",
           "rounds": h.rounds[-1], "wall_s": wall,
           "setup_wall_s": h.setup_wall_s, "eval_wall_s": h.eval_wall_s,
           "resident_wall_s": rh.wall_s, "launches": launches,
           "forwards": n_forwards, "loss_global": lg.tolist(),
           "resident_loss_global": lg1.tolist(), "max_loss_rel_gap": rel,
           "max_pbuf_gap": gaps["pbuf"], "max_obuf_gap": gaps["obuf"],
           "max_memory_allocated_bytes": peak,
           "flash_max_bf16_ulps": row["max_bf16_ulps"]}
    print(f"legacy LM path: {h.rounds[-1]} rounds in {wall:.2f} s "
          f"(resident {rh.wall_s:.2f} s), launches {launches}, loss "
          f"{lg.tolist()} vs {lg1.tolist()}, gaps {gaps}, peak "
          f"{peak / 1e9:.2f} GB", flush=True)
    return out, row


def train_phase(root: pathlib.Path) -> tuple:
    """Phase 39: ``launch.train.train`` on smollm-135m at full width on the
    card (``TRAIN_RUN``), the counters zeroed just before: flash launches
    once per layer per step and nothing else launches, the loss falls (the
    last five steps' mean below the first five's), the checkpoint reads back
    bit-equal through ``load_checkpoint``; flash held on its first call's
    inputs and timed; five more steps profiled (the busy share); then the
    smoke geometry on the card and on the CPU from the same params and
    batches, losses within ``LM_CARD_CPU_TOL``."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import io as CIO
    from repro_torch.data.synthetic import lm_batches, make_token_stream
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as TR
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_paths
    shutil.rmtree(root, ignore_errors=True)
    ck = root / "train.npz"
    kept, calls = {}, Counter()
    orig = FA.flash_attention
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention = flash_keeper(kept, calls, orig)
    zero_counters()
    t0 = time.perf_counter()
    try:
        run = TR.train(TRAIN_RUN["arch"], smoke=False,
                       steps=TRAIN_RUN["steps"], batch=TRAIN_RUN["batch"],
                       seq=TRAIN_RUN["seq"], ckpt_path=str(ck),
                       device="cuda", return_run=True)
    finally:
        FA.flash_attention = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    n_layers = run.cfg.n_layers
    check(launches["flash_attention"] == n_layers * TRAIN_RUN["steps"]
          and sum(launches.values()) == launches["flash_attention"],
          f"trainer launches {launches}: expected flash {n_layers} x "
          f"{TRAIN_RUN['steps']} and nothing else")
    losses = np.asarray(run.losses)
    check(np.isfinite(losses).all() and losses[-5:].mean()
          < losses[:5].mean(), f"trainer loss did not fall: "
          f"{losses.tolist()}")
    params, opt, extra = CIO.load_checkpoint(ck, run.params, run.opt_state)
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for tree, want in ((params, run.params),
                                  (opt, run.opt_state))
               for (_, a), (_, b) in zip(tree_paths(tree),
                                         tree_paths(want)))
    check(same and extra["steps"] == TRAIN_RUN["steps"],
          "trainer checkpoint does not read back bit-equal")
    ck_bytes = ck.stat().st_size
    del params, opt
    shutil.rmtree(root, ignore_errors=True)
    step_ms = statistics.median(run.step_wall_s[1:]) * 1e3
    first_step_s = run.step_wall_s[0]
    # the card's busy share over five more steps from the trained params,
    # under the profiler
    prof_walls = []
    busy_s, busy_top, busy_extra = device_profile(
        lambda: prof_walls.extend(TR.fit(
            run.cfg, 5, TRAIN_RUN["batch"], TRAIN_RUN["seq"], 3e-4, "adam",
            torch.device("cuda"), log_every=5,
            params=run.params).step_wall_s))
    check(len(kept) == 1, f"trainer flash shapes {sorted(kept)}")
    key, ins = next(iter(kept.items()))
    n_params = sum(t.numel() for _, t in tree_paths(run.params))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    row = flash_path_row(key, ins, calls[key], "trainer (phase 39)")
    # the smoke geometry, card vs CPU, from the same params and batches
    scfg = R.get_smoke_config(TRAIN_RUN["arch"])
    init = R.init_params(scfg, torch.Generator().manual_seed(0))
    stream = make_token_stream(scfg.vocab_size, 200_000)
    smoke = {d: TR.fit(scfg, TRAIN_SMOKE_STEPS, TRAIN_RUN["batch"],
                       TRAIN_RUN["seq"], 3e-4, "adam", torch.device(d),
                       params=init,
                       batches=lm_batches(stream, TRAIN_RUN["batch"],
                                          TRAIN_RUN["seq"])).losses
             for d in ("cuda", "cpu")}
    gap = float(np.max(np.abs(np.asarray(smoke["cuda"])
                              - np.asarray(smoke["cpu"]))))
    check(gap <= LM_CARD_CPU_TOL, f"trainer smoke card vs CPU losses "
          f"{smoke}")
    out = {"config": f"launch.train.train({TRAIN_RUN['arch']!r}, "
                     f"smoke=False, steps={TRAIN_RUN['steps']}, batch="
                     f"{TRAIN_RUN['batch']}, seq={TRAIN_RUN['seq']}) (30 "
                     f"layers, nothing cut), adam lr 3e-4",
           "params": n_params, "wall_s": wall, "ms_per_step": step_ms,
           "first_step_s": first_step_s, "launches": launches,
           "losses": losses.tolist(),
           "first5_mean": float(losses[:5].mean()),
           "last5_mean": float(losses[-5:].mean()),
           "checkpoint_bytes": ck_bytes, "checkpoint_bit_equal": True,
           "profiled_steps": len(prof_walls),
           "profiled_steps_wall_s": sum(prof_walls),
           "device_busy_s": busy_s,
           "device_busy_share": (None if busy_s is None
                                 else busy_s / sum(prof_walls)),
           "device_top_kernels": busy_top, **busy_extra,
           "max_memory_allocated_bytes": peak,
           "smoke_card_vs_cpu": {"steps": TRAIN_SMOKE_STEPS,
                                 "card": smoke["cuda"], "cpu": smoke["cpu"],
                                 "max_loss_gap": gap}}
    print(f"trainer: {TRAIN_RUN['steps']} steps, {step_ms:.2f} ms a step, "
          f"loss {losses[:5].mean():.4f} -> {losses[-5:].mean():.4f}, "
          f"launches {launches}, checkpoint {ck_bytes / 1e9:.2f} GB "
          f"bit-equal, smoke card vs CPU gap {gap:.2e}", flush=True)
    return out, row


# ---- phases 40-41: activation recomputation and the pods plane ------------

# phase 40: one train step's feed at smollm-135m's full width, both modes
REMAT_RUN = dict(arch="smollm-135m", batch=8, seq=2048, steps=5, lr=3e-4)
# phase 41: pods as workers, 4 smollm-135m replicas; the coordinator is
# examples/multipod_dystop.py's (WAA at V = 5 over uniform(1, 3) pod costs,
# tau_bound 2, every active pod pulling all its peers)
PODS_RUN = dict(arch="smollm-135m", n_pods=4, local_steps=2, batch=2,
                seq=512, rounds=2, lr=3e-4, V=5.0, tau_bound=2, seed=0)


def remat_phase() -> tuple:
    """Phase 40: 5 train steps of smollm-135m at full width (batch 8 x seq
    2048, Adam lr 3e-4, the trainer's feed) with ``make_train_step(remat=
    False)`` and then ``remat=True``, from one init drawn on the card, the
    counters zeroed before each: flash launches once per layer per step
    without remat and twice with it (the recompute), nothing else; the
    losses bit-equal; ms per step and the peak memory of each (the peak
    reset between them); flash held on its first call's inputs and
    timed."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_batches, make_token_stream
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_feed
    from repro_torch.models import registry as R
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_map
    run = REMAT_RUN
    cfg = R.get_config(run["arch"])
    dev = torch.device("cuda")
    b, s, n = run["batch"], run["seq"], run["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    init = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    it = lm_batches(make_token_stream(cfg.vocab_size, max(200_000,
                                                          b * s * 4)), b, s)
    feed = make_feed(cfg, b, s, dev)
    batches = [feed(next(it)) for _ in range(n)]
    kept, calls = {}, Counter()
    orig = FA.flash_attention
    modes = {}
    for remat in (False, True):
        opt = get_optimizer("adam", run["lr"])
        params = tree_map(torch.clone, init)
        state = opt.init(params)
        step = S.make_train_step(cfg, opt, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls.clear()                 # the kernel row counts the remat run
        FA.flash_attention = flash_keeper(kept, calls, orig)
        zero_counters()
        losses, walls = [], []
        try:
            for batch in batches:
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                losses.append(float(m["loss"]))
                walls.append(time.perf_counter() - t0)
        finally:
            FA.flash_attention = orig
        torch.cuda.synchronize()
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()
        want = cfg.n_layers * n * (2 if remat else 1)
        check(launches["flash_attention"] == want
              and sum(launches.values()) == want,
              f"remat={remat}: launches {launches}, expected flash {want} "
              f"and nothing else")
        check(np.isfinite(losses).all(), f"remat={remat}: losses {losses}")
        modes["remat" if remat else "plain"] = {
            "losses": losses, "ms_per_step": statistics.median(walls[1:])
            * 1e3, "first_step_s": walls[0], "launches": launches,
            "flash_per_step": launches["flash_attention"] / n,
            "max_memory_allocated_bytes": peak}
        del params, state, m, step
        print(f"remat={remat}: {modes['remat' if remat else 'plain']}",
              flush=True)
    plain, rem = modes["plain"]["losses"], modes["remat"]["losses"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(rem, plain))
    check(rem == plain, f"remat losses {rem} are not the bits of remat="
          f"False's {plain} (largest relative gap {rel})")
    del init, batches
    gc.collect()
    torch.cuda.empty_cache()
    check(len(kept) == 1, f"remat flash shapes {sorted(kept)}")
    key, ins = next(iter(kept.items()))
    check(key[1] == (b, cfg.n_heads, s, cfg.resolved_head_dim),
          f"remat flash shape {key}")
    row = flash_path_row(key, ins, calls[key], "trainer at seq 2048, remat "
                         "(phase 40)")
    row["launches_plain"] = modes["plain"]["launches"]["flash_attention"]
    row["launches_remat"] = modes["remat"]["launches"]["flash_attention"]
    out = {"config": f"{run['arch']} get_config() (30 layers, nothing cut), "
                     f"launch/train.py's feed, batch {b}, seq {s}, adam lr "
                     f"{run['lr']}, {n} steps a mode from one init",
           **modes, "losses_bit_equal": True,
           "peak_ratio": (modes["remat"]["max_memory_allocated_bytes"]
                          / modes["plain"]["max_memory_allocated_bytes"])}
    print(f"remat: losses bit-equal over {n} steps; peak "
          f"{modes['plain']['max_memory_allocated_bytes'] / 1e9:.2f} GB -> "
          f"{modes['remat']['max_memory_allocated_bytes'] / 1e9:.2f} GB, "
          f"{modes['plain']['ms_per_step']:.1f} -> "
          f"{modes['remat']['ms_per_step']:.1f} ms a step", flush=True)
    return out, row


# phase 44: the shared bf16 tolerances of the tests (tests/test_torch_moe.py
# and tests/test_torch_serving.py): loss, gradients atol and rtol, logits
REPAIR_TOL = dict(loss=2e-3, atol=5e-3, rtol=5e-2, logits=0.1)
REPAIR_DECODE = ("smollm-135m", "grok-1-314b", "mamba2-2.7b",
                 "recurrentgemma-2b", "paligemma-3b", "seamless-m4t-medium")


def _loss_grads(cfg, params, batch, remat: bool):
    """(loss, [gradient per leaf]) of ``compute_loss`` on a detached copy
    of ``params``."""
    import torch
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_from_paths, tree_paths
    paths = tree_paths(params)
    leaves = [t.detach().requires_grad_() for _, t in paths]
    p = tree_from_paths(zip([q for q, _ in paths], leaves))
    loss, _ = R.compute_loss(cfg, p, batch, remat=remat)
    return float(loss), torch.autograd.grad(loss, leaves)


def _greedy(cfg, params, prompt, frames, n: int, dev):
    """Prefill ``prompt`` (B, P) and decode ``n`` greedy tokens -> (tokens
    (B, n), the steps' logits (B, n, V) on the CPU)."""
    import torch
    from repro_torch.models import encdec as E
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    b, p = prompt.shape
    with torch.no_grad():
        if R.is_encdec(cfg):
            cache = E.fill_cross_cache(cfg, params, E.init_cache(
                cfg, b, p + n, frames.shape[1], dev), frames.to(dev))
            step = E.decode_step
        else:
            cache = T.init_cache(cfg, b, p + n, dev)
            step = T.decode_step
        tok = prompt.to(dev)
        for i in range(p):
            logits, cache = step(cfg, params, cache, tok[:, i:i + 1])
        toks, steps = [], []
        for _ in range(n):
            steps.append(logits[:, 0, :cfg.vocab_size].float().cpu())
            nxt = logits[:, 0, :cfg.vocab_size].argmax(-1, keepdim=True)
            toks.append(nxt.cpu())
            logits, cache = step(cfg, params, cache, nxt)
    return torch.cat(toks, 1), torch.stack(steps, 1)


def repair_phase() -> dict:
    """Phase 44: the paths whose rounding follows the reference's compiled
    backward and decode step, on the card against the same function on
    the CPU, from one init and one seeded batch: kimi-k2's and grok's
    smoke models (their MoE layers: the gates' summed gradient, the
    experts' shared input) and recurrentgemma's with ``remat=True`` (the
    RG-LRU conv's product f32 in the checkpointed forward, rounded in the
    recompute): loss and every gradient within the tests' shared bf16
    tolerance (``REPAIR_TOL``); then 8 greedy tokens after a 12-token
    prompt from each decoder family's smoke config (the in-group f32
    hand-on, seamless's ``ln_x``/``ln2`` reads): the tokens equal and each
    step's logits within it.  The counters are zeroed before each card
    run and read after it."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_map
    out = {"tolerance": REPAIR_TOL, "grads": {}, "decode": {}}
    for arch, remat in (("kimi-k2-1t-a32b", False), ("grok-1-314b", False),
                        ("recurrentgemma-2b", True)):
        cfg = R.get_smoke_config(arch)
        params = R.init_params(cfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(7)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int64))
            for k in ("tokens", "labels")}
        zero_counters()
        card = _loss_grads(cfg, tree_map(lambda t: t.to("cuda"), params),
                           tree_map(lambda t: t.to("cuda"), batch), remat)
        torch.cuda.synchronize()
        launches = read_counters()
        cpu = _loss_grads(cfg, params, batch, remat)
        gap = abs(card[0] - cpu[0])
        worst = max(float(((g.float().cpu() - h.float()).abs()
                           / (REPAIR_TOL["atol"] + REPAIR_TOL["rtol"]
                              * h.float().abs())).max())
                    for g, h in zip(card[1], cpu[1]))
        check(np.isfinite(card[0]) and gap <= REPAIR_TOL["loss"],
              f"{arch} (remat={remat}): loss card {card[0]} vs CPU "
              f"{cpu[0]}")
        check(worst <= 1.0, f"{arch} (remat={remat}): a gradient is "
              f"{worst:.2f}x the tolerance, card vs CPU")
        want = {"flash_attention": 1, "moe_router": int(cfg.moe is not None)}
        check(all((launches[k] > 0) == bool(v) for k, v in want.items()),
              f"{arch}: launches {launches}")
        out["grads"][arch] = {"remat": remat, "loss_card": card[0],
                              "loss_cpu": cpu[0], "loss_gap": gap,
                              "worst_grad_over_tol": worst,
                              "launches": launches}
        print(f"repairs, {arch} (remat={remat}): loss gap {gap:.3e}, worst "
              f"gradient {worst:.3f} of the tolerance, launches {launches}",
              flush=True)
    for arch in REPAIR_DECODE:
        cfg = R.get_smoke_config(arch)
        params = R.init_params(cfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(5)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (2, 12)).astype(np.int64))
        frames = None
        if R.is_encdec(cfg):
            frames = torch.from_numpy(rng.normal(
                size=(2, R.frames_for(cfg, 20), cfg.d_model)).astype(
                    np.float32)).to(getattr(torch, cfg.dtype))
        zero_counters()
        tok_c, lg_c = _greedy(cfg, tree_map(lambda t: t.to("cuda"), params),
                              prompt, frames, 8, "cuda")
        torch.cuda.synchronize()
        launches = read_counters()
        tok_h, lg_h = _greedy(cfg, params, prompt, frames, 8, "cpu")
        err = float((lg_c - lg_h).abs().max())
        check(torch.equal(tok_c, tok_h), f"{arch}: greedy tokens, card "
              f"{tok_c.tolist()} vs CPU {tok_h.tolist()}")
        check(err <= REPAIR_TOL["logits"], f"{arch}: decode logits, card "
              f"vs CPU, differ by {err}")
        moe_layers = sum(map(cfg.is_moe_layer, range(cfg.n_layers)))
        enc_layers = cfg.n_enc_layers if R.is_encdec(cfg) else 0
        check(launches["moe_router"] == moe_layers * (12 + 8)
              and launches["flash_attention"] == enc_layers,
              f"{arch} decode: launches {launches}")
        out["decode"][arch] = {"tokens_equal": True, "max_abs_logit_gap": err,
                               "launches": launches}
        print(f"repairs, {arch} decode: tokens equal, max |logit gap| "
              f"{err:.3e}, launches {launches}", flush=True)
    return out


def pods_plan() -> dict:
    """Phase 41's host side, shared by both forms: the coordinator's mixing
    matrices, each pod's batches (numpy) and each round's active pods."""
    import numpy as np
    from repro_torch.core.aggregation import mixing_matrix
    from repro_torch.core.staleness import StalenessState
    from repro_torch.core.waa import worker_activation
    from repro_torch.data.synthetic import lm_batches, make_token_stream
    from repro_torch.models import registry as R
    run = PODS_RUN
    n = run["n_pods"]
    cfg = R.get_config(run["arch"])
    rng = np.random.default_rng(run["seed"])
    st = StalenessState.create(n, tau_bound=run["tau_bound"])
    ws, actives = [], []
    for _ in range(run["rounds"]):
        active, _ = worker_activation(st, rng.uniform(1.0, 3.0, n),
                                      V=run["V"])
        links = np.zeros((n, n), bool)
        for i in np.flatnonzero(active):
            links[i] = True
            links[i, i] = False
        ws.append(mixing_matrix(active, links, np.ones(n)))
        actives.append(np.flatnonzero(active).tolist())
        st.advance(active)
    it = lm_batches(make_token_stream(cfg.vocab_size, 200_000), run["batch"],
                    run["seq"], seed=run["seed"])
    shape = (run["rounds"], n, run["local_steps"])
    draws = [next(it) for _ in range(int(np.prod(shape)))]
    batches = {k: np.stack([d[k] for d in draws]).reshape(
        shape + draws[0][k].shape) for k in draws[0]}
    return {"W": ws, "active": actives, "batches": batches}


def row_digest(tree, i: int) -> list:
    """Two wrapping int64 sums over the bits of pod ``i``'s leaves, in
    ``tree_paths`` order (plain and position-weighted): equal rows give
    equal digests, and a differing bit changes them."""
    import torch
    from repro_torch.tree import tree_paths
    s1 = s2 = 0
    off = 0
    for _, leaf in tree_paths(tree):
        x = leaf[i].reshape(-1)
        bits = x.view(torch.int16 if x.element_size() == 2
                      else torch.int32).long()
        pos = torch.arange(off, off + bits.numel(), dtype=torch.int64,
                           device=bits.device).mul_(2654435761).add_(1)
        s1 += int(bits.sum())
        s2 += int(bits.mul_(pos).sum())
        off += x.numel()
    return [s1 % 2 ** 64, s2 % 2 ** 64]


def pods_drive(plan: dict, mesh, lo: int, hi: int) -> dict:
    """Drive phase 41's rounds on pods ``[lo, hi)`` of this process (all
    of them on one process, one on a rank): the pods drawn on the card
    from their own seeds, the counters zeroed just before the rounds and
    read just after; identity rows checked unchanged by each mix; the
    gather timed (host); flash's and ``aggregate``'s first call inputs
    kept.  Returns the walls, the counters, the metrics and each pod's
    digest after every round."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import protocol as PROTO
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import steps as S
    from repro_torch.models import registry as R
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding.rules import FleetSharding
    from repro_torch.tree import tree_map, tree_paths
    run = PODS_RUN
    cfg = R.get_config(run["arch"])
    dev = torch.device("cuda")
    pods = [R.init_params(cfg, torch.Generator(dev).manual_seed(i))
            for i in range(lo, hi)]
    params = tree_map(lambda *ls: torch.stack(ls), *pods)
    del pods
    opt = get_optimizer("adam", run["lr"])
    state = S.init_pod_states(opt, params)
    gathers, identity_checked = [], []
    orig_mix = PROTO.dystop_pod_mix
    orig_gather = FleetSharding.all_gather_rows
    orig_fa, orig_agg = FA.flash_attention, AGG.aggregate
    kept, calls, agg_kept = {}, Counter(), {}

    def timed_gather(shd, X):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_gather(shd, X)
        torch.cuda.synchronize()
        gathers.append(time.perf_counter() - t0)
        return X

    def checked_mix(tree, W, mesh_=None):
        out = orig_mix(tree, W, mesh_)
        for j in range(hi - lo):
            if W[lo + j, lo + j] == 1.0:          # an identity row
                check(all(torch.equal(a[j], c[j]) for (_, a), (_, c) in
                          zip(tree_paths(out), tree_paths(tree))),
                      f"pods: the mix changed identity-row pod {lo + j}")
                identity_checked.append(lo + j)
        return out

    def rec_agg(W, X, col_ids=None, **kw):
        if not agg_kept:
            agg_kept["W"], agg_kept["X"] = W.clone(), X.clone()
        return orig_agg(W, X, col_ids, **kw)

    PROTO.dystop_pod_mix = checked_mix
    FleetSharding.all_gather_rows = timed_gather
    FA.flash_attention = flash_keeper(kept, calls, orig_fa)
    AGG.aggregate = rec_agg
    try:
        step = S.make_dystop_round_step(cfg, opt, mesh, remat=True,
                                        local_steps=run["local_steps"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        walls, metrics, digests = [], [], []
        for r in range(run["rounds"]):
            batch = {k: torch.from_numpy(v[r, lo:hi]).to(dev)
                     for k, v in plan["batches"].items()}
            torch.cuda.synchronize()
            if mesh is not None:
                dist.barrier()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch, plan["W"][r])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            digests.append([row_digest(params, j) for j in range(hi - lo)])
        launches = read_counters()
    finally:
        PROTO.dystop_pod_mix = orig_mix
        FleetSharding.all_gather_rows = orig_gather
        FA.flash_attention, AGG.aggregate = orig_fa, orig_agg
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          f"pods: metrics not finite: {metrics}")
    out = {"walls_s": walls, "gathers_s": gathers, "launches": launches,
           "metrics": metrics, "digests": digests,
           "identity_rows_checked": identity_checked,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "flash_kept": kept, "flash_calls": calls, "agg_kept": agg_kept}
    del params, state
    return out


def pods_rank(plan: dict) -> list:
    """One gloo rank of phase 41(b): its pod's rounds, then ``aggregate``
    held on its own first call's inputs (k = 1, the gathered (n_pods, P)
    buffer) against the plain version; every rank's results, gathered (no
    CUDA tensor leaves the rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.protocol import pod_sharding
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.launch.mesh import make_fleet_mesh
    mesh = make_fleet_mesh(dist.get_world_size(), "cuda")
    lo, hi = pod_sharding(mesh, PODS_RUN["n_pods"]).home
    out = pods_drive(plan, mesh, lo, hi)
    # does gloo all-gather CUDA tensors itself? (the pod mix goes through
    # host memory either way)
    probe = torch.full((4,), float(mesh.rank), device="cuda")
    parts = [torch.empty_like(probe) for _ in range(mesh.n_shards)]
    try:
        dist.all_gather(parts, probe)
        out["gloo_cuda_all_gather"] = (
            "ok" if all(bool((p == r).all()) for r, p in enumerate(parts))
            else "wrong values")
    except RuntimeError as e:
        out["gloo_cuda_all_gather"] = str(e).splitlines()[0][:200]
    agg = out.pop("agg_kept")
    del out["flash_kept"], out["flash_calls"]
    got = AGG.aggregate(agg["W"], agg["X"])
    want = AGG.aggregate_plain(agg["W"], agg["X"])
    gap = (got - want).abs()
    err = float(gap.max())
    check(bool(torch.isfinite(got).all())
          and bool((gap <= 1e-5 + 1e-5 * want.abs()).all()),
          f"pods rank {mesh.rank}: aggregate on its own inputs, |err| {err}")
    out["aggregate"] = {"k": agg["W"].shape[0], "n_in": agg["W"].shape[1],
                        "P": agg["X"].shape[1], "max_abs_err": err}
    del agg, got, want, gap
    torch.cuda.empty_cache()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def pod_agg_row(W, X, launches, label: str) -> dict:
    """``aggregate`` at a pod-mix shape on the path's own gathered buffer:
    held to its plain version (f32 atol and rtol 1e-5) and timed beside it,
    ``matmul`` on the same rows and its bound (median of 10 launches)."""
    from repro_torch.launch import loopcost as LC
    import torch
    from repro_torch.kernels import aggregate as AGG
    got = AGG.aggregate(W, X)
    want = AGG.aggregate_plain(W, X)
    gap = (got - want).abs()
    err = float(gap.max())
    check(bool(torch.isfinite(got).all())
          and bool((gap <= 1e-5 + 1e-5 * want.abs()).all()),
          f"aggregate at the {label} shape: |err| {err}")
    del got, want, gap
    k, n = W.shape
    b_ms, b_by = LC.agg_cost(W.cpu(), None, X.shape[1], n).bound()
    row = {"label": label, "k": k, "n_in": n, "P": X.shape[1],
           "launches": launches, "max_abs_err": err,
           "ms": device_ms(lambda: AGG.aggregate(W, X), reps=10),
           "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, X), reps=10),
           "library_ms": device_ms(lambda: torch.matmul(W, X), reps=10),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"aggregate, {label}: {row}", flush=True)
    return row


def pods_phase() -> tuple:
    """Phase 41: ``make_dystop_round_step`` with ``dystop_pod_mix`` on 4
    smollm-135m replicas at full width (``PODS_RUN``: local_steps 2, remat
    on, per-pod batch 2 x seq 512, 2 rounds, Adam; the W of
    ``pods_plan``'s coordinator), (a) in this process (the stacked form)
    and (b) as 4 gloo ranks sharing the card (``launch.mesh.spawn``), from
    the same init and batches.  Checks: aggregate once a round and flash
    twice per layer per local step (remat) and nothing else, on each
    side; every pod's row after every round bit-equal between (a) and (b)
    (``row_digest``), and the metrics; the identity rows unchanged by each
    mix; losses finite; ``aggregate`` held on the path's own inputs (the
    stacked k = 4 and the ranks' k = 1 calls) and timed, flash too."""
    import torch
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import registry as R
    run = PODS_RUN
    n, steps, rounds = run["n_pods"], run["local_steps"], run["rounds"]
    cfg = R.get_config(run["arch"])
    plan = pods_plan()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a = pods_drive(plan, None, 0, n)
    stacked_wall = time.perf_counter() - t0
    fa_per_pod = cfg.n_layers * 2 * steps * rounds
    check(a["launches"]["aggregate"] == rounds
          and a["launches"]["flash_attention"] == n * fa_per_pod
          and sum(a["launches"].values()) == rounds + n * fa_per_pod,
          f"pods (stacked): launches {a['launches']}, expected aggregate "
          f"{rounds} and flash {n * fa_per_pod}")
    identity = [i for W in plan["W"] for i in range(n) if W[i, i] == 1.0]
    check(a["identity_rows_checked"] == identity and identity,
          f"pods: identity rows {a['identity_rows_checked']} against the "
          f"plan's {identity}")
    W4, X = a["agg_kept"]["W"], a["agg_kept"]["X"]
    check(tuple(W4.shape) == (n, n), f"pods: stacked W {tuple(W4.shape)}")
    agg_rows = [pod_agg_row(W4, X, a["launches"]["aggregate"],
                            f"pods plane, stacked (k = {n})"),
                pod_agg_row(W4[:1].contiguous(), X, None,
                            "pods plane, one rank's row (k = 1)")]
    check(len(a["flash_kept"]) == 1, f"pods flash shapes "
          f"{sorted(a['flash_kept'])}")
    key, ins = next(iter(a["flash_kept"].items()))
    flash = flash_path_row(key, ins, a["flash_calls"][key],
                           "pods plane, remat (phase 41)")
    del W4, X, ins
    a.pop("agg_kept"), a.pop("flash_kept"), a.pop("flash_calls")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = MESH.spawn(pods_rank, n, plan, device="cuda")
    spawn_wall = time.perf_counter() - t0
    for i, rk in enumerate(ranks):
        check(rk["launches"]["aggregate"] == rounds
              and rk["launches"]["flash_attention"] == fa_per_pod
              and sum(rk["launches"].values()) == rounds + fa_per_pod,
              f"pods rank {i}: launches {rk['launches']}")
        for r in range(rounds):
            check(rk["digests"][r] == [a["digests"][r][i]],
                  f"pods: pod {i}'s row after round {r} differs between the "
                  f"stacked and the rank form")
        check(rk["metrics"] == a["metrics"], f"pods rank {i}: metrics "
              f"{rk['metrics']} against the stacked {a['metrics']}")
    check(sorted(i for rk in ranks for i in rk["identity_rows_checked"])
          == sorted(identity), "pods: the ranks' identity rows")
    agg_rows[1]["launches"] = [rk["launches"]["aggregate"] for rk in ranks]
    agg_rows[1]["ranks_max_abs_err"] = [rk["aggregate"]["max_abs_err"]
                                        for rk in ranks]
    out = {"config": f"{n} x {run['arch']} get_config() (30 layers, nothing "
                     f"cut), make_dystop_round_step(remat=True, local_steps="
                     f"{steps}), per-pod batch {run['batch']} x seq "
                     f"{run['seq']}, adam lr {run['lr']}, {rounds} rounds; "
                     f"coordinator: WAA V={run['V']} over uniform(1, 3) pod "
                     f"costs, tau_bound {run['tau_bound']}, links to every "
                     f"peer (examples/multipod_dystop.py)",
           "P": agg_rows[0]["P"], "active": plan["active"],
           "W": [w.tolist() for w in plan["W"]],
           "stacked": {"wall_s": stacked_wall,
                       "round_walls_s": a["walls_s"],
                       "launches": a["launches"], "metrics": a["metrics"],
                       "max_memory_allocated_bytes":
                           a["max_memory_allocated_bytes"]},
           "ranks": {"spawn_wall_s": spawn_wall,
                     "round_walls_s": [rk["walls_s"] for rk in ranks],
                     "gather_s": [rk["gathers_s"] for rk in ranks],
                     "launches": [rk["launches"] for rk in ranks],
                     "max_memory_allocated_bytes": [
                         rk["max_memory_allocated_bytes"] for rk in ranks],
                     "gloo_cuda_all_gather": ranks[0][
                         "gloo_cuda_all_gather"]},
           "rows_bit_equal": True, "metrics_bit_equal": True,
           "identity_rows_unchanged": identity}
    print(f"pods: stacked {a['walls_s']} s a round, ranks "
          f"{out['ranks']['round_walls_s']}, gathers "
          f"{out['ranks']['gather_s']}; rows bit-equal for {rounds} rounds; "
          f"losses {[m['loss'] for m in a['metrics']]}", flush=True)
    return out, agg_rows, flash


# phase 42: a counted step against its measured time.  The counter's peak
# (launch.loopcost) and the allocator's must agree within PEAK_FACTOR: the
# allocator rounds blocks up and holds the kernels' and cuBLAS's own
# scratch, which no op's output shows
COUNTED_TRAIN = dict(arch="smollm-135m", batch=8, seq=2048, lr=3e-4, steps=4)
COUNTED_PREFILL = dict(arch="mamba2-2.7b", n_layers=8, batch=4, seq=2048,
                       steps=4)
PEAK_FACTOR = 1.5


def ssd_keeper(kept: dict, calls: Counter, ssd):
    """A wrapper around ``ssd_chunk`` that counts the calls of each shape
    and keeps a copy of the inputs of each shape's first call (the
    kernel's own counter stays the only proof of launches)."""
    def rec_ssd(Bc, Cc, cum_la, xbar):
        key = ("ssd_chunk", tuple(xbar.shape), Bc.shape[2])
        calls[key] += 1
        if key not in kept:
            kept[key] = tuple(t.detach().clone() for t in (Bc, Cc, cum_la,
                                                           xbar))
        return ssd(Bc, Cc, cum_la, xbar)
    return rec_ssd


@contextlib.contextmanager
def swapped(module, name: str, wrapper):
    """``module.name`` replaced by ``wrapper(module.name)`` for the
    extent."""
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def counted_step(cfg, shape, mode: str, art, args, steps: int, smi: str,
                 during) -> dict:
    """Phase 42's readings of one path: ``steps`` runs of ``art``'s step on
    the card's ``args`` inside the context ``during()`` (each the same
    state's step; the median ms of all but the first), then one more under
    ``launch.loopcost.step_costs``, whose integers must equal the same
    step's count on ``meta``; the model FLOPs, ``mfu``, the roofline share
    and the counter's activation peak against the allocator's."""
    import torch
    from repro_torch.launch import analysis as A
    from repro_torch.launch import loopcost as LC
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, make_host_mesh
    from repro_torch.tree import tree_paths
    for i, (a, m_) in enumerate(zip(args, art.abstract_args, strict=True)):
        for (path, t), (_, m) in zip(tree_paths(a), tree_paths(m_),
                                     strict=True):
            check((t.shape, t.dtype) == (m.shape, m.dtype),
                  f"{cfg.arch_id} {mode}: argument {i} {path} is "
                  f"{tuple(t.shape)} {t.dtype} on the card, "
                  f"{tuple(m.shape)} {m.dtype} on meta")
    t0 = time.perf_counter()
    meta = LC.step_costs(art.step_fn, *art.abstract_args)
    meta_s = time.perf_counter() - t0
    walls = []
    with during():
        zero_counters()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = art.step_fn(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del out
        launches = read_counters()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = LC.step_costs(art.step_fn, *args)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    alloc_act = torch.cuda.max_memory_allocated() - before
    ints = lambda c: {"dot_flops": c.dot_flops, "io_bytes": c.io_bytes,
                      "peak_bytes": c.peak_bytes, "arg_bytes": c.arg_bytes,
                      "kernel_calls": dict(c.kernel_calls),
                      "collectives": dict(c.collectives)}
    check(ints(card) == ints(meta), f"{cfg.arch_id} {mode}: the card's "
          f"count {ints(card)} is not meta's {ints(meta)}")
    for name, n in launches.items():
        want = card.kernel_calls.get(name, 0) * steps
        check(n == want, f"{cfg.arch_id} {mode}: {name} launched {n} times "
              f"in {steps} steps, the counter saw {want // steps} a step")
    check(all(launches[k] > 0 for k in card.kernel_calls),
          f"{cfg.arch_id} {mode}: launches {launches}")
    step_s = statistics.median(walls[1:])
    roof = A.extract_roofline(cfg, shape, "host", make_host_mesh("cuda"),
                              mode, card, art)
    ratio = card.activation_peak_bytes / alloc_act
    check(1 / PEAK_FACTOR <= ratio <= PEAK_FACTOR,
          f"{cfg.arch_id} {mode}: counted activation peak "
          f"{card.activation_peak_bytes} B against the allocator's "
          f"{alloc_act} B (ratio {ratio:.3f}, allowed factor {PEAK_FACTOR})")
    row = {"card": smi, "mode": mode, "steps": steps,
           "ms_per_step": step_s * 1e3, "step_walls_s": walls,
           "launches": launches, "counted": ints(card),
           "card_count_equals_meta": True, "meta_count_s": meta_s,
           "card_count_s": count_s,
           "model_flops": roof.model_flops,
           "mfu": roof.model_flops / (step_s * PEAK_FLOPS_BF16),
           "t_compute_ms": roof.t_compute * 1e3,
           "t_memory_ms": roof.t_memory * 1e3,
           "roofline_share": max(roof.t_compute, roof.t_memory) / step_s,
           "bottleneck": roof.bottleneck,
           "useful_flops_ratio": roof.useful_flops_ratio,
           "counted_activation_peak_bytes": card.activation_peak_bytes,
           "allocator_activation_peak_bytes": alloc_act,
           "peak_ratio": ratio, "peak_factor_allowed": PEAK_FACTOR}
    print(f"counted {cfg.arch_id} {mode}: {step_s * 1e3:.1f} ms a step, "
          f"mfu {row['mfu']:.4f}, roofline share "
          f"{row['roofline_share']:.4f} ({roof.bottleneck}), card count = "
          f"meta count, activation peak counted/allocator {ratio:.3f} "
          f"(factor {PEAK_FACTOR} allowed) [{smi}]", flush=True)
    return row


def counted_phase(smi: str) -> tuple:
    """Phase 42: (a) ``build_train_artifacts`` for smollm-135m at full width
    (batch 8 x seq 2048, Adam lr 3e-4, remat) on the host mesh and (b)
    ``build_prefill_artifacts`` for mamba2-2.7b at 8 of 64 layers (batch 4
    x seq 2048), each materialised on the card and read by
    ``counted_step``; flash and ``ssd_chunk`` held on the inputs of their
    first call on these paths against their plain versions and timed."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synthetic import lm_batches, make_token_stream
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_chunk as SC
    from repro_torch.launch import loopcost as LC
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_feed
    from repro_torch.models import registry as R
    from repro_torch.optim import get_optimizer
    dev = torch.device("cuda")
    mesh = make_host_mesh("cuda")
    out, rows = {}, []

    def feed(cfg, b, s):
        it = lm_batches(make_token_stream(cfg.vocab_size, max(200_000,
                                                              b * s * 4)),
                        b, s)
        return make_feed(cfg, b, s, dev)(next(it))

    # (a) the train step
    run = COUNTED_TRAIN
    cfg = R.get_config(run["arch"])
    b, s = run["batch"], run["seq"]
    shape = ShapeSpec("counted_train", s, b, "train")
    opt = get_optimizer("adam", run["lr"])
    art = S.build_train_artifacts(cfg, shape, mesh, opt, remat=True)
    gc.collect()
    torch.cuda.empty_cache()
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    args = (params, opt.init(params), feed(cfg, b, s))
    kept, calls = {}, Counter()
    out["train"] = counted_step(
        cfg, shape, "train", art, args, run["steps"], smi,
        lambda: swapped(FA, "flash_attention",
                        lambda fa: flash_keeper(kept, calls, fa)))
    del args, params
    out["train"]["config"] = (f"{run['arch']} get_config() (30 layers), "
                              f"build_train_artifacts(batch {b}, seq {s}, "
                              f"adam lr {run['lr']}, remat=True), "
                              f"make_host_mesh('cuda')")
    check(len(kept) == 1, f"phase 42 flash shapes {sorted(kept)}")
    key, ins = next(iter(kept.items()))
    rows.append(flash_path_row(key, ins, out["train"]["launches"]
                               ["flash_attention"], "counted train step "
                               "(phase 42)"))
    del kept, ins
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the prefill step
    run = COUNTED_PREFILL
    cfg = dataclasses.replace(R.get_config(run["arch"]),
                              n_layers=run["n_layers"])
    b, s = run["batch"], run["seq"]
    shape = ShapeSpec("counted_prefill", s, b, "prefill")
    art = S.build_prefill_artifacts(cfg, shape, mesh)
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    args = (params, feed(cfg, b, s))
    kept, calls = {}, Counter()
    out["prefill"] = counted_step(
        cfg, shape, "prefill", art, args, run["steps"], smi,
        lambda: swapped(SC, "ssd_chunk",
                        lambda ssd: ssd_keeper(kept, calls, ssd)))
    del args, params
    out["prefill"]["config"] = (f"{run['arch']} get_config() at n_layers="
                                f"{run['n_layers']} (of 64), "
                                f"build_prefill_artifacts(batch {b}, seq "
                                f"{s}), make_host_mesh('cuda')")
    check(len(kept) == 1, f"phase 42 ssd shapes {sorted(kept)}")
    (_, (g_, h_, q_, p_), n_), ins = next(iter(kept.items()))
    got = SC.ssd_chunk(*ins)
    want = SC.ssd_chunk_plain(*ins)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "phase 42 ssd_chunk not finite")
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    sb_ms, sb_by = LC.ssd_cost(g_, h_, q_, n_, p_).bound()
    rows.append({
        "label": "counted prefill step (phase 42)",
        "shape": [g_, h_, q_, n_, p_],
        "launches": out["prefill"]["launches"]["ssd_chunk"],
        "max_abs_err": float((got - want).abs().max()),
        "ms": device_ms(lambda: SC.ssd_chunk(*ins)),
        "plain_ms": device_ms(lambda: SC.ssd_chunk_plain(*ins), 20),
        "bound_ms": sb_ms, "bound_by": sb_by, "library_ms": None})
    print(f"ssd_chunk (phase 42): {rows[-1]}", flush=True)
    del kept, ins, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


# phase 43: the tools' twins, each as a user runs it on the card: the
# chaos check as a subprocess, each example in this process at its defaults
# (its last printed line starts so; None: the federation's rows, checked
# apart), and the kernels each example's path must launch
EXAMPLES = {"quickstart": ("wall-clock: ", ("aggregate", "fused_sgd")),
            "dfl_federation": (None, ("aggregate", "fused_sgd")),
            "dfl_lm": ("engine: ", ("aggregate", "flash_attention")),
            "serve_lm": ("greedy continuation: ", ("flash_attention",)),
            "serving_engine": ("  req 3: ", ())}
CHUNKED_LOSS_TOL = 2e-3            # paligemma's loss, chunked vs naive


def chaos_phase(root: pathlib.Path) -> dict:
    """Phase 43(a): ``scripts/torch_chaos_check.py --plane both --device
    cuda`` as a subprocess (its snapshots under ``root``): exit 0 and
    ``passed`` on both planes."""
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = root / "chaos.json"
    script = pathlib.Path(__file__).resolve().parent / "scripts" \
        / "torch_chaos_check.py"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(script), "--plane", "both",
                          "--device", "cuda", "--out", str(out)],
                         env=dict(os.environ, TMPDIR=str(root)),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"torch_chaos_check exit {res.returncode}:\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    art = json.loads(out.read_text())
    recs = {r["plane"]: r for r in art["records"]}
    check(art["passed"] and set(recs) == {"sim", "lm"}
          and all(r["passed"] for r in recs.values()),
          f"torch_chaos_check: {art}")
    shutil.rmtree(root, ignore_errors=True)
    for plane, r in recs.items():
        print(f"chaos {plane}: killed_mid_run={r['killed_mid_run']}, "
              f"resume_from={r['resume_from']}, final round "
              f"{r['final_round']}", flush=True)
    return {"wall_s": wall, "records": art["records"]}


def examples_phase() -> dict:
    """Phase 43(b): each ``examples/torch_*.py`` in this process through
    ``runpy`` with ``sys.argv`` at its defaults (the card), the counters
    zeroed just before and read just after: its last printed line, its
    wall and the kernels its path launched; flash held on the inputs of
    each of its shapes' first call against the plain version (2 bf16
    ulps)."""
    import io
    import runpy
    import torch
    from repro_torch.kernels import flash_attention as FA
    out = {}
    for name, (last, kernels) in EXAMPLES.items():
        path = pathlib.Path(__file__).resolve().parent / "examples" \
            / f"torch_{name}.py"
        buf, argv = io.StringIO(), sys.argv
        kept, calls = {}, Counter()
        sys.argv = [str(path)]
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with swapped(FA, "flash_attention",
                         lambda fa: flash_keeper(kept, calls, fa)), \
                    contextlib.redirect_stdout(buf):
                runpy.run_path(str(path), run_name="__main__")
            torch.cuda.synchronize()
        finally:
            sys.argv = argv
        wall = time.perf_counter() - t0
        launches = read_counters()
        lines = buf.getvalue().strip().splitlines()
        if last is None:
            rows = [ln.split()[:2] for ln in lines[1:]
                    if not ln.startswith("    ->")]
            check(rows == [[m, phi] for phi in ("1.0", "0.4") for m in (
                "dystop", "sa-adfl", "asydfl", "matcha")],
                  f"example {name}: rows {rows}")
        else:
            check(bool(lines) and lines[-1].startswith(last),
                  f"example {name}: last line {lines[-1:]}")
        ran = sorted(k for k, v in launches.items() if v)
        check(ran == sorted(kernels), f"example {name} launched {launches},"
              f" expected {sorted(kernels)}")
        ulps = 0.0
        for key, (q, k, v) in kept.items():
            _, _, _, _, causal, window, softcap = key
            got = FA.flash_attention(q, k, v, causal, window, softcap)
            want = FA.flash_attention_plain(q, k, v, causal, window, softcap)
            ulps = max(ulps, bf16_ulps(got.float(), want.float()))
        check(ulps <= 2.0, f"example {name}: flash {ulps} bf16 ulps off its "
              f"plain version on the path's own inputs")
        out[name] = {"wall_s": wall, "last_line": lines[-1],
                     "launches": launches,
                     "flash_shapes": {str(k_[1:]): c
                                      for k_, c in calls.items()},
                     "flash_max_bf16_ulps": ulps}
        print(f"example torch_{name}: {wall:.2f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }, last line: "
              f"{lines[-1]}", flush=True)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    return out


def chunked_loss_phase(dev) -> dict:
    """Phase 43(c): paligemma-3b's loss at phase 31's full width with
    ``attn_impl="chunked"`` and with the naive einsum (the same params and
    feed), forward and backward: both finite, within
    ``CHUNKED_LOSS_TOL``, no kernel launched, and ``chunked_attention``
    called once per layer under "chunked" and never under "naive" (the
    losses alone cannot tell the two paths apart)."""
    from repro_torch.configs import paligemma_3b
    from repro_torch.models import layers as LAYERS
    out = {}
    for impl in ("chunked", "naive"):
        cfg = dataclasses.replace(paligemma_3b.get_config(), attn_impl=impl)
        kept, calls, chunked = {}, Counter(), Counter()

        def counting(fn):
            def wrapped(*a, **k):
                chunked["calls"] += 1
                return fn(*a, **k)
            return wrapped

        with swapped(LAYERS, "chunked_attention", counting):
            out[impl] = full_loss_phase(cfg, f"paligemma attn_impl={impl}",
                                        VLM_LOSS["batch"], VLM_LOSS["text"],
                                        dev, kept, calls)
        check(not any(out[impl]["launches"].values()) and not kept,
              f"a kernel launched on the {impl} prefix-LM path: "
              f"{out[impl]['launches']}")
        want = cfg.n_layers if impl == "chunked" else 0
        check(chunked["calls"] == want,
              f"attn_impl={impl}: chunked_attention called "
              f"{chunked['calls']} times, expected {want}")
        out[impl]["chunked_attention_calls"] = chunked["calls"]
    gap = abs(out["chunked"]["loss"] - out["naive"]["loss"])
    check(gap <= CHUNKED_LOSS_TOL, f"paligemma chunked vs naive loss: {gap}")
    out["loss_gap"] = gap
    out["attn_chunk"] = paligemma_3b.get_config().attn_chunk
    print(f"paligemma chunked vs naive: loss gap {gap:.3g}, chunked_attention"
          f" calls {out['chunked']['chunked_attention_calls']} / "
          f"{out['naive']['chunked_attention_calls']}", flush=True)
    return out


# phase 45: one model sharded over a (data, model) mesh of 4 gloo ranks on
# the card.  Bounds (tests/test_torch_sharded.py's shared bf16 ones): loss
# 2e-3; grad_norm 2e-3 of itself at the first step, where both runs hold
# the same params, and the gradients' rtol 5e-2 at the second, whose
# params already differ (below); a gradient block's digests within 10 % of
# its norm (bf16: the gap grows through the layers' backward, 5.1 % at 24
# layers with bf16 psums; a dropped psum or a wrong block reads 100 %).
# The update itself: per leaf block, the norm of the two runs' difference
# in new params over the norm of the unsharded run's update (Adam moves an
# element by about lr a step whatever its gradient, so an element whose
# tiny gradient changes sign between two sum orders moves the other way;
# a skipped update reads 1, a sign-flipped one 2; sound runs read 0.089
# on an H100).  The prefill logits within ``logits_ulps`` bf16 ulps of the
# largest (sound runs read 1), and the same logits against the unsharded
# prefill after one step (a stale replica, ~90 ulps) beyond it
SHARD_RUN = dict(arch="stablelm-1.6b", n_layers=4, mesh=(2, 2), batch=8,
                 seq=512, lr=3e-4, steps=2, seed=0)
SHARD_TOL = dict(loss=2e-3, grad_norm=(2e-3, 5e-2), update=0.3,
                 logits_ulps=2, digest=0.1)


def shard_cfg():
    """Phase 45's model: stablelm-1.6b at full width, its depth cut to
    ``SHARD_RUN["n_layers"]`` of 24 (at 24 the whole script passed 1,000
    s on an H100 80GB HBM3 at 700 W: 1,062.3 s, phase 45 78.6 s of it)."""
    from repro_torch.models import registry as R
    return dataclasses.replace(R.get_config(SHARD_RUN["arch"]),
                               n_layers=SHARD_RUN["n_layers"])


def shard_batches() -> list:
    """Phase 45's global batches (numpy): seeded tokens and labels over the
    vocab, every position in the loss."""
    import numpy as np
    run = SHARD_RUN
    cfg = shard_cfg()
    rng = np.random.default_rng(run["seed"])
    shape = (run["batch"], run["seq"])
    return [{"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape).astype(
                 np.int32),
             "loss_mask": np.ones(shape, np.float32)}
            for _ in range(run["steps"])]


def block_digests(leaves, specs, mesh, ranks) -> list:
    """For each leaf (whole, or this rank's block where ``ranks`` is None)
    and each rank's block of it: (sum of squares, the sum of its product
    with a seeded N(0, 1) tensor of the leaf's whole shape, cut the same
    way), in f32 on the card."""
    import torch
    from repro_torch.launch.mesh import rank_view
    from repro_torch.sharding import rules as SR
    out = []
    for i, (t, spec) in enumerate(zip(leaves, specs)):
        shape = (SR.global_shape(t.shape, spec, mesh) if ranks is None
                 else tuple(t.shape))
        r = torch.randn(shape, generator=torch.Generator("cuda").manual_seed(
            1000 + i), device="cuda")
        rows = []
        for rk in ([None] if ranks is None else ranks):
            if rk is None:
                blk, rr = t.float(), SR.local_slice(r, spec, mesh)
            else:
                view = rank_view(mesh, rk)
                blk = SR.local_slice(t, spec, view).float()
                rr = SR.local_slice(r, spec, view)
            rows.append((float(torch.sum(blk * blk)),
                         float(torch.sum(blk * rr))))
        out.append(rows)
        del r
    return out


def first_grads(opt, keep: dict):
    """``opt`` whose update keeps the first gradient tree it is given in
    ``keep["grads"]``: the train step's own gradient, read after the
    run."""
    def update(grads, state, params):
        keep.setdefault("grads", grads)
        return opt.update(grads, state, params)
    return dataclasses.replace(opt, update=update)


def shard_reference(batches, ref_path: pathlib.Path) -> dict:
    """Phase 45's unsharded run on the card: the prefill on the init and
    the 2 train steps (the first step's gradient as digests of every
    rank's block); its new params, its logits and the logits of a prefill
    after the first step (the control) saved on the host for the ranks."""
    import torch
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as S
    from repro_torch.models import registry as R
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_paths
    run = SHARD_RUN
    cfg = shard_cfg()
    dev = torch.device("cuda")
    mesh = MESH.Mesh(("data", "model"), run["mesh"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(run["seed"]))
    bs = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
          for b in batches]
    opt = get_optimizer("adam", run["lr"])
    art = S.build_train_artifacts(
        cfg, S.ShapeSpec("shard", run["seq"], run["batch"], "train"), mesh,
        opt)
    specs = [sp for _, sp in tree_paths(art.in_shardings[0])]
    logits = S.make_prefill_step(cfg)(params, bs[0])
    first = {}
    step = S.make_train_step(cfg, first_grads(opt, first))
    state = opt.init(params)
    metrics = []
    for b in bs:
        params, state, m = step(params, state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        if len(metrics) == 1:        # the control: a replica one step on
            stepped = S.make_prefill_step(cfg)(params, bs[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    digests = block_digests([g for _, g in tree_paths(first.pop("grads"))],
                            specs, mesh, range(mesh.n_devices))
    torch.save({"params": [t.cpu() for _, t in tree_paths(params)],
                "logits": logits.cpu(), "stepped": stepped.cpu()}, ref_path)
    del params, state, logits, stepped, bs
    gc.collect()
    torch.cuda.empty_cache()
    return {"metrics": metrics, "digests": digests, "wall_s": wall,
            "max_memory_allocated_bytes": peak}


def shard_flash_row(ins, calls: list, label: str) -> dict:
    """Flash on a rank's own first call's inputs against its plain
    version, whole and as the second half of the query rows at
    ``q_offset`` (2 bf16 ulps each), timed beside its bound and SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import loopcost as LC
    q, k, v, causal, window, softcap = ins
    got = FA.flash_attention(q, k, v, causal, window, softcap)
    want = FA.flash_attention_plain(q, k, v, causal, window, softcap)
    half = q.shape[2] // 2
    rows = q[:, :, half:]
    got_off = FA.flash_attention(rows, k, v, causal, window, softcap,
                                 q_offset=half)
    want_off = FA.flash_attention_plain(rows, k, v, causal, window, softcap,
                                        q_offset=half)
    torch.cuda.synchronize()
    ulps = bf16_ulps(got.float(), want.float())
    ulps_off = bf16_ulps(got_off.float(), want_off.float())
    check(bool(torch.isfinite(got).all()) and ulps <= 2.0
          and ulps_off <= 2.0,
          f"flash {label}: {ulps} and, at q_offset {half}, {ulps_off} bf16 "
          f"ulps from the plain version")
    check(torch.equal(want_off, want[:, :, half:]),
          f"flash {label}: the plain version at an offset is not the "
          f"whole's rows")
    b_ms, b_by = LC.flash_cost(q, k, causal, window).bound()
    h, hk = q.shape[1], k.shape[1]
    k_rep = k.repeat_interleave(h // hk, dim=1)
    v_rep = v.repeat_interleave(h // hk, dim=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=causal)
    return {"label": label, "shape": list(q.shape), "kv_heads": hk,
            "dtype": str(q.dtype), "causal": causal, "window": window,
            "softcap": softcap, "calls": calls, "max_bf16_ulps": ulps,
            "max_bf16_ulps_at_offset": ulps_off, "q_offset": half,
            "max_abs_err": max(
                float((got.float() - want.float()).abs().max()),
                float((got_off.float() - want_off.float()).abs().max())),
            "ms": device_ms(lambda: FA.flash_attention(q, k, v, causal), 20),
            "ms_at_offset": device_ms(lambda: FA.flash_attention(
                rows, k, v, causal, q_offset=half), 20),
            "plain_ms": device_ms(lambda: FA.flash_attention_plain(
                q, k, v, causal), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library": "scaled_dot_product_attention",
            "library_ms": device_ms(sdpa, 20)}


def shard_rank(plan: dict) -> list:
    """One gloo rank of phase 45: its blocks drawn from the unsharded
    init's stream, then (counters zeroed, a cost counter on) the prefill
    and 2 train steps; its update of each param block and its logits
    against the unsharded run's slices (the logits also against the
    control's), its first step's gradient (kept by the optimizer's
    update) as digests; flash on its own first inputs (timed one rank at
    a time).  Every rank's results, gathered (no CUDA tensor leaves the
    rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import loopcost as LC
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as S
    from repro_torch.models import registry as R
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding import rules as SR
    from repro_torch.tree import tree_map, tree_paths
    run = SHARD_RUN
    cfg = shard_cfg()
    dev = torch.device("cuda")
    mesh = MESH.make_rank_mesh(("data", "model"), run["mesh"], "cuda")
    opt = get_optimizer("adam", run["lr"])
    shape = S.ShapeSpec("shard", run["seq"], run["batch"], "train")
    first = {}
    art = S.build_train_artifacts(cfg, shape, mesh, first_grads(opt, first))
    pre = S.build_prefill_artifacts(
        cfg, S.ShapeSpec("shard", run["seq"], run["batch"], "prefill"), mesh)
    specs = [sp for _, sp in tree_paths(art.in_shardings[0])]
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(
        run["seed"]), mesh, art.rules)
    init_s = time.perf_counter() - t0
    bs = [SR.local_tree({k: torch.from_numpy(v).to(dev)
                         for k, v in b.items()}, art.in_shardings[2], mesh)
          for b in plan["batches"]]
    kept, calls = {}, []
    orig_fa = FA.flash_attention

    def rec_fa(q, k, v, causal=True, window=None, softcap=None,
               q_offset=0):
        calls.append(1)
        if not kept:
            kept["ins"] = tuple(t.detach().clone() for t in (q, k, v)) + (
                causal, window, softcap)
        return orig_fa(q, k, v, causal, window, softcap, q_offset)

    init = [t.clone() for _, t in tree_paths(params)]
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention = rec_fa
    try:
        zero_counters()
        with LC.CostCounter() as counter:
            t0 = time.perf_counter()
            logits = pre.step_fn(params, bs[0])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            state, metrics, step_s = opt.init(params), [], []
            for b in bs:
                t0 = time.perf_counter()
                params, state, m = art.step_fn(params, state, b)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in m.items()})
        launches = read_counters()
    finally:
        FA.flash_attention = orig_fa
    peak = torch.cuda.max_memory_allocated()
    ref = torch.load(plan["ref_path"], mmap=True, map_location="cpu")
    lr, update, worst_lr, beyond = run["lr"], [], 0.0, 0
    for (_, got), spec, whole, was in zip(tree_paths(params), specs,
                                          ref["params"], init):
        want = SR.local_slice(whole, spec, mesh).to(dev).float()
        gap = got.float() - want
        update.append(float(torch.linalg.vector_norm(gap)) / max(float(
            torch.linalg.vector_norm(want - was.float())), 1e-30))
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
            got.float().abs(), want.abs()).clamp_min(2.0 ** -126))) - 7)
        worst_lr = max(worst_lr, float(gap.abs().max()) / lr)
        beyond += int((gap.abs() > ulp).sum())
        del want, gap, ulp
    del init
    want = SR.local_slice(ref["logits"], pre.out_shardings, mesh).to(dev)
    top = float(want.abs().max())
    logit_ulp = 2.0 ** (int(torch.floor(torch.log2(torch.tensor(top)))) - 7)
    logit_gap = float((logits - want).abs().max())
    del want
    stale = SR.local_slice(ref["stepped"], pre.out_shardings, mesh).to(dev)
    stale_gap = float((logits - stale).abs().max())
    del ref, stale, logits
    digests = block_digests([g for _, g in tree_paths(first.pop("grads"))],
                            specs, mesh, None)
    del state
    torch.cuda.empty_cache()
    flash = rank_serial(lambda: shard_flash_row(
        kept["ins"], len(calls), f"sharded train, rank {dist.get_rank()}"))
    del kept
    out = {"rank": dist.get_rank(), "coords": list(mesh.coords),
           "init_s": init_s, "prefill_s": prefill_s, "step_s": step_s,
           "metrics": metrics, "launches": launches,
           "collective_bytes": dict(counter.collectives),
           "collective_calls": dict(counter.collective_calls),
           "counted_flops": counter.dot_flops,
           "max_memory_allocated_bytes": peak,
           "update_gap": max(update), "update_gap_by_leaf": update,
           "params_max_gap_lr": worst_lr,
           "params_beyond_one_ulp": beyond,
           "params_numel": sum(t.numel() for _, t in tree_paths(params)),
           "logits_max_abs_gap": logit_gap, "logits_ulp": logit_ulp,
           "logits_stale_gap": stale_gap,
           "digests": digests, "flash": flash}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def sharded_phase(smi: str, root: pathlib.Path) -> tuple:
    """Phase 45 (see the module docstring): the unsharded reference run,
    then 4 gloo ranks sharing the card, and the checks."""
    import torch
    from repro_torch.launch import mesh as MESH
    run = SHARD_RUN
    cfg = shard_cfg()
    t_phase = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    ref_path = root / "reference.pt"
    batches = shard_batches()
    gc.collect()
    torch.cuda.empty_cache()
    ref = shard_reference(batches, ref_path)
    t0 = time.perf_counter()
    try:
        ranks = MESH.spawn(shard_rank, int(torch.tensor(run["mesh"]).prod()),
                           {"batches": batches, "ref_path": str(ref_path)},
                           device="cuda")
    finally:
        ref_path.unlink(missing_ok=True)
    spawn_wall = time.perf_counter() - t0
    flash_per_rank = cfg.n_layers * (2 * run["steps"] + 1)
    tol = SHARD_TOL
    failed = []              # every check's message, raised together

    def expect(ok, msg):
        if not ok:
            failed.append(msg)

    for rk in ranks:
        i = rk["rank"]
        expect(rk["launches"]["flash_attention"] == flash_per_rank
               and sum(rk["launches"].values()) == flash_per_rank,
               f"sharded rank {i}: launches {rk['launches']}, expected "
               f"flash {flash_per_rank} and nothing else")
        for s_, (got, want) in enumerate(zip(rk["metrics"],
                                             ref["metrics"])):
            expect(abs(got["loss"] - want["loss"]) <= tol["loss"]
                   and abs(got["grad_norm"] - want["grad_norm"])
                   <= tol["grad_norm"][s_] * want["grad_norm"],
                   f"sharded rank {i}, step {s_}: metrics {got} against "
                   f"the unsharded {want}")
        expect(rk["metrics"] == ranks[0]["metrics"],
               f"sharded rank {i}: metrics differ from rank 0's")
        expect(rk["update_gap"] <= tol["update"],
               f"sharded rank {i}: a param block's update is "
               f"{rk['update_gap']:.3f} of its norm from the unsharded "
               f"run's")
        expect(rk["logits_max_abs_gap"] <= tol["logits_ulps"]
               * rk["logits_ulp"] < rk["logits_stale_gap"],
               f"sharded rank {i}: prefill logits differ by "
               f"{rk['logits_max_abs_gap']} from the unsharded run's and "
               f"by {rk['logits_stale_gap']} from its prefill one step on "
               f"(bf16 ulp of the largest {rk['logits_ulp']})")
        for leaf, (got, want) in enumerate(zip(rk["digests"],
                                               ref["digests"])):
            (sq, pr), (wsq, wpr) = got[0], want[i]
            norm = wsq ** 0.5
            expect(abs(sq ** 0.5 - norm) <= tol["digest"] * norm
                   and abs(pr - wpr) <= tol["digest"] * norm,
                   f"sharded rank {i}: gradient leaf {leaf}'s block "
                   f"digests ({sq}, {pr}) against the unsharded run's "
                   f"({wsq}, {wpr})")
    worst_digest = max(
        max(abs(g[0][0] ** 0.5 - w[rk["rank"]][0] ** 0.5),
            abs(g[0][1] - w[rk["rank"]][1])) / max(w[rk["rank"]][0] ** 0.5,
                                                    1e-30)
        for rk in ranks for g, w in zip(rk["digests"], ref["digests"]))
    flash = ranks[0]["flash"]
    flash["launches_per_rank"] = [rk["launches"]["flash_attention"]
                                  for rk in ranks]
    flash["max_bf16_ulps"] = max(rk["flash"]["max_bf16_ulps"]
                                 for rk in ranks)
    out = {"config": f"{run['arch']} get_config() at n_layers="
                     f"{run['n_layers']} (of 24; full width), "
                     f"build_train_artifacts / build_prefill_artifacts on a "
                     f"{run['mesh'][0]} x {run['mesh'][1]} (data, model) "
                     f"mesh of gloo ranks sharing cuda:0, global batch "
                     f"{run['batch']} x seq {run['seq']}, adam lr "
                     f"{run['lr']}, remat, {run['steps']} steps and one "
                     f"prefill, init seed {run['seed']}",
           "card": smi, "tolerance": tol,
           "reference": {k: v for k, v in ref.items() if k != "digests"},
           "spawn_wall_s": spawn_wall,
           "phase_wall_s": time.perf_counter() - t_phase,
           "worst_digest_over_norm": worst_digest,
           "ranks": [{k: v for k, v in rk.items()
                      if k not in ("digests", "flash")} for rk in ranks]}
    for rk in out["ranks"]:
        print(f"sharded rank {rk['rank']} {rk['coords']}: steps "
              f"{rk['step_s']} s, prefill {rk['prefill_s']:.2f} s, peak "
              f"{rk['max_memory_allocated_bytes'] / 1e9:.2f} GB, flash "
              f"{rk['launches']['flash_attention']}, collective bytes "
              f"{rk['collective_bytes']}, metrics {rk['metrics']}",
              flush=True)
    print(f"sharded: reference {ref['wall_s']:.1f} s, ranks "
          f"{spawn_wall:.1f} s, phase {out['phase_wall_s']:.1f} s; worst "
          f"digest gap {worst_digest:.2e} of the norm; reference metrics "
          f"{ref['metrics']}; update gap "
          f"{[rk['update_gap'] for rk in ranks]} of its norm, params "
          f"worst {[rk['params_max_gap_lr'] for rk in ranks]} lr, beyond "
          f"one ulp {[rk['params_beyond_one_ulp'] for rk in ranks]}; "
          f"logits {[rk['logits_max_abs_gap'] for rk in ranks]} (ulp "
          f"{[rk['logits_ulp'] for rk in ranks]}), one step on "
          f"{[rk['logits_stale_gap'] for rk in ranks]}", flush=True)
    check(not failed, "phase 45: " + "; ".join(failed))
    return out, flash


def main() -> int:
    t_script = time.perf_counter()
    phase_starts = {}

    def lap(phase: str) -> None:
        """Note when ``phase`` starts, in s since the script's start (the
        ``{"script"}`` line), so a slice that must cut depth can see where
        the script's time goes."""
        phase_starts[phase] = time.perf_counter() - t_script

    # phase 26's fleet all but fills the card: with fixed-size segments the
    # blocks one round frees are not reused by the next round's larger
    # ones (it ran out with 8 GB reserved but unallocated)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    # phase 9's flex_attention yardstick is compiled in this process, its
    # caches inside the checkout's build/ (which .gitignore lists)
    build_dir = pathlib.Path(__file__).resolve().parent / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(build_dir / "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_dir / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import numpy as np
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import flat_state as FS
    from repro_torch.dfl import worker as WK
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    from repro_torch.kernels import _build
    from repro_torch.launch import loopcost as LC
    from repro_torch.configs import (gemma2_2b, mamba2_2_7b,
                                     recurrentgemma_2b, smollm_135m)
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_sgd as FSGD
    from repro_torch.kernels import ssd_chunk as SC
    from repro_torch.configs import grok_1_314b
    from repro_torch.kernels import moe_router as MR
    from repro_torch.models import registry as R
    from repro_torch.serving import (ARRIVAL_PRESETS, ServeEngine, drive,
                                     generate_requests)
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE f32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)

    # ---- 1. build -----------------------------------------------------------
    lap("1")
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    cfg = SimConfig()
    spec = FS.spec_of(WK.init_stacked(torch.Generator(), 1, cfg.dim,
                                      cfg.hidden, 10))
    P = spec.n_params
    gen = torch.Generator().manual_seed(1234)

    # ---- 2. each kernel against its plain version --------------------------
    lap("2")
    buckets = (8, 16, 32, 64, N_WORKERS)
    X = torch.randn((N_WORKERS, P), generator=gen).to(dev)
    agg_err = 0.0
    for k in buckets:
        cases = [(u, True) for u in buckets] + [(N_WORKERS, False)]
        for u, col in cases:
            W, cid = agg_case(gen, k, u, N_WORKERS, col, dev)
            got = AGG.aggregate(W, X, cid)
            want = AGG.aggregate_plain(W, X, cid)
            torch.cuda.synchronize()
            agg_err = max(agg_err, float((got - want).abs().max()))
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    print(f"aggregate: {len(buckets) * 6} bucket cases match the plain "
          f"version, max |err| {agg_err:.3e}", flush=True)
    # k past 8 rows of a block and every P % 4 (the load width follows P
    # and the base address): the plain version's values, and the bits the
    # 4-wide loads give on the same columns
    wide = torch.randn((N_WORKERS, 6924), generator=gen).to(dev)
    flat = torch.empty((N_WORKERS * 6920 + 1,), device=dev)
    x_cases = [(f"P={p_}", wide[:, :p_].contiguous())
               for p_ in (6920, 6921, 6922, 6923)]
    x_cases.append(("P=6920, base 4 bytes off 16", flat[1:].view(N_WORKERS,
                                                                 6920)))
    x_cases[-1][1].copy_(wide[:, :6920])
    n_width = 0
    for k in (8, 100, 128, 200):
        for col in (True, False):
            W, cid = agg_case(gen, k, 64 if col else N_WORKERS, N_WORKERS,
                              col, dev)
            ref = AGG.aggregate(W, wide, cid)
            for label, Xp in x_cases:
                got = AGG.aggregate(W, Xp, cid)
                want = AGG.aggregate_plain(W, Xp, cid)
                torch.cuda.synchronize()
                agg_err = max(agg_err, float((got - want).abs().max()))
                torch.testing.assert_close(
                    got, want, atol=1e-5, rtol=1e-5,
                    msg=lambda m: f"aggregate k={k} {label}: {m}")
                check(torch.equal(got.view(torch.int32),
                                  ref[:, :Xp.shape[1]].view(torch.int32)),
                      f"aggregate's bits change with the load width at "
                      f"k={k}, {label}, col_sparse={col}")
                n_width += 1
    W, cid = agg_case(gen, 100, 64, N_WORKERS, True, dev)
    bad = cid.clone()
    bad[5] = N_WORKERS
    check(bool(torch.isnan(AGG.aggregate(W, X, bad)).all()),
          "aggregate: an out-of-range column id did not turn the outputs NaN")
    del wide, flat, x_cases
    print(f"aggregate: {n_width} cases at k in 8..200, P % 4 in 0..3 and a "
          f"misaligned base match the plain version with the 4-wide bits, "
          f"an out-of-range id gives NaN, max |err| {agg_err:.3e}",
          flush=True)

    sgd_err = 0.0
    steps, batch = cfg.local_steps, cfg.batch_size
    n_sgd = 0
    # the path's MLP at k in {8, 16, 100}, a batch the cluster does not
    # divide, widths other than the default and 50 steps (each step's
    # minibatch is copied in while the step before runs)
    odd_spec = FS.spec_of(mlp_stacked(20, 48, 36, 7))
    sgd_cases = [(k, batch, spec, steps) for k in (8, 16, N_WORKERS)]
    sgd_cases += [(N_WORKERS, 30, spec, steps),
                  (N_WORKERS, batch, odd_spec, steps), (8, batch, spec, 50)]
    for k, b_, sp, st in sgd_cases:
        d_, c_ = sp.shapes[sp.keys.index("w1")][0], sp.shapes[-1][-1]
        for with_losses in (True, False):
            buf, xb, yb, active = sgd_case(gen, k, st, b_, d_, c_, dev,
                                           sp.n_params)
            out, loss = FSGD.fused_sgd(buf, xb, yb, active, sp, cfg.lr,
                                       with_losses=with_losses)
            ref, ref_loss = FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, sp, cfg.lr, with_losses=with_losses)
            torch.cuda.synchronize()
            sgd_err = max(sgd_err, float((out - ref).abs().max()),
                          float((loss - ref_loss).abs().max()))
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
            torch.testing.assert_close(loss, ref_loss, atol=1e-4, rtol=0)
            idle = active == 0
            check(torch.equal(out[idle], buf[idle]),
                  "fused_sgd changed an inactive row")
            check(with_losses or torch.equal(loss, torch.zeros_like(loss)),
                  "fused_sgd reported losses with with_losses=False")
            # the same bits on a second launch, and a row's bits alone equal
            # its bits among k rows
            again, again_loss = FSGD.fused_sgd(buf, xb, yb, active, sp,
                                               cfg.lr, with_losses)
            check(torch.equal(out, again) and torch.equal(loss, again_loss),
                  f"fused_sgd k={k} batch={b_}: a second launch gave other "
                  f"bits")
            for i in sorted({0, k // 3, k - 1}):
                one, one_loss = FSGD.fused_sgd(
                    buf[i:i + 1], xb[i:i + 1], yb[i:i + 1], active[i:i + 1],
                    sp, cfg.lr, with_losses)
                check(torch.equal(one[0], out[i])
                      and torch.equal(one_loss[0], loss[i]),
                      f"fused_sgd: row {i}'s bits alone differ from its bits "
                      f"among k={k} (batch {b_})")
            n_sgd += 1
    sgd_smem = FSGD.smem_bytes(batch, cfg.dim, cfg.hidden, cfg.hidden, 10)
    print(f"fused_sgd: {n_sgd} cases (k in 8..100, batch 30, widths "
          f"20-48-36-7, 50 steps) match the plain version, max |err| "
          f"{sgd_err:.3e}; "
          f"the same bits on a second launch and for rows alone; "
          f"{FSGD.cluster_size(batch)} CTAs per row, {sgd_smem} B of shared "
          f"memory each", flush=True)

    # ---- 2b. aggregate past 2^31 columns -----------------------------------
    lap("2b")
    big_p = 2 ** 31 + 4096
    Xb = torch.empty((2, big_p), device=dev)
    Xb.normal_(generator=torch.Generator(dev).manual_seed(7))
    Wb = torch.rand((2, 2), generator=gen).to(dev)
    windows = (0, 2 ** 31 - 2048, big_p - 4096)
    Yb = AGG.aggregate(Wb, Xb)
    torch.cuda.synchronize()
    big_err = 0.0
    for lo in windows:
        got = Yb[:, lo:lo + 4096]
        want = AGG.aggregate_plain(Wb, Xb[:, lo:lo + 4096].contiguous())
        check(bool(torch.isfinite(got).all()),
              f"aggregate past 2^31 columns: non-finite at column {lo}")
        big_err = max(big_err, float((got - want).abs().max()))
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    del Yb, got
    bb_ms, bb_by = LC.agg_cost(Wb.cpu(), None, big_p, 2).bound()
    big_row = {"label": "past 2^31 columns", "k": 2, "u": 2,
               "col_sparse": False, "P": big_p, "max_abs_err": big_err,
               "ms": device_ms(lambda: AGG.aggregate(Wb, Xb), reps=3),
               "bound_ms": bb_ms, "bound_by": bb_by}
    # the plain version is one matmul, the library call itself
    for key, fn in (("plain", lambda: AGG.aggregate_plain(Wb, Xb)),
                    ("library", lambda: torch.matmul(Wb, Xb))):
        big_row[f"{key}_ms"], refusal = past_int32_ms(fn)
        if refusal:
            big_row[f"{key}_refused"] = refusal
    agg_err = max(agg_err, big_err)
    del Xb, Wb
    torch.cuda.empty_cache()
    print(f"aggregate past 2^31 columns (k=2, N=2, P={big_p}): windows at "
          f"0, 2^31 - 2048 and P - 4096 match the plain version, max |err| "
          f"{big_err:.3e}; {big_row['ms']:.3f} ms, bound {bb_ms:.3f} ms "
          f"({bb_by}); plain {big_row['plain_ms']}, matmul "
          f"{big_row['library_ms']} ({big_row.get('library_refused')})",
          flush=True)

    # ---- 3. the main path, through the kernels -----------------------------
    lap("3")
    shapes: Counter = Counter()
    orig_agg, orig_sgd = AGG.aggregate, FSGD.fused_sgd
    orig_fa = FA.flash_attention
    rec_agg, _ = recorder(shapes, orig_agg)
    AGG.aggregate, FSGD.fused_sgd = rec_agg, sgd_recorder(shapes, orig_sgd)
    AGG.launches = 0
    FSGD.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        hist = run_simulation(DySTop(V=10.0, t_thre=20), cfg)
    finally:
        AGG.aggregate, FSGD.fused_sgd = orig_agg, orig_sgd
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    launches = {"aggregate": AGG.launches, "fused_sgd": FSGD.launches}
    check(launches["aggregate"] > 0 and launches["fused_sgd"] > 0,
          f"a kernel of the main path never launched: {launches}")
    acc = np.asarray(hist.acc_global)
    check(np.isfinite(acc).all() and np.isfinite(hist.loss_global).all(),
          "non-finite accuracy or loss")
    check(acc[-1] > acc[0], f"accuracy did not rise: {acc.tolist()}")
    print(f"main path: {hist.rounds[-1]} rounds in {sim_wall:.2f} s, "
          f"launches {launches}, acc {acc[0]:.4f} -> {acc[-1]:.4f}",
          flush=True)

    # ---- 4. times at the main path's shapes --------------------------------
    lap("4")
    def agg_row(k, u, col, count):
        W, cid = agg_case(gen, k, u, N_WORKERS, col, dev)
        lib_cid = None if cid is None else cid.long()
        b_ms, b_by = LC.agg_cost(W.cpu(), None if cid is None else cid.cpu(),
                                 P, N_WORKERS).bound()
        return {
            "label": "sim", "k": k, "u": u, "col_sparse": col,
            "rounds": count,
            "ms": device_ms(lambda: AGG.aggregate(W, X, cid)),
            "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, X, cid)),
            "library_ms": device_ms(
                (lambda: torch.matmul(W, X)) if cid is None else
                (lambda: torch.matmul(W, X.index_select(0, lib_cid)))),
            "call_ms": call_ms(lambda: AGG.aggregate(W, X, cid)),
            "bound_ms": b_ms, "bound_by": b_by}

    agg_shapes = sorted(((s, c) for s, c in shapes.items()
                         if s[0] == "aggregate"), key=lambda sc: -sc[1])
    agg_rows = [agg_row(s[1], s[2], s[3], c) for s, c in agg_shapes]
    # what this timing cannot go below: a call with next to no work, and one
    # PyTorch elementwise launch
    W1, X1 = torch.ones((1, 1), device=dev), torch.ones((1, 128), device=dev)
    agg_floor = {"ms": device_ms(lambda: AGG.aggregate(W1, X1)),
                 "torch_add_ms": device_ms(lambda: X1.add_(0.0))}
    sgd_shapes = sorted(((s, c) for s, c in shapes.items()
                         if s[0] == "fused_sgd"), key=lambda sc: -sc[1])
    # the path's shapes first (commonest first), then the rest of k in
    # {8, 16, 100} with losses on and off; beside each, the floor of this
    # timing for fused_sgd (one row, one step of a 1-1-1-2 MLP: at batch 1
    # a one-CTA launch with next to no work, at batch 4 a 4-CTA cluster
    # with next to no work) and one PyTorch launch
    tiny_spec = FS.spec_of(mlp_stacked(1, 1, 1, 2))
    tiny = sgd_case(gen, 1, 1, 1, 1, 2, dev, tiny_spec.n_params)
    tiny4 = sgd_case(gen, 1, 1, 4, 1, 2, dev, tiny_spec.n_params)
    sgd_floor = {"ms": device_ms(lambda: FSGD.fused_sgd(
        *tiny, tiny_spec, cfg.lr, False)),
        "cluster4_ms": device_ms(lambda: FSGD.fused_sgd(
            *tiny4, tiny_spec, cfg.lr, False)),
        "torch_add_ms": agg_floor["torch_add_ms"]}
    sgd_keys = [s[1:] for s, _ in sgd_shapes]
    sgd_keys += [(k, wl) for k in (8, 16, N_WORKERS) for wl in (False, True)
                 if (k, wl) not in sgd_keys]
    sgd_rows = []
    for k, with_losses in sgd_keys:
        buf, xb, yb, active = sgd_case(gen, k, steps, batch, cfg.dim,
                                       10, dev, P)
        b_ms, b_by = LC.sgd_cost(spec, active, k, steps, batch,
                                    with_losses).bound()
        sgd_rows.append({
            "k": k, "with_losses": with_losses,
            "rounds": shapes[("fused_sgd", k, with_losses)],
            "ms": device_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "plain_ms": device_ms(lambda: FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "call_ms": call_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "floor_ms": sgd_floor["ms"],
            "floor_cluster4_ms": sgd_floor["cluster4_ms"],
            "torch_add_ms": sgd_floor["torch_add_ms"]})
        r_ = sgd_rows[-1]
        print(f"fused_sgd k={k} losses={'on' if with_losses else 'off'} "
              f"({r_['rounds']} rounds): {r_['ms']:.5f} ms, plain "
              f"{r_['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}), floor "
              f"{sgd_floor['ms']:.5f} ms (4-CTA cluster "
              f"{sgd_floor['cluster4_ms']:.5f}, a PyTorch launch "
              f"{sgd_floor['torch_add_ms']:.5f})", flush=True)

    # ---- 5. the card and the CPU agree --------------------------------------
    lap("5")
    short = SimConfig(n_rounds=60)
    h_card = run_simulation(DySTop(V=10.0, t_thre=20), short)
    h_cpu = run_simulation(DySTop(V=10.0, t_thre=20), short, device="cpu")
    for f in ("rounds", "sim_time", "comm_gb", "round_active",
              "staleness_avg", "staleness_max"):
        check(getattr(h_card, f) == getattr(h_cpu, f),
              f"card and CPU runs differ in {f}")
    acc_gap = float(np.max(np.abs(np.asarray(h_card.acc_global)
                                  - np.asarray(h_cpu.acc_global))))
    check(acc_gap <= 1e-3, f"card and CPU accuracy differ by {acc_gap}")
    print(f"card vs CPU, {short.n_rounds} rounds: control plane identical, "
          f"max |acc gap| {acc_gap:.2e}", flush=True)

    # ---- 6. how busy the card is on the main path --------------------------
    lap("6")
    busy_s, busy_top, _ = device_profile(
        lambda: run_simulation(DySTop(V=10.0, t_thre=20), cfg))
    print(f"main path under the profiler: device kernels "
          f"{busy_s if busy_s is None else round(busy_s, 4)} s", flush=True)

    # ---- 7. the flash kernel against its plain version --------------------
    lap("7")
    flash_err = flash_ulps = 0.0
    both, bf16_only = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    fa_cases = [("path", (4, 9, 256, 64), 3, True, None, None, both),
                ("ragged S=200", (4, 9, 200, 64), 3, True, None, None, both),
                ("window 64", (4, 9, 256, 64), 3, True, 64, None, both),
                ("softcap 50", (4, 9, 256, 64), 3, True, None, 50.0, both),
                ("(1, 8, 1024, 128)", (1, 8, 1024, 128), 8, True, None, None,
                 both),
                ("window 0: all rows masked", (2, 4, 96, 64), 2, True, 0,
                 None, both),
                ("non-causal window -32: last rows masked", (2, 4, 160, 64),
                 2, False, -32, None, both),
                # the bf16 kernel's lifted limits (the f32 kernel refuses
                # these three)
                ("D=112 (kimi-k2)", (2, 8, 200, 112), 1, True, None, None,
                 bf16_only),
                ("D=32 (smoke widths)", (2, 4, 96, 32), 2, True, None, None,
                 bf16_only),
                ("B=70000 (past grid z)", (70000, 1, 16, 64), 1, True, None,
                 None, bf16_only),
                ("D=256 (bf16: two warpgroups), S=950, window 300, "
                 "softcap 30", (8, 8, 950, 256), 4, True, 300, 30.0, both)]
    for label, (b, h, s, d), hk, causal, window, softcap, dtypes in fa_cases:
        for dtype in dtypes:
            q = torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
            q = q.transpose(1, 2)          # the model's layout, as a view
            k = torch.randn((b, hk, s, d), generator=gen).to(dev, dtype)
            v = torch.randn((b, hk, s, d), generator=gen).to(dev, dtype)
            got = FA.flash_attention(q, k, v, causal, window, softcap)
            want = FA.flash_attention_plain(q, k, v, causal, window, softcap)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all(), f"flash {label}: non-finite")
            err = float((got.float() - want.float()).abs().max())
            flash_err = max(flash_err, err)
            if dtype == torch.float32:
                check(err <= 1e-5, f"flash {label} f32: |err| {err}")
                print(f"flash {label} f32: max |err| {err:.3e}")
            else:
                ulps = bf16_ulps(got.float(), want.float())
                flash_ulps = max(flash_ulps, ulps)
                check(ulps <= 2.0, f"flash {label} bf16: {ulps} ulps")
                print(f"flash {label} bf16: max |err| {err:.3e}, "
                      f"{ulps:.2f} bf16 ulps")
            if window is not None and window <= 0:
                rows = ~flash_mask(s, causal, window).any(1)
                check(bool((got[:, :, rows.to(dev)] == 0).all()),
                      f"flash {label}: a fully masked row is not 0")
            del q, k, v, got, want
        if dtypes == bf16_only:
            try:
                FA.check_sizes(b, h, s, d, torch.float32)
            except ValueError:
                pass
            else:
                raise RuntimeError(f"chip_smoke: the f32 kernel took {label}")
    # TMA needs 16-byte-aligned bases and strides: such a bf16 call raises
    # before any launch, and never falls back
    before = FA.launches
    wide = torch.randn((2, 4, 96, 65), generator=gen).to(dev, torch.bfloat16)
    flat = torch.randn((2 * 4 * 96 * 64 + 1,), generator=gen).to(
        dev, torch.bfloat16)
    for label, bad in (("rows 130 bytes apart", wide[..., :64]),
                       ("base off by 2 bytes",
                        flat[1:].view(2, 4, 96, 64))):
        try:
            FA.flash_attention(bad, bad, bad)
        except ValueError as e:
            check("16" in str(e), f"flash misaligned ({label}): {e}")
        else:
            raise RuntimeError(f"chip_smoke: flash took a misaligned bf16 "
                               f"input ({label})")
    check(FA.launches == before, "flash launched on a misaligned input")
    print("flash: misaligned bf16 inputs raise (strides, base)")
    del wide, flat
    sys.stdout.flush()

    # ---- 8. the LM fleet's main path at full width, through the kernels ----
    lap("8")
    lm_cfg = smollm_135m.get_config()
    lm_run = LW.LMRunConfig(n_workers=8, n_rounds=30, batch=4, seq=256,
                            optimizer="adam", lr=1e-3, eval_every=5)

    def lm_mech():
        return DySTop(V=3.0, t_thre=10, max_neighbors=3)

    lm_shapes: Counter = Counter()
    AGG.aggregate, FA.flash_attention = recorder(lm_shapes, orig_agg, orig_fa)
    AGG.launches = 0
    FA.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fleet, lm_hist = LW.run_lm_federation(lm_mech(), lm_cfg, lm_run)
    finally:
        AGG.aggregate, FA.flash_attention = orig_agg, orig_fa
    torch.cuda.synchronize()
    lm_wall = time.perf_counter() - t0
    lm_launches = {"flash_attention": FA.launches, "aggregate": AGG.launches}
    check(lm_launches["flash_attention"] > 0 and lm_launches["aggregate"] > 0,
          f"a kernel of the LM path never launched: {lm_launches}")
    lm_peak = torch.cuda.max_memory_allocated()
    lossg = np.asarray(lm_hist.loss_global)
    check(lossg.shape == (6,) and np.isfinite(lossg).all()
          and np.isfinite(lm_hist.round_loss).all(),
          f"LM evals not finite: {lossg.tolist()}")
    check(all_finite(fleet.pbuf), "LM params not finite")
    print(f"LM path: {lm_hist.rounds[-1]} rounds in {lm_wall:.2f} s, "
          f"launches {lm_launches}, loss_global {lossg[0]:.4f} -> "
          f"{lossg[-1]:.4f}", flush=True)

    # ---- 9. times at the LM path's shapes ----------------------------------
    lap("9")
    fa_key, fa_count = max(((s, c) for s, c in lm_shapes.items()
                            if s[0] == "flash_attention"),
                           key=lambda sc: sc[1])
    _, (b, h, s, d), hk, fdt, causal, window, softcap = fa_key
    q = torch.randn((b, s, h, d), generator=gen).to(dev, fdt).transpose(1, 2)
    k = torch.randn((b, s, hk, d), generator=gen).to(dev, fdt).transpose(1, 2)
    v = torch.randn((b, s, hk, d), generator=gen).to(dev, fdt).transpose(1, 2)
    got = FA.flash_attention(q, k, v, causal, window, softcap)
    want = FA.flash_attention_plain(q, k, v, causal, window, softcap)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ulps = (bf16_ulps(got.float(), want.float()) if fdt == torch.bfloat16
            else 0.0)
    check(torch.isfinite(got).all() and ulps <= 2.0
          and (fdt == torch.bfloat16 or err <= 1e-5),
          f"flash at the LM path's strided views: |err| {err}, {ulps} ulps")
    flash_err, flash_ulps = max(flash_err, err), max(flash_ulps, ulps)
    print(f"flash at the LM path's strided q/k/v views: max |err| "
          f"{err:.3e}, {ulps:.2f} bf16 ulps", flush=True)
    k_rep = k.repeat_interleave(h // hk, dim=1)
    v_rep = v.repeat_interleave(h // hk, dim=1)
    fb_ms, fb_by = LC.flash_cost(q, k, causal, window).bound()
    flash_row = {
        "shape": [b, h, s, d], "kv_heads": hk, "dtype": str(fdt),
        "causal": causal, "calls": fa_count,
        "ms": device_ms(lambda: FA.flash_attention(q, k, v, causal, window,
                                                   softcap)),
        "plain_ms": device_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal, window, softcap)),
        "library_ms": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=causal)),
        "call_ms": call_ms(lambda: FA.flash_attention(q, k, v, causal,
                                                      window, softcap)),
        "bound_ms": fb_ms, "bound_by": fb_by, "max_bf16_ulps": ulps,
        "library_bf16_ulps": bf16_ulps(
            torch.nn.functional.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=causal).float(), want.float())}
    lm_agg_row = lm_aggregate_row(gen, lm_shapes, lm_launches["aggregate"],
                                  fleet.pbuf, "LM")
    agg_err = max(agg_err, lm_agg_row["max_abs_err"])
    del fleet
    # flash at two published attention widths at S = 4096, beside the path's
    g_att, m_att = grok_1_314b.get_config(), gemma2_2b.get_config()
    flash_rows = [dict(flash_row, label="LM path (smollm-135m)")]
    for label, cfg_, softcap_, window_ in (
            ("grok-1-314b widths, no softcap", g_att, None, None),
            ("gemma2-2b widths, softcap, window", m_att,
             m_att.attn_logit_softcap, m_att.window_size)):
        flash_rows.append(flash_long_row(
            gen, dev, label, 1 if cfg_ is g_att else 2, cfg_.n_heads,
            cfg_.n_kv_heads, 4096, cfg_.resolved_head_dim, softcap_,
            window_))
        flash_ulps = max(flash_ulps, flash_rows[-1]["max_bf16_ulps"])
        print(f"flash {label}: {flash_rows[-1]}", flush=True)
    torch.cuda.empty_cache()
    lm_busy = lm_profile(lm_mech(), lm_cfg, lm_run)

    # ---- 10. the card and the CPU agree on the LM plane --------------------
    lap("10")
    lm_gap = lm_card_vs_cpu(lm_mech, smollm_135m.get_smoke_config(), "LM")

    # ---- 11. the ssd_chunk kernel against its plain version ---------------
    lap("11")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain versions must run IEEE f32 products")
    ssd_err = 0.0
    ssd_cases = [("path (8, 80, 256, 128, 64)", (8, 80, 256, 128, 64), 0.1),
                 ("smoke (4, 16, 32, 32, 32)", (4, 16, 32, 32, 32), 0.1),
                 ("ragged Q=200", (2, 8, 200, 128, 64), 0.1),
                 ("large dt: masked exponents past 88", (2, 8, 256, 128, 64),
                  2.0)]
    for label, (g_, h_, q_, n_, p_), rate in ssd_cases:
        ins = ssd_case(gen, g_, h_, q_, n_, p_, rate, dev)
        if rate > 1.0:
            top = float((ins[2][..., 0] - ins[2][..., -1]).max())
            check(top > 88.0, f"ssd {label}: largest masked exponent {top}")
        got = SC.ssd_chunk(*ins)
        want = SC.ssd_chunk_plain(*ins)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"ssd {label}: non-finite")
        err = float((got - want).abs().max())
        ssd_err = max(ssd_err, err)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
        print(f"ssd_chunk {label}: max |err| {err:.3e}", flush=True)
    # cum_la that rises, which the model never feeds but the plain version
    # takes: a falling wave that rises in places, and a spike to 100 at the
    # second query tile's first row, where a decay split at that row would
    # overflow (exp(100)) in rows whose plain values are finite; rows the
    # plain version gives non-finite (the spike's own) are left out
    Bc, Cc, _, xb = ssd_case(gen, 2, 8, 256, 128, 64, 0.1, dev)
    qs = torch.arange(256, dtype=torch.float32)
    wave = (torch.sin(qs / 8) - 0.08 * qs).expand(2, 8, 256).contiguous()
    spike = torch.zeros((2, 8, 256))
    spike[..., 64] = 100.0
    spike[..., 65:] = -2.0 - 0.08 * (qs[65:] - 64)
    for label, la_, n_bad in (("cum_la a wave", wave, 0),
                              ("cum_la spiking at q = 64", spike, 16)):
        la_ = la_.to(dev)
        got = SC.ssd_chunk(Bc, Cc, la_, xb)
        want = SC.ssd_chunk_plain(Bc, Cc, la_, xb)
        torch.cuda.synchronize()
        rows = torch.isfinite(want).all(-1)
        check(int((~rows).sum()) == n_bad,
              f"ssd {label}: {int((~rows).sum())} non-finite plain rows")
        check(bool(torch.isfinite(got[rows]).all()),
              f"ssd {label}: non-finite where the plain version is finite")
        err = float((got[rows] - want[rows]).abs().max())
        ssd_err = max(ssd_err, err)
        torch.testing.assert_close(got[rows], want[rows], atol=2e-4,
                                   rtol=2e-4)
        print(f"ssd_chunk {label}: max |err| {err:.3e} (relative to the "
              f"largest value {float(want[rows].abs().max()):.3e})",
              flush=True)
    del ins, got, want, Bc, Cc, xb

    # ---- 12. the mamba2 LM path at full width, through the kernels --------
    lap("12")
    m_cfg = dataclasses.replace(mamba2_2_7b.get_config(), n_layers=8)
    m_run = LW.LMRunConfig(n_workers=8, n_rounds=20, batch=4, seq=512,
                           optimizer="adam", lr=1e-3, eval_every=5)
    m_shapes: Counter = Counter()
    exponents = []
    orig_ssd = SC.ssd_chunk
    AGG.aggregate, _ = recorder(m_shapes, orig_agg)
    SC.ssd_chunk = ssd_recorder(m_shapes, exponents, orig_ssd)
    AGG.launches = 0
    FA.launches = 0
    SC.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        m_fleet, m_hist = LW.run_lm_federation(lm_mech(), m_cfg, m_run)
    finally:
        AGG.aggregate, SC.ssd_chunk = orig_agg, orig_ssd
    torch.cuda.synchronize()
    m_wall = time.perf_counter() - t0
    m_launches = {"ssd_chunk": SC.launches, "aggregate": AGG.launches,
                  "flash_attention": FA.launches}
    check(m_launches["ssd_chunk"] > 0 and m_launches["aggregate"] > 0,
          f"a kernel of the mamba2 path never launched: {m_launches}")
    check(m_launches["flash_attention"] == 0,
          f"mamba2 has no attention, yet flash launched: {m_launches}")
    m_peak = torch.cuda.max_memory_allocated()
    m_expo = float(torch.stack(exponents).max())
    m_loss = np.asarray(m_hist.loss_global)
    check(m_loss.shape == (m_run.n_rounds // m_run.eval_every,)
          and np.isfinite(m_loss).all()
          and np.isfinite(m_hist.round_loss).all(),
          f"mamba2 evals not finite: {m_loss.tolist()}")
    check(all_finite(m_fleet.pbuf) and all_finite(m_fleet.obuf),
          "mamba2 params or optimizer state not finite")
    p_m = m_fleet.pbuf.shape[1]
    print(f"mamba2 path (8 layers, P={p_m}): {m_hist.rounds[-1]} rounds in "
          f"{m_wall:.2f} s, launches {m_launches}, loss_global "
          f"{m_loss[0]:.4f} -> {m_loss[-1]:.4f}, peak "
          f"{m_peak / 1e9:.2f} GB, largest masked exponent {m_expo:.1f}",
          flush=True)
    m_agg_row = lm_aggregate_row(gen, m_shapes, m_launches["aggregate"],
                                 m_fleet.pbuf, "mamba2")
    agg_err = max(agg_err, m_agg_row["max_abs_err"])
    del m_fleet
    torch.cuda.empty_cache()
    m_busy = lm_profile(lm_mech(), m_cfg, m_run)
    torch.cuda.empty_cache()

    # ---- 13. ssd_chunk timed at the path's commonest shape ----------------
    lap("13")
    ssd_key, ssd_count = max(((s_, c) for s_, c in m_shapes.items()
                              if s_[0] == "ssd_chunk"), key=lambda sc: sc[1])
    _, g_, h_, q_, n_, p_ = ssd_key
    ins = ssd_case(gen, g_, h_, q_, n_, p_, 0.1, dev)
    sb_ms, sb_by = LC.ssd_cost(g_, h_, q_, n_, p_).bound()
    ssd_row = {
        "shape": [g_, h_, q_, n_, p_], "calls": ssd_count,
        "ms": device_ms(lambda: SC.ssd_chunk(*ins)),
        "plain_ms": device_ms(lambda: SC.ssd_chunk_plain(*ins)),
        "call_ms": call_ms(lambda: SC.ssd_chunk(*ins)),
        "bound_ms": sb_ms, "bound_by": sb_by, "library_ms": None}
    del ins
    print(f"ssd_chunk at {ssd_row['shape']}: {ssd_row['ms']:.4f} ms, plain "
          f"{ssd_row['plain_ms']:.4f} ms, bound {sb_ms:.4f} ms ({sb_by})",
          flush=True)

    # ---- 14. the card and the CPU agree on the mamba2 smoke geometry -------
    lap("14")
    m_gap = lm_card_vs_cpu(lm_mech, mamba2_2_7b.get_smoke_config(), "mamba2")
    torch.cuda.empty_cache()

    # ---- 15. the moe_router kernel against its plain version --------------
    lap("15")
    router_err = 0.0
    router_cases = [(t_, e_, k_, False) for t_, e_, k_ in (
        (8, 8, 2), (4096, 8, 2), (4096, 384, 8), (300, 8, 2))]
    # grok's E = 8 (four rows share a warp) and E = 16 (two) with every row
    # a tie
    router_cases += [(64, 8, 2, True), (64, 16, 4, True)]
    for t_, e_, k_, ties in router_cases:
        x = (router_tie_logits(t_, e_, dev) if ties
             else router_logits(gen, t_, e_, dev))
        gates, ids = MR.moe_router(x, k_)
        p_gates, p_ids = MR.moe_router_plain(x, k_)
        torch.cuda.synchronize()
        check(torch.equal(ids, p_ids), f"moe_router ({t_}, {e_}, {k_}): ids "
              f"differ from the plain version's")
        check(bool(torch.isfinite(gates).all()),
              f"moe_router ({t_}, {e_}, {k_}): non-finite gates")
        err = float((gates - p_gates).abs().max())
        check(err <= 1e-6, f"moe_router ({t_}, {e_}, {k_}): |err| {err}")
        router_err = max(router_err, err)
        tie_note = ", every row a tie" if ties else ""
        print(f"moe_router ({t_}, {e_}, {k_}{tie_note}): ids identical, max "
              f"|gate err| {err:.3e}", flush=True)

    # ---- 16. serving grok-1-314b at full width, through the kernels -------
    lap("16")
    for mod in (AGG, FSGD, FA, SC, MR):
        mod.launches = 0
    g_cfg = dataclasses.replace(grok_1_314b.get_config(), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_params = R.init_params(g_cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    g_init_wall = time.perf_counter() - t0
    g_init_peak = torch.cuda.max_memory_allocated()
    g_reqs = generate_requests(ARRIVAL_PRESETS["steady"], g_cfg.vocab_size)
    g_eng = ServeEngine(g_cfg, g_params, batch_slots=8, max_len=512, seed=0,
                        device="cuda")
    finite, step_s = [], []
    step = g_eng.step

    def timed_step():
        t1 = time.perf_counter()
        events = step()
        finite.append(torch.isfinite(g_eng.last_logits).all())
        step_s.append(time.perf_counter() - t1)
        return events

    g_eng.step = timed_step
    t0 = time.perf_counter()
    g_rep = drive(g_eng, g_reqs)
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_peak = torch.cuda.max_memory_allocated()
    g_ticks = g_eng.t
    g_launches = {"moe_router": MR.launches, "flash_attention": FA.launches,
                  "ssd_chunk": SC.launches, "aggregate": AGG.launches,
                  "fused_sgd": FSGD.launches}
    check(g_rep.n_finished == len(g_reqs) == 24,
          f"grok served {g_rep.n_finished} of {len(g_reqs)} requests")
    for rid, r in enumerate(g_reqs):
        check(len(g_rep.outputs[rid]) == r.gen.max_new_tokens,
              f"grok request {rid}: {len(g_rep.outputs[rid])} tokens of "
              f"{r.gen.max_new_tokens}")
    check(bool(torch.stack(finite).all()), "grok logits not finite")
    check(g_launches["moe_router"] == g_cfg.n_layers * g_ticks,
          f"moe_router launched {g_launches['moe_router']} times in "
          f"{g_ticks} ticks of {g_cfg.n_layers} MoE layers")
    check(all(g_launches[k] == 0 for k in ("flash_attention", "ssd_chunk",
                                           "aggregate", "fused_sgd")),
          f"a kernel off the serving path launched: {g_launches}")
    g_tick_ms = sum(step_s) / g_ticks * 1e3
    print(f"grok serving (4 layers): {g_rep.n_finished} requests, "
          f"{g_rep.total_tokens} tokens in {g_rep.makespan_s:.2f} s "
          f"({g_rep.tokens_per_sec:.1f} tok/s), {g_ticks} ticks at "
          f"{g_tick_ms:.2f} ms, launches {g_launches}, init "
          f"{g_init_wall:.2f} s, peak {g_peak / 1e9:.2f} GB", flush=True)
    # the profile covers ticks 40-70 of a second drive, as phase 28's
    # (cut from the whole drive, for the time limit: reading back its
    # trace took most of the phase's 72-88 s)
    from torch.profiler import ProfilerActivity, profile
    g_prof = profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
    g_e2 = ServeEngine(g_cfg, g_params, batch_slots=8, max_len=512, seed=0,
                       device="cuda")
    g_inner, g_window = g_e2.step, []
    g_edges = (SERVE_PROF_FROM, SERVE_PROF_FROM + SERVE_PROF_TICKS)

    def g_windowed_step():
        if len(g_window) < 2 and g_e2.t == g_edges[len(g_window)]:
            torch.cuda.synchronize()
            g_window.append(time.perf_counter())
            (g_prof.start if len(g_window) == 1 else g_prof.stop)()
        return g_inner()

    g_e2.step = g_windowed_step
    t1 = time.perf_counter()
    prof_rep = [drive(g_e2, g_reqs)]
    torch.cuda.synchronize()
    prof_rep.append(time.perf_counter() - t1)
    check(len(g_window) == 2, f"grok's second drive ran {g_e2.t} ticks, "
          f"fewer than the profiled window's end")
    check(prof_rep[0].outputs == g_rep.outputs,
          "the profiled drive served other tokens")
    g_busy, g_top, g_extra = profile_rows(g_prof)
    g_prof_wall = g_window[1] - g_window[0]
    del g_e2, g_inner, g_windowed_step

    # ---- 17. moe_router timed at the path's shape and kimi's --------------
    lap("17")
    router_rows = []
    x1 = torch.ones((1, 1), device=dev)          # a call with no work
    router_floor = {"ms": device_ms(lambda: MR.moe_router(x1, 1)),
                    "torch_add_ms": agg_floor["torch_add_ms"]}
    for t_, e_, k_ in ((8, 8, 2), (4096, 384, 8)):
        x = router_logits(gen, t_, e_, dev)
        rb_ms, rb_by = LC.router_cost(t_, e_, k_).bound()
        router_rows.append({
            "shape": [t_, e_, k_],
            "ms": device_ms(lambda: MR.moe_router(x, k_)),
            "plain_ms": device_ms(lambda: MR.moe_router_plain(x, k_)),
            "call_ms": call_ms(lambda: MR.moe_router(x, k_)),
            "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None,
            "floor_ms": router_floor["ms"]})
        print(f"moe_router at ({t_}, {e_}, {k_}): "
              f"{router_rows[-1]['ms']:.5f} ms, plain "
              f"{router_rows[-1]['plain_ms']:.4f} ms, bound {rb_ms:.6f} ms "
              f"({rb_by}), floor {router_floor['ms']:.5f} ms", flush=True)
    # the engine's timed step closes over the engine: collect the cycle, or
    # its 41 GB of weights stay alive through every later phase
    del g_eng, g_params, step, timed_step
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 18. the card and the CPU agree on serving -------------------------
    lap("18")
    serve_gaps = {label: serve_card_vs_cpu(c, label) for label, c in (
        ("grok", grok_1_314b.get_smoke_config()),
        ("smollm", smollm_135m.get_smoke_config()),
        ("mamba2", mamba2_2_7b.get_smoke_config()))}
    # recurrentgemma's smoke window is 64: prompts and generations that pass
    # it wrap the attention ring and carry the RG-LRU state past it
    serve_gaps["recurrentgemma"] = serve_card_vs_cpu(
        recurrentgemma_2b.get_smoke_config(), "recurrentgemma",
        prompt_len=(40, 56), gen_len=(24, 40), max_len=128)
    check(serve_gaps["recurrentgemma"]["longest_request"] > 64,
          "recurrentgemma's card-vs-CPU requests stay inside the window")

    # ---- 19-21. the fleet mesh: gloo ranks sharing the card ----------------
    lap("19-21")
    from repro_torch.launch import mesh as MESH
    lm5 = dataclasses.replace(lm_run, n_rounds=5)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm5_fleet, lm5_hist = LW.run_lm_federation(lm_mech(), lm_cfg, lm5)
    torch.cuda.synchronize()
    lm5_wall = time.perf_counter() - t0
    del lm5_fleet
    torch.cuda.empty_cache()
    col_top = next(s_ for s_, _ in agg_shapes if s_[3])
    row_top = next((s_ for s_, _ in agg_shapes if not s_[3]),
                   ("aggregate", N_WORKERS, N_WORKERS, False))
    plan_base = dict(device="cuda", n=N_WORKERS, P=P, reps=20,
                     buckets=buckets, dim=cfg.dim, hidden=cfg.hidden,
                     steps=steps, batch=batch, lr=cfg.lr,
                     sgd_ks=(8, 16, N_WORKERS),
                     agg_top=[tuple(col_top[1:]), tuple(row_top[1:])],
                     sgd_top=sgd_shapes[0][0][1], sim_cfg=cfg)
    mesh_runs = {}
    for n_sh in MESH_SHARDS:
        plan = dict(plan_base)
        if n_sh == 2:
            plan["lm_twin"] = dict(n=lm_run.n_workers, P=lm_agg_row["P"],
                                   row_ids=[2, 5], reps=3)
            plan["lm"] = (lm_cfg, lm5)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = MESH.spawn(mesh_rank, n_sh, plan, device="cuda")
        spawn_wall = time.perf_counter() - t0
        mesh_runs[n_sh] = mesh_checks(n_sh, ranks, spawn_wall, hist,
                                      lm5_hist, lm5_wall, lm_run.n_workers,
                                      lm_agg_row["P"])
        del ranks

    # ---- 22. the arena's headline cell: the five Table-I mechanisms ------
    lap("22")
    torch.cuda.empty_cache()
    arena, arena_shapes = arena_phase()
    arena_agg_rows, arena_sgd_rows = arena_kernel_rows(arena_shapes, gen,
                                                       spec, dev)

    # ---- 23. the convergence bound, card vs CPU ---------------------------
    lap("23")
    bound = bound_phase()

    # ---- 24. a SIGKILL mid-run, and the resume -----------------------------
    lap("24")
    sigkill = sigkill_phase(build_dir / "chip_smoke_sigkill")

    # ---- 25. LM snapshot -> resume -> serve --------------------------------
    lap("25")
    torch.cuda.empty_cache()
    lm_snap = lm_snapshot_phase(build_dir / "chip_smoke_lm_snapshots")

    # ---- 26. the hybrid LM fleet at full width, 3 of 26 layers -------------
    lap("26")
    hybrid, hy_flash, hy_agg = hybrid_fleet_phase(gen, dev, lm_mech)
    flash_ulps = max(flash_ulps, hy_flash["max_bf16_ulps"])
    agg_err = max(agg_err, hy_agg["max_abs_err"])

    # ---- 27. the hybrid smoke geometry, card vs CPU (seq 128 > window 64) --
    lap("27")
    hybrid["card_vs_cpu_loss_gap"] = lm_card_vs_cpu(
        lm_mech, recurrentgemma_2b.get_smoke_config(), "hybrid", seq=128)

    # ---- 28. serving recurrentgemma-2b at full size ------------------------
    lap("28")
    hybrid["serving"] = full_serve_phase(recurrentgemma_2b.get_config(),
                                         "recurrentgemma")
    hybrid["serving"]["card_vs_cpu"] = serve_gaps["recurrentgemma"]

    # ---- 29. training the moe family ---------------------------------------
    lap("29")
    moe_train, moe_row = moe_train_phase(gen, dev, lm_mech)

    # ---- 30. serving paligemma-3b at full size (text only) -----------------
    lap("30")
    from repro_torch.configs import paligemma_3b, seamless_m4t_medium
    vlm = {"serving": full_serve_phase(paligemma_3b.get_config(),
                                       "paligemma")}

    # ---- 31. paligemma-3b's loss at full width, 256 stub prefix tokens -----
    lap("31")
    vlm_kept, vlm_calls = {}, Counter()
    vlm["loss"] = full_loss_phase(paligemma_3b.get_config(), "paligemma",
                                  VLM_LOSS["batch"], VLM_LOSS["text"], dev,
                                  vlm_kept, vlm_calls)
    # the prefix keeps attention off flash, as it keeps the JAX package's
    # off its Pallas kernel
    check(not any(vlm["loss"]["launches"].values()) and not vlm_kept,
          f"a kernel launched on the prefix-LM's path: "
          f"{vlm['loss']['launches']}")

    # ---- 32. the vlm smoke geometry, card vs CPU ---------------------------
    lap("32")
    vlm["card_vs_cpu"] = family_card_vs_cpu(
        paligemma_3b.get_smoke_config(), "paligemma", seq=48)

    # ---- 33. serving seamless-m4t-medium at full size ----------------------
    lap("33")
    ed_kept, ed_calls = {}, Counter()
    encdec = {"serving": encdec_serve_phase(ed_kept, ed_calls)}

    # ---- 34. seamless-m4t-medium's loss at full width ----------------------
    lap("34")
    sm_cfg = seamless_m4t_medium.get_config()
    encdec["loss"] = full_loss_phase(sm_cfg, "seamless",
                                     ENCDEC_LOSS["batch"], ENCDEC_LOSS["seq"],
                                     dev, ed_kept, ed_calls)
    check(encdec["loss"]["launches"]["flash_attention"]
          == sm_cfg.n_enc_layers + sm_cfg.n_layers
          and encdec["loss"]["launches"]["flash_attention"]
          == sum(encdec["loss"]["launches"].values()),
          f"seamless loss: launches {encdec['loss']['launches']}, expected "
          f"flash once per encoder and decoder layer and nothing else")
    ed_rows = {key: flash_path_row(
        key, ins, ed_calls[key],
        ("encoder (non-causal)" if not key[4] else "decoder (causal)")
        + f" {list(key[1])}") for key, ins in ed_kept.items()}
    check({(k[1], k[4]) for k in ed_rows} == {
        ((ENCDEC_SERVE["batch"], 16, 128, 64), False),
        ((ENCDEC_LOSS["batch"], 16, 128, 64), False),
        ((ENCDEC_LOSS["batch"], 16, ENCDEC_LOSS["seq"], 64), True)},
        f"seamless flash shapes: {sorted(k[1:] for k in ed_rows)}")
    encdec["flash"] = list(ed_rows.values())
    del ed_kept, vlm_kept
    torch.cuda.empty_cache()

    # ---- 35. the enc-dec smoke geometry, card vs CPU -----------------------
    lap("35")
    encdec["card_vs_cpu"] = family_card_vs_cpu(
        seamless_m4t_medium.get_smoke_config(), "seamless", seq=64)

    # ---- 36. the legacy sim path at the defaults ---------------------------
    lap("36")
    legacy, legacy_agg_rows = legacy_sim_phase(hist, dev)

    # ---- 37. the legacy sim path, card vs CPU, and its resume --------------
    lap("37")
    legacy["card_vs_cpu_and_resume"] = legacy_card_cpu_phase(
        build_dir / "chip_smoke_legacy")

    # ---- 38. the legacy LM path, smollm-135m at full width -----------------
    lap("38")
    legacy["lm"], legacy_flash = legacy_lm_phase(
        lm_mech, lm_cfg, dataclasses.replace(lm_run, n_rounds=5))

    # ---- 39. the trainer ---------------------------------------------------
    lap("39")
    train, train_flash = train_phase(build_dir / "chip_smoke_train")

    # ---- 40. activation recomputation on the trainer at full width ---------
    lap("40")
    remat, remat_flash = remat_phase()

    # ---- 41. the pods plane: stacked and 4 gloo ranks ----------------------
    lap("41")
    pods, pods_agg_rows, pods_flash = pods_phase()

    # ---- 42. a counted step against its time -------------------------------
    lap("42")
    counted, counted_rows = counted_phase(smi)

    # ---- 43. the chaos twin, the examples, the chunked prefix-LM ----------
    lap("43")
    tools = {"chaos": chaos_phase(build_dir / "chip_smoke_chaos"),
             "examples": examples_phase(),
             "chunked_vlm_loss": chunked_loss_phase(dev)}

    # ---- 44. the repaired backward and decode, card vs CPU ----------------
    lap("44")
    repairs = repair_phase()

    # ---- 45. stablelm-1.6b sharded over a (data, model) mesh of ranks -----
    lap("45")
    sharded, sharded_flash = sharded_phase(smi, build_dir / "chip_smoke_shard")
    lap("end")
    # each group of later phases' wall, from when it and the next began
    group_walls = {f"{key}_wall_s": phase_starts[b] - phase_starts[a]
                   for key, a, b in (("phases_26_29", "26", "30"),
                                     ("phases_30_35", "30", "36"),
                                     ("phases_36_39", "36", "40"),
                                     ("phases_40_41", "40", "42"),
                                     ("phase_42", "42", "43"),
                                     ("phase_43", "43", "44"),
                                     ("phase_44", "44", "45"),
                                     ("phase_45", "45", "end"))}

    new_flash = list(ed_rows.values()) + [legacy_flash, train_flash,
                                          remat_flash, pods_flash,
                                          sharded_flash]
    new_flash += [r for r in counted_rows if "kv_heads" in r]
    ssd_err = max([ssd_err] + [r["max_abs_err"] for r in counted_rows
                               if "kv_heads" not in r])
    flash_ulps = max([flash_ulps] + [r["max_bf16_ulps"] for r in new_flash])
    flash_err = max([flash_err] + [r["max_abs_err"] for r in new_flash])
    agg_err = max([agg_err] + [r["max_abs_err"] for r in legacy_agg_rows
                               + pods_agg_rows])

    top_agg, top_sgd = agg_rows[0], sgd_rows[0]
    kernels = [
        {"name": "aggregate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:220",
         "launches": launches["aggregate"], "max_abs_err": agg_err,
         "shape": {k: top_agg[k] for k in ("k", "u", "col_sparse")},
         "ms": top_agg["ms"], "kernel_ms": top_agg["ms"],
         "plain_ms": top_agg["plain_ms"], "bound_ms": top_agg["bound_ms"],
         "bound_by": top_agg["bound_by"],
         "library_ms": top_agg["library_ms"], "call_ms": top_agg["call_ms"],
         "lm": lm_agg_row,
         "shapes": agg_rows + [lm_agg_row, m_agg_row, big_row],
         "arena_shapes": arena_agg_rows,
         "arena_launches": {m: r["launches"]["aggregate"]
                            for m, r in arena["mechanisms"].items()},
         "floor": agg_floor},
        {"name": "fused_sgd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_sgd.cu",
         "replaces": "src/repro/kernels/fused_sgd.py:112",
         "launches": launches["fused_sgd"], "max_abs_err": sgd_err,
         "shape": {k: top_sgd[k] for k in ("k", "with_losses")},
         "ms": top_sgd["ms"], "kernel_ms": top_sgd["ms"],
         "plain_ms": top_sgd["plain_ms"], "bound_ms": top_sgd["bound_ms"],
         "bound_by": top_sgd["bound_by"], "library_ms": None,
         "call_ms": top_sgd["call_ms"], "floor": sgd_floor,
         "shapes": sgd_rows, "arena_shapes": arena_sgd_rows,
         "arena_launches": {m: r["launches"]["fused_sgd"]
                            for m, r in arena["mechanisms"].items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:102",
         "launches": lm_launches["flash_attention"], "max_abs_err": flash_err,
         "max_bf16_ulps": flash_ulps,
         "shape": {k: flash_row[k] for k in ("shape", "kv_heads", "dtype",
                                             "causal")},
         "ms": flash_row["ms"], "kernel_ms": flash_row["ms"],
         "plain_ms": flash_row["plain_ms"], "bound_ms": flash_row["bound_ms"],
         "bound_by": flash_row["bound_by"],
         "library_ms": flash_row["library_ms"],
         "call_ms": flash_row["call_ms"],
         "shapes": [{k: r[k] for k in (
             "label", "shape", "kv_heads", "causal", "window", "softcap",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library", "max_bf16_ulps", "library_bf16_ulps") if k in r}
             for r in flash_rows]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk.py:62",
         "launches": m_launches["ssd_chunk"], "max_abs_err": ssd_err,
         "shape": {"G_H_Q_N_P": ssd_row["shape"]},
         "ms": ssd_row["ms"], "kernel_ms": ssd_row["ms"],
         "plain_ms": ssd_row["plain_ms"], "bound_ms": ssd_row["bound_ms"],
         "bound_by": ssd_row["bound_by"], "library_ms": None,
         "call_ms": ssd_row["call_ms"]},
        {"name": "moe_router", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_router.cu",
         "replaces": "src/repro/kernels/moe_router.py:49",
         "launches": g_launches["moe_router"], "max_abs_err": router_err,
         "shape": {"T_E_k": router_rows[0]["shape"]},
         "ms": router_rows[0]["ms"], "kernel_ms": router_rows[0]["ms"],
         "plain_ms": router_rows[0]["plain_ms"],
         "bound_ms": router_rows[0]["bound_ms"],
         "bound_by": router_rows[0]["bound_by"], "library_ms": None,
         "call_ms": router_rows[0]["call_ms"], "kimi": router_rows[1],
         "floor": router_floor},
    ]
    kernels += mesh_kernel_rows(mesh_runs, sgd_floor)
    kernels += [
        {"name": "flash_attention", "path": "hybrid fleet (phase 26)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:102",
         "launches": hy_flash["launches"],
         "max_abs_err": hy_flash["max_abs_err"],
         "max_bf16_ulps": hy_flash["max_bf16_ulps"],
         **{k: hy_flash[k] for k in (
             "shape", "kv_heads", "window", "softcap", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library",
             "library_bf16_ulps")}},
        {"name": "aggregate", "path": "hybrid fleet (phase 26)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:220",
         "launches": hy_agg["launches"], "max_abs_err": hy_agg["max_abs_err"],
         **{k: hy_agg[k] for k in ("k", "u", "col_sparse", "P", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}},
        moe_row]
    for key, row in ed_rows.items():
        if key[1][0] == ENCDEC_LOSS["batch"] and not key[4]:
            continue               # the loss's encoder call: in "encdec"
        kernels.append({
            "name": "flash_attention",
            "path": ("seamless serving, encoder (phase 33)" if not key[4]
                     else "seamless loss, decoder (phase 34)"),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "launches": row["calls"], **{k: row[k] for k in (
                "max_abs_err", "max_bf16_ulps", "shape", "kv_heads",
                "causal", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library", "library_bf16_ulps")}})
    for r in legacy_agg_rows:
        kernels.append({
            "name": "aggregate",
            "path": "legacy sim, the dense per-leaf entry (phase 36)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/aggregate.cu",
            "replaces": "src/repro/kernels/aggregate.py:220",
            "entry": "src/repro/kernels/aggregate.py:52",
            **{k: r[k] for k in ("launches", "max_abs_err", "k", "n_in", "P",
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
    for r in pods_agg_rows:
        kernels.append({
            "name": "aggregate", "path": r["label"] + " (phase 41)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/aggregate.cu",
            "replaces": "src/repro/kernels/aggregate.py:220",
            **{k: r[k] for k in ("launches", "max_abs_err", "k", "n_in", "P",
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
    for r in counted_rows:
        kernels.append({
            "name": ("flash_attention" if "kv_heads" in r else "ssd_chunk"),
            "path": r["label"], "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/flash_attention.cu"
                       if "kv_heads" in r else
                       "src/repro_torch/kernels/csrc/ssd_chunk.cu"),
            "replaces": ("src/repro/kernels/flash_attention.py:102"
                         if "kv_heads" in r else
                         "src/repro/kernels/ssd_chunk.py:62"),
            "launches": r.get("calls", r.get("launches")),
            **{k: r[k] for k in ("max_abs_err", "shape", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}})
    kernels.append({
        "name": "flash_attention", "path": sharded_flash["label"]
        + " (phase 45)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:102",
        "launches": sharded_flash["launches_per_rank"][0],
        **{k: sharded_flash[k] for k in (
            "launches_per_rank", "max_abs_err", "max_bf16_ulps",
            "max_bf16_ulps_at_offset", "q_offset", "shape", "kv_heads",
            "causal", "ms", "ms_at_offset", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library")}})
    for r in (legacy_flash, train_flash, remat_flash, pods_flash):
        kernels.append({
            "name": "flash_attention", "path": r["label"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "launches": r["calls"], **{k: r[k] for k in (
                "max_abs_err", "max_bf16_ulps", "shape", "kv_heads",
                "causal", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library", "library_bf16_ulps")}})
    print(json.dumps({"mesh": {
        "backend": "gloo", "device": "cuda:0 shared by every rank",
        "sim_config": "SimConfig() defaults with mesh_shards=S, "
                      "DySTop(V=10.0, t_thre=20)",
        "lm_config": "phase 8's smollm-135m config at n_rounds=5, "
                     "mesh_shards=2",
        "unsharded_sim_wall_s": sim_wall,
        "shards": {str(k_): {**v, "twins": [t["max_abs_err"]
                                            for t in v["twins"]]}
                   for k_, v in mesh_runs.items()}}}))
    print(json.dumps({"aggregate_shapes": agg_rows}))
    print(json.dumps({"fused_sgd_shapes": sgd_rows}))
    print(json.dumps({"lm": {
        "config": "smollm-135m get_config() (30 layers), LMRunConfig("
                  "n_workers=8, n_rounds=30, batch=4, seq=256, adam, "
                  "lr=1e-3, eval_every=5), DySTop(V=3.0, t_thre=10, "
                  "max_neighbors=3)",
        "P": lm_agg_row["P"], "rounds": lm_hist.rounds[-1],
        "rows_trained": int(sum(lm_hist.round_active)),
        "wall_s": lm_wall, "setup_wall_s": lm_hist.setup_wall_s,
        "plan_wall_s": lm_hist.plan_wall_s,
        "pack_wall_s": lm_hist.pack_wall_s,
        "stage_wall_s": lm_hist.stage_wall_s,
        "drain_wall_s": lm_hist.drain_wall_s,
        "eval_wall_s": lm_hist.eval_wall_s, "launches": lm_launches,
        "flash_shapes": {str(s_[1:]): c for s_, c in lm_shapes.items()
                         if s_[0] == "flash_attention"},
        "aggregate_shapes": {str(s_[1:]): c for s_, c in lm_shapes.items()
                             if s_[0] == "aggregate"},
        "loss_global_first": float(lossg[0]),
        "loss_global_last": float(lossg[-1]),
        "loss_global": lossg.tolist(),
        "max_memory_allocated_bytes": lm_peak, **lm_busy,
        "card_vs_cpu_loss_gap": lm_gap, "flash": flash_row,
        "aggregate": lm_agg_row}}))
    print(json.dumps({"mamba2": {
        "config": "mamba2-2.7b get_config() at n_layers=8 (of 64), "
                  "LMRunConfig(n_workers=8, n_rounds=20, batch=4, seq=512, "
                  "adam, lr=1e-3, eval_every=5), DySTop(V=3.0, t_thre=10, "
                  "max_neighbors=3)",
        "P": p_m, "rounds": m_hist.rounds[-1],
        "rows_trained": int(sum(m_hist.round_active)),
        "wall_s": m_wall, "setup_wall_s": m_hist.setup_wall_s,
        "plan_wall_s": m_hist.plan_wall_s,
        "pack_wall_s": m_hist.pack_wall_s,
        "stage_wall_s": m_hist.stage_wall_s,
        "drain_wall_s": m_hist.drain_wall_s,
        "eval_wall_s": m_hist.eval_wall_s, "launches": m_launches,
        "ssd_shapes": {str(s_[1:]): c for s_, c in m_shapes.items()
                       if s_[0] == "ssd_chunk"},
        "aggregate_shapes": {str(s_[1:]): c for s_, c in m_shapes.items()
                             if s_[0] == "aggregate"},
        "largest_masked_exponent": m_expo,
        "loss_global": m_loss.tolist(),
        "max_memory_allocated_bytes": m_peak, **m_busy,
        "card_vs_cpu_loss_gap": m_gap, "ssd_chunk": ssd_row,
        "aggregate": m_agg_row}}))
    print(json.dumps({"serving": {
        "config": "grok-1-314b get_config() at n_layers=4 (of 64), "
                  "ServeEngine(batch_slots=8, max_len=512, seed=0), "
                  "ARRIVAL_PRESETS['steady'] on the wall clock",
        "params": sum(t.numel() for t in tree_leaves(R.init_params(
            g_cfg, None))),
        "init_wall_s": g_init_wall, "init_peak_bytes": g_init_peak,
        "max_memory_allocated_bytes": g_peak, "drive_wall_s": g_wall,
        "ticks": g_ticks, "ms_per_tick": g_tick_ms,
        "step_wall_s": sum(step_s), "launches": g_launches,
        **{k: v for k, v in dataclasses.asdict(g_rep).items()
           if k not in ("outputs", "finish_order")},
        "profiled_drive_wall_s": prof_rep[1],
        "profiled_makespan_s": prof_rep[0].makespan_s,
        "profiled_ticks": list(g_edges), "profiled_wall_s": g_prof_wall,
        "device_busy_s": g_busy,
        "device_busy_share": (None if g_busy is None
                              else g_busy / g_prof_wall),
        "device_top_kernels": g_top, **g_extra,
        "card_vs_cpu": serve_gaps, "moe_router": router_rows}}))
    print(json.dumps({"arena": {
        "config": "benchmarks/arena.py::main's phi0.4/clean cell with "
                  "run_mech's settings: " + json.dumps(ARENA_CFG)
                  + ", mechanisms " + json.dumps(ARENA_MECHS), **arena}}))
    print(json.dumps({"convergence": bound}))
    print(json.dumps({"sigkill_resume": sigkill}))
    print(json.dumps({"lm_snapshot": lm_snap}))
    print(json.dumps({"hybrid": hybrid}))
    print(json.dumps({"moe_train": moe_train}))
    print(json.dumps({"vlm": vlm}))
    print(json.dumps({"encdec": encdec}))
    print(json.dumps({"legacy": {**legacy, "aggregate": legacy_agg_rows,
                                 "flash": legacy_flash}}))
    print(json.dumps({"train": {**train, "flash": train_flash}}))
    print(json.dumps({"remat": {**remat, "flash": remat_flash}}))
    print(json.dumps({"repairs": repairs}))
    print(json.dumps({"pods": {**pods, "aggregate": pods_agg_rows,
                               "flash": pods_flash}}))
    print(json.dumps({"counted": counted}))
    print(json.dumps({"sharded": {**sharded, "flash": sharded_flash}}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"script": {"wall_s": time.perf_counter() - t_script,
                                 **group_walls,
                                 "phase_starts_s": phase_starts}}))
    print(json.dumps({"sim": {
        "config": "SimConfig() defaults, DySTop(V=10.0, t_thre=20)",
        "rounds": hist.rounds[-1], "evals": len(hist.rounds),
        "wall_s": sim_wall, "setup_wall_s": hist.setup_wall_s,
        "plan_wall_s": hist.plan_wall_s, "pack_wall_s": hist.pack_wall_s,
        "stage_wall_s": hist.stage_wall_s, "drain_wall_s": hist.drain_wall_s,
        "eval_wall_s": hist.eval_wall_s, "acc_first": float(acc[0]),
        "acc_final": float(acc[-1]), "sim_time_s": hist.sim_time[-1],
        "comm_gb": hist.comm_gb[-1], "card_vs_cpu_acc_gap": acc_gap,
        "device_busy_s": busy_s,
        "device_busy_share": None if busy_s is None else busy_s / sim_wall,
        "device_top_kernels": busy_top}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sim-child"]:       # phase 24's killed run
        sys.exit(sim_child(sys.argv[2]))
    sys.exit(main())
