#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Twenty-two phases, each printing JSON lines; any failure exits non-zero.

1. env/build — the card, its power limit, the torch and CUDA versions; TF32
   off for matmuls and convolutions; the CUDA kernels built with nvcc from
   the sources in this checkout (one nvcc per source, all started
   together), with ptxas's registers and spills and, where cuobjdump is
   there, the attention and SSD libraries' tensor-core (HMMA), ldmatrix
   and cp.async instruction counts, and the HMMA of each instance that
   must run them (HMMA_REQUIRED: TF32 in every float32 attention instance
   and every SSD instance, bf16 too in the SSD's bfloat16 ones; none may
   lack them).
2. kernels — every kernel of the two paths against its plain PyTorch
   version on the card (float32 and bfloat16, the paths' shapes, ragged
   row counts and one large shape), and its time from CUDA-graph replay
   (back to back as ``stream_ms``) beside the plain version's, the least
   time the card could take (``bound_ms``) and, where one PyTorch call
   computes the same function, that call's (``library_ms``, back to back:
   ``torch.quantize_per_channel`` cannot be captured).  The
   calibrated-update kernels agree with their plain versions to an ulp; the
   quantize kernels exactly (codes, values and masks).  The card's
   per-launch floor: an empty kernel (``EMPTY_KERNEL``, built here with
   the kernels' nvcc flags), timed from CUDA-graph replay and back to
   back, the least a launch of any kernel costs.
3. main path — ``FederatedSimulation.run(5, eval_every=5)`` at the full
   width of the paper's non-convex task (mlp 60-64-10, batch 20, FedProx
   synthetic(1,1), 10 clients, the bimodal K schedule: nine clients at
   K = 2, one at K = 200; lr 0.03, λ = 1) for fedavg, fedprox, fednova and
   fedagrac.  Every local step must go through a kernel (launch counters),
   and the trajectory must match the same run on the CPU.
4. compressed path — the same simulation with wire compression, on the
   compression bench's sync workload (benchmarks/compression_bench.py: lr
   on FedProx synthetic(1,1) from zero weights, n = 610, lr 0.02, λ = 1,
   error feedback on, top-k 5 %): fedagrac and fedavg with each of int8,
   int4, topk and topk+int8 on the uplink, fedagrac with topk+int8 up and
   an int8 broadcast, and fedavg topk+int8 on phase 3's mlp task, 5 rounds
   each.  Every codec call must go through the quantize kernels (exact
   launch counts), the recorded wire bytes must equal the bytes model, and
   the trajectory must match the same run on the CPU.

5. attention kernel — the flash-attention forward kernel (on the tensor
   cores: bfloat16 products, float32 as three TF32 products) against its
   plain version on the card, float32 and bfloat16, ``o`` and ``lse``, at the
   serving path's shapes (llama3-8b at the largest prefill bucket, a
   ragged bucket fill), ragged MHA, gemma-2b's MQA with head dim 256, a
   sliding window, one long shape, phase 8's local-step and eval shapes
   and phase 10's shared attention block (head dim 80, MHA); head dims
   that are not multiples of 16 on rows that are not 16-byte aligned
   (36, 77, 98, and 35 cut from rows of 64), views of a fused QKV buffer,
   and Skv ≠ Sq with rows that see no key, so that every copy width of
   both dtypes runs.  ``kernel_time`` lines at the path's shape, the long
   shape, phase 10's (4, 128) prefill and phase 8's local step, timed from
   CUDA-graph replay, with the bound (float32: at a third of the TF32
   tensor-core peak, and at the SIMT peak beside it; its tensor-core work
   as ``mma_ops``) and the time of ``scaled_dot_product_attention`` as a
   yardstick (the port never calls it).  Then phases 19's, 20's and 22's
   prefill instances (``ATTN_SERVE_SHAPES``), checked in both dtypes and
   timed in bfloat16 beside SDPA (under gemma3's window with the window as
   an explicit mask): deepseek-v2-lite's MLA at Dqk 192 / Dv 128,
   granite's GQA at head dim 64, gemma3-12b's local layers at S = 2048,
   window 1024; musicgen-medium's MHA (24 heads of 64) and qwen2-vl-2b's
   GQA 12 / 2 at head dim 128, each at 4 × 512; qwen1.5-32b's MHA (40
   heads of 128) at 4 × 512.  Then phase 21's
   training instances (``ATTN_TRAIN_SHAPES``, the client axis folded into
   B), checked in both dtypes and timed in the dtype phase 21 runs them:
   granite's f32 step (4, 128, 16, 8, 64), MLA's bf16 step (2, 256, 16,
   16, 192 → 128), gemma3's bf16 local layer at (2, 2048, 16, 8, 256)
   window 1024; and phase 21's other forward shapes, checked only
   (``ATTN_TRAIN_CHECKED``: the evals, gemma3's global layer, the tests'
   cuts).
6. serving path — ``ServeEngine`` on llama3-8b at full width and depth
   (32 layers, d 4096, 32 / 8 heads, d_ff 14336, vocab 128256) in
   bfloat16, random weights from a seed: 8 requests whose prompts cover
   every prefill bucket, 4 slots, max_len 512.  Every prefill's 32
   attention calls must launch the kernel and no decode tick may; prints
   time to first token, prefill and decode tokens/s and wall per tick.
   Then the same model in float32, cut to 2 layers, serves 4 requests on
   the card and is held against the CPU teacher-forced with the card's
   tokens.

7. attention backward — the dq and dk/dv kernels against their plain
   versions on the card, float32 and bfloat16, at the training path's
   shape (gemma-2b: 4 rows of 128 tokens, 8 heads, 1 kv head, head dim
   256), MHA, llama3-8b's GQA, ragged lengths, a sliding window, Skv ≠ Sq,
   one long shape, the --small model's step, zamba2's MHA at head dim 80,
   head dims whose bfloat16 rows start on 8-, 4- and 2-byte boundaries
   (36, 98, 77) and a view of a fused QKV buffer, so that every head-dim
   bucket, copy width and group path of the tensor-core kernels (bfloat16
   on bf16 products, float32 on 3×TF32 ones) runs.  ``kernel_time`` lines
   at the path's shape and the long one, timed from CUDA-graph replay,
   with the bound (float32: at a third of the TF32 peak, and at the SIMT
   peak beside it), the kernels' tensor-core work, and the time of
   ``scaled_dot_product_attention``'s backward, also from graph replay
   (the port never calls it).  ``dkv_group`` lines: the dk/dv kernel's
   two ways of summing a GQA/MQA group, float32 and bfloat16, each forced
   and checked, timed against each other at four shapes beside the one
   the wrapper picks.  Phase 21's training shapes are among the checked
   and timed ones (``ATTN_BWD_TRAIN``: granite's f32 step, MLA's at Dqk
   192 / Dv 128 and gemma3's local layer at window 1024, both dtypes;
   SDPA's backward under a window takes it as an explicit mask), and its
   other steps' shapes among the checked ones.
8. federated LM training — ``FederatedSimulation.run(3, eval_every=3)`` of
   the LM example (``repro_torch.examples.fed_lm_train``) on gemma-2b at
   full width (d 2048, 8 heads / 1 kv head, head dim 256, d_ff 16384,
   vocab 256000) in float32, cut to 2 layers and 2 clients, for fedagrac
   and fedavg: exact launch counts of the forward, dq, dk/dv and
   calibrated-update kernels, a finite loss, held-out perplexity below the
   vocab, wall per round and tokens/s; the calibrated-update kernel
   against its plain version at the run's (2, P) client matrix, and timed
   there.  Then the example's --small model on the card against the
   CPU.
9. SSD kernel — the Mamba2 chunked-scan kernel (on the tensor cores, every
   chunk a block, the blocks chained through the state) against its plain
   version on the card, float32 and bfloat16 (x, B and C read in place from
   one conv-output tensor), y and the final state within 2e-4 of each
   one's largest entry, at zamba2-2.7b's prefill shapes (one chunk, two, a
   ragged 100), grouped B/C, P = N = 128, a ragged 77 and one long shape
   (32 chunks); ``kernel_time`` lines at the path's shape and the long
   shape, timed from CUDA-graph replay (back to back as ``stream_ms``),
   with the bound (a third of the TF32 peak; the SIMT one beside it) and
   the tensor-core work (``mma_ops``; no PyTorch call computes the SSD: no
   yardstick).  Then the four SSD backward kernels (``ssd_scan_bwd.cu``:
   dstate, chain, chunk, reduce; dstate and chunk on the tensor cores,
   chain and reduce SIMT float32) against the plain chunked
   VJP (``ref.ssd_chunked_bwd``) on the card, float32 and bfloat16, every
   gradient (dx, ddt, dA, dB, dC) within SSD_BWD_TOL of its largest entry
   (dA SSD_BWD_DA_TOL, a bfloat16 one one bfloat16 ulp more), at the same
   shapes — strided conv-output slices, one chunk, 32 chunks, grouped,
   P = N = 128, ragged — and at the training path's folded shape with one
   A per row, dS_last zero and not, after the forward's chunk-entry
   states are held to the plain ones; ``kernel_time`` lines of each
   backward kernel at the path's shape and the long one from CUDA-graph
   replay, with its bound (the VJP's own tensors it moves, or its
   operations at the peaks of their operand types; the traffic of the
   intermediates between the kernels beside it, ``intermediate_ms``), its plain stage's time and the plain
   backward's (autograd of ``ref.ssd_chunked``, ``plain_ms``), the
   tensor-core work of dstate and chunk (``mma_ops``), and a line of the
   four together against the whole VJP's bound; then the four again at the
   path's shape in each dtype, every gradient bit-equal to the first
   run's.
10. hybrid inference — zamba2-2.7b at full width and depth (54 Mamba2
   layers, a shared attention block after every 6, d 2560, 80 SSM heads,
   d_ff 10240, vocab 32000) in bfloat16, random weights from a seed,
   through ``serve_prefill`` and ``serve_decode``: prefills of 4 × 128,
   2 × 256 and 1 × 100 tokens, each followed by 32 greedy decode steps
   (max_len 512).  Every prefill must launch the SSD kernel 54 times and
   the attention kernel 9 times, no decode step either; prints prefill
   tokens/s, wall per decode step, decode tokens/s and peak memory.  Then
   the same model in float32, cut to 12 layers (two groups), on the card
   against the CPU, teacher-forced with the card's tokens.
11. population path — partial participation and the paper's CNN and
   quadratics.  (a) ``benchmarks/population_bench.py``'s setting (read
   from its source, not imported) at its largest population: 100,000
   clients, a ``uniform`` cohort of 8 a round, FedaGrac (λ 0.5, lr 0.05,
   K 4, batch 16) on the mlp 60-64-10 (P = 4608) over
   ``gaussian_classification`` data, 2 samples a client, 48 rounds in
   chunks of 12, the 1.84 GB ν⁽ⁱ⁾ store on the card: exactly 4 × 48
   calibrated-update launches, peak device memory under 1.5 × the store
   + 256 MB (a round that copied the store would not fit), every drawn
   client's ν⁽ⁱ⁾ row written and no other; then M = 1024 at the same
   cohort, its ms per round printed beside.  (b) the
   ``partial_participation`` example's task (M = 256, C = 8, lr model, K
   4) for fedagrac under ``uniform``, ``round_robin``, ``weighted`` and
   ``availability`` (0.7) and fednova under ``uniform`` with ν decay 0.3,
   5 rounds each, on the card against the CPU by phase 3's rule, the same
   cohorts on both, and those the reference draws (``reference_quick.json``
   ``cohorts``).  (c) the paper's CNN at full width (P = 21888) on
   ``image_classification`` data, 6000 images over 10 clients by DP1 (α
   0.3), nine clients at K = 2 and one at 20, fedagrac and fedavg for 3
   rounds against the CPU, exactly 20 launches a round; the
   calibrated-update kernel against its plain version at the two paths'
   (8, 4608) and (10, 21888) matrices, timed from CUDA-graph replay; and
   the ``objective_inconsistency`` twin on the card: FedAvg ends at the
   closed-form fixed point and FedaGrac at x*, each within QUAD_TOL.
12. paper twins — the ``--quick`` twins of the paper's experiments
   (``repro_torch.benchmarks``: thm1, table1, table2, fig2, fairness)
   through their ``main`` on the card, their CSV rows printed, and the
   ``continuous_batching`` twin.  The lr rows (table1's, table2,
   fairness) against the reference's quick rows
   (``src/repro_torch/benchmarks/reference_quick.json``): accuracies
   within PATH_SAMPLES samples, rounds to target equal unless the
   reference sat within PATH_SAMPLES samples of the target up to its
   crossing; thm1's distances within QUAD_TOL of the reference's, FedAvg
   at its closed-form fixed point and FedaGrac at x*.  The mlp rows
   (table1's, fig2) against the same runs on the CPU by phase 3's rule,
   each printed beside the reference's row.  Exactly one
   calibrated-update launch a local step of every round (k_max × rounds
   of each run), the prox kernel's for fedprox runs, and the attention
   kernel once a layer in each of the serving twin's prefills.
13. buffered asynchrony — ``BufferedAsyncSimulation`` (fed/async_engine.py)
   and compression on the cohort and buffered rounds.  (a) the
   ``table_async`` twin's ``main(quick=True)`` on the card, in a worker
   process started with phase 12 (both are host-bound and run side by
   side; phase 13 collects it): its rows (all
   lr) against the reference's quick rows by phase 12's rule, its buffer =
   M run at fixed speeds against its own synchronous FedaGrac run by phase
   3's rule (the spread from a rerun of that run on the card with reversed
   rows), one B1 launch a local step of every run.  (b) the table's fleet
   (10 clients, lognormal speeds σ = 1, K = 40) on benchmarks/common.py's
   lr and mlp tasks at full width: buffered FedaGrac (λ 0.5, buffer 8,
   hinge), FedBuff (fedavg, buffer 5), FedaGrac's buffer with an int8
   uplink and broadcast and with a top-k uplink, 10 updates each, on the
   card against the CPU by phase 3's rule (the mlp's ReLU branches
   sampled by relabelled reruns as in phase 12), exact B1 / B3-B5
   launches and wire bytes, every buffer with a client reporting twice;
   the int8 run twice on the card, equal to the last bit.  (c) phase 11's
   population setting on the buffered engine (8 clients in flight, a
   buffer of 8, K 4, 48 updates in chunks of 12) at M = 100,000 and 1024,
   ms per update at both; an int8 uplink at 100,000; then the compressed
   cohort round (int8) at 100,000: exact launches, every reporter's ν⁽ⁱ⁾
   row written and no other, peak device memory under 1.5 × the (M, P)
   stores (ν⁽ⁱ⁾, the anchor buffers `A` and `N`, the error-feedback rows)
   + 256 MB, so that no update copies one.
14. failure scenarios and robust aggregation (fed/scenarios.py,
   core/robust.py).  (a) the ``scenario`` and ``robust`` twins'
   ``main(quick=True)`` on the card, side by side (both are host-bound:
   the robust twin runs in a worker process) — the buffered engine under
   dropout, spikes, flaky networks and diurnal availability; the
   synchronous engine under NaN injection, scale and sign-flip attacks,
   undefended and with a median or trimmed-mean defense and a
   quarantine: every row
   (lr) against the reference's quick row by phase 12's rule, the abort
   fractions, survival and quarantine counts equal, one B1 launch a local
   step of every run.  (b) ``dropout``, ``spike``, ``flaky`` and
   ``diurnal`` (with the ``availability`` sampler) on the mlp, each on
   the synchronous and the buffered engine (the lognormal fleet, K 40),
   card against CPU by phase 3's rule with relabelled reruns,
   ``History.dropped`` and the simulated times equal to the CPU's.  (c)
   phase 11's population setting under a scale attack on the int8 wire,
   defended by a trimmed mean with a quarantine, at M = 100,000 and 1024:
   exact launches, ms per round flat in M, peak memory under 1.5 × the
   (M, P) stores + 256 MB (no round copies ν⁽ⁱ⁾, the error-feedback rows
   or the health vectors); then each defense against none at M = 100,000,
   wall per round, the aten ops and the implicit host syncs a round
   issues.  Before (a): the attack and every defense's stages issue no
   implicit host sync on the card (``set_sync_debug_mode("error")``).
15. the device-sampled, checkpointed path (data.DeviceBatcher, the device
   chunks of core/engine.py, checkpoint/).  (a) the card's
   ``DeviceBatcher`` indices of 48 rounds of phase 11's uniform cohort of
   8 at M = 100,000 equal ``fed/keyed.py``'s numpy indices element for
   element, and the cohorts equal the reference's committed ones.  (b)
   the device-mode population chunk (cohorts, batches and k′ drawn in the
   chunk) at M = 100,000 and 1024, K 4, chunks of 8, 48 rounds: ms per
   round at both beside phase 11's host-mode rounds, peak memory over the
   ν⁽ⁱ⁾ store, exactly K B1 launches a round; then under ``dropout``
   through the in-chunk ``scenario_fn``, ``History.dropped`` equal to the
   CPU's.  (c) resume: 24 rounds on the int8 wire under a scale attack
   whose corrupt set is not empty, defended by a trimmed mean with a
   quarantine, at M = 1024, saved, loaded into a fresh simulation and run
   24 more, equal to 48 rounds on one simulation bit for bit (B1, B3, B4
   counted); then ``checkpoint.save`` / ``load`` of the M = 100,000 state
   timed (bytes, seconds, GB/s), where the disk has the room.  (d) the
   ``failure_scenarios`` example twin on the device batcher: its rows
   against the reference's (``reference_quick.json`` ``examples``), the
   abort fractions equal, one B1 launch a local step.
16. personalized serving fed by bf16 training over a float32 master
   (``FedConfig.master_dtype``, serving/personalized.py).  (a) phase 8's
   run (gemma-2b at full width, 2 of 18 layers, 2 clients, 3 rounds of
   fedavg and fedagrac) in bfloat16 over the float32 master: the master
   float32 and the views bfloat16, finite losses, exact launches (the
   forward, dq and dk/dv kernels in bfloat16 once a layer a local step,
   the forward once a layer an eval, B1 once a local step); fedagrac's
   state published as a snapshot (v3), one more round, published again
   (v4); the example's --small --bf16 model on the card against the CPU
   by phase 3's rule (CPU reruns with reversed rows, then with the
   master's weights moved by a bfloat16 ulp or two, until the card is
   covered).  (b) ``PersonalizedServeEngine`` (4 slots) on the trained
   model, for "none", "nu" and "lowrank" (rank 2, factored on the card;
   the factors hold the ν rows within LOWRANK_TOL): a trace of requests
   from both clients and a cold start, the swap to v4 while a long
   request is in flight, against the same trace without the swap —
   requests admitted before the swap keep their tokens, every completion
   records its version; "none" bit-equal (tokens and logits) to the plain
   ``ServeEngine``; the personalized slots' logits differ from the base's
   (the scale sets the deltas' RMS to PERSONAL_DELTA_RMS of the base's,
   printed); a row-path tick within ROW_TICK_ULPS of per-slot batch-1
   decodes; each decode path's tick wall; the attention kernel once a
   layer an admission; peak memory against its reckoning (60·P bytes).
   (c) the ``personalized_serving`` example twin at --small on the card
   against the CPU: the completions and versions equal, the card's logits
   against the CPU's snapshot rows teacher-forced with the card's tokens
   by phase 6's rule.  (d) the ``serving_bench`` twin's quick run:
   requests/s at M = 32, 1,000 and 100,000 and its flatness check.
17. hybrid training — ``FederatedSimulation.run(3, eval_every=3)`` of the
   LM example on zamba2-2.7b at full width (d 2560, 80 SSM heads of dim
   64, one group of d_state 64, chunk 128, 32 attention heads of dim 80,
   d_ff 10240, vocab 32000) in float32, cut to 12 of 54 layers (two
   groups: the shared block applied twice), 2 clients, batch 2, seq 256
   (two SSD chunks), lr 0.003, fedagrac and fedavg, then fedagrac in
   bfloat16 over a float32 master: exactly one SSD forward and one launch
   of each backward kernel per Mamba2 layer per local step for both
   clients (12 × k_max × rounds, the forward 12 more for the eval), the
   attention forward, dq and dk/dv twice a step (the forward twice more),
   B1 once a step, and no other; a finite loss, a held-out perplexity
   below the initial weights' (printed beside the vocab), wall per round,
   tokens/s and peak memory.  Then the
   reduced model (4 layers, d 128, chunk 16, two groups) at seq 32 and
   lr 0.03 on the card against the CPU by phase 8's rule.
18. tree layout — ``param_layout="tree"``, ``FedConfig``'s default, whose
   local steps are plain torch leaf by leaf (no calibrated-update launch)
   and whose wire crosses the flat view table: (a) phase 8's gemma-2b cut
   and inputs, fedagrac, against phase 8's flat run (reused, not run
   again) by phase 8's rule (the spread of a tree rerun with reversed
   sequences), the attention launches as phase 8 counts them and no
   other, wall per round and peak memory beside phase 8's; (b) phase 3's
   main path, TREE_ROUNDS rounds of the nine algorithms, FedAvgM and
   FedAdam, against the CPU by phase 3's rule (relabelled reruns where the
   mlp's branches need them, C14), no launch; (c) phase 4's compressed
   workload, one run of each codec and the int8 broadcast: exact quantize
   launches and wire bytes, against the CPU; (d) phase 13's setting at M =
   1024, a cohort run in chunks and a buffered run, against the CPU; (e)
   ``track_nu="explicit"`` and ``quantize_transmit`` (fedagrac_first with
   a prox term) on each layout against the CPU, the flat round one
   calibrated-update launch a local step.

19. MoE, MLA and sliding-window serving — each model at full width and
   depth in bfloat16 behind ``ServeEngine``, random weights from a seed
   drawn one expert at a time, one model at a time (the one before freed,
   each one's peak memory printed).  (a) deepseek-v2-lite-16b (27 layers,
   MLA kv_lora 512, 64 experts top-6 + 2 shared, ≈32.4 GB): 4 slots,
   buckets (64, 128, 256), prompts of 37, 101, 190 and 256 tokens, 16 new
   each; exactly 27 attention launches an admission (Dqk 192, Dv 128),
   none in decode; TTFT, prefill / decode tokens/s, wall per tick, and
   the MoE assignments dropped per admission and per tick at the config's
   capacity factor 1.25 (a tick of 4 slots has capacity 1, C19); then at
   capacity factor NO_DROP_CAPACITY (nothing drops) the absorbed decode's
   logits against a no-cache forward of the same tokens and against the
   naive decode teacher-forced with its tokens, within BF16_LOGIT_RTOL;
   then a float32 cut (2 layers, d 256, the full routing) on the card
   against the CPU, served on both with the card's tokens, by phase 6's
   rule.  (b) granite-moe-1b-a400m (24 layers, 32 experts top-8): the
   same timing run and card-against-CPU check.  (c) gemma3-12b (48
   layers, 5:1 local:global, window 1024, head dim 256, vocab 262,144,
   ≈23.6 GB): 2 slots, a prompt of 1020 tokens filling its bucket (its
   decode crosses the local rings' end) and one of 2048 (the rings'
   whole-ring gather), 16 new each, 48 attention launches an admission;
   the 1020 prompt's logits against a no-cache forward; the 2048 prompt's
   printed (behind the engine its pad mask empties every local ring slot,
   C20) and, through ``serve_prefill`` / ``serve_decode``, checked
   against a no-cache forward.
20. xLSTM and the audio and vision front ends — the models the engine
   refuses (as the reference's does), through ``serve_prefill`` /
   ``serve_decode``, each at full width and depth in bfloat16, random
   weights from a seed, one at a time (the one before freed, each one's
   peak memory printed), batches from ``roofline/serve_profile.py``'s
   ``prompt_batch``: (a) xlstm-125m (12 layers, 3 mLSTM + 1 sLSTM a
   group, d 768, 4 heads): a prefill of 4 × 512 tokens and 16 greedy
   steps, no kernel launched (xLSTM runs outside any kernel, as in the
   reference); prefill ms, ms a step, tokens/s; the served logits against
   a no-cache forward of the same tokens by ``BF16_LOGIT_*``; one row of
   2048 tokens whose prefill logits are finite, and on it the first mLSTM
   layer's parallel form against the recurrence in float32 within
   MLSTM_RECURRENCE_RTOL, with the rows where the reference's form
   overflows to NaN (C21) counted.  (b) musicgen-medium (48 layers, 4
   codebooks): 4 rows × 4 codebooks × 512 codes, each step feeding back
   every codebook's argmax as (B, K, 1); exactly 48 attention launches a
   prefill and none a step.  (c) qwen2-vl-2b (28 layers, M-RoPE): 4 rows
   of 512 seeded embeddings, a 16 × 16 image grid (positions (0, i // 16,
   i % 16)) then 256 text positions from 16 on, each step feeding back
   ``embed[token]`` at the next text position; exactly 28 attention
   launches a prefill and none a step.  Each: decode against a no-cache
   forward, and a float32 cut (xLSTM one group of 4 layers, the others 2
   layers) at full width on the card against the CPU, 2 rows × 128, 8
   steps, teacher-forced with the card's ids, by phase 6's rule.

21. the MoE, MLA, sliding-window and xLSTM families trained — each
   through the LM example's flat round (``_run_fed_lm``) at full width,
   random weights from a seed, depth and clients cut to the card
   (FAMILY_TRAIN; 2 rounds, lr 0.003, 2 clients): granite-moe-1b-a400m
   (8 of 24 layers, 32 experts top-8, float32, fedagrac and fedavg,
   batch 2 × 128), deepseek-v2-lite-16b (1 of 27 layers, MLA and 64
   experts top-6 + 2 shared, bfloat16 over the float32 master, fedagrac,
   batch 1 × 256), gemma3-12b (one local layer at window 1024 and one
   global, bfloat16 over the master, fedavg, batch 1 × 2048, one
   held-out row), xlstm-125m uncut (float32, fedagrac, batch 2 × 128):
   exact launches (B6 once an attention layer a local step for both
   clients and once more in the eval, B7's two kernels once an attention
   layer a step, B1 once a step, no other), finite losses and
   perplexities, peak memory under FAMILY_PEAK_BYTES, wall per round,
   tokens/s.  Then each model's tests' cut (2 layers, d 64, vocab 256)
   on the card against the CPU by phase 8's rule, with CPU reruns that
   change only rounding drawn until the card is covered.

22. the launch layer's serving steps on a torch.distributed mesh — a
   one-rank group (gloo and NCCL on a ``HashStore``) and a ``(1, 1)``
   ("data", "model") ``DeviceMesh`` on the card; qwen1.5-32b uncut in
   bfloat16 (70.4 GB of weights made on the card from a seed) placed by
   ``serve_specs`` as DTensors without a copy (the peak after placement
   within PLACE_SLACK of the weights), 4 × 512 tokens through
   ``build_prefill`` into caches of 1024 slots, then 16 greedy steps
   through ``build_decode``: prefill ms, ms a step, tokens/s, the peak,
   the device's busy share of 4 profiled steps; exactly 64 B6 launches a
   prefill and none a step; decode against a no-cache forward within
   BF16_LOGIT_*; the prefill's logits against the plain
   ``serve_prefill`` on the same weights; a float32 cut (1 of 64 layers
   at full width, 2 × 128, 8 steps) on the card's mesh against a CPU
   mesh of the same group by phase 6's rule.
23. the launch layer's training round on the same kind of mesh —
   llama3-8b at full width (2 of 32 layers, P ≈ 1.487 B) in bfloat16 over
   a float32 flat master, one client of two rows at seq 4096, k_max 2,
   through ``launch.train.build_train_round``: three rounds as a chunk of
   2 and its tail of 1 (the length-polymorphic chunk), exactly k_max ×
   rounds B1 launches and a B6, dq and dk/dv launch a layer a step; the
   chunk bit-equal to three single rounds on the mesh and to
   ``make_flat_round`` on plain tensors; one tree-layout bfloat16 round
   equal to ``make_round``'s; wall per round and per local step,
   tokens/s, the busy share of one profiled round, peak memory, the host
   seconds a round over the plain round's (DTensor's); a reduced float32
   cut through the same chunk on the card's mesh against a CPU mesh by
   phase 8's rule.

Each phase prints its seconds.  Then the card's name and power limit, a
``{"kernels": [...]}`` line (the nine Pallas sites' kernels, the bf16
instances timed on phase 16's path and on phases 19's, 20's and 22's six
models' (their launches), phase 21's and 23's training instances of B6
and B7 (granite's f32, MLA's, gemma3's and llama3-8b's bf16, with their
runs' launches), and
the four SSD backward kernels, which
replace autodiff of
``src/repro/models/mamba2.py:74``), and
last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
LR, LAM, MU = 0.03, 0.7, 0.1
MAIN_SHAPES = {"lr": (10, 640), "mlp": (10, 4608)}
# (8, P): phase 13's buffers of 8 reports (and phase 11's cohort of 8)
CHECK_SHAPES = [(10, 640), (10, 4608), (8, 640), (8, 4608), (3, 128),
                (1000, 384), (65536, 1024)]
TIMED_SHAPES = [(10, 640), (10, 4608), (8, 640), (8, 4608), (65536, 1024)]
# the quantize kernels' shapes: the broadcast (1, P) and client (10, P) rows
# of the lr and mlp tasks, phase 13's buffer rows (8, P), ragged row
# counts, and one large shape
WIRE_SHAPES = [(1, 640), (10, 640), (10, 4608), (8, 640), (8, 4608),
               (3, 128), (1000, 384), (65536, 1024)]
WIRE_MAIN_SHAPE = (10, 640)          # the compressed path's client rows
PAD = 30                             # true columns n = cols − PAD
TIE_SCALE = 0.125                    # a power of two: x / s is exact
# the kernel does the plain version's float32 arithmetic, one rounding per
# operation in the same order, so both agree to the last bit; the stated
# tolerance (as in tests/test_kernels.py) leaves room for one ulp
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8}
# The main path on the card against the same run on the CPU.  Both see the
# same data, batches and initial weights and differ only in float32
# rounding (cuBLAS and the CPU's BLAS sum in other orders).  How far
# rounding alone moves this trajectory is measured, not assumed: a second
# CPU run takes every microbatch with its rows reversed — the same loss (a
# mean over the rows) with other roundings — and the card must stay within
# PATH_SPREAD times that spread, plus a float32-scale floor (PATH_RTOL
# relative; PATH_SAMPLES of the 4000 eval samples, for logits that tie to
# within rounding).  On a contractive run the spread is float32 noise and
# the check is tight; a run that amplifies rounding has a wide spread, in
# the JAX package as here, and the check says so instead of failing on it.
PATH_SPREAD, PATH_RTOL, PATH_SAMPLES = 4.0, 1e-4, 4
# Phase 4's runs: (task, algorithm, uplink, broadcast compressor); the
# "none" runs are the uncompressed walls the compressed ones are set beside
COMPRESSED_RUNS = (
    ("lr", "fedagrac", "none", "none"), ("lr", "fedavg", "none", "none"),
    *(("lr", algo, comp, "none") for algo in ("fedagrac", "fedavg")
      for comp in ("int8", "int4", "topk", "topk+int8")),
    ("lr", "fedagrac", "topk+int8", "int8"),
    ("mlp", "fedavg", "none", "none"), ("mlp", "fedavg", "topk+int8", "none"))
# Phase 5's shapes (B, S, H, Hkv, D, window): llama3-8b at the engine's
# largest prefill bucket and at a ragged bucket fill, ragged MHA, gemma-2b's
# MQA and head dim, a sliding window, the long shape for timing, and phase
# 8's: a local step of gemma-2b (2 clients × batch 2 folded into B) and its
# held-out eval (8 sequences), and the --small model's (4 clients × batch
# 2, and the eval), and phase 10's: zamba2-2.7b's shared attention block
# (MHA 32 / 32 heads of dim 80) at its three prefills; and head dims that
# are not multiples of 16 (36: rows on 8-byte boundaries in bfloat16; 77:
# on 2-byte ones, 4-byte ones in float32; 98: on 8-byte ones in float32),
# zero-filled by the kernels
ATTN_SHAPES = [(1, 256, 32, 8, 128, 0), (1, 200, 32, 8, 128, 0),
               (2, 77, 4, 4, 64, 0), (1, 128, 8, 1, 256, 0),
               (1, 512, 4, 2, 64, 128), (1, 4096, 32, 8, 128, 0),
               (4, 128, 8, 1, 256, 0), (8, 128, 8, 1, 256, 0),
               (8, 32, 2, 1, 32, 0), (4, 128, 32, 32, 80, 0),
               (2, 256, 32, 32, 80, 0), (1, 100, 32, 32, 80, 0),
               (2, 77, 4, 4, 36, 0), (1, 64, 4, 2, 77, 0),
               (2, 64, 4, 2, 98, 0)]
ATTN_PATH_SHAPE = (1, 256, 32, 8, 128, 0)
# the LM training step's shape (phases 8 and 16)
ATTN_STEP_SHAPE = (4, 128, 8, 1, 256, 0)
ATTN_TIMED = [ATTN_PATH_SHAPE, (1, 4096, 32, 8, 128, 0),
              (4, 128, 32, 32, 80, 0), ATTN_STEP_SHAPE]
# Phases 19's and 20's prefill instances (B, S, H, Hkv, Dqk, Dv, window),
# checked in both dtypes and timed in bfloat16: deepseek-v2-lite's MLA at
# its largest bucket (q and k of dn + dr = 128 + 64, v of dv = 128),
# granite-moe's GQA 16 / 8 at head dim 64 there, gemma3-12b's local layers
# at a 2048-token prefill (GQA 16 / 8, head dim 256, window 1024);
# musicgen-medium's MHA 24 / 24 at head dim 64 and qwen2-vl-2b's GQA 12 / 2
# (a group of 6) at head dim 128, each at phase 20's 4 × 512 prefill;
# qwen1.5-32b's MHA 40 / 40 at head dim 128 at phase 22's 4 × 512 prefill;
# the kernels line names them by model
ATTN_SERVE_SHAPES = {"mla_bf16": (1, 256, 16, 16, 192, 128, 0),
                     "granite_bf16": (1, 256, 16, 8, 64, 64, 0),
                     "gemma3_bf16": (1, 2048, 16, 8, 256, 256, 1024),
                     "musicgen_bf16": (4, 512, 24, 24, 64, 64, 0),
                     "qwen2vl_bf16": (4, 512, 12, 2, 128, 128, 0),
                     "qwen15_bf16": (4, 512, 40, 40, 128, 128, 0)}
# Phase 21's training instances (B, S, H, Hkv, Dqk, Dv, window) with the
# client axis folded into B, checked in both dtypes and timed in the dtype
# phase 21 trains them in: granite-moe's GQA 16 / 8 at head dim 64 (2
# clients × 2 rows × 128, float32), deepseek-v2-lite's MLA at Dqk 192 / Dv
# 128 (2 clients × 1 row × 256, bfloat16 over the float32 master) and
# gemma3-12b's local layer at window 1024 (2 clients × 1 row × 2048,
# bfloat16); the kernels line names them by model and dtype
ATTN_TRAIN_SHAPES = {
    "granite_train_f32": ((4, 128, 16, 8, 64, 64, 0), torch.float32),
    "mla_train_bf16": ((2, 256, 16, 16, 192, 128, 0), torch.bfloat16),
    "gemma3_train_bf16": ((2, 2048, 16, 8, 256, 256, 1024), torch.bfloat16),
    # phase 23's llama3-8b local step (1 client × 2 rows, seq 4096)
    "llama3_train_bf16": ((2, 4096, 32, 8, 128, 128, 0), torch.bfloat16)}
# and the rest of phase 21's forward shapes, checked in both dtypes: the
# evals' (8 held-out rows; gemma3's one row, whose local layer is
# ATTN_SERVE_SHAPES' gemma3), gemma3's global layer, and the tests' cuts
# on the card (4 clients × 2 rows: granite, deepseek's MLA at 48 → 32,
# gemma3's local and global layers at seq 32)
ATTN_TRAIN_CHECKED = [(8, 128, 16, 8, 64, 64, 0), (8, 256, 16, 16, 192, 128, 0),
                      (2, 2048, 16, 8, 256, 256, 0),
                      (1, 2048, 16, 8, 256, 256, 0), (8, 16, 2, 2, 32, 32, 0),
                      (8, 16, 2, 2, 48, 32, 0), (8, 32, 2, 2, 32, 32, 16),
                      (8, 32, 2, 2, 32, 32, 0)]
ATTN_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# The float32 forward's tiles, copied from csrc/flash_attention.cu
# (tests/test_torch_build.py holds each against the source): q tiles of
# FWD_TF32_BLOCK_ROWS rows, kv tiles of FWD_TF32_BLOCK_KEYS[bucket] keys;
# above FWD_TF32_WIDE_HEAD_DIM two warps share each 16 rows, both taking S
FWD_TF32_BLOCK_ROWS = 64
FWD_TF32_BLOCK_KEYS = {64: 64, 80: 64, 128: 32, 256: 32}
FWD_TF32_WIDE_HEAD_DIM = 128
# Views of one fused QKV buffer (B, S, H, Hkv, D, window, lead elements
# before q in each row): llama3-8b's widths, a head dim of 36 under a
# window (8-byte rows in bfloat16), and one-element leads (2-byte rows) at
# head dims 40 and 256
ATTN_FUSED_SHAPES = [(1, 256, 32, 8, 128, 0, 0), (2, 77, 4, 2, 36, 16, 0),
                     (1, 64, 4, 2, 40, 0, 1), (1, 96, 2, 1, 256, 0, 1)]
# Head dims cut from wider rows (B, S, H, Hkv, D, window, row width): 35
# of 64, 16-byte rows whose last chunk holds 6 bytes of the head, and 120
# of 128 under a window
ATTN_CUT_SHAPES = [(2, 100, 1, 1, 35, 0, 64), (1, 64, 1, 1, 120, 16, 128)]
# Sq ≠ Skv (B, Sq, Skv, H, Hkv, D, window): Skv < Sq under a window, where
# the late rows see no key (o = 0), and Skv > Sq
ATTN_CROSS_SHAPES = [(1, 160, 96, 4, 1, 64, 48), (2, 200, 70, 8, 2, 128, 32),
                     (1, 96, 160, 4, 2, 64, 0)]
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 494.7e12          # H100 SXM dense TF32 tensor cores
# Phase 7's shapes (B, Sq, Skv, H, Hkv, D, window): the training path's
# (gemma-2b, 2 clients × batch 2 folded into B, S 128, MQA, head dim 256),
# MHA, llama3-8b's GQA g = 4, ragged lengths, a sliding window, Skv > Sq
# and Skv < Sq (late rows under the window see no key), the long shape, and
# the --small model's local step (4 clients × batch 2, head dim 32), and
# for the bfloat16 kernels' copy widths and head-dim buckets: head dims 36,
# 98 and 77 (bfloat16 rows on 8-, 4- and 2-byte boundaries) and zamba2's
# MHA block (32 / 32 heads of dim 80) at its 4 × 128 prefill; then phase
# 21's training shapes (ATTN_BWD_TRAIN), gemma3's global layer and the
# tests' cuts on the card (ATTN_TRAIN_CHECKED's steps), an eighth entry Dv
# where v's head dim is not D (the others keep Dv = D)
ATTN_BWD_TRAIN = {
    "granite_train_f32": ((4, 128, 128, 16, 8, 64, 0), torch.float32),
    "mla_train_bf16": ((2, 256, 256, 16, 16, 192, 0, 128), torch.bfloat16),
    "gemma3_train_bf16": ((2, 2048, 2048, 16, 8, 256, 1024), torch.bfloat16),
    "llama3_train_bf16": ((2, 4096, 4096, 32, 8, 128, 0), torch.bfloat16)}
ATTN_BWD_SHAPES = [(4, 128, 128, 8, 1, 256, 0), (2, 128, 128, 4, 4, 64, 0),
                   (1, 256, 256, 32, 8, 128, 0), (2, 77, 77, 4, 2, 64, 0),
                   (1, 200, 200, 8, 2, 128, 0), (1, 512, 512, 4, 2, 64, 128),
                   (1, 96, 160, 4, 2, 64, 0), (1, 160, 96, 4, 1, 64, 48),
                   (1, 4096, 4096, 32, 8, 128, 0), (8, 32, 32, 2, 1, 32, 0),
                   (2, 77, 77, 4, 2, 36, 0), (2, 64, 64, 4, 1, 98, 0),
                   (1, 64, 64, 4, 2, 77, 0), (4, 128, 128, 32, 32, 80, 0),
                   *(shape for shape, _ in ATTN_BWD_TRAIN.values()),
                   (2, 2048, 2048, 16, 8, 256, 0), (8, 16, 16, 2, 2, 32, 0),
                   (8, 16, 16, 2, 2, 48, 0, 32), (8, 32, 32, 2, 2, 32, 16),
                   (8, 32, 32, 2, 2, 32, 0)]
# a view of a fused QKV buffer (B, S, H, Hkv, D, window, lead): one
# element before q in each row (2-byte rows) at gemma-2b's MQA head dim
ATTN_BWD_FUSED_SHAPES = [(2, 96, 4, 1, 256, 0, 1)]
ATTN_BWD_PATH_SHAPE = (4, 128, 128, 8, 1, 256, 0)
ATTN_BWD_TIMED = [ATTN_BWD_PATH_SHAPE, (1, 4096, 4096, 32, 8, 128, 0),
                  *(shape for shape, _ in ATTN_BWD_TRAIN.values())]
# GQA/MQA shapes at which the dk/dv kernel's two ways of summing a group
# (ops.dkv_split picks one) are timed against each other: S = 4096
# and 8 × 512 (512 blocks when one loops over a group), llama3-8b's
# 1 × 256 prefill and gemma-2b's training step (32 and 8)
ATTN_BWD_GROUP_SHAPES = [(1, 4096, 4096, 32, 8, 128, 0),
                         (8, 512, 512, 32, 8, 128, 0),
                         (1, 256, 256, 32, 8, 128, 0), ATTN_BWD_PATH_SHAPE]
# The backward kernels' shape of work, copied from
# csrc/flash_attention_bwd.cu and csrc/tf32_tiles.cuh
# (tests/test_torch_build.py holds each against the source): bfloat16 P
# and dS split into kPieces bfloat16 pieces; every float32 product taken
# as kTerms TF32 products (3×TF32); the head-dim buckets launch_mma and
# launch_tf32 pick (Dqk and Dv zero-filled up to one); above
# BWD_WIDE_HEAD_DIM dq splits each row's columns over two warps
# (kDqHalves) and dk/dv takes dk and dv in separate blocks (kPasses), in
# both dtypes
BWD_PIECES = 2
BWD_TF32_TERMS = 3
BWD_HEAD_BUCKETS = (64, 80, 128, 256)
BWD_WIDE_HEAD_DIM = 128
# The backward kernels sum the plain version's float32 terms in another
# order.  Against a float64 autograd reference the plain version's float32
# error is ≤ 1e-6 of each gradient's largest entry at S ≤ 1024; the kernels
# are held to 2e-5 of it (bfloat16: plus one bf16 ulp of the entry, the
# rounding of the same float32 value).
ATTN_BWD_TOL = 2e-5
# The kernel sums the plain version's float32 terms in another order:
# float32 o and lse agree to ~1e-6 relative; a bfloat16 o is that float32
# value rounded once, so the two may land one bf16 ulp (≤ 2⁻⁷·|o|) apart.
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# Phase 6: the engine's settings, and the card-against-CPU tolerance on
# float32 logits (std ≈ 1.3 with these random weights): cuBLAS and the
# CPU's BLAS sum dot products of up to 14336 float32 terms in other
# orders, ~1e-5 relative per layer; 1e-3 leaves an order of magnitude.
SERVE = {"slots": 4, "max_len": 512, "prefill_buckets": (32, 64, 128, 256)}
# (lowest, highest) prompt length of the timing run's 8 requests: every
# bucket twice, one prompt of 200-256 tokens
SERVE_PROMPTS = [(8, 32), (33, 64), (65, 128), (200, 256), (16, 32),
                 (40, 64), (90, 128), (129, 199)]
SERVE_CHECK_PROMPTS = [(20, 32), (50, 64), (100, 128), (200, 256)]
LOGIT_TOL = 1e-3
# Phase 8: the federated LM example (examples/fed_lm_train.py: Zipf
# topic-skewed streams, K_i ~ N(4, 2²), λ 0.5) on gemma-2b at full width in
# float32, cut to 2 of 18 layers and 2 of the example's 4 clients.  The
# example's lr 0.3 diverges at d_model 512, in the JAX package as in the
# port (ROADMAP C9: the perplexity passes 1e8 after one round, on the
# CPU); at d 1024 lr 0.03 already oscillates and lr 0.01 learns.  d 2048
# was not tried at those rates on the CPU (too large there), so the
# full-width run takes lr 0.003, a margin below the 0.01 that learned at
# d 1024.  The --small check keeps lr 0.3.
FED_LM = {"layers": 2, "clients": 2, "seq": 128, "batch": 2, "rounds": 3,
          "lr": 0.003, "algorithms": ("fedagrac", "fedavg")}

# Phase 9's shapes (b, l, h, p, g, n, chunk): zamba2-2.7b's SSD (80 heads
# of dim 64, one group of d_state 64, chunk 128) at phase 10's prefills —
# 4 prompts of 128 (one chunk), 2 of 256 (two: the inter-chunk carry), 1 of
# 100 (a ragged chunk) — and at 4 of 256, the path shape of the kernel's
# bound; grouped B/C; the kernel's limits P = N = 128; a ragged 77 with
# groups; P = 20 and N = 10, whose rows hold no whole 16-byte vectors (the
# kernel's element-by-element loads), over three chunks; one long shape
# (32 chunks) for timing
SSD_SHAPES = [(4, 256, 80, 64, 1, 64, 128), (4, 128, 80, 64, 1, 64, 128),
              (2, 256, 80, 64, 1, 64, 128), (1, 100, 80, 64, 1, 64, 128),
              (2, 64, 4, 16, 2, 8, 16), (1, 256, 4, 128, 1, 128, 128),
              (1, 77, 4, 16, 2, 8, 128), (2, 96, 4, 20, 2, 10, 32),
              (1, 4096, 80, 64, 1, 64, 128)]
SSD_PATH_SHAPE = (4, 256, 80, 64, 1, 64, 128)
SSD_TIMED = [SSD_PATH_SHAPE, (1, 4096, 80, 64, 1, 64, 128)]
# The SSD kernel's buckets of max(P, N), to which it zero-pads P and N,
# and its row tiles of 16 positions, copied from ssd_scan/csrc/ssd_scan.cu
# (tests/test_torch_build.py holds them against the source)
SSD_BUCKETS = (32, 64, 128)
SSD_ROW_TILE = 16
# The kernel sums the plain version's float32 terms in another order (for
# bfloat16 inputs too: both read the same values and compute in float32);
# y and the state are held to SSD_TOL of each tensor's largest entry, the
# reference's own tolerance (tests/test_ssd_kernel.py)
SSD_TOL = 2e-4
# Phase 10: zamba2-2.7b at full width and depth in bfloat16 — three prefill
# batches (rows, prompt length), each followed by greedy decode steps; then
# the float32 card-against-CPU check at 12 of 54 layers (two groups)
HYBRID = {"prompts": [(4, 128), (2, 256), (1, 100)], "decode_steps": 32,
          "max_len": 512, "check_layers": 12,
          "check_prompts": [(2, 256), (1, 100)], "check_steps": 8}
# Phase 9's backward: the four kernels of ssd_scan_bwd.cu against the plain
# chunked VJP (ref.ssd_chunked_bwd) on the card at every SSD_SHAPES shape
# (x, B and C slices of one conv output; P = N = 128, grouped, ragged,
# one chunk, 32 chunks) with dS_last nonzero, and at SSD_BWD_EXTRA: the
# training path's folded shape (phase 17: 2 clients × 2 rows) with one A
# per row, with dS_last zero too (a training loss reads no final state),
# and a grouped one with one A per row.  Each gradient is held to a
# fraction of its largest entry: SSD_BWD_TOL for the float32 ones (both
# sides sum float32 terms, in other orders; the kernel reads the forward
# kernel's states, which carry its TF32 splits); dA to SSD_BWD_DA_TOL,
# looser because dA sums ddA·dt over a head's positions, ddA the reverse
# cumsum of C·dC − xdt·d(xdt), two large terms that cancel (the float32
# plain version is itself 3e-4 of the largest entry from a float64 one at
# P = N = 128, tests/test_torch_ssd_backward.py); a bfloat16 dx, dB or dC
# also to SSD_BWD_BF16_TOL, one bfloat16 ulp of its largest entry: both
# sides round the same float32 sum once, and two sums a few float32 ulps
# apart can round to neighbouring bfloat16 values.
SSD_BWD_EXTRA = [(SSD_PATH_SHAPE, True, False), (SSD_PATH_SHAPE, True, True),
                 ((2, 64, 4, 16, 2, 8, 16), True, False)]
SSD_BWD_TOL = 1e-4
SSD_BWD_DA_TOL = 1e-3
SSD_BWD_BF16_TOL = 2.0 ** -7
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")
# Phase 17: zamba2-2.7b at full width in float32, cut to 12 of 54 layers
# (two groups: the shared attention block applied twice), through the LM
# example's simulation, phase 8's run (lr 0.003, ROADMAP C9) but at seq 256
# (two SSD chunks, so the backward's chain runs).  The random weights'
# logit spread puts the initial held-out perplexity above the vocab
# (a training loss of 10.89 nats against ln 32000 = 10.37), and twelve
# local steps at lr 0.003 do not bring it below: the check is that the
# held-out perplexity fell below the initial weights', both printed beside
# the vocab.  Then fedagrac in bfloat16 over the float32 master; then the
# 4-layer reduced model at seq 32 on the card against the CPU by phase 8's
# rule, with CPU reruns that change only rounding —
# reversed batch rows, then initial weights moved by a float32 ulp — drawn
# until the card is covered, at most HYBRID_TRAIN["max_probes"]; the CPU
# runs on one thread (ROADMAP C18: with several, two identical CPU runs of
# the reduced hybrid differ).  The reduced model runs at lr 0.03: at the
# example's 0.3 it is chaotic (two identical 8-thread CPU runs end 0.2
# apart after 3 rounds), which would make any spread-based check vacuous
HYBRID_TRAIN = {"layers": 12, "clients": 2, "seq": 256, "batch": 2,
                "rounds": 3, "lr": 0.003, "algorithms": ("fedagrac", "fedavg"),
                "small_layers": 4, "small_seq": 32, "small_lr": 0.03,
                "max_probes": 4}

# quantize-kernel launches of one codec call
CODEC_LAUNCHES = {
    "none": {}, "int8": {"quantize_2d": 1, "dequantize_2d": 1},
    "int4": {"quantize_2d": 1, "dequantize_2d": 1},
    "topk": {"topk_mask_2d": 1},
    "topk+int8": {"topk_mask_2d": 1, "quantize_2d": 1, "dequantize_2d": 1}}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters: int) -> float:
    """Device time per call over ``iters`` back-to-back calls (CUDA
    events), after a warm-up."""
    for _ in range(3):
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


def _graph_ms(fn, iters: int, stream=None) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so no host work sits between the launches (back-to-back
    calls from Python, as ``_time_ms`` times them, measure the host's issue
    rate wherever a call takes less device time than host time).  With
    ``stream``, the warm-up and the capture run on it: autograd issues a
    backward on the stream its forward ran on, so a backward is captured
    on that one."""
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def _ptxas_table(log: str) -> dict:
    """Registers and spill bytes of each kernel instance in an nvcc
    ``-Xptxas -v`` log, by mangled name."""
    table, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif fn and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            table[fn] = {"spill_stores": int(m[1]),
                         "spill_loads": int(m[2])}
        elif fn and "registers" in ln:
            table[fn]["registers"] = int(
                re.search(r"Used (\d+) registers", ln)[1])
    return table


def _hmma_counts(dump: str) -> dict:
    """Each kernel's tensor-core products with TF32 operands (HMMA ….TF32)
    and with bf16 ones (HMMA ….BF16), and all its instructions, in a
    ``cuobjdump -sass`` listing, by mangled name."""
    counts, fn = {}, None
    for ln in dump.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m[1]
            counts[fn] = {"hmma_tf32": 0, "hmma_bf16": 0, "instructions": 0}
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", ln):
            counts[fn]["instructions"] += 1
            if "HMMA" in ln:
                counts[fn]["hmma_tf32"] += "TF32" in ln
                counts[fn]["hmma_bf16"] += "BF16" in ln
    return counts


# The instances phase 1 requires tensor-core products of, by library: the
# name every instance of a kernel carries, and the HMMA kinds it must run
# (the SSD scan's and its backward chunk kernel's bfloat16 instances take
# C·Bᵀ in bf16, their float32 ones in TF32, and every other product in
# TF32)
HMMA_REQUIRED = {
    "flash_attention": {"flash_fwd_kernel_tf32": ("hmma_tf32",)},
    "flash_attention_bwd": {"dq_kernel_tf32": ("hmma_tf32",),
                            "dkv_kernel_tf32": ("hmma_tf32",)},
    "ssd_scan": {"ssd_scan_kernel_mmaIf": ("hmma_tf32",),
                 "ssd_scan_kernel_mmaI13__nv_bfloat16": ("hmma_tf32",
                                                        "hmma_bf16")},
    "ssd_scan_bwd": {"ssd_bwd_dstate_kernel": ("hmma_tf32",),
                     "ssd_bwd_chunk_kernelIf": ("hmma_tf32",),
                     "ssd_bwd_chunk_kernelI13__nv_bfloat16": ("hmma_tf32",
                                                             "hmma_bf16")},
}


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_env() -> dict:
    smi = _card_line()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in _build.SOURCES
             for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    # registers and spill bytes of each attention and SSD kernel instance,
    # and, where the toolkit has cuobjdump, each library's tensor-core
    # (HMMA), ldmatrix (LDSM) and cp.async (LDGSTS) instruction counts and
    # each required instance's HMMA by operand type (HMMA_REQUIRED)
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    attn = {}
    for lib, required in HMMA_REQUIRED.items():
        table = _ptxas_table(_build.build_log(lib))
        attn[f"{lib}_ptxas"] = table
        # spill bytes over the bfloat16 and float32 tensor-core instances
        for kind in ("_mma", "_tf32"):
            attn[f"{lib}{kind}_spill_bytes"] = sum(
                t["spill_stores"] + t["spill_loads"]
                for name, t in table.items() if kind in name)
        if cuobjdump.is_file():
            dump = subprocess.run(
                [str(cuobjdump), "-sass", str(_build.library_path(lib))],
                capture_output=True, text=True).stdout
            attn[f"{lib}_sass"] = {op: dump.count(op)
                                   for op in ("HMMA", "LDSM", "LDGSTS")}
            counts = _hmma_counts(dump)
            for kernel, kinds in required.items():
                found = {fn: n for fn, n in counts.items() if kernel in fn}
                attn[f"{kernel}_hmma"] = found
                _require(found and all(n[kind] > 0 for n in found.values()
                                       for kind in kinds),
                         f"{kernel} instances without {kinds} HMMA: "
                         f"{found}")
    env = {"phase": "env", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "nvcc_build_s": build_s, "built": sorted(built), "ptxas": ptxas,
           **attn}
    _emit(env)
    return env


def _operands(shape, dtype, gen):
    rows, cols = shape
    dev = DEVICE
    x, g, c, x0 = (torch.randn(rows, cols, generator=gen, device=dev
                               ).to(dtype) for _ in range(4))
    active = torch.arange(rows, device=dev) % 3 != 1
    eta = torch.where(active, LR, 0.0).to(torch.float32)
    return x, g, c, x0, eta, active


def _bound(inputs, out, ops_per_elem) -> tuple[float, str]:
    nbytes = sum(t.numel() * t.element_size() for t in inputs) \
        + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = out.numel() * ops_per_elem / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# phase 2's yardstick: a kernel that does nothing, launched as the port's
# kernels are (a C entry point taking the stream)
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
"""


def _launch_floor() -> dict:
    """The card's per-launch floor: ``EMPTY_KERNEL`` built with the port's
    nvcc flags into the build directory, its device time per launch from
    CUDA-graph replay (``graph_ms``) and back to back (``stream_ms``)."""
    import ctypes
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "empty_kernel.cu"
    lib_path = _build.BUILD_DIR / "libempty_kernel.so"
    src.write_text(EMPTY_KERNEL)
    t0 = time.perf_counter()
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    _require(done.returncode == 0, f"the empty kernel did not build: "
                                   f"{done.stdout}{done.stderr}")
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    lib.launch_empty.argtypes = [ctypes.c_void_p]
    lib.launch_empty.restype = ctypes.c_int

    def launch():
        rc = lib.launch_empty(ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))
        _require(rc == 0, f"the empty kernel's launch failed ({rc})")
    out = {"kernel": "empty", "graph_ms": _graph_ms(launch, 1000),
           "stream_ms": _time_ms(launch, 1000), "build_s": build_s}
    _emit({"phase": "kernels", "part": "launch_floor", **out})
    return out


def phase_kernels() -> dict:
    from repro_torch.kernels.calibrated_update import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    # (wrapper, plain version, operands for it, float32 ops per element);
    # the timed forms are the main path's: fedagrac passes c, fedprox none
    entries = {
        "calibrated_update": (
            ops.calibrated_update, ref.calibrated_update,
            lambda x, g, c, x0, eta: (x, g, c, eta, LAM), 4),
        "calibrated_update_prox": (
            ops.calibrated_update_prox, ref.calibrated_update_prox,
            lambda x, g, c, x0, eta: (x, g, None, x0, eta, 0.0, MU), 5),
    }
    result = {name: {"max_abs_err": 0.0} for name in entries}
    checks = []
    for name, (kernel, plain, args_of, n_ops) in entries.items():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in CHECK_SHAPES:
                x, g, c, x0, eta, active = _operands(shape, dtype, gen)
                forms = [args_of(x, g, c, x0, eta)]
                if name == "calibrated_update":
                    forms.append((x, g, None, eta, 0.0))
                else:
                    forms.append((x, g, c, x0, eta, LAM, MU))
                for args in forms:
                    got = kernel(*args)
                    want = plain(*args)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs()
                    tol = KERNEL_TOL[dtype] * (1 + want.float().abs())
                    max_err = float(err.max())
                    _require(bool((err <= tol).all()),
                             f"{name} {dtype} {shape}: max |err| {max_err}")
                    _require(torch.equal(got[~active], x[~active]),
                             f"{name} {dtype} {shape}: an η = 0 row moved")
                    result[name]["max_abs_err"] = max(
                        result[name]["max_abs_err"], max_err)
                    checks.append({"kernel": name, "dtype": str(dtype),
                                   "shape": shape,
                                   "c": args[2] is not None,
                                   "max_abs_err": max_err,
                                   "tol": KERNEL_TOL[dtype]})
                if shape not in TIMED_SHAPES:
                    continue
                args = args_of(x, g, c, x0, eta)
                big = shape[0] * shape[1] > 1 << 20
                iters = 20 if big else 500
                out = kernel(*args)
                inputs = [a for a in args if isinstance(a, torch.Tensor)]
                bound_ms, bound_by = _bound(inputs, out, n_ops)
                timing = {"kernel": name, "dtype": str(dtype),
                          "shape": shape,
                          "ms": _graph_ms(lambda: kernel(*args), iters),
                          "stream_ms": _time_ms(lambda: kernel(*args),
                                                iters),
                          "plain_ms": _graph_ms(lambda: plain(*args), iters),
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": None}
                _emit({"phase": "kernel_time", **timing})
                if dtype == torch.float32 and shape == MAIN_SHAPES["mlp"]:
                    result[name].update(
                        {k: timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")})
                del x, g, c, x0, eta, out
                torch.cuda.empty_cache()
    _emit({"phase": "kernels", "checks": len(checks),
           "max_abs_err": {n: r["max_abs_err"] for n, r in result.items()},
           "worst": max(checks, key=lambda ch: ch["max_abs_err"])})
    _launch_floor()
    return result


def check_update_at(rows: int, cols: int) -> dict:
    """B1 on the ``(rows, cols)`` float32 client matrix of a path (phase 8:
    gemma-2b's (2, 744.5 M)) against its plain version, in both forms the
    flat round launches (fedagrac's c, fedavg's none), compared in column
    slices so the comparison's temporaries stay small; then timed."""
    from repro_torch.kernels.calibrated_update import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    x, g, c = (torch.randn(rows, cols, generator=gen, device=DEVICE)
               for _ in range(3))
    active = torch.arange(rows, device=DEVICE) % 3 != 1
    eta = torch.where(active, LR, 0.0).to(torch.float32)
    tol = KERNEL_TOL[torch.float32]
    step = 1 << 26
    max_err = 0.0
    for c_arg in (c, None):
        got = ops.calibrated_update(x, g, c_arg, eta, LAM)
        want = ref.calibrated_update(x, g, c_arg, eta, LAM)
        torch.cuda.synchronize()
        for j in range(0, cols, step):
            gs, ws = got[:, j:j + step], want[:, j:j + step]
            err = (gs - ws).abs()
            ok = bool((err <= tol * (1 + ws.abs())).all())
            max_err = max(max_err, float(err.max()))
            _require(ok, f"calibrated_update float32 ({rows}, {cols}) "
                         f"c={c_arg is not None}: max |err| {max_err}")
        _require(torch.equal(got[~active], x[~active]),
                 f"calibrated_update ({rows}, {cols}): an η = 0 row moved")
        del got, want
        torch.cuda.empty_cache()
    args = (x, g, c, eta, LAM)
    bound_ms, bound_by = _bound([x, g, c, eta], x, 4)
    timing = {"kernel": "calibrated_update", "dtype": str(torch.float32),
              "shape": (rows, cols),
              "ms": _time_ms(lambda: ops.calibrated_update(*args), 5),
              "plain_ms": _time_ms(lambda: ref.calibrated_update(*args), 5),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": None}
    _emit({"phase": "kernel_check", "kernel": "calibrated_update",
           "dtype": str(torch.float32), "shape": (rows, cols),
           "forms": 2, "max_abs_err": max_err, "tol": tol})
    _emit({"phase": "kernel_time", **timing})
    del x, g, c, args
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **timing}


def _wire_rows(shape, dtype, qmax, gen):
    """(rows, cols) rows on the card with n = cols − PAD true columns and a
    poisoned pad tail (1e9).  Row 0 has its largest magnitude at
    qmax · TIE_SCALE, so its scale is exactly TIE_SCALE, and half of its
    true entries are exact .5 ties of x / s; with two or more rows, row 1
    is all zero in its true columns, so its scale is eps."""
    rows, cols = shape
    n = cols - PAD
    amax = qmax * TIE_SCALE
    x = 3.0 * torch.randn(rows, cols, generator=gen, device=DEVICE)
    half = n // 2
    codes = torch.randint(-qmax, qmax, (half,), generator=gen, device=DEVICE)
    x[0, :half] = (codes + 0.5) * TIE_SCALE
    x[0, half:n] = x[0, half:n].clamp(-amax, amax)
    x[0, 0] = amax
    if rows > 1:
        x[1, :n] = 0.0
    x[:, n:] = 1e9
    return x.to(dtype), n


def _library_wire(name, x, scale):
    """One PyTorch call that computes the kernel's function, or None: int8
    per-row quantization is ``torch.quantize_per_channel`` and its
    inverse ``.dequantize()`` (float32 only); no single call masks by a
    per-row threshold.  Timed here only; the port never calls them."""
    if name == "topk_mask_2d" or x.dtype != torch.float32:
        return None
    scales = scale[:, 0].double()
    zeros = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)

    def quantize():
        return torch.quantize_per_channel(x, scales, zeros, 0, torch.qint8)
    if name == "quantize_2d":
        return quantize
    qt = quantize()
    return qt.dequantize


def phase_wire_kernels() -> dict:
    from repro_torch.kernels.quantize import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    result = {name: {"max_abs_err": 0.0} for name in ops.launches}
    checks = []

    def check(name, got, want, dtype, shape, exact, **what):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = float(err.max()) if err.numel() else 0.0
        tol = 0.0 if exact else KERNEL_TOL[dtype]
        _require(bool((err <= tol * (1 + want.float().abs())).all()),
                 f"{name} {dtype} {shape} {what}: max |err| {max_err}")
        result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                          max_err)
        checks.append({"kernel": name, "dtype": str(dtype), "shape": shape,
                       **what, "max_abs_err": max_err, "tol": tol})

    for dtype in (torch.float32, torch.bfloat16):
        for shape in WIRE_SHAPES:
            for qmax in (7, 127):
                x, n = _wire_rows(shape, dtype, qmax, gen)
                scale = ops.row_scales(x, n, qmax)
                _require(float(scale[0]) == TIE_SCALE,
                         f"row 0 scale {float(scale[0])}, not {TIE_SCALE}")
                q = ops.quantize_2d(x, scale, qmax=qmax)
                # the codes are integers from the same float32 arithmetic
                check("quantize_2d", q, ref.quantize_2d(x, scale, qmax),
                      dtype, shape, True, qmax=qmax)
                half = n // 2
                _require(bool((q[0, 1:half].remainder(2) == 0).all()),
                         f"{dtype} {shape}: a .5 tie did not round to even")
                _require(shape[0] == 1 or not q[1, :n].any(),
                         f"{dtype} {shape}: the zero row has codes")
                out = ops.dequantize_2d(q, scale, out_dtype=dtype)
                check("dequantize_2d", out,
                      ref.dequantize_2d(q, scale, dtype), dtype, shape,
                      dtype == torch.float32, qmax=qmax)
            k = max(1, round(0.05 * n))
            thresh = ops.topk_thresholds(x, n, k)
            xm = x.clone()
            xm[-1, 1] = float("nan")            # a NaN is masked to 0
            masked = ops.topk_mask_2d(xm, thresh)
            check("topk_mask_2d", masked, ref.topk_mask_2d(xm, thresh),
                  dtype, shape, dtype == torch.float32, k=k)
            _require(float(masked[-1, 1]) == 0.0, "a NaN survived the mask")
            if shape not in TIMED_SHAPES:
                continue
            # x, scale and q are qmax 127's (the int8 path)
            timed = {
                "quantize_2d": (lambda: ops.quantize_2d(x, scale),
                                lambda: ref.quantize_2d(x, scale),
                                [x, scale], q, 4),
                "dequantize_2d": (
                    lambda: ops.dequantize_2d(q, scale, out_dtype=dtype),
                    lambda: ref.dequantize_2d(q, scale, dtype),
                    [q, scale], out, 1),
                "topk_mask_2d": (lambda: ops.topk_mask_2d(x, thresh),
                                 lambda: ref.topk_mask_2d(x, thresh),
                                 [x, thresh], masked, 2)}
            big = shape[0] * shape[1] > 1 << 20
            iters = 20 if big else 500
            for name, (kernel, plain, inputs, res, n_ops) in timed.items():
                bound_ms, bound_by = _bound(inputs, res, n_ops)
                library = _library_wire(name, x, scale)
                timing = {"kernel": name, "dtype": str(dtype),
                          "shape": shape,
                          "ms": _graph_ms(kernel, iters),
                          "stream_ms": _time_ms(kernel, iters),
                          "plain_ms": _graph_ms(plain, iters),
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          # back to back: quantize_per_channel cannot
                          # be captured in a CUDA graph
                          "library_ms": (None if library is None
                                         else _time_ms(library, iters))}
                _emit({"phase": "kernel_time", **timing})
                if dtype == torch.float32 and shape == WIRE_MAIN_SHAPE:
                    result[name].update(
                        {k: timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")})
            del x, xm, q, out, masked, timed
            torch.cuda.empty_cache()
    _emit({"phase": "wire_kernels", "checks": len(checks),
           "max_abs_err": {n: r["max_abs_err"] for n, r in result.items()},
           "worst": max(checks, key=lambda ch: ch["max_abs_err"])})
    return result


def _reverse_rows(batches: dict) -> dict:
    """Every microbatch with its rows in reverse order: the batch axis is
    the labels' last, whatever the shape of a feature row."""
    rows = batches["y"].dim() - 1
    return {"x": batches["x"].flip(rows), "y": batches["y"].flip(rows)}


def _batcher(data, parts, device: str, reverse_rows: bool,
             batch_size: int = 20):
    """The host batcher, or one that hands out every microbatch with its
    rows reversed (the same loss, other float32 roundings), full rounds
    and cohorts alike."""
    from repro_torch.data import FederatedBatcher

    class Batcher(FederatedBatcher):
        def round_batches(self, t, k_max):
            b = super().round_batches(t, k_max)
            return _reverse_rows(b) if reverse_rows else b

        def chunk_batches(self, t0, r, k_max):
            b = super().chunk_batches(t0, r, k_max)
            return _reverse_rows(b) if reverse_rows else b

        def cohort_batches(self, t, cohort, k_max):
            b = super().cohort_batches(t, cohort, k_max)
            return _reverse_rows(b) if reverse_rows else b

        def chunk_cohort_batches(self, t0, cohorts, k_max):
            b = super().chunk_cohort_batches(t0, cohorts, k_max)
            return _reverse_rows(b) if reverse_rows else b

    return Batcher(data, parts, batch_size=batch_size, seed=0,
                   device=device)


def _bimodal() -> np.ndarray:
    ks = np.full((1, 10), 2, np.int32)
    ks[0, -1] = 200
    return ks


def _vs_cpu_margins(g: dict, c: dict, p, n_eval: int = 4000) -> dict:
    """The card's run ``g`` against the CPU's ``c``: {metric: (diff, tol)},
    the tolerance PATH_SPREAD times the spread of the CPU rerun with
    reversed rows ``p`` (or, given a list of reruns that each change only
    float32 rounding, the largest of their spreads), plus the float32
    floor (the eval accuracy over ``n_eval`` samples counted in samples).
    Each tolerance only grows as reruns are added to the list."""
    probes = p if isinstance(p, list) else [p]

    def spread(diff):
        return np.max([diff(q) for q in probes], axis=0)

    vs = {"loss": (np.abs(g["loss"] - c["loss"]),
                   PATH_SPREAD * spread(lambda q: np.abs(q["loss"]
                                                         - c["loss"]))
                   + PATH_RTOL * np.abs(c["loss"])),
          "metric_samples": (
              n_eval * np.abs(g["metric"] - c["metric"]),
              PATH_SPREAD * n_eval * spread(
                  lambda q: np.abs(q["metric"] - c["metric"]))
              + PATH_SAMPLES),
          "params": (
              float((g["params"] - c["params"]).abs().max()),
              PATH_SPREAD * float(spread(
                  lambda q: float((q["params"] - c["params"]).abs().max())))
              + PATH_RTOL * float(c["params"].abs().max()))}
    return vs


def _vs_covered(vs: dict) -> bool:
    return all(bool(np.all(diff <= tol)) for diff, tol in vs.values())


def _vs_cpu(name: str, g: dict, c: dict, p, n_eval: int = 4000) -> dict:
    """``_vs_cpu_margins``, raising past a tolerance."""
    vs = _vs_cpu_margins(g, c, p, n_eval)
    for what, (diff, tol) in vs.items():
        _require(bool(np.all(diff <= tol)),
                 f"{name}: {what} differs from the CPU run by {diff}, "
                 f"more than {tol}")
    return vs


def _run_main_path(device: str, algorithms, data, parts, params0,
                   reverse_rows: bool = False) -> dict:
    from repro_torch.configs.base import FedConfig
    from repro_torch.fed import FederatedSimulation
    from repro_torch.kernels.calibrated_update import ops
    from repro_torch.models.simple import mlp_accuracy, mlp_loss

    x_eval, y_eval = data.x.to(device), data.y.to(device)
    ks = _bimodal()
    out = {}
    for algo in algorithms:
        fed = FedConfig(algorithm=algo, n_clients=10, lr=0.03,
                        calibration_rate=1.0, weights="data",
                        param_layout="flat")
        batcher = _batcher(data, parts, device, reverse_rows)
        sim = FederatedSimulation(
            mlp_loss, params0, fed, batcher, k_schedule=ks, device=device,
            eval_fn=lambda p: float(mlp_accuracy(p, {"x": x_eval,
                                                     "y": y_eval})))
        before = dict(ops.launches)
        hist = sim.run(5, eval_every=5)
        out[algo] = {
            "loss": np.array(hist.loss), "metric": np.array(hist.metric),
            "wall_per_round_s": float(np.mean(hist.wall)),
            "params": sim.state["params"].cpu(),
            "launches": {k: ops.launches[k] - before[k] for k in before}}
    return out


def _launch_counters() -> list:
    from repro_torch.kernels.calibrated_update import ops as cu_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return [cu_ops, q_ops, fa_ops, ssd_ops]


def _reset_all_launches() -> None:
    for mod in _launch_counters():
        mod.reset_launches()


def _all_launches() -> dict:
    return {name: n for mod in _launch_counters()
            for name, n in mod.launches.items()}


def phase_main_path() -> dict:
    from repro_torch.data import fedprox_synthetic
    from repro_torch.kernels.calibrated_update import ops
    from repro_torch.models.simple import mlp_init
    algorithms = ("fedavg", "fedprox", "fednova", "fedagrac")
    data, parts = fedprox_synthetic(0, 10, alpha=1.0, beta=1.0)
    params0 = mlp_init(torch.Generator().manual_seed(0), 60, 64, 10)
    # warm-up (cuBLAS handles, allocator) outside the counted run
    _run_main_path(DEVICE, ("fedavg",), data, parts, params0)
    _reset_all_launches()
    gpu = _run_main_path(DEVICE, algorithms, data, parts, params0)
    launches = dict(ops.launches)
    cpu = _run_main_path("cpu", algorithms, data, parts, params0)
    spread = _run_main_path("cpu", algorithms, data, parts, params0,
                            reverse_rows=True)
    for name, n in launches.items():
        _require(n > 0, f"{name} was never launched on the main path")
    for algo in algorithms:
        g, c, p = gpu[algo], cpu[algo], spread[algo]
        kernel = ("calibrated_update_prox" if algo == "fedprox"
                  else "calibrated_update")
        _require(g["launches"][kernel] == 5 * 200,
                 f"{algo}: {g['launches']} launches, expected 1000 of "
                 f"{kernel} (5 rounds × k_max 200)")
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"{algo}: non-finite loss or metric")
        vs = _vs_cpu(algo, g, c, p)
        _emit({"phase": "main_path", "algorithm": algo,
               "loss": g["loss"].tolist(), "metric": g["metric"].tolist(),
               "wall_per_round_s": g["wall_per_round_s"],
               "cpu_wall_per_round_s": c["wall_per_round_s"],
               "launches": g["launches"],
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return launches


def _compressed_tasks() -> dict:
    """The lr task of the compression bench (zero weights, lr 0.02) and
    phase 3's mlp task (lr 0.03), on phase 3's data."""
    from repro_torch.data import fedprox_synthetic
    from repro_torch.models import simple
    data, parts = fedprox_synthetic(0, 10, alpha=1.0, beta=1.0)
    return {
        "lr": {"data": data, "parts": parts, "lr": 0.02,
               "params": {"w": torch.zeros(60, 10), "b": torch.zeros(10)},
               "loss": simple.lr_loss, "accuracy": simple.lr_accuracy},
        "mlp": {"data": data, "parts": parts, "lr": 0.03,
                "params": simple.mlp_init(torch.Generator().manual_seed(0),
                                          60, 64, 10),
                "loss": simple.mlp_loss, "accuracy": simple.mlp_accuracy}}


def _run_compressed(device: str, runs, tasks: dict, t_rounds: int = 5,
                    reverse_rows: bool = False) -> dict:
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import compress, flat
    from repro_torch.fed import FederatedSimulation
    from repro_torch.kernels.quantize import ops
    out = {}
    for run in runs:
        task, algo, up, down = run
        spec = tasks[task]
        data = spec["data"]
        x_eval, y_eval = data.x.to(device), data.y.to(device)
        fed = FedConfig(algorithm=algo, n_clients=10, lr=spec["lr"],
                        calibration_rate=1.0, weights="data",
                        param_layout="flat", compressor=up,
                        broadcast_compressor=down, error_feedback=True,
                        topk_frac=0.05)
        sim = FederatedSimulation(
            spec["loss"], spec["params"], fed,
            _batcher(data, spec["parts"], device, reverse_rows),
            k_schedule=_bimodal(), device=device,
            eval_fn=lambda p, acc=spec["accuracy"]: float(
                acc(p, {"x": x_eval, "y": y_eval})))
        before = dict(ops.launches)
        hist = sim.run(t_rounds, eval_every=t_rounds)
        n = flat.make_flat_spec(spec["params"]).n
        out[run] = {
            "loss": np.array(hist.loss), "metric": np.array(hist.metric),
            "wall_per_round_s": float(np.mean(hist.wall)),
            "params": sim.state["params"].cpu(),
            "launches": {k: ops.launches[k] - before[k] for k in before},
            "bytes_up": hist.bytes_up, "bytes_down": hist.bytes_down,
            "uses_nu": sim.algo.uses_nu,
            "wire": compress.wire_cost(n, sim.algo.uses_nu, sim.compression)}
    return out


def _codec_ms(tasks: dict) -> dict:
    """Time of one codec call on the card (CUDA events over back-to-back
    calls, mask and selection included) at the compressed path's shapes:
    (task, rows, compressor) → ms, rows 10 for the clients' payloads and 1
    for the broadcast."""
    from repro_torch.core import compress, flat
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    out = {}
    for task, spec in tasks.items():
        fspec = flat.make_flat_spec(spec["params"])
        for rows in (10, 1):
            x = 0.01 * torch.randn(rows, fspec.p, generator=gen,
                                   device=DEVICE)
            for name in CODEC_LAUNCHES:
                codec = compress.make_codec(name, fspec.n)
                out[(task, rows, name)] = (
                    0.0 if name == "none"
                    else _time_ms(lambda: codec(x), 200))
    return out


def phase_compressed_path() -> dict:
    from repro_torch.kernels.quantize import ops
    tasks = _compressed_tasks()
    # warm-up of the codecs' library calls (torch.topk) outside the count
    _run_compressed(DEVICE, [("lr", "fedagrac", "topk+int8", "int8")],
                    tasks, t_rounds=1)
    codec_ms = _codec_ms(tasks)
    _reset_all_launches()
    gpu = _run_compressed(DEVICE, COMPRESSED_RUNS, tasks)
    launches = dict(ops.launches)
    cpu = _run_compressed("cpu", COMPRESSED_RUNS, tasks)
    spread = _run_compressed("cpu", COMPRESSED_RUNS, tasks,
                             reverse_rows=True)
    for name, n in launches.items():
        _require(n > 0, f"{name} was never launched on the compressed path")
    for run in COMPRESSED_RUNS:
        task, algo, up, down = run
        g = gpu[run]
        name = f"{task}/{algo} up={up} down={down}"
        quantities = 2 if g["uses_nu"] else 1
        want = {k: 5 * quantities * (CODEC_LAUNCHES[up].get(k, 0)
                                     + CODEC_LAUNCHES[down].get(k, 0))
                for k in g["launches"]}
        _require(g["launches"] == want,
                 f"{name}: launches {g['launches']}, expected {want}")
        wire = g["wire"]
        _require(g["bytes_up"] == [10 * wire["uplink_per_client"]] * 5
                 and g["bytes_down"]
                 == [10 * wire["downlink_per_client"]] * 5,
                 f"{name}: bytes {g['bytes_up'][0]}/{g['bytes_down'][0]} "
                 f"per round, expected 10 × {wire}")
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"{name}: non-finite loss or metric")
        vs = _vs_cpu(name, g, cpu[run], spread[run])
        codec_ms_per_round = quantities * (codec_ms[(task, 10, up)]
                                           + codec_ms[(task, 1, down)])
        _emit({"phase": "compressed_path", "task": task, "algorithm": algo,
               "uplink": up, "broadcast": down,
               "loss": g["loss"].tolist(), "metric": g["metric"].tolist(),
               "wall_per_round_s": g["wall_per_round_s"],
               "uncompressed_wall_per_round_s":
                   gpu[(task, algo, "none", "none")]["wall_per_round_s"],
               "cpu_wall_per_round_s": cpu[run]["wall_per_round_s"],
               "codec_ms_per_round": codec_ms_per_round,
               "launches": g["launches"],
               "bytes_up_per_round": g["bytes_up"][0],
               "bytes_down_per_round": g["bytes_down"][0],
               "bytes_up_fp32_per_round": 10 * wire["uplink_fp32_per_client"],
               "bytes_down_fp32_per_round":
                   10 * wire["downlink_fp32_per_client"],
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return launches


def _band_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask lets through: what this run's
    attention must compute."""
    qp = np.arange(Sq)
    hi = np.minimum(qp, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _typed_bound(nbytes: int, ops: tuple[int, int, int]
                 ) -> tuple[float, str, Optional[float]]:
    """(bound ms, "bytes" or "operations", SIMT bound ms or None): the
    larger of ``nbytes`` over the memory rate and the operations ``ops``
    by the types of their operands — (bf16 × bf16, one operand exact,
    float32 only) — at the tensor cores' peaks: the first at bfloat16's,
    the second at half TF32's (two TF32 products each), the third at a
    third of it (three TF32 products stand for one float32 product,
    3×TF32).  Where every operation is float32 only, also the bound at the
    SIMT float32 peak, the float32 bound before the kernels ran on the
    tensor cores."""
    bf, exact, f32 = ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (bf / BF16_OPS_PER_S + exact / (TF32_OPS_PER_S / 2)
             + f32 / (TF32_OPS_PER_S / BWD_TF32_TERMS)) * 1e3
    simt = (max(t_bytes, f32 / FP32_OPS_PER_S * 1e3)
            if bf == exact == 0 else None)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", simt
    return t_ops, "operations", simt


def _tensor_bound(nbytes: int, ops: int, dtype
                  ) -> tuple[float, str, Optional[float]]:
    """``_typed_bound`` for ``ops`` operations of one input type: all
    bf16 × bf16 for bfloat16 (no SIMT bound), all float32 otherwise."""
    if dtype == torch.bfloat16:
        return (*_typed_bound(nbytes, (ops, 0, 0))[:2], None)
    return _typed_bound(nbytes, (0, 0, ops))


def _attn_bound(q, k, v, window) -> tuple[float, str, Optional[float]]:
    """The least time for one attention call: every input read once and
    o and lse written once, or 2·(Dqk + Dv) operations per visible pair
    and head at the tensor cores' peak of the input type (``_tensor_bound``),
    whichever is larger."""
    B, Sq, H, D = q.shape
    Skv, Dv = k.shape[1], v.shape[3]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + B * Sq * H * Dv * q.element_size() + B * H * Sq * 4
    ops = 2 * (D + Dv) * B * H * _band_pairs(Sq, Skv, True, window)
    return _tensor_bound(nbytes, ops, q.dtype)


def _fwd_mma_ops(q, k, v, window) -> int:
    """Tensor-core operations of the float32 forward kernel on this run's
    inputs: per (q tile, kv tile) pair it visits — FWD_TF32_BLOCK_ROWS
    queries against FWD_TF32_BLOCK_KEYS[bucket] keys, the tiles of the
    causal / window band — two products over the head-dim bucket D (S and
    P·V; above FWD_TF32_WIDE_HEAD_DIM S twice, once by each warp of a
    pair), each taken as BWD_TF32_TERMS TF32 products.  Masked entries of
    the tiles it visits are counted."""
    B, Sq, H, _ = q.shape
    Skv = k.shape[1]
    D = min(b for b in BWD_HEAD_BUCKETS if b >= max(q.shape[3], v.shape[3]))
    BQ, BK = FWD_TF32_BLOCK_ROWS, FWD_TF32_BLOCK_KEYS[D]
    tiles = 0
    for q0 in range(0, Sq, BQ):
        t_end = min(-(-Skv // BK), (q0 + BQ - 1) // BK + 1)
        t_begin = max(q0 - window + 1, 0) // BK if window else 0
        tiles += max(t_end - t_begin, 0)
    products = 3 if D > FWD_TF32_WIDE_HEAD_DIM else 2
    return BWD_TF32_TERMS * products * (2 * D) * BQ * BK * tiles * B * H


def _fused_qkv(shape, dtype, gen):
    """q, k, v cut as strided views from one (B, S, lead + (H + 2·Hkv)·D)
    buffer, as a fused QKV projection hands them over: ``lead`` elements
    before q in every row shift each row's start off a 16-byte boundary."""
    B, S, H, Hkv, D, _, lead = shape
    buf = torch.randn(B, S, lead + (H + 2 * Hkv) * D, generator=gen,
                      device=DEVICE).to(dtype)
    cuts = [lead, lead + H * D, lead + (H + Hkv) * D, lead + (H + 2 * Hkv) * D]
    return tuple(buf[..., a:b].unflatten(-1, (h, D)) for a, b, h in
                 zip(cuts, cuts[1:], (H, Hkv, Hkv)))


def _check_attention(checks, result, label, dtype, q, k, v, window):
    """The kernel against its plain version on the card at ATTN_TOL."""
    from repro_torch.kernels.flash_attention import ops, ref
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    want_o, want_lse = ref.attention_fwd(q, k, v, causal=True,
                                         window=window)
    torch.cuda.synchronize()
    err_o = (o.float() - want_o.float()).abs()
    if dtype == torch.float32:
        tol_o = ATTN_TOL[dtype] * (1 + want_o.abs())
    else:
        tol_o = ATTN_TOL[dtype] * torch.maximum(
            o.float().abs(), want_o.float().abs()) + 1e-6
    err_lse = (lse - want_lse).abs()
    tol_lse = ATTN_TOL[torch.float32] * (1 + want_lse.abs())
    max_o, max_lse = float(err_o.max()), float(err_lse.max())
    _require(bool((err_o <= tol_o).all())
             and bool((err_lse <= tol_lse).all())
             and bool(torch.isfinite(o).all()),
             f"flash_attention_fwd {dtype} {label}: max |err| o "
             f"{max_o}, lse {max_lse}")
    result["max_abs_err"] = max(result["max_abs_err"], max_o)
    checks.append({"kernel": "flash_attention_fwd", "dtype": str(dtype),
                   "shape": label, "copy_width": ops.copy_width(q, k, v),
                   "max_abs_err_o": max_o, "max_abs_err_lse": max_lse,
                   "tol": ATTN_TOL[dtype]})


def _attn_timing(shape, dtype, q, k, v, window) -> dict:
    """A ``kernel_time`` line of the forward kernel at ``shape`` from
    CUDA-graph replay, beside its plain version, its bound and
    ``scaled_dot_product_attention`` (a yardstick the port never calls;
    under a window it takes the window as an explicit boolean mask)."""
    from repro_torch.kernels.flash_attention import ops, ref
    iters = 100 if q.shape[1] <= 256 else 5
    bound_ms, bound_by, simt_ms = _attn_bound(q, k, v, window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = {"is_causal": True}
    if window:
        sdpa = {"attn_mask": ref.visible(q.shape[1], k.shape[1], True,
                                         window, device=q.device)}

    def kernel():
        ops.flash_attention_fwd(q, k, v, causal=True, window=window)

    timing = {
        "kernel": "flash_attention_fwd", "dtype": str(dtype),
        "shape": shape, "ms": _graph_ms(kernel, iters),
        **({} if dtype != torch.float32 else
           {"mma_ops": _fwd_mma_ops(q, k, v, window)}),
        "stream_ms": _time_ms(kernel, iters),
        "plain_ms": _graph_ms(lambda: ref.attention_fwd(
            q, k, v, causal=True, window=window), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
        **({} if simt_ms is None else {"simt_bound_ms": simt_ms}),
        "library_ms": _graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa), iters)}
    _emit({"phase": "kernel_time", **timing})
    return timing


def phase_attention_kernel() -> dict:
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    result = {"max_abs_err": 0.0}
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ATTN_SHAPES:
            B, S, H, Hkv, D, window = shape
            q, k, v = (torch.randn(B, S, h, D, generator=gen, device=DEVICE
                                   ).to(dtype) for h in (H, Hkv, Hkv))
            _check_attention(checks, result, shape, dtype, q, k, v, window)
            if shape in ATTN_TIMED:
                timing = _attn_timing(shape, dtype, q, k, v, window)
                if dtype == torch.bfloat16 and shape == ATTN_PATH_SHAPE:
                    result.update({key: timing[key] for key in ATTN_KEYS})
                if dtype == torch.bfloat16 and shape == ATTN_STEP_SHAPE:
                    result["bf16_step"] = {key: timing[key]
                                           for key in ATTN_KEYS}
            del q, k, v
            torch.cuda.empty_cache()
        for name, shape in ATTN_SERVE_SHAPES.items():
            B, S, H, Hkv, Dqk, Dv, window = shape
            q = torch.randn(B, S, H, Dqk, generator=gen, device=DEVICE
                            ).to(dtype)
            k, v = (torch.randn(B, S, Hkv, d, generator=gen, device=DEVICE
                                ).to(dtype) for d in (Dqk, Dv))
            _check_attention(checks, result, shape, dtype, q, k, v, window)
            if dtype == torch.bfloat16:
                timing = _attn_timing(shape, dtype, q, k, v, window)
                result[name] = {key: timing[key] for key in ATTN_KEYS}
                result[name]["max_abs_err"] = checks[-1]["max_abs_err_o"]
            del q, k, v
            torch.cuda.empty_cache()
        train = [(name, shape, timed) for name, (shape, timed)
                 in ATTN_TRAIN_SHAPES.items()]
        for name, shape, timed_dtype in train + [
                (None, shape, None) for shape in ATTN_TRAIN_CHECKED]:
            B, S, H, Hkv, Dqk, Dv, window = shape
            q = torch.randn(B, S, H, Dqk, generator=gen, device=DEVICE
                            ).to(dtype)
            k, v = (torch.randn(B, S, Hkv, d, generator=gen, device=DEVICE
                                ).to(dtype) for d in (Dqk, Dv))
            _check_attention(checks, result, shape, dtype, q, k, v, window)
            if dtype == timed_dtype:
                timing = _attn_timing(shape, dtype, q, k, v, window)
                result[name] = {key: timing[key] for key in ATTN_KEYS}
                result[name]["max_abs_err"] = checks[-1]["max_abs_err_o"]
            del q, k, v
            torch.cuda.empty_cache()
        for shape in ATTN_FUSED_SHAPES:
            q, k, v = _fused_qkv(shape, dtype, gen)
            _check_attention(checks, result, shape, dtype, q, k, v,
                             shape[5])
        for shape in ATTN_CUT_SHAPES:
            B, S, H, Hkv, D, window, width = shape
            q, k, v = (torch.randn(B, S, h, width, generator=gen,
                                   device=DEVICE).to(dtype)[..., :D]
                       for h in (H, Hkv, Hkv))
            _check_attention(checks, result, shape, dtype, q, k, v, window)
        for shape in ATTN_CROSS_SHAPES:
            B, Sq, Skv, H, Hkv, D, window = shape
            q = torch.randn(B, Sq, H, D, generator=gen, device=DEVICE
                            ).to(dtype)
            k, v = (torch.randn(B, Skv, Hkv, D, generator=gen,
                                device=DEVICE).to(dtype) for _ in range(2))
            _check_attention(checks, result, shape, dtype, q, k, v, window)
    widths = {str(dtype): sorted({ch["copy_width"] for ch in checks
                                  if ch["dtype"] == str(dtype)})
              for dtype in (torch.float32, torch.bfloat16)}
    _require(widths[str(torch.float32)] == [4, 8, 16]
             and widths[str(torch.bfloat16)] == [2, 4, 8, 16],
             f"phase 5 left a copy width unchecked: {widths}")
    _emit({"phase": "attention_kernel", "checks": len(checks),
           "max_abs_err": result["max_abs_err"], "copy_widths": widths,
           "worst": max(checks, key=lambda ch: ch["max_abs_err_o"])})
    result["bf16_step"]["max_abs_err"] = max(
        ch["max_abs_err_o"] for ch in checks
        if ch["dtype"] == str(torch.bfloat16))
    return result


def _attn_bwd_bound(kernel, q, k, v, window
                    ) -> tuple[float, str, Optional[float]]:
    """The least time for one backward kernel call: q, k, v and do read
    once, lse and δ (float32) read once and its outputs (dq; or dk and dv)
    written once, or its products over the visible pairs at the tensor
    cores' peak of the input type (``_tensor_bound``) — per visible
    (query, key) pair and head, the score and dp products (2·Dqk + 2·Dv)
    and then dq (2·Dqk), or dk and dv (2·Dqk + 2·Dv) — whichever is
    larger."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    es = q.element_size()
    nbytes = (sum(t.numel() for t in (q, k, v)) + B * Sq * H * Dv) * es \
        + 2 * B * H * Sq * 4
    per_pair = 2 * (D + Dv)
    if kernel == "flash_attention_bwd_dq":
        nbytes += q.numel() * es
        per_pair += 2 * D
    else:
        nbytes += (k.numel() + v.numel()) * es
        per_pair += 2 * (D + Dv)
    ops = per_pair * B * H * _band_pairs(Sq, Skv, True, window)
    return _tensor_bound(nbytes, ops, q.dtype)


def _bwd_close(got, want, dtype) -> tuple[float, bool]:
    """(max |err| over the largest |want|, within tolerance): float32 to
    ATTN_BWD_TOL of the tensor's largest entry; bfloat16 to one bf16 ulp
    of the entry plus that float32 term."""
    got, want = got.float(), want.float()
    amax = float(want.abs().max())
    err = (got - want).abs()
    tol = ATTN_BWD_TOL * amax
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
    return float(err.max()) / max(amax, 1e-30), bool((err <= tol).all())


def _bwd_mma_ops(kernel, q, k, v, window) -> int:
    """Tensor-core operations of a backward kernel on this run's visible
    pairs: per visible (query, key) pair and head, 2·D for each product
    over the head-dim bucket D — dq: S, dP and dS·K; dk/dv: S, dP, Pᵀ·dO
    and dSᵀ·Q — with bfloat16 P and dS split into BWD_PIECES bf16 pieces
    (a product of each), and every float32 product taken as
    BWD_TF32_TERMS TF32 products.  Above BWD_WIDE_HEAD_DIM two warps split
    each dq row's columns — the bfloat16 dq's both take all of S and dP,
    the float32 dq's each take half and trade dS — and dk/dv takes S twice
    (dk and dv are taken by separate blocks).  The masked halves of tiles
    on the diagonal are not counted."""
    B, Sq, H, _ = q.shape
    D = min(b for b in BWD_HEAD_BUCKETS if b >= max(q.shape[3], v.shape[3]))
    wide = D > BWD_WIDE_HEAD_DIM
    f32 = q.dtype == torch.float32
    n = 1 if f32 else BWD_PIECES
    if kernel == "flash_attention_bwd_dq":
        products = 2 + n + (2 if wide and not f32 else 0)
    else:
        products = 2 + 2 * n + (1 if wide else 0)
    terms = BWD_TF32_TERMS if f32 else 1
    return terms * 2 * D * products * B * H * _band_pairs(
        Sq, k.shape[1], True, window)


def _check_backward(checks, result, label, dtype, q, k, v, window, gen):
    """Both backward kernels against their plain versions on the card, from
    the forward kernel's o and lse and a random cotangent; returns
    (o, lse, do, δ)."""
    from repro_torch.kernels.flash_attention import ops, ref
    kw = {"causal": True, "window": window}
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    do = torch.randn(o.shape, generator=gen, device=DEVICE).to(dtype)
    delta = ref.row_delta(do, o)
    got = {"flash_attention_bwd_dq": (ops.flash_attention_bwd_dq(
               q, k, v, do, lse, delta, **kw),),
           "flash_attention_bwd_dkv": ops.flash_attention_bwd_dkv(
               q, k, v, do, lse, delta, **kw)}
    want = ref.attention_bwd(q, k, v, o, lse, do, **kw)
    want = {"flash_attention_bwd_dq": want[:1],
            "flash_attention_bwd_dkv": want[1:]}
    torch.cuda.synchronize()
    for name in got:
        for what, g_t, w_t in zip(
                ("dq",) if name.endswith("dq") else ("dk", "dv"),
                got[name], want[name]):
            rel, ok = _bwd_close(g_t, w_t, dtype)
            _require(ok and bool(torch.isfinite(g_t).all()),
                     f"{name} {dtype} {label}: {what} max |err| / "
                     f"max |want| = {rel}")
            err = float((g_t.float() - w_t.float()).abs().max())
            result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                              err)
            checks.append({"kernel": name, "grad": what,
                           "dtype": str(dtype), "shape": label,
                           "copy_width": ops.copy_width(q, k, v, do),
                           "split": ops.dkv_split(q, k),
                           "max_abs_err": err, "rel_err": rel})
    return o, lse, do, delta


def phase_attention_backward() -> dict:
    """Both backward kernels against their plain versions on the card at
    ATTN_BWD_SHAPES and ATTN_BWD_FUSED_SHAPES in float32 and bfloat16,
    then timed at ATTN_BWD_TIMED; the dk/dv kernel's group paths at
    ATTN_BWD_GROUP_SHAPES.  Returns each kernel's worst error and
    its timing at the training path's shape in float32 (phase 8's type),
    under ``<name>_bf16`` the bfloat16 ones (phase 16's), and under
    ``<name>_<model>`` those of phase 21's shapes in its dtypes
    (ATTN_BWD_TRAIN) with the worst error there."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    result = {name: {"max_abs_err": 0.0} for name in names}
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ATTN_BWD_SHAPES:
            B, Sq, Skv, H, Hkv, D, window, *rest = shape
            Dv = rest[0] if rest else D
            q = torch.randn(B, Sq, H, D, generator=gen, device=DEVICE
                            ).to(dtype)
            k, v = (torch.randn(B, Skv, Hkv, d, generator=gen,
                                device=DEVICE).to(dtype) for d in (D, Dv))
            o, lse, do, delta = _check_backward(checks, result, shape, dtype,
                                                q, k, v, window, gen)
            if shape in ATTN_BWD_TIMED:
                _time_backward(result, shape, dtype, q, k, v, o, lse, do,
                               delta)
            del q, k, v, o, lse, do, delta
            torch.cuda.empty_cache()
        for shape in ATTN_BWD_FUSED_SHAPES:
            q, k, v = _fused_qkv(shape, dtype, gen)
            _check_backward(checks, result, shape, dtype, q, k, v, shape[5],
                            gen)
    _time_group_paths(gen)
    bf16 = [ch for ch in checks if ch["dtype"] == str(torch.bfloat16)]
    for name in names:
        result[name + "_bf16"]["max_abs_err"] = max(
            ch["max_abs_err"] for ch in bf16 if ch["kernel"] == name)
        for model, (shape, dtype) in ATTN_BWD_TRAIN.items():
            result[f"{name}_{model}"]["max_abs_err"] = max(
                ch["max_abs_err"] for ch in checks
                if ch["kernel"] == name and ch["shape"] == shape
                and ch["dtype"] == str(dtype))
    f32 = [ch for ch in checks if ch["dtype"] == str(torch.float32)]
    _emit({"phase": "attention_backward", "checks": len(checks),
           "max_abs_err": {n: r["max_abs_err"] for n, r in result.items()},
           "copy_widths": sorted({ch["copy_width"] for ch in bf16}),
           "bf16_split_paths": sorted({ch["split"] for ch in bf16
                                       if ch["grad"] != "dq"}),
           "f32_copy_widths": sorted({ch["copy_width"] for ch in f32}),
           "f32_split_paths": sorted({ch["split"] for ch in f32
                                      if ch["grad"] != "dq"}),
           "worst_f32": max(f32, key=lambda ch: ch["rel_err"]),
           "reserved_bytes_after": torch.cuda.memory_reserved(),
           "worst": max(checks, key=lambda ch: ch["rel_err"])})
    return result


def _time_group_paths(gen) -> None:
    """The dk/dv kernel, float32 and bfloat16, at ATTN_BWD_GROUP_SHAPES
    with each way of summing a GQA/MQA group forced in turn — one block
    looping over the g query heads, or one block a head writing float32
    partials that dkv_reduce_kernel sums: each held against the plain
    version, then both timed from CUDA-graph replay in the order loop,
    split, split, loop.  Prints a dkv_group line a shape and dtype, with
    the path ``ops.dkv_split`` picks there."""
    from repro_torch.kernels.flash_attention import ops, ref
    rule = ops.dkv_split
    try:
        for dtype, shape in ((dtype, shape)
                             for dtype in (torch.float32, torch.bfloat16)
                             for shape in ATTN_BWD_GROUP_SHAPES):
            B, Sq, Skv, H, Hkv, D, window = shape
            q = torch.randn(B, Sq, H, D, generator=gen, device=DEVICE
                            ).to(dtype)
            k, v = (torch.randn(B, Skv, Hkv, D, generator=gen,
                                device=DEVICE).to(dtype) for _ in range(2))
            o, lse = ops.flash_attention_fwd(q, k, v)
            do = torch.randn(o.shape, generator=gen, device=DEVICE).to(dtype)
            delta = ref.row_delta(do, o)
            want = ref.attention_bwd_dkv(q, k, v, do, lse, delta)
            line = {"phase": "dkv_group", "dtype": str(dtype),
                    "shape": shape,
                    "rule": "split" if rule(q, k) else "loop"}

            def run():
                return ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)

            for path in ("loop", "split"):
                ops.dkv_split = lambda q_, k_, split=path == "split": split
                for what, g_t, w_t in zip(("dk", "dv"), run(), want):
                    rel, ok = _bwd_close(g_t, w_t, dtype)
                    _require(ok and bool(torch.isfinite(g_t).all()),
                             f"dk/dv {path} {shape}: {what} max |err| / "
                             f"max |want| = {rel}")
                    line[f"{path}_{what}_rel_err"] = rel
            iters = 50 if Sq <= 512 else 5
            for path in ("loop", "split", "split", "loop"):
                ops.dkv_split = lambda q_, k_, split=path == "split": split
                line.setdefault(f"{path}_ms", []).append(_graph_ms(run,
                                                                   iters))
            _emit(line)
            del q, k, v, o, lse, do, delta, want
            torch.cuda.empty_cache()
    finally:
        ops.dkv_split = rule


def _time_backward(result, shape, dtype, q, k, v, o, lse, do, delta):
    """kernel_time lines of both backward kernels at ``shape``, kernel and
    plain version from CUDA-graph replay (the kernel also from
    back-to-back calls, ``stream_ms``), with the time of
    scaled_dot_product_attention's backward (dq, dk and dv through
    autograd, from graph replay too) as the yardstick (the port never calls
    it), the tensor-core work done and, for float32, the bound at the SIMT
    peak beside the 3×TF32 one."""
    from repro_torch.kernels.flash_attention import ops, ref
    window = shape[6]
    kw = {"causal": True, "window": window}
    iters = 50 if shape[1] <= 256 else 3
    # under a window SDPA takes it as an explicit boolean mask
    sdpa = ({"is_causal": True} if window == 0 else
            {"attn_mask": ref.visible(q.shape[1], k.shape[1], True, window,
                                      device=q.device)})
    # SDPA's forward runs on the stream the backward is captured on:
    # captured on another, the backward invalidated the capture
    # (cudaErrorStreamCaptureInvalidated) at some shapes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa)
    dot = do.transpose(1, 2)
    library_ms = _graph_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters, stream=side)
    del out
    entries = {
        "flash_attention_bwd_dq": (
            lambda: ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
            lambda: ref.attention_bwd_dq(q, k, v, do, lse, delta, **kw)),
        "flash_attention_bwd_dkv": (
            lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                **kw),
            lambda: ref.attention_bwd_dkv(q, k, v, do, lse, delta, **kw))}
    for name, (kernel, plain) in entries.items():
        bound_ms, bound_by, simt_ms = _attn_bwd_bound(name, q, k, v, window)
        timing = {"kernel": name, "dtype": str(dtype), "shape": shape,
                  "ms": _graph_ms(kernel, iters),
                  "stream_ms": _time_ms(kernel, iters),
                  "plain_ms": _graph_ms(plain, iters),
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms}
        ops_done = _bwd_mma_ops(name, q, k, v, window)
        timing["mma_ops"] = ops_done
        if dtype == torch.bfloat16:
            timing["mma_pieces"] = BWD_PIECES
        else:
            timing.update({"mma_terms": BWD_TF32_TERMS,
                           "simt_bound_ms": simt_ms})
        timing["mma_tflops"] = ops_done / timing["ms"] / 1e9
        _emit({"phase": "kernel_time", **timing})
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        if dtype == torch.float32 and shape == ATTN_BWD_PATH_SHAPE:
            result[name].update({key: timing[key] for key in keys})
        if dtype == torch.bfloat16 and shape == ATTN_BWD_PATH_SHAPE:
            result[name + "_bf16"] = {key: timing[key] for key in keys}
        for model, train in ATTN_BWD_TRAIN.items():
            if (shape, dtype) == train:
                result[f"{name}_{model}"] = {key: timing[key]
                                             for key in keys}


def _serve_requests(prompts, max_new, vocab: int, seed: int) -> list:
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
                        1, vocab, int(rng.integers(lo, hi + 1))
                    ).astype(np.int32),
                    max_new_tokens=int(rng.integers(max_new[0],
                                                     max_new[1] + 1)))
            for i, (lo, hi) in enumerate(prompts)]


def _timed_engine_class():
    """``ServeEngine`` that times its admissions and ticks (each ends in a
    host read of the sampled tokens, so the host clock covers the device
    work), counts attention-kernel launches in each, checks every logits
    tensor is finite, and can record the logits each token came from."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.serving import ServeEngine

    class TimedEngine(ServeEngine):
        def __init__(self, *args, record: bool = False,
                     forced: Optional[dict] = None, **kw):
            super().__init__(*args, **kw)
            self.record = record
            # uid -> tokens: emit these instead of sampling (a run
            # teacher-forced with another run's tokens)
            self.forced = forced
            self.logits: dict[int, list] = {}
            self.first_token_s: dict[int, float] = {}
            self.admit_s, self.tick_s = [], []
            self.admissions = 0
            self.prefill_tokens = self.padded_tokens = 0
            self.decode_tokens = 0
            self.admit_launches = self.tick_launches = 0
            self.t0 = time.perf_counter()

        def _admit(self):
            before = ops.launches["flash_attention_fwd"]
            t0 = time.perf_counter()
            super()._admit()
            self.admit_s.append(time.perf_counter() - t0)
            self.admit_launches += ops.launches["flash_attention_fwd"] \
                - before

        def _sample(self, logits, rows, uids, steps):
            out = super()._sample(logits, rows, uids, steps)
            if self.forced is not None:
                out = [self.forced[uid][step]
                       for uid, step in zip(uids, steps)]
            now = time.perf_counter() - self.t0    # the tokens are on the host
            for uid, step in zip(uids, steps):
                if step == 0:
                    self.first_token_s[uid] = now
            return out

        def _tick(self):
            before = ops.launches["flash_attention_fwd"]
            live = sum(a is not None for a in self.active)
            t0 = time.perf_counter()
            super()._tick()
            if live:
                self.tick_s.append(time.perf_counter() - t0)
                self.decode_tokens += live
            self.tick_launches += ops.launches["flash_attention_fwd"] \
                - before

        def _prefill_slot(self, s, req, toks, caches):
            logits, single = super()._prefill_slot(s, req, toks, caches)
            _require(bool(torch.isfinite(logits).all()),
                     f"request {req.uid}: non-finite prefill logits")
            self.admissions += 1
            self.prefill_tokens += len(req.prompt)
            self.padded_tokens += toks.shape[1]
            if self.record:
                self.logits[req.uid] = [
                    logits[0, len(req.prompt) - 1].float().cpu()]
            return logits, single

        def _decode_tick(self, toks, live):
            logits = super()._decode_tick(toks, live)
            _require(bool(torch.isfinite(logits).all()),
                     "non-finite decode logits")
            if self.record:
                rows = logits.float().cpu()
                for s in live:
                    self.logits[self.active[s].uid].append(rows[s])
            return logits

    return TimedEngine


def _serve_stats(eng, reqs, wall_s: float) -> dict:
    done = {c.uid: c for c in eng.done}
    _require(sorted(done) == [r.uid for r in reqs],
             f"served {sorted(done)} of {len(reqs)} requests")
    for r in reqs:
        toks = done[r.uid].tokens
        _require(len(toks) == r.max_new_tokens
                 and all(0 <= t < eng.cfg.vocab for t in toks),
                 f"request {r.uid}: {len(toks)} tokens, expected "
                 f"{r.max_new_tokens} ids below {eng.cfg.vocab}")
    return {"requests": len(reqs), "admissions": eng.admissions,
            "ticks": eng.ticks, "wall_s": wall_s,
            "ttft_s": [eng.first_token_s[r.uid] for r in reqs],
            "prompt_tokens": eng.prefill_tokens,
            "padded_prefill_tokens": eng.padded_tokens,
            "prefill_s": float(np.sum(eng.admit_s)),
            "prefill_tokens_per_s": eng.prefill_tokens
            / float(np.sum(eng.admit_s)),
            "decode_tokens": eng.decode_tokens,
            "decode_s": float(np.sum(eng.tick_s)),
            "decode_tokens_per_s": eng.decode_tokens
            / float(np.sum(eng.tick_s)),
            "wall_per_tick_s": float(np.mean(eng.tick_s)),
            "wall_per_tick_p50_s": float(np.median(eng.tick_s)),
            "flash_launches_prefill": eng.admit_launches,
            "flash_launches_decode": eng.tick_launches}


def _serve(cfg, params, reqs, device, record=False, settings=None,
           forced=None):
    engine_cls = _timed_engine_class()
    eng = engine_cls(cfg, params, device=device, record=record,
                     forced=forced, **(settings or SERVE))
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.t0 = t0
    eng.run()
    if device != "cpu":
        torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def phase_serving(cfg=None, check_cfg=None) -> dict:
    """The timing run at full width and depth in bfloat16, then the
    float32 card-against-CPU check.  Returns the kernels' launch counts
    of the timing run."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import model as model_lib
    cfg = cfg or dataclasses.replace(get_arch("llama3-8b"), dtype="bfloat16")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = []
    tree_map(leaves.append, params)
    # warm-up (cuBLAS handles, allocator) outside the counted run
    _serve(cfg, params, _serve_requests([(8, 32)], (2, 2), cfg.vocab, 99),
           DEVICE)
    reqs = _serve_requests(SERVE_PROMPTS, (16, 32), cfg.vocab, 0)
    _reset_all_launches()
    eng, wall = _serve(cfg, params, reqs, DEVICE)
    launches = _all_launches()
    stats = _serve_stats(eng, reqs, wall)
    want = cfg.n_layers * eng.admissions
    _require(launches["flash_attention_fwd"] == want
             and eng.admit_launches == want and eng.tick_launches == 0
             and launches["flash_attention_bwd_dq"] == 0
             and launches["flash_attention_bwd_dkv"] == 0,
             f"flash_attention_fwd launches: {eng.admit_launches} in "
             f"prefills, {eng.tick_launches} in decode ticks; expected "
             f"{want} ({cfg.n_layers} layers × {eng.admissions} "
             f"admissions) and 0, and no backward launch")
    _emit({"phase": "serving", "model": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers,
           "params": sum(t.numel() for t in leaves),
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "init_s": init_s, **SERVE,
           "max_new_tokens": [r.max_new_tokens for r in reqs],
           "prompt_lens": [len(r.prompt) for r in reqs], **stats,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    del eng, params, leaves
    torch.cuda.empty_cache()

    check_cfg = check_cfg or dataclasses.replace(get_arch("llama3-8b"),
                                                 n_layers=2)
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(1), check_cfg)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    reqs = _serve_requests(SERVE_CHECK_PROMPTS, (8, 12), check_cfg.vocab, 1)
    eng, wall = _serve(check_cfg, params, reqs, DEVICE, record=True)
    _serve_stats(eng, reqs, wall)
    _require(eng.admit_launches == check_cfg.n_layers * eng.admissions
             and eng.tick_launches == 0,
             f"check run: {eng.admit_launches} / {eng.tick_launches} "
             f"attention launches in prefill / decode")
    worst, clear_tokens, near_ties = 0.0, 0, 0
    with torch.inference_mode():
        for c in eng.done:
            r = next(r for r in reqs if r.uid == c.uid)
            seq = np.concatenate([r.prompt, np.asarray(c.tokens[:-1],
                                                       np.int32)])
            ref = model_lib.forward(
                cpu_params, {"tokens": torch.from_numpy(seq)[None].long()},
                check_cfg)[0][0, len(r.prompt) - 1:]
            got = torch.stack(eng.logits[c.uid])
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            _require(err <= LOGIT_TOL,
                     f"request {c.uid}: card logits differ from the CPU's "
                     f"by {err} > {LOGIT_TOL}")
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
            toks = torch.tensor(c.tokens)
            _require(torch.equal(toks[clear], ref.argmax(-1)[clear]),
                     f"request {c.uid}: a token differs from the CPU's "
                     f"argmax where its margin exceeds {2 * LOGIT_TOL}")
            clear_tokens += int(clear.sum())
            near_ties += int((~clear).sum())
    _emit({"phase": "serving_vs_cpu", "model": check_cfg.name,
           "dtype": check_cfg.dtype, "n_layers": check_cfg.n_layers,
           "requests": len(reqs), "admissions": eng.admissions,
           "max_abs_logit_err": worst, "tol": LOGIT_TOL,
           "tokens_checked": clear_tokens, "near_ties": near_ties,
           "wall_s": wall})
    del eng, params, cpu_params
    torch.cuda.empty_cache()
    return launches


def _flip_batch_rows(batches: dict) -> dict:
    return {k: v.flip(-2) for k, v in batches.items()}


def _lm_batcher_class(flip_rows: bool):
    """The host LM batcher, or one that hands out every microbatch with its
    sequences in reverse order (the same loss, other float32 roundings)."""
    from repro_torch.data import LMFederatedBatcher

    class Batcher(LMFederatedBatcher):
        def round_batches(self, t, k_max):
            b = super().round_batches(t, k_max)
            return _flip_batch_rows(b) if flip_rows else b

        def chunk_batches(self, t0, r, k_max):
            b = super().chunk_batches(t0, r, k_max)
            return _flip_batch_rows(b) if flip_rows else b

    return Batcher


def _run_fed_lm(cfg, algo: str, device, *, clients: int, seq: int,
                batch: int, rounds: int, lr: Optional[float] = None,
                generator=None, flip_rows: bool = False, bf16: bool = False,
                moved: Optional[int] = None, ulp_moved: Optional[int] = None,
                keep: bool = False, eval_first: bool = False,
                layout: str = "flat", held_out: Optional[int] = None
                ) -> dict:
    """The example's simulation (``repro_torch.examples.fed_lm_train``)
    for ``rounds`` rounds in one chunk; returns its history, final params,
    the kernels' launches, wall and peak memory.  ``bf16``: the example's
    ``--bf16`` (``cfg`` in bfloat16 over a float32 master); ``moved``: the
    master's initial weights moved by a bfloat16 ulp or two at random
    (``_bf16_moved``, seeded); ``ulp_moved``: by a float32 ulp
    (``_f32_moved``); ``keep``: the simulation is returned too, under
    ``"sim"``; ``eval_first``: the held-out metric of the initial weights
    too, under ``"metric0"``, taken before the counts and the clock
    start; ``layout``: the example's ``--layout`` (the params come back
    raveled on both, ``"base_memory_bytes"`` is what was allocated on the
    card before the run); ``held_out``: the eval's sequences (the
    example's HELD_OUT_SEQS by default)."""
    from repro_torch.core import flat
    from repro_torch.examples import fed_lm_train as ex
    batcher = _lm_batcher_class(flip_rows)(
        ex.make_streams(cfg, seq, clients), batch_size=batch, device=device)
    fed = ex.fed_config(algo, n_clients=clients, bf16=bf16, layout=layout)
    if lr is not None:
        fed = dataclasses.replace(fed, lr=lr)
    sim = ex.make_simulation(cfg, fed, seq=seq, batch=batch, rounds=rounds,
                             device=torch.device(device),
                             generator=generator, batcher=batcher,
                             held_out=held_out or ex.HELD_OUT_SEQS)
    if moved is not None:
        sim.state["params"] = _bf16_moved(sim.state["params"], sim._spec.n,
                                          moved)
    if ulp_moved is not None:
        sim.state["params"] = _f32_moved(sim.state["params"], sim._spec.n,
                                         ulp_moved)
    metric0 = float(sim.eval_fn(sim.params)) if eval_first else None
    base = None
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    _reset_all_launches()
    t0 = time.perf_counter()
    hist = sim.run(rounds, eval_every=rounds)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    spec = sim.flat_spec
    master = (sim.state["params"] if layout == "flat"
              else flat.ravel(spec, sim.state["params"]))
    out = {"loss": np.array(hist.loss), "metric": np.array(hist.metric),
           "round_wall_s": list(hist.wall), "wall_s": wall,
           "k_max": sim.k_max, "k": sim.k_schedule[0].tolist(),
           "params": master.cpu(), "n": spec.n, "p": spec.p,
           "master_dtype": master.dtype,
           "view_dtypes": sorted({str(d) for d in spec.dtypes}),
           "launches": _all_launches(), "metric0": metric0,
           "peak_memory_bytes": peak, "base_memory_bytes": base}
    del master
    if keep:
        out["sim"] = sim
    del sim
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def _lm_vs_cpu_margins(g: dict, c: dict, probes: list) -> dict:
    """An LM run on the card ``g`` against the CPU's ``c``: {what: (diff,
    tol)}, the tolerance PATH_SPREAD times the largest spread of the CPU
    reruns ``probes`` (each changing only rounding) plus PATH_RTOL of the
    CPU's values."""
    def spread(key):
        return np.max([np.abs(q[key] - c[key]) for q in probes], axis=0)

    return {
        "loss": (np.abs(g["loss"] - c["loss"]),
                 PATH_SPREAD * spread("loss")
                 + PATH_RTOL * np.abs(c["loss"])),
        "perplexity": (np.abs(g["metric"] - c["metric"]),
                       PATH_SPREAD * spread("metric")
                       + PATH_RTOL * np.abs(c["metric"])),
        "params": (float((g["params"] - c["params"]).abs().max()),
                   PATH_SPREAD * max(float((q["params"] - c["params"])
                                           .abs().max()) for q in probes)
                   + PATH_RTOL * float(c["params"].abs().max()))}


def _bf16_moved(master: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """A float32 master whose first ``n`` entries are moved by 2⁻⁷ of
    themselves, up or down at random, or left (a third each): a bfloat16
    ulp or two of every view entry that moves."""
    gen = torch.Generator().manual_seed(seed)
    step = torch.randint(-1, 2, (n,), generator=gen).to(master.device)
    out = master.clone()
    out[:n] = (master[:n] * (1 + step * 2.0 ** -7)).bfloat16().float()
    return out


def _f32_moved(master: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """A float32 master whose first ``n`` entries are moved to a float32
    neighbour, up or down at random, or left (a third each:
    ``_ulp_moved``'s rule)."""
    out = master.clone()
    out[:n] = _ulp_moved({"w": master[:n].cpu()}, seed)["w"].to(
        master.device)
    return out


def phase_fed_lm(cfg=None, small_cfg=None) -> tuple[dict, dict]:
    """Federated LM training at full width (FED_LM), then the example's
    --small model on the card against the CPU.  Returns the kernels'
    launch counts of the last full-width run, and the full-width fedagrac
    run (its history, host params, wall and peak memory), which phase 18
    holds the tree layout to."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.examples import fed_lm_train as ex
    cfg = cfg or dataclasses.replace(get_arch("gemma-2b"),
                                     n_layers=FED_LM["layers"],
                                     dtype="float32")
    run = {k: FED_LM[k] for k in ("clients", "seq", "batch", "rounds",
                                  "lr")}
    _emit({"phase": "fed_lm_cuts", "model": cfg.name,
           "n_layers": f"{cfg.n_layers} of {get_arch(cfg.name).n_layers}",
           "clients": f"{run['clients']} of {ex.MCLIENTS}",
           "widths": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                      "vocab": cfg.vocab}})
    # warm-up (cuBLAS handles, allocator) outside the counted runs
    _run_fed_lm(small_cfg or ex.build_config(True), "fedavg", DEVICE,
                clients=2, seq=32, batch=2, rounds=1)
    launches, kept = {}, {}
    for algo in FED_LM["algorithms"]:
        g = _run_fed_lm(cfg, algo, DEVICE, **run)
        launches = g["launches"]
        L, k_max, R = cfg.n_layers, g["k_max"], run["rounds"]
        want = {"flash_attention_fwd": L * k_max * R + L,
                "flash_attention_bwd_dq": L * k_max * R,
                "flash_attention_bwd_dkv": L * k_max * R,
                "calibrated_update": k_max * R}
        got = {k: launches[k] for k in want}
        _require(got == want and all(
            n == 0 for k, n in launches.items() if k not in want),
                 f"{algo}: launches {launches}, expected {want} and no other")
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"{algo}: non-finite loss {g['loss']} or perplexity "
                 f"{g['metric']}")
        _require(float(g["metric"][-1]) < cfg.vocab,
                 f"{algo}: held-out perplexity {g['metric'][-1]} is not "
                 f"below the vocab ({cfg.vocab})")
        tokens = run["clients"] * k_max * run["batch"] * run["seq"]
        wall = float(np.mean(g["round_wall_s"]))
        _emit({"phase": "fed_lm", "model": cfg.name, "algorithm": algo,
               "dtype": cfg.dtype, "n_layers": cfg.n_layers, **run,
               "params": g["n"], "k": g["k"], "k_max": k_max,
               "loss": g["loss"].tolist(), "perplexity": g["metric"].tolist(),
               "wall_per_round_s": g["round_wall_s"],
               "wall_per_local_step_s": wall / k_max,
               "tokens_per_round": tokens,
               "train_tokens_per_s": tokens / wall,
               "run_wall_s": g["wall_s"], "launches": got,
               "peak_memory_bytes": g["peak_memory_bytes"]})
        width = g["p"]
        if algo == "fedagrac":
            kept = g
        del g
    # B1 at this path's (M, P), on the memory the runs have given back
    check_update_at(run["clients"], width)
    small = small_cfg or ex.build_config(True)
    srun = {"clients": ex.MCLIENTS, "seq": 32, "batch": 2, "rounds": 3}
    for algo in FED_LM["algorithms"]:
        runs = [_run_fed_lm(small, algo, dev, generator=torch.Generator(
                    ).manual_seed(0), flip_rows=flip, **srun)
                for dev, flip in ((DEVICE, False), ("cpu", False),
                                  ("cpu", True))]
        g, c, p = runs
        _require(g["launches"]["flash_attention_bwd_dq"] > 0,
                 f"{algo} --small: the card run launched no backward kernel")
        vs = _lm_vs_cpu_margins(g, c, [p])
        for what, (diff, tol) in vs.items():
            _require(bool(np.all(diff <= tol)),
                     f"{algo} --small: {what} differs from the CPU run by "
                     f"{diff}, more than {tol}")
        _emit({"phase": "fed_lm_vs_cpu", "model": "gemma-2b --small",
               "algorithm": algo, **srun, "k": g["k"],
               "loss": g["loss"].tolist(), "perplexity": g["metric"].tolist(),
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return launches, kept


def _ssd_operands(shape, dtype, gen, a_rows: bool = False):
    """The SSD's operands as the Mamba2 block hands them over: x, B and C
    views of one (b, l, h·p + 2·g·n) tensor in ``dtype`` (x's position
    stride is that width), dt = softplus(·) and A = −exp(·) in float32, A
    (b, h) with ``a_rows`` (the vmapped clients' fold), else (h,)."""
    b, l, h, p, g, n, _ = shape
    d_in = h * p
    xbc = torch.randn(b, l, d_in + 2 * g * n, generator=gen,
                      device=DEVICE).to(dtype)
    x = xbc[..., :d_in].reshape(b, l, h, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, l, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, l, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=gen, device=DEVICE))
    A = -torch.exp(0.5 * torch.randn((b, h) if a_rows else (h,),
                                     generator=gen, device=DEVICE))
    return x, dt, A, B, C


def _ssd_bound(x, B) -> tuple[float, str, Optional[float]]:
    """The least time for one SSD call: x, dt, A, B and C read once, y and
    the state (float32) written once; or the fewest operations that give y
    and the state, at a third of the TF32 tensor-core peak (the reference
    computes in float32, and three TF32 products stand for one float32
    product: ``_tensor_bound``, whose SIMT bound comes third).  That is the
    recurrence, not the chunked form: per (b, h) and position one
    multiply-add per state entry to add x·dt ⊗ B (the decay kept as a
    running scalar) and one to read C·S, 4·N·P operations, less N·P at the
    first position, where the state is zero and the update a product."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    es = x.element_size()
    nbytes = (b * l * h * p + 2 * b * l * g * n) * es + b * l * h * 4 \
        + h * 4 + b * l * h * p * 4 + b * h * p * n * 4
    ops = b * h * (4 * l - 1) * n * p
    return _tensor_bound(nbytes, ops, torch.float32)


def _ssd_mma_ops(x, B, chunk) -> int:
    """Tensor-core operations of the SSD kernel on these inputs: per
    (b, h, chunk), over the bucket D of max(P, N) and the chunk's Lp
    positions (a multiple of SSD_ROW_TILE): ΔS (2·Lp·D²), the causal
    triangle's diagonal blocks of SSD_ROW_TILE² positions — C·Bᵀ and y's
    diagonal term, 2·SSD_ROW_TILE²·D each — and, past the first chunk,
    C·S_{c−1}ᵀ (2·Lp·D²).  Float32 inputs take every product as
    BWD_TF32_TERMS TF32 products; bfloat16 inputs C·Bᵀ as one bf16
    product and the others as two TF32 products (x, B or C exact)."""
    b, l, h, p = x.shape
    n = B.shape[3]
    D = min(d for d in SSD_BUCKETS if d >= max(p, n))
    L = min(chunk, l)
    chunks = -(-l // L)
    rows = -(-L // SSD_ROW_TILE)
    Lp = rows * SSD_ROW_TILE
    bf16 = x.dtype == torch.bfloat16
    terms = 2 if bf16 else BWD_TF32_TERMS
    blocks = rows * (rows + 1) // 2 * 2 * SSD_ROW_TILE ** 2 * D
    per_chunk = terms * 2 * Lp * D * D + blocks * ((1 if bf16 else terms)
                                                   + terms)
    off = terms * 2 * Lp * D * D
    return b * h * (chunks * per_chunk + (chunks - 1) * off)


def _ssd_bwd_mma_ops(kernel: str, x, B, L: int) -> int:
    """Tensor-core operations that the dstate and chunk kernels issue on
    these inputs (0 for chain and reduce, SIMT), over the bucket D of
    max(P, N) and row tiles of SSD_ROW_TILE positions: per (b, h) and
    chunk, its nt row tiles and the nt(nt + 1)/2 causal tile pairs.  Per
    pair, six 16 × 16 × D products, each 2·SSD_ROW_TILE²·D operations: the
    scores C·Bᵀ, x·dyᵀ and dy·xᵀ (V is formed twice, as Vᵀ for dB and as V
    for dC) and Wᵀ·dy, Vᵀ·C and V·B; per row tile, B·G_cᵀ, xdt·G_c and,
    past the first chunk, dy·S_{c−1}, 2·SSD_ROW_TILE·D² each.  dstate: ΔG
    over the chunk's tiles, 2·nt·SSD_ROW_TILE·D², chunks after the first.
    Float32 inputs take every product as BWD_TF32_TERMS TF32 products;
    bfloat16 ones C·Bᵀ as one bf16 product, the products with an exact x,
    B or C (x·dyᵀ, dy·xᵀ, Vᵀ·C, V·B, B·G_cᵀ, xdt·G_c, ΔG) as two, and those
    of float32 operands only (Wᵀ·dy, dy·S_{c−1}) as BWD_TF32_TERMS."""
    b, l, h, p = x.shape
    n = B.shape[3]
    D = min(d for d in SSD_BUCKETS if d >= max(p, n))
    c = -(-l // L)
    lengths = [min(L, l - i * L) for i in range(c)]
    tiles = [-(-lc // SSD_ROW_TILE) for lc in lengths]
    full = BWD_TF32_TERMS
    exact = 2 if x.dtype == torch.bfloat16 else full
    score_cb = 1 if x.dtype == torch.bfloat16 else full
    pair = 2 * SSD_ROW_TILE ** 2 * D
    row = 2 * SSD_ROW_TILE * D * D
    if kernel == "ssd_bwd_dstate":
        return b * h * sum(nt * row * exact for nt in tiles[1:])
    if kernel != "ssd_bwd_chunk":
        return 0
    ops = 0
    for ci, nt in enumerate(tiles):
        ops += nt * (nt + 1) // 2 * pair * (score_cb + full + 4 * exact)
        ops += nt * row * (2 * exact + (full if ci > 0 else 0))
    return b * h * ops


def _ssd_bwd_parts(kernel: str, x, B, L: int, A
                   ) -> tuple[int, int, tuple[int, int, int]]:
    """One launch of a backward kernel: (bytes of the VJP's own tensors it
    reads or writes, bytes of the intermediates between the kernels it
    reads or writes, its operations by the types of their operands).  The
    VJP's own tensors are x, dt, A, B, C, dy, dS_last, the forward's saved
    states (entering each chunk, and the final one) in, and dx, ddt, dA,
    dB, dC out; the intermediates are ΔG / G (a state per chunk), the
    chunk decays, each head's dB / dC (dBh, dCh) and each chunk's dA.
    Operations, per (b, h) and chunk of L positions, c chunks: dstate ΔG
    (2·L·P·N, chunks after the first); chain one multiply-add per state
    entry and chunk; chunk the causal triangles of C·Bᵀ, dy·xdtᵀ, Wᵀ·dy,
    Vᵀ·C and V·B (L(L+1)·(3N + 2P)) and B·G_cᵀ, xdt·G_c and dy·S_{c−1}
    (2·L·P·N each, the last after the first chunk); reduce one add per
    head entry.  They come as (bf16 × bf16, one operand exact — a bfloat16
    x, B or C against a float32 one —, float32 only): with bfloat16 inputs
    C·Bᵀ is the first; dy·xdtᵀ, Vᵀ·C, V·B, B·G_cᵀ, xdt·G_c and ΔG the
    second; Wᵀ·dy, dy·S_{c−1}, chain and reduce the third.  With float32
    inputs every operation is the third."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    es, f4 = x.element_size(), 4
    c = l // L
    state = b * h * p * n * f4
    dt_b, a_b = b * l * h * f4, A.numel() * f4
    bc = b * l * g * n * es
    heads = b * l * h * n * f4
    chunk_h = b * c * h * f4
    tri, lpn = L * (L + 1), 2 * L * p * n
    bf = exact = 0
    if kernel == "ssd_bwd_dstate":
        own = dt_b + a_b + bc + b * l * h * p * f4
        mid = (c - 1) * state + chunk_h
        exact, f32 = b * h * (c - 1) * lpn, 0
    elif kernel == "ssd_bwd_chain":
        own = state
        mid = (c - 1) * state + chunk_h + c * state
        f32 = 2 * p * n * b * h * (c - 1)
    elif kernel == "ssd_bwd_chunk":
        own = (b * l * h * p + 2 * b * l * g * n) * es + dt_b + a_b \
            + b * l * h * p * f4 + (c + 1) * state + b * l * h * p * es \
            + dt_b
        mid = c * state + 2 * heads + chunk_h
        bf = b * h * c * tri * n
        exact = b * h * c * (tri * (2 * n + p) + 2 * lpn)
        f32 = b * h * (c * tri * p + (c - 1) * lpn)
    else:
        own = 2 * bc + a_b
        mid = 2 * heads + chunk_h
        f32 = 2 * b * l * h * n
    if x.dtype != torch.bfloat16:
        bf, exact, f32 = 0, 0, bf + exact + f32
    return own, mid, (bf, exact, f32)


def _ssd_bwd_bound(kernel: str, x, B, L: int, A
                   ) -> tuple[float, str, Optional[float], int]:
    """(bound ms, "bytes" or "operations", SIMT bound ms, intermediate
    bytes) of one launch of a backward kernel: the VJP's own bytes it
    moves (``_ssd_bwd_parts``) or its operations at the peaks of their
    operand types (``_typed_bound``), whichever takes longer.  The
    intermediates' traffic is an artefact of splitting the VJP into four
    kernels and stays out of the bound; it is returned beside it."""
    own, mid, ops = _ssd_bwd_parts(kernel, x, B, L, A)
    return (*_typed_bound(own, ops), mid)


def _ssd_vjp_bound(x, B, L: int, A) -> tuple[float, str, Optional[float]]:
    """The least time for the whole SSD backward: x, dt, A, B, C, dy,
    dS_last and the saved states read once, dx, ddt, dA, dB and dC
    written once, or the four kernels' operations (``_ssd_bwd_parts``) at
    the peaks of their operand types (``_typed_bound``), whichever takes
    longer."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    es, f4 = x.element_size(), 4
    c = l // L
    state = b * h * p * n * f4
    nbytes = 2 * (b * l * h * p + 2 * b * l * g * n) * es \
        + 2 * b * l * h * f4 + 2 * A.numel() * f4 + b * l * h * p * f4 \
        + (c + 2) * state
    parts = [_ssd_bwd_parts(k, x, B, L, A)[2] for k in (
        "ssd_bwd_dstate", "ssd_bwd_chain", "ssd_bwd_chunk", "ssd_bwd_reduce")]
    return _typed_bound(nbytes, tuple(sum(col) for col in zip(*parts)))


def _ssd_bwd_check(checks: list, shape, dtype, gen, a_rows: bool,
                   ds_zero: bool) -> None:
    """The forward kernel with its states (y, the final state and the
    states entering each chunk held to SSD_TOL of the plain version's),
    then the four backward kernels against ``ref.ssd_chunked_bwd`` on the
    same inputs, each gradient within its tolerance (SSD_BWD_*)."""
    from repro_torch.kernels.ssd_scan import ops, ref
    chunk = shape[-1]
    x, dt, A, B, C = _ssd_operands(shape, dtype, gen, a_rows=a_rows)
    y, state, states = ops.ssd_scan(x, dt, A, B, C, chunk, states=True)
    for what, got, want in zip(("y", "state", "states"), (y, state, states),
                               ref.chunk_states(x, dt, A, B, C, chunk)):
        amax = float(want.abs().max())
        err = float((got - want).abs().max())
        _require(err <= SSD_TOL * max(amax, 1e-30)
                 and bool(torch.isfinite(got).all()),
                 f"ssd_scan {dtype} {shape} A rows {a_rows}: {what} max "
                 f"|err| {err} > {SSD_TOL} × {amax}")
    dy = torch.randn(y.shape, generator=gen, device=DEVICE)
    dS = (torch.zeros_like(state) if ds_zero
          else torch.randn(state.shape, generator=gen, device=DEVICE))
    got = ops.ssd_scan_bwd(x, dt, A, B, C, chunk, dy, dS, states, state)
    want = ref.ssd_chunked_bwd(x, dt, A, B, C, chunk, dy, dS)
    torch.cuda.synchronize()
    rel, err_abs = {}, {}
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        _require(g.shape == w.shape and g.dtype == w.dtype,
                 f"ssd_scan_bwd {name}: {tuple(g.shape)} {g.dtype}, the "
                 f"plain version's {tuple(w.shape)} {w.dtype}")
        tol = SSD_BWD_DA_TOL if name == "dA" else SSD_BWD_TOL
        if g.dtype == torch.bfloat16:
            tol += SSD_BWD_BF16_TOL
        amax = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        _require(err <= tol * amax and bool(torch.isfinite(g).all()),
                 f"ssd_scan_bwd {dtype} {shape} A rows {a_rows} dS zero "
                 f"{ds_zero}: {name} max |err| {err} > {tol} × {amax}")
        rel[name] = err / amax
        err_abs[name] = err
    checks.append({"kernel": "ssd_scan_bwd", "dtype": str(dtype),
                   "shape": shape, "a_rows": a_rows, "ds_zero": ds_zero,
                   "rel_err": rel, "abs_err": err_abs})


def _ssd_bwd_times(shape, dtype, gen) -> dict:
    """kernel_time lines of the four backward kernels at ``shape`` (one A
    per row at the training path's shape, as phase 17 folds its clients),
    from CUDA-graph replay, beside each one's plain stage (``ref.bwd_*``,
    graph replay), the plain backward (autograd of ``ref.ssd_chunked``,
    back to back: ``plain_ms``), the bound and the tensor-core work
    (``_ssd_bwd_mma_ops``; chain and reduce are SIMT).  No PyTorch call
    computes the SSD: no yardstick.  Returns {kernel: timing}."""
    from repro_torch.kernels.ssd_scan import ops, ref
    chunk = shape[-1]
    a_rows = shape == SSD_PATH_SHAPE
    x, dt, A, B, C = _ssd_operands(shape, dtype, gen, a_rows=a_rows)
    b, l, h, _ = x.shape
    L = min(chunk, l)
    _, state, states = ops.ssd_scan(x, dt, A, B, C, chunk, states=True)
    dy = torch.randn(x.shape, generator=gen, device=DEVICE)
    dS = torch.randn(state.shape, generator=gen, device=DEVICE)
    iters = 20 if shape == SSD_PATH_SHAPE else 3
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
    out = ref.ssd_chunked(*leaves, chunk)
    plain_ms = _time_ms(lambda: torch.autograd.grad(
        out, leaves, (dy, dS), retain_graph=True), iters)
    del out, leaves
    dG, decay = ops._launch_dstate(dt, A, C, dy, L, h)
    G = ops._launch_chain(dG, decay, dS)
    _, _, dBh, dCh, dA_chunks = ops._launch_chunk(x, dt, A, B, C, dy, states,
                                                  state, G, L)
    shared = A.dim() == 1
    entries = {
        "ssd_bwd_dstate": (lambda: ops._launch_dstate(dt, A, C, dy, L, h),
                           lambda: ref.bwd_dstate(dt, A, C, dy, L, h)),
        "ssd_bwd_chain": (lambda: ops._launch_chain(G, decay, dS),
                          lambda: ref.bwd_chain(G, decay, dS)),
        "ssd_bwd_chunk": (
            lambda: ops._launch_chunk(x, dt, A, B, C, dy, states, state, G,
                                      L),
            lambda: ref.bwd_chunk(x, dt, A, B, C, dy, states, state, G, L)),
        "ssd_bwd_reduce": (
            lambda: ops._launch_reduce(dBh, dCh, dA_chunks, B.shape[2],
                                       dtype, shared),
            lambda: ref.bwd_reduce(dBh, dCh, dA_chunks, B.shape[2], dtype,
                                   shared))}
    out = {}
    for name, (kernel, plain) in entries.items():
        bound_ms, bound_by, simt_ms, mid = _ssd_bwd_bound(name, x, B, L, A)
        timing = {"kernel": name, "dtype": str(dtype), "shape": shape,
                  "a_rows": a_rows, "ms": _graph_ms(kernel, iters),
                  "stream_ms": _time_ms(kernel, iters),
                  "plain_stage_ms": _graph_ms(plain, iters),
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "simt_bound_ms": simt_ms,
                  "intermediate_bytes": mid,
                  "intermediate_ms": mid / HBM_BYTES_PER_S * 1e3,
                  "mma_ops": _ssd_bwd_mma_ops(name, x, B, L),
                  "library_ms": None}
        _emit({"phase": "kernel_time", **timing})
        out[name] = timing
    total = sum(t["ms"] for t in out.values())
    bound_ms, bound_by, simt_ms = _ssd_vjp_bound(x, B, L, A)
    _emit({"phase": "kernel_time", "kernel": "ssd_scan_bwd (four)",
           "dtype": str(dtype), "shape": shape, "ms": total,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "simt_bound_ms": simt_ms, "x_bound": total / bound_ms,
           "intermediate_ms": sum(t["intermediate_ms"]
                                  for t in out.values())})
    return out


def _ssd_bwd_rerun(dtype, gen) -> None:
    """The four backward kernels twice at SSD_PATH_SHAPE (one A per row):
    every gradient bit-equal to the first run's (sums in a fixed order, no
    atomics)."""
    from repro_torch.kernels.ssd_scan import ops
    chunk = SSD_PATH_SHAPE[-1]
    x, dt, A, B, C = _ssd_operands(SSD_PATH_SHAPE, dtype, gen, a_rows=True)
    _, state, states = ops.ssd_scan(x, dt, A, B, C, chunk, states=True)
    dy = torch.randn(x.shape, generator=gen, device=DEVICE)
    dS = torch.randn(state.shape, generator=gen, device=DEVICE)
    first = ops.ssd_scan_bwd(x, dt, A, B, C, chunk, dy, dS, states, state)
    again = ops.ssd_scan_bwd(x, dt, A, B, C, chunk, dy, dS, states, state)
    torch.cuda.synchronize()
    for name, g, h in zip(SSD_BWD_NAMES, first, again):
        _require(torch.equal(g, h), f"ssd_scan_bwd {dtype} "
                 f"{SSD_PATH_SHAPE}: a rerun's {name} is not bit-equal")
    _emit({"phase": "ssd_backward_rerun", "dtype": str(dtype),
           "shape": SSD_PATH_SHAPE, "bit_equal": list(SSD_BWD_NAMES)})


def _ssd_backward() -> dict:
    """Part of phase 9: the backward kernels checked (``_ssd_bwd_check``)
    at SSD_SHAPES and SSD_BWD_EXTRA in float32 and bfloat16, rerun
    bit-equal at the path's shape (``_ssd_bwd_rerun``), then timed at
    SSD_TIMED.  Returns each kernel's timing at the training path's shape
    in float32 (phase 17's dtype), with the largest absolute error over
    the checks of the gradients it writes (the chunk kernel dx and ddt,
    the reduce kernel dB, dC and dA; dstate and chain, whose G feeds
    them all, every gradient)."""
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    checks = []
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, a_rows, ds_zero in ([(s, False, False) for s in SSD_SHAPES]
                                       + SSD_BWD_EXTRA):
            _ssd_bwd_check(checks, shape, dtype, gen, a_rows, ds_zero)
            torch.cuda.empty_cache()
        _ssd_bwd_rerun(dtype, gen)
        for shape in SSD_TIMED:
            times = _ssd_bwd_times(shape, dtype, gen)
            if dtype == torch.float32 and shape == SSD_PATH_SHAPE:
                timings = {name: {key: t[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                    for name, t in times.items()}
            torch.cuda.empty_cache()
    worst = {name: max(ch["rel_err"][name] for ch in checks)
             for name in SSD_BWD_NAMES}
    writes = {"ssd_bwd_chunk": ("dx", "ddt"),
              "ssd_bwd_reduce": ("dB", "dC", "dA")}
    for name, t in timings.items():
        t["max_abs_err"] = max(ch["abs_err"][g] for ch in checks
                               for g in writes.get(name, SSD_BWD_NAMES))
    _emit({"phase": "ssd_backward", "checks": len(checks),
           "worst_rel_err": worst,
           "tol": {"float32": SSD_BWD_TOL, "dA": SSD_BWD_DA_TOL,
                   "bfloat16_extra": SSD_BWD_BF16_TOL}})
    return timings


def phase_ssd_kernel() -> dict:
    """B8 against its plain version on the card at SSD_SHAPES in float32
    and bfloat16 (y and the final state), then timed at SSD_TIMED; then
    the backward kernels (``_ssd_backward``).  Returns {kernel: timing}:
    B8's at the path's shape in bfloat16 (with its worst error), the
    backward kernels' there in float32."""
    from repro_torch.kernels.ssd_scan import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    result = {"max_abs_err": 0.0}
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SSD_SHAPES:
            chunk = shape[-1]
            x, dt, A, B, C = _ssd_operands(shape, dtype, gen)
            y, state, _ = ops.ssd_scan(x, dt, A, B, C, chunk)
            want_y, want_s = ref.ssd_chunked(x, dt, A, B, C, chunk)
            torch.cuda.synchronize()
            errs = {}
            for what, got, want in (("y", y, want_y),
                                    ("state", state, want_s)):
                amax = float(want.abs().max())
                err = float((got - want).abs().max())
                _require(err <= SSD_TOL * amax
                         and bool(torch.isfinite(got).all()),
                         f"ssd_scan {dtype} {shape}: {what} max |err| "
                         f"{err} > {SSD_TOL} × {amax}")
                errs[what] = err
                result["max_abs_err"] = max(result["max_abs_err"], err)
            checks.append({"kernel": "ssd_scan", "dtype": str(dtype),
                           "shape": shape, "max_abs_err_y": errs["y"],
                           "max_abs_err_state": errs["state"],
                           "rel_err": max(errs["y"] / float(
                               want_y.abs().max()), errs["state"] / max(
                                   float(want_s.abs().max()), 1e-30)),
                           "tol": SSD_TOL})
            del y, state, want_y, want_s
            if shape in SSD_TIMED:
                iters = 50 if shape == SSD_PATH_SHAPE else 5
                bound_ms, bound_by, simt_ms = _ssd_bound(x, B)

                def kernel():
                    ops.ssd_scan(x, dt, A, B, C, chunk)

                timing = {
                    "kernel": "ssd_scan", "dtype": str(dtype),
                    "shape": shape, "ms": _graph_ms(kernel, iters),
                    "mma_ops": _ssd_mma_ops(x, B, chunk),
                    "stream_ms": _time_ms(kernel, iters),
                    "plain_ms": _graph_ms(lambda: ref.ssd_chunked(
                        x, dt, A, B, C, chunk), iters),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "simt_bound_ms": simt_ms, "library_ms": None}
                _emit({"phase": "kernel_time", **timing})
                if dtype == torch.bfloat16 and shape == SSD_PATH_SHAPE:
                    result.update({key: timing[key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")})
            del x, dt, A, B, C
            torch.cuda.empty_cache()
    _emit({"phase": "ssd_kernel", "checks": len(checks),
           "max_abs_err": result["max_abs_err"],
           "worst": max(checks, key=lambda ch: ch["rel_err"])})
    return {"ssd_scan": result, **_ssd_backward()}


def _direct_serve(cfg, params, prompt: dict, steps: int, device,
                  tokens=None, max_len: Optional[int] = None) -> dict:
    """``serve_prefill`` of the batch ``prompt`` (``serve_profile.
    prompt_batch``'s, any front end) into fresh caches of ``max_len``
    positions (default: prompt + steps), then ``steps`` greedy
    ``serve_decode`` steps — or, given ``tokens`` (rows, steps[, K]),
    those tokens (teacher forcing) — under inference mode.  Host clocks end
    in a synchronise.  Returns the logits of every step (float32, on the
    CPU), the ids fed (rows, steps[, K]), the walls and the kernels'
    launches in the prefill and in the decode steps."""
    from repro_torch.models import model as model_lib
    from repro_torch.roofline.serve_profile import next_position, step_batch
    on_card = device != "cpu"
    length = (prompt["embeds"].shape[1] if "embeds" in prompt
              else next(iter(prompt.values())).shape[-1])
    rows = next(iter(prompt.values())).shape[0]
    mrope = next_position(prompt) if cfg.frontend == "vision" else 0
    caches = model_lib.init_caches(cfg, rows, max_len or length + steps,
                                   device=device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    logits_seen, fed, step_s = [], [], []
    with torch.inference_mode():
        sync()
        _reset_all_launches()
        t0 = time.perf_counter()
        logits, caches = model_lib.serve_prefill(params, prompt, cfg,
                                                 caches=caches)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_launches = _all_launches()
        _reset_all_launches()
        for i in range(steps):
            _require(bool(torch.isfinite(logits).all()),
                     f"non-finite logits at step {i}")
            logits_seen.append(logits[:, -1].float().cpu())
            tok = (logits[:, -1].argmax(-1) if tokens is None
                   else tokens[:, i].to(device))
            fed.append(tok.cpu())
            t0 = time.perf_counter()
            logits, caches = model_lib.serve_decode(
                params, step_batch(cfg, params, tok, mrope + i), caches,
                length + i, cfg)
            sync()
            step_s.append(time.perf_counter() - t0)
        _require(bool(torch.isfinite(logits).all()),
                 "non-finite logits after the last step")
        logits_seen.append(logits[:, -1].float().cpu())
    return {"logits": torch.stack(logits_seen, 1),
            "tokens": torch.stack(fed, 1) if fed else None,
            "prefill_s": prefill_s, "step_s": step_s,
            "prefill_launches": prefill_launches,
            "decode_launches": _all_launches()}


def _hybrid_serve(cfg, params, rows: int, length: int, steps: int,
                  device, tokens=None, seed: int = 0) -> dict:
    """``_direct_serve`` of ``rows`` seeded prompts of ``length`` tokens
    into caches of HYBRID["max_len"] positions."""
    from repro_torch.roofline.serve_profile import prompt_batch
    return _direct_serve(cfg, params,
                         prompt_batch(cfg, rows, length, device, seed),
                         steps, device, tokens=tokens,
                         max_len=HYBRID["max_len"])


def phase_hybrid(cfg=None, check_cfg=None) -> dict:
    """zamba2-2.7b at full width and depth in bfloat16 through
    ``serve_prefill`` / ``serve_decode`` (HYBRID), with exact launch counts
    — one SSD per Mamba2 layer and one attention per shared-block
    application in each prefill, none in a decode step — then the float32
    cut to HYBRID["check_layers"] layers on the card against the CPU,
    teacher-forced with the card's tokens.  Returns the kernels' launch
    counts summed over the timed runs (their prefills and decode steps)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import model as model_lib
    cfg = cfg or dataclasses.replace(get_arch("zamba2-2.7b"),
                                     dtype="bfloat16")
    segments, n_groups = model_lib.group_spec(cfg)
    n_mamba = sum(count for kind, count, _ in segments
                  if kind == "mamba2") * n_groups
    n_attn = sum(count for kind, count, _ in segments
                 if kind == "attn") * n_groups
    t0 = time.perf_counter()
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = []
    tree_map(leaves.append, params)
    # warm-up (cuBLAS and cuDNN handles, the allocator) outside the count,
    # at the first prompt shape, whose kernel shapes phases 5 and 9 check
    _hybrid_serve(cfg, params, *HYBRID["prompts"][0], 2, DEVICE)
    counted: dict[str, int] = {}
    for rows, length in HYBRID["prompts"]:
        torch.cuda.reset_peak_memory_stats()
        run = _hybrid_serve(cfg, params, rows, length,
                            HYBRID["decode_steps"], DEVICE, seed=length)
        want = {name: 0 for name in run["prefill_launches"]}
        want.update({"ssd_scan": n_mamba, "flash_attention_fwd": n_attn})
        _require(run["prefill_launches"] == want,
                 f"prefill ({rows} × {length}): launches "
                 f"{run['prefill_launches']}, expected {want}")
        _require(not any(run["decode_launches"].values()),
                 f"decode steps launched {run['decode_launches']}")
        for name, n in run["prefill_launches"].items():
            counted[name] = counted.get(name, 0) + n
        decode_s = float(np.sum(run["step_s"]))
        _emit({"phase": "hybrid", "model": cfg.name, "dtype": cfg.dtype,
               "n_layers": cfg.n_layers, "mamba_layers": n_mamba,
               "attention_applications": n_attn,
               "params": sum(t.numel() for t in leaves),
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in leaves),
               "init_s": init_s, "rows": rows, "prompt_len": length,
               "max_len": HYBRID["max_len"],
               "prefill_s": run["prefill_s"],
               "prefill_tokens_per_s": rows * length / run["prefill_s"],
               "decode_steps": len(run["step_s"]),
               "wall_per_decode_step_s": decode_s / len(run["step_s"]),
               "wall_per_decode_step_p50_s": float(np.median(
                   run["step_s"])),
               "decode_tokens_per_s": rows * len(run["step_s"]) / decode_s,
               "prefill_launches": {k: n for k, n in
                                    run["prefill_launches"].items() if n},
               "decode_launches": sum(run["decode_launches"].values()),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    del params, leaves
    torch.cuda.empty_cache()

    check_cfg = check_cfg or dataclasses.replace(
        get_arch("zamba2-2.7b"), n_layers=HYBRID["check_layers"])
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(1), check_cfg)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    worst = 0.0
    for rows, length in HYBRID["check_prompts"]:
        steps = HYBRID["check_steps"]
        card = _hybrid_serve(check_cfg, params, rows, length, steps, DEVICE,
                             seed=length + 1)
        host = _hybrid_serve(check_cfg, cpu_params, rows, length, steps,
                             "cpu", tokens=card["tokens"], seed=length + 1)
        err = float((card["logits"] - host["logits"]).abs().max())
        worst = max(worst, err)
        _require(err <= LOGIT_TOL,
                 f"check ({rows} × {length}): card logits differ from the "
                 f"CPU's by {err} > {LOGIT_TOL}")
        _emit({"phase": "hybrid_vs_cpu", "model": check_cfg.name,
               "dtype": check_cfg.dtype, "n_layers": check_cfg.n_layers,
               "rows": rows, "prompt_len": length, "decode_steps": steps,
               "max_abs_logit_err": err, "tol": LOGIT_TOL,
               "logit_std": float(host["logits"].std()),
               "prefill_launches": {k: n for k, n in
                                    card["prefill_launches"].items() if n},
               "cpu_prefill_s": host["prefill_s"]})
    del params, cpu_params
    torch.cuda.empty_cache()
    return counted


# ---------------------------------------------------------------------------
# phase 11: the population path (partial participation, the paper's CNN and
# quadratics)
# ---------------------------------------------------------------------------

POPULATION_BENCH = Path(__file__).resolve().parent / "benchmarks" / \
    "population_bench.py"
# part (b): the partial_participation example's task at M = 256, C = 8
PARTIAL_RUNS = (("fedagrac", "uniform", 0.0), ("fedagrac", "round_robin", 0.0),
                ("fedagrac", "weighted", 0.0),
                ("fedagrac", "availability", 0.0),
                ("fednova", "uniform", 0.3))
PARTIAL_AVAILABILITY, PARTIAL_ROUNDS = 0.7, 5
# part (c): the paper's CNN, full width, 10 clients on DP1 (α 0.3).  Its
# ReLUs and max pools switch wherever a pre-activation, or a pool window's
# top two, sit within rounding of each other, so two float32 runs of it
# part by switch events, not by float32 noise: a run lands on one of a few
# discrete branches, and which one is chance.  Of 160 CPU reruns of each
# algorithm that change only rounding (`python -m
# repro_torch.roofline.cnn_spread`), about a fifth take a round-1 switch
# that moves the round-3 loss by 1.9-2.2e-3 (fedagrac) or 4e-4 (fedavg)
# and the params by 2.5-3.2e-3, and 3 of fedavg's move the eval accuracy
# by 36 samples where the common branches move it by 5; a card run has
# taken the round-1 switch, to the last digit of the loss.  A spread
# measured from three reruns misses such a branch, and the rule then
# refuses 13-16% of runs that differ only in rounding.  The spread is
# therefore the largest over up to CNN_MAX_PROBES CPU reruns: reversed
# rows first, then the initial weights moved one ulp each in random
# directions (seeds 1, 2, ...), at which cap the rule refuses 0.06% of
# them (fedavg; none of fedagrac's).  The reruns are drawn one at a time
# and stop once the card lies within the tolerance: each tolerance only
# grows with the reruns, so that passes exactly when the whole set would,
# and a card left outside after all of them fails.  The phase prints how
# many it drew and each one's params spread.
CNN = {"samples": 6000, "clients": 10, "alpha": 0.3, "batch": 20,
       "lr": 0.05, "lam": 0.5, "rounds": 3, "k_slow": 2, "k_fast": 20,
       "algorithms": ("fedagrac", "fedavg")}
CNN_MAX_PROBES = 128
# the objective-inconsistency twin: the reference example (same
# quadratics) ends FedAvg 1.20e-6 from the closed-form fixed point, the
# float32 floor of this computation; the card is held to PATH_SPREAD times
# it, and FedaGrac's distance to x* to the same
QUAD_JAX_EXAMPLE_DIST = 1.20e-6
QUAD_TOL = PATH_SPREAD * QUAD_JAX_EXAMPLE_DIST
# peak device memory of the M = 100k run over the ν⁽ⁱ⁾ store: a round that
# copied the store would need twice it
POP_MEMORY_SLACK = 256 * 2 ** 20


def population_settings(path: Path = POPULATION_BENCH) -> dict:
    """benchmarks/population_bench.py's population settings, read from its
    source (not imported: it imports the JAX package): C, K, the batch, the
    data width, the largest M of the full sweep, rounds, chunk, lr and λ."""
    import ast
    tree = ast.parse(path.read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                      ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            consts.update(zip(names, ast.literal_eval(node.value)))
        elif isinstance(node, ast.Assign):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    local = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                      ast.IfExp):
            local[node.targets[0].id] = ast.literal_eval(node.value.orelse)
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Name)
              and node.targets[0].id == "chunk"):
            local["chunk"] = ast.literal_eval(node.value)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "FedConfig"):
            local.update({kw.arg: ast.literal_eval(kw.value)
                          for kw in node.keywords
                          if kw.arg in ("lr", "calibration_rate",
                                        "cohort_sampler")})
    return {"cohort": consts["C"], "k": consts["K_MEAN"],
            "batch": consts["BATCH"], "d": consts["D"],
            "classes": consts["N_CLASSES"], "n_data": consts["N_DATA"],
            "m": max(local["m_list"]), "m_small": 1024,
            "rounds": local["t_rounds"], "chunk": local["chunk"],
            "lr": local["lr"], "lam": local["calibration_rate"],
            "sampler": local["cohort_sampler"]}


class _OpCounter:
    """Counts the aten operations issued while active (each one host issue
    of at least one kernel on the card)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))
        self.n = 0
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        return False


def _population_run(pop: dict, m: int, count_ops: bool = False,
                    sampler: str = "host", keep: bool = False,
                    device: Optional[str] = None, **fed_kw) -> dict:
    """FedaGrac on a population of m clients, C a round, on the card
    (``roofline.round_profile.population_simulation``, ``fed_kw`` adding
    config fields, ``sampler`` its batcher): ``pop["chunk"]`` warm-up
    rounds, then the counted run of ``pop["rounds"]`` rounds in chunks.
    ``count_ops``: then 2 more rounds under ``_OpCounter``, for the aten
    ops a round issues.  ``keep``: the simulation is returned as
    ``"sim"``.  ``device="cpu"`` runs it on the CPU (no memory figures)."""
    from repro_torch.kernels.calibrated_update import ops
    from repro_torch.roofline.round_profile import population_simulation
    device = device or DEVICE
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    sim = population_simulation(m, pop, device, sampler=sampler, **fed_kw)
    _require(sim._partial, f"M = {m}: the population path is not engaged")
    drawn = set()
    host_cohort = sim.population.host_cohort

    def recorded(t):
        ids, w = host_cohort(t)
        drawn.update(ids.tolist())
        return ids, w
    sim.population.host_cohort = recorded
    sim.run(pop["chunk"], chunk_rounds=pop["chunk"])          # warm-up
    before, before_all = dict(ops.launches), _all_launches()
    hist = sim.run(pop["rounds"], chunk_rounds=pop["chunk"])
    launches = {k: n - before[k] for k, n in ops.launches.items()}
    all_launches = _launch_delta(before_all)
    peak = None
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    nu_i = sim.state["nu_i"]
    written = int((torch.count_nonzero(nu_i, dim=1) > 0).sum())
    out = {"m": m, "launches": launches, "all_launches": all_launches,
           "loss": np.array(hist.loss), "mass": np.array(hist.mass),
           "ms_per_round": 1e3 * float(np.mean(hist.wall)),
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in sim.state.values()),
           "nu_i_bytes": nu_i.numel() * nu_i.element_size(),
           "stores_bytes": _stores_bytes(*sim.state.values()),
           "nu_i_on": str(nu_i.device), "p": sim._spec.p,
           "peak_memory_bytes": peak,
           "rows_written": written, "clients_drawn": len(drawn),
           "params_finite": bool(torch.isfinite(sim.state["params"]).all()),
           "bytes_up_per_round": hist.bytes_up[0],
           "quarantined": float(np.sum(hist.quarantined)),
           "dropped": list(hist.dropped), "cohorts": sorted(drawn)}
    if count_ops:
        with _OpCounter() as ops_count:
            sim.run(2, chunk_rounds=2)
            torch.cuda.synchronize()
        out["host_ops_per_round"] = ops_count.n / 2
        # the implicit host syncs of 2 more rounds (the chunk's own end
        # synchronises explicitly, which is not counted)
        import warnings
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sim.run(2, chunk_rounds=2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        out["implicit_syncs_per_round"] = len(caught) / 2
    if keep:
        out["sim"] = sim
    del sim, nu_i
    if on_card:
        torch.cuda.empty_cache()
    return out


def _reference_cohorts(setting: str, sampler: str) -> list:
    """The reference's committed cohorts of a setting and sampler
    (``reference_quick.json`` ``cohorts``), one list of ids a round."""
    rows = json.loads(REFERENCE_QUICK.read_text())["cohorts"]
    return next(r["ids"] for r in rows
                if r["setting"] == setting and r["sampler"] == sampler)


def _population_scale(pop: dict) -> tuple:
    """Part (a): M = 100k and M = 1024 at the same cohort; exact launches,
    the ν⁽ⁱ⁾ store on the card, and peak memory under the bound.  Returns
    the M = 100k run's launches and P, and the ms per round by M."""
    runs = {}
    for m in (pop["m_small"], pop["m"]):
        r = _population_run(pop, m)
        runs[m] = r
        want = pop["k"] * pop["rounds"]
        _require(r["launches"] == {"calibrated_update": want,
                                   "calibrated_update_prox": 0},
                 f"M = {m}: launches {r['launches']}, expected {want} of "
                 f"calibrated_update (K {pop['k']} × {pop['rounds']} "
                 f"rounds)")
        _require(np.isfinite(r["loss"]).all() and r["params_finite"],
                 f"M = {m}: non-finite loss {r['loss']} or params")
        # uniform weights under Horvitz–Thompson: C · (1/M · M/C) = 1
        _require(np.allclose(r["mass"], 1.0, rtol=0, atol=1e-5),
                 f"M = {m}: cohort masses {r['mass']}, expected 1")
        _require(r["nu_i_on"].startswith(DEVICE),
                 f"M = {m}: the ν⁽ⁱ⁾ store is on {r['nu_i_on']}")
        # every client drawn has its fresh row, no other client a row
        _require(r["rows_written"] == r["clients_drawn"],
                 f"M = {m}: {r['rows_written']} ν⁽ⁱ⁾ rows written for "
                 f"{r['clients_drawn']} clients drawn")
        bound = 1.5 * r["nu_i_bytes"] + POP_MEMORY_SLACK
        _require(r["peak_memory_bytes"] < bound,
                 f"M = {m}: peak {r['peak_memory_bytes']} bytes over "
                 f"{bound}: the round copies the ν⁽ⁱ⁾ store")
        _emit({"phase": "population", "part": "scale", "m": m,
               "cohort": pop["cohort"], "sampler": pop["sampler"],
               "k": pop["k"], "batch": pop["batch"],
               "model": f"mlp {pop['d']}-64-{pop['classes']}",
               "p": r["p"], "rounds": pop["rounds"], "chunk": pop["chunk"],
               "ms_per_round": r["ms_per_round"],
               "state_bytes": r["state_bytes"],
               "nu_i_bytes": r["nu_i_bytes"],
               "peak_memory_bytes": r["peak_memory_bytes"],
               "peak_memory_bound": bound, "launches": r["launches"],
               "rows_written": r["rows_written"],
               "bytes_up_per_round": r["bytes_up_per_round"],
               "loss": r["loss"][[0, -1]].tolist()})
    small, big = runs[pop["m_small"]], runs[pop["m"]]
    _emit({"phase": "population", "part": "flat_in_m",
           "ms_per_round": {str(pop["m_small"]): small["ms_per_round"],
                            str(pop["m"]): big["ms_per_round"]},
           "ratio": big["ms_per_round"] / small["ms_per_round"]})
    return big["launches"], big["p"], {m: r["ms_per_round"]
                                       for m, r in runs.items()}


def _run_partial(device: str, algorithm: str, sampler: str, nu_decay: float,
                 task, reverse_rows: bool = False) -> dict:
    from repro_torch.examples import partial_participation as ex
    from repro_torch.fed import FederatedSimulation
    from repro_torch.kernels.calibrated_update import ops
    from repro_torch.models.simple import lr_accuracy, lr_init, lr_loss
    data, parts = task
    x_eval, y_eval = data.x.to(device), data.y.to(device)
    fed = ex.fed_config(algorithm, cohort_size=ex.C, cohort_sampler=sampler,
                        availability=PARTIAL_AVAILABILITY,
                        cohort_nu_decay=nu_decay)
    sim = FederatedSimulation(
        lr_loss, lr_init(torch.Generator(), 60, 10), fed,
        _batcher(data, parts, device, reverse_rows, batch_size=ex.BATCH),
        k_schedule=ex.schedule(), device=device,
        eval_fn=lambda p: float(lr_accuracy(p, {"x": x_eval, "y": y_eval})))
    cohorts = []
    host_cohort = sim.population.host_cohort

    def recorded(t):
        ids, w = host_cohort(t)
        cohorts.append(ids.tolist())
        return ids, w
    sim.population.host_cohort = recorded
    before = dict(ops.launches)
    hist = sim.run(PARTIAL_ROUNDS, eval_every=PARTIAL_ROUNDS)
    return {"loss": np.array(hist.loss), "metric": np.array(hist.metric),
            "params": sim.state["params"].cpu(), "cohorts": cohorts,
            "launches": {k: ops.launches[k] - before[k] for k in before},
            "wall_per_round_s": float(np.mean(hist.wall))}


def _partial_vs_cpu() -> None:
    """Part (b): the partial_participation example's task at M = 256, C =
    8, on the card against the CPU, each sampler; both must see the same
    cohorts."""
    from repro_torch.examples import partial_participation as ex
    task = ex.task()
    n_eval = len(task[0])
    for algorithm, sampler, nu_decay in PARTIAL_RUNS:
        g, c, p = (_run_partial(dev, algorithm, sampler, nu_decay, task, rev)
                   for dev, rev in ((DEVICE, False), ("cpu", False),
                                    ("cpu", True)))
        name = f"{algorithm}/{sampler}"
        _require(g["cohorts"] == c["cohorts"] == p["cohorts"],
                 f"{name}: the card saw cohorts {g['cohorts']}, the CPU "
                 f"{c['cohorts']}")
        want_ids = _reference_cohorts("partial_participation", sampler)
        _require(g["cohorts"] == want_ids[:PARTIAL_ROUNDS],
                 f"{name}: cohorts {g['cohorts']}, the reference's "
                 f"{want_ids[:PARTIAL_ROUNDS]}")
        want = PARTIAL_ROUNDS * ex.K_STEPS
        _require(g["launches"]["calibrated_update"] == want,
                 f"{name}: launches {g['launches']}, expected {want} of "
                 f"calibrated_update")
        _require(np.isfinite(g["loss"]).all(), f"{name}: non-finite loss")
        vs = _vs_cpu(name, g, c, p, n_eval=n_eval)
        _emit({"phase": "population", "part": "vs_cpu", "m": ex.M,
               "cohort": ex.C, "algorithm": algorithm, "sampler": sampler,
               "nu_decay": nu_decay, "rounds": PARTIAL_ROUNDS,
               "cohorts": g["cohorts"], "loss": g["loss"].tolist(),
               "metric": g["metric"].tolist(), "launches": g["launches"],
               "wall_per_round_s": g["wall_per_round_s"],
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})


def _run_cnn(device: str, algorithm: str, data, parts, params0,
             reverse_rows: bool = False) -> dict:
    from repro_torch.configs.base import FedConfig
    from repro_torch.fed import FederatedSimulation
    from repro_torch.kernels.calibrated_update import ops
    from repro_torch.models.simple import cnn_accuracy, cnn_loss
    x_eval, y_eval = data.x.to(device), data.y.to(device)
    ks = np.full((1, CNN["clients"]), CNN["k_slow"], np.int32)
    ks[0, -1] = CNN["k_fast"]
    fed = FedConfig(algorithm=algorithm, n_clients=CNN["clients"],
                    lr=CNN["lr"], calibration_rate=CNN["lam"],
                    weights="data", param_layout="flat")
    sim = FederatedSimulation(
        cnn_loss, params0, fed,
        _batcher(data, parts, device, reverse_rows, batch_size=CNN["batch"]),
        k_schedule=ks, device=device,
        eval_fn=lambda p: float(cnn_accuracy(p, {"x": x_eval,
                                                 "y": y_eval})))
    before = dict(ops.launches)
    hist = sim.run(CNN["rounds"], eval_every=CNN["rounds"])
    return {"loss": np.array(hist.loss), "metric": np.array(hist.metric),
            "params": sim.state["params"].cpu(), "p": sim._spec.p,
            "launches": {k: ops.launches[k] - before[k] for k in before},
            "wall_per_round_s": float(np.mean(hist.wall))}


def _ulp_moved(params: dict, seed: int) -> dict:
    """Every weight moved to a float32 neighbour, up or down at random, or
    left (a third each)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in params.items():
        step = torch.randint(-1, 2, v.shape, generator=gen)
        out[k] = torch.where(step > 0, torch.nextafter(v, v + 1),
                             torch.where(step < 0,
                                         torch.nextafter(v, v - 1), v))
    return out


def _cnn_vs_cpu() -> int:
    """Part (c), the CNN: DP1 over 10 clients, the bimodal K, card against
    CPU, exactly one B1 launch a local step.  Returns P."""
    from repro_torch.data import dirichlet_partition, image_classification
    from repro_torch.models.simple import cnn_init
    data = image_classification(torch.Generator().manual_seed(0),
                                CNN["samples"])
    parts = dirichlet_partition(data.y.numpy(), CNN["clients"],
                                CNN["alpha"], seed=0)
    params0 = cnn_init(torch.Generator().manual_seed(0))
    p = 0
    for algorithm in CNN["algorithms"]:
        g = _run_cnn(DEVICE, algorithm, data, parts, params0)
        c = _run_cnn("cpu", algorithm, data, parts, params0)
        sp = [_run_cnn("cpu", algorithm, data, parts, params0, True)]
        while (not _vs_covered(_vs_cpu_margins(g, c, sp, CNN["samples"]))
               and len(sp) < CNN_MAX_PROBES):
            sp.append(_run_cnn("cpu", algorithm, data, parts,
                               _ulp_moved(params0, len(sp))))
        want = CNN["k_fast"] * CNN["rounds"]
        _require(g["launches"] == {"calibrated_update": want,
                                   "calibrated_update_prox": 0},
                 f"cnn {algorithm}: launches {g['launches']}, expected "
                 f"{CNN['k_fast']} a round")
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"cnn {algorithm}: non-finite loss or metric")
        vs = _vs_cpu(f"cnn {algorithm}", g, c, sp, n_eval=CNN["samples"])
        p = g["p"]
        _emit({"phase": "population", "part": "cnn", "algorithm": algorithm,
               **{k: CNN[k] for k in ("samples", "clients", "alpha",
                                      "batch", "lr", "lam", "rounds")},
               "k": f"{CNN['clients'] - 1} at {CNN['k_slow']}, 1 at "
                    f"{CNN['k_fast']}",
               "p": p, "sizes": [len(q) for q in parts],
               "loss": g["loss"].tolist(), "metric": g["metric"].tolist(),
               "launches": g["launches"],
               "launches_per_round": g["launches"]["calibrated_update"]
               / CNN["rounds"],
               "wall_per_round_s": g["wall_per_round_s"],
               "cpu_wall_per_round_s": c["wall_per_round_s"],
               "probes": len(sp), "max_probes": CNN_MAX_PROBES,
               "probe_params_spread": [
                   float((q["params"] - c["params"]).abs().max())
                   for q in sp],
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return p


def _update_at_graph(shape) -> dict:
    """B1 at a path's float32 ``shape`` against its plain version, in both
    forms the cohort round launches (fedagrac's c, fedavg's none), then
    timed from CUDA-graph replay beside the plain version."""
    from repro_torch.kernels.calibrated_update import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    x, g, c, _, eta, active = _operands(shape, torch.float32, gen)
    max_err = 0.0
    for c_arg in (c, None):
        got = ops.calibrated_update(x, g, c_arg, eta, LAM)
        want = ref.calibrated_update(x, g, c_arg, eta, LAM)
        err = (got - want).abs()
        max_err = max(max_err, float(err.max()))
        _require(bool((err <= KERNEL_TOL[torch.float32]
                       * (1 + want.abs())).all()),
                 f"calibrated_update {shape}: max |err| {max_err}")
        _require(torch.equal(got[~active], x[~active]),
                 f"calibrated_update {shape}: an η = 0 row moved")
    args = (x, g, c, eta, LAM)
    bound_ms, bound_by = _bound([x, g, c, eta], x, 4)
    timing = {"kernel": "calibrated_update", "dtype": str(torch.float32),
              "shape": shape,
              "ms": _graph_ms(lambda: ops.calibrated_update(*args), 500),
              "stream_ms": _time_ms(lambda: ops.calibrated_update(*args),
                                    500),
              "plain_ms": _graph_ms(lambda: ref.calibrated_update(*args),
                                    500),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": None}
    _emit({"phase": "kernel_check", "kernel": "calibrated_update",
           "dtype": str(torch.float32), "shape": shape, "forms": 2,
           "max_abs_err": max_err, "tol": KERNEL_TOL[torch.float32]})
    _emit({"phase": "kernel_time", **timing})
    return timing


def _quadratics_on_card() -> None:
    """Part (c), the objective_inconsistency twin on the card: FedAvg ends
    at the closed-form fixed point, FedaGrac at x*."""
    from repro_torch.core import theory
    from repro_torch.data.synthetic import quadratic_clients
    from repro_torch.examples import objective_inconsistency as ex
    As, bs = quadratic_clients(ex.QUAD_SEED, ex.M, ex.D, hetero=1.5)
    x_star = theory.global_optimum(As, bs, ex.W)
    fp = theory.fedavg_fixed_point(As, bs, ex.W, ex.K, ex.LR)
    t0 = time.perf_counter()
    avg = ex.trajectory("fedavg", 0.0, As, bs, DEVICE)
    grac = ex.trajectory("fedagrac", 1.0, As, bs, DEVICE)
    wall = time.perf_counter() - t0
    d_fp = float(np.linalg.norm(avg[-1] - fp))
    d_star = float(np.linalg.norm(grac[-1] - x_star))
    gap = float(np.linalg.norm(fp - x_star))
    _require(np.isfinite(avg).all() and np.isfinite(grac).all(),
             "quadratics: non-finite iterates")
    _require(d_fp <= QUAD_TOL, f"quadratics: FedAvg ends {d_fp} from its "
                               f"closed-form fixed point, over {QUAD_TOL}")
    _require(d_star <= QUAD_TOL, f"quadratics: FedaGrac ends {d_star} from "
                                 f"x*, over {QUAD_TOL}")
    _require(gap > 0.5, f"quadratics: the fixed point is only {gap} from x*")
    _emit({"phase": "population", "part": "quadratics", "m": ex.M,
           "d": ex.D, "k": ex.K.tolist(), "lr": ex.LR, "rounds": ex.T,
           "fedavg_to_fixed_point": d_fp, "fedagrac_to_x_star": d_star,
           "fixed_point_to_x_star": gap, "tol": QUAD_TOL,
           "jax_example_fedavg_to_fixed_point": QUAD_JAX_EXAMPLE_DIST,
           "wall_s": wall})


def phase_population(pop: Optional[dict] = None) -> dict:
    """Phase 11.  Returns B1's timing at the population round's (C, P)."""
    pop = pop or population_settings()
    _emit({"phase": "population_settings",
           "source": "benchmarks/population_bench.py", **pop})
    launches, p, host_ms = _population_scale(pop)
    _partial_vs_cpu()
    p_cnn = _cnn_vs_cpu()
    timing = _update_at_graph((pop["cohort"], p))
    _update_at_graph((CNN["clients"], p_cnn))
    _quadratics_on_card()
    return {"launches": launches, "timing": timing,
            "host_mode_ms": host_ms}


# ---------------------------------------------------------------------------
# phase 12: the paper's experiments as port twins
# ---------------------------------------------------------------------------

REFERENCE_QUICK = Path(__file__).resolve().parent / "src" / "repro_torch" / \
    "benchmarks" / "reference_quick.json"
# the twins phase 12 drives at their --quick size, in this order
TWINS = ("thm1", "table1", "table2", "fig2", "fairness")
TWIN_EVAL = 4000                      # the synthetic task's eval samples
TWIN_CLIENT_EVAL = 400                # one client's samples (fairness)
# printed accuracies carry 4 decimals: two such roundings apart
TWIN_PRINT_SLACK = 1e-4
# thm1's columns and their printed decimals
THM1_COLUMNS = {"fedavg_to_fixed_point": 6, "fedavg_to_opt": 4,
                "fedavg_subopt": 4, "thm1_rhs": 4, "fedagrac_to_opt": 6}
# The mlp rows (table1's, fig2's) on the card against the same runs on the
# CPU by phase 3's rule: PATH_SPREAD × the spread of a CPU rerun with every
# microbatch's rows reversed, plus the floors.  The mlp's ReLUs, like the
# CNN's (ROADMAP C12, C14), switch where a pre-activation sits within
# rounding of zero, so float32 runs of it can part by a switch event: the
# card's table1 mlp non-IID run did at round 22 (loss 1.46e-4 off, my chip
# run 1 of PR 21), which no rerun with reordered rows or one-ulp moved
# weights reproduced: neither changes how a sample's pre-activations
# round.  A rerun with the model's input features and hidden units
# relabelled (the same function; every GEMM sums in another order, as the
# card's do) lands on such branches: 3 of 24 reruns of that run took the
# card's, 6 of 24 of the IID run two others (`python -m
# repro_torch.roofline.twin_spread`).  So where the reversed-row rerun
# leaves the card outside, relabelled reruns (seeds 1, 2, ...) are drawn
# one at a time until it is covered, at most TWIN_MAX_PROBES, as phase 11
# does for the CNN: each tolerance only grows with reruns, so this passes
# exactly when all of them would.  fig2's λ = 2 under asynchronism
# over-calibrates and amplifies rounding (the JAX package ends it at
# 0.101, the port's CPU at 0.4708) and is held the same way.
TWIN_MAX_PROBES = 64
# the twins whose mlp runs are held to the CPU; a worker process runs them
# there while the card runs them
TWINS_ON_CPU = ("table1", "fig2")


class _RecordedRuns:
    """While active, records every ``FederatedSimulation.run`` (or every
    ``run`` of ``cls``, the buffered engine's): the simulation, its initial
    weights, the run's arguments and history."""

    def __init__(self, cls=None):
        from repro_torch.fed import simulation
        self.cls = cls or simulation.FederatedSimulation
        self.runs: list = []

    def __enter__(self):
        orig = self.orig = self.cls.run
        runs = self.runs

        def run(sim, t_rounds, *args, **kwargs):
            params0 = {k: v.cpu() for k, v in sim.params.items()}
            hist = orig(sim, t_rounds, *args, **kwargs)
            runs.append({"sim": sim, "params0": params0, "rounds": t_rounds,
                         "args": args, "kwargs": kwargs, "hist": hist,
                         "params": sim.state["params"].cpu()})
            return hist
        self.cls.run = run
        return self.runs

    def __exit__(self, *exc):
        self.cls.run = self.orig
        return False


def _relabelled(params: dict, features: torch.Tensor,
                hidden: torch.Tensor) -> dict:
    """The mlp with its input features and hidden units renumbered: the
    same function of the renumbered features."""
    return {"w1": params["w1"][features][:, hidden].contiguous(),
            "b1": params["b1"][hidden].contiguous(),
            "w2": params["w2"][hidden].contiguous(),
            "b2": params["b2"].clone()}


def _cpu_rerun(rec: dict, order: Optional[torch.Tensor] = None,
               relabel_seed: Optional[int] = None,
               device: str = "cpu") -> dict:
    """A recorded run again on the CPU (or ``device``): the same config, K
    and λ schedules (and clock, for the buffered engine), data,
    partitions, batcher seed and initial weights.  Given ``order``, every
    microbatch's rows in that order; given ``relabel_seed``, the mlp's
    input features and hidden units relabelled by seeded permutations, and
    its final weights mapped back (both the same computation, other
    float32 roundings)."""
    from repro_torch.core import flat
    from repro_torch.data import Dataset, FederatedBatcher
    from repro_torch.fed import BufferedAsyncSimulation, FederatedSimulation
    from repro_torch.models import simple
    sim, b = rec["sim"], rec["sim"].batcher
    data, params0 = b.data, rec["params0"]
    if relabel_seed is not None:
        gen = torch.Generator().manual_seed(relabel_seed)
        features = torch.randperm(params0["w1"].shape[0], generator=gen)
        hidden = torch.randperm(params0["w1"].shape[1], generator=gen)
        data = Dataset(x=data.x[:, features].contiguous(), y=data.y)
        params0 = _relabelled(params0, features, hidden)

    class Batcher(FederatedBatcher):
        # every path (rounds, cohorts, both engines) gathers its rows
        # through _gather: (…, B) indices, a microbatch's rows on the last
        # axis
        def _gather(self, idx):
            return super()._gather(idx if order is None
                                   else idx[..., order.numpy()])

    accuracy = {simple.lr_loss: simple.lr_accuracy,
                simple.mlp_loss: simple.mlp_accuracy}[sim._loss_fn]
    eval_set = {"x": data.x.to(device), "y": data.y.to(device)}
    kw = dict(eval_fn=lambda p: float(accuracy(p, eval_set)),
              k_schedule=sim.k_schedule, lam_schedule=sim.lam_schedule,
              device=device)
    batcher = Batcher(data, b.parts, b.batch_size, seed=b.seed,
                      device=device)
    if isinstance(sim, BufferedAsyncSimulation):
        rerun = BufferedAsyncSimulation(sim._loss_fn, params0, sim.fed,
                                        batcher, clock=sim.clock, **kw)
    else:
        rerun = FederatedSimulation(sim._loss_fn, params0, sim.fed, batcher,
                                    **kw)
    hist = rerun.run(rec["rounds"], *rec["args"], **rec["kwargs"])
    params = {k: v.cpu() for k, v in rerun.params.items()}
    if relabel_seed is not None:
        params = _relabelled(params, torch.argsort(features),
                             torch.argsort(hidden))
    params = flat.ravel(flat.make_flat_spec(params), params)
    return {"loss": np.array(hist.loss), "metric": np.array(hist.metric),
            "params": params, "dropped": hist.dropped,
            "sim_time": hist.sim_time, "staleness": hist.staleness}


def _trajectory(rec: dict) -> dict:
    hist = rec["hist"]
    return {"loss": np.array(hist.loss), "metric": np.array(hist.metric),
            "params": rec["params"]}


def _mlp_runs_on_cpu(names) -> dict:
    """The twins ``names`` through their ``main(quick=True)`` on the CPU
    (a worker process's job): for each mlp run its trajectory and its
    rerun with every microbatch's rows reversed, None for the others."""
    import contextlib
    import io
    from repro_torch.benchmarks.run import MODULES
    torch.set_num_threads(2)
    out = {}
    for name in names:
        with _RecordedRuns() as runs, \
                contextlib.redirect_stdout(io.StringIO()):
            MODULES[name].main(quick=True, device="cpu")
        out[name] = [
            {"plain": _trajectory(rec), "reversed": _cpu_rerun(
                rec, torch.arange(rec["sim"].batcher.batch_size - 1, -1,
                                  -1))}
            if rec["sim"]._loss_fn.__name__ == "mlp_loss" else None
            for rec in runs]
    return out


def _twin_on_card(name: str) -> dict:
    """One twin's ``main(quick=True)`` on the card: its printed rows (also
    printed here), the runs it made, its seconds."""
    import contextlib
    import io
    from repro_torch.benchmarks.run import MODULES
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _RecordedRuns() as runs, contextlib.redirect_stdout(buf):
        MODULES[name].main(quick=True, device=DEVICE)
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    header, *rows = [ln.split(",") for ln in text.strip().splitlines()]
    return {"header": header, "rows": rows, "runs": runs, "s": seconds}


def _close(card: str, ref: str, tol: float) -> bool:
    return abs(float(card) - float(ref)) <= tol


def _rounds_agree(card: str, ref: str, margin: float) -> bool:
    """Equal rounds to target, unless the reference sat within
    PATH_SAMPLES samples of the target up to its crossing round."""
    return card == ref or margin * TWIN_EVAL <= PATH_SAMPLES


def _check_lr_rows(name: str, got: dict, ref: dict) -> None:
    """table1's lr rows, table2 and fairness against the reference's quick
    rows: accuracies within PATH_SAMPLES samples of their eval set (4000;
    400 for one client, and the across-client std, which moves no more
    than the largest client's change), rounds to target by
    ``_rounds_agree``."""
    acc_tol = PATH_SAMPLES / TWIN_EVAL + TWIN_PRINT_SLACK
    client_tol = PATH_SAMPLES / TWIN_CLIENT_EVAL + TWIN_PRINT_SLACK
    for i, (row, want) in enumerate(zip(got["rows"], ref["rows"])):
        if name == "table1" and row[1] != "lr":
            continue
        key = 2 if name == "fairness" else 3
        _require(row[:key] == want[:key],
                 f"{name}: row {row} does not line up with {want}")
        if name == "fairness":
            ok = (_close(row[2], want[2], acc_tol)
                  and all(_close(row[j], want[j], client_tol)
                          for j in (3, 4, 5)))
        else:
            ok = (_close(row[4], want[4], acc_tol)
                  and _rounds_agree(row[3], want[3],
                                    ref["target_margin"][i]))
        _require(ok, f"{name}: the card's row {row} is not the reference's "
                     f"{want} within PATH_SAMPLES ({PATH_SAMPLES}) samples")
        _emit({"phase": "twins", "module": name, "row": row,
               "reference": want})


def _check_thm1_rows(got: dict, ref: dict) -> None:
    """Each distance within QUAD_TOL of the reference's printed one (plus
    a unit of its last printed decimal: both are rounded); FedAvg at its
    closed-form fixed point and FedaGrac at x*, each within QUAD_TOL."""
    cols = {c: got["header"].index(c) for c in THM1_COLUMNS}
    for row, want in zip(got["rows"], ref["rows"]):
        _require(row[:2] == want[:2], f"thm1: row {row} is not {want}")
        for col, j in cols.items():
            tol = QUAD_TOL + 10.0 ** -THM1_COLUMNS[col]
            _require(_close(row[j], want[j], tol),
                     f"thm1 {row[1]}: {col} {row[j]} against the "
                     f"reference's {want[j]}, over {tol}")
        for col in ("fedavg_to_fixed_point", "fedagrac_to_opt"):
            _require(float(row[cols[col]]) <= QUAD_TOL,
                     f"thm1 {row[1]}: {col} = {row[cols[col]]}, over "
                     f"QUAD_TOL {QUAD_TOL}")
        _emit({"phase": "twins", "module": "thm1", "row": row,
               "reference": want})


def _check_mlp_rows(name: str, got: dict, ref: dict, cpu: list) -> None:
    """The mlp runs against the same twin's runs on the CPU (``cpu``, from
    ``_mlp_runs_on_cpu``) by phase 3's rule, reruns added as
    TWIN_MAX_PROBES says; each row printed beside the reference's and the
    CPU's final accuracy."""
    for row, want, rec, on_cpu in zip(got["rows"], ref["rows"], got["runs"],
                                      cpu):
        if name == "table1" and row[1] != "mlp":
            continue
        _require(row[:3] == want[:3] and on_cpu is not None,
                 f"{name}: row {row} does not line up with {want}")
        g = _trajectory(rec)
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"{name} {row}: non-finite loss or metric on the card")
        c, probes = on_cpu["plain"], [on_cpu["reversed"]]
        while (not _vs_covered(_vs_cpu_margins(g, c, probes, TWIN_EVAL))
               and len(probes) < TWIN_MAX_PROBES):
            probes.append(_cpu_rerun(rec, relabel_seed=len(probes)))
        vs = _vs_cpu(f"{name} {row}", g, c, probes, TWIN_EVAL)
        _emit({"phase": "twins", "module": name, "row": row,
               "reference": want, "cpu_final_acc": float(c["metric"][-1]),
               "probes": len(probes),
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})


def _twin_launches(name: str, got: dict) -> dict:
    """B1 / B2 launches the twin's runs must make: every local step of
    every round launches one, fedprox's the prox kernel (B2)."""
    want = {"calibrated_update": 0, "calibrated_update_prox": 0}
    if name == "thm1":
        from repro_torch.benchmarks import thm1_quadratic as thm1
        want["calibrated_update"] = (len(thm1.HETERO) * len(thm1.ALGORITHMS)
                                     * thm1.T_QUICK * int(thm1.K.max()))
        return want
    for rec in got["runs"]:
        kernel = ("calibrated_update_prox"
                  if rec["sim"].fed.algorithm == "fedprox"
                  else "calibrated_update")
        want[kernel] += rec["rounds"] * rec["sim"].k_max
    return want


def _continuous_batching_on_card() -> dict:
    """The continuous_batching twin on the card: returns its launches of
    the attention kernel (every prefill's layers; none in decode)."""
    from repro_torch.examples import continuous_batching as ex
    from repro_torch.kernels.flash_attention import ops as fa_ops
    before = fa_ops.launches["flash_attention_fwd"]
    out = ex.main(["--device", DEVICE])
    launched = fa_ops.launches["flash_attention_fwd"] - before
    want = ex.config().n_layers * len(ex.REQUESTS)
    _require(launched == want,
             f"continuous_batching: {launched} attention launches, expected "
             f"{want} (every layer of each of {len(ex.REQUESTS)} prefills, "
             f"none in decode)")
    _emit({"phase": "twins", "module": "continuous_batching",
           "ticks": out["ticks"], "tokens": out["tokens"],
           "tokens_per_tick": out["tokens_per_tick"], "wall_s": out["wall_s"],
           "flash_attention_fwd": launched})
    return {"flash_attention_fwd": launched}


def phase_twins() -> dict:
    """Phase 12.  Returns the launches of its run."""
    import multiprocessing
    reference = json.loads(REFERENCE_QUICK.read_text())["modules"]
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        on_cpu = pool.apply_async(_mlp_runs_on_cpu, (TWINS_ON_CPU,))
        _reset_all_launches()
        got = {name: _twin_on_card(name) for name in TWINS}
        cb = _continuous_batching_on_card()
        launches = _all_launches()
        cpu = on_cpu.get()
    want = {"calibrated_update": 0, "calibrated_update_prox": 0}
    for name in TWINS:
        for k, n in _twin_launches(name, got[name]).items():
            want[k] += n
    _require({k: launches[k] for k in want} == want,
             f"twins: calibrated-update launches {launches}, expected {want}"
             f" (one a local step of every round)")
    _require(launches["flash_attention_fwd"] == cb["flash_attention_fwd"],
             f"twins: attention launches {launches} outside the serving "
             f"twin's prefills")
    for name, n in launches.items():
        if name not in want and name != "flash_attention_fwd":
            _require(n == 0, f"twins: {name} launched {n} times")
    for name in TWINS:
        g, ref = got[name], reference[name]
        _require(g["header"] == ref["header"] and len(g["rows"]) ==
                 len(ref["rows"]), f"{name}: header {g['header']} or "
                                   f"{len(g['rows'])} rows against the "
                                   f"reference's {ref['header']}")
        if name == "thm1":
            _check_thm1_rows(g, ref)
        else:
            if name != "fig2":
                _check_lr_rows(name, g, ref)
            if name in TWINS_ON_CPU:
                _check_mlp_rows(name, g, ref, cpu[name])
        walls = [w for rec in g["runs"] for w in rec["hist"].wall]
        _emit({"phase": "twins", "module": name, "s": g["s"],
               "runs": len(g["runs"]),
               "rounds": sum(rec["rounds"] for rec in g["runs"]),
               "wall_per_round_s": float(np.mean(walls)) if walls else None})
    _emit({"phase": "twins", "launches": launches, "expected": want})
    return launches


# ---------------------------------------------------------------------------
# phase 13: buffered semi-asynchronous rounds
# ---------------------------------------------------------------------------

# part (b): the table_async fleet (10 clients, lognormal speeds σ = 1 from
# seed 7, K = 40 for every task) on benchmarks/common.py's tasks at full
# width; each run ``updates`` buffered updates, evaluated at the end
FLEET = {"k": 40, "sigma": 1.0, "clock_seed": 7, "updates": 10}
# (algorithm, λ, buffer, staleness, uplink, broadcast): buffered FedaGrac
# (the table's tempered row), FedBuff, and FedaGrac's buffer with an int8
# uplink and broadcast, and with a top-k uplink
FLEET_RUNS = (("fedagrac", 0.5, 8, "hinge", "none", "none"),
              ("fedavg", 1.0, 5, "constant", "none", "none"),
              ("fedagrac", 0.5, 8, "hinge", "int8", "int8"),
              ("fedagrac", 0.5, 8, "hinge", "topk", "none"))
# part (c): phase 11's population setting on the buffered engine, its
# cohort of 8 as the clients in flight and the buffer
ASYNC_POP_UPDATES = 48


def _launch_delta(before: dict) -> dict:
    now = _all_launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _check_table_async_rows(got: dict, ref: dict) -> None:
    """table_async's rows (all on the lr task) against the reference's
    quick rows by phase 12's rule: the settings equal, updates to target
    equal unless the reference sat within PATH_SAMPLES samples of the
    target (then the simulated seconds too), the accuracy at the budget
    within PATH_SAMPLES samples, the mean staleness (host) equal."""
    acc_tol = PATH_SAMPLES / TWIN_EVAL + TWIN_PRINT_SLACK
    _require(got["header"] == ref["header"]
             and len(got["rows"]) == len(ref["rows"]),
             f"table_async: {got['header']} / {len(got['rows'])} rows "
             f"against {ref['header']} / {len(ref['rows'])}")
    for i, (row, want) in enumerate(zip(got["rows"], ref["rows"])):
        ok = (row[:4] == want[:4] and row[7] == want[7]
              and _rounds_agree(row[4], want[4], ref["target_margin"][i])
              and (row[4] != want[4] or row[5] == want[5])
              and _close(row[6], want[6], acc_tol))
        _require(ok, f"table_async: the card's row {row} is not the "
                     f"reference's {want} by phase 12's rule")
        _emit({"phase": "async", "part": "table_async", "row": row,
               "reference": want})


def _table_async_on_card(reference: dict) -> dict:
    """Part (a): the table_async twin's ``main(quick=True)`` on the card;
    its rows against the reference's, its buffer = M run against its own
    synchronous FedaGrac run by phase 3's rule (the spread a rerun of that
    run on the card with reversed rows), one B1 launch a local step."""
    import contextlib
    import io
    from repro_torch.benchmarks import table_async
    from repro_torch.fed import BufferedAsyncSimulation
    buf = io.StringIO()
    before = _all_launches()
    t0 = time.perf_counter()
    with _RecordedRuns() as sync_runs, \
            _RecordedRuns(BufferedAsyncSimulation) as async_runs, \
            contextlib.redirect_stdout(buf):
        table_async.main(quick=True, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = _launch_delta(before)
    text = buf.getvalue()
    print(text, end="", flush=True)
    lines = text.strip().splitlines()
    header, *rows = [ln.split(",") for ln in lines if not ln.startswith("#")]
    _check_table_async_rows({"header": header, "rows": rows}, reference)
    want = sum(rec["rounds"] * rec["sim"].k_max
               for rec in sync_runs + async_runs)
    _require(launches == {"calibrated_update": want},
             f"table_async: launches {launches}, expected {want} of "
             f"calibrated_update (k_max × rounds or updates of each run)")
    sync = next(r for r in sync_runs if r["sim"].fed.algorithm == "fedagrac")
    full = next(r for r in async_runs
                if r["sim"].buffer == r["sim"].fed.n_clients)
    g, c = _trajectory(full), _trajectory(sync)
    _require(np.isfinite(g["loss"]).all() and np.isfinite(g["metric"]).all(),
             "table_async async_full: non-finite loss or metric")
    rev = torch.arange(sync["sim"].batcher.batch_size - 1, -1, -1)
    p = _cpu_rerun(sync, rev, device=DEVICE)
    vs = _vs_cpu("table_async async_full vs sync", g, c, p)
    _require(any("(OK)" in ln for ln in lines if ln.startswith("# buffer")),
             f"table_async: the drift check did not pass: {lines[-1]}")
    walls = [w for rec in async_runs for w in rec["hist"].wall]
    _emit({"phase": "async", "part": "table_async", "s": seconds,
           "runs": len(sync_runs) + len(async_runs),
           "updates": sum(r["rounds"] for r in async_runs),
           "wall_per_update_s": float(np.mean(walls)),
           "launches": launches, "notes": [ln for ln in lines
                                           if ln.startswith("#")],
           "async_full_vs_sync": {k: float(np.max(d))
                                  for k, (d, _) in vs.items()},
           "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return launches


def _table_async_run(reference: dict) -> dict:
    """Part (a) in a worker process (started beside phase 12, whose twins
    are as host-bound): returns the launches of its runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _table_async_on_card(reference)


def _fleet_run(kind: str, run: tuple, device: str) -> dict:
    """One FLEET_RUNS entry on ``device``: the recorded run, its launches
    and wire model."""
    from repro_torch.benchmarks.common import make_task
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import compress
    from repro_torch.fed import BufferedAsyncSimulation
    from repro_torch.fed.clock import make_clock
    algorithm, lam, buffer, staleness, up, down = run
    task = make_task(kind, noniid=True, device=device)
    m, t = task.batcher.m, FLEET["updates"]
    fed = FedConfig(algorithm=algorithm, n_clients=m, lr=task.lr,
                    calibration_rate=lam, weights="data",
                    buffer_size=buffer, staleness=staleness,
                    staleness_a=0.5, staleness_b=2, compressor=up,
                    broadcast_compressor=down, param_layout="flat")
    sim = BufferedAsyncSimulation(
        task.loss_fn, task.params, fed, task.batcher, eval_fn=task.eval_fn,
        k_schedule=np.full((t * m + 1, m), FLEET["k"], np.int32),
        clock=make_clock(m, dist="lognormal", sigma=FLEET["sigma"],
                         seed=FLEET["clock_seed"]), device=device)
    params0 = {k: v.cpu() for k, v in sim.params.items()}
    before = _all_launches()
    hist = sim.run(t, eval_every=t)
    return {"sim": sim, "params0": params0, "rounds": t, "args": (),
            "kwargs": {"eval_every": t}, "hist": hist,
            "params": sim.state["params"].cpu(),
            "launches": _launch_delta(before),
            "wire": compress.wire_cost(sim._spec.n, sim.algo.uses_nu,
                                       sim.compression)}


def _fleet_launches(run: tuple, sim) -> dict:
    """B1 once a local step; each codec once a quantity (delta, and ν's
    transmit for ν algorithms) an update, and the broadcast's once more at
    t = 0."""
    _, _, _, _, up, down = run
    t, q = FLEET["updates"], 2 if sim.algo.uses_nu else 1
    want = {"calibrated_update": t * FLEET["k"]}
    for name in ("quantize_2d", "dequantize_2d", "topk_mask_2d"):
        n = (t * q * (CODEC_LAUNCHES[up].get(name, 0)
                      + CODEC_LAUNCHES[down].get(name, 0))
             + q * CODEC_LAUNCHES[down].get(name, 0))
        if n:
            want[name] = n
    return want


def _fleet_vs_cpu() -> None:
    """Part (b): each FLEET_RUNS entry on lr and mlp, card against CPU by
    phase 3's rule (the mlp's ReLU branches sampled by relabelled reruns,
    as phase 12 does), exact launches and wire bytes; one compressed run
    twice on the card, bit for bit (the repeated reporters' scatters are
    resolved on the host: no write races)."""
    rev = torch.arange(19, -1, -1)                     # batch 20
    for kind in ("lr", "mlp"):
        for run in FLEET_RUNS:
            g = _fleet_run(kind, run, DEVICE)
            sim, hist = g["sim"], g["hist"]
            name = f"{kind}/{run[0]} λ={run[1]} buffer={run[2]} " \
                   f"{run[3]} up={run[4]} down={run[5]}"
            want = _fleet_launches(run, sim)
            _require(g["launches"] == want,
                     f"{name}: launches {g['launches']}, expected {want}")
            wire = g["wire"]
            _require(hist.bytes_up == [run[2] * wire["uplink_per_client"]]
                     * FLEET["updates"]
                     and hist.bytes_down
                     == [run[2] * wire["downlink_per_client"]]
                     * FLEET["updates"],
                     f"{name}: bytes {hist.bytes_up[0]} / "
                     f"{hist.bytes_down[0]} an update, expected "
                     f"{run[2]} × {wire}")
            gt = _trajectory(g)
            _require(np.isfinite(gt["loss"]).all()
                     and np.isfinite(gt["metric"]).all(),
                     f"{name}: non-finite loss or metric")
            c = _cpu_rerun(g)
            probes = [_cpu_rerun(g, rev)]
            while (kind == "mlp"
                   and not _vs_covered(_vs_cpu_margins(gt, c, probes))
                   and len(probes) < TWIN_MAX_PROBES):
                probes.append(_cpu_rerun(g, relabel_seed=len(probes)))
            vs = _vs_cpu(name, gt, c, probes)
            repeats = sum(len(set(r)) < len(r) for r in _timeline(sim).ids
                          .tolist())
            _emit({"phase": "async", "part": "fleet", "task": kind,
                   "algorithm": run[0], "lam": run[1], "buffer": run[2],
                   "staleness": run[3], "uplink": run[4],
                   "broadcast": run[5], "updates": FLEET["updates"],
                   "k": FLEET["k"], "p": sim._spec.p,
                   "buffers_with_a_repeated_reporter": repeats,
                   "loss": gt["loss"].tolist(),
                   "metric": gt["metric"].tolist(),
                   "sim_time": hist.sim_time[-1],
                   "mean_staleness": float(np.mean(hist.staleness)),
                   "wall_per_update_s": float(np.mean(hist.wall)),
                   "launches": g["launches"],
                   "bytes_up_per_update": hist.bytes_up[0],
                   "bytes_down_per_update": hist.bytes_down[0],
                   "params_digest": _digest(g["params"]),
                   "probes": len(probes),
                   "vs_cpu": {k: float(np.max(d))
                              for k, (d, _) in vs.items()},
                   "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
            _require(repeats > 0, f"{name}: no buffer repeats a reporter")
    # the same compressed run twice on the card: equal to the last bit
    runs = [_fleet_run("lr", FLEET_RUNS[2], DEVICE) for _ in range(2)]
    a, b = (r["sim"].state for r in runs)
    # the anchor buffers' rows 0…M-1 (row M is the scratch row that takes
    # a repeated client's earlier re-dispatches, in any order)
    anchors = [(r["sim"]._anchors[:-1], r["sim"]._nu_anchors[:-1])
               for r in runs]
    _require(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                            for k in a)
             and runs[0]["hist"].loss == runs[1]["hist"].loss
             and all(torch.equal(x, y) for x, y in zip(*anchors)),
             "lr/fedagrac int8: two runs on the card differ")
    _emit({"phase": "async", "part": "determinism",
           "run": "lr/fedagrac buffer=8 up=int8 down=int8",
           "state_digests": {k: _digest(v) for k, v in sorted(a.items())}})


def _timeline(sim):
    from repro_torch.fed.clock import simulate_timeline
    return simulate_timeline(sim.k_schedule, sim.clock, sim.buffer,
                             FLEET["updates"], population=sim.population)


def _stores_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and t.dim() == 2)


def _async_population_run(pop: dict, m: int, **fed_kw) -> dict:
    """The buffered engine on phase 11's setting at m clients, C = 8 in
    flight and a buffer of 8: a warm-up chunk, then ASYNC_POP_UPDATES
    updates in chunks; peak memory from before the simulation is built."""
    from repro_torch.fed.clock import simulate_timeline
    from repro_torch.roofline.round_profile import \
        population_async_simulation
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sim = population_async_simulation(m, pop, DEVICE, **fed_kw)
    _require(not sim.population.full_participation
             and sim.buffer == pop["cohort"],
             f"M = {m}: the buffered population path is not engaged")
    sim.run(pop["chunk"], chunk_updates=pop["chunk"])          # warm-up
    before = _all_launches()
    hist = sim.run(ASYNC_POP_UPDATES, chunk_updates=pop["chunk"])
    launches = _launch_delta(before)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    nu_i = sim.state["nu_i"]
    tl = simulate_timeline(sim.k_schedule, sim.clock, sim.buffer,
                           ASYNC_POP_UPDATES, population=sim.population)
    out = {"m": m, "launches": launches, "loss": np.array(hist.loss),
           "mass": np.array(hist.mass),
           "ms_per_update": 1e3 * float(np.mean(hist.wall)),
           "stores_bytes": _stores_bytes(*sim.state.values(), sim._anchors,
                                         sim._nu_anchors),
           "peak_memory_bytes": peak, "p": sim._spec.p,
           "rows_written": int((torch.count_nonzero(nu_i, dim=1) > 0).sum()),
           "reporters": len(set(tl.ids.ravel().tolist())),
           "anchors_on": str(sim._anchors.device),
           "params_finite": bool(torch.isfinite(sim.state["params"]).all()),
           "mean_staleness": float(np.mean(hist.staleness)),
           "params_digest": _digest(sim.state["params"])}
    del sim, nu_i
    torch.cuda.empty_cache()
    return out


def _check_population_memory(what: str, r: dict) -> float:
    bound = 1.5 * r["stores_bytes"] + POP_MEMORY_SLACK
    _require(r["peak_memory_bytes"] < bound,
             f"{what}: peak {r['peak_memory_bytes']} bytes over {bound}: "
             f"an update copies an (M, P) store")
    return bound


def _async_population_scale(pop: dict) -> None:
    """Part (c): M = 100k and M = 1024, then an int8 uplink at 100k, on the
    buffered engine; then the compressed cohort round at 100k.  Exact
    launches, peak memory under 1.5 × the stores + 256 MB, every
    reporter's ν⁽ⁱ⁾ row written and no other."""
    k, t = pop["k"], ASYNC_POP_UPDATES
    runs = {}
    for m, comp in ((pop["m_small"], "none"), (pop["m"], "none"),
                    (pop["m"], "int8")):
        r = _async_population_run(pop, m, compressor=comp)
        runs[(m, comp)] = r
        want = {"calibrated_update": k * t}
        if comp == "int8":
            want.update(quantize_2d=2 * t, dequantize_2d=2 * t)
        _require(r["launches"] == want,
                 f"async M = {m} {comp}: launches {r['launches']}, "
                 f"expected {want}")
        _require(np.isfinite(r["loss"]).all() and r["params_finite"],
                 f"async M = {m} {comp}: non-finite loss or params")
        _require(r["anchors_on"].startswith(DEVICE),
                 f"async M = {m}: the anchor buffers are on "
                 f"{r['anchors_on']}")
        _require(r["rows_written"] == r["reporters"],
                 f"async M = {m} {comp}: {r['rows_written']} ν⁽ⁱ⁾ rows "
                 f"written for {r['reporters']} reporting clients")
        bound = _check_population_memory(f"async M = {m} {comp}", r)
        _emit({"phase": "async", "part": "population", "engine": "buffered",
               "m": m, "cohort": pop["cohort"], "buffer": pop["cohort"],
               "k": k, "updates": t, "chunk": pop["chunk"],
               "uplink": comp, "p": r["p"],
               "ms_per_update": r["ms_per_update"],
               "stores_bytes": r["stores_bytes"],
               "peak_memory_bytes": r["peak_memory_bytes"],
               "peak_memory_bound": bound, "launches": r["launches"],
               "rows_written": r["rows_written"],
               "mean_staleness": r["mean_staleness"],
               "params_digest": r["params_digest"],
               "loss": r["loss"][[0, -1]].tolist()})
    small, big = runs[(pop["m_small"], "none")], runs[(pop["m"], "none")]
    _emit({"phase": "async", "part": "flat_in_m",
           "ms_per_update": {str(pop["m_small"]): small["ms_per_update"],
                             str(pop["m"]): big["ms_per_update"]},
           "ratio": big["ms_per_update"] / small["ms_per_update"]})
    r = _population_run(pop, pop["m"], compressor="int8")
    want = {"calibrated_update": k * pop["rounds"], "quantize_2d":
            2 * pop["rounds"], "dequantize_2d": 2 * pop["rounds"]}
    got = r["all_launches"]
    _require(got == want, f"compressed cohort round M = {pop['m']}: "
                          f"launches {got}, expected {want}")
    _require(np.isfinite(r["loss"]).all() and r["params_finite"]
             and r["rows_written"] == r["clients_drawn"],
             f"compressed cohort round M = {pop['m']}: non-finite, or "
             f"{r['rows_written']} rows for {r['clients_drawn']} clients")
    bound = _check_population_memory(
        f"compressed cohort round M = {pop['m']}", r)
    _emit({"phase": "async", "part": "population", "engine": "cohort_round",
           "m": pop["m"], "cohort": pop["cohort"], "k": k,
           "rounds": pop["rounds"], "uplink": "int8",
           "ms_per_round": r["ms_per_round"],
           "stores_bytes": r["stores_bytes"],
           "peak_memory_bytes": r["peak_memory_bytes"],
           "peak_memory_bound": bound, "launches": got,
           "bytes_up_per_round": r["bytes_up_per_round"]})


def phase_async(pop: Optional[dict] = None, table_async=None) -> dict:
    """Phase 13.  Returns the launches of its runs on the card.
    ``table_async``: part (a) already started in a worker (an
    ``AsyncResult`` of ``_table_async_run``), collected here."""
    reference = json.loads(REFERENCE_QUICK.read_text())["modules"]
    _reset_all_launches()
    if table_async is None:
        _table_async_on_card(reference["table_async"])
    _fleet_vs_cpu()
    _async_population_scale(pop or population_settings())
    launches = _all_launches()
    if table_async is not None:
        for name, n in table_async.get().items():
            launches[name] += n
    _emit({"phase": "async", "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 14: failure scenarios and robust aggregation
# ---------------------------------------------------------------------------

# the two twins phase 14 (a) drives at their --quick size
FAULT_TWINS = ("scenario", "robust")
# part (b): the timing scenarios on the mlp, each on the synchronous and
# the buffered engine (the table's lognormal fleet, K 40): name -> config
# knobs (scenario_bench's, diurnal with its availability sampler)
TIMING_SCENARIOS = {
    "dropout": {"dropout_rate": 0.3, "rejoin_delay": 2.0},
    "spike": {"scenario_rate": 0.4, "scenario_magnitude": 8.0},
    "flaky": {"scenario_rate": 0.3, "scenario_magnitude": 5.0},
    "diurnal": {"scenario_period": 16.0, "cohort_size": 8,
                "cohort_sampler": "availability"},
}
FAULT_SYNC_ROUNDS, FAULT_UPDATES = 5, 10
# part (c): phase 11's population setting under a scale attack (10 % of
# the clients, ×25) on the int8 wire, defended by each DEFENSES entry with
# a quarantine of 4 rounds, against no defense at all
FAULT_POP = {"scenario": "scale_attack", "scenario_rate": 0.1,
             "scenario_magnitude": 25.0, "compressor": "int8"}
FAULT_POP_DEFENSE = "trimmed_mean"


def _check_scenario_rows(got: dict, ref: dict) -> None:
    """scenario_bench's rows (lr) against the reference's quick rows: the
    settings, the abort fraction (host) equal; updates to target by
    phase 12's rule, the simulated seconds equal where the updates are;
    the final accuracy within PATH_SAMPLES samples."""
    acc_tol = PATH_SAMPLES / TWIN_EVAL + TWIN_PRINT_SLACK
    for i, (row, want) in enumerate(zip(got["rows"], ref["rows"])):
        ok = (row[:3] == want[:3] and row[6] == want[6]
              and _rounds_agree(row[4], want[4], ref["target_margin"][i])
              and (row[4] != want[4] or row[5] == want[5])
              and _close(row[3], want[3], acc_tol))
        _require(ok, f"scenario: the card's row {row} is not the "
                     f"reference's {want} by phase 12's rule")
        _emit({"phase": "faults", "part": "scenario", "row": row,
               "reference": want})


def _check_robust_rows(got: dict, ref: dict) -> None:
    """robust_bench's rows (lr) against the reference's quick rows: the
    settings, survival and quarantined-client rounds equal; the final
    accuracy (a mean of 5 evaluations) within PATH_SAMPLES samples, rounds
    to target by phase 12's rule."""
    acc_tol = PATH_SAMPLES / TWIN_EVAL + TWIN_PRINT_SLACK
    for i, (row, want) in enumerate(zip(got["rows"], ref["rows"])):
        ok = (row[:3] == want[:3] and row[5] == want[5]
              and (row[3] == want[3] == "-"
                   or ("-" not in (row[3], want[3])
                       and _close(row[3], want[3], acc_tol)))
              and _rounds_agree(row[4], want[4], ref["target_margin"][i]))
        _require(ok, f"robust: the card's row {row} is not the "
                     f"reference's {want} by phase 12's rule")
        _emit({"phase": "faults", "part": "robust", "row": row,
               "reference": want})


def _fault_twin_run(name: str, device: str) -> dict:
    """One fault twin's ``main(quick=True)`` on ``device``, in this process
    or a worker's: its printed text and seconds, the kernel launches its
    runs made and the B1 launches they must make (one a local step of
    every round or update), the walls of its rounds."""
    import contextlib
    import io
    from repro_torch.benchmarks.run import MODULES
    from repro_torch.fed import BufferedAsyncSimulation
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    buf = io.StringIO()
    before = _all_launches()
    t0 = time.perf_counter()
    with _RecordedRuns() as sync_runs, \
            _RecordedRuns(BufferedAsyncSimulation) as async_runs, \
            contextlib.redirect_stdout(buf):
        MODULES[name].main(quick=True, device=device)
    runs = sync_runs + async_runs
    return {"text": buf.getvalue(), "s": time.perf_counter() - t0,
            "launches": _launch_delta(before),
            "want": sum(rec["rounds"] * rec["sim"].k_max for rec in runs),
            "runs": len(runs),
            "walls": [w for rec in runs for w in rec["hist"].wall]}


def _fault_twins_on_card(reference: dict) -> dict:
    """Part (a): the scenario and robust twins' ``main(quick=True)`` on the
    card, their rows against the reference's; one B1 launch a local step
    of every run.  Both are host-bound, so the robust twin runs in a
    worker process (on another core of the card's host) while this one
    runs the scenario twin.  Returns the worker's launches."""
    import multiprocessing
    first, second = FAULT_TWINS
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        worker = pool.apply_async(_fault_twin_run, (second, DEVICE))
        got = {first: _fault_twin_run(first, DEVICE)}
        got[second] = worker.get()
    for name in FAULT_TWINS:
        g = got[name]
        print(g["text"], end="", flush=True)
        lines = g["text"].strip().splitlines()
        header, *rows = [ln.split(",") for ln in lines
                         if not ln.startswith("#")]
        ref = reference[name]
        _require(header == ref["header"] and len(rows) == len(ref["rows"]),
                 f"{name}: {header} / {len(rows)} rows against "
                 f"{ref['header']} / {len(ref['rows'])}")
        (_check_scenario_rows if name == "scenario"
         else _check_robust_rows)({"header": header, "rows": rows}, ref)
        _require(g["launches"] == {"calibrated_update": g["want"]},
                 f"{name}: launches {g['launches']}, expected {g['want']} "
                 f"of calibrated_update (k_max × rounds or updates of each "
                 f"run)")
        _emit({"phase": "faults", "part": name, "s": g["s"],
               "runs": g["runs"], "launches": g["launches"],
               "wall_per_round_s": float(np.mean(g["walls"])),
               "worker": name == second,
               "notes": [ln for ln in lines if ln.startswith("#")]})
    return got[second]["launches"]


def _timing_run(engine: str, name: str, device: str) -> dict:
    """One TIMING_SCENARIOS entry on the mlp (benchmarks/common.py's task,
    the lognormal fleet, K 40) on ``engine`` ("sync" or "buffered"): the
    recorded run and its launches."""
    from repro_torch.benchmarks.common import make_task
    from repro_torch.configs.base import FedConfig
    from repro_torch.fed import BufferedAsyncSimulation, FederatedSimulation
    from repro_torch.fed.clock import make_clock
    task = make_task("mlp", noniid=True, device=device)
    m = task.batcher.m
    knobs = dict(TIMING_SCENARIOS[name])
    t = FAULT_SYNC_ROUNDS if engine == "sync" else FAULT_UPDATES
    kw = dict(algorithm="fedagrac", n_clients=m, lr=task.lr,
              calibration_rate=0.5, weights="data", param_layout="flat",
              scenario=name, **knobs)
    ks = np.full((t * m + 1, m), FLEET["k"], np.int32)
    if engine == "sync":
        sim = FederatedSimulation(task.loss_fn, task.params,
                                  FedConfig(**kw), task.batcher,
                                  eval_fn=task.eval_fn, k_schedule=ks,
                                  device=device)
    else:
        kw.update(buffer_size=min(m // 2, knobs.get("cohort_size", m)),
                  staleness="poly", staleness_a=0.5, staleness_b=2)
        sim = BufferedAsyncSimulation(
            task.loss_fn, task.params, FedConfig(**kw), task.batcher,
            eval_fn=task.eval_fn, k_schedule=ks,
            clock=make_clock(m, dist="lognormal", sigma=FLEET["sigma"],
                             seed=FLEET["clock_seed"]), device=device)
    params0 = {k: v.cpu() for k, v in sim.params.items()}
    before = _all_launches()
    hist = sim.run(t, eval_every=t)
    return {"sim": sim, "params0": params0, "rounds": t, "args": (),
            "kwargs": {"eval_every": t}, "hist": hist,
            "params": sim.state["params"].cpu(),
            "launches": _launch_delta(before)}


def _timing_vs_cpu() -> None:
    """Part (b): each timing scenario on the mlp, synchronous and buffered,
    card against CPU by phase 3's rule (relabelled reruns for the ReLU
    branches, ROADMAP C14); ``History.dropped`` and the timeline's
    simulated times and staleness equal to the CPU's exactly (host draws:
    the reference's keyed streams); one B1 launch a local step."""
    rev = torch.arange(19, -1, -1)                     # batch 20
    for engine in ("sync", "buffered"):
        for name in TIMING_SCENARIOS:
            g = _timing_run(engine, name, DEVICE)
            sim, hist = g["sim"], g["hist"]
            label = f"mlp/{engine}/{name}"
            want = {"calibrated_update": g["rounds"] * sim.k_max}
            _require(g["launches"] == want,
                     f"{label}: launches {g['launches']}, expected {want}")
            gt = _trajectory(g)
            _require(np.isfinite(gt["loss"]).all()
                     and np.isfinite(gt["metric"]).all(),
                     f"{label}: non-finite loss or metric")
            c = _cpu_rerun(g)
            _require(hist.dropped == c["dropped"]
                     and hist.sim_time == c["sim_time"]
                     and hist.staleness == c["staleness"],
                     f"{label}: dropped / sim_time / staleness differ from "
                     f"the CPU's: {hist.dropped} vs {c['dropped']}")
            probes = [_cpu_rerun(g, rev)]
            while (not _vs_covered(_vs_cpu_margins(gt, c, probes))
                   and len(probes) < TWIN_MAX_PROBES):
                probes.append(_cpu_rerun(g, relabel_seed=len(probes)))
            vs = _vs_cpu(label, gt, c, probes)
            _emit({"phase": "faults", "part": "timing", "engine": engine,
                   "scenario": name, "rounds": g["rounds"],
                   "k": FLEET["k"], "dropped": hist.dropped,
                   "mass": hist.mass, "sim_time": hist.sim_time[-1:]
                   if hist.sim_time else [],
                   "loss": gt["loss"].tolist(),
                   "metric": gt["metric"].tolist(),
                   "wall_per_round_s": float(np.mean(hist.wall)),
                   "launches": g["launches"], "probes": len(probes),
                   "vs_cpu": {k: float(np.max(d))
                              for k, (d, _) in vs.items()},
                   "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
            if name in ("dropout", "spike"):
                _require(any(d > 0 for d in hist.dropped),
                         f"{label}: no client dropped")


def _defended_population_scale(pop: dict) -> None:
    """Part (c): the attacked, defended int8 cohort round (FAULT_POP,
    trimmed mean, a quarantine of 4) at M = 100,000 and 1024: exact
    launches, ms per round flat in M, peak memory under 1.5 × the (M, P)
    stores + 256 MB (no round copies ν⁽ⁱ⁾, the error-feedback rows or the
    health vectors), the params finite, every drawn client's ν⁽ⁱ⁾ row
    written; then each defense against none at M = 100,000: wall and
    launches per round (the defenses are host-issued torch ops on a
    host-bound round)."""
    from repro_torch.fed.scenarios import _corrupt_set
    k, rounds = pop["k"], pop["rounds"]
    _require(_corrupt_set(pop["m"], 0, FAULT_POP["scenario_rate"]).any(),
             "the population's corrupt set is empty")
    defended = dict(FAULT_POP, defense=FAULT_POP_DEFENSE,
                    quarantine_window=4)
    runs = {}
    for m in (pop["m_small"], pop["m"]):
        r = _population_run(pop, m, count_ops=m == pop["m"], **defended)
        runs[m] = r
        want = {"calibrated_update": k * rounds, "quantize_2d": 2 * rounds,
                "dequantize_2d": 2 * rounds}
        _require(r["all_launches"] == want,
                 f"defended cohort round M = {m}: launches "
                 f"{r['all_launches']}, expected {want}")
        _require(np.isfinite(r["loss"]).all() and r["params_finite"]
                 and r["rows_written"] == r["clients_drawn"],
                 f"defended cohort round M = {m}: non-finite, or "
                 f"{r['rows_written']} rows for {r['clients_drawn']} "
                 f"clients")
        bound = _check_population_memory(
            f"defended cohort round M = {m}", r)
        _emit({"phase": "faults", "part": "population", "m": m,
               "cohort": pop["cohort"], "k": k, "rounds": rounds,
               **defended, "p": r["p"], "ms_per_round": r["ms_per_round"],
               "stores_bytes": r["stores_bytes"],
               "peak_memory_bytes": r["peak_memory_bytes"],
               "peak_memory_bound": bound, "launches": r["all_launches"],
               "quarantined": r["quarantined"],
               "loss": r["loss"][[0, -1]].tolist()})
    small, big = runs[pop["m_small"]], runs[pop["m"]]
    _emit({"phase": "faults", "part": "flat_in_m",
           "ms_per_round": {str(pop["m_small"]): small["ms_per_round"],
                            str(pop["m"]): big["ms_per_round"]},
           "ratio": big["ms_per_round"] / small["ms_per_round"]})
    from repro_torch.core.robust import DEFENSES
    walls = {}
    for defense in ("none",) + tuple(d for d in DEFENSES if d != "none"):
        if defense == FAULT_POP_DEFENSE:
            r = big
        else:
            kw = dict(FAULT_POP, defense=defense,
                      quarantine_window=0 if defense == "none" else 4)
            r = _population_run(pop, pop["m"], count_ops=True, **kw)
            _require(np.isfinite(r["loss"]).all(),
                     f"M = {pop['m']} {defense}: non-finite loss")
        walls[defense] = r["ms_per_round"]
        _emit({"phase": "faults", "part": "defense_cost", "m": pop["m"],
               "defense": defense, "ms_per_round": r["ms_per_round"],
               "launches_per_round": {
                   name: n / rounds for name, n in
                   r["all_launches"].items()},
               "host_ops_per_round": r["host_ops_per_round"],
               "implicit_syncs_per_round": r["implicit_syncs_per_round"],
               "quarantined": r["quarantined"]})
    _emit({"phase": "faults", "part": "defense_cost_vs_none",
           "ms_per_round_over_none": {d: w - walls["none"]
                                      for d, w in walls.items()}})


def _robust_stage_syncs() -> None:
    """Part (c), first: the attack and every defense's stages (the
    defense alone; the model and ν stages, with and without a
    quarantine) on the card at the population's (8, 4608) rows issue no
    implicit host sync (``torch.cuda.set_sync_debug_mode("error")``)."""
    from repro_torch.core import robust
    from repro_torch.fed import scenarios
    b, p, n = 8, 4608, 4554
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = torch.randn(b, p, device=DEVICE, generator=gen)
    rows[:, n:] = 0
    w = torch.full((b,), 1.0 / b, device=DEVICE)
    ids = torch.arange(b, device=DEVICE) * 7
    r = torch.zeros((), dtype=torch.int32, device=DEVICE)
    atk = scenarios.scale_attack_scenario(100, rate=0.3, magnitude=25.0)
    atk.corrupt_delta(r, rows, n, ids=ids)      # the per-device corrupt set
    spec = dataclasses.make_dataclass("Spec", ["n"])(n)

    def no_sync(label, fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            raise RuntimeError(f"{label}: an implicit host sync: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")

    no_sync("scale_attack", lambda: atk.corrupt_delta(r, rows, n, ids=ids))
    checked = 0
    for name in robust.DEFENSES:
        for window in (0, 4):
            cfg = robust.RobustConfig(defense=name, quarantine_window=window)
            rb = robust.build_round_robust(cfg, spec, True)
            state = {k: torch.zeros(100, dtype=dt, device=DEVICE)
                     for k, dt in zip(robust.ROBUST_STATE_KEYS,
                                      (torch.int32, torch.float32,
                                       torch.float32, torch.int32,
                                       torch.int32))}
            quar = rb.quarantined(state, r, ids)
            mask = torch.ones(b, dtype=torch.bool, device=DEVICE)
            no_sync(name, lambda: robust.DEFENSES[name](cfg, n)(rows, mask))
            no_sync(f"{name} model, window {window}", lambda: rb.model(
                rows, w, state, dict(state), r, ids, quar, in_place=True))
            no_sync(f"{name} nu, window {window}",
                    lambda: rb.nu(rows, w, quar))
            checked += 3
    _emit({"phase": "faults", "part": "robust_stage_syncs",
           "stages_checked": checked + 1, "implicit_syncs": 0})


def phase_faults(pop: Optional[dict] = None) -> dict:
    """Phase 14.  Returns the launches of its runs on the card."""
    reference = json.loads(REFERENCE_QUICK.read_text())["modules"]
    _reset_all_launches()
    _robust_stage_syncs()
    in_worker = _fault_twins_on_card(reference)
    _timing_vs_cpu()
    _defended_population_scale(pop or population_settings())
    launches = _all_launches()
    for name, n in in_worker.items():
        launches[name] += n
    _emit({"phase": "faults", "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 15: the device-sampled, checkpointed path
# ---------------------------------------------------------------------------

# (b): rounds a device-mode chunk runs, and the dropout the in-chunk
# scenario hook applies
DEVICE_CHUNK = 8
DEVICE_DROPOUT = {"scenario": "dropout", "dropout_rate": 0.3}
# (c): phase 14's attacked int8 wire, defended, resumed halfway
RESUME = {"m": 1024, "rounds": 24, **FAULT_POP,
          "defense": FAULT_POP_DEFENSE, "quarantine_window": 4}
# (c): room the M = 100,000 checkpoint needs beyond its own bytes
CKPT_DISK_SLACK = 1 << 30


def _device_draw(pop: dict) -> None:
    """Part (a): 48 rounds of phase 11's uniform cohort at M = 100,000 —
    the cohorts against the reference's committed ones, the card's
    ``DeviceBatcher`` row indices against ``fed/keyed.py``'s numpy draw,
    element for element."""
    from repro_torch.fed import ClientPopulation, keyed
    from repro_torch.roofline.round_profile import _population_parts
    m, rounds = pop["m"], pop["rounds"]
    batcher, _, _ = _population_parts(m, pop, DEVICE, "device")
    population = ClientPopulation(m, cohort_size=pop["cohort"],
                                  sampler=pop["sampler"], seed=0)
    cohorts = np.stack([population.cohort(t) for t in range(rounds)])
    # the committed cohorts are population_bench's largest M's
    checked = m == 100_000
    if checked:
        want_ids = _reference_cohorts("population_bench", pop["sampler"])
        _require(cohorts.tolist() == want_ids[:rounds],
                 f"device draw: cohorts at M = {m} are not the reference's")
    ts = np.arange(rounds)
    t0 = time.perf_counter()
    card = batcher.rows(torch.from_numpy(ts)[:, None],
                        torch.from_numpy(cohorts), pop["k"]).cpu().numpy()
    card_s = time.perf_counter() - t0
    keys = keyed.fold_in(keyed.fold_in(keyed.prng_key(0), ts[:, None]),
                         cohorts)
    sizes = np.array([len(p) for p in batcher.parts])
    u = keyed.randint(keys, (pop["k"], pop["batch"]), sizes[cohorts])
    parts = batcher.parts
    host = np.array([[[[parts[i][v] for v in row] for row in u[j, c]]
                      for c, i in enumerate(cohorts[j])]
                     for j in range(rounds)])
    _require(card.shape == host.shape and np.array_equal(card, host),
             f"device draw: the card's indices differ from the keyed numpy "
             f"draw at {int(np.sum(card != host))} of {host.size}")
    _emit({"phase": "device_path", "part": "draw", "m": m,
           "rounds": rounds, "cohort": pop["cohort"],
           "indices": int(host.size), "card_draw_s": card_s,
           "cohorts_equal_reference": checked})


def _device_population_scale(pop: dict, host_ms: dict):
    """Part (b): the device-mode population chunk at M = 100,000 and 1024,
    beside phase 11's host-mode ms per round by M (``host_ms``); then the
    same run at 1024 under dropout through the in-chunk hook, card against
    CPU.  Returns the M = 100,000 simulation (for (c)'s timing)."""
    dpop = dict(pop, chunk=DEVICE_CHUNK)
    runs = {}
    for m in (pop["m_small"], pop["m"]):
        r = _population_run(dpop, m, sampler="device", keep=m == pop["m"])
        runs[m] = r
        want = pop["k"] * pop["rounds"]
        _require(r["launches"] == {"calibrated_update": want,
                                   "calibrated_update_prox": 0},
                 f"device mode M = {m}: launches {r['launches']}, "
                 f"expected {want} of calibrated_update")
        _require(np.isfinite(r["loss"]).all() and r["params_finite"],
                 f"device mode M = {m}: non-finite loss or params")
        _require(r["rows_written"] == r["clients_drawn"],
                 f"device mode M = {m}: {r['rows_written']} ν⁽ⁱ⁾ rows for "
                 f"{r['clients_drawn']} clients")
        bound = 1.5 * r["nu_i_bytes"] + POP_MEMORY_SLACK
        peak = r["peak_memory_bytes"]
        _require(peak is None or peak < bound,
                 f"device mode M = {m}: peak {peak} over {bound}")
        _emit({"phase": "device_path", "part": "population", "m": m,
               "cohort": pop["cohort"], "k": pop["k"],
               "rounds": pop["rounds"], "chunk": DEVICE_CHUNK,
               "ms_per_round": r["ms_per_round"],
               "host_mode_ms_per_round": host_ms.get(m),
               "nu_i_bytes": r["nu_i_bytes"],
               "peak_memory_bytes": r["peak_memory_bytes"],
               "peak_over_store_bytes": None if peak is None
               else peak - r["nu_i_bytes"], "launches": r["launches"],
               "b1_per_round": r["launches"]["calibrated_update"]
               / pop["rounds"]})
    small, big = runs[pop["m_small"]], runs[pop["m"]]
    _emit({"phase": "device_path", "part": "flat_in_m",
           "ms_per_round": {str(pop["m_small"]): small["ms_per_round"],
                            str(pop["m"]): big["ms_per_round"]},
           "ratio": big["ms_per_round"] / small["ms_per_round"]})
    card = _population_run(dpop, pop["m_small"], sampler="device",
                           **DEVICE_DROPOUT)
    cpu = _population_run(dpop, pop["m_small"], sampler="device",
                          device="cpu", **DEVICE_DROPOUT)
    _require(card["dropped"] == cpu["dropped"]
             and any(d > 0 for d in card["dropped"]),
             f"device-mode dropout: dropped {card['dropped']} on the card, "
             f"{cpu['dropped']} on the CPU")
    _require(card["cohorts"] == cpu["cohorts"],
             "device-mode dropout: the card drew other cohorts")
    _require(np.isfinite(card["loss"]).all(),
             "device-mode dropout: non-finite loss")
    _emit({"phase": "device_path", "part": "dropout", "m": pop["m_small"],
           "rate": DEVICE_DROPOUT["dropout_rate"], "rounds": pop["rounds"],
           "dropped": card["dropped"], "ms_per_round": card["ms_per_round"],
           "launches": card["launches"],
           "loss_vs_cpu": float(np.max(np.abs(card["loss"] - cpu["loss"])))})
    return big["sim"]


def _resume_on_card(pop: dict) -> None:
    """Part (c), first: 24 + 24 rounds on one simulation against 24, a
    checkpoint, a fresh simulation restored from it and 24 more — equal to
    the last bit on the card."""
    import tempfile
    from repro_torch.checkpoint import serialize
    from repro_torch.fed import scenarios
    from repro_torch.roofline.round_profile import population_simulation
    kw = {k: v for k, v in RESUME.items() if k not in ("m", "rounds")}
    m, rounds = RESUME["m"], RESUME["rounds"]
    _require(scenarios._corrupt_set(m, 0, RESUME["scenario_rate"]).any(),
             "resume: the corrupt set is empty (ROADMAP C2)")
    before = _all_launches()
    whole = population_simulation(m, pop, DEVICE, sampler="device", **kw)
    whole.run(rounds, chunk_rounds=DEVICE_CHUNK)
    with tempfile.TemporaryDirectory(dir=str(Path(__file__).resolve()
                                             .parent / "build")) as tmp:
        path = str(Path(tmp) / "resume.msgpack")
        serialize.save(path, whole.state)
        h1 = whole.run(rounds, chunk_rounds=DEVICE_CHUNK)
        resumed = population_simulation(m, pop, DEVICE, sampler="device",
                                        **kw)
        resumed.state = serialize.load(path, resumed.state)
    h2 = resumed.run(rounds, chunk_rounds=DEVICE_CHUNK)
    launches = _launch_delta(before)
    torch.cuda.synchronize()
    diff = [k for k in whole.state
            if not torch.equal(whole.state[k], resumed.state[k])]
    _require(not diff and h1.loss == h2.loss,
             f"resume: the resumed state differs at {diff} (loss "
             f"{h1.loss[-1]} against {h2.loss[-1]})")
    hit = scenarios._corrupt_set(m, 0, RESUME["scenario_rate"])
    drawn = [whole.population.cohort(t) for t in range(rounds)]
    _require(any(hit[ids].any() for ids in drawn),
             "resume: no corrupt client was drawn")
    for name in ("calibrated_update", "quantize_2d", "dequantize_2d"):
        _require(launches.get(name, 0) > 0,
                 f"resume: {name} never launched ({launches})")
    _emit({"phase": "device_path", "part": "resume", "m": m,
           "rounds": [rounds, rounds], **kw, "bit_equal": True,
           "state_keys": sorted(whole.state), "launches": launches,
           "quarantined": float(np.sum(h2.quarantined)),
           "loss": [h1.loss[-1], h2.loss[-1]]})


def _checkpoint_timing(sim) -> None:
    """Part (c), then: ``checkpoint.save`` and ``load`` of the M = 100,000
    state (the ν⁽ⁱ⁾ store dominates), where the disk has the room; the
    file goes to the build directory and is deleted."""
    import shutil
    from repro_torch.checkpoint import serialize
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    nbytes = sum(t.numel() * t.element_size() for t in sim.state.values())
    free = shutil.disk_usage(str(build)).free
    if free < nbytes + CKPT_DISK_SLACK:
        _emit({"phase": "device_path", "part": "checkpoint_io",
               "m": sim.fed.n_clients, "bytes": nbytes, "free_bytes": free,
               "save_s": "not measured", "load_s": "not measured"})
        return
    path = build / "phase15_state.msgpack"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serialize.save(str(path), sim.state)
        save_s = time.perf_counter() - t0
        file_bytes = path.stat().st_size
        t0 = time.perf_counter()
        restored = serialize.load(str(path), sim.state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        path.unlink(missing_ok=True)
    same = all(torch.equal(restored[k], sim.state[k]) for k in sim.state)
    _require(same, "checkpoint: the restored M = 100,000 state differs")
    _emit({"phase": "device_path", "part": "checkpoint_io",
           "m": sim.fed.n_clients, "bytes": nbytes, "file_bytes": file_bytes,
           "free_bytes": free, "save_s": save_s, "load_s": load_s,
           "save_gb_per_s": file_bytes / save_s / 1e9,
           "load_gb_per_s": file_bytes / load_s / 1e9})


def _failure_scenarios_on_card(reference: dict) -> None:
    """Part (d): the ``failure_scenarios`` example twin on the card (device
    batcher): every accuracy within PATH_SAMPLES samples of the
    reference's row, the abort fraction equal, one B1 launch a local
    step of every run."""
    from repro_torch.examples import failure_scenarios as ex
    before = _all_launches()
    t0 = time.perf_counter()
    with _RecordedRuns() as runs:
        rows = ex.run(DEVICE)
    seconds = time.perf_counter() - t0
    launches = _launch_delta(before)
    ref = reference["rows"]
    tol = PATH_SAMPLES / (ex.M * 50) + TWIN_PRINT_SLACK
    for row, want in zip(rows, ref):
        _require(row[0] == want[0] and row[-1] == want[-1]
                 and all(_close(a, b, tol)
                         for a, b in zip(row[1:-1], want[1:-1])),
                 f"failure_scenarios: the card's row {row} is not the "
                 f"reference's {want}")
        _emit({"phase": "device_path", "part": "failure_scenarios",
               "row": row, "reference": want})
    _require(len(rows) == len(ref), "failure_scenarios: rows missing")
    want = sum(rec["rounds"] * rec["sim"].k_max for rec in runs)
    _require(launches == {"calibrated_update": want},
             f"failure_scenarios: launches {launches}, expected {want}")
    _require(all(rec["sim"]._device_sampler for rec in runs),
             "failure_scenarios: a run did not use the device batcher")
    _emit({"phase": "device_path", "part": "failure_scenarios", "s": seconds,
           "runs": len(runs), "launches": launches})


def phase_device_path(pop: Optional[dict] = None,
                      host_ms: Optional[dict] = None) -> dict:
    """Phase 15.  ``host_ms``: phase 11's host-mode ms per round by M, in
    the same call.  Returns the launches of its runs."""
    pop = pop or population_settings()
    reference = json.loads(REFERENCE_QUICK.read_text())
    _reset_all_launches()
    _device_draw(pop)
    big = _device_population_scale(pop, host_ms or {})
    _checkpoint_timing(big)
    del big
    torch.cuda.empty_cache()
    _resume_on_card(pop)
    _failure_scenarios_on_card(reference["examples"]["failure_scenarios"])
    launches = _all_launches()
    _emit({"phase": "device_path", "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 16: personalized serving fed by bf16 training over a float32 master
# ---------------------------------------------------------------------------

# (a): phase 8's model and run (FED_LM) in bfloat16 over a float32 master,
# then PERSONAL_LEG2_ROUNDS more fedagrac rounds: the second leg, whose
# snapshot is swapped in.  The --small check's CPU reruns: reversed rows,
# then the master's initial weights moved by a bfloat16 ulp or two
# (``_bf16_moved``), drawn until the card is covered, at most
# BF16_MAX_PROBES.
PERSONAL_LEG2_ROUNDS = 1
BF16_MAX_PROBES = 8
# (b): the engine; the trace as (prompt length, new tokens, client), client
# 999 a cold start (no ν⁽ⁱ⁾ row); the long request, in flight at the swap
# after PERSONAL_SWAP_TICK ticks; the requests admitted after it
PERSONAL = {"slots": 4, "max_len": 256, "prefill_buckets": (32, 64, 128)}
PERSONAL_PRE = [(20, 10, 0), (45, 8, 1), (90, 12, 999)]
PERSONAL_LONG = (30, 24, 0)
PERSONAL_POST = [(12, 8, 1), (60, 6, 0), (25, 6, 999)]
PERSONAL_SWAP_TICK = 4
# the deltas' RMS as a share of the base's RMS: the scale is set so, and
# printed.  A bfloat16 view keeps 2⁻⁸ of an entry, so a smaller share of
# ν⁽ⁱ⁾ − ν (a gradient, ~10⁻³ of the weights here) would vanish in the cast
PERSONAL_DELTA_RMS = 0.05
# the factors at the serving rank (= M, so exact in exact arithmetic)
# against the ν rows, within 2⁻¹⁴ of the largest row entry: their dot
# products sum in float64, so what is left is float32 rounding of the
# rows, the basis and the coefficients (summed in cuBLAS's float32 order
# they were 7·10⁻⁴ off at P = 744.5 M)
PERSONAL_RANK = 2
LOWRANK_TOL = 2.0 ** -14
# one row-path tick against per-slot batch-1 decodes on the summed rows:
# bfloat16 ulps (2⁻⁸) of the largest logit (the batched GEMMs round
# otherwise)
ROW_TICK_ULPS = 8


def _bf16_training(cfg) -> tuple:
    """Part (a).  Returns the counted fedagrac run's launches, the flat
    spec and the two legs' snapshots (on the card)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.examples import fed_lm_train as ex
    run = {k: FED_LM[k] for k in ("clients", "seq", "batch", "rounds",
                                  "lr")}
    _emit({"phase": "personalized_cuts", "model": cfg.name,
           "dtype": f"{cfg.dtype} over a float32 master",
           "n_layers": f"{cfg.n_layers} of {get_arch(cfg.name).n_layers}",
           "clients": f"{run['clients']} of {ex.MCLIENTS}",
           "widths": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                      "vocab": cfg.vocab}})
    small = ex.build_config(True, bf16=True)
    # warm-up (bfloat16 cuBLAS handles) outside the counted runs
    _run_fed_lm(small, "fedavg", DEVICE, clients=2, seq=32, batch=2,
                rounds=1, bf16=True)
    for algo in ("fedavg", "fedagrac"):          # fedagrac's sim is kept
        g = _run_fed_lm(cfg, algo, DEVICE, bf16=True,
                        keep=algo == "fedagrac", **run)
        launches = g["launches"]
        L, k_max, R = cfg.n_layers, g["k_max"], run["rounds"]
        want = {"flash_attention_fwd": L * k_max * R + L,
                "flash_attention_bwd_dq": L * k_max * R,
                "flash_attention_bwd_dkv": L * k_max * R,
                "calibrated_update": k_max * R}
        got = {k: launches[k] for k in want}
        _require(got == want and all(
            n == 0 for k, n in launches.items() if k not in want),
                 f"bf16 {algo}: launches {launches}, expected {want} and "
                 f"no other")
        _require(g["master_dtype"] == torch.float32
                 and g["view_dtypes"] == [str(torch.bfloat16)],
                 f"bf16 {algo}: master {g['master_dtype']}, views "
                 f"{g['view_dtypes']}")
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"bf16 {algo}: non-finite loss {g['loss']} or perplexity "
                 f"{g['metric']}")
        tokens = run["clients"] * k_max * run["batch"] * run["seq"]
        wall = float(np.mean(g["round_wall_s"]))
        _emit({"phase": "personalized", "part": "bf16_training",
               "model": cfg.name, "algorithm": algo, "dtype": cfg.dtype,
               "master_dtype": str(g["master_dtype"]),
               "view_dtypes": g["view_dtypes"], **run, "params": g["n"],
               "k": g["k"], "k_max": k_max, "loss": g["loss"].tolist(),
               "perplexity": g["metric"].tolist(),
               "wall_per_round_s": g["round_wall_s"],
               "wall_per_local_step_s": wall / k_max,
               "train_tokens_per_s": tokens / wall, "launches": got,
               "peak_memory_bytes": g["peak_memory_bytes"]})
    sim = g.pop("sim")
    snaps = [sim.publish_snapshot()]
    sim.run(PERSONAL_LEG2_ROUNDS, eval_every=PERSONAL_LEG2_ROUNDS)
    snaps.append(sim.publish_snapshot())
    spec = sim.flat_spec
    _require(snaps[1]["flat_master"].dtype == torch.float32
             and int(snaps[1]["version"]) == R + PERSONAL_LEG2_ROUNDS,
             f"leg 2: snapshot v{int(snaps[1]['version'])}")
    del sim, g
    gc.collect()            # the simulation's closures may hold a cycle
    torch.cuda.empty_cache()

    srun = {"clients": ex.MCLIENTS, "seq": 32, "batch": 2, "rounds": 3}
    for algo in FED_LM["algorithms"]:
        def one(dev, **kw):
            return _run_fed_lm(small, algo, dev, bf16=True,
                               generator=torch.Generator().manual_seed(0),
                               **srun, **kw)
        g, c = one(DEVICE), one("cpu")
        probes = [one("cpu", flip_rows=True)]
        while (not _vs_covered(_lm_vs_cpu_margins(g, c, probes))
               and len(probes) < BF16_MAX_PROBES):
            probes.append(one("cpu", moved=len(probes)))
        _require(g["launches"]["flash_attention_bwd_dq"] > 0,
                 f"bf16 {algo} --small: the card run launched no backward "
                 f"kernel")
        vs = _lm_vs_cpu_margins(g, c, probes)
        for what, (diff, tol) in vs.items():
            _require(bool(np.all(diff <= tol)),
                     f"bf16 {algo} --small: {what} differs from the CPU run"
                     f" by {diff}, more than {tol}")
        _emit({"phase": "personalized", "part": "bf16_vs_cpu",
               "model": "gemma-2b --small --bf16", "algorithm": algo,
               **srun, "k": g["k"], "loss": g["loss"].tolist(),
               "perplexity": g["metric"].tolist(), "probes": len(probes),
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return launches, spec, snaps


def _personal_engine_class():
    """``PersonalizedServeEngine`` recording each request's prompt and the
    logits each of its tokens came from (by uid, and by completion in
    ``done_records``, beside ``done``: a trace replayed twice repeats
    uids), checking them finite, and timing each decode tick by the path
    it took (a synchronise on each side)."""
    from repro_torch.serving import PersonalizedServeEngine

    class Recording(PersonalizedServeEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.logits: dict[int, list] = {}
            self.prompts: dict[int, np.ndarray] = {}
            self.path_s = {"shared": [], "grouped": [], "rows": []}
            self.done_records: list[tuple] = []
            self.admissions = 0
            self._path = "shared"

        def _tick(self):
            n0 = len(self.done)
            super()._tick()
            self.done_records += [(self.prompts[c.uid], self.logits[c.uid])
                                  for c in self.done[n0:]]

        def _prefill_slot(self, s, req, toks, caches):
            logits, single = super()._prefill_slot(s, req, toks, caches)
            _require(bool(torch.isfinite(logits).all()),
                     f"request {req.uid}: non-finite prefill logits")
            self.admissions += 1
            self.prompts[req.uid] = req.prompt
            self.logits[req.uid] = [
                logits[0, len(req.prompt) - 1].float().cpu()]
            return logits, single

        def _decode_rows(self, toks):
            self._path = "rows"
            return super()._decode_rows(toks)

        def _decode_grouped(self, toks, live, versions):
            self._path = "grouped"
            return super()._decode_grouped(toks, live, versions)

        def _decode_tick(self, toks, live):
            self._path = "shared"
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = super()._decode_tick(toks, live)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.path_s[self._path].append(time.perf_counter() - t0)
            _require(bool(torch.isfinite(logits).all()),
                     "non-finite decode logits")
            rows = logits.float().cpu()
            for s in live:
                self.logits[self.active[s].uid].append(rows[s])
            return logits

    return Recording


def _personal_requests(vocab: int) -> tuple:
    """(requests before the swap, the long one, requests after it)."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(16)

    def make(uid, n, m, cid):
        return Request(uid=uid, prompt=rng.integers(1, vocab, n).astype(
            np.int32), max_new_tokens=m, client_id=cid)

    pre = [make(i, *t) for i, t in enumerate(PERSONAL_PRE)]
    long = make(len(pre), *PERSONAL_LONG)
    post = [make(len(pre) + 1 + i, *t) for i, t in enumerate(PERSONAL_POST)]
    return pre, long, post


def _personal_serve(engine, snaps, vocab: int, swap: bool):
    """The trace through ``engine``: the requests before the swap and the
    long one, PERSONAL_SWAP_TICK ticks, the swap to the second leg's
    snapshot (``swap``), the requests after it, then drained.  Returns
    {uid: completion} and the swap's wall (s)."""
    pre, long, post = _personal_requests(vocab)
    for r in pre + [long]:
        engine.submit(dataclasses.replace(r))
    for _ in range(PERSONAL_SWAP_TICK):
        engine.step()
    _require(any(a is not None and a.uid == long.uid for a in engine.active),
             "the long request is not in flight at the swap")
    swap_s = None
    if swap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.swap(snaps[1])
        torch.cuda.synchronize()
        swap_s = time.perf_counter() - t0
    for r in post:
        engine.submit(dataclasses.replace(r))
    engine.run()
    done = {c.uid: c for c in engine.done}
    _require(sorted(done) == [r.uid for r in pre + [long] + post]
             and all(len(done[r.uid].tokens) == r.max_new_tokens
                     for r in pre + [long] + post),
             f"served {sorted(done)}: requests missing or cut")
    return done, swap_s


def _personal_scale(snap: dict, n: int) -> float:
    """The scale that makes the ν deltas' RMS PERSONAL_DELTA_RMS of the
    base's."""
    base = snap["flat_master"][:n]
    rows = snap["nu_i"][:, :n] - snap["nu"][None, :n]
    return float(PERSONAL_DELTA_RMS * base.norm() / n ** 0.5
                 / (rows.norm() / (rows.shape[0] * n) ** 0.5))


def _row_tick_vs_plain(cfg, spec, snap: dict, scale: float) -> dict:
    """One row-path tick (``personalized_decode`` on four summed rows: two
    clients' and two bases) against a batch-1 ``serve_decode`` on each
    row, within ROW_TICK_ULPS of the largest logit."""
    from repro_torch.core import flat
    from repro_torch.models import model as model_lib
    from repro_torch.serving import make_personalizer, personalized_decode
    resolve = make_personalizer("nu", snap, scale)
    base = snap["flat_master"]
    rows = torch.stack([base + resolve(0), base + resolve(1), base, base])
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(1, cfg.vocab, (4, 1), generator=gen).to(DEVICE)
    offs = torch.zeros(4, dtype=torch.int32, device=DEVICE)
    dtype = getattr(torch, cfg.dtype)
    worst, ulp = 0.0, 0.0
    with torch.inference_mode():
        got, _ = personalized_decode(
            spec, cfg, rows, toks,
            model_lib.init_caches(cfg, 4, PERSONAL["max_len"], dtype,
                                  DEVICE), offs)
        for i in range(4):
            want, _ = model_lib.serve_decode(
                flat.view_tree(spec, rows[i]), {"tokens": toks[i][None]},
                model_lib.init_caches(cfg, 1, PERSONAL["max_len"], dtype,
                                      DEVICE), 0, cfg)
            want = want[0, 0].float()
            worst = max(worst, float((got[i].float() - want).abs().max()))
            ulp = max(ulp, 2.0 ** -8 * float(want.abs().max()))
    _require(worst <= ROW_TICK_ULPS * ulp,
             f"row-path tick: {worst} from per-slot decodes, more than "
             f"{ROW_TICK_ULPS} bfloat16 ulps of the largest logit ({ulp})")
    del rows
    return {"max_abs_err": worst, "ulps": worst / ulp,
            "tol_ulps": ROW_TICK_ULPS}


def _lowrank_snapshot(snap: dict, errs: list) -> dict:
    """``snap``'s base with its ν rows factored at PERSONAL_RANK, the
    factors held to the rows within LOWRANK_TOL (their relative error
    appended to ``errs``)."""
    from repro_torch.serving import lowrank_factors, make_snapshot
    coeff, basis = lowrank_factors(snap["nu_i"], snap["nu"], PERSONAL_RANK)
    err = top = 0.0
    for j in range(snap["nu_i"].shape[0]):
        row = snap["nu_i"][j] - snap["nu"]
        top = max(top, float(row.abs().max()))
        row -= coeff[j] @ basis
        err = max(err, float(row.abs_().max()))
        del row
    _require(err <= LOWRANK_TOL * top,
             f"lowrank_factors at rank {PERSONAL_RANK}: {err} from the ν "
             f"rows (largest {top})")
    errs.append(err / top)
    return make_snapshot(int(snap["version"]), snap["flat_master"],
                         coeff=coeff, basis=basis)


def _personalized_serving(cfg, spec, snaps: list) -> dict:
    """Part (b) on ``snaps``, the two legs' snapshots (replaced in place by
    their low-rank forms for the "lowrank" kind).  Returns the B6 launches
    of its prefills."""
    from repro_torch.core import flat
    from repro_torch.kernels.flash_attention import ops as fa_ops
    p, n = spec.p, spec.n
    v1, v2 = (int(s["version"]) for s in snaps)
    scale = _personal_scale(snaps[0], n)
    # reckoned before the run (bytes): the two snapshots (base, ν, ν⁽ⁱ⁾:
    # 16·P each) and the largest of: an engine (its (slots, P) rows, 16·P,
    # two versions' bf16 trees, 4·P, and an admission's delta with its
    # ν⁽ⁱ⁾ − ν or a tick's bf16 casts of the rows, 8·P); the row tick's
    # check (four summed rows, 16·P, their casts, 8·P, a slot's view,
    # 2·P); the factoring (the ν rows, the basis and the first leg's
    # basis, 24·P)
    reckoned = (32 + 28) * p
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the peak so far after each stage, to say which one sets it
    stage_peaks = {"start": torch.cuda.memory_allocated()}
    recording = _personal_engine_class()
    before = fa_ops.launches["flash_attention_fwd"]
    admissions = 0
    factor_err = []
    # the plain engine on the first leg's weights, for the "none" pin
    plain = _timed_engine_class()(
        cfg, flat.unravel(spec, snaps[0]["flat_master"]), device=DEVICE,
        record=True, **PERSONAL)
    plain_done, _ = _personal_serve(plain, snaps, cfg.vocab, swap=False)
    admissions += plain.admissions
    plain_logits = plain.logits
    del plain
    stage_peaks["plain"] = torch.cuda.max_memory_allocated()
    for kind in ("none", "nu", "lowrank"):
        if kind == "lowrank":
            # each leg's ν rows factored at the serving rank (exact: M =
            # 2); the list replaced in place, so the caller's lets the ν
            # rows go too
            snaps[:] = [_lowrank_snapshot(s, factor_err) for s in snaps]
            torch.cuda.empty_cache()
            stage_peaks["factors"] = torch.cuda.max_memory_allocated()
        runs = {}
        for swap in (False, True):
            eng = recording(cfg, spec, snaps[0], personalizer=kind,
                            scale=scale, device=DEVICE, **PERSONAL)
            done, swap_s = _personal_serve(eng, snaps, cfg.vocab, swap)
            admissions += eng.admissions
            runs[swap] = {"done": done, "logits": eng.logits,
                          "path_s": eng.path_s, "swap_s": swap_s}
            del eng
            torch.cuda.empty_cache()
        pre, long, post = _personal_requests(cfg.vocab)
        first = [r.uid for r in pre + [long]]
        for swap, r in runs.items():
            for uid, c in r["done"].items():
                want = v2 if swap and uid not in first else v1
                _require(c.version == want,
                         f"{kind}: request {uid} served under v{c.version},"
                         f" expected v{want}")
        _require(all(runs[True]["done"][u].tokens
                     == runs[False]["done"][u].tokens for u in first),
                 f"{kind}: the swap changed an in-flight request's tokens")
        if kind == "none":
            same = all(
                runs[False]["done"][u].tokens == plain_done[u].tokens
                and all(torch.equal(a, b) for a, b in zip(
                    runs[False]["logits"][u], plain_logits[u]))
                for u in plain_done)
            _require(same, "none: tokens or logits differ from the plain "
                           "ServeEngine's")
            base_logits = runs[False]["logits"]
        else:
            personal = [r.uid for r in pre + [long] if r.client_id < 2]
            moved = [float((runs[False]["logits"][u][0]
                            - base_logits[u][0]).abs().max())
                     for u in personal]
            _require(max(moved) > 0,
                     f"{kind}: no personalized slot's logits differ from "
                     f"the base's (scale {scale})")
        ticks = {path: [len(r["path_s"][path]) for r in runs.values()]
                 for path in ("shared", "grouped", "rows")}
        _emit({"phase": "personalized", "part": "serving", "kind": kind,
               "model": cfg.name, "dtype": cfg.dtype, "scale": scale,
               "delta_rms_share": PERSONAL_DELTA_RMS, "versions": [v1, v2],
               **PERSONAL, "ticks_by_path": ticks,
               "tick_ms_by_path": {
                   path: 1e3 * float(np.median(np.concatenate(
                       [r["path_s"][path] for r in runs.values()])))
                   for path in ticks if sum(ticks[path])},
               "swap_ms": 1e3 * runs[True]["swap_s"],
               "in_flight_tokens_kept": True,
               **({} if kind == "none" else
                  {"personal_logit_shift": moved}),
               **({"factors_rel_err": factor_err} if kind == "lowrank"
                  else {})})
        stage_peaks[kind] = torch.cuda.max_memory_allocated()
        if kind == "nu":
            row_tick = _row_tick_vs_plain(cfg, spec, snaps[0], scale)
            _emit({"phase": "personalized", "part": "row_tick",
                   **row_tick})
            stage_peaks["row_tick"] = torch.cuda.max_memory_allocated()
    launches = fa_ops.launches["flash_attention_fwd"] - before
    _require(launches == cfg.n_layers * admissions,
             f"serving: {launches} attention launches, expected "
             f"{cfg.n_layers} × {admissions} admissions")
    peak = torch.cuda.max_memory_allocated()
    _emit({"phase": "personalized", "part": "serving_memory",
           "reckoned_bytes": reckoned, "peak_memory_bytes": peak,
           "p": p, "peak_after": stage_peaks})
    _require(peak <= 1.5 * reckoned + POP_MEMORY_SLACK,
             f"serving: peak memory {peak} over 1.5 × the reckoned "
             f"{reckoned} + {POP_MEMORY_SLACK}")
    return {"flash_attention_fwd": launches}


def _personalized_example_on_card() -> None:
    """Part (c): the ``personalized_serving`` twin at ``--small`` on the
    card and on the CPU: every completion's version the CPU's, and the
    card's served logits against the CPU's own snapshot rows
    teacher-forced with the card's tokens, phase 6's rule (LOGIT_TOL;
    tokens the CPU's argmax wherever its top-2 margin exceeds twice
    that)."""
    from repro_torch.core import flat
    from repro_torch.examples import personalized_serving as ex
    from repro_torch.models import model as model_lib
    from repro_torch.serving import make_personalizer
    t0 = time.perf_counter()
    card = ex.run(small=True, device=DEVICE,
                  engine_cls=_personal_engine_class())
    card_s = time.perf_counter() - t0
    cpu = ex.run(small=True, device="cpu")
    eng, spec, cfg = card["engine"], cpu["spec"], cpu["cfg"]
    done, cpu_done = eng.done, cpu["engine"].done
    _require([(c.uid, c.client_id, c.version) for c in done]
             == [(c.uid, c.client_id, c.version) for c in cpu_done],
             "personalized_serving: the card's completions and versions are"
             " not the CPU's")
    worst, clear_tokens, near_ties = 0.0, 0, 0
    with torch.inference_mode():
        for c, (prompt, logits) in zip(done, eng.done_records):
            snap = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                    for k, v in cpu["snapshots"][c.version].items()}
            delta = make_personalizer("nu", snap)(c.client_id)
            row = snap["flat_master"] + (0 if delta is None else delta)
            seq = np.concatenate([prompt, np.asarray(c.tokens[:-1],
                                                     np.int32)])
            ref = model_lib.forward(
                flat.view_tree(spec, row),
                {"tokens": torch.from_numpy(seq)[None].long()},
                cfg)[0][0, len(prompt) - 1:]
            got = torch.stack(logits)
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            _require(err <= LOGIT_TOL,
                     f"personalized_serving request {c.uid}: card logits "
                     f"differ from the CPU's by {err} > {LOGIT_TOL}")
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
            toks = torch.tensor(c.tokens)
            _require(torch.equal(toks[clear], ref.argmax(-1)[clear]),
                     f"personalized_serving request {c.uid}: a token "
                     f"differs from the CPU's argmax where its margin "
                     f"exceeds {2 * LOGIT_TOL}")
            clear_tokens += int(clear.sum())
            near_ties += int((~clear).sum())
    _emit({"phase": "personalized", "part": "example_vs_cpu",
           "example": "personalized_serving --small",
           "completions": len(done), "max_abs_logit_err": worst,
           "tol": LOGIT_TOL, "tokens_checked": clear_tokens,
           "near_ties": near_ties, "card_s": card_s})


def _serving_bench_on_card() -> None:
    """Part (d): the ``serving_bench`` twin's quick run on the card —
    requests/s at each population and the reference's flatness check."""
    from repro_torch.benchmarks import serving_bench
    t0 = time.perf_counter()
    _, rep = serving_bench.report(quick=True, device=DEVICE)
    for row in rep["population_sweep"] + rep["personalizer_kinds"]:
        _emit({"phase": "personalized", "part": "serving_bench", **row})
    _emit({"phase": "personalized", "part": "serving_bench",
           "hot_swap": rep["hot_swap"],
           "flat_in_population": rep["flat_in_population"],
           "s": time.perf_counter() - t0})
    _require(rep["flat_in_population"],
             "serving_bench: requests/s at M = 100,000 under "
             f"{serving_bench.FLAT_RATIO} × that at M = 32")


def phase_personalized(cfg=None) -> dict:
    """Phase 16.  Returns the launches of (a)'s counted bf16 run (its B6
    and B7 under ``*_bf16``) and of (b)'s prefills."""
    from repro_torch.configs.registry import get_arch
    cfg = cfg or dataclasses.replace(get_arch("gemma-2b"),
                                     n_layers=FED_LM["layers"],
                                     dtype="bfloat16")
    launches, spec, snaps = _bf16_training(cfg)
    serving = _personalized_serving(cfg, spec, snaps)
    del snaps
    torch.cuda.empty_cache()
    _personalized_example_on_card()
    _serving_bench_on_card()
    out = {"calibrated_update": launches["calibrated_update"]}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        out[name + "_bf16"] = launches[name]
    out["flash_attention_fwd_bf16"] += serving["flash_attention_fwd"]
    _emit({"phase": "personalized", "launches": out})
    return out


# ---------------------------------------------------------------------------
# phase 17: hybrid training (zamba2) through the flat round
# ---------------------------------------------------------------------------

def _hybrid_layers(cfg) -> tuple[int, int]:
    """(Mamba2 layers, shared-attention applications) of a forward."""
    from repro_torch.models import model as model_lib
    segments, n_groups = model_lib.group_spec(cfg)
    count = {kind: n for kind, n, _ in segments}
    return (count.get("mamba2", 0) * n_groups,
            count.get("attn", 0) * n_groups)


def _hybrid_run_checked(cfg, algo: str, run: dict, bf16: bool = False
                        ) -> dict:
    """One counted run of HYBRID_TRAIN's cut: exact launches — per local
    step one SSD forward and one launch of each backward kernel per
    Mamba2 layer, the attention forward, dq and dk/dv once per
    shared-block application, B1 once; the eval one SSD forward per layer
    and one attention forward per application — a finite loss, and a
    held-out perplexity below the initial weights' (HYBRID_TRAIN's
    comment says why not below the vocab); prints wall, tokens/s and peak
    memory."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    n_mamba, n_attn = _hybrid_layers(cfg)
    g = _run_fed_lm(cfg, algo, DEVICE, bf16=bf16, eval_first=True, **run)
    k_max, R = g["k_max"], run["rounds"]
    steps = k_max * R
    want = {"ssd_scan": n_mamba * steps + n_mamba,
            **{name: n_mamba * steps for name in ssd_ops.BWD_KERNELS},
            "flash_attention_fwd": n_attn * steps + n_attn,
            "flash_attention_bwd_dq": n_attn * steps,
            "flash_attention_bwd_dkv": n_attn * steps,
            "calibrated_update": steps}
    launches = g["launches"]
    got = {k: launches[k] for k in want}
    tokens = run["clients"] * k_max * run["batch"] * run["seq"]
    wall = float(np.mean(g["round_wall_s"]))
    _emit({"phase": "hybrid_training", "model": cfg.name,
           "algorithm": algo, "dtype": cfg.dtype,
           "master_dtype": str(g["master_dtype"]),
           "n_layers": cfg.n_layers, "mamba_layers": n_mamba,
           "attention_applications": n_attn, **run, "params": g["n"],
           "k": g["k"], "k_max": k_max, "loss": g["loss"].tolist(),
           "initial_perplexity": g["metric0"],
           "perplexity": g["metric"].tolist(), "vocab": cfg.vocab,
           "wall_per_round_s": g["round_wall_s"],
           "wall_per_local_step_s": wall / k_max,
           "tokens_per_round": tokens, "train_tokens_per_s": tokens / wall,
           "run_wall_s": g["wall_s"], "launches": got,
           "peak_memory_bytes": g["peak_memory_bytes"]})
    _require(got == want and all(n == 0 for k, n in launches.items()
                                 if k not in want),
             f"hybrid {algo} ({cfg.dtype}): launches {launches}, expected "
             f"{want} and no other")
    _require(np.isfinite(g["loss"]).all() and np.isfinite(g["metric"]).all(),
             f"hybrid {algo}: non-finite loss {g['loss']} or perplexity "
             f"{g['metric']}")
    _require(float(g["metric"][-1]) < g["metric0"],
             f"hybrid {algo}: held-out perplexity {g['metric'][-1]} is not "
             f"below the initial weights' ({g['metric0']})")
    if bf16:
        # the Mamba2 blocks keep A_log, D and dt_bias float32, as the
        # reference does
        _require(g["master_dtype"] == torch.float32
                 and g["view_dtypes"] == [str(torch.bfloat16),
                                          str(torch.float32)],
                 f"hybrid bf16: master {g['master_dtype']}, views "
                 f"{g['view_dtypes']}")
    return got


def phase_hybrid_training(cfg=None, small_cfg=None) -> dict:
    """zamba2-2.7b at full width, cut to HYBRID_TRAIN["layers"] layers, in
    float32 through the LM example's simulation (fedagrac and fedavg),
    then fedagrac in bfloat16 over a float32 master, each with exact
    launch counts (``_hybrid_run_checked``); then the reduced model on the
    card against the CPU.  Returns the launches of the float32 fedagrac
    run."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.examples import fed_lm_train as ex
    base = get_arch("zamba2-2.7b")
    cfg = cfg or dataclasses.replace(base, n_layers=HYBRID_TRAIN["layers"],
                                     dtype="float32")
    small = small_cfg or reduced(base, n_layers=HYBRID_TRAIN["small_layers"])
    run = {k: HYBRID_TRAIN[k] for k in ("clients", "seq", "batch", "rounds",
                                        "lr")}
    s = cfg.ssm
    _emit({"phase": "hybrid_training_cuts", "model": cfg.name,
           "n_layers": f"{cfg.n_layers} of {base.n_layers}",
           "clients": f"{run['clients']} of {ex.MCLIENTS}",
           "widths": {"d_model": cfg.d_model, "ssm_heads":
                      s.expand * cfg.d_model // s.head_dim,
                      "ssm_head_dim": s.head_dim, "n_groups": s.n_groups,
                      "d_state": s.d_state, "chunk": s.chunk,
                      "n_heads": cfg.n_heads,
                      "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                      "vocab": cfg.vocab}})
    # warm-up (cuBLAS and cuDNN handles, the allocator) outside the counts
    _run_fed_lm(small, "fedavg", DEVICE, clients=2, seq=HYBRID_TRAIN[
        "small_seq"], batch=2, rounds=1)
    counted = {}
    for algo in HYBRID_TRAIN["algorithms"]:
        got = _hybrid_run_checked(cfg, algo, run)
        if algo == "fedagrac":
            counted = got
        torch.cuda.empty_cache()
    _hybrid_run_checked(dataclasses.replace(cfg, dtype="bfloat16"),
                        "fedagrac", run, bf16=True)
    torch.cuda.empty_cache()
    srun = {"clients": ex.MCLIENTS, "seq": HYBRID_TRAIN["small_seq"],
            "batch": 2, "rounds": 3, "lr": HYBRID_TRAIN["small_lr"]}
    threads = torch.get_num_threads()
    for algo in HYBRID_TRAIN["algorithms"]:
        def one(dev, **kw):
            # the CPU runs on one thread: with several, the embedding's
            # gradient differs by an ulp between identical calls (C18)
            torch.set_num_threads(1 if dev == "cpu" else threads)
            try:
                return _run_fed_lm(small, algo, dev, generator=torch.Generator(
                    ).manual_seed(0), **srun, **kw)
            finally:
                torch.set_num_threads(threads)
        g, c = one(DEVICE), one("cpu")
        probes = [one("cpu", flip_rows=True)]
        while (not _vs_covered(_lm_vs_cpu_margins(g, c, probes))
               and len(probes) < HYBRID_TRAIN["max_probes"]):
            probes.append(one("cpu", ulp_moved=len(probes)))
        _require(g["launches"]["ssd_bwd_chunk"] > 0,
                 f"hybrid {algo} --small: the card run launched no SSD "
                 f"backward kernel")
        vs = _lm_vs_cpu_margins(g, c, probes)
        for what, (diff, tol) in vs.items():
            _require(bool(np.all(diff <= tol)),
                     f"hybrid {algo} small: {what} differs from the CPU run "
                     f"by {diff}, more than {tol}")
        _emit({"phase": "hybrid_training_vs_cpu",
               "model": f"reduced zamba2-2.7b, {small.n_layers} layers",
               "algorithm": algo, **srun, "k": g["k"],
               "loss": g["loss"].tolist(), "perplexity": g["metric"].tolist(),
               "probes": len(probes),
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return counted


# Phase 18: the tree layout (param_layout="tree", FedConfig's default), whose
# local steps are plain torch per leaf (no calibrated-update launch) and
# whose wire crosses the flat view table.  (b): phase 3's main path for the
# nine algorithms and FedAvgM / FedAdam (the server_opt twin's settings),
# TREE_ROUNDS rounds each; (c): phase 4's compressed workload, one run of
# each codec and the broadcast; (d): phase 13's small M, a cohort and a
# buffered run; (e): the builder-level ``track_nu="explicit"`` and
# ``quantize_transmit`` rounds on both layouts, on phase 4's lr task.  The
# CPU runs of (b), (c) and (e) go to a worker process while the card runs
# its own (TREE_CPU_THREADS intra-op threads there).
TREE_RUNS = (tuple((a, "sgd", 1.0) for a in (
    "fedavg", "fedprox", "fednova", "scaffold", "fedlin", "fedagrac",
    "fedagrac_avg", "fedagrac_first", "fedagrac_reverse"))
    + (("fedavg", "momentum", 1.0), ("fedavg", "adam", 0.05)))
TREE_ROUNDS = 2
TREE_COMPRESSED_RUNS = (
    ("lr", "fedagrac", "int8", "none"), ("lr", "fedavg", "int4", "none"),
    ("lr", "fedagrac", "topk", "none"), ("lr", "fedagrac", "topk+int8",
                                         "int8"),
    ("mlp", "fedavg", "topk+int8", "none"))
TREE_POP_ROUNDS = 8
TREE_BUILDER_RUNS = (("explicit", dict(track_nu="explicit")),
                     ("quantize_transmit", dict(quantize_transmit=True)))
TREE_CPU_THREADS = 4


def _tree_lm(flat_run: dict, cfg=None) -> dict:
    """Part (a): phase 8's gemma-2b cut (or ``cfg``, phase 8's) and
    inputs, fedagrac on the tree layout, held to phase 8's flat fedagrac
    run (not run again) by phase 8's rule: PATH_SPREAD × the spread of a
    tree rerun with every microbatch's sequences reversed, plus PATH_RTOL.
    Exact attention launches, no calibrated-update launch.  Returns the
    launches."""
    from repro_torch.configs.registry import get_arch
    cfg = cfg or dataclasses.replace(get_arch("gemma-2b"),
                                     n_layers=FED_LM["layers"],
                                     dtype="float32")
    run = {k: FED_LM[k] for k in ("clients", "seq", "batch", "rounds",
                                  "lr")}
    g = _run_fed_lm(cfg, "fedagrac", DEVICE, layout="tree", **run)
    launches = g["launches"]
    probe = _run_fed_lm(cfg, "fedagrac", DEVICE, layout="tree",
                        flip_rows=True, **run)
    L, k_max, R = cfg.n_layers, g["k_max"], run["rounds"]
    want = {"flash_attention_fwd": L * k_max * R + L,
            "flash_attention_bwd_dq": L * k_max * R,
            "flash_attention_bwd_dkv": L * k_max * R}
    _require(k_max == flat_run["k_max"] and g["n"] == flat_run["n"],
             "tree LM: not phase 8's run")
    _require({k: launches[k] for k in want} == want and all(
        n == 0 for k, n in launches.items() if k not in want),
        f"tree LM: launches {launches}, expected {want} and no other "
        f"(no calibrated_update: the tree step is plain torch)")
    _require(np.isfinite(g["loss"]).all() and np.isfinite(g["metric"]).all(),
             f"tree LM: non-finite loss {g['loss']} or perplexity "
             f"{g['metric']}")
    # |tree − flat| within PATH_SPREAD × |tree reversed − tree| + floor
    vs = _lm_vs_cpu_margins(flat_run, g, [probe])
    for what, (diff, tol) in vs.items():
        _require(bool(np.all(diff <= tol)),
                 f"tree LM: {what} differs from phase 8's flat run by "
                 f"{diff}, more than {tol}")
    tokens = run["clients"] * k_max * run["batch"] * run["seq"]
    _emit({"phase": "tree_layout", "part": "lm", "model": cfg.name,
           "algorithm": "fedagrac", "dtype": cfg.dtype, **run,
           "params": g["n"], "k": g["k"], "k_max": k_max,
           "loss": g["loss"].tolist(), "perplexity": g["metric"].tolist(),
           "flat_loss": flat_run["loss"].tolist(),
           "flat_perplexity": flat_run["metric"].tolist(),
           "wall_per_round_s": g["round_wall_s"],
           "flat_wall_per_round_s": flat_run["round_wall_s"],
           "train_tokens_per_s": tokens / float(np.mean(g["round_wall_s"])),
           "peak_memory_bytes": g["peak_memory_bytes"],
           "base_memory_bytes": g["base_memory_bytes"],
           "flat_peak_memory_bytes": flat_run["peak_memory_bytes"],
           "flat_base_memory_bytes": flat_run.get("base_memory_bytes"),
           "launches": {k: launches[k] for k in want},
           "vs_flat": {k: float(np.max(d)) for k, (d, _) in vs.items()},
           "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return {k: launches[k] for k in want}


def _tree_run(sim, params0: dict, rounds: int, **kwargs) -> dict:
    """``sim.run(rounds, **kwargs)`` recorded as ``_cpu_rerun`` reads it,
    its launches and its final params raveled."""
    from repro_torch.core import flat
    before = _all_launches()
    hist = sim.run(rounds, **kwargs)
    return {"sim": sim, "params0": params0, "rounds": rounds, "args": (),
            "kwargs": kwargs, "hist": hist, "launches": _launch_delta(before),
            "params": flat.ravel(flat.make_flat_spec(sim.params),
                                 sim.params).cpu()}


def _tree_main_sim(device: str, run: tuple) -> dict:
    """One TREE_RUNS entry on ``device``: phase 3's task (the mlp,
    nine clients at K = 2 and one at 200, lr 0.03, λ 1) on the tree
    layout, TREE_ROUNDS rounds, recorded."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.data import fedprox_synthetic
    from repro_torch.fed import FederatedSimulation
    from repro_torch.models.simple import mlp_accuracy, mlp_init, mlp_loss
    algo, server, slr = run
    data, parts = fedprox_synthetic(0, 10, alpha=1.0, beta=1.0)
    params0 = mlp_init(torch.Generator().manual_seed(0), 60, 64, 10)
    x_eval, y_eval = data.x.to(device), data.y.to(device)
    fed = FedConfig(algorithm=algo, n_clients=10, lr=0.03,
                    calibration_rate=1.0, weights="data",
                    server_opt=server, server_lr=slr)
    sim = FederatedSimulation(
        mlp_loss, params0, fed, _batcher(data, parts, device, False),
        k_schedule=_bimodal(), device=device,
        eval_fn=lambda p: float(mlp_accuracy(p, {"x": x_eval, "y": y_eval})))
    _require(sim.layout == "tree", f"{algo}: not the tree layout")
    return _tree_run(sim, params0, TREE_ROUNDS, eval_every=TREE_ROUNDS)


def _tree_compressed_sim(device: str, run: tuple) -> dict:
    """One TREE_COMPRESSED_RUNS entry on ``device``: phase 4's task and
    codecs on the tree layout, TREE_ROUNDS rounds, recorded."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.fed import FederatedSimulation
    task, algo, up, down = run
    spec = _compressed_tasks()[task]
    data = spec["data"]
    x_eval, y_eval = data.x.to(device), data.y.to(device)
    fed = FedConfig(algorithm=algo, n_clients=10, lr=spec["lr"],
                    calibration_rate=1.0, weights="data", compressor=up,
                    broadcast_compressor=down, error_feedback=True,
                    topk_frac=0.05)
    sim = FederatedSimulation(
        spec["loss"], spec["params"], fed,
        _batcher(data, spec["parts"], device, False),
        k_schedule=_bimodal(), device=device,
        eval_fn=lambda p, acc=spec["accuracy"]: float(
            acc(p, {"x": x_eval, "y": y_eval})))
    _require(sim.layout == "tree", f"{run}: not the tree layout")
    return _tree_run(sim, spec["params"], TREE_ROUNDS,
                     eval_every=TREE_ROUNDS)


def _builder_run(device: str, layout: str, kw: dict,
                 reverse_rows: bool = False) -> dict:
    """TREE_ROUNDS rounds of the builder-level round (``rounds.make_round``
    or ``flat.make_flat_round`` with ``kw``) of fedagrac_first with a prox
    term on phase 4's lr task (the bimodal K): loss, final accuracy,
    params raveled, launches."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import flat, rounds
    from repro_torch.core.fedopt import get_algorithm
    task = _compressed_tasks()["lr"]
    data = task["data"]
    batcher = _batcher(data, task["parts"], device, reverse_rows)
    algo = dataclasses.replace(get_algorithm("fedagrac_first", FedConfig(
        algorithm="fedagrac_first", n_clients=10, lr=task["lr"],
        calibration_rate=1.0)), prox_mu=0.01)
    params = {k: v.to(device) for k, v in task["params"].items()}
    spec = flat.make_flat_spec(params)
    ks = torch.from_numpy(_bimodal()[0]).to(device)
    k_max = int(ks.max())
    if layout == "tree":
        fn = rounds.make_round(task["loss"], algo, lr=task["lr"],
                               k_max=k_max, **kw)
        state = rounds.init_state(params, 10, algo)
    else:
        fn = flat.make_flat_round(spec, task["loss"], algo, lr=task["lr"],
                                  k_max=k_max, **kw)
        state = rounds.init_state(flat.ravel(spec, params), 10, algo)
    before = _all_launches()
    losses = []
    for t in range(TREE_ROUNDS):
        state, metrics = fn(state, batcher.round_batches(t, k_max), ks,
                            batcher.weights)
        losses.append(float(metrics["loss"]))
    master = (state["params"] if layout == "flat"
              else flat.ravel(spec, state["params"]))
    acc = float(task["accuracy"](flat.unravel(spec, master),
                                 {"x": data.x.to(device),
                                  "y": data.y.to(device)}))
    return {"loss": np.array(losses), "metric": np.array([acc]),
            "params": master.cpu(), "launches": _launch_delta(before),
            "k_max": k_max}


def _cpu_pair(rec: dict) -> dict:
    """A recorded run on the CPU (its own trajectory where it ran there)
    and the CPU rerun with every microbatch's rows reversed."""
    batch = rec["sim"].batcher.batch_size
    on_cpu = rec["sim"].device.type == "cpu"
    return {"plain": _trajectory(rec) if on_cpu else _cpu_rerun(rec),
            "reversed": _cpu_rerun(rec, torch.arange(batch - 1, -1, -1))}


def _tree_cpu_side() -> dict:
    """Phase 18's CPU runs, a worker process's job beside the card's: each
    run of (b) and (c) and its reversed-rows rerun, each builder run of
    (e) and its reversed-rows run."""
    torch.set_num_threads(TREE_CPU_THREADS)
    out = {("main",) + run: _cpu_pair(_tree_main_sim("cpu", run))
           for run in TREE_RUNS}
    out.update({("compressed",) + run: _cpu_pair(_tree_compressed_sim(
        "cpu", run)) for run in TREE_COMPRESSED_RUNS})
    for what, kw in TREE_BUILDER_RUNS:
        for layout in ("tree", "flat"):
            out[("builder", what, layout)] = {
                "plain": _builder_run("cpu", layout, kw),
                "reversed": _builder_run("cpu", layout, kw,
                                         reverse_rows=True)}
    return out


def _tree_vs_cpu(name: str, g: dict, cpu: dict, n_eval: int,
                 rec: Optional[dict] = None) -> tuple[dict, int]:
    """A card run's trajectory ``g`` against the CPU's by phase 3's rule:
    PATH_SPREAD × the spread of the reversed-rows rerun and, given the
    card's recorded mlp run ``rec``, relabelled reruns drawn until the
    card is covered (C14), at most TWIN_MAX_PROBES."""
    _require(np.isfinite(g["loss"]).all() and np.isfinite(g["metric"]).all(),
             f"{name}: non-finite loss or metric")
    probes = [cpu["reversed"]]
    while (rec is not None
           and not _vs_covered(_vs_cpu_margins(g, cpu["plain"], probes,
                                               n_eval))
           and len(probes) < TWIN_MAX_PROBES):
        probes.append(_cpu_rerun(rec, relabel_seed=len(probes)))
    return _vs_cpu(name, g, cpu["plain"], probes, n_eval), len(probes)


def _vs_fields(vs: dict) -> dict:
    return {"vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
            "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}}


def _tree_main_path(card: dict, cpu: dict) -> None:
    """Part (b): each TREE_RUNS entry on the card against the CPU; no
    kernel launch (the tree step is plain torch)."""
    for run in TREE_RUNS:
        rec = card[run]
        name = f"tree {run[0]}/{run[1]}"
        _require(rec["launches"] == {},
                 f"{name}: launches {rec['launches']}, expected none")
        vs, probes = _tree_vs_cpu(name, _trajectory(rec),
                                  cpu[("main",) + run],
                                  len(rec["sim"].batcher.data), rec)
        hist = rec["hist"]
        _emit({"phase": "tree_layout", "part": "main_path",
               "algorithm": run[0], "server_opt": run[1],
               "server_lr": run[2], "rounds": TREE_ROUNDS,
               "loss": hist.loss, "metric": hist.metric,
               "wall_per_round_s": float(np.mean(hist.wall)),
               "probes": probes, **_vs_fields(vs)})


def _tree_compressed(card: dict, cpu: dict) -> dict:
    """Part (c): exact quantize launches (the wire crosses the view table,
    so B3-B5 run on the tree round) and wire bytes, each run against the
    CPU.  Returns the launches."""
    from repro_torch.core import compress
    total: dict = {}
    for run in TREE_COMPRESSED_RUNS:
        task, algo, up, down = run
        rec = card[run]
        sim, hist = rec["sim"], rec["hist"]
        name = f"tree {task}/{algo} up={up} down={down}"
        quantities = 2 if sim.algo.uses_nu else 1
        want = {k: TREE_ROUNDS * quantities * n for k, n in (
            (k, CODEC_LAUNCHES[up].get(k, 0) + CODEC_LAUNCHES[down].get(k, 0))
            for k in ("quantize_2d", "dequantize_2d", "topk_mask_2d")) if n}
        _require(rec["launches"] == want,
                 f"{name}: launches {rec['launches']}, expected {want}")
        wire = compress.wire_cost(sim.flat_spec.n, sim.algo.uses_nu,
                                  sim.compression)
        _require(hist.bytes_up == [10 * wire["uplink_per_client"]]
                 * TREE_ROUNDS and hist.bytes_down
                 == [10 * wire["downlink_per_client"]] * TREE_ROUNDS,
                 f"{name}: bytes {hist.bytes_up[0]}/{hist.bytes_down[0]} "
                 f"per round, expected 10 × {wire}")
        vs, probes = _tree_vs_cpu(name, _trajectory(rec),
                                  cpu[("compressed",) + run],
                                  len(sim.batcher.data),
                                  rec if task == "mlp" else None)
        for k, n in want.items():
            total[k] = total.get(k, 0) + n
        _emit({"phase": "tree_layout", "part": "compressed", "task": task,
               "algorithm": algo, "uplink": up, "broadcast": down,
               "rounds": TREE_ROUNDS, "loss": hist.loss,
               "metric": hist.metric, "launches": rec["launches"],
               "bytes_up_per_round": hist.bytes_up[0],
               "bytes_down_per_round": hist.bytes_down[0],
               "wall_per_round_s": float(np.mean(hist.wall)),
               "probes": probes, **_vs_fields(vs)})
    return total


def _tree_builder_options(card: dict, cpu: dict) -> dict:
    """Part (e): ``track_nu="explicit"`` and ``quantize_transmit`` on each
    layout against the CPU by phase 3's rule; the flat round one
    calibrated-update launch a local step, the tree round none.  Returns
    the launches."""
    total: dict = {}
    for key, g in card.items():
        _, what, layout = key
        name = f"{what} on {layout}"
        want = ({} if layout == "tree" else
                {"calibrated_update": g["k_max"] * TREE_ROUNDS})
        _require(g["launches"] == want,
                 f"{name}: launches {g['launches']}, expected {want}")
        vs, _ = _tree_vs_cpu(name, g, cpu[key], 4000)
        for k, n in want.items():
            total[k] = total.get(k, 0) + n
        _emit({"phase": "tree_layout", "part": "builder_options",
               "option": what, "layout": layout,
               "algorithm": "fedagrac_first + prox 0.01",
               "loss": g["loss"].tolist(), "metric": g["metric"][0],
               "launches": g["launches"], **_vs_fields(vs)})
    return total


def _tree_population() -> None:
    """Part (d): phase 13's population setting at its small M on the tree
    layout, a cohort run in chunks and a buffered run, against the CPU by
    phase 3's rule."""
    from repro_torch.models.simple import mlp_accuracy
    from repro_torch.roofline.round_profile import (
        population_async_simulation, population_simulation)
    pop = population_settings()
    m = pop["m_small"]
    for engine, build, kw in (
            ("cohort", population_simulation, {"chunk_rounds": 4,
                                               "eval_every": 4}),
            ("buffered", population_async_simulation, {"chunk_updates": 4,
                                                       "eval_every": 4})):
        sim = build(m, pop, DEVICE, param_layout="tree")
        data = sim.batcher.data
        x_eval, y_eval = data.x.to(DEVICE), data.y.to(DEVICE)
        sim.eval_fn = lambda p: float(mlp_accuracy(p, {"x": x_eval,
                                                       "y": y_eval}))
        _require(sim.layout == "tree" and not
                 sim.population.full_participation,
                 f"tree {engine}: not the tree layout's population path")
        params0 = {k: v.cpu() for k, v in sim.params.items()}
        rec = _tree_run(sim, params0, TREE_POP_ROUNDS, **kw)
        name = f"tree {engine} M = {m}"
        _require(rec["launches"] == {},
                 f"{name}: launches {rec['launches']}, expected none")
        _require(tuple(sim.state["nu_i"]["w1"].shape[:1]) == (m,),
                 f"{name}: the ν⁽ⁱ⁾ store is not population-sized")
        vs, probes = _tree_vs_cpu(name, _trajectory(rec), _cpu_pair(rec),
                                  len(data), rec)
        hist = rec["hist"]
        _emit({"phase": "tree_layout", "part": "population",
               "engine": engine, "m": m, "cohort": pop["cohort"],
               "k": pop["k"], "rounds": TREE_POP_ROUNDS,
               "loss": hist.loss, "metric": hist.metric, "mass": hist.mass,
               "ms_per_round": 1e3 * float(np.mean(hist.wall)),
               "probes": probes, **_vs_fields(vs)})


def phase_tree_layout(flat_lm: dict, cfg=None) -> dict:
    """Phase 18, the tree layout: (a) phase 8's gemma-2b cut (``cfg``:
    phase 8's) against ``flat_lm`` (phase 8's fedagrac run), (b) phase 3's
    main path, (c) phase 4's compressed workload, (d) phase 13's small-M
    cohort and buffered runs, (e) the builder options on both layouts.
    The CPU runs of (b), (c) and (e) run in a worker process meanwhile.
    Returns the launches of its runs."""
    import multiprocessing
    launches: dict = {}

    def add(more: dict) -> None:
        for k, n in more.items():
            launches[k] = launches.get(k, 0) + n

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu_side = pool.apply_async(_tree_cpu_side)
        add(_tree_lm(flat_lm, cfg))
        torch.cuda.empty_cache()
        main = {run: _tree_main_sim(DEVICE, run) for run in TREE_RUNS}
        compressed = {run: _tree_compressed_sim(DEVICE, run)
                      for run in TREE_COMPRESSED_RUNS}
        builder = {("builder", what, layout): _builder_run(DEVICE, layout,
                                                           kw)
                   for what, kw in TREE_BUILDER_RUNS
                   for layout in ("tree", "flat")}
        _tree_population()
        cpu = cpu_side.get()
    _tree_main_path(main, cpu)
    add(_tree_compressed(compressed, cpu))
    add(_tree_builder_options(builder, cpu))
    return launches


# Phase 19: MoE, MLA and sliding-window serving, each model at full width
# and depth in bfloat16 behind ServeEngine, one at a time.  deepseek-v2-lite
# and granite-moe: 4 slots, buckets (64, 128, 256), three ragged prompts and
# one of exactly the largest bucket, 16 new tokens each.  gemma3-12b: 2
# slots, a prompt that fills a bucket of 1020 (under the window: exact, its
# decode steps cross the local rings' end) and one of 2048 (over the
# window: the rings' whole-ring gather; behind the engine the pad mask then
# empties every local ring slot, C20, so its logits are printed, not
# checked, and the model path without the engine is checked instead).
MODEL_SERVE = {"slots": 4, "max_len": 512, "prefill_buckets": (64, 128, 256)}
MODEL_PROMPTS = (37, 101, 190, 256)
MODEL_NEW_TOKENS = 16
GEMMA3_SERVE = {"slots": 2, "max_len": 2048 + 16,
                "prefill_buckets": (1020, 2048)}
GEMMA3_PROMPTS = (1020, 2048)
# the capacity factor at which no MoE assignment drops (capacity ≥ T needs
# cf ≥ E / k: 10.7 for deepseek, 4 for granite), so that a decode tick and
# a no-cache forward route alike
NO_DROP_CAPACITY = 64.0
# bfloat16 logits of two computations that differ only in rounding (the
# engine's decode against a no-cache forward, the absorbed MLA decode
# against the naive one), by each emitted position's ‖Δ‖₂ / ‖logits‖₂
# over the vocab: the median position within BF16_LOGIT_MEDIAN_RTOL, the
# worst within BF16_LOGIT_RTOL.  In bfloat16 an MoE's top-k flips where
# two experts' router probabilities lie within a rounding, and a flipped
# expert moves that token's layer output by a sixth or more, so the worst
# position of a 27-layer MoE wanders far beyond the rounding itself
BF16_LOGIT_RTOL = 0.5
BF16_LOGIT_MEDIAN_RTOL = 0.15
# one MLA layer's decode output, absorbed against naive, on the served
# cache: the same bfloat16 operands, the absorbed path rounding q̃, p and õ
# to bfloat16 (the reference's arithmetic) — a few bfloat16 units
MLA_LAYER_RTOL = 2.0 ** -5
# the card-against-CPU check (phase 6's rule, LOGIT_TOL): the float32 model
# cut to 2 layers at d 256 with the full model's experts and top-k (its
# capacity arithmetic), served on both with the card's tokens
MODEL_CHECK_PROMPTS = (20, 50, 100, 200)
MODEL_CHECK_NEW_TOKENS = 8


def _fixed_requests(lengths, new: int, vocab: int, seed: int) -> list:
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, max_new_tokens=new,
                    prompt=rng.integers(1, vocab, n).astype(np.int32))
            for i, n in enumerate(lengths)]


@contextlib.contextmanager
def _recorded_routes():
    """The expert ids of every ``moe.route`` call inside the block, kept on
    the device (no host sync), in call order."""
    from repro_torch.models import moe as moe_mod
    route, calls = moe_mod.route, []

    def recording(router_w, x, top_k):
        out = route(router_w, x, top_k)
        calls.append(out[1])
        return out

    moe_mod.route = recording
    try:
        yield calls
    finally:
        moe_mod.route = route


def _dropped(calls: list, cfg) -> list[tuple[int, int]]:
    """(tokens routed, assignments past the capacity) of each call."""
    from repro_torch.models import moe as moe_mod
    out = []
    for ids in calls:
        T, k = ids.shape
        counts = torch.bincount(ids.reshape(-1),
                                minlength=cfg.moe.n_experts)
        kept = counts.clamp(max=moe_mod.capacity(T, cfg)).sum()
        out.append((T, T * k - int(kept)))
    return out


def _logit_gaps(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    """Each position's ‖got − want‖₂ / ‖want‖₂ over the vocab."""
    got, want = got.float(), want.float().to(got.device)
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()


def _gap_check(what: str, gaps: list[float]) -> dict:
    """Fails unless the median and the worst position's gap are within
    BF16_LOGIT_MEDIAN_RTOL and BF16_LOGIT_RTOL."""
    out = {"median": float(np.median(gaps)), "max": float(np.max(gaps))}
    _require(out["median"] <= BF16_LOGIT_MEDIAN_RTOL
             and out["max"] <= BF16_LOGIT_RTOL,
             f"{what}: bfloat16 logit gaps {out} above "
             f"{BF16_LOGIT_MEDIAN_RTOL} / {BF16_LOGIT_RTOL}")
    return out


def _mla_layer_gaps(cfg, params, caches) -> list[float]:
    """The first and last layers' MLA decode of one random token a slot on
    the served cache, absorbed against naive: ‖Δy‖₂ / ‖y‖₂."""
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.layers import rope_angles
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    naive = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, absorb=False))
    gaps = []
    with torch.inference_mode():
        for layer in (0, cfg.n_layers - 1):
            p = tree_map(lambda t: t[layer, 0], params["segments"][0]["attn"])
            cache = tree_map(lambda t: t[layer, 0], caches[0])
            B = cache["idx"].shape[0]
            x = torch.randn(B, 1, cfg.d_model, generator=gen,
                            device=DEVICE).to(params["embed"].dtype)
            q_pos = cache["idx"].long()[:, None].to(torch.int32)
            angles = rope_angles(q_pos, cfg.resolved_head_dim,
                                 cfg.rope_theta)
            y = {c.mla.absorb: attn_mod.mla_attention(
                    p, x, c, angles=angles, q_pos=q_pos, cache=cache)[0]
                 for c in (cfg, naive)}
            gaps.append(float((y[True].float() - y[False].float()).norm()
                              / y[False].float().norm()))
    return gaps


def _no_cache_logits(cfg, params, req, tokens) -> torch.Tensor:
    """A no-cache forward over prompt + emitted tokens: the logits at each
    emitting position."""
    from repro_torch.models import model as model_lib
    seq = np.concatenate([req.prompt, np.asarray(tokens[:-1], np.int32)])
    with torch.inference_mode():
        logits = model_lib.forward(
            params, {"tokens": torch.from_numpy(seq)[None].long().to(
                DEVICE)}, cfg)[0]
    return logits[0, len(req.prompt) - 1:]


def _timed_model_run(cfg, params, settings, lengths, seed: int) -> tuple:
    """The engine's timing run on ``lengths``, after a short warm-up:
    (stats, the attention launches, the MoE's (T, dropped) per route
    call)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    _serve(cfg, params, _fixed_requests(lengths[:1], 2, cfg.vocab, 99),
           DEVICE, settings=settings)
    reqs = _fixed_requests(lengths, MODEL_NEW_TOKENS, cfg.vocab, seed)
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    with _recorded_routes() as calls:
        eng, wall = _serve(cfg, params, reqs, DEVICE, record=True,
                           settings=settings)
    launches = fa_ops.launches["flash_attention_fwd"]
    stats = _serve_stats(eng, reqs, wall)
    want = cfg.n_layers * eng.admissions
    _require(launches == want == eng.admit_launches
             and eng.tick_launches == 0
             and fa_ops.launches["flash_attention_bwd_dq"] == 0,
             f"{cfg.name}: {eng.admit_launches} attention launches in "
             f"prefills, {eng.tick_launches} in decode ticks; expected "
             f"{want} ({cfg.n_layers} layers × {eng.admissions} "
             f"admissions) and 0")
    stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    drops = _dropped(calls, cfg) if cfg.moe is not None else []
    return eng, reqs, stats, launches, drops


def _drop_summary(drops: list, cfg, slots: int) -> dict:
    """Assignments past the capacity per admission and per decode tick:
    each forward routes in its n_layers layers one after another, a
    tick's ``slots`` tokens (idle slots' dummies included), an
    admission's whole bucket."""
    from repro_torch.models.moe import capacity
    if not drops:
        return {}
    L = cfg.n_layers
    forwards = [(drops[i][0], sum(d for _, d in drops[i:i + L]))
                for i in range(0, len(drops), L)]
    return {"capacity_per_tick": capacity(slots, cfg),
            "assignments_per_tick": slots * cfg.moe.top_k * L,
            "dropped_per_tick": [d for T, d in forwards if T == slots],
            "dropped_per_admission": [d for T, d in forwards if T != slots]}


def _engine_vs_cpu(cfg) -> dict:
    """The float32 check model served on the card, then on the CPU with
    the card's tokens: logits within LOGIT_TOL, each token the CPU's
    argmax wherever its margin exceeds 2·LOGIT_TOL (phase 6's rule)."""
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import model as model_lib
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(1), cfg)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    reqs = _fixed_requests(MODEL_CHECK_PROMPTS, MODEL_CHECK_NEW_TOKENS,
                           cfg.vocab, 1)
    eng, wall = _serve(cfg, params, reqs, DEVICE, record=True,
                       settings=MODEL_SERVE)
    _serve_stats(eng, reqs, wall)
    card = {c.uid: c.tokens for c in eng.done}
    cpu, _ = _serve(cfg, cpu_params, reqs, "cpu", record=True,
                    settings=MODEL_SERVE, forced=card)
    worst, clear_tokens, near_ties = 0.0, 0, 0
    for r in reqs:
        got = torch.stack(eng.logits[r.uid])
        ref = torch.stack(cpu.logits[r.uid])
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        _require(err <= LOGIT_TOL,
                 f"{cfg.name} request {r.uid}: card logits differ from the "
                 f"CPU's by {err} > {LOGIT_TOL}")
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
        toks = torch.tensor(card[r.uid])
        _require(torch.equal(toks[clear], ref.argmax(-1)[clear]),
                 f"{cfg.name} request {r.uid}: a token differs from the "
                 f"CPU's argmax where its margin exceeds {2 * LOGIT_TOL}")
        clear_tokens += int(clear.sum())
        near_ties += int((~clear).sum())
    out = {"model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "requests": len(reqs), "max_abs_logit_err": worst,
           "tol": LOGIT_TOL, "tokens_checked": clear_tokens,
           "near_ties": near_ties}
    del eng, cpu, params, cpu_params
    return out


def _check_cfg(cfg):
    """The float32 check model: ``reduced`` to 2 layers at d 256 (vocab
    4096; MLA's reduced latent dims), the full model's routing kept."""
    from repro_torch.configs.base import reduced
    small = reduced(cfg, n_layers=2, d_model=256, vocab=4096)
    if cfg.moe is not None:
        small = dataclasses.replace(small, moe=dataclasses.replace(
            cfg.moe, d_ff=256))
    return small


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _serve_moe_model(name: str, mla_checks: bool) -> int:
    """(a) / (b): the timing run at the config's own capacity factor, the
    dropped assignments per tick; for MLA the absorbed decode against a
    no-cache forward and against the naive decode at NO_DROP_CAPACITY;
    the float32 check model against the CPU.  Returns the timing run's
    attention launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(get_arch(name), dtype="bfloat16")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    eng, reqs, stats, launches, drops = _timed_model_run(
        cfg, params, MODEL_SERVE, MODEL_PROMPTS, 0)
    _emit({"phase": "moe_mla_window", "model": name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "param_bytes": param_bytes,
           "init_s": init_s, **MODEL_SERVE,
           "prompt_lens": list(MODEL_PROMPTS),
           "max_new_tokens": MODEL_NEW_TOKENS, **stats,
           **_drop_summary(drops, cfg, MODEL_SERVE["slots"])})
    del eng
    if mla_checks:
        nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=NO_DROP_CAPACITY))
        absorbed, _ = _serve(nodrop, params, reqs, DEVICE, record=True,
                             settings=MODEL_SERVE)
        tokens = {c.uid: c.tokens for c in absorbed.done}
        naive, _ = _serve(dataclasses.replace(nodrop, mla=dataclasses.replace(
            cfg.mla, absorb=False)), params, reqs, DEVICE, record=True,
            settings=MODEL_SERVE, forced=tokens)
        gaps = {"absorbed_vs_no_cache": [], "absorbed_vs_naive": []}
        for r in reqs:
            got = torch.stack(absorbed.logits[r.uid])
            gaps["absorbed_vs_no_cache"] += _logit_gaps(
                got, _no_cache_logits(nodrop, params, r, tokens[r.uid]))
            gaps["absorbed_vs_naive"] += _logit_gaps(
                got, torch.stack(naive.logits[r.uid]))
        layer = _mla_layer_gaps(nodrop, params, absorbed.caches)
        _emit({"phase": "moe_mla_window_mla", "model": name,
               "capacity_factor": NO_DROP_CAPACITY,
               "gaps": {k: sorted(v) for k, v in gaps.items()},
               "tol": [BF16_LOGIT_MEDIAN_RTOL, BF16_LOGIT_RTOL],
               "layer_absorbed_vs_naive": layer,
               "layer_tol": MLA_LAYER_RTOL,
               "absorbed_wall_per_tick_s": float(np.mean(absorbed.tick_s)),
               "naive_wall_per_tick_s": float(np.mean(naive.tick_s))})
        _require(max(layer) <= MLA_LAYER_RTOL,
                 f"{name}: one layer's absorbed decode is {layer} from the "
                 f"naive one's")
        for what, g in gaps.items():
            _gap_check(f"{name} {what}", g)
        del absorbed, naive
    del params
    _free()
    _emit({"phase": "moe_mla_window_vs_cpu",
           **_engine_vs_cpu(_check_cfg(get_arch(name)))})
    _free()
    return launches


def _serve_gemma3() -> int:
    """(c): the engine on the two prompts; the one that fills its bucket
    under the window against a no-cache forward; the 2048-token prompt
    through ``serve_prefill`` / ``serve_decode`` (no pad mask) against a
    no-cache forward.  Returns the engine's attention launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(get_arch("gemma3-12b"), dtype="bfloat16")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    eng, reqs, stats, launches, _ = _timed_model_run(
        cfg, params, GEMMA3_SERVE, GEMMA3_PROMPTS, 0)
    gaps = {}
    for r in reqs:
        n = len(r.prompt)
        tokens = next(c.tokens for c in eng.done if c.uid == r.uid)
        g = _logit_gaps(torch.stack(eng.logits[r.uid]),
                        _no_cache_logits(cfg, params, r, tokens))
        # C20: behind the engine only the prompt that fills a bucket under
        # the window keeps every key of its local windows
        gaps[n] = (_gap_check(f"gemma3's {n}-token prompt behind the "
                              f"engine", g) if n <= cfg.sliding_window
                   else {"median": float(np.median(g)),
                         "max": float(np.max(g))})
    _emit({"phase": "moe_mla_window", "model": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "param_bytes": param_bytes,
           "init_s": init_s, **GEMMA3_SERVE,
           "prompt_lens": list(GEMMA3_PROMPTS),
           "max_new_tokens": MODEL_NEW_TOKENS, **stats,
           "engine_vs_no_cache": gaps,
           "tol": [BF16_LOGIT_MEDIAN_RTOL, BF16_LOGIT_RTOL]})
    del eng
    # the whole-ring gather without the engine's pad mask
    r = reqs[GEMMA3_PROMPTS.index(2048)]
    before = fa_ops.launches["flash_attention_fwd"]
    with torch.inference_mode():
        caches = model_lib.init_caches(cfg, 1, GEMMA3_SERVE["max_len"],
                                       device=DEVICE)
        logits, caches = model_lib.serve_prefill(
            params, {"tokens": torch.from_numpy(r.prompt)[None].long().to(
                DEVICE)}, cfg, caches=caches)
        rows, tokens = [logits[0, -1]], []
        for step in range(MODEL_NEW_TOKENS - 1):
            tokens.append(int(rows[-1].argmax()))
            logits, caches = model_lib.serve_decode(
                params, {"tokens": torch.tensor([[tokens[-1]]],
                                                device=DEVICE)},
                caches, len(r.prompt) + step, cfg)
            rows.append(logits[0, 0])
    tokens.append(int(rows[-1].argmax()))
    prefill_launches = fa_ops.launches["flash_attention_fwd"] - before
    model_gap = _logit_gaps(torch.stack(rows),
                            _no_cache_logits(cfg, params, r, tokens))
    _emit({"phase": "moe_mla_window_model_path", "model": cfg.name,
           "prompt_len": len(r.prompt), "decode_steps": MODEL_NEW_TOKENS - 1,
           "vs_no_cache": sorted(model_gap),
           "tol": [BF16_LOGIT_MEDIAN_RTOL, BF16_LOGIT_RTOL],
           "flash_launches": prefill_launches})
    _require(prefill_launches == cfg.n_layers,
             f"gemma3: {prefill_launches} attention launches in a prefill "
             f"and {MODEL_NEW_TOKENS - 1} decode steps, expected "
             f"{cfg.n_layers}")
    _gap_check("gemma3's 2048-token prompt through serve_prefill / "
               "serve_decode", model_gap)
    del params, caches, logits, rows
    _free()
    return launches


def phase_moe_mla_window() -> dict:
    """Phase 19.  Returns the timing runs' attention launches by the
    kernels line's names."""
    _free()
    return {"flash_attention_fwd_mla_bf16": _serve_moe_model(
                "deepseek-v2-lite-16b", mla_checks=True),
            "flash_attention_fwd_granite_bf16": _serve_moe_model(
                "granite-moe-1b-a400m", mla_checks=False),
            "flash_attention_fwd_gemma3_bf16": _serve_gemma3()}


# ---------------------------------------------------------------------------
# phase 20: xLSTM and the audio and vision front ends through serve_prefill /
# serve_decode (the engine refuses them, as the reference's does)
# ---------------------------------------------------------------------------

# (rows, prompt length, decode steps) of the timing run; the float32 cuts'
# card-against-CPU run; a vision prompt's image grid there (16 × 16 in the
# timing run, 8 × 8 in the cut's 128 positions)
DIRECT = {"rows": 4, "prompt": 512, "steps": 16}
DIRECT_CHECK = {"rows": 2, "prompt": 128, "steps": 8, "grid": 8}
# layers of the float32 cuts: one xLSTM group (3 mLSTM + 1 sLSTM), 2 of
# the attention models'
DIRECT_CHECK_LAYERS = {"xlstm-125m": 4, "musicgen-medium": 2,
                       "qwen2-vl-2b": 2}
# xlstm-125m's long row: one prefill of 2048 tokens, where the reference's
# parallel form gives NaN rows (ROADMAP C21: exp(a_s − amax_q) above
# float32's range above the diagonal, then multiplied by the mask)
XLSTM_LONG = 2048
FLOAT32_EXP_MAX = 88.72
# the first mLSTM layer of the long row in float32, the parallel form
# against the recurrence (the port's decode step over the row from the
# empty state), by each position's ‖Δh‖₂ / ‖h‖₂ over the heads: 4.7e-5 at
# most on the CPU with the same construction (random bfloat16 weights), so
# ten times that
MLSTM_RECURRENCE_RTOL = 5e-4
# xlstm-125m's float32 decode against its no-cache forward (the parallel
# form against the recurrence, bf16 rounding out of the way), the worst
# position's ‖Δ‖₂ / ‖logits‖₂: 3.2e-4 on the CPU and 1.9e-3 on an H100 at
# 4 × 512, 16 steps (this model amplifies rounding some 350×: its bf16
# forward lies 0.7 of the logits' norm from the float32 one), while a
# decode whose first mLSTM layer lost its state after the prefill lies
# 1.36 (median; CPU, 2 × 256) from the forward
XLSTM_F32_DECODE_RTOL = 1e-2


def _cat_batches(batches: list) -> dict:
    """Batches of one front end joined along the sequence."""
    return {key: torch.cat([b[key] for b in batches],
                           dim=1 if key == "embeds" else -1)
            for key in batches[0]}


def _no_cache_logits_of(cfg, params, prompt: dict, fed) -> torch.Tensor:
    """One no-cache forward over the prompt and the fed ids (rows, steps[,
    K]): its logits at the served positions (the prompt's last, then one a
    fed id), flattened to (positions × codebooks, V)."""
    from repro_torch.models import model as model_lib
    from repro_torch.roofline.serve_profile import next_position, step_batch
    mrope = next_position(prompt) if cfg.frontend == "vision" else 0
    fed = fed.to(DEVICE)
    steps = [step_batch(cfg, params, fed[:, i], mrope + i)
             for i in range(fed.shape[1])]
    with torch.inference_mode():
        logits = model_lib.forward(params, _cat_batches([prompt] + steps),
                                   cfg)[0]
    n = logits.shape[1] - fed.shape[1]      # the prompt's length
    return logits[:, n - 1:].reshape(-1, logits.shape[-1])


def _decode_vs_forward(cfg, params, prompt: dict, run: dict) -> list:
    """Each served position's logit gap (the prefill's last position, then
    every decode step's; each codebook's logits a position of their own)
    against one no-cache forward of the prompt and the fed ids."""
    want = _no_cache_logits_of(cfg, params, prompt, run["tokens"])
    return _logit_gaps(run["logits"].reshape(want.shape), want)


def _xlstm_decode_checks(cfg, params, prompt: dict, run: dict) -> dict:
    """xLSTM's decode against a no-cache forward.  At random weights the
    model is rounding-dominated in bfloat16: its bf16 forward lies a median
    0.66 (the reference's 0.70) of the logits' norm from the float32
    forward of the same bf16 weights (CPU, 2 × 256 tokens; 0.71 on an
    H100 at 4 × 528), beyond BF16_LOGIT_*.  So the served path is held to the forward in float32
    (the same weights, cast; greedy from the same prompt) within
    XLSTM_F32_DECODE_RTOL, and the bf16 run's gaps to the spread that
    rounding alone puts between the bf16 and float32 forwards of the bf16
    run's tokens: its median and worst position no larger."""
    from repro_torch.core.tree_util import tree_map
    want = _no_cache_logits_of(cfg, params, prompt, run["tokens"])
    gaps = _logit_gaps(run["logits"].reshape(want.shape), want)
    f32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    run32 = _direct_serve(f32, params32, prompt, DIRECT["steps"], DEVICE)
    gaps32 = _decode_vs_forward(f32, params32, prompt, run32)
    spread = _logit_gaps(want, _no_cache_logits_of(f32, params32, prompt,
                                                   run["tokens"]))
    out = {"bf16": {"median": float(np.median(gaps)),
                    "max": float(np.max(gaps))},
           "bf16_rounding_spread": {"median": float(np.median(spread)),
                                    "max": float(np.max(spread))},
           "float32": {"median": float(np.median(gaps32)),
                       "max": float(np.max(gaps32))},
           "float32_tol": XLSTM_F32_DECODE_RTOL}
    _require(out["float32"]["max"] <= XLSTM_F32_DECODE_RTOL
             and out["bf16"]["median"] <= out["bf16_rounding_spread"][
                 "median"]
             and out["bf16"]["max"] <= out["bf16_rounding_spread"]["max"],
             f"{cfg.name}: decode against a no-cache forward: {out}")
    del params32
    return out


def _direct_vs_cpu(name: str) -> dict:
    """The float32 cut (DIRECT_CHECK_LAYERS) at full width served on the
    card, then on the CPU teacher-forced with the card's ids: logits
    within LOGIT_TOL, each id the CPU's argmax wherever its margin exceeds
    2·LOGIT_TOL (phase 6's rule)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import model as model_lib
    from repro_torch.roofline.serve_profile import prompt_batch
    cfg = dataclasses.replace(get_arch(name),
                              n_layers=DIRECT_CHECK_LAYERS[name])
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(1), cfg)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rows, length, steps = (DIRECT_CHECK[k] for k in ("rows", "prompt",
                                                     "steps"))
    card = _direct_serve(cfg, params, prompt_batch(
        cfg, rows, length, DEVICE, 1, DIRECT_CHECK["grid"]), steps, DEVICE)
    host = _direct_serve(cfg, cpu_params, prompt_batch(
        cfg, rows, length, "cpu", 1, DIRECT_CHECK["grid"]), steps, "cpu",
        tokens=card["tokens"])
    err = float((card["logits"] - host["logits"]).abs().max())
    _require(err <= LOGIT_TOL,
             f"{name} float32 cut: card logits differ from the CPU's by "
             f"{err} > {LOGIT_TOL}")
    ref = host["logits"][:, :-1]
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_TOL
    _require(torch.equal(card["tokens"][clear], ref.argmax(-1)[clear]),
             f"{name} float32 cut: a served id differs from the CPU's "
             f"argmax where its margin exceeds {2 * LOGIT_TOL}")
    out = {"model": name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "rows": rows, "prompt_len": length, "decode_steps": steps,
           "max_abs_logit_err": err, "tol": LOGIT_TOL,
           "logit_std": float(host["logits"].std()),
           "ids_checked": int(clear.sum()), "near_ties": int((~clear).sum()),
           "prefill_launches": {k: n for k, n in
                                card["prefill_launches"].items() if n},
           "cpu_prefill_s": host["prefill_s"]}
    del params, cpu_params
    return out


def _mlstm_layer_vs_recurrence(cfg, params, tokens) -> dict:
    """The first mLSTM layer on the long row: its q, k, v and gates as the
    model computes them (bfloat16), then the parallel form against the
    recurrence, both float32; and the query rows where the reference's
    form, exp(a_s − amax_q) unmasked above the diagonal, overflows."""
    import torch.nn.functional as F
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.mamba2 import _causal_conv
    _, d_in, H, hd = xlstm_mod._mdims(cfg)
    block = tree_map(lambda t: t[0, 0], params["segments"][0])
    p = block["mlstm"]
    with torch.inference_mode():
        h = apply_norm(block["norm"], params["embed"][tokens], cfg.norm,
                       cfg.norm_eps)
        h_path = (h @ p["up"])[..., :d_in]
        conv_out = F.silu(_causal_conv(h_path, p["conv_w"], p["conv_b"]))
        q, k, v, log_i, log_f = xlstm_mod._qkv_gates(p, conv_out, h_path,
                                                     cfg)
        par = xlstm_mod._mlstm_parallel(q, k, v, log_i, log_f)
        B, S = tokens.shape
        state = (torch.zeros(B, H, hd, hd, device=DEVICE),
                 torch.zeros(B, H, hd, device=DEVICE),
                 torch.full((B, H), -torch.inf, device=DEVICE))
        rec = []
        for t in range(S):
            state, out = xlstm_mod._mlstm_step(
                state, q[:, t].float(), k[:, t].float() * hd ** -0.5,
                v[:, t].float(), log_i[:, t], log_f[:, t])
            rec.append(out)
        rec = torch.stack(rec, dim=1)
        gaps = ((par - rec).norm(dim=(-2, -1))
                / rec.norm(dim=(-2, -1))).flatten()
        a = log_i - torch.cumsum(log_f, dim=1)
        amax = torch.cummax(a, dim=1).values
        later = torch.cat([torch.flip(torch.cummax(
            torch.flip(a, [1]), dim=1).values, [1])[:, 1:],
            torch.full_like(a[:, :1], -torch.inf)], dim=1)
        overflow = ((later - amax) > FLOAT32_EXP_MAX).sum(dim=1)[0]
    out = {"layer": 0, "tokens": S, "finite": bool(torch.isfinite(par).all()),
           "gap_max": float(gaps.max()), "gap_median": float(gaps.median()),
           "tol": MLSTM_RECURRENCE_RTOL,
           "reference_nan_rows_by_head": overflow.tolist(),
           "log_f_mean_by_head": log_f.mean(dim=1)[0].tolist()}
    _require(out["finite"] and out["gap_max"] <= MLSTM_RECURRENCE_RTOL,
             f"xlstm-125m: the first mLSTM layer's parallel form against "
             f"the recurrence at {S} tokens: {out}")
    return out


def _serve_direct_model(name: str) -> int:
    """One of phase 20's models: seeded bfloat16 weights on the card, a
    warm-up, the timing run (DIRECT) with exact launches, decode against
    a no-cache forward, xLSTM's long row, then the float32 cut against the
    CPU.  Returns the timing run's attention launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import model as model_lib
    from repro_torch.roofline.serve_profile import prompt_batch
    cfg = dataclasses.replace(get_arch(name), dtype="bfloat16")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    rows, length, steps = (DIRECT[k] for k in ("rows", "prompt", "steps"))
    prompt = prompt_batch(cfg, rows, length, DEVICE, 0)
    _direct_serve(cfg, params, prompt, 2, DEVICE)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    run = _direct_serve(cfg, params, prompt, steps, DEVICE)
    n_attn = 0 if cfg.xlstm is not None else cfg.n_layers
    want = {key: 0 for key in run["prefill_launches"]}
    want["flash_attention_fwd"] = n_attn
    _require(run["prefill_launches"] == want
             and not any(run["decode_launches"].values()),
             f"{name}: prefill launches {run['prefill_launches']} (expected "
             f"{n_attn} attention launches, nothing else), decode "
             f"{run['decode_launches']} (expected none)")
    decode_s = float(np.sum(run["step_s"]))
    stats = {"phase": "direct_serving", "model": name, "dtype": cfg.dtype,
             "n_layers": cfg.n_layers,
             "params": sum(t.numel() for t in leaves),
             "param_bytes": sum(t.numel() * t.element_size()
                                for t in leaves),
             "init_s": init_s, "rows": rows, "prompt_len": length,
             "decode_steps": steps, "prefill_ms": run["prefill_s"] * 1e3,
             "prefill_tokens_per_s": rows * length / run["prefill_s"],
             "decode_ms_per_step": decode_s / steps * 1e3,
             "decode_ms_per_step_p50": float(np.median(run["step_s"])) * 1e3,
             "decode_tokens_per_s": rows * steps / decode_s,
             "flash_launches_prefill": run["prefill_launches"][
                 "flash_attention_fwd"],
             "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if cfg.xlstm is None:
        stats["decode_vs_no_cache"] = _gap_check(
            f"{name}: decode against a no-cache forward",
            _decode_vs_forward(cfg, params, prompt, run))
        stats["tol"] = [BF16_LOGIT_MEDIAN_RTOL, BF16_LOGIT_RTOL]
    else:
        stats["decode_vs_no_cache"] = _xlstm_decode_checks(cfg, params,
                                                           prompt, run)
        long = prompt_batch(cfg, 1, XLSTM_LONG, DEVICE, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = model_lib.serve_prefill(
                params, long, cfg, caches=model_lib.init_caches(
                    cfg, 1, XLSTM_LONG, device=DEVICE))
        _require(bool(torch.isfinite(logits).all()),
                 f"{name}: non-finite logits after a {XLSTM_LONG}-token "
                 f"prefill")
        stats["long_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        stats["long_row"] = _mlstm_layer_vs_recurrence(cfg, params,
                                                       long["tokens"])
    _emit(stats)
    del params, leaves, run
    _free()
    _emit({"phase": "direct_serving_vs_cpu", **_direct_vs_cpu(name)})
    _free()
    return stats["flash_launches_prefill"]


def phase_direct_serving() -> dict:
    """Phase 20.  Returns the timing runs' attention launches by the
    kernels line's names."""
    _free()
    _serve_direct_model("xlstm-125m")
    return {"flash_attention_fwd_musicgen_bf16": _serve_direct_model(
                "musicgen-medium"),
            "flash_attention_fwd_qwen2vl_bf16": _serve_direct_model(
                "qwen2-vl-2b")}


# Phase 21: the MoE, MLA, sliding-window and xLSTM families through the LM
# example's flat round (``_run_fed_lm``) at full width — every width of the
# published config kept — with depth and clients cut to the card.  Phase 8
# ran gemma-2b's cut at 68 bytes a parameter (float32 fedagrac, 2 clients);
# phase 16's bfloat16 fedagrac over the float32 master at ~72, its fedavg at
# ~32.  From ``ModelConfig.param_count()``: granite-moe-1b-a400m 8 of 24
# layers, P 0.478 G, float32 (~33 GB); deepseek-v2-lite-16b 1 of 27 layers
# (MLA and 64 experts top-6 + 2 shared), P 1.004 G, in bfloat16 over the
# float32 master (float32 would need ~68 GB); gemma3-12b 2 of 48 layers,
# one local (window 1024) and one global (global_every 2 for the
# published 6, the only cut that keeps one layer of each kind), P 1.455 G,
# at seq 2048 so that the window bites, in bfloat16 over the master with
# fedavg (fedagrac's ν⁽ⁱ⁾ and first-gradient rows would pass the card) and
# one held-out sequence (8 of 262,144-entry rows would take ~26 GB of
# logits); xlstm-125m uncut, P 0.194 G, float32.  lr 0.003 (phase 8's, C9),
# 2 rounds of the example's K_i ~ N(4, 2²); every cut's round fits under
# FAMILY_PEAK_BYTES (PERF.md, phase 21).  Then each model's tests' cut
# (``reduced(...,
# n_layers=2, d_model=64, vocab=256)``; gemma3 at seq 32 over its window of
# 16) on the card against the CPU by phase 8's rule, CPU reruns that change
# only rounding (reversed rows, then weights moved by a float32 ulp) drawn
# until the card is covered, at most FAMILY_SMALL["max_probes"]: MoE
# routing may flip on a rounding (C19) and xLSTM amplifies one (C23)
FAMILY_TRAIN = {
    "granite-moe-1b-a400m": {"layers": 8, "dtype": "float32", "clients": 2,
                             "batch": 2, "seq": 128,
                             "algorithms": ("fedagrac", "fedavg")},
    "deepseek-v2-lite-16b": {"layers": 1, "dtype": "bfloat16", "clients": 2,
                             "batch": 1, "seq": 256,
                             "algorithms": ("fedagrac",)},
    "gemma3-12b": {"layers": 2, "global_every": 2, "dtype": "bfloat16",
                   "clients": 2, "batch": 1, "seq": 2048, "held_out": 1,
                   "algorithms": ("fedavg",)},
    "xlstm-125m": {"layers": 12, "dtype": "float32", "clients": 2,
                   "batch": 2, "seq": 128, "algorithms": ("fedagrac",)}}
FAMILY_ROUNDS, FAMILY_LR = 2, 0.003
FAMILY_PEAK_BYTES = 75e9
FAMILY_SMALL = {"clients": 4, "batch": 2, "rounds": 3, "lr": 0.1,
                "max_probes": 4}
FAMILY_SMALL_SEQ = {"gemma3-12b": 32}
# the kernels line's names of each model's training instances
FAMILY_KERNELS = {"granite-moe-1b-a400m": "granite_train_f32",
                  "deepseek-v2-lite-16b": "mla_train_bf16",
                  "gemma3-12b": "gemma3_train_bf16"}


def _family_cut(name: str):
    from repro_torch.configs.registry import get_arch
    spec = FAMILY_TRAIN[name]
    cut = {"n_layers": spec["layers"], "dtype": spec["dtype"]}
    if "global_every" in spec:
        cut["global_every"] = spec["global_every"]
    return dataclasses.replace(get_arch(name), **cut)


def _attn_layers(cfg) -> int:
    """Attention layers a forward runs (each one B6 launch)."""
    from repro_torch.models import blocks, model as model_lib
    segments, n_groups = model_lib.group_spec(cfg)
    return n_groups * sum(n for kind, n, _ in segments
                          if kind in blocks.ATTN_KINDS)


def _family_run(name: str) -> dict:
    """Each algorithm of ``name``'s cut through the round, checked: exact
    launches, finite losses and perplexities, peak memory under
    FAMILY_PEAK_BYTES.  Returns the first algorithm's launches."""
    from repro_torch.configs.registry import get_arch
    spec = FAMILY_TRAIN[name]
    cfg = _family_cut(name)
    L = _attn_layers(cfg)
    run = {k: spec[k] for k in ("clients", "seq", "batch")}
    _emit({"phase": "family_training_cuts", "model": name,
           "n_layers": f"{cfg.n_layers} of {get_arch(name).n_layers}",
           "attention_layers": L, "dtype": cfg.dtype,
           "param_count": cfg.param_count(),
           "widths": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                      "vocab": cfg.vocab, "moe": dataclasses.asdict(cfg.moe)
                      if cfg.moe else None,
                      "mla": dataclasses.asdict(cfg.mla) if cfg.mla
                      else None, "sliding_window": cfg.sliding_window,
                      "xlstm": dataclasses.asdict(cfg.xlstm) if cfg.xlstm
                      else None}})
    first = None
    for algo in spec["algorithms"]:
        _free()
        g = _run_fed_lm(cfg, algo, DEVICE, rounds=FAMILY_ROUNDS, lr=FAMILY_LR,
                        bf16=cfg.dtype == "bfloat16", eval_first=True,
                        held_out=spec.get("held_out"), **run)
        steps = g["k_max"] * FAMILY_ROUNDS
        want = {"flash_attention_fwd": L * steps + L,
                "flash_attention_bwd_dq": L * steps,
                "flash_attention_bwd_dkv": L * steps,
                "calibrated_update": steps}
        want = {k: n for k, n in want.items() if n}
        launches = g["launches"]
        got = {k: launches[k] for k in want}
        tokens = run["clients"] * g["k_max"] * run["batch"] * run["seq"]
        wall = float(np.mean(g["round_wall_s"]))
        _emit({"phase": "family_training", "model": name, "algorithm": algo,
               "dtype": cfg.dtype, "master_dtype": str(g["master_dtype"]),
               "view_dtypes": g["view_dtypes"], **run,
               "rounds": FAMILY_ROUNDS, "lr": FAMILY_LR, "params": g["n"],
               "k": g["k"], "k_max": g["k_max"], "loss": g["loss"].tolist(),
               "initial_perplexity": g["metric0"],
               "perplexity": g["metric"].tolist(),
               "wall_per_round_s": g["round_wall_s"],
               "wall_per_local_step_s": wall / g["k_max"],
               "tokens_per_round": tokens,
               "train_tokens_per_s": tokens / wall,
               "run_wall_s": g["wall_s"], "launches": got,
               "peak_memory_bytes": g["peak_memory_bytes"]})
        _require(got == want and all(n == 0 for k, n in launches.items()
                                     if k not in want),
                 f"{name} {algo}: launches {launches}, expected {want} and "
                 f"no other")
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"{name} {algo}: non-finite loss {g['loss']} or perplexity "
                 f"{g['metric']}")
        _require(g["peak_memory_bytes"] < FAMILY_PEAK_BYTES,
                 f"{name} {algo}: peak memory {g['peak_memory_bytes']} "
                 f"passes {FAMILY_PEAK_BYTES}")
        first = first or launches
        del g
    _free()
    return first


def _family_vs_cpu(name: str) -> None:
    """The tests' cut of ``name`` on the card against the CPU, for each of
    its algorithms, by phase 8's rule (``_lm_vs_cpu_margins``)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    small = reduced(get_arch(name), n_layers=2, d_model=64, vocab=256)
    srun = {k: FAMILY_SMALL[k] for k in ("clients", "batch", "rounds",
                                         "lr")}
    srun["seq"] = FAMILY_SMALL_SEQ.get(name, 16)
    for algo in FAMILY_TRAIN[name]["algorithms"]:
        def one(dev, **kw):
            return _run_fed_lm(small, algo, dev, generator=torch.Generator(
                ).manual_seed(0), **srun, **kw)
        g, c = one(DEVICE), one("cpu")
        probes = [one("cpu", flip_rows=True)]
        while (not _vs_covered(_lm_vs_cpu_margins(g, c, probes))
               and len(probes) < FAMILY_SMALL["max_probes"]):
            probes.append(one("cpu", ulp_moved=len(probes)))
        vs = _lm_vs_cpu_margins(g, c, probes)
        _emit({"phase": "family_training_vs_cpu",
               "model": f"reduced {name}, 2 layers, d 64", "algorithm": algo,
               **srun, "k": g["k"], "loss": g["loss"].tolist(),
               "perplexity": g["metric"].tolist(), "probes": len(probes),
               "launches": {k: n for k, n in g["launches"].items() if n},
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
        _require(g["launches"]["calibrated_update"] > 0,
                 f"{name} small: the card run launched no B1")
        for what, (diff, tol) in vs.items():
            _require(bool(np.all(diff <= tol)),
                     f"{name} small {algo}: {what} differs from the CPU run "
                     f"by {diff}, more than {tol}")


def phase_family_training() -> dict:
    """Phase 21.  Returns each attention model's launches of its training
    instances by the kernels line's names (the first algorithm's run)."""
    out = {}
    for name in FAMILY_TRAIN:
        launches = _family_run(name)
        _family_vs_cpu(name)
        if name in FAMILY_KERNELS:
            for kernel in ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"):
                out[f"{kernel}_{FAMILY_KERNELS[name]}"] = launches[kernel]
    return out



# Phase 22: the launch layer's serving steps (``repro_torch.launch.serve``,
# ``build_prefill`` / ``build_decode``) on a torch.distributed mesh of one
# rank: a ``(1, 1)`` ("data", "model") ``DeviceMesh`` over a one-rank group
# (gloo for the CPU, NCCL for the card, on a ``HashStore``), every tensor a
# DTensor placed by ``serve_specs`` (all replicated on one rank).
# qwen1.5-32b uncut in bfloat16 (64 layers, d 5120, MHA 40 / 40 at head
# dim 128, QKV bias, GLU 27,392, vocab 152,064; 70.4 GB of weights) from
# seeded weights made on the card: LAUNCH_ROWS × LAUNCH_PROMPT tokens into
# caches of LAUNCH_CACHE slots (5.37 GB), then LAUNCH_STEPS greedy steps,
# after a warm-up of the same prefill and two steps.  The float32 cut (1
# of 64 layers at full width, ≈8.3 GB) on the card's mesh against a
# ``(1, 1)`` CPU mesh of the same group, within LOGIT_TOL
LAUNCH_ARCH = "qwen1.5-32b"
LAUNCH_ROWS, LAUNCH_PROMPT, LAUNCH_CACHE, LAUNCH_STEPS = 4, 512, 1024, 16
LAUNCH_PROFILED = 4           # decode steps profiled for the busy share
LAUNCH_CHECK = {"layers": 1, "rows": 2, "prompt": 128, "steps": 8}
# placing the weights must not copy them: the peak after placement, above
# what earlier phases still hold, within this of the weights' bytes
PLACE_SLACK = 1 << 30


def _launch_run(cfg, params, tokens: torch.Tensor, steps: int, mesh,
                cache_len: int, fed=None, profiled: int = 0) -> dict:
    """``build_prefill`` of ``tokens`` (rows, length) into fresh caches of
    ``cache_len`` slots, then ``steps`` ``build_decode`` steps, greedy or
    fed ``fed`` (rows, steps); then ``profiled`` more steps under
    ``torch.profiler`` on the card for the device's busy share.  Returns
    the logits of every step (float32, on the CPU), the ids fed, the walls
    and the kernels' launches in the prefill and in the timed steps."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    from repro_torch.roofline.round_profile import _busy_us
    rows, length = tokens.shape
    on_card = mesh.device_type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    profiled = profiled if on_card else 0
    prefill, bundle = serve.build_prefill(
        cfg, ShapeConfig("prefill", cache_len, rows, "prefill"), mesh)
    decode, _ = serve.build_decode(
        cfg, ShapeConfig("decode", cache_len, rows, "decode"), mesh)
    placed = serve.place(params, bundle["param_ps"], mesh)
    seen, ids, step_s = [], [], []
    sync()
    _reset_all_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(placed, {"tokens": tokens}, model_lib.init_caches(
        cfg, rows, cache_len, device=mesh.device_type))
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_launches = _all_launches()
    _reset_all_launches()
    for i in range(steps):
        whole = logits.full_tensor()[:, -1]
        _require(bool(torch.isfinite(whole).all()),
                 f"{cfg.name}: non-finite logits at step {i}")
        seen.append(whole.float().cpu())
        tok = whole.argmax(-1) if fed is None else fed[:, i].to(whole.device)
        ids.append(tok.cpu())
        t0 = time.perf_counter()
        logits, caches = decode(placed, {"tokens": tok[:, None]}, caches,
                                length + i)
        sync()
        step_s.append(time.perf_counter() - t0)
    decode_launches = _all_launches()
    whole = logits.full_tensor()[:, -1]
    _require(bool(torch.isfinite(whole).all()),
             f"{cfg.name}: non-finite logits after the last step")
    seen.append(whole.float().cpu())
    busy = None
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for j in range(profiled):
                logits, caches = decode(
                    placed, {"tokens": whole.argmax(-1)[:, None]}, caches,
                    length + steps + j)
                whole = logits.full_tensor()[:, -1]
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            busy = _busy_us([(e.time_range.start, e.time_range.end)
                             for e in kernels]) / wall_us
    return {"logits": torch.stack(seen, 1), "tokens": torch.stack(ids, 1),
            "prefill_s": prefill_s, "step_s": step_s,
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches, "busy_share": busy}


def _launch_vs_cpu(mesh, cpu_mesh) -> dict:
    """The float32 cut served through the launch steps on the card's mesh,
    then on the CPU mesh teacher-forced with the card's ids: logits within
    LOGIT_TOL, each id the CPU's argmax wherever its margin exceeds
    2·LOGIT_TOL (phase 6's rule)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(get_arch(LAUNCH_ARCH),
                              n_layers=LAUNCH_CHECK["layers"])
    params = model_lib.init_params(
        torch.Generator(device=DEVICE).manual_seed(2), cfg)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rows, length, steps = (LAUNCH_CHECK[k] for k in ("rows", "prompt",
                                                     "steps"))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (rows, length)))
    card = _launch_run(cfg, params, tokens.to(DEVICE), steps, mesh,
                       length + steps)
    t0 = time.perf_counter()
    host = _launch_run(cfg, cpu_params, tokens, steps, cpu_mesh,
                       length + steps, fed=card["tokens"])
    cpu_s = time.perf_counter() - t0
    err = float((card["logits"] - host["logits"]).abs().max())
    _require(err <= LOGIT_TOL,
             f"{LAUNCH_ARCH} float32 cut: card logits differ from the "
             f"CPU's by {err} > {LOGIT_TOL}")
    ref = host["logits"][:, :-1]
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_TOL
    _require(torch.equal(card["tokens"][clear], ref.argmax(-1)[clear]),
             f"{LAUNCH_ARCH} float32 cut: a served id differs from the "
             f"CPU's argmax where its margin exceeds {2 * LOGIT_TOL}")
    out = {"model": LAUNCH_ARCH, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "rows": rows, "prompt_len": length,
           "decode_steps": steps, "max_abs_logit_err": err,
           "tol": LOGIT_TOL, "logit_std": float(host["logits"].std()),
           "ids_checked": int(clear.sum()),
           "near_ties": int((~clear).sum()),
           "card_prefill_launches": {k: n for k, n in
                                     card["prefill_launches"].items() if n},
           "cpu_s": cpu_s}
    del params, cpu_params
    return out


def phase_launch_serving() -> dict:
    """Phase 22.  Returns the timing run's attention launches by the
    kernels line's name."""
    import torch.distributed as tdist
    from repro_torch import dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.launch import serve, specs as specs_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as model_lib
    _free()
    # what earlier phases still hold; the placement check reads above it
    held = torch.cuda.memory_allocated()
    tdist.init_process_group(backend="cpu:gloo,cuda:nccl",
                             store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        cfg = dataclasses.replace(get_arch(LAUNCH_ARCH), dtype="bfloat16")
        t0 = time.perf_counter()
        params = model_lib.init_params(
            torch.Generator(device=DEVICE).manual_seed(0), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = tree_leaves(params)
        param_bytes = sum(t.numel() * t.element_size() for t in leaves)
        torch.cuda.reset_peak_memory_stats()
        bundle = specs_lib.serve_specs(cfg, ShapeConfig(
            "prefill", LAUNCH_CACHE, LAUNCH_ROWS, "prefill"), mesh,
            kind="prefill")
        placed = serve.place(params, bundle["param_ps"], mesh)
        torch.cuda.synchronize()
        placed_peak = torch.cuda.max_memory_allocated() - held
        shared = all(a.to_local().data_ptr() == b.data_ptr() for a, b in
                     zip(tree_leaves(placed), leaves))
        _require(shared and placed_peak <= param_bytes + PLACE_SLACK,
                 f"placing {LAUNCH_ARCH}'s weights copied them: peak "
                 f"{placed_peak} B for {param_bytes} B of weights, storage "
                 f"shared: {shared}")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab, (LAUNCH_ROWS, LAUNCH_PROMPT))).to(DEVICE)
        _launch_run(cfg, placed, tokens, 2, mesh, LAUNCH_CACHE)   # warm-up
        _free()
        run = _launch_run(cfg, placed, tokens, LAUNCH_STEPS, mesh,
                          LAUNCH_CACHE, profiled=LAUNCH_PROFILED)
        peak = torch.cuda.max_memory_allocated()
        want = {key: 0 for key in run["prefill_launches"]}
        want["flash_attention_fwd"] = cfg.n_layers
        _require(run["prefill_launches"] == want
                 and not any(run["decode_launches"].values()),
                 f"{LAUNCH_ARCH}: prefill launches "
                 f"{run['prefill_launches']} (expected {cfg.n_layers} "
                 f"attention launches, nothing else), decode "
                 f"{run['decode_launches']} (expected none)")
        decode_s = float(np.sum(run["step_s"]))
        stats = {"phase": "launch_serving", "card": _card_line(),
                 "model": LAUNCH_ARCH,
                 "dtype": cfg.dtype, "n_layers": cfg.n_layers,
                 "mesh": dist.view(mesh).shape, "world": tdist.get_world_size(),
                 "params": sum(t.numel() for t in leaves),
                 "param_bytes": param_bytes, "init_s": init_s,
                 "held_before_bytes": held,
                 "placed_peak_bytes": placed_peak,
                 "rows": LAUNCH_ROWS, "prompt_len": LAUNCH_PROMPT,
                 "cache_len": LAUNCH_CACHE, "decode_steps": LAUNCH_STEPS,
                 "prefill_ms": run["prefill_s"] * 1e3,
                 "prefill_tokens_per_s": LAUNCH_ROWS * LAUNCH_PROMPT
                 / run["prefill_s"],
                 "decode_ms_per_step": decode_s / LAUNCH_STEPS * 1e3,
                 "decode_ms_per_step_p50": float(np.median(run["step_s"]))
                 * 1e3,
                 "decode_tokens_per_s": LAUNCH_ROWS * LAUNCH_STEPS / decode_s,
                 "decode_weight_bound_ms": param_bytes / HBM_BYTES_PER_S
                 * 1e3,
                 "decode_busy_share": run["busy_share"],
                 "flash_launches_prefill": run["prefill_launches"][
                     "flash_attention_fwd"],
                 "peak_memory_bytes": peak}
        # (f) the mesh's prefill against the plain serve_prefill
        with torch.inference_mode():
            plain, _ = model_lib.serve_prefill(params, {"tokens": tokens},
                                               cfg)
        plain = plain[:, -1].float().cpu()
        stats["mesh_vs_plain_equal"] = bool(torch.equal(
            run["logits"][:, 0], plain))
        if not stats["mesh_vs_plain_equal"]:
            stats["mesh_vs_plain"] = _gap_check(
                f"{LAUNCH_ARCH}: the mesh's prefill against serve_prefill",
                _logit_gaps(run["logits"][:, 0], plain))
        # (e) decode against a no-cache forward of the same ids
        stats["decode_vs_no_cache"] = _gap_check(
            f"{LAUNCH_ARCH}: decode against a no-cache forward",
            _decode_vs_forward(cfg, params, {"tokens": tokens}, run))
        stats["tol"] = [BF16_LOGIT_MEDIAN_RTOL, BF16_LOGIT_RTOL]
        _emit(stats)
        del params, placed, leaves, run, plain
        _free()
        _emit({"phase": "launch_serving_vs_cpu", **_launch_vs_cpu(
            mesh, make_local_mesh(1, 1, device_type="cpu"))})
        _free()
    finally:
        dist.unset_mesh()
        tdist.destroy_process_group()
    return {"flash_attention_fwd_qwen15_bf16": stats[
        "flash_launches_prefill"]}

# Phase 23: the launch layer's training round (``repro_torch.launch.train``,
# ``build_train_round``) on the same one-rank mesh: llama3-8b
# (arXiv:2407.21783) at full width — d 4096, 32 / 8 heads of 128, GLU
# 14,336, vocab 128,256, untied head — in bfloat16 over a float32 flat
# master (the reference ``main``'s configuration for an uncut arch with
# --param-layout flat --master-dtype float32), cut to 2 of 32 layers
# (P ≈ 1.487 B, a 5.95 GB float32 buffer), ``train_4k``'s sequence of
# 4096 kept with its global batch cut from 256 to 2 (M = 1 on one card,
# two rows a client), k_max 2, three rounds run as a chunk of 2 and its
# tail of 1 (the length-polymorphic chunk).  The chunked run is held to
# three single rounds on the mesh and to three ``make_flat_round`` rounds
# on plain tensors, bit for bit (a size-1 mesh replicates; were they not
# equal, within PATH_SPREAD × the spread of a plain rerun with reversed
# rows); one tree-layout bfloat16 round to the plain ``make_round``; and
# the reduced float32 cut (LAUNCH_TRAIN_CHECK) on the card's mesh to a
# ``(1, 1)`` CPU mesh of the same group by phase 8's rule
LAUNCH_TRAIN_ARCH = "llama3-8b"
LAUNCH_TRAIN = {"layers": 2, "global_batch": 2, "k_max": 2, "rounds": 3,
                "chunk": 2, "lr": 3e-2}
LAUNCH_TRAIN_CHECK = {"layers": 2, "d_model": 64, "vocab": 256, "seq": 32,
                      "global_batch": 2, "lr": 0.1, "max_probes": 4}


def _launch_train_inputs(cfg, m: int, k_max: int, b_local: int, seq: int,
                         rounds: int, device, flip: bool = False):
    """``rounds`` rounds of ``launch.train.round_inputs`` stacked on
    ``device``: batches (rounds, m, k_max, b_local, seq) and K_i (rounds,
    m); ``flip`` reverses each microbatch's rows (the same loss, other
    roundings)."""
    from repro_torch.launch import train
    per = [train.round_inputs(cfg, m, k_max, b_local, seq, t)
           for t in range(rounds)]
    batches = {k: torch.stack([b[k] for b, _ in per]).to(device)
               for k in per[0][0]}
    if flip:
        batches = {k: v.flip(3) for k, v in batches.items()}
    return batches, torch.stack([k for _, k in per]).to(device)


STATE_KEYS = ("params", "nu", "nu_i")
# the slices in which a state buffer goes back to the card to be compared
COMPARE_SLICE = 1 << 28


def _local(t: torch.Tensor) -> torch.Tensor:
    from repro_torch import dist
    return t.to_local() if dist.is_dtensor(t) else t


def _pinned(tensors: dict) -> dict:
    """Copies of the card's ``tensors`` (DTensors: their local shards) in
    pinned host memory."""
    out = {}
    for k, v in tensors.items():
        v = _local(v)
        out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        out[k].copy_(v)
    return out


def _state_host(state: dict) -> dict:
    """The round state's float buffers, whole, in pinned host memory."""
    return _pinned({k: state[k] for k in STATE_KEYS})


def _gaps(tensors: dict, host: dict) -> dict:
    """Each tensor's largest |difference| from its pinned host copy, the
    copy brought back to the card a slice at a time: 0.0 where the two
    are equal to the bit, inf where they differ only in bits that no
    difference shows (a NaN, a signed zero)."""
    gaps = {}
    for k, h in host.items():
        v, h = _local(tensors[k]).reshape(-1), h.reshape(-1)
        worst, same = 0.0, True
        for i in range(0, v.numel(), COMPARE_SLICE):
            a = v[i:i + COMPARE_SLICE]
            b = h[i:i + COMPARE_SLICE].to(a.device, non_blocking=True)
            if not torch.equal(a, b):
                same = False
                worst = max(worst, float((a.float() - b.float()).abs()
                                         .max()))
        gaps[k] = 0.0 if same else (worst or float("inf"))
    return gaps


def _launch_train_check(mesh, cpu_mesh) -> dict:
    """The reduced float32 cut through ``build_train_round`` (flat,
    fedagrac, a chunk of 2 and its tail) on the card's mesh against the
    CPU mesh, by phase 8's rule: PATH_SPREAD × the largest spread of CPU
    reruns that change only rounding (reversed rows, then one-ulp moves of
    the initial master) plus PATH_RTOL, drawn until the card is
    covered."""
    from repro_torch.configs.base import FedConfig, ShapeConfig, reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flat, rounds as rounds_lib
    from repro_torch.core.fedopt import get_algorithm
    from repro_torch.launch import train
    from repro_torch.models import model as model_lib
    c = LAUNCH_TRAIN_CHECK
    cfg = reduced(get_arch(LAUNCH_TRAIN_ARCH), n_layers=c["layers"],
                  d_model=c["d_model"], vocab=c["vocab"])
    shape = ShapeConfig("t", seq_len=c["seq"],
                        global_batch=c["global_batch"], kind="train")
    fed = FedConfig(algorithm="fedagrac", lr=c["lr"], param_layout="flat")
    algo = get_algorithm(fed.algorithm, fed)
    k_max, n_rounds = LAUNCH_TRAIN["k_max"], LAUNCH_TRAIN["rounds"]

    def run(on, flip=False, moved=None):
        chunk, bundle = train.build_train_round(
            cfg, shape, on, fed, k_max=k_max, chunk_rounds=2)
        dev = torch.device(on.device_type)
        params = model_lib.init_params(torch.Generator().manual_seed(3), cfg)
        master = flat.ravel(bundle["flat_spec"], params)
        if moved is not None:
            master = _f32_moved(master, bundle["flat_spec"].n, moved)
        m, b = bundle["m"], bundle["b_local"]
        batches, ks = _launch_train_inputs(cfg, m, k_max, b, c["seq"],
                                           n_rounds, dev, flip)
        w = torch.full((m,), 1.0 / m, device=dev)
        st = rounds_lib.init_state(master.to(dev), m, algo)
        _reset_all_launches()
        losses = []
        for sl in (slice(0, 2), slice(2, n_rounds)):
            r = sl.stop - sl.start
            st, met = chunk(st, {k: v[sl] for k, v in batches.items()},
                            ks[sl], w.expand(r, m), [algo.lam] * r)
            losses += met["loss"].full_tensor().cpu().tolist()
        return {"loss": np.array(losses),
                "metric": np.array(losses[-1:]),
                "params": st["params"].to_local().cpu(),
                "launches": _all_launches()}

    g, cpu = run(mesh), run(cpu_mesh)
    probes = [run(cpu_mesh, flip=True)]
    while (not _vs_covered(_lm_vs_cpu_margins(g, cpu, probes))
           and len(probes) < c["max_probes"]):
        probes.append(run(cpu_mesh, moved=len(probes)))
    vs = _lm_vs_cpu_margins(g, cpu, probes)
    _require(g["launches"]["calibrated_update"] == k_max * n_rounds,
             f"the reduced cut's card run launched B1 "
             f"{g['launches']['calibrated_update']} times, expected "
             f"{k_max * n_rounds}")
    for what, (diff, tol) in vs.items():
        _require(bool(np.all(diff <= tol)),
                 f"the reduced cut through build_train_round: {what} "
                 f"differs from the CPU mesh by {diff}, more than {tol}")
    return {"model": f"reduced {LAUNCH_TRAIN_ARCH}, {c['layers']} layers, "
                     f"d {c['d_model']}", "seq": c["seq"],
            "loss": g["loss"].tolist(), "probes": len(probes),
            "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
            "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}}


def phase_launch_training() -> tuple[dict, dict]:
    """Phase 23.  Returns the chunked run's launches of B1 and of the
    attention kernels, by the kernels line's names, and B1's check and
    times at the path's ``(M, P)`` float32 rows (``check_update_at``)."""
    import torch.distributed as tdist
    from repro_torch import dist
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core import flat, rounds as rounds_lib
    from repro_torch.core.fedopt import get_algorithm
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.launch import specs as specs_lib, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.roofline.round_profile import _busy_us
    _free()
    tdist.init_process_group(backend="cpu:gloo,cuda:nccl",
                             store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        lt = LAUNCH_TRAIN
        k_max, n_rounds = lt["k_max"], lt["rounds"]
        cfg = specs_lib.bf16_config(dataclasses.replace(
            get_arch(LAUNCH_TRAIN_ARCH), n_layers=lt["layers"]))
        shape = dataclasses.replace(SHAPES["train_4k"],
                                    global_batch=lt["global_batch"])
        fed = FedConfig(algorithm="fedagrac", lr=lt["lr"],
                        param_layout="flat", master_dtype="float32")
        algo = get_algorithm(fed.algorithm, fed)
        chunk, bundle = train.build_train_round(cfg, shape, mesh, fed,
                                                k_max=k_max,
                                                chunk_rounds=lt["chunk"])
        single, _ = train.build_train_round(cfg, shape, mesh, fed,
                                            k_max=k_max)
        fspec, m, b_local = (bundle["flat_spec"], bundle["m"],
                             bundle["b_local"])
        # B1 against its plain version at the rows the path updates (on
        # a one-rank mesh each rank's shard is the whole row), before the
        # model takes the card's memory
        b1 = check_update_at(m, fspec.p)
        _free()
        params = model_lib.init_params(
            torch.Generator(device=DEVICE).manual_seed(0), cfg)
        master = flat.ravel(fspec, params)
        del params
        batches, ks = _launch_train_inputs(cfg, m, k_max, b_local,
                                           shape.seq_len, n_rounds, DEVICE)
        w = torch.full((m,), 1.0 / m, device=DEVICE)

        def one(t):
            return {k: v[t] for k, v in batches.items()}

        part_s = {}
        t_part = time.perf_counter()

        def lap(name):
            nonlocal t_part
            now = time.perf_counter()
            part_s[name] = now - t_part
            t_part = now

        # warm-up: one round (cuBLAS handles, the allocator's pools)
        single(rounds_lib.init_state(master, m, algo), one(0), ks[0], w)
        _free()
        lap("init_and_warm_up")
        torch.cuda.reset_peak_memory_stats()
        # (a) the main path: a chunk of 2 and its tail of 1
        _reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m1 = chunk(rounds_lib.init_state(master, m, algo),
                       {k: v[:2] for k, v in batches.items()}, ks[:2],
                       w.expand(2, m), [algo.lam] * 2)
        st, m2 = chunk(st, {k: v[2:] for k, v in batches.items()}, ks[2:],
                       w.expand(1, m), [algo.lam])
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        launches = _all_launches()
        peak = torch.cuda.max_memory_allocated()
        steps = k_max * n_rounds
        want = {"calibrated_update": steps,
                "flash_attention_fwd": cfg.n_layers * steps,
                "flash_attention_bwd_dq": cfg.n_layers * steps,
                "flash_attention_bwd_dkv": cfg.n_layers * steps}
        _require(all(launches[k] == n for k, n in want.items())
                 and not any(n for k, n in launches.items()
                             if k not in want),
                 f"{LAUNCH_TRAIN_ARCH} through build_train_round: launches "
                 f"{launches}, expected {want} and no other")
        losses = torch.cat([m1["loss"].full_tensor(),
                            m2["loss"].full_tensor()]).cpu()
        _require(bool(torch.isfinite(losses).all()),
                 f"{LAUNCH_TRAIN_ARCH}: non-finite losses {losses.tolist()}")
        chunked = _state_host(st)
        del st
        _free()
        lap("chunked_run_and_host_copy")
        # (b) three single rounds on the mesh: the chunk's rounds, bit for
        # bit; each round's host seconds to issue it (no sync inside)
        st = rounds_lib.init_state(master, m, algo)
        mesh_wall, mesh_host = [], []
        for t in range(n_rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = single(st, one(t), ks[t], w)
            mesh_host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            mesh_wall.append(time.perf_counter() - t0)
        chunk_gaps = _gaps(st, chunked)
        chunk_equal = not any(chunk_gaps.values())
        _require(chunk_equal, f"{LAUNCH_TRAIN_ARCH}: the chunk of 2 and its "
                 f"tail differ from three single rounds by {chunk_gaps}")
        lap("single_rounds_and_compare")
        # the device's busy share over one more round, profiled
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = single(st, one(0), ks[0], w)
            torch.cuda.synchronize()
            prof_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = (_busy_us([(e.time_range.start, e.time_range.end)
                          for e in kernels]) / prof_us if kernels else None)
        del st
        _free()
        lap("profiled_round")
        # (c) the same rounds through make_flat_round on plain tensors
        dist.unset_mesh()

        def plain_rounds(data):
            fn = flat.make_flat_round(
                fspec, lambda p, b: model_lib.lm_loss(p, b, cfg), algo,
                lr=fed.lr, k_max=k_max)
            st = rounds_lib.init_state(master, m, algo)
            wall, host = [], []
            for t in range(n_rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = fn(st, {k: v[t] for k, v in data.items()}, ks[t], w)
                host.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
            return st, wall, host

        plain, plain_wall, plain_host = plain_rounds(batches)
        gaps = _gaps(plain, chunked)
        equal = not any(gaps.values())
        vs_plain = None
        if not equal:
            # the rounding spread: the plain rounds again with each
            # microbatch's rows reversed
            plain_copy = _state_host(plain)
            del plain
            _free()
            flipped, _, _ = plain_rounds({k: v.flip(3) for k, v in
                                          batches.items()})
            spread = _gaps(flipped, plain_copy)
            vs_plain = {k: (gaps[k], PATH_SPREAD * spread[k])
                        for k in STATE_KEYS}
            for k, (diff, tol) in vs_plain.items():
                _require(diff <= tol,
                         f"{LAUNCH_TRAIN_ARCH}: the mesh's {k} differs from "
                         f"make_flat_round's by {diff} > {tol}")
            del flipped, plain_copy
        else:
            del plain
        del chunked
        _free()
        lap("plain_rounds_and_compare")
        # (d) one tree-layout bfloat16 round on the mesh and plain
        tree_fed = dataclasses.replace(fed, param_layout="tree",
                                       master_dtype="")
        tree_step, _ = train.build_train_round(cfg, shape, mesh, tree_fed,
                                               k_max=k_max)
        params = flat.unravel(fspec, master)
        del master
        _free()
        st, _ = tree_step(rounds_lib.init_state(params, m, algo), one(0),
                          ks[0], w)
        tree_mesh = _pinned(dict(enumerate(tree_leaves(st["params"]))))
        del st
        dist.unset_mesh()
        st, _ = rounds_lib.make_round(
            lambda p, b: model_lib.lm_loss(p, b, cfg), algo, lr=fed.lr,
            k_max=k_max)(rounds_lib.init_state(params, m, algo), one(0),
                         ks[0], w)
        tree_plain = dict(enumerate(tree_leaves(st["params"])))
        tree_finite = all(bool(torch.isfinite(t).all())
                          for t in tree_plain.values())
        tree_equal = not any(_gaps(tree_plain, tree_mesh).values())
        _require(tree_finite and tree_equal,
                 f"{LAUNCH_TRAIN_ARCH} tree bf16 round: finite "
                 f"{tree_finite}, the mesh's equal to make_round's "
                 f"{tree_equal}")
        del st, params, tree_mesh, tree_plain
        _free()
        lap("tree_rounds")
        tokens = m * k_max * b_local * shape.seq_len
        wall = float(np.mean(mesh_wall))
        stats = {"phase": "launch_training", "card": _card_line(),
                 "model": LAUNCH_TRAIN_ARCH, "dtype": cfg.dtype,
                 "master_dtype": fed.master_dtype, "layout": "flat",
                 "algorithm": fed.algorithm, "n_layers": cfg.n_layers,
                 "mesh": dist.view(mesh).shape,
                 "world": tdist.get_world_size(), "params": fspec.n,
                 "p": fspec.p, "clients": m, "b_local": b_local,
                 "seq": shape.seq_len, "k_max": k_max,
                 "k": ks.cpu().tolist(), "rounds": n_rounds,
                 "chunks": [2, 1], "loss": losses.tolist(),
                 "chunked_wall_s": chunk_s,
                 "wall_per_round_s": mesh_wall,
                 "wall_per_local_step_s": wall / k_max,
                 "tokens_per_round": tokens,
                 "tokens_per_s": tokens / wall,
                 "plain_wall_per_round_s": plain_wall,
                 "host_s_per_round": mesh_host,
                 "plain_host_s_per_round": plain_host,
                 "dtensor_host_s_per_round": float(np.mean(mesh_host)
                                                   - np.mean(plain_host)),
                 "dtensor_host_share": float(
                     (np.mean(mesh_host) - np.mean(plain_host)) / wall),
                 "busy_share": busy, "peak_memory_bytes": peak,
                 "launches": {k: n for k, n in launches.items() if n},
                 "chunk_equals_singles": chunk_equal,
                 "mesh_vs_plain_equal": equal,
                 "tree_bf16_round_equal": tree_equal}
        if vs_plain is not None:
            stats["mesh_vs_plain"] = vs_plain
        check = _launch_train_check(mesh, make_local_mesh(1, 1,
                                                          device_type="cpu"))
        lap("reduced_cut_vs_cpu")
        stats["part_s"] = part_s
        _emit(stats)
        _emit({"phase": "launch_training_vs_cpu", **check})
        _free()
    finally:
        dist.unset_mesh()
        tdist.destroy_process_group()
    return ({"calibrated_update_llama3_train": launches["calibrated_update"],
             **{f"{k}_llama3_train_bf16": launches[k]
                for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv")}}, b1)

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    t_start = time.perf_counter()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _emit({"phase_time": name, "s": time.perf_counter() - t0})
        return out

    timed("env", phase_env)
    timings = timed("kernels", phase_kernels)
    timings.update(timed("wire_kernels", phase_wire_kernels))
    timings["flash_attention_fwd"] = timed("attention_kernel",
                                           phase_attention_kernel)
    timings["flash_attention_fwd_bf16"] = timings[
        "flash_attention_fwd"].pop("bf16_step")
    for name in (*ATTN_SERVE_SHAPES, *ATTN_TRAIN_SHAPES):
        timings[f"flash_attention_fwd_{name}"] = timings[
            "flash_attention_fwd"].pop(name)
    launches = timed("main_path", phase_main_path)
    launches.update(timed("compressed_path", phase_compressed_path))
    launches["flash_attention_fwd"] = timed(
        "serving", phase_serving)["flash_attention_fwd"]
    timings.update(timed("attention_backward", phase_attention_backward))
    lm_launches, flat_lm = timed("fed_lm", phase_fed_lm)
    launches.update({name: n for name, n in lm_launches.items()
                     if name.startswith("flash_attention_bwd")})
    timings.update(timed("ssd_kernel", phase_ssd_kernel))
    launches["ssd_scan"] = timed("hybrid", phase_hybrid)["ssd_scan"]
    host_ms = timed("population", phase_population)["host_mode_ms"]
    import multiprocessing
    reference = json.loads(REFERENCE_QUICK.read_text())["modules"]
    # phase 13 (a) runs in a worker beside phase 12: both are host-bound
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        table_async = pool.apply_async(_table_async_run,
                                       (reference["table_async"],))
        for name, n in timed("twins", phase_twins).items():
            launches[name] = launches.get(name, 0) + n
        for name, n in timed("async", lambda: phase_async(
                table_async=table_async)).items():
            launches[name] = launches.get(name, 0) + n
    for name, n in timed("faults", phase_faults).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed("device_path", lambda: phase_device_path(
            host_ms=host_ms)).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed("personalized", phase_personalized).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed("hybrid_training", phase_hybrid_training).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed("tree_layout",
                         lambda: phase_tree_layout(flat_lm)).items():
        launches[name] = launches.get(name, 0) + n
    del flat_lm
    launches.update(timed("moe_mla_window", phase_moe_mla_window))
    launches.update(timed("direct_serving", phase_direct_serving))
    launches.update(timed("family_training", phase_family_training))
    launches.update(timed("launch_serving", phase_launch_serving))
    lt_launches, timings["calibrated_update_llama3_train"] = timed(
        "launch_training", phase_launch_training)
    launches.update(lt_launches)
    _emit({"phase_time": "total", "s": time.perf_counter() - t_start})
    # again at the end, so that the tail of a long log names the card
    print(_card_line(), flush=True)
    quantize_src = "src/repro_torch/kernels/quantize/csrc/quantize.cu"
    bwd_src = ("src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_bwd.cu")
    bwd_rep = "src/repro/kernels/flash_attention/backward.py:"
    sources = {"calibrated_update": (
        "src/repro_torch/kernels/calibrated_update/csrc/calibrated_update.cu",
        "src/repro/kernels/calibrated_update/kernel.py:60"),
        # B1 on phase 23's path, timed at its (M, P) float32 rows
        "calibrated_update_llama3_train": (
        "src/repro_torch/kernels/calibrated_update/csrc/calibrated_update.cu",
        "src/repro/kernels/calibrated_update/kernel.py:60"),
        "calibrated_update_prox": (
        "src/repro_torch/kernels/calibrated_update/csrc/calibrated_update.cu",
        "src/repro/kernels/calibrated_update/kernel.py:83"),
        "quantize_2d": (quantize_src,
                        "src/repro/kernels/quantize/kernel.py:72"),
        "dequantize_2d": (quantize_src,
                          "src/repro/kernels/quantize/kernel.py:94"),
        "topk_mask_2d": (quantize_src,
                         "src/repro/kernels/quantize/kernel.py:117"),
        "flash_attention_fwd": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:113"),
        "flash_attention_bwd_dq": (bwd_src, bwd_rep + "150"),
        "flash_attention_bwd_dkv": (bwd_src, bwd_rep + "178"),
        # the bfloat16 instances on phase 16's training path, timed at its
        # step's shape
        "flash_attention_fwd_bf16": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:113"),
        "flash_attention_bwd_dq_bf16": (bwd_src, bwd_rep + "150"),
        "flash_attention_bwd_dkv_bf16": (bwd_src, bwd_rep + "178"),
        # the bfloat16 instances on phases 19's, 20's and 22's serving paths,
        # each
        # timed at its model's largest prefill (ATTN_SERVE_SHAPES)
        **{f"flash_attention_fwd_{name}": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:113")
           for name in ATTN_SERVE_SHAPES},
        # the instances on phase 21's training paths, each timed at its
        # model's local step (ATTN_TRAIN_SHAPES, ATTN_BWD_TRAIN)
        **{f"flash_attention_fwd_{name}": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:113")
           for name in ATTN_TRAIN_SHAPES},
        **{f"flash_attention_bwd_{part}_{name}": (
            bwd_src, bwd_rep + ("150" if part == "dq" else "178"))
           for name in ATTN_BWD_TRAIN for part in ("dq", "dkv")},
        "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:88"),
        # no Pallas site: the reference differentiates ssd_chunked with
        # autodiff
        **{name: ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
                  "src/repro/models/mamba2.py:74")
           for name in ("ssd_bwd_dstate", "ssd_bwd_chain", "ssd_bwd_chunk",
                        "ssd_bwd_reduce")}}
    _emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **timings[name]}
        for name, (src, rep) in sources.items()]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
