#!/usr/bin/env python3
"""Chip smoke check of the PyTorch/CUDA port (``repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

  1. card    — the card's name and power limit (nvidia-smi), torch/CUDA
               versions;
  2. build   — builds every CUDA kernel from ``src/repro_torch/kernels/
               csrc`` (one nvcc per source, in parallel); ptxas's register
               and spill lines; each instantiation of the bf16 flash
               kernel with its HMMA count from ``cuobjdump -sass`` of the
               built library (it must run on the tensor cores) and its
               spill bytes (none allowed at D <= 128); likewise the bf16
               ssd_scan passes (HMMA in all 12 instantiations of the two
               product passes, no spill in any of the 14 kernels); the
               resident node_fused_iter kernel's (its fused and its
               gradient form) and the streaming Gram kernel's registers
               and spills at each dtype and rank capacity (none allowed
               at capacity 4, the main path's);
               then the launch floor: an empty kernel
               (torch.cuda._sleep(0)) timed back to back as the kernels
               are;
  3. kernels — each kernel against its plain PyTorch version on the same
               inputs on the card, at the paper's Experiment 1 shape (the
               main path's), its sample-split fold (path A's Gram), the
               Experiment 2 shape, a ragged shape and tasks past the
               shared-memory budget of the resident node_fused_iter
               kernel (which run its two-pass kernel: each call's kernel
               as the C entry reports it, in ``_build.KERNEL_LAUNCHES``;
               mix_rows's and node_task_gram's kernels);
               f32 and bf16 inputs, plus f64 through the engine op; the
               reference tolerances (rtol = atol = 1e-4 at f32, 5e-2 at
               bf16); kernel, plain and library times (median of CUDA-
               event-timed launch batches) beside the card's bound, and
               node_fused_iter's time with one and with two CTAs a task
               forced (each also held to the plain version), at each
               shape and dtype, beside the kernel's pick;
 3b. lint    — the static checks' launch budgets (JX001) on the card:
               ``repro_torch.analysis.harness`` runs all twelve programs
               on the simulator at f32 at its tiny shape (L 8, d 16,
               r 2, T_con 2) with NO recording context, so the real
               kernels launch, at T_GD 1 and 2 (LINT_LENGTHS: the
               difference is one iteration), then the same on the CPU
               inside ``_build.recording()``; then the virtual tier,
               both devices, in one spawn of 8 gloo ranks on the card
               (L 24, block 3), forked from a forkserver started before
               the kernels' build (``harness.warm_ranks``), so its
               imports of torch and the port run beside the build and
               not in this phase.  The CPU runs
               record counts only: no op recorder, whose shapes and
               dtypes JX002 / JX003 read on the CPU, not here.  Each
               case's ``_build.LAUNCHES`` an iteration and outside the
               loop on the card, beside the CPU
               recording's and the program's DispatchBudget, by kernel;
               the virtual tier's sends beside R·K·wire_virtual; any
               disagreement fails the run.  The phase's seconds (at
               most LINT_MAX_S);
  4. main    — ``run_experiment`` on the EXPERIMENT1 preset (T_con=10,
               L=20, d=T=600, r=4, n=30, ER p=0.5 Metropolis, T_pm=30,
               T_GD=500) at float32 on the cuda backend, with the launch
               counts set to 0 just before and read just after (every
               node_fused_iter launch the resident kernel, every mix_rows
               launch the one-tile kernel, the Gram on one CTA a task);
               then the
               same spec and key on the torch-ref backend on the card,
               whose sd_max trace must agree (rtol 1e-4, atol 1e-5);
  5. profile — torch.profiler over 20 outer iterations: device time by
               kernel and the device's busy share;
  6. slice kernels — node_task_grad_tiles against its plain version at
               the sample-split fold of Experiment 1 (n = 15), Experiment
               2 and the ragged shape, f32 and bf16 (the tolerances
               above), through the resident gradient form (as its C
               entry reports), the same bits on one and two CTAs a task
               forced, f64 through ops.altgdmin_node_gradient;
               compress_topk and dequant against theirs BIT FOR BIT at
               (20, 600, 4), (100, 100, 10), (3, 97, 3) and the sparse
               tier's (100 000, 16, 2), tied rows included, and
               compress_topk on blocks with NaN rows (fewer
               and more non-NaN rows than k), +inf rows and all rows
               equal at (20, 600, 4) and (3, 97, 3), k = d/2 and d (NaN
               compared by its bits); the int8 round (int8_round, both
               wires) against ref_int8_round BIT FOR BIT at ROUND_SHAPES,
               f32 and bf16, with a zero, a NaN and an inf block; times
               as in phase 3, node_task_grad_tiles' also at one and two
               CTAs a task and in bf16, the round's beside the plain
               round's device time at each f32 shape, with
               torch.mul(q, scale) as dequant's library call;
  7. path A — the same preset sample-split into two folds (n_folds=2),
               T_GD=500, cuda: launches node_task_gram 501,
               node_task_grad_tiles 500, mix_rows 500, node_fused_iter 0,
               and the CUDA launches by kernel as their C entries report
               them (the gradient's resident form 500 times); sd_max against torch-ref on the card (rtol 1e-4, atol
               1e-5); convergence; a profile of 20 iterations;
  8. path B — dif_topk (compression_k=150, and =d), dif_quantized
               (int8) and dif_event (event_threshold=0.02) on the same
               preset cut to T_GD=PATH_B_T_GD (250), T_con=10, cuda:
               compress_topk / dequant
               / mix_rows at 10·T_GD launches (by kernel as in path A;
               dif_quantized's dequant launches are int8_round_kernel,
               the whole round);
               finite outputs; sd_max
               below 0.65 / 0.5 / 0.6 of its first value (the
               reference's bounds); against torch-ref on the card over
               the whole trajectory (top-k at k=d, int8, event), or, for
               top-k at k=150, whose row selection round-off can flip
               (see PATH_B), reported over the first 50 iterations with
               the first parting iteration and held at the final sd_max
               (within 10 %); a profile of 20 iterations each, with
               its device operations, device ms and host ms an
               iteration;
  9. masked — the dropout-tolerant trio dif_partial / dif_stale /
               dif_pushsum on the same preset cut to T_GD=MASKED_T_GD
               (100), cuda, always-on
               (SystemSpec()) and under 30 % bernoulli dropout
               (MASKED_DROPOUT, the reference's DROP30): node_fused_iter
               T_GD and mix_rows T_con·T_GD launches (2·T_con·T_GD for
               push-sum, whose weight column rides every round), each
               program's DispatchBudget a iteration; sd_max against
               torch-ref on the card over the whole trajectory (rtol
               1e-4, atol 1e-5); always-on dif_partial's torch-ref trace
               and iterate equal to dense dif_altgdmin's bit for bit;
               under dropout sd_max[-1] < 0.2·sd_max[0]; a strictly
               increasing simulated time axis; a profile of 20
               iterations each;
 10. gossip kernels — gossip_combine against ref_gossip_combine at the
               mesh round's shape (n = d·r = 2400, K = 2 and K = 19), the
               roll form's (n = 20·600·4, K = 2), a ragged n and bf16,
               with the weights as Python floats and as a device tensor;
               f32 rtol = atol = 1e-6 (the reference's kernel tolerance),
               bf16 5e-2, and bit for bit; bit for bit also at K = 130
               (past one shared-memory stage, f32 and bf16), K = 40 and
               a z one element past an aligned base; each through the
               form its C entry reports (combine_regs_kernel for K+1 <=
               8, combine_tile_kernel, or combine_tile_kernel/staged past
               64 rows); times as in
               phase 3, with torch.addmv as the library call;
 11. roll   — roll_gossip at Experiment 1 width (Z (20, 600, 4), ring
               (−1, 1), T_con = 10) through the kernel, against torch-ref
               on the card and against stacked_product with the circulant
               W;
 12. mesh   — L = 20 ranks on the one card, spawned once over gloo
               (staged through host memory), each running the EXPERIMENT1
               preset through run_experiment(substrate="mesh") for all
               twelve programs: the six stateless ones (T_GD =
               MESH_T_GD, dif_altgdmin MESH_DECAY_T_GD), then
               MESH_STATE_SOLVERS (T_GD =
               MESH_STATE_T_GD, a cut made for time): dif_topk (k = 150),
               dif_quantized (int8) and dif_event (θ = 0.02) as in path
               B, and the masked trio under MASKED_DROPOUT; every rank's
               result equal to rank 0's; rank 0's sd_max trace and final
               U_nodes and B_nodes against the port's simulator on the
               card under the same schedule (MESH_TOL: rtol 1e-4, atol
               1e-5), dif_topk at k = 150 as in path B (agreement with
               its first parting iteration, the final sd_max within
               10 %); dif_altgdmin's geometric decay, and sd_max falling
               for the six new ones; each rank's launches by wrapper
               (node_fused_iter, gossip_combine, compress_topk, dequant)
               against the program's DispatchBudget, its CUDA launches
               (gossip_combine's form; dif_quantized's int8_round_kernel
               once a round and dequant_kernel once a round a shift) and
               its point-to-point sends against R·K·wire_mesh; ms per
               iteration labelled with the transport, staging and wire ms
               and sends per iteration;
 12b. virtual_mesh — the same twelve programs on the virtual-node tier:
               VIRTUAL_RANKS = 4 gloo ranks on the one card, each holding
               a block of 5 nodes (cross-rank classes (−1, 1, 2) of the
               preset's W), in one spawn (VIRTUAL_TIMEOUT): dif_altgdmin
               at the preset's T_GD = 500, the other stateless ones at
               MESH_T_GD, the compressed and masked trios at
               MESH_STATE_T_GD; held as in phase 12 (every rank equal to
               rank 0, MESH_TOL against the simulator on the card,
               dif_topk at k = 150 as in path B, dif_altgdmin's
               convergence over the whole run), each rank's launches by
               wrapper and CUDA kernel against the virtual
               DispatchBudget (node_fused_iter once an iteration over the
               block, compress_topk / int8_round_kernel once a round, no
               gossip_combine, mix_rows or dequant_kernel, nothing else)
               and its sends against R·K·wire_virtual; each program's
               line carries phase 12's ms, staging and wire ms, sends an
               iteration and spawn seconds beside its own;
 12c. sparse — the sparse consensus tier at the reference's scale
               configuration (benchmarks/scale_bench.py:49-58; SPARSE_L
               = 100 000 nodes and tasks on a Barabási–Albert graph, m =
               3, Metropolis weights in sparse form, d = 16, r = 2, n =
               8, T_con = 3, η = 1e-4; T_GD cut from 3 to SPARSE_T_GD
               for time) at f32 on the
               simulator: materialized once on the card (its seconds; the
               edges, the stored and padded entries, whether W^{T_con}
               declined its fill budget); node_fused_iter and
               node_task_gram against their plain versions at its shape
               (100 000 tasks, n = 8, d = 16, r = 2) with their times and
               bounds; one program of each rule family (SPARSE_FULL_L,
               cut from the twelve for time) on cuda with
               their launches the dense simulator's less every mix_rows
               and gossip_combine launch (sparse_budget), each against
               torch-ref on the same materialization (sd_max at rtol
               1e-4, atol 1e-5, and U_nodes at MESH_TOL but for the int8
               and event rules; dif_topk at its final value within 10 %);
               dif_altgdmin's ms an iteration on each backend (no
               second run: nothing compiles and the materialization
               warmed every operand) and, under --sparse-tier only (the
               profiler takes 40-50 s of its own over the run's 900 000
               device events), a profiled run (device ms,
               device operations and host ms an iteration, busy share,
               top device ops); the phase's peak device memory under
               SPARSE_MEM_LIMIT;
 12d. sparse_auto — the reference's L = 1024 test graph (ER p = 6/L,
               seed 5, d = 8, r = 2, n = 10) under representation="auto",
               which must take the sparse tier; every program at
               SPARSE_AUTO_T_GD on cuda against the same spec with
               representation="dense", the launches of sparse_budget on
               both;
 12e. sparse_virtual — the scale configuration on SPARSE_VIRTUAL_RANKS
               gloo ranks on the one card (a block of 25 000 nodes a
               rank), every rank starting from phase 12c's
               materialization carried across as host arrays:
               dif_altgdmin, exact_diffusion, dif_topk (k = 4)
               and dif_partial under MASKED_DROPOUT, held as phase 12b
               holds its programs (MESH_TOL against the simulator on the
               sparse phase's materialization, dif_topk at its final
               value, the virtual DispatchBudget, R·K·wire_virtual sends
               of a 3.2 MB block each), without its convergence checks;
 13. serving kernels — task_gram and task_grad_tiles (one basis shared by
               T tasks) against their plain versions at the serving
               phase's cohort (T = 64, n = 16, d = 600, r = 4), a serving
               batch (T = 32), the JAX package's kernel benchmark row
               (T = 32, n = 30), a ragged shape (T = 3, n = 20, d = 100,
               r = 8), f32 and bf16 (the tolerances of phase 3), task_gram's
               and task_grad_tiles' kernels as their C entries report
               them, task_grad_tiles' time at one and two CTAs a task
               forced;
               ops.altgdmin_minimize_B / altgdmin_gradient against their
               plain route at f32 and f64; times as in phase 3 (no
               single PyTorch call computes either);
 14. serving — the serving path on the card, with the launch counts set
               to 0 just before and read just after: run_experiment on
               the EXPERIMENT1 preset with checkpoint_every=100 (its
               traces and final U_nodes equal the main phase's
               unsegmented run bit for bit; steps 0, 100, ..., 500
               published); a fixed cohort of 64 noiseless requests served
               from every published U through HotSwapSource and
               ServingEngine (one node_task_gram launch a batch), whose
               mean θ error falls at every step until it reaches the f32
               floor (SERVE_ERR_FLOOR), stays within 2× of its least
               value from there on, and ends below 0.75× step 0's;
               at each step the cohort's least-squares heads and its
               gradient at the served U through ops.altgdmin_minimize_B
               (task_gram) and ops.altgdmin_gradient (task_grad_tiles),
               the first against the engine's B as a consistency check
               (both launch the same kernel body; rtol 1e-4, atol 1e-5),
               the gradient against its plain route (phase 3's f32
               tolerance) and falling below a tenth of step 0's by the
               final step; a closed loop of 800
               ragged requests (T_new from 8, 16, 32; max_batch 32) at
               70 % of the measured ragged-batch capacity, max_wait 4×
               its batch time, the swap source polled: every request
               served or shed once, one node_task_gram launch a batch,
               requests/s, p50/p99 latency, sheds, mean batch.  Then,
               outside the counted run, the packed-solve frontier: µs per
               dispatch and per request at batch 1, 8, 32 on cuda and
               torch-ref.

 15. lm_kernels — flash_attention and ssd_scan against their plain
               versions (ref_attention, ref_ssd) on the card at f32 and
               bf16 within the reference's tolerances (tests/
               test_kernels.py: 2e-5 / 2e-2 and 1e-4 / 5e-2): flash at
               qwen3-1.7b's prefill (B 4, S 2048, H 16, Hkv 8, D 128),
               the same with window 512, a ragged S = 1000, cross lengths
               Sq 16 / Skv 2048 and D = 112; ssd_scan at mamba2-130m's
               (B 4, S 2048, H 24, P 64, N 128, Q 128) and S = 1000, y
               and h_final; flash also at deepseek-v3's MLA prefill (B 4,
               S 2048, 128 heads, D 192, the scale (dn + dr)^-1/2 passed)
               and at the prefills of the four presets phase 17b adds
               (granite-20b MQA 48/1, command-r-35b 64/8, phi4-mini-3.8b
               24/8, all D 128; musicgen-medium MHA 24/24 at D 64), these
               timed at bf16; times as in phase 3 at both dtypes, with
               scaled_dot_product_attention (is_causal, enable_gqa) as
               flash's library call, timed only (ssd_scan has none);
               each kernel's worst error at bf16 (the tensor-core
               kernels) beside f32's (the CUDA-core ones);
 16. lm_dense — qwen3-1.7b at full width, weights drawn on the card from
               a seed: make_prefill_step on B 4 × S 2048 at f32 through
               the kernel, with the launch counts set to 0 just before
               and read just after (28 flash_attention launches), its
               last-position logits within 2e-3 of the torch-ref route on
               the card (tests/test_arch_smoke.py's cross-route
               tolerance); generate_tokens with B 4, prompt 128, gen 32,
               whose teacher-forced decode logits at every prompt
               position are within 2e-3 of the kernel-route forward;
               then at bf16 (linear weights cast once): the last-position
               logits through the kernel against the bf16 torch-ref
               route (relative L2 within LM_BF16_REL_L2, which must
               reject the planted faults of LM_BF16_CAUGHT; each fault's
               reading is printed), the error against f32, prefill
               tokens/s, decode ms a token, and the device's busy share
               over a profiled prefill step and 16 decode steps;
 17. lm_ssm  — the same for mamba2-130m: 24 ssd_scan launches a forward,
               decode through the O(1) step ≡ prefill; the bf16 prefill
               step's CUDA launches by kernel (``KERNEL_LAUNCHES``: the
               three tensor-core passes 24 times each); its bf16 route
               check against LM_SSM_BF16_REL_L2 with the faults of
               LM_SSM_BF16_CAUGHT planted through ssd_scan's inputs.
 17b. lm_plans — the same for the plans past the scan stacks, each at
               its published widths (LM_PLANS): zamba2-7b whole (81 SSM
               layers, the shared attention block after each group of 6:
               81 ssd_scan and 13 flash_attention launches a prefill
               step), llava-next-mistral-7b whole at B 1 x S 8192 (2880
               patch embeddings from the stub frontend, then 5312 text
               tokens, past its 4096-token window: 32), deepseek-v3 cut to
               its 3 dense layers and first MoE layer (MLA at D 192, 256
               experts top-8 and the shared expert: 4) and arctic cut to 1
               layer (128 experts top-2 and the dense residual: 1); then
               phi4-mini-3.8b whole (GQA 24/8, tied embeddings: 32),
               musicgen-medium whole (MHA at D 64, the audio stub's token
               stream: 48), granite-20b cut to 26 of 52 layers (MQA 48/1:
               26) and command-r-35b to 16 of 40 (the parallel block: 16),
               all at B 4 x S 2048, the cuts set by the f32 tree built
               before the serving copy.  The
               f32 checks on the first LM_PLANS_F32_ROWS rows (the kernel
               route against torch-ref, the logits and the MoE aux loss
               within LM_TOL; decode on LM_PLANS_GEN against the forward,
               a MoE's at capacity factor E / top_k), then the serving
               copy cast to bf16 in place a leaf at a time (two copies
               of a MoE cut would not fit): the prefill step on the whole
               batch with its launches by wrapper and by __global__
               function, its route against bf16 torch-ref (zamba2 within
               LM_SSM_BF16_REL_L2, the rest LM_BF16_REL_L2), each kernel
               against its plain version at the model's own shape, each
               planted fault caught by the route or by that kernel check
               (the route's reading taken only where the kernel check
               misses the fault; at one KV head, granite's, the KV-head
               reversal is no fault and is not planted, which the line
               says), tokens/s, decode ms, profiles of
               LM_PLANS_DECODE_PROFILE decode steps, and the peak device
               memory under the card's.
 18. train   — launch.train's trainer at full width on the card (its
               parts, make_trainer, then launch.train.train itself for 2
               steps on qwen3-1.7b), TRAIN_CASES: mamba2-130m (24
               layers) and qwen3-1.7b cut to 4 of 28 layers, 4 nodes, a
               per-node batch of 2 x 1024 tokens; zamba2-7b cut to 6 of
               81 layers (one group: ssd_scan and flash both under
               autograd), 2 nodes x 2 x 1024; llava-next-mistral-7b cut
               to 1 of 32 layers, 4 nodes x 1 x 4096 (2880 patch rows,
               then 1216 text tokens); bf16 activations, remat "all",
               diffusion with
               t_con 1, the embedding and LM head node-local, AdamW on a
               warmup-cosine schedule.  The first step's gradients on
               the kernel route (flash_attention / ssd_scan under
               autograd: the kernel forward, the plain core's backward)
               against torch-ref leaf by leaf within the model's bf16
               relative L2 bound (LM_SSM_BF16_REL_L2 where ssd_scan runs,
               else LM_BF16_REL_L2),
               every leaf's gradient nonzero and finite on every node;
               1 warm + 4 timed steps on each route from the same
               weights and batches, losses within TRAIN_LOSS_RTOL, the
               launches of every step held to the count derived from the
               config and strategy (each LM kernel's launches of a
               forward a node, x 2 under remat, gossip_combine one a
               communicated leaf a round), which the dry run's count
               (launch.dryrun on a (1, 1) mesh) must equal, ms a step
               (host clock ended by a synchronize), tokens/s, peak
               device memory beside the dry run's prediction and one
               profiled step's device ms and busy share; 2 steps at f32
               activations on both routes within LM_TOL; for mamba2-130m
               cut to
               TRAIN_STRATEGY_LAYERS layers the other six strategies, 2
               steps each on both routes: allreduce keeps
               the communicated leaves equal on every node, local lets
               them part, and after one step every strategy's node-local
               leaves are the local strategy's.  Then the MoE plans'
               backward at smoke width (TRAIN_MOE_SMOKE: arctic-480b,
               deepseek-v3-671b; their full-width trainer state fits no
               card): the first losses and gradients through the kernels
               against torch-ref within TRAIN_MOE_TOL, the gradient
               nonzero on every node at every leaf and every expert, the
               aux loss's own gradient nonzero at every router, and
               TRAIN_MOE_STEPS diffusion steps with the derived launches.
 19. examples — the six port examples (EXAMPLES, ``examples/*_torch.py``)
               at their default sizes on the card, each imported by path
               and its main called in this process (the mesh example's
               ranks forked from the warm forkserver), with the launch
               counts set to 0 just before and read just after: each
               one's seconds and key line; quickstart's Dif-AltGDmin
               final SD within EXAMPLE_SD_RATIO of the centralized run's
               and DGD's above EXAMPLE_DGD_FLOOR; distributed_mtrl's 8
               gloo ranks on the card within EXAMPLE_MESH_TOL of the
               simulator at f64; train_lm's loss falling and its
               checkpoint round trip bit for bit; serve_personalize's θ
               error falling over the checkpoints; serve_decode's prefill
               step within LM_TOL of its decode; every kernel of
               EXAMPLE_KERNELS launched.
 20. dryrun  — ``repro_torch.launch.dryrun`` on a (1, 1) mesh, its
               prediction for qwen3-1.7b's bf16 prefill at B 4 x S 2048
               and phase 18's qwen3-1.7b train step (4 layers, 4 nodes x
               2 x 1024) against the real step on the card: argument
               bytes exactly the tensors' bytes, the peak within
               DRYRUN_PEAK_RTOL of max_memory_allocated (from a
               reset_peak_memory_stats() taken with the arguments in
               place, less what other phases hold), the launches equal;
               the step's ms beside the prediction's roofline terms.

Then the kernels line (each kernel's launches from its own path's run;
flash's and ssd_scan's rows are their bf16 tensor-core kernels,
``dtype`` bfloat16, with the f32 CUDA-core kernel's error as
``max_abs_err_f32_kernel``; ssd_scan's also carries the CUDA launches a
call of the bf16 prefill step, counted by kernel, and the f32 kernel's
ms; node_fused_iter's its times at one and two CTAs a task,
node_task_gram's at path A's fold, task_gram's at each serving shape;
node_task_grad_tiles' and task_grad_tiles' their resident form and
times at one and two CTAs a task; mix_rows' also the masked phase's
launches; gossip_combine's its form and its time at every f32 case;
dequant's the int8 round's, the
kernel dif_quantized launches, with the standalone dequant_kernel's
beside it; compress_topk's and dequant's rank-0 launches on the mesh,
node_fused_iter's, node_task_gram's, compress_topk's and dequant's
launches on the sparse tier (``launches_sparse``), node_fused_iter's and
node_task_gram's times and bounds at its shape (``sparse_shape``),
gossip_combine's per mesh program; flash_attention's, ssd_scan's and
gossip_combine's launches a train step by model
(``launches_train_per_step``, phase 18); every kernel's launches over
the six examples
(``launches_examples``, phase 19); flash_attention's and ssd_scan's
launches a prefill step of
each plan of phase 17b (``launches_lm_plans``), flash's time at the MLA
shape (``mla_shape``) and at the four new presets' prefill shapes
(``lm_plans_shapes``), ssd_scan's CUDA launches in zamba2's step; the
launch floor beside mix_rows,
compress_topk, dequant and gossip_combine), the card line, and the
result line.  Exits non-zero,
printing no result, without a CUDA device or outside the repo.

    python3 chip_smoke.py --lint

builds the kernels and runs phase 3b only, then prints each case's
launches an iteration on the card.

    python3 chip_smoke.py --lm-plans --train

builds the kernels and runs phase 17b (``--lm-plans``) and phase 18
(``--train``), either alone or both, then prints each plan's launches
of a bf16 prefill step by wrapper and by __global__ function and the
train launches a step by kernel and model.

    python3 chip_smoke.py --examples --dryrun

builds the kernels and runs phase 20 (``--dryrun``) and phase 19
(``--examples``), either alone or both, then prints the dry run's
readings and the examples' launches by kernel.

    python3 chip_smoke.py --sparse-tier

builds the kernels and runs phases 12c-12e only, printing their lines,
with all twelve programs at L = 100 000 in phase 12c (no cut for time).

    python3 chip_smoke.py --kernel-times [--src DIR] [--label NAME]

runs none of the phases: it imports ``repro_torch`` from ``DIR``
(default: this checkout's ``src``), builds its least-squares, mixing,
compression and flash kernels there, and prints one JSON line: the card's name and
power limit, and the device ms (device_ms) of the bf16 flash kernel at
each LM prefill shape of phase 15 that it times at bf16 (beside
scaled_dot_product_attention's ms and the bound of its operations),
of ``mix_rows`` at Experiment
1's AGREE operand and tests/test_torch_gpu.py's other shapes, of
``node_task_gram`` at SHAPES, of ``task_gram`` and ``task_grad_tiles``
at SINGLE_SHAPES, of ``node_task_grad_tiles`` at GRAD_TIME_SHAPES, of
the int8 wire's round as the tree's ``refresh`` runs it on cuda at
ROUND_SHAPES (f32 and bf16), of ``node_fused_iter`` at Experiment 1,
``dequant`` at (20, 600, 4) (f32) and ``gossip_combine`` at every case
of COMBINE_CASES, of the gradient kernel with one and
two CTAs a task forced at path A's fold and the serving cohort (where
the tree has that knob), and of an empty kernel (the launch floor); and
a profile of 20 iterations of ``dif_quantized`` (int8) at Experiment 1:
device operations, device ms and host ms an iteration.  Only the wrappers' common
signatures are called, so an older tree of the port (its ``src`` from
``git archive``) can be timed by this script too: run parent, change,
change, parent on one card, one process each.

    python3 chip_smoke.py --grad-oracle [--src DIR] [--label NAME]

likewise runs none of the phases: it builds the least-squares kernels of
the port in ``DIR`` and prints one JSON line holding
``node_task_grad_tiles`` and its plain version (ref_node_grad_tiles, f32
on the card) each against an f64 oracle of the same inputs, f32: at the
two-pass kernel's tasks (GRAD_ORACLE_SHAPES, n = 200 and 400,
GRAD_ORACLE_DRAWS seeded B draws) and over a seeded sweep of B at every
f32 case of tests/test_torch_gpu.py's two gradient tests
(GRAD_SWEEP_CASES): per case the worst error of each against the oracle,
and the worst reading of |kernel − plain| against the tests' tolerance
with its draw and the two errors of that draw.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"


def _load_file(name: str, path: Path):
    """The module of ``path``, imported under ``name`` without importing
    its package."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit): HBM
# bandwidth, float32 outside the tensor cores (the kernels' f32 FMAs) and
# dense bf16 on the tensor cores.  One source, repro_torch.launch.mesh,
# read from this checkout's file (it imports nothing but the standard
# library), so that --src may name another tree.
_H100 = _load_file("_repro_torch_launch_mesh",
                   SRC / "repro_torch" / "launch" / "mesh.py")
HBM_BYTES_PER_S = _H100.HBM_BW
F32_FLOP_PER_S = _H100.PEAK_FLOPS_F32
BF16_FLOP_PER_S = _H100.PEAK_FLOPS_BF16

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2),
       "float64": dict(rtol=1e-4, atol=1e-4)}     # the kernels compute in f32

# (L, tpn, n, d, r): Experiment 1 (the main path's shape), its
# sample-split fold (path A's node_task_gram, n = 15), Experiment 2, a
# ragged shape (d not a multiple of 32, r odd), and tasks past the
# shared-memory budget of the resident node_fused_iter kernel at both
# dtypes (half of X_t's 400 x 600 columns: 486 KB in f32, 243 KB in bf16,
# above a CTA's 227 KB), which run the two-pass kernel.
SHAPES = {"exp1": (20, 30, 30, 600, 4), "exp1_fold": (20, 30, 15, 600, 4),
          "exp2": (100, 1, 50, 100, 10), "ragged": (3, 5, 20, 97, 3),
          "past_budget": (2, 2, 400, 600, 4)}

SOURCES = {"node_fused_iter": "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "node_task_gram": "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "mix_rows": "src/repro_torch/kernels/csrc/gossip_axpy.cu",
           "node_task_grad_tiles":
               "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "compress_topk": "src/repro_torch/kernels/csrc/compress.cu",
           "dequant": "src/repro_torch/kernels/csrc/compress.cu",
           "gossip_combine": "src/repro_torch/kernels/csrc/gossip_axpy.cu",
           "task_gram": "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "task_grad_tiles": "src/repro_torch/kernels/csrc/altgdmin_ls.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
REPLACES = {"node_fused_iter": "src/repro/kernels/altgdmin_ls.py:244",
            "node_task_gram": "src/repro/kernels/altgdmin_ls.py:306",
            "mix_rows": "src/repro/kernels/gossip_axpy.py:45",
            "node_task_grad_tiles": "src/repro/kernels/altgdmin_ls.py:375",
            "compress_topk": "src/repro/kernels/compress.py:64",
            "dequant": "src/repro/kernels/compress.py:89",
            "gossip_combine": "src/repro/kernels/gossip_axpy.py:73",
            "task_gram": "src/repro/kernels/altgdmin_ls.py:67",
            "task_grad_tiles": "src/repro/kernels/altgdmin_ls.py:139",
            "flash_attention": "src/repro/kernels/flash_attention.py:111",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:87"}

# The sample-split fold of Experiment 1 (n = 30 split in two), and the
# (N, d, r, k) blocks of compress_topk: the dif_topk path's (k = d/4),
# Experiment 2's, a ragged one at the two ends of k, and the sparse
# tier's (the scale configuration's 100 000 nodes at k = d/4).
GRAD_SHAPES = {"exp1_fold": SHAPES["exp1_fold"], "exp2": SHAPES["exp2"],
               "ragged": SHAPES["ragged"]}
TOPK_SHAPES = {"exp1": (20, 600, 4, 150), "exp2": (100, 100, 10, 25),
               "ragged_k1": (3, 97, 3, 1), "ragged_kd": (3, 97, 3, 97),
               "sparse": (100_000, 16, 2, 4)}
# compress_topk's blocks with NaN, +inf and all-equal norms, at the
# dif_topk path's shape and the ragged one
TOPK_SPECIAL_SHAPES = ("exp1", "ragged_k1")
# (N, d, r) of the int8 round: the dif_quantized path's (Experiment 1),
# L = 100 at d = 1000, a ragged d at r = 16, a node past what one CTA
# holds (a cluster of 8 CTAs, each reading its share twice), and the
# sparse tier's block (the scale configuration's 100 000 nodes)
ROUND_SHAPES = {"exp1": (20, 600, 4), "l100": (100, 1000, 4),
                "ragged": (3, 291, 16), "past_cta": (3, 8192, 16),
                "sparse": (100_000, 16, 2)}
ROUND_WIRES = ("int8", "int8_stochastic")


# gossip_combine's (name, n, K, dtype, weights): the mesh round at
# Experiment 1 (n = d·r; K = 2 on a ring, 19 at ER p = 0.5), the roll
# form's operand (n = L·d·r, a ring), a ragged n, bf16.
COMBINE_CASES = (("mesh_K2", 2400, 2, "float32", "floats"),
                 ("mesh_K19", 2400, 19, "float32", "tensor"),
                 ("mesh_K19_floats", 2400, 19, "float32", "floats"),
                 ("roll_K2", 48000, 2, "float32", "floats"),
                 ("ragged_K19", 2401, 19, "float32", "tensor"),
                 ("mesh_K19_bf16", 2400, 19, "bfloat16", "tensor"),
                 ("ragged_K2_bf16", 2401, 2, "bfloat16", "floats"))
COMBINE_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
               "bfloat16": TOL["bfloat16"]}
# Beyond COMBINE_CASES, each also held bit for bit: K past one
# shared-memory stage of the tile kernel's COMBINE_STAGE_ROWS rows (three
# staged groups; f32, and bf16 at a ragged n), a K inside one stage, and
# z one element past an aligned base (its 4-byte copies); (name, n, K,
# dtype, weights, elements z is offset by).  K+1 <= COMBINE_REG_ROWS
# takes the register form.
COMBINE_STAGE_ROWS, COMBINE_REG_ROWS = 64, 8
COMBINE_EXTRA_CASES = (("staged_K130", 2400, 130, "float32", "tensor", 0),
                       ("staged_K130_bf16", 2401, 130, "bfloat16", "floats",
                        0),
                       ("mesh_K40", 2400, 40, "float32", "tensor", 0),
                       ("offset_z_K19", 2400, 19, "float32", "tensor", 1))

# The masked phase: the dropout-tolerant trio on the dense path's
# Experiment 1 materialization, always-on and under the reference's 30 %
# bernoulli dropout (tests/test_system.py's DROP30), whose convergence
# bound is that test's: sd_max[-1] < MASKED_SHRINK · sd_max[0].
MASKED_SOLVERS = ("dif_partial", "dif_stale", "dif_pushsum")
MASKED_DROPOUT = dict(availability="bernoulli", p_on=0.7, seed=7)
MASKED_SHRINK = 0.2
# cut from the preset's 500 to make room for the train phase: sd_max
# falls 0.50 → ~1e-6 over 500 iterations under the dropout, halving about
# every 14, so 100 still checks the shrink with orders to spare
MASKED_T_GD = 100

# The mesh phase: every stateless program, its outer iterations, and
# the seconds the 20 ranks get to report.  T_GD is cut from the preset's
# 500 to 30: 20 ranks time-sharing one card take 0.16-0.54 s an
# iteration (PERF.md), so 500 iterations of the six programs would not
# fit the script's time limit; at 120 the whole script came within 83 s
# of it on a slow host, and 50 left too little room for the train phase.
# dif_altgdmin runs MESH_DECAY_T_GD: its decay is checked over two spans
# of 20 iterations (41 is the least T_GD that holds them), and over the
# preset's whole 500 iterations in the virtual_mesh phase.  The ranks of
# the three mesh phases fork from the forkserver with torch preloaded
# (spawn_ranks).
MESH_SOLVERS = ("dif_altgdmin", "dec_altgdmin", "dgd_altgdmin",
                "exact_diffusion", "beyond_central", "centralized_altgdmin")
MESH_T_GD = 30
MESH_DECAY_T_GD = 41
# The stateful and masked programs in the same spawn, with path B's knobs
# and the masked phase's dropout: (solver, knobs, system, whether rank
# 0's sd_max trace and final U_nodes and B_nodes are held to the
# simulator's over the whole run at MESH_TOL).  dif_topk at k = 150 is
# held as in path B instead (its row selection can flip on round-off:
# agreement reported with the first parting iteration, the final sd_max
# within 10 %).  Their T_GD is cut from the preset's 500 to
# MESH_STATE_T_GD for time: the wire-2 programs send twice the messages
# of the stateless ones, whose iterations take 0.37-0.54 s on 20 ranks.
# Not below 30: dif_quantized's int8 rounding parts from the simulator's
# on round-off, and its U_nodes come back within MESH_TOL only as the
# run converges (on an H100: 1.3e-5 from the simulator's at 20
# iterations, 4.5e-6 at 30).
MESH_STATE_SOLVERS = (
    ("dif_topk", {"compression_k": 150}, None, False),
    ("dif_quantized", {"compression": "int8"}, None, True),
    ("dif_event", {"event_threshold": 0.02}, None, True),
    ("dif_partial", {}, MASKED_DROPOUT, True),
    ("dif_stale", {}, MASKED_DROPOUT, True),
    ("dif_pushsum", {}, MASKED_DROPOUT, True))
MESH_STATE_T_GD = 30
MESH_TIMEOUT = 600
# The virtual_mesh phase: Experiment 1 on VIRTUAL_RANKS gloo ranks on the
# one card, a block of L / VIRTUAL_RANKS = 5 nodes a rank (cross-rank
# classes (-1, 1, 2) of its W), the same programs as the mesh phase,
# dif_altgdmin at the preset's whole T_GD = 500.
VIRTUAL_RANKS = 4
VIRTUAL_TIMEOUT = 300
# rank 0's final U_nodes and B_nodes against the simulator's on the card:
# the trajectory tolerance the sd_max traces are held to
MESH_TOL = dict(rtol=1e-4, atol=1e-5)

# The sparse tier's phases.  ``sparse`` runs the reference's own scale
# configuration (benchmarks/scale_bench.py:49-58) at f32: L = T = 100 000
# on a Barabási–Albert graph (m = 3, seed 0) with Metropolis weights in
# sparse form, d = 16, r = 2, n = 8, κ = 1.2, init T_pm = 3 / T_con = 2,
# T_con = 3, η = 1e-4 (T_GD cut below); the programs of SPARSE_FULL_L,
# each held against torch-ref on the card, with the peak device memory
# over the phase under SPARSE_MEM_LIMIT (a densified f32 W alone would be
# 40 GB).  Its masked program runs always-on: a dropout schedule's
# event-driven clock walks the graph's 600 000 directed links every round
# in host Python, which sparse_virtual pays once, for dif_partial.
SPARSE_L = 100_000
SPARSE_MEM_LIMIT = 2 * 2 ** 30
# T_GD cut from the reference's 3 to fit the script's time limit: the
# retraction's batched QR forms Q one 16 × 2 block at a time (torch's
# cuSOLVER orgqr loop, nine kernels a block), seconds a call at this L
# (PERF.md §5), and every run and its torch-ref hold pays one an
# iteration.
SPARSE_T_GD = 1
# Each program with its knobs and how it is held against torch-ref:
# "iterate" — the sd_max trace and the final U_nodes (MESH_TOL);
# "trace" — the sd_max trace (the int8 and event rules make discrete
# choices on the data, which round-off can flip for a few of the 100 000
# nodes); "final" — the final sd_max within 10 % (top-k's selection).
SPARSE_PROGRAMS = (("dif_altgdmin", {}, "iterate"),
                   ("dec_altgdmin", {}, "iterate"),
                   ("dgd_altgdmin", {}, "iterate"),
                   ("centralized_altgdmin", {}, "iterate"),
                   ("exact_diffusion", {}, "iterate"),
                   ("beyond_central", {}, "iterate"),
                   ("dif_topk", {"compression_k": 4}, "final"),
                   ("dif_quantized", {"compression": "int8"}, "trace"),
                   ("dif_event", {"event_threshold": 0.02}, "trace"),
                   ("dif_partial", {}, "iterate"),
                   ("dif_stale", {}, "iterate"),
                   ("dif_pushsum", {}, "iterate"))
# The programs the sparse phase runs at L = 100 000, cut from the twelve
# for time (T_GD already at 1): one of each rule family — gossip
# (dif_altgdmin), neighbour (dgd_altgdmin), fusion center, compressed
# (dif_topk and dif_quantized: their compress_topk and int8 round launch
# on the tier's (100 000, 16, 2) block), masked (dif_pushsum; dif_partial
# runs at this L under dropout in sparse_virtual's simulator hold).
# sparse_auto runs all twelve on the tier.
SPARSE_FULL_L = ("dif_altgdmin", "dgd_altgdmin", "centralized_altgdmin",
                 "dif_topk", "dif_quantized", "dif_pushsum")
# ``sparse_auto``: the reference's own test graph for the tier
# (tests/test_sparse.py:251-257): ER(1024, 6/L, seed 5), d = 8, r = 2,
# n = 10, under representation="auto", each program against the same
# spec with representation="dense" at SPARSE_AUTO_T_GD iterations.
SPARSE_AUTO_L, SPARSE_AUTO_T_GD = 1024, 10
# ``sparse_virtual``: the scale configuration on SPARSE_VIRTUAL_RANKS
# gloo ranks on the one card (a block of 25 000 nodes a rank; the BA
# graph links every pair of ranks, so K = 3 cross-rank classes), the
# reference bench's virtual-tier programs (scale_bench.py:160-225, top-k
# at k = 4) and dif_altgdmin, dif_partial under MASKED_DROPOUT.
SPARSE_VIRTUAL_RANKS = 4
SPARSE_VIRTUAL_TIMEOUT = 300
SPARSE_VIRTUAL_SOLVERS = (("dif_altgdmin", {}, None, True),
                          ("exact_diffusion", {}, None, True),
                          ("dif_topk", {"compression_k": 4}, None, False),
                          ("dif_partial", {}, MASKED_DROPOUT, True))

# (T, n, d, r) of the single-basis kernels: the serving phase's cohort
# at Experiment 1's width (the shape the path gives them, the kernel
# rows' timing), a serving batch of 32, the JAX package's kernel
# benchmark row (benchmarks/kernel_bench.py), a ragged d with r = 8.
SINGLE_SHAPES = {"cohort": (64, 16, 600, 4), "serving": (32, 16, 600, 4),
                 "kernel_bench": (32, 30, 600, 4), "ragged": (3, 20, 100, 8)}
# The serving phase: the publish cadence, the drifting cohort, the closed
# loop (requests, T_new mix, batch capacity, load as a share of the
# measured capacity, deadline in batch times; the reference benchmark's
# calibration, benchmarks/serving_bench.py) and the frontier's batches.
SERVE_EVERY = 100
COHORT, COHORT_T_NEW = 64, 16
LOOP_N, LOOP_T_NEW, LOOP_BATCH = 800, (8, 16, 32), 32
LOOP_LOAD, LOOP_WAIT = 0.7, 4.0
FRONTIER_BATCHES, FRONTIER_T_NEW, FRONTIER_REPS = (1, 8, 32), 16, 50
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
# The cohort's θ error at float32: noiseless requests served from an f32
# basis bottom out near 5e-7 (the trained basis's own round-off, reached
# by about iteration 200), where successive steps differ by round-off.
# The error must fall at every step until both steps are under this
# floor, and every step under it must stay within SERVE_ERR_PLATEAU× of
# the least error reached (at f64 the reference's test, and the CPU
# test, hold strict monotonicity over the whole schedule).
SERVE_ERR_FLOOR, SERVE_ERR_PLATEAU = 2e-6, 2.0

# The LM phases.  flash_attention's (name, B, Sq, Skv, H, Hkv, D, window)
# cases, qwen3-1.7b's prefill first (the kernels line's timing), and
# ssd_scan's (name, B, S, H, P, N, Q), mamba2-130m's first; the
# reference's kernel tolerances (tests/test_kernels.py); the serving
# shapes (prefill batch × length; generate's batch, prompt, gen) and the
# cross-route tolerance of tests/test_arch_smoke.py.
FLASH_CASES = (("qwen3_prefill", 4, 2048, 2048, 16, 8, 128, None),
               ("window_512", 4, 2048, 2048, 16, 8, 128, 512),
               ("ragged_1000", 4, 1000, 1000, 16, 8, 128, None),
               ("cross_16_2048", 4, 16, 2048, 16, 8, 128, None),
               ("d112", 2, 1024, 1024, 32, 32, 112, None),
               ("mla_prefill", 4, 2048, 2048, 128, 128, 192, None),
               ("granite_prefill", 4, 2048, 2048, 48, 1, 128, None),
               ("command_r_prefill", 4, 2048, 2048, 64, 8, 128, None),
               ("phi4_prefill", 4, 2048, 2048, 24, 8, 128, None),
               ("musicgen_prefill", 4, 2048, 2048, 24, 24, 64, None))
# the cases timed at each dtype; deepseek-v3's MLA prefill (D = dn + dr
# = 192, V padded from 128, scale (dn + dr)^-1/2 passed explicitly) and
# the prefills of the four lm_plans presets (granite-20b MQA 48/1,
# command-r-35b GQA 64/8, phi4-mini-3.8b GQA 24/8, musicgen-medium MHA
# at D 64) at bf16 only, the plain version timed over 3 single calls
# (up to 8.6 GB of scores a call)
FLASH_TIMED = {"qwen3_prefill": ("float32", "bfloat16"),
               "window_512": ("float32", "bfloat16"),
               "mla_prefill": ("bfloat16",),
               "granite_prefill": ("bfloat16",),
               "command_r_prefill": ("bfloat16",),
               "phi4_prefill": ("bfloat16",),
               "musicgen_prefill": ("bfloat16",)}
FLASH_SCALE = {"mla_prefill": 192 ** -0.5}
SSD_CASES = (("mamba2_prefill", 4, 2048, 24, 64, 128, 128),
             ("ragged_1000", 4, 1000, 24, 64, 128, 128))
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
LM_PREFILL = (4, 2048)
LM_GEN = (4, 128, 32)
LM_TOL = dict(rtol=2e-3, atol=2e-3)
# qwen3-1.7b's bf16 last-position logits through the flash kernel
# against the bf16 torch-ref route, as a relative L2 error (scale-free).
# On the H100 the route reads 0.016 and the faults planted by
# flash_fault_readings 0.29 (one key ahead) to 1.40 (KV heads reversed):
# the limit, 3x the route and a sixth of the nearest fault, lies between,
# and every run checks that it still rejects each planted fault.
LM_BF16_REL_L2 = 0.05
LM_BF16_CAUGHT = ("diagonal_hidden", "one_key_ahead", "kv_heads_reversed",
                  "scale_without_log2e")
# mamba2-130m's, through the three-pass ssd_scan kernels, likewise.  On
# the H100 the route reads 0.032 and the faults planted by
# ssd_fault_readings 0.62 (A halved) to 1.39 (heads reversed): the limit,
# 3x the route and a sixth of the nearest fault, lies between, and every
# run checks that it still rejects each planted fault.
LM_SSM_BF16_REL_L2 = 0.10
LM_SSM_BF16_CAUGHT = ("bc_one_token_ahead", "a_halved", "d_dropped",
                      "heads_reversed")
LM_BF16_ROUTE = {"flash_attention": (LM_BF16_REL_L2, LM_BF16_CAUGHT),
                 "ssd_scan": (LM_SSM_BF16_REL_L2, LM_SSM_BF16_CAUGHT)}
# The __global__ functions a bf16 call of each LM kernel launches, as its
# C entry reports them (flash's reports none: one kernel a call)
LM_BF16_KERNELS = {"flash_attention": (),
                   "ssd_scan": ("chunk_state_kernel", "state_pass_kernel",
                                "chunk_out_kernel")}
LM_DECODE_PROFILE = 16
# Phase 17b, lm_plans: the plans past the scan stacks at their published
# widths, (arch, layers kept (None: all), prefill (B, S), the launches of
# one prefill step by kernel).  zamba2-7b whole (13 groups of 6 SSM
# layers around the shared attention block, then 3); llava-next at
# B 1 x S 8192, its 2880 patch rows then 5312 text tokens, past its
# 4096-token window; deepseek-v3 cut to its 3 dense layers and its first
# MoE layer (all 256 experts, the shared expert, MLA), 57.6 GiB at f32;
# arctic cut to 1 layer (128 experts and the dense residual), 52.4 GiB at
# f32, where 2 layers would be 103 GiB.  The f32 checks (kernel route
# against torch-ref, decode against the forward) run on the first
# LM_PLANS_F32_ROWS rows of the prefill batch: deepseek's torch-ref
# attention at 4 rows would hold 26 GB of f32 scores beside its 57.6 GiB
# of weights.  Decode: LM_PLANS_GEN (batch, prompt, gen), the MoE
# configurations' decode check at a capacity factor of E / top_k, at
# which the forward drops no token (decode, a token at a time, never
# does).  Then the four presets of the scan plan that never ran on the
# card, B 4 x S 2048: phi4-mini-3.8b whole (GQA 24/8, tied embeddings;
# 14.3 GiB at f32) and musicgen-medium whole (MHA 24/24 at D 64, the
# audio token stream through the embedding; 6.8 GiB); granite-20b (MQA
# 48/1) cut from 52 to 26 layers and command-r-35b (the parallel
# attention || FFN block, rope theta 8e6, vocab 256 000) from 40 to 16.
# The cut is lm_phase's f32 tree, built whole before the serving copy
# is cast from it: 104.9 and 120.6 GiB whole, 53.6 and 57.6 GiB at the
# cuts (deepseek's cut is 57.6 GiB at f32 and peaked at 63.3 GiB on the
# card); whole depth would fit at bf16 (54.4 and 65.6 GiB).
LM_PLANS = (("zamba2-7b", None, (4, 2048),
             {"ssd_scan": 81, "flash_attention": 13}),
            ("llava-next-mistral-7b", None, (1, 8192),
             {"flash_attention": 32}),
            ("deepseek-v3-671b", 4, (4, 2048), {"flash_attention": 4}),
            ("arctic-480b", 1, (4, 2048), {"flash_attention": 1}),
            ("phi4-mini-3.8b", None, (4, 2048), {"flash_attention": 32}),
            ("musicgen-medium", None, (4, 2048), {"flash_attention": 48}),
            ("granite-20b", 26, (4, 2048), {"flash_attention": 26}),
            ("command-r-35b", 16, (4, 2048), {"flash_attention": 16}))
LM_PLANS_F32_ROWS = 1
# cut for time (from (4, 32, 8) and 16 profiled steps: the deep
# stacks' decode is host-bound, ~0.2 s a step for zamba2-7b)
LM_PLANS_GEN = (4, 8, 4)
LM_PLANS_DECODE_PROFILE = 4
# Phase 18, train: launch.train's trainer (AdamW on a warmup-cosine
# schedule, the embedding and LM head node-local) at full width, bf16
# activations, diffusion with t_con 1; remat "all", as the configs have
# it.  Each case: (arch, layers kept (None: all), nodes, per-node batch,
# tokens a sequence).
# qwen3-1.7b is cut to 4 of its 28 layers: its f32 parameters,
# gradients and two moments on 4 nodes would need ~110 GB at 28.
# zamba2-7b is cut to 6 of 81 layers, one group (six Mamba2 layers
# around the shared attention block; below 6 layers there is no group
# and flash would not run), on 2 nodes: the dry run reads 52.0 GiB
# there and 104.1 GiB on 4.  llava-next-mistral-7b is cut to 1 of 32
# layers on 4 nodes x 1 x 4096 tokens: its 2880 patch rows leave no
# text at 1024 tokens (launch/specs.py raises), and 2 layers read
# 74.8 GiB, too near the card's 79.2 (its serving peak ran 3 GiB over
# the prediction).  mamba2-130m also runs the other six strategies.  Losses of every step
# within a relative TRAIN_LOSS_RTOL of the torch-ref route, the first
# step's gradients leaf by leaf within the relative L2 bound of the
# model's bf16 kernel route (LM_SSM_BF16_REL_L2 where ssd_scan runs,
# else LM_BF16_REL_L2), the f32 run's losses within LM_TOL.
TRAIN_NODES, TRAIN_PER_NODE, TRAIN_SEQ = 4, 2, 1024
TRAIN_CASES = (("mamba2-130m", None, TRAIN_NODES, TRAIN_PER_NODE, TRAIN_SEQ),
               ("qwen3-1.7b", 4, TRAIN_NODES, TRAIN_PER_NODE, TRAIN_SEQ),
               ("zamba2-7b", 6, 2, 2, 1024),
               ("llava-next-mistral-7b", 1, 4, 1, 4096))
TRAIN_WARM, TRAIN_TIMED = 1, 4
TRAIN_F32_STEPS = TRAIN_STRATEGY_STEPS = 2
TRAIN_LOSS_RTOL = 2e-2
# launch.train.train itself runs 2 steps of the cheaper step
TRAIN_ENTRY = "qwen3-1.7b"
TRAIN_STRATEGIES = ("local", "allreduce", "consensus", "dgd", "topk",
                    "quantized")
# the six other strategies run mamba2-130m cut to this depth (cut for
# time: ~2.6 s a step at its 24 layers on a slow host, 24 steps).  What
# they hold (allreduce keeps the replicas equal, local lets them part,
# node-local leaves stay unmixed) does not depend on depth, and their
# losses within TRAIN_LOSS_RTOL catch none of ssd_scan's planted faults
# at 6 layers or at 24 (worst 2.6e-3 on an "NVIDIA H100 80GB HBM3,
# 700.00 W"): a wrong ssd_scan in training is for the first step's
# gradients to catch, at the whole depth
TRAIN_STRATEGY_LAYERS = 6
# a node-local leaf after one step: what the local strategy leaves there
# (the embedding's backward sums with atomics on the card, so not bit for
# bit); mixing would move it by ~lr = 3e-4
TRAIN_LOCAL_ATOL = 1e-6
# The MoE dispatch's backward (index_put / index_add) and the aux loss
# under autograd, at the MoE plans' smoke widths only: one MoE layer's
# trainer state at published width is 270-340 GB a replica (11.3 B
# parameters for deepseek-v3, 14 B for arctic, ~24 bytes each), which
# no card holds.  TRAIN_MOE_STEPS fused diffusion steps of 4 nodes x 2 x
# 64 tokens (f32, no remat, as smoke() has them) through the kernels
# against torch-ref: losses and first gradients within TRAIN_MOE_TOL
# (the atomics of index_add are not bit for bit).
TRAIN_MOE_SMOKE = ("arctic-480b", "deepseek-v3-671b")
TRAIN_MOE_SHAPE = (4, 2, 64)
TRAIN_MOE_STEPS = 2
TRAIN_MOE_TOL = dict(rtol=1e-4, atol=1e-5)

# Phase 19, examples: the six port examples at their default sizes on the
# card, in this process (imported by path, main([]) called), each one's
# key line printed, and the launches of all six by kernel, of which
# EXAMPLE_KERNELS must each be nonzero.  Held: quickstart's Dif-AltGDmin
# final SD within EXAMPLE_SD_RATIO of the centralized run's and DGD's
# above EXAMPLE_DGD_FLOOR; the mesh within EXAMPLE_MESH_TOL of the
# simulator (f64); train_lm's loss falling and its checkpoint round trip
# bit for bit; serve_personalize's θ error falling over the checkpoints;
# serve_decode's prefill step within LM_TOL of its decode.
EXAMPLES = ("quickstart_torch", "distributed_mtrl_torch",
            "federated_multitask_torch", "serve_personalize_torch",
            "serve_decode_torch", "train_lm_torch")
EXAMPLE_KERNELS = ("node_fused_iter", "mix_rows", "node_task_gram",
                   "task_gram", "task_grad_tiles", "flash_attention",
                   "ssd_scan", "gossip_combine")
EXAMPLE_SD_RATIO = 10.0
EXAMPLE_DGD_FLOOR = 1e-1
EXAMPLE_MESH_TOL = 1e-8
# Phase 20, dryrun: the meta-device dry run's prediction on one device,
# mesh (1, 1), against the card: qwen3-1.7b's bf16 prefill at B 4 x S
# 2048, and phase 18's qwen3-1.7b train step (4 of 28 layers, 4 nodes x
# 2 x 1024 tokens).  Argument bytes exact, the peak within
# DRYRUN_PEAK_RTOL of max_memory_allocated (counted from a
# reset_peak_memory_stats() taken with the arguments in place, less what
# other phases hold), the launches equal.
DRYRUN_PREFILL = ("qwen3-1.7b", 4, 2048)
DRYRUN_TRAIN = ("qwen3-1.7b", 4)
DRYRUN_PEAK_RTOL = 0.15


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T_START}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, *, reps: int = 15, batch: int = 20) -> float:
    """Median device time of one call of ``fn``.  Each batch of calls is
    queued behind a device-side sleep, so the events time the calls back
    to back on the card rather than the host's pace of launching them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)           # cycles: outlasts the queueing
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def nbytes(*ts) -> int:
    """Bytes of the tensors: each input read once, each output written
    once."""
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, flops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, want, tol: dict, what: str) -> float:
    torch.cuda.synchronize()                    # a fault shows up here
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
    worst = float(err.max())
    require(ok and bool(torch.isfinite(got).all()),
            f"{what}: kernel disagrees with its plain version "
            f"(max abs err {worst:.3e}, tolerance {tol})")
    return worst


def pair_err(torch, got, want, tol: dict, what: str) -> float:
    """max_err over the two outputs of a kernel."""
    return max(max_err(torch, g, w, tol, what) for g, w in zip(got, want))


def instance(torch, shape, dtype, seed):
    L, tpn, n, d, r = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((L, tpn, n, d), generator=g, device="cuda")
    U = torch.linalg.qr(torch.randn((L, d, r), generator=g,
                                    device="cuda"))[0]
    y = torch.randn((L, tpn, n), generator=g, device="cuda")
    return X.to(dtype), U.to(dtype), y.to(dtype)


def reported(_build, fn, *args, **kw):
    """``fn(*args, **kw)`` and the CUDA launches its C entry reported
    (``_build.KERNEL_LAUNCHES``, set to 0 just before)."""
    _build.KERNEL_LAUNCHES.clear()
    out = fn(*args, **kw)
    return out, dict(_build.KERNEL_LAUNCHES)


def check_kernels(torch):
    from repro_torch.distributed import graphs, mixing
    from repro_torch.kernels import _build, altgdmin_ls, gossip_axpy, ops, ref

    rows = {}
    for sname, shape in SHAPES.items():
        L, tpn, n, d, r = shape
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            X, U, y = instance(torch, shape, dtype, seed=len(rows))
            tol = TOL[dname]
            what = f"{sname} {dname}"
            (B, tiles), fused_kernel = reported(
                _build, altgdmin_ls.node_fused_iter, X, U, y)
            e_fused = pair_err(torch, (B, tiles), ref.ref_fused_iter(X, U, y),
                               tol, f"node_fused_iter {what}")
            (G, c), gram_kernel = reported(_build, altgdmin_ls.node_task_gram,
                                           X, U, y)
            gram_ref = ref.ref_task_gram(X, U, y)
            e_gram = pair_err(torch, (G, c), gram_ref, tol,
                              f"node_task_gram {what}")
            require(gram_kernel == {"stream_gram_kernel": 1},
                    f"node_task_gram {what}: launched {gram_kernel}")
            # mix_rows at this shape's AGREE operand: W^{T_con} of an ER
            # graph's Metropolis weights, Z = the (L, d*r) iterate
            W = mixing.metropolis_weights(graphs.erdos_renyi(L, 0.5, seed=0))
            Wp = torch.linalg.matrix_power(
                torch.as_tensor(W, dtype=torch.float32, device="cuda"), 10)
            Z = U.reshape(L, d * r)
            out, mix_kernel = reported(_build, gossip_axpy.mix_rows, Wp, Z)
            require(out.dtype == Z.dtype, "mix_rows must return Z's dtype")
            require(mix_kernel == {"mix_tile_kernel": 1},
                    f"mix_rows {what}: launched {mix_kernel}, want the "
                    f"one-tile kernel")
            e_mix = max_err(torch, out, ref.ref_mix_rows(Wp, Z), tol,
                            f"mix_rows {what}")
            check = {"shape": sname, "dtype": dname,
                     "fused_iter_kernel": fused_kernel,
                     "gram_kernel": gram_kernel,
                     "max_abs_err": {"node_fused_iter": e_fused,
                                     "node_task_gram": e_gram,
                                     "mix_rows": e_mix}}
            if dname == "float32":
                check["timing"] = timings(torch, X, U, y, Wp, Z, B, tiles,
                                          G, c, out)
            if sname != "past_budget":
                # the resident kernel with its CTAs a task forced, beside
                # the pick the kernel makes (fused_ms_by_ctas[pick] is
                # the kernel's time)
                check["fused_ms_by_ctas"] = {
                    c: device_ms(torch, lambda: altgdmin_ls.node_fused_iter(
                        X, U, y, ctas_per_task=c)) for c in (1, 2)}
            want_kernel = ("fused_iter_kernel" if sname == "past_budget"
                           else "fused_resident_kernel")
            require(fused_kernel == {want_kernel: 1},
                    f"node_fused_iter {what}: launched {fused_kernel}, "
                    f"want {want_kernel}")
            rows[(sname, dname)] = check
            emit("kernels", **check)
        # float64 through the engine op: converted to f32 for the kernel,
        # as the TPU kernel's body does
        X, U, y = instance(torch, shape, torch.float64, seed=99)
        e64 = pair_err(
            torch, ops.altgdmin_fused_step(X, U, y, backend="cuda"),
            ops.altgdmin_fused_step(X, U, y, backend="torch-ref"),
            TOL["float64"], f"altgdmin_fused_step {sname} float64")
        emit("kernels", shape=sname, dtype="float64",
             max_abs_err={"altgdmin_fused_step": e64})
    return rows


def timing(torch, kernel, plain, args, n_bytes, flops, library=None, *,
           flop_per_s=F32_FLOP_PER_S, plain_reps=None):
    """Kernel, plain and library ms of one call on ``args``, and the
    card's bound for its bytes and operations (at ``flop_per_s``, the
    peak for the operands' type).  ``plain_reps`` times a slow plain
    version over that many single calls."""
    b, by = bound(n_bytes, flops, flop_per_s)
    plain_kw = dict(reps=plain_reps, batch=1) if plain_reps else {}
    return dict(ms=device_ms(torch, lambda: kernel(*args)),
                plain_ms=device_ms(torch, lambda: plain(*args), **plain_kw),
                library_ms=(device_ms(torch, lambda: library(*args))
                            if library else None),
                bound_ms=b, bound_by=by)


def timings(torch, X, U, y, Wp, Z, B, tiles, G, c, out):
    """Kernel, plain and library ms, and the bound, at one f32 shape.
    Bytes count each input read once and each output written once."""
    from repro_torch.kernels import altgdmin_ls, gossip_axpy, ref
    L, tpn, n, d = X.shape
    r = U.shape[2]
    tasks = L * tpn
    flops_gram = tasks * (2 * n * d * r + 2 * n * r * r + 2 * n * r)
    flops_fused = flops_gram + tasks * (r ** 3 / 3 + 2 * r * r + 2 * n * r
                                        + 2 * n * d + d * r)
    return {
        "node_fused_iter": timing(
            torch, altgdmin_ls.node_fused_iter, ref.ref_fused_iter,
            (X, U, y), nbytes(X, U, y, B, tiles), flops_fused),
        "node_task_gram": timing(
            torch, altgdmin_ls.node_task_gram, ref.ref_task_gram, (X, U, y),
            nbytes(X, U, y, G, c), flops_gram),
        "mix_rows": timing(
            torch, gossip_axpy.mix_rows, ref.ref_mix_rows, (Wp, Z),
            nbytes(Wp, Z, out), 2 * Z.shape[0] ** 2 * Z.shape[1],
            library=torch.matmul)}


# phase 3b: the static checks' harness on the card, each case at T_GD 1
# and 2 (an iteration's count is the same at any two lengths; the CLI
# runs 3 and 4); the virtual tier's spawn of harness.N_DEV ranks; the
# phase's ceiling
LINT_LENGTHS = (1, 2)
LINT_TIMEOUT = 240
LINT_MAX_S = 45.0


def lint_phase(torch) -> dict:
    """Phase 3b: JX001 with the real kernels.  Every program on the
    simulator (this process) and on the virtual tier (one spawn of
    harness.N_DEV gloo ranks on the card), each case run on the card
    without a recording context and on the CPU inside
    ``_build.recording()``; the launches an iteration and outside the
    loop of the two, by kernel, must equal each other and the
    DispatchBudget, and the virtual tier's sends R·K·wire_virtual on
    both.  One line a case, then the phase's seconds.  → {program/
    substrate: launches an iteration on the card, by kernel}."""
    from repro_torch.analysis import harness, torchlint
    from repro_torch.core.program import get_program, program_names

    t0 = time.perf_counter()
    harness.warm_ranks()        # started before the build; here a no-op
    # the CPU runs count launches and sends only (record_ops=False): the
    # op recorder's shapes and dtypes are JX002 / JX003's, read on the
    # CPU, and its first use in eight ranks at once is most of a spawn
    pairs = []
    for name in program_names():
        pairs.append((harness.run_case(name, "simulator", device="cuda",
                                       lengths=LINT_LENGTHS),
                      harness.run_case(name, "simulator", record_ops=False,
                                       lengths=LINT_LENGTHS)))
    sim_s = time.perf_counter() - t0
    specs = [(name, "virtual", "float32", device)
             for name in program_names() for device in ("cuda", "cpu")]
    t1, wall1 = time.perf_counter(), time.time()
    virtual = harness.spawn_cases(specs, device="cuda", lengths=LINT_LENGTHS,
                                  timeout=LINT_TIMEOUT, record_ops=False)
    spawn_s = time.perf_counter() - t1
    rank0_s = sum(c.seconds for c in virtual)
    # rank 0's first case began ready_s into the spawn; the spawn ended
    # teardown_s after its last
    ready_s = virtual[0].started - wall1
    teardown_s = wall1 + spawn_s - virtual[-1].started - virtual[-1].seconds
    pairs += list(zip(virtual[0::2], virtual[1::2]))
    out = {}
    for card, cpu in pairs:
        budget = get_program(card.program).dispatch_budget
        want = budget.per_iter(card.substrate, card.rounds, card.n_shifts,
                               card.local_steps)
        by_card = {k: v for k, v in card.launches_by_kernel.items() if v}
        by_cpu = {k: v for k, v in cpu.launches_by_kernel.items() if v}
        line = {"program": card.program, "substrate": card.substrate,
                "budget": want, "launches": card.launches[0],
                "launches_cpu": cpu.launches[0], "outside": card.launches[1],
                "outside_cpu": cpu.launches[1], "by_kernel": by_card,
                "R": card.rounds, "K": card.n_shifts,
                "card_s": card.seconds, "cpu_s": cpu.seconds}
        if card.substrate == "virtual":
            line.update(sends=card.sends[0], sends_cpu=cpu.sends[0],
                        sends_priced=card.rounds * card.n_shifts
                        * budget.wire_virtual)
        emit("lint", **line)
        found = (torchlint.check_dispatch_budget(card, budget)
                 + torchlint.check_comm_pricing(card, budget))
        require(not found and card.launches == cpu.launches
                and by_card == by_cpu and card.sends == cpu.sends,
                f"lint {card.program}/{card.substrate}: card launches "
                f"{card.launches} {by_card}, CPU recording {cpu.launches} "
                f"{by_cpu}, budget {want}; sends {card.sends} / "
                f"{cpu.sends}; {[f.render() for f in found]}")
        out[f"{card.program}/{card.substrate}"] = by_card
    seconds = time.perf_counter() - t0
    emit("lint_summary", seconds=seconds, simulator_s=sim_s,
         spawn_s=spawn_s, rank0_cases_s=rank0_s,
         spawn_overhead_s=spawn_s - rank0_s, ranks_ready_s=ready_s,
         teardown_s=teardown_s, cases=len(pairs),
         nvidia_smi=nvidia_smi_line())
    require(seconds <= LINT_MAX_S, f"the lint phase took {seconds:.1f} s, "
            f"above its {LINT_MAX_S} s")
    return out


def main_path(torch):
    from repro_torch.api import EngineSpec, materialize, run_experiment
    from repro_torch.configs.paper import EXPERIMENT1, to_spec
    from repro_torch.kernels import _build

    cfg = EXPERIMENT1[0]
    require(cfg.T_con == 10, "EXPERIMENT1[0] is the T_con=10 preset")
    spec = to_spec(cfg, dtype="float32", backend="cuda")
    T_GD, (L, tpn, n, d, r) = cfg.T_GD, SHAPES["exp1"]

    _build.LAUNCHES.clear()
    _build.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    mat = materialize(spec, key=0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trace = run_experiment(spec, key=0, materialized=mat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    kernel_launches = dict(_build.KERNEL_LAUNCHES)

    want = {"node_fused_iter": T_GD, "mix_rows": T_GD, "node_task_gram": 1}
    require(all(launches.get(k, 0) == v for k, v in want.items()),
            f"main path launch counts {launches}, want {want}")
    want_kernels = {"fused_resident_kernel": T_GD, "mix_tile_kernel": T_GD,
                    "stream_gram_kernel": 1}
    require(kernel_launches == want_kernels,
            f"main path: CUDA launches {kernel_launches}, want "
            f"{want_kernels}")
    for name, arr, shape in (
            ("sd_max", trace.sd_max, (T_GD,)),
            ("sd_mean", trace.sd_mean, (T_GD,)),
            ("spread", trace.spread, (T_GD,)),
            ("time_axis", trace.time_axis, (T_GD,)),
            ("U_nodes", trace.U_nodes.cpu().numpy(), (L, d, r)),
            ("B_nodes", trace.B_nodes.cpu().numpy(), (L, tpn, r))):
        require(tuple(arr.shape) == shape and bool(np.isfinite(arr).all()),
            f"{name}: shape {tuple(arr.shape)} (want {shape}) or not finite")
    require(trace.final_sd_max < 1e-3 * trace.sd_max[0],
            f"dif_altgdmin did not converge: sd_max {trace.sd_max[0]:.3e} "
            f"→ {trace.final_sd_max:.3e}")

    spec_ref = dataclasses.replace(spec, engine=EngineSpec(backend="torch-ref"))
    t3 = time.perf_counter()
    trace_ref = run_experiment(spec_ref, key=0, materialized=mat)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    diff = np.abs(trace.sd_max - trace_ref.sd_max)
    require(bool(np.all(diff <= 1e-5 + 1e-4 * np.abs(trace_ref.sd_max))),
            f"sd_max of the cuda run disagrees with torch-ref "
            f"(max abs diff {diff.max():.3e})")
    emit("main", preset=cfg.name, dtype="float32", T_GD=T_GD,
         launches=launches, kernel_launches=kernel_launches,
         final_sd_max=trace.final_sd_max,
         first_sd_max=float(trace.sd_max[0]),
         final_spread=float(trace.spread[-1]),
         sd_max_vs_torch_ref_max_abs_diff=float(diff.max()),
         materialize_s=t1 - t0, run_s=t2 - t1,
         ms_per_iter=(t2 - t1) / T_GD * 1e3,
         torch_ref_run_s=t4 - t3,
         torch_ref_ms_per_iter=(t4 - t3) / T_GD * 1e3,
         total_s=t2 - t0)
    return spec, mat, launches, trace


def profiled(torch, fn, *, warm: bool = True) -> dict:
    """One call of ``fn`` (after a warm call, unless ``warm`` is False)
    under torch.profiler: host wall ms ended by a device synchronize,
    device ms summed over kernels, the device's busy share and the top
    kernels by device ms.  The profiler's raw events are read as they
    are (``kineto_results``): building its per-event Python objects
    costs tens of µs an event, minutes for a run of a million launches."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    if warm:
        fn()
        torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, device_ops = {}, 0
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            name = ev.name()
            kernels[name] = kernels.get(name, 0.0) + ev.duration_ns() / 1e6
            device_ops += 1
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms if wall_ms else None,
                device_ops=device_ops,
                top_kernels_ms=[[name[:90], ms] for name, ms in top])


def profile(torch, spec, mat, *, label="profile"):
    from repro_torch.api import run_experiment

    iters = 20
    short = dataclasses.replace(
        spec, solver=dataclasses.replace(spec.solver, T_GD=iters))
    prof = profiled(torch, lambda: run_experiment(short, key=0,
                                                  materialized=mat))
    emit("profile", path=label, iterations=iters,
         device_ops_per_iter=prof["device_ops"] / iters,
         device_ms_per_iter=prof["device_busy_ms"] / iters,
         host_ms_per_iter=prof["wall_ms"] / iters, **prof)


def check_slice_kernels(torch):
    """Phase 6: node_task_grad_tiles, compress_topk, the int8 round and
    dequant against their plain versions, with the times of each at the
    shape its path gives it."""
    from repro_torch.kernels import _build, altgdmin_ls, compress, ops, ref

    errs = {"node_task_grad_tiles": 0.0, "compress_topk": 0.0,
            "dequant": 0.0}
    times = {}
    for sname, shape in GRAD_SHAPES.items():
        L, tpn, n, d, r = shape
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            X, U, y = instance(torch, shape, dtype, seed=7)
            B = torch.randn((L, tpn, r), device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(8))
            tiles, grad_kernel = reported(
                _build, altgdmin_ls.node_task_grad_tiles, X, U, B, y)
            require(grad_kernel == {"fused_resident_kernel/grad": 1},
                    f"node_task_grad_tiles {sname} {dname}: launched "
                    f"{grad_kernel}, want the resident gradient form")
            want = ref.ref_node_grad_tiles(X, U, B, y)
            e = max_err(torch, tiles, want, TOL[dname],
                        f"node_task_grad_tiles {sname} {dname}")
            # one order of summation whatever the CTAs a task
            for c in (1, 2):
                require(torch.equal(altgdmin_ls.node_task_grad_tiles(
                    X, U, B, y, ctas_per_task=c), tiles),
                    f"node_task_grad_tiles {sname} {dname}: {c} CTAs a "
                    f"task change the tiles")
            if dname == "float32":
                errs["node_task_grad_tiles"] = max(
                    errs["node_task_grad_tiles"], e)
            emit("slice_kernels", kernel="node_task_grad_tiles",
                 shape=sname, dtype=dname, max_abs_err=e,
                 cuda_kernel=grad_kernel)
            if sname == "exp1_fold":
                t = timing(
                    torch, altgdmin_ls.node_task_grad_tiles,
                    ref.ref_node_grad_tiles, (X, U, B, y),
                    nbytes(X, U, B, y, tiles),
                    L * tpn * (2 * n * d * r + 2 * n * r + 2 * n * d
                               + d * r))
                # the resident form with its CTAs a task forced, beside
                # the pick
                t["ms_by_ctas_a_task"] = {
                    c: device_ms(torch, lambda: altgdmin_ls
                                 .node_task_grad_tiles(X, U, B, y,
                                                       ctas_per_task=c))
                    for c in (1, 2)}
                t["cuda_kernel"] = grad_kernel
                if dname == "float32":
                    times["node_task_grad_tiles"] = t
                else:
                    times["node_task_grad_tiles"]["bfloat16"] = t
        X, U, y = instance(torch, shape, torch.float64, seed=8)
        B = torch.randn((L, tpn, r), device="cuda", dtype=torch.float64)
        e64 = max_err(
            torch, ops.altgdmin_node_gradient(X, U, B, y, backend="cuda"),
            ops.altgdmin_node_gradient(X, U, B, y, backend="torch-ref"),
            TOL["float64"], f"altgdmin_node_gradient {sname} float64")
        emit("slice_kernels", kernel="altgdmin_node_gradient", shape=sname,
             dtype="float64", max_abs_err=e64)

    for sname, (N, d, r, k) in TOPK_SHAPES.items():
        for dname in ("float32", "bfloat16"):
            g = torch.Generator(device="cuda").manual_seed(d + k)
            M = torch.randn((N, d, r), generator=g, device="cuda").to(
                getattr(torch, dname))
            M[:, d // 2] = M[:, 0]           # exact ties: index order
            M[:, d - 1] = M[:, 0]
            vals, idx = compress.compress_topk(M, k)
            v_ref, i_ref = ref.ref_compress_topk(M, k)
            torch.cuda.synchronize()
            require(torch.equal(idx, i_ref) and torch.equal(vals, v_ref),
                    f"compress_topk {sname} {dname} differs from its plain "
                    f"version")
            emit("slice_kernels", kernel="compress_topk", shape=sname,
                 dtype=dname, bitwise_equal=True)
            if sname == "exp1" and dname == "float32":
                times["compress_topk"] = timing(
                    torch, compress.compress_topk, ref.ref_compress_topk,
                    (M, k), nbytes(M, vals, idx), 2 * N * d * r + N * d)
        if sname in TOPK_SPECIAL_SHAPES:
            check_topk_special(torch, compress, ref, sname, N, d, r)
        for dname in ("float32", "bfloat16"):
            g = torch.Generator(device="cuda").manual_seed(N)
            q = torch.randint(-127, 128, (N, d, r), generator=g,
                              device="cuda", dtype=torch.int8)
            scale = (torch.rand((N, 1, 1), generator=g, device="cuda")
                     + 1e-3).to(getattr(torch, dname))
            out = compress.dequant(q, scale)
            want = ref.ref_dequant(q, scale)
            torch.cuda.synchronize()
            require(out.dtype == want.dtype and torch.equal(out, want),
                    f"dequant {sname} {dname} differs from its plain "
                    f"version")
            emit("slice_kernels", kernel="dequant", shape=sname,
                 dtype=dname, bitwise_equal=True)
            if sname == "exp1" and dname == "float32":
                times["dequant_kernel"] = timing(
                    torch, compress.dequant, ref.ref_dequant, (q, scale),
                    nbytes(q, scale, out), q.numel(), library=torch.mul)
    times["dequant"] = check_int8_round(torch)
    times["dequant"]["dequant_kernel"] = times.pop("dequant_kernel")
    emit("slice_kernels", timing=times)
    return errs, times


def check_int8_round(torch):
    """The int8 wire's round (int8_round) against ref_int8_round bit for
    bit at ROUND_SHAPES, f32 and bf16, both wires, on blocks with a zero
    delta, a NaN and an inf appended (scale and x̂' compared with NaN
    positions equal, q on the nodes whose scale is finite); its time
    beside the plain round's device time at each f32 shape (int8 wire).
    → the time at Experiment 1, with the other shapes' beside it."""
    from repro_torch.distributed.consensus import stochastic_dither
    from repro_torch.kernels import _build, compress, ref

    def same_nan(got, want):
        nan = torch.isnan(want)
        bits = torch.int32 if want.element_size() == 4 else torch.int16
        return (torch.equal(torch.isnan(got), nan)
                and torch.equal(got.view(bits)[~nan], want.view(bits)[~nan]))

    by_shape = {}
    for sname, (N, d, r) in ROUND_SHAPES.items():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            g = torch.Generator(device="cuda").manual_seed(N + d)
            Z = torch.randn((N + 3, d, r), generator=g, device="cuda")
            xhat = 0.5 * torch.randn((N + 3, d, r), generator=g,
                                     device="cuda")
            xhat[N] = Z[N]                          # a zero delta
            Z[N + 1, d // 2, 0] = float("nan")
            Z[N + 2, d - 1, r - 1] = float("inf")
            Z, xhat = Z.to(dtype), xhat.to(dtype)
            for wire in ROUND_WIRES:
                u = (stochastic_dither(1, torch.arange(N + 3, device="cuda"),
                                       (d, r), dtype)
                     if wire == "int8_stochastic" else None)
                (q, scale, xn), kernel = reported(
                    _build, compress.int8_round, Z, xhat, u)
                q0, scale0, xn0 = ref.ref_int8_round(Z, xhat, u)
                torch.cuda.synchronize()
                fin = torch.isfinite(scale0.flatten())
                require(kernel == {"int8_round_kernel": 1}
                        and same_nan(scale, scale0) and same_nan(xn, xn0)
                        and int(fin.sum()) == N + 1
                        and torch.equal(q[fin], q0[fin]),
                        f"int8_round {sname} {dname} {wire} differs from "
                        f"its plain version (launched {kernel})")
                emit("slice_kernels", kernel="int8_round", shape=sname,
                     dtype=dname, wire=wire, bitwise_equal=True)
            if dname == "float32":
                Zt, xt = Z[:N].contiguous(), xhat[:N].contiguous()
                q, scale, xn = compress.int8_round(Zt, xt)
                by_shape[sname] = timing(
                    torch, compress.int8_round, ref.ref_int8_round,
                    (Zt, xt), nbytes(Zt, xt, q, scale, xn), 8 * Zt.numel())
    times = dict(by_shape["exp1"], cuda_kernel="int8_round_kernel",
                 by_shape=by_shape)
    emit("slice_kernels", kernel="int8_round", timing=by_shape)
    return times


def check_topk_special(torch, compress, ref, sname, N, d, r):
    """compress_topk on NaN, inf, all-equal and tied blocks
    (``ref.topk_special_block``) at k = d/2 and d, f32 and bf16, against
    its plain version bit for bit (NaN rows compared by their bits): NaN
    above every number, ties in index order, no row past d."""
    g = torch.Generator(device="cuda").manual_seed(d)
    base = torch.randn((N, d, r), generator=g, device="cuda")
    for kind in ref.TOPK_SPECIAL_KINDS:
        for dname in ("float32", "bfloat16"):
            M = ref.topk_special_block(base, kind).to(getattr(torch, dname))
            bits = torch.int32 if dname == "float32" else torch.int16
            for k in (d // 2, d):
                vals, idx = compress.compress_topk(M, k)
                v_ref, i_ref = ref.ref_compress_topk(M, k)
                torch.cuda.synchronize()
                require(torch.equal(idx, i_ref)
                        and torch.equal(vals.view(bits), v_ref.view(bits)),
                        f"compress_topk {sname} {kind} {dname} k={k} "
                        f"differs from its plain version")
            emit("slice_kernels", kernel="compress_topk", shape=sname,
                 block=kind, dtype=dname, k=[d // 2, d], bitwise_equal=True)


def run_path(torch, spec, mat, want, want_kernels, *, name):
    """Drive ``run_experiment`` on the cuda backend with the launch
    counts set to 0 just before and read just after; check the wrappers'
    counts against ``want`` and the CUDA launches their C entries
    reported against ``want_kernels``, the outputs' shapes and
    finiteness; then the same spec and materialization on torch-ref.
    → (trace, torch-ref trace, launches, CUDA launches by kernel,
    seconds per run of each)."""
    from repro_torch.api import EngineSpec, run_experiment
    from repro_torch.core.program import get_program
    from repro_torch.kernels import _build

    T_GD, p = spec.solver.T_GD, spec.problem
    # the fusion center's simulator carries one iterate
    U_shape = ((p.L, p.d, p.r) if get_program(spec.solver.name).stacked
               else (1, p.d, p.r))
    _build.LAUNCHES.clear()
    _build.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    trace = run_experiment(spec, key=0, materialized=mat)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    kernel_launches = dict(_build.KERNEL_LAUNCHES)
    require(all(launches.get(k, 0) == v for k, v in want.items()),
            f"{name}: launch counts {launches}, want {want}")
    require(kernel_launches == want_kernels,
            f"{name}: CUDA launches {kernel_launches}, want {want_kernels}")
    for field, arr, shape in (
            ("sd_max", trace.sd_max, (T_GD,)),
            ("spread", trace.spread, (T_GD,)),
            ("time_axis", trace.time_axis, (T_GD,)),
            ("U_nodes", trace.U_nodes.cpu().numpy(), U_shape),
            ("B_nodes", trace.B_nodes.cpu().numpy(),
             (p.L, p.T // p.L, p.r))):
        require(tuple(arr.shape) == shape and bool(np.isfinite(arr).all()),
                f"{name} {field}: shape {tuple(arr.shape)} (want {shape}) "
                f"or not finite")
    spec_ref = dataclasses.replace(spec,
                                   engine=EngineSpec(backend="torch-ref"))
    t2 = time.perf_counter()
    trace_ref = run_experiment(spec_ref, key=0, materialized=mat)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return trace, trace_ref, launches, kernel_launches, t1 - t0, t3 - t2


def agree_upto(a, b, upto=None) -> tuple[bool, float, int | None]:
    """Whether two sd_max traces agree (rtol 1e-4, atol 1e-5) over their
    first ``upto`` iterations, the max abs difference there, and the
    first iteration where they part (None if they never do)."""
    ok = np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)
    parts = np.flatnonzero(~ok)
    first = int(parts[0]) if parts.size else None
    return bool(ok[:upto].all()), float(np.abs(a - b)[:upto].max()), first


def path_a(torch):
    """Phase 7: sample-split Dif-AltGDmin at Experiment 1."""
    from repro_torch.api import materialize
    from repro_torch.configs.paper import EXPERIMENT1, to_spec

    cfg = EXPERIMENT1[0]
    spec = to_spec(cfg, dtype="float32", backend="cuda")
    spec = dataclasses.replace(spec, problem=dataclasses.replace(
        spec.problem, n_folds=2))
    T_GD = cfg.T_GD
    mat = materialize(spec, key=0, device="cuda")
    want = {"node_task_gram": T_GD + 1, "node_task_grad_tiles": T_GD,
            "mix_rows": T_GD, "node_fused_iter": 0}
    want_kernels = {"stream_gram_kernel": T_GD + 1,
                    "mix_tile_kernel": T_GD,
                    "fused_resident_kernel/grad": T_GD}
    trace, trace_ref, launches, kernel_launches, run_s, ref_s = run_path(
        torch, spec, mat, want, want_kernels, name="path A")
    ok, diff, first = agree_upto(trace.sd_max, trace_ref.sd_max)
    emit("path_a", preset=cfg.name, n_folds=2, dtype="float32", T_GD=T_GD,
         launches=launches, kernel_launches=kernel_launches,
         first_sd_max=float(trace.sd_max[0]),
         final_sd_max=trace.final_sd_max,
         final_spread=float(trace.spread[-1]),
         sd_max_vs_torch_ref_max_abs_diff=diff, run_s=run_s,
         ms_per_iter=run_s / T_GD * 1e3, torch_ref_run_s=ref_s,
         torch_ref_ms_per_iter=ref_s / T_GD * 1e3,
         first_parting_iteration=first)
    require(ok, f"path A: sd_max disagrees with torch-ref (max abs diff "
                f"{diff:.3e}, first at iteration {first})")
    require(trace.final_sd_max < 1e-2 * trace.sd_max[0],
            f"path A did not converge: sd_max {trace.sd_max[0]:.3e} → "
            f"{trace.final_sd_max:.3e}")
    profile(torch, spec, mat, label="path_a")
    return launches


# (solver, knobs, kernel counted per round, the reference's convergence
# bound, whether the whole sd_max trajectory is held to torch-ref).  Row
# selection at k < d is discontinuous: once the f32 round-off of
# mix_rows (against the plain product's) reorders two nearly equal row
# norms of Z − x̂ — a difference of nearly equal numbers — the two runs
# select different rows and part.  At k = 150 that happens within the
# first 50 iterations, so that run reports its agreement over them and
# its first parting iteration and is held to its final value (within
# 10 %); the same path at k = d, whose selection cannot flip, is held
# over the whole trajectory.  The four runs take PATH_B_T_GD iterations,
# cut from the preset's 500 to make room for the train phase: sd_max
# reaches the f32 floor in ~250 (halving about every 14 iterations).
PATH_B_T_GD = 250
PATH_B = (("dif_topk", {"compression_k": 150}, "compress_topk", 0.65, False),
          ("dif_topk", {"compression_k": 600}, "compress_topk", 0.65, True),
          ("dif_quantized", {"compression": "int8"}, "dequant", 0.5, True),
          ("dif_event", {"event_threshold": 0.02}, None, 0.6, True))


def path_b(torch, spec, mat):
    """Phase 8: the compressed trio at Experiment 1, on the dense path's
    materialization, PATH_B_T_GD iterations."""
    spec = dataclasses.replace(spec, solver=dataclasses.replace(
        spec.solver, T_GD=PATH_B_T_GD))
    T_GD, T_con = spec.solver.T_GD, spec.solver.T_con
    p_d = spec.problem.d
    launches_by_kernel, failures = {}, []
    for name, kw, kernel, shrink, held in PATH_B:
        upto = None if held else 50
        s = dataclasses.replace(spec, solver=dataclasses.replace(
            spec.solver, name=name, **kw))
        want = {"mix_rows": T_con * T_GD, "node_fused_iter": T_GD,
                "node_task_gram": 1, "node_task_grad_tiles": 0,
                "compress_topk": 0, "dequant": 0}
        if kernel:
            want[kernel] = T_con * T_GD
        want_kernels = {"fused_resident_kernel": T_GD,
                        "mix_tile_kernel": T_con * T_GD,
                        "stream_gram_kernel": 1}
        if kernel == "dequant":        # the whole int8 round, one launch
            want_kernels["int8_round_kernel"] = T_con * T_GD
        trace, trace_ref, launches, kernel_launches, run_s, ref_s = run_path(
            torch, s, mat, want, want_kernels, name=name)
        if kernel:
            launches_by_kernel.setdefault(kernel, launches.get(kernel, 0))
        ok, diff, first = agree_upto(trace.sd_max, trace_ref.sd_max, upto)
        final_rel = (abs(trace.final_sd_max - trace_ref.final_sd_max)
                     / trace_ref.final_sd_max)
        emit("path_b", solver=name, knobs=kw, dtype="float32", T_GD=T_GD,
             T_con=T_con, launches=launches, kernel_launches=kernel_launches,
             first_sd_max=float(trace.sd_max[0]),
             final_sd_max=trace.final_sd_max,
             torch_ref_final_sd_max=trace_ref.final_sd_max,
             final_rel_diff_vs_torch_ref=final_rel,
             compared_iterations=upto or T_GD, trajectory_held=held,
             agrees_over_compared=ok,
             sd_max_vs_torch_ref_max_abs_diff=diff,
             first_parting_iteration=first,
             mean_send_frac=(float(np.mean(trace.send_frac))
                             if trace.send_frac is not None else None),
             run_s=run_s, ms_per_iter=run_s / T_GD * 1e3,
             torch_ref_run_s=ref_s,
             torch_ref_ms_per_iter=ref_s / T_GD * 1e3)
        # every solver runs before a failed check raises, so one run
        # reports all three
        if held and not ok:
            failures.append(
                f"{name} {kw}: sd_max disagrees with torch-ref (max abs "
                f"diff {diff:.3e}, first at iteration {first})")
        if not held and final_rel > 0.1:
            failures.append(f"{name}: final sd_max {trace.final_sd_max:.3e}"
                            f" vs torch-ref {trace_ref.final_sd_max:.3e}")
        if not trace.final_sd_max < shrink * trace.sd_max[0]:
            failures.append(
                f"{name} did not converge: sd_max {trace.sd_max[0]:.3e} → "
                f"{trace.final_sd_max:.3e} (bound {shrink})")
        if kw.get("compression_k") != p_d:       # k = d: no own profile
            profile(torch, s, mat, label=f"path_b_{name}")
    require(not failures, "; ".join(failures))
    return launches_by_kernel


def masked_phase(torch, spec, mat):
    """Phase 9: the dropout-tolerant trio at Experiment 1 on the dense
    path's materialization, always-on and under MASKED_DROPOUT.  Each
    run's launches against its program's DispatchBudget (mix_rows once a
    round, twice for push-sum); the cuda sd_max trace against torch-ref's
    on the card over the whole run; always-on dif_partial's torch-ref
    trace and iterate equal to dense dif_altgdmin's bit for bit;
    convergence under dropout; a strictly increasing simulated clock; a
    profile of 20 iterations each.  Returns the mix_rows launches of
    each solver's dropout run."""
    from repro_torch.api import EngineSpec, SystemSpec, run_experiment
    from repro_torch.core.program import get_program
    from repro_torch.distributed.consensus import get_rule

    spec = dataclasses.replace(spec, solver=dataclasses.replace(
        spec.solver, T_GD=MASKED_T_GD))
    T_GD, T_con = spec.solver.T_GD, spec.solver.T_con
    dense_ref = run_experiment(dataclasses.replace(
        spec, engine=EngineSpec(backend="torch-ref")), key=0,
        materialized=mat)
    systems = (("always_on", SystemSpec()),
               ("dropout", SystemSpec(**MASKED_DROPOUT)))
    mix_launches, failures = {}, []
    for name in MASKED_SOLVERS:
        prog = get_program(name)
        rounds = get_rule(prog.combine).signature(T_con).rounds_per_iter
        per_iter = prog.dispatch_budget.per_iter("simulator", rounds, 0, 1)
        n_mix = (per_iter - 1) * T_GD          # all but node_fused_iter
        want = {"node_fused_iter": T_GD, "mix_rows": n_mix,
                "node_task_gram": 1, "node_task_grad_tiles": 0,
                "compress_topk": 0, "dequant": 0, "gossip_combine": 0}
        want_kernels = {"fused_resident_kernel": T_GD,
                        "mix_tile_kernel": n_mix, "stream_gram_kernel": 1}
        for label, system in systems:
            s = dataclasses.replace(spec, system=system,
                                    solver=dataclasses.replace(spec.solver,
                                                               name=name))
            trace, trace_ref, launches, kernel_launches, run_s, ref_s = (
                run_path(torch, s, mat, want, want_kernels,
                         name=f"masked {name} {label}"))
            require((launches["node_fused_iter"] + launches["mix_rows"])
                    == per_iter * T_GD,
                    f"masked {name} {label}: launches {launches}, want "
                    f"{per_iter} an iteration by the DispatchBudget")
            if label == "dropout":
                mix_launches[name] = launches["mix_rows"]
            ok, diff, first = agree_upto(trace.sd_max, trace_ref.sd_max)
            dense_equal = None
            if label == "always_on" and name == "dif_partial":
                dense_equal = bool(
                    np.array_equal(trace_ref.sd_max, dense_ref.sd_max)
                    and torch.equal(trace_ref.U_nodes, dense_ref.U_nodes))
                if not dense_equal:
                    gap = np.abs(trace_ref.sd_max - dense_ref.sd_max).max()
                    failures.append(
                        f"always-on dif_partial on torch-ref is not dense "
                        f"dif_altgdmin's trajectory bit for bit (max abs "
                        f"diff {gap:.3e})")
            clock_ok = (trace.time_axis_source == "simulated"
                        and bool(np.all(np.diff(trace.time_axis) > 0)))
            emit("masked", solver=name, system=label,
                 system_spec=dataclasses.asdict(system), dtype="float32",
                 T_GD=T_GD, T_con=T_con, launches=launches,
                 kernel_launches=kernel_launches,
                 dispatch_budget_per_iter=per_iter,
                 live_share=float(system.availability_mask(
                     T_GD, spec.problem.L).mean()),
                 first_sd_max=float(trace.sd_max[0]),
                 final_sd_max=trace.final_sd_max,
                 torch_ref_final_sd_max=trace_ref.final_sd_max,
                 sd_max_vs_torch_ref_max_abs_diff=diff,
                 first_parting_iteration=first,
                 torch_ref_equals_dense=dense_equal,
                 time_axis_source=trace.time_axis_source,
                 simulated_s=float(trace.time_axis[-1]),
                 run_s=run_s, ms_per_iter=run_s / T_GD * 1e3,
                 torch_ref_run_s=ref_s,
                 torch_ref_ms_per_iter=ref_s / T_GD * 1e3)
            if not ok:
                failures.append(
                    f"masked {name} {label}: sd_max disagrees with "
                    f"torch-ref (max abs diff {diff:.3e}, first at "
                    f"iteration {first})")
            if not clock_ok:
                failures.append(f"masked {name} {label}: the simulated "
                                f"clock is not strictly increasing")
            if label == "dropout" and not (
                    trace.final_sd_max < MASKED_SHRINK * trace.sd_max[0]):
                failures.append(
                    f"masked {name} under dropout did not converge: sd_max "
                    f"{trace.sd_max[0]:.3e} → {trace.final_sd_max:.3e}")
            profile(torch, s, mat, label=f"masked_{name}_{label}")
    require(not failures, "; ".join(failures))
    return mix_launches



def combine_form(K) -> str:
    """The form gossip_combine's C entry reports for K neighbours."""
    if K + 1 <= COMBINE_REG_ROWS:
        return "combine_regs_kernel"
    if K + 1 > COMBINE_STAGE_ROWS:
        return "combine_tile_kernel/staged"
    return "combine_tile_kernel"


def combine_operands(torch, n, K, dname, offset=0):
    """gossip_combine's operands for one case, from a seed: z (n,) —
    ``offset`` elements past an aligned base — neighbours (K, n) in
    ``dname``, and K+1 positive f32 weights summing to 1 on the card."""
    g = torch.Generator(device="cuda").manual_seed(n + K)
    dtype = getattr(torch, dname)
    z = torch.randn(n + offset, generator=g, device="cuda").to(dtype)[offset:]
    nbrs = torch.randn((K, n), generator=g, device="cuda").to(dtype)
    wt = torch.rand(K + 1, generator=g, device="cuda")
    return z, nbrs, wt / wt.sum()


def check_gossip_kernel(torch):
    """Phase 10: gossip_combine against its plain version at the mesh and
    roll shapes, within COMBINE_TOL and bit for bit, and at
    COMBINE_EXTRA_CASES bit for bit, each through the form its C entry
    reports (registers for K+1 <= COMBINE_REG_ROWS, one shared-memory
    stage, or stages past COMBINE_STAGE_ROWS rows); the time of each f32 case (the kernel row's numbers are the
    mesh round's at K = 19, the Experiment 1 graph's shift count)."""
    from repro_torch.kernels import _build, gossip_axpy, ops, ref

    errs, times = [], {}
    cases = [c + (0,) for c in COMBINE_CASES] + list(COMBINE_EXTRA_CASES)
    for name, n, K, dname, wkind, offset in cases:
        dtype = getattr(torch, dname)
        z, nbrs, wt = combine_operands(torch, n, K, dname, offset)
        w_floats = tuple(wt.tolist())
        # the op takes the case's own weights: a float tuple it uploads,
        # or the device tensor as it is
        weights = wt if wkind == "tensor" else w_floats
        out, form = reported(_build, ops.gossip_combine, z, nbrs, weights,
                             backend="cuda")
        want = ref.ref_gossip_combine(z, nbrs, weights)
        require(out.dtype == dtype, "gossip_combine must return z's dtype")
        want_form = combine_form(K)
        require(form == {want_form: 1},
                f"gossip_combine {name}: launched {form}, want {want_form}")
        e = max_err(torch, out, want, COMBINE_TOL[dname],
                    f"gossip_combine {name}")
        bitwise = bool(torch.equal(out, want))
        require(bitwise, f"gossip_combine {name}: not bit for bit equal to "
                         f"ref_gossip_combine (max abs err {e:.3e})")
        if dname == "float32":
            errs.append(e)
            w0, wk = float(w_floats[0]), wt[1:]
            flops, n_bytes = gossip_axpy.combine_cost(z, nbrs, wt)
            times[name] = timing(
                torch, gossip_axpy.gossip_combine, ref.ref_gossip_combine,
                (z, nbrs, wt), n_bytes, flops,
                library=lambda z_, nb, _w: torch.addmv(z_, nb.T, wk,
                                                       beta=w0))
        emit("gossip_kernels", case=name, n=n, K=K, dtype=dname,
             weights=wkind, z_offset=offset, cuda_kernel=form,
             max_abs_err=e, bitwise_equal=bitwise, timing=times.get(name))
    row = dict(times["mesh_K19"], cuda_kernel={combine_form(19): 1},
               by_case={k: v["ms"] for k, v in times.items()})
    return max(errs), row


def roll_form(torch):
    """Phase 11: roll_gossip at Experiment 1 width through the kernel."""
    from repro_torch.distributed import mixing
    from repro_torch.distributed.consensus import stacked_product
    from repro_torch.distributed.gossip import roll_gossip
    from repro_torch.kernels import _build

    L, d, r, T_con = 20, 600, 4, 10
    g = torch.Generator(device="cuda").manual_seed(20)
    Z = torch.randn((L, d, r), generator=g, device="cuda")
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = roll_gossip(Z, T_con, (-1, 1), backend="cuda")
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    require(launches == {"gossip_combine": T_con},
            f"roll form launches {launches}, want {T_con} gossip_combine")
    plain = roll_gossip(Z, T_con, (-1, 1), backend="torch-ref")
    W = torch.as_tensor(mixing.circulant_weights(L, (-1, 1)),
                        dtype=torch.float32, device="cuda")
    dense = stacked_product(Z, W, T_con)
    e_plain = max_err(torch, out, plain, COMBINE_TOL["float32"],
                      "roll_gossip vs torch-ref")
    # against cuBLAS's products the sums run in another order: f32
    # round-off over ten rounds
    e_dense = max_err(torch, out, dense, dict(rtol=1e-5, atol=1e-5),
                      "roll_gossip vs stacked_product")
    emit("roll", shape=[L, d, r], shifts=[-1, 1], T_con=T_con,
         launches=launches, max_abs_err_vs_torch_ref=e_plain,
         bitwise_equal_torch_ref=bool(torch.equal(out, plain)),
         max_abs_err_vs_stacked_product=e_dense, first_call_ms=run_ms)
    return launches["gossip_combine"]


def spawn_ranks(fn, n, *, args, device, timeout):
    """``mesh.spawn`` of ``n`` gloo ranks forked from the forkserver with
    torch preloaded (``harness.warm_ranks``, started before the build in
    the full run): the ranks skip importing torch, which took most of a
    20-rank spawn."""
    from repro_torch.analysis import harness
    from repro_torch.distributed.mesh import spawn
    harness.warm_ranks()
    return spawn(fn, n, args=args, backend="gloo", device=device,
                 timeout=timeout)


def program_runs(spec, T_GD, state_T_GD, *, own=None):
    """The mesh phases' runs, all twelve programs: (solver, knobs,
    system, held, T_GD) — the six stateless ones at ``T_GD`` (the
    programs of the mapping ``own`` at their own), then
    MESH_STATE_SOLVERS at ``state_T_GD`` — and their mesh specs."""
    from repro_torch.api import SystemSpec

    own = own or {}
    runs = [(name, {}, None, True, own.get(name, T_GD))
            for name in MESH_SOLVERS] + [
        (name, kw, system, held, state_T_GD)
        for name, kw, system, held in MESH_STATE_SOLVERS]
    specs = [dataclasses.replace(
        spec, substrate="mesh",
        system=SystemSpec(**system) if system is not None else None,
        solver=dataclasses.replace(spec.solver, name=name, T_GD=T, **kw))
        for name, kw, system, _, T in runs]
    return runs, specs


def hold_programs(phase, spec, mat, runs, specs, ranks, *, tier, K, spawn_s,
                  extra=None, converges=True, sims=None):
    """Hold each program's mesh run (``ranks``, every rank's results of
    run_on_mesh) as phases 12 and 12b do, emit a ``phase`` line a
    program, and raise on any failure.  ``tier`` is the DispatchBudget
    substrate ("mesh" or "virtual"), ``K`` the shift classes by the
    program's topology; ``extra(name)`` adds fields to a program's line;
    ``converges=False`` drops the convergence checks (a run too short,
    or a step too small, to show them); ``sims`` maps a program to its
    simulator trace on ``mat`` when one was run already (the same spec
    on substrate "simulator"), else the simulator runs here.
    Returns rank 0's launches (gossip_combine's by program,
    compress_topk's and dequant's) and each program's timings."""
    from repro_torch.api import run_experiment
    from repro_torch.core.program import get_program
    from repro_torch.distributed.consensus import get_rule

    n_ranks = len(ranks)
    L = spec.problem.L
    failures = []
    out = {"gossip_combine_by_program": {}, "per_program": {}}
    for i, (s, (name, kw, system, held, T)) in enumerate(zip(specs, runs)):
        hw = ranks[0][i]
        label = f"{name} {kw}" if kw else name
        for g in range(1, n_ranks):
            require(np.array_equal(ranks[g][i]["U_nodes"], hw["U_nodes"])
                    and np.array_equal(ranks[g][i]["B_nodes"],
                                       hw["B_nodes"])
                    and np.array_equal(ranks[g][i]["sd_max"], hw["sd_max"]),
                    f"{phase} {label}: rank {g}'s result differs from rank "
                    f"0's")
        prog = get_program(name)
        k = K[prog.topology]
        rounds = get_rule(prog.combine).signature(s.solver.T_con).rounds_per_iter
        budget = prog.dispatch_budget
        per_iter = budget.per_iter(tier, rounds, k, 1)
        n_round = T * rounds if prog.mixer != "central" else 0
        if tier == "mesh":
            want = {"node_fused_iter": T, "node_task_gram": 1,
                    "gossip_combine": n_round,
                    "compress_topk": n_round if name == "dif_topk" else 0,
                    # the int8 round, then one decode a shift
                    "dequant": n_round * (1 + k) if name == "dif_quantized"
                    else 0}
            want_kernels = {combine_form(k): n_round} if n_round else {}
            if name == "dif_quantized":
                want_kernels.update(int8_round_kernel=n_round,
                                    dequant_kernel=n_round * k)
            wire = budget.wire_mesh
        else:
            # the virtual combine is segment sums and whole-block sends:
            # no mixing kernel; a compressed rule refreshes its whole
            # block in one launch a round, and ships it refreshed
            want = {"node_fused_iter": T, "node_task_gram": 1,
                    "gossip_combine": 0, "mix_rows": 0,
                    "compress_topk": n_round if name == "dif_topk" else 0,
                    "dequant": n_round if name == "dif_quantized" else 0}
            want_kernels = ({"int8_round_kernel": n_round,
                             "dequant_kernel": 0}
                            if name == "dif_quantized" else {})
            wire = budget.wire_virtual
        want_sends = n_round * k * wire
        for g in range(n_ranks):
            got = ranks[g][i]["launches"]
            got_k = ranks[g][i]["kernel_launches"]
            require(all(got.get(key, 0) == v for key, v in want.items())
                    and sum(got.get(key, 0) for key in want
                            if key != "node_task_gram") == per_iter * T
                    and (tier == "mesh" or set(got) <= set(want))
                    and all(got_k.get(key, 0) == v
                            for key, v in want_kernels.items()),
                    f"{phase} {label} rank {g}: launches {got}, CUDA "
                    f"launches {got_k}, want {want} and {want_kernels} "
                    f"({per_iter} an iteration by the DispatchBudget)")
            require(ranks[g][i]["sends"] == want_sends,
                    f"{phase} {label} rank {g}: {ranks[g][i]['sends']} "
                    f"sends, want R·K·wire·T_GD = {want_sends}")
        out["gossip_combine_by_program"][name] = hw["launches"].get(
            "gossip_combine", 0)
        if name == "dif_altgdmin":
            out["gossip_combine"] = hw["launches"].get("gossip_combine", 0)
        elif name == "dif_topk":
            out["compress_topk"] = hw["launches"].get("compress_topk", 0)
        elif name == "dif_quantized":
            out["dequant"] = hw["launches"].get("dequant", 0)
            out["dequant_kernels"] = hw["kernel_launches"]
        sim = (sims or {}).get(name) or run_experiment(
            dataclasses.replace(s, substrate="simulator"), key=0,
            materialized=mat)
        sd, sd_sim = hw["sd_max"], sim.sd_max
        ok, diff, first = agree_upto(sd, sd_sim)
        # the iterates themselves, not only their worst subspace distance
        mats = {}
        for field in ("U_nodes", "B_nodes"):
            got_f = hw[field]
            want_f = getattr(sim, field).cpu().numpy()
            if field == "U_nodes" and not prog.stacked:
                # the fusion center's simulator carries one (d, r) iterate
                want_f = np.broadcast_to(want_f, got_f.shape)
            mats[field] = (
                got_f.shape == want_f.shape
                and bool(np.allclose(got_f, want_f, **MESH_TOL)),
                float(np.abs(got_f - want_f).max())
                if got_f.shape == want_f.shape else float("inf"))
        require(sd.shape == (T,) and bool(np.isfinite(sd).all())
                and hw["U_nodes"].shape == tuple(mat.init.U0.shape)
                and bool(np.isfinite(hw["U_nodes"]).all())
                and bool(np.isfinite(hw["B_nodes"]).all()),
                f"{phase} {label}: outputs of the wrong shape or not finite")
        final_rel = abs(float(sd[-1]) - float(sd_sim[-1])) / float(sd_sim[-1])
        timing = {
            "T_GD": T, "ms_per_iter": hw["seconds"] / T * 1e3,
            "stage_ms_per_iter": hw["transport_s"].get("stage_s", 0.0)
            / T * 1e3,
            "wire_ms_per_iter": hw["transport_s"].get("wire_s", 0.0)
            / T * 1e3,
            "sends_per_iter": hw["sends"] / T}
        out["per_program"][name] = timing
        emit(phase, solver=name, knobs=kw,
             system=(dataclasses.asdict(s.system) if s.system is not None
                     else None),
             live_share=(float(s.system.availability_mask(T, L).mean())
                         if s.system is not None else None),
             L=L, ranks=n_ranks, T_GD=T, T_con=s.solver.T_con,
             preset_T_GD=spec.solver.T_GD,
             T_GD_cut=(f"from the preset's {spec.solver.T_GD} to fit the "
                       f"script's time limit" if T != spec.solver.T_GD
                       else None),
             transport=hw["transport"],
             ms_per_iter=timing["ms_per_iter"],
             ms_per_iter_label=f"rank 0, {hw['transport']}",
             stage_ms_per_iter=timing["stage_ms_per_iter"],
             wire_ms_per_iter=timing["wire_ms_per_iter"],
             sends_per_iter=timing["sends_per_iter"],
             **{f"wire_{tier}": wire}, shifts=k,
             dispatch_budget_per_iter=per_iter,
             launches_rank0=hw["launches"],
             kernel_launches_rank0=hw["kernel_launches"],
             first_sd_max=float(sd[0]), final_sd_max=float(sd[-1]),
             sim_final_sd_max=float(sd_sim[-1]),
             final_rel_diff_vs_simulator=final_rel,
             trajectory_held=held,
             sd_max_vs_simulator_max_abs_diff=diff,
             first_parting_iteration=first,
             U_nodes_vs_simulator_max_abs_diff=mats["U_nodes"][1],
             B_nodes_vs_simulator_max_abs_diff=mats["B_nodes"][1],
             spawn_s=spawn_s, **(extra(name) if extra else {}))
        if held:
            if not ok:
                failures.append(f"{label}: sd_max disagrees with the "
                                f"simulator (max abs diff {diff:.3e}, "
                                f"first at {first})")
            for field, (close, err) in mats.items():
                if not close:
                    failures.append(f"{label}: {field} disagrees with the "
                                    f"simulator (max abs diff {err:.3e})")
        elif final_rel > 0.1:
            failures.append(f"{label}: final sd_max {float(sd[-1]):.3e} vs "
                            f"the simulator's {float(sd_sim[-1]):.3e}")
        if not converges:
            continue
        if name not in MESH_SOLVERS and not sd[-1] < sd[0]:
            failures.append(f"{label}: sd_max did not fall, {sd[0]:.3e} → "
                            f"{sd[-1]:.3e}")
        if name == "dif_altgdmin":
            # halving or better over each of two spans of h iterations
            h = min(50, (T - 1) // 2)
            if not (h >= 20 and sd[h] < 0.5 * sd[0]
                    and sd[2 * h] < 0.5 * sd[h]):
                failures.append(f"dif_altgdmin: no geometric decay, sd_max "
                                f"{sd[0]:.3e} / {sd[h]:.3e} / "
                                f"{sd[2 * h]:.3e}")
            if T == 500 and not sd[-1] < 1e-3 * sd[0]:
                failures.append(f"dif_altgdmin did not converge: {sd[0]:.3e}"
                                f" → {sd[-1]:.3e}")
    require(not failures, f"{phase}: " + "; ".join(failures))
    out["spawn_s"] = spawn_s
    return out


def mesh_phase(torch, spec, mat, *, T_GD=MESH_T_GD,
               state_T_GD=MESH_STATE_T_GD, L=20, timeout=MESH_TIMEOUT):
    """Phase 12: all twelve programs on an L-rank gloo mesh on the one
    card, in one spawn, each rank running its node through
    run_experiment(substrate="mesh"): the six stateless ones (T_GD), the
    compressed trio and the masked trio under MASKED_DROPOUT
    (state_T_GD).  Each held against the port's simulator on the card
    under the same schedule; each rank's launches by kernel against the
    program's DispatchBudget, its sends against R·K·wire_mesh.  The
    kernels are built already (phase 2), so ranks only load them.
    Returns rank 0's launches of gossip_combine (dif_altgdmin's run, and
    every program's), compress_topk (dif_topk's) and dequant
    (dif_quantized's, with its CUDA launches by kernel), and each
    program's timings."""
    from repro_torch.api.runner import run_on_mesh
    from repro_torch.distributed.consensus import mesh_weights_from_matrix

    require(spec.problem.L == L, f"the preset has L={spec.problem.L}")
    device = mat.Xg.device.type
    runs, specs = program_runs(spec, T_GD, state_T_GD,
                               own={"dif_altgdmin": MESH_DECAY_T_GD})
    t0 = time.perf_counter()
    ranks = spawn_ranks(run_on_mesh, L,
                        args=(device, [s.to_dict() for s in specs], 0),
                        device=device, timeout=timeout)
    spawn_s = time.perf_counter() - t0
    K = {"W": len(mesh_weights_from_matrix(mat.W)[0]),
         "adj": len(mesh_weights_from_matrix(mat.adj)[0]), "none": 0}
    return hold_programs("mesh", spec, mat, runs, specs, ranks, tier="mesh",
                         K=K, spawn_s=spawn_s)


def virtual_mesh_phase(torch, spec, mat, mesh_out, *, D=VIRTUAL_RANKS,
                       timeout=VIRTUAL_TIMEOUT):
    """Phase 12b: all twelve programs on the virtual-node tier, D gloo
    ranks on the one card each holding a block of L / D nodes, in one
    spawn: dif_altgdmin at the preset's T_GD, the other stateless ones
    at MESH_T_GD, the compressed and masked trios at MESH_STATE_T_GD.
    Held as phase 12 holds them, against the virtual DispatchBudget
    (no gossip_combine, mix_rows or dequant_kernel) and R·K·wire_virtual
    sends, K the cross-rank edge classes; each program's line carries
    phase 12's timings of the same program beside its own (``mesh_*``,
    from ``mesh_out``)."""
    from repro_torch.api.runner import run_on_mesh
    from repro_torch.distributed.consensus import (VirtualTopology,
                                                   neighbor_average_matrix)

    L = spec.problem.L
    require(L % D == 0, f"{D} ranks do not divide L={L}")
    device = mat.Xg.device.type
    runs, specs = program_runs(spec, MESH_T_GD, MESH_STATE_T_GD,
                               own={"dif_altgdmin": spec.solver.T_GD})
    vts = {"W": VirtualTopology.from_weights(mat.W.cpu().numpy(), D),
           "adj": VirtualTopology.from_weights(
               neighbor_average_matrix(mat.adj).cpu().numpy(), D)}
    t0 = time.perf_counter()
    ranks = spawn_ranks(run_on_mesh, D,
                        args=(device, [s.to_dict() for s in specs], 0),
                        device=device, timeout=timeout)
    spawn_s = time.perf_counter() - t0
    K = {"W": len(vts["W"].dev_shifts), "adj": len(vts["adj"].dev_shifts),
         "none": 0}

    def beside(name):
        m = mesh_out["per_program"][name]
        return {"block": L // D, "dev_shifts": list(vts["W"].dev_shifts),
                "dev_shifts_adj": list(vts["adj"].dev_shifts),
                **{f"mesh_{key}": v for key, v in m.items()},
                "mesh_ranks": L, "mesh_spawn_s": mesh_out["spawn_s"]}
    return hold_programs("virtual_mesh", spec, mat, runs, specs, ranks,
                         tier="virtual", K=K, spawn_s=spawn_s, extra=beside)


def sparse_spec(**solver):
    """The reference's scale configuration (SPARSE_L, BA m = 3, sparse
    Metropolis weights; T_GD cut to SPARSE_T_GD) at f32 on the cuda
    backend, solver fields replaced by ``solver``."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec)
    L = SPARSE_L
    return ExperimentSpec(
        problem=ProblemSpec(d=16, T=L, r=2, n=8, L=L, kappa=1.2,
                            dtype="float32"),
        topology=TopologySpec(family="barabasi_albert", ba_m=3, seed=0,
                              weights="metropolis", representation="sparse"),
        init=InitSpec(T_pm=3, T_con=2),
        solver=dataclasses.replace(
            SolverSpec(name="dif_altgdmin", T_GD=SPARSE_T_GD, T_con=3,
                       eta=1e-4), **solver),
        engine=EngineSpec(backend="cuda"))


def sparse_budget(spec, name):
    """A program's launches on the sparse tier: the dense simulator's
    with every mix_rows and gossip_combine launch removed, which is the
    virtual tier's DispatchBudget at K = 0 — (wrapper counts, CUDA
    launches by kernel, launches an iteration)."""
    from repro_torch.core.program import get_program
    from repro_torch.distributed.consensus import get_rule

    prog = get_program(name)
    T, T_con = spec.solver.T_GD, spec.solver.T_con
    steps = spec.solver.local_steps
    R = get_rule(prog.combine).signature(T_con).rounds_per_iter
    n_round = R * T if prog.mixer != "central" else 0
    want = {"node_fused_iter": T * steps, "node_task_gram": 1,
            "mix_rows": 0, "gossip_combine": 0, "node_task_grad_tiles": 0,
            "compress_topk": n_round if name == "dif_topk" else 0,
            "dequant": n_round if name == "dif_quantized" else 0}
    want_kernels = {"fused_resident_kernel": T * steps,
                    "stream_gram_kernel": 1}
    if name == "dif_quantized":             # the whole int8 round
        want_kernels["int8_round_kernel"] = n_round
    per_iter = prog.dispatch_budget.per_iter("virtual", R, 0, steps)
    require(sum(want.values()) - 1 == per_iter * T,
            f"{name}: launches {want} disagree with the DispatchBudget's "
            f"{per_iter} an iteration")
    return want, want_kernels, per_iter


def check_sparse_kernels(torch):
    """node_fused_iter and node_task_gram against their plain versions
    at the scale configuration's shape (L = 100 000 tasks, one a node,
    n = 8, d = 16, r = 2; f32), with their times and bounds
    (compress_topk and the int8 round take the tier's (100 000, 16, 2)
    block in phase 6)."""
    from repro_torch.kernels import _build, altgdmin_ls, ref

    shape = (SPARSE_L, 1, 8, 16, 2)
    L, tpn, n, d, r = shape
    X, U, y = instance(torch, shape, torch.float32, seed=23)
    (B, tiles), fused_kernel = reported(_build, altgdmin_ls.node_fused_iter,
                                        X, U, y)
    e_fused = pair_err(torch, (B, tiles), ref.ref_fused_iter(X, U, y),
                       TOL["float32"], "node_fused_iter sparse")
    (G, c), gram_kernel = reported(_build, altgdmin_ls.node_task_gram,
                                   X, U, y)
    e_gram = pair_err(torch, (G, c), ref.ref_task_gram(X, U, y),
                      TOL["float32"], "node_task_gram sparse")
    require(fused_kernel == {"fused_resident_kernel": 1}
            and gram_kernel == {"stream_gram_kernel": 1},
            f"sparse shape: launched {fused_kernel} and {gram_kernel}")
    tasks = L * tpn
    flops_gram = tasks * (2 * n * d * r + 2 * n * r * r + 2 * n * r)
    flops_fused = flops_gram + tasks * (r ** 3 / 3 + 2 * r * r + 2 * n * r
                                        + 2 * n * d + d * r)
    times = {
        "node_fused_iter": timing(
            torch, altgdmin_ls.node_fused_iter, ref.ref_fused_iter,
            (X, U, y), nbytes(X, U, y, B, tiles), flops_fused),
        "node_task_gram": timing(
            torch, altgdmin_ls.node_task_gram, ref.ref_task_gram, (X, U, y),
            nbytes(X, U, y, G, c), flops_gram)}
    times["node_fused_iter"]["ms_by_ctas_a_task"] = {
        k: device_ms(torch, lambda: altgdmin_ls.node_fused_iter(
            X, U, y, ctas_per_task=k)) for k in (1, 2)}
    for name, e in (("node_fused_iter", e_fused), ("node_task_gram", e_gram)):
        times[name].update(shape=list(shape), max_abs_err=e)
    emit("sparse", part="kernels", timing=times)
    return times


def sparse_phase(torch, programs=SPARSE_FULL_L, *, profile=False):
    """The sparse tier at the reference's scale configuration on the
    simulator: materialize once on the card (no (L, L) array), then
    ``programs`` (of SPARSE_PROGRAMS) on cuda with their launches
    against sparse_budget, each held against torch-ref on the same
    materialization; with ``profile``, dif_altgdmin's run profiled
    (900 000 device events: 40-50 s of the profiler's own).  The peak device
    memory over the phase must stay under SPARSE_MEM_LIMIT.  → (the
    materialization, the launches for the kernels line, the kernels'
    times at the tier's shape, the cuda traces sparse_virtual holds its
    programs against)."""
    import gc
    from repro_torch.api import materialize, run_experiment
    from repro_torch.distributed import consensus
    from repro_torch.distributed.graphs import SparseGraph
    from repro_torch.distributed.mixing import SparseWeights

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    t_phase = time.perf_counter()
    spec = sparse_spec()
    T_GD, T_con = spec.solver.T_GD, spec.solver.T_con
    t0 = time.perf_counter()
    mat = materialize(spec, key=0, device="cuda")
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    W, graph = mat.W, mat.graph
    require(isinstance(W, SparseWeights) and isinstance(mat.adj, SparseGraph),
            f"the sparse tier's materialization holds {type(W).__name__} "
            f"and {type(mat.adj).__name__}")
    t0 = time.perf_counter()
    hoist = consensus._sparse_power(W, T_con)
    power_s = time.perf_counter() - t0
    emit("sparse", part="materialize", L=SPARSE_L, family="barabasi_albert",
         ba_m=3, edges=graph.n_edges, stored_entries=W.nnz,
         padded_entries=int(consensus._sparse_arrays(W)[0].size),
         max_degree=graph.max_degree, density=graph.density,
         power_budget=8 * max(W.nnz, W.n),
         power_declined=hoist is None, power_s=power_s,
         materialize_s=materialize_s)
    kernel_times = check_sparse_kernels(torch)

    launches, failures, traces = {}, [], {}
    reused = {name for name, _, system, _ in SPARSE_VIRTUAL_SOLVERS
              if system is None and name in programs}
    for name, kw, hold in SPARSE_PROGRAMS:
        if name not in programs:
            continue
        s = sparse_spec(name=name, **kw)
        want, want_kernels, per_iter = sparse_budget(s, name)
        trace, trace_ref, got, got_kernels, run_s, ref_s = run_path(
            torch, s, mat, want, want_kernels, name=f"sparse {name}")
        launches[name] = got
        ok, diff, first = agree_upto(trace.sd_max, trace_ref.sd_max)
        final_rel = (abs(trace.final_sd_max - trace_ref.final_sd_max)
                     / trace_ref.final_sd_max)
        U_diff = float((trace.U_nodes.double()
                        - trace_ref.U_nodes.double()).abs().max())
        U_ok = bool(torch.allclose(trace.U_nodes, trace_ref.U_nodes,
                                   **MESH_TOL))
        if name in reused:
            traces[name] = trace
        line = dict(part="program", solver=name, knobs=kw, L=SPARSE_L,
                    T_GD=T_GD, T_GD_cut=f"from the reference's 3 to "
                    f"{T_GD} to fit the script's time limit", T_con=T_con,
                    launches=got, kernel_launches=got_kernels,
                    dispatch_budget_per_iter=per_iter,
                    first_sd_max=float(trace.sd_max[0]),
                    final_sd_max=trace.final_sd_max,
                    torch_ref_final_sd_max=trace_ref.final_sd_max,
                    final_rel_diff_vs_torch_ref=final_rel,
                    held=hold, agrees=ok, U_nodes_agree=U_ok,
                    sd_max_vs_torch_ref_max_abs_diff=diff,
                    first_parting_iteration=first,
                    U_nodes_vs_torch_ref_max_abs_diff=U_diff,
                    run_s=run_s, ms_per_iter=run_s / T_GD * 1e3,
                    torch_ref_run_s=ref_s,
                    torch_ref_ms_per_iter=ref_s / T_GD * 1e3)
        if profile and name == "dif_altgdmin":
            # the runs above found every operand on the card and the
            # W^{T_con} hoist decided (materialize's init and the power
            # line), and nothing compiles, so they are warm: no second
            # run (the JAX bench's reason for one); a profiled third run
            t0 = time.perf_counter()
            prof = profiled(torch, lambda: run_experiment(
                s, key=0, materialized=mat), warm=False)
            line["profile"] = dict(
                seconds=time.perf_counter() - t0,
                iterations=T_GD,
                device_ms_per_iter=prof["device_busy_ms"] / T_GD,
                device_ops_per_iter=prof["device_ops"] / T_GD,
                host_ms_per_iter=prof["wall_ms"] / T_GD,
                device_busy_share=prof["device_busy_share"],
                top_kernels_ms=prof["top_kernels_ms"])
        emit("sparse", **line)
        if hold != "final" and not ok:
            failures.append(f"{name}: sd_max disagrees with torch-ref (max "
                            f"abs diff {diff:.3e}, first at {first})")
        if hold == "iterate" and not U_ok:
            failures.append(f"{name}: U_nodes disagree with torch-ref (max "
                            f"abs diff {U_diff:.3e})")
        if hold == "final" and final_rel > 0.1:
            failures.append(f"{name}: final sd_max {trace.final_sd_max:.3e}"
                            f" vs torch-ref {trace_ref.final_sd_max:.3e}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    emit("sparse", part="memory", peak_mib=peak / 2 ** 20,
         base_mib=base_mb, limit_mib=SPARSE_MEM_LIMIT / 2 ** 20,
         phase_s=phase_s)
    require(peak < SPARSE_MEM_LIMIT,
            f"sparse: peak device memory {peak / 2 ** 30:.2f} GiB, past "
            f"{SPARSE_MEM_LIMIT / 2 ** 30:.0f} GiB")
    require(not failures, "sparse: " + "; ".join(failures))
    return mat, launches, kernel_times, traces


def sparse_auto_phase(torch):
    """The reference's L = 1024 test graph under representation="auto":
    it must take the sparse tier; then every program at SPARSE_AUTO_T_GD
    on cuda against the same spec with representation="dense", with the
    launches of sparse_budget on both (the dense matrix's mixers
    sparsify it, maybe_sparsify)."""
    from repro_torch.api import (EngineSpec, ExperimentSpec, InitSpec,
                                 ProblemSpec, SolverSpec, TopologySpec,
                                 materialize, run_experiment)
    from repro_torch.distributed.mixing import SparseWeights
    from repro_torch.kernels import _build

    L, T_GD = SPARSE_AUTO_L, SPARSE_AUTO_T_GD
    t_phase = time.perf_counter()

    def spec(representation, name="dif_altgdmin", **kw):
        return ExperimentSpec(
            problem=ProblemSpec(d=8, T=L, r=2, n=10, L=L, kappa=1.2,
                                dtype="float32"),
            topology=TopologySpec(family="erdos_renyi", p=6.0 / L, seed=5,
                                  representation=representation),
            init=InitSpec(T_pm=3, T_con=2),
            solver=SolverSpec(name=name, T_GD=T_GD, T_con=3, **kw),
            engine=EngineSpec(backend="cuda"))
    mats = {rep: materialize(spec(rep), key=0, device="cuda")
            for rep in ("auto", "dense")}
    require(isinstance(mats["auto"].W, SparseWeights)
            and torch.is_tensor(mats["dense"].W),
            "sparse_auto: representation='auto' did not take the sparse "
            "tier at L = 1024")
    failures = []
    for name, kw, hold in SPARSE_PROGRAMS:
        traces, launches = {}, {}
        for rep, mat in mats.items():
            s = spec(rep, name, **kw)
            _build.LAUNCHES.clear()
            traces[rep] = run_experiment(s, key=0, materialized=mat)
            launches[rep] = dict(_build.LAUNCHES)
        want = {k: v for k, v in sparse_budget(s, name)[0].items() if v}
        ok, diff, first = agree_upto(traces["auto"].sd_max,
                                     traces["dense"].sd_max)
        final_rel = (abs(traces["auto"].final_sd_max
                         - traces["dense"].final_sd_max)
                     / traces["dense"].final_sd_max)
        emit("sparse_auto", solver=name, knobs=kw, L=L, T_GD=T_GD,
             launches=launches["auto"], launches_dense=launches["dense"],
             first_sd_max=float(traces["auto"].sd_max[0]),
             final_sd_max=traces["auto"].final_sd_max,
             dense_final_sd_max=traces["dense"].final_sd_max,
             final_rel_diff_vs_dense=final_rel, held=hold,
             agrees=ok, sd_max_vs_dense_max_abs_diff=diff,
             first_parting_iteration=first)
        for rep in mats:
            if launches[rep] != want:
                failures.append(f"{name} {rep}: launches {launches[rep]}, "
                                f"want {want}")
        if not all(np.isfinite(t.sd_max).all() for t in traces.values()):
            failures.append(f"{name}: sd_max not finite")
        if hold != "final" and not ok:
            failures.append(f"{name}: sd_max disagrees with the dense "
                            f"representation (max abs diff {diff:.3e})")
        if hold == "final" and final_rel > 0.1:
            failures.append(f"{name}: final sd_max "
                            f"{traces['auto'].final_sd_max:.3e} vs dense "
                            f"{traces['dense'].final_sd_max:.3e}")
    emit("sparse_auto", phase_s=time.perf_counter() - t_phase)
    require(not failures, "sparse_auto: " + "; ".join(failures))


def sparse_arrays(mat) -> dict:
    """A sparse-tier materialization as host arrays for
    ``materialized_from_arrays`` (W by its SparseWeights fields)."""
    W, p, init = mat.W, mat.problem, mat.init
    host = {"Xg": mat.Xg, "yg": mat.yg, "U0": init.U0,
            "R_diag": init.R_diag, "alpha": init.alpha,
            "U_star": p.U_star, "B_star": p.B_star}
    return {**{k: v.cpu().numpy() for k, v in host.items()},
            "W_rows": W.rows, "W_cols": W.cols, "W_vals": W.vals,
            "W_diag": W.diag, "n": W.n, "eta": mat.eta, "mu": p.mu,
            "sigma_max": p.sigma_max, "sigma_min": p.sigma_min}


def sparse_virtual_phase(torch, mat, sims, *, D=SPARSE_VIRTUAL_RANKS,
                         timeout=SPARSE_VIRTUAL_TIMEOUT):
    """The scale configuration on the virtual-node tier: D gloo ranks on
    the one card, each taking the sparse phase's materialization ``mat``
    as host arrays (so every rank starts from the simulator's state
    without running the init at full L again) and running
    SPARSE_VIRTUAL_SOLVERS on its block of L / D nodes from the sparse W
    as it comes.  Held as phase 12b holds its programs (every rank equal
    to rank 0; MESH_TOL against the simulator on ``mat`` — the sparse
    phase's cuda traces ``sims`` where it ran the same spec; dif_topk at
    its final value; the virtual DispatchBudget; R·K·wire_virtual
    sends), without the convergence checks (SPARSE_T_GD at η = 1e-4)."""
    from repro_torch.api import SystemSpec
    from repro_torch.api.runner import run_on_mesh
    from repro_torch.core.program import get_program
    from repro_torch.distributed.consensus import VirtualTopology
    from repro_torch.distributed.mesh import spawn

    t_phase = time.perf_counter()
    base = sparse_spec()
    runs = [(name, kw, system, held, base.solver.T_GD)
            for name, kw, system, held in SPARSE_VIRTUAL_SOLVERS]
    specs = [dataclasses.replace(
        sparse_spec(name=name, **kw), substrate="mesh",
        system=SystemSpec(**system) if system is not None else None)
        for name, kw, system, _, _ in runs]
    require(all(get_program(name).topology == "W"
                for name, *_ in SPARSE_VIRTUAL_SOLVERS),
            "sparse_virtual decomposes W alone")
    vt = VirtualTopology.from_weights(mat.W, D)
    t0 = time.perf_counter()
    ranks = spawn_ranks(run_on_mesh, D,
                        args=("cuda", [s.to_dict() for s in specs], 0,
                              sparse_arrays(mat), "float32"),
                        device="cuda", timeout=timeout)
    spawn_s = time.perf_counter() - t0
    K = {"W": len(vt.dev_shifts)}
    block_mb = (SPARSE_L // D) * base.problem.d * base.problem.r * 4 / 1e6

    def beside(name):
        return {"block": SPARSE_L // D,
                "rank0_setup_s": ranks[0][0]["setup_s"],
                "rank0_runs_s": sum(r["seconds"] for r in ranks[0]),
                "dev_shifts": list(vt.dev_shifts),
                "local_entries": vt.n_local_entries,
                "cross_entries": vt.n_cross_entries,
                "send_mb": block_mb}
    out = hold_programs("sparse_virtual", base, mat, runs, specs, ranks,
                        tier="virtual", K=K, spawn_s=spawn_s, extra=beside,
                        converges=False, sims=sims)
    emit("sparse_virtual", phase_s=time.perf_counter() - t_phase,
         spawn_s=spawn_s)
    return out


def sparse_tier(torch, programs=SPARSE_FULL_L, *, profile=False):
    """The sparse tier's three phases in order: ``sparse`` (over
    ``programs``; dif_altgdmin profiled with ``profile``), ``sparse_auto``,
    ``sparse_virtual`` (the last on the first's materialization).  → (the
    sparse phase's launches by program, the kernels' times at the tier's
    shape)."""
    t0 = time.perf_counter()
    mat, launches, times, traces = sparse_phase(torch, programs,
                                                profile=profile)
    sparse_auto_phase(torch)
    sparse_virtual_phase(torch, mat, traces)
    emit("sparse_tier", seconds=time.perf_counter() - t0)
    return launches, times


def check_serving_kernels(torch):
    """Phase 13: task_gram and task_grad_tiles against their plain
    versions, with their times at each f32 shape (the kernel rows take the
    cohort's, the serving phase's shape)."""
    from repro_torch.kernels import _build, altgdmin_ls, ops, ref

    errs = {"task_gram": 0.0, "task_grad_tiles": 0.0}
    times, by_shape, grad_by_shape = {}, {}, {}
    for sname, (T, n, d, r) in SINGLE_SHAPES.items():
        for dname in ("float32", "bfloat16"):
            X, U, y = (t[0] for t in instance(
                torch, (1, T, n, d, r), getattr(torch, dname), seed=T + n))
            B = torch.randn((T, r), device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(T + n + 1))
            (G, c), gram_kernel = reported(_build, altgdmin_ls.task_gram,
                                           X, U, y)
            gram_ref = ref.ref_single_task_gram(X, U, y)
            e_gram = pair_err(torch, (G, c), gram_ref, TOL[dname],
                              f"task_gram {sname} {dname}")
            require(gram_kernel == {"stream_gram_kernel": 1},
                    f"task_gram {sname} {dname}: launched {gram_kernel}")
            tiles, grad_kernel = reported(
                _build, altgdmin_ls.task_grad_tiles, X, U, B, y)
            require(grad_kernel == {"fused_resident_kernel/grad": 1},
                    f"task_grad_tiles {sname} {dname}: launched "
                    f"{grad_kernel}")
            e_grad = max_err(torch, tiles,
                             ref.ref_single_grad_tiles(X, U, B, y),
                             TOL[dname], f"task_grad_tiles {sname} {dname}")
            timing_ = None
            if dname == "float32":
                errs["task_gram"] = max(errs["task_gram"], e_gram)
                errs["task_grad_tiles"] = max(errs["task_grad_tiles"], e_grad)
                timing_ = {
                    "task_gram": timing(
                        torch, altgdmin_ls.task_gram, ref.ref_single_task_gram,
                        (X, U, y), nbytes(X, U, y, G, c),
                        T * (2 * n * d * r + 2 * n * r * r + 2 * n * r)),
                    "task_grad_tiles": timing(
                        torch, altgdmin_ls.task_grad_tiles,
                        ref.ref_single_grad_tiles, (X, U, B, y),
                        nbytes(X, U, B, y, tiles),
                        T * (2 * n * d * r + 2 * n * r + 2 * n * d + d * r))}
                by_shape[sname] = {"task_gram": timing_["task_gram"]["ms"],
                                   "gram_kernel": gram_kernel}
                grad_by_shape[sname] = {
                    "ms": timing_["task_grad_tiles"]["ms"],
                    "ms_by_ctas_a_task": {
                        c: device_ms(torch, lambda: altgdmin_ls
                                     .task_grad_tiles(X, U, B, y,
                                                      ctas_per_task=c))
                        for c in (1, 2)}}
                if sname == "cohort":
                    times = timing_
                    times["task_grad_tiles"]["cuda_kernel"] = grad_kernel
            emit("serving_kernels", shape=sname, T=T, n=n, d=d, r=r,
                 dtype=dname, max_abs_err={"task_gram": e_gram,
                                           "task_grad_tiles": e_grad},
                 gram_kernel=gram_kernel, grad_kernel=grad_kernel,
                 timing=timing_)
        # the ops on their two routes, f32 and f64 operands
        for dname in ("float32", "float64"):
            X, U, y = (t[0] for t in instance(
                torch, (1, T, n, d, r), getattr(torch, dname), seed=5))
            B = ops.altgdmin_minimize_B(X, U, y, backend="cuda")
            e_min = max_err(
                torch, B, ops.altgdmin_minimize_B(X, U, y,
                                                  backend="torch-ref"),
                TOL["float32"], f"altgdmin_minimize_B {sname} {dname}")
            e_g = max_err(
                torch, ops.altgdmin_gradient(X, U, B, y, backend="cuda"),
                ops.altgdmin_gradient(X, U, B, y, backend="torch-ref"),
                TOL["float32"], f"altgdmin_gradient {sname} {dname}")
            emit("serving_kernels", shape=sname, dtype=dname,
                 max_abs_err={"altgdmin_minimize_B": e_min,
                              "altgdmin_gradient": e_g})
    # task_gram's and task_grad_tiles' rows: beside the cohort's time,
    # each f32 shape's (task_grad_tiles' with its CTAs a task forced)
    times["task_gram"]["by_shape"] = by_shape
    times["task_grad_tiles"]["by_shape"] = grad_by_shape
    return errs, times


def _time_s(torch, fn, reps):
    """Host seconds per call of ``fn`` over ``reps`` calls, ended by a
    device synchronize (one warm call first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def serving_phase(torch, spec, mat, plain):
    """Phase 14: train with checkpoint publishing, hot-swap every
    published U into the serving engine, serve a fixed cohort and a
    closed loop, on the card; ``plain`` is the main phase's unsegmented
    run of the same spec on the same materialization."""
    import tempfile

    from repro_torch.api import run_experiment
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import (HotSwapSource, RequestGenerator,
                                     ServingEngine, pack_requests,
                                     run_closed_loop)

    T_GD, p = spec.solver.T_GD, spec.problem
    steps = list(range(0, T_GD + 1, SERVE_EVERY))
    U_star = mat.problem.U_star
    with tempfile.TemporaryDirectory(prefix="serving_ck_") as ckdir:
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        seg = run_experiment(spec, key=0, materialized=mat,
                             checkpoint_every=SERVE_EVERY,
                             checkpoint_dir=ckdir)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        published = sorted(int(f.split("_")[1]) for f in os.listdir(ckdir))
        require(published == steps,
                f"published steps {published}, want {steps}")
        for field in ("sd_max", "sd_mean", "spread", "time_axis"):
            require(np.array_equal(getattr(seg, field), getattr(plain, field)),
                    f"segmented run: {field} differs from the unsegmented run")
        require(torch.equal(seg.U_nodes, plain.U_nodes),
                "segmented run: final U_nodes differ from the unsegmented run")

        # the drifting cohort, hot-swapped in from every published step
        cohort = RequestGenerator(U_star, t_new=COHORT_T_NEW,
                                  seed=3).generate(COHORT)
        X_list, y_list = [q.X for q in cohort], [q.y for q in cohort]
        theta_star = np.stack([q.theta_star for q in cohort])
        Xp, yp, _ = pack_requests(X_list, y_list, max_batch=COHORT,
                                  dtype=torch.float32, device="cuda")
        # the publications replayed in order into a live directory, which
        # the server's hot-swap reader polls after each one lands
        live = os.path.join(ckdir, "live")
        os.makedirs(live)
        source = HotSwapSource(live, d=p.d, r=p.r, dtype=torch.float32,
                               device="cuda")
        eng, errs, grad_norms, e_routes, e_grad = None, [], [], 0.0, 0.0
        for step in steps:
            name = f"step_{step:09d}"
            shutil.copytree(os.path.join(ckdir, name),
                            os.path.join(live, name))
            got = source.poll()
            require(got is not None and got[0] == step,
                    f"HotSwapSource offered {got and got[0]}, want {step}")
            if eng is None:
                eng = ServingEngine(got[1], max_batch=COHORT, version=step)
            else:
                eng.update_representation(got[1], version=step)
            _, theta, version = eng.solve(X_list, y_list)
            require(version == step, f"served version {version} != {step}")
            th = theta.double().cpu().numpy()
            errs.append(float(np.mean(np.linalg.norm(th - theta_star, axis=1)
                                      / np.linalg.norm(theta_star, axis=1))))
            B_ls = ops.altgdmin_minimize_B(Xp, eng.U, yp)      # task_gram
            g = ops.altgdmin_gradient(Xp, eng.U, B_ls, yp)   # task_grad_tiles
            grad_norms.append(float(torch.linalg.norm(g)))
            # the ops entry point against the engine's fold solve (a
            # consistency check: both launch the same kernel body), and
            # the gradient against its plain route (the kernels' f32
            # tolerance: near the optimum the gradient is a sum of
            # round-off)
            B_eng, _ = eng.solve_packed(Xp, yp)             # node_task_gram
            e_routes = max(e_routes, max_err(
                torch, B_ls, B_eng, SERVE_TOL,
                f"step {step}: task_gram route vs solve_packed"))
            e_grad = max(e_grad, max_err(
                torch, g, ops.altgdmin_gradient(Xp, eng.U, B_ls, yp,
                                                backend="torch-ref"),
                TOL["float32"], f"step {step}: altgdmin_gradient vs its "
                f"plain route"))
        low = [e for e in errs if e < SERVE_ERR_FLOOR]
        require(all(b < a or max(a, b) < SERVE_ERR_FLOOR
                    for a, b in zip(errs, errs[1:]))
                and all(e < SERVE_ERR_PLATEAU * min(errs) for e in low)
                and errs[-1] < 0.75 * errs[0],
                f"the cohort's θ error does not fall at every step down to "
                f"the f32 floor {SERVE_ERR_FLOOR} and stay within "
                f"{SERVE_ERR_PLATEAU}× of its least value there: {errs}")
        require(grad_norms[-1] < 0.1 * grad_norms[0],
                f"the cohort's gradient does not fall: {grad_norms}")

        # the closed loop: calibrate on one ragged full batch, then drive
        gen = RequestGenerator(U_star, t_new=LOOP_T_NEW, seed=11)
        probe = gen.generate(LOOP_BATCH)
        loop_eng = ServingEngine(mat.init.U0[0], max_batch=LOOP_BATCH)
        for t in LOOP_T_NEW:    # one batch per sample bucket: first-call
            warm = RequestGenerator(U_star, t_new=t, seed=10).generate(
                LOOP_BATCH)     # costs stay out of the calibration and loop
            loop_eng.solve([q.X for q in warm], [q.y for q in warm])
        s_batch = _time_s(torch, lambda: loop_eng.solve(
            [q.X for q in probe], [q.y for q in probe]), 10)
        rate = LOOP_LOAD * LOOP_BATCH / s_batch
        gen = RequestGenerator(U_star, t_new=LOOP_T_NEW, rate_hz=rate,
                               seed=12)
        requests = gen.generate(LOOP_N)
        swap = HotSwapSource(ckdir, d=p.d, r=p.r, device="cuda")
        before = _build.LAUNCHES["node_task_gram"]
        report = run_closed_loop(loop_eng, requests,
                                 max_wait_s=LOOP_WAIT * s_batch,
                                 queue_capacity=max(4 * LOOP_BATCH, 16),
                                 swap_source=swap)
        torch.cuda.synchronize()
        loop_launches = _build.LAUNCHES["node_task_gram"] - before
        launches = dict(_build.LAUNCHES)
    rids = [rec.rid for rec in report.records]
    require(len(rids) == len(set(rids))
            and len(rids) + report.n_shed == LOOP_N,
            f"closed loop: {len(rids)} served ({len(set(rids))} distinct) + "
            f"{report.n_shed} shed != {LOOP_N} offered")
    require(loop_launches == len(report.batch_sizes),
            f"closed loop: {loop_launches} node_task_gram launches for "
            f"{len(report.batch_sizes)} batches")
    require({rec.version for rec in report.records} == {T_GD},
            "closed loop: the swap source did not serve the final step")
    want = {"node_fused_iter": T_GD, "mix_rows": T_GD,
            "task_gram": len(steps), "task_grad_tiles": len(steps)}
    require(all(launches.get(k, 0) == v for k, v in want.items()),
            f"serving path launch counts {launches}, want {want}")
    pct = report.latency_percentiles((50, 99))
    span = max(r.t_done for r in report.records) - min(
        r.t_arrival for r in report.records)
    emit("serving", preset=spec.name, dtype="float32", T_GD=T_GD,
         checkpoint_every=SERVE_EVERY, published=published,
         segmented_equals_unsegmented_bitwise=True, train_s=train_s,
         cohort=COHORT, cohort_t_new=COHORT_T_NEW, mean_theta_err=errs,
         cohort_grad_norm=grad_norms,
         task_gram_vs_solve_packed_max_abs_err=e_routes,
         gradient_vs_plain_max_abs_err=e_grad, launches=launches)
    emit("serving_loop", requests=LOOP_N, t_new=list(LOOP_T_NEW),
         max_batch=LOOP_BATCH, batch_s=s_batch, capacity_req_per_s=
         LOOP_BATCH / s_batch, offered_req_per_s=rate,
         served_req_per_s=len(rids) / span,
         max_wait_ms=LOOP_WAIT * s_batch * 1e3,
         p50_latency_ms=pct["p50"] * 1e3, p99_latency_ms=pct["p99"] * 1e3,
         served=len(rids), shed=report.n_shed,
         batches=len(report.batch_sizes),
         mean_batch=float(np.mean(report.batch_sizes)),
         node_task_gram_launches=loop_launches,
         mean_theta_err=report.mean_err,
         clock="host, each batch ended by a device synchronize")
    return launches


def serving_frontier(torch, U):
    """The packed solve's µs per dispatch and per request at a few batch
    sizes, on cuda and on torch-ref, on the card (host clock, ended by a
    device synchronize)."""
    from repro_torch.serving import ServingEngine

    rows = []
    g = torch.Generator(device="cuda").manual_seed(4)
    for batch in FRONTIER_BATCHES:
        X = torch.randn((batch, FRONTIER_T_NEW, U.shape[0]), generator=g,
                        device="cuda")
        y = torch.randn((batch, FRONTIER_T_NEW), generator=g, device="cuda")
        for backend in ("cuda", "torch-ref"):
            eng = ServingEngine(U, max_batch=batch, backend=backend)
            s = _time_s(torch, lambda: eng.solve_packed(X, y),
                        FRONTIER_REPS)
            rows.append({"batch": batch, "backend": backend,
                         "us_per_dispatch": s * 1e6,
                         "us_per_request": s * 1e6 / batch,
                         "req_per_s": batch / s})
    emit("serving_frontier", t_new=FRONTIER_T_NEW, d=int(U.shape[0]),
         r=int(U.shape[1]), rows=rows,
         clock="host, ended by a device synchronize")


# kernel templates by name in the mangled symbols of cuobjdump and ptxas:
# the bf16 flash kernel (DMAX), the three bf16 ssd_scan passes (PMAX,
# NMAX; the state pass by its vector width), the resident
# node_fused_iter kernel and the streaming Gram kernel (dtype, rank
# capacity)
KERNEL_SYMBOL = re.compile(r"(flash_mma_kernel|chunk_state_kernel|"
                           r"state_pass_kernel|chunk_out_kernel|"
                           r"fused_resident_kernel|stream_gram_kernel)"
                           r"I(f|13__nv_bfloat16)?((?:L[ib]\d+E)+)E")
MANGLED_DTYPE = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
# each library's SASS by path, dumped once (sass_texts)
_SASS: dict = {}


def sass_texts(libs) -> None:
    """Dump the SASS of each library of ``libs`` (cuobjdump), all at once,
    into _SASS."""
    from concurrent.futures import ThreadPoolExecutor
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def dump(lib):
        return subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
    todo = sorted({str(lib) for lib in libs} - set(_SASS))
    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        _SASS.update(zip(todo, pool.map(dump, todo)))


def sass_report(_build, lib, source: str) -> dict:
    """{(kernel, template args): {"hmma", "registers", "spill_bytes"}} for
    each instantiation of KERNEL_SYMBOL in the built library: HMMA
    instructions in its SASS (cuobjdump), registers and spill bytes
    (ptxas -v of the build of ``source``).  The template args are its
    dtype's name, where it has a type parameter, then its ints."""
    sass_texts([lib])
    sass = _SASS[str(lib)]

    def key_of(line):
        m = KERNEL_SYMBOL.search(line)
        if not m:
            return None
        dtype = (MANGLED_DTYPE[m[2]],) if m[2] else ()
        return m[1], dtype + tuple(int(v) for v in
                                   re.findall(r"L[ib](\d+)E", m[3]))

    rows, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = key_of(line)
            if key:
                rows[key] = {"hmma": 0}
        elif key and "HMMA" in line:
            rows[key]["hmma"] += 1
    for line in _build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            key = key_of(line)
        elif key in rows and "spill stores" in line:
            n = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            rows[key]["spill_bytes"] = n[1] + n[2]
        elif key in rows and "Used" in line and "registers" in line:
            rows[key]["registers"] = int(line.split("Used")[1].split()[0])
    return rows


def flash_mma_report(_build, lib) -> list[dict]:
    """Each instantiation of the bf16 flash kernel (DMAX 64, 128, 256): its
    HMMA count, registers and spill bytes (sass_report).  Fails unless
    every one runs on the tensor cores and none at D <= 128 spills."""
    rows = sass_report(_build, lib, "flash_attention")
    out = [{"dmax": args[0], **row} for (_, args), row in sorted(rows.items())]
    require(len(out) == 3 and all(r["hmma"] > 0 for r in out),
            f"flash_mma_kernel: want 3 instantiations on the tensor cores, "
            f"got {out}")
    require(all(r.get("spill_bytes") == 0 for r in out if r["dmax"] <= 128),
            f"flash_mma_kernel spills at D <= 128: {out}")
    return out


def ssd_mma_report(_build, lib) -> list[dict]:
    """The bf16 ssd_scan passes: chunk_state_kernel and chunk_out_kernel
    at each (PMAX, NMAX) of 64/128 x 64/128/256, state_pass_kernel at
    its two vector widths, with HMMA count, registers and spill bytes.
    Fails unless the two product passes run on the tensor cores in every
    instantiation and no kernel spills."""
    rows = sass_report(_build, lib, "ssd_scan")
    out = [{"kernel": name, "template": list(args), **row}
           for (name, args), row in sorted(rows.items())]
    mma = [r for r in out if r["kernel"] != "state_pass_kernel"]
    require(len(mma) == 12 and all(r["hmma"] > 0 for r in mma)
            and len(out) == 14,
            f"ssd_scan: want 12 tensor-core instantiations and 2 state "
            f"passes, got {out}")
    require(all(r.get("spill_bytes") == 0 for r in out),
            f"ssd_scan kernels spill: {out}")
    return out


def altgdmin_report(_build, lib, kernel: str) -> list[dict]:
    """``kernel`` (the resident node_fused_iter kernel in its two forms,
    the fused iteration and the gradient for a given B, or the streaming
    Gram kernel in its two forms, U_g's rows in shared memory or read
    through L1) at each dtype and rank capacity (4, 8, 16): registers and
    spill bytes (sass_report).  Fails unless every instantiation is there
    and none at capacity 4 (the main path's, its registers capped for
    five or two CTAs an SM) spills."""
    rows = sass_report(_build, lib, "altgdmin_ls")
    flag = "u_shared" if kernel == "stream_gram_kernel" else "grad_only"
    out = [{"dtype": args[0], "rank_capacity": args[1],
            flag: bool(args[2]), "registers": row.get("registers"),
            "spill_bytes": row.get("spill_bytes")}
           for (name, args), row in sorted(rows.items()) if name == kernel]
    want = 12
    require(len(out) == want,
            f"{kernel}: want {want} instantiations, got {out}")
    require(all(r["spill_bytes"] == 0 for r in out
                if r["rank_capacity"] == 4),
            f"{kernel} spills at rank capacity 4: {out}")
    return out


def ssd_inputs(torch, B, S, H, P, N, dtype):
    """ssd_scan's operands drawn on the card from a seed: x, Bm, Cm normal
    in ``dtype``; dt, A and D as tests/test_kernels.py draws them."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(S + P)
    x = torch.randn((B, S, H, P), generator=g, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda")) * 0.1
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    Bm, Cm = (torch.randn((B, S, N), generator=g, device="cuda").to(dtype)
              for _ in range(2))
    return x, dt, A, Bm, Cm, torch.full((H,), 0.5, device="cuda")


def check_lm_kernels(torch):
    """Phase 15: flash_attention and ssd_scan against their plain
    versions at f32 and bf16; times at each dtype (the kernels line takes
    the main path's shape and dtype, bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, ssd_scan

    errs = {"flash_attention": 0.0, "flash_attention_bf16": 0.0,
            "ssd_scan": 0.0, "ssd_scan_bf16": 0.0}
    times = {}
    peak = {"float32": F32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S}
    for name, B, Sq, Skv, H, Hkv, D, window in FLASH_CASES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            g = torch.Generator(device="cuda").manual_seed(Sq + D)
            q, k, v = (torch.randn(shape, generator=g, device="cuda")
                       .to(dtype) for shape in
                       ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))

            scale = FLASH_SCALE.get(name)

            def kernel(q, k, v):
                return flash_attention.flash_attention(
                    q, k, v, causal=True, window=window, scale=scale)

            def plain(q, k, v):
                return ref.ref_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=True, window=window, scale=scale).transpose(1, 2)

            def library(q, k, v):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)

            out = kernel(q, k, v)
            err = max_err(torch, out, plain(q, k, v), FLASH_TOL[dname],
                          f"flash_attention {name} {dname}")
            key = ("flash_attention" if dname == "float32"
                   else "flash_attention_bf16")
            errs[key] = max(errs[key], err)
            timing_ = None
            if dname in FLASH_TIMED.get(name, ()):
                flops, n_bytes = flash_attention.cost(q, k, v,
                                                      window=window)
                timing_ = timing(
                    torch, kernel, plain, (q, k, v), n_bytes, flops,
                    library if window is None and Sq == Skv else None,
                    flop_per_s=peak[dname],
                    plain_reps=(3 if FLASH_TIMED[name] == ("bfloat16",)
                                else None))
                if name == "qwen3_prefill" and dname == "bfloat16":
                    times["flash_attention"] = timing_
                elif FLASH_TIMED[name] == ("bfloat16",):
                    times.setdefault("flash_attention_shapes", {})[name] = (
                        dict(B=B, S=Sq, H=H, Hkv=Hkv, D=D, scale=scale,
                             dtype=dname, **timing_))
            emit("lm_kernels", kernel="flash_attention", case=name, B=B,
                 Sq=Sq, Skv=Skv, H=H, Hkv=Hkv, D=D, window=window,
                 scale=scale, dtype=dname, max_abs_err=err, timing=timing_)
            del q, k, v, out
    for name, B, S, H, P, N, Q in SSD_CASES:
        for dname in ("float32", "bfloat16"):
            args = ssd_inputs(torch, B, S, H, P, N, getattr(torch, dname))

            def kernel(*a):
                return ssd_scan.ssd_scan(*a, chunk=Q)

            y, h = kernel(*args)
            err = pair_err(torch, (y, h), ref.ref_ssd(*args), SSD_TOL[dname],
                           f"ssd_scan {name} {dname}")
            key = "ssd_scan" if dname == "float32" else "ssd_scan_bf16"
            errs[key] = max(errs[key], err)
            timing_ = None
            if name == "mamba2_prefill":
                flops, n_bytes = ssd_scan.cost(*args)
                timing_ = timing(torch, kernel, ref.ref_ssd, args, n_bytes,
                                 flops, flop_per_s=peak[dname],
                                 plain_reps=3)
                times["ssd_scan" if dname == "bfloat16"
                      else "ssd_scan_f32"] = timing_
            emit("lm_kernels", kernel="ssd_scan", case=name, B=B, S=S, H=H,
                 P=P, N=N, chunk=Q, dtype=dname, max_abs_err=err,
                 timing=timing_)
    return errs, times


def rel_l2(torch, got, want) -> float:
    """||got - want||_2 / ||want||_2 in float64 (NaN if either is not
    finite)."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def fault_readings(torch, module, faults, call, plain, tol, step,
                   want, route_catches_faults=True) -> dict:
    """For each planted fault -- a stand-in for ``module``'s wrapper of
    the same name, swapped in where ``ops`` calls it: whether the kernel
    check (``tol`` against ``plain``, the plain version's output of
    ``call``'s inputs) fails on ``call(fault)``, its worst error there,
    and the relative L2 error of ``step()``'s last-position logits
    against ``want`` with the fault in place.  The real wrapper must pass
    that kernel check (its worst error is ``"kernel"``'s reading).  With
    ``route_catches_faults`` False, the logits are read only for a fault
    the kernel check misses (None for the others)."""
    name = module.__name__.rsplit(".", 1)[-1]
    real = getattr(module, name)
    out = {"kernel": dict(max_abs_err=max_err(
        torch, call(real), plain, tol, f"{name} at the model's shape"))}
    try:
        for fault_name, fault in faults.items():
            err = (call(fault).double() - plain).abs()
            fails = bool((err > tol["atol"] + tol["rtol"] * plain.abs()).any())
            setattr(module, name, fault)
            out[fault_name] = dict(
                kernel_check_fails=fails,
                kernel_max_abs_err=float(err.max()),
                logits_rel_l2=(rel_l2(torch, step(), want)
                               if route_catches_faults or not fails
                               else None))
    finally:
        setattr(module, name, real)
    return out


def flash_fault_readings(torch, step, want, shape=None,
                         route_catches_faults=True) -> dict:
    """Faults planted in the bf16 flash route by a change of the kernel's
    inputs: the diagonal key hidden (kp < qp: Skv one short, so query i
    sits at key i - 1), one key ahead visible (kp <= qp + 1: a zero key
    appended), the KV heads reversed (a wrong GQA map), and scores scaled
    without the log2 e fold (x ln 2); fault_readings at ``shape`` (B, S,
    H, Hkv, D, window, scale; default qwen3's prefill), FLASH_TOL at bf16
    against ref_attention; at one KV head the faults of
    flash_faults_not_planted are left out."""
    from repro_torch.kernels import flash_attention as fa, ref
    real = fa.flash_attention

    def append_zero_key(t):
        return torch.cat([t, t.new_zeros(t[:, :1].shape)], 1)

    faults = {
        "diagonal_hidden": lambda q, k, v, **kw: real(
            q, k[:, :-1], v[:, :-1], **kw),
        "one_key_ahead": lambda q, k, v, **kw: real(
            q, append_zero_key(k), append_zero_key(v), **kw),
        "kv_heads_reversed": lambda q, k, v, **kw: real(
            q, k.flip(2), v.flip(2), **kw),
        "scale_without_log2e": lambda q, k, v, **kw: real(
            q, k, v, **{**kw, "scale": q.shape[-1] ** -0.5 * math.log(2)}),
    }
    if shape is None:
        _, B, S, _, H, Hkv, D, window = FLASH_CASES[0]
        shape = (B, S, H, Hkv, D, window, None)
    B, S, H, Hkv, D, window, scale = shape
    for fault in flash_faults_not_planted(Hkv):
        del faults[fault]
    g = torch.Generator(device="cuda").manual_seed(S + D)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               .to(torch.bfloat16) for shape in
               ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    plain = ref.ref_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), window=window,
                              scale=scale).transpose(1, 2).double()
    return fault_readings(
        torch, fa, faults,
        lambda f: f(q, k, v, causal=True, window=window, scale=scale),
        plain, FLASH_TOL["bfloat16"], step, want, route_catches_faults)


def flash_faults_not_planted(Hkv) -> dict:
    """{fault: why} of LM_BF16_CAUGHT's faults that flash_fault_readings
    leaves out at ``Hkv`` KV heads: at one (granite-20b's MQA) k.flip(2)
    is k, so the KV-head reversal would be no fault, and the kernel check
    at the model's shape against ref_attention holds the head map."""
    return ({"kv_heads_reversed": "one KV head: reversing the KV heads is "
                                  "no change; the kernel check at the "
                                  "model's shape holds the head map"}
            if Hkv == 1 else {})


def ssd_fault_readings(torch, step, want, shape=None,
                       route_catches_faults=True) -> dict:
    """Faults planted in the bf16 ssd_scan route by a change of the
    kernel's inputs: B and C one token ahead (each token paired with the
    next token's B and C, a zero row at the end), A halved (the decay of
    every head too slow), D dropped (no skip term), and the heads of x
    reversed (a wrong head map); fault_readings at ``shape`` (B, S, H,
    P, N, Q; default mamba2-130m's prefill), SSD_TOL at bf16 on y against
    ref_ssd."""
    from repro_torch.kernels import ref, ssd_scan as ss
    real = ss.ssd_scan

    def ahead(t):
        return torch.cat([t[:, 1:], t.new_zeros(t[:, :1].shape)], 1)

    faults = {
        "bc_one_token_ahead": lambda x, dt, A, Bm, Cm, D, **kw: real(
            x, dt, A, ahead(Bm), ahead(Cm), D, **kw),
        "a_halved": lambda x, dt, A, Bm, Cm, D, **kw: real(
            x, dt, A * 0.5, Bm, Cm, D, **kw),
        "d_dropped": lambda x, dt, A, Bm, Cm, D, **kw: real(
            x, dt, A, Bm, Cm, torch.zeros_like(D), **kw),
        "heads_reversed": lambda x, dt, A, Bm, Cm, D, **kw: real(
            x.flip(2), dt, A, Bm, Cm, D, **kw),
    }
    B, S, H, P, N, Q = shape or SSD_CASES[0][1:]
    args = ssd_inputs(torch, B, S, H, P, N, torch.bfloat16)
    plain = ref.ref_ssd(*args)[0].double()
    return fault_readings(
        torch, ss, faults, lambda f: f(*args, chunk=Q)[0], plain,
        SSD_TOL["bfloat16"], step, want, route_catches_faults)


def _lm_tokens(torch, vocab, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=g, device="cuda")


def lm_batch(torch, cfg, B, S, seed) -> dict:
    """A prefill batch of S positions drawn on the card from ``seed``:
    tokens, an audio model's codec tokens (the stub frontend), or a
    vlm's patch embeddings (the stub frontend) and then S - vis_tokens
    tokens."""
    from repro_torch.models.frontends import audio_token_stub, vlm_batch_stub
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.modality == "vlm":
        return vlm_batch_stub(g, B, S, cfg)
    if cfg.modality == "audio":
        return {"tokens": audio_token_stub(g, B, S, cfg)}
    return {"tokens": _lm_tokens(torch, cfg.vocab_size, (B, S), seed)}


def lm_kernel_shapes(cfg, B, S) -> dict:
    """The shapes at which a prefill of B x S calls each LM kernel:
    flash (B, S, H, Hkv, D, window, scale) -- MLA's with V padded to the
    query-key head dim and the scale (dn + dr)^-1/2 --, ssd_scan (B, S,
    H, P, N, Q)."""
    if cfg.attn_impl == "mla":
        D = cfg.nope_head_dim + cfg.rope_head_dim
        flash = (B, S, cfg.n_heads, cfg.n_heads, D, cfg.sliding_window,
                 D ** -0.5)
    else:
        flash = (B, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                 cfg.sliding_window, None)
    return {"flash_attention": flash,
            "ssd_scan": (B, S, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                         cfg.ssm_chunk)}


def last_and_aux(torch, params, batch, cfg):
    """make_prefill_step's function with the aux loss beside it: the
    last position's f32 logits and the MoE load-balance loss."""
    from repro_torch.models import transformer as tfm
    with torch.no_grad():
        x, aux = tfm.hidden_states(params, batch, cfg)
        return tfm.logits_of(params, x[:, -1], cfg), aux


def lm_phase(torch, arch: str, phase: str, want: dict, *, layers=None,
             prefill=LM_PREFILL, gen=LM_GEN, f32_rows=None,
             route_catches_faults=True,
             decode_profile=LM_DECODE_PROFILE) -> tuple[dict, dict]:
    """Phases 16-17b: ``arch`` (cut to ``layers`` where given) at full
    width on the card through its LM kernels, ``want`` the launches of
    one prefill step by kernel.  At f32 on the first ``f32_rows`` rows
    of the prefill batch (all by default): the kernel route against
    torch-ref, last-position logits and the MoE aux loss within LM_TOL;
    teacher-forced decode (``gen``) against the kernel forward.  Then
    the serving copy at bf16, cast in place a leaf at a time: the prefill
    step on the whole batch (the main path's counted run), its route
    against bf16 torch-ref by relative L2, which must reject each planted
    fault of its kernels (with ``route_catches_faults`` False, the fault
    may be caught by the kernel check at the model's shape instead, and
    the route is not read for a fault that check catches), prefill
    tokens/s, decode ms and profiles (``decode_profile`` decode steps);
    the peak device memory
    under the card's.  Returns the launches of the bf16 prefill step by
    wrapper and by ``__global__`` function."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import generate_tokens
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import (
        LanguageModel, count_params, init_params, serving_params)

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    require(n_params == cfg.n_params(),
            f"{arch}: {n_params} parameters, want {cfg.n_params()}")
    B, S = prefill
    batch = lm_batch(torch, cfg, B, S, seed=1)
    rows = {k: v[:f32_rows] for k, v in batch.items()}

    # f32: the kernel route against torch-ref
    model32 = LanguageModel(cfg32, params)
    _build.LAUNCHES.clear()
    last_k, aux_k = last_and_aux(torch, model32.params, rows, cfg32)
    torch.cuda.synchronize()
    launches32 = dict(_build.LAUNCHES)
    require(launches32 == want,
            f"{arch} f32: prefill launches {launches32}, want {want}")
    with ops.backend_scope("torch-ref"):
        last_r, aux_r = last_and_aux(torch, model32.params, rows, cfg32)
    e_route = max_err(torch, last_k, last_r, LM_TOL,
                      f"{arch} f32 prefill: kernel vs torch-ref route")
    e_aux = max_err(torch, aux_k, aux_r, LM_TOL,
                    f"{arch} f32 aux loss: kernel vs torch-ref route")
    require(bool(aux_k > 0) == bool(cfg.n_experts),
            f"{arch}: aux loss {float(aux_k)}")

    # decode: teacher-forced logits against the kernel forward; a MoE's
    # at a capacity at which the forward drops no token
    Bg, prompt_len, n_gen = gen
    prompt = _lm_tokens(torch, cfg.vocab_size, (Bg, prompt_len), seed=2)
    cfg_dec = cfg32 if not cfg.n_experts else dataclasses.replace(
        cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    model_dec = LanguageModel(cfg_dec, params)
    _build.LAUNCHES.clear()
    tokens, stats = generate_tokens(model_dec, prompt, n_gen,
                                    keep_prefill_logits=True)
    gen_launches = dict(_build.LAUNCHES)
    require(not gen_launches, f"{arch}: decode launched {gen_launches}")
    kept = stats.pop("prefill_logits")
    full = model_dec(prompt)
    e_decode = max_err(torch, kept, full, LM_TOL,
                       f"{arch} f32: teacher-forced decode vs kernel forward")
    require(tokens.shape == (Bg, n_gen)
            and int(tokens.max()) < cfg.vocab_size,
            f"{arch}: generated tokens {tuple(tokens.shape)}")
    del full, kept, model32, model_dec, last_r

    # bf16: the serving copy, cast in place a leaf at a time
    serving_params(params, cfg)
    torch.cuda.empty_cache()
    model16 = LanguageModel(cfg, params)
    del params
    prefill16 = make_prefill_step(cfg)
    _build.LAUNCHES.clear()
    _build.KERNEL_LAUNCHES.clear()
    last16 = prefill16(model16.params, batch)
    torch.cuda.synchronize()
    launches16 = dict(_build.LAUNCHES)
    kernel_launches16 = dict(_build.KERNEL_LAUNCHES)
    want16 = {name: n for kernel, n in want.items()
              for name in LM_BF16_KERNELS[kernel]}
    require(launches16 == want and kernel_launches16 == want16,
            f"{arch} bf16: prefill launches {launches16}, CUDA launches "
            f"{kernel_launches16}, want {want} and {want16}")
    require(bool(torch.isfinite(last16).all()) and bool(
        torch.isfinite(last_k).all()), f"{arch}: non-finite logits")
    e_bf16 = float((last16[:f32_rows] - last_k).abs().max())
    # the bf16 route through the tensor-core kernels against the bf16
    # torch-ref route: both round every activation to bf16 and part only
    # inside the kernels (flash rounds P to bf16; ssd_scan rounds M, h_c
    # and x exp(seg - cum) dt), and where a MoE router's top-k parts
    limit = (LM_SSM_BF16_REL_L2 if "ssd_scan" in want else LM_BF16_REL_L2)
    with ops.backend_scope("torch-ref"):
        last16_ref = prefill16(model16.params, batch)
    shapes = lm_kernel_shapes(cfg, B, S)
    readers = {"flash_attention": flash_fault_readings,
               "ssd_scan": ssd_fault_readings}
    faults = {}
    for kernel in want:
        faults[kernel] = readers[kernel](
            torch, lambda: prefill16(model16.params, batch), last16_ref,
            shapes[kernel], route_catches_faults)
    bf16_route = dict(
        rel_l2=rel_l2(torch, last16, last16_ref), limit=limit,
        max_abs_err=float((last16 - last16_ref).abs().max()), faults=faults)
    require(bf16_route["rel_l2"] <= limit,
            f"{arch} bf16 prefill: kernel vs torch-ref route "
            f"{bf16_route} above {limit}")
    # every planted fault must be caught; flash_faults_not_planted names
    # the ones left out at this shape
    not_planted = (flash_faults_not_planted(shapes["flash_attention"][3])
                   if "flash_attention" in want else {})
    required = [(k, f) for k in want for f in LM_BF16_ROUTE[k][1]
                if f not in not_planted]
    caught = [f for _, f in required]
    by_route = {f: (faults[k][f]["logits_rel_l2"] or 0.0) > limit
                for k, f in required}
    by_kernel = {f: faults[k][f]["kernel_check_fails"] for k, f in required}
    blind = [f for f in caught if not by_route[f]
             and (route_catches_faults or not by_kernel[f])]
    require(not blind, f"{arch} bf16: the checks miss the planted faults "
                       f"{blind}: {bf16_route}")
    del last16_ref
    reps = 3
    t1 = time.perf_counter()
    for _ in range(reps):
        prefill16(model16.params, batch)
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t1) / reps
    generate_tokens(model16, prompt[:, :4], 4)            # warm
    _, stats16 = generate_tokens(model16, prompt, n_gen)
    prof_prefill = profiled(torch, lambda: prefill16(model16.params, batch))

    def decode_steps():
        state = model16.init_cache(Bg, decode_profile)
        for i in range(decode_profile):
            _, state = model16.decode_step(state, prompt[:, i % prompt_len:
                                                         i % prompt_len + 1])
    prof_decode = profiled(torch, decode_steps)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    require(peak < total, f"{arch}: peak {peak} bytes, card {total}")
    emit(phase, arch=arch, layers=cfg.n_layers,
         layers_published=get_config(arch).n_layers, params=n_params,
         init_s=init_s, prefill_batch=B, prefill_len=S,
         vis_tokens=cfg.vis_tokens if "vis_embed" in batch else 0,
         f32_rows=last_k.shape[0], launches=launches32,
         f32_kernel_vs_torch_ref_max_abs_err=e_route,
         aux_loss=float(aux_k), aux_kernel_vs_torch_ref_abs_err=e_aux,
         f32_decode_vs_forward_max_abs_err=e_decode,
         decode_capacity_factor=cfg_dec.capacity_factor,
         bf16_launches=launches16, bf16_kernel_launches=kernel_launches16,
         generate=dict(batch=Bg, prompt=prompt_len, gen=n_gen,
                       first_row=tokens[0].tolist()),
         bf16_vs_f32_max_abs_err=e_bf16,
         bf16_kernel_vs_torch_ref=bf16_route,
         faults_caught_by_route=by_route, faults_caught_by_kernel=by_kernel,
         faults_not_planted=not_planted,
         bf16_prefill_s=prefill_s, bf16_prefill_tok_per_s=B * S / prefill_s,
         bf16_teacher_forced_prefill_s=stats16["prefill_s"],
         bf16_decode_ms_per_token=stats16["decode_s"] / n_gen * 1e3,
         bf16_decode_tok_per_s=Bg * n_gen / stats16["decode_s"],
         profile_prefill=prof_prefill,
         profile_decode=dict(steps=decode_profile, **prof_decode),
         peak_memory_gib=peak / 2 ** 30, card_memory_gib=total / 2 ** 30,
         clock="host, ended by a device synchronize")
    del model16
    torch.cuda.empty_cache()
    return launches16, kernel_launches16


def lm_plans_phase(torch) -> dict:
    """Phase 17b: lm_phase for each configuration of LM_PLANS.  Returns
    {arch: (launches of a bf16 prefill step by wrapper, by __global__
    function)}."""
    return {arch: lm_phase(torch, arch, "lm_plans", want, layers=layers,
                           prefill=prefill, gen=LM_PLANS_GEN,
                           f32_rows=LM_PLANS_F32_ROWS,
                           route_catches_faults=False,
                           decode_profile=LM_PLANS_DECODE_PROFILE)
            for arch, layers, prefill, want in LM_PLANS}


def plan_launches(cfg) -> dict:
    """The LM kernels' launches of one forward of ``cfg``, by kernel: one
    flash_attention an attention layer and a zamba group's shared block,
    one ssd_scan an SSM layer."""
    from repro_torch.models.transformer import build_plan
    out = {}
    for seg in build_plan(cfg):
        if seg[0] == "zamba":
            out["ssd_scan"] = out.get("ssd_scan", 0) + seg[1] * seg[2]
            out["flash_attention"] = out.get("flash_attention", 0) + seg[1]
        else:
            name = "flash_attention" if seg[1][0] == "attn" else "ssd_scan"
            out[name] = out.get(name, 0) + seg[2]
    return out


def train_launches(cfg, strategy, n_comm, nodes) -> dict:
    """The launches one fused train step of ``nodes`` nodes makes on the
    card: the LM kernels of a forward once a node, again in the backward
    where remat recomputes each block (a zamba group as one); one
    gossip_combine a communicated leaf a round of the strategy."""
    want = {kernel: nodes * n * (2 if cfg.remat else 1)
            for kernel, n in plan_launches(cfg).items()}
    # t_con 1 (dgd's one neighbour round whatever t_con); allreduce takes
    # the node mean in plain torch, local sends nothing
    if strategy not in ("allreduce", "local"):
        want["gossip_combine"] = n_comm
    return want


def communicated_leaves(params) -> int:
    """The leaves of a node-stacked tree that a strategy communicates
    (all but launch.train's node-local ones)."""
    from repro_torch.distributed.aggregation import _split_local
    from repro_torch.launch.train import LOCAL_PATTERNS
    from repro_torch.utils.trees import tree_leaves
    return sum(tree_leaves(_split_local(params, LOCAL_PATTERNS)))


def train_run(torch, cfg, route, steps, strategy="diffusion", *,
              shape=(TRAIN_NODES, TRAIN_PER_NODE, TRAIN_SEQ), want=None,
              keep=None, keep_last=False):
    """``steps`` steps of launch.train's trainer for ``cfg`` at ``shape``
    (nodes, per-node batch, tokens a sequence) on the kernel route
    ``route``, weights and batches from seed 0: per-node losses, host ms
    of each step (ended by a synchronize), the launches of each step
    (held to ``want`` on cuda, none on torch-ref), and ``keep(state)``
    after each step; with ``keep_last`` also the last state, the step
    function and the last batch (a qwen3 state is ~25 GB: nothing else
    keeps one)."""
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.train import make_trainer

    nodes, per_node, seq = shape
    out = dict(losses=[], ms=[], launches=[], kept=[])
    with ops.backend_scope(route):
        state, step, batch_at = make_trainer(
            cfg, steps=steps, n_nodes=nodes, per_node_batch=per_node,
            seq=seq, aggregation=strategy, device="cuda")
        for i in range(steps):
            batch = batch_at(i)
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses = metrics["loss_per_node"].tolist()
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            launches = dict(_build.LAUNCHES)
            require(launches == (want if route == "cuda" else {}),
                    f"{cfg.name} {strategy} {route} step {i}: launches "
                    f"{launches}, want {want if route == 'cuda' else {}}")
            out["losses"].append(losses)
            out["launches"].append(launches)
            if keep is not None:
                out["kept"].append(keep(state))
    if keep_last:
        out["state"], out["step"], out["batch"] = state, step, batch
    del state
    torch.cuda.empty_cache()
    return out


def losses_agree(a, b, rtol, what) -> float:
    """Worst relative difference of two runs' per-node losses (NaN where
    both are NaN counts as agreement); raises past ``rtol``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    require(bool(np.all(np.isfinite(a) == np.isfinite(b))),
            f"{what}: losses finite on one route only: {a} {b}")
    fin = np.isfinite(a)
    rel = float(np.max(np.abs(a[fin] - b[fin]) / np.abs(b[fin]),
                       initial=0.0))
    require(rel <= rtol, f"{what}: losses {a.tolist()} vs {b.tolist()}, "
                         f"relative {rel:.3e} above {rtol}")
    return rel


def train_prediction(arch, cfg, shape) -> dict:
    """The dry run's reading (launch.dryrun.run_one on a (1, 1) mesh) of
    one fused diffusion step of ``cfg`` at ``shape`` (nodes, per-node
    batch, tokens a sequence): its peak bytes and kernel launches."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import InputShape

    nodes, per_node, seq = shape
    rec = dryrun.run_one(arch, InputShape("train_phase", seq,
                                          nodes * per_node, "train"),
                         mesh=MeshShape(("data", "model"), (1, 1)),
                         cfg=cfg, n_nodes=nodes)
    return dict(peak_gib=rec["memory"]["peak_bytes"] / 2 ** 30,
                launches=rec["kernel_launches"], dry_run_s=rec["lower_s"])


def train_phase(torch) -> dict:
    """Phase 18: the LM trainer on the card, each model of TRAIN_CASES
    through launch.train's parts (make_trainer) on the kernel route and
    on torch-ref, then launch.train.train itself; then the MoE plans'
    backward at smoke width (train_moe_smoke).  Returns, per kernel, the
    launches of one fused diffusion step of each model."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_trainer, train
    from repro_torch.models.transformer import count_params
    from repro_torch.utils.trees import tree_leaves_with_path

    t_phase = time.perf_counter()
    launches_train = {"flash_attention": {}, "ssd_scan": {},
                      "gossip_combine": {}}
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, n_layers, nodes, per_node, seq in TRAIN_CASES:
        t_model = time.perf_counter()
        shape = (nodes, per_node, seq)
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        require(cfg.remat and cfg.remat_policy == "all" and
                cfg.dtype == "bfloat16", f"{arch}: {cfg}")
        grad_limit = (LM_SSM_BF16_REL_L2 if "ssd_scan" in plan_launches(cfg)
                      else LM_BF16_REL_L2)
        predicted = train_prediction(arch, cfg, shape)

        # the first step's gradients, kernel route against torch-ref
        state, _, batch_at = make_trainer(cfg, steps=1, n_nodes=nodes,
                                          per_node_batch=per_node, seq=seq,
                                          device="cuda")
        params, batch = state.params, batch_at(0)
        del state
        n_params = count_params(params) // nodes
        n_comm = communicated_leaves(params)
        want = train_launches(cfg, "diffusion", n_comm, nodes)
        require(predicted["launches"] == want,
                f"{arch}: the dry run's launches {predicted['launches']}, "
                f"derived {want}")
        _build.LAUNCHES.clear()
        _, g_k = steps.node_value_and_grad(params, batch, cfg, nodes)
        torch.cuda.synchronize()
        grad_launches = dict(_build.LAUNCHES)
        want_grad = {k: v for k, v in want.items() if k != "gossip_combine"}
        require(grad_launches == want_grad,
                f"{arch} gradients: launches {grad_launches}, want "
                f"{want_grad}")
        with ops.backend_scope("torch-ref"):
            _, g_r = steps.node_value_and_grad(params, batch, cfg, nodes)
        grads = {}
        for (path, gk), (_, gr) in zip(tree_leaves_with_path(g_k),
                                       tree_leaves_with_path(g_r)):
            per_node_max = [float(gk[i].abs().max()) for i in range(nodes)]
            require(min(per_node_max) > 0
                    and all(map(math.isfinite, per_node_max)),
                    f"{arch}: gradient of {path} is zero or not finite on "
                    f"a node: {per_node_max}")
            grads[path] = dict(rel_l2=rel_l2(torch, gk, gr),
                               min_node_max_abs=min(per_node_max))
            require(grads[path]["rel_l2"] <= grad_limit,
                    f"{arch}: gradient of {path} {grads[path]} past "
                    f"{grad_limit}")
        del params, g_k, g_r, batch, batch_at
        torch.cuda.empty_cache()

        # the timed run: TRAIN_WARM + TRAIN_TIMED diffusion steps, cuda
        # then torch-ref from the same weights and batches
        n_steps = TRAIN_WARM + TRAIN_TIMED
        torch.cuda.reset_peak_memory_stats()
        run_k = train_run(torch, cfg, "cuda", n_steps, shape=shape,
                          want=want, keep_last=True)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        require(peak_gib * 2 ** 30 < total,
                f"{arch}: peak {peak_gib} GiB, card {total / 2 ** 30}")
        prof = profiled(torch, lambda: run_k["step"](run_k["state"],
                                                     run_k["batch"]),
                        warm=False)
        del run_k["state"], run_k["step"], run_k["batch"]
        torch.cuda.empty_cache()
        run_r = train_run(torch, cfg, "torch-ref", n_steps, shape=shape)
        bf16_rel = losses_agree(run_k["losses"], run_r["losses"],
                                TRAIN_LOSS_RTOL, f"{arch} bf16 diffusion")
        timed = run_k["ms"][TRAIN_WARM:]
        step_ms = statistics.median(timed)

        # f32 activations, both routes
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        f32 = [train_run(torch, cfg32, route, TRAIN_F32_STEPS, shape=shape,
                         want=want)
               for route in ("cuda", "torch-ref")]
        f32_rel = losses_agree(f32[0]["losses"], f32[1]["losses"],
                               LM_TOL["rtol"], f"{arch} f32 diffusion")

        # the entry point itself, two steps on the card
        history = None
        if arch == TRAIN_ENTRY:
            _build.LAUNCHES.clear()
            _, history = train(arch, smoke=False, steps=2, n_nodes=nodes,
                               per_node_batch=per_node, seq=seq,
                               n_layers=n_layers, device="cuda")
            entry_launches = dict(_build.LAUNCHES)
            require(entry_launches == {k: 2 * v for k, v in want.items()}
                    and all(map(math.isfinite, history)),
                    f"{arch} launch.train.train: launches "
                    f"{entry_launches}, history {history}")
            torch.cuda.empty_cache()

        for kernel, per_arch in launches_train.items():
            if kernel in want:
                per_arch[arch] = want[kernel]
        emit("train", arch=arch, layers=cfg.n_layers,
             layers_published=get_config(arch).n_layers, params=n_params,
             nodes=nodes, per_node_batch=per_node, seq=seq,
             vis_tokens=cfg.vis_tokens if cfg.modality == "vlm" else 0,
             dtype=cfg.dtype, remat=cfg.remat_policy,
             strategy="diffusion", communicated_leaves=n_comm,
             launches_per_step=want, gradient_launches=grad_launches,
             first_step_gradients=dict(
                 leaves=len(grads), limit=grad_limit,
                 max_rel_l2=max(g["rel_l2"] for g in grads.values()),
                 min_node_max_abs=min(g["min_node_max_abs"]
                                      for g in grads.values()),
                 by_leaf=grads),
             losses_cuda=run_k["losses"], losses_torch_ref=run_r["losses"],
             bf16_loss_max_rel=bf16_rel, f32_losses=[r["losses"]
                                                     for r in f32],
             f32_loss_max_rel=f32_rel, step_ms=run_k["ms"],
             step_ms_torch_ref=run_r["ms"], ms_per_step=step_ms,
             tok_per_s=nodes * per_node * seq / step_ms * 1e3,
             f32_step_ms=[r["ms"] for r in f32], peak_memory_gib=peak_gib,
             peak_memory_gib_predicted=predicted["peak_gib"],
             peak_rel_err_predicted=(predicted["peak_gib"] - peak_gib)
             / peak_gib,
             dry_run=predicted, profile_step=prof,
             train_entry_history=history,
             seconds=time.perf_counter() - t_model,
             clock="host, ended by a device synchronize")
        if arch == "mamba2-130m":
            t_strat = time.perf_counter()
            cut = dataclasses.replace(cfg, n_layers=TRAIN_STRATEGY_LAYERS)
            emit("train_strategies", arch=arch, layers=cut.n_layers,
                 strategies=train_strategies(torch, cut, n_comm),
                 seconds=time.perf_counter() - t_strat)
    for arch, launches in train_moe_smoke(torch).items():
        for kernel, per_arch in launches_train.items():
            if kernel in launches:
                per_arch[f"{arch} smoke"] = launches[kernel]
    emit("train_phase", seconds=time.perf_counter() - t_phase)
    return launches_train


def train_moe_smoke(torch) -> dict:
    """The MoE plans' backward on the card at smoke width (see
    TRAIN_MOE_SMOKE): for each, the first step's per-node losses and
    gradients through the kernels against torch-ref (TRAIN_MOE_TOL), the
    loss's gradient nonzero on every node at every leaf and at every
    expert of each expert stack, the aux loss's own gradient nonzero at
    every router, and TRAIN_MOE_STEPS steps on both routes (losses
    within TRAIN_MOE_TOL's rtol, the derived launches every step).
    Returns {arch: the launches of one step by kernel}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_trainer
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.trees import tree_leaves_with_path

    out = {}
    nodes, per_node, seq = TRAIN_MOE_SHAPE
    for arch in TRAIN_MOE_SMOKE:
        t_model = time.perf_counter()
        cfg = get_config(arch).smoke()
        state, _, batch_at = make_trainer(cfg, steps=TRAIN_MOE_STEPS,
                                          n_nodes=nodes,
                                          per_node_batch=per_node, seq=seq,
                                          device="cuda")
        params, batch = state.params, batch_at(0)
        del state
        want = train_launches(cfg, "diffusion", communicated_leaves(params),
                              nodes)
        _build.LAUNCHES.clear()
        loss_k, g_k = steps.node_value_and_grad(params, batch, cfg, nodes)
        torch.cuda.synchronize()
        grad_launches = dict(_build.LAUNCHES)
        require(grad_launches == {k: v for k, v in want.items()
                                  if k != "gossip_combine"},
                f"{arch} smoke gradients: launches {grad_launches}, want "
                f"{want}")
        with ops.backend_scope("torch-ref"):
            loss_r, g_r = steps.node_value_and_grad(params, batch, cfg, nodes)
        e_loss = max_err(torch, loss_k, loss_r, TRAIN_MOE_TOL,
                         f"{arch} smoke first losses")
        e_grad, experts = 0.0, {}
        for (path, gk), (_, gr) in zip(tree_leaves_with_path(g_k),
                                       tree_leaves_with_path(g_r)):
            e_grad = max(e_grad, max_err(torch, gk, gr, TRAIN_MOE_TOL,
                                         f"{arch} smoke gradient of {path}"))
            require(all(bool(gk[i].abs().max() > 0) for i in range(nodes)),
                    f"{arch} smoke: gradient of {path} zero on a node")
            if "/experts/" in path:
                # (nodes, layers, E, ...): every expert's slice on every node
                per_expert = gk.abs().flatten(3).amax(-1)
                experts[path] = float(per_expert.min())
                require(experts[path] > 0,
                        f"{arch} smoke: an expert of {path} has a zero "
                        f"gradient on some node")

        # the aux loss alone, node 0, through the kernels: its gradient
        # reaches every router
        p0 = steps._node_slices(params, 0,
                                lambda x: x.detach().requires_grad_(),
                                tfm.build_plan(cfg))
        routers = [(p, x) for p, x in tree_leaves_with_path(p0)
                   if p.endswith("router")]
        with torch.enable_grad():
            _, aux = tfm.forward(p0, {k: v[0] for k, v in batch.items()},
                                 cfg)
            aux_grads = torch.autograd.grad(aux, [x for _, x in routers])
        aux_router = {p: float(g.abs().max())
                      for (p, _), g in zip(routers, aux_grads)}
        require(routers and min(aux_router.values()) > 0,
                f"{arch} smoke: the aux loss's gradient at the routers "
                f"{aux_router}")
        del params, p0, g_k, g_r, batch, batch_at

        runs = {route: train_run(torch, cfg, route, TRAIN_MOE_STEPS,
                                 shape=TRAIN_MOE_SHAPE, want=want)
                for route in ("cuda", "torch-ref")}
        rel = losses_agree(runs["cuda"]["losses"],
                           runs["torch-ref"]["losses"],
                           TRAIN_MOE_TOL["rtol"], f"{arch} smoke diffusion")
        out[arch] = want
        emit("train_moe_smoke", arch=arch, layers=cfg.n_layers,
             experts=cfg.n_experts, top_k=cfg.top_k, d_model=cfg.d_model,
             nodes=nodes, per_node_batch=per_node, seq=seq, dtype=cfg.dtype,
             why="one MoE layer's trainer state at published width is "
                 "270-340 GB a replica: no card holds it",
             launches_per_step=want, gradient_launches=grad_launches,
             first_loss_max_abs_err=e_loss, first_grad_max_abs_err=e_grad,
             tol=TRAIN_MOE_TOL, expert_min_grad_abs=experts,
             aux_loss=float(aux.detach()),
             aux_grad_at_router_max_abs=aux_router,
             losses_cuda=runs["cuda"]["losses"],
             losses_torch_ref=runs["torch-ref"]["losses"],
             loss_max_rel=rel, step_ms=runs["cuda"]["ms"],
             seconds=time.perf_counter() - t_model)
        torch.cuda.empty_cache()
    return out


def train_strategies(torch, cfg, n_comm) -> dict:
    """The six other strategies on ``cfg``, TRAIN_STRATEGY_STEPS steps
    each on cuda and on torch-ref: losses within TRAIN_LOSS_RTOL, the
    derived launches; allreduce keeps the communicated leaves of every
    node equal, local lets them part, and after the first step every
    strategy's node-local leaves are the local strategy's on the same
    route (across routes, Adam's ±lr first step flips with the sign of
    near-zero gradients)."""
    from repro_torch.distributed.aggregation import _split_local
    from repro_torch.launch.train import LOCAL_PATTERNS
    from repro_torch.utils.trees import tree_leaves_with_path

    def split(params):
        mask = dict(tree_leaves_with_path(_split_local(params,
                                                       LOCAL_PATTERNS)))
        return ({p: x for p, x in tree_leaves_with_path(params)
                 if mask[p]},
                {p: x.clone() for p, x in tree_leaves_with_path(params)
                 if not mask[p]})

    out, local_after_one = {}, {}
    for strategy in TRAIN_STRATEGIES:
        want = train_launches(cfg, strategy, n_comm, TRAIN_NODES)
        runs = {}
        for route in ("cuda", "torch-ref"):
            run = train_run(torch, cfg, route, TRAIN_STRATEGY_STEPS,
                            strategy, want=want, keep_last=True,
                            keep=lambda st: split(st.params)[1])
            comm, _ = split(run["state"].params)
            same = all(bool(torch.equal(x[0], x[g])) for x in comm.values()
                       for g in range(1, TRAIN_NODES))
            nan_leaves = sorted(p for p, x in comm.items()
                                if not bool(torch.isfinite(x).all()))
            del comm
            if strategy == "allreduce":
                require(same, f"allreduce {route}: replicas parted")
            if strategy == "local":
                require(not same, f"local {route}: replicas equal")
            if strategy == "local":
                local_after_one[route] = run["kept"][0]
            drift = max(float((x - local_after_one[route][p]).abs().max())
                        for p, x in run["kept"][0].items())
            require(drift <= TRAIN_LOCAL_ATOL,
                    f"{strategy} {route}: node-local leaves moved "
                    f"{drift:.3e} from the local strategy's after one step")
            runs[route] = dict(losses=run["losses"], ms=run["ms"],
                               replicas_equal=same, nan_leaves=nan_leaves,
                               local_leaf_drift=drift)
            del run
            torch.cuda.empty_cache()
        require(runs["cuda"]["nan_leaves"] == runs["torch-ref"]["nan_leaves"],
                f"{strategy}: NaN leaves differ by route: {runs}")
        rel = losses_agree(runs["cuda"]["losses"], runs["torch-ref"]["losses"],
                           TRAIN_LOSS_RTOL, f"{cfg.name} {strategy}")
        out[strategy] = dict(launches_per_step=want, loss_max_rel=rel,
                             **{route.replace("-", "_"): r
                                for route, r in runs.items()})
    return out


def _example_key_line(name: str, text: str) -> str:
    """The line of an example's output that carries its result."""
    keys = {"quickstart_torch": "Dif-AltGDmin (paper",
            "distributed_mtrl_torch": "max |U_hw",
            "federated_multitask_torch": "diffusion (T_con",
            "serve_personalize_torch": "closed loop",
            "serve_decode_torch": "qwen3-1.7b",
            "train_lm_torch": "over"}
    lines = [ln for ln in text.splitlines() if keys[name] in ln]
    return lines[-1].strip() if lines else ""


def examples_phase(torch) -> dict:
    """Phase 19: the six port examples on the card (EXAMPLES), with the
    launch counts set to 0 just before and read just after.  → launches
    by kernel."""
    import contextlib
    import io

    from repro_torch.analysis import harness
    from repro_torch.kernels import _build

    # the mesh example's ranks fork from the warm forkserver
    harness.warm_ranks()
    t_phase = time.perf_counter()
    _build.LAUNCHES.clear()
    out, seconds = {}, {}
    for name in EXAMPLES:
        mod = _load_file(f"_example_{name}", ROOT / "examples" / f"{name}.py")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out[name] = mod.main([])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        emit("examples", example=name, seconds=seconds[name],
             key_line=_example_key_line(name, buf.getvalue()),
             result=out[name])
    launches = dict(_build.LAUNCHES)
    sd = out["quickstart_torch"]["final_sd_max"]
    require(sd["dif_altgdmin"] <= EXAMPLE_SD_RATIO
            * sd["centralized_altgdmin"],
            f"quickstart: Dif-AltGDmin {sd['dif_altgdmin']:.3e} against "
            f"centralized {sd['centralized_altgdmin']:.3e}")
    require(sd["dgd_altgdmin"] > EXAMPLE_DGD_FLOOR,
            f"quickstart: DGD reached {sd['dgd_altgdmin']:.3e}")
    mesh = out["distributed_mtrl_torch"]
    require(mesh["max_abs_diff"] <= EXAMPLE_MESH_TOL,
            f"distributed_mtrl: mesh vs simulator {mesh['max_abs_diff']}")
    lm = out["train_lm_torch"]
    require(lm["loss"] < lm["loss0"] and lm["roundtrip_equal"],
            f"train_lm: {lm}")
    errs = out["serve_personalize_torch"]["errs"]
    require(errs[-1] < errs[0], f"serve_personalize: θ errors {errs}")
    dec = out["serve_decode_torch"]
    require(all(v["prefill_vs_decode"] <= LM_TOL["atol"]
                for v in dec.values()), f"serve_decode: {dec}")
    missing = [k for k in EXAMPLE_KERNELS if not launches.get(k)]
    require(not missing, f"examples: no launch of {missing}: {launches}")
    emit("examples_summary", seconds=time.perf_counter() - t_phase,
         seconds_by_example=seconds, launches=launches,
         mesh_rank0_launches=mesh["launches_rank0"])
    return launches


def dryrun_check(torch, phase: str, rec: dict, args, step) -> dict:
    """Phase 20's reading of one configuration: the real ``step(*args)``
    on the card against the dry run's record ``rec``: argument bytes
    exactly, the peak within DRYRUN_PEAK_RTOL, the launches equal; the
    step's host ms (ended by a synchronize) beside the record's roofline
    terms."""
    from repro_torch.kernels import _build
    from repro_torch.utils.trees import tree_leaves

    arg_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    other = torch.cuda.memory_allocated() - arg_bytes   # other phases'
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - other
    del out
    mem = rec["memory"]
    got = dict(
        argument_bytes=arg_bytes,
        argument_bytes_predicted=mem["argument_bytes"], peak_bytes=peak,
        peak_bytes_predicted=mem["peak_bytes"],
        peak_rel_err=(mem["peak_bytes"] - peak) / peak,
        temp_bytes=peak - arg_bytes, temp_bytes_predicted=mem["temp_bytes"],
        other_phases_bytes=other, launches=launches,
        launches_predicted=rec["kernel_launches"], step_ms=step_ms,
        roofline_ms={k: v * 1e3 for k, v in rec["roofline"].items()
                     if k.endswith("_s")},
        flops_predicted=rec["cost"]["flops"],
        bytes_accessed_predicted=rec["cost"]["bytes_accessed"],
        dry_run_s=rec["lower_s"])
    emit("dryrun", config=phase, **got)
    require(arg_bytes == mem["argument_bytes"],
            f"dryrun {phase}: argument bytes {arg_bytes}, predicted "
            f"{mem['argument_bytes']}")
    require(abs(got["peak_rel_err"]) <= DRYRUN_PEAK_RTOL,
            f"dryrun {phase}: peak {peak}, predicted {mem['peak_bytes']}")
    require(launches == rec["kernel_launches"],
            f"dryrun {phase}: launches {launches}, predicted "
            f"{rec['kernel_launches']}")
    return got


def dryrun_phase(torch) -> dict:
    """Phase 20: repro_torch.launch.dryrun on mesh (1, 1) against the
    card, for DRYRUN_PREFILL and DRYRUN_TRAIN."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.launch.train import make_trainer
    from repro_torch.models.transformer import init_params, serving_params

    mesh = MeshShape(("data", "model"), (1, 1))
    out = {}
    arch, B, S = DRYRUN_PREFILL
    cfg = get_config(arch)
    rec = dryrun.run_one(arch, InputShape(f"prefill_{B}x{S}", S, B,
                                          "prefill"), mesh=mesh, cfg=cfg)
    torch.cuda.empty_cache()
    params = serving_params(init_params(cfg, seed=0, device="cuda"), cfg)
    batch = lm_batch(torch, cfg, B, S, seed=1)
    out["prefill"] = dryrun_check(torch, f"{arch} bf16 prefill {B}x{S}",
                                  rec, (params, batch),
                                  make_prefill_step(cfg))
    del params, batch
    torch.cuda.empty_cache()
    arch, layers = DRYRUN_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shape = InputShape("train_phase", TRAIN_SEQ,
                       TRAIN_NODES * TRAIN_PER_NODE, "train")
    rec = dryrun.run_one(arch, shape, mesh=mesh, cfg=cfg,
                         n_nodes=TRAIN_NODES)
    state, step_fn, batch = make_trainer(
        cfg, steps=10, n_nodes=TRAIN_NODES, per_node_batch=TRAIN_PER_NODE,
        seq=TRAIN_SEQ, device="cuda")
    out["train"] = dryrun_check(
        torch, f"{arch} {layers} layers train, {TRAIN_NODES} nodes x "
        f"{TRAIN_PER_NODE} x {TRAIN_SEQ}", rec, (state, batch(0)), step_fn)
    del state, batch
    torch.cuda.empty_cache()
    return out


# (L, M) of mix_rows in --kernel-times: Experiment 1's AGREE operand, then
# tests/test_torch_gpu.py's other shapes
MIX_TIME_SHAPES = ((20, 2400), (100, 1000), (3, 291), (37, 129))


# (L, tpn, n, d, r) of the gradient kernel in --kernel-times beside
# GRAD_SHAPES: tests/test_torch_gpu.py's other shapes (Experiment 1, the
# rank capacity's edge, r = 8 and r = 16, and n = 400, past the resident
# form's shared memory: the two-pass kernel)
GRAD_TIME_SHAPES = {**GRAD_SHAPES, "exp1": SHAPES["exp1"],
                    "edge": (2, 2, 40, 33, 16), "r8": (2, 3, 20, 100, 8),
                    "r16": (2, 3, 16, 600, 16),
                    "two_pass_n400": (2, 2, 400, 600, 4)}


def kernel_times(torch, src: Path, label: str) -> dict:
    """--kernel-times: the device ms of the least-squares, mixing and
    int8 kernels of the port in ``src`` (see the module docstring)."""
    import inspect
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.distributed.consensus import get_rule
    import torch.nn.functional as F
    from repro_torch.kernels import (_build, altgdmin_ls, compress,
                                     flash_attention, gossip_axpy)
    _build.build(("altgdmin_ls", "gossip_axpy", "compress",
                  "flash_attention"))
    times = {"launch_floor": device_ms(torch, lambda: torch.cuda._sleep(0))}
    # the bf16 flash kernel at the LM prefill shapes of phase 15 timed at
    # bf16, beside scaled_dot_product_attention and its bound
    for name, B, Sq, Skv, H, Hkv, D, window in FLASH_CASES:
        if "bfloat16" not in FLASH_TIMED.get(name, ()) or window:
            continue
        g = torch.Generator(device="cuda").manual_seed(Sq + D)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16) for shape in
                   ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
        scale = FLASH_SCALE.get(name)
        flops, n_bytes = flash_attention.cost(q, k, v)
        times[f"flash_attention {name} bfloat16"] = dict(
            ms=device_ms(torch, lambda: flash_attention.flash_attention(
                q, k, v, causal=True, scale=scale)),
            library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True, scale=scale)),
            bound_ms=bound(n_bytes, flops, BF16_FLOP_PER_S)[0])
        del q, k, v
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for L, M in MIX_TIME_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(L)
            W = torch.rand((L, L), generator=g, device="cuda")
            W = W / W.sum(dim=1, keepdim=True)
            Z = torch.randn((L, M), generator=g, device="cuda").to(dtype)
            times[f"mix_rows {L}x{M} {dname}"] = device_ms(
                torch, lambda: gossip_axpy.mix_rows(W, Z))
        for sname, shape in SHAPES.items():
            X, U, y = instance(torch, shape, dtype, seed=0)
            times[f"node_task_gram {sname} {dname}"] = device_ms(
                torch, lambda: altgdmin_ls.node_task_gram(X, U, y))
        for sname, (T, n, d, r) in SINGLE_SHAPES.items():
            X, U, y = (t[0] for t in instance(torch, (1, T, n, d, r), dtype,
                                              seed=0))
            times[f"task_gram {sname} {dname}"] = device_ms(
                torch, lambda: altgdmin_ls.task_gram(X, U, y))
        for sname, shape in GRAD_TIME_SHAPES.items():
            X, U, y = instance(torch, shape, dtype, seed=0)
            B = torch.randn(shape[:2] + shape[4:], device="cuda")
            times[f"node_task_grad_tiles {sname} {dname}"] = device_ms(
                torch, lambda: altgdmin_ls.node_task_grad_tiles(X, U, B, y))
        for sname, (T, n, d, r) in SINGLE_SHAPES.items():
            X, U, y = (t[0] for t in instance(torch, (1, T, n, d, r), dtype,
                                              seed=0))
            B = torch.randn((T, r), device="cuda")
            times[f"task_grad_tiles {sname} {dname}"] = device_ms(
                torch, lambda: altgdmin_ls.task_grad_tiles(X, U, B, y))
        # the int8 wire's round as the tree's refresh runs it on cuda
        rule = get_rule("quantized_gossip")
        for sname, (N, d, r) in ROUND_SHAPES.items():
            g = torch.Generator(device="cuda").manual_seed(N)
            Z = torch.randn((N, d, r), generator=g, device="cuda").to(dtype)
            xhat = (0.5 * torch.randn((N, d, r), generator=g,
                                      device="cuda")).to(dtype)
            ids = torch.arange(N, device="cuda")
            times[f"int8 round {sname} {dname}"] = device_ms(
                torch, lambda: rule.refresh(Z, xhat, ids, 0, backend="cuda",
                                            wire="int8"))
    f32 = torch.float32
    X, U, y = instance(torch, SHAPES["exp1"], f32, seed=0)
    times["node_fused_iter exp1 float32"] = device_ms(
        torch, lambda: altgdmin_ls.node_fused_iter(X, U, y))
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randint(-127, 128, (20, 600, 4), generator=g, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand((20, 1, 1), generator=g, device="cuda") + 1e-3
    times["dequant exp1 float32"] = device_ms(
        torch, lambda: compress.dequant(q, scale))
    # gossip_combine at COMBINE_CASES (the mesh round, the roll form,
    # ragged n, bf16), with the weights on the device
    for name, n, K, dname, _ in COMBINE_CASES:
        z, nbrs, wt = combine_operands(torch, n, K, dname)
        times[f"gossip_combine {name}"] = device_ms(
            torch, lambda: gossip_axpy.gossip_combine(z, nbrs, wt))
    # the gradient form's CTAs a task forced, where the tree has the knob
    if "ctas_per_task" in inspect.signature(
            altgdmin_ls.node_task_grad_tiles).parameters:
        shape = GRAD_SHAPES["exp1_fold"]
        X, U, y = instance(torch, shape, f32, seed=0)
        B = torch.randn(shape[:2] + shape[4:], device="cuda")
        T, n, d, r = SINGLE_SHAPES["cohort"]
        Xs, Us, ys = (t[0] for t in instance(torch, (1, T, n, d, r), f32,
                                             seed=0))
        Bs = torch.randn((T, r), device="cuda")
        for c in (1, 2):
            times[f"node_task_grad_tiles exp1_fold float32 ctas={c}"] = (
                device_ms(torch, lambda: altgdmin_ls.node_task_grad_tiles(
                    X, U, B, y, ctas_per_task=c)))
            times[f"task_grad_tiles cohort float32 ctas={c}"] = device_ms(
                torch, lambda: altgdmin_ls.task_grad_tiles(
                    Xs, Us, Bs, ys, ctas_per_task=c))
    return {"label": label, "src": str(src), "card": nvidia_smi_line(),
            "ms": times, "dif_quantized_profile": quantized_profile(torch)}


# --grad-oracle: the gradient kernel's tasks past the resident form's
# shared memory at f32 (n = 200, the smallest, and n = 400), with
# GRAD_ORACLE_DRAWS seeded B draws each; and the seeded sweep of B over
# tests/test_torch_gpu.py's f32 gradient cases, with the X seed each
# test uses (GRAD_SWEEP_DRAWS draws at Experiment 1's two shapes,
# GRAD_ORACLE_DRAWS at the others)
GRAD_ORACLE_SHAPES = {"two_pass_n200": (2, 2, 200, 600, 4),
                      "two_pass_n400": (2, 2, 400, 600, 4)}
GRAD_SWEEP_CASES = (
    ("kernel_matches_plain exp1", (20, 30, 30, 600, 4), 1),
    ("kernel_matches_plain exp2", (100, 1, 50, 100, 10), 1),
    ("kernel_matches_plain ragged", (3, 5, 20, 97, 3), 1),
    ("kernel_matches_plain edge", (2, 2, 40, 33, 16), 1),
    ("forms_match_plain exp1_fold", (20, 30, 15, 600, 4), 5),
    ("forms_match_plain cohort", (1, 64, 16, 600, 4), 5),
    ("forms_match_plain ragged", (3, 5, 20, 97, 3), 5),
    ("forms_match_plain r8", (2, 3, 20, 100, 8), 5),
    ("forms_match_plain r16", (2, 3, 16, 600, 16), 5),
    ("forms_match_plain two_pass_n200", (2, 2, 200, 600, 4), 5),
    ("forms_match_plain two_pass_n400", (2, 2, 400, 600, 4), 5))
GRAD_ORACLE_DRAWS = 32
GRAD_SWEEP_DRAWS = 256


def grad_oracle(torch, src: Path, label: str) -> dict:
    """--grad-oracle: node_task_grad_tiles of the port in ``src`` and its
    plain version (ref_node_grad_tiles, f32 on the card) each held
    against an f64 oracle of the same inputs; per case the worst of each
    error over the draws, and the worst reading of |kernel − plain|
    against the tests' tolerance (atol + rtol·|plain|, 1e-4 each: > 1 is
    past it) with its draw and the two errors of that draw."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import _build, altgdmin_ls, ref
    _build.build(("altgdmin_ls",))
    tol = TOL["float32"]

    def oracle(X, U, B, y):
        Xd, Bd = X.double(), B.double()
        resid = ((Xd @ U.double()[:, None]) @ Bd[..., None])[..., 0] \
            - y.double()
        return (Xd.mT @ resid[..., None]) * Bd[:, :, None, :]

    def case(shape, x_seed, draws):
        X, U, y = instance(torch, shape, torch.float32, seed=x_seed)
        worst = {"kernel_vs_oracle": 0.0, "plain_vs_oracle": 0.0,
                 "ratio_vs_plain": 0.0, "ratio_vs_oracle": 0.0}
        kernels = {}
        for b_seed in range(draws):
            g = torch.Generator(device="cuda").manual_seed(b_seed)
            B = torch.randn(shape[:2] + shape[4:], generator=g,
                            device="cuda")
            _build.KERNEL_LAUNCHES.clear()
            got = altgdmin_ls.node_task_grad_tiles(X, U, B, y).double()
            kernels.update(_build.KERNEL_LAUNCHES)
            plain = ref.ref_node_grad_tiles(X, U, B, y).double()
            want = oracle(X, U, B, y)
            k_err = float((got - want).abs().max())
            p_err = float((plain - want).abs().max())
            r_plain = float(((got - plain).abs()
                             / (tol["atol"] + tol["rtol"] * plain.abs()))
                            .max())
            r_oracle = float(((got - want).abs()
                              / (tol["atol"] + tol["rtol"] * want.abs()))
                             .max())
            worst["kernel_vs_oracle"] = max(worst["kernel_vs_oracle"],
                                            k_err)
            worst["plain_vs_oracle"] = max(worst["plain_vs_oracle"], p_err)
            worst["ratio_vs_oracle"] = max(worst["ratio_vs_oracle"],
                                           r_oracle)
            if r_plain >= worst["ratio_vs_plain"]:
                worst.update(ratio_vs_plain=r_plain, worst_draw=b_seed,
                             worst_draw_kernel_vs_oracle=k_err,
                             worst_draw_plain_vs_oracle=p_err)
        return {"shape": shape, "x_seed": x_seed, "draws": draws,
                "kernels": kernels, **worst}

    out = {"label": label, "src": str(src), "card": nvidia_smi_line(),
           "oracle": {name: case(shape, 5, GRAD_ORACLE_DRAWS)
                      for name, shape in GRAD_ORACLE_SHAPES.items()},
           "sweep": {name: case(shape, x_seed,
                                GRAD_SWEEP_DRAWS if "exp1" in name
                                else GRAD_ORACLE_DRAWS)
                     for name, shape, x_seed in GRAD_SWEEP_CASES}}
    return out


def quantized_profile(torch, iters: int = 20) -> dict:
    """dif_quantized (int8) at Experiment 1 on cuda, ``iters`` outer
    iterations under torch.profiler (profiled): device operations, device
    ms and host ms an iteration."""
    from repro_torch.api import materialize, run_experiment
    from repro_torch.configs.paper import EXPERIMENT1, to_spec

    spec = to_spec(EXPERIMENT1[0], dtype="float32", backend="cuda")
    spec = dataclasses.replace(spec, solver=dataclasses.replace(
        spec.solver, name="dif_quantized", compression="int8", T_GD=iters))
    mat = materialize(spec, key=0, device="cuda")
    prof = profiled(torch, lambda: run_experiment(spec, key=0,
                                                  materialized=mat))
    return {"device_ops_per_iter": prof["device_ops"] / iters,
            "device_ms_per_iter": prof["device_busy_ms"] / iters,
            "host_ms_per_iter": prof["wall_ms"] / iters}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel-times", action="store_true",
                        help="only time the least-squares and mixing kernels")
    parser.add_argument("--grad-oracle", action="store_true",
                        help="only hold the gradient kernel and its plain "
                             "version against an f64 oracle")
    parser.add_argument("--sparse-tier", action="store_true",
                        help="only build the kernels and run the sparse "
                             "tier's three phases, all twelve programs "
                             "in the first")
    parser.add_argument("--lint", action="store_true",
                        help="only build the kernels and run the lint "
                             "phase")
    parser.add_argument("--train", action="store_true",
                        help="only build the kernels and run the train "
                             "phase (with --lm-plans: both)")
    parser.add_argument("--lm-plans", action="store_true",
                        help="only build the kernels and run the lm_plans "
                             "phase (with --train: both)")
    parser.add_argument("--examples", action="store_true",
                        help="only build the kernels and run the examples "
                             "phase (with --dryrun: both)")
    parser.add_argument("--dryrun", action="store_true",
                        help="only build the kernels and run the dryrun "
                             "phase (with --examples: both)")
    parser.add_argument("--src", type=Path, default=SRC,
                        help="with --kernel-times or --grad-oracle: the src "
                             "directory of the tree to run")
    parser.add_argument("--label", default="this checkout",
                        help="with --kernel-times or --grad-oracle: the name "
                             "of the tree")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = args.src if args.kernel_times or args.grad_oracle else SRC
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: run from the repository root ({src}/repro_torch "
              f"is missing)", file=sys.stderr)
        return 2
    # plain float32 products in full precision on the card (no TF32), so
    # the plain versions are a fair yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.kernel_times:
        print(json.dumps(kernel_times(torch, src, args.label)), flush=True)
        return 0
    if args.grad_oracle:
        print(json.dumps(grad_oracle(torch, src, args.label)), flush=True)
        return 0
    sys.path.insert(0, str(SRC))

    smi = nvidia_smi_line()
    emit("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    if not (args.sparse_tier or args.train or args.lm_plans
            or args.examples or args.dryrun):
        # phase 3b's ranks fork from this server: its imports of torch
        # and the port run beside the kernels' build
        from repro_torch.analysis import harness
        harness.warm_ranks()
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    ptxas = [line.strip() for name in _build.SOURCES
             for line in _build.build_log(name).splitlines()
             if "registers" in line or "spill" in line]
    build_s = time.perf_counter() - t0
    sass_texts(paths[name] for name in ("flash_attention", "ssd_scan",
                                        "altgdmin_ls"))
    emit("build", seconds=build_s, sass_s=time.perf_counter() - t0 - build_s,
         ptxas=ptxas,
         flash_mma_kernel=flash_mma_report(_build, paths["flash_attention"]),
         ssd_kernels=ssd_mma_report(_build, paths["ssd_scan"]),
         fused_resident_kernel=altgdmin_report(
             _build, paths["altgdmin_ls"], "fused_resident_kernel"),
         stream_gram_kernel=altgdmin_report(
             _build, paths["altgdmin_ls"], "stream_gram_kernel"))

    # the launch floor: an empty kernel, timed back to back as the
    # kernels are
    if args.sparse_tier:
        sparse_tier(torch, [name for name, _, _ in SPARSE_PROGRAMS],
                    profile=True)
        return 0
    if args.lint:
        print(json.dumps({"launches_lint": lint_phase(torch)}), flush=True)
        return 0
    if args.train or args.lm_plans:
        if args.lm_plans:
            print(json.dumps({"launches_lm_plans": lm_plans_phase(torch)}),
                  flush=True)
        if args.train:
            print(json.dumps({"launches_train": train_phase(torch)}),
                  flush=True)
        return 0
    if args.examples or args.dryrun:
        if args.dryrun:
            print(json.dumps({"dryrun": dryrun_phase(torch)}), flush=True)
        if args.examples:
            print(json.dumps({"launches_examples": examples_phase(torch)}),
                  flush=True)
        return 0
    launch_floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    emit("launch_floor", ms=launch_floor_ms)
    rows = check_kernels(torch)
    lint_phase(torch)
    spec, mat, launches, trace = main_path(torch)
    profile(torch, spec, mat, label="main")
    slice_errs, slice_timing = check_slice_kernels(torch)
    launches_a = path_a(torch)
    launches_b = path_b(torch, spec, mat)
    launches_masked = masked_phase(torch, spec, mat)
    combine_err, combine_timing = check_gossip_kernel(torch)
    roll_form(torch)
    launches_mesh = mesh_phase(torch, spec, mat)
    virtual_mesh_phase(torch, spec, mat, launches_mesh)
    launches_sparse, sparse_times = sparse_tier(torch)
    single_errs, single_timing = check_serving_kernels(torch)
    launches_serving = serving_phase(torch, spec, mat, trace)
    serving_frontier(torch, trace.U_nodes[0])
    lm_errs, lm_timing = check_lm_kernels(torch)
    dense_launches, _ = lm_phase(torch, "qwen3-1.7b", "lm_dense",
                                 {"flash_attention": 28})
    ssm_launches, ssd_kernel_launches = lm_phase(
        torch, "mamba2-130m", "lm_ssm", {"ssd_scan": 24})
    lm_launches = {**dense_launches, **ssm_launches}
    launches_plans = lm_plans_phase(torch)
    launches_train = train_phase(torch)
    dryrun_phase(torch)
    launches_examples = examples_phase(torch)

    main_row = rows[("exp1", "float32")]
    kernels = []
    for name in ("node_fused_iter", "mix_rows", "node_task_gram"):
        errs = [row["max_abs_err"][name] for key, row in rows.items()
                if key[1] == "float32"]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": max(errs),
                        **main_row["timing"][name]})
    # node_fused_iter's row: beside its time, the resident kernel's with
    # one and with two CTAs a task forced; node_task_gram's its time at
    # path A's fold (501 launches there); mix_rows's beside the launch
    # floor; node_fused_iter's and node_task_gram's also their launches
    # and times at the sparse tier's shape
    kernels[0]["ms_by_ctas_a_task"] = main_row["fused_ms_by_ctas"]
    for row in (kernels[0], kernels[2]):
        row["launches_sparse"] = launches_sparse["dif_altgdmin"][row["name"]]
        row["sparse_shape"] = sparse_times[row["name"]]
    kernels[1]["launch_floor_ms"] = launch_floor_ms
    # mix_rows' launches on the masked phase's dropout runs (a round)
    kernels[1]["launches_masked"] = launches_masked
    kernels[2].update(
        cuda_kernel=main_row["gram_kernel"],
        path_a_fold=rows[("exp1_fold", "float32")]["timing"]["node_task_gram"])
    # node_task_grad_tiles' row: the resident gradient form at path A's
    # fold, with one and two CTAs a task forced and the bf16 time beside;
    # dequant's: the int8 round (int8_round_kernel, the launch on
    # dif_quantized's path) at Experiment 1, its other shapes and the
    # standalone dequant_kernel beside it
    slice_launches = {"node_task_grad_tiles":
                      launches_a["node_task_grad_tiles"], **launches_b}
    for name in ("node_task_grad_tiles", "compress_topk", "dequant"):
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": slice_launches[name],
                        "max_abs_err": slice_errs[name],
                        **slice_timing[name]})
        if name != "node_task_grad_tiles":
            kernels[-1]["launch_floor_ms"] = launch_floor_ms
    # compress_topk's and dequant's rank-0 launches on the mesh beside
    # their path B counts
    kernels[-2]["launches_mesh"] = launches_mesh["compress_topk"]
    kernels[-1]["launches_mesh"] = launches_mesh["dequant"]
    kernels[-2]["launches_sparse"] = launches_sparse["dif_topk"][
        "compress_topk"]
    kernels[-1]["launches_sparse"] = launches_sparse["dif_quantized"][
        "dequant"]
    kernels[-1]["cuda_launches_mesh"] = launches_mesh["dequant_kernels"]
    kernels.append({"name": "gossip_combine", "route": "cuda",
                    "source": SOURCES["gossip_combine"],
                    "replaces": REPLACES["gossip_combine"],
                    "launches": launches_mesh["gossip_combine"],
                    "launches_mesh_by_program":
                        launches_mesh["gossip_combine_by_program"],
                    "launches_train_per_step":
                        launches_train["gossip_combine"],
                    "max_abs_err": combine_err,
                    "launch_floor_ms": launch_floor_ms, **combine_timing})
    for name in ("task_gram", "task_grad_tiles"):
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches_serving[name],
                        "max_abs_err": single_errs[name],
                        **single_timing[name]})
    # flash's row is its bf16 tensor-core kernel, the main path's (times,
    # bound, error); the f32 CUDA-core kernel is another __global__
    # function, whose error rides beside it
    plans = {name: {arch: launches[0].get(name, 0)
                    for arch, launches in launches_plans.items()}
             for name in ("flash_attention", "ssd_scan")}
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": SOURCES["flash_attention"],
                    "replaces": REPLACES["flash_attention"],
                    "launches": lm_launches["flash_attention"],
                    "launches_train_per_step":
                        launches_train["flash_attention"],
                    "launches_lm_plans": plans["flash_attention"],
                    "dtype": "bfloat16",
                    "max_abs_err": lm_errs["flash_attention_bf16"],
                    "max_abs_err_f32_kernel": lm_errs["flash_attention"],
                    "mla_shape": lm_timing["flash_attention_shapes"][
                        "mla_prefill"],
                    "lm_plans_shapes": {
                        name: t for name, t in
                        lm_timing["flash_attention_shapes"].items()
                        if name != "mla_prefill"},
                    **lm_timing["flash_attention"]})
    # ssd_scan's row likewise: the bf16 three-pass tensor-core kernels
    # (their CUDA launches a call, counted over a bf16 prefill step of
    # mamba2-130m), the f32 CUDA-core kernel's error and time beside them
    kernels.append({"name": "ssd_scan", "route": "cuda",
                    "source": SOURCES["ssd_scan"],
                    "replaces": REPLACES["ssd_scan"],
                    "launches": lm_launches["ssd_scan"],
                    "launches_train_per_step": launches_train["ssd_scan"],
                    "launches_lm_plans": plans["ssd_scan"],
                    "cuda_launches_by_kernel_zamba2":
                        launches_plans["zamba2-7b"][1],
                    "dtype": "bfloat16",
                    "cuda_launches_per_call":
                        sum(ssd_kernel_launches.values())
                        / lm_launches["ssd_scan"],
                    "cuda_launches_by_kernel": ssd_kernel_launches,
                    "max_abs_err": lm_errs["ssd_scan_bf16"],
                    "max_abs_err_f32_kernel": lm_errs["ssd_scan"],
                    "f32_kernel_ms": lm_timing["ssd_scan_f32"]["ms"],
                    **lm_timing["ssd_scan"]})
    # each kernel's launches over the six examples (phase 19)
    for row in kernels:
        row["launches_examples"] = launches_examples.get(row["name"], 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
