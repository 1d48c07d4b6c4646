#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
with nvcc, checks them against their plain PyTorch versions on the card,
and drives the port's paths: ``ZMCMultiFunctions(spec,
use_kernel=True).evaluate()`` on the paper's Fig.-1 workload (1200
integrands, five forms, dims 2-4) at 10^6 samples x 10 trials, with the
MC and the Sobol sampler, the integration service
(``repro_torch.service.IntegrationEngine``, also through ``python -m
repro_torch.launch.serve_integrals``) on the launcher's default workload,
on the Fig.-1 spec served as requests (MC and Sobol) and on a full-width
parameter sweep (MC and Sobol), VEGAS-adapted families through
``evaluate`` and adaptive requests through the service, and stratified
sampling (``eval_strata(use_kernel=True)`` and ``ZMCNormal``), the
multi-device path (a mesh of one NCCL rank, then four gloo ranks), the
LM stack's serving path at full width, dense, MoE (MLA), SSM (Mamba-2)
and hybrid models, its training path at full width and depth
(stablelm-3b, mamba2-130m), and its multi-device path (training, expert-
parallel serving and a pipeline on four gloo ranks sharing the card,
qwen2.5-32b served tensor parallel on four ranks, and qwen2-vl-7b served
context parallel on eight, then training with Megatron-SP saves), and
training of the moe, hybrid and encoder families and deepseek-v3-671b's own
recipe (Adafactor, MTP) on one card:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels (one nvcc per source, started together);
3. holds the device Threefry (``zmc_random_bits``) bit-exact against
   ``rng.random_bits`` over 2^20 counters, across the c0 wrap;
4. plans the spec: three dim buckets, nothing left unfused;
5. at N = 65536, holds the fused kernel against ``fused_mc_plain`` on the
   card (s1, s2 within rtol=1e-4, atol=1e-2: f32 sums in another order,
   and FMA contraction in the kernel) and two kernel launches against each
   other by sha256 (the kernel reduces in a fixed order);
6. runs ``evaluate(num_trials=10)`` at N = 10^6 with the launch counters
   reset just before, checks 3 x 10 kernel launches, and the 2-sigma
   coverage of the harmonic families against ``harmonic_analytic``;
7. holds one trial's launches at N = 10^6 (the main path's grid: 62
   chunks per function, a cut last chunk) against the plain version: means
   and standard errors within 1e-2 of a standard error (the raw-sum
   tolerance of step 5 is printed beside it), times both (CUDA events), computes the kernel's
   bound from the operations one trial needs, and reads the instruction
   mix nvcc emitted for pass 1's inner loops (``cuobjdump -sass``) beside
   the main path's registers and instructions per draw and their reference
   values (96, 72.01: the dim-outer loop, 16 draws an iteration);
8. times steady-state trials and profiles one (device busy and idle
   share, host operations by time);
9. rounds: on the Fig.-1 buckets, one R = 4 launch at N = 65536 per round
   with per-block window starts at other depths, one just below 2^32 (the
   rounds cross the u32 wrap): each round's sums sha256-equal to a
   single-round launch at that offset, and within rtol=1e-4, atol=1e-2 of
   the plain version with the same rounds;
10. compactified: d2/d3/d4 buckets of Gaussians over R^d and [0, inf)^d
   mixed with finite families at N = 10^6: kernel vs plain estimates
   within the tolerance of step 7 (the kernel timed over warm launches,
   as in step 7), and 2-sigma coverage >= 0.85 of the Gaussians against
   their analytic values; then the same spec with ``sampler="sobol"``
   (``fused_mc_pass1<1, true, true>``): kernel vs plain raw sums at
   N = 65536 (rtol=1e-4, atol=1e-2) and estimates at N = 10^6 (as step
   14), ``evaluate`` (3 launches, all Sobol and compactified), the same
   coverage gate, and the kernel timed beside its bound (tan-map and
   half-line axes counted as in the MC bound);
11. the service on the launcher's defaults (64 requests, seven families
   at dims 2-4, 16384 samples in rounds of 8192, R <= 8), served
   synchronously, with the pipelined worker thread, and again after a
   restart on the first run's state dir: launches per wave <= buckets,
   no chunked fallback round, zero launches on the warm replay, and the
   three runs' served means sha256-equal; each launch of the synchronous
   run (R = 2 rounds, compactified blocks) held against the plain
   version with the same rounds, window starts and transform columns,
   round by round, within the tolerance of step 7;
12. the service at full width: the Fig.-1 spec as seven requests of 2^20
   samples in rounds of 65536 (16 rounds, R = 8: 2 waves x 3 buckets = 6
   launches), held against ``evaluate(n_samples=2^20)`` (the same
   counters) within 1e-2 of a standard error, with the wall split into
   kernel and host time;
13. the device Sobol points and shifts (``zmc_sobol``) bit-exact against
   ``core.sobol`` on 2^17 indices crossing 2^32, at every dim 1-8, and the
   points as pass 1 walks them (``zmc_sobol_walk``: 256 threads, each
   along its stride-256 run in Gray-code order) on 102400 indices whose
   runs cross 2^32;
14. Sobol on the Fig.-1 spec: kernel vs plain raw sums at N = 65536
   (rtol=1e-4, atol=1e-2), repeat launches and each round of an R = 4
   launch sha256-equal to single launches; ``evaluate(num_trials=10)``
   with ``sampler="sobol"`` at N = 10^6 (30 launches, all Sobol), 2-sigma
   coverage of the harmonics, the median MC-to-Sobol ratio of
   ``trial_std``, and the kernel timed and held against the plain version
   at N = 10^6 within the tolerance of step 7, beside its bound (each
   distinct point counted once) and its pass-1 instantiation's registers,
   resident blocks per SM and SASS instructions per draw;
15. service configuration 3, a parameter sweep: the Fig.-1 4-d harmonic
   template over a 32 x 32 (a, b) grid (16 canonical slices of 64), 2^20
   samples per point in rounds of 65536, R = 8, once per sampler: one
   launch per wave, no fallback, each launch held round by round against
   the plain version with the same rounds, window starts and sweep
   pairs, slice 0's 64 points sha256-equal to per-point families launched
   with the same fn ids and windows, one wave timed against its bound,
   the overlapping prefix sweep a[:16] x b served with 0 launches, and a
   traced run's split of the wall by pipeline stage;
16. service configuration 2 with ``sampler="sobol"`` held against
   ``evaluate(sampler="sobol", n_samples=2^20)``;
17. VEGAS importance grids at the paper's width: 1024 peaked integrands
   (Genz corner peaks 512 x 3-d and 384 x 4-d, 128 narrow Gaussians over
   R^2, compactified), each family's grid fitted on the card in three
   pilot-and-refine epochs; per sampler (MC and Sobol): kernel vs plain
   raw sums at N = 65536 (rtol=1e-4, atol=1e-2), repeat and R = 4 round
   digests, ``evaluate(num_trials=10)`` at N = 10^6 with 30 launches (all
   adapted), 2-sigma coverage >= 0.85 against the exact values, kernel vs
   plain at N = 10^6 within the tolerance of step 7, the kernel timed
   beside its bound and its pass-1 instantiation's registers, resident
   blocks per SM and SASS instructions per draw; then the median
   unadapted-to-adapted ratio of
   ``trial_std`` (MC), which must exceed 1;
18. adaptive requests through the service, the protocol of repro's
   BENCH_10 (``benchmarks/service_bench.py``): a Genz corner peak at
   stderr 5e-5 and narrow Gaussians over R^2 at 5e-4, fixed against
   ``adaptive=True``: >= 5x fewer samples with the pilots charged, >= 1
   refit, estimates within 6 sigma of the exact values and of the fixed
   path; an adapted run abandoned after 3 waves and resumed from its state
   dir sha256-equal to an uninterrupted one with the same stream ids; then
   step 17's 1024 integrands as three adaptive requests: 0 fallback
   rounds and at most 3 launches per wave;
19. stratified sampling: the stratum-moments kernel
   (``kernels/csrc/moments.cu``) on the value matrix of ZMCNormal's dim-8
   initial table (6561 strata x 2048 samples, 53.7 MB) and on a 512 MiB
   matrix, against its plain version and the two-pass formula (count
   exact, mean atol=1e-5, M2 rtol=1e-4) with repeat digests, timed beside
   its HBM bound and ``torch.var_mean``; ``eval_strata(use_kernel=True)``
   (one launch) against the plain path; ``ZMCNormal`` with its defaults
   on an 8-d Genz Gaussian peak, 5 trials, within 4 trial standard
   deviations of the exact value;
20. the multi-device path (``mesh=``): the Fig.-1 evaluate at N = 10^6 x
   10 trials, MC and Sobol, on a (1, 1) mesh of a world-size-1 NCCL group,
   sha256-equal to steps 6 and 14 with 30 launches each, timed beside one
   device in turns (the collectives' cost); then four gloo ranks spawned
   on this card (not scaling: they split it), each holding its launches
   to the CUDA kernel: the (1, 4) mesh's per-function sums sha256-equal to
   the single launch, (4, 1) and (2, 2) raw sums at N = 65538 within the
   ROADMAP's tolerances of one device with n exact and estimates at 10^6
   within 1e-2 of a standard error of steps 6 and 14, one digest over the
   ranks and repeats of (2, 2), an R = 4 sharded launch sha256-equal to 4
   single rounds, service configuration 2 on (2, 2) against step 12,
   ``ZMCNormal`` at dim 8 on (2, 2) (the moments kernel per rank) against
   step 19, ``compressed_psum`` within its int8 bound, and each rank's
   kernel ms for its shard of a Fig.-1 trial (against plain at 65536)
   beside the collectives' ms;
21. a state dir on a mesh and the invariant checker: four gloo ranks on
   this card serve service configuration 2 on the (2, 2) mesh with a state
   dir that rank 0 owns, abandoned after its first wave (no close()) and
   resumed by four new ranks: every launch the CUDA kernel, the resumed
   run only the remaining wave, its estimates sha256-equal to step 20's
   run on every rank, a warm replay with 0 launches, lease.json naming
   only rank 0's pid; each wave's wall beside step 20's, with the time
   in the store's operations, and warm ranks in turns without and with a
   state dir (the journal's cost per wave); then the port's auditor
   (``repro_torch.analysis.streams.audit_state_dir``) over the state dirs
   of steps 11, 18 and 21 (the abandoned journal included; 0 violations
   each, its ms), and
   ``python -m repro_torch.analysis``'s main (the lint and every form's
   contracts) exiting 0;
22. the LM stack's serving path (``repro_torch.launch.serve.Server``, no
   kernel of its own: the products are cuBLAS calls, attention the
   reference's full score rectangle in PyTorch) for stablelm-3b (2.796e9
   parameters stored in f32, served from a bf16 copy) and chatglm3-6b
   (6.244e9 in bf16, GQA 32/2, 2d RoPE) at full width and depth, weights
   from the port's seeded init: 4 requests with 512-token prompts from
   ``concrete_batch``, 64 greedy tokens, a cache of 576.  Gates: (a) at full
   width with 2 layers in f32 (TF32 off), the card's prefill logits and 8
   decode steps against the same weights on the CPU within 5e-3 of the
   largest |logit|, and the greedy tokens equal wherever the top-2 gap
   exceeds that; (b) at full depth in bf16, each block's decode step at
   position 512 against the same block's prefill over 513 positions on the
   same input, and the head on both, the RMS of the difference within 1e-2
   of the prefill's (the free-running logits are printed beside it: the
   seeded model amplifies rounding 2-7 times a layer, so at full depth two
   prefills of 512 and 513 tokens disagree at position 511 as much);
   (c) two ``generate`` calls sha256-equal; (d) no NaN or Inf in any
   logits.  Prints prefill ms, decode ms per step (the first generate's
   64 steps, timed with CUDA events), tokens per second and
   ``torch.cuda.max_memory_allocated``, each time beside its bound (the
   weights' and the full rectangle's operations at 989 TFLOP/s dense bf16,
   the weights' and the cache's bytes at 3.35 TB/s: NVIDIA's H100 SXM data
   sheet) and its share of it;
23. the same serving path for the moe family (``models.mla``, ``models.moe``:
   no kernel of its own either) with step 22's traffic: deepseek-v2-lite-16b
   (15.706e9 parameters in bf16; MLA with kv_lora 512, 26 MoE layers of 64
   experts top-6 and 2 shared) at full width and depth, and deepseek-v3-671b
   at full width with its depth cut to 4 (3 dense layers and 1 MoE layer of
   256 experts top-8, q-lora 1536; 15.797e9 parameters with the mtp
   subtree).  Gates: (a) v2-lite alone, 1 dense and 1 MoE layer in f32 as
   step 22's, with the router's (token, expert) choices compared call by
   call and the smallest k-th to (k+1)-th probability margin printed;
   (b) each block's decode step against its prefill, MoE blocks dropless,
   request by request, in f32 compute on the served bf16 weights within
   1e-2 (the bf16 ratios printed beside it: MLA's absorbed step and its
   expanded prefill round scores of ~1e3 to bf16 differently, as the
   reference's do); (c) and (d) as step 22's.  Prints the same times
   beside the bounds (``lm_bounds`` extended: the latent cache row, MLA's
   score widths, each token's top-k experts, a decode step's distinct
   experts counted from its routing) and the bytes the reference's
   formulation reads per decode step (every expert), the dropped pairs per
   MoE layer of the served prefill at capacity factor 1.25, and a profile
   of four decode steps (device busy share, operations per step);
24. the same serving path for the ssm and hybrid families
   (``models.ssm``: no kernel of its own either) with step 22's traffic:
   mamba2-130m (129.06e6 parameters, 24 Mamba-2 blocks) and zamba2-7b
   (6.751e9 parameters in bf16: 78 Mamba-2 blocks in 13 groups of 6, each
   followed by one shared attention block with a KV cache per invocation,
   then 3 more) at full width, mamba2-130m at full depth and zamba2-7b
   cut to 39 layers (6 groups and 3 more).  Gates: (a) as step 22's, at 2
   layers for mamba2-130m and at 3 for zamba2-7b with the shared block
   after 2; (b) in bf16 as served, every Mamba-2 block and every
   invocation of the shared block; (c) and (d) as step 22's.  Prints the
   same times beside the bounds (``lm_bounds`` extended: the shared block's
   weights read and run at each invocation, the SSD's per-token terms, the
   SSM state and convolution tails read and written by each decode step)
   and a profile of four decode steps; then mamba2-130m's long prompt: one
   request of 32,768 tokens (prefill_32k's length) and 64 new ones, its
   prefill and decode times beside a 512-token request's, the cache's
   bytes of both (they must be equal) and the peak, and its gate at 2
   layers in f32: the decode step at 32,768 against the last logits of a
   prefill over 32,769 within 5e-3 of the largest |logit|;
25. the LM training path (``repro_torch.launch.train``: ``Model.loss``,
   the train step, AdamW, ``TokenStream``, the checkpoint; no kernel of
   its own either; steps 22-24 run under ``torch.no_grad()``, the
   parameters being trainable): stablelm-3b at full width and depth
   (2.796e9 parameters, gradients and AdamW moments in f32, bf16 compute,
   remat "full"), batch 8 x 512 from ``TokenStream`` in 2 microbatches,
   one warm-up step and 3 timed with CUDA events: forward and backward,
   clip, optimizer and step ms, tokens/s and
   ``torch.cuda.max_memory_allocated``, each beside its bound
   (``train_bounds``: 8 N T matmul operations and the score rectangles
   at 989 TFLOP/s, the clip's 12 and the optimizer's 28 bytes a parameter
   at 3.35 TB/s), and one step profiled; gate (a) at full width and 2
   layers in f32 (TF32 off), one step of 2 x 64 in 2 microbatches on the
   card against the same weights on the CPU: the loss within 1e-4, the
   gradient norm within 1e-3, each leaf's gradient within 1e-2 relative
   RMS, the parameters within 1e-3; then mamba2-130m at full width, cut
   to 8 of its 24 layers, with ``examples/train_lm.py``'s settings (batch 8 x 256, 2
   microbatches): its step timed beside its bound and profiled; gate (b)
   6 uninterrupted steps against a run that checkpoints every 3 steps,
   fails at step 4 and resumes: the losses of steps 3-5 equal and the
   final parameters, moments and step sha256-equal (the train step runs
   under ``torch.use_deterministic_algorithms(True)``, with cuBLAS's
   workspace set at the script's start), the checkpoint's save and
   restore timed with its bytes; gate (c) 6 steps on one fixed batch
   (lr 1e-3, warmup 2), the last loss below the first, the trajectory
   printed; gate (d) every loss and gradient norm finite;
26. the LM multi-device path (``repro_torch.distributed.{sharding, fsdp,
   elastic, pipeline}``, ``train_loop(mesh=)``, the MoE island,
   ``Server(mesh=)``; no kernel of its own): one ``multihost.spawn`` of
   four gloo ranks sharing the card, the one-device references run first.
   (a) stablelm-3b at full width, 2 of 32 layers, in f32 (TF32 off),
   step 25's AdamW, batch and microbatches, on (data, model) = (2, 2): 3
   uninterrupted steps, 2 timed (step ms, the collectives' ms inside it,
   tokens/s, each rank's peak); gate (a1) the mesh's first 2 steps in
   f64 (every f32 upcast of the model kept at f64) against 2 on one
   device in f64 in the mesh's pieces of rows (4 microbatches of 2 rows)
   with step 25's gate (a) tolerances (every loss and grad_norm, each
   leaf's gradient after step 2, the parameters); the f32 run's 2 steps
   against one device's in f32, in the mesh's rows and in step 25's 2
   microbatches, printed beside it (tensor parallelism sums the row-split
   products in another order, which the seeded model amplifies as another
   microbatching does), and the f32 step-1 witness; gate (a3) each rank's resident
   state bytes and one step's collectives (kind, count, bytes) equal to
   ``launch.dryrun``'s derivation; gate (a2) the run checkpointing at
   step 2 and failing in step 3, resumed on (2, 2): its losses and final
   state sha256-equal to the uninterrupted run's, and the checkpoint
   restored on (4, 1) and on one device sha256-equal to its files.
   (b) deepseek-v2-lite-16b at full width, 3 of its 27 layers, on (1,
   4), 16 of 64 experts a rank, step 23's prompts and cache: gate (b1) at
   depth 3,
   dropless and in f32, prefill and 8 decode steps within 5e-3 of the
   largest |logit| of one device's; gate (b2) at the served capacity in
   bf16, two generates of 16 tokens sha256-equal on every rank, the dropped pairs per MoE layer
   printed beside one device's; gate (b3) the all-to-all bytes per MoE
   layer of a prefill and a decode step equal to the derivation; prefill
   and decode ms, the all-to-all ms of a decode step, tokens/s and each
   rank's peak.  (c) four stablelm-3b blocks at full width along a pod
   axis, 8 microbatches of 1 x 512, f32: within 1e-5 of the largest
   |output| of the blocks run in sequence on one rank (the bits compared),
   each rank's wall and idle share beside the schedule's bubble
   (P-1)/(M+P-1).  Every phase runs tensor parallel over ``model`` (heads,
   MLP width, vocab; the decode caches split along the sequence);
27. qwen2.5-32b served at full width and depth (64 layers, 32.8e9
   parameters, 65.5 GB in bf16) on (data, model) = (1, 4): four gloo
   ranks sharing the card, each holding its quarter of the heads, MLP
   width and vocab (16.4 GB) and its quarter of the cache's positions
   (flash-decoding over ``model``), step 22's request (4 x 512-token
   prompts, cache 576): gate (d1) at depth 4, prefill and 8 decode steps
   fed one device's tokens, computed in f64 within 5e-3 of the largest
   |logit| of one device's in f64 (run first), and in f32 (TF32 off) as
   far from one device's f64 as one device's own f32 is, within 2x: the
   seeded model amplifies f32 rounding, which tensor parallelism
   reorders; gate (d2) 8 greedy tokens from ``Server.generate`` and from
   its prefill and decode steps written out (each timed) sha256-equal on
   every rank; gate (d3) each rank's resident parameter and cache bytes
   equal to ``dryrun.cell_bytes``' argument bytes and a decode step's
   collectives (kind, count, bytes) equal to ``serve_collectives``;
   prefill and decode ms, tokens/s, each rank's peak and the init's peak
   (step 26 cut in depth so that step 28 fits the time limit);
28. context parallelism and Megatron-SP saves on the LM mesh (no kernel of
   their own): (e) qwen2-vl-7b at full width (28 heads on 4 KV heads: on
   8 ranks the reference's q-sequence case, each rank's query rows against
   the whole K/V) in bf16 on (data, model) = (1, 8), eight gloo ranks
   sharing the card, step 22's request as the VLM's concrete batch (vision
   embeddings, M-RoPE positions): gate (e1) at depth 2, prefill and 8
   decode steps fed one device's tokens, in f64 within 5e-3 of the largest
   |logit| of one device's f64 run (f32 printed beside it); the served
   model cut to 7 of its 28 layers: gate (e2) two ``Server.generate`` runs
   of 4 greedy tokens sha256-equal on every rank; gate (e3) each rank's
   resident parameter and cache bytes equal to ``cell_bytes``, a
   prefill's and a decode step's collectives equal to
   ``serve_collectives`` and the q-sequence scores' constraint checked
   once a layer per prefill; prefill and decode ms (the second generate's,
   each with its greedy pick), the collectives' ms, tokens/s, each rank's
   peak.  (f) step 26 (a)'s stablelm-3b run with ``sp_activations`` on
   (2, 2), run by step 26's four ranks after (c) (the same mesh: no spawn
   of its own), printed here: gate (f1) 2 steps in f64 against one device in the
   mesh's rows at step 25's tolerances (f32 printed beside it); gate (f2)
   the carry each entry's remat saves per microbatch (counted by
   ``saved_tensors_hooks``) 5,242,880 bytes a rank, half of it without
   SP; gate (f3) one step's collectives equal to ``train_collectives``;
   the step ms beside step 26 (a)'s;
29. the example scripts (``examples/{quickstart, harmonic_modes,
   boltzmann_collision, service_quickstart}_torch.py``) run as a user runs
   them, through their ``main`` on the card at their own defaults, and
   ``harmonic_modes --full --use-kernel``; gates: (g1) each script's own
   asserts; (g2) quickstart's and boltzmann's users' own integrands (the
   chunked engine, no kernel) at 2^14 samples x 2 trials on the card
   against the CPU, raw sums within rtol=5e-5, atol=5e-3 and estimates
   within 1e-2 of a standard error; (g3) the paper's Fig. 1 through the
   fused kernel (100 modes, 10^6 x 10, 10 launches) with 2-sigma coverage
   at least 0.85, its seconds per trial printed; (g4) the service tour's
   launch counts as the reference script prints them (cold 2, warm 0,
   top-up 1, infinite domain 1 with no fallback round, sweep 1, sweep
   top-up 1); (g5) one timed trial of the Boltzmann graphs over 512 beams
   (1024 integrands of dim 3, 10^6 samples, ``use_kernel=False``), its
   first chunks profiled;
30. LM training of the other families on one card (no kernel of its own;
   step 25's train step, batch 8 x 512, tolerances, f32 parameters, bf16
   compute, remat "full"): (h) deepseek-v2-lite-16b at 3 of 27 layers (1
   dense, 2 MoE of 64 experts), AdamW, capacity factor 1.25: gate (h1) at 2
   layers card vs CPU in f32, dropless, the router's choices compared call
   by call; gate (h2) a plain run of the timed run's 4 steps from one seed
   sha256-equal to the timed run under deterministic mode, the dropped
   pairs per MoE layer; (i) zamba2-7b at 13 of 81 layers: gate (i1) in f64
   at 2 layers with the shared block run twice (loss 1e-11, grad_norm
   1e-8, each leaf's gradient, the shared block's summed ones by name,
   1e-7, parameters 1e-5), and its f32 witness (the card's f32 gradients
   from the CPU's f64 ones within 2x the CPU's own f32 ones); (j)
   deepseek-v3-671b's own recipe (Adafactor, 4 microbatches, the MTP
   loss) cut to its 3 dense layers (a MoE stage of none): gate (j1) at 1
   dense layer and the MTP block, one step of 4 x 64 in 4 microbatches,
   loss, ce and mtp each; (k) hubert-xlarge at 48
   layers (frames, bidirectional, the same-position loss): gate (k1) at 2
   layers; gate (k2) at 4 layers, Adafactor with int8 compression, a run
   crashed in step 4 and resumed from step 3 sha256-equal to 6 steps
   uninterrupted, a saved and restored state equal; gate (k3) one step's
   gradients and residuals through ``compress_tree`` equal bit for bit on
   the card and on the CPU; for each, one warm-up step, 3 timed beside
   ``train_bounds`` (top-k experts, the shared block per invocation, the
   MTP head; Adafactor's bytes), the peak, one profiled step, every loss
   finite and every grad_norm finite or past the f32 sum of squares'
   range with every gradient element finite (hubert-xlarge's seeded 48
   layers, whose timed steps then apply no gradient: a cost measurement);
   the gates' CPU halves with the host's denormals flushed;
   then prints each step's seconds (each step also prints its own as it
   ends), the ``{"kernels": [...]}`` line,
   one entry per kernel variant (the Sobol sweep's launches as
   ``fused_mc_sobol_swept``, the adapted Sobol ones as
   ``fused_mc_sobol_adapted``, a rank's shard on the (2, 2) mesh as
   ``fused_mc_sharded``) and the stratum-moments kernel.

Every path is driven with the kernel's launch counters set to 0 just
before it and read just after; a variant the path should run and did
not fails the script.  Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# step 25's train step runs in deterministic mode, which asks for cuBLAS's
# fixed workspace configuration before the first cuBLAS call (steps 7-24
# make cuBLAS calls); on Hopper this is PyTorch's default size, 32 MiB
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

N_CHECK = 65536          # samples per function for the first kernel-vs-plain check
N_MAIN = 10**6           # the paper's protocol: 10^6 samples x 10 trials
TRIALS = 10
TIMING_REPS = 5
RTOL, ATOL = 1e-4, 1e-2  # kernel vs plain on raw sums (f32 order, FMA contraction)
# Kernel vs plain at N_MAIN, on the estimates: each mean and standard error
# within this fraction of the plain standard error.  One 16384-sample chunk
# drawn with other counters, lost, doubled or not cut at n_valid moves a
# mean by about sqrt(16384 / 10^6) = 0.13 standard errors, so the worst of a
# bucket's functions lands far past the limit; f32 rounding stays well under.
EST_TOL = 1e-2

# The least work of one draw (one Threefry-2x32 first word per function,
# sample and dim), with what is the same for every sample of a (function,
# dim) left out: x1 = c1 + k1 and round 1's rotate of it.  Rounds 1-20
# each add; the x0 key injections after rounds 4, 8, 12 and 16 fold into
# the next round's add (one three-input IADD3); the x1 injections after
# rounds 4-16 are 4 adds and the last x0 injection 1; round 20's rotate and
# xor feed only the unused second word.
TF_ADDS = 20 + 4 + 1          # the ALU pipe (IADD3) or the FMA pipe (IMAD) takes them
TF_ALU_ONLY = 18 + 19 + 1     # rotates (rounds 2-19), xors (rounds 1-19), >> 8
CONV_PER_DRAW = 1             # u32 -> f32
FP32_PER_DRAW = 3             # the 2^-24 scale, the affine map, the body's step
FP32_PER_VALUE = 30           # the body's finish (cos/sin/exp/log) and the sums
# Per clock per SM on Hopper (CUDA C++ Programming Guide, throughput of
# arithmetic instructions, compute capability 9.0): 32-bit integer add,
# logic and shift 64 (ALU pipe), 32-bit float add/mul/fma 128 (FMA pipes,
# which also take IMAD at 64), type conversions 16; 4 schedulers issue
# one warp instruction (32 lanes) each per clock.
ALU_PER_CLK, FMA_PER_CLK, IMAD_PER_CLK, CONV_PER_CLK, ISSUE_PER_CLK = 64, 128, 64, 16, 128
HBM_BYTES_PER_S = 3.35e12
# The compactification of one axis, at least: what an f32 tan map and
# half-line map must compute on the only path the clamp leaves them (|a| <
# pi/2), whatever a compiler emits for them; what is the same for every
# sample of a (function, dim), the kind and its tests, is left out.  Both
# maps: the clamp's min and max (ALU pipe) and the Jacobian's product (1).
# The tan map: u - 1/2 and the scale by pi (2); one range reduction shared
# by sin and cos (the quadrant rounded with a shifter constant and taken
# back, 2, its parity read from the sum's bits, 1 ALU; three Cody-Waite
# products, 3); r^2 (1); the sin polynomial to r^7 (2 Horner steps, r r^2
# and the last FMA, 4) and the cos polynomial to r^8 (4); the quadrant's
# swap of sin and cos and its sign (3 ALU); one reciprocal of the cosine
# (1 SFU) with its Newton step (2), shared by tan = sin / cos (the
# quotient, its residual and its correction, 3) and the Jacobian pi / cos^2
# (2): 24 FP32, 1 SFU, 6 ALU.  The half-line map: 1 - u (1); one reciprocal
# (1 SFU) with its Newton step (2), shared by u / (1 - u) (3) and the
# Jacobian 1 / (1 - u)^2 (1); the shift (1): 9 FP32, 1 SFU, 2 ALU.
# Reciprocals go to the special-function unit, 16 per clock per SM.
TAN_AXIS = dict(fp32=2 + 2 + 3 + 1 + 4 + 4 + 2 + 3 + 2 + 1, sfu=1, conv=0, alu=2 + 1 + 3)
HALF_AXIS = dict(fp32=1 + 2 + 3 + 1 + 1 + 1, sfu=1, conv=0, alu=2)
SFU_PER_CLK = 16

# The least a Sobol point costs per (sample index, dim), walked in Gray-code
# order: the index's trailing ones (a NOT, a bit reverse and a
# find-leading-one) pick one direction vector, and one XOR applies it.
SOBOL_ALU_PER_POINT = 4

# The importance map of one adapted axis, at least: the bin select (the
# scale by n_bins, a float -> int conversion, the min with n_bins - 1, the
# int -> float conversion and the fraction), the bin's width, the
# interpolation, the Jacobian factor and its product: 6 float operations,
# 2 conversions and 1 ALU operation (the two shared-memory loads of the
# bin's edges are not counted); one more multiply per value folds the
# grid's Jacobian product in.
FP32_PER_ADAPT_AXIS, CONV_PER_ADAPT_AXIS, ALU_PER_ADAPT_AXIS = 6, 2, 1

N_ROUND = 65536          # samples per round in the rounds check (step 9)
ROUNDS = 4
N_FULL = 1 << 20         # step 12: samples per integrand through the service
FULL_ROUND, FULL_R = 65536, 8
# step 15: the Fig.-1 4-d harmonic template swept over a 32 x 32 (a, b) grid
SWEEP_A = (0.5, 2.0, 32)
SWEEP_B = (-1.0, 1.0, 32)
SWEEP_SLICE = 64
SWEEP_PREFIX = 16        # the overlapping sweep's a axis: a[:16] x b, 8 aligned slices
# step 17: importance grids fitted in 3 pilot-and-refine epochs of 4096
# samples per function, 16 bins per axis (repro.core.adaptive.N_BINS)
ADAPT_EPOCHS, ADAPT_PILOT, ADAPT_BINS = 3, 4096, 16
# step 18: the engine knobs of repro's adaptive benchmark phase
# (benchmarks/service_bench.py, BENCH_10), and its resume check's target
# (tighter than the benchmark's 2e-4, so the run spans 4 waves and the
# abandoned engine stops mid-flight)
BENCH10_KW = dict(seed=0, round_samples=8192, pipeline_waves=False,
                  adapt_rounds_per_epoch=1, adapt_max_epochs=3,
                  adapt_pilot_samples=2048)
RESUME_TARGET = 5e-5
# step 19: ZMCNormal's defaults (repro/core/normal.py) at dim 8: 3^8 = 6561
# strata of 2048 samples, depth 8, k_split 32; and a matrix of 512 MiB to
# read the stratum-moments kernel's bandwidth
NORMAL_DIM, NORMAL_SPLITS, NORMAL_N_PER, NORMAL_TRIALS = 8, 3, 2048, 5
# step 20: four gloo ranks share the card; raw sums at an n not divisible by
# them, against one device within the ROADMAP's tolerances
MESH_RANKS = 4
N_ODD = N_CHECK + 2
MESH_TOL = {"mc": dict(rtol=5e-5, atol=5e-3), "sobol": dict(rtol=1e-4, atol=1e-2)}
BIG_MOMENTS = (32768, 4096)
# step 22: the LM serving path (repro_torch.launch.serve.Server) at full
# width and depth: 4 requests with 512-token prompts from concrete_batch, 64
# greedy tokens each, a cache of 576 positions
LM_ARCHS = ("stablelm-3b", "chatglm3-6b")
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 64
LM_CAP = LM_PROMPT + LM_NEW
LM_TIMING_REPS = 3
# gate (a): the card against the CPU at full width, 2 layers, f32 compute
# with TF32 off, on the prefill and 8 decode steps fed the same tokens:
# max |diff| within LM_F32_REL of the largest |logit|.  f32 sums in another
# order differ by ~1e-7 of each, and a layer of this seeded model multiplies
# a difference in its input 2-7 times (the reference's fan-in init makes
# |q.k| / sqrt(hd) ~ 80, so attention is near one-hot, and each block adds
# ~5x its normalised input to the residual).  On the card, two layers left
# 1.8e-4 (stablelm-3b) and 1.2e-3 (chatglm3-6b, 2 KV heads read by 32
# query heads); a fault in the path (a mask, a position, a cache row) moves
# logits by their own size
LM_CHECK_LAYERS, LM_CHECK_STEPS, LM_F32_REL = 2, 8, 5e-3
# gate (b): at full depth in bf16, each block's decode step at position 512
# against the same block's prefill over 513 positions, both fed the
# prefill's input to that block (and the head on the last block's): RMS of
# the difference within LM_BF16_LAYER_RMS of the RMS of the prefill's row.
# One bf16 rounding is 2^-9 relative and a block's output carries a few;
# the free-running logits are printed, not gated: that amplification makes
# two prefills of 512 and 513 tokens disagree at position 511 as much
LM_BF16_LAYER_RMS = 1e-2
# step 23: the LM serving path of the moe family (MLA attention, the MoE
# feed-forward) with step 22's traffic and gates: (arch, depth, gate (a)).
# deepseek-v2-lite-16b at full width and depth; deepseek-v3-671b at full
# width with its depth cut to 4 (its 3 dense layers and 1 MoE layer: the
# whole model's 671.7e9 parameters fit no card), without gate (a), whose f32
# copy of two layers (13.9e9 parameters) would not fit beside the bf16 one.
# Gate (b) runs the MoE blocks dropless (capacity_factor = n_experts /
# top_k): at the served 1.25 a prefill over 4 x 513 tokens drops pairs that
# a 4-token decode step keeps, by design
LM_MOE_ARCHS = (("deepseek-v2-lite-16b", None, True), ("deepseek-v3-671b", 4, False))
# step 24: the LM serving path of the ssm and hybrid families (the Mamba-2
# block; zamba2-7b's shared attention block run after every 6 Mamba-2
# blocks, a KV cache per invocation) with step 22's traffic and gates, at
# full width and depth: (arch, gate (a)'s depth).  Gate (a) runs
# mamba2-130m at 2 layers and zamba2-7b at 3 with the shared block after 2
# (one group of 2 Mamba-2 blocks, the shared block, one tail block); gate
# (b) covers every Mamba-2 block and every invocation of the shared block
LM_SSM_ARCHS = (("mamba2-130m", {"n_layers": LM_CHECK_LAYERS}),
                ("zamba2-7b", {"n_layers": 3, "shared_attn_every": 2}))
# the long prompt: one request of prefill_32k's length (configs/shapes.py)
# and 64 new tokens, on the ssm family's constant-size cache
LM_LONG_ARCH, LM_LONG_PROMPT = "mamba2-130m", 32768
# NVIDIA's H100 SXM data sheet: the dense bf16 tensor-core peak and the HBM3
# rate, both at the 700 W limit
H100_BF16_FLOPS, H100_HBM_BYTES_S = 989e12, 3.35e12
# step 25: the LM training path (repro_torch.launch.train) at full width and
# depth.  stablelm-3b: AdamW with f32 parameters, gradients and moments,
# remat "full", batch 8 x 512 from TokenStream in 2 microbatches; one
# warm-up step, then TRAIN_TIMED steps timed phase by phase (CUDA events)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_TIMED = "stablelm-3b", 8, 512, 2, 3
# gate (a): full width, 2 layers, f32 compute with TF32 off, one step of
# batch 2 x 64 in 2 microbatches at the peak rate (warmup 0) on the card
# against the same weights on the CPU.  f32 sums in another order differ by
# ~1e-7 of each; the seeded model multiplies a difference 2-7 times a layer
# (step 22's gate (a)), and backward through near one-hot attention more:
# the loss within TRAIN_LOSS_RTOL, the gradient norm within
# TRAIN_GNORM_RTOL, each leaf's gradient within TRAIN_GRAD_RMS relative RMS,
# the updated parameters within TRAIN_PARAM_RMS (Adam's first step is
# ~sign(g) lr: an element whose gradient is ~0 may move by 2 lr on one side
# only).  A fault in the path (a mask, a shift, a missed microbatch, a
# dropped clip) moves these by their own size
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 64
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RMS, TRAIN_PARAM_RMS = 1e-4, 1e-3, 1e-2, 1e-3
# mamba2-130m at examples/train_lm.py's batch (8 x 256, 2 microbatches),
# SSM_TRAIN_STEPS steps (warmup 1); gate (b) checkpoints every
# SSM_CKPT_EVERY steps and fails at step SSM_FAIL_AT (step 30 (k2)'s
# counts, for the script's time limit); gate (c): SSM_TRAIN_STEPS
# steps on one fixed batch at lr 1e-3, warmup 2
SSM_TRAIN_ARCH, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = "mamba2-130m", 8, 256, 6
SSM_CKPT_EVERY, SSM_FAIL_AT = 3, 4
# step 26: the LM multi-device path on four gloo ranks sharing the card.
# (a) stablelm-3b at full width with MESH_TRAIN_LAYERS of its 32 layers (the
# one cut: every gathered byte crosses host memory through gloo, and more
# layers add only identical ones; 2, so that step 28 fits the time limit),
# in f32, step 25's AdamW, batch and
# microbatches, on (data, model) = (2, 2): MESH_RESUME_STEPS uninterrupted
# steps (one warm-up, the rest timed), gate (a1) on the first
# MESH_TRAIN_STEPS against one device with step 25's gate (a) tolerances
# (2: the second step runs on the first's optimizer state, and each f64
# step on the mesh takes ~13 s, in (a1) and in step 28 (f1));
# the run writes its step-MESH_CKPT_EVERY checkpoint as train_loop does, and
# train_loop resumes from it, fails in step MESH_FAIL_AT + 1 and resumes
# again (gate (a2)).  (b) deepseek-v2-lite-16b at full width on (1, 4), cut to
# MESH_B2_DEPTH of its 27 layers (1 dense, 2 MoE, so that step 28 fits),
# step 23's request; gate (b1) at depth MESH_B1_DEPTH.  (c) four stablelm-3b
# blocks at full width along a pod axis, PIPE_M microbatches of 1 x PIPE_SEQ,
# within PIPE_TOL of the largest |output| of the blocks run in sequence
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 2
MESH_RESUME_STEPS, MESH_CKPT_EVERY, MESH_FAIL_AT = 3, 2, 2
# gate (a1)'s one device runs the mesh's rows as its microbatches: 2
# microbatches of 4 rows split over data = 2 ranks are 4 pieces of 2 rows.
# Since tensor parallelism the mesh also sums each row-split product (wo,
# wd, the vocab) over model in another order than one device's, so gate
# (a1) compares the two in f64, where that order moves the step-2 state by
# about 2^-29 of what it moves f32's; the f32 comparison is printed.
# In step 25's 2 microbatches of 4 rows the seeded model's (at 4 layers)
# gradients move by ~7% relative RMS (one device against one device), past
# the gate, and Adam turns that into 8e-3 of the parameters by step 3.  The
# witness that this is f32 rounding, not a fault: step 1's gradients in f64
# (every f32 upcast of the model kept at f64) in both microbatchings agree
# within MESH_F64_RMS relative RMS (f64 rounds 2^29 times finer than f32),
# and each f32 gradient, one device's in both microbatchings and the
# mesh's, lies about as far from them: the mesh's within MESH_F32_SPREAD
# times the farther one device's
MESH_ROW_ACCUM = 4
MESH_F64_RMS, MESH_F32_SPREAD = 1e-8, 2.0
MESH_TIMED_DECODE = 4
# (b2)'s generates: 16 greedy tokens (every decode step's ~270 collectives
# cross gloo at ~6 ms each under tensor parallelism)
MESH_B2_NEW = 16
MESH_SERVE_ARCH, MESH_B1_DEPTH, MESH_B2_DEPTH = "deepseek-v2-lite-16b", 3, 3
PIPE_M, PIPE_SEQ, PIPE_TOL, PIPE_SEED = 8, 512, 1e-5, 100
# step 27: qwen2.5-32b tensor parallel on (1, 4), step 22's prompts and
# cache; gate (d1) at depth TP_D1_DEPTH; TP_NEW greedy tokens a generate
# (8, so that step 28 fits the time limit: a decode step takes ~2 s)
TP_ARCH, TP_D1_DEPTH, TP_NEW = "qwen2.5-32b", 4, 8
# step 28 (e): qwen2-vl-7b (28 heads on 4 KV heads: neither 4 nor the group
# of 7 nor the heads divide 8, the q-sequence case) at full width on (data,
# model) = (1, 8), step 22's request as the VLM's concrete batch (vision
# embeddings spliced ahead, M-RoPE positions); gate (e1) at depth
# CP_E1_DEPTH (each layer is the same q-sequence case, and 2 carry one
# layer's output into the next); the served model (e2, e3, the times) cut to CP_E_DEPTH of its
# 28 layers, CP_NEW greedy tokens a generate (at full depth a decode step
# gathers the 1.67 GB of attention weights a rank through gloo, ~7 s on this
# card, and (e2)'s two generates took 70 s of the script's twenty minutes)
CP_ARCH, CP_RANKS, CP_E1_DEPTH, CP_E_DEPTH, CP_NEW = "qwen2-vl-7b", 8, 2, 7, 4
CP_SCORES = "batch|None|qgroup|attn_q_seq|None"
# (f): step 26 (a)'s stablelm-3b run (full width, MESH_TRAIN_LAYERS layers,
# f32, AdamW, batch and microbatches, (2, 2)) with sp_activations: each
# entry's remat saves a rank's 2 rows x 256 of 512 positions x 2560 x 4 B,
# half of the 10,485,760 without it
SP_CARRY_BYTES = 2 * (TRAIN_SEQ // 2) * 2560 * 4
# step 29: the port's example scripts (examples/*_torch.py) on the card, each
# through its main at its own defaults, harmonic_modes also with --full
# --use-kernel (the paper's Fig. 1: 2-sigma coverage at least EX_COVERAGE);
# gate (g2) holds the users'-integrand path (quickstart's gauss3d,
# boltzmann's two graphs: the chunked engine, no kernel) on the card against
# the CPU at EX_N samples x EX_TRIALS trials, raw sums within the ROADMAP's
# MC tolerance and estimates within EST_TOL of a standard error; gate (g4)
# the service tour's launch counts, as the reference script prints them;
# (g5) one timed trial of the Boltzmann graphs over EX_BEAMS beams (1024
# integrands of dim 3) at EX_BIG_N samples
EX_N, EX_TRIALS, EX_RTOL, EX_ATOL = 2**14, 2, 5e-5, 5e-3
EX_COVERAGE = 0.85
EX_LAUNCHES = {"cold": 2, "warm": 0, "top_up": 1, "infinite": 1, "sweep": 1,
               "sweep_top_up": 1}
EX_BEAMS, EX_BIG_N = 512, 10**6
# step 30: LM training of the moe, hybrid and encoder families and of
# deepseek-v3-671b's own recipe on one card, step 25's train step, batch
# (TRAIN_BATCH x TRAIN_SEQ), gates and tolerances, f32 parameters (16 bytes a
# parameter with AdamW), bf16 compute, remat "full"; one warm-up step, then
# FAM_TIMED steps timed phase by phase and one profiled.  Each entry: (arch,
# the timed run's overrides, its gate (x1)'s overrides).
# (h) deepseek-v2-lite-16b at 3 of 27 layers (1 dense, 2 MoE of 64 experts,
# top-6, 2 shared) at the configured capacity factor 1.25; (h1) at 2 layers
# (1 dense, 1 MoE) dropless (capacity factor E/k, as reduced() sets it), so
# that a routing difference cannot drop another pair; (h2) a plain run of
# the timed run's 1 + FAM_TIMED steps from the same seed at capacity 1.25,
# sha256-equal to the timed run's state after them
FAM_MOE = ("deepseek-v2-lite-16b", {"n_layers": 3}, {"n_layers": 2})
# (i) zamba2-7b at 13 of 81 layers (2 groups of 6 Mamba-2 blocks, each
# followed by the shared attention block, 1 tail block); (i1) at 2 layers with
# the shared block after each (cut from 4 with it after every 2, for time), so
# that it runs twice and its gradient is the sum over both invocations.  (i1)
# is gated in f64 (parameters, compute, moments, the SSD, RoPE's cos and
# sin; every f32 upcast kept at f64), as the mesh gates of steps 26-28 are:
# in f32 the card's and the CPU's gradients lie ~4e-3 apart (relative RMS),
# the gradient norm 1.08e-3 (step 25's gate 1e-3), and Adam's first step,
# lr g / (|g| + eps) on the zero-initialised A_log and dt_bias, turns that
# into 1.6e-2 of their parameters where |g| is near eps; in f64 the loss lay
# 2.5e-15 apart, the norm 1.2e-12, the gradients 1.9e-11 and the parameters
# 1.8e-8 (measured on one H100, 700 W).  FAM_I1_F64_TOL (loss, grad_norm,
# gradients, parameters) lies between those and the f32 readings, each
# about the geometric mean.  The witness that f32 differs by rounding, not
# by a fault: the same weights rounded to f32, one step on each side, and
# the card's f32 gradients no farther from the CPU's f64 ones than
# FAM_F32_SPREAD times the CPU's own f32 gradients (step 27 (d1)'s rule)
FAM_HYBRID = ("zamba2-7b", {"n_layers": 13}, {"n_layers": 2, "shared_attn_every": 1})
FAM_I1_F64_TOL = (1e-11, 1e-8, 1e-7, 1e-5)
FAM_F32_SPREAD = MESH_F32_SPREAD
# (j) deepseek-v3-671b's train.default_hparams_for (Adafactor, grad_accum 4,
# weight decay 0; opt_dtype bf16, which Adafactor's f32 statistics do not
# read) with the MTP block, cut to its 3 dense layers: the moe_layers stage
# has no layer (one MoE layer's 11.3e9 parameters, with f32 gradients 90 GB,
# fit no card); (j1) 1 dense layer and the MTP block (3.123e9 parameters;
# the moe_layers stage empty, the repair's case), the recipe on one step of
# FAM_J1_BATCH x FAM_J1_SEQ in its FAM_J1_ACCUM microbatches.  Its CPU half
# runs with the host's denormals flushed (host_flush_denormals): the MTP
# head's logits span ~10^2, so its softmax gradient is mostly f32 denormals,
# and with them the CPU step took 168.9 s (measured on the card's host)
FAM_V3 = ("deepseek-v3-671b", {"n_layers": 3}, {"n_layers": 1, "first_dense_layers": 1})
FAM_J1_BATCH, FAM_J1_SEQ, FAM_J1_ACCUM = 4, 64, 4
# (k) hubert-xlarge at full depth (48 layers): TokenStream's frames through
# frontend_proj, bidirectional attention, the same-position loss; (k1) at 2
# layers; (k2) at FAM_K2_LAYERS layers under Adafactor with int8 error-feedback
# compression: FAM_K2_STEPS uninterrupted steps against a run that
# checkpoints every FAM_K2_CKPT_EVERY steps, fails in step FAM_K2_FAIL_AT and
# resumes; (k3) one step's gradients and residuals through compress_tree on
# the card and on the CPU, bit for bit
FAM_ENC = ("hubert-xlarge", {}, {"n_layers": 2})
FAM_K2_LAYERS, FAM_K2_STEPS, FAM_K2_CKPT_EVERY, FAM_K2_FAIL_AT = 4, 6, 3, 4
# the gradient norm past which the train step's f32 sum of squares (the
# reference's _global_norm) overflows: sqrt of f32's largest value.  The
# seeded model's gradients grow by orders of magnitude with depth (its fan-in
# init has no depth scaling): hubert-xlarge's at 48 layers pass it (3.0e23,
# measured on one H100), so its grad_norm is inf and the clip zeroes the
# step's gradients, as the reference's would; there the gate asks for every
# gradient element finite and a finite f64 norm past this one
F32_NORM_MAX = 1.8446743e19
FAM_TIMED = 3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


class Laps:
    """Each step's seconds, printed on a line of its own as the step ends
    (a step runs from the previous one's end), and kept for the summary."""

    def __init__(self, card: str, t0: float):
        self.card, self.t, self.seconds = card, t0, {}

    def end(self, step: int) -> None:
        now = time.perf_counter()
        self.seconds[step] = round(now - self.t, 1)
        print(f"step {step} {now - self.t:.1f} s; on {self.card}", flush=True)
        self.t = now


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def fig1_spec(device):
    import numpy as np
    from repro_torch.core import genz
    from repro_torch.core.integrand import (MultiFunctionSpec, abs_sum_family,
                                            gaussian_family, harmonic_family)
    osc, osc_exact = genz.oscillatory(100, 3)
    corner, corner_exact = genz.corner_peak(100, 4)
    fams = [
        harmonic_family(500, 4),                               # Eq. (1)
        harmonic_family(200, 2),
        abs_sum_family(49, 2, np.ones(49)),                    # Eq. (2), n < 50
        abs_sum_family(151, 3, np.ones(151), sign_last=-1.0),  # Eq. (2), n >= 50
        gaussian_family(100, 4),
        osc,
        corner,
    ]
    return (MultiFunctionSpec.from_families(fams).to(device),
            {5: osc_exact, 6: corner_exact})


def launch_bucket(fn, bucket, n_samples, key, **kw):
    import math
    from repro_torch.kernels import template
    return fn(template.pack_scalars(key, 0, n_samples), bucket.fn_ids,
              bucket.packed, bucket.lo, bucket.hi, bucket.block_forms,
              dim=bucket.dim,
              n_sample_blocks=max(1, math.ceil(n_samples / template.S_BLK)), **kw)


def real_rows(bucket, out):
    import torch
    return torch.cat([out[0, s.row_start:s.row_start + s.n_fn]
                      for s in bucket.slices])


def sum_ratio(diff, plain):
    """Worst |diff| / (atol + rtol |plain|): at most 1 where allclose holds."""
    return float((diff / (ATOL + RTOL * plain.abs())).max())


def compare_sums(bucket, k_out, p_out, n_samples) -> float:
    """Hold a kernel launch's raw sums against the plain version's on the
    bucket's real rows within rtol/atol; returns max |diff|."""
    import torch
    kr, pr = real_rows(bucket, k_out), real_rows(bucket, p_out)
    check(bool(torch.isfinite(kr).all()), f"d{bucket.dim}: non-finite sums")
    diff = (kr - pr).abs()
    ok = torch.allclose(kr, pr, rtol=RTOL, atol=ATOL)
    print(f"bucket d{bucket.dim} at N={n_samples}: kernel vs plain sums max|diff| "
          f"s1 {float(diff[:, 0].max()):.6g}, s2 {float(diff[:, 1].max()):.6g}; "
          f"worst |diff| / (atol + rtol |plain|) {sum_ratio(diff, pr):.4f} "
          f"(rtol={RTOL}, atol={ATOL}: {'ok' if ok else 'FAIL'})")
    check(ok, f"d{bucket.dim} at N={n_samples}: kernel disagrees with the plain version")
    return float(diff.max())


def compare_estimates(bucket, k_out, p_out, n_samples) -> float:
    """Hold the estimates a launch gives (mean and standard error per
    function, as ``direct_mc.finalize`` makes them; the box volume cancels)
    against the plain version's: both within EST_TOL of the plain standard
    error.  The raw-sum tolerance of ``compare_sums`` is printed beside it
    but not held: its atol is fixed while f32 rounding differences of a
    sum grow with its length.  Returns max |diff| of the raw sums."""
    import torch
    kr, pr = real_rows(bucket, k_out), real_rows(bucket, p_out)
    check(bool(torch.isfinite(kr).all()), f"d{bucket.dim}: non-finite sums")

    def estimates(rows):
        r = rows.double()
        mean = r[:, 0] / n_samples
        var = torch.clamp(r[:, 1] / n_samples - mean * mean, min=0.0)
        return mean, torch.sqrt(var / n_samples)

    (km, kse), (pm, pse) = estimates(kr), estimates(pr)
    check(bool((pse > 0).all()), f"d{bucket.dim}: a zero standard error")
    d_mean = float(((km - pm).abs() / pse).max())
    d_se = float(((kse - pse).abs() / pse).max())
    diff = (kr - pr).abs()
    ok = d_mean <= EST_TOL and d_se <= EST_TOL
    print(f"bucket d{bucket.dim} at N={n_samples}: kernel vs plain estimates: "
          f"max |d mean| {d_mean:.3g} and max |d stderr| {d_se:.3g} standard "
          f"errors (limit {EST_TOL}: {'ok' if ok else 'FAIL'}); sums max|diff| "
          f"s1 {float(diff[:, 0].max()):.6g}, s2 {float(diff[:, 1].max()):.6g}, "
          f"{sum_ratio(diff, pr):.4f} of the N={N_CHECK} sum tolerance")
    check(ok, f"d{bucket.dim} at N={n_samples}: kernel estimates disagree "
              f"with the plain version's")
    return float(diff.max())


def op_bound_ms(draws: float, values: float, n_sm: int, clock_hz: float,
                tan_axes: float = 0.0, half_axes: float = 0.0,
                adapt_axes: float = 0.0, adapt_values: float = 0.0) -> dict:
    """The least time the card needs for these operations, per resource
    (ms).  Integer adds go to whichever of the ALU and FMA pipes leaves
    the busier one least loaded.  ``tan_axes`` and ``half_axes`` count
    draws through the compactification's tan map and half-line map,
    ``adapt_axes`` draws through an importance grid and ``adapt_values``
    the values its Jacobian multiplies."""
    def axes(k):                        # the compactification's operations of kind k
        return tan_axes * TAN_AXIS[k] + half_axes * HALF_AXIS[k]

    alu_only = draws * TF_ALU_ONLY + adapt_axes * ALU_PER_ADAPT_AXIS + axes("alu")
    adds = draws * TF_ADDS
    fp = (draws * FP32_PER_DRAW + values * FP32_PER_VALUE + axes("fp32")
          + adapt_axes * FP32_PER_ADAPT_AXIS + adapt_values)
    conv = draws * CONV_PER_DRAW + adapt_axes * CONV_PER_ADAPT_AXIS + axes("conv")
    sfu = axes("sfu")

    def pipes(a):                       # a: adds issued on the ALU pipe
        return max((alu_only + a) / ALU_PER_CLK, (adds - a) / IMAD_PER_CLK,
                   (adds - a + fp) / FMA_PER_CLK)

    clocks = {
        "ALU and FMA pipes": min(pipes(adds * i / 100) for i in range(101)),
        "issue": (alu_only + adds + fp + conv + sfu) / ISSUE_PER_CLK,
        "conversion": conv / CONV_PER_CLK,
        "special functions": sfu / SFU_PER_CLK,
    }
    return {k: v / (n_sm * clock_hz) * 1e3 for k, v in clocks.items()}


def sobol_op_bound_ms(draws: float, values: float, point_dims: float, n_sm: int,
                      clock_hz: float, tan_axes: float = 0.0, half_axes: float = 0.0,
                      adapt_axes: float = 0.0, adapt_values: float = 0.0) -> dict:
    """The least time the card needs for a Sobol launch's operations, per
    resource (ms).  A draw is one XOR with its shift on the ALU pipe, one
    u32 -> f32 conversion and FP32_PER_DRAW float operations; a point
    costs SOBOL_ALU_PER_POINT ALU operations per distinct (sample index,
    dim) the launch draws (``point_dims``, from :func:`distinct_point_dims`),
    once however many functions and blocks share it; the values cost what
    they cost under MC, and the stages (``tan_axes``, ``half_axes``,
    ``adapt_axes``, ``adapt_values``) what they cost in :func:`op_bound_ms`."""
    def axes(k):                        # the compactification's operations of kind k
        return tan_axes * TAN_AXIS[k] + half_axes * HALF_AXIS[k]

    alu = (draws + point_dims * SOBOL_ALU_PER_POINT + adapt_axes * ALU_PER_ADAPT_AXIS
           + axes("alu"))
    conv = draws * CONV_PER_DRAW + adapt_axes * CONV_PER_ADAPT_AXIS + axes("conv")
    fp = (draws * FP32_PER_DRAW + values * FP32_PER_VALUE + axes("fp32")
          + adapt_axes * FP32_PER_ADAPT_AXIS + adapt_values)
    sfu = axes("sfu")
    clocks = {"ALU pipe": alu / ALU_PER_CLK, "FMA pipes": fp / FMA_PER_CLK,
              "issue": (alu + conv + fp + sfu) / ISSUE_PER_CLK,
              "conversion": conv / CONV_PER_CLK,
              "special functions": sfu / SFU_PER_CLK}
    return {k: v / (n_sm * clock_hz) * 1e3 for k, v in clocks.items()}


def distinct_point_dims(plan, n_samples: int, round_bases=None, n_rounds: int = 1,
                        round_stride: int = 0) -> float:
    """(sample index, dim) pairs whose Sobol points a launch of each of
    ``plan``'s buckets needs: the union of its blocks' windows (each
    ``n_samples`` long at ``round_base + r * round_stride``, u32 windows
    taken as integers) times its dim.  Every block of a bucket at the same
    window draws the same points (the functions differ only in their
    shifts), so a Fig.-1 bucket needs ``n_samples * dim`` and a sweep
    wave's slices share theirs.  ``round_bases``: one per-block window
    tensor per bucket, or None for all 0."""
    total = 0
    for i, b in enumerate(plan.buckets):
        bases = {0} if round_bases is None else set(round_bases[i].tolist())
        starts = sorted({x + r * round_stride for x in bases for r in range(n_rounds)})
        covered, end = 0, -1
        for x in starts:
            covered += max(0, x + n_samples - max(x, end))
            end = max(end, x + n_samples)
        total += covered * b.dim
    return float(total)


def built_point_dims(plan, n_samples: int) -> float:
    """(sample, function block, dim) triples the kernel computes points for:
    each CUDA block walks its own, so a point is stepped (or built, at a
    thread's first sample) once per 16-function block that draws it (the
    kernel's overhead over :func:`distinct_point_dims`)."""
    from repro_torch.kernels import template
    return float(n_samples) * sum(b.fn_ids.shape[0] // template.F_BLK * b.dim
                                  for b in plan.buckets)


ALU_OPS = ("IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "FSETP", "SEL",
           "FSEL", "IMNMX", "FMNMX", "IABS", "MOV", "PLOP3")
FMA_OPS = ("IMAD", "FFMA", "FADD", "FMUL")


@functools.lru_cache(maxsize=2)
def _cuobjdump(lib_path) -> str | None:
    import shutil
    from repro_torch.kernels import build
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump"))
    try:
        out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout if out.returncode == 0 else None


def sass_listing(lib_path, function: str) -> list[tuple] | None:
    """(address, opcode, operands) of each instruction of
    the function whose mangled name contains ``function``, from
    ``cuobjdump -sass`` of the built library; None when the tool is missing
    or its listing cannot be read."""
    import re
    listing = _cuobjdump(str(lib_path))
    if listing is None:
        return None
    body, inside = [], False
    for line in listing.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                          line)
            if m:
                body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return body


def sass_loops(lib_path, function: str = "fused_mc_pass1ILi0ELb0ELb0EE") -> list[dict] | None:
    """Instruction mix of the innermost loops of one pass-1 instantiation
    (by default the main path's MC one without compactified or swept
    blocks, ``fused_mc_pass1<0, false, false>``; its mangled name is
    ``function``), read from ``cuobjdump -sass`` of the built library: per
    loop its instructions, draws (one u32 -> f32 conversion each),
    rotates, shared-memory loads and opcode counts.  None when the tool is
    missing or its listing cannot be read: this is a report of what nvcc
    emitted, not a check."""
    import collections
    import re
    body = sass_listing(lib_path, function)
    if body is None:
        return None
    loops = []
    for addr, op, args in body:
        t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) <= addr:
            loops.append((int(t.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
    found = []
    for a, b in inner:
        ops = collections.Counter(op for addr, op, _ in body if a <= addr <= b)
        found.append({
            "range": f"0x{a:x}-0x{b:x}",
            "draws": sum(n for op, n in ops.items() if op.startswith("I2F")),
            "rotates": sum(n for op, n in ops.items()
                           if op.startswith("SHF") and ".W" in op),
            "lds": sum(n for op, n in ops.items() if op.startswith("LDS")),
            "instr": sum(ops.values()),
            "alu": sum(n for op, n in ops.items() if op.split(".")[0] in ALU_OPS),
            "fma": sum(n for op, n in ops.items() if op.split(".")[0] in FMA_OPS),
            "ops": ops})
    return found or None


def pass1_report(lib_path, res: dict, name: str) -> str:
    """One line for a pass-1 instantiation ``name`` (``<stages,sobol,swept>``,
    as ``build.pass1_resources`` names it; ``res`` its entry there): its
    registers, spill stores and resident blocks per SM, and the SASS
    instructions per draw of its innermost drawing loops (a draw is one
    unsigned u32 -> f32 conversion: the uniform's; an adapted axis' bin
    conversion is signed), split into the loops that draw 16 at a time (dim
    outer, the 16 functions inside) and the rest."""
    import re
    st, sob, sw = re.match(r"<(\d),(\w+),(\w+)>", name).groups()
    mangled = f"fused_mc_pass1ILi{st}ELb{int(sob == 'true')}ELb{int(sw == 'true')}EE"
    line = (f"fused_mc_pass1{name}: {res['registers']} registers, {res['spill_stores']} "
            f"bytes of spill stores, {res['blocks_per_sm']} resident blocks per SM")
    loops = sass_loops(lib_path, mangled)
    if not loops:
        return line + "; SASS not measured (no listing)"
    for lp in loops:
        lp["udraws"] = sum(n for op, n in lp["ops"].items()
                           if op.startswith("I2F") and "U32" in op)
    groups = {"16 draws an iteration": [lp for lp in loops if lp["udraws"] >= 16],
              "1-15 draws an iteration": [lp for lp in loops if 0 < lp["udraws"] < 16]}
    for label, ls in groups.items():
        if ls:
            n = sum(lp["udraws"] for lp in ls)
            line += (f"; {len(ls)} loops of {label}: "
                     f"{sum(lp['instr'] for lp in ls) / n:.2f} SASS instructions and "
                     f"{sum(lp['lds'] for lp in ls) / n:.2f} LDS per draw")
    return line


def compact_spec(device):
    """Step 10's spec: Gaussians over R^d and [0, inf)^d (sigma 0.5-2)
    mixed with finite harmonic and Genz families, at d = 2, 3, 4."""
    import numpy as np
    from repro_torch.core import genz
    from repro_torch.core.integrand import (MultiFunctionSpec, gaussian_family,
                                            harmonic_family)
    fams, exact = [], {}
    for d in (2, 3, 4):
        exact[len(fams)] = ("R^d", d)
        fams.append(gaussian_family(64, d, lo=-np.inf, hi=np.inf))
        exact[len(fams)] = ("[0,inf)^d", d)
        fams.append(gaussian_family(64, d, lo=0.0, hi=np.inf))
        fams.append(harmonic_family(48, d))
        fams.append(genz.oscillatory(32, d)[0])
    return MultiFunctionSpec.from_families(fams).to(device), exact


def adapted_spec(device):
    """Step 17's spec, 1024 peaked integrands: Genz corner peaks 512 x 3-d
    and 384 x 4-d (difficulty 4) and 128 narrow Gaussians over R^2 (sigma
    0.2-0.35, compactified), each family's importance grid fitted on the
    card in ADAPT_EPOCHS epochs of ``initial_edges`` -> ``pilot_weights``
    -> ``refine_edges``.  Returns the adapted spec, the same families
    without grids, and the exact values."""
    import numpy as np
    from repro_torch.core import adaptive, genz, rng
    from repro_torch.core.integrand import (MultiFunctionSpec, gaussian_analytic,
                                            gaussian_family)
    c3, e3 = genz.corner_peak(512, 3, difficulty=4.0)
    c4, e4 = genz.corner_peak(384, 4, difficulty=4.0)
    sigma = np.linspace(0.2, 0.35, 128).astype(np.float32)
    gauss = gaussian_family(128, 2, sigma=sigma, lo=-np.inf, hi=np.inf)
    base = [f.to(device) for f in (c3, c4, gauss.compactified())]
    adapted = []
    for i, fam in enumerate(base):
        edges = adaptive.initial_edges(fam.domains, ADAPT_BINS)
        for epoch in range(1, ADAPT_EPOCHS + 1):
            weights = adaptive.pilot_weights(fam, edges, rng.fold_key(14, 16 * i + epoch),
                                             ADAPT_PILOT)
            edges = adaptive.refine_edges(edges, weights)
        adapted.append(fam.adapted(edges, epoch=ADAPT_EPOCHS))
    exact = np.concatenate([e3, e4, gaussian_analytic(128, 2, sigma=sigma)])
    return (MultiFunctionSpec.from_families(adapted),
            MultiFunctionSpec.from_families(base), exact)


def sha256_of(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def variant_counts(expect: dict, what: str) -> dict:
    """Read the per-variant kernel launch counts after a path, print them,
    and fail if a variant the path runs was launched no time."""
    from repro_torch.kernels import template
    counts = template.kernel_launch_counts()
    print(f"{what}: kernel launches by variant {counts}")
    for name, must in expect.items():
        if must:
            check(counts[name] > 0, f"{what}: variant {name} never launched")
    return counts


def traced_split(reqs, **engine_kw) -> str:
    """Serve ``reqs`` synchronously on a fresh engine with tracing on and
    return the wall and the trace's time per pipeline stage (wal_commit
    runs inside deposit), as one printable line."""
    import torch
    from repro_torch.obs import Observability
    from repro_torch.obs.trace import STAGES, span_totals
    from repro_torch.service import IntegrationEngine
    events = []
    engine = IntegrationEngine(device="cuda", obs=Observability.enabled(
        sinks=[events.append]), **engine_kw)
    t0 = time.perf_counter()
    tickets = [engine.submit(r) for r in reqs]
    while engine.step():
        pass
    check(all(engine.poll(t) is not None for t in tickets), "traced run unfinished")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.close()
    tot = span_totals(events)
    per_wave = {k: [round(ev["dur"] / 1e3, 3) for ev in events
                    if ev.get("ph") == "X" and ev["name"] == k]
                for k in ("launch", "device_execute", "deposit")}
    return (f"{1e3 * wall:.3f} ms wall over {engine.stats.waves} waves; "
            + ", ".join(f"{k} {1e3 * tot.get(k, 0.0):.3f} ms "
                        f"({100 * tot.get(k, 0.0) / wall:.1f}%)" for k in STAGES)
            + f"; submits and the rest {1e3 * (wall - sum(tot.get(k, 0.0) for k in STAGES if k != 'wal_commit')):.3f} ms"
            + "".join(f" (of which {k} {1e3 * v:.3f} ms)" for k, v in tot.items()
                      if k not in STAGES)
            + "; ms per wave: " + ", ".join(f"{k} {v}" for k, v in per_wave.items()))


def served_digest(results) -> str:
    import numpy as np
    h = hashlib.sha256()
    for r in results:
        h.update(np.ascontiguousarray(r.means, np.float32).tobytes())
        h.update(np.ascontiguousarray(r.stderrs, np.float32).tobytes())
    return h.hexdigest()


def mesh_rank() -> dict:
    """One of step 20's four gloo ranks, all on the card of the parent:
    every mesh check that needs the ranks, returned to the parent (which
    holds them against the single-device steps) as numpy and numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import genz, rng
    from repro_torch.core.multifunctions import ZMCMultiFunctions
    from repro_torch.core.normal import ZMCNormal
    from repro_torch.distributed import collectives, compression
    from repro_torch.kernels import template
    from repro_torch.kernels.mc_eval import multi
    from repro_torch.kernels.moments import ops as mops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.service import IntegrationEngine, IntegrationRequest

    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device("cuda", 0)
    spec, _ = fig1_spec(device)
    key = rng.fold_key(0, 0)
    plans = {s: multi.plan_spec(spec, sampler=s) for s in ("mc", "sobol")}
    meshes = {shape: make_mesh_for(model_parallel=shape[1], device="cuda")
              for shape in ((1, MESH_RANKS), (MESH_RANKS, 1), (2, 2))}
    out = {"rank": rank}

    def digest(states) -> str:
        h = hashlib.sha256()
        for i in sorted(states):
            h.update(states[i].s1.cpu().numpy().tobytes())
            h.update(states[i].s2.cpu().numpy().tobytes())
        return h.hexdigest()

    def sharded(plan, n, mesh):
        """sharded_eval_plan with the launches counted: every one through
        the CUDA kernel, on the card."""
        template.reset_kernel_launch_count()
        got = multi.sharded_eval_plan(plan, n, key, mesh)
        torch.cuda.synchronize()
        check(template.kernel_launch_count() == plan.n_launches,
              f"rank {rank}: {template.kernel_launch_count()} CUDA launches for "
              f"{plan.n_launches} buckets")
        check(all(st.s1.device.type == "cuda" for st in got.values()),
              f"rank {rank}: sums left the card")
        return got

    # (1, 4), functions only: each function's sums the single launch's bits
    out["fn_only_equal"] = {}
    for s, plan in plans.items():
        one = multi.eval_plan(plan, N_MAIN, key)
        got = sharded(plan, N_MAIN, meshes[(1, MESH_RANKS)])
        out["fn_only_equal"][s] = sum(digest({0: got[i]}) == digest({0: one[i]})
                                      for i in one)
    # (4, 1) and (2, 2): raw sums at N_ODD against one device, n exact, the
    # estimates at N_MAIN (held by the parent against steps 6 and 14)
    for shape in ((MESH_RANKS, 1), (2, 2)):
        mesh = meshes[shape]
        for s, plan in plans.items():
            one = multi.eval_plan(plan, N_ODD, key)
            got = sharded(plan, N_ODD, mesh)
            ok = all(torch.allclose(got[i].s1, one[i].s1, **MESH_TOL[s])
                     and torch.allclose(got[i].s2, one[i].s2, **MESH_TOL[s])
                     for i in one)
            worst = max(float((got[i].s1 - one[i].s1).abs().max()) for i in one)
            again = digest(sharded(plan, N_ODD, mesh))
            zmc = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                                    sampler=s, mesh=mesh)
            template.reset_kernel_launch_count()
            mops.reset_kernel_launch_count()
            est = zmc.evaluate(num_trials=1)
            torch.cuda.synchronize()
            out[(shape, s)] = dict(
                sums_ok=ok, max_abs=worst, digest=digest(got), repeat=again,
                n_exact=all(float(st.n) == N_ODD for st in got.values()),
                means=est.means[0], stderrs=est.stderrs[0],
                counts=template.kernel_launch_counts())
    mesh = meshes[(2, 2)]
    # R = 4 rounds in one sharded launch against 4 single-round ones
    start = {i: 3 * i for i in range(len(spec.families))}
    _, stack = multi.sharded_eval_plan_rounds(plans["mc"], N_ROUND, ROUNDS, key, mesh,
                                              start_rounds=start)
    same = 0
    for r in range(ROUNDS):
        _, one = multi.sharded_eval_plan_rounds(
            plans["mc"], N_ROUND, 1, key, mesh,
            start_rounds={i: v + r for i, v in start.items()})
        same += all(sha256_of(a[r]) == sha256_of(b[0]) for a, b in zip(stack, one))
    out["rounds_same"] = same
    # service configuration 2 on (2, 2), in memory (step 21 serves it again
    # with a state dir and holds it against this run)
    engine = IntegrationEngine(round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R,
                               mesh=mesh)
    template.reset_kernel_launch_count()
    tickets = [engine.submit(IntegrationRequest.make([f], n_samples=N_FULL))
               for f in spec.families]
    wave_s = []
    while True:
        t0 = time.perf_counter()
        if not engine.step():
            break
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t0)
    served = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    out["service"] = dict(means=np.concatenate([r.means for r in served]),
                          stderrs=np.concatenate([r.stderrs for r in served]),
                          launches=template.kernel_launch_count(),
                          waves=engine.stats.waves, wave_s=wave_s,
                          fallback=engine.batcher.fallback_rounds)
    engine.close()
    # ZMCNormal at dim 8, samples over all four ranks, moments on the card
    gpeak = genz.gaussian_peak(1, NORMAL_DIM)[0].to(device)

    def normal_fn(x):
        return gpeak.fn(x.reshape(1, -1, NORMAL_DIM), gpeak.params).reshape(x.shape[:-1])

    mops.reset_kernel_launch_count()
    t0 = time.perf_counter()
    nres = ZMCNormal(normal_fn, np.tile([[0.0, 1.0]], (NORMAL_DIM, 1)), seed=0,
                     mesh=mesh, use_kernel=True).evaluate(num_trials=NORMAL_TRIALS)
    torch.cuda.synchronize()
    out["normal"] = dict(integral=nres.integral, trial_std=nres.trial_std,
                         s_per_trial=(time.perf_counter() - t0) / NORMAL_TRIALS,
                         moments_launches=mops.kernel_launch_count())
    # compressed_psum over "data" against the exact sum and its int8 bound
    x = torch.randn(4096, device=device, generator=torch.Generator(
        device=device).manual_seed(20 + collectives.axis_index(mesh, ("data",))))
    exact = collectives.psum_fixed(x, mesh, ("data",))
    comp = compression.compressed_psum(x, mesh, "data")
    amax = float(collectives.pmax(x.abs().max(), mesh, ("data",)))
    out["compressed"] = dict(err=float((comp - exact).abs().max()),
                             bound=2 * amax / 127 + 1e-5,
                             on_card=comp.device.type == "cuda")
    # the kernel on this rank's shard of one Fig.-1 trial: against its plain
    # version at N_CHECK, then timed at N_MAIN with the ranks taking turns
    per_shard, first, n_local = multi._sample_window(mesh, ("data",), N_MAIN)
    rbs = multi._rank_buckets(plans["mc"], mesh, "model")
    err = 0.0
    for rb in rbs:
        scal = template.pack_scalars(key, first, N_CHECK)
        k = multi._launch_local(rb, scal, N_CHECK // template.S_BLK, "mc")[0]
        b = rb.local
        p = template.fused_mc_plain(scal, b.fn_ids, b.packed, b.lo, b.hi, b.block_forms,
                                    dim=b.dim, n_sample_blocks=N_CHECK // template.S_BLK,
                                    block_tcols=b.block_tcols)[0]
        real = torch.zeros(b.fn_ids.shape[0], dtype=torch.bool, device=device)
        r0 = rb.b0 * template.F_BLK
        for sl in rb.padded.slices:
            lo_r, hi_r = max(sl.row_start, r0), min(sl.row_start + sl.n_fn, r0 + real.numel())
            if lo_r < hi_r:
                real[lo_r - r0:hi_r - r0] = True
        check(torch.allclose(k[real], p[real], rtol=RTOL, atol=ATOL),
              f"rank {rank}: the kernel disagrees with plain on its shard")
        err = max(err, float((k[real] - p[real]).abs().max()))
    rows = [int(sum(max(0, min(sl.row_start + sl.n_fn, (rb.b1) * template.F_BLK)
                        - max(sl.row_start, rb.b0 * template.F_BLK))
                    for sl in rb.padded.slices)) for rb in rbs]
    out["shard"] = dict(max_abs_err=err, n_local=n_local,
                        draws=sum(n * rb.local.dim for n, rb in zip(rows, rbs)) * n_local,
                        values=sum(rows) * n_local)
    scal = template.pack_scalars(key, first, n_local)
    blocks = -(-per_shard // template.S_BLK)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        parts = [multi._launch_local(rb, scal, blocks, "mc")[0] for rb in rbs]
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(TIMING_REPS):
            parts = [multi._launch_local(rb, scal, blocks, "mc")[0] for rb in rbs]
        ev1.record()
        torch.cuda.synchronize()
        out["shard"]["ms"] = ev0.elapsed_time(ev1) / TIMING_REPS
        if rank == 0:
            ev0.record()
            for rb in rbs:
                b = rb.local
                template.fused_mc_plain(scal, b.fn_ids, b.packed, b.lo, b.hi,
                                        b.block_forms, dim=b.dim, n_sample_blocks=blocks,
                                        block_tcols=b.block_tcols)
            ev1.record()
            torch.cuda.synchronize()
            out["shard"]["plain_ms"] = ev0.elapsed_time(ev1)
    dist.barrier()
    parts = [multi._launch_local(rb, scal, blocks, "mc")[0] for rb in rbs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMING_REPS):
        for part in parts:
            collectives.psum_gather_rows(part, mesh, ("data",), "model")
    torch.cuda.synchronize()
    out["shard"]["collectives_ms"] = (time.perf_counter() - t0) * 1e3 / TIMING_REPS
    return out


def state_rank(state_dir: str, waves) -> dict:
    """One of step 21's four gloo ranks: service configuration 2 on the
    (2, 2) mesh with a state dir that rank 0 owns.  With ``waves`` the run
    stops after that many waves and is abandoned (no close(): no
    snapshot, the lease left behind); without, it runs to the end, closes,
    and a fresh engine replays it warm.  Every wave is timed, with its
    ``deposit`` and ``wal_commit`` spans and the time the rank spent in
    the store's operations (each ends in a broadcast from rank 0), its
    kernel launches counted, and the pid in lease.json read after it."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import template
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.obs import Observability
    from repro_torch.obs.trace import span_totals
    from repro_torch.service import IntegrationEngine, IntegrationRequest

    device = torch.device("cuda", 0)
    spec, _ = fig1_spec(device)
    mesh = make_mesh_for(model_parallel=2, device="cuda")
    lease = os.path.join(state_dir, "lease.json")
    out = {"rank": dist.get_rank(), "pid": os.getpid(), "lease_pids": set()}

    def lease_pid():
        if os.path.exists(lease):
            with open(lease, encoding="utf-8") as f:
                out["lease_pids"].add(json.load(f)["pid"])

    def serve(stop=None, path=state_dir):
        events, store_s = [], [0.0]
        t0 = time.perf_counter()
        engine = IntegrationEngine(round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R,
                                   mesh=mesh, state_dir=path,
                                   obs=Observability.enabled(sinks=[events.append]))
        run = dict(open_s=time.perf_counter() - t0)
        if path is not None:
            on_rank0 = engine.store._on_rank0

            def timed(fn, **kw):
                t = time.perf_counter()
                try:
                    return on_rank0(fn, **kw)
                finally:
                    store_s[0] += time.perf_counter() - t

            engine.store._on_rank0 = timed
        lease_pid()
        template.reset_launch_count()
        template.reset_kernel_launch_count()
        t0 = time.perf_counter()
        tickets = [engine.submit(IntegrationRequest.make([f], n_samples=N_FULL))
                   for f in spec.families]
        run["submit_s"] = time.perf_counter() - t0
        run.update(wave_s=[], store_s=[], deposit_s=[], wal_s=[])
        while stop is None or len(run["wave_s"]) < stop:
            del events[:]
            store_s[0] = 0.0
            t0 = time.perf_counter()
            if not engine.step():
                break
            torch.cuda.synchronize()
            run["wave_s"].append(time.perf_counter() - t0)
            tot = span_totals(events)
            run["store_s"].append(store_s[0])
            run["deposit_s"].append(tot.get("deposit", 0.0))
            run["wal_s"].append(tot.get("wal_commit", 0.0))
            lease_pid()
        served = [engine.poll(t) for t in tickets]
        run.update(dispatches=template.launch_count(),
                   kernel_launches=template.kernel_launch_count(),
                   counts=template.kernel_launch_counts(),
                   hits=sum(r is not None and r.served_from_cache for r in served),
                   fallback=engine.batcher.fallback_rounds)
        if all(r is not None for r in served):
            run["means"] = np.concatenate([r.means for r in served])
            run["stderrs"] = np.concatenate([r.stderrs for r in served])
        return engine, run

    if waves is not None:
        _, out["abandoned"] = serve(stop=waves)
        return out              # the engine is dropped unclosed
    engine, out["resumed"] = serve()
    t0 = time.perf_counter()
    engine.close()
    out["resumed"]["close_s"] = time.perf_counter() - t0
    engine, out["replay"] = serve()
    engine.close()
    # in these processes, now warm, turns without a state dir and with a
    # fresh one (none, dir, dir, none): the journal's cost per wave apart
    # from a fresh process's first wave
    out["turns"] = []
    for k, disk in enumerate((False, True, True, False)):
        engine, run = serve(path=f"{state_dir}_warm{k}" if disk else None)
        engine.close()
        out["turns"].append((disk, run["wave_s"], run["store_s"], run["submit_s"]))
    # one outcome broadcast alone (what every store operation adds)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.broadcast_object_list([None, None], src=0)
    out["broadcast_s"] = (time.perf_counter() - t0) / 20
    # the state dir's file system: one journal-sized append and its fsync
    if out["rank"] == 0:
        path = os.path.join(state_dir, "fsync_probe")
        fsync_s = []
        with open(path, "ab") as f:
            for _ in range(5):
                f.write(os.urandom(100_000))
                f.flush()
                t0 = time.perf_counter()
                os.fsync(f.fileno())
                fsync_s.append(time.perf_counter() - t0)
        os.unlink(path)
        out["fsync_s"] = fsync_s
    return out


def lm_run(model, batch: dict, steps: int, tokens=None):
    """Prefill, then ``steps`` decode steps fed ``tokens`` (B, steps) or,
    without them, the greedy choice.  Returns (the steps + 1 logits, the
    tokens fed)."""
    import torch
    logits, cache = model.prefill(batch, LM_CAP)
    out, fed = [logits], []
    for i in range(steps):
        tok = (tokens[:, i:i + 1] if tokens is not None
               else torch.argmax(logits, dim=-1)[:, None].to(torch.int32))
        fed.append(tok)
        logits, cache = model.decode_step(cache, tok, LM_PROMPT + i, LM_CAP)
        out.append(logits)
    return out, torch.cat(fed, dim=1)


def lm_bounds(cfg, experts_per_step: float | None = None, batch: int = LM_BATCH,
              prompt: int = LM_PROMPT) -> dict:
    """The least time the card could take for step 22's (and 23's, 24's)
    prefill of ``batch`` prompts of ``prompt`` tokens, one decode step (the
    mean over the 64 positions served) and a generate call: the larger of
    the bytes over the HBM rate and the operations over the bf16 peak.
    Weights are the layers and the output head in the compute dtype (not
    the embedding, whose rows are gathered, unless the head is tied to it,
    nor the mtp subtree, which serving does not read); the prefill's
    attention is the full score rectangle it computes; a decode step reads
    the cache up to its own position.  MLA: a cache row is the latent and
    the roped key, the prefill's scores are taken at nope + rope and its
    values at v_head_dim, the absorbed step's in the latent space.  MoE:
    operations count each token's ``top_k`` experts; a decode step's bytes
    count ``experts_per_step`` routed experts (the distinct experts its
    routing selected, summed over the MoE layers; every expert where not
    given), and ``formulation_bytes`` what the reference's formulation
    reads, which runs every expert's capacity rows.  SSM and hybrid: the
    hybrid's shared block is read and run once per invocation (its weights
    do not stay in the 50 MB L2 between them), each invocation with its own
    KV cache; a Mamba-2 layer's SSD adds, per token, C.B over its chunk,
    the chunk's scores against x, its share of the chunk state and the
    inter-chunk read-out (its recurrence is negligible), and its state and
    convolution tails are written by the prefill and read and written by
    each decode step, in the compute dtype."""
    from repro_torch.models import moe
    from repro_torch.models.config import count_params
    from repro_torch.models.model import param_defs
    b, s, new = batch, prompt, LM_NEW
    cap = s + new
    L, d, vp, h = cfg.n_layers, cfg.d_model, cfg.vocab_padded, cfg.n_heads
    esize = 2                                          # bf16
    defs = param_defs(cfg)
    # Mamba-2 layers, and attention layers run (the hybrid's G invocations)
    n_ssm = L if cfg.family in ("ssm", "hybrid") else 0
    n_attn = L // cfg.shared_attn_every if cfg.family == "hybrid" else L - n_ssm
    weights = (count_params(defs) - count_params(defs["embed"])
               - count_params(defs.get("mtp", {}))
               + (n_attn - 1) * count_params(defs.get("shared_attn", {}))
               + (d * vp if cfg.tie_embeddings else 0))
    head = d + d * vp                                  # final norm and head
    expert = 3 * d * cfg.moe_d_ff                      # one routed expert's weights
    moe_layers = cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" else 0
    routed = moe_layers * cfg.n_experts * expert
    layer_w = weights - routed + moe_layers * cfg.top_k * expert - head  # one token's
    if experts_per_step is None:
        experts_per_step = moe_layers * cfg.n_experts
    if cfg.attn_type == "mla":
        kv_row = n_attn * (cfg.kv_lora_rank + cfg.qk_rope_dim) * esize  # latent and key
        dqk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        step_attn = 2 * (2 * cfg.kv_lora_rank + cfg.qk_rope_dim)   # per head and position
    else:
        kv_row = 2 * n_attn * cfg.n_kv_heads * cfg.head_dim * esize  # K and V, all layers
        dqk = dv = cfg.head_dim
        step_attn = 2 * (dqk + dv)
    pre_flops = 2 * layer_w * b * s + 2 * b * n_attn * h * s * s * (dqk + dv) + 2 * d * vp * b
    pre_bytes = weights * esize + b * s * d * esize + b * cap * kv_row + b * vp * esize
    state = ssd = step_ssm = 0
    if n_ssm:
        di, n, q = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_chunk
        state = n_ssm * b * (di * n + (cfg.ssm_conv_width - 1) * (di + 2 * n)) * esize
        s_pad = -(-s // q) * q
        ssd = n_ssm * b * s_pad * (2 * q * n + 2 * q * di + 4 * n * di)
        step_ssm = n_ssm * b * 6 * di * n   # decay, dt B x, add, C . state
    pre_flops += ssd
    pre_bytes += state
    read = (weights - routed + experts_per_step * expert) * esize
    dec_flops = dec_bytes = form_bytes = 0.0
    for i in range(new):
        pos = s + i
        dec_flops += 2 * (layer_w + d * vp) * b + b * n_attn * h * (pos + 1) * step_attn + step_ssm
        rest = b * d * esize + b * (pos + 1) * kv_row + b * vp * esize + 2 * state
        dec_bytes += read + rest
        form_bytes += weights * esize + rest
    dec_flops, dec_bytes, form_bytes = dec_flops / new, dec_bytes / new, form_bytes / new
    pre = max(pre_flops / H100_BF16_FLOPS, pre_bytes / H100_HBM_BYTES_S)
    dec = max(dec_flops / H100_BF16_FLOPS, dec_bytes / H100_HBM_BYTES_S)
    out = dict(prefill_ms=1e3 * pre, decode_ms=1e3 * dec,
               prefill_by="operations" if pre_flops / H100_BF16_FLOPS
               >= pre_bytes / H100_HBM_BYTES_S else "bytes",
               decode_by="operations" if dec_flops / H100_BF16_FLOPS
               >= dec_bytes / H100_HBM_BYTES_S else "bytes",
               prefill_flops=pre_flops, decode_bytes=dec_bytes,
               tokens_per_s=b * new / (pre + new * dec))
    if moe_layers:
        t = b * s
        out.update(formulation_bytes=form_bytes,
                   formulation_ms=1e3 * form_bytes / H100_HBM_BYTES_S,
                   active_params=layer_w + head,
                   # the formulation's expert rows in the prefill over the active ones
                   expert_rows_ratio=cfg.n_experts * moe.capacity(t, cfg) / (t * cfg.top_k))
    return out


def rel_rms(a, b) -> float:
    """RMS of a - b over the RMS of b, in f32."""
    d = a.float() - b.float()
    return float(d.pow(2).mean().sqrt() / b.float().pow(2).mean().sqrt())


def worst_rms(got: dict, want: dict, device) -> tuple[float, str]:
    """The largest relative RMS (in f64, on ``device``) over the leaves of
    two name -> tensor dicts, and its leaf."""
    import torch
    errs = {}
    for n, w in want.items():
        w = w.to(device, torch.float64)
        d = got[n].to(device, torch.float64) - w
        errs[n] = float(d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
    worst = max(errs, key=errs.get)
    return errs[worst], worst


@contextlib.contextmanager
def f64_upcasts():
    """Inside, ``Tensor.float()`` leaves an f64 tensor as it is: the model's
    f32 upcasts (the norms' statistics, attention scores, the logits) keep
    an f64 run in f64 throughout.  Step 26's witness of gate (a1)."""
    import torch
    plain = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else plain(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = plain


def lm_layerwise(model, tokens, tok) -> list[float]:
    """Gate (b): every block's decode step at position S (the prompt's
    length) against the same block's prefill over S + 1 positions, both fed
    the prefill's input to that block, the cache of positions < S from a
    prefill of the prompt's rows; then the head on the two last outputs.
    Blocks in the order they run (``Model.plan``: the hybrid's shared block
    at each of its invocations).  Returns each block's ``rel_rms`` and the
    logits' last."""
    import torch
    s = tokens.shape[1]
    x, positions = model.embed_input({"tokens": torch.cat([tokens, tok], 1)})
    errs = []
    for block in model.plan:
        y, _ = block.prefill(x, positions, LM_CAP)
        _, cache = block.prefill(x[:, :s], positions[:, :s], LM_CAP)
        d, _ = block.decode(x[:, s:], cache, s)
        errs.append(rel_rms(d, y[:, s:]))
        x = y
    v = model.cfg.vocab_size
    errs.append(rel_rms(model.logits(d)[..., :v], model.logits(y[:, s:])[..., :v]))
    return errs


def lm_depth_probe() -> None:
    """Not part of the run: how the seeded dense models amplify rounding
    with depth, the evidence behind gates (a) and (b) of step 22.  On the
    card, at full width, the decode step at 512 against a prefill over 513
    and two prefills' shared position 511, by depth and compute dtype; on
    the CPU, at d = 512, each block's f32 output against f64.  Run as
    ``python -c 'import chip_smoke as c; c.lm_depth_probe()'``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import blocks
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in LM_ARCHS:
        full = get_config(arch)
        v = full.vocab_size
        for dtype, depths in (("bfloat16", (1, 2, 4, 8, 16, full.n_layers)),
                              ("float32", (2, 8, full.n_layers))):
            for n in depths:
                cfg = full.with_overrides(n_layers=n, compute_dtype=dtype)
                model = Model(cfg, device="cuda", seed=0).cast(cfg.dtype("compute"))
                tokens = concrete_batch(cfg, LM_BATCH, LM_PROMPT, train=False,
                                        device="cuda")["tokens"]
                logits, cache = model.prefill({"tokens": tokens}, LM_CAP)
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
                dec, _ = model.decode_step(cache, tok, LM_PROMPT)
                ext = model.forward({"tokens": torch.cat([tokens, tok], 1)})
                print(f"depth probe {arch} {dtype} {n} layers: decode vs prefill RMS ratio "
                      f"{rel_rms(dec[:, :v], ext[:, -1, :v]):.3e}, two prefills at "
                      f"{LM_PROMPT - 1} {rel_rms(logits[:, :v], ext[:, -2, :v]):.3e}")
                del model, cache
                torch.cuda.empty_cache()
    cfg = get_config("stablelm-3b").with_overrides(
        n_layers=24, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64, d_ff=1376,
        vocab_size=1024, compute_dtype="float32")
    model = Model(cfg, device="cpu", seed=0)
    tokens = concrete_batch(cfg, 2, 128, train=False, device="cpu")
    x32, positions = model.embed_input(tokens)
    x64, f64 = x32.double(), cfg.with_overrides(compute_dtype="float64")
    errs = []
    for block in model.blocks:
        x32 = block(x32, positions)
        x64 = blocks.dense_block(x64, block, f64, positions)
        errs.append(float((x32.double() - x64).pow(2).mean().sqrt() / x64.pow(2).mean().sqrt()))
    print(f"depth probe, CPU, d = 512, 24 layers: each block's f32 output against f64, "
          f"RMS ratio {[f'{e:.1e}' for e in errs]}")


def lm_card_vs_cpu(cfg_a, dev) -> dict:
    """Gate (a): ``cfg_a`` (full width, its depth cut, f32 compute) served on
    the card, then the same weights moved to the CPU, each running the
    prefill and ``LM_CHECK_STEPS`` decode steps fed the same tokens.
    Returns the largest |diff|, its tolerance (``LM_F32_REL`` of the largest
    |logit|) and that logit, the largest RMS ratio, the greedy tokens equal
    among the rows whose top-2 gap exceeds the tolerance, the CPU run's
    seconds, and the gate's failures."""
    import gc

    import torch
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch
    v = cfg_a.vocab_size
    srv = Server(cfg_a, device=dev, seed=0)
    batch = concrete_batch(cfg_a, LM_BATCH, LM_PROMPT, train=False, device=dev)
    card_logits, fed = lm_run(srv.compute, batch, LM_CHECK_STEPS)
    card_logits = [x[:, :v].cpu() for x in card_logits]
    t_cpu = time.perf_counter()
    cpu_model = srv.compute.cpu()                      # the same weights, moved
    cpu_logits, _ = lm_run(cpu_model, {k: x.cpu() for k, x in batch.items()},
                           LM_CHECK_STEPS, tokens=fed.cpu())
    cpu_logits = [x[:, :v] for x in cpu_logits]
    t_cpu = time.perf_counter() - t_cpu
    scale = max(float(x.abs().max()) for x in cpu_logits)
    tol = LM_F32_REL * scale
    err = max(float((c - h).abs().max()) for c, h in zip(card_logits, cpu_logits))
    rms = max(rel_rms(c, h) for c, h in zip(card_logits, cpu_logits))
    decided = agree = 0
    for c, h in zip(card_logits, cpu_logits):
        top2 = torch.topk(h, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        decided += int(sure.sum())
        agree += int((torch.argmax(c, -1) == torch.argmax(h, -1))[sure].sum())
    failures = []
    if not all(bool(torch.isfinite(x).all()) for x in card_logits + cpu_logits):
        failures.append("(a) non-finite logits")
    if err > tol:
        failures.append(f"(a) card vs CPU {err:.3e} > {tol:.3e}")
    if agree != decided:
        failures.append(f"(a) greedy tokens differ in {decided - agree} rows")
    del srv, batch, cpu_model, card_logits, cpu_logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(err=err, tol=tol, scale=scale, rms=rms, agree=agree, decided=decided,
                cpu_s=t_cpu, failures=failures)


def lm_served(full, dev) -> dict:
    """The served configuration at full width and depth: the server built
    from the seeded init (its load seconds and peak), one warm-up call and
    ``LM_TIMING_REPS`` prefills timed with CUDA events (the decode steps
    are timed inside gate (c)'s first generate).  The peak is reset after
    loading, for serving's."""
    import torch
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Server(full, device=dev, seed=0)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()      # the init draws each stacked leaf in f32
    torch.cuda.reset_peak_memory_stats()
    model = srv.compute
    batch = concrete_batch(full, LM_BATCH, LM_PROMPT, train=False, device=dev)
    srv.generate(batch, 2, seq_cap=LM_CAP)             # warm-up: cuBLAS handles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pre_ms = []
    for _ in range(LM_TIMING_REPS):
        start.record()
        logits0, _ = model.prefill(batch, LM_CAP)
        end.record()
        torch.cuda.synchronize()
        pre_ms.append(start.elapsed_time(end))
    first_tok = torch.argmax(logits0, dim=-1)[:, None].to(torch.int32)
    return dict(srv=srv, model=model, batch=batch, t_load=t_load, load_peak=load_peak,
                pre_ms=pre_ms, prefill_ms=sorted(pre_ms)[len(pre_ms) // 2], logits0=logits0,
                first_tok=first_tok)


def lm_generate_twice(srv, batch) -> dict:
    """Gate (c): two ``generate`` calls, each from a fresh cache: their wall
    seconds (``walls``) and the sha256 of their tokens (``digests``).  The
    first one's ``LM_NEW`` decode steps are timed with CUDA events, from the
    first step's start to the last one's end, the greedy picks between them
    included (``decode_ms`` a step), and their logits kept (``dec_logits``:
    the first is position ``LM_PROMPT``'s, fed the prefill's greedy pick)."""
    import torch
    model = srv.compute
    plain = model.decode_step
    events, dec_logits = [], []

    def timed(*args, **kw):
        if not events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        logits, cache = plain(*args, **kw)
        dec_logits.append(logits)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events[1:] = [end]
        return logits, cache

    walls, digests = [], []
    for i in range(2):
        model.decode_step = timed if i == 0 else plain
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = srv.generate(batch, LM_NEW, seq_cap=LM_CAP)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        digests.append(sha256_of(toks))
    del model.decode_step                              # the method again
    return dict(walls=walls, digests=digests, dec_logits=dec_logits,
                decode_ms=events[0].elapsed_time(events[1]) / LM_NEW)


def lm_serving(card: str) -> None:
    """Step 22: the LM serving path of the dense family at full width and
    depth, for each of ``LM_ARCHS``, with gates (a)-(d) and the times
    beside their bounds.  Every number of an architecture is printed before
    its gates are checked."""
    import gc

    import torch
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"step 22 peaks: {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16, "
          f"{H100_HBM_BYTES_S / 1e12:.2f} TB/s HBM (NVIDIA's H100 SXM data sheet, 700 W); "
          f"the card: {card}")
    for arch in LM_ARCHS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        v = full.vocab_size
        # (a) the card against the CPU: full width, 2 layers, f32 compute
        a = lm_card_vs_cpu(full.with_overrides(n_layers=LM_CHECK_LAYERS,
                                               compute_dtype="float32"), dev)
        failures = a["failures"]
        print(f"step 22 {arch} (a) card vs CPU, {LM_CHECK_LAYERS} layers at full width, f32 "
              f"(TF32 off), prefill + {LM_CHECK_STEPS} decode steps: max |diff| {a['err']:.3e} "
              f"against {a['tol']:.3e} ({LM_F32_REL} of the largest |logit|, {a['scale']:.3f}); "
              f"largest RMS ratio {a['rms']:.2e}; greedy tokens equal in "
              f"{a['agree']}/{a['decided']} rows whose top-2 gap exceeds it; the CPU run "
              f"{a['cpu_s']:.1f} s")

        # the served configuration at full width and depth
        run = lm_served(full, dev)
        srv, model, batch = run["srv"], run["model"], run["batch"]
        logits0, first_tok = run["logits0"], run["first_tok"]
        # (c) two generate calls, each from a fresh cache (the first's decode
        # steps timed)
        gen = lm_generate_twice(srv, batch)
        walls, digests, dec_logits = gen["walls"], gen["digests"], gen["dec_logits"]
        # (b) each block's decode step against its prefill; the free-running
        # logits and two prefills' shared position beside them, not gated
        layer_errs = lm_layerwise(model, batch["tokens"], first_tok)
        ext = model.forward({"tokens": torch.cat([batch["tokens"], first_tok], 1)})
        free = rel_rms(dec_logits[0][:, :v], ext[:, -1, :v])
        floor = rel_rms(logits0[:, :v], ext[:, -2, :v])
        same_b = int((torch.argmax(dec_logits[0][:, :v], -1)
                      == torch.argmax(ext[:, -1, :v], -1)).sum())
        # (d) no NaN or Inf in any logits of the step
        finite = all(bool(torch.isfinite(x[..., :v]).all())
                     for x in [logits0, ext] + dec_logits)
        peak = torch.cuda.max_memory_allocated()
        bd = lm_bounds(full)
        tps = LM_BATCH * LM_NEW / min(walls)
        prefill_ms, decode_ms = run["prefill_ms"], gen["decode_ms"]
        print(f"step 22 {arch}: {sum(p.numel() for p in srv.model.parameters()):,} parameters "
              f"stored in {full.param_dtype}, served in {full.compute_dtype}; loaded in "
              f"{run['t_load']:.2f} s; batch {LM_BATCH} x {LM_PROMPT}-token prompts, {LM_NEW} "
              f"new tokens, cache {LM_CAP}")
        print(f"step 22 {arch}: prefill {prefill_ms:.3f} ms (runs "
              f"{[round(x, 3) for x in run['pre_ms']]}; bound {bd['prefill_ms']:.3f} ms by "
              f"{bd['prefill_by']}, {bd['prefill_flops'] / 1e12:.3f} TFLOP; "
              f"{100 * bd['prefill_ms'] / prefill_ms:.1f}% of it)")
        print(f"step 22 {arch}: decode {decode_ms:.3f} ms per step over {LM_NEW} steps (bound "
              f"{bd['decode_ms']:.3f} ms by {bd['decode_by']}, {bd['decode_bytes'] / 1e9:.3f} GB "
              f"per step; {100 * bd['decode_ms'] / decode_ms:.1f}% of it)")
        print(f"step 22 {arch}: generate {[round(w, 4) for w in walls]} s for {LM_BATCH} x "
              f"{LM_NEW} tokens: {tps:.1f} tokens/s (bound {bd['tokens_per_s']:.1f}; "
              f"{100 * tps / bd['tokens_per_s']:.1f}% of it); peak memory "
              f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB serving, "
              f"{run['load_peak'] / 1e9:.3f} GB while loading")
        print(f"step 22 {arch} (b) bf16, full depth, each block's decode at {LM_PROMPT} vs its "
              f"prefill over {LM_PROMPT + 1} on the same input: RMS ratio max "
              f"{max(layer_errs[:-1]):.3e} over {len(layer_errs) - 1} blocks "
              f"({sum(e == 0 for e in layer_errs[:-1])} bit-equal), logits {layer_errs[-1]:.3e} "
              f"(gate {LM_BF16_LAYER_RMS}); free-running logits {free:.4f}, argmax equal in "
              f"{same_b}/{LM_BATCH} (not gated: two prefills of {LM_PROMPT} and "
              f"{LM_PROMPT + 1} tokens at position {LM_PROMPT - 1}: {floor:.4f})")
        print(f"step 22 {arch} (c) generate sha256 {digests[0][:16]} {digests[1][:16]} "
              f"{'equal' if digests[0] == digests[1] else 'DIFFER'}; (d) finite {finite}; "
              f"{time.perf_counter() - t_arch:.1f} s")
        if max(layer_errs) > LM_BF16_LAYER_RMS:
            failures.append(f"(b) decode vs prefill per block {layer_errs}")
        if digests[0] != digests[1]:
            failures.append("(c) repeated generate calls differ")
        if not finite:
            failures.append("(d) non-finite logits")
        del srv, model, batch, logits0, dec_logits, ext, run, gen
        gc.collect()
        torch.cuda.empty_cache()
        check(not failures, f"{arch}: {'; '.join(failures)}")


@contextlib.contextmanager
def routes_logged(margins: bool = False):
    """Every call of the port's MoE router while open, in order: (expert ids
    (T, k), and with ``margins`` each token's gap between its k-th and
    (k+1)-th router probability)."""
    import torch
    from repro_torch.models import moe
    route, log = moe._route, []

    def logged(x_flat, router_w, cfg):
        w, idx = route(x_flat, router_w, cfg)
        gap = None
        if margins:
            with torch.no_grad():       # a training step's router too
                probs = torch.softmax(torch.matmul(x_flat.float(), router_w.float()), dim=-1)
                top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
                gap = top[:, -2] - top[:, -1]
        log.append((idx, gap))
        return w, idx

    moe._route = logged
    try:
        yield log
    finally:
        moe._route = route


def route_flips(card_log, cpu_log, n_experts: int) -> tuple[int, float, float]:
    """(token, expert) choices that differ between two logs of the same
    calls, the smallest k-th to (k+1)-th margin of the second log, and the
    smallest margin among the tokens whose choices differ (inf if none)."""
    import torch
    flips, least, at_flip = 0, float("inf"), float("inf")
    for (a, _), (b, gap) in zip(card_log, cpu_log, strict=True):
        one = lambda idx: torch.zeros(idx.shape[0], n_experts, dtype=torch.bool).scatter_(
            1, idx.cpu(), True)
        diff = one(a) != one(b)
        flips += int(diff.sum()) // 2
        least = min(least, float(gap.min()))
        moved = diff.any(dim=1)
        if moved.any():
            at_flip = min(at_flip, float(gap.cpu()[moved].min()))
    return flips, least, at_flip


def decode_profile(model, batch: dict, steps: int = 4) -> str:
    """``steps`` greedy decode steps from a fresh prefill under
    ``torch.profiler``: wall and device-busy ms per step, the device's
    operations per step and the five that take the most device time."""
    import torch
    logits, cache = model.prefill(batch, LM_CAP)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

    def run(i):
        nonlocal logits, cache, tok
        logits, cache = model.decode_step(cache, tok, LM_PROMPT + i)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

    return profile_steps(run, steps)


def profile_steps(run, steps: int, top_n: int = 5, by_op: bool = False) -> str:
    """``run(i)`` for i < ``steps`` under ``torch.profiler``: wall and
    device-busy ms per step, the device's operations per step and the
    ``top_n`` that take the most device time; ``by_op`` adds the ``top_n``
    PyTorch operators whose own launches take the most device time (each
    kernel under the operator it is linked to).  It sums the profiler's raw
    events: building ``key_averages`` from them takes tens of seconds for a
    profile of 10^4 device operations, on the host between steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    raw = prof.profiler.kineto_results.events()
    on_device = [e for e in raw if e.device_type() == DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in on_device) / 1e6 / steps
    if busy == 0:
        return f"{wall:.3f} ms wall per step; device time not measured (no CUDA events)"

    def most(keyed) -> str:
        """The ``top_n`` keys by device time: (key, event, what one call
        of the key is) -> "key ms xcalls" per step."""
        totals: dict = {}
        for key, e, call in keyed:
            t = totals.setdefault(key, [0, set()])
            t[0] += e.duration_ns()
            t[1].add(call)
        top = sorted(totals.items(), key=lambda kv: kv[1][0], reverse=True)[:top_n]
        return "; ".join(f"{k[:60]} {ns / 1e6 / steps:.3f} ms x{len(calls) // steps}"
                         for k, (ns, calls) in top)

    out = (f"{wall:.3f} ms wall per step, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%, "
           f"idle {100 - 100 * busy / wall:.1f}%), {len(on_device) / steps:.0f} device "
           f"operations per step; most device time: "
           + most((e.name(), e, i) for i, e in enumerate(on_device)))
    if by_op:   # an operator's own launches: each kernel counted once, under its launcher
        ops = {e.correlation_id(): e.name() for e in raw
               if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0}
        out += "; by operator: " + most((ops.get(e.linked_correlation_id(), "(none)"), e,
                                         e.linked_correlation_id()) for e in on_device)
    return out


def lm_moe_serving(card: str) -> None:
    """Step 23: the LM serving path of the moe family (MLA and MoE) for each
    of ``LM_MOE_ARCHS``, with step 22's traffic, gates (a)-(d) and the times
    beside their bounds.  Every number of an architecture is printed before
    its gates are checked."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"step 23: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before it; "
          f"on {card}")
    for arch, depth, gate_a in LM_MOE_ARCHS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        label = arch if depth is None else f"{arch} (depth {depth} of {full.n_layers})"
        if depth is not None:
            full = full.with_overrides(n_layers=depth)
        v = full.vocab_size
        n_moe = full.n_layers - full.first_dense_layers
        failures = []
        if gate_a:
            # (a) the card against the CPU: full width, 1 dense and 1 MoE
            # layer, f32 compute; the router's choices compared call by call
            cfg_a = full.with_overrides(n_layers=full.first_dense_layers + 1,
                                        compute_dtype="float32")
            srv = Server(cfg_a, device=dev, seed=0)
            batch = concrete_batch(cfg_a, LM_BATCH, LM_PROMPT, train=False, device=dev)
            with routes_logged(margins=True) as card_log:
                card_logits, fed = lm_run(srv.compute, batch, LM_CHECK_STEPS)
            card_logits = [x[:, :v].cpu() for x in card_logits]
            t_cpu = time.perf_counter()
            cpu_model = srv.compute.cpu()              # the same weights, moved
            with routes_logged(margins=True) as cpu_log:
                cpu_logits, _ = lm_run(cpu_model, {k: x.cpu() for k, x in batch.items()},
                                       LM_CHECK_STEPS, tokens=fed.cpu())
            cpu_logits = [x[:, :v] for x in cpu_logits]
            t_cpu = time.perf_counter() - t_cpu
            flips, least, at_flip = route_flips(card_log, cpu_log, full.n_experts)
            scale_a = max(float(x.abs().max()) for x in cpu_logits)
            tol_a = LM_F32_REL * scale_a
            err_a = max(float((c - h).abs().max()) for c, h in zip(card_logits, cpu_logits))
            rms_a = max(rel_rms(c, h) for c, h in zip(card_logits, cpu_logits))
            decided = agree = 0
            for c, h in zip(card_logits, cpu_logits):
                top2 = torch.topk(h, 2, dim=-1).values
                sure = (top2[:, 0] - top2[:, 1]) > tol_a
                decided += int(sure.sum())
                agree += int((torch.argmax(c, -1) == torch.argmax(h, -1))[sure].sum())
            finite_a = all(bool(torch.isfinite(x).all()) for x in card_logits + cpu_logits)
            print(f"step 23 {label} (a) card vs CPU, {cfg_a.n_layers} layers (1 MoE) at full "
                  f"width, f32 (TF32 off), prefill + {LM_CHECK_STEPS} decode steps: max |diff| "
                  f"{err_a:.3e} against {tol_a:.3e} ({LM_F32_REL} of the largest |logit|, "
                  f"{scale_a:.3f}); largest RMS ratio {rms_a:.2e}; greedy tokens equal in "
                  f"{agree}/{decided} rows whose top-2 gap exceeds it; router: {flips} of "
                  f"{sum(int(i.numel()) for i, _ in cpu_log)} (token, expert) choices differ "
                  f"over {len(cpu_log)} calls, smallest k-th to (k+1)-th probability margin "
                  f"{least:.3e}, {'no token differs' if flips == 0 else f'at a differing token {at_flip:.3e}'}; "
                  f"the CPU run {t_cpu:.1f} s")
            if not finite_a:
                failures.append("(a) non-finite logits")
            if err_a > tol_a:
                failures.append(f"(a) card vs CPU {err_a:.3e} > {tol_a:.3e}")
            if agree != decided:
                failures.append(f"(a) greedy tokens differ in {decided - agree} rows")
            del srv, batch, cpu_model, card_logits, cpu_logits, card_log, cpu_log
            gc.collect()
            torch.cuda.empty_cache()

        # the served configuration
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv = Server(full, device=dev, seed=0)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated()  # the init draws each stacked leaf in f32
        torch.cuda.reset_peak_memory_stats()
        model = srv.compute
        batch = concrete_batch(full, LM_BATCH, LM_PROMPT, train=False, device=dev)
        srv.generate(batch, 2, seq_cap=LM_CAP)         # warm-up: cuBLAS handles
        with routes_logged() as log:                   # the served capacity's drops
            model.prefill(batch, LM_CAP)
        cap = moe.capacity(LM_BATCH * LM_PROMPT, full)
        dropped = [int((~moe.dispatch_plan(idx, full)[3]).sum()) for idx, _ in log]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        pre_ms = []
        for _ in range(LM_TIMING_REPS):
            start.record()
            logits0, cache = model.prefill(batch, LM_CAP)
            end.record()
            torch.cuda.synchronize()
            pre_ms.append(start.elapsed_time(end))
        prefill_ms = sorted(pre_ms)[len(pre_ms) // 2]
        del cache
        first_tok = torch.argmax(logits0, dim=-1)[:, None].to(torch.int32)
        # (c) two generate calls, each from a fresh cache: the first's decode
        # steps timed, their routes logged after its prefill's
        with routes_logged() as log:
            gen = lm_generate_twice(srv, batch)
        walls, digests, dec_logits = gen["walls"], gen["digests"], gen["dec_logits"]
        decode_ms = gen["decode_ms"]
        check(len(log) == 2 * (LM_NEW + 1) * n_moe,
              f"{arch}: {len(log)} router calls in two generates")
        distinct = [int(idx.unique().numel()) for idx, _ in log[n_moe:(LM_NEW + 1) * n_moe]]
        experts_per_step = sum(distinct) / LM_NEW
        del log
        peak = torch.cuda.max_memory_allocated()
        profiled = decode_profile(model, batch)
        # (b) each block's decode step against its prefill, MoE blocks
        # dropless, request by request on the served weights: gated in f32
        # compute (each bf16 weight cast at its use), printed in bf16 as
        # served, where MLA's absorbed step and its expanded prefill round
        # scores of ~1e3 to bf16 in two different ways, as the reference's
        # do (LM_MOE_ARCHS); the free-running logits and two prefills'
        # shared position beside them, not gated
        errs = {}
        for dtype in ("bfloat16", "float32"):
            twin = Model(full.with_overrides(compute_dtype=dtype,
                                             capacity_factor=full.n_experts / full.top_k),
                         device="meta", dtype=full.dtype("param"))
            twin.load_state_dict(model.state_dict(), assign=True)
            per = [lm_layerwise(twin, batch["tokens"][i:i + 1], first_tok[i:i + 1])
                   for i in range(LM_BATCH)]
            errs[dtype] = [max(e) for e in zip(*per)]
            if dtype == "bfloat16":
                ext = twin.forward({"tokens": torch.cat([batch["tokens"], first_tok], 1)})
            del twin, per
            torch.cuda.empty_cache()
        layer_errs = errs["float32"]
        free = rel_rms(dec_logits[0][:, :v], ext[:, -1, :v])
        floor = rel_rms(logits0[:, :v], ext[:, -2, :v])
        same_b = int((torch.argmax(dec_logits[0][:, :v], -1)
                      == torch.argmax(ext[:, -1, :v], -1)).sum())
        # (d) no NaN or Inf in any logits of the step
        finite = all(bool(torch.isfinite(x[..., :v]).all())
                     for x in [logits0, ext] + dec_logits)
        bd = lm_bounds(full, experts_per_step)
        tps = LM_BATCH * LM_NEW / min(walls)
        n_params = sum(p.numel() for p in srv.model.parameters())
        print(f"step 23 {label}: {n_params:,} parameters ({bd['active_params']:,} read per "
              f"token: no embedding, no mtp, top-{full.top_k} of {full.n_experts} experts) "
              f"stored in {full.param_dtype}, served in {full.compute_dtype}; loaded in "
              f"{t_load:.2f} s; batch {LM_BATCH} x {LM_PROMPT}-token prompts, {LM_NEW} new "
              f"tokens, cache {LM_CAP}")
        print(f"step 23 {label}: prefill {prefill_ms:.3f} ms (runs "
              f"{[round(x, 3) for x in pre_ms]}; bound {bd['prefill_ms']:.3f} ms by "
              f"{bd['prefill_by']}, {bd['prefill_flops'] / 1e12:.3f} TFLOP; "
              f"{100 * bd['prefill_ms'] / prefill_ms:.1f}% of it); the formulation's expert "
              f"rows {bd['expert_rows_ratio']:.3f}x the active ones (capacity {cap} per expert "
              f"at {full.capacity_factor}); dropped (token, expert) pairs per MoE layer "
              f"{dropped} of {LM_BATCH * LM_PROMPT * full.top_k}")
        print(f"step 23 {label}: decode {decode_ms:.3f} ms per step over {LM_NEW} steps (bound "
              f"{bd['decode_ms']:.3f} ms by {bd['decode_by']}, {bd['decode_bytes'] / 1e9:.3f} GB "
              f"per step with {experts_per_step:.2f} distinct experts per step over {n_moe} MoE "
              f"layers, {min(distinct)}-{max(distinct)} per layer; "
              f"{100 * bd['decode_ms'] / decode_ms:.1f}% of it); the reference's formulation "
              f"reads {bd['formulation_bytes'] / 1e9:.3f} GB per step (every expert: "
              f"{bd['formulation_ms']:.3f} ms at the HBM rate)")
        print(f"step 23 {label}: generate {[round(w, 4) for w in walls]} s for {LM_BATCH} x "
              f"{LM_NEW} tokens: {tps:.1f} tokens/s (bound {bd['tokens_per_s']:.1f}; "
              f"{100 * tps / bd['tokens_per_s']:.1f}% of it); peak memory "
              f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB serving, "
              f"{load_peak / 1e9:.3f} GB while loading")
        print(f"step 23 {label}: {LM_PROMPT}-{LM_PROMPT + 3} decode steps profiled: {profiled}")
        print(f"step 23 {label} (b) MoE blocks dropless, each block's decode at {LM_PROMPT} "
              f"vs its prefill over {LM_PROMPT + 1} on the same input, request by request, "
              f"RMS ratio: f32 compute on the bf16 weights max {max(layer_errs[:-1]):.3e} over "
              f"{len(layer_errs) - 1} blocks, logits {layer_errs[-1]:.3e} (gate "
              f"{LM_BF16_LAYER_RMS}); bf16 as served (not gated) "
              f"{[float(f'{e:.2e}') for e in errs['bfloat16']]}; free-running bf16 logits "
              f"{free:.4f}, argmax equal in {same_b}/{LM_BATCH} (not gated: two prefills of "
              f"{LM_PROMPT} and {LM_PROMPT + 1} tokens at position {LM_PROMPT - 1}: "
              f"{floor:.4f})")
        print(f"step 23 {label} (c) generate sha256 {digests[0][:16]} {digests[1][:16]} "
              f"{'equal' if digests[0] == digests[1] else 'DIFFER'}; (d) finite {finite}; "
              f"{time.perf_counter() - t_arch:.1f} s")
        if max(layer_errs) > LM_BF16_LAYER_RMS:
            failures.append(f"(b) decode vs prefill per block {layer_errs}")
        if digests[0] != digests[1]:
            failures.append("(c) repeated generate calls differ")
        if not finite:
            failures.append("(d) non-finite logits")
        del srv, model, batch, logits0, dec_logits, ext, gen
        gc.collect()
        torch.cuda.empty_cache()
        check(not failures, f"{arch}: {'; '.join(failures)}")


def cache_bytes(caches: list[dict]) -> int:
    return sum(t.numel() * t.element_size() for c in caches for t in c.values())


def lm_ssm_serving(card: str) -> None:
    """Step 24: the LM serving path of the ssm and hybrid families (the
    Mamba-2 block; zamba2's shared attention block) for each of
    ``LM_SSM_ARCHS`` at full width and depth, with step 22's traffic, gates
    (a)-(d), the times beside their bounds and a profile of four decode
    steps; then mamba2-130m's long prompt.  Every number of an
    architecture is printed before its gates are checked."""
    import gc

    import torch
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"step 24: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before it; "
          f"on {card}")
    for arch, check_over in LM_SSM_ARCHS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        v = full.vocab_size
        # (a) the card against the CPU: full width, cut depth, f32 compute
        cfg_a = full.with_overrides(compute_dtype="float32", **check_over)
        a = lm_card_vs_cpu(cfg_a, dev)
        failures = a["failures"]
        print(f"step 24 {arch} (a) card vs CPU, {cfg_a.n_layers} layers "
              f"({check_over}) at full width, f32 (TF32 off), prefill + {LM_CHECK_STEPS} "
              f"decode steps: max |diff| {a['err']:.3e} against {a['tol']:.3e} ({LM_F32_REL} of "
              f"the largest |logit|, {a['scale']:.3f}); largest RMS ratio {a['rms']:.2e}; greedy "
              f"tokens equal in {a['agree']}/{a['decided']} rows whose top-2 gap exceeds it; "
              f"the CPU run {a['cpu_s']:.1f} s")

        run = lm_served(full, dev)
        srv, model, batch = run["srv"], run["model"], run["batch"]
        logits0, first_tok = run["logits0"], run["first_tok"]
        gen = lm_generate_twice(srv, batch)                            # (c)
        walls, digests, dec_logits = gen["walls"], gen["digests"], gen["dec_logits"]
        peak = torch.cuda.max_memory_allocated()
        _, cache = model.prefill(batch, LM_CAP)
        n_cache = cache_bytes(cache)
        del cache
        profiled = decode_profile(model, batch)
        # (b) each block's decode step (each invocation of the shared block's
        # too) against its prefill in bf16 as served; the free-running logits
        # and two prefills' shared position beside them, not gated
        layer_errs = lm_layerwise(model, batch["tokens"], first_tok)
        ext = model.forward({"tokens": torch.cat([batch["tokens"], first_tok], 1)})
        free = rel_rms(dec_logits[0][:, :v], ext[:, -1, :v])
        floor = rel_rms(logits0[:, :v], ext[:, -2, :v])
        same_b = int((torch.argmax(dec_logits[0][:, :v], -1)
                      == torch.argmax(ext[:, -1, :v], -1)).sum())
        # (d) no NaN or Inf in any logits of the step
        finite = all(bool(torch.isfinite(x[..., :v]).all())
                     for x in [logits0, ext] + dec_logits)
        bd = lm_bounds(full)
        tps = LM_BATCH * LM_NEW / min(walls)
        prefill_ms, decode_ms = run["prefill_ms"], gen["decode_ms"]
        n_shared = sum(m is model.shared_attn for m in model.plan)
        print(f"step 24 {arch}: {sum(p.numel() for p in srv.model.parameters()):,} parameters "
              f"stored in {full.param_dtype}, served in {full.compute_dtype}; "
              f"{full.n_layers} Mamba-2 blocks, the shared block run {n_shared} times; loaded "
              f"in {run['t_load']:.2f} s; batch {LM_BATCH} x {LM_PROMPT}-token prompts, "
              f"{LM_NEW} new tokens, cache {LM_CAP} ({n_cache / 1e9:.4f} GB after the prefill)")
        print(f"step 24 {arch}: prefill {prefill_ms:.3f} ms (runs "
              f"{[round(x, 3) for x in run['pre_ms']]}; bound {bd['prefill_ms']:.3f} ms by "
              f"{bd['prefill_by']}, {bd['prefill_flops'] / 1e12:.3f} TFLOP; "
              f"{100 * bd['prefill_ms'] / prefill_ms:.1f}% of it)")
        print(f"step 24 {arch}: decode {decode_ms:.3f} ms per step over {LM_NEW} steps (bound "
              f"{bd['decode_ms']:.3f} ms by {bd['decode_by']}, {bd['decode_bytes'] / 1e9:.3f} GB "
              f"per step; {100 * bd['decode_ms'] / decode_ms:.1f}% of it)")
        print(f"step 24 {arch}: generate {[round(w, 4) for w in walls]} s for {LM_BATCH} x "
              f"{LM_NEW} tokens: {tps:.1f} tokens/s (bound {bd['tokens_per_s']:.1f}; "
              f"{100 * tps / bd['tokens_per_s']:.1f}% of it); peak memory "
              f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB serving, "
              f"{run['load_peak'] / 1e9:.3f} GB while loading")
        print(f"step 24 {arch}: {LM_PROMPT}-{LM_PROMPT + 3} decode steps profiled: {profiled}")
        print(f"step 24 {arch} (b) bf16, full depth, each block's decode at {LM_PROMPT} vs its "
              f"prefill over {LM_PROMPT + 1} on the same input: RMS ratio max "
              f"{max(layer_errs[:-1]):.3e} over {len(layer_errs) - 1} blocks in run order "
              f"({[float(f'{e:.2e}') for e in layer_errs[:-1]]}), logits {layer_errs[-1]:.3e} "
              f"(gate {LM_BF16_LAYER_RMS}); free-running logits {free:.4f}, argmax equal in "
              f"{same_b}/{LM_BATCH} (not gated: two prefills of {LM_PROMPT} and "
              f"{LM_PROMPT + 1} tokens at position {LM_PROMPT - 1}: {floor:.4f})")
        print(f"step 24 {arch} (c) generate sha256 {digests[0][:16]} {digests[1][:16]} "
              f"{'equal' if digests[0] == digests[1] else 'DIFFER'}; (d) finite {finite}; "
              f"{time.perf_counter() - t_arch:.1f} s")
        if max(layer_errs) > LM_BF16_LAYER_RMS:
            failures.append(f"(b) decode vs prefill per block {layer_errs}")
        if digests[0] != digests[1]:
            failures.append("(c) repeated generate calls differ")
        if not finite:
            failures.append("(d) non-finite logits")
        if arch == LM_LONG_ARCH:
            failures += lm_long_prompt(model, decode_ms, dev)
        del srv, model, batch, logits0, dec_logits, ext, run, gen
        gc.collect()
        torch.cuda.empty_cache()
        check(not failures, f"{arch}: {'; '.join(failures)}")


def lm_long_prompt(model, decode_ms_512: float, dev) -> list[str]:
    """Step 24's long prompt on ``model`` (mamba2-130m as served): one
    request of ``LM_LONG_PROMPT`` tokens and ``LM_NEW`` greedy tokens, its
    prefill and decode steps timed beside a 512-token request's, the cache's
    bytes of both (equal: the state does not grow with the sequence), the
    peak; then its gate at 2 layers in f32.  Returns the failures."""
    import gc

    import torch
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.model import Model
    cfg, s = model.cfg, LM_LONG_PROMPT
    v = cfg.vocab_size
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def serve(prompt: int) -> dict:
        batch = concrete_batch(cfg, 1, prompt, train=False, device=dev)
        model.prefill(batch, prompt + LM_NEW)          # warm-up: this shape's cuBLAS calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start.record()
        logits, cache = model.prefill(batch, prompt + LM_NEW)
        end.record()
        torch.cuda.synchronize()
        prefill_ms = start.elapsed_time(end)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        finite = bool(torch.isfinite(logits[:, :v]).all())
        start.record()
        for i in range(LM_NEW):
            logits, cache = model.decode_step(cache, tok, prompt + i)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            finite = finite and bool(torch.isfinite(logits[:, :v]).all())
        end.record()
        torch.cuda.synchronize()
        return dict(prefill_ms=prefill_ms, decode_ms=start.elapsed_time(end) / LM_NEW,
                    bytes=cache_bytes(cache), peak=torch.cuda.max_memory_allocated(),
                    finite=finite)

    short, long = serve(LM_PROMPT), serve(s)
    bd = lm_bounds(cfg, batch=1, prompt=s)
    # the gate: 2 layers in f32, the decode step at position s against the
    # last logits of a prefill over s + 1 tokens
    cfg2 = cfg.with_overrides(n_layers=LM_CHECK_LAYERS, compute_dtype="float32")
    m2 = Model(cfg2, device=dev, seed=0)
    toks = concrete_batch(cfg2, 1, s + 1, train=False, device=dev)["tokens"]
    _, cache = m2.prefill({"tokens": toks[:, :s]}, s + 1)
    dec, _ = m2.decode_step(cache, toks[:, s:], s)
    ext, _ = m2.prefill({"tokens": toks}, s + 1)
    dec, ext = dec[:, :v].cpu(), ext[:, :v].cpu()
    err, tol = float((dec - ext).abs().max()), LM_F32_REL * float(ext.abs().max())
    print(f"step 24 {cfg.name} long prompt, batch 1: prefill of {s} tokens {long['prefill_ms']:.3f} "
          f"ms (bound {bd['prefill_ms']:.3f} ms by {bd['prefill_by']}, "
          f"{100 * bd['prefill_ms'] / long['prefill_ms']:.1f}% of it; {LM_PROMPT} tokens "
          f"{short['prefill_ms']:.3f} ms); decode {long['decode_ms']:.3f} ms per step over "
          f"{LM_NEW} steps (bound {bd['decode_ms']:.4f} ms by {bd['decode_by']}; at "
          f"{LM_PROMPT} tokens {short['decode_ms']:.3f} ms at batch 1, {decode_ms_512:.3f} at "
          f"batch {LM_BATCH}); cache {long['bytes']:,} bytes ({LM_PROMPT} tokens: "
          f"{short['bytes']:,}); peak memory torch.cuda.max_memory_allocated "
          f"{long['peak'] / 1e9:.3f} GB ({LM_PROMPT} tokens: {short['peak'] / 1e9:.3f} GB); "
          f"finite {long['finite'] and short['finite']}")
    print(f"step 24 {cfg.name} long prompt gate, {LM_CHECK_LAYERS} layers in f32 (TF32 off): "
          f"decode at {s} vs the last logits of a prefill over {s + 1}: max |diff| {err:.3e} "
          f"against {tol:.3e} ({LM_F32_REL} of the largest |logit|); RMS ratio "
          f"{rel_rms(dec, ext):.2e}")
    failures = []
    if long["bytes"] != short["bytes"]:
        failures.append(f"long prompt: cache {long['bytes']} bytes, {short['bytes']} at "
                        f"{LM_PROMPT} tokens")
    if not (long["finite"] and short["finite"]):
        failures.append("long prompt: non-finite logits")
    if err > tol:
        failures.append(f"long prompt: decode vs prefill {err:.3e} > {tol:.3e}")
    del m2, cache
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def train_bounds(cfg, batch: int, seq: int, optimizer: str = "adamw") -> dict:
    """The least time the card could take for one train step of ``batch``
    sequences of ``seq`` tokens under full remat: forward and backward at
    the bf16 peak, 8 N T matmul operations (N the weights a token meets: the
    layers and the head, not the embedding table unless the head is tied to
    it; of a MoE layer's routed experts only the ``top_k`` its router picks,
    beside the shared ones, as ``lm_bounds`` counts them; the hybrid's
    shared block once per invocation; the MTP block, and the head a second
    time, where ``mtp_depth`` asks for them; 2 forward, 2 the recompute, 4
    backward) plus the attention rectangles the port computes whole (4 B h
    S^2 (dqk + dv) an attention layer forward, 4 times; MLA's at nope +
    rope and v_head_dim) and the Mamba-2 SSD's per-token terms
    (``lm_bounds``'s, 4 times); then at the HBM rate the clip's 3 reads and
    writes of each gradient (12 bytes a parameter in f32: read for the norm,
    read and written for the scale) and the optimizer's least traffic:
    AdamW's parameter, gradient and both moments read and the parameter and
    moments written (28 bytes a parameter in f32), Adafactor's parameter
    and gradient read and the parameter written, its unfactored second
    moments read and written, its factored row and column statistics read
    and written.  The least memory is the parameters, the gradients and the
    optimizer's state."""
    import math

    import torch
    from repro_torch.models.config import count_params, flatten
    from repro_torch.models.model import param_defs
    defs = param_defs(cfg)
    n_params = count_params(defs)
    d, vp, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    n_ssm = L if cfg.family in ("ssm", "hybrid") else 0
    n_attn = L // cfg.shared_attn_every if cfg.family == "hybrid" else L - n_ssm
    moe_layers = L - cfg.first_dense_layers if cfg.family == "moe" else 0
    head = count_params(defs["head"]) if "head" in defs else d * vp
    matmul = (n_params - count_params(defs["embed"]) + (d * vp if cfg.tie_embeddings else 0)
              - moe_layers * (cfg.n_experts - cfg.top_k) * 3 * d * cfg.moe_d_ff
              + max(n_attn - 1, 0) * count_params(defs.get("shared_attn", {}))
              + (head if cfg.mtp_depth else 0))
    tokens = batch * seq
    flops = 8 * matmul * tokens
    if cfg.attn_type == "mla":
        dqk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        dqk = dv = cfg.head_dim
    attn_runs = n_attn + (1 if cfg.mtp_depth else 0)
    flops += 4 * 4 * batch * cfg.n_heads * seq * seq * (dqk + dv) * attn_runs
    if n_ssm:
        di, n, q = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_chunk
        s_pad = -(-seq // q) * q
        flops += 4 * n_ssm * batch * s_pad * (2 * q * n + 2 * q * di + 4 * n * di)
    pb = torch.finfo(cfg.dtype("param")).bits // 8          # parameters and gradients
    if optimizer == "adamw":
        mb = torch.finfo(cfg.dtype("opt")).bits // 8
        opt_bytes = n_params * (3 * pb + 4 * mb)
        opt_state = 2 * mb * n_params
    else:
        opt_state = 0
        for p in flatten(defs).values():
            sh = p.shape
            if len(sh) >= 2 and sh[-1] >= 128 and sh[-2] >= 128:
                opt_state += 4 * (math.prod(sh[:-1]) + math.prod(sh[:-2]) * sh[-1])
            else:
                opt_state += 4 * math.prod(sh)
        opt_bytes = 3 * pb * n_params + 2 * opt_state
    fb = flops / H100_BF16_FLOPS
    clip = 3 * pb * n_params / H100_HBM_BYTES_S
    opt = opt_bytes / H100_HBM_BYTES_S
    step = fb + clip + opt
    return dict(params=n_params, matmul_params=matmul, tokens=tokens, flops=flops,
                fb_ms=1e3 * fb, clip_ms=1e3 * clip, opt_ms=1e3 * opt, step_ms=1e3 * step,
                tokens_per_s=tokens / step, opt_state_bytes=opt_state,
                state_bytes=2 * pb * n_params + opt_state)


DIGEST_CHUNK = 1 << 28     # bytes of a tensor hashed as one piece


def state_digest(state) -> str:
    """sha256 over a train state, in the reference's order of leaf names:
    each tensor (a stage leaf layer by layer) cut into ``DIGEST_CHUNK``-byte
    pieces, each piece copied to the host and hashed on a pool of threads
    (hashlib lets go of the GIL), then one sha256 over the names and the
    pieces' digests.  Equal digests mean equal bytes, as one sha256 over all
    of them would; the pool makes a 20 GB state a few seconds' work."""
    import concurrent.futures

    import torch
    from repro_torch.distributed.checkpoint import leaf_paths
    from repro_torch.optim.optimizers import is_stacked
    pieces = []
    for name, leaf in leaf_paths(state):
        for i, t in enumerate(leaf if is_stacked(leaf) else [leaf]):
            flat = t.detach().reshape(-1)
            if flat.dtype == torch.bfloat16:
                flat = flat.view(torch.int16)
            per = max(1, DIGEST_CHUNK // flat.element_size())
            pieces += [(f"{name}/{i}/{j}", flat[j:j + per])
                       for j in range(0, max(flat.numel(), 1), per)]

    def one(piece):
        return hashlib.sha256(piece.cpu().numpy()).digest()

    with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        digests = list(pool.map(one, (t for _, t in pieces)))
    h = hashlib.sha256()
    for (name, _), d in zip(pieces, digests):
        h.update(name.encode())
        h.update(d)
    return h.hexdigest()


def train_timed(model, hp, stream, n: int, digest: bool = False) -> dict:
    """One warm-up step, then ``n`` steps timed phase by phase with CUDA
    events: forward and backward (``TrainStep.grads``), the clip and the
    optimizer (``apply``); then one more step under ``torch.profiler``.
    Returns the medians, each step's losses and gradient norms (and every
    metric, ``metrics``), the peak memory (reset by the caller before the
    model is built), the profile's summary, and of the warm-up step's
    gradients before the clip whether every element is finite and their
    norm in f64 (the step's own norm sums f32 squares, as the reference's
    ``_global_norm``, which overflow past a norm of 1.8e19); with
    ``digest``, the state's :func:`state_digest` after the ``1 + n``
    steps, before the profiled one."""
    import torch
    from repro_torch.launch import train
    dev = model.device
    state = train.make_train_state(model, hp)
    step = train.make_train_step(model, hp)
    with train.deterministic(dev):          # the warm-up step, phase by phase
        m = step.grads(state, stream.next_batch())
        grads = [p.grad for p in model.parameters()]
        grads_finite = all(bool(torch.isfinite(g).all()) for g in grads)
        gnorm64 = float(torch.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float64) ** 2
                                       for g in grads)))
        del grads
        m["grad_norm"] = step.clip(state)
        step.apply(state)
    losses, gnorms = [float(m["loss"])], [float(m["grad_norm"])]
    logged = [{k: float(v) for k, v in m.items()}]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    fb, clip, opt, total = [], [], [], []
    for _ in range(n):
        batch = stream.next_batch()
        torch.cuda.synchronize()
        with train.deterministic(dev):
            ev[0].record()
            metrics = step.grads(state, batch)
            ev[1].record()
            gnorm = step.clip(state)
            ev[2].record()
            step.apply(state)
            ev[3].record()
        torch.cuda.synchronize()
        fb.append(ev[0].elapsed_time(ev[1]))
        clip.append(ev[1].elapsed_time(ev[2]))
        opt.append(ev[2].elapsed_time(ev[3]))
        total.append(ev[0].elapsed_time(ev[3]))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(gnorm))
        logged.append(dict({k: float(v) for k, v in metrics.items()}, grad_norm=gnorms[-1]))
    peak = torch.cuda.max_memory_allocated()
    digested = state_digest(state) if digest else None
    profiled = profile_steps(lambda i: step(state, stream.next_batch()), 1, top_n=6,
                             by_op=True)
    med = lambda xs: sorted(xs)[len(xs) // 2]
    return dict(state=state, fb_ms=med(fb), clip_ms=med(clip), opt_ms=med(opt),
                step_ms=med(total), steps_ms=total, losses=losses, gnorms=gnorms,
                metrics=logged, peak=peak, profiled=profiled, grads_finite=grads_finite,
                gnorm64=gnorm64, digest=digested)


def train_card_vs_cpu(cfg_a, dev, hp=None, batch: int = TRAIN_CHECK_BATCH,
                      seq: int = TRAIN_CHECK_SEQ, routes: bool = False, weights=None,
                      keep: bool = False, against=None,
                      tol=(TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RMS,
                           TRAIN_PARAM_RMS)) -> dict:
    """Gate (a): ``cfg_a`` (full width, cut depth, f32 or f64 compute)
    drawn on the card (or ``weights``, a host state dict, cast to its
    dtypes), the same weights copied to the CPU, one train step of the same
    TokenStream batch on each (``hp``: AdamW, 2 microbatches, warmup 0 by
    default), then each leaf compared on the card, the host's freed memory
    kept meanwhile (:func:`host_heap_kept`).  Returns the metrics of both,
    each metric's relative error, the largest of the loss and its parts
    (``ce``, ``mtp``), the largest per-leaf relative RMS of the (clipped)
    gradients (each leaf's in ``leaf_rms``) and of the updated parameters,
    the card half's, the CPU step's and the comparison's seconds and the
    failures against ``tol`` (loss, grad_norm, gradients, parameters); with
    ``routes`` the router's choices compared call by call
    (:func:`route_flips`: ``flips``, the smallest margin ``least`` and
    ``at_flip``, over ``choices`` in ``calls``); with ``keep`` the CPU
    side's weights before the step (``weights``) and its gradients
    (``grads``), on the host; with ``against`` (leaf name -> host tensor)
    each side's gradients' largest per-leaf relative RMS from those
    (``vs``: side -> (value, leaf))."""
    import gc
    import math

    import torch
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    if hp is None:
        hp = train.TrainHParams(warmup_steps=0, total_steps=10, grad_accum=TRAIN_ACCUM)
    loss_tol, gnorm_tol, grad_tol, param_tol = tol
    t0 = time.perf_counter()
    with host_heap_kept():
        if weights is None:
            card = Model(cfg_a, device=dev, seed=0)
        else:
            card = Model(cfg_a, device="meta")
            card.load_state_dict({k: weights[k].to(dev, v.dtype)
                                  for k, v in card.state_dict().items()}, assign=True)
        cpu = Model(cfg_a, device="meta")
        cpu.load_state_dict({k: v.to("cpu", copy=True) for k, v in card.state_dict().items()},
                            assign=True)
        res = {"weights": {k: v.clone() for k, v in cpu.state_dict().items()}} if keep else {}
        data = TokenStream(cfg_a, batch, seq, seed=0, device="cpu").next_batch()
        out, logs = {}, {}
        for name, model, b in (("card", card, {k: v.to(dev) for k, v in data.items()}),
                               ("cpu", cpu, data)):
            with routes_logged(margins=True) if routes else contextlib.nullcontext([]) as log:
                state = train.make_train_state(model, hp)
                _, m = train.make_train_step(model, hp)(state, b)
                out[name] = {k: float(v) for k, v in m.items()}
            logs[name] = log
            out[name + "_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()

        def rel(a, b) -> float:           # rel_rms in two norms, on the card
            a, b = a.to(dev), b.to(dev)
            return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

        grad_rms = param_rms = 0.0
        worst = worst_p = ""
        leaf_rms = {}
        vs = {"card": (0.0, ""), "cpu": (0.0, "")}
        for (n, pc), (_, ph) in zip(card.named_parameters(), cpu.named_parameters(),
                                    strict=True):
            g = leaf_rms[n] = rel(pc.grad, ph.grad)
            if g > grad_rms:
                grad_rms, worst = g, n
            r = rel(pc.detach(), ph.detach())
            if r > param_rms:
                param_rms, worst_p = r, n
            if against is not None:
                for side, p in (("card", pc), ("cpu", ph)):
                    x = rel(p.grad, against[n])
                    if x > vs[side][0]:
                        vs[side] = (x, n)
        if keep:
            res["grads"] = {n: p.grad for n, p in cpu.named_parameters()}
        compare_s = time.perf_counter() - t0
    c, h = out["card"], out["cpu"]
    errs = {k: abs(c[k] - h[k]) / abs(h[k]) for k in h}
    loss_err = max(v for k, v in errs.items() if k != "grad_norm")
    gnorm_err = errs["grad_norm"]
    failures = []
    if not all(math.isfinite(x) for x in list(c.values()) + list(h.values())):
        failures.append("(a) non-finite metrics")
    for k in h:
        if k != "grad_norm" and errs[k] > loss_tol:
            failures.append(f"(a) {k} {c[k]} vs {h[k]}")
    if gnorm_err > gnorm_tol:
        failures.append(f"(a) grad_norm {c['grad_norm']} vs {h['grad_norm']}")
    if grad_rms > grad_tol:
        failures.append(f"(a) gradient {worst} relative RMS {grad_rms:.3e}")
    if param_rms > param_tol:
        failures.append(f"(a) parameters ({worst_p}) relative RMS {param_rms:.3e}")
    res.update(card=c, cpu=h, errs=errs, loss_err=loss_err, gnorm_err=gnorm_err,
               grad_rms=grad_rms, worst=worst, leaf_rms=leaf_rms, param_rms=param_rms,
               worst_param=worst_p, card_s=out["card_s"], cpu_s=out["cpu_s"],
               compare_s=compare_s, failures=failures, tol=tol)
    if against is not None:
        res["vs"] = vs
    if routes:
        res["flips"], res["least"], res["at_flip"] = route_flips(logs["card"], logs["cpu"],
                                                                 cfg_a.n_experts)
        res["choices"] = sum(int(i.numel()) for i, _ in logs["cpu"])
        res["calls"] = len(logs["cpu"])
    del card, cpu, state, logs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def lm_training(card: str) -> None:
    """Step 25: the LM training path at full width and depth, stablelm-3b
    (gate (a) at cut depth, the timed steps beside their bounds, gate (d))
    then mamba2-130m (gates (b), (c), (d); step ms beside its bound; the
    checkpoint's save and restore).  Every number of an architecture is
    printed before its gates are checked."""
    import dataclasses
    import gc
    import math
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch import train
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    host_flush_denormals()
    dev = torch.device("cuda", 0)
    finite = lambda xs: all(math.isfinite(x) for x in xs)
    print(f"step 25: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before it; "
          f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}; on {card}")

    # -- stablelm-3b ------------------------------------------------------------
    t_arch = time.perf_counter()
    full = get_config(TRAIN_ARCH)
    a = train_card_vs_cpu(full.with_overrides(n_layers=TRAIN_CHECK_LAYERS,
                                              compute_dtype="float32"), dev)
    failures = a["failures"]
    print(f"step 25 {TRAIN_ARCH} (a) card vs CPU, {TRAIN_CHECK_LAYERS} layers at full width, "
          f"f32 (TF32 off), one step of {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ} in "
          f"{TRAIN_ACCUM} microbatches: loss {a['card']['loss']:.7f} vs {a['cpu']['loss']:.7f} "
          f"(rel {a['loss_err']:.2e}, gate {TRAIN_LOSS_RTOL}); grad_norm "
          f"{a['card']['grad_norm']:.5f} vs {a['cpu']['grad_norm']:.5f} (rel "
          f"{a['gnorm_err']:.2e}, gate {TRAIN_GNORM_RTOL}); largest per-leaf gradient "
          f"relative RMS {a['grad_rms']:.3e} ({a['worst']}, gate {TRAIN_GRAD_RMS}); "
          f"parameters {a['param_rms']:.3e} (gate {TRAIN_PARAM_RMS}); the CPU step "
          f"{a['cpu_s']:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    hp = train.TrainHParams(grad_accum=TRAIN_ACCUM, warmup_steps=1, total_steps=10)
    model = Model(full, device=dev, seed=0)
    stream = TokenStream(full, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
    run = train_timed(model, hp, stream, TRAIN_TIMED)
    bd = train_bounds(full, TRAIN_BATCH, TRAIN_SEQ)
    tps = bd["tokens"] / (run["step_ms"] / 1e3)
    print(f"step 25 {TRAIN_ARCH}: {bd['params']:,} parameters in f32, compute "
          f"{full.compute_dtype}, AdamW f32 moments, remat {full.remat}; batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} in {TRAIN_ACCUM} microbatches ({bd['tokens']} tokens a step)")
    print(f"step 25 {TRAIN_ARCH}: forward+backward {run['fb_ms']:.3f} ms (bound "
          f"{bd['fb_ms']:.3f} ms by operations, 8 N T with N = {bd['matmul_params']:.4g} "
          f"and the attention rectangles, {bd['flops'] / 1e12:.2f} TFLOP; "
          f"{100 * bd['fb_ms'] / run['fb_ms']:.1f}% of it); clip {run['clip_ms']:.3f} ms "
          f"(bound {bd['clip_ms']:.3f} ms by bytes, 12 B a parameter; "
          f"{100 * bd['clip_ms'] / run['clip_ms']:.1f}%); optimizer {run['opt_ms']:.3f} ms "
          f"(bound {bd['opt_ms']:.3f} ms by bytes, 28 B a parameter; "
          f"{100 * bd['opt_ms'] / run['opt_ms']:.1f}%)")
    print(f"step 25 {TRAIN_ARCH}: step {run['step_ms']:.3f} ms (runs "
          f"{[round(x, 3) for x in run['steps_ms']]}; bound {bd['step_ms']:.3f} ms; "
          f"{100 * bd['step_ms'] / run['step_ms']:.1f}% of it); {tps:.1f} tokens/s (bound "
          f"{bd['tokens_per_s']:.1f}); peak memory torch.cuda.max_memory_allocated "
          f"{run['peak'] / 1e9:.3f} GB (parameters, gradients and moments "
          f"{bd['state_bytes'] / 1e9:.3f} GB)")
    print(f"step 25 {TRAIN_ARCH}: one step profiled: {run['profiled']}")
    print(f"step 25 {TRAIN_ARCH} (d) losses {[round(x, 5) for x in run['losses']]}, "
          f"grad_norm {[round(x, 4) for x in run['gnorms']]}; "
          f"{time.perf_counter() - t_arch:.1f} s")
    if not finite(run["losses"] + run["gnorms"]):
        failures.append("(d) non-finite loss or grad_norm")
    del model, stream, run
    gc.collect()
    torch.cuda.empty_cache()
    check(not failures, f"{TRAIN_ARCH} training: {'; '.join(failures)}")

    # -- mamba2-130m ----------------------------------------------------------------
    t_arch = time.perf_counter()
    cfg = get_config(SSM_TRAIN_ARCH)
    hp = dataclasses.replace(
        train.default_hparams_for(cfg, global_batch=SSM_TRAIN_BATCH, data_shards=1),
        total_steps=SSM_TRAIN_STEPS, warmup_steps=max(1, SSM_TRAIN_STEPS // 10),
        grad_accum=TRAIN_ACCUM)
    kw = dict(batch=SSM_TRAIN_BATCH, seq=SSM_TRAIN_SEQ, steps=SSM_TRAIN_STEPS, log_every=100,
              device=dev)
    failures = []
    torch.cuda.reset_peak_memory_stats()
    run = train_timed(Model(cfg, device=dev, seed=0), hp,
                      TokenStream(cfg, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, seed=0, device=dev),
                      TRAIN_TIMED)
    bd = train_bounds(cfg, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
    print(f"step 25 {SSM_TRAIN_ARCH}: {bd['params']:,} parameters in f32, compute "
          f"{cfg.compute_dtype}, remat {cfg.remat}, {hp.optimizer}; batch {SSM_TRAIN_BATCH} x "
          f"{SSM_TRAIN_SEQ} in {TRAIN_ACCUM} microbatches: forward+backward "
          f"{run['fb_ms']:.3f} ms (bound {bd['fb_ms']:.3f}), clip {run['clip_ms']:.3f} ms "
          f"(bound {bd['clip_ms']:.3f}), optimizer {run['opt_ms']:.3f} ms (bound "
          f"{bd['opt_ms']:.3f}); step {run['step_ms']:.3f} ms (bound {bd['step_ms']:.3f} ms; "
          f"{100 * bd['step_ms'] / run['step_ms']:.1f}% of it), "
          f"{bd['tokens'] / (run['step_ms'] / 1e3):.1f} tokens/s; peak "
          f"{run['peak'] / 1e9:.3f} GB; one step profiled: {run['profiled']}")
    del run
    gc.collect()
    # (b) uninterrupted, then crash at SSM_FAIL_AT and resume from the last checkpoint
    ckpt_dir = tempfile.mkdtemp(prefix="zmc_train_ckpt_")
    t0 = time.perf_counter()
    state_ref, losses_ref, _ = train.train_loop(cfg, hp, **kw)
    t_ref = time.perf_counter() - t0
    digest_ref = state_digest(state_ref)
    t0 = time.perf_counter()
    crashed = False
    try:
        train.train_loop(cfg, hp, ckpt_dir=ckpt_dir, ckpt_every=SSM_CKPT_EVERY,
                         fail_at_step=SSM_FAIL_AT, **kw)
    except RuntimeError as e:
        crashed = "injected failure" in str(e)
    t_crash = time.perf_counter() - t0
    latest = ckpt.latest_step(ckpt_dir)
    t0 = time.perf_counter()
    state_res, losses_res, _ = train.train_loop(cfg, hp, ckpt_dir=ckpt_dir, ckpt_every=100,
                                                **kw)
    t_res = time.perf_counter() - t0
    digest_res = state_digest(state_res)
    same_losses = losses_res == losses_ref[latest:] if latest is not None else False
    # the checkpoint's save and restore, timed alone on the uninterrupted state
    t0 = time.perf_counter()
    ckpt.save(ckpt_dir, 99, state_ref, extra={"data_step": SSM_TRAIN_STEPS})
    save_s = time.perf_counter() - t0
    step_dir = os.path.join(ckpt_dir, "step_99")
    n_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    t0 = time.perf_counter()
    restored, _ = ckpt.restore(ckpt_dir, 99, state_res, device="cpu")
    train.load_train_state(state_res, restored)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_after_restore = state_digest(state_res) == digest_ref
    del state_ref, state_res, restored
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"step 25 {SSM_TRAIN_ARCH} (b) {SSM_TRAIN_STEPS} uninterrupted steps {t_ref:.2f} s, "
          f"losses {[round(x, 6) for x in losses_ref]}; checkpoints every {SSM_CKPT_EVERY}, "
          f"failure injected at step {SSM_FAIL_AT}: {'raised' if crashed else 'NOT RAISED'} "
          f"after {t_crash:.2f} s, latest checkpoint step {latest}; resumed "
          f"{len(losses_res)} steps in {t_res:.2f} s: losses "
          f"{'equal' if same_losses else 'DIFFER'} to the uninterrupted run's steps "
          f"{latest}-{SSM_TRAIN_STEPS - 1}, final state sha256 {digest_ref[:16]} "
          f"{digest_res[:16]} {'equal' if digest_ref == digest_res else 'DIFFER'} "
          f"(parameters, AdamW moments, step); deterministic mode outside the step: "
          f"{torch.are_deterministic_algorithms_enabled()}")
    print(f"step 25 {SSM_TRAIN_ARCH}: checkpoint save {save_s:.3f} s, restore and load "
          f"{restore_s:.3f} s, {n_bytes / 1e9:.3f} GB on disk "
          f"({'equal' if same_after_restore else 'DIFFERENT'} state after the load)")
    if not crashed:
        failures.append("(b) the injected failure did not raise")
    if not (same_losses and digest_ref == digest_res and latest == SSM_CKPT_EVERY):
        failures.append("(b) the resumed run differs from the uninterrupted one")
    if not same_after_restore:
        failures.append("(b) a saved and restored state differs")
    # (c) memorisation of one fixed batch
    hp_c = dataclasses.replace(hp, lr=1e-3, warmup_steps=2)
    model = Model(cfg, device=dev, seed=0)
    state = train.make_train_state(model, hp_c)
    step = train.make_train_step(model, hp_c)
    batch = TokenStream(cfg, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, seed=1, device=dev).next_batch()
    fixed, gn = [], []
    for _ in range(SSM_TRAIN_STEPS):
        state, m = step(state, batch)
        fixed.append(float(m["loss"]))
        gn.append(float(m["grad_norm"]))
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    print(f"step 25 {SSM_TRAIN_ARCH} (c) {SSM_TRAIN_STEPS} steps on one fixed batch, lr "
          f"{hp_c.lr}, warmup {hp_c.warmup_steps}: losses {[round(x, 5) for x in fixed]} "
          f"(last {'below' if fixed[-1] < fixed[0] else 'NOT below'} the first); "
          f"{time.perf_counter() - t_arch:.1f} s")
    if not fixed[-1] < fixed[0]:
        failures.append("(c) the fixed-batch loss did not fall")
    if not finite(losses_ref + losses_res + fixed + gn):
        failures.append("(d) non-finite loss or grad_norm")
    check(not failures, f"{SSM_TRAIN_ARCH} training: {'; '.join(failures)}")


@contextlib.contextmanager
def host_heap_kept():
    """glibc's malloc told to serve every block from its heap and to keep
    what is freed (``mallopt``: no ``mmap``, no trim) while open, then
    trimmed back.  A CPU half's tensors of GBs each would otherwise be
    mapped fresh and page-faulted in at every allocation: on this repo's
    hosts that took two thirds of a CPU train step (a narrow deepseek-v3
    step, 3.83 s against 1.06 s kept, each the second of two).  The
    process's own allocator; nothing outside it changes."""
    import ctypes
    import ctypes.util
    name = ctypes.util.find_library("c")
    libc = ctypes.CDLL(name) if name else None
    if libc is None or not hasattr(libc, "mallopt"):
        yield
        return
    m_trim_threshold, m_mmap_max = -1, -4
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.malloc_trim.argtypes = [ctypes.c_size_t]
    libc.mallopt(m_mmap_max, 0)
    libc.mallopt(m_trim_threshold, -1)                  # glibc takes it as SIZE_MAX
    try:
        yield
    finally:
        libc.mallopt(m_mmap_max, 65536)                 # glibc's defaults
        libc.mallopt(m_trim_threshold, 128 * 1024)
        libc.malloc_trim(0)


def host_flush_denormals() -> None:
    """The host's f32 and f64 values below the smallest normal one read and
    written as zero (x86's FTZ and DAZ) by this thread and every thread it
    starts after the call, so by the intra-op pool when it is called before
    the process's first parallel CPU operation.  The CPU halves of the
    card-vs-CPU gates take softmaxes of near one-hot logits (this seeded
    model's), whose gradients are largely denormal, and a denormal costs
    the CPU ~100 times a normal operand: deepseek-v3's MTP block (its logits
    span ~10^2) at a quarter of its width took 40.5 s a 4-microbatch CPU
    step with them and 4.1 s without (8 x86 cores), the same metrics.  A
    flushed value is under 1.2e-38, far below every tolerance; the card
    keeps its denormals."""
    import torch
    torch.set_flush_denormal(True)


def host_memory() -> str:
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) for ln in f}
    return (f"the host's MemTotal {mem['MemTotal'] / 2**20:.1f} GiB, MemAvailable "
            f"{mem['MemAvailable'] / 2**20:.1f} GiB")


def lm_training_families(card: str) -> None:
    """Step 30: LM training of the moe (h), hybrid (i) and encoder (k)
    families and deepseek-v3-671b's own recipe (j) on one card, through
    ``train.make_train_state`` / ``make_train_step`` / ``train_loop``, at
    full width (``FAM_*``).  Every number of an architecture is printed
    before its gates are checked."""
    import dataclasses
    import gc
    import math
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import compression, fsdp
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import is_stacked, map_leaves

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    host_flush_denormals()
    dev = torch.device("cuda", 0)
    finite = lambda xs: all(math.isfinite(x) for x in xs)
    f32 = dict(compute_dtype="float32")
    # gate (i1) in f64 (every f32 upcast kept at f64): see FAM_HYBRID
    f64 = dict(param_dtype="float64", compute_dtype="float64", opt_dtype="float64")
    hp_adamw = train.TrainHParams(grad_accum=TRAIN_ACCUM, warmup_steps=1, total_steps=10)
    print(f"step 30: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before it; "
          f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}; on {card}")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def configs(fam):
        arch, over, over_1 = fam
        full = get_config(arch).with_overrides(param_dtype="float32")
        return arch, full, full.with_overrides(**over), over_1

    def gate(arch: str, tag: str, cfg_1, hp=None, batch=TRAIN_CHECK_BATCH,
             seq=TRAIN_CHECK_SEQ, gated: bool = True, **kw) -> dict:
        a = train_card_vs_cpu(cfg_1, dev, hp, batch, seq, **kw)
        accum = hp.grad_accum if hp is not None else TRAIN_ACCUM
        loss_tol, gnorm_tol, grad_tol, param_tol = (a["tol"] if gated
                                                    else ("not gated",) * 4)
        depth = (f"{cfg_1.n_layers} layer{'s' if cfg_1.n_layers != 1 else ''}"
                 + (" and the MTP block" if cfg_1.mtp_depth else ""))
        parts = ", ".join(f"{k} {a['card'][k]:.7f} vs {a['cpu'][k]:.7f} "
                          f"(rel {a['errs'][k]:.2e})" for k in a["cpu"] if k != "grad_norm")
        print(f"step 30 {arch} {tag} card vs CPU, {depth} at full width, "
              f"{cfg_1.param_dtype} parameters and compute (TF32 off), "
              f"{train_bounds(cfg_1, batch, seq)['params']:,} parameters, one step of {batch} "
              f"x {seq} in {accum} microbatch{'es' if accum > 1 else ''}: {parts}, gate "
              f"{loss_tol}; grad_norm "
              f"{a['card']['grad_norm']:.5f} vs {a['cpu']['grad_norm']:.5f} (rel "
              f"{a['gnorm_err']:.2e}, gate {gnorm_tol}); largest per-leaf gradient "
              f"relative RMS {a['grad_rms']:.3e} ({a['worst']}, gate {grad_tol}); "
              f"parameters {a['param_rms']:.3e} ({a['worst_param']}, gate "
              f"{param_tol}); the card half {a['card_s']:.1f} s, the CPU step "
              f"{a['cpu_s']:.1f} s, the comparison {a['compare_s']:.1f} s")
        a["failures"] = [f"{tag} {x[4:]}" for x in a["failures"]] if gated else []
        return a

    def timed(arch: str, full, cfg, hp, digest: bool = False) -> tuple[dict, list[str]]:
        label = (f"{arch} ({cfg.n_layers} of {full.n_layers} layers"
                 + (", MTP)" if cfg.mtp_depth else ")"))
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev, seed=0)
        run = train_timed(model, hp, TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                                 device=dev), FAM_TIMED, digest)
        bd = train_bounds(cfg, TRAIN_BATCH, TRAIN_SEQ, hp.optimizer)
        run["opt_bytes"] = fsdp.resident_bytes(run["state"]["opt"])
        run["bounds"] = bd
        tps = bd["tokens"] / (run["step_ms"] / 1e3)
        print(f"step 30 {label}: {bd['params']:,} parameters in {cfg.param_dtype}, compute "
              f"{cfg.compute_dtype}, remat {cfg.remat}, {hp.optimizer}; batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} in {hp.grad_accum} microbatches ({bd['tokens']} tokens a step)")
        print(f"step 30 {label}: forward+backward {run['fb_ms']:.3f} ms (bound "
              f"{bd['fb_ms']:.3f} ms by operations, 8 N T with N = {bd['matmul_params']:.4g} "
              f"and the attention rectangles, {bd['flops'] / 1e12:.2f} TFLOP; "
              f"{100 * bd['fb_ms'] / run['fb_ms']:.1f}% of it); clip {run['clip_ms']:.3f} ms "
              f"(bound {bd['clip_ms']:.3f} ms by bytes; "
              f"{100 * bd['clip_ms'] / run['clip_ms']:.1f}%); optimizer {run['opt_ms']:.3f} ms "
              f"(bound {bd['opt_ms']:.3f} ms by bytes; "
              f"{100 * bd['opt_ms'] / run['opt_ms']:.1f}%)")
        print(f"step 30 {label}: step {run['step_ms']:.3f} ms (runs "
              f"{[round(x, 3) for x in run['steps_ms']]}; bound {bd['step_ms']:.3f} ms; "
              f"{100 * bd['step_ms'] / run['step_ms']:.1f}% of it); {tps:.1f} tokens/s (bound "
              f"{bd['tokens_per_s']:.1f}); peak memory torch.cuda.max_memory_allocated "
              f"{run['peak'] / 1e9:.3f} GB (parameters, gradients and optimizer state "
              f"{bd['state_bytes'] / 1e9:.3f} GB, the optimizer's {run['opt_bytes'] / 1e9:.3f} "
              f"GB)")
        print(f"step 30 {label}: one step profiled: {run['profiled']}")
        print(f"step 30 {label}: losses {[round(x, 5) for x in run['losses']]}, grad_norm "
              f"{[round(x, 4) for x in run['gnorms']]}; the warm-up step's gradients before "
              f"the clip {'all finite' if run['grads_finite'] else 'NOT ALL FINITE'}, their "
              f"norm in f64 {run['gnorm64']:.6g}")
        failures = []
        if not finite(run["losses"]):
            failures.append("non-finite loss")
        if not finite(run["gnorms"]) and not (run["grads_finite"]
                                              and finite([run["gnorm64"]])
                                              and run["gnorm64"] > F32_NORM_MAX):
            # a grad_norm may be inf only where the f32 sum of squares overflows
            failures.append("non-finite grad_norm")
        del model
        run.pop("state")
        free()
        return run, failures

    # -- (h) deepseek-v2-lite-16b: MoE training ----------------------------------
    t_arch = time.perf_counter()
    arch, full, cfg, over_1 = configs(FAM_MOE)
    a = gate(arch, "(h1)", full.with_overrides(**over_1, **f32,
                                               capacity_factor=full.n_experts / full.top_k),
             routes=True)
    print(f"step 30 {arch} (h1) router, dropless (capacity factor "
          f"{full.n_experts / full.top_k:.4f}): {a['flips']} of {a['choices']} (token, expert) "
          f"choices differ over {a['calls']} calls, smallest k-th to (k+1)-th probability "
          f"margin {a['least']:.3e}, "
          + ("no token differs" if a["flips"] == 0 else f"at a differing token {a['at_flip']:.3e}"))
    failures = a["failures"]
    # (h2) at the configured capacity, from one seed: a plain run of the
    # timed run's 1 + FAM_TIMED steps, then the timed run, the same bits
    t0 = time.perf_counter()
    drops, losses = {}, []
    moe_blocks = [i for i in range(cfg.n_layers) if moe.is_moe_layer(cfg, i)]
    model = Model(cfg, device=dev, seed=0)
    state = train.make_train_state(model, hp_adamw)
    step = train.make_train_step(model, hp_adamw)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
    for i in range(1 + FAM_TIMED):
        tags, hooks = [], []
        if i == 0:                      # each MoE block's dispatches in step 1
            hooks = [model.blocks[j].register_forward_pre_hook(
                lambda m, args, j=j: tags.append(j)) for j in moe_blocks]
        with routes_logged() if hooks else contextlib.nullcontext([]) as log:
            state, m = step(state, stream.next_batch())
        for h in hooks:
            h.remove()
        for j, (idx, _) in zip(tags, log, strict=True):
            drops.setdefault(j, []).append(int((~moe.dispatch_plan(idx, cfg)[3]).sum()))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    plain = state_digest(state)
    del model, state, step, stream
    free()
    plain_s = time.perf_counter() - t0
    run, more = timed(arch, full, cfg, hp_adamw, digest=True)
    pairs = TRAIN_BATCH * TRAIN_SEQ * cfg.top_k // TRAIN_ACCUM
    print(f"step 30 {arch} (h2) a plain run of {1 + FAM_TIMED} steps from seed 0 at "
          f"{cfg.n_layers} layers ({plain_s:.1f} s) and the timed run's first "
          f"{1 + FAM_TIMED}, capacity factor {cfg.capacity_factor} "
          f"(capacity {moe.capacity(TRAIN_BATCH * TRAIN_SEQ // TRAIN_ACCUM, cfg)} rows an "
          f"expert a microbatch), deterministic mode: losses {losses} and "
          f"{run['losses']}; state sha256 {plain[:16]} {run['digest'][:16]} "
          f"{'equal' if plain == run['digest'] else 'DIFFER'} (parameters, AdamW moments, "
          f"step); dropped pairs of {pairs} a microbatch in step 1, per MoE layer, each "
          f"dispatch (microbatch by microbatch, the forward then backward's recompute): "
          f"{drops}")
    if plain != run["digest"] or losses != run["losses"]:
        failures.append("(h2) two runs from one seed differ")
    if sorted(drops) != moe_blocks or any(v[0::2] != v[1::2] for v in drops.values()):
        failures.append("(h2) a MoE layer's recompute dropped other pairs than its forward")
    print(f"step 30 {arch}: {time.perf_counter() - t_arch:.1f} s")
    check(not failures + more, f"step 30 {arch} training: {'; '.join(failures + more)}")

    # -- (i) zamba2-7b: hybrid training -----------------------------------------
    t_arch = time.perf_counter()
    arch, full, cfg, over_1 = configs(FAM_HYBRID)
    cfg_1 = full.with_overrides(**over_1, **f64)
    probe = Model(cfg_1, device="meta")
    invocations = sum(b is probe.shared_attn for b in probe.plan)
    del probe
    with f64_upcasts():
        a = gate(arch, "(i1)", cfg_1, keep=True, tol=FAM_I1_F64_TOL)
    shared = {n: v for n, v in a["leaf_rms"].items() if n.startswith("shared_attn.")}
    print(f"step 30 {arch} (i1) the shared block's {len(shared)} leaves, run {invocations} "
          f"times a forward, gradient (the sum over its invocations) relative RMS each: "
          + ", ".join(f"{n.removeprefix('shared_attn.')} {v:.2e}" for n, v in shared.items()))
    failures = a["failures"]
    # the witness: the same weights rounded to f32, one step on each side in
    # f32, each side's gradients held against the CPU's f64 ones
    w = gate(arch, "(i1) witness", full.with_overrides(**over_1, **f32), gated=False,
             weights=a.pop("weights"), against=a.pop("grads"))
    (card_vs, card_leaf), (cpu_vs, cpu_leaf) = w["vs"]["card"], w["vs"]["cpu"]
    print(f"step 30 {arch} (i1) witness, the f32 step's gradients from the CPU's f64 ones, "
          f"largest per-leaf relative RMS: the card {card_vs:.3e} ({card_leaf}), the CPU "
          f"{cpu_vs:.3e} ({cpu_leaf}) (gate {FAM_F32_SPREAD} x the CPU's)")
    if not card_vs <= FAM_F32_SPREAD * cpu_vs:
        failures.append(f"(i1) the card's f32 gradients {card_vs:.3e} from f64")
    del w
    free()
    bad = [n for n, v in shared.items() if not v <= FAM_I1_F64_TOL[2]]
    if bad or not shared or invocations != 2:
        failures.append(f"(i1) shared block run {invocations} times, gradients "
                        f"{bad or 'missing'}")
    _, more = timed(arch, full, cfg, hp_adamw)
    print(f"step 30 {arch}: {time.perf_counter() - t_arch:.1f} s")
    check(not failures + more, f"step 30 {arch} training: {'; '.join(failures + more)}")

    # -- (j) deepseek-v3-671b's own recipe: Adafactor, 4 microbatches, MTP ----------
    t_arch = time.perf_counter()
    arch, full, cfg, over_1 = configs(FAM_V3)
    recipe = train.default_hparams_for(full)
    print(f"step 30 {arch}: the recipe {recipe.optimizer}, grad_accum {recipe.grad_accum}, lr "
          f"{recipe.lr} (Adafactor takes weight decay 0), opt_dtype {cfg.opt_dtype}, MTP depth "
          f"{cfg.mtp_depth}; {host_memory()}")
    a = gate(arch, "(j1)", full.with_overrides(**over_1, **f32),
             dataclasses.replace(recipe, warmup_steps=0, total_steps=10,
                                 grad_accum=FAM_J1_ACCUM), FAM_J1_BATCH, FAM_J1_SEQ)
    failures = a["failures"]
    if set(a["cpu"]) != {"loss", "ce", "mtp", "grad_norm"}:
        failures.append(f"(j1) metrics {sorted(a['cpu'])}")
    hp = dataclasses.replace(recipe, warmup_steps=1, total_steps=10)
    probe = train.abstract_train_state(Model(cfg, device="meta"), hp)
    empty = {k: tuple(v.shape) for k, v in ckpt.leaf_paths(probe)
             if "/moe_layers/" in k and k.startswith(("params/", "opt/"))}
    del probe
    run, more = timed(arch, full, cfg, hp)
    failures += more
    bd = run["bounds"]
    print(f"step 30 {arch}: mtp {[round(m['mtp'], 5) for m in run['metrics']]}, ce "
          f"{[round(m['ce'], 5) for m in run['metrics']]}; Adafactor's state "
          f"{run['opt_bytes']:,} bytes ({run['opt_bytes'] / bd['params']:.4f} a parameter; "
          f"AdamW's f32 moments would take 8, {8 * bd['params'] / 1e9:.3f} GB); the empty "
          f"moe_layers stage's {len(empty)} parameter and state leaves, e.g. "
          f"{next(iter(empty.items()), None)}")
    if not finite([m["mtp"] for m in run["metrics"]]):
        failures.append("non-finite mtp")
    if not empty or any(v[0] != 0 for v in empty.values()):
        failures.append(f"the moe_layers stage's leaves {empty}")
    print(f"step 30 {arch}: {time.perf_counter() - t_arch:.1f} s")
    check(not failures, f"step 30 {arch} training: {'; '.join(failures)}")

    # -- (k) hubert-xlarge: the encoder family ---------------------------------------
    t_arch = time.perf_counter()
    arch, full, cfg, over_1 = configs(FAM_ENC)
    failures = gate(arch, "(k1)", full.with_overrides(**over_1, **f32))["failures"]
    # (k2) Adafactor with int8 error-feedback compression: crash and resume
    t0 = time.perf_counter()
    cfg_2 = full.with_overrides(n_layers=FAM_K2_LAYERS)
    hp_2 = train.TrainHParams(optimizer="adafactor", grad_compression=True,
                              grad_accum=TRAIN_ACCUM, warmup_steps=1, total_steps=FAM_K2_STEPS)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=FAM_K2_STEPS, log_every=100, device=dev)
    ckpt_dir = tempfile.mkdtemp(prefix="zmc_train_ckpt_")
    state_ref, losses_ref, _ = train.train_loop(cfg_2, hp_2, **kw)
    digest_ref = state_digest(state_ref)
    crashed = False
    try:
        train.train_loop(cfg_2, hp_2, ckpt_dir=ckpt_dir, ckpt_every=FAM_K2_CKPT_EVERY,
                         fail_at_step=FAM_K2_FAIL_AT, **kw)
    except RuntimeError as e:
        crashed = "injected failure" in str(e)
    latest = ckpt.latest_step(ckpt_dir)
    state_res, losses_res, _ = train.train_loop(cfg_2, hp_2, ckpt_dir=ckpt_dir,
                                                ckpt_every=100, **kw)
    digest_res = state_digest(state_res)
    same_losses = latest is not None and losses_res == losses_ref[latest:]
    ckpt.save(ckpt_dir, 99, state_ref, extra={"data_step": FAM_K2_STEPS})
    restored, _ = ckpt.restore(ckpt_dir, 99, state_res, device="cpu")
    train.load_train_state(state_res, restored)
    same_after_restore = state_digest(state_res) == digest_ref
    n_factored = sum(k.endswith("/vr") for k, _ in ckpt.leaf_paths(state_ref))
    del restored, state_ref
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"step 30 {arch} (k2) {FAM_K2_LAYERS} layers, Adafactor ({n_factored} factored "
          f"leaves) with int8 error feedback: {FAM_K2_STEPS} uninterrupted steps, losses "
          f"{[round(x, 6) for x in losses_ref]}; checkpoints every {FAM_K2_CKPT_EVERY}, "
          f"failure injected in step {FAM_K2_FAIL_AT}: {'raised' if crashed else 'NOT RAISED'}, "
          f"latest checkpoint step {latest}; resumed {len(losses_res)} steps: losses "
          f"{'equal' if same_losses else 'DIFFER'} to steps {latest}-{FAM_K2_STEPS - 1}; final "
          f"state sha256 {digest_ref[:16]} {digest_res[:16]} "
          f"{'equal' if digest_ref == digest_res else 'DIFFER'} (parameters, factored "
          f"statistics, ef_err, step); a saved and restored state "
          f"{'equal' if same_after_restore else 'DIFFERENT'}; {time.perf_counter() - t0:.1f} s")
    if not crashed:
        failures.append("(k2) the injected failure did not raise")
    if not (same_losses and digest_ref == digest_res and latest == FAM_K2_CKPT_EVERY):
        failures.append("(k2) the resumed run differs from the uninterrupted one")
    if not same_after_restore:
        failures.append("(k2) a saved and restored state differs")
    if not finite(losses_ref + losses_res):
        failures.append("(k2) non-finite loss")
    # (k3) one step's gradients and residuals through compress_tree, card and CPU
    model = Model(cfg_2, device=dev, seed=0)
    state = train.load_train_state(train.make_train_state(model, hp_2), state_res)
    del state_res
    step = train.make_train_step(model, hp_2)
    with train.deterministic(dev):
        step.grads(state, TokenStream(cfg_2, TRAIN_BATCH, TRAIN_SEQ, seed=1,
                                      device=dev).next_batch())
        step.clip(state)
        grads = map_leaves(lambda p: torch.stack([t.grad for t in p]) if is_stacked(p)
                           else p.grad, state["params"])
        on_card = compression.compress_tree(grads, state["ef_err"])
    on_cpu = compression.compress_tree(map_leaves(lambda t: t.cpu(), grads),
                                       map_leaves(lambda t: t.cpu(), state["ef_err"]))
    unequal = [n for part_c, part_h in zip(on_card, on_cpu)
               for (n, c), (_, h) in zip(ckpt.leaf_paths(part_c), ckpt.leaf_paths(part_h))
               if not torch.equal(c.cpu(), h)]
    n_el = sum(t.numel() for _, t in ckpt.leaf_paths(grads))
    err_max = max(float(t.abs().max()) for _, t in ckpt.leaf_paths(state["ef_err"]))
    print(f"step 30 {arch} (k3) compress_tree of one step's stacked gradients "
          f"({len(ckpt.leaf_paths(grads))} leaves, {n_el:,} elements) and the resumed run's "
          f"residuals (largest |ef_err| {err_max:.3e}) on the card and on the CPU: dequantised "
          f"gradients and new residuals "
          f"{'equal bit for bit' if not unequal else f'DIFFER in {unequal[:4]}'}")
    if unequal or not err_max > 0:
        failures.append(f"(k3) card and CPU compression differ in {unequal[:4]}")
    del model, state, step, grads, on_card, on_cpu
    free()
    _, more = timed(arch, full, cfg, hp_adamw)
    print(f"step 30 {arch}: {time.perf_counter() - t_arch:.1f} s")
    check(not failures + more, f"step 30 {arch} training: {'; '.join(failures + more)}")


def mesh_hp(accum: int = TRAIN_ACCUM):
    """Step 26's (a) hyperparameters: step 25's stablelm-3b run (``accum``
    microbatches)."""
    from repro_torch.launch import train
    return train.TrainHParams(grad_accum=accum, warmup_steps=1, total_steps=10)


def mesh_train_cfg():
    """Step 26's (a) configuration: stablelm-3b at full width, cut to
    MESH_TRAIN_LAYERS layers, in f32 compute."""
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).with_overrides(n_layers=MESH_TRAIN_LAYERS,
                                                 compute_dtype="float32")


def tree_sha(named) -> str:
    """sha256 over (name, bytes) pairs, bf16 as its bits."""
    import torch
    h = hashlib.sha256()
    for name, t in sorted(named, key=lambda nt: nt[0]):
        t = torch.stack(list(t)) if isinstance(t, (list, tuple)) else t
        t = t.detach().cpu().contiguous()
        h.update(name.encode())
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


def ckpt_sha(directory: str, step: int) -> str:
    """sha256 of a checkpoint's leaves as written (the files' arrays)."""
    import numpy as np
    h = hashlib.sha256()
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        man = json.load(f)
    for e in sorted(man["leaves"], key=lambda e: e["name"]):
        a = np.load(os.path.join(directory, f"step_{step}", e["file"]))
        h.update(e["name"].encode())
        h.update(np.ascontiguousarray(a).view(np.int16).tobytes() if a.dtype.kind == "V"
                 else np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def lm_mesh_rank(work: str, refs: str | None = None) -> dict:
    """One of step 26's four gloo ranks on the card of the parent: (a) the
    training phases, (b) the serving phases, (c) the pipeline; returns the
    numbers and digests, rank 0's comparisons against the parent's
    one-device references in ``work``; with ``refs`` (step 28 (f1)'s
    one-device references) also step 28's (f) (:func:`lm_sp_rank`) in
    these ranks, under ``sp``: the same mesh, so no spawn of its own."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import collectives, elastic, fsdp
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import blocks, moe
    from repro_torch.models.config import init_params
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import is_stacked, map_leaves

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dev = torch.device("cuda", 0)
    out: dict = {"rank": rank}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    m22 = make_mesh_for(model_parallel=2, device="cuda")
    full = mesh_train_cfg()
    hp = mesh_hp()
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=100, device=dev)

    # (a) f32 compute, TF32 off: MESH_RESUME_STEPS uninterrupted steps, the
    # first a warm-up and the rest timed; gate (a1) after step
    # MESH_TRAIN_STEPS against the parent's one-device steps, gate (a3) on
    # one step's collectives and the resident state
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = fsdp.shard_model(Model(full, device="meta"), m22, device=dev)
    state = train.make_mesh_train_state(model, hp, m22)
    step = train.make_train_step(model, hp, m22)
    stream = TokenStream(full, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
    out["resident"] = fsdp.resident_bytes(state)
    out["resident_derived"] = dryrun.cell_bytes(
        full, ShapeSpec("mesh", "train", TRAIN_SEQ, TRAIN_BATCH), m22, hp)["state_bytes"]
    crash = os.path.join(work, "crash")
    writer = ckpt.AsyncCheckpointer(crash)
    steps_ms, coll_ms, metrics = [], [], []
    for i in range(MESH_RESUME_STEPS):
        batch = stream.next_batch()
        sync()
        collectives.reset_counters()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        counted = collectives.counters()
        coll_ms.append(counted["seconds"] * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 1:
            out["counted"] = {k: counted[k] for k in dryrun._empty()}
        if i + 1 == MESH_CKPT_EVERY:
            writer.save(i + 1, state, extra={"data_step": stream.snapshot()["step"]},
                        shardings=step.shardings)
            writer.wait()       # written before the next step is timed
        if i == 0:
            # the witness: step 1's gradients against the parent's f64 ones
            grads = map_leaves(lambda p: [t.grad for t in p] if is_stacked(p) else p.grad,
                               state["params"])
            g_whole = ckpt.gather_tree(grads, step.shardings["params"])
            if rank == 0:
                ref = torch.load(os.path.join(work, "g1_f64.pt"))
                out["a1_g1_f64"] = worst_rms({n: t for n, t in ckpt.leaf_paths(g_whole)},
                                             ref, dev)
                del ref
            del grads, g_whole
        if i + 1 == MESH_TRAIN_STEPS:
            grads = map_leaves(lambda p: [t.grad for t in p] if is_stacked(p) else p.grad,
                               state["params"])
            g_whole = ckpt.gather_tree(grads, step.shardings["params"])
            p_whole = ckpt.gather_tree(state["params"], step.shardings["params"])
            if rank == 0:
                ref = torch.load(os.path.join(work, "a1_ref.pt"))
                g_rms = {n: rel_rms(t, ref["grads"][n]) for n, t in ckpt.leaf_paths(g_whole)}
                p_rms = {n: rel_rms(t, ref["params"][n]) for n, t in ckpt.leaf_paths(p_whole)}
                out["a1_grad_rms"] = max(g_rms.values())
                out["a1_grad_worst"] = max(g_rms, key=g_rms.get)
                out["a1_param_rms"] = max(p_rms.values())
                del ref
            del grads, g_whole, p_whole
    out["derived"] = {k: v for k, v in dryrun.train_collectives(
        full, hp, m22, TRAIN_BATCH, TRAIN_SEQ).items() if k != "total_bytes"}
    out["peak"] = torch.cuda.max_memory_allocated()
    out["steps_ms"], out["coll_ms"], out["metrics"] = steps_ms, coll_ms, metrics
    out["losses"] = [x["loss"] for x in metrics]
    writer.close()
    # each rank's blocks: equal on every rank is the whole state equal
    out["local_sha"] = tree_sha(ckpt.leaf_paths(state))
    del model, state, step
    free()
    out["a1_s"] = time.perf_counter() - t0

    # (a1) the mesh's first MESH_TRAIN_STEPS steps in f64 against the
    # parent's one device in f64 in the same rows
    t0 = time.perf_counter()
    full64 = full.with_overrides(param_dtype="float64", compute_dtype="float64")
    with f64_upcasts():
        model = fsdp.shard_model(Model(full64, device="meta"), m22, device=dev)
        state = train.make_mesh_train_state(model, hp, m22)
        step = train.make_train_step(model, hp, m22)
        stream = TokenStream(full, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
        metrics64 = []
        for _ in range(MESH_TRAIN_STEPS):
            state, m = step(state, stream.next_batch())
            metrics64.append({k: float(v) for k, v in m.items()})
    grads = map_leaves(lambda p: [t.grad for t in p] if is_stacked(p) else p.grad,
                       state["params"])
    g_whole = ckpt.gather_tree(grads, step.shardings["params"])
    p_whole = ckpt.gather_tree(state["params"], step.shardings["params"])
    if rank == 0:
        ref = torch.load(os.path.join(work, "a1_ref64.pt"))
        rel = lambda key: max(abs(x[key] - y[key]) / abs(y[key])
                              for x, y in zip(metrics64, ref["metrics"]))
        g_rms = {n: rel_rms(t, ref["grads"][n]) for n, t in ckpt.leaf_paths(g_whole)}
        p_rms = {n: rel_rms(t, ref["params"][n]) for n, t in ckpt.leaf_paths(p_whole)}
        out["a1_64"] = {"loss": rel("loss"), "grad_norm": rel("grad_norm"),
                        "grads": max(g_rms.values()), "grads_worst": max(g_rms, key=g_rms.get),
                        "params": max(p_rms.values()),
                        "losses": [x["loss"] for x in metrics64],
                        "ref_losses": [y["loss"] for y in ref["metrics"]]}
        del ref
    del model, state, step, grads, g_whole, p_whole
    free()
    out["a1_64_s"] = time.perf_counter() - t0

    # (a2) train_loop resumes (a)'s run from its checkpoint, fails in step
    # MESH_FAIL_AT + 1 and resumes again; the checkpoint restored on (4, 1)
    t0 = time.perf_counter()
    try:
        train.train_loop(full, hp, steps=MESH_RESUME_STEPS, mesh=m22, ckpt_dir=crash,
                         ckpt_every=MESH_CKPT_EVERY, fail_at_step=MESH_FAIL_AT, **kw)
    except RuntimeError as exc:
        out["crashed"] = str(exc)
    free()
    t1 = time.perf_counter()
    state, resumed, _ = train.train_loop(full, hp, steps=MESH_RESUME_STEPS, mesh=m22,
                                         ckpt_dir=crash, ckpt_every=100, **kw)
    out["resume_s"] = time.perf_counter() - t1
    out["resumed"] = resumed
    out["resumed_sha"] = tree_sha(ckpt.leaf_paths(state))
    model = Model(full, device="meta")
    del state
    free()
    m41 = make_mesh_for(model_parallel=1, device="cuda")
    t1 = time.perf_counter()
    tree, _ = elastic.elastic_restore(crash, MESH_CKPT_EVERY, train.abstract_train_state(model, hp),
                                      train.train_state_specs(model, hp), m41)
    out["restore41_s"] = time.perf_counter() - t1
    whole = ckpt.gather_tree(tree, train.train_shardings(model, hp, m41))
    if rank == 0:
        out["restored41_sha"] = tree_sha(ckpt.leaf_paths(whole))
        out["ckpt_sha"] = ckpt_sha(crash, MESH_CKPT_EVERY)
    del tree, whole
    free()
    out["a2_s"] = time.perf_counter() - t0

    # (b) deepseek-v2-lite-16b on (1, 4): 16 of 64 experts per rank
    t0 = time.perf_counter()
    m14 = make_mesh_for(model_parallel=4, device="cuda")
    ds = get_config(MESH_SERVE_ARCH).with_overrides(n_layers=MESH_B2_DEPTH)
    v = ds.vocab_size
    # (b1) dropless (E/k), f32 compute, depth 3: prefill and 8 decode steps
    # fed the one-device run's tokens
    cfg_b1 = ds.with_overrides(n_layers=MESH_B1_DEPTH, compute_dtype="float32",
                               capacity_factor=ds.n_experts / ds.top_k)
    srv = Server(cfg_b1, mesh=m14, device=dev)
    batch = concrete_batch(cfg_b1, LM_BATCH, LM_PROMPT, train=False, device=dev)
    ref = torch.load(os.path.join(work, "b1_ref.pt"))
    local, _ = srv.local(batch)
    with srv.context(local["tokens"].shape[0]):
        logits, _ = lm_run(srv.compute, local, LM_CHECK_STEPS, tokens=ref["fed"].to(dev))
    # each rank's vocab columns, gathered whole
    whole = lambda x: torch.cat(collectives.all_gather_axes(x, m14, ("model",)), dim=-1)
    scale = max(float(x.abs().max()) for x in ref["logits"])
    out["b1_err"] = max(float((whole(a)[:, :v].cpu() - b).abs().max())
                        for a, b in zip(logits, ref["logits"]))
    out["b1_scale"] = scale
    del srv, logits
    free()
    # (b2) the served capacity (1.25), bf16, MESH_B2_DEPTH layers: two generates,
    # the dropped pairs of the first per layer; prefill and decode timed
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    srv = Server(ds, mesh=m14, device=dev)
    out["b_build_s"] = time.perf_counter() - t1
    batch = concrete_batch(ds, LM_BATCH, LM_PROMPT, train=False, device=dev)
    moe.DROPS = []
    toks = [srv.generate(batch, MESH_B2_NEW, seq_cap=LM_CAP)]
    out["drops"], moe.DROPS = moe.DROPS, None
    toks.append(srv.generate(batch, MESH_B2_NEW, seq_cap=LM_CAP))
    out["tok_sha"] = [sha256_of(t) for t in toks]
    n_moe = ds.n_layers - ds.first_dense_layers
    local, _ = srv.local(batch)
    rows = local["tokens"].shape[0]
    with srv.context(rows):
        sync()
        t1 = time.perf_counter()
        logits, cache = srv.compute.prefill(local, LM_CAP)
        sync()
        out["prefill_ms"] = (time.perf_counter() - t1) * 1e3
        tok = srv.argmax_over_vocab(logits)
        dec, a2a = [], []
        for i in range(MESH_TIMED_DECODE):
            collectives.reset_counters()
            t1 = time.perf_counter()
            logits, cache = srv.compute.decode_step(cache, tok, LM_PROMPT + i, LM_CAP)
            tok = srv.argmax_over_vocab(logits)
            sync()
            dec.append((time.perf_counter() - t1) * 1e3)
            c = collectives.counters()
            a2a.append(c["seconds_by_kind"]["all-to-all"] * 1e3)
            if i == 0:
                out["b3_decode"] = c["all-to-all"]
        collectives.reset_counters()
        srv.compute.prefill(local, LM_CAP)
        out["b3_prefill"] = collectives.counters()["all-to-all"]
    out["b3_derived_decode"] = dryrun.moe_layer_collectives(ds, m14, rows)["all-to-all"]
    out["b3_derived_prefill"] = dryrun.moe_layer_collectives(
        ds, m14, rows * LM_PROMPT)["all-to-all"]
    out["n_moe"] = n_moe
    out["decode_ms"], out["a2a_ms"] = dec, a2a
    out["serve_peak"] = torch.cuda.max_memory_allocated()
    out["serve_resident"] = fsdp.resident_bytes(srv.model.param_tree())
    del srv, logits, cache
    free()
    out["b_s"] = time.perf_counter() - t0

    # (c) four stablelm-3b blocks, one a rank, along a pod axis
    t0 = time.perf_counter()
    mpod = make_mesh_for(model_parallel=1, pods=4, device="cuda")
    cfg_c = get_config(TRAIN_ARCH).with_overrides(compute_dtype="float32")

    def block(p):
        gen = torch.Generator(device=dev)
        gen.manual_seed(PIPE_SEED + p)
        tree = init_params(blocks.dense_block_defs(cfg_c), gen, torch.float32, dev)
        return blocks.DenseBlock(cfg_c, tree)

    gen = torch.Generator(device=dev)
    gen.manual_seed(PIPE_SEED)
    x = torch.randn((PIPE_M, 1, PIPE_SEQ, cfg_c.d_model), generator=gen, device=dev)
    positions = torch.arange(PIPE_SEQ, device=dev, dtype=torch.int32)[None]
    with torch.no_grad():
        mine = block(collectives.axis_index(mpod, ("pod",)))
        params = {n: t.detach()[None] for n, t in mine.named_parameters()}
        stage = lambda p, xb: torch.func.functional_call(mine, p, (xb, positions))
        pipeline_apply(stage, params, x, mpod, axis="pod")          # warm
        sync()
        timings: dict = {}
        y = pipeline_apply(stage, params, x, mpod, axis="pod", timings=timings)
        sync()
        out["pipe_timings"] = timings
        if rank == 0:
            seq = [block(p) for p in range(4)]
            ref = []
            for xb in x:
                for b in seq:
                    xb = b(xb, positions)
                ref.append(xb)
            ref = torch.stack(ref)
            out["pipe_err"] = float((y - ref).abs().max())
            out["pipe_bits_equal"] = bool(torch.equal(y, ref))
            out["pipe_scale"] = float(ref.abs().max())
    del mine, params, x, y
    free()
    out["c_s"] = time.perf_counter() - t0
    if refs is not None:
        out["sp"] = lm_sp_rank(refs)
    return out


def lm_mesh(card: str, refs: str | None = None) -> tuple[float, list | None]:
    """Step 26: the LM multi-device path on four gloo ranks sharing the card
    (one ``multihost.spawn``): (a) stablelm-3b training on (2, 2), (b)
    deepseek-v2-lite-16b serving on (1, 4) with expert parallelism, (c) a
    4-stage pipeline.  The one-device references are run here first (their
    memory freed before the ranks start); every number is printed before
    the gates are checked.  With ``refs`` (a directory), (a1)'s one-device
    runs in the mesh's rows are also written there as step 28 (f1) reads
    them (``f1_ref_<dtype>.pt``: the same runs), and the ranks run step
    28's (f) after (c).  Returns (a)'s median step ms and, with ``refs``,
    each rank's (f) results (else None)."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch import multihost, train
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import map_leaves

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    work = tempfile.mkdtemp(prefix="lm_mesh_")
    hp = mesh_hp()
    full = mesh_train_cfg()
    print(f"step 26: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before it; "
          f"on {card}")

    # one-device references: (a1) MESH_TRAIN_STEPS f32 steps, in the mesh's
    # microbatches of rows (gated) and in step 25's (printed); step 1's
    # gradients of both in f32 and in f64 (the witness); (b1) depth 3 in
    # f32, dropless; (b2) the served configuration's dropped pairs
    t0 = time.perf_counter()
    stacked = lambda leaf: (torch.stack(leaf) if isinstance(leaf, list) else leaf).detach().cpu()
    dev_grads = lambda state: {n: (torch.stack(t) if isinstance(t, list) else t).detach().clone()
                               for n, t in ckpt.leaf_paths(map_leaves(
        lambda p: [t.grad for t in p] if isinstance(p, list) else p.grad, state["params"]))}
    a1_ref, g1 = {}, {}
    full64 = full.with_overrides(param_dtype="float64", compute_dtype="float64")
    for accum in (MESH_ROW_ACCUM, TRAIN_ACCUM):
        for cfg_w in (full, full64):
            with f64_upcasts() if cfg_w is full64 else contextlib.nullcontext():
                model = Model(cfg_w, device=dev, seed=0)
                state = train.make_train_state(model, mesh_hp(accum))
                step = train.make_train_step(model, mesh_hp(accum))
                stream = TokenStream(full, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
                metrics = []
                for i in range(MESH_TRAIN_STEPS if cfg_w is full or accum == MESH_ROW_ACCUM
                               else 1):
                    state, m = step(state, stream.next_batch())
                    metrics.append({k: float(v) for k, v in m.items()})
                    if i == 0:
                        g1[cfg_w.compute_dtype, accum] = dev_grads(state)
                if cfg_w is full64 and accum == MESH_ROW_ACCUM:
                    # gate (a1): the last step in f64, kept in f32 (far finer than its
                    # tolerances)
                    torch.save({"metrics": metrics,
                                "grads": {n: t.float().cpu() for n, t in dev_grads(state).items()},
                                "params": {n: stacked(t).float() for n, t in
                                           ckpt.leaf_paths(state["params"])}},
                               os.path.join(work, "a1_ref64.pt"))
            if cfg_w is full:
                a1_ref[accum] = metrics
            if cfg_w is full and accum == MESH_ROW_ACCUM:
                torch.save({"grads": {n: t.cpu() for n, t in dev_grads(state).items()},
                            "params": {n: stacked(t) for n, t in ckpt.leaf_paths(state["params"])}},
                           os.path.join(work, "a1_ref.pt"))
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()
    if refs is not None:
        shutil.copy(os.path.join(work, "a1_ref64.pt"), os.path.join(refs, "f1_ref_float64.pt"))
        torch.save({"metrics": a1_ref[MESH_ROW_ACCUM],
                    **torch.load(os.path.join(work, "a1_ref.pt"))},
                   os.path.join(refs, "f1_ref_float32.pt"))
    f64_ref = g1["float64", TRAIN_ACCUM]
    witness = {"f64": worst_rms(g1["float64", MESH_ROW_ACCUM], f64_ref, dev),
               "f32": worst_rms(g1["float32", MESH_ROW_ACCUM], g1["float32", TRAIN_ACCUM], dev)}
    for accum in (MESH_ROW_ACCUM, TRAIN_ACCUM):
        witness[accum] = worst_rms(g1["float32", accum], f64_ref, dev)
    torch.save({n: t.float().cpu() for n, t in f64_ref.items()}, os.path.join(work, "g1_f64.pt"))
    del g1, f64_ref
    gc.collect()
    torch.cuda.empty_cache()
    ds = get_config(MESH_SERVE_ARCH).with_overrides(n_layers=MESH_B2_DEPTH)
    v = ds.vocab_size
    cfg_b1 = ds.with_overrides(n_layers=MESH_B1_DEPTH, compute_dtype="float32",
                               capacity_factor=ds.n_experts / ds.top_k)
    srv = Server(cfg_b1, device=dev, seed=0)
    batch = concrete_batch(cfg_b1, LM_BATCH, LM_PROMPT, train=False, device=dev)
    with torch.no_grad():
        logits, fed = lm_run(srv.compute, batch, LM_CHECK_STEPS)
    torch.save({"logits": [x[:, :v].cpu() for x in logits], "fed": fed.cpu()},
               os.path.join(work, "b1_ref.pt"))
    del srv, logits
    gc.collect()
    torch.cuda.empty_cache()
    srv = Server(ds, device=dev, seed=0)
    batch = concrete_batch(ds, LM_BATCH, LM_PROMPT, train=False, device=dev)
    moe.DROPS = []
    one_tokens = srv.generate(batch, MESH_B2_NEW, seq_cap=LM_CAP)
    one_drops, moe.DROPS = moe.DROPS, None
    del srv, batch
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    print(f"step 26 one-device references (a1, b1, b2) {ref_s:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB left allocated; on {card}")

    t0 = time.perf_counter()
    ranks = multihost.spawn(lm_mesh_rank, MESH_RANKS, work, refs, device="cuda",
                            backend="gloo", timeout=900)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    failures = []
    med = lambda xs: sorted(xs)[len(xs) // 2]

    # (a1)
    a1 = r0["metrics"][:MESH_TRAIN_STEPS]
    rel = lambda key, ref: max(abs(x[key] - y[key]) / abs(y[key]) for x, y in zip(a1, ref))
    loss_err, gnorm_err = rel("loss", a1_ref[MESH_ROW_ACCUM]), rel("grad_norm", a1_ref[MESH_ROW_ACCUM])
    print(f"step 26 (a1) not gated, {TRAIN_ARCH} at full width, {MESH_TRAIN_LAYERS} of 32 "
          f"layers, f32 (TF32 off), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {MESH_TRAIN_STEPS} steps on (data, "
          f"model) = (2, 2) ({TRAIN_ACCUM} microbatches, each rank 2 rows of each) vs one "
          f"device in the same {MESH_ROW_ACCUM} microbatches of 2 rows: losses "
          f"{[round(x['loss'], 7) for x in a1]} vs "
          f"{[round(y['loss'], 7) for y in a1_ref[MESH_ROW_ACCUM]]} (rel {loss_err:.2e}, gate "
          f"{TRAIN_LOSS_RTOL}); grad_norm rel {gnorm_err:.2e} (gate {TRAIN_GNORM_RTOL}); "
          f"step-{MESH_TRAIN_STEPS} gradients' largest per-leaf relative RMS "
          f"{r0['a1_grad_rms']:.3e} ({r0['a1_grad_worst']}, gate {TRAIN_GRAD_RMS}); parameters "
          f"{r0['a1_param_rms']:.3e} (gate {TRAIN_PARAM_RMS}); on {card}")
    print(f"step 26 (a1) not gated, one device in {TRAIN_ACCUM} microbatches of 4 rows (the "
          f"same function in another association order; the seeded model amplifies it): "
          f"loss rel {rel('loss', a1_ref[TRAIN_ACCUM]):.2e} from the mesh's, "
          f"{max(abs(x['loss'] - y['loss']) / abs(y['loss']) for x, y in zip(a1_ref[MESH_ROW_ACCUM], a1_ref[TRAIN_ACCUM])):.2e} "
          f"from one device's {MESH_ROW_ACCUM} microbatches; grad_norm rel "
          f"{rel('grad_norm', a1_ref[TRAIN_ACCUM]):.2e}; on {card}")
    spread = max(witness[MESH_ROW_ACCUM][0], witness[TRAIN_ACCUM][0])
    show = lambda w: f"{w[0]:.3e} ({w[1]})"
    print(f"step 26 (a1) witness, step 1's gradients, largest per-leaf relative RMS: one "
          f"device in f64 (f32 upcasts kept at f64), {MESH_ROW_ACCUM} vs {TRAIN_ACCUM} "
          f"microbatches {show(witness['f64'])} (gate {MESH_F64_RMS}); in f32 "
          f"{show(witness['f32'])}; from f64 in {TRAIN_ACCUM} microbatches: one device f32 "
          f"in {MESH_ROW_ACCUM} {show(witness[MESH_ROW_ACCUM])}, in {TRAIN_ACCUM} "
          f"{show(witness[TRAIN_ACCUM])}, the mesh {show(r0['a1_g1_f64'])} (gate "
          f"{MESH_F32_SPREAD} x {spread:.3e}); on {card}")
    a64 = r0["a1_64"]
    print(f"step 26 (a1) gated, in f64 (f32 upcasts kept at f64): {MESH_TRAIN_STEPS} steps on "
          f"(2, 2) vs one device in the same {MESH_ROW_ACCUM} microbatches of 2 rows: losses "
          f"{a64['losses']} vs {a64['ref_losses']} (rel {a64['loss']:.2e}, gate "
          f"{TRAIN_LOSS_RTOL}); grad_norm rel {a64['grad_norm']:.2e} (gate {TRAIN_GNORM_RTOL}); "
          f"step-{MESH_TRAIN_STEPS} gradients' largest per-leaf relative RMS "
          f"{a64['grads']:.3e} ({a64['grads_worst']}, gate {TRAIN_GRAD_RMS}); parameters "
          f"{a64['params']:.3e} (gate {TRAIN_PARAM_RMS}); {r0['a1_64_s']:.1f} s; on {card}")
    if witness["f64"][0] > MESH_F64_RMS:
        failures.append(f"(a1) f64 gradients differ across microbatchings {witness['f64']}")
    if r0["a1_g1_f64"][0] > MESH_F32_SPREAD * spread:
        failures.append(f"(a1) the mesh's step-1 gradients {r0['a1_g1_f64']} from f64")
    if a64["loss"] > TRAIN_LOSS_RTOL or a64["grad_norm"] > TRAIN_GNORM_RTOL:
        failures.append(f"(a1) f64 loss {a64['loss']:.2e} or grad_norm {a64['grad_norm']:.2e}")
    if a64["grads"] > TRAIN_GRAD_RMS or a64["params"] > TRAIN_PARAM_RMS:
        failures.append(f"(a1) f64 gradients {a64['grads']:.2e} or parameters "
                        f"{a64['params']:.2e}")
    # (a2), (a3) and the times
    tokens = TRAIN_BATCH * TRAIN_SEQ
    timed = r0["steps_ms"][1:]
    step_ms, coll_ms = med(timed), med(r0["coll_ms"][1:])
    print(f"step 26 (a) {TRAIN_ARCH} {MESH_TRAIN_LAYERS} layers, compute "
          f"{full.compute_dtype}, AdamW f32, remat {full.remat}, on (2, 2): step "
          f"{step_ms:.1f} ms (median of {len(timed)} after one warm-up; steps "
          f"{[round(x, 1) for x in r0['steps_ms']]}), collectives {coll_ms:.1f} ms inside it "
          f"(staged through host memory: gloo ranks sharing the card), {tokens / step_ms * 1e3:.0f} "
          f"tokens/s; peak per rank {[round(r['peak'] / 1e9, 3) for r in ranks]} GB; resident "
          f"state per rank {[r['resident'] for r in ranks]} bytes, derived "
          f"{r0['resident_derived']}; on {card}")
    print(f"step 26 (a3) one step's collectives per rank (count, bytes): counted "
          f"{ {k: (v['count'], v['bytes']) for k, v in r0['counted'].items()} }; derived "
          f"{ {k: (v['count'], v['bytes']) for k, v in r0['derived'].items()} }; on {card}")
    for r in ranks:
        if r["resident"] != r["resident_derived"]:
            failures.append(f"(a3) rank {r['rank']} resident {r['resident']} != "
                            f"{r['resident_derived']}")
        if r["counted"] != r["derived"]:
            failures.append(f"(a3) rank {r['rank']} collectives {r['counted']} != "
                            f"{r['derived']}")
    # one device restores the crashed run's checkpoint whole
    model = Model(full, device=dev, seed=1)
    state = train.make_train_state(model, hp)
    t1 = time.perf_counter()
    restored, _ = ckpt.restore(os.path.join(work, "crash"), MESH_CKPT_EVERY, state,
                               device="cpu")
    train.load_train_state(state, restored)
    one_restore_s = time.perf_counter() - t1
    from repro_torch.models.convert import stack_tree
    one_sha = tree_sha(ckpt.leaf_paths(stack_tree(state)))
    del model, state, restored
    gc.collect()
    torch.cuda.empty_cache()
    same = all(r["resumed_sha"] == r["local_sha"] for r in ranks)
    print(f"step 26 (a2) (a)'s checkpoint at step {MESH_CKPT_EVERY}, crash in step "
          f"{MESH_FAIL_AT + 1} ({r0.get('crashed')!r}), resume from step {MESH_CKPT_EVERY} on "
          f"(2, 2): losses {[round(x, 6) for x in r0['resumed']]} vs the uninterrupted "
          f"{[round(x, 6) for x in r0['losses'][MESH_CKPT_EVERY:]]}, final state sha256 per "
          f"rank {[r['resumed_sha'][:16] for r in ranks]} vs "
          f"{[r['local_sha'][:16] for r in ranks]} ({'equal' if same else 'DIFFERENT'}; "
          f"resume {r0['resume_s']:.1f} s); the "
          f"checkpoint {r0['ckpt_sha'][:16]}, restored on (4, 1) {r0['restored41_sha'][:16]} "
          f"({r0['restore41_s']:.1f} s), on one device {one_sha[:16]} ({one_restore_s:.1f} s); "
          f"on {card}")
    if not same or r0["resumed"] != r0["losses"][MESH_CKPT_EVERY:]:
        failures.append("(a2) the resumed run differs from the uninterrupted one")
    if not r0["ckpt_sha"] == r0["restored41_sha"] == one_sha:
        failures.append("(a2) a restored state differs from the checkpoint")

    # (b)
    n_moe = r0["n_moe"]
    print(f"step 26 (b1) {MESH_SERVE_ARCH} depth {MESH_B1_DEPTH}, dropless (capacity "
          f"{ds.n_experts / ds.top_k:.4g}), f32 compute, on (data, model) = (1, 4) with 16 of "
          f"64 experts a rank: prefill and {LM_CHECK_STEPS} decode steps' logits vs one "
          f"device's: max |diff| {r0['b1_err']:.3e} (gate {LM_F32_REL} x {r0['b1_scale']:.3f}); "
          f"on {card}")
    if not r0["b1_err"] <= LM_F32_REL * r0["b1_scale"]:
        failures.append(f"(b1) logits {r0['b1_err']:.3e}")
    per_layer = lambda drops, calls: [sum(drops[c * n_moe + j] for c in range(calls))
                                      for j in range(n_moe)]
    calls = 1 + MESH_B2_NEW
    mesh_drops = [sum(x) for x in zip(*(per_layer(r["drops"], calls) for r in ranks))]
    one_layer = per_layer(one_drops, calls)
    shas = {s for r in ranks for s in r["tok_sha"]}
    dec = med(r0["decode_ms"])
    gen_ms = r0["prefill_ms"] + MESH_B2_NEW * dec
    print(f"step 26 (b2) depth {ds.n_layers} of 27, capacity {ds.capacity_factor}, bf16: "
          f"generate sha256 "
          f"{sorted(shas)} over 2 repeats x {MESH_RANKS} ranks; dropped (token, expert) pairs "
          f"per MoE layer over the prefill and {MESH_B2_NEW} decode steps, the mesh (capacity per "
          f"EP token slice) {mesh_drops} vs one device {one_layer}; one device's tokens "
          f"sha256 {sha256_of(one_tokens)[:16]}; on {card}")
    print(f"step 26 (b) serving on (1, 4): server built in {r0['b_build_s']:.1f} s; prefill "
          f"{r0['prefill_ms']:.1f} ms, decode {dec:.1f} ms a step (median of {MESH_TIMED_DECODE}), "
          f"all-to-all {med(r0['a2a_ms']):.1f} ms a decode step, "
          f"{LM_BATCH * MESH_B2_NEW / gen_ms * 1e3:.1f} tokens/s; peak per rank "
          f"{[round(r['serve_peak'] / 1e9, 3) for r in ranks]} GB, resident parameters "
          f"{[round(r['serve_resident'] / 1e9, 3) for r in ranks]} GB; on {card}")
    print(f"step 26 (b3) all-to-all bytes per MoE layer: decode {r0['b3_decode']['bytes'] / n_moe:.0f} "
          f"(derived {r0['b3_derived_decode']['bytes']}), prefill "
          f"{r0['b3_prefill']['bytes'] / n_moe:.0f} (derived {r0['b3_derived_prefill']['bytes']}); "
          f"on {card}")
    if len(shas) != 1:
        failures.append(f"(b2) generate digests {shas}")
    for r in ranks:
        for k in ("decode", "prefill"):
            got, want = r[f"b3_{k}"], r[f"b3_derived_{k}"]
            if got["bytes"] != n_moe * want["bytes"] or got["count"] != n_moe * want["count"]:
                failures.append(f"(b3) rank {r['rank']} {k} all-to-all {got} vs {n_moe} x {want}")

    # (c)
    tm = [r["pipe_timings"] for r in ranks]
    idle = [1 - t["busy"] / t["wall"] for t in tm]
    bubble = (MESH_RANKS - 1) / (PIPE_M + MESH_RANKS - 1)
    print(f"step 26 (c) pipeline: 4 {TRAIN_ARCH} blocks at full width, one a rank along pod, "
          f"{PIPE_M} microbatches of 1 x {PIPE_SEQ}, f32: max |diff| vs the blocks in sequence "
          f"{r0['pipe_err']:.3e} (gate {PIPE_TOL} x {r0['pipe_scale']:.3f}), bits "
          f"{'equal' if r0['pipe_bits_equal'] else 'not equal'}; wall "
          f"{[round(t['wall'] * 1e3, 1) for t in tm]} ms per rank, idle share "
          f"{[round(x, 3) for x in idle]} against the schedule's bubble {bubble:.3f}; on {card}")
    if not r0["pipe_err"] <= PIPE_TOL * max(1.0, r0["pipe_scale"]):
        failures.append(f"(c) pipeline {r0['pipe_err']:.3e}")
    sp = [r["sp"] for r in ranks] if refs is not None else None
    print(f"step 26 phases (rank 0): a {r0['a1_s']:.1f} s, a1 in f64 {r0['a1_64_s']:.1f} s, "
          f"a2 {r0['a2_s']:.1f} s, "
          f"b {r0['b_s']:.1f} s, c {r0['c_s']:.1f} s"
          + (f", step 28's (f) {sp[0]['float32_s'] + sp[0]['float64_s']:.1f} s" if sp else "")
          + f"; spawn {spawn_s:.1f} s; on {card}")
    shutil.rmtree(work, ignore_errors=True)
    for f in failures:
        print(f"FAIL: step 26 {f}", file=sys.stderr, flush=True)
    check(not failures, "step 26")
    return step_ms, sp


def lm_tp_rank(work: str) -> dict:
    """One of step 27's four gloo ranks on the card of the parent: gate
    (d1) against the parent's one-device run, then the full model."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: dict = {"rank": dist.get_rank()}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    m14 = make_mesh_for(model_parallel=4, device="cuda")
    cfg = get_config(TP_ARCH)
    v = cfg.vocab_size
    whole = lambda x: torch.cat(collectives.all_gather_axes(x, m14, ("model",)), dim=-1)

    # (d1) depth TP_D1_DEPTH in f32 and in f64 (the bf16 weights computed
    # in f64, f32 upcasts kept at f64): prefill and decode steps fed the
    # one-device run's tokens
    t0 = time.perf_counter()
    ref = torch.load(os.path.join(work, "d1_ref.pt"))
    for dt in ("float32", "float64"):
        cfg_d1 = cfg.with_overrides(n_layers=TP_D1_DEPTH, compute_dtype=dt)
        with f64_upcasts() if dt == "float64" else contextlib.nullcontext():
            srv = Server(cfg_d1, mesh=m14, device=dev)
            batch = concrete_batch(cfg_d1, LM_BATCH, LM_PROMPT, train=False, device=dev)
            local, _ = srv.local(batch)
            with srv.context(local["tokens"].shape[0], LM_BATCH):
                logits, _ = lm_run(srv.compute, local, LM_CHECK_STEPS,
                                   tokens=ref["fed"].to(dev))
        mine = [whole(a)[:, :v].cpu().double() for a in logits]
        out[f"d1_{dt}"] = [float((a - b).abs().max()) for a, b in zip(mine, ref[dt])]
        out[f"d1_{dt}_vs64"] = [float((a - b).abs().max()) for a, b in zip(mine, ref["float64"])]
        del srv, logits, mine
        free()
    out["d1_scale"] = max(float(x.abs().max()) for x in ref["float64"])
    out["d1_one32_vs64"] = [float((a - b).abs().max())
                            for a, b in zip(ref["float32"], ref["float64"])]
    del ref
    out["d1_s"] = time.perf_counter() - t0

    # (d2) full depth in bf16: the server (each rank draws its blocks in
    # turn), one generate
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    srv = Server(cfg, mesh=m14, device=dev)
    sync()
    out["build_s"] = time.perf_counter() - t0
    out["init_peak"] = torch.cuda.max_memory_allocated()
    free_b, total_b = torch.cuda.mem_get_info()
    out["card_used_after_init"] = total_b - free_b
    batch = concrete_batch(cfg, LM_BATCH, LM_PROMPT, train=False, device=dev)
    t1 = time.perf_counter()
    toks = [srv.generate(batch, TP_NEW, seq_cap=LM_CAP)]
    out["generate_s"] = time.perf_counter() - t1

    # the second generate written out, each phase timed; (d3) its first
    # decode step's collectives, the resident bytes
    local, _ = srv.local(batch)
    rows = local["tokens"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    with srv.context(rows, LM_BATCH):
        sync()
        t1 = time.perf_counter()
        logits, cache = srv.compute.prefill(local, LM_CAP)
        tok = srv.argmax_over_vocab(logits)
        sync()
        out["prefill_ms"] = (time.perf_counter() - t1) * 1e3
        dec, coll, fed = [], [], []
        for i in range(TP_NEW):
            fed.append(tok)
            collectives.reset_counters()
            t1 = time.perf_counter()
            logits, cache = srv.compute.decode_step(cache, tok, LM_PROMPT + i, LM_CAP)
            tok = srv.argmax_over_vocab(logits)
            sync()
            dec.append((time.perf_counter() - t1) * 1e3)
            c = collectives.counters()
            coll.append(c["seconds"] * 1e3)
            if i == 0:
                out["d3_counted"] = {k: c[k] for k in dryrun._empty()}
    toks.append(torch.cat(fed, dim=1))
    out["tok_sha"] = [sha256_of(t) for t in toks]
    out["tokens"] = toks[0][:, :8].cpu().tolist()
    out["decode_ms"], out["coll_ms"] = dec, coll
    out["d3_derived"] = {k: v for k, v in dryrun.serve_collectives(
        cfg, m14, LM_BATCH, 1, LM_CAP).items() if k != "total_bytes"}
    out["resident"] = [fsdp.resident_bytes(srv.model.param_tree()), fsdp.resident_bytes(cache)]
    cell = dryrun.cell_bytes(cfg, ShapeSpec("tp", "decode", LM_CAP, LM_BATCH), m14)
    out["cell"] = [cell["params_bytes"], cell["cache_bytes"]]
    out["serve_peak"] = torch.cuda.max_memory_allocated()
    del srv, logits, cache
    free()
    out["d2_s"] = time.perf_counter() - t0
    return out


def lm_tp(card: str) -> None:
    """Step 27: qwen2.5-32b served tensor parallel on (1, 4), four gloo
    ranks sharing the card (one ``multihost.spawn``); gate (d1)'s one
    device runs here first, its memory freed before the ranks start."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.launch import multihost
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    work = tempfile.mkdtemp(prefix="lm_tp_")
    cfg = get_config(TP_ARCH)
    v = cfg.vocab_size
    print(f"step 27: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before it; "
          f"{TP_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads on "
          f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; the init's "
          f"largest f32 draw {fsdp.init_transient_bytes(cfg):,} bytes; on {card}")

    # (d1)'s one device, f32 first (its greedy tokens feed every other run)
    t0 = time.perf_counter()
    d1 = {}
    for dt in ("float32", "float64"):
        cfg_d1 = cfg.with_overrides(n_layers=TP_D1_DEPTH, compute_dtype=dt)
        with f64_upcasts() if dt == "float64" else contextlib.nullcontext():
            srv = Server(cfg_d1, device=dev, seed=0)
            batch = concrete_batch(cfg_d1, LM_BATCH, LM_PROMPT, train=False, device=dev)
            with torch.no_grad():
                logits, fed = lm_run(srv.compute, batch, LM_CHECK_STEPS,
                                     tokens=d1.get("fed"))
        d1[dt] = [x[:, :v].cpu().double() for x in logits]
        d1.setdefault("fed", fed)
        del srv, logits
        gc.collect()
        torch.cuda.empty_cache()
    d1["fed"] = d1["fed"].cpu()
    torch.save(d1, os.path.join(work, "d1_ref.pt"))
    del d1
    ref_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ranks = multihost.spawn(lm_tp_rank, MESH_RANKS, work, device="cuda", backend="gloo",
                            timeout=900)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    failures = []
    med = lambda xs: sorted(xs)[len(xs) // 2]
    show = lambda xs: [f"{x:.2e}" for x in xs]
    scale = r0["d1_scale"]
    print(f"step 27 (d1) {TP_ARCH} depth {TP_D1_DEPTH}, its bf16 weights, on (data, model) = "
          f"(1, 4), prefill and {LM_CHECK_STEPS} decode steps fed one device's tokens: max "
          f"|diff| per step from one device, in f64 (gated: {LM_F32_REL} x {scale:.3f}) "
          f"{show(r0['d1_float64'])}; in f32, TF32 off {show(r0['d1_float32'])}; the witness, "
          f"from one device's f64: one device in f32 {show(r0['d1_one32_vs64'])}, the mesh in "
          f"f32 {show(r0['d1_float32_vs64'])} (gate {MESH_F32_SPREAD} x the one device's); "
          f"one device {ref_s:.1f} s; on {card}")
    if not max(r0["d1_float64"]) <= LM_F32_REL * scale:
        failures.append(f"(d1) f64 logits {max(r0['d1_float64']):.3e}")
    if not max(r0["d1_float32_vs64"]) <= MESH_F32_SPREAD * max(r0["d1_one32_vs64"]):
        failures.append(f"(d1) f32 logits from f64 {max(r0['d1_float32_vs64']):.3e}")
    shas = {x for r in ranks for x in r["tok_sha"]}
    print(f"step 27 (d2) full depth, bf16: {TP_NEW} greedy tokens from Server.generate and "
          f"from its steps written out and timed, sha256 "
          f"{sorted(shas)} over 2 repeats x {MESH_RANKS} ranks; the first tokens "
          f"{r0['tokens'][0]}; on {card}")
    if len(shas) != 1:
        failures.append(f"(d2) generate digests {shas}")
    dec = med(r0["decode_ms"])
    gen_ms = r0["prefill_ms"] + TP_NEW * dec
    print(f"step 27 serving on (1, 4): server built in {r0['build_s']:.1f} s (each rank's "
          f"init peak {[round(r['init_peak'] / 1e9, 3) for r in ranks]} GB, the card "
          f"{r0['card_used_after_init'] / 1e9:.2f} GB used by all after it); prefill "
          f"{r0['prefill_ms']:.1f} ms, decode {dec:.1f} ms a step (median of {TP_NEW}; "
          f"collectives {med(r0['coll_ms']):.1f} ms of it), {LM_BATCH * TP_NEW / gen_ms * 1e3:.2f} "
          f"tokens/s, a generate {r0['generate_s']:.1f} s; peak per rank serving "
          f"{[round(r['serve_peak'] / 1e9, 3) for r in ranks]} GB; on {card}")
    print(f"step 27 (d3) resident (parameter, cache) bytes per rank "
          f"{[r['resident'] for r in ranks]}, derived {r0['cell']}; a decode step's "
          f"collectives (count, bytes): counted "
          f"{ {k: (x['count'], x['bytes']) for k, x in r0['d3_counted'].items()} }, derived "
          f"{ {k: (x['count'], x['bytes']) for k, x in r0['d3_derived'].items()} }; on {card}")
    for r in ranks:
        if r["resident"] != r["cell"]:
            failures.append(f"(d3) rank {r['rank']} resident {r['resident']} != {r['cell']}")
        if r["d3_counted"] != r["d3_derived"]:
            failures.append(f"(d3) rank {r['rank']} collectives {r['d3_counted']} != "
                            f"{r['d3_derived']}")
    print(f"step 27 phases (rank 0): d1 {r0['d1_s']:.1f} s, d2 {r0['d2_s']:.1f} s; spawn "
          f"{spawn_s:.1f} s; on {card}")
    shutil.rmtree(work, ignore_errors=True)
    for f in failures:
        print(f"FAIL: step 27 {f}", file=sys.stderr, flush=True)
    check(not failures, "step 27")


def lm_cp_rank(work: str) -> dict:
    """One of step 28 (e)'s eight gloo ranks on the card of the parent:
    gate (e1) against the parent's one-device run, then the full model."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: dict = {"rank": dist.get_rank()}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    m18 = make_mesh_for(model_parallel=CP_RANKS, device="cuda")
    cfg = get_config(CP_ARCH)
    v = cfg.vocab_size
    whole = lambda x: torch.cat(collectives.all_gather_axes(x, m18, ("model",)), dim=-1)

    # (e1) depth CP_E1_DEPTH in f32 and in f64 (the bf16 weights computed
    # in f64, f32 upcasts kept at f64): prefill and decode steps fed the
    # one-device run's tokens
    t0 = time.perf_counter()
    ref = torch.load(os.path.join(work, "e1_ref.pt"))
    for dt in ("float32", "float64"):
        cfg_e1 = cfg.with_overrides(n_layers=CP_E1_DEPTH, compute_dtype=dt)
        with f64_upcasts() if dt == "float64" else contextlib.nullcontext():
            srv = Server(cfg_e1, mesh=m18, device=dev)
            batch = concrete_batch(cfg_e1, LM_BATCH, LM_PROMPT, train=False, device=dev)
            local, _ = srv.local(batch)
            with srv.context(local["tokens"].shape[0], LM_BATCH):
                logits, _ = lm_run(srv.compute, local, LM_CHECK_STEPS,
                                   tokens=ref["fed"].to(dev))
        mine = [whole(a)[:, :v].cpu().double() for a in logits]
        out[f"e1_{dt}"] = [float((a - b).abs().max()) for a, b in zip(mine, ref[dt])]
        out[f"e1_{dt}_vs64"] = [float((a - b).abs().max()) for a, b in zip(mine, ref["float64"])]
        del srv, logits, mine
        free()
    out["e1_scale"] = max(float(x.abs().max()) for x in ref["float64"])
    out["e1_one32_vs64"] = [float((a - b).abs().max())
                            for a, b in zip(ref["float32"], ref["float64"])]
    del ref
    out["e1_s"] = time.perf_counter() - t0

    # (e2) CP_E_DEPTH layers in bf16: the server (each rank draws its blocks
    # in turn), two generates; the second's prefill and decode steps (each
    # with its greedy pick) timed, and (e3) their collectives and the
    # scores' checks counted
    t0 = time.perf_counter()
    cfg = cfg.with_overrides(n_layers=CP_E_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    srv = Server(cfg, mesh=m18, device=dev)
    sync()
    out["build_s"] = time.perf_counter() - t0
    out["init_peak"] = torch.cuda.max_memory_allocated()
    free_b, total_b = torch.cuda.mem_get_info()
    out["card_used_after_init"] = total_b - free_b
    batch = concrete_batch(cfg, LM_BATCH, LM_PROMPT, train=False, device=dev)
    toks = [srv.generate(batch, CP_NEW, seq_cap=LM_CAP)]
    steps, caches = [], []
    prefill, decode_step, sample = srv.compute.prefill, srv.compute.decode_step, srv._sample

    def start(fn):
        def run(*args):
            sync()
            collectives.reset_counters()
            sh.CHECKS.clear()
            steps.append(time.perf_counter())
            logits, cache = fn(*args)
            caches.append(cache)
            return logits, cache
        return run

    def finish(*args):
        tok = sample(*args)
        sync()
        c = collectives.counters()
        steps[-1] = ((time.perf_counter() - steps[-1]) * 1e3, c["seconds"] * 1e3,
                     {k: c[k] for k in dryrun._empty()}, dict(sh.CHECKS))
        return tok
    srv.compute.prefill, srv.compute.decode_step = start(prefill), start(decode_step)
    srv._sample = finish
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    toks.append(srv.generate(batch, CP_NEW, seq_cap=LM_CAP))
    out["generate_s"] = time.perf_counter() - t1
    out["tok_sha"] = [sha256_of(t) for t in toks]
    out["tokens"] = toks[0].cpu().tolist()
    (out["prefill_ms"], out["prefill_coll_ms"], out["e3_prefill"], checks), *decode = steps
    out["e3_checks"] = checks.get(tuple(None if a == "None" else a
                                        for a in CP_SCORES.split("|")), 0)
    out["decode_ms"], out["coll_ms"] = [d[0] for d in decode], [d[1] for d in decode]
    out["e3_decode"] = decode[0][2]
    cache = caches[0]
    out["e3_derived"] = {phase: {k: x for k, x in dryrun.serve_collectives(
        cfg, m18, LM_BATCH, seq, LM_CAP).items() if k != "total_bytes"}
        for phase, seq in (("prefill", LM_PROMPT), ("decode", 1))}
    out["resident"] = [fsdp.resident_bytes(srv.model.param_tree()), fsdp.resident_bytes(cache)]
    cell = dryrun.cell_bytes(cfg, ShapeSpec("cp", "decode", LM_CAP, LM_BATCH), m18)
    out["cell"] = [cell["params_bytes"], cell["cache_bytes"]]
    out["serve_peak"] = torch.cuda.max_memory_allocated()
    del srv, cache
    free()
    out["e2_s"] = time.perf_counter() - t0
    return out


def lm_sp_rank(work: str) -> dict:
    """One of step 28 (f)'s four gloo ranks on the card of the parent:
    MESH_TRAIN_STEPS steps with sp_activations in f32 (the first with its
    collectives and saved carries counted) and in f64, each held against
    the parent's one device in the mesh's rows."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.data import TokenStream
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model import Model, saved_carries
    from repro_torch.optim.optimizers import is_stacked, map_leaves

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dev = torch.device("cuda", 0)
    out: dict = {"rank": rank}
    m22 = make_mesh_for(model_parallel=2, device="cuda")
    hp = mesh_hp()
    for dt in ("float32", "float64"):
        t0 = time.perf_counter()
        full = mesh_train_cfg().with_overrides(sp_activations=True)
        if dt == "float64":
            full = full.with_overrides(param_dtype="float64", compute_dtype="float64")
        torch.cuda.reset_peak_memory_stats()
        with f64_upcasts() if dt == "float64" else contextlib.nullcontext():
            model = fsdp.shard_model(Model(full, device="meta"), m22, device=dev)
            state = train.make_mesh_train_state(model, hp, m22)
            step = train.make_train_step(model, hp, m22)
            stream = TokenStream(full, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
            metrics, steps_ms, coll_ms = [], [], []
            for i in range(MESH_TRAIN_STEPS):
                batch = stream.next_batch()
                torch.cuda.synchronize()
                dist.barrier()
                collectives.reset_counters()
                t1 = time.perf_counter()
                with saved_carries() if i == 0 else contextlib.nullcontext([]) as saved:
                    state, m = step(state, batch)
                torch.cuda.synchronize()
                dist.barrier()
                steps_ms.append((time.perf_counter() - t1) * 1e3)
                counted = collectives.counters()
                coll_ms.append(counted["seconds"] * 1e3)
                metrics.append({k: float(x) for k, x in m.items()})
                if i == 0 and dt == "float32":
                    out["f3_counted"] = {k: counted[k] for k in dryrun._empty()}
                    out["f2_saved"] = list(saved)
        grads = map_leaves(lambda p: [t.grad for t in p] if is_stacked(p) else p.grad,
                           state["params"])
        g_whole = ckpt.gather_tree(grads, step.shardings["params"])
        p_whole = ckpt.gather_tree(state["params"], step.shardings["params"])
        if rank == 0:
            ref = torch.load(os.path.join(work, f"f1_ref_{dt}.pt"))
            rel = lambda key: max(abs(x[key] - y[key]) / abs(y[key])
                                  for x, y in zip(metrics, ref["metrics"]))
            g_rms = {n: rel_rms(t, ref["grads"][n]) for n, t in ckpt.leaf_paths(g_whole)}
            p_rms = {n: rel_rms(t, ref["params"][n]) for n, t in ckpt.leaf_paths(p_whole)}
            out[f"f1_{dt}"] = {"loss": rel("loss"), "grad_norm": rel("grad_norm"),
                               "grads": max(g_rms.values()),
                               "grads_worst": max(g_rms, key=g_rms.get),
                               "params": max(p_rms.values()),
                               "losses": [x["loss"] for x in metrics],
                               "ref_losses": [y["loss"] for y in ref["metrics"]]}
            del ref
        out[f"{dt}_steps_ms"], out[f"{dt}_coll_ms"] = steps_ms, coll_ms
        out[f"{dt}_peak"] = torch.cuda.max_memory_allocated()
        out[f"{dt}_s"] = time.perf_counter() - t0
        if dt == "float32":
            out["f3_derived"] = {k: x for k, x in dryrun.train_collectives(
                full, hp, m22, TRAIN_BATCH, TRAIN_SEQ).items() if k != "total_bytes"}
            out["f2_entries"] = len(model.plan) * hp.grad_accum
        del model, state, step, grads, g_whole, p_whole
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_cp_sp(card: str, step26_ms: float, sp: list | None = None) -> None:
    """Step 28: (e) qwen2-vl-7b served with context parallelism on (1, 8),
    eight gloo ranks sharing the card; (f) step 26 (a)'s stablelm-3b run
    with sp_activations on (2, 2), four ranks: ``sp``, each rank's results
    where step 26's ranks ran it, else a spawn here.  The one-device
    references run here first, their memory freed before the ranks start;
    every number is printed before the gates are checked."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import fsdp
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import dryrun, multihost, train
    from repro_torch.launch.serve import Server
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import map_leaves

    torch.backends.cuda.matmul.allow_tf32 = False      # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    work = tempfile.mkdtemp(prefix="lm_cp_")
    cfg = get_config(CP_ARCH)
    v = cfg.vocab_size
    m18 = AbstractMesh(("data", "model"), (1, CP_RANKS))
    cell = dryrun.cell_bytes(cfg, ShapeSpec("cp", "decode", LM_CAP, LM_BATCH), m18)
    print(f"step 28: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before it; "
          f"(e) {CP_ARCH}: {cfg.n_layers} layers (served at {CP_E_DEPTH}), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV heads (the q-sequence "
          f"case on model = {CP_RANKS}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; at full "
          f"depth {cell['params_bytes']:,} parameter and {cell['cache_bytes']:,} cache bytes a "
          f"rank derived; the init's largest f32 draw {fsdp.init_transient_bytes(cfg):,} "
          f"bytes; on {card}")

    # (e1)'s one device, f32 first (its greedy tokens feed every other run)
    t0 = time.perf_counter()
    e1 = {}
    for dt in ("float32", "float64"):
        cfg_e1 = cfg.with_overrides(n_layers=CP_E1_DEPTH, compute_dtype=dt)
        with f64_upcasts() if dt == "float64" else contextlib.nullcontext():
            srv = Server(cfg_e1, device=dev, seed=0)
            batch = concrete_batch(cfg_e1, LM_BATCH, LM_PROMPT, train=False, device=dev)
            with torch.no_grad():
                logits, fed = lm_run(srv.compute, batch, LM_CHECK_STEPS,
                                     tokens=e1.get("fed"))
        e1[dt] = [x[:, :v].cpu().double() for x in logits]
        e1.setdefault("fed", fed)
        del srv, logits
        gc.collect()
        torch.cuda.empty_cache()
    e1["fed"] = e1["fed"].cpu()
    torch.save(e1, os.path.join(work, "e1_ref.pt"))
    del e1
    # (f1)'s one device in the mesh's rows, f32 and f64: step 26 (a1)'s
    hp = mesh_hp(MESH_ROW_ACCUM)
    stacked = lambda leaf: (torch.stack(leaf) if isinstance(leaf, list) else leaf).detach().cpu()
    for dt in ("float32", "float64") if sp is None else ():
        full = mesh_train_cfg()
        if dt == "float64":
            full = full.with_overrides(param_dtype="float64", compute_dtype="float64")
        with f64_upcasts() if dt == "float64" else contextlib.nullcontext():
            model = Model(full, device=dev, seed=0)
            state = train.make_train_state(model, hp)
            step = train.make_train_step(model, hp)
            stream = TokenStream(full, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
            metrics = []
            for _ in range(MESH_TRAIN_STEPS):
                state, m = step(state, stream.next_batch())
                metrics.append({k: float(x) for k, x in m.items()})
        grads = map_leaves(lambda p: [t.grad for t in p] if isinstance(p, list) else p.grad,
                           state["params"])
        torch.save({"metrics": metrics,
                    "grads": {n: stacked(t).float() for n, t in ckpt.leaf_paths(grads)},
                    "params": {n: stacked(t).float() for n, t in ckpt.leaf_paths(state["params"])}},
                   os.path.join(work, f"f1_ref_{dt}.pt"))
        del model, state, step, grads
        gc.collect()
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    print(f"step 28 one-device references (e1{', f1' if sp is None else ''}) {ref_s:.1f} s "
          f"((f) run in step 26's ranks: {sp is not None}); on {card}")

    t0 = time.perf_counter()
    ranks = multihost.spawn(lm_cp_rank, CP_RANKS, work, device="cuda", backend="gloo",
                            timeout=900)
    e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if sp is None:
        sp = multihost.spawn(lm_sp_rank, MESH_RANKS, work, device="cuda", backend="gloo",
                             timeout=900)
    f_s = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    r0, s0 = ranks[0], sp[0]
    failures = []
    med = lambda xs: sorted(xs)[len(xs) // 2]
    show = lambda xs: [f"{x:.2e}" for x in xs]

    # (e)
    scale = r0["e1_scale"]
    print(f"step 28 (e1) {CP_ARCH} depth {CP_E1_DEPTH}, its bf16 weights, on (data, model) = "
          f"(1, {CP_RANKS}), prefill and {LM_CHECK_STEPS} decode steps fed one device's "
          f"tokens: max |diff| per step from one device, in f64 (gated: {LM_F32_REL} x "
          f"{scale:.3f}) {show(r0['e1_float64'])}; in f32, TF32 off {show(r0['e1_float32'])}; "
          f"from one device's f64: one device in f32 {show(r0['e1_one32_vs64'])}, the mesh in "
          f"f32 {show(r0['e1_float32_vs64'])}; on {card}")
    if not max(r0["e1_float64"]) <= LM_F32_REL * scale:
        failures.append(f"(e1) f64 logits {max(r0['e1_float64']):.3e}")
    shas = {x for r in ranks for x in r["tok_sha"]}
    print(f"step 28 (e2) depth {CP_E_DEPTH}, bf16: two Server.generate runs of {CP_NEW} greedy tokens, "
          f"sha256 {sorted(shas)} over 2 x {CP_RANKS} ranks; the tokens {r0['tokens'][0]}; "
          f"on {card}")
    if len(shas) != 1:
        failures.append(f"(e2) generate digests {shas}")
    dec = med(r0["decode_ms"])
    print(f"step 28 (e) serving {CP_E_DEPTH} layers on (1, {CP_RANKS}): server built in {r0['build_s']:.1f} s "
          f"(each rank's init peak {[round(r['init_peak'] / 1e9, 3) for r in ranks]} GB, the "
          f"card {r0['card_used_after_init'] / 1e9:.2f} GB used by all after it); prefill "
          f"{r0['prefill_ms']:.1f} ms (collectives {r0['prefill_coll_ms']:.1f} ms of it), "
          f"decode {dec:.1f} ms a step (median of {len(r0['decode_ms'])}; collectives "
          f"{med(r0['coll_ms']):.1f} ms of it), each with its greedy pick; "
          f"{LM_BATCH * CP_NEW / r0['generate_s']:.2f} tokens/s over the timed generate "
          f"({r0['generate_s']:.1f} s); peak per rank serving "
          f"{[round(r['serve_peak'] / 1e9, 3) for r in ranks]} GB; on {card}")
    fmt = lambda d: {k: (x["count"], x["bytes"]) for k, x in d.items()}
    print(f"step 28 (e3) resident (parameter, cache) bytes per rank "
          f"{sorted({tuple(r['resident']) for r in ranks})}, derived {r0['cell']}; the "
          f"q-sequence scores checked {[r['e3_checks'] for r in ranks]} times in a prefill "
          f"({CP_E_DEPTH} layers); a prefill's collectives (count, bytes) counted "
          f"{fmt(r0['e3_prefill'])}, derived {fmt(r0['e3_derived']['prefill'])}; a decode "
          f"step's counted {fmt(r0['e3_decode'])}, derived {fmt(r0['e3_derived']['decode'])}; "
          f"on {card}")
    for r in ranks:
        if r["resident"] != r["cell"]:
            failures.append(f"(e3) rank {r['rank']} resident {r['resident']} != {r['cell']}")
        if r["e3_checks"] != CP_E_DEPTH:
            failures.append(f"(e3) rank {r['rank']} scores checked {r['e3_checks']} times")
        for phase in ("prefill", "decode"):
            if r[f"e3_{phase}"] != r["e3_derived"][phase]:
                failures.append(f"(e3) rank {r['rank']} {phase} collectives "
                                f"{r[f'e3_{phase}']} != {r['e3_derived'][phase]}")
    # (f)
    f64, f32 = s0["f1_float64"], s0["f1_float32"]
    print(f"step 28 (f1) {TRAIN_ARCH} {MESH_TRAIN_LAYERS} layers with sp_activations on "
          f"(2, 2), {MESH_TRAIN_STEPS} steps vs one device in the same {MESH_ROW_ACCUM} "
          f"microbatches of 2 rows, gated in f64 (f32 upcasts kept at f64): losses "
          f"{f64['losses']} vs {f64['ref_losses']} (rel {f64['loss']:.2e}, gate "
          f"{TRAIN_LOSS_RTOL}); grad_norm rel {f64['grad_norm']:.2e} (gate "
          f"{TRAIN_GNORM_RTOL}); step-{MESH_TRAIN_STEPS} gradients' largest per-leaf relative "
          f"RMS {f64['grads']:.3e} ({f64['grads_worst']}, gate {TRAIN_GRAD_RMS}); parameters "
          f"{f64['params']:.3e} (gate {TRAIN_PARAM_RMS}); in f32, not gated: loss rel "
          f"{f32['loss']:.2e}, grad_norm {f32['grad_norm']:.2e}, gradients {f32['grads']:.3e} "
          f"({f32['grads_worst']}), parameters {f32['params']:.3e}; on {card}")
    if f64["loss"] > TRAIN_LOSS_RTOL or f64["grad_norm"] > TRAIN_GNORM_RTOL:
        failures.append(f"(f1) f64 loss {f64['loss']:.2e} or grad_norm {f64['grad_norm']:.2e}")
    if f64["grads"] > TRAIN_GRAD_RMS or f64["params"] > TRAIN_PARAM_RMS:
        failures.append(f"(f1) f64 gradients {f64['grads']:.2e} or parameters "
                        f"{f64['params']:.2e}")
    saved = sorted({x for r in sp for x in r["f2_saved"]})
    print(f"step 28 (f2) the carry each entry's remat saved per microbatch, bytes a rank: "
          f"{saved} in {[len(r['f2_saved']) for r in sp]} entries (want {SP_CARRY_BYTES:,} in "
          f"{s0['f2_entries']}; {2 * SP_CARRY_BYTES:,} without sp_activations); on {card}")
    for r in sp:
        if r["f2_saved"] != [SP_CARRY_BYTES] * s0["f2_entries"]:
            failures.append(f"(f2) rank {r['rank']} saved {r['f2_saved']}")
    print(f"step 28 (f3) one step's collectives per rank (count, bytes): counted "
          f"{fmt(s0['f3_counted'])}; derived {fmt(s0['f3_derived'])}; on {card}")
    for r in sp:
        if r["f3_counted"] != r["f3_derived"]:
            failures.append(f"(f3) rank {r['rank']} collectives {r['f3_counted']} != "
                            f"{r['f3_derived']}")
    timed = s0["float32_steps_ms"][1:]
    print(f"step 28 (f) f32 step {med(timed):.1f} ms (median of {len(timed)} after one; steps "
          f"{[round(x, 1) for x in s0['float32_steps_ms']]}), collectives "
          f"{med(s0['float32_coll_ms'][1:]):.1f} ms of it, against step 26 (a)'s {step26_ms:.1f} "
          f"ms without sp_activations; peak per rank "
          f"{[round(r['float32_peak'] / 1e9, 3) for r in sp]} GB; f64 steps "
          f"{[round(x, 1) for x in s0['float64_steps_ms']]} ms; on {card}")
    print(f"step 28 phases: references {ref_s:.1f} s; (e) spawn {e_s:.1f} s (rank 0: e1 "
          f"{r0['e1_s']:.1f} s, e2 {r0['e2_s']:.1f} s); (f) spawn {f_s:.1f} s (rank 0: f32 "
          f"{s0['float32_s']:.1f} s, f64 {s0['float64_s']:.1f} s; in step 26's ranks when the "
          f"spawn took 0); on {card}")
    for f in failures:
        print(f"FAIL: step 28 {f}", file=sys.stderr, flush=True)
    check(not failures, "step 28")


def example_script(name: str):
    """The module of ``examples/<name>_torch.py`` (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", os.path.join(ROOT, "examples", f"{name}_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def raw_sums(zmc, trials: int):
    """(trials, n_fn, 2) raw (s1, s2) of a solver's trials, f64 on the CPU."""
    import torch
    out = []
    for t in range(trials):
        sums = zmc._trial_sums(t, zmc.n_samples, 0)
        out.append(torch.stack([torch.cat([x.s1 for x in sums]),
                                torch.cat([x.s2 for x in sums])], -1).double().cpu())
    return torch.stack(out)


def examples_on_card(card: str) -> None:
    """Step 29: the four example scripts of the integrator run as a user
    runs them, through their ``main`` on the card, with gates (g1)-(g5)."""
    import io

    import numpy as np
    import torch
    from repro_torch.kernels import template

    mods = {name: example_script(name) for name in
            ("quickstart", "harmonic_modes", "boltzmann_collision", "service_quickstart")}

    def run(label: str, fn, echo: bool = True):
        """``fn()`` with what it prints captured (echoed but the Fig.-1 band
        rows); (its result, wall seconds).  (g1): a script's own assert
        failing fails the step."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                result = fn()
        except AssertionError as e:
            fail(f"step 29 (g1) {label}: the script's assert failed: {e!r}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if echo:
            for line in buf.getvalue().splitlines():
                if line.strip() and not line.startswith("n="):
                    print(f"  {label} | {line}")
        print(f"step 29 {label}: {wall:.2f} s wall; on {card}")
        return result, wall

    # each script at its own defaults; no kernel on the users'-integrand path
    template.reset_kernel_launch_count()
    run("quickstart", lambda: mods["quickstart"].main("cuda"))
    run("harmonic_modes", lambda: mods["harmonic_modes"].main("cuda"))
    run("boltzmann_collision", lambda: mods["boltzmann_collision"].main("cuda"))
    chunked = template.kernel_launch_counts()
    check(not any(chunked.values()), f"step 29: the chunked scripts launched {chunked}")
    # (g3) the paper's Fig. 1 through the fused kernel
    template.reset_kernel_launch_count()
    (_, _, cover), wall = run("harmonic_modes --full --use-kernel",
                              lambda: mods["harmonic_modes"].main("cuda", full=True,
                                                                  use_kernel=True))
    counts = variant_counts({"fused_mc": True}, "step 29 harmonic_modes --full --use-kernel")
    print(f"step 29 (g3) harmonic_modes --full --use-kernel: 100 modes, 10^6 samples x 10 "
          f"trials, {wall / 10:.4f} s per trial, {counts['fused_mc']} launches, 2-sigma "
          f"coverage {cover:.2f} (gate {EX_COVERAGE}); on {card}")
    check(cover >= EX_COVERAGE, f"step 29 (g3) coverage {cover:.2f}")
    check(counts["fused_mc"] == 10, f"step 29 (g3) {counts['fused_mc']} launches, not 10")
    # (g4) the service tour: rounds, the compactified stage, the swept stage
    template.reset_kernel_launch_count()
    tour, _ = run("service_quickstart", lambda: mods["service_quickstart"].main("cuda"))
    variant_counts({"fused_mc_rounds": True, "fused_mc_compactified": True,
                    "fused_mc_swept": True}, "step 29 service_quickstart")
    print(f"step 29 (g4) service_quickstart launch counts {tour['launches']} (the reference "
          f"script's {EX_LAUNCHES}), fallback rounds {tour['fallback_rounds']}; on {card}")
    check(tour["launches"] == EX_LAUNCHES and tour["fallback_rounds"] == 0,
          "step 29 (g4) the service tour's launch counts")
    # (g2) the users' own integrands on the card against the CPU
    for name in ("quickstart", "boltzmann_collision"):
        (zg, rg), _ = run(f"{name} (g2) cuda", lambda: mods[name].main(
            "cuda", n_samples=EX_N, num_trials=EX_TRIALS), echo=False)
        (zc, rc), _ = run(f"{name} (g2) cpu", lambda: mods[name].main(
            "cpu", n_samples=EX_N, num_trials=EX_TRIALS), echo=False)
        sg, sc = raw_sums(zg, EX_TRIALS), raw_sums(zc, EX_TRIALS)
        ratio = float(((sg - sc).abs() / (EX_ATOL + EX_RTOL * sc.abs())).max())
        d_mean = float(np.max(np.abs(rg.means - rc.means) / rc.stderrs))
        d_se = float(np.max(np.abs(rg.stderrs - rc.stderrs) / rc.stderrs))
        print(f"step 29 (g2) {name} at {EX_N} samples x {EX_TRIALS} trials, {zg.spec.n_fn_total} "
              f"integrands, card vs CPU: raw sums worst |diff| / (atol + rtol |cpu|) "
              f"{ratio:.4f} (rtol={EX_RTOL}, atol={EX_ATOL}); max |d mean| {d_mean:.3g} and "
              f"|d stderr| {d_se:.3g} standard errors (limit {EST_TOL}); on {card}")
        check(ratio <= 1.0 and d_mean <= EST_TOL and d_se <= EST_TOL,
              f"step 29 (g2) {name}: the card disagrees with the CPU")
    # (g5) the paper's 10^3 integrations on the path its users write
    (zb, rb), wall = run(f"boltzmann_collision (g5) {EX_BEAMS} beams", lambda: mods[
        "boltzmann_collision"].main("cuda", n_samples=EX_BIG_N, num_trials=1,
                                    n_beams=EX_BEAMS))
    chunks = 2
    profiled = profile_steps(lambda i: zb._trial_sums(0, chunks * zb.chunk, 0), 1)
    print(f"step 29 (g5) the Boltzmann graphs over {EX_BEAMS} beams: {zb.spec.n_fn_total} "
          f"user-written integrands of dim 3, {EX_BIG_N} samples, use_kernel=False: "
          f"{wall:.3f} s per trial ({-(-EX_BIG_N // zb.chunk)} chunks of {zb.chunk} samples "
          f"a graph); the first {chunks} chunks of each graph profiled: {profiled}; "
          f"finite {bool(np.isfinite(rb.means).all())}; on {card}")
    check(bool(np.isfinite(rb.means).all() and np.isfinite(rb.stderrs).all()),
          "step 29 (g5) non-finite estimates")


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    host_flush_denormals()
    import concurrent.futures

    from repro_torch.kernels import build
    # step 2's nvcc processes start here, beside step 1's imports and the
    # card's start
    nvcc_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    building = nvcc_pool.submit(build.build, verbose=True)
    t_build = time.perf_counter()
    import numpy as np

    from repro_torch.core import rng
    from repro_torch.core.integrand import harmonic_analytic
    from repro_torch.core.multifunctions import ZMCMultiFunctions
    from repro_torch.kernels import template
    from repro_torch.kernels.mc_eval import multi

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = nvidia_smi("name,power.limit")
    print(f"card: {card}", flush=True)
    laps = Laps(card, t_start)
    laps.end(1)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = building.result()
    nvcc_pool.shutdown()
    print(f"build: {len(built)} libraries in {time.perf_counter() - t_build:.2f} s, "
          f"{time.perf_counter() - t0:.2f} s of it after step 1", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    pass1 = {r["name"]: r for r in build.pass1_resources(built["zmc_fused_mc"]["log"])}
    for r in pass1.values():
        print(f"  fused_mc_pass1{r['name']}: {r['registers']} registers, "
              f"{r['spill_stores']} bytes of spill stores, {r['blocks_per_sm']} resident "
              f"blocks per SM")
    laps.end(2)

    # -- 3. device Threefry, bit for bit ------------------------------------
    n = 1 << 20
    i = torch.arange(n, dtype=torch.int64, device=device)
    c0 = (2**32 - n // 2 + i) & rng.MASK32                  # wraps halfway
    fn_ids = (i * 2654435761) % (1 << 24)
    fn_ids[:1024] = (1 << 24) - 1                           # largest fn id
    c1 = (fn_ids * rng.DIM_STRIDE + i % rng.DIM_STRIDE) & rng.MASK32
    k0, k1 = rng.fold_key(2024, 7)
    got = template.random_bits_cuda(k0, k1, c0, c1)
    want = rng.random_bits(k0, k1, c0, c1)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    print(f"zmc_random_bits vs rng.random_bits: {n - bad}/{n} equal "
          f"(c0 from {2**32 - n // 2} with wrap, fn ids up to 2^24-1)")
    check(bad == 0, f"device Threefry differs on {bad} counters")
    laps.end(3)

    # -- 4. the Fig.-1 spec and its plan ------------------------------------
    spec, genz_exact = fig1_spec(device)
    plan = multi.plan_spec(spec)
    print(f"spec: {spec.n_fn_total} integrands in {len(spec.families)} families; "
          f"plan: {plan.n_launches} buckets "
          + ", ".join(f"d{b.dim}:{b.fn_ids.shape[0]} rows/"
                      f"{len(set(b.block_forms.tolist()))} forms"
                      for b in plan.buckets))
    check(plan.unfused == (), f"families left unfused: {plan.unfused}")
    check(plan.n_launches == 3, f"expected 3 buckets, got {plan.n_launches}")
    laps.end(4)

    # -- 5. kernel vs plain at N_CHECK, and repeat digests -----------------
    key = rng.fold_key(0, 0)
    max_err = 0.0
    for b in plan.buckets:
        k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key)
        k_again = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key)
        p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_sums(b, k_out, p_out, N_CHECK))
        d1 = hashlib.sha256(k_out.cpu().numpy().tobytes()).hexdigest()
        d2 = hashlib.sha256(k_again.cpu().numpy().tobytes()).hexdigest()
        print(f"bucket d{b.dim} at N={N_CHECK}: repeat sha256 {d1[:16]} {d2[:16]} "
              f"{'equal' if d1 == d2 else 'DIFFER'}")
        check(d1 == d2, f"d{b.dim}: repeated launches differ")
    laps.end(5)

    # -- 6. the main path ---------------------------------------------------
    zmc = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                            device="cuda")
    template.reset_launch_count()
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    res = zmc.evaluate(num_trials=TRIALS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = template.kernel_launch_count()
    dispatches = template.launch_count()
    print(f"evaluate(num_trials={TRIALS}) at N={N_MAIN}: {wall / TRIALS:.4f} s "
          f"per trial (wall); kernel_launch_count() = {launches}, "
          f"launch_count() = {dispatches}")
    check(launches == plan.n_launches * TRIALS,
          f"expected {plan.n_launches * TRIALS} kernel launches, got {launches}")
    main_counts = variant_counts({"fused_mc": True}, "evaluate path")
    main_est = (res.means.copy(), res.stderrs.copy())    # held again in step 20
    check(res.means.shape == (TRIALS, spec.n_fn_total), "bad result shape")
    check(bool(np.isfinite(res.means).all() and np.isfinite(res.stderrs).all()),
          "non-finite estimates")

    fbar, dfn = res.trial_mean, res.trial_std
    exact_h = np.concatenate([harmonic_analytic(500, 4), harmonic_analytic(200, 2)])
    cover_h = float(np.mean(np.abs(fbar[:700] - exact_h) <= 2 * dfn[:700]))
    offs = spec.offsets()
    cover_g = {}
    for idx, exact in genz_exact.items():
        sl = slice(offs[idx], offs[idx] + spec.families[idx].n_fn)
        cover_g[spec.families[idx].name] = float(
            np.mean(np.abs(fbar[sl] - exact) <= 2 * dfn[sl]))
    print(f"harmonic 2-sigma coverage vs harmonic_analytic: {cover_h:.4f} "
          f"(700 integrands); Genz coverage vs exact: "
          + ", ".join(f"{k} {v:.4f}" for k, v in cover_g.items()))
    check(cover_h >= 0.85, f"harmonic coverage {cover_h} < 0.85")
    laps.end(6)

    # -- 7. kernel vs plain at the main path's shapes, timing and bound -----
    # One trial's launches as evaluate makes them: N_MAIN samples, so 62
    # chunks per function, a cut last chunk and a 62-partial fold in pass 2.
    key = rng.fold_key(0, 0)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(TIMING_REPS):
        k_outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key)
                  for b in plan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    kernel_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    p_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key)
              for b in plan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(plan.buckets, k_outs, p_outs):
        max_err = max(max_err, compare_estimates(b, k_out, p_out, N_MAIN))

    props = torch.cuda.get_device_properties(device)
    try:
        clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    except ValueError:
        clock_hz = 1.98e9                    # H100 SXM boost clock, data sheet
    n_sm = props.multi_processor_count
    draws = sum(f.n_fn * f.dim for f in spec.families) * N_MAIN
    values = spec.n_fn_total * N_MAIN
    op_ms = op_bound_ms(draws, values, n_sm, clock_hz)
    n_bytes = sum(4 * (b.packed.numel() + b.lo.numel() + b.hi.numel()
                       + b.fn_ids.numel() + 2 * b.fn_ids.numel())
                  for b in plan.buckets)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(*op_ms.values(), byte_ms)
    print(f"one trial (3 launches, {draws:.4g} draws, {values:.4g} values): kernel "
          f"{kernel_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms "
          f"(kernel at {100 * bound_ms / kernel_ms:.1f}% of it) at {n_sm} SMs x "
          f"{clock_hz / 1e9:.3f} GHz: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in op_ms.items())
          + f", bytes {byte_ms:.6f} ms; on {card}")

    loops = sass_loops(built["zmc_fused_mc"]["path"])
    loops = loops and [lp for lp in loops if lp["rotates"] >= 10 and lp["draws"]]
    if not loops:
        print("pass-1 SASS: not measured (cuobjdump missing or unreadable)")
    else:
        n_draws = sum(lp["draws"] for lp in loops)
        per_draw = {k: sum(lp[k] for lp in loops) / n_draws
                    for k in ("instr", "alu", "fma")}
        spread = [lp["instr"] / lp["draws"] for lp in loops]
        print(f"pass-1 SASS: {len(loops)} inner Threefry loops, "
              f"{sorted({lp['draws'] for lp in loops})} draws per iteration; per "
              f"draw {per_draw['instr']:.2f} instructions ({min(spread):.2f} to "
              f"{max(spread):.2f}): ALU {per_draw['alu']:.2f}, FMA pipes "
              f"{per_draw['fma']:.2f}, other "
              f"{per_draw['instr'] - per_draw['alu'] - per_draw['fma']:.2f}")
        top = max(loops, key=lambda lp: lp["instr"] / lp["draws"])
        print(f"  opcodes per draw in loop {top['range']}: " + ", ".join(
            f"{op} {n / top['draws']:g}" for op, n in top["ops"].most_common()))
        sass_clk = max(per_draw["alu"] / ALU_PER_CLK, per_draw["instr"] / ISSUE_PER_CLK)
        print(f"compiled-code bound (these loops' mix, every draw): "
              f"{draws * sass_clk / (n_sm * clock_hz) * 1e3:.3f} ms per trial "
              f"(ALU {per_draw['alu']:.2f} / {ALU_PER_CLK}, all "
              f"{per_draw['instr']:.2f} / {ISSUE_PER_CLK} per draw per clock per SM)")
    print(f"main path fused_mc_pass1<0,false,false>: "
          f"{pass1['<0,false,false>']['registers']} registers (its reference allocation: 96), "
          + (f"{per_draw['instr']:.2f}" if loops else "not measured")
          + " SASS instructions per draw (reference: 72.01)")
    laps.end(7)

    # -- 8. where a steady-state trial's time goes ---------------------------
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    zmc.evaluate(num_trials=3)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        zmc.evaluate(num_trials=1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
                  for e in events) / 1e3
    print(f"steady state: {steady:.4f} s per trial (evaluate(3), wall); one "
          f"profiled trial {prof_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / prof_ms:.1f}%, idle {100 - 100 * busy_ms / prof_ms:.1f}%)")
    print(events.table(sort_by="self_cpu_time_total", row_limit=10))
    laps.end(8)

    # -- 9. rounds: R-round launches against single rounds and plain ------
    key = rng.fold_key(4, 9)
    rounds_err = 0.0
    for b in plan.buckets:
        n_blocks = b.fn_ids.shape[0] // template.F_BLK
        base = torch.tensor([(i * 37 * N_ROUND) & rng.MASK32
                             for i in range(n_blocks)], dtype=torch.int64)
        base[n_blocks // 2] = 2**32 - 3 * N_ROUND // 2   # crosses the wrap
        kw = dict(dim=b.dim, n_sample_blocks=N_ROUND // template.S_BLK,
                  block_tcols=b.block_tcols, round_base=base)
        ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
        scal = template.pack_scalars(key, 0, N_ROUND, round_stride=N_ROUND)
        k_out = template.fused_mc_cuda(scal, *ops, n_rounds=ROUNDS, **kw)
        p_out = template.fused_mc_plain(scal, *ops, n_rounds=ROUNDS, **kw)
        torch.cuda.synchronize()
        same = 0
        for r in range(ROUNDS):
            one = template.fused_mc_cuda(
                template.pack_scalars(key, r * N_ROUND, N_ROUND), *ops, **kw)
            d_r = hashlib.sha256(k_out[r].cpu().numpy().tobytes()).hexdigest()
            d_1 = hashlib.sha256(one[0].cpu().numpy().tobytes()).hexdigest()
            same += d_r == d_1
        print(f"bucket d{b.dim}: R={ROUNDS} launch at N={N_ROUND} per round: "
              f"{same}/{ROUNDS} rounds sha256-equal to single-round launches "
              f"(window starts up to {int(base.max())}, one crossing 2^32)")
        check(same == ROUNDS, f"d{b.dim}: a round differs from its single-round launch")
        for r in range(ROUNDS):
            rounds_err = max(rounds_err, compare_sums(
                b, k_out[r:r + 1], p_out[r:r + 1], N_ROUND))
    laps.end(9)

    # -- 10. compactified families -------------------------------------------
    cspec, c_exact = compact_spec(device)
    czmc = ZMCMultiFunctions(cspec, n_samples=N_MAIN, seed=3, use_kernel=True,
                             device="cuda")
    cplan = czmc._get_fusion_plan()
    check(cplan.unfused == () and cplan.n_launches == 3,
          f"compactified spec: {cplan.n_launches} buckets, unfused {cplan.unfused}")
    key = rng.fold_key(3, 0)

    def compact_launches():
        return [template.fused_mc_cuda(
            template.pack_scalars(key, 0, N_MAIN), b.fn_ids, b.packed, b.lo,
            b.hi, b.block_forms, dim=b.dim,
            n_sample_blocks=-(-N_MAIN // template.S_BLK),
            block_tcols=b.block_tcols) for b in cplan.buckets]

    compact_launches()                      # warm: first compactified launches
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(TIMING_REPS):
        ck_outs = compact_launches()
    ev1.record()
    torch.cuda.synchronize()
    compact_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    cp_outs = [template.fused_mc_plain(
        template.pack_scalars(key, 0, N_MAIN), b.fn_ids, b.packed, b.lo, b.hi,
        b.block_forms, dim=b.dim, n_sample_blocks=-(-N_MAIN // template.S_BLK),
        block_tcols=b.block_tcols) for b in cplan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    compact_plain_ms = ev0.elapsed_time(ev1)
    compact_err = 0.0
    for b, k_out, p_out in zip(cplan.buckets, ck_outs, cp_outs):
        compact_err = max(compact_err, compare_estimates(b, k_out, p_out, N_MAIN))
    template.reset_kernel_launch_count()
    cres = czmc.evaluate(num_trials=1)
    variant_counts({"fused_mc": True, "fused_mc_compactified": True},
                   "compactified evaluate")
    from repro_torch.core.integrand import gaussian_analytic
    offs = cspec.offsets()
    covered, total = 0, 0
    for idx, (region, d) in c_exact.items():
        sl = slice(offs[idx], offs[idx] + cspec.families[idx].n_fn)
        want = gaussian_analytic(64, d, half=region != "R^d")
        pull = np.abs(cres.means[0][sl] - want) / cres.stderrs[0][sl]
        covered += int((pull <= 2).sum())
        total += len(want)
        print(f"gaussian over {region}, d={d}: 2-sigma coverage "
              f"{float(np.mean(pull <= 2)):.4f}, worst pull {float(pull.max()):.2f}, "
              f"mean/exact {float(np.mean(cres.means[0][sl] / want)):.5f}")
    cover_c = covered / total
    print(f"compactified Gaussians: 2-sigma coverage {cover_c:.4f} over {total} "
          f"integrals at N={N_MAIN}")
    check(cover_c >= 0.85, f"compactified coverage {cover_c} < 0.85")
    c_draws = sum(f.n_fn * f.dim for f in czmc.spec.families) * N_MAIN
    c_values = czmc.spec.n_fn_total * N_MAIN
    tan_axes = sum(f.n_fn * f.dim for f, (r, _) in
                   ((czmc.spec.families[i], v) for i, v in c_exact.items())
                   if r == "R^d") * N_MAIN
    half_axes = sum(f.n_fn * f.dim for f, (r, _) in
                    ((czmc.spec.families[i], v) for i, v in c_exact.items())
                    if r != "R^d") * N_MAIN
    c_op = op_bound_ms(c_draws, c_values, n_sm, clock_hz, tan_axes, half_axes)
    compact_bound = max(c_op.values())
    print(f"compactified buckets (3 launches, {c_draws:.4g} draws, "
          f"{tan_axes:.4g} tan-map and {half_axes:.4g} half-line axes): kernel "
          f"{compact_ms:.3f} ms, plain {compact_plain_ms:.1f} ms, bound "
          f"{compact_bound:.3f} ms (kernel at {100 * compact_bound / compact_ms:.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in c_op.items()) + f"; on {card}")
    print("compactified pass 1: " + pass1_report(
        built["zmc_fused_mc"]["path"], pass1["<1,false,true>"], "<1,false,true>"))
    print(f"compactification per axis in the bounds: tan map {TAN_AXIS}, half-line "
          f"{HALF_AXIS}")

    # compactified Sobol: the same spec through fused_mc_pass1<1, true, true>
    cszmc = ZMCMultiFunctions(cspec, n_samples=N_MAIN, seed=3, use_kernel=True,
                              sampler="sobol", device="cuda")
    csplan = cszmc._get_fusion_plan()
    check(csplan.unfused == () and csplan.n_launches == 3 and csplan.sampler == "sobol",
          f"compactified Sobol spec: {csplan.n_launches} buckets, unfused {csplan.unfused}")
    cs_kw = [dict(sampler="sobol", dirvecs=b.dirvecs, block_tcols=b.block_tcols)
             for b in csplan.buckets]
    cs_err = 0.0
    for b, kw in zip(csplan.buckets, cs_kw):
        k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key, **kw)
        p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key, sampler="sobol",
                              block_tcols=b.block_tcols)
        torch.cuda.synchronize()
        cs_err = max(cs_err, compare_sums(b, k_out, p_out, N_CHECK))
    template.reset_kernel_launch_count()
    csres = cszmc.evaluate(num_trials=1)
    cs_counts = variant_counts({"fused_mc": True, "fused_mc_sobol": True,
                                "fused_mc_compactified": True},
                               "compactified Sobol evaluate")
    check(cs_counts["fused_mc_sobol"] == cs_counts["fused_mc_compactified"]
          == csplan.n_launches, "a compactified Sobol launch ran as MC or unstaged")
    covered, total = 0, 0
    for idx, (region, d) in c_exact.items():
        sl = slice(offs[idx], offs[idx] + cspec.families[idx].n_fn)
        want = gaussian_analytic(64, d, half=region != "R^d")
        covered += int((np.abs(csres.means[0][sl] - want) <= 2 * csres.stderrs[0][sl]).sum())
        total += len(want)
    cover_cs = covered / total
    print(f"compactified Gaussians, Sobol: 2-sigma coverage {cover_cs:.4f} over "
          f"{total} integrals at N={N_MAIN}")
    check(cover_cs >= 0.85, f"compactified Sobol coverage {cover_cs} < 0.85")

    def compact_sobol_launches():
        return [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key, **kw)
                for b, kw in zip(csplan.buckets, cs_kw)]

    compact_sobol_launches()
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(TIMING_REPS):
        csk_outs = compact_sobol_launches()
    ev1.record()
    torch.cuda.synchronize()
    cs_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    csp_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key, sampler="sobol",
                              block_tcols=b.block_tcols) for b in csplan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    cs_plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(csplan.buckets, csk_outs, csp_outs):
        cs_err = max(cs_err, compare_estimates(b, k_out, p_out, N_MAIN))
    cs_pts = distinct_point_dims(csplan, N_MAIN)
    cs_op = sobol_op_bound_ms(c_draws, c_values, cs_pts, n_sm, clock_hz, tan_axes,
                              half_axes)
    cs_bound = max(cs_op.values())
    compact_sobol = dict(launches=cs_counts["fused_mc_compactified"], max_abs_err=cs_err,
                         ms=cs_ms, plain_ms=cs_plain_ms, bound_ms=cs_bound)
    print(f"compactified Sobol buckets (3 launches, {c_draws:.4g} draws, {cs_pts:.4g} "
          f"distinct point dims): kernel {cs_ms:.3f} ms, plain {cs_plain_ms:.1f} ms, "
          f"bound {cs_bound:.3f} ms (kernel at {100 * cs_bound / cs_ms:.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in cs_op.items()) + f"; on {card}")
    print("compactified Sobol pass 1: " + pass1_report(
        built["zmc_fused_mc"]["path"], pass1["<1,true,true>"], "<1,true,true>"))
    laps.end(10)

    # -- 11. the service on the launcher's defaults --------------------------
    import tempfile
    from repro_torch.launch import serve_integrals
    state = tempfile.mkdtemp(prefix="zmc_state_")
    base_args = ["--device", "cuda", "--requests", "64", "--n-fn", "8",
                 "--samples", "16384", "--round-samples", "8192",
                 "--max-rounds-per-wave", "8"]
    n_dims = 3                         # the workload's families span dims 2-4
    runs = {}
    service_counts = dict.fromkeys(template.VARIANTS, 0)
    # the synchronous run's waves, as the batcher launched them, to hold
    # against the plain version below
    sync_waves = []
    launch_plan_rounds = multi.launch_plan_rounds

    def recorded(plan, round_samples, n_rounds, key, *, start_rounds):
        where, outputs = launch_plan_rounds(plan, round_samples, n_rounds, key,
                                            start_rounds=start_rounds)
        sync_waves.append((plan, round_samples, n_rounds, key,
                           dict(start_rounds), outputs))
        return where, outputs

    for label, extra in (("synchronous", ["--state-dir", state]),
                         ("pipelined", ["--thread"]),
                         ("restarted", ["--state-dir", state])):
        template.reset_kernel_launch_count()
        multi.launch_plan_rounds = recorded if label == "synchronous" else launch_plan_rounds
        try:
            out = serve_integrals.main(base_args + extra)
        finally:
            multi.launch_plan_rounds = launch_plan_rounds
        torch.cuda.synchronize()
        counts = variant_counts({"fused_mc_rounds": label != "restarted",
                                 "fused_mc_compactified": label != "restarted"},
                                f"service ({label})")
        for k, v in counts.items():
            service_counts[k] += v
        waves = out["stats"].waves
        digest = served_digest(out["results"])
        runs[label] = out
        print(f"service config 1 ({label}): {len(out['results'])} requests in "
              f"{out['seconds']:.4f} s -> {len(out['results']) / out['seconds']:.1f} "
              f"requests/s; {out['launches']} launches in {waves} waves "
              f"({out['launches'] / max(waves, 1):.2f} per wave against at most "
              f"{n_dims} buckets per wave); {out['fallback_rounds']} chunked "
              f"fallback rounds; {out['hits']} pure cache hits; digest {digest[:16]}")
        check(out["fallback_rounds"] == 0, f"{label}: chunked fallback rounds")
        check(out["launches"] <= n_dims * max(waves, 1),
              f"{label}: more launches than buckets per wave")
        out["digest"] = digest
    check(runs["restarted"]["launches"] == 0, "the warm replay launched kernels")
    check(runs["restarted"]["hits"] == len(runs["restarted"]["results"]),
          "the warm replay was not served from the cache")
    check(len({r["digest"] for r in runs.values()}) == 1,
          "synchronous, pipelined and restarted digests differ")
    print("service config 1: synchronous = pipelined = restarted digests "
          f"({runs['synchronous']['digest'][:16]}), warm replay 0 launches")
    # each launch of the synchronous run (R-round, compactified blocks at
    # the service's shapes) against the plain version with the same
    # rounds, window starts and transform columns, round by round
    n_compact = 0
    for plan_w, n_round, n_r, key_w, starts, outputs in sync_waves:
        scal = template.pack_scalars(key_w, 0, n_round, round_stride=n_round)
        for b, k_out in zip(plan_w.buckets, outputs):
            p_out = template.fused_mc_plain(
                scal, b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
                n_sample_blocks=-(-n_round // template.S_BLK), n_rounds=n_r,
                round_base=multi._round_base_for(b, starts, n_round),
                block_tcols=b.block_tcols)
            compact = bool((b.block_tcols >= 0).any())
            n_compact += compact and n_r > 1
            for r in range(n_r):
                err = compare_estimates(b, k_out[r:r + 1], p_out[r:r + 1], n_round)
                if compact:
                    compact_err = max(compact_err, err)
                else:
                    rounds_err = max(rounds_err, err)
    print(f"service config 1: {sum(len(w[5]) for w in sync_waves)} launches of "
          f"the synchronous run ({n_compact} with R > 1 and compactified "
          f"blocks; R in {sorted({w[2] for w in sync_waves})}) held against "
          f"the plain version")
    check(n_compact > 0,
          "the synchronous run launched no R > 1 compactified bucket")
    print("service config 1, traced synchronous run: " + traced_split(
        serve_integrals.demo_workload(64, n_fn=8, n_samples=16384),
        round_samples=8192, max_rounds_per_wave=8))
    laps.end(11)

    # -- 12. the service at full width: Fig.-1 as requests ------------------
    from repro_torch.service import IntegrationEngine, IntegrationRequest
    reqs = [IntegrationRequest.make([f], n_samples=N_FULL) for f in spec.families]
    engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                               max_rounds_per_wave=FULL_R)
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    tickets = [engine.submit(r) for r in reqs]
    while engine.step():
        pass
    full = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    full_counts = variant_counts({"fused_mc_rounds": True}, "service config 2")
    full_launches = template.kernel_launch_count()
    for k, v in full_counts.items():
        service_counts[k] += v
    offsets = [e.fn_offset for e in (engine.cache.get(c) for c in
               (r.stream_ids[0] for r in full))]
    engine.close()
    print(f"service config 2: {spec.n_fn_total} integrands x {N_FULL} samples in "
          f"{engine.stats.waves} waves, {full_launches} kernel launches, "
          f"{engine.batcher.fallback_rounds} fallback rounds, {full_wall:.4f} s wall; "
          f"fn offsets {'=' if offsets == spec.offsets() else '!='} spec.offsets()")
    check(full_launches == 6, f"expected 6 launches, got {full_launches}")
    check(offsets == spec.offsets(), "the cache placed the families elsewhere")
    # the same counters through evaluate: one 2^20-sample round per family
    ref = ZMCMultiFunctions(spec, n_samples=N_FULL, seed=0, use_kernel=True,
                            device="cuda").evaluate(num_trials=1)
    got_m = np.concatenate([r.means for r in full])
    got_s = np.concatenate([r.stderrs for r in full])
    d_mean = float(np.max(np.abs(got_m - ref.means[0]) / ref.stderrs[0]))
    d_se = float(np.max(np.abs(got_s - ref.stderrs[0]) / ref.stderrs[0]))
    print(f"service config 2 vs evaluate(n_samples={N_FULL}): max |d mean| "
          f"{d_mean:.3g}, max |d stderr| {d_se:.3g} standard errors "
          f"(limit {EST_TOL})")
    check(d_mean <= EST_TOL and d_se <= EST_TOL,
          "service config 2 disagrees with evaluate")
    # one wave's launches (R = 8 rounds of 65536 per family), timed alone
    fplan = multi.plan_spec(spec)
    start = {i: 0 for i in range(len(spec.families))}
    ev0.record()
    for _ in range(TIMING_REPS):
        multi.launch_plan_rounds(fplan, FULL_ROUND, FULL_R, engine.key,
                                 start_rounds=start)
    ev1.record()
    torch.cuda.synchronize()
    wave_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    _, k_wave = multi.launch_plan_rounds(fplan, FULL_ROUND, FULL_R, engine.key,
                                         start_rounds=start)
    ev0.record()
    p_wave = [template.fused_mc_plain(
        template.pack_scalars(engine.key, 0, FULL_ROUND, round_stride=FULL_ROUND),
        b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
        n_sample_blocks=FULL_ROUND // template.S_BLK, n_rounds=FULL_R,
        round_base=multi._round_base_for(b, start, FULL_ROUND),
        block_tcols=b.block_tcols) for b in fplan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    wave_plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(fplan.buckets, k_wave, p_wave):
        # the wave's R rounds folded, as the cache folds them
        rounds_err = max(rounds_err, compare_estimates(
            b, k_out.sum(0, keepdim=True), p_out.sum(0, keepdim=True),
            FULL_ROUND * FULL_R))
    w_draws = sum(f.n_fn * f.dim for f in spec.families) * FULL_ROUND * FULL_R
    w_values = spec.n_fn_total * FULL_ROUND * FULL_R
    w_op = op_bound_ms(w_draws, w_values, n_sm, clock_hz)
    wave_bound = max(w_op.values())
    host_share = 1 - engine.stats.waves * wave_ms / (full_wall * 1e3)
    print("service config 2, traced synchronous run: " + traced_split(
        reqs, round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R))
    print(f"service config 2: kernel {wave_ms:.3f} ms per wave (3 launches, R={FULL_R}, "
          f"{w_draws:.4g} draws), plain {wave_plain_ms:.1f} ms, bound "
          f"{wave_bound:.3f} ms (kernel at {100 * wave_bound / wave_ms:.1f}%); wall "
          f"{1e3 * full_wall / max(engine.stats.waves, 1):.3f} ms per wave, host share "
          f"{100 * host_share:.1f}% of the wall; on {card}")
    laps.end(12)

    # -- 13. device Sobol points and shifts, bit for bit --------------------
    from repro_torch.core import sobol
    n = 1 << 17
    i = torch.arange(n, dtype=torch.int64, device=device)
    idx = (2**32 - n // 4 + i * 3) & rng.MASK32             # crosses 2^32
    fid = (i * 2654435761) % (1 << 24)
    k0, k1 = rng.fold_key(2025, 3)
    bad = 0
    for dim in range(1, sobol.MAX_DIM + 1):
        pts, shs = template.sobol_cuda(k0, k1, idx, fid, dim)
        d = torch.arange(dim, device=device)
        want_sh = rng.random_bits(
            k0, k1, torch.full((1,), sobol.SHIFT_C0, device=device),
            rng.counter_c1(fid[:, None], d[None, :]))
        bad += int((pts != sobol.sobol_bits(idx, dim)).sum())
        bad += int((shs != want_sh).sum())
    torch.cuda.synchronize()
    print(f"device sobol_point / sobol_shift vs core.sobol: {bad} differences over "
          f"{n} indices x dims 1-{sobol.MAX_DIM} (indices from {2**32 - n // 4}, "
          f"crossing 2^32)")
    check(bad == 0, f"device Sobol points or shifts differ in {bad} words")
    # the points as pass 1 walks them: 256 threads, each along its stride-256
    # run, every run crossing 2^32
    start = 2**32 - 256 * 200 - 99
    walk_idx = (start + i[:256 * 400]) & rng.MASK32
    bad = sum(int((template.sobol_walk_cuda(start, walk_idx.numel(), dim, device)
                   != sobol.sobol_bits(walk_idx, dim)).sum())
              for dim in range(1, sobol.MAX_DIM + 1))
    print(f"device walked Sobol points (sobol_walk, 256 runs of stride 256 crossing "
          f"2^32) vs core.sobol: {bad} differences over {walk_idx.numel()} indices x "
          f"dims 1-{sobol.MAX_DIM}")
    check(bad == 0, f"walked Sobol points differ in {bad} words")
    laps.end(13)

    # -- 14. Fig.-1 evaluate with the Sobol sampler --------------------------
    splan = multi.plan_spec(spec, sampler="sobol")
    check(splan.unfused == () and splan.n_launches == 3,
          f"Sobol plan: {splan.n_launches} buckets, unfused {splan.unfused}")
    key = rng.fold_key(0, 0)
    sobol_err = 0.0
    for b in splan.buckets:
        kw = dict(sampler="sobol", dirvecs=b.dirvecs)
        k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key, **kw)
        k_again = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key, **kw)
        p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key, sampler="sobol")
        torch.cuda.synchronize()
        sobol_err = max(sobol_err, compare_sums(b, k_out, p_out, N_CHECK))
        d1 = hashlib.sha256(k_out.cpu().numpy().tobytes()).hexdigest()
        d2 = hashlib.sha256(k_again.cpu().numpy().tobytes()).hexdigest()
        print(f"Sobol bucket d{b.dim} at N={N_CHECK}: repeat sha256 {d1[:16]} "
              f"{d2[:16]} {'equal' if d1 == d2 else 'DIFFER'}")
        check(d1 == d2, f"Sobol d{b.dim}: repeated launches differ")
        # R = 4 rounds at other window depths, one crossing 2^32
        n_blocks = b.fn_ids.shape[0] // template.F_BLK
        base = torch.tensor([(j * 37 * N_ROUND) & rng.MASK32 for j in range(n_blocks)],
                            dtype=torch.int64)
        base[n_blocks // 2] = 2**32 - 3 * N_ROUND // 2
        ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
        rkw = dict(dim=b.dim, n_sample_blocks=N_ROUND // template.S_BLK,
                   round_base=base, sampler="sobol")
        r_out = template.fused_mc_cuda(
            template.pack_scalars(key, 0, N_ROUND, round_stride=N_ROUND), *ops,
            n_rounds=ROUNDS, **rkw)
        same = 0
        for r in range(ROUNDS):
            one = template.fused_mc_cuda(
                template.pack_scalars(key, r * N_ROUND, N_ROUND), *ops, **rkw)
            same += (hashlib.sha256(r_out[r].cpu().numpy().tobytes()).digest()
                     == hashlib.sha256(one[0].cpu().numpy().tobytes()).digest())
        print(f"Sobol bucket d{b.dim}: R={ROUNDS} launch: {same}/{ROUNDS} rounds "
              f"sha256-equal to single-round launches (one window crossing 2^32)")
        check(same == ROUNDS, f"Sobol d{b.dim}: a round differs from its single-round launch")

    szmc = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                             sampler="sobol", device="cuda")
    template.reset_launch_count()
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    sres = szmc.evaluate(num_trials=TRIALS)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    s_launches = template.kernel_launch_count()
    sobol_counts = variant_counts({"fused_mc": True, "fused_mc_sobol": True},
                                  "Sobol evaluate path")
    print(f"Sobol evaluate(num_trials={TRIALS}) at N={N_MAIN}: {swall / TRIALS:.4f} s "
          f"per trial (wall); {s_launches} kernel launches")
    check(s_launches == splan.n_launches * TRIALS,
          f"expected {splan.n_launches * TRIALS} Sobol launches, got {s_launches}")
    check(sobol_counts["fused_mc_sobol"] == s_launches, "a Sobol launch ran as MC")
    check(bool(np.isfinite(sres.means).all() and np.isfinite(sres.stderrs).all()),
          "non-finite Sobol estimates")
    s_fbar, s_dfn = sres.trial_mean, sres.trial_std
    s_cover = float(np.mean(np.abs(s_fbar[:700] - exact_h) <= 2 * s_dfn[:700]))
    ratio = dfn / np.maximum(s_dfn, 1e-30)
    print(f"Sobol harmonic 2-sigma coverage vs harmonic_analytic: {s_cover:.4f} (700 "
          f"integrands); median MC-to-Sobol ratio of trial_std over the "
          f"{spec.n_fn_total} integrals {float(np.median(ratio)):.2f} (harmonics "
          f"{float(np.median(ratio[:700])):.2f})")
    check(s_cover >= 0.85, f"Sobol harmonic coverage {s_cover} < 0.85")

    ev0.record()
    for _ in range(TIMING_REPS):
        sk_outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key,
                                 sampler="sobol", dirvecs=b.dirvecs)
                   for b in splan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    sobol_ms = ev0.elapsed_time(ev1) / TIMING_REPS
    ev0.record()
    sp_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key, sampler="sobol")
               for b in splan.buckets]
    ev1.record()
    torch.cuda.synchronize()
    sobol_plain_ms = ev0.elapsed_time(ev1)
    for b, k_out, p_out in zip(splan.buckets, sk_outs, sp_outs):
        sobol_err = max(sobol_err, compare_estimates(b, k_out, p_out, N_MAIN))
    s_pts = distinct_point_dims(splan, N_MAIN)
    s_built = built_point_dims(splan, N_MAIN)
    s_op = sobol_op_bound_ms(draws, values, s_pts, n_sm, clock_hz)
    sobol_bound = max(s_op.values())
    print(f"Sobol trial (3 launches, {draws:.4g} draws, {s_pts:.4g} distinct point "
          f"dims, {s_built:.4g} walked, once per 16-function block): kernel "
          f"{sobol_ms:.3f} ms, plain {sobol_plain_ms:.1f} ms, bound {sobol_bound:.3f} ms "
          f"(kernel at {100 * sobol_bound / sobol_ms:.1f}% of it): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in s_op.items())
          + f"; MC kernel {kernel_ms:.3f} ms; on {card}")
    print("Sobol pass 1: " + pass1_report(built["zmc_fused_mc"]["path"],
                                          pass1["<0,true,true>"], "<0,true,true>")
          + f"; kernel {sobol_ms:.3f} ms against its bound {sobol_bound:.3f} ms")
    laps.end(14)

    # -- 15. service configuration 3: a parameter sweep at full width --------
    from repro_torch.core.integrand import MultiFunctionSpec, harmonic_family
    from repro_torch.service import SweepRequest
    a_vals = np.linspace(*SWEEP_A).astype(np.float32)
    b_vals = np.linspace(*SWEEP_B).astype(np.float32)
    grid = {"a": a_vals, "b": b_vals}
    tmpl = harmonic_family(1, 4)
    n_pts = len(a_vals) * len(b_vals)
    swept = {}                          # per sampler: its kernels-line numbers
    for sampler in ("mc", "sobol"):
        swept_err = 0.0
        engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                                   max_rounds_per_wave=FULL_R)
        waves_rec = []

        def recorded_sweep(plan, round_samples, n_rounds, key, *, start_rounds):
            where, outputs = launch_plan_rounds(plan, round_samples, n_rounds, key,
                                                start_rounds=start_rounds)
            waves_rec.append((plan, round_samples, n_rounds, key, dict(start_rounds),
                              outputs))
            return where, outputs

        multi.launch_plan_rounds = recorded_sweep
        template.reset_kernel_launch_count()
        try:
            t0 = time.perf_counter()
            ticket = engine.submit(SweepRequest.make(tmpl, grid, n_samples=N_FULL,
                                                     sampler=sampler))
            while engine.step():
                pass
            sres3 = engine.poll(ticket)
            torch.cuda.synchronize()
            sweep_wall = time.perf_counter() - t0
        finally:
            multi.launch_plan_rounds = launch_plan_rounds
        counts = variant_counts({"fused_mc_rounds": True, "fused_mc_swept": True,
                                 "fused_mc_sobol": sampler == "sobol"},
                                f"service config 3 ({sampler})")
        n_launch = template.kernel_launch_count()
        waves = engine.stats.waves
        print(f"service config 3 ({sampler}): {n_pts} points in "
              f"{len(sres3.stream_ids)} slices x {N_FULL} samples: {n_launch} kernel "
              f"launches in {waves} waves (at most 1 bucket per wave), "
              f"{engine.batcher.fallback_rounds} fallback rounds, {sweep_wall:.4f} s "
              f"wall, {1e3 * sweep_wall / max(waves, 1):.3f} ms per wave")
        check(sres3.complete and sres3.grid_shape == (len(a_vals), len(b_vals)),
              "config 3: sweep result incomplete or misshapen")
        check(bool(np.isfinite(sres3.means).all() and (sres3.stderrs > 0).all()),
              "config 3: non-finite estimates")
        check(n_launch <= waves, "config 3: more launches than buckets per wave")
        check(engine.batcher.fallback_rounds == 0, "config 3: chunked fallback rounds")
        check(len(sres3.stream_ids) == n_pts // SWEEP_SLICE, "config 3: slice count")
        # each launch against the plain version with the same rounds, window
        # starts and sweep pairs, round by round
        for plan_w, n_round, n_r, key_w, starts, outputs in waves_rec:
            scal = template.pack_scalars(key_w, 0, n_round, round_stride=n_round)
            for b, k_out in zip(plan_w.buckets, outputs):
                check(b.block_sweep is not None, "config 3: a bucket without sweep pairs")
                p_out = template.fused_mc_plain(
                    scal, b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
                    n_sample_blocks=-(-n_round // template.S_BLK), n_rounds=n_r,
                    round_base=multi._round_base_for(b, starts, n_round),
                    block_sweep=b.block_sweep, sampler=sampler)
                for r in range(n_r):
                    swept_err = max(swept_err, compare_estimates(
                        b, k_out[r:r + 1], p_out[r:r + 1], n_round))
        # slice 0 of the first wave against its 64 points as per-point
        # families, with the same fn ids, window starts and rounds
        plan_w, n_round, n_r, key_w, starts, outputs = waves_rec[0]
        (b,) = plan_w.buckets
        off = engine.cache.get(sres3.stream_ids[0]).fn_offset
        sl = next(x for x in b.slices if int(b.fn_ids[x.row_start]) == off)
        pts_spec = MultiFunctionSpec.from_families([
            harmonic_family(1, 4, a=a_vals[j // len(b_vals)][None],
                            b=b_vals[j % len(b_vals)][None])
            for j in range(SWEEP_SLICE)]).to(device)
        pts_plan = multi.plan_spec(pts_spec, sampler=sampler,
                                   fn_offsets=[off + j for j in range(SWEEP_SLICE)])
        _, pts_out = launch_plan_rounds(
            pts_plan, n_round, n_r, key_w,
            start_rounds={j: starts[sl.family_index] for j in range(SWEEP_SLICE)})
        equal = 0
        for j, ps in enumerate(pts_plan.buckets[0].slices):
            got = outputs[0][:, sl.row_start + j].cpu().numpy().tobytes()
            want = pts_out[0][:, ps.row_start].cpu().numpy().tobytes()
            equal += hashlib.sha256(got).digest() == hashlib.sha256(want).digest()
        print(f"service config 3 ({sampler}): slice 0's {SWEEP_SLICE} points, all "
              f"{n_r} rounds: {equal}/{SWEEP_SLICE} sha256-equal to per-point "
              f"families launched with the same fn ids and windows")
        check(equal == SWEEP_SLICE, f"config 3 ({sampler}): a swept point differs "
                                    f"from its per-point launch")
        # one wave's launch, timed alone
        start0 = {x.family_index: 0 for x in b.slices}
        ev0.record()
        for _ in range(TIMING_REPS):
            launch_plan_rounds(plan_w, n_round, n_r, key_w, start_rounds=start0)
        ev1.record()
        torch.cuda.synchronize()
        sweep_ms = ev0.elapsed_time(ev1) / TIMING_REPS
        ev0.record()
        template.fused_mc_plain(
            template.pack_scalars(key_w, 0, n_round, round_stride=n_round),
            b.fn_ids, b.packed, b.lo, b.hi, b.block_forms, dim=b.dim,
            n_sample_blocks=-(-n_round // template.S_BLK), n_rounds=n_r,
            round_base=multi._round_base_for(b, start0, n_round),
            block_sweep=b.block_sweep, sampler=sampler)
        ev1.record()
        torch.cuda.synchronize()
        sweep_plain_ms = ev0.elapsed_time(ev1)
        w3_values = float(n_pts) * n_round * n_r
        w3_draws = w3_values * b.dim
        bound3 = max((op_bound_ms(w3_draws, w3_values, n_sm, clock_hz)
                      if sampler == "mc" else
                      sobol_op_bound_ms(w3_draws, w3_values, distinct_point_dims(
                          plan_w, n_round, [multi._round_base_for(b, start0, n_round)],
                          n_r, n_round), n_sm, clock_hz)).values())
        swept[sampler] = dict(launches=counts["fused_mc_swept"], max_abs_err=swept_err,
                              ms=sweep_ms, plain_ms=sweep_plain_ms, bound_ms=bound3)
        host3 = 1 - waves * sweep_ms / (1e3 * sweep_wall)
        print(f"service config 3 ({sampler}): kernel {sweep_ms:.3f} ms per "
              f"wave (1 launch, R={n_r}, {w3_draws:.4g} draws), plain "
              f"{sweep_plain_ms:.1f} ms, bound {bound3:.3f} ms (kernel at "
              f"{100 * bound3 / sweep_ms:.1f}%); host share "
              f"{100 * host3:.1f}% of the wall; on {card}")
        # an overlapping sweep: the prefix grid a[:16] x b, 8 aligned slices
        template.reset_kernel_launch_count()
        t_over = engine.submit(SweepRequest.make(
            tmpl, {"a": a_vals[:SWEEP_PREFIX], "b": b_vals}, n_samples=N_FULL,
            sampler=sampler))
        while engine.step():
            pass
        over = engine.poll(t_over)
        torch.cuda.synchronize()
        over_launches = template.kernel_launch_count()
        same_prefix = np.array_equal(over.means,
                                     sres3.means[:SWEEP_PREFIX * len(b_vals)])
        print(f"service config 3 ({sampler}): overlapping sweep a[:{SWEEP_PREFIX}] x b "
              f"({len(over.stream_ids)} slices): {over_launches} launches, served "
              f"from cache {over.served_from_cache}, means equal to the full sweep's "
              f"prefix: {same_prefix}")
        check(over_launches == 0 and over.served_from_cache and same_prefix,
              f"config 3 ({sampler}): the overlapping sweep was not a free cache hit")
        engine.close()
        print(f"service config 3 ({sampler}), traced synchronous run: " + traced_split(
            [SweepRequest.make(tmpl, grid, n_samples=N_FULL, sampler=sampler)],
            round_samples=FULL_ROUND, max_rounds_per_wave=FULL_R))
    laps.end(15)

    # -- 16. service configuration 2 with the Sobol sampler ------------------
    sreqs = [IntegrationRequest.make([f], n_samples=N_FULL, sampler="sobol")
             for f in spec.families]
    engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                               max_rounds_per_wave=FULL_R)
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    tickets = [engine.submit(r) for r in sreqs]
    while engine.step():
        pass
    sfull = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    sfull_wall = time.perf_counter() - t0
    variant_counts({"fused_mc_rounds": True, "fused_mc_sobol": True},
                   "service config 2 (sobol)")
    s2_launches = template.kernel_launch_count()
    engine.close()
    sref = ZMCMultiFunctions(spec, n_samples=N_FULL, seed=0, use_kernel=True,
                             sampler="sobol", device="cuda").evaluate(num_trials=1)
    got_m = np.concatenate([r.means for r in sfull])
    got_s = np.concatenate([r.stderrs for r in sfull])
    d_mean = float(np.max(np.abs(got_m - sref.means[0]) / sref.stderrs[0]))
    d_se = float(np.max(np.abs(got_s - sref.stderrs[0]) / sref.stderrs[0]))
    print(f"service config 2 (sobol): {s2_launches} kernel launches in "
          f"{engine.stats.waves} waves, {engine.batcher.fallback_rounds} fallback "
          f"rounds, {sfull_wall:.4f} s wall; vs evaluate(sampler='sobol', "
          f"n_samples={N_FULL}): max |d mean| {d_mean:.3g}, max |d stderr| "
          f"{d_se:.3g} standard errors (limit {EST_TOL})")
    check(s2_launches == 6 and engine.batcher.fallback_rounds == 0,
          "service config 2 (sobol): expected 6 launches and no fallback")
    check(d_mean <= EST_TOL and d_se <= EST_TOL,
          "service config 2 (sobol) disagrees with evaluate")
    laps.end(16)

    # -- 17. adapted families: VEGAS grids through the fused kernel ---------
    t0 = time.perf_counter()
    aspec, uspec, a_exact = adapted_spec(device)
    torch.cuda.synchronize()
    print(f"adapted spec: {aspec.n_fn_total} integrands in {len(aspec.families)} "
          f"families ({', '.join(f.name for f in aspec.families)}), grids fitted on "
          f"the card in {time.perf_counter() - t0:.2f} s ({ADAPT_EPOCHS} epochs of "
          f"{ADAPT_PILOT}-sample pilots, {ADAPT_BINS} bins per axis)")
    adapted = {}                 # per sampler: its kernels-line numbers and result
    a_offs = aspec.offsets()
    for sampler in ("mc", "sobol"):
        aplan = multi.plan_spec(aspec, sampler=sampler)
        check(aplan.unfused == () and aplan.n_launches == 3,
              f"adapted plan ({sampler}): {aplan.n_launches} buckets, unfused "
              f"{aplan.unfused}")
        key = rng.fold_key(0, 0)
        a_err = 0.0
        for b in aplan.buckets:
            check(bool((b.block_adapt[0] >= 0).all()), "a bucket block without its grid")
            kw = dict(block_tcols=b.block_tcols, block_adapt=b.block_adapt,
                      sampler=sampler)
            k_out = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key,
                                  block_meta=b.block_meta, dirvecs=b.dirvecs, **kw)
            k_again = launch_bucket(template.fused_mc_cuda, b, N_CHECK, key,
                                    block_meta=b.block_meta, dirvecs=b.dirvecs, **kw)
            p_out = launch_bucket(template.fused_mc_plain, b, N_CHECK, key, **kw)
            torch.cuda.synchronize()
            a_err = max(a_err, compare_sums(b, k_out, p_out, N_CHECK))
            same = sha256_of(k_out) == sha256_of(k_again)
            # R = 4 rounds at other window depths, one crossing 2^32
            n_blocks = b.fn_ids.shape[0] // template.F_BLK
            base = torch.tensor([(j * 37 * N_ROUND) & rng.MASK32
                                 for j in range(n_blocks)], dtype=torch.int64)
            base[n_blocks // 2] = 2**32 - 3 * N_ROUND // 2
            ops = (b.fn_ids, b.packed, b.lo, b.hi, b.block_forms)
            rkw = dict(kw, dim=b.dim, n_sample_blocks=N_ROUND // template.S_BLK,
                       round_base=base, block_meta=b.block_meta, dirvecs=b.dirvecs)
            r_out = template.fused_mc_cuda(
                template.pack_scalars(key, 0, N_ROUND, round_stride=N_ROUND), *ops,
                n_rounds=ROUNDS, **rkw)
            rounds_same = sum(
                sha256_of(r_out[r]) == sha256_of(template.fused_mc_cuda(
                    template.pack_scalars(key, r * N_ROUND, N_ROUND), *ops, **rkw)[0])
                for r in range(ROUNDS))
            print(f"adapted bucket d{b.dim} ({sampler}): repeat sha256 "
                  f"{'equal' if same else 'DIFFER'}; R={ROUNDS} launch: {rounds_same}/"
                  f"{ROUNDS} rounds sha256-equal to single-round launches (one window "
                  f"crossing 2^32)")
            check(same, f"adapted d{b.dim} ({sampler}): repeated launches differ")
            check(rounds_same == ROUNDS,
                  f"adapted d{b.dim} ({sampler}): a round differs from its single-round launch")

        azmc = ZMCMultiFunctions(aspec, n_samples=N_MAIN, seed=0, use_kernel=True,
                                 sampler=sampler, device="cuda")
        template.reset_launch_count()
        template.reset_kernel_launch_count()
        t0 = time.perf_counter()
        ares = azmc.evaluate(num_trials=TRIALS)
        torch.cuda.synchronize()
        awall = time.perf_counter() - t0
        a_launches = template.kernel_launch_count()
        a_counts = variant_counts({"fused_mc": True, "fused_mc_adapted": True,
                                   "fused_mc_compactified": True,
                                   "fused_mc_sobol": sampler == "sobol"},
                                  f"adapted evaluate path ({sampler})")
        print(f"adapted evaluate(num_trials={TRIALS}, sampler={sampler!r}) at N={N_MAIN}: "
              f"{awall / TRIALS:.4f} s per trial (wall); {a_launches} kernel launches")
        check(a_launches == aplan.n_launches * TRIALS,
              f"expected {aplan.n_launches * TRIALS} adapted launches, got {a_launches}")
        check(a_counts["fused_mc_adapted"] == a_launches, "an adapted launch ran no grid")
        check(bool(np.isfinite(ares.means).all() and np.isfinite(ares.stderrs).all()),
              "non-finite adapted estimates")
        pull = np.abs(ares.trial_mean - a_exact) / np.maximum(ares.trial_std, 1e-30)
        a_cover = float(np.mean(pull <= 2))
        print(f"adapted ({sampler}) 2-sigma coverage vs exact: {a_cover:.4f} over "
              f"{aspec.n_fn_total} integrals; "
              + ", ".join(f"{f.name} {float(np.mean(pull[o:o + f.n_fn] <= 2)):.4f}"
                          for f, o in zip(aspec.families, a_offs)))
        check(a_cover >= 0.85, f"adapted ({sampler}) coverage {a_cover} < 0.85")

        kw_of = {b.name: dict(block_tcols=b.block_tcols, block_adapt=b.block_adapt,
                              sampler=sampler) for b in aplan.buckets}
        ev0.record()
        for _ in range(TIMING_REPS):
            ak_outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key,
                                     block_meta=b.block_meta, dirvecs=b.dirvecs,
                                     **kw_of[b.name]) for b in aplan.buckets]
        ev1.record()
        torch.cuda.synchronize()
        a_ms = ev0.elapsed_time(ev1) / TIMING_REPS
        ev0.record()
        ap_outs = [launch_bucket(template.fused_mc_plain, b, N_MAIN, key, **kw_of[b.name])
                   for b in aplan.buckets]
        ev1.record()
        torch.cuda.synchronize()
        a_plain_ms = ev0.elapsed_time(ev1)
        for b, k_out, p_out in zip(aplan.buckets, ak_outs, ap_outs):
            a_err = max(a_err, compare_estimates(b, k_out, p_out, N_MAIN))
        a_draws = float(sum(f.n_fn * f.dim for f in aspec.families)) * N_MAIN
        a_values = float(aspec.n_fn_total) * N_MAIN
        a_tan = float(aspec.families[2].n_fn * aspec.families[2].dim) * N_MAIN
        if sampler == "mc":
            a_op = op_bound_ms(a_draws, a_values, n_sm, clock_hz, tan_axes=a_tan,
                               adapt_axes=a_draws, adapt_values=a_values)
        else:
            a_op = sobol_op_bound_ms(a_draws, a_values, distinct_point_dims(aplan, N_MAIN),
                                     n_sm, clock_hz, tan_axes=a_tan, adapt_axes=a_draws,
                                     adapt_values=a_values)
        a_bound = max(a_op.values())
        print(f"adapted trial ({sampler}, 3 launches, {a_draws:.4g} draws through a grid, "
              f"{a_tan:.4g} of them then through the tan map): kernel {a_ms:.3f} ms, "
              f"plain {a_plain_ms:.1f} ms, bound {a_bound:.3f} ms (kernel at "
              f"{100 * a_bound / a_ms:.1f}% of it): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in a_op.items()) + f"; on {card}")
        inst = "<2,false,true>" if sampler == "mc" else "<2,true,true>"
        print(f"adapted pass 1 ({sampler}): "
              + pass1_report(built["zmc_fused_mc"]["path"], pass1[inst], inst)
              + f"; kernel {a_ms:.3f} ms against its bound {a_bound:.3f} ms")
        adapted[sampler] = dict(launches=a_counts["fused_mc_adapted"], max_abs_err=a_err,
                                ms=a_ms, plain_ms=a_plain_ms, bound_ms=a_bound,
                                res=ares)
    ures = ZMCMultiFunctions(uspec, n_samples=N_MAIN, seed=0, use_kernel=True,
                             device="cuda").evaluate(num_trials=TRIALS)
    ratio = ures.trial_std / np.maximum(adapted["mc"]["res"].trial_std, 1e-30)
    print(f"unadapted-to-adapted trial_std ratio (MC, {TRIALS} trials at N={N_MAIN}): "
          f"median {float(np.median(ratio)):.2f} over {aspec.n_fn_total} integrals; "
          + ", ".join(f"{f.name} {float(np.median(ratio[o:o + f.n_fn])):.2f}"
                      for f, o in zip(uspec.families, a_offs)))
    check(float(np.median(ratio)) > 1.0, "the grids did not lower the trial spread")
    laps.end(17)

    # -- 18. adaptive requests through the service (BENCH_10's protocol) ----
    import shutil
    from repro_torch.core import genz
    from repro_torch.core.integrand import gaussian_family
    from repro_torch.obs import Observability
    from repro_torch.service.api import IntegrationClient

    def bench10_engine(state_dir=None):
        return IntegrationEngine(state_dir=state_dir, device="cuda",
                                 obs=Observability.enabled(), **BENCH10_KW)

    def solve(fams, target, adaptive):
        eng = bench10_engine()
        t0 = time.perf_counter()
        res = IntegrationClient(eng).integrate(fams, target_stderr=target,
                                               adaptive=adaptive)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        samples = int(sum(res.n_per_family))
        if adaptive:
            # every pilot charged: one per opened epoch plus at most one
            # frozen refit attempt per base stream, per function
            epochs = int(eng.obs.m["adapted_streams"].value())
            samples += ((epochs + len(fams)) * eng.adapt_pilot_samples
                        * sum(f.n_fn for f in fams))
        refits = int(eng.obs.m["grid_refits"].value())
        out = (res, samples, refits, dt, eng.stats.waves, eng.batcher.fallback_rounds)
        eng.close()
        return out

    corner, corner_exact = genz.corner_peak(2, 3, difficulty=4.0)
    gauss2 = gaussian_family(2, 2, sigma=[0.2, 0.35], lo=-np.inf, hi=np.inf)
    service_adapt = 0
    for name, fams, target, exact in (("genz_corner_3d", [corner], 5e-5, corner_exact),
                                      ("gaussian_r2", [gauss2], 5e-4, None)):
        f_res, f_n, _, f_dt, f_waves, _ = solve(fams, target, False)
        template.reset_kernel_launch_count()
        a_res, a_n, refits, a_dt, a_waves, a_fb = solve(fams, target, True)
        service_adapt += variant_counts({"fused_mc_adapted": True},
                                        f"adaptive service ({name})")["fused_mc_adapted"]
        ratio10 = f_n / max(a_n, 1)
        print(f"adaptive[{name}]: {f_n} fixed vs {a_n} adapted samples (pilots "
              f"charged) to stderr <= {target:g}: {ratio10:.1f}x fewer, {refits} "
              f"refit(s), {a_waves} waves ({f_waves} fixed), {a_fb} fallback rounds; "
              f"{f_dt:.3f} s vs {a_dt:.3f} s; means {a_res.means} (fixed "
              f"{f_res.means}, exact {exact})")
        check(ratio10 >= 5.0, f"{name}: {ratio10:.1f}x fewer samples, gate >= 5x")
        check(refits >= 1, f"{name}: no grid refit fired")
        check(bool(np.all(a_res.stderrs <= target)), f"{name}: target not met")
        if exact is not None:
            check(bool(np.all(np.abs(a_res.means - exact) <= 6 * a_res.stderrs + 1e-5)),
                  f"{name}: adapted estimate off its analytic value")
        check(bool(np.all(np.abs(a_res.means - f_res.means)
                          <= 6 * (a_res.stderrs + f_res.stderrs) + 1e-6)),
              f"{name}: adaptive and fixed paths disagree")
        check(a_fb == 0, f"{name}: chunked fallback rounds")
    # an adapted run abandoned after 3 waves and resumed from its state dir
    work = tempfile.mkdtemp(prefix="zmc_adapt_")
    eng = bench10_engine(os.path.join(work, "uninterrupted"))
    r_a = IntegrationClient(eng).integrate([corner], target_stderr=RESUME_TARGET,
                                           adaptive=True)
    waves_a = eng.stats.waves
    eng.close()
    eng = bench10_engine(os.path.join(work, "interrupted"))
    eng.submit(IntegrationRequest.make([corner], target_stderr=RESUME_TARGET,
                                       adaptive=True))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    del eng                    # abandoned mid-flight: no close(), no snapshot
    eng = bench10_engine(os.path.join(work, "interrupted"))
    r_b = IntegrationClient(eng).integrate([corner], target_stderr=RESUME_TARGET,
                                           adaptive=True)
    eng.close()                # both of work's state dirs are audited at step 21
    same_ids = r_a.stream_ids == r_b.stream_ids
    same_bytes = (served_digest([r_a]) == served_digest([r_b])
                  and r_a.n_per_family == r_b.n_per_family)
    print(f"adaptive resume: uninterrupted run {waves_a} waves; abandoned after 3 "
          f"and resumed: stream ids {'equal' if same_ids else 'DIFFER'}, results "
          f"sha256 {'equal' if same_bytes else 'DIFFER'} ({served_digest([r_a])[:16]})")
    check(same_ids and same_bytes, "the resumed adapted run differs from the uninterrupted one")
    # the 1024-integrand batch as adaptive requests, one per family, each
    # target the family's largest standard error at one wave's samples
    # under the step-17 grids (epoch 3), so the engine's chain (epoch 1,
    # refits at its wave boundaries) needs about 2-4 waves
    se = adapted["mc"]["res"].stderrs.mean(0) * np.sqrt(N_MAIN / (FULL_R * FULL_ROUND))
    targets = [1.1 * float(se[o:o + f.n_fn].max()) for f, o in zip(uspec.families, a_offs)]
    raw = [genz.corner_peak(512, 3, difficulty=4.0)[0],
           genz.corner_peak(384, 4, difficulty=4.0)[0],
           gaussian_family(128, 2, sigma=np.linspace(0.2, 0.35, 128).astype(np.float32),
                           lo=-np.inf, hi=np.inf)]
    engine = IntegrationEngine(round_samples=FULL_ROUND, device="cuda",
                               max_rounds_per_wave=FULL_R, pipeline_waves=False,
                               obs=Observability.enabled())
    template.reset_kernel_launch_count()
    t0 = time.perf_counter()
    tickets = [engine.submit(IntegrationRequest.make([f], target_stderr=t, adaptive=True))
               for f, t in zip(raw, targets)]
    per_wave = []
    while True:
        before = template.kernel_launch_count()
        if not engine.step():
            break
        per_wave.append(template.kernel_launch_count() - before)
    batch = [engine.poll(t) for t in tickets]
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    b_counts = variant_counts({"fused_mc_adapted": True}, "adaptive batch")
    service_adapt += b_counts["fused_mc_adapted"]
    b_means = np.concatenate([r.means for r in batch])
    b_se = np.concatenate([r.stderrs for r in batch])
    b_cover = float(np.mean(np.abs(b_means - a_exact) <= 2 * b_se))
    print(f"adaptive batch: {aspec.n_fn_total} integrands as 3 requests (targets "
          + ", ".join(f"{t:.3g}" for t in targets) + f"): {engine.stats.waves} waves, "
          f"launches per wave {per_wave}, {int(engine.obs.m['grid_refits'].value())} "
          f"refits, {engine.batcher.fallback_rounds} fallback rounds, "
          f"{batch_wall:.3f} s wall; 2-sigma coverage vs exact {b_cover:.4f}; "
          f"{service_adapt} adapted launches over step 18")
    engine.close()
    check(all(r is not None and np.all(r.stderrs <= t) for r, t in zip(batch, targets)),
          "adaptive batch: a request unfinished or above its target")
    check(engine.batcher.fallback_rounds == 0, "adaptive batch: chunked fallback rounds")
    check(all(n <= 3 for n in per_wave), "adaptive batch: more launches than buckets in a wave")
    laps.end(18)

    # -- 19. stratified sampling: the stratum-moments kernel and ZMCNormal ---
    import torch.nn.functional as F
    from repro_torch.core import stratified
    from repro_torch.core.normal import ZMCNormal
    from repro_torch.kernels.moments import ops as mops
    from repro_torch.kernels.moments import ref as mref
    gpeak, gpeak_exact = genz.gaussian_peak(1, NORMAL_DIM)
    gpeak = gpeak.to(device)

    def normal_fn(x):
        return gpeak.fn(x.reshape(1, -1, NORMAL_DIM), gpeak.params).reshape(x.shape[:-1])

    n0 = NORMAL_SPLITS ** NORMAL_DIM
    table = stratified.initial_grid(np.tile([[0.0, 1.0]], (NORMAL_DIM, 1)),
                                    NORMAL_SPLITS, n0, device=device)
    key = rng.fold_key(0, 0)
    slots = torch.arange(n0, device=device)
    u = rng.uniforms_for(*key, stratified.stratum_ids(slots, 0),
                         torch.arange(NORMAL_N_PER, device=device), NORMAL_DIM)
    lo, hi = table.boxes[:, None, :, 0], table.boxes[:, None, :, 1]
    vals = normal_fn(lo + u * (hi - lo))           # what eval_strata reduces
    del u
    vals = F.pad(vals, [0, 0, 0, -n0 % mops.R_BLK]).contiguous()

    def hold_moments(x, what):
        k1, k2 = mops.moments_cuda(x), mops.moments_cuda(x)
        torch.cuda.synchronize()
        check(sha256_of(k1) == sha256_of(k2), f"{what}: repeated launches differ")
        err = 0.0
        for label, w in (("plain", mops.moments_plain(x)), ("two-pass", mref.moments_ref(x))):
            d_count = float((k1[:, 0] - w[:, 0]).abs().max())
            d_mean = float((k1[:, 1] - w[:, 1]).abs().max())
            d_m2 = float(((k1[:, 2] - w[:, 2]).abs() / w[:, 2].abs().clamp(min=1e-30)).max())
            print(f"{what}: kernel vs {label}: count max|diff| {d_count:g}, mean "
                  f"{d_mean:.3g} (atol 1e-5), M2 relative {d_m2:.3g} (rtol 1e-4); "
                  f"repeat sha256 equal")
            check(d_count == 0 and d_mean <= 1e-5 and d_m2 <= 1e-4,
                  f"{what}: the kernel disagrees with the {label} version")
            err = max(err, d_mean, float((k1[:, 2] - w[:, 2]).abs().max()))
        return err

    def time_ms(fn, reps=20):
        """Device ms per call of ``fn``: the calls are queued behind a ~10 ms
        sleep kernel, so the host's launch overhead (tens of microseconds,
        as long as the kernel itself here) does not leave the card idle
        between them."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.01 * clock_hz))
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    mom_err = hold_moments(vals, f"stratum moments {tuple(vals.shape)}")
    mom = {"ms": time_ms(lambda: mops.moments_cuda(vals)),
           "plain_ms": time_ms(lambda: mops.moments_plain(vals), reps=3),
           "library_ms": time_ms(lambda: torch.var_mean(vals, dim=1, correction=0)),
           "bound_ms": (vals.numel() + 3 * vals.shape[0]) * 4 / HBM_BYTES_PER_S * 1e3}
    big = torch.randn(*BIG_MOMENTS, device=device, generator=torch.Generator(
        device=device).manual_seed(19)) * 3.0 + 1.0
    hold_moments(big, f"stratum moments {BIG_MOMENTS}")
    big_ms = time_ms(lambda: mops.moments_cuda(big))
    big_lib = time_ms(lambda: torch.var_mean(big, dim=1, correction=0))
    big_bound = (big.numel() + 3 * big.shape[0]) * 4 / HBM_BYTES_PER_S * 1e3
    for shape, ms, lib_ms, bound in ((tuple(vals.shape), mom["ms"], mom["library_ms"],
                                      mom["bound_ms"]),
                                     (BIG_MOMENTS, big_ms, big_lib, big_bound)):
        n_bytes = (shape[0] * shape[1] + 3 * shape[0]) * 4
        print(f"stratum moments {shape}: kernel {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} "
              f"GB/s), torch.var_mean {lib_ms:.4f} ms, HBM bound {bound:.4f} ms "
              f"(kernel at {100 * bound / ms:.1f}% of it); on {card}")
    print(f"stratum moments {tuple(vals.shape)}: plain {mom['plain_ms']:.3f} ms")
    del big
    # the path: eval_strata(use_kernel=True) against the plain reduction
    mops.reset_kernel_launch_count()
    m_k, v_k = stratified.eval_strata(normal_fn, table.boxes, slots, 0, NORMAL_N_PER,
                                      key, use_kernel=True)
    torch.cuda.synchronize()
    mom["launches"] = mops.kernel_launch_count()
    m_p, v_p = stratified.eval_strata(normal_fn, table.boxes, slots, 0, NORMAL_N_PER, key)
    d_mean = float((m_k - m_p).abs().max())
    # the plain path's variance is E[f^2] - E[f]^2 in f32, which loses about
    # 2^-23 E[f^2] to cancellation; the kernel's is two-pass
    d_var = float(((v_k - v_p).abs()
                   / (1e-3 * v_p + 1e-6 * (v_p + m_p * m_p))).max())
    print(f"eval_strata(use_kernel=True) on {n0} strata x {NORMAL_N_PER}: "
          f"{mom['launches']} stratum_moments launch; vs the plain path: mean "
          f"max|diff| {d_mean:.3g} (atol 1e-5), variance |diff| at most "
          f"{d_var:.3g} of 1e-3 var + 1e-6 E[f^2]")
    check(mom["launches"] == 1, "eval_strata(use_kernel=True) launched no kernel")
    check(d_mean <= 1e-5 and d_var <= 1.0, "eval_strata's kernel path disagrees")
    mom["max_abs_err"] = mom_err
    del vals
    t0 = time.perf_counter()
    nres = ZMCNormal(normal_fn, np.tile([[0.0, 1.0]], (NORMAL_DIM, 1)), seed=0,
                     device="cuda").evaluate(num_trials=NORMAL_TRIALS)
    torch.cuda.synchronize()
    n_wall = time.perf_counter() - t0
    n_dev = abs(nres.integral - float(gpeak_exact[0]))
    print(f"ZMCNormal on {gpeak.name} (dim {NORMAL_DIM}, splits {NORMAL_SPLITS}, "
          f"n_per_stratum {NORMAL_N_PER}, depth 8, k_split 32): {nres.integral:.7f} "
          f"vs exact {float(gpeak_exact[0]):.7f}, |diff| {n_dev:.3g} = "
          f"{n_dev / max(nres.trial_std, 1e-30):.2f} trial stds (trial std "
          f"{nres.trial_std:.3g}, in-run stderr {nres.stderr:.3g}); "
          f"{n_wall / NORMAL_TRIALS:.3f} s per trial")
    check(n_dev <= 4 * nres.trial_std, "ZMCNormal is off its exact value")
    laps.end(19)

    # -- 20. the multi-device path: a mesh of one NCCL rank, then four gloo ranks
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_mesh_for

    def est_digest(means, stderrs) -> str:
        return hashlib.sha256(np.ascontiguousarray(means).tobytes()
                              + np.ascontiguousarray(stderrs).tobytes()).hexdigest()

    # (a) world size 1 under NCCL, a (1, 1) mesh: the single-device bits
    with tempfile.TemporaryDirectory() as rv:
        dist.init_process_group("nccl", init_method=f"file://{rv}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh11 = make_mesh_for(device="cuda")
            for sampler, (m_ref, s_ref) in (("mc", main_est),
                                            ("sobol", (sres.means, sres.stderrs))):
                z = ZMCMultiFunctions(spec, n_samples=N_MAIN, seed=0, use_kernel=True,
                                      sampler=sampler, mesh=mesh11)
                template.reset_kernel_launch_count()
                t0 = time.perf_counter()
                r1 = z.evaluate(num_trials=TRIALS)
                torch.cuda.synchronize()
                w1 = (time.perf_counter() - t0) / TRIALS
                n1 = template.kernel_launch_count()
                same = est_digest(r1.means, r1.stderrs) == est_digest(m_ref, s_ref)
                print(f"mesh (1, 1), NCCL, {sampler}: evaluate(num_trials={TRIALS}) at "
                      f"N={N_MAIN}: {n1} kernel launches, {w1:.4f} s per trial (wall); "
                      f"means and stderrs sha256 {'equal' if same else 'DIFFER'} to "
                      f"the single-device run's (step {6 if sampler == 'mc' else 14})")
                check(n1 == plan.n_launches * TRIALS, f"mesh (1, 1) {sampler}: {n1} launches")
                check(same, f"mesh (1, 1) {sampler}: not the single-device bits")
                if sampler == "mc":
                    # steady state beside one device, in turns: one, mesh,
                    # mesh, one; 3 trials each
                    ws1_steady = {"one": [], "mesh": []}
                    for side, zz in (("one", zmc), ("mesh", z), ("mesh", z), ("one", zmc)):
                        t0 = time.perf_counter()
                        zz.evaluate(num_trials=3)
                        torch.cuda.synchronize()
                        ws1_steady[side].append((time.perf_counter() - t0) / 3)
            outs = [launch_bucket(template.fused_mc_cuda, b, N_MAIN, key)[0]
                    for b in plan.buckets]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                for o in outs:
                    collectives.psum_gather_rows(o, mesh11, ("data",), "model")
            torch.cuda.synchronize()
            ws1_coll = (time.perf_counter() - t0) * 1e3 / 20
        finally:
            dist.destroy_process_group()
    one_s, mesh_s = (sum(ws1_steady[k]) / 2 for k in ("one", "mesh"))
    print(f"mesh (1, 1), NCCL: steady state {1e3 * mesh_s:.3f} ms per trial against "
          f"{1e3 * one_s:.3f} on one device, in turns (one, mesh, mesh, one; 3 trials "
          f"each: one {', '.join(f'{1e3 * v:.3f}' for v in ws1_steady['one'])}, mesh "
          f"{', '.join(f'{1e3 * v:.3f}' for v in ws1_steady['mesh'])}): "
          f"{1e3 * (mesh_s - one_s):+.3f} ms per trial; the three gathers of one trial "
          f"alone {ws1_coll:.3f} ms; on {card}")

    # (b) four gloo ranks sharing this card (not scaling: one card's time is
    # split among them)
    t0 = time.perf_counter()
    ranks = multihost.spawn(mesh_rank, MESH_RANKS, device="cuda", backend="gloo",
                            timeout=600)
    print(f"{MESH_RANKS} gloo ranks on one card: {time.perf_counter() - t0:.1f} s "
          f"(process start, mesh setup and every check)")
    n_fam = len(spec.families)
    for rk in ranks:
        check(rk["fn_only_equal"] == {"mc": n_fam, "sobol": n_fam},
              f"rank {rk['rank']}: mesh (1, {MESH_RANKS}): per-function sums differ "
              f"from the single launch: {rk['fn_only_equal']}")
    print(f"mesh (1, {MESH_RANKS}), functions only: every family's sums sha256-equal to "
          f"the single-device launch on all {MESH_RANKS} ranks, MC and Sobol, N={N_MAIN}")
    for shape in ((MESH_RANKS, 1), (2, 2)):
        for sampler, (m_ref, s_ref) in (("mc", main_est), ("sobol", (sres.means, sres.stderrs))):
            got = [rk[(shape, sampler)] for rk in ranks]
            d_mean = max(float(np.max(np.abs(g["means"] - m_ref[0]) / s_ref[0])) for g in got)
            d_se = max(float(np.max(np.abs(g["stderrs"] - s_ref[0]) / s_ref[0])) for g in got)
            print(f"mesh {shape} {sampler}: raw sums at N={N_ODD} within "
                  f"{MESH_TOL[sampler]} of one device: {all(g['sums_ok'] for g in got)} "
                  f"(max|d s1| {max(g['max_abs'] for g in got):.4g}), n exact: "
                  f"{all(g['n_exact'] for g in got)}; estimates at N={N_MAIN} vs step "
                  f"{6 if sampler == 'mc' else 14}'s trial 0: max |d mean| {d_mean:.3g}, "
                  f"|d stderr| {d_se:.3g} standard errors (limit {EST_TOL})")
            check(all(g["sums_ok"] and g["n_exact"] for g in got),
                  f"mesh {shape} {sampler}: sums or n off")
            check(d_mean <= EST_TOL and d_se <= EST_TOL,
                  f"mesh {shape} {sampler}: estimates off the single device's")
            if shape == (2, 2):
                digests = {g["digest"] for g in got} | {g["repeat"] for g in got}
                print(f"mesh (2, 2) {sampler}: {len(digests)} distinct sha256 over "
                      f"{MESH_RANKS} ranks x 2 repeats")
                check(len(digests) == 1, f"mesh (2, 2) {sampler}: ranks or repeats differ")
    mesh_counts = ranks[0][((2, 2), "mc")]["counts"]
    print(f"mesh (2, 2) main path (evaluate at N={N_MAIN}, one trial), rank 0: kernel "
          f"launches by variant {mesh_counts}")
    for rk in ranks:
        check(rk[((2, 2), "mc")]["counts"]["fused_mc"] == plan.n_launches,
              f"rank {rk['rank']}: the (2, 2) evaluate did not launch fused_mc per bucket")
    check(all(rk["rounds_same"] == ROUNDS for rk in ranks),
          "a sharded R-round launch differs from its single-round launches")
    print(f"mesh (2, 2): an R={ROUNDS} sharded rounds launch sha256-equal to {ROUNDS} "
          f"single-round sharded launches on every rank")
    full_m = np.concatenate([r.means for r in full])
    full_s = np.concatenate([r.stderrs for r in full])
    for rk in ranks:
        sv = rk["service"]
        d_mean = float(np.max(np.abs(sv["means"] - full_m) / full_s))
        d_se = float(np.max(np.abs(sv["stderrs"] - full_s) / full_s))
        check(d_mean <= EST_TOL and d_se <= EST_TOL and sv["fallback"] == 0
              and sv["launches"] <= plan.n_launches * sv["waves"],
              f"rank {rk['rank']}: service config 2 on (2, 2) off: {d_mean}, {d_se}, {sv}")
    sv = ranks[0]["service"]
    print(f"service config 2 on (2, 2): {sv['waves']} waves, {sv['launches']} launches "
          f"per rank, {sv['fallback']} fallback rounds; estimates within {EST_TOL} "
          f"standard errors of step 12's on every rank")
    for rk in ranks:
        nm = rk["normal"]
        check(abs(nm["integral"] - nres.integral) <= 4 * nres.trial_std
              and nm["moments_launches"] > 0,
              f"rank {rk['rank']}: ZMCNormal on (2, 2) off: {nm}")
    nm = ranks[0]["normal"]
    print(f"ZMCNormal dim {NORMAL_DIM} on (2, 2) (samples over 4 ranks, moments kernel "
          f"per rank, {nm['moments_launches']} launches on rank 0): {nm['integral']:.7f} "
          f"vs step 19's {nres.integral:.7f} (4 trial stds: {4 * nres.trial_std:.3g}); "
          f"{nm['s_per_trial']:.3f} s per trial")
    for rk in ranks:
        c = rk["compressed"]
        check(c["err"] <= c["bound"] and c["on_card"],
              f"rank {rk['rank']}: compressed_psum off its bound: {c}")
    print(f"compressed_psum over data (2 shards): max|err| "
          f"{max(rk['compressed']['err'] for rk in ranks):.3g} within its int8 bound "
          f"{ranks[0]['compressed']['bound']:.3g}")
    for rk in ranks:
        sh = rk["shard"]
        print(f"rank {rk['rank']}: its shard of one Fig.-1 trial ({sh['n_local']} samples, "
              f"{sh['values']:.4g} values): kernel {sh['ms']:.3f} ms (the ranks taking "
              f"turns on the card), collectives {sh['collectives_ms']:.3f} ms per trial "
              f"(3 gathers, gloo through the host, the ranks together); max|kernel - "
              f"plain| {sh['max_abs_err']:.4g} at N={N_CHECK}")
    sh = ranks[0]["shard"]
    shard_bound = max(op_bound_ms(sh["draws"], sh["values"], n_sm, clock_hz).values())
    print(f"four ranks share one card: these times split one card's work, they are not "
          f"scaling; rank 0's shard kernel {sh['ms']:.3f} ms against its bound "
          f"{shard_bound:.3f} ms, plain {sh['plain_ms']:.1f} ms; on {card}")
    sharded = dict(launches=mesh_counts["fused_mc"], max_abs_err=max(
        rk["shard"]["max_abs_err"] for rk in ranks), ms=sh["ms"],
        plain_ms=sh["plain_ms"], bound_ms=shard_bound)
    laps.end(20)

    # -- 21. a state dir on the (2, 2) mesh, resumed; the invariant checker -----
    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis import contracts as analysis_contracts
    from repro_torch.analysis.streams import audit_state_dir
    from repro_torch.kernels import registry
    sv20 = ranks[0]["service"]
    whole = est_digest(sv20["means"], sv20["stderrs"])
    mesh_state = tempfile.mkdtemp(prefix="zmc_mesh_state_")
    lease_path = os.path.join(mesh_state, "lease.json")
    # (a) configuration 2 with a state dir, abandoned after its first wave by
    # four ranks, resumed by four new ones, then replayed warm
    # (no device: spawn's default is the card)
    first = multihost.spawn(state_rank, MESH_RANKS, mesh_state, 1, backend="gloo",
                            timeout=600)
    with open(lease_path, encoding="utf-8") as f:
        left = json.load(f)["pid"]
    # the journal as the abandoned ranks left it, audited in (b)
    shutil.copytree(mesh_state, f"{mesh_state}_abandoned")
    second = multihost.spawn(state_rank, MESH_RANKS, mesh_state, None, device="cuda",
                             backend="gloo", timeout=600)
    ab, rs, rp = first[0]["abandoned"], second[0]["resumed"], second[0]["replay"]
    for group, run in ((first, "abandoned"), (second, "resumed"), (second, "replay")):
        for rk in group:
            got = rk[run]
            check(got["kernel_launches"] == got["dispatches"] and got["fallback"] == 0,
                  f"rank {rk['rank']}, {run}: {got['dispatches']} dispatches, "
                  f"{got['kernel_launches']} CUDA kernel launches, {got['fallback']} "
                  "fallback rounds")
            check(rk["lease_pids"] == {group[0]["pid"]},
                  f"rank {rk['rank']}, {run}: lease.json named pids {rk['lease_pids']}, "
                  f"rank 0 is {group[0]['pid']}")
            if run != "abandoned":
                check(est_digest(got["means"], got["stderrs"]) == whole,
                      f"rank {rk['rank']}, {run}: served estimates differ from step 20's")
            if run == "resumed":
                check(got["counts"]["fused_mc_rounds"] > 0,
                      f"rank {rk['rank']}: the resumed run never launched fused_mc_rounds")
    check(left == first[0]["pid"], f"the abandoned dir's lease names pid {left}")
    check(not os.path.exists(lease_path), "the resumed ranks' close() left the lease")
    check(len(ab["wave_s"]) == 1 and len(rs["wave_s"]) == sv20["waves"] - 1
          and ab["kernel_launches"] + rs["kernel_launches"] == sv20["launches"],
          f"abandoned {ab['kernel_launches']} + resumed {rs['kernel_launches']} launches "
          f"over {len(ab['wave_s'])} + {len(rs['wave_s'])} waves, step 20 "
          f"{sv20['launches']} over {sv20['waves']}")
    check(rp["dispatches"] == 0 and rp["hits"] == len(spec.families),
          f"warm replay: {rp['dispatches']} launches, {rp['hits']} pure hits")
    print(f"service config 2 on (2, 2) with a state dir (rank 0 owns it): abandoned "
          f"after wave 1 ({ab['kernel_launches']} launches), resumed by 4 new ranks "
          f"({rs['kernel_launches']} launches over {len(rs['wave_s'])} wave(s), "
          f"{rs['counts']}), served estimates sha256-equal to step 20's run on every "
          f"rank ({whole[:16]}); warm replay {rp['dispatches']} launches, "
          f"{rp['hits']} pure hits; lease.json only ever named rank 0's pid")
    def ms(xs):
        return [round(1e3 * x, 3) for x in xs]

    turns = second[0]["turns"]
    mean_wave = {disk: float(np.mean([w for d, ws, _, _ in turns if d == disk for w in ws]))
                 for disk in (False, True)}
    print("mesh (2, 2) config 2, warm ranks in turns (none, dir, dir, none; rank 0): "
          + "; ".join(f"{'state dir' if d else 'no state dir'} waves {ms(ws)} ms"
                      + (f" (store operations {ms(st)} ms)" if d else "")
                      + f", submit {1e3 * sub:.1f} ms" for d, ws, st, sub in turns)
          + f"; mean wave {1e3 * mean_wave[True]:.3f} ms with the state dir against "
          f"{1e3 * mean_wave[False]:.3f} without: "
          f"{1e3 * (mean_wave[True] - mean_wave[False]):+.3f} ms per wave; on {card}")
    print(f"mesh (2, 2) config 2 wall per wave (ms, rank 0): step 20 without a state "
          f"dir {ms(sv20['wave_s'])}; with one: abandoned run's wave 1 {ms(ab['wave_s'])}, "
          f"resumed run's wave 2 {ms(rs['wave_s'])}; on {card}")
    for label, group, run in (("abandoned wave 1", first, "abandoned"),
                              ("resumed wave 2", second, "resumed")):
        print(f"  {label}: per rank, time in the store's operations (rank 0's write, "
              f"then the broadcast) {[ms(rk[run]['store_s']) for rk in group]} ms; rank "
              f"0's deposit span {ms(group[0][run]['deposit_s'])} ms, of which "
              f"wal_commit {ms(group[0][run]['wal_s'])} ms")
    print(f"  resume (rank 0): open and recover {1e3 * rs['open_s']:.3f} ms, submit "
          f"{1e3 * rs['submit_s']:.3f} ms, its wave {ms(rs['wave_s'])} ms, close with "
          f"the snapshot {1e3 * rs['close_s']:.3f} ms; the state dir's file system: "
          f"fsync of a 100 KB append {ms(second[0]['fsync_s'])} ms; one outcome "
          f"broadcast alone {ms([rk['broadcast_s'] for rk in second])} ms per rank; "
          f"the abandoned run "
          f"opened in {1e3 * ab['open_s']:.3f} ms and submitted in "
          f"{1e3 * ab['submit_s']:.3f} ms")
    # (b) every state dir this script wrote, through the port's auditor
    for label, path in (("step 11", state),
                        ("step 18 uninterrupted", os.path.join(work, "uninterrupted")),
                        ("step 18 abandoned and resumed", os.path.join(work, "interrupted")),
                        ("step 21 abandoned after wave 1", f"{mesh_state}_abandoned"),
                        ("step 21", mesh_state),
                        ("step 21 warm turn 1", f"{mesh_state}_warm1"),
                        ("step 21 warm turn 2", f"{mesh_state}_warm2")):
        t0 = time.perf_counter()
        report = audit_state_dir(path)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"audit ({label}): {report.summary()}; {ms:.3f} ms")
        check(report.ok and report.streams > 0, f"audit ({label}): {report.violations}")
    # (c) the lint and every registered form's contracts
    t0 = time.perf_counter()
    rc = analysis_cli.main([])
    secs = time.perf_counter() - t0
    forms = registry.forms()
    combos = sum(len(analysis_contracts._combos(f)) for f in forms)
    print(f"python -m repro_torch.analysis: exit {rc}; lint of src/repro_torch and "
          f"{len(forms)} forms' contracts over {combos} capability combinations in "
          f"{secs:.3f} s")
    check(rc == 0, "the invariant checker found violations")
    for path in (state, work, mesh_state, f"{mesh_state}_abandoned",
                 f"{mesh_state}_warm1", f"{mesh_state}_warm2"):
        shutil.rmtree(path, ignore_errors=True)
    laps.end(21)

    # -- 22. the LM serving path at full width and depth ---------------------------
    # (steps 22-24 serve: the parameters are trainable, and no graph is recorded)
    with torch.no_grad():
        lm_serving(card)
    laps.end(22)

    # -- 23. the LM serving path of the moe family (MLA and MoE) ------------------
    with torch.no_grad():
        lm_moe_serving(card)
    laps.end(23)

    # -- 24. the LM serving path of the ssm and hybrid families (Mamba-2) --------
    with torch.no_grad():
        lm_ssm_serving(card)
    laps.end(24)

    # -- 25. the LM training path at full width and depth -------------------------
    lm_training(card)
    laps.end(25)

    # -- 26. the LM multi-device path: four gloo ranks on the card ---------------
    refs = tempfile.mkdtemp(prefix="lm_refs_")         # step 26's one device, for step 28
    step26_ms, sp = lm_mesh(card, refs)
    laps.end(26)

    # -- 27. qwen2.5-32b served tensor parallel on four gloo ranks ----------------
    lm_tp(card)
    laps.end(27)

    # -- 28. context parallelism on eight gloo ranks, SP on four --------------------
    lm_cp_sp(card, step26_ms, sp)
    shutil.rmtree(refs, ignore_errors=True)
    laps.end(28)

    # -- 29. the example scripts on the card: users' own integrands ---------------
    examples_on_card(card)
    laps.end(29)

    # -- 30. LM training of the moe, hybrid and encoder families, v3's recipe -------
    lm_training_families(card)
    laps.end(30)
    print("step seconds: " + json.dumps(laps.seconds))

    entry = dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_mc.cu",
                 bound_by="operations", library_ms=None)
    print(json.dumps({"kernels": [
        dict(entry, name="fused_mc", replaces="src/repro/kernels/template.py:425",
             launches=main_counts["fused_mc"], max_abs_err=max_err,
             ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms),
        dict(entry, name="fused_mc_rounds",
             replaces="src/repro/kernels/template.py:457",
             launches=service_counts["fused_mc_rounds"], max_abs_err=rounds_err,
             ms=wave_ms, plain_ms=wave_plain_ms, bound_ms=wave_bound),
        dict(entry, name="fused_mc_compactified",
             replaces="src/repro/kernels/template.py:189",
             launches=service_counts["fused_mc_compactified"],
             max_abs_err=compact_err, ms=compact_ms, plain_ms=compact_plain_ms,
             bound_ms=compact_bound),
        dict(entry, name="fused_mc_sobol_compactified",
             replaces="src/repro/kernels/template.py:189", **compact_sobol),
        dict(entry, name="fused_mc_sobol",
             replaces="src/repro/kernels/template.py:172",
             launches=sobol_counts["fused_mc_sobol"], max_abs_err=sobol_err,
             ms=sobol_ms, plain_ms=sobol_plain_ms, bound_ms=sobol_bound),
        dict(entry, name="fused_mc_swept",
             replaces="src/repro/kernels/template.py:231", **swept["mc"]),
        dict(entry, name="fused_mc_sobol_swept",
             replaces="src/repro/kernels/template.py:231", **swept["sobol"]),
        *(dict(entry, name=name, replaces="src/repro/kernels/template.py:318",
               **{k: v for k, v in adapted[s].items() if k != "res"})
          for name, s in (("fused_mc_adapted", "mc"), ("fused_mc_sobol_adapted", "sobol"))),
        dict(entry, name="fused_mc_sharded",
             replaces="src/repro/kernels/template.py:425", **sharded),
        dict(name="stratum_moments", route="cuda",
             source="src/repro_torch/kernels/csrc/moments.cu",
             replaces="src/repro/kernels/moments/kernel.py:43", bound_by="bytes", **mom),
    ]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
