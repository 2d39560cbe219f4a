#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase exits non-zero; there is no CPU
fallback, and a missing GPU is a failure):

1. card: the GPU's name and power limit (nvidia-smi); build the CUDA kernels
   from src/repro_torch/csrc with nvcc and print the build seconds; count
   instructions in the built library's SASS (cuobjdump): HGMMA/HMMA in the
   bf16 attention kernels (HGMMA in the D = 112 and D = 80 instances of the
   forward and of both backward passes), IGMMA/IMMA and no
   IDP4A in assoc_matmul, LDGSTS
   (16-byte cp.async) in the sparse kernels, BMMA (1-bit tensor-core
   products) in the Hamming search and top-k kernels and BGMMA (1-bit
   warpgroup products) in the top-1, 16-byte loads in the majority kernel,
   no SIMT top-1 (retired), and the SIMT attention kernel built for f32 only;
2. kernels: the launch floor (a one-element add_); each of the nine
   kernels against its plain PyTorch version on
   the card, at the main path's shapes and at one tall shape (102,400 classes
   over 64 cores, d = 2048, batch 4096); the fused top-1 at every main-path
   shape (the OTA serves, the flat serve at C = 102,400, multi-centroid
   predict and bank serve, Table I at M = 11) and at ragged, tie (all rows
   equal, equal rows across a class split's edge), c_real inside the last
   split, B off its tile, W = 5, 76 and 400 shapes; the majority also on
   bytes 0-255 at M = 300, odd N and a base one byte off alignment;
   assoc_matmul also at a ragged shape
   (K = 500, a partial class tile) and on bytes 0-255; the fused top-k and
   the per-bank search also at ragged, tie (across the kernel's 128-row
   tiles and across the top-k's class splits) and limit shapes, k = 1
   against the top-1 kernel (also at the flat serve's shape), c_real inside
   the last split, k past a split's
   classes (W = 64 and 5), B and C off the search's tiles and W = 76;
   `hamming_search` also at the Table I trials' shape; the two sparse
   kernels at ragged, tie and empty-query shapes, full lists at the serve
   shape, indices on segment and row edges, one class past a 128-class
   tile, and d = 2^21 -- bit-exact; the attention forward at
   the LM prefill's shape (B = 8, S = 1024, 32 heads over 4, D = 64, causal,
   bf16), gemma3-1b's layer shape (4 heads over 1, D = 256, window 512 and
   global), non-causal, ragged, a prefill chunk (q_offset 512), f32,
   deepseek-coder-33b's layer shape (56 heads over 8, D = 128), D = 16 and
   32, rows that see no key (q_offset -64), Mixtral-8x22B's layer (48 heads
   over 8, D = 128, window 4096) at B = 8 x 1024 and B = 1 x 8192,
   Kimi-K2's (64 heads over 8, D = 112) and Zamba2-2.7B's (32 heads over
   32, D = 80) in bf16 and f32 -- within atol = rtol = 2e-2 in bf16 and
   1e-5 in f32; each with the kernel's median
   device time (CUDA-graph replay) and eager call time, the plain version's
   time, one PyTorch library call's where one computes the same function
   (for the Hamming searches also one bf16 `torch.bmm` on the +-1
   expansions), and the bound (least time the card could take; the Hamming
   kernels' products counted as 2*G*B*c*32W operations at the 1-bit
   tensor-core rate, B1_OPS_PER_S);
3. precharacterization: the EM channel + exhaustive OTA phase search at
   3 TX / 64 RX / 7 dB, avg BER 0.0100 +- 1e-4;
4. OTA serve at the paper's configuration (6400 classes, d = 512, M = 3,
   64 cores, batch 256): 8 calls in each of the four bsc modes
   (baseline/permuted x unpacked/packed) and ideal baseline unpacked/packed;
   packed == unpacked on the same seeds, ideal == the noise-free reference
   (predictions and maxsim), and the launch counters show which kernels
   each serve ran;
5. wired serve, unpacked and packed, with the same checks;
6. the bsc tier alone at the serve shape: every core's flip rate lies within
   5 sigma of its BER, and the packed draw equals the unpacked one;
7. Table I at the paper's task (C = 100, d = 512, 2000 trials): M in
   (1, 3, 5, 7, 9, 11) x baseline/permuted x ideal/wireless (the average
   BER of phase 3) x unpacked/packed, 48 calls of `classifier.run_trials`
   (`run_accuracy` is its mean); packed == unpacked trial for trial, M = 1
   cells 1.0, the ideal baseline M = 3 cell within 5 sigma of 0.9702;
8. sparse trials at d = 2^20, density 0.001, k_max = 2048 (M in (1, 3),
   ideal and bsc), every run's search held against a dense oracle on every
   25th trial, and at d = 8192 (density 0.008, k_max 131, ideal) the sparse,
   packed and unpacked searches equal, distance for distance;
9. the sparse serve at d = 2^20, k_max = 2048 over the paper's 6400 classes,
   64 cores, M = 3, batch 256: ideal and bsc calls, the ideal answers held
   against a dense oracle, the psum wire and representation="auto" against
   index_ag, the d = 8192 sparse serve against the packed one, and the bsc
   drop and insertion rates per core within 5 sigma;
10. coarse-to-fine and multi-centroid: the flat and coarse serves at the C
   sweep's gate row (102,400 classes, d = 2048, 8 cores, batch 512, bsc at
   BER 0.02, groups of 8, 8 kept), 8 calls each, packed and unpacked:
   0 predictions differ coarse vs flat, packed == unpacked; the screen's
   recall against full distances (`hamming_search_banked`); keep == n_grp
   at C = 1024 == flat in pred and maxsim; `train_multicentroid` on the
   6400-class d = 512 codebook (k_c = 4), `multicentroid_predict` right on
   every noisy prototype at BER 0.0 and 0.1, and the 25,600-row bank served
   flat and coarse over 64 cores, centroid rows and classes equal;
11. the LM serve: TinyLlama-1.1B at its published width and depth (22
   layers, d = 2048, bf16, 1.1 B parameters drawn from the seed), batch 8 x
   prompt 1024 x 32 new tokens, greedy, through `Engine.generate`: 22
   attention launches a generate and no other kernel, time to first token,
   decode ms per token, tokens/s; each layer's attention on its own inputs
   against f64 (kernel no further off than its plain twin); and, with the
   attention projections at fan-in over their contraction, f32 greedy
   tokens of kernel and twin identical (last logits within 1e-3),
   decode(prefill(x), t) against prefill(x ‖ t) within 5e-3, bf16 last
   logits within LM_BF16_LOGIT_BOUND (see `phase_lm`); bf16 `torch.matmul` at
   the projection shapes identical with the reduced-precision reduction
   flag on and off;
12. the physical tier and living channels at the paper's configuration: the
   symbol serve, 8 calls in each of baseline/permuted x unpacked/packed,
   packed == unpacked and every call == a plain re-derivation of its physics
   (combo, constellation lookup, the same noise, `awgn_decide`, a dense
   search over every core's shard), with the decode's own time; the
   empirical flip rate of all 64 RX at d = 2^16 within 5 sigma + 5e-4 of
   the per-symbol analytic BER; the Table I workload on the symbol tier
   (C = 100, 1000 trials, re-characterized per M: M = 1 accuracy 1.0, M = 3
   symbol within 5 binomial sigma of bsc, packed == unpacked); bitplane
   noise (flip rates within 5 sigma of round(ber*2^16)/2^16, the comparator
   against a per-bit reference, serve time beside exact noise); the M-drop
   (m_active = 1 unpacked, packed and sparse == `serve_reference`; the
   symbol tier refuses it); StaticProcess serves == process-free serves,
   quarantine, a PhaseDriftProcess serve's time, and the closed loop (open
   drop >= 3 points, closed gap <= 1, re-fits > 0);
13. multi-tenant serving (the slot ring, the scheduler, the tenant registry,
   the multi-tenant OTA serve), every tenant at the paper's configuration:
   (a) the reference serving bench's trace (512 requests of 4 trials, 4
   tenants in the order of its seeded Poisson race, 16 slots, all queued at
   t = 0) in three modes (baseline packed and unpacked, permuted packed) on
   phase 3's state; (b) the paper's batch of 256 trials, 64 requests over 8
   tenants and 8 slots, packed, on bsc and on the symbol tier, then the
   tenant lifecycle (evict a tenant and onboard a new one into its row,
   evict another and re-onboard the first into that row: its answers
   unchanged, the new tenant's equal its standalone serves); (c) the
   adaptive engine at the drift benchmark's serving point (16 RX, C = 64,
   symbol tier, PhaseDriftProcess, 4 slots, 32 requests). Every completion
   equals a standalone `make_ota_serve` of its request on a generator
   seeded alike, in pred and maxsim; (a) takes 32 steps; every step
   launches one search kernel and nothing else; under StaticProcess the
   adaptive engine equals `HDCEngine`. Reported: continuous and static
   (one standalone serve a request) trials/s and their ratio, p50/p95
   latency, ms a step, the drifting run's trials/s and controller actions;
14. fault tolerance (`repro_torch.faults`, the fault-aware serves, the
   fault controller and engine): (a) the chaos benchmark's pinned
   scenario, the serving_faults row of BENCH_BASELINE.json (16 RX, C = 64,
   d = 512, M = 3, permuted packed psum bsc at BER 0.01, 2 dead cores and
   1% stuck cells, 8 batches of 64 trials, seed 0): the healthy
   fault-aware serve == the plain serve, the unaware serve drops at least
   min_unaware_drop_pts and the aware one stays within max_aware_gap_pts of
   fault-free (the row's own bounds), the degradation curve over 0-8 dead
   cores, the stuck sweep and the fault-tolerant engine (4 slots, 32
   requests, every completion == its standalone fault-aware serve); (b) the
   paper's configuration on phase 3's state: the healthy fault-aware serve
   == the fault-free serve in pred and maxsim in the four bsc modes, ideal
   packed, the four symbol modes, one coarse packed serve and under
   StaticProcess, each with both serves' ms; the stuck mask and the
   dead-core zeroing + failover gather alone; vote erasure of TXs 1 and 2
   == the m_active = 1 serve; 8 of 64 cores dead + 1% stuck cells, aware
   >= unaware in the four bsc modes; (c) `FaultTolerantHDCEngine` on phase
   13 (b)'s trace with those faults failed over: every completion == its
   standalone fault-aware serve, one search launch a step, trials/s and ms
   a step beside `AdaptiveHDCEngine`'s, then a short `WearoutFaults` run
   (dead cores and hit rate per step, reported);
15. continuous LM serving (`ContinuousEngine` + `Scheduler`) at
   TinyLlama-1.1B's published width and depth, weights from the seed: (a)
   the reference serving bench's trace (24 requests of 16/32/64 tokens
   shuffled by seed 0, 4 slots, 16 new, greedy, all queued at t = 0) in
   bf16 beside static B = 1 generates: tokens/s of both and their ratio,
   p50/p95 latency, decode steps, ms a step, token agreement (reported);
   (b) the same trace in f32 with the attention projections at fan-in over
   their contraction: every completion == its static generate token for
   token (on a difference the static run's top-2 margin there is printed
   first) and the first step's logits within 1e-3 of the static decode's;
   (c) chunked admission in f32 (6 requests of 256/640/1024 tokens, 2
   slots, chunks of 256 on the attention kernel's q_offset): every
   completion == its static generate (one-shot prefill), the chunk
   signatures exact, the 256-token prompts prefilled whole; then bf16 with
   and without chunks: the longest host-clock gap between decode steps
   while a 1024-token prompt admits. Every scheduler run launches
   flash_attention_fwd 22 times a whole-prompt admission or chunk and
   nothing else, none in a decode step;
16. training at TinyLlama-1.1B's published width and depth (bf16 parameters
   from the seed, remat on, batch 8 x 1024 of `SyntheticLM`): (a) the
   attention backward kernel against its plain twin at the training shape,
   gemma3-1b's layer (windowed and global), deepseek-coder-33b's, D = 16
   and 32, non-causal, ragged, a chunk's q_offset, f32 at two small shapes,
   rows that see no key, Kimi-K2's layer (D = 112) and Zamba2-2.7B's shared
   block (D = 80) at B 4 x 1024, Mixtral-8x22B's layer at B 1 x 8192 past
   its window of 4096, a D = 112 chunk over a cache prefix and f32 at
   D = 80 and 112 (the forward's lse held to the twin's too): f32
   within FLASH_F32_TOL, bf16 no further off f64 than FLASH_BF16_VS_TWIN
   times the twin and within a bf16 ulp of the twin in the kernel's own
   arithmetic (P and dS as bf16 hi + lo), two launches at the training
   shape bit-identical, with the kernel's, the twin's and SDPA's backward
   times and the bound; (b) AdamW (`TRAIN`): 5 steps at the reference's
   own init, reported (its gradient norm ~1e15 leaves nothing to learn),
   then 15 steps with the attention projections at fan-in over their
   contraction, as phases 11 and 15 gate: the loss down by 0.5, 44 forward
   and 22 backward attention launches a step and no other kernel, every
   layer's backward kernel held to the twin on the first step's own
   inputs, ms a step, tokens/s, peak memory, the model-FLOPs share of the
   bf16 peak; (c) 10 sign_majority steps at OTA BER 0.01 on that draw
   (`SIGN`): losses finite, the flip rate within 5 sigma; (d) in a child
   process with deterministic algorithms, a Trainer that fails at step 6
   and resumes from its step-5 checkpoint == an uninterrupted one, bit for
   bit (`RESUME`);
17. the scale-out serve across ranks (`launch.mesh.spawn`, gloo; every
   rank a process on the one card, the port's `mesh=` builders on its
   shard, `shard_inputs`): at the paper's configuration on (data, model)
   grids of 1x2, 1x4 and 2x4 ranks, the four modes x psum, psum_packed and
   rs_ag on the ideal channel == the one-rank serve of the same inputs ==
   `serve_reference` (plain PyTorch) on the card (pred and maxsim); the bsc
   masks and the symbol tier's draws replayed by core index
   (``bsc_replay`` in the four modes x three collectives, ``symbol_replay``
   on psum) == the one-rank serve bit for bit; on bsc at a per-core BER
   ramp (MR_HOT_BER), every model rank of a data row drawing over the
   global cores on that row's generator and keeping its own, the three
   collectives equal bit for bit and, with the hit rate at most 0.95, on
   1x2 and 1x4 the real bsc and symbol serves == the one-rank serve bit for
   bit (the draws are mesh-layout invariant), on 2x4 (each data row its own
   generator) the hit rate within 3 binomial sigmas (of the difference) of
   the one-rank serve's; the symbol tier (psum) packed == unpacked; on 1x4
   also phase 10's flat packed serve at
   C = 102,400 (25,600 classes a rank) with each collective and its coarse
   screen (held to the one-rank serve on the plain top-k twin), the wired
   serve and the sparse serve at d = 8192 (index_ag and the dense
   psum_packed wire) == one rank == `serve_reference`; on 2x4 also the
   one-shot training == one rank == the plain one-hot class sums and, on
   EXPERIMENTS.md:10-19's 2x4 cell (C = 4096, d = 1024, 8 cores, B = 128),
   the bytes every rank's collectives move (operand + result): 133,632
   (psum), 55,296 (psum_packed), 53,760 (rs_ag packed); on a 4-rank model
   axis the packed lanes whose bit 31 is set sum as uint32. Each case's ms
   a call on rank 0 (host clock, median of MR_TIMED; the replayed cases
   untimed) beside the one-rank serve's, with the backend named: gloo
   through host memory, which says nothing of NVLink.
   A rank that fails or outlives MR_TIMEOUT fails the phase;
18. living channels, faults and the HDC engines across ranks (the same
   gloo ranks on the one card; each model rank holds its cores' rows of
   the process and fault state, `phy.shard_pstate` and
   `faults.shard_fstate`), at the paper's configuration on phase 3's state:
   (a) on 1x2, 1x4 and 2x4 a PhaseDriftProcess serve on the replayed
   symbol draws (unpacked) and on the replayed bsc masks (packed), psum,
   LR_STEPS steps: every rank's process-state rows == the one-rank
   rollout's bit for bit (on both data replicas of 2x4), pred and maxsim
   == the one-rank serve's; (b) on 1x4 and 2x4 phase 14 (b)'s scenario on
   the replayed bsc masks in the four modes: the healthy fault-aware serve
   == the fault-free serve on ranks (psum), 8 of 64 cores dead (two on each
   model rank of 1x4, LR_DEAD), failed over in shards of 16, + 1% stuck
   cells (psum_packed), the votes of TXs 1 and 2 erased (rs_ag), each ==
   the one-rank fault serve, one coarse packed fault serve on 1x4, and a
   WearoutFaults rollout whose rows == the one-rank rollout's; (c) on 1x4
   the engines: HDCEngine on phase 13 (b)'s trace and
   FaultTolerantHDCEngine under (b)'s dead cores and stuck cells, every
   completion == its rank-standalone serve on `rank_generator` and == the
   one-rank engine's (one data row: the request's own generator), the four
   ranks' completion lists identical, rank 0's ms a step and trials/s
   beside the one-rank engine's; AdaptiveHDCEngine at phase 13 (c)'s drift
   point on replayed symbol draws, its controller trace and completions ==
   the one-rank engine's; a FaultTolerantHDCEngine on a fading channel
   (LR_FADE, WearoutFaults, bsc_replay) whose trace (re-fits, quarantines,
   the fleet-mode drop, remaps) == the one-rank engine's. Each engine
   launches one search kernel a step and nothing else. A rank that fails
   or outlives LR_TIMEOUT fails the phase;
19. training across ranks (gloo ranks sharing the card; NCCL refuses two
   ranks on one device): TinyLlama-1.1B at its published width and depth
   (bf16, remat) from phase 16's conditioned draw, B 4 x S 1024 of the
   synthetic stream, TR["steps"] steps: AdamW on 1x2 (the Megatron split:
   16 heads, 2 kv heads, 2816 of d_ff and 16,000 of the vocabulary a rank,
   the vocabulary-split loss), AdamW on 2x1 (data parallel, ZeRO-1 moments)
   and signum at the OTA BER 0.01 on 2x1 (the int8 sign vote), and AdamW
   on 2x2 cut to 2 layers: every rank reports the same loss; every AdamW
   step's loss within TR["loss_rtol"] and its step-1 gradient norm within
   TR["gnorm_rtol"] of one rank's AdamW steps on the same parameters and
   batches (this process), signum's step-1 loss within TR["loss_rtol"] of
   it too (a vote over the data ranks' halves is not one rank's step), the
   last loss below the first,
   every rank's parameter + optimizer bytes == the bytes of its resolved
   shards (`sharding.local_bytes`), and every step on every rank launches
   the attention forward twice a layer and the backward once, and nothing
   else of the table; rank 0's ms a step and tokens/s, each rank's peak
   memory and wire bytes a step. A rank that fails or outlives TR_TIMEOUT
   fails the phase;
20. the MoE decoder at its published widths, depth cut to fit the card
   (MOE_RUNS; bf16 weights drawn from the seed, large leaves slice by
   slice): Mixtral-8x22B at 12 of 56 layers, then Kimi-K2 at 1 of 61, one
   model on the card at a time, each on phase 11's trace through
   `Engine.generate`: the layer count of attention launches a generate
   and no other kernel (Kimi's at D = 112), two generates bit-identical,
   time to first token, decode ms a token, tokens/s, peak memory; in a
   recorded prefill every (group, expert) keeps min(load, C) of its
   assignments (the drop share at capacity 1.25 printed), every layer's
   attention on its own inputs no further off f64 than FLASH_BF16_VS_TWIN
   times its twin, and layer 0's MoE block on its own input against its
   f64 evaluation expert by expert: every assignment whose f64 margin
   exceeds MOE_MARGIN routed alike, max |diff| over the tokens routed
   alike within MOE_BF16_BOUND; where a prefill's device time goes (CUDA
   events on layer 0's parts: attention, routing, dispatch, expert GEMMs,
   combine, the rest). Between the two, Mixtral at 2 layers in f32 with
   nothing dropped (MOE_RING): a 4352-token prompt into the 4096-slot
   ring, 16 decodes through it, each within 5e-3 of the whole sequence's
   prefill at its position;
21. the SSM and hybrid decoders at their published widths and depths
   (SSM_RUNS: Falcon-Mamba-7B, 64 Mamba-1 layers, and Zamba2-2.7B, 54
   Mamba-2 layers in 9 groups with one shared attention block at D = 80;
   bf16 weights from the seed, one model on the card at a time), each on
   phase 11's trace through `Engine.generate`: time to first token, decode
   ms a token, tokens/s, peak memory; the attention kernel launched once a
   group in Zamba2's prefill (9) and in no decode step, nothing launched
   by Falcon-Mamba; two generates bit-identical; layer 0's block in bf16
   against its f64 evaluation (the sequential recurrence, `selective_scan_ref`
   / `ssd_ref`, in f64) within SSM_BF16_REL of max |f64|, and the chunked
   scan in f32 on the layer's own inputs against that recurrence within
   SSM_SCAN_REL (final state and y - D u); CUDA-event times of layer 0's
   parts (in_proj, conv, x_proj/dt, the scan, gate and out_proj; Zamba2's
   shared attention and MLP) and the scans' share of the first token. Then
   each at SSM_SMALL's 2 layers in f32 (Zamba2 in 2 groups of 1, its shared
   attention at fan-in over its contraction): decode(prefill(x), t) within
   5e-3 of prefill(x ‖ t), the ContinuousEngine's completions == static
   B = 1 generates (slots reused), and no aten op given a CPU tensor in a
   prefill and a decode step;
22. the enc-dec and VLM decoders at their published widths and depths
   (XD_RUNS: Whisper-tiny, 4 + 4 layers, B 32 clips of 1500 stub frames,
   32-token prompts, 64 new; Qwen2-VL-7B, 28 layers, B 8 with one image of
   256 patch embeddings a row and its M-RoPE positions, 1024 text tokens,
   32 new; the batches from the launcher's `build_batch`, bf16 weights from
   the seed, one model on the card at a time) through `Engine.generate`:
   time to first token (Whisper: and the encoder's time), decode ms a
   token, tokens/s, peak memory; the attention kernel launched 12 times a
   Whisper generate (4 encoder, non-causal over 1500 frames; 4 causal self;
   4 cross, Sq 32 over Skv 1500) and 28 a Qwen2-VL one, none in a decode
   step, nothing else launched; two generates bit-identical; the first
   decode at prompt + vision prefix; layer 0's block (Whisper's encoder
   and decoder blocks) in bf16 against its f64 evaluation: the kernel no
   further off than FLASH_BF16_VS_TWIN x the twin, and with its attention
   at fan-in over its contraction within XD_BF16_REL of max |f64|. Then
   each at XD_SMALL's 2 layers in f32: decode(prefill(x), t) within 5e-3
   of prefill(x ‖ t), the ContinuousEngine's completions at 4 slots ==
   static B = 1 generates (each request with its own frames or image, two
   image grids), and no aten op given a CPU tensor in a prefill and a
   decode step;
23. training of the non-dense decoders at their published widths
   (NT_RUNS; bf16 parameters from the seed, remat on, B x 1024 of
   `SyntheticLM`, one model on the card at a time, the attention
   projections at fan-in over their contraction): first one Mamba-1
   layer's forward and backward at Falcon-Mamba-7B's width under remat, at
   B 1 x S 1024, its peak device memory printed (what sizes Falcon-Mamba's
   cut); then Mixtral-8x22B at 1 layer, Kimi-K2 at 1 layer with 24 of its
   384 routed experts, Zamba2-2.7B at all 54 layers, Falcon-Mamba-7B at
   its cut, Whisper-tiny whole (B 16 x 448 over 1500 stub frames) and
   Qwen2-VL-7B at 14 of 28 layers (B 4 x (256 patch embeddings + 1024
   tokens), M-RoPE positions; its peak sizes the cut) each take
   TRAIN["steps"] AdamW steps (NT_OPT: lr 3e-5 from the
   first step) through `build_train_fns`: every loss finite and the last below the
   first by TRAIN["min_drop"]; every step the attention forward twice and
   the backward once a layer under remat (Mixtral and Kimi-K2: 2 + 1;
   Whisper 24 + 12: its encoder's 4, its decoder's 4 self and 4 cross;
   Qwen2-VL 28 + 14), the shared block's 9 + 9 (Zamba2; not under remat),
   nothing for Falcon-Mamba, and no other kernel of the table; the first step's
   backward calls held to the twin on their own inputs (`bwd_vs_twin`);
   the MoE's aux loss finite and positive and its router's gradient
   non-zero; for Falcon-Mamba and Zamba2 an f32 gradient gate at NT_GRAD's
   2 layers: layer 0's block (Zamba2: group 0's shared block and Mamba-2
   layer, the attention through the f32 kernels at D = 80), its gradient
   with respect to its input and every leaf within NT_GRAD["rel"] of each
   one's largest entry of the same block in f64 with the sequential
   recurrence. Reported: ms a step (median of steps 3-15, host clock),
   tokens/s, peak memory, the model-FLOPs share of the bf16 peak (MoE on
   its active parameters), beside the card's name and power limit;
24. training of every non-dense family across ranks (NR_RUNS; gloo ranks
   all on the one card, spawned as phase 19 spawns its own; phase 23's
   draw, NR["steps"] AdamW steps at NT_OPT): on 1x2 Mixtral-8x22B and
   Kimi-K2 at 1 layer (24 experts), Falcon-Mamba-7B at 2 layers,
   Zamba2-2.7B at 1 group and Qwen2-VL-7B at 2 layers, on 2x2
   Whisper-tiny whole; one rank's steps on the same parameters and
   batches first (this process): the ranks report one loss, every step's
   within NR's bounds of one rank's (step 1's routing flips printed for
   the MoE runs) and the step-1 gradient norm within NR["gnorm_rtol"];
   each rank holds its resolved shards' bytes; every step launches the
   attention kernels phase 23 counts for the config and nothing else.
   Reported: rank 0's ms a step beside one rank's, tokens/s, each rank's
   peak memory and wire bytes a step;
25. the dry run held to the card (DRY): `python -m repro_torch.launch.dryrun`
   in three subprocesses at once (`dry_run_records`), counting on fake
   CUDA tensors (every record must say so), as rank 0 of fake worlds:
   (a) phase 16's AdamW step on one rank, its predicted peak plus what phase 16 held outside its steps
   (tensors of earlier phases resident as the steps started, and its
   recorded backward rows, both read there) within DRY["peak_rel"] of phase
   16's max_memory_allocated (the categories at the peak, the counted
   FLOPs over phase 16's model FLOPs and the roofline bound over its ms a
   step reported); (b) phase 19's 1x2 AdamW step: rank 0's wire bytes a
   step equal to phase 19's counter and its peak within DRY["peak_rel"];
   (c) every phase 17 1x4 serve on the repo's own tiers: rank 0's wire
   bytes a call equal to phase 17's counter; (d) tinyllama-1.1b train_4k
   and hdc-scaleout serve_packed on the 16x16 production mesh: status ok,
   each one's per-rank peak against the card's memory and its dominant
   roofline term printed. The compat line (the runtime's capabilities)
   prints after the card's.

Each phase prints its seconds. Then the card line again, a JSON line
{"kernels": [...]} (launches counted on the main-path runs of phases 4-5 and
7-16, each run between a reset and a read of the counters: the serves, the
48 Table I calls, the sparse trials and serves at d = 2^20, phase 10's
serves, recall oracle and multi-centroid calls, phase 11's generates,
phase 12's serves, trials and drift sweeps, and phase 13's slot-ring runs
(its standalone comparison serves are not counted), phase 14's chaos
serves, fault-aware serves and engine runs (the fault-free serves beside
them, the vote-erasure comparisons, the timing calls and the standalone
comparisons are not counted), phase 15's scheduler runs (the static
comparison generates are not counted), phase 16's training steps and
Trainer runs (the kernel cases of (a) are not counted), one counted call
of every case on every rank of phase 17 (the one-rank comparison serves and
the timed calls are not counted) and, on every rank of phase 18, the
process serves of (a), the fault-aware serves of (b) and the engines' runs
of (c) (the one-rank runs, the fault-free and standalone comparison serves
and the warm rings are not counted), and every training step on every rank
of phase 19 (the one-rank comparison steps are not counted), phase
20's generates (its recorded prefills, checks, timings and the ring check
are not counted), and phase 21's generates (its timed prefill and decodes,
gates, part timings and SSM_SMALL's runs are not counted), and phase
22's generates (its encoder timing, layer-0 checks and XD_SMALL's runs
are not counted), and phase 23's training steps (its memory probe and
gradient gates are not counted), and every training step on every rank
of phase 24 (the one-rank comparison steps are not counted);
the d = 8192 comparisons, the
keep == n_grp identity at C = 1024, phase 11's checks and phase 12's
quarantine check are not counted), and as the last line {"ok": true, ...}.

    python3 chip_smoke.py --profile --json out/chip_smoke.json

adds a profile of every serve mode (the symbol modes too), of the sparse
serve, of the flat and coarse packed serves at 102,400 classes, of one
multi-tenant step of phase 13's (a) baseline packed and unpacked and (b)
bsc (the share of the tenant gather, bank_rows packed or store rows
unpacked, and of the per-slot fan-out), of phase 14's bsc baseline
serves at the paper's configuration, fault-free and fault-aware, of one
continuous LM step at N = 4 beside one static decode step at B = 4 and of a
1024-token prompt's whole prefill beside its four chunks of 256, of two
TinyLlama-1.1B training steps (with the backward kernel's share), of
phase 20's two MoE prefills (the attention kernel's share), of phase 21's
prefills and decode steps (Zamba2's with the attention kernel's share), of
phase 22's prefills (the attention kernel's share) and decode steps, and of
the LM prefill (with
the attention kernel's share of its device time) and decode step under
torch.profiler (device busy time, idle share, top device ops per call), and
writes every number of the run, unrounded, to the JSON file.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's peaks (H100 SXM) and the roofline's helpers: one count for the
# kernels' bounds here and the dry run's roofline (phase 25)
from repro_torch.analysis.roofline import (  # noqa: E402
    BF16_FLOPS_PER_S, kernel_bound)
from repro_torch.kernels.flash_attention.ops import attention_pairs  # noqa: E402
CALLS = 8                        # serve calls per mode
SEED = 0
SPARSE_DIM, SPARSE_DENSITY, SPARSE_K = 2**20, 0.001, 2048   # benchmarks/sparse.py:46-47
NARROW_DIM, NARROW_DENSITY, NARROW_K = 8192, 0.008, 131     # packed kernels fit (W = 256)
# the gate row of the coarse-to-fine C sweep: benchmarks/topk.py:52-53
# (C = 102,400, gs = 8, keep = 8), :89-101 (d = 2048, M = 3, 8 cores, batch
# 512, exact noise) and :102 (bsc at BER 0.02)
COARSE = dict(n_classes=102400, dim=2048, m_tx=3, n_rx_cores=8, batch=512)
COARSE_BER, COARSE_GS, COARSE_KEEP = 0.02, 8, 8
# the serve codebook of the multi-centroid memory, with train_multicentroid's
# defaults (src/repro/core/classifier.py:450-461): k_c = 4 -> 25,600 rows
MC_CLASSES, MC_DIM, MC_KC, MC_CORES = 6400, 512, 4, 64
PAPER_TABLE1 = {  # benchmarks/table1.py:11-16, M = 1, 3, ..., 11
    ("baseline", "ideal"): [1, 0.966, 0.902, 0.803, 0.704, 0.543],
    ("baseline", "wireless"): [1, 0.966, 0.9, 0.801, 0.699, 0.537],
    ("permuted", "ideal"): [1, 1, 1, 1, 0.995, 0.978],
    ("permuted", "wireless"): [1, 1, 1, 1, 0.994, 0.963],
}
TABLE1_MS = (1, 3, 5, 7, 9, 11)
# phase 12: the symbol tier's empirical BER at d = 2^16 over all 64 RX, the
# Table I workload on the physical tier and the reference's numbers for it
# (EXPERIMENTS.md:150-177), and the living-channel scenarios: the gated
# closed loop at tests/test_phy_process.py:283-306's parameters with 512
# trials, and EXPERIMENTS.md:228-236's, reported
SYMBOL_BER_DIM = 2**16
SYMBOL_TASK = dict(n_classes=100, dim=512, n_trials=1000)
PAPER_SYMBOL = dict(avg_ber=0.0401, max_ber=0.162, m5=0.887, m5_permuted=0.981,
                    m5_avg_ber=0.1072)
DRIFT_GATE = dict(n_rx=16, n_classes=64, sigma=0.15, alpha=0.5, guard=128, steps=25, tail=8,
                  trials=512)
DRIFT_REPORT = dict(sigma=0.1, steps=50, tail=10)
# phase 11: TinyLlama-1.1B at its published width (src/repro/configs/tinyllama_1_1b.py:
# 22 layers, d 2048, 32 heads over 4 kv heads, head_dim 64, d_ff 5632, vocab
# 32000, bf16), weights drawn from the seed; batch 8 x prompt 1024 x 32 new, greedy
LM = dict(arch="tinyllama-1.1b", batch=8, prompt_len=1024, max_new=32)
LM_GENERATES = 2                 # counted generate calls (the first one cold)
# bf16 prefill last logits, kernel vs its plain twin, with the attention
# projections at fan-in over their contraction: max |diff| allowed, about 3x
# what this tree shows on the H100 and 5% of its largest logit (PERF.md)
LM_BF16_LOGIT_BOUND = 0.25
# phase 13, multi-tenant serving, every tenant at the paper's configuration
# (ScaleOutConfig's defaults): (a) the reference bench's trace
# (benchmarks/serving.py:105-108: 512 requests of 4 trials, 16 slots, 4
# tenants; the tenant order from its Poisson race, :140-147, seed 0; all
# queued at t = 0) at 6400 classes over 64 cores; (b) the paper's batch of
# 256 trials, 64 requests over 8 slots and 8 tenants; (c) the drift
# benchmark's serving point (benchmarks/serving.py:231-300)
MT_TRACE = dict(requests=512, slots=16, tenants=4, batch=4)
MT_BATCH = dict(requests=64, slots=8, tenants=8, batch=256)
MT_DRIFT = dict(n_rx=16, n_classes=64, sigma=0.1, alpha=0.5, guard=128, cap=0.05, slots=4,
                tenants=2, requests=32, batch=4)
# phase 14, fault tolerance: (a) the chaos benchmark's pinned scenario, the
# serving_faults row of BENCH_BASELINE.json (read from the file with its
# bounds; benchmarks/faults.py:51-192 for the curve, the sweep and the
# engine's 4 slots and 32 requests); (b) the paper's configuration with 8 of
# 64 cores dead and 1% stuck cells, and one coarse packed serve (groups of
# 10 of each core's 100 classes, 8 kept); (c) the fault-tolerant engine on
# phase 13 (b)'s trace with the same faults, then a short wearout run
CHAOS_CURVE, CHAOS_STUCK = (0, 1, 2, 4, 8), (0.0, 0.01, 0.05, 0.1)
CHAOS_ENGINE = dict(slots=4, requests=32)
FAULTS_PAPER = dict(k_dead=8, stuck_density=0.01, coarse_group=10, coarse_keep=8)
WEAROUT = dict(p_die=0.02, stuck_rate=1e-3)
# phase 15, continuous LM serving at TinyLlama-1.1B's published width: (a)
# and (b) the reference serving bench's trace (benchmarks/serving.py:29-31,
# :39-44: 24 requests, prompt lengths 16/32/64 shuffled by seed 0, 4 slots,
# 16 new tokens, greedy, all queued at t = 0); (c) chunked admission: 6
# requests of 256, 640 and 1024 tokens (shuffled alike), 2 slots, chunks
# of 256, the chunk signatures that mix must give, and the bound on the
# first continuous step's f32 logits against the static decode's (phase
# 11's bound on the f32 prefill logits)
CONT_TRACE = dict(requests=24, lengths=(16, 32, 64), slots=4, max_new=16)
CONT_CHUNKED = dict(requests=6, lengths=(256, 640, 1024), slots=2, max_new=16, chunk=256)
CONT_CHUNK_SIGS = {(0, 256), (256, 256), (512, 128), (512, 256), (768, 256)}
CONT_LOGIT_TOL = 1e-3
# the attention kernel against its plain twin: f32 within atol = rtol of it
# (phase 2's f32 tolerance: only the order of the sums differs); bf16 no
# further off f64 than this many times the twin (phase 11's per-layer rule)
FLASH_F32_TOL = 1e-5
FLASH_BF16_VS_TWIN = 1.5
# the bf16 backward kernel against the twin in its own arithmetic (P and dS
# as bf16 hi + lo, `flash_bwd_ref(p_bf16=2)`): the two sum in other orders in
# f32 and then round to bf16, so an entry may differ by one bf16 ulp of its
# value (<= 2^-7 of it) and an entry near zero by the f32 sums' order (atol:
# this share of the twin's largest entry)
FLASH_SPLIT_RTOL = 2.0 ** -7
FLASH_SPLIT_ATOL = 2.0 ** -12
# phase 16, training at TinyLlama-1.1B's published width and depth (bf16
# parameters from the seed, remat on, batch 8 x 1024 of the synthetic stream):
# (b) AdamW as the reference's test_adamw_loss_decreases sets it
# (tests/test_train.py: lr 1e-3, warmup 5, 30 total steps, 15 steps, the loss
# down by 0.5); (c) sign_majority with the OTA BER as
# tests/test_distributed.py's test_sign_majority_training_converges (lr 3e-4,
# warmup 5, 40 total steps), 10 steps; (d) crash and resume at 2 layers,
# checkpoints every 5 steps, the failure at step 6 of 8
TRAIN = dict(arch="tinyllama-1.1b", batch=8, seq=1024, steps=15, lr=1e-3, warmup=5,
             total_steps=30, min_drop=0.5, ref_init_steps=5)
SIGN = dict(steps=10, lr=3e-4, warmup=5, total_steps=40, ber=0.01)
RESUME = dict(layers=2, steps=8, ckpt_every=5, fail_at=6)
# phase 17: the scale-out serve over (data, model) grids of gloo ranks on the
# one card, at the paper's configuration (ScaleOutConfig's defaults);
# EXPERIMENTS.md:10-19's 2x4 cell and its per-device collective bytes
MR_GRIDS = ((1, 2), (1, 4), (2, 4))
MR_MODES = ((False, "unpacked"), (False, "packed"), (True, "unpacked"), (True, "packed"))
MR_COLLECTIVES = ("psum", "psum_packed", "rs_ag")
MR_TIMED = 5                     # timed calls a case, after its counted call
MR_TIMEOUT = 300                 # seconds a grid's ranks may take, their start included
MR_CELL = dict(n_classes=4096, dim=1024, m_tx=3, n_rx_cores=8, batch=128)
MR_CELL_BYTES = {("psum", "unpacked"): 133_632, ("psum", "packed"): 133_632,
                 ("psum_packed", "packed"): 55_296, ("rs_ag", "packed"): 53_760}
# the bsc cases' per-core BER, a ramp over the cores (core i at lo + (hi -
# lo) * i / (n - 1)): hits well below 1, and a rank that reads another
# core's BER moves them; the replayed tiers' draws come from MR_REPLAY_SEED
MR_HOT_BER = (0.25, 0.5)
MR_REPLAY_SEED = 17
# phase 18: living channels, faults and the HDC engines on the same grids, at
# the paper's configuration on phase 3's state (the parts each grid runs);
# (a) a PhaseDriftProcess serve LR_STEPS steps on replayed noise; (b) phase
# 14 (b)'s scenario with its 8 dead cores spread two to each of 4 model ranks
# (one failover plan, in shards of 16 cores, on one rank and on ranks); (c)
# the engines on 1x4: phase 13 (b)'s trace, phase 13 (c)'s drift point and
# phase 14 (c)'s faults, then a fading channel whose controller re-fits,
# quarantines, drops the fleet mode and remaps (LR_FADE)
LR_GRIDS = {(1, 2): ("a",), (1, 4): ("a", "b", "c"), (2, 4): ("a", "b")}
LR_STEPS = 5
LR_DEAD = (3, 9, 17, 30, 36, 40, 51, 60)
LR_SHARD = 16
LR_FADE = dict(sigma_db=8.0, requests=16, slots=4)
LR_TIMEOUT = 300                 # seconds a grid's ranks may take, their start included
# phase 19: sharded training over gloo ranks on the one card, TinyLlama-1.1B
# at its published width and depth from phase 16's conditioned draw, B x S
# of the synthetic stream (B cut from phase 16's 8 to 4: at 8, 1x2 and 2x1
# took 133.7 s together on an H100 80GB HBM3 at 700 W, PERF.md §4): AdamW
# on 1x2 (Megatron split: 16 heads, 2 kv heads, 2816 of d_ff and 16,000 of
# the vocabulary a rank) and on 2x1 (data
# parallel, ZeRO-1), signum at the OTA BER on 2x1, and AdamW on 2x2 cut to
# 2 layers (both groups at once); every AdamW step's loss held to one
# rank's steps on the same parameters and batches within TR["loss_rtol"]
# and the step-1 gradient norm within TR["gnorm_rtol"]: sound runs read up
# to 6.78e-05 and 5.21e-03 (the norm on 2x2; bf16 partial gradients summed),
# planted faults on 1x2 / 2x1 at least 1.67e-03 (the loss, MLP input
# gradient not all-reduced) and 0.212 (the norm, any of three faults;
# H100 80GB HBM3 at 700 W, PERF.md §6). The learning rate is
# held at 3e-5 from the first step: at phase 16's schedule (1e-3 after a
# warm-up of 5) the first steps move every parameter by ~2e-4 and the loss
# rises for 6 steps on one rank (phase 16's AdamW: 10.75, 11.96, 14.11,
# 13.74, ...), where a 6e-5 step lowers it (its signum: 10.75, 9.69)
TR = dict(arch="tinyllama-1.1b", batch=4, seq=1024, steps=4, loss_rtol=5e-4, gnorm_rtol=2e-2,
          adamw=dict(kind="adamw", lr=3e-5, warmup=1, total_steps=30),
          sign=dict(kind="sign_majority", lr=3e-5, warmup=1, total_steps=30, ber=0.01))
# The 1x2 and 2x1 runs at 4 of 22 layers: at 22 they took 58 and 68 s of a
# whole run of 1277 s once phase 26 joined, over the run's 1200 s limit
# (H100 80GB HBM3 at 700 W)
TR_RUNS = {(1, 2): (("adamw", 4),), (2, 1): (("adamw", 4), ("sign", 4)),
           (2, 2): (("adamw", 2),)}
TR_TIMEOUT = 600                 # seconds a grid's ranks may take, their start included
# phase 20: the MoE decoder at its published widths on one card, depth cut to
# fit 80 GB (src/repro/configs/mixtral_8x22b.py and kimi_k2.py; bf16 weights
# drawn from the seed): Mixtral-8x22B at 12 of 56 layers (30.45 B parameters,
# 60.9 GB) and Kimi-K2 at 1 of 61 (38.8 GB; 2 layers would need 73 GB), each
# on phase 11's trace (LM); then Mixtral's ring decode past its 4096 window at
# 2 layers in f32, capacity_factor E/k so that nothing drops, B 1 x prompt
# 4352 x 16 new (the 2-layer f32 model, 21.6 GB, alone on the card)
MOE_RUNS = (("mixtral-8x22b", 12), ("kimi-k2", 1))
MOE_RING = dict(arch="mixtral-8x22b", layers=2, prompt_len=4352, new=16)
# one MoE layer in bf16 on the prefill's layer-0 input against its f64
# evaluation: every (token, k) assignment whose f64 probability margin to its
# neighbours in rank exceeds MOE_MARGIN routed alike, and over the tokens
# routed alike max |diff| within MOE_BF16_BOUND: about 3x what this tree
# shows on an H100 80GB HBM3 at 700 W (0.01776 and 0.01895, max |f64 out|
# 2.748 and 3.813; PERF.md §6)
MOE_MARGIN = 1e-5
MOE_BF16_BOUND = {"mixtral-8x22b": 0.05, "kimi-k2": 0.06}
# phase 21: the SSM and hybrid decoders at their published widths and depths
# (src/repro/configs/falcon_mamba_7b.py, 64 Mamba-1 layers, 14.5 GB of bf16
# weights; zamba2_2_7b.py, 54 Mamba-2 layers in 9 groups and one shared
# attention block at D = 80, 4.9 GB; weights from the seed), each on phase
# 11's trace (LM). Layer 0's block in bf16 against its f64 evaluation within
# SSM_BF16_REL of max |f64| (8 bf16 roundings, 2^-5), and the chunked scan
# in f32 against the f64 sequential recurrence on the layer's own inputs
# within SSM_SCAN_REL of each output's largest entry (f32 sums over the
# chunks of 128; the reference's own tolerance of its scans against their
# oracles is 1e-4). SSM_SMALL: the f32 gates at 2 layers (the hybrid at 2
# groups of 1): decode == prefill of S + 1 within the reference's 5e-3, and
# the continuous engine's completions == static generates
SSM_RUNS = ("falcon-mamba-7b", "zamba2-2.7b")
SSM_BF16_REL = 2.0 ** -5
SSM_SCAN_REL = 1e-4
SSM_SMALL = dict(layers=2, batch=2, prompt_len=200, steps=3, tol=5e-3, requests=6,
                 lengths=(16, 40, 96), slots=3, max_new=8)
# phase 22: the enc-dec and VLM decoders at their published widths and depths
# (src/repro/configs/whisper_tiny.py: 4 + 4 layers, d 384, 6 heads of 64, 1500
# stub frames, ~41 M parameters; qwen2_vl_7b.py: 28 layers, d 3584, 28 heads
# over 4 of 128, M-RoPE sections (16, 24, 24), ~8.3 B parameters drawn in
# slices of at most 2 GiB; weights from the seed). Whisper: B 32 clips of
# 1500 frames (the stub frontend's output, drawn as the launcher draws it),
# 32-token prompts, 64 new; Qwen2-VL: B 8, one image a row (a 16 x 16 grid
# of 256 patch embeddings: a 448 x 448 image after the merger), 1024 text
# tokens, 32 new. Layer 0 in bf16 on the first two rows against its f64
# evaluation: at the seeded init (a near-hard attention) the kernel's block
# no further off than FLASH_BF16_VS_TWIN x the twin's, and with its
# attention at fan-in over its contraction within XD_BF16_REL of max |f64|
# (SSM_BF16_REL's 2^-5). XD_SMALL: the f32 gates at 2 layers (Whisper 2 + 2)
# with the attention at fan-in over its contraction: decode == prefill of
# S + 1 within the SSM phase's 5e-3, continuous (4 slots, each request with
# its own frames or image, two image grids) == static B = 1 generates, and
# no aten op given a CPU tensor in a prefill and a decode step
XD_RUNS = {"whisper-tiny": dict(batch=32, prompt_len=32, max_new=64),
           "qwen2-vl-7b": dict(batch=8, prompt_len=1024, max_new=32, grid=(16, 16))}
XD_BF16_REL = 2.0 ** -5
XD_SMALL = dict(layers=2, batch=2, prompt_len=200, steps=3, tol=5e-3, requests=6,
                lengths=(16, 40, 96), grids=((16, 16), (8, 8)), slots=4, max_new=8)
# phase 23: training of the non-dense decoders (MoE, SSM, hybrid, enc-dec,
# VLM) at their published widths on one card (bf16 parameters from the seed,
# remat on, B x NT_SEQ of SyntheticLM, TRAIN["steps"] AdamW steps at NT_OPT
# through build_train_fns; one model on the card at a time; the attention
# projections at fan-in over their contraction, phase 16's rule). bf16 parameters and gradients and
# AdamW's f32 moments take 12 bytes a parameter, which sets the cuts
# (PERF.md §4): Mixtral-8x22B at 1 of 56 layers (2.907 B parameters, 32.5
# GiB; 2 layers need 60.5 GiB before activations); Kimi-K2 at 1 of 61
# layers with 24 of its 384 routed experts, one model shard's
# (src/repro/configs/kimi_k2.py: "EP 384/16 = 24 experts per model shard";
# 3.566 B, 39.8 GiB; all 384 need 217 GiB), top-8, the shared expert and
# d_expert 2048 kept; Zamba2-2.7B uncut (54 Mamba-2 layers, 9 calls of the
# shared block; 2.423 B, 27.1 GiB); Falcon-Mamba-7B at NT_FALCON's cut.
NT_SEQ = 1024
# AdamW held at lr 3e-5 from the first step (warm-up 1), as phase 19 holds
# its own: at phase 16's schedule (1e-3 after a warm-up of 5) every model's
# loss rose within 6 steps to 1.41-2.82x its first (Mixtral-8x22B 10.96 ->
# 30.93) before falling, and held at 3e-4 or 1e-4 Mixtral's and Zamba2's
# still rose to 1.36-2.25x; at 3e-5 no loss rose above its first and the
# last fell by 2.03-4.76 (benchmarks/torch_nondense_lr.py on an H100 80GB
# HBM3 at 700 W, PERF.md §6)
NT_OPT = dict(lr=3e-5, warmup=1, total_steps=TRAIN["total_steps"])
# Falcon-Mamba-7B's cut, from phase 23's own probe: autograd through the
# eager Hillis-Steele scan keeps a chunk's [B, 128, 8192, 16] f32 pairs for
# every step of the scan, and one Mamba-1 layer's forward and backward
# under remat at B 1 x S 1024 takes 8.71 GiB above its weights (H100 80GB
# HBM3 at 700 W, PERF.md §4), about B times that while a layer recomputes.
# 16 of 64 layers are 2.218 B parameters, 24.8 GiB of bf16 parameters and
# gradients and f32 moments; at B 2 that reckons ~42 GiB (read: a 52.86 GiB
# peak with AdamW's f32 temporaries), under ~70, at 3.8 s a step; B 4 adds
# ~17 GiB and doubles the step; all 64 layers need 81.3 GiB before any
# activation. B 2 fits at 8 and more layers, so the scan needs no
# per-chunk recompute.
NT_FALCON = dict(layers=16, batch=2)
# Whisper-tiny whole (4 + 4 layers, ~41 M parameters): B 16 x 448 tokens,
# the real model's target cap (src/repro/configs/whisper_tiny.py), over
# 1500 stub frames a row drawn at unit scale as phase 22 draws them.
# Qwen2-VL-7B at 14 of 28 layers: 4.353 B parameters, 48.6 GiB at 12 bytes
# a parameter (16 layers 53.9 GiB, all 28 91 GB), B 4 x (256 patch
# embeddings of a 16 x 16 grid + 1024 tokens) with `vlm.default_positions`;
# the run's peak sizes the cut (`nt_cut_line`). The frames and patch
# embeddings come from this script: the launcher feeds tokens only.
NT_RUNS = (dict(arch="mixtral-8x22b", layers=1, batch=4),
           dict(arch="kimi-k2", layers=1, batch=4, experts=24),
           dict(arch="zamba2-2.7b", layers=None, batch=4),
           dict(arch="falcon-mamba-7b", **NT_FALCON),
           dict(arch="whisper-tiny", layers=None, batch=16, seq=448),
           dict(arch="qwen2-vl-7b", layers=14, batch=4, grid=(16, 16)))
# the f32 gradient gate of the SSM and hybrid runs: layer 0's block (the
# hybrid's group 0: the shared attention block, then its Mamba-2 layer) at 2
# layers (the hybrid at 2 groups of 1, its shared attention at fan-in over
# its contraction as SSM_SMALL's), on its own input, B 1 x S 256 (two scan
# chunks), against the same block in f64 with the sequential recurrence:
# the gradient with respect to the input and to each leaf within ``rel`` of
# that one's largest entry (the CPU tests hold the port to JAX at 1e-4)
NT_GRAD = dict(layers=2, batch=1, seq=256, rel=1e-4)
# phase 24: training of every non-dense family across ranks (gloo, every rank
# on cuda:0, spawned as phase 19 spawns its own), each family at its
# published width, phase 23's draw (the attention projections at fan-in
# over their contraction), NR["steps"] AdamW steps at NT_OPT, one rank's
# steps on the same parameters and batches run first in this process. On
# 1x2: Mixtral-8x22B at 1 layer (each rank half of every expert's hidden
# width, `expert_mlp: model`), Kimi-K2 at 1 layer with 24 routed experts
# (12 a rank, the router's logits gathered), Falcon-Mamba-7B at 2 layers
# (d_inner 4096 a rank; in_proj's x|z cut puts all of x on rank 0),
# Zamba2-2.7B at 1 group (6 Mamba-2 layers, 40 heads a rank, and the shared
# block) and Qwen2-VL-7B at 2 layers with its vision prefix; on 2x2
# Whisper-tiny whole (its vocabulary does not divide: the tied head whole,
# embed over data). B 2 x 1024 (Qwen2-VL 2 x (256 + 1024)), Whisper B 8 x 448
# over 1500 frames. Gates: the ranks report one loss; every step's loss
# within NR["loss_rtol"] of one rank's and the step-1 gradient norm within
# NR["gnorm_rtol"]; each rank holds its resolved shards' bytes; every step
# launches the attention kernels phase 23 counts for the config and no
# other kernel. The MoE runs also print how many of step 1's layer-0
# (token, expert) assignments route otherwise on the ranks than on one
# rank (bf16 near-ties). Step 1's loss (before any update) is held to
# loss_rtol on every run, and so is every later step where step 1 routes
# alike; where it does not, steps 2-3 are held to moe_loss_rtol, the flips
# printed beside them. Readings on an H100 80GB HBM3 at 700 W (PERF.md §6):
# sound runs, loss up to 6.22e-05 routed alike (Zamba2) and 8.37e-05 at
# step 1 but 1.54e-03 at step 3 with 14 of 4,096 layer-0 assignments
# flipped (Mixtral-8x22B); step-1 gradient norm up to 1.60e-04 on 1x2
# (Kimi-K2) and 9.66e-04 on 2x2 (Whisper-tiny; phase 19 read 5.21e-03
# there); planted faults (benchmarks/torch_nondense_rank_mutants.py),
# Zamba2's gated norm over the rank's channels 7.44e-04 (loss; 1.38e-04 at
# step 1) and 1.34e-03 (norm), a model rank's partial sums unreduced
# 1.53e-03 to 3.46e-02 (loss; 1.53e-03 to 1.02e-02 at step 1, 6.89e-03 the
# least of an MoE run's steps 2-3) and 0.0392 to 0.331 (norm; 0.183 on
# 2x2), Mixtral's and Whisper's ranks reporting different losses.
NR = dict(steps=3, loss_rtol=3e-4, moe_loss_rtol=5e-3, gnorm_rtol={"1x2": 5e-4, "2x2": 2e-2},
          timeout=900)
NR_RUNS = {(1, 2): (dict(arch="mixtral-8x22b", layers=1, batch=2),
                    dict(arch="kimi-k2", layers=1, batch=2, experts=24),
                    dict(arch="falcon-mamba-7b", layers=2, batch=2),
                    dict(arch="zamba2-2.7b", groups=1, batch=2),
                    dict(arch="qwen2-vl-7b", layers=2, batch=2, grid=(16, 16))),
           (2, 2): (dict(arch="whisper-tiny", layers=None, batch=8, seq=448),)}
# phase 25: the dry run (`python -m repro_torch.launch.dryrun`, fake tensors
# standing for this card) held to what phases 16, 17 and 19 measured in this
# run: (a) phase 16's AdamW step (TRAIN) on one rank, (b) phase 19's 1x2
# AdamW step (TR) as rank 0 of a fake world of 2, (c) phase 17's 1x4 serves
# (the cases on the repo's own tiers), (d) two production records on the
# 16x16 mesh. The predicted peak within DRY["peak_rel"] of the measured
# max_memory_allocated (phase 16's with what that phase held outside its
# steps added); the wire bytes equal to the counter's reading
DRY = dict(peak_rel=0.10, timeout=240,
           production=(("tinyllama-1.1b", "train_4k"), ("hdc-scaleout", "serve_packed"),
                       ("tinyllama-1.1b", "prefill_32k"), ("tinyllama-1.1b", "decode_32k")))
# phase 26: sharded inference (gloo, every rank on cuda:0, spawned as phase
# 24 spawns its own), each family at its published width in bf16, the
# attention projections at fan-in over their contraction (phase 16's rule):
# TinyLlama-1.1B whole, Mixtral-8x22B and Kimi-K2 at 1 layer (Kimi with 24
# routed experts, one model shard's), Falcon-Mamba-7B and Qwen2-VL-7B at 2
# layers, Zamba2-2.7B and Whisper-tiny whole. B 2 (one row a data rank on
# 2x1 and 2x2) x ``prompt`` tokens (Qwen2-VL behind 256 patches of a 16 x 16
# grid, Whisper over its 1500 stub frames) at ``pad_to`` slots, then
# NI["steps"] greedy steps. On a cut K/V cache (``kv_seq`` on ``model``: 256
# of 512 slots a rank) the decode crosses from rank 0's slots into rank
# 1's (positions 255-256; Qwen2-VL 511-512 of 1024); Mixtral's 4096-slot
# window ring, 4095 of it filled, wraps from slot 4095 on rank 1 to slot 0
# on rank 0. One rank's run first in this process; its greedy tokens are
# every grid's inputs; each grid runs the families NI_GRIDS names. Gates: each step's logits, gathered, within
# NI["logit_rel"] of one rank's largest |logit|; the rank's argmax equal to
# one rank's wherever one rank's top-2 margin exceeds twice that bound;
# each rank's cache within NI["cache_rel"] of the largest entry of its
# slice of one rank's (slot_pos equal); every prefill launches the
# attention kernel once a call on each rank, a decode step no kernel. The
# bounds are bf16's: a CPU rehearsal at the smoke widths in bf16 read up to
# 0.0148 (logits) and 0.0242 (Zamba2's conv state) on 1x2; a rank that
# reads the wrong slots, heads or channels is off by O(1). Where bf16's own
# rounding is larger (Zamba2-2.7B's 54 layers read 0.069-0.085 on 1x2), a
# call or leaf is held to NI["yard"] times one rank's bf16 distance from
# the same run in f32 (the bf16 parameters widened, one rank's greedy
# tokens). An MoE call
# whose routing differs from one rank's (bf16 near-ties in the router: on
# the card Kimi-K2's 1x2 prefill read 0.0906) is held to
# NI["moe_logit_rel"] instead, the assignments routed otherwise printed and
# held under NI["max_rerouted"] of rank 0's, or 4 (phase 24 read 14 of
# 4,096).
NI = dict(batch=2, steps=2, logit_rel=5e-2, cache_rel=5e-2, yard=2.0, moe_logit_rel=0.25,
          max_rerouted=0.01, timeout=900)
NI_RUNS = (dict(arch="tinyllama-1.1b", prompt=255, pad_to=512),
           dict(arch="mixtral-8x22b", layers=1, prompt=4095, pad_to=4096),
           dict(arch="kimi-k2", layers=1, experts=24, prompt=255, pad_to=512),
           dict(arch="falcon-mamba-7b", layers=2, prompt=255, pad_to=512),
           dict(arch="zamba2-2.7b", prompt=255, pad_to=512),
           dict(arch="whisper-tiny", prompt=255, pad_to=512),
           dict(arch="qwen2-vl-7b", layers=2, prompt=255, pad_to=1024, grid=(16, 16)))
# the families each grid runs: every one on 1x2; on the data grids those
# the run's limit affords (Mixtral's dispatch group straddles the data
# ranks; Kimi-K2's and Qwen2-VL's `embed: data` leaves move 10.7 and 4.7 GB
# a call on 2x1, Zamba2-2.7B's in_proj 4.5 GB a step on 2x2: 8.3, 3.1 and
# 5.0 s a decode step through gloo; a rank's first Whisper-tiny prefill
# takes 11-14 s; H100 80GB HBM3 at 700 W). The CPU tests run every family
# on every grid (tests/test_torch_distributed_infer.py)
NI_GRIDS = {(1, 2): tuple(r["arch"] for r in NI_RUNS),
            (2, 1): ("tinyllama-1.1b", "mixtral-8x22b", "falcon-mamba-7b", "zamba2-2.7b"),
            (2, 2): ("tinyllama-1.1b", "mixtral-8x22b")}
# phase 16 (a): the backward kernel's cases, label -> (B, Sq, Skv, H, KH, D,
# causal, window, q_offset, dtype); the training shape first
FLASH_BWD_CASES = [
    ("train", (8, 1024, 1024, 32, 4, 64, True, -1, 0, "bfloat16")),
    ("gemma3-1b local", (8, 1024, 1024, 4, 1, 256, True, 512, 0, "bfloat16")),
    ("gemma3-1b global", (8, 1024, 1024, 4, 1, 256, True, -1, 0, "bfloat16")),
    ("deepseek-coder-33b", (2, 1024, 1024, 56, 8, 128, True, -1, 0, "bfloat16")),
    ("D=16", (2, 300, 300, 4, 2, 16, True, -1, 0, "bfloat16")),
    ("D=32", (2, 300, 300, 4, 2, 32, True, -1, 0, "bfloat16")),
    ("non-causal", (8, 512, 512, 32, 4, 64, False, -1, 0, "bfloat16")),
    ("ragged", (8, 1000, 1000, 32, 4, 64, True, -1, 0, "bfloat16")),
    ("chunk", (8, 256, 768, 32, 4, 64, True, -1, 512, "bfloat16")),
    ("f32", (2, 256, 256, 4, 2, 64, True, -1, 0, "float32")),
    ("f32 windowed chunk", (2, 128, 384, 4, 2, 32, True, 64, 256, "float32")),
    # queries 0-63 see no key: P = 1 on every key in the backward
    ("fully masked rows", (2, 128, 128, 4, 2, 64, True, -1, -64, "bfloat16")),
    # phase 23's layers: Kimi-K2 (D = 112) and Zamba2-2.7B's shared block
    # (D = 80) in the D = 128 tiles, Mixtral-8x22B past its window of 4096
    # (the one published config whose window binds the dQ pass's key range),
    # a D = 112 chunk over a cache prefix, and f32 at D = 80 and 112
    ("kimi-k2 D=112", (4, 1024, 1024, 64, 8, 112, True, -1, 0, "bfloat16")),
    ("zamba2 D=80", (4, 1024, 1024, 32, 32, 80, True, -1, 0, "bfloat16")),
    ("mixtral windowed", (1, 8192, 8192, 48, 8, 128, True, 4096, 0, "bfloat16")),
    ("D=112 chunk", (2, 256, 768, 8, 2, 112, True, -1, 512, "bfloat16")),
    ("f32 D=80", (2, 256, 256, 4, 2, 80, True, -1, 0, "float32")),
    ("f32 D=112", (2, 128, 384, 4, 2, 112, True, 64, 256, "float32")),
    # phase 23's Whisper-tiny and Qwen2-VL-7B: the encoder's non-causal
    # attention over 1500 frames, the cross-attention (Sq 448 over Skv 1500,
    # no tile multiple), and Qwen2-VL's causal layer over 256 patches + 1024
    # tokens
    ("whisper-tiny encoder", (16, 1500, 1500, 6, 6, 64, False, -1, 0, "bfloat16")),
    ("whisper-tiny cross", (16, 448, 1500, 6, 6, 64, False, -1, 0, "bfloat16")),
    ("qwen2-vl-7b", (4, 1280, 1280, 28, 4, 128, True, -1, 0, "bfloat16")),
]
# serve modes: (serve, PHY tier, permuted bundling, representation)
MODES = ([("ota", ch, perm, rep) for ch, perm in (("bsc", False), ("bsc", True), ("ideal", False))
          for rep in ("unpacked", "packed")]
         + [("wired", "bsc", False, rep) for rep in ("unpacked", "packed")])
SERVE_KERNELS = {  # (serve, representation) -> the kernels its calls must launch
    ("ota", "unpacked"): ("assoc_matmul",), ("ota", "packed"): ("hamming_topk_banked",),
    ("wired", "unpacked"): ("majority_bundle", "assoc_matmul"),
    ("wired", "packed"): ("hamming_search",),
}
KERNELS = {  # name -> (route, source, the TPU kernel it replaces)
    "hamming_topk_banked": ("cuda", "src/repro_torch/csrc/hamming.cu",
                            "src/repro/kernels/hamming/kernel.py:109"),
    "hamming_search": ("cuda", "src/repro_torch/csrc/hamming.cu",
                       "src/repro/kernels/hamming/kernel.py:260"),
    "hamming_topk_k_banked": ("cuda", "src/repro_torch/csrc/hamming.cu",
                              "src/repro/kernels/hamming/kernel.py:214"),
    "hamming_search_banked": ("cuda", "src/repro_torch/csrc/hamming.cu",
                              "src/repro/kernels/hamming/kernel.py:41"),
    "assoc_matmul": ("cuda", "src/repro_torch/csrc/assoc_matmul.cu",
                     "src/repro/kernels/assoc_matmul/kernel.py:42"),
    "majority_bundle": ("cuda", "src/repro_torch/csrc/majority.cu",
                        "src/repro/kernels/majority/kernel.py:27"),
    "sparse_search": ("cuda", "src/repro_torch/csrc/sparse.cu",
                      "src/repro/kernels/sparse/kernel.py:62"),
    "sparse_topk_banked": ("cuda", "src/repro_torch/csrc/sparse.cu",
                           "src/repro/kernels/sparse/kernel.py:119"),
    "flash_attention_fwd": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:82"),
    # the model's FlashAttention-2 custom VJP (a blockwise scan, no Pallas kernel)
    "flash_attention_bwd": ("cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:263"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# instructions in the SASS of the redesigned kernels: kernel symbol -> the
# opcodes that must appear (tensor-core products; the sparse kernels'
# asynchronous 16-byte copies; the majority's 16-byte loads) and those that
# must not. "LDG.128" is any LDG whose modifiers include .128.
SASS_RULES = {
    "flash_fwd_mma_kernel": (("HGMMA", "HMMA"), ()),
    "assoc_matmul_kernel": (("IGMMA", "IMMA"), ("IDP4A",)),
    "sparse_kernel": (("LDGSTS",), ()),
    # the packed Hamming search and top-k: 1-bit tensor-core products
    # (mma.sync); the top-1: 1-bit warpgroup products (wgmma)
    "hamming_search_kernel": (("BMMA", "IMMA"), ()),
    "hamming_topk_k_kernel": (("BMMA", "IMMA"), ()),
    "hamming_top1_kernel": (("BGMMA",), ("BMMA", "IMMA")),
    "majority_kernel": (("LDG.128",), ()),
    # the attention backward's two passes: bf16 on the tensor cores (wgmma),
    # f32 products on the CUDA cores
    "flash_bwd_dkdv_mma_kernel": (("HGMMA",), ()),
    "flash_bwd_dq_mma_kernel": (("HGMMA",), ()),
    "flash_bwd_dkdv_kernel": (("FFMA",), ()),
    "flash_bwd_dq_kernel": (("FFMA",), ()),
}
# the SIMT attention kernels, built for f32 only (bf16 has its wgmma kernels)
SIMT_ATTENTION = ("flash_fwd_simt_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
# kernel symbols that must not be in the library: the retired SIMT top-1,
# replaced by hamming_top1_kernel
GONE = ("hamming_topk_banked_kernel",)


def _op_pattern(op: str) -> str:
    """A regex for an opcode rule: a plain name, or NAME.MOD for any NAME
    instruction whose dotted modifiers include MOD."""
    head, _, mod = op.partition(".")
    return rf"\b{head}\b" if not mod else rf"\b{head}(?:\.\w+)*?\.{mod}\b"


def sass_counts(lib: Path) -> dict:
    """{kernel symbol: {opcode: count}} over every instance of the kernels in
    SASS_RULES, from ``cuobjdump -sass`` of the built library; also
    the names of the SIMT attention kernels' instances ({symbol: [names]},
    f32 only) and of every function whose name holds a symbol of GONE."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    ops = sorted({op for want, bad in SASS_RULES.values() for op in want + bad})
    pats = {op: re.compile(_op_pattern(op)) for op in ops}
    counts = {name: dict.fromkeys(ops, 0) for name in SASS_RULES}
    simt, gone, current, fn = {n: [] for n in SIMT_ATTENTION}, [], None, None
    instances = {}
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            current = next((n for n in SASS_RULES if n in fn), None)
            if current is not None:
                instances[fn] = dict.fromkeys(ops, 0)
            for n in SIMT_ATTENTION:
                if n in fn:
                    simt[n].append(fn)
            gone += [fn for n in GONE if n in fn]
        elif current is not None:
            for op, pat in pats.items():
                hits = len(pat.findall(line))
                counts[current][op] += hits
                instances[fn][op] += hits
    return dict(counts=counts, instances=instances, simt_attention=simt, gone=gone)


def ptxas_report(lib: Path) -> dict:
    """{instance: (registers, spill store bytes, spill load bytes)} of the
    kernels in SASS_RULES, from the ptxas report (-Xptxas -v) that the
    build keeps in build.log beside the library."""
    out, current = {}, None
    for line in (lib.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            name = next((n for n in SASS_RULES if n in fn), None)
            current = None if name is None else fn[fn.index(name):].split("EE")[0] + "E"
            if current is not None:
                out[current] = [None, None, None]
        elif current is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[current][1:] = [int(st), int(ld)]
        elif current is not None and "Used" in line and "registers" in line:
            out[current][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def call_ms(torch, fn, samples: int = 7, reps: int = 20) -> float:
    """Median time of one eager call of `fn` issued back to back from Python
    (``samples`` runs of ``reps`` calls): the device time or, when the host
    issues slower than the device runs, the host's cost per call (what an
    eager caller pays). Calls of tens of ms take one sample of a few."""
    fn()
    torch.cuda.synchronize()
    start, end = _events(torch)
    per_call = []
    for _ in range(samples):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def time_ms(torch, fn, samples: int = 7) -> float:
    """Median device time of one call of `fn`: a batch of calls (sized from
    one eager call to take ~2 ms) captured in one CUDA graph, so the host's
    launch cost drops out, and the graph replayed `samples` times between
    CUDA events. Caches stay warm, as for the serve, which reuses its
    prototypes from call to call."""
    fn()
    torch.cuda.synchronize()
    start, end = _events(torch)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(1, min(100, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up on a side stream before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per_call)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def bmm_yardstick(torch, hv, q, p) -> dict:
    """The Hamming searches' second library time: one bf16 `torch.bmm` of
    the +-1 expansions of q [G, B, W] and p [G, C, W], d - 2H in one call
    (the product a tensor-core route computes; its bf16 output rounds)."""
    d = 32 * q.shape[-1]
    qb = (1 - 2 * hv.unpack(q, d).to(torch.bfloat16)).contiguous()
    pbt = (1 - 2 * hv.unpack(p, d).to(torch.bfloat16)).transpose(1, 2).contiguous()
    return dict(bmm=lambda: torch.bmm(qb, pbt))


def kernel_cases(torch, gen):
    """(kernel name, shape label, kernel call, plain call, library call or
    None, bytes moved, operations, operation kind) at the main path's shapes
    and the tall shape."""
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv
    from repro_torch.kernels.assoc_matmul import ops as assoc_ops
    from repro_torch.kernels.assoc_matmul.ref import assoc_matmul_ref
    from repro_torch.kernels.hamming.ops import CLASS_TILE, plan_top1, search_cost, topk_cost
    from repro_torch.kernels.hamming.ref import hamming_search_ref, hamming_topk_banked_ref
    from repro_torch.kernels.majority import ops as majority_ops
    from repro_torch.kernels.majority.ref import majority_bundle_ref

    dev = "cuda"

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.uint8)

    def top1_case(label, g, b, c, w, c_real=None, p=None, q=None, expect=None):
        q = words(g, b, w) if q is None else q
        p = words(g, c, w) if p is None else p
        cr = c if c_real is None else c_real
        return ("hamming_topk_banked", f"{label} G={g} B={b} C={c} c_real={cr} W={w}",
                lambda: tk.hamming_topk_banked(q, p, c_real=cr),
                lambda: hamming_topk_banked_ref(q, p, cr), None, *topk_cost(g, b, cr, w),
                {} if expect is None else dict(expect=expect))

    # the main path's shapes (the OTA serves, phase 10's flat serve at
    # C = 102,400 and multi-centroid predict and bank serve, Table I at M = 11),
    # then the tall shape and the edges: ragged and unaligned (W = 5, 76),
    # B off the query tile, W past the SIMT kernel's old limit of 360
    cases = [top1_case(label, *shape) for label, shape in [
        ("serve baseline", (64, 256, 100, 16)), ("serve permuted", (192, 256, 100, 16)),
        ("flat C=102,400", (8, 512, 12800, 64)), ("multi-centroid predict", (1, 6400, 25600, 16)),
        ("Table I M=11", (11, 2000, 100, 16)), ("multi-centroid bank serve", (64, 256, 400, 16)),
        ("tall", (64, 4096, 1600, 64)), ("ragged", (3, 77, 333, 5)), ("W=76", (4, 64, 300, 76)),
        ("B off the query tile", (2, 300, 20000, 16)), ("W=400", (2, 128, 1000, 400)),
        # 128-query tiles with the query tile streamed (too wide to stay resident)
        ("W=76 at 128-query tiles", (8, 512, 2000, 76)),
        # phase 13's multi-tenant steps: (a) 16 slots x 64 cores (x 3 banks
        # permuted) of 4 trials, (b) 8 slots x 64 cores of 256 trials
        ("mt step (a)", (1024, 4, 100, 16)), ("mt step (a) permuted", (3072, 4, 100, 16)),
        ("mt step (b)", (512, 256, 100, 16))]]
    # the step as the serve calls it: bank g reads table row bank_rows[g]
    # (4 tenants x 64 cores), gathered before the launch; the bound counts
    # the table's rows once
    q, table = words(1024, 4, 16), words(256, 100, 16)
    bank_rows = torch.randint(0, 256, (1024,), generator=gen, device=dev, dtype=torch.int32)
    cases.append(("hamming_topk_banked", "mt step (a) with bank_rows G=1024 B=4 C=100 W=16",
                  lambda q=q, t=table, r=bank_rows: tk.hamming_topk_banked(q, t, bank_rows=r),
                  lambda q=q, t=table, r=bank_rows: hamming_topk_banked_ref(q, t, 100, r), None,
                  *topk_cost(1024, 4, 100, 16, table_rows=256), {}))
    # every row equal: every query's first minimum is column 0, in every split
    same = words(2, 1, 64).expand(2, 1000, 64).contiguous()
    cases.append(top1_case("all rows equal", 2, 100, 1000, 64, p=same, expect=lambda got: bool(
        (got[1] == 0).all())))
    # (2, 64, 3000, 16) takes 24 splits of one tile: eight equal copies of
    # query 0's row straddle the edge of splits 0 and 1, the lower must win
    _, splits = plan_top1(2, 64, 3000, torch.cuda.get_device_properties(0).multi_processor_count)
    edge = CLASS_TILE * (24 // splits)
    q, p = words(2, 64, 16), words(2, 3000, 16)
    p[:, edge - 4:edge + 4] = q[:, :1]
    cases.append(top1_case(f"equal rows across the split edge at {edge} ({splits} splits)",
                           2, 64, 3000, 16, p=p, q=q, expect=lambda got, e=edge: bool(
                               (got[1][:, 0] == e - 4).all() and (got[0][:, 0] == 0).all())))
    # c_real inside the last split's tile; the columns past it equal every
    # query 0 row (distance 0), so they would win if they took part
    q, p = words(2, 64, 16), words(2, 3000, 16)
    p[:, 2950:] = q[:, :1]
    cases.append(top1_case("c_real inside the last split", 2, 64, 3000, 16, c_real=2950, p=p,
                           q=q, expect=lambda got: bool((got[1] < 2950).all())))
    for label, (b, c, w) in [("serve wired", (256, 6400, 16)), ("tall", (4096, 102400, 64)),
                             ("Table I trials", (2000, 100, 16))]:
        q, p = words(b, w), words(c, w)
        # cdist with p=0 counts the coordinates that differ: the Hamming
        # distance, on the unpacked bits as f32
        qf, pf = hv.unpack(q, 32 * w).float(), hv.unpack(p, 32 * w).float()
        cases.append(("hamming_search", f"{label} B={b} C={c} W={w}",
                      lambda q=q, p=p: tk.hamming_search(q, p),
                      lambda q=q, p=p: hamming_search_ref(q, p),
                      lambda qf=qf, pf=pf: torch.cdist(qf, pf, p=0),
                      *search_cost(1, b, c, w),
                      bmm_yardstick(torch, hv, q[None], p[None])))
    for label, (g, b, c, k) in [("serve per core G=64", (64, 256, 100, 512)),
                                ("serve permuted G=192", (192, 256, 100, 512)),
                                ("serve wired G=1", (1, 256, 6400, 512)),
                                ("mt step (a) G=1024", (1024, 4, 100, 512)),
                                ("tall", (64, 4096, 1600, 2048)),
                                # padding past K, a partial class tile, unaligned rows
                                ("ragged", (3, 200, 100, 500)),
                                # every byte value, not only 0 and 1: 2v - 1 each
                                ("bytes 0-255", (3, 200, 100, 500))]:
        q, p = bits(g, b, k), bits(g, c, k)
        if label.startswith("bytes"):
            q, p = (torch.randint(0, 256, x.shape, generator=gen, device=dev,
                                  dtype=torch.uint8) for x in (q, p))
        qb = (2 * q.to(torch.bfloat16) - 1).contiguous()
        pbt = (2 * p.to(torch.bfloat16) - 1).transpose(1, 2).contiguous()
        cases.append(("assoc_matmul", f"{label} B={b} C={c} K={k}",
                      lambda q=q, p=p: tk.assoc_matmul_banked(q, p),
                      lambda q=q, p=p: assoc_matmul_ref(q, p),
                      lambda qb=qb, pbt=pbt: torch.bmm(qb, pbt),
                      *assoc_ops.cost(g, b, c, k)))
    for label, (m, b, d) in [("serve wired", (3, 256, 512)), ("tall", (3, 4096, 2048))]:
        x = bits(m, b, d)
        cases.append(("majority_bundle", f"{label} M={m} B={b} d={d}",
                      lambda x=x: tk.majority_bundle(x),
                      lambda x=x, m=m: majority_bundle_ref(x.reshape(m, -1)).reshape(x.shape[1:]),
                      lambda x=x: torch.mode(x, 0).values,   # odd M: the mode is the majority
                      *majority_ops.cost(m, b * d)))
    # every byte value at M = 300 (past the 16-bit lanes' 257-row flush; even
    # M, so ties give 0); N odd (the byte-wise path and tail); a base one byte
    # past an aligned address (a sliced input)
    full = torch.randint(0, 256, (300, 64, 512), generator=gen, device=dev, dtype=torch.uint8)
    odd = bits(4, 7, 333)
    offset = bits(3 * 256 * 512 + 1)[1:].view(3, 256, 512)
    for label, x in [("bytes 0-255", full), ("odd N, even M", odd), ("base offset by 1 byte", offset)]:
        m, b, d = x.shape
        cases.append(("majority_bundle", f"{label} M={m} B={b} d={d}",
                      lambda x=x: tk.majority_bundle(x),
                      lambda x=x, m=m: majority_bundle_ref(x.reshape(m, -1)).reshape(x.shape[1:]),
                      None, *majority_ops.cost(m, b * d)))
    return cases


def sparse_kernel_cases(torch, gen):
    """The two sparse kernels' cases, as `kernel_cases` gives them plus a
    dict of extras: ``lib_eager`` (time the library call eagerly: a
    cuSPARSE product is not captured in a CUDA graph here) and ``expect``
    (a check of the result beyond equality with the plain version). Queries
    are random index lists at density >= 0.001, lists with every slot live,
    and lists on the edges of the kernels' segments (`plan`) and of the row;
    every list is checked sorted and SENTINEL-padded, the kernels'
    precondition. The prototypes are random words (about half their bits
    set)."""
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv, sparse
    from repro_torch.kernels.sparse.ops import plan, search_cost, topk_cost
    from repro_torch.kernels.sparse.ref import sparse_search_ref, sparse_topk_banked_ref

    dev, S = "cuda", sparse.SENTINEL

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def sorted_lists(q):
        """The kernels' precondition, held on every list they are fed: each
        row strictly increasing up to its SENTINEL padding."""
        require(bool((q[..., 1:] > q[..., :-1]).logical_or(q[..., 1:] == S).all()),
                "sparse kernel cases: index lists not sorted or not SENTINEL-padded")
        return q

    def lists(n, d, k, density, empty=()):
        q = sparse.random_sparse(gen, n, d, k, density, dev)
        q[list(empty)] = S                  # all-SENTINEL rows, as padded batch rows are
        return sorted_lists(q)

    def live(q):
        return int((q != S).sum())

    def full(n, d, k):
        """Lists with all k slots live (as the bsc serve's are), one index in
        each of k equal strides of the row."""
        stride = d // k
        return sorted_lists((torch.arange(k, device=dev, dtype=torch.int32) * stride
                             + torch.randint(0, stride, (n, k), generator=gen, device=dev,
                                             dtype=torch.int32)).contiguous())

    def edges(n, d, k, wseg, density):
        """Random lists but the first four: the first and last bits of the row
        and of the kernels' first segment boundary; every segment's first and
        last bit; live slots all inside one (middle) segment; empty."""
        seg, nseg = 32 * wseg, -(-d // (32 * wseg))
        q = sparse.random_sparse(gen, n, d, k, density, dev)
        mid = nseg // 2 * seg
        one = torch.randperm(min(seg, d - mid), generator=gen, device=dev)[:min(k, 300)] + mid
        special = [sorted({b for b in (0, seg - 1, seg, d - 1) if b < d}),
                   sorted({b for i in range(nseg) for b in (i * seg, min(d, (i + 1) * seg) - 1)}),
                   sorted(one.tolist()), []]
        for r, idx in enumerate(special):
            idx = idx[:k]
            q[r] = S
            q[r, :len(idx)] = torch.tensor(idx, dtype=torch.int32, device=dev)
        return sorted_lists(q)

    cases = []
    for label, (b, c, w, k, dens, empty, lib) in [
            ("trials", (2000, 100, 32768, 2048, SPARSE_DENSITY, (), True)),
            ("serve-wide", (256, 6400, 32768, 2048, SPARSE_DENSITY, (), False)),
            ("ragged", (77, 333, 1000, 2097, 0.04, (3, 4, 5), False)),
            ("a class tile and one", (40, 129, 1000, 2097, 0.04, (), False)),
            ("segment edges", (40, 100, 32768, 2048, SPARSE_DENSITY, (), False)),
            ("d = 2^21", (20, 150, 65536, 4096, SPARSE_DENSITY, (), False))]:
        q, p = lists(b, 32 * w, k, dens, empty), words(c, w)
        if label == "segment edges":
            q = edges(b, 32 * w, k, plan(b, c, w, search=True).wseg, dens)
        libfn, extra = None, {}
        if lib:
            # the overlap |q AND p| by cuSPARSE: the queries as a CSR f32
            # matrix [B, d] times the unpacked prototypes [d, C] f32, all of
            # the kernel's work but two adds
            valid = q != S
            crow = torch.zeros(b + 1, dtype=torch.int64, device=dev)
            crow[1:] = valid.sum(1).cumsum(0)
            col = q[valid].to(torch.int64)
            with warnings.catch_warnings():     # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                csr = torch.sparse_csr_tensor(crow, col, torch.ones(col.numel(), device=dev),
                                              size=(b, 32 * w), check_invariants=True)
            dense = hv.unpack(p, 32 * w).T.float().contiguous()
            libfn, extra = (lambda csr=csr, dense=dense: torch.sparse.mm(csr, dense)), dict(
                lib_eager=True, lib_what=f"CSR f32 [B, d] x f32 [d, C] ({dense.numel() * 4} B)")
        cases.append(("sparse_search", f"{label} B={b} C={c} k={k} W={w}",
                      lambda q=q, p=p: tk.sparse_search(q, p),
                      lambda q=q, p=p: sparse_search_ref(q, p), libfn,
                      *search_cost(b, c, w, k, live=live(q)), extra))
    for label, (g, b, c, c_real, w, k, dens, empty) in [
            ("serve G=64", (64, 256, 100, 100, 32768, 2048, SPARSE_DENSITY, ())),
            ("ragged", (3, 77, 333, 300, 1000, 2097, 0.04, (2, 80, 150))),
            ("full lists, serve G=64", (64, 256, 100, 100, 32768, 2048, None, ())),
            ("a class tile and one", (2, 40, 129, 129, 1000, 2097, 0.04, ())),
            ("segment edges", (2, 40, 100, 100, 32768, 2048, SPARSE_DENSITY, ())),
            ("d = 2^21", (2, 20, 150, 150, 65536, 4096, SPARSE_DENSITY, ()))]:
        if dens is None:
            q = full(g * b, 32 * w, k).reshape(g, b, k)
        elif label == "segment edges":
            wseg = plan(b, c_real, w, banks=g).wseg
            q = edges(g * b, 32 * w, k, wseg, dens).reshape(g, b, k)
        else:
            q = lists(g * b, 32 * w, k, dens, empty).reshape(g, b, k)
        p = words(g, c, w)
        cases.append(("sparse_topk_banked", f"{label} B={b} C={c} c_real={c_real} k={k} W={w}",
                      lambda q=q, p=p, cr=c_real: tk.sparse_topk_banked(q, p, c_real=cr),
                      lambda q=q, p=p, cr=c_real: sparse_topk_banked_ref(q, p, cr), None,
                      *topk_cost(g, b, c, w, k, c_real, live=live(q)), {}))
    # duplicates of query 0's bank row across tile boundaries (32 rows a tile
    # at W = 1000, one at W = 32768): the first copy must win at distance 0
    for w, k, dens, dups in [(1000, 2097, 0.04, (31, 32, 64)), (32768, 2048, SPARSE_DENSITY,
                                                              (5, 6, 99))]:
        g, b, c = 2, 40, 100
        q = lists(g * b, 32 * w, k, dens).reshape(g, b, k)
        p = words(g, c, w)
        p[:, list(dups)] = hv.pack(sparse.densify(q[:, 0], 32 * w))[:, None, :]

        def expect(got, first=dups[0]):
            dist, idx = got
            return bool((idx[:, 0] == first).all() and (dist[:, 0] == 0).all())

        cases.append(("sparse_topk_banked", f"ties at {dups} B={b} C={c} k={k} W={w}",
                      lambda q=q, p=p: tk.sparse_topk_banked(q, p),
                      lambda q=q, p=p: sparse_topk_banked_ref(q, p), None,
                      *topk_cost(g, b, c, w, k, live=live(q)), dict(expect=expect)))
    return cases


def hamming_k_cases(torch, gen):
    """The fused top-k's and the per-bank search's cases, as
    `sparse_kernel_cases` gives them: the coarse screen's shape (G = 8 cores,
    B = 512, 1600 group summaries of W = 64 words, k = 8) and the recall
    oracle's (12,800 rows per core) first, then ragged shapes, ties across
    the kernel's 128-row tiles, k = 1 against the top-1 kernel, and k at the
    kernel's limit."""
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv
    from repro_torch.kernels.hamming.ops import CLASS_TILE, MAX_K, plan, search_cost, topk_cost
    from repro_torch.kernels.hamming.ref import (hamming_search_banked_ref,
                                                 hamming_topk_k_banked_ref)

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def topk_case(label, g, b, c, w, k, c_real=None, p=None, q=None, expect=None):
        q = words(g, b, w) if q is None else q
        p = words(g, c, w) if p is None else p
        cr = c if c_real is None else c_real
        return ("hamming_topk_k_banked", f"{label} G={g} B={b} C={c} c_real={cr} W={w} k={k}",
                lambda: tk.hamming_topk_banked(q, p, k=k, c_real=cr),
                lambda: hamming_topk_k_banked_ref(q, p, k, cr), None,
                *topk_cost(g, b, cr, w, k),
                {} if expect is None else dict(expect=expect))

    cases = [topk_case("screen", 8, 512, 1600, 64, 8),
             topk_case("bank screen", 64, 256, 50, 16, 8),   # under one tile
             topk_case("ragged", 3, 77, 333, 16, 5, c_real=300),
             # the last split ends at c_real, inside its last tile
             topk_case("c_real inside the last split", 8, 512, 1600, 64, 8, c_real=1550),
             # k past one split's classes (6 splits of one 128-class tile)
             topk_case("k past a split's classes", 2, 100, 700, 64, 150, c_real=650),
             topk_case("k past a split's classes, W=5", 1, 64, 1600, 5, 200)]
    # eight equal copies of query 0's row straddle the boundary of splits 1
    # and 2 of the screen's plan: ranks 0-7 are those columns, lowest first
    splits = plan(8, 512, 1600, torch.cuda.get_device_properties(0).multi_processor_count)
    edge = CLASS_TILE * (2 * 13 // splits)       # split 2's first tile of 13
    q, p = words(8, 512, 64), words(8, 1600, 64)
    p[:, edge - 4:edge + 4] = q[:, :1]
    want_i = torch.arange(edge - 4, edge + 4, device="cuda", dtype=torch.int32)
    cases.append(topk_case(f"equal rows across the split edge at {edge}", 8, 512, 1600, 64, 8,
                           p=p, q=q, expect=lambda got, want=want_i: bool(
                               (got[1][:, 0] == want).all() and (got[0][:, 0] == 0).all())))
    # every row identical: rank r is column r, across five tiles
    same = words(2, 1, 64).expand(2, 600, 64).contiguous()
    cases.append(topk_case("all rows equal", 2, 40, 600, 64, 12, p=same, expect=lambda got: bool(
        (got[1] == torch.arange(12, device="cuda", dtype=torch.int32)).all()
        and (got[0] == got[0][..., :1]).all())))
    # query 0's rows at 0..11 bits, at 122..133 and again at 250..261 (both
    # copies straddle a tile edge): ranks (0,122), (0,250), (1,123), ...
    q = words(2, 8, 64)
    p = words(2, 384, 64)
    for at in (122, 250):
        for j in range(12):
            p[:, at + j] = q[:, 0]
            p[:, at + j, 0] ^= (1 << j) - 1
    want_i = torch.tensor([122, 250, 123, 251, 124, 252], device="cuda", dtype=torch.int32)
    want_d = torch.tensor([0, 0, 1, 1, 2, 2], device="cuda", dtype=torch.int32)
    cases.append(topk_case("duplicates across tiles", 2, 8, 384, 64, 6, p=p, q=q,
                           expect=lambda got: bool((got[0][:, 0] == want_d).all()
                                                   and (got[1][:, 0] == want_i).all())))
    def as_top1(got, q, p):
        d1, i1 = tk.hamming_topk_banked(q, p)
        return torch.equal(got[0][..., 0], d1) and torch.equal(got[1][..., 0], i1)

    # k = 1 against the top-1 kernel, at the screen's shape and at the flat
    # serve's (C = 102,400 over 8 cores), where its time stands beside the top-1's
    for label, c in [("k=1 == top-1 kernel", 1600), ("k=1 == top-1 kernel, flat C=102,400", 12800)]:
        q, p = words(8, 512, 64), words(8, c, 64)
        cases.append(topk_case(label, 8, 512, c, 64, 1, p=p, q=q,
                               expect=lambda got, q=q, p=p: as_top1(got, q, p)))
    q, p = words(8, 64, 64), words(8, 1600, 64)

    def over_the_limit_raises(got, q=q, p=p):
        try:
            tk.hamming_topk_banked(q, p, k=MAX_K + 1)
        except ValueError as e:
            return "MAX_K" in str(e)
        return False

    cases.append(topk_case("k at the limit (k + 1 raises)", 8, 64, 1600, 64, MAX_K, p=p, q=q,
                           expect=over_the_limit_raises))
    for label, (g, b, c, w) in [("recall oracle", (8, 512, 12800, 64)),
                                ("ragged", (3, 77, 333, 5)),
                                # 128-query tiles, B past a tile, C % 4 != 0
                                ("B and C off the tiles", (4, 200, 9001, 64)),
                                ("W=76", (2, 130, 700, 76))]:
        q, p = words(g, b, w), words(g, c, w)
        qf, pf = hv.unpack(q, 32 * w).float(), hv.unpack(p, 32 * w).float()
        cases.append(("hamming_search_banked", f"{label} G={g} B={b} C={c} W={w}",
                      lambda q=q, p=p: tk.hamming_search_banked(q, p),
                      lambda q=q, p=p: hamming_search_banked_ref(q, p),
                      lambda qf=qf, pf=pf: torch.cdist(qf, pf, p=0),   # batched, on bits
                      *search_cost(g, b, c, w),
                      bmm_yardstick(torch, hv, q, p)))
    return cases


def flash_cases(torch, gen):
    """The attention kernel's cases, as `sparse_kernel_cases` gives them: the
    prefill's shape first (TinyLlama-1.1B, B = 8, S = 1024), then gemma3-1b's
    layer shape at its full width (windowed and global), non-causal, a ragged
    length, a prefill chunk (q_offset = 512 over a 768-key prefix), f32 at
    the prefill's shape, deepseek-coder-33b's layer shape (B = 2), the two
    smallest head dims, a causal q_offset of -64 (queries 0-63 see no
    key and take the mean of V over all keys), phase 20's layers:
    Mixtral-8x22B's (48 heads over 8, D = 128, window 4096) at B = 8 x 1024
    and at B = 1 x 8192, past the window, and Kimi-K2's (64 heads over 8,
    D = 112) in bf16 and f32, phase 21's shared attention block,
    Zamba2-2.7B's (32 heads over 32, D = 80), in bf16 and f32, and phase
    22's layers: Whisper-tiny's encoder (B 32, non-causal over 1500 frames)
    and cross-attention (Sq 32 over Skv 1500, non-causal), and Qwen2-VL-7B's
    prefill (28 heads over 4, D = 128, 256 + 1024 positions). Tolerances: f32 atol = rtol =
    1e-5 (only the order of the sums differs); bf16 atol = rtol = 2e-2, compared in f32 (both
    sides round to bf16 once at the output). The library call is
    F.scaled_dot_product_attention on the same tensors (is_causal where that
    is the mask, else an explicit boolean mask), timed eagerly."""
    import torch.nn.functional as F

    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention.ops import fwd_cost
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    cases = []
    for label, (b, sq, skv, h, kh, d, causal, win, off, dt) in [
            ("prefill", (8, 1024, 1024, 32, 4, 64, True, -1, 0, torch.bfloat16)),
            ("gemma3-1b local", (8, 1024, 1024, 4, 1, 256, True, 512, 0, torch.bfloat16)),
            ("gemma3-1b global", (8, 1024, 1024, 4, 1, 256, True, -1, 0, torch.bfloat16)),
            ("non-causal", (8, 512, 512, 32, 4, 64, False, -1, 0, torch.bfloat16)),
            ("ragged", (8, 1000, 1000, 32, 4, 64, True, -1, 0, torch.bfloat16)),
            ("chunk", (8, 256, 768, 32, 4, 64, True, -1, 512, torch.bfloat16)),
            ("f32 prefill", (8, 1024, 1024, 32, 4, 64, True, -1, 0, torch.float32)),
            ("deepseek-coder-33b", (2, 1024, 1024, 56, 8, 128, True, -1, 0, torch.bfloat16)),
            ("D=16", (2, 300, 300, 4, 2, 16, True, -1, 0, torch.bfloat16)),
            ("D=32", (2, 300, 300, 4, 2, 32, True, -1, 0, torch.bfloat16)),
            # queries 0-63 see no key: the mean of V over all 128 keys
            ("fully masked rows", (2, 128, 128, 4, 2, 64, True, -1, -64, torch.bfloat16)),
            # phase 20's layers: Mixtral-8x22B (window 4096 on every layer) at the
            # serve's shape and past its window, Kimi-K2 at D = 112
            ("mixtral-8x22b", (8, 1024, 1024, 48, 8, 128, True, 4096, 0, torch.bfloat16)),
            ("mixtral-8x22b windowed", (1, 8192, 8192, 48, 8, 128, True, 4096, 0,
                                        torch.bfloat16)),
            ("kimi-k2", (8, 1024, 1024, 64, 8, 112, True, -1, 0, torch.bfloat16)),
            ("kimi-k2 f32", (8, 1024, 1024, 64, 8, 112, True, -1, 0, torch.float32)),
            # phase 21's shared attention block: Zamba2-2.7B (32 heads over 32, D = 80)
            ("zamba2-2.7b", (8, 1024, 1024, 32, 32, 80, True, -1, 0, torch.bfloat16)),
            ("zamba2-2.7b f32", (8, 1024, 1024, 32, 32, 80, True, -1, 0, torch.float32)),
            # phase 22's layers: Whisper-tiny's encoder (non-causal over 1500 frames,
            # no multiple of any tile) and cross-attention (Sq 32 != Skv 1500), and
            # Qwen2-VL-7B's prefill of an image and its text (256 + 1024)
            ("whisper-tiny encoder", (32, 1500, 1500, 6, 6, 64, False, -1, 0,
                                      torch.bfloat16)),
            ("whisper-tiny cross", (32, 32, 1500, 6, 6, 64, False, -1, 0, torch.bfloat16)),
            ("qwen2-vl-7b", (8, 1280, 1280, 28, 4, 128, True, -1, 0, torch.bfloat16))]:
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, skv, kh, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=win, q_offset=off)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if win <= 0 and off == 0 and sq == skv:
            def lib(qt=qt, kt=kt, vt=vt, c=causal):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=c, enable_gqa=True)
        else:
            qp = off + torch.arange(sq, device="cuda")[:, None]
            kp = torch.arange(skv, device="cuda")[None, :]
            mask = (kp <= qp) if causal else torch.ones_like(qp - kp, dtype=torch.bool)
            if win > 0:
                mask &= (qp - kp) < win

            def lib(qt=qt, kt=kt, vt=vt, mask=mask):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
        tol = FLASH_F32_TOL if dt == torch.float32 else 2e-2
        cases.append((
            "flash_attention_fwd",
            f"{label} B={b} Sq={sq} Skv={skv} H={h} KH={kh} D={d} causal={causal} "
            f"window={win} q_offset={off} {str(dt).split('.')[-1]}",
            lambda q=q, k=k, v=v, kw=kw: tk.flash_attention_fwd(q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: flash_fwd_ref(q, k, v, **kw), lib,
            *fwd_cost(b, sq, skv, h, kh, d, causal, win, off, dt),
            dict(tol=(tol, tol), lib_eager=True,
                 lib_what="F.scaled_dot_product_attention (eager)")))
    return cases


def phase_kernels(torch, gen) -> dict:
    # the floor a launch sits on: one-element add_, timed as the kernels are
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(torch, lambda: one.add_(1))
    print(f"launch floor: one-element add_ {floor_ms:.6f} ms (CUDA-graph replay)", flush=True)
    results = {"launch_floor_ms": floor_ms}
    for case in kernel_cases(torch, gen) + hamming_k_cases(torch, gen) + sparse_kernel_cases(
            torch, gen) + flash_cases(torch, gen):
        name, label, kern, plain, lib, nbytes, ops, kind = case[:8]
        extra = case[8] if len(case) > 8 else {}
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                  for a, b in zip(got_t, want_t))
        if "tol" in extra:      # float kernels: within the stated tolerance, in f32
            atol, rtol = extra["tol"]
            near = all(torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol)
                       for a, b in zip(got_t, want_t))
            require(near, f"{name} [{label}] beyond atol {atol} rtol {rtol} of its plain "
                          f"version (max |err| {err})")
            verdict = f"within atol {atol} rtol {rtol} (max |err| {err:.3g})"
        else:
            exact = all(torch.equal(a, b) for a, b in zip(got_t, want_t))
            require(exact, f"{name} [{label}] differs from its plain version (max |err| {err})")
            verdict = "bit-exact"
        if "expect" in extra:
            require(extra["expect"](got), f"{name} [{label}]: fails its expected-result check")
        ms, eager_ms = time_ms(torch, kern), call_ms(torch, kern)
        plain_ms = time_ms(torch, plain, samples=3)
        lib_timer = call_ms if extra.get("lib_eager") else time_ms
        lib_ms = lib_timer(torch, lib, samples=3) if lib is not None else None
        bmm_ms = time_ms(torch, extra["bmm"], samples=3) if "bmm" in extra else None
        # products with a peak for their type (b1: measured); gathers and
        # int32 counts have no published peak and are bytes bound
        bound_s, bound_by = kernel_bound(nbytes, ops, kind)
        bound_ms = bound_s * 1e3
        row = dict(shape=label, max_abs_err=err, ms=ms, call_ms=eager_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bmm_ms=bmm_ms,
                   bound_by=bound_by, library_ms=lib_ms, bytes=nbytes, ops=ops, op_kind=kind,
                   library_what=extra.get("lib_what"), tol=extra.get("tol"))
        results.setdefault(name, []).append(row)
        print(f"kernel {name} [{label}]: {verdict}, {ms:.4f} ms (eager call {eager_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, "
              f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms"
              f"{'' if bmm_ms is None else f', bf16 bmm {bmm_ms:.5f} ms'}, bound "
              f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B, {ops} {kind} ops)", flush=True)
    return results


# ---------------------------------------------------------------------------
# phases 4-5: the serves
# ---------------------------------------------------------------------------

def serve_setup(torch, base, mode, protos_u, device):
    """One serve mode: (label, cfg, serve fn, its prototypes, CALLS batches of
    (classes, queries), noise generator). The query and noise generators are
    seeded alike in every mode, so every mode sees the same draws."""
    import dataclasses

    from repro_torch.core import hypervector as hv
    from repro_torch.core import scaleout

    kind, ch, perm, rep = mode
    cfg = dataclasses.replace(base, channel=ch, permuted=perm, representation=rep)
    make = scaleout.make_ota_serve if kind == "ota" else scaleout.make_wired_serve
    label = (f"ota {ch} {'permuted' if perm else 'baseline'} {rep}" if kind == "ota"
             else f"wired {rep}")
    gq = torch.Generator(device=device).manual_seed(1)
    batches = [scaleout.make_queries(gq, cfg, protos_u) for _ in range(CALLS)]
    return (label, cfg, make(cfg, device=device), hv.pack(protos_u) if cfg.packed else protos_u,
            batches, torch.Generator(device=device).manual_seed(2))


def run_serve(torch, base, mode, protos_u, state, device):
    """CALLS serve calls of one mode with the launch counters set to 0 just
    before and read just after; returns predictions, maxsims, classes, the
    noise-free reference's predictions and maxsims, per-call ms and kernel
    launches."""
    from repro_torch import kernels as tk
    from repro_torch.core import scaleout

    label, cfg, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    preds, sims, ms = [], [], []
    tk.reset_launch_counts()
    for _, q in batches:
        t0 = time.perf_counter()
        pred, sim = serve(protos, q, state, gn)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        preds.append(pred)
        sims.append(sim)
    counts = tk.launch_counts()
    refs = [scaleout.serve_reference(cfg, protos, q) for _, q in batches]
    return dict(label=label, pred=torch.cat(preds), sim=torch.cat(sims),
                classes=torch.cat([c for c, _ in batches]), ms=ms, counts=counts,
                ref_pred=torch.cat([r[0] for r in refs]),
                ref_sim=torch.cat([r[1] for r in refs]))


def hit_rate(torch, run, permuted: bool) -> dict:
    from repro_torch.core import classifier

    if permuted:
        return classifier.serve_accuracy(run["pred"], run["classes"])
    sent = (run["pred"][:, None] == run["classes"]).any(1)
    return {"hit": float(sent.float().mean())}


def phase_serves(torch, state, protos_u, base, device="cuda") -> dict:
    """Phases 4-5 at configuration `base` (the paper's on the card)."""
    launches = dict.fromkeys(KERNELS, 0)
    runs = {}
    for mode in MODES:
        run = runs[mode] = run_serve(torch, base, mode, protos_u, state, device)
        want = SERVE_KERNELS[(mode[0], mode[3])]
        require(all(run["counts"][k] > 0 for k in want),
                f"{run['label']}: {want} not all launched {run['counts']}")
        require(all(v == 0 for k, v in run["counts"].items() if k not in want),
                f"{run['label']}: unexpected launches {run['counts']}")
        for name, n in run["counts"].items():
            launches[name] += n
        run["acc"] = hit_rate(torch, run, mode[2])
        print(f"serve {run['label']}: {CALLS} calls x batch {base.batch}, "
              f"{statistics.median(run['ms']):.3f} ms/call median "
              f"(first {run['ms'][0]:.3f}), {json.dumps(run['acc'])}, launches {run['counts']}",
              flush=True)
    for kind, ch, perm, rep in MODES:
        run = runs[(kind, ch, perm, rep)]
        if rep == "packed":
            u = runs[(kind, ch, perm, "unpacked")]
            require(torch.equal(u["pred"], run["pred"]) and torch.equal(u["sim"], run["sim"]),
                    f"{run['label']}: differs from the unpacked serve")
        if kind == "wired" or ch == "ideal":
            require(torch.equal(run["pred"], run["ref_pred"])
                    and torch.equal(run["sim"], run["ref_sim"]),
                    f"{run['label']}: differs from serve_reference")
    require(runs[("ota", "bsc", False, "unpacked")]["acc"]["hit"] > 0.9,
            "bsc baseline: fewer than 90% of trials answered from the sent set")
    print("serve checks: packed == unpacked in every mode, ideal and wired == "
          "serve_reference (predictions and maxsim)", flush=True)
    return {"launches": launches, "runs": {
        r["label"]: dict(ms=r["ms"], acc=r["acc"], counts=r["counts"]) for r in runs.values()}}


def phase_flip_rate(torch, state, cfg) -> dict:
    """The bsc tier alone at the serve shape: CALLS draws of every core's
    copy of an all-zero bundle. Each core's flip rate must lie within 5 sigma
    of ``state.ber`` (binomial sigma over the bits drawn), and the packed
    tier's draw on the same seed must unpack to the unpacked one."""
    from repro_torch import phy
    from repro_torch.core import hypervector as hv

    chan, n = phy.get_channel("bsc"), cfg.n_rx_cores
    zeros = torch.zeros((cfg.batch, cfg.dim), dtype=torch.uint8, device="cuda")
    flips = torch.zeros(n, dtype=torch.float64, device="cuda")
    for seed in range(CALLS):
        draws = [chan.rx_copies(torch.Generator(device="cuda").manual_seed(100 + seed),
                                hv.pack(zeros) if packed else zeros, state, 0, n,
                                packed=packed, dim=cfg.dim, noise=cfg.noise)
                 for packed in (False, True)]
        require(torch.equal(hv.unpack(draws[1], cfg.dim), draws[0]),
                "bsc: the packed draw differs from the unpacked one")
        flips += draws[0].sum((1, 2), dtype=torch.float64)
    bits = CALLS * cfg.batch * cfg.dim
    ber = state.ber.double()
    rate = flips / bits
    sigma = (ber * (1 - ber) / bits).sqrt()
    z = float(((rate - ber).abs() / sigma.clamp_min(1e-300)).max())
    require(bool(((rate - ber).abs() <= 5 * sigma + 1e-12).all()),
            f"bsc: a core's flip rate is more than 5 sigma from its BER (max {z:.2f} sigma)")
    print(f"bsc flip rate: {n} cores x {bits} bits, within 5 sigma of each core's BER "
          f"(max {z:.3f} sigma), packed draw == unpacked", flush=True)
    return dict(bits_per_core=bits, max_sigma=z)


# ---------------------------------------------------------------------------
# phases 7-9: Table I, the sparse trials, the sparse serve
# ---------------------------------------------------------------------------

def counted(torch, fn):
    """(result, seconds, launch counts) of one main-path call, the counters
    set to 0 just before and read just after."""
    from repro_torch import kernels as tk

    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, tk.launch_counts()


def require_only(counts: dict, want: tuple, what: str) -> None:
    require(all(counts[k] > 0 for k in want) and
            all(v == 0 for k, v in counts.items() if k not in want),
            f"{what}: launches {counts}, expected {want} and nothing else")


def add_launches(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


@contextlib.contextmanager
def recorded(module, name: str):
    """Within the block, every call of ``module.name`` runs unchanged and
    appends its (positional arguments, result) to the list this yields."""
    orig, log = getattr(module, name), []

    def wrapper(*args, **kwargs):
        log.append((args, orig(*args, **kwargs)))
        return log[-1][1]

    setattr(module, name, wrapper)
    try:
        yield log
    finally:
        setattr(module, name, orig)


def phase_table1(torch, wireless_ber: float, launches: dict) -> dict:
    """Table I at the paper's task: 48 calls of `classifier.run_trials`."""
    from repro_torch.core import classifier

    cfg = classifier.HDCTaskConfig()
    flags, rows, call_s = {}, {}, []
    for rep in ("unpacked", "packed"):
        for bundling in ("baseline", "permuted"):
            want = (("assoc_matmul",) if rep == "unpacked" else
                    ("hamming_search",) if bundling == "baseline" else ("hamming_topk_banked",))
            for name, channel, ber in (("ideal", "ideal", 0.0),
                                       ("wireless", "bsc", wireless_ber)):
                accs = []
                for m in TABLE1_MS:
                    f, sec, counts = counted(torch, lambda: classifier.run_trials(
                        SEED, cfg, m, ber, bundling, representation=rep, channel=channel))
                    require_only(counts, want, f"table1 {rep} {bundling} {name} M={m}")
                    add_launches(launches, counts)
                    call_s.append(sec)
                    flags[(rep, bundling, name, m)] = f
                    accs.append(float(f.float().mean()))
                rows[(rep, bundling, name)] = accs
    for (rep, bundling, name, m), f in flags.items():
        if rep == "packed":
            require(torch.equal(f, flags[("unpacked", bundling, name, m)]),
                    f"table1 {bundling} {name} M={m}: packed differs from unpacked")
    require(all(accs[0] == 1.0 for accs in rows.values()), "table1: an M = 1 cell is not 1.0")
    p = 0.99 * 0.98                        # prod(1 - i/C), i < M = 3, C = 100
    acc3 = rows[("unpacked", "baseline", "ideal")][1]
    sigma = (p * (1 - p) / cfg.n_trials) ** 0.5
    require(abs(acc3 - p) <= 5 * sigma,
            f"table1 ideal baseline M=3: {acc3} is more than 5 sigma from {p:.4f}")
    for bundling in ("baseline", "permuted"):
        for name in ("ideal", "wireless"):
            print(f"table1 {bundling:8s} {name:8s} M={TABLE1_MS}: "
                  f"{rows[('unpacked', bundling, name)]} (paper {PAPER_TABLE1[(bundling, name)]})",
                  flush=True)
    print(f"table1 checks: packed == unpacked trial for trial in all 24 cells, M = 1 cells "
          f"1.0, ideal baseline M=3 {acc3} within 5 sigma of {p:.4f}; "
          f"{statistics.median(call_s) * 1e3:.3f} ms per call median "
          f"(max {max(call_s) * 1e3:.3f})", flush=True)
    return dict(rows={" ".join(k): v for k, v in rows.items()}, wireless_ber=wireless_ber,
                call_ms=[x * 1e3 for x in call_s])


def phase_sparse_trials(torch, ber: float, launches: dict) -> dict:
    """Sparse trials at d = 2^20, each run's search held against a dense
    oracle; at d = 8192 the three representations' searches held equal."""
    from repro_torch.core import classifier, hypervector as hv, sparse
    from repro_torch.kernels.hamming.ref import hamming_search_ref

    cfg = classifier.HDCTaskConfig(dim=SPARSE_DIM)
    out = {}
    for channel, b in (("ideal", 0.0), ("bsc", ber)):
        for m in (1, 3):
            with recorded(classifier, "sparse_search") as log:
                f, sec, counts = counted(torch, lambda: classifier.run_trials(
                    SEED, cfg, m, b, representation="sparse", channel=channel,
                    density=SPARSE_DENSITY, k_max=SPARSE_K))
            require_only(counts, ("sparse_search",), f"sparse trials {channel} M={m}")
            add_launches(launches, counts)
            require(len(log) == 1, f"sparse trials {channel} M={m}: {len(log)} searches")
            (qs, protos), dist = log[0]
            # every 25th trial's distances from the densified, packed query
            oracle = hamming_search_ref(hv.pack(sparse.densify(qs[::25], SPARSE_DIM)), protos)
            require(torch.equal(dist[::25], oracle),
                    f"sparse trials {channel} M={m}: distances differ from the dense oracle")
            out[f"{channel} M={m}"] = dict(acc=float(f.float().mean()), s=sec,
                                           live=float(sparse.count(qs).float().mean()))
            print(f"sparse trials d=2^20 k_max={SPARSE_K} {channel} M={m}: accuracy "
                  f"{out[f'{channel} M={m}']['acc']}, {sec:.3f} s, "
                  f"{out[f'{channel} M={m}']['live']:.1f} live indices per query", flush=True)
    require(out["ideal M=1"]["acc"] == 1.0, "sparse trials: ideal M=1 accuracy is not 1.0")
    # at d = 8192 (not counted: a check, not the main path) the three
    # representations search the same trials: equal distances, equal dots
    narrow = classifier.HDCTaskConfig(dim=NARROW_DIM)
    searches = {"sparse": "sparse_search", "packed": "hamming_search",
                "unpacked": "assoc_matmul"}
    for m in (1, 3):
        flags, found = {}, {}
        for rep, fn in searches.items():
            with recorded(classifier, fn) as log:
                flags[rep], _, counts = counted(torch, lambda: classifier.run_trials(
                    SEED, narrow, m, 0.0, representation=rep, channel="ideal",
                    density=NARROW_DENSITY, k_max=NARROW_K))
            require(len(log) == 1, f"sparse trials d=8192 M={m} {rep}: {len(log)} searches")
            found[rep] = log[0][1]
            if rep == "sparse":
                require_only(counts, ("sparse_search",), f"sparse trials d=8192 M={m}")
        require(torch.equal(found["sparse"], found["packed"]) and
                torch.equal((NARROW_DIM - 2 * found["sparse"]).float(), found["unpacked"]),
                f"sparse trials d=8192 M={m}: the sparse, packed and unpacked searches differ")
        require(torch.equal(flags["sparse"], flags["packed"]) and
                torch.equal(flags["packed"], flags["unpacked"]),
                f"sparse trials d=8192 M={m}: sparse, packed and unpacked differ")
        out[f"d=8192 M={m}"] = float(flags["sparse"].float().mean())
    print(f"sparse trials checks: ideal M=1 accuracy 1.0 at d=2^20; every 25th trial's "
          f"distances == the dense oracle in all four runs; at d=8192 sparse == packed == "
          f"unpacked distances ({narrow.n_trials} x {narrow.n_classes}) and flags (accuracy "
          f"M=1 {out['d=8192 M=1']}, M=3 {out['d=8192 M=3']})", flush=True)
    return out


def rate_sigmas(counts, n: int, p):
    """Per-core distance of observed Bernoulli counts from n*p, in binomial
    sigmas. A float32 uniform draw compared with p cannot resolve p below its
    2^-24 step, so p is floored there, and one count of slack covers the
    discreteness where n*p is small (some cores' BER is ~1e-12)."""
    p = p.clamp(min=2.0**-24)
    sigma = (n * p * (1 - p)).sqrt()
    return ((counts - n * p).abs() - 1).clamp(min=0) / sigma.clamp(min=1e-300)


def sparse_codebook(torch, gen, n: int, d: int, k_max: int, density: float):
    """Index lists [n, k_max] and packed words [n, d/32] of a random sparse
    codebook, packed 64 rows at a time (a dense [6400, 2^20] codebook is
    6.7 GB of bytes)."""
    from repro_torch.core import hypervector as hv, sparse

    codes = sparse.random_sparse(gen, n, d, k_max, density, "cuda")
    words = torch.cat([hv.pack(sparse.densify(codes[i:i + 64], d))
                       for i in range(0, n, 64)])
    return codes, words


def phase_sparse_serve(torch, state, launches: dict, profile: bool = False) -> dict:
    """The sparse serve at d = 2^20 over the paper's geometry (``profile``:
    also its ideal and bsc calls under torch.profiler)."""
    import dataclasses

    from repro_torch.core import hypervector as hv, scaleout, sparse
    from repro_torch.kernels.hamming.ref import hamming_search_ref

    base = scaleout.ScaleOutConfig(representation="sparse", collective="index_ag",
                                   dim=SPARSE_DIM, k_max=SPARSE_K)
    d, n_core = base.dim, base.n_rx_cores
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    codes, protos = sparse_codebook(torch, gen, base.n_classes, d, base.k_max, SPARSE_DENSITY)
    gq = torch.Generator(device="cuda").manual_seed(1)
    batches = [scaleout.make_queries(gq, base, codes) for _ in range(CALLS)]
    out, answers = {}, {}
    drops = torch.zeros(n_core, dtype=torch.float64, device="cuda")
    accepted = torch.zeros(n_core, dtype=torch.float64, device="cuda")
    live_total, slots_total = 0, 0
    for channel in ("ideal", "bsc"):
        cfg = dataclasses.replace(base, channel=channel)
        serve = scaleout.make_ota_serve(cfg)
        gn = torch.Generator(device="cuda").manual_seed(2)
        preds, sims, ms = [], [], []
        for classes, q in batches:
            with recorded(sparse, "_noise_draws") as drawn:     # the bsc draws it makes
                (pred, sim), sec, counts = counted(torch, lambda: serve(protos, q, state, gn))
            require_only(counts, ("sparse_topk_banked",), f"sparse serve {channel}")
            add_launches(launches, counts)
            ms.append(sec * 1e3)
            preds.append(pred)
            sims.append(sim)
            if channel == "ideal":              # a dense oracle on the first 16 trials
                bundled = hv.majority(sparse.densify(q[:16, 0], d).transpose(0, 1))
                dist = hamming_search_ref(hv.pack(bundled), protos)
                require(torch.equal(pred[:16], torch.argmin(dist, -1).to(torch.int32)) and
                        torch.equal(sim[:16], (d - 2 * dist.min(-1).values) / (2.0 * d) + 0.5),
                        "sparse serve ideal: differs from the dense oracle")
            else:
                require(len(drawn) == 1, "sparse serve bsc: not one draw per call")
                drop, _, acc = drawn[0][1]
                live = sparse.valid(sparse.bundle(q[:, 0]))[None]       # [1, B, k]
                drops += (drop & live).sum((1, 2), dtype=torch.float64)
                accepted += acc.sum((1, 2), dtype=torch.float64)
                live_total += int(live.sum())
                slots_total += live.numel()
        pred, classes = torch.cat(preds), torch.cat([c for c, _ in batches])
        hit = float((pred[:, None] == classes).any(1).float().mean())
        answers[channel] = (preds, sims)
        out[channel] = dict(ms=ms, hit=hit)
        print(f"sparse serve {channel}: {CALLS} calls x batch {base.batch}, "
              f"{statistics.median(ms):.3f} ms/call median (first {ms[0]:.3f}), hit rate "
              f"{hit} (reported, not gated)", flush=True)
    # the drop rate of live indices, and the insertion acceptance, per core
    ber = state.ber.double()[:n_core]
    z_drop = rate_sigmas(drops, live_total, ber)
    z_ins = rate_sigmas(accepted, slots_total, torch.clamp(ber * (d / base.k_max), max=1.0))
    require(float(z_drop.max()) <= 5, f"sparse bsc: a core's drop rate is more than 5 sigma "
                                      f"from its BER (max {float(z_drop.max()):.2f} sigma)")
    require(float(z_ins.max()) <= 5, f"sparse bsc: a core's insertion rate is more than 5 sigma "
                                     f"from min(1, ber*d/k_max) (max {float(z_ins.max()):.2f} sigma)")
    # the psum wire and representation="auto" answer as index_ag does
    for channel in ("ideal", "bsc"):
        for variant in (dict(collective="psum"), dict(representation="auto", collective="psum")):
            cfg = dataclasses.replace(base, channel=channel, **variant)
            if variant.get("representation") == "auto":
                require(scaleout.resolve_representation(cfg).representation == "sparse",
                        "representation='auto' does not resolve to sparse at d = 2^20")
                if channel == "bsc":
                    continue
            gn = torch.Generator(device="cuda").manual_seed(2)
            (pred, sim), _, counts = counted(
                torch, lambda: scaleout.make_ota_serve(cfg)(protos, batches[0][1], state, gn))
            require_only(counts, ("sparse_topk_banked",), f"sparse serve {channel} {variant}")
            add_launches(launches, counts)
            want_p, want_s = answers[channel][0][0], answers[channel][1][0]
            require(torch.equal(pred, want_p) and torch.equal(sim, want_s),
                    f"sparse serve {channel} {variant}: differs from index_ag")
    # at d = 8192 (not counted: a check, not the main path) the ideal sparse
    # serve answers as the packed serve
    narrow = dataclasses.replace(base, dim=NARROW_DIM, k_max=NARROW_K, channel="ideal")
    codes8, protos8 = sparse_codebook(torch, gen, base.n_classes, NARROW_DIM, NARROW_K,
                                      NARROW_DENSITY)
    packed = dataclasses.replace(narrow, representation="packed", collective="psum", k_max=0)
    g8 = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(2):
        _, q8 = scaleout.make_queries(g8, narrow, codes8)
        (sp, ss), _, counts = counted(
            torch, lambda: scaleout.make_ota_serve(narrow)(protos8, q8, state, None))
        require_only(counts, ("sparse_topk_banked",), "sparse serve d=8192")
        q8p = hv.pack(sparse.densify(q8, NARROW_DIM))
        pp, ps = scaleout.make_ota_serve(packed)(protos8, q8p, state, None)
        require(torch.equal(sp, pp) and torch.equal(ss, ps),
                "sparse serve d=8192: differs from the packed serve")
    print(f"sparse serve checks: ideal == dense oracle (16 trials x {CALLS} calls), psum == "
          f"index_ag and auto -> sparse, d=8192 sparse == packed; bsc drop rate within 5 sigma "
          f"of each core's BER (max {float(z_drop.max()):.3f} sigma over {live_total} live "
          f"indices), insertion rate within 5 sigma of min(1, ber*d/k_max) (max "
          f"{float(z_ins.max()):.3f} sigma)", flush=True)
    out["bsc_rates"] = dict(live=live_total, slots=slots_total,
                            max_sigma_drop=float(z_drop.max()), max_sigma_ins=float(z_ins.max()))
    if profile:
        for channel in ("ideal", "bsc"):
            serve = scaleout.make_ota_serve(dataclasses.replace(base, channel=channel))
            gn = torch.Generator(device="cuda").manual_seed(2)
            out[f"profile {channel}"] = profile_calls(torch, f"sparse serve {channel}", [
                lambda q=q: serve(protos, q, state, gn) for _, q in batches])
    return out


# ---------------------------------------------------------------------------
# phase 10: coarse-to-fine search and the multi-centroid memory
# ---------------------------------------------------------------------------

def coarse_serves(torch, base, protos_u, protos_p, state, launches, log=None):
    """CALLS calls of each of the flat and coarse serves, packed and
    unpacked, on the same query and noise seeds; each call's launches are
    checked and added to ``launches``. ``log``
    (a list) receives the recorded (args, result) of every packed coarse
    call's screen and `_coarse_fine_packed`."""
    import dataclasses

    from repro_torch.core import hypervector as hv, scaleout

    kernels = {("packed", False): ("hamming_topk_banked",),
               ("packed", True): ("hamming_topk_k_banked",),
               ("unpacked", False): ("assoc_matmul",), ("unpacked", True): ("assoc_matmul",)}
    gq = torch.Generator(device="cuda").manual_seed(1)
    batches = [scaleout.make_queries(gq, base, protos_u) for _ in range(CALLS)]
    runs = {}
    for rep in ("packed", "unpacked"):
        for coarse in (False, True):
            cfg = dataclasses.replace(base, representation=rep,
                                      coarse_group=COARSE_GS if coarse else 0)
            serve = scaleout.make_ota_serve(cfg)
            protos = protos_p if cfg.packed else protos_u
            gn = torch.Generator(device="cuda").manual_seed(2)
            preds, sims, ms = [], [], []
            for _, q in batches:
                q = hv.pack(q) if cfg.packed else q
                with contextlib.ExitStack() as stack:
                    if log is not None and coarse and cfg.packed:
                        fine = stack.enter_context(recorded(scaleout, "_coarse_fine_packed"))
                        screen = stack.enter_context(recorded(scaleout, "hamming_topk_banked"))
                    (pred, sim), sec, counts = counted(torch, lambda: serve(protos, q, state, gn))
                    if log is not None and coarse and cfg.packed:
                        log.append((fine[0], screen[0]))
                require_only(counts, kernels[(rep, coarse)],
                             f"coarse phase {rep} {'coarse' if coarse else 'flat'} C={base.n_classes}")
                add_launches(launches, counts)
                preds.append(pred)
                sims.append(sim)
                ms.append(sec * 1e3)
            runs[(rep, coarse)] = dict(pred=torch.cat(preds), sim=torch.cat(sims), ms=ms)
    classes = torch.cat([c for c, _ in batches])
    return runs, classes


def phase_coarse(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 10 at the full width of the C sweep's gate row (COARSE), the
    identity at keep == n_grp, the screen's recall, and the multi-centroid
    memory at the serve codebook (train, predict, bank served flat and
    coarse)."""
    import dataclasses

    from repro_torch import kernels as tk, phy
    from repro_torch.core import classifier, hypervector as hv, scaleout
    from repro_torch.serving import hdc

    out = {}
    base = scaleout.ScaleOutConfig(**COARSE, noise="exact", channel="bsc",
                                   coarse_keep=COARSE_KEEP)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    protos_u = hv.random_hv(gen, base.n_classes, base.dim, "cuda")
    protos_p = torch.cat([hv.pack(protos_u[i:i + 8192]) for i in range(0, base.n_classes, 8192)])
    state = phy.state_from_ber(torch.full((base.n_rx_cores,), COARSE_BER, device="cuda"),
                               base.m_tx)
    c_core = base.n_classes // base.n_rx_cores
    cut = c_core / (c_core / COARSE_GS + COARSE_KEEP * COARSE_GS)
    log = []
    runs, classes = coarse_serves(torch, base, protos_u, protos_p, state, launches, log)
    mism = {}
    for rep in ("packed", "unpacked"):
        flat, coarse = runs[(rep, False)], runs[(rep, True)]
        mism[rep] = int((flat["pred"] != coarse["pred"]).sum())
        hit = float((coarse["pred"][:, None] == classes).any(1).float().mean())
        out[f"{rep} C={base.n_classes}"] = dict(
            flat_ms=flat["ms"], coarse_ms=coarse["ms"], mismatches=mism[rep], hit=hit,
            speedup=statistics.median(flat["ms"]) / statistics.median(coarse["ms"]))
        print(f"coarse {rep} C={base.n_classes} d={base.dim} {base.n_rx_cores} cores batch "
              f"{base.batch} BER {COARSE_BER} gs={COARSE_GS} keep={COARSE_KEEP}: flat "
              f"{statistics.median(flat['ms']):.3f} ms/call, coarse "
              f"{statistics.median(coarse['ms']):.3f} ms/call median ({CALLS} calls; "
              f"{out[f'{rep} C={base.n_classes}']['speedup']:.3f}x, row-visit cut {cut:.2f}x), "
              f"{mism[rep]} of {flat['pred'].numel()} predictions differ, hit rate {hit}",
              flush=True)
        require(mism[rep] == 0, f"coarse {rep}: {mism[rep]} predictions differ from the flat serve")
    for coarse in (False, True):
        a, b = runs[("packed", coarse)], runs[("unpacked", coarse)]
        require(torch.equal(a["pred"], b["pred"]) and torch.equal(a["sim"], b["sim"]),
                f"coarse phase: packed differs from unpacked (coarse={coarse})")

    # the screen's recall: of every (core, query), does the flat per-core
    # winner (first minimum of the full distances) lie in a surviving group?
    # (and on the core that holds the flat serve's answer)
    kept, kept_win, pairs = 0, 0, 0
    flat_pred = runs[("packed", False)]["pred"].reshape(CALLS, base.batch)
    for i, (((_, banks, q), _), (_, (_, gidx))) in enumerate(log):
        dist, _, counts = counted(torch, lambda: tk.hamming_search_banked(q.contiguous(), banks))
        require_only(counts, ("hamming_search_banked",), "recall oracle")
        add_launches(launches, counts)
        winner = torch.argmin(dist, -1)                       # [cores, B]
        d1, i1 = tk.hamming_topk_banked(q.contiguous(), banks)
        require(torch.equal(i1.long(), winner) and torch.equal(d1, dist.min(-1).values),
                "recall oracle: the full distances disagree with the fused top-1")
        survived = (gidx == (winner // COARSE_GS)[..., None].to(gidx.dtype)).any(-1)
        kept += int(survived.sum())
        pairs += winner.numel()
        core = (flat_pred[i] // c_core).long()
        kept_win += int(survived.gather(0, core[None])[0].sum())
    require(len(log) == CALLS, f"recall: {len(log)} coarse packed calls recorded")
    out["recall"] = dict(kept=kept, pairs=pairs, share=kept / pairs, winning_core=kept_win,
                         queries=CALLS * base.batch)
    print(f"coarse recall: the flat per-core winner survives the screen in {kept} of {pairs} "
          f"(core, query) pairs ({kept / pairs:.6f}), on the core of the flat serve's answer in "
          f"{kept_win} of {CALLS * base.batch} (full distances by hamming_search_banked)",
          flush=True)

    # keep == n_grp: the coarse serve is the flat serve, pred and maxsim
    small = dataclasses.replace(base, n_classes=1024, coarse_keep=1024 // base.n_rx_cores // COARSE_GS)
    ident, _ = coarse_serves(torch, small, protos_u[:1024].contiguous(),
                             protos_p[:1024].contiguous(), state, {})   # a check: not counted
    for rep in ("packed", "unpacked"):
        f, c = ident[(rep, False)], ident[(rep, True)]
        require(torch.equal(f["pred"], c["pred"]) and torch.equal(f["sim"], c["sim"]),
                f"coarse identity {rep}: keep == n_grp differs from the flat serve")
    print(f"coarse checks: 0 mismatches coarse vs flat in {CALLS} x {base.batch} trials, packed "
          f"and unpacked; packed == unpacked (flat and coarse, pred and maxsim); keep == n_grp "
          f"({small.coarse_keep}) at C={small.n_classes} == flat in pred and maxsim", flush=True)

    # the multi-centroid memory at the serve codebook
    book = classifier.make_codebook(torch.Generator(device="cuda").manual_seed(SEED),
                                    classifier.HDCTaskConfig(n_classes=MC_CLASSES, dim=MC_DIM),
                                    device="cuda")
    cents, train_s, counts = counted(torch, lambda: classifier.train_multicentroid(
        torch.Generator(device="cuda").manual_seed(3), book, MC_KC))
    require_only(counts, (), "train_multicentroid")
    pred_s = {}
    for ber in (0.0, 0.1):
        qs = hv.flip_bits_packed(torch.Generator(device="cuda").manual_seed(4), hv.pack(book), ber)
        pred, pred_s[ber], counts = counted(
            torch, lambda: classifier.multicentroid_predict(qs, cents))
        require_only(counts, ("hamming_topk_banked",), "multicentroid_predict")
        add_launches(launches, counts)
        require(torch.equal(pred.long(), torch.arange(MC_CLASSES, device="cuda")),
                f"multicentroid_predict at BER {ber}: {int((pred.long() != torch.arange(MC_CLASSES, device='cuda')).sum())} "
                "of the noisy prototypes misclassified")
    mc_cfg = scaleout.ScaleOutConfig(n_classes=MC_CLASSES * MC_KC, dim=MC_DIM, m_tx=3,
                                     n_rx_cores=MC_CORES, batch=256, representation="packed",
                                     channel="ideal", coarse_keep=COARSE_KEEP)
    bank = hdc.multicentroid_bank(torch.Generator(device="cuda").manual_seed(3), book, MC_KC,
                                  mc_cfg)
    require(torch.equal(bank, cents.reshape(MC_CLASSES * MC_KC, -1)),
            "multicentroid_bank: not the class-major rows of train_multicentroid")
    gq = torch.Generator(device="cuda").manual_seed(5)
    batches = [scaleout.make_queries(gq, dataclasses.replace(mc_cfg, n_classes=MC_CLASSES), book)
               for _ in range(CALLS)]
    mc_state = phy.state_from_ber(torch.zeros(MC_CORES, device="cuda"), 3)
    mc = {}
    for coarse, want in ((False, "hamming_topk_banked"), (True, "hamming_topk_k_banked")):
        serve = scaleout.make_ota_serve(dataclasses.replace(
            mc_cfg, coarse_group=COARSE_GS if coarse else 0))
        preds, ms = [], []
        for _, q in batches:                              # packed queries
            (pred, _), sec, counts = counted(torch, lambda: serve(bank, q, mc_state, None))
            require_only(counts, (want,), f"multicentroid serve coarse={coarse}")
            add_launches(launches, counts)
            preds.append(pred)
            ms.append(sec * 1e3)
        mc[coarse] = dict(pred=torch.cat(preds), ms=ms)
    sent = torch.cat([c for c, _ in batches])
    flat_cls = hdc.centroid_to_class(mc[False]["pred"], MC_KC)
    coarse_cls = hdc.centroid_to_class(mc[True]["pred"], MC_KC)
    require(torch.equal(flat_cls, coarse_cls), "multicentroid serve: coarse classes differ from flat")
    require(torch.equal(mc[False]["pred"], mc[True]["pred"]),
            "multicentroid serve: coarse centroid rows differ from flat")
    hit = float((flat_cls[:, None] == sent).any(1).float().mean())
    out["multicentroid"] = dict(
        train_s=train_s, predict_s=pred_s, rows=int(bank.shape[0]), hit=hit,
        flat_ms=mc[False]["ms"], coarse_ms=mc[True]["ms"])
    print(f"multicentroid checks: train {MC_CLASSES} classes x k_c={MC_KC} (d={MC_DIM}) in "
          f"{train_s:.3f} s; predict classifies all {MC_CLASSES} noisy prototypes at BER 0.0 "
          f"and 0.1 ({pred_s[0.0] * 1e3:.3f} / {pred_s[0.1] * 1e3:.3f} ms); bank "
          f"{bank.shape[0]} rows == the trained centroids; ideal serve over {MC_CORES} cores "
          f"flat {statistics.median(mc[False]['ms']):.3f} ms/call, coarse "
          f"{statistics.median(mc[True]['ms']):.3f} ms/call, centroid rows and classes flat == "
          f"coarse, hit rate {hit}", flush=True)
    if profile:
        for coarse in (False, True):
            cfg = dataclasses.replace(base, representation="packed",
                                      coarse_group=COARSE_GS if coarse else 0)
            serve = scaleout.make_ota_serve(cfg)
            gq = torch.Generator(device="cuda").manual_seed(1)
            qs = [scaleout.make_queries(gq, cfg, protos_u)[1] for _ in range(CALLS)]  # packed
            gn = torch.Generator(device="cuda").manual_seed(2)
            label = f"{'coarse' if coarse else 'flat'} packed C={base.n_classes}"
            # the coarse screen's split lists go through topk_merge_kernel
            out[f"profile {label}"] = profile_calls(torch, label, [
                lambda q=q: serve(protos_p, q, state, gn) for q in qs],
                share_of="topk_merge_kernel" if coarse else None)
    return out


def profile_calls(torch, label: str, calls: list, share_of: str | None = None) -> dict:
    """Where a call's time goes: the calls (zero-argument callables) under
    torch.profiler after one warm call; the device's busy time is the union
    of its kernel and copy intervals, its idle share the rest of the host's
    wall time of those calls, and the top device ops by summed time. With
    `share_of`, also the share of the summed device time in the ops whose
    name holds that string, and their device ms per call."""
    from torch.profiler import ProfilerActivity, profile

    calls[0]()                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += 0 if cur_e is None else cur_e - cur_s
    n = len(calls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    row = dict(wall_ms_per_call=wall_us / n / 1e3,
               device_busy_ms_per_call=busy / n / 1e3,
               idle_share=(1 - busy / wall_us) if dev else None,
               device_ops_per_call=len(dev) / n,
               top=[(name[:60], t / n / 1e3) for name, t in top])
    if share_of is not None:
        total = sum(by_name.values())
        mine = sum(t for name, t in by_name.items() if share_of in name)
        row["share"] = mine / total if total else None
        row["share_ms_per_call"] = mine / n / 1e3
        print(f"profile {label}: share of device time in {share_of}: {row['share']} "
              f"({row['share_ms_per_call']:.4f} ms/call)", flush=True)
    idle = "n/a" if row["idle_share"] is None else f"{row['idle_share']:.3f}"
    print(f"profile {label}: {row['wall_ms_per_call']:.3f} ms/call wall, device busy "
          f"{row['device_busy_ms_per_call']:.3f} ms/call "
          f"({row['device_ops_per_call']:.0f} device ops), idle share {idle}; top: "
          + ", ".join(f"{name} {t:.4f}" for name, t in row["top"][:4]), flush=True)
    return row


def fan_in_over_contraction(params: dict, cfg) -> dict:
    """Scale a drawn tree's attention projections, in place, to fan-in over
    the axes they contract: d_model for wq, wk, wv and H * hd for wo (the MLP
    and the head already are). The reference's init takes fan-in over axis -2
    (`src/repro/models/base.py:41-44`), which for wq [d, H, hd] and wk
    [d, KH, hd] is the head axis: at TinyLlama's width q and k then have
    std ~8 and ~23 and the scores ~180, a near-hard attention under which
    any change of summation order, the plain twin's own re-blocking
    included, changes the greedy tokens at 22 layers (phase 11 reports
    how far)."""
    a, d, h = params["blocks"]["attn"], cfg.d_model, cfg.n_heads
    a["wq"].mul_(math.sqrt(h / d))
    a["wk"].mul_(math.sqrt(cfg.n_kv_heads / d))
    a["wv"].mul_(math.sqrt(cfg.n_kv_heads / d))
    a["wo"].mul_(1 / math.sqrt(h))
    return params


def using(fn):
    """The models' attention entry (`layers.flash_attention_fwd`) swapped
    for ``fn``."""
    from unittest import mock

    from repro_torch.models import layers
    return mock.patch.object(layers, "flash_attention_fwd", fn)


def exact_attention(torch, q, k, v, causal=True, window=-1, q_offset=0, **_):
    """Softmax attention in f64: the yardstick of the per-layer check."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    kd, vd = (x.double().repeat_interleave(g, 2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) / math.sqrt(d)
    qp = q_offset + torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    ok = (kp <= qp) if causal else torch.ones_like(qp - kp, dtype=torch.bool)
    if window > 0:
        ok &= (qp - kp) < window
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc.masked_fill(~ok, -1e30), -1), vd)


# TinyLlama-1.1B's projection shapes in the prefill (M = batch 8 x prompt
# 1024 rows; K x N of wq/wo, wk/wv, wg/wu and wd)
BF16_MATMUL_SHAPES = [(8192, 2048, 2048), (8192, 2048, 256), (8192, 2048, 5632),
                      (8192, 5632, 2048)]


def bf16_reduction_check(torch, gen) -> list:
    """bf16 ``torch.matmul`` with PyTorch's
    ``allow_bf16_reduced_precision_reduction`` on and off, each against the
    f32 product rounded to bf16 once, at the LM's projection shapes: whether
    the flag changes what cuBLAS returns on this card (the reference
    accumulates in f32, src/repro/models/layers.py `dense`)."""
    flags = torch.backends.cuda.matmul
    keep = flags.allow_bf16_reduced_precision_reduction
    rows = []
    try:
        for m, k, n in BF16_MATMUL_SHAPES:
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
            ref = torch.matmul(x.float(), w.float()).bfloat16().float()
            got = {}
            for on in (True, False):
                flags.allow_bf16_reduced_precision_reduction = on
                got[on] = torch.matmul(x, w).float()
            torch.cuda.synchronize()
            row = dict(shape=(m, k, n), on_vs_off_equal=bool(torch.equal(got[True], got[False])),
                       on_err=float((got[True] - ref).abs().max()),
                       off_err=float((got[False] - ref).abs().max()),
                       on_differ=int((got[True] != ref).sum()),
                       off_differ=int((got[False] != ref).sum()))
            rows.append(row)
            print(f"bf16 matmul M={m} K={k} N={n}: reduced-precision reduction on vs off "
                  f"{'identical' if row['on_vs_off_equal'] else 'DIFFER'}; vs the f32 product "
                  f"rounded once: on max |err| {row['on_err']:.4g} ({row['on_differ']} of {m * n} "
                  f"differ), off {row['off_err']:.4g} ({row['off_differ']} differ)", flush=True)
    finally:
        flags.allow_bf16_reduced_precision_reduction = keep
    return rows


def phase_lm(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 11: the dense-decoder LM serve at TinyLlama-1.1B's published
    width and depth (`LM`), weights drawn from the seed.

    With the reference's own init, as its launcher draws it: the main path,
    counted (bf16 `Engine.generate` x LM_GENERATES, 22 attention launches each
    and no other kernel), time to first token and decode ms per token; every
    layer's attention on its own inputs (the prefill's, first two rows),
    kernel and plain twin against f64, the kernel no further off than 1.5x
    the twin (bf16 and f32); and, reported only, how far kernel vs twin and
    twin vs the twin re-blocked drift apart end to end in f32.

    With the attention projections at fan-in over their contraction
    (`fan_in_over_contraction`): in f32 the greedy tokens of kernel and twin
    identical, the prefill's last logits within 1e-3 and decode(prefill(x), t)
    against prefill(x ‖ t) within 5e-3; in bf16 the last logits within
    LM_BF16_LOGIT_BOUND, token agreement reported. Last, bf16 `torch.matmul`
    at the projection shapes is the same with PyTorch's reduced-precision
    reduction flag on and off (`bf16_reduction_check`)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.models import count_params, get_model, init_params
    from repro_torch.serving import Engine, ServeConfig

    dev = "cuda"
    b, s, new = LM["batch"], LM["prompt_len"], LM["max_new"]
    cfg = configs.get_config(LM["arch"])
    toks = torch.randint(0, cfg.vocab, (b, s + 1), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    prompt = {"tokens": toks[:, :s].contiguous()}
    pad_to = s + new + 1
    models = {dt: get_model(dataclasses.replace(cfg, dtype=dt))
              for dt in (torch.bfloat16, torch.float32)}
    engines = {dt: Engine(m, ServeConfig(max_new=new)) for dt, m in models.items()}

    def draw(conditioned: bool) -> dict:
        """{dtype: params}: one f32 draw from the seed, cast to bf16."""
        p32 = init_params(models[torch.float32].specs,
                          torch.Generator(device=dev).manual_seed(SEED), dev)
        if conditioned:
            fan_in_over_contraction(p32, cfg)

        def cast(t):
            return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.bfloat16()
        return {torch.float32: p32, torch.bfloat16: cast(p32)}

    def reblocked(q, k, v, **kw):
        return flash_fwd_ref(q, k, v, **dict(kw, block_q=128, block_k=256))

    def end_to_end(dt, params, fn):
        """(prefill last logits, greedy tokens) with the attention `fn`."""
        with using(fn):
            lg, _ = models[dt].prefill_fn(params, prompt)
            return lg, engines[dt].generate(params, prompt)

    # --- the reference's init: the main path, counted
    ref = draw(False)
    model, params, eng = models[torch.bfloat16], ref[torch.bfloat16], engines[torch.bfloat16]
    n_params = count_params(model.specs)
    gen_s = []
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for _ in range(LM_GENERATES):
        t0 = time.perf_counter()
        toks_k = eng.generate(params, prompt)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    counts = tk.launch_counts()
    require_only(counts, ("flash_attention_fwd",), "lm generate")
    require(counts["flash_attention_fwd"] == cfg.n_layers * LM_GENERATES,
            f"lm generate: {counts['flash_attention_fwd']} attention launches in "
            f"{LM_GENERATES} calls, expected {cfg.n_layers} a call")
    add_launches(launches, counts)
    require(tuple(toks_k.shape) == (b, new) and
            bool(((toks_k >= 0) & (toks_k < cfg.vocab)).all()),
            f"lm generate: tokens {tuple(toks_k.shape)} out of shape or range")

    ttft_ms, dec_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, prompt, pad_to=pad_to)
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(new):
            step, cache = model.decode_fn(params, cache, tok, s + i)
            tok = torch.argmax(step, -1).to(torch.int32)
        torch.cuda.synchronize()
        ttft_ms.append((t1 - t0) * 1e3)
        dec_ms.append((time.perf_counter() - t1) / new * 1e3)
    require(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all()),
            "lm bf16: logits not finite")
    tok_s = b * new / statistics.median(gen_s[1:])
    out = dict(arch=cfg.name, params=n_params, batch=b, prompt_len=s, max_new=new,
               generate_s=gen_s, ttft_ms=ttft_ms, decode_ms_per_token=dec_ms,
               tokens_per_s=tok_s, launches=counts["flash_attention_fwd"])
    print(f"lm serve: {cfg.name} ({n_params} parameters, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, bf16), batch {b} x prompt {s} x {new} new, greedy: prefill "
          f"(time to first token) {statistics.median(ttft_ms):.3f} ms, decode "
          f"{statistics.median(dec_ms):.3f} ms/token, generate {gen_s[0]:.3f} s cold / "
          f"{statistics.median(gen_s[1:]):.3f} s warm ({tok_s:.1f} generated tokens/s)",
          flush=True)
    if profile:
        out["profile prefill"] = profile_calls(torch, "lm prefill bf16", [
            lambda: model.prefill_fn(params, prompt, pad_to=pad_to)], share_of="flash_fwd")
        _, cache = model.prefill_fn(params, prompt, pad_to=pad_to)
        state = dict(cache=cache, tok=toks_k[:, 0], pos=s)

        def decode_step():
            step, state["cache"] = model.decode_fn(params, state["cache"], state["tok"],
                                                   state["pos"])
            state["tok"] = torch.argmax(step, -1).to(torch.int32)
            state["pos"] += 1

        out["profile decode"] = profile_calls(torch, "lm decode step bf16",
                                              [decode_step] * 16)
        del state
    del cache

    layer_err = {}
    for dt in (torch.bfloat16, torch.float32):     # every layer on its own inputs
        seen = []

        def record(q, k, v, **kw):
            seen.append((q[:2], k[:2], v[:2], kw))
            return tk.flash_attention_fwd(q, k, v, **kw)

        with using(record):
            models[dt].prefill_fn(ref[dt], prompt)
        rows = []
        for q, k, v, kw in seen:
            want = exact_attention(torch, q, k, v, **kw)
            rows.append(tuple(float((got.double() - want).abs().max()) for got in (
                tk.flash_attention_fwd(q, k, v, **kw), flash_fwd_ref(q, k, v, **kw))))
        del seen
        name = str(dt).split(".")[-1]
        require(len(rows) == cfg.n_layers and all(a <= FLASH_BF16_VS_TWIN * t
                                                   for a, t in rows),
                f"lm {name}: a layer's attention off f64 by more than 1.5x the twin's: {rows}")
        layer_err[name] = rows
    lg_k, tk_k = end_to_end(torch.float32, ref[torch.float32], tk.flash_attention_fwd)
    lg_t, tk_t = end_to_end(torch.float32, ref[torch.float32], flash_fwd_ref)
    lg_r, tk_r = end_to_end(torch.float32, ref[torch.float32], reblocked)
    drift = dict(kernel_vs_twin_logits=float((lg_k - lg_t).abs().max()),
                 kernel_vs_twin_tokens=float((tk_k == tk_t).float().mean()),
                 twin_vs_reblocked_logits=float((lg_t - lg_r).abs().max()),
                 twin_vs_reblocked_tokens=float((tk_t == tk_r).float().mean()))
    out.update(layer_err_vs_f64=layer_err, reference_init_f32_drift=drift)
    worst = {k: (max(a for a, _ in v), max(t for _, t in v)) for k, v in layer_err.items()}
    print(f"lm checks, the reference's init: {counts['flash_attention_fwd']} attention launches "
          f"in {LM_GENERATES} generates ({cfg.n_layers} each), nothing else launched; bf16 "
          f"logits finite; every layer's attention vs f64, worst max |err| kernel / twin: "
          + ", ".join(f"{k} {a:.4g} / {t:.4g}" for k, (a, t) in worst.items())
          + f"; f32 end to end (not gated): kernel vs twin logits "
          f"{drift['kernel_vs_twin_logits']:.4g}, tokens agree "
          f"{drift['kernel_vs_twin_tokens']:.4f}; twin vs twin re-blocked "
          f"{drift['twin_vs_reblocked_logits']:.4g}, {drift['twin_vs_reblocked_tokens']:.4f}",
          flush=True)
    del ref, lg_k, lg_t, lg_r

    # --- attention projections at fan-in over their contraction: the gates end to end
    con = draw(True)
    lg32, tk32 = end_to_end(torch.float32, con[torch.float32], tk.flash_attention_fwd)
    lg32_t, tk32_t = end_to_end(torch.float32, con[torch.float32], flash_fwd_ref)
    f32_err = float((lg32 - lg32_t).abs().max())
    require(torch.equal(tk32, tk32_t),
            f"lm f32: greedy tokens differ kernel vs twin in "
            f"{int((tk32 != tk32_t).sum())} of {tk32.numel()}")
    require(f32_err <= 1e-3, f"lm f32: prefill logits kernel vs twin differ by {f32_err}")
    m32, p32 = models[torch.float32], con[torch.float32]
    _, cache = m32.prefill_fn(p32, prompt, pad_to=s + 1)
    lg_step, _ = m32.decode_fn(p32, cache, toks[:, s], s)
    lg_full, _ = m32.prefill_fn(p32, {"tokens": toks})
    dec_err = float((lg_step - lg_full).abs().max())
    require(dec_err < 5e-3, f"lm f32: decode(prefill(x), t) vs prefill(x + t) differ by "
                            f"{dec_err}")
    del cache
    lgb, tkb = end_to_end(torch.bfloat16, con[torch.bfloat16], tk.flash_attention_fwd)
    lgb_t, tkb_t = end_to_end(torch.bfloat16, con[torch.bfloat16], flash_fwd_ref)
    bf16_err = float((lgb - lgb_t).abs().max())
    agree = float((tkb == tkb_t).float().mean())
    require(bool(torch.isfinite(lgb).all()) and bool(torch.isfinite(lgb_t).all()),
            "lm bf16: logits not finite")
    require(bf16_err <= LM_BF16_LOGIT_BOUND,
            f"lm bf16: prefill logits kernel vs twin differ by {bf16_err} > "
            f"{LM_BF16_LOGIT_BOUND}")
    out.update(f32_logit_err=f32_err, decode_consistency_err=dec_err,
               bf16_logit_err=bf16_err, bf16_token_agreement=agree,
               logit_std=float(lgb.std()), logit_max=float(lgb.abs().max()))
    # the port's bf16 products leave the reduction to cuBLAS: hold that the
    # reduced-precision flag (True by default) changes nothing at these shapes
    out["bf16_matmul"] = bf16_reduction_check(torch, torch.Generator(device=dev).manual_seed(SEED))
    require(all(r["on_vs_off_equal"] for r in out["bf16_matmul"]),
            "lm bf16: allow_bf16_reduced_precision_reduction changes torch.matmul's result")
    print(f"lm checks, projections at fan-in over their contraction: f32 greedy tokens "
          f"kernel == twin ({tk32.numel()}), last logits max |diff| {f32_err:.3g}; "
          f"decode(prefill(x), t) vs prefill(x + t) {dec_err:.3g}; bf16 logits finite, last "
          f"logits kernel vs twin max |diff| {bf16_err:.4g} (bound {LM_BF16_LOGIT_BOUND}; "
          f"max |logit| {out['logit_max']:.3g}), tokens agree {agree:.4f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: the symbol tier, M-drop, bitplane noise and living channels
# ---------------------------------------------------------------------------

def symbol_physics(torch, cfg, protos_u, q, state, gen_state):
    """One symbol-tier serve call re-derived in plain PyTorch from the same
    generator state: the TX bit combo (permuted TX g rolls its bits by g),
    each core's noiseless symbols ``symbols[i][combo]``, the tier's draws in
    its order (real normals, imaginary normals, fallback flips),
    `ota.awgn_decide`, the fallback for invalid rows, and a dense f32
    bipolar search over every core's class shard (and the M permuted banks).
    Returns (pred, maxsim) as the serve does."""
    from repro_torch.core import hypervector as hv, ota

    d, n, m = cfg.dim, cfg.n_rx_cores, cfg.m_tx
    bits = hv.unpack(q[:, 0], d) if cfg.packed else q[:, 0]             # [B, M, d]
    if cfg.permuted:
        bits = torch.stack([torch.roll(bits[:, g], g, -1) for g in range(m)], 1)
    combo = (bits.to(torch.int64) << torch.arange(m, device="cuda")[:, None]).sum(1)
    gen = torch.Generator(device="cuda")
    gen.set_state(gen_state)
    full = (n,) + tuple(combo.shape)
    nr = torch.randn(full, generator=gen, device="cuda")
    ni = torch.randn(full, generator=gen, device="cuda")
    flips = torch.rand(full, generator=gen, device="cuda") < state.ber[:, None, None]
    dec = ota.awgn_decide(None, state.symbols[:, combo], state.c0[:, None, None],
                          state.c1[:, None, None], state.n0, noise=(nr, ni))
    exact = ota.majority_labels(m, "cuda")[combo][None] ^ flips.to(torch.uint8)
    dec = torch.where(state.valid[:, None, None], dec, exact)
    qb = 2.0 * dec.to(torch.float32) - 1.0                              # [n, B, d]
    c_core = cfg.n_classes // n
    banks = ([torch.roll(protos_u, s, -1) for s in range(m)] if cfg.permuted
             else [protos_u])
    sims = torch.stack([torch.einsum("nbd,ncd->bnc", qb, (2.0 * bk.to(torch.float32) - 1.0)
                                     .reshape(n, c_core, d)).reshape(-1, cfg.n_classes)
                        for bk in banks], 1)                            # [B, banks, C]
    sims = sims if cfg.permuted else sims[:, 0]
    return torch.argmax(sims, -1).to(torch.int32), sims.max(-1).values / (2.0 * d) + 0.5


def symbol_serves(torch, state, protos_u, base, launches) -> dict:
    """The symbol serve at the paper's configuration: CALLS calls in each
    mode on the query and noise seeds of phases 4-5, every call held against
    `symbol_physics`, packed against unpacked; the bsc baseline alongside
    for the wall times. Also the decode alone (lookup, AWGN, compare, pack)
    at the serve's shape."""
    from repro_torch import kernels as tk, phy
    from repro_torch.core import hypervector as hv

    runs = {}
    for mode in ([("ota", "symbol", perm, rep) for perm in (False, True)
                  for rep in ("unpacked", "packed")]
                 + [("ota", "bsc", False, rep) for rep in ("unpacked", "packed")]):
        label, cfg, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u, "cuda")
        preds, sims, ms, states = [], [], [], []
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        for _, q in batches:
            states.append(gn.get_state())
            t0 = time.perf_counter()
            pred, sim = serve(protos, q, state, gn)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            preds.append(pred)
            sims.append(sim)
        counts = tk.launch_counts()
        require_only(counts, SERVE_KERNELS[("ota", cfg.representation)], label)
        add_launches(launches, counts)
        if cfg.channel == "symbol":
            for (_, q), st, pred, sim in zip(batches, states, preds, sims):
                want_p, want_s = symbol_physics(torch, cfg, protos_u, q, state, st)
                require(torch.equal(pred, want_p) and torch.equal(sim, want_s),
                        f"{label}: a call differs from the plain re-derivation of its physics")
        run = dict(label=label, pred=torch.cat(preds), sim=torch.cat(sims),
                   classes=torch.cat([c for c, _ in batches]), ms=ms, counts=counts)
        run["acc"] = hit_rate(torch, run, mode[2])
        runs[mode] = run
        print(f"serve {label}: {CALLS} calls x batch {base.batch}, "
              f"{statistics.median(ms):.3f} ms/call median (first {ms[0]:.3f}), "
              f"{json.dumps(run['acc'])}, launches {counts}", flush=True)
    for perm in (False, True):
        u, p = runs[("ota", "symbol", perm, "unpacked")], runs[("ota", "symbol", perm, "packed")]
        require(torch.equal(u["pred"], p["pred"]) and torch.equal(u["sim"], p["sim"]),
                f"{p['label']}: differs from the unpacked serve")
    # the decode alone at the serve's shape: device time of 20 back-to-back calls
    chan, n = phy.get_channel("symbol"), base.n_rx_cores
    combo = torch.randint(0, 2 ** base.m_tx, (base.batch, base.dim),
                          generator=torch.Generator(device="cuda").manual_seed(5), device="cuda",
                          dtype=torch.int32)
    gd = torch.Generator(device="cuda").manual_seed(6)
    decode_ms = {rep: call_ms(torch, lambda packed=(rep == "packed"): chan.rx_copies(
        gd, combo, state, 0, n, packed=packed, dim=base.dim, noise="exact"))
        for rep in ("unpacked", "packed")}
    bsc = phy.get_channel("bsc")
    bundle = torch.zeros((base.batch, base.words), dtype=torch.int32, device="cuda")
    decode_ms["bsc packed"] = call_ms(torch, lambda: bsc.rx_copies(
        gd, bundle, state, 0, n, packed=True, dim=base.dim, noise="exact"))
    print(f"symbol decode (lookup + AWGN + compare [+ pack]) at {n} cores x batch "
          f"{base.batch} x d {base.dim}: unpacked {decode_ms['unpacked']:.4f} ms, packed "
          f"{decode_ms['packed']:.4f} ms (the bsc tier's packed noise "
          f"{decode_ms['bsc packed']:.4f} ms; CUDA events over 20 back-to-back calls)",
          flush=True)
    print("symbol serve checks: every call == the plain re-derivation of its physics "
          "(predictions and maxsim), packed == unpacked", flush=True)
    return dict(runs={r["label"]: dict(ms=r["ms"], acc=r["acc"], counts=r["counts"])
                      for r in runs.values()}, decode_ms=decode_ms)


def symbol_ber(torch, state) -> dict:
    """Monte-Carlo flip rate of every RX's symbol decode of one M-TX
    transmission at d = SYMBOL_BER_DIM against the per-symbol analytic BER:
    for every valid row within 5 binomial sigma + 5e-4 (tests/test_phy.py:
    205-241's band)."""
    from repro_torch import phy
    from repro_torch.core import hypervector as hv, ota

    m, d = state.m_tx, SYMBOL_BER_DIM
    gen = torch.Generator(device="cuda").manual_seed(7)
    queries = hv.random_hv(gen, m, d, "cuda")
    maj = hv.majority(queries)
    combo = phy.combo_index(queries, axis=0).to(torch.int64)
    dec = ota.awgn_decide(gen, state.symbols[:, combo], state.c0[:, None],
                          state.c1[:, None], state.n0)
    emp = (dec != maj[None]).to(torch.float64).mean(1)
    ana, _ = ota.decision_metrics(state.symbols, ota.majority_labels(m, "cuda"), state.n0,
                                  method="symbol")
    ana = ana.double()
    valid = state.valid
    tol = 5.0 * (torch.clamp(ana * (1 - ana), min=1e-9) / d).sqrt() + 5e-4
    bad = valid & ((emp - ana).abs() > tol)
    require(bool(valid.any()) and not bool(bad.any()),
            f"symbol BER: {int(bad.sum())} valid RX outside 5 sigma + 5e-4 of the per-symbol "
            "analytic BER")
    out = dict(valid=int(valid.sum()), emp_avg=float(emp[valid].mean()),
               emp_max=float(emp[valid].max()), ana_avg=float(ana[valid].mean()),
               ana_max=float(ana[valid].max()), eq1_avg=float(state.ber[valid].mean()))
    print(f"symbol BER: {out['valid']} of {state.n_rx} RX valid, every valid RX within 5 sigma "
          f"+ 5e-4 of the per-symbol analytic at d = {d}; empirical avg {out['emp_avg']:.4f} "
          f"max {out['emp_max']:.4f} (analytic {out['ana_avg']:.4f} / {out['ana_max']:.4f}, "
          f"Eq. 1 {out['eq1_avg']:.4f}; reference {PAPER_SYMBOL['avg_ber']} / "
          f"{PAPER_SYMBOL['max_ber']})", flush=True)
    return out


def symbol_trials(torch, launches) -> dict:
    """Table I's workload on the physical tier (EXPERIMENTS.md:162-177):
    C = 100, d = 512, 1000 trials, the 64-RX system re-characterized per M;
    baseline at M = 1, 3, 5 and permuted at M = 5, bsc at each state's Eq. 1
    average BER beside the symbol tier, packed == unpacked trial for trial."""
    from repro_torch.core import classifier, scaleout

    cfg = classifier.HDCTaskConfig(**SYMBOL_TASK)
    rows, out = {}, {}
    for m, bundling in ((1, "baseline"), (3, "baseline"), (5, "baseline"), (5, "permuted")):
        state = scaleout.precharacterize_state(scaleout.ScaleOutConfig(m_tx=m), device="cuda")
        avg = float(state.ber.mean())
        flags = {}
        for name, channel in (("bsc", "bsc"), ("symbol", "symbol")):
            for rep in ("unpacked", "packed"):
                want = (("assoc_matmul",) if rep == "unpacked" else ("hamming_search",)
                        if bundling == "baseline" else ("hamming_topk_banked",))
                f, _, counts = counted(torch, lambda: classifier.run_trials(
                    SEED, cfg, m, avg, bundling, representation=rep, channel=channel,
                    state=state))
                require_only(counts, want, f"symbol trials {name} {bundling} M={m} {rep}")
                add_launches(launches, counts)
                flags[(name, rep)] = f
            require(torch.equal(flags[(name, "unpacked")], flags[(name, "packed")]),
                    f"symbol trials {name} {bundling} M={m}: packed differs from unpacked")
        acc = {k: float(flags[(k, "unpacked")].float().mean()) for k in ("bsc", "symbol")}
        rows[(m, bundling)] = dict(avg_ber=avg, **acc)
        print(f"symbol trials {bundling} M={m}: Eq. 1 avg BER {avg:.4f}, bsc {acc['bsc']}, "
              f"symbol {acc['symbol']}", flush=True)
    require(rows[(1, "baseline")]["symbol"] == 1.0, "symbol trials: M = 1 accuracy is not 1.0")
    p3 = rows[(3, "baseline")]
    sigma = (p3["bsc"] * (1 - p3["bsc"]) / cfg.n_trials) ** 0.5
    require(abs(p3["symbol"] - p3["bsc"]) <= 5 * sigma,
            f"symbol trials M=3: symbol {p3['symbol']} is more than 5 sigma ({sigma:.4f}) from "
            f"bsc {p3['bsc']}")
    print(f"symbol trials checks: M = 1 symbol 1.0, M = 3 symbol within 5 sigma of bsc "
          f"({abs(p3['symbol'] - p3['bsc']):.4f} <= {5 * sigma:.4f}), packed == unpacked; M = 5 "
          f"baseline {rows[(5, 'baseline')]['symbol']} (reference {PAPER_SYMBOL['m5']}), "
          f"permuted {rows[(5, 'permuted')]['symbol']} (reference "
          f"{PAPER_SYMBOL['m5_permuted']}), M = 5 avg BER "
          f"{rows[(5, 'baseline')]['avg_ber']:.4f} (reference {PAPER_SYMBOL['m5_avg_ber']}, "
          "the reference's own coordinate search)", flush=True)
    out["rows"] = {f"{b} M={m}": v for (m, b), v in rows.items()}
    return out


def bitplane_checks(torch, state, protos_u, base, launches) -> dict:
    """The packed bsc serve with noise="bitplane": each core's flip rate over
    a zero bundle within 5 sigma of round(ber * 2^16) / 2^16, the comparator
    against a per-bit reference on the same planes, and the serve's wall
    time beside noise="exact"."""
    import dataclasses

    from repro_torch import phy
    from repro_torch.core import hypervector as hv

    chan, n, d = phy.get_channel("bsc"), base.n_rx_cores, base.dim
    planes = base.noise_planes
    zeros = torch.zeros((base.batch, base.words), dtype=torch.int32, device="cuda")
    flips = torch.zeros(n, dtype=torch.float64, device="cuda")
    for seed in range(CALLS):
        rx = chan.rx_copies(torch.Generator(device="cuda").manual_seed(200 + seed), zeros,
                            state, 0, n, packed=True, dim=d, noise="bitplane", planes=planes)
        flips += hv.unpack(rx, d).sum((1, 2), dtype=torch.float64)
    bits = CALLS * base.batch * d
    q = torch.clamp(torch.round(state.ber.double() * 2**planes), 0, 2**planes - 1) / 2**planes
    rate = flips / bits
    sigma = (q * (1 - q) / bits).sqrt()
    z = float(((rate - q).abs() / sigma.clamp_min(1e-300)).max())
    require(bool(((rate - q).abs() <= 5 * sigma + 1e-12).all()),
            f"bitplane: a core's flip rate is more than 5 sigma from its quantized BER "
            f"(max {z:.2f} sigma)")
    # the comparator against the per-bit uniforms of the same planes
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (n, base.batch, base.words)
    words = hv._random_words(gen, (planes,) + shape, "cuda")
    p = state.ber.reshape(n, 1, 1)
    got = hv.bernoulli_words(None, p, shape, planes, planes=words)
    u = torch.zeros((n, base.batch, d), dtype=torch.int64, device="cuda")
    for i in range(planes):
        u += hv.unpack(words[i], d).to(torch.int64) << i
    t = torch.clamp(torch.round(p.float() * 2**planes), 0, 2**planes - 1).to(torch.int64)
    require(torch.equal(got, hv.pack((u < t).to(torch.uint8))),
            "bitplane: the comparator differs from the per-bit reference on the same planes")
    ms = {}
    for noise in ("exact", "bitplane"):
        cfg = dataclasses.replace(base, representation="packed", noise=noise)
        mode = ("ota", "bsc", False, "packed")
        _, _, serve, protos, batches, gn = serve_setup(torch, cfg, mode, protos_u, "cuda")
        ms[noise] = []
        for _, qb in batches:
            _, sec, counts = counted(torch, lambda: serve(protos, qb, state, gn))
            require_only(counts, ("hamming_topk_banked",), f"bitplane serve noise={noise}")
            add_launches(launches, counts)
            ms[noise].append(sec * 1e3)
    print(f"bitplane: {n} cores x {bits} bits within 5 sigma of round(ber*2^{planes})/2^"
          f"{planes} (max {z:.3f} sigma), comparator == per-bit reference; packed bsc serve "
          f"{statistics.median(ms['bitplane']):.3f} ms/call median with bitplane noise, "
          f"{statistics.median(ms['exact']):.3f} with exact", flush=True)
    return dict(max_sigma=z, bits_per_core=bits, ms=ms)


def m_drop_checks(torch, state, protos_u, base, launches) -> dict:
    """m_active = 1 of 3 on the ideal tier, unpacked and packed at the
    paper's configuration and sparse at d = 8192: the serve equals
    `serve_reference` (which bundles the first m_act TXs) bit for bit; the
    symbol tier refuses an M-drop."""
    import dataclasses

    from repro_torch.core import hypervector as hv, scaleout

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    codes8, protos8 = sparse_codebook(torch, gen, base.n_classes, NARROW_DIM, NARROW_K,
                                      NARROW_DENSITY)
    sparse_cfg = dataclasses.replace(base, representation="sparse", collective="index_ag",
                                     dim=NARROW_DIM, k_max=NARROW_K)
    out = {}
    for rep, cfg0, book, protos in (
            ("unpacked", base, protos_u, protos_u),
            ("packed", dataclasses.replace(base, representation="packed"), protos_u,
             hv.pack(protos_u)),
            ("sparse", sparse_cfg, codes8, protos8)):
        cfg = dataclasses.replace(cfg0, channel="ideal", m_active=1)
        serve = scaleout.make_ota_serve(cfg)
        gq = torch.Generator(device="cuda").manual_seed(1)
        ms = []
        for _ in range(2):
            _, q = scaleout.make_queries(gq, cfg, book)
            (pred, sim), sec, counts = counted(torch, lambda: serve(protos, q, state, None))
            require_only(counts, SERVE_KERNELS.get(("ota", rep), ("sparse_topk_banked",)),
                         f"m_active=1 {rep}")
            add_launches(launches, counts)
            want_p, want_s = scaleout.serve_reference(cfg, protos, q)
            require(torch.equal(pred, want_p) and torch.equal(sim, want_s),
                    f"m_active=1 {rep}: differs from serve_reference")
            ms.append(sec * 1e3)
        out[rep] = ms
    try:
        scaleout.make_ota_serve(dataclasses.replace(base, channel="symbol", m_active=1))
        raised = False
    except ValueError:
        raised = True
    require(raised, "channel='symbol' with m_active=1 did not raise")
    print("m-drop checks: m_active=1 unpacked, packed (d = 512) and sparse (d = 8192) == "
          "serve_reference; channel='symbol' with m_active=1 raises", flush=True)
    return out


def living_channels(torch, state, protos_u, base, launches) -> dict:
    """StaticProcess serves against process-free serves (bsc and symbol,
    unpacked and packed, CALLS steps), quarantine of core 0, the
    PhaseDriftProcess serve's time per call, and the closed-loop drift
    sweeps (DRIFT_GATE gated, DRIFT_REPORT reported)."""
    import dataclasses

    from repro_torch import phy
    from repro_torch.core import classifier, scaleout

    out = {}
    c_core = base.n_classes // base.n_rx_cores
    for channel in ("bsc", "symbol"):
        for rep in ("unpacked", "packed"):
            mode = ("ota", channel, False, rep)
            label, cfg, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u,
                                                                 "cuda")
            pserve = scaleout.make_ota_serve(cfg, process=phy.StaticProcess())
            pstate = phy.StaticProcess().init(state)
            gp = torch.Generator(device="cuda").manual_seed(2)
            gens = phy.process_generators(SEED, "cuda")
            for _, q in batches:
                want = serve(protos, q, state, gn)
                (pred, sim, pstate), _, counts = counted(
                    torch, lambda: pserve(protos, q, pstate, gp, gens))
                require_only(counts, SERVE_KERNELS[("ota", rep)], f"static process {label}")
                add_launches(launches, counts)
                require(torch.equal(pred, want[0]) and torch.equal(sim, want[1]),
                        f"static process {label}: differs from the process-free serve")
            require(int(pstate.t) == CALLS, "static process: t did not advance once a call")
    # quarantine core 0: no prediction in its class range
    label, cfg, _, protos, batches, _ = serve_setup(torch, base, ("ota", "symbol", False,
                                                                  "unpacked"), protos_u, "cuda")
    pserve = scaleout.make_ota_serve(cfg, process=phy.StaticProcess())
    p0 = phy.StaticProcess().init(state)
    quar = phy.set_quarantine(p0, torch.arange(base.n_rx_cores, device="cuda") == 0)
    gens = phy.process_generators(SEED, "cuda")
    opened = torch.cat([pserve(protos, q, p0, torch.Generator(device="cuda").manual_seed(2),
                               gens)[0] for _, q in batches])
    closed = torch.cat([pserve(protos, q, quar, torch.Generator(device="cuda").manual_seed(2),
                               gens)[0] for _, q in batches])
    require(bool((opened < c_core).any()) and not bool((closed < c_core).any()),
            "quarantine: core 0's classes still win (or never won unmasked)")
    # a drifting channel's serve, time per call beside the process-free serve
    drift = phy.PhaseDriftProcess(sigma=DRIFT_REPORT["sigma"], alpha=0.5,
                                  guard_dims=DRIFT_GATE["guard"])
    for rep in ("unpacked", "packed"):
        label, cfg, serve, protos, batches, gn = serve_setup(
            torch, base, ("ota", "symbol", False, rep), protos_u, "cuda")
        pserve = scaleout.make_ota_serve(cfg, process=drift)
        pstate = drift.init(state)
        gens = phy.process_generators(SEED, "cuda")
        ms = {"process-free": [], "phase_drift": []}
        for _, q in batches:
            _, sec, _ = counted(torch, lambda: serve(protos, q, state, gn))
            ms["process-free"].append(sec * 1e3)
            (_, _, pstate), sec, counts = counted(torch, lambda: pserve(protos, q, pstate, gn,
                                                                        gens))
            require_only(counts, SERVE_KERNELS[("ota", rep)], f"drift serve {label}")
            add_launches(launches, counts)
            ms["phase_drift"].append(sec * 1e3)
        out[f"drift serve {rep}"] = ms
        print(f"process serve {label}: PhaseDriftProcess(sigma {DRIFT_REPORT['sigma']}, guard "
              f"{DRIFT_GATE['guard']}) {statistics.median(ms['phase_drift']):.3f} ms/call "
              f"median, process-free {statistics.median(ms['process-free']):.3f}", flush=True)
    # the closed loop (tests/test_phy_process.py:283-306's scenario at 512 trials)
    g = DRIFT_GATE
    cfg16 = scaleout.ScaleOutConfig(n_classes=g["n_classes"], n_rx_cores=g["n_rx"])
    state16 = scaleout.precharacterize_state(cfg16, device="cuda")
    task = classifier.HDCTaskConfig(n_classes=g["n_classes"], dim=512, n_trials=g["trials"])
    band = {"cap": 0.05}

    def sweep(proc, steps, **kw):
        res, sec, counts = counted(torch, lambda: classifier.run_drift_sweep(
            7, task, 3, state16, proc, steps, **kw))
        require_only(counts, ("assoc_matmul",), "drift sweep")
        add_launches(launches, counts)
        return res, sec

    proc = phy.PhaseDriftProcess(sigma=g["sigma"], alpha=g["alpha"], guard_dims=g["guard"])
    base_acc = sweep(phy.StaticProcess(), 1)[0]["acc"][0]
    opened, s_open = sweep(proc, g["steps"])
    adapt, s_adapt = sweep(proc, g["steps"], adaptive=True, patience=1, band_kwargs=band)
    tail = g["tail"]
    drop = 100.0 * (base_acc - statistics.fmean(opened["acc"][-tail:]))
    gap = 100.0 * (base_acc - statistics.fmean(adapt["acc"][-tail:]))
    require(drop >= 3.0 and gap <= 1.0 and adapt["n_refits"] > 0,
            f"closed loop: open-loop drop {drop:.2f} pts (>= 3), closed-loop gap {gap:.2f} "
            f"pts (<= 1), {adapt['n_refits']} re-fits (> 0)")
    out["closed_loop"] = dict(baseline=base_acc, open=opened["acc"], adaptive=adapt["acc"],
                              drop_pts=drop, gap_pts=gap, n_refits=adapt["n_refits"],
                              seconds=dict(open=s_open, adaptive=s_adapt))
    print(f"closed loop ({g['n_rx']} RX, C = {g['n_classes']}, sigma {g['sigma']}, "
          f"{g['steps']} steps x {g['trials']} trials): no drift {base_acc}, open-loop tail-"
          f"{tail} drop {drop:.2f} pts, closed-loop gap {gap:.2f} pts, {adapt['n_refits']} "
          f"re-fits; {s_adapt:.2f} s for the adaptive sweep", flush=True)
    # EXPERIMENTS.md:228-236's scenario through run_drift_sweep, reported only
    r = DRIFT_REPORT
    proc = phy.PhaseDriftProcess(sigma=r["sigma"], alpha=0.5, guard_dims=g["guard"])
    opened, _ = sweep(proc, r["steps"])
    adapt, _ = sweep(proc, r["steps"], adaptive=True, patience=1, band_kwargs=band)
    tail = r["tail"]
    rep_row = dict(open_tail=statistics.fmean(opened["acc"][-tail:]),
                   open_worst=min(opened["acc"]),
                   adaptive_tail=statistics.fmean(adapt["acc"][-tail:]),
                   adaptive_worst=min(adapt["acc"]), n_refits=adapt["n_refits"])
    out["drift_report"] = rep_row
    print(f"drift sweep (sigma {r['sigma']}, {r['steps']} steps x {g['trials']} trials, "
          f"reported): open-loop tail-{tail} {rep_row['open_tail']:.4f} (worst "
          f"{rep_row['open_worst']:.4f}), adaptive {rep_row['adaptive_tail']:.4f} (worst "
          f"{rep_row['adaptive_worst']:.4f}, {rep_row['n_refits']} re-fits); the reference's "
          "0.894 / 1.000 come from its serving loop with LinkController", flush=True)
    print("living channel checks: StaticProcess == process-free (bsc and symbol, unpacked and "
          f"packed, {CALLS} steps), quarantined core 0 never wins, closed loop recovers",
          flush=True)
    return out


def phase_physical(torch, state, protos_u, base, launches, profile: bool = False) -> dict:
    """Phase 12: the symbol tier, M-drop, bitplane noise and living channels."""
    out = dict(serves=symbol_serves(torch, state, protos_u, base, launches),
               ber=symbol_ber(torch, state),
               trials=symbol_trials(torch, launches),
               bitplane=bitplane_checks(torch, state, protos_u, base, launches),
               m_drop=m_drop_checks(torch, state, protos_u, base, launches),
               living=living_channels(torch, state, protos_u, base, launches))
    if profile:
        for mode in ([("ota", "symbol", perm, rep) for perm in (False, True)
                      for rep in ("unpacked", "packed")]
                     + [("ota", "bsc", False, rep) for rep in ("unpacked", "packed")]):
            label, _, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u,
                                                               "cuda")
            out[f"profile {label}"] = profile_calls(torch, label, [
                lambda q=q: serve(protos, q, state, gn) for _, q in batches])
    return out


# ---------------------------------------------------------------------------
# phase 13: multi-tenant serving
# ---------------------------------------------------------------------------

def poisson_race(n_requests: int, tenants: int, seed: int = 0) -> list:
    """The reference bench's trace order (benchmarks/serving.py:140-147): the
    tenant of each arrival is the argmin of the tenants' next-event times
    under seeded exponential inter-arrivals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nxt = rng.exponential(1.0, tenants)
    trace = []
    for _ in range(n_requests):
        t = int(np.argmin(nxt))
        trace.append(t)
        nxt[t] += rng.exponential(1.0)
    return trace


def latency_pcts(lat: list) -> dict:
    import numpy as np

    a = np.asarray(lat)
    return dict(p50_ms=float(np.percentile(a, 50) * 1e3), p95_ms=float(np.percentile(a, 95) * 1e3),
                max_ms=float(a.max() * 1e3))


def cuda_gen(torch, seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def mt_requests(torch, cfg, books, trace, seed0: int = 0) -> list:
    """(tenant, queries, noise seed) of each request: queries drawn from the
    tenant's codebook on seed 100 + i, noise on seed 1000 + i (the reference
    bench's seeds), offset by ``seed0``."""
    from repro_torch.core import scaleout

    return [(t, scaleout.make_queries(cuda_gen(torch, seed0 + 100 + i), cfg, books[t])[1],
             seed0 + 1000 + i) for i, t in enumerate(trace)]


def mt_static(torch, cfg, state, banks, reqs, fstate=None) -> tuple:
    """One standalone `make_ota_serve` call per request, each answer brought
    to the host (what the slot ring is held to): (answers, latencies, wall).
    With ``fstate``, the fault-aware serve under that (static) fault state."""
    from repro_torch import faults
    from repro_torch.core import scaleout

    if fstate is None:
        serve = scaleout.make_ota_serve(cfg)
    else:
        fserve = scaleout.make_ota_serve(cfg, faults=faults.StaticFaults())

        def serve(protos, q, st, g):
            return fserve(protos, q, st, g, fstate, None)[:2]
    gens = [cuda_gen(torch, seed) for _, _, seed in reqs]
    serve(banks[0], reqs[0][1], state, cuda_gen(torch, 0))      # warm
    torch.cuda.synchronize()
    out, lat = [], []
    t0 = time.perf_counter()
    for (t, q, _), g in zip(reqs, gens):
        pred, sim = serve(banks[t], q, state, g)
        out.append((pred.cpu().numpy(), sim.cpu().numpy()))
        lat.append(time.perf_counter() - t0)                     # queueing included
    return out, lat, time.perf_counter() - t0


def mt_continuous(torch, eng, reqs, launches, what: str) -> tuple:
    """The same requests through the slot ring (all queued at t = 0, noise
    generators seeded alike), after a warm step of a full ring; the launch
    counters set to 0 just before and read just after. Gates one search
    launch a step and ceil(R / slots) steps. Returns (completions in request
    order, wall, steps, counts)."""
    from repro_torch import kernels as tk
    from repro_torch.serving import HDCScheduler

    warm = HDCScheduler(eng)
    for _ in range(eng.num_slots):
        warm.submit(reqs[0][0], reqs[0][1], generator=cuda_gen(torch, 0))
    warm.run(timeout=600)
    gens = [cuda_gen(torch, seed) for _, _, seed in reqs]
    sched = HDCScheduler(eng, clock=time.perf_counter)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [sched.submit(t, q, generator=g) for (t, q, _), g in zip(reqs, gens)]
    sched.run(timeout=600)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    want = SERVE_KERNELS[("ota", eng.cfg.representation)]
    steps = -(-len(reqs) // eng.num_slots)
    require(sched.steps == steps, f"{what}: {sched.steps} steps, expected {steps}")
    require(all(counts[k] == steps for k in want)
            and all(v == 0 for k, v in counts.items() if k not in want),
            f"{what}: launches {counts}, expected one {want} a step ({steps}) and nothing else")
    add_launches(launches, counts)
    return [sched.results[r] for r in rids], wall, sched.steps, counts


def mt_identity(done, static, what: str) -> None:
    import numpy as np

    bad = [i for i, (c, (p, s)) in enumerate(zip(done, static))
           if c.status != "ok" or not (np.array_equal(c.pred, p) and np.array_equal(c.maxsim, s))]
    require(not bad, f"{what}: {len(bad)} completions differ from their standalone serve "
                     f"(first request {bad[:1]})")


def mt_workload(torch, cfg, state, books, trace, slots, label, launches) -> tuple:
    """Static against continuous on one trace: identity, steps, launches, and
    trials/s and latencies of both. Returns (row, engine, requests, static
    answers)."""
    from repro_torch.core import hypervector as hv
    from repro_torch.serving import HDCEngine

    banks = [hv.pack(b) if cfg.packed else b for b in books]
    reqs = mt_requests(torch, cfg, books, trace)
    static, s_lat, s_wall = mt_static(torch, cfg, state, banks, reqs)
    eng = HDCEngine(cfg, state, num_slots=slots, max_tenants=len(books))
    for t, b in enumerate(banks):
        eng.registry.onboard(t, b)
    done, c_wall, steps, counts = mt_continuous(torch, eng, reqs, launches, label)
    mt_identity(done, static, label)
    n_trials = len(reqs) * cfg.batch
    row = dict(requests=len(reqs), slots=slots, tenants=len(books), batch=cfg.batch,
               steps=steps, launches=counts,
               static=dict(wall_s=s_wall, trials_per_s=n_trials / s_wall, **latency_pcts(s_lat)),
               continuous=dict(wall_s=c_wall, trials_per_s=n_trials / c_wall,
                               ms_per_step=c_wall / steps * 1e3,
                               **latency_pcts([c.latency for c in done])))
    row["ratio"] = row["continuous"]["trials_per_s"] / row["static"]["trials_per_s"]
    c, st = row["continuous"], row["static"]
    print(f"mt {label}: {len(reqs)} requests x {cfg.batch} trials, {len(books)} tenants, "
          f"{slots} slots: continuous {c['trials_per_s']:.1f} trials/s ({steps} steps, "
          f"{c['ms_per_step']:.4f} ms/step, p50 {c['p50_ms']:.4f} ms, p95 {c['p95_ms']:.4f} "
          f"ms), static {st['trials_per_s']:.1f} trials/s (p50 {st['p50_ms']:.4f} ms, p95 "
          f"{st['p95_ms']:.4f} ms), ratio {row['ratio']:.4f}; launches {counts}", flush=True)
    return row, eng, reqs, static


def mt_lifecycle(torch, eng, cfg, state, books, new_book, reqs, static, launches) -> dict:
    """Evict tenant 0 and onboard a new tenant into its row; evict tenant 1
    and re-onboard tenant 0 into that (other) row. Tenant 0's requests, served
    again on generators seeded alike, answer as before, and the new tenant's
    equal its standalone serves."""
    from repro_torch.core import hypervector as hv

    pack = (lambda b: hv.pack(b)) if cfg.packed else (lambda b: b)
    row0 = eng.registry.rows[0]
    eng.registry.evict(0)
    require(eng.registry.onboard("new", pack(new_book)) == row0,
            "lifecycle: the new tenant did not take the evicted row")
    row1 = eng.registry.rows[1]
    eng.registry.evict(1)
    require(eng.registry.onboard(0, pack(books[0])) == row1 != row0,
            "lifecycle: tenant 0 did not come back on another row")
    again = [(i, r) for i, r in enumerate(reqs) if r[0] == 0][:eng.num_slots]
    require(bool(again), "lifecycle: the trace holds no request of tenant 0")
    fresh = [("new", q, seed + 5000) for _, (_, q, seed) in again]
    want_new, _, _ = mt_static(torch, cfg, state, {"new": pack(new_book)} | {0: pack(books[0])},
                               fresh)
    done, _, _, counts = mt_continuous(torch, eng, [r for _, r in again] + fresh, launches,
                                       "lifecycle")
    mt_identity(done[:len(again)], [static[i] for i, _ in again], "lifecycle: tenant 0")
    mt_identity(done[len(again):], want_new, "lifecycle: the new tenant")
    print(f"mt lifecycle: tenant 0 row {row0} -> {row1}, the new tenant on row {row0}; "
          f"{len(again)} of tenant 0's requests answer as before, {len(fresh)} of the new "
          "tenant's equal their standalone serves", flush=True)
    return dict(row0=row0, row1=row1, requests=len(again) + len(fresh), launches=counts)


def mt_profile(torch, eng, state, reqs, label: str) -> dict:
    """A full-ring step (results to the host included) CALLS times under
    torch.profiler; then, alone, the step's tenant gather (packed: the
    `index_select` of the table rows named by ``bank_rows`` before the top-1
    launch; unpacked: the `index_select` of the slots' store rows before the
    matmul launch), named by its kernel, and its per-slot PHY fan-out, each
    against the step's device busy time. Baseline serves only."""
    from repro_torch import phy
    from repro_torch.core import scaleout

    cfg, n = eng.cfg, eng.num_slots
    st = eng.admit_many(eng.init_state(), [q for _, q, _ in reqs[:n]],
                        [t for t, _, _ in reqs[:n]], list(range(n)),
                        [cuda_gen(torch, s) for s in range(n)])
    step = profile_calls(torch, f"mt step {label}", [
        lambda: [x.cpu() for x in eng.step(eng.params, st)[1]]] * CALLS)
    store = eng.registry.store
    n_core = cfg.n_rx_cores
    if cfg.packed:
        table = store.reshape(store.shape[0] * n_core, -1, store.shape[-1])
        bank_rows = (st["row"][:, None] * n_core
                     + torch.arange(n_core, dtype=torch.int32, device="cuda")).reshape(-1)
        what, rows = "bank_rows gather", bank_rows
    else:
        table, rows, what = store, st["row"], "store-row gather"
    gather = profile_calls(torch, f"mt gather {label}", [
        lambda: table.index_select(0, rows)] * CALLS)
    gather_share = gather["device_busy_ms_per_call"] / step["device_busy_ms_per_call"]
    kernel = gather["top"][0][0] if gather["top"] else "no device op recorded"
    print(f"mt profile {label}: the {what} ({kernel}) is "
          f"{gather_share:.4f} of the step's device busy time "
          f"({gather['device_busy_ms_per_call']:.5f} ms)", flush=True)
    chan = phy.get_channel(cfg.channel)
    sh = scaleout._shard_of(cfg, None)
    q = st["queries"][:, :, 0]
    qb = scaleout._ota_bundle(cfg, chan, sh, q.reshape((-1,) + tuple(q.shape[2:])))
    qb = qb.reshape((n, -1) + tuple(qb.shape[1:]))
    gens = [cuda_gen(torch, s) for s in range(n)]
    fan = profile_calls(torch, f"mt fan-out {label}", [
        lambda: [scaleout._rx_fanout(cfg, chan, sh, qb[s], state, gens[s]) for s in range(n)]]
        * CALLS)
    share = fan["device_busy_ms_per_call"] / step["device_busy_ms_per_call"]
    print(f"mt profile {label}: the per-slot fan-out is {share:.4f} of the step's device busy "
          f"time ({fan['device_busy_ms_per_call']:.4f} of {step['device_busy_ms_per_call']:.4f} "
          f"ms), {fan['device_ops_per_call']:.0f} of {step['device_ops_per_call']:.0f} device "
          "ops", flush=True)
    return dict(step=step, gather=gather, gather_busy_share=gather_share, fanout=fan,
                fanout_busy_share=share)


def mt_adaptive(torch, launches) -> dict:
    """The drift benchmark's serving point: AdaptiveHDCEngine under
    StaticProcess equals HDCEngine bit for bit; under PhaseDriftProcess the
    trials/s and the controller's action counts are reported."""
    from repro_torch import phy
    from repro_torch.core import classifier, scaleout
    from repro_torch.serving import AdaptiveHDCEngine, HDCEngine, LinkControllerConfig

    d = MT_DRIFT
    cfg = scaleout.ScaleOutConfig(n_classes=d["n_classes"], n_rx_cores=d["n_rx"],
                                  batch=d["batch"], channel="symbol")
    state = scaleout.precharacterize_state(cfg)
    books = classifier.make_tenant_codebooks(
        [cuda_gen(torch, t) for t in range(d["tenants"])],
        classifier.HDCTaskConfig(n_classes=d["n_classes"], dim=cfg.dim))
    reqs = mt_requests(torch, cfg, books, [i % d["tenants"] for i in range(d["requests"])])
    ctl = LinkControllerConfig(patience=1, band_kwargs={"cap": d["cap"]})

    def run(eng, what):
        for t, b in enumerate(books):
            eng.registry.onboard(t, b)
        return mt_continuous(torch, eng, reqs, launches, what)

    plain, _, _, _ = run(HDCEngine(cfg, state, num_slots=d["slots"], max_tenants=2), "static")
    static, _, _, _ = run(AdaptiveHDCEngine(cfg, state, process=phy.StaticProcess(),
                                            num_slots=d["slots"], max_tenants=2,
                                            controller=ctl), "adaptive static")
    mt_identity(static, [(c.pred, c.maxsim) for c in plain],
                "adaptive engine under StaticProcess")
    proc = phy.PhaseDriftProcess(sigma=d["sigma"], alpha=d["alpha"], guard_dims=d["guard"])
    eng = AdaptiveHDCEngine(cfg, state, process=proc, num_slots=d["slots"], max_tenants=2,
                            controller=ctl)
    _, wall, steps, _ = run(eng, "adaptive drift")
    actions = {}
    for e in eng.controller.trace:
        actions[e["action"]] = actions.get(e["action"], 0) + 1
    row = dict(trials_per_s=d["requests"] * d["batch"] / wall, wall_s=wall, steps=steps,
               actions=actions, n_refits=eng.controller.n_refits)
    print(f"mt adaptive ({d['n_rx']} RX, C = {d['n_classes']}, symbol, PhaseDriftProcess sigma "
          f"{d['sigma']}, {d['slots']} slots, {d['requests']} requests x {d['batch']}): "
          f"{row['trials_per_s']:.1f} trials/s, {steps} steps, actions {actions} "
          f"({row['n_refits']} re-fits); StaticProcess == HDCEngine", flush=True)
    return row


def phase_mt(torch, state, launches, profile: bool = False) -> dict:
    """Phase 13: multi-tenant serving, workloads (a), (b) and (c)."""
    import dataclasses

    from repro_torch.core import classifier, scaleout

    base = scaleout.ScaleOutConfig()
    task = classifier.HDCTaskConfig(n_classes=base.n_classes, dim=base.dim)
    out = {}
    a = MT_TRACE
    books = classifier.make_tenant_codebooks([cuda_gen(torch, t) for t in range(a["tenants"])],
                                             task)
    trace = poisson_race(a["requests"], a["tenants"])
    for perm, rep in ((False, "packed"), (False, "unpacked"), (True, "packed")):
        cfg = dataclasses.replace(base, batch=a["batch"], permuted=perm, representation=rep)
        label = f"(a) {'permuted' if perm else 'baseline'} {rep}"
        out[label], eng, reqs, _ = mt_workload(torch, cfg, state, books, trace, a["slots"],
                                               label, launches)
        if profile and not perm:
            out[f"profile {label}"] = mt_profile(torch, eng, state, reqs, label)
    b = MT_BATCH
    books = classifier.make_tenant_codebooks(
        [cuda_gen(torch, t) for t in range(b["tenants"] + 1)], task)
    trace = poisson_race(b["requests"], b["tenants"])
    for channel in ("bsc", "symbol"):
        cfg = dataclasses.replace(base, batch=b["batch"], representation="packed",
                                  channel=channel)
        label = f"(b) {channel} baseline packed"
        out[label], eng, reqs, static = mt_workload(torch, cfg, state, books[:-1], trace,
                                                    b["slots"], label, launches)
        out[f"lifecycle {label}"] = mt_lifecycle(torch, eng, cfg, state, books[:-1], books[-1],
                                                 reqs, static, launches)
        if profile and channel == "bsc":
            out[f"profile {label}"] = mt_profile(torch, eng, state, reqs, label)
    out["(c) adaptive"] = mt_adaptive(torch, launches)
    print("mt checks: every completion == its standalone serve ((a) three modes, (b) bsc and "
          f"symbol), {-(-a['requests'] // a['slots'])} steps for {a['requests']} requests over "
          f"{a['slots']} slots, one search launch a step, the tenant lifecycle, StaticProcess "
          "adaptive == static", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: fault tolerance
# ---------------------------------------------------------------------------

def injected(torch, cfg, k_dead: int, density: float, failover: bool, seed: int = 7):
    """The healthy fault state of ``cfg`` with cores 0..k_dead-1 dead and
    stuck cells at ``density`` (drawn on a generator seeded ``seed``, so
    every scenario of one density sees the same cells), failed over when
    asked (one shard on one GPU)."""
    from repro_torch import faults

    f = faults.healthy_for(cfg)
    if k_dead:
        f = faults.inject(f, dead_rx=list(range(k_dead)))
    if density:
        s0, s1 = faults.sample_stuck_cells(cuda_gen(torch, seed), cfg.n_rx_cores, cfg.words,
                                           density)
        f = faults.inject(f, stuck0=s0, stuck1=s1)
    return faults.plan_failover(f, cfg.n_rx_cores) if failover else f


def chaos(torch, launches) -> dict:
    """(a) The pinned chaos scenario (BENCH_BASELINE.json serving_faults):
    zero-fault identity, baseline / unaware / aware draw accuracy held to the
    row's bounds, the degradation curve, the stuck sweep and the
    fault-tolerant engine's trials/s."""
    from repro_torch import faults, phy
    from repro_torch.core import hypervector as hv, scaleout
    from repro_torch.serving import FaultControllerConfig, FaultTolerantHDCEngine

    row = json.loads((ROOT / "BENCH_BASELINE.json").read_text())["serving_faults"]
    sc = row["scenario"]
    cfg = scaleout.ScaleOutConfig(
        n_classes=sc["n_classes"], dim=sc["dim"], m_tx=sc["m_tx"], n_rx_cores=sc["n_rx"],
        batch=sc["batch"], permuted=True, channel=sc["channel"], collective=sc["collective"],
        representation=sc["representation"])
    seed = sc["seed"]
    protos_u = hv.random_hv(cuda_gen(torch, seed), cfg.n_classes, cfg.dim)
    protos = hv.pack(protos_u)
    state = phy.state_from_ber(torch.full((cfg.n_rx_cores,), sc["ber"], device="cuda"),
                               cfg.m_tx)
    batches = [scaleout.make_queries(cuda_gen(torch, seed + 100 + i), cfg, protos_u)
               for i in range(sc["n_batches"])]
    noise = [seed + 200 + i for i in range(sc["n_batches"])]
    fserve = scaleout.make_ota_serve(cfg, faults=faults.StaticFaults())
    plain = scaleout.make_ota_serve(cfg)
    healthy = faults.healthy_for(cfg)
    p0, s0 = plain(protos, batches[0][1], state, cuda_gen(torch, noise[0]))
    p1, s1, _ = fserve(protos, batches[0][1], state, cuda_gen(torch, noise[0]), healthy, None)
    zero_fault_identical = bool(torch.equal(p0, p1) and torch.equal(s0, s1))
    require(zero_fault_identical, "chaos: the healthy fault-aware serve differs from the plain")

    def acc(f):
        hits = total = 0
        for (cls, q), s in zip(batches, noise):
            pred, _, _ = fserve(protos, q, state, cuda_gen(torch, s), f, None)
            hits += int((pred == cls).sum())
            total += pred.numel()
        return hits / total

    def scenario(k, density, failover):
        return acc(injected(torch, cfg, k, density, failover, seed + 7))

    def run():
        out = dict(baseline=scenario(0, 0.0, False),
                   unaware=scenario(sc["k_dead"], sc["stuck_density"], False),
                   aware=scenario(sc["k_dead"], sc["stuck_density"], True))
        out["curve"] = [dict(k_dead=k, unaware=scenario(k, 0.0, False),
                             aware=scenario(k, 0.0, True)) for k in CHAOS_CURVE]
        out["stuck"] = [dict(density=p, aware=scenario(0, p, True)) for p in CHAOS_STUCK]
        return out

    out, sec, counts = counted(torch, run)
    require_only(counts, ("hamming_topk_banked",), "chaos serves")
    add_launches(launches, counts)
    drop = 100.0 * (out["baseline"] - out["unaware"])
    gap = 100.0 * (out["baseline"] - out["aware"])
    out.update(zero_fault_identical=zero_fault_identical, unaware_drop_pts=drop,
               aware_gap_pts=gap, serves_s=sec, launches=counts)
    print(f"chaos ({sc['n_rx']} RX, C = {cfg.n_classes}, d = {cfg.dim}, M = {cfg.m_tx}, permuted "
          f"packed psum bsc at BER {sc['ber']}, {sc['k_dead']} dead cores + "
          f"{100 * sc['stuck_density']:g}% stuck cells, {sc['n_batches']} x {sc['batch']} "
          f"trials, seed {seed}): zero_fault_identical {zero_fault_identical}; draw accuracy "
          f"baseline {out['baseline']:.4f}, unaware {out['unaware']:.4f} (drop {drop:.2f} "
          f"pts, bound >= {row['min_unaware_drop_pts']}), aware {out['aware']:.4f} (gap "
          f"{gap:.2f} pts, bound <= {row['max_aware_gap_pts']})", flush=True)
    print("chaos curve (k dead: unaware / aware): " + ", ".join(
        f"{r['k_dead']}: {r['unaware']:.4f} / {r['aware']:.4f}" for r in out["curve"])
        + "; stuck sweep (aware): " + ", ".join(
        f"{r['density']:g}: {r['aware']:.4f}" for r in out["stuck"]), flush=True)
    require(drop >= row["min_unaware_drop_pts"],
            f"chaos: the unaware serve drops {drop:.2f} pts < {row['min_unaware_drop_pts']}")
    require(gap <= row["max_aware_gap_pts"],
            f"chaos: the aware serve is {gap:.2f} pts off > {row['max_aware_gap_pts']}")
    e = CHAOS_ENGINE
    fstate = injected(torch, cfg, sc["k_dead"], 0.0, True)
    eng = FaultTolerantHDCEngine(cfg, state, process=phy.StaticProcess(),
                                 fault_model=faults.StaticFaults(), num_slots=e["slots"],
                                 max_tenants=1, fstate=fstate,
                                 controller=FaultControllerConfig(band_kwargs={"cap": 0.05}))
    eng.registry.onboard(0, protos)
    reqs = [(0, batches[i % len(batches)][1], 1000 + i) for i in range(e["requests"])]
    static, _, _ = mt_static(torch, cfg, state, [protos], reqs, fstate)
    done, wall, steps, counts = mt_continuous(torch, eng, reqs, launches, "chaos engine")
    mt_identity(done, static, "chaos engine")
    out["engine"] = dict(trials_per_s=e["requests"] * cfg.batch / wall, wall_s=wall,
                         steps=steps, launches=counts)
    print(f"chaos engine: FaultTolerantHDCEngine, {e['slots']} slots, {e['requests']} requests "
          f"x {cfg.batch} trials, {sc['k_dead']} dead cores failed over: "
          f"{out['engine']['trials_per_s']:.1f} trials/s ({steps} steps), every completion == "
          f"its standalone fault-aware serve", flush=True)
    return out


def fault_paper(torch, state, launches, profile: bool = False) -> dict:
    """(b) The paper's configuration on phase 3's state: the healthy
    fault-aware serve == the fault-free serve in every mode (CALLS calls on
    the seeds of phases 4-5) with both serves' ms (with ``profile``, the
    bsc baseline serves of both kinds under torch.profiler too); the stuck
    mask and the RX-fault gather alone; vote erasure of TXs 1 and 2 ==
    m_active = 1; and 8 of 64 cores dead + 1% stuck cells, unaware against
    aware, in the four bsc modes."""
    import dataclasses

    from repro_torch import faults, phy
    from repro_torch.core import classifier, hypervector as hv, scaleout

    base = scaleout.ScaleOutConfig()
    protos_u = classifier.make_codebook(
        cuda_gen(torch, 0), classifier.HDCTaskConfig(n_classes=base.n_classes, dim=base.dim))
    healthy = faults.healthy_for(base)
    static = faults.StaticFaults()
    modes = ([(f"{ch} {'permuted' if perm else 'baseline'} {rep}",
               dict(channel=ch, permuted=perm, representation=rep))
              for ch in ("bsc", "symbol") for perm in (False, True)
              for rep in ("unpacked", "packed")]
             + [("ideal baseline packed", dict(channel="ideal", representation="packed")),
                (f"bsc coarse packed (groups of {FAULTS_PAPER['coarse_group']}, "
                 f"{FAULTS_PAPER['coarse_keep']} kept)",
                 dict(representation="packed", coarse_group=FAULTS_PAPER["coarse_group"],
                      coarse_keep=FAULTS_PAPER["coarse_keep"])),
                ("bsc baseline packed, StaticProcess",
                 dict(representation="packed", process="static"))])
    out = {}

    def setup(kw):
        kw = dict(kw)
        proc = phy.StaticProcess() if kw.pop("process", None) else None
        cfg = dataclasses.replace(base, **kw)
        protos = hv.pack(protos_u) if cfg.packed else protos_u
        gq = cuda_gen(torch, 1)
        batches = [scaleout.make_queries(gq, cfg, protos_u) for _ in range(CALLS)]
        return cfg, proc, protos, batches

    for label, kw in modes:
        cfg, proc, protos, batches = setup(kw)
        chan = proc.init(state) if proc else state
        tail = (None,) if proc else ()
        plain = scaleout.make_ota_serve(cfg, process=proc)
        fserve = scaleout.make_ota_serve(cfg, process=proc, faults=static)
        gp, gf = cuda_gen(torch, 2), cuda_gen(torch, 2)
        want = [plain(protos, q, chan, gp, *tail)[:2] for _, q in batches]
        got, sec, counts = counted(torch, lambda: [
            fserve(protos, q, chan, gf, *tail, healthy, None)[:2] for _, q in batches])
        want_k = (("hamming_topk_k_banked",) if cfg.coarse_group
                  else SERVE_KERNELS[("ota", cfg.representation)])
        require_only(counts, want_k, f"faults (b) {label}")
        add_launches(launches, counts)
        same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(want, got))
        require(same, f"faults (b) {label}: the healthy fault-aware serve differs from the "
                      "fault-free serve")
        q = batches[0][1]
        ms = call_ms(torch, lambda: plain(protos, q, chan, gp, *tail), samples=5)
        fms = call_ms(torch, lambda: fserve(protos, q, chan, gf, *tail, healthy, None),
                      samples=5)
        out[label] = dict(ms=ms, fault_ms=fms, launches=counts)
        print(f"faults (b) {label}: healthy fault-aware == fault-free over {CALLS} calls "
              f"(pred and maxsim); {fms:.4f} ms a call vs {ms:.4f} fault-free", flush=True)
        if profile and label.startswith("bsc baseline") and proc is None:
            out[label]["profile"] = {
                "fault-free": profile_calls(torch, f"faults (b) {label} fault-free", [
                    lambda q=q: plain(protos, q, chan, gp) for _, q in batches]),
                "fault-aware": profile_calls(torch, f"faults (b) {label} fault-aware", [
                    lambda q=q: fserve(protos, q, chan, gf, healthy, None)
                    for _, q in batches])}
    # the two fault stages alone, at the serve's shapes
    f = injected(torch, base, FAULTS_PAPER["k_dead"], FAULTS_PAPER["stuck_density"], True)
    stages = {}
    for rep, last in (("packed", base.words), ("unpacked", base.dim)):
        dtype = torch.int32 if rep == "packed" else torch.uint8
        store = torch.zeros((1, base.n_rx_cores, base.n_classes // base.n_rx_cores, last),
                            dtype=dtype, device="cuda")
        q_rx = torch.zeros((1, base.n_rx_cores, base.batch, last), dtype=dtype, device="cuda")
        stuck = (f.stuck0, f.stuck1)
        stages[rep] = dict(
            stuck_ms=call_ms(torch, lambda: scaleout._apply_stuck(store, stuck, base.dim,
                                                                  rep == "packed")),
            rx_faults_ms=call_ms(torch, lambda: scaleout._apply_rx_faults(f, q_rx, None)))
    out["stages"] = stages
    print("faults (b) stages alone (CUDA events over 20 back-to-back calls): " + "; ".join(
        f"{rep}: stuck mask on the store {v['stuck_ms']:.4f} ms, dead-core zeroing + "
        f"failover gather {v['rx_faults_ms']:.4f} ms" for rep, v in stages.items()), flush=True)
    # vote erasure of TXs 1 and 2 == the m_active = 1 serve
    for rep in ("unpacked", "packed"):
        cfg, _, protos, batches = setup(dict(permuted=True, representation=rep))
        oracle = scaleout.make_ota_serve(dataclasses.replace(cfg, m_active=1))
        fserve = scaleout.make_ota_serve(cfg, faults=static)
        erased = faults.inject(healthy, vote_drop=[1, 2])
        go, gf = cuda_gen(torch, 2), cuda_gen(torch, 2)
        for _, q in batches[:2]:
            a = oracle(protos, q, state, go)
            b = fserve(protos, q, state, gf, erased, None)
            require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                    f"faults (b) vote erasure {rep}: differs from the m_active=1 serve")
    print("faults (b) vote erasure of TXs 1 and 2 == the m_active = 1 serve, permuted "
          "unpacked and packed", flush=True)
    # 8 of 64 cores dead + 1% stuck cells: unaware against aware
    acc = {}
    for label, kw in modes[:4]:
        cfg, _, protos, batches = setup(kw)
        fserve = scaleout.make_ota_serve(cfg, faults=static)
        row = {}
        for name, failover in (("unaware", False), ("aware", True)):
            f = injected(torch, cfg, FAULTS_PAPER["k_dead"], FAULTS_PAPER["stuck_density"],
                         failover)
            g = cuda_gen(torch, 2)
            run, _, counts = counted(torch, lambda: dict(
                pred=torch.cat([fserve(protos, q, state, g, f, None)[0] for _, q in batches]),
                classes=torch.cat([c for c, _ in batches])))
            add_launches(launches, counts)
            row[name] = hit_rate(torch, run, cfg.permuted)
        key = "draw_acc" if cfg.permuted else "hit"
        require(row["aware"][key] >= row["unaware"][key],
                f"faults (b) {label}: aware {row['aware']} below unaware {row['unaware']}")
        acc[label] = row
        print(f"faults (b) {label}, {FAULTS_PAPER['k_dead']} of {cfg.n_rx_cores} cores dead + "
              f"{100 * FAULTS_PAPER['stuck_density']:g}% stuck cells: unaware "
              f"{json.dumps(row['unaware'])}, aware {json.dumps(row['aware'])}", flush=True)
    out["dead_and_stuck"] = acc
    return out


def fault_engine(torch, state, launches) -> dict:
    """(c) FaultTolerantHDCEngine on phase 13 (b)'s trace (bsc, packed,
    StaticProcess, StaticFaults; 8 of 64 cores dead, failed over, 1% stuck
    cells): every completion == its standalone fault-aware serve, one search
    launch a step, trials/s beside AdaptiveHDCEngine's; then a short
    WearoutFaults run, reported only."""
    import dataclasses

    from repro_torch import faults, phy
    from repro_torch.core import classifier, hypervector as hv, scaleout
    from repro_torch.serving import AdaptiveHDCEngine, FaultTolerantHDCEngine

    b = MT_BATCH
    base = scaleout.ScaleOutConfig()
    cfg = dataclasses.replace(base, batch=b["batch"], representation="packed")
    task = classifier.HDCTaskConfig(n_classes=base.n_classes, dim=base.dim)
    books = classifier.make_tenant_codebooks([cuda_gen(torch, t) for t in range(b["tenants"])],
                                             task)
    banks = [hv.pack(bk) for bk in books]
    trace = poisson_race(b["requests"], b["tenants"])
    reqs = mt_requests(torch, cfg, books, trace)
    fstate = injected(torch, cfg, FAULTS_PAPER["k_dead"], FAULTS_PAPER["stuck_density"], True)

    def engine(kind, **kw):
        eng = kind(cfg, state, process=phy.StaticProcess(), num_slots=b["slots"],
                   max_tenants=b["tenants"], **kw)
        for t, bank in enumerate(banks):
            eng.registry.onboard(t, bank)
        return eng

    static, _, _ = mt_static(torch, cfg, state, banks, reqs, fstate)
    ft = engine(FaultTolerantHDCEngine, fault_model=faults.StaticFaults(), fstate=fstate)
    store_c = ft.registry.store.reshape(b["tenants"], cfg.n_rx_cores, -1, cfg.words)
    stuck_ms = call_ms(torch, lambda: scaleout._apply_stuck(
        store_c, (fstate.stuck0, fstate.stuck1), cfg.dim, True))
    done, wall, steps, counts = mt_continuous(torch, ft, reqs, launches, "faults (c)")
    mt_identity(done, static, "faults (c)")
    _, a_wall, a_steps, _ = mt_continuous(torch, engine(AdaptiveHDCEngine), reqs, launches,
                                          "faults (c) adaptive")
    n_trials = len(reqs) * cfg.batch
    out = dict(trials_per_s=n_trials / wall, ms_per_step=wall / steps * 1e3, steps=steps,
               launches=counts, store_stuck_ms=stuck_ms, adaptive=dict(trials_per_s=n_trials / a_wall,
                                              ms_per_step=a_wall / a_steps * 1e3))
    print(f"faults (c) FaultTolerantHDCEngine: {len(reqs)} requests x {cfg.batch} trials, "
          f"{b['tenants']} tenants, {b['slots']} slots, {FAULTS_PAPER['k_dead']} dead cores "
          f"failed over + {100 * FAULTS_PAPER['stuck_density']:g}% stuck cells: "
          f"{out['trials_per_s']:.1f} trials/s, {out['ms_per_step']:.4f} ms/step ({steps} "
          f"steps, launches {counts}); AdaptiveHDCEngine healthy "
          f"{out['adaptive']['trials_per_s']:.1f} trials/s, "
          f"{out['adaptive']['ms_per_step']:.4f} ms/step; every completion == its standalone "
          f"fault-aware serve; the stuck mask on the {b['tenants']}-tenant store alone "
          f"{stuck_ms:.4f} ms", flush=True)
    # a short wearout run: cores die and cells stick as the steps go
    model = faults.WearoutFaults(**WEAROUT)
    wear = engine(FaultTolerantHDCEngine, fault_model=model,
                  fault_generator=cuda_gen(torch, 7))
    dead = []
    commit = wear.on_barrier

    def on_barrier():
        commit()
        dead.append(int(wear.fstate.dead_rx.sum()))

    wear.on_barrier = on_barrier
    sched_done, _, w_steps, counts = mt_continuous(torch, wear, reqs, launches, "wearout")
    dead = dead[-w_steps:]                       # the measured run's barriers
    classes = [scaleout.make_queries(cuda_gen(torch, 100 + i), cfg, books[t])[0]
               for i, t in enumerate(trace)]
    hits = [float((torch.from_numpy(c.pred)[:, None] == cls.cpu()).any(1).float().mean())
            for c, cls in zip(sched_done, classes)]
    per_step = [sum(hits[i:i + b["slots"]]) / len(hits[i:i + b["slots"]])
                for i in range(0, len(hits), b["slots"])]
    out["wearout"] = dict(model=WEAROUT, dead_cores=dead, hit_per_step=per_step)
    print(f"faults (c) wearout (p_die {WEAROUT['p_die']}, stuck_rate {WEAROUT['stuck_rate']}, "
          f"no failover): dead cores after each step {dead}, hit rate per step "
          + ", ".join(f"{h:.4f}" for h in per_step), flush=True)
    return out


def phase_faults(torch, state, launches, profile: bool = False) -> dict:
    """Phase 14: fault tolerance, parts (a), (b) and (c)."""
    out = dict(chaos=chaos(torch, launches),
               paper=fault_paper(torch, state, launches, profile=profile),
               engine=fault_engine(torch, state, launches))
    print("fault checks: chaos zero_fault_identical, unaware drop and aware gap within the "
          "serving_faults bounds, every healthy fault-aware serve == its fault-free serve, "
          "vote erasure == m_active = 1, aware >= unaware, every engine completion == its "
          "standalone fault-aware serve, one search launch a step", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: continuous LM serving
# ---------------------------------------------------------------------------

def cont_trace(cfg, spec: dict, seed: int = SEED) -> list:
    """The reference serving bench's request mix (benchmarks/serving.py:39-44):
    the lengths cycled over the requests and shuffled, then each prompt drawn
    from the same numpy generator. Returns the prompts [S] int32 on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lens = [int(spec["lengths"][i % len(spec["lengths"])]) for i in range(spec["requests"])]
    rng.shuffle(lens)
    return [torch.as_tensor(rng.integers(0, cfg.vocab, (n,)), dtype=torch.int32, device="cuda")
            for n in lens]


def cont_static(torch, model, params, prompts, max_new: int, warm: bool = True) -> dict:
    """One static B = 1 `Engine.generate` a request, in order, each result
    brought to the host (what the continuous run is held to), after one warm
    generate a prompt length when timed (``warm``): tokens, latencies
    (queueing included), wall."""
    from repro_torch.serving import Engine, ServeConfig

    eng = Engine(model, ServeConfig(max_new=max_new))
    for n in sorted({p.shape[0] for p in prompts}) if warm else ():
        eng.generate(params, {"tokens": next(p for p in prompts if p.shape[0] == n)[None]})
    torch.cuda.synchronize()
    toks, lat = [], []
    t0 = time.perf_counter()
    for p in prompts:
        toks.append(eng.generate(params, {"tokens": p[None]})[0].tolist())
        lat.append(time.perf_counter() - t0)
    return dict(tokens=toks, lat=lat, wall=time.perf_counter() - t0)


def cont_serve(torch, model, params, prompts, slots: int, max_new: int, chunk=None,
               watch: int | None = None, what: str = "cont") -> dict:
    """The requests through `Scheduler` + `ContinuousEngine`, all queued at
    t = 0, after a warm-up that serves one request of each prompt length;
    the launch counters set to 0 just before and read just after. Gates
    `flash_attention_fwd` as the only kernel, with 22 launches (one a layer)
    for each whole-prompt admission and each prefill chunk, none in a
    decode step. The kernel's inputs at each call signature of the counted
    run are kept and, after it, the kernel is held against its plain twin
    on them (`attention_checks`). Returns the completions in request order,
    wall, steps, the longest host-clock gap between two successive decode
    steps, and of those the longest in which a prompt of length ``watch``
    was admitting, both also over the gaps a request decoded across (the
    wait between two of its tokens), the counts, those checks, the engine's
    signature sets and the first step's logits."""
    from repro_torch import kernels as tk
    from repro_torch.serving import ContinuousEngine, Scheduler, ServeConfig

    lens = [int(p.shape[0]) for p in prompts]
    eng = ContinuousEngine(model, ServeConfig(max_new=max_new), num_slots=slots,
                           max_prompt_len=max(lens), prefill_chunk=chunk)
    warm = Scheduler(eng, params)
    for n in sorted(set(lens)):
        warm.submit(torch.zeros((n,), dtype=torch.int32), max_new=min(2, max_new))
    warm.run(timeout=600)
    eng._prefill_sigs.clear()
    eng._chunk_sigs.clear()
    first = []
    sample = eng._sample_slots

    def keep_first(logits, generators):
        if not first:
            first.append(logits.clone())
        return sample(logits, generators)

    eng._sample_slots = keep_first
    seen = {}

    def record(q, k, v, **kw):
        """The kernel; its inputs kept at each new call signature (the
        first layer's), for the check after the run."""
        sig = (tuple(q.shape), tuple(k.shape), kw.get("q_offset", 0))
        if sig not in seen:
            seen[sig] = (q.clone(), k.clone(), v.clone(), kw)
        return tk.flash_attention_fwd(q, k, v, **kw)

    sched = Scheduler(eng, params, clock=time.perf_counter)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [sched.submit(p) for p in prompts]
    last, gaps, touched, first_slots = None, [], set(), None
    with using(record):
        while sched.pending or sched.active:
            running = {rec[0].rid for rec in sched.running.values()}
            touched |= {req.rid for req, _ in sched.admitting.values()}
            n = sched.steps
            sched.step()
            touched |= {req.rid for req, _ in sched.admitting.values()}
            touched |= {rec[0].rid for rec in sched.running.values()} - running
            if sched.steps == n:
                continue
            now = time.perf_counter()
            if last is not None:     # (gap, a `watch` prompt admitting, someone decoding across)
                gaps.append((now - last,
                             watch is not None and any(lens[r] == watch for r in touched),
                             bool(running)))
            last = now
            if first_slots is None:
                first_slots = {slot: rec[0].rid for slot, rec in sched.running.items()}
            touched = set()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    admissions = sum(-(-n // chunk) if chunk and n > chunk else 1 for n in lens)
    want = model.cfg.n_layers * admissions
    require(counts["flash_attention_fwd"] == want and
            all(v == 0 for k, v in counts.items() if k != "flash_attention_fwd"),
            f"{what}: launches {counts}, expected {want} flash_attention_fwd "
            f"({model.cfg.n_layers} a whole-prompt admission or chunk, {admissions} of them, "
            f"none in {sched.steps} decode steps) and nothing else")
    checks = attention_checks(torch, seen, what)

    def longest(keep):
        sel = [g for g, hit, dec in gaps if keep(hit, dec)]
        return max(sel) * 1e3 if sel else None
    done = [sched.results[r] for r in rids]
    n_tok = sum(len(c.tokens) for c in done)
    return dict(done=done, wall=wall, steps=sched.steps, tokens=n_tok, counts=counts,
                checks=checks, admissions=admissions, first_logits=first[0],
                first_slots=first_slots,
                prefill_sigs=set(eng._prefill_sigs), chunk_sigs=set(eng._chunk_sigs),
                max_gap_ms=longest(lambda hit, dec: True),
                watch_gap_ms=longest(lambda hit, dec: hit),
                watch_token_gap_ms=longest(lambda hit, dec: hit and dec),
                capacity=eng.capacity)


def attention_checks(torch, seen: dict, what: str) -> list:
    """The attention kernel against its plain twin on the inputs a counted
    serve gave it, one call a signature (B, Sq, Skv, q_offset): in f32
    within FLASH_F32_TOL of the twin, in bf16 no further off f64 than
    FLASH_BF16_VS_TWIN times the twin (the twin rounds P to bf16 at its own
    blocking, so the two may round apart by more than phase 2's random
    inputs show). These launches come after the counts are read."""
    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    rows = []
    for (qs, ks, off), (q, k, v, kw) in sorted(seen.items()):
        got, want = tk.flash_attention_fwd(q, k, v, **kw), flash_fwd_ref(q, k, v, **kw)
        dt = str(q.dtype).split(".")[-1]
        row = dict(shape=f"B={qs[0]} Sq={qs[1]} Skv={ks[1]} H={qs[2]} KH={ks[2]} D={qs[3]} "
                         f"q_offset={off} {dt}",
                   max_abs_err=float((got.double() - want.double()).abs().max()))
        if q.dtype == torch.float32:
            ok = torch.allclose(got, want, atol=FLASH_F32_TOL, rtol=FLASH_F32_TOL)
        else:
            exact = exact_attention(torch, q, k, v, **kw)
            row["kernel_vs_f64"], row["twin_vs_f64"] = (
                float((x.double() - exact).abs().max()) for x in (got, want))
            ok = row["kernel_vs_f64"] <= FLASH_BF16_VS_TWIN * row["twin_vs_f64"]
        require(ok, f"{what}: flash_attention_fwd [{row['shape']}] off its plain twin: {row}")
        rows.append(row)
    return rows


def static_margin(torch, model, params, prompt, max_new: int, j: int) -> float:
    """The static B = 1 run's top-2 logit margin at the logits that chose
    its token ``j`` (prefill for j = 0, decode step j - 1 after)."""
    n = prompt.shape[0]
    logits, cache = model.prefill_fn(params, {"tokens": prompt[None]}, pad_to=n + max_new + 1)
    for i in range(j):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = model.decode_fn(params, cache, tok, n + i)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def cont_identity(torch, model, params, prompts, run, static, max_new: int, what: str) -> None:
    """Every completion == its static B = 1 generate (run on the attention
    kernel's plain twin), token for token; on a difference, print where and
    the static run's top-2 margin there first."""
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    bad = [i for i, (c, s) in enumerate(zip(run["done"], static)) if c.tokens != s]
    if bad:
        i = bad[0]
        got, want = run["done"][i].tokens, static[i]
        j = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
        with using(flash_fwd_ref):
            margin = static_margin(torch, model, params, prompts[i], max_new, j)
        print(f"{what}: request {i} (prompt {prompts[i].shape[0]}) first differs at token {j} "
              f"(continuous {got[j]}, static {want[j]}); the static run's top-2 logit margin "
              f"there {margin:.6g}", flush=True)
    require(not bad, f"{what}: {len(bad)} of {len(static)} completions differ from their "
                     f"static B = 1 generate (requests {bad[:8]})")


def first_step_error(torch, model, params, prompts, run, max_new: int) -> float:
    """max |logits| difference between the first continuous step's rows and
    each slot's static B = 1 decode at the same position."""
    err = 0.0
    for slot, rid in run["first_slots"].items():
        p = prompts[rid]
        n = p.shape[0]
        logits, cache = model.prefill_fn(params, {"tokens": p[None]}, pad_to=n + max_new + 1)
        step, _ = model.decode_fn(params, cache, torch.argmax(logits, -1).to(torch.int32), n)
        err = max(err, float((run["first_logits"][slot] - step[0]).abs().max()))
    return err


def cont_row(run: dict, static: dict | None = None) -> dict:
    row = dict(steps=run["steps"], tokens=run["tokens"], wall_s=run["wall"],
               tok_per_s=run["tokens"] / run["wall"], ms_per_step=run["wall"] / run["steps"] * 1e3,
               max_gap_ms=run["max_gap_ms"], watch_gap_ms=run["watch_gap_ms"],
               watch_token_gap_ms=run["watch_token_gap_ms"],
               launches=run["counts"]["flash_attention_fwd"], admissions=run["admissions"],
               **latency_pcts([c.latency for c in run["done"]]))
    if static is not None:
        row["static"] = dict(wall_s=static["wall"], tok_per_s=run["tokens"] / static["wall"],
                             **latency_pcts(static["lat"]))
        row["ratio"] = row["tok_per_s"] / row["static"]["tok_per_s"]
        row["token_agreement"] = sum(
            a == b for c, s in zip(run["done"], static["tokens"]) for a, b in zip(c.tokens, s)
        ) / run["tokens"]
    return row


def phase_continuous(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 15: continuous LM serving (`ContinuousEngine` + `Scheduler`) at
    TinyLlama-1.1B's published width and depth, weights drawn from the seed.

    (a) the reference serving bench's trace (`CONT_TRACE`) in bf16, on the
    seed's draw as the launcher takes it, beside static B = 1 generates:
    tokens/s of both and their ratio, p50/p95 latency, decode steps, ms a
    step; token agreement reported, not gated (cuBLAS at M = 4 and at M = 1
    may round bf16 differently). (b) the same trace in f32 with the
    attention projections at fan-in over their contraction: every
    completion == its static B = 1 generate, and the first step's logits
    within CONT_LOGIT_TOL of the static decode's. (c) chunked admission
    (`CONT_CHUNKED`) in f32: every completion == its static generate (one-shot
    prefill), the chunk signatures exactly CONT_CHUNK_SIGS and only the
    256-token prompts prefilled whole; then in bf16 with and without
    chunking, the longest host-clock gap between decode steps while a
    1024-token prompt admits. The static runs that (b) and (c) are held to
    run the attention kernel's plain twin, so those gates hold the kernel
    against it end to end. Every run through the scheduler is counted: 22
    attention launches a whole-prompt admission or chunk, none in a decode
    step, no other kernel; and the kernel is held against its twin on its
    inputs at every call signature of every counted run, bf16 and f32
    (`attention_checks`)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.models import get_model, init_params

    dev = "cuda"
    cfg = configs.get_config(LM["arch"])
    bf, f32 = (get_model(dataclasses.replace(cfg, dtype=dt))
               for dt in (torch.bfloat16, torch.float32))
    p32 = init_params(f32.specs, torch.Generator(device=dev).manual_seed(SEED), dev)

    def cast(t):
        return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.bfloat16()

    pbf = cast(p32)                         # the seed's draw in bf16 (phase 11's main path)
    fan_in_over_contraction(p32, cfg)       # f32, conditioned as in phase 11's gates
    out = {}

    # (a) the bench's trace in bf16
    a = CONT_TRACE
    prompts = cont_trace(cfg, a)
    static = cont_static(torch, bf, pbf, prompts, a["max_new"])
    run = cont_serve(torch, bf, pbf, prompts, a["slots"], a["max_new"], what="cont (a) bf16")
    add_launches(launches, run["counts"])
    checks = list(run["checks"])
    out["a_bf16"] = row = cont_row(run, static)
    st = row["static"]
    print(f"cont (a) bf16 trace: {a['requests']} requests x {a['max_new']} new, lens "
          f"{sorted(a['lengths'])}, {a['slots']} slots, all queued at t = 0: continuous "
          f"{row['tok_per_s']:.1f} tok/s ({row['steps']} decode steps, {row['ms_per_step']:.3f} "
          f"ms/step, p50 {row['p50_ms']:.1f} ms, p95 {row['p95_ms']:.1f} ms), static B = 1 "
          f"{st['tok_per_s']:.1f} tok/s (p50 {st['p50_ms']:.1f} ms, p95 {st['p95_ms']:.1f} ms), "
          f"ratio {row['ratio']:.3f}; tokens agree with static {row['token_agreement']:.4f} (not "
          f"gated); {row['launches']} attention launches for {row['admissions']} admissions",
          flush=True)

    # (b) the same trace in f32, conditioned: token for token, first-step logits
    with using(flash_fwd_ref):
        static32 = cont_static(torch, f32, p32, prompts, a["max_new"], warm=False)
    run = cont_serve(torch, f32, p32, prompts, a["slots"], a["max_new"], what="cont (b) f32")
    add_launches(launches, run["counts"])
    checks += run["checks"]
    cont_identity(torch, f32, p32, prompts, run, static32["tokens"], a["max_new"], "cont (b) f32")
    with using(flash_fwd_ref):
        err = first_step_error(torch, f32, p32, prompts, run, a["max_new"])
    require(err <= CONT_LOGIT_TOL, f"cont (b) f32: first step's logits off the static decode's "
                                   f"by {err} > {CONT_LOGIT_TOL}")
    out["b_f32"] = row = dict(cont_row(run), first_step_logit_err=err)
    print(f"cont (b) f32 trace: {a['requests']} of {a['requests']} completions == their static "
          f"B = 1 generate token for token; first step's logits vs the static decode max |diff| "
          f"{err:.3g} (bound {CONT_LOGIT_TOL}); continuous {row['tok_per_s']:.1f} tok/s "
          f"({row['ms_per_step']:.3f} ms/step)", flush=True)

    # (c) chunked admission in f32, then the stall in bf16 with and without chunks
    c = CONT_CHUNKED
    prompts = cont_trace(cfg, c)
    with using(flash_fwd_ref):
        static32 = cont_static(torch, f32, p32, prompts, c["max_new"], warm=False)
    run = cont_serve(torch, f32, p32, prompts, c["slots"], c["max_new"], chunk=c["chunk"],
                     what="cont (c) f32 chunked")
    add_launches(launches, run["counts"])
    checks += run["checks"]
    cont_identity(torch, f32, p32, prompts, run, static32["tokens"], c["max_new"],
                  "cont (c) f32 chunked")
    whole = {sig[0][1][1] for sig in run["prefill_sigs"]}
    require(run["chunk_sigs"] == CONT_CHUNK_SIGS,
            f"cont (c): chunk signatures {sorted(run['chunk_sigs'])}, expected "
            f"{sorted(CONT_CHUNK_SIGS)}")
    require(whole == {c["chunk"]}, f"cont (c): whole prefills at lengths {whole}, expected "
                                   f"only {c['chunk']}")
    out["c_f32"] = cont_row(run)
    print(f"cont (c) f32 chunked: {c['requests']} requests (lens {sorted(c['lengths'])}, chunk "
          f"{c['chunk']}, {c['slots']} slots, capacity {run['capacity']}): every completion == "
          f"its static B = 1 generate (one-shot prefill); chunks {sorted(run['chunk_sigs'])}; "
          f"whole prefills only at {sorted(whole)}; {run['counts']['flash_attention_fwd']} "
          f"attention launches for {run['admissions']} admissions and chunks", flush=True)
    del static32, run
    stall = {}
    for label, chunk in (("whole", None), ("chunked", c["chunk"])):
        run = cont_serve(torch, bf, pbf, prompts, c["slots"], c["max_new"], chunk=chunk,
                         watch=max(c["lengths"]), what=f"cont (c) bf16 {label}")
        add_launches(launches, run["counts"])
        checks += run["checks"]
        stall[label] = cont_row(run)
        stall[label]["tokens_list"] = [d.tokens for d in run["done"]]
    agree = sum(x == y for s, t in zip(stall["whole"]["tokens_list"],
                                       stall["chunked"]["tokens_list"]) for x, y in zip(s, t))
    for r in stall.values():
        del r["tokens_list"]
    out["c_bf16"] = dict(stall, token_agreement=agree / stall["whole"]["tokens"])
    require(stall["whole"]["watch_gap_ms"] is not None and stall["chunked"]["watch_gap_ms"]
            is not None, "cont (c) bf16: no decode step ran while a 1024-token prompt admitted")
    w, ch = stall["whole"], stall["chunked"]

    def ms(x):
        return "none (no request decoding)" if x is None else f"{x:.3f} ms"

    print(f"cont (c) bf16 stall, while a {max(c['lengths'])}-token prompt admits: longest gap "
          f"between successive decode steps whole prefill {w['watch_gap_ms']:.3f} ms, chunks of "
          f"{c['chunk']} {ch['watch_gap_ms']:.3f} ms; longest wait between a decoding request's "
          f"tokens whole {ms(w['watch_token_gap_ms'])}, chunked {ms(ch['watch_token_gap_ms'])} "
          f"(longest gap overall {w['max_gap_ms']:.3f} / {ch['max_gap_ms']:.3f} ms; ms/step "
          f"{w['ms_per_step']:.3f} / {ch['ms_per_step']:.3f}; tok/s {w['tok_per_s']:.1f} / "
          f"{ch['tok_per_s']:.1f}; p95 {w['p95_ms']:.1f} / {ch['p95_ms']:.1f} ms); chunked vs "
          f"whole tokens agree {out['c_bf16']['token_agreement']:.4f} (not gated)", flush=True)

    out["attention_checks"] = checks
    f32_rows = [r for r in checks if "kernel_vs_f64" not in r]
    bf_rows = [r for r in checks if "kernel_vs_f64" in r]
    print(f"cont kernel checks: flash_attention_fwd vs its plain twin at every call signature "
          f"of the counted runs, {len(checks)} signatures "
          f"({', '.join(r['shape'] for r in checks)}): f32 within atol = rtol = {FLASH_F32_TOL} "
          f"(max |err| {max(r['max_abs_err'] for r in f32_rows):.3g}); bf16 vs f64 no further "
          f"off than {FLASH_BF16_VS_TWIN}x the twin (worst ratio "
          f"{max(r['kernel_vs_f64'] / r['twin_vs_f64'] for r in bf_rows):.3f}, max |kernel - "
          f"twin| {max(r['max_abs_err'] for r in bf_rows):.3g})", flush=True)
    if profile:
        out.update(cont_profile(torch, bf, pbf, cont_trace(cfg, CONT_TRACE), prompts))
    print(f"cont checks: (b) and (c) every f32 completion == its static B = 1 generate on "
          f"the kernel's plain twin, first step's logits within the bound, the chunk "
          f"signatures exact, flash_attention_fwd the only kernel: {cfg.n_layers} launches a "
          f"whole-prompt admission or chunk, none in a decode step; the kernel within its "
          f"twin's bounds at every call signature", flush=True)
    return out


def cont_profile(torch, model, params, trace, chunked) -> dict:
    """``--profile``: one continuous step at N = 4 (every slot decoding)
    beside one static decode step at B = 4, both bf16 at trace (a)'s longest
    prompt; and a 1024-token prompt of trace (c) prefilled whole beside the
    same prompt's four chunks of 256 (each call from a fresh cache)."""
    from repro_torch.serving import ContinuousEngine, ServeConfig

    a, c = CONT_TRACE, CONT_CHUNKED
    n, new = a["slots"], a["max_new"]
    longest = [p for p in trace if p.shape[0] == max(a["lengths"])][:n]
    eng = ContinuousEngine(model, ServeConfig(max_new=new), num_slots=n,
                           max_prompt_len=max(a["lengths"]))
    holder = dict(state=eng.init_state())
    for slot, p in enumerate(longest):
        holder["state"], _ = eng.prefill_into_slot(params, holder["state"], {"tokens": p[None]},
                                                   slot)

    def cont_step():
        holder["state"], _ = eng.step(params, holder["state"])

    s = longest[0].shape[0]
    logits, cache = model.prefill_fn(params, {"tokens": torch.stack(longest)}, pad_to=s + new + 1)
    st = dict(cache=cache, tok=torch.argmax(logits, -1).to(torch.int32), pos=s)

    def static_step():
        step, st["cache"] = model.decode_fn(params, st["cache"], st["tok"], st["pos"])
        st["tok"] = torch.argmax(step, -1).to(torch.int32)
        st["pos"] += 1

    batch = {"tokens": next(p for p in chunked if p.shape[0] == max(c["lengths"]))[None]}
    ceng = ContinuousEngine(model, ServeConfig(max_new=c["max_new"]), num_slots=1,
                            max_prompt_len=max(c["lengths"]), prefill_chunk=c["chunk"])

    def whole():
        model.prefill_fn(params, batch, pad_to=ceng.capacity)

    def chunks():
        job = ceng.begin_chunked_prefill(params, batch)
        while not job.done:
            job = ceng.advance_chunked_prefill(params, job)

    return {"profile continuous step": profile_calls(
                torch, f"cont step N={n} bf16", [cont_step] * 8),
            "profile static step": profile_calls(
                torch, f"static decode step B={n} bf16", [static_step] * 8),
            "profile whole prefill": profile_calls(
                torch, f"cont whole prefill {max(c['lengths'])} bf16", [whole] * 4),
            "profile chunked prefill": profile_calls(
                torch, f"cont {max(c['lengths'])} in chunks of {c['chunk']} bf16",
                [chunks] * 4)}


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------

def bwd_vs_twin(torch, inputs: tuple, got: tuple, kw: dict) -> dict:
    """The backward kernel's outputs ``got`` on ``inputs`` (q, k, v, out, lse,
    dout) against its plain twin: f32 within FLASH_F32_TOL; bf16 no further
    off f64 than FLASH_BF16_VS_TWIN times the twin, and within
    FLASH_SPLIT_RTOL / FLASH_SPLIT_ATOL of the twin in the kernel's own
    arithmetic (``p_bf16=2``: a wrong tile that the f64 gate might let
    through), for each of dq, dk, dv. Returns the row with its verdict under
    "ok"."""
    from repro_torch.kernels.flash_attention.ref import flash_bwd_exact, flash_bwd_ref

    q, k, v, out, lse, dout = inputs
    want = flash_bwd_ref(q, k, v, out, lse, dout, **kw)
    row = dict(max_abs_err=max(float((a.double() - b.double()).abs().max())
                               for a, b in zip(got, want)))
    if q.dtype == torch.float32:
        row["ok"] = all(torch.allclose(a, b, atol=FLASH_F32_TOL, rtol=FLASH_F32_TOL)
                        for a, b in zip(got, want))
    else:
        exact = flash_bwd_exact(q, k, v, dout, **{n: kw[n] for n in ("causal", "window",
                                                                    "q_offset") if n in kw})
        row["kernel_vs_f64"] = [float((a.double() - e).abs().max()) for a, e in zip(got, exact)]
        row["twin_vs_f64"] = [float((a.double() - e).abs().max()) for a, e in zip(want, exact)]
        split = flash_bwd_ref(q, k, v, out, lse, dout, p_bf16=2, **kw)
        # each output's worst |kernel - split twin| over its allowance
        row["vs_split"] = [float(((a.double() - b.double()).abs() / (
            FLASH_SPLIT_RTOL * b.double().abs()
            + FLASH_SPLIT_ATOL * float(b.double().abs().max()))).max())
            for a, b in zip(got, split)]
        row["ok"] = (all(a <= FLASH_BF16_VS_TWIN * t
                         for a, t in zip(row["kernel_vs_f64"], row["twin_vs_f64"]))
                     and all(r <= 1.0 for r in row["vs_split"]))
    return row


def flash_bwd_cases(torch, gen) -> list:
    """Phase 16 (a): the backward kernel at the training shape first
    (TinyLlama-1.1B, B = 8, S = 1024, causal, bf16), then gemma3-1b's layer
    (windowed and global), deepseek-coder-33b's, D = 16 and 32, non-causal, a
    ragged length, a prefill chunk's q_offset, f32 at two small shapes (one
    windowed over a cache prefix), rows that see no key (q_offset -64), and
    phase 23's head dims: Kimi-K2's layer (D = 112) and Zamba2-2.7B's shared
    block (D = 80), Mixtral-8x22B's layer at S 8192 past its window, a
    D = 112 chunk and f32 at D = 80 and 112, and Whisper-tiny's and
    Qwen2-VL-7B's: the encoder's non-causal 1500 x 1500, the cross-attention
    448 over 1500, Qwen2-VL's causal 1280 at D = 128.
    Each case runs the forward kernel with its log-sum-exp (held to the
    twin's within FLASH_F32_TOL), then the backward kernel and the twin on
    the same (q, k, v, out, lse, dout) (`bwd_vs_twin`; at the training
    shape the kernel twice, held to its own bits); times the kernel
    (CUDA-graph replay and eager), the twin, and the library: the backward
    alone of autograd through F.scaled_dot_product_attention on the same
    tensors (is_causal where that is the mask, else a boolean mask), timed
    eagerly. The bound counts 10 * pairs * D operations (S and dP recomputed,
    dQ, dK, dV) at the peak of the inputs' type and each input and output
    byte once."""
    import torch.nn.functional as F

    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention.ops import bwd_cost
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

    rows = []
    for label, (b, sq, skv, h, kh, d, causal, win, off, dt) in FLASH_BWD_CASES:
        dt = getattr(torch, dt)
        q, dout = (torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
                   for _ in range(2))
        k, v = (torch.randn(b, skv, kh, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=win, q_offset=off)
        out, lse = tk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        _, lse_t = flash_fwd_ref(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        lse_err = float((lse - lse_t).abs().max())
        require(torch.allclose(lse, lse_t, atol=FLASH_F32_TOL, rtol=FLASH_F32_TOL),
                f"flash_attention_fwd [{label}]: lse off the twin's by {lse_err}")
        inputs = (q, k, v, out, lse, dout)
        got = tk.flash_attention_bwd(*inputs, **kw)
        torch.cuda.synchronize()
        row = bwd_vs_twin(torch, inputs, got, kw)
        shape = (f"{label} B={b} Sq={sq} Skv={skv} H={h} KH={kh} D={d} causal={causal} "
                 f"window={win} q_offset={off} {str(dt).split('.')[-1]}")
        require(row.pop("ok"), f"flash_attention_bwd [{shape}] off its plain twin: {row}")
        if label == "train":              # two launches on the same inputs: the same bits
            again = tk.flash_attention_bwd(*inputs, **kw)
            torch.cuda.synchronize()
            row["deterministic"] = all(torch.equal(a, b) for a, b in zip(got, again))
            require(row["deterministic"], f"flash_attention_bwd [{shape}]: two launches on "
                                          f"the same inputs differ")
            del again
        del got

        def kern(inputs=inputs, kw=kw):
            return tk.flash_attention_bwd(*inputs, **kw)

        def plain(inputs=inputs, kw=kw):
            return flash_bwd_ref(*inputs, **kw)

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        if win <= 0 and off == 0 and sq == skv:
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=True)
        else:
            qp = off + torch.arange(sq, device="cuda")[:, None]
            kp = torch.arange(skv, device="cuda")[None, :]
            mask = (kp <= qp) if causal else torch.ones_like(qp - kp, dtype=torch.bool)
            if win > 0:
                mask &= (qp - kp) < win
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        do_t = dout.transpose(1, 2)

        def lib(o_lib=o_lib, qt=qt, kt=kt, vt=vt, do_t=do_t):
            return torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True)

        ms, eager_ms = time_ms(torch, kern), call_ms(torch, kern)
        plain_ms = time_ms(torch, plain, samples=3)
        lib_ms = call_ms(torch, lib, samples=3)
        nbytes, ops, kind = bwd_cost(b, sq, skv, h, kh, d, causal, win, off, dt)
        bound_s, bound_by = kernel_bound(nbytes, ops, kind)
        row.update(shape=shape, lse_err=lse_err, ms=ms, call_ms=eager_ms, plain_ms=plain_ms,
                   bound_ms=bound_s * 1e3, bound_by=bound_by,
                   library_ms=lib_ms, bytes=nbytes, ops=ops, op_kind=kind,
                   library_what="autograd.grad through F.scaled_dot_product_attention "
                                "(backward only, eager)")
        rows.append(row)
        vs = ("" if "kernel_vs_f64" not in row else
              f"; vs f64 dq/dk/dv kernel {'/'.join(f'{x:.3g}' for x in row['kernel_vs_f64'])}"
              f", twin {'/'.join(f'{x:.3g}' for x in row['twin_vs_f64'])}; vs the split "
              f"twin {'/'.join(f'{x:.3g}' for x in row['vs_split'])} of its allowance"
              + ("; two launches bit-identical" if row.get("deterministic") else ""))
        print(f"kernel flash_attention_bwd [{shape}]: within its gate (max |err| vs twin "
              f"{row['max_abs_err']:.3g}{vs}; lse vs twin {lse_err:.3g}), {ms:.4f} ms (eager "
              f"call {eager_ms:.4f}), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}; {nbytes} B, {ops} {kind} ops)",
              flush=True)
        del inputs, out, lse, o_lib, qt, kt, vt
    return rows


@contextlib.contextmanager
def recorded_bwd(keep_rows: int):
    """Within the block, every backward of the attention's autograd function
    runs unchanged and appends its first ``keep_rows`` batch rows: ((q, k, v,
    out, lse, dout), (dq, dk, dv), kwargs), all cloned. The batch rows of
    attention are independent, so these rows of the outputs are the
    kernel's own outputs for those rows' inputs."""
    from repro_torch.kernels.flash_attention import ops

    orig, log = ops.FlashAttention.backward, []

    def backward(ctx, dout):      # the function's own backward, recording (saved
        q, k, v, out, lse = ctx.saved_tensors      # tensors unpack once under remat)
        res = ops.flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        log.append((tuple(x[:keep_rows].clone() for x in (q, k, v, out, lse, dout.to(q.dtype))),
                    tuple(x[:keep_rows].clone() for x in res), dict(ctx.kw)))
        return (*res, None, None, None, None, None)

    ops.FlashAttention.backward = staticmethod(backward)
    try:
        yield log
    finally:
        ops.FlashAttention.backward = staticmethod(orig)


def train_launches(counts: dict, cfg, steps: int, what: str, per_step=None) -> None:
    """A step launches ``per_step`` = (forward, backward) attention kernels,
    by default remat's: the forward twice a layer (the forward and its
    recomputation) and the backward once; and no other kernel of the
    table."""
    fwd, bwd = per_step or (2 * cfg.n_layers, cfg.n_layers)
    require_only(counts, tuple(k for k, n in (("flash_attention_fwd", fwd),
                                              ("flash_attention_bwd", bwd)) if n), what)
    want = (fwd * steps, bwd * steps)
    got = (counts["flash_attention_fwd"], counts["flash_attention_bwd"])
    require(got == want, f"{what}: (forward, backward) launches {got}, expected {want}")


def step_model_flops(cfg, n_params: int, batch: int, seq: int, attn_calls=None) -> float:
    """A training step's model FLOPs with its attention (not the reference's
    6 N D, `analysis.roofline.model_flops`): 6 N T for the parameters' products plus
    attention's 12 * B * H * pairs * D a call (forward 4, backward 8; the
    remat recomputation not counted), ``attn_calls`` calls a step (default
    one a layer)."""
    calls = cfg.n_layers if attn_calls is None else attn_calls
    if not calls:
        return 6 * n_params * batch * seq
    pairs = attention_pairs(seq, seq, True, -1, 0)
    return 6 * n_params * batch * seq + 12 * batch * cfg.n_heads * pairs * cfg.hd * calls


def train_steps(torch, fns, pipe, params, opt_state, steps: int, cfg, what: str,
                launches: dict, record: bool = False, generators=None, per_step=None,
                auxes=None):
    """``steps`` counted train steps from step 0 (the counters reset before
    and read after each, `train_launches` gating each against ``per_step``):
    (params, opt_state, losses, gnorms, host seconds a step, the first
    step's recorded backward calls when ``record``); each step's aux loss
    appended to ``auxes`` when given."""
    from repro_torch import kernels as tk

    losses, gnorms, step_s, seen = [], [], [], []
    for step in range(steps):
        batch = pipe.batch(step)
        gen = generators(step) if generators is not None else None
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        with (recorded_bwd(2) if record and step == 0 else contextlib.nullcontext([])) as log:
            params, opt_state, m = fns.step(params, opt_state, batch, gen)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]) if "gnorm" in m else None)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if auxes is not None:
            auxes.append(float(m["aux"]))
        seen += log
        counts = tk.launch_counts()
        train_launches(counts, cfg, 1, f"{what} step {step}", per_step)
        add_launches(launches, counts)
    return params, opt_state, losses, gnorms, step_s, seen


def phase_train_adamw(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 16 (b): AdamW at TinyLlama-1.1B's published width and depth (bf16
    parameters from the seed, remat on), B x S of `SyntheticLM` (`TRAIN`).

    First, reported: TRAIN["ref_init_steps"] steps at the reference's own
    init, under which nothing learns at this width: the attention
    projections' fan-in over the head axis (`fan_in_over_contraction`)
    grows the residual stream layer by layer, the global gradient norm is
    ~1e15, and the clipped gradients sit far below AdamW's eps. Then, gated,
    the same draw with the attention projections at fan-in over their
    contraction, as phases 11 and 15 gate: every loss finite, the last below
    the first by TRAIN["min_drop"], each step 44 forward and 22 backward
    attention launches and no other kernel; during the first step every
    layer's backward inputs are captured (first two batch rows) and the
    kernel's outputs held to the twin (`bwd_vs_twin`). Reported: ms a step
    (median of steps 3-15, host clock), tokens/s, peak device memory, the
    model-FLOPs share of the bf16 peak."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import count_params, get_model
    from repro_torch.train.loop import build_train_fns
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import tree_leaves

    t = TRAIN
    cfg = configs.get_config(t["arch"])
    model = get_model(cfg)
    fns = build_train_fns(model, OptConfig(lr=t["lr"], warmup=t["warmup"],
                                           total_steps=t["total_steps"]), device="cuda")
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=t["seq"], global_batch=t["batch"]),
                       device="cuda")
    n_params = count_params(model.specs)
    params, opt_state = fns.init(SEED)
    *_, ref_losses, ref_gnorms, _, _ = train_steps(
        torch, fns, pipe, params, opt_state, t["ref_init_steps"], cfg,
        "train adamw, reference init", launches)
    print(f"train adamw, the reference's init (reported): loss " + " ".join(
        f"{x:.4f}" for x in ref_losses) + ", gradient norm " + " ".join(
        f"{g:.3g}" for g in ref_gnorms), flush=True)
    del params, opt_state

    params, opt_state = fns.init(SEED)
    fan_in_over_contraction(params, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what the process holds as the steps start (phase 25 (a) reads it):
    # the parameters and moments, and tensors of earlier phases still resident
    resident = torch.cuda.memory_allocated()
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves((params, opt_state)))
    params, opt_state, losses, gnorms, step_s, seen = train_steps(
        torch, fns, pipe, params, opt_state, t["steps"], cfg, "train adamw", launches,
        record=True)
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses), f"train adamw: a loss is not finite: {losses}")
    require(losses[-1] <= losses[0] - t["min_drop"],
            f"train adamw: loss {losses[0]:.4f} -> {losses[-1]:.4f}, fell by less than "
            f"{t['min_drop']}: {losses}")
    recorded = sum(x.numel() * x.element_size() for inputs, got, _ in seen for x in inputs + got)
    rows = []
    for inputs, got, kw in seen:
        row = bwd_vs_twin(torch, inputs, got, kw)
        require(row.pop("ok"), f"train adamw: a layer's backward kernel off its twin: {row}")
        rows.append(row)
    require(len(rows) == cfg.n_layers, f"train adamw: {len(rows)} backward calls captured")
    prof = None
    if profile:                 # two more steps under torch.profiler, not counted
        state = dict(p=params, s=opt_state)

        def step():
            state["p"], state["s"], _ = fns.step(state["p"], state["s"], pipe.batch(0))

        prof = profile_calls(torch, "train step bf16", [step] * 2, share_of="flash_bwd")
        del state, step
    del seen, params, opt_state
    ms = statistics.median(step_s[2:]) * 1e3
    tokens = t["batch"] * t["seq"]
    flops = step_model_flops(cfg, n_params, t["batch"], t["seq"])
    out = dict(arch=cfg.name, params=n_params, batch=t["batch"], seq=t["seq"], losses=losses,
               gnorms=gnorms, ref_init_losses=ref_losses, ref_init_gnorms=ref_gnorms,
               step_s=step_s, ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
               max_memory_allocated=peak, model_flops=flops, resident_before=resident,
               state_bytes=state_bytes, recorded_bytes=recorded,
               mfu_bf16=flops / (ms / 1e3) / BF16_FLOPS_PER_S, layer_bwd=rows,
               launches_per_step=(2 * cfg.n_layers, cfg.n_layers), profile=prof)
    worst = max((r["kernel_vs_f64"][i] / r["twin_vs_f64"][i] for r in rows for i in range(3)
                 if r["twin_vs_f64"][i] > 0), default=float("nan"))
    print(f"train adamw: {cfg.name} ({n_params} parameters, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, bf16, remat, attention projections at fan-in over their "
          f"contraction), batch {t['batch']} x seq {t['seq']}, {t['steps']} steps: loss "
          + " ".join(f"{x:.4f}" for x in losses) + ", gradient norm "
          + " ".join(f"{g:.3g}" for g in gnorms), flush=True)
    print(f"train adamw: {ms:.2f} ms a step (median of steps 3-{t['steps']}, host clock; "
          f"first {step_s[0] * 1e3:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, peak "
          f"memory {peak / 2**30:.2f} GiB, model FLOPs {flops:.4g} a step = "
          f"{out['mfu_bf16']:.4f} of the bf16 peak (989 TFLOP/s)", flush=True)
    print(f"train adamw checks: losses finite, fell {losses[0] - losses[-1]:.4f} >= "
          f"{t['min_drop']}; {2 * cfg.n_layers} forward and {cfg.n_layers} backward attention "
          f"launches every step, no other kernel; every layer's backward kernel within its "
          f"twin's bound on the step's own inputs (worst kernel/twin error vs f64 "
          f"{worst:.4f})", flush=True)
    return out


def phase_train_sign(torch, launches: dict) -> dict:
    """Phase 16 (c): sign_majority with the OTA BER at TinyLlama-1.1B's width
    (`SIGN`), on (b)'s conditioned draw: every loss finite, the launches as
    (b)'s, and in the first step the share of flipped votes among the
    gradient's nonzero elements within 5 sigma of the BER. The loss
    trajectory is reported, not gated: lr * sign at the first warm-up steps
    is below half a bf16 ulp of most weights."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import collectives
    from repro_torch.models import get_model
    from repro_torch.train.loop import build_train_fns, step_generator
    from repro_torch.train.optimizer import OptConfig

    t, s = TRAIN, SIGN
    cfg = configs.get_config(t["arch"])
    fns = build_train_fns(get_model(cfg), OptConfig(
        kind="sign_majority", lr=s["lr"], warmup=s["warmup"], total_steps=s["total_steps"]),
        ota_ber=s["ber"], device="cuda")
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=t["seq"], global_batch=t["batch"]),
                       device="cuda")
    params, opt_state = fns.init(SEED)
    fan_in_over_contraction(params, cfg)
    votes = dict(n=0, flipped=0, step=None)
    orig = collectives.sign_allreduce

    def counting(x, *args, **kw):
        out = orig(x, *args, **kw)
        if votes["step"] == 0:
            live = x != 0
            votes["n"] += int(live.sum())
            votes["flipped"] += int(((out != torch.sign(x)) & live).sum())
        return out

    def generators(step):          # the first step's votes are counted
        votes["step"] = step
        return step_generator(SEED, step, "cuda")

    collectives.sign_allreduce = counting
    try:
        params, opt_state, losses, _, step_s, _ = train_steps(
            torch, fns, pipe, params, opt_state, s["steps"], cfg, "train sign_majority",
            launches, generators=generators)
    finally:
        collectives.sign_allreduce = orig
    del params, opt_state
    rate = votes["flipped"] / max(votes["n"], 1)
    sigma = math.sqrt(s["ber"] * (1 - s["ber"]) / max(votes["n"], 1))
    require(all(math.isfinite(x) for x in losses),
            f"train sign_majority: a loss is not finite: {losses}")
    require(votes["n"] > 0 and abs(rate - s["ber"]) <= 5 * sigma,
            f"train sign_majority: flip rate {rate} over {votes['n']} votes, not within 5 "
            f"sigma ({sigma}) of {s['ber']}")
    ms = statistics.median(step_s[2:]) * 1e3
    print(f"train sign_majority (OTA BER {s['ber']}): loss " + " ".join(
        f"{x:.4f}" for x in losses) + f" (reported, not gated); {ms:.2f} ms a step; "
        f"flip rate {rate:.6f} over {votes['n']} nonzero votes of the first step, within 5 "
        f"sigma ({5 * sigma:.2e}) of {s['ber']}; launches as (b)", flush=True)
    return dict(losses=losses, step_s=step_s, ms_per_step=ms, flip_rate=rate,
                votes=votes["n"], sigma=sigma)


def resume_child(ckpt_root: str) -> int:
    """Phase 16 (d), in a child process started with CUBLAS_WORKSPACE_CONFIG
    set and deterministic algorithms on: TinyLlama-1.1B's width at RESUME's
    depth, bf16, one uninterrupted Trainer run against one that fails at
    RESUME["fail_at"] and resumes from its checkpoint. Prints one JSON line."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch import kernels as tk
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.train.loop import Trainer, TrainerConfig, build_train_fns
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import tree_leaves

    torch.use_deterministic_algorithms(True)
    t, r = TRAIN, RESUME
    cfg = dataclasses.replace(configs.get_config(t["arch"]), n_layers=r["layers"])
    fns = build_train_fns(get_model(cfg), OptConfig(lr=t["lr"], warmup=t["warmup"],
                                                    total_steps=t["total_steps"]), device="cuda")
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=t["seq"], global_batch=t["batch"]),
                       device="cuda")

    def trainer(name):
        return Trainer(fns, pipe, TrainerConfig(steps=r["steps"], ckpt_every=r["ckpt_every"],
                                                ckpt_dir=os.path.join(ckpt_root, name),
                                                keep=1))

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    pa, sa, la = trainer("a").run(SEED, quiet=True)
    shutil.rmtree(os.path.join(ckpt_root, "a"))
    crashed = trainer("b")
    try:
        crashed.run(SEED, fail_at=r["fail_at"], quiet=True)
        failed = False
    except RuntimeError:
        failed = True
    pb, sb, lb = crashed.run(SEED, quiet=True)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    leaves = list(zip(tree_leaves((pa, sa)), tree_leaves((pb, sb))))
    print(json.dumps(dict(
        failed=failed, equal=all(torch.equal(x, y) for x, y in leaves), leaves=len(leaves),
        losses_a=la, losses_b=lb, launches=counts, seconds=time.perf_counter() - t0,
        steps_run=len(la) + r["fail_at"] + len(lb), disk_free=shutil.disk_usage(ckpt_root).free)))
    return 0


def phase_train_resume(torch, launches: dict) -> dict:
    """Phase 16 (d): `resume_child` in a child process (deterministic
    algorithms need CUBLAS_WORKSPACE_CONFIG before CUDA starts, and this
    process started CUDA in phase 1), checkpoints under a temporary
    directory that the phase deletes. Gates: the injected failure raised,
    the resumed run's parameters and optimizer state equal the uninterrupted
    run's bit for bit, the last loss equal, the launches as (b)'s."""
    import dataclasses
    import tempfile

    from repro_torch import configs

    r = RESUME
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--resume-child", root], env=env, capture_output=True,
                              text=True, timeout=900)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(proc.returncode == 0, f"train resume: the child exited {proc.returncode}:\n"
                                  f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(configs.get_config(TRAIN["arch"]), n_layers=r["layers"])
    train_launches(res["launches"], cfg, res["steps_run"], "train resume")
    add_launches(launches, res["launches"])
    require(res["failed"], "train resume: the injected failure did not raise")
    require(res["equal"], "train resume: the resumed run's parameters or optimizer state "
                          "differ from the uninterrupted run's")
    require(res["losses_a"][-1] == res["losses_b"][-1],
            f"train resume: last loss {res['losses_b'][-1]} != {res['losses_a'][-1]}")
    print(f"train resume ({cfg.name} width, {r['layers']} layers, bf16, deterministic "
          f"algorithms): failure injected at step {r['fail_at']}, resumed from step "
          f"{r['ckpt_every']}: {res['leaves']} parameter and optimizer leaves equal bit for "
          f"bit, last loss {res['losses_b'][-1]:.6f} == {res['losses_a'][-1]:.6f}; child "
          f"{res['seconds']:.1f} s, {res['disk_free'] / 2**30:.1f} GiB free", flush=True)
    return res


def phase_train(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 16: training. (a) the backward kernel against its twin
    (`flash_bwd_cases`; its rows go to the kernels line), (b) AdamW (with
    ``profile``, two more steps under torch.profiler: device busy, idle
    share, top ops, the backward kernel's share), (c) sign_majority and (d)
    crash and resume."""
    out = dict(kernel_cases=flash_bwd_cases(torch, torch.Generator(device="cuda").manual_seed(1)))
    out["adamw"] = phase_train_adamw(torch, launches, profile=profile)
    out["sign_majority"] = phase_train_sign(torch, launches)
    out["resume"] = phase_train_resume(torch, launches)
    return out


# ---------------------------------------------------------------------------
# phase 17: the scale-out serve across ranks (gloo, every rank on cuda:0)
# ---------------------------------------------------------------------------

def mr_cases(grid: tuple) -> list:
    """Phase 17's serves on one (data, model) grid: each a dict of name,
    kind (ota, wired or train), codebook and configuration."""
    cases = [dict(name=f"{ch} {'permuted' if perm else 'baseline'} {rep} {coll}", kind="ota",
                  book="paper", cfg=dict(channel=ch, permuted=perm, representation=rep,
                                         collective=coll))
             for ch in ("ideal", "bsc") for perm, rep in MR_MODES for coll in MR_COLLECTIVES]
    # the noise replayed by core index (untimed): the same bits on ranks as on one rank
    cases += [dict(name=f"bsc_replay {'permuted' if perm else 'baseline'} {rep} {coll}",
                   kind="ota", book="paper", timed=0,
                   cfg=dict(channel="bsc_replay", permuted=perm, representation=rep,
                            collective=coll))
              for perm, rep in MR_MODES for coll in MR_COLLECTIVES]
    cases += [dict(name=f"{ch} {'permuted' if perm else 'baseline'} {rep} psum", kind="ota",
                   book="paper", timed=0 if ch == "symbol_replay" else MR_TIMED,
                   cfg=dict(channel=ch, permuted=perm, representation=rep))
              for ch in ("symbol", "symbol_replay") for perm, rep in MR_MODES]
    if grid == (1, 4):
        flat = dict(COARSE, channel="ideal", representation="packed")
        cases += [dict(name=f"flat packed C={COARSE['n_classes']} {coll}", kind="ota",
                       book="coarse", cfg=dict(flat, collective=coll))
                  for coll in MR_COLLECTIVES]
        cases += [dict(name=f"coarse packed C={COARSE['n_classes']} psum_packed", kind="ota",
                       book="coarse", cfg=dict(flat, collective="psum_packed",
                                               coarse_group=COARSE_GS,
                                               coarse_keep=COARSE_KEEP))]
        cases += [dict(name=f"wired {rep}", kind="wired", book="paper",
                       cfg=dict(channel="ideal", representation=rep))
                  for rep in ("unpacked", "packed")]
        cases += [dict(name=f"sparse d={NARROW_DIM} {coll}", kind="ota", book="narrow",
                       cfg=dict(channel="ideal", representation="sparse", dim=NARROW_DIM,
                                k_max=NARROW_K, collective=coll))
                  for coll in ("index_ag", "psum_packed")]
    if grid == (2, 4):
        cases += [dict(name=f"cell {coll} {rep}", kind="ota", book="cell",
                       cfg=dict(MR_CELL, channel="ideal", representation=rep, collective=coll))
                  for coll, rep in MR_CELL_BYTES]
        cases += [dict(name=f"train {rep}", kind="train", book="paper",
                       cfg=dict(representation=rep)) for rep in ("unpacked", "packed")]
    return cases


MR_KERNELS = {  # (kind, representation, coarse) -> the kernels a rank's call launches
    ("ota", "unpacked", False): ("assoc_matmul",),
    ("ota", "packed", False): ("hamming_topk_banked",),
    ("ota", "packed", True): ("hamming_topk_k_banked",),
    ("ota", "sparse", False): ("sparse_topk_banked",),
    ("wired", "unpacked", False): ("majority_bundle", "assoc_matmul"),
    ("wired", "packed", False): ("hamming_search",),
    ("train", "unpacked", False): (), ("train", "packed", False): (),
}


def mr_books(torch, names) -> dict:
    """The codebooks of phase 17, made on the card from seeds (the same in
    every process): (unpacked bits or index lists, the serve's prototypes
    packed or not is decided per case)."""
    from repro_torch.core import classifier, hypervector as hv

    books = {}
    if "paper" in names:
        books["paper"] = classifier.make_codebook(
            cuda_gen(torch, 0), classifier.HDCTaskConfig(n_classes=6400, dim=512),
            device="cuda")
    if "coarse" in names:
        books["coarse"] = hv.random_hv(cuda_gen(torch, SEED), COARSE["n_classes"],
                                       COARSE["dim"], "cuda")
    if "narrow" in names:
        books["narrow"] = sparse_codebook(torch, cuda_gen(torch, SEED), 6400, NARROW_DIM,
                                          NARROW_K, NARROW_DENSITY)
    if "cell" in names:
        books["cell"] = hv.random_hv(cuda_gen(torch, 5), MR_CELL["n_classes"], MR_CELL["dim"],
                                     "cuda")
    return books


def mr_hot_ber(torch, n: int):
    lo, hi = MR_HOT_BER
    return lo + (hi - lo) * torch.arange(n, device="cuda", dtype=torch.float32) / (n - 1)


def mr_replay_tiers(torch, mesh) -> None:
    """Register the tiers ``bsc_replay`` and ``symbol_replay``: the BSC's
    flip masks (at `mr_hot_ber`) and the symbol tier's draws made before
    the serve from MR_REPLAY_SEED for every core and trial of the paper's
    configuration, each core taking those of its global index ``rx_base +
    i`` and each rank its rows of the batch (``mesh=None``: all of them),
    as the tests' replayed tiers do."""
    from repro_torch import phy
    from repro_torch.core import hypervector as hv, scaleout

    cfg = scaleout.ScaleOutConfig()
    g = torch.Generator().manual_seed(MR_REPLAY_SEED)       # the host's: the same everywhere
    full = (cfg.n_rx_cores, cfg.batch, cfg.dim)
    masks = (torch.rand(full, generator=g) < mr_hot_ber(torch, cfg.n_rx_cores).cpu()[:, None, None])
    nr, ni = torch.randn(full, generator=g), torch.randn(full, generator=g)
    flips = torch.rand(full, generator=g) < 0.01
    mine = lambda x: scaleout.shard_batch(mesh, x, 1).cuda()              # noqa: E731
    masks, nr, ni, flips = (mine(x) for x in (masks.to(torch.uint8), nr, ni, flips))

    class BSCReplay(phy.Channel):
        name, wire = "bsc_replay", "votes"

        def rx_copies(self, generator, reduced, state, rx_base, n_cores, *, packed, dim,
                      noise, planes=16, n_all=None):
            m = masks[rx_base:rx_base + n_cores]
            return reduced[None] ^ (hv.pack(m) if packed else m)

    class SymbolReplay(phy.SymbolChannel):
        name = "symbol_replay"

        def draws(self, generator, state, rx_base, n_cores, shape, n_all=None):
            rows = slice(rx_base, rx_base + n_cores)
            return nr[rows], ni[rows], flips[rows]

    phy.register_channel(BSCReplay(), override=True)
    phy.register_channel(SymbolReplay(), override=True)


def mr_plain_topk(q, protos, *, k=None, bank_rows=None):
    """`hamming_topk_banked`'s plain twin, for the coarse oracle."""
    from repro_torch.kernels.hamming import ref

    if k is None:
        return ref.hamming_topk_banked_ref(q, protos, protos.shape[1], bank_rows)
    return ref.hamming_topk_k_banked_ref(q, protos, k, protos.shape[1], bank_rows)


def mr_oracle(torch, cfg, case: dict, a, b, serve_one):
    """The plain answer of an ideal case on the whole inputs (``a, b``: the
    prototypes and queries, or the examples and labels): the one-shot
    training as a one-hot product in f64, the coarse screen as the one-rank
    serve with its kernel swapped for the plain twin, every other serve
    `serve_reference` (plain PyTorch, no kernel)."""
    from unittest import mock

    from repro_torch.core import hypervector as hv, scaleout

    if case["kind"] == "train":
        ex, labels = a, b
        ex_u = hv.unpack(ex, cfg.dim) if cfg.packed else ex
        onehot = torch.nn.functional.one_hot(labels, cfg.n_classes).to(torch.float64)
        sums = onehot.T @ (2.0 * ex_u.to(torch.float64) - 1.0)             # [C, d]
        protos = (sums > 0).to(torch.uint8)
        return (hv.pack(protos) if cfg.packed else protos).cpu().numpy()
    if cfg.coarse_group:
        with mock.patch.object(scaleout, "hamming_topk_banked", mr_plain_topk):
            out = serve_one()
    else:
        out = scaleout.serve_reference(cfg, a, b)
    return out[0].cpu().numpy(), out[1].cpu().numpy()


def mr_serve(torch, case: dict, mesh, books: dict, state) -> dict:
    """One case of phase 17 on this rank's shard (``mesh=None``: the
    one-rank serve of the whole inputs, with the plain oracle of an ideal
    case): its rows' answers, the launches and wire bytes of one counted
    call, and ``case["timed"]`` (default MR_TIMED) more calls' ms (host
    clock, each ending in a synchronize). The bsc tiers serve at the BER
    ramp `mr_hot_ber`, the symbol tiers through the paper's state."""
    from repro_torch import kernels as tk, phy
    from repro_torch.core import hypervector as hv, scaleout
    from repro_torch.distributed import collectives

    cfg = scaleout.ScaleOutConfig(**case["cfg"])
    s = 1 if mesh is None else mesh.axis_size("model")
    dpos, _ = scaleout._dpos(mesh)
    tx = 0 if mesh is None else mesh.index("model")
    if case["book"] != "paper":
        state = phy.state_from_ber(torch.zeros(cfg.n_rx_cores, device="cuda"), cfg.m_tx)
    elif cfg.channel.startswith("bsc"):
        state = phy.state_from_ber(mr_hot_ber(torch, cfg.n_rx_cores), cfg.m_tx)
    if case["kind"] == "train":
        book = books["paper"]
        g = cuda_gen(torch, 4)
        labels = torch.randint(0, cfg.n_classes, (cfg.batch,), generator=g, device="cuda")
        ex = book[labels] ^ (torch.rand(book[labels].shape, generator=g, device="cuda")
                             < 0.1).to(torch.uint8)
        ex = hv.pack(ex) if cfg.packed else ex
        fn = scaleout.make_hdc_train(cfg, device="cuda", mesh=mesh)
        args = (scaleout.shard_batch(mesh, ex), scaleout.shard_batch(mesh, labels))
        call = lambda: fn(*args)                                         # noqa: E731
        whole = (ex, labels)
    else:
        if case["book"] == "narrow":
            codes, protos = books["narrow"]
            classes, q = scaleout.make_queries(cuda_gen(torch, 1), cfg, codes, model_size=s)
        else:
            book = books[case["book"]]
            classes, q = scaleout.make_queries(cuda_gen(torch, 1), cfg, book, model_size=s)
            protos = (torch.cat([hv.pack(book[i:i + 8192]) for i in range(0, len(book), 8192)])
                      if cfg.packed else book)
        whole = (protos, q)
        protos, q, st = scaleout.shard_inputs(cfg, mesh, protos, q, state)
        build = scaleout.make_wired_serve if case["kind"] == "wired" else scaleout.make_ota_serve
        fn = build(cfg, device="cuda", mesh=mesh)
        # the data row's noise: every model rank draws over the global cores
        # on this generator and keeps its own (one rank: seed 1000)
        seed = 1000 + 100 * dpos
        call = lambda: fn(protos, q, st, cuda_gen(torch, seed))          # noqa: E731
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    collectives.reset_wire_bytes()
    out = call()
    torch.cuda.synchronize()
    res = dict(launches=tk.launch_counts(), bytes=collectives.wire_bytes(),
               coords=(dpos, tx))
    if case["kind"] == "train":
        res["protos"] = out.cpu().numpy()
    else:
        res.update(pred=out[0].cpu().numpy(), sim=out[1].cpu().numpy(),
                   classes=classes.cpu().numpy())
    if mesh is None and (case["kind"] == "train" or cfg.channel == "ideal"):
        res["oracle"] = mr_oracle(torch, cfg, case, *whole, call)
    ms = []
    for _ in range(case.get("timed", MR_TIMED)):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res["ms"] = ms
    return res


def mr_rank(mesh, state_np: dict, cases: list) -> dict:
    """What each rank of a phase-17 grid runs on cuda:0: every case on its
    shard. Returns {name: that case's rank results}."""
    import torch
    import torch.distributed as dist

    from repro_torch import phy

    from repro_torch.distributed import collectives

    state = phy.ChannelState(**{f: torch.from_numpy(v).cuda() for f, v in state_np.items()})
    books = mr_books(torch, {c["book"] for c in cases})
    mr_replay_tiers(torch, mesh)
    g, s = mesh.group("model"), mesh.axis_size("model")
    out = {"backend": dist.get_backend(g)}
    # slot-blind fields of a 4-rank axis are 4 bits, 8 to a lane: every vote
    # +1 sums the top field to 8, bit 31, so the int32 sum must wrap as uint32
    votes = torch.ones((4, 64), dtype=torch.int8, device="cuda")
    fbits, k = collectives.vote_field_spec(s)
    lanes = collectives.all_reduce(collectives._pack_vote_fields(votes, 1, fbits, k), g)
    out["bit31"] = (bool((lanes < 0).all()) if fbits * k == 32 else None,
                    bool((collectives.packed_vote_allreduce(votes, g) == s).all()))
    for case in cases:
        out[case["name"]] = mr_serve(torch, case, mesh, books, state)
    return out


def mr_assemble(np, results: list, name: str, key: str):
    """One case's global answer from its ranks: every model rank of a data
    row must answer alike, the data rows in order; training: every data
    rank alike, the model ranks' classes in order."""
    by = {r[name]["coords"]: r[name][key] for r in results}
    n_data, n_model = 1 + max(d for d, _ in by), 1 + max(t for _, t in by)
    if key == "protos":
        require(all(np.array_equal(by[(d, t)], by[(0, t)])
                    for d in range(n_data) for t in range(n_model)),
                f"mr {name}: data ranks learned different prototypes")
        return np.concatenate([by[(0, t)] for t in range(n_model)])
    require(all(np.array_equal(by[(d, t)], by[(d, 0)])
                for d in range(n_data) for t in range(n_model)),
            f"mr {name}: model ranks answer differently")
    return np.concatenate([by[(d, 0)] for d in range(n_data)])


def mr_hit(np, pred, classes, permuted: bool) -> tuple:
    """(hit rate, trials): the share of trials answered from the sent set
    (baseline) or of draws answered (permuted)."""
    if permuted:
        return float((pred == classes).mean()), pred.size
    return float((pred[:, None] == classes).any(1).mean()), len(pred)


def phase_multirank(torch, state, launches: dict) -> dict:
    """Phase 17: each grid's ranks (gloo, all on cuda:0) serve every case;
    the one-rank serves of the same inputs in this process, and on ideal
    their plain oracles, are what they are held to."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as tmesh

    state_np = {f: getattr(state, f).cpu().numpy() for f in state.FIELDS}
    grids = {g: mr_cases(g) for g in MR_GRIDS}
    every = {c["name"]: c for cases in grids.values() for c in cases}
    books = mr_books(torch, {c["book"] for c in every.values()})
    mr_replay_tiers(torch, None)
    one = {name: mr_serve(torch, c, None, books, state) for name, c in every.items()}
    for name, r in one.items():
        if "oracle" in r:
            got = (r["protos"],) if every[name]["kind"] == "train" else (r["pred"], r["sim"])
            want = (r["oracle"],) if every[name]["kind"] == "train" else r["oracle"]
            require(all(np.array_equal(a, b) for a, b in zip(got, want)),
                    f"mr one rank {name}: differs from its plain oracle")
    del books
    torch.cuda.empty_cache()
    out = {"one_rank_ms": {n: statistics.median(r["ms"]) for n, r in one.items() if r["ms"]},
           "grids": {}}
    _build.build()             # the ranks load the library built here
    for grid, cases in grids.items():
        t0 = time.perf_counter()
        results = tmesh.spawn(mr_rank, grid, (state_np, cases), timeout=MR_TIMEOUT,
                              threads=None)
        wall = time.perf_counter() - t0
        label = f"{grid[0]}x{grid[1]}"
        backend = results[0]["backend"]
        for r in results:
            require(r["bit31"][1] and r["bit31"][0] in (True, None),
                    f"mr {label}: the packed lanes' sum {r['bit31']} is not the uint32 sum")
        rows, hits = {}, {}
        for c in cases:
            name = c["name"]
            rep = c["cfg"].get("representation", "unpacked")
            want = MR_KERNELS[(c["kind"], rep, bool(c["cfg"].get("coarse_group")))]
            for r in results:
                counts = r[name]["launches"]
                require(all(counts[k] > 0 for k in want)
                        and all(v == 0 for k, v in counts.items() if k not in want),
                        f"mr {label} {name}: launches {counts}, expected {want}")
                add_launches(launches, counts)
                require(c["kind"] == "train" or r[name]["bytes"] > 0,
                        f"mr {label} {name}: no bytes on the wire")
            if c["kind"] == "train":
                got = mr_assemble(np, results, name, "protos")
                require(np.array_equal(got, one[name]["protos"])
                        and np.array_equal(got, one[name]["oracle"]),
                        f"mr {label} {name}: prototypes differ from the one-rank training "
                        "or the plain one-hot sums")
                continue
            pred = mr_assemble(np, results, name, "pred")
            sim = mr_assemble(np, results, name, "sim")
            rows[name] = (pred, sim)
            ch = c["cfg"].get("channel", "bsc")
            if ch in ("ideal", "bsc_replay", "symbol_replay"):
                require(np.array_equal(pred, one[name]["pred"])
                        and np.array_equal(sim, one[name]["sim"]),
                        f"mr {label} {name}: differs from the one-rank serve")
            if ch == "ideal":
                require(all(np.array_equal(a, b) for a, b in zip((pred, sim),
                                                                  one[name]["oracle"])),
                        f"mr {label} {name}: differs from its plain oracle")
            if ch in ("bsc", "symbol") and grid[0] == 1:
                # one data row: the same generator as the one-rank serve, and
                # each core's noise a function of (generator, core) alone
                require(np.array_equal(pred, one[name]["pred"])
                        and np.array_equal(sim, one[name]["sim"]),
                        f"mr {label} {name}: real noise differs from the one-rank serve")
                h, _ = mr_hit(np, pred, one[name]["classes"], c["cfg"]["permuted"])
                hits[name] = (h, h, 0.0)
                require(ch == "symbol" or h <= 0.95,
                        f"mr {label} {name}: hit {h} at the BER ramp {MR_HOT_BER}; "
                        "the noise does nothing")
            elif ch in ("bsc", "symbol"):
                perm = c["cfg"]["permuted"]
                h, n = mr_hit(np, pred, one[name]["classes"], perm)
                h1, _ = mr_hit(np, one[name]["pred"], one[name]["classes"], perm)
                pbar = (h + h1) / 2
                sigma = math.sqrt(2 * pbar * (1 - pbar) / n)
                hits[name] = (h, h1, sigma)
                require(abs(h - h1) <= 3 * sigma,
                        f"mr {label} {name}: hit {h} vs one rank {h1}, beyond 3 sigma {sigma}")
                require(ch == "symbol" or h1 <= 0.95,
                        f"mr {label} {name}: one-rank hit {h1} at the BER ramp "
                        f"{MR_HOT_BER}; the 3-sigma gate sees nothing")
            if c["book"] == "cell":
                got = [r[name]["bytes"] for r in results]
                want_b = MR_CELL_BYTES[(c["cfg"]["collective"], c["cfg"]["representation"])]
                require(got == [want_b] * len(results),
                        f"mr {label} {name}: wire bytes {got}, expected {want_b} on every rank")
        # on bsc every collective answers alike on the same per-rank
        # generators, and on the symbol tier packed answers as unpacked
        for perm, rep in MR_MODES:
            tag = f"{'permuted' if perm else 'baseline'} {rep}"
            first = rows[f"bsc {tag} psum"]
            for coll in MR_COLLECTIVES[1:]:
                other = rows[f"bsc {tag} {coll}"]
                require(all(np.array_equal(a, b) for a, b in zip(first, other)),
                        f"mr {label} bsc {tag}: {coll} differs from psum")
            if rep == "packed":
                u = rows[f"symbol {'permuted' if perm else 'baseline'} unpacked psum"]
                require(all(np.array_equal(a, b)
                            for a, b in zip(u, rows[f"symbol {tag} psum"])),
                        f"mr {label} symbol {tag}: packed differs from unpacked")
        ms = {c["name"]: statistics.median(results[0][c["name"]]["ms"]) for c in cases
              if results[0][c["name"]]["ms"]}
        for ch in ("ideal", "bsc"):
            for perm, rep in MR_MODES:
                tag = f"{ch} {'permuted' if perm else 'baseline'} {rep}"
                print(f"mr {label} {tag}: " + ", ".join(
                    f"{coll} {ms[f'{tag} {coll}']:.3f}" for coll in MR_COLLECTIVES)
                    + f" ms a call (one rank {out['one_rank_ms'][f'{tag} psum']:.3f})"
                    + ("" if ch == "ideal" else ", hit {:.4f} vs one rank {:.4f}".format(
                        *hits[f"{tag} psum"][:2])), flush=True)
        extra = [c["name"] for c in cases if c["name"] in ms
                 and not c["name"].startswith(("ideal", "bsc")) and c["kind"] != "train"]
        print(f"mr {label} " + "; ".join(
            f"{n} {ms[n]:.3f} ms (one rank {out['one_rank_ms'][n]:.3f})" for n in extra),
            flush=True)
        bytes0 = {c["name"]: results[0][c["name"]]["bytes"] for c in cases}
        out["grids"][label] = dict(backend=backend, wall_s=wall, ms=ms, hits=hits,
                                   bytes=bytes0, bit31=results[0]["bit31"][0])
        real = ("real bsc and symbol == one rank bit for bit" if grid[0] == 1 else
                "real bsc and symbol hit within 3 sigma of one rank (each data row its "
                "own generator)")
        print(f"mr {label}: {len(results)} ranks over {backend} on cuda:0, "
              f"{len(cases)} cases, ideal == one rank == the plain oracle, replayed bsc "
              f"and symbol == one rank, bsc collectives equal, {real}, "
              f"lanes with bit 31 set sum as uint32: "
              f"{results[0]['bit31'][0]}, {wall:.1f} s with the ranks' start", flush=True)
    cell = out["grids"]["2x4"]["bytes"]
    print("mr wire bytes per rank, 2x4 cell (C = 4096, d = 1024, M = 3, 8 cores, B = 128): "
          + ", ".join(f"{coll} {rep} {cell[f'cell {coll} {rep}']:,}"
                      for coll, rep in MR_CELL_BYTES), flush=True)
    print("mr checks: every grid's ideal serves == the one-rank serve == the plain oracle "
          "(serve_reference; the coarse screen on the plain top-k; the training as one-hot "
          f"sums) in pred and maxsim, the flat packed serve at C = {COARSE['n_classes']} on "
          "1x4 too; the bsc masks and symbol draws replayed by core index == the one-rank "
          f"serve; at the bsc BER ramp {MR_HOT_BER} psum == psum_packed == rs_ag on the same "
          "generators; real bsc and symbol noise on 1x2 and 1x4 == the one-rank serve bit "
          "for bit (mesh-layout invariant draws), on 2x4 the hit rate within 3 sigma of "
          "one rank's; the byte totals of EXPERIMENTS.md:16-19 on every rank", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: living channels, faults and the HDC engines across ranks (gloo,
# every rank on cuda:0)
# ---------------------------------------------------------------------------

def lr_leaves(p) -> dict:
    """A process or fault state's leaves on the host (the channel's under
    chan/)."""
    out = {}
    for f in p.FIELDS:
        x = getattr(p, f)
        if hasattr(x, "FIELDS"):
            out.update({f"chan/{g}": getattr(x, g).cpu().numpy() for g in x.FIELDS})
        else:
            out[f] = x.cpu().numpy()
    return out


def lr_fstate(torch, cfg, scenario: str, model_size: int):
    """The global fault state of a scenario on a model axis of ``model_size``
    ranks: "healthy"; "dead": LR_DEAD dead, failed over in shards of
    LR_SHARD cores, and 1% stuck cells (phase 14 (b)'s density and cells);
    "erased": the votes of TXs 1 and 2 dropped."""
    from repro_torch import faults

    f = faults.healthy_for(cfg, model_size=model_size)
    if scenario == "dead":
        s0, s1 = faults.sample_stuck_cells(cuda_gen(torch, 7), cfg.n_rx_cores, cfg.words,
                                           FAULTS_PAPER["stuck_density"])
        f = faults.plan_failover(faults.inject(f, dead_rx=list(LR_DEAD), stuck0=s0, stuck1=s1),
                                 LR_SHARD)
    elif scenario == "erased":
        f = faults.inject(f, vote_drop=[1, 2])
    return f


def lr_replay_drift(torch, mesh) -> None:
    """Register ``symbol_replay16``: the symbol tier on normals and flips
    drawn before the serve (MR_REPLAY_SEED + 1) for every core and trial of
    phase 13 (c)'s drift point (16 RX, batch 4), each core taking those of
    its global index and each rank its rows of the batch."""
    from repro_torch import phy
    from repro_torch.core import scaleout

    d = MT_DRIFT
    g = torch.Generator().manual_seed(MR_REPLAY_SEED + 1)
    full = (d["n_rx"], d["batch"], 512)
    nr, ni = torch.randn(full, generator=g), torch.randn(full, generator=g)
    flips = torch.rand(full, generator=g) < 0.01
    nr, ni, flips = (scaleout.shard_batch(mesh, x, 1).cuda() for x in (nr, ni, flips))

    class SymbolReplay16(phy.SymbolChannel):
        name = "symbol_replay16"

        def draws(self, generator, state, rx_base, n_cores, shape, n_all=None):
            rows = slice(rx_base, rx_base + n_cores)
            return nr[rows], ni[rows], flips[rows]

    phy.register_channel(SymbolReplay16(), override=True)


def lr_living(torch, mesh, state, books) -> dict:
    """(a) A PhaseDriftProcess serve on symbol_replay (unpacked) and on
    bsc_replay (packed), psum, LR_STEPS steps on process generators seeded
    alike: each step's answers and the evolved state's leaves (this rank's
    rows), one counted run."""
    import numpy as np

    from repro_torch import phy
    from repro_torch.core import hypervector as hv, scaleout

    s = 1 if mesh is None else mesh.axis_size("model")
    out = {}
    for ch, rep in (("symbol_replay", "unpacked"), ("bsc_replay", "packed")):
        cfg = scaleout.ScaleOutConfig(channel=ch, representation=rep)
        proc = phy.PhaseDriftProcess(guard_dims=64)
        book = books["paper"]
        _, q = scaleout.make_queries(cuda_gen(torch, 1), cfg, book, model_size=s)
        protos, q, pst = scaleout.shard_inputs(cfg, mesh, hv.pack(book) if cfg.packed else book,
                                               q, proc.init(state))
        fn = scaleout.make_ota_serve(cfg, process=proc, mesh=mesh)
        gens, g = phy.process_generators(11, "cuda"), cuda_gen(torch, 2)

        def run(pst=pst):
            steps = []
            for _ in range(LR_STEPS):
                pred, sim, pst = fn(protos, q, pst, g, gens)
                steps.append((pred, sim, pst))
            return steps

        steps, _, counts = counted(torch, run)
        out[f"{ch} {rep}"] = dict(
            launches=counts, pred=np.stack([p.cpu().numpy() for p, _, _ in steps]),
            sim=np.stack([x.cpu().numpy() for _, x, _ in steps]),
            pstate=[lr_leaves(p) for _, _, p in steps])
    return out


def lr_fault_cases(coarse: bool) -> list:
    """(b)'s serves: (name, cfg overrides, scenario); the coarse one on 1x4
    and one rank."""
    cases = [(f"{'permuted' if perm else 'baseline'} {rep} {sc} {coll}",
              dict(permuted=perm, representation=rep, collective=coll), sc)
             for perm, rep in MR_MODES
             for sc, coll in (("healthy", "psum"), ("dead", "psum_packed"), ("erased", "rs_ag"))]
    if coarse:
        cases.append((f"coarse packed dead psum (groups of {FAULTS_PAPER['coarse_group']}, "
                      f"{FAULTS_PAPER['coarse_keep']} kept)",
                      dict(representation="packed", coarse_group=FAULTS_PAPER["coarse_group"],
                           coarse_keep=FAULTS_PAPER["coarse_keep"]), "dead"))
    return cases


def lr_faults(torch, mesh, state, books, coarse: bool) -> dict:
    """(b) Every fault serve on bsc_replay on this rank (one counted call
    each; the healthy ones also beside the fault-free serve on the same
    ranks) and a WearoutFaults rollout of LR_STEPS steps on a fault
    generator seeded alike: its leaves after every step."""
    from repro_torch import faults
    from repro_torch.core import hypervector as hv, scaleout

    sh_s = 1 if mesh is None else mesh.axis_size("model")
    out = {}
    for name, kw, sc in lr_fault_cases(coarse):
        cfg = scaleout.ScaleOutConfig(channel="bsc_replay", **kw)
        book = books["paper"]
        _, q = scaleout.make_queries(cuda_gen(torch, 1), cfg, book, model_size=sh_s)
        protos, q, st, fs = scaleout.shard_inputs(
            cfg, mesh, hv.pack(book) if cfg.packed else book, q, state,
            fstate=lr_fstate(torch, cfg, sc, sh_s))
        fserve = scaleout.make_ota_serve(cfg, faults=faults.StaticFaults(), mesh=mesh)
        (pred, sim, _), _, counts = counted(torch, lambda: fserve(protos, q, st, cuda_gen(torch, 2),
                                                                  fs, None))
        res = dict(pred=pred.cpu().numpy(), sim=sim.cpu().numpy(), launches=counts)
        if sc == "healthy":
            p2, s2 = scaleout.make_ota_serve(cfg, mesh=mesh)(protos, q, st, cuda_gen(torch, 2))
            res["healthy_equal"] = bool(torch.equal(pred, p2) and torch.equal(sim, s2))
        out[name] = res
    cfg = scaleout.ScaleOutConfig()
    sh = scaleout._shard_of(cfg, mesh)
    f = scaleout.shard_state_of(cfg, mesh, faults.healthy_for(cfg, model_size=sh.model_size))
    model, g, wear = faults.WearoutFaults(**WEAROUT), cuda_gen(torch, 13), []
    for _ in range(LR_STEPS):
        f = model.step(g, f, rx_base=sh.tx * sh.cores, n_rx=cfg.n_rx_cores)
        wear.append(lr_leaves(f))
    out["wearout"] = wear
    return out


def lr_sched(torch, eng, banks, reqs) -> dict:
    """Onboard ``banks``, run one warm full ring, then every request queued
    at once on generators seeded alike, the launch counters set to 0 just
    before and read just after: the completions (pred, maxsim, status) in
    request order, the host-clock wall, steps and counts, the trace."""
    from repro_torch import kernels as tk
    from repro_torch.serving import HDCScheduler

    for t, b in enumerate(banks):
        eng.registry.onboard(t, b)
    warm = HDCScheduler(eng)
    for _ in range(eng.num_slots):
        warm.submit(reqs[0][0], reqs[0][1], generator=cuda_gen(torch, 0))
    warm.run(timeout=600)
    sched = HDCScheduler(eng, clock=time.perf_counter)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [sched.submit(t, q, generator=cuda_gen(torch, seed)) for t, q, seed in reqs]
    sched.run(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = [sched.results[r] for r in rids]
    ctl = getattr(eng, "controller", None)
    return dict(done=[(c.pred, c.maxsim, c.status) for c in done], wall=wall,
                steps=sched.steps, launches=tk.launch_counts(),
                trace=None if ctl is None else ctl.trace)


def lr_standalone_equal(torch, cfg, mesh, state, banks, reqs, done, fstate=None) -> bool:
    """Every completion == its standalone serve on this rank (its rows of
    the batch on `rank_generator` of the request's generator; fault-aware
    under the static global ``fstate`` when given)."""
    import numpy as np

    from repro_torch import faults
    from repro_torch.core import scaleout
    from repro_torch.serving.hdc import rank_generator

    if fstate is None:
        fn = scaleout.make_ota_serve(cfg, mesh=mesh)
    else:
        f_rows = scaleout.shard_state_of(cfg, mesh, fstate)
        fserve = scaleout.make_ota_serve(cfg, faults=faults.StaticFaults(), mesh=mesh)
        fn = lambda *a: fserve(*a, f_rows, None)[:2]                       # noqa: E731
    for (t, q, seed), (pred, sim, status) in zip(reqs, done):
        protos, q_l, st = scaleout.shard_inputs(cfg, mesh, banks[t], q, state)
        p, s = fn(protos, q_l, st, rank_generator(cuda_gen(torch, seed), mesh))
        if status != "ok" or not (np.array_equal(p.cpu().numpy(), pred)
                                  and np.array_equal(s.cpu().numpy(), sim)):
            return False
    return True


def lr_engines(torch, mesh, state, state16) -> dict:
    """(c) The three engines on this rank: HDCEngine on phase 13 (b)'s trace
    and FaultTolerantHDCEngine under phase 14 (c)'s faults (LR_DEAD failed
    over, 1% stuck; StaticProcess, StaticFaults), each against its
    rank-standalone serves; AdaptiveHDCEngine at phase 13 (c)'s drift point
    on replayed noise; and a FaultTolerantHDCEngine on a fading channel
    (LR_FADE, WearoutFaults) on bsc_replay whose controller re-fits,
    quarantines, drops the fleet mode and remaps."""
    import dataclasses

    from repro_torch import faults, phy
    from repro_torch.core import classifier, hypervector as hv, scaleout
    from repro_torch.serving import (AdaptiveHDCEngine, FaultControllerConfig,
                                     FaultTolerantHDCEngine, HDCEngine, LinkControllerConfig)

    s = 1 if mesh is None else mesh.axis_size("model")
    b = MT_BATCH
    base = scaleout.ScaleOutConfig()
    cfg = dataclasses.replace(base, batch=b["batch"], representation="packed")
    books = classifier.make_tenant_codebooks(
        [cuda_gen(torch, t) for t in range(b["tenants"])],
        classifier.HDCTaskConfig(n_classes=base.n_classes, dim=base.dim))
    banks = [hv.pack(bk) for bk in books]
    reqs = [(t, scaleout.make_queries(cuda_gen(torch, 100 + i), cfg, books[t], model_size=s)[1],
             1000 + i) for i, t in enumerate(poisson_race(b["requests"], b["tenants"]))]
    out = {}
    kw = dict(num_slots=b["slots"], max_tenants=b["tenants"], mesh=mesh)
    out["engine"] = run = lr_sched(torch, HDCEngine(cfg, state, **kw), banks, reqs)
    run["standalone_equal"] = lr_standalone_equal(torch, cfg, mesh, state, banks, reqs,
                                                  run["done"])
    fstate = lr_fstate(torch, cfg, "dead", s)
    ft = FaultTolerantHDCEngine(cfg, state, process=phy.StaticProcess(),
                                fault_model=faults.StaticFaults(), fstate=fstate, **kw)
    out["ft static"] = run = lr_sched(torch, ft, banks, reqs)
    run["standalone_equal"] = lr_standalone_equal(torch, cfg, mesh, state, banks, reqs,
                                                  run["done"], fstate)
    d = MT_DRIFT
    cfg16 = scaleout.ScaleOutConfig(n_classes=d["n_classes"], n_rx_cores=d["n_rx"],
                                    batch=d["batch"], channel="symbol_replay16")
    books16 = classifier.make_tenant_codebooks(
        [cuda_gen(torch, t) for t in range(d["tenants"])],
        classifier.HDCTaskConfig(n_classes=d["n_classes"], dim=cfg16.dim))
    reqs16 = [(i % d["tenants"], scaleout.make_queries(cuda_gen(torch, 100 + i), cfg16,
                                                       books16[i % d["tenants"]],
                                                       model_size=s)[1], 1000 + i)
              for i in range(d["requests"])]
    eng = AdaptiveHDCEngine(
        cfg16, state16, process=phy.PhaseDriftProcess(sigma=d["sigma"], alpha=d["alpha"],
                                                      guard_dims=d["guard"]),
        num_slots=d["slots"], max_tenants=d["tenants"], mesh=mesh,
        controller=LinkControllerConfig(patience=1, band_kwargs={"cap": d["cap"]}))
    out["adaptive"] = lr_sched(torch, eng, books16, reqs16)
    fade = dataclasses.replace(cfg, channel="bsc_replay")
    ctl = FaultControllerConfig(patience=1, band_kwargs={"cap": 0.02}, quarantine_ber=0.05,
                                quarantine_after=1, release_ber=0.01, release_after=2,
                                drop_frac=0.25, m_floor=1, alt_collective="psum_packed",
                                remap_after=2)
    eng = FaultTolerantHDCEngine(
        fade, state, process=phy.BlockFadingProcess(sigma_db=LR_FADE["sigma_db"], block=1),
        fault_model=faults.WearoutFaults(**WEAROUT), fault_generator=cuda_gen(torch, 4),
        controller=ctl, num_slots=LR_FADE["slots"], max_tenants=b["tenants"], mesh=mesh)
    out["ft fading"] = run = lr_sched(torch, eng, banks, reqs[:LR_FADE["requests"]])
    run["pstate"], run["fstate"] = lr_leaves(eng.pstate), lr_leaves(eng.fstate)
    return out


def lr_run(torch, mesh, states: dict, parts: tuple) -> dict:
    """Phase 18's parts on this rank (``mesh=None``: one rank, the whole
    inputs), on phase 3's state (and phase 13 (c)'s 16-RX state)."""
    from repro_torch import phy

    state, state16 = (phy.ChannelState(**{f: torch.from_numpy(v).cuda() for f, v in st.items()})
                      for st in (states["paper"], states["drift"]))
    books = mr_books(torch, {"paper"})
    mr_replay_tiers(torch, mesh)
    lr_replay_drift(torch, mesh)
    out = {}
    if "a" in parts:
        out["a"] = lr_living(torch, mesh, state, books)
    if "b" in parts:
        out["b"] = lr_faults(torch, mesh, state, books,
                             coarse=mesh is None or mesh.shape == (1, 4))
    if "c" in parts:
        out["c"] = lr_engines(torch, mesh, state, state16)
    return out


def lr_rank(mesh, states: dict, parts: tuple) -> dict:
    """What each rank of a phase-18 grid runs on cuda:0."""
    import torch

    from repro_torch.core import scaleout

    out = lr_run(torch, mesh, states, parts)
    out["coords"] = (scaleout._dpos(mesh)[0], mesh.index("model"))
    return out


def lr_data_rows(results, get, axis: int, what: str):
    """The global answer of the ranks' rows of the batch (``axis``): every
    model rank of a data row alike, the data rows in order."""
    import numpy as np

    by = {r["coords"]: get(r) for r in results}
    n_data, n_model = 1 + max(d for d, _ in by), 1 + max(t for _, t in by)
    require(all(np.array_equal(by[(d, t)], by[(d, 0)])
                for d in range(n_data) for t in range(n_model)),
            f"{what}: model ranks answer differently")
    return np.concatenate([by[(d, 0)] for d in range(n_data)], axis=axis)


def lr_state_equal(results, get, want: dict, what: str) -> None:
    """Every leaf of a process or fault state on the ranks == the one-rank
    state's: a row-leading leaf as every data replica's rows of its model
    column in order (the replicas alike), ``t``, the TX leaves (over the M
    encoders) and the channel's phase assignment and noise density whole
    on every rank."""
    import numpy as np

    by = {r["coords"]: get(r) for r in results}
    n_data, n_model = 1 + max(d for d, _ in by), 1 + max(t for _, t in by)
    for leaf, w in want.items():
        if leaf in ("t", "dead_tx", "vote_drop", "chan/phase_idx", "chan/n0"):
            got = [x[leaf][:len(w)] if leaf in ("dead_tx", "vote_drop") else x[leaf]
                   for x in by.values()]
            require(all(np.array_equal(g, w) for g in got), f"{what}: {leaf} differs")
            continue
        require(all(np.array_equal(by[(d, t)][leaf], by[(0, t)][leaf])
                    for d in range(n_data) for t in range(n_model)),
                f"{what}: the data replicas' {leaf} rows differ")
        got = np.concatenate([by[(0, t)][leaf] for t in range(n_model)])
        require(np.array_equal(got, w), f"{what}: the ranks' {leaf} rows differ from one rank's")


def lr_gate_launches(counts: dict, want: tuple, what: str, steps: int | None = None) -> None:
    require(all(counts[k] == steps if steps is not None else counts[k] > 0 for k in want)
            and all(v == 0 for k, v in counts.items() if k not in want),
            f"{what}: launches {counts}, expected {want}"
            + ("" if steps is None else f" {steps} times (one a step)") + " and nothing else")


def phase_living_ranks(torch, state, launches: dict) -> dict:
    """Phase 18: each grid's ranks (gloo, all on cuda:0) run their parts of
    LR_GRIDS; the one-rank runs of the same inputs in this process are what
    they are held to."""
    import numpy as np

    from repro_torch.core import scaleout
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as tmesh

    d = MT_DRIFT
    state16 = scaleout.precharacterize_state(scaleout.ScaleOutConfig(
        n_classes=d["n_classes"], n_rx_cores=d["n_rx"], batch=d["batch"], channel="symbol"))
    states = {k: {f: getattr(st, f).cpu().numpy() for f in st.FIELDS}
              for k, st in (("paper", state), ("drift", state16))}
    one = lr_run(torch, None, states, ("a", "b", "c"))
    kern = lambda rep: (("hamming_topk_banked",) if rep == "packed"           # noqa: E731
                        else ("assoc_matmul",))
    for name, res in one["c"].items():
        require(res["standalone_equal"] if "standalone_equal" in res else True,
                f"lr one rank (c) {name}: a completion differs from its standalone serve")
    acts = {e["action"] for e in one["c"]["ft fading"]["trace"]}
    require({"refit", "quarantine", "m_drop", "link_mode", "remap"} <= acts,
            f"lr one rank (c) ft fading: the controller took only {sorted(acts)}; "
            "the trace gate would see nothing")
    out = {"one_rank": {k: dict(ms_per_step=r["wall"] / r["steps"] * 1e3,
                                trials_per_s=len(r["done"]) * MT_BATCH["batch"] / r["wall"])
                        for k, r in one["c"].items() if k in ("engine", "ft static")},
           "grids": {}}
    _build.build()             # the ranks load the library built here
    for grid, parts in LR_GRIDS.items():
        label = f"{grid[0]}x{grid[1]}"
        t0 = time.perf_counter()
        results = tmesh.spawn(lr_rank, grid, (states, parts), timeout=LR_TIMEOUT, threads=None)
        wall = time.perf_counter() - t0
        row = dict(wall_s=wall)
        if "a" in parts:
            for name, want in one["a"].items():
                what = f"lr {label} (a) {name}"
                for r in results:
                    lr_gate_launches(r["a"][name]["launches"], kern(name.split()[1]), what)
                    add_launches(launches, r["a"][name]["launches"])
                for key in ("pred", "sim"):
                    got = lr_data_rows(results, lambda r: r["a"][name][key], 1, what)
                    require(np.array_equal(got, want[key]), f"{what}: {key} differs from one rank")
                for k in range(LR_STEPS):
                    lr_state_equal(results, lambda r: r["a"][name]["pstate"][k],
                                   want["pstate"][k], f"{what} step {k + 1}")
            print(f"lr {label} (a) living channel: PhaseDriftProcess on "
                  + " and ".join(one["a"]) + f", psum, {LR_STEPS} steps: every rank's "
                  "process-state rows == the one-rank rollout's"
                  + (" on both data replicas" if grid[0] > 1 else "")
                  + ", pred and maxsim == the one-rank serve's", flush=True)
        if "b" in parts:
            names = [n for n, _, _ in lr_fault_cases(grid == (1, 4))]
            for name in names:
                what = f"lr {label} (b) {name}"
                want = one["b"][name]
                rep = "packed" if " packed " in f" {name} " else "unpacked"
                k = ("hamming_topk_k_banked",) if name.startswith("coarse") else kern(rep)
                for r in results:
                    lr_gate_launches(r["b"][name]["launches"], k, what)
                    add_launches(launches, r["b"][name]["launches"])
                    require(r["b"][name].get("healthy_equal", True),
                            f"{what}: healthy fault-aware differs from fault-free on a rank")
                for key in ("pred", "sim"):
                    got = lr_data_rows(results, lambda r: r["b"][name][key], 0, what)
                    require(np.array_equal(got, want[key]), f"{what}: {key} differs from one rank")
            for k in range(LR_STEPS):
                lr_state_equal(results, lambda r: r["b"]["wearout"][k], one["b"]["wearout"][k],
                               f"lr {label} (b) wearout step {k + 1}")
            dead = int(one["b"]["wearout"][-1]["dead_rx"].sum())
            print(f"lr {label} (b) faults on bsc_replay, four modes: healthy fault-aware == "
                  f"fault-free on ranks (psum); {len(LR_DEAD)} of 64 cores dead (two on each "
                  f"model rank of 1x4), failed over in shards of {LR_SHARD}, + "
                  f"{100 * FAULTS_PAPER['stuck_density']:g}% stuck cells (psum_packed); the "
                  "votes of TXs 1 and 2 erased (rs_ag)"
                  + ("; coarse packed with the dead cores" if grid == (1, 4) else "")
                  + f": every serve == the one-rank fault serve; WearoutFaults {LR_STEPS} "
                  f"steps ({dead} cores dead): rows == the one-rank rollout's", flush=True)
        if "c" in parts:
            c = {}
            for name, want in one["c"].items():
                what = f"lr {label} (c) {name}"
                runs = [r["c"][name] for r in results]
                for run in runs:
                    require(run["steps"] == want["steps"],
                            f"{what}: {run['steps']} steps, one rank {want['steps']}")
                    require(run.get("standalone_equal", True),
                            f"{what}: a completion differs from its rank-standalone serve")
                    require(run["trace"] == want["trace"],
                            f"{what}: the controller trace differs from the one-rank engine's")
                    require(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                                and a[2] == b[2] for a, b in zip(run["done"], runs[0]["done"])),
                            f"{what}: the ranks' completion lists differ")
                    rep = "unpacked" if name == "adaptive" else "packed"
                    lr_gate_launches(run["launches"], kern(rep), what, run["steps"])
                    add_launches(launches, run["launches"])
                if name == "adaptive" or (grid[0] == 1 and name in ("engine", "ft static")):
                    # replayed noise, or real noise on the request's own generator
                    # (one data row): the one-rank engine's answers
                    require(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                                and a[2] == b[2] for a, b in zip(runs[0]["done"], want["done"])),
                            f"{what}: completions differ from the one-rank engine's")
                if name == "ft fading":
                    lr_state_equal(results, lambda r: r["c"][name]["pstate"], want["pstate"],
                                   f"{what} process state")
                r0 = runs[0]
                c[name] = dict(ms_per_step=r0["wall"] / r0["steps"] * 1e3, steps=r0["steps"],
                               trials_per_s=len(r0["done"]) * MT_BATCH["batch"] / r0["wall"],
                               actions=sorted({e["action"] for e in (r0["trace"] or [])}))
            row["c"] = c
            o = out["one_rank"]
            for name in ("engine", "ft static"):
                print(f"lr {label} (c) {'HDCEngine' if name == 'engine' else 'FaultTolerantHDCEngine'}"
                      f" ({MT_BATCH['requests']} requests x {MT_BATCH['batch']} trials, "
                      f"{MT_BATCH['tenants']} tenants, {MT_BATCH['slots']} slots, packed bsc"
                      + (f", {len(LR_DEAD)} dead cores failed over + 1% stuck" if name != "engine"
                         else "") + f"): rank 0 {c[name]['ms_per_step']:.3f} ms a step, "
                      f"{c[name]['trials_per_s']:.1f} trials/s (one rank "
                      f"{o[name]['ms_per_step']:.3f} ms, {o[name]['trials_per_s']:.1f} trials/s; "
                      "gloo through host memory); every completion == its rank-standalone "
                      "serve and == the one-rank engine's, the four ranks' completions "
                      "identical", flush=True)
            print(f"lr {label} (c) AdaptiveHDCEngine (phase 13 (c)'s drift point, replayed "
                  f"symbol noise): controller trace == the one-rank engine's "
                  f"({len(one['c']['adaptive']['trace'])} actions), completions == its; "
                  f"FaultTolerantHDCEngine on a fading channel (BlockFadingProcess "
                  f"{LR_FADE['sigma_db']} dB, WearoutFaults, bsc_replay): trace == one rank's "
                  f"({', '.join(c['ft fading']['actions'])}), process-state rows == its",
                  flush=True)
        out["grids"][label] = row
        print(f"lr {label}: {len(results)} ranks over gloo on cuda:0, parts {', '.join(parts)}, "
              f"{wall:.1f} s with the ranks' start", flush=True)
    print("lr checks: every rank's process and fault rows == the one-rank rollout's (data "
          "replicas alike), the process and fault serves == the one-rank serves on replayed "
          "noise, healthy fault-aware == fault-free on ranks, the engines' completions == "
          "their rank-standalone serves and alike on every rank, on 1x4 == the one-rank "
          "engines' (HDCEngine and the static fault-tolerant engine on real bsc noise), the "
          "controller traces == the one-rank engines'", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: sharded training across ranks (gloo, every rank on cuda:0)
# ---------------------------------------------------------------------------

def tr_config(layers):
    """TinyLlama-1.1B's published config, its depth cut to ``layers`` when
    given."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(TR["arch"])
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def tr_params(torch, model, cfg):
    """Phase 16's conditioned draw: the parameters from SEED, the attention
    projections at fan-in over their contraction."""
    from repro_torch.models import init_params

    return fan_in_over_contraction(init_params(model.specs, cuda_gen(torch, SEED), "cuda"), cfg)


def tr_one_rank(torch, layers) -> dict:
    """One rank's TR["steps"] AdamW steps from the conditioned parameters on
    the same batches: the losses and gradient norms every grid is held to
    (not counted: launches of comparison runs)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.train.loop import build_train_fns
    from repro_torch.train.optimizer import OptConfig

    cfg = tr_config(layers)
    model = get_model(cfg)
    fns = build_train_fns(model, OptConfig(**TR["adamw"]), device="cuda")
    params, state = fns.shard_params(tr_params(torch, model, cfg))
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=TR["seq"], global_batch=TR["batch"]),
                       device="cuda")
    losses, gnorms = [], []
    for step in range(TR["steps"]):
        params, state, m = fns.step(params, state, pipe.batch(step))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    del params, state
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms)


def tr_train(torch, mesh, kind: str, layers) -> dict:
    """TR["steps"] steps of ``kind`` on this rank's shards: the losses (the
    global step's, alike on every rank), host seconds a step (each ending in
    a synchronize), each step's launches and wire bytes (counters set to 0
    just before and read just after), the peak device memory, and the
    bytes of the parameters and optimizer state held beside those of the
    resolved shards."""
    from repro_torch import kernels as tk
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import collectives, sharding
    from repro_torch.models import get_model
    from repro_torch.train.loop import build_train_fns, step_generator
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import tree_leaves

    o = dict(TR[kind])
    ber = o.pop("ber", None)
    cfg = tr_config(layers)
    model = get_model(cfg)
    fns = build_train_fns(model, OptConfig(**o), mesh=mesh, ota_ber=ber, device="cuda")
    params, state = fns.shard_params(tr_params(torch, model, cfg))
    torch.cuda.empty_cache()
    held = sum(x.numel() * x.element_size() for x in tree_leaves((params, state)))
    resolved = sharding.local_bytes(fns.placements, (params, state), fns.mesh)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=TR["seq"], global_batch=TR["batch"]),
                       device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_s, counts, wire = [], [], [], [], []
    for step in range(TR["steps"]):
        batch = pipe.batch(step)
        gen = step_generator(SEED, step, "cuda", fns.data_index) if ber is not None else None
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        collectives.reset_wire_bytes()
        t0 = time.perf_counter()
        params, state, m = fns.step(params, state, batch, gen)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]) if "gnorm" in m else None)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        counts.append(tk.launch_counts())
        wire.append(collectives.wire_bytes())
    peak = torch.cuda.max_memory_allocated()
    del params, state
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms, step_s=step_s, counts=counts, wire=wire,
                peak=peak, held=held, resolved=resolved, layers=cfg.n_layers)


def tr_rank(mesh, runs: tuple) -> dict:
    """What each rank of a phase-19 grid runs on cuda:0: its runs in
    order."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"coords": (mesh.index("data"), mesh.index("model"))}
    for kind, layers in runs:
        out[(kind, layers)] = tr_train(torch, mesh, kind, layers)
    return out


def phase_train_ranks(torch, launches: dict) -> dict:
    """Phase 19: each grid's ranks (gloo, all on cuda:0) train TR_RUNS. One
    rank's AdamW steps on the same parameters and batches (this process)
    are what the grids' AdamW losses, every step, and step-1 gradient norm
    are held to; signum's step-1 loss (before any update) too."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as tmesh

    layers_set = sorted({lay for runs in TR_RUNS.values() for _, lay in runs},
                        key=lambda x: -1 if x is None else x)
    ref = {lay: tr_one_rank(torch, lay) for lay in layers_set}
    torch.cuda.empty_cache()
    _build.build()             # the ranks load the library built here
    out = {"one_rank": {str(k): v for k, v in ref.items()}, "grids": {}}
    for grid, runs in TR_RUNS.items():
        label = f"{grid[0]}x{grid[1]}"
        t0 = time.perf_counter()
        results = tmesh.spawn(tr_rank, grid, (runs,), timeout=TR_TIMEOUT, threads=None)
        wall = time.perf_counter() - t0
        row = {"wall_s": wall}
        for kind, layers in runs:
            what = f"tr {label} {TR[kind]['kind']}" + ("" if layers is None else
                                                      f" ({layers} layers)")
            rs = [r[(kind, layers)] for r in results]
            cfg = tr_config(layers)
            losses, want = rs[0]["losses"], ref[layers]
            require(all(r["losses"] == losses for r in rs),
                    f"{what}: the ranks report different losses")
            require(all(math.isfinite(x) for x in losses), f"{what}: a loss is not finite")
            held_to = len(losses) if kind == "adamw" else 1
            rel = [abs(a - b) / abs(b) for a, b in zip(losses[:held_to], want["losses"])]
            gn_rel = (abs(rs[0]["gnorms"][0] - want["gnorms"][0]) / want["gnorms"][0]
                      if kind == "adamw" else None)
            print(f"{what}: loss against one rank's, relative, step by step: "
                  + " ".join(f"{x:.3g}" for x in rel) + ("" if gn_rel is None else
                                                          f"; step-1 gradient norm "
                                                          f"{rs[0]['gnorms'][0]:.6g} vs "
                                                          f"{want['gnorms'][0]:.6g}, relative "
                                                          f"{gn_rel:.3g}"), flush=True)
            require(max(rel) <= TR["loss_rtol"],
                    f"{what}: losses {losses[:held_to]} vs one rank {want['losses'][:held_to]} "
                    f"(relative {max(rel):.3g} > {TR['loss_rtol']})")
            if gn_rel is not None:
                require(gn_rel <= TR["gnorm_rtol"], f"{what}: step-1 gradient norm relative "
                        f"{gn_rel:.3g} > {TR['gnorm_rtol']}")
            require(losses[-1] < losses[0], f"{what}: the loss did not fall: {losses}")
            for r in rs:
                require(r["held"] == r["resolved"],
                        f"{what}: a rank holds {r['held']} B of parameters and optimizer "
                        f"state, its resolved shards {r['resolved']} B")
                for step, counts in enumerate(r["counts"]):
                    train_launches(counts, cfg, 1, f"{what} step {step}")
                    add_launches(launches, counts)
            ms = statistics.median(rs[0]["step_s"][1:]) * 1e3
            tokens = TR["batch"] * TR["seq"]
            res = dict(losses=losses, gnorms=rs[0]["gnorms"], one_rank=want, loss_rel=rel,
                       gnorm_rel=gn_rel, ms_per_step=ms, step_s=rs[0]["step_s"],
                       tokens_per_s=tokens / ms * 1e3,
                       peak=[r["peak"] for r in rs], held=[r["held"] for r in rs],
                       wire=[statistics.median(r["wire"]) for r in rs],
                       launches_per_step=(2 * cfg.n_layers, cfg.n_layers))
            row[TR[kind]["kind"] + ("" if layers is None else f"-{layers}L")] = res
            print(f"{what}: {cfg.name} ({cfg.n_layers} layers, bf16, remat), batch "
                  f"{TR['batch']} x seq {TR['seq']}, {TR['steps']} steps: loss "
                  + " ".join(f"{x:.4f}" for x in losses)
                  + "; one rank " + " ".join(f"{x:.4f}" for x in want["losses"][:held_to])
                  + f" (relative <= {TR['loss_rtol']})", flush=True)
            print(f"{what}: rank 0 {ms:.1f} ms a step (median of steps 2-{TR['steps']}, host "
                  f"clock; first {rs[0]['step_s'][0] * 1e3:.1f} ms), {res['tokens_per_s']:.0f} "
                  f"tokens/s; peak memory a rank " + ", ".join(
                      f"{p / 2**30:.2f}" for p in res["peak"]) + " GiB; parameters + "
                  f"optimizer a rank " + ", ".join(f"{h:,}" for h in res["held"])
                  + " B (== the resolved shards); wire bytes a step a rank " + ", ".join(
                      f"{int(w):,}" for w in res["wire"]) + f"; {2 * cfg.n_layers} forward and "
                  f"{cfg.n_layers} backward attention launches every step on every rank",
                  flush=True)
        out["grids"][label] = row
        print(f"tr {label}: {len(results)} ranks over gloo on cuda:0, {wall:.1f} s with the "
              "ranks' start", flush=True)
    print("tr checks: on every grid and run the ranks report one loss, finite, the last "
          f"below the first; every AdamW step's loss within {TR['loss_rtol']} of one rank's "
          f"on the same parameters and batches and its step-1 gradient norm within "
          f"{TR['gnorm_rtol']}, signum's step-1 loss within {TR['loss_rtol']}; every rank "
          "holds exactly its resolved shards' bytes; every step on every rank launches the "
          "attention forward (2 a layer, remat) and backward (1 a layer) kernels and no "
          "other kernel of the table", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: the MoE decoder (Mixtral-8x22B and Kimi-K2 at published width)
# ---------------------------------------------------------------------------

def moe_cfg(arch: str, layers: int, dtype=None, **moe_changes):
    """The published config cut to its first ``layers`` layers (the window
    pattern with them), in ``dtype`` and with ``moe_changes`` if given."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch)
    kw = dict(n_layers=layers)
    if cfg.window_pattern is not None:
        kw["window_pattern"] = cfg.window_pattern[:layers]
    if moe_changes:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe_changes)
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(cfg, **kw)


@contextlib.contextmanager
def moe_taps():
    """Within the block, the MoE module's ``route`` results (a list, one a
    layer a call) and the first ``apply`` call's input (``first["x"]``) are
    kept; both run unchanged."""
    from unittest import mock

    from repro_torch.models import moe

    routes, first = [], {}
    route, apply = moe.route, moe.apply

    def tap_route(*args, **kwargs):
        routes.append(route(*args, **kwargs))
        return routes[-1]

    def tap_apply(p, cfg, x, *args, **kwargs):
        first.setdefault("x", x)
        return apply(p, cfg, x, *args, **kwargs)

    with mock.patch.object(moe, "route", tap_route), mock.patch.object(moe, "apply", tap_apply):
        yield routes, first


def moe_routing_stats(torch, routes) -> dict:
    """Over a prefill's routings (one a layer): how many (group, expert)
    cells keep other than min(load, C) of their assignments (the gate: 0),
    and the (token, k) assignments dropped at capacity."""
    off = kept = total = 0
    for r in routes:
        oh = torch.zeros(r.idx.shape + (r.probs.shape[-1],), device=r.idx.device)
        oh.scatter_(-1, r.idx[..., None], 1.0)                       # [G, Tg, K, E]
        load = oh.sum(dim=(1, 2))                                     # [G, E]
        held = (oh * r.keep[..., None]).sum(dim=(1, 2))
        off += int((held != load.clamp_max(r.capacity)).sum())
        kept += int(r.keep.sum())
        total += r.keep.numel()
    return dict(cells_off=off, dropped=total - kept, assignments=total,
                drop_share=(total - kept) / total, capacity=routes[0].capacity,
                groups=routes[0].idx.shape[0], group_tokens=routes[0].idx.shape[1])


def moe_layer_vs_f64(torch, p: dict, cfg, x) -> dict:
    """One MoE layer, `moe.apply` in bf16 on its input x, against its f64
    evaluation expert by expert (a whole f64 layer of Mixtral-8x22B is 19 GB
    and does not fit beside the model). The f64 routing is written here
    apart from `moe.route` and `moe.combine_weights`, so that a fault of
    theirs shows: the top-k by k first-index argmaxes (ties to the lower
    expert), the slot-major cumsum over a one-hot, and the combine weights
    as the reference's dense one-hot product. Each expert's slots go
    through its weights widened to f64 one expert at a time; the shared
    expert in f64. Each (token, k) assignment's margin is the f64
    probability gap to its neighbours in rank; those above MOE_MARGIN must
    route alike. The error is over the tokens whose experts and kept flags
    agree."""
    import torch.nn.functional as F

    from repro_torch.models import moe
    from repro_torch.models.layers import act_fn

    m, act = cfg.moe, act_fn(cfg.act)
    b, s, d = x.shape
    e_n, k = m.n_experts, m.top_k
    tg = min(m.group_size, b * s)
    while (b * s) % tg:
        tg -= 1
    g = b * s // tg
    got, _ = moe.apply(p, cfg, x)
    rb = moe.route(p["router"], cfg, x.reshape(g, tg, d))
    x64 = x.double().reshape(g, tg, d)
    probs = torch.softmax(x64 @ p["router"].double(), dim=-1)          # [G, Tg, E]
    left, picks = probs.clone(), []
    for _ in range(k):
        j = left.argmax(-1)                                            # the first maximum
        picks.append(j)
        left.scatter_(-1, j[..., None], -math.inf)
    idx = torch.stack(picks, -1)                                       # [G, Tg, K]
    gate = probs.gather(-1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    oh = F.one_hot(idx.transpose(1, 2).reshape(g, k * tg), e_n)         # slot-major
    pos = ((oh.cumsum(1) - 1) * oh).sum(-1).reshape(g, k, tg).transpose(1, 2)
    c = max(4, -(-math.ceil(tg * k / e_n * m.capacity_factor) // 4) * 4)
    keep = pos < c
    comb = torch.einsum("gtke,gtkc->gtec", F.one_hot(idx, e_n).double() * (gate * keep)[..., None],
                        F.one_hot(pos.clamp_max(c), c + 1)[..., :c].double())
    want = torch.zeros_like(x64)
    for e in range(e_n):
        ce = comb[:, :, e]                                             # [G, Tg, C]
        xe = torch.bmm((ce > 0).double().transpose(1, 2), x64).reshape(g * c, d)
        h = act(xe @ p["wg"][e].double()) * (xe @ p["wu"][e].double())
        want += torch.bmm(ce, (h @ p["wd"][e].double()).reshape(g, c, d))
    if m.n_shared:
        sh, xs = p["shared"], x64.reshape(g * tg, d)
        want += ((act(xs @ sh["wg"].double()) * (xs @ sh["wu"].double()))
                 @ sh["wd"].double()).reshape(g, tg, d)
    ranked = torch.sort(probs, dim=-1, descending=True).values
    gaps = ranked[..., :-1] - ranked[..., 1:]                          # rank j vs j + 1
    below = gaps[..., :k]
    above = torch.cat([torch.full_like(below[..., :1], math.inf), gaps[..., :k - 1]], -1)
    sure = torch.minimum(below, above) > MOE_MARGIN                    # [G, Tg, K]
    same = rb.idx == idx
    alike = (same & (rb.keep == keep)).all(-1)                         # [G, Tg]
    err = (got.double().reshape(g, tg, d) - want).abs().amax(-1)
    return dict(assignments=sure.numel(), checked=int(sure.sum()),
                checked_differ=int((sure & ~same).sum()), differ=int((~same).sum()),
                tokens=alike.numel(), tokens_alike=int(alike.sum()),
                err=float(err[alike].max()), err_all_tokens=float(err.max()),
                f64_max=float(want.abs().max()), drop_share_f64=float(1 - keep.double().mean()))


def moe_serve(torch, arch: str, layers: int, launches: dict, profile: bool) -> dict:
    """One MoE decoder at its published width, cut to ``layers`` layers, bf16
    weights from the seed, on phase 11's trace: the counted generates, time
    to first token, decode ms a token, tokens/s and peak memory; then one
    recorded prefill (every layer's attention inputs, routing, and layer 0's
    MoE input) for the gates and the device-time breakdown."""
    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.models import count_params, get_model, init_params, moe
    from repro_torch.models.transformer import _layer
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.tree import tree_leaves

    dev = "cuda"
    b, s, new = LM["batch"], LM["prompt_len"], LM["max_new"]
    cfg = moe_cfg(arch, layers)
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2**30      # what earlier phases hold
    t0 = time.perf_counter()
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    toks = torch.randint(0, cfg.vocab, (b, s), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    prompt = {"tokens": toks}
    eng = Engine(model, ServeConfig(max_new=new))
    what = f"moe {arch} ({layers} layers)"

    gen_s, outs = [], []
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for _ in range(LM_GENERATES):
        t0 = time.perf_counter()
        outs.append(eng.generate(params, prompt))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    counts = tk.launch_counts()
    require_only(counts, ("flash_attention_fwd",), f"{what} generate")
    require(counts["flash_attention_fwd"] == layers * LM_GENERATES,
            f"{what}: {counts['flash_attention_fwd']} attention launches in {LM_GENERATES} "
            f"generates, expected {layers} a generate")
    add_launches(launches, counts)
    require(tuple(outs[0].shape) == (b, new) and
            bool(((outs[0] >= 0) & (outs[0] < cfg.vocab)).all()),
            f"{what}: tokens {tuple(outs[0].shape)} out of shape or range")
    require(torch.equal(outs[0], outs[1]), f"{what}: two generates differ in "
                                           f"{int((outs[0] != outs[1]).sum())} tokens")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    ttft_ms, dec_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, prompt, pad_to=s + new + 1)
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(new):
            step, cache = model.decode_fn(params, cache, tok, s + i)
            tok = torch.argmax(step, -1).to(torch.int32)
        torch.cuda.synchronize()
        ttft_ms.append((t1 - t0) * 1e3)
        dec_ms.append((time.perf_counter() - t1) / new * 1e3)
    require(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all()),
            f"{what}: logits not finite")
    del cache, logits, step
    tok_s = b * new / statistics.median(gen_s[1:])
    out = dict(arch=cfg.name, layers=layers, params=count_params(model.specs),
               weight_gb=weight_gb, init_s=init_s, generate_s=gen_s, ttft_ms=ttft_ms,
               decode_ms_per_token=dec_ms, tokens_per_s=tok_s, peak_gib=peak_gib,
               held_before_gib=before_gib, launches=counts["flash_attention_fwd"])
    print(f"moe serve: {cfg.name} at {layers} of its layers ({out['params']} parameters, "
          f"{weight_gb:.2f} GB, drawn in {init_s:.1f} s; d {cfg.d_model}, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k}, head dim {cfg.hd}, bf16), batch {b} x prompt {s} x "
          f"{new} new, greedy: prefill (time to first token) {statistics.median(ttft_ms):.3f} ms, "
          f"decode {statistics.median(dec_ms):.3f} ms/token, generate {gen_s[0]:.3f} s cold / "
          f"{statistics.median(gen_s[1:]):.3f} s warm ({tok_s:.1f} generated tokens/s), peak "
          f"memory {peak_gib:.2f} GiB ({before_gib:.2f} held before the draw)", flush=True)

    # one recorded prefill: the gates' inputs
    seen, whole = [], {}

    def record(q, k, v, **kw):
        whole.setdefault("qkv", (q, k, v, kw))
        seen.append((q[:2], k[:2], v[:2], kw))
        return tk.flash_attention_fwd(q, k, v, **kw)

    with using(record), moe_taps() as (routes, first):
        model.prefill_fn(params, prompt)
    stats = moe_routing_stats(torch, routes)
    require(len(routes) == layers and stats["cells_off"] == 0,
            f"{what}: {stats['cells_off']} (group, expert) cells keep other than "
            f"min(load, C) over {len(routes)} layers")
    rows = []
    for q, k, v, kw in seen:
        want = exact_attention(torch, q, k, v, **kw)
        rows.append(tuple(float((got.double() - want).abs().max()) for got in (
            tk.flash_attention_fwd(q, k, v, **kw), flash_fwd_ref(q, k, v, **kw))))
        del want
    del seen
    require(len(rows) == layers and all(a <= FLASH_BF16_VS_TWIN * t for a, t in rows),
            f"{what}: a layer's attention off f64 by more than {FLASH_BF16_VS_TWIN}x the "
            f"twin's: {rows}")
    p0 = _layer(params["blocks"], 0)["mlp"]
    x0 = first["x"]
    f64 = moe_layer_vs_f64(torch, p0, cfg, x0)
    require(f64["checked_differ"] == 0,
            f"{what}: {f64['checked_differ']} assignments with f64 margin > {MOE_MARGIN} "
            f"routed unlike the f64 evaluation")
    require(f64["err"] <= MOE_BF16_BOUND[arch],
            f"{what}: layer 0's MoE off its f64 evaluation by {f64['err']} > "
            f"{MOE_BF16_BOUND[arch]}")
    out.update(routing=stats, attention_err_vs_f64=rows, moe_vs_f64=f64)

    # where a prefill's device time goes: layer 0's parts on its own input
    m = cfg.moe
    tg = moe.group_tokens(b * s, m.group_size)
    g, e, d = b * s // tg, m.n_experts, cfg.d_model
    xg = x0.reshape(g, tg, d)
    comb = moe.combine_weights(moe.route(p0["router"], cfg, xg), cfg.dtype)
    c = comb.shape[-1] // e
    xe = moe.dispatch(xg, comb).reshape(g, e, c, d).transpose(0, 1).reshape(e, g * c, d)
    ye = moe.experts(p0, cfg, xe).reshape(e, g, c, d).transpose(0, 1).reshape(g, e * c, d)
    q, k, v, kw = whole["qkv"]
    parts = dict(
        prefill=call_ms(torch, lambda: model.prefill_fn(params, prompt), 1, 2),
        attention=call_ms(torch, lambda: tk.flash_attention_fwd(q, k, v, **kw), 1, 3),
        moe_layer=call_ms(torch, lambda: moe.apply(p0, cfg, x0), 1, 3),
        route=call_ms(torch, lambda: moe.combine_weights(moe.route(p0["router"], cfg, xg),
                                                        cfg.dtype), 1, 3),
        dispatch=call_ms(torch, lambda: moe.dispatch(xg, comb), 1, 3),
        experts=call_ms(torch, lambda: moe.experts(p0, cfg, xe), 1, 3),
        combine=call_ms(torch, lambda: moe.combine(comb, ye), 1, 3))
    del xe, ye, comb, whole
    per_layer = parts["attention"] + parts["moe_layer"]
    parts["rest"] = parts["prefill"] - layers * per_layer
    flops = dict(dispatch_combine=2 * 2 * b * s * e * c * d,
                 experts=3 * 2 * e * g * c * d * m.d_expert)
    out.update(prefill_parts_ms=parts, moe_flops=flops)
    print(f"moe profile {arch} prefill (CUDA events; layer 0's parts on its own input, x "
          f"{layers} layers): prefill {parts['prefill']:.3f} ms; a layer: attention kernel "
          f"{parts['attention']:.3f}, MoE block {parts['moe_layer']:.3f} (routing and slots "
          f"{parts['route']:.3f}, dispatch {parts['dispatch']:.3f}, expert GEMMs "
          f"{parts['experts']:.3f}, combine {parts['combine']:.3f}); the rest of the prefill "
          f"{parts['rest']:.3f} (projections, norms, RoPE, head); G {g} x Tg {tg}, C {c}: "
          f"dispatch + combine {flops['dispatch_combine'] / 1e12:.3f} TFLOP, experts "
          f"{flops['experts'] / 1e12:.3f} TFLOP a layer", flush=True)
    if profile:
        out["profile prefill"] = profile_calls(torch, f"moe {arch} prefill bf16", [
            lambda: model.prefill_fn(params, prompt)], share_of="flash_fwd")
    worst = max(a for a, _ in rows), max(t for _, t in rows)
    print(f"moe checks {arch}: {out['launches']} attention launches in {LM_GENERATES} "
          f"generates ({layers} each, D = {cfg.hd}), nothing else launched; two generates "
          f"bit-identical; every (group, expert) keeps min(load, C = {stats['capacity']}), "
          f"{stats['dropped']} of {stats['assignments']} (token, k) assignments dropped "
          f"({stats['drop_share']:.4f}) in the prefill; every layer's attention vs f64, "
          f"worst max |err| kernel / twin {worst[0]:.4g} / {worst[1]:.4g}; layer 0's MoE vs "
          f"f64: {f64['checked']} of {f64['assignments']} assignments with margin > "
          f"{MOE_MARGIN} all routed alike ({f64['differ']} differ in all), max |err| over "
          f"{f64['tokens_alike']} of {f64['tokens']} tokens routed alike {f64['err']:.4g} "
          f"(bound {MOE_BF16_BOUND[arch]}; all tokens {f64['err_all_tokens']:.4g}, max "
          f"|f64| {f64['f64_max']:.4g})", flush=True)
    del params, prompt, eng, x0, first, p0, routes
    torch.cuda.empty_cache()
    return out


def moe_ring(torch) -> dict:
    """Mixtral-8x22B at its published width, MOE_RING's 2 layers in f32
    (capacity_factor E/k: an expert's capacity is its group's tokens, so
    nothing drops and grouping cannot change a token's output), with the
    attention projections at fan-in over their contraction (phase 11's f32
    gates): B 1 x prompt 4352 prefilled into the 4096-slot ring, then 16
    decodes through it, each step's logits against the prefill of the whole
    sequence at that position (causal: prefill(x ‖ t[:i+1])'s last logits)
    within 5e-3."""
    from repro_torch.models import get_model, init_params
    from repro_torch.models import transformer as tfm

    dev = "cuda"
    base = moe_cfg(MOE_RING["arch"], MOE_RING["layers"])
    cfg = moe_cfg(MOE_RING["arch"], MOE_RING["layers"], dtype=torch.float32,
                  capacity_factor=base.moe.n_experts / base.moe.top_k)
    n, new = MOE_RING["prompt_len"], MOE_RING["new"]
    model = get_model(cfg)
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(SEED + 2), dev)
    fan_in_over_contraction(params, cfg)
    toks = torch.randint(0, cfg.vocab, (1, n + new), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 3))
    with moe_taps() as (routes, _):
        _, cache = model.prefill_fn(params, {"tokens": toks[:, :n]})
    require(cache["k"].shape[2] == cfg.max_window < n and all(bool(r.keep.all()) for r in routes),
            f"moe ring: cache of {cache['k'].shape[2]} slots, or an assignment dropped at "
            f"capacity_factor {cfg.moe.capacity_factor}")
    steps = []
    for i in range(new):
        lg, cache = model.decode_fn(params, cache, toks[:, n + i], n + i)
        steps.append(lg)
    positions = torch.arange(n + new, dtype=torch.int32, device=dev)[None]
    h, _ = tfm.run_stack_prefill(params, cfg, tfm.embed_tokens(params, cfg, toks), positions)
    full = tfm.logits_head(params, cfg, h[:, n:])
    errs = [float((steps[i] - full[:, i]).abs().max()) for i in range(new)]
    require(max(errs) < 5e-3, f"moe ring: decode(prefill(x), t) vs prefill(x + t) differ by "
                              f"{max(errs)}")
    out = dict(layers=cfg.n_layers, prompt_len=n, new=new, ring_slots=cache["k"].shape[2],
               capacity=routes[0].capacity, group_tokens=routes[0].idx.shape[1],
               step_errs=errs, logit_max=float(full.abs().max()))
    print(f"moe ring {cfg.name} ({cfg.n_layers} layers, f32, capacity_factor "
          f"{cfg.moe.capacity_factor}: C {out['capacity']} = Tg {out['group_tokens']}, none "
          f"dropped): prompt {n} into a {out['ring_slots']}-slot ring, {new} decodes through it; "
          f"each step's logits vs the whole sequence's prefill at that position, worst max "
          f"|diff| {max(errs):.3g} (bound 5e-3; max |logit| {out['logit_max']:.3g})", flush=True)
    del params, cache, h, full, steps
    torch.cuda.empty_cache()
    return out


def phase_moe(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 20: the MoE decoder at its published widths (MOE_RUNS), one model
    on the card at a time, and Mixtral's ring decode (MOE_RING)."""
    out = {}
    arch, layers = MOE_RUNS[0]
    out[arch] = moe_serve(torch, arch, layers, launches, profile)
    out["ring"] = moe_ring(torch)
    for arch, layers in MOE_RUNS[1:]:
        out[arch] = moe_serve(torch, arch, layers, launches, profile)
    return out


# ---------------------------------------------------------------------------
# phase 21: the SSM and hybrid decoders (Falcon-Mamba-7B and Zamba2-2.7B)
# ---------------------------------------------------------------------------

def ssm_cfg(arch: str, layers: int | None = None, dtype=None):
    """The published config, or cut to ``layers`` layers (the hybrid's
    groups then hold one Mamba-2 layer each), in ``dtype`` if given."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch)
    kw = {}
    if layers is not None:
        kw["n_layers"] = layers
        if cfg.shared_attn_every:
            kw["shared_attn_every"] = 1
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(cfg, **kw)


def ssm_block_f64(torch, p: dict, cfg, x):
    """Layer 0's Mamba block in f64, written apart from `models.mamba` but
    for the sequential recurrence itself (`selective_scan_ref` / `ssd_ref`
    run in f64): (block output, the recurrence's inputs, its y and final
    state)."""
    import torch.nn.functional as F

    from repro_torch.models import mamba

    s_cfg, (b, s, d) = cfg.ssm, x.shape
    din, k = s_cfg.expand * d, s_cfg.d_conv
    P = {n: t.double() for n, t in p.items()}
    xd = x.double()

    def rms(v, gain):
        return v * torch.rsqrt((v * v).mean(-1, keepdim=True) + cfg.norm_eps) * (1 + gain)

    def conv(v):
        vp = F.pad(v, (0, 0, k - 1, 0))
        return F.silu(sum(vp[:, j:j + s] * P["conv_w"][:, j] for j in range(k)) + P["conv_b"])

    h = rms(xd, P["norm"])
    if s_cfg.kind == "mamba1":
        r, n = s_cfg.dt_rank or d // 16, s_cfg.d_state
        xin, z = (h @ P["in_proj"]).split(din, -1)
        xc = conv(xin)
        dt_raw, bm, cm = (xc @ P["x_proj"]).split([r, n, n], -1)
        dt = F.softplus(dt_raw @ P["dt_proj"] + P["dt_bias"])
        args = (xc, dt, -torch.exp(P["A_log"]), bm, cm, P["D"])
        y, hf = mamba.selective_scan_ref(*args, torch.zeros((b, din, n), dtype=torch.float64,
                                                            device=x.device))
        gated = y * F.silu(z)
    else:
        nh, gn = din // s_cfg.head_dim, s_cfg.n_groups * s_cfg.d_state
        z, xbc, dt_raw = (h @ P["in_proj"]).split([din, din + 2 * gn, nh], -1)
        xin, bm, cm = conv(xbc).split([din, gn, gn], -1)
        groups = (b, s, s_cfg.n_groups, s_cfg.d_state)
        args = (xin.reshape(b, s, nh, s_cfg.head_dim), F.softplus(dt_raw + P["dt_bias"]),
                -torch.exp(P["A_log"]), bm.reshape(groups), cm.reshape(groups), P["D"])
        y, hf = mamba.ssd_ref(*args, torch.zeros((b, nh, s_cfg.d_state, s_cfg.head_dim),
                                                 dtype=torch.float64, device=x.device))
        gated = rms(y.reshape(b, s, din) * F.silu(z), P["gate_norm"])
    return xd + gated @ P["out_proj"], args, y, hf


def ssm_layer_vs_f64(torch, p: dict, cfg, x) -> dict:
    """Layer 0's block at full width: (a) the port's block in bf16 on its
    input x against the f64 evaluation, max |diff| over max |f64|, within
    SSM_BF16_REL; (b) the port's chunked scan (`selective_scan` / `ssd`, f32)
    on the f64 evaluation's own scan inputs, rounded to f32, against the
    f64 sequential recurrence: its final state, and the recurrence's part
    of y (y - D u: the f32 scan run with D = 0, since the skip D u is ~1000x
    the recurrence's part at the seeded init and an f32 y would round the
    part away), each within SSM_SCAN_REL of its largest entry."""
    from repro_torch.models import mamba

    kind = cfg.ssm.kind
    block = mamba.mamba1_block if kind == "mamba1" else mamba.mamba2_block
    scan = mamba.selective_scan if kind == "mamba1" else mamba.ssd
    got, _ = block(p, cfg, x)
    want, args, y64, h64 = ssm_block_f64(torch, p, cfg, x)
    block_err = float((got.double() - want).abs().max()) / float(want.abs().max())
    a32 = [t.float() for t in args[:5]] + [torch.zeros_like(args[5], dtype=torch.float32)]
    h0 = torch.zeros_like(h64, dtype=torch.float32)
    rec32, h32 = scan(*a32, h0, cfg.ssm.chunk)
    u64, d64 = args[0], (args[5][:, None] if kind == "mamba2" else args[5])
    rec64 = y64 - u64 * d64
    out = dict(block_rel_err=block_err, f64_max=float(want.abs().max()),
               state_rel_err=float((h32.double() - h64).abs().max() / h64.abs().max()),
               rec_rel_err=float((rec32.double() - rec64).abs().max() / rec64.abs().max()),
               state_max=float(h64.abs().max()), rec_max=float(rec64.abs().max()),
               skip_max=float((u64 * d64).abs().max()))
    del got, want, args, y64, h64, a32, rec32, h32, rec64
    return out


def ssm_layer_parts(torch, params: dict, cfg, x) -> dict:
    """CUDA-event times (ms) of layer 0's parts on its own input x at the
    prefill's shape: norm + in_proj, the conv (and SiLU), x_proj/dt (Mamba-1:
    x_proj, dt_proj, softplus; Mamba-2: softplus), the scan (selective_scan
    or SSD), the gate and out_proj, and the whole block; for the hybrid also
    group 0's shared block, its attention (norm, projections, RoPE, the
    kernel, output projection) and its MLP."""
    import torch.nn.functional as F

    from repro_torch.models import hybrid, mamba
    from repro_torch.models.layers import dense, rmsnorm

    s_cfg, (b, s, d) = cfg.ssm, x.shape
    din = s_cfg.expand * d
    hyb = bool(cfg.shared_attn_every)
    p = hybrid._mamba_layer(params["groups"], 0, 0) if hyb else {
        k: v[0] for k, v in params["blocks"].items()}

    def t(fn):
        return call_ms(torch, fn, 1, 3)

    parts = {}
    proj = lambda: dense(rmsnorm(x, p["norm"], cfg.norm_eps), p["in_proj"])  # noqa: E731
    parts["in_proj"] = t(proj)
    xz = proj()
    if s_cfg.kind == "mamba1":
        r, n = s_cfg.dt_rank or d // 16, s_cfg.d_state
        xin, z = xz.split(din, -1)
        conv = lambda: F.silu(mamba.causal_conv1d(xin, p["conv_w"], p["conv_b"]).float()  # noqa: E731
                              ).to(x.dtype)
        parts["conv"] = t(conv)
        xc = conv()

        def xdt():
            dt_raw, bm, cm = mamba._dot_f32(xc, p["x_proj"]).split([r, n, n], -1)
            return F.softplus(dt_raw @ p["dt_proj"].float() + p["dt_bias"]), bm, cm

        parts["x_proj_dt"] = t(xdt)
        dt, bm, cm = xdt()
        h0 = torch.zeros((b, din, n), dtype=torch.float32, device=x.device)
        scan = lambda: mamba.selective_scan(xc, dt, -torch.exp(p["A_log"]), bm, cm,  # noqa: E731
                                            p["D"], h0, s_cfg.chunk)
        parts["scan"] = t(scan)
        y = scan()[0]
        gate = lambda: dense((y.float() * F.silu(z.float())).to(x.dtype),  # noqa: E731
                             p["out_proj"])
        parts["gate_out_proj"] = t(gate)
        parts["block"] = t(lambda: mamba.mamba1_block(p, cfg, x))
    else:
        nh, gn = din // s_cfg.head_dim, s_cfg.n_groups * s_cfg.d_state
        z, xbc, dt_raw = xz.split([din, din + 2 * gn, nh], -1)
        conv = lambda: F.silu(mamba.causal_conv1d(xbc, p["conv_w"], p["conv_b"]).float()  # noqa: E731
                              ).to(x.dtype)
        parts["conv"] = t(conv)
        xin, bm, cm = conv().split([din, gn, gn], -1)
        soft = lambda: F.softplus(dt_raw.float() + p["dt_bias"])  # noqa: E731
        parts["x_proj_dt"] = t(soft)
        dt = soft()
        groups = (b, s, s_cfg.n_groups, s_cfg.d_state)
        h0 = torch.zeros((b, nh, s_cfg.d_state, s_cfg.head_dim), dtype=torch.float32,
                         device=x.device)
        scan = lambda: mamba.ssd(xin.reshape(b, s, nh, s_cfg.head_dim), dt,  # noqa: E731
                                 -torch.exp(p["A_log"]), bm.reshape(groups),
                                 cm.reshape(groups), p["D"], h0, s_cfg.chunk)
        parts["scan"] = t(scan)
        y = scan()[0].reshape(b, s, din)
        gate = lambda: dense(rmsnorm((y.float() * F.silu(z.float())).to(x.dtype),  # noqa: E731
                                     p["gate_norm"], cfg.norm_eps), p["out_proj"])
        parts["gate_out_proj"] = t(gate)
        parts["block"] = t(lambda: mamba.mamba2_block(p, cfg, x))
        shared, grp = params["shared"], params["groups"]
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)

        def attn():
            h = rmsnorm(x, grp["ln1"][0], cfg.norm_eps)
            q, k, v = hybrid._attn_heads(shared["attn"], cfg, h, pos, cfg.rope_theta)
            o = hybrid.flash_attention(q, k, v, causal=True)
            return x + hybrid._attn_out(shared["attn"], cfg, o)

        parts["shared_attention"] = t(attn)
        xa = attn()
        parts["shared_mlp"] = t(lambda: hybrid._shared_mlp(shared, grp["ln2"][0], cfg, xa))
    return parts


def cpu_op_watch(torch):
    """A dispatch mode that records the aten ops given a CPU tensor (gate 5:
    nothing on the path reads or writes the host's memory): ``cpu_ops``
    those with a CPU tensor of one or more dimensions, ``cpu_scalars``
    those with a 0-dim one only (a host scalar, as a Python number is)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cpu_ops, self.cpu_scalars = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            flat = []
            for a in list(args) + list(kwargs.values()):
                flat.extend(a if isinstance(a, (list, tuple)) else [a])
            cpu = [a for a in flat if isinstance(a, torch.Tensor) and a.device.type == "cpu"]
            if any(a.dim() > 0 for a in cpu):
                self.cpu_ops.append(str(func))
            elif cpu:
                self.cpu_scalars.append(str(func))
            return func(*args, **kwargs)

    return Watch()


def ssm_small(torch, arch: str, launches: dict) -> dict:
    """Gates 1, 3 and 5 at SSM_SMALL's reduced depth in f32 (the hybrid's
    two groups hold one Mamba-2 layer each; its shared attention at fan-in
    over its contraction, phase 11's f32 conditioning): decode(prefill(x),
    t) against prefill(x ‖ t) at each of SSM_SMALL's steps within
    SSM_SMALL["tol"] (the reference's bound, tests/test_models.py); the
    ContinuousEngine's completions on SSM_SMALL's trace == static B = 1
    generates, greedy, slots reused; and no aten op on a CPU tensor in a
    prefill and a decode step. Launches here are not counted."""
    from repro_torch.models import get_model, init_params
    from repro_torch.serving import ContinuousEngine, Engine, Scheduler, ServeConfig

    dev = "cuda"
    sm = SSM_SMALL
    cfg = ssm_cfg(arch, sm["layers"], torch.float32)
    model = get_model(cfg)
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(SEED + 4), dev)
    if cfg.shared_attn_every:       # the shared attention block, as phase 11's layers
        fan_in_over_contraction({"blocks": {"attn": params["shared"]["attn"]}}, cfg)
    n, steps = sm["prompt_len"], sm["steps"]
    toks = torch.randint(0, cfg.vocab, (sm["batch"], n + steps), device=dev,
                         dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 5))
    watch = cpu_op_watch(torch)
    with watch:
        _, cache = model.prefill_fn(params, {"tokens": toks[:, :n]}, pad_to=n + steps + 1)
        lg, cache = model.decode_fn(params, cache, toks[:, n], n)
    require(not watch.cpu_ops and all(t.is_cuda for t in cache.values()) and lg.is_cuda,
            f"ssm {arch}: ops on CPU tensors in a prefill and a decode: "
            f"{sorted(set(watch.cpu_ops))[:8]}")
    errs = []
    for i in range(steps):
        if i:
            lg, cache = model.decode_fn(params, cache, toks[:, n + i], n + i)
        full, _ = model.prefill_fn(params, {"tokens": toks[:, :n + i + 1]})
        errs.append(float((lg - full).abs().max()))
    require(max(errs) < sm["tol"], f"ssm {arch}: decode(prefill(x), t) vs prefill(x + t) "
                                   f"differ by {max(errs)} (bound {sm['tol']})")
    # continuous == static, slots reused
    rng = torch.Generator(device=dev).manual_seed(SEED + 6)
    lengths = [sm["lengths"][i % len(sm["lengths"])] for i in range(sm["requests"])]
    prompts = [torch.randint(0, cfg.vocab, (m,), device=dev, dtype=torch.int32, generator=rng)
               for m in lengths]
    scfg = ServeConfig(max_new=sm["max_new"])
    eng = ContinuousEngine(model, scfg, num_slots=sm["slots"], max_prompt_len=max(lengths))
    sched = Scheduler(eng, params)
    rids = [sched.submit(p) for p in prompts]
    sched.run(timeout=600)
    same = 0
    for rid, p in zip(rids, prompts):
        want = Engine(model, scfg).generate(params, {"tokens": p[None]})[0]
        same += sched.poll(rid).tokens == want.tolist()
    require(same == len(prompts), f"ssm {arch}: {same} of {len(prompts)} continuous "
                                  f"completions == their static B = 1 generate")
    out = dict(layers=cfg.n_layers, step_errs=errs, cont_equal=same, requests=len(prompts),
               cont_steps=sched.steps, cpu_ops=len(watch.cpu_ops),
               cpu_scalar_ops=sorted(set(watch.cpu_scalars)))
    print(f"ssm small {cfg.name} ({cfg.n_layers} layers, f32): decode(prefill(x), t) vs "
          f"prefill(x + t), {steps} steps from prompt {n}, worst max |diff| {max(errs):.3g} "
          f"(bound {sm['tol']}); continuous, {sm['slots']} slots: {same} of {len(prompts)} "
          f"completions == their static B = 1 generate ({sched.steps} steps); aten ops on "
          f"CPU tensors in a prefill and a decode: {len(watch.cpu_ops)} (on CPU scalars: "
          f"{len(watch.cpu_scalars)})", flush=True)
    del params, cache, eng, sched
    torch.cuda.empty_cache()
    return out


def ssm_serve(torch, arch: str, launches: dict, profile: bool) -> dict:
    """One SSM-family decoder at its published width and depth, bf16 weights
    from the seed, on phase 11's trace (LM) through `Engine.generate`: the
    counted generates (the hybrid's attention kernel once a group in a
    prefill, nothing else launched; nothing at all for the SSM), time to
    first token, decode ms a token, tokens/s and peak memory; layer 0's
    block against f64 (gate 2) and its parts' CUDA-event times."""
    import dataclasses

    from repro_torch import kernels as tk
    from repro_torch.models import count_params, get_model, hybrid, init_params, zoo
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.tree import tree_leaves

    dev = "cuda"
    b, s, new = LM["batch"], LM["prompt_len"], LM["max_new"]
    cfg = ssm_cfg(arch)
    hyb = bool(cfg.shared_attn_every)
    groups = cfg.n_layers // cfg.shared_attn_every if hyb else 0
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    toks = torch.randint(0, cfg.vocab, (b, s), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    prompt = {"tokens": toks}
    what = f"ssm {arch} ({cfg.n_layers} layers)"
    # the engine's prefill timed inside each generate (time to first token;
    # the decode's ms a token is the rest of the generate over its steps),
    # with its launches and its last logits kept
    seen = {"prefill_s": [], "prefill_launches": []}

    def timed_prefill(params, batch, pad_to=None):
        torch.cuda.synchronize()
        before, t0 = tk.launch_counts(), time.perf_counter()
        logits, cache = model.prefill_fn(params, batch, pad_to=pad_to)
        torch.cuda.synchronize()
        seen["prefill_s"].append(time.perf_counter() - t0)
        seen["prefill_launches"].append(tk.launch_counts()["flash_attention_fwd"]
                                        - before["flash_attention_fwd"])
        seen["prefill_logits"] = logits
        return logits, cache

    def kept_decode(params, cache, token, pos):
        seen["decode_logits"], cache = model.decode_fn(params, cache, token, pos)
        return seen["decode_logits"], cache

    eng = Engine(dataclasses.replace(model, prefill_fn=timed_prefill, decode_fn=kept_decode),
                 ServeConfig(max_new=new))

    gen_s, outs = [], []
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for _ in range(LM_GENERATES):
        t0 = time.perf_counter()
        outs.append(eng.generate(params, prompt))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    counts = tk.launch_counts()
    if hyb:
        require_only(counts, ("flash_attention_fwd",), f"{what} generate")
        require(seen["prefill_launches"] == [groups] * LM_GENERATES
                and counts["flash_attention_fwd"] == groups * LM_GENERATES,
                f"{what}: {seen['prefill_launches']} attention launches in the prefills of "
                f"{LM_GENERATES} generates and {counts['flash_attention_fwd']} in all, "
                f"expected {groups} a prefill (one a group) and none in a decode step")
    else:
        require(all(v == 0 for v in counts.values()), f"{what}: launches {counts}, expected none")
    add_launches(launches, counts)
    require(tuple(outs[0].shape) == (b, new) and
            bool(((outs[0] >= 0) & (outs[0] < cfg.vocab)).all()),
            f"{what}: tokens {tuple(outs[0].shape)} out of shape or range")
    require(torch.equal(outs[0], outs[1]), f"{what}: two generates differ in "
                                           f"{int((outs[0] != outs[1]).sum())} tokens")
    require(bool(torch.isfinite(seen["prefill_logits"]).all()) and
            bool(torch.isfinite(seen["decode_logits"]).all()), f"{what}: logits not finite")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ttft_ms = statistics.median(seen["prefill_s"][1:]) * 1e3
    dec_ms = statistics.median((g - p) / new * 1e3 for g, p in
                               zip(gen_s[1:], seen["prefill_s"][1:]))
    tok_s = b * new / statistics.median(gen_s[1:])
    out = dict(arch=cfg.name, layers=cfg.n_layers, params=count_params(model.specs),
               weight_gb=weight_gb, init_s=init_s, generate_s=gen_s,
               prefill_s=seen["prefill_s"], ttft_ms=ttft_ms,
               decode_ms_per_token=dec_ms, tokens_per_s=tok_s, peak_gib=peak_gib,
               held_before_gib=before_gib, launches=counts.get("flash_attention_fwd", 0))
    print(f"ssm serve: {cfg.name} at {cfg.n_layers} of its {cfg.n_layers} layers "
          f"({out['params']} parameters, {weight_gb:.2f} GB, drawn in {init_s:.1f} s; d "
          f"{cfg.d_model}, {cfg.ssm.kind}, d_inner {cfg.ssm.expand * cfg.d_model}, N "
          f"{cfg.ssm.d_state}{f', {groups} shared-attention calls at D {cfg.hd}' if hyb else ''}"
          f", bf16), batch {b} x prompt {s} x {new} new, greedy, the warm generate: prefill "
          f"(time to first token) {ttft_ms:.3f} ms, decode {dec_ms:.3f} ms/token, generate "
          f"{gen_s[0]:.3f} s cold / {statistics.median(gen_s[1:]):.3f} s warm ({tok_s:.1f} "
          f"generated tokens/s), peak memory {peak_gib:.2f} GiB ({before_gib:.2f} held before "
          f"the draw)", flush=True)
    del seen

    # layer 0's input (the embedding, or after group 0's shared block), the
    # gates and the parts
    x0 = tfm.embed_tokens(params, cfg, toks)
    if hyb:
        grp = params["groups"]
        x0 = hybrid._shared_attn_train(params["shared"], grp["ln1"][0], grp["ln2"][0], cfg, x0,
                                       zoo._positions(toks))[0]
        p0 = hybrid._mamba_layer(grp, 0, 0)
    else:
        p0 = {k: v[0] for k, v in params["blocks"].items()}
    f64 = ssm_layer_vs_f64(torch, p0, cfg, x0)
    require(f64["block_rel_err"] <= SSM_BF16_REL,
            f"{what}: layer 0's block off its f64 evaluation by {f64['block_rel_err']} of "
            f"max |f64| > {SSM_BF16_REL}")
    require(max(f64["state_rel_err"], f64["rec_rel_err"]) <= SSM_SCAN_REL,
            f"{what}: the chunked scan off the f64 recurrence: state {f64['state_rel_err']}, "
            f"y - D u {f64['rec_rel_err']} of their max > {SSM_SCAN_REL}")
    parts = ssm_layer_parts(torch, params, cfg, x0)
    parts["scan_share_of_first_token"] = cfg.n_layers * parts["scan"] / ttft_ms
    out.update(layer0_vs_f64=f64, prefill_parts_ms=parts)
    extra = (f", shared block: attention {parts['shared_attention']:.3f} (the kernel at D "
             f"{cfg.hd} inside), MLP {parts['shared_mlp']:.3f} (x {groups})" if hyb else "")
    print(f"ssm profile {arch} prefill (CUDA events; layer 0's parts on its own input, x "
          f"{cfg.n_layers} layers): first token {ttft_ms:.3f} ms; a layer: norm + in_proj "
          f"{parts['in_proj']:.3f}, conv {parts['conv']:.3f}, x_proj/dt {parts['x_proj_dt']:.3f}, "
          f"scan {parts['scan']:.3f}, gate + out_proj {parts['gate_out_proj']:.3f}; the block "
          f"{parts['block']:.3f}{extra}; the scans {parts['scan_share_of_first_token']:.3f} of "
          f"the first token", flush=True)
    if profile:
        out["profile prefill"] = profile_calls(torch, f"ssm {arch} prefill bf16", [
            lambda: model.prefill_fn(params, prompt)],
            share_of="flash_fwd" if hyb else None)
        _, cache = model.prefill_fn(params, prompt, pad_to=s + new + 1)
        tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        out["profile decode"] = profile_calls(torch, f"ssm {arch} decode step bf16", [
            lambda i=i: model.decode_fn(params, cache, tok, s + i) for i in range(4)])
        del cache
    print(f"ssm checks {arch}: {out['launches']} attention launches in {LM_GENERATES} "
          f"generates ({groups if hyb else 0} each, none in a decode step), nothing else "
          f"launched; two generates bit-identical; layer 0's block (bf16) vs f64: "
          f"{f64['block_rel_err']:.3g} of max |f64| {f64['f64_max']:.4g} (bound "
          f"{SSM_BF16_REL}); the chunked scan (f32) vs the f64 sequential recurrence on the "
          f"layer's inputs: final state {f64['state_rel_err']:.3g} of {f64['state_max']:.4g}, "
          f"y - D u {f64['rec_rel_err']:.3g} of {f64['rec_max']:.4g} (bound {SSM_SCAN_REL}; "
          f"max |D u| {f64['skip_max']:.4g})", flush=True)
    del params, prompt, eng, x0, p0
    torch.cuda.empty_cache()
    return out


def phase_ssm(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 21: the SSM and hybrid decoders at their published widths and
    depths (SSM_RUNS), one model on the card at a time, then SSM_SMALL's
    f32 gates of each."""
    out = {}
    for arch in SSM_RUNS:
        out[arch] = ssm_serve(torch, arch, launches, profile)
    for arch in SSM_RUNS:
        out[f"{arch} small"] = ssm_small(torch, arch, launches)
    return out


# ---------------------------------------------------------------------------
# phase 22: the enc-dec and VLM decoders (Whisper-tiny and Qwen2-VL-7B)
# ---------------------------------------------------------------------------

def xd_cfg(arch: str, layers: int | None = None, dtype=None):
    """The published config, or cut to ``layers`` layers (Whisper's encoder
    too), in ``dtype`` if given."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch)
    kw = {}
    if layers is not None:
        kw["n_layers"] = layers
        if cfg.kind == "encdec":
            kw["n_enc_layers"] = layers
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(cfg, **kw)


def xd_attention_trees(params: dict, cfg) -> list:
    """Every attention projection set of a model: Whisper's encoder, decoder
    and cross-attention, or the decoder stack's."""
    if cfg.kind == "encdec":
        return [params["enc_blocks"]["attn"], params["dec_blocks"]["attn"],
                params["dec_blocks"]["xattn"]]
    return [params["blocks"]["attn"]]


def xd_condition(params: dict, cfg) -> dict:
    """`fan_in_over_contraction` on every attention projection set."""
    for a in xd_attention_trees(params, cfg):
        fan_in_over_contraction({"blocks": {"attn": a}}, cfg)
    return params


def xd_mrope64(torch, x, positions, theta: float, sections: tuple):
    """M-RoPE in f64, written apart from `layers.apply_rope`: each of the D/2
    frequency slots rotates by its section's position stream."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    sec = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)], device=x.device)
    p = positions.double().gather(-1, sec.expand(*positions.shape[:-1], half))
    cos, sin = torch.cos(p * freqs)[..., None, :], torch.sin(p * freqs)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def xd_block_f64(torch, blk: dict, cfg, x, enc=None, positions=None, causal=True):
    """One block in f64, written apart from the port's modules: pre-RMSNorm
    attention (Whisper: no RoPE; Qwen2-VL: M-RoPE), Whisper's decoder
    cross-attention over ``enc`` when given, and the gated MLP. Weights are
    the block's, widened."""
    import torch.nn.functional as F

    def rms(v, gain):
        return v * torch.rsqrt((v * v).mean(-1, keepdim=True) + cfg.norm_eps) * (
            1 + gain.double())

    def attend(a, xq, xkv, causal, rope):
        q = torch.einsum("bsd,dhk->bshk", xq, a["wq"].double())
        k = torch.einsum("bsd,dhk->bshk", xkv, a["wk"].double())
        v = torch.einsum("bsd,dhk->bshk", xkv, a["wv"].double())
        if rope:
            q = xd_mrope64(torch, q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = xd_mrope64(torch, k, positions, cfg.rope_theta, cfg.mrope_sections)
        o = exact_attention(torch, q, k, v, causal=causal)
        return torch.einsum("bshk,hkd->bsd", o, a["wo"].double())

    act = F.silu if cfg.act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))
    x = x.double()
    x = x + attend(blk["attn"], rms(x, blk["ln1"]), rms(x, blk["ln1"]), causal,
                   cfg.mrope_sections is not None)
    if enc is not None:
        h = rms(x, blk["lnx"])
        x = x + attend(blk["xattn"], h, enc.double(), False, False)
    h, m = rms(x, blk["ln2"]), blk["mlp"]
    return x + (act(h @ m["wg"].double()) * (h @ m["wu"].double())) @ m["wd"].double()


def xd_layer_vs_f64(torch, params: dict, cfg, batch: dict) -> dict:
    """Layer 0's block (Whisper: the encoder's and the decoder's) in bf16 on
    the first two rows of the serve's batch against `xd_block_f64` on the
    same inputs: max |diff| over max |f64| with the kernel and with the
    plain twin in the block (at the seeded init), and with the kernel again
    after the layer's attention is put at fan-in over its contraction."""
    import copy

    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.models import encdec, vlm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import sinusoid_positions

    two = {k: v[:2] for k, v in batch.items()}
    cases = []
    if cfg.kind == "encdec":
        xe = (two["frames"] + sinusoid_positions(cfg.enc_seq, cfg.d_model, "cuda")[None]
              ).to(cfg.dtype)
        enc = encdec.run_encoder(params, cfg, two["frames"])
        s = two["tokens"].shape[1]
        xd = (params["embed"][two["tokens"]].to(cfg.dtype)
              + sinusoid_positions(s, cfg.d_model, "cuda")[None].to(cfg.dtype))
        eb, db = (tfm._layer(params[n], 0) for n in ("enc_blocks", "dec_blocks"))
        cases.append(("encoder", eb, lambda b: encdec._enc_block(b, cfg, xe),
                      lambda b: xd_block_f64(torch, b, cfg, xe, causal=False)))
        cases.append(("decoder", db, lambda b: encdec._dec_block(b, cfg, xd, enc)[0],
                      lambda b: xd_block_f64(torch, b, cfg, xd, enc=enc)))
    else:
        x0 = vlm.assemble_sequence(params, cfg, two["tokens"], two["patch_embeds"])
        pos = two["positions"]
        blk = tfm._layer(params["blocks"], 0)
        cases.append(("layer 0", blk,
                      lambda b: tfm.attn_block_train(b, cfg, x0, pos, -1, cfg.rope_theta)[0],
                      lambda b: xd_block_f64(torch, b, cfg, x0, positions=pos)))
    out = {}
    for name, blk, run, run64 in cases:
        want = run64(blk)
        scale = float(want.abs().max())
        rel = lambda got, want=want, scale=scale: float((got.double() - want).abs().max()) / scale  # noqa: E731
        kernel = rel(run(blk))
        with using(lambda q, k, v, **kw: flash_fwd_ref(q, k, v, **kw)):
            twin = rel(run(blk))
        cond = copy.copy(blk)
        cond["attn"] = {k: v.clone() for k, v in blk["attn"].items()}
        fan_in_over_contraction({"blocks": {"attn": cond["attn"]}}, cfg)
        if "xattn" in blk:
            cond["xattn"] = {k: v.clone() for k, v in blk["xattn"].items()}
            fan_in_over_contraction({"blocks": {"attn": cond["xattn"]}}, cfg)
        want_c = run64(cond)
        conditioned = float((run(cond).double() - want_c).abs().max()) / float(
            want_c.abs().max())
        out[name] = dict(kernel_rel=kernel, twin_rel=twin, f64_max=scale,
                         conditioned_rel=conditioned, conditioned_f64_max=float(
                             want_c.abs().max()))
        del want, want_c, cond
    torch.cuda.empty_cache()
    return out


def xd_serve(torch, arch: str, launches: dict, profile: bool) -> dict:
    """One model of phase 22 at its published width and depth, bf16 weights
    from the seed, its batch from the launcher's `build_batch` (Whisper's
    frames; Qwen2-VL's patch embeddings and M-RoPE positions), through
    `Engine.generate`: the counted generates (the attention kernel Whisper's
    4 encoder, 4 self and 4 cross times a prefill, Qwen2-VL's 28; none in a
    decode step; nothing else launched), time to first token (Whisper: and
    the encoder's time), decode ms a token, tokens/s and peak memory; layer
    0 against f64."""
    import dataclasses

    from repro_torch import kernels as tk
    from repro_torch.launch.serve import build_batch
    from repro_torch.models import count_params, encdec, get_model, init_params
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.tree import tree_leaves

    dev = "cuda"
    run = XD_RUNS[arch]
    b, s, new = run["batch"], run["prompt_len"], run["max_new"]
    cfg = xd_cfg(arch)
    is_encdec = cfg.kind == "encdec"
    per_generate = cfg.n_enc_layers + 2 * cfg.n_layers if is_encdec else cfg.n_layers
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    batch = build_batch(cfg, torch.Generator(device=dev).manual_seed(SEED + 1), b, s,
                        run.get("grid", (4, 4)))
    prefix = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    what = f"xd {arch} ({cfg.n_layers} layers)"
    seen = {"prefill_s": [], "prefill_launches": []}

    def timed_prefill(params, batch, pad_to=None):
        torch.cuda.synchronize()
        before, t0 = tk.launch_counts(), time.perf_counter()
        logits, cache = model.prefill_fn(params, batch, pad_to=pad_to)
        torch.cuda.synchronize()
        seen["prefill_s"].append(time.perf_counter() - t0)
        seen["prefill_launches"].append(tk.launch_counts()["flash_attention_fwd"]
                                        - before["flash_attention_fwd"])
        seen["prefill_logits"], seen["cache_shapes"] = logits, {
            k: tuple(v.shape) for k, v in cache.items()}
        return logits, cache

    def kept_decode(params, cache, token, pos):
        seen.setdefault("decode_pos", []).append(pos)
        seen["decode_logits"], cache = model.decode_fn(params, cache, token, pos)
        return seen["decode_logits"], cache

    eng = Engine(dataclasses.replace(model, prefill_fn=timed_prefill, decode_fn=kept_decode),
                 ServeConfig(max_new=new))
    gen_s, outs = [], []
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for _ in range(LM_GENERATES):
        t0 = time.perf_counter()
        outs.append(eng.generate(params, batch))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    counts = tk.launch_counts()
    require_only(counts, ("flash_attention_fwd",), f"{what} generate")
    require(seen["prefill_launches"] == [per_generate] * LM_GENERATES
            and counts["flash_attention_fwd"] == per_generate * LM_GENERATES,
            f"{what}: {seen['prefill_launches']} attention launches in the prefills of "
            f"{LM_GENERATES} generates and {counts['flash_attention_fwd']} in all, expected "
            f"{per_generate} a prefill and none in a decode step")
    add_launches(launches, counts)
    require(tuple(outs[0].shape) == (b, new) and
            bool(((outs[0] >= 0) & (outs[0] < cfg.vocab)).all()),
            f"{what}: tokens {tuple(outs[0].shape)} out of shape or range")
    require(torch.equal(outs[0], outs[1]), f"{what}: two generates differ in "
                                           f"{int((outs[0] != outs[1]).sum())} tokens")
    require(bool(torch.isfinite(seen["prefill_logits"]).all()) and
            bool(torch.isfinite(seen["decode_logits"]).all()), f"{what}: logits not finite")
    require(seen["decode_pos"][0] == s + prefix and seen["cache_shapes"]["k"][2] ==
            s + prefix + new + 1, f"{what}: the first decode at {seen['decode_pos'][0]}, cache "
                                  f"{seen['cache_shapes']['k']}; expected {s} + prefix {prefix}")
    if is_encdec:
        require(seen["cache_shapes"]["ck"] == (cfg.n_layers, b, cfg.enc_seq, cfg.n_kv_heads,
                                               cfg.hd), f"{what}: cross cache "
                                                        f"{seen['cache_shapes']['ck']}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ttft_ms = statistics.median(seen["prefill_s"][1:]) * 1e3
    dec_ms = statistics.median((g - p) / new * 1e3 for g, p in
                               zip(gen_s[1:], seen["prefill_s"][1:]))
    tok_s = b * new / statistics.median(gen_s[1:])
    enc_ms = (call_ms(torch, lambda: encdec.run_encoder(params, cfg, batch["frames"]), 1, 3)
              if is_encdec else None)
    out = dict(arch=cfg.name, layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
               params=count_params(model.specs), weight_gb=weight_gb, init_s=init_s,
               generate_s=gen_s, prefill_s=seen["prefill_s"], ttft_ms=ttft_ms,
               encoder_ms=enc_ms, decode_ms_per_token=dec_ms, tokens_per_s=tok_s,
               peak_gib=peak_gib, held_before_gib=before_gib, prefix=prefix,
               launches=counts["flash_attention_fwd"])
    shape = (f"{cfg.n_enc_layers} + {cfg.n_layers} of its {cfg.n_enc_layers} + {cfg.n_layers} "
             f"layers" if is_encdec else f"{cfg.n_layers} of its {cfg.n_layers} layers")
    inputs = (f"{cfg.enc_seq} frames a clip" if is_encdec else
              f"an image of {prefix} patch embeddings a row ({run['grid'][0]} x "
              f"{run['grid'][1]}), M-RoPE {cfg.mrope_sections}")
    print(f"xd serve: {cfg.name} at {shape} ({out['params']} parameters, {weight_gb:.2f} GB, "
          f"drawn in {init_s:.1f} s; d {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} of {cfg.hd}, bf16), batch {b} x prompt {s} x {new} new, "
          f"{inputs}, greedy, the warm generate: prefill (time to first token) {ttft_ms:.3f} ms"
          f"{f' (the encoder alone, CUDA events: {enc_ms:.3f} ms)' if is_encdec else ''}, decode "
          f"{dec_ms:.3f} ms/token, generate {gen_s[0]:.3f} s cold / "
          f"{statistics.median(gen_s[1:]):.3f} s warm ({tok_s:.1f} generated tokens/s), peak "
          f"memory {peak_gib:.2f} GiB ({before_gib:.2f} held before the draw)", flush=True)
    del seen

    f64 = xd_layer_vs_f64(torch, params, cfg, batch)
    for name, row in f64.items():
        require(row["kernel_rel"] <= FLASH_BF16_VS_TWIN * row["twin_rel"],
                f"{what}: {name}'s block (bf16) off f64 by {row['kernel_rel']} of max |f64|, "
                f"more than {FLASH_BF16_VS_TWIN}x the twin's {row['twin_rel']}")
        require(row["conditioned_rel"] <= XD_BF16_REL,
                f"{what}: {name}'s block with its attention at fan-in over its contraction "
                f"off f64 by {row['conditioned_rel']} of max |f64| > {XD_BF16_REL}")
    out["layer0_vs_f64"] = f64
    if profile:
        out["profile prefill"] = profile_calls(torch, f"xd {arch} prefill bf16", [
            lambda: model.prefill_fn(params, batch)], share_of="flash_fwd")
        _, cache = model.prefill_fn(params, batch, pad_to=s + prefix + new + 1)
        tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        out["profile decode"] = profile_calls(torch, f"xd {arch} decode step bf16", [
            lambda i=i: model.decode_fn(params, cache, tok, s + prefix + i) for i in range(4)])
        del cache
    print(f"xd checks {arch}: {out['launches']} attention launches in {LM_GENERATES} generates "
          f"({per_generate} each, D = {cfg.hd}, none in a decode step), nothing else launched; "
          f"two generates bit-identical; the first decode at prompt + prefix = {s + prefix}; "
          + "; ".join(f"{name}'s block (bf16) vs f64: kernel {r['kernel_rel']:.3g}, twin "
                      f"{r['twin_rel']:.3g} of max |f64| {r['f64_max']:.4g} (kernel <= "
                      f"{FLASH_BF16_VS_TWIN}x twin), with its attention at fan-in over its "
                      f"contraction {r['conditioned_rel']:.3g} of {r['conditioned_f64_max']:.4g} "
                      f"(bound {XD_BF16_REL})" for name, r in f64.items()), flush=True)
    del params, batch, eng
    torch.cuda.empty_cache()
    return out


def xd_request(torch, cfg, gen, n: int, grid=None) -> dict:
    """One B = 1 request of ``n`` tokens with its own unit-scale stub frames
    (Whisper) or image of ``grid`` patch embeddings and its default M-RoPE
    positions (Qwen2-VL), drawn from ``gen``."""
    from repro_torch.models import vlm

    dev = "cuda"
    req = {"tokens": torch.randint(0, cfg.vocab, (1, n), device=dev, dtype=torch.int32,
                                   generator=gen)}
    if cfg.kind == "encdec":
        req["frames"] = torch.randn((1, cfg.enc_seq, cfg.d_model), device=dev, generator=gen,
                                    dtype=cfg.dtype)
    else:
        sv = grid[0] * grid[1]
        req["patch_embeds"] = torch.randn((1, sv, cfg.d_model), device=dev, generator=gen,
                                          dtype=cfg.dtype)
        req["positions"] = vlm.default_positions(1, sv, n, grid, device=dev)
    return req


def xd_small(torch, arch: str) -> dict:
    """Gates at XD_SMALL's 2 layers (Whisper 2 + 2) in f32 with every
    attention at fan-in over its contraction: decode(prefill(x), t) against
    prefill(x ‖ t) at each of XD_SMALL's steps within XD_SMALL["tol"] (the
    first decode at prompt + prefix); the ContinuousEngine's completions at
    4 slots == static B = 1 generates, greedy, each request with its own
    frames or image (two grids, so two prefix lengths: ``max_prefix``),
    slots reused; and no aten op on a CPU tensor in a prefill and a decode.
    Launches here are not counted."""
    from repro_torch.models import get_model, init_params
    from repro_torch.models import vlm
    from repro_torch.serving import ContinuousEngine, Engine, Scheduler, ServeConfig

    dev = "cuda"
    sm = XD_SMALL
    cfg = xd_cfg(arch, sm["layers"], torch.float32)
    model = get_model(cfg)
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(SEED + 4), dev)
    xd_condition(params, cfg)
    n, steps, bsz = sm["prompt_len"], sm["steps"], sm["batch"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = [xd_request(torch, cfg, gen, n + steps, sm["grids"][0]) for _ in range(bsz)]
    full = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    prefix = full["patch_embeds"].shape[1] if "patch_embeds" in full else 0

    def upto(m):            # the batch at its first m text tokens
        out = dict(full, tokens=full["tokens"][:, :m])
        if "positions" in out:
            out["positions"] = full["positions"][:, :prefix + m]
        return out

    watch = cpu_op_watch(torch)
    with watch:
        _, cache = model.prefill_fn(params, upto(n), pad_to=prefix + n + steps + 1)
        lg, cache = model.decode_fn(params, cache, full["tokens"][:, n], prefix + n)
    require(not watch.cpu_ops and all(t.is_cuda for t in cache.values()) and lg.is_cuda,
            f"xd {arch}: ops on CPU tensors in a prefill and a decode: "
            f"{sorted(set(watch.cpu_ops))[:8]}")
    errs = []
    for i in range(steps):
        if i:
            lg, cache = model.decode_fn(params, cache, full["tokens"][:, n + i], prefix + n + i)
        whole, _ = model.prefill_fn(params, upto(n + i + 1))
        errs.append(float((lg - whole).abs().max()))
    require(max(errs) < sm["tol"], f"xd {arch}: decode(prefill(x), t) vs prefill(x + t) "
                                   f"differ by {max(errs)} (bound {sm['tol']})")
    del cache
    # continuous == static, slots reused, each request its own frames or image
    lengths = [sm["lengths"][i % len(sm["lengths"])] for i in range(sm["requests"])]
    grids = [sm["grids"][i % len(sm["grids"])] for i in range(sm["requests"])]
    reqs = [xd_request(torch, cfg, gen, m, g) for m, g in zip(lengths, grids)]
    max_prefix = 0 if cfg.kind == "encdec" else max(g[0] * g[1] for g in grids)
    scfg = ServeConfig(max_new=sm["max_new"])
    eng = ContinuousEngine(model, scfg, num_slots=sm["slots"], max_prompt_len=max(lengths),
                           max_prefix=max_prefix)
    sched = Scheduler(eng, params)
    rids = [sched.submit(r["tokens"][0], extras={k: v for k, v in r.items() if k != "tokens"})
            for r in reqs]
    sched.run(timeout=600)
    same = 0
    for rid, r in zip(rids, reqs):
        want = Engine(model, scfg).generate(params, r)[0]
        same += sched.poll(rid).tokens == want.tolist()
    require(same == len(reqs), f"xd {arch}: {same} of {len(reqs)} continuous completions == "
                               f"their static B = 1 generate")
    out = dict(layers=cfg.n_layers, step_errs=errs, cont_equal=same, requests=len(reqs),
               cont_steps=sched.steps, prefix=prefix, max_prefix=max_prefix,
               cpu_ops=len(watch.cpu_ops), cpu_scalar_ops=sorted(set(watch.cpu_scalars)))
    print(f"xd small {cfg.name} ({cfg.n_layers} layers, f32, attention at fan-in over its "
          f"contraction): decode(prefill(x), t) vs prefill(x + t), {steps} steps from prompt "
          f"{n} + prefix {prefix}, worst max |diff| {max(errs):.3g} (bound {sm['tol']}); "
          f"continuous, {sm['slots']} slots{f', max_prefix {max_prefix}' if max_prefix else ''}: "
          f"{same} of {len(reqs)} completions == their static B = 1 generate ({sched.steps} "
          f"steps); aten ops on CPU tensors in a prefill and a decode: {len(watch.cpu_ops)} (on "
          f"CPU scalars: {len(watch.cpu_scalars)})", flush=True)
    del params, eng, sched, reqs, rows, full
    torch.cuda.empty_cache()
    return out


def phase_xd(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 22: the enc-dec and VLM decoders at their published widths and
    depths (XD_RUNS), one model on the card at a time, then XD_SMALL's f32
    gates of each."""
    out = {}
    for arch in XD_RUNS:
        out[arch] = xd_serve(torch, arch, launches, profile)
    for arch in XD_RUNS:
        out[f"{arch} small"] = xd_small(torch, arch)
    return out


# ---------------------------------------------------------------------------
# phase 23: training of the MoE, SSM and hybrid decoders
# ---------------------------------------------------------------------------

def nt_cfg(run: dict):
    """A run of NT_RUNS (or NR_RUNS) as a config: the MoE decoders cut to
    ``layers`` (and ``experts`` routed experts), the enc-dec and VLM ones as
    `xd_cfg` cuts them, the SSM and hybrid ones as `ssm_cfg` does or, with
    ``groups``, the hybrid cut to whole groups of its published
    shared_attn_every Mamba-2 layers; bf16, remat on, as published."""
    import dataclasses

    if run["arch"] in dict(MOE_RUNS):
        changes = {"n_experts": run["experts"]} if "experts" in run else {}
        return moe_cfg(run["arch"], run["layers"], **changes)
    if run["arch"] in XD_RUNS:
        return xd_cfg(run["arch"], run["layers"])
    if "groups" in run:
        cfg = ssm_cfg(run["arch"])
        return dataclasses.replace(cfg, n_layers=run["groups"] * cfg.shared_attn_every)
    return ssm_cfg(run["arch"], run["layers"])


def nt_attention_calls(cfg) -> tuple[int, tuple[int, int]]:
    """(attention calls a forward, (forward, backward) attention launches a
    training step): remat recomputes each checkpointed layer's attention
    once more (the MoE and VLM stacks, Whisper's encoder and decoder layers,
    the latter two calls each); the hybrid's shared block runs outside
    remat; the SSM has none."""
    if cfg.kind == "encdec":
        calls = cfg.n_enc_layers + 2 * cfg.n_layers
    elif cfg.shared_attn_every:
        calls = cfg.n_layers // cfg.shared_attn_every
        return calls, (calls, calls)
    elif cfg.ssm is not None:
        return 0, (0, 0)
    else:
        calls = cfg.n_layers
    return calls, ((2 if cfg.remat else 1) * calls, calls)


def nt_pipe(torch, cfg, run: dict):
    """The run's batches: SyntheticLM's tokens (B x ``seq``, NT_SEQ by
    default) and, for Whisper, B stub frames of enc_seq a row (unit scale,
    as `xd_request` draws them) or, for Qwen2-VL, B images of ``grid``
    patch embeddings with their default M-RoPE positions; a step's extras
    drawn from a generator seeded by the step, so every rank draws the
    same batch."""
    import types

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import vlm

    b, n = run["batch"], run.get("seq", NT_SEQ)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=n, global_batch=b), device="cuda")
    if cfg.kind not in ("encdec", "vlm"):
        return pipe

    def batch(step: int) -> dict:
        out = dict(pipe.batch(step))
        gen = cuda_gen(torch, SEED + 4000 + step)
        if cfg.kind == "encdec":
            out["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), device="cuda",
                                        generator=gen, dtype=cfg.dtype)
        else:
            sv = run["grid"][0] * run["grid"][1]
            out["patch_embeds"] = torch.randn((b, sv, cfg.d_model), device="cuda",
                                              generator=gen, dtype=cfg.dtype)
            out["positions"] = vlm.default_positions(b, sv, n, run["grid"], device="cuda")
        return out

    return types.SimpleNamespace(batch=batch)


def nt_condition(params: dict, cfg) -> dict:
    """The attention projections at fan-in over their contraction (phase
    16's rule), in place: every set of the enc-dec and VLM, the MoE stack's,
    the hybrid's shared block's; the SSM has none."""
    if cfg.kind in ("encdec", "vlm"):
        return xd_condition(params, cfg)
    if cfg.moe is not None:
        return fan_in_over_contraction(params, cfg)
    if cfg.shared_attn_every:
        fan_in_over_contraction({"blocks": {"attn": params["shared"]["attn"]}}, cfg)
    return params


def nt_flops(cfg, params: dict, active: int, b: int, n: int, sv: int, calls: int) -> float:
    """A training step's model FLOPs: `step_model_flops` for the MoE, SSM and
    hybrid; for Whisper 6 x parameters x the tokens they see (the encoder's
    B x enc_seq frames, the decoder's and the tied head's B x n tokens) plus
    each attention's 12 * B * H * pairs * D; for Qwen2-VL the stack over the
    B x (sv + n) positions and the head over the n text ones."""
    from repro_torch.tree import tree_leaves

    def size(tree):
        return sum(x.numel() for x in tree_leaves(tree))

    if cfg.kind == "encdec":
        t = cfg.enc_seq
        flops = 6 * b * (size(params["enc_blocks"]) * t
                         + (size(params["dec_blocks"]) + cfg.vocab * cfg.d_model) * n)
        pairs = (cfg.n_enc_layers * attention_pairs(t, t, False, -1, 0) + cfg.n_layers
                 * (attention_pairs(n, n, True, -1, 0) + attention_pairs(n, t, False, -1, 0)))
    elif cfg.kind == "vlm":
        s = sv + n
        flops = 6 * b * (size(params["blocks"]) * s + size(params["lm_head"]) * n)
        pairs = cfg.n_layers * attention_pairs(s, s, True, -1, 0)
    else:
        return step_model_flops(cfg, active, b, n, attn_calls=calls)
    return flops + 12 * b * cfg.n_heads * cfg.hd * pairs


def nt_active_params(cfg, n_params: int) -> int:
    """The parameters a token's forward multiplies by: all of them but, in
    an MoE, the routed experts it is not sent to (top-k of E; the shared
    expert counted)."""
    if cfg.moe is None:
        return n_params
    m = cfg.moe
    routed = 3 * cfg.n_layers * m.n_experts * cfg.d_model * m.d_expert
    return n_params - routed + routed * m.top_k // m.n_experts


def nt_mamba_layer_peak(torch) -> dict:
    """One Mamba-1 layer at Falcon-Mamba-7B's width in bf16, under
    torch.utils.checkpoint as the model runs it with remat, forward and
    backward at B 1 x S NT_SEQ: the peak device memory above its weights
    and input (its gradients, the recomputed forward's saved tensors and
    the scan's backward), which sizes Falcon-Mamba's cut (NT_FALCON)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import init_params, mamba

    dev = "cuda"
    cfg = ssm_cfg("falcon-mamba-7b")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    p = init_params(mamba.mamba1_specs(cfg, layers=0), gen, dev)
    for t in p.values():
        t.requires_grad_()
    x = torch.randn(1, NT_SEQ, cfg.d_model, generator=gen, device=dev).to(cfg.dtype)
    x.requires_grad_()
    ct = torch.randn(x.shape, generator=gen, device=dev).to(cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = checkpoint(lambda p, x: mamba.mamba1_block(p, cfg, x)[0], p, x, use_reentrant=False,
                     preserve_rng_state=False)
    out.backward(ct)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    weights = sum(t.numel() * t.element_size() for t in p.values())
    require(all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in p.values()),
            "nt falcon-mamba-7b probe: a layer gradient is missing or not finite")
    print(f"nt falcon-mamba-7b probe: one Mamba-1 layer (d {cfg.d_model}, d_inner "
          f"{cfg.ssm.expand * cfg.d_model}, state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}, "
          f"bf16, remat) forward + backward at B 1 x S {NT_SEQ}: peak {peak / 2**30:.3f} GiB "
          f"above its {weights / 2**30:.3f} GiB of weights and its input, {sec * 1e3:.1f} ms "
          f"(first call); {card_line()}", flush=True)
    del p, x, ct, out
    torch.cuda.empty_cache()
    return dict(peak_above_weights=peak, weights=weights, seconds=sec)


def nt_grad_gate(torch, arch: str) -> dict:
    """The f32 gradient gate (NT_GRAD) of an SSM or hybrid decoder: layer 0's
    block at 2 layers in f32 on its own input (the embedded tokens), the
    gradient of sum(block(x) * ct) with respect to x and to every leaf of
    the block (the hybrid's group 0: the shared attention and MLP, its two
    norm gains, then its Mamba-2 layer; the attention through the f32
    forward and backward kernels at D = 80), against the same block in f64
    (`xd_block_f64` with RoPE for the shared block, `ssm_block_f64` with the
    sequential recurrence): each within NT_GRAD["rel"] of its largest
    entry."""
    import dataclasses

    from repro_torch import kernels as tk
    from repro_torch.models import get_model, hybrid, init_params, mamba
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.tree import tree_flatten, tree_unflatten

    g, dev = NT_GRAD, "cuda"
    cfg = ssm_cfg(arch, g["layers"], torch.float32)
    params = init_params(get_model(cfg).specs, torch.Generator(device=dev).manual_seed(SEED + 7),
                         dev)
    hyb = bool(cfg.shared_attn_every)
    if hyb:
        fan_in_over_contraction({"blocks": {"attn": params["shared"]["attn"]}}, cfg)
        grp, sh = params["groups"], params["shared"]
        block = {"attn": sh["attn"], "mlp": sh["mlp"], "ln1": grp["ln1"][0],
                 "ln2": grp["ln2"][0], "mamba": hybrid._mamba_layer(grp, 0, 0)}
    else:
        block = {"mamba": {k: v[0] for k, v in params["blocks"].items()}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    b, n = g["batch"], g["seq"]
    toks = torch.randint(0, cfg.vocab, (b, n), device=dev, dtype=torch.int32, generator=gen)
    x = embed_tokens(params, cfg, toks)
    ct = torch.randn(x.shape, generator=gen, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(b, n)
    # the shared block's RoPE as M-RoPE of one position stream
    rope_cfg = dataclasses.replace(cfg, mrope_sections=(cfg.hd // 2,)) if hyb else None
    paths = [p for p, _ in tree_flatten(block)]

    def port(t, xs):
        if hyb:
            xs = hybrid._shared_attn_train(t, t["ln1"], t["ln2"], cfg, xs, pos)[0]
            return mamba.mamba2_block(t["mamba"], cfg, xs)[0]
        return mamba.mamba1_block(t["mamba"], cfg, xs)[0]

    def exact(t, xs):
        if hyb:
            xs = xd_block_f64(torch, t, rope_cfg, xs, positions=pos[..., None])
        return ssm_block_f64(torch, t["mamba"], cfg, xs)[0]

    def grads(fn, dtype):
        xs = x.detach().to(dtype).requires_grad_()
        leaves = [t.detach().to(dtype).requires_grad_() for _, t in tree_flatten(block)]
        out = fn(tree_unflatten(block, leaves), xs)
        return torch.autograd.grad((out * ct.to(dtype)).sum(), [xs] + leaves)

    tk.reset_launch_counts()
    got = grads(port, torch.float32)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    want = grads(exact, torch.float64)
    rel = {}
    for name, a, e in zip(["x"] + ["/".join(map(str, p)) for p in paths], got, want):
        scale = float(e.abs().max())
        require(scale > 0 and bool(torch.isfinite(a).all()),
                f"nt grad {arch}: the f64 gradient of {name} is zero or the f32 one not finite")
        rel[name] = float((a.double() - e).abs().max()) / scale
    worst = max(rel, key=rel.get)
    require(rel[worst] <= g["rel"], f"nt grad {arch}: layer 0's block gradient of {worst} "
                                    f"{rel[worst]:.3g} of its largest entry off f64 (bound "
                                    f"{g['rel']}): {rel}")
    if hyb:   # the f32 attention kernels at D = 80 ran, forward and backward
        require(counts["flash_attention_fwd"] == 1 and counts["flash_attention_bwd"] == 1,
                f"nt grad {arch}: attention launches {counts}, expected one of each")
    print(f"nt grad {cfg.name} ({g['layers']} layers, f32, B {b} x S {n}): layer 0's block"
          f"{' (shared attention at D = ' + str(cfg.hd) + ' + Mamba-2)' if hyb else ''} "
          f"gradient vs f64 with the sequential recurrence, {len(rel)} tensors (x and every "
          f"leaf): worst {worst} {rel[worst]:.3g} of its largest entry (bound {g['rel']}); x "
          f"{rel['x']:.3g}", flush=True)
    del params, block, got, want
    torch.cuda.empty_cache()
    return dict(rel=rel, worst=worst, launches=counts)


def nt_train(torch, run: dict, launches: dict) -> dict:
    """One run of NT_RUNS: TRAIN["steps"] AdamW steps at NT_OPT through
    `build_train_fns`, the attention projections at fan-in over their
    contraction, gated as phase 23 says; then the model is freed."""
    from repro_torch.models import count_params, get_model
    from repro_torch.train.loop import build_train_fns
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import tree_leaves

    t, dev = TRAIN, "cuda"
    cfg = nt_cfg(run)
    model = get_model(cfg)
    b, n = run["batch"], run.get("seq", NT_SEQ)
    sv = run["grid"][0] * run["grid"][1] if "grid" in run else 0
    moe = cfg.moe is not None
    calls, per_step = nt_attention_calls(cfg)
    what = f"nt {cfg.name}"
    fns = build_train_fns(model, OptConfig(**NT_OPT), device=dev)
    pipe = nt_pipe(torch, cfg, run)
    n_params = count_params(model.specs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state = fns.init(SEED)
    nt_condition(params, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    auxes = []
    params, opt_state, losses, gnorms, step_s, seen = train_steps(
        torch, fns, pipe, params, opt_state, t["steps"], cfg, what, launches, record=True,
        per_step=per_step, auxes=auxes)
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses), f"{what}: a loss is not finite: {losses}")
    require(losses[-1] <= losses[0] - t["min_drop"],
            f"{what}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, fell by less than "
            f"{t['min_drop']}: {losses}")
    router = None
    if moe:
        require(all(math.isfinite(a) and a > 0 for a in auxes),
                f"{what}: an aux loss is not finite and positive: {auxes}")
        router = float(opt_state["m"]["blocks"]["mlp"]["router"].abs().max())
        require(router > 0, f"{what}: the router's gradient is zero (its AdamW moment is)")
    rows = []
    for inputs, got, kw in seen:
        row = bwd_vs_twin(torch, inputs, got, kw)
        require(row.pop("ok"), f"{what}: a backward kernel call off its twin: {row}")
        rows.append(row)
    require(len(rows) == calls, f"{what}: {len(rows)} backward calls captured, expected {calls}")
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params) + tree_leaves(
        opt_state["m"]) + tree_leaves(opt_state["v"]))
    active = nt_active_params(cfg, n_params)
    flops = nt_flops(cfg, params, active, b, n, sv, calls)
    del seen, params, opt_state, fns
    torch.cuda.empty_cache()
    ms = statistics.median(step_s[2:]) * 1e3
    card = card_line()
    tokens = b * (n + sv)
    out = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params, active_params=active,
               batch=b, seq=n, prefix=sv, losses=losses, gnorms=gnorms, aux=auxes,
               router_moment=router,
               init_s=init_s, step_s=step_s, ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
               max_memory_allocated=peak, params_and_moments_bytes=state_bytes,
               model_flops=flops, mfu_bf16=flops / (ms / 1e3) / BF16_FLOPS_PER_S,
               launches_per_step=per_step, layer_bwd=rows, card=card)
    experts = f", {cfg.moe.n_experts} routed experts" if moe else ""
    shape = (f"batch {b} x seq {n}" + (f" over {cfg.enc_seq} frames" if cfg.kind == "encdec"
                                       else "") + (f" after {sv} patches" if sv else ""))
    layers = (f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.kind == "encdec"
              else str(cfg.n_layers))
    print(f"nt train {cfg.name} ({layers} layers{experts}, {n_params} parameters, "
          f"d {cfg.d_model}, bf16, remat), {shape}, {t['steps']} AdamW steps: loss "
          + " ".join(f"{x:.4f}" for x in losses) + ", gradient norm "
          + " ".join(f"{x:.3g}" for x in gnorms)
          + ("" if not moe else ", aux " + " ".join(f"{x:.4g}" for x in auxes)), flush=True)
    print(f"nt train {cfg.name}: {ms:.2f} ms a step (median of steps 3-{t['steps']}, host "
          f"clock; first {step_s[0] * 1e3:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, peak "
          f"memory {peak / 2**30:.2f} GiB (parameters + AdamW moments "
          f"{state_bytes / 2**30:.2f} GiB), model FLOPs {flops:.4g} a step on {active} active "
          f"parameters = {out['mfu_bf16']:.4f} of the bf16 peak (989 TFLOP/s); {card}",
          flush=True)
    if "grid" in run:
        out["cut"] = nt_cut_line(torch, cfg, peak, state_bytes)
    worst = max((r["kernel_vs_f64"][i] / r["twin_vs_f64"][i] for r in rows for i in range(3)
                 if r["twin_vs_f64"][i] > 0), default=float("nan"))
    print(f"nt checks {cfg.name}: losses finite, fell {losses[0] - losses[-1]:.4f} >= "
          f"{t['min_drop']}; {per_step[0]} forward and {per_step[1]} backward attention "
          f"launches every step, no other kernel"
          + (f"; every backward call within its twin's bound on the first step's own inputs "
             f"(D = {cfg.hd}; worst kernel/twin error vs f64 {worst:.4f})" if rows else "")
          + ("" if not moe else f"; aux finite and positive, router moment {router:.3g}"),
          flush=True)
    return out


def nt_cut_line(torch, cfg, peak: int, state_bytes: int) -> dict:
    """Qwen2-VL-7B's cut, probed by its own run: the peak above the
    parameters and moments (activations, AdamW's temporaries) added to the
    state of 2 more layers and of the whole model (12 bytes a parameter,
    `count_params`) against the card's memory."""
    import dataclasses

    from repro_torch.models import count_params, get_model

    total = torch.cuda.get_device_properties(0).total_memory
    above = peak - state_bytes
    rows = {}
    for layers in (cfg.n_layers + 2, xd_cfg(cfg.name).n_layers):
        c = dataclasses.replace(cfg, n_layers=layers)
        state = 12 * count_params(get_model(c).specs)
        rows[layers] = dict(state=state, peak=state + above, fits=state + above < total)
    require(peak < total, f"nt {cfg.name}: peak {peak} B over the card's {total}")
    print(f"nt cut {cfg.name}: {cfg.n_layers} layers peak {peak / 2**30:.2f} GiB, "
          f"{above / 2**30:.2f} above its {state_bytes / 2**30:.2f} GiB of parameters and "
          f"moments; with that overhead " + ", ".join(
              f"{k} layers need ~{v['peak'] / 2**30:.1f} GiB ({v['state'] / 2**30:.1f} of state; "
              f"{'fits' if v['fits'] else 'does not fit'})" for k, v in rows.items())
          + f" on the card's {total / 2**30:.1f} GiB", flush=True)
    return dict(peak=peak, above_state=above, card_bytes=total,
                **{f"{k}_layers": v for k, v in rows.items()})


def phase_nondense_train(torch, launches: dict) -> dict:
    """Phase 23: Falcon-Mamba's layer probe, then NT_RUNS one model at a
    time (the MoE, hybrid, SSM, enc-dec and VLM decoders), each SSM-family
    run followed by its f32 gradient gate."""
    print(f"nt: {card_line()}", flush=True)
    out = {"falcon_layer_probe": nt_mamba_layer_peak(torch)}
    for run in NT_RUNS:
        res = nt_train(torch, run, launches)
        if run["arch"] in SSM_RUNS:
            res["grad_gate"] = nt_grad_gate(torch, run["arch"])
        out[run["arch"]] = res
    return out


# ---------------------------------------------------------------------------
# phase 24: training of every non-dense family across ranks
# ---------------------------------------------------------------------------

def nr_label(run: dict) -> str:
    cut = (f"{run['groups']} group" if "groups" in run else
           "whole" if run.get("layers") is None else f"{run['layers']} layers")
    return f"{run['arch']} ({cut})"


def nr_train(torch, mesh, run: dict) -> dict:
    """NR["steps"] AdamW steps of ``run`` on this rank's shards (``mesh``
    None: one rank): the global losses and gradient norms, host seconds a
    step, each step's launches and wire bytes (the counters set to 0 just
    before and read just after), the peak device memory, the bytes held
    beside those of the resolved shards, and (MoE) step 1's layer-0
    routing."""
    from repro_torch import kernels as tk
    from repro_torch.distributed import collectives, sharding
    from repro_torch.models import get_model, init_params, moe
    from repro_torch.train.loop import build_train_fns
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import tree_leaves

    cfg = nt_cfg(run)
    model = get_model(cfg)
    fns = build_train_fns(model, OptConfig(**NT_OPT), mesh=mesh, device="cuda")
    whole = nt_condition(init_params(model.specs, cuda_gen(torch, SEED), "cuda"), cfg)
    params, state = fns.shard_params(whole)
    del whole
    torch.cuda.empty_cache()
    held = sum(x.numel() * x.element_size() for x in tree_leaves((params, state)))
    resolved = sharding.local_bytes(fns.placements, (params, state), fns.mesh)
    pipe = nt_pipe(torch, cfg, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(losses=[], gnorms=[], aux=[], step_s=[], counts=[], wire=[], routing=None)
    route = moe.route

    def first_route(*a, **kw):               # step 1's first call: layer 0's forward
        r = route(*a, **kw)
        if out["routing"] is None:         # numpy: a rank's result crosses a queue
            out["routing"] = r.idx.detach().cpu().numpy()
        return r

    for step in range(NR["steps"]):
        batch = pipe.batch(step)
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        collectives.reset_wire_bytes()
        moe.route = first_route if step == 0 else route
        t0 = time.perf_counter()
        try:
            params, state, m = fns.step(params, state, batch, None)
        finally:
            moe.route = route
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["gnorm"]))
        out["aux"].append(float(m["aux"]))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["counts"].append(tk.launch_counts())
        out["wire"].append(collectives.wire_bytes())
    out.update(peak=torch.cuda.max_memory_allocated(), held=held, resolved=resolved)
    del params, state, fns
    torch.cuda.empty_cache()
    return out


def nr_rank(mesh, runs: tuple) -> dict:
    """What each rank of a phase-24 grid runs on cuda:0: its runs in
    order."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"coords": (mesh.index("data"), mesh.index("model"))}
    for run in runs:
        out[nr_label(run)] = nr_train(torch, mesh, run)
    return out


def nr_flips(torch, a, b) -> int:
    """(token, expert) assignments in one top-k routing [G, Tg, K] (numpy)
    and not in the other."""
    e = int(max(a.max(), b.max())) + 1
    oh = [torch.nn.functional.one_hot(torch.from_numpy(x), e).sum(-2) for x in (a, b)]
    return int((oh[0] - oh[1]).clamp_min(0).sum())


def phase_nondense_ranks(torch, launches: dict) -> dict:
    """Phase 24: one rank's steps of every run of NR_RUNS on the same
    parameters and batches (this process; not counted), then each grid's
    ranks (gloo, all on cuda:0) train its runs, gated as NR_RUNS says."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as tmesh

    print(f"nr: {card_line()}", flush=True)
    ref = {}
    for runs in NR_RUNS.values():
        for run in runs:
            ref[nr_label(run)] = nr_train(torch, None, run)
    _build.build()             # the ranks load the library built here
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    print(f"nr: one rank's runs done; this process keeps {held / 2**30:.2f} GiB of the card "
          "while the ranks run", flush=True)
    out = {"grids": {}, "parent_reserved": held}
    worst = {"loss": 0.0, "gnorm": 0.0}
    for grid, runs in NR_RUNS.items():
        label = f"{grid[0]}x{grid[1]}"
        t0 = time.perf_counter()
        results = tmesh.spawn(nr_rank, grid, (runs,), timeout=NR["timeout"], threads=None)
        wall = time.perf_counter() - t0
        row = {"wall_s": wall}
        for run in runs:
            name = nr_label(run)
            what = f"nr {label} {name}"
            cfg = nt_cfg(run)
            rs, want = [r[name] for r in results], ref[name]
            losses = rs[0]["losses"]
            require(all(r["losses"] == losses for r in rs),
                    f"{what}: the ranks report different losses: {[r['losses'] for r in rs]}")
            require(all(math.isfinite(x) for x in losses), f"{what}: a loss is not finite")
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
            gn_rel = abs(rs[0]["gnorms"][0] - want["gnorms"][0]) / want["gnorms"][0]
            worst["loss"], worst["gnorm"] = max(worst["loss"], *rel), max(worst["gnorm"], gn_rel)
            flips = (None if want["routing"] is None else
                     nr_flips(torch, want["routing"], rs[0]["routing"]))
            print(f"{what}: loss against one rank's, relative, step by step: "
                  + " ".join(f"{x:.3g}" for x in rel) + f"; step-1 gradient norm "
                  f"{rs[0]['gnorms'][0]:.6g} vs {want['gnorms'][0]:.6g}, relative {gn_rel:.3g}"
                  + ("" if flips is None else
                     f"; step 1 layer 0 routes {flips} of {want['routing'].size} (token, "
                     f"expert) assignments otherwise than one rank"), flush=True)
            bound = [NR["loss_rtol"]] + [NR["moe_loss_rtol"] if flips else NR["loss_rtol"]] * (
                len(rel) - 1)
            require(all(x <= b for x, b in zip(rel, bound)),
                    f"{what}: losses {losses} vs one rank {want['losses']} (relative "
                    + " ".join(f"{x:.3g}" for x in rel) + f" over bounds {bound})")
            require(gn_rel <= NR["gnorm_rtol"][label], f"{what}: step-1 gradient norm relative "
                                                       f"{gn_rel:.3g} > {NR['gnorm_rtol'][label]}")
            per_step = nt_attention_calls(cfg)[1]
            for r in rs:
                require(r["held"] == r["resolved"],
                        f"{what}: a rank holds {r['held']} B of parameters and optimizer "
                        f"state, its resolved shards {r['resolved']} B")
                for step, counts in enumerate(r["counts"]):
                    train_launches(counts, cfg, 1, f"{what} step {step}", per_step)
                    add_launches(launches, counts)
            ms = statistics.median(rs[0]["step_s"][1:]) * 1e3
            sv = run["grid"][0] * run["grid"][1] if "grid" in run else 0
            tokens = run["batch"] * (run.get("seq", NT_SEQ) + sv)
            res = dict(losses=losses, gnorms=rs[0]["gnorms"], aux=rs[0]["aux"],
                       one_rank={k: want[k] for k in ("losses", "gnorms", "aux", "step_s",
                                                      "peak")},
                       loss_rel=rel, loss_bound=bound, gnorm_rel=gn_rel, routing_flips=flips,
                       ms_per_step=ms,
                       step_s=rs[0]["step_s"], tokens_per_s=tokens / ms * 1e3,
                       one_rank_ms=statistics.median(want["step_s"][1:]) * 1e3,
                       peak=[r["peak"] for r in rs], held=[r["held"] for r in rs],
                       wire=[statistics.median(r["wire"]) for r in rs],
                       launches_per_step=per_step)
            row[name] = res
            print(f"{what}: {cfg.name} (bf16, remat), batch {run['batch']} x seq "
                  f"{run.get('seq', NT_SEQ)}" + (f" after {sv} patches" if sv else "")
                  + f", {NR['steps']} AdamW steps: loss " + " ".join(f"{x:.4f}" for x in losses)
                  + "; one rank " + " ".join(f"{x:.4f}" for x in want["losses"])
                  + f"; rank 0 {ms:.1f} ms a step (median of steps 2-{NR['steps']}, host "
                  f"clock; one rank {res['one_rank_ms']:.1f}), {res['tokens_per_s']:.0f} "
                  f"tokens/s; peak memory a rank " + ", ".join(
                      f"{p / 2**30:.2f}" for p in res["peak"]) + " GiB (one rank "
                  f"{want['peak'] / 2**30:.2f}); parameters + optimizer a rank " + ", ".join(
                      f"{h:,}" for h in res["held"]) + " B (== the resolved shards); wire "
                  "bytes a step a rank " + ", ".join(f"{int(w):,}" for w in res["wire"])
                  + f"; {per_step[0]} forward and {per_step[1]} backward attention launches "
                  "every step on every rank", flush=True)
        out["grids"][label] = row
        print(f"nr {label}: {len(results)} ranks over gloo on cuda:0, {wall:.1f} s with the "
              "ranks' start", flush=True)
    out["worst"] = worst
    print(f"nr checks: every run's ranks report one loss, finite; every step's loss within "
          f"{NR['loss_rtol']} of one rank's on the same parameters and batches, steps 2-"
          f"{NR['steps']} of a run whose step 1 routes otherwise within {NR['moe_loss_rtol']} "
          f"(worst {worst['loss']:.3g}), and the step-1 gradient norm within "
          + ", ".join(f"{v} on {k}" for k, v in NR["gnorm_rtol"].items())
          + f" (worst {worst['gnorm']:.3g}); every rank holds exactly its resolved shards' "
          "bytes; every step on every rank launches the attention kernels its config counts "
          "and no other kernel of the table", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 26: sharded inference on ranks
# ---------------------------------------------------------------------------

def ni_cfg(run: dict):
    """A run of NI_RUNS as a config: the MoE decoders cut as `moe_cfg` cuts
    them, the others as `xd_cfg` / `ssm_cfg` do (uncut without ``layers``);
    bf16, as published."""
    from repro_torch import configs

    if run["arch"] in dict(MOE_RUNS):
        changes = {"n_experts": run["experts"]} if "experts" in run else {}
        return moe_cfg(run["arch"], run["layers"], **changes)
    if run["arch"] in XD_RUNS:
        return xd_cfg(run["arch"], run.get("layers"))
    if run["arch"] in SSM_RUNS:
        return ssm_cfg(run["arch"], run.get("layers"))
    return configs.get_config(run["arch"])


def ni_job(run: dict) -> dict:
    """The dry run's job of a run (`launch.dryrun.run_custom`), without its
    kind and mesh."""
    job = dict(arch=run["arch"], batch=NI["batch"], layers=run.get("layers"),
               experts=run.get("experts"))
    if "grid" in run:
        job["vision"] = run["grid"][0] * run["grid"][1]
    return job


def ni_batch(torch, cfg, run: dict) -> dict:
    """The prompt batch: B x prompt tokens and, for Whisper, B x enc_seq stub
    frames at unit scale, for Qwen2-VL B images of ``grid`` patch embeddings
    with their default M-RoPE positions; drawn from seeded generators in
    bf16 (an f32 run widens the same values), the same on every rank."""
    from repro_torch.models import vlm

    b, n = NI["batch"], run["prompt"]
    out = {"tokens": torch.randint(0, cfg.vocab, (b, n), device="cuda",
                                   generator=cuda_gen(torch, SEED + 5000),
                                   dtype=torch.int32)}
    gen = cuda_gen(torch, SEED + 5001)
    if cfg.kind == "encdec":
        out["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), device="cuda",
                                    generator=gen, dtype=torch.bfloat16).to(cfg.dtype)
    if cfg.kind == "vlm":
        sv = run["grid"][0] * run["grid"][1]
        out["patch_embeds"] = torch.randn((b, sv, cfg.d_model), device="cuda", generator=gen,
                                          dtype=torch.bfloat16).to(cfg.dtype)
        out["positions"] = vlm.default_positions(b, sv, n, run["grid"], device="cuda")
    return out


def ni_condition(params: dict, cfg) -> dict:
    """phase 16's rule on every family: the attention projections at fan-in
    over their contraction (`nt_condition`; the dense decoder's stack as the
    MoE's)."""
    if cfg.moe is None and cfg.ssm is None and cfg.kind not in ("encdec", "vlm"):
        return fan_in_over_contraction(params, cfg)
    return nt_condition(params, cfg)


def ni_infer(torch, mesh, run: dict, tokens=None, one_cache: str | None = None,
             f32: bool = False) -> dict:
    """One run on this rank (``mesh`` None: one rank): the prefill, then
    NI["steps"] decode steps, greedy on one rank, else on ``tokens`` (one
    rank's greedy tokens [steps, B]); ``f32``: the same bf16 parameters
    widened, the model in f32 (the yardstick of bf16's own rounding). Each
    call's host ms, launches, wire
    bytes and peak device memory (the counters and the peak reset just
    before it) and its MoE routing (every route's top-k experts [tokens, K],
    the layers' concatenated), the logits of every step gathered whole
    ([steps + 1, B, V], CPU f32), and, given ``one_cache`` (one rank's
    final cache, saved), each leaf's largest |difference| from its slice
    there over that slice's largest entry (an int leaf: 0 where equal)."""
    from repro_torch import kernels as tk
    from repro_torch.distributed import collectives
    from repro_torch.models import get_model, init_params, moe
    from repro_torch.train.loop import build_infer_fns
    from repro_torch.tree import tree_flatten

    import dataclasses

    from repro_torch.tree import tree_map

    cfg = ni_cfg(run)
    whole = ni_condition(init_params(get_model(cfg).specs, cuda_gen(torch, SEED), "cuda"), cfg)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        whole = tree_map(lambda t: t.float(), whole)
    model = get_model(cfg)
    fns = build_infer_fns(model, mesh=mesh, device="cuda")
    params = fns.shard_params(whole)
    del whole
    torch.cuda.empty_cache()
    batch = ni_batch(torch, cfg, run)
    b = NI["batch"]
    start = run["prompt"] + (run["grid"][0] * run["grid"][1] if "grid" in run else 0)
    out = dict(calls=[], logits=[], argmax=[])
    route, routes = moe.route, []

    def tap(*a, **kw):                     # numpy: a rank's result crosses a queue
        r = route(*a, **kw)
        routes.append(r.idx.reshape(-1, r.idx.shape[-1]).cpu().numpy())
        return r

    def call(fn):
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        collectives.reset_wire_bytes()
        torch.cuda.reset_peak_memory_stats()
        routes.clear()
        moe.route = tap
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            lg, cache = fn()
            torch.cuda.synchronize()
        finally:
            moe.route = route
        out["calls"].append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                 launches=tk.launch_counts(), wire=collectives.wire_bytes(),
                                 peak=torch.cuda.max_memory_allocated(), base=base,
                                 routes=list(routes)))
        lg = fns.gather_logits(lg).float()
        if mesh is not None and lg.shape[0] < b:          # the rows over the data ranks
            lg = collectives.all_gather_dim(lg, 0, mesh.group("data"))
        out["logits"].append(lg.cpu())
        out["argmax"].append(lg.argmax(-1).to(torch.int32))
        return cache

    cache = call(lambda: fns.prefill(params, batch, run["pad_to"]))
    for i in range(NI["steps"]):
        tok = out["argmax"][-1] if tokens is None else torch.from_numpy(tokens[i]).to("cuda")
        cache = call(lambda: fns.decode(params, cache, tok, start + i))
    # numpy: a rank's result crosses a queue
    out["logits"] = torch.stack(out["logits"]).numpy()
    out["argmax"] = torch.stack(out["argmax"]).cpu().numpy()
    if one_cache is not None:
        want = torch.load(one_cache)
        plc = dict(tree_flatten(fns.cache_placements(b, run["pad_to"])))
        err = {}
        for path, x in tree_flatten(cache):
            name = "/".join(path)
            ref = want[name].to("cuda")
            ref = ref[plc[path].slices(fns.mesh)] if fns.mesh is not None else ref
            require(tuple(x.shape) == tuple(ref.shape),
                    f"ni {run['arch']} {name}: piece {tuple(x.shape)} != slice "
                    f"{tuple(ref.shape)}")
            diff = float((x.float() - ref.float()).abs().max())
            err[name] = (0.0 if diff == 0 else float("inf")) if not x.is_floating_point() \
                else diff / max(float(ref.float().abs().max()), 1e-30)
        out["cache_rel"] = err
    else:
        out["cache"] = {"/".join(p): x.cpu() for p, x in tree_flatten(cache)}
    del params, cache, fns
    torch.cuda.empty_cache()
    return out


def ni_rank(mesh, runs: tuple, tokens: dict, caches: dict) -> dict:
    """What each rank of a phase-26 grid runs on cuda:0: every run on one
    rank's greedy tokens, its cache held to one rank's."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"coords": (mesh.index("data"), mesh.index("model"))}
    for run in runs:
        out[run["arch"]] = ni_infer(torch, mesh, run, tokens[run["arch"]], caches[run["arch"]])
    return out


def phase_infer_ranks(torch, launches: dict, tmp: Path) -> dict:
    """Phase 26: one rank's run of every NI_RUNS family (this process, its
    final cache saved under ``tmp``), then each grid of NI_GRIDS (gloo
    ranks, all on cuda:0) runs every family on one rank's greedy tokens,
    gated as NI_RUNS says. Returns every reading, phase 25's among them."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as tmesh

    print(f"ni: {card_line()}", flush=True)
    ref, tokens, caches = {}, {}, {}
    yard = {}
    for run in NI_RUNS:
        arch = run["arch"]
        res = ni_infer(torch, None, run)
        caches[arch] = str(tmp / f"ni_{arch}.pt")
        tokens[arch] = res["argmax"][:-1]
        # bf16's own rounding: the same run in f32 on one rank's greedy tokens
        wide = ni_infer(torch, None, run, tokens[arch], f32=True)
        scale = float(np.abs(res["logits"]).max())
        yard[arch] = dict(
            logits=(np.abs(res["logits"] - wide["logits"]).reshape(len(wide["logits"]), -1)
                    .max(-1) / scale),
            cache={k: float((x.float() - wide["cache"][k].float()).abs().max())
                   / max(float(x.float().abs().max()), 1e-30)
                   for k, x in res["cache"].items() if x.is_floating_point()})
        add_launches(launches, {k: sum(c["launches"][k] for c in wide["calls"])
                                for k in wide["calls"][0]["launches"]})
        del wide
        torch.save(res.pop("cache"), caches[arch])
        ref[arch] = res
        cfg = ni_cfg(run)
        calls = nt_attention_calls(cfg)[0]
        for i, c in enumerate(res["calls"]):
            want = calls if i == 0 else 0
            require(c["launches"].get("flash_attention_fwd", 0) == want and all(
                v == 0 for k, v in c["launches"].items() if k != "flash_attention_fwd"),
                f"ni one rank {arch} call {i}: launches {c['launches']}, expected "
                f"{want} of flash_attention_fwd and nothing else")
            add_launches(launches, c["launches"])
        require(bool(np.isfinite(res["logits"]).all()), f"ni one rank {arch}: non-finite")
    _build.build()             # the ranks load the library built here
    torch.cuda.empty_cache()
    out = {"one_rank": {a: [{k: v for k, v in c.items() if k != "routes"} for c in r["calls"]]
                        for a, r in ref.items()}, "grids": {}}
    worst = {"logit": 0.0, "cache": 0.0, "flips": 0, "margins": 0}
    for grid, archs in NI_GRIDS.items():
        label = f"{grid[0]}x{grid[1]}"
        runs = tuple(r for r in NI_RUNS if r["arch"] in archs)
        t0 = time.perf_counter()
        results = tmesh.spawn(ni_rank, grid, (runs, tokens, caches), timeout=NI["timeout"],
                              threads=None)
        wall = time.perf_counter() - t0
        row = {"wall_s": wall}
        for run in runs:
            arch = run["arch"]
            what = f"ni {label} {arch}"
            one = ref[arch]
            lg1 = one["logits"]
            scale = float(np.abs(lg1).max())
            top2 = np.sort(lg1, axis=-1)[..., -2:]
            margin = top2[..., 1] - top2[..., 0]                 # [steps + 1, B]
            rel, flips, sure = 0.0, 0, int((margin > 2 * NI["logit_rel"] * scale).sum())
            # MoE: each call's (token, expert) assignments rank 0 routes otherwise
            # than one rank (rank 0's tokens lead the global order)
            rerouted, assigned = [], 0
            for c1, c0 in zip(one["calls"], results[0][arch]["calls"]):
                n = sum(nr_flips(torch, a[None, :len(b)], b[None])
                        for a, b in zip(c1["routes"], c0["routes"]))
                rerouted.append(n)
                assigned += sum(b.size for b in c0["routes"])
            for r in results:
                got = r[arch]
                per_call = np.abs(got["logits"] - lg1).reshape(len(lg1), -1).max(-1) / scale
                bound = np.where(np.array(rerouted) > 0, NI["moe_logit_rel"],
                                 np.maximum(NI["logit_rel"], NI["yard"] * yard[arch]["logits"]))
                require(bool((per_call <= bound).all()),
                        f"{what} rank {r['coords']}: logits off one rank's, call by call "
                        f"{np.round(per_call, 4).tolist()} over bounds {bound.tolist()} "
                        f"(assignments routed otherwise {rerouted})")
                rel = max(rel, float(per_call.max()))
                differ = got["argmax"] != one["argmax"]
                flips += int((differ & (margin > 2 * NI["logit_rel"] * scale)).sum())
                cache_rel = max(got["cache_rel"].values())
                worst["cache"] = max(worst["cache"], cache_rel)
                cbound = {k: max(NI["cache_rel"], NI["yard"] * yard[arch]["cache"].get(k, 0.0))
                          for k in got["cache_rel"]}
                require(all(v <= cbound[k] for k, v in got["cache_rel"].items()),
                        f"{what} rank {r['coords']}: cache off one rank's slice "
                        f"{got['cache_rel']} (bounds {cbound})")
                for i, c in enumerate(got["calls"]):
                    want = nt_attention_calls(ni_cfg(run))[0] if i == 0 else 0
                    require(c["launches"].get("flash_attention_fwd", 0) == want and all(
                        v == 0 for k, v in c["launches"].items()
                        if k != "flash_attention_fwd"),
                        f"{what} rank {r['coords']} call {i}: launches {c['launches']}")
                    add_launches(launches, c["launches"])
            worst["logit"] = max(worst["logit"], rel)
            worst["flips"] += flips
            worst["margins"] += sure
            r0 = results[0][arch]["calls"]
            require(sum(rerouted) <= max(4, NI["max_rerouted"] * assigned),
                    f"{what}: {sum(rerouted)} of {assigned} (token, expert) assignments "
                    "routed otherwise than one rank")
            res = dict(logit_rel=rel, flips=flips, sure=sure, rerouted=rerouted,
                       assigned=assigned, bf16_vs_f32=dict(
                           logits=float(yard[arch]["logits"].max()),
                           cache=max(yard[arch]["cache"].values())),
                       cache_rel=[r[arch]["cache_rel"] for r in results],
                       prefill=dict(ms=r0[0]["ms"], wire=r0[0]["wire"], peak=r0[0]["peak"],
                                    base=r0[0]["base"]),
                       decode=dict(ms=statistics.median(c["ms"] for c in r0[2:]),
                                   wire=r0[1]["wire"], peak=r0[1]["peak"], base=r0[1]["base"]),
                       one_rank=dict(prefill_ms=one["calls"][0]["ms"],
                                     decode_ms=statistics.median(
                                         c["ms"] for c in one["calls"][2:])))
            row[arch] = res
            print(f"{what} ({ni_cfg(run).n_layers} layers, B {NI['batch']} x {run['prompt']} "
                  f"at {run['pad_to']} slots, {NI['steps']} steps): logits against one rank's, "
                  f"largest |difference| / largest |logit| {rel:.3g}; greedy tokens differ at "
                  f"{flips} of the {sure} (step, row) pairs whose one-rank top-2 margin "
                  f"exceeds {2 * NI['logit_rel']:.3g} of the scale; one rank's bf16 logits "
                  f"off its f32 run's {res['bf16_vs_f32']['logits']:.3g}, its cache "
                  f"{res['bf16_vs_f32']['cache']:.3g}; "
                  + (f"{sum(rerouted)} of {assigned} (token, expert) assignments routed "
                     f"otherwise than one rank on rank 0, call by call {rerouted}; "
                     if assigned else "") + f"cache off its slice of "
                  f"one rank's {max(max(c.values()) for c in res['cache_rel']):.3g}; rank 0 "
                  f"prefill {res['prefill']['ms']:.1f} ms (one rank "
                  f"{res['one_rank']['prefill_ms']:.1f}), decode {res['decode']['ms']:.1f} "
                  f"ms a step (one rank {res['one_rank']['decode_ms']:.1f}), wire bytes "
                  f"{res['prefill']['wire']:,} a prefill and {res['decode']['wire']:,} a "
                  f"step, peak {res['prefill']['peak'] / 2**30:.3f} / "
                  f"{res['decode']['peak'] / 2**30:.3f} GiB", flush=True)
            require(flips == 0, f"{what}: {flips} greedy tokens differ where one rank's "
                                "margin is clear")
        out["grids"][label] = row
        print(f"ni {label}: {len(results)} ranks over gloo on cuda:0, {wall:.1f} s with the "
              "ranks' start", flush=True)
    out["worst"] = worst
    print(f"ni checks: every grid's logits within {NI['logit_rel']} of one rank's scale or "
          f"{NI['yard']}x one rank's bf16 distance from f32, an MoE call routed otherwise "
          f"than one rank's within {NI['moe_logit_rel']} (worst {worst['logit']:.3g}); "
          f"greedy tokens equal at all {worst['margins']} "
          f"clear-margin (step, row) pairs ({worst['flips']} differ); every rank's cache "
          f"within {NI['cache_rel']} (or {NI['yard']}x bf16's) of its slice of one rank's "
          f"(worst {worst['cache']:.3g}), "
          "slot_pos equal; one attention launch a prefill call, none a decode step",
          flush=True)
    return out



# ---------------------------------------------------------------------------
# phase 25: the dry run held to the card
# ---------------------------------------------------------------------------

def dry_jobs() -> list:
    """The dry run's jobs of (a)-(c): phase 16's and phase 19's steps and
    phase 17's 1x4 serves on the repo's own tiers (its replaying tiers are
    this script's and move what the tiers they replay move)."""
    jobs = [dict(kind="train", arch=TRAIN["arch"], batch=TRAIN["batch"], seq=TRAIN["seq"],
                 mesh=[1], what="a"),
            dict(kind="train", arch=TR["arch"], layers=TR_RUNS[(1, 2)][0][1],
                 batch=TR["batch"], seq=TR["seq"], mesh=[1, 2], what="b")]
    for c in mr_cases((1, 4)):
        if c["cfg"].get("channel", "bsc").endswith("_replay"):
            continue
        jobs.append(dict(kind={"ota": "ota", "wired": "wired", "train": "train_hdc"}[c["kind"]],
                         cfg=c["cfg"], mesh=[1, 4], what="c", name=c["name"]))
    return jobs


def dry_infer_jobs() -> list:
    """The dry run's jobs of (e): phase 26's prefill and decode, every
    family on 1x2, TinyLlama-1.1B, Mixtral-8x22B and Whisper-tiny on the
    data grids that run them, as rank 0 of each grid."""
    jobs = []
    for grid, archs in NI_GRIDS.items():
        label = f"{grid[0]}x{grid[1]}"
        keep = archs if grid == (1, 2) else [a for a in archs if a in (
            "tinyllama-1.1b", "mixtral-8x22b", "whisper-tiny")]
        for run in (r for r in NI_RUNS if r["arch"] in keep):
            base = dict(ni_job(run), mesh=list(grid), what="e", grid=label)
            jobs.append(dict(base, kind="prefill", seq=run["prompt"], pad_to=run["pad_to"]))
            jobs.append(dict(base, kind="decode", seq=run["pad_to"]))
    return jobs


def dry_run_records(tmp: Path) -> tuple[list, dict]:
    """Phase 25's dry runs (`python -m repro_torch.launch.dryrun` on fake
    tensors standing for this card), every subprocess at once, each given
    DRY["timeout"] seconds: the custom jobs of `dry_jobs` in one, those of
    `dry_infer_jobs` in three, each production record of DRY in its own
    (16x16, rank 0). Returns (the custom records, {(arch, cell): production
    record}); fails on a non-zero exit or a run past its time (killed)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    (tmp / "jobs.json").write_text(json.dumps(dry_jobs()))
    infer = dry_infer_jobs()
    for i in range(3):                      # a run's prefill and decode, every third run
        (tmp / f"infer{i}.json").write_text(json.dumps(
            [j for k, j in enumerate(infer) if k // 2 % 3 == i]))
    mod = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cuda"]
    runs = [["--custom", str(tmp / "jobs.json"), "--out", str(tmp / "custom.json")]]
    runs += [["--custom", str(tmp / f"infer{i}.json"), "--out", str(tmp / f"infer{i}_out.json")]
             for i in range(3)]
    runs += [["--arch", arch, "--cell", cell, "--force", "--out", str(tmp / "prod")]
             for arch, cell in DRY["production"]]
    procs = []
    try:
        for i, args in enumerate(runs):
            with open(tmp / f"run{i}.log", "w") as log:
                procs.append(subprocess.Popen(mod + args, env=env, cwd=ROOT, stdout=log,
                                              stderr=subprocess.STDOUT))
        for i, (p, args) in enumerate(zip(procs, runs)):
            try:
                p.wait(timeout=DRY["timeout"])
            except subprocess.TimeoutExpired:
                require(False, f"dry run {args[:2]} not done in {DRY['timeout']} s")
            require(p.returncode == 0, f"dry run {args[:2]} exited {p.returncode}: "
                    + (tmp / f"run{i}.log").read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = json.loads((tmp / "custom.json").read_text())
    for i in range(3):
        recs += json.loads((tmp / f"infer{i}_out.json").read_text())
    prod = {(a, c): json.loads((tmp / "prod" / "pod1" / f"{a}__{c}.json").read_text())
            for a, c in DRY["production"]}
    return recs, prod


def dry_infer_check(recs: list, infer_ranks: dict) -> dict:
    """Phase 25 (e): rank 0's wire bytes of each of phase 26's prefills and
    decode steps counted (the records of `dry_infer_jobs`) equal to its
    counter, and the predicted peak within DRY["peak_rel"] of its
    max_memory_allocated (each call's, the peak reset just before it), with
    what the rank held outside the call's arguments added, as (a) adds it:
    its memory_allocated as the call starts less the arguments counted (31-33
    MiB in every call on an H100, the size of cuBLAS's default
    workspace)."""
    rows, worst = 0, 0.0
    for r in recs:
        job = r["job"]
        if job["what"] != "e":
            continue
        what = f"dry (e) {job['grid']} {job['arch']} {job['kind']}"
        meas = infer_ranks["grids"][job["grid"]][job["arch"]][job["kind"]]
        wire = r["cost_per_rank"]["collective"]["total"]
        outside = meas["base"] - r["memory_per_rank"]["arguments"]
        pred = r["memory_per_rank"]["peak_bytes"] + outside
        rel = abs(pred - meas["peak"]) / meas["peak"]
        worst, rows = max(worst, rel), rows + 1
        print(f"{what}, rank 0: wire bytes {wire:,} (by type "
              f"{r['cost_per_rank']['collective']}) vs phase 26's counter {meas['wire']:,}; "
              f"predicted peak {r['memory_per_rank']['peak_bytes'] / 2**30:.3f} GiB + held "
              f"outside the arguments {outside / 2**20:.1f} MiB = {pred / 2**30:.3f} GiB vs "
              f"{meas['peak'] / 2**30:.3f} GiB (relative {rel:.4f}); {r['t_count_s']:.1f} s "
              "to count", flush=True)
        require(wire == meas["wire"], f"{what}: wire bytes {wire} != phase 26's {meas['wire']}")
        require(rel <= DRY["peak_rel"], f"{what}: predicted peak {pred} vs {meas['peak']} "
                                        f"(relative {rel:.4f})")
    return dict(cases=rows, worst_peak_rel=worst)


def phase_dryrun(torch, train: dict, train_ranks: dict, multirank: dict, infer_ranks: dict
                 ) -> dict:
    """Phase 25: the dry runs of `dry_run_records`, each record traced on
    fake CUDA tensors, and each prediction held to what the earlier phases
    of this run measured, read from their results, with no second run of
    those steps:
    (a) the peak, plus what phase 16 held outside its steps (read there),
    within DRY["peak_rel"] of phase 16's max_memory_allocated (the
    categories at the peak printed; the counted FLOPs over phase 16's model
    FLOPs and the roofline bound over its ms a step reported); (b) rank 0's
    wire bytes a step equal to phase 19's 1x2 counter and its peak within
    DRY["peak_rel"] of rank 0's; (c) rank 0's wire bytes a call equal to
    phase 17's counter on every 1x4 case counted; (d) both production
    records ok, their per-rank peak against the card's memory and their
    dominant roofline term printed; (e) rank 0's wire bytes of each of
    phase 26's prefills and decode steps counted equal to its counter, and
    the predicted peak within DRY["peak_rel"] of its max_memory_allocated
    (each call's, the peak reset just before it)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        recs, prod = dry_run_records(Path(tmp))
    for r in recs + list(prod.values()):
        require(r.get("traced_on") == "cuda", f"dry run {r.get('job') or r.get('cell')}: "
                f"traced on {r.get('traced_on')}, not on fake CUDA tensors")
    card = torch.cuda.get_device_properties(0).total_memory
    out = {"records": recs, "production": {f"{a} {c}": r for (a, c), r in prod.items()}}

    def gib(x):
        return x / 2**30

    # (a) phase 16's AdamW step on one rank
    a = next(r for r in recs if r["job"]["what"] == "a")
    ta = train["adamw"]
    meas = ta["max_memory_allocated"]
    # the dry run counts the step; phase 16's reading also counts what the
    # process holds outside it, both read in that phase: tensors of earlier
    # phases resident as its steps start, and the backward rows it records
    outside = ta["resident_before"] - ta["state_bytes"] + ta["recorded_bytes"]
    step_pred = a["memory_per_rank"]["peak_bytes"]
    pred = step_pred + outside
    rel = abs(pred - meas) / meas
    cats = a["memory_per_rank"]["categories_at_peak"]
    flops_ratio = a["cost_per_rank"]["flops"] / train["adamw"]["model_flops"]
    bound_ratio = a["roofline_s"]["bound"] * 1e3 / train["adamw"]["ms_per_step"]
    print(f"dry (a) {TRAIN['arch']} AdamW B {TRAIN['batch']} x {TRAIN['seq']}, one rank: "
          f"predicted step peak {gib(step_pred):.3f} GiB + held outside the step "
          f"{gib(outside):.3f} (resident {gib(ta['resident_before'] - ta['state_bytes']):.3f}, "
          f"recorded rows {gib(ta['recorded_bytes']):.3f}) = {gib(pred):.3f} GiB vs phase "
          f"16's {gib(meas):.3f} GiB (relative {rel:.4f}, gate {DRY['peak_rel']}; the step "
          f"alone {abs(step_pred - meas) / meas:.4f}); at the peak " + ", ".join(
              f"{k} {gib(v):.2f}" for k, v in cats.items()) + f" GiB; counted FLOPs / phase "
          f"16's model FLOPs {flops_ratio:.4f}; roofline bound {a['roofline_s']['bound'] * 1e3:.2f}"
          f" ms ({a['roofline_s']['dominant']}) / measured {train['adamw']['ms_per_step']:.2f} "
          f"ms = {bound_ratio:.4f}; {a['t_count_s']:.1f} s to count", flush=True)
    require(rel <= DRY["peak_rel"], f"dry (a): predicted peak {pred} vs measured {meas} "
                                    f"(relative {rel:.4f} > {DRY['peak_rel']})")
    out["a"] = dict(pred=pred, step_pred=step_pred, outside=outside, meas=meas, rel=rel,
                    flops_ratio=flops_ratio, bound_ratio=bound_ratio)
    # (b) phase 19's 1x2 AdamW step, rank 0
    b = next(r for r in recs if r["job"]["what"] == "b")
    layers = TR_RUNS[(1, 2)][0][1]
    grid = train_ranks["grids"]["1x2"]["adamw" + ("" if layers is None else f"-{layers}L")]
    wire_meas, peak_meas = int(grid["wire"][0]), grid["peak"][0]
    wire_pred = b["cost_per_rank"]["collective"]["total"]
    pred_b = b["memory_per_rank"]["peak_bytes"]
    rel_b = abs(pred_b - peak_meas) / peak_meas
    print(f"dry (b) {TR['arch']} AdamW 1x2 ({layers or 'all'} layers), rank 0 of a fake world "
          "of 2: wire bytes a step "
          f"{wire_pred:,} (by type {b['cost_per_rank']['collective']}) vs phase 19's counter "
          f"{wire_meas:,}; predicted peak {gib(pred_b):.2f} GiB vs {gib(peak_meas):.2f} GiB "
          f"(relative {rel_b:.4f})", flush=True)
    require(wire_pred == wire_meas, f"dry (b): wire bytes {wire_pred} != phase 19's {wire_meas}")
    require(rel_b <= DRY["peak_rel"], f"dry (b): predicted peak {pred_b} vs measured "
                                      f"{peak_meas} (relative {rel_b:.4f})")
    out["b"] = dict(wire=wire_pred, wire_meas=wire_meas, pred=pred_b, meas=peak_meas,
                    rel=rel_b)
    # (c) phase 17's 1x4 serves, rank 0
    bytes_meas = multirank["grids"]["1x4"]["bytes"]
    rows = [(r["job"]["name"], r["cost_per_rank"]["collective"]["total"],
             bytes_meas[r["job"]["name"]]) for r in recs if r["job"]["what"] == "c"]
    bad = [(n, p, m) for n, p, m in rows if p != m]
    print(f"dry (c) phase 17's 1x4 serves, rank 0: {len(rows) - len(bad)} of {len(rows)} "
          f"cases' wire bytes a call equal the counter's (" + "; ".join(
              f"{n} {p:,}" for n, p, _ in rows[:4]) + "; ...)", flush=True)
    require(not bad, f"dry (c): wire bytes differ from phase 17's counter: {bad}")
    out["c"] = dict(cases=len(rows))
    # (d) two production records on 16x16
    for (arch, cell), r in prod.items():
        require(r["status"] == "ok", f"dry (d) {arch} {cell}: status {r['status']}: "
                                     f"{r.get('error')}")
        m, rl = r["memory_per_rank"], r["roofline_s"]
        print(f"dry (d) {arch} {cell} on {r['mesh']}, rank 0: peak {gib(m['peak_bytes']):.2f} "
              f"GiB of the card's {gib(card):.2f} (arguments {gib(m['arguments']):.3f}); "
              f"roofline compute {rl['compute'] * 1e3:.4g} / memory {rl['memory'] * 1e3:.4g} / "
              f"collective {rl['collective'] * 1e3:.4g} ms, dominant {rl['dominant']}; "
              f"{r['t_count_s']:.1f} s to count", flush=True)
    out["e"] = dry_infer_check(recs, infer_ranks)
    rows_e, worst_e = out["e"]["cases"], out["e"]["worst_peak_rel"]
    print(f"dry checks: (a) and (b)'s predicted peaks within {DRY['peak_rel']} of phases 16 "
          "and 19's max_memory_allocated; (b) and (c)'s wire bytes equal the counter's "
          "readings of phases 19 and 17; every production record ok; (e) "
          f"{rows_e} of phase 26's prefills and decode steps: wire bytes equal the "
          f"counter's, predicted peaks within {DRY['peak_rel']} (worst {worst_e:.4f})",
          flush=True)
    return out


def phase_profile(torch, state, protos_u, base) -> dict:
    """``--profile``: each serve mode's CALLS calls under torch.profiler."""
    out = {}
    for mode in MODES:
        label, _, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u, "cuda")
        out[label] = profile_calls(torch, label, [
            lambda q=q: serve(protos, q, state, gn) for _, q in batches])
    return out


def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile every serve mode under torch.profiler")
    ap.add_argument("--json", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    ap.add_argument("--resume-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs only on the GPU here",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)
    if args.resume_child is not None:      # phase 16 (d)'s child process
        return resume_child(args.resume_child)
    from repro_torch.core import classifier, scaleout
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}
    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"card: {card} ({kind}, {count} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    from repro_torch import compat
    print(compat.describe(), flush=True)
    _build.library()
    print(f"build: {_build.build_seconds:.2f} s (nvcc, sm_90a, "
          f"{len(_build.SOURCES)} sources in parallel)", flush=True)
    sass = sass_counts(_build.build())
    sass["ptxas"] = ptxas_report(_build.build())
    print("ptxas (registers, spill store / load bytes): " + ", ".join(
        f"{k} {v[0]} regs {v[1]}/{v[2]} B" for k, v in sass["ptxas"].items()), flush=True)
    for name, (want, bad) in SASS_RULES.items():
        got = sass["counts"][name]
        print(f"sass {name}: " + ", ".join(f"{op} {got[op]}" for op in want + bad), flush=True)
        require(sum(got[op] for op in want) > 0, f"sass {name}: no {'/'.join(want)} instruction")
        require(all(got[op] == 0 for op in bad), f"sass {name}: {bad} present: {got}")
    require(not sass["gone"], f"sass: retired kernels still built: {sass['gone']}")
    # Kimi-K2's D = 112 and Zamba2's D = 80 run in the D = 128 tiles: their
    # bf16 instances of the forward and of both backward passes on wgmma too
    for kern in ("flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel"):
        for d in (112, 80):
            inst = {fn: c["HGMMA"] for fn, c in sass["instances"].items()
                    if kern in fn and f"Li{d}E" in fn}
            print(f"sass {kern}<{d}>: HGMMA {sum(inst.values())}", flush=True)
            require(len(inst) == 1 and all(n > 0 for n in inst.values()),
                    f"sass: the D = {d} instance of {kern} has no HGMMA: {inst}")
    # the SIMT attention kernels are built for f32 only (no bf16 instance)
    for name, fns in sass["simt_attention"].items():
        print(f"sass {name}: {len(fns)} instances, bf16 among them: "
              f"{any('bfloat16' in fn for fn in fns)}", flush=True)
        require(fns and all("bfloat16" not in fn for fn in fns),
                f"sass: the SIMT attention kernel {name} has other than f32 instances: {fns}")
    seconds["1 build"] = time.perf_counter() - t_start

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    kernels = phase("2 kernels", lambda: phase_kernels(
        torch, torch.Generator(device="cuda").manual_seed(0)))

    cfg = scaleout.ScaleOutConfig()
    pre_ms = []

    def precharacterize():
        for _ in range(2):                   # cold (first use of its ops), then warm
            t0 = time.perf_counter()
            st = scaleout.precharacterize_state(cfg, device="cuda")
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        return st

    state = phase("3 precharacterization", precharacterize)
    avg, mx = float(state.ber.mean()), float(state.ber.max())
    print(f"precharacterization: {cfg.m_tx} TX / {cfg.n_rx_cores} RX / {cfg.snr_db} dB, "
          f"avg BER {avg:.6f}, max {mx:.6f}, {pre_ms[0]:.1f} ms cold, {pre_ms[1]:.1f} ms warm",
          flush=True)
    require(abs(avg - 0.0100) <= 1e-4, f"avg BER {avg} is not 0.0100 +- 1e-4")

    protos_u = classifier.make_codebook(
        torch.Generator(device="cuda").manual_seed(0),
        classifier.HDCTaskConfig(n_classes=cfg.n_classes, dim=cfg.dim), device="cuda")
    serves = phase("4-5 serves", lambda: phase_serves(torch, state, protos_u, cfg))
    launches = dict(serves["launches"])
    flip = phase("6 bsc flip rate", lambda: phase_flip_rate(torch, state, cfg))
    table = phase("7 table1", lambda: phase_table1(torch, avg, launches))
    sparse_trials = phase("8 sparse trials", lambda: phase_sparse_trials(torch, avg, launches))
    sparse_serve = phase("9 sparse serve", lambda: phase_sparse_serve(
        torch, state, launches, profile=args.profile))
    coarse = phase("10 coarse-to-fine and multi-centroid", lambda: phase_coarse(
        torch, launches, profile=args.profile))
    lm = phase("11 LM serve", lambda: phase_lm(torch, launches, profile=args.profile))
    physical = phase("12 symbol tier, M-drop, bitplane, living channels",
                     lambda: phase_physical(torch, state, protos_u, cfg, launches,
                                            profile=args.profile))
    mt = phase("13 multi-tenant serving", lambda: phase_mt(torch, state, launches,
                                                           profile=args.profile))
    fault = phase("14 fault tolerance", lambda: phase_faults(torch, state, launches,
                                                             profile=args.profile))
    cont = phase("15 continuous LM serving", lambda: phase_continuous(
        torch, launches, profile=args.profile))
    train = phase("16 training", lambda: phase_train(torch, launches, profile=args.profile))
    multirank = phase("17 scale-out serve across ranks",
                      lambda: phase_multirank(torch, state, launches))
    living = phase("18 living channels, faults and the HDC engines across ranks",
                   lambda: phase_living_ranks(torch, state, launches))
    train_ranks = phase("19 training across ranks",
                        lambda: phase_train_ranks(torch, launches))
    moe_dec = phase("20 the MoE decoder", lambda: phase_moe(torch, launches,
                                                           profile=args.profile))
    ssm_dec = phase("21 the SSM and hybrid decoders", lambda: phase_ssm(
        torch, launches, profile=args.profile))
    xd_dec = phase("22 the enc-dec and VLM decoders", lambda: phase_xd(
        torch, launches, profile=args.profile))
    nondense = phase("23 training of the non-dense decoders",
                     lambda: phase_nondense_train(torch, launches))
    nondense_ranks = phase("24 training of every non-dense family across ranks",
                           lambda: phase_nondense_ranks(torch, launches))
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ni_") as tmp:
        infer_ranks = phase("26 sharded inference on ranks",
                            lambda: phase_infer_ranks(torch, launches, Path(tmp)))
    dryrun = phase("25 the dry run held to the card",
                   lambda: phase_dryrun(torch, train, train_ranks, multirank, infer_ranks))
    kernels["flash_attention_bwd"] = train["kernel_cases"]
    profiles = (phase("profile", lambda: phase_profile(torch, state, protos_u, cfg))
                if args.profile else None)

    line = []
    for name, (route, source, replaces) in KERNELS.items():
        main_row = kernels[name][0]          # the first case is the main path's shape
        line.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=launches.get(name, 0),
                         max_abs_err=max(r["max_abs_err"] for r in kernels[name]),
                         ms=main_row["ms"], call_ms=main_row["call_ms"],
                         plain_ms=main_row["plain_ms"],
                         bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                         library_ms=main_row["library_ms"], shape=main_row["shape"]))
    require(all(k["launches"] > 0 for k in line), "a kernel of the path never launched")
    seconds["total"] = time.perf_counter() - t_start
    print("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
          flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(
            card=card, kind=kind, torch=torch.__version__, build_s=_build.build_seconds,
            sass=sass,
            ber=dict(avg=avg, max=mx, ms=pre_ms), kernels=kernels, serves=serves["runs"],
            flip_rate=flip, table1=table, sparse_trials=sparse_trials,
            sparse_serve=sparse_serve, coarse=coarse, lm=lm, physical=physical, mt=mt,
            faults=fault, cont=cont, train=train, multirank=multirank, living_ranks=living,
            train_ranks=train_ranks, moe=moe_dec, ssm=ssm_dec, xd=xd_dec,
            nondense_train=nondense, nondense_ranks=nondense_ranks, infer_ranks=infer_ranks,
            dryrun=dryrun,
            launches=launches,
            profiles=profiles, seconds=seconds), indent=1))
    print(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
